// The device side of the port's spans (utils/spans.py): a one-thread mark
// kernel captured into the CUDA graphs at each span boundary.
//
// Replaces no TPU kernel: it exists because a graph replay has no host
// ops, so the profiler cannot say which layer a replayed kernel belongs
// to.  Each mark reads the card's global nanosecond timer (%globaltimer,
// as ar_decode.cu's `mark` does), adds the time since the graph's
// previous mark to the region that ends here, and moves the graph's
// `last` stamp.  Regions and slots are fixed on the host at capture time,
// so a replay needs nothing from the host.  Bound: one launch a mark (a
// graph node, a few microseconds of card time); the work is three 8-byte
// accesses.

#include <cuda_runtime.h>

__global__ void span_mark(unsigned long long* slots, int last, int region) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (region >= 0) atomicAdd(&slots[region], now - slots[last]);
  slots[last] = now;
}

extern "C" {

// One mark on `stream`: slots[region] += now - slots[last] (region < 0
// adds nothing: a graph's opening mark), then slots[last] = now.
int span_mark_launch(void* slots, int last, int region, void* stream) {
  span_mark<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(slots), last, region);
  return cudaGetLastError();
}

}  // extern "C"
