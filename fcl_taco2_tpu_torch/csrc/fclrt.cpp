// fclrt: native host runtime of fcl_taco2_tpu_torch (the port's own copy
// of the JAX package's native/fclrt.cpp; the two must stay bit-equal).
//
// The per-batch host work on the training hot path is building the phoneme
// regroup plan (ops/regroup.py build_plan): scanning durations, computing
// segment tables, and producing the utterance-frame gather index map.  The
// reference does the equivalent with per-phoneme Python loops (reference
// tts.py:243-263); the numpy version is vectorized, and this C++
// implementation removes the remaining interpreter overhead and temporary
// allocations (it is O(total frames) with exactly one pass per output
// table).
//
// Exposed via a plain C ABI for ctypes.
//
// Build: data/native.py compiles it with g++ -O3 -shared -fPIC into
// fcl_taco2_tpu_torch/_build/ at first use.

#include <cstdint>
#include <cstring>

#include <algorithm>
#include <vector>

extern "C" {

// Build the segment tables + inverse frame map for one batch.
//
// Inputs:
//   durations : [B * Tmax] int32, frames per token (0 = skip/pad)
//   B, Tmax   : batch / token-axis sizes
//   max_dur   : D, static per-segment frame budget
//   P         : padded segment capacity (out tables sized to P)
//   max_olen  : Lmax, padded utterance frame capacity
// Outputs (caller-allocated):
//   seg_utt   [P], seg_tok [P], seg_start [P], seg_dur [P]  int32
//   frame_mask [P * max_dur]  uint8 (1 where d < seg_dur)
//   position   [P * max_dur]  float32 (d / dur ramps)
//   utt_gather [B * max_olen] int32 (flat index into P*D phoneme frames)
//   utt_mask   [B * max_olen] uint8 (1 at valid frames)
// Returns: number of real segments, or -1 if P / max_dur is exceeded.
int32_t fclrt_build_plan(
    const int32_t* durations, int32_t B, int32_t Tmax, int32_t max_dur,
    int32_t P, int32_t max_olen,
    int32_t* seg_utt, int32_t* seg_tok, int32_t* seg_start,
    int32_t* seg_dur, uint8_t* frame_mask, float* position,
    int32_t* utt_gather, uint8_t* utt_mask) {
  const int32_t D = max_dur;
  std::memset(seg_utt, 0, sizeof(int32_t) * P);
  std::memset(seg_tok, 0, sizeof(int32_t) * P);
  std::memset(seg_start, 0, sizeof(int32_t) * P);
  std::memset(seg_dur, 0, sizeof(int32_t) * P);
  std::memset(frame_mask, 0, sizeof(uint8_t) * P * D);
  std::memset(position, 0, sizeof(float) * P * D);
  std::memset(utt_gather, 0, sizeof(int32_t) * B * max_olen);
  std::memset(utt_mask, 0, sizeof(uint8_t) * B * max_olen);

  int32_t seg = 0;
  for (int32_t b = 0; b < B; ++b) {
    int32_t frame = 0;  // cumulative frame position within utterance b
    const int32_t* durs_b = durations + (int64_t)b * Tmax;
    for (int32_t t = 0; t < Tmax; ++t) {
      const int32_t d = durs_b[t];
      if (d <= 0) continue;
      if (d > D || seg >= P || frame + d > max_olen) return -1;
      seg_utt[seg] = b;
      seg_tok[seg] = t;
      seg_start[seg] = frame;
      seg_dur[seg] = d;
      uint8_t* fm = frame_mask + (int64_t)seg * D;
      float* pos = position + (int64_t)seg * D;
      int32_t* gather = utt_gather + (int64_t)b * max_olen + frame;
      uint8_t* mask = utt_mask + (int64_t)b * max_olen + frame;
      const int32_t base = seg * D;
      for (int32_t k = 0; k < d; ++k) {
        fm[k] = 1;
        // divide (not multiply by reciprocal): bit-exact with the numpy
        // reference implementation in ops/regroup.py
        pos[k] = (float)((double)k / (double)d);
        gather[k] = base + k;
        mask[k] = 1;
      }
      frame += d;
      ++seg;
    }
  }
  return seg;
}

// Build the duration-classed plan (bit-exact vs ops/regroup.py
// build_classed_plan): segments partition into ascending duration classes
// (first class whose cap fits; an over-full class spills its LAST
// arrivals upward), each class padded to a static capacity, and the
// utterance-frame gather indexes the CONCATENATION of the per-class flat
// frame buffers (class c's segment j frame k lives at
// offset_c + j * class_durs[c] + k, offset_c = sum cap_i * dur_i, i < c).
//
// Inputs:
//   durations  : [B * Tmax] int32 (0 = skip/pad)
//   olens      : [B] int32 total frames per utterance
//   class_durs : [n_classes] ascending duration caps (last >= max dur)
//   class_caps : [n_classes] static per-class segment capacities
// Outputs (caller-allocated, FLAT over classes):
//   seg_utt/seg_tok/seg_start/seg_dur : [sum(class_caps)] int32
//   seg_mask   : [sum(class_caps)] uint8
//   frame_mask : [sum(class_caps[c] * class_durs[c])] uint8
//   position   : [same] float32
//   utt_gather : [B * max_olen] int32, utt_mask : [B * max_olen] uint8
// Returns: total real segments, -1 on capacity overflow, -2 when a
// duration exceeds the top class cap, -3 when an utterance's frames
// exceed max_olen (the numpy builder would index out of bounds there;
// never write past the caller's buffers).
int32_t fclrt_build_classed_plan(
    const int32_t* durations, int32_t B, int32_t Tmax,
    const int32_t* olens, const int32_t* class_durs,
    const int32_t* class_caps, int32_t n_classes, int32_t max_olen,
    int32_t* seg_utt, int32_t* seg_tok, int32_t* seg_start,
    int32_t* seg_dur, uint8_t* seg_mask, uint8_t* frame_mask,
    float* position, int32_t* utt_gather, uint8_t* utt_mask) {
  int64_t rows = 0, cells = 0;
  for (int32_t c = 0; c < n_classes; ++c) {
    rows += class_caps[c];
    cells += (int64_t)class_caps[c] * class_durs[c];
  }
  std::memset(seg_utt, 0, sizeof(int32_t) * rows);
  std::memset(seg_tok, 0, sizeof(int32_t) * rows);
  std::memset(seg_start, 0, sizeof(int32_t) * rows);
  std::memset(seg_dur, 0, sizeof(int32_t) * rows);
  std::memset(seg_mask, 0, sizeof(uint8_t) * rows);
  std::memset(frame_mask, 0, sizeof(uint8_t) * cells);
  std::memset(position, 0, sizeof(float) * cells);
  std::memset(utt_gather, 0, sizeof(int32_t) * B * max_olen);

  // segments in utterance-major order
  std::vector<int32_t> s_utt, s_tok, s_start, s_dur, s_base;
  for (int32_t b = 0; b < B; ++b) {
    int32_t frame = 0;
    const int32_t* durs_b = durations + (int64_t)b * Tmax;
    for (int32_t t = 0; t < Tmax; ++t) {
      const int32_t d = durs_b[t];
      if (d <= 0) { continue; }
      if (d > class_durs[n_classes - 1]) return -2;
      if (frame + d > max_olen) return -3;  // utt_gather bounds guard
      // first class whose cap fits (searchsorted 'left')
      int32_t c = 0;
      while (class_durs[c] < d) ++c;
      s_utt.push_back(b);
      s_tok.push_back(t);
      s_start.push_back(frame);
      s_dur.push_back(d);
      s_base.push_back(c);
      frame += d;
    }
  }
  const int64_t n_seg = (int64_t)s_dur.size();

  // membership with upward spill of each over-full class's tail; spill
  // order replicates the numpy implementation (pool first, then the
  // class's own arrivals in ascending global order)
  std::vector<int64_t> pool;
  int64_t row_off = 0, cell_off = 0;
  for (int32_t c = 0; c < n_classes; ++c) {
    std::vector<int64_t> idx;
    idx.swap(pool);
    for (int64_t i = 0; i < n_seg; ++i) {
      if (s_base[i] == c) idx.push_back(i);
    }
    if ((int64_t)idx.size() > class_caps[c]) {
      pool.assign(idx.begin() + class_caps[c], idx.end());
      idx.resize(class_caps[c]);
    }
    std::sort(idx.begin(), idx.end());  // keep utterance-major order
    const int32_t D_c = class_durs[c];
    for (int64_t j = 0; j < (int64_t)idx.size(); ++j) {
      const int64_t i = idx[j];
      const int64_t row = row_off + j;
      seg_utt[row] = s_utt[i];
      seg_tok[row] = s_tok[i];
      seg_start[row] = s_start[i];
      seg_dur[row] = s_dur[i];
      seg_mask[row] = 1;
      uint8_t* fm = frame_mask + cell_off + j * D_c;
      float* pos = position + cell_off + j * D_c;
      int32_t* gather =
          utt_gather + (int64_t)s_utt[i] * max_olen + s_start[i];
      const int32_t d = s_dur[i];
      const int64_t base = cell_off + j * D_c;
      for (int32_t k = 0; k < d; ++k) {
        fm[k] = 1;
        pos[k] = (float)((double)k / (double)d);
        gather[k] = (int32_t)(base + k);
      }
    }
    row_off += class_caps[c];
    cell_off += (int64_t)class_caps[c] * D_c;
  }
  if (!pool.empty()) return -1;

  for (int32_t b = 0; b < B; ++b) {
    uint8_t* mask = utt_mask + (int64_t)b * max_olen;
    const int32_t L = olens[b];
    for (int32_t l = 0; l < max_olen; ++l) mask[l] = l < L ? 1 : 0;
  }
  return (int32_t)n_seg;
}

}  // extern "C"
