"""Host-side batch pipeline: convert + upload ahead of the device (port of
``fcl_taco2_tpu/data/loader.py``).

One worker thread builds numpy batches (``data/converter.py``) and uploads
them in order: on the card each array is copied into pinned host memory
and sent with a non-blocking copy on a side stream, so the upload overlaps
the running step; the consumer's stream waits on the upload's event before
the batch is used (``BatchUploader``).  The order is the loader's, which
the per-step generators follow.  What the worker uploads is any tree of
numpy arrays: a ``Batch``, the device cache's plan packs
(``data/device_cache.py``), or tagged tuples of them (chained dispatch);
a ``finish`` step, run on the consumer's thread and stream, turns an
uploaded item into what the trainer consumes (the device cache
assembles its batch there, into buffers the previous step has finished
reading on the same stream).
"""

import queue
import threading
import time

import torch


class PrefetchLoader:
    """Iterate device-ready batches with background convert + transfer.

    After iteration, ``stats`` holds the wall-time split for the pass:
    ``wait_s`` (consumer blocked — the only part that can starve the
    device), ``convert_s`` / ``put_s`` (worker-side conversion and H2D,
    normally hidden behind device compute), ``batches``.
    """

    DEPTH = 3

    def __init__(self, batches, convert_fn, uploader, finish=None):
        """batches: list of utterance lists (or of groups of them);
        convert_fn: item -> tree of numpy arrays; uploader: a
        ``BatchUploader`` (``put`` on the worker, ``ready`` on the
        consumer's thread); finish: optional callable on the consumer's
        thread, applied to each ready item."""
        self.batches = batches
        self.convert_fn = convert_fn
        self.uploader = uploader
        self.finish = finish
        self.stats = {"wait_s": 0.0, "convert_s": 0.0, "put_s": 0.0,
                      "batches": 0}

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        q = queue.Queue(maxsize=self.DEPTH)
        stop = object()
        abandoned = threading.Event()
        err = []
        stats = {"wait_s": 0.0, "convert_s": 0.0, "put_s": 0.0,
                 "batches": 0}
        self.stats = stats  # live view; finalized when iteration ends

        def _put(item):
            # bounded put that gives up if the consumer went away (an
            # exception or break in the training loop must not leave the
            # worker blocked on a full queue forever)
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in self.batches:
                    t0 = time.perf_counter()
                    converted = self.convert_fn(b)
                    t1 = time.perf_counter()
                    item = self.uploader.put(converted)
                    stats["convert_s"] += t1 - t0
                    stats["put_s"] += time.perf_counter() - t1
                    if not _put(item):
                        return
            except BaseException as e:  # surface in consumer thread
                err.append(e)
            finally:
                _put(stop)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                stats["wait_s"] += time.perf_counter() - t0
                if item is stop:
                    break
                stats["batches"] += 1
                item = self.uploader.ready(item)
                yield item if self.finish is None else self.finish(item)
        finally:
            abandoned.set()
            thread.join()
            if err:
                raise err[0]


def _map_batch(fn, tree):
    """Apply ``fn`` to every array of a tree: a ``Batch`` (and its
    classes; a share's ``counts`` vector too), an array, or a tuple / list
    of them; strings (tags) and None pass through."""
    if tree is None or isinstance(tree, str):
        return tree
    if hasattr(tree, "_asdict"):  # Batch, SegClass
        return type(tree)(*[_map_batch(fn, x) for x in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_batch(fn, x) for x in tree)
    return fn(tree)


class BatchUploader:
    """A tree of numpy arrays (``_map_batch``) -> tensors on ``device``.
    On the card: pinned host copies, non-blocking copies on a side stream
    and an event that the consumer's stream waits on (``ready``); on the
    CPU the arrays are wrapped as they are."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(device=self.device)
                       if self.device.type == "cuda" else None)

    def put(self, batch):
        if self.stream is None:
            return _map_batch(torch.from_numpy, batch), None
        with torch.cuda.stream(self.stream):
            dev = _map_batch(lambda a: torch.from_numpy(a).pin_memory().to(
                self.device, non_blocking=True), batch)
            event = torch.cuda.Event()
            event.record(self.stream)
        return dev, event

    def ready(self, item):
        batch, event = item
        if event is None:
            return batch
        current = torch.cuda.current_stream(self.device)
        current.wait_event(event)

        def mark(t):
            t.record_stream(current)  # allocated on the side stream
            return t
        return _map_batch(mark, batch)

    def __call__(self, batch):
        """Upload and wait: the synchronous form."""
        return self.ready(self.put(batch))
