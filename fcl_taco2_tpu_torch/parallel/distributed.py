"""Process bootstrap and each rank's share of the global batch (port of
``fcl_taco2_tpu/parallel/distributed.py``).

The JAX package runs one program on every host: ``jax.distributed``
wires the processes together and ``make_global_batch`` assembles the
logically global arrays its train step consumes with global semantics.
Here every rank is one process driving one card (``torch.distributed``):
every rank builds the same global numpy ``Batch`` (the converter is
deterministic given the manifest and the epoch seed) and keeps its
contiguous share of the utterances, with the global batch's padded
shapes and loss denominators (``make_global_batch``), so the ranks'
losses and gradients sum to the global batch's (``train/step.py``).

``spawn`` starts one rank a card on this host (``torch.multiprocessing``)
for the CLIs; under ``torchrun`` the ranks join through the environment
(``initialize()`` with no arguments).
"""

import math
import os
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from fcl_taco2_tpu_torch.models.taco2_sa import SegClass
from fcl_taco2_tpu_torch.ops.masking import global_counts

_LOCAL_HOSTS = ("localhost", "127.0.0.1", "::1")


def _host_of(address):
    rest = address.split("://", 1)[-1]
    return rest.rsplit(":", 1)[0].strip("[]")


def _check_nccl(device, num_processes, coordinator_address):
    """NCCL refuses two ranks on one device: raise, naming the cause,
    before the process group is made (NCCL itself fails only at the first
    collective, with a message about duplicate GPUs)."""
    if device.type != "cuda":
        raise ValueError(f"backend='nccl' needs a CUDA device, got "
                         f"{device}; use backend='gloo' on the CPU")
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local is not None:
        local = int(local)
    elif coordinator_address is not None and \
            _host_of(coordinator_address) in _LOCAL_HOSTS:
        local = num_processes
    cards = torch.cuda.device_count()
    if local is not None and local > cards:
        raise ValueError(
            f"backend='nccl' with {local} ranks on this host but {cards} "
            "card(s): NCCL refuses two ranks on one device; give each rank "
            "a card of its own, or pass backend='gloo' for ranks that "
            "share one")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device="cuda") -> None:
    """Join this process to the run's process group
    (``distributed.py:22-38``).

    With no address and no ``MASTER_ADDR``/``WORLD_SIZE`` in the
    environment this is a no-op: a plain single-process run.  With them
    only (``torchrun``), the group comes from the environment.
    ``coordinator_address``: ``host:port`` or ``tcp://host:port`` of rank
    0.  ``backend``: "nccl" (the default for a CUDA ``device``) or "gloo"
    (the default on the CPU; it also carries all_reduce and broadcast of
    CUDA tensors, through the host, for ranks that share a card).
    ``device``: this rank's device, made current when it is a CUDA one
    with an index.  Over NCCL the steps capture their collectives in CUDA
    graphs, so NCCL's asynchronous error handling is off
    (``TORCH_NCCL_ASYNC_ERROR_HANDLING=0`` unless the environment sets it),
    as PyTorch's CUDA-graph notes require before the process group is
    made."""
    from_env = coordinator_address is None and num_processes is None
    if from_env and not (os.environ.get("MASTER_ADDR")
                         or os.environ.get("WORLD_SIZE")):
        return
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        _check_nccl(dev, num_processes, coordinator_address)
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if from_env:
        dist.init_process_group(backend, init_method="env://")
    else:
        addr = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=addr,
                                world_size=num_processes, rank=process_id)


def is_multiprocess() -> bool:
    return process_count() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


# --------------------------------------------------------------------------
# each rank's share of the global batch
# --------------------------------------------------------------------------

def _round_up(x, mult):
    return int(math.ceil(max(x, 1) / mult) * mult)


def make_global_batch(mesh, batch):
    """The global numpy ``Batch`` -> this rank's share of it
    (``distributed.py:41-64``); a mesh that is not ``distributed`` gets
    the batch as it is.  See ``batch_share``."""
    if not mesh.distributed:
        return batch
    return batch_share(batch, mesh.rank, mesh.size)


def batch_share(batch, rank, n_ranks):
    """Rank ``rank``'s contiguous share of the utterances of ``batch`` (a
    numpy ``Batch``; ``B % n_ranks`` must be 0).

    The share keeps the global ``Tmax`` and ``Lmax`` (the unmasked means
    divide by the padded global size) and carries ``counts``, the global
    batch's denominators (``ops/masking.py::global_counts``).  Its plan
    holds the global plan's segments of its own utterances, in the
    global plan's classes (segments are utterance-major within a class,
    ``ops/regroup.py``, so they form one contiguous run): ``seg_utt``
    re-based to the share's rows and ``utt_gather`` to its flats.  Every
    rank gets one capacity a class: the global capacity over the ranks,
    rounded up to 8, or the largest rank's count where that is more, so
    the shapes stay put from batch to batch."""
    B = batch.tokens.shape[0]
    if B % n_ranks:
        raise ValueError(f"a batch of {B} utterances is not divisible by "
                         f"{n_ranks} ranks")
    b = B // n_ranks
    lo, hi = rank * b, rank * b + b
    counts = global_counts(batch.olens, batch.ilens)
    flat = batch.seg_classes is None
    classes = (SegClass(batch.seg_utt, batch.seg_tok, batch.seg_start,
                        batch.frame_mask, batch.position),) if flat \
        else batch.seg_classes
    shares, first, off_g, off_l, dcap = [], [], [], [], []
    og = ol = 0
    for sc in classes:
        P, D = sc.frame_mask.shape
        owner = np.where(sc.frame_mask[:, 0], np.asarray(sc.seg_utt) // b,
                         -1)
        per_rank = np.bincount(owner[owner >= 0], minlength=n_ranks)
        cap = max(_round_up(-(-P // n_ranks), 8),
                  _round_up(int(per_rank.max(initial=0)), 8))
        idx = np.nonzero(owner == rank)[0]
        k = len(idx)

        def take(x):
            out = np.zeros((cap,) + x.shape[1:], x.dtype)
            out[:k] = x[idx]
            return out

        seg_utt = take(np.asarray(sc.seg_utt))
        seg_utt[:k] -= lo
        shares.append(SegClass(seg_utt, take(np.asarray(sc.seg_tok)),
                               take(np.asarray(sc.seg_start)),
                               take(np.asarray(sc.frame_mask)),
                               take(np.asarray(sc.position))))
        first.append(int(idx[0]) if k else 0)
        off_g.append(og)
        off_l.append(ol)
        dcap.append(D)
        og += P * D
        ol += cap * D
    # utt_gather: global flat index -> (class, segment, frame) -> local
    g = np.asarray(batch.utt_gather[lo:hi]).astype(np.int64)
    mask = np.asarray(batch.utt_mask[lo:hi])
    off_g, off_l = np.asarray(off_g), np.asarray(off_l)
    first, dcap = np.asarray(first), np.asarray(dcap)
    c = np.searchsorted(off_g, g, side="right") - 1
    rel = g - off_g[c]
    local = off_l[c] + (rel // dcap[c] - first[c]) * dcap[c] + rel % dcap[c]
    utt_gather = np.where(mask, local, 0).astype(np.int32)

    def rows(x):
        return None if x is None else x[lo:hi]

    out = batch._replace(
        tokens=rows(batch.tokens), ilens=rows(batch.ilens),
        mel=rows(batch.mel), olens=rows(batch.olens),
        durations=rows(batch.durations), f0=rows(batch.f0),
        energy=rows(batch.energy), spembs=rows(batch.spembs),
        utt_gather=utt_gather, utt_mask=mask, counts=counts)
    if flat:
        sc = shares[0]
        return out._replace(seg_utt=sc.seg_utt, seg_tok=sc.seg_tok,
                            seg_start=sc.seg_start,
                            frame_mask=sc.frame_mask, position=sc.position)
    return out._replace(seg_classes=tuple(shares))


# --------------------------------------------------------------------------
# one process a card
# --------------------------------------------------------------------------

def free_port():
    """A free TCP port on this host for the ranks' rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device, rank):
    """Rank ``rank``'s device: "cuda" -> ``cuda:rank`` (a card a rank);
    an indexed CUDA device such as "cuda:0" -> that card for every rank
    (they share it, over gloo); "cpu" -> the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank)
    return dev


def _spawned(rank, fn, n, port, args, device, backend):
    dev = rank_device(device, rank)
    initialize(f"tcp://localhost:{port}", n, rank, backend=backend,
               device=dev)
    try:
        fn(dev, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs, args=(), device="cuda", backend=None):
    """Run ``fn(device, *args)`` in ``nprocs`` ranks on this host, each
    joined to one process group (``initialize``) before ``fn`` runs and
    taken out of it after; returns when every rank has ended and raises
    when one failed.  ``fn`` must be importable (a module-level function).
    ``device`` as in ``rank_device``; ranks that share a card need
    ``backend="gloo"``."""
    dev = torch.device(device)
    shared = dev.type == "cuda" and dev.index is not None
    if nprocs > 1 and shared and (backend or "nccl") == "nccl":
        raise ValueError(
            f"{nprocs} ranks on {dev} with backend='nccl': NCCL refuses two "
            "ranks on one device; pass device='cuda' (a card a rank) or "
            "backend='gloo'")
    import torch.multiprocessing as mp
    mp.spawn(_spawned, args=(fn, nprocs, free_port(), tuple(args), device,
                             backend), nprocs=nprocs, join=True)


def cli_ranks(n_devices, device):
    """The ranks a CLI run asks for: ``--n-devices``, or by default every
    visible card (JAX's "default: all"); one on the CPU or on an indexed
    card.  Under ``torchrun``, its ``WORLD_SIZE``."""
    if os.environ.get("WORLD_SIZE"):
        return int(os.environ["WORLD_SIZE"])
    if n_devices is not None:
        return n_devices
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and \
            torch.cuda.is_available():
        return torch.cuda.device_count()
    return 1


def run_ranks(fn, n, argv, device, backend=None):
    """A CLI's body ``fn(device, argv)`` as the run's ``n`` ranks: in this
    process when ``n`` is 1 or it already is a rank; under ``torchrun``
    as the rank its environment names (card ``LOCAL_RANK``); else in
    ``n`` spawned ranks (``spawn``), returning None.  Returns ``fn``'s
    result where it runs here."""
    if n == 1 or dist.is_initialized():
        return fn(torch.device(device), argv)
    if os.environ.get("WORLD_SIZE"):
        dev = rank_device(device, int(os.environ.get("LOCAL_RANK", 0)))
        initialize(backend=backend, device=dev)
        try:
            return fn(dev, argv)
        finally:
            dist.destroy_process_group()
    spawn(fn, n, args=(argv,), device=device, backend=backend)
    return None
