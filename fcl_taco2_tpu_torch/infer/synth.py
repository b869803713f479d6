"""Batched multi-utterance synthesis with speed metrics (port of
``fcl_taco2_tpu/infer/synth.py``).

Kept: bucketed ``(B, Tmax, budget)`` shapes, the exact re-dispatch when
predicted durations overrun the frame budget, the frames/s stats,
``quantize="int8"`` with the codes prepared once at init, and manifest
decoding (``synth_manifest``: feats.ark/feats.scp, per-utterance speed
lines and a summary) with one batch's work in flight while the previous
batch is read back.

Compiled as in JAX (``synth.py:111-171``): on the card the whole
``synthesize`` of a batch is one CUDA graph per ``(B, Tmax, budget,
use_dur)`` (``utils/graphs.py``), captured before the batch's timed
window starts, as JAX's compile is; ``d_factor`` is an input, not part of
the key.  A replay draws from the caller's generator at its state, so the
exact re-dispatch from the saved state draws the same dropout.  Every
decoder route is graphed (the scan and ``hybrid`` run their loops to the
static step count, ``models/decoder.py``).  Sharded serving over NCCL is
graphed with its gather's all-reduce inside each rank's graph; over gloo,
whose collectives cannot be captured, it stays eager (said once).

Sharded serving (``mesh``, ``synth.py:92-164``): every rank gets the same
utterances, runs the whole ``synthesize`` on its contiguous share of the
batch's rows (the fused decoder kernels run per rank, on the rank's
card) and the outputs are gathered to every rank.  The gather is one
``all_reduce`` of a zero-filled buffer in which each rank writes its own
rows (exact: every other rank adds zeros), because gloo, which carries
ranks that share one card, reduces and broadcasts CUDA tensors but
gathers none.  The prenet dropout's generator is the same on every rank,
as JAX replicates the key.

The model decides what its lengths take, through four methods:
``serve_options`` (its serving keywords, made once), ``serve_plan`` (the
frames a batch needs, whether that is exact, and the per-utterance
targets padded), ``serve`` (``synthesize`` with those targets) and, where
a plan can fall short, ``frames_needed``.  ``Tacotron2SA``'s targets are
durations; ``Tacotron2``'s (``models/tacotron2.py``) are pinned lengths
(``lengths=``, espnet's minlen = maxlen), else each row stops at its stop
token within ``maxlenratio`` times its phonemes.  A model that gives stop
logits has them in the stats.

Host spans (``utils/spans.py``): ``serve.prepare`` (padding, the copies
to the card), ``serve.launch`` (the graph's call) and ``serve.readback``
(starting the copy to the host; waiting for it and slicing); the graph's
own are the model's ``synthesize``'s.
"""

import math
import os
import time
from typing import List, Optional

import numpy as np
import torch

from fcl_taco2_tpu_torch.infer.ark import ArkScpWriter
from fcl_taco2_tpu_torch.ops.rnn import step_seed
from fcl_taco2_tpu_torch.parallel.mesh import capture_plan
from fcl_taco2_tpu_torch.utils.device import resolve_device
from fcl_taco2_tpu_torch.utils.graphs import Graphed
from fcl_taco2_tpu_torch.utils.spans import span


def _round_up(x, mult):
    return int(math.ceil(max(x, 1) / mult) * mult)


class Synthesizer:
    def __init__(self, model, batch_size=8, tok_bucket=32,
                 frame_per_token=16, frame_bucket=256, ragged_decode=True,
                 quantize="none", decoder_backend="auto", device="cuda",
                 mesh=None):
        """``model``: a ``Tacotron2SA`` or a ``Tacotron2``; it is moved to
        ``device`` (the card unless ``device="cpu"``), and its parameters
        are cast to the config's compute dtype once here — the JAX
        package casts inside every call, to the same values.
        ``quantize``, ``decoder_backend``, ``ragged_decode``: the model's
        ``serve_options`` (for ``Tacotron2SA``: int8 on the streaming
        decoder entry only, its codes prepared once here).
        ``mesh``: the serving ranks (``parallel/mesh.py``); ``batch_size``
        must divide by their number."""
        if mesh is not None and batch_size % mesh.size:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"mesh size {mesh.size}")
        self.mesh = mesh if mesh is not None and mesh.distributed else None
        self.device = resolve_device(device)
        self.model = model.to(self.device).compute_model()
        self.options = self.model.serve_options(
            quantize=quantize, decoder_backend=decoder_backend,
            ragged_decode=ragged_decode, sharded=self.mesh is not None)
        self.batch_size = batch_size
        self.tok_bucket = tok_bucket
        self.frame_per_token = frame_per_token
        self.frame_bucket = frame_bucket
        ok, mesh = capture_plan(self.mesh, "Synthesizer (sharded serving)") \
            if self.device.type == "cuda" else (False, None)
        self.graphs = Graphed(self._graph_body, self.device, "synthesize",
                              mesh=mesh)
        self.graphed = ok

    def _graph_body(self, inputs, gen):
        tokens, ilens, targets, d_factor, given, budget = inputs
        return self._sharded(tokens, ilens, targets, given, gen, budget,
                             d_factor)

    def _inputs(self, tokens, ilens, targets, given, budget, d_factor):
        return (tokens, ilens, targets,
                torch.tensor(float(d_factor), dtype=torch.float32),
                bool(given), int(budget))

    def _prepare(self, args, gen, budget, d_factor):
        """Capture the batch's graph (when new), outside the timed
        window."""
        if self.graphed:
            self.graphs.prepare(None, self._inputs(*args, budget, d_factor),
                                gen)

    def _run(self, tokens, ilens, targets, given, gen_state, gen, budget,
             d_factor):
        gen.set_state(gen_state)  # a re-dispatch draws the same dropout
        if self.graphed:
            return self.graphs(None, self._inputs(
                tokens, ilens, targets, given, budget, d_factor), gen)
        return self._sharded(tokens, ilens, targets, given, gen, budget,
                             d_factor)

    def _sharded(self, tokens, ilens, targets, given, gen, budget,
                 d_factor):
        """The model's ``serve`` of the batch; on a mesh of this rank's
        rows, the outputs gathered from every rank."""
        if self.mesh is None:
            return self._serve(tokens, ilens, targets, given, gen, budget,
                               d_factor)
        b = tokens.shape[0] // self.mesh.size
        rows = slice(self.mesh.rank * b, self.mesh.rank * b + b)
        out = self._serve(tokens[rows], ilens[rows], targets[rows], given,
                          gen, budget, d_factor)
        return {k: None if v is None else self._gather(v, rows)
                for k, v in out.items()}

    def _serve(self, tokens, ilens, targets, given, gen, budget, d_factor):
        return self.model.serve(tokens, ilens, gen, budget,
                                targets if given else None, d_factor,
                                **self.options)

    def _gather(self, part, rows):
        """Every rank's rows of an output: each rank fills its own rows of
        a zero buffer and the buffers are summed."""
        full = part.new_zeros((self.batch_size,) + tuple(part.shape[1:]))
        full[rows] = part
        return self.mesh.all_reduce_(full)

    def _dispatch(self, token_lists, rng, targets=None, d_factor=1.0,
                  before_capture=None):
        """Launch one padded batch and start copying its result to the
        host; returns the pending batch for ``_consume``.  On the card the
        mel and olens go to pinned memory by non-blocking copies followed
        by an event, so the host is free to dispatch the next batch before
        this one is read back.  ``before_capture``: called first when the
        batch's bucket has no graph yet (``synth_manifest`` finishes the
        batch in flight then, so no batch's wall holds a capture)."""
        n = len(token_lists)
        B = self.batch_size
        if n > B:
            raise ValueError(f"{n} utterances > batch_size {B}")
        Tmax = _round_up(max(len(t) for t in token_lists), self.tok_bucket)
        need, exact, padded = self.model.serve_plan(
            token_lists, targets, B, Tmax, d_factor, self.frame_per_token)
        budget = _round_up(need, self.frame_bucket)
        with span("serve.prepare"):
            tokens = np.zeros((B, Tmax), np.int64)
            ilens = np.zeros(B, np.int64)
            for i, t in enumerate(token_lists):
                tokens[i, :len(t)] = t
                ilens[i] = len(t)
            dev = self.device
            args = (torch.from_numpy(tokens).to(dev),
                    torch.from_numpy(ilens).to(dev),
                    torch.from_numpy(padded).to(dev), targets is not None)
        if isinstance(rng, torch.Generator):
            gen = rng
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(rng))
        gen_state = gen.get_state()
        if before_capture is not None and self.graphed and \
                not self.graphs.captured(None, self._inputs(
                    *args, budget, d_factor)):
            before_capture()
        self._prepare(args, gen, budget, d_factor)

        t0 = time.perf_counter()
        with span("serve.launch"):
            out = self._run(*args, gen_state, gen, budget, d_factor)
        with span("serve.readback"):
            host = _start_readback(out)
        return {"out": out, "host": host, "t0": t0, "n": n,
                "budget": budget, "args": args, "gen": gen,
                "gen_state": gen_state, "d_factor": d_factor,
                "exact": exact}

    def _consume(self, pend):
        """Wait for a pending batch's copy; returns (mels, stats).  The
        wall clock runs from its dispatch to the end of its readback."""
        n, budget = pend["n"], pend["budget"]
        with span("serve.readback"):
            mel, olens, stop = _finish_readback(pend["host"])
            wall = time.perf_counter() - pend["t0"]

        # never return truncated mels: when a guessed budget falls short
        # (predicted durations), the model knows the exact need from the
        # answer, so re-dispatch once at the exact bucket
        redispatched = 0
        while not pend["exact"] and int((olens[:n] >= budget).sum()):
            need = self.model.frames_needed(pend["out"], n)
            new_budget = _round_up(need, self.frame_bucket)
            if new_budget <= budget:
                break  # budget boundary hit exactly; nothing was dropped
            budget = new_budget
            redispatched += 1
            self._prepare(pend["args"], pend["gen"], budget,
                          pend["d_factor"])
            t0 = time.perf_counter()
            out = self._run(*pend["args"], pend["gen_state"], pend["gen"],
                            budget, pend["d_factor"])
            mel, olens, stop = _finish_readback(_start_readback(out))
            wall = time.perf_counter() - t0

        with span("serve.readback"):
            mels = [mel[i, :olens[i]] for i in range(n)]
        total_frames = int(olens[:n].sum())
        fps = total_frames / wall if wall > 0 else float("inf")
        stats = {"frames_per_sec": fps, "wall_sec": wall,
                 "total_frames": total_frames, "truncated": 0,
                 "redispatched": redispatched, "budget": budget}
        if stop is not None:
            stats["stop"] = [stop[i, :olens[i]] for i in range(n)]
        return mels, stats

    def synth_batch(self, token_lists: List[np.ndarray], rng,
                    durations: Optional[List[np.ndarray]] = None,
                    d_factor: float = 1.0,
                    lengths: Optional[List[int]] = None):
        """Synthesize a batch of token sequences; returns (mels, stats).

        ``rng``: int seed or ``torch.Generator`` (on the model's device)
        for the prenet dropout.  ``durations`` (``Tacotron2SA``) or
        ``lengths`` (``Tacotron2``: each utterance's frames, pinned): the
        model's targets.  mels: list of (L_i, odim) float32 numpy; stats:
        frames/s over the whole batch call (wall clock includes the copy
        back to the host) and, where the model gives them, ``stop``: each
        utterance's stop logits."""
        if durations is not None and lengths is not None:
            raise ValueError("give durations or lengths, not both")
        return self._consume(self._dispatch(
            token_lists, rng,
            targets=durations if lengths is None else lengths,
            d_factor=d_factor))

    def synth_manifest(self, utts, out_dir, write_ark=True, rng=0,
                       label="decode", use_gt_durations=False, d_factor=1.0):
        """Decode a manifest shard; returns mean frames/s
        (``synth.py:269-344``).

        Writes feats.ark/feats.scp (PWG-compatible) and ``<label>.txt``:
        one speed line an utterance (its frames over its batch's wall),
        then mean, total, p50 and p95 frames/s.  ``rng``: int seed; batch
        k draws from a generator seeded by ``(rng, k)``, so two runs with
        one seed write the same arks.  ``use_gt_durations`` feeds the
        corpus durations instead of the predictor (the reference's dur=
        knob, e2e_tts_tacotron2_sa.py:642-646).  On a mesh every rank
        decodes and rank 0 alone writes the files."""
        from fcl_taco2_tpu_torch.data.manifest import load_durations

        writes = self.mesh is None or self.mesh.rank == 0
        os.makedirs(out_dir, exist_ok=True)
        writer = ArkScpWriter(os.path.join(out_dir, "feats.ark"),
                              os.path.join(out_dir, "feats.scp")) \
            if write_ark and writes else None
        speeds = []
        utt_lines = []
        total_frames = 0
        t_start = time.perf_counter()

        def finish(chunk, pend):
            mels, stats = self._consume(pend)
            speeds.append(stats["frames_per_sec"])
            for u, m in zip(chunk, mels):
                fps_u = (m.shape[0] / stats["wall_sec"]
                         if stats["wall_sec"] > 0 else float("inf"))
                utt_lines.append(
                    f"{u.uttid} frames {m.shape[0]} "
                    f"batch_wall_sec {stats['wall_sec']:.4f} "
                    f"frames_per_sec {fps_u:.1f}\n")
            if writer:
                for u, m in zip(chunk, mels):
                    writer.write(u.uttid, m)
            return stats["total_frames"]

        # 1-deep pipeline: batch k+1 is dispatched before batch k is read
        # back, so the device's work overlaps the host's readback and IO;
        # each batch's wall still runs from its dispatch to its readback
        # (a new bucket's capture waits for the batch in flight)
        pending = None

        def flush():
            nonlocal pending, total_frames
            if pending is not None:
                total_frames += finish(*pending)
                pending = None

        try:
            for k, i in enumerate(range(0, len(utts), self.batch_size)):
                chunk = utts[i:i + self.batch_size]
                gen = torch.Generator(device=self.device)
                gen.manual_seed(step_seed(int(rng), k))
                durs = None
                if use_gt_durations:
                    durs = [load_durations(u) for u in chunk]
                disp = self._dispatch([u.tokenids for u in chunk], gen,
                                      targets=durs, d_factor=d_factor,
                                      before_capture=flush)
                flush()
                pending = (chunk, disp)
            flush()
        finally:
            if writer:
                writer.close()
        total_wall = time.perf_counter() - t_start
        mean_fps = float(np.mean(speeds)) if speeds else 0.0
        total_fps = total_frames / total_wall if total_wall > 0 else 0.0
        if not writes:
            return mean_fps
        with open(os.path.join(out_dir, f"{label}.txt"), "w") as f:
            f.writelines(utt_lines)
            f.write(f"mean_frames_per_sec {mean_fps:.1f}\n")
            f.write(f"total_frames_per_sec {total_fps:.1f}\n")
            if speeds:  # batch-throughput distribution (p50/p95)
                f.write("p50_frames_per_sec "
                        f"{float(np.percentile(speeds, 50)):.1f}\n")
                f.write("p95_frames_per_sec "
                        f"{float(np.percentile(speeds, 95)):.1f}\n")
        return mean_fps


def _start_readback(out):
    """Start copying a batch's mel, olens and stop logits (None where the
    model gives none) to the host: pinned buffers, non-blocking copies and
    an event on the card; the tensors themselves on the CPU."""
    ts = [out["mel"], out["olens"], out.get("stop")]
    if not ts[0].is_cuda:
        return ts, None
    host = []
    for t in ts:
        h = None
        if t is not None:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
        host.append(h)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _finish_readback(host):
    """Wait for ``_start_readback``'s copies; returns numpy (mel, olens,
    stop or None)."""
    ts, event = host
    if event is not None:
        event.synchronize()
    return tuple(None if t is None else t.numpy() for t in ts)
