"""Device-resident dataset cache and on-device batch assembly (port of
``fcl_taco2_tpu/data/device_cache.py``).

Every utterance's padded feature rows (tokens, durations, mel, f0,
energy, lengths, speaker embedding) are uploaded once, train and
validation together, at the converter's corpus-fit shapes, with an
all-zero row N that stands for the converter's empty pad utterances.  A
batch then costs one packed int32 plan vector on the host (``plan``: the
utterance rows and the regroup plan's index arrays, a few tens of KB) and
one gather on the device (``assemble``).  The plan's dense halves,
``frame_mask`` and ``position``, are derived on the device from
``seg_dur`` as the JAX package derives them (``d < dur``, and the fp32
division ``d / dur``, which equals numpy's float64-then-float32 over the
whole ``d, dur <= 64`` domain), so the assembled ``Batch`` is bit-equal
to ``BatchConverter(utts)`` on the same utterances.

``assemble`` writes into preallocated batch buffers that live as long as
the cache: a CUDA graph of the train step reads them (``train/step.py``).
Call it on the stream that runs the step, as the trainer's loader does
(``data/loader.py``'s ``finish``), so a batch is not overwritten while
the previous step still reads it.

Batch membership changes every epoch under ``shuffle`` batching
(batchfy_fcl.py:291), so the cache holds per-utterance rows, never
converted batches.
"""

import numpy as np
import torch

from fcl_taco2_tpu_torch.data.manifest import load_spemb
from fcl_taco2_tpu_torch.models.taco2_sa import Batch, SegClass
from fcl_taco2_tpu_torch.utils.device import resolve_device


def _require_fixed(converter):
    if not (converter.fixed_tmax and converter.fixed_lmax):
        raise ValueError("device cache requires corpus-fit fixed shapes "
                         "(BatchConverter.fit_corpus)")
    if converter.transform is not None:
        raise ValueError("device cache cannot apply per-epoch host mel "
                         "transforms (preprocess_conf); disable one")
    if converter.duration_classes and converter.class_caps is None:
        raise ValueError("device cache with duration classes requires "
                         "corpus-fit class_caps")
    if not converter.duration_classes and not converter.fixed_nseg:
        raise ValueError("device cache requires a corpus-fit fixed_nseg "
                         "(one plan layout for the run)")


def _feature_key(u):
    """What an utterance's cache row is made from."""
    return (u.mel_path, u.dur_path, u.f0_path, u.energy_path, u.filetypes,
            u.spemb_path, u.spemb_filetype, u.eos_appended,
            tuple(int(t) for t in u.tokenids))


def distinct_utterances(utts):
    """One utterance per uttid, in first-seen order.  A validation
    utterance that is also a training one (``--valid-json`` equal to
    ``--train-json``, the quick-start pattern) shares its row; the same
    uttid with other features raises.  The JAX package raises on any
    repeat (``fcl_taco2_tpu/data/device_cache.py:116-117``), so its
    default trainer fails on such manifests."""
    seen = {}
    for u in utts:
        first = seen.setdefault(u.uttid, u)
        if first is not u and _feature_key(first) != _feature_key(u):
            raise ValueError(
                f"uttid {u.uttid} appears twice with different features: "
                f"{first.mel_path} and {u.mel_path} (durations "
                f"{first.dur_path} and {u.dur_path})")
    return list(seen.values())


def estimate_cache_bytes(converter, n_utts, spk_embed_dim=0):
    """Device bytes the cache will occupy (for the ``auto`` gate)."""
    T, L = converter.fixed_tmax, converter.fixed_lmax
    odim = converter.odim
    per = 4 * (T + T + L * odim + T + T + 2 + spk_embed_dim)
    return (n_utts + 1) * per


class DeviceBatchCache:
    """Built once per trainer: ``plan`` (host, numpy) and ``assemble``
    (device) stages of the loader.  ``device`` defaults to the card and
    raises when none is present."""

    def __init__(self, converter, utts, device="cuda"):
        self.device = resolve_device(device)
        _require_fixed(converter)
        self.converter = converter
        self.B = converter.batch_size
        self.Tmax = converter.fixed_tmax
        self.Lmax = converter.fixed_lmax
        self._rows = {}
        self._host_dur = []  # per-row true-length duration vectors
        self._build(utts)
        self.layout = self.static_layout()
        self.pack_len = int(sum(self.layout))
        self._offs = np.concatenate([[0], np.cumsum(self.layout)]).astype(
            int)
        self.batch = self._buffers()

    # ---------- one-time cache construction ----------

    def _build(self, utts):
        conv, T, L = self.converter, self.Tmax, self.Lmax
        utts = distinct_utterances(utts)
        N = len(utts)
        tokens = np.zeros((N + 1, T), np.int32)
        durs = np.zeros((N + 1, T), np.int32)
        mel = np.zeros((N + 1, L, conv.odim), np.float32)
        f0 = np.zeros((N + 1, T, 1), np.float32)
        en = np.zeros((N + 1, T, 1), np.float32)
        ilens = np.zeros(N + 1, np.int32)
        olens = np.zeros(N + 1, np.int32)
        spembs = None
        for i, u in enumerate(utts):
            self._rows[u.uttid] = i
            m, d, p, e = conv._features(u)
            nT, nL = u.n_tokens, m.shape[0]
            if int(d.sum()) != nL:
                raise ValueError(
                    f"{u.uttid}: durations sum {int(d.sum())} != mel "
                    f"frames {nL}")
            tokens[i, :nT] = u.tokenids
            durs[i, :nT] = d
            mel[i, :nL] = m
            f0[i, :nT] = p
            en[i, :nT] = e
            ilens[i] = nT
            olens[i] = nL
            self._host_dur.append(np.asarray(d, np.int32))
            v = load_spemb(u)
            if v is not None:
                if spembs is None:
                    if i:
                        raise ValueError(
                            "inconsistent speaker embeddings: every "
                            "utterance needs a spembs entry once any has "
                            "one")
                    spembs = np.zeros((N + 1, v.shape[0]), np.float32)
                spembs[i] = v
            elif spembs is not None:
                raise ValueError(
                    "inconsistent speaker embeddings: every utterance "
                    "needs a spembs entry once any has one")
        host = dict(tokens=tokens, durations=durs, mel=mel, f0=f0,
                    energy=en, ilens=ilens, olens=olens, spembs=spembs)
        self.bytes = sum(a.nbytes for a in host.values() if a is not None)
        # ONE upload for the whole run; a batch costs its plan pack only
        self.rows = {k: None if a is None
                     else torch.from_numpy(a).to(self.device)
                     for k, a in host.items()}

    def static_layout(self):
        """The packed plan vector's segment sizes: the utterance rows, the
        four per-segment index arrays (of each class), the frame map."""
        conv, B, L = self.converter, self.B, self.Lmax
        if conv.duration_classes:
            seg = [c for P_c in conv.class_caps for c in (P_c,) * 4]
        else:
            seg = [conv.fixed_nseg] * 4
        return tuple([B] + seg + [B * L])

    def _buffers(self):
        """The assembled batch's buffers, allocated once."""
        conv, B, T, L, dev = (self.converter, self.B, self.Tmax, self.Lmax,
                              self.device)
        r = self.rows

        def like(name, n):
            return r[name].new_empty((n,) + tuple(r[name].shape[1:]))

        def seg(P, D):
            i32 = dict(dtype=torch.int32, device=dev)
            return (torch.empty(P, **i32), torch.empty(P, **i32),
                    torch.empty(P, **i32),
                    torch.empty((P, D), dtype=torch.bool, device=dev),
                    torch.empty((P, D), dtype=torch.float32, device=dev))

        common = dict(
            tokens=like("tokens", B), ilens=like("ilens", B),
            mel=like("mel", B), olens=like("olens", B),
            durations=like("durations", B), f0=like("f0", B),
            energy=like("energy", B),
            spembs=None if r["spembs"] is None else like("spembs", B),
            utt_gather=torch.empty((B, L), dtype=torch.int32, device=dev),
            utt_mask=torch.empty((B, L), dtype=torch.bool, device=dev))
        if conv.duration_classes:
            classes = tuple(SegClass(*seg(P_c, D_c)) for P_c, D_c in
                            zip(conv.class_caps, conv.duration_classes))
            return Batch(seg_utt=None, seg_tok=None, seg_start=None,
                         frame_mask=None, position=None,
                         seg_classes=classes, **common)
        su, st, ss, fm, pos = seg(conv.fixed_nseg, conv.max_dur)
        return Batch(seg_utt=su, seg_tok=st, seg_start=ss, frame_mask=fm,
                     position=pos, **common)

    # ---------- per-batch host stage (the loader's convert step) ----------

    def plan(self, utts):
        """Utterance list -> the packed int32 plan vector (``pack_len``,),
        laid out as ``layout`` (``device_cache.py:149-183``)."""
        conv, B, T, L = self.converter, self.B, self.Tmax, self.Lmax
        n = len(utts)
        if n > B:
            raise ValueError(f"batch of {n} exceeds configured size {B}")
        idx = np.full(B, len(self._host_dur), np.int32)  # pad -> zero row
        durations = np.zeros((B, T), np.int32)
        olens = np.zeros(B, np.int32)
        for i, u in enumerate(utts):
            r = self._rows.get(u.uttid)
            if r is None:
                raise KeyError(f"{u.uttid} not in device cache")
            idx[i] = r
            d = self._host_dur[r]
            durations[i, :len(d)] = d
            olens[i] = int(d.sum())
        parts = [idx]
        if conv.duration_classes:
            plan = conv._build_classed_plan(durations, olens,
                                            conv.class_caps, L)
            for cp in plan.classes:
                parts += [cp.seg_utt, cp.seg_tok, cp.seg_start, cp.seg_dur]
        else:
            plan = conv._build_plan(durations, olens, conv.fixed_nseg, L)
            parts += [plan.seg_utt, plan.seg_tok, plan.seg_start,
                      plan.seg_dur]
        parts.append(plan.utt_gather.reshape(-1))
        if tuple(p.size for p in parts) != self.layout:
            raise ValueError("plan layout changed mid-run (fixed shapes "
                             "should make it constant)")
        return np.concatenate([p.reshape(-1).astype(np.int32)
                               for p in parts])

    # ---------- per-batch device stage ----------

    def assemble(self, packed):
        """Packed plan vector (a tensor on the cache's device, or numpy)
        -> the ``Batch`` buffers, written in place and returned."""
        if not isinstance(packed, torch.Tensor):
            packed = torch.from_numpy(np.asarray(packed, np.int32))
        packed = packed.to(self.device, non_blocking=True)
        conv, B, L, out = self.converter, self.B, self.Lmax, self.batch
        offs, r = self._offs, self.rows

        def part(j, n):
            return packed[offs[j]:offs[j] + n]

        idx = part(0, B)
        for name in ("tokens", "ilens", "mel", "olens", "durations", "f0",
                     "energy", "spembs"):
            if r[name] is not None:
                torch.index_select(r[name], 0, idx, out=getattr(out, name))
        torch.lt(torch.arange(L, dtype=torch.int32, device=self.device),
                 out.olens[:, None], out=out.utt_mask)
        out.utt_gather.copy_(part(len(self.layout) - 1, B * L).view(B, L))

        def fill(sc, j, P, D):
            sd = part(j + 3, P)
            sc.seg_utt.copy_(part(j, P))
            sc.seg_tok.copy_(part(j + 1, P))
            sc.seg_start.copy_(part(j + 2, P))
            d = torch.arange(D, dtype=torch.int32, device=self.device)
            torch.lt(d[None, :], sd[:, None], out=sc.frame_mask)
            # fp32 single-rounded division == the host plan's
            # float64-then-float32 for this domain (module docstring)
            pos = d.to(torch.float32)[None, :] \
                / torch.clamp(sd, min=1).to(torch.float32)[:, None]
            torch.where(sc.frame_mask, pos, pos.new_zeros(()), out=sc.position)

        if conv.duration_classes:
            for c, (P_c, D_c) in enumerate(zip(conv.class_caps,
                                               conv.duration_classes)):
                fill(out.seg_classes[c], 1 + 4 * c, P_c, D_c)
        else:
            fill(out, 1, conv.fixed_nseg, conv.max_dur)
        return out
