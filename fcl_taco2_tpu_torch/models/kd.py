"""Knowledge distillation: FCL-taco2-T teacher -> FCL-taco2-S student
(port of ``fcl_taco2_tpu/models/kd.py``).

The student carries bias-free projections to the teacher's widths
(``kd_proj``, a child module of the student ``Tacotron2SA``, so its
``state_dict`` is the JAX package's KD params tree through the bridge)
and adds four toggleable distillation losses (reference
``…_kd_student.py:759-801``):

1. output: L1 + MSE of student vs teacher mel, before and after the
   postnet;
2. encoder: MSE over [embed, conv0.., blstm];
3. decoder: MSE over [prenet, lstm0, lstm1, postnet layers];
4. prosody: MSE over [d_outs, p_outs, e_outs, p_embs, e_embs].

The frozen teacher runs in train mode (dropout on, BatchNorm on batch
statistics, its new statistics thrown away) under ``torch.no_grad``, from
a generator of its own; on a rank of a data-parallel run its BatchNorm
statistics are the global batch's, as the student's are (JAX runs the
teacher in train mode over the global batch, ``kd.py:117-125``).
Projections apply to the captured activations (linear maps commute with
the regrouping gathers).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from fcl_taco2_tpu_torch.models.taco2_sa import Tacotron2SA
from fcl_taco2_tpu_torch.ops.masking import (N_VALID, TOKENS, count_frames,
                                             lengths_to_non_pad_mask,
                                             masked_l1, masked_mse,
                                             weighted_l1, weighted_mse)
from fcl_taco2_tpu_torch.utils.initializers import init_linears_


class KDProj(nn.Module):
    """The student -> teacher projections (``kd.py:63-93``); with
    ``share_proj`` each list holds one projection shared by its layers."""

    def __init__(self, s, t, share_proj=True, device=None):
        super().__init__()

        def lin(d_in, d_out):
            return nn.Linear(d_in, d_out, bias=False, device=device)

        n_convs = 1 if share_proj else s.econv_layers
        n_lstm = 1 if share_proj else 2
        n_post = 1 if share_proj else s.postnet_layers - 1
        self.embed = lin(s.embed_dim, t.embed_dim)
        self.convs = nn.ModuleList(lin(s.econv_chans, t.econv_chans)
                                   for _ in range(n_convs))
        self.blstm = lin(s.eunits, t.eunits)
        self.prenet = lin(s.prenet_units, t.prenet_units)
        self.lstm = nn.ModuleList(lin(s.dunits, t.dunits)
                                  for _ in range(n_lstm))
        self.post = nn.ModuleList(lin(s.postnet_chans, t.postnet_chans)
                                  for _ in range(n_post))
        self.pemb = lin(s.eunits, t.eunits)
        self.eemb = lin(s.eunits, t.eunits)


def _proj(lin, x):
    """``x @ w`` in fp32: JAX promotes a bf16 activation times the fp32
    projection to fp32 (``kd.py:38-39``)."""
    return F.linear(x.float(), lin.weight)


def _pick(plist, i):
    return plist[0] if len(plist) == 1 else plist[i]


def _knowledge_mse(students, teachers, mask, count=None):
    """Sum of masked-mean MSEs over tensor pairs, accumulated in fp32
    whatever the compute dtype (``kd.py:98-107``); ``count`` as in
    ``ops.masking.masked_mse``."""
    total = 0.0
    for s_item, t_item in zip(students, teachers):
        total = total + masked_mse(s_item.float(), t_item.float(), mask,
                                   count)
    return total


def teacher_generator(generator):
    """The teacher's generator of a step: the step's own.  The teacher's
    forward draws first and the student's continues from the state it
    leaves, so the two draw disjoint parts of one counter-based stream
    (JAX's ``random.split(rng)``), on the device, with nothing read on the
    host: a CUDA graph of the KD step replays fresh draws for both."""
    return generator


class KDStudent:
    """Student model + projections + the KD loss (``kd.py:43-201``).

    ``student`` is a ``Tacotron2SA`` of ``student_cfg`` with the
    projections as its ``kd_proj`` child; ``teacher`` a ``Tacotron2SA``
    of ``teacher_cfg`` whose parameters take no gradient (load its
    weights with ``train.checkpoint.load_params_only``).  Both live on
    ``device``, the card unless ``device="cpu"``; weights are drawn from
    ``seed`` (the projections from ``seed + 1``).
    """

    def __init__(self, student_cfg, teacher_cfg, share_proj=True,
                 distill_output=True, distill_encoder=True,
                 distill_decoder=True, distill_prosody=True, device="cuda",
                 seed=0):
        for name, cfg in (("student", student_cfg), ("teacher", teacher_cfg)):
            if (cfg.elayers != 1 or cfg.dlayers != 2
                    or cfg.reduction_factor != 1 or cfg.prenet_layers == 0
                    or cfg.postnet_layers == 0 or cfg.econv_layers == 0):
                raise ValueError(
                    f"KD requires the reference KD topology for the {name} "
                    "(elayers=1, dlayers=2, reduction_factor=1, convs, "
                    "prenet and postnet present): the KD modules hard-code "
                    "these captures (encoder_sa_kd.py:144-197, "
                    "decoder_sa_kd.py:627-702)")
        if (student_cfg.econv_layers != teacher_cfg.econv_layers
                or student_cfg.postnet_layers != teacher_cfg.postnet_layers):
            raise ValueError("KD requires matching encoder-conv and postnet "
                             "depths between student and teacher")
        self.student = Tacotron2SA(student_cfg, device=device, seed=seed)
        self.student.kd_proj = init_linears_(
            KDProj(student_cfg, teacher_cfg, share_proj,
                   device=self.student.device),
            torch.Generator().manual_seed(seed + 1))
        self.teacher = Tacotron2SA(teacher_cfg, device=device, seed=seed)
        self.teacher.requires_grad_(False)
        self.scfg = student_cfg
        self.tcfg = teacher_cfg
        self.distill_output = distill_output
        self.distill_encoder = distill_encoder
        self.distill_decoder = distill_decoder
        self.distill_prosody = distill_prosody

    def loss_fn(self, batch, generator, train=True):
        """Student losses + distillation losses (``kd.py:111-201``).

        ``generator``: the step's generator (the student's draws); the
        teacher draws from ``teacher_generator(generator)``.  Returns
        ``(loss, (report, new_state, None))`` as ``Tacotron2SA.loss_fn``;
        ``new_state`` is the student's (the teacher's is discarded)."""
        with torch.no_grad():
            _, (_, _, t_know) = self.teacher.loss_fn(
                batch, teacher_generator(generator), train=train,
                capture_kd=True)
        loss, (report, new_state, s_know) = self.student.loss_fn(
            batch, generator, train=train, capture_kd=True)
        report = dict(report)
        proj = self.student.kd_proj
        Tmax, Lmax = batch.tokens.shape[1], batch.mel.shape[1]
        in_mask = lengths_to_non_pad_mask(batch.ilens, Tmax)[..., None]
        out_mask = lengths_to_non_pad_mask(batch.olens, Lmax)[..., None]
        # a rank's share of a global batch divides by the global counts
        g = batch.counts
        n_in = None if g is None else g[TOKENS]
        n_out = None if g is None else count_frames(g)
        terms = {}

        if self.distill_output:
            sa, ta = s_know["after_outs"].float(), t_know["after_outs"].float()
            sb, tb = (s_know["before_outs"].float(),
                      t_know["before_outs"].float())
            if self.scfg.use_weighted_masking:
                # the one KD criterion whose weighted path works in the
                # reference (…_kd_student.py:72-80); the knowledge terms
                # stay masked means (kd.py:141-155)
                n_valid = torch.sum(batch.olens > 0).float() \
                    if g is None else g[N_VALID]
                terms["output_l1_loss"] = (
                    weighted_l1(sa, ta, out_mask, n_valid)
                    + weighted_l1(sb, tb, out_mask, n_valid))
                terms["output_mse_loss"] = (
                    weighted_mse(sa, ta, out_mask, n_valid)
                    + weighted_mse(sb, tb, out_mask, n_valid))
            else:
                terms["output_l1_loss"] = (
                    masked_l1(sa, ta, out_mask, n_out)
                    + masked_l1(sb, tb, out_mask, n_out))
                terms["output_mse_loss"] = (
                    masked_mse(sa, ta, out_mask, n_out)
                    + masked_mse(sb, tb, out_mask, n_out))

        if self.distill_encoder:
            s_embed, *s_convs, s_blstm = s_know["encoder"]
            s_items = [_proj(proj.embed, s_embed)]
            s_items += [_proj(_pick(proj.convs, i), sc)
                        for i, sc in enumerate(s_convs)]
            s_items.append(_proj(proj.blstm, s_blstm))
            terms["encoder_loss"] = _knowledge_mse(
                s_items, t_know["encoder"], in_mask, n_in)

        if self.distill_decoder:
            s_pre, s_l0, s_l1, *s_post = s_know["decoder"]
            s_items = [_proj(proj.prenet, s_pre),
                       _proj(_pick(proj.lstm, 0), s_l0),
                       _proj(_pick(proj.lstm, 1), s_l1)]
            # postnet layers 0..n-2 projected; the last (odim wide) is
            # compared directly (kd.py:180-185)
            s_items += [_proj(_pick(proj.post, i), sp)
                        for i, sp in enumerate(s_post[:-1])]
            s_items.append(s_post[-1])
            terms["decoder_loss"] = _knowledge_mse(
                s_items, t_know["decoder"], out_mask, n_out)

        if self.distill_prosody:
            s_d, s_p, s_e, s_pe, s_ee = s_know["prosody"]
            s_items = [s_d, s_p, s_e, _proj(proj.pemb, s_pe),
                       _proj(proj.eemb, s_ee)]
            terms["prosody_loss"] = _knowledge_mse(
                s_items, t_know["prosody"], in_mask, n_in)

        for name, term in terms.items():
            loss = loss + term
            report[name] = term.detach()
        report["loss"] = loss.detach()
        return loss, (report, new_state, None)
