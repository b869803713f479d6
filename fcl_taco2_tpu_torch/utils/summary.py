"""Model-size reporting: per-submodule trainable parameter counts (port of
``fcl_taco2_tpu/utils/summary.py``).

The reference prints per-module parameter counts at model construction
(e2e_tts_tacotron2_sa.py:483-517, ..._kd_student.py:625-670).  The counts
here are keyed by the top-level modules of the JAX package's params tree
(``encoder``, ``decoder``, ``duration_predictor``, ..., ``kd_proj``),
read through the weight bridge, so they equal the JAX package's.
BatchNorm running statistics are buffers, not counted.
"""

from fcl_taco2_tpu_torch.utils.params import jax_path


def param_counts(model):
    """{top-level submodule: #params} plus 'total'."""
    counts = {}
    for name, p in model.named_parameters():
        top = str(jax_path(name)[0])
        counts[top] = counts.get(top, 0) + p.numel()
    counts["total"] = sum(counts.values())
    return counts


def format_param_report(model, title="model"):
    counts = param_counts(model)
    total = counts.pop("total")
    lines = [f"{title} parameters:"]
    for name in sorted(counts):
        lines.append(f"  {name:<22s} {counts[name]:>12,d}")
    lines.append(f"  {'TOTAL':<22s} {total:>12,d}  "
                 f"({total * 4 / 2 ** 20:.1f} MB fp32)")
    return "\n".join(lines)
