"""What decides `correct`: the program's outputs of the timed path against the
plain reference's, each number beside its limit.

Decode cells: for each judged recording, the averaged probabilities P the
program took the argmax of against the reference's R over the same
recording, windows and averaging:
  kl_mean       the mean over rows of KL(R || P), the worst judged
                recording's;
and, logged only, ||P - R|| / ||R|| and the gaps by which the chosen class
lies below the reference's best (they do not separate the control).

Train cells: the reference follows the program's first steps from the
same weights over chunks it works out again from the raw corpus
(`reference/data.py`, `reference/train.py`):
  feed_mismatch  1 where the program's chunks differ from the reference's;
  grad1_gap      the first gradient as the optimizer got it (MADGRAD's
                 `s` after one step over its lamb), by the worst leaf:
                 | ||g|| - ||g_ref|| | / max(||g_ref||, the median leaf's);
  grad1_median_gap  the same gap of the median leaf: steady from seed to
                 seed where the worst leaf's swings;
  update_gap     the parameters' change after the steps, by the worst leaf,
                 the same way;
leaves whose reference gradient is under a thousandth of the median
leaf's are left out of update_gap (they move by round-off alone).

A cell compares the readings its file's `limits` name (`loss1_rel`, the
first step's |loss - loss_ref| / loss_ref, is one more); a cell whose file
names none is never correct.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from lcbench.harness import flops as F
from lcbench.harness import program

Check = Tuple[str, float, float]


def forward_flops(cfg: dict, frames: int) -> float:
    return F.forward_flops(cfg["model_class"], program.model_kwargs(cfg), frames)


def reference_module(cfg: dict):
    from lcbench.reference import mamba, sconformer

    return {"SCConformerXL": sconformer, "Mamba": mamba}[cfg["model_class"]]


def reference_weights(ctx, shapes):
    from lcbench.harness.weights import seeded_tensors

    return seeded_tensors(shapes, ctx.seed, ctx.device)


def decode_checks(ctx, kept: Dict[int, tuple], pool: list, n_classes: int,
                  shapes) -> List[Check]:
    import torch

    from lcbench.reference.decode import averaged_probs
    from lcbench.reference.layers import fp32_products

    if not kept:
        return [("judged_recordings", 0.0, -1.0)]
    cfg, tr = ctx.config, ctx.traffic
    ref = reference_module(cfg)
    p = reference_weights(ctx, shapes)
    mcfg = program.model_kwargs(cfg)
    stats = ref.eval_stats(p, mcfg)
    worst = dict.fromkeys(DECODE_READINGS, 0.0)
    with fp32_products():
        for n, (probs, ids) in sorted(kept.items()):
            spec = torch.from_numpy(pool[n % len(pool)][0]).to(ctx.device)
            R = averaged_probs(lambda a, ln: ref.forward(p, mcfg, a, ln, stats=stats),
                               spec, tr["seq_len"], tr["overlap"], n_classes)
            if probs.shape != R.shape:
                return [("shape_mismatch", 1.0, 0.0)]
            for k, v in decode_readings(probs.to(R.device).float(), R, ids).items():
                worst[k] = max(worst[k], v)
            del R
    from lcbench.harness.runner import log

    log("decode readings, the worst judged recording's: " + ", ".join(
        f"{k} {v!r}" for k, v in worst.items()))
    return compared(ctx, worst)


DECODE_READINGS = ("prob_rel_l2", "logp_gap_max", "logp_gap_mean", "kl_mean")


def compared(ctx, readings: dict) -> List[Check]:
    """The readings the cell's limits name, each beside its limit: which
    numbers separate a cell's sound runs from its control is a finding of
    that cell (PERF.md), so its file names them."""
    limits = ctx.workload.get("limits", {})
    unknown = set(limits) - set(readings)
    if unknown:
        raise KeyError(f"limits for readings that are not taken: {sorted(unknown)}")
    return [(k, readings[k], float(limits[k])) for k in sorted(limits)]


def decode_readings(P, R, ids) -> dict:
    """The numbers compared for one recording (see the module docstring)."""
    import torch

    logR = torch.log(R)
    chosen = logR.gather(1, torch.as_tensor(ids, device=R.device).long()[:, None])[:, 0]
    gap = logR.max(-1).values - chosen
    kl = (R * (logR - torch.log(P.clamp_min(1e-30)))).sum(-1)
    return {"prob_rel_l2": float((P - R).norm() / R.norm()),
            "logp_gap_max": float(gap.max()),
            "logp_gap_mean": float(gap.mean()),
            "kl_mean": float(kl.mean())}


def _leaf_gaps(prog: Dict[str, float], refn: Dict[str, float], names, what: str):
    """(the worst leaf's, the median leaf's) | ||a|| - ||b|| | over
    max(||b||, the median leaf's ||b||)."""
    from lcbench.harness.runner import log

    vals = sorted(refn[n] for n in names)
    med = vals[len(vals) // 2] if vals else 0.0
    gaps = sorted((abs(prog[n] - refn[n]) / max(refn[n], med, 1e-30), n) for n in names)
    if gaps:
        g, n = gaps[-1]
        log(f"{what}: worst leaf {n} ({prog[n]!r} against {refn[n]!r}), median leaf's gap "
            f"{gaps[len(gaps) // 2][0]!r}, median leaf's norm {med!r}")
    return (gaps[-1][0], gaps[len(gaps) // 2][0]) if gaps else (0.0, 0.0)


def train_checks(ctx, readings: dict, refr: dict, weights0: dict) -> List[Check]:
    """`readings`: the program's {'loss': [...], 'grad1': {name: norm},
    'params': {name: tensor after the steps}}; `refr`: the reference's
    follow(); `weights0`: the seeded weights both started from."""
    from lcbench.harness.runner import log

    losses = readings["loss"]
    log(f"losses by step: {losses!r} against {refr['loss']!r}")
    rel = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses, refr["loss"])]
    log(f"loss gaps by step: {rel!r}")
    names = sorted(refr["grad1"])
    g_ref = {n: float(refr["grad1"][n].norm()) for n in names}
    grad_gap, grad_median = _leaf_gaps(readings["grad1"], g_ref, names, "first gradient")
    med = sorted(g_ref.values())[len(names) // 2]
    moved = [n for n in names if g_ref[n] >= 1e-3 * med]
    d_ref = {n: float((refr["params"][n] - weights0[n]).norm()) for n in moved}
    d_prog = {n: float((readings["params"][n].to(weights0[n].device) - weights0[n]).norm())
              for n in moved}
    upd_gap, _ = _leaf_gaps(d_prog, d_ref, moved, "change after the steps")
    return compared(ctx, {"loss1_rel": rel[0], "grad1_gap": grad_gap,
                          "grad1_median_gap": grad_median, "update_gap": upd_gap})
