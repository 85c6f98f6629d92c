"""The numbers that decide ``correct``: what the timed path produced,
held against the plain reference on the same weights and inputs. Each
number has a limit of its own, kept in ``portbench/limits/<cell>.json``
with the readings it was set from. The program's outputs come in as plain
tensors; this module reads them only to judge them."""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

INF = float("inf")


def serve_numbers(ref: Dict, prog: Dict, arch, cfg, threshold: float
                  ) -> Dict[str, float]:
    """A served batch against the reference's float32 outputs:

    - ``logits``: the widest gap of a class logit, over the largest
      reference logit (at least 1);
    - ``logits_rms``: the root mean square of the logits' gaps over that of
      the reference's logits;
    - ``boxes``: the widest gap of a box coordinate (relative units);
    - ``served``: the widest gap of a served detection's box coordinate or
      score from the reference's box of its query and the reference's score
      of the label served (a label the reference ranks lower reads as the
      gap of the two scores).

    The served detections of an image are its kept queries in order (the
    program's keep rule on its own logits); a count that differs reads
    infinite."""
    r_logits = ref["pred_logits"].float()
    r_boxes = ref["pred_boxes"].float()
    dev = r_logits.device
    p_logits = prog["logits"].float().to(dev)
    p_boxes = prog["boxes"].float().to(dev)
    gap = p_logits - r_logits
    out = {"logits": float(gap.abs().max()
                           / max(1.0, float(r_logits.abs().max()))),
           "logits_rms": float(gap.pow(2).mean().sqrt()
                               / r_logits.pow(2).mean().sqrt()),
           "boxes": float((p_boxes - r_boxes).abs().max()),
           "served": 0.0}
    _, _, p_keep = arch.postprocess(p_logits, cfg, threshold)
    for b, (boxes, labels, scores) in enumerate(prog["served"]):
        idx = p_keep[b].nonzero()[:, 0]
        if not len(idx) == len(boxes) == len(labels) == len(scores):
            out["served"] = INF
            continue
        if len(idx):
            labels = labels.to(dev).long()
            box_gap = (boxes.to(dev).float() - r_boxes[b, idx]).abs().max()
            score_gap = (scores.to(dev).float() - arch.label_scores(
                r_logits[b, idx], labels, cfg)).abs().max()
            out["served"] = max(out["served"], float(box_gap),
                                float(score_gap))
    return out


def served_by(outputs: Dict, arch, cfg, threshold: float) -> List:
    """What a detector whose outputs these are serves, per image: (boxes,
    labels, scores) of its kept queries, by the published keep rule; the
    control put in the program's place serves this."""
    labels, scores, keep = arch.postprocess(outputs["pred_logits"], cfg,
                                            threshold)
    return [(outputs["pred_boxes"][b][keep[b]], labels[b][keep[b]],
             scores[b][keep[b]]) for b in range(keep.shape[0])]


def worst(values: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """The largest reading of each number over several comparisons."""
    out: Dict[str, float] = {}
    for v in values:
        for k, x in v.items():
            out[k] = max(out.get(k, 0.0), x)
    return out


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: Sequence[str]) -> Dict[str, float]:
    """Each leaf's gap of norms, over the larger of that leaf's reference
    norm and the median leaf's."""
    med = statistics.median(ref[k] for k in leaves)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in leaves}


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The first steps of training against the reference's:

    - ``loss``: the widest relative gap of a step's loss; ``loss_step1``:
      the first step's;
    - ``grad``: per leaf, the gap of the norm of the first step's gradient
      as the optimizer took it (after clipping; ``leaf_gaps``), the widest;
      ``grad_median``: the median leaf's;
    - ``change``: the same of each leaf's change over all the steps, leaving
      out leaves whose first reference gradient is under a thousandth of the
      median leaf's (they move by round-off alone); ``change_median``.

    The widest gaps swing from seed to seed: a near tie in one matching
    settles either way on rounding, which moves a step's gradient and,
    through Adam, everything after it. The limits file names the numbers
    compared. Leaves that one side has and the other lacks read infinite."""
    names = ("loss", "loss_step1", "grad", "grad_median", "change",
             "change_median")
    if set(prog["grad"]) != set(ref["grad"]) \
            or set(prog["change"]) != set(ref["change"]) \
            or len(prog["losses"]) != len(ref["losses"]):
        return dict.fromkeys(names, INF)
    steps = [abs(p - r) / abs(r) if math.isfinite(p) else INF
             for p, r in zip(prog["losses"], ref["losses"])]
    leaves = sorted(ref["grad"])
    med_raw = statistics.median(ref["raw_grad"][k] for k in leaves)
    moving = [k for k in leaves if ref["raw_grad"][k] >= 1e-3 * med_raw]
    grad = list(leaf_gaps(prog["grad"], ref["grad"], leaves).values())
    change = list(leaf_gaps(prog["change"], ref["change"], moving).values())
    return dict(zip(names, (max(steps), steps[0], max(grad),
                            statistics.median(grad), max(change),
                            statistics.median(change))))


def judged(numbers: Dict[str, float], limits: Dict[str, Dict]) -> Dict:
    """{name: {"value", "limit"}} of each limited number, and whether all
    lie within their limits (a number without a limit, or a NaN, fails;
    no limits at all is no check, and not correct)."""
    out, ok = {}, bool(limits)
    for name, spec in limits.items():
        v = numbers.get(name, INF)
        if v != v:
            v = INF
        out[name] = {"value": v, "limit": spec["limit"]}
        ok = ok and v <= spec["limit"]
    return {"checks": out, "correct": ok}
