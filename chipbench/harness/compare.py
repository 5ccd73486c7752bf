"""The numbers that decide ``correct``, each computed the same way for the
program, for the control and for a planted fault.

Training (one reading per run, over its first steps):

* ``loss_gap``: the largest relative gap between a step's loss and the
  reference's, over the steps compared;
* ``grad_gap``: the worst leaf's gap between the norm of its first
  gradient and the reference's;
* ``change_gap``: the worst leaf's gap between the norm of its change
  over the steps compared and the reference's;
* ``grad_err``: the worst leaf's relative error of its first gradient,
  element by element over a seeded sample of its elements (the norm of
  the difference over the norm of the reference's). The norms above sum
  away errors of rounding, so a precision below the configuration's (the
  control) moves them little; this number separates it.

A leaf's gap is |a - b| / max(b, the median leaf's b): the gap of the two
norms, not the norm of the difference. Leaves whose reference gradient is
under a thousandth of the median leaf's are left out of both leaf
readings: Adam moves them by round-off alone.

Serving: ``logit_gap`` is the widest gap by which a served token's logit
lies below the reference's best at its position, over the sampled
requests; ``length_errors`` counts requests that finished in the window
with another number of tokens than they asked for.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

NEGLIGIBLE = 1e-3


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep) -> float:
    med = statistics.median(ref[n] for n in keep)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in keep)


def counted_leaves(ref_first_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_first_grad.values())
    return sorted(n for n, g in ref_first_grad.items() if g >= NEGLIGIBLE * med)


def train_readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    keep = counted_leaves(ref["first_grad"])
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"], strict=True))
    err = max(float((prog["grad_sample"][n] - ref["grad_sample"][n]).norm()
                    / ref["grad_sample"][n].norm().clamp(min=1e-30)) for n in keep)
    return {
        "loss_gap": loss,
        "grad_gap": _leaf_gap(prog["first_grad"], ref["first_grad"], keep),
        "change_gap": _leaf_gap(prog["change"], ref["change"], keep),
        "grad_err": err,
    }


def worst_leaves(prog: Dict, ref: Dict) -> Dict[str, str]:
    """The leaf that sets each leaf reading (for the record)."""
    keep = counted_leaves(ref["first_grad"])
    med = {k: statistics.median(ref[k][n] for n in keep) for k in ("first_grad", "change")}

    def worst(k):
        return max(keep, key=lambda n: abs(prog[k][n] - ref[k][n]) / max(ref[k][n], med[k]))

    return {"grad_gap": worst("first_grad"), "change_gap": worst("change"),
            "grad_err": max(keep, key=lambda n: float(
                (prog["grad_sample"][n] - ref["grad_sample"][n]).norm()
                / ref["grad_sample"][n].norm().clamp(min=1e-30)))}


def checks(readings: Dict[str, float], limits: Dict[str, float]) -> List[Tuple[str, float, float]]:
    """(name, value, limit) for every limit of the cell; a reading that is
    missing or not a number fails."""
    out = []
    for name, limit in limits.items():
        v = readings.get(name, float("nan"))
        out.append((name, float(v), float(limit)))
    return out


def passed(rows) -> bool:
    return all(v <= lim for _, v, lim in rows)
