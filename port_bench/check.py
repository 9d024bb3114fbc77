"""How `correct` is decided: the numbers compared between what the timed
path produced and the plain reference, each beside its limit.

Training cells compare, over the first micro-steps that set-up drove
through the window's own call: the loss of every micro-step (relative
gap, the worst step); the gap between the program's norm and the
reference's of each leaf of the first gradient as the optimizer holds
it, the median leaf's; and that of the parameters' change over those
steps, the worst leaf's. Each leaf's gap is measured against the
reference's norm of that leaf or of the median leaf, whichever is
larger. Leaves whose reference gradient is under a thousandth of the
median leaf's move under Adam by round-off alone and are left out of
the change. The gradient is held by its median leaf because its worst
leaf, one of the first BatchNorm layers' scales or shifts, reads 0.14 to
0.35 in bfloat16 on every seed and 0.002 to 0.004 in float32 (PERF.md).

Depth cells compare a sample of the frames served in the window, drawn
from the seed: per frame the mean over pixels of |d - d_ref| / d_ref,
divided by the same mean of the reference computed in bfloat16 on that
frame (how far rounding alone moves it under these weights, which
differs tenfold from seed to seed), the worst frame
(`harness.depth_numbers`).

Limits live in `limits/<workload>.json`, one file per cell, with the
readings they were set from.
"""
from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TINY_LEAF = 1e-3


def load_limits(workload: str) -> dict:
    with open(os.path.join(HERE, "limits", workload + ".json")) as f:
        return json.load(f)["limits"]


def leaf_gap(got, want, keep=None) -> float:
    """Worst leaf's |got - want| / max(want, median of every leaf's
    want), over the leaves `keep` selects (default all)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    floor = max(float(np.median(want)), 1e-30)
    if keep is not None:
        got, want = got[keep], want[keep]
    return float(np.max(np.abs(got - want) / np.maximum(want, floor)))


def median_leaf_gap(got, want) -> float:
    """The median leaf's |got - want| / max(want, median of want)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    floor = max(float(np.median(want)), 1e-30)
    return float(np.median(np.abs(got - want) / np.maximum(want, floor)))


def train_numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers of a training cell from the program's readings
    and the reference's (both as `reference.train.follow` returns them)."""
    loss_p = np.asarray(prog["loss"], np.float64)
    loss_r = np.asarray(ref["loss"], np.float64)
    keep = ref["grad"] >= TINY_LEAF * np.median(ref["grad"])
    eas_p = np.asarray(prog["eas"], np.float64)
    eas_r = np.asarray(ref["eas"], np.float64)
    return {"loss_gap": float(np.max(np.abs(loss_p - loss_r)
                                     / np.abs(loss_r))),
            "eas_gap": float(np.max(np.abs(eas_p - eas_r) / np.abs(eas_r))),
            "grad_median_gap": median_leaf_gap(prog["grad"], ref["grad"]),
            "change_gap": leaf_gap(prog["change"], ref["change"], keep)}


def depth_gap(got: np.ndarray, want: np.ndarray) -> float:
    """Mean over pixels of |got - want| / want of one depth map."""
    want = np.asarray(want, np.float64)
    return float(np.mean(np.abs(np.asarray(got, np.float64) - want) / want))


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): correct when every number is
    finite and at most its limit."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits[name]
        out[name] = {"value": value, "limit": limit}
        ok = ok and bool(np.isfinite(value)) and value <= limit
    return ok, out
