"""The comparison that decides `correct`: the program's pixels against the
plain reference's, at the pixels the seed drew, over every launch the
window made.

Two numbers, each held to a limit of the cell's own (cells/<workload>.json,
with the readings it was set from):
- `mismatch_share`: the share of compared values (a pixel's channel; in
  an orbit every launch's) that differ from the reference's by more than
  RTOL of its magnitude, floored at FLOOR.  A value that is not finite on
  either side counts as a mismatch.  It catches a launch, a sample or a
  pixel that went missing or wrong; the share is not zero in sound runs
  because a rounding difference now and then flips a discrete choice of a
  path (a roulette coin, a lobe) and the two sides trace different paths
  from there on.
- `rel_l1`: the summed absolute difference over the summed magnitude of
  the reference: a bias spread thinly over every pixel shows here.
"""

from __future__ import annotations

import numpy as np

RTOL = 1e-3
FLOOR = 1e-2
NUMBERS = ("mismatch_share", "rel_l1")


def compare(program: np.ndarray, reference: np.ndarray) -> dict:
    """The numbers compared, from two arrays of the same shape."""
    p = np.asarray(program, np.float64)
    r = np.asarray(reference, np.float64)
    if p.shape != r.shape:
        raise ValueError(f"shapes differ: {p.shape} against {r.shape}")
    err = np.abs(p - r)
    ok = err <= RTOL * np.maximum(np.abs(r), FLOOR)         # False where either side is not finite
    finite = np.isfinite(p).all() and np.isfinite(r).all()
    rel_l1 = float(err.sum() / max(np.abs(r).sum(), 1e-30)) if finite else float("inf")
    return {"mismatch_share": float(1.0 - ok.mean()), "rel_l1": rel_l1}


def judge(numbers: dict, limits: dict) -> bool:
    """Whether every number is within its limit; a missing limit or a
    number that is not finite fails."""
    return all(name in limits and np.isfinite(v) and v <= limits[name] for name, v in numbers.items())


def lines(numbers: dict, limits: dict) -> list:
    """One line a number: its name, its value and its limit."""
    return [f"check {name} {numbers[name]!r} limit {limits.get(name)!r}" for name in numbers]
