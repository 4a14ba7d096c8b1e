"""The comparison that decides a run's ``correct``: the program's outputs
at the checked rows of every call in the window against the plain
reference (``reference/ld.py``), each number beside its limit.

Numbers (each the worst over every call and checked row):

* ``l2``, ``l2d``, ``annot`` (``l2_annot`` and ``l2d_annot`` together):
  the largest |program - reference| / max(1, |reference|);
* ``maf``, ``rstd`` (``residuals_std``): the largest relative gap;
* ``counters``: the (call, row) pairs that break the counter contract:
  ``l2_ws`` and ``l2d_ws`` equal, and ``l2d_wse`` equal except by at most
  the row's pairs within the float32 epilogue's rounding of ``rsq_thr``
  (``near``).

A value that is NaN on one side only counts as an infinite gap.  Every
number passes when it is at most its limit; a cell's limits live in its
workload file.
"""

from __future__ import annotations

import numpy as np

SCALED = {"l2": ("l2",), "l2d": ("l2d",),
          "annot": ("l2_annot", "l2d_annot")}
RELATIVE = {"maf": "maf", "rstd": "residuals_std"}


def _gap(ours: np.ndarray, ref: np.ndarray, floor: float | None) -> float:
    """The largest gap of ``ours`` from ``ref``, over ``max(floor, |ref|)``
    (``floor`` None: over ``|ref|``); NaN on one side only is infinite."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    nan_o, nan_r = np.isnan(ours), np.isnan(ref)
    if (nan_o != nan_r).any():
        return float("inf")
    ok = ~nan_r
    if not ok.any():
        return 0.0
    scale = np.abs(ref[ok]) if floor is None else np.maximum(np.abs(ref[ok]),
                                                             floor)
    with np.errstate(divide="ignore", invalid="ignore"):
        gap = np.abs(ours[ok] - ref[ok]) / scale
    gap = np.where(np.abs(ours[ok] - ref[ok]) == 0, 0.0, gap)
    return float(np.max(gap)) if gap.size else 0.0


def readings(calls: list, ref: dict) -> dict:
    """The numbers compared, from ``calls`` (per call a dict of the
    program's outputs at the checked rows) against ``ref`` (the reference
    at the same rows)."""
    out = {}
    for name, keys in SCALED.items():
        if all(k in ref for k in keys):
            out[name] = max(_gap(c[k], ref[k], 1.0)
                            for c in calls for k in keys)
    for name, key in RELATIVE.items():
        out[name] = max(_gap(c[key], ref[key], None) for c in calls)
    bad = 0
    for c in calls:
        wrong = ((np.asarray(c["l2_ws"]) != ref["l2_ws"])
                 | (np.asarray(c["l2d_ws"]) != ref["l2d_ws"])
                 | (np.abs(np.asarray(c["l2d_wse"], np.int64)
                           - ref["l2d_wse"]) > ref["near"]))
        bad += int(wrong.sum())
    out["counters"] = bad
    return out


def verdict(read: dict, limits: dict) -> tuple[bool, dict]:
    """Whether every number is within its limit, and per number its
    reading and limit.  A number without a limit, or a limit without a
    reading, fails."""
    table = {k: {"value": read.get(k), "limit": limits.get(k)}
             for k in sorted(set(read) | set(limits))}
    ok = all(v["value"] is not None and v["limit"] is not None
             and v["value"] <= v["limit"] for v in table.values())
    return ok, table
