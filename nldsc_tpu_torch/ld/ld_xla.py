"""Sentinel finalization of the banded LD pass (torch)."""

from __future__ import annotations

import torch


def finalize_outputs(l2_acc, l2d_acc, ws, wsd, wse, poison, usable,
                     add_sd_zero):
    """Apply NaN/-1 sentinel semantics (ldscalc.h:16-21, SURVEY Q4).

    Unusable rows get NaN scores and -1 counters; a row with a
    zero-additive-sd SNP in its window (itself included) gets NaN L2; a
    zero-additive-sd pivot gets NaN L2D unless no neighbour passed the
    dominance filter, and WSE 0.
    """
    nan = torch.tensor(float("nan"), dtype=torch.float32, device=l2_acc.device)
    l2 = torch.where(usable & (poison == 0), 1.0 + l2_acc, nan)
    l2d_pivot_bad = torch.where(wsd > 0, nan, torch.zeros_like(nan))
    l2d = torch.where(usable, torch.where(add_sd_zero, l2d_pivot_bad, l2d_acc),
                      nan)
    neg1 = torch.full_like(ws, -1)
    ws_o = torch.where(usable, ws, neg1)
    wsd_o = torch.where(usable, wsd, neg1)
    wse_o = torch.where(usable, torch.where(add_sd_zero, torch.zeros_like(wse),
                                            wse), neg1)
    return l2, l2d, ws_o, wsd_o, wse_o
