"""Carry the JAX package's engine inputs across to the port's tensors.

The tests feed both packages identical inputs this way: the dict that
``nldsc_tpu.ld.ld_int8.preprocess_int8`` returns, the window bounds and
the dominance mask, all as numpy arrays, become the arguments of
:func:`nldsc_tpu_torch.ld.ld_int8.sym_scan_segment` and of the kernel
wrapper; the annotation matrix that ``nldsc_tpu.io.ldscores.read_annot``
returns becomes the padded float32 tensor those take as ``annot``; and
the f32 engine's standardized rows, from
``nldsc_tpu.ld.preprocess.preprocess_block``, become the arguments of the
``ld_xla`` engines.  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .ld_int8 import SCAL_FIELDS


def from_jax_inputs(pre: dict, lo, hi, dom_ok, device="cpu") -> dict:
    """Engine inputs as tensors on ``device``.

    Returns ``g``, ``m``, ``h`` (int8), ``scal`` (f32 (M, 9)), ``lo``,
    ``hi`` (int32), ``usable``, ``dom_ok``, ``add_sd_zero`` (bool) and
    ``has_missing`` (bool).
    """
    def t(x, dtype):
        return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)

    scal = np.stack([np.asarray(pre[k], dtype=np.float32)
                     for k in SCAL_FIELDS], axis=1)
    return {
        "g": t(pre["g"], torch.int8),
        "m": t(pre["m"], torch.int8),
        "h": t(pre["h"], torch.int8),
        "scal": t(scal, torch.float32),
        "lo": t(lo, torch.int32),
        "hi": t(hi, torch.int32),
        "usable": t(pre["usable"], torch.bool),
        "dom_ok": t(dom_ok, torch.bool),
        "add_sd_zero": t(pre["add_sd_zero"], torch.bool),
        "has_missing": bool(np.asarray(pre["has_missing"])),
    }


def annot_from_jax(annot, m_pad: int, device="cpu") -> torch.Tensor:
    """The JAX package's annotation matrix, float64 ``(M, p)``, as the
    port's engines take it: float32 ``(m_pad, p)`` on ``device``, zero
    rows for the padding (what ``nldsc_tpu/ld/pipeline.py:192-195`` gives
    its own engines)."""
    a = np.zeros((m_pad, annot.shape[1]), dtype=np.float32)
    a[:annot.shape[0]] = annot
    return torch.from_numpy(a).to(device)


def from_jax_f32_inputs(pre: dict, lo, hi, dom_ok, blk_lo, blk_hi,
                        device="cpu") -> dict:
    """The f32 engine's inputs from the JAX package's: the dict that
    ``nldsc_tpu.ld.preprocess.preprocess_block`` returns, the window
    bounds, the dominance mask and the block ranges, as numpy arrays.

    Returns ``add``, ``res`` (float32), ``lo``, ``hi`` (int32),
    ``usable``, ``dom_ok``, ``add_sd_zero`` (bool) as tensors on
    ``device``, and ``blk_lo``, ``blk_hi`` as int32 host arrays: the
    arguments of the ``nldsc_tpu_torch.ld.ld_xla`` engines, in order.
    """
    def t(x, dtype):
        return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)

    return {
        "add": t(pre["add"], torch.float32),
        "res": t(pre["res"], torch.float32),
        "lo": t(lo, torch.int32),
        "hi": t(hi, torch.int32),
        "usable": t(pre["usable"], torch.bool),
        "dom_ok": t(dom_ok, torch.bool),
        "add_sd_zero": t(pre["add_sd_zero"], torch.bool),
        "blk_lo": np.asarray(blk_lo, dtype=np.int32),
        "blk_hi": np.asarray(blk_hi, dtype=np.int32),
    }
