"""Read how XLA compiles the JAX package's float32 LD arithmetic, and which
emulation of it the port must run (``nldsc_tpu_torch/core/numerics.py``).

Prints, for this jax/jaxlib on the CPU:

1. the constants of the optimized HLO of each jitted function the port
   mirrors (``corr_from_dots`` and the adjusted r², ``preprocess_int8``
   clean and with missing genotypes, the f32 engine's
   ``preprocess_block`` and ``_tile_epilogue``), and the divisions left
   in it: a division by the constant n shows as a product by f32(1/n);
2. how many of 200,000 pairs (a 400 x 500 tile of products of seeded
   genotypes with 2% missing, N = 150) differ bitwise from the jitted
   JAX values under three float32 forms of the epilogue: operation by
   operation with ``/ n``, with the reciprocal only, and with the
   reciprocal and the fused multiply-adds (the port's form).  The last
   column must read 0 on every output.

Run: ``python3 scripts/probe_xla_f32.py`` (CPU, about half a minute).
After a jaxlib upgrade, a nonzero count in the last column means the
port's rules need reading again.
"""

from __future__ import annotations

import os
import re
import sys
from functools import partial

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jaxlib  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from nldsc_tpu.ld import ld_int8 as jax_int8  # noqa: E402
from nldsc_tpu.ld import ld_xla as jax_xla  # noqa: E402
from nldsc_tpu.ld import preprocess as jax_pre  # noqa: E402
from nldsc_tpu_torch.core.numerics import fma_rn, recip_f32  # noqa: E402
from nldsc_tpu_torch.ld import ld_int8  # noqa: E402
from utils import random_genotypes  # noqa: E402

N = 150
ROWS, COLS = 400, 500


@partial(jax.jit, static_argnames=("n", "n_pad"))
def jax_epilogue(dots, sc_i, sc_j, *, n, n_pad):
    n32 = jnp.float32(n)
    adj_c = (n32 - 1.0) / (n32 - 2.0)
    r_add, r_da, r_db = jax_int8.corr_from_dots(
        dots, jax_int8.scal_views(sc_i, "col"),
        jax_int8.scal_views(sc_j, "row"), n32, jnp.float32(n_pad), True,
        True)
    return r_add, r_da, 1.0 - (1.0 - r_da * r_da) * adj_c


def hlo_summary(name: str, lowered) -> None:
    text = lowered.compile().as_text()
    consts = sorted(set(re.findall(r"f32\[\] constant\(([-0-9.e+]+)\)",
                                   text)), key=float)
    divides = len(re.findall(r"= f32\[[^\]]*\]\{?[^ ]* divide\(", text))
    print(f"{name}: f32 constants {consts}; f32 divides {divides}")


def forms(dots, si, sj, n, n_padf, adj_c):
    """(r_add, r_dom_a, adjusted r_dom_a) under each float32 form."""
    sgg, sgh = dots["sgg"], dots["sgh"]
    am_i, am_j = si["am"], sj["am"]
    sgu = si["gsum"] - dots["sgm"]
    sug = sj["gsum"] - dots["smg"]
    suh = sj["hsum"] - dots["smh"]
    suu = n_padf - si["cm"] - sj["cm"] + dots["smm"]

    def plain(fused: bool, recip: bool):
        def mad(a, b, c):
            return fma_rn(a, b, c) if fused else a * b + c

        def scale(x):
            return x * recip_f32(n) if recip else x / n
        ac = mad(am_i * am_j, suu, mad(-am_j, sgu, mad(-am_i, sug, sgg)))
        a1 = mad(-am_i, suh - sug, sgh - sgg)
        a2 = mad(-am_i, sug - 0.5 * suh, sgg - 0.5 * sgh)
        a0 = mad(-am_i, suu - 0.5 * suh, sgu - 0.5 * sgh)
        dom = mad(sj["v2"], a2, mad(sj["v0"], a0, sj["v1"] * a1))
        if not fused:      # the op-by-op forms keep the source's order
            ac = sgg - am_i * sug - am_j * sgu + am_i * am_j * suu
            dom = sj["v0"] * a0 + sj["v1"] * a1 + sj["v2"] * a2
        r_add = scale(ac * si["inv_sd"] * sj["inv_sd"])
        r_da = scale(dom * si["inv_sd"] * sj["inv_rstd"])
        adj = (mad(-mad(-r_da, r_da, 1.0), adj_c, 1.0) if fused
               else 1.0 - (1.0 - r_da * r_da) * adj_c)
        return r_add, r_da, adj
    return {"op by op": plain(False, False),
            "reciprocal only": plain(False, True),
            "reciprocal + FMAs": plain(True, True)}


def main() -> None:
    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
          f"backend {jax.default_backend()}")
    rng = np.random.default_rng(2024)
    m = ROWS + COLS
    g = random_genotypes(rng, m, N, missing_rate=0.02)
    n_pad = -(-N // 128) * 128
    codes = np.full((m, n_pad), -1, dtype=np.int8)
    codes[:, :N] = g
    pre = ld_int8.preprocess_int8(torch.from_numpy(codes),
                                  torch.ones(m, dtype=torch.bool), 0.01, N)
    scal = ld_int8.stack_scalars(pre)
    rows, cols = slice(0, ROWS), slice(ROWS, m)
    dots = ld_int8.tile_products(pre["g"], pre["m"], pre["h"], True, "int8",
                                 symmetric=True)(rows, cols)
    jd = {k: jnp.asarray(v.numpy()) for k, v in dots.items()}
    js_i, js_j = jnp.asarray(scal[rows].numpy()), jnp.asarray(
        scal[cols].numpy())

    print("\n1. optimized HLO")
    hlo_summary("corr_from_dots + adjusted r2 (N = 150, missing)",
                jax_epilogue.lower(jd, js_i, js_j, n=N, n_pad=n_pad))
    pos_ok = jnp.ones(m, bool)
    for clean in (True, False):
        hlo_summary(f"preprocess_int8 (assume_no_missing={clean})",
                    jax_int8.preprocess_int8.lower(
                        jnp.asarray(np.maximum(codes, 0) if clean else codes),
                        pos_ok, jnp.float32(0.01), n_samples=N,
                        assume_no_missing=clean))
    hlo_summary("preprocess_block (f32 engine)", jax_pre.preprocess_block.lower(
        jnp.asarray(codes), pos_ok, jnp.float32(0.01), n_samples=N))
    c = jnp.zeros((64, 128), jnp.float32)
    i = jnp.zeros(64, jnp.int32)
    j = jnp.zeros(128, jnp.int32)
    b64, b128 = jnp.zeros(64, bool), jnp.zeros(128, bool)
    hlo_summary("_tile_epilogue (f32 engine)", jax.jit(
        jax_xla._tile_epilogue, static_argnames=("n_samples",)).lower(
            c, c, i, j, i, i, b64, b128, b128, b128, n_samples=N,
            rsq_thr=jnp.float32(1e-3)))
    print(f"f32(1/{N}) = {recip_f32(N)!r}, f32(f32(1/{N})^2) = "
          f"{ld_int8.f32(recip_f32(N) ** 2)!r}")

    print(f"\n2. bitwise mismatches of {ROWS * COLS:,} pairs against the "
          "jitted JAX epilogue (N = 150, 2% missing)")
    theirs = [np.asarray(x) for x in jax_epilogue(jd, js_i, js_j, n=N,
                                                  n_pad=n_pad)]
    table = forms(dots, ld_int8.scal_views(scal[rows], "col"),
                  ld_int8.scal_views(scal[cols], "row"), float(N),
                  float(n_pad), ld_int8.adj_constant(N))
    print(f"{'form':<20} {'r_add off':>10} {'r_dom_a off':>12} "
          f"{'adjusted r2 off':>16}")
    for name, outs in table.items():
        off = [int((o.numpy().view(np.int32)
                    != t.view(np.int32)).sum()) for o, t in zip(outs, theirs)]
        print(f"{name:<20} {off[0]:>10,} {off[1]:>12,} {off[2]:>16,}")


if __name__ == "__main__":
    main()
