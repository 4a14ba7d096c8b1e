"""One chromosome of a reference panel, drawn on the device from a seed.

The genotype model is the one the repository's smoke test draws its UK
Biobank-width chromosome with (``chip_smoke.chromosome_blocks``), frozen
here with its copy chain vectorised: per SNP a minor-allele frequency
from ``U(maf)``, per ``rate_span`` SNPs a copy rate from ``U(copy_rate)``;
a SNP takes, sample by sample, its predecessor's genotype where a uniform
draw is below the rate, else a fresh binomial(2, MAF) genotype drawn from a
second uniform by its inverse CDF.  So a genotype is the fresh draw of the
last row at or before it whose draw was fresh.  The traffic then sets
``missing.rate`` of the genotypes of every ``missing.every``-th SNP
missing.  The codes are packed to PLINK ``.bed`` bytes on the device and
fetched once to pageable host memory; no file is written.

Positions: ``bp`` SNPs ``spacing`` bp apart, or ``cm`` a genetic map
fixed by the configuration (a panel's users share one map), so that every
seed gives the same windows and the same work.
"""

from __future__ import annotations

import numpy as np
import torch

#: genotypes drawn per block: bounds the draw's temporaries to a few GB
BLOCK_GENOTYPES = 1 << 28


def seed_of(seed: int, stream: int = 0) -> int:
    """A non-negative 63-bit seed for stream ``stream`` of ``seed`` (any
    whole number, negative or past 32 bits)."""
    return (int(seed) * 1_000_003 + stream) % (1 << 63)


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """int8 (rows, n) codes {0, 1, 2, -1} -> uint8 (rows, ceil(n / 4))
    ``.bed`` bytes on the codes' device: missing 01, het 10, hom-A2 11,
    hom-A1 and the pad bitpairs 00, the first sample in the low bits."""
    rows, n = codes.shape
    bits = torch.where(codes < 0, 1, torch.where(codes > 0, codes + 1, 0))
    bps = (n + 3) // 4
    padded = torch.zeros((rows, 4 * bps), dtype=torch.uint8,
                         device=codes.device)
    padded[:, :n] = bits.to(torch.uint8)
    q = padded.view(rows, bps, 4)
    return q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4) | (q[..., 3] << 6)


def copy_chain(fresh: torch.Tensor, keep: torch.Tensor,
               prev: torch.Tensor | None) -> torch.Tensor:
    """Rows of codes from their fresh draws ``fresh`` (rows, n) and the
    flags ``keep`` (rows, n) of the genotypes that copy their predecessor:
    each genotype is the fresh draw of the last row at or before it whose
    draw was fresh, or ``prev`` (the row before the block) where there is
    none.  ``prev`` None: the first row is fresh."""
    rows = fresh.shape[0]
    if prev is None:
        keep = keep.clone()
        keep[0] = False
    at = torch.arange(rows, dtype=torch.int32, device=fresh.device)[:, None]
    last = torch.where(keep, torch.tensor(-1, dtype=torch.int32,
                                          device=fresh.device), at)
    last = torch.cummax(last, dim=0).values
    got = fresh.gather(0, last.clamp(min=0).long())
    if prev is None:
        return got
    return torch.where(last >= 0, got, prev[None, :])


def code_blocks(config: dict, traffic: dict, seed: int, device):
    """Yield ``(r0, codes)``: int8 (rows, n) codes of SNPs ``[r0, r0 +
    rows)`` of the configuration's chromosome under ``traffic``."""
    m, n = config["n_snps"], config["n_samples"]
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed_of(seed))
    lo, hi = config["maf"]
    maf = torch.rand(m, generator=gen, device=dev) * (hi - lo) + lo
    span = config["rate_span"]
    lo, hi = config["copy_rate"]
    rate = (torch.rand(-(-m // span), generator=gen, device=dev) * (hi - lo)
            + lo).repeat_interleave(span)[:m]
    miss = traffic.get("missing")
    block = max(1, BLOCK_GENOTYPES // n)
    prev = None
    for r0 in range(0, m, block):
        rows = min(block, m - r0)
        u = torch.rand((2, rows, n), generator=gen, device=dev)
        p = maf[r0:r0 + rows, None]
        # binomial(2, MAF) from one draw: 0 below (1 - p)^2, 2 above 1 - p^2
        fresh = ((u[0] >= (1 - p) ** 2).to(torch.int8)
                 + (u[0] >= 1 - p * p).to(torch.int8))
        keep = u[1] < rate[r0:r0 + rows, None]
        del u
        codes = copy_chain(fresh, keep, prev)
        del fresh, keep
        prev = codes[-1].clone()
        if miss:
            every = miss["every"]
            first = -(-r0 // every) * every
            hit = torch.arange(first, r0 + rows, every, device=dev) - r0
            if len(hit):
                gone = torch.rand((len(hit), n), generator=gen,
                                  device=dev) < miss["rate"]
                codes[hit] = torch.where(gone, -1, codes[hit]).to(torch.int8)
        yield r0, codes


def packed_chromosome(config: dict, traffic: dict, seed: int,
                      device) -> tuple[np.ndarray, bool]:
    """The chromosome's ``.bed`` rows in pageable host memory, uint8 (M,
    ceil(N / 4)), as a reader returns them, and whether any genotype is
    missing."""
    m, n = config["n_snps"], config["n_samples"]
    raw = np.empty((m, (n + 3) // 4), dtype=np.uint8)
    host = torch.from_numpy(raw)
    has_missing = False
    for r0, codes in code_blocks(config, traffic, seed, device):
        has_missing = has_missing or bool((codes < 0).any())
        host[r0:r0 + codes.shape[0]].copy_(pack_codes(codes))
    return raw, has_missing


def positions(config: dict) -> np.ndarray:
    """float64 (M,) window coordinates of the configuration's map: bp for
    ``{"metric": "bp", "spacing": s}``; cM for ``{"metric": "cm",
    "total": T, "span": S, "spread": [a, b], "order_seed": k}``: a rate per
    span of S SNPs, the values ``a + (b - a)(j + 1/2)/K`` for the K spans
    in the order that ``order_seed`` draws, scaled to T cM over the
    chromosome."""
    m, spec = config["n_snps"], config["map"]
    if spec["metric"] == "bp":
        return np.arange(1, m + 1, dtype=np.float64) * spec["spacing"]
    span = spec["span"]
    k = -(-m // span)
    a, b = spec["spread"]
    rates = a + (b - a) * (np.arange(k) + 0.5) / k
    order = np.random.default_rng(spec["order_seed"]).permutation(k)
    step = np.repeat(rates[order], span)[:m]
    step *= spec["total"] / step.sum()
    return np.cumsum(step)


def annotations(traffic: dict, m: int, seed: int, device) -> np.ndarray | None:
    """float64 (M, p) annotations holding float32 values, or None: column
    0 all ones (the base annotation), then ``binary`` annotations in runs
    of ``run`` SNPs, annotation k covering a share from the grid over
    ``coverage``, then continuous ones in [0, 1)."""
    spec = traffic.get("annotations")
    if not spec:
        return None
    p, nb, run = spec["p"], spec["binary"], spec["run"]
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed_of(seed, 2))
    lo, hi = spec["coverage"]
    cover = torch.linspace(lo, hi, nb, device=dev)
    out = torch.empty((m, p), dtype=torch.float32, device=dev)
    out[:, 0] = 1.0
    runs = torch.rand((-(-m // run), nb), generator=gen, device=dev) < cover
    out[:, 1:1 + nb] = runs.repeat_interleave(run, dim=0)[:m]
    out[:, 1 + nb:] = torch.rand((m, p - 1 - nb), generator=gen, device=dev)
    return out.cpu().numpy().astype(np.float64)
