"""The split-missing route of the PyTorch port against the JAX package
(run on the CPU: the plain twins).

Every test feeds both packages the same numpy inputs, made from a seed
with ``tests/test_ld_split.py::row_level_missing``'s recipe.  Counters
must be exactly equal; the δ-corrections' l2/l2d within 1e-5 (summation
order only), the pipeline's scores within ``test_golden``'s tolerances.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nldsc_tpu.config import LDConfig as JaxLDConfig
from nldsc_tpu.ld import ld_int8 as jax_int8
from nldsc_tpu.ld import ld_split as jax_split
from nldsc_tpu.ld import pipeline as jax_pipeline
from nldsc_tpu.ld import windows as jax_windows
from nldsc_tpu_torch import _build, cli
from nldsc_tpu_torch.config import LDConfig
from nldsc_tpu_torch.io.plink import write_plink
from nldsc_tpu_torch.ld import ld_int8, ld_pallas_sym, ld_split, pipeline
from nldsc_tpu_torch.ld.convert import from_jax_inputs

from test_golden import check
from test_ld_split import row_level_missing
from test_torch_pipeline import _read_l2
from utils import adversarial_genotypes, make_positions, random_genotypes

RSQ = 1e-3
DELTA_TOL = dict(rtol=1e-5, atol=1e-5)
KW = dict(ld_wind=5000, wind_metric="bp", maf_thr=0.01, std_thr=1e-4,
          rsq_thr=RSQ)


def _adversarial(rng, n=160):
    """All-missing, monomorphic and heavy-missing rows among clean ones
    (``test_ld_split.py::test_split_adversarial_rows``)."""
    base = random_genotypes(rng, 40, n, missing_rate=0.0)
    adv = adversarial_genotypes(rng, n)
    allmiss = np.full((1, n), -1, dtype=np.int8)
    return np.concatenate([base[:20], adv, allmiss, base[20:]]).astype(
        np.int8)


def _unusable_only(rng):
    """Missing genotypes only in MAF-dropped rows
    (``test_ld_split.py::test_split_unusable_contaminated_rows_only``)."""
    g = random_genotypes(rng, 120, 150, missing_rate=0.0)
    for r in (10, 70):
        g[r] = 0
        g[r, :3] = 1
        g[r, 5:20] = -1
    return g


def _engine_inputs(g, pos, B, wind=5000.0):
    """JAX preprocessing of padded codes, and the split plan, as numpy."""
    m, n = g.shape
    m_pad, n_pad = -(-m // B) * B, -(-n // 128) * 128
    gp = np.full((m_pad, n_pad), -1, dtype=np.int8)
    gp[:m, :n] = g
    lo, hi, pos_ok = jax_windows.window_bounds(pos, wind)
    pos_ok_p = np.zeros(m_pad, bool)
    pos_ok_p[:m] = pos_ok
    lo_p = np.full(m_pad, m_pad, np.int32)
    hi_p = np.full(m_pad, -1, np.int32)
    lo_p[:m], hi_p[:m] = lo, hi
    pre = jax_int8.preprocess_int8(jnp.asarray(gp), jnp.asarray(pos_ok_p),
                                   jnp.float32(0.01), n_samples=n)
    dom_ok = np.asarray(pre["usable"] & (pre["rstd"] > jnp.float32(1e-4)))
    rowmiss = (np.asarray(pre["cm"]) > n_pad - n) & np.asarray(pre["usable"])
    return dict(gp=gp, pre=pre, dom_ok=dom_ok, lo=lo_p, hi=hi_p, n=n,
                rowmiss=rowmiss, m_pad=m_pad)


@pytest.mark.parametrize("seg_rows", [64, 4096])
def test_plan_split_v2_matches_jax(rng, seg_rows):
    g = row_level_missing(rng, 250, 130, row_frac=0.1)
    e = _engine_inputs(g, make_positions(250, spacing=300), 16)
    S = min(seg_rows, e["m_pad"])
    ours = ld_split.plan_split_v2(e["rowmiss"], e["lo"], e["hi"], S,
                                  e["m_pad"])
    theirs = jax_split.plan_split_v2(e["rowmiss"], e["lo"], e["hi"], S,
                                     e["m_pad"])
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_compact_missing_rows_matches_jax(rng):
    g = random_genotypes(rng, 96, 130, missing_rate=0.1)
    g_pad = np.full((128, 256), -1, dtype=np.int8)
    g_pad[:96, :130] = g
    miss_idx = np.flatnonzero((g_pad < 0).any(axis=1)).astype(np.int32)
    miss_idx = np.concatenate([miss_idx, np.full(8, 127, np.int32)])
    ours = ld_split.compact_missing_rows(torch.from_numpy(g_pad), miss_idx)
    theirs = jax_split.compact_missing_rows(jnp.asarray(g_pad),
                                            jnp.asarray(miss_idx))
    assert ours.dtype == torch.int8
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    full = ld_int8.preprocess_int8(torch.from_numpy(g_pad),
                                   torch.ones(128, dtype=torch.bool), 0.01,
                                   130)["m"]
    np.testing.assert_array_equal(ours.numpy(), full.numpy()[miss_idx])


@pytest.mark.parametrize("missing", [True, False])
def test_preprocess_lazy_m_statistics_bitwise(rng, missing):
    g = random_genotypes(rng, 70, 203, missing_rate=0.05 if missing else 0)
    gp = np.full((70, 256), -1 if missing else 0, dtype=np.int8)
    gp[:, :203] = g
    pos_ok = torch.from_numpy(rng.random(70) > 0.1)
    gt = torch.from_numpy(gp)
    kw = dict(assume_no_missing=not missing)
    full = ld_int8.preprocess_int8(gt, pos_ok, 0.01, 203, **kw)
    lazy = ld_int8.preprocess_int8(gt, pos_ok, 0.01, 203, **kw,
                                   materialize_m=False)
    for k in full:
        if k != "m":
            assert torch.equal(full[k].nan_to_num(7.0),
                               lazy[k].nan_to_num(7.0)), k
    assert lazy["m"] is lazy["g"]
    if missing:
        assert torch.equal(ld_int8.materialize_missing(gt), full["m"])


def _split_case(rng, case):
    if case == "adversarial":
        g = _adversarial(rng)
        pos = make_positions(g.shape[0], spacing=400, jitter_rng=rng,
                             skip_idx=(3, 30))      # keeps row 25 usable
        return g, pos, 16, 24
    g = row_level_missing(rng, 230, 150, row_frac=0.1, entry_rate=0.3)
    pos = make_positions(230, spacing=600, jitter_rng=rng, skip_idx=(7,))
    return g, pos, 16, 64           # m_pad 240: the last segment clamps


@pytest.mark.parametrize("case", ["rows", "adversarial"])
def test_split_corrections_twin_matches_jax(rng, case):
    g, pos, B, S = _split_case(rng, case)
    e = _engine_inputs(g, pos, B)
    pre, m_pad = e["pre"], e["m_pad"]
    plan = jax_split.plan_split_v2(e["rowmiss"], e["lo"], e["hi"], S, m_pad)
    m_c = jax_split.compact_missing_rows(jnp.asarray(e["gp"]),
                                         jnp.asarray(plan["miss_idx"]))
    theirs = jax_split.split_corrections(
        pre["g"], m_c, pre["h"], jax_int8.stack_scalars(pre),
        jnp.asarray(e["lo"]), jnp.asarray(e["hi"]), pre["usable"],
        jnp.asarray(e["dom_ok"]), jnp.asarray(e["rowmiss"]),
        jnp.float32(RSQ), jnp.int32(m_pad), jnp.asarray(plan["miss_idx"]),
        jnp.asarray(plan["cs"]), jnp.asarray(plan["c_cnt"]),
        jnp.asarray(plan["xs"]), jnp.asarray(plan["x_cnt"]),
        seg_rows=S, n_segs=plan["n_segs"], p_band=plan["p_band"],
        p_x=plan["p_x"], n_samples=e["n"])

    inp = from_jax_inputs({k: np.asarray(v) for k, v in pre.items()},
                          e["lo"], e["hi"], e["dom_ok"])
    before = (ld_split.corr_launches, ld_split.fused_launches)
    ours = ld_split.split_corrections(
        inp["g"], ld_split.compact_missing_rows(torch.from_numpy(e["gp"]),
                                                plan["miss_idx"]),
        inp["h"], inp["scal"], inp["lo"], inp["hi"], inp["usable"],
        inp["dom_ok"], torch.from_numpy(e["rowmiss"]), RSQ, m_pad, plan,
        n_samples=e["n"])
    assert (ld_split.corr_launches, ld_split.fused_launches) == before
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(theirs[2]))
    for a, b in zip(ours[:2], theirs[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **DELTA_TOL)
    assert np.abs(np.asarray(theirs[0])).max() > 0     # corrections happen


def test_ld_scores_split_matches_jax(rng):
    g, pos, B, S = _split_case(rng, "rows")
    e = _engine_inputs(g, pos, B)
    pre, m_pad = e["pre"], e["m_pad"]
    plan = jax_split.plan_split_v2(e["rowmiss"], e["lo"], e["hi"], S, m_pad)
    lo, hi, _ = jax_windows.window_bounds(pos, 5000.0)
    _, blk_hi, _ = jax_windows.band_blocks(lo, hi, B, m_pad // B)
    theirs = jax_split.ld_scores_split(
        pre["g"], jax_split.compact_missing_rows(
            jnp.asarray(e["gp"]), jnp.asarray(plan["miss_idx"])),
        pre["h"], jax_int8.stack_scalars(pre), jnp.asarray(e["lo"]),
        jnp.asarray(e["hi"]), pre["usable"], jnp.asarray(e["dom_ok"]),
        pre["add_sd_zero"], jnp.asarray(e["rowmiss"]), jnp.float32(RSQ), plan,
        block_size=B, right_k=jax_windows.right_band_blocks(blk_hi, B),
        n_samples=e["n"])
    inp = from_jax_inputs({k: np.asarray(v) for k, v in pre.items()},
                          e["lo"], e["hi"], e["dom_ok"])
    ours = ld_split.ld_scores_split(
        inp["g"], ld_split.compact_missing_rows(torch.from_numpy(e["gp"]),
                                                plan["miss_idx"]),
        inp["h"], inp["scal"], inp["lo"], inp["hi"], inp["usable"],
        inp["dom_ok"], inp["add_sd_zero"], torch.from_numpy(e["rowmiss"]),
        RSQ, plan, block_size=B, n_samples=e["n"])
    for a, b in zip(ours[2:], theirs[2:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(ours[:2], theirs[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), equal_nan=True,
                                   **DELTA_TOL)


def test_split_corrections_refuses_annot(rng):
    # annotations are taken as the engines take them, a float32 (M_pad, p)
    # tensor beside the genotypes: anything else is refused, on any device
    g = torch.zeros((16, 128), dtype=torch.int8)
    for bad in (np.ones((16, 3), np.float32), torch.ones(16, 3).double(),
                torch.ones(8, 3), torch.ones(16), torch.ones(16, 0),
                torch.ones(3, 16).t()):
        with pytest.raises(ValueError, match="annot must be"):
            ld_split.split_corrections(g, *([None] * 10), {}, annot=bad,
                                       n_samples=10)


def test_corr_products_plain_is_exact(rng):
    x = torch.from_numpy(rng.integers(0, 3, (8, 256), dtype=np.int8))
    cat = torch.from_numpy(rng.integers(0, 3, (24, 256), dtype=np.int8))
    before = ld_split.corr_launches
    a, b = ld_split.corr_products(x, cat, 16)
    assert ld_split.corr_launches == before
    xi, ci = x.numpy().astype(np.int64), cat.numpy().astype(np.int64)
    np.testing.assert_array_equal(a.numpy(), xi @ ci.T)
    np.testing.assert_array_equal(b.numpy(), 2 * np.minimum(xi, 1)
                                  @ ci[:16].T)
    assert ld_split.corr_products(x, cat)[1] is None


def _route_spies(monkeypatch):
    """Record which route each package takes: the clean or the 8-product
    pass, and whether split corrections ran."""
    seen = {"ours": [], "jax": []}

    def spy(where, module, name, tag):
        real = getattr(module, name)

        def wrapper(*a, **kw):
            seen[where].append(tag(kw))
            return real(*a, **kw)

        monkeypatch.setattr(module, name, wrapper)

    def kind(kw):
        return "global" if kw["has_missing"] else "clean"

    spy("ours", ld_pallas_sym, "sym_credits", kind)
    spy("ours", ld_split, "split_corrections", lambda kw: "split")
    spy("jax", jax_int8, "sym_scan_segment", kind)
    spy("jax", jax_split, "split_corrections", lambda kw: "split")

    def route(where):
        s = seen[where]
        out = "split" if "split" in s else s[0]
        s.clear()
        return out

    return route


def _routing_case(rng, case):
    if case.startswith("rows"):
        frac = {"rows002": 0.02, "rows02": 0.2}[case]
        g = row_level_missing(rng, 256, 192, row_frac=frac, entry_rate=0.3)
        return g, make_positions(256, spacing=650, jitter_rng=rng), {}, \
            "split"
    if case == "every_row":
        g = random_genotypes(rng, 180, 200, missing_rate=0.05)
        assert (g < 0).any(axis=1).mean() > 0.9
        return g, make_positions(180, spacing=900, jitter_rng=rng), {}, \
            "global"
    if case == "unusable_only":
        g = _unusable_only(rng)
        return g, make_positions(120, spacing=800, jitter_rng=rng), \
            {"maf_thr": 0.05}, "clean"
    g = _adversarial(rng)
    pos = make_positions(g.shape[0], spacing=400, jitter_rng=rng,
                         skip_idx=(3, 25))
    return g, pos, {"split_missing": True}, "split"


@pytest.mark.parametrize("case", ["rows002", "rows02", "every_row",
                                  "unusable_only", "forced_adversarial"])
def test_default_routing_matches_jax(rng, monkeypatch, case):
    g, pos, extra, want = _routing_case(rng, case)
    route = _route_spies(monkeypatch)
    kw = {**KW, "block_size": 32, **extra}
    ours = pipeline.compute_ld_scores(g, pos, LDConfig(**kw), device="cpu")
    theirs = jax_pipeline.compute_ld_scores(g, pos, JaxLDConfig(**kw))
    assert route("ours") == route("jax") == want
    check(ours, theirs)


@pytest.mark.parametrize("row_frac", [0.02, 0.2])
def test_port_split_equals_port_global(rng, monkeypatch, row_frac):
    g = row_level_missing(rng, 256, 192, row_frac=row_frac, entry_rate=0.3)
    pos = make_positions(256, spacing=650, jitter_rng=rng)
    route = _route_spies(monkeypatch)
    split = pipeline.compute_ld_scores(
        g, pos, LDConfig(**KW, block_size=64, split_missing=True),
        device="cpu")
    assert route("ours") == "split"
    glob = pipeline.compute_ld_scores(
        g, pos, LDConfig(**KW, block_size=64, split_missing=False),
        device="cpu")
    assert route("ours") == "global"
    for k in ("l2_ws", "l2d_ws", "l2d_wse"):
        np.testing.assert_array_equal(split[k], glob[k], err_msg=k)
    for k in ("l2", "l2d"):
        np.testing.assert_allclose(split[k], glob[k], rtol=1e-5, atol=1e-5,
                                   equal_nan=True, err_msg=k)
    np.testing.assert_array_equal(np.isnan(split["l2"]), np.isnan(glob["l2"]))


def test_engine_pallas_never_splits(rng, monkeypatch):
    g = row_level_missing(rng, 128, 150, row_frac=0.05, entry_rate=0.3)
    route = _route_spies(monkeypatch)
    pipeline.compute_ld_scores(g, make_positions(128, spacing=650),
                               LDConfig(**KW, block_size=32,
                                        use_pallas=True), device="cpu")
    assert route("ours") == "global"


@pytest.mark.parametrize("flag, split", [("--split-missing", True),
                                         ("--no-split-missing", False)])
def test_cli_split_flags_match_jax(rng, tmp_path, monkeypatch, flag, split):
    g = row_level_missing(rng, 300, 203, row_frac=0.05, entry_rate=0.2)
    bp = make_positions(300, spacing=600, jitter_rng=rng).astype(np.int64)
    prefix = write_plink(tmp_path / "chr22", g, bp=bp)
    ours, theirs = str(tmp_path / "ours.L2"), str(tmp_path / "theirs.L2")
    route = _route_spies(monkeypatch)
    cli.main(["ld", "--bfile", prefix, "-kb", "5", "-maf", "0.01", "-o",
              ours, "--device", "cpu", "--block-size", "64", "--extra",
              flag])
    jax_pipeline.estimate_lds(prefix, ld_wind=5, wind_metric="kbp",
                              maf_thr=0.01, std_thr=1e-4, out=theirs,
                              extra=True, block_size=64, split_missing=split,
                              n_devices=1)
    want = "split" if split else "global"
    assert route("ours") == route("jax") == want
    a, b = _read_l2(ours), _read_l2(theirs)
    assert list(a) == list(b)
    for k in ("CHR", "BP", "WSA", "WSD", "WSDE"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ("L2", "L2D", "MAF", "RSTD"):
        np.testing.assert_allclose(a[k], b[k], rtol=2e-5, atol=2e-4,
                                   equal_nan=True, err_msg=k)


def test_library_path_tracks_headers(tmp_path, monkeypatch):
    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {k: _build.library_path(k) for k in ("ld_sym", "split_corr")}
    header = tmp_path / "pair_epilogue.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {k: _build.library_path(k) for k in before}
    for k in before:
        assert before[k] != after[k], k
        assert after[k].name.startswith(f"lib{k}-")
    (tmp_path / "new_header.cuh").write_text("#pragma once\n")
    assert _build.library_path("ld_sym") != after["ld_sym"]
