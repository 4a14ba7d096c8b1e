#!/usr/bin/env python3
"""Probe ATen's CPU square root (MKL VML): the cause of fault F4.

    python3 scripts/probe_vml_sqrt.py [--procs 60] [--threads 8]

Prints, for this machine's torch (no GPU needed):

1. ``torch.sqrt`` of 24,576 uniform float32 and float64 values
   (contiguous, strided, and ``torch.pow(x, 0.5)``) against the correctly
   rounded square root, and VML's ``vmsSqrt`` in its LA, HA and EP modes
   on the same values, called through ``libtorch_cpu`` with ctypes;
2. VML's dispatch: the raw CPU code ``mkl_serv_vml_cpu_detect`` returns,
   the table index ``mkl_vml_serv_cpu_detect`` caches, and the square root
   kernel each of them selects for an HA call
   (``mkl_vml_kernel_GetTTableIndex`` into ``mkl_vml_kernel_sSqrt_ttab``);
3. the race: ``--procs`` fresh processes that each run 12 bool->float32
   row sums at ``--threads`` threads and then their first ``torch.sqrt``
   of 24,576 values, counting those with a value off by more than 1e-6
   relative (float32; 1e-14 for float64); again with
   ``GOMP_SPINCOUNT=0``, and again after a first ``torch.sqrt`` of 16
   values (which runs on one thread).

Parts 1-2 need a torch that links MKL with its symbols exported (x86
builds); without them they say so and part 3 still runs.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

N = 24_576
MODES = {"LA": 0x1, "HA": 0x2, "EP": 0x3}
#: VML_FTZDAZ_OFF | VML_ERRMODE_IGNORE, as ATen passes them
FLAGS = 0x00140000 | 0x100
ISAS = ("EX", "E2", "H8", "L9", "Z0")


def exact(x: np.ndarray) -> np.ndarray:
    """The correctly rounded square root (float64 for float32 inputs)."""
    if x.dtype == np.float32:
        return np.sqrt(x.astype(np.float64)).astype(np.float32)
    return np.sqrt(x)


def child(variant: str, dtype: str) -> int:
    """One fresh process of part 3; prints ``CHUNK`` or ``ok``."""
    import torch

    torch.set_num_threads(int(os.environ["PROBE_THREADS"]))
    g = torch.from_numpy(np.random.default_rng(1).integers(
        0, 3, (N, 128), dtype=np.int8))
    for _ in range(2):
        torch.cat([(g[r:r + 4096] == 1).sum(dim=1, dtype=torch.float32)
                   for r in range(0, N, 4096)])
    if variant == "one-thread-first":
        torch.sqrt(torch.ones(16, dtype=getattr(torch, dtype)))
    x = np.random.default_rng(0).uniform(1e-3, 1.0, N).astype(dtype)
    got = torch.sqrt(torch.from_numpy(x)).numpy()
    rel = float(np.max(np.abs(got / exact(x) - 1)))
    tol = 1e-6 if dtype == "float32" else 1e-14
    print("CHUNK" if rel > tol else "ok")
    return 0


def vml_library(torch):
    lib = ctypes.CDLL(str(Path(torch.__file__).parent / "lib"
                          / "libtorch_cpu.so"))
    try:
        lib.vmsSqrt, lib.mkl_vml_kernel_sSqrt_ttab
    except AttributeError:
        return None
    return lib


def part1(torch, lib) -> None:
    # a first VML call on one thread, so that part 1 cannot meet the race
    torch.sqrt(torch.ones(16))
    rng = np.random.default_rng(0)
    for dtype in (np.float32, np.float64):
        x = rng.uniform(1e-3, 1.0, N).astype(dtype)
        want = exact(x)
        t = torch.from_numpy(x)
        wide = torch.zeros(2 * N, dtype=t.dtype)
        wide[::2] = t
        got = {"torch.sqrt": torch.sqrt(t), "strided": torch.sqrt(wide[::2]),
               "pow 0.5": torch.pow(t, 0.5)}
        off = {k: int((v.numpy() != want).sum()) for k, v in got.items()}
        line = f"{np.dtype(dtype).name}: rows off of {N}: {off}"
        if lib is not None and dtype == np.float32:
            f = lib.vmsSqrt
            f.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int64]
            for mode, bits in MODES.items():
                r = np.empty_like(x)
                f(N, x.ctypes.data, r.ctypes.data, bits | FLAGS)
                rel = float(np.max(np.abs(r / want - 1)))
                same = np.array_equal(r, got["torch.sqrt"].numpy())
                line += (f"; vmsSqrt {mode} {int((r != want).sum())} off, "
                         f"max rel {rel:.3g}{' (= torch.sqrt)' * same}")
        print(line)


def part2(lib) -> None:
    names = {}
    for isa in ISAS:
        for acc in ("HAynn", "LAynn", "EPnnn"):
            name = f"mkl_vml_kernel_sSqrt_{isa}{acc}"
            try:
                names[ctypes.cast(getattr(lib, name),
                                  ctypes.c_void_p).value] = name
            except AttributeError:
                pass
    table = ctypes.cast(lib.mkl_vml_kernel_sSqrt_ttab,
                        ctypes.POINTER(ctypes.c_void_p))
    raw = lib.mkl_serv_vml_cpu_detect()
    mapped = lib.mkl_vml_serv_cpu_detect()
    for what, cpu in (("cached index", mapped), ("raw code", raw)):
        idx = lib.mkl_vml_kernel_GetTTableIndex(cpu)
        print(f"VML dispatch: {what} {cpu} -> HA table entry {idx} = "
              f"{names.get(table[idx], hex(table[idx] or 0))}")


def part3(procs: int, threads: int) -> None:
    for dtype in ("float32", "float64"):
        for variant, env in (("default", {}),
                             ("GOMP_SPINCOUNT=0", {"GOMP_SPINCOUNT": "0"}),
                             ("one-thread-first", {})):
            e = dict(os.environ, PROBE_THREADS=str(threads), **env)
            bad = sum(subprocess.run(
                [sys.executable, __file__, "--child", variant, dtype],
                env=e, capture_output=True, text=True, check=True,
                timeout=120).stdout.strip() == "CHUNK" for _ in range(procs))
            print(f"race, {dtype}, {variant}: {bad} of {procs} fresh "
                  f"processes had a chunk off", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=60)
    ap.add_argument("--threads", type=int, default=8)
    a = ap.parse_args()
    import torch

    print(f"torch {torch.__version__}, "
          f"{torch.backends.cpu.get_cpu_capability()}, "
          f"{torch.get_num_threads()} threads")
    lib = vml_library(torch)
    part1(torch, lib)
    if lib is None:
        print("VML dispatch: no exported MKL VML symbols in libtorch_cpu")
    else:
        part2(lib)
    part3(a.procs, a.threads)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2], sys.argv[3]))
    sys.exit(main())
