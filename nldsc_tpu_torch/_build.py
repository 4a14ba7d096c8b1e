"""Build the port's CUDA kernels with nvcc at first use.

Each ``csrc/<name>.cu`` compiles into a shared library with a plain C
interface, ``build/nldsc_tpu_torch/lib<name>-<hash>.so`` beside the
package, and is loaded with ``ctypes``.  The hash covers the source,
every shared header ``csrc/*.cuh`` and the flags, so an edited kernel or
header rebuilds and an unchanged one loads at once.  A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "nldsc_tpu_torch"

# -fmad=false: no float32 multiply and add are contracted except the
# explicit __fmaf_rn of the epilogues, so every operation rounds as in the
# plain twins and threshold counts agree exactly
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

#: name -> loaded library; name -> {"seconds": nvcc seconds in this
#: process (0.0 when the library was already built), "log": ptxas report}
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_INFO: dict[str, dict] = {}


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> None:
    """Build the libraries of ``csrc/<name>.cu`` that are missing, one
    nvcc process each, all started together, and load them."""
    started = {}
    for name in names:
        if name in _LIBS:
            continue
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        started[name] = (proc, tmp, out, time.time())
    failed = []
    for name, (proc, tmp, out, t0) in started.items():
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed to build {name}.cu "
                          f"(exit {proc.returncode}):\n{stderr}")
            continue
        out.with_name(out.name + ".log").write_text(stderr)
        os.replace(tmp, out)
        BUILD_INFO[name] = {"seconds": time.time() - t0}
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        _load_built(name)


def _load_built(name: str) -> ctypes.CDLL:
    if name in _LIBS:
        return _LIBS[name]
    out = library_path(name)
    log_path = out.with_name(out.name + ".log")
    info = BUILD_INFO.setdefault(name, {"seconds": 0.0})
    info["log"] = log_path.read_text() if log_path.exists() else ""
    lib = ctypes.CDLL(str(out))
    _LIBS[name] = lib
    return lib


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if needed."""
    build(name)
    return _LIBS[name]
