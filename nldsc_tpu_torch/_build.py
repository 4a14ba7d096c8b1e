"""Build the port's CUDA kernels with nvcc at first use.

Each ``csrc/<name>.cu`` compiles into a shared library with a plain C
interface, ``build/nldsc_tpu_torch/lib<name>-<hash>.so`` beside the
package, and is loaded with ``ctypes``.  The hash covers the source and
the flags, so an edited kernel rebuilds and an unchanged one loads at
once.  A failed build raises with the compiler's output.
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

# -fmad=false: every float32 operation of the epilogues rounds on its
# own, in the order of the plain twins, so threshold counts agree exactly
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
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if needed."""
    if name in _LIBS:
        return _LIBS[name]
    out = library_path(name)
    log_path = out.with_name(out.name + ".log")
    seconds = 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.time()
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {name}.cu "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        log_path.write_text(proc.stderr)
        os.replace(tmp, out)
        seconds = time.time() - t0
    BUILD_INFO[name] = {"seconds": seconds,
                        "log": log_path.read_text() if log_path.exists()
                        else ""}
    lib = ctypes.CDLL(str(out))
    _LIBS[name] = lib
    return lib
