"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under ``veneur_tpu_torch/csrc/`` compiles into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), for ``sm_90a``, into ``build/kernels/`` at the repository root.
The library's file name carries a hash of its source and flags, so an
edited source never loads a stale build. A build runs at first use;
:func:`build` starts one nvcc per missing library, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCES = {"tdigest_merge": _PKG / "csrc" / "tdigest_merge.cu"}
BUILD_DIR = _PKG.parent / "build" / "kernels"
# -fmad=false: no fused multiply-add, so the kernels round exactly like
# their plain PyTorch versions (see csrc/tdigest_merge.cu)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

_loaded: dict = {}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA "
                           "toolkit on PATH to build the port's kernels")
    return found


def library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=None) -> dict:
    """Compile every named library that is not built yet, one nvcc each,
    all started together. Returns {name: compiler stderr} for the ones it
    built (ptxas prints each kernel's registers and shared memory there);
    raises with the compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])]
        jobs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    logs, failed = {}, []
    for name, (out, tmp, proc) in jobs.items():
        stdout, stderr = proc.communicate()
        logs[name] = stdout + stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                          f"{logs[name]}")
        else:
            os.replace(tmp, out)  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
