"""Build the port's CUDA sources at first use and load them with ctypes.

Each `<name>.cu` in this directory compiles with nvcc for Hopper
(`sm_90a`) into a shared library with a plain C interface, cached under
`_build/` by a hash of everything it compiles from: its source, every
`*.cuh` header here, and the flags. A second process finds the library
there and skips the build; an edit to any of them builds anew. Nothing
builds at import: the CPU tests import every module of the port on a
machine with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build wall time (0.0 when the cache hit),
#          "log": nvcc's output, -Xptxas -v's registers/smem/spills}
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels build from source at first use")


def _lib_path(name: str) -> Path:
    """The library's path in the cache, keyed on the source, the headers
    it may include (all of this directory's `*.cuh`) and the flags."""
    h = hashlib.sha256()
    for f in (SRC_DIR / f"{name}.cu", *sorted(SRC_DIR.glob("*.cuh"))):
        h.update(f.name.encode() + b"\0" + f.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names) -> None:
    """Compile every named source that is not built yet, one nvcc per
    source, all started together; raise with nvcc's output on failure."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        procs = []
        for name in todo:
            path = _lib_path(name)
            if path.exists():
                build_info.setdefault(name, {"seconds": 0.0, "log": ""})
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".tmp{os.getpid()}")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(SRC_DIR / f"{name}.cu")]
            procs.append((name, path, tmp, time.perf_counter(),
                          subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
        failed = []
        for name, path, tmp, t0, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}.cu:\n{log}")
                continue
            os.replace(tmp, path)
            build_info[name] = {"seconds": time.perf_counter() - t0,
                                "log": log}
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for name in todo:
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `<name>.cu`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name]
    return lib


def sources() -> list[str]:
    """Names of every CUDA source of the port."""
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))
