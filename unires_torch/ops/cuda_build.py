"""Build and load the port's CUDA kernels (``unires_torch/csrc/*.cu``).

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``), one process
per source, all started together, and linked into one shared library with a
plain C interface, loaded with ``ctypes``: no PyTorch headers, so a build
takes seconds. The library lands in
``build/unires_torch_kernels/`` at the root of the checkout, named by a hash
of the sources and the build command, so an edited source is rebuilt and a
stale library is never loaded. Nothing is built at import time: the first
kernel launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "unires_torch_kernels"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC"]
_COMPILE = [f for f in _FLAGS if f != "-shared"] + ["-c"]

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C signatures of csrc/resample.cu and csrc/graph.cu (every pointer and the
# stream as c_void_p, so that ctypes never truncates a 64-bit address)
_SIGNATURES = {
    "unires_pull": [_VP] * 4 + [_I] * 7 + [_VP, _VP],
    "unires_push": [_VP] * 4 + [_I] * 10 + [_VP, _VP],
    "unires_pull_grad": [_VP, _VP, _VP] + [_I] * 6 + [_VP, _VP],
    "unires_pull_batch": [_VP] * 4 + [_I] * 8 + [_LL, _VP, _VP],
    "unires_push_batch": [_VP] * 4 + [_I] * 11 + [_LL, _VP, _VP],
    "unires_pull_grad_batch": [_VP, _VP, _VP] + [_I] * 7 + [_LL, _VP, _VP],
    "unires_if_begin": [_VP] * 4,
    "unires_if_end": [_VP, _VP],
    "unires_while_begin": [_VP] * 5,
    "unires_while_end": [ctypes.c_ulonglong, _VP, _VP, _VP],
    "unires_capture_nodes": [_VP, _VP],
    "unires_stream_create": [_VP],
}


def nvcc_path() -> str:
    """nvcc on the PATH, else under PyTorch's idea of the CUDA home."""
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libunires_torch_kernels_{h.hexdigest()[:16]}.so"


def _nvcc(cmds) -> None:
    """Run the nvcc commands ``cmds``, all started together; raise naming
    the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{out}")


class _Kernels:
    """The loaded library and how long its build took (0 when it was cached)."""

    def __init__(self):
        self.lib = None
        self.build_seconds = None

    def get(self) -> ctypes.CDLL:
        if self.lib is None:
            self.lib = self._load()
        return self.lib

    def _load(self) -> ctypes.CDLL:
        so = library_path()
        t0 = time.perf_counter()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o")
                    for src in _sources()]
            try:
                nvcc = nvcc_path()
                _nvcc([[nvcc, *_COMPILE, "-o", str(o), str(src)]
                       for src, o in zip(_sources(), objs)])
                _nvcc([[nvcc, *_FLAGS, "-o", str(tmp), *map(str, objs)]])
                os.replace(tmp, so)
            finally:
                for o in objs:
                    o.unlink(missing_ok=True)
        self.build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        return lib


kernels = _Kernels()


def check(err: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
