"""Build and load the port's CUDA kernels (``unires_torch/csrc/*.cu``).

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``), one process
per source, all started together, and linked into one shared library with a
plain C interface, loaded with ``ctypes``: no PyTorch headers, so a build
takes seconds. The library lands in
``build/unires_torch_kernels/`` at the root of the checkout, named by a hash
of the sources and the build command, so an edited source is rebuilt and a
stale library is never loaded. Nothing is built at import time: the first
kernel launch builds.

Besides, what every kernel wrapper shares around its launch: the device
launch counter (:class:`KernelCount`, :class:`Counted`) and the launch
groups the fit reports (:data:`GROUPS`), the check of a launch's error code
and the int32 size check.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "unires_torch_kernels"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC"]
_COMPILE = [f for f in _FLAGS if f != "-shared"] + ["-c"]

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# the stencils of csrc/finite_diff.cu: input, output, scale, its stride,
# (nx, ny, nz), batch, the batch's stride, 1 / vx, counter, stream
_STENCIL = [_VP] * 3 + [_I] * 5 + [_LL] + [_F] * 3 + [_VP, _VP]
# the passes of csrc/blur.cu: input, output, (pre, n, nq) of its volumes, r,
# the taps (host floats) and their count, batch, the batch's stride,
# counter, stream
_BLUR = [_VP, _VP] + [_I] * 4 + [_VP, _I, _I, _LL, _VP, _VP]
# C signatures of csrc/resample.cu, csrc/finite_diff.cu, csrc/blur.cu,
# csrc/gn_stats.cu and csrc/graph.cu
# (every pointer and the stream as c_void_p, so that ctypes never truncates
# a 64-bit address)
_SIGNATURES = {
    "unires_pull": [_VP] * 4 + [_I] * 7 + [_VP, _VP],
    "unires_push": [_VP] * 4 + [_I] * 10 + [_VP, _VP],
    "unires_pull_grad": [_VP, _VP, _VP] + [_I] * 6 + [_VP, _VP],
    "unires_pull_batch": [_VP] * 4 + [_I] * 8 + [_LL, _VP, _VP],
    "unires_push_batch": [_VP] * 4 + [_I] * 11 + [_LL, _VP, _VP],
    "unires_pull_grad_batch": [_VP, _VP, _VP] + [_I] * 7 + [_LL, _VP, _VP],
    "unires_fd_gradient": _STENCIL,
    "unires_fd_divergence": _STENCIL,
    "unires_fd_membrane": _STENCIL,
    "unires_blur_down": _BLUR,
    "unires_blur_up": _BLUR,
    # gr, diff, ctc, the three coordinate vectors, (X, Y, Z), batch, the
    # three batch strides, partials, out, counter, stream
    "unires_gn_moments": [_VP] * 6 + [_I] * 4 + [_LL] * 3 + [_VP] * 4,
    "unires_gn_partials": [_I] * 3,
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


class KernelCount:
    """The launches of one kernel, counted by the kernel itself: thread 0
    of its first block adds one to a (launches, FOV = true launches) pair of
    64-bit device counters, one pair per device. A replay of a captured
    graph therefore counts what it launches, and a launch that a graph's
    conditional node skips counts nothing. Reading a count waits for the
    device; setting one zeroes the device counters."""

    def __init__(self):
        self._dev = {}  # device index -> int64 tensor (2,)
        self._base = [0, 0]

    def ptr(self, device: torch.device) -> int:
        t = self._dev.get(device.index)
        if t is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("a kernel's first launch on a device must "
                                   "come before any graph capture")
            t = torch.zeros(2, dtype=torch.int64, device=device)
            self._dev[device.index] = t
        return t.data_ptr()

    def read(self, i: int) -> int:
        return self._base[i] + sum(int(t[i]) for t in self._dev.values())

    def mark(self) -> dict:
        """The device counters as they stand, copied on the device (no
        wait): the start of a :meth:`deltas`."""
        return {k: t.clone() for k, t in self._dev.items()}

    def deltas(self, mark: dict) -> dict:
        """{device index: launches counted since ``mark``}, as device
        tensors (no wait)."""
        return {k: t[0] - mark[k][0] if k in mark else t[0]
                for k, t in self._dev.items()}

    def set(self, i: int, value: int) -> None:
        for t in self._dev.values():
            t[i].zero_()
        self._base[i] = int(value)


# the launch groups a ``fit`` span reports: group name -> its kernels, each
# added where it is wrapped (``Counted(fn, group=...)``)
GROUPS: dict = {}


class Counted:
    """A kernel wrapper; ``launches`` / ``fov_launches`` read and set its
    :class:`KernelCount`; ``group`` adds it to that group of :data:`GROUPS`."""

    def __init__(self, fn, group: str = None):
        functools.update_wrapper(self, fn)
        self.count = KernelCount()
        if group is not None:
            GROUPS.setdefault(group, []).append(self)

    def __call__(self, *args, **kw):
        return self.__wrapped__(*args, **kw)

    launches = property(lambda self: self.count.read(0),
                        lambda self, v: self.count.set(0, v))
    fov_launches = property(lambda self: self.count.read(1),
                            lambda self, v: self.count.set(1, v))


def launch_marks(groups: dict = None) -> dict:
    """The device counters of each named group of :class:`Counted` kernels
    (``{name: kernels}``, default :data:`GROUPS`) as they stand, copied on
    the device (no wait): the start of a :func:`launches_since`."""
    groups = GROUPS if groups is None else groups
    return {name: {f: f.count.mark() for f in fns}
            for name, fns in groups.items()}


def launches_since(groups: dict = None, marks: dict = None) -> dict:
    """``{name: launches}`` of each group (default :data:`GROUPS`) since
    :func:`launch_marks` gave ``marks`` (a kernel it did not mark: since its
    first launch), on every device, from one read of each device (it waits
    for the device); 0 where no kernel of a group has launched."""
    groups = GROUPS if groups is None else groups
    parts = {}  # device index -> [(group, launches as a device tensor)]
    for name, fns in groups.items():
        for f in fns:
            mark = (marks or {}).get(name, {}).get(f, {})
            for k, n in f.count.deltas(mark).items():
                parts.setdefault(k, []).append((name, n))
    out = dict.fromkeys(groups, 0)
    for items in parts.values():
        counts = torch.stack([n for _, n in items]).tolist()
        for (name, _), n in zip(items, counts):
            out[name] += n
    return out


def volume_batch(t: torch.Tensor, nd: int, name: str):
    """``t`` (..., volume of ``nd`` axes) viewed as a kernel's batch (B,
    ...), or None for a CPU tensor, which takes the plain version. Raises
    for a CUDA tensor the kernels do not take: not float32 (TypeError), a
    volume not C-contiguous, or leading axes that no single stride
    describes (ValueError)."""
    if t.device.type == "cpu":
        return None
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
    if t.dim() < nd or t.numel() == 0:
        raise ValueError(f"{name}: expected non-empty volumes of {nd} axes, "
                         f"got {tuple(t.shape)}")
    if not t[(0,) * (t.dim() - nd)].is_contiguous():
        raise ValueError(f"{name}: the kernel needs contiguous volumes")
    try:
        return t.view((-1,) + tuple(t.shape[-nd:]))
    except RuntimeError:
        raise ValueError(f"{name}: the leading axes of {tuple(t.shape)} "
                         f"(strides {t.stride()}) do not fold into one "
                         f"batch stride") from None


def check_size(*dims) -> None:
    """Raise unless every volume of ``dims`` holds < 2**31 voxels: the
    kernels index in int32."""
    for dim in dims:
        if int(np.prod(np.asarray(dim, np.int64))) >= 2 ** 31:
            raise ValueError(f"volume {tuple(dim)} too large for int32 indexing")
