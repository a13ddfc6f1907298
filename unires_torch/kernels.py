"""Slice-profile kernels (host-side, numpy; shapes static per operator).

A numpy copy of ``unires_tpu.kernels``.

Re-implements the behavior of nitorch.core.kernels.smooth as pinned by its
single call-site in the reference (unires/_project.py:276-278):

    fwhm = (1 - gap) * ratio
    smo_ker = smooth(profile, fwhm, sep=False)

Profiles (per axis): -1 = dirac, 0 = rect, 1 = triangle, 2 = gaussian.
Each 1D kernel tap integrates the profile over the unit voxel centred at the
tap (i.e. profile convolved with a rect(1) basis), then the taps are
normalised to sum 1 so the forward operator A preserves mean intensity.
``sep=False`` -> full ND kernel = outer product of the 1D kernels.
"""
from __future__ import annotations

import math

import numpy as np


def _phi(x):
    """Standard normal CDF."""
    return 0.5 * (1.0 + np.vectorize(math.erf)(np.asarray(x, dtype=np.float64) / math.sqrt(2.0)))


def _rect_integral(lo, hi, w):
    """Integral over [lo, hi] of the unit-mass boxcar of full width w."""
    a, b = -w / 2.0, w / 2.0
    return np.clip(np.minimum(hi, b) - np.maximum(lo, a), 0.0, None) / w


def _tri_integral(lo, hi, w):
    """Integral over [lo, hi] of the unit-mass triangle with FWHM w.

    Triangle f(x) = max(0, 1 - |x|/w) has full width at half maximum w and
    total mass w (support [-w, w]); normalise by w.
    """

    def F(t):  # antiderivative of max(0, 1 - |t|/w), cumulative from -inf
        t = np.clip(t, -w, w)
        return np.where(t <= 0, 0.5 * (t + w) ** 2 / w, w - 0.5 * (w - t) ** 2 / w)

    return (F(hi) - F(lo)) / w


def _gauss_integral(lo, hi, w):
    """Integral over [lo, hi] of the unit-mass gaussian with FWHM w."""
    sd = w / math.sqrt(8.0 * math.log(2.0))
    return _phi(hi / sd) - _phi(lo / sd)


def kernel_1d(profile: int, fwhm: float) -> np.ndarray:
    """1D slice-profile kernel, odd length, normalised to sum 1.

    Args:
        profile: -1 dirac | 0 rect | 1 triangle | 2 gaussian.
        fwhm: full width at half maximum (in voxels of the target grid).
    """
    fwhm = float(fwhm)
    if profile == -1 or fwhm <= 1e-6:
        return np.ones(1, dtype=np.float64)
    if profile == 0:
        radius = int(math.ceil((fwhm + 1.0) / 2.0 - 0.5))
        fn = _rect_integral
    elif profile == 1:
        radius = int(math.ceil(fwhm + 0.5))
        fn = _tri_integral
    elif profile == 2:
        sd = fwhm / math.sqrt(8.0 * math.log(2.0))
        radius = max(1, int(math.ceil(3.0 * sd + 0.5)))
        fn = _gauss_integral
    else:
        raise ValueError(f"Unknown profile {profile}")
    t = np.arange(-radius, radius + 1, dtype=np.float64)
    ker = fn(t - 0.5, t + 0.5, fwhm)
    # trim zero tails, keep odd symmetric support
    nz = np.nonzero(ker > 0)[0]
    lo, hi = nz[0], nz[-1]
    r = max(radius - lo, hi - radius)
    ker = ker[radius - r : radius + r + 1]
    s = ker.sum()
    if s > 0:
        ker = ker / s
    return ker


def smooth_kernel(profiles, fwhm, dtype=np.float32) -> np.ndarray:
    """Full ND (non-separable) slice-profile kernel: outer product of 1D taps.

    Args:
        profiles: per-axis profile codes, len 2 or 3.
        fwhm: per-axis FWHM, same length.

    Returns:
        Kernel of shape (k0, k1[, k2]) with sum 1, dtype float32 by default.
    """
    profiles = [int(p) for p in np.asarray(profiles).ravel()]
    fwhm = [float(f) for f in np.asarray(fwhm).ravel()]
    kers = [kernel_1d(p, f) for p, f in zip(profiles, fwhm)]
    out = kers[0]
    for k in kers[1:]:
        out = np.multiply.outer(out, k)
    return out.astype(dtype)
