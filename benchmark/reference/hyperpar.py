"""Noise and tissue levels of an observation, and the fit's weights from them.

A frozen copy of the plain estimate that UniRes makes (nitorch's
``estimate_noise`` as the reference calls it, unires/_core.py:96-142): the
non-negative voxels histogrammed in 1024 bins, a two-class Gaussian mixture
fitted by EM on the histogram in float64; the background class gives the
noise sd (tau = 1 / sd^2), the classes' gap the tissue level mu. Channel c's
prior weight is lambda_c = reg_scl sqrt(1 / C) / mean(mu of its
observations) at the schedule's last position (its weight ``reg_scl``).
"""
from __future__ import annotations

import math

import numpy as np


def _gmm2(centers, counts, max_iter=1000, tol=1e-8):
    """(means, sds) of a 2-class 1D GMM fitted by EM to binned data."""
    tot = counts.sum()
    cdf = np.cumsum(counts) / tot
    med = centers[np.searchsorted(cdf, 0.5)]

    def mom(w):
        s = w.sum()
        if s <= 0:
            return centers.mean(), centers.std() + 1e-3, 1e-9
        m = (w * centers).sum() / s
        v = (w * (centers - m) ** 2).sum() / s
        return m, np.sqrt(max(v, 1e-12)), s / tot

    m1, s1, p1 = mom(counts * (centers <= med))
    m2, s2, p2 = mom(counts * (centers > med))
    ll_old = -np.inf
    for _ in range(max_iter):
        l1 = (np.log(max(p1, 1e-30)) - 0.5 * ((centers - m1) / s1) ** 2
              - np.log(s1) - 0.918938533)
        l2 = (np.log(max(p2, 1e-30)) - 0.5 * ((centers - m2) / s2) ** 2
              - np.log(s2) - 0.918938533)
        mx = np.maximum(l1, l2)
        lse = mx + np.log(np.exp(l1 - mx) + np.exp(l2 - mx))
        r1 = np.exp(l1 - lse)
        ll = (counts * lse).sum() / tot
        m1, s1, p1 = mom(counts * r1)
        m2, s2, p2 = mom(counts * (1.0 - r1))
        if abs(ll - ll_old) < tol * max(1.0, abs(ll)):
            break
        ll_old = ll
    return np.array([m1, m2]), np.array([s1, s2])


def noise_and_level(x: np.ndarray):
    """(background sd, tissue level mu) of an observation's voxels."""
    v = np.asarray(x).ravel()
    v = v[v >= 0]
    vmin, vmax = float(v.min()), float(v.max())
    counts, edges = np.histogram(v, bins=1024, range=(vmin, vmax))
    centers = 0.5 * (edges[:-1] + edges[1:])
    means, sds = _gmm2(centers, np.asarray(counts, np.float64))
    bg = int(np.argmin(means))
    sd = max(float(sds[bg]), max(1e-6 * (vmax - vmin), 1e-12))
    return sd, float(abs(means[1 - bg] - means[bg]))


def weights(channels, reg_scl):
    """(tau per observation, lambda per channel) of ``channels``: per channel
    the list of its observations' voxels (numpy)."""
    taus, lams = [], []
    C = len(channels)
    for obs in channels:
        est = [noise_and_level(x) for x in obs]
        taus.extend(1.0 / sd ** 2 for sd, _ in est)
        lams.append(float(reg_scl) * math.sqrt(1.0 / C)
                    / float(np.mean([mu for _, mu in est])))
    return taus, lams
