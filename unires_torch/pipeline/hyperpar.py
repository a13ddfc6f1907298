"""Data-driven hyper-parameter estimation.

Re-implements the behavior of nitorch.tools.img_statistics.estimate_noise as
used by the reference (unires/_core.py:96-142): fit a 2-class intensity
mixture (background/noise vs foreground) per observation, and set
    sd  = background std, tau = 1/sd^2, mu = |mean_fg - mean_bg|.
Non-CT data is restricted to non-negative intensities first (:119-121).

Implementation: the volume is copied to the host once, histogrammed there
(1024 bins), and the 2-class mixture EM runs on the histogram in float64. A
copy of ``unires_tpu.pipeline.hyperpar`` that takes torch tensors.
"""
from __future__ import annotations

from timeit import default_timer as timer

import numpy as np
import torch

from ..utils.log import info


def fit_gmm2(centers: np.ndarray, counts: np.ndarray, max_iter: int = 1000,
             tol: float = 1e-8):
    """2-class 1D GMM EM on binned data. Returns (means, sds, weights)."""
    centers = np.asarray(centers, np.float64)
    counts = np.asarray(counts, np.float64)
    tot = counts.sum()
    if tot <= 0:
        return np.array([0.0, 1.0]), np.array([1.0, 1.0]), np.array([0.5, 0.5])
    # init: split mass at the median
    cdf = np.cumsum(counts) / tot
    med = centers[np.searchsorted(cdf, 0.5)]
    lo = counts * (centers <= med)
    hi = counts * (centers > med)

    def mom(w):
        s = w.sum()
        if s <= 0:
            return centers.mean(), centers.std() + 1e-3, 1e-9
        m = (w * centers).sum() / s
        v = (w * (centers - m) ** 2).sum() / s
        return m, np.sqrt(max(v, 1e-12)), s / tot

    m1, s1, p1 = mom(lo)
    m2, s2, p2 = mom(hi)
    ll_old = -np.inf
    for _ in range(max_iter):
        # E-step (in log space for stability)
        def logpdf(m, s):
            return -0.5 * ((centers - m) / s) ** 2 - np.log(s) - 0.918938533
        l1 = np.log(max(p1, 1e-30)) + logpdf(m1, s1)
        l2 = np.log(max(p2, 1e-30)) + logpdf(m2, s2)
        mx = np.maximum(l1, l2)
        lse = mx + np.log(np.exp(l1 - mx) + np.exp(l2 - mx))
        r1 = np.exp(l1 - lse)
        ll = (counts * lse).sum() / tot
        # M-step
        m1, s1, p1 = mom(counts * r1)
        m2, s2, p2 = mom(counts * (1.0 - r1))
        if abs(ll - ll_old) < tol * max(1.0, abs(ll)):
            break
        ll_old = ll
    means = np.array([m1, m2])
    sds = np.array([s1, s2])
    ps = np.array([p1, p2])
    return means, sds, ps


def fit_rice2(centers: np.ndarray, counts: np.ndarray, max_iter: int = 1000,
              tol: float = 1e-8):
    """2-class 1D Rician-mixture EM on binned magnitude data.

    Rice pdf f(x|nu,sig) = x/sig^2 exp(-(x^2+nu^2)/(2 sig^2)) I0(x nu/sig^2);
    ECM updates use the scaled Bessel ratio I1/I0 (SPM's spm_noise_estimate
    scheme; the reference's nitorch estimate_noise exposes the same choice —
    SURVEY §2.2 'Gaussian/Rician'). Returns (nus, sigs, weights, means).
    """
    from scipy.special import i0e, i1e

    centers = np.asarray(centers, np.float64)
    counts = np.asarray(counts, np.float64)
    tot = counts.sum()
    if tot <= 0 or (centers < 0).any():
        m, s, p = fit_gmm2(centers, counts)
        return m, s, p, m
    cdf = np.cumsum(counts) / tot
    med = centers[np.searchsorted(np.clip(cdf, 0, 1), 0.5)]
    span = max(centers.max() - centers.min(), 1e-9)
    nus = np.array([max(med * 0.1, 1e-3 * span), max(med * 2.0, 2e-3 * span)])
    sigs = np.array([max(med * 0.5, 1e-3 * span)] * 2)
    ws = np.array([0.5, 0.5])
    x = np.maximum(centers, 1e-12 * span)
    ll_old = -np.inf
    for _ in range(max_iter):
        logp = np.empty((2, x.size))
        for k in range(2):
            s2 = sigs[k] ** 2
            z = x * nus[k] / s2
            logp[k] = (np.log(max(ws[k], 1e-30)) + np.log(x) - np.log(s2)
                       - (x ** 2 + nus[k] ** 2) / (2 * s2)
                       + np.log(np.maximum(i0e(z), 1e-300)) + z)
        mx = logp.max(axis=0)
        lse = mx + np.log(np.exp(logp - mx).sum(axis=0))
        r = np.exp(logp - lse)
        ll = (counts * lse).sum() / tot
        for k in range(2):
            w = counts * r[k]
            m0 = max(w.sum(), 1e-30)
            s2 = sigs[k] ** 2
            z = x * nus[k] / s2
            ratio = i1e(z) / np.maximum(i0e(z), 1e-300)
            m1r = (w * x * ratio).sum()
            m2 = (w * x * x).sum()
            nu = max(m1r / m0, 0.0)
            s2_new = (m2 + nu ** 2 * m0 - 2 * nu * m1r) / (2 * m0)
            nus[k] = nu
            sigs[k] = np.sqrt(max(s2_new, (1e-6 * span) ** 2))
            ws[k] = m0 / tot
        if abs(ll - ll_old) < tol * max(1.0, abs(ll)):
            break
        ll_old = ll
    # Rice mean (Laguerre half): used only for bg/fg ordering and mu
    means = np.empty(2)
    for k in range(2):
        s2 = sigs[k] ** 2
        z2 = nus[k] ** 2 / (2 * s2)
        means[k] = (sigs[k] * np.sqrt(np.pi / 2)
                    * np.exp(-z2 / 2 + np.log(np.maximum(
                        i0e(z2 / 2) * (1 + z2) + i1e(z2 / 2) * z2, 1e-300))
                        + z2 / 2))
    return nus, sigs, ws, means


def estimate_noise(dat, is_ct: bool = False, bins: int = 1024,
                   model: str = "gaussian", show_fit: bool = False,
                   fig_num: int = 100):
    """(sd_bg, mean_bg, sd_fg, mean_fg) of the 2-class intensity fit.

    ``model`` 'gaussian' (reference default behaviour — the demo anchors
    sd=49.0 on sigma=75 Rayleigh background match a Gaussian fit) or
    'rician' (magnitude MR; the Rician sigma is the true noise sd).
    CT always uses the Gaussian mixture (negative HU values).
    """
    # histogram on host: one device->host copy of the volume
    if isinstance(dat, torch.Tensor):
        dat = dat.detach().cpu().numpy()
    v = np.asarray(dat).ravel()
    if not is_ct:
        v = v[v >= 0]
    if v.size == 0:
        return 1.0, 0.0, 1.0, 1.0
    vmin = float(v.min())
    vmax = float(v.max())
    if not np.isfinite(vmin) or vmax <= vmin:
        return 1.0, 0.0, 1.0, 1.0
    counts, edges = np.histogram(v, bins=bins, range=(vmin, vmax))
    counts = np.asarray(counts, np.float64)
    centers = 0.5 * (edges[:-1] + edges[1:])
    sd_floor = max(1e-6 * (vmax - vmin), 1e-12)
    if model == "rician" and not is_ct and vmin >= 0:
        nus, sigs, ws, means = fit_rice2(centers, counts)
        bg = int(np.argmin(means))
        fg = 1 - bg
        out = (float(max(sigs[bg], sd_floor)), float(means[bg]),
               float(max(sigs[fg], sd_floor)), float(means[fg]))
        if show_fit:
            _plot_noise_fit(centers, counts, ("rician", nus, sigs, ws),
                            fig_num)
        return out
    means, sds, ws = fit_gmm2(centers, counts)
    bg = int(np.argmin(means))
    fg = 1 - bg
    if show_fit:
        _plot_noise_fit(centers, counts, ("gaussian", means, sds, ws),
                        fig_num)
    # guard against a collapsed background class (e.g. heavily zero-inflated
    # data): tau = 1/sd^2 must stay finite and sane
    return (float(max(sds[bg], sd_floor)), float(means[bg]),
            float(max(sds[fg], sd_floor)), float(means[fg]))


def _plot_noise_fit(centers, counts, fit, fig_num: int):
    """Histogram + fitted class densities (reference show_hyperpar,
    unires/_core.py:124-126 via nitorch estimate_noise(show_fit=True))."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    kind, p1, p2, ws = fit
    tot = max(counts.sum(), 1e-30)
    width = centers[1] - centers[0] if centers.size > 1 else 1.0
    dens = counts / (tot * width)
    fig = plt.figure(fig_num, figsize=(6, 4))
    fig.clf()
    ax = fig.add_subplot(111)
    ax.bar(centers, dens, width=width, alpha=0.4, label="data")
    xs = np.linspace(centers.min(), centers.max(), 512)
    if kind == "gaussian":
        for k in range(2):
            pdf = ws[k] * np.exp(-0.5 * ((xs - p1[k]) / p2[k]) ** 2) / (
                p2[k] * np.sqrt(2 * np.pi))
            ax.plot(xs, pdf, label=f"class {k} (gauss)")
    else:
        from scipy.special import i0e

        xs_pos = np.maximum(xs, 1e-12)
        for k in range(2):
            s2 = p2[k] ** 2
            z = xs_pos * p1[k] / s2
            pdf = ws[k] * (xs_pos / s2) * np.exp(
                -(xs_pos ** 2 + p1[k] ** 2) / (2 * s2) + z) * i0e(z)
            ax.plot(xs, pdf, label=f"class {k} (rice)")
    ax.set_title("noise fit")
    ax.legend()
    fig.canvas.draw_idle()
    try:
        plt.pause(0.01)
    except Exception:
        pass


def estimate_hyperpar(x, sett):
    """Set sd/tau/mu on every observation (reference _core.py:96-142)."""
    t0 = info(sett, "hyper-start")
    model = getattr(sett, "noise_model", "gaussian")
    cnt = 0
    for c in range(len(x)):
        for o in x[c]:
            sd_bg, mu_bg, sd_fg, mu_fg = estimate_noise(
                o.dat, is_ct=o.ct, model=model,
                show_fit=bool(sett.show_hyperpar), fig_num=100 + cnt)
            o.sd = float(sd_bg)
            o.tau = float(1.0 / sd_bg ** 2)
            o.mu = float(abs(mu_fg - mu_bg))
            cnt += 1
    info(sett, "hyper-done", x, t0)
    return x
