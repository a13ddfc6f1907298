"""Optional matplotlib visualisation (reference: nitorch show_slices /
plot_convergence, used at unires/run.py:91-99 behind plot_conv/show_jtv).

A copy of ``unires_tpu.utils.plots``. Host-side: matplotlib is imported at
the first plot, with the Agg backend where there is no display; figures are
saved or shown depending on the environment. Volumes arrive as numpy arrays
or torch tensors (copied to the host here). Without matplotlib a run that
asks for a plot raises :class:`ImportError` naming the setting that asked.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _plt(asked_by: str = "a plot"):
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(f"{asked_by} needs matplotlib, which is not "
                          "installed") from e
    if not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def require_matplotlib(sett) -> None:
    """Raise ImportError now, naming the setting, if ``sett`` asks for a
    plot and matplotlib is missing (rather than after the first iteration)."""
    asked = [n for n, on in (("Settings.plot_conv", sett.plot_conv),
                             ("Settings.show_jtv", sett.show_jtv),
                             ("Settings.do_print >= 3", sett.do_print >= 3))
             if on]
    if asked:
        _plt(" / ".join(asked))


def _host(vol) -> np.ndarray:
    if isinstance(vol, torch.Tensor):
        return vol.detach().cpu().numpy()
    return np.asarray(vol)


def show_slices(vol, title: str = "", fig_num: int = 1, cmap: str = "gray",
                save_to: str | None = None):
    """Orthogonal mid-slice viewer (nitorch show_slices equivalent)."""
    plt = _plt("show_slices")
    vol = _host(vol)
    fig, axes = plt.subplots(1, 3, num=fig_num, figsize=(12, 4), clear=True)
    mids = [s // 2 for s in vol.shape]
    views = [vol[mids[0], :, :], vol[:, mids[1], :], vol[:, :, mids[2]]]
    for ax, im, lbl in zip(axes, views, ("sagittal", "coronal", "axial")):
        ax.imshow(np.asarray(im).T, cmap=cmap, origin="lower")
        ax.set_title(f"{title} {lbl}".strip())
        ax.axis("off")
    fig.tight_layout()
    if save_to:
        fig.savefig(save_to, dpi=100)
    elif os.environ.get("DISPLAY"):
        plt.pause(0.01)
    return fig


def plot_convergence(obj_trace, fig_num: int = 99, save_to: str | None = None):
    """Objective triplet curves (reference plot_convergence, run.py:97-99)."""
    plt = _plt("plot_convergence")
    v = np.asarray(obj_trace, np.float64)
    if v.ndim != 2 or v.shape[0] < 1:
        return None
    fig, ax = plt.subplots(num=fig_num, clear=True)
    labels = ["-ln p(y|x)", "-ln p(x|y)", "-ln p(y)"]
    for i in range(min(3, v.shape[1])):
        ax.plot(v[:, i], label=labels[i])
    ax.set_xlabel("iteration")
    ax.set_ylabel("negative log-likelihood")
    ax.legend()
    fig.tight_layout()
    if save_to:
        fig.savefig(save_to, dpi=100)
    elif os.environ.get("DISPLAY"):
        plt.pause(0.01)
    return fig
