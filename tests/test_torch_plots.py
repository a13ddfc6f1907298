"""The port's dashboards (``unires_torch.utils.plots``) and what drives them
from the fit: ``plot_conv``, ``show_jtv``, the verbosity-3 slices, and the
``profile_dir`` trace. None of them may change the fit: the objective trace
with them on equals the trace without, digit for digit.
"""
import glob
import importlib
import json
import os

import numpy as np
import pytest
import torch

import unires_torch
from phantoms import blob_phantom, degrade
from unires_torch.pipeline.fit import fit as t_fit
from unires_torch.utils import plots

torch.set_num_threads(2)
# the module, not the ``fit`` function the package re-exports under its name
fit_mod = importlib.import_module("unires_torch.pipeline.fit")

KW = dict(vx=1.0, do_coreg=False, do_print=0, max_iter=6, tolerance=0,
          write_out=False, device="cpu")


@pytest.fixture(autouse=True)
def _headless(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)  # Agg, nothing shown


@pytest.fixture(scope="module")
def chans():
    gt = blob_phantom(dim=(16, 16, 17), amplitude=1000.0, seed=5)
    out = []
    for ax, seed in ((2, 11), (0, 22)):
        x, mat, _ = degrade(gt, thick_axis=ax, thick=4.0, noise_sd=30.0,
                            seed=seed)
        out.append([np.asarray(x), mat])
    return out


@pytest.fixture(scope="module")
def plain_trace(chans):
    return t_fit(*unires_torch.init(chans, unires_torch.Settings(**KW)))[3]


@pytest.mark.parametrize("vol", [
    np.random.default_rng(0).random((8, 9, 10)).astype(np.float32),
    torch.arange(720.0).reshape(8, 9, 10)], ids=["numpy", "tensor"])
def test_show_slices_returns_a_figure_and_writes_a_png(tmp_path, vol):
    png = str(tmp_path / "s.png")
    fig = plots.show_slices(vol, title="t", fig_num=7, cmap="coolwarm",
                            save_to=png)
    assert len(fig.axes) == 3
    assert [a.get_title() for a in fig.axes] == ["t sagittal", "t coronal",
                                                 "t axial"]
    assert open(png, "rb").read(8) == b"\x89PNG\r\n\x1a\n"


def test_plot_convergence_returns_a_figure_and_writes_a_png(tmp_path):
    png = str(tmp_path / "c.png")
    trace = np.cumsum(np.ones((5, 3)), axis=0)
    fig = plots.plot_convergence(trace, save_to=png)
    assert len(fig.axes[0].lines) == 3
    np.testing.assert_array_equal(fig.axes[0].lines[1].get_ydata(),
                                  trace[:, 1])
    assert open(png, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    assert plots.plot_convergence(np.zeros((0, 3))) is None


def test_a_plot_without_matplotlib_raises_naming_the_setting(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ImportError, match=r"Settings\.show_jtv needs"):
        plots.require_matplotlib(unires_torch.Settings(show_jtv=True))
    with pytest.raises(ImportError, match=r"Settings\.plot_conv / Settings"):
        plots.require_matplotlib(unires_torch.Settings(plot_conv=True,
                                                       do_print=3))
    plots.require_matplotlib(unires_torch.Settings())  # asks for no plot


def test_fit_with_every_dashboard_gives_the_same_trace(chans, plain_trace,
                                                       monkeypatch, capsys):
    drawn = []
    for name in ("show_slices", "plot_convergence"):
        fn = getattr(plots, name)
        monkeypatch.setattr(
            fit_mod, name,
            lambda *a, _fn=fn, _n=name, **kw: (drawn.append(
                (_n, kw.get("title"))), _fn(*a, **kw))[1])
    sett = unires_torch.Settings(**dict(KW, plot_conv=True, show_jtv=True,
                                        do_print=3))
    _, _, _, obj, n = t_fit(*unires_torch.init(chans, sett))
    capsys.readouterr()
    assert n == 6
    np.testing.assert_array_equal(obj, plain_trace)
    # per chunk (the 6 iterations are one chunk of chunk_iters 16): a
    # slice figure per channel, the convergence, the JTV
    assert len(drawn) == 4
    assert drawn == [("show_slices", "y (channel 0) @ iter 6"),
                     ("show_slices", "y (channel 1) @ iter 6"),
                     ("plot_convergence", None), ("show_slices", "JTV")]


def test_profile_dir_writes_a_trace_and_leaves_the_fit_alone(
        chans, plain_trace, tmp_path):
    d = str(tmp_path / "prof")
    sett = unires_torch.Settings(**dict(KW, profile_dir=d))
    _, _, _, obj, _ = t_fit(*unires_torch.init(chans, sett))
    np.testing.assert_array_equal(obj, plain_trace)
    files = glob.glob(os.path.join(d, "*.pt.trace.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 1000
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)


def test_profiler_is_closed_when_the_fit_raises(chans, tmp_path, monkeypatch):
    d = str(tmp_path / "prof")
    x, y, sett = unires_torch.init(chans, unires_torch.Settings(
        **dict(KW, profile_dir=d)))

    def boom(self, *args):
        raise RuntimeError("step failed")

    monkeypatch.setattr(fit_mod.FitRun, "step", boom)
    with pytest.raises(RuntimeError, match="step failed"):
        t_fit(x, y, sett)
    assert len(glob.glob(os.path.join(d, "*.pt.trace.json"))) == 1
    # a second profiler can start: the first one was stopped
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.ones(3).sum()
    assert prof.key_averages()
