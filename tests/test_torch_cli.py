"""The port's command line (``unires_torch.cli``) against the JAX package's.

The parser must hold every flag of ``unires_tpu.cli`` with the same default
(``--device`` apart: it names a torch device). ``--linear`` runs through
both command lines on the same NIfTI file: same output file name, affines
equal, data to rtol 1e-5 / atol 1e-5 * max (float32 trilinear reslice). A
short fit on the CPU writes the JAX command line's file names with the
output affine, as tests/test_pipeline.py checks for the JAX package.
"""
import os
from argparse import ArgumentParser

import numpy as np
import pytest
import torch

import unires_torch.cli as tcli
import unires_tpu.cli as jcli
from phantoms import blob_phantom, degrade
from unires_torch.pipeline.nifti import load, save

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def nifti_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("inputs")
    gt = blob_phantom(dim=(32, 32, 33), amplitude=1000.0, seed=5)
    paths = []
    for c, seed in enumerate((11, 22)):
        x_obs, mat_x, _ = degrade(gt, thick_axis=2, thick=4.0, noise_sd=30.0,
                                  seed=seed)
        p = str(d / f"chan{c}.nii.gz")
        save(np.asarray(x_obs), p, affine=mat_x)
        paths.append(p)
    return paths


class _Stop(Exception):
    pass


def _jax_parser(monkeypatch):
    """The parser ``unires_tpu.cli.run`` builds, caught before it parses."""
    caught = []

    class Capture(ArgumentParser):
        def parse_args(self, *args, **kw):
            caught.append(self)
            raise _Stop

    monkeypatch.setattr(jcli, "ArgumentParser", Capture)
    with pytest.raises(_Stop):
        jcli.run([])
    return caught[0]


def test_parser_has_every_jax_flag_with_its_default(monkeypatch):
    want = {a.dest: a for a in _jax_parser(monkeypatch)._actions}
    got = {a.dest: a for a in tcli.build_parser()._actions}
    assert set(want) <= set(got)
    for dest, a in want.items():
        b = got[dest]
        assert a.option_strings == b.option_strings, dest
        assert (a.nargs, a.const, a.type, a.choices) == \
            (b.nargs, b.const, b.type, b.choices), dest
        if dest != "device":
            assert a.default == b.default, dest
    assert got["device"].default == "cuda"
    # every --flag has its --no-flag where the JAX parser has one
    opts = lambda p: {s for a in p._actions for s in a.option_strings}  # noqa: E731
    assert opts(_jax_parser(monkeypatch)) == opts(tcli.build_parser())


def test_cli_linear_matches_jax_cli(nifti_inputs, tmp_path):
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    tcli.run([nifti_inputs[0], "--linear", "--dir_out", out_t,
              "--print_info", "0", "--device", "cpu"])
    jcli.run([nifti_inputs[0], "--linear", "--dir_out", out_j,
              "--print_info", "0"])
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j)) \
        == ["u_chan0.nii.gz"]
    got, hdr_t = load(os.path.join(out_t, "u_chan0.nii.gz"))
    want, hdr_j = load(os.path.join(out_j, "u_chan0.nii.gz"))
    assert got.shape == want.shape and got.ndim == 3
    assert np.array_equal(hdr_t.affine, hdr_j.affine)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_cli_short_fit_writes_the_outputs(nifti_inputs, tmp_path):
    out = str(tmp_path / "out")
    tcli.run([*nifti_inputs, "--vx", "1.0", "--dir_out", out, "--print_info",
              "0", "--tolerance", "1e-2", "--sched", "0", "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["u_chan0.nii.gz", "u_chan1.nii.gz"]
    dats = [load(os.path.join(out, f)) for f in sorted(os.listdir(out))]
    assert dats[0][0].shape == dats[1][0].shape
    assert np.isfinite(dats[0][0]).all() and dats[0][0].max() > 0
    assert np.array_equal(dats[0][1].affine, dats[1][1].affine)
    np.testing.assert_allclose(np.abs(np.diag(dats[0][1].affine)[:3]), 1.0,
                               atol=1e-4)


@pytest.mark.parametrize("flag", ["--plot_conv", "--show_jtv", "--shard"])
def test_cli_unported_flags_parse_then_raise(nifti_inputs, tmp_path, flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcli.run([nifti_inputs[0], flag, "--dir_out", str(tmp_path),
                  "--print_info", "0", "--device", "cpu"])


def test_cli_cuda_without_a_card_raises(nifti_inputs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.run([nifti_inputs[0], "--linear", "--dir_out", str(tmp_path),
                  "--print_info", "0"])
