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
def test_cli_unported_flags_parse_then_raise(nifti_inputs, tmp_path, flag,
                                             monkeypatch):
    """The name dates from when these flags raised in the port. Each now
    RUNS: a short fit of one image with the flag on writes its output
    (``--shard``: a batch of one subject)."""
    monkeypatch.delenv("DISPLAY", raising=False)
    out = str(tmp_path / "out")
    tcli.run([nifti_inputs[0], flag, "--vx", "2.0", "--dir_out", out,
              "--print_info", "0", "--tolerance", "1e-2", "--sched", "0",
              "--device", "cpu"])
    assert os.listdir(out) == ["u_chan0.nii.gz"]
    dat, _ = load(os.path.join(out, "u_chan0.nii.gz"))
    assert np.isfinite(dat).all() and dat.max() > 0


def _subject_files(d, n_subjects=2):
    """Comma groups of two-channel subjects (tests/test_fit_batch.py:112)."""
    groups = []
    for b in range(n_subjects):
        gt = blob_phantom(dim=(16, 16, 17), amplitude=1000.0, seed=b)
        grp = []
        for c, ax in enumerate((2, 1)):
            x_obs, mat_x, _ = degrade(gt, thick_axis=ax, thick=4.0,
                                      noise_sd=5.0, seed=b + 10 * c)
            grp.append(str(d / f"s{b}_c{c}.nii"))
            save(np.asarray(x_obs), grp[-1], affine=mat_x)
        groups.append(",".join(grp))
    return groups


def test_cli_shard_linear_writes_what_the_jax_cli_writes(tmp_path):
    """``--shard --linear`` with two comma groups: the file names of the JAX
    command line (tests/test_fit_batch.py:105-125), and within each package
    the four outputs on one grid. The volumes are not compared across the
    packages: every subject is co-registered first (the command line has no
    flag against it), which on volumes this small is ill-posed and ends in
    another optimum in each package; tests/test_torch_pipeline.py compares
    co-registration at a size where it is posed."""
    groups = _subject_files(tmp_path)
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    args = ["--shard", "--linear", "--no-unified_rigid", "--print_info", "0",
            "--device", "cpu"]
    tcli.run(groups + args + ["--dir_out", out_t])
    jcli.run(groups + args + ["--dir_out", out_j])
    names = sorted(os.listdir(out_t))
    assert names == sorted(os.listdir(out_j)) and len(names) == 4
    assert all(n.startswith("u_") for n in names)
    for out in (out_t, out_j):
        dats = [load(os.path.join(out, n)) for n in names]
        assert len({d.shape for d, _ in dats}) == 1
        for d, hdr in dats:
            assert d.ndim == 3 and np.isfinite(d).all() and d.max() > 0
            np.testing.assert_allclose(hdr.affine, dats[0][1].affine,
                                       atol=1e-5)


def test_cli_shard_short_fit_puts_both_subjects_on_one_grid(tmp_path):
    groups = _subject_files(tmp_path)
    out = str(tmp_path / "out")
    tcli.run(groups + ["--shard", "--dir_out", out, "--print_info", "0",
                       "--tolerance", "1e-2", "--sched", "0", "--device",
                       "cpu"])
    names = sorted(os.listdir(out))
    assert names == ["u_s0_c0.nii", "u_s0_c1.nii", "u_s1_c0.nii",
                     "u_s1_c1.nii"]
    dats = [load(os.path.join(out, n)) for n in names]
    assert len({d.shape for d, _ in dats}) == 1
    for d, hdr in dats:
        assert np.isfinite(d).all() and d.max() > 0
        np.testing.assert_array_equal(hdr.affine, dats[0][1].affine)
    assert not np.array_equal(dats[0][0], dats[2][0])


def test_cli_cuda_without_a_card_raises(nifti_inputs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.run([nifti_inputs[0], "--linear", "--dir_out", str(tmp_path),
                  "--print_info", "0"])
