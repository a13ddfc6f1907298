"""The port's init options against the JAX package: the bundled atlas,
``reset_origin`` / ``fix_affine`` (CT), ``resample_inplane``, labels,
atlas alignment (SE and CSO) and ``common_output``.

Inputs are made with numpy from a seed and go through both packages on the
CPU, where the port's pull / pull_grad are the plain PyTorch versions.
Tolerances: affines and dims exact (the same float64 host arithmetic);
resliced data rtol 1e-5 / atol 1e-5 * max|input| (float32, the same
operations up to fused multiply-adds); labels voxel for voxel; registration
as stated in each test.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unires_torch
import unires_tpu
from phantoms import blob_phantom
from unires_torch.data import default_atlas
from unires_torch.geometry import (affine_basis, affine_diag,
                                   affine_matrix_classic, expm)
from unires_torch.pipeline import format_y as tfmt
from unires_torch.pipeline import registration as treg
from unires_torch.pipeline import run as trun
from unires_torch.pipeline.convert import convert_state
from unires_torch.pipeline.nifti import load, save
from unires_tpu.data import default_atlas as default_atlas_jax
from unires_tpu.pipeline import format_y as jfmt
from unires_tpu.pipeline import registration as jreg
from unires_tpu.pipeline import run as jrun

torch.set_num_threads(2)

ROT = affine_matrix_classic([3.0, -2.0, 1.5, 0.3, -0.2, 0.25])


def _close(got, want, scale):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * scale)


def _labels(shape, seed, values=(0, 1, 2, 5)):
    """A blocky label volume: smooth noise cut into the given values."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, len(values), [(n + 3) // 4 for n in shape])
    lab = np.asarray(values, np.float32)[coarse]
    for ax in range(3):
        lab = np.repeat(lab, 4, axis=ax)
    return np.ascontiguousarray(lab[tuple(slice(0, n) for n in shape)])


def test_default_atlas_equals_jax_bitwise():
    dat, mat = default_atlas()
    dat_j, mat_j = default_atlas_jax()
    assert dat.dtype == np.float32 and dat.shape == (91, 109, 109)
    assert np.array_equal(dat, dat_j)
    assert np.array_equal(mat, mat_j)


@pytest.mark.parametrize("order", [0, 1])
def test_reset_origin_matches_jax(order):
    """Affine exact, data 1e-5 relative, on a rotated anisotropic grid."""
    rng = np.random.default_rng(4)
    dat = rng.random((10, 12, 14), dtype=np.float32)
    if order == 0:
        dat = np.round(4 * dat)
    mat = ROT @ affine_diag([1.0, 1.5, 2.5])
    mat[:3, 3] += [100.0, -50.0, 30.0]
    got, mat_t = treg.reset_origin(torch.from_numpy(dat), mat,
                                   interpolation=order)
    want, mat_j = jreg.reset_origin(jnp.asarray(dat), mat,
                                    interpolation=order)
    assert np.array_equal(mat_t, mat_j)
    assert tuple(got.shape) == tuple(want.shape)
    if order == 0:
        # nearest: a sample point within float32 rounding of a cell border
        # may pick the neighbour; none does on this grid
        assert np.array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got, want, np.abs(dat).max())
    centre = mat_t @ np.r_[(np.asarray(got.shape) - 1) / 2.0, 1.0]
    np.testing.assert_allclose(centre[:3], 0.0, atol=1e-9)


def test_warp_label_matches_jax_voxel_for_voxel():
    lab = _labels((14, 15, 17), 5)
    M = unires_torch.ops.resample.affine_to_M(affine_matrix_classic(
        [0.6, -0.4, 0.3, 0.05, -0.03, 0.04]) @ affine_diag([1.0, 1.0, 0.5]))
    dim_y = (13, 16, 30)
    got = tfmt.warp_label(torch.from_numpy(lab), M, dim_y)
    want = np.asarray(jfmt.warp_label(jnp.asarray(lab), jnp.asarray(M), dim_y))
    assert got.dtype == torch.float32 and tuple(got.shape) == dim_y
    assert set(np.unique(got.numpy())) <= set(np.unique(lab))
    assert len(np.unique(got.numpy())) > 2
    assert np.array_equal(got.numpy(), want)


def _read_both(chans, tmp_path, label=None, **kw):
    """x of both packages' read_data for the same arrays (and label file)."""
    if label is not None:
        pth = str(tmp_path / "label.nii.gz")
        save(label, pth, affine=chans[0][1])
        kw["label"] = (pth, (0, 0))
    st = unires_torch.Settings(device="cpu", do_print=0, **kw)
    sj = unires_tpu.Settings(do_print=0, **kw)
    xt = trun.read_data([[d, m] for d, m in chans], st)
    xj = jrun.read_data([[d, m] for d, m in chans], sj)
    return xt, st, xj, sj


def _same_obs(xt, xj, scale):
    for xct, xcj in zip(xt, xj):
        for ot, oj in zip(xct, xcj):
            assert tuple(ot.dim) == tuple(oj.dim) == tuple(ot.dat.shape)
            assert np.array_equal(ot.mat, oj.mat)
            _close(ot.dat, oj.dat, scale)
            assert (ot.label is None) == (oj.label is None)
            if ot.label is not None:
                assert np.array_equal(ot.label[0].numpy(),
                                      np.asarray(oj.label[0]))


def test_fix_affine_matches_jax(tmp_path):
    """CT observations and their labels get the origin reset; dims and
    affines exact, data 1e-5."""
    rng = np.random.default_rng(6)
    dat = 1000.0 * rng.random((12, 10, 9), dtype=np.float32) - 200.0
    mat = ROT @ affine_diag([1.0, 1.2, 3.0])
    mat[:3, 3] += [40.0, -20.0, 10.0]
    xt, st, xj, sj = _read_both([(dat, mat)], tmp_path, ct=True,
                                do_res_origin=True,
                                label=_labels(dat.shape, 7))
    xt, xj = trun.fix_affine(xt, st), jrun.fix_affine(xj, sj)
    assert tuple(xt[0][0].dim) != dat.shape
    _same_obs(xt, xj, np.abs(dat).max())
    # off: untouched
    st.do_res_origin = False
    before = xt[0][0].mat.copy()
    assert np.array_equal(trun.fix_affine(xt, st)[0][0].mat, before)


def test_resample_inplane_matches_jax(tmp_path):
    """In-plane axes finer than the recon voxel are downsampled (order 0),
    the label by majority vote; dims and affines exact, data 1e-5."""
    rng = np.random.default_rng(8)
    dat = rng.random((20, 22, 6), dtype=np.float32)
    mat = affine_diag([0.5, 0.4, 3.0])
    mat[:3, 3] = [-5.0, -4.0, -9.0]
    xt, st, xj, sj = _read_both([(dat, mat)], tmp_path, vx=1.0,
                                force_inplane_res=True,
                                label=_labels(dat.shape, 9))
    xt, xj = trun.resample_inplane(xt, st), jrun.resample_inplane(xj, sj)
    assert tuple(xt[0][0].dim) == (10, 8, 6)
    _same_obs(xt, xj, 1.0)


# --- atlas alignment --------------------------------------------------------

@pytest.fixture(scope="module")
def blob_pair():
    """A 2 mm blob "atlas" and a differently contrasted noisy copy."""
    gt = blob_phantom(dim=(48, 48, 48), amplitude=1000.0, seed=7)
    rng = np.random.default_rng(7)
    mov = (1500.0 * np.sqrt(gt / 1000.0)).astype(np.float32)
    mov = mov + 15.0 * rng.standard_normal(mov.shape).astype(np.float32)
    return gt.astype(np.float32), mov, affine_diag([2.0, 2.0, 2.0])


Q_TRUE = {"SE": np.array([4.0, -3.0, 2.0, 0.03, -0.02, 0.025]),
          "CSO": np.array([4.0, -3.0, 2.0, 0.03, -0.02, 0.025, 0.06])}


@pytest.mark.parametrize("group", ["SE", "CSO"])
def test_register_pair_matches_jax_at_coarse_levels(blob_pair, group):
    """Levels 8 and 4 mm only (the JAX package compiles one optimiser per
    level). Both recover the transform to the 4 mm level's accuracy (2 mm,
    0.03 in the linear block), and agree with each other to 0.5 mm and
    5e-3: the two descents take the same accept / reject decisions on
    float32 losses only up to near-ties."""
    gt, mov, mat = blob_pair
    C_true = expm(Q_TRUE[group], affine_basis(group))
    K = len(Q_TRUE[group])
    kw = dict(levels=(8.0, 4.0), fwhm=(7.0, 4.0), group=group)
    qt, wc_t = treg._register_pair(torch.from_numpy(gt), mat,
                                   torch.from_numpy(mov), C_true @ mat,
                                   np.zeros(K), **kw)
    qj, wc_j = jreg._register_pair(jnp.asarray(gt), mat, jnp.asarray(mov),
                                   C_true @ mat, np.zeros(K), **kw)
    np.testing.assert_allclose(wc_t, wc_j, atol=1e-12)
    At = treg.q_to_world(qt, group, wc_t)
    Aj = jreg.q_to_world(qj, group, wc_j)
    for A in (At, Aj):
        res = np.linalg.solve(A, C_true)
        assert np.abs(res[:3, 3]).max() < 2.0, res
        assert np.abs(res[:3, :3] - np.eye(3)).max() < 0.03, res
    np.testing.assert_allclose(At[:3, 3], Aj[:3, 3], atol=0.5)
    np.testing.assert_allclose(At[:3, :3], Aj[:3, :3], atol=5e-3)


def test_atlas_align_cso_recovers_rigid_and_scale(tmp_path, blob_pair):
    """rigid=False with an atlas file, down to its finest level: the JAX
    tests' tolerances (tests/test_registration.py: 1 mm, 0.025)."""
    gt, mov, _ = blob_pair
    atlas_path = str(tmp_path / "atlas.nii.gz")
    save(gt, atlas_path, affine=np.eye(4))
    q_true = np.array([2.0, -1.5, 1.0, 0.03, -0.02, 0.025, 0.08])
    C_true = expm(q_true, affine_basis("CSO"))
    n0 = unires_torch.ops.resample.pull_grad.launches
    mat_a = treg.atlas_align((torch.from_numpy(mov), C_true), rigid=False,
                             atlas_path=atlas_path)
    aligned = np.linalg.solve(mat_a, C_true)
    assert np.abs(aligned[:3, 3]).max() < 1.0, aligned
    assert np.abs(aligned[:3, :3] - np.eye(3)).max() < 0.025, aligned
    # a CPU tensor runs the plain versions: no kernel launch is counted
    assert unires_torch.ops.resample.pull_grad.launches == n0


def test_atlas_align_env_variable(tmp_path, blob_pair, monkeypatch):
    """UNIRES_ATLAS names the atlas when no path is given."""
    gt, _, _ = blob_pair
    atlas_path = str(tmp_path / "atlas_env.nii.gz")
    save(gt[::2, ::2, ::2], atlas_path, affine=affine_diag([2.0, 2.0, 2.0]))
    monkeypatch.setenv("UNIRES_ATLAS", atlas_path)
    T = affine_matrix_classic([3.0, 2.0, -2.0])
    mat_a = treg.atlas_align((torch.from_numpy(gt), T), rigid=True)
    aligned = np.linalg.solve(mat_a, T)
    assert np.abs(aligned[:3, 3]).max() < 1.0, aligned


def _template_4mm():
    """The bundled template at 4 mm (stride 2): atlas alignment then
    finishes at 4 mm, on small grids."""
    adat, amat = default_atlas()
    return (np.ascontiguousarray(adat[::2, ::2, ::2]),
            amat @ affine_diag([2.0, 2.0, 2.0]))


def test_atlas_align_bundled_recovers_offset():
    """A rigidly displaced copy of the bundled template is re-aligned, to
    the tolerances of the JAX test at 2 mm scaled to this 4 mm finish
    (3 mm, 0.03)."""
    dat, mat = _template_4mm()
    R_true = expm(np.array([6.0, -4.0, 3.0, 0.04, -0.03, 0.05]),
                  affine_basis("SE"))
    mat_a = treg.atlas_align((torch.from_numpy(dat), R_true @ mat),
                             rigid=True)
    aligned = np.linalg.solve(mat_a, R_true)
    assert np.abs(aligned[:3, 3]).max() < 3.0, aligned
    assert np.abs(aligned[:3, :3] - np.eye(3)).max() < 0.03, aligned


def test_init_common_output_matches_jax(tmp_path):
    """common_output: atlas alignment, crop to the atlas box, pow 256. The
    output grid equals the JAX package's (dim exactly; mat to 1e-6, as
    tests/test_atlas_geometry.py holds it: its voxel size is read back from
    the atlas-aligned mean space); the atlas transforms agree to 1 mm / 0.01;
    the label lands on the output grid with the input's values; a JAX init
    converts with its label and mat_atlas."""
    dat, mat = _template_4mm()
    T = affine_matrix_classic([5.0, -4.0, 3.0, 0.03, -0.02, 0.02])
    lab = _labels(dat.shape, 11)
    pth = str(tmp_path / "label.nii.gz")
    save(lab, pth, affine=T @ mat)
    kw = dict(vx=4.0, do_coreg=False, do_print=0, write_out=False,
              common_output=True, max_iter=0, label=(pth, (0, 0)))
    xt, yt, st = unires_torch.init([[dat, T @ mat]],
                                   unires_torch.Settings(device="cpu", **kw))
    xj, yj, sj = unires_tpu.init([[dat, T @ mat]],
                                 unires_tpu.Settings(**kw))
    assert st.do_atlas_align and st.crop and st.pow == 256
    assert tuple(yt[0].dim) == tuple(int(d) for d in yj[0].dim)
    np.testing.assert_allclose(yt[0].mat, np.asarray(yj[0].mat), rtol=0,
                               atol=1e-6)
    At, Aj = np.asarray(st.mat_atlas), np.asarray(sj.mat_atlas)
    np.testing.assert_allclose(At[:3, 3], Aj[:3, 3], atol=1.0)
    np.testing.assert_allclose(At[:3, :3], Aj[:3, :3], atol=0.01)
    res = np.linalg.solve(At, T)
    assert np.abs(res[:3, 3]).max() < 3.0, res
    assert tuple(yt[0].label.shape) == tuple(yt[0].dim)
    assert set(np.unique(yt[0].label.numpy())) <= set(np.unique(lab))
    # the JAX init through convert: label and atlas transform carried across
    xc, yc, sc = convert_state(xj, yj, sj, "cpu")
    assert np.array_equal(np.asarray(sc.mat_atlas), Aj)
    assert np.array_equal(xc[0][0].label[0].numpy(),
                          np.asarray(xj[0][0].label[0]))
    assert np.array_equal(yc[0].label.numpy(), np.asarray(yj[0].label))
    sc.write_out, sc.dir_out = True, str(tmp_path / "out")
    dat_y, mat_y, pth_y, _, label, pth_label = unires_torch.fit(xc, yc, sc)
    assert np.array_equal(label.numpy(), np.asarray(yj[0].label))
    assert dat_y.shape == tuple(yc[0].dim) + (1,)
    assert pth_label.endswith("u_label_0.nii.gz") and len(pth_y) == 1
    lab_w, hdr = load(pth_label)
    assert np.array_equal(lab_w, label.numpy())
    np.testing.assert_allclose(hdr.affine, mat_y, atol=1e-4)


def test_atlas_options_no_longer_raise_and_the_rest_still_do():
    """The name dates from when six settings raised in the port. None does
    any more: ``settings.check_supported`` is gone, and ``init`` takes every
    one of them on a small volume."""
    import unires_torch.settings as tsett

    assert not hasattr(tsett, "check_supported")
    assert not hasattr(tsett, "_UNPORTED")
    dat = blob_phantom(dim=(8, 8, 9), amplitude=1000.0, seed=1)
    for extra in (dict(checkpoint_every=5), dict(resume=True),
                  dict(shard="batch"), dict(profile_dir="p"),
                  dict(plot_conv=True), dict(show_jtv=True)):
        sett = unires_torch.Settings(device="cpu", do_print=0, max_iter=0,
                                     write_out=False, **extra)
        x, y, sett = unires_torch.init([[dat, np.eye(4)]], sett)
        (name, value), = extra.items()
        assert getattr(sett, name) == value
        assert tuple(y[0].dat.shape) == tuple(y[0].dim)
