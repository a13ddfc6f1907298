"""The rigid Gauss-Newton statistics' dispatch on the CPU
(``ops/gn_stats.py``).

A CPU tensor takes the plain chain (``gn_moments_plain``): the nine products
stacked into G and W and each subject's float64 moments taken alone by
``solvers.rigid._moments``. ``match_stats_device`` must give, bit for bit,
what it gave before the moments moved behind ``gn_moments``
(:func:`_match_stats_before` is that code, verbatim), for a
super-resolution observation (a C^T C volume) and a denoising one (ctc =
1.0), unbatched and as a batch of two subjects; a CPU call never loads the
kernels' library and counts no launch. The CUDA kernel itself is held to the
plain chain on the card (``tests/test_torch_gpu.py``).
"""
import numpy as np
import pytest
import torch

from unires_torch.geometry import affine_diag, affine_matrix_classic
from unires_torch.models.forward import make_obs_suite, obs_dyn_args
from unires_torch.models.proj_op import proj_info
from unires_torch.ops import cuda_build, gn_stats
from unires_torch.ops.conv import blur_down_sep, blur_up_sep
from unires_torch.ops.scaling import apply_scaling
from unires_torch.solvers import rigid
from unires_torch.utils.batch import each, sum_f64

torch.set_num_threads(2)

_PAIRS = [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)]
METHODS = {"sr": "super-resolution", "denoise": "denoising"}


def _match_stats_before(dat_x, dat_y, M, scl, tau, suite, po, sr, coords,
                        ctc):
    """``solvers.rigid.match_stats_device`` as it was before the kernel."""
    dat_yx = suite["pull"](dat_y, M)
    if sr:
        dat_yx = blur_down_sep(dat_yx, po.smo_ker_1d, po.ratio)
        dat_yx = apply_scaling(dat_yx, scl, po.dim_thick)
    gr = suite["pull_grad"](dat_y, M)
    msk = dat_x != 0
    res = torch.where(msk, dat_x - dat_yx, 0.0)
    ll = (0.5 * tau) * sum_f64(res.square())
    diff = torch.where(msk & (dat_yx != 0), dat_yx - dat_x, 0.0)
    if sr:
        diff = blur_up_sep(diff, po.smo_ker_1d, po.ratio)
    G = torch.stack([gr[..., d] * diff for d in range(3)], dim=-4)
    W = torch.stack([gr[..., d1] * gr[..., d2] * ctc for d1, d2 in _PAIRS],
                    dim=-4)
    moments = each(lambda g: rigid._moments(g, coords, 1).reshape(-1), G, 4)
    return torch.cat([ll[..., None], moments,
                      each(lambda w: rigid._moments(w, coords, 2).reshape(-1),
                           W, 4)], dim=-1)


def _observation(kind):
    """A small observation and its GN round's arguments: super-resolution
    (4 mm slices along z, the blur's C^T C volume) or denoising (the
    recon's voxel size, ctc = 1.0), at a pose off the identity."""
    method = METHODS[kind]
    dim_y, mat_y = (20, 18, 17), affine_diag([1.5, 1.5, 1.5])
    header = affine_matrix_classic([0.4, -0.7, 0.3, 0.02, -0.01, 0.03])
    if kind == "sr":
        dim_x, mat_x = (20, 18, 6), header @ affine_diag([1.5, 1.5, 4.5])
    else:
        dim_x, mat_x = (19, 18, 16), header @ affine_diag([1.5, 1.5, 1.5])
    po = proj_info(dim_y, mat_y, dim_x, mat_x, prof_ip=0, prof_tp=0)
    sr = kind == "sr"
    dim = po.dim_yx if sr else po.dim_x
    center = tuple((n - 1) / 2.0 for n in dim)
    coords = rigid._centred_coords(dim, center, "cpu")
    ctc = rigid.ctc_volume(po, dim, "cpu") if sr else 1.0
    return po, method, sr, coords, ctc


def _inputs(po, B, seed):
    """Volumes (B, ...) (unbatched for B = 0), maps, scales and taus."""
    rng = np.random.default_rng(seed)
    lead = (B,) if B else ()
    dat_y = torch.from_numpy(
        rng.random(lead + tuple(po.dim_y), dtype=np.float32) * 1000)
    x = rng.random(lead + tuple(po.dim_x), dtype=np.float32) * 1000
    x[x < 100] = 0.0  # a background, masked as the fit masks it
    M = torch.from_numpy(obs_dyn_args(po, "super-resolution")[0]).float()
    if not B:
        return torch.from_numpy(x), dat_y, M, 0.03, 2.5e-4
    return (torch.from_numpy(x), dat_y, M.expand(B, 3, 4).contiguous(),
            torch.tensor([0.03, -0.02][:B], dtype=torch.float32),
            torch.tensor([2.5e-4, 3.1e-4][:B], dtype=torch.float64))


def _bits(t):
    return t.contiguous().view(torch.int64)


@pytest.mark.parametrize("B", [0, 1, 2], ids=["one", "batch1", "batch2"])
@pytest.mark.parametrize("kind", list(METHODS))
def test_match_stats_is_the_chain_before_the_kernel(kind, B):
    """The GN round's statistics on the CPU, bit for bit what the stacked
    chain gave, with the plain chain run and no launch counted."""
    po, method, sr, coords, ctc = _observation(kind)
    dat_x, dat_y, M, scl, tau = _inputs(po, B, 1)
    if not sr:  # denoising pulls onto dim_x: the input's own grid
        M = torch.from_numpy(obs_dyn_args(po, method)[0]).float().expand(
            M.shape).contiguous()
    suite = make_obs_suite(po, method)
    n0 = gn_stats.gn_moments.launches
    got = rigid.match_stats_device(dat_x, dat_y, M, scl, tau, suite, po, sr,
                                   coords, ctc)
    want = _match_stats_before(dat_x, dat_y, M, scl, tau, suite, po, sr,
                               coords, ctc)
    assert got.dtype == torch.float64
    assert got.shape == ((B,) if B else ()) + (1 + gn_stats.N_MOMENTS,)
    assert float(want[..., 1:].abs().max()) > 0
    assert torch.equal(_bits(got), _bits(want))
    assert gn_stats.gn_moments.launches == n0


def _gn_inputs(dim, B, seed, with_ctc):
    rng = np.random.default_rng(seed)
    lead = (B,) if B else ()
    gr = torch.from_numpy(rng.standard_normal(lead + dim + (3,),
                                              dtype=np.float32))
    diff = torch.from_numpy(rng.standard_normal(lead + dim, dtype=np.float32))
    diff[diff.abs() < 0.3] = 0.0
    ctc = (torch.from_numpy(rng.random(dim, dtype=np.float32) + 0.5)
           if with_ctc else 1.0)
    coords = rigid._centred_coords(dim, tuple((n - 1) / 2 for n in dim),
                                   "cpu")
    return gr, diff, ctc, coords


@pytest.mark.parametrize("with_ctc", [True, False], ids=["ctc", "no_ctc"])
def test_a_cpu_call_takes_the_plain_chain_and_never_loads_the_library(
        with_ctc, monkeypatch):
    """``gn_moments`` of CPU tensors is ``gn_moments_plain`` to the bit,
    without building or loading the kernels' library."""
    def refuse():
        raise AssertionError("a CPU call loaded the kernels' library")

    monkeypatch.setattr(cuda_build.kernels, "get", refuse)
    args = _gn_inputs((9, 7, 11), 2, 3, with_ctc)
    got = gn_stats.gn_moments(*args)
    assert got.shape == (2, gn_stats.N_MOMENTS)
    assert torch.equal(_bits(got), _bits(gn_stats.gn_moments_plain(*args)))


def test_each_subject_of_a_batch_is_reduced_alone():
    """A subject's moments in a batch of two are its moments alone, to the
    bit (the batched fit's rule): the plain chain sums each subject apart."""
    gr, diff, ctc, coords = _gn_inputs((8, 10, 9), 2, 4, True)
    both = gn_stats.gn_moments(gr, diff, ctc, coords)
    for b in range(2):
        one = gn_stats.gn_moments(gr[b], diff[b], ctc, coords)
        assert one.shape == (gn_stats.N_MOMENTS,)
        assert torch.equal(_bits(both[b]), _bits(one))


def test_the_group_is_registered():
    """The kernel's launches reach the ``fit`` span as ``gn_stats``."""
    assert gn_stats.gn_moments in cuda_build.GROUPS["gn_stats"]
