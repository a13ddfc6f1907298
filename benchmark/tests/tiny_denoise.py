"""``denoise3.subjects`` (UniRes' denoising method) at a tiny grid, for the
CPU tests of the benchmark (``test_bench_denoise.py``) and of the port
(``tests/test_torch_denoise.py``).

The tiny cell is ``denoise3.subjects`` at 8 mm: the whole head in 23 x 28
x 23 voxels and observations at the same 8 mm (ratio 1, as the cell's 1 mm
inputs), coreg finishing at 8 mm, one lambda, a gain tolerance of 5e-2, at
most 60 iterations. Its limits, from its readings on the CPU (seeds 2**31 +
12345 and the two after it, on one and on two threads): sound runs read
recon_rel 0.1254 to 0.1307, data_rel 5.1e-7 to 1.5e-4 (at 8 mm the recon
nearly interpolates the data, so the program's float32 sample points move
the small data term by that much; the control reads the same), prior_rel
9.7e-9 to 3e-8, scale_err 0 exactly; the control (float32 with TF32
operands) prior_rel 2.6e-6 to 7.6e-6; a solve that returns its initial
guess recon_rel 0.165.
"""
import copy

from harness import spec

SEED_TINY = 2 ** 31 + 12345
TINY_LIMITS = dict(recon_rel=0.14, scale_err=0.0, data_rel=5e-4,
                   prior_rel=2e-7, unfinished=0)


def tiny_denoise3():
    """A copy of the ``denoise3.subjects`` cell at 8 mm, with the limits of
    ``TINY_LIMITS``."""
    cell = copy.deepcopy(spec.cell("denoise3.subjects"))
    cf = cell["config"]
    cf["phantom"].update(vx_mm=8.0, dim=[23, 28, 23])
    cf["acquisition"]["slice_mm"] = 8.0
    cf["settings"].update(sched_num=0, tolerance=5e-2, max_iter=60,
                          coreg_params=dict(cost_fun="nmi", group="SE",
                                            samp=8, fwhm=7.0,
                                            mean_space=False))
    cf["limits"] = dict(TINY_LIMITS)
    return cell
