"""Synthetic brain-like phantom (numpy only).

A copy of ``brain_phantom`` from the repository's test phantoms, so that the
port can build its workload without the JAX package: nested tissue shells
with plateau intensities, a folded GM/WM interface, ventricles and mild
texture, one geometry shared by the T1/T2/PD contrasts.
"""
import numpy as np


def _smooth_noise(dim, sigma_vox, seed):
    """Band-limited unit-std noise via FFT gaussian filtering (numpy only)."""
    rng = np.random.default_rng(seed)
    n = rng.standard_normal(dim).astype(np.float32)
    f = np.fft.rfftn(n)
    for d in range(3):
        k = np.fft.fftfreq(dim[d]) if d < 2 else np.fft.rfftfreq(dim[d])
        g = np.exp(-2.0 * (np.pi * k * sigma_vox) ** 2).astype(np.float32)
        shape = [1, 1, 1]
        shape[d] = k.size
        f *= g.reshape(shape)
    s = np.fft.irfftn(f, dim, axes=(0, 1, 2)).astype(np.float32)
    sd = float(s.std())
    return s / max(sd, 1e-12)


# Tissue intensity tables, BrainWeb-like ordering per contrast (fractions of
# the phantom amplitude). Classes: 0 bg, 1 CSF, 2 GM, 3 WM, 4 scalp, 5 skull.
_CLASS_INTENSITY = {
    "t1": (0.0, 0.18, 0.62, 1.00, 0.45, 0.08),
    "t2": (0.0, 1.00, 0.55, 0.36, 0.30, 0.05),
    "pd": (0.0, 1.00, 0.95, 0.80, 0.50, 0.05),
}


def brain_phantom(dim=(181, 217, 181), contrast="t1", amplitude=2000.0,
                  seed=0, texture=0.03, return_mat=False):
    """Structured brain-like phantom: nested tissue shells with PLATEAU
    intensities, SHARP interfaces (folded GM/WM boundary) and mild texture.

    Replaces the smooth Gaussian-blob phantom for quality anchoring (round-4
    VERDICT item 4): a TV prior trivially loves smooth blobs; this phantom has
    BrainWeb-like statistics — piecewise-constant tissue classes, a wiggly
    cortical ribbon, ventricles, skull/scalp shells — so PSNR / sr-vs-trilinear
    numbers anchor quality honestly (reference anchor: BrainWeb MSE 28,621.78
    vs trilinear 35,222.99, demos/demo_single_channel.ipynb:250,327).

    Geometry lives in an MNI-like RAS frame (AC near the volume centre,
    consistent with unires_tpu.data.default_atlas and geometry.bb_atlas), so
    the same phantom validates the atlas/crop path: ``return_mat=True`` also
    returns the 1 mm affine placing it at MNI coordinates.

    The three contrasts share one geometry (same seed -> same tissue classes)
    with per-contrast plateau intensities — a real multi-channel workload for
    the joint-TV prior.
    """
    dim = tuple(int(d) for d in dim)
    origin = np.array([-90.0, -126.0, -72.0])  # BrainWeb MNI placement, 1 mm
    ii, jj, kk = np.meshgrid(*[np.arange(n, dtype=np.float32) for n in dim],
                             indexing="ij")
    X = origin[0] + ii
    Y = origin[1] + jj
    Z = origin[2] + kk

    cb = (0.0, -18.0, 18.0)  # brain centre (matches data.atlas)

    def rho(centre, semi):
        return np.sqrt(((X - centre[0]) / semi[0]) ** 2
                       + ((Y - centre[1]) / semi[1]) ** 2
                       + ((Z - centre[2]) / semi[2]) ** 2)

    r_brain = rho(cb, (72.0, 90.0, 78.0))
    # cortical folding: band-limited perturbation of the normalised radius
    folds = _smooth_noise(dim, sigma_vox=4.0, seed=seed + 1)
    r_eff = r_brain + 0.045 * folds

    cls = np.zeros(dim, np.uint8)
    cls[rho((0.0, -14.0, 6.0), (82.0, 102.0, 92.0)) <= 1.0] = 4   # scalp
    cls[rho((0.0, -15.0, 8.0), (76.0, 96.0, 86.0)) <= 1.0] = 5    # skull
    cls[r_eff <= 1.00] = 1                                        # CSF rim
    cls[r_eff <= 0.92] = 2                                        # GM ribbon
    cls[r_eff <= 0.80] = 3                                        # WM core
    vent = np.minimum(rho((-14.0, -28.0, 20.0), (10.0, 34.0, 12.0)),
                      rho((14.0, -28.0, 20.0), (10.0, 34.0, 12.0)))
    cls[(vent <= 1.0) & (cls == 3)] = 1                           # ventricles

    table = np.asarray(_CLASS_INTENSITY[contrast], np.float32) * float(amplitude)
    vol = table[cls]
    if texture:
        tex = _smooth_noise(dim, sigma_vox=1.5, seed=seed + 2)
        vol = vol * (1.0 + float(texture) * tex)
    vol = np.clip(vol, 0.0, None).astype(np.float32)
    if return_mat:
        mat = np.eye(4)
        mat[:3, 3] = origin
        return vol, mat
    return vol
