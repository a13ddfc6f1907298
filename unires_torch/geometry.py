"""Host-side geometry core: affines, Lie algebra, mean space.

All geometry runs on host in float64 numpy: these are tiny 4x4 computations
done once per operator build, exactly as the reference computes them once in
``_proj_info`` (reference unires/_project.py:193-297 and
unires/_core.py:171-307). A numpy copy of ``unires_tpu.geometry``, which the
port cannot import (that package imports JAX at import time).

Re-implements (from behavior, not code) the nitorch helpers used by the
reference at:
  - voxel_size            (called at unires/_project.py:224 etc.)
  - affine_basis('SE')    (unires/_core.py:317)
  - _expm / dexpm         (unires/_core.py:448, unires/_update.py:618)
  - affine_matrix_classic (unires/_core.py:251)
  - _mean_space           (unires/_core.py:228)
  - ceil_pow              (unires/_core.py:244)
  - _bb_atlas             (unires/_core.py:233)
"""
from __future__ import annotations

import numpy as np
from scipy.linalg import expm as _scipy_expm, expm_frechet, logm


# ---------------------------------------------------------------------------
# Basic affine helpers
# ---------------------------------------------------------------------------

def voxel_size(mat: np.ndarray) -> np.ndarray:
    """Voxel size = column norms of the 3x3 block of a 4x4 affine."""
    mat = np.asarray(mat, dtype=np.float64)
    return np.sqrt((mat[:3, :3] ** 2).sum(axis=0))


def affine_translation(t) -> np.ndarray:
    mat = np.eye(4, dtype=np.float64)
    mat[:3, 3] = np.asarray(t, dtype=np.float64)
    return mat


def affine_diag(scale) -> np.ndarray:
    mat = np.eye(4, dtype=np.float64)
    mat[:3, :3] = np.diag(np.asarray(scale, dtype=np.float64))
    return mat


def affine_matrix_classic(p) -> np.ndarray:
    """SPM-style affine from parameters.

    ``p`` may hold up to 12 params: [tx ty tz, rx ry rz, zx zy zz, sx sy sz].
    The reference uses it with 3 params (translations) at unires/_core.py:251.
    Rotations are in radians, applied as Rx @ Ry @ Rz.
    """
    p = np.asarray(p, dtype=np.float64).ravel()
    q = np.zeros(12)
    q[6:9] = 1.0
    q[: p.size] = p
    T = affine_translation(q[:3])
    cx, sx = np.cos(q[3]), np.sin(q[3])
    cy, sy = np.cos(q[4]), np.sin(q[4])
    cz, sz = np.cos(q[5]), np.sin(q[5])
    Rx = np.array([[1, 0, 0, 0], [0, cx, sx, 0], [0, -sx, cx, 0], [0, 0, 0, 1]], dtype=np.float64)
    Ry = np.array([[cy, 0, sy, 0], [0, 1, 0, 0], [-sy, 0, cy, 0], [0, 0, 0, 1]], dtype=np.float64)
    Rz = np.array([[cz, sz, 0, 0], [-sz, cz, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], dtype=np.float64)
    Z = affine_diag(q[6:9])
    S = np.array([[1, q[9], q[10], 0], [0, 1, q[11], 0], [0, 0, 1, 0], [0, 0, 0, 1]], dtype=np.float64)
    return T @ Rx @ Ry @ Rz @ Z @ S


# ---------------------------------------------------------------------------
# Lie algebra: SE(3)
# ---------------------------------------------------------------------------

def affine_basis(group: str = "SE") -> np.ndarray:
    """Generator matrices of the requested affine Lie group, shape (K, 4, 4).

    Order for 'SE': 3 translations (x, y, z) then 3 rotations.
    Mirrors nitorch.spatial.affine_basis('SE') as used at unires/_core.py:317.
    """
    if group == "T":
        K = 3
    elif group == "SE":
        K = 6
    elif group == "CSO":  # SE + isotropic scaling
        K = 7
    else:
        raise ValueError(f"Unknown group {group!r}")
    B = np.zeros((K, 4, 4), dtype=np.float64)
    B[0, 0, 3] = 1.0
    B[1, 1, 3] = 1.0
    B[2, 2, 3] = 1.0
    if K >= 6:
        # rotations (antisymmetric generators)
        B[3, 0, 1], B[3, 1, 0] = 1.0, -1.0
        B[4, 0, 2], B[4, 2, 0] = 1.0, -1.0
        B[5, 1, 2], B[5, 2, 1] = 1.0, -1.0
        # normalise rotation generators like nitorch (1/sqrt(2) Frobenius norm 1)
        B[3:6] /= np.sqrt(2.0)
    if K >= 7:
        B[6, 0, 0] = B[6, 1, 1] = B[6, 2, 2] = 1.0
    return B


def expm(q, basis) -> np.ndarray:
    """Matrix exponential of sum_i q_i B_i (host, float64)."""
    q = np.asarray(q, dtype=np.float64).ravel()
    basis = np.asarray(basis, dtype=np.float64)
    X = np.einsum("k,kij->ij", q, basis)
    return _scipy_expm(X)


def dexpm(q, basis):
    """(expm(X), d expm(X) / d q_k) with X = sum q_k B_k.

    Returns (R, dR) with dR of shape (K, 4, 4). Exact Frechet derivatives
    (reference nitorch _expm(grad_X=True), unires/_update.py:618).
    """
    q = np.asarray(q, dtype=np.float64).ravel()
    basis = np.asarray(basis, dtype=np.float64)
    X = np.einsum("k,kij->ij", q, basis)
    K = basis.shape[0]
    dR = np.zeros((K, 4, 4), dtype=np.float64)
    R = _scipy_expm(X)
    for k in range(K):
        dR[k] = expm_frechet(X, basis[k], compute_expm=False)
    return R, dR


def rigid_log(mat, basis=None) -> np.ndarray:
    """Inverse of :func:`expm` for rigid transforms: q with
    expm(q, basis) == mat (host, float64).

    The matrix log of a rigid 4x4 lies exactly in span(basis) for 'SE', so
    the Frobenius projection onto the (orthogonal) generators is exact.
    """
    from scipy.linalg import logm

    if basis is None:
        basis = affine_basis("SE")
    X = np.real(logm(np.asarray(mat, np.float64)))
    B = np.asarray(basis, np.float64)
    num = np.einsum("ij,kij->k", X, B)
    den = np.einsum("kij,kij->k", B, B)
    return num / den


def fov_centre(mat, dim) -> np.ndarray:
    """World coordinates of the FOV centre voxel ((d-1)/2 per axis)."""
    mat = np.asarray(mat, np.float64)
    v = np.array([(float(d) - 1.0) / 2.0 for d in dim] + [1.0], np.float64)
    return (mat @ v)[:3]


def rigid_from_q(q, basis=None, centre=None) -> np.ndarray:
    """World rigid transform of pose parameters q.

    With ``centre`` (the recon-FOV world centre, :func:`fov_centre`) the
    exponential is CONJUGATED by the centre translation,
    ``T(c) @ expm(q) @ T(-c)``: rotations act about the volume centre
    instead of the world origin. On corner-origin affines (e.g. plain
    diagonal voxel-size mats) origin rotations couple to translations
    through a ~150 mm lever arm, producing near-flat screw directions in
    the GN Hessian along which the pose random-walks (round-4 bench:
    +-10 mm q swings at constant NLL). The reference never conjugates
    (nitorch _expm at unires/_update.py:618) but its demo data carry
    anatomically-centred affines, which hides the conditioning problem.
    """
    if basis is None:
        basis = affine_basis("SE")
    R = expm(q, basis)
    if centre is not None:
        R = (affine_translation(centre) @ R
             @ affine_translation(-np.asarray(centre)))
    return R


# ---------------------------------------------------------------------------
# Mean space (output grid over N input volumes)
# ---------------------------------------------------------------------------

def _rotation_part(mat: np.ndarray) -> np.ndarray:
    """Closest rotation (SVD polar) of the 3x3 block, sign-corrected."""
    A = np.asarray(mat, dtype=np.float64)[:3, :3]
    U, _, Vt = np.linalg.svd(A)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        # keep handedness of the input affine
        U[:, -1] *= -1
        R = U @ Vt
    return R


def mean_space(all_mat: np.ndarray, all_dim: np.ndarray, vx=None):
    """Barycentric "mean space" over N affines (orientation mean + union FOV).

    Re-derivation of nitorch.tools._preproc_utils._mean_space behavior as used
    at unires/_core.py:228: average the rotations (log-Euclidean on SO(3)),
    impose the target voxel size, and choose translation/dim so the grid
    covers the union of all input fields of view.

    Args:
        all_mat: (N, 4, 4) float64 affines.
        all_dim: (N, 3) dimensions.
        vx: target voxel size (3,) or None -> mean input voxel size.

    Returns:
        (mat, dim, vx): 4x4 affine, (3,) int dims, (3,) voxel size.
    """
    all_mat = np.asarray(all_mat, dtype=np.float64)
    all_dim = np.asarray(all_dim, dtype=np.float64)
    N = all_mat.shape[0]
    if vx is None:
        vx = np.stack([voxel_size(all_mat[n]) for n in range(N)]).mean(0)
    vx = np.asarray(vx, dtype=np.float64).ravel()
    if vx.size == 1:
        vx = np.full(3, float(vx))

    # Mean rotation: log-Euclidean mean of polar rotations.
    logs = []
    for n in range(N):
        R = _rotation_part(all_mat[n])
        L = logm(R)
        logs.append(np.real(L))
    Rm = _scipy_expm(np.mean(logs, axis=0))
    Rm = _rotation_part(np.block([[Rm, np.zeros((3, 1))], [np.zeros((1, 3)), np.ones((1, 1))]]))

    mat0 = np.eye(4, dtype=np.float64)
    mat0[:3, :3] = Rm @ np.diag(vx)

    # Union FOV: map all corners of all volumes into mat0 voxel space.
    mn = np.full(3, np.inf)
    mx = np.full(3, -np.inf)
    inv0 = np.linalg.inv(mat0)
    for n in range(N):
        d = all_dim[n]
        corners = np.array(
            [[i, j, k, 1.0] for i in (0, d[0] - 1) for j in (0, d[1] - 1) for k in (0, d[2] - 1)],
            dtype=np.float64,
        ).T
        vox = (inv0 @ all_mat[n] @ corners)[:3]
        mn = np.minimum(mn, vox.min(axis=1))
        mx = np.maximum(mx, vox.max(axis=1))

    mn = np.floor(mn)
    mx = np.ceil(mx)
    dim = (mx - mn + 1).astype(np.int64)
    mat = mat0 @ affine_translation(mn)
    return mat, dim, vx


# ---------------------------------------------------------------------------
# Misc host helpers
# ---------------------------------------------------------------------------

def ceil_pow(dim, p: float = 2.0, l: float = 2.0, mx: int = 0) -> np.ndarray:
    """Round dims up to l * p**k (capped at mx), per axis.

    Mirrors nitorch.core.utils.ceil_pow as used at unires/_core.py:244-245.
    """
    dim = np.asarray(dim, dtype=np.float64).copy()
    out = dim.copy()
    for i, d in enumerate(dim):
        k = 0.0
        val = l
        while val < d:
            k += 1
            val = l * p ** k
        out[i] = val
        if mx and out[i] > mx:
            out[i] = mx
    return out


# Atlas bounding boxes in approximate MNI millimetres, used when cropping the
# output FOV (reference: nitorch _bb_atlas('atlas_t1', fov=...), called at
# unires/_core.py:233-234 and :70-71). The nitorch boxes come from its bundled
# atlas; these are equivalent standard-space boxes (mm, RAS, origin at AC).
_BB_MM = {
    # fov: (min corner mm, max corner mm)
    "brain": (np.array([-90.0, -126.0, -72.0]), np.array([90.0, 90.0, 108.0])),
    "head": (np.array([-90.0, -126.0, -90.0]), np.array([90.0, 90.0, 126.0])),
}


def bb_atlas(fov: str = "brain"):
    """(mat, dim) of the atlas bounding box at 1mm isotropic."""
    if fov not in _BB_MM:
        raise ValueError(f"Unknown fov {fov!r} (use 'brain'|'head')")
    mn, mx = _BB_MM[fov]
    dim = (mx - mn + 1.0).astype(np.float64)
    mat = affine_translation(mn)
    # RAS with +1mm voxels, voxel (0,0,0) at mn
    return mat, dim
