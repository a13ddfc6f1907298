"""Small-affine and Lie-group helpers: the host's in float64 numpy, the
device's in float64 torch.

The counterpart of ``unires_tpu.ops.lie``. The JAX package computes its
SE(3) exponential and maps in float32 on the device so that its fit loop can
update poses inside one jitted program. The port's fit chunk and its NMI
registration levels do the same on the card (``solvers.fitloop``,
``pipeline.registration``), in float64 torch ops that read nothing back:
:func:`se3_expm` (Rodrigues), :func:`se3_dexpm` (its derivative in each
parameter, the exact Frechet derivative of the exponential),
:func:`expm44` / :func:`group_expm` (Taylor with scaling and squaring, any
basis) and :func:`group_dexpm` (its derivative), :func:`inv44` and
:func:`compose_maps`, batched over leading dimensions. The host callers
(the init) keep :func:`unires_torch.geometry.expm` / ``dexpm`` (scipy) and
the numpy forms of :func:`inv44` and :func:`compose_maps`, which the same
names take for numpy input. The maps are composed and inverted in float64
and cast to float32 once; expect their last bits to differ from the JAX
package's, which rounds ``pre @ R @ post`` in float32.
"""
from __future__ import annotations

import numpy as np
import torch


def inv33(A: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 3, 3) matrices through the adjugate."""
    def a(i, j):
        return A[..., i, j]

    cof = [[a(1, 1) * a(2, 2) - a(1, 2) * a(2, 1),
            a(0, 2) * a(2, 1) - a(0, 1) * a(2, 2),
            a(0, 1) * a(1, 2) - a(0, 2) * a(1, 1)],
           [a(1, 2) * a(2, 0) - a(1, 0) * a(2, 2),
            a(0, 0) * a(2, 2) - a(0, 2) * a(2, 0),
            a(0, 2) * a(1, 0) - a(0, 0) * a(1, 2)],
           [a(1, 0) * a(2, 1) - a(1, 1) * a(2, 0),
            a(0, 1) * a(2, 0) - a(0, 0) * a(2, 1),
            a(0, 0) * a(1, 1) - a(0, 1) * a(1, 0)]]
    adj = torch.stack([torch.stack(r, dim=-1) for r in cof], dim=-2)
    det = a(0, 0) * cof[0][0] + a(0, 1) * cof[1][0] + a(0, 2) * cof[2][0]
    return adj / det[..., None, None]


def matvec3(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A (..., 3, 3) times v (..., 3), each row summed left to right."""
    return (A[..., 0] * v[..., 0:1] + A[..., 1] * v[..., 1:2]
            + A[..., 2] * v[..., 2:3])


def _affine(L: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[L t; 0 0 0 1] from (..., 3, 3) and (..., 3)."""
    top = torch.cat([L, t[..., None]], dim=-1)
    bottom = torch.eye(4, dtype=top.dtype, device=top.device)[3:]
    return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def inv44(M4):
    """Inverse of 4x4 affines [L t; 0 1]: numpy float64 for a host array,
    batched float64 torch (the 3x3 adjugate) for a tensor."""
    if isinstance(M4, torch.Tensor):
        Li = inv33(M4[..., :3, :3])
        return _affine(Li, -matvec3(Li, M4[..., :3, 3]))
    M4 = np.asarray(M4, np.float64)
    Li = np.linalg.inv(M4[:3, :3])
    out = np.eye(4)
    out[:3, :3] = Li
    out[:3, 3] = -(Li @ M4[:3, 3])
    return out


def compose_maps(pre, R, post):
    """(M, Minv): the (3, 4) float32 maps of M4 = pre @ R @ post, composed
    and inverted in float64. Host arrays give numpy maps; tensors give
    contiguous float32 tensors on their device (batched over leading
    dimensions of R)."""
    if isinstance(R, torch.Tensor):
        M4 = pre @ R @ post
        return (M4[..., :3, :4].to(torch.float32).contiguous(),
                inv44(M4)[..., :3, :4].to(torch.float32).contiguous())
    M4 = (np.asarray(pre, np.float64) @ np.asarray(R, np.float64)
          @ np.asarray(post, np.float64))
    return (np.ascontiguousarray(M4[:3, :4], dtype=np.float32),
            np.ascontiguousarray(inv44(M4)[:3, :4], dtype=np.float32))


def _algebra(q: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """X = sum_k q_k B_k, (..., 4, 4)."""
    return (q[..., :, None, None] * basis).sum(dim=-3)


def se3_expm(q: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """exp(sum_k q_k B_k) for a basis whose rotation generators are
    antisymmetric (the 'SE' basis of ``geometry.affine_basis``): Rodrigues
    for the rotation block and the V matrix for the translation, in the
    dtype of ``q`` (float64 in the fit), batched over q's leading
    dimensions. Below a rotation of 1e-4 rad the coefficients are their
    series."""
    X = _algebra(q, basis)
    O = X[..., :3, :3]
    w = torch.stack([O[..., 2, 1], O[..., 0, 2], O[..., 1, 0]], dim=-1)
    th2 = (w * w).sum(dim=-1)
    big = th2 > 1e-8
    th2s = torch.where(big, th2, torch.ones_like(th2))
    th = torch.sqrt(th2s)
    a = torch.where(big, torch.sin(th) / th, 1.0 - th2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(th)) / th2s, 0.5 - th2 / 24.0)
    c = torch.where(big, (th - torch.sin(th)) / (th2s * th),
                    1.0 / 6.0 - th2 / 120.0)
    O2 = O @ O
    eye = torch.eye(3, dtype=X.dtype, device=X.device)
    R3 = eye + a[..., None, None] * O + b[..., None, None] * O2
    V = eye + b[..., None, None] * O + c[..., None, None] * O2
    return _affine(R3, matvec3(V, X[..., :3, 3]))


def expm44(X: torch.Tensor, order: int = 16,
           squarings: int = 4) -> torch.Tensor:
    """exp(X) of (..., n, n) matrices: Taylor to ``order`` after dividing by
    2^squarings, then squared back. In float64 with the defaults it is
    accurate to ~1e-15 relative for ||X|| up to ~10 (the JAX package's
    float32 form keeps order 10)."""
    Xs = X / (2.0 ** squarings)
    term = torch.eye(X.shape[-1], dtype=X.dtype, device=X.device).expand(
        X.shape)
    out = term
    for k in range(1, order + 1):
        term = (term @ Xs) / k
        out = out + term
    for _ in range(squarings):
        out = out @ out
    return out


def group_expm(q: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """exp(sum_k q_k B_k) for any affine basis (e.g. 'CSO'), (..., 4, 4)."""
    return expm44(_algebra(q, basis))


def _frechet(q: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """dR[..., k, :, :] = d exp(sum_i q_i B_i) / d q_k: the Frechet
    derivative of the exponential at X in the direction B_k, the top-right
    block of exp([[X, B_k], [0, X]]) (as scipy's ``expm_frechet``)."""
    X = _algebra(q, basis)
    K = basis.shape[0]
    Xk = X[..., None, :, :].expand(X.shape[:-2] + (K, 4, 4))
    Z = torch.zeros(Xk.shape[:-2] + (8, 8), dtype=X.dtype, device=X.device)
    Z[..., :4, :4] = Xk
    Z[..., 4:, 4:] = Xk
    Z[..., :4, 4:] = basis
    return expm44(Z)[..., :4, 4:]


def se3_dexpm(q: torch.Tensor, basis: torch.Tensor):
    """(R, dR) with dR[..., k, :, :] = d exp(sum_i q_i B_i) / d q_k for the
    'SE' basis: R is :func:`se3_expm`'s, dR the exact Frechet derivative
    (the JAX package differentiates its float32 closed form)."""
    return se3_expm(q, basis), _frechet(q, basis)


def group_dexpm(q: torch.Tensor, basis: torch.Tensor):
    """(R, dR) as :func:`se3_dexpm` for any affine basis (e.g. 'CSO'): R is
    :func:`group_expm`'s, dR the same Frechet derivative (the JAX package
    takes ``jacfwd`` of its float32 Taylor exponential)."""
    return group_expm(q, basis), _frechet(q, basis)
