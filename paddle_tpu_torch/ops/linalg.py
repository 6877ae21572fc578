"""Linear algebra (counterpart of paddle_tpu/ops/linalg.py).

The reference computes these with XLA's linalg and no Pallas kernel, so
the port's are ``torch.linalg`` on the tensor's device (cuSOLVER and
cuBLAS on the card), with TF32 off (``paddle_tpu_torch/__init__.py``).
Decompositions agree with the reference up to the sign or phase of each
singular or eigen vector. ``lstsq`` solves through the SVD, as ``jnp``
does, so a rank-deficient system gets the minimum-norm solution on the
card too; its residuals are empty unless the system is full-rank and
overdetermined, as in ``jnp``.

``matrix_rank``'s ``hermitian`` is accepted by the reference and never
applied; the port raises for True ("Faults of the reference" 22).
"""
from __future__ import annotations

import torch

from ..core.dispatch import primitive
from .math import _ignored, _promoted, _tensor


def _tup(axis):
    if axis is None:
        return None
    return tuple(axis) if isinstance(axis, (list, tuple)) else int(axis)


@primitive
def norm(x, p="fro", axis=None, keepdim=False):
    x = _tensor(x)
    if p == "fro" or p is None:
        if axis is None:
            return torch.sqrt(torch.sum(torch.square(x)))
        ax = _tup(axis)
        if isinstance(ax, tuple) and len(ax) == 2:
            return torch.linalg.matrix_norm(x, "fro", dim=ax,
                                            keepdim=keepdim)
        return torch.linalg.vector_norm(x, 2, dim=ax, keepdim=keepdim)
    if p == "nuc":
        ax = (-2, -1) if axis is None else _tup(axis)
        return torch.linalg.matrix_norm(x, "nuc", dim=ax, keepdim=keepdim)
    if axis is None:
        x, axis = x.reshape(-1), 0
    p = float(p)
    ax = _tup(axis)
    if p == float("inf"):
        return torch.amax(torch.abs(x), dim=ax, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(torch.abs(x), dim=ax, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=ax, keepdim=keepdim)
    return torch.sum(torch.abs(x) ** p, dim=ax,
                     keepdim=keepdim) ** (1.0 / p)


@primitive
def cholesky(x, upper=False):
    return torch.linalg.cholesky(_tensor(x), upper=upper)


@primitive
def qr(x, mode="reduced"):
    q, r = torch.linalg.qr(_tensor(x), mode=mode)
    return q, r


@primitive
def svd(x, full_matrices=False):
    return tuple(torch.linalg.svd(_tensor(x), full_matrices=full_matrices))


@primitive
def inv(x):
    return torch.linalg.inv(_tensor(x))


@primitive
def pinv(x, rcond=1e-15, hermitian=False):
    return torch.linalg.pinv(_tensor(x), rtol=rcond, hermitian=hermitian)


@primitive
def det(x):
    return torch.linalg.det(_tensor(x))


@primitive
def slogdet(x):
    sign, logabsdet = torch.linalg.slogdet(_tensor(x))
    return sign, logabsdet


@primitive
def solve(x, y):
    return torch.linalg.solve(*_promoted(x, y))


@primitive
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    x, y = _promoted(x, y)
    if transpose:
        x = x.transpose(-1, -2)
        upper = not upper
    return torch.linalg.solve_triangular(x, y, upper=upper,
                                         unitriangular=unitriangular)


@primitive
def cholesky_solve(x, y, upper=False):
    b, factor = _promoted(x, y)
    return torch.cholesky_solve(b, factor, upper=upper)


@primitive
def matrix_power(x, n):
    return torch.linalg.matrix_power(_tensor(x), int(n))


@primitive(nondiff=True)
def matrix_rank(x, tol=None, hermitian=False):
    _ignored("matrix_rank", "hermitian", hermitian, False)
    return torch.linalg.matrix_rank(_tensor(x), rtol=tol).to(torch.int64)


@primitive
def eigh(x, UPLO="L"):
    w, v = torch.linalg.eigh(_tensor(x), UPLO=UPLO)
    return w, v


def eig(x):
    w, v = torch.linalg.eig(_tensor(x))
    return w, v


@primitive
def eigvalsh(x, UPLO="L"):
    return torch.linalg.eigvalsh(_tensor(x), UPLO=UPLO)


@primitive
def lstsq(x, y, rcond=None):
    """``(solution, residuals, rank, singular values)`` through the SVD:
    singular values at or below ``rcond`` times the largest count as 0
    (``rcond`` None: the dtype's eps times max(M, N))."""
    a, b = _promoted(x, y)
    m, n = a.shape[-2], a.shape[-1]
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    if rcond is None:
        rcond = torch.finfo(s.dtype).eps * max(m, n)
    keep = s > rcond * s.amax(-1, keepdim=True)
    inv_s = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    vec = b.dim() == a.dim() - 1
    bb = b.unsqueeze(-1) if vec else b
    sol = vh.transpose(-1, -2).conj() @ (
        inv_s[..., None] * (u.transpose(-1, -2).conj() @ bb))
    rank = keep.sum(-1).to(torch.int64)
    if m > n and bool((rank == n).all()):
        resid = torch.sum(torch.abs(a @ sol - bb) ** 2, dim=-2)
        if vec:
            resid = resid[..., 0]
    else:
        resid = torch.empty((0,), dtype=s.dtype, device=a.device)
    return (sol[..., 0] if vec else sol), resid, rank, s


@primitive
def multi_dot(xs):
    return torch.linalg.multi_dot([_tensor(x) for x in xs])


@primitive
def histogram(x, bins=100, min=0, max=0):
    """Counts (float32, as ``jnp.histogram`` gives them) over ``bins``
    equal bins of ``[min, max]``, or of the data's range when both are 0;
    the last bin holds its right edge."""
    x = _tensor(x).reshape(-1)
    xf = x if x.is_floating_point() else x.float()
    if min == 0 and max == 0:
        lo, hi = float(xf.min()), float(xf.max())
    else:
        lo, hi = float(min), float(max)
    return torch.histc(xf.float(), bins=int(bins), min=lo, max=hi)


@primitive(nondiff=True)
def bincount(x, weights=None, minlength=0):
    x = _tensor(x).long()
    return torch.bincount(x, weights=None if weights is None
                          else _tensor(weights, x), minlength=int(minlength))


@primitive
def corrcoef(x, rowvar=True):
    x = _tensor(x)
    return torch.corrcoef(x if rowvar else x.T)


@primitive
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    x = _tensor(x)
    return torch.cov(x if rowvar or x.dim() < 2 else x.T,
                     correction=1 if ddof else 0,
                     fweights=None if fweights is None
                     else _tensor(fweights, x),
                     aweights=None if aweights is None
                     else _tensor(aweights, x))


@primitive
def tensordot(x, y, axes=2):
    return torch.tensordot(*_promoted(x, y), dims=axes)


def einsum(equation, *operands):
    return _einsum(list(operands), equation=equation)


@primitive(name="einsum")
def _einsum(operands, equation):
    return torch.einsum(equation, *[_tensor(o) for o in operands])


@primitive(nondiff=True)
def eigvals(x):
    return torch.linalg.eigvals(_tensor(x))


@primitive(nondiff=True)
def lu(x, pivot=True, get_infos=False):
    """Packed L\\U and 1-based pivots (int32), and with ``get_infos`` the
    factorization's info (int32)."""
    lu_mat, piv, info = torch.linalg.lu_factor_ex(_tensor(x), pivot=pivot)
    if get_infos:
        return lu_mat, piv.to(torch.int32), info.to(torch.int32)
    return lu_mat, piv.to(torch.int32)


@primitive(nondiff=True)
def lu_unpack(lu_mat, pivots, unpack_ludata=True, unpack_pivots=True):
    p, lower, upper = torch.lu_unpack(_tensor(lu_mat),
                                      _tensor(pivots).to(torch.int32))
    return p, lower, upper
