"""Linear-algebra ops.

Counterpart of ``mxnet_tpu/ops/la_op.py`` (MXNet 1.x
``src/operator/tensor/la_op.cc``): ``linalg_gemm``, ``potri``, ``trmm``,
``trsm``, ``gelqf``, ``syevd``, ``sumlogdiag``, ``extractdiag``,
``makediag``, ``extracttrian``, ``maketrian``, ``det``, ``slogdet`` and
``inverse``, and the ``_linalg_*`` alias of every ``linalg_*`` op
(``tensor.py``'s ``gemm2``, ``potrf`` and ``syrk`` too), as the JAX
module registers them. The JAX ops are plain XLA; these are
``torch.linalg`` (cuSOLVER and cuBLAS on a card), differentiated by
autograd.

Every op here captures into a CUDA graph, forward and backward, with no
host sync, but ``linalg_syevd``: ``torch.linalg.eigh`` reads cuSOLVER's
status back to the host to raise on a failed solve, and torch has no
``_ex`` form of it. It is registered as a host op (``registry.py``), so
the compile service runs a body holding it uncaptured.
``linalg_inverse`` is ``inv_ex`` and ``tensor.py``'s ``linalg_potrf``
``cholesky_ex``, which read no status back.

MXNet's conventions: batched over the leading axes; ``syevd`` returns
the eigenvectors as rows (A = U^T diag(L) U), eigenvalues ascending;
``gelqf`` factors A = L Q with Q's rows orthonormal and returns
``(Q, L)``, as MXNet 1.x does (the JAX op returns ``(L, Q)``); ``potri``
is the inverse of A A^T from the Cholesky factor A. The signs of
``gelqf``'s and ``syevd``'s factors are the solver's: cuSOLVER, LAPACK
and XLA may each flip a row.
"""
from __future__ import annotations

import math

import torch

from .registry import _NUM_OUTPUTS, _REGISTRY, differentiable, list_ops, \
    register

__all__ = []


def _t(x):
    return x.transpose(-1, -2)


def _tri(a, lower):
    return a.tril() if lower else a.triu()


@register("linalg_gemm")
def _linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                 beta=1.0, axis=-2):
    """``alpha * op(A) @ op(B) + beta * C``."""
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b) + beta * C


@register("linalg_potri")
def _linalg_potri(A, lower=True):
    """``inv(A A^T)`` from the lower Cholesky factor ``A`` (``inv(A^T A)``
    from an upper one)."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(
        A.shape)
    inv = torch.linalg.solve_triangular(A, eye, upper=not lower)
    return torch.matmul(_t(inv), inv) if lower else torch.matmul(inv, _t(inv))


@register("linalg_trmm")
def _linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                 alpha=1.0):
    """``alpha * op(tri(A)) @ B`` (``B @ op(tri(A))`` with
    ``rightside``)."""
    tri = _tri(A, lower)
    if transpose:
        tri = _t(tri)
    out = torch.matmul(B, tri) if rightside else torch.matmul(tri, B)
    return alpha * out


@register("linalg_trsm")
def _linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                 alpha=1.0):
    """``X`` with ``op(A) X = alpha B`` (``X op(A) = alpha B`` with
    ``rightside``), ``A`` triangular."""
    tri, upper = (_t(A), lower) if transpose else (A, not lower)
    return torch.linalg.solve_triangular(tri, alpha * B, upper=upper,
                                         left=not rightside)


@register("linalg_gelqf", num_outputs=2)
def _linalg_gelqf(A):
    """``(Q, L)`` with ``A = L Q``: Q's rows orthonormal, L lower."""
    q, r = torch.linalg.qr(_t(A))
    return _t(q), _t(r)


@register("linalg_syevd", num_outputs=2, host=True)
def _linalg_syevd(A):
    """``(U, L)`` with ``A = U^T diag(L) U``: eigenvectors as rows,
    eigenvalues ascending."""
    w, v = torch.linalg.eigh(A)
    return _t(v), w


@register("linalg_sumlogdiag")
def _linalg_sumlogdiag(A):
    """The sum of the logs of each matrix's diagonal."""
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)


@register("linalg_extractdiag")
def _linalg_extractdiag(A, offset=0):
    """The ``offset`` diagonal of each matrix."""
    return torch.diagonal(A, offset=offset, dim1=-2, dim2=-1)


@register("linalg_makediag")
def _linalg_makediag(A, offset=0):
    """Square matrices with the vectors of ``A`` on their ``offset``
    diagonal."""
    return torch.diag_embed(A, offset=offset)


def _tri_indices(n, k, lower, device):
    idx = torch.tril_indices(n, n, k, device=device) if lower else \
        torch.triu_indices(n, n, k, device=device)
    return idx[0], idx[1]


@register("linalg_extracttrian")
def _linalg_extracttrian(A, offset=0, lower=True):
    """The triangle of each matrix as a vector, row by row."""
    rows, cols = _tri_indices(A.shape[-1], offset, lower, A.device)
    return A[..., rows, cols]


@register("linalg_maketrian")
def _linalg_maketrian(A, offset=0, lower=True):
    """Matrices with the vectors of ``A`` as their triangle, row by row;
    ``offset > 0`` is an upper triangle, ``offset < 0`` a lower one."""
    k = abs(offset)
    t = (math.isqrt(8 * A.shape[-1] + 1) - 1) // 2
    n = t + k
    upper = offset > 0 or (offset == 0 and not lower)
    rows, cols = _tri_indices(n, k if upper else -k, not upper, A.device)
    flat = A.new_zeros(A.shape[:-1] + (n * n,))
    index = (rows * n + cols).expand(A.shape)
    return flat.scatter(-1, index, A).reshape(A.shape[:-1] + (n, n))


@register("linalg_det")
def _linalg_det(A):
    """The determinant of each matrix."""
    return torch.linalg.det(A)


@register("linalg_slogdet", num_outputs=2)
def _linalg_slogdet(A):
    """``(sign, log |det|)`` of each matrix."""
    sign, logabs = torch.linalg.slogdet(A)
    return sign, logabs


@register("linalg_inverse")
def _linalg_inverse(A):
    """The inverse of each matrix (``inv_ex``: no status read back to the
    host; a singular matrix gives what the solver leaves, as in JAX)."""
    return torch.linalg.inv_ex(A)[0]


def _register_linalg_aliases():
    """``_linalg_<name>`` for every ``linalg_<name>`` op registered by
    now (MXNet registers both names)."""
    for name in [n for n in list_ops() if n.startswith("linalg_")]:
        if "_" + name not in _REGISTRY:
            register("_" + name, num_outputs=_NUM_OUTPUTS[name],
                     differentiable=differentiable(name))(_REGISTRY[name])


_register_linalg_aliases()
