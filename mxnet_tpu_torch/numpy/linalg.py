"""mx.np.linalg (MXNet 1.x ``python/mxnet/numpy/linalg.py``).

Counterpart of ``mxnet_tpu/numpy/linalg.py``. That module defines
``pinv``, ``tensorinv`` and ``tensorsolve`` twice each (:24 and :123,
:88 and :105, :96 and :114); Python keeps the later definitions, over
``_npi_pinv_scalar_rcond``, ``_npi_tensorinv`` and ``_npi_tensorsolve``,
and those are the ones ported. Every function is a registry op
(``ops/numpy_ops.py``) on ``torch.linalg``; ``eigh`` and ``eigvalsh``
are host ops, as ``linalg_syevd``.
"""
from __future__ import annotations

from ..ndarray.ndarray import _invoke
from . import _as_np, ndarray

__all__ = ["norm", "inv", "pinv", "det", "slogdet", "matrix_rank", "svd",
           "qr", "cholesky", "eig", "eigh", "eigvals", "eigvalsh", "solve",
           "lstsq", "matrix_power", "multi_dot", "tensorinv", "tensorsolve"]


def _op(name, *arrays, **kwargs):
    return _invoke(name, [_as_np(a) for a in arrays], kwargs, wrap=ndarray)


def norm(x, ord=None, axis=None, keepdims=False):  # noqa: A002
    return _op("_npi_norm", x, ord=ord, axis=axis, keepdims=keepdims)


def inv(a):
    return _op("_npi_inv", a)


def pinv(a, rcond=1e-15, hermitian=False):
    return _op("_npi_pinv_scalar_rcond", a, rcond=float(rcond),
               hermitian=bool(hermitian))


def det(a):
    return _op("_npi_det", a)


def slogdet(a):
    return _op("_npi_slogdet", a)


def matrix_rank(M, tol=None):  # noqa: N803
    return _op("_npi_matrix_rank", M, tol=tol)


def svd(a):
    return _op("_npi_svd", a)


def qr(a):
    return _op("_npi_qr", a)


def cholesky(a):
    return _op("_npi_cholesky", a)


def eig(a):
    return _op("_npi_eig", a)


def eigh(a, UPLO="L"):  # noqa: N803
    return _op("_npi_eigh", a, UPLO=UPLO)


def eigvals(a):
    return _op("_npi_eigvals", a)


def eigvalsh(a, UPLO="L"):  # noqa: N803
    return _op("_npi_eigvalsh", a, UPLO=UPLO)


def solve(a, b):
    return _op("_npi_solve", a, b)


def lstsq(a, b, rcond=None):
    return _op("_npi_lstsq", a, b, rcond=rcond)


def matrix_power(a, n):
    return _op("_npi_matrix_power", a, n=n)


def multi_dot(arrays):
    return _op("_npi_multi_dot", *arrays)


def tensorinv(a, ind=2):
    return _op("_npi_tensorinv", a, ind=int(ind))


def tensorsolve(a, b, axes=None):
    return _op("_npi_tensorsolve", a, b,
               a_axes=tuple(axes) if axes else None)
