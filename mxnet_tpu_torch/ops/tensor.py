"""Tensor structure ops: reductions, ordering, products, indexing, shape
manipulation, sequences and creation.

Counterpart of ``mxnet_tpu/ops/tensor.py``, op for op with the same
keyword arguments and defaults, following the JAX function bodies where
they differ from MXNet's documentation:

* ``argmax``/``argmin``/``argsort``/``argmax_channel`` and ``topk``'s
  indices are float32 (``topk``'s in its ``dtype``), and these ops, the
  creation ops, ``shape_array``/``size_array``, ``boolean_mask`` and
  ``_histogram`` are not differentiable (their outputs are detached);
* reductions take ``axis``, ``keepdims`` and ``exclude``; ``max``/``min``
  split the gradient evenly among ties, as JAX's do; ``sort`` and
  ``argsort`` are stable, and ``is_ascend=False`` flips the ascending
  order (ties in reverse), as the JAX bodies do; ``topk`` breaks ties by
  the lower index, as ``lax.top_k`` does, and its ``ret_typ`` is
  ``"indices"``, ``"value"``, ``"both"`` or ``"mask"`` (1/0 in the
  input's dtype at the top-k positions, as MXNet's; the JAX body returns
  the indices for ``"mask"``);
* ``take``'s ``mode`` is ``"clip"``, anything else wraps; float indices
  truncate toward zero; ``pad_width`` is MXNet's flat per-axis
  ``(before, after)`` list; ``_arange`` takes ``repeat``; ``unravel_index``
  clips out-of-range indices and ``ravel_multi_index`` clips coordinates,
  as ``jnp``'s do.

Creation ops take ``ctx`` (a Context, a torch device or a string such as
``"cpu(0)"`` from symbol JSON); None is the current context.

``linalg_gemm2``, ``linalg_potrf`` and ``linalg_syrk`` (JAX
``tensor.py:126-151``) get their ``_linalg_*`` aliases with the ops of
``la_op.py``. ``linalg_potrf`` factors through ``cholesky_ex``, which
does not read its status back to the host, so it runs inside a CUDA
graph: a matrix that is not positive definite gives NaN in its lower
triangle, as the JAX op does, and raises nothing.

``cast_storage`` is the dense identity at the op layer, as the JAX op
(``tensor.py:600-606``): the storage types are the NDArray layer's
(``ndarray/sparse.py``), and an op reads a sparse input's dense view.
``_sparse_retain`` zeroes every row that ``indices`` does not list.
"""
from __future__ import annotations

import math

import torch

from ..base import canonical_dtype
from .registry import register


def _norm_axis(axis):
    if axis is None or axis == ():
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(x, ax):
    """``ax`` (None: every axis) as a sorted tuple of non-negative
    axes."""
    if ax is None:
        return tuple(range(x.ndim))
    ax = ax if isinstance(ax, tuple) else (ax,)
    return tuple(sorted(a % x.ndim for a in ax))


def _device(ctx):
    from ..context import Context, current_context

    if ctx is None or ctx == "":
        return current_context().torch_device()
    if isinstance(ctx, Context):
        return ctx.torch_device()
    if isinstance(ctx, torch.device):
        return ctx
    text = str(ctx)
    if "(" in text:  # MXNet's "cpu(0)" / "gpu(1)"
        kind, idx = text.rstrip(")").split("(")
        return Context(kind, int(idx or 0)).torch_device()
    return torch.device(text)


# ----------------------------------------------------------- reductions ----

def _over_merged(x, dims, keepdims, fn):
    """``fn(t)`` over the trailing axis of ``x`` with ``dims`` moved to
    the end and merged (for reductions torch takes over one axis)."""
    if not dims:
        return x.clone()
    rest = [d for d in range(x.ndim) if d not in dims]
    moved = x.permute(rest + list(dims))
    out = fn(moved.reshape(moved.shape[:len(rest)] + (-1,)))
    if keepdims:
        out = out.reshape([1 if d in dims else s
                           for d, s in enumerate(x.shape)])
    return out


def _sum(x, dims, keepdims):
    dtype = x.dtype if not x.is_floating_point() and x.dtype != torch.bool \
        else None
    if not dims:
        return x.clone()
    return torch.sum(x, dim=dims, keepdim=keepdims, dtype=dtype)


def _mean(x, dims, keepdims):
    if not x.is_floating_point():
        x = x.to(torch.get_default_dtype())
    if not dims:
        return x.clone()
    return torch.mean(x, dim=dims, keepdim=keepdims)


def _prod(x, dims, keepdims):
    dtype = x.dtype if not x.is_floating_point() else None
    return _over_merged(x, dims, keepdims,
                        lambda t: torch.prod(t, dim=-1, dtype=dtype))


def _nansum(x, dims, keepdims):
    if not dims:
        return x.clone()
    return torch.nansum(x, dim=dims, keepdim=keepdims)


def _nanprod(x, dims, keepdims):
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.ones_like(x), x)
    return _prod(x, dims, keepdims)


def _max(x, dims, keepdims):
    if not dims:
        return x.clone()
    return torch.amax(x, dim=dims, keepdim=keepdims)


def _min(x, dims, keepdims):
    if not dims:
        return x.clone()
    return torch.amin(x, dim=dims, keepdim=keepdims)


def _make_reduce(name, fn):
    def red(x, axis=None, keepdims=False, exclude=False):
        ax = _norm_axis(axis)
        dims = _dims(x, ax)
        if exclude and ax is not None:
            dims = tuple(d for d in range(x.ndim) if d not in dims)
        return fn(x, dims, keepdims)

    red.__name__ = red.__qualname__ = name
    red.__doc__ = (f"``{name}`` over ``axis`` (None: all; ``exclude``: "
                   "all but ``axis``).")
    return red


for _name, _fn in [("sum", _sum), ("mean", _mean), ("prod", _prod),
                   ("nansum", _nansum), ("nanprod", _nanprod),
                   ("max", _max), ("min", _min)]:
    register(_name, aliases=(f"_np_{_name}",))(_make_reduce(_name, _fn))


@register("norm")
def _norm(x, ord=2, axis=None, keepdims=False):
    """L1 (``ord=1``) or L2 norm over ``axis`` (None: all)."""
    dims = _dims(x, _norm_axis(axis))
    if ord == 1:
        return _sum(torch.abs(x), dims, keepdims)
    return torch.sqrt(_sum(torch.square(x), dims, keepdims))


def _arg(fn, x, axis, keepdims):
    ax = _norm_axis(axis)
    if ax is None:
        out = fn(x.reshape(-1))
        if keepdims:
            out = out.reshape((1,) * x.ndim)
    else:
        out = fn(x, dim=ax, keepdim=keepdims)
    return out.to(torch.float32)


@register("argmax", differentiable=False)
def _argmax(x, axis=None, keepdims=False):
    return _arg(torch.argmax, x, axis, keepdims)


@register("argmin", differentiable=False)
def _argmin(x, axis=None, keepdims=False):
    return _arg(torch.argmin, x, axis, keepdims)


@register("argsort", differentiable=False)
def _argsort(x, axis=-1, is_ascend=True):
    idx = torch.argsort(x, dim=axis, stable=True)
    if not is_ascend:
        idx = torch.flip(idx, dims=(axis,))
    return idx.to(torch.float32)


@register("sort")
def _sort(x, axis=-1, is_ascend=True):
    out = torch.sort(x, dim=axis, stable=True).values
    if not is_ascend:
        out = torch.flip(out, dims=(axis,))
    return out


@register("topk", differentiable=False)
def _topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False,
          dtype="float32"):
    axis = axis % x.ndim
    xm = torch.movedim(x, axis, -1)
    # a stable sort puts the lower index first among ties, as lax.top_k
    idx = torch.argsort(xm, dim=-1, descending=not is_ascend,
                        stable=True)[..., :k]
    if ret_typ == "mask":
        mask = torch.zeros_like(xm).scatter_(-1, idx, 1)
        return torch.movedim(mask, -1, axis)
    vals = torch.movedim(torch.gather(xm, -1, idx), -1, axis)
    idx = torch.movedim(idx, -1, axis).to(canonical_dtype(dtype))
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx
    return idx


# -------------------------------------------------------------- products ---

@register("dot")
def _dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """MXNet's dot: the last axis of ``lhs`` against the first of
    ``rhs``."""
    if transpose_a and lhs.ndim > 1:
        lhs = lhs.transpose(-1, -2)
    if transpose_b and rhs.ndim > 1:
        rhs = rhs.transpose(-1, -2)
    if lhs.ndim == 1 and rhs.ndim == 1:
        return torch.dot(lhs, rhs)
    return torch.tensordot(lhs, rhs, dims=([lhs.ndim - 1], [0]))


@register("batch_dot")
def _batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    if transpose_a:
        lhs = lhs.transpose(-1, -2)
    if transpose_b:
        rhs = rhs.transpose(-1, -2)
    return torch.matmul(lhs, rhs)


@register("linalg_gemm2")
def _linalg_gemm2(a, b, transpose_a=False, transpose_b=False, alpha=1.0):
    """``alpha * op(a) @ op(b)`` over the leading (batch) axes."""
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    return alpha * torch.matmul(a, b)


@register("linalg_potrf")
def _potrf(a):
    """The lower Cholesky factor of each matrix; NaN in the lower
    triangle of one that is not positive definite (no host sync)."""
    low, info = torch.linalg.cholesky_ex(a)
    ok = (info == 0).unsqueeze(-1).unsqueeze(-1)
    return torch.where(ok, low, torch.full_like(low, float("nan"))).tril()


@register("linalg_syrk")
def _syrk(a, transpose=False, alpha=1.0):
    """``alpha * a @ a^T`` (``a^T @ a`` with ``transpose``)."""
    at = a.transpose(-1, -2)
    return alpha * (torch.matmul(at, a) if transpose else torch.matmul(a, at))


@register("khatri_rao")
def _khatri_rao(*mats):
    """The column-wise Kronecker product of matrices with one number of
    columns."""
    out = mats[0]
    for m in mats[1:]:
        out = torch.einsum("i...,j...->ij...", out, m).reshape(
            -1, out.shape[-1])
    return out


# ------------------------------------------------------------- indexing ----

def _index(t):
    """Indices (floats allowed) truncated toward zero, as int64."""
    return t.to(torch.int64)


@register("take")
def _take(a, indices, axis=0, mode="clip"):
    n = a.shape[axis]
    idx = _index(indices)
    idx = idx.clamp(0, n - 1) if mode == "clip" else torch.remainder(idx, n)
    axis = axis % a.ndim
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register("pick")
def _pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data`` at ``index`` along ``axis``; indices (floats allowed) are
    truncated to integers and clipped into range."""
    idx = _index(index).clamp(0, data.shape[axis] - 1)
    out = torch.take_along_dim(data, idx.unsqueeze(axis), dim=axis)
    return out if keepdims else out.squeeze(axis)


@register("gather_nd")
def _gather_nd(data, indices):
    return data[tuple(_index(indices))]


@register("scatter_nd")
def _scatter_nd(data, indices, shape=()):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(_index(indices)), data, accumulate=True)


@register("_scatter_set_nd")
def _scatter_set_nd(lhs, rhs, indices):
    """The advanced-index write ``lhs[indices] = rhs``, out of place."""
    return lhs.index_put(tuple(_index(indices)), rhs.to(lhs.dtype))


@register("Embedding")
def _embedding(data, weight, input_dim=None, output_dim=None,
               dtype="float32", sparse_grad=False):
    """Row gather. Ids may arrive as floats (MXNet's default array type):
    they are cast to integers first, truncating as the JAX op does
    (exact for ids below 2**24)."""
    return torch.nn.functional.embedding(_index(data), weight)


@register("one_hot")
def _one_hot(indices, depth=1, on_value=1.0, off_value=0.0,
             dtype="float32"):
    """Out-of-range indices give a row of ``off_value``, as
    ``jax.nn.one_hot``."""
    hot = (_index(indices).unsqueeze(-1) == torch.arange(
        depth, device=indices.device)).to(torch.float32)
    return (hot * (on_value - off_value) + off_value).to(
        canonical_dtype(dtype))


@register("where")
def _where(condition, x, y):
    return torch.where(condition != 0, x, y)


@register("boolean_mask", differentiable=False)
def _boolean_mask(data, index, axis=0):
    """The slices of ``data`` along ``axis`` where ``index`` is non-zero
    (a data-dependent shape: the host reads the mask)."""
    keep = torch.nonzero(index.reshape(-1) != 0).reshape(-1)
    return torch.index_select(data, axis, keep.to(data.device))


@register("batch_take")
def _batch_take(a, indices):
    """One element per row: ``a[i, indices[i]]``."""
    return a[torch.arange(a.shape[0], device=a.device), _index(indices)]


@register("choose_element_0index")
def _choose_element_0index(lhs, rhs):
    return lhs[torch.arange(lhs.shape[0], device=lhs.device), _index(rhs)]


@register("fill_element_0index")
def _fill_element_0index(lhs, mhs, rhs):
    """``lhs`` with ``lhs[i, rhs[i]] = mhs[i]``, out of place."""
    rows = torch.arange(lhs.shape[0], device=lhs.device)
    return lhs.index_put((rows, _index(rhs)), mhs.to(lhs.dtype))


@register("argmax_channel", differentiable=False)
def _argmax_channel(data):
    return torch.argmax(data, dim=1).to(torch.float32)


# -------------------------------------------------------- shape manip ------

@register("reshape", aliases=("Reshape",))
def _reshape(x, shape=()):
    """MXNet special codes: 0 copies the input dim at that position, -1
    is inferred, -2 copies all remaining dims."""
    tgt = []
    for i, s in enumerate(shape):
        if s == 0:
            tgt.append(x.shape[i])
        elif s == -2:
            tgt.extend(x.shape[i:])
        else:
            tgt.append(int(s))
    return x.reshape(tuple(tgt))


@register("reshape_like")
def _reshape_like(x, like):
    return x.reshape(like.shape)


@register("shape_array", differentiable=False)
def _shape_array(x):
    return torch.tensor(tuple(x.shape), dtype=torch.int64, device=x.device)


@register("size_array", differentiable=False)
def _size_array(x):
    return torch.tensor([x.numel()], dtype=torch.int64, device=x.device)


@register("transpose")
def _transpose(x, axes=()):
    """A view with permuted strides (it is not made contiguous here)."""
    axes = tuple(axes) if axes else tuple(reversed(range(x.ndim)))
    return x.permute(axes)


@register("expand_dims")
def _expand_dims(x, axis=0):
    return torch.unsqueeze(x, axis)


@register("squeeze")
def _squeeze(x, axis=None):
    ax = _norm_axis(axis)
    if ax is None:
        return torch.squeeze(x)
    return torch.squeeze(x, dim=ax)


@register("Flatten", aliases=("flatten",))
def _flatten(x):
    return x.reshape(x.shape[0], -1)


@register("Concat", aliases=("concat",))
def _concat(*args, dim=1, num_args=None):
    return torch.cat(args, dim=dim)


@register("stack")
def _stack(*args, axis=0, num_args=None):
    return torch.stack(args, dim=axis)


def _equal_parts(x, n, axis):
    if x.shape[axis] % n:
        raise ValueError(f"array split does not result in an equal "
                         f"division: {x.shape[axis]} into {n}")
    return torch.split(x, x.shape[axis] // n, dim=axis)


@register("SliceChannel", aliases=("split", "slice_channel"),
          num_outputs=lambda n_in, kw: int(kw.get("num_outputs", 1)))
def _split(x, num_outputs=1, axis=1, squeeze_axis=False):
    parts = _equal_parts(x, int(num_outputs), axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts) if num_outputs > 1 else parts[0]


def _split_v2_indices(indices):
    """MXNet's Python wrapper stores ``[0] + indices`` in the op
    attribute; bare user indices are taken too (JAX :421-428)."""
    idx = list(indices)
    if idx and idx[0] == 0:
        idx = idx[1:]
    return idx


@register("split_v2", aliases=("_split_v2",), num_outputs=lambda n_in, kw:
          int(kw["sections"]) if kw.get("sections")
          else len(_split_v2_indices(kw.get("indices", ()))) + 1)
def _split_v2(data, indices=(), axis=0, squeeze_axis=False, sections=0):
    """Split at explicit indices, or into ``sections`` equal parts;
    always a tuple."""
    if sections:
        parts = _equal_parts(data, int(sections), axis)
    else:
        parts = torch.tensor_split(data, _split_v2_indices(indices),
                                   dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


def _positive(n, b, e, s):
    """``slice(b, e, s)`` over ``n`` elements as a slice with a positive
    step and whether to flip its result (torch slices step forward
    only)."""
    start, stop, step = slice(b, e, s).indices(n)
    if step > 0:
        return slice(start, stop, step), False
    picked = range(start, stop, step)
    if not picked:
        return slice(0, 0), False
    return slice(picked[-1], start + 1, -step), True


def _slices(shape, begin, end, step):
    sl, flips = [], []
    for i, n in enumerate(shape):
        b = begin[i] if i < len(begin) else None
        e = end[i] if i < len(end) else None
        s = step[i] if step and i < len(step) and step[i] else None
        pos, flip = _positive(n, b, e, s)
        sl.append(pos)
        if flip:
            flips.append(i)
    return tuple(sl), tuple(flips)


@register("slice")
def _slice(x, begin=(), end=(), step=()):
    sl, flips = _slices(x.shape, begin, end, step)
    out = x[sl]
    return torch.flip(out, dims=flips) if flips else out


@register("slice_axis")
def _slice_axis(x, axis=0, begin=0, end=None):
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(begin, end)
    return x[tuple(sl)]


@register("slice_like")
def _slice_like(x, like, axes=()):
    axes = tuple(axes) if axes else tuple(range(x.ndim))
    sl = [slice(None)] * x.ndim
    for a in axes:
        sl[a] = slice(0, like.shape[a])
    return x[tuple(sl)]


@register("flip", aliases=("reverse",))
def _flip(x, axis=0):
    return torch.flip(x, dims=_dims(x, _norm_axis(axis)))


@register("tile")
def _tile(x, reps=()):
    return torch.tile(x, tuple(reps))


@register("repeat")
def _repeat(x, repeats=1, axis=None):
    return torch.repeat_interleave(x, int(repeats), dim=axis)


@register("pad", aliases=("Pad",))
def _pad(x, mode="constant", pad_width=(), constant_value=0.0):
    """``pad_width`` is MXNet's flat ``(before, after)`` per axis from
    axis 0; ``mode`` is ``constant``, ``edge`` or ``reflect``."""
    pairs = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
             for i in range(len(pad_width) // 2)]
    pairs += [(0, 0)] * (x.ndim - len(pairs))
    tmode = {"constant": "constant", "edge": "replicate",
             "reflect": "reflect"}[mode]
    first = next((i for i, p in enumerate(pairs) if p != (0, 0)), x.ndim)
    flat = [v for p in reversed(pairs[first:]) for v in p]
    if not flat:
        return x.clone()
    if tmode == "constant":
        return torch.nn.functional.pad(x, flat, value=constant_value)
    # torch pads the last 1-3 axes of a batch of channels
    k = x.ndim - first
    lead = x.shape[:first]
    out = torch.nn.functional.pad(
        x.reshape((1, -1) + x.shape[first:]), flat, mode=tmode)
    return out.reshape(lead + out.shape[2:]) if lead else \
        out.reshape(out.shape[-k:])


@register("swapaxes", aliases=("SwapAxis",))
def _swapaxes(x, dim1=0, dim2=0):
    return torch.swapaxes(x, dim1, dim2)


@register("depth_to_space")
def _depth_to_space(x, block_size=1):
    b, c, h, w = x.shape
    bs = block_size
    x = x.reshape(b, bs, bs, c // (bs * bs), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, c // (bs * bs), h * bs, w * bs)


@register("space_to_depth")
def _space_to_depth(x, block_size=1):
    b, c, h, w = x.shape
    bs = block_size
    x = x.reshape(b, c, h // bs, bs, w // bs, bs)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, c * bs * bs, h // bs, w // bs)


@register("diag")
def _diag(data, k=0, axis1=0, axis2=1):
    if data.ndim == 1:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=axis1, dim2=axis2)


# -------------------------------------------------------------- sequence ---

@register("SequenceMask", aliases=("sequence_mask",))
def _sequence_mask(data, sequence_length=None, use_sequence_length=False,
                   value=0.0, axis=0):
    if not use_sequence_length or sequence_length is None:
        return data
    steps = torch.arange(data.shape[axis], device=data.device)
    mask = steps[:, None] < _index(sequence_length)[None, :]  # (T, B)
    if axis == 1:
        mask = mask.T
    mask = mask.reshape(mask.shape + (1,) * (data.ndim - 2))
    return torch.where(mask, data, torch.full((), value, dtype=data.dtype,
                                              device=data.device))


@register("SequenceLast", aliases=("sequence_last",))
def _sequence_last(data, sequence_length=None, use_sequence_length=False,
                   axis=0):
    if not use_sequence_length or sequence_length is None:
        return torch.select(data, axis, data.shape[axis] - 1)
    last = _index(sequence_length) - 1                     # (B,)
    moved = torch.movedim(data, axis, 0)                   # (T, B, ...)
    idx = last.reshape((1, -1) + (1,) * (moved.ndim - 2)).expand(
        (1,) + moved.shape[1:])
    return torch.gather(moved, 0, idx.clamp(0, moved.shape[0] - 1))[0]


@register("SequenceReverse", aliases=("sequence_reverse",))
def _sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                      axis=0):
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(axis,))
    moved = torch.movedim(data, axis, 0)
    steps = torch.arange(moved.shape[0], device=data.device)[:, None]
    slen = _index(sequence_length)[None, :]
    idx = torch.where(steps < slen, slen - 1 - steps, steps)
    idx = idx.reshape(idx.shape + (1,) * (moved.ndim - 2)).expand(
        moved.shape)
    return torch.movedim(torch.gather(moved, 0, idx), 0, axis)


# ------------------------------------------------------------ the rest -----

@register("digamma")
def _digamma(data):
    return torch.digamma(data)


@register("multi_sum_sq")
def _multi_sum_sq(*arrays, num_arrays=1):
    """One vector holding each array's sum of squares."""
    return torch.stack([torch.sum(torch.square(a)) for a in arrays])


@register("unravel_index", aliases=("_unravel_index",))
def _unravel_index(data, shape=()):
    """Flat indices -> coordinates, ``(ndim,) + data.shape``, int32;
    out-of-range indices are clipped, as ``jnp.unravel_index`` does."""
    size = math.prod(shape)
    idx = torch.remainder(_index(data).clamp(-size, size - 1), size)
    coords = []
    for n in reversed(tuple(shape)):
        coords.append(torch.remainder(idx, n))
        idx = torch.div(idx, n, rounding_mode="floor")
    return torch.stack(coords[::-1], dim=0).to(torch.int32)


@register("ravel_multi_index", aliases=("_ravel_multi_index",))
def _ravel_multi_index(data, shape=()):
    """Coordinates ``(ndim, N)`` -> flat indices, int32; each coordinate
    clipped into its axis."""
    flat = torch.zeros(data.shape[1:], dtype=torch.int64, device=data.device)
    for i, n in enumerate(shape):
        flat = flat * int(n) + _index(data[i]).clamp(0, int(n) - 1)
    return flat.to(torch.int32)


@register("add_n", aliases=("ElementWiseSum", "_sum"))
def _add_n(*args, num_args=None):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@register("moments", num_outputs=2)
def _moments(data, axes=(), keepdims=False):
    """(mean, biased variance) over ``axes`` (empty: all)."""
    dims = tuple(axes) if axes else tuple(range(data.ndim))
    mean = torch.mean(data, dim=dims, keepdim=keepdims)
    mk = mean if keepdims else torch.mean(data, dim=dims, keepdim=True)
    var = torch.mean(torch.square(data - mk), dim=dims, keepdim=keepdims)
    return mean, var


@register("softmax_cross_entropy")
def _softmax_cross_entropy(data, label):
    """The summed cross-entropy of softmax(data) against integer
    labels."""
    logp = torch.log_softmax(data, dim=-1)
    picked = torch.gather(logp, -1, _index(label).unsqueeze(-1))
    return -torch.sum(picked)


@register("_histogram", aliases=("histogram",), num_outputs=2,
          differentiable=False)
def _histogram(data, bins=None, bin_cnt=10, range=None):
    """(counts, bin edges) as ``jnp.histogram``: ``bins`` an explicit
    edge tensor, else ``bin_cnt`` uniform bins over ``range`` (default:
    the data's min and max). The last bin includes its right edge;
    values outside the edges are not counted. Counts are float32, as the
    JAX op's."""
    flat = data.reshape(-1)
    if bins is not None:
        edges = bins
    else:
        if range is not None:
            lo, hi = (torch.full((), float(v), dtype=flat.dtype,
                                 device=flat.device) for v in range)
        else:
            lo, hi = torch.min(flat), torch.max(flat)
        n = int(bin_cnt)
        edges = lo + (hi - lo) / n * torch.arange(
            n + 1, dtype=flat.dtype, device=flat.device)
        edges = torch.cat([edges[:-1], hi.reshape(1)])
    at = torch.searchsorted(edges, flat, right=True)
    at = torch.where(flat == edges[-1], edges.numel() - 1, at)
    counts = torch.zeros(edges.numel() + 1, dtype=torch.float32,
                         device=flat.device)
    counts.index_add_(0, at, torch.ones_like(flat, dtype=torch.float32))
    return counts[1:edges.numel()], edges


@register("col2im")
def _col2im(data, output_size=(), kernel=(), stride=(1, 1), dilate=(1, 1),
            pad=(0, 0)):
    """Fold sliding-window columns back into the image, summing where
    windows overlap (the transpose of im2col)."""
    n, ckk, _ = data.shape
    kh, kw = kernel
    c = ckk // (kh * kw)
    oh, ow = output_size
    sh, sw = stride
    dh, dw = dilate
    ph, pw = pad
    hpad, wpad = oh + 2 * ph, ow + 2 * pw
    out_h = (hpad - (dh * (kh - 1) + 1)) // sh + 1
    out_w = (wpad - (dw * (kw - 1) + 1)) // sw + 1
    cols = data.reshape(n, c, kh, kw, out_h, out_w)
    img = torch.zeros((n, c, hpad, wpad), dtype=data.dtype,
                      device=data.device)
    for i in range(kh):
        for j in range(kw):
            img[:, :, i * dh:i * dh + sh * out_h:sh,
                j * dw:j * dw + sw * out_w:sw] += cols[:, :, i, j]
    return img[:, :, ph:ph + oh, pw:pw + ow]


def _assign_at(lhs, begin, end, step):
    """The write target of ``lhs[begin:end:step]`` in a copy of ``lhs``:
    ``(copy, positive slices, axes to flip the value along)``; as in the
    JAX op, only the axes ``begin`` names are sliced."""
    nd = len(begin)
    shape = lhs.shape[:nd]
    sl, flips = _slices(shape, begin, end, step)
    return lhs.clone(), sl, flips


@register("_slice_assign")
def _slice_assign(lhs, rhs, begin=(), end=(), step=()):
    """``lhs`` with ``lhs[begin:end:step] = rhs``, out of place."""
    out, sl, flips = _assign_at(lhs, begin, end, step)
    out[sl] = torch.flip(rhs, dims=flips).to(lhs.dtype) if flips \
        else rhs.to(lhs.dtype)
    return out


@register("_slice_assign_scalar")
def _slice_assign_scalar(lhs, scalar=0.0, begin=(), end=(), step=()):
    out, sl, _ = _assign_at(lhs, begin, end, step)
    out[sl] = scalar
    return out


@register("_rnn_param_concat")
def _rnn_param_concat(*args, dim=0, num_args=None):
    """The fused RNN parameter pack: flattened along axis 0 when
    ``dim`` is 0."""
    if dim == 0:
        return torch.cat([a.reshape(-1) for a in args], dim=0)
    return torch.cat(args, dim=dim)


@register("_identity_with_attr_like_rhs")
def _identity_with_attr_like_rhs(lhs, rhs):
    return lhs


@register("cast_storage")
def _cast_storage(data, stype="default"):
    """The dense identity: the storage types live at the NDArray layer."""
    return data


@register("_sparse_retain")
def _sparse_retain(data, indices):
    """``data`` with the rows that ``indices`` does not list zeroed."""
    keep = torch.zeros(data.shape[0], dtype=torch.bool, device=data.device)
    keep[indices.long()] = True
    keep = keep.reshape((-1,) + (1,) * (data.ndim - 1))
    return torch.where(keep, data, torch.zeros((), dtype=data.dtype,
                                               device=data.device))


# -------------------------------------------------------------- creation ---

@register("_zeros", aliases=("_zeros_without_dtype",), differentiable=False)
def _zeros_op(shape=(), dtype="float32", ctx=None):
    return torch.zeros(tuple(shape), dtype=canonical_dtype(dtype or
                                                           "float32"),
                       device=_device(ctx))


@register("_ones", differentiable=False)
def _ones_op(shape=(), dtype="float32", ctx=None):
    return torch.ones(tuple(shape), dtype=canonical_dtype(dtype or
                                                          "float32"),
                      device=_device(ctx))


@register("_full", differentiable=False)
def _full_op(shape=(), value=0.0, dtype="float32", ctx=None):
    return torch.full(tuple(shape), value,
                      dtype=canonical_dtype(dtype or "float32"),
                      device=_device(ctx))


@register("_arange", differentiable=False)
def _arange_op(start=0.0, stop=None, step=1.0, repeat=1, infer_range=False,
               dtype="float32", ctx=None):
    if stop is None:
        start, stop = 0.0, start
    out = torch.arange(start, stop, step, dtype=canonical_dtype(dtype),
                       device=_device(ctx))
    if repeat > 1:
        out = torch.repeat_interleave(out, int(repeat))
    return out


@register("_linspace", differentiable=False)
def _linspace_op(start=0.0, stop=1.0, num=50, endpoint=True,
                 dtype="float32", ctx=None):
    num = int(num)
    dev = _device(ctx)
    if endpoint:
        out = torch.linspace(start, stop, num, dtype=torch.float64,
                             device=dev)
    else:
        out = torch.linspace(start, stop, num + 1, dtype=torch.float64,
                             device=dev)[:num]
    return out.to(canonical_dtype(dtype))
