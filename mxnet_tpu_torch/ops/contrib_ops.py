"""Contrib ops: FFT, detection (``MultiBox*``, NMS, IoU, the box codec,
bipartite matching), ROI pooling and align, the spatial transformer,
correlation, the interleaved attention products, ``BatchNorm_v1`` and
``SyncBatchNorm``, the ``_image_*`` ops and the contrib utilities.

Counterpart of ``mxnet_tpu/ops/contrib_ops.py`` (MXNet 1.x
``src/operator/contrib/``): the same names, aliases, output counts,
``differentiable=False`` flags and keyword defaults. The JAX ops are
plain XLA; these are torch ops (cuBLAS, cuFFT and torch's own kernels on
a card), differentiated by autograd. ``_contrib_getnnz`` waits for the
sparse arrays (``ROADMAP.md`` item A4).

On a card every op here but ``_contrib_boolean_mask`` runs inside a
CUDA graph with no host sync, forward and backward: no ``.item()``, no
``nonzero``, no tensor made from host data (constants are 0-d fills), and
the hard-negative count of ``MultiBoxTarget`` stays a device tensor
compared with each anchor's rank. ``_contrib_boolean_mask`` has an output
whose shape is its data's: it is a host op (``registry.py``), as the
JAX op is ``eager``.

Numerics follow the JAX ops:

* Sorts are stable (``argsort(stable=True)``), as ``jnp.argsort`` is: they
  decide the NMS order among equal scores and which of equally confident
  anchors ``MultiBoxTarget`` keeps as hard negatives. ``argmax`` takes the
  first of equal values in both packages.
* ``clip`` and the constant ``maximum``/``minimum`` are
  ``torch.maximum``/``torch.minimum`` against 0-d tensors, which split the
  gradient evenly at a tie as ``jnp.clip`` does (``torch.clamp`` passes
  it whole): a sampling grid on pixel centres hits such ties.
* Max reductions are ``amax``, which share the gradient among equal
  maxima, as JAX's ``max`` does.
* NMS sorts by score, builds the IoU of the first ``topk`` sorted rows
  against all (the JAX op builds all N x N, but its loop reads only rows
  below ``topk``: the same keep mask in ``topk / N`` of the memory), and
  suppresses greedily in ``topk`` steps of two device ops each.
* The scatters of ``count_sketch``, ``MultiBoxTarget``'s forced matches
  and the backward passes of the bilinear gathers (``ROIAlign``,
  ``BilinearSampler``, ``SpatialTransformer``) use atomic adds on a card:
  float sums there are not bitwise repeatable.

Where the port differs from the JAX op (``ROADMAP.md``, faults): ``box_nms``
with ``in_format="corner"`` and ``out_format="center"`` writes center
boxes (the JAX op raises: its module defines ``_corner_to_center`` twice,
and the second returns a tuple), fault C25; ``SyncBatchNorm`` with
``ndev > 1`` raises, naming the second card it would need (the JAX op
normalises over the local batch), fault C26.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .nn import _batch_norm
from .registry import register

__all__ = []


def _c(x, value):
    """``value`` as a 0-d tensor of ``x``'s dtype on ``x``'s device (a fill:
    it captures, where a tensor made from host data would copy and sync)."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def _maximum(x, value):
    return torch.maximum(x, _c(x, value))


def _minimum(x, value):
    return torch.minimum(x, _c(x, value))


def _clip(x, lo, hi):
    """``jnp.clip``: maximum, then minimum, each splitting the gradient
    at a tie."""
    return _minimum(_maximum(x, lo), hi)


def _f32(x):
    return float(np.float32(x))


# ------------------------------------------------------------------- fft ----

@register("_contrib_fft")
def _contrib_fft(data, compute_size=128):
    """FFT along the last axis; the complex output interleaved as
    ``[..., 2 * d]`` (re, im, re, im, ...)."""
    out = torch.view_as_real(torch.fft.fft(data.to(torch.complex64), dim=-1))
    return out.reshape(data.shape[:-1] + (2 * data.shape[-1],)) \
        .to(torch.float32)


@register("_contrib_ifft")
def _contrib_ifft(data, compute_size=128):
    """Inverse of ``_contrib_fft``'s layout: the real part, unscaled
    (times ``d``, cuFFT's convention)."""
    d = data.shape[-1] // 2
    pairs = data.reshape(data.shape[:-1] + (d, 2))
    comp = torch.complex(pairs[..., 0], pairs[..., 1])
    return (torch.fft.ifft(comp, dim=-1).real * d).to(torch.float32)


# ------------------------------------------------------------- detection ----

@register("MultiBoxPrior", aliases=("_contrib_MultiBoxPrior",))
def _multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                    steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor boxes ``(1, H * W * (len(sizes) + len(ratios) - 1), 4)`` in
    corner format, for each location (row-major) the sizes at the first
    ratio, then the first size at the other ratios."""
    h, w = data.shape[2], data.shape[3]
    f32, dev = torch.float32, data.device
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    cy = (torch.arange(h, dtype=f32, device=dev) + offsets[0]) * step_y
    cx = (torch.arange(w, dtype=f32, device=dev) + offsets[1]) * step_x
    shapes = [(s, ratios[0]) for s in sizes] + \
        [(sizes[0], r) for r in ratios[1:]]
    # (s * sqrt(r), s / sqrt(r)) in float32, as the JAX op rounds them
    half = []
    for s, r in shapes:
        root = np.sqrt(np.float32(r))
        half.append((_f32(np.float32(s) * root) / 2,
                     _f32(np.float32(s) / root) / 2))
    zero = torch.zeros((), dtype=f32, device=dev)
    hw = torch.stack([zero + v for v, _ in half])     # (A,)
    hh = torch.stack([zero + v for _, v in half])
    cy, cx = cy[:, None, None], cx[None, :, None]
    corners = torch.broadcast_tensors(cx - hw, cy - hh, cx + hw, cy + hh)
    out = torch.stack(corners, dim=-1).reshape(1, -1, 4)
    if clip:
        out = _clip(out, 0.0, 1.0)
    return out


def _center_to_corner(b):
    x, y, w, h = b.unbind(-1)
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], dim=-1)


def _corner_to_center(b):
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1],
                       dim=-1)


def _iou_corner(lhs, rhs):
    """IoU of ``(..., N, 4)`` and ``(..., M, 4)`` corner boxes ->
    ``(..., N, M)`` (the leading axes broadcast)."""
    lx1, ly1, lx2, ly2 = (lhs[..., :, None, i] for i in range(4))
    rx1, ry1, rx2, ry2 = (rhs[..., None, :, i] for i in range(4))
    iw = _maximum(torch.minimum(lx2, rx2) - torch.maximum(lx1, rx1), 0.0)
    ih = _maximum(torch.minimum(ly2, ry2) - torch.maximum(ly1, ry1), 0.0)
    inter = iw * ih
    area_l = _maximum(lx2 - lx1, 0.0) * _maximum(ly2 - ly1, 0.0)
    area_r = _maximum(rx2 - rx1, 0.0) * _maximum(ry2 - ry1, 0.0)
    union = area_l + area_r - inter
    return torch.where(union > 0, inter / union, _c(inter, 0.0))


@register("_contrib_box_iou")
def _contrib_box_iou(lhs, rhs, format="corner"):
    """IoU of every pair of ``lhs`` and ``rhs`` boxes."""
    if format == "center":
        lhs, rhs = _center_to_corner(lhs), _center_to_corner(rhs)
    return _iou_corner(lhs, rhs)


def _nms_keep(boxes, scores, ids, valid, overlap_thresh, topk):
    """Greedy NMS over a batch: ``boxes (B, N, 4)``, ``scores``, ``ids``,
    ``valid (B, N)`` -> the keep mask ``(B, N)``. In score order (stable),
    each of the first ``topk`` (all for ``topk < 0``) kept valid boxes
    suppresses the later boxes of its class whose IoU with it exceeds
    ``overlap_thresh``. No gradient flows through the mask."""
    boxes, scores, ids = boxes.detach(), scores.detach(), ids.detach()
    b, n = scores.shape
    order = torch.argsort(-scores, dim=1, stable=True)
    boxes_o = boxes.gather(1, order[..., None].expand(b, n, 4))
    ids_o = ids.gather(1, order)
    keep = valid.gather(1, order)
    k = n if topk < 0 else min(int(topk), n)
    rank = torch.arange(n, device=scores.device)
    # row i of `cut`: the boxes box i suppresses when it is kept
    cut = (_iou_corner(boxes_o[:, :k], boxes_o) > overlap_thresh) & \
        (ids_o[:, :k, None] == ids_o[:, None, :]) & \
        (rank[None, None, :] > rank[:k, None]) & keep[:, :k, None]
    stay = ~cut
    for i in range(k):
        keep &= torch.where(keep[:, i:i + 1], stay[:, i], True)
    return torch.zeros_like(keep).scatter_(1, order, keep)


@register("box_nms", aliases=("_contrib_box_nms",), num_outputs=1)
def _box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
             coord_start=2, score_index=1, id_index=-1, force_suppress=False,
             in_format="corner", out_format="corner", background_id=-1):
    """NMS that keeps the input's shape: the suppressed (and invalid)
    rows become -1."""
    shape = data.shape
    flat = data.reshape((-1,) + tuple(shape[-2:]))      # (B, N, K)
    boxes = flat[..., coord_start:coord_start + 4]
    if in_format == "center":
        boxes = _center_to_corner(boxes)
    if out_format != in_format:
        out_boxes = boxes if out_format == "corner" \
            else _corner_to_center(boxes)
        flat = torch.cat([flat[..., :coord_start], out_boxes,
                          flat[..., coord_start + 4:]], dim=-1)
    scores = flat[..., score_index]
    if id_index >= 0 and not force_suppress:
        ids = flat[..., id_index]
    else:
        ids = torch.zeros_like(scores)
    valid = scores > valid_thresh
    if id_index >= 0 and background_id >= 0:
        valid = valid & (flat[..., id_index] != background_id)
    keep = _nms_keep(boxes, scores, ids, valid, overlap_thresh, topk)
    out = torch.where(keep[..., None], flat, _c(flat, -1.0))
    return out.reshape(shape)


def _anchor_centers(anchors):
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    return aw, ah, acx, acy


@register("MultiBoxTarget", aliases=("_contrib_MultiBoxTarget",),
          num_outputs=3)
def _multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                     ignore_label=-1.0, negative_mining_ratio=-1.0,
                     negative_mining_thresh=0.5, minimum_negative_samples=0,
                     variances=(0.1, 0.1, 0.2, 0.2)):
    """Anchor matching and target encoding. ``anchor (1, N, 4)``, ``label
    (B, M, 5)`` rows ``[cls, x1, y1, x2, y2]`` (-1 padding), ``cls_pred
    (B, classes + 1, N)``. Returns ``loc_target (B, N * 4)``, ``loc_mask
    (B, N * 4)`` and ``cls_target (B, N)``: class + 1 for a matched anchor
    (IoU at least ``overlap_threshold``, or the best anchor of a ground
    truth), 0 for background and, with hard negative mining, 0 only for
    the ``ratio * positives`` unmatched anchors of highest non-background
    confidence (below ``negative_mining_thresh`` IoU) and
    ``ignore_label`` for the rest."""
    anchors = anchor[0]
    n = anchors.shape[0]
    b = label.shape[0]
    gt_valid = label[..., 0] >= 0                      # (B, M)
    gt_boxes = label[..., 1:5]                         # (B, M, 4)
    iou = _iou_corner(anchors, gt_boxes)               # (B, N, M)
    iou = torch.where(gt_valid[:, None, :], iou, _c(iou, -1.0))
    best_gt = iou.argmax(dim=2)                        # (B, N)
    best_iou = iou.amax(dim=2)
    # each valid ground truth forces its best anchor (an add, so that
    # padded rows, which all argmax to anchor 0, erase nothing)
    best_anchor = iou.argmax(dim=1)                    # (B, M)
    forced = torch.zeros((b, n), dtype=torch.int32, device=anchors.device) \
        .scatter_add_(1, best_anchor, gt_valid.to(torch.int32)) > 0
    pos = (best_iou >= overlap_threshold) | forced
    matched = gt_boxes.gather(1, best_gt[..., None].expand(b, n, 4))
    matched_cls = label[..., 0].gather(1, best_gt)
    aw, ah, acx, acy = _anchor_centers(anchors)
    gw = matched[..., 2] - matched[..., 0]
    gh = matched[..., 3] - matched[..., 1]
    gcx = (matched[..., 0] + matched[..., 2]) / 2
    gcy = (matched[..., 1] + matched[..., 3]) / 2
    eps = 1e-8
    tx = (gcx - acx) / _maximum(aw, eps) / variances[0]
    ty = (gcy - acy) / _maximum(ah, eps) / variances[1]
    tw = torch.log(_maximum(gw, eps) / _maximum(aw, eps)) / variances[2]
    th = torch.log(_maximum(gh, eps) / _maximum(ah, eps)) / variances[3]
    loc_t = torch.stack([tx, ty, tw, th], dim=-1)
    loc_t = torch.where(pos[..., None], loc_t, _c(loc_t, 0.0)).reshape(b, -1)
    loc_m = pos[..., None].expand(b, n, 4).to(anchors.dtype).reshape(b, -1)
    cls_t = torch.where(pos, matched_cls + 1.0, _c(matched_cls, 0.0))
    if negative_mining_ratio > 0:
        neg_conf = cls_pred.detach()[:, 1:].amax(dim=1)            # (B, N)
        eligible = ~pos & (best_iou < negative_mining_thresh)
        num_pos = pos.sum(dim=1, dtype=torch.int32).to(torch.float32)
        num_neg = torch.clamp_min(
            (negative_mining_ratio * num_pos).to(torch.int32),
            minimum_negative_samples)
        score = torch.where(eligible, neg_conf, _c(neg_conf, -math.inf))
        order = torch.argsort(-score, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(n, device=order.device).expand(b, n))
        keep_neg = eligible & (rank < num_neg[:, None])
        cls_t = torch.where(pos, cls_t, torch.where(
            keep_neg, _c(cls_t, 0.0), _c(cls_t, ignore_label)))
    return loc_t, loc_m, cls_t


@register("MultiBoxDetection", aliases=("_contrib_MultiBoxDetection",))
def _multibox_detection(cls_prob, loc_pred, anchor, clip=True,
                        threshold=0.01, background_id=0,
                        nms_threshold=0.5, force_suppress=False,
                        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """Decoded detections ``(B, N, 6)``, rows ``[id, score, x1, y1, x2,
    y2]`` in anchor order: the best non-background class of each anchor
    (its index among the foreground classes) and its probability, NMS
    within each class, -1 rows where suppressed or at most
    ``threshold``."""
    b, c, n = cls_prob.shape
    aw, ah, acx, acy = _anchor_centers(anchor[0])
    loc = loc_pred.reshape(b, n, 4)
    cx = loc[..., 0] * variances[0] * aw + acx
    cy = loc[..., 1] * variances[1] * ah + acy
    w = torch.exp(loc[..., 2] * variances[2]) * aw / 2
    h = torch.exp(loc[..., 3] * variances[3]) * ah / 2
    boxes = torch.stack([cx - w, cy - h, cx + w, cy + h], dim=-1)
    if clip:
        boxes = _clip(boxes, 0.0, 1.0)
    fg = torch.cat([cls_prob[:, :background_id],
                    cls_prob[:, background_id + 1:]], dim=1) \
        if 0 <= background_id < c else cls_prob
    best = fg.argmax(dim=1).to(torch.float32)                     # (B, N)
    score = fg.amax(dim=1)
    keep_score = score > threshold
    det = torch.cat([
        torch.where(keep_score, best, _c(best, -1.0))[..., None],
        torch.where(keep_score, score, _c(score, 0.0))[..., None], boxes],
        dim=-1)
    return _box_nms(det, overlap_thresh=nms_threshold,
                    valid_thresh=threshold, topk=nms_topk, coord_start=2,
                    score_index=1, id_index=0, force_suppress=force_suppress)


# ------------------------------------------------------------------ rois ----

def _bilinear_gather(data, bidx, ys, xs):
    """Bilinear samples of ``data (B, C, H, W)`` at float coordinates
    ``ys``, ``xs`` of image ``bidx`` (all broadcast to one shape S) ->
    ``(*S, C)``; out-of-range coordinates clamp to the edge."""
    h, w = data.shape[-2], data.shape[-1]
    y0 = _clip(torch.floor(ys), 0, h - 1)
    x0 = _clip(torch.floor(xs), 0, w - 1)
    y1 = _clip(y0 + 1, 0, h - 1)
    x1 = _clip(x0 + 1, 0, w - 1)
    wy = _clip(ys - y0, 0.0, 1.0)[..., None]
    wx = _clip(xs - x0, 0.0, 1.0)[..., None]
    y0i, y1i, x0i, x1i = (t.long() for t in (y0, y1, x0, x1))
    v00 = data[bidx, :, y0i, x0i]
    v01 = data[bidx, :, y0i, x1i]
    v10 = data[bidx, :, y1i, x0i]
    v11 = data[bidx, :, y1i, x1i]
    return (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
            + v10 * wy * (1 - wx) + v11 * wy * wx)


def _roi_grid(rois, spatial_scale, ph, pw, s, off, rounded, aligned):
    """Per ROI ``(R, 1, 1, 1, 1)`` corners and the bins' ``s x s`` sample
    offsets ``(ph, 1, s, 1)``, ``(1, pw, 1, s)``."""
    f32, dev = rois.dtype, rois.device
    x1, y1, x2, y2 = (rois[:, i] * spatial_scale - off for i in (1, 2, 3, 4))
    if rounded:
        x1, y1, x2, y2 = (torch.round(t) for t in (x1, y1, x2, y2))
        rh = _maximum(y2 - y1 + 1, 1.0)
        rw = _maximum(x2 - x1 + 1, 1.0)
    else:
        rh = y2 - y1 if aligned else _maximum(y2 - y1, 1.0)
        rw = x2 - x1 if aligned else _maximum(x2 - x1, 1.0)
    bin_h, bin_w = rh / ph, rw / pw
    sy = torch.arange(ph, device=dev)[:, None, None, None]
    sx = torch.arange(pw, device=dev)[None, :, None, None]
    oy = (torch.arange(s, dtype=f32, device=dev)[None, None, :, None]
          + 0.5) / s
    ox = (torch.arange(s, dtype=f32, device=dev)[None, None, None, :]
          + 0.5) / s
    r = (slice(None),) + (None,) * 4
    ys = y1[r] + (sy + oy) * bin_h[r]
    xs = x1[r] + (sx + ox) * bin_w[r]
    return ys, xs


@register("ROIPooling")
def _roi_pooling(data, rois, pooled_size=(1, 1), spatial_scale=1.0):
    """Max pooling over regions. ``rois (R, 5)`` rows ``[batch_index, x1,
    y1, x2, y2]`` in image coordinates; each of the ``pooled_size`` bins
    takes the maximum of a 2 x 2 grid of pixels (the JAX op's static-shape
    stand-in for the reference's variable-size bins) -> ``(R, C, ph,
    pw)``."""
    ph, pw = pooled_size
    h, w = data.shape[2], data.shape[3]
    ys, xs = _roi_grid(rois, spatial_scale, ph, pw, 2, 0.0, True, False)
    ys = _clip(ys, 0, h - 1).long()
    xs = _clip(xs, 0, w - 1).long()
    bidx = rois[:, 0].long()[:, None, None, None, None]
    vals = data[bidx, :, ys, xs]                      # (R, ph, pw, 2, 2, C)
    return vals.amax(dim=(3, 4)).permute(0, 3, 1, 2)


@register("_contrib_ROIAlign")
def _roi_align(data, rois, pooled_size=(1, 1), spatial_scale=1.0,
               sample_ratio=2, position_sensitive=False, aligned=False):
    """Bilinear average pooling over regions: each bin averages a
    ``sample_ratio`` x ``sample_ratio`` grid of bilinear samples ->
    ``(R, C, ph, pw)``."""
    ph, pw = pooled_size
    s = max(int(sample_ratio), 1)
    ys, xs = _roi_grid(rois, spatial_scale, ph, pw, s,
                       0.5 if aligned else 0.0, False, aligned)
    bidx = rois[:, 0].long()[:, None, None, None, None]
    vals = _bilinear_gather(data, bidx, ys, xs)       # (R, ph, pw, s, s, C)
    return vals.mean(dim=(3, 4)).permute(0, 3, 1, 2)


# -------------------------------------------------- spatial transformer ----

def _unit_grid(h, w, like):
    ys = torch.linspace(-1.0, 1.0, h, dtype=like.dtype, device=like.device)
    xs = torch.linspace(-1.0, 1.0, w, dtype=like.dtype, device=like.device)
    return torch.meshgrid(ys, xs, indexing="ij")


@register("GridGenerator")
def _grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """A sampling grid ``(B, 2, H, W)``, (x, y) in [-1, 1]: an affine map
    ``data (B, 6)`` of the target's unit grid, or (``"warp"``) the unit
    grid plus the flow ``data (B, 2, H, W)`` in pixels."""
    if transform_type == "affine":
        b = data.shape[0]
        h, w = target_shape
        theta = data.reshape(b, 2, 3)
        gy, gx = _unit_grid(h, w, data)
        coords = torch.stack([gx.reshape(-1), gy.reshape(-1),
                              torch.ones_like(gx).reshape(-1)])   # (3, HW)
        return torch.matmul(theta, coords).reshape(b, 2, h, w)
    b, _, h, w = data.shape
    gy, gx = _unit_grid(h, w, data)
    flow = torch.stack([data[:, 0] / ((w - 1) / 2.0),
                        data[:, 1] / ((h - 1) / 2.0)], dim=1)
    return torch.stack([gx, gy])[None] + flow


@register("BilinearSampler")
def _bilinear_sampler(data, grid, cudnn_off=False):
    """``data (B, C, H, W)`` sampled at ``grid (B, 2, Ho, Wo)`` in [-1, 1];
    samples more than a pixel outside the image are 0."""
    b, _, h, w = data.shape
    xs = (grid[:, 0] + 1.0) * (w - 1) / 2.0
    ys = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    inside = (xs >= -1) & (xs <= w) & (ys >= -1) & (ys <= h)
    bidx = torch.arange(b, device=data.device)[:, None, None]
    out = _bilinear_gather(data, bidx, ys, xs).permute(0, 3, 1, 2)
    return out * inside[:, None].to(data.dtype)


@register("SpatialTransformer")
def _spatial_transformer(data, loc, target_shape=(0, 0),
                         transform_type="affine", sampler_type="bilinear",
                         cudnn_off=False):
    """An affine grid of ``target_shape`` from ``loc (B, 6)``, sampled
    bilinearly."""
    grid = _grid_generator(loc, transform_type="affine",
                           target_shape=tuple(target_shape))
    return _bilinear_sampler(data, grid)


# ------------------------------------------------------------------ misc ----

def _resize_linear(x, h, w):
    """``jax.image.resize(method="linear")`` of the last two axes of
    ``x (N, C, H, W)``: half-pixel centres, a triangle filter widened by the
    scale when shrinking (antialiased)."""
    return F.interpolate(x, size=(h, w), mode="bilinear",
                         align_corners=False, antialias=True)


def _resize_nearest(x, h, w):
    """``jax.image.resize(method="nearest")`` of the last two axes: output
    pixel i reads ``floor((i + 0.5) * in / out)``, in float32."""
    for axis, size in ((-2, h), (-1, w)):
        m = x.shape[axis]
        if m == size:
            continue
        idx = torch.floor((torch.arange(size, dtype=torch.float32,
                                        device=x.device) + 0.5) * m / size)
        x = x.index_select(axis, idx.long())
    return x


@register("_contrib_BilinearResize2D")
def _bilinear_resize2d(data, height=1, width=1, scale_height=None,
                       scale_width=None, mode="size"):
    """``(N, C, H, W)`` resized to ``(height, width)`` (or the input's size
    times the scales), as ``jax.image.resize`` linear."""
    h = int(data.shape[2] * scale_height) if scale_height else height
    w = int(data.shape[3] * scale_width) if scale_width else width
    return _resize_linear(data, h, w)


@register("Correlation")
def _correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                 stride2=1, pad_size=0, is_multiply=True):
    """The FlowNet cost volume at ``kernel_size=1`` (the JAX op's reading):
    one output channel per displacement of ``data2`` within
    ``max_displacement`` (step ``stride2``), the channel mean of the
    product (or the absolute difference)."""
    _, _, h, w = data1.shape
    d = max_displacement
    p = d + pad_size
    padded = F.pad(data2, (p, p, p, p))
    outs = []
    for dy in range(-d, d + 1, stride2):
        for dx in range(-d, d + 1, stride2):
            shifted = padded[:, :, p + dy:p + dy + h, p + dx:p + dx + w]
            if is_multiply:
                outs.append((data1 * shifted).mean(dim=1))
            else:
                outs.append(torch.abs(data1 - shifted).mean(dim=1))
    return torch.stack(outs, dim=1)


@register("_contrib_boolean_mask", differentiable=False, host=True)
def _boolean_mask(data, index, axis=0):
    """The slices of ``data`` along ``axis`` where ``index`` is nonzero: an
    output shape that depends on the values, so a host op."""
    idx = torch.nonzero(index.reshape(-1))[:, 0]
    return torch.index_select(data, axis, idx)


@register("_contrib_index_copy")
def _index_copy(old, index, new_tensor):
    """``old`` with rows ``index`` replaced by ``new_tensor``'s."""
    return old.index_copy(0, index.long(), new_tensor)


@register("_contrib_arange_like")
def _contrib_arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    """``start + step * (i // repeat)`` for i below ``data.shape[axis]``
    (``data``'s size when ``axis`` is None): a flat float32 vector, as the
    JAX op gives it."""
    n = data.shape[axis] if axis is not None else data.numel()
    i = torch.div(torch.arange(n, device=data.device), max(int(repeat), 1),
                  rounding_mode="floor")
    return start + step * i.to(torch.float32)


@register("multi_all_finite")
def _multi_all_finite(*arrays, num_arrays=1, init_output=True):
    """``[1.]`` when every element of every input is finite, else ``[0.]``
    (the AMP overflow check), computed on the device."""
    ok = torch.stack([torch.isfinite(a).all() for a in arrays]).all()
    return ok.to(torch.float32).reshape(1)


@register("_contrib_count_sketch")
def _count_sketch(data, h, s, out_dim=16, processing_batch_size=32):
    """Count sketch: ``out[..., h[j]] += data[..., j] * s[j]``."""
    out = torch.zeros(data.shape[:-1] + (out_dim,), dtype=data.dtype,
                      device=data.device)
    return out.index_add(-1, h.long().reshape(-1), data * s.reshape(-1))


@register("im2col")
def _im2col(data, kernel=(), stride=(), dilate=(), pad=()):
    """Patches ``(B, C * prod(kernel), prod(out_spatial))``, channel-major
    then kernel offsets, as ``lax.conv_general_dilated_patches`` orders
    them."""
    n = len(kernel)
    stride = tuple(stride) if stride else (1,) * n
    dilate = tuple(dilate) if dilate else (1,) * n
    pad = tuple(pad) if pad else (0,) * n
    b, c = data.shape[:2]
    x = F.pad(data, [p for q in reversed(pad) for p in (q, q)])
    for d in range(n):
        x = x.unfold(2 + d, (kernel[d] - 1) * dilate[d] + 1, stride[d])
        if dilate[d] > 1:
            x = x[..., ::dilate[d]]
    # (B, C, *out, *kernel) -> (B, C, *kernel, *out)
    x = x.permute([0, 1] + list(range(2 + n, 2 + 2 * n))
                  + list(range(2, 2 + n)))
    return x.reshape(b, c * math.prod(kernel), -1)


@register("BlockGrad", aliases=("stop_gradient",))
def _block_grad(data):
    """``data`` with no gradient flowing back."""
    return data.detach()


# ------------------------------------------------- transformer products ----
# MXNet's contrib/transformer.cc: q, k and v interleaved per head in one
# (seq, batch, parts * heads * head_dim) projection.

def _split_interleaved(qkv, heads, parts):
    seq, bsz, proj = qkv.shape
    x = qkv.reshape(seq, bsz, heads, parts, proj // (parts * heads))
    return [x[:, :, :, i, :] for i in range(parts)]   # each (s, b, h, d)


def _inv_sqrt(d):
    """``1 / sqrt(d)`` rounded as the JAX ops round it (float32)."""
    return _f32(np.float32(1.0) / np.sqrt(np.float32(d)))


@register("_contrib_interleaved_matmul_selfatt_qk")
def _interleaved_selfatt_qk(queries_keys_values, heads=1):
    """Scaled ``q @ k^T`` from the interleaved projection ->
    ``(batch * heads, seq, seq)``."""
    q, k, _ = _split_interleaved(queries_keys_values, heads, 3)
    att = torch.einsum("qbhd,kbhd->bhqk", q * _inv_sqrt(q.shape[-1]), k)
    b, h, s, _ = att.shape
    return att.reshape(b * h, s, s)


@register("_contrib_interleaved_matmul_selfatt_valatt")
def _interleaved_selfatt_valatt(queries_keys_values, attention, heads=1):
    """``attention @ v`` back to ``(seq, batch, heads * head_dim)``."""
    _, _, v = _split_interleaved(queries_keys_values, heads, 3)
    s, b, h, d = v.shape
    out = torch.einsum("bhqk,kbhd->qbhd", attention.reshape(b, h, s, s), v)
    return out.reshape(s, b, h * d)


@register("_contrib_interleaved_matmul_encdec_qk")
def _interleaved_encdec_qk(queries, keys_values, heads=1):
    """Scaled ``q @ k^T`` of separate queries and interleaved keys and
    values -> ``(batch * heads, q_seq, kv_seq)``."""
    qs, b, proj = queries.shape
    d = proj // heads
    q = queries.reshape(qs, b, heads, d)
    k, _ = _split_interleaved(keys_values, heads, 2)
    att = torch.einsum("qbhd,kbhd->bhqk", q * _inv_sqrt(d), k)
    return att.reshape(b * heads, qs, k.shape[0])


@register("_contrib_interleaved_matmul_encdec_valatt")
def _interleaved_encdec_valatt(keys_values, attention, heads=1):
    """``attention @ v`` of the interleaved keys and values ->
    ``(q_seq, batch, heads * head_dim)``."""
    _, v = _split_interleaved(keys_values, heads, 2)
    ks, b, h, d = v.shape
    qs = attention.shape[1]
    out = torch.einsum("bhqk,kbhd->qbhd", attention.reshape(b, h, qs, ks), v)
    return out.reshape(qs, b, h * d)


# ------------------------------------------------------------ box codec ----

def _centers(boxes):
    xmin, ymin, xmax, ymax = boxes.unbind(-1)
    w = xmax - xmin
    h = ymax - ymin
    return xmin + w / 2, ymin + h / 2, w, h


@register("_contrib_box_encode", num_outputs=2)
def _box_encode(samples, matches, anchors, refs, means=(0., 0., 0., 0.),
                stds=(0.1, 0.1, 0.2, 0.2)):
    """Regression targets of the positive samples (``samples > 0.5``)
    against their matched references, and their mask."""
    ax, ay, aw, ah = _centers(anchors)
    idx = _maximum(matches, 0).long()[..., None]
    matched = refs.gather(1, idx.expand(idx.shape[:-1] + (4,)))
    gx, gy, gw, gh = _centers(matched)
    parts = [(gx - ax) / aw, (gy - ay) / ah, torch.log(gw / aw),
             torch.log(gh / ah)]
    t = torch.stack([(p - m) / s for p, m, s in zip(parts, means, stds)],
                    dim=-1)
    mask = (samples > 0.5)[..., None]
    return torch.where(mask, t, _c(t, 0.0)), \
        mask.expand(t.shape).to(t.dtype)


@register("_contrib_box_decode")
def _box_decode(data, anchors, std0=0.1, std1=0.1, std2=0.2, std3=0.2,
                clip=-1.0, format="corner"):
    """Regression deltas back to corner boxes; ``clip > 0`` caps the
    log-scale deltas."""
    if format == "corner":
        ax, ay, aw, ah = _centers(anchors)
    else:
        ax, ay, aw, ah = anchors.unbind(-1)
    d0, d1, dw, dh = (data[..., i] * s for i, s in
                      enumerate((std0, std1, std2, std3)))
    cx = d0 * aw + ax
    cy = d1 * ah + ay
    if clip is not None and clip > 0:
        dw = _minimum(dw, clip)
        dh = _minimum(dh, clip)
    w = torch.exp(dw) * aw
    h = torch.exp(dh) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


@register("_contrib_bipartite_matching", num_outputs=2,
          differentiable=False)
def _bipartite_matching(data, is_ascend=False, threshold=0.0, topk=-1):
    """Greedy one-to-one matching of ``data (B, rows, cols)`` by score:
    each round takes the best remaining pair (the first of equal ones).
    Returns each row's column and each column's row, -1 where unmatched."""
    b, rows, cols = data.shape
    rounds = min(rows, cols) if topk <= 0 else min(topk, rows, cols)
    score = -data if is_ascend else data
    passes = (data <= threshold) if is_ascend else (data >= threshold)
    score = torch.where(passes, score, _c(score, -math.inf))
    row_out = torch.full((b, rows), -1.0, dtype=data.dtype,
                         device=data.device)
    col_out = torch.full((b, cols), -1.0, dtype=data.dtype,
                         device=data.device)
    ar_r = torch.arange(rows, device=data.device)
    ar_c = torch.arange(cols, device=data.device)
    for _ in range(rounds):
        flat = score.reshape(b, -1)
        best = flat.argmax(dim=1)
        ri, ci = best // cols, best % cols
        valid = flat.gather(1, best[:, None])[:, 0] > -math.inf
        row_out = torch.where(valid[:, None] & (ar_r[None] == ri[:, None]),
                              ci[:, None].to(data.dtype), row_out)
        col_out = torch.where(valid[:, None] & (ar_c[None] == ci[:, None]),
                              ri[:, None].to(data.dtype), col_out)
        gone = (ar_r[None, :, None] == ri[:, None, None]) | \
            (ar_c[None, None, :] == ci[:, None, None])
        score = torch.where(gone, _c(score, -math.inf), score)
    return row_out, col_out


# ------------------------------------------------------------ utilities ----

@register("_contrib_quadratic", aliases=("quadratic",))
def _quadratic(data, a=0.0, b=0.0, c=0.0):
    """``a * data ** 2 + b * data + c``."""
    return a * torch.square(data) + b * data + c


@register("_contrib_allclose", differentiable=False)
def _allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    """``1.`` when ``|a - b| <= atol + rtol * |b|`` everywhere (a 0-d
    float32 on the device; ``torch.allclose`` would read it back)."""
    return torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan) \
        .all().to(torch.float32)


@register("_contrib_index_array", differentiable=False)
def _index_array(data, axes=None):
    """The coordinates of every element, ``data.shape + (len(axes),)``,
    int64 (the JAX op's int64 is int32 without x64)."""
    grids = torch.meshgrid(*[torch.arange(s, device=data.device)
                             for s in data.shape], indexing="ij")
    if axes is not None:     # picked on the host: an index tensor would copy
        grids = [grids[a] for a in axes]
    return torch.stack(grids, dim=-1).to(torch.int64)


register("BatchNorm_v1", num_outputs=3)(_batch_norm)


@register("_contrib_SyncBatchNorm", num_outputs=3,
          aliases=("SyncBatchNorm",))
def _sync_batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                     momentum=0.9, fix_gamma=True, use_global_stats=False,
                     output_mean_var=False, ndev=1, key=None, axis=1,
                     training=True):
    """BatchNorm over the batch of one card. With ``ndev > 1`` MXNet
    reduces the statistics across the cards of the batch: the port runs
    one card per process and raises (fault C26)."""
    if int(ndev) > 1:
        raise MXNetError(
            f"SyncBatchNorm with ndev={ndev} reduces the batch statistics "
            f"across {ndev} cards and needs a second card (gpu(1)) in this "
            "process; the port runs one card per process (ndev=1). See "
            "ROADMAP.md, multi-card data parallelism")
    return _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=eps,
                       momentum=momentum, fix_gamma=fix_gamma,
                       use_global_stats=use_global_stats, axis=axis,
                       training=training)


# ----------------------------------------------------------- image ops -----
# src/operator/image/: the device-side image pipeline on HWC or NHWC data.

@register("_image_to_tensor")
def _image_to_tensor(data):
    """HWC/NHWC in [0, 255] -> CHW/NCHW float32 in [0, 1]."""
    x = data.to(torch.float32) / 255.0
    return x.permute((2, 0, 1) if x.ndim == 3 else (0, 3, 1, 2))


@register("_image_normalize")
def _image_normalize(data, mean=(0.0,), std=(1.0,)):
    """``(data - mean) / std`` per channel of CHW/NCHW data."""
    shape = [1] * data.ndim
    shape[0 if data.ndim == 3 else 1] = -1
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    m = torch.stack([zero + v for v in mean]).reshape(shape)
    s = torch.stack([zero + v for v in std]).reshape(shape)
    return (data - m) / s


@register("_image_resize")
def _image_resize(data, size=(), keep_ratio=False, interp=1):
    """HWC/NHWC resized to ``size`` ``(w, h)`` (or ``w`` for both):
    nearest for ``interp=0``, else linear, in float32 and back to the
    input's dtype."""
    if isinstance(size, int):
        size = (size, size)
    w, h = (size[0], size[1]) if len(size) == 2 else (size[0], size[0])
    x = data.to(torch.float32)
    x = x.permute(2, 0, 1)[None] if data.ndim == 3 else x.permute(0, 3, 1, 2)
    x = _resize_nearest(x, h, w) if interp == 0 else _resize_linear(x, h, w)
    x = x[0].permute(1, 2, 0) if data.ndim == 3 else x.permute(0, 2, 3, 1)
    return x.to(data.dtype)


@register("_image_crop")
def _image_crop(data, x=0, y=0, width=1, height=1):
    """The ``width`` x ``height`` window of HWC/NHWC data at ``(x, y)``."""
    if data.ndim == 3:
        return data[y:y + height, x:x + width, :]
    return data[:, y:y + height, x:x + width, :]
