"""Post-training int8 quantization: ``quantize_model`` and
``quantize_net``.

Counterpart of the whole of ``mxnet_tpu/contrib/quantization.py``, in
three phases:

1. **Calibrate** (``_collect_ranges`` :222): run ``calib_data`` through
   the float32 graph on the caller's context (on a card: the flash
   kernel and cuBLAS) and collect the range of the data input of every
   FullyConnected (and Convolution) node: ``"naive"`` (running min and
   max; taken on the device, where they are exact), ``"entropy"`` (the
   KL-divergence threshold search of ``calibrate.cc`` over a 2048-bin
   host histogram per tensor) or ``"percentile"`` (a 99.99% clip); and
   the observed min and max of each such node's output.
2. **Pass** (``quantize_graph`` :334): rewrite the graph: FullyConnected
   becomes ``_contrib_quantized_fully_connected`` and Convolution
   ``_contrib_quantized_conv`` (K4 through an int8 im2col,
   ``ops/quantization.py``), each with int8 weight and float32 scale
   inputs and the calibrated range as attributes; Embedding becomes
   ``_contrib_quantized_embedding`` + dequantize.
3. **Params** (``_quantize_params`` :421): symmetric int8 weights, one
   scale per output channel (default; a convolution's over its
   ``(C / g) * prod(kernel)`` values) or per tensor; embedding tables per
   tensor; biases stay float32.

The KL search and the histogram collector are host numpy, the JAX
package's arithmetic, so both packages pick the same thresholds from the
same histograms; the search projects each candidate onto the int8
levels with one ``np.add.reduceat`` where the JAX package loops over
the levels (sums of integer counts: the same bits, 7x faster).
"""
from __future__ import annotations

import tempfile

import numpy as _np
import torch

__all__ = ["quantize_model", "quantize_net", "quantize_graph",
           "kl_optimal_threshold", "last_calibration", "last_quantization",
           "DEFAULT_NUM_BINS", "DEFAULT_NUM_QUANTIZED_BINS"]

_QUANTIZABLE = {"Convolution": "_contrib_quantized_conv",
                "FullyConnected": "_contrib_quantized_fully_connected"}

#: calibrate.cc uses 8001 bins; 2048 keeps the sweep cheap on host numpy
#: while leaving the int8 projection (255 levels) 8x oversampled.
DEFAULT_NUM_BINS = 2048
#: int8 symmetric: 255 representable levels (-127..127).
DEFAULT_NUM_QUANTIZED_BINS = 255

# the last calibration and the last graph-pass census in this process
_LAST_CALIB = None
_LAST_PASS = None


def last_calibration():
    """The most recent calibration run in this process (mode, bins,
    per-tensor thresholds/ranges, examples seen) or None."""
    return _LAST_CALIB


def last_quantization():
    """The most recent :func:`quantize_graph` census in this process
    (per-weight granularity kinds, op counts) or None."""
    return _LAST_PASS


# ------------------------------------------------------------ KL search ---

def _smooth(p, eps=0.0001):
    """parity: calibrate.cc SmoothDistribution — add eps mass to the zero
    bins, subtract the compensating mass from nonzero bins so KL(P||Q)
    stays finite; None when infeasible (all-zero or eps overload)."""
    p = p.astype(_np.float64)
    is_zeros = p == 0
    n_zeros = int(is_zeros.sum())
    n_nonzeros = p.size - n_zeros
    if not n_nonzeros:
        return None
    eps1 = eps * float(n_zeros) / float(n_nonzeros)
    if eps1 >= 1.0:
        return None
    out = p.copy()
    out[is_zeros] = eps
    out[~is_zeros] -= eps1
    return out


def _kl_divergence(p, q):
    """KL(P||Q) over already-positive distributions (normalized here)."""
    p = p / p.sum()
    q = q / q.sum()
    mask = p > 0
    return float(_np.sum(p[mask] * _np.log(p[mask] / q[mask])))


def kl_optimal_threshold(hist, hist_edges,
                         num_quantized_bins=DEFAULT_NUM_QUANTIZED_BINS):
    """The calibrate.cc KL-divergence threshold search, host-side numpy.

    ``hist`` is a histogram over the SYMMETRIC range
    ``(-th, th)`` (even bin count; ``hist_edges`` has ``len(hist)+1``
    entries). The two halves are folded into a histogram of ``|x|``;
    every candidate threshold (each folded bin edge from
    ``num_quantized_bins//2 + 1`` outward) clips the reference
    distribution P at the candidate, dumps the outlier mass into the
    edge bin, projects P onto ``(num_quantized_bins+1)//2`` int8-side
    levels, expands the projection Q back, smooths both, and scores
    KL(P ‖ Q). Returns ``(threshold, kl_divergence)`` for the argmin —
    deterministic: pure numpy, ties broken toward the smaller
    threshold.
    """
    hist = _np.asarray(hist, _np.float64)
    hist_edges = _np.asarray(hist_edges, _np.float64)
    n = hist.size
    if n % 2 or hist_edges.size != n + 1:
        raise ValueError(
            f"kl_optimal_threshold wants an even-bin symmetric histogram; "
            f"got {n} bins / {hist_edges.size} edges")
    mid = n // 2
    # fold onto |x|: bin j covers [j*w, (j+1)*w)
    abs_hist = hist[mid:] + hist[:mid][::-1]
    abs_edges = hist_edges[mid:]
    nq = (num_quantized_bins + 1) // 2  # int8 symmetric: 128 magnitude bins
    if abs_hist.size <= nq:
        # fewer bins than quantized levels: clipping can only lose mass
        return float(abs_edges[-1]), 0.0
    best_th, best_kl = float(abs_edges[-1]), _np.inf
    total = abs_hist.sum()
    if total <= 0:
        return float(abs_edges[-1]), 0.0
    levels = _np.arange(nq)
    for i in range(nq, abs_hist.size + 1):
        p = abs_hist[:i].copy()
        p[-1] += abs_hist[i:].sum()  # outliers clip into the edge bin
        threshold = float(abs_edges[i])
        # project the i reference bins onto nq quantized levels: level j
        # merges bins [j * m, (j + 1) * m), the last one up to i, each
        # nonzero bin taking the level's mean over its nonzero bins. The
        # counts are integers, so the per-level sums are exact in any
        # order and equal the JAX package's loop over the levels.
        num_merged = i // nq
        ref = abs_hist[:i]
        nonzero = (ref != 0).astype(_np.float64)
        starts = levels * num_merged
        sums = _np.add.reduceat(ref, starts)
        norms = _np.add.reduceat(nonzero, starts)
        means = _np.where(norms > 0, sums / _np.maximum(norms, 1.0), 0.0)
        q = _np.repeat(means, _np.diff(_np.append(starts, i)))
        q[ref == 0] = 0.0
        ps = _smooth(p)
        qs = _smooth(q)
        if ps is None or qs is None:
            continue
        kl = _kl_divergence(ps, qs)
        if kl < best_kl:
            best_kl, best_th = kl, threshold
    return best_th, (0.0 if best_kl is _np.inf else best_kl)


class _HistogramCollector:
    """Per-tensor symmetric histogram accumulated across calib batches
    (parity: the reference collector's ``combine_histogram`` — constant
    bin width, range grown outward when a batch exceeds it)."""

    def __init__(self, num_bins=DEFAULT_NUM_BINS):
        self.num_bins = int(num_bins)
        self.state = {}  # name -> (hist, hist_edges, min, max, th)

    def collect(self, name, arr):
        a = arr.reshape(-1)
        new_min = float(a.min()) if a.size else 0.0
        new_max = float(a.max()) if a.size else 0.0
        new_th = max(abs(new_min), abs(new_max), 1e-8)
        st = self.state.get(name)
        if st is None:
            hist, edges = _np.histogram(a, bins=self.num_bins,
                                        range=(-new_th, new_th))
            self.state[name] = (hist.astype(_np.int64), edges,
                                new_min, new_max, new_th)
            return
        hist, edges, old_min, old_max, old_th = st
        if new_th <= old_th:
            add, _ = _np.histogram(a, bins=hist.size, range=(-old_th, old_th))
            self.state[name] = (hist + add, edges,
                                min(old_min, new_min), max(old_max, new_max),
                                old_th)
            return
        # grow outward keeping the bin width: the old histogram drops
        # unchanged into the middle of the widened one
        old_step = 2.0 * old_th / hist.size
        half_inc = int((new_th - old_th) // old_step + 1)
        # keep the bin count even so the KL fold stays exact
        grown_bins = hist.size + 2 * half_inc
        grown_th = half_inc * old_step + old_th
        add, new_edges = _np.histogram(a, bins=grown_bins,
                                       range=(-grown_th, grown_th))
        add = add.astype(_np.int64)
        add[half_inc:grown_bins - half_inc] += hist
        self.state[name] = (add, new_edges,
                            min(old_min, new_min), max(old_max, new_max),
                            grown_th)

    def thresholds(self, num_quantized_bins=DEFAULT_NUM_QUANTIZED_BINS):
        """{name: (threshold, kl, min_seen, max_seen, bins)} per tensor."""
        out = {}
        for name, (hist, edges, mn, mx, _th) in self.state.items():
            th, kl = kl_optimal_threshold(
                hist, edges, num_quantized_bins=num_quantized_bins)
            out[name] = (th, kl, mn, mx, hist.size)
        return out


# ----------------------------------------------------------- calibration ---

# ----------------------------------------------------------- calibration ---

def _output_entry_name(node, oi):
    if node.is_var:
        return node.name
    return f"{node.name}_output" if node.num_outputs == 1 \
        else f"{node.name}_output{oi}"


def _collect_ranges(sym, arg_params, aux_params, calib_data, data_names,
                    num_calib_examples, calib_mode,
                    num_bins=DEFAULT_NUM_BINS, label_names=()):
    """Phase 1: ``(ranges, out_ranges)``. ``ranges`` maps each
    quantizable node to the calibrated ``(min, max)`` of its data input
    (by ``calib_mode``); ``out_ranges`` to the observed min and max of its
    own output."""
    global _LAST_CALIB
    from ..symbol.symbol import _topo

    internals = sym.get_internals()
    out_names = internals.list_outputs()
    watch = {}      # output name -> [quantizable nodes reading it as data]
    out_watch = {}  # output name -> the quantizable node producing it
    for node in _topo(sym._entries):
        if node.op in _QUANTIZABLE:
            src, oi = node.inputs[0]
            watch.setdefault(_output_entry_name(src, oi), []).append(
                node.name)
            out_watch[_output_entry_name(node, 0)] = node.name
    ranges, out_ranges = {}, {}
    hists = _HistogramCollector(num_bins) if calib_mode == "entropy" else None
    seen = batches = 0

    def merge(table, key, lo, hi):
        if key in table:
            plo, phi = table[key]
            table[key] = (min(plo, lo), max(phi, hi))
        else:
            table[key] = (lo, hi)

    calib_data.reset()  # a freshly fitted iterator arrives exhausted
    for batch in calib_data:
        feed = dict(zip(data_names, batch.data))
        if label_names and getattr(batch, "label", None):
            feed.update(zip(label_names, batch.label))
        feed.update(arg_params)
        feed.update(aux_params)
        with torch.no_grad():
            outs = internals.eval_with(feed)
        for oname, arr in zip(out_names, outs):
            watched = oname in watch
            if not watched and oname not in out_watch:
                continue
            # min and max of a float32 tensor are exact on the device
            lo, hi = (float(v) for v in torch.aminmax(arr._data.reshape(-1)))
            if watched:
                if calib_mode == "naive":
                    for consumer in watch[oname]:
                        merge(ranges, consumer, lo, hi)
                else:  # host numpy, as the JAX package
                    a = arr.asnumpy().astype(_np.float64)
                    if calib_mode == "entropy":
                        hists.collect(oname, a)
                    else:
                        plo = float(_np.percentile(a, 0.01))
                        phi = float(_np.percentile(a, 99.99))
                        for consumer in watch[oname]:
                            merge(ranges, consumer, plo, phi)
            if oname in out_watch:
                merge(out_ranges, out_watch[oname], lo, hi)
        seen += batch.data[0].shape[0]
        batches += 1
        if num_calib_examples is not None and seen >= num_calib_examples:
            break
    calib_data.reset()
    if watch and not seen:
        raise ValueError(
            "calibration saw no examples (empty calib_data); the "
            "quantize pass would silently skip every node")
    tensors = {}
    if calib_mode == "entropy":
        for oname, (th, kl, mn, mx, bins) in hists.thresholds().items():
            for consumer in watch[oname]:
                ranges[consumer] = (-th, th)
            tensors[oname] = {"threshold": round(th, 6),
                              "kl_divergence": round(kl, 6),
                              "min_seen": round(mn, 6),
                              "max_seen": round(mx, 6), "bins": bins}
    else:
        for oname, consumers in watch.items():
            for c in consumers:
                if c in ranges:
                    lo, hi = ranges[c]
                    tensors[oname] = {"min": round(lo, 6),
                                      "max": round(hi, 6)}
    _LAST_CALIB = {"mode": calib_mode, "num_bins": num_bins,
                   "examples": seen, "batches": batches,
                   "tensors": tensors}
    return ranges, out_ranges


# ------------------------------------------------------------- graph pass ---

def quantize_graph(sym, excluded_sym_names=(), ranges=None, out_ranges=None,
                   quantize_granularity="channel-wise"):
    """Phase 2: graph surgery. Returns ``(qsym, qspecs)``; ``qspecs`` maps
    each quantized weight variable to its granularity (``"channel"`` /
    ``"tensor"``, or ``"embedding"`` for int8 tables)."""
    global _LAST_PASS
    from ..symbol.symbol import Symbol, _Node, _topo

    if quantize_granularity not in ("channel-wise", "tensor-wise"):
        raise ValueError("quantize_granularity must be 'channel-wise' or "
                         f"'tensor-wise', got {quantize_granularity!r}")
    ranges = ranges or {}
    out_ranges = out_ranges or {}
    excluded = set(excluded_sym_names or ())
    mapping = {}  # id(old node) -> new node
    qspecs, op_census = {}, {}
    kind = "channel" if quantize_granularity == "channel-wise" else "tensor"
    for node in _topo(sym._entries):
        new_inputs = [(mapping[id(c)], oi) for c, oi in node.inputs]
        if node.op in _QUANTIZABLE and node.name not in excluded \
                and node.name in ranges and len(node.inputs) >= 2 \
                and node.inputs[1][0].is_var:
            lo, hi = ranges[node.name]
            qop = _QUANTIZABLE[node.op]
            attrs = dict(node.attrs)
            attrs["min_calib_range"] = lo
            attrs["max_calib_range"] = hi
            if node.name in out_ranges:
                attrs["min_out_calib_range"] = out_ranges[node.name][0]
                attrs["max_out_calib_range"] = out_ranges[node.name][1]
            # new variables named after the ORIGINAL weight variable, so
            # the params line up whatever the node is called
            wname = node.inputs[1][0].name
            ins = [new_inputs[0], (_Node(None, wname + "_quantize"), 0),
                   (_Node(None, wname + "_scale"), 0)]
            if len(new_inputs) > 2:  # bias
                ins.append(new_inputs[2])
            new = _Node(qop, node.name, attrs, ins,
                        num_outputs=node.num_outputs)
            qspecs[wname] = kind
            op_census[qop] = op_census.get(qop, 0) + 1
        elif node.op == "Embedding" and node.name not in excluded \
                and len(node.inputs) >= 2 and node.inputs[1][0].is_var:
            # weight-only int8: the gather reads the int8 table, the
            # dequantize follows; ids need no activation calibration
            wname = node.inputs[1][0].name
            attrs = {k: v for k, v in node.attrs.items()
                     if k in ("input_dim", "output_dim")}
            qe = _Node("_contrib_quantized_embedding", node.name, attrs,
                       [new_inputs[0], (_Node(None, wname + "_quantize"), 0),
                        (_Node(None, wname + "_min"), 0),
                        (_Node(None, wname + "_max"), 0)], num_outputs=3)
            new = _Node("_contrib_dequantize", node.name + "_dequantize",
                        {}, [(qe, 0), (qe, 1), (qe, 2)])
            qspecs[wname] = "embedding"
            op_census["_contrib_quantized_embedding"] = \
                op_census.get("_contrib_quantized_embedding", 0) + 1
        else:
            new = _Node(node.op, node.name, dict(node.attrs), new_inputs,
                        num_outputs=node.num_outputs)
        mapping[id(node)] = new
    _LAST_PASS = {
        "granularity": quantize_granularity,
        "weights": dict(qspecs),
        "per_channel": sum(1 for k in qspecs.values() if k == "channel"),
        "per_tensor": sum(1 for k in qspecs.values()
                          if k in ("tensor", "embedding")),
        "ops": op_census,
    }
    return Symbol([(mapping[id(n)], i) for n, i in sym._entries]), qspecs


# ---------------------------------------------------------------- params ---

def _quantize_params(arg_params, qspecs):
    """Phase 3: symmetric int8 weights and float32 scales (host numpy,
    as the JAX package), each on the context of its float weight."""
    from ..ndarray import array

    if not isinstance(qspecs, dict):  # bare name iterable: channel-wise
        qspecs = {n: "channel" for n in qspecs}
    qargs = {}
    for name, arr in arg_params.items():
        kind = qspecs.get(name)
        if kind is None:
            qargs[name] = arr
            continue
        ctx = arr.context
        w = arr.asnumpy()
        if kind == "embedding":
            absmax = float(_np.abs(w).max())
            absmax = absmax if absmax > 0 else 1.0
            scale = absmax / 127.0
            q = _np.clip(_np.round(w / scale), -127, 127).astype(_np.int8)
            qargs[name + "_quantize"] = array(q, ctx=ctx)
            qargs[name + "_min"] = array(_np.asarray([-absmax], _np.float32),
                                         ctx=ctx)
            qargs[name + "_max"] = array(_np.asarray([absmax], _np.float32),
                                         ctx=ctx)
            continue
        flat = w.reshape(w.shape[0], -1)
        if kind == "tensor":
            absmax = _np.asarray([_np.abs(flat).max()])
        else:  # channel
            absmax = _np.abs(flat).max(axis=1)
        scale = _np.where(absmax > 0, absmax / 127.0, 1.0) \
            .astype(_np.float32)
        q = _np.clip(_np.round(flat / scale[:, None] if kind == "channel"
                               else flat / scale), -127, 127) \
            .astype(_np.int8).reshape(w.shape)
        qargs[name + "_quantize"] = array(q, ctx=ctx)
        qargs[name + "_scale"] = array(scale, ctx=ctx)
    return qargs


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   label_names=("softmax_label",), ctx=None,
                   excluded_sym_names=None, calib_mode="naive",
                   calib_data=None, num_calib_examples=None,
                   quantized_dtype="int8", logger=None,
                   quantize_granularity="channel-wise",
                   calib_bins=DEFAULT_NUM_BINS):
    """Calibrate on ``calib_data``, rewrite the graph and quantize the
    weights. Returns ``(qsym, qarg_params, aux_params)``. Calibration
    runs where ``arg_params`` and ``calib_data``'s batches live; ``ctx``
    and ``logger`` are accepted for the MXNet signature."""
    if quantized_dtype not in ("int8", "auto"):
        raise ValueError("only int8 symmetric quantization is supported")
    if calib_mode not in ("naive", "entropy", "percentile"):
        raise ValueError(f"calib_mode must be naive|entropy|percentile, "
                         f"got {calib_mode!r}")
    if calib_data is None:
        raise ValueError("calib_data is required (the activation ranges "
                         "become attributes of the quantized graph)")
    ranges, out_ranges = _collect_ranges(
        sym, arg_params, aux_params, calib_data, list(data_names),
        num_calib_examples, calib_mode, num_bins=calib_bins,
        label_names=list(label_names or ()))
    qsym, qspecs = quantize_graph(
        sym, excluded_sym_names or (), ranges, out_ranges,
        quantize_granularity=quantize_granularity)
    return qsym, _quantize_params(arg_params, qspecs), dict(aux_params)


def quantize_net(network, calib_data, data_shape=None, calib_mode="naive",
                 num_calib_examples=None, excluded_layers=None, ctx=None,
                 logger=None, quantize_granularity="channel-wise"):
    """Quantize a HybridBlock: ``export`` -> ``load_checkpoint`` ->
    :func:`quantize_model` -> ``save_checkpoint`` ->
    ``SymbolBlock.imports``. Everything runs on ``ctx`` (default: the
    current context, the card): the calibration batches, the float graph
    and the returned block's parameters."""
    from .. import io, model, nd
    from ..context import current_context
    from ..gluon import SymbolBlock

    with ctx or current_context():
        if not isinstance(calib_data, io.DataIter):
            calib_data = io.NDArrayIter(calib_data, batch_size=min(
                32, calib_data.shape[0]), label_name=None)
        first = calib_data.provide_data[0]
        network(nd.zeros(first.shape))  # materialize deferred params
        with tempfile.TemporaryDirectory() as d:
            prefix = d + "/net"
            network.export(prefix, 0)
            sym, args, auxs = model.load_checkpoint(prefix, 0)
            qsym, qargs, auxs = quantize_model(
                sym, args, auxs, data_names=(first.name,),
                calib_data=calib_data, calib_mode=calib_mode,
                num_calib_examples=num_calib_examples,
                excluded_sym_names=excluded_layers,
                quantize_granularity=quantize_granularity)
            # round-trip through the checkpoint format, as the JAX package
            model.save_checkpoint(prefix + "-q", 0, qsym, qargs, auxs)
            return SymbolBlock.imports(prefix + "-q-symbol.json",
                                       [first.name],
                                       prefix + "-q-0000.params", ctx=ctx)
