"""Network visualization: ``print_summary`` and ``plot_network``.

Counterpart of ``mxnet_tpu/visualization.py`` (MXNet 1.x
``python/mxnet/visualization.py``). ``print_summary`` prints the
per-layer table (name and op, output shape, parameter count, previous
layers) and the total, the same text as the JAX package's for the same
graph and shapes; ``plot_network`` builds a graphviz ``Digraph`` when
the optional ``graphviz`` package is installed, and raises
``ImportError`` otherwise.
"""
from __future__ import annotations

import math

__all__ = ["print_summary", "plot_network"]


def print_summary(symbol, shape=None, line_length=120,
                  positions=(.44, .64, .74, 1.)):
    """Print the summary table of ``symbol``; ``shape`` maps input names
    to shapes, from which each layer's output shape and parameter count
    follow. Returns the total parameter count."""
    from .symbol.symbol import _topo

    shape_dict = {}
    if shape is not None:
        internals = symbol.get_internals()
        _, out_shapes, _ = internals.infer_shape(**shape)
        # every node's outputs, variables (by their names) included
        shape_dict = dict(zip(internals.list_outputs(), out_shapes))

    positions = [int(line_length * p) for p in positions]
    headers = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]

    def print_row(fields, pos):
        line = ""
        for field, p in zip(fields, pos):
            line += str(field)
            line = line[:p - 1] + " " * max(1, p - len(line))
        print(line)

    print("_" * line_length)
    print_row(headers, positions)
    print("=" * line_length)
    input_names = set(symbol.list_arguments()) | \
        set(symbol.list_auxiliary_states())
    total_params = 0
    for node in _topo(symbol._entries):
        if node.is_var:
            continue
        name = node.name
        out_name = name + "_output" if node.num_outputs == 1 \
            else name + "_output0"
        out_shape = shape_dict.get(out_name, "")
        cur_params = 0
        pre_layers = []
        for child, _ in node.inputs:
            if child.is_var:
                # a declared input and a label are data, not parameters,
                # even when their names start with the layer's
                is_data = child.name in (shape or {}) or \
                    child.name.endswith("_label")
                if not is_data and child.name.startswith(name):
                    if shape_dict.get(child.name):
                        cur_params += math.prod(shape_dict[child.name])
                elif child.name in input_names:
                    pre_layers.append(child.name)
            else:
                pre_layers.append(child.name)
        total_params += cur_params
        fields = [f"{name}({node.op})",
                  str(tuple(out_shape)) if out_shape != "" else "",
                  cur_params, ",".join(pre_layers[:3])]
        print_row(fields, positions)
        print("_" * line_length)
    print(f"Total params: {total_params}")
    print("_" * line_length)
    return total_params


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 dtype=None, node_attrs=None, hide_weights=True):
    """A graphviz ``Digraph`` of the network (needs ``graphviz``)."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise ImportError("Draw network requires graphviz library") \
            from None
    from .symbol.symbol import _topo

    node_attr = {"shape": "box", "fixedsize": "true", "width": "1.3",
                 "height": "0.8034", "style": "filled"}
    node_attr.update(node_attrs or {})
    dot = Digraph(name=title, format=save_format)
    order = _topo(symbol._entries)
    palette = {"Convolution": "#fb8072", "FullyConnected": "#fb8072",
               "BatchNorm": "#bebada", "Activation": "#ffffb3",
               "Pooling": "#80b1d3", "Concat": "#fdb462",
               "softmax": "#fccde5"}
    names = set()
    first_arg = symbol.list_arguments()[:1]
    for node in order:
        if node.is_var and hide_weights and node.name not in first_arg:
            if node.attrs.get("__is_aux__") or any(
                    node.name.endswith(s)
                    for s in ("weight", "bias", "gamma", "beta",
                              "moving_mean", "moving_var")):
                continue
        color = palette.get(node.op or "", "#8dd3c7")
        label = node.name if node.is_var else f"{node.op}\n{node.name}"
        dot.node(node.name, label=label, fillcolor=color, **node_attr)
        names.add(node.name)
    for node in order:
        if node.name not in names:
            continue
        for child, _ in node.inputs:
            if child.name in names:
                dot.edge(child.name, node.name)
    return dot
