"""Analytic FLOP counting from an exported graph (convs and matmuls), port
of the JAX package's ``utils/flops.py``.

JAX walks a jaxpr; the port traces the call with ``torch.export`` and walks
its graph, reading each node's output and operand shapes from
``meta["val"]``. Counts are 2 * MACs: a convolution (``aten.convolution``
and the port's K1/K2 operators ``pmr::conv3d`` / ``pmr::conv3d_pair`` (two
outputs, counted together) / ``pmr::conv3d_transpose``, which the wrappers
call while exporting) costs 2 * output elements * input
channels * kernel taps, the count JAX gives ``conv_general_dilated`` (a
transposed conv included, whose lhs-dilated input JAX counts whole); a
matrix product (``mm``, ``bmm``, ``matmul``, ``linear``, ``addmm``,
``baddbmm``) 2 * output elements * k. A loop is counted as traced: the
port runs Python loops, so each iteration is in the graph. A detect head
that skips work JAX's traces (the port's skips the deep-supervision heads
and a probabilistic model's unused passes) counts less.
"""

from __future__ import annotations

import math

import torch

# matrix products: the operand whose last axis is contracted, by position
_MATMULS = {"aten.mm.default": 0, "aten.bmm.default": 0, "aten.matmul.default": 0,
            "aten.linear.default": 0, "aten.addmm.default": 1, "aten.baddbmm.default": 1}


def _shape(node):
    return tuple(int(d) for d in node.meta["val"].shape)


def _node_flops(node) -> int:
    name = str(node.target)
    if name in ("pmr.conv3d.default", "pmr.conv3d_pair.default"):
        parts, kernel = node.args[0], node.args[1]
        cin = sum(_shape(p)[-1] for p in parts)
        val = node.meta["val"]
        outs = val if isinstance(val, (list, tuple)) else [val]  # conv3d_pair: two
        return 2 * sum(math.prod(int(d) for d in o.shape) for o in outs) * cin * \
            math.prod(_shape(kernel)[:3])
    if name == "pmr.conv3d_transpose.default":
        x, kernel = node.args[0], node.args[1]
        return 2 * math.prod(_shape(node)) * _shape(x)[-1] * math.prod(_shape(kernel)[:3])
    if name == "aten.convolution.default":
        w, transposed, groups = _shape(node.args[1]), bool(node.args[6]), int(node.args[8])
        # input channels an output element reads: weight (out, in/g, ...), or
        # (in, out/g, ...) transposed
        cin = w[0] // groups if transposed else w[1]
        return 2 * math.prod(_shape(node)) * cin * math.prod(w[2:])
    if name in _MATMULS:  # every output element sums k products
        return 2 * math.prod(_shape(node)) * _shape(node.args[_MATMULS[name]])[-1]
    return 0


def _graph_flops(gm) -> int:
    total = 0
    for node in gm.graph.nodes:
        if node.op == "call_function":
            total += _node_flops(node)
    for sub in gm.children():  # higher-order ops' subgraphs
        if isinstance(sub, torch.fx.GraphModule):
            total += _graph_flops(sub)
    return total


class _Call(torch.nn.Module):
    def __init__(self, fn, kwargs):
        super().__init__()
        self.fn, self.kwargs = fn, kwargs

    def forward(self, *args):
        return self.fn(*args, **self.kwargs)


def count_matmul_flops(fn, *args, **kwargs) -> int:
    """Total conv + matmul FLOPs (2 * MACs) of one call of ``fn(*args)``,
    traced without autograd (tensors it closes over become constants)."""
    from torch.export import export

    with torch.no_grad():
        ep = export(_Call(fn, kwargs), tuple(args), strict=False)
    return _graph_flops(ep.graph_module)


def logical_io_bytes(*arrays) -> int:
    """Sum of array sizes in bytes (tensors or numpy arrays), for roofline
    IO estimates."""
    total = 0
    for a in arrays:
        itemsize = a.element_size() if torch.is_tensor(a) else a.dtype.itemsize
        total += math.prod(a.shape) * itemsize
    return total
