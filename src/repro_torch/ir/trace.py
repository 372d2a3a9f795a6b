"""``from_torch`` — trace a PyTorch CNN into :class:`~repro_torch.ir.graph_ir.GraphIR`.

The port's counterpart of the reference's ``from_jax``
(``repro/ir/trace.py``): the "bring your own workload" importer for code
instead of JSON.  Give it an ``nn.Module`` (or a plain function of tensors)
and example inputs; it traces the program with ``torch.fx.symbolic_trace``,
runs it once on the example inputs for the shapes, and maps the compute
ops onto the same :class:`repro_torch.core.graph.Layer` kinds as
``from_jax``:

    ========================================  ==============================
    PyTorch op                                Layer kind
    ========================================  ==============================
    conv2d, nn.Conv2d                         conv (dwconv when groups ==
                                              input channels)
    linear, nn.Linear, matmul, mm, ``@``      fc
    max/avg_pool2d, nn.MaxPool2d/AvgPool2d    pool (global_pool when the
                                              window covers the whole
                                              spatial extent)
    adaptive pooling to 1; mean/sum/amax/     global_pool
    amin over H, W
    add/sub/maximum/minimum (2 tensors)       add
    mul/div (2 tensors)                       mul
    cat                                       concat
    ========================================  ==============================

Everything elementwise or shape plumbing (activations, bias adds and
scalings with constants, batch norm, dropout, reshape/flatten/view/permute,
dtype casts) is *folded* into its producer, as ``from_jax`` folds them.
Nodes are named ``{base}_{uid}`` in program order with ``from_jax``'s
bases, so a module written op for op like a JAX function gives the same
canonical JSON and fingerprint.  Convolutions and pools take PyTorch's
NCHW operands; a ``permute`` to NHWC is followed, so reductions and concats
after it find their spatial and feature dims as ``from_jax`` does.

The walker is a CNN-shaped subset: batch size must be 1 (the paper's edge
setting) and an unsupported op raises :class:`TraceError` naming it.  A
program ``torch.fx`` cannot trace (data-dependent control flow) raises
:class:`TraceError` too.  The resulting IR runs through the import
pipeline (``repro_torch.ir.passes.canonicalize``).

Example::

    import torch
    import torch.nn.functional as F

    def cnn(x, w1, w2):
        y = F.relu(F.conv2d(x, w1, padding=1))
        y = F.max_pool2d(y, 2)
        return F.conv2d(y, w2, padding=1)

    ir = from_torch(cnn, (torch.zeros(1, 3, 32, 32),
                          torch.zeros(8, 3, 3, 3),
                          torch.zeros(16, 8, 3, 3)), name="tiny")
    graph = ir.build()            # ready for repro_torch.search
"""
from __future__ import annotations

import math
import operator
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.fx as fx
import torch.nn.functional as F
from torch import nn

from repro_torch.ir.graph_ir import GraphIR
from repro_torch.ir.passes import canonicalize


class TraceError(ValueError):
    """The traced program uses an op or shape outside the supported CNN
    subset; the message names it."""


# ---- the op tables ------------------------------------------------------------------

_CONV_FNS = (F.conv2d, torch.conv2d)
_LINEAR_FNS = (F.linear,)
_MATMUL_FNS = (operator.matmul, torch.matmul, torch.mm)
_POOL_FNS = (F.max_pool2d, torch.max_pool2d, F.avg_pool2d)
_ADAPTIVE_FNS = (F.adaptive_avg_pool2d, F.adaptive_max_pool2d)
_CAT_FNS = (torch.cat, torch.concat, torch.concatenate)
_ADD_FNS = (operator.add, operator.sub, torch.add, torch.sub,
            torch.maximum, torch.minimum)
_MUL_FNS = (operator.mul, operator.truediv, torch.mul, torch.div)
_REDUCE_FNS = (torch.mean, torch.sum, torch.amax, torch.amin)

#: functions folded into their producer (elementwise / shape plumbing)
_ALIAS_FNS = frozenset({
    F.relu, F.relu6, F.gelu, F.silu, F.mish, F.elu, F.leaky_relu,
    F.hardswish, F.hardsigmoid, F.hardtanh, F.sigmoid, F.tanh, F.softmax,
    F.batch_norm, F.dropout, torch.relu, torch.sigmoid, torch.tanh,
    torch.exp, torch.log, torch.abs, torch.neg, torch.sqrt, torch.rsqrt,
    torch.erf, torch.clamp, torch.softmax, torch.flatten, torch.reshape,
    torch.permute, torch.transpose, torch.squeeze, torch.unsqueeze,
    operator.neg,
})
_ADD_METHODS = frozenset({"add", "sub", "maximum", "minimum"})
_MUL_METHODS = frozenset({"mul", "div"})
_REDUCE_METHODS = frozenset({"mean", "sum", "amax", "amin"})
_ALIAS_METHODS = frozenset({
    "abs", "bfloat16", "clamp", "clamp_min", "clone", "contiguous",
    "detach", "double", "exp", "expand", "expand_as", "flatten", "float",
    "half", "neg", "permute", "relu", "reshape", "rsqrt", "sigmoid",
    "softmax", "sqrt", "squeeze", "tanh", "to", "transpose", "type",
    "type_as", "unsqueeze", "view", "view_as",
})
#: ops whose result is not a tensor (``x.size(0)``, ``x.shape[2]``):
#: constants
_META_OPS = frozenset({"dim", "numel", "size", "getattr", "getitem"})
_ALIAS_MODULES = (
    nn.ReLU, nn.ReLU6, nn.GELU, nn.SiLU, nn.Mish, nn.ELU, nn.LeakyReLU,
    nn.Hardswish, nn.Hardsigmoid, nn.Hardtanh, nn.Sigmoid, nn.Tanh,
    nn.Softmax, nn.BatchNorm2d, nn.Dropout, nn.Identity, nn.Flatten,
)


def _op_name(node: fx.Node, module: Optional[nn.Module]) -> str:
    if node.op == "call_module":
        return type(module.get_submodule(node.target)).__name__
    if node.op == "call_method":
        return str(node.target)
    return getattr(node.target, "__name__", str(node.target))


@dataclass
class _Val:
    """What the walker knows about one traced value."""
    node: Optional[str]          # producing IR node name; None = parameter
    chw: Tuple[int, int, int]    # logical activation shape (C, H, W)
    shape: Tuple[int, ...]       # raw tensor shape
    #: rank-4 dim order ("NCHW"/"NHWC"): convs and pools read NCHW; a
    #: permute moves the channel dim, and reductions/concats follow it
    layout: Optional[str] = None


def _pair(v: Any) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[-1]))
    return (int(v), int(v))


def _dims(dim: Any, rank: int) -> Tuple[int, ...]:
    """Reduction dims, normalised to 0..rank-1 (None: all of them)."""
    if dim is None:
        return tuple(range(rank))
    if isinstance(dim, int):
        dim = (dim,)
    return tuple(int(d) % rank for d in dim)


class _Walker(fx.Interpreter):
    """Runs the traced graph on the example inputs, mapping each node."""

    def __init__(self, gm: fx.GraphModule) -> None:
        super().__init__(gm)
        self.nodes: List[Dict[str, Any]] = []
        self._uid = 0
        self.vals: Dict[fx.Node, _Val] = {}

    # ---- node emission ---------------------------------------------------------
    def _emit(self, base: str, kind: str, inputs: List[str],
              **geom: Any) -> str:
        self._uid += 1
        name = f"{base}_{self._uid}"
        node: Dict[str, Any] = {"name": name, "kind": kind,
                                "inputs": inputs, **geom}
        self.nodes.append(node)
        return name

    def _chw_of_shape(self, shape: Tuple[int, ...]) -> Tuple[int, int, int]:
        if len(shape) == 4:
            if shape[0] != 1:
                raise TraceError(
                    f"activations must have batch size 1 (the paper's edge "
                    f"setting), got shape {shape}")
            return (shape[1], shape[2], shape[3])     # NCHW
        if len(shape) == 3:
            return (shape[0], shape[1], shape[2])
        if len(shape) == 2:
            if shape[0] != 1:
                raise TraceError(
                    f"2-d activations must be (1, features), got {shape}")
            return (shape[1], 1, 1)
        if len(shape) == 1:
            return (shape[0], 1, 1)
        raise TraceError(f"unsupported activation rank {len(shape)} "
                         f"(shape {shape})")

    def _as_data(self, val: _Val,
                 chw: Optional[Tuple[int, int, int]] = None) -> _Val:
        """Promote a parameter value to a traced activation: the model
        input becomes an ``input`` node on first data use."""
        if val.node is not None:
            return val
        c, h, w = chw if chw is not None else self._chw_of_shape(val.shape)
        node = self._emit("input", "input", [], m=c, p=h, q=w)
        val.node, val.chw = node, (c, h, w)
        return val

    # ---- value lookup ----------------------------------------------------------
    def _val(self, a: Any) -> _Val:
        """The walker's value of an argument: a traced node's, or a
        constant's (a Python scalar, a non-tensor node)."""
        if isinstance(a, fx.Node) and a in self.vals:
            return self.vals[a]
        shape = tuple(a.shape) if isinstance(a, torch.Tensor) else ()
        return _Val(None, (0, 0, 0), shape)

    @staticmethod
    def _arg(node: fx.Node, i: int, name: str, default: Any = None) -> Any:
        if len(node.args) > i:
            return node.args[i]
        return node.kwargs.get(name, default)

    def _const(self, a: Any) -> Any:
        """An argument's concrete value (a node's from the run)."""
        return self.env[a] if isinstance(a, fx.Node) else a

    # ---- dispatch --------------------------------------------------------------
    def run_node(self, n: fx.Node) -> Any:
        result = super().run_node(n)
        if n.op == "placeholder" or n.op == "get_attr":
            if isinstance(result, torch.Tensor):
                self.vals[n] = _Val(None, (0, 0, 0), tuple(result.shape))
        elif n.op in ("call_function", "call_method", "call_module"):
            self._node(n, result)
        return result

    def _node(self, n: fx.Node, out: Any) -> None:
        t, op = n.target, n.op
        tensor_in = any(a in self.vals for a in n.all_input_nodes)
        if not isinstance(out, torch.Tensor) and (
                not tensor_in or _op_name(n, self.module) in _META_OPS):
            return                       # shape arithmetic: a constant
        if isinstance(out, torch.Tensor) and not tensor_in:
            # a tensor made from no tensor (torch.zeros, torch.arange): a
            # constant, as a literal is in a jaxpr
            self.vals[n] = _Val(None, (0, 0, 0), tuple(out.shape))
            return
        oshape = tuple(out.shape) if isinstance(out, torch.Tensor) else ()
        if op == "call_module":
            return self._module(n, self.module.get_submodule(t), oshape)
        if op == "call_function":
            if t in _CONV_FNS:
                return self._conv(n, oshape, self._arg(n, 0, "input"),
                                  self._const(self._arg(n, 1, "weight")),
                                  self._arg(n, 3, "stride", 1),
                                  self._arg(n, 4, "padding", 0),
                                  self._arg(n, 5, "dilation", 1),
                                  self._arg(n, 6, "groups", 1))
            if t in _LINEAR_FNS:
                return self._linear(n, oshape, self._arg(n, 0, "input"))
            if t in _MATMUL_FNS:
                return self._matmul(n, oshape)
            if t in _POOL_FNS:
                k = self._arg(n, 1, "kernel_size")
                return self._pool(n, oshape, self._arg(n, 0, "input"), k,
                                  self._arg(n, 2, "stride") or k,
                                  self._arg(n, 3, "padding", 0))
            if t in _ADAPTIVE_FNS:
                return self._adaptive(n, oshape, self._arg(n, 0, "input"),
                                      self._arg(n, 1, "output_size"))
            if t in _REDUCE_FNS:
                return self._reduce(n, oshape, self._arg(n, 0, "input"),
                                    self._arg(n, 1, "dim"))
            if t in _ADD_FNS or t in _MUL_FNS:
                return self._binary(n, oshape,
                                    "add" if t in _ADD_FNS else "mul")
            if t in _CAT_FNS:
                return self._concat(n, oshape, self._arg(n, 0, "tensors"),
                                    self._arg(n, 1, "dim", 0))
            if t in _ALIAS_FNS:
                return self._alias(n, oshape)
        if op == "call_method":
            if t in _REDUCE_METHODS:
                return self._reduce(n, oshape, n.args[0],
                                    self._arg(n, 1, "dim"))
            if t in _ADD_METHODS or t in _MUL_METHODS:
                return self._binary(n, oshape,
                                    "add" if t in _ADD_METHODS else "mul")
            if t == "matmul":
                return self._matmul(n, oshape)
            if t in _ALIAS_METHODS:
                return self._alias(n, oshape)
        raise TraceError(
            f"unsupported op {_op_name(n, self.module)!r} in traced "
            f"program; the importer understands convolutions (conv2d), "
            f"matmuls (linear, matmul), pooling (max/avg_pool2d, adaptive "
            f"pooling to 1, mean/sum over H,W), elementwise add/mul, and "
            f"cat — write this op in those terms or author the workload as "
            f"GraphIR JSON")

    def _module(self, n: fx.Node, mod: nn.Module, oshape) -> None:
        x = n.args[0] if n.args else None
        if isinstance(mod, nn.Conv2d):
            return self._conv(n, oshape, x, mod.weight, mod.stride,
                              mod.padding, mod.dilation, mod.groups)
        if isinstance(mod, nn.Linear):
            return self._linear(n, oshape, x)
        if isinstance(mod, (nn.MaxPool2d, nn.AvgPool2d)):
            return self._pool(n, oshape, x, mod.kernel_size,
                              mod.stride or mod.kernel_size, mod.padding)
        if isinstance(mod, (nn.AdaptiveAvgPool2d, nn.AdaptiveMaxPool2d)):
            return self._adaptive(n, oshape, x, mod.output_size)
        if isinstance(mod, _ALIAS_MODULES):
            return self._alias(n, oshape)
        raise TraceError(
            f"unsupported module {type(mod).__name__!r} ({n.target}) in "
            f"traced program; write it in conv2d/linear/pooling/add/mul/cat "
            f"terms or author the workload as GraphIR JSON")

    # ---- op handlers -----------------------------------------------------------
    def _conv(self, n, oshape, x, weight, stride, padding, dilation,
              groups) -> None:
        lshape = tuple(self._const(x).shape)
        if len(lshape) != 4:
            raise TraceError(
                f"only 2-d convolutions are supported, got an input of "
                f"rank {len(lshape)}")
        if lshape[0] != 1:
            raise TraceError(f"conv batch size must be 1, got {lshape[0]}")
        c, h, w = lshape[1], lshape[2], lshape[3]
        lval = self._as_data(self._val(x), (c, h, w))
        assert lval.node is not None      # _as_data promoted it
        lval.layout = "NCHW"
        r, s = int(weight.shape[2]), int(weight.shape[3])
        dil = _pair(dilation)
        if isinstance(padding, str):
            # 'same': PyTorch pads (lo, hi) = (t // 2, t - t // 2) with t =
            # dilation * (k - 1); Layer.padding is symmetric, and max()
            # keeps the halo (as from_jax does for JAX's 'SAME')
            pad = (0, 0) if padding == "valid" else tuple(
                d * (k - 1) - d * (k - 1) // 2 for d, k in zip(dil, (r, s)))
        else:
            pad = _pair(padding)
        groups = int(groups)
        m, p, q = oshape[1], oshape[2], oshape[3]
        kind, base = ("dwconv", "dw") if groups == c and groups > 1 \
            else ("conv", "conv")
        node = self._emit(
            base, kind, [lval.node], c=c, h=h, w=w, m=m, p=p, q=q,
            r=r, s=s, stride=list(_pair(stride)), padding=list(pad),
            dilation=list(dil), groups=groups)
        self.vals[n] = _Val(node, (m, p, q), oshape, "NCHW")

    def _fc(self, n, oshape, data: _Val, cdim: int, nbat: int = 0) -> None:
        """An fc node over ``data``; the first ``nbat`` output dims are
        batch dims of a batched matmul and not features."""
        data = self._as_data(data)
        assert data.node is not None      # _as_data promoted it
        m = math.prod(oshape[nbat:]) if oshape else 1
        node = self._emit("fc", "fc", [data.node], c=cdim, h=1, w=1,
                          m=m, p=1, q=1)
        self.vals[n] = _Val(node, (m, 1, 1), oshape)

    def _linear(self, n, oshape, x) -> None:
        xs = tuple(self._const(x).shape)
        self._fc(n, oshape, self._val(x), xs[-1])

    def _matmul(self, n, oshape) -> None:
        a, b = n.args[0], n.args[1]
        lval, rval = self._val(a), self._val(b)
        if lval.node is not None and rval.node is not None:
            # both operands are traced activations: this is an attention/
            # bilinear product, not a weighted fc layer — an fc node would
            # keep only one branch and dead-eliminate the other silently
            raise TraceError(
                "matmul of two traced activations (activation x "
                "activation, e.g. attention) is not an fc layer this IR "
                "models; only activation x parameter matmuls trace")
        # the operand with a traced producer is the data; weights stay
        # parameters.  With neither traced yet, the left one is the data.
        ls, rs = tuple(self._const(a).shape), tuple(self._const(b).shape)
        nbat = len(oshape) - 2 if min(len(ls), len(rs)) >= 3 else 0
        if lval.node is None and rval.node is not None:
            self._fc(n, oshape, rval, rs[0] if len(rs) == 1 else rs[-2],
                     nbat)
        else:
            self._fc(n, oshape, lval, ls[-1], nbat)

    def _pool(self, n, oshape, x, kernel, stride, padding) -> None:
        val = self._val(x)
        r, s = _pair(kernel)
        if len(val.shape) != 4:
            raise TraceError(
                f"unsupported pooling over a rank-{len(val.shape)} input; "
                f"expected NCHW pooling")
        if (r, s) == (1, 1):
            if val.node is None:
                val = self._as_data(val)
            self.vals[n] = val                              # no window
            return
        if val.node is None:
            val = self._as_data(val)
            val.layout = "NCHW"
        assert val.node is not None
        c, h, w = val.chw
        p, q = oshape[2], oshape[3]
        if (r, s) == (h, w) and (p, q) == (1, 1):
            node = self._emit("gpool", "global_pool", [val.node],
                              c=c, h=h, w=w, m=c, p=1, q=1, r=h, s=w)
        else:
            node = self._emit(
                "pool", "pool", [val.node], c=c, h=h, w=w, m=c, p=p, q=q,
                r=r, s=s, stride=list(_pair(stride)),
                padding=list(_pair(padding)))
        self.vals[n] = _Val(node, (c, p, q), oshape, "NCHW")

    def _adaptive(self, n, oshape, x, output_size) -> None:
        if _pair(output_size) != (1, 1):
            raise TraceError(
                f"adaptive pooling to {output_size} is not a Layer this IR "
                f"models; only pooling to 1 (global pooling) traces")
        val = self._as_data(self._val(x))
        assert val.node is not None
        c, h, w = val.chw
        node = self._emit("gpool", "global_pool", [val.node],
                          c=c, h=h, w=w, m=c, p=1, q=1, r=h, s=w)
        self.vals[n] = _Val(node, (c, 1, 1), oshape, val.layout)

    def _reduce(self, n, oshape, x, dim) -> None:
        val = self._val(x)
        if val.node is None:              # reducing a parameter: constant
            self.vals[n] = _Val(None, (0, 0, 0), oshape)
            return
        axes = _dims(self._const(dim), len(val.shape))
        spatial = ({1, 2} if val.layout == "NHWC" else {2, 3}) \
            if len(val.shape) == 4 else set()
        if spatial and spatial.issubset(set(axes)):
            c, h, w = val.chw
            node = self._emit("gpool", "global_pool", [val.node],
                              c=c, h=h, w=w, m=c, p=1, q=1, r=h, s=w)
            self.vals[n] = _Val(node, (c, 1, 1), oshape)
            return
        if spatial & set(axes):
            # a partial spatial reduction (sum over H only) is real
            # compute with no Layer kind — folding it would silently
            # drop it and garble every downstream geometry
            raise TraceError(
                f"reduction over dims {axes} covers only part of the "
                f"spatial dims {sorted(spatial)}; only full global "
                f"pooling (both spatial dims) is supported")
        # softmax-style reductions along features: fold into the producer
        self.vals[n] = _Val(val.node, val.chw, oshape)

    def _binary(self, n, oshape, kind: str) -> None:
        a, b = (self._val(v) for v in n.args[:2])
        if a.node is not None and b.node is not None and a.node != b.node:
            # two distinct traced operands = a real merge layer, even when
            # one side broadcasts (squeeze-excite: y * se(y) with se shaped
            # (1,C,1,1)) — folding it would dead-eliminate the whole branch
            big = a if math.prod(a.shape or (1,)) >= \
                math.prod(b.shape or (1,)) else b
            c, h, w = big.chw
            node = self._emit(kind, kind, [a.node, b.node],
                              c=c, h=h, w=w, m=c, p=h, q=w)
            self.vals[n] = _Val(node, big.chw, oshape, big.layout)
            return
        # bias add / relu / scaling / x over its own reduction (softmax):
        # fold into the producer
        src = a if a.node is not None else b
        self.vals[n] = _Val(src.node, src.chw if src.node else (0, 0, 0),
                            oshape)

    def _concat(self, n, oshape, tensors: Sequence[Any], dim: int) -> None:
        traced = [self._val(v) for v in tensors]
        traced = [v for v in traced if v.node is not None]
        if not traced:
            self.vals[n] = _Val(None, (0, 0, 0), oshape)
            return
        dim = int(dim) % len(oshape)
        layout = next((v.layout for v in traced if v.layout), "NCHW")
        if len(oshape) == 4:
            feature_dim = 3 if layout == "NHWC" else 1
            if dim != feature_dim:
                raise TraceError(
                    f"only feature-dim concatenation is supported (got "
                    f"dim={dim} on a {layout} activation, feature dim "
                    f"{feature_dim}); spatial concat is not a CNN layer "
                    f"this cost model knows")
        _c, h, w = traced[0].chw
        ctot = oshape[dim]
        node = self._emit("cat", "concat", [v.node for v in traced],
                          c=ctot, h=h, w=w, m=ctot, p=h, q=w)
        self.vals[n] = _Val(node, (ctot, h, w), oshape,
                            layout if len(oshape) == 4 else None)

    def _alias(self, n, oshape) -> None:
        vals = [self._val(a) for a in n.all_input_nodes]
        src = next((v for v in vals if v.node is not None),
                   vals[0] if vals else None)
        if src is None:
            return
        chw = src.chw
        if src.node is not None and len(oshape) <= 2 \
                and oshape != src.shape:
            # flatten before a classifier head: (1, C, H, W) -> (1, CHW)
            chw = (math.prod(oshape) if oshape else 1, 1, 1)
        layout = src.layout if len(oshape) == 4 else None
        perm = self._permutation(n, len(src.shape))
        if perm is not None and layout is not None:
            cpos = perm.index(1 if layout == "NCHW" else 3)
            layout = {1: "NCHW", 3: "NHWC"}.get(cpos)
        self.vals[n] = _Val(src.node, chw, oshape, layout)

    def _permutation(self, n: fx.Node, rank: int) -> Optional[List[int]]:
        """The dim permutation of a ``permute``/``transpose`` node (None for
        any other alias)."""
        name = n.target if n.op == "call_method" else \
            getattr(n.target, "__name__", "")
        if name == "permute":
            dims = n.args[1:]
            if len(dims) == 1 and isinstance(dims[0], (tuple, list)):
                dims = dims[0]
            return [int(d) % rank for d in dims]
        if name == "transpose":
            d0, d1 = (int(d) % rank for d in n.args[1:3])
            perm = list(range(rank))
            perm[d0], perm[d1] = perm[d1], perm[d0]
            return perm
        return None


def _flat(out: Any) -> List[Any]:
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _flat(o)]
    if isinstance(out, dict):
        return [x for o in out.values() for x in _flat(o)]
    return [out]


def from_torch(module: Callable[..., Any], example_inputs: Tuple[Any, ...],
               *, name: str = "traced_cnn",
               canonical: bool = True) -> GraphIR:
    """Trace ``module(*example_inputs)`` into a (by default canonicalized)
    :class:`GraphIR`.

    ``module`` is an ``nn.Module`` or a function of tensors; weights may be
    the module's parameters or arguments, as in ``from_jax``.
    ``example_inputs`` supply shapes (zeros work); the program runs once on
    them, on their device.  Raises :class:`TraceError` when the program
    strays outside the supported CNN op subset or ``torch.fx`` cannot trace
    it."""
    try:
        gm = fx.symbolic_trace(module)
    except Exception as e:       # fx raises many types on untraceable code
        raise TraceError(f"torch.fx cannot trace {name!r}: "
                         f"{type(e).__name__}: {e}") from e
    walker = _Walker(gm)
    with torch.no_grad():
        walker.run(*example_inputs)
    out_node = next(n for n in gm.graph.nodes if n.op == "output")
    outputs: List[str] = []
    for a in _flat(out_node.args[0]):
        val = walker.vals.get(a) if isinstance(a, fx.Node) else None
        if val is None or val.node is None:
            raise TraceError(
                "a model output does not depend on any traced layer — "
                "is the program returning a constant?")
        if val.node not in outputs:
            outputs.append(val.node)
    ir = GraphIR(name=name, nodes=walker.nodes, outputs=outputs)
    return canonicalize(ir) if canonical else ir
