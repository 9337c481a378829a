"""Graph IR for the accelerator performance model.

TPU-native rebuild of the DNNWeaver2 layer the reference simulator sits on
(ant_simulator/dnnweaver2/: graph.py:18-255, tensor.py:5-59,
scalar/dtypes.py:1-74, tensorOps/cnn.py): a small, functional graph of
tensors + ops with per-tensor fixed-point/float dtypes. Only Convolution
and MatMul nodes carry cost (the reference simulator dispatches exactly
those two, simulator.py:493-521); pooling/eltwise/norm ops exist so whole
benchmark networks can be expressed, and are skipped by the cost model.

The IR lowers to the cycle model via ``to_layer_specs`` (ConvSpec /
MatMulSpec consumed by perfmodel.simulator) — precision comes from the
tensor dtypes, mirroring how dnnweaver2 tensors carried FQDtype entries
into bitfusion's precision perf factor.

The port's copy of the reference's ``perfmodel/graph.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from .simulator import ConvSpec, MatMulSpec

__all__ = ["Dtype", "FixedPoint", "Float", "CustomFloat", "Log", "Binary",
           "FQDtype", "Tensor", "Op", "Graph", "get_default_graph",
           "conv2D", "matmul", "maxPool", "avgPool", "flatten",
           "batch_norm", "relu", "add", "concat", "to_layer_specs"]


# ---------------------------------------------------------------------------
# dtypes (dnnweaver2/scalar/dtypes.py equivalents)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Dtype:
    bits: int

    def __str__(self):
        return f"{type(self).__name__}{self.bits}"


@dataclasses.dataclass(frozen=True)
class FixedPoint(Dtype):
    frac: int = 0

    def __str__(self):
        return f"FXP{self.bits}"

    @property
    def int_bits(self) -> int:
        return self.bits - self.frac


@dataclasses.dataclass(frozen=True)
class Float(Dtype):
    def __str__(self):
        return f"FP{self.bits}"


@dataclasses.dataclass(frozen=True)
class CustomFloat(Dtype):
    exp: int = 5

    def __str__(self):
        return f"CFP{self.bits}e{self.exp}"


@dataclasses.dataclass(frozen=True)
class Log(Dtype):
    def __str__(self):
        return f"LOG{self.bits}"


@dataclasses.dataclass(frozen=True)
class Binary(Dtype):
    def __init__(self):
        object.__setattr__(self, "bits", 1)

    def __str__(self):
        return "BIN"


class FQDtype:
    """Preset registry (dnnweaver2 FQDtype)."""
    BIN = Binary()
    FXP2 = FixedPoint(2, 0)
    FXP4 = FixedPoint(4, 0)
    FXP6 = FixedPoint(6, 0)
    FXP8 = FixedPoint(8, 0)
    FXP16 = FixedPoint(16, 8)
    FXP32 = FixedPoint(32, 16)
    FP16 = Float(16)
    FP32 = Float(32)
    Log8 = Log(8)

    @staticmethod
    def fxp(bits: int) -> FixedPoint:
        return FixedPoint(bits, 0)


# ---------------------------------------------------------------------------
# tensors, ops, graph
# ---------------------------------------------------------------------------

class Tensor:
    """Shape + dtype bookkeeping (dnnweaver2/tensor.py:5-59)."""

    def __init__(self, shape: Sequence[int], name: str = "",
                 dtype: Dtype = FQDtype.FXP8, op: Optional["Op"] = None):
        self.shape = tuple(int(s) for s in shape)
        self.name = name
        self.dtype = dtype
        self.op = op            # producing op (None for graph inputs)

    @property
    def size(self) -> int:
        return math.prod(self.shape) if self.shape else 1

    @property
    def size_in_bits(self) -> int:
        return self.size * self.dtype.bits

    @property
    def size_in_bytes(self) -> int:
        return -(-self.size_in_bits // 8)

    def __repr__(self):
        return f"Tensor({self.name!r}, {self.shape}, {self.dtype})"


class Op:
    def __init__(self, kind: str, name: str, inputs: List[Tensor],
                 attrs: Optional[dict] = None):
        self.kind = kind
        self.name = name
        self.inputs = list(inputs)
        self.attrs = dict(attrs or {})
        self.output: Optional[Tensor] = None

    def __repr__(self):
        return f"Op({self.kind}:{self.name})"


_GRAPH_STACK: List["Graph"] = []


class Graph:
    """Op/tensor registry with name scopes and a default-graph stack
    (dnnweaver2/graph.py:18-255)."""

    def __init__(self, name: str = "graph"):
        self.name = name
        self.ops: "dict[str, Op]" = {}
        self.tensors: "dict[str, Tensor]" = {}
        self._scopes: List[str] = []

    # -- context management --------------------------------------------------
    def __enter__(self):
        _GRAPH_STACK.append(self)
        return self

    def __exit__(self, *exc):
        _GRAPH_STACK.pop()
        return False

    @contextlib.contextmanager
    def name_scope(self, scope: str):
        self._scopes.append(scope)
        try:
            yield self
        finally:
            self._scopes.pop()

    def _qualify(self, name: str) -> str:
        base = "/".join(self._scopes + [name]) if self._scopes else name
        q, i = base, 0
        while q in self.ops or q in self.tensors:
            i += 1
            q = f"{base}_{i}"
        return q

    # -- construction ---------------------------------------------------------
    def tensor(self, shape: Sequence[int], name: str = "t",
               dtype: Dtype = FQDtype.FXP8) -> Tensor:
        t = Tensor(shape, self._qualify(name), dtype)
        self.tensors[t.name] = t
        return t

    def add_op(self, kind: str, name: str, inputs: List[Tensor],
               out_shape: Sequence[int], out_dtype: Dtype,
               attrs: Optional[dict] = None) -> Tensor:
        op = Op(kind, self._qualify(name), inputs, attrs)
        self.ops[op.name] = op
        out = Tensor(out_shape, op.name + ":0", out_dtype, op=op)
        op.output = out
        self.tensors[out.name] = out
        return out


def get_default_graph() -> Graph:
    if not _GRAPH_STACK:
        _GRAPH_STACK.append(Graph("default"))
    return _GRAPH_STACK[-1]


# ---------------------------------------------------------------------------
# op constructors (dnnweaver2/tensorOps/cnn.py; shapes are NHWC)
# ---------------------------------------------------------------------------

def conv2D(x: Tensor, weights: Tensor, bias: Optional[Tensor] = None,
           stride: int = 1, pad: str | int = "SAME",
           out_dtype: Optional[Dtype] = None, name: str = "conv") -> Tensor:
    """weights (K, K, IC, OC); x (N, H, W, IC) -> (N, O, O, OC)."""
    g = get_default_graph()
    n, h, w, ic = x.shape
    k = weights.shape[0]
    assert weights.shape[2] == ic, (weights.shape, x.shape)
    oc = weights.shape[3]
    if pad == "SAME":
        o = -(-h // stride)
        padding = max(0, (o - 1) * stride + k - h) // 2
    else:
        padding = int(pad)
        o = (h - k + 2 * padding) // stride + 1
    inputs = [x, weights] + ([bias] if bias is not None else [])
    return g.add_op("Convolution", name, inputs, (n, o, o, oc),
                    out_dtype or x.dtype,
                    {"stride": stride, "pad": padding})


def matmul(x: Tensor, weights: Tensor, bias: Optional[Tensor] = None,
           out_dtype: Optional[Dtype] = None, name: str = "matmul") -> Tensor:
    """weights (NI, NO); x (..., NI) -> (..., NO)."""
    g = get_default_graph()
    ni, no = weights.shape
    assert x.shape[-1] == ni, (x.shape, weights.shape)
    inputs = [x, weights] + ([bias] if bias is not None else [])
    return g.add_op("MatMul", name, inputs, x.shape[:-1] + (no,),
                    out_dtype or x.dtype)


def _pool(kind, x, k, stride, name):
    g = get_default_graph()
    n, h, w, c = x.shape
    o = (h - k) // stride + 1
    return g.add_op(kind, name, [x], (n, o, o, c), x.dtype,
                    {"k": k, "stride": stride})


def maxPool(x: Tensor, k: int = 2, stride: int = 2,
            name: str = "maxpool") -> Tensor:
    return _pool("MaxPool", x, k, stride, name)


def avgPool(x: Tensor, k: int = 2, stride: int = 2,
            name: str = "avgpool") -> Tensor:
    return _pool("AvgPool", x, k, stride, name)


def flatten(x: Tensor, name: str = "flatten") -> Tensor:
    g = get_default_graph()
    return g.add_op("Flatten", name, [x],
                    (x.shape[0], math.prod(x.shape[1:])), x.dtype)


def batch_norm(x: Tensor, name: str = "bn") -> Tensor:
    g = get_default_graph()
    return g.add_op("BatchNorm", name, [x], x.shape, x.dtype)


def relu(x: Tensor, name: str = "relu") -> Tensor:
    g = get_default_graph()
    return g.add_op("ReLU", name, [x], x.shape, x.dtype)


def add(a: Tensor, b: Tensor, name: str = "add") -> Tensor:
    g = get_default_graph()
    assert a.shape == b.shape
    return g.add_op("Add", name, [a, b], a.shape, a.dtype)


def concat(tensors: Sequence[Tensor], axis: int = -1,
           name: str = "concat") -> Tensor:
    g = get_default_graph()
    shape = list(tensors[0].shape)
    shape[axis] = sum(t.shape[axis] for t in tensors)
    return g.add_op("Concat", name, list(tensors), tuple(shape),
                    tensors[0].dtype)


# ---------------------------------------------------------------------------
# lowering to the cycle model
# ---------------------------------------------------------------------------

def to_layer_specs(graph: Graph) -> List[ConvSpec | MatMulSpec]:
    """Convolution/MatMul nodes -> simulator layer specs; everything else
    is free (simulator.py:493-521 dispatches only these two kinds).
    Precision = tensor dtype bits (input -> iprec, weights -> wprec)."""
    out: List[ConvSpec | MatMulSpec] = []
    for op in graph.ops.values():
        if op.kind == "Convolution":
            x, w = op.inputs[0], op.inputs[1]
            o = op.output.shape[1]
            out.append(ConvSpec(k=w.shape[0], out=o,
                                stride=op.attrs["stride"],
                                ic=x.shape[-1], oc=w.shape[-1],
                                iprec=x.dtype.bits, wprec=w.dtype.bits,
                                name=op.name))
        elif op.kind == "MatMul":
            x, w = op.inputs[0], op.inputs[1]
            rows = math.prod(x.shape[:-1]) // x.shape[0] \
                if len(x.shape) > 1 else 1
            out.append(MatMulSpec(ni=w.shape[0], no=w.shape[1],
                                  iprec=x.dtype.bits, wprec=w.dtype.bits,
                                  rows=max(1, rows), name=op.name))
    return out
