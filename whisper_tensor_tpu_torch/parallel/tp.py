"""Tensor parallelism: each rank's step or training graph, weights and
caches.

The port's own pass behind `TextInferenceInterface(mesh=, shard_rules=)`
and, in its training mode, `LMTrainer(mesh=, rules=)`.
In the JAX package GSPMD keeps every array at its global shape and
inserts the collectives; eager PyTorch has no such compiler, so each
rank runs the step graph at its LOCAL shapes, with the collectives
written into the graph. `shard_graph` takes the global milli graph
(after int8 quantization or packing, never fused: the reference keeps
matmul fusion off under a mesh, text.py:318-322), the mesh and the
shard rules (parallel/mesh.py), and returns a TpPlan: the rank's graph,
which weight inputs are cut along which dimension, and the caches' local
head counts.

How a placement moves through the graph. Each tensor is replicated,
split along one dimension over `tp` (with `sections`: a dimension made
of several concatenated parts, each split on its own), or partial (each
rank holds a term of a sum). Weights start from their rules: a
column-parallel (None, "tp") product yields its output split along the
last dimension, a row-parallel ("tp", None) product of a split
activation yields partial sums, and a partial tensor is summed
(AllReduce) where something other than a linear op reads it, so a bias
is added once, after the sum. A vocab-parallel embedding becomes a
masked lookup of the rank's rows (VocabGather, partial); a split graph
output (the logits of a column-parallel head) is gathered (AllGather).
Shapes come from the graph's own shape inference (`infer_all`), so a
Reshape's head count becomes the local one (Hq/tp, Hkv/tp) where the
reshape keeps the split dimension leading.

  * Fused q/k/v. A product whose output is Split into q, k and v (GPT-2's
    wqkv_i (E, 3E) and bqkv_i) is cut in sections: each rank holds its
    heads' columns of q, of k and of v, as pipeline_trainer.py:105
    interleave_qkv lays them out, so the local Split still yields q, k,
    v.
  * KV caches split heads over tp only when tp divides the head count
    (the reference's _cache_sharding, text.py:635-643); otherwise the
    cache and the k/v projections that write it stay replicated, and
    each rank's attention takes the cache heads its query heads read
    (KVHeads).
  * int8: a column shard slices the per-column `::scale` with its
    columns; a row shard keeps the whole scale, so the scaled partial
    sums add up.
  * Packed weights: column shards cut q, scales and offsets by columns.
    A row shard is a shard of the LOGICAL rows: the 4-bit layout packs
    row k low and row k + K/2 high (dequant_repacked), so each shard is
    repacked from its rows, and scales/offsets split at group
    boundaries (the group must divide K/tp). A shard dequantizes to the
    rows of dequant_repacked bit for bit.
  * LoRA stacks (install_adapters) replicate unless their base weight
    is cut: a column-parallel base cuts B's columns, a row-parallel base
    cuts A's rows, so that bypass is a partial sum added to the
    product's partials before the one AllReduce.

Anything the rules above do not cover is made replicated first (a gather
of a split input, a sum of a partial one), which is correct and slow;
the plan lists such places in `fallbacks`.

Training (`training=True`, on the trainer's graph: every weight an
input, no caches, logits at every position). The loss is one value that
every rank of `tp` computes alike from the gathered logits, so each
collective takes the gradient rule of that one loss (parallel/comm.py):
a replicated tensor that enters work each rank does on its own block (a
column-parallel product's input, a slice, a weight broadcast over a
split tensor, the k and v that KVHeads picks from) passes a CopyIn, whose
backward sums the ranks' partial gradients; a partial sum leaves through
AllReduce as reduce_out (identity backward); a split tensor made whole,
the logits among them, through AllGather as gather_out (backward: the
rank's slice). The vocab-parallel embedding is the masked lookup above;
the head is column-parallel and its logits are gathered before the loss
(the loss is not vocab-parallel). A weight whose cut dimension
the axis does not divide is refused, naming it (jax.device_put refuses
it the same way: GPT-2's 50,257-row wte at tp=2).
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..dtype import DType
from ..graph import new_global_id
from ..milli.ir import MilliGraph, MilliNode, MilliOp
from ..milli.ops.basic import Constant
from ..milli.registry import lowering
from ..scalar_info import ScalarInfo
from ..tensor_info import TensorInfo
from . import comm
from .mesh import Mesh, rule_spec

@dataclass(frozen=True)
class Split:
    """Split along `dim` (of the tensor's global rank) into the mesh
    axis's parts; with sections > 1, the dimension is that many equal
    concatenated parts, each split on its own."""

    dim: int
    sections: int = 1


PARTIAL = "partial"


def take_shard(a, dim: int, parts: int, index: int, sections: int = 1,
               name: str = "array"):
    """Block `index` of `parts` of a numpy array or tensor along `dim`,
    each of its `sections` equal parts cut on its own. Refuses a size
    the parts do not divide, naming the array."""
    n = int(a.shape[dim])
    if n % (sections * parts):
        raise ValueError(
            f"{name} of shape {tuple(a.shape)}: the global size of its "
            f"dimension {dim} ({n}"
            + ("" if sections == 1 else f" in {sections} sections")
            + f") should be divisible by {parts}, the extent of mesh axis "
            f"'tp'")
    s, c = n // sections, n // sections // parts
    pieces = []
    for k in range(sections):
        sl = [slice(None)] * a.ndim
        sl[dim] = slice(k * s + index * c, k * s + (index + 1) * c)
        pieces.append(a[tuple(sl)])
    if len(pieces) == 1:
        return pieces[0]
    if isinstance(a, torch.Tensor):
        return torch.cat(pieces, dim=dim)
    return np.concatenate(pieces, axis=dim)


def shard_packed_rows(q: np.ndarray, bits: int, parts: int, index: int,
                      name: str = "weight") -> np.ndarray:
    """The packed q of logical rows [index*K/parts, (index+1)*K/parts):
    for 4 bits the nibble rows are taken and packed again (row i low,
    row i + K_local/2 high)."""
    if bits != 4:
        return take_shard(q, 0, parts, index, name=name)
    K = 2 * q.shape[0]
    if K % (2 * parts):
        raise ValueError(f"{name}: K = {K} rows in 4-bit pairs cannot be "
                         f"cut into {parts} even shards")
    rows = np.concatenate([q & 0x0F, q >> 4], axis=0)
    kl = K // parts
    mine = rows[index * kl:(index + 1) * kl]
    return (mine[:kl // 2] | (mine[kl // 2:] << 4)).astype(np.uint8)


# -- the graph ops the pass inserts ----------------------------------------

@dataclass
class AllReduceMilli(MilliOp):
    """Sum of a partial tensor over the mesh axis (`training`: with
    reduce_out's gradient)."""

    mesh: Any = None
    axis: str = "tp"
    training: bool = False
    KIND = "AllReduce"

    def run(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return comm.reduce_out(x, self.mesh, self.axis)
        return comm.all_reduce(x, self.mesh, self.axis)

    def eval(self, inputs):
        x = torch.from_numpy(np.ascontiguousarray(inputs[0]))
        return [self.run(x).numpy()]


@dataclass
class CopyInMilli(MilliOp):
    """x itself, with copy_in's gradient: the sum over the mesh axis of
    the ranks' gradients of a replicated tensor."""

    mesh: Any = None
    axis: str = "tp"
    KIND = "CopyIn"

    def eval(self, inputs):
        return [inputs[0]]


@dataclass
class AllGatherMilli(MilliOp):
    """The whole of a tensor split along `dim` (with `sections`, each
    section's blocks are put back in place)."""

    mesh: Any = None
    axis: str = "tp"
    dim: int = 0
    sections: int = 1
    training: bool = False
    KIND = "AllGather"

    def run(self, x: torch.Tensor) -> torch.Tensor:
        gather = comm.gather_out if self.training else comm.all_gather
        y = gather(x, self.mesh, self.axis, self.dim)
        if self.sections == 1:
            return y
        # [r0: s0 s1 ..| r1: s0 s1 ..] -> [s0: r0 r1 ..| s1: r0 r1 ..]
        blocks = [b.chunk(self.sections, dim=self.dim)
                  for b in y.chunk(self.mesh.shape[self.axis], dim=self.dim)]
        return torch.cat([blk[k] for k in range(self.sections)
                          for blk in blocks], dim=self.dim)

    def eval(self, inputs):
        x = torch.from_numpy(np.ascontiguousarray(inputs[0]))
        return [self.run(x).numpy()]


@dataclass
class TpSliceMilli(MilliOp):
    """This rank's block of a replicated tensor (take_shard)."""

    dim: int = 0
    parts: int = 1
    index: int = 0
    sections: int = 1
    KIND = "TpSlice"

    def eval(self, inputs):
        return [np.ascontiguousarray(take_shard(
            inputs[0], self.dim, self.parts, self.index, self.sections))]


@dataclass
class VocabGatherMilli(MilliOp):
    """Rows `ids` of a table cut by rows: this rank's rows [offset,
    offset + rows) are looked up, the others are zeros (a partial sum
    over the ranks). `vocab` wraps negative ids as Gather does."""

    offset: int = 0
    rows: int = 0
    vocab: int = 0
    KIND = "VocabGather"

    def eval(self, inputs):
        table, ids = inputs
        ids = np.where(ids < 0, ids + self.vocab, ids).astype(np.int64)
        loc = ids - self.offset
        hit = (loc >= 0) & (loc < self.rows)
        out = table[np.where(hit, loc, 0)]
        return [np.where(hit[..., None], out, np.zeros((), table.dtype))]


@dataclass
class KVHeadsMilli(MilliOp):
    """The heads of replicated k and v (B, Hkv, S, D) that this rank's
    query heads q (B, Hq/parts, Sq, D) read under GQA: a slice where the
    local query heads read whole groups or share one, else one head per
    query head. Made contiguous for the attention kernels."""

    parts: int = 1
    index: int = 0
    KIND = "KVHeads"
    N_OUTPUTS = 2

    def heads(self, hq_local: int, hkv: int):
        hq = hq_local * self.parts
        if hq % hkv:
            raise ValueError(f"{hq} query heads over {hkv} kv heads")
        g = hq // hkv
        first = self.index * hq_local
        if hq_local % g == 0:
            return slice(first // g, first // g + hq_local // g)
        if g % hq_local == 0:
            return slice(first // g, first // g + 1)
        return [(first + j) // g for j in range(hq_local)]

    def eval(self, inputs):
        q, k, v = inputs
        h = self.heads(q.shape[1], k.shape[1])
        return [np.ascontiguousarray(k[:, h]), np.ascontiguousarray(v[:, h])]


@lowering("AllReduce")
def _all_reduce(op, inputs, static, device):
    return [op.run(inputs[0])]


@lowering("CopyIn")
def _copy_in(op, inputs, static, device):
    return [comm.copy_in(inputs[0], op.mesh, op.axis)]


@lowering("AllGather")
def _all_gather(op, inputs, static, device):
    return [op.run(inputs[0])]


@lowering("TpSlice")
def _tp_slice(op, inputs, static, device):
    return [take_shard(inputs[0], op.dim, op.parts, op.index,
                       op.sections).contiguous()]


@lowering("VocabGather")
def _vocab_gather(op, inputs, static, device):
    table, ids = inputs
    ids = torch.where(ids < 0, ids + op.vocab, ids).long()
    loc = ids - op.offset
    hit = (loc >= 0) & (loc < op.rows)
    out = table[torch.where(hit, loc, 0)]
    return [out * hit[..., None].to(out.dtype)]


@lowering("KVHeads")
def _kv_heads(op, inputs, static, device):
    q, k, v = inputs
    h = op.heads(q.shape[1], k.shape[1])
    if isinstance(h, list):
        idx = torch.tensor(h, device=k.device)
        return [k.index_select(1, idx), v.index_select(1, idx)]
    return [k[:, h].contiguous(), v[:, h].contiguous()]


# -- the pass ----------------------------------------------------------------

MATMULS = ("MatMul", "QuantMatMul", "PackedMatMul")
ELEMENTWISE = ("SimpleBinary", "SimpleUnary", "Cast", "CastLike", "Where",
               "ClampMin", "Pow", "Identity")
LINEAR_UNARY = ("Cast", "Identity")


@dataclass
class TpPlan:
    """One rank's share of a step graph (shard_graph)."""

    graph: MilliGraph
    mesh: Mesh
    axis: str
    # graph inputs cut at load: name -> Split (its dim in the input's
    # stored layout; a packed 4-bit q cut by rows is repacked)
    inputs: Dict[str, Split] = field(default_factory=dict)
    fallbacks: List[str] = field(default_factory=list)

    @property
    def parts(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def index(self) -> int:
        return self.mesh.index(self.axis)

    def local_dims(self, name: str, dims: Sequence[int]) -> Tuple[int, ...]:
        """The local shape of input `name` of global shape `dims`."""
        s = self.inputs.get(name)
        dims = [int(d) for d in dims]
        if s is not None:
            dims[s.dim] //= self.parts
        return tuple(dims)

    def shard_weights(self, arrays: Mapping[str, np.ndarray],
                      packed_bits: Mapping[str, int] = {}
                      ) -> Dict[str, np.ndarray]:
        """This rank's blocks of host weights named as the graph's
        inputs. packed_bits: {packed q input: bits}, whose row cuts are
        repacked."""
        out = {}
        for n, a in arrays.items():
            s = self.inputs.get(n)
            if s is None:
                out[n] = a
            elif n in packed_bits and s.dim == 0:
                out[n] = shard_packed_rows(a, int(packed_bits[n]),
                                           self.parts, self.index, n)
            else:
                out[n] = np.ascontiguousarray(take_shard(
                    a, s.dim, self.parts, self.index, s.sections, n))
        return out


def _tp_specs(names: Sequence[str], rules, axis: str) -> Dict[str, int]:
    """{weight input: the dimension its rule cuts over `axis`} for the
    inputs the rules cut. Rules name base weights; `W::...` inputs
    follow W in the pass. A rule on another mesh axis is refused."""
    out = {}
    for n in names:
        if "::" in n:
            continue
        spec = rule_spec(n, rules)
        for d, entry in enumerate(spec or ()):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            if axes == (axis,):
                out[n] = d
            elif axes:
                raise NotImplementedError(
                    f"{n}: rule spec {spec} shards over {axes}; serving "
                    f"shards weights over {axis!r} only")
    return out


class _Pass:
    def __init__(self, milli: MilliGraph, mesh: Mesh, rules,
                 weight_shapes: Mapping[str, Tuple[int, ...]],
                 weight_dtypes: Mapping[str, DType], axis: str,
                 packed: Mapping[str, int], training: bool = False):
        self.mesh, self.axis = mesh, axis
        self.training = training
        self.parts = mesh.shape[axis]
        self.index = mesh.index(axis)
        self.g = g = copy.deepcopy(milli)
        self.packed = packed
        # shapes are worked out at sample sizes of the symbolic dims
        # (batch, sequence): distinct primes no model width is made of
        samples: Dict[int, int] = {}
        primes = iter((3, 7, 11, 13, 17, 19, 23, 29))

        def concrete(d):
            if d.is_known:
                return int(d.value())
            sym = d.symbolic
            if sym.symbol_id not in samples:
                samples[sym.symbol_id] = next(primes)
            return samples[sym.symbol_id] + sym.offset

        infos = {}
        for n, tid in g.inputs.items():
            info = g.tensors[tid].info
            if n in weight_shapes:
                info = TensorInfo.shaped(weight_dtypes[n], weight_shapes[n])
            elif n == "lora_idx":
                batch = g.tensors[g.inputs["input_ids"]].info.dims()[0]
                info = TensorInfo.shaped(DType.I64, [concrete(batch)])
            elif info is not None and info.dims() is not None:
                info = TensorInfo.shaped(info.dtype,
                                         [concrete(d) for d in info.dims()])
            infos[n] = info
        self.infos = g.infer_all({n: i for n, i in infos.items()
                                  if i is not None})
        self.producer = {t: node for node in g.nodes for t in node.outputs}
        self.shapes = self._infer_shapes()
        self.input_name = {tid: n for n, tid in g.inputs.items()}
        self.weight_names = set(weight_shapes)
        self.state: Dict[int, Any] = {}
        self.plan_inputs: Dict[str, Split] = {}
        self.fallbacks: List[str] = []
        self.new_nodes: List[MilliNode] = []
        self._memo: Dict[Tuple, int] = {}
        self._place_inputs(_tp_specs(list(weight_shapes), rules, axis))

    # -- shapes --------------------------------------------------------
    def dims(self, tid) -> Optional[list]:
        d = self.shapes.get(tid)
        return None if d is None else list(d)

    def rank(self, tid) -> Optional[int]:
        if tid in self.shapes:
            return len(self.shapes[tid])
        info = self.infos.get(tid)
        return None if info is None else info.rank

    def size(self, tid, d) -> Optional[int]:
        dims = self.dims(tid)
        if dims is None or not dims[d].is_known:
            return None
        return int(dims[d].value())

    def const(self, tid) -> Optional[np.ndarray]:
        node = self.producer.get(tid)
        if node is not None and node.op.KIND == "Constant":
            return np.asarray(node.op.value)
        info = self.infos.get(tid)
        return None if info is None or info.value is None \
            else np.asarray(info.value)

    def _infer_shapes(self) -> Dict[int, list]:
        """Global dims (ScalarInfo, symbolic batch and sequence kept) of
        the graph's tensors: the ops the step graphs are made of worked
        out here, where the graph's own infer_all gives up (a constant
        operand, Split), the rest taken from infer_all."""
        S = {t: list(i.dims()) for t, i in self.infos.items()
             if i.dims() is not None}
        for node in self.g.nodes:
            try:
                outs = self._node_shapes(node, S)
            except (ValueError, IndexError, TypeError, KeyError):
                outs = None
            for k, t in enumerate(node.outputs):
                if t is None:
                    continue
                if outs is not None and outs[k] is not None:
                    S[t] = outs[k]
        return S

    def _node_shapes(self, node, S) -> Optional[List[Optional[list]]]:
        kind, op = node.op.KIND, node.op
        ins = [None if i is None else S.get(i) for i in node.inputs]
        x = ins[0] if ins else None
        one = ScalarInfo(numeric=1)
        if kind in ELEMENTWISE:
            live = ins[:1] if kind == "CastLike" else ins
            if any(d is None for d in live):
                return None
            r = max(len(d) for d in live)
            out = []
            for k in range(r):
                cands = [d[k - r + len(d)] for d in live if k - r + len(d) >= 0]
                big = [c for c in cands if not c.equals(one)]
                out.append(big[0] if big else one)
            return [out]
        if x is None:
            return None
        if kind in ("MatMul", "QuantMatMul"):
            b = ins[1]
            if len(x) < 2 or b is None or len(b) < 2:
                return None
            lead = x[:-2] if len(x) >= len(b) else b[:-2]
            return [list(lead) + [x[-2], b[-1]]]
        if kind == "PackedMatMul":
            return [x[:-1] + [ins[1][-1]]]
        if kind in ("Rotary", "RMSNorm", "Identity", "DynUpdateSlice"):
            return [x]
        if kind == "LayerNorm":
            return [x] + [None] * (len(node.outputs) - 1)
        if kind == "Transpose":
            perm = list(op.perm) or list(range(len(x)))[::-1]
            return [[x[p] for p in perm]]
        if kind == "Attention" and len(x) == 4 and ins[2] is not None:
            return [x[:3] + [ins[2][3]]] + [None] * (len(node.outputs) - 1)
        if kind == "Split":
            axis = op.axis % len(x)
            sizes = (self.const(node.inputs[1]) if len(node.inputs) > 1
                     and node.inputs[1] is not None else None)
            if sizes is not None:
                sizes = [int(v) for v in sizes.reshape(-1)]
            elif op.sizes:
                sizes = list(op.sizes)
            else:
                n = len(node.outputs)
                sizes = [int(x[axis].value()) // n] * n
            return [x[:axis] + [ScalarInfo(numeric=v)] + x[axis + 1:]
                    for v in sizes]
        if kind == "Reshape":
            t = self.const(node.inputs[1])
            if t is None:
                return None
            t = [int(v) for v in t.reshape(-1)]
            out = [x[i] if v == 0 else (ScalarInfo(numeric=v) if v > 0
                                         else None)
                   for i, v in enumerate(t)]
            if None in out:
                rest = [x[i] for i in range(len(x))
                        if not (i < len(t) and t[i] == 0)]
                if not all(d.is_known for d in rest):
                    return None
                n = math.prod(int(d.value()) for d in rest)
                known = math.prod(v for v in t if v > 0)
                out[out.index(None)] = ScalarInfo(numeric=n // known)
            return [out]
        if kind == "Unsqueeze":
            axes = (self.const(node.inputs[1]) if len(node.inputs) > 1
                    and node.inputs[1] is not None else op.axes)
            r = len(x) + len(np.asarray(axes).reshape(-1))
            added = {int(a) % r for a in np.asarray(axes).reshape(-1)}
            it = iter(x)
            return [[one if k in added else next(it) for k in range(r)]]
        if kind == "Squeeze":
            axes = (self.const(node.inputs[1]) if len(node.inputs) > 1
                    and node.inputs[1] is not None else op.axes)
            if axes is None:
                return [[d for d in x if not d.equals(one)]]
            gone = {int(a) % len(x) for a in np.asarray(axes).reshape(-1)}
            return [[d for k, d in enumerate(x) if k not in gone]]
        if kind == "Gather" and ins[1] is not None:
            axis = op.axis % len(x)
            return [x[:axis] + ins[1] + x[axis + 1:]]
        if kind == "Einsum":
            lhs, rhs = op.equation.replace(" ", "").split("->")
            size = {}
            for letters, d in zip(lhs.split(","), ins):
                for c, v in zip(letters, d):
                    if c not in size or size[c].equals(one):
                        size[c] = v
            return [[size[c] for c in rhs]]
        return None

    # -- placement of the graph inputs ---------------------------------
    def _place_inputs(self, specs: Dict[str, int]) -> None:
        g = self.g
        sections = self._qkv_sections()
        forced = self._replicated_writers()
        for n, tid in g.inputs.items():
            base, _, kind = n.partition("::")
            d = specs.get(base)
            if n.startswith("cache_"):
                heads = self.size(tid, 1)
                if heads is not None and heads % self.parts == 0:
                    self._set_input(n, Split(1))
                continue
            if d is None or base in forced:
                continue
            sec = sections.get(base, 1)
            packed = base in self.packed
            if kind == "":
                split = Split(d, sec)
            elif kind == "scale":            # int8 per-column scale (N,)
                split = Split(0, sec) if d == 1 else None
            elif kind in ("pscales", "poffsets"):   # (K/G, N)
                split = Split(d, sec)
            elif kind == "lora_as":          # (n, K, r)
                split = Split(1) if d == 0 else None
            elif kind == "lora_bs":          # (n, r, N)
                split = Split(2, sec) if d == 1 else None
            else:
                split = None
            if split is None:
                continue
            if packed and kind == "" and d == 0:
                K = self.packed_k(n)
                ok = K % self.parts == 0 and (self.packed[base] != 4
                                              or (K // self.parts) % 2 == 0)
                if not ok:
                    raise ValueError(f"{n}: K = {K} rows cannot be cut into "
                                     f"{self.parts} shards")
            else:
                dims = self.dims(tid)
                if dims is not None and all(d.is_known for d in dims):
                    # refuse now what the upload would: a zero-strided
                    # stand-in of the weight's shape
                    take_shard(np.broadcast_to(np.zeros((), np.int8), tuple(
                        int(d.value()) for d in dims)), split.dim,
                        self.parts, 0, split.sections, n)
            self._set_input(n, split)

    def packed_k(self, n: str) -> int:
        rows = self.size(self.g.inputs[n], 0)
        return rows * 2 if self.packed[n] == 4 else rows

    def _set_input(self, n: str, split: Split) -> None:
        self.plan_inputs[n] = split
        self.state[self.g.inputs[n]] = split

    def _qkv_sections(self) -> Dict[str, int]:
        """{weight input: sections} for products whose output a Split
        node cuts into equal parts along the last dimension (fused
        q/k/v): the weight, its bias and their `::` companions are cut in
        those sections. (Unequal splits fall back to a gather.)"""
        out: Dict[str, int] = {}
        for node in self.g.nodes:
            if node.op.KIND != "Split" or node.op.sizes or (
                    len(node.inputs) > 1 and node.inputs[1] is not None):
                continue
            r = self.rank(node.inputs[0])
            if r is None or node.op.axis % r != r - 1:
                continue
            for w in self._chain_weights(node.inputs[0], MATMULS):
                out[w] = len(node.outputs)
        return out

    def _replicated_writers(self) -> set:
        """Weights whose products write a cache that stays replicated
        (tp does not divide its heads): they stay whole."""
        out = set()
        for node in self.g.nodes:
            if node.op.KIND != "DynUpdateSlice":
                continue
            name = self.input_name.get(node.inputs[0], "")
            heads = self.size(node.inputs[0], 1) if name.startswith(
                "cache_") else None
            if heads is None or heads % self.parts == 0:
                continue
            out.update(self._chain_weights(node.inputs[1], MATMULS))
        return out

    def _chain_weights(self, tid, stop_kinds) -> List[str]:
        """Walk back from `tid` through shape and elementwise ops (and
        both sides of an Add of two activations, as a LoRA bypass adds)
        to the products that made it: the products' weights, and any
        weight added on the way (a bias)."""
        found, todo, seen = [], [tid], set()
        while todo and len(seen) < 64:
            tid = todo.pop()
            node = self.producer.get(tid)
            if node is None or tid in seen:
                continue
            seen.add(tid)
            kind = node.op.KIND
            if kind in stop_kinds:
                w = self.input_name.get(node.inputs[1])
                if w is not None:
                    found.append(w.partition("::")[0])
            elif kind == "SimpleBinary" and node.op.mode in ("add", "sub"):
                for t in node.inputs:
                    w = self.input_name.get(t)
                    if w is not None and w in self.weight_names:
                        found.append(w)
                    elif w is None and self.const(t) is None:
                        todo.append(t)
            elif kind in ("Transpose", "Reshape", "Rotary", "Cast",
                          "Identity", "RMSNorm", "LayerNorm", "Split"):
                todo.append(node.inputs[0])
        return found

    # -- conversions -----------------------------------------------------
    def _add(self, op: MilliOp, inputs: List[int], n_out: int = 1,
             label: Optional[str] = None) -> List[int]:
        outs = [self.g.new_tensor(label=label) for _ in range(n_out)]
        self.new_nodes.append(MilliNode(new_global_id(), op, list(inputs),
                                        outs))
        return outs

    def to_rep(self, tid, why: Optional[str] = None) -> int:
        st = self.state.get(tid)
        if st is None:
            return tid
        key = ("rep", tid)
        if key not in self._memo:
            if st == PARTIAL:
                op = AllReduceMilli(mesh=self.mesh, axis=self.axis,
                                    training=self.training)
            else:
                op = AllGatherMilli(mesh=self.mesh, axis=self.axis,
                                    dim=st.dim, sections=st.sections,
                                    training=self.training)
                if why is not None:
                    self.fallbacks.append(why)
            (out,) = self._add(op, [tid])
            self._copy_info(tid, out)
            self._memo[key] = out
        return self._memo[key]

    def to_split(self, tid, dim: int, sections: int) -> int:
        """A replicated tensor's local block along `dim`."""
        key = ("split", tid, dim, sections)
        if key not in self._memo:
            (out,) = self._add(TpSliceMilli(dim=dim, parts=self.parts,
                                            index=self.index,
                                            sections=sections),
                               [self.copy_in(tid)])
            self._copy_info(tid, out)
            self.state[out] = Split(dim, sections)
            self._memo[key] = out
        return self._memo[key]

    def copy_in(self, tid) -> int:
        """Training: a replicated tensor that may carry a gradient, passed
        through CopyIn before work each rank does on its own part of it
        (once for every such use). Otherwise, and for constants and
        integer tensors, tid itself."""
        if not self.training or self.state.get(tid) is not None \
                or self.const(tid) is not None:
            return tid
        info = self.infos.get(tid)
        if info is not None and info.dtype is not None \
                and not info.dtype.is_float:
            return tid
        key = ("copy_in", tid)
        if key not in self._memo:
            (out,) = self._add(CopyInMilli(mesh=self.mesh, axis=self.axis),
                               [tid])
            self._copy_info(tid, out)
            self._memo[key] = out
        return self._memo[key]

    def _copy_info(self, src, dst) -> None:
        if src in self.infos:
            self.infos[dst] = self.infos[src]
        if src in self.shapes:
            self.shapes[dst] = self.shapes[src]

    # -- the walk ----------------------------------------------------------
    def run(self) -> TpPlan:
        g = self.g
        for node in g.nodes:
            handler = getattr(self, "h_" + node.op.KIND, None)
            ins = list(node.inputs)
            if all(self.state.get(i) is None for i in ins if i is not None):
                self._emit(node, ins, [None] * len(node.outputs))
                continue
            if handler is None or not handler(node, ins):
                self._replicated(node, ins)
        outputs = {}
        for name, tid in g.outputs.items():
            if name.startswith("new_cache_") or self.state.get(tid) is None:
                outputs[name] = tid
            else:
                outputs[name] = self.to_rep(tid)
        g.nodes = self.new_nodes
        g.outputs = outputs
        return TpPlan(g, self.mesh, self.axis, self.plan_inputs,
                      self.fallbacks)

    def _emit(self, node: MilliNode, ins: List, states: List,
              op: Optional[MilliOp] = None) -> None:
        if any(s is not None for s in states):
            # the replicated inputs of work that is split or partial
            ins = [None if i is None else self.copy_in(i) for i in ins]
        node.inputs = ins
        if op is not None:
            node.op = op
        self.new_nodes.append(node)
        for t, s in zip(node.outputs, states):
            if t is not None and s is not None:
                self.state[t] = s

    def _replicated(self, node, ins) -> None:
        """Every input made whole; outputs replicated."""
        why = f"{node.op.KIND} (node {node.id})"
        ins = [None if i is None else self.to_rep(i, why) for i in ins]
        self._emit(node, ins, [None] * len(node.outputs))

    # -- handlers: return True when the node was placed ------------------
    def h_MatMul(self, node, ins) -> bool:
        a, b = ins[0], ins[1]
        sa, sb = self.state.get(a), self.state.get(b)
        ra, rb = self.rank(a), self.rank(b)
        if ra is None or rb is None:
            return False
        rout = max(ra, rb)
        if PARTIAL in (sa, sb):
            if sb is None and sa == PARTIAL:
                self._emit(node, ins, [PARTIAL])
                return True
            return False
        if sa is None and isinstance(sb, Split) and sb.dim == rb - 1:
            self._emit(node, ins, [Split(rout - 1, sb.sections)])
            return True
        if isinstance(sb, Split) and sb.dim == rb - 2 and sb.sections == 1:
            if sa is None:
                ins[0] = self.to_split(a, ra - 1, 1)
            elif sa != Split(ra - 1, 1):
                return False
            self._emit(node, ins, [PARTIAL])
            return True
        if sb is None and sa == Split(ra - 1, 1) and rb >= 2:
            # a replicated right side under an activation cut along the
            # contraction (a LoRA A of a row-parallel base): its rows
            k = self.size(b, rb - 2)
            if k is None or k % self.parts:
                return False
            ins[1] = self.to_split(b, rb - 2, 1)
            self._emit(node, ins, [PARTIAL])
            return True
        return False

    def h_QuantMatMul(self, node, ins) -> bool:
        return self.h_MatMul(node, ins)

    def h_PackedMatMul(self, node, ins) -> bool:
        a, b = ins[0], ins[1]
        sa, sb = self.state.get(a), self.state.get(b)
        ra = self.rank(a)
        if ra is None or sa == PARTIAL:
            return False
        if sa is None and isinstance(sb, Split) and sb.dim == 1:
            self._emit(node, ins, [Split(ra - 1, sb.sections)])
            return True
        if isinstance(sb, Split) and sb.dim == 0:
            if sa is None:
                ins[0] = self.to_split(a, ra - 1, 1)
            elif sa != Split(ra - 1, 1):
                return False
            self._emit(node, ins, [PARTIAL])
            return True
        return False

    def _elementwise_partial(self, node, ins) -> Optional[bool]:
        kind, mode = node.op.KIND, getattr(node.op, "mode", None)
        states = [self.state.get(i) for i in ins]
        if PARTIAL not in states:
            return None
        if kind in LINEAR_UNARY or (kind == "SimpleUnary" and mode == "neg"):
            self._emit(node, ins, [PARTIAL])
            return True
        if kind == "SimpleBinary":
            if mode in ("add", "sub") and states == [PARTIAL, PARTIAL]:
                self._emit(node, ins, [PARTIAL])
                return True
            if mode == "mul" and states.count(PARTIAL) == 1 and all(
                    s in (None, PARTIAL) for s in states):
                self._emit(node, ins, [PARTIAL])
                return True
            if mode == "div" and states == [PARTIAL, None]:
                self._emit(node, ins, [PARTIAL])
                return True
        ins[:] = [None if i is None else
                  (self.to_rep(i) if self.state.get(i) == PARTIAL else i)
                  for i in ins]
        return None

    def h_elementwise(self, node, ins) -> bool:
        done = self._elementwise_partial(node, ins)
        if done:
            return True
        live = ins[:1] if node.op.KIND == "CastLike" else ins
        rout = self.rank(node.outputs[0])
        if rout is None:
            return False
        want = None
        for i in live:
            s = self.state.get(i) if i is not None else None
            if isinstance(s, Split):
                if self.rank(i) is None:
                    return False
                d = Split(s.dim + rout - self.rank(i), s.sections)
                if want is not None and d != want:
                    return False
                want = d
        if want is None:
            self._emit(node, ins, [None])
            return True
        for k, i in enumerate(live):
            if i is None or self.state.get(i) is not None:
                continue
            r = self.rank(i)
            if r is None:
                return False
            d = want.dim - (rout - r)
            if d < 0:
                continue
            n = self.size(i, d)
            if n == 1:
                continue
            if n is None:
                return False
            ins[k] = self.to_split(i, d, want.sections)
        self._emit(node, ins, [want])
        return True

    h_SimpleBinary = h_SimpleUnary = h_Cast = h_CastLike = h_Where = \
        h_ClampMin = h_Pow = h_Identity = h_elementwise

    def h_Transpose(self, node, ins) -> bool:
        s = self.state.get(ins[0])
        if s == PARTIAL:
            self._emit(node, ins, [PARTIAL])
            return True
        perm = list(node.op.perm)
        if not perm or node.op.swap_last2:
            return False
        self._emit(node, ins, [Split(perm.index(s.dim), s.sections)])
        return True

    def h_Reshape(self, node, ins) -> bool:
        x, target = ins[0], ins[1]
        s = self.state.get(x)
        if s == PARTIAL:
            self._emit(node, ins, [PARTIAL])
            return True
        t = self.const(target)
        din, dout = self.dims(x), self.dims(node.outputs[0])
        if t is None or din is None or dout is None or \
                self.state.get(target) is not None:
            return False
        t = [int(v) for v in t.reshape(-1)]
        p = 0
        while p < min(len(din), len(dout)) and din[p].equals(dout[p]):
            p += 1
        q = 0
        while q < min(len(din), len(dout)) - p and \
                din[-1 - q].equals(dout[-1 - q]):
            q += 1
        sec = s.sections
        if s.dim < p:
            k = s.dim
        elif s.dim >= len(din) - q:
            k = s.dim - len(din) + len(dout)
        elif s.dim == p and sec == 1:
            k = p
        else:
            return False
        size = dout[k].value() if dout[k].is_known else None
        if size is None or size % self.parts:
            return False
        if t[k] > 0:
            t[k] //= self.parts
        elif t[k] == 0 and k >= p:
            return False
        (new_t,) = self._add(Constant(value=np.asarray(t, np.int64)), [])
        self._emit(node, [x, new_t], [Split(k, sec)])
        return True

    def h_Split(self, node, ins) -> bool:
        s = self.state.get(ins[0])
        n_out = len(node.outputs)
        if s == PARTIAL:
            self._emit(node, ins, [PARTIAL] * n_out)
            return True
        r = self.rank(ins[0])
        if r is None or (len(ins) > 1 and ins[1] is not None):
            return False
        axis = node.op.axis % r
        if axis != s.dim:
            self._emit(node, ins, [s] * n_out)
            return True
        if node.op.sizes or s.sections != n_out:
            return False
        self._emit(node, ins, [Split(s.dim)] * n_out)
        return True

    def h_Rotary(self, node, ins) -> bool:
        s = self.state.get(ins[0])
        if s == PARTIAL or any(self.state.get(i) is not None
                               for i in ins[1:] if i is not None):
            return False
        if node.op.num_heads == 0 and self.rank(ins[0]) == 4 and s.dim == 1:
            self._emit(node, ins, [s])
            return True
        return False

    def h_DynUpdateSlice(self, node, ins) -> bool:
        cache, upd = ins[0], ins[1]
        sc, su = self.state.get(cache), self.state.get(upd)
        if sc == PARTIAL or any(self.state.get(i) is not None
                                for i in ins[2:] if i is not None):
            return False
        if self.rank(cache) is None:
            return False
        axis = node.op.axis % self.rank(cache)
        if sc is None:
            ins[1] = self.to_rep(upd)
            self._emit(node, ins, [None])
            return True
        if sc.dim == axis:
            return False
        if su is None:
            ins[1] = self.to_split(upd, sc.dim, sc.sections)
        elif su != sc:
            return False
        self._emit(node, ins, [sc])
        return True

    def h_Attention(self, node, ins) -> bool:
        q, k, v = ins[0], ins[1], ins[2]
        sq, sk, sv = (self.state.get(t) for t in (q, k, v))
        rest = [i for i in ins[3:] if i is not None]
        if PARTIAL in (sq, sk, sv) or any(
                self.state.get(i) is not None for i in rest):
            return False
        n_out = len(node.outputs)
        if self.rank(q) == 4:
            if sq != Split(1):
                return False
            if sk is None and sv is None:
                ins[1], ins[2] = self._add(
                    KVHeadsMilli(parts=self.parts, index=self.index),
                    [q, self.copy_in(k), self.copy_in(v)], n_out=2)
            elif not (sk == sv == Split(1)):
                return False
            if len(ins) > 3 and ins[3] is not None and \
                    self.rank(ins[3]) == 4:
                heads = self.size(ins[3], 1)
                if heads is None:
                    return False
                if heads > 1:
                    ins[3] = self.to_split(ins[3], 1, 1)
            self._emit(node, ins, [Split(1)] * n_out)
            return True
        return False

    def h_Gather(self, node, ins) -> bool:
        data, idx = ins
        sd, si = self.state.get(data), self.state.get(idx)
        if si is not None or sd == PARTIAL:
            return False
        r = self.rank(data)
        if r is None:
            return False
        axis = node.op.axis % r
        if sd.dim == axis == 0 and sd.sections == 1:
            vocab = self.size(data, 0)
            rows = vocab // self.parts
            self._emit(node, ins, [PARTIAL], VocabGatherMilli(
                offset=self.index * rows, rows=rows, vocab=vocab))
            return True
        return False

    def _norm(self, node, ins) -> bool:
        s = self.state.get(ins[0])
        if s == PARTIAL or any(self.state.get(i) is not None
                               for i in ins[1:] if i is not None):
            return False
        r = self.rank(ins[0])
        if r is None or s.dim >= node.op.axis % r or len(node.outputs) != 1:
            return False
        self._emit(node, ins, [s])
        return True

    h_RMSNorm = h_LayerNorm = _norm

    def h_Einsum(self, node, ins) -> bool:
        lhs, out_letters = node.op.equation.replace(" ", "").split("->")
        letters = lhs.split(",")
        states = [self.state.get(i) for i in ins]
        if len(letters) != len(ins) or any("." in ls for ls in letters):
            return False
        if PARTIAL in states:
            if states.count(PARTIAL) == 1 and all(
                    s in (None, PARTIAL) for s in states):
                self._emit(node, ins, [PARTIAL])
                return True
            return False
        cut = {(letters[k][s.dim], s.sections)
               for k, s in enumerate(states) if s is not None}
        if len(cut) != 1:
            return False
        ((letter, sec),) = cut
        for k, i in enumerate(ins):
            if states[k] is None and letter in letters[k]:
                d = letters[k].index(letter)
                if self.size(i, d) != 1:
                    ins[k] = self.to_split(i, d, sec)
        if letter in out_letters:
            self._emit(node, ins, [Split(out_letters.index(letter), sec)])
        else:
            self._emit(node, ins, [PARTIAL])
        return True


def shard_graph(milli: MilliGraph, mesh: Mesh, rules,
                weight_shapes: Mapping[str, Tuple[int, ...]],
                weight_dtypes: Mapping[str, DType], axis: str = "tp",
                packed: Mapping[str, int] = {},
                training: bool = False) -> TpPlan:
    """This rank's share of `milli` under `rules` over mesh axis `axis`.

    weight_shapes / weight_dtypes: the global shape and type of each
    weight input (every graph input the caller feeds from its weights:
    int8 scales, packed scales and offsets and LoRA stacks included).
    packed: {packed q input: bits}. training: the gradient rules of one
    replicated loss (CopyIn, reduce_out, gather_out; see the module's
    docstring). The graph is copied; `milli` is not changed."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh {mesh.shape} has no {axis!r} axis")
    return _Pass(milli, mesh, rules, weight_shapes, weight_dtypes, axis,
                  packed, training).run()
