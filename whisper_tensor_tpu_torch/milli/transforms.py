"""Milli-graph passes of the text path, and the QuantMatMul op.

The port's copy of the parts of whisper_tensor_tpu/milli/transforms.py
that the text interfaces run:
  * fuse_parallel_matmuls: same-input weight matmuls (q/k/v, gate/up)
    become one wide matmul and a static Split; apply_matmul_fusion runs
    it and binds the fused weights;
  * pair_cache_writes (the port's own, no counterpart in the JAX
    package): a layer's K and V cache writes (DynUpdateSlice with one
    start) become one KVWrite node, one launch of the cache-write kernel;
  * quantize_matmul_weights: MatMul(x, W) -> QuantMatMul(x, W_i8,
    scale) for 2-D weight inputs, with quantize_int8 (the numpy
    function of whisper_tensor_tpu/backends/pallas/quant_matmul.py:
    23-37) computing the weights and scales;
  * QuantMatMulMilli, whose lowering runs the port's int8_matmul
    (backends/cuda/quant_matmul.py);
  * pack_matmul_nodes (:515-571): MatMul(x, W) -> PackedMatMul(x, q,
    scales, offsets) for weights with a packed source (GGUF blocks, or
    a dense weight quantized on the host), and PackedMatMulMilli
    (:474-512), whose lowering runs the port's packed_matmul
    (backends/cuda/packed_matmul.py).
  * inject_multi_lora (:330-468): per-row multi-LoRA surgery, a one-hot
    of `lora_idx` and three Einsum nodes and an Add after every targeted
    MatMul, node for node the reference's.
  * inject_lora (:227-329): the training-side LoRA surgery, a low-rank
    bypass x @ A @ B * (alpha / r) after every targeted MatMul, node for
    node the reference's (training/trainer.py's `lora_rank`).
A decode window's graph (interfaces/text.py, window_models) takes the
main graph's passes: quantize_matmul_weights(precomputed=) over the
main graph's int8 pairs, and pack_matmul_nodes over its packed arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..backends.cuda.packed_matmul import (dequant_repacked, packed_matmul,
                                           repack_packed_tensor)
from ..backends.cuda.quant_matmul import Int8MatMul, int8_matmul
from ..dtype import DType
from ..graph import new_global_id
from ..tensor_info import Level, TensorInfo
from .ir import MilliGraph, MilliNode, MilliOp
from .registry import lowering


def quantize_int8(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8: w (K, N) -> (w_i8 (K,N), scale (N,))."""
    w = np.asarray(w, dtype=np.float32)
    amax = np.abs(w).max(axis=0)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale[None, :]), -127, 127).astype(np.int8)
    return q, scale


@dataclass
class QuantMatMulMilli(MilliOp):
    """x (…,K) float, w_i8 (K,N) int8, scale (N,) f32 -> (…,N) in x.dtype."""

    KIND = "QuantMatMul"

    def eval(self, inputs):
        x, w_i8, scale = inputs
        xf = x.astype(np.float32)
        out = (xf @ w_i8.astype(np.float32)) * scale[None, :].astype(np.float32)
        return [out.astype(x.dtype)]

    def infer(self, infos):
        x, w, s = infos
        if all(i.level is Level.NUMERIC for i in infos):
            return [TensorInfo.numeric(self.eval([i.value for i in infos])[0])]
        dx, dw = x.dims(), w.dims()
        if dx is not None and dw is not None:
            return [TensorInfo.shaped(x.dtype, list(dx[:-1]) + [dw[-1]])]
        if x.rank is not None:
            return [TensorInfo.ranked(x.dtype, x.rank)]
        return [TensorInfo.minimal(x.dtype)]


def quantize_matmul_weights(
    milli: MilliGraph,
    weight_names: Sequence[str],
    weight_getter,
    min_elements: int = 1 << 16,
    precomputed: Optional[Dict[str, Tuple]] = None,
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Mutate `milli`: every MatMul whose RHS is a 2-D weight input from
    `weight_names` (and large enough to matter) becomes QuantMatMul with
    an extra `<name>::scale` input. Returns {name: (w_i8, scale)} —
    callers feed w_i8 under the original name and scale under the new.

    precomputed: apply the SAME surgery to a second graph built from the
    same recipe without touching the dense weights again: exactly the
    names present get QuantMatMul, reusing the given (w_i8, scale), host
    arrays or device tensors, so both graphs share one weight set.
    """
    from .ops import MatMul   # (milli.ops imports this module)

    name_to_tid = {name: tid for name, tid in milli.inputs.items()}
    quantized: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    scale_tid: Dict[str, int] = {}
    for node in milli.nodes:
        if not isinstance(node.op, MatMul) or len(node.inputs) != 2:
            continue
        rhs = node.inputs[1]
        rhs_name = None
        for name in weight_names:
            if name_to_tid.get(name) == rhs:
                rhs_name = name
                break
        if rhs_name is None:
            continue
        if precomputed is not None:
            if rhs_name not in precomputed:
                continue
            if rhs_name not in quantized:
                quantized[rhs_name] = precomputed[rhs_name]
                scale_tid[rhs_name] = milli.add_input(f"{rhs_name}::scale")
        else:
            w = np.asarray(weight_getter(rhs_name))
            if w.ndim != 2 or w.size < min_elements:
                continue
            if rhs_name not in quantized:
                quantized[rhs_name] = quantize_int8(w.astype(np.float32))
                scale_tid[rhs_name] = milli.add_input(f"{rhs_name}::scale")
        node.op = QuantMatMulMilli()
        node.inputs = [node.inputs[0], rhs, scale_tid[rhs_name]]
    return quantized


def fuse_parallel_matmuls(
    milli: MilliGraph,
    weight_names: Sequence[str],
    min_group: int = 2,
) -> Dict[str, List[Tuple[str, int]]]:
    """Fuse same-input weight matmuls into one wide matmul + static Split.

    MatMuls that share the SAME lhs tensor and whose RHS are distinct
    2-D weight graph-inputs (q/k/v projections, SwiGLU gate/up) merge
    into `y = x @ concat(W_1..W_n, axis=1)` followed by a Split back to
    the original output tensors. Numerically EXACT: every output column
    of a matmul depends only on its own RHS column, so concatenation
    changes nothing — including int8 per-channel or GGUF per-block
    quantization applied afterwards (both are column/row-block local).

    Why: every matmul launch has a fixed cost, and a decode step is a
    chain of small matmuls. Fusing 7 projections per transformer layer
    into 4 removes 3 of those launches.

    Mutates `milli` (member weight inputs are REMOVED from
    milli.inputs) and returns {fused_input_name: [(member_name,
    n_cols), ...]} in split order — callers bind the fused weight as
    np.concatenate([W_members], axis=1).
    """
    from .ops import MatMul, Split   # (milli.ops imports this module)

    name_by_tid = {tid: n for n, tid in milli.inputs.items()
                   if n in set(weight_names)}
    uses: Dict[int, int] = {}
    for node in milli.nodes:
        for i in node.inputs:
            if i is not None:
                uses[i] = uses.get(i, 0) + 1
    outputs_set = set(milli.outputs.values())

    def _cols(rhs_tid: int) -> Optional[int]:
        info = milli.tensors[rhs_tid].info
        dims = info.dims() if info is not None else None
        if dims is None or len(dims) != 2:
            return None
        d = dims[-1]
        try:
            return int(d.value())
        except Exception:
            return None

    # candidate groups keyed by (lhs tid, phase, group, op config)
    groups: Dict[Tuple, List[Tuple[int, Any, str, int]]] = {}
    for idx, node in enumerate(milli.nodes):
        if type(node.op) is not MatMul or len(node.inputs) != 2:
            continue
        lhs, rhs = node.inputs
        nm = name_by_tid.get(rhs)
        if (nm is None or uses.get(rhs, 0) != 1 or rhs in outputs_set
                or node.outputs[0] in outputs_set):
            continue
        cols = _cols(rhs)
        if cols is None or cols % 128:
            # keep fused widths lane-aligned; odd widths stay unfused
            continue
        key = (lhs, node.phase, node.group, node.op.accumulate,
               node.op.out_dtype)
        groups.setdefault(key, []).append((idx, node, nm, cols))

    fused: Dict[str, List[Tuple[str, int]]] = {}
    removed: set = set()
    inserts: Dict[int, List[MilliNode]] = {}
    for key, members in groups.items():
        if len(members) < min_group:
            continue
        lhs, phase, group, acc, odt = key
        names = [m[2] for m in members]
        sizes = [m[3] for m in members]
        fname = f"{names[0]}::fused{len(names)}"
        ftid = milli.add_input(fname)
        out_f = milli.new_tensor(label=fname + "::out")
        mm = MilliNode(new_global_id(),
                       MatMul(accumulate=acc, out_dtype=odt),
                       [lhs, ftid], [out_f], phase, group)
        sp = MilliNode(new_global_id(), Split(axis=-1, sizes=sizes),
                       [out_f], [m[1].outputs[0] for m in members],
                       phase, group)
        inserts[members[0][0]] = [mm, sp]
        removed.update(m[0] for m in members)
        fused[fname] = list(zip(names, sizes))
        for nm in names:
            del milli.inputs[nm]

    if not fused:
        return fused
    new_nodes: List[MilliNode] = []
    for idx, node in enumerate(milli.nodes):
        if idx in inserts:
            new_nodes.extend(inserts[idx])
        if idx not in removed:
            new_nodes.append(node)
    milli.nodes = new_nodes
    return fused


def apply_matmul_fusion(milli: MilliGraph, weight_inputs, store):
    """Convenience wrapper: run fuse_parallel_matmuls and return
    (fused_map, getter) where getter(name, dtype) binds both plain and
    fused weight inputs from a TensorStore (fused = column concat of the
    members). dtype is the dequantized type of a packed weight: F32, the
    store's default, where the reference's default None fails."""
    fused = fuse_parallel_matmuls(milli, set(weight_inputs))

    def get(n: str, dtype: DType = DType.F32) -> np.ndarray:
        if n in fused:
            return np.concatenate(
                [store.get_numeric(m, dtype).numpy()
                 for m, _ in fused[n]], axis=1)
        return store.get_numeric(n, dtype).numpy()

    return fused, get


def pair_cache_writes(milli: MilliGraph) -> int:
    """Merge each layer's K and V cache writes into one KVWrite node.

    Two DynUpdateSlice nodes merge when they share their start tensor,
    both write axis 2 of a 4-D cache, their caches have one shape and
    type, their updates one type and shape (as far as the graph knows
    them; the kernel's wrapper checks the rest), and no node between
    them, nor the second, reads the first one's output. The merged node
    takes the second write's place, where both updates exist, and keeps
    both output tensors, so the graph's new_cache_k_i / new_cache_v_i
    are the same tensors. Exact: the two writes touch different caches.
    Writes that do not pair stay as they are.

    Why: a decode step writes every layer's two caches, and each write is
    a kernel launch and a wrapper call on the host (on the direct path,
    whose start is a scalar, about seven launches of index arithmetic
    and an index_copy_); merged, a layer's writes are one launch.

    Mutates `milli`; returns the number of pairs merged."""
    from .ops import KVWriteMilli   # (milli.ops imports this module)

    def info(tid):
        t = milli.tensors.get(tid)
        return None if t is None else t.info

    def write(node):
        """(cache info, update info) of a node that may pair, or None."""
        if node.op.KIND != "DynUpdateSlice" or len(node.inputs) != 3 \
                or len(node.outputs) != 1:
            return None
        cache = info(node.inputs[0])
        if cache is None or cache.rank != 4 or cache.dims() is None \
                or node.op.axis % 4 != 2:
            return None
        return cache, info(node.inputs[1])

    def agree(a, b) -> bool:
        """The two caches' infos match; the updates' where both known."""
        if a[0].dtype != b[0].dtype or a[0].dims() != b[0].dims():
            return False
        ua, ub = a[1], b[1]
        if ua is None or ub is None:
            return True
        return (ua.dtype == ub.dtype
                and (ua.rank is None or ub.rank is None
                     or ua.rank == ub.rank == 4)
                and (ua.dims() is None or ub.dims() is None
                     or ua.dims() == ub.dims()))

    readers: Dict[int, List[int]] = {}
    for idx, node in enumerate(milli.nodes):
        for t in node.inputs:
            if t is not None:
                readers.setdefault(t, []).append(idx)
    merged: Dict[int, MilliNode] = {}      # second write's index -> node
    removed: set = set()
    for i, first in enumerate(milli.nodes):
        a = write(first)
        if a is None or i in merged:
            continue
        out = first.outputs[0]
        for j in range(i + 1, len(milli.nodes)):
            if any(i < r <= j for r in readers.get(out, ())):
                break
            second = milli.nodes[j]
            b = write(second)
            if (b is None or j in merged or second.inputs[2] != first.inputs[2]
                    or not agree(a, b)):
                continue
            (ck, uk, start), (cv, uv, _) = first.inputs, second.inputs
            merged[j] = MilliNode(new_global_id(), KVWriteMilli(axis=2),
                                  [ck, uk, cv, uv, start],
                                  [out, second.outputs[0]], second.phase,
                                  second.group)
            removed.add(i)
            break
    milli.nodes = [merged.get(j, node) for j, node in enumerate(milli.nodes)
                   if j not in removed]
    return len(merged)


def inject_lora(
    milli: MilliGraph,
    weight_names: Sequence[str],
    rank: int,
    weight_getter,
    alpha: Optional[float] = None,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """LoRA adapter injection by graph surgery.

    Every MatMul whose RHS is a 2-D weight input from `weight_names`
    gains a low-rank bypass: y = x @ W  +  (x @ A) @ B * (alpha/rank),
    with A (K,r) gaussian-init and B (r,N) zero-init (so the adapted
    model starts exactly equal to the base). A/B become new graph inputs
    `<name>::lora_a` / `<name>::lora_b`; the base weight stays a plain
    input, so freezing it is just "don't put it in the trained params".

    Reference equivalent: examples/rwkv_lora_train.rs (adapters trained
    through the milli training artifact). Returns {adapter_name: init}.
    The port's copy of the JAX package's (whisper_tensor_tpu/milli/
    transforms.py:227-329), node for node.
    """
    from .ops import MatMul   # (milli.ops imports this module)
    from .ops.basic import Constant, SimpleBinary

    if alpha is None:
        alpha = float(rank)
    scale = float(alpha) / float(rank)
    rng = np.random.default_rng(seed)
    tid_to_name = {tid: n for n, tid in milli.inputs.items()}
    adapters: Dict[str, np.ndarray] = {}
    # per-weight adapter tids (a weight used by several MatMuls shares
    # one adapter pair, like sharing the base weight)
    ab_tids: Dict[str, Tuple[int, int]] = {}

    i = 0
    while i < len(milli.nodes):
        node = milli.nodes[i]
        if not (isinstance(node.op, MatMul) and len(node.inputs) == 2):
            i += 1
            continue
        rhs_name = tid_to_name.get(node.inputs[1])
        if rhs_name not in weight_names:
            i += 1
            continue
        w = np.asarray(weight_getter(rhs_name))
        if w.ndim != 2:
            i += 1
            continue
        K, N = w.shape
        if rhs_name not in ab_tids:
            a_name, b_name = f"{rhs_name}::lora_a", f"{rhs_name}::lora_b"
            ab_tids[rhs_name] = (milli.add_input(a_name),
                                 milli.add_input(b_name))
            # adapters share the base weight's dtype so the bypass never
            # changes the graph's promotion behavior
            adapters[a_name] = (rng.standard_normal((K, rank))
                                / np.sqrt(K)).astype(w.dtype)
            adapters[b_name] = np.zeros((rank, N), dtype=w.dtype)
        a_tid, b_tid = ab_tids[rhs_name]
        x_tid, orig_out = node.inputs[0], node.outputs[0]
        phase, group = node.phase, node.group

        def _t(label):
            return milli.new_tensor(label=label)

        t_xa = _t(f"{rhs_name}::xa")
        t_xab = _t(f"{rhs_name}::xab")
        new_nodes = [
            MilliNode(new_global_id(), MatMul(), [x_tid, a_tid], [t_xa],
                      phase, group),
            MilliNode(new_global_id(), MatMul(), [t_xa, b_tid], [t_xab],
                      phase, group),
        ]
        bypass = t_xab
        if scale != 1.0:
            t_sc = _t(f"{rhs_name}::lora_scale")
            t_scaled = _t(f"{rhs_name}::xab_scaled")
            new_nodes += [
                MilliNode(new_global_id(),
                          Constant(value=np.asarray(scale, dtype=w.dtype)),
                          [], [t_sc], phase, group),
                MilliNode(new_global_id(), SimpleBinary(mode="mul"),
                          [bypass, t_sc], [t_scaled], phase, group),
            ]
            bypass = t_scaled
        t_out = _t(f"{rhs_name}::lora_out")
        new_nodes.append(MilliNode(new_global_id(),
                                   SimpleBinary(mode="add"),
                                   [orig_out, bypass], [t_out], phase, group))
        # splice right after the MatMul (keeps topological list order),
        # then rewire every later consumer + graph outputs to the sum
        milli.nodes[i + 1:i + 1] = new_nodes
        for later in milli.nodes[i + 1 + len(new_nodes):]:
            later.inputs = [t_out if t == orig_out else t
                            for t in later.inputs]
        for oname, otid in list(milli.outputs.items()):
            if otid == orig_out:
                milli.outputs[oname] = t_out
        i += 1 + len(new_nodes)
    return adapters


def inject_multi_lora(
    milli: MilliGraph,
    adapters: Sequence[Dict[str, Tuple[np.ndarray, np.ndarray, float]]],
    weight_getter,
    idx_input: str = "lora_idx",
) -> Dict[str, np.ndarray]:
    """Per-row LoRA adapter selection by graph surgery (multi-LoRA
    serving).

    adapters: ordered list, one dict per adapter, mapping a milli
    weight-input name to (A (K, r), B (r, N), scale). Every MatMul whose
    RHS is one of those weights gains
        y = x @ W + (x @ As[idx]) @ Bs[idx]
    where As (n+1, K, rmax) / Bs (n+1, rmax, N) stack every adapter
    (slot 0 = zeros = the base model; scale folded into B; ranks
    zero-padded to rmax) as new inputs `<name>::lora_as/bs`, and `idx`
    is a new per-row (batch,) int64 input `lora_idx` selecting each
    row's adapter.

    The selection is computed as the reference computes it: x @ As for
    every slot, masked by one_hot(idx) in the weight's type, then
    contracted with Bs (three Einsum nodes), not a per-row gather.

    Returns {new input name: stacked array} for the adapter inputs."""
    from ..dtype import DType
    from .ops import MatMul   # (milli.ops imports this module)
    from .ops.basic import Cast, Constant, SimpleBinary
    from .ops.einsum import EinsumMilli
    from .ops.shape import Unsqueeze

    targeted = sorted({w for a in adapters for w in a})
    if not targeted:
        return {}
    idx_tid = milli.add_input(idx_input)
    tid_to_name = {tid: n for n, tid in milli.inputs.items()}
    n_slots = len(adapters) + 1
    new_inputs: Dict[str, np.ndarray] = {}
    ab_tids: Dict[str, Tuple[int, int]] = {}
    oh_tids: Dict[Any, int] = {}     # np dtype -> shared one-hot tid

    i = 0
    while i < len(milli.nodes):
        node = milli.nodes[i]
        if not (isinstance(node.op, MatMul) and len(node.inputs) == 2):
            i += 1
            continue
        rhs_name = tid_to_name.get(node.inputs[1])
        if rhs_name not in targeted:
            i += 1
            continue
        w = np.asarray(weight_getter(rhs_name))
        if w.ndim != 2:
            i += 1
            continue
        K, N = w.shape
        if rhs_name not in ab_tids:
            rmax = max(int(np.asarray(a[rhs_name][0]).shape[1])
                       for a in adapters if rhs_name in a)
            As = np.zeros((n_slots, K, rmax), w.dtype)
            Bs = np.zeros((n_slots, rmax, N), w.dtype)
            for s, a in enumerate(adapters):
                if rhs_name not in a:
                    continue
                A, B, scale = a[rhs_name]
                A = np.asarray(A)
                r = int(A.shape[1])
                if A.shape != (K, r):
                    raise ValueError(
                        f"{rhs_name}: A shape {A.shape} != ({K}, r)")
                B = np.asarray(B, np.float32) * float(scale)
                if B.shape != (r, N):
                    raise ValueError(
                        f"{rhs_name}: B shape {B.shape} != ({r}, {N})")
                As[s + 1, :, :r] = A.astype(w.dtype)
                Bs[s + 1, :r, :] = B.astype(w.dtype)
            a_name, b_name = f"{rhs_name}::lora_as", f"{rhs_name}::lora_bs"
            ab_tids[rhs_name] = (milli.add_input(a_name),
                                 milli.add_input(b_name))
            new_inputs[a_name] = As
            new_inputs[b_name] = Bs
        a_tid, b_tid = ab_tids[rhs_name]
        x_tid, orig_out = node.inputs[0], node.outputs[0]
        phase, group = node.phase, node.group

        def _t(label):
            return milli.new_tensor(label=label)

        new_nodes = []
        oh_tid = oh_tids.get(w.dtype)
        if oh_tid is None:
            # shared per-row one-hot(idx) in the weight dtype
            t_iota = _t("lora::iota")
            t_idxu = _t("lora::idxu")
            t_eq = _t("lora::eq")
            oh_tid = _t(f"lora::onehot_{np.dtype(w.dtype).name}")
            new_nodes += [
                MilliNode(new_global_id(),
                          Constant(value=np.arange(n_slots,
                                                   dtype=np.int64)),
                          [], [t_iota], phase, group),
                MilliNode(new_global_id(), Unsqueeze(axes=[1]),
                          [idx_tid], [t_idxu], phase, group),
                MilliNode(new_global_id(), SimpleBinary(mode="eq"),
                          [t_idxu, t_iota], [t_eq], phase, group),
                MilliNode(new_global_id(),
                          Cast(dtype=DType.from_numpy(w.dtype)),
                          [t_eq], [oh_tid], phase, group),
            ]
            oh_tids[w.dtype] = oh_tid
        t_xa = _t(f"{rhs_name}::xa_all")      # (B, n, S, r)
        t_xm = _t(f"{rhs_name}::xa_masked")
        t_xab = _t(f"{rhs_name}::xab")        # (B, S, N)
        t_out = _t(f"{rhs_name}::mlora_out")
        new_nodes += [
            MilliNode(new_global_id(),
                      EinsumMilli(equation="bsk,nkr->bnsr"),
                      [x_tid, a_tid], [t_xa], phase, group),
            MilliNode(new_global_id(),
                      EinsumMilli(equation="bnsr,bn->bnsr"),
                      [t_xa, oh_tid], [t_xm], phase, group),
            MilliNode(new_global_id(),
                      EinsumMilli(equation="bnsr,nrm->bsm"),
                      [t_xm, b_tid], [t_xab], phase, group),
            MilliNode(new_global_id(), SimpleBinary(mode="add"),
                      [orig_out, t_xab], [t_out], phase, group),
        ]
        milli.nodes[i + 1:i + 1] = new_nodes
        for later in milli.nodes[i + 1 + len(new_nodes):]:
            later.inputs = [t_out if t == orig_out else t
                            for t in later.inputs]
        for oname, otid in list(milli.outputs.items()):
            if otid == orig_out:
                milli.outputs[oname] = t_out
        i += 1 + len(new_nodes)
    return new_inputs


@dataclass
class PackedMatMulMilli(MilliOp):
    """x (…,K) float @ dequant(q, scales, offsets) for GGUF blocks kept
    packed on the device (backends/cuda/packed_matmul.py layout).

    inputs: x, q (K//2,N u8 nibble-packed | K,N i8), scales (K//G,N)
    f32, offsets (K//G,N) f32. Reference: QuantMatMul executing GGUF
    without float materialization (src/packed_tensor.rs:96)."""

    bits: int = 4
    # statically elides the offset subtraction for all-zero-offset
    # layouts (Q8_0, plain int8) in the 8-bit kernel path
    has_off: bool = True
    KIND = "PackedMatMul"

    def eval(self, inputs):
        x, q, s, o = inputs
        w = dequant_repacked({"q": np.asarray(q), "scales": np.asarray(s),
                              "offsets": np.asarray(o),
                              "bits": np.int8(self.bits)})
        out = x.astype(np.float32) @ w
        return [out.astype(x.dtype)]

    def infer(self, infos):
        x, q = infos[0], infos[1]
        dx, dq = x.dims(), q.dims()
        if dx is not None and dq is not None:
            return [TensorInfo.shaped(x.dtype, list(dx[:-1]) + [dq[-1]])]
        if x.rank is not None:
            return [TensorInfo.ranked(x.dtype, x.rank)]
        return [TensorInfo.minimal(x.dtype)]


def pack_matmul_nodes(
    milli: MilliGraph,
    weight_names: Sequence[str],
    store,
    sources: Optional[Dict[str, Any]] = None,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Mutate `milli`: every MatMul whose 2-D RHS weight has a packed
    GGUF source recorded in ``store.packed_sources`` becomes
    PackedMatMul with `<name>::pscales` / `<name>::poffsets` inputs;
    the nibble/int8 array feeds under the original weight name. Returns
    {name: repacked device arrays} for the caller to feed.

    This is how GGUF weights execute WITHOUT ever holding a dense float
    copy on the device (reference QuantMatMul path).

    `sources` overrides store.packed_sources: {name: () -> PackedTensor
    | device-layout dict | None} — used by the interface's host-quantize
    path (quantize="q4_0"/"q8_0"/... on ANY dense checkpoint, not just
    GGUF files). A dict (GPTQ/AWQ, reference :554) is the kernel's
    layout already and carries `has_off`."""
    from .ops import MatMul   # (milli.ops imports this module)

    if sources is None:
        sources = getattr(store, "packed_sources", None) or {}
    name_to_tid = dict(milli.inputs)
    packed: Dict[str, Dict[str, np.ndarray]] = {}
    extra_tids: Dict[str, Tuple[int, int]] = {}
    for node in milli.nodes:
        if not isinstance(node.op, MatMul) or len(node.inputs) != 2:
            continue
        rhs = node.inputs[1]
        rhs_name = None
        for name in weight_names:
            if name_to_tid.get(name) == rhs:
                rhs_name = name
                break
        if rhs_name is None or rhs_name not in sources:
            continue
        if rhs_name not in packed:
            pt = sources[rhs_name]()
            if isinstance(pt, dict):     # already in device layout
                rp = pt                  # (GPTQ/AWQ, importers/quantized.py)
            else:
                rp = repack_packed_tensor(pt) if pt is not None else None
            if rp is None:
                continue
            packed[rhs_name] = rp
            extra_tids[rhs_name] = (
                milli.add_input(f"{rhs_name}::pscales"),
                milli.add_input(f"{rhs_name}::poffsets"))
        if rhs_name not in packed:
            continue
        s_tid, o_tid = extra_tids[rhs_name]
        node.op = PackedMatMulMilli(
            bits=int(packed[rhs_name]["bits"]),
            has_off=bool(packed[rhs_name].get("has_off", True)))
        node.inputs = [node.inputs[0], rhs, s_tid, o_tid]
    return packed


@lowering("QuantMatMul")
def quant_matmul(op, inputs, static, device):
    """int8_matmul; Int8MatMul (its backward the int8_matmul_dx kernel)
    when x requires grad under grad mode, as in a QLoRA training step."""
    x, w_i8, scale = inputs
    if x.requires_grad and torch.is_grad_enabled():
        return [Int8MatMul.apply(x, w_i8, scale)]
    return [int8_matmul(x, w_i8, scale)]


@lowering("PackedMatMul")
def packed_matmul_lowering(op, inputs, static, device):
    x, q, scales, offsets = inputs
    return [packed_matmul(x, q, scales, offsets, op.bits, op.has_off)]
