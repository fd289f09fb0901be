"""MilliOpGraph: the simplified mid-level IR.

Functional equivalent of the reference's MilliOpGraph
(src/milli_graph/mod.rs:335+): a flat list of ~40 simple ops with
explicit ordering, named external inputs/outputs, group/phase metadata,
shape/dtype inference (`infer_all`), and an interpreter (`eval`), the
CPU correctness oracle. The port runs a graph on torch tensors through
backends/torch_exec (GraphExecutor), with the lowerings keyed by
`MilliOp.KIND` in milli/registry.py.

The port's copy of whisper_tensor_tpu/milli/ir.py, without `to_jax`.
The ops' reverse-mode `backward` rules (milli/autodiff.py) are the
reference's.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..graph import Introspectable, new_global_id
from ..tensor_info import Level, TensorInfo


class Phase(enum.Enum):
    """Op-group phase tags for training graphs (reference MilliOpPhase,
    src/milli_graph/mod.rs:63-86)."""

    FORWARD = "forward"
    LOSS = "loss"
    BACKWARD = "backward"
    OPTIMIZER = "optimizer"
    CUSTOM = "custom"


@dataclass
class MilliTensor:
    id: int
    info: Optional[TensorInfo] = None
    label: Optional[str] = None
    # provenance: the symbolic-graph tensor this derives from (introspection)
    source_tensor: Optional[int] = None


@dataclass
class MilliNode:
    id: int
    op: "MilliOp"
    inputs: List[int]
    outputs: List[int]
    phase: Phase = Phase.FORWARD
    group: Optional[str] = None


class MilliOp(Introspectable):
    """Base class for milli ops.

    Subclasses implement:
      * ``eval(inputs) -> outputs`` — numpy oracle semantics (bit-exact
        dtype behavior; bf16/f16/f8 compute in f32 then round back).
      * ``infer(infos) -> infos`` — symbolic-aware inference. Returning
        *less* knowledge is always legal; contradicting eval is not
        (validated by validate_infer).
      * ``backward(b, node, grads) -> per-input grad ids`` — symbolic
        reverse-mode rule (reference MilliOp::backward).
    """

    KIND = "?"
    N_OUTPUTS = 1

    def eval(self, inputs: List[np.ndarray]) -> List[np.ndarray]:
        raise NotImplementedError(f"{self.KIND}.eval")

    def infer(self, infos: List[TensorInfo]) -> List[TensorInfo]:
        """Default: try full constant-fold eval when every input is NUMERIC."""
        vals = []
        for fi in infos:
            if fi.level is not Level.NUMERIC:
                raise NotImplementedError
            vals.append(fi.value)
        outs = self.eval(vals)
        return [TensorInfo.numeric(o) for o in outs]

    def backward(
        self,
        b: "MilliGraph",
        node: MilliNode,
        out_grads: List[Optional[int]],
    ) -> List[Optional[int]]:
        raise NotImplementedError(f"{self.KIND} has no backward rule")

    def display_name(self) -> str:
        return self.KIND


class MilliGraph:
    """Graph + builder in one (graphs are built mutably, then frozen by use)."""

    def __init__(self, name: str = "") -> None:
        self.id = new_global_id()
        self.name = name
        self.tensors: Dict[int, MilliTensor] = {}
        self.nodes: List[MilliNode] = []
        self.inputs: Dict[str, int] = {}
        self.outputs: Dict[str, int] = {}
        self._next_tid = 0

    # -- construction ---------------------------------------------------
    def new_tensor(self, label: Optional[str] = None, info: Optional[TensorInfo] = None,
                   source_tensor: Optional[int] = None) -> int:
        tid = self._next_tid
        self._next_tid += 1
        self.tensors[tid] = MilliTensor(tid, info, label, source_tensor)
        return tid

    def add_input(self, name: str, info: Optional[TensorInfo] = None) -> int:
        tid = self.new_tensor(label=name, info=info)
        self.inputs[name] = tid
        return tid

    def mark_output(self, name: str, tid: int) -> None:
        self.outputs[name] = tid

    def add_op(self, op: MilliOp, inputs: Sequence[int], n_outputs: Optional[int] = None,
               phase: Phase = Phase.FORWARD, group: Optional[str] = None,
               labels: Optional[Sequence[Optional[str]]] = None) -> List[int]:
        n_out = n_outputs if n_outputs is not None else op.N_OUTPUTS
        outs = [
            self.new_tensor(label=(labels[i] if labels else None))
            for i in range(n_out)
        ]
        self.nodes.append(MilliNode(new_global_id(), op, list(inputs), outs, phase, group))
        return outs

    def op1(self, op: MilliOp, *inputs: int, phase: Phase = Phase.FORWARD,
            group: Optional[str] = None) -> int:
        """Convenience: add a single-output op, return the output id."""
        return self.add_op(op, list(inputs), phase=phase, group=group)[0]

    # -- composition ------------------------------------------------------
    def merge_graph(self, other: "MilliGraph", input_map: Dict[str, int]) -> Dict[str, int]:
        """Splice `other` into self; its named inputs are fed by `input_map`
        (name -> tensor id in self). Returns other's outputs mapped into
        self's id space. (Reference merge_graph, src/milli_graph/mod.rs:441.)
        """
        remap: Dict[int, int] = {}
        for name, tid in other.inputs.items():
            if name not in input_map:
                raise KeyError(f"merge_graph: missing input {name!r}")
            remap[tid] = input_map[name]
        for node in other.nodes:
            new_outs = []
            for o in node.outputs:
                t = other.tensors[o]
                nid = self.new_tensor(t.label, t.info, t.source_tensor)
                remap[o] = nid
                new_outs.append(nid)
            self.nodes.append(MilliNode(
                new_global_id(), node.op, [remap[i] for i in node.inputs],
                new_outs, node.phase, node.group))
        return {name: remap[tid] for name, tid in other.outputs.items()}

    # -- execution (CPU oracle interpreter) -------------------------------
    def eval(
        self,
        feeds: Dict[str, np.ndarray],
        observer: Optional["MilliObserver"] = None,
        validate: bool = False,
        capture: Optional[Callable[[int, np.ndarray], None]] = None,
        op_impl: Optional[Callable[["MilliOp", List], Optional[List]]] = None,
    ) -> Dict[str, np.ndarray]:
        """op_impl: optional alternate per-op executor, called as
        op_impl(op, inputs); returning None falls back to the op's
        numpy oracle eval."""
        values: Dict[int, np.ndarray] = {}
        for name, tid in self.inputs.items():
            if name not in feeds:
                raise KeyError(f"missing graph input {name!r}")
            values[tid] = np.asarray(feeds[name])

        # refcount tensor lifetimes so intermediates free eagerly
        refcount: Dict[int, int] = {}
        for node in self.nodes:
            for i in node.inputs:
                if i is not None:
                    refcount[i] = refcount.get(i, 0) + 1
        keep = set(self.outputs.values())

        for node in self.nodes:
            try:
                ins = [values[i] if i is not None else None for i in node.inputs]
            except KeyError as e:
                raise RuntimeError(
                    f"milli op {node.op.KIND} consumes tensor {e} before production"
                ) from e
            t0 = time.perf_counter()
            try:
                outs = op_impl(node.op, ins) if op_impl is not None else None
                if outs is None:
                    outs = node.op.eval(ins)
            except Exception as e:
                shapes = [tuple(x.shape) for x in ins]
                dts = [str(x.dtype) for x in ins]
                raise RuntimeError(
                    f"milli op {node.op.KIND} failed (inputs shapes={shapes} dtypes={dts}): {e}"
                ) from e
            dt_ms = (time.perf_counter() - t0) * 1e3
            if len(outs) != len(node.outputs):
                raise RuntimeError(f"{node.op.KIND}: produced {len(outs)} outputs, expected {len(node.outputs)}")
            for tid, arr in zip(node.outputs, outs):
                arr = np.asarray(arr)
                if validate:
                    self._check_matches(tid, arr, node)
                values[tid] = arr
                if capture is not None:
                    capture(tid, arr)
                if observer is not None:
                    observer.on_tensor_assigned(self, tid, arr)
            if observer is not None:
                observer.on_op_executed(self, node, dt_ms)
                if observer.should_cancel():
                    raise EvalCancelled()
            for i in node.inputs:
                if i is None:
                    continue
                refcount[i] -= 1
                if refcount[i] == 0 and i not in keep and i not in self.inputs.values():
                    values.pop(i, None)

        out = {}
        for name, tid in self.outputs.items():
            if tid not in values:
                raise RuntimeError(f"output {name!r} (tensor {tid}) never produced")
            out[name] = values[tid]
        return out

    def _check_matches(self, tid: int, arr: np.ndarray, node: MilliNode) -> None:
        """Per-tensor shape/dtype validation (reference check_tensor_matches,
        src/symbolic_graph/mod.rs:206)."""
        info = self.tensors[tid].info
        if info is None:
            return
        truth = TensorInfo.numeric(arr)
        if not info.consistent_with(truth):
            raise RuntimeError(
                f"validation failed for tensor {tid} ({self.tensors[tid].label}) "
                f"from {node.op.KIND}: declared {info}, got {truth}")

    # -- inference ----------------------------------------------------------
    def infer_all(self, input_infos: Dict[str, TensorInfo]) -> Dict[int, TensorInfo]:
        """Propagate TensorInfo through the graph (reference infer_all,
        src/milli_graph/mod.rs:997). Ops that cannot infer yield MINIMAL-
        or weaker info; this never raises for coverage gaps."""
        infos: Dict[int, TensorInfo] = {}
        for name, tid in self.inputs.items():
            if name in input_infos:
                infos[tid] = input_infos[name]
                if self.tensors[tid].info is None:
                    self.tensors[tid].info = input_infos[name]
        for node in self.nodes:
            ins = [infos.get(i) if i is not None else None for i in node.inputs]
            outs: Optional[List[TensorInfo]] = None
            if all(x is not None or i is None
                   for x, i in zip(ins, node.inputs)):
                try:
                    outs = node.op.infer(ins)  # type: ignore[arg-type]
                except NotImplementedError:
                    outs = None
                except Exception:
                    outs = None
            if outs is None:
                continue
            for tid, oi in zip(node.outputs, outs):
                if oi is not None:
                    infos[tid] = oi
                    if self.tensors[tid].info is None:
                        self.tensors[tid].info = oi
        return infos

    # -- introspection -------------------------------------------------------
    def intermediate_labels(self) -> Dict[int, str]:
        return {tid: t.label for tid, t in self.tensors.items() if t.label}

    def op_census(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for n in self.nodes:
            out[n.op.KIND] = out.get(n.op.KIND, 0) + 1
        return out

    def __repr__(self) -> str:
        return (f"MilliGraph({self.name!r}, {len(self.nodes)} ops, "
                f"{len(self.inputs)} in, {len(self.outputs)} out)")


class EvalCancelled(RuntimeError):
    pass


class MilliObserver:
    """Observer protocol (reference src/milli_graph/observer.rs:7-24)."""

    def on_op_executed(self, graph: MilliGraph, node: MilliNode, ms: float) -> None:
        pass

    def on_tensor_assigned(self, graph: MilliGraph, tid: int, value: np.ndarray) -> None:
        pass

    def should_cancel(self) -> bool:
        return False
