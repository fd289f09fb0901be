"""Control-flow symbolic ops: If, Scan, Loop.

Reference equivalents: src/symbolic_graph/ops/misc.rs:84 (IfOperation)
and ops/scan.rs:16 (ScanOperation). These hold nested SymbolicGraphs and
execute directly in the interpreter (`eval_direct`); they are the ops
the whole-graph XLA lowering partitions around. (LLM decode loops do NOT
go through ONNX Scan in this framework — the SuperGraph compiles decode
to lax.scan directly.)

The port's copy of whisper_tensor_tpu/symbolic_graph/ops/control.py,
with the ONNX re-export hooks (`sub_graph_attrs`, `to_onnx_attrs`) that
symbolic_graph/export.py reads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from .base import Operation, register


@register("If")
class If(Operation):
    def __init__(self):
        self.then_graph = None
        self.else_graph = None

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls()

    def _bind_subgraphs(self, node, attrs, resolver, store, opsets, base_dir):
        from ..ir import SymbolicGraph

        self.then_graph = SymbolicGraph._from_graph_proto(
            attrs.g("then_branch"), resolver, store, opsets, base_dir)
        self.else_graph = SymbolicGraph._from_graph_proto(
            attrs.g("else_branch"), resolver, store, opsets, base_dir)

    def sub_graphs(self):
        return [g for g in (self.then_graph, self.else_graph) if g is not None]

    def sub_graph_attrs(self):
        return {k: g for k, g in (("then_branch", self.then_graph),
                                  ("else_branch", self.else_graph))
                if g is not None}

    def eval_direct(self, backend, inputs: List[np.ndarray],
                    outer_env: Dict[str, np.ndarray], n_outputs: int) -> List[np.ndarray]:
        cond = bool(np.asarray(inputs[0]).reshape(-1)[0])
        g = self.then_graph if cond else self.else_graph
        out = backend.run(g, {}, outer_env=outer_env)
        return [out[g.tensors[t].name] for t in g.outputs][:n_outputs]


@register("Scan")
@dataclass
class Scan(Operation):
    num_scan_inputs: int = 1
    scan_input_directions: Optional[List[int]] = None
    scan_output_directions: Optional[List[int]] = None
    scan_input_axes: Optional[List[int]] = None
    scan_output_axes: Optional[List[int]] = None

    def __post_init__(self):
        self.body = None

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("num_scan_inputs", 1),
                   attrs.ints("scan_input_directions", None),
                   attrs.ints("scan_output_directions", None),
                   attrs.ints("scan_input_axes", None),
                   attrs.ints("scan_output_axes", None))

    def _bind_subgraphs(self, node, attrs, resolver, store, opsets, base_dir):
        from ..ir import SymbolicGraph

        self.body = SymbolicGraph._from_graph_proto(
            attrs.g("body"), resolver, store, opsets, base_dir)

    def sub_graphs(self):
        return [self.body] if self.body is not None else []

    def sub_graph_attrs(self):
        return {"body": self.body} if self.body is not None else {}
    def sub_graph_attrs(self):
        return {"body": self.body} if self.body is not None else {}

    def to_onnx_attrs(self):
        return {"num_scan_inputs": self.num_scan_inputs,
                "scan_input_directions": self.scan_input_directions,
                "scan_output_directions": self.scan_output_directions,
                "scan_input_axes": self.scan_input_axes,
                "scan_output_axes": self.scan_output_axes}

    def eval_direct(self, backend, inputs: List[np.ndarray],
                    outer_env: Dict[str, np.ndarray], n_outputs: int) -> List[np.ndarray]:
        m = self.num_scan_inputs
        n_state = len(inputs) - m
        state = [np.asarray(v) for v in inputs[:n_state]]
        scans = [np.asarray(v) for v in inputs[n_state:]]
        in_axes = self.scan_input_axes or [0] * m
        in_dirs = self.scan_input_directions or [0] * m
        body = self.body
        body_in_names = [body.tensors[t].name for t in body.inputs]
        body_out_names = [body.tensors[t].name for t in body.outputs]
        n_scan_out = len(body_out_names) - n_state
        steps = scans[0].shape[in_axes[0] % scans[0].ndim]
        collected: List[List[np.ndarray]] = [[] for _ in range(n_scan_out)]
        for it in range(steps):
            feeds = {}
            for name, s in zip(body_in_names[:n_state], state):
                feeds[name] = s
            for j in range(m):
                ax = in_axes[j] % scans[j].ndim
                idx = steps - 1 - it if in_dirs[j] else it
                feeds[body_in_names[n_state + j]] = np.take(scans[j], idx, axis=ax)
            out = backend.run(body, feeds, outer_env=outer_env)
            state = [np.asarray(out[n]) for n in body_out_names[:n_state]]
            for k in range(n_scan_out):
                collected[k].append(np.asarray(out[body_out_names[n_state + k]]))
        out_axes = self.scan_output_axes or [0] * n_scan_out
        out_dirs = self.scan_output_directions or [0] * n_scan_out
        outs = list(state)
        for k in range(n_scan_out):
            seq = collected[k][::-1] if out_dirs[k] else collected[k]
            ax = out_axes[k]
            outs.append(np.stack(seq, axis=ax % (seq[0].ndim + 1)))
        return outs[:n_outputs]


@register("Loop")
class Loop(Operation):
    """ONNX Loop: trip-count + cond driven. Interpreter-only."""

    def __init__(self):
        self.body = None

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls()

    def _bind_subgraphs(self, node, attrs, resolver, store, opsets, base_dir):
        from ..ir import SymbolicGraph

        self.body = SymbolicGraph._from_graph_proto(
            attrs.g("body"), resolver, store, opsets, base_dir)

    def sub_graphs(self):
        return [self.body] if self.body is not None else []


    def eval_direct(self, backend, inputs: List[np.ndarray],
                    outer_env: Dict[str, np.ndarray], n_outputs: int) -> List[np.ndarray]:
        from .sequence import OptionalVal

        def _coerce(v):
            # sequence/optional loop state stays a host container
            return v if isinstance(v, (list, OptionalVal)) else np.asarray(v)

        body = self.body
        max_trip = inputs[0]
        cond = inputs[1]
        state = [_coerce(v) for v in inputs[2:]]
        n_state = len(state)
        body_in_names = [body.tensors[t].name for t in body.inputs]
        body_out_names = [body.tensors[t].name for t in body.outputs]
        n_scan_out = len(body_out_names) - 1 - n_state
        max_n = int(np.asarray(max_trip).reshape(-1)[0]) if max_trip is not None and np.asarray(max_trip).size else np.iinfo(np.int64).max
        c = bool(np.asarray(cond).reshape(-1)[0]) if cond is not None and np.asarray(cond).size else True
        collected: List[List[np.ndarray]] = [[] for _ in range(n_scan_out)]
        it = 0
        while c and it < max_n:
            feeds = {body_in_names[0]: np.asarray(it, dtype=np.int64),
                     body_in_names[1]: np.asarray(c)}
            for name, s in zip(body_in_names[2:], state):
                feeds[name] = s
            out = backend.run(body, feeds, outer_env=outer_env)
            c = bool(np.asarray(out[body_out_names[0]]).reshape(-1)[0])
            state = [_coerce(out[n]) for n in body_out_names[1:1 + n_state]]
            for k in range(n_scan_out):
                collected[k].append(np.asarray(out[body_out_names[1 + n_state + k]]))
            it += 1
        outs = list(state)
        for k in range(n_scan_out):
            outs.append(np.stack(collected[k], axis=0) if collected[k]
                        else np.zeros((0,), dtype=np.float32))
        return outs[:n_outputs]
