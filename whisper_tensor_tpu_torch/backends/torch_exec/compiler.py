"""Run a MilliGraph eagerly on PyTorch tensors.

Counterpart of whisper_tensor_tpu/backends/xla/compiler.py:93-161
(`_trace_graph`). The reference traces the graph once into a jitted XLA
program; on the way it folds on the host every value that does not
depend on the inputs' data:
  * shape-only ops (Shape, SizeOf) of a traced value, from its shape;
  * any op whose inputs are all folded (constants, shape arithmetic),
    through the op's numpy `eval`, up to 64k elements.
Folded values reach the lowerings as `static` (a Reshape target, Split
sizes, a Range bound), which keeps every shape static.

Eager PyTorch has no trace, so the folding runs once per PLAN: the
first run for a set of input shapes and dtypes executes the graph while
it folds, and records which nodes fold, their values, and the device
steps that remain. Later runs with the same shapes replay the device
steps only. Folded values that a device step or an output needs are
uploaded once per plan.

There is no oracle fallback: a node that has to run on the device and
has no lowering raises NotImplementedError naming its KIND.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...dtype import to_device
from ...milli.ir import MilliGraph
from ...milli.ops import LOWERINGS

_FOLD_BLOCKLIST = {"RandomNormalLike"}
_SHAPE_ONLY_OPS = {"Shape", "SizeOf"}
_FOLD_MAX_ELEMENTS = 1 << 16     # fold small host-side shape math only

PlanKey = Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]


class _Step:
    """One node that runs on the device."""

    __slots__ = ("fn", "op", "inputs", "static", "outputs")

    def __init__(self, fn: Callable, op, inputs: List[Optional[int]],
                 static: List[Optional[np.ndarray]], outputs: List[int]):
        self.fn, self.op, self.inputs = fn, op, inputs
        self.static, self.outputs = static, outputs


class _Plan:
    def __init__(self):
        self.steps: List[_Step] = []
        self.consts: Dict[int, torch.Tensor] = {}   # uploaded folded values


def _host_dummy(t: torch.Tensor) -> np.ndarray:
    """A zero-strided host stand-in with t's shape: shape-only ops read
    nothing else."""
    return np.broadcast_to(np.zeros((), np.float32), tuple(t.shape))


class GraphExecutor:
    """Executes `graph` on `device`; call with {input name: tensor}.

    Inputs are used as given: a lowering may write into one in place
    (DynUpdateSlice writes into the cache it is handed)."""

    def __init__(self, graph: MilliGraph, device: torch.device):
        self.graph = graph
        self.device = device
        self.input_names = list(graph.inputs)
        self._plans: Dict[PlanKey, _Plan] = {}

    def __call__(self, feeds: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        args = [feeds[n] for n in self.input_names]
        key = tuple((tuple(a.shape), a.dtype) for a in args)
        plan = self._plans.get(key)
        if plan is None:
            # two threads may build one key at once (the batcher's loop
            # and an HTTP thread rescoring logprobs): each builds from
            # local state, and either plan serves later calls
            plan, vals = self._build(args)
            self._plans[key] = plan
        else:
            vals = dict(plan.consts)
            for tid, a in zip(self.graph.inputs.values(), args):
                vals[tid] = a
            for st in plan.steps:
                ins = [None if i is None else vals[i] for i in st.inputs]
                for tid, o in zip(st.outputs,
                                  st.fn(st.op, ins, st.static, self.device)):
                    vals[tid] = o
        return {n: vals[t] for n, t in self.graph.outputs.items()}

    # ------------------------------------------------------------------
    def _build(self, args: List[torch.Tensor]):
        """First run for these shapes: fold, execute, record the plan."""
        plan = _Plan()
        vals: Dict[int, torch.Tensor] = {}
        statics: Dict[int, np.ndarray] = {}
        for tid, a in zip(self.graph.inputs.values(), args):
            vals[tid] = a

        def lift(tid: int) -> torch.Tensor:
            if tid not in vals:
                vals[tid] = plan.consts[tid] = to_device(statics[tid],
                                                         self.device)
            return vals[tid]

        for node in self.graph.nodes:
            kind = node.op.KIND
            in_statics = [statics.get(i) if i is not None else None
                          for i in node.inputs]
            if kind in _SHAPE_ONLY_OPS and any(
                    s is None and i is not None
                    for s, i in zip(in_statics, node.inputs)):
                dummies = [s if s is not None or i is None
                           else _host_dummy(vals[i])
                           for s, i in zip(in_statics, node.inputs)]
                for tid, f in zip(node.outputs, node.op.eval(dummies)):
                    statics[tid] = np.asarray(f)
                continue
            if kind not in _FOLD_BLOCKLIST and all(
                    s is not None or i is None
                    for s, i in zip(in_statics, node.inputs)):
                folded = [np.asarray(f) for f in node.op.eval(in_statics)]
                if all(f.size <= _FOLD_MAX_ELEMENTS for f in folded):
                    for tid, f in zip(node.outputs, folded):
                        statics[tid] = f
                    continue
                # too big to keep on the host: a per-plan device constant
                for tid, f in zip(node.outputs, folded):
                    vals[tid] = plan.consts[tid] = to_device(f, self.device)
                continue
            fn = LOWERINGS.get(kind)
            if fn is None:
                raise NotImplementedError(
                    f"milli op {kind} has no PyTorch lowering in the port "
                    f"(node {node.id}); the port has no oracle fallback")
            ins = [lift(i) if i is not None else None for i in node.inputs]
            step = _Step(fn, node.op, list(node.inputs), in_statics,
                         list(node.outputs))
            outs = fn(node.op, ins, in_statics, self.device)
            if len(outs) != len(node.outputs):
                raise RuntimeError(f"lowering of {kind} returned "
                                   f"{len(outs)} outputs, graph has "
                                   f"{len(node.outputs)}")
            plan.steps.append(step)
            for tid, o in zip(node.outputs, outs):
                vals[tid] = o
        for t in self.graph.outputs.values():
            lift(t)
        return plan, vals
