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

Two kinds of graph need more than shapes in the plan's key:
  * A lowering that needs a host value the fold did not give it (a
    Reshape shape, Slice bounds, Reduce axes or a TopK k fed as a graph
    input) raises NeedsStatic. The executor then LIFTS the graph inputs
    that value depends on: they fold as host values from then on, and
    their values join the plan's key, so a plan built for axes [1] never
    replays for axes [0]. The reference lifts small integer feeds the
    same way (backends/eval_backend.py:283-318).
  * An op whose output shape depends on the data (NonZero, Compress,
    Unique) makes every shape read after it data-dependent: a plan that
    folded such a Shape or SizeOf is not kept, and the next run builds
    afresh.

An input that requires grad under grad mode is never lifted: the
executor raises instead, since the host value would carry no gradient.
Everything else runs on torch tensors, so autograd differentiates a
graph the executor runs (training/trainer.py).

Taps (the reference's `compile_milli(capture_labels=)`,
backends/xla/compiler.py:273-277): `GraphExecutor(graph, device,
taps=labels)` also reports the values of the milli tensors with those
labels (a symbolic graph's tensor names). The set is fixed when the
executor is made, so it never keys a plan: the plan records where each
tap's value appears (a graph input, a folded value, or the output of a
device step) and `run` returns a copy of it taken at that point, so a
later in-place write (a cache write into the tensor it is handed)
cannot change it. A replayed plan reports the same taps as the run that
built it. An executor without taps replays as before.

There is no oracle fallback: a node that has to run on the device and
has no lowering raises NotImplementedError naming its KIND.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...dtype import to_device, to_host
from ...milli.ir import MilliGraph
from ...milli.ops import LOWERINGS
from ...milli.registry import NeedsStatic

_FOLD_BLOCKLIST = {"RandomNormalLike", "Bernoulli", "Dropout"}
_SHAPE_ONLY_OPS = {"Shape", "SizeOf"}
_DATA_SHAPED_OPS = {"NonZero", "Compress", "Unique"}
_FOLD_MAX_ELEMENTS = 1 << 16     # fold small host-side shape math only
_LIFT_MAX_ELEMENTS = 1 << 16     # graph inputs that may be lifted

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
        # False once a shape of a data-shaped value was folded
        self.replayable = True
        # taps whose value exists before the first step (inputs, folded
        # values), and those each step makes: (label, tensor id) lists
        self.tap_start: List[Tuple[str, int]] = []
        self.tap_after: Dict[int, List[Tuple[str, int]]] = {}


class _LiftInputs(Exception):
    """A build needs these graph inputs as host values."""

    def __init__(self, names):
        self.names = names


def _host_dummy(t: torch.Tensor) -> np.ndarray:
    """A zero-strided host stand-in with t's shape: shape-only ops read
    nothing else."""
    return np.broadcast_to(np.zeros((), np.float32), tuple(t.shape))


class GraphExecutor:
    """Executes `graph` on `device`; call with {input name: tensor}.

    Inputs are used as given: a lowering may write into one in place
    (DynUpdateSlice writes into the cache it is handed). `taps`: labels
    of milli tensors whose values `run` reports as well; a label the
    graph lacks is left out (`tap_labels` lists those found)."""

    def __init__(self, graph: MilliGraph, device: torch.device,
                 taps: Sequence[str] = ()):
        self.graph = graph
        self.device = device
        self.input_names = list(graph.inputs)
        self._plans: Dict[PlanKey, _Plan] = {}
        self._lifted: List[str] = []   # inputs whose values key a plan
        by_label = {t.label: tid for tid, t in graph.tensors.items()
                    if t.label}
        self._taps: Dict[int, List[str]] = {}
        for lbl in sorted(set(taps)):
            if lbl in by_label:
                self._taps.setdefault(by_label[lbl], []).append(lbl)
        self.tap_labels = [lbl for lbls in self._taps.values()
                           for lbl in lbls]

    def _key(self, feeds) -> PlanKey:
        key = tuple((tuple(feeds[n].shape), feeds[n].dtype)
                    for n in self.input_names)
        if self._lifted:
            key += tuple(_value_key(feeds[n]) for n in self._lifted)
        return key

    def __call__(self, feeds: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        return self.run(feeds)[0]

    def run(self, feeds: Dict[str, torch.Tensor]):
        """(outputs, taps): {output name: tensor}, {tap label: a copy of
        its value where it was made}."""
        args = [feeds[n] for n in self.input_names]
        plan = self._plans.get(self._key(feeds))
        taps: Dict[str, torch.Tensor] = {}
        if plan is None:
            # two threads may build one key at once (the batcher's loop
            # and an HTTP thread rescoring logprobs): each builds from
            # local state, and either plan serves later calls
            while True:
                try:
                    plan, vals = self._build(args, taps)
                    break
                except _LiftInputs as need:
                    self._lifted = sorted(set(self._lifted) | need.names)
            if plan.replayable:
                self._plans[self._key(feeds)] = plan
        else:
            vals = dict(plan.consts)
            for tid, a in zip(self.graph.inputs.values(), args):
                vals[tid] = a
            for lbl, tid in plan.tap_start:
                taps[lbl] = vals[tid].clone()
            tap_after = plan.tap_after
            for k, st in enumerate(plan.steps):
                ins = [None if i is None else vals[i] for i in st.inputs]
                for tid, o in zip(st.outputs, st.fn(st.op, ins, st.static,
                                                    self.device)):
                    vals[tid] = o
                if tap_after:
                    for lbl, tid in tap_after.get(k, ()):
                        taps[lbl] = vals[tid].clone()
        return {n: vals[t] for n, t in self.graph.outputs.items()}, taps

    # ------------------------------------------------------------------
    def _build(self, args: List[torch.Tensor],
               taps: Optional[Dict[str, torch.Tensor]] = None):
        """First run for these shapes: fold, execute, record the plan;
        the taps' values go into `taps`."""
        plan = _Plan()
        vals: Dict[int, torch.Tensor] = {}
        statics: Dict[int, np.ndarray] = {}
        if taps is None:
            taps = {}
        taps.clear()
        # graph inputs each device value depends on, and the values whose
        # shape depends on data
        deps: Dict[int, frozenset] = {}
        data_shaped: set = set()
        for (name, tid), a in zip(self.graph.inputs.items(), args):
            vals[tid] = a
            deps[tid] = frozenset([name])
            if name in self._lifted:
                statics[tid] = _lifted_value(name, a)
            for lbl in self._taps.get(tid, ()):
                plan.tap_start.append((lbl, tid))
                taps[lbl] = a.clone()

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
                if any(i in data_shaped for i in node.inputs):
                    plan.replayable = False
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
            try:
                outs = fn(node.op, ins, in_statics, self.device)
            except NeedsStatic as e:
                need = deps.get(node.inputs[e.index], frozenset())
                names = {n for n in need if n not in self._lifted
                         and _small(args[self.input_names.index(n)])}
                for n in names:
                    _lifted_value(n, args[self.input_names.index(n)])
                if not names or names != set(need) - set(self._lifted):
                    raise NotImplementedError(
                        f"{e} (node {node.id}): it depends on no graph "
                        f"input that can be lifted to a host value") from e
                raise _LiftInputs(names) from e
            if len(outs) != len(node.outputs):
                raise RuntimeError(f"lowering of {kind} returned "
                                   f"{len(outs)} outputs, graph has "
                                   f"{len(node.outputs)}")
            plan.steps.append(step)
            dep = frozenset().union(*(deps.get(i, frozenset())
                                      for i in node.inputs if i is not None))
            shaped = kind in _DATA_SHAPED_OPS or any(
                i in data_shaped for i in node.inputs if i is not None)
            for tid, o in zip(node.outputs, outs):
                vals[tid] = o
                deps[tid] = dep
                if shaped:
                    data_shaped.add(tid)
                for lbl in self._taps.get(tid, ()):
                    plan.tap_after.setdefault(len(plan.steps) - 1, []).append(
                        (lbl, tid))
                    taps[lbl] = o.clone()
        for t in self.graph.outputs.values():
            lift(t)
        made = {tid for k in plan.tap_after.values() for _, tid in k}
        for tid, lbls in self._taps.items():
            if tid not in made and tid not in self.graph.inputs.values():
                # a folded value: uploaded with the plan's constants
                for lbl in lbls:
                    plan.tap_start.append((lbl, tid))
                    taps[lbl] = lift(tid).clone()
        return plan, vals


def _lifted_value(name: str, t: torch.Tensor) -> np.ndarray:
    """A lifted input's host value; an input that requires grad is never
    lifted (its host copy would carry no gradient)."""
    if t.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            f"graph input {name!r} requires grad, but a lowering needs it "
            f"as a host value: lifting it would drop its gradient")
    return to_host(t)


def _small(t: torch.Tensor) -> bool:
    return t.numel() <= _LIFT_MAX_ELEMENTS


def _value_key(t: torch.Tensor):
    """A lifted input's value, as a plan-key part."""
    return (str(t.dtype), tuple(t.shape), to_host(t).tobytes())
