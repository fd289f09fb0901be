"""EvalBackend: execution dispatch over a SymbolicGraph.

The port's copy of whisper_tensor_tpu/backends/eval_backend.py (:44-325)
with the XLA mode replaced by a torch mode. Two modes:

  * "oracle": the numpy interpreter, op by op, with validation of every
    assignment, the observer protocol and cancellation;
  * "torch": the whole graph lowered once to a MilliGraph and run by
    GraphExecutor (backends/torch_exec) on the backend's device.

A graph with control flow runs its If/Scan/Loop on the host and their
nested graphs through the selected mode, as in the reference; in torch
mode the other nodes of such a graph run on the device too, one node at a
time. A graph that `needs_host_eval` (STRING tensors, sequence and
optional containers, `ai.onnx.ml` nodes) runs in the interpreter in both
modes: torch has no string or ragged container type. `last_path` records
which path served the last run: "torch" (one graph on the device),
"torch-control" (control flow on the host, every other node and every
nested graph on the device) or "oracle" (the numpy interpreter). There is
no other fallback: a node without a lowering raises NotImplementedError
naming its KIND. The reference's segmented XLA path (xla/segmented.py) is
a workaround for its missing host callbacks and has no counterpart here.

`capture` (reference :44-70, reported at :319-321): labels of tensors
inside the lowered graph (a symbolic graph's tensor names) that the
torch path reports through `observer.on_tensor_assigned` after each run,
as taps of the graph's GraphExecutor: fixed when the executor is made,
so a label that is not chosen costs nothing, and each value a copy taken
where it was made. The interpreter reports every assignment, as in the
reference. `derive` makes a backend with its own observer and taps that
shares the lowered graph, the device weights and the executors, which
are kept by the labels the lowered graph holds: one without taps, and
the TAPPED_EXECUTORS most recently used tap sets. `bind` runs a graph as
a lowered copy that its owner transformed, over that owner's device
weights: the text interface binds its int8 graph
(TextInferenceInterface.eval_backend).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Dict, FrozenSet, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..dtype import DType, to_device, to_host, to_torch
from ..milli.ir import EvalCancelled, MilliGraph
from ..symbolic_graph.ir import SymbolicGraph
from ..symbolic_graph.ops.base import LowerCtx
from ..tensor_info import TensorInfo
from .torch_exec.compiler import GraphExecutor

# executors with taps kept beside each graph's untapped one, the least
# recently used dropped first
TAPPED_EXECUTORS = 4


class SymbolicObserver:
    """Observer protocol (reference src/symbolic_graph/observer.rs:7-25)."""

    def on_op_executed(self, graph, sop, ms: float) -> None:
        pass

    def on_tensor_assigned(self, graph, name: str, value) -> None:
        pass

    def on_loading_weight(self, name: str) -> None:
        pass

    def should_cancel(self) -> bool:
        return False


def mode_device(mode: str, device=None) -> torch.device:
    """The device an interface of `mode` keeps its tensors on: `device`
    for "torch"; the CPU for "oracle", whose interpreter hands its outputs
    over there (run_on_device)."""
    if mode not in ("oracle", "torch"):
        raise ValueError(f"unknown mode {mode!r} (oracle or torch)")
    return resolve_device("cpu" if mode == "oracle" else device)


def _is_container(v) -> bool:
    from ..symbolic_graph.ops.sequence import OptionalVal

    return isinstance(v, (list, OptionalVal))


class EvalBackend:
    """mode: "oracle" (numpy interpreter) | "torch" (GraphExecutor on
    `device`: CUDA unless "cpu" is passed)."""

    def __init__(self, mode: str = "oracle", validate: Optional[bool] = None,
                 observer: Optional[SymbolicObserver] = None,
                 device=None, capture: Optional[set] = None):
        if mode not in ("oracle", "torch"):
            raise ValueError(f"unknown mode {mode!r} (oracle or torch)")
        self.mode = mode
        self.capture = frozenset(capture or ())
        self.device = resolve_device(device) if mode == "torch" else None
        # the interpreter validates every assignment (reference
        # eval_backend.rs:230-270); the torch path does not
        self.validate = (mode == "oracle") if validate is None else validate
        self.observer = observer
        self.last_path: Optional[str] = None
        self._op_milli_cache: Dict[int, MilliGraph] = {}
        self._op_exec_cache: Dict[int, GraphExecutor] = {}
        # by graph id: (the lowered graph, {weight input: store name}),
        # the labels it holds, its weights on the device
        self._graph_milli_cache: Dict[int, Any] = {}
        self._labels: Dict[int, FrozenSet[str]] = {}
        self._weights_device_cache: Dict[int, Dict[str, torch.Tensor]] = {}
        # GraphExecutors by (graph id, the taps it reports)
        self._executors: OrderedDict = OrderedDict()

    def derive(self, observer: Optional[SymbolicObserver] = None,
               capture: Optional[set] = None) -> "EvalBackend":
        """A backend of the same mode and device with its own observer
        and taps, sharing this one's lowered graphs, device weights and
        executors."""
        be = EvalBackend(self.mode, self.validate, observer, self.device,
                         capture)
        be._graph_milli_cache = self._graph_milli_cache
        be._labels = self._labels
        be._weights_device_cache = self._weights_device_cache
        be._executors = self._executors
        return be

    def bind(self, graph: SymbolicGraph, milli: MilliGraph,
             weights: Dict[str, torch.Tensor]) -> "EvalBackend":
        """Run `graph` in torch mode as `milli`, a lowering of it that its
        owner transformed (fused, quantized), over `weights` ({input of
        milli: tensor on this backend's device}), which are used as they
        are: nothing of the graph's store is read or uploaded again."""
        if self.mode != "torch":
            raise ValueError("bind takes a torch-mode backend")
        self._graph_milli_cache[graph.id] = (milli, {n: n for n in weights})
        self._weights_device_cache[graph.id] = weights
        return self

    # ------------------------------------------------------------------
    def run(self, graph: SymbolicGraph, feeds: Dict[str, Any],
            outer_env: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        if self.mode == "torch" and not graph.needs_host_eval():
            if not graph.has_control_flow():
                out = self._run_torch(graph, feeds, outer_env)
                self.last_path = "torch"
                return out
            out = self._run_interp(graph, feeds, outer_env, on_device=True)
            self.last_path = "torch-control"
            return out
        out = self._run_interp(graph, feeds, outer_env, on_device=False)
        self.last_path = "oracle"
        return out

    # ------------------------------------------------------------------
    # interpreter (per-op, validating, observable)
    # ------------------------------------------------------------------
    def _run_interp(self, graph: SymbolicGraph, feeds: Dict[str, Any],
                    outer_env: Optional[Dict[str, Any]],
                    on_device: bool) -> Dict[str, Any]:
        env: Dict[str, Any] = {}
        outer = outer_env or {}

        def resolve(name: str):
            if name in env:
                return env[name]
            if name in graph.store:
                if self.observer is not None:
                    self.observer.on_loading_weight(name)
                v = graph.store.get_numeric(name).numpy()
                env[name] = v
                return v
            if name in outer:
                return outer[name]
            raise KeyError(f"tensor {name!r} has no value")

        for name, v in feeds.items():
            env[name] = v if _is_container(v) else np.asarray(v)
        for tid in graph.inputs:
            n = graph.tensors[tid].name
            if n not in env and n not in outer:
                raise KeyError(f"missing graph input {n!r}")

        child_env = dict(outer)
        for sop in graph.topo_sort():
            in_names = [graph.tensors[i].name if i is not None else None
                        for i in sop.inputs]
            ins = [resolve(n) if n is not None else None for n in in_names]
            n_out = len(sop.outputs)
            t0 = time.perf_counter()
            try:
                if hasattr(sop.op, "eval_direct"):
                    child_env.update(env)
                    outs = sop.op.eval_direct(self, ins, child_env, n_out)
                else:
                    outs = self._eval_single_op(graph, sop, ins,
                                                on_device)
            except (EvalCancelled, KeyboardInterrupt, NotImplementedError):
                raise
            except Exception as e:
                shapes = [None if x is None else tuple(np.shape(x))
                          for x in ins]
                raise RuntimeError(
                    f"op {sop.name!r} ({sop.op.OP_TYPE}) failed with input "
                    f"shapes {shapes}: {e}") from e
            ms = (time.perf_counter() - t0) * 1e3
            for st, v in zip(sop.outputs, outs):
                if st is None:
                    continue
                if not _is_container(v):
                    v = np.asarray(v)
                name = graph.tensors[st].name
                if self.validate and isinstance(v, np.ndarray):
                    self._check(graph, st, v, sop)
                env[name] = v
                if self.observer is not None:
                    self.observer.on_tensor_assigned(graph, name, v)
            if self.observer is not None:
                self.observer.on_op_executed(graph, sop, ms)
                if self.observer.should_cancel():
                    raise EvalCancelled()
        return {graph.tensors[t].name: resolve(graph.tensors[t].name)
                for t in graph.outputs}

    def _eval_single_op(self, graph: SymbolicGraph, sop,
                        ins: List[Optional[np.ndarray]], on_device: bool):
        """Lower this op alone into a milli graph (reference
        ops/mod.rs:108-119) and run it: on the device in torch mode,
        through the numpy oracle otherwise."""
        milli = self._op_milli_cache.get(sop.id)
        if milli is None:
            milli = MilliGraph(f"op:{sop.op.OP_TYPE}")
            ctx = LowerCtx(milli)
            in_ids = [milli.add_input(f"i{k}") if v is not None else None
                      for k, v in enumerate(ins)]
            outs = sop.op.lower(ctx, in_ids, len(sop.outputs))
            for k, o in enumerate(outs):
                milli.mark_output(f"o{k}", o)
            self._op_milli_cache[sop.id] = milli
        feeds = {f"i{k}": v for k, v in enumerate(ins) if v is not None}
        if on_device:
            ex = self._op_exec_cache.get(sop.id)
            if ex is None:
                ex = self._op_exec_cache[sop.id] = GraphExecutor(
                    milli, self.device)
            res = self._execute(
                ex, feeds, {},
                {f"i{k}": graph.tensors[i].dtype
                 for k, i in enumerate(sop.inputs) if i is not None},
                {f"o{k}": graph.tensors[o].dtype
                 for k, o in enumerate(sop.outputs) if o is not None})
        else:
            res = milli.eval(feeds)
        return [res[f"o{k}"] for k in range(len(milli.outputs))]

    def _check(self, graph: SymbolicGraph, tid: int, v: np.ndarray,
               sop) -> None:
        info = graph.tensors[tid].info
        if info is None:
            return
        truth = TensorInfo.numeric(v)
        if info.dtype is not None and not info.consistent_with(truth):
            raise RuntimeError(
                f"validation failed: {graph.tensors[tid].name} from "
                f"{sop.name}: declared {info}, got {truth}")

    # ------------------------------------------------------------------
    # torch whole-graph mode
    # ------------------------------------------------------------------
    def _milli_of(self, graph: SymbolicGraph):
        cached = self._graph_milli_cache.get(graph.id)
        if cached is None:
            cached = graph.to_milli()
            self._graph_milli_cache[graph.id] = cached
        return cached

    def _device_weights(self, graph: SymbolicGraph, names) -> Dict[str, Any]:
        cache = self._weights_device_cache.setdefault(graph.id, {})
        for name in names:
            if name not in cache:
                if self.observer is not None:
                    self.observer.on_loading_weight(name)
                cache[name] = to_device(
                    graph.store.get_numeric(name).numpy(), self.device)
        return cache

    def _executor(self, graph: SymbolicGraph):
        """(the graph's GraphExecutor with this backend's taps among the
        labels the lowered graph holds, its weights on the device), each
        made once; executors with taps are bounded (TAPPED_EXECUTORS)."""
        milli, weight_inputs = self._milli_of(graph)
        weights = self._device_weights(graph, weight_inputs)
        labels = self._labels.get(graph.id)
        if labels is None:
            labels = self._labels[graph.id] = frozenset(
                t.label for t in milli.tensors.values() if t.label)
        key = (graph.id, self.capture & labels)
        ex = self._executors.get(key)
        if ex is None:
            ex = self._executors[key] = GraphExecutor(milli, self.device,
                                                      taps=key[1])
            tapped = [k for k in self._executors if k[1]]
            for k in tapped[:-TAPPED_EXECUTORS]:
                del self._executors[k]
        else:
            self._executors.move_to_end(key)
        return ex, weights

    def _run_torch(self, graph: SymbolicGraph, feeds: Dict[str, Any],
                   outer_env: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        milli, weight_inputs = self._milli_of(graph)
        ex, weights = self._executor(graph)
        host: Dict[str, Any] = {}
        for name in milli.inputs:
            if name in feeds:
                host[name] = feeds[name]
            elif name in weight_inputs:
                continue
            elif outer_env and name in outer_env:
                host[name] = outer_env[name]
            else:
                raise KeyError(f"missing input {name!r}")
        dtypes = {graph.tensors[t].name: graph.tensors[t].dtype
                  for t in list(graph.inputs) + list(graph.outputs)}
        return self._execute(ex, host, weights, dtypes, dtypes, graph)

    def run_on_device(self, graph: SymbolicGraph,
                      feeds: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """Torch mode without the host: device tensors in (cast to the
        inputs' declared types; a numpy feed is uploaded in its declared
        type), device tensors out. The graph is lowered
        and its weights uploaded once; the executor folds its statics on
        the first run for a set of shapes and replays the device steps
        after. The image interface's denoise loop runs its UNet here, so
        nothing crosses to the host between steps. In oracle mode the
        interpreter runs on host copies of the feeds, and its outputs
        come back as CPU tensors (the interfaces' `mode="oracle"`)."""
        if self.mode == "oracle":
            out = self.run(graph, {n: to_host(v) if isinstance(
                v, torch.Tensor) else v for n, v in feeds.items()})
            return {n: to_device(np.asarray(v), torch.device("cpu"))
                    for n, v in out.items()}
        if graph.has_control_flow() or graph.needs_host_eval():
            raise ValueError("run_on_device takes a graph without control "
                             "flow or host values")
        ex, weights = self._executor(graph)
        dev = dict(weights)
        for t in graph.inputs:
            name, dt = graph.tensors[t].name, graph.tensors[t].dtype
            v = feeds[name]
            if isinstance(v, torch.Tensor):
                dev[name] = v.to(self.device, to_torch(dt) if dt is not None
                                 else v.dtype)
            else:
                dev[name] = to_device(np.asarray(v), self.device, dt)
        self.last_path = "torch"
        return self._report(graph, ex, dev)

    def _report(self, graph: SymbolicGraph, ex: GraphExecutor,
                dev: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Run `ex`; hand its taps to the observer, as device tensors."""
        if not ex.tap_labels:
            return ex(dev)
        out, taps = ex.run(dev)
        if self.observer is not None:
            for lbl, v in taps.items():
                self.observer.on_tensor_assigned(graph, lbl, v)
        return out

    def _execute(self, ex: GraphExecutor, host: Dict[str, Any],
                 device_feeds: Dict[str, Any],
                 in_dtypes: Dict[str, Optional[DType]],
                 out_dtypes: Dict[str, Optional[DType]],
                 graph: Optional[SymbolicGraph] = None
                 ) -> Dict[str, np.ndarray]:
        """Upload the host feeds in their declared types, run, and
        download the outputs in theirs (a 4-bit float crosses as its f32
        carrier, dtype.py)."""
        dev = dict(device_feeds)
        for name, v in host.items():
            # a tensor already on the device is used as it is (a lowering
            # may write into it: the step graphs' cache writes do)
            dev[name] = (v.to(self.device) if isinstance(v, torch.Tensor)
                         else to_device(np.asarray(v), self.device,
                                        in_dtypes.get(name)))
        return {name: to_host(t, out_dtypes.get(name))
                for name, t in self._report(graph, ex, dev).items()}
