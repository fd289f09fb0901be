"""SuperGraph: serializable heterogeneous job graph + execution.

Reference equivalent: src/super_graph/mod.rs (SuperGraph::run/eval with
greedy data-driven scheduling :105-130; SuperGraphBuilder + validation
:184-203). The ExecutionContext supplies model registry, backend mode,
caches, tokenizers and the observer — the seam where the server's
scheduler plugs in (reference crates/whisper-tensor-server/scheduler.rs).

The port's copy of whisper_tensor_tpu/super_graph/graph.py (:24-203).
Its departures:
  * `backend_mode` is "torch" by default: every model runs on
    `device` (the card unless "cpu" is passed) through EvalBackend.
    "oracle", the numpy interpreter, runs only when it is named; "xla",
    the reference's name for its device mode, runs as "torch", since
    the reference's clients send it. The reference defaults to "oracle".
  * Tensors stay on the device between nodes: `run_model` takes numpy
    arrays or device tensors and, for a graph without control flow,
    returns device tensors (`EvalBackend.run_on_device`). Nodes move to
    the host only what they must (an argmax token, a preview frame),
    and `SuperGraph.run` moves the graph's outputs to numpy at the
    job's edge.
  * The observer receives snapshots: a value handed to
    `on_tensor_assigned` is cloned when it is assigned, so an in-place
    cache write later in the run cannot change it. Only the names the
    observer is `subscribed` to are snapshotted and reported.
  * A job's backend of a model derives from a base backend: the Model's
    own (`Model.backend(...)`), or in torch mode the one that `backends`
    names for the model. The lowered graph, the device weights and the
    executors are made once and shared with every later job; a job with
    taps builds an executor of its own. The server names an int8 model's
    text interface's backend (TextInferenceInterface.eval_backend), so
    the job runs that interface's int8 graph and weights, as its text
    path does, with no second quantization or upload; the reference's
    job, and the port's "oracle", run the dense graph.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..graph import new_global_id
from .cache import SuperGraphCache, SuperGraphTensorCache
from .links import LinkKind, SuperLink
from .nodes import SuperNode, host_value

# backend_mode -> the EvalBackend mode that serves it
BACKEND_MODES = {"torch": "torch", "xla": "torch", "oracle": "oracle"}


class SuperObserver:
    """Reference src/super_graph/observer.rs:7-27."""

    def on_node_executed(self, node, ms: float) -> None:
        pass

    def on_tensor_assigned(self, link_name: str, value) -> None:
        pass

    def on_loading_weight(self, name: str) -> None:
        pass

    def on_progress(self, node, fraction: float) -> None:
        pass

    def should_cancel(self) -> bool:
        return False

    def subscribed(self, name: str) -> bool:
        """Whether on_tensor_assigned wants `name` (a link's name or a
        model tensor's label). Values are snapshotted only for the names
        this admits; the default admits every name when a subclass
        overrides on_tensor_assigned, and none otherwise."""
        return type(self).on_tensor_assigned is not \
            SuperObserver.on_tensor_assigned


def snapshot(v):
    """A payload whose torch tensors are copies: what an observer keeps
    stays as it was when it was assigned."""
    if isinstance(v, torch.Tensor):
        return v.detach().clone()
    if isinstance(v, dict):
        return {k: snapshot(x) for k, x in v.items()}
    if isinstance(v, np.ndarray):
        return v.copy()
    return v


class _Forward:
    """The model backends' observer: forwards to the job's observer.
    Tapped values arrive as snapshots already (GraphExecutor clones a
    tap where it is made; the interpreter's values are fresh arrays)."""

    def __init__(self, sup: SuperObserver):
        self.sup = sup

    def on_op_executed(self, graph, sop, ms: float) -> None:
        pass

    def on_tensor_assigned(self, graph, name, value) -> None:
        if self.sup.subscribed(name):
            self.sup.on_tensor_assigned(name, value)

    def on_loading_weight(self, name) -> None:
        self.sup.on_loading_weight(name)

    def should_cancel(self) -> bool:
        return self.sup.should_cancel()


class ExecutionContext:
    """models: {name: Model}; see the module docstring."""

    def __init__(self, models: Optional[Dict[str, Any]] = None,
                 tokenizers: Optional[Dict[str, Any]] = None,
                 backend_mode: str = "torch",
                 observer: Optional[SuperObserver] = None,
                 cache: Optional[SuperGraphCache] = None,
                 tensor_cache: Optional[SuperGraphTensorCache] = None,
                 capture_labels: Optional[set] = None,
                 device=None,
                 backends: Optional[Dict[str, Any]] = None):
        if backend_mode not in BACKEND_MODES:
            raise ValueError(f"unknown backend_mode {backend_mode!r} "
                             f"({', '.join(BACKEND_MODES)})")
        self.models = models or {}
        self.tokenizers = tokenizers or {}
        self.backend_mode = BACKEND_MODES[backend_mode]
        self.device = (resolve_device(device)
                       if self.backend_mode == "torch" else None)
        self.observer = observer or SuperObserver()
        self.cache = cache or SuperGraphCache()
        self.tensor_cache = tensor_cache or SuperGraphTensorCache()
        # model-tensor labels to report through the observer: taps fixed
        # when a model's executor is built, so unchosen labels cost nothing
        self.capture_labels = set(capture_labels or ())
        self.bases = dict(backends or {})
        self._backends: Dict[int, Any] = {}

    def backend(self, model):
        """This job's EvalBackend of `model`, made at its first run."""
        be = self._backends.get(model.id)
        if be is None:
            base = self.bases.get(model.name) \
                if self.backend_mode == "torch" else None
            base = base or model.backend(self.backend_mode,
                                         device=self.device)
            be = self._backends[model.id] = base.derive(
                observer=_Forward(self.observer),
                capture=self.capture_labels)
        return be

    def run_model(self, model, feeds: Dict[str, Any]) -> Dict[str, Any]:
        """Run `model` on `feeds` (numpy arrays or device tensors). In
        torch mode a graph without control flow answers with device
        tensors; otherwise the answer is numpy."""
        be = self.backend(model)
        g = model.graph
        if self.backend_mode == "torch" and not g.has_control_flow() \
                and not g.needs_host_eval():
            return be.run_on_device(g, feeds)
        return be.run(g, {k: host_value(v) for k, v in feeds.items()})

    def get_tokenizer(self, source: str):
        if source in self.tokenizers:
            return self.tokenizers[source]
        from ..tokenizer import AnyTokenizer

        tok = AnyTokenizer.load(source)
        self.tokenizers[source] = tok
        return tok


class SuperGraph:
    def __init__(self, name: str = ""):
        self.id = new_global_id()
        self.name = name
        self.links: Dict[int, SuperLink] = {}
        self.nodes: List[SuperNode] = []
        self.inputs: Dict[str, int] = {}
        self.outputs: Dict[str, int] = {}
        self._next_link = 0

    # -- builder (reference SuperGraphBuilder) ---------------------------
    def link(self, kind: LinkKind, name: Optional[str] = None) -> int:
        lid = self._next_link
        self._next_link += 1
        self.links[lid] = SuperLink(lid, kind, name)
        return lid

    def mark_input(self, name: str, lid: int) -> int:
        self.inputs[name] = lid
        return lid

    def mark_output(self, name: str, lid: int) -> int:
        self.outputs[name] = lid
        return lid

    def add(self, node: SuperNode) -> SuperNode:
        self.nodes.append(node)
        return node

    def validate(self) -> None:
        produced = set(self.inputs.values())
        for n in self.nodes:
            for port, lid in n.inputs.items():
                if lid not in self.links:
                    raise ValueError(f"{n.name}.{port}: unknown link {lid}")
            for port, lid in n.outputs.items():
                if lid in produced:
                    raise ValueError(f"{n.name}.{port}: link {lid} produced twice")
                produced.add(lid)
        for name, lid in self.outputs.items():
            if lid not in produced:
                raise ValueError(f"output {name}: link {lid} never produced")

    # -- execution: greedy data-driven scheduling -------------------------
    def run(self, ctx: ExecutionContext, feeds: Dict[str, Any],
            host: bool = True) -> Dict[str, Any]:
        """Run the graph; its outputs cross to numpy unless `host` is
        False (a Scan body's outputs stay where they are)."""
        values: Dict[int, Any] = {}
        for name, lid in self.inputs.items():
            if name not in feeds:
                raise KeyError(f"missing super-graph input {name!r}")
            values[lid] = feeds[name]
        pending = list(self.nodes)
        while pending:
            progressed = False
            rest = []
            for node in pending:
                if all(lid in values for lid in node.inputs.values()):
                    ins = {port: values[lid] for port, lid in node.inputs.items()}
                    t0 = time.perf_counter()
                    outs = node.execute(ctx, ins)
                    ms = (time.perf_counter() - t0) * 1e3
                    ctx.observer.on_node_executed(node, ms)
                    for port, lid in node.outputs.items():
                        if port not in outs:
                            raise RuntimeError(f"{node.name}: missing output {port!r}")
                        values[lid] = outs[port]
                        link = self.links[lid]
                        if link.name and ctx.observer.subscribed(link.name):
                            ctx.observer.on_tensor_assigned(
                                link.name, snapshot(outs[port]))
                    progressed = True
                else:
                    rest.append(node)
            pending = rest
            if not progressed and pending:
                stuck = [n.name for n in pending[:5]]
                raise RuntimeError(f"super graph stuck (missing inputs): {stuck}")
        out = {name: values[lid] for name, lid in self.outputs.items()}
        return host_value(out) if host else out

    # -- serialization -------------------------------------------------------
    def to_json(self) -> dict:
        return {
            "name": self.name,
            "links": [l.to_json() for l in self.links.values()],
            "nodes": [n.to_json() for n in self.nodes],
            "inputs": self.inputs,
            "outputs": self.outputs,
        }

    def dumps(self) -> str:
        return json.dumps(self.to_json())

    @staticmethod
    def from_json(d: dict) -> "SuperGraph":
        g = SuperGraph(d.get("name", ""))
        for lj in d["links"]:
            link = SuperLink.from_json(lj)
            g.links[link.id] = link
            g._next_link = max(g._next_link, link.id + 1)
        for nj in d["nodes"]:
            g.nodes.append(SuperNode.from_json(nj))
        g.inputs = {k: int(v) for k, v in d["inputs"].items()}
        g.outputs = {k: int(v) for k, v in d["outputs"].items()}
        return g

    @staticmethod
    def loads(s: str) -> "SuperGraph":
        return SuperGraph.from_json(json.loads(s))

    def __repr__(self):
        return (f"SuperGraph({self.name!r}, {len(self.nodes)} nodes, "
                f"{len(self.links)} links)")
