"""Compiler facade: the stable compile-and-run contract.

Reference equivalent: src/compiler/mod.rs:66-163 (CompilationSubject /
build_program / CompiledProgram + interpret_milli_graph / op_census).

The port's copy of whisper_tensor_tpu/compiler.py. Where the JAX
package's build_program targets XLA, the port's runs the graph on its
GraphExecutor (backends/torch_exec/compiler.py) on a torch device: the
card unless the caller passes device="cpu". `backend` reports "torch".
On the card a node that has to run there and has no lowering (the
string and ai.onnx.ml kinds, say) raises NoLowering, as any CUDA error
or a kernel that fails to build or launch does: nothing moves to the
host. On the CPU such a node runs through its op's numpy eval as a step
of the executor's plan (host_ops), and `backend` then reports
"failed-torch", as the JAX facade reports "failed-xla", with
stats["fallback_reason"] naming each kind; every other node still runs
its lowering, so caches are written in place as on the card.

Feeds are host arrays, uploaded in the input's declared type, or torch
tensors, used as they are on the program's device (a step graph's
caches are written in place). Outputs come back as host arrays, as the
JAX facade's do. A Model's weights are read from its store and uploaded
at the first run that needs them, then stay on the device (the JAX
facade feeds them from the store at every run):
stats["weight_bytes_uploaded"] counts the bytes. stats["compile_ms"] is
the first run's time, in which the executor builds its plan. As in the
JAX package, `capture_labels` is carried but not used; `run` takes the
JAX facade's `observer` and, like that facade's XLA path, calls it
never.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .backends.torch_exec.compiler import GraphExecutor
from .device import resolve_device
from .dtype import to_device, to_host
from .milli.ir import MilliGraph
from .model import Model


@dataclass
class CompilationSubject:
    """What to compile: a Model (symbolic graph) or a raw MilliGraph."""

    model: Optional[Model] = None
    milli: Optional[MilliGraph] = None
    capture_labels: List[str] = field(default_factory=list)

    def graph(self) -> MilliGraph:
        if self.milli is not None:
            return self.milli
        milli, weights = self.model.graph.to_milli()
        self._weight_inputs = weights
        return milli


class CompiledProgram:
    """Executable program; `backend` reports "torch", or "failed-torch"
    once a node with no lowering ran on the host (the CPU only)."""

    def __init__(self, milli: MilliGraph,
                 weight_feeder: Optional[Callable] = None, device=None):
        self.milli = milli
        self.device = resolve_device(device)
        self.backend = "torch"
        self._executor = GraphExecutor(
            milli, self.device, host_ops=self.device.type == "cpu")
        self._weight_feeder = weight_feeder
        self._weights: Dict[str, torch.Tensor] = {}
        self.stats: Dict[str, Any] = {"compile_ms": None,
                                      "op_count": len(milli.nodes),
                                      "weight_bytes_uploaded": 0}

    def _declared(self, name: str):
        info = self.milli.tensors[self.milli.inputs[name]].info
        return None if info is None else info.dtype

    def _device_feeds(self, feeds: Dict[str, Any]) -> Dict[str, Any]:
        dev: Dict[str, Any] = {}
        for name in self.milli.inputs:
            if name in feeds:
                v = feeds[name]
                if isinstance(v, torch.Tensor):
                    dev[name] = v.to(self.device)
                elif self._executor.host_ops and _is_text(np.asarray(v)):
                    dev[name] = np.asarray(v)   # strings stay on the host
                else:
                    dev[name] = to_device(np.asarray(v), self.device,
                                          self._declared(name))
                continue
            if name not in self._weights and self._weight_feeder is not None:
                w = self._weight_feeder(name)
                if w is None:
                    continue
                t = self._weights[name] = to_device(np.asarray(w),
                                                    self.device)
                self.stats["weight_bytes_uploaded"] += (t.numel()
                                                        * t.element_size())
            if name in self._weights:
                dev[name] = self._weights[name]
        return dev

    def run(self, feeds: Dict[str, Any],
            observer=None) -> Dict[str, np.ndarray]:
        t0 = time.perf_counter()
        out = self._executor(self._device_feeds(feeds))
        if self.stats["compile_ms"] is None:
            self.stats["compile_ms"] = (time.perf_counter() - t0) * 1e3
        if self._executor.host_kinds:
            self.backend = "failed-torch"
            self.stats["fallback_reason"] = "; ".join(
                self._executor.host_kinds.values())
        return {k: v if isinstance(v, np.ndarray) else to_host(v)
                for k, v in out.items()}


def _is_text(a: np.ndarray) -> bool:
    return a.dtype == object or a.dtype.kind in "US"


def build_program(subject: CompilationSubject, device=None) -> CompiledProgram:
    """A program of `subject` on `device` (the card unless "cpu")."""
    milli = subject.graph()
    feeder = None
    if subject.model is not None:
        store = subject.model.graph.store
        names = getattr(subject, "_weight_inputs", {})

        def feeder(name):  # noqa: F811
            src = names.get(name, name)
            if src in store:
                return store.get_numeric(src).numpy()
            return None

    return CompiledProgram(milli, feeder, device=device)


def interpret_milli_graph(milli: MilliGraph, feeds: Dict[str, np.ndarray]
                          ) -> Dict[str, np.ndarray]:
    """The validation interpreter (reference compiler/mod.rs:18-33)."""
    return milli.eval(feeds, validate=True)


def op_census(milli: MilliGraph) -> Dict[str, int]:
    return milli.op_census()
