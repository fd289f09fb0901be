"""Job scheduler: queued execution with streaming observer reports and
cooperative cancellation.

Reference equivalent: crates/whisper-tensor-server/src/scheduler.rs
(job queue :114, spawn_blocking dispatch :500, LocalSuperGraphObserver
streaming through a lock-free queue :215-392, cancellation registry
:400-422). Python redesign: a worker thread pool of 1 (jobs serialized
per device, like the reference), queue.Queue report streaming, and an
Event-based cancellation registry.

The port's copy of whisper_tensor_tpu/server/scheduler.py. Its
StreamingObserver subclasses the port's SuperObserver and reports what
the reference's drops without a word: a subscribed device or bf16 torch
tensor is downloaded (`to_host`, bf16 kept as bf16) and abbreviated,
and a tensor map is reported with one abbreviated tensor per entry in
`tensors` beside the reference's placeholder `tensor`. A subscribed
value it cannot encode fails the job (job_error), never a quiet return.
The worker drops a finished job before it waits for the next one.
"""

from __future__ import annotations

import itertools
import queue
import threading
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..dtype import to_host
from ..milli.ir import EvalCancelled
from ..super_graph.graph import SuperObserver
from .protocol import (JOB_ACCEPTED, JOB_ERROR, JOB_RESULT, NODE_EXECUTED,
                       PROGRESS, TENSOR_ASSIGNED, AbbreviatedTensor)


@dataclass
class ObserverSettings:
    """Live-tunable subscriptions (reference UpdateSuperGraphObserverSettings)."""

    report_node_timings: bool = True
    report_progress: bool = True
    tensor_subscriptions: set = field(default_factory=set)  # link names


def _abbreviate(name: str, value) -> AbbreviatedTensor:
    """The preview of one subscribed value; TypeError for a value that is
    not a tensor."""
    if isinstance(value, torch.Tensor):
        value = to_host(value)
    if isinstance(value, (np.ndarray, np.generic, int, float, bool)):
        a = np.asarray(value)
        if a.dtype.kind in "biufcV":       # ml_dtypes' bf16 is kind V
            return AbbreviatedTensor.from_array(a)
    raise TypeError(f"subscribed link {name!r} carries a "
                    f"{type(value).__name__}, which is not a tensor")


class StreamingObserver(SuperObserver):
    """Pushes reports into the job's outbound queue (the reference's
    ArrayQueue + Notify pattern)."""

    def __init__(self, job_id: int, out: "queue.Queue", settings: ObserverSettings,
                 cancel: threading.Event):
        self.job_id = job_id
        self.out = out
        self.settings = settings
        self.cancel = cancel

    def on_node_executed(self, node, ms: float) -> None:
        if self.settings.report_node_timings:
            self.out.put({"type": NODE_EXECUTED, "job": self.job_id,
                          "node": getattr(node, "name", str(node)), "ms": ms})

    def subscribed(self, name: str) -> bool:
        return name in self.settings.tensor_subscriptions

    def on_tensor_assigned(self, link_name: str, value) -> None:
        if link_name not in self.settings.tensor_subscriptions:
            return
        report = {"type": TENSOR_ASSIGNED, "job": self.job_id,
                  "link": link_name}
        if isinstance(value, dict):
            report["tensor"] = AbbreviatedTensor.from_array(
                np.asarray(value)).__dict__
            report["tensors"] = {k: _abbreviate(f"{link_name}.{k}", v).__dict__
                                 for k, v in value.items()}
        else:
            report["tensor"] = _abbreviate(link_name, value).__dict__
        self.out.put(report)

    def on_progress(self, node, fraction: float) -> None:
        if self.settings.report_progress:
            self.out.put({"type": PROGRESS, "job": self.job_id,
                          "fraction": float(fraction)})

    def should_cancel(self) -> bool:
        return self.cancel.is_set()


@dataclass
class Job:
    id: int
    fn: Callable[[StreamingObserver], Any]
    settings: ObserverSettings
    cancel: threading.Event = field(default_factory=threading.Event)


class Scheduler:
    def __init__(self):
        self._jobs: "queue.Queue[Optional[Job]]" = queue.Queue()
        self.reports: "queue.Queue[dict]" = queue.Queue()
        self._next = itertools.count(1)
        self._cancel_registry: Dict[int, threading.Event] = {}
        self._settings_registry: Dict[int, ObserverSettings] = {}
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def submit(self, fn: Callable[[StreamingObserver], Any],
               settings: Optional[ObserverSettings] = None) -> int:
        job = Job(next(self._next), fn, settings or ObserverSettings())
        self._cancel_registry[job.id] = job.cancel
        self._settings_registry[job.id] = job.settings
        # acceptance rides the same FIFO as the job's own reports, so
        # clients always see job_accepted before any node_executed/...
        self.reports.put({"type": JOB_ACCEPTED, "job": job.id})
        self._jobs.put(job)
        return job.id

    def cancel(self, job_id: int) -> bool:
        ev = self._cancel_registry.get(job_id)
        if ev is None:
            return False
        ev.set()
        return True

    def update_settings(self, job_id: int, **kw) -> bool:
        s = self._settings_registry.get(job_id)
        if s is None:
            return False
        for k, v in kw.items():
            if k == "tensor_subscriptions":
                s.tensor_subscriptions = set(v)
            elif hasattr(s, k):
                setattr(s, k, v)
        return True

    def shutdown(self):
        self._jobs.put(None)

    def _loop(self):
        while True:
            job = self._jobs.get()
            if job is None:
                return
            obs = StreamingObserver(job.id, self.reports, job.settings, job.cancel)
            try:
                result = job.fn(obs)
                self.reports.put({"type": JOB_RESULT, "job": job.id,
                                  "result": result})
            except EvalCancelled:
                self.reports.put({"type": JOB_ERROR, "job": job.id,
                                  "error": "cancelled", "cancelled": True})
            except Exception as e:  # noqa: BLE001 - report, don't die
                self.reports.put({"type": JOB_ERROR, "job": job.id,
                                  "error": f"{type(e).__name__}: {e}",
                                  "traceback": traceback.format_exc()[-2000:]})
            finally:
                self._cancel_registry.pop(job.id, None)
                self._settings_registry.pop(job.id, None)
                # keep nothing of a finished job while waiting for the
                # next: its closure may hold models and their device
                # weights (an unloaded model's among them)
                job = obs = result = None
