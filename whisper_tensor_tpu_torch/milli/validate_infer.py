"""Infer-correctness ablation harness.

Reference equivalent: src/milli_graph/validate_infer.rs:23-60 — for
every milli op executed in a real graph, ablate each input's knowledge
to all 4 lattice levels (NUMERIC/SHAPED/RANKED/MINIMAL) and assert that
`infer()` never *contradicts* the eval ground truth (returning less
knowledge is always legal).

The port's copy of whisper_tensor_tpu/milli/validate_infer.py, over the
port's op set (the port's own KVWrite, QuantMatMul and PackedMatMul
among them).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..tensor_info import Level, TensorInfo
from .ir import MilliGraph


@dataclass
class InferViolation:
    op_kind: str
    levels: tuple
    message: str


@dataclass
class ValidationReport:
    checked_ops: int = 0
    checked_combos: int = 0
    violations: List[InferViolation] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations


def validate_infer(graph: MilliGraph, feeds: Dict[str, np.ndarray],
                   max_combos_per_op: int = 32) -> ValidationReport:
    """Run the graph on the oracle, then ablate every op's inputs."""
    report = ValidationReport()
    values: Dict[int, np.ndarray] = {}
    for name, tid in graph.inputs.items():
        values[tid] = np.asarray(feeds[name])

    levels = (Level.NUMERIC, Level.SHAPED, Level.RANKED, Level.MINIMAL)
    for node in graph.nodes:
        ins = [values[i] if i is not None else None for i in node.inputs]
        try:
            outs = node.op.eval([v for v in ins])
        except Exception:
            continue  # op not evaluable with these feeds; skip
        for tid, v in zip(node.outputs, outs):
            values[tid] = np.asarray(v)
        truths = [TensorInfo.numeric(np.asarray(v)) for v in outs]
        report.checked_ops += 1

        n_in = len([v for v in ins if v is not None])
        combos = list(itertools.product(levels, repeat=n_in))
        if len(combos) > max_combos_per_op:
            # keep uniform-level combos + a deterministic sample
            uniform = [tuple([lv] * n_in) for lv in levels]
            combos = uniform + combos[:max_combos_per_op - len(uniform)]
        for combo in combos:
            infos: List[Optional[TensorInfo]] = []
            k = 0
            for v in ins:
                if v is None:
                    infos.append(None)
                    continue
                infos.append(TensorInfo.numeric(np.asarray(v)).at_level(combo[k]))
                k += 1
            report.checked_combos += 1
            try:
                inferred = node.op.infer(infos)  # type: ignore[arg-type]
            except NotImplementedError:
                continue
            except Exception:
                continue  # failing to infer = returning no knowledge
            if inferred is None:
                continue
            for oi, truth in zip(inferred, truths):
                if oi is None:
                    continue
                if not oi.consistent_with(truth):
                    report.violations.append(InferViolation(
                        node.op.KIND, combo,
                        f"inferred {oi} contradicts truth {truth}"))
    return report
