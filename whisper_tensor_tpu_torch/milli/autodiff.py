"""Symbolic reverse-mode autodiff over MilliOpGraphs.

Reference equivalent: generate_milli_backward + BackwardGenOptions +
TrainingMetadata (src/milli_graph/mod.rs:1170-1222, 207-243, 101-154).
This is the *editable training artifact* path: the backward pass is
materialized as more milli ops (Phase.BACKWARD groups) in the same
graph, so it can be inspected, serialized, modified, and executed on
any backend: the numpy oracle, or the port's GraphExecutor on the card.
(The autograd path in training/trainer.py covers the "just give me
gradients" use case; both coexist.)

The port's copy of whisper_tensor_tpu/milli/autodiff.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from .ir import MilliGraph, MilliNode, Phase
from .ops import CastLike, Constant, SimpleBinary


@dataclass
class BackwardGenOptions:
    """Reference BackwardGenOptions (mod.rs:207-243)."""

    # tensor ids whose gradient flow is cut
    stop_gradients: Set[int] = field(default_factory=set)
    # seed gradients flowing in from outside (BPTT): output tid -> input name
    external_gradients: Dict[int, str] = field(default_factory=dict)


@dataclass
class TrainingMetadata:
    """Maps between graph I/O names for a complete training step
    (reference TrainingMetadata, mod.rs:101-154)."""

    loss_output: str = "loss"
    param_to_grad: Dict[str, str] = field(default_factory=dict)
    param_to_new: Dict[str, str] = field(default_factory=dict)
    opt_state_in_to_out: Dict[str, str] = field(default_factory=dict)


def generate_backward(g: MilliGraph, loss_tid: int,
                      wrt: Dict[str, int],
                      options: Optional[BackwardGenOptions] = None
                      ) -> Dict[str, int]:
    """Append backward ops computing d(loss)/d(param) for each named
    tensor in `wrt` (name -> tid). Returns name -> grad tid.

    Fan-out gradients accumulate via Add (reference mod.rs:1188+);
    missing backward rules raise unless gradient flow to every `wrt`
    tensor is still complete without them.
    """
    options = options or BackwardGenOptions()
    grads: Dict[int, int] = {}
    one = g.op1(Constant(np.asarray(1.0, dtype=np.float32)), phase=Phase.BACKWARD)
    grads[loss_tid] = g.op1(CastLike(), one, loss_tid, phase=Phase.BACKWARD)
    for tid, name in options.external_gradients.items():
        grads[tid] = g.inputs.get(name) or g.add_input(name)

    wanted = set(wrt.values())
    nodes = [n for n in g.nodes if n.phase is not Phase.BACKWARD]
    for node in reversed(nodes):
        out_grads = [grads.get(o) for o in node.outputs]
        if all(og is None for og in out_grads):
            continue
        try:
            in_grads = node.op.backward(g, node, out_grads)
        except NotImplementedError:
            # legal only if no wanted tensor is upstream of this node
            upstream = _reachable_up(g, node)
            if upstream & wanted:
                raise
            continue
        for tid, gid in zip(node.inputs, in_grads):
            if tid is None or gid is None or tid in options.stop_gradients:
                continue
            if tid in grads:
                grads[tid] = g.op1(SimpleBinary("add"), grads[tid], gid,
                                   phase=Phase.BACKWARD)
            else:
                grads[tid] = gid
    out = {}
    for name, tid in wrt.items():
        if tid not in grads:
            raise ValueError(f"no gradient reached parameter {name!r}")
        out[name] = grads[tid]
    return out


def _reachable_up(g: MilliGraph, node: MilliNode) -> Set[int]:
    """All tensor ids transitively feeding `node`."""
    producer = {}
    for n in g.nodes:
        for o in n.outputs:
            producer[o] = n
    seen: Set[int] = set()
    stack = [i for i in node.inputs if i is not None]
    while stack:
        t = stack.pop()
        if t in seen:
            continue
        seen.add(t)
        p = producer.get(t)
        if p is not None:
            stack.extend(i for i in p.inputs if i is not None)
    return seen
