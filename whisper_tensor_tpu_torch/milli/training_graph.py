"""Compose a complete training-step graph: forward + loss + backward +
optimizer, as one MilliOpGraph.

Reference equivalent: generate_milli_graph_with_options
(src/symbolic_graph/mod.rs:800) + the loss wiring / backward / optimizer
generation in src/milli_graph/mod.rs. The result is a single editable,
serializable, backend-agnostic artifact: inputs = data + params + opt
state (+ step), outputs = loss + new params + new state; the port's
GraphExecutor runs it on the card as it runs a forward graph.

The port's copy of whisper_tensor_tpu/milli/training_graph.py.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .autodiff import BackwardGenOptions, TrainingMetadata, generate_backward
from .ir import MilliGraph, Phase
from .losses import cross_entropy_loss, l1_loss, mse_loss
from .optimizers import OptimizerKind, OptimizerOptions, generate_optimizer_ops

_LOSSES = {"cross_entropy": cross_entropy_loss, "mse": mse_loss, "l1": l1_loss}


def build_training_graph(forward: MilliGraph, param_names: Sequence[str],
                         pred_output: str, loss: str = "cross_entropy",
                         target_name: str = "target",
                         optimizer: Optional[OptimizerOptions] = None,
                         backward_options: Optional[BackwardGenOptions] = None,
                         input_infos=None,
                         ) -> Tuple[MilliGraph, TrainingMetadata]:
    """Mutates a merged copy of `forward` into a training step graph.

    input_infos: optional {input name: TensorInfo} with CONCRETE shapes
    (e.g. the fixed (B, S) of the training batch) — several backward
    rules (LayerNorm span, attention head grouping) need resolved dims
    that symbolic batch/seq inputs cannot provide."""
    g = MilliGraph(f"{forward.name}:train")
    # re-declare forward inputs, splice the forward graph
    input_map = {name: g.add_input(name, forward.tensors[tid].info)
                 for name, tid in forward.inputs.items()}
    out_map = g.merge_graph(forward, input_map)
    pred_tid = out_map[pred_output]

    target = g.add_input(target_name)
    loss_tid = _LOSSES[loss](g, pred_tid, target)
    g.mark_output("loss", loss_tid)

    # propagate shape/rank infos: several backward rules (LayerNorm span,
    # attention GQA factor, reduce axes normalization) need them
    infer_inputs = {name: forward.tensors[tid].info
                    for name, tid in forward.inputs.items()
                    if forward.tensors[tid].info is not None}
    if input_infos:
        infer_inputs.update(input_infos)
    g.infer_all(infer_inputs)

    params = {n: input_map[n] for n in param_names}
    grads = generate_backward(g, loss_tid, params, backward_options)
    meta = TrainingMetadata(loss_output="loss")
    for n, gt in grads.items():
        g.mark_output(f"grad::{n}", gt)
        meta.param_to_grad[n] = f"grad::{n}"
    if optimizer is not None:
        generate_optimizer_ops(g, params, grads, optimizer, meta)
    return g, meta


def init_opt_state(meta: TrainingMetadata, params: Dict[str, np.ndarray]
                   ) -> Dict[str, np.ndarray]:
    state = {}
    for name in meta.opt_state_in_to_out:
        # state::<kind>::<param>
        pname = name.split("::", 2)[2]
        state[name] = np.zeros_like(np.asarray(params[pname], dtype=np.float32))
    return state
