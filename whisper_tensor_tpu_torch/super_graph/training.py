"""Training as a serializable SuperGraph job.

Reference equivalent: examples/mnist_train_supergraph.rs — the epoch
loop rides a SuperGraph Scan whose body executes the milli training
artifact (forward+loss+backward+optimizer as ONE graph), so a complete
training job (graph + loop) serializes to JSON, ships to the server,
streams progress through observers, and honors cancellation.

The train-step milli graph is embedded in the node's params via
milli.serde (the milli layer is serde-serializable like the
reference's); execution jit-compiles it once per shape via the XLA
backend (ctx.backend_mode == "oracle" runs the interpreter instead).

The port's copy of whisper_tensor_tpu/super_graph/training.py
(:26-136). Outside "oracle" the node runs the training graph through the
port's GraphExecutor on the context's device (built at the first step;
its plan is folded then and replayed after), the parameters and the
optimizer state stay there between steps, and each step's loss stays on
the device until the Scan's loss column crosses to numpy at the job's
edge.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..dtype import to_device
from .graph import SuperGraph
from .links import LinkKind
from .nodes import ScanNode, SuperNode, host_value, register_node


@register_node
class MilliTrainStepNode(SuperNode):
    """One optimizer step of an embedded milli training graph.

    in:  'state' (tensor map: params + opt state [+ 'step' scalar]),
         one port per data input (params['data_inputs'])
    out: 'state' (updated), 'loss'
    params: milli (serialized graph JSON), state_map {state_in: out},
            data_inputs [names], loss_output (default 'loss'),
            has_step (bool — feed/advance the 1-based 'step' scalar)
    """

    def _graph(self):
        if getattr(self, "_g", None) is None:
            from ..milli.serde import graph_from_json

            self._g = graph_from_json(self.params["milli"])
            self._compiled = None
        return self._g

    def execute(self, ctx, ins):
        g = self._graph()
        feeds = dict(ins["state"])
        for name in self.params["data_inputs"]:
            feeds[name] = ins[name]
        if self.params.get("has_step"):
            feeds.setdefault("step", np.asarray(1.0, np.float32))
        if ctx.backend_mode == "oracle":
            feeds = {k: np.asarray(host_value(v)) for k, v in feeds.items()}
            out = g.eval(feeds)
        else:
            if getattr(self, "_compiled", None) is None:
                from ..backends.torch_exec.compiler import GraphExecutor

                self._compiled = GraphExecutor(g, ctx.device)
            feeds = {k: (v if isinstance(v, torch.Tensor)
                         else to_device(np.asarray(v), ctx.device))
                     for k, v in feeds.items()}
            out = self._compiled(feeds)
        new_state = {k_in: out[k_out]
                     for k_in, k_out in self.params["state_map"].items()}
        if self.params.get("has_step"):
            new_state["step"] = feeds["step"] + np.float32(1.0)
        return {"state": new_state,
                "loss": out[self.params.get("loss_output", "loss")]}


def build_training_supergraph(train_milli, meta, data_inputs: List[str],
                              name: str = "train") -> SuperGraph:
    """Wrap a milli training-step graph (training_graph.
    build_training_graph output + its TrainingMetadata) in a SuperGraph
    Scan over stacked batches.

    Graph inputs:  'init_state' (params + opt state [+ step]),
                   'batches_<x>' for each data input (stacked, axis 0)
    Graph outputs: 'final_state', 'losses' (per-step loss column).
    """
    from ..milli.serde import graph_to_json

    state_map = dict(meta.param_to_new)
    state_map.update(meta.opt_state_in_to_out)
    has_step = "step" in train_milli.inputs

    g = SuperGraph(name)
    init_l = g.mark_input("init_state", g.link(LinkKind.TENSOR_MAP,
                                               "init_state"))
    batch_ls = {d: g.mark_input(f"batches_{d}",
                                g.link(LinkKind.TENSOR, f"batches_{d}"))
                for d in data_inputs}
    final_l = g.link(LinkKind.TENSOR_MAP, "final_state")
    losses_l = g.link(LinkKind.TENSOR, "losses")

    body = SuperGraph(f"{name}_body")
    b_state = body.mark_input("state", body.link(LinkKind.TENSOR_MAP))
    b_data = {d: body.mark_input(d, body.link(LinkKind.TENSOR))
              for d in data_inputs}
    b_state_out = body.link(LinkKind.TENSOR_MAP)
    b_loss = body.link(LinkKind.TENSOR)
    body.add(MilliTrainStepNode(
        inputs={"state": b_state, **b_data},
        outputs={"state": b_state_out, "loss": b_loss},
        milli=graph_to_json(train_milli), state_map=state_map,
        data_inputs=list(data_inputs), loss_output="loss",
        has_step=has_step))
    body.mark_output("state_out", b_state_out)
    body.mark_output("loss", b_loss)

    scan = ScanNode(
        inputs={"state": init_l,
                **{f"batches_{d}": batch_ls[d] for d in data_inputs}},
        outputs={"final_state": final_l, "losses": losses_l},
        state=[("state", "state", "state_out")],
        scan_inputs=[(f"batches_{d}", d, 0) for d in data_inputs],
        scan_outputs=[("loss", "losses", 0)],
        body=None)
    scan.body = body
    g.add(scan)
    g.mark_output("final_state", final_l)
    g.mark_output("losses", losses_l)
    g.validate()
    return g


def initial_train_state(meta, params: Dict[str, np.ndarray],
                        has_step: bool = True) -> Dict[str, np.ndarray]:
    """params + zeroed optimizer state (+ step=1) as the Scan's initial
    state map."""
    from ..milli.training_graph import init_opt_state

    state = dict(params)
    state.update(init_opt_state(meta, params))
    if has_step:
        state["step"] = np.asarray(1.0, np.float32)
    return state
