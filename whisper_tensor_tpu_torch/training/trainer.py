"""LM trainer: PyTorch autograd over the port's executor.

The port's copy of whisper_tensor_tpu/training/trainer.py (LMTrainer).
The reference takes jax.grad of a traced milli graph and steps an optax
optimizer; here autograd differentiates the same milli graph as the
port's GraphExecutor runs it on the card, and the optimizer is optax's
formulas in plain torch ops (training/optim.py, whose state leaves are
optax's, so checkpoints interchange: training/checkpoint.py).

What is kept from the reference: the graph (`to_milli(
bake_small_constants=False)`, every weight a graph input, no fusion
pass), the per-step cast of the f32 masters to `compute_dtype` (the
`::scale` inputs of an int8 base stay f32), the logsumexp loss, LoRA
adapters (milli/transforms.py inject_lora) with a frozen base, the
int8-frozen base (quantize_matmul_weights; its products run the
int8_matmul kernel, differentiated by Int8MatMul, whose backward is the
int8_matmul_dx kernel), remat (True: torch.utils.checkpoint over the
forward; "dots": selective checkpointing that saves the 2-D products'
outputs, as dots_with_no_batch_dims_saveable does) and the forward's
attention on the plain path (kernel_attention_disabled(): the
attention kernels have no backward, as the reference's flash kernel
has no VJP). The trainer runs on the card unless the caller passes
device="cpu".

Under a mesh (parallel/mesh.py; every rank of the world builds the
trainer and calls its steps alike) the reference places each weight
with a NamedSharding from `rules` (GPT2_RULES by default) and lets GSPMD
insert the collectives (:146-154, :183, :330-337). Here each rank runs
its share of the graph:
  * tp: the graph pass parallel/tp.py in its training mode cuts the
    weights the rules cut and inserts the collectives of one replicated
    loss; `tp_plan` is the rank's plan;
  * dp and sp: the batch's rows are cut over dp and its sequence over sp
    where sp divides it (parallel/mesh.py data_sharding), the sequence
    by the pass parallel/sp.py; each rank's loss is its tokens' term of
    the global mean, and reduce_out sums the terms into the loss every
    rank returns; the gradients are summed over the axes that cut the
    batch (comm.all_reduce_many), so a step equals the single-device
    step on the whole batch;
  * fsdp: the masters and the optimizer state of every weight of at
    least fsdp_min_size elements are cut over dp too (fsdp_shardings),
    each gathered over dp where the graph reads it, its gradient
    reduce-scattered in the backward (the all_gather's own rule), as
    the reference pins with with_sharding_constraint (:303-314);
  * LoRA adapters stay whole on every rank, and so does an int8-frozen
    base (the reference's _frozen_params leaves it unplaced); a frozen
    base that is not quantized is cut by the rules;
  * grad_clip's global norm counts each element once: the squared sums
    of a cut leaf are summed over the axes that cut it.
`param_shardings` (parallel.mesh.Sharding, by weight_names) says where
each weight lies; training/checkpoint.py gathers and cuts by it.
"""

from __future__ import annotations

import copy
import functools
import re
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..backends.torch_exec.compiler import GraphExecutor
from ..device import resolve_device
from ..dtype import DType, to_device, to_torch
from ..graph import new_global_id
from ..milli.ir import MilliGraph, MilliNode
from ..milli.ops.attention import kernel_attention_disabled
from ..model import Model
from .optim import build_optimizer


def _dots_policy(ctx, op, *args, **kwargs):
    """remat="dots": keep the outputs of products without batch dims (the
    2-D aten.mm the weight products reduce to), recompute the rest, the
    (B, H, S, S) attention scores' batched products among it."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class LMTrainer:
    """Next-token cross-entropy trainer over a training-mode graph
    (inputs: input_ids; outputs: logits)."""

    def __init__(self, model: Model, optimizer: str = "adamw",
                 lr: float = 3e-4, weight_decay: float = 0.01,
                 mesh=None, rules=None, param_dtype: DType = DType.F32,
                 grad_clip: Optional[float] = None,
                 compute_dtype: Optional[DType] = None,
                 accum_steps: int = 1,
                 lr_schedule: Optional[str] = None,
                 warmup_steps: int = 0, total_steps: int = 0,
                 remat: "bool | str" = False, fsdp: bool = False,
                 fsdp_min_size: int = 2 ** 16,
                 lora_rank: int = 0, lora_alpha: Optional[float] = None,
                 lora_targets: Optional[Sequence[str]] = None,
                 quantize_base: Optional[str] = None, device=None):
        """The reference's arguments, with their meaning (see its
        docstring): grad_clip is optax's global-norm clipping,
        compute_dtype the per-step cast of the masters, accum_steps
        optax.MultiSteps, lr_schedule None | "warmup_cosine" |
        "warmup_linear", remat False | True | "dots", lora_rank > 0
        trains only adapters on the 2-D weight MatMuls whose names hold
        one of lora_targets, quantize_base="int8" (with lora_rank > 0)
        freezes the base as int8. mesh: a parallel.mesh.Mesh (see the
        module's docstring), whose ranks each build the trainer; rules:
        its sharding rules (GPT2_RULES when None); fsdp cuts the weights
        of at least fsdp_min_size elements over dp as well. Without a
        mesh, rules and fsdp do nothing, as in the reference. device:
        the card unless "cpu" is passed (under a mesh, the mesh's)."""
        if mesh is not None:
            from ..parallel.mesh import Mesh

            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.mesh.Mesh (see "
                                f"make_mesh), not {type(mesh).__name__}")
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        self.model = model
        milli, weight_inputs = model.graph.to_milli(bake_small_constants=False)
        self.milli = milli
        self.weight_names = [n for n in milli.inputs if n in weight_inputs]
        self.data_names = [n for n in milli.inputs if n not in weight_inputs]
        self.lora_rank = lora_rank
        self._lora_init: Dict[str, np.ndarray] = {}
        if lora_rank > 0:
            from ..milli.transforms import inject_lora

            targets = [n for n in self.weight_names
                       if lora_targets is None
                       or any(t in n for t in lora_targets)]
            self._lora_init = inject_lora(
                milli, targets, rank=lora_rank,
                weight_getter=lambda n: model.graph.store.get_numeric(
                    n, param_dtype).numpy(),
                alpha=lora_alpha)
            if not self._lora_init:
                raise ValueError(
                    "lora_rank set but no 2-D weight MatMul matched "
                    f"lora_targets={lora_targets!r}")
        self._quantized_base = {}
        if quantize_base is not None:
            if quantize_base != "int8":
                raise ValueError(f"quantize_base={quantize_base!r}")
            if lora_rank == 0:
                raise ValueError("quantize_base needs lora_rank > 0 "
                                 "(only a frozen base can be quantized)")
            from ..milli.transforms import quantize_matmul_weights

            self._quantized_base = quantize_matmul_weights(
                milli, self.weight_names,
                lambda n: model.graph.store.get_numeric(
                    n, DType.F32).numpy())
        self._order = list(milli.inputs)
        self.mesh = mesh
        self.fsdp = fsdp and mesh is not None
        self.fsdp_min_size = fsdp_min_size
        self.param_dtype = param_dtype
        self.tp_plan = None
        self.param_shardings = None
        self._fsdp_dims: Dict[str, int] = {}
        self._leaf_axes: Dict[str, tuple] = {}
        self._graph = milli
        if mesh is not None:
            self._graph = self._shard(rules)
        self._exec = GraphExecutor(self._graph, self.device)
        self._seq_execs: Dict[int, GraphExecutor] = {}
        self.compute_dtype = compute_dtype
        self.lr = lr
        self.remat = remat
        self.tx = build_optimizer(
            optimizer, lr, weight_decay, grad_clip, accum_steps,
            lr_schedule, warmup_steps, total_steps,
            norm_sq=None if mesh is None else self._global_sq)
        self._frozen_cache: Optional[Dict[str, torch.Tensor]] = None

    # -- the mesh --------------------------------------------------------
    def _shard(self, rules) -> MilliGraph:
        """This rank's graph under the mesh, with `param_shardings`,
        `tp_plan` and the fsdp gathers."""
        from ..parallel.mesh import (GPT2_RULES, Sharding, fsdp_shardings)
        from ..parallel.tp import shard_graph

        mesh = self.mesh
        self._rules = list(rules if rules is not None else GPT2_RULES)
        store = self.model.graph.store
        shapes, dtypes = {}, {}
        for n in self.weight_names:
            if n in self._quantized_base:
                w_i8, scale = self._quantized_base[n]
                shapes[n], dtypes[n] = w_i8.shape, DType.I8
                shapes[f"{n}::scale"] = scale.shape
                dtypes[f"{n}::scale"] = DType.F32
            else:
                shapes[n] = tuple(store.get(n).shape)
                dtypes[n] = self.param_dtype
        for n, v in self._lora_init.items():
            shapes[n], dtypes[n] = v.shape, self.param_dtype
        graph = self.milli
        plan_inputs = {}
        if mesh.shape.get("tp", 1) > 1:
            # an int8-frozen base stays whole on every rank
            exact = [(f"^{re.escape(n)}$", None) for n in self._quantized_base]
            self.tp_plan = shard_graph(self.milli, mesh, exact + self._rules,
                                       shapes, dtypes, training=True)
            graph, plan_inputs = self.tp_plan.graph, self.tp_plan.inputs
        shardings = []
        for n in self.weight_names:
            shape = shapes[n]
            spec, cuts = [None] * len(shape), [1] * len(shape)
            split = plan_inputs.get(n)
            if split is not None:
                spec[split.dim], cuts[split.dim] = "tp", split.sections
            if self.fsdp and n not in self._quantized_base:
                (fs,) = fsdp_shardings(
                    [n], [shape], mesh, rules=[(f"^{re.escape(n)}$",
                                                tuple(spec))],
                    min_size=self.fsdp_min_size)
                spec = list(fs.spec)
                if "dp" in spec and mesh.shape.get("dp", 1) > 1:
                    self._fsdp_dims[n] = spec.index("dp")
            sh = Sharding(mesh, tuple(spec), tuple(cuts))
            shardings.append(sh)
            self._leaf_axes[n] = sh.axes()
        self.param_shardings = shardings
        if self._fsdp_dims:
            graph = self._gather_fsdp(graph)
        return graph

    def _gather_fsdp(self, graph: MilliGraph) -> MilliGraph:
        """A copy of `graph` in which every fsdp-cut weight is gathered
        over dp just before the first node that reads it (AllGather: its
        backward reduce-scatters the gradient over dp)."""
        from ..parallel.tp import AllGatherMilli

        g = copy.deepcopy(graph) if graph is self.milli else graph
        whole = {}
        for n, d in self._fsdp_dims.items():
            whole[g.inputs[n]] = (g.new_tensor(label=f"{n}::gathered"),
                                  AllGatherMilli(mesh=self.mesh, axis="dp",
                                                 dim=d))
        nodes, placed = [], set()
        for node in g.nodes:
            for k, t in enumerate(node.inputs):
                if t in whole:
                    out, op = whole[t]
                    if t not in placed:
                        nodes.append(MilliNode(new_global_id(), op, [t],
                                               [out]))
                        placed.add(t)
                    node.inputs[k] = out
            nodes.append(node)
        g.nodes = nodes
        return g

    def _exec_for(self, ids: torch.Tensor, data) -> GraphExecutor:
        """The executor of the local ids of a batch placed by `data`:
        the sequence pass's graph where sp cuts the sequence."""
        if data is None or data.spec[1] is None:
            return self._exec
        tokens = int(ids.shape[1])
        if tokens not in self._seq_execs:
            from ..parallel.sp import shard_sequence

            self._seq_execs[tokens] = GraphExecutor(
                shard_sequence(self._graph, self.mesh, tokens), self.device)
        return self._seq_execs[tokens]

    def _global_sq(self, updates: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The squared global norm of sharded updates: each leaf's local
        squared sum, summed over the axes that cut it (a whole leaf counts
        once)."""
        from ..parallel import comm

        groups: Dict[tuple, torch.Tensor] = {}
        for n in sorted(updates):
            u = updates[n]
            axes = self._leaf_axes.get(n, ())
            groups[axes] = groups.get(axes, 0) + torch.sum(u * u)
        total = 0
        for axes in sorted(groups):
            sq = groups[axes]
            for a in axes:
                sq = comm.all_reduce(sq, self.mesh, a)
            total = total + sq
        return total

    # ------------------------------------------------------------------
    def _upload(self, host: np.ndarray, dtype: DType) -> torch.Tensor:
        return to_device(np.asarray(host).astype(dtype.to_numpy(),
                                                 copy=False),
                         self.device, dtype)

    def _weight(self, i: int, n: str) -> torch.Tensor:
        """Weight `n` (the i-th of weight_names) in param_dtype on the
        device: under a mesh, this rank's block of it only."""
        host = self.model.graph.store.get_numeric(n, self.param_dtype).numpy()
        if self.param_shardings is not None:
            from ..parallel.mesh import local_block

            host = local_block(host, self.param_shardings[i], n)
        return self._upload(host, self.param_dtype)

    def init_params(self) -> Dict[str, torch.Tensor]:
        """The TRAINED parameters, on the trainer's device in
        param_dtype: all weights normally (under a mesh, this rank's
        blocks); only the LoRA adapters, whole, when lora_rank is set
        (the base is frozen, _frozen_params)."""
        if self.lora_rank > 0:
            return {n: self._upload(v, self.param_dtype)
                    for n, v in self._lora_init.items()}
        return {n: self._weight(i, n) for i, n in enumerate(self.weight_names)}

    def _frozen_params(self) -> Dict[str, torch.Tensor]:
        """LoRA mode: the frozen base weights (int8 and their f32 scales
        where quantize_base is set), uploaded once."""
        if self.lora_rank == 0:
            return {}
        if self._frozen_cache is None:
            frozen = {}
            for i, n in enumerate(self.weight_names):
                if n in self._quantized_base:
                    w_i8, scale = self._quantized_base[n]
                    frozen[n] = to_device(w_i8, self.device)
                    frozen[f"{n}::scale"] = to_device(scale, self.device)
                    continue
                frozen[n] = self._weight(i, n)
            self._frozen_cache = frozen
        return self._frozen_cache

    def init_opt_state(self, params) -> List[torch.Tensor]:
        """The optimizer state: a list of tensors in optax's leaf order
        for the same optimizer (training/optim.py)."""
        return self.tx.init(self._tensors(params))

    # ------------------------------------------------------------------
    def _tensors(self, params) -> Dict[str, torch.Tensor]:
        """params (tensors or host arrays, a loaded checkpoint's) on the
        trainer's device."""
        out = {}
        for n, v in params.items():
            if not isinstance(v, torch.Tensor):
                arr = np.asarray(v)
                v = to_device(arr, self.device)
            out[n] = v.to(self.device)
        return out

    def _forward(self, params: Dict[str, Any], ids, frozen=None,
                 exe: Optional[GraphExecutor] = None):
        if self.compute_dtype is not None:
            cdt = to_torch(self.compute_dtype)

            def cast(d):
                # quant scales stay f32: an int8 base's accuracy rides
                # entirely on its per-channel scales
                return {k: (v.to(cdt) if v.is_floating_point()
                            and not k.endswith("::scale") else v)
                        for k, v in d.items()}

            params = cast(params)
            frozen = cast(frozen) if frozen else frozen
        by_name = dict(frozen or {})
        by_name.update(params)
        by_name["input_ids"] = ids
        feeds = {n: by_name[n] for n in self._order}
        # the forward will be differentiated: the attention kernels have
        # no backward, so every Attention call runs the plain path
        with kernel_attention_disabled():
            outs = (exe or self._exec)(feeds)
        return outs["logits"]

    def _data(self, ids):
        """Where a (B, S) batch lies on the mesh (None without one)."""
        if self.mesh is None:
            return None
        from ..parallel.mesh import data_sharding

        return data_sharding(self.mesh, ids.shape)

    def loss_fn(self, params, ids, targets, frozen=None) -> torch.Tensor:
        """Mean next-token NLL in the logsumexp form, f32. ids/targets:
        the whole (B, S) batch. Under a mesh, params are this rank's
        blocks, the rank runs its rows and tokens, and the loss (the
        same on every rank) is the sum of the ranks' terms; its
        gradients on a rank are that rank's terms' (train_step sums
        them)."""
        params = self._tensors(params)
        ids = self._ids(ids)
        targets = self._ids(targets)
        count = targets.numel()
        data = self._data(ids)
        if data is not None:
            from ..parallel.mesh import local_block

            ids = local_block(ids, data, "input_ids")
            targets = local_block(targets, data, "targets")
        exe = self._exec_for(ids, data)
        if frozen is None:
            frozen = self._frozen_params()
        if self.remat == "dots":
            from torch.utils.checkpoint import (
                checkpoint, create_selective_checkpoint_contexts)

            logits = checkpoint(
                self._forward, params, ids, frozen, exe, use_reentrant=False,
                context_fn=functools.partial(
                    create_selective_checkpoint_contexts, _dots_policy))
        elif self.remat:
            from torch.utils.checkpoint import checkpoint

            logits = checkpoint(self._forward, params, ids, frozen, exe,
                                use_reentrant=False)
        else:
            logits = self._forward(params, ids, frozen, exe)
        logits = logits.float()
        # logsumexp form: nll = lse(logits) - logits[target]; never
        # materializes the full (B, S, V) log-probabilities
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
        if data is None or not data.axes():
            return (lse - gold).mean()
        from ..parallel import comm

        loss = (lse - gold).sum() / count
        for a in data.axes():
            loss = comm.reduce_out(loss, self.mesh, a)
        return loss

    def _ids(self, ids) -> torch.Tensor:
        if isinstance(ids, torch.Tensor):
            return ids.to(self.device, torch.int64)
        return torch.as_tensor(np.asarray(ids, dtype=np.int64),
                               device=self.device)

    def value_and_grad(self, params, ids, targets):
        """(loss, {name: gradient}) of loss_fn at params; under a mesh
        each rank's gradients of its blocks of the whole batch's loss
        (summed over the axes that cut the batch)."""
        params = self._tensors(params)
        ids, targets = self._ids(ids), self._ids(targets)
        names = list(params)
        leaves = [params[n].detach().requires_grad_(True) for n in names]
        loss = self.loss_fn(dict(zip(names, leaves)), ids, targets)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad():
            grads = {n: torch.zeros_like(p) if g is None else g
                     for n, p, g in zip(names, leaves, grads)}
            data = self._data(ids)
            if data is not None:
                from ..parallel import comm

                for a in data.axes():
                    # fsdp's gathers reduce-scattered over dp already
                    sum_up = [n for n in names if not (
                        a == "dp" and n in self._fsdp_dims)]
                    grads.update(zip(sum_up, comm.all_reduce_many(
                        [grads[n] for n in sum_up], self.mesh, a)))
        return loss.detach(), grads

    def train_step(self, params, opt_state, ids, targets):
        """One optimizer step. ids/targets: (B, S) int, the whole batch
        on every rank of a mesh. Returns (params, opt_state, loss),
        params and state as new tensors on the trainer's device (under
        a mesh, this rank's blocks), loss an f32 scalar tensor (the same
        on every rank)."""
        params = self._tensors(params)
        opt_state = [v if isinstance(v, torch.Tensor)
                     else to_device(np.asarray(v), self.device)
                     for v in opt_state]
        loss, grads = self.value_and_grad(params, ids, targets)
        names = list(params)
        with torch.no_grad():
            updates, opt_state = self.tx.update(grads, opt_state, params)
            new = {n: (params[n] + updates[n]).to(params[n].dtype)
                   for n in names}
        return new, opt_state, loss
