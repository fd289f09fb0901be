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
has no VJP). Meshes, sharding rules and FSDP are not ported (ROADMAP
A11). The trainer runs on the card unless the caller passes
device="cpu".
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..backends.torch_exec.compiler import GraphExecutor
from ..device import resolve_device
from ..dtype import DType, to_device, to_torch
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
        freezes the base as int8. mesh, rules and fsdp are not ported
        (ROADMAP A11). device: the card unless "cpu" is passed."""
        if mesh is not None or rules is not None or fsdp:
            raise NotImplementedError(
                "LMTrainer: mesh, rules and fsdp are not ported (A11)")
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
        self._exec = GraphExecutor(milli, self.device)
        self._order = list(milli.inputs)
        self.param_dtype = param_dtype
        self.compute_dtype = compute_dtype
        self.lr = lr
        self.remat = remat
        self.tx = build_optimizer(optimizer, lr, weight_decay, grad_clip,
                                  accum_steps, lr_schedule, warmup_steps,
                                  total_steps)
        self._frozen_cache: Optional[Dict[str, torch.Tensor]] = None

    # ------------------------------------------------------------------
    def _upload(self, host: np.ndarray, dtype: DType) -> torch.Tensor:
        return to_device(np.asarray(host).astype(dtype.to_numpy(),
                                                 copy=False),
                         self.device, dtype)

    def init_params(self) -> Dict[str, torch.Tensor]:
        """The TRAINED parameters, on the trainer's device in
        param_dtype: all weights normally; only the LoRA adapters when
        lora_rank is set (the base is frozen, _frozen_params)."""
        if self.lora_rank > 0:
            return {n: self._upload(v, self.param_dtype)
                    for n, v in self._lora_init.items()}
        return {n: self._upload(self.model.graph.store.get_numeric(
                    n, self.param_dtype).numpy(), self.param_dtype)
                for n in self.weight_names}

    def _frozen_params(self) -> Dict[str, torch.Tensor]:
        """LoRA mode: the frozen base weights (int8 and their f32 scales
        where quantize_base is set), uploaded once."""
        if self.lora_rank == 0:
            return {}
        if self._frozen_cache is None:
            frozen = {}
            for n in self.weight_names:
                if n in self._quantized_base:
                    w_i8, scale = self._quantized_base[n]
                    frozen[n] = to_device(w_i8, self.device)
                    frozen[f"{n}::scale"] = to_device(scale, self.device)
                    continue
                frozen[n] = self._upload(self.model.graph.store.get_numeric(
                    n, self.param_dtype).numpy(), self.param_dtype)
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

    def _forward(self, params: Dict[str, Any], ids, frozen=None):
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
            outs = self._exec(feeds)
        return outs["logits"]

    def loss_fn(self, params, ids, targets, frozen=None) -> torch.Tensor:
        """Mean next-token NLL in the logsumexp form, f32."""
        params = self._tensors(params)
        ids = self._ids(ids)
        targets = self._ids(targets)
        if frozen is None:
            frozen = self._frozen_params()
        if self.remat == "dots":
            from torch.utils.checkpoint import (
                checkpoint, create_selective_checkpoint_contexts)

            logits = checkpoint(
                self._forward, params, ids, frozen, use_reentrant=False,
                context_fn=functools.partial(
                    create_selective_checkpoint_contexts, _dots_policy))
        elif self.remat:
            from torch.utils.checkpoint import checkpoint

            logits = checkpoint(self._forward, params, ids, frozen,
                                use_reentrant=False)
        else:
            logits = self._forward(params, ids, frozen)
        logits = logits.float()
        # logsumexp form: nll = lse(logits) - logits[target]; never
        # materializes the full (B, S, V) log-probabilities
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
        return (lse - gold).mean()

    def _ids(self, ids) -> torch.Tensor:
        if isinstance(ids, torch.Tensor):
            return ids.to(self.device, torch.int64)
        return torch.as_tensor(np.asarray(ids, dtype=np.int64),
                               device=self.device)

    def train_step(self, params, opt_state, ids, targets):
        """One optimizer step. ids/targets: (B, S) int. Returns (params,
        opt_state, loss), params and state as new tensors on the
        trainer's device, loss an f32 scalar tensor."""
        params = self._tensors(params)
        opt_state = [v if isinstance(v, torch.Tensor)
                     else to_device(np.asarray(v), self.device)
                     for v in opt_state]
        names = list(params)
        leaves = [params[n].detach().requires_grad_(True) for n in names]
        loss = self.loss_fn(dict(zip(names, leaves)), ids, targets)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad():
            grads = {n: torch.zeros_like(p) if g is None else g
                     for n, p, g in zip(names, leaves, grads)}
            updates, opt_state = self.tx.update(grads, opt_state, params)
            new = {n: (params[n] + updates[n]).to(params[n].dtype)
                   for n in names}
        return new, opt_state, loss.detach()
