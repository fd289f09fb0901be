"""dp x pp x tp composed training: the GPipe pipeline inside a trainer.

The port's copy of whisper_tensor_tpu/parallel/pipeline_trainer.py
(LayeredLM, layered_gpt2 with interleave_qkv :105, PipelinedLMTrainer
:147). A pipeline needs identical per-stage programs, so the trainer
takes a LAYERED description of the LM (embed_fn / block_fn / head_fn,
the block's parameters stacked on a leading L axis) rather than the
flat imported graph, whose layer structure ONNX erases. `layered_gpt2`
builds it from the weight getter the gpt2 recipe takes.

Where the reference runs the step as one jitted program (GSPMD outside
the pipeline's shard_map, psum inside it), each rank here runs its part
eagerly and the collectives are written out:
  * the block stack rides `pp` through the port's pipeline_apply (ring
    shifts, the last stage's output broadcast), each rank holding only
    its layers, cut on `tp` by the block's specs, and its optimizer
    state for them;
  * microbatch rows are cut over `dp` (pipeline_apply's batch_axis);
  * Megatron tp inside the block (qkv and fc column-cut, proj and mp
    row-cut): a replicated input enters each column-parallel product
    through comm.copy_in and each row-parallel sum leaves through
    comm.reduce_out, the gradient rules of the one loss every tp rank
    computes (the reference's psum inside shard_map transposes the same
    way);
  * embed and head run on the whole batch on every rank, their weights
    whole.
Gradients. Every rank computes the same loss L from the gathered logits,
and backpropagates L / dp: pipeline_apply's dp gather sums the ranks'
gradients of its output (comm.all_gather's rule, made for a sum of
per-rank terms), which gives each rank its rows of dL/dy. Every
parameter's gradient is then summed over dp, which makes each the
gradient of L: the block's from each rank's rows, the head's from its dp
shares of L. The embedding's output enters the pipeline through copy_in
over pp, since only the first stage reads it. The loss is the reference's
log_softmax form (:206-221).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from . import comm
from .mesh import Mesh, Sharding, local_block
from .pipeline import pipeline_apply


class LayeredLM(NamedTuple):
    """A pipeline-stageable LM: logits = head(h_L), h_l = block(p_l,
    h_{l-1}), h_0 = embed(ids)."""

    embed_fn: Callable          # (embed_params, ids) -> h (B,S,D)
    block_fn: Callable          # (block_params_one_layer, h, mesh) -> h
    head_fn: Callable           # (head_params, h) -> logits
    embed_params: Dict[str, Any]
    block_params: Dict[str, Any]   # leaves stacked (L, ...)
    head_params: Dict[str, Any]
    block_specs: Optional[Dict[str, tuple]] = None  # tp spec tuples


def _ln(h, g, b, eps=1e-5):
    mu = h.mean(-1, keepdim=True)
    v = ((h - mu) ** 2).mean(-1, keepdim=True)
    return (h - mu) / torch.sqrt(v + eps) * g + b


def layered_gpt2(cfg, weight_getter, tp_axis: Optional[str] = None
                 ) -> LayeredLM:
    """A LayeredLM from a gpt2 HF-layout weight getter (the callable the
    recipe importers.recipes.llm.gpt2.build_gpt2_* takes, e.g.
    random_gpt2_weights(cfg)); parameters as host arrays. tp_axis: the
    mesh axis of Megatron tensor parallelism inside the block (None: no
    tp)."""
    H, D = cfg.n_head, cfg.n_embd
    hd = D // H
    tp = tp_axis

    def embed_fn(p, ids):
        S = ids.shape[1]
        return p["wte"][ids] + p["wpe"][:S][None]

    def block_fn(p, h, mesh: Optional[Mesh] = None):
        # wqkv's columns are per head [q_h k_h v_h] (interleave_qkv), so
        # a contiguous tp column block holds whole heads
        cut = tp is not None and mesh is not None
        x = _ln(h, p["ln1g"], p["ln1b"])
        if cut:
            x = comm.copy_in(x, mesh, tp)
        qkv = x @ p["wqkv"] + p["bqkv"]                 # (B,S,3*D/tp)
        Hl = qkv.shape[-1] // (3 * hd)
        B, S = x.shape[:2]
        t = qkv.reshape(B, S, Hl, 3, hd).permute(0, 2, 3, 1, 4)
        q, k, v = t[:, :, 0], t[:, :, 1], t[:, :, 2]  # (B,Hl,S,hd)
        scores = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
        mask = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
        scores = scores.masked_fill(~mask, -torch.inf)
        ctx = torch.softmax(scores, dim=-1) @ v
        ctx = ctx.transpose(1, 2).reshape(B, S, Hl * hd)
        proj = ctx @ p["wproj"]                         # row-cut: partial
        if cut:
            proj = comm.reduce_out(proj, mesh, tp)
        h = h + proj + p["bproj"]
        x2 = _ln(h, p["ln2g"], p["ln2b"])
        if cut:
            x2 = comm.copy_in(x2, mesh, tp)
        ff = torch.nn.functional.gelu(x2 @ p["wfc"] + p["bfc"],
                                      approximate="tanh")
        mp = ff @ p["wmp"]                              # row-cut: partial
        if cut:
            mp = comm.reduce_out(mp, mesh, tp)
        return h + mp + p["bmp"]

    def head_fn(p, h):
        return _ln(h, p["lnfg"], p["lnfb"]) @ p["wte_t"]

    L = cfg.n_layer

    def w(name):
        return np.asarray(weight_getter(name))

    def interleave_qkv(t):
        # recipe layout (D, [q|k|v]) -> (D, [q_h k_h v_h per head])
        if t.ndim == 2:
            return t.reshape(D, 3, H, hd).transpose(0, 2, 1, 3).reshape(
                D, 3 * D)
        return t.reshape(3, H, hd).transpose(1, 0, 2).reshape(3 * D)

    hf = {
        "ln1g": "ln_1.weight", "ln1b": "ln_1.bias",
        "wqkv": "attn.c_attn.weight", "bqkv": "attn.c_attn.bias",
        "wproj": "attn.c_proj.weight", "bproj": "attn.c_proj.bias",
        "ln2g": "ln_2.weight", "ln2b": "ln_2.bias",
        "wfc": "mlp.c_fc.weight", "bfc": "mlp.c_fc.bias",
        "wmp": "mlp.c_proj.weight", "bmp": "mlp.c_proj.bias",
    }

    def get(key, i):
        t = w(f"transformer.h.{i}.{hf[key]}")
        return interleave_qkv(t) if key in ("wqkv", "bqkv") else t

    block_params = {k: np.stack([get(k, i) for i in range(L)]) for k in hf}
    block_specs = {
        "ln1g": (), "ln1b": (),
        "wqkv": (None, tp), "bqkv": (tp,),
        "wproj": (tp, None), "bproj": (),
        "ln2g": (), "ln2b": (),
        "wfc": (None, tp), "bfc": (tp,),
        "wmp": (tp, None), "bmp": (),
    } if tp is not None else None
    wte = w("transformer.wte.weight")
    return LayeredLM(
        embed_fn, block_fn, head_fn,
        embed_params={"wte": wte, "wpe": w("transformer.wpe.weight")},
        block_params=block_params,
        head_params={"lnfg": w("transformer.ln_f.weight"),
                     "lnfb": w("transformer.ln_f.bias"),
                     "wte_t": wte.T.copy()},
        block_specs=block_specs)


def _flat(params: Dict[str, Dict[str, torch.Tensor]]
          ) -> Dict[str, torch.Tensor]:
    return {f"{g}/{k}": v for g, d in params.items() for k, v in d.items()}


def _nest(flat: Dict[str, torch.Tensor]
          ) -> Dict[str, Dict[str, torch.Tensor]]:
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, v in flat.items():
        g, k = key.split("/", 1)
        out.setdefault(g, {})[k] = v
    return out


class PipelinedLMTrainer:
    """Next-token cross-entropy trainer over a LayeredLM on a (dp, pp,
    tp) mesh (parallel.mesh.Mesh; every rank builds it and steps alike).

    The block stack rides the GPipe pipeline (pp), microbatch rows are
    cut over dp, Megatron tp runs inside the block; embed and head run
    whole on every rank (see the module's docstring). Parameters are a
    {"embed", "block", "head"} dict of tensors on the mesh's device, the
    block's this rank's layers and tp blocks."""

    def __init__(self, layered: LayeredLM, mesh: Mesh, microbatches: int = 4,
                 lr: float = 3e-4, optimizer: str = "adamw",
                 weight_decay: float = 0.01):
        from ..training.optim import build_optimizer

        if optimizer not in ("adamw", "sgd"):
            raise ValueError(optimizer)
        self.lm = layered
        self.mesh = mesh
        self.microbatches = microbatches
        self.pp = mesh.shape.get("pp", 1)
        self.dp = mesh.shape.get("dp", 1)
        self.dp_axis = "dp" if self.dp > 1 else None
        L = next(iter(layered.block_params.values())).shape[0]
        if L % max(self.pp, 1):
            raise ValueError(f"n_layer {L} not divisible by pp {self.pp}")
        self.tx = build_optimizer(optimizer, lr, weight_decay, None, 1, None,
                                  0, 0)

    # -- parameter placement -------------------------------------------
    def block_sharding(self, name: str) -> Sharding:
        """Where a block leaf lies: its layers over pp, its tp spec."""
        spec = self.lm.block_specs[name] if self.lm.block_specs else ()
        return Sharding(self.mesh, ("pp", *spec))

    def init_params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        dev = self.mesh.device

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        lm = self.lm
        return {
            "embed": {k: up(v) for k, v in lm.embed_params.items()},
            "block": {k: up(local_block(np.asarray(v),
                                        self.block_sharding(k), k))
                      for k, v in lm.block_params.items()},
            "head": {k: up(v) for k, v in lm.head_params.items()},
        }

    def init_opt_state(self, params):
        return self.tx.init(_flat(params))

    # -- the composed step ---------------------------------------------
    def _stage(self, p, h):
        return self.lm.block_fn(p, h, mesh=self.mesh)

    def loss_fn(self, params, ids, targets) -> torch.Tensor:
        """Mean next-token NLL (log_softmax form), the same on every
        rank."""
        dev = self.mesh.device
        ids = torch.as_tensor(np.asarray(ids, np.int64), device=dev)
        targets = torch.as_tensor(np.asarray(targets, np.int64), device=dev)
        h = self.lm.embed_fn(params["embed"], ids)
        if self.pp > 1:
            h = comm.copy_in(h, self.mesh, "pp")
        h = pipeline_apply(self._stage, params["block"], h, self.mesh,
                           axis="pp", microbatches=self.microbatches,
                           batch_axis=self.dp_axis)
        logits = self.lm.head_fn(params["head"], h).float()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        return nll.mean()

    def value_and_grad(self, params, ids, targets):
        """(loss, gradients): the whole batch's loss and, nested as
        params are, each rank's gradients of its blocks of it (the
        ranks' shares summed over dp)."""
        flat = _flat(params)
        names = list(flat)
        leaves = [flat[n].detach().requires_grad_(True) for n in names]
        loss = self.loss_fn(_nest(dict(zip(names, leaves))), ids, targets)
        grads = torch.autograd.grad(loss / self.dp, leaves,
                                    allow_unused=True)
        with torch.no_grad():
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]
            if self.dp_axis is not None:
                grads = comm.all_reduce_many(grads, self.mesh, "dp")
        return loss.detach(), _nest(dict(zip(names, grads)))

    def train_step(self, params, opt_state, ids, targets):
        """One optimizer step on the whole (B, S) batch, the same on
        every rank; returns (params, opt_state, loss)."""
        flat = _flat(params)
        loss, grads = self.value_and_grad(params, ids, targets)
        with torch.no_grad():
            updates, opt_state = self.tx.update(_flat(grads), opt_state,
                                                flat)
            new = {n: (flat[n] + updates[n]).to(flat[n].dtype)
                   for n in flat}
        return _nest(new), opt_state, loss
