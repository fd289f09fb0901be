"""Expert parallelism (EP) for MoE layers: GShard-style dense dispatch.

The port's counterpart of whisper_tensor_tpu/parallel/moe.py. Expert
weights are stacked on a leading E axis; routing is one-hot dispatch and
combine tensors (static shapes: each expert takes at most C tokens, the
rest of its tokens are dropped and contribute zero; capacity_factor >=
E/k drops none, C = ceil(T*k*cf / E)).

  router logits (T,E) -> top-k gates -> dispatch (T,E,C) one-hot /
  combine (T,E,C) weights -> expert inputs (E,C,D) -> batched SwiGLU
  FFN -> combine back to (T,D).

On a mesh the reference lets GSPMD move the tokens. Here every rank
holds all the tokens and routes them alike; under `ep` a rank holds
E/ep experts (shard_moe_params) and runs them on its slice of the
dispatch, under `tp` a rank holds F/tp of each expert's hidden units,
and the rank's partial (T, D) is summed over both axes (all_reduce).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from . import comm
from .mesh import Mesh, Sharding, shard_array


def moe_capacity(n_tokens: int, n_experts: int, k: int,
                 capacity_factor: float = 1.25) -> int:
    """Per-expert token capacity, a multiple of 8 from 8 tokens up
    (reference :29)."""
    c = int(math.ceil(n_tokens * k * capacity_factor / n_experts))
    return max(8, ((c + 7) // 8) * 8) if n_tokens >= 8 else max(1, c)


def top_k_dispatch(logits: torch.Tensor, k: int, capacity: int,
                   norm_topk: bool = True, scale: float = 1.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dispatch (T,E,C) f32 one-hot, combine (T,E,C) f32) from router
    logits (T, E) (reference :36): the softmax gates of each token's
    top-k experts, renormalized over the k when norm_topk, times
    `scale`; each expert takes its tokens in order up to `capacity`."""
    T, E = logits.shape
    gates = torch.softmax(logits.float(), dim=-1)
    _, topi = torch.topk(gates, k, dim=-1)                       # (T, k)
    mask = torch.nn.functional.one_hot(topi, E).float().sum(dim=1)
    sel = gates * mask
    if norm_topk:
        sel = sel / sel.sum(-1, keepdim=True).clamp_min(1e-20)
    sel = sel * scale
    # position of each token in its expert's buffer (first-come order)
    pos = torch.cumsum(mask, dim=0) * mask - 1.0        # (T, E), -1 unrouted
    keep = (pos >= 0) & (pos < capacity)
    slot = torch.where(keep, pos, 0.0).long()
    dispatch = torch.nn.functional.one_hot(slot, capacity).float() \
        * keep[..., None].float()
    return dispatch, dispatch * sel[..., None]


def _experts(x, dispatch, combine, w_gate, w_up, w_down):
    """The SwiGLU experts of the stacks on their dispatch slices:
    (T, D) in x's type, before any sum over ranks."""
    xin = torch.einsum("tec,td->ecd", dispatch, x.float()).to(x.dtype)
    g = torch.einsum("ecd,edf->ecf", xin.float(), w_gate.float())
    u = torch.einsum("ecd,edf->ecf", xin.float(), w_up.float())
    h = (g * torch.reciprocal(1.0 + torch.exp(-g)) * u).to(x.dtype)
    out_e = torch.einsum("ecf,efd->ecd", h.float(), w_down.float())
    return torch.einsum("tec,ecd->td", combine, out_e)


def moe_ffn(x, router_w, w_gate, w_up, w_down, k: int,
            capacity: Optional[int] = None, capacity_factor: float = 1.25,
            norm_topk: bool = True, scale: float = 1.0,
            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Top-k routed SwiGLU MoE over stacked expert weights (reference
    :69).

    x: (T, D) tokens. router_w: (E, D). Without a mesh w_gate, w_up:
    (E, D, F), w_down: (E, F, D). With a mesh they are this rank's
    shards (shard_moe_params: E/ep experts, F/tp hidden units), x and
    router_w whole on every rank, and the result (T, D) is whole on
    every rank."""
    T, D = x.shape
    E = router_w.shape[0]
    C = capacity if capacity is not None else moe_capacity(
        T, E, k, capacity_factor)
    logits = torch.einsum("td,ed->te", x.float(), router_w.float())
    dispatch, combine = top_k_dispatch(logits, k, C, norm_topk=norm_topk,
                                       scale=scale)
    if mesh is not None and "ep" in mesh.shape:
        n = E // mesh.shape["ep"]
        lo = mesh.index("ep") * n
        dispatch = dispatch[:, lo:lo + n]
        combine = combine[:, lo:lo + n]
    out = _experts(x, dispatch, combine, w_gate, w_up, w_down)
    if mesh is not None:
        for axis in ("tp", "ep"):
            if axis in mesh.shape:
                out = comm.all_reduce(out, mesh, axis)
    return out.to(x.dtype)


def moe_param_specs() -> Dict[str, Tuple]:
    """Specs of the stacked expert weights: experts over `ep`, FFN hidden
    over `tp` (megatron column/row split inside each expert)."""
    return {
        "router_w": (None, None),
        "w_gate": ("ep", None, "tp"),
        "w_up": ("ep", None, "tp"),
        "w_down": ("ep", "tp", None),
    }


def shard_moe_params(params: Dict, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's shards of a {router_w, w_gate, w_up, w_down} dict of
    host or device arrays, on its device (reference :136)."""
    specs = moe_param_specs()
    out = {}
    for name, v in params.items():
        spec = tuple(a if a in mesh.shape else None for a in specs[name])
        out[name] = shard_array(v, Sharding(mesh, spec), name)
    return out


def load_balance_loss(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Switch-Transformer auxiliary load-balance loss E * sum_e f_e P_e
    (reference :150): f_e the share of top-k picks of expert e (no
    gradient), P_e its mean router probability; 1.0 for a uniform
    router."""
    T, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    _, topi = torch.topk(probs, k, dim=-1)
    counts = torch.nn.functional.one_hot(topi, E).float().sum(
        dim=(0, 1)).detach()
    f = counts / (T * k)
    return E * torch.sum(f * probs.mean(dim=0))


def moe_ffn_with_aux(x, router_w, w_gate, w_up, w_down, k: int,
                     capacity=None, capacity_factor: float = 1.25,
                     norm_topk: bool = True, scale: float = 1.0,
                     aux_weight: float = 0.01,
                     mesh: Optional[Mesh] = None):
    """moe_ffn plus the weighted auxiliary loss, the training form
    (reference :171). Returns (output, aux_loss)."""
    logits = torch.einsum("td,ed->te", x.float(), router_w.float())
    out = moe_ffn(x, router_w, w_gate, w_up, w_down, k=k,
                  capacity=capacity, capacity_factor=capacity_factor,
                  norm_topk=norm_topk, scale=scale, mesh=mesh)
    return out, aux_weight * load_balance_loss(logits, k)
