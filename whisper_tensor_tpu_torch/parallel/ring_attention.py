"""Ring attention: exact attention over a sequence sharded across the
ranks of a mesh axis (context parallelism).

The port's counterpart of whisper_tensor_tpu/parallel/ring_attention.py.
Queries stay on their rank; K/V blocks travel round the ring by the
ring shift (parallel/comm.py, the reference's ppermute) while each rank
keeps flash-style online-softmax statistics (running max m, normalizer
l, accumulator acc), so the result equals full attention with O(S/N)
memory a rank. The math of each block is plain torch in f32, as the
reference's einsums are; the causal mask is built from the shard index
of the block's origin.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import comm
from .mesh import Mesh


def _online_update(acc, m, l, s, v):
    """One flash-attention statistics update with new scores s
    (..., q, k) and values v (..., k, d) (reference :24)."""
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    # guard fully-masked blocks
    dead = torch.isinf(m_new)
    m_safe = torch.where(dead, 0.0, m_new)
    p = torch.where(dead, 0.0, torch.exp(s - m_safe))
    alpha = torch.where(torch.isinf(m), 0.0,
                        torch.exp(torch.where(torch.isinf(m), -torch.inf, m)
                                  - m_safe))
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + torch.einsum("...qk,...kd->...qd", p,
                                         v.float())
    return acc_new, m_new, l_new


def ring_attention(q, k, v, mesh: Mesh, axis_name: str = "sp",
                   scale: Optional[float] = None, causal: bool = False
                   ) -> torch.Tensor:
    """q, k, v: this rank's (B, H, S_local, D) blocks of a sequence cut
    over `axis_name`. Returns this rank's block of the attention output
    (reference :42)."""
    B, H, S, D = q.shape
    n, idx = mesh.shape[axis_name], mesh.index(axis_name)
    scale = scale if scale is not None else D ** -0.5
    qf = q.float() * scale
    acc = torch.zeros((B, H, S, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    m = torch.full((B, H, S, 1), -torch.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, S, 1), dtype=torch.float32, device=q.device)
    kb, vb = k, v
    rows = torch.arange(S, device=q.device)
    for step in range(n):
        src = (idx - step) % n          # which shard this kv block came from
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb.float())
        if causal:
            keep = (idx * S + rows)[:, None] >= (src * S + rows)[None, :]
            s = torch.where(keep, s, -torch.inf)
        acc, m, l = _online_update(acc, m, l, s, vb)
        if step + 1 < n:
            kb = comm.ring_shift(kb, mesh, axis_name)
            vb = comm.ring_shift(vb, mesh, axis_name)
    denom = torch.where(l == 0.0, 1.0, l)
    return (acc / denom).to(q.dtype)


def ring_attention_sharded(q, k, v, mesh: Mesh, seq_axis: str = "sp",
                           scale: Optional[float] = None,
                           causal: bool = False) -> torch.Tensor:
    """Full (B, H, S, D) tensors in, the full output out on every rank:
    the sequence dim is cut over `seq_axis`, each rank runs the ring on
    its block, and the blocks are gathered (reference :85)."""
    n, i = mesh.shape[seq_axis], mesh.index(seq_axis)
    S = q.shape[2]
    if S % n:
        raise ValueError(f"sequence of {S} does not divide over {n} "
                         f"ranks of {seq_axis!r}")
    c = S // n
    part = [t.narrow(2, i * c, c).to(mesh.device) for t in (q, k, v)]
    out = ring_attention(*part, mesh, seq_axis, scale=scale, causal=causal)
    return comm.all_gather(out, mesh, seq_axis, dim=2)
