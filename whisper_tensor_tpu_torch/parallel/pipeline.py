"""Pipeline parallelism (pp axis): GPipe-style microbatched execution
over layer groups held by the ranks of a mesh axis.

The port's counterpart of whisper_tensor_tpu/parallel/pipeline.py.
Layer parameters are stacked on a leading L axis; the rank at index d of
`axis` holds and runs layers [d*L/P, (d+1)*L/P) (its local block,
which the caller cuts: a trainer keeps only its blocks). At schedule step t the rank
works on microbatch t - d (bubble steps compute values that are never
used), then the activation moves to rank d+1 by the ring shift
(parallel/comm.py, the reference's ppermute): M + P - 1 steps for M
microbatches over P stages, a bubble share of (P-1)/(M+P-1). The last
stage's outputs are broadcast to every rank.

Gradients go through autograd: the ring shift's backward sends each
activation's gradient back a stage, and the broadcast's backward hands
the last stage the gradient of the loss every rank computes from the
replicated output, so each rank's layers get the gradient of that one
loss.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import comm
from .mesh import Mesh, Sharding, local_block


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_apply(stage_fn: Callable, local_params, x: torch.Tensor,
                   mesh: Mesh, axis: str = "pp", microbatches: int = 4,
                   batch_axis: Optional[str] = None) -> torch.Tensor:
    """Run x through all L stacked layers, layer groups held over
    `axis` (reference :22).

    stage_fn(params_one_layer, h) -> h          (one layer)
    local_params: pytree (dicts, lists) of this rank's blocks of the
        stacks (leading dim L, L % pp == 0): its L/pp layers, as
        `local_block(leaf, Sharding(mesh, (axis, *spec)))` cuts them,
        where a spec for the other dims (the reference's param_specs,
        e.g. (None, "tp") for a column-cut weight) asks stage_fn to hold
        the matching collectives.
    x: (B, ...) whole on every rank, with B % microbatches == 0.
    batch_axis: optional mesh axis (e.g. "dp") cutting each
        microbatch's ROWS, composing data parallelism with the pipeline.
    Returns the same result as applying all L layers in order, whole on
    every rank."""
    n, idx = mesh.shape[axis], mesh.index(axis)
    M = microbatches
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} does not divide into {M} microbatches")
    mb = B // M
    xm = x.to(mesh.device).reshape(M, mb, *x.shape[1:])
    if batch_axis is not None:
        xm = local_block(xm, Sharding(mesh, (None, batch_axis)), "x")

    local = _tree_map(lambda p: p.to(mesh.device), local_params)
    n_local = next(iter(_leaves(local))).shape[0]

    def group(h):
        for layer in range(n_local):
            h = stage_fn(_tree_map(lambda p: p[layer], local), h)
        return h

    first = torch.tensor(idx == 0, device=xm.device)
    recv = torch.zeros_like(xm[0])
    out = [torch.zeros_like(xm[0]) for _ in range(M)]
    for t in range(M + n - 1):
        # the first stage takes microbatch t; every other stage what
        # came from the left. Both stay in the graph on every rank, so
        # each rank's backward runs every shift's backward.
        h_in = torch.where(first, xm[min(t, M - 1)], recv)
        h_out = group(h_in)
        if idx == n - 1 and t >= n - 1:
            out[t - (n - 1)] = h_out
        else:
            slot = min(max(t - (n - 1), 0), M - 1)
            out[slot] = torch.where(torch.tensor(False, device=xm.device),
                                    h_out, out[slot])
        if t + 1 < M + n - 1:
            recv = comm.ring_shift(h_out, mesh, axis)
    y = comm.broadcast(torch.stack(out), mesh, axis, src=n - 1)
    if batch_axis is not None:
        y = comm.all_gather(y, mesh, batch_axis, dim=1)
    return y.reshape(B, *y.shape[2:])


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree
