"""Collectives over a mesh axis: all_reduce, all_gather, reduce_scatter,
broadcast and the ring shift, and the tensor-parallel pair of training
(copy_in, reduce_out, with gather_out).

The port's own module: in the JAX package GSPMD inserts these
(psum, all_gather, ppermute) and XLA runs them over ICI. Here the code
that runs on a mesh calls them: parallel/tp.py's graph ops, ring
attention, expert parallelism and the pipeline schedule. Each helper
counts its calls and the host time spent in it on the mesh
(`Mesh.comm_calls`, `Mesh.comm_seconds`).

Backends. NCCL takes every collective on CUDA tensors, and gloo every
one on CPU tensors. Under gloo on the card (two ranks sharing one card,
since NCCL refuses two ranks on one device) every collective is staged
through host memory: the tensor is copied to the host, the collective
runs there, and the result is copied back. PyTorch's backend table
lists broadcast and all_reduce as taking CUDA tensors under gloo; on an
H100 with torch 2.11 gloo took CUDA all_reduce, broadcast and
all_gather in chip_smoke.py phase 19's probe (`gloo_table`), refused
send/recv there (an EFAULT writev from device memory), and a rank
serving Llama-3-8B's widths that handed gloo its CUDA tensors aborted
in gloo's thread with that EFAULT. A collective that fails raises;
nothing retries another way.

Gradients. Every helper is differentiable: all_reduce's backward is an
all_reduce of the incoming gradients, all_gather's sums each rank's
slice of them (a reduce_scatter), reduce_scatter's gathers them, the
ring shift's backward shifts the gradient the other way, and
broadcast's backward hands the source its own gradient (and the others
zeros): a replicated value that every rank turns into the same loss
gets the gradient of that one loss, not the sum over ranks. Under grad
mode each runs as a torch.autograd.Function; otherwise the plain call.

all_reduce and all_gather's rules fit a loss that is a SUM of per-rank
terms (data or sequence parallelism: each rank's loss covers its own
tokens). A tensor-parallel region instead feeds ONE loss that every rank
of the axis computes alike, so its gradients arrive replicated, and
summing them would count them once per rank. Training's tp graph
(parallel/tp.py) therefore uses Megatron's pair, and a gather fit for
it:
  * copy_in: identity forward, all_reduce backward, on a replicated
    input of work that each rank does on its own block (a
    column-parallel product, a slice): the ranks' partial gradients
    add up to the input's whole one;
  * reduce_out: all_reduce forward, identity backward, on the partial
    sums of a row-parallel product;
  * gather_out: all_gather forward, and backward this rank's slice of
    the (replicated) gradient.

An axis of extent 1 still runs its collective (a copy on one rank), so
a mesh path exercises its backend at any extent; the ring shift alone
returns x there, having no peer.
"""

from __future__ import annotations

import time

import torch

from .mesh import Mesh

# all_reduce_many's bucket, in elements: it bounds the card memory that
# concatenating a bucket adds (256 MB of f32), not a tuned size.
_BUCKET = 1 << 26


def _buffer(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A contiguous copy of x for a collective to write in place (x
    itself may be read by others: another consumer in a graph,
    autograd): on the host under gloo."""
    if mesh.backend == "gloo" and x.is_cuda:
        return x.to("cpu", memory_format=torch.contiguous_format)
    return x.clone(memory_format=torch.contiguous_format)


class _Timed:
    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.mesh.comm_seconds += time.perf_counter() - self.t0
        self.mesh.comm_calls += 1


def _sum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    import torch.distributed as dist

    with _Timed(mesh):
        y = _buffer(x, mesh)
        dist.all_reduce(y, group=mesh.group(axis))
        return y.to(x.device)


def _gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int
            ) -> torch.Tensor:
    import torch.distributed as dist

    with _Timed(mesh):
        y = _buffer(x, mesh)
        parts = [torch.empty_like(y) for _ in range(mesh.shape[axis])]
        dist.all_gather(parts, y, group=mesh.group(axis))
        return torch.cat(parts, dim=dim).to(x.device)


def _bcast(x: torch.Tensor, mesh: Mesh, axis: str, src: int
           ) -> torch.Tensor:
    import torch.distributed as dist

    g = mesh.group(axis)
    with _Timed(mesh):
        y = _buffer(x, mesh)
        dist.broadcast(y, group=g, src=dist.get_global_rank(g, src))
        return y.to(x.device)


def _scatter(x: torch.Tensor, mesh: Mesh, axis: str, dim: int
             ) -> torch.Tensor:
    import torch.distributed as dist

    n = mesh.shape[axis]
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dimension {dim} of "
                         f"{tuple(x.shape)} does not divide over the {n} "
                         f"ranks of {axis!r}")
    with _Timed(mesh):
        y = _buffer(x.movedim(dim, 0), mesh)
        out = torch.empty((y.shape[0] // n, *y.shape[1:]), dtype=y.dtype,
                          device=y.device)
        dist.reduce_scatter_tensor(out, y, group=mesh.group(axis))
        return out.movedim(0, dim).to(x.device)


def _shift(x: torch.Tensor, mesh: Mesh, axis: str, offset: int
           ) -> torch.Tensor:
    import torch.distributed as dist

    n, i = mesh.shape[axis], mesh.index(axis)
    if n == 1 or offset % n == 0:
        return x
    g = mesh.group(axis)
    dst = dist.get_global_rank(g, (i + offset) % n)
    src = dist.get_global_rank(g, (i - offset) % n)
    with _Timed(mesh):
        send = _buffer(x, mesh)
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, dst, g),
               dist.P2POp(dist.irecv, recv, src, g)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv.to(x.device)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _sum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    """Backward: each rank's slice of the gradients summed over the
    ranks (a reduce_scatter)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim % x.dim()
        return _gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim % x.dim()
        return _scatter(x, mesh, axis, ctx.dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh, ctx.axis), None, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _sum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim % x.dim()
        ctx.n = x.shape[ctx.dim]
        return _gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.index(ctx.axis)
        return (g.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None, None,
                None)


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, src):
        ctx.own = mesh.index(axis) == src
        return _bcast(x, mesh, axis, src)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.own else torch.zeros_like(g)), None, None, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, offset):
        ctx.mesh, ctx.axis, ctx.offset = mesh, axis, offset
        return _shift(x, mesh, axis, offset)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.mesh, ctx.axis, -ctx.offset), None, None, None


def _grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of x over the ranks of `axis`, on every one of them."""
    return _AllReduce.apply(x, mesh, axis) if _grad(x) else _sum(x, mesh,
                                                                  axis)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """The ranks' blocks of `axis` concatenated along `dim`, in the
    axis's order, on every rank."""
    return (_AllGather.apply(x, mesh, axis, dim) if _grad(x)
            else _gather(x, mesh, axis, dim))


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0
                   ) -> torch.Tensor:
    """The sum of x over the ranks of `axis`, of which each rank keeps
    its block along `dim` (the axis's extent must divide it)."""
    return (_ReduceScatter.apply(x, mesh, axis, dim) if _grad(x)
            else _scatter(x, mesh, axis, dim % x.dim()))


def copy_in(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """x itself; in the backward the sum of the ranks' gradients of it
    (Megatron's f: a replicated input entering a tensor-parallel
    region)."""
    return _CopyIn.apply(x, mesh, axis) if _grad(x) else x


def reduce_out(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of the ranks' partial x, whose gradient passes through
    unchanged (Megatron's g: a tensor-parallel region's partial sums
    leaving it)."""
    return _ReduceOut.apply(x, mesh, axis) if _grad(x) else _sum(x, mesh,
                                                                  axis)


def gather_out(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """all_gather for one replicated loss: each rank's gradient of its
    block is its slice of the gathered tensor's gradient."""
    return (_GatherOut.apply(x, mesh, axis, dim) if _grad(x)
            else _gather(x, mesh, axis, dim))


def all_reduce_many(tensors, mesh: Mesh, axis: str) -> list:
    """The sum over the ranks of `axis` of each of `tensors` (no
    gradient), in as few collectives as buckets of up to _BUCKET
    elements of one type allow: a larger tensor goes alone. Every rank
    must hand the same shapes and types in the same order."""
    out = list(tensors)
    runs: dict = {}
    for i, t in enumerate(out):
        runs.setdefault((t.dtype, t.device), []).append(i)
    for idx in runs.values():
        while idx:
            take, n = [], 0
            while idx and (not take or n + out[idx[0]].numel() <= _BUCKET):
                n += out[idx[0]].numel()
                take.append(idx.pop(0))
            flat = _sum(torch.cat([out[i].detach().reshape(-1)
                                   for i in take]) if len(take) > 1
                        else out[take[0]].detach().reshape(-1), mesh, axis)
            at = 0
            for i in take:
                k = out[i].numel()
                out[i] = flat[at:at + k].view_as(out[i])
                at += k
    return out


def broadcast(x: torch.Tensor, mesh: Mesh, axis: str, src: int = 0
              ) -> torch.Tensor:
    """The value of the rank at index `src` on `axis`, on every rank of
    the axis (x's shape and type must agree on all of them)."""
    return (_Broadcast.apply(x, mesh, axis, src) if _grad(x)
            else _bcast(x, mesh, axis, src))


def ring_shift(x: torch.Tensor, mesh: Mesh, axis: str, offset: int = 1
               ) -> torch.Tensor:
    """ppermute over the ring of `axis`: the rank at index i sends x to
    index i + offset and returns what index i - offset sent (modulo the
    axis's extent)."""
    return (_RingShift.apply(x, mesh, axis, offset) if _grad(x)
            else _shift(x, mesh, axis, offset))
