"""Device mesh and sharding-rule layer over torch.distributed.

The port's counterpart of whisper_tensor_tpu/parallel/mesh.py. There a
Mesh is a grid of JAX devices and GSPMD inserts the collectives; here
every rank is one process with one device, a Mesh is a named grid of
the ranks of a torch.distributed world (a DeviceMesh underneath), and
the code that runs on it calls its collectives itself (parallel/comm.py,
the graph pass parallel/tp.py).

Axis conventions, as in the reference:
  dp — data parallel (batch)
  sp — sequence parallel (activations' sequence dim; a.k.a. context)
  tp — tensor parallel (hidden/heads; megatron-style column/row splits)
  pp — pipeline parallel (layer groups; parallel/pipeline.py)
  ep — expert parallel (MoE experts; parallel/moe.py)

The rule tables (GPT2_RULES, LLAMA_RULES) and the placement logic of
weight_shardings and fsdp_shardings are copies of the reference's
(:66-152). A `Sharding` holds the spec tuple the reference's
NamedSharding holds as its PartitionSpec.

The backend is chosen when the world starts (`distributed_init`):
"nccl" for a CUDA device, "gloo" for device="cpu", or "gloo" on the
card when the caller asks for it (two ranks sharing one card: NCCL
refuses two ranks on one device). Nothing retries on another backend.
"""

from __future__ import annotations

import datetime
import math
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device

AXES = ("dp", "sp", "tp")

# the extents of a mesh axis a spec entry names: one axis, several, or none
SpecEntry = Union[None, str, Tuple[str, ...]]


def _dist():
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "parallel.mesh.distributed_init first")
    return dist


class Mesh:
    """A named grid of the ranks of the torch.distributed world.

    `shape` maps each axis name to its extent, in order, as a JAX
    mesh's `.shape` does; `group(axis)` is the process group of the
    ranks that share this rank's place on every other axis; `index(axis)`
    is this rank's coordinate on `axis`. `device` is this rank's device:
    CUDA unless "cpu" is passed (index LOCAL_RANK modulo the cards the
    process sees, so two ranks may share one card). `comm_seconds` and
    `comm_calls` count the host time spent in, and the calls of, the
    collectives of parallel/comm.py run on this mesh."""

    def __init__(self, axis_names: Sequence[str], extents: Sequence[int],
                 device=None, ranks: Optional[Sequence[int]] = None):
        dist = _dist()
        from torch.distributed.device_mesh import DeviceMesh

        if len(axis_names) != len(extents):
            raise ValueError(f"axes {tuple(axis_names)} and extents "
                             f"{tuple(extents)} differ in length")
        n = math.prod(int(e) for e in extents)
        ranks = list(range(dist.get_world_size())) if ranks is None \
            else [int(r) for r in ranks]
        if len(ranks) < n:
            raise ValueError(f"need {n} devices, have {len(ranks)}")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = {a: int(e) for a, e in
                                      zip(axis_names, extents)}
        self.backend = str(dist.get_backend())
        self.rank = dist.get_rank()
        self.device = _rank_device(device)
        grid = torch.tensor(ranks[:n], dtype=torch.int64).reshape(
            tuple(int(e) for e in extents))
        # the DeviceMesh's type only picks which devices DTensor would
        # place on; the groups use the world's backend either way
        self._dm = DeviceMesh("cuda" if self.backend == "nccl" else "cpu",
                              grid, mesh_dim_names=self.axis_names)
        where = (grid == self.rank).nonzero()
        self._coord = (None if where.numel() == 0
                       else [int(c) for c in where[0]])
        self.comm_seconds = 0.0
        self.comm_calls = 0

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank}, {self.backend}, "
                f"{self.device})")

    def extent(self, axis: SpecEntry) -> int:
        """The number of shards a spec entry cuts a dimension into (1 for
        None or an axis the mesh lacks)."""
        return math.prod(self.shape.get(a, 1) for a in _axes(axis))

    def index(self, axis: SpecEntry) -> int:
        """This rank's shard index along a spec entry (several axes:
        major to minor in the order named, as JAX's PartitionSpec)."""
        if self._coord is None:
            raise ValueError(f"rank {self.rank} is not in {self}")
        i = 0
        for a in _axes(axis):
            if a in self.shape:
                i = i * self.shape[a] + self._coord[
                    self.axis_names.index(a)]
        return i

    def group(self, axis: str):
        """The process group of `axis` through this rank."""
        if axis not in self.shape:
            raise KeyError(f"mesh has no axis {axis!r} ({self.axis_names})")
        return self._dm.get_group(axis)


def _axes(entry: SpecEntry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _rank_device(device) -> torch.device:
    if device is not None:
        return resolve_device(device)
    dev = resolve_device(None)
    local = int(os.environ.get("LOCAL_RANK", _dist().get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count()) \
        if dev.type == "cuda" else dev


def make_mesh(dp: int = 1, sp: int = 1, tp: int = 1, ep: int = 1,
              devices: Optional[Sequence[int]] = None, device=None) -> Mesh:
    """A Mesh with the standard (dp, sp, tp) axes, plus an `ep` axis
    when expert parallelism is requested (ep > 1) (reference :24).
    `devices`: the world ranks to lay out (default all, in order); the
    first dp*sp*tp*ep of them form the grid. `device`: this rank's
    device (default its card; "cpu" on the CPU)."""
    if ep > 1:
        return Mesh(("dp", "sp", "tp", "ep"), (dp, sp, tp, ep), device,
                    devices)
    return Mesh(AXES, (dp, sp, tp), device, devices)


def auto_factors(n_devices: int) -> Tuple[int, int, int]:
    """(dp, sp, tp) of auto_mesh: tp the largest of 8, 4, 2 that divides
    n, dp the rest, sp 1 (reference :42)."""
    tp = next((c for c in (8, 4, 2) if n_devices % c == 0), 1)
    return n_devices // tp, 1, tp


def auto_mesh(n_devices: int, device=None) -> Mesh:
    """Reasonable default factorization: tp innermost, then dp; sp=1."""
    dp, sp, tp = auto_factors(n_devices)
    return make_mesh(dp=dp, sp=sp, tp=tp, device=device)


@dataclass(frozen=True)
class Sharding:
    """Where each dimension of an array lies on a mesh: `spec` is the
    tuple the reference's PartitionSpec holds (an axis name, a tuple of
    names, or None per leading dimension; () = replicated). `sections`
    (per leading dimension, default 1): a dimension made of that many
    equal concatenated parts, each cut on its own, as the tp pass cuts a
    fused q/k/v product (parallel/tp.py Split)."""

    mesh: Mesh
    spec: Tuple[SpecEntry, ...] = ()
    sections: Tuple[int, ...] = ()

    def cuts(self, dim: int) -> int:
        """The sections of dimension `dim` (1 unless stated)."""
        return self.sections[dim] if dim < len(self.sections) else 1

    def axes(self) -> Tuple[str, ...]:
        """The mesh axes of extent > 1 that cut the array."""
        return tuple(a for e in self.spec for a in _axes(e)
                     if self.mesh.shape.get(a, 1) > 1)


def named(mesh: Mesh, *spec) -> Sharding:
    return Sharding(mesh, tuple(spec))


# ---------------------------------------------------------------------------
# per-weight sharding rules (pattern -> PartitionSpec), megatron-style:
# column-parallel for up-projections (shard output dim on tp), row-parallel
# for down-projections (shard input dim on tp), embeddings sharded on vocab.
# ---------------------------------------------------------------------------

GPT2_RULES: List[Tuple[str, Tuple]] = [
    (r"^wte$", ("tp", None)),           # (V, E): shard vocab
    (r"^wte_t$", (None, "tp")),         # (E, V)
    (r"^wpe$", (None, None)),
    (r"^wqkv_\d+$", (None, "tp")),      # (E, 3E) column-parallel
    (r"^bqkv_\d+$", ("tp",)),
    (r"^wproj_\d+$", ("tp", None)),     # (E, E) row-parallel
    (r"^bproj_\d+$", (None,)),
    (r"^wfc_\d+$", (None, "tp")),       # (E, 4E) column-parallel
    (r"^bfc_\d+$", ("tp",)),
    (r"^wmp_\d+$", ("tp", None)),       # (4E, E) row-parallel
    (r"^bmp_\d+$", (None,)),
    (r"^ln\w*_?\d*$", None),            # norm params replicated
]

LLAMA_RULES: List[Tuple[str, Tuple]] = [
    (r"embed", ("tp", None)),
    (r"(wq|wk|wv|w_qkv)_", (None, "tp")),
    (r"(wo|w_o)_", ("tp", None)),
    (r"(w_gate|w_up|w1|w3)_", (None, "tp")),
    (r"(w_down|w2)_", ("tp", None)),
    (r"lm_head", (None, "tp")),
    (r"norm", None),
]


def rule_spec(name: str, rules) -> Optional[Tuple]:
    """The spec of the first rule whose pattern `re.search`es `name`,
    else None (replicated)."""
    for pat, s in rules or []:
        if re.search(pat, name):
            return s
    return None


def weight_shardings(names: Sequence[str], mesh: Mesh,
                     rules: List[Tuple[str, Optional[Tuple]]]
                     ) -> List[Sharding]:
    """Map weight names to Shardings via the first matching rule;
    unmatched weights are replicated (reference :92)."""
    out = []
    for n in names:
        spec = rule_spec(n, rules)
        out.append(Sharding(mesh, () if spec is None else tuple(spec)))
    return out


def fsdp_shardings(names: Sequence[str], shapes: Sequence[Tuple[int, ...]],
                   mesh: Mesh,
                   rules: Optional[List[Tuple[str, Optional[Tuple]]]] = None,
                   axis: str = "dp", min_size: int = 2 ** 16
                   ) -> List[Sharding]:
    """ZeRO-3 / FSDP-style parameter shardings (reference :112): start
    from the first matching TP rule's spec (or replicated), then place
    `axis` on the LARGEST dim that is still unsharded and that the axis
    divides. Weights smaller than min_size elements keep their base
    spec."""
    n_shard = mesh.shape.get(axis, 1)
    out = []
    for name, shape in zip(names, shapes):
        spec = rule_spec(name, rules)
        base = list(spec) if spec is not None else [None] * len(shape)
        base += [None] * (len(shape) - len(base))
        if n_shard > 1 and int(np.prod(shape, dtype=np.int64)) >= min_size:
            cands = [d for d in range(len(shape))
                     if base[d] is None and shape[d] % n_shard == 0]
            if cands:
                d = max(cands, key=lambda d: shape[d])
                base[d] = axis
        out.append(Sharding(mesh, tuple(base)))
    return out


def local_block(arr, sharding: Sharding, name: Optional[str] = None):
    """This rank's block of a host or device array under `sharding`
    (a view where slicing allows and no dimension has sections).
    Refuses a dimension its extent does not divide, as jax.device_put
    refuses it, naming the array."""
    mesh = sharding.mesh
    for d, entry in enumerate(sharding.spec):
        k = mesh.extent(entry)
        if k == 1:
            continue
        size, sec = int(arr.shape[d]), sharding.cuts(d)
        if size % (k * sec):
            raise ValueError(
                f"{name or 'array'} of shape {tuple(arr.shape)}: the "
                f"global size of its dimension {d} ({size}"
                + ("" if sec == 1 else f" in {sec} sections")
                + f") should be divisible by {k}, the extent of mesh axes "
                f"{entry!r}")
        part, i = size // sec // k, mesh.index(entry)
        pieces = []
        for j in range(sec):
            idx = [slice(None)] * arr.ndim
            start = j * (size // sec) + i * part
            idx[d] = slice(start, start + part)
            pieces.append(arr[tuple(idx)])
        if sec == 1:
            arr = pieces[0]
        elif isinstance(arr, torch.Tensor):
            arr = torch.cat(pieces, dim=d)
        else:
            arr = np.concatenate(pieces, axis=d)
    return arr


def gather_block(block: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """The whole array from every rank's block under `sharding` (the
    inverse of local_block; a collective: every rank of the axes that
    cut it calls it). No gradient flows through it."""
    from . import comm

    mesh = sharding.mesh
    out = block.detach()
    for d, entry in enumerate(sharding.spec):
        # several axes on one dimension: major to minor, so the minor
        # axis's blocks are joined first
        for a in reversed(_axes(entry)):
            n = mesh.shape.get(a, 1)
            if n == 1:
                continue
            out = comm._gather(out, mesh, a, d)
            sec = sharding.cuts(d)
            if sec > 1:
                # [r0: s0 s1 ..| r1: s0 s1 ..] -> [s0: r0 r1 ..| s1: ..]
                blocks = [b.chunk(sec, dim=d) for b in out.chunk(n, dim=d)]
                out = torch.cat([blk[k] for k in range(sec)
                                 for blk in blocks], dim=d)
    return out


def data_sharding(mesh: Mesh, shape: Sequence[int]) -> Sharding:
    """Where a (B, S, ...) batch lies on a training mesh (reference
    training/trainer.py:330-337): rows over `dp`, and the sequence over
    `sp` only when sp divides S; replicated over every other axis."""
    sp = mesh.shape.get("sp", 1)
    seq = "sp" if sp > 1 and int(shape[1]) % sp == 0 else None
    return Sharding(mesh, ("dp" if "dp" in mesh.shape else None, seq))


def shard_array(arr, sharding: Sharding, name: Optional[str] = None
                ) -> torch.Tensor:
    """This rank's shard of a host (numpy) or device array, on this
    rank's device (reference :155, jax.device_put)."""
    block = local_block(arr, sharding, name)
    if isinstance(block, torch.Tensor):
        return block.to(sharding.mesh.device).contiguous()
    return torch.from_numpy(np.ascontiguousarray(block)).to(
        sharding.mesh.device)


def distributed_init(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device=None,
                     timeout: Optional[datetime.timedelta] = None) -> str:
    """Start this process's rank of the world (reference :161, where
    jax.distributed.initialize does it). Each process calls it once.

    coordinator: "host:port" (a TCP store), or an init URL such as
    "tcp://host:port" or "file:///path"; by default torchrun's
    environment (MASTER_ADDR / MASTER_PORT). num_processes and
    process_id default to WORLD_SIZE and RANK. backend: "nccl" by
    default for a CUDA device, "gloo" for device="cpu"; pass "gloo" to
    run gloo on the card. timeout: how long a collective may wait for
    the other ranks (torch.distributed's default when None). Returns
    the backend."""
    import torch.distributed as dist

    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if coordinator is None:
        init = "env://"
    else:
        init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    world = int(num_processes if num_processes is not None
                else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None
               else os.environ["RANK"])
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, **kw)
    return backend


def multihost_mesh(dp_hosts: Optional[int] = None, sp: int = 1, tp: int = 1,
                   device=None) -> Mesh:
    """Mesh layout for several hosts (reference :181): dp spans hosts
    while sp and tp stay inside one. A host's ranks are counted from
    LOCAL_WORLD_SIZE (torchrun's; default: the whole world on one
    host); dp_hosts defaults to the number of hosts, and the local ranks
    must factor as dp_local*sp*tp."""
    world = _dist().get_world_size()
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    n_hosts = world // n_local if dp_hosts is None else dp_hosts
    if n_local % (sp * tp) != 0:
        raise ValueError(f"local devices {n_local} not divisible by "
                         f"sp*tp={sp * tp}")
    dp = n_hosts * (n_local // (sp * tp))
    return make_mesh(dp=dp, sp=sp, tp=tp, device=device)
