"""Training checkpoint save/resume.

The reference has NO training checkpointing (SURVEY.md §5: optimizer
state lives in caller-held tensors). Here it's first-class: params +
optimizer state + step/metadata serialize to a single .npz (portable,
no framework lock-in).

The port's copy of whisper_tensor_tpu/training/checkpoint.py, the same
layout (`params/<name>`, `opt/<i>` leaves and `__meta__`), so a file
either package writes loads in the other: the port's optimizer state
is a list of tensors in optax's leaf order (training/optim.py). Tensors
are written as host arrays (dtype.to_host).

Under a mesh (the reference's :61-98, where a sharded array gathers on
np.asarray and device_put re-shards it) each rank holds blocks
(LMTrainer.param_shardings): save_checkpoint gathers every block into
its whole array (a collective: every rank calls it) and rank 0 writes
the one file, in the same layout, while the others wait; load_checkpoint
cuts each whole array into the rank's block again. An optimizer leaf is
cut like the parameter it belongs to: its state comes in runs of one
leaf per parameter in sorted name order, beside 0-d counters
(training/optim.py), which `_owners` reads off the shapes.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..dtype import to_device, to_host


def _flatten(tree, prefix=""):
    """Flatten a pytree of arrays into {path: array} (dicts/lists/tuples)."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        out[f"{prefix}__seq__"] = np.asarray(
            ["list" if isinstance(tree, list) else "tuple", str(len(tree))],
            dtype=object)
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is None:
        out[f"{prefix}__none__"] = np.zeros(0)
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    # rebuild nested structure from path keys
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        if "__none__" in node:
            return None
        if "__seq__" in node:
            kind, n = node["__seq__"]
            items = [rebuild(node[str(i)]) for i in range(int(n))]
            return items if kind == "list" else tuple(items)
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


def _host(v) -> np.ndarray:
    return to_host(v.detach()) if isinstance(v, torch.Tensor) else np.asarray(v)


def _owners(leaf_shapes: Sequence[Tuple[int, ...]],
            param_shapes: Dict[str, Tuple[int, ...]]) -> List[Optional[str]]:
    """The parameter each optimizer leaf belongs to (None: a counter):
    a state is 0-d counters and runs of one leaf per parameter, in
    sorted name order, with the parameters' shapes."""
    names = sorted(param_shapes)
    want = [tuple(param_shapes[n]) for n in names]
    out: List[Optional[str]] = []
    i = 0
    while i < len(leaf_shapes):
        if tuple(leaf_shapes[i]) == ():
            out.append(None)
            i += 1
        elif [tuple(x) for x in leaf_shapes[i:i + len(names)]] == want:
            out += names
            i += len(names)
        else:
            raise ValueError(f"optimizer leaf {i} of shape "
                             f"{tuple(leaf_shapes[i])} starts no run of "
                             f"the parameters' shapes")
    return out


def _placed(mesh, param_shardings, param_order) -> Dict[str, Any]:
    if mesh is None or param_shardings is None or param_order is None:
        return {}
    return dict(zip(param_order, param_shardings))


def save_checkpoint(path: str, params: Dict[str, Any], opt_state: Any,
                    step: int, extra: Optional[Dict[str, Any]] = None,
                    mesh=None, param_shardings=None, param_order=None
                    ) -> None:
    """params: {name: tensor or array}; opt_state: the trainer's list of
    state tensors (optax's leaf order), stored as the ordered leaves
    list the reference stores. Under a mesh (with the trainer's
    param_shardings by param_order) params and opt_state are this rank's
    blocks: every rank calls this, the blocks are gathered, rank 0
    writes, and the call returns on every rank once the file is
    written."""
    by_name = _placed(mesh, param_shardings, param_order)
    if by_name:
        import torch.distributed as dist

        from ..parallel.mesh import gather_block

        owners = _owners([tuple(x.shape) for x in opt_state],
                         {n: tuple(v.shape) for n, v in params.items()})
        writer = dist.get_rank() == 0

        def whole(v, n):
            # one array at a time to the host, kept by the writer only
            if n in by_name:
                if not isinstance(v, torch.Tensor):
                    v = to_device(np.asarray(v), mesh.device)
                v = gather_block(v.to(mesh.device), by_name[n])
            return _host(v) if writer else None

        params = {n: whole(v, n) for n, v in params.items()}
        opt_state = [whole(x, o) for x, o in zip(opt_state, owners)]
        if writer:
            _write(path, params, opt_state, step, extra)
        dist.barrier()
        return
    _write(path, params, opt_state, step, extra)


def _write(path: str, params: Dict[str, Any], opt_state: Any, step: int,
           extra: Optional[Dict[str, Any]]) -> None:
    flat = {}
    flat.update(_flatten({"params": {k: _host(v) for k, v in params.items()}}))
    opt_leaves = [_host(x) for x in opt_state]
    flat.update(_flatten({"opt": opt_leaves}))
    meta = {"step": int(step), "extra": extra or {}}
    np.savez(path, __meta__=np.asarray(json.dumps(meta)), **flat)


def load_checkpoint(path: str, opt_state_like: Any = None, mesh=None,
                    param_shardings=None, param_order=None
                    ) -> Tuple[Dict[str, Any], Any, int, Dict]:
    """Returns (params as host arrays, opt_state, step, extra).
    opt_state_like: a freshly initialized state (the trainer's
    init_opt_state) whose devices and dtypes receive the stored leaves
    as tensors; without it the raw leaves list comes back. mesh,
    param_shardings, param_order (the trainer's mesh, param_shardings
    and weight_names): each named parameter, and each optimizer leaf of
    one, comes back as this rank's block; the rest whole."""
    with np.load(path, allow_pickle=True) as z:
        meta = json.loads(str(z["__meta__"]))
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    tree = _unflatten(flat)
    params = tree["params"]
    opt_leaves = list(tree["opt"])
    by_name = _placed(mesh, param_shardings, param_order)
    if by_name:
        from ..parallel.mesh import local_block

        owners = _owners([x.shape for x in opt_leaves],
                         {n: v.shape for n, v in params.items()})

        def block(v, n):
            return v if n not in by_name else np.ascontiguousarray(
                local_block(v, by_name[n], n))

        params = {n: block(v, n) for n, v in params.items()}
        opt_leaves = [block(x, o) for x, o in zip(opt_leaves, owners)]
    if opt_state_like is not None:
        if len(opt_state_like) != len(opt_leaves):
            raise ValueError(f"load_checkpoint: {len(opt_leaves)} stored "
                             f"optimizer leaves, the state has "
                             f"{len(opt_state_like)}")
        opt_state = [to_device(v, like.device).to(like.dtype)
                     for v, like in zip(opt_leaves, opt_state_like)]
    else:
        opt_state = opt_leaves
    return params, opt_state, meta["step"], meta["extra"]
