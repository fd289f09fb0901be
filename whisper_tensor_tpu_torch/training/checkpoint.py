"""Training checkpoint save/resume.

The reference has NO training checkpointing (SURVEY.md §5: optimizer
state lives in caller-held tensors). Here it's first-class: params +
optimizer state + step/metadata serialize to a single .npz (portable,
no framework lock-in).

The port's copy of whisper_tensor_tpu/training/checkpoint.py, the same
layout (`params/<name>`, `opt/<i>` leaves and `__meta__`), so a file
either package writes loads in the other: the port's optimizer state
is a list of tensors in optax's leaf order (training/optim.py). Tensors
are written as host arrays (dtype.to_host). Sharded save and load are
not ported (ROADMAP A11).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple

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


def save_checkpoint(path: str, params: Dict[str, Any], opt_state: Any,
                    step: int, extra: Optional[Dict[str, Any]] = None) -> None:
    """params: {name: tensor or array}; opt_state: the trainer's list of
    state tensors (optax's leaf order), stored as the ordered leaves
    list the reference stores."""
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
    as tensors; without it the raw leaves list comes back."""
    if mesh is not None or param_shardings is not None:
        raise NotImplementedError(
            "load_checkpoint: sharded load is not ported (A11)")
    with np.load(path, allow_pickle=True) as z:
        meta = json.loads(str(z["__meta__"]))
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    tree = _unflatten(flat)
    params = tree["params"]
    opt_leaves = list(tree["opt"])
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
