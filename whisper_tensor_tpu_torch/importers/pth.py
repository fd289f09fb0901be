""".pth (PyTorch checkpoint) reader.

Counterpart of whisper_tensor_tpu/importers/pth.py, which parses the
zip container and the pickle by hand because the JAX package has no
torch; the port has torch, so `torch.load` reads the file, restricted
to tensors and plain containers (`weights_only`) and memory-mapped, so
a tensor's bytes are read when it is taken.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def load_pth(path: str) -> Dict[str, np.ndarray]:
    """A torch.save'd state dict -> {name: host array}, each tensor in
    its own type (bf16 widened to f32, which holds it exactly: numpy has
    no bf16). A top-level 'state_dict' entry is taken as the state dict,
    as the reference's reader takes it; entries that are not tensors are
    left out."""
    obj = torch.load(path, map_location="cpu", weights_only=True,
                     mmap=True)
    if isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]
    out: Dict[str, np.ndarray] = {}
    for k, v in obj.items():
        if isinstance(v, torch.Tensor):
            t = v.detach()
            out[k] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out
