"""PEFT LoRA adapters: merged into the base weights at load, or resolved
into per-weight (A, B, scale) for per-row multi-LoRA serving.

The port's copy of whisper_tensor_tpu/importers/lora.py (numpy only),
without `save_peft_adapter` (the training side, not ported). A PEFT
adapter directory holds `adapter_config.json` (r, lora_alpha,
fan_in_fan_out, use_rslora) and `adapter_model.safetensors` with keys
like `base_model.model.<module>.lora_A.weight` (r, in) and
`...lora_B.weight` (out, r), read through the port's
importers/safetensors_io.py. Merging computes
`W <- W + scale * transpose(B @ A, fan_in_fan_out)` in f32 and casts
back, PEFT's `merge_and_unload()`; scale is alpha / r, or alpha /
sqrt(r) under rsLoRA.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np

from .safetensors_io import SafetensorsStore


def _strip_adapter_key(key: str) -> Tuple[str, str] | None:
    """'base_model.model.<mod>.lora_A[.default].weight' -> (<mod>, 'A')."""
    for side in ("A", "B"):
        for mid in (f".lora_{side}.weight", f".lora_{side}.default.weight"):
            if key.endswith(mid):
                mod = key[: -len(mid)]
                for prefix in ("base_model.model.", "base_model."):
                    if mod.startswith(prefix):
                        mod = mod[len(prefix):]
                        break
                return mod, side
    return None


def _read_adapter(adapter_dir: str):
    """(scale, fan_in_fan_out, adapter store, {module: {"A": key, "B":
    key}}) of a PEFT dir."""
    with open(os.path.join(adapter_dir, "adapter_config.json"), "r",
              encoding="utf-8") as f:
        cfg = json.load(f)
    r = int(cfg.get("r", 8))
    alpha = float(cfg.get("lora_alpha", r))
    scale = alpha / np.sqrt(r) if cfg.get("use_rslora") else alpha / r
    st = os.path.join(adapter_dir, "adapter_model.safetensors")
    if not os.path.exists(st):
        raise FileNotFoundError(
            f"no adapter_model.safetensors in {adapter_dir}")
    store = SafetensorsStore([st])
    ab: Dict[str, Dict[str, str]] = {}
    for key in store.names():
        hit = _strip_adapter_key(key)
        if hit is not None:
            ab.setdefault(hit[0], {})[hit[1]] = key
    return scale, bool(cfg.get("fan_in_fan_out", False)), store, ab


class LoraMergedStore:
    """Wraps a weight store; `load(name)` returns the base weight with
    the adapter's low-rank delta merged in (f32 accumulate, cast back).
    Duck-types the store surface the loaders read (load / __contains__ /
    names / getter)."""

    def __init__(self, base, adapter_dir: str):
        self.base = base
        self.scale, self.fan_in_fan_out, self._adapter, self._ab = \
            _read_adapter(adapter_dir)
        incomplete = [m for m, s in self._ab.items() if len(s) != 2]
        if incomplete:
            raise ValueError(f"adapter pairs missing A or B: {incomplete}")
        self.merged_modules = sorted(self._ab)

    def names(self):
        return self.base.names()

    def __contains__(self, name):
        return name in self.base

    def load(self, name: str) -> np.ndarray:
        arr = self.base.load(name)
        if not name.endswith(".weight"):
            return arr
        keys = self._ab.get(name[: -len(".weight")])
        if keys is None:
            return arr
        a = self._adapter.load(keys["A"]).astype(np.float32)  # (r, in)
        b = self._adapter.load(keys["B"]).astype(np.float32)  # (out, r)
        delta = self.scale * (b @ a)                          # (out, in)
        if self.fan_in_fan_out:   # Conv1D layout: base weight is (in, out)
            delta = delta.T
        if delta.shape != arr.shape:
            raise ValueError(
                f"adapter delta {delta.shape} does not match base weight "
                f"{name} {arr.shape} (fan_in_fan_out="
                f"{self.fan_in_fan_out})")
        return (arr.astype(np.float32) + delta).astype(arr.dtype)

    def getter(self, transform=None):
        def get(name: str) -> np.ndarray:
            arr = self.load(name)
            return transform(name, arr) if transform else arr

        return get


def load_peft_adapter_arrays(adapter_dir: str, weight_map: Dict[str, str]):
    """PEFT dir -> {milli weight input: (A (K, r), B (r, N), scale)} for
    per-row multi-LoRA serving (milli/transforms.py inject_multi_lora).

    weight_map is the recipe's {initializer name: HF state-dict name}
    record of matmul-RHS weights. The milli RHS is W_hf.T for Linear
    recipes and W_hf for GPT-2's Conv1D (whose PEFT adapters carry
    fan_in_fan_out); in both the milli-layout delta is A_peft.T @
    B_peft.T * scale, so A = A_peft.T and B = B_peft.T. Strict: a module
    of the adapter with no mapping raises, since a partly applied
    adapter would differ from the merged-at-load model."""
    scale, _, ad, ab = _read_adapter(adapter_dir)
    rev = {hf: init for init, hf in weight_map.items()}
    out: Dict[str, tuple] = {}
    unmatched = []
    for mod, keys in sorted(ab.items()):
        if len(keys) != 2:
            raise ValueError(f"adapter module {mod} missing A or B")
        init = rev.get(mod + ".weight")
        if init is None:
            unmatched.append(mod)
            continue
        a = ad.load(keys["A"]).astype(np.float32)   # (r, in)
        b = ad.load(keys["B"]).astype(np.float32)   # (out, r)
        out[init] = (np.ascontiguousarray(a.T), np.ascontiguousarray(b.T),
                     float(scale))
    if unmatched:
        raise ValueError(
            f"adapter modules {unmatched} have no matmul-weight mapping "
            f"in this model (mapped: {sorted(rev)[:8]}...): the served "
            f"adapter would be partially applied")
    if not out:
        raise ValueError("adapter contains no lora_A/lora_B pairs")
    return out


__all__ = ["LoraMergedStore", "load_peft_adapter_arrays"]
