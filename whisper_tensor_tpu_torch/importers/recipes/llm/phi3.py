"""Phi-3 import recipe (fused qkv_proj / gate_up_proj, no biases).

Reference equivalent: crates/whisper-tensor-import/src/models/llm/phi3.rs.
Delegates to the llama step builder after unfusing the packed weights.

The port's copy of whisper_tensor_tpu/importers/recipes/llm/phi3.py,
unchanged: the same getter gives the reference's ONNX bytes (through the
port's build_llama_step). Phi-3-mini's head dim is 96, which no
attention kernel takes: its Attention runs the plain path, as the
reference's runs XLA's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ....dtype import DType
from ...onnx_builder import WeightStorage
from .llama import LlamaConfig, build_llama_step


@dataclass
class Phi3Config(LlamaConfig):
    model_type: str = "phi3"

    @staticmethod
    def from_hf(cfg: dict) -> "Phi3Config":
        base = LlamaConfig.from_hf(cfg)
        return Phi3Config(**{**base.__dict__, "model_type": "phi3",
                             "attention_bias": False})


def build_phi3_step(weights: Callable[[str], np.ndarray], cfg: Phi3Config,
                    max_len: int, dtype: DType = DType.F32,
                    storage: Optional[WeightStorage] = None) -> bytes:
    """Unfuse phi3's packed projections into llama layout, then reuse the
    llama step builder."""
    E = cfg.hidden_size
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.hd
    I = cfg.intermediate_size

    def get(name: str) -> np.ndarray:
        parts = name.split(".")
        if "self_attn" in name:
            layer = ".".join(parts[:3])
            packed = np.asarray(weights(layer + ".self_attn.qkv_proj.weight"))
            qn = Hq * D
            kn = Hkv * D
            if name.endswith("q_proj.weight"):
                return packed[:qn]
            if name.endswith("k_proj.weight"):
                return packed[qn:qn + kn]
            if name.endswith("v_proj.weight"):
                return packed[qn + kn:]
            if name.endswith("o_proj.weight"):
                return np.asarray(weights(layer + ".self_attn.o_proj.weight"))
        if ".mlp." in name:
            layer = ".".join(parts[:3])
            if name.endswith("down_proj.weight"):
                return np.asarray(weights(layer + ".mlp.down_proj.weight"))
            packed = np.asarray(weights(layer + ".mlp.gate_up_proj.weight"))
            if name.endswith("gate_proj.weight"):
                return packed[:I]
            if name.endswith("up_proj.weight"):
                return packed[I:]
        return np.asarray(weights(name))

    return build_llama_step(get, cfg, max_len=max_len, dtype=dtype,
                            storage=storage)
