"""SuperGraph link kinds and payload types.

Reference equivalent: src/super_graph/links.rs:6-28 (Tensor, String,
TensorMap, Tokenizer, Hash, Image, AudioClip, MultimodalItem, List-of).
Payloads are plain Python values; links are typed slots.

The port's copy of whisper_tensor_tpu/super_graph/links.py, unchanged.
A TENSOR or TENSOR_MAP payload may hold torch tensors on the device
while a job runs (super_graph/graph.py); it crosses to numpy at the
job's edge.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


class LinkKind(enum.Enum):
    TENSOR = "tensor"
    STRING = "string"
    TENSOR_MAP = "tensor_map"      # Dict[str, np.ndarray]
    TOKENIZER = "tokenizer"
    HASH = "hash"                  # int cache key
    IMAGE = "image"
    AUDIO_CLIP = "audio_clip"
    MULTIMODAL_ITEM = "multimodal_item"
    LIST = "list"                  # list of any payload kind


@dataclass
class SuperLink:
    id: int
    kind: LinkKind
    name: Optional[str] = None

    def to_json(self):
        return {"id": self.id, "kind": self.kind.value, "name": self.name}

    @staticmethod
    def from_json(d):
        return SuperLink(d["id"], LinkKind(d["kind"]), d.get("name"))


@dataclass
class Image:
    """HWC uint8 or float image payload."""

    pixels: np.ndarray

    @property
    def size(self):
        return self.pixels.shape[1], self.pixels.shape[0]


@dataclass
class AudioClip:
    samples: np.ndarray   # (n,) or (channels, n) float32 in [-1, 1]
    sample_rate: int

    @property
    def duration_s(self) -> float:
        return self.samples.shape[-1] / self.sample_rate


@dataclass
class MultimodalItem:
    role: str = "user"
    text: Optional[str] = None
    image: Optional[Image] = None
    embedding: Optional[np.ndarray] = None
