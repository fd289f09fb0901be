"""Super-graph payload types: the Image payload.

The port's copy of whisper_tensor_tpu/super_graph/links.py (reference
src/super_graph/links.rs:6-28), trimmed to `Image`, which the image
interface returns. The link kinds, SuperLink, AudioClip and
MultimodalItem wait for the super graphs and the speech and multimodal
interfaces (ROADMAP A9).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Image:
    """HWC uint8 or float image payload."""

    pixels: np.ndarray

    @property
    def size(self):
        return self.pixels.shape[1], self.pixels.shape[0]
