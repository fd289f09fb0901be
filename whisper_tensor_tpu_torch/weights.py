"""Weights carried from host arrays to the port's device tensors.

The JAX TextInferenceInterface assembles its weights as one host array
per milli input name (whisper_tensor_tpu/interfaces/text.py:584-633):
dense weights, fused q/k/v and gate/up concatenations, int8 matrices
and their `::scale` vectors. This module uploads such a set, so the
port and the reference can run on the very same arrays.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .dtype import DType, to_device


def carry_weights(arrays: Mapping[str, np.ndarray],
                  dtypes: Mapping[str, DType],
                  device: torch.device) -> Dict[str, torch.Tensor]:
    """{name: host array} + {name: declared DType} -> {name: tensor}.

    A float array whose host type differs from its declared DType (BF16
    held as float32 where ml_dtypes is missing) is cast on the device."""
    if set(arrays) != set(dtypes):
        raise ValueError(
            f"weights and declared dtypes name different tensors: "
            f"{sorted(set(arrays) ^ set(dtypes))[:8]}")
    return {n: to_device(a, device, dtypes[n]) for n, a in arrays.items()}
