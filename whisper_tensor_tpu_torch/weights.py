"""Weights carried from host arrays to the port's device tensors.

The JAX TextInferenceInterface assembles its weights as one host array
per milli input name (whisper_tensor_tpu/interfaces/text.py:584-633):
dense weights, fused q/k/v and gate/up concatenations, int8 matrices
and their `::scale` vectors. `carry_weights` uploads such a set, so the
port and the reference can run on the very same arrays.

The diffusion recipes take their weights from a name -> numpy getter
(`random_unet_weights` and its like, or a diffusers checkpoint's
safetensors) and cast each array to the model's type as they embed it.
`carry_arrays` puts such arrays on a device in that type, as the
model's parameters.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .dtype import DType, to_device, to_torch


def carry_weights(arrays: Mapping[str, np.ndarray],
                  dtypes: Mapping[str, DType],
                  device: torch.device) -> Dict[str, torch.Tensor]:
    """{name: host array} + {name: declared DType} -> {name: tensor}.

    A float array whose host type differs from its declared DType (BF16
    held as float32 where ml_dtypes is missing) is cast on the device. A
    tensor already on `device` in its declared type is taken as it is
    (an interface's int8 weights shared with a sibling's)."""
    if set(arrays) != set(dtypes):
        raise ValueError(
            f"weights and declared dtypes name different tensors: "
            f"{sorted(set(arrays) ^ set(dtypes))[:8]}")
    return {n: (a.to(device, to_torch(dtypes[n]))
                if isinstance(a, torch.Tensor)
                else to_device(a, device, dtypes[n]))
            for n, a in arrays.items()}


def carry_arrays(arrays: Mapping[str, np.ndarray], dtype: DType,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """{name: host array of any float type} -> {name: tensor of `dtype`
    on `device`}: each array rounded to `dtype` once, on the host, as a
    recipe's `astype` rounds the weights it embeds."""
    np_dt = dtype.to_numpy()
    return {n: to_device(np.asarray(a).astype(np_dt), device, dtype)
            for n, a in arrays.items()}
