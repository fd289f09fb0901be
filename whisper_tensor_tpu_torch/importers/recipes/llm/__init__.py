"""The text recipes: each builds a model's ONNX step graph from its
weights (the port's copies of whisper_tensor_tpu/importers/recipes/llm/).

`transposed` is the recipes' host transpose of a weight matrix into its
matmul-RHS layout."""

from __future__ import annotations

import warnings

import numpy as np
import torch

# same-size integer carriers: torch has no ml_dtypes bf16 or f8 type
_CARRIERS = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}


def transposed(a) -> np.ndarray:
    """np.ascontiguousarray(a.T) of a 2-D array, bit for bit, by torch's
    blocked copy: numpy's strided transpose reads a large weight several
    times slower, and the loaders transpose every matmul weight (and a
    tied lm_head of vocab x hidden) at each load. The bits move as
    same-size integers."""
    a = np.asarray(a)
    carrier = _CARRIERS.get(a.dtype.itemsize)
    if a.ndim != 2 or carrier is None or a.dtype.kind == "O":
        return np.ascontiguousarray(a.T)
    with warnings.catch_warnings():     # a read-only array is only read
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(np.ascontiguousarray(a).view(carrier))
    return t.T.contiguous().numpy().view(a.dtype)
