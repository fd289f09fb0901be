"""PyTorch + CUDA port of whisper_tensor_tpu.

The JAX package stays the reference. This package reuses its
framework-neutral layers (ONNX import, recipes, the milli IR and its
numpy passes, tokenizers, the server protocol and HTTP front end) and
owns every place that executes tensors: the milli-op lowerings, the
graph executor, the text interface, and the hand-written CUDA kernels
under csrc/.

Importing the package sets the precision contract (see device.py).
It never imports jax.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
