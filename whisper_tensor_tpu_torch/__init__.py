"""PyTorch + CUDA port of whisper_tensor_tpu.

The JAX package stays the reference, and this package imports nothing
of it. It keeps its own copies of the framework-neutral layers it runs,
trimmed to the text path it serves (ONNX codec and builder, the llama
and GPT-2 recipes, the transformers and GGUF loaders, the GGUF block
formats and their numpy (de)quantizers, the symbolic graph, the milli
IR with its numpy ops and passes, tokenizers, the server, its protocol
and its OpenAI HTTP front end; each copy's docstring names its
source), and owns every place that executes tensors: the milli-op
lowerings, the graph executor, the text interface, the batcher and the
hand-written CUDA kernels under csrc/.

Importing the package sets the precision contract (see device.py).
It never imports jax.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
