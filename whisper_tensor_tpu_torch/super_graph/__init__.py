"""The port's SuperGraph layer: serializable job graphs whose nodes run
models on the device, with observers that stream node timings and the
tensors a client subscribes to (the port's copy of
whisper_tensor_tpu/super_graph/__init__.py)."""

from .cache import SuperGraphCache, SuperGraphTensorCache
from .graph import ExecutionContext, SuperGraph, SuperObserver
from .links import AudioClip, Image, LinkKind, MultimodalItem, SuperLink
from . import nodes

__all__ = ["SuperGraph", "ExecutionContext", "SuperObserver",
           "SuperGraphCache", "SuperGraphTensorCache",
           "LinkKind", "SuperLink", "Image", "AudioClip", "MultimodalItem",
           "nodes"]
