"""SuperGraph node kinds.

Reference equivalent: src/super_graph/nodes.rs:2808-2830 (21 node
kinds). Each node consumes/produces typed link payloads; execution is
host-side orchestration — heavy tensor work happens inside
ModelExecution (which dispatches to the oracle interpreter or compiled
XLA programs via the ExecutionContext).

The port's copy of whisper_tensor_tpu/super_graph/nodes.py (:80-383).
In torch mode a payload may be a device tensor (super_graph/graph.py):
the host-side nodes take it to numpy where they read it (`host_value`),
and ScanNode stacks a device column on the device. The phoneme nodes
run the port's copy of phonemization.py on the host.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..dtype import to_host
from ..graph import new_global_id
from .links import AudioClip, Image, LinkKind

_NODE_REGISTRY: Dict[str, type] = {}


def register_node(cls):
    _NODE_REGISTRY[cls.__name__] = cls
    return cls


def node_registry():
    return dict(_NODE_REGISTRY)


class SuperNode:
    """Base node: named input/output ports bound to link ids."""

    def __init__(self, name: str = "", inputs: Optional[Dict[str, int]] = None,
                 outputs: Optional[Dict[str, int]] = None, **params):
        self.id = new_global_id()
        self.name = name or type(self).__name__
        self.inputs = dict(inputs or {})
        self.outputs = dict(outputs or {})
        self.params = params

    def execute(self, ctx, ins: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError

    # -- serialization ----------------------------------------------------
    def to_json(self) -> dict:
        return {"type": type(self).__name__, "name": self.name,
                "inputs": self.inputs, "outputs": self.outputs,
                "params": _json_safe(self.params)}

    @classmethod
    def from_json(cls, d: dict) -> "SuperNode":
        klass = _NODE_REGISTRY[d["type"]]
        node = klass(name=d["name"], inputs=d["inputs"],
                     outputs=d["outputs"], **d.get("params", {}))
        if d.get("body") is not None:  # nested SuperGraph (ScanNode)
            from .graph import SuperGraph

            node.body = SuperGraph.from_json(d["body"])
        return node


def host_value(v):
    """A payload with every torch tensor in it moved to numpy."""
    if isinstance(v, torch.Tensor):
        return to_host(v)
    if isinstance(v, dict):
        return {k: host_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [host_value(x) for x in v]
    return v


def _json_safe(v):
    if isinstance(v, dict):
        return {k: _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, (str, int, float, bool, type(None))):
        return v
    if isinstance(v, np.ndarray):
        return {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
    raise TypeError(f"not serializable: {type(v)}")


# ---------------------------------------------------------------------------


@register_node
class ModelExecutionNode(SuperNode):
    """ports: in 'tensors' (TENSOR_MAP), out 'tensors' (TENSOR_MAP).
    params: model_ref (name in ctx.models).
    Reference: SuperGraphNodeModelExecution."""

    def execute(self, ctx, ins):
        model = ctx.models[self.params["model_ref"]]
        feeds = ins["tensors"]
        t0 = time.perf_counter()
        out = ctx.run_model(model, feeds)
        ctx.observer.on_node_executed(self, (time.perf_counter() - t0) * 1e3)
        return {"tensors": out}


@register_node
class MilliOpGraphNode(SuperNode):
    """Embedded milli graph for glue math (shape calc etc.).
    ports: in 'tensors', out 'tensors'. params hold the graph object
    (in-memory only; serialized jobs use builder-side reconstruction)."""

    def __init__(self, *args, graph=None, **kw):
        super().__init__(*args, **kw)
        self.graph = graph

    def execute(self, ctx, ins):
        out = self.graph.eval({k: np.asarray(host_value(v))
                               for k, v in ins["tensors"].items()})
        return {"tensors": out}

    def to_json(self):
        raise NotImplementedError("MilliOpGraphNode is not serializable yet")


@register_node
class TokenizerLoadNode(SuperNode):
    """params: source (path or registry name) -> out 'tokenizer'."""

    def execute(self, ctx, ins):
        return {"tokenizer": ctx.get_tokenizer(self.params["source"])}


@register_node
class TokenizerEncodeNode(SuperNode):
    """in: 'tokenizer', 'text' -> out 'tokens' (1-D i64)."""

    def execute(self, ctx, ins):
        ids = ins["tokenizer"].encode(ins["text"])
        return {"tokens": np.asarray(ids, dtype=np.int64)}


@register_node
class TokenizerDecodeNode(SuperNode):
    """in: 'tokenizer', 'tokens' -> out 'text'."""

    def execute(self, ctx, ins):
        toks = [int(t) for t in
                np.asarray(host_value(ins["tokens"])).reshape(-1)]
        return {"text": ins["tokenizer"].decode(toks)}


@register_node
class ScanNode(SuperNode):
    """Nested SuperGraph loop (reference SuperGraphNodeScan).

    params:
      state: list of (outer_init_port, body_in_name, body_out_name)
      scan_inputs: list of (outer_port, body_in_name, axis)
      scan_outputs: list of (body_out_name, outer_port, axis)
      n_iters_port: optional port carrying iteration count (else from
                    the first scan input's axis length)
    body: nested SuperGraph (attribute, reconstructed on deserialize)
    """

    def __init__(self, *args, body=None, **kw):
        super().__init__(*args, **kw)
        self.body = body

    def to_json(self):
        d = super().to_json()
        if self.body is not None:
            d["body"] = self.body.to_json()
        return d

    def execute(self, ctx, ins):
        from .graph import SuperGraph  # noqa: F401

        state_spec = self.params.get("state", [])
        scan_in = self.params.get("scan_inputs", [])
        scan_out = self.params.get("scan_outputs", [])
        state = {b_in: ins[outer] for outer, b_in, _ in state_spec}
        if "n_iters" in ins:
            n = int(np.asarray(host_value(ins["n_iters"])).reshape(()))
        elif scan_in:
            outer, _, axis = scan_in[0]
            n = ins[outer].shape[axis]
        else:
            raise ValueError("ScanNode: no iteration count")
        collected: Dict[str, List[Any]] = {b_out: [] for b_out, _, _ in scan_out}
        for it in range(n):
            feeds = dict(state)
            for outer, b_in, axis in scan_in:
                feeds[b_in] = _take(ins[outer], it, axis)
            ctx.observer.on_progress(self, it / max(n, 1))
            if ctx.observer.should_cancel():
                from ..milli.ir import EvalCancelled

                raise EvalCancelled()
            out = self.body.run(ctx, feeds, host=False)
            state = {b_in: out[b_out]
                     for (_, b_in, b_out) in [(s[0], s[1], s[2]) for s in state_spec]}
            for b_out, _, _ in scan_out:
                collected[b_out].append(out[b_out])
        result = {}
        for outer, b_in, b_out in state_spec:
            result[f"final_{b_in}"] = state[b_in]
        for b_out, outer_port, axis in scan_out:
            result[outer_port] = _stack(collected[b_out], axis)
        return result


def _take(v, i: int, axis: int):
    """Item `i` along `axis` of a numpy array or a torch tensor."""
    if isinstance(v, torch.Tensor):
        return v.select(axis, i)
    return np.take(np.asarray(v), i, axis=axis)


def _stack(items: List[Any], axis: int):
    """A scan column: torch.stack where every item is a tensor (a device
    column stays on the device), np.stack otherwise."""
    if items and all(isinstance(x, torch.Tensor) for x in items):
        return torch.stack(items, dim=axis)
    return np.stack([np.asarray(host_value(x)) for x in items], axis=axis)


@register_node
class RNNCacheReadNode(SuperNode):
    """in: 'hash', 'tokens' -> out: 'state' (may be None), 'prefix_len'.
    Longest-token-prefix state resume (reference RNNCacheRead)."""

    def execute(self, ctx, ins):
        h = int(np.asarray(host_value(ins["hash"])).reshape(()))
        toks = tuple(int(t) for t in
                     np.asarray(host_value(ins["tokens"])).reshape(-1))
        prefix, state = ctx.cache.read(h, toks)
        return {"state": state,
                "prefix_len": np.asarray(len(prefix), dtype=np.int64)}


@register_node
class RNNCacheWriteNode(SuperNode):
    """in: 'hash', 'tokens', 'state' -> (no outputs)."""

    def execute(self, ctx, ins):
        h = int(np.asarray(host_value(ins["hash"])).reshape(()))
        toks = tuple(int(t) for t in
                     np.asarray(host_value(ins["tokens"])).reshape(-1))
        ctx.cache.write(h, toks, ins["state"])
        return {}


@register_node
class TensorCacheReadNode(SuperNode):
    """params: key; in: 'store_id' optional -> out 'tensor' or raises."""

    def execute(self, ctx, ins):
        store = ctx.tensor_cache.get(int(self.params.get("store_id", 0)))
        return {"tensor": store[self.params["key"]]}


@register_node
class TensorCacheWriteNode(SuperNode):
    def execute(self, ctx, ins):
        store = ctx.tensor_cache.get(int(self.params.get("store_id", 0)))
        store[self.params["key"]] = ins["tensor"]
        return {}


@register_node
class TensorPackCacheReadNode(SuperNode):
    """Tensor-map variant of TensorCacheRead (reference TensorPackCache)."""

    def execute(self, ctx, ins):
        store = ctx.tensor_cache.get(int(self.params.get("store_id", 0)))
        return {"tensors": store.get(self.params["key"], {})}


@register_node
class TensorPackCacheWriteNode(SuperNode):
    def execute(self, ctx, ins):
        store = ctx.tensor_cache.get(int(self.params.get("store_id", 0)))
        store[self.params["key"]] = ins["tensors"]
        return {}


@register_node
class ReportProgressNode(SuperNode):
    """in: 'value' (fraction 0..1 tensor), passthrough + observer."""

    def execute(self, ctx, ins):
        frac = float(np.asarray(host_value(ins["value"])).reshape(()))
        ctx.observer.on_progress(self, frac)
        return {"value": ins["value"]}


@register_node
class TensorToImageNode(SuperNode):
    """in: 'tensor' (1,C,H,W) or (C,H,W) in [-1,1] or [0,1] -> out 'image'."""

    def execute(self, ctx, ins):
        x = np.asarray(host_value(ins["tensor"])).astype(np.float32)
        if x.ndim == 4:
            x = x[0]
        lo = self.params.get("input_range_low", -1.0)
        hi = self.params.get("input_range_high", 1.0)
        x = (x - lo) / (hi - lo)
        x = np.clip(x, 0, 1)
        pixels = (np.transpose(x, (1, 2, 0)) * 255).round().astype(np.uint8)
        return {"image": Image(pixels)}


@register_node
class ImageToTensorNode(SuperNode):
    """in: 'image' -> out 'tensor' (1,C,H,W) float in configured range."""

    def execute(self, ctx, ins):
        img = ins["image"]
        lo = self.params.get("output_range_low", -1.0)
        hi = self.params.get("output_range_high", 1.0)
        x = img.pixels.astype(np.float32) / 255.0 * (hi - lo) + lo
        return {"tensor": np.transpose(x, (2, 0, 1))[None]}


@register_node
class TensorToAudioClipNode(SuperNode):
    """in: 'tensor' -> out 'audio' at params['sample_rate']."""

    def execute(self, ctx, ins):
        samples = np.asarray(host_value(ins["tensor"])).astype(
            np.float32).reshape(-1)
        return {"audio": AudioClip(samples, int(self.params.get("sample_rate", 22050)))}


@register_node
class AudioClipToTensorNode(SuperNode):
    """in: 'audio' -> out 'tensor' (1, n) float32, resampled if needed."""

    def execute(self, ctx, ins):
        clip = ins["audio"]
        samples = np.asarray(clip.samples, dtype=np.float32).reshape(-1)
        target = int(self.params.get("sample_rate", clip.sample_rate))
        if target != clip.sample_rate:
            from ..utils.audio import resample

            samples = resample(samples, clip.sample_rate, target)
        return {"tensor": samples[None]}


@register_node
class AudioClipToMelSpectrogramNode(SuperNode):
    """in: 'audio' -> out 'mel' (1, n_mels, frames). Whisper-style log-mel.
    params: n_mels (80), n_fft (400), hop (160), sample_rate (16000),
    pad_to_frames optional."""

    def execute(self, ctx, ins):
        from ..utils.audio import log_mel_spectrogram, resample

        clip = ins["audio"]
        sr = int(self.params.get("sample_rate", 16000))
        samples = np.asarray(clip.samples, dtype=np.float32).reshape(-1)
        if clip.sample_rate != sr:
            samples = resample(samples, clip.sample_rate, sr)
        mel = log_mel_spectrogram(
            samples, sr,
            n_mels=int(self.params.get("n_mels", 80)),
            n_fft=int(self.params.get("n_fft", 400)),
            hop=int(self.params.get("hop", 160)),
            pad_to_frames=self.params.get("pad_to_frames"))
        return {"mel": mel[None]}


@register_node
class TextToPhonemesNode(SuperNode):
    """in: 'text' -> out 'phonemes' (IPA string). params: language."""

    def execute(self, ctx, ins):
        from ..phonemization import phonemize

        return {"phonemes": phonemize(ins["text"],
                                      self.params.get("language", "en-us"))}


@register_node
class PiperPhonemesToTensorNode(SuperNode):
    """in: 'phonemes' -> out 'tokens' (1, n) i64 via the piper id map
    (params: phoneme_id_map)."""

    def execute(self, ctx, ins):
        from ..phonemization import piper_phoneme_ids

        ids = piper_phoneme_ids(ins["phonemes"], self.params.get("phoneme_id_map"))
        return {"tokens": np.asarray(ids, dtype=np.int64)[None]}


@register_node
class KokoroPhonemesToTensorNode(SuperNode):
    """in: 'phonemes' -> out 'tokens' via the kokoro (misaki) vocab."""

    def execute(self, ctx, ins):
        from ..phonemization import kokoro_phoneme_ids

        ids = kokoro_phoneme_ids(ins["phonemes"], self.params.get("vocab"))
        return {"tokens": np.asarray(ids, dtype=np.int64)[None]}


@register_node
class F5TextToTensorNode(SuperNode):
    """in: 'text' -> out 'tokens' via F5-TTS character vocab."""

    def execute(self, ctx, ins):
        vocab = self.params.get("vocab") or {}
        ids = [vocab.get(c, 0) for c in ins["text"]]
        return {"tokens": np.asarray(ids, dtype=np.int64)[None]}
