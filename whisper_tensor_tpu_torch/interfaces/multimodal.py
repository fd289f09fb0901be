"""Multimodal language interface on PyTorch: interleaved text, image and
embedding inputs.

Counterpart of whisper_tensor_tpu/interfaces/multimodal.py (the
reference's MultimodalLanguageInterface, src/interfaces.rs:185-327).
Graph surgery (symbolic_graph/surgery.py) derives an `inputs_embeds`
entry of the text model's step graph; here it runs with the text
interface's own passes (matmul fusion, int8, the paired cache writes)
over the text interface's device weights, so the embeds prefill takes
the same kernels as a token prefill and nothing is uploaded twice. The
reference's compiled prefill (`_prefill_program`, :107-138) is one
eager run of that graph on the device; decoding continues on the text
interface's step graph from the caches it filled. Text embeds through
the model's own table on the device, images through the vision encoder
(EvalBackend.run_on_device), and the fused sequence never leaves the
card: `embed_items` returns a device tensor. Packed (GGUF, q4_0) text
weights are not taken on the embeds path yet.
"""

from __future__ import annotations

import copy
from typing import List, Optional

import numpy as np
import torch

from ..backends.eval_backend import EvalBackend
from ..backends.torch_exec.compiler import GraphExecutor
from ..milli.transforms import (fuse_parallel_matmuls, pair_cache_writes,
                                quantize_matmul_weights)
from ..model import Model
from ..super_graph.links import MultimodalItem
from .text import SamplingParams, _bucket, _pick_token


class MultimodalLanguageInterface:
    """Wraps a TextInferenceInterface. Images pass through an optional
    vision-encoder Model (pixels -> "embeddings" (1, n, E)); text
    tokenizes and embeds through the model's own table; the fused
    (1, S, E) sequence prefills through the inputs_embeds graph."""

    def __init__(self, text_interface, embed_weight_name: str = "wte",
                 vision_encoder: Optional[Model] = None):
        self.text = text_interface
        self.device = text_interface.device
        self.vision_encoder = vision_encoder
        self.embed_weight_name = embed_weight_name
        self._vision = EvalBackend("torch", device=self.device)
        self._embeds_exec: Optional[GraphExecutor] = None
        self._embeds_weight_names: List[str] = []

    # ------------------------------------------------------------------
    def _wte(self) -> torch.Tensor:
        """The token-embedding table: the text interface's device
        weight."""
        return self.text._weights()[self.embed_weight_name]

    def encode_image(self, pixels: np.ndarray) -> torch.Tensor:
        """(H, W, 3) uint8 pixels -> (n, E) embeddings on the device."""
        if self.vision_encoder is None:
            raise ValueError("no vision encoder configured")
        px = (pixels.astype(np.float32) / 127.5) - 1.0
        out = self._vision.run_on_device(
            self.vision_encoder.graph,
            {"pixels": np.transpose(px, (2, 0, 1))[None]})
        return out["embeddings"].reshape(-1, out["embeddings"].shape[-1])

    def embed_items(self, items: List[MultimodalItem]) -> torch.Tensor:
        """Fuse items into one (1, S, E) embedding sequence on the
        device."""
        wte = self._wte()
        parts: List[torch.Tensor] = []
        for item in items:
            if item.text is not None:
                if self.text.tokenizer is None:
                    raise ValueError("no tokenizer for text items")
                ids = np.asarray(self.text.tokenizer.encode(item.text),
                                 dtype=np.int64)
                parts.append(wte[torch.from_numpy(ids).to(self.device)])
            if item.embedding is not None:
                emb = torch.as_tensor(np.asarray(item.embedding),
                                      device=self.device)
                parts.append(emb.to(wte.dtype).reshape(-1, wte.shape[1]))
            if item.image is not None:
                parts.append(self.encode_image(item.image.pixels)
                             .to(wte.dtype))
        return torch.cat(parts, dim=0)[None]

    # ------------------------------------------------------------------
    def _ensure_embeds_exec(self):
        """The inputs_embeds graph with the text interface's passes: its
        matmul fusion (deterministic names, so the fused device weights
        are shared) and int8 quantization (the same weights, so the same
        int8 tensors and scales)."""
        if self._embeds_exec is not None:
            return
        from ..symbolic_graph.surgery import replace_ids_with_embeds

        t = self.text
        if t._packed or t.row_extra_names:
            raise NotImplementedError(
                "the inputs_embeds path takes dense or int8 text weights "
                "only (not packed weights or served adapters)")
        graph = replace_ids_with_embeds(t.model.graph)
        milli, weight_inputs = graph.to_milli()
        if t._fused:
            fuse_parallel_matmuls(milli, set(weight_inputs))
        if t._quantized:
            # the placement is the text graph's; the values come from the
            # text interface's device weights, so none is quantized here
            quantize_matmul_weights(
                milli, list(t._quantized),
                lambda n: np.broadcast_to(np.float32(0.0),
                                          t._quantized[n][0].shape))
        names = [n for n in milli.inputs
                 if n in weight_inputs or n in t._fused
                 or n.endswith("::scale")]
        missing = [n for n in names if n not in t._weights()]
        if missing:
            raise ValueError(f"the inputs_embeds graph names weights the "
                             f"text interface lacks: {missing[:4]}")
        self._embeds_weight_names = names
        run = copy.copy(milli)
        pair_cache_writes(run)
        self._embeds_exec = GraphExecutor(run, self.device)

    def prefill_embeds(self, embeds: torch.Tensor, caches) -> torch.Tensor:
        """One run of the inputs_embeds graph at pos 0: (B, S, E) device
        embeddings -> (B, S, V) logits; `caches` are written in place."""
        self._ensure_embeds_exec()
        w = self.text._weights()
        feeds = {"inputs_embeds": embeds,
                 "pos": torch.zeros((), dtype=torch.int64,
                                    device=self.device)}
        feeds.update(zip(self.text.cache_in_names, caches))
        feeds.update({n: w[n] for n in self._embeds_weight_names})
        return self._embeds_exec(feeds)["logits"]

    def generate_from_embeds(self, embeds, n_new: int,
                             sampling: Optional[SamplingParams] = None
                             ) -> np.ndarray:
        """(B, L, E) fused embeddings -> (B, n_new) generated ids: the
        embeds prefill at the prompt's bucket, then the text interface's
        decode steps. sampling=None is greedy."""
        wte = self._wte()
        embeds = torch.as_tensor(embeds, device=self.device).to(wte.dtype)
        if embeds.ndim == 2:
            embeds = embeds[None]
        B, L, E = embeds.shape
        Sb = _bucket(L, self.text.prompt_buckets)
        padded = torch.zeros((B, Sb, E), dtype=wte.dtype, device=self.device)
        padded[:, :L] = embeds
        caches = self.text.fresh_cache(B)
        logits = self.prefill_embeds(padded, caches)
        gen = None
        if sampling is not None and sampling.temperature > 0.0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(sampling.seed))
        toks = [_pick_token(logits[:, L - 1, :], gen, sampling, None)]
        pos = torch.full((), L, dtype=torch.int64, device=self.device)
        for _ in range(1, n_new):
            last = self.text.step(toks[-1][:, None], pos, caches)[:, -1, :]
            toks.append(_pick_token(last, gen, sampling, None))
            pos = pos + 1
        return torch.stack(toks[:n_new], dim=1).cpu().numpy()

    def run_items_in_string_out(self, items: List[MultimodalItem],
                                n_new: int = 32,
                                sampling: Optional[SamplingParams] = None
                                ) -> str:
        """Generation conditioned on the fused sequence through the
        inputs_embeds path (no token requantization)."""
        toks = self.generate_from_embeds(self.embed_items(items), n_new,
                                         sampling=sampling)[0]
        if self.text.tokenizer is None:
            return " ".join(str(t) for t in toks)
        return self.text.tokenizer.decode([int(t) for t in toks])

    # ------------------------------------------------------------------
    def run_items_nearest_token(self, items: List[MultimodalItem],
                                n_new: int = 32) -> str:
        """Explicit lossy fallback: re-quantize embeddings to their
        nearest vocab tokens and run the plain token path. Only exact
        for text-only item lists; kept for models whose step graph
        cannot take surgery."""
        embeds = self.embed_items(items)[0].float()
        w32 = self._wte().float()
        norms = (w32 ** 2).sum(-1)
        ids = torch.argmax(embeds @ w32.T - 0.5 * norms[None, :], dim=-1)
        toks = self.text.generate_tokens(
            ids[None].cpu().numpy().astype(np.int64), n_new)[0]
        if self.text.tokenizer is None:
            return " ".join(str(t) for t in toks)
        return self.text.tokenizer.decode([int(t) for t in toks])
