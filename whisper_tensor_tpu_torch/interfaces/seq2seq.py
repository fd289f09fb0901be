"""Sequence-to-sequence text2text (T5) and speech (Whisper) interface on
PyTorch.

Counterpart of whisper_tensor_tpu/interfaces/seq2seq.py. The reference
runs the encoder once and compiles the decode loop (`_decode_program`,
:94-146) and beam search (`_beam_program`, :148-247) into one lax.scan
program each; here the encoder runs once on the device
(EvalBackend.run_on_device), its cross K/V stay there, and each loop is
a Python loop over the cached decoder step that keeps tokens, scores and
caches on the device and reads back only the finished tokens. The
decoder step runs through a TextInferenceInterface (`self.dec`), which
fuses its matmuls, pairs its cache writes (one ragged_kv_write launch a
layer a step) and holds its device weights; the step graph's cross_*
inputs are fed beside its caches. As in the reference, `start_sequence`
is a forced decoder prefix of one or more tokens (Whisper's
start-of-transcript sequence) run as one prefill, and `encoder_feed`
names the encoder's input ("mel" for Whisper).

A token encoder (`input_ids`) has a fixed length. A shorter prompt is
padded with id 0 (T5's pad) to it; an encoder that takes an
`attention_mask` (the loader's T5 graphs, recipes/llm/t5.py `pad_mask`)
is fed 1 over the prompt and 0 over the pads, and hands the decoder its
`cross_mask`, so no pad is attended (ROADMAP C28). An encoder without
that input takes only prompts of its length, as the reference's
`encode` does. A `mel` feed is never padded. Beam search takes the top
W of (B, W*V) with torch.topk, which orders equal scores differently
from lax.top_k: beams agree with the reference where no two candidates
tie.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..backends.eval_backend import EvalBackend
from ..device import resolve_device
from ..dtype import DType
from ..model import Model
from .text import SamplingParams, TextInferenceInterface, _pick_token


class Seq2SeqInterface:
    """encoder: input_ids(B,L) -> encoder_states + cross_k_i/cross_v_i.
    decoder_step: input_ids(B,S), pos, cache_*, cross_*, weights ->
    logits + new_cache_*."""

    def __init__(self, encoder: Model, decoder_step: Model, max_len: int,
                 start_token: int = 0, eos_token: int = 1,
                 tokenizer=None, cache_dtype: DType = DType.F32,
                 start_sequence: Optional[List[int]] = None,
                 encoder_feed: str = "input_ids", device=None,
                 dec: Optional[TextInferenceInterface] = None):
        """start_sequence: multi-token forced decoder prefix (Whisper's
        start-of-transcript sequence); defaults to [start_token].
        encoder_feed: the encoder's input name ('mel' for Whisper).
        dec: a TextInferenceInterface of `decoder_step` on `device` to
        share (its fused graph and device weights)."""
        self.device = resolve_device(device)
        self.encoder = encoder
        self.decoder = decoder_step
        self.max_len = max_len
        self.start_token = start_token
        self.start_sequence = list(start_sequence) if start_sequence \
            else [start_token]
        self.encoder_feed = encoder_feed
        self.eos_token = eos_token
        self.tokenizer = tokenizer
        self.cache_dtype = cache_dtype
        self.dec = dec or TextInferenceInterface(decoder_step, max_len,
                                                 cache_dtype=cache_dtype,
                                                 device=self.device)
        self.cross_in = [n for n in self.dec.milli.inputs
                         if n.startswith("cross_")]
        g = encoder.graph
        self.enc_len = self.masked = None
        if encoder_feed == "input_ids":
            self.enc_len = int(g.tensors[g.by_name["input_ids"]].info
                               .dims()[1].value())
            self.masked = "attention_mask" in [g.tensors[t].name
                                               for t in g.inputs]
        self._enc_backend = EvalBackend("torch", device=self.device)

    # ------------------------------------------------------------------
    def _enc_feeds(self, inputs) -> Dict[str, np.ndarray]:
        """The encoder's feeds: a mel batch as given; (B, L) ids padded
        with 0 to `enc_len`, with their `attention_mask` where the graph
        takes one."""
        if self.encoder_feed != "input_ids":
            a = np.asarray(inputs, dtype=np.float32)
            return {self.encoder_feed: a if a.ndim == 3 else a[None]}
        a = np.asarray(inputs, dtype=np.int64)
        if a.ndim == 1:
            a = a[None]
        B, L = a.shape
        if L > self.enc_len:
            raise ValueError(f"prompt of {L} tokens exceeds the encoder "
                             f"length {self.enc_len}")
        if L < self.enc_len and not self.masked:
            raise ValueError(f"prompt of {L} tokens is shorter than the "
                             f"encoder length {self.enc_len}, and the "
                             f"encoder graph has no attention_mask input "
                             f"to mask the pads")
        feeds = {"input_ids": np.pad(a, ((0, 0), (0, self.enc_len - L)))}
        if self.masked:
            feeds["attention_mask"] = np.broadcast_to(
                (np.arange(self.enc_len) < L).astype(np.int64),
                (B, self.enc_len)).copy()
        return feeds

    def encode(self, input_ids) -> Dict[str, torch.Tensor]:
        """(B, L) ids, or (B, n_mels, frames) mel -> the encoder's
        outputs as device tensors."""
        return self._enc_backend.run_on_device(self.encoder.graph,
                                               self._enc_feeds(input_ids))

    def fresh_cache(self, batch: int) -> List[torch.Tensor]:
        return self.dec.fresh_cache(batch)

    def _step(self, ids: torch.Tensor, pos: torch.Tensor,
              caches: List[torch.Tensor],
              crosses: List[torch.Tensor]) -> torch.Tensor:
        """One decoder step: (R, S) ids -> (R, S, V) logits; the caches
        are written in place."""
        feeds = self.dec._feeds(ids, pos, caches)
        feeds.update(zip(self.cross_in, crosses))
        return self.dec._exec(feeds)["logits"]

    def _prefix(self, rows: int) -> torch.Tensor:
        """The decoder's first input: the forced start sequence in each
        row."""
        return torch.tensor(self.start_sequence, dtype=torch.int64,
                            device=self.device)[None].expand(rows, -1)

    # ------------------------------------------------------------------
    def generate_tokens(self, input_ids, n_new: int,
                        sampling: Optional[SamplingParams] = None
                        ) -> np.ndarray:
        """(B, L) encoder ids (or a mel batch) -> (B, n_new) decoder ids
        (starting after the start sequence). sampling=None is greedy;
        otherwise tokens are drawn from a torch.Generator seeded with
        sampling.seed."""
        enc = self.encode(input_ids)
        crosses = [enc[n] for n in self.cross_in]
        B = crosses[0].shape[0]
        caches = self.fresh_cache(B)
        gen = None
        if sampling is not None and sampling.temperature > 0.0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(sampling.seed))
        P = len(self.start_sequence)
        pos = torch.zeros((), dtype=torch.int64, device=self.device)
        lg = self._step(self._prefix(B), pos, caches, crosses)
        toks = [_pick_token(lg[:, -1, :], gen, sampling, None)]
        pos = pos + P
        for _ in range(1, n_new):
            lg = self._step(toks[-1][:, None], pos, caches, crosses)
            toks.append(_pick_token(lg[:, -1, :], gen, sampling, None))
            pos = pos + 1
        return torch.stack(toks, dim=1).cpu().numpy()

    def beam_search_tokens(self, input_ids, n_new: int, beam: int = 4,
                           length_penalty: float = 0.0) -> np.ndarray:
        """Beam-search decode: (B, L) ids (or a mel batch) -> (B, n_new)
        best sequences.
        Rows are batch * beam; each step re-scores (B, W*V), keeps the
        top W and gathers caches and histories by parent beam. A beam
        that emitted EOS extends only with EOS, at no cost."""
        enc = self.encode(input_ids)
        W = beam
        crosses = [torch.repeat_interleave(enc[n], W, dim=0)
                   for n in self.cross_in]
        R = crosses[0].shape[0]
        B = R // W
        caches = self.fresh_cache(R)
        dev, eos = self.device, self.eos_token
        scores = torch.where(torch.arange(R, device=dev) % W == 0, 0.0,
                             -torch.inf)
        alive = torch.ones((R,), dtype=torch.bool, device=dev)
        hist = torch.zeros((R, n_new), dtype=torch.int64, device=dev)
        base = (torch.arange(B, device=dev) * W)[:, None]

        def select(lp, i, scores, alive):
            V = lp.shape[-1]
            eos_only = torch.full((V,), -torch.inf, device=dev)
            eos_only[eos] = 0.0
            lp = torch.where(alive[:, None], lp, eos_only[None])
            total = scores[:, None] + lp                        # (R, V)
            top_s, top_i = torch.topk(total.reshape(B, W * V), W, dim=-1)
            rows = (base + top_i // V).reshape(-1)
            token = (top_i % V).reshape(-1)
            for c in caches:
                c.copy_(c[rows])
            hist.copy_(hist[rows])
            hist[:, i] = token
            return token, top_s.reshape(-1), alive[rows] & (token != eos)

        pos = torch.zeros((), dtype=torch.int64, device=dev)
        lg = self._step(self._prefix(R), pos, caches, crosses)
        cur, scores, alive = select(
            torch.log_softmax(lg[:, -1, :].float(), dim=-1), 0, scores,
            alive)
        pos = pos + len(self.start_sequence)
        for i in range(1, n_new):
            lg = self._step(cur[:, None], pos, caches, crosses)
            cur, scores, alive = select(
                torch.log_softmax(lg[:, -1, :].float(), dim=-1), i, scores,
                alive)
            pos = pos + 1
        norm = scores.reshape(B, W)
        if length_penalty != 0.0:
            is_eos = hist == eos
            lengths = torch.clamp(
                torch.argmax(is_eos.int(), dim=1)
                + torch.where(is_eos.any(dim=1), 1, n_new), max=n_new)
            norm = norm / lengths.reshape(B, W).float() ** length_penalty
        best = torch.argmax(norm, dim=1)
        return hist.reshape(B, W, n_new)[
            torch.arange(B, device=dev), best].cpu().numpy()

    def run_string_in_string_out(self, text: str, n_new: int = 32,
                                 sampling: Optional[SamplingParams] = None
                                 ) -> str:
        if self.tokenizer is None:
            raise ValueError("no tokenizer configured")
        ids = np.asarray(self.tokenizer.encode(text), dtype=np.int64)[None]
        toks = self.generate_tokens(ids, n_new, sampling=sampling)[0]
        out = []
        for t in toks:
            if int(t) == self.eos_token:
                break
            out.append(int(t))
        return self.tokenizer.decode(out)
