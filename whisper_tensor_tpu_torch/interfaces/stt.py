"""Speech-to-text interface (Whisper encoder-decoder) on PyTorch.

Counterpart of whisper_tensor_tpu/interfaces/stt.py: audio -> mel
spectrogram (utils/audio.py, on the host as in the reference) ->
encoder -> greedy decoder with a forced start-of-transcript prefix.

The reference compiles the greedy decode into one jitted lax.scan
(`_decode_program`, :161-200) over its matmul-fused decoder step. Here
`_transcribe_compiled` is one loop on the device over the decoder step
run through a TextInferenceInterface (`self.dec`), which fuses its
matmuls, pairs its cache writes (one ragged_kv_write launch a layer a
step) and holds its device weights: the tokens, their validity, the
position and the caches stay on the device, and the loop reads back the
validity once every `CHECK_EVERY` steps (to stop after the end of the
transcript, which the scan's fixed length runs through) and then the
tokens. Each step computes what the scan's body computes, so the tokens
are the reference's. `_transcribe_mel`, the reference's Python loop
(:301-336), stays as the plain referee: the unfused decoder graph
through EvalBackend with a host argmax a step. Both allocate the
decoder caches in the graph's declared type, where the reference's
referee zeroes f32 caches for every model type and relies on the feed
cast. Beams go through Seq2SeqInterface with the start sequence and the
`mel` feed.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..backends.eval_backend import EvalBackend
from ..device import resolve_device
from ..dtype import to_torch
from ..model import Model
from ..super_graph.links import AudioClip
from ..utils.audio import log_mel_spectrogram, resample
from .text import TextInferenceInterface

CHECK_EVERY = 16     # decode steps between reads of the validity


class SpeechToTextInterface:
    def __init__(self, encoder: Model, decoder_step: Model,
                 tokenizer=None, max_len: Optional[int] = None,
                 n_mels: int = 80, n_frames: int = 3000,
                 sot_sequence: Optional[List[int]] = None,
                 eot_token: int = 50257, device=None):
        self.device = resolve_device(device)
        self.encoder = encoder
        self.decoder = decoder_step
        self.tokenizer = tokenizer
        # default: the KV-cache length baked into the decoder graph
        # (declared shape of the cache_k_0 input)
        if max_len is None:
            max_len = 448
            g = decoder_step.graph
            if "cache_k_0" in g.by_name:
                d = g.tensors[g.by_name["cache_k_0"]].info.dims()[2]
                if d.is_known:
                    max_len = int(d.value())
        self.max_len = max_len
        self.n_mels = n_mels
        self.n_frames = n_frames
        # the template may carry None slots (HF forced_decoder_ids null =
        # auto-detect language); the runnable sequence resolves them
        self.sot_template = list(sot_sequence or [50258])
        self.eot_token = eot_token
        self.cache_dtype = decoder_step.cache_dtype()
        self.sot_sequence = self._resolve_sot(self.sot_template)
        self._backends: Dict[int, EvalBackend] = {}
        self._dec: Optional[TextInferenceInterface] = None
        self._s2s = None

    # ------------------------------------------------------------------
    def _try_token(self, text: str) -> Optional[int]:
        inner = getattr(self.tokenizer, "_tok", None)
        if inner is not None and hasattr(inner, "token_to_id"):
            t = inner.token_to_id(text)
            return None if t is None else int(t)
        return None

    def _resolve_sot(self, seq) -> List[int]:
        """Fill a template's None slots (position 1 = language: default
        <|en|> when the tokenizer knows it) and drop the unresolvable
        rest."""
        out = []
        for i, t in enumerate(seq):
            if t is None and i == 1:
                t = self._try_token("<|en|>")
            if t is None:
                continue
            out.append(int(t))
        return out

    def sot_with(self, language: Optional[str] = None,
                 task: Optional[str] = None) -> List[int]:
        """The forced SOT prefix with `<|language|>` / `<|task|>`
        substituted at whisper's template positions 1 / 2 (looked up in
        the tokenizer; multilingual checkpoints); auto-detect (None)
        slots keep their position. Raises ValueError for tokens the
        tokenizer does not know."""
        seq = list(self.sot_template)
        if language is None and task is None:
            return list(self.sot_sequence)

        def tid(text):
            t = self._try_token(text)
            if t is None:
                raise ValueError(
                    f"token {text!r} not in this model's tokenizer "
                    "(not a multilingual whisper checkpoint?)")
            return t

        for pos, text in ((1, f"<|{language}|>" if language else None),
                          (2, f"<|{task}|>" if task else None)):
            if text is None:
                continue
            t = tid(text)
            if len(seq) > pos:
                seq[pos] = t
            elif len(seq) == pos:
                seq.append(t)
            else:
                raise ValueError(
                    f"this checkpoint's SOT prefix {seq} is too short "
                    f"to carry a {'language' if pos == 1 else 'task'} "
                    "token")
        return self._resolve_sot(seq)

    def mel_from_samples(self, samples: np.ndarray) -> np.ndarray:
        mel = log_mel_spectrogram(np.asarray(samples, np.float32).reshape(-1),
                                  16000, n_mels=self.n_mels,
                                  pad_to_frames=self.n_frames)
        return mel[None]

    def mel_from_audio(self, clip: AudioClip) -> np.ndarray:
        samples = np.asarray(clip.samples, dtype=np.float32).reshape(-1)
        if clip.sample_rate != 16000:
            samples = resample(samples, clip.sample_rate, 16000)
        return self.mel_from_samples(samples)

    # ------------------------------------------------------------------
    def _backend(self, model: Model) -> EvalBackend:
        be = self._backends.get(model.id)
        if be is None:
            be = self._backends[model.id] = EvalBackend("torch",
                                                        device=self.device)
        return be

    def encode(self, mel: np.ndarray) -> Dict[str, torch.Tensor]:
        """(1, n_mels, n_frames) mel -> the encoder's outputs on the
        device."""
        return self._backend(self.encoder).run_on_device(
            self.encoder.graph, {"mel": np.asarray(mel, np.float32)})

    @property
    def dec(self) -> TextInferenceInterface:
        """The fused, pair-written decoder step and its device weights."""
        if self._dec is None:
            self._dec = TextInferenceInterface(
                self.decoder, self.max_len, cache_dtype=self.cache_dtype,
                device=self.device)
        return self._dec

    def _transcribe_compiled(self, mel: np.ndarray,
                             max_new: int) -> List[int]:
        """Greedy decode as one device loop (the reference's scan body,
        step for step); returns the tokens before the end of the
        transcript."""
        dec, dev = self.dec, self.device
        enc = self.encode(mel)
        cross_in = [n for n in dec.milli.inputs if n.startswith("cross_")]
        crosses = [enc[n] for n in cross_in]
        caches = dec.fresh_cache(1)

        def step(ids, pos):
            feeds = dec._feeds(ids, pos, caches)
            feeds.update(zip(cross_in, crosses))
            return dec._exec(feeds)["logits"]

        P = len(self.sot_sequence)
        sot = torch.tensor([self.sot_sequence], dtype=torch.int64,
                           device=dev)
        lg = step(sot, torch.zeros((), dtype=torch.int64, device=dev))
        cur = torch.argmax(lg[0, P - 1], dim=-1)
        pos = torch.full((), P, dtype=torch.int64, device=dev)
        alive = torch.ones((), dtype=torch.bool, device=dev)
        toks, valids = [], []
        for i in range(max_new):
            valid = alive & (cur != self.eot_token)
            lg = step(cur.view(1, 1), pos)
            nxt = torch.argmax(lg[0, -1], dim=-1)
            toks.append(cur)
            valids.append(valid)
            cur = torch.where(valid, nxt, cur)
            pos = torch.where(valid & (pos < self.max_len - 1), pos + 1, pos)
            alive = valid
            if (i + 1) % CHECK_EVERY == 0 and not bool(alive):
                break
        if not toks:
            return []
        toks = torch.stack(toks).cpu().numpy()
        valids = torch.stack(valids).cpu().numpy()
        out: List[int] = []
        for t, v in zip(toks, valids):
            if not v:
                break
            out.append(int(t))
        return out

    def _transcribe_mel(self, mel: np.ndarray, max_new: int) -> List[int]:
        """The plain referee: the unfused decoder graph a step, the
        argmax on the host."""
        enc = self.encode(mel)
        be = self._backend(self.decoder)
        g = self.decoder.graph
        n_layers = sum(1 for k in enc if k.startswith("cross_k_"))
        feeds: Dict[str, torch.Tensor] = {}
        for i in range(n_layers):
            ck = enc[f"cross_k_{i}"]
            feeds[f"cross_k_{i}"] = ck
            feeds[f"cross_v_{i}"] = enc[f"cross_v_{i}"]
            for c in ("k", "v"):
                info = g.tensors[g.by_name[f"cache_{c}_{i}"]].info
                feeds[f"cache_{c}_{i}"] = torch.zeros(
                    (1, ck.shape[1], self.max_len, ck.shape[3]),
                    dtype=to_torch(info.dtype), device=self.device)

        def run(ids, pos):
            out = be.run_on_device(g, {
                **feeds, "input_ids": torch.tensor(ids, dtype=torch.int64,
                                                   device=self.device),
                "pos": torch.tensor(pos, dtype=torch.int64,
                                    device=self.device)})
            for i in range(n_layers):
                for c in ("k", "v"):
                    feeds[f"cache_{c}_{i}"] = out[f"new_cache_{c}_{i}"]
            return out["logits"]

        sot = [list(self.sot_sequence)]
        cur = int(torch.argmax(run(sot, 0)[0, len(sot[0]) - 1]))
        pos = len(sot[0])
        tokens: List[int] = []
        for _ in range(max_new):
            if cur == self.eot_token:
                break
            tokens.append(cur)
            cur = int(torch.argmax(run([[cur]], pos)[0, -1]))
            pos += 1
        return tokens

    # ------------------------------------------------------------------
    def transcribe_long(self, clip: AudioClip, max_new_per_chunk: int = 224,
                        compiled: bool = True) -> List[int]:
        """Long-form transcription: audio beyond one mel window (30 s at
        the Whisper defaults) is split into window-sized segments, each
        transcribed independently, tokens concatenated (sequential
        segmentation, whisper.cpp's 'greedy chunking')."""
        samples = np.asarray(clip.samples, dtype=np.float32).reshape(-1)
        if clip.sample_rate != 16000:
            samples = resample(samples, clip.sample_rate, 16000)
        chunk_samples = self.n_frames * 160
        out: List[int] = []
        for off in range(0, max(len(samples), 1), chunk_samples):
            seg = samples[off:off + chunk_samples]
            if seg.size == 0:
                break
            mel = self.mel_from_samples(seg)
            if compiled:
                out.extend(self._transcribe_compiled(mel, max_new_per_chunk))
            else:
                out.extend(self._transcribe_mel(mel, max_new_per_chunk))
        return out

    def transcribe_beam(self, clip: AudioClip, max_new: int = 64,
                        beam: int = 4,
                        length_penalty: float = 0.0) -> List[int]:
        """Beam-search transcription through Seq2SeqInterface: the
        forced start sequence as one prefill, then the per-step
        re-score, top-k and cache reorder on the device."""
        from .seq2seq import Seq2SeqInterface

        if self._s2s is None or \
                self._s2s.start_sequence != list(self.sot_sequence):
            self._s2s = Seq2SeqInterface(
                self.encoder, self.decoder, max_len=self.max_len,
                start_sequence=self.sot_sequence, eos_token=self.eot_token,
                cache_dtype=self.cache_dtype, encoder_feed="mel",
                device=self.device, dec=self.dec)
            self._s2s._enc_backend = self._backend(self.encoder)
        toks = self._s2s.beam_search_tokens(
            self.mel_from_audio(clip), max_new, beam=beam,
            length_penalty=length_penalty)[0]
        out: List[int] = []
        for t in toks:
            if int(t) == self.eot_token:
                break
            out.append(int(t))
        return out

    def transcribe_tokens(self, clip: AudioClip, max_new: int = 64,
                          compiled: bool = False) -> List[int]:
        mel = self.mel_from_audio(clip)
        if compiled:
            return self._transcribe_compiled(mel, max_new)
        return self._transcribe_mel(mel, max_new)

    def run_audio_in_text_out(self, clip: AudioClip,
                              max_new: int = 64) -> str:
        """User-facing transcription: the device loop, with audio longer
        than one mel window split into sequential windows."""
        if self.tokenizer is None:
            raise ValueError("no tokenizer configured")
        n16 = int(round(len(np.asarray(clip.samples).reshape(-1))
                        * 16000.0 / max(clip.sample_rate, 1)))
        if n16 > self.n_frames * 160:
            toks = self.transcribe_long(clip, max_new_per_chunk=max_new)
        else:
            toks = self._transcribe_compiled(self.mel_from_audio(clip),
                                             max_new)
        return self.tokenizer.decode(toks)

    @classmethod
    def from_bundle(cls, bundle, tokenizer=None,
                    device=None) -> "SpeechToTextInterface":
        """Build from a transformers-loader whisper bundle."""
        spec = bundle.interfaces["stt"]
        tok = tokenizer
        if tok is None and bundle.tokenizer_source:
            from ..tokenizer import AnyTokenizer

            tok = AnyTokenizer.load(bundle.tokenizer_source)
        return cls(bundle.models[spec["encoder"]],
                   bundle.models[spec["decoder"]], tokenizer=tok,
                   max_len=spec.get("max_len"), n_mels=spec.get("n_mels", 80),
                   n_frames=spec.get("n_frames", 3000),
                   sot_sequence=(list(spec.get("sot_sequence") or [])
                                 or [spec.get("sot", 50258)]),
                   eot_token=spec.get("eot", 50257), device=device)


class StreamingTranscriber:
    """Online transcription over a SpeechToTextInterface, the reference's
    (:356-459).

    Feed audio incrementally with `feed()`; committed tokens come back
    as they stabilize. The active window is re-transcribed per feed.

    Commit policy:
      * `local_agreement=N` (default 2): the longest common token
        prefix of the last N consecutive hypotheses is committed early
        (the whisper-streaming LocalAgreement policy). Early commits
        are kept even if a later full-window hypothesis disagrees.
      * `local_agreement=None`: conservative mode; commits happen only
        when a full mel window closes (and at `flush()`), so the final
        committed token stream is exactly `transcribe_long`'s output
        for the same audio, however the feeds were chunked.

    When the buffer reaches one mel window (n_frames*160 samples at
    16 kHz) the window is finalized: its full-window hypothesis beyond
    the already-committed count is committed and the audio dropped.
    """

    def __init__(self, iface: SpeechToTextInterface,
                 local_agreement: Optional[int] = 2,
                 max_new_per_window: int = 224):
        if local_agreement is not None and local_agreement < 2:
            raise ValueError("local_agreement must be >= 2 (or None)")
        self.iface = iface
        self.agreement = local_agreement
        self.max_new = max_new_per_window
        self._buf = np.zeros(0, np.float32)
        self._hyps: List[List[int]] = []   # recent active-window hyps
        self._win_committed = 0            # committed within the window
        self.committed: List[int] = []

    @property
    def _window(self) -> int:
        return self.iface.n_frames * 160

    def _transcribe(self, samples: np.ndarray) -> List[int]:
        mel = self.iface.mel_from_samples(samples)
        return self.iface._transcribe_compiled(mel, self.max_new)

    def _close_full_windows(self) -> List[int]:
        new: List[int] = []
        W = self._window
        while len(self._buf) >= W:
            toks = self._transcribe(self._buf[:W])
            new.extend(toks[self._win_committed:])
            self._buf = self._buf[W:]
            self._win_committed = 0
            self._hyps = []
        return new

    def feed(self, samples, sample_rate: int = 16000) -> List[int]:
        """Append audio; return the newly committed token ids."""
        samples = np.asarray(samples, dtype=np.float32).reshape(-1)
        if sample_rate != 16000:
            samples = resample(samples, sample_rate, 16000)
        self._buf = np.concatenate([self._buf, samples])
        new = self._close_full_windows()
        if len(self._buf) and self.agreement is not None:
            toks = self._transcribe(self._buf)
            self._hyps.append(toks)
            self._hyps = self._hyps[-self.agreement:]
            if len(self._hyps) == self.agreement:
                k = 0
                while all(len(h) > k and h[k] == self._hyps[-1][k]
                          for h in self._hyps):
                    k += 1
                if k > self._win_committed:
                    new.extend(self._hyps[-1][self._win_committed:k])
                    self._win_committed = k
        self.committed.extend(new)
        return new

    @property
    def pending(self) -> List[int]:
        """Uncommitted tail of the latest active-window hypothesis."""
        if not self._hyps:
            return []
        return list(self._hyps[-1][self._win_committed:])

    def flush(self) -> List[int]:
        """End of stream: transcribe and commit everything buffered."""
        new = self._close_full_windows()
        if len(self._buf):
            toks = self._transcribe(self._buf)
            new.extend(toks[self._win_committed:])
        self._buf = np.zeros(0, np.float32)
        self._hyps = []
        self._win_committed = 0
        self.committed.extend(new)
        return new

    def text(self, toks: Optional[List[int]] = None) -> str:
        if self.iface.tokenizer is None:
            raise ValueError("no tokenizer configured")
        return self.iface.tokenizer.decode(
            self.committed if toks is None else toks)
