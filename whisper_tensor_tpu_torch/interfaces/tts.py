"""Text-to-speech interface on PyTorch.

Counterpart of whisper_tensor_tpu/interfaces/tts.py (reference
TextToSpeechInterface, src/interfaces.rs:2824; TTSInputConfig :2790
with Piper/Kokoro/F5 variants; Kokoro voice embeddings :2703). The
model contract per engine:

  piper : tokens (1,T) i64, input_lengths (1,), scales (3,) -> audio
  kokoro: tokens (1,T), voice embedding (1,E) [per-length style row],
          speed () -> audio
  f5    : text tokens + reference audio tensor -> audio (flow matching)

Text preprocessing runs on the host through the port's copy of
phonemization.py and the per-engine id maps (the code the super graph's
phoneme nodes run); each model runs on the device through
EvalBackend.run_on_device, its graph lowered and its weights uploaded
once, and only the samples come back. `mode="oracle"` (the reference's
`mode`, whose "xla" is "torch" here) runs each model in the numpy
interpreter instead, its outputs on the CPU.

F5's ODE: the reference fuses the 32 Euler steps into one jitted scan
(:154-204) and falls back to a per-step host loop when that program
fails (:217-240), a workaround of its XLA path that is not carried over.
Here the loop runs on the device, the latents staying there between the
steps, and a failure raises. `F5Synthesizer.ode_plain` is the per-step
referee: each step's latents cross the host, as in the reference's
fallback loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..backends.eval_backend import EvalBackend, mode_device
from ..model import Model
from ..phonemization import kokoro_phoneme_ids, phonemize, piper_phoneme_ids
from ..super_graph.links import AudioClip

# the preprocess outputs the F5 transformer reads at every step
F5_FIXED = ("cat_mel_text", "cat_mel_text_drop", "qk_rotated_empty",
            "rope_cos", "rope_sin")


@dataclass
class TTSInputConfig:
    """Which engine + its preprocessing metadata (reference :2790)."""

    engine: str = "piper"                 # piper | kokoro | f5
    language: str = "en-us"
    sample_rate: int = 22050
    phoneme_id_map: Optional[Dict[str, list]] = None   # piper
    vocab: Optional[Dict[str, int]] = None             # kokoro
    voice_embeddings: Optional[np.ndarray] = None      # kokoro (styles, len, E)
    noise_scale: float = 0.667
    length_scale: float = 1.0
    noise_w: float = 0.8
    speed: float = 1.0


class TextToSpeechInterface:
    def __init__(self, model: Model, config: TTSInputConfig,
                 mode: str = "torch", device=None):
        self.device = mode_device(mode, device)
        self.model = model
        self.config = config
        self.voice_names: list = []
        self._backend = EvalBackend(mode, device=self.device)

    @classmethod
    def from_bundle(cls, bundle, mode: str = "torch", device=None):
        """Build from a loader bundle (importers.loaders piper/kokoro/f5).
        Returns an F5Synthesizer for the f5 engine (3-model pipeline)."""
        spec = bundle.interfaces["tts"]
        if spec["engine"] == "f5":
            return F5Synthesizer(
                bundle.models[spec["preprocess"]],
                bundle.models[spec["transformer"]],
                bundle.models[spec["decode"]],
                vocab=spec["vocab"], nfe_steps=spec.get("nfe_steps", 32),
                sample_rate=spec.get("sample_rate", 24000), mode=mode,
                device=device)
        cfg = TTSInputConfig(
            engine=spec["engine"],
            language=spec.get("language", "en-us"),
            sample_rate=spec.get("sample_rate", 22050),
            phoneme_id_map=spec.get("phoneme_id_map"),
            vocab=spec.get("vocab"),
            noise_scale=spec.get("noise_scale", 0.667),
            length_scale=spec.get("length_scale", 1.0),
            noise_w=spec.get("noise_w", 0.8))
        iface = cls(bundle.models[spec["model"]], cfg, mode=mode,
                    device=device)
        ve = bundle.meta.get("voice_embeddings")
        if ve:
            iface.voice_names = sorted(ve)
            cfg.voice_embeddings = np.stack([ve[n] for n in iface.voice_names])
        return iface

    def feeds(self, text: str, voice: int = 0) -> Dict[str, np.ndarray]:
        """The model's host feeds for `text` (phonemes and ids)."""
        cfg = self.config
        if cfg.engine == "f5":
            vocab = cfg.vocab or {}
            return {"tokens": np.asarray([[vocab.get(c, 0) for c in text]],
                                         dtype=np.int64)}
        phonemes = phonemize(text, cfg.language)
        if cfg.engine == "piper":
            ids = piper_phoneme_ids(phonemes, cfg.phoneme_id_map)
            return {"input": np.asarray(ids, dtype=np.int64)[None],
                    "input_lengths": np.asarray([len(ids)], dtype=np.int64),
                    "scales": np.asarray([cfg.noise_scale, cfg.length_scale,
                                          cfg.noise_w], dtype=np.float32)}
        if cfg.engine != "kokoro":
            raise ValueError(cfg.engine)
        ids = kokoro_phoneme_ids(phonemes, cfg.vocab)
        feeds = {"tokens": np.asarray(ids, dtype=np.int64)[None],
                 "speed": np.asarray(cfg.speed, dtype=np.float32)}
        if cfg.voice_embeddings is not None:
            style = cfg.voice_embeddings[voice]
            row = style[min(len(ids) - 1, style.shape[0] - 1)]
            feeds["style"] = np.asarray(row, dtype=np.float32)[None]
        return feeds

    def run_text_to_audio(self, text: str, voice: int = 0) -> AudioClip:
        out = self._backend.run_on_device(self.model.graph,
                                          self.feeds(text, voice))
        key = "audio" if "audio" in out else "output"
        samples = out[key].float().reshape(-1).cpu().numpy()
        return AudioClip(samples, self.config.sample_rate)


class F5Synthesizer:
    """F5-TTS: 3-model ONNX pipeline + NFE-step ODE denoising loop.

    Reference equivalent: load_f5_tts / build_f5_supergraph /
    build_f5_denoising_loop (crates/whisper-tensor-import/src/models/
    speech/f5_tts.rs:23-380). Per step the transformer predicts the
    denoised signal and the Euler update is
    noise <- (1 - dt) * noise + dt * denoised with dt = 1/NFE.
    """

    def __init__(self, preprocess: Model, transformer: Model, decode: Model,
                 vocab: Dict[str, int], nfe_steps: int = 32,
                 sample_rate: int = 24000, mode: str = "torch",
                 device=None):
        self.device = mode_device(mode, device)
        self.mode = mode
        self.preprocess = preprocess
        self.transformer = transformer
        self.decode = decode
        self.vocab = vocab
        self.nfe_steps = nfe_steps
        self.sample_rate = sample_rate
        self._backends: Dict[int, EvalBackend] = {}

    def _backend(self, model: Model) -> EvalBackend:
        be = self._backends.get(model.id)
        if be is None:
            be = self._backends[model.id] = EvalBackend(self.mode,
                                                        device=self.device)
        return be

    def _run(self, model: Model, feeds) -> Dict[str, torch.Tensor]:
        return self._backend(model).run_on_device(model.graph, feeds)

    def text_ids(self, text: str) -> np.ndarray:
        return np.asarray([[self.vocab.get(c, 0) for c in text]],
                          dtype=np.int32)

    def ode(self, pre: Dict[str, torch.Tensor],
            observer=None) -> torch.Tensor:
        """The Euler loop on the device from the preprocess outputs."""
        noise = pre["noise"].float()
        fixed = {n: pre[n] for n in F5_FIXED}
        dt = 1.0 / self.nfe_steps
        for i in range(self.nfe_steps):
            den = self._run(self.transformer, {
                **fixed, "noise": noise,
                "time_step": torch.tensor(i, dtype=torch.int32,
                                          device=self.device)})["denoised"]
            noise = (1.0 - dt) * noise + dt * den.float()
            if observer is not None:
                observer.on_progress(self, (i + 1) / self.nfe_steps)
        return noise

    def ode_plain(self, pre: Dict[str, torch.Tensor]) -> np.ndarray:
        """The per-step referee: each step's feeds and latents cross the
        host (the reference's step loop, :221-240)."""
        host = {n: pre[n].cpu().numpy() for n in F5_FIXED}
        noise = pre["noise"].float().cpu().numpy()
        dt = 1.0 / self.nfe_steps
        for i in range(self.nfe_steps):
            den = self._backend(self.transformer).run(
                self.transformer.graph,
                {**host, "noise": noise,
                 "time_step": np.asarray(i, dtype=np.int32)})["denoised"]
            noise = (1.0 - dt) * noise + dt * np.asarray(den, np.float32)
        return noise

    def prepare(self, text: str, ref_audio: AudioClip,
                max_duration: int = 0) -> Dict[str, torch.Tensor]:
        """The preprocess stage's outputs on the device."""
        if ref_audio is None:
            raise ValueError("F5 needs a reference AudioClip (voice prompt)")
        audio = np.asarray(ref_audio.samples, dtype=np.float32).reshape(1, 1, -1)
        return self._run(self.preprocess, {
            "audio": audio, "text_ids": self.text_ids(text),
            "max_duration": np.asarray(max_duration, dtype=np.int64)})

    def run_text_to_audio(self, text: str, ref_audio: AudioClip = None,
                          max_duration: int = 0, observer=None) -> AudioClip:
        pre = self.prepare(text, ref_audio, max_duration)
        noise = self.ode(pre, observer)
        dec = self._run(self.decode, {"denoised": noise,
                                      "ref_signal_len": pre["ref_signal_len"]})
        samples = dec["output_audio"].float().reshape(-1).cpu().numpy()
        return AudioClip(samples, self.sample_rate)
