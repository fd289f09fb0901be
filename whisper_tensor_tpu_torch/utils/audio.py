"""Audio utilities: resampling + whisper-style log-mel spectrogram.

Reference equivalent: the AudioClipToMelSpectrogram node internals
(src/super_graph/nodes.rs) and audio handling in the STT pipeline.

The port's copy of whisper_tensor_tpu/utils/audio.py: the resampler
and the mel front end the super graph's audio nodes and the speech
interfaces run, and the stdlib WAV codec of the audio routes and
`cli stt|tts`.
"""

from __future__ import annotations

import functools

import numpy as np


def resample(samples: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Linear-interpolation resampler (sufficient for speech frontends)."""
    if sr_in == sr_out:
        return samples
    n_out = int(round(len(samples) * sr_out / sr_in))
    x_out = np.arange(n_out, dtype=np.float64) * (sr_in / sr_out)
    return np.interp(x_out, np.arange(len(samples)), samples).astype(np.float32)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Slaney-style mel filterbank (matches librosa/whisper defaults)."""
    fmin, fmax = 0.0, sr / 2.0

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        # slaney: linear below 1 kHz, log above
        f_sp = 200.0 / 3
        mel = f / f_sp
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                        mel)

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        f_sp = 200.0 / 3
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        return np.where(m >= min_log_mel,
                        min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        f_sp * m)

    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    freqs = mel_to_hz(mels)
    fft_freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    fb = np.zeros((n_mels, len(fft_freqs)))
    for i in range(n_mels):
        lower = (fft_freqs - freqs[i]) / (freqs[i + 1] - freqs[i])
        upper = (freqs[i + 2] - fft_freqs) / (freqs[i + 2] - freqs[i + 1])
        fb[i] = np.maximum(0, np.minimum(lower, upper))
    # slaney normalization
    enorm = 2.0 / (freqs[2:n_mels + 2] - freqs[:n_mels])
    fb *= enorm[:, None]
    return fb.astype(np.float32)


def log_mel_spectrogram(samples: np.ndarray, sr: int = 16000, n_mels: int = 80,
                        n_fft: int = 400, hop: int = 160,
                        pad_to_frames=None) -> np.ndarray:
    """Whisper-style log-mel: reflect-padded STFT, mel projection,
    log10 clamped to max-8, scaled to ~[-1, 1]. Returns (n_mels, frames)."""
    x = np.asarray(samples, dtype=np.float32)
    if pad_to_frames is not None:
        want = int(pad_to_frames) * hop
        if len(x) < want:
            x = np.pad(x, (0, want - len(x)))
        else:
            x = x[:want]
    window = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    pad = n_fft // 2
    xp = np.pad(x, (pad, pad), mode="reflect")
    n_frames = 1 + (len(xp) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = xp[idx] * window
    spec = np.fft.rfft(frames, axis=-1)
    power = (spec.real ** 2 + spec.imag ** 2)[:-1]  # whisper drops last frame
    mel = mel_filterbank(sr, n_fft, n_mels) @ power.T
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)


def wav_bytes(samples: np.ndarray, sample_rate: int) -> bytes:
    """Mono float samples in [-1, 1] -> 16-bit PCM WAV bytes (stdlib)."""
    import io
    import wave

    pcm = np.round(np.clip(np.asarray(samples, dtype=np.float32), -1.0, 1.0)
                   * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Write mono float samples in [-1, 1] as 16-bit PCM WAV (stdlib)."""
    with open(path, "wb") as f:
        f.write(wav_bytes(samples, sample_rate))


def read_wav_bytes(data: bytes):
    """WAV bytes -> (float32 mono samples in [-1, 1], sample_rate)."""
    import io

    return read_wav(io.BytesIO(data))


def read_wav(path):
    """Read a WAV file (path or file-like) to (float32 mono samples in
    [-1, 1], sample_rate)."""
    import wave

    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        ch = w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        s = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        s = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        s = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128) / 128
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if ch > 1:
        s = s.reshape(-1, ch).mean(axis=1)
    return s, sr
