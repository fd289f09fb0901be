"""The synthetic TTS sets the port's tests and chip_smoke.py run: a piper
voice, a kokoro directory and an F5-TTS directory, each honouring its
engine's real I/O contract at a tiny size.

The port's copies of the builders of tests/test_tts_loaders.py
(`_tiny_piper_onnx`, `_write_piper_voice`, `_tiny_kokoro_onnx`,
`_write_kokoro_dir`, `_write_f5_dir`), over the port's OnnxBuilder: they
write the same bytes (tests/test_torch_port_tts.py holds them to it), and
import nothing of the JAX package, so that chip_smoke.py runs them on
the card.
"""

import json
import os

import numpy as np

from whisper_tensor_tpu_torch.dtype import DType
from whisper_tensor_tpu_torch.importers.onnx_builder import OnnxBuilder


def tiny_piper_onnx() -> bytes:
    """Piper I/O contract: input (1,T) i64, input_lengths (1,) i64,
    scales (3,) f32 -> output (1,1,samples)."""
    rng = np.random.default_rng(0)
    b = OnnxBuilder("piper_tiny", opset=23)
    ids = b.input("input", DType.I64, [1, "T"])
    lens = b.input("input_lengths", DType.I64, [1])
    scales = b.input("scales", DType.F32, [3])
    emb = b.gather(b.initializer(
        "emb", rng.standard_normal((64, 8)).astype(np.float32)), ids)
    ls = b.slice_(scales, [1], [2], axes=[0])              # length_scale
    emb = b.mul(emb, b.node("Unsqueeze", [ls, b.const_i64([0])]))
    lf = b.node("Cast", [lens], to=1)
    emb = b.mul(emb, b.reshape(b.node("Div", [lf, b.node("Max", [lf])]),
                               [1, 1, 1]))
    up = b.matmul(emb, b.initializer(
        "up", (rng.standard_normal((8, 50)) / 8).astype(np.float32)))
    audio = b.node("Tanh", [b.reshape(up, [1, 1, -1])], outputs=["output"])
    b.output("output", DType.F32, [1, 1, "samples"])
    return b.build()


def write_piper_voice(d, name="en_US-test-low"):
    onnx_path = os.path.join(d, f"{name}.onnx")
    with open(onnx_path, "wb") as f:
        f.write(tiny_piper_onnx())
    pmap = {" ": [3], "a": [4], "b": [5], "t": [6], "p": [7], "u": [8],
            "^": [1], "$": [2], "_": [0]}
    with open(onnx_path + ".json", "w") as f:
        json.dump({"audio": {"sample_rate": 22050},
                   "num_speakers": 1,
                   "espeak": {"voice": "en-us"},
                   "inference": {"noise_scale": 0.5, "length_scale": 1.5,
                                 "noise_w": 0.7},
                   "phoneme_id_map": pmap}, f)
    return onnx_path


def tiny_kokoro_onnx() -> bytes:
    """Kokoro contract: tokens (1,T) i64, style (1,256) f32, speed () f32
    -> audio (samples,)."""
    rng = np.random.default_rng(1)
    b = OnnxBuilder("kokoro_tiny", opset=23)
    ids = b.input("tokens", DType.I64, [1, "T"])
    style = b.input("style", DType.F32, [1, 256])
    speed = b.input("speed", DType.F32, [])
    emb = b.gather(b.initializer(
        "emb", rng.standard_normal((64, 16)).astype(np.float32)), ids)
    sproj = b.matmul(style, b.initializer(
        "sp", (rng.standard_normal((256, 16)) / 16).astype(np.float32)))
    h = b.mul(b.add(emb, b.node("Unsqueeze", [sproj, b.const_i64([0])])),
              speed)
    up = b.matmul(h, b.initializer(
        "up", (rng.standard_normal((16, 40)) / 16).astype(np.float32)))
    b.node("Tanh", [b.reshape(up, [-1])], outputs=["audio"])
    b.output("audio", DType.F32, ["samples"])
    return b.build()


def write_kokoro_dir(d):
    os.makedirs(os.path.join(d, "onnx"))
    os.makedirs(os.path.join(d, "voices"))
    with open(os.path.join(d, "onnx", "model_q8.onnx"), "wb") as f:
        f.write(tiny_kokoro_onnx())
    vocab = {c: i for i, c in enumerate("_^$ abtpu")}
    with open(os.path.join(d, "tokenizer.json"), "w") as f:
        json.dump({"model": {"vocab": vocab}}, f)
    rng = np.random.default_rng(2)
    for name in ("af_bella", "am_adam"):
        rng.standard_normal((510, 256)).astype("<f4").tofile(
            os.path.join(d, "voices", f"{name}.bin"))
    return d


def write_f5_dir(d):
    """Synthetic 3-stage F5 set honoring the real I/O contract:
    preprocess(audio, text_ids, max_duration) -> 7 tensors;
    transformer(noise, rope_*, cat_*, qk_rotated_empty, time_step) ->
    denoised; decode(denoised, ref_signal_len) -> output_audio."""
    rng = np.random.default_rng(7)
    T, MEL = 12, 6    # frames, mel bins

    b = OnnxBuilder("F5_Preprocess", opset=23)
    audio = b.input("audio", DType.F32, [1, 1, "samples"])
    ids = b.input("text_ids", DType.I32, [1, "L"])
    b.input("max_duration", DType.I64, [])
    emb = b.gather(b.initializer(
        "emb", rng.standard_normal((64, MEL)).astype(np.float32)),
        b.node("Cast", [ids], to=7))
    mean_emb = b.node("ReduceMean", [emb, b.const_i64([1])], keepdims=1)
    base = b.node("Expand", [mean_emb, b.const_i64([1, T, MEL])])
    amp = b.node("ReduceMean", [b.node("Abs", [audio]),
                                b.const_i64([2])], keepdims=0)   # (1,1)
    cat = b.add(base, b.node("Unsqueeze", [amp, b.const_i64([2])]))
    b.node("Identity", [cat], outputs=["cat_mel_text"])
    b.node("Mul", [cat, b.const(np.asarray(0.5, np.float32))],
           outputs=["cat_mel_text_drop"])
    b.node("Identity", [b.const(
        rng.standard_normal((1, T, MEL)).astype(np.float32))],
        outputs=["noise"])
    b.node("Identity", [b.const(np.cos(
        np.arange(T * 4, dtype=np.float32)).reshape(1, T, 4))],
        outputs=["rope_cos"])
    b.node("Identity", [b.const(np.sin(
        np.arange(T * 4, dtype=np.float32)).reshape(1, T, 4))],
        outputs=["rope_sin"])
    b.node("Identity", [b.const(np.zeros((1, T, 4), np.float32))],
           outputs=["qk_rotated_empty"])
    b.node("Identity", [b.const(np.asarray(T // 2, np.int64))],
           outputs=["ref_signal_len"])
    for name, shp, dt in [("cat_mel_text", [1, T, MEL], DType.F32),
                          ("cat_mel_text_drop", [1, T, MEL], DType.F32),
                          ("noise", [1, T, MEL], DType.F32),
                          ("rope_cos", [1, T, 4], DType.F32),
                          ("rope_sin", [1, T, 4], DType.F32),
                          ("qk_rotated_empty", [1, T, 4], DType.F32),
                          ("ref_signal_len", [], DType.I64)]:
        b.output(name, dt, shp)
    pre = b.build()

    b2 = OnnxBuilder("F5_Transformer", opset=23)
    noise = b2.input("noise", DType.F32, [1, T, MEL])
    b2.input("rope_cos", DType.F32, [1, T, 4])
    b2.input("rope_sin", DType.F32, [1, T, 4])
    cat = b2.input("cat_mel_text", DType.F32, [1, T, MEL])
    b2.input("cat_mel_text_drop", DType.F32, [1, T, MEL])
    b2.input("qk_rotated_empty", DType.F32, [1, T, 4])
    tstep = b2.input("time_step", DType.I32, [])
    tf = b2.node("Cast", [tstep], to=1)
    # pull noise toward a target derived from the conditioning + step
    target = b2.mul(cat, b2.add(b2.mul(tf, b2.const(
        np.asarray(0.01, np.float32))), b2.const(np.asarray(1.0, np.float32))))
    b2.node("Identity", [b2.add(b2.mul(noise, b2.const(
        np.asarray(0.2, np.float32))), target)], outputs=["denoised"])
    b2.output("denoised", DType.F32, [1, T, MEL])
    trans = b2.build()

    b3 = OnnxBuilder("F5_Decode", opset=23)
    den = b3.input("denoised", DType.F32, [1, T, MEL])
    b3.input("ref_signal_len", DType.I64, [])
    up = b3.matmul(den, b3.initializer(
        "voc", (rng.standard_normal((MEL, 25)) / MEL).astype(np.float32)))
    b3.node("Tanh", [b3.reshape(up, [1, -1])], outputs=["output_audio"])
    b3.output("output_audio", DType.F32, [1, "samples"])
    dec = b3.build()

    for name, data in [("F5_Preprocess.onnx", pre),
                       ("F5_Transformer.onnx", trans),
                       ("F5_Decode.onnx", dec)]:
        with open(os.path.join(d, name), "wb") as f:
            f.write(data)
    with open(os.path.join(d, "vocab.txt"), "w") as f:
        f.write("\n".join(list("_ abtpuhelow")) + "\n")
    return d
