"""Synthesize speech from text on the PyTorch port.

The port's counterpart of examples/tts_speak.py: the same flags, sizes
and output, on the card unless --cpu asks for the CPU.

Reference equivalent: examples/piper_tts.rs / kokoro examples. Modes:
  * real voice:  python examples/torch_port/tts_speak.py \
                   --model /path/to/en_US-voice.onnx \
                   --text "hello from the tpu" --out hello.wav
    (piper .onnx+.json voices, kokoro dirs, F5 via --ref-audio)
  * --smoke: a tiny random piper-shaped voice is synthesized on the fly
    (no downloads) and spoken through the full phonemize -> VITS path.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def _smoke_voice(tmpdir: str) -> str:
    """Author a tiny piper-layout voice (random weights) on disk."""
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.importers.onnx_builder import OnnxBuilder

    rng = np.random.default_rng(0)
    b = OnnxBuilder("piper_tiny", opset=23)
    b.input("input", DType.I64, [1, "seq"])
    b.input("input_lengths", DType.I64, [1])
    b.input("scales", DType.F32, [3])
    emb = b.const((rng.standard_normal((256, 8)) * 0.3).astype(np.float32))
    h = b.gather(emb, "input")                       # (1, S, 8)
    w = b.const((rng.standard_normal((8, 160)) * 0.3).astype(np.float32))
    wave = b.node("Tanh", [b.matmul(h, w)])
    out = b.node("Reshape", [wave, b.const(np.asarray([1, 1, -1], np.int64))],
                 outputs=["output"])
    b.output("output", DType.F32, [1, 1, "samples"])
    path = os.path.join(tmpdir, "en_US-smoke-low.onnx")
    with open(path, "wb") as f:
        f.write(b.build())
    cfg = {"audio": {"sample_rate": 16000},
           "espeak": {"voice": "en-us"},
           "phoneme_id_map": {c: [i + 10] for i, c in enumerate(
               "abcdefghijklmnopqrstuvwxyz @")},
           "num_symbols": 256}
    with open(path + ".json", "w") as f:
        json.dump(cfg, f)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", help="piper voice .onnx / kokoro dir / F5 dir")
    ap.add_argument("--text", default="hello from the tensor processor")
    ap.add_argument("--voice", default=None, help="voice name (kokoro)")
    ap.add_argument("--ref-audio", default=None, help="F5 voice prompt .wav")
    ap.add_argument("--out", default="out.wav")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from whisper_tensor_tpu_torch.device import resolve_device
    from whisper_tensor_tpu_torch.importers.loaders import identify_and_load
    from whisper_tensor_tpu_torch.interfaces.tts import TextToSpeechInterface
    from whisper_tensor_tpu_torch.utils.audio import write_wav

    device = resolve_device("cpu" if args.cpu else None)
    print(f"device: {device}")

    model = args.model
    if args.smoke:
        import tempfile

        model = _smoke_voice(tempfile.mkdtemp(prefix="wt_tts_"))
    if not model:
        raise SystemExit("need --model (or --smoke)")
    bundle = identify_and_load(model)
    iface = TextToSpeechInterface.from_bundle(bundle, device=device)
    voice = 0
    if args.voice and getattr(iface, "voice_names", None):
        voice = iface.voice_names.index(args.voice)
    clip = iface.run_text_to_audio(args.text, voice=voice)
    write_wav(args.out, clip.samples, clip.sample_rate)
    result = {"output": args.out, "samples": int(len(clip.samples)),
              "sample_rate": clip.sample_rate,
              "seconds": round(len(clip.samples) / clip.sample_rate, 3)}
    print(json.dumps(result))
    return {"device": str(device), **result,
            "audio": np.asarray(clip.samples)}


if __name__ == "__main__":
    main()
