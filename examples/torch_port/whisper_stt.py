"""Transcribe audio with a Whisper checkpoint on the PyTorch port.

The port's counterpart of examples/whisper_stt.py: the same flags, sizes
and output, on the card unless --cpu asks for the CPU. A checkpoint that
ships no tokenizer decodes with the byte tokenizer, as the port's server
does.

Reference equivalent: examples/whisper.rs. Modes:
  * real model:  python examples/torch_port/whisper_stt.py \
                   --model /path/to/whisper_dir --audio speech.wav
  * --smoke: a tiny random whisper-shaped model transcribes synthetic
    audio (no downloads) — exercises mel -> encoder -> cached greedy
    decode end to end.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", help="HF whisper checkpoint dir")
    ap.add_argument("--audio", help="input .wav (16 kHz mono best)")
    ap.add_argument("--max-tokens", type=int, default=64)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from whisper_tensor_tpu_torch.device import resolve_device
    from whisper_tensor_tpu_torch.interfaces.stt import SpeechToTextInterface
    from whisper_tensor_tpu_torch.super_graph.links import AudioClip
    from whisper_tensor_tpu_torch.tokenizer import AnyTokenizer

    device = resolve_device("cpu" if args.cpu else None)
    print(f"device: {device}")
    if args.smoke:
        from whisper_tensor_tpu_torch.importers.recipes.speech.whisper import (
            WhisperConfig, build_whisper_decoder_step, build_whisper_encoder)
        from whisper_tensor_tpu_torch.model import Model

        rng = np.random.default_rng(0)
        cfg = WhisperConfig(d_model=32, encoder_layers=1, decoder_layers=1,
                            encoder_attention_heads=2,
                            decoder_attention_heads=2,
                            encoder_ffn_dim=64, decoder_ffn_dim=64,
                            vocab_size=300, num_mel_bins=16,
                            max_source_positions=50,
                            max_target_positions=32)

        cache = {}

        def w(name):
            if name not in cache:
                cache[name] = (rng.standard_normal(
                    _whisper_shape(name, cfg)) * 0.05).astype(np.float32)
            return cache[name]

        enc = Model.new_from_onnx(build_whisper_encoder(w, cfg))
        dec = Model.new_from_onnx(build_whisper_decoder_step(w, cfg,
                                                             max_len=16))
        iface = SpeechToTextInterface(enc, dec, n_mels=cfg.num_mel_bins,
                                      n_frames=2 * cfg.max_source_positions,
                                      max_len=16, sot_sequence=[1],
                                      eot_token=2,
                                      tokenizer=AnyTokenizer.load("bytes"),
                                      device=device)
        samples = np.sin(np.linspace(0, 440 * 2 * np.pi, 16000)
                         ).astype(np.float32)
        clip = AudioClip(samples, 16000)
    else:
        if not (args.model and args.audio):
            raise SystemExit("need --model and --audio (or --smoke)")
        from whisper_tensor_tpu_torch.importers.loaders import \
            identify_and_load
        from whisper_tensor_tpu_torch.utils.audio import read_wav

        bundle = identify_and_load(args.model)
        iface = SpeechToTextInterface.from_bundle(
            bundle, tokenizer=(None if bundle.tokenizer_source
                               else AnyTokenizer.load("bytes")),
            device=device)
        samples, sr = read_wav(args.audio)
        clip = AudioClip(samples, sr)

    text = iface.run_audio_in_text_out(clip, max_new=args.max_tokens)
    print(json.dumps({"text": text}))
    return {"device": str(device), "text": text}


def _whisper_shape(name, cfg):
    """Shapes for random whisper weights by HF state-dict name."""
    D, F = cfg.d_model, cfg.encoder_ffn_dim
    M, V = cfg.num_mel_bins, cfg.vocab_size
    import re

    rules = [
        (r"conv1\.weight$", (D, M, 3)), (r"conv1\.bias$", (D,)),
        (r"conv2\.weight$", (D, D, 3)), (r"conv2\.bias$", (D,)),
        (r"embed_positions\.weight$",
         (max(cfg.max_source_positions, cfg.max_target_positions), D)),
        (r"embed_tokens\.weight$", (V, D)),
        (r"fc1\.weight$", (F, D)), (r"fc1\.bias$", (F,)),
        (r"fc2\.weight$", (D, F)), (r"fc2\.bias$", (D,)),
        (r"\.weight$", (D, D)), (r"\.bias$", (D,)),
    ]
    for pat, shape in rules:
        if re.search(pat, name):
            if "layer_norm" in name or "layernorm" in name:
                return (D,)
            return shape
    return (D,)


if __name__ == "__main__":
    main()
