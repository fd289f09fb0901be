"""Multimodal chat on the PyTorch port: image + text through the true
inputs_embeds path.

The port's counterpart of examples/llava_chat.py: the same flags, sizes
and output, on the card unless --cpu asks for the CPU. Its smoke model
is written from seeded numpy weights (a checkpoint directory in the
classic LLaVA layout, at the JAX smoke's widths), where the JAX example
draws them from transformers' LlavaForConditionalGeneration. A
checkpoint that ships no tokenizer reads and writes text with the byte
tokenizer, and a bf16 model keeps a bf16 cache, as the port's server
does (the JAX example keeps the interface's default f32 cache).

Reference equivalent: the MultimodalLanguageInterface flows
(src/interfaces.rs:166-327). Modes:
  * real model:  python examples/torch_port/llava_chat.py \\
                   --model /path/to/llava_dir --image photo.ppm \\
                   --text "What is in this picture?"
  * --smoke: a tiny random LLaVA (CLIP-ViT tower + llama LM + projector)
    runs an image+text prompt end to end — no downloads.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

SMOKE_CONFIG = {
    "model_type": "llava", "vision_feature_layer": -2,
    "image_token_index": 32000,
    "vision_config": dict(model_type="clip_vision_model",
                          num_hidden_layers=2, hidden_size=32,
                          num_attention_heads=2, intermediate_size=64,
                          image_size=16, patch_size=8,
                          hidden_act="quick_gelu"),
    "text_config": dict(model_type="llama", num_hidden_layers=2,
                        hidden_size=24, num_attention_heads=2,
                        num_key_value_heads=2, intermediate_size=48,
                        vocab_size=300, max_position_embeddings=64)}


def read_ppm(path: str) -> np.ndarray:
    """Minimal P6 PPM reader -> (H, W, 3) u8."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"P6":
            raise ValueError(f"{path}: not a P6 PPM")
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = map(int, line.split())
        if int(f.readline()) != 255:
            raise ValueError(f"{path}: not an 8-bit PPM")
        return np.frombuffer(f.read(w * h * 3), np.uint8).reshape(h, w, 3)


def llava_shapes(c: dict) -> dict:
    """The weights of a LLaVA checkpoint in the classic layout
    (language_model.*, vision_tower.*, multi_modal_projector.*)."""
    t, v = c["text_config"], c["vision_config"]
    E, I, V = t["hidden_size"], t["intermediate_size"], t["vocab_size"]
    kv = E // t["num_attention_heads"] * t["num_key_value_heads"]
    s = {"language_model.model.embed_tokens.weight": (V, E),
         "language_model.model.norm.weight": (E,),
         "language_model.lm_head.weight": (V, E)}
    for i in range(t["num_hidden_layers"]):
        p = f"language_model.model.layers.{i}."
        s.update({p + "input_layernorm.weight": (E,),
                  p + "post_attention_layernorm.weight": (E,),
                  p + "self_attn.q_proj.weight": (E, E),
                  p + "self_attn.k_proj.weight": (kv, E),
                  p + "self_attn.v_proj.weight": (kv, E),
                  p + "self_attn.o_proj.weight": (E, E),
                  p + "mlp.gate_proj.weight": (I, E),
                  p + "mlp.up_proj.weight": (I, E),
                  p + "mlp.down_proj.weight": (E, I)})
    VE, VF, P = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    vp = "vision_tower.vision_model."
    s.update({vp + "embeddings.class_embedding": (VE,),
              vp + "embeddings.patch_embedding.weight": (VE, 3, P, P),
              vp + "embeddings.position_embedding.weight":
                  ((v["image_size"] // P) ** 2 + 1, VE),
              vp + "pre_layrnorm.weight": (VE,),
              vp + "pre_layrnorm.bias": (VE,),
              vp + "post_layernorm.weight": (VE,),
              vp + "post_layernorm.bias": (VE,)})
    for i in range(v["num_hidden_layers"]):
        p = f"{vp}encoder.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            s[p + f"self_attn.{n}.weight"] = (VE, VE)
            s[p + f"self_attn.{n}.bias"] = (VE,)
        for n in ("layer_norm1", "layer_norm2"):
            s[p + n + ".weight"] = s[p + n + ".bias"] = (VE,)
        s.update({p + "mlp.fc1.weight": (VF, VE), p + "mlp.fc1.bias": (VF,),
                  p + "mlp.fc2.weight": (VE, VF), p + "mlp.fc2.bias": (VE,)})
    mp = "multi_modal_projector."
    s.update({mp + "linear_1.weight": (E, VE), mp + "linear_1.bias": (E,),
              mp + "linear_2.weight": (E, E), mp + "linear_2.bias": (E,)})
    return s


def write_smoke_checkpoint(d: str, seed: int = 0) -> None:
    """SMOKE_CONFIG's checkpoint in `d`: seeded N(0, 0.02) matrices and
    embeddings, norm weights 1, biases 0 (transformers' initializer)."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(seed)
    tensors = {}
    for n, s in llava_shapes(SMOKE_CONFIG).items():
        if len(s) > 1 or n.endswith("class_embedding"):
            tensors[n] = (rng.standard_normal(s) * 0.02).astype(np.float32)
        else:
            tensors[n] = np.full(s, float(n.endswith(".weight")), np.float32)
    save_file(tensors, os.path.join(d, "model.safetensors"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(SMOKE_CONFIG, f)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", help="LLaVA checkpoint dir")
    ap.add_argument("--image", help="P6 .ppm image")
    ap.add_argument("--text", default="Describe the image.")
    ap.add_argument("--max-tokens", type=int, default=48)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from whisper_tensor_tpu_torch.device import resolve_device
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.importers.loaders import loader_registry
    from whisper_tensor_tpu_torch.interfaces.multimodal import \
        MultimodalLanguageInterface
    from whisper_tensor_tpu_torch.interfaces.text import \
        TextInferenceInterface
    from whisper_tensor_tpu_torch.super_graph.links import (Image,
                                                            MultimodalItem)
    from whisper_tensor_tpu_torch.tokenizer import AnyTokenizer

    device = resolve_device("cpu" if args.cpu else None)
    print(f"device: {device}")
    if args.smoke:
        import tempfile

        model_dir = tempfile.mkdtemp(prefix="wt_llava_")
        write_smoke_checkpoint(model_dir)
        pixels = np.random.default_rng(0).integers(
            0, 255, (16, 16, 3)).astype(np.uint8)
    else:
        if not (args.model and args.image):
            raise SystemExit("need --model and --image (or --smoke)")
        model_dir = args.model
        pixels = read_ppm(args.image)

    max_len = 64 if args.smoke else 1024
    bundle = loader_registry()["transformers"].load(
        {"path": model_dir, "dtype": "f32" if args.smoke else "bf16",
         "max_len": max_len})
    spec = bundle.interfaces["multimodal"]
    text_model = bundle.models[spec["model"]]
    vis_model = bundle.models[spec["vision"]]
    tok = AnyTokenizer.load(bundle.tokenizer_source or "bytes")

    # the cache in the model's type, as the port's server keeps it: a
    # bf16 cache is what the attention kernels take
    iface = TextInferenceInterface(
        text_model, max_len=max_len, tokenizer=tok, device=device,
        cache_dtype=DType.F32 if args.smoke else DType.BF16)
    mm = MultimodalLanguageInterface(iface,
                                     embed_weight_name=spec["embed_weight"],
                                     vision_encoder=vis_model)
    out = mm.run_items_in_string_out(
        [MultimodalItem(image=Image(pixels)),
         MultimodalItem(text=args.text)], n_new=args.max_tokens)
    print(json.dumps({"response": out}))
    return {"device": str(device), "response": out}


if __name__ == "__main__":
    main()
