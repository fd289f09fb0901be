"""Generate an image with a Stable Diffusion pipeline on the PyTorch port.

The port's counterpart of examples/sd_image.py: the same flags, sizes
and output, on the card unless --cpu asks for the CPU. Its smoke text
encoder takes seeded numpy weights through the port's CLIP recipe, where
the JAX example draws them from transformers' CLIPTextModel.

Reference equivalent: examples/{stable_diffusion,sdxl}.rs. Two modes:
  * real checkpoint:  python examples/torch_port/sd_image.py \\
        --model /path/to/diffusers_dir --prompt "a watercolor fox" \\
        --steps 20 --out fox.ppm
    (any diffusers layout the loader understands: SD1.5/SD2/SDXL/SD3/Flux,
    or a single-file LDM .safetensors)
  * --smoke: random-weight SD1.5-shaped pipeline at 128x128 — exercises
    the full text-encoder -> CFG UNet loop -> VAE path with no downloads.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def save_ppm(path: str, pixels: np.ndarray) -> None:
    """Write (H, W, 3) u8 as a PPM (stdlib-only; PNG would need pillow)."""
    h, w, _ = pixels.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(pixels, dtype=np.uint8).tobytes())


def _clip_weights(cfg, seed: int = 0):
    """Seeded HF CLIPTextModel weights by name, drawn as its initializer
    draws them: matrices and embeddings N(0, 0.02), LayerNorm weights 1,
    biases 0."""
    E, F = cfg.hidden_size, cfg.intermediate_size
    tp = "text_model."
    shapes = {tp + "embeddings.token_embedding.weight": (cfg.vocab_size, E),
              tp + "embeddings.position_embedding.weight":
                  (cfg.max_position_embeddings, E),
              tp + "final_layer_norm.weight": (E,),
              tp + "final_layer_norm.bias": (E,)}
    for i in range(cfg.num_hidden_layers):
        p = f"{tp}encoder.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[p + f"self_attn.{n}.weight"] = (E, E)
            shapes[p + f"self_attn.{n}.bias"] = (E,)
        for n in ("layer_norm1", "layer_norm2"):
            shapes[p + n + ".weight"] = shapes[p + n + ".bias"] = (E,)
        shapes.update({p + "mlp.fc1.weight": (F, E), p + "mlp.fc1.bias": (F,),
                       p + "mlp.fc2.weight": (E, F),
                       p + "mlp.fc2.bias": (E,)})
    rng = np.random.default_rng(seed)
    sd = {}
    for n, s in shapes.items():
        if len(s) > 1:
            sd[n] = (rng.standard_normal(s) * 0.02).astype(np.float32)
        else:
            sd[n] = np.full(s, float("norm" in n and n.endswith("weight")),
                            np.float32)
    return sd


def _smoke_interface(device):
    """Random-weight SD1.5-shaped pipeline (tiny CLIP/UNet/VAE), same
    graphs and interface the loader produces for real checkpoints."""
    from whisper_tensor_tpu_torch.importers.recipes.diffusion.clip import (
        ClipTextConfig, build_clip_text)
    from whisper_tensor_tpu_torch.importers.recipes.diffusion.unet import (
        UNetConfig, build_sd_unet, random_unet_weights)
    from whisper_tensor_tpu_torch.importers.recipes.diffusion.vae import (
        VAEConfig, build_vae_decoder)
    from whisper_tensor_tpu_torch.interfaces.image_gen import \
        ImageGenerationInterface
    from whisper_tensor_tpu_torch.model import Model

    ccfg = ClipTextConfig(num_hidden_layers=2, hidden_size=64,
                          num_attention_heads=4, intermediate_size=128,
                          vocab_size=1000)
    sd = _clip_weights(ccfg)
    te = Model.new_from_onnx(build_clip_text(lambda n: sd[n], ccfg),
                             name="te")
    ucfg = UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                      cross_attention_dim=64, attention_head_dim=4,
                      norm_groups=8)
    unet = Model.new_from_onnx(
        build_sd_unet(random_unet_weights(), ucfg, batch=2,
                      latent_hw=(16, 16)), name="unet")
    vae = Model.new_from_onnx(build_vae_decoder(
        random_unet_weights(1),
        VAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                  norm_groups=4), latent_hw=(16, 16)), name="vae")
    return ImageGenerationInterface(te, unet, vae, tokenizer=None,
                                    bos_token_id=1, uncond_token_id=2,
                                    device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", help="diffusers dir or LDM single file")
    ap.add_argument("--prompt", default="a watercolor fox in the snow")
    ap.add_argument("--negative", default="")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--cfg", type=float, default=7.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="out.ppm")
    ap.add_argument("--smoke", action="store_true",
                    help="random-weight SD1.5 at 128x128 (no checkpoint)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from whisper_tensor_tpu_torch.device import resolve_device
    from whisper_tensor_tpu_torch.interfaces.image_gen import ImageGenConfig

    device = resolve_device("cpu" if args.cpu else None)
    print(f"device: {device}")
    t0 = time.time()
    if args.smoke:
        iface = _smoke_interface(device)
        cfg = ImageGenConfig(steps=min(args.steps, 4),
                             guidance_scale=args.cfg, height=128, width=128,
                             seed=args.seed)
    else:
        if not args.model:
            raise SystemExit("need --model <dir> (or --smoke)")
        from whisper_tensor_tpu_torch.importers.loaders import \
            identify_and_load
        from whisper_tensor_tpu_torch.interfaces.image_gen import \
            image_interface_from_bundle

        bundle = identify_and_load(args.model)
        iface = image_interface_from_bundle(bundle, device=device)
        cfg = ImageGenConfig(steps=args.steps, guidance_scale=args.cfg,
                             seed=args.seed)
    print(f"pipeline ready in {time.time() - t0:.1f}s")

    class Progress:
        def on_progress(self, node, f):
            print(f"\r  denoising {f * 100:5.1f}%", end="", flush=True)

    t1 = time.time()
    img = iface.run(args.prompt, negative_prompt=args.negative, cfg=cfg,
                    observer=Progress())
    print(f"\ngenerated in {time.time() - t1:.1f}s "
          f"({cfg.steps} steps, {img.pixels.shape[1]}x{img.pixels.shape[0]})")
    save_ppm(args.out, img.pixels)
    print(f"wrote {args.out}")
    return {"device": str(device), "out": args.out, "pixels": img.pixels}


if __name__ == "__main__":
    main()
