"""Original LDM / CompVis single-file checkpoint support (SD1.x-family
"model.diffusion_model.*" naming).

Reference equivalent: crates/whisper-tensor-import/src/models/diffusion/
sd15.rs / sd2.rs / sd_xl.rs — the reference builds its graphs directly
against the LDM names and probes tensor shapes to detect the variant.
Here the recipes speak diffusers names, so this module provides
on-demand name translation (diffusers -> LDM) plus shape-probing config
detection; the same recipes then consume LDM checkpoints unchanged.

Mapping follows the canonical LDM<->diffusers correspondence used by
the public conversion tooling (resnet in_layers/out_layers split,
input/middle/output block indexing, VAE attention conv<->linear).

The port's copy of whisper_tensor_tpu/importers/ldm.py.
"""

from __future__ import annotations

import re
from typing import Callable, Tuple

import numpy as np

from .recipes.llm import transposed

UNET_PREFIX = "model.diffusion_model."
VAE_PREFIX = "first_stage_model."
CLIP_PREFIX = "cond_stage_model.transformer."

_RESNET = {"norm1": "in_layers.0", "conv1": "in_layers.2",
           "time_emb_proj": "emb_layers.1", "norm2": "out_layers.0",
           "conv2": "out_layers.3", "conv_shortcut": "skip_connection"}


def _map_resnet(rest: str) -> str:
    head, _, tail = rest.partition(".")
    return f"{_RESNET[head]}.{tail}"


def unet_diffusers_to_ldm(name: str, layers_per_block: int,
                          down_has_attn: Tuple[bool, ...]) -> str:
    """Translate one diffusers UNet2DConditionModel weight name to its
    LDM key (without the model.diffusion_model. prefix)."""
    lpb = layers_per_block
    n_blocks = len(down_has_attn)
    if name.startswith("time_embedding.linear_1."):
        return name.replace("time_embedding.linear_1.", "time_embed.0.")
    if name.startswith("time_embedding.linear_2."):
        return name.replace("time_embedding.linear_2.", "time_embed.2.")
    if name.startswith("add_embedding.linear_1."):        # SDXL text_time
        return name.replace("add_embedding.linear_1.", "label_emb.0.0.")
    if name.startswith("add_embedding.linear_2."):
        return name.replace("add_embedding.linear_2.", "label_emb.0.2.")
    if name.startswith("conv_in."):
        return name.replace("conv_in.", "input_blocks.0.0.")
    if name.startswith("conv_norm_out."):
        return name.replace("conv_norm_out.", "out.0.")
    if name.startswith("conv_out."):
        return name.replace("conv_out.", "out.2.")

    m = re.match(r"down_blocks\.(\d+)\.resnets\.(\d+)\.(.+)", name)
    if m:
        i, j, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        return f"input_blocks.{1 + i * (lpb + 1) + j}.0.{_map_resnet(rest)}"
    m = re.match(r"down_blocks\.(\d+)\.attentions\.(\d+)\.(.+)", name)
    if m:
        i, j, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        return f"input_blocks.{1 + i * (lpb + 1) + j}.1.{rest}"
    m = re.match(r"down_blocks\.(\d+)\.downsamplers\.0\.conv\.(.+)", name)
    if m:
        i, rest = int(m.group(1)), m.group(2)
        return f"input_blocks.{(i + 1) * (lpb + 1)}.0.op.{rest}"

    if name.startswith("mid_block.resnets.0."):
        return ("middle_block.0."
                + _map_resnet(name[len("mid_block.resnets.0."):]))
    if name.startswith("mid_block.attentions.0."):
        return "middle_block.1." + name[len("mid_block.attentions.0."):]
    if name.startswith("mid_block.resnets.1."):
        return ("middle_block.2."
                + _map_resnet(name[len("mid_block.resnets.1."):]))

    m = re.match(r"up_blocks\.(\d+)\.resnets\.(\d+)\.(.+)", name)
    if m:
        i, j, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        return f"output_blocks.{i * (lpb + 1) + j}.0.{_map_resnet(rest)}"
    m = re.match(r"up_blocks\.(\d+)\.attentions\.(\d+)\.(.+)", name)
    if m:
        i, j, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        return f"output_blocks.{i * (lpb + 1) + j}.1.{rest}"
    m = re.match(r"up_blocks\.(\d+)\.upsamplers\.0\.conv\.(.+)", name)
    if m:
        i, rest = int(m.group(1)), m.group(2)
        idx = i * (lpb + 1) + lpb
        # module position depends on whether this up block has attention
        mod = 2 if down_has_attn[n_blocks - 1 - i] else 1
        return f"output_blocks.{idx}.{mod}.conv.{rest}"
    raise KeyError(f"no LDM mapping for unet weight {name!r}")


_VAE_ATTN = {"group_norm": "norm", "to_q": "q", "to_k": "k", "to_v": "v",
             "to_out.0": "proj_out"}


def vae_decoder_diffusers_to_ldm(name: str, n_blocks: int = 4) -> str:
    """Translate diffusers AutoencoderKL decoder names to LDM keys
    (without the first_stage_model. prefix). LDM up-block indices run
    low-res->high-res reversed relative to diffusers."""
    if name.startswith("post_quant_conv."):
        return name
    if name.startswith("decoder.conv_in.") or name.startswith("decoder.conv_out."):
        return name
    if name.startswith("decoder.conv_norm_out."):
        return name.replace("decoder.conv_norm_out.", "decoder.norm_out.")
    if name.startswith("decoder.mid_block.resnets.0."):
        return ("decoder.mid.block_1."
                + name[len("decoder.mid_block.resnets.0."):]
                .replace("conv_shortcut", "nin_shortcut"))
    if name.startswith("decoder.mid_block.resnets.1."):
        return ("decoder.mid.block_2."
                + name[len("decoder.mid_block.resnets.1."):]
                .replace("conv_shortcut", "nin_shortcut"))
    m = re.match(r"decoder\.mid_block\.attentions\.0\.(.+)\.(weight|bias)",
                 name)
    if m:
        return f"decoder.mid.attn_1.{_VAE_ATTN[m.group(1)]}.{m.group(2)}"
    m = re.match(r"decoder\.up_blocks\.(\d+)\.resnets\.(\d+)\.(.+)", name)
    if m:
        i, j, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        return (f"decoder.up.{n_blocks - 1 - i}.block.{j}."
                + rest.replace("conv_shortcut", "nin_shortcut"))
    m = re.match(r"decoder\.up_blocks\.(\d+)\.upsamplers\.0\.conv\.(.+)",
                 name)
    if m:
        i, rest = int(m.group(1)), m.group(2)
        return f"decoder.up.{n_blocks - 1 - i}.upsample.conv.{rest}"
    raise KeyError(f"no LDM mapping for vae weight {name!r}")


def vae_encoder_diffusers_to_ldm(name: str) -> str:
    """Translate diffusers AutoencoderKL ENCODER names to LDM keys
    (without the first_stage_model. prefix). LDM encoder down-block
    indices run in the same order as diffusers."""
    if name.startswith("quant_conv."):
        return name
    if name.startswith("encoder.conv_in.") or \
            name.startswith("encoder.conv_out."):
        return name
    if name.startswith("encoder.conv_norm_out."):
        return name.replace("encoder.conv_norm_out.", "encoder.norm_out.")
    if name.startswith("encoder.mid_block.resnets.0."):
        return ("encoder.mid.block_1."
                + name[len("encoder.mid_block.resnets.0."):]
                .replace("conv_shortcut", "nin_shortcut"))
    if name.startswith("encoder.mid_block.resnets.1."):
        return ("encoder.mid.block_2."
                + name[len("encoder.mid_block.resnets.1."):]
                .replace("conv_shortcut", "nin_shortcut"))
    m = re.match(r"encoder\.mid_block\.attentions\.0\.(.+)\.(weight|bias)",
                 name)
    if m:
        return f"encoder.mid.attn_1.{_VAE_ATTN[m.group(1)]}.{m.group(2)}"
    m = re.match(r"encoder\.down_blocks\.(\d+)\.resnets\.(\d+)\.(.+)", name)
    if m:
        i, j, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        return (f"encoder.down.{i}.block.{j}."
                + rest.replace("conv_shortcut", "nin_shortcut"))
    m = re.match(r"encoder\.down_blocks\.(\d+)\.downsamplers\.0\.conv\.(.+)",
                 name)
    if m:
        return f"encoder.down.{m.group(1)}.downsample.conv.{m.group(2)}"
    raise KeyError(f"no LDM mapping for vae encoder weight {name!r}")


def detect_unet_config(has_key: Callable[[str], bool],
                       shape_of: Callable[[str], Tuple[int, ...]]):
    """Shape-probe an LDM UNet (reference sd15.rs:70-95 reads the same
    anchor tensors). Returns a recipes.diffusion.unet.UNetConfig."""
    from .recipes.diffusion.unet import UNetConfig

    conv_in = shape_of("input_blocks.0.0.weight")
    model_ch, in_ch = conv_in[0], conv_in[1]
    # first attention block may not be in the first down block (SDXL)
    ctx = None
    for i in range(1, 13):
        key = f"input_blocks.{i}.1.transformer_blocks.0.attn2.to_k.weight"
        if has_key(key):
            ctx = shape_of(key)[1]
            break
    if ctx is None:
        raise ValueError("no cross-attention blocks found in UNet")
    # layers_per_block: resnet entries before the first downsampler
    lpb = 0
    idx = 1
    while has_key(f"input_blocks.{idx}.0.in_layers.2.weight"):
        lpb += 1
        idx += 1
    # block channels + attention flags
    chans, has_attn = [], []
    i = 0
    while True:
        first = 1 + i * (lpb + 1)
        key = f"input_blocks.{first}.0.out_layers.3.weight"
        if not has_key(key):
            break
        chans.append(shape_of(key)[0])
        has_attn.append(has_key(f"input_blocks.{first}.1.proj_in.weight"))
        i += 1
    sdxl = has_key("label_emb.0.0.weight")
    tf_layers = []
    for bi in range(len(chans)):
        first = 1 + bi * (lpb + 1)
        n = 0
        while has_key(f"input_blocks.{first}.1.transformer_blocks.{n}"
                      f".attn1.to_q.weight"):
            n += 1
        tf_layers.append(n)
    # heads: SD1.x uses 8 fixed heads; SD2/SDXL use 64-wide heads
    head_dim = 64 if (ctx >= 1024 or sdxl) else None
    groups = next(g for g in (32, 16, 8, 4, 2, 1)
                  if all(c % g == 0 for c in chans))
    cfg = UNetConfig(
        in_channels=in_ch, out_channels=in_ch,
        block_out_channels=tuple(chans), layers_per_block=lpb,
        norm_groups=groups,
        cross_attention_dim=ctx,
        attention_head_dim=8, head_dim=head_dim,
        down_has_attn=tuple(has_attn),
        transformer_layers_per_block=tuple(max(t, 0) for t in tf_layers),
        addition_embed=sdxl,
        projection_class_embeddings_input_dim=(
            shape_of("label_emb.0.0.weight")[1] if sdxl else 2816),
        time_embed_dim=shape_of("time_embed.0.weight")[0])
    return cfg


class LdmWeights:
    """Getter adapters over a raw LDM state-dict-like store."""

    def __init__(self, load: Callable[[str], np.ndarray],
                 has: Callable[[str], bool]):
        self.load = load
        self.has = has

    def unet_getter(self, cfg):
        def get(name, shape=None):
            return self.load(UNET_PREFIX + unet_diffusers_to_ldm(
                name, cfg.layers_per_block, cfg.down_has_attn))
        return get

    def vae_getter(self, n_blocks: int = 4):
        def get(name, shape=None):
            arr = self.load(VAE_PREFIX
                            + vae_decoder_diffusers_to_ldm(name, n_blocks))
            # LDM VAE attention q/k/v/proj_out are 1x1 convs; the
            # diffusers layout (and our recipe) uses linear weights
            if ("attentions" in name and name.endswith(".weight")
                    and arr.ndim == 4):
                arr = arr[:, :, 0, 0]
            return arr
        return get

    def vae_encoder_getter(self):
        def get(name, shape=None):
            arr = self.load(VAE_PREFIX + vae_encoder_diffusers_to_ldm(name))
            if ("attentions" in name and name.endswith(".weight")
                    and arr.ndim == 4):
                arr = arr[:, :, 0, 0]
            return arr
        return get

    def clip_getter(self, prefix: str = CLIP_PREFIX):
        def get(name):
            return self.load(prefix + name)
        return get


# ---------------------------------------------------------------------------
# open_clip text towers (SD2 cond_stage_model.model.*, SDXL
# conditioner.embedders.1.model.*): HF CLIPTextModel name translation.
# Reference equivalent: sd2.rs / sd_xl.rs conditioner handling.
# ---------------------------------------------------------------------------

_OPENCLIP_TOP = {
    "text_model.embeddings.token_embedding.weight": "token_embedding.weight",
    "text_model.embeddings.position_embedding.weight": "positional_embedding",
    "text_model.final_layer_norm.weight": "ln_final.weight",
    "text_model.final_layer_norm.bias": "ln_final.bias",
}
_OPENCLIP_LEAF = {
    "self_attn.out_proj.weight": "attn.out_proj.weight",
    "self_attn.out_proj.bias": "attn.out_proj.bias",
    "layer_norm1.weight": "ln_1.weight", "layer_norm1.bias": "ln_1.bias",
    "layer_norm2.weight": "ln_2.weight", "layer_norm2.bias": "ln_2.bias",
    "mlp.fc1.weight": "mlp.c_fc.weight", "mlp.fc1.bias": "mlp.c_fc.bias",
    "mlp.fc2.weight": "mlp.c_proj.weight", "mlp.fc2.bias": "mlp.c_proj.bias",
}


def openclip_getter(load: Callable[[str], np.ndarray], prefix: str):
    """Weight getter speaking HF CLIPTextModel names over an open_clip
    state dict at `prefix` (e.g. 'cond_stage_model.model.' or
    'conditioner.embedders.1.model.'). Handles the fused in_proj qkv,
    ln_1/ln_2/c_fc/c_proj renames, and the transposed text_projection."""

    def get(name: str) -> np.ndarray:
        if name in _OPENCLIP_TOP:
            return load(prefix + _OPENCLIP_TOP[name])
        if name in ("text_projection", "text_projection.weight"):
            # open_clip stores (width, proj) used as x @ W; HF Linear
            # weight is (proj, width)
            return transposed(load(prefix + "text_projection"))
        m = re.match(r"text_model\.encoder\.layers\.(\d+)\.(.+)", name)
        if m:
            i, leaf = int(m.group(1)), m.group(2)
            blk = f"transformer.resblocks.{i}."
            if leaf in _OPENCLIP_LEAF:
                return load(prefix + blk + _OPENCLIP_LEAF[leaf])
            qkv = re.match(r"self_attn\.([qkv])_proj\.(weight|bias)", leaf)
            if qkv:
                fused = load(prefix + blk + "attn.in_proj_" + qkv.group(2))
                E = fused.shape[0] // 3
                part = {"q": 0, "k": 1, "v": 2}[qkv.group(1)]
                return fused[part * E:(part + 1) * E]
        raise KeyError(f"no open_clip mapping for {name!r}")

    return get


def detect_openclip_config(load, has, prefix: str, drop_last: bool = False):
    """Shape-probe an open_clip text tower -> ClipTextConfig. drop_last
    builds only L-1 blocks so last_hidden_state == SD2's 'penultimate'
    conditioning (ln_final applied after stopping one block early)."""
    from .recipes.diffusion.clip import ClipTextConfig

    tok = load(prefix + "token_embedding.weight")
    n = 0
    while has(prefix + f"transformer.resblocks.{n}.ln_1.weight"):
        n += 1
    E = tok.shape[1]
    return ClipTextConfig(
        num_hidden_layers=n - 1 if drop_last else n,
        hidden_size=E, num_attention_heads=max(E // 64, 1),
        intermediate_size=load(
            prefix + "transformer.resblocks.0.mlp.c_fc.weight").shape[0],
        vocab_size=tok.shape[0],
        max_position_embeddings=load(prefix + "positional_embedding").shape[0],
        hidden_act="gelu",
        projection_dim=(load(prefix + "text_projection").shape[1]
                        if has(prefix + "text_projection") else None))
