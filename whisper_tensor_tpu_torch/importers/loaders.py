"""Loader registry, the transformers, GGUF and diffusers loaders,
identify_and_load.

The port's copy of whisper_tensor_tpu/importers/loaders.py, trimmed to
the `transformers` loader for GPT-2, llama-family, Gemma and Phi-3
checkpoints (config.json + safetensors), the `gguf` loader for
llama-family, Gemma and Phi-3 GGUF files (:525-652), the `diffusers`
loader (below) and the `auto` loader that probes for them. Their
config keys and their bundles' `text` interface spec are the
reference's: dtype, quantize (int8, or host quantization to q4_0, q8_0,
q5_0, q4_k or q6_k), max_len, ragged_decode, serve_batch, serve_chunk,
serve_chunk_max, serve_admit_coalesce_ms, prefill_chunk,
serve_auto_prefix, `lora` (a PEFT adapter merged into the weights at
load, importers/lora.py) and `serve_adapters` (name=dir adapters the
batcher selects per request), and for GGUF packed_weights (keep the
file's blocks packed on the device, default on); the end-of-sequence
ids come from the checkpoint (`_resolve_eos`) or the GGUF metadata.
Model types gemma, gemma2, gemma3_text (gemma3) and phi3 load as in the
reference (:261-276, :454-460), and so do GGUF archs gemma, gemma2 and
phi3, dequantized on the host; their recipes build one scalar position,
so `ragged_decode` raises for them (the reference accepts it and its
batcher fails at the first request: ROADMAP C18). The `diffusers`
loader builds the `sd` image pipeline (SD-1.5, SD-2.x; :785-948); its
sdxl, sd3 and flux kinds and the `ldm` single-file loader raise "not
ported". Left out, each raising: other model types and GGUF archs
(ValueError, as the reference does for an unknown one), `decode_windows`
(NotImplementedError), and the ONNX, RWKV and TTS loaders (not
registered). GPTQ/AWQ
checkpoints load (importers/quantized.py): their quantized Linears run
packed, unless a merged adapter densifies them as in the reference.

Like the reference, the loader embeds every weight in one in-memory
ONNX ModelProto, then decodes it into the graph's TensorStore: host
memory peaks at several times the checkpoint's size.
"""

from __future__ import annotations

import enum
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..dtype import DType
from ..model import Model


class ConfigFieldType(enum.Enum):
    FILE_PATH = "file_path"
    STRING = "string"
    INT = "int"
    FLOAT = "float"
    BOOL = "bool"
    ENUM = "enum"


@dataclass
class ConfigField:
    name: str
    type: ConfigFieldType
    description: str = ""
    default: Any = None
    required: bool = False
    choices: Optional[List[str]] = None
    min: Optional[float] = None
    max: Optional[float] = None

    def to_json(self):
        return {"name": self.name, "type": self.type.value,
                "description": self.description, "default": self.default,
                "required": self.required, "choices": self.choices,
                "min": self.min, "max": self.max}


@dataclass
class LoadedBundle:
    """What a loader produces: named models + interface descriptors."""

    models: Dict[str, Model]
    interfaces: Dict[str, Any] = field(default_factory=dict)
    tokenizer_source: Optional[str] = None
    meta: Dict[str, Any] = field(default_factory=dict)


class Loader:
    NAME = "?"
    DESCRIPTION = ""

    def config_schema(self) -> List[ConfigField]:
        return [ConfigField("path", ConfigFieldType.FILE_PATH,
                            "model file or directory", required=True)]

    def can_load(self, path: str) -> bool:
        return False

    def load(self, config: Dict[str, Any]) -> LoadedBundle:
        raise NotImplementedError


_LOADERS: Dict[str, Loader] = {}


def register_loader(cls):
    _LOADERS[cls.NAME] = cls()
    return cls


def loader_registry() -> Dict[str, Loader]:
    return dict(_LOADERS)


def _resolve_eos(d: str, hf_cfg: dict):
    """End-of-sequence token id(s) for a HF checkpoint dir:
    generation_config.json wins over config.json. Returns int, list of
    ints (Llama-3-style multi-eos), or None."""
    eos = None
    gp = os.path.join(d, "generation_config.json")
    if os.path.exists(gp):
        try:
            with open(gp, "r", encoding="utf-8") as f:
                eos = json.load(f).get("eos_token_id")
        except (OSError, ValueError):
            eos = None
    if eos is None:
        eos = hf_cfg.get("eos_token_id")
    return eos


_LLAMA_FAMILY = ("llama", "mistral", "mixtral", "qwen2", "qwen3",
                 "qwen3_moe")
# model types whose recipes take no pos_per_row: one scalar position
_SCALAR_POS = ("gemma", "gemma2", "gemma3_text", "gemma3", "phi3")


@register_loader
class TransformersLoader(Loader):
    NAME = "transformers"
    DESCRIPTION = "HF transformers checkpoint dir (config.json + safetensors)"
    SUPPORTED = ("gpt2",) + _LLAMA_FAMILY + _SCALAR_POS

    def config_schema(self):
        return super().config_schema() + [
            ConfigField("max_len", ConfigFieldType.INT, "KV cache slots",
                        default=1024, min=16),
            ConfigField("dtype", ConfigFieldType.ENUM, "compute dtype",
                        default="bf16", choices=["f32", "bf16", "f16"]),
            ConfigField("ragged_decode", ConfigFieldType.BOOL,
                        "per-row positions for continuous batching",
                        default=False),
            ConfigField("prefill_chunk", ConfigFieldType.INT,
                        "chunked-prefill piece width for the serving "
                        "batcher (0 = whole-bucket prefill)", default=0),
            ConfigField("serve_batch", ConfigFieldType.INT,
                        "serving batcher slot count (max_batch)",
                        default=8, min=1),
            ConfigField("serve_chunk", ConfigFieldType.INT,
                        "decode steps per batcher dispatch",
                        default=16, min=1),
            ConfigField("serve_chunk_max", ConfigFieldType.INT,
                        "adaptive long-chunk length for steady-state "
                        "decode (0 = off)", default=0),
            ConfigField("serve_admit_coalesce_ms", ConfigFieldType.INT,
                        "admission coalescing deadline (ms)", default=50),
            ConfigField("serve_auto_prefix", ConfigFieldType.INT,
                        "automatic prefix caching: LRU pool of N cached "
                        "KV rows (0 = off)", default=0),
            ConfigField("quantize", ConfigFieldType.ENUM,
                        "weight quantization for the text interface",
                        default="", choices=["", "int8", "q4_0", "q8_0",
                                             "q5_0", "q4_k", "q6_k"]),
            ConfigField("lora", ConfigFieldType.FILE_PATH,
                        "PEFT adapter dir (adapter_config.json + "
                        "adapter_model.safetensors) merged into the base "
                        "weights at load", default=""),
            ConfigField("serve_adapters", ConfigFieldType.STRING,
                        "multi-LoRA serving: name=peft_dir[,name2=dir2] "
                        "adapters selectable per request through the "
                        "batcher (needs ragged_decode)", default=""),
        ]

    def can_load(self, path: str) -> bool:
        return os.path.isdir(path) and os.path.exists(
            os.path.join(path, "config.json"))

    def load(self, config):
        from .quantized import QuantizedStore, parse_quantization_config
        from .safetensors_io import SafetensorsStore, load_hf_config

        if config.get("decode_windows"):
            raise NotImplementedError(
                "transformers loader option 'decode_windows' is not ported "
                "to PyTorch yet")
        d = config["path"]
        hf_cfg = load_hf_config(d)
        mt = hf_cfg.get("model_type")
        dtype = {"f32": DType.F32, "bf16": DType.BF16,
                 "f16": DType.F16}[config.get("dtype", "bf16")]
        max_len = int(config.get("max_len", 1024))
        store = SafetensorsStore.from_dir(d)
        # GPTQ/AWQ checkpoints (config.json quantization_config), as the
        # reference loads them (:204-213, :466-471): `.weight` names
        # dequantize on the host for the recipe, and each quantized
        # Linear the recipe reads as a matmul weight records a packed
        # source, so it runs through packed_matmul at 4 bits a weight.
        # GPT-2's Conv1D weights stay (in, out) (QuantizedStore `linear`)
        qspec = parse_quantization_config(hf_cfg)
        qstore = None
        if qspec is not None:
            store = qstore = QuantizedStore(store, qspec,
                                            linear=mt != "gpt2")
        if config.get("lora"):
            from .lora import LoraMergedStore

            store = LoraMergedStore(store, config["lora"])
            qstore = None   # merged deltas densify: no packed bypass
        weight_map: Dict[str, str] = {}   # initializer -> HF name
        ragged = bool(config.get("ragged_decode", False))
        if ragged and mt in _SCALAR_POS:
            # the reference builds these recipes' scalar-position graph
            # under ragged_decode too, and its batcher fails at the first
            # request (ROADMAP C18): refused here, at load
            raise ValueError(f"ragged_decode is not supported for "
                             f"model_type {mt!r}: its recipe builds a step "
                             f"graph with one position for every row")
        if mt == "gpt2":
            from .recipes.llm.gpt2 import GPT2Config, build_gpt2_step

            cfg = GPT2Config.from_hf(hf_cfg)
            data = build_gpt2_step(store.getter(), cfg,
                                   max_len=min(max_len, cfg.n_positions),
                                   dtype=dtype, pos_per_row=ragged,
                                   weight_map=weight_map)
            geometry = dict(n_layers=cfg.n_layer, n_kv_heads=cfg.n_head,
                            head_dim=cfg.n_embd // cfg.n_head)
        elif mt in _LLAMA_FAMILY:
            from .recipes.llm.llama import LlamaConfig, build_llama_step

            cfg = LlamaConfig.from_hf(hf_cfg)

            def getter(name):
                if name == "lm_head.weight" and name not in store:
                    return store.load("model.embed_tokens.weight")
                return store.load(name)

            data = build_llama_step(getter, cfg, max_len=max_len, dtype=dtype,
                                    pos_per_row=ragged, weight_map=weight_map)
            geometry = dict(n_layers=cfg.num_hidden_layers,
                            n_kv_heads=cfg.num_key_value_heads, head_dim=cfg.hd)
        elif mt in ("gemma", "gemma2"):
            from .recipes.llm.gemma import GemmaConfig, build_gemma_step

            cfg = GemmaConfig.from_hf(hf_cfg)
            data = build_gemma_step(store.getter(), cfg, max_len=max_len,
                                    dtype=dtype)
            geometry = dict(n_layers=cfg.num_hidden_layers,
                            n_kv_heads=cfg.num_key_value_heads, head_dim=cfg.hd)
        elif mt in ("gemma3_text", "gemma3"):
            from .recipes.llm.gemma3 import Gemma3Config, build_gemma3_step

            cfg = Gemma3Config.from_hf(hf_cfg)
            data = build_gemma3_step(store.getter(), cfg, max_len=max_len,
                                     dtype=dtype)
            geometry = dict(n_layers=cfg.num_hidden_layers,
                            n_kv_heads=cfg.num_key_value_heads,
                            head_dim=cfg.head_dim)
        elif mt == "phi3":
            from .recipes.llm.phi3 import Phi3Config, build_phi3_step

            cfg = Phi3Config.from_hf(hf_cfg)
            data = build_phi3_step(store.getter(), cfg, max_len=max_len,
                                   dtype=dtype)
            geometry = dict(n_layers=cfg.num_hidden_layers,
                            n_kv_heads=cfg.num_key_value_heads, head_dim=cfg.hd)
        else:
            raise ValueError(f"transformers model_type {mt!r} not supported "
                             f"by the port (have: {self.SUPPORTED})")
        name = hf_cfg.get("_name_or_path") or os.path.basename(os.path.normpath(d))
        model = Model.new_from_onnx(data, name=name)
        if qstore is not None:
            for init_name, hf_name in weight_map.items():
                src = qstore.packed_source(hf_name)
                if src is not None:
                    model.graph.store.packed_sources[init_name] = src
        tok = d if os.path.exists(os.path.join(d, "tokenizer.json")) else None
        # multi-LoRA serving: "name=/peft/dir,name2=/other", resolved
        # against the recipe's weight_map when the batcher is built
        serve_adapters = {}
        for part in str(config.get("serve_adapters", "") or "").split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    f"serve_adapters entry {part!r} is not name=path")
            aname, apath = part.split("=", 1)
            serve_adapters[aname.strip()] = apath.strip()
        if serve_adapters and not weight_map:
            raise ValueError(f"serve_adapters not supported for "
                             f"model_type {mt!r} (no weight map)")
        if serve_adapters and not ragged:
            raise ValueError("serve_adapters needs ragged_decode=1 "
                             "(adapters are served by the batcher)")
        return LoadedBundle(models={name: model},
                            interfaces={"text": {"model": name,
                                                 "max_len": max_len,
                                                 "ragged": ragged,
                                                 "prefill_chunk": int(config.get("prefill_chunk", 0) or 0),
                                                 "max_batch": int(config.get("serve_batch", 8) or 8),
                                                 "chunk": int(config.get("serve_chunk", 16) or 16),
                                                 "chunk_max": int(config.get("serve_chunk_max", 0) or 0),
                                                 "admit_coalesce_s": float(config.get("serve_admit_coalesce_ms", 50) or 0) / 1e3,
                                                 "auto_prefix": int(config.get("serve_auto_prefix", 0) or 0),
                                                 "quantize": config.get("quantize") or "",
                                                 "adapters": serve_adapters,
                                                 "weight_map": weight_map,
                                                 "eos_token_id":
                                                     _resolve_eos(d, hf_cfg),
                                                 **geometry}},
                            tokenizer_source=tok,
                            meta={"model_type": mt, "dtype": dtype.name})


@register_loader
class GgufLoader(Loader):
    NAME = "gguf"
    DESCRIPTION = "GGUF quantized checkpoint (llama.cpp format)"

    def config_schema(self):
        return super().config_schema() + [
            ConfigField("max_len", ConfigFieldType.INT, "KV cache slots",
                        default=1024, min=16),
            ConfigField("dtype", ConfigFieldType.ENUM, "compute dtype",
                        default="bf16", choices=["f32", "bf16", "f16"]),
            ConfigField("ragged_decode", ConfigFieldType.BOOL,
                        "per-row positions for continuous batching",
                        default=False),
            ConfigField("prefill_chunk", ConfigFieldType.INT,
                        "chunked-prefill piece width for the serving "
                        "batcher (0 = whole-bucket prefill)", default=0),
            ConfigField("serve_batch", ConfigFieldType.INT,
                        "serving batcher slot count (max_batch)",
                        default=8, min=1),
            ConfigField("serve_chunk", ConfigFieldType.INT,
                        "decode steps per batcher dispatch",
                        default=16, min=1),
            ConfigField("serve_chunk_max", ConfigFieldType.INT,
                        "adaptive long-chunk length for steady-state "
                        "decode (0 = off)", default=0),
            ConfigField("serve_admit_coalesce_ms", ConfigFieldType.INT,
                        "admission coalescing deadline (ms)", default=50),
            ConfigField("serve_auto_prefix", ConfigFieldType.INT,
                        "automatic prefix caching: LRU pool of N cached "
                        "KV rows (0 = off)", default=0),
            ConfigField("packed_weights", ConfigFieldType.BOOL,
                        "keep GGUF quants packed on the device (the "
                        "packed_matmul kernel; llama-family)", default=True),
        ]

    def can_load(self, path: str) -> bool:
        if not os.path.isfile(path) or not path.endswith(".gguf"):
            return False
        with open(path, "rb") as f:
            return f.read(4) == b"GGUF"

    def load(self, config):
        from ..symbolic_graph.tensor_store import LazyTensor
        from ..tensor import NumericTensor
        from .gguf import GGUFFile
        from .recipes.llm.gguf_llama import (LLAMA_FAMILY, build_from_gguf,
                                             build_from_gguf_packed)

        if config.get("decode_windows"):
            raise NotImplementedError(
                "gguf loader option 'decode_windows' is not ported to "
                "PyTorch yet")
        g = GGUFFile(config["path"])
        arch = g.architecture
        if arch not in LLAMA_FAMILY + ("phi3", "gemma", "gemma2"):
            raise ValueError(f"gguf architecture {arch!r} not supported yet")
        max_len = int(config.get("max_len", 1024))
        dtype = {"f32": DType.F32, "bf16": DType.BF16,
                 "f16": DType.F16}[config.get("dtype", "bf16")]
        ragged = bool(config.get("ragged_decode", False))
        name = g.metadata.get("general.name", os.path.basename(config["path"]))
        if bool(config.get("packed_weights", True)) and arch in LLAMA_FAMILY:
            # sub-byte weights stay packed end to end: structure-only
            # ONNX + TensorStore entries (lazy dense fallback + packed
            # source for the packed_matmul kernel)
            data, geometry, entries = build_from_gguf_packed(
                g, max_len=max_len, dtype=dtype, pos_per_row=ragged)
            model = Model.new_from_onnx(data, name=name)
            store = model.graph.store
            for wname, e in entries.items():
                if "value" in e:
                    store.put(wname, NumericTensor(e["value"]))
                    continue
                store.put(wname, LazyTensor(
                    loader=(lambda ld=e["lazy"]: NumericTensor(ld()))))
                if e["packed"] is not None:
                    store.packed_sources[wname] = e["packed"]
        else:
            data, geometry = build_from_gguf(g, max_len=max_len, dtype=dtype,
                                             pos_per_row=ragged)
            model = Model.new_from_onnx(data, name=name)
        eos = g.metadata.get("tokenizer.ggml.eos_token_id")
        return LoadedBundle(models={name: model},
                            interfaces={"text": {"model": name,
                                                 "max_len": max_len,
                                                 "ragged": ragged,
                                                 "prefill_chunk": int(config.get("prefill_chunk", 0) or 0),
                                                 "max_batch": int(config.get("serve_batch", 8) or 8),
                                                 "chunk": int(config.get("serve_chunk", 16) or 16),
                                                 "chunk_max": int(config.get("serve_chunk_max", 0) or 0),
                                                 "admit_coalesce_s": float(config.get("serve_admit_coalesce_ms", 50) or 0) / 1e3,
                                                 "auto_prefix": int(config.get("serve_auto_prefix", 0) or 0),
                                                 "quantize": config.get("quantize") or "",
                                                 "eos_token_id":
                                                     (int(eos) if eos
                                                      is not None else None),
                                                 **geometry}},
                            meta={"architecture": arch,
                                  "quantized": True})


@register_loader
class DiffusersPipelineLoader(Loader):
    """Diffusers pipeline directory (model_index.json), the reference's
    DiffusersPipelineLoader (:785-948) for the `sd` kind: SD-1.5 and
    SD-2.x (epsilon or, per scheduler_config.json, v-prediction). Every
    component builds from diffusers-layout safetensors through the
    recipes (importers/recipes/diffusion/): the CLIP text encoder, the
    UNet at batch 2 (the CFG pair), the VAE decoder and, with `img2img`,
    the VAE encoder. The sdxl, sd3 and flux kinds raise "not ported"."""

    NAME = "diffusers"
    DESCRIPTION = "Diffusers pipeline dir (model_index.json)"

    def config_schema(self):
        return super().config_schema() + [
            ConfigField("height", ConfigFieldType.INT, "image height"),
            ConfigField("width", ConfigFieldType.INT, "image width"),
            ConfigField("dtype", ConfigFieldType.ENUM, "compute dtype",
                        default="bf16", choices=["f32", "bf16", "f16"]),
            ConfigField("img2img", ConfigFieldType.BOOL,
                        "also build the VAE encoder (img2img, inpaint)"),
        ]

    def can_load(self, path: str) -> bool:
        return os.path.isdir(path) and os.path.exists(
            os.path.join(path, "model_index.json"))

    def load(self, config):
        from .recipes.diffusion.clip import ClipTextConfig, build_clip_text
        from .recipes.diffusion.unet import UNetConfig, build_sd_unet
        from .recipes.diffusion.vae import (VAEConfig, build_vae_decoder,
                                            build_vae_encoder)
        from .safetensors_io import SafetensorsStore

        d = config["path"]
        with open(os.path.join(d, "model_index.json")) as f:
            idx = json.load(f)
        cls = idx.get("_class_name", "")
        kind = ("flux" if "Flux" in cls else
                "sd3" if "StableDiffusion3" in cls else
                "sdxl" if "XL" in cls else "sd")
        if kind != "sd":
            raise NotImplementedError(
                f"the {kind!r} diffusers pipeline ({cls}) is not ported to "
                f"the PyTorch package yet; it loads the 'sd' kind "
                f"(SD-1.5, SD-2.x) only (ROADMAP A9)")
        dtype = {"f32": DType.F32, "bf16": DType.BF16,
                 "f16": DType.F16}[config.get("dtype", "bf16")]

        def sub_cfg(sub):
            with open(os.path.join(d, sub, "config.json")) as f:
                return json.load(f)

        def getter(sub):
            store = SafetensorsStore.from_dir(os.path.join(d, sub))
            return lambda name, shape=None: store.load(name)

        models: Dict[str, Model] = {}
        spec: Dict[str, Any] = {"pipeline": kind}

        def add(key, data, name):
            models[name] = Model.new_from_onnx(data, name=name)
            spec[key] = name

        cj = sub_cfg("text_encoder")
        ccfg = ClipTextConfig.from_hf(cj)
        spec["bos_token_id"] = cj.get("bos_token_id", 49406)
        spec["eos_token_id"] = cj.get("eos_token_id", 49407)
        spec["seq_len"] = min(ccfg.max_position_embeddings, 77)
        # HF CLIP configs carry projection_dim even when the checkpoint
        # has no text_projection weight
        if "CLIPTextModelWithProjection" not in (cj.get("architectures")
                                                 or []):
            ccfg.projection_dim = None
        add("text_encoder", build_clip_text(
            getter("text_encoder"), ccfg, seq_len=spec["seq_len"],
            dtype=dtype), f"{kind}-text_encoder")
        ucfg = UNetConfig.from_hf(sub_cfg("unet"))
        h = int(config.get("height", ucfg.sample_size * 8))
        w_ = int(config.get("width", ucfg.sample_size * 8))
        add("unet", build_sd_unet(getter("unet"), ucfg, batch=2,
                                  latent_hw=(h // 8, w_ // 8), dtype=dtype),
            f"{kind}-unet")
        # scheduler prediction type (SD2-768 is v_prediction)
        sp = os.path.join(d, "scheduler", "scheduler_config.json")
        if os.path.exists(sp):
            with open(sp) as f:
                spec["prediction_type"] = json.load(f).get(
                    "prediction_type", "epsilon")
        vcfg = VAEConfig.from_hf(sub_cfg("vae"))
        add("vae", build_vae_decoder(getter("vae"), vcfg,
                                     latent_hw=(h // 8, w_ // 8),
                                     dtype=dtype), f"{kind}-vae")
        if config.get("img2img"):
            add("vae_encoder", build_vae_encoder(getter("vae"), vcfg,
                                                 image_hw=(h, w_),
                                                 dtype=dtype),
                f"{kind}-vae-encoder")
            spec["vae_scaling"] = vcfg.scaling_factor
            spec["vae_shift"] = vcfg.shift_factor
        spec["height"], spec["width"] = h, w_
        spec["latent_channels"] = vcfg.latent_channels
        tok = os.path.join(d, "tokenizer", "tokenizer.json")
        return LoadedBundle(models=models, interfaces={"image": spec},
                            tokenizer_source=(tok if os.path.exists(tok)
                                              else None),
                            meta={"architecture": f"diffusers-{kind}"})


@register_loader
class LdmCheckpointLoader(Loader):
    """Original LDM/CompVis single-file SD checkpoint, recognized as the
    reference's LdmCheckpointLoader (:949) recognizes it; loading it
    raises "not ported" (ROADMAP A9)."""

    NAME = "ldm"
    DESCRIPTION = "Single-file SD checkpoint (LDM naming, .safetensors)"

    def can_load(self, path: str) -> bool:
        if not (os.path.isfile(path) and path.endswith(".safetensors")):
            return False
        from .safetensors_io import SafetensorsStore

        try:
            store = SafetensorsStore([path])
        except (OSError, ValueError):
            return False
        return any(n.startswith("model.diffusion_model.")
                   for n in store.names())

    def load(self, config):
        raise NotImplementedError(
            "the single-file LDM checkpoint loader ('ldm') is not ported to "
            "the PyTorch package yet; convert the checkpoint to a diffusers "
            "directory (ROADMAP A9)")


@register_loader
class AutoLoader(Loader):
    NAME = "auto"
    DESCRIPTION = "Probe the path and delegate to the right loader"

    def can_load(self, path: str) -> bool:
        return True

    def load(self, config):
        path = config["path"]
        for name, loader in _LOADERS.items():
            if name != "auto" and loader.can_load(path):
                return loader.load(config)
        raise ValueError(f"cannot identify model format at {path!r} (the "
                         f"port loads transformers checkpoint dirs, GGUF "
                         f"files and diffusers pipeline dirs only)")


def identify_and_load(path: str, **config) -> LoadedBundle:
    return _LOADERS["auto"].load({"path": path, **config})
