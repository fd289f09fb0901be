"""Loader registry, the raw ONNX, transformers, GGUF, RWKV-7, diffusers,
LDM and TTS loaders, identify_and_load.

The port's copy of whisper_tensor_tpu/importers/loaders.py: the `onnx`
loader for a raw .onnx file (:110-121; its weights embedded, in a .bin
file beside it, or referenced in their origin checkpoint), the
`transformers` loader for GPT-2, llama-family, Gemma, Phi-3,
DeepSeek-V2/V3, T5, LLaVA and Whisper checkpoints (config.json +
safetensors),
the `gguf` loader for llama-family, Gemma and Phi-3 GGUF files
(:525-652), the `rwkv7` loader for RWKV-7 `.pth` files (:656-679), the
`diffusers` and `ldm` loaders (below), the TTS loaders `piper`, `kokoro` and `f5`
(:681-784, :1123-1158) and the `auto` loader that probes for them.
Their config keys and their bundles' `text` interface spec are the
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
batcher fails at the first request: ROADMAP C18), and for deepseek_v2
and deepseek_v3 likewise (ROADMAP C25). deepseek_v2/v3 take
`absorb_mla` (default on: attention over the latent cache) and v3 its
sigmoid group routing (:279-293); `t5` builds an encoder and a decoder
step (`enc_len`, default 512) under a `text2text` spec (:422-452);
`llava` a llama/mistral/qwen2 text model and a CLIP vision tower with
its projector under `text` and `multimodal` specs, in either weight
layout (:350-420); `whisper` an encoder over 2 * max_source_positions
mel frames and a decoder step under an `stt` spec (:293-348). The
`rwkv7` loader takes `dtype` (default f32, the
reference's graph) and `tokenizer` (a World vocabulary file; the
reference's loader names none). The `diffusers`
loader builds the sd (SD-1.5, SD-2.x), sdxl, sd3 and flux image
pipelines (:784-946), the `ldm` loader SD-1.x/2.x and SDXL single files
(:949-1120). Left out, each raising: other model types and GGUF archs
(ValueError, as the reference does for an unknown one). `decode_windows`
(`transformers`: GPT-2 and the llama family, :221-260, :474-485; `gguf`:
every arch but phi3, :621-633; neither under ragged_decode) adds, for
each window size below max_len, the recipe's step graph at that max_len
built structure-only (zero weights from the store's zeros_getter, or
build_from_gguf(zeros=True), under WeightStorage.none()) sharing the
main model's TensorStore, and names them in the text spec's "windows"
({size: model name}). `auto` probes the loaders in the
reference's order: `ldm` (PRIORITY 11), then diffusers, piper, kokoro and
f5 (10), then the rest as registered, `onnx` first. GPTQ/AWQ
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
from .onnx_builder import WeightStorage


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


@register_loader
class OnnxLoader(Loader):
    NAME = "onnx"
    DESCRIPTION = "Load a raw ONNX model file"

    def can_load(self, path: str) -> bool:
        return os.path.isfile(path) and path.endswith(".onnx")

    def load(self, config):
        path = config["path"]
        model = Model.new_from_onnx_file(path)
        return LoadedBundle(models={model.name: model})


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


def _add_windows(models: Dict[str, Model], model: Model, name: str,
                 max_len: int, config, build) -> Dict[str, str]:
    """The `decode_windows` option (reference :474-485, :621-633): for
    each size w in the comma-separated list with 0 < w < max_len, the
    structure-only step graph `build(w)` as a Model sharing `model`'s
    TensorStore, added to `models` as `<name>-w<w>`. Returns the text
    spec's "windows", {str(w): model name}."""
    spec = {}
    for tok in str(config.get("decode_windows", "") or "").split(","):
        if not tok.strip():
            continue
        w = int(tok.strip())
        if not 0 < w < max_len:
            continue
        wm = Model.new_from_onnx(build(w), name=f"{name}-w{w}")
        wm.graph.store = model.graph.store     # the weights are shared
        models[wm.name] = wm
        spec[str(w)] = wm.name
    return spec


_LLAMA_FAMILY = ("llama", "mistral", "mixtral", "qwen2", "qwen3",
                 "qwen3_moe")
# model types whose recipes take no pos_per_row: one scalar position
_SCALAR_POS = ("gemma", "gemma2", "gemma3_text", "gemma3", "phi3",
               "deepseek_v2", "deepseek_v3")


@register_loader
class TransformersLoader(Loader):
    NAME = "transformers"
    DESCRIPTION = "HF transformers checkpoint dir (config.json + safetensors)"
    SUPPORTED = ("gpt2",) + _LLAMA_FAMILY + _SCALAR_POS + ("t5", "llava",
                                                            "whisper")

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
            ConfigField("decode_windows", ConfigFieldType.STRING,
                        "comma-separated KV window sizes (e.g. 256,1024) "
                        "for phased windowed decode: smaller caches on "
                        "early tokens (gpt2/llama-family)", default=""),
            ConfigField("lora", ConfigFieldType.FILE_PATH,
                        "PEFT adapter dir (adapter_config.json + "
                        "adapter_model.safetensors) merged into the base "
                        "weights at load", default=""),
            ConfigField("serve_adapters", ConfigFieldType.STRING,
                        "multi-LoRA serving: name=peft_dir[,name2=dir2] "
                        "adapters selectable per request through the "
                        "batcher (needs ragged_decode)", default=""),
            ConfigField("absorb_mla", ConfigFieldType.BOOL,
                        "deepseek: attention over the compressed latent "
                        "cache (kv_b_proj folded into q and the output)",
                        default=True),
            ConfigField("enc_len", ConfigFieldType.INT,
                        "t5: encoder length (prompts pad to it)",
                        default=512, min=1),
        ]

    def can_load(self, path: str) -> bool:
        return os.path.isdir(path) and os.path.exists(
            os.path.join(path, "config.json"))

    def load(self, config):
        from .quantized import QuantizedStore, parse_quantization_config
        from .safetensors_io import SafetensorsStore, load_hf_config

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
        window_builder = None             # max_len -> a window's ONNX
        ragged = bool(config.get("ragged_decode", False))
        if ragged and mt in _SCALAR_POS:
            # the reference builds these recipes' scalar-position graph
            # under ragged_decode too, and its batcher fails at the first
            # request (ROADMAP C18, C25): refused here, at load
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
            window_builder = lambda w: build_gpt2_step(  # noqa: E731
                store.zeros_getter(), cfg, max_len=w, dtype=dtype,
                storage=WeightStorage.none())
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

            def zeros(name, _zg=store.zeros_getter()):
                if name == "lm_head.weight" and name not in store:
                    name = "model.embed_tokens.weight"
                return _zg(name)

            window_builder = lambda w: build_llama_step(  # noqa: E731
                zeros, cfg, max_len=w, dtype=dtype,
                storage=WeightStorage.none())
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
        elif mt in ("deepseek_v2", "deepseek_v3"):
            from .recipes.llm.deepseek import (DeepseekConfig,
                                               build_deepseek_step)

            cfg = DeepseekConfig.from_hf(hf_cfg)
            if mt == "deepseek_v3":
                cfg.scoring_func = "sigmoid"
                cfg.topk_method = "noaux_tc"
            data = build_deepseek_step(store.getter(), cfg, max_len=max_len,
                                       dtype=dtype,
                                       absorb=bool(config.get("absorb_mla",
                                                              True)))
            # the two caches differ in width: the latent (kv_lora_rank)
            # and the rope key (qk_rope_head_dim)
            geometry = dict(n_layers=cfg.num_hidden_layers, n_kv_heads=1,
                            head_dim=cfg.kv_lora_rank)
        elif mt == "llava":
            return self._load_llava(config, d, hf_cfg, store, dtype,
                                    max_len)
        elif mt == "t5":
            return self._load_t5(config, d, hf_cfg, store, dtype, max_len)
        elif mt == "whisper":
            return self._load_whisper(d, hf_cfg, store, dtype, max_len)
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
        models = {name: model}
        window_spec = {}
        if window_builder is not None and not ragged:
            window_spec = _add_windows(models, model, name, max_len,
                                       config, window_builder)
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
        return LoadedBundle(models=models,
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
                                                 "windows": window_spec,
                                                 "adapters": serve_adapters,
                                                 "weight_map": weight_map,
                                                 "eos_token_id":
                                                     _resolve_eos(d, hf_cfg),
                                                 **geometry}},
                            tokenizer_source=tok,
                            meta={"model_type": mt, "dtype": dtype.name})


    @staticmethod
    def _load_llava(config, d, hf_cfg, store, dtype, max_len):
        """A LLaVA checkpoint: language_model.* + vision_tower.* +
        multi_modal_projector.* in one dir, in the classic layout or the
        transformers 4.52+ one (model.language_model.*, lm_head.*)."""
        from .recipes.llm.llama import LlamaConfig, build_llama_step
        from .recipes.vision import ClipVisionConfig, build_clip_vision

        text_cfg = hf_cfg["text_config"]
        if text_cfg.get("model_type", "llama") not in (
                "llama", "mistral", "qwen2"):
            raise ValueError(
                f"llava text model {text_cfg.get('model_type')!r} "
                "not supported")

        def lm_getter(name):
            cands = [f"language_model.{name}"]
            if name.startswith("model."):
                cands.append("model.language_model." + name[len("model."):])
            else:
                cands.append(name)
            for cand in cands:
                if cand in store:
                    return store.load(cand)
            if name == "lm_head.weight":
                return lm_getter("model.embed_tokens.weight")
            return store.load(cands[0])

        cfg = LlamaConfig.from_hf(text_cfg)
        data = build_llama_step(lm_getter, cfg, max_len=max_len, dtype=dtype)
        vcfg = ClipVisionConfig.from_hf(hf_cfg["vision_config"])
        vcfg.select_layer = int(hf_cfg.get("vision_feature_layer", -2))

        def prefixed(prefix):
            def get(name):
                for cand in (f"{prefix}.{name}", f"model.{prefix}.{name}"):
                    if cand in store:
                        return store.load(cand)
                return store.load(name)
            return get

        vdata = build_clip_vision(prefixed("vision_tower"), vcfg,
                                  dtype=dtype,
                                  projector=prefixed("multi_modal_projector"))
        name = (hf_cfg.get("_name_or_path")
                or os.path.basename(os.path.normpath(d)))
        tok = d if os.path.exists(os.path.join(d, "tokenizer.json")) else None
        return LoadedBundle(
            models={name: Model.new_from_onnx(data, name=name),
                    name + "-vision": Model.new_from_onnx(
                        vdata, name=name + "-vision")},
            interfaces={"text": {"model": name, "max_len": max_len,
                                 "quantize": config.get("quantize") or "",
                                 "eos_token_id": _resolve_eos(d, hf_cfg),
                                 "n_layers": cfg.num_hidden_layers,
                                 "n_kv_heads": cfg.num_key_value_heads,
                                 "head_dim": cfg.hd},
                        "multimodal": {"model": name,
                                       "vision": name + "-vision",
                                       "embed_weight": "embed_tokens",
                                       "image_size": vcfg.image_size}},
            tokenizer_source=tok,
            meta={"model_type": "llava", "dtype": dtype.name})

    @staticmethod
    def _load_whisper(d, hf_cfg, store, dtype, max_len):
        """A Whisper checkpoint (reference :293-348): the encoder over
        2 * max_source_positions mel frames and the decoder step at
        min(max_len, max_target_positions) under an `stt` spec, whose
        forced start sequence comes from generation_config.json."""
        from .recipes.speech.whisper import (WhisperConfig,
                                             build_whisper_decoder_step,
                                             build_whisper_encoder)

        cfg = WhisperConfig.from_hf(hf_cfg)
        dec_len = min(max_len, cfg.max_target_positions)
        n_frames = 2 * cfg.max_source_positions  # conv stride-2 stack
        enc = Model.new_from_onnx(
            build_whisper_encoder(store.getter(), cfg, n_frames=n_frames,
                                  dtype=dtype), name="whisper-encoder")
        dec = Model.new_from_onnx(
            build_whisper_decoder_step(store.getter(), cfg, max_len=dec_len,
                                       n_frames=n_frames, dtype=dtype),
            name="whisper-decoder")
        tok = d if os.path.exists(os.path.join(d, "tokenizer.json")) else None
        gcfg = {}
        gp = os.path.join(d, "generation_config.json")
        if os.path.exists(gp):
            try:
                with open(gp, "r", encoding="utf-8") as f:
                    gcfg = json.load(f)
            except (OSError, ValueError):
                gcfg = {}
        start = int(gcfg.get("decoder_start_token_id",
                             hf_cfg.get("decoder_start_token_id", 50258)))
        # keep POSITIONS: real multilingual checkpoints ship [[1, null],
        # [2, task], [3, notimestamps]] where null is the auto-detect
        # language slot, which sot_with substitutes by position
        sot_seq: list = [start]
        for pos, tid in sorted(gcfg.get("forced_decoder_ids") or [],
                               key=lambda p: p[0]):
            while len(sot_seq) < pos:
                sot_seq.append(None)
            sot_seq.append(None if tid is None else int(tid))
        return LoadedBundle(
            models={"whisper-encoder": enc, "whisper-decoder": dec},
            interfaces={"stt": {
                "encoder": "whisper-encoder", "decoder": "whisper-decoder",
                "n_mels": cfg.num_mel_bins, "max_len": dec_len,
                "n_frames": n_frames, "sot": start, "sot_sequence": sot_seq,
                "eot": int(gcfg.get("eos_token_id",
                                    hf_cfg.get("eos_token_id", 50257)))}},
            tokenizer_source=tok,
            meta={"model_type": "whisper", "dtype": dtype.name})

    @staticmethod
    def _load_t5(config, d, hf_cfg, store, dtype, max_len):
        """A T5 checkpoint: the encoder at `enc_len` and the decoder step
        under a `text2text` spec; the head ties to shared.weight when
        the checkpoint has no lm_head. Both graphs take the padding mask
        (recipes/llm/t5.py `pad_mask`), so a shorter prompt's pads are
        not attended (ROADMAP C28)."""
        from .recipes.llm.t5 import (T5Config, build_t5_decoder_step,
                                     build_t5_encoder)

        cfg = T5Config.from_hf(hf_cfg)
        enc_len = int(config.get("enc_len", 512))
        dec_len = min(max_len, 512)

        def t5_getter(nm):
            if nm == "lm_head.weight" and nm not in store:
                return store.load("shared.weight")
            return store.load(nm)

        name = (hf_cfg.get("_name_or_path")
                or os.path.basename(os.path.normpath(d)))
        enc = Model.new_from_onnx(
            build_t5_encoder(t5_getter, cfg, seq_len=enc_len, dtype=dtype,
                             pad_mask=True),
            name=name + "-encoder")
        dec = Model.new_from_onnx(
            build_t5_decoder_step(t5_getter, cfg, max_len=dec_len,
                                  enc_len=enc_len, dtype=dtype,
                                  pad_mask=True),
            name=name + "-decoder")
        tok = d if os.path.exists(os.path.join(d, "tokenizer.json")) else None
        return LoadedBundle(
            models={enc.name: enc, dec.name: dec},
            interfaces={"text2text": {
                "encoder": enc.name, "decoder": dec.name,
                "max_len": dec_len, "enc_len": enc_len,
                "start": int(hf_cfg.get("decoder_start_token_id", 0)),
                "eos": int(hf_cfg.get("eos_token_id", 1))}},
            tokenizer_source=tok,
            meta={"model_type": "t5", "dtype": dtype.name})


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
            ConfigField("decode_windows", ConfigFieldType.STRING,
                        "comma-separated KV window sizes for phased "
                        "windowed decode", default=""),
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
        models = {name: model}
        window_spec = {}
        if not ragged and arch != "phi3":
            window_spec = _add_windows(
                models, model, name, max_len, config,
                lambda w: build_from_gguf(g, max_len=w, dtype=dtype,
                                          zeros=True,
                                          storage=WeightStorage.none())[0])
        eos = g.metadata.get("tokenizer.ggml.eos_token_id")
        return LoadedBundle(models=models,
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
                                                 "windows": window_spec,
                                                 "eos_token_id":
                                                     (int(eos) if eos
                                                      is not None else None),
                                                 **geometry}},
                            meta={"architecture": arch,
                                  "quantized": True})


@register_loader
class Rwkv7Loader(Loader):
    """RWKV-7 `.pth` checkpoint (a torch.save'd state dict; the
    reference's Rwkv7Loader, :656-679): one step graph whose state the
    `text` spec marks `rnn_state`, served by interfaces/rnn_text.py."""

    NAME = "rwkv7"
    DESCRIPTION = "RWKV-7 .pth checkpoint (linear recurrence)"

    def config_schema(self):
        return super().config_schema() + [
            ConfigField("dtype", ConfigFieldType.ENUM, "compute dtype "
                        "(the recurrent state stays f32)", default="f32",
                        choices=["f32", "bf16", "f16"]),
            ConfigField("tokenizer", ConfigFieldType.FILE_PATH,
                        "RWKV World vocabulary file (.txt)", default=""),
        ]

    def can_load(self, path: str) -> bool:
        return os.path.isfile(path) and path.endswith(".pth") \
            and "rwkv" in os.path.basename(path).lower()

    def load(self, config):
        from .pth import load_pth
        from .recipes.llm.rwkv7 import build_rwkv7_step, rwkv7_config_from_sd

        sd = load_pth(config["path"])
        cfg = rwkv7_config_from_sd(sd)
        dtype = {"f32": DType.F32, "bf16": DType.BF16,
                 "f16": DType.F16}[config.get("dtype", "f32")]
        data = build_rwkv7_step(lambda n: sd[n], cfg, dtype=dtype)
        name = os.path.basename(config["path"])
        model = Model.new_from_onnx(data, name=name)
        return LoadedBundle(models={name: model},
                            interfaces={"text": {"model": name,
                                                 "rnn_state": True,
                                                 "n_layers": cfg.n_layer,
                                                 "n_embd": cfg.n_embd}},
                            tokenizer_source=config.get("tokenizer") or None,
                            meta={"architecture": "rwkv7",
                                  "dtype": dtype.name})


@register_loader
class DiffusersPipelineLoader(Loader):
    """Diffusers pipeline directory (model_index.json), the reference's
    DiffusersPipelineLoader (:785-946): the `sd` kind (SD-1.5, SD-2.x,
    epsilon or, per scheduler_config.json, v-prediction), `sdxl` (CLIP-L
    and the projected OpenCLIP-bigG, the UNet's addition embeddings),
    `sd3` (two CLIPs, an optional T5 encoder, the MMDiT) and `flux`
    (CLIP-L's pooled output, the T5 encoder, the Flux transformer).
    Every component builds from diffusers-layout safetensors through the
    recipes (importers/recipes/): the CFG kinds' denoiser at batch 2 (the
    CFG pair), Flux's at batch 1 (guidance-distilled), the VAE decoder
    and, with `img2img`, the VAE encoder."""

    NAME = "diffusers"
    DESCRIPTION = "Diffusers pipeline dir (model_index.json)"
    PRIORITY = 10

    def config_schema(self):
        return super().config_schema() + [
            ConfigField("height", ConfigFieldType.INT, "image height"),
            ConfigField("width", ConfigFieldType.INT, "image width"),
            ConfigField("dtype", ConfigFieldType.ENUM, "compute dtype",
                        default="bf16", choices=["f32", "bf16", "f16"]),
            ConfigField("t5_seq_len", ConfigFieldType.INT,
                        "T5 context tokens (sd3/flux)", default=77),
            ConfigField("img2img", ConfigFieldType.BOOL,
                        "also build the VAE encoder (img2img, inpaint)"),
        ]

    def can_load(self, path: str) -> bool:
        return os.path.isdir(path) and os.path.exists(
            os.path.join(path, "model_index.json"))

    def load(self, config):
        from .recipes.diffusion.clip import ClipTextConfig, build_clip_text
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

        def clip(sub):
            cj = sub_cfg(sub)
            ccfg = ClipTextConfig.from_hf(cj)
            if sub == "text_encoder":
                spec["bos_token_id"] = cj.get("bos_token_id", 49406)
                spec["eos_token_id"] = cj.get("eos_token_id", 49407)
                spec["seq_len"] = min(ccfg.max_position_embeddings, 77)
            # HF CLIP configs carry projection_dim even when the
            # checkpoint has no text_projection weight
            if "CLIPTextModelWithProjection" not in (
                    cj.get("architectures") or []):
                ccfg.projection_dim = None
            add(sub, build_clip_text(getter(sub), ccfg, seq_len=min(
                ccfg.max_position_embeddings, 77), dtype=dtype),
                f"{kind}-{sub}")

        def t5(sub, name):
            from .recipes.llm.t5 import T5Config, build_t5_encoder

            add(sub, build_t5_encoder(getter(sub),
                                      T5Config.from_hf(sub_cfg(sub)),
                                      seq_len=t5_len, dtype=dtype,
                                      with_cross=False), name)

        vcfg = VAEConfig.from_hf(sub_cfg("vae"))
        t5_len = int(config.get("t5_seq_len", 77))
        if kind in ("sd", "sdxl"):
            from .recipes.diffusion.unet import UNetConfig, build_sd_unet

            ucfg = UNetConfig.from_hf(sub_cfg("unet"))
            h = int(config.get("height", ucfg.sample_size * 8))
            w_ = int(config.get("width", ucfg.sample_size * 8))
            clip("text_encoder")
            if kind == "sdxl":
                clip("text_encoder_2")
            add("unet", build_sd_unet(getter("unet"), ucfg, batch=2,
                                      latent_hw=(h // 8, w_ // 8),
                                      dtype=dtype), f"{kind}-unet")
            # scheduler prediction type (SD2-768 is v_prediction)
            sp = os.path.join(d, "scheduler", "scheduler_config.json")
            if os.path.exists(sp):
                with open(sp) as f:
                    spec["prediction_type"] = json.load(f).get(
                        "prediction_type", "epsilon")
        elif kind == "sd3":
            from .recipes.diffusion.mmdit import SD3Config, build_sd3_mmdit

            mcfg = SD3Config.from_hf(sub_cfg("transformer"))
            h = int(config.get("height", mcfg.sample_size * 8))
            w_ = int(config.get("width", mcfg.sample_size * 8))
            clip("text_encoder")
            clip("text_encoder_2")
            has_t5 = os.path.isdir(os.path.join(d, "text_encoder_3"))
            ctx = spec["seq_len"] + (t5_len if has_t5 else 0)
            if has_t5:
                t5("text_encoder_3", "sd3-t5")
            add("transformer", build_sd3_mmdit(
                getter("transformer"), mcfg, batch=2, context_len=ctx,
                latent_hw=(h // 8, w_ // 8), dtype=dtype), "sd3-mmdit")
            spec["joint_dim"] = mcfg.joint_attention_dim
            spec["t5_seq_len"] = t5_len
        else:  # flux
            from .recipes.diffusion.flux import FluxConfig, build_flux

            fcfg = FluxConfig.from_hf(sub_cfg("transformer"))
            h = int(config.get("height", 1024))
            w_ = int(config.get("width", 1024))
            clip("text_encoder")
            t5("text_encoder_2", "flux-t5")
            add("transformer", build_flux(
                getter("transformer"), fcfg, batch=1, context_len=t5_len,
                latent_hw=(h // 8, w_ // 8), dtype=dtype), "flux-transformer")
            spec["guidance_embeds"] = fcfg.guidance_embeds
            spec["t5_seq_len"] = t5_len
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
    """Original LDM/CompVis single-file SD checkpoint
    (model.diffusion_model.* / first_stage_model.* / cond_stage_model.*),
    the reference's LdmCheckpointLoader (:949-1120): SD-1.x (the HF CLIP
    naming), SD-2.x (the open_clip tower, its penultimate layer) and SDXL
    (conditioner.embedders.0 CLIP-L and 1 OpenCLIP-bigG), each detected
    from the names and shapes (importers/ldm.py) and built by the same
    recipes as a diffusers directory, through name maps; `img2img` adds
    the VAE encoder."""

    NAME = "ldm"
    DESCRIPTION = "Single-file SD checkpoint (LDM naming, .safetensors)"
    PRIORITY = 11   # a .safetensors file is ambiguous; probe keys first

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

    def config_schema(self):
        return super().config_schema() + [
            ConfigField("height", ConfigFieldType.INT, "image height"),
            ConfigField("width", ConfigFieldType.INT, "image width"),
            ConfigField("dtype", ConfigFieldType.ENUM, "compute dtype",
                        default="bf16", choices=["f32", "bf16", "f16"]),
            ConfigField("prediction_type", ConfigFieldType.ENUM,
                        "scheduler prediction (SD2-768: v_prediction)",
                        default="epsilon",
                        choices=["epsilon", "v_prediction"]),
            ConfigField("img2img", ConfigFieldType.BOOL,
                        "also build the VAE encoder (img2img, inpaint)"),
        ]

    def load(self, config):
        from .ldm import (CLIP_PREFIX, UNET_PREFIX, VAE_PREFIX, LdmWeights,
                          detect_openclip_config, detect_unet_config,
                          openclip_getter)
        from .recipes.diffusion.clip import ClipTextConfig, build_clip_text
        from .recipes.diffusion.unet import build_sd_unet
        from .recipes.diffusion.vae import (VAEConfig, build_vae_decoder,
                                            build_vae_encoder)
        from .safetensors_io import SafetensorsStore

        path = config["path"]
        store = SafetensorsStore([path])
        dtype = {"f32": DType.F32, "bf16": DType.BF16,
                 "f16": DType.F16}[config.get("dtype", "bf16")]
        lw = LdmWeights(store.load, lambda k: k in store)
        has = lambda k: k in store  # noqa: E731
        names = list(store.names())
        ucfg = detect_unet_config(
            lambda k: (UNET_PREFIX + k) in store,
            lambda k: store.load(UNET_PREFIX + k).shape)
        sdxl = ucfg.addition_embed

        def probe_hf_clip(prefix):
            tok = store.load(prefix
                             + "text_model.embeddings.token_embedding.weight")
            n_layers = 0
            while (prefix + f"text_model.encoder.layers.{n_layers}."
                   "layer_norm1.weight") in store:
                n_layers += 1
            return ClipTextConfig(
                num_hidden_layers=n_layers, hidden_size=tok.shape[1],
                num_attention_heads=max(tok.shape[1] // 64, 1),
                intermediate_size=store.load(
                    prefix + "text_model.encoder.layers.0.mlp.fc1.weight"
                ).shape[0],
                vocab_size=tok.shape[0],
                max_position_embeddings=store.load(
                    prefix + "text_model.embeddings.position_embedding"
                    ".weight").shape[0])

        openclip_sd2 = any(n.startswith("cond_stage_model.model.")
                           for n in names)
        if sdxl:
            # conditioner.embedders.0 = CLIP-L (HF naming),
            # conditioner.embedders.1 = OpenCLIP bigG (+text_projection)
            te1_prefix = "conditioner.embedders.0.transformer."
            te2_prefix = "conditioner.embedders.1.model."
            if not any(n.startswith(te1_prefix) for n in names):
                raise ValueError("SDXL checkpoint missing "
                                 "conditioner.embedders.0")
            ccfg = probe_hf_clip(te1_prefix)
            ccfg2 = detect_openclip_config(store.load, has, te2_prefix)
            # label_emb input = pooled(te2 projection) + 6 micro-cond
            # sinusoids; solve for the sinusoid width (256 on real SDXL)
            ucfg.addition_time_embed_dim = (
                ucfg.projection_class_embeddings_input_dim
                - ccfg2.projection_dim) // 6
        elif openclip_sd2:
            # SD2: open_clip ViT-H tower; conditioning = 'penultimate'
            # (stop one block early, then ln_final) -> build L-1 blocks
            ccfg = detect_openclip_config(store.load, has,
                                          "cond_stage_model.model.",
                                          drop_last=True)
            ccfg.projection_dim = None
        elif any(n.startswith(CLIP_PREFIX) for n in names):
            ccfg = probe_hf_clip(CLIP_PREFIX)
        else:
            raise ValueError("checkpoint has no recognizable text encoder")

        h = int(config.get("height", 1024 if sdxl else 512))
        w_ = int(config.get("width", 1024 if sdxl else 512))
        # VAE decoder config by shape probing
        lat = store.load(VAE_PREFIX + "post_quant_conv.weight").shape[0]
        boc = []
        k = 0
        while (VAE_PREFIX + f"decoder.up.{k}.block.0.conv1.weight") in store:
            boc.append(store.load(
                VAE_PREFIX + f"decoder.up.{k}.block.0.conv1.weight").shape[0])
            k += 1
        vlpb = 0
        while (VAE_PREFIX + f"decoder.up.0.block.{vlpb}.conv1.weight") in store:
            vlpb += 1
        groups = 32 if all(c % 32 == 0 for c in boc) else 4
        vcfg = VAEConfig(latent_channels=lat,
                         block_out_channels=tuple(boc),
                         layers_per_block=max(vlpb - 1, 1), norm_groups=groups)

        models: Dict[str, Model] = {}
        spec: Dict[str, Any] = {
            "pipeline": "sdxl" if sdxl else "sd",
            "height": h, "width": w_, "latent_channels": lat,
            "seq_len": min(ccfg.max_position_embeddings, 77),
            # CLIP convention: the two top vocab slots are BOS/EOS
            # (49406/49407 for the real 49408-token vocab)
            "bos_token_id": ccfg.vocab_size - 2,
            "eos_token_id": ccfg.vocab_size - 1,
            "prediction_type": config.get("prediction_type", "epsilon")}

        def add(key, data, name):
            models[name] = Model.new_from_onnx(data, name=name)
            spec[key] = name

        if sdxl:
            add("text_encoder",
                build_clip_text(lw.clip_getter(te1_prefix), ccfg,
                                seq_len=spec["seq_len"], dtype=dtype),
                "ldm-clip-l")
            add("text_encoder_2",
                build_clip_text(openclip_getter(store.load, te2_prefix),
                                ccfg2, seq_len=spec["seq_len"], dtype=dtype),
                "ldm-clip-g")
        elif openclip_sd2:
            add("text_encoder",
                build_clip_text(openclip_getter(store.load,
                                                "cond_stage_model.model."),
                                ccfg, seq_len=spec["seq_len"], dtype=dtype),
                "ldm-openclip")
        else:
            add("text_encoder", build_clip_text(lw.clip_getter(), ccfg,
                                                seq_len=spec["seq_len"],
                                                dtype=dtype), "ldm-clip")
        add("unet", build_sd_unet(lw.unet_getter(ucfg), ucfg, batch=2,
                                  latent_hw=(h // 8, w_ // 8),
                                  dtype=dtype), "ldm-unet")
        add("vae", build_vae_decoder(lw.vae_getter(len(boc)), vcfg,
                                     latent_hw=(h // 8, w_ // 8),
                                     dtype=dtype), "ldm-vae")
        if config.get("img2img"):
            add("vae_encoder", build_vae_encoder(lw.vae_encoder_getter(),
                                                 vcfg, image_hw=(h, w_),
                                                 dtype=dtype),
                "ldm-vae-encoder")
            spec["vae_scaling"] = vcfg.scaling_factor
            spec["vae_shift"] = vcfg.shift_factor
        return LoadedBundle(models=models, interfaces={"image": spec},
                            meta={"architecture":
                                  "ldm-sdxl" if sdxl else "ldm-sd"})


def _find_piper_pair(path: str):
    """Resolve (onnx_path, config_path) for a piper voice: the config is
    the sibling `<model>.onnx.json` (or `<model>.json`). The reference's
    (:681-700)."""
    if os.path.isfile(path) and path.endswith(".onnx"):
        for cand in (path + ".json", path[:-5] + ".json"):
            if os.path.exists(cand):
                return path, cand
        return None
    if os.path.isdir(path):
        for f in sorted(os.listdir(path)):
            if f.endswith(".onnx"):
                pair = _find_piper_pair(os.path.join(path, f))
                if pair:
                    return pair
    return None


@register_loader
class PiperLoader(Loader):
    NAME = "piper"
    DESCRIPTION = "Piper VITS TTS voice (.onnx + .onnx.json config)"
    PRIORITY = 10   # probed before the other loaders

    def can_load(self, path: str) -> bool:
        return _find_piper_pair(path) is not None

    def load(self, config):
        """The reference's (:702-735)."""
        onnx_path, cfg_path = _find_piper_pair(config["path"])
        with open(cfg_path) as f:
            pcfg = json.load(f)
        model = Model.new_from_onnx_file(onnx_path)
        name = model.name
        inf = pcfg.get("inference", {})
        tts = {"model": name, "engine": "piper",
               "sample_rate": int(pcfg.get("audio", {}).get("sample_rate",
                                                            22050)),
               "language": pcfg.get("espeak", {}).get("voice", "en-us"),
               "phoneme_id_map": pcfg.get("phoneme_id_map"),
               "num_speakers": int(pcfg.get("num_speakers", 1)),
               "noise_scale": float(inf.get("noise_scale", 0.667)),
               "length_scale": float(inf.get("length_scale", 1.0)),
               "noise_w": float(inf.get("noise_w", 0.8))}
        return LoadedBundle(models={name: model},
                            interfaces={"tts": tts},
                            meta={"architecture": "piper-vits"})


@register_loader
class KokoroLoader(Loader):
    NAME = "kokoro"
    DESCRIPTION = ("Kokoro TTS dir (onnx/<variant>.onnx + tokenizer.json + "
                   "voices/*.bin)")
    PRIORITY = 10

    def can_load(self, path: str) -> bool:
        return (os.path.isdir(path)
                and os.path.isdir(os.path.join(path, "onnx"))
                and os.path.exists(os.path.join(path, "tokenizer.json"))
                and os.path.isdir(os.path.join(path, "voices")))

    def load(self, config):
        """The reference's (:736-784): the first (or the `variant`)
        ONNX file, the tokenizer's vocabulary, and each voice's style
        rows, one 256-wide row a phoneme count."""
        import numpy as np

        d = config["path"]
        variant = config.get("variant")
        onnx_dir = os.path.join(d, "onnx")
        cands = sorted(f for f in os.listdir(onnx_dir) if f.endswith(".onnx"))
        if variant:
            fname = f"{variant}.onnx"
            if fname not in cands:
                raise ValueError(f"kokoro variant {variant!r} not in {cands}")
        else:
            fname = cands[0]
        model = Model.new_from_onnx_file(os.path.join(onnx_dir, fname))
        name = model.name
        with open(os.path.join(d, "tokenizer.json")) as f:
            vocab = json.load(f).get("model", {}).get("vocab", {})
        voices = {}
        vdir = os.path.join(d, "voices")
        for f_ in sorted(os.listdir(vdir)):
            if f_.endswith(".bin"):
                raw = np.fromfile(os.path.join(vdir, f_), dtype="<f4")
                voices[f_[:-4]] = raw.reshape(-1, 256)
        tts = {"model": name, "engine": "kokoro", "sample_rate": 24000,
               "vocab": vocab, "voices": sorted(voices)}
        return LoadedBundle(models={name: model},
                            interfaces={"tts": tts},
                            tokenizer_source=os.path.join(d, "tokenizer.json"),
                            meta={"architecture": "kokoro",
                                  "voice_embeddings": voices})


@register_loader
class F5TtsLoader(Loader):
    NAME = "f5"
    DESCRIPTION = ("F5-TTS dir (F5_Preprocess.onnx + F5_Transformer.onnx + "
                   "F5_Decode.onnx + vocab.txt)")
    PRIORITY = 10
    PARTS = ("F5_Preprocess.onnx", "F5_Transformer.onnx", "F5_Decode.onnx")

    def can_load(self, path: str) -> bool:
        return (os.path.isdir(path)
                and all(os.path.exists(os.path.join(path, p))
                        for p in self.PARTS)
                and os.path.exists(os.path.join(path, "vocab.txt")))

    def load(self, config):
        """The reference's (:1123-1158): three ONNX stages and a
        newline vocabulary, 32 ODE steps by default, 24 kHz output."""
        d = config["path"]
        models, names = {}, {}
        for part, key in zip(self.PARTS,
                             ("preprocess", "transformer", "decode")):
            m = Model.new_from_onnx_file(os.path.join(d, part))
            models[m.name] = m
            names[key] = m.name
        with open(os.path.join(d, "vocab.txt"), encoding="utf-8") as f:
            vocab = {line.rstrip("\n"): i
                     for i, line in enumerate(f) if line.rstrip("\n")}
        tts = {"engine": "f5", "sample_rate": 24000,
               "nfe_steps": int(config.get("nfe_steps", 32)),
               "vocab": vocab, **names}
        return LoadedBundle(models=models, interfaces={"tts": tts},
                            meta={"architecture": "f5-tts"})


@register_loader
class AutoLoader(Loader):
    NAME = "auto"
    DESCRIPTION = "Probe the path and delegate to the right loader"

    def can_load(self, path: str) -> bool:
        return True

    def load(self, config):
        path = config["path"]
        # ldm, then the TTS and diffusers loaders (PRIORITY 11, 10) are
        # probed first, as in the reference; the rest keep their
        # registration order
        ranked = sorted((item for item in _LOADERS.items()
                         if item[0] != "auto"),
                        key=lambda kv: -getattr(kv[1], "PRIORITY", 0))
        for name, loader in ranked:
            if loader.can_load(path):
                return loader.load(config)
        raise ValueError(f"cannot identify model format at {path!r}")


def identify_and_load(path: str, **config) -> LoadedBundle:
    return _LOADERS["auto"].load({"path": path, **config})
