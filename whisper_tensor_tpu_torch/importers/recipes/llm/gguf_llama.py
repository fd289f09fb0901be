"""GGUF -> llama-family step graph.

Reference equivalent: the per-arch GGUF adapters
(crates/whisper-tensor-import/src/gguf/{llama3,qwen2,qwen3}.rs).
Maps GGUF tensor names (token_embd / blk.N.attn_q ...) to HF names and
reuses the llama recipe, either with every weight dequantized on the
host (build_from_gguf) or with the matmul weights left packed for the
packed_matmul kernel (build_from_gguf_packed).

The port's copy of whisper_tensor_tpu/importers/recipes/llm/
gguf_llama.py. build_from_gguf's `zeros=True` and `storage` (reference
:162-170) build a decode window's structure-only graph: shape-faithful
zero weights read from the file's tensor infos, nothing loaded or
dequantized, the payloads dropped under WeightStorage.none(). Arch
gemma, gemma2 and phi3 (:78-245: `_gguf_name_gemma`,
`gemma_config_from_gguf`, `_PHI3_LAYER_MAP` and build_from_gguf's
branches) dequantize every weight on the host and run their own
recipes; the packed path takes the llama family (llama, mistral, qwen2,
qwen3), as in the reference.

One fault of the reference is not inherited (ROADMAP C5). llama.cpp's
converter (convert_hf_to_gguf.py, LlamaModel.permute, applied to q_proj
and k_proj) stores the Q and K rows of arch `llama` files (Llama and
Mistral) permuted for GGML's interleaved rope:
    w.reshape(n_head, 2, hd / 2, K).swapaxes(1, 2)
(n_head_kv heads for K). The llama recipe's rotary rotates NeoX halves,
so those rows must be un-permuted before it sees them; the reference
feeds them unchanged, and a real llama.cpp Llama file gets the wrong
attention scores. Here `_unpermute` applies the inverse,
    w.reshape(n_head, hd / 2, 2, K).swapaxes(1, 2),
to attn_q and attn_k of arch llama and mistral, at the source: on the
dense path to the dequantized rows, on the packed path to whole rows of
block bytes (each row of a GGUF tensor is its own run of blocks, so the
reorder is exact and commutes with per-row block quantization), before
the interface fuses q/k/v. qwen2 and qwen3 files use NeoX rope, and
llama.cpp leaves their rows as they are.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ....dtype import DType
from ....tensor import NumericTensor, PackedTensor
from . import transposed
from .llama import LlamaConfig, build_llama_step

_NAME_MAP = {
    "model.embed_tokens.weight": "token_embd.weight",
    "model.norm.weight": "output_norm.weight",
    "lm_head.weight": "output.weight",
}
_LAYER_MAP = {
    "input_layernorm.weight": "attn_norm.weight",
    "self_attn.q_proj.weight": "attn_q.weight",
    "self_attn.k_proj.weight": "attn_k.weight",
    "self_attn.v_proj.weight": "attn_v.weight",
    "self_attn.q_proj.bias": "attn_q.bias",
    "self_attn.k_proj.bias": "attn_k.bias",
    "self_attn.v_proj.bias": "attn_v.bias",
    "self_attn.o_proj.weight": "attn_output.weight",
    "post_attention_layernorm.weight": "ffn_norm.weight",
    "mlp.gate_proj.weight": "ffn_gate.weight",
    "mlp.up_proj.weight": "ffn_up.weight",
    "mlp.down_proj.weight": "ffn_down.weight",
}
LLAMA_FAMILY = ("llama", "qwen2", "qwen3", "mistral")
# archs whose llama.cpp converter permutes the Q/K rows (ROADMAP C5)
_PERMUTED_ARCHS = ("llama", "mistral")


def _gguf_name(hf_name: str) -> str:
    if hf_name in _NAME_MAP:
        return _NAME_MAP[hf_name]
    if hf_name.startswith("model.layers."):
        rest = hf_name[len("model.layers."):]
        idx, leaf = rest.split(".", 1)
        return f"blk.{idx}.{_LAYER_MAP[leaf]}"
    raise KeyError(hf_name)


def config_from_gguf(g) -> LlamaConfig:
    arch = g.architecture
    m = g.metadata

    def key(suffix, default=None):
        return m.get(f"{arch}.{suffix}", default)

    n_head = int(key("attention.head_count"))
    emb = int(key("embedding_length"))
    return LlamaConfig(
        num_hidden_layers=int(key("block_count")),
        num_attention_heads=n_head,
        num_key_value_heads=int(key("attention.head_count_kv", n_head)),
        hidden_size=emb,
        intermediate_size=int(key("feed_forward_length")),
        vocab_size=int(key("vocab_size",
                           len(m.get("tokenizer.ggml.tokens", [])))),
        max_position_embeddings=int(key("context_length", 8192)),
        rms_norm_eps=float(key("attention.layer_norm_rms_epsilon", 1e-5)),
        rope_theta=float(key("rope.freq_base", 10000.0)),
        attention_bias=(arch == "qwen2"),
        head_dim=(int(key("attention.key_length"))
                  if key("attention.key_length") else None),
        model_type=arch,
        tie_word_embeddings=("output.weight" not in g.tensors),
    )


_GEMMA1_LAYER_MAP = {
    "input_layernorm.weight": "attn_norm.weight",
    "self_attn.q_proj.weight": "attn_q.weight",
    "self_attn.k_proj.weight": "attn_k.weight",
    "self_attn.v_proj.weight": "attn_v.weight",
    "self_attn.o_proj.weight": "attn_output.weight",
    # gemma1 has a single pre-FFN norm: HF post_attention_layernorm
    "post_attention_layernorm.weight": "ffn_norm.weight",
    "mlp.gate_proj.weight": "ffn_gate.weight",
    "mlp.up_proj.weight": "ffn_up.weight",
    "mlp.down_proj.weight": "ffn_down.weight",
}
_GEMMA2_LAYER_MAP = {
    **_GEMMA1_LAYER_MAP,
    # gemma2's 4-norm sandwich (llama.cpp names)
    "post_attention_layernorm.weight": "post_attention_norm.weight",
    "pre_feedforward_layernorm.weight": "ffn_norm.weight",
    "post_feedforward_layernorm.weight": "post_ffw_norm.weight",
}


def _gguf_name_gemma(hf_name: str, gemma2: bool) -> str:
    if hf_name in _NAME_MAP:
        return _NAME_MAP[hf_name]
    if hf_name.startswith("model.layers."):
        rest = hf_name[len("model.layers."):]
        idx, leaf = rest.split(".", 1)
        lmap = _GEMMA2_LAYER_MAP if gemma2 else _GEMMA1_LAYER_MAP
        return f"blk.{idx}.{lmap[leaf]}"
    raise KeyError(hf_name)


def gemma_config_from_gguf(g):
    from .gemma import GemmaConfig

    arch = g.architecture
    m = g.metadata

    def key(suffix, default=None):
        return m.get(f"{arch}.{suffix}", default)

    n_head = int(key("attention.head_count"))
    emb = int(key("embedding_length"))
    soft_a = key("attn_logit_softcapping")
    soft_f = key("final_logit_softcapping")
    return GemmaConfig(
        num_hidden_layers=int(key("block_count")),
        num_attention_heads=n_head,
        num_key_value_heads=int(key("attention.head_count_kv", 1)),
        hidden_size=emb,
        intermediate_size=int(key("feed_forward_length")),
        vocab_size=int(key("vocab_size",
                           len(m.get("tokenizer.ggml.tokens", [])))),
        max_position_embeddings=int(key("context_length", 8192)),
        rms_norm_eps=float(key("attention.layer_norm_rms_epsilon", 1e-6)),
        rope_theta=float(key("rope.freq_base", 10000.0)),
        head_dim=int(key("attention.key_length") or emb // n_head),
        attn_logit_softcapping=float(soft_a) if soft_a else None,
        final_logit_softcapping=float(soft_f) if soft_f else None,
        gemma2=(arch == "gemma2"),
        model_type=arch,
    )


_PHI3_LAYER_MAP = {
    "self_attn.qkv_proj.weight": "attn_qkv.weight",
    "self_attn.o_proj.weight": "attn_output.weight",
    "mlp.gate_up_proj.weight": "ffn_up.weight",     # gguf fuses gate+up
    "mlp.down_proj.weight": "ffn_down.weight",
    "input_layernorm.weight": "attn_norm.weight",
    "post_attention_layernorm.weight": "ffn_norm.weight",
}


def _gguf_name_phi3(hf_name: str) -> str:
    if hf_name in _NAME_MAP:
        return _NAME_MAP[hf_name]
    if hf_name.startswith("model.layers."):
        rest = hf_name[len("model.layers."):]
        idx, leaf = rest.split(".", 1)
        return f"blk.{idx}.{_PHI3_LAYER_MAP[leaf]}"
    raise KeyError(hf_name)


def _row_order(n_head: int, hd: int) -> np.ndarray:
    """Row r of the un-permuted weight is row order[r] of the llama.cpp
    file: the inverse of reshape(n_head, 2, hd / 2, K).swapaxes(1, 2)."""
    return np.arange(n_head * hd).reshape(n_head, hd // 2, 2) \
        .swapaxes(1, 2).reshape(-1)


def _unpermute(t, n_head: int, hd: int):
    """Undo llama.cpp's Q/K row permutation on a GGUF-oriented (N, K)
    tensor: a dense array, or a PackedTensor by whole rows of blocks."""
    order = _row_order(n_head, hd)
    if isinstance(t, PackedTensor):
        N = t.shape[0]
        rows = np.frombuffer(t.data, dtype=np.uint8).reshape(N, -1)
        return PackedTensor(np.ascontiguousarray(rows[order]).tobytes(),
                            t.fmt, t.shape)
    return np.ascontiguousarray(np.asarray(t)[order])


class _Source:
    """The GGUF tensors of one file under HF names, un-permuted where
    llama.cpp permuted them."""

    def __init__(self, g, cfg: LlamaConfig):
        self.g, self.cfg = g, cfg
        self.permuted = g.architecture in _PERMUTED_ARCHS

    def resolve(self, hf_name: str) -> str:
        if hf_name == "lm_head.weight" and self.cfg.tie_word_embeddings:
            hf_name = "model.embed_tokens.weight"
        return _gguf_name(hf_name)

    def heads(self, hf_name: str) -> Optional[int]:
        """The head count llama.cpp permuted this tensor's rows by."""
        if not self.permuted:
            return None
        if hf_name.endswith("self_attn.q_proj.weight"):
            return self.cfg.num_attention_heads
        if hf_name.endswith("self_attn.k_proj.weight"):
            return self.cfg.num_key_value_heads
        return None

    def load(self, hf_name: str):
        """NumericTensor or PackedTensor, HF row order."""
        t = self.g.load(self.resolve(hf_name))
        nh = self.heads(hf_name)
        if nh is None:
            return t
        if isinstance(t, PackedTensor):
            return _unpermute(t, nh, self.cfg.hd)
        return NumericTensor.from_numpy(_unpermute(t.numpy(), nh,
                                                   self.cfg.hd))

    def dense(self, hf_name: str) -> np.ndarray:
        """f32 (floats) host array, HF orientation."""
        return _dense(self.load(hf_name))


def _dense(t) -> np.ndarray:
    """A GGUF tensor as a host array: packed blocks dequantized to f32,
    floats widened to f32."""
    if isinstance(t, PackedTensor):
        return t.dequantize(DType.F32).numpy()
    arr = t.numpy()
    return arr.astype(np.float32) if arr.dtype.kind == "f" else arr


def _llama_family(g) -> LlamaConfig:
    if g.architecture not in LLAMA_FAMILY:
        raise ValueError(
            f"packed path supports llama-family ggufs, not "
            f"{g.architecture!r}")
    return config_from_gguf(g)


def build_from_gguf(g, max_len: int, dtype: DType = DType.BF16,
                    pos_per_row: bool = False, storage=None,
                    zeros: bool = False) -> Tuple[bytes, Dict]:
    """Every weight dequantized on the host and embedded in the ONNX
    (under `storage`, default WeightStorage.embed()). Arch gemma, gemma2
    and phi3 go through their own recipes, as in the reference
    (:162-222); they have no per-row position (ValueError).

    zeros=True builds a structure-only graph: shape-faithful zero
    weights from the tensor infos, no tensor loaded or dequantized, for
    a decode window's graph that shares the main model's TensorStore
    (the loader's `decode_windows`)."""
    def zero(gname: str) -> np.ndarray:
        return np.zeros(tuple(g.tensors[gname].shape), dtype=np.float32)

    if g.architecture in ("gemma", "gemma2"):
        from .gemma import build_gemma_step

        if pos_per_row:
            raise ValueError("ragged decode not supported for gguf gemma yet")
        gcfg = gemma_config_from_gguf(g)
        gemma2 = g.architecture == "gemma2"

        def getter_g(hf_name: str) -> np.ndarray:
            # gemma always ties the LM head to the embedding
            if hf_name == "lm_head.weight":
                hf_name = "model.embed_tokens.weight"
            gname = _gguf_name_gemma(hf_name, gemma2)
            if zeros:
                return zero(gname)
            arr = _dense(g.load(gname))
            # the HF->GGUF converter bakes gemma's "+1" into every norm
            # weight; the recipe adds it back, so un-bake here
            if (hf_name.endswith("layernorm.weight")
                    or hf_name == "model.norm.weight"):
                arr = arr - 1.0
            return arr

        data = build_gemma_step(getter_g, gcfg, max_len=max_len, dtype=dtype,
                                storage=storage)
        return data, dict(n_layers=gcfg.num_hidden_layers,
                          n_kv_heads=gcfg.num_key_value_heads,
                          head_dim=gcfg.hd)
    if g.architecture == "phi3":
        from .phi3 import Phi3Config, build_phi3_step

        if pos_per_row:
            raise ValueError("ragged decode not supported for gguf phi3 yet")
        cfg = Phi3Config(**{**config_from_gguf(g).__dict__,
                            "model_type": "phi3", "attention_bias": False})

        def getter3(hf_name: str) -> np.ndarray:
            if hf_name == "lm_head.weight" and cfg.tie_word_embeddings:
                hf_name = "model.embed_tokens.weight"
            gname = _gguf_name_phi3(hf_name)
            return zero(gname) if zeros else _dense(g.load(gname))

        data = build_phi3_step(getter3, cfg, max_len=max_len, dtype=dtype,
                               storage=storage)
        return data, dict(n_layers=cfg.num_hidden_layers,
                          n_kv_heads=cfg.num_key_value_heads,
                          head_dim=cfg.hd)
    cfg = _llama_family(g)
    src = _Source(g, cfg)

    def getter(hf_name: str) -> np.ndarray:
        return zero(src.resolve(hf_name)) if zeros else src.dense(hf_name)

    data = build_llama_step(getter, cfg, max_len=max_len, dtype=dtype,
                            pos_per_row=pos_per_row, storage=storage)
    geometry = dict(n_layers=cfg.num_hidden_layers,
                    n_kv_heads=cfg.num_key_value_heads, head_dim=cfg.hd)
    return data, geometry


def build_from_gguf_packed(g, max_len: int, dtype: DType = DType.BF16,
                           pos_per_row: bool = False
                           ) -> Tuple[bytes, Dict, Dict]:
    """Like build_from_gguf, but big matmul weights are NEVER
    dequantized on host: the graph serializes without their payloads,
    and the returned `store_entries` bind each matmul weight name to (a)
    a lazy dense transposed-dequant fallback and (b) a packed source for
    the packed_matmul kernel (milli.transforms.pack_matmul_nodes).

    Returns (onnx_bytes, geometry, store_entries) where store_entries =
    {name: {"value": array}} for small weights and {name: {"lazy":
    zero-arg dense loader, "packed": zero-arg PackedTensor loader or
    None}} for matmul weights."""
    from ....backends.cuda.packed_matmul import SUPPORTED
    from ...onnx_builder import WeightStorage

    cfg = _llama_family(g)
    src = _Source(g, cfg)

    def is_lazy_big(hf_name: str) -> bool:
        # matmul-RHS weights routed through the recipe's weight_map
        return hf_name.endswith(".weight") and (
            "self_attn." in hf_name or "mlp." in hf_name
            or hf_name == "lm_head.weight")

    def getter(hf_name: str) -> np.ndarray:
        if is_lazy_big(hf_name):
            # shape-faithful zeros (calloc — no pages committed, no
            # dequantization); the payload is never serialized
            info = g.tensors[src.resolve(hf_name)]
            return np.zeros(tuple(info.shape), dtype=np.float32)
        return src.dense(hf_name)

    weight_map: Dict[str, str] = {}
    sink: Dict[str, np.ndarray] = {}
    data = build_llama_step(getter, cfg, max_len=max_len, dtype=dtype,
                            pos_per_row=pos_per_row,
                            storage=WeightStorage.to_sink(sink),
                            weight_map=weight_map)

    # sink holds every initializer VALUE (small tensors real; matmul
    # weights as shape-only zeros). Matmul weights get lazy loaders
    # instead; everything else installs as-is.
    store_entries: Dict[str, Dict] = {}
    for init_name, val in sink.items():
        if init_name not in weight_map:
            store_entries[init_name] = {"value": np.asarray(val)}
            continue
        hf_name = weight_map[init_name]
        info = g.tensors[src.resolve(hf_name)]

        def dense_loader(hf_name=hf_name):
            return transposed(src.dense(hf_name))

        packed_loader = None
        if info.packed is not None and info.packed in SUPPORTED \
                and len(info.shape) == 2:
            def packed_loader(hf_name=hf_name):
                return src.load(hf_name)
        store_entries[init_name] = {"lazy": dense_loader,
                                    "packed": packed_loader}
    geometry = dict(n_layers=cfg.num_hidden_layers,
                    n_kv_heads=cfg.num_key_value_heads, head_dim=cfg.hd)
    return data, geometry, store_entries
