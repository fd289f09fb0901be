"""GPT-2 import recipe: HF weights -> ONNX with fixed-shape KV caches.

Reference equivalent: the per-arch LLM recipes in
crates/whisper-tensor-import/src/models/llm/ (llama3.rs etc.) which emit
ONNX with concat-grow KV-cache I/O. TPU redesign: one unified "step"
graph with FIXED-size cache buffers (B, H, MAX, D) + a scalar position.
Prefill (S=prompt bucket) and decode (S=1) are the same graph at
different S; every shape is static, so the whole step jits once and the
caches are donated buffers updated in place via CacheWrite
(DynamicUpdateSlice). Masking makes unwritten cache slots inert.

The port's copy of whisper_tensor_tpu/importers/recipes/llm/gpt2.py,
with the training graph
(`build_gpt2_train`, :223-284). The `weight_map` out-parameter
records {initializer name: HF name} of the matmul weights, which
GPTQ/AWQ packed sources and PEFT adapter serving resolve against.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from ....dtype import DType
from ...onnx_builder import OnnxBuilder, WeightStorage
from . import transposed


class GPT2Config:
    def __init__(self, n_layer=12, n_head=12, n_embd=768, vocab_size=50257,
                 n_positions=1024, layer_norm_epsilon=1e-5):
        self.n_layer = n_layer
        self.n_head = n_head
        self.n_embd = n_embd
        self.vocab_size = vocab_size
        self.n_positions = n_positions
        self.layer_norm_epsilon = layer_norm_epsilon

    @staticmethod
    def from_hf(cfg) -> "GPT2Config":
        return GPT2Config(cfg["n_layer"], cfg["n_head"], cfg["n_embd"],
                          cfg["vocab_size"], cfg.get("n_positions", 1024),
                          cfg.get("layer_norm_epsilon", 1e-5))


def build_gpt2_step(weights: Callable[[str], np.ndarray], cfg: GPT2Config,
                    max_len: int, dtype: DType = DType.F32,
                    pos_per_row: bool = False,
                    weight_map: Optional[dict] = None,
                    storage: Optional[WeightStorage] = None) -> bytes:
    """Build the unified step graph.

    weights(name) returns HF GPT-2 state-dict arrays
    (transformer.wte.weight, transformer.h.{i}.attn.c_attn.weight, ...).
    HF GPT-2 Conv1D weights are (in, out) — used directly as matmul RHS.

    Graph I/O:
      inputs : input_ids (B,S) i64, pos () i64,
               cache_k_{i}/cache_v_{i} (B,H,MAX,D)
      outputs: logits (B,S,V), new_cache_k_{i}/new_cache_v_{i}

    pos_per_row=True makes `pos` shape (batch,): each row decodes at its
    own offset (ragged continuous batching; reference serving seam
    crates/whisper-tensor-server/src/scheduler.rs:424-717).
    """
    E, H, L, V = cfg.n_embd, cfg.n_head, cfg.n_layer, cfg.vocab_size
    D = E // H
    np_dt = dtype.to_numpy()

    def w(name: str) -> np.ndarray:
        return np.asarray(weights(name)).astype(np_dt)

    def lin(init_name: str, hf_name: str) -> str:
        # matmul-RHS weight (HF Conv1D (in, out), used directly);
        # weight_map records the mapping for PEFT adapter resolution
        if weight_map is not None:
            weight_map[init_name] = hf_name
        return b.initializer(init_name, w(hf_name))

    b = OnnxBuilder("gpt2_step", opset=23, custom_opsets={"wt": 1})
    ids = b.input("input_ids", DType.I64, ["batch", "seq"])
    pos = b.input("pos", DType.I64, ["batch"] if pos_per_row else [])
    cache_ins = []
    for i in range(L):
        cache_ins.append((
            b.input(f"cache_k_{i}", dtype, ["batch", H, max_len, D]),
            b.input(f"cache_v_{i}", dtype, ["batch", H, max_len, D])))

    wte = b.initializer("wte", w("transformer.wte.weight"))        # (V, E)
    wpe = b.initializer("wpe", w("transformer.wpe.weight"))        # (P, E)

    # x = wte[ids] + wpe[pos + arange(S)]
    tok = b.gather(wte, ids)                                       # (B,S,E)
    seq_shape = b.node("Shape", [ids], start=1, end=2)             # [S]
    s_scalar = b.node("Squeeze", [seq_shape, b.const_i64([0])])
    zero = b.const_i64(0)
    one = b.const_i64(1)
    positions = b.node("Range", [zero, s_scalar, one])             # (S,) static under jit? S static, but values 0..S
    if pos_per_row:
        pos_b = b.node("Unsqueeze", [pos, b.const_i64([1])])       # (B,1)
        abs_pos = b.add(positions, pos_b)                          # (B,S)
    else:
        abs_pos = b.add(positions, b.node("Cast", [pos], to=7))    # (S,) + () i64
    pemb = b.gather(wpe, abs_pos)                             # (S,E)|(B,S,E)
    x = b.add(tok, pemb)

    # attention mask: slot m visible to query s iff m <= pos + s
    if pos_per_row:
        # rank-1 position mask (wt Attention extension) — same
        # visibility as the dense (B,1,S,MAX) Where mask, but the TPU
        # backend can dispatch the ragged flash-decode kernel on it
        mask = pos
    else:
        mrange = b.node("Range", [zero, b.const_i64(max_len), one])  # (MAX,)
        q_abs = b.node("Unsqueeze", [abs_pos, b.const_i64([1])])   # (S,1)
        m2 = b.node("Unsqueeze", [mrange, b.const_i64([0])])       # (1,MAX)
        vis = b.node("LessOrEqual", [m2, q_abs])
        big_neg = b.const(np.asarray(-1e30, dtype=np.float32))
        zero_f = b.const(np.asarray(0.0, dtype=np.float32))
        mask = b.node("Where", [vis, zero_f, big_neg])
        mask = b.node("Unsqueeze", [mask, b.const_i64([0, 1])])    # (1,1,S,MAX)
        if dtype is not DType.F32:
            mask = b.cast(mask, dtype)

    eps = cfg.layer_norm_epsilon
    cache_outs = []
    for i in range(L):
        p = f"transformer.h.{i}."
        ln1 = b.layer_norm(x, b.initializer(f"ln1g_{i}", w(p + "ln_1.weight")),
                           b.initializer(f"ln1b_{i}", w(p + "ln_1.bias")),
                           epsilon=eps)
        qkv = b.add(b.matmul(ln1, lin(f"wqkv_{i}", p + "attn.c_attn.weight")),
                    b.initializer(f"bqkv_{i}", w(p + "attn.c_attn.bias")))
        q, k, v = b.node("Split", [qkv], n_outputs=3, axis=-1, num_outputs=3)

        def heads(t):
            t = b.reshape(t, [0, 0, H, D])
            return b.transpose(t, [0, 2, 1, 3])                    # (B,H,S,D)

        qh, kh, vh = heads(q), heads(k), heads(v)
        ck, cv = cache_ins[i]
        nk = b.node("CacheWrite", [ck, kh, pos], axis=2, domain="wt",
                    outputs=[f"new_cache_k_{i}"])
        nv = b.node("CacheWrite", [cv, vh, pos], axis=2, domain="wt",
                    outputs=[f"new_cache_v_{i}"])
        cache_outs.append((nk, nv))
        att = b.attention(qh, nk, nv, mask=mask, scale=1.0 / float(np.sqrt(D)))
        att = b.reshape(b.transpose(att, [0, 2, 1, 3]), [0, 0, E])
        att = b.add(b.matmul(att, lin(f"wproj_{i}", p + "attn.c_proj.weight")),
                    b.initializer(f"bproj_{i}", w(p + "attn.c_proj.bias")))
        x = b.add(x, att)

        ln2 = b.layer_norm(x, b.initializer(f"ln2g_{i}", w(p + "ln_2.weight")),
                           b.initializer(f"ln2b_{i}", w(p + "ln_2.bias")),
                           epsilon=eps)
        hmid = b.add(b.matmul(ln2, lin(f"wfc_{i}", p + "mlp.c_fc.weight")),
                     b.initializer(f"bfc_{i}", w(p + "mlp.c_fc.bias")))
        hmid = b.node("Gelu", [hmid], approximate="tanh")
        mlp = b.add(b.matmul(hmid, lin(f"wmp_{i}", p + "mlp.c_proj.weight")),
                    b.initializer(f"bmp_{i}", w(p + "mlp.c_proj.bias")))
        x = b.add(x, mlp)

    xf = b.layer_norm(x, b.initializer("lnfg", w("transformer.ln_f.weight")),
                      b.initializer("lnfb", w("transformer.ln_f.bias")),
                      epsilon=eps)
    # tied lm head: logits = xf @ wte^T
    wte_t = b.initializer("wte_t", transposed(w("transformer.wte.weight")))
    logits = b.node("MatMul", [xf, wte_t], outputs=["logits"])
    b.output("logits", dtype, ["batch", "seq", V])
    for i, (nk, nv) in enumerate(cache_outs):
        b.output(nk, dtype, ["batch", H, max_len, D])
        b.output(nv, dtype, ["batch", H, max_len, D])
    return b.build(storage or WeightStorage.embed())


def hf_gpt2_weight_getter(model) -> Callable[[str], np.ndarray]:
    """Weight getter over a torch transformers GPT2LMHeadModel."""
    sd = model.state_dict()

    def get(name: str) -> np.ndarray:
        return sd[name].detach().cpu().numpy()

    return get


def random_gpt2_weights(cfg: GPT2Config, seed: int = 0) -> Callable[[str], np.ndarray]:
    """HF-layout random weights without torch (for benches/smoke tests)."""
    rng = np.random.default_rng(seed)
    E, V, P = cfg.n_embd, cfg.vocab_size, cfg.n_positions

    def make(name: str) -> np.ndarray:
        if name == "transformer.wte.weight":
            return (rng.standard_normal((V, E)) * 0.02).astype(np.float32)
        if name == "transformer.wpe.weight":
            return (rng.standard_normal((P, E)) * 0.01).astype(np.float32)
        parts = name.split(".")
        leaf = ".".join(parts[-2:])
        shapes = {
            "ln_1.weight": (E,), "ln_1.bias": (E,),
            "ln_2.weight": (E,), "ln_2.bias": (E,),
            "ln_f.weight": (E,), "ln_f.bias": (E,),
            "c_attn.weight": (E, 3 * E), "c_attn.bias": (3 * E,),
            "c_proj.weight": None,  # depends on attn vs mlp
            "c_proj.bias": None,
            "c_fc.weight": (E, 4 * E), "c_fc.bias": (4 * E,),
        }
        if leaf == "c_proj.weight":
            shape = (4 * E, E) if "mlp" in name else (E, E)
        elif leaf == "c_proj.bias":
            shape = (E,)
        else:
            shape = shapes[leaf]
        if leaf.endswith("weight") and len(shape) == 2:
            return (rng.standard_normal(shape) * 0.02).astype(np.float32)
        if leaf in ("ln_1.weight", "ln_2.weight", "ln_f.weight"):
            return np.ones(shape, dtype=np.float32)
        return np.zeros(shape, dtype=np.float32)

    cache: Dict[str, np.ndarray] = {}

    def get(name: str) -> np.ndarray:
        if name not in cache:
            cache[name] = make(name)
        return cache[name]

    return get


def build_gpt2_train(weights: Callable[[str], np.ndarray], cfg: GPT2Config,
                     dtype: DType = DType.F32,
                     storage: Optional[WeightStorage] = None,
                     weight_map: Optional[dict] = None) -> bytes:
    """Training-mode graph: input_ids (B,S) -> logits (B,S,V).

    No KV caches; causal fused attention. Every weight stays a runtime
    input (> CONST_BAKE threshold not required: recipes always route
    weights through the TensorStore), so jax.grad over the traced milli
    graph differentiates w.r.t. the weight inputs directly.
    """
    E, H, L, V = cfg.n_embd, cfg.n_head, cfg.n_layer, cfg.vocab_size
    D = E // H
    np_dt = dtype.to_numpy()

    def w(name: str) -> np.ndarray:
        return np.asarray(weights(name)).astype(np_dt)

    def lin(init_name: str, hf_name: str) -> str:
        if weight_map is not None:
            weight_map[init_name] = hf_name
        return b.initializer(init_name, w(hf_name))

    b = OnnxBuilder("gpt2_train", opset=23)
    ids = b.input("input_ids", DType.I64, ["batch", "seq"])
    wte = b.initializer("wte", w("transformer.wte.weight"))
    wpe = b.initializer("wpe", w("transformer.wpe.weight"))
    tok = b.gather(wte, ids)
    seq_shape = b.node("Shape", [ids], start=1, end=2)
    s_scalar = b.node("Squeeze", [seq_shape, b.const_i64([0])])
    positions = b.node("Range", [b.const_i64(0), s_scalar, b.const_i64(1)])
    x = b.add(tok, b.gather(wpe, positions))
    eps = cfg.layer_norm_epsilon
    for i in range(L):
        p = f"transformer.h.{i}."
        ln1 = b.layer_norm(x, b.initializer(f"ln1g_{i}", w(p + "ln_1.weight")),
                           b.initializer(f"ln1b_{i}", w(p + "ln_1.bias")), epsilon=eps)
        qkv = b.add(b.matmul(ln1, lin(f"wqkv_{i}", p + "attn.c_attn.weight")),
                    b.initializer(f"bqkv_{i}", w(p + "attn.c_attn.bias")))
        q, k, v = b.node("Split", [qkv], n_outputs=3, axis=-1, num_outputs=3)

        def heads(t):
            return b.transpose(b.reshape(t, [0, 0, H, D]), [0, 2, 1, 3])

        att = b.attention(heads(q), heads(k), heads(v),
                          scale=1.0 / float(np.sqrt(D)), is_causal=True)
        att = b.reshape(b.transpose(att, [0, 2, 1, 3]), [0, 0, E])
        att = b.add(b.matmul(att, lin(f"wproj_{i}", p + "attn.c_proj.weight")),
                    b.initializer(f"bproj_{i}", w(p + "attn.c_proj.bias")))
        x = b.add(x, att)
        ln2 = b.layer_norm(x, b.initializer(f"ln2g_{i}", w(p + "ln_2.weight")),
                           b.initializer(f"ln2b_{i}", w(p + "ln_2.bias")), epsilon=eps)
        hmid = b.add(b.matmul(ln2, lin(f"wfc_{i}", p + "mlp.c_fc.weight")),
                     b.initializer(f"bfc_{i}", w(p + "mlp.c_fc.bias")))
        hmid = b.node("Gelu", [hmid], approximate="tanh")
        mlp = b.add(b.matmul(hmid, lin(f"wmp_{i}", p + "mlp.c_proj.weight")),
                    b.initializer(f"bmp_{i}", w(p + "mlp.c_proj.bias")))
        x = b.add(x, mlp)
    xf = b.layer_norm(x, b.initializer("lnfg", w("transformer.ln_f.weight")),
                      b.initializer("lnfb", w("transformer.ln_f.bias")), epsilon=eps)
    wte_t = b.initializer("wte_t", transposed(w("transformer.wte.weight")))
    b.node("MatMul", [xf, wte_t], outputs=["logits"])
    b.output("logits", dtype, ["batch", "seq", V])
    return b.build(storage or WeightStorage.embed())
