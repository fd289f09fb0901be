"""RWKV-7 import recipe: constant-state linear recurrence (no attention).

Reference equivalent: crates/whisper-tensor-import/src/models/llm/
rwkv7.rs (architecture spec re-derived from its graph construction; see
file:120-424). Single-token step graph:

  inputs : token (B,) i64, per layer: tmix_x_{i} (B,E),
           vk_state_{i} (B,H,D,D) f32, cmix_x_{i} (B,E)
  outputs: logits (B,V), new_tmix_x_{i}, new_vk_state_{i}, new_cmix_x_{i}

Per layer (head dim D = E/H):
  dx    = x_prev - ln1(x)
  *_lerp = ln1(x) + dx * x_{r,w,k,v,a,g}
  r,k,v = linear(receptance/key/value)(lerps)
  v0 threading: layer 0 keeps v; later layers v = lerp(v, v0,
      sigmoid(lora_v(value_lerp)))
  gate  = sigmoid(g_lerp @ g1) @ g2
  decay = exp(-0.606531 * sigmoid(tanh(w_lerp @ w1) @ w2 + w0))   [f32]
  kappa = l2_normalize_per_head(k * k_k)
  iclr  = sigmoid(a_lerp @ a1 @ a2 + a0)
  k     = lerp(k, k * iclr, k_a)
  S     = S * decay^T - (S @ kappa)(iclr * kappa)^T + v @ k^T     [f32]
  out   = groupnorm_heads(S @ r) ; bonus = sum(r*k*r_k)_head * v
  x    += linear(output)((out + bonus) * gate)
  channel mix: k2 = lerp(ln2(x), cmix_prev, ffn.x_k);
  x += linear(value)(relu(linear(key)(k2))^2)

The port's copy of whisper_tensor_tpu/importers/recipes/llm/rwkv7.py,
unchanged (the same ONNX bytes). The step has no attention: its
products are MatMuls, which `quantize="int8"` would send to
int8_matmul; the rest is torch elementwise work on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np

from ....dtype import DType
from ...onnx_builder import OnnxBuilder, WeightStorage
from . import transposed


@dataclass
class Rwkv7Config:
    n_layer: int
    n_embd: int
    n_head: int
    vocab_size: int
    lora_w: int = 64
    lora_a: int = 64
    lora_v: int = 32
    lora_g: int = 128


def rwkv7_config_from_sd(sd: Dict[str, np.ndarray]) -> Rwkv7Config:
    n_layer = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    V, E = sd["emb.weight"].shape
    H = sd["blocks.0.att.r_k"].shape[0]
    return Rwkv7Config(
        n_layer=n_layer, n_embd=E, n_head=H, vocab_size=V,
        lora_w=sd["blocks.0.att.w1"].shape[1],
        lora_a=sd["blocks.0.att.a1"].shape[1],
        lora_v=(sd["blocks.1.att.v1"].shape[1] if n_layer > 1 else 32),
        lora_g=sd["blocks.0.att.g1"].shape[1])


def build_rwkv7_step(weights: Callable[[str], np.ndarray], cfg: Rwkv7Config,
                     dtype: DType = DType.F32,
                     storage: Optional[WeightStorage] = None) -> bytes:
    E, H, V, L = cfg.n_embd, cfg.n_head, cfg.vocab_size, cfg.n_layer
    D = E // H
    np_dt = dtype.to_numpy()

    b = OnnxBuilder("rwkv7_step", opset=23)

    def w(name, flatten=False):
        arr = np.asarray(weights(name)).astype(np.float32)
        if flatten:
            arr = arr.reshape(-1)
        return b.initializer(name.replace(".", "_"), arr.astype(np_dt))

    def wT(name):
        arr = np.asarray(weights(name)).astype(np.float32)
        return b.initializer(name.replace(".", "_") + "_T",
                             transposed(arr).astype(np_dt))

    def linear(x, name):
        return b.matmul(x, wT(name + ".weight"))

    def layer_norm(x, name):
        return b.layer_norm(x, w(name + ".weight"), w(name + ".bias"),
                            epsilon=1e-5)

    def lerp(a, c, t):
        return b.add(a, b.mul(b.node("Sub", [c, a]), t))

    tok = b.input("token", DType.I64, ["batch"])
    states_out = []

    x = b.gather(w("emb.weight"), tok)          # (B, E)
    x = layer_norm(x, "blocks.0.ln0")
    v0 = None
    for i in range(L):
        p = f"blocks.{i}."
        tmix_in = b.input(f"tmix_x_{i}", dtype, ["batch", E])
        vk_in = b.input(f"vk_state_{i}", DType.F32, ["batch", H, D, D])
        after_ln1 = layer_norm(x, p + "ln1")
        states_out.append((f"new_tmix_x_{i}", after_ln1, ["batch", E], dtype))
        dx = b.node("Sub", [tmix_in, after_ln1])

        def mix(which):
            return b.add(after_ln1, b.mul(dx, w(p + f"att.x_{which}", flatten=True)))

        r = linear(mix("r"), p + "att.receptance")
        k = linear(mix("k"), p + "att.key")
        value_lerp = mix("v")
        v = linear(value_lerp, p + "att.value")
        if v0 is None:
            v0 = v
        else:
            v0_mix = b.add(b.matmul(b.matmul(value_lerp, w(p + "att.v1")),
                                    w(p + "att.v2")),
                           w(p + "att.v0", flatten=True))
            v = lerp(v, v0, b.node("Sigmoid", [v0_mix]))
        gate = b.matmul(b.node("Sigmoid", [b.matmul(mix("g"), w(p + "att.g1"))]),
                        w(p + "att.g2"))
        llld = b.add(b.matmul(b.node("Tanh", [b.matmul(mix("w"), w(p + "att.w1"))]),
                              w(p + "att.w2")),
                     w(p + "att.w0", flatten=True))
        if dtype is not DType.F32:
            llld = b.cast(llld, DType.F32)
        cdec = b.const(np.asarray(-0.606531, dtype=np.float32))
        decay = b.node("Exp", [b.mul(cdec, b.node("Sigmoid", [llld]))])  # (B,E) f32

        kappa = b.mul(k, w(p + "att.k_k", flatten=True))
        kappa = b.reshape(kappa, [0, H, D])
        kappa = b.node("LpNormalization", [kappa], axis=-1, p=2)
        iclr = b.node("Sigmoid", [
            b.add(b.matmul(b.matmul(mix("a"), w(p + "att.a1")), w(p + "att.a2")),
                  w(p + "att.a0", flatten=True))])
        k = lerp(k, b.mul(k, iclr), w(p + "att.k_a", flatten=True))

        # state update in f32, column-vector convention (B,H,D,1)
        def col(t, cast_f32=True):
            t2 = b.reshape(t, [0, H, D, 1])
            return b.cast(t2, DType.F32) if (cast_f32 and dtype is not DType.F32) else t2

        r_c = col(r)
        k_c = col(k)
        v_c = col(v)
        iclr_c = col(iclr)
        kap_c = b.node("Unsqueeze", [kappa, b.const_i64([3])])
        if dtype is not DType.F32:
            kap_c = b.cast(kap_c, DType.F32)
        dec_c = b.reshape(decay, [0, H, D, 1])
        t_decay = b.transpose(dec_c, [0, 1, 3, 2])                 # (B,H,1,D)
        temp = b.transpose(b.mul(iclr_c, kap_c), [0, 1, 3, 2])     # (B,H,1,D)
        temp2 = b.matmul(vk_in, kap_c)                              # (B,H,D,1)
        S = b.node("Sub", [b.mul(vk_in, t_decay), b.matmul(temp2, temp)])
        S = b.add(S, b.matmul(v_c, b.transpose(k_c, [0, 1, 3, 2])))
        states_out.append((f"new_vk_state_{i}", S, ["batch", H, D, D], DType.F32))
        out = b.matmul(S, r_c)                                      # (B,H,D,1)
        out = b.reshape(out, [0, E])
        if dtype is not DType.F32:
            out = b.cast(out, dtype)
        out = b.node("GroupNormalization",
                     [out, w(p + "att.ln_x.weight"), w(p + "att.ln_x.bias")],
                     num_groups=H, epsilon=1e-5 * D)

        bonus = b.reshape(b.mul(r, k), [0, H, D])
        bonus = b.mul(bonus, w(p + "att.r_k"))
        bonus = b.node("ReduceSum", [bonus, b.const_i64([-1])], keepdims=1)  # (B,H,1)
        bonus = b.reshape(b.mul(bonus, b.reshape(v, [0, H, D])), [0, E])
        out = b.mul(b.add(bonus, out), gate)
        x = b.add(x, linear(out, p + "att.output"))

        # channel mixing
        after_ln2 = layer_norm(x, p + "ln2")
        cmix_in = b.input(f"cmix_x_{i}", dtype, ["batch", E])
        states_out.append((f"new_cmix_x_{i}", after_ln2, ["batch", E], dtype))
        h = lerp(after_ln2, cmix_in, w(p + "ffn.x_k", flatten=True))
        h = b.node("Relu", [linear(h, p + "ffn.key")])
        h = b.mul(h, h)
        x = b.add(x, linear(h, p + "ffn.value"))

    xf = layer_norm(x, "ln_out")
    b.node("MatMul", [xf, wT("head.weight")], outputs=["logits"])
    b.output("logits", dtype, ["batch", V])
    for name, tid, shape, dt in states_out:
        b.node("Identity", [tid], outputs=[name])
        b.output(name, dt, shape)
    return b.build(storage or WeightStorage.embed())


def random_rwkv7_weights(cfg: Rwkv7Config, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    E, H, V = cfg.n_embd, cfg.n_head, cfg.vocab_size
    D = E // H
    sd: Dict[str, np.ndarray] = {
        "emb.weight": (rng.standard_normal((V, E)) * 0.02).astype(np.float32),
        "ln_out.weight": np.ones(E, np.float32),
        "ln_out.bias": np.zeros(E, np.float32),
        "head.weight": (rng.standard_normal((V, E)) * 0.02).astype(np.float32),
        "blocks.0.ln0.weight": np.ones(E, np.float32),
        "blocks.0.ln0.bias": np.zeros(E, np.float32),
    }
    for i in range(cfg.n_layer):
        p = f"blocks.{i}."
        for ln in ("ln1", "ln2"):
            sd[p + ln + ".weight"] = np.ones(E, np.float32)
            sd[p + ln + ".bias"] = np.zeros(E, np.float32)
        for m in "rwkvag":
            sd[p + f"att.x_{m}"] = rng.uniform(0, 1, (1, 1, E)).astype(np.float32)
        for nm in ("receptance", "key", "value", "output"):
            sd[p + f"att.{nm}.weight"] = (rng.standard_normal((E, E)) / np.sqrt(E)).astype(np.float32)
        sd[p + "att.w0"] = rng.standard_normal((1, 1, E)).astype(np.float32)
        sd[p + "att.w1"] = (rng.standard_normal((E, cfg.lora_w)) * 0.02).astype(np.float32)
        sd[p + "att.w2"] = (rng.standard_normal((cfg.lora_w, E)) * 0.02).astype(np.float32)
        sd[p + "att.a0"] = np.zeros((1, 1, E), np.float32)
        sd[p + "att.a1"] = (rng.standard_normal((E, cfg.lora_a)) * 0.02).astype(np.float32)
        sd[p + "att.a2"] = (rng.standard_normal((cfg.lora_a, E)) * 0.02).astype(np.float32)
        if i > 0:
            sd[p + "att.v0"] = np.zeros((1, 1, E), np.float32)
            sd[p + "att.v1"] = (rng.standard_normal((E, cfg.lora_v)) * 0.02).astype(np.float32)
            sd[p + "att.v2"] = (rng.standard_normal((cfg.lora_v, E)) * 0.02).astype(np.float32)
        sd[p + "att.g1"] = (rng.standard_normal((E, cfg.lora_g)) * 0.02).astype(np.float32)
        sd[p + "att.g2"] = (rng.standard_normal((cfg.lora_g, E)) * 0.02).astype(np.float32)
        sd[p + "att.k_k"] = rng.uniform(0.5, 1, (1, 1, E)).astype(np.float32)
        sd[p + "att.k_a"] = rng.uniform(0, 1, (1, 1, E)).astype(np.float32)
        sd[p + "att.r_k"] = rng.standard_normal((H, D)).astype(np.float32)
        sd[p + "att.ln_x.weight"] = np.ones(E, np.float32)
        sd[p + "att.ln_x.bias"] = np.zeros(E, np.float32)
        sd[p + "ffn.x_k"] = rng.uniform(0, 1, (1, 1, E)).astype(np.float32)
        sd[p + "ffn.key.weight"] = (rng.standard_normal((4 * E, E)) / np.sqrt(E)).astype(np.float32)
        sd[p + "ffn.value.weight"] = (rng.standard_normal((E, 4 * E)) / np.sqrt(4 * E)).astype(np.float32)
    return sd
