"""The PyTorch port stands alone: it imports neither jax nor the JAX
package (whisper_tensor_tpu), at any level.

(a) An AST scan of every module of whisper_tensor_tpu_torch/ and of
    chip_smoke.py: no `import jax...`, and no import of
    `whisper_tensor_tpu` or `whisper_tensor_tpu.<anything>`, top-level
    or nested in a function.
(b) A fresh interpreter writes a tiny llama checkpoint, a GGUF file of
    its weights (the port's write_gguf, Q4_0 blocks) and a GPTQ
    checkpoint of them (the port's pack_gptq), and serves one direct,
    one ragged_decode, one host-quantized q4_0, one GGUF and one GPTQ
    completion through the port's Server and OpenAIApi on the CPU, then
    a regex completion, an embeddings request on the q4_0 model and a
    best_of completion; neither jax nor the JAX package (by exact name
    or the `whisper_tensor_tpu.` prefix) is then in sys.modules.
(c) A fresh interpreter runs one conformance case of every op type the
    port runs through its Model.eval on the CPU, with the same check.
(d) A served image, training, the rest of the text family (DeepSeek
    and RWKV-7 over HTTP, a LLaVA chat with an image, T5 beams), and
    speech (a transcription and a speech request over HTTP, a streaming
    transcription, F5, an LSTM graph), each in a fresh interpreter, with
    the same check.
(e) A raw .onnx file with .bin weights through the Server's `onnx`
    loader and build_program, in a fresh interpreter, with the same
    check.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "whisper_tensor_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "whisper_tensor_tpu")


def _foreign(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imports(tree):
    """(line, module) of every absolute import in the tree."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_nothing_of_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), str(path))
    bad = [(line, mod) for line, mod in _imports(tree) if _foreign(mod)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_scan_sees_nested_imports():
    """The scan finds imports inside functions and the exact package
    name, and leaves the port's own name alone."""
    src = ("def f():\n    import jax.numpy\n"
           "def g():\n    from whisper_tensor_tpu.dtype import DType\n"
           "import whisper_tensor_tpu\n"
           "from whisper_tensor_tpu_torch.dtype import DType\n")
    found = [mod for _, mod in sorted(_imports(ast.parse(src)))
             if _foreign(mod)]
    assert found == ["jax.numpy", "whisper_tensor_tpu.dtype",
                     "whisper_tensor_tpu"]


_SERVE_SCRIPT = r"""
import http.client, json, sys
import numpy as np
from safetensors.numpy import save_file
from pathlib import Path
E, I, V, D = 256, 384, 512, 128
shapes = {"model.embed_tokens.weight": (V, E), "lm_head.weight": (V, E),
          "model.norm.weight": (E,)}
for i in range(2):
    p = f"model.layers.{i}."
    shapes.update({
        p + "input_layernorm.weight": (E,),
        p + "post_attention_layernorm.weight": (E,),
        p + "self_attn.q_proj.weight": (E, E),
        p + "self_attn.k_proj.weight": (D, E),
        p + "self_attn.v_proj.weight": (D, E),
        p + "self_attn.o_proj.weight": (E, E),
        p + "mlp.gate_proj.weight": (I, E), p + "mlp.up_proj.weight": (I, E),
        p + "mlp.down_proj.weight": (E, I)})
rng = np.random.default_rng(0)
weights = {n: (1.0 + 0.1 * rng.standard_normal(s) if len(s) == 1
               else 0.08 * rng.standard_normal(s)).astype(np.float32)
           for n, s in shapes.items()}
d = Path(sys.argv[1])
d.mkdir(parents=True, exist_ok=True)
(d / "config.json").write_text(json.dumps({
    "model_type": "llama", "num_hidden_layers": 2, "hidden_size": E,
    "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": D,
    "intermediate_size": I, "vocab_size": V, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-5, "max_position_embeddings": 64}))
save_file(weights, str(d / "model.safetensors"))
from whisper_tensor_tpu_torch.backends.cpu.dequant import quantize_blocks
from whisper_tensor_tpu_torch.importers.gguf import write_gguf
from whisper_tensor_tpu_torch.packed_format import PackedFormat
from whisper_tensor_tpu_torch.tensor import PackedTensor
names = {"input_layernorm": "attn_norm", "post_attention_layernorm": "ffn_norm",
         "self_attn.q_proj": "attn_q", "self_attn.k_proj": "attn_k",
         "self_attn.v_proj": "attn_v", "self_attn.o_proj": "attn_output",
         "mlp.gate_proj": "ffn_gate", "mlp.up_proj": "ffn_up",
         "mlp.down_proj": "ffn_down"}
tensors = {"token_embd.weight": weights["model.embed_tokens.weight"],
           "output_norm.weight": weights["model.norm.weight"]}
for n, w in weights.items():
    if n.startswith("model.layers."):
        i, leaf = n[len("model.layers."):].split(".", 1)
        n = f"blk.{i}.{names[leaf[:-len('.weight')]]}.weight"
    elif n == "lm_head.weight":
        n = "output.weight"
    else:
        continue
    tensors[n] = (w if w.ndim == 1 else PackedTensor(
        quantize_blocks(w, PackedFormat.Q4_0), PackedFormat.Q4_0, w.shape))
for i in range(2):                      # qwen2's attention biases
    for p, n in (("q", E), ("k", D), ("v", D)):
        tensors[f"blk.{i}.attn_{p}.bias"] = np.zeros(n, np.float32)
write_gguf(str(d / "tiny.gguf"), {
    "general.architecture": "qwen2", "qwen2.block_count": 2,
    "qwen2.embedding_length": E, "qwen2.attention.head_count": 2,
    "qwen2.attention.head_count_kv": 1, "qwen2.attention.key_length": D,
    "qwen2.feed_forward_length": I, "qwen2.vocab_size": V}, tensors)
from whisper_tensor_tpu_torch.importers.quantized import QuantSpec, pack_gptq
g = d / "gptq"
g.mkdir()
gptq = {}
for n, w in weights.items():
    if not n.endswith("proj.weight"):
        gptq[n] = w
        continue
    q = rng.integers(0, 16, w.T.shape).astype(np.uint8)
    zeros = np.full((w.shape[1] // 64, w.shape[0]), 8.0, np.float32)
    scales = np.full_like(zeros, 0.01)
    gptq.update(zip((n[:-6] + "qweight", n[:-6] + "qzeros",
                     n[:-6] + "scales"),
                    pack_gptq(q, zeros, scales, QuantSpec("gptq", 4, 64))))
(g / "config.json").write_text(json.dumps(dict(json.loads(
    (d / "config.json").read_text()), quantization_config={
        "quant_method": "gptq", "bits": 4, "group_size": 64})))
save_file(gptq, str(g / "model.safetensors"))
from whisper_tensor_tpu_torch.server.main import Server
from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi
srv = Server(device="cpu")
(direct,) = srv.models.run_loader("transformers", {
    "path": str(d), "dtype": "bf16", "max_len": 64})
(ragged,) = srv.models.run_loader("transformers", {
    "path": str(d), "dtype": "bf16", "max_len": 64, "ragged_decode": True})
(q4_0,) = srv.models.run_loader("transformers", {
    "path": str(d), "dtype": "bf16", "max_len": 64, "quantize": "q4_0"})
(packed,) = srv.models.run_loader("auto", {
    "path": str(d / "tiny.gguf"), "max_len": 64})
(gptq,) = srv.models.run_loader("auto", {"path": str(g), "max_len": 64})
api = OpenAIApi(srv, "127.0.0.1", 0).start()


def post(path, body):
    c = http.client.HTTPConnection("127.0.0.1", api.port, timeout=120)
    c.request("POST", path, body=json.dumps(body),
              headers={"Content-Type": "application/json"})
    r = c.getresponse()
    return r.status, json.loads(r.read())


for entry in (direct, ragged, q4_0, packed, gptq):
    status, r = post("/v1/completions", {
        "model": str(entry.id), "prompt": "hi", "max_tokens": 3,
        "temperature": 0})
    print("STATUS", status, r["usage"]["completion_tokens"])
for path, entry, body in (
        ("/v1/completions", direct, {"prompt": "hi", "max_tokens": 8,
                                     "regex": "ab{1,3}c"}),
        ("/v1/embeddings", q4_0, {"input": ["hi", "there"]}),
        ("/v1/completions", direct, {"prompt": "hi", "max_tokens": 3,
                                     "n": 1, "best_of": 2})):
    print("ROUTE", post(path, dict(body, model=str(entry.id)))[0])
api.stop()
srv._batchers[ragged.id].stop()
print("PACKED", [len(srv._text_iface(e)._packed)
                 for e in (q4_0, packed, gptq)])
print("FOREIGN", sorted(m for m in sys.modules
                        if m in ("jax", "whisper_tensor_tpu")
                        or m.startswith(("jax.", "whisper_tensor_tpu."))))
"""


def test_a_served_completion_loads_nothing_of_jax(tmp_path):
    """The script writes its checkpoint with numpy and safetensors alone,
    so whatever of jax is loaded afterwards, the port loaded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _SERVE_SCRIPT, str(tmp_path / "tiny-llama")],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("STATUS 200 3") == 5, proc.stdout
    assert proc.stdout.count("ROUTE 200") == 3, proc.stdout
    assert "PACKED [9, 9, 8]" in proc.stdout, proc.stdout
    assert "FOREIGN []" in proc.stdout, proc.stdout


_CORPUS_SCRIPT = r"""
import sys
from pathlib import Path
import numpy as np
from whisper_tensor_tpu_torch.model import Model
paths = {}
n = 0
for f in sorted(Path(sys.argv[1]).glob("*.onnx")):
    feeds = dict(np.load(f.with_suffix(".npz"), allow_pickle=True))
    m = Model.new_from_onnx(f.read_bytes())
    be = m.backend("torch", device="cpu")
    be.run(m.graph, feeds)
    paths[be.last_path] = paths.get(be.last_path, 0) + 1
    n += 1
print("RAN", n, sorted(paths.items()))
print("FOREIGN", sorted(m for m in sys.modules
                        if m in ("jax", "whisper_tensor_tpu")
                        or m.startswith(("jax.", "whisper_tensor_tpu."))))
"""


def test_corpus_graphs_run_without_jax(tmp_path):
    """One conformance case of every op type the port runs (built here
    with the port's builder) goes through the port's Model.eval in a
    fresh interpreter: the generic ONNX path, the interpreter of graphs
    with strings and sequences and the host control flow included, loads
    nothing of jax or the JAX package."""
    import torch_conformance as tc

    seen = set()
    for case in tc.selected(tc.cases_of(*tc.MODULES)):
        if case.op_type in seen:
            continue
        seen.add(case.op_type)
        stem = tmp_path / f"{len(seen):03d}"
        stem.with_suffix(".onnx").write_bytes(tc.onnx_bytes(case))
        np.savez(stem.with_suffix(".npz"), **tc.feeds_of(case))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _CORPUS_SCRIPT, str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"RAN {len(seen)} " in proc.stdout, proc.stdout
    assert "'torch-control'" in proc.stdout and "'oracle'" in proc.stdout
    assert "FOREIGN []" in proc.stdout, proc.stdout


_IMAGE_SCRIPT = r"""
import base64, http.client, json, os, sys
import numpy as np
import torch
from safetensors.numpy import save_file
torch.set_num_threads(1)
from whisper_tensor_tpu_torch.importers.recipes.diffusion import unet, vae
d = sys.argv[1]
get = unet.random_unet_weights(0)


def component(sub, cfg_json, build, **kw):
    rec = {}

    def g(name, shape=None):
        rec[name] = np.ascontiguousarray(get(name, shape), np.float32)
        return rec[name]

    build(g, **kw)
    os.makedirs(os.path.join(d, sub))
    json.dump(cfg_json, open(os.path.join(d, sub, "config.json"), "w"))
    save_file(rec, os.path.join(d, sub, "model.safetensors"))


ucfg = {"block_out_channels": [8, 16], "layers_per_block": 1,
        "cross_attention_dim": 16, "attention_head_dim": 2,
        "norm_num_groups": 4, "sample_size": 8,
        "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"]}
vcfg = {"block_out_channels": [8, 8, 16, 16], "layers_per_block": 1,
        "norm_num_groups": 4}
component("unet", ucfg, unet.build_sd_unet,
          cfg=unet.UNetConfig.from_hf(ucfg), batch=2, latent_hw=(8, 8))
component("vae", vcfg, vae.build_vae_decoder,
          cfg=vae.VAEConfig.from_hf(vcfg), latent_hw=(8, 8))
E, F, L = 16, 32, 1
clip = {"text_model.embeddings.token_embedding.weight": (100, E),
        "text_model.embeddings.position_embedding.weight": (8, E),
        "text_model.final_layer_norm.weight": (E,),
        "text_model.final_layer_norm.bias": (E,)}
p = "text_model.encoder.layers.0."
for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
    clip[p + f"self_attn.{n}.weight"] = (E, E)
    clip[p + f"self_attn.{n}.bias"] = (E,)
for n in ("layer_norm1", "layer_norm2"):
    clip[p + n + ".weight"] = clip[p + n + ".bias"] = (E,)
clip.update({p + "mlp.fc1.weight": (F, E), p + "mlp.fc1.bias": (F,),
             p + "mlp.fc2.weight": (E, F), p + "mlp.fc2.bias": (E,)})
os.makedirs(os.path.join(d, "text_encoder"))
json.dump({"num_hidden_layers": L, "hidden_size": E,
           "num_attention_heads": 2, "intermediate_size": F,
           "vocab_size": 100, "max_position_embeddings": 8,
           "hidden_act": "gelu", "bos_token_id": 1, "eos_token_id": 2},
          open(os.path.join(d, "text_encoder", "config.json"), "w"))
save_file({n: np.ascontiguousarray(get(n, s), np.float32)
           for n, s in clip.items()},
          os.path.join(d, "text_encoder", "model.safetensors"))
json.dump({"_class_name": "StableDiffusionPipeline"},
          open(os.path.join(d, "model_index.json"), "w"))
from whisper_tensor_tpu_torch.server.main import Server
from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi
from whisper_tensor_tpu_torch.utils.image import png_to_array
srv = Server(device="cpu")
srv.models.run_loader("auto", {"path": d, "height": 64, "width": 64})
api = OpenAIApi(srv, "127.0.0.1", 0).start()
c = http.client.HTTPConnection("127.0.0.1", api.port, timeout=120)
c.request("POST", "/v1/images/generations",
          body=json.dumps({"prompt": "x", "steps": 2}),
          headers={"Content-Type": "application/json"})
r = c.getresponse()
img = png_to_array(base64.b64decode(json.loads(r.read())["data"][0]["b64_json"]))
print("IMAGE", r.status, img.shape)
api.stop()
print("FOREIGN", sorted(m for m in sys.modules
                        if m in ("jax", "whisper_tensor_tpu")
                        or m.startswith(("jax.", "whisper_tensor_tpu."))))
"""


def test_a_served_image_loads_nothing_of_jax(tmp_path):
    """The image slice (conv lowerings, the diffusion recipes, the
    diffusers loader, the image interface, /v1/images/generations) in a
    fresh interpreter on the CPU, its bf16 pipeline written with numpy
    and safetensors alone."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _IMAGE_SCRIPT, str(tmp_path / "sd")],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "IMAGE 200 (64, 64, 3)" in proc.stdout, proc.stdout[-2000:]
    assert "FOREIGN []" in proc.stdout, proc.stdout[-2000:]


_TRAIN_SCRIPT = r"""
import os, sys
import numpy as np
from whisper_tensor_tpu_torch.importers.lora import (
    load_peft_adapter_arrays, save_peft_adapter)
from whisper_tensor_tpu_torch.importers.recipes.llm.gpt2 import (
    GPT2Config, build_gpt2_train, random_gpt2_weights)
from whisper_tensor_tpu_torch.milli.serde import graph_from_json, graph_to_json
from whisper_tensor_tpu_torch.milli.training_graph import build_training_graph
from whisper_tensor_tpu_torch.model import Model
from whisper_tensor_tpu_torch.training.checkpoint import (
    load_checkpoint, save_checkpoint)
from whisper_tensor_tpu_torch.training.trainer import LMTrainer
from whisper_tensor_tpu_torch.dtype import DType
from whisper_tensor_tpu_torch.tensor_info import TensorInfo
cfg = GPT2Config(n_layer=1, n_head=2, n_embd=32, vocab_size=64,
                 n_positions=16)
wm = {}
data = build_gpt2_train(random_gpt2_weights(cfg, 0), cfg, weight_map=wm)
ids = np.random.default_rng(0).integers(0, 64, (2, 9))
for kw in (dict(remat="dots"), dict(lora_rank=2, lora_targets=("wfc_",))):
    tr = LMTrainer(Model.new_from_onnx(data), device="cpu", **kw)
    p = tr.init_params()
    s = tr.init_opt_state(p)
    for _ in range(2):
        p, s, loss = tr.train_step(p, s, ids[:, :-1], ids[:, 1:])
    print("LOSS", np.isfinite(float(loss)))
save_checkpoint(os.path.join(sys.argv[1], "ck.npz"), p, s, step=2)
print("CKPT", load_checkpoint(os.path.join(sys.argv[1], "ck.npz"),
                              opt_state_like=s)[2])
d = save_peft_adapter(p, wm, 2, os.path.join(sys.argv[1], "peft"))
print("PEFT", len(load_peft_adapter_arrays(d, wm)))
milli, w = Model.new_from_onnx(data).graph.to_milli(
    bake_small_constants=False)
g, _ = build_training_graph(
    milli, sorted(w), "logits",
    input_infos={"input_ids": TensorInfo.shaped(DType.I64, [2, 8])})
print("JSON", graph_to_json(graph_from_json(graph_to_json(g))) ==
      graph_to_json(g))
print("FOREIGN", sorted(m for m in sys.modules
                        if m in ("jax", "whisper_tensor_tpu")
                        or m.startswith(("jax.", "whisper_tensor_tpu."))))
"""


def test_training_loads_nothing_of_jax(tmp_path):
    """The training slice (LMTrainer with remat and LoRA, checkpoints,
    PEFT files, the milli training graph and its JSON) in a fresh
    interpreter on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _TRAIN_SCRIPT, str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("LOSS True") == 2, proc.stdout
    assert "CKPT 2" in proc.stdout and "PEFT 1" in proc.stdout, proc.stdout
    assert "JSON True" in proc.stdout, proc.stdout
    assert "FOREIGN []" in proc.stdout, proc.stdout


_FAMILY_SCRIPT = r"""
import base64, http.client, json, os, sys
import numpy as np
import torch
d = sys.argv[1]
from whisper_tensor_tpu_torch.importers.recipes.llm.rwkv7 import (
    Rwkv7Config, random_rwkv7_weights)
sd = random_rwkv7_weights(Rwkv7Config(n_layer=1, n_embd=32, n_head=2,
                                      vocab_size=300, lora_w=8, lora_a=8,
                                      lora_v=8, lora_g=8))
torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
           os.path.join(d, "rwkv-tiny.pth"))
with open(os.path.join(d, "vocab.txt"), "w", encoding="utf-8") as f:
    for i in range(256):
        f.write(f"{i + 1} {bytes([i])!r} 1\n")
from whisper_tensor_tpu_torch.interfaces.seq2seq import Seq2SeqInterface
from whisper_tensor_tpu_torch.server.main import Server
from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi
from whisper_tensor_tpu_torch.utils.image import png_bytes
srv = Server(device="cpu")
api = OpenAIApi(srv, "127.0.0.1", 0).start()

def post(path, body):
    c = http.client.HTTPConnection("127.0.0.1", api.port, timeout=120)
    c.request("POST", path, body=json.dumps(body),
              headers={"Content-Type": "application/json"})
    r = c.getresponse()
    return r.status, json.loads(r.read())

for name in ("deepseek", "rwkv-tiny.pth"):
    cfg = {"path": os.path.join(d, name), "dtype": "f32", "max_len": 32}
    if name.endswith(".pth"):
        cfg["tokenizer"] = os.path.join(d, "vocab.txt")
    (e,) = srv.models.run_loader("auto", cfg)
    print("TEXT", name, post("/v1/completions", {
        "model": e.name, "prompt": "hi", "max_tokens": 3,
        "temperature": 0})[0])
    srv._dispatch({"type": "unload_model", "model_id": e.id})
srv.models.run_loader("auto", {"path": os.path.join(d, "llava"),
                               "dtype": "f32", "max_len": 128})
png = base64.b64encode(png_bytes(np.zeros((16, 16, 3), np.uint8))).decode()
print("IMAGE", post("/v1/chat/completions", {"max_tokens": 3, "messages": [
    {"role": "user", "content": [{"type": "image_url", "image_url": {
        "url": "data:image/png;base64," + png}}]}]})[0])
api.stop()
b = srv.models.run_loader("auto", {"path": os.path.join(d, "t5"),
                                   "dtype": "f32", "enc_len": 8,
                                   "max_len": 16})
enc, dec = (e.model for e in b)
s2s = Seq2SeqInterface(enc, dec, 16, device="cpu")
print("T5", s2s.beam_search_tokens(np.ones((1, 5), np.int64), 3, 2).shape)
print("FOREIGN", sorted(m for m in sys.modules
                        if m in ("jax", "whisper_tensor_tpu")
                        or m.startswith(("jax.", "whisper_tensor_tpu."))))
"""


def test_the_text_familys_last_slice_loads_nothing_of_jax(tmp_path):
    """DeepSeek and RWKV-7 completions over HTTP (the RWKV World
    tokenizer), a LLaVA chat with an image, T5 beams, in a fresh
    interpreter on the CPU. The checkpoints are written here, by
    transformers."""
    transformers = pytest.importorskip("transformers")
    import torch

    torch.manual_seed(0)
    transformers.DeepseekV2ForCausalLM(transformers.DeepseekV2Config(
        num_hidden_layers=2, num_attention_heads=2, hidden_size=32,
        intermediate_size=48, moe_intermediate_size=16, vocab_size=300,
        q_lora_rank=None, kv_lora_rank=16, qk_nope_head_dim=8,
        qk_rope_head_dim=4, v_head_dim=8, n_routed_experts=4,
        num_experts_per_tok=2, n_shared_experts=1, first_k_dense_replace=1,
        max_position_embeddings=32)).save_pretrained(
            str(tmp_path / "deepseek"))
    transformers.T5ForConditionalGeneration(transformers.T5Config(
        num_layers=1, num_decoder_layers=1, num_heads=2, d_model=16, d_kv=8,
        d_ff=32, vocab_size=300, relative_attention_num_buckets=8,
        relative_attention_max_distance=16)).save_pretrained(
            str(tmp_path / "t5"))
    transformers.LlavaForConditionalGeneration(transformers.LlavaConfig(
        vision_config=dict(model_type="clip_vision_model",
                           num_hidden_layers=1, hidden_size=32,
                           num_attention_heads=2, intermediate_size=64,
                           image_size=16, patch_size=8),
        text_config=dict(model_type="llama", num_hidden_layers=1,
                         hidden_size=32, num_attention_heads=2,
                         intermediate_size=64, vocab_size=300,
                         max_position_embeddings=128))).save_pretrained(
            str(tmp_path / "llava"))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _FAMILY_SCRIPT, str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "TEXT deepseek 200" in proc.stdout, proc.stdout
    assert "TEXT rwkv-tiny.pth 200" in proc.stdout, proc.stdout
    assert "IMAGE 200" in proc.stdout and "T5 (1, 3)" in proc.stdout, \
        proc.stdout
    assert "FOREIGN []" in proc.stdout, proc.stdout


_SPEECH_SCRIPT = r"""
import base64, http.client, json, os, sys
import numpy as np
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
d = sys.argv[1]
import torch_tts_sets as sets
from whisper_tensor_tpu_torch.importers.loaders import identify_and_load
from whisper_tensor_tpu_torch.interfaces.tts import TextToSpeechInterface
from whisper_tensor_tpu_torch.model import Model
from whisper_tensor_tpu_torch.importers.onnx_builder import OnnxBuilder
from whisper_tensor_tpu_torch.dtype import DType
from whisper_tensor_tpu_torch.server.main import Server
from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi
from whisper_tensor_tpu_torch.super_graph.links import AudioClip
from whisper_tensor_tpu_torch.utils.audio import wav_bytes
for name, write in (("piper", sets.write_piper_voice),
                    ("f5", sets.write_f5_dir)):
    os.makedirs(os.path.join(d, name))
    write(os.path.join(d, name))
srv = Server(device="cpu")
api = OpenAIApi(srv, "127.0.0.1", 0).start()
srv.models.run_loader("auto", {"path": os.path.join(d, "whisper"),
                               "dtype": "f32", "max_len": 32})
srv.models.run_loader("auto", {"path": os.path.join(d, "piper")})
samples = (0.1 * np.sin(np.arange(16000) / 9.0)).astype(np.float32)
c = http.client.HTTPConnection("127.0.0.1", api.port, timeout=120)
c.request("POST", "/v1/audio/transcriptions", body=json.dumps(
    {"audio_b64": base64.b64encode(wav_bytes(samples, 16000)).decode(),
     "max_new_tokens": 3}), headers={"Content-Type": "application/json"})
r = c.getresponse()
r.read()
print("STT", r.status)
c.request("POST", "/v1/audio/speech", body=json.dumps({"input": "tab"}),
          headers={"Content-Type": "application/json"})
r = c.getresponse()
r.read()
print("TTS", r.status)
api.stop()
mid = srv.models.list_models()[0]["id"]
print("STREAM", srv._dispatch({
    "type": "transcribe_stream", "model_id": mid, "final": True,
    "max_new_tokens": 3,
    "samples_b64": base64.b64encode(samples.tobytes()).decode()})["final"])
f5 = TextToSpeechInterface.from_bundle(
    identify_and_load(os.path.join(d, "f5")), device="cpu")
print("F5", f5.run_text_to_audio("hello", ref_audio=AudioClip(
    samples[:400], 24000)).samples.size > 0)
b = OnnxBuilder("lstm", opset=17)
x = b.input("x", DType.F32, [3, 1, 2])
b.node("LSTM", [x, b.initializer("w", np.ones((1, 8, 2), np.float32)),
                b.initializer("r", np.ones((1, 8, 2), np.float32))],
       outputs=["y"], hidden_size=2)
b.output("y", DType.F32, [3, 1, 1, 2])
out = Model.new_from_onnx(b.build()).eval({"x": np.ones((3, 1, 2),
                                                         np.float32)},
                                          device="cpu")
print("LSTM", out["y"].shape)
print("FOREIGN", sorted(m for m in sys.modules
                        if m in ("jax", "whisper_tensor_tpu")
                        or m.startswith(("jax.", "whisper_tensor_tpu."))))
"""


def test_speech_loads_nothing_of_jax(tmp_path):
    """A transcription and a speech request over HTTP, a streaming
    transcription message, an F5 synthesis and an LSTM graph, in a fresh
    interpreter on the CPU. The Whisper checkpoint is written here, by
    transformers; the TTS sets by the port's own builders."""
    transformers = pytest.importorskip("transformers")
    import torch

    torch.manual_seed(0)
    transformers.WhisperForConditionalGeneration(transformers.WhisperConfig(
        d_model=16, encoder_layers=1, decoder_layers=1,
        encoder_attention_heads=2, decoder_attention_heads=2,
        encoder_ffn_dim=32, decoder_ffn_dim=32, num_mel_bins=16,
        max_source_positions=50, max_target_positions=32, vocab_size=120,
        decoder_start_token_id=5, eos_token_id=2, pad_token_id=0,
        bos_token_id=1)).save_pretrained(
            str(tmp_path / "whisper"))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _SPEECH_SCRIPT, str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for line in ("STT 200", "TTS 200", "STREAM True", "F5 True",
                 "LSTM (3, 1, 1, 2)", "FOREIGN []"):
        assert line in proc.stdout, proc.stdout


def test_the_scan_covers_the_parallel_package():
    """parallel/ is among the scanned sources, every module of it."""
    names = {p.name for p in SOURCES
             if p.parent.name == "parallel"
             and p.parent.parent.name == "whisper_tensor_tpu_torch"}
    assert {"mesh.py", "comm.py", "tp.py", "ring_attention.py", "moe.py",
            "pipeline.py", "sp.py", "pipeline_trainer.py"} <= names


_PARALLEL_SCRIPT = r"""
import os, sys
import numpy as np
import torch
from whisper_tensor_tpu_torch.importers.recipes.llm.gpt2 import (
    GPT2Config, build_gpt2_step, random_gpt2_weights)
from whisper_tensor_tpu_torch.interfaces.text import TextInferenceInterface
from whisper_tensor_tpu_torch.model import Model
from whisper_tensor_tpu_torch.parallel.mesh import (
    GPT2_RULES, Mesh, distributed_init, make_mesh)
from whisper_tensor_tpu_torch.parallel.moe import moe_ffn, shard_moe_params
from whisper_tensor_tpu_torch.parallel.pipeline import pipeline_apply
from whisper_tensor_tpu_torch.parallel.ring_attention import (
    ring_attention_sharded)
print("BACKEND", distributed_init("file://" + os.path.join(sys.argv[1], "s"),
                                  1, 0, device="cpu"))
cfg = GPT2Config(n_layer=1, n_head=2, n_embd=32, vocab_size=64,
                 n_positions=16)
m = Model.new_from_onnx(build_gpt2_step(random_gpt2_weights(cfg), cfg,
                                        max_len=16))
mesh = make_mesh(tp=1, device="cpu")
it = TextInferenceInterface(m, 16, prompt_buckets=(8,), mesh=mesh,
                            shard_rules=GPT2_RULES, device="cpu")
print("TOKENS", it.generate_tokens(np.array([[1, 2, 3]]), 4).shape,
      mesh.comm_calls > 0)
q = torch.randn(1, 2, 8, 4)
print("RING", ring_attention_sharded(q, q, q, Mesh(("sp",), (1,),
                                                   device="cpu")).shape)
p = {"router_w": np.ones((2, 4), np.float32),
     "w_gate": np.ones((2, 4, 3), np.float32),
     "w_up": np.ones((2, 4, 3), np.float32),
     "w_down": np.ones((2, 3, 4), np.float32)}
sp = shard_moe_params(p, make_mesh(device="cpu"))
print("MOE", moe_ffn(torch.ones(5, 4), *sp.values(), k=1).shape)
print("PIPE", pipeline_apply(lambda w, h: h @ w, torch.eye(4)[None],
                             torch.ones(2, 4), Mesh(("pp",), (1,),
                                                    device="cpu"),
                             microbatches=2).shape)
print("FOREIGN", sorted(m for m in sys.modules
                        if m in ("jax", "whisper_tensor_tpu")
                        or m.startswith(("jax.", "whisper_tensor_tpu."))))
"""


def test_parallel_serving_loads_nothing_of_jax(tmp_path):
    """A one-rank gloo world on the CPU: a mesh-served GPT-2, ring
    attention, the MoE layer and the pipeline, in a fresh interpreter."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _PARALLEL_SCRIPT, str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for line in ("BACKEND gloo", "TOKENS (1, 4) True",
                 "RING torch.Size([1, 2, 8, 4])", "MOE torch.Size([5, 4])",
                 "PIPE torch.Size([2, 4])", "FOREIGN []"):
        assert line in proc.stdout, proc.stdout


_PARALLEL_TRAIN_SCRIPT = r"""
import os, sys
import numpy as np
from whisper_tensor_tpu_torch.importers.recipes.llm.gpt2 import (
    GPT2Config, build_gpt2_train, random_gpt2_weights)
from whisper_tensor_tpu_torch.model import Model
from whisper_tensor_tpu_torch.parallel import (
    Mesh, PipelinedLMTrainer, distributed_init, layered_gpt2, make_mesh)
from whisper_tensor_tpu_torch.training.checkpoint import (
    load_checkpoint, save_checkpoint)
from whisper_tensor_tpu_torch.training.trainer import LMTrainer
distributed_init("file://" + os.path.join(sys.argv[1], "s"), 1, 0,
                 device="cpu")
cfg = GPT2Config(n_layer=2, n_head=2, n_embd=32, vocab_size=64,
                 n_positions=16)
data = build_gpt2_train(random_gpt2_weights(cfg, 0), cfg)
ids = np.random.default_rng(0).integers(0, 64, (2, 9))
mesh = make_mesh(device="cpu")
tr = LMTrainer(Model.new_from_onnx(data), mesh=mesh, fsdp=True,
               grad_clip=1.0, device="cpu")
p = tr.init_params()
s = tr.init_opt_state(p)
p, s, loss = tr.train_step(p, s, ids[:, :-1], ids[:, 1:])
print("LOSS", np.isfinite(float(loss)))
path = os.path.join(sys.argv[1], "ck.npz")
save_checkpoint(path, p, s, 1, mesh=mesh, param_shardings=tr.param_shardings,
                param_order=tr.weight_names)
print("CKPT", load_checkpoint(path, opt_state_like=s, mesh=mesh,
                              param_shardings=tr.param_shardings,
                              param_order=tr.weight_names)[2])
pt = PipelinedLMTrainer(layered_gpt2(cfg, random_gpt2_weights(cfg, 0)),
                        Mesh(("dp", "pp", "tp"), (1, 1, 1), device="cpu"),
                        microbatches=2)
pp = pt.init_params()
print("PIPE", np.isfinite(float(pt.train_step(
    pp, pt.init_opt_state(pp), ids[:, :-1], ids[:, 1:])[2])))
print("FOREIGN", sorted(m for m in sys.modules
                        if m in ("jax", "whisper_tensor_tpu")
                        or m.startswith(("jax.", "whisper_tensor_tpu."))))
"""


def test_parallel_training_loads_nothing_of_jax(tmp_path):
    """A one-rank gloo world on the CPU: LMTrainer under a mesh with
    fsdp and clipping, a sharded checkpoint written and read, and a
    PipelinedLMTrainer step, in a fresh interpreter."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _PARALLEL_TRAIN_SCRIPT, str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for line in ("LOSS True", "CKPT 1", "PIPE True", "FOREIGN []"):
        assert line in proc.stdout, proc.stdout


_ONNX_SCRIPT = r"""
import os, sys
import numpy as np
d = sys.argv[1]
from whisper_tensor_tpu_torch.compiler import CompilationSubject, build_program
from whisper_tensor_tpu_torch.importers.onnx_builder import WeightStorage
from whisper_tensor_tpu_torch.importers.recipes.llm.gpt2 import (
    GPT2Config, build_gpt2_step, random_gpt2_weights)
from whisper_tensor_tpu_torch.server.main import Server
cfg = GPT2Config(n_layer=1, n_head=2, n_embd=256, vocab_size=1024,
                 n_positions=16)
path = os.path.join(d, "tiny.onnx")
with open(path, "wb") as f:
    f.write(build_gpt2_step(random_gpt2_weights(cfg), cfg, max_len=16,
                            storage=WeightStorage.bin_file(
                                os.path.join(d, "tiny.bin"))))
srv = Server(device="cpu")
(entry,) = srv.models.run_loader("onnx", {"path": path})
prog = build_program(CompilationSubject(model=entry.model), device="cpu")
feeds = {"input_ids": np.asarray([[1, 2, 3]], np.int64),
         "pos": np.asarray(0, np.int64),
         "cache_k_0": np.zeros((1, 2, 16, 128), np.float32),
         "cache_v_0": np.zeros((1, 2, 16, 128), np.float32)}
out = prog.run(feeds)
print("ONNX", prog.backend, out["logits"].shape,
      bool(np.isfinite(out["logits"]).all()))
print("FOREIGN", sorted(m for m in sys.modules
                        if m in ("jax", "whisper_tensor_tpu")
                        or m.startswith(("jax.", "whisper_tensor_tpu."))))
"""


def test_a_raw_onnx_file_loads_and_runs_without_jax(tmp_path):
    """A raw .onnx file with .bin weights, written by the port's builder,
    loaded by the port's Server through the `onnx` loader and run by
    build_program, in a fresh interpreter on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _ONNX_SCRIPT, str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for line in ("ONNX torch (1, 3, 1024) True", "FOREIGN []"):
        assert line in proc.stdout, proc.stdout
