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
