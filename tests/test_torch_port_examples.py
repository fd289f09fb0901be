"""The port's examples (examples/torch_port/*.py) stay runnable: each
runs on the CPU (--cpu) in this process through main(argv), in its
--smoke mode where its JAX counterpart has one and otherwise with the
flags tests/test_examples.py gives it (serve_clients: 2 clients, 6
tokens; gpt2_train: 3 steps; mnist_train: its default 60 steps with the
accuracy gate), and multihost_train, which starts its ranks as
processes, in a subprocess.
They are the port's counterpart of tests/test_examples.py, the system
test tier of the JAX package's examples.

Where the result is deterministic it is held against the JAX package,
computed through its API here on the same seeded weights:
  * greedy tokens, token-exact at an f32 cache: serve_clients (each
    client's tokens against the JAX interface's greedy decode of its
    prompt), speculative_decode (plain greedy) and super_graph_llm;
  * the first step's loss: gpt2_train and lora_train against the JAX
    LMTrainer, mnist_train against the JAX training graph's MilliGraph
    .eval, each within 1e-5 relative (f32, summation order only);
  * gpt2_train --mesh dp=2 (two spawned gloo ranks): the first step's
    loss equals the single rank's, the later ones within 1e-5.
The rest keep their JAX tests' checks: the output lines, the adapters
trained with the base frozen, the loss falling. And without --cpu on a
machine with no card every example fails before it runs anything.
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples", "torch_port")
NAMES = ["serve_clients", "speculative_decode", "gpt2_train", "lora_train",
         "mnist_train", "mnist_train_supergraph", "super_graph_llm",
         "rwkv_lora_train", "multihost_train", "sd_image", "llava_chat",
         "whisper_stt", "tts_speak"]


def _example(name):
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    return importlib.import_module(name)


# the examples whose JAX counterparts have a --smoke mode; the others
# are run with their own flags (as tests/test_examples.py runs them)
SMOKE = set(NAMES) - {"serve_clients", "gpt2_train", "mnist_train",
                      "super_graph_llm"}


def _run(name, capsys, *argv):
    smoke = ["--smoke"] if name in SMOKE else []
    out = _example(name).main([*smoke, "--cpu", *argv])
    assert out["device"] == "cpu"
    return out, capsys.readouterr().out


def _jax_example(name):
    """The JAX package's example module, under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_example_is_here():
    assert sorted(NAMES) == sorted(
        f[:-3] for f in os.listdir(os.path.join(ROOT, "examples"))
        if f.endswith(".py"))
    assert all(os.path.exists(os.path.join(EXAMPLES, f"{n}.py"))
               for n in NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_an_example_without_cpu_needs_the_card(name):
    """No fallback hides a missing card: without --cpu, main fails at its
    first step, the device."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = ["--smoke"] if name in SMOKE - {"multihost_train"} else []
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        _example(name).main(argv)


def _jax_gpt2_iface(cfg_kw, max_len, buckets, pos_per_row=False, seed=0):
    from whisper_tensor_tpu.dtype import DType as JDType
    from whisper_tensor_tpu.importers.recipes.llm.gpt2 import (
        GPT2Config, build_gpt2_step, random_gpt2_weights)
    from whisper_tensor_tpu.interfaces.text import TextInferenceInterface
    from whisper_tensor_tpu.model import Model

    cfg = GPT2Config(**cfg_kw)
    m = Model.new_from_onnx(build_gpt2_step(
        random_gpt2_weights(cfg, seed=seed), cfg, max_len=max_len,
        dtype=JDType.F32, pos_per_row=pos_per_row))
    return TextInferenceInterface(m, max_len=max_len, prompt_buckets=buckets)


def test_serve_clients(capsys):
    out, text = _run("serve_clients", capsys, "--clients", "2", "--tokens",
                     "6", "--chunk", "3")
    assert "aggregate" in text
    ref = _jax_gpt2_iface(dict(n_layer=2, n_head=2, n_embd=64,
                               vocab_size=503, n_positions=256), 256,
                          (16, 32, 64), pos_per_row=True)
    assert len(out["tokens"]) == 2
    for p, got in zip(out["prompts"], out["tokens"]):
        np.testing.assert_array_equal(got, ref.generate_tokens(p[None], 6)[0])


def test_speculative_decode(capsys):
    out, text = _run("speculative_decode", capsys, "--k", "3")
    assert "token-exact" in text and "ok" in text
    ref = _jax_gpt2_iface(dict(n_layer=2, n_head=2, n_embd=64,
                               vocab_size=211, n_positions=128), 128, (16, 32))
    want = ref.generate_tokens(np.asarray([[5, 17, 3, 99, 42]]), 8)[0]
    for k in ("plain", "tiny-draft", "self-draft"):
        np.testing.assert_array_equal(out[k], want)


def test_super_graph_llm(capsys):
    out, text = _run("super_graph_llm", capsys)
    assert "identical tokens" in text
    ref = _jax_gpt2_iface(dict(n_layer=2, n_head=2, n_embd=64,
                               vocab_size=300, n_positions=64), 64, (16, 32))
    from whisper_tensor_tpu.tokenizer import ByteTokenizer

    prompt = np.asarray([ByteTokenizer().encode("hello tpu")], np.int64)
    np.testing.assert_array_equal(out["tokens"],
                                  ref.generate_tokens(prompt, 12)[0])


def _copy_batch():
    """The examples' first copy-task batch (rng seed 0, B 8, S 32)."""
    pat = np.random.default_rng(0).integers(1, 128, (8, 16))
    seq = np.concatenate([pat, pat], axis=1)
    return seq[:, :-1], seq[:, 1:]


def _jax_first_loss(**kw):
    from whisper_tensor_tpu.importers.recipes.llm.gpt2 import (
        GPT2Config, build_gpt2_train, random_gpt2_weights)
    from whisper_tensor_tpu.model import Model
    from whisper_tensor_tpu.training.trainer import LMTrainer

    cfg = GPT2Config(n_layer=2, n_head=4, n_embd=64, vocab_size=128,
                     n_positions=64)
    tr = LMTrainer(Model.new_from_onnx(
        build_gpt2_train(random_gpt2_weights(cfg), cfg)), optimizer="adamw",
        **kw)
    p = tr.init_params()
    _, _, loss = tr.train_step(p, tr.init_opt_state(p), *_copy_batch())
    return float(np.asarray(loss))


def test_gpt2_train(capsys):
    out, text = _run("gpt2_train", capsys, "--steps", "3")
    assert "step   0" in text and "done in" in text
    assert len(out["losses"]) == 3
    np.testing.assert_allclose(out["losses"][0], _jax_first_loss(lr=3e-3),
                               rtol=1e-5)


def test_gpt2_train_mesh_dp2_equals_one_rank(capsys):
    one, _ = _run("gpt2_train", capsys, "--steps", "3")
    two, _ = _run("gpt2_train", capsys, "--steps", "3", "--mesh", "dp=2")
    assert two["ranks"] == 2
    assert two["losses"][0] == pytest.approx(one["losses"][0], rel=1e-6)
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)


def test_lora_train(capsys):
    out, text = _run("lora_train", capsys)
    assert "adapters:" in text and "done in" in text
    assert out["losses"][-1] < out["losses"][0]
    # B starts at zero: the first step's loss is the frozen base's
    want = _jax_first_loss(lr=1e-2, lora_rank=4, lora_alpha=8.0,
                           lora_targets=["wqkv", "wproj", "wfc", "wmp"])
    np.testing.assert_allclose(out["losses"][0], want, rtol=1e-5)


def test_mnist_train(capsys):
    out, text = _run("mnist_train", capsys)
    # the default 60 steps, with the JAX example's accuracy gate (> 0.9)
    assert "accuracy:" in text and len(out["losses"]) == 60
    assert out["accuracy"] > 0.9
    from whisper_tensor_tpu.milli.optimizers import (OptimizerKind,
                                                     OptimizerOptions)
    from whisper_tensor_tpu.milli.training_graph import (
        build_training_graph, init_opt_state)

    ref = _jax_example("mnist_train")
    rng = np.random.default_rng(0)
    fwd, params = ref.build_forward(rng)
    g, meta = build_training_graph(
        fwd, list(params), "pred", loss="cross_entropy",
        optimizer=OptimizerOptions(OptimizerKind.ADAMW, lr=3e-3))
    x, y = ref.synthetic_batch(rng)
    first = g.eval({"x": x, "target": y, **params,
                    **init_opt_state(meta, params),
                    "step": np.asarray(1.0, np.float32)})["loss"]
    np.testing.assert_allclose(out["losses"][0], float(first), rtol=1e-5)


def test_mnist_train_supergraph(capsys):
    out, text = _run("mnist_train_supergraph", capsys)
    assert "job JSON" in text and "accuracy:" in text
    assert len(out["losses"]) == 12
    assert out["losses"][-1] < out["losses"][0]


def test_rwkv_lora_train(capsys):
    out, text = _run("rwkv_lora_train", capsys)
    assert "OK: adapters trained" in text
    assert len(out["losses"]) == 6 and out["losses"][-1] < out["losses"][0]


def test_multihost_train():
    r = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, "multihost_train.py"),
         "--smoke", "--cpu"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    assert "both workers finished" in r.stdout
    assert r.stdout.count("MULTIHOST TRAIN OK") == 2


def test_sd_image(capsys, tmp_path):
    path = str(tmp_path / "x.ppm")
    out, text = _run("sd_image", capsys, "--steps", "2", "--out", path)
    assert "wrote" in text and os.path.getsize(path) > 128 * 128 * 3
    assert out["pixels"].shape == (128, 128, 3)
    assert out["pixels"].std() > 0


def test_llava_chat(capsys):
    out, text = _run("llava_chat", capsys, "--max-tokens", "4")
    assert '"response"' in text and isinstance(out["response"], str)


def test_whisper_stt(capsys):
    out, text = _run("whisper_stt", capsys, "--max-tokens", "4")
    assert '"text"' in text and isinstance(out["text"], str)


def test_tts_speak(capsys, tmp_path):
    out, text = _run("tts_speak", capsys, "--out", str(tmp_path / "x.wav"))
    assert '"sample_rate"' in text and out["sample_rate"] == 16000
    assert out["samples"] > 0 and np.isfinite(out["audio"]).all()
