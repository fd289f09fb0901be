"""RWKV-7, the RNN interface, the .pth reader and the RWKV World
tokenizer on the port, against the JAX package, on the CPU.

The JAX package's tests/test_rwkv7.py model (2 layers, n_embd 32, 4
heads, LoRA ranks 8; a vocabulary of 320, which the test vocabulary file
fits), its seeded `random_rwkv7_weights`,
written by torch.save as `RWKV-x070-tiny.pth`.

* The port's recipe writes the JAX recipe's ONNX bytes (f32, bf16).
* The port's .pth reader (torch.load) gives the JAX package's own
  parser's arrays, bit for bit, on files saved in bf16, f16 and f32.
* Both packages' rwkv7 loaders read the file: the last prefill logits
  within 1e-4 of the largest |logit| and 8 greedy tokens equal at f32;
  the C10 rule at bf16 (the state stays f32); the port's greedy loop
  equals the port's own step-by-step feedback.
* The World tokenizer: ids of a seeded vocabulary file (str and bytes
  entries, multi-byte UTF-8, overlapping prefixes) equal the JAX
  package's, and decode inverts them.
* Serving: WebSocket generate_text and /v1/completions give the tokens
  of the JAX package's RNN interface; sampling is refused with a 400.
"""

import http.client
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from whisper_tensor_tpu.importers.loaders import (  # noqa: E402
    loader_registry as jax_loaders)
from whisper_tensor_tpu.importers.pth import load_pth as jax_load_pth  # noqa: E402
from whisper_tensor_tpu.importers.recipes.llm import (  # noqa: E402
    rwkv7 as jax_rwkv7)
from whisper_tensor_tpu.interfaces.rnn_text import (  # noqa: E402
    RnnTextInterface as JaxRnn)
from whisper_tensor_tpu.tokenizer import (  # noqa: E402
    RwkvWorldTokenizer as JaxWorld)
from whisper_tensor_tpu_torch.dtype import DType  # noqa: E402
from whisper_tensor_tpu_torch.importers.loaders import (  # noqa: E402
    identify_and_load, loader_registry)
from whisper_tensor_tpu_torch.importers.pth import load_pth  # noqa: E402
from whisper_tensor_tpu_torch.importers.recipes.llm import rwkv7  # noqa: E402
from whisper_tensor_tpu_torch.interfaces.rnn_text import (  # noqa: E402
    RnnTextInterface)
from whisper_tensor_tpu_torch.server.main import Server  # noqa: E402
from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi  # noqa: E402
from whisper_tensor_tpu_torch.tokenizer import (  # noqa: E402
    AnyTokenizer, RwkvWorldTokenizer)

CFG = dict(n_layer=2, n_embd=32, n_head=4, vocab_size=320, lora_w=8,
           lora_a=8, lora_v=8, lora_g=8)
SD = rwkv7.random_rwkv7_weights(rwkv7.Rwkv7Config(**CFG))
PROMPT = np.random.default_rng(5).integers(0, 320, (2, 9)).astype(np.int64)


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("rwkv") / "RWKV-x070-tiny.pth")
    torch.save({k: torch.from_numpy(v) for k, v in SD.items()}, p)
    return p


@pytest.mark.parametrize("dt", ["F32", "BF16"])
def test_recipe_writes_the_references_onnx_bytes(dt):
    from whisper_tensor_tpu.dtype import DType as JaxDType

    got = rwkv7.build_rwkv7_step(SD.__getitem__, rwkv7.Rwkv7Config(**CFG),
                                 dtype=DType[dt])
    want = jax_rwkv7.build_rwkv7_step(
        SD.__getitem__, jax_rwkv7.Rwkv7Config(**CFG), dtype=JaxDType[dt])
    assert got == want


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "f16", "f32"])
def test_pth_reader_equals_the_jax_packages_parser(tmp_path, dt):
    p = str(tmp_path / "w.pth")
    state = {k: torch.from_numpy(v).to(dt) for k, v in SD.items()
             if k.startswith(("emb.", "blocks.0.att."))}
    state["blocks.0.att.r_k"] = state["blocks.0.att.r_k"].T  # strided
    torch.save(state, p)
    got, want = load_pth(p), jax_load_pth(p)
    assert list(got) == list(want)
    for k in got:
        assert got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], np.asarray(want[k], np.float32)
                                      if dt == torch.bfloat16 else want[k])


def _ifaces(pth, dtype="f32"):
    pb = loader_registry()["rwkv7"].load({"path": pth, "dtype": dtype})
    jb = jax_loaders()["rwkv7"].load({"path": pth})
    assert pb.interfaces["text"] == jb.interfaces["text"]
    (pm,), (jm,) = pb.models.values(), jb.models.values()
    return RnnTextInterface(pm, device="cpu"), JaxRnn(jm)


def test_loaders_give_the_jax_packages_tokens_and_logits(pth):
    port, ref = _ifaces(pth)
    got, _ = port.feed_tokens(PROMPT)
    want, _ = ref.feed_tokens(PROMPT)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_array_equal(port.generate_tokens(PROMPT, 8),
                                  ref.generate_tokens(PROMPT, 8))
    assert identify_and_load(pth).meta["architecture"] == "rwkv7"


def test_bf16_logits_hold_the_c10_rule(pth):
    port, ref = _ifaces(pth, dtype="bf16")
    assert port.fresh_state(1)["vk_state_0"].dtype == torch.float32
    got, _ = port.feed_tokens(PROMPT)
    want, _ = ref.feed_tokens(PROMPT)
    bound = np.abs(want).max(axis=-1, keepdims=True) / 16
    assert np.all(np.abs(got.astype(np.float32) - want) <= bound)


def test_the_greedy_loop_equals_stepwise_feedback(pth):
    port, _ = _ifaces(pth)
    toks = port.generate_tokens(PROMPT, 6)
    logits, states = port._feed(PROMPT)
    manual = []
    for _ in range(6):
        cur = torch.argmax(logits, dim=-1)
        manual.append(cur)
        logits, states = port.step(cur, states)
    np.testing.assert_array_equal(toks, torch.stack(manual, 1).numpy())


def _vocab(path):
    """A seeded World vocabulary: the 256 bytes, then multi-byte str and
    bytes entries with shared prefixes."""
    rng = np.random.default_rng(3)
    toks = [bytes([b]) for b in range(256)]
    words = ["th", "the", "there", "héllo", "日本", "日本語", " a", " an"]
    toks += [w.encode() for w in words]
    toks += [bytes(rng.integers(97, 123, int(n)).tolist())
             for n in rng.integers(2, 5, 40)]
    with open(path, "w", encoding="utf-8") as f:
        for i, t in enumerate(toks, 1):
            try:
                rep = repr(t.decode("utf-8"))
            except UnicodeDecodeError:
                rep = repr(t)
            f.write(f"{i} {rep} {len(t)}\n")
    return str(path)


@pytest.mark.parametrize("text", ["there the th", "héllo 日本語 an a",
                                  "zqxj kl mno", "\x00\xff bytes"])
def test_world_tokenizer_ids_equal_the_jax_packages(tmp_path, text):
    path = _vocab(tmp_path / "vocab.txt")
    tok = AnyTokenizer.load(path)
    assert isinstance(tok, RwkvWorldTokenizer)
    ids = tok.encode(text)
    assert ids == JaxWorld(path).encode(text)
    assert tok.decode(ids) == text


def test_rwkv_served_over_the_websocket_and_openai(pth, tmp_path):
    srv = Server(device="cpu")
    vocab = _vocab(tmp_path / "vocab.txt")
    (entry,) = srv.models.run_loader("rwkv7", {"path": pth,
                                               "tokenizer": vocab})
    ref = JaxRnn(next(iter(jax_loaders()["rwkv7"].load(
        {"path": pth}).models.values())))
    tok = JaxWorld(vocab)
    ids = np.asarray(tok.encode("the héllo"), np.int64)[None]
    want = tok.decode([int(t) for t in ref.generate_tokens(ids, 5)[0]])
    assert srv._dispatch({"type": "generate_text", "model_id": entry.id,
                          "prompt": "the héllo", "max_new_tokens": 5}) is None
    while True:
        r = srv.scheduler.reports.get(timeout=300)
        if r["type"] in ("job_result", "job_error"):
            break
    assert r["type"] == "job_result" and r["result"]["text"] == want
    api = OpenAIApi(srv, "127.0.0.1", 0).start()
    try:
        for temp, status in ((0, 200), (0.8, 400)):
            c = http.client.HTTPConnection("127.0.0.1", api.port, timeout=300)
            c.request("POST", "/v1/completions", body=json.dumps(
                {"prompt": "the héllo", "max_tokens": 5,
                 "temperature": temp}),
                headers={"Content-Type": "application/json"})
            res = c.getresponse()
            out = json.loads(res.read())
            c.close()
            assert res.status == status, out
        assert "greedy" in out["error"]["message"]
        c = http.client.HTTPConnection("127.0.0.1", api.port, timeout=300)
        c.request("POST", "/v1/completions", body=json.dumps(
            {"prompt": "the héllo", "max_tokens": 5, "temperature": 0}),
            headers={"Content-Type": "application/json"})
        out = json.loads(c.getresponse().read())
        c.close()
        assert out["choices"][0]["text"] == want
    finally:
        api.stop()
        srv.scheduler.shutdown()
