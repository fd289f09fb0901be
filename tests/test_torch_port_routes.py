"""The port's front ends for constrained decoding, tool calls,
embeddings, best_of reranking and beam search, against the JAX package.

The flows of tests/test_openai_api.py (:157 response_format and regex,
:288 tools, :368 embeddings, :608 best_of) and tests/test_server_cli.py
(:672 WebSocket regex / json_schema, beam search, :794 cli embed) run
on the port's Server, OpenAI HTTP API, WebSocket server and CLI on the
CPU, over the reference tests' tiny GPT-2 (1 layer, 2 heads, n_embd 16,
vocab 300, random weights from torch's seed 23; byte tokenizer), loaded
once direct and once with ragged_decode, f32 weights, the servers' bf16
KV cache. The JAX package's Server serves the same checkpoint beside
it: greedy answers (constrained, tool calls, beam search) must be the
JAX package's text exactly, embeddings stand its vectors to 1e-5 (f32
sums in other orders; the bf16 cache rounds the same values the same
way), and best_of must return the top candidates by the JAX package's
own sequence_scores of the port's candidates. Sampled answers cannot
match (jax.random against torch's generator) and must fullmatch.
"""

import asyncio
import http.client
import json
import re
import socket
import threading
import time

import numpy as np
import pytest

pytest.importorskip("jax")

from whisper_tensor_tpu.server.main import Server as JaxServer  # noqa: E402
from whisper_tensor_tpu.server.openai_api import (  # noqa: E402
    OpenAIApi as JaxApi)
from whisper_tensor_tpu_torch.server.main import Server  # noqa: E402
from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi  # noqa: E402
from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer  # noqa: E402

TOK = ByteTokenizer()


def _write_tiny_gpt2(d, n_positions=256, seed=23):
    import torch
    from safetensors.torch import save_file
    from transformers import GPT2Config as HFConfig, GPT2LMHeadModel

    torch.manual_seed(seed)
    hf = GPT2LMHeadModel(HFConfig(n_layer=1, n_head=2, n_embd=16,
                                  vocab_size=300, n_positions=n_positions))
    d.mkdir()
    (d / "config.json").write_text(json.dumps({
        "model_type": "gpt2", "n_layer": 1, "n_head": 2, "n_embd": 16,
        "vocab_size": 300, "n_positions": n_positions}))
    save_file({k: v.contiguous() for k, v in hf.state_dict().items()
               if k != "lm_head.weight"}, str(d / "model.safetensors"))
    return str(d)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _write_tiny_gpt2(tmp_path_factory.mktemp("routes") / "tiny-gpt2")


@pytest.fixture(scope="module")
def apis(ckpt):
    """{"port": (Server, OpenAIApi, direct id, ragged id), "jax": ...}."""
    out = {}
    for key, srv in (("port", Server(device="cpu")), ("jax", JaxServer())):
        ids = []
        for ragged in (False, True):
            (e,) = srv.models.run_loader("transformers", {
                "path": ckpt, "dtype": "f32", "max_len": 256,
                "ragged_decode": ragged})
            ids.append(str(e.id))
        api = (OpenAIApi if key == "port" else JaxApi)(
            srv, "127.0.0.1", 0).start()
        out[key] = (srv, api, *ids)
    yield out
    for srv, api, *_ in out.values():
        api.stop()
        for bat in srv._batchers.values():
            bat.stop()


def _req(api, path, body):
    c = http.client.HTTPConnection("127.0.0.1", api.port, timeout=180)
    try:
        c.request("POST", path, body=json.dumps(body),
                  headers={"Content-Type": "application/json"})
        r = c.getresponse()
        return r.status, json.loads(r.read() or b"{}")
    finally:
        c.close()


def _both(apis, path, body, model=0):
    """(port's (status, answer), JAX package's) for one request on the
    direct (model=0) or the ragged (model=1) entry."""
    return tuple(_req(apis[k][1], path, dict(body, model=apis[k][2 + model]))
                 for k in ("port", "jax"))


# -- response_format and regex (tests/test_openai_api.py:157) ----------

@pytest.mark.parametrize("model", [0, 1], ids=["direct", "ragged"])
@pytest.mark.parametrize("body,check", [
    ({"prompt": "x", "max_tokens": 12, "regex": r"ab{1,4}c",
      "temperature": 0}, r"ab{1,4}c"),
    ({"prompt": "q", "max_tokens": 24, "temperature": 0,
      "response_format": {"type": "json_schema", "json_schema": {"schema": {
          "type": "object", "properties": {
              "ok": {"type": "boolean"}, "c": {"enum": ["a", "b"]}},
          "required": ["ok", "c"]}}}}, "json"),
    ({"prompt": "{", "max_tokens": 20, "temperature": 0,
      "response_format": {"type": "json_object"}}, None)],
    ids=["regex", "json_schema", "json_object"])
def test_constrained_completions_greedy(apis, model, body, check):
    (s, got), (s_ref, want) = _both(apis, "/v1/completions", body, model)
    assert s == s_ref == 200, got
    text = got["choices"][0]["text"]
    assert text == want["choices"][0]["text"]
    assert got["choices"][0]["finish_reason"] == \
        want["choices"][0]["finish_reason"]
    if check == "json":
        doc = json.loads(text)
        assert isinstance(doc["ok"], bool) and doc["c"] in ("a", "b")
    elif check is not None:
        assert re.fullmatch(check, text)
    if model == 1:
        # a constrained request on a ragged model runs on the batcher's
        # own interface, not through the batcher
        srv, _, _, rid = apis["port"]
        entry = srv.models.get(int(rid))
        assert srv._score_iface(entry) is srv._batcher(entry).iface
        assert srv._batcher(entry).stats()["tokens_emitted"] == 0


def test_constrained_sampled_and_chat(apis):
    """The reference test's two requests as it makes them (regex at the
    default temperature 1, a chat with an integer schema): both
    fullmatch; a bad response_format type answers 400 in both."""
    for key in ("port", "jax"):
        _, api, mid, _ = apis[key]
        s, d = _req(api, "/v1/completions", {
            "model": mid, "prompt": "x", "max_tokens": 12,
            "regex": r"ab{1,4}c"})
        assert s == 200, d
        assert re.fullmatch(r"ab{1,4}c", d["choices"][0]["text"])
        s, d = _req(api, "/v1/chat/completions", {
            "model": mid, "messages": [{"role": "user", "content": "count"}],
            "max_tokens": 12, "response_format": {
                "type": "json_schema", "json_schema": {"schema": {
                    "type": "integer"}}}})
        assert s == 200, d
        int(d["choices"][0]["message"]["content"])
        s, _ = _req(api, "/v1/completions", {
            "model": mid, "prompt": "x", "response_format": {"type": "xml"}})
        assert s == 400


# -- tools (tests/test_openai_api.py:288) ------------------------------

TOOLS = [
    {"type": "function", "function": {
        "name": "get_weather",
        "parameters": {"type": "object",
                       "properties": {"city": {"enum": ["oslo", "paris"]},
                                      "days": {"enum": [1, 2]}},
                       "required": ["city", "days"]}}},
    {"type": "function", "function": {
        "name": "set_alarm",
        "parameters": {"type": "object",
                       "properties": {"hour": {"enum": [1, 2, 3]}},
                       "required": ["hour"]}}}]
MSGS = [{"role": "user", "content": "weather in oslo"}]


@pytest.mark.parametrize("choice,max_tokens", [
    ({"type": "function", "function": {"name": "set_alarm"}}, 64),
    ("required", 80), ("auto", 80)])
def test_tool_calls(apis, choice, max_tokens):
    (s, got), (s_ref, want) = _both(apis, "/v1/chat/completions", {
        "messages": MSGS, "max_tokens": max_tokens, "temperature": 0,
        "tools": TOOLS, "tool_choice": choice})
    assert s == s_ref == 200, got
    ch, ref = got["choices"][0], want["choices"][0]
    assert ch["finish_reason"] == ref["finish_reason"] == "tool_calls"
    assert ch["message"]["content"] is None
    call = ch["message"]["tool_calls"][0]
    assert call["type"] == "function"
    fn, ref_fn = call["function"], ref["message"]["tool_calls"][0]["function"]
    assert fn == ref_fn
    args = json.loads(fn["arguments"])
    if fn["name"] == "set_alarm":
        assert args["hour"] in (1, 2, 3)
    else:
        assert args["city"] in ("oslo", "paris") and args["days"] in (1, 2)


def test_tool_choice_none_and_errors(apis):
    (s, got), (_, want) = _both(apis, "/v1/chat/completions", {
        "messages": MSGS, "max_tokens": 6, "temperature": 0, "tools": TOOLS,
        "tool_choice": "none"})
    assert s == 200 and "tool_calls" not in got["choices"][0]["message"]
    assert got["choices"][0]["message"]["content"] == \
        want["choices"][0]["message"]["content"]
    for body, status in (
            ({"tool_choice": {"type": "function",
                              "function": {"name": "nope"}}}, 404),
            ({"stream": True}, 400),
            ({"response_format": {"type": "json_object"}}, 400)):
        (s, _), (s_ref, _) = _both(apis, "/v1/chat/completions", dict(
            {"messages": MSGS, "tools": TOOLS}, **body))
        assert s == s_ref == status
    follow = [
        {"role": "user", "content": "a"},
        {"role": "assistant", "content": None, "tool_calls": [
            {"id": "c1", "type": "function",
             "function": {"name": "f", "arguments": "{}"}}]},
        {"role": "tool", "tool_call_id": "c1", "content": "ok"}]
    (s, got), (_, want) = _both(apis, "/v1/chat/completions", {
        "messages": follow, "max_tokens": 4, "temperature": 0,
        "tools": TOOLS, "tool_choice": "none"})
    assert s == 200
    assert got["choices"][0]["message"]["content"] == \
        want["choices"][0]["message"]["content"]


# -- embeddings (tests/test_openai_api.py:368) --------------------------

@pytest.mark.parametrize("model", [0, 1], ids=["direct", "ragged"])
@pytest.mark.parametrize("body", [
    {"input": ["hi", "hello there"]}, {"input": "hi"},
    {"input": [104, 105], "pooling": "mean"},
    {"input": ["a", "bb", "the quick brown fox"], "pooling": "mean"}],
    ids=["list", "one", "ids-mean", "three-mean"])
def test_embeddings(apis, model, body):
    (s, got), (s_ref, want) = _both(apis, "/v1/embeddings", body, model)
    assert s == s_ref == 200, got
    assert got["object"] == "list" and len(got["data"]) == len(want["data"])
    assert got["usage"] == want["usage"]
    for g, w in zip(got["data"], want["data"]):
        v = np.asarray(g["embedding"])
        assert v.shape == (16,) and g["index"] == w["index"]
        np.testing.assert_allclose(np.linalg.norm(v), 1.0, rtol=1e-6)
        np.testing.assert_allclose(v, w["embedding"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("body", [{"input": []}, {"input": 3},
                                  {"input": "a", "pooling": "max"},
                                  {"input": "a", "encoding_format": "base64"}])
def test_embeddings_errors(apis, body):
    (s, _), (s_ref, _) = _both(apis, "/v1/embeddings", body)
    assert s == s_ref == 400


# -- best_of (tests/test_openai_api.py:608) -----------------------------

def _jax_scores(apis, prompt_ids, cands):
    """The JAX package's sequence_scores of candidate token lists, as
    run_many builds them, empty candidates last."""
    srv, _, mid, _ = apis["jax"]
    iface = srv._score_iface(srv.models.get(int(mid)))
    P = len(prompt_ids)
    full = np.zeros((len(cands), P + max(1, max(map(len, cands)))), np.int64)
    lens = np.zeros(len(cands), np.int64)
    for i, t in enumerate(cands):
        full[i, :P], full[i, P:P + len(t)] = prompt_ids, t
        lens[i] = P + len(t)
    s = np.asarray(iface.sequence_scores(full, np.full(len(cands), P), lens))
    return np.where(lens > P, s, -np.inf)


def _stop_trim(toks, stop):
    """The tokens before the one whose text completes `stop`."""
    for k in range(len(toks)):
        if stop in TOK.decode(toks[:k + 1]):
            return toks[:k]
    return toks


@pytest.mark.parametrize("stop", [False, True])
def test_best_of_reranks_by_the_references_scores(apis, stop):
    """best_of=6 n=2 (n=5 with a stop string that empties a candidate):
    the answers are the port's six seeded candidates ranked by the JAX
    package's scores of them, empty ones last."""
    from whisper_tensor_tpu_torch.interfaces.text import SamplingParams

    srv, api, mid, _ = apis["port"]
    iface = srv._score_iface(srv.models.get(int(mid)))
    base = {"model": mid, "prompt": "hi", "max_tokens": 6,
            "temperature": 1.3, "seed": 5}
    s, all6 = _req(api, "/v1/completions", dict(base, n=6, best_of=6))
    assert s == 200
    rows = iface.generate_tokens(
        np.tile(np.asarray(TOK.encode("hi"), np.int64)[None], (6, 1)), 6,
        sampling=SamplingParams(temperature=1.3, seed=5))
    cands = [[int(t) for t in row] for row in rows]
    assert [c["text"] for c in all6["choices"]] == [TOK.decode(c)
                                                    for c in cands]
    body, n = dict(base, n=2, best_of=6), 2
    if stop:
        first = next(TOK.decode(c[:1]) for c in cands if TOK.decode(c[:1]))
        body, n = dict(base, n=5, best_of=6, stop=[first[0]]), 5
        cands = [_stop_trim(c, first[0]) for c in cands]
        assert [] in cands
    s, r = _req(api, "/v1/completions", body)
    assert s == 200 and len(r["choices"]) == n
    scores = _jax_scores(apis, TOK.encode("hi"), cands)
    order = np.argsort(-scores)[:n]
    assert [c["text"] for c in r["choices"]] == [
        TOK.decode(cands[int(i)]) for i in order]
    if stop and sum(len(c) > 0 for c in cands) >= n:
        assert all(np.isfinite(scores[order]))


def test_best_of_errors(apis):
    for body in ({"n": 3, "best_of": 2}, {"n": 1, "best_of": 65},
                 {"n": 1, "best_of": 3, "temperature": 0},
                 {"n": 1, "best_of": 3, "regex": "a+"}):
        (s, _), (s_ref, _) = _both(apis, "/v1/completions", dict(
            {"prompt": "hi", "max_tokens": 4, "temperature": 1.0}, **body))
        assert s == s_ref == 400, body


def test_best_of_on_the_ragged_model(apis):
    """The batcher draws the candidates, the batcher's interface scores
    them: n of them answer."""
    _, api, _, rid = apis["port"]
    s, r = _req(api, "/v1/completions", {
        "model": rid, "prompt": "hi", "max_tokens": 5, "temperature": 1.1,
        "seed": 3, "n": 2, "best_of": 4})
    assert s == 200 and len(r["choices"]) == 2


# -- WebSocket regex / json_schema / num_beams (tests/test_server_cli.py:672)

@pytest.fixture(scope="module")
def ws(ckpt):
    """A port Server on a WebSocket port with the checkpoint loaded
    direct and ragged (max_len 64), and a client."""
    from tests.test_server_cli import _WSClient

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    srv = Server(device="cpu")
    loop = asyncio.new_event_loop()

    def run():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(srv.run(port=port))
        except RuntimeError:
            pass   # teardown stops the loop mid-serve

    threading.Thread(target=run, daemon=True).start()
    time.sleep(0.3)
    c = _WSClient("127.0.0.1", port)
    mids = []
    for ragged in (False, True):
        c.send({"type": "run_loader", "loader": "transformers",
                "config": {"path": ckpt, "dtype": "f32", "max_len": 64,
                           "ragged_decode": ragged}})
        mids.append(c.recv()["loaded"][0])
    yield srv, c, mids
    c.close()
    for bat in srv._batchers.values():
        bat.stop()
    loop.call_soon_threadsafe(loop.stop)


def _ws_gen(c, mid, **kw):
    c.send({"type": "generate_text", "model_id": mid, "prompt": "hi",
            "max_new_tokens": 12, "tokenizer": "bytes", **kw})
    for _ in range(400):
        r = c.recv()
        if r["type"] in ("job_result", "job_error"):
            return r


@pytest.fixture(scope="module")
def jax_iface(ckpt):
    """The JAX package's text interface on the checkpoint as its Server
    builds it (bf16 cache, max_len 64), with the byte tokenizer."""
    from whisper_tensor_tpu.tokenizer import ByteTokenizer as JaxBytes

    srv = JaxServer()
    (e,) = srv.models.run_loader("transformers", {
        "path": ckpt, "dtype": "f32", "max_len": 64})
    iface = srv._text_iface(e)
    iface.tokenizer = JaxBytes()
    return iface


@pytest.mark.parametrize("ragged", [0, 1], ids=["direct", "ragged"])
@pytest.mark.parametrize("kw", [
    {"regex": r"ab{1,4}c"},
    {"json_schema": {"enum": ["yes", "no", 7]}},
    {"regex": r"[0-9]{1,3}", "with_probs": True}], ids=["regex", "schema",
                                                        "with_probs"])
def test_ws_constrained(ws, jax_iface, ragged, kw):
    srv, c, mids = ws
    r = _ws_gen(c, mids[ragged], temperature=0, **kw)
    assert r["type"] == "job_result", r
    text = r["result"]["text"]
    want = jax_iface.run_string_in_string_out(
        "hi", 12, regex=kw.get("regex"), json_schema=kw.get("json_schema"))
    assert text == want
    if "regex" in kw:
        assert re.fullmatch(kw["regex"], text)
    else:
        assert json.loads(text) in ("yes", "no", 7)
    if kw.get("with_probs"):
        toks = r["result"]["tokens"]
        assert "".join(t["text"] for t in toks) == text
        assert all(0.0 <= t["p"] <= 1.0 for t in toks)


@pytest.mark.parametrize("ragged", [0, 1], ids=["direct", "ragged"])
@pytest.mark.parametrize("kw", [{"num_beams": 3},
                                {"num_beams": 2, "length_penalty": 1.0,
                                 "eos_token_id": 40}])
def test_ws_beam_search(ws, jax_iface, ragged, kw):
    srv, c, mids = ws
    r = _ws_gen(c, mids[ragged], **kw)
    assert r["type"] == "job_result", r
    ids = np.asarray(TOK.encode("hi"), np.int64)[None]
    want = jax_iface.beam_search_tokens(
        ids, 12, beam=kw["num_beams"],
        length_penalty=kw.get("length_penalty", 0.0),
        eos_token_id=kw.get("eos_token_id"))[0]
    assert r["result"]["text"] == TOK.decode([int(t) for t in want])


def test_ws_constraint_with_beams_is_refused(ws):
    srv, c, mids = ws
    with pytest.raises(ValueError, match="num_beams"):
        srv._dispatch({"type": "generate_text", "model_id": mids[0],
                       "prompt": "hi", "regex": "a+", "num_beams": 2})


# -- the CLI (tests/test_server_cli.py:794) -----------------------------

@pytest.fixture(scope="module")
def ckpt64(tmp_path_factory):
    return _write_tiny_gpt2(tmp_path_factory.mktemp("cli") / "tiny-gpt2",
                            n_positions=64, seed=0)


def test_cli_embed(ckpt64, capsys):
    """`embed` prints one JSON line per input: unit-norm hidden-state
    pooling, the JAX package's CLI's vectors (its f32 cache against the
    port's f32 cache, to 1e-5)."""
    from whisper_tensor_tpu.cli import main as jax_main
    from whisper_tensor_tpu_torch.cli import main

    args = ["embed", "--model", ckpt64, "--max-len", "64", "-c", "dtype=f32",
            "--pooling", "mean", "hello", "world wide"]
    main(args + ["--device", "cpu"])
    got = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
           if ln]
    jax_main(args)
    want = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert [r["index"] for r in got] == [0, 1] and len(want) == 2
    for g, w in zip(got, want):
        v = np.asarray(g["embedding"])
        assert v.shape == (16,) and abs(np.linalg.norm(v) - 1.0) < 1e-5
        np.testing.assert_allclose(v, w["embedding"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("flags", [
    ["--regex", "ab{1,4}c"],
    ["--json-schema", json.dumps({"type": "object", "properties": {
        "ok": {"type": "boolean"}}, "required": ["ok"]})],
    ["--num-beams", "3"]], ids=["regex", "json-schema", "num-beams"])
def test_cli_generate_constrained_and_beams(ckpt64, capsys, flags):
    """`generate` with the flags prints the JAX package's CLI's text
    (greedy, f32 cache in both)."""
    from whisper_tensor_tpu.cli import main as jax_main
    from whisper_tensor_tpu_torch.cli import main

    args = ["generate", "--model", ckpt64, "--prompt", "hi", "--max-len",
            "64", "--max-new-tokens", "16", "-c", "dtype=f32"] + flags
    main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    jax_main(args)
    want = capsys.readouterr().out
    assert got == want
    if flags[0] == "--regex":
        assert re.fullmatch(flags[1], got.rstrip("\n"))
    elif flags[0] == "--json-schema":
        assert isinstance(json.loads(got)["ok"], bool)


def test_cli_generate_refuses_a_constraint_with_beams(ckpt64):
    from whisper_tensor_tpu_torch.cli import main

    with pytest.raises(SystemExit, match="num-beams"):
        main(["generate", "--model", ckpt64, "--prompt", "hi", "--regex",
              "a+", "--num-beams", "2", "--device", "cpu"])
