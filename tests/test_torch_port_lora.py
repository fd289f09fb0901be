"""LoRA adapters on the PyTorch port against the JAX package, on the CPU.

PEFT adapter dirs are written with `peft` over tiny random HF checkpoints,
as tests/test_lora_adapter.py writes them: a GPT-2 (2 layers, n_embd 64,
2 heads, vocab 211, 64 positions) with two Conv1D adapters `a` and `b`
(fan_in_fan_out, r 4, alpha 16, on c_attn, c_proj and c_fc) and a third
`c`, and a llama (2 layers, hidden 32) with a Linear adapter on q_proj,
v_proj and down_proj and an rsLoRA one on q_proj. Held against the JAX
package: the merged weights and the resolved (A, B, scale) arrays bit
for bit, `inject_multi_lora`'s milli graph node for node with equal
`MilliGraph.eval` outputs, and greedy tokens of the two batchers at an
f32 cache with base, `a` and `b` rows in one chunk. Held against the
port's own merged-at-load direct path: the batcher's tokens per adapter,
with a shared prefix, the auto-prefix pool and a run-time load_adapter.
The OpenAI routes' adapter aliases and errors, and the refusals of
adapters on int8 and packed weights, close the file."""

import http.client
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("peft")

from whisper_tensor_tpu.dtype import DType as JaxDType  # noqa: E402
from whisper_tensor_tpu.importers import lora as jax_lora  # noqa: E402
from whisper_tensor_tpu.importers.loaders import (  # noqa: E402
    loader_registry as jax_loaders)
from whisper_tensor_tpu.importers.safetensors_io import (  # noqa: E402
    SafetensorsStore as JaxStore)
from whisper_tensor_tpu.milli.transforms import (  # noqa: E402
    inject_multi_lora as jax_inject)
from whisper_tensor_tpu.server.batching import (  # noqa: E402
    ContinuousBatcher as JaxBatcher)
from whisper_tensor_tpu_torch.dtype import DType  # noqa: E402
from whisper_tensor_tpu_torch.importers import lora  # noqa: E402
from whisper_tensor_tpu_torch.importers.loaders import (  # noqa: E402
    loader_registry)
from whisper_tensor_tpu_torch.importers.safetensors_io import (  # noqa: E402
    SafetensorsStore)
from whisper_tensor_tpu_torch.interfaces.text import (  # noqa: E402
    TextInferenceInterface)
from whisper_tensor_tpu_torch.milli.ops import LOWERINGS  # noqa: E402
from whisper_tensor_tpu_torch.milli.ops.einsum import (  # noqa: E402
    EinsumMilli)
from whisper_tensor_tpu_torch.milli.transforms import (  # noqa: E402
    inject_multi_lora)
from whisper_tensor_tpu_torch.server.batching import (  # noqa: E402
    ContinuousBatcher)
from whisper_tensor_tpu_torch.server.main import Server  # noqa: E402
from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi  # noqa: E402

MAX_LEN = 64
V = 211


def _save_base(hf, d, cfg_json):
    from safetensors.torch import save_file

    d.mkdir()
    (d / "config.json").write_text(json.dumps(cfg_json))
    save_file({k: v.contiguous() for k, v in hf.state_dict().items()
               if k != "lm_head.weight"}, str(d / "model.safetensors"))


def _peft_dir(hf, d, seed, **cfg):
    """Save a PEFT adapter over `hf` with both factors random (peft
    zero-inits lora_B, which would make every merge a no-op)."""
    from peft import LoraConfig, get_peft_model

    pm = get_peft_model(hf, LoraConfig(lora_dropout=0.0, **cfg))
    torch.manual_seed(seed)
    with torch.no_grad():
        for n, p in pm.named_parameters():
            if "lora_" in n:
                p.copy_(torch.randn_like(p) * 0.3)
    pm.save_pretrained(str(d))
    return d


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    from transformers import GPT2Config as HFGPT2, GPT2LMHeadModel
    from transformers import LlamaConfig as HFLlama, LlamaForCausalLM

    root = tmp_path_factory.mktemp("lora")
    out = {}
    torch.manual_seed(3)
    gcfg = dict(n_layer=2, n_head=2, n_embd=64, vocab_size=V,
                n_positions=MAX_LEN)
    hf = GPT2LMHeadModel(HFGPT2(**gcfg))
    with torch.no_grad():            # sharper weights: context matters
        for n, p in hf.named_parameters():
            if p.ndim == 2:
                p.mul_(4.0)
    _save_base(hf, root / "gpt2", {"model_type": "gpt2", **gcfg})
    out["gpt2"] = root / "gpt2"
    for name, seed in (("a", 10), ("b", 20), ("c", 30)):
        fresh = GPT2LMHeadModel(HFGPT2(**gcfg))
        fresh.load_state_dict(hf.state_dict())
        out[name] = _peft_dir(fresh, root / f"adapter-{name}", seed, r=4,
                              lora_alpha=16, fan_in_fan_out=True,
                              target_modules=["c_attn", "c_proj", "c_fc"])
    torch.manual_seed(1)
    lcfg = dict(num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, hidden_size=32,
                intermediate_size=64, vocab_size=173,
                max_position_embeddings=MAX_LEN, attention_dropout=0.0,
                tie_word_embeddings=True)
    hl = LlamaForCausalLM(HFLlama(**lcfg))
    _save_base(hl, root / "llama", {"model_type": "llama", **lcfg,
                                    "rms_norm_eps": 1e-6,
                                    "rope_theta": 10000.0})
    out["llama"] = root / "llama"
    for name, seed, kw in (
            ("llama_lin", 11, dict(r=2, lora_alpha=8, target_modules=[
                "q_proj", "v_proj", "down_proj"])),
            ("llama_rs", 12, dict(r=4, lora_alpha=8, use_rslora=True,
                                  target_modules=["q_proj"]))):
        fresh = LlamaForCausalLM(HFLlama(**lcfg))
        fresh.load_state_dict(hl.state_dict())
        out[name] = _peft_dir(fresh, root / name, seed, **kw)
    return out


# -- the merged store and the resolved arrays ------------------------------


@pytest.mark.parametrize("base,adapter", [("gpt2", "a"),
                                          ("llama", "llama_lin"),
                                          ("llama", "llama_rs")])
def test_merged_store_equals_the_reference_bit_for_bit(dirs, base, adapter):
    """GPT-2 Conv1D (fan_in_fan_out), llama Linear and rsLoRA's
    alpha / sqrt(r): every tensor of the checkpoint, merged or not."""
    port = lora.LoraMergedStore(SafetensorsStore.from_dir(str(dirs[base])),
                                str(dirs[adapter]))
    ref = jax_lora.LoraMergedStore(JaxStore.from_dir(str(dirs[base])),
                                   str(dirs[adapter]))
    assert port.scale == ref.scale
    assert port.merged_modules == ref.merged_modules
    assert sorted(port.names()) == sorted(ref.names())
    changed = 0
    for n in ref.names():
        got, want = port.load(n), ref.load(n)
        assert got.dtype == want.dtype and np.array_equal(got, want), n
        changed += not np.array_equal(got, ref.base.load(n))
    assert changed == (8 if base == "gpt2" else
                       6 if adapter == "llama_lin" else 2)


def test_a_missing_lora_pair_raises_in_both(tmp_path):
    from safetensors.numpy import save_file

    d = tmp_path / "bad-adapter"
    d.mkdir()
    (d / "adapter_config.json").write_text(json.dumps({"r": 2,
                                                       "lora_alpha": 4}))
    save_file({"base_model.model.x.lora_A.weight":
               np.zeros((2, 4), np.float32)},
              str(d / "adapter_model.safetensors"))

    class Empty:
        def names(self):
            return []

    for mod in (lora, jax_lora):
        with pytest.raises(ValueError, match="missing A or B"):
            mod.LoraMergedStore(Empty(), str(d))


def _bundles(path, **cfg):
    """The port's and the JAX package's loads of one checkpoint."""
    cfg = {"path": str(path), "dtype": "f32", "max_len": MAX_LEN, **cfg}
    return (loader_registry()["transformers"].load(cfg),
            jax_loaders()["transformers"].load(cfg))


@pytest.mark.parametrize("base,adapter", [("gpt2", "a"),
                                          ("llama", "llama_lin")])
def test_adapter_arrays_equal_the_reference(dirs, base, adapter):
    """The recipes' weight maps agree, and so do load_peft_adapter_arrays'
    (A, B, scale); an adapter on an unmapped module raises in both."""
    pb, jb = _bundles(dirs[base])
    wmap = pb.interfaces["text"]["weight_map"]
    assert wmap == jb.interfaces["text"]["weight_map"] and wmap
    got = lora.load_peft_adapter_arrays(str(dirs[adapter]), wmap)
    want = jax_lora.load_peft_adapter_arrays(str(dirs[adapter]), wmap)
    assert sorted(got) == sorted(want)
    for n in want:
        assert got[n][2] == want[n][2]
        for g, w in zip(got[n][:2], want[n][:2]):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    partial = dict(list(wmap.items())[1:])
    for mod in (lora, jax_lora):
        with pytest.raises(ValueError, match="no matmul-weight mapping"):
            mod.load_peft_adapter_arrays(str(dirs[adapter]), partial)


# -- the surgery and its op -------------------------------------------------


def test_inject_multi_lora_builds_the_reference_graph(dirs):
    """On both packages' GPT-2 milli graphs (per-row pos) with adapters
    a and b: the same node kinds in order, input names, adapter stacks
    bit for bit, and MilliGraph.eval outputs at three rows (base, a, b)
    equal exactly."""
    pb, jb = _bundles(dirs["gpt2"], ragged_decode=True)
    wmap = pb.interfaces["text"]["weight_map"]
    ads = [jax_lora.load_peft_adapter_arrays(str(dirs[n]), wmap)
           for n in ("a", "b")]
    graphs, stacks = [], []
    for b, inject in ((pb, inject_multi_lora), (jb, jax_inject)):
        m = next(iter(b.models.values()))
        milli, _ = m.graph.to_milli()
        st = m.graph.store
        stacks.append(inject(milli, ads,
                             lambda n, st=st: st.get_numeric(n).numpy()))
        graphs.append((m, milli))
    (pm, pg), (jm, jg) = graphs
    assert [n.op.KIND for n in pg.nodes] == [n.op.KIND for n in jg.nodes]
    assert sum(n.op.KIND == "Einsum" for n in pg.nodes) == 3 * 8
    assert list(pg.inputs) == list(jg.inputs) and "lora_idx" in pg.inputs
    assert [n.op.equation for n in pg.nodes if n.op.KIND == "Einsum"] == \
        [n.op.equation for n in jg.nodes if n.op.KIND == "Einsum"]
    assert sorted(stacks[0]) == sorted(stacks[1])
    for n in stacks[1]:
        assert np.array_equal(stacks[0][n], stacks[1][n]), n
    rng = np.random.default_rng(0)
    feeds = {"input_ids": rng.integers(0, V, (3, 5)).astype(np.int64),
             "pos": np.zeros(3, np.int64),
             "lora_idx": np.asarray([0, 1, 2], np.int64)}
    for n in pg.inputs:
        if n.startswith("cache_"):
            feeds[n] = np.zeros((3, 2, MAX_LEN, 32), np.float32)
        elif n in stacks[1]:
            feeds[n] = stacks[1][n]
        elif n not in feeds:
            feeds[n] = jm.graph.store.get_numeric(n).numpy()
    got, want = pg.eval(feeds), jg.eval(feeds)
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    # the rows really differ by adapter
    lg = want["logits"]
    assert not np.allclose(lg[0], lg[1]) and not np.allclose(lg[1], lg[2])


@pytest.mark.parametrize("eq,shapes", [
    ("bsk,nkr->bnsr", [(3, 5, 64), (3, 64, 4)]),
    ("bnsr,bn->bnsr", [(3, 3, 5, 4), (3, 3)]),
    ("bnsr,nrm->bsm", [(3, 3, 5, 4), (3, 4, 96)])])
@pytest.mark.parametrize("dt", [np.float32, "bfloat16"])
def test_einsum_lowering_matches_eval(eq, shapes, dt):
    """f32 within f32 summation-order noise; bf16 within one bf16 ulp of
    the output (both compute in f32 and round once)."""
    import ml_dtypes

    npdt = np.dtype(ml_dtypes.bfloat16) if dt == "bfloat16" else np.dtype(dt)
    rng = np.random.default_rng(len(eq))
    xs = [rng.standard_normal(s).astype(np.float32).astype(npdt)
          for s in shapes]
    op = EinsumMilli(equation=eq)
    want = op.eval(xs)[0]
    ts = [torch.from_numpy(x.astype(np.float32)).to(
        torch.bfloat16 if dt == "bfloat16" else torch.float32) for x in xs]
    got = LOWERINGS["Einsum"](op, ts, [None] * len(ts), torch.device("cpu"))
    got = got[0].float().numpy()
    w = want.astype(np.float32)
    tol = (2.0 ** -7 * np.abs(w) + 1e-6 if dt == "bfloat16"
           else 1e-5 * np.abs(w) + 1e-6)
    assert got.shape == w.shape and bool((np.abs(got - w) <= tol).all())


# -- serving: the batcher, the server, the HTTP routes -----------------------


def _arrays(dirs, names, wmap):
    return {n: lora.load_peft_adapter_arrays(str(dirs[n]), wmap)
            for n in names}


def _merged_tokens(dirs, adapter, prompt, n_new):
    """The port's merged-at-load direct path: `-c lora=<dir>`."""
    cfg = {"path": str(dirs["gpt2"]), "dtype": "f32", "max_len": MAX_LEN}
    if adapter is not None:
        cfg["lora"] = str(dirs[adapter])
    b = loader_registry()["transformers"].load(cfg)
    iface = TextInferenceInterface(next(iter(b.models.values())),
                                   max_len=MAX_LEN,
                                   prompt_buckets=(16, 32, 48), device="cpu")
    return iface.generate_tokens(np.asarray(prompt)[None], n_new)[0]


_PROMPTS = [np.random.default_rng(1).integers(0, V, (n,)).astype(np.int64)
            for n in (5, 8, 4, 6, 7)]
_NAMES = [None, "a", "b", "a", None]


def test_batcher_mixed_adapters_equal_the_jax_batcher_and_merged_loads(dirs):
    """Five requests, base, a and b, in one batch at an f32 cache: the
    port's batcher (whole-bucket and 4-token-piece admission) gives the
    JAX batcher's tokens and each adapter's merged-at-load tokens."""
    pb, jb = _bundles(dirs["gpt2"], ragged_decode=True)
    wmap = pb.interfaces["text"]["weight_map"]
    kw = dict(max_len=MAX_LEN, max_batch=5, chunk=4, prompt_buckets=(16,))
    jbat = JaxBatcher(next(iter(jb.models.values())), cache_dtype=JaxDType.F32,
                      adapters={n: jax_lora.load_peft_adapter_arrays(
                          str(dirs[n]), wmap) for n in ("a", "b")},
                      **kw).start()
    try:
        want = [f.result(timeout=300) for f in
                [jbat.submit(p, 7, adapter=a)
                 for p, a in zip(_PROMPTS, _NAMES)]]
    finally:
        jbat.stop()
    for pc in (None, 4):
        bat = ContinuousBatcher(next(iter(pb.models.values())),
                                cache_dtype=DType.F32, prefill_chunk=pc,
                                adapters=_arrays(dirs, "ab", wmap),
                                device="cpu", **kw).start()
        try:
            got = [f.result(timeout=300) for f in
                   [bat.submit(p, 7, adapter=a)
                    for p, a in zip(_PROMPTS, _NAMES)]]
            with pytest.raises(ValueError, match="unknown adapter"):
                bat.submit(_PROMPTS[0], 2, adapter="nope")
        finally:
            bat.stop()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=str(pc))
    for p, a, w in zip(_PROMPTS[:3], _NAMES[:3], want[:3]):
        np.testing.assert_array_equal(_merged_tokens(dirs, a, p, 7), w)
    assert not np.array_equal(want[1], want[2])


@pytest.mark.parametrize("pchunk", [None, 4])
def test_shared_prefix_is_computed_under_each_adapter(dirs, pchunk):
    """prefix_ids: a base request and an `a` request each equal their
    merged-at-load model fed prefix + prompt, so the prefix's KV was
    computed under the request's own adapter."""
    pb, _ = _bundles(dirs["gpt2"], ragged_decode=True)
    prefix = np.asarray([7, 19, 3, 88, 140, 2], np.int64)
    bat = ContinuousBatcher(
        next(iter(pb.models.values())), max_len=MAX_LEN, max_batch=4,
        chunk=4, cache_dtype=DType.F32, prompt_buckets=(16,),
        prefix_ids=prefix, prefill_chunk=pchunk, device="cpu",
        adapters=_arrays(dirs, "a", pb.interfaces["text"]["weight_map"])
    ).start()
    try:
        f1 = bat.submit(_PROMPTS[0], 6)
        f2 = bat.submit(_PROMPTS[1], 6, adapter="a")
        out_base, out_a = f1.result(timeout=300), f2.result(timeout=300)
    finally:
        bat.stop()
    np.testing.assert_array_equal(out_base, _merged_tokens(
        dirs, None, np.concatenate([prefix, _PROMPTS[0]]), 6))
    np.testing.assert_array_equal(out_a, _merged_tokens(
        dirs, "a", np.concatenate([prefix, _PROMPTS[1]]), 6))


def test_auto_prefix_pool_is_keyed_by_adapter_and_base_chunks_switch(dirs):
    """One 40-token prompt under base, then `a`, then base again, one at
    a time: all-base chunks run the pre-surgery graph, the `a` request
    must not reuse the base request's pooled prefix row (nor the base
    request `a`'s), and each equals its merged-at-load model."""
    pb, _ = _bundles(dirs["gpt2"], ragged_decode=True)
    bat = ContinuousBatcher(
        next(iter(pb.models.values())), max_len=MAX_LEN, max_batch=2,
        chunk=4, cache_dtype=DType.F32, prompt_buckets=(16, 32, 48),
        auto_prefix=4, device="cpu",
        adapters=_arrays(dirs, "a", pb.interfaces["text"]["weight_map"])
    ).start()
    ran = {"base": 0, "lora": 0}
    iface = bat.iface
    for key, ex in (("base", "_exec"), ("lora", "_exec_lora")):
        inner = getattr(iface, ex)

        def counted(feeds, inner=inner, key=key):
            ran[key] += 1
            return inner(feeds)
        setattr(iface, ex, counted)
    p = np.random.default_rng(9).integers(0, V, (40,)).astype(np.int64)
    try:
        outs = [bat.submit(p, 5, adapter=a).result(timeout=300)
                for a in (None, "a", None, "a")]
        stats = bat.stats()["auto_prefix"]
    finally:
        bat.stop()
    assert stats["pool"] == 2 and stats["hits"] == 2, stats
    assert ran["base"] > 0 and ran["lora"] > 0
    np.testing.assert_array_equal(outs[0], outs[2])
    np.testing.assert_array_equal(outs[1], outs[3])
    np.testing.assert_array_equal(outs[0], _merged_tokens(dirs, None, p, 5))
    np.testing.assert_array_equal(outs[1], _merged_tokens(dirs, "a", p, 5))


def _req(port, method, path, body=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        c.request(method, path,
                  body=None if body is None else json.dumps(body),
                  headers={"Content-Type": "application/json"})
        r = c.getresponse()
        return r.status, json.loads(r.read())
    finally:
        c.close()


def test_server_adapters_openai_aliases_and_load_adapter(dirs):
    """serve_adapters=a,b on the port's Server: `/v1/models` lists
    <model>:a and :b; the `adapter` field, the <model>:<adapter> alias
    and the bare name give one answer, the merged-at-load one; an
    unknown adapter, adapter with logprobs, regex or logit_bias, and an
    ambiguous bare name answer 400; the WebSocket protocol's
    generate_text serves `adapter` through the batcher and refuses it on
    the direct path's routes. load_adapter c over the WebSocket
    protocol swaps batchers while a request is in flight (it finishes),
    c then serves its merged-at-load tokens, and a second load of c or
    a missing dir fails without touching the registry."""
    from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer

    srv = Server(device="cpu")
    (entry,) = srv.models.run_loader("transformers", {
        "path": str(dirs["gpt2"]), "dtype": "f32", "max_len": MAX_LEN,
        "ragged_decode": True, "serve_batch": 4,
        "serve_adapters": f"a={dirs['a']},b={dirs['b']}"})
    api = OpenAIApi(srv, "127.0.0.1", 0).start()
    tok = ByteTokenizer()
    try:
        s, listing = _req(api.port, "GET", "/v1/models")
        ids = [m["id"] for m in listing["data"]]
        assert ids == [entry.name, f"{entry.name}:a", f"{entry.name}:b"]
        body = {"prompt": "hi", "max_tokens": 5, "temperature": 0}
        texts = []
        for extra in ({"model": entry.name, "adapter": "a"},
                      {"model": f"{entry.name}:a"}, {"model": "a"}):
            s, d = _req(api.port, "POST", "/v1/completions",
                        {**body, **extra})
            assert s == 200, d
            texts.append(d["choices"][0]["text"])
        assert texts[0] == texts[1] == texts[2]
        ids_hi = np.asarray(tok.encode("hi"), np.int64)
        merged = [int(t) for t in _merged_tokens(dirs, "a", ids_hi, 5)]
        assert texts[0] == tok.decode(merged)
        for extra, match in (
                ({"adapter": "zz"}, "unknown adapter"),
                ({"adapter": "a", "logprobs": 1}, "logprobs"),
                ({"adapter": "a", "regex": "[a-z]+"}, "constrained"),
                ({"adapter": "a", "logit_bias": {"5": 1.0}}, "logit_bias")):
            s, d = _req(api.port, "POST", "/v1/completions",
                        {**body, "model": entry.name, **extra})
            assert s == 400 and match in d["error"]["message"], d
        # a second model serving an adapter named `a`: the bare name is
        # ambiguous, the qualified one is not
        (e2,) = srv.models.run_loader("transformers", {
            "path": str(dirs["gpt2"]), "dtype": "f32", "max_len": MAX_LEN,
            "ragged_decode": True, "serve_adapters": f"a={dirs['a']}"})
        s, d = _req(api.port, "POST", "/v1/completions",
                    {**body, "model": "a"})
        assert s == 400 and "ambiguous" in d["error"]["message"], d
        srv._dispatch({"type": "unload_model", "model_id": e2.id})
        # the WebSocket protocol's generate_text with `adapter`
        msg = {"type": "generate_text", "model_id": entry.id, "prompt": "hi",
               "max_new_tokens": 5, "tokenizer": "bytes", "adapter": "a"}
        assert srv._dispatch(msg) is None
        while True:
            r = srv.scheduler.reports.get(timeout=300)
            if r["type"] in ("job_result", "job_error"):
                break
        assert r["type"] == "job_result" and r["result"]["text"] == texts[0]
        with pytest.raises(ValueError, match="batcher alone"):
            srv._dispatch(dict(msg, regex="a+"))
        with pytest.raises(ValueError, match="unknown adapter"):
            srv._dispatch(dict(msg, adapter="zz"))

        old = srv._batcher(entry)
        slow = old.submit(ids_hi, 30, adapter="b")
        rep = srv._dispatch({"type": "load_adapter", "model_id": entry.id,
                             "name": "c", "path": str(dirs["c"])})
        assert rep["type"] == "adapter_loaded"
        assert rep["adapters"] == ["a", "b", "c"]
        new = srv._batcher(entry)
        assert new is not old
        assert slow.result(timeout=300).shape == (30,)
        s, d = _req(api.port, "POST", "/v1/completions",
                    {**body, "model": f"{entry.name}:c"})
        assert s == 200, d
        merged_c = [int(t) for t in _merged_tokens(dirs, "c", ids_hi, 5)]
        assert d["choices"][0]["text"] == tok.decode(merged_c)
        with pytest.raises(ValueError, match="already loaded"):
            srv._dispatch({"type": "load_adapter", "model_id": entry.id,
                           "name": "c", "path": str(dirs["c"])})
        with pytest.raises(FileNotFoundError):
            srv._dispatch({"type": "load_adapter", "model_id": entry.id,
                           "name": "x", "path": str(dirs["gpt2"] / "no")})
        assert srv._batcher(entry) is new
        assert sorted(entry.interfaces["text"]["adapters"]) == ["a", "b", "c"]
    finally:
        api.stop()
        for b in srv._batchers.values():
            b.stop()


@pytest.mark.parametrize("quantize", ["int8", "q4_0"])
def test_adapters_on_quantized_weights_are_refused(quantize):
    """As in the JAX package: adapters need dense weights. A GPT-2 of
    n_embd 128, whose c_fc (128 x 512) takes both quantizations."""
    from whisper_tensor_tpu.importers.recipes.llm.gpt2 import (
        GPT2Config, build_gpt2_step, random_gpt2_weights)
    from whisper_tensor_tpu.interfaces.text import (
        TextInferenceInterface as JaxTextInterface)
    from whisper_tensor_tpu.model import Model as JaxModel
    from whisper_tensor_tpu_torch.model import Model

    cfg = GPT2Config(n_layer=1, n_head=2, n_embd=128, vocab_size=V,
                     n_positions=MAX_LEN)
    data = build_gpt2_step(random_gpt2_weights(cfg), cfg, max_len=MAX_LEN,
                           dtype=JaxDType.F32, pos_per_row=True)
    ad = {"a": {"wfc_0": (np.zeros((128, 2), np.float32),
                          np.zeros((2, 512), np.float32), 1.0)}}
    for iface in (
            TextInferenceInterface(Model.new_from_onnx(data), max_len=MAX_LEN,
                                   quantize=quantize, device="cpu"),
            JaxTextInterface(JaxModel.new_from_onnx(data), max_len=MAX_LEN,
                             quantize=quantize)):
        with pytest.raises(ValueError, match="quantized"):
            iface.install_adapters(ad)


def test_serve_adapters_on_packed_weights_are_refused(dirs):
    """serve_adapters over a host-quantized (q4_0) checkpoint: the
    batcher's construction raises, so no batcher is registered."""
    srv = Server(device="cpu")
    (entry,) = srv.models.run_loader("transformers", {
        "path": str(dirs["gpt2"]), "dtype": "f32", "max_len": MAX_LEN,
        "ragged_decode": True, "quantize": "q4_0",
        "serve_adapters": f"a={dirs['a']}"})
    with pytest.raises(ValueError, match="quantized"):
        srv._batcher(entry)
    assert not srv._batchers
