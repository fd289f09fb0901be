"""T5 and the seq2seq interface on the port, against the JAX package, on
the CPU.

Tiny checkpoints written by transformers (seeded torch init; the JAX
package's tests/test_t5.py sizes: 2 + 2 layers, 2 heads of 8, d_model
16, d_ff 32, 8 buckets up to distance 16; a vocabulary of 300 so that
the byte tokenizer's ids fit), with relu FFNs and a tied head, and with
gated-gelu FFNs and an untied head. The encoder length is 12, the
decoder's cache 16.

* The port's recipe writes the JAX recipe's ONNX bytes (encoder and
  decoder step, f32 and bf16), and both packages' loaders give the same
  `text2text` spec.
* Encoder outputs, teacher-forced decoder logits (the JAX package's
  step graph through its oracle) within 1e-4 of the largest |value|,
  greedy tokens and beams of 4 equal at f32. The beams are compared on
  inputs whose candidate scores have no tie within 1e-6 (the first
  step's is checked here): torch.topk and lax.top_k order equal scores
  differently.
* Every Attention of both graphs takes the plain path in bf16 (the
  per-head relative-position bias, one query row a decoder step).
* A prompt shorter than the encoder length is padded and masked (the
  loader's graphs take `attention_mask`, ROADMAP C28): its encoder
  outputs at the prompt's positions and its greedy tokens equal the JAX
  package's graphs built at the prompt's own length, and
  `transformers`' encoder and `generate` under `attention_mask`.
* `cli generate` on a T5 directory, greedy and --num-beams 4: a short
  prompt, against the JAX interface built at the prompt's length (the
  JAX cli takes only prompts of its encoder's length).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
transformers = pytest.importorskip("transformers")

from whisper_tensor_tpu.dtype import DType as JaxDType  # noqa: E402
from whisper_tensor_tpu.importers.loaders import (  # noqa: E402
    loader_registry as jax_loaders)
from whisper_tensor_tpu.importers.recipes.llm import t5 as jax_t5  # noqa: E402
from whisper_tensor_tpu.interfaces.seq2seq import (  # noqa: E402
    Seq2SeqInterface as JaxSeq2Seq)
from whisper_tensor_tpu_torch import cli  # noqa: E402
from whisper_tensor_tpu_torch.dtype import DType  # noqa: E402
from whisper_tensor_tpu_torch.importers.loaders import (  # noqa: E402
    loader_registry)
from whisper_tensor_tpu_torch.importers.recipes.llm import t5  # noqa: E402
from whisper_tensor_tpu_torch.interfaces.seq2seq import (  # noqa: E402
    Seq2SeqInterface)
from whisper_tensor_tpu_torch.interfaces.text import (  # noqa: E402
    SamplingParams)
from whisper_tensor_tpu_torch.milli.ops import attention  # noqa: E402
from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer  # noqa: E402

ENC_LEN, MAX_DEC, V = 12, 16, 300
KINDS = {"relu": False, "gated": True}
IDS = np.random.default_rng(5).integers(2, V, (2, ENC_LEN)).astype(np.int64)


def _hf(kind):
    from transformers import T5Config, T5ForConditionalGeneration

    gated = KINDS[kind]
    torch.manual_seed(0)
    hf = T5ForConditionalGeneration(T5Config(
        num_layers=2, num_decoder_layers=2, num_heads=2, d_model=16,
        d_kv=8, d_ff=32, vocab_size=V, dropout_rate=0.0,
        feed_forward_proj="gated-gelu" if gated else "relu",
        tie_word_embeddings=not gated, decoder_start_token_id=0,
        relative_attention_num_buckets=8,
        relative_attention_max_distance=16))
    return hf.eval()


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    out = {}
    for kind in KINDS:
        d = tmp_path_factory.mktemp(kind)
        _hf(kind).save_pretrained(str(d), safe_serialization=True)
        out[kind] = str(d)
    return out


def _load(pkg, path, dtype="f32", enc_len=ENC_LEN):
    reg = loader_registry() if pkg == "port" else jax_loaders()
    return reg["transformers"].load({"path": path, "max_len": MAX_DEC,
                                     "enc_len": enc_len, "dtype": dtype})


def _ifaces(path, dtype="f32", jax_enc_len=ENC_LEN):
    pb, jb = (_load("port", path, dtype),
              _load("jax", path, dtype, enc_len=jax_enc_len))
    ps, js = pb.interfaces["text2text"], jb.interfaces["text2text"]
    assert ps == dict(js, enc_len=ENC_LEN)
    cache = {"f32": DType.F32, "bf16": DType.BF16}[dtype]
    port = Seq2SeqInterface(pb.models[ps["encoder"]],
                            pb.models[ps["decoder"]], max_len=ps["max_len"],
                            start_token=ps["start"], eos_token=ps["eos"],
                            cache_dtype=cache, device="cpu")
    ref = JaxSeq2Seq(jb.models[js["encoder"]], jb.models[js["decoder"]],
                     max_len=js["max_len"], start_token=js["start"],
                     eos_token=js["eos"])
    return port, ref


def _close(got, want, frac=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= frac * np.abs(want).max()


@pytest.mark.parametrize("dt", ["F32", "BF16"])
@pytest.mark.parametrize("part", ["encoder", "decoder"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_recipes_write_the_references_onnx_bytes(kind, part, dt):
    sd = {k: v.float().numpy() for k, v in _hf(kind).state_dict().items()}
    outs = []
    for pkg, dtype in ((t5, DType[dt]), (jax_t5, JaxDType[dt])):
        cfg = pkg.T5Config(num_layers=2, num_decoder_layers=2, num_heads=2,
                           d_model=16, d_kv=8, d_ff=32, vocab_size=V,
                           relative_attention_num_buckets=8,
                           relative_attention_max_distance=16,
                           is_gated_act=KINDS[kind],
                           tie_word_embeddings=not KINDS[kind])
        if part == "encoder":
            outs.append(pkg.build_t5_encoder(sd.__getitem__, cfg, ENC_LEN,
                                             dtype=dtype))
        else:
            outs.append(pkg.build_t5_decoder_step(
                lambda n: sd[n if n in sd else "shared.weight"], cfg,
                MAX_DEC, ENC_LEN, dtype=dtype))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("kind", list(KINDS))
def test_encoder_and_teacher_forced_decoder_match(checkpoints, kind):
    port, ref = _ifaces(checkpoints[kind])
    enc = port.encode(IDS)
    want = ref.encode(IDS)
    for n in ["encoder_states"] + ref.cross_in:
        _close(enc[n], want[n])
    caches = port.fresh_cache(2)
    crosses = [enc[n] for n in port.cross_in]
    feeds = {n: np.asarray(want[n]) for n in ref.cross_in}
    for i in range(2):
        for c in ("k", "v"):
            feeds[f"cache_{c}_{i}"] = np.zeros((2, 2, MAX_DEC, 8), np.float32)
    for t, tok in enumerate([0, 7, 33, 12]):
        ids = np.full((2, 1), tok, np.int64)
        got = port._step(torch.from_numpy(ids), torch.tensor(t), caches,
                         crosses)
        out = ref.decoder.eval({**feeds, "input_ids": ids,
                                "pos": np.asarray(t, np.int64)})
        for k in list(feeds):
            if k.startswith("cache_"):
                feeds[k] = out["new_" + k]
        _close(got.numpy(), out["logits"])


@pytest.mark.parametrize("kind", list(KINDS))
def test_greedy_tokens_equal_the_jax_packages(checkpoints, kind):
    port, ref = _ifaces(checkpoints[kind])
    np.testing.assert_array_equal(port.generate_tokens(IDS, 10),
                                  ref.generate_tokens(IDS, 10))


@pytest.mark.parametrize("kind", list(KINDS))
def test_beams_equal_the_jax_packages(checkpoints, kind):
    port, ref = _ifaces(checkpoints[kind])
    enc = port.encode(IDS)
    lg = port._step(port._prefix(2), torch.tensor(0), port.fresh_cache(2),
                    [enc[n] for n in port.cross_in])
    top = torch.topk(torch.log_softmax(lg[:, 0].float(), -1), 5).values
    assert (top[:, :-1] - top[:, 1:]).min() > 1e-6
    np.testing.assert_array_equal(port.beam_search_tokens(IDS, 8, beam=4),
                                  ref.beam_search_tokens(IDS, 8, beam=4))


def test_sampled_generation_repeats_under_its_seed(checkpoints):
    port, _ = _ifaces(checkpoints["gated"])
    sp = SamplingParams(temperature=0.9, top_k=20, seed=3)
    a = port.generate_tokens(IDS, 8, sampling=sp)
    assert a.shape == (2, 8) and a.max() < V
    np.testing.assert_array_equal(a, port.generate_tokens(IDS, 8,
                                                          sampling=sp))


def test_t5_attention_takes_the_plain_path(checkpoints, monkeypatch):
    routes = []
    for name in ("flash_mode", "pos_mode"):
        real = getattr(attention, name)

        def spy(*a, _real=real, **kw):
            routes.append(_real(*a, **kw))
            return routes[-1]

        monkeypatch.setattr(attention, name, spy)
    for name in ("flash_attention", "decode_attention"):
        monkeypatch.setattr(attention, name, lambda *a, **k: pytest.fail(
            "an attention kernel wrapper was called"))
    port, _ = _ifaces(checkpoints["relu"], dtype="bf16")
    port.generate_tokens(IDS, 3)
    # the encoder's 2 self-attentions, then 3 steps x 2 layers x
    # (self + cross)
    assert len(routes) == 14 and routes == [None] * 14


@pytest.mark.parametrize("beams", [1, 4])
def test_cli_generate_serves_t5(checkpoints, capsys, beams):
    path = checkpoints["gated"]
    cli.main(["generate", "--model", path, "--device", "cpu", "--prompt",
              "hello", "--max-new-tokens", "6", "--num-beams", str(beams),
              "-c", "dtype=f32", "-c", f"enc_len={ENC_LEN}", "--max-len",
              str(MAX_DEC)])
    out = capsys.readouterr().out.rstrip("\n")
    ids = np.asarray([ByteTokenizer().encode("hello")], np.int64)
    _, ref = _ifaces(path, jax_enc_len=ids.shape[1])
    toks = [int(t) for t in (ref.generate_tokens(ids, 6) if beams == 1
                             else ref.beam_search_tokens(ids, 6, beam=4))[0]]
    if 1 in toks:
        toks = toks[:toks.index(1)]
    assert out == ByteTokenizer().decode(toks)


SHORT = 5      # a prompt of 5 tokens, padded to ENC_LEN = 12


@pytest.mark.parametrize("kind", list(KINDS))
def test_a_short_prompt_attends_no_pad(checkpoints, kind):
    """ROADMAP C28: the pads of a short prompt are masked out of the
    encoder's self-attention and the decoder's cross-attention. The
    port's padded, masked run against the JAX package's graphs built at
    the prompt's length and against transformers under attention_mask."""
    port, ref = _ifaces(checkpoints[kind], jax_enc_len=SHORT)
    assert port.masked and "cross_mask" in port.cross_in
    ids = IDS[:, :SHORT]
    enc = port.encode(ids)
    want = ref.encode(ids)
    for n in ["encoder_states"] + [c for c in port.cross_in
                                   if c != "cross_mask"]:
        axis = 1 if n == "encoder_states" else 2
        _close(np.take(enc[n].numpy(), range(SHORT), axis=axis), want[n])
    hf = _hf(kind)
    am = np.zeros((2, ENC_LEN), np.int64)
    am[:, :SHORT] = 1
    with torch.no_grad():
        hs = hf.encoder(input_ids=torch.from_numpy(
            np.pad(ids, ((0, 0), (0, ENC_LEN - SHORT)))),
            attention_mask=torch.from_numpy(am)).last_hidden_state
    _close(enc["encoder_states"][:, :SHORT].numpy(), hs[:, :SHORT].numpy())
    got = port.generate_tokens(ids, 10)
    np.testing.assert_array_equal(got, ref.generate_tokens(ids, 10))
    with torch.no_grad():
        gen = hf.generate(input_ids=torch.from_numpy(ids),
                          attention_mask=torch.ones_like(
                              torch.from_numpy(ids)),
                          max_new_tokens=10, do_sample=False, num_beams=1,
                          min_length=0)[:, 1:].numpy()
    for row, hrow in zip(got, gen):
        n = (list(row).index(1) + 1) if 1 in row else 10
        np.testing.assert_array_equal(row[:n], hrow[:n])
    np.testing.assert_array_equal(port.beam_search_tokens(ids, 6, beam=2),
                                  ref.beam_search_tokens(ids, 6, beam=2))


def test_an_unmasked_encoder_takes_only_full_prompts(checkpoints):
    """The default recipe graph (the JAX package's bytes) has no
    attention_mask: a full-length prompt runs, a short one raises rather
    than attend its pads."""
    from whisper_tensor_tpu_torch.model import Model

    jb = _load("jax", checkpoints["relu"])
    sd = {k: v.float().numpy() for k, v in _hf("relu").state_dict().items()}
    cfg = t5.T5Config(num_layers=2, num_decoder_layers=2, num_heads=2,
                      d_model=16, d_kv=8, d_ff=32, vocab_size=V,
                      relative_attention_num_buckets=8,
                      relative_attention_max_distance=16)
    enc = Model.new_from_onnx(t5.build_t5_encoder(sd.__getitem__, cfg,
                                                  ENC_LEN))
    dec = Model.new_from_onnx(t5.build_t5_decoder_step(
        lambda n: sd[n if n in sd else "shared.weight"], cfg, MAX_DEC,
        ENC_LEN))
    port = Seq2SeqInterface(enc, dec, MAX_DEC, device="cpu")
    assert not port.masked and "cross_mask" not in port.cross_in
    js = jb.interfaces["text2text"]
    ref = JaxSeq2Seq(jb.models[js["encoder"]], jb.models[js["decoder"]],
                     max_len=MAX_DEC)
    np.testing.assert_array_equal(port.generate_tokens(IDS, 6),
                                  ref.generate_tokens(IDS, 6))
    with pytest.raises(ValueError, match="attention_mask"):
        port.generate_tokens(IDS[:, :SHORT], 6)
