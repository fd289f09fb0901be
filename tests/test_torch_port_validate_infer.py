"""The port's infer ablation harness (milli/validate_infer.py) against the
JAX package's, on the CPU.

tests/test_validate_infer.py's GPT-2 step graph (1 layer, 2 heads of 8,
vocab 50) goes through both packages' recipes, lowerings and harnesses
on the same feeds: the counts of checked ops and of checked knowledge
combinations must be equal, and neither harness may report a violation.
Then the port's own milli ops: KVWrite (pair_cache_writes on GPT-2 and
llama step graphs), QuantMatMul and PackedMatMul (a tiny llama's text
interface graph with quantize="int8" and "q4_0"), each checked and free
of violations. A planted op whose infer contradicts its eval shows that
the harness can fail.
"""

import importlib
from dataclasses import dataclass

import numpy as np
import pytest

pytest.importorskip("jax")

from whisper_tensor_tpu_torch.milli.ir import MilliGraph, MilliOp  # noqa: E402
from whisper_tensor_tpu_torch.milli.transforms import pair_cache_writes  # noqa: E402
from whisper_tensor_tpu_torch.milli.validate_infer import validate_infer  # noqa: E402
from whisper_tensor_tpu_torch.tensor_info import TensorInfo  # noqa: E402


def _gpt2_case(pkg, max_len=32):
    g2 = importlib.import_module(f"{pkg}.importers.recipes.llm.gpt2")
    Model = importlib.import_module(f"{pkg}.model").Model
    cfg = g2.GPT2Config(n_layer=1, n_head=2, n_embd=16, vocab_size=50,
                        n_positions=32)
    model = Model.new_from_onnx(g2.build_gpt2_step(
        g2.random_gpt2_weights(cfg), cfg, max_len=max_len))
    milli, weight_inputs = model.graph.to_milli()
    rng = np.random.default_rng(0)
    feeds = {"input_ids": rng.integers(0, 50, (1, 4)).astype(np.int64),
             "pos": np.asarray(0, dtype=np.int64)}
    for i in range(cfg.n_layer):
        feeds[f"cache_k_{i}"] = np.zeros((1, 2, max_len, 8), np.float32)
        feeds[f"cache_v_{i}"] = np.zeros((1, 2, max_len, 8), np.float32)
    for name in weight_inputs:
        feeds[name] = model.graph.store.get_numeric(name).numpy()
    return milli, feeds


def _messages(report):
    return [f"{v.op_kind}{v.levels}: {v.message}"
            for v in report.violations[:5]]


def test_gpt2_step_graph_checks_what_the_jax_harness_checks():
    from whisper_tensor_tpu.milli.validate_infer import (
        validate_infer as ref_validate)

    mine = validate_infer(*_gpt2_case("whisper_tensor_tpu_torch"))
    ref = ref_validate(*_gpt2_case("whisper_tensor_tpu"))
    assert mine.ok, _messages(mine)
    assert ref.ok, _messages(ref)
    assert (mine.checked_ops, mine.checked_combos) == (
        ref.checked_ops, ref.checked_combos)
    assert mine.checked_ops > 30 and mine.checked_combos > 200


def _kinds_checked(milli, feeds):
    report = validate_infer(milli, feeds)
    assert report.ok, _messages(report)
    return report, {n.op.KIND for n in milli.nodes}


def test_kv_write_of_the_pair_pass_on_gpt2():
    milli, feeds = _gpt2_case("whisper_tensor_tpu_torch")
    assert pair_cache_writes(milli) == 1
    report, kinds = _kinds_checked(milli, feeds)
    assert "KVWrite" in kinds and "DynUpdateSlice" not in kinds
    assert report.checked_ops > 30


def _llama_iface(quantize, per_row=False):
    from whisper_tensor_tpu_torch.importers.recipes.llm.llama import (
        LlamaConfig, build_llama_step)
    from whisper_tensor_tpu_torch.interfaces.text import (
        TextInferenceInterface)
    from whisper_tensor_tpu_torch.model import Model

    # widths at which the int8 pass takes the MLP's products (it skips
    # weights under 64k elements)
    cfg = LlamaConfig(num_hidden_layers=1, hidden_size=256,
                      intermediate_size=512, num_attention_heads=4,
                      num_key_value_heads=2, vocab_size=96)

    def get(name):
        rng = np.random.default_rng(sum(map(ord, name)))
        if name.endswith("norm.weight"):
            return (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
        shape = {"embed_tokens": (96, 256), "lm_head": (96, 256),
                 "q_proj": (256, 256), "o_proj": (256, 256),
                 "k_proj": (128, 256), "v_proj": (128, 256),
                 "gate_proj": (512, 256), "up_proj": (512, 256),
                 "down_proj": (256, 512)}
        key = next(k for k in shape if k in name)
        return (0.05 * rng.standard_normal(shape[key])).astype(np.float32)

    model = Model.new_from_onnx(build_llama_step(
        get, cfg, max_len=16, pos_per_row=per_row))
    return TextInferenceInterface(model, max_len=16, prompt_buckets=(8,),
                                  quantize=quantize, device="cpu")


def _iface_feeds(iface, per_row=False):
    feeds = dict(iface.host_weights())
    feeds["input_ids"] = np.random.default_rng(5).integers(
        0, 96, (1, 5)).astype(np.int64)
    feeds["pos"] = (np.zeros(1, np.int64) if per_row
                    else np.asarray(0, np.int64))
    for n in iface.cache_in_names:
        feeds[n] = np.zeros((1, 2, 16, 64), np.float32)
    return feeds


def test_kv_write_of_the_pair_pass_on_llama():
    iface = _llama_iface(None, per_row=True)
    milli = iface.milli
    assert pair_cache_writes(milli) == 1
    _, kinds = _kinds_checked(milli, _iface_feeds(iface, per_row=True))
    assert "KVWrite" in kinds


@pytest.mark.parametrize("quantize,kind", [("int8", "QuantMatMul"),
                                           ("q4_0", "PackedMatMul")])
def test_the_quantized_matmul_passes_on_a_tiny_llama(quantize, kind):
    iface = _llama_iface(quantize)
    report, kinds = _kinds_checked(iface.milli, _iface_feeds(iface))
    assert kind in kinds
    assert report.checked_ops > 30


@dataclass
class _WrongRank(MilliOp):
    """Evaluates to its input; infers one more dimension."""

    KIND = "WrongRank"

    def eval(self, inputs):
        return [inputs[0]]

    def infer(self, infos):
        return [TensorInfo.ranked(infos[0].dtype, 3)]


def test_a_contradicting_infer_is_reported():
    g = MilliGraph("bad")
    g.mark_output("y", g.op1(_WrongRank(), g.add_input("x")))
    report = validate_infer(g, {"x": np.zeros((2, 2), np.float32)})
    assert not report.ok and report.violations[0].op_kind == "WrongRank"
    assert report.checked_ops == 1 and report.checked_combos == 4
