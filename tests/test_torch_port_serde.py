"""The port's milli serde registry against the JAX package's (ROADMAP
C29): it holds every kind the JAX registry holds, the vision kinds of
milli/ops/vision.py among them, and the port's own KVWrite.

Each of the eight vision kinds goes through the port's JSON dumps and
loads with attributes off their defaults; a milli graph holding RoiAlign
and GridSample, serialized by the JAX package, loads in the port and
evaluates to the JAX package's outputs.
"""

import json

import numpy as np
import pytest

pytest.importorskip("jax")

from whisper_tensor_tpu.milli import serde as ref_serde  # noqa: E402
from whisper_tensor_tpu_torch.milli import serde  # noqa: E402
from whisper_tensor_tpu_torch.milli.ir import MilliGraph  # noqa: E402

VISION = {
    "AffineGrid": dict(align_corners=True),
    "CenterCropPad": dict(axes=[1, 2]),
    "Col2Im": dict(dilations=[1, 2], pads=[0, 1, 0, 1], strides=[2, 1]),
    "DeformConv": dict(dilations=[1, 1], group=2, kernel_shape=[3, 3],
                       offset_group=2, pads=[1, 1, 1, 1], strides=[1, 2]),
    "GridSample": dict(mode="cubic", padding_mode="border",
                       align_corners=True),
    "ImageDecoder": dict(pixel_format="BGR"),
    "NonMaxSuppression": dict(center_point_box=True),
    "RoiAlign": dict(mode="max", output_height=3, output_width=2,
                     sampling_ratio=2, spatial_scale=0.5, half_pixel=False),
}


def test_the_registry_is_the_jax_registry_and_kv_write():
    mine, ref = serde.op_registry(), ref_serde.op_registry()
    assert set(mine) == set(ref) | {"KVWrite"}
    assert set(VISION) <= set(mine)


@pytest.mark.parametrize("kind", sorted(VISION))
def test_a_vision_kind_goes_through_dumps_and_loads(kind):
    op = serde.op_registry()[kind](**VISION[kind])
    g = MilliGraph(kind)
    g.mark_output("y", g.op1(op, g.add_input("x"), g.add_input("z")))
    text = json.dumps(serde.graph_to_json(g))
    back = serde.graph_from_json(json.loads(text))
    assert [n.op for n in back.nodes] == [op]
    assert json.dumps(serde.graph_to_json(back)) == text


def _vision_graph(pkg):
    import importlib

    vision = importlib.import_module(f"{pkg}.milli.ops.vision")
    G = importlib.import_module(f"{pkg}.milli.ir").MilliGraph
    g = G("vision")
    x, rois, idx = (g.add_input(n) for n in ("x", "rois", "idx"))
    grid = g.add_input("grid")
    g.mark_output("roi", g.op1(vision.RoiAlignMilli(
        output_height=3, output_width=2, sampling_ratio=2,
        spatial_scale=0.5), x, rois, idx))
    g.mark_output("grid", g.op1(vision.GridSampleMilli(
        padding_mode="border", align_corners=True), x, grid))
    return g


def test_a_jax_serialized_vision_graph_loads_and_evaluates_alike():
    rng = np.random.default_rng(29)
    feeds = {"x": rng.standard_normal((2, 3, 8, 8)).astype(np.float32),
             "rois": np.asarray([[0, 0, 6, 6], [2, 1, 12, 9],
                                 [4, 4, 14, 15]], np.float32),
             "idx": np.asarray([0, 1, 1], np.int64),
             "grid": rng.uniform(-1.1, 1.1, (2, 5, 4, 2)).astype(np.float32)}
    ref = _vision_graph("whisper_tensor_tpu")
    text = json.dumps(ref_serde.graph_to_json(ref))
    mine = serde.graph_from_json(json.loads(text))
    assert [n.op.KIND for n in mine.nodes] == ["RoiAlign", "GridSample"]
    want, got = ref.eval(feeds), mine.eval(feeds)
    for name in ("roi", "grid"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-6)
