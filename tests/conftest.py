"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Real-TPU tests are opt-in via WT_TPU_TESTS=1 (the bench/driver path);
everything else runs on the CPU platform so the suite works on any host
and exercises multi-device sharding via --xla_force_host_platform_device_count.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

if not os.environ.get("WT_TPU_TESTS"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"
    import jax

    jax.config.update("jax_platforms", "cpu")

# persistent XLA compile cache: repeat suite runs skip recompilation
# (entries are keyed on platform, so CPU test entries never collide with
# TPU bench entries)
from whisper_tensor_tpu.compile_cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA kernels of the PyTorch "
        "port); skips where torch.cuda.is_available() is False")
