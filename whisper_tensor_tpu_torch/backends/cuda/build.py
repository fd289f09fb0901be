"""Build and load the port's CUDA kernels.

Every `.cu` file under whisper_tensor_tpu_torch/csrc/ is compiled by
nvcc, in one call, for Hopper (`-gencode arch=compute_90a,code=sm_90a`)
into one shared library with a plain C interface, which is loaded with
ctypes. No PyTorch header is included, so the build takes seconds.

The build runs at the first kernel launch of a process, never at
import. Its output goes to <repo>/build/cuda/, named by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one
is loaded as it is.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check()` turns a non-zero code into an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "cuda"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    # q, k, v, pos (int64), out, B, Hq, Hkv, L, D, scale, stream
    "wt_decode_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            ctypes.c_float, _P],
    # q, k, v, mask, pos (int64), out, B, Hq, Hkv, Sq, Skv, D, q strides
    # (b, h, s), mask batch stride, causal, scale, stream
    "wt_flash_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _LL, _LL, _LL, _LL, _I, ctypes.c_float, _P],
    # x, w_i8, scale, out, M, K, N, x_is_bf16, stream
    "wt_int8_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # cache, update, pos (int64), B, H, L, D, S, update strides (b, h, s,
    # d), mode, stream
    "wt_ragged_kv_write": [_P, _P, _P, _I, _I, _I, _I, _I, _LL, _LL, _LL,
                           _LL, _I, _P],
}


@dataclass
class BuildInfo:
    path: Path
    seconds: float      # 0.0 when an existing library was loaded
    log: str            # nvcc/ptxas output (register and smem use)


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_info: Optional[BuildInfo] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError(
            f"nvcc not found (PATH, then {home}/bin): the port's CUDA "
            f"kernels are built from source at first use")
    return found


def _compile() -> BuildInfo:
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"libwt_cuda_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return BuildInfo(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)      # atomic: a concurrent build never sees half
    return BuildInfo(out, seconds, proc.stdout + proc.stderr)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib, _info
    with _lock:
        if _lib is None:
            info = _compile()
            lib = ctypes.CDLL(str(info.path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.wt_error_string.argtypes = [ctypes.c_int]
            lib.wt_error_string.restype = ctypes.c_char_p
            _lib, _info = lib, info
        return _lib


def build_info() -> Optional[BuildInfo]:
    """How the library of this process was obtained (None before)."""
    return _info


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = library().wt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
