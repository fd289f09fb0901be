"""Build and load the port's CUDA kernels.

Every `.cu` file under whisper_tensor_tpu_torch/csrc/ is compiled by
its own nvcc process, all started together, for Hopper (`-gencode
arch=compute_90a,code=sm_90a`); one more nvcc links the objects into a
shared library with a plain C interface, which is loaded with ctypes.
No PyTorch header is included, so the build takes seconds, as long as
its slowest source.

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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    # x, q, scales, offsets, out, M, K, N, G, bits, has_off, x_is_bf16,
    # stream
    "wt_packed_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _P],
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


def _run(cmds):
    """Run the commands at once; (stdout + stderr of each) or raise."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    logs, failed = [], []
    for cmd, proc in procs:
        log = proc.communicate()[0]
        logs.append(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


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
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        logs = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                     for src, o in zip(sources, objs)])
        logs += _run([[nvcc, NVCC_FLAGS[0], NVCC_FLAGS[1], "-shared", "-o",
                       str(tmp), *map(str, objs)]])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    os.replace(tmp, out)      # atomic: a concurrent build never sees half
    return BuildInfo(out, seconds, "".join(logs))


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
