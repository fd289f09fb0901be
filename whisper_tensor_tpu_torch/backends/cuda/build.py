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

Each C entry point launches on the stream it is given (`raw_stream`)
and returns `cudaGetLastError()`; `check()` turns a non-zero code into
an error. `card_sms` and `kernel_limits` give the launch plans what
they size their grids by: the device's multiprocessors, and what the
`wt_*_limits` entries read of a kernel (its tile constants, and its
blocks a multiprocessor from the CUDA occupancy calculator).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "cuda"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    # q, k, v, pos (int64), out, partial acc, partial (m, l), q_type (0
    # bf16, 1 f32, 2 f16), B, Hq, Hkv, L, D, splits, chunk, scale, stream
    "wt_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _I, _I, ctypes.c_float, _P],
    # Hq, Hkv, D, limits (int[2]: heads a block, blocks a multiprocessor)
    "wt_decode_limits": [_I, _I, _I, _P],
    # q, k, v, mask, pos (int64), out, partial acc, partial (m, l), B,
    # Hq, Hkv, Sq, Skv, D, q strides (b, h, s), mask batch stride, causal,
    # scale, splits, chunk, stream
    "wt_flash_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _LL, _LL, _LL, _LL, _I, ctypes.c_float,
                           _I, _I, _P],
    # Hq, Hkv, D, limits (int[3]: heads a block, query positions a block,
    # blocks a multiprocessor)
    "wt_flash_limits": [_I, _I, _I, _P],
    # x, w_i8, scale, out, partial sums, M, K, N, x_is_bf16, path, bm,
    # splits, kchunk, sms, stream
    "wt_int8_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                       _I, _P],
    # path, bm, x_is_bf16, limits (int[3]: rows of W a stage, columns a
    # block, blocks a multiprocessor)
    "wt_int8_limits": [_I, _I, _I, _P],
    # the cp.async path: dy, w_i8, scale, dx, hi and lo scratch, partial
    # sums, M, K, N, dy_is_bf16, splits, split_cols, sms, stream
    "wt_int8_matmul_dx": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _P],
    # (none): the stage width the dx scratch rows are padded to
    "wt_int8_dx_stage_cols": [],
    # the TMA path: dy, w_i8, scale, dx, partial sums, M, K, N,
    # dy_is_bf16, splits, split_cols, sms, stream
    "wt_int8_matmul_dx_tma": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _P],
    # tma, dy_is_bf16, limits (int[4]: reduction columns a stage, rows
    # and columns of dx a block, blocks a multiprocessor)
    "wt_int8_dx_limits": [_I, _I, _P],
    # x, q, scales, offsets, out, partial sums, M, K, N, G, bits,
    # has_off, x_is_bf16, path, bm, splits, kchunk, sms, stream
    "wt_packed_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _I, _P],
    # path, bm, bits, x_is_bf16, G, limits (int[3]: rows of q a stage,
    # columns a block, blocks a multiprocessor)
    "wt_packed_limits": [_I, _I, _I, _I, _I, _P],
    # cache 0, update 0, cache 1, update 1, pos, geometry (int64[20]:
    # caches, B, H, L, D, S, mode, pos int32, pos stride, units a slab,
    # units, blocks, update strides (b, h, s, d) of each cache), stream
    "wt_kv_write": [_P, _P, _P, _P, _P, _P, _P],
    # mode, limits (int[3]: threads a block, blocks a multiprocessor,
    # cache values a unit)
    "wt_kv_write_limits": [_I, _P],
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
    if _lib is not None:
        return _lib
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


CARD_SMS = 132      # an H100 SXM's multiprocessors: the plans' CPU default


def device_index(device: torch.device) -> int:
    """The index of a CUDA device (the current one for plain "cuda")."""
    return torch.cuda.current_device() if device.index is None else device.index


@functools.lru_cache(maxsize=None)
def card_sms(index: Optional[int] = None) -> int:
    """The multiprocessors of CUDA device `index`, asked once per device
    (the launch plans size their grids by it); CARD_SMS for None, the
    plans' CPU tests."""
    if index is None:
        return CARD_SMS
    return torch.cuda.get_device_properties(index).multi_processor_count


def kernel_limits(entry: str, index: int, *args, count: int = 3) -> tuple:
    """The `count` ints a `wt_*_limits` C entry writes for `args` on CUDA
    device `index` (what the launch plans read of a kernel on the card)."""
    out = (ctypes.c_int * count)()
    with torch.cuda.device(index):
        check(getattr(library(), entry)(*args, out), entry)
    return tuple(out)


def split_units(units: int, blocks: int, wave: int, block_cost: float,
                max_splits: int) -> int:
    """The units of K (whole stages, or stages and groups) a split takes,
    for a grid of `blocks` blocks a split over `units` units, on a card
    that runs `wave` blocks at once. Splits cut each block's work but
    round the grid up to whole waves: of the split counts that keep the
    grid within two waves' worth, the one whose waves x (work per block +
    block_cost) is least, the fewest splits on a tie; a grid that fills
    two waves unsplit is not split (chip_smoke.py --plans measured these
    choices for packed_matmul)."""
    best = None
    for s in range(1, min(units, max_splits, -(-2 * wave // blocks)) + 1):
        per = -(-units // s)                         # units per split
        waves = -(-blocks * -(-units // per) // wave)
        cost = waves * (per / units + block_cost)
        if best is None or cost < best[0]:
            best = (cost, per)
    return best[1]


def raw_stream(device) -> int:
    """The handle of the current CUDA stream of `device` (a torch.device
    or a device index), for the C entry points: torch's raw-stream query
    (a torch.cuda.Stream object for it costs about 12 us of host time a
    call beside an H100)."""
    i = device if isinstance(device, int) else device_index(device)
    query = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if query is None:
        return torch.cuda.current_stream(i).cuda_stream
    return query(i)


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = library().wt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
