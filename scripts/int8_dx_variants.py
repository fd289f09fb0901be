"""Time variants of the TMA path of int8_matmul_dx on one NVIDIA Hopper GPU.

    python3 scripts/int8_dx_variants.py

The kernel (whisper_tensor_tpu_torch/csrc/int8_matmul_dx.cu) converts
each stage's int8 W tile into its bf16 B tile twice as large, and the
tensor cores wait on that conversion. Its loading warpgroup converts the
first kLoaderUnits of a tile's 2,048 units (8 columns of a row each) and
the two consumer warpgroups the rest. This script builds the source with
kLoaderUnits at 2,048 (the loading warpgroup alone), 1,024 (the choice),
512 and 0, and once with the conversion left out (a ceiling: its output
is wrong and is not checked), each into a library of its own with the
port's nvcc flags, and times them at QLoRA's shapes (M = 1,024, the
Llama-3-8B weights), in 4 rounds that alternate their order. It prints
for each shape and variant the median ms of the rounds with their range,
and the worst share of agreement_bound against int8_matmul_dx_plain.
It imports torch and the port only, and needs nvcc (CUDA_HOME or
/usr/local/cuda).
"""

import ctypes
import os
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from whisper_tensor_tpu_torch.backends.cuda import (  # noqa: E402
    agreement_bound, build)
from whisper_tensor_tpu_torch.backends.cuda import (  # noqa: E402
    quant_matmul as qm)

SHAPES = (("q/o", 4096, 4096), ("k/v", 4096, 1024),
          ("gate/up", 4096, 14336), ("down", 14336, 4096),
          ("lm_head", 4096, 128256))
M = 1024
UNITS = "constexpr int kLoaderUnits = 1024;"
LOOP = "for (int j = 0; j < kN; ++j) {"


def variants(src: str) -> dict:
    """name -> (source, checked)."""
    assert UNITS in src and LOOP in src, "the source has changed"
    out = {f"loader {n} units": (src.replace(
        UNITS, f"constexpr int kLoaderUnits = {n};"), True)
        for n in (2048, 1024, 512, 0)}
    out["no conversion (ceiling)"] = (
        src.replace(LOOP, "for (int j = 0; j < 0; ++j) {"), False)
    return out


def build_all(srcs: dict) -> dict:
    """name -> the TMA entry of the variant's library, built in parallel."""
    out_dir = ROOT / "build" / "int8_dx_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    procs = {}
    for i, (name, (src, _)) in enumerate(srcs.items()):
        cu = out_dir / f"v{i}.cu"
        cu.write_text(src)
        so = out_dir / f"v{i}.so"
        procs[name] = (subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-shared", f"-I{build.CSRC}", "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
        fn = ctypes.CDLL(str(so)).wt_int8_matmul_dx_tma
        fn.argtypes = build._SIGNATURES["wt_int8_matmul_dx_tma"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def time_ms(torch, run, n: int, reps: int = 3, inner: int = 5) -> float:
    for i in range(2):
        run(i)
    torch.cuda.synchronize()
    times, k = [], 0
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            run(k % n)
            k += 1
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    srcs = variants((build.CSRC / "int8_matmul_dx.cu").read_text())
    fns = build_all(srcs)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    stream = build.raw_stream(dev)
    sms = build.card_sms(torch.cuda.current_device())
    print(f"{card}; M = {M}, bf16 dy; median ms of 4 rounds [range]")
    for label, K, N in SHAPES:
        copies = max(2, -(-160_000_000 // (K * N + M * N * 2)))
        sets = [(torch.randn(M, N, generator=gen, device=dev).bfloat16(),
                 torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                               dtype=torch.int8),
                 torch.rand(N, generator=gen, device=dev) * 0.01 + 1e-3)
                for _ in range(copies)]
        out = torch.empty(M, K, dtype=torch.bfloat16, device=dev)
        plan = qm.dx_plan(M, K, N, torch.bfloat16,
                          torch.cuda.current_device())
        part = (torch.empty(plan.splits, M, K, device=dev)
                if plan.splits > 1 else None)

        def runner(fn):
            def run(i):
                dy, w, s = sets[i]
                code = fn(dy.data_ptr(), w.data_ptr(), s.data_ptr(),
                          out.data_ptr(),
                          None if part is None else part.data_ptr(), M, K,
                          N, 1, plan.splits, plan.split_cols, sms, stream)
                if code:
                    raise RuntimeError(f"CUDA error {code}")
            return run

        dy, w, s = sets[0]
        ref = qm.int8_matmul_dx_plain(dy, w, s)
        mag = qm.int8_matmul_dx_plain(dy.float().abs(), w.abs(), s)
        shares = {}
        for name, fn in fns.items():
            if srcs[name][1]:
                runner(fn)(0)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs()
                shares[name] = (err / agreement_bound(ref, mag)
                                .clamp_min(1e-30)).max().item()
        times = {name: [] for name in fns}
        order = list(fns)
        for rnd in range(4):
            for name in order if rnd % 2 == 0 else order[::-1]:
                times[name].append(time_ms(torch, runner(fns[name]), copies))
        bms = 2 * M * K * N / 989e12 * 1e3
        print(f"{label} K={K} N={N} (bound {bms:.4f} ms):")
        for name, t in times.items():
            share = (f", worst err/tol {shares[name]:.4g}"
                     if name in shares else "")
            print(f"  {name}: {statistics.median(t):.4f} "
                  f"[{min(t):.4f}-{max(t):.4f}]{share}", flush=True)
            if name in shares and not shares[name] <= 1.0:
                sys.exit(f"{name} disagrees with the plain version")
        del sets, ref, mag
        torch.cuda.empty_cache()


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
