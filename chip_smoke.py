#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout (K1, the
CUDA C++ matmul, with ``nvcc``; K2, the Triton RMSNorm, at first launch),
holds each kernel against its plain PyTorch version, and then drives the
port's main path at the tensor-parallel widths of Mistral-Large-123B
(``d_model`` 12288, ``d_ff`` 28672, TP = 8 ranks stacked on one card,
4096 tokens per rank):

    PcclSession(H100_DGX) → communicator("x", 8) → planned all_reduce,
    reduce_scatter, all_gather and all_to_all, ring_ef8 all_reduce,
    fused matmul → reduce-scatter (K1), fused all-reduce → RMSNorm (K2).

Every check that fails raises, so the script exits non-zero and prints no
result line.  It exits non-zero at once when CUDA is not available or the
``repro_torch`` package is not beside it.  The last line is the device
summary ``{"ok": true, "device": {...}}``; the line before it is the
kernels' JSON record, and the line before that the card's name and power
limit from ``nvidia-smi``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# Mistral-Large-123B widths (src/repro/configs/mistral_large_123b.py), TP = 8
TP = 8
TOKENS = 4096          # tokens per rank
D_MODEL = 12288
D_FF = 28672
BLOCKS = (128, 128, 128)
EPS = 1e-5
SEED = 0

# Published peaks of one H100 SXM (dense): bf16 tensor cores, fp32 CUDA
# cores, HBM bandwidth.  Bounds are stated against these.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

# Tolerances of a kernel against its plain version (rtol, atol).  bf16:
# the repo's kernel tolerance (tests/test_kernels.py), which covers a
# one-ulp flip of the final cast.  fp32: rtol as the repo's; atol 1e-4 for
# K1, whose fp32 sum over K = 3584 terms runs in another order than the
# plain version's (error ~ sqrt(K) · 2^-24 · |partial sum| per element).
KERNEL_TOL = {
    ("matmul", "bfloat16"): (2e-2, 2e-2),
    ("matmul", "float32"): (2e-5, 1e-4),
    ("rmsnorm", "bfloat16"): (2e-2, 2e-2),
    ("rmsnorm", "float32"): (2e-5, 2e-5),
}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Median device time of one call, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(torch, got, want, name: str, dtype: str) -> float:
    """Max-abs difference of a kernel and its plain version, within tolerance."""
    rtol, atol = KERNEL_TOL[(name, dtype)]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    max_err = err.max().item()
    rel = max_err / max(w.abs().max().item(), 1e-30)
    ok = bool((err <= atol + rtol * w.abs()).all().item())
    log(f"  {name}[{dtype}] kernel vs plain: max_abs_err={max_err:.3e} "
        f"max_rel_err={rel:.3e} tol=(rtol {rtol}, atol {atol})")
    check(bool(torch.isfinite(g).all().item()), f"{name}[{dtype}] not finite")
    check(ok, f"{name}[{dtype}] disagrees with its plain version")
    return max_err


def bound(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes")


# ------------------------------------------------------------ kernel phase


def kernel_phase(torch, gen, dtype_name: str) -> dict:
    """Each kernel at its main-path shape against its plain version, timed."""
    import torch.nn.functional as F

    from repro_torch.kernels.matmul import matmul_cuda, matmul_reference
    from repro_torch.kernels.rmsnorm import rmsnorm_reference, rmsnorm_triton

    dt = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    out = {}

    # K1: all ranks' rows of the fused mm+RS step, (TP·T, d_ff/TP) @ (d_ff/TP, d_model)
    M, K, N = TP * TOKENS, D_FF // TP, D_MODEL
    x = torch.randn(M, K, generator=gen, device=dev).to(dt)
    w = (torch.randn(K, N, generator=gen, device=dev) / math.sqrt(K)).to(dt)
    got = matmul_cuda(x, w)
    want = matmul_reference(x, w, block_k=BLOCKS[2])
    err = compare(torch, got, want, "matmul", dtype_name)
    chunks = torch.cat([matmul_cuda(c, w) for c in x.split(TOKENS)])
    check(torch.equal(chunks, got), f"matmul[{dtype_name}] per-chunk calls differ from one whole-M call")
    log(f"  matmul[{dtype_name}] {TP} per-chunk calls == one whole-M call: bit-identical")
    del want, chunks
    ms = time_ms(torch, lambda: matmul_cuda(x, w), 5)
    plain_ms = time_ms(torch, lambda: matmul_reference(x, w, block_k=BLOCKS[2]), 3)
    lib_ms = time_ms(torch, lambda: torch.matmul(x, w), 5)
    flops = 2.0 * M * N * K
    nbytes = (M * K + K * N + M * N) * x.element_size()
    b_ms, b_by = bound(flops, nbytes, dtype_name)
    out["matmul"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms, shape=[M, K, N])
    log(f"  matmul[{dtype_name}] ({M}x{K})@({K}x{N}): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"torch.matmul {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), "
        f"{flops / ms / 1e9:.1f} TFLOP/s")
    del x, w, got

    # K2: the all-reduced activation of every rank, (TP·T, d_model)
    rows, d = TP * TOKENS, D_MODEL
    x = torch.randn(rows, d, generator=gen, device=dev).to(dt)
    gamma = torch.randn(d, generator=gen, device=dev) + 1.0
    got = rmsnorm_triton(x, gamma, eps=EPS)
    want = rmsnorm_reference(x, gamma, eps=EPS)
    err = compare(torch, got, want, "rmsnorm", dtype_name)
    del want
    ms = time_ms(torch, lambda: rmsnorm_triton(x, gamma, eps=EPS), 10)
    plain_ms = time_ms(torch, lambda: rmsnorm_reference(x, gamma, eps=EPS), 5)
    g_lib = gamma.to(dt)
    if hasattr(F, "rms_norm"):
        lib_ms = time_ms(torch, lambda: F.rms_norm(x, (d,), g_lib, EPS), 10)
    else:
        lib_ms = time_ms(
            torch, lambda: x.float() * torch.rsqrt(x.float().pow(2).mean(-1, keepdim=True) + EPS) * gamma, 10
        )
    nbytes = 2 * rows * d * x.element_size() + d * gamma.element_size()
    flops = 4.0 * rows * d
    b_ms, b_by = bound(flops, nbytes, dtype_name)
    out["rmsnorm"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=lib_ms, shape=[rows, d])
    log(f"  rmsnorm[{dtype_name}] ({rows}x{d}): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"library {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), "
        f"{nbytes / ms / 1e6:.1f} GB/s")
    return out


# --------------------------------------------------------- main path phase


def main_path(torch, gen, device) -> dict:
    """The port's main path, as a user calls it.  Returns what it produced,
    for the checks made after the counted window."""
    from repro_torch import PcclSession
    from repro_torch.comm import fusion
    from repro_torch.core import cost_model as cm
    from repro_torch.kernels.matmul import matmul_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_triton

    results = {}
    session = PcclSession(cm.H100_DGX, device=device)
    comm = session.communicator("x", TP)
    x = torch.randn(TP, TOKENS, D_MODEL, generator=gen, device=device).to(torch.bfloat16)
    nbytes = float(TOKENS * D_MODEL * x.element_size())
    results["x"] = x

    t = time.perf_counter()
    for coll in ("all_reduce", "reduce_scatter", "all_gather", "all_to_all"):
        sched = comm.axis_schedule(coll, nbytes)
        log(f"  plan {coll} {nbytes / 2**20:.0f} MiB: {sched.algorithm}, "
            f"{sched.num_rounds} rounds, planned {comm.estimate(coll, nbytes) * 1e6:.1f} us")
    results["all_reduce"] = comm.all_reduce(x)
    results["reduce_scatter"] = comm.reduce_scatter(x)
    results["all_gather"] = comm.all_gather(results["reduce_scatter"])
    results["all_to_all"] = comm.all_to_all(x)
    torch.cuda.synchronize(device)
    log(f"  phase collectives (bf16): {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    tol = cm.compressed_ef_error_bound(TP)
    comm_ef = session.communicator("x", TP, rel_error_tol=tol)
    results["ef8_algorithm"] = comm_ef.chosen_algorithm("all_reduce", nbytes)
    results["ring_ef8"] = comm_ef.all_reduce(x)
    torch.cuda.synchronize(device)
    log(f"  phase ring_ef8 all_reduce: {time.perf_counter() - t:.3f} s "
        f"(algorithm {results['ef8_algorithm']})")

    comm_ring = session.communicator("x", TP, algorithm="ring")
    K = D_FF // TP
    for name in ("bfloat16", "float32"):
        dt = getattr(torch, name)
        xm = torch.randn(TP, TOKENS, K, generator=gen, device=device).to(dt)
        w = (torch.randn(K, D_MODEL, generator=gen, device=device) / math.sqrt(K)).to(dt)
        t = time.perf_counter()
        before = session.exec_stats().fused_dispatches
        k1_before = matmul_cuda.launches
        out = fusion.fused_matmul_reduce_scatter(
            comm_ring, xm, w, block_m=BLOCKS[0], block_n=BLOCKS[1], block_k=BLOCKS[2]
        )
        torch.cuda.synchronize(device)
        check(session.exec_stats().fused_dispatches == before + 1,
              f"fused mm+RS [{name}] did not take the fused path")
        check(device.type != "cuda" or matmul_cuda.launches > k1_before,
              f"fused mm+RS [{name}] launched no K1")
        log(f"  phase fused matmul→reduce-scatter [{name}] x {tuple(xm.shape)} w {tuple(w.shape)}: "
            f"{time.perf_counter() - t:.3f} s")
        results[f"mm_rs_{name}"] = (xm, w, out)

    gamma = torch.randn(D_MODEL, generator=gen, device=device) + 1.0
    t = time.perf_counter()
    before = session.exec_stats().fused_dispatches
    k2_before = rmsnorm_triton.launches
    results["ar_rms"] = fusion.fused_all_reduce_rmsnorm(comm, x, gamma, eps=EPS)
    torch.cuda.synchronize(device)
    check(session.exec_stats().fused_dispatches == before + 1,
          "fused AR+RMSNorm did not take the fused path")
    check(device.type != "cuda" or rmsnorm_triton.launches > k2_before,
          "fused AR+RMSNorm launched no K2")
    log(f"  phase fused all-reduce→RMSNorm [bfloat16]: {time.perf_counter() - t:.3f} s")
    results.update(session=session, comm=comm, comm_ring=comm_ring, gamma=gamma)
    return results


def check_main_path(torch, r) -> None:
    """What the main path produced, held against the port's own oracles."""
    from repro_torch.api import NativeBackend
    from repro_torch.comm import fusion
    from repro_torch.comm import primitives as prims
    from repro_torch.core import cost_model as cm
    from repro_torch.kernels.rmsnorm import rmsnorm

    x, comm = r["x"], r["comm"]
    native = NativeBackend()
    A = x.abs().max().item()
    nbytes = float(TOKENS * D_MODEL * x.element_size())
    for coll in ("all_reduce", "reduce_scatter", "all_gather", "all_to_all"):
        got = r[coll]
        src = r["reduce_scatter"] if coll == "all_gather" else x
        want = getattr(native, coll)(comm, src)
        check(got.shape == want.shape, f"{coll}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        check(bool(torch.isfinite(got).all().item()), f"{coll}: not finite")
        err = (got.float() - want.float()).abs().max().item()
        if coll in ("all_gather", "all_to_all"):
            # pure data movement: exact
            check(err == 0.0, f"{coll} differs from the native backend")
            log(f"  {coll} [bfloat16] vs native: bit-identical")
        else:
            # each of the schedule's R rounds rounds a partial sum to bf16
            # (error <= 2^-9 · n · max|x| each) where native rounds once
            rounds = comm.axis_schedule(coll, nbytes).num_rounds
            tol = (rounds + 1) * 2.0 ** -9 * TP * A
            log(f"  {coll} [bfloat16] vs native: max_abs_err={err:.3e} (tol {tol:.3e})")
            check(err <= tol, f"{coll} disagrees with the native backend")

    # fp32: the engine against the per-round interpreter, on one schedule
    x32 = x.float()
    shard32 = r["reduce_scatter"].float()
    for coll in ("all_reduce", "reduce_scatter", "all_gather", "all_to_all"):
        src = shard32 if coll == "all_gather" else x32
        sched = comm.axis_schedule(coll, 4.0 * TOKENS * D_MODEL)
        got = getattr(prims, coll)(src, sched)
        want = prims.run_reference(coll, src, sched)
        check(torch.equal(got, want), f"{coll} [float32] engine differs from run_reference")
        log(f"  {coll} [float32] engine vs run_reference ({sched.algorithm}): bit-identical")
        del got, want
    del x32, shard32

    check(r["ef8_algorithm"] == "ring_ef8", f"auto picked {r['ef8_algorithm']} under the ring_ef8 tolerance")
    exact = x.float().sum(0)
    err = (r["ring_ef8"].float() - exact).abs().max().item()
    bound = cm.compressed_ef_error_bound(TP) * TP * A
    log(f"  ring_ef8 all_reduce vs exact sum: max_abs_err={err:.3e} "
        f"(bound(n)·n·max|x| = {bound:.3e}, rel {err / (TP * A):.3e})")
    check(bool(torch.isfinite(r["ring_ef8"]).all().item()) and err <= bound,
          "ring_ef8 outside compressed_ef_error_bound")
    del exact

    for name in ("bfloat16", "float32"):
        xm, w, out = r[f"mm_rs_{name}"]
        check(out.shape == (TP, TOKENS // TP, D_MODEL), f"mm+RS [{name}] shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all().item()), f"mm+RS [{name}] not finite")
        unfused = fusion._unfused_matmul_reduce_scatter(r["comm_ring"], xm, w, blocks=BLOCKS)
        check(torch.equal(out, unfused), f"fused mm+RS [{name}] differs from unfused")
        log(f"  fused matmul→reduce-scatter [{name}] vs unfused on the card: bit-identical")

    out = r["ar_rms"]
    check(bool(torch.isfinite(out).all().item()), "AR+RMSNorm not finite")
    unfused = rmsnorm(comm.all_reduce(x), r["gamma"], eps=EPS)
    check(torch.equal(out, unfused), "fused AR+RMSNorm differs from all_reduce → K2")
    log("  fused all-reduce→RMSNorm [bfloat16] vs all_reduce → K2: bit-identical")


def warm_timings(torch, r) -> None:
    """Warm device time of each main-path call (after the counted window).

    Collectives are timed against the least bytes they must move on one
    card (read the stacked operand once, write the result once).  Fused
    and unfused seams are timed in turns — unfused, fused, fused, unfused.
    """
    from repro_torch.comm import fusion
    from repro_torch.kernels.rmsnorm import rmsnorm

    x, comm = r["x"], r["comm"]
    for coll in ("all_reduce", "reduce_scatter", "all_gather", "all_to_all"):
        src = r["reduce_scatter"] if coll == "all_gather" else x
        ms = time_ms(torch, lambda: getattr(comm, coll)(src), 5)
        moved = (src.numel() + r[coll].numel()) * src.element_size()
        log(f"  warm {coll} [bfloat16] {tuple(src.shape)}: {ms:.3f} ms "
            f"(bytes bound {moved / PEAK_BYTES_PER_S * 1e3:.3f} ms)")
    xm, w, _ = r["mm_rs_bfloat16"]

    def fused_mm():
        return fusion.fused_matmul_reduce_scatter(r["comm_ring"], xm, w, block_m=BLOCKS[0],
                                                  block_n=BLOCKS[1], block_k=BLOCKS[2])

    def unfused_mm():
        return fusion._unfused_matmul_reduce_scatter(r["comm_ring"], xm, w, blocks=BLOCKS)

    def fused_ar():
        return fusion.fused_all_reduce_rmsnorm(comm, x, r["gamma"], eps=EPS)

    def unfused_ar():
        return rmsnorm(comm.all_reduce(x), r["gamma"], eps=EPS)

    for seam, fused, unfused, reps in (("matmul→reduce-scatter", fused_mm, unfused_mm, 2),
                                       ("all-reduce→RMSNorm", fused_ar, unfused_ar, 5)):
        u1, f1, f2, u2 = (time_ms(torch, fn, reps) for fn in (unfused, fused, fused, unfused))
        log(f"  warm {seam} [bfloat16]: fused {f1:.3f} / {f2:.3f} ms, "
            f"unfused {u1:.3f} / {u2:.3f} ms")


# ---------------------------------------------------------------------- main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke runs only on a GPU",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: the repro_torch package is not under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()

    smi = nvidia_smi()
    log(smi)
    import triton

    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, triton {triton.__version__}, "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build
    from repro_torch.kernels.matmul import kernel as k1
    from repro_torch.kernels.matmul import matmul_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_triton

    t = time.perf_counter()
    build.load(k1.SOURCE)
    log(f"build: nvcc {k1.SOURCE.name} for sm_90a: {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    probe = torch.ones(2, 8, device="cuda")
    rmsnorm_triton(probe, torch.ones(8, device="cuda"))
    torch.cuda.synchronize()
    log(f"build: Triton rmsnorm compile + first launch: {time.perf_counter() - t:.2f} s")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    log("== kernel phase: kernels against their plain versions, main-path shapes")
    t = time.perf_counter()
    kernels = {name: kernel_phase(torch, gen, name) for name in ("bfloat16", "float32")}
    torch.cuda.empty_cache()
    log(f"  phase kernels: {time.perf_counter() - t:.3f} s")

    log(f"== main path: Mistral-Large-123B widths, TP={TP} rank-stacked, {TOKENS} tokens/rank")
    matmul_cuda.launches = 0
    rmsnorm_triton.launches = 0
    t = time.perf_counter()
    results = main_path(torch, gen, torch.device("cuda"))
    launches = {"matmul": matmul_cuda.launches, "rmsnorm": rmsnorm_triton.launches}
    log(f"  phase main path: {time.perf_counter() - t:.3f} s; kernel launches {launches}")
    check(launches["matmul"] > 0, "the main path never launched K1")
    check(launches["rmsnorm"] > 0, "the main path never launched K2")
    log(f"  peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    log("== checks of the main path's results")
    t = time.perf_counter()
    check_main_path(torch, results)
    log(f"  phase checks: {time.perf_counter() - t:.3f} s")
    log("== warm timings of the main path")
    t = time.perf_counter()
    warm_timings(torch, results)
    del results
    log(f"  phase warm timings: {time.perf_counter() - t:.3f} s")
    log(f"total: {time.perf_counter() - t_start:.1f} s")

    sources = {
        "matmul": ("cuda", "src/repro_torch/kernels/matmul/csrc/matmul.cu",
                   "src/repro/kernels/matmul/kernel.py:52"),
        "rmsnorm": ("triton", "src/repro_torch/kernels/rmsnorm/kernel.py",
                    "src/repro/kernels/rmsnorm/kernel.py:37"),
    }
    for name in sources:
        log(f"  {name}[float32]: " + json.dumps(kernels["float32"][name]))
    record = {"kernels": []}
    for name, (route, source, replaces) in sources.items():
        k = kernels["bfloat16"][name]
        record["kernels"].append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"], "dtype": "bfloat16", "shape": k["shape"],
        })
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
