#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout (K1 and K3
two CUDA C++ routes each, K4 three: the tensor-core kernels ``*_sm90*.cu``
for bf16 and the CUDA-core kernels for fp32; one ``nvcc`` per source, all
seven started together; K2, the Triton RMSNorm, at first launch), shows what
``ptxas`` allotted the tensor-core kernels (registers, shared memory, no
spills) and that their SASS holds ``HGMMA``, holds each kernel against its
plain PyTorch version at the shapes its path gives it, checks which route
each K1, K3 and K4 call took (and K4's time in each of its three passes),
and then drives the port's main paths:

1. collectives at the tensor-parallel widths of Mistral-Large-123B
   (``d_model`` 12288, ``d_ff`` 28672, TP = 8 ranks stacked on one card,
   4096 tokens per rank):

       PcclSession(H100_DGX) → communicator("x", 8) → planned all_reduce,
       reduce_scatter, all_gather and all_to_all, ring_ef8 all_reduce,
       fused matmul → reduce-scatter (K1), fused all-reduce → RMSNorm (K2);

2. serving Zamba2-2.7B at its published widths and depth (54 Mamba-2
   layers, 9 shared-attention calls, random weights from seed 0):
   ``ServeEngine.generate`` on 4 requests of 4096, 3072, 2048 and 1024
   prompt tokens, 16 new tokens each, whose prefill runs flash attention
   (K3) and the SSD scan (K4).

3. serving OLMoE-1B-7B at its published widths and depth (16 MoE layers,
   64 experts top-8, random weights from seed 0), the same requests,
   whose prefill runs K3 at head dim 128 (16 launches);

4. serving DeepSeek-V2-Lite at its published widths with depth cut to 4
   layers (MLA, 2 shared + 64 routed experts top-6), the same requests;
   MLA and MoE run plain PyTorch, as in the reference: no kernel.

5. serving xLSTM-1.3B at its published widths and depth (48 blocks: 6
   groups of 7 mLSTMs and one sLSTM, random weights from seed 0), the same
   requests, whose prefill runs K4 on its tiled tensor-core route in each
   mLSTM (P = 1024, N = 512: 42 launches) and the sLSTM as a loop over the
   steps, timed apart.

6. serving Whisper-small at its published widths and depth (12 encoder
   and 12 decoder layers, random weights from seed 0): one 30 s audio
   segment a request (1500 stub encoder frames) and decoder prompts of
   228, 132, 36 and 4 tokens, 16 new tokens each, whose prefill runs K3 in
   each decoder layer's causal self-attention (12 launches); the encoder's
   bidirectional attention and the cross-attention are plain, as in the
   reference, and the encoder's is timed apart.

7. training Zamba2-2.7B at its published widths and depth: AdamW
   (``OptimizerConfig()``), ``make_train_step`` with 2 microbatches of
   4096 tokens, remat ``full``; K3 and K4 run in the forward pass and its
   remat recompute (36 and 216 launches a step), their backward is their
   plain versions' autograd, timed apart by CUDA events and by the device
   time of the kernels it launched; the step-0 loss is held against the
   plain path's.  The kernel phase holds K3 and K4 at this path's shapes
   too, called as it calls them (through their autograd Function);

8. data-parallel training through PCCL: ``examples/pccl_dp_training_torch.py``'s
   model and defaults (a widened chatglm3-6b, 63 M parameters, batch 8 x
   128), 8 ranks stacked on the card, each parameter's gradients
   all-reduced on ``PcclSession(H100_DGX)``'s plan; every rank's row of the
   sum the same bits, the mean the full batch's gradient.

9. training Whisper-small at its published widths and depth through the
   fault-tolerant ``Trainer``: batches of 8 x 448 tokens (1500 encoder
   frames a row) in 2 microbatches, 10 steps, an async checkpoint every 3
   steps, a failure injected at step 8, the restart from the step-6
   checkpoint and the replay of steps 6 and 7 (48 K3 launches a step, on
   the tensor-core route), the final save; the last checkpoint restored
   into a fresh tree and served (8 new tokens for path 6's prompts), the
   same tokens as from the trained tree; an uninterrupted run to the same
   loss; and ``python -m repro_torch.launch.train`` on a reduced Whisper
   in a fresh process, on the card by default.  The kernel phase holds K3
   at this path's shape, ``(4, 448, 12, 12, 64)``, through its autograd
   Function too.

10. path 1 again with ``PCCL_VERIFY=1`` after ``clear_exec_caches()``:
   every schedule ``compile_schedule`` meets is verified
   (``repro_torch.analysis.verify``) before its tables are built, K1 and
   K2 launched again; path 1's calls in fp32 on fixed inputs, bit for bit
   as without the variable; a schedule with a transfer dropped refused
   with no cache grown.  Then the four collectives through the deprecated
   ``PcclComm`` shim, bit for bit as the communicator; a cold
   ``compile_schedule``'s host time with and without the hook for ring and
   RHD all-reduce and ring and DEX all-to-all at n = 8, 16, 64 and 128;
   and in fresh processes, on the card by default, ``python -m
   repro_torch.analysis`` (PASS), ``python -m
   repro_torch.analysis.lint_concurrency`` (0 findings), both examples
   (``quickstart_torch.py``, ``serve_decode_torch.py``) and ``python -m
   repro_torch.launch.serve --arch zamba2-2.7b --no-reduced`` (the
   published config, its tokens/s and peak memory).

11. path 2 again under a mesh: ``torch.distributed`` on NCCL with one
   rank, ``init_device_mesh("cuda", (1, 1))`` with ``("data", "model")``,
   ``ServeEngine.generate`` inside ``use_partitioning(mesh,
   default_rules())``: the tokens and every step's logits bit for bit as
   path 2's, K3 9 and K4 54 launches a prefill on the tensor-core route,
   and the shard sites a prefill reaches the count the CPU test takes.
   In fresh processes started before path 9 (host only, they count beside
   paths 9 and 10): the port's roofline of path 2's prefill
   and path 7's step on one rank, printed beside their measured times, and
   the count's memory of path 7's step beside its last step's: the bytes
   of its arguments, and its peak less what was allocated before it
   (11b); and ``python -m repro_torch.launch.dryrun`` for Zamba2-2.7B,
   OLMoE-1B-7B, DeepSeek-V2-Lite-16B and xLSTM-1.3B × train_4k and
   DeepSeek × prefill_32k on 256 ranks and Zamba2 on 512 (11c), after the
   torch release and the DTensor rules the port installed on it: each
   exits 0, allocates nothing on the card, has no op that fell back, and
   prints its bytes by collective, its memory per rank and PCCL's speedup,
   each beside the torch 2.13 record counted on the CPU
   (``PATH11_TORCH213``: FLOPs a rank, every collective's bytes, the
   temporaries and the speedup), all held within 5 % but those
   ``PERF.md`` §6 lists as not met (printed).  11d: ``python -m repro_torch.launch.dryrun
   --reduced`` in a fresh process beside them, every architecture's
   reduced config × train, prefill and decode on a 2 × 2 mesh: each cell
   counted with no op falling back.

12. one process per rank: four processes on this card joined over gloo
   on a ``FileStore`` (``repro_torch.launch.procs.spawn``).  12a: path 1's
   four collectives at its per-rank shapes in fp32, at the algorithms the
   planner picks there, the all-reduce it gives ``ring_ef8`` under its
   error bound, fused mm+RS (bf16 and fp32) and fused AR+RMSNorm, each
   through ``session.communicator(group)`` with every round one
   ``dist.batch_isend_irecv`` and CUDA payloads staged through pinned host
   memory: each rank's result bit for bit its row of the rank-stacked
   engine run here (SHA-256 of the bytes), the seams equal to their
   unfused compositions, every round on the ``gloo-staged`` route, K1 and
   K2 counted in each process; ms per call and bytes staged printed.  Two
   NCCL ranks on this card are refused ("Duplicate GPU detected"), which
   is why the path runs on gloo.  12b: Whisper-small at published widths
   and depth through the ``Trainer`` on a ``("data", "model") = (2, 2)``
   mesh, DTensor parameters and moments, 4 × 448 tokens a step, a
   checkpoint at step 2, a failure injected at step 2 and the restart
   from it; losses within 1e-4 (relative) of the one-process ``Trainer``
   on the same batches, K3 counted in each process; ms a step and peak
   memory printed.  12c: data slice 1 fails, ``shrink_mesh`` gives ``(1,
   2)``, ``reshard_tree`` keeps every value bit for bit and the survivors
   take one more step.  12d: Whisper-small, 12b's weights, fp32 activations,
   serving on the (2, 2) mesh of four processes through the model's own
   ``prefill`` and ``decode_step`` (``procs.serve_program``: 4 prompts of 228 tokens, 1500
   random encoder frames, 4 greedy steps; the self-attention cache split
   along its length over "model", written and attended on each rank's
   part): the greedy tokens of one process on the card, every step's
   logits within 2e-2 (absolute and relative, as the continuation gates).

13. the kernel lint on the card (run right after the kernel phase, held
   to 60 s): ``repro_torch.analysis.kernel_lint.run_shipped`` over every
   route at edge shapes and at the main paths' shapes, all clean (13a);
   every modelled launch's grid, threads and dynamic shared memory equal
   to what its library's ``*_geometry`` export (the launcher's own
   function) reports, static plus dynamic shared memory within the card's
   opt-in limit (13b); every route at ragged shapes launched into outputs
   pre-filled with NaN between sentinel guard bands: every element written,
   no guard touched (13c); each kernel at its main-path shapes with and
   without ``PCCL_VERIFY=1``: the same bytes, the gate's miss and hit timed
   on the host (13d).  Path 10 also reports the gate's misses and hits for
   K1 and K2: every launch of path 1 under the variable passed it.

A parity phase then holds Zamba2's prefill with the kernels against its
plain path in fp32 (6 layers, batch 2, 512 tokens), and teacher-forced
decode against a longer prefill, xLSTM's the same way (one group: 7
mLSTMs and one sLSTM) and Whisper's at full depth (random encoder frames,
a 228-token prompt); a second holds OLMoE's (2 layers), counting
routing flips, and DeepSeek's absorbed MLA decode against its expanded
prefill; a third holds training, the loss and every parameter's gradient
of Zamba2 and xLSTM (one group each, fp32) with the kernels against the
plain path.  Every check that fails raises, so the
script exits non-zero and prints no result line.  It exits non-zero at once when CUDA is not available or the
``repro_torch`` package is not beside it.  The last line is the device
summary ``{"ok": true, "device": {...}}``; the line before it is the
kernels' JSON record, and the line before that the card's name and power
limit from ``nvidia-smi``.
"""

from __future__ import annotations

import gc
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
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

# Serving Zamba2-2.7B, OLMoE-1B-7B and DeepSeek-V2-Lite
# (src/repro_torch/configs/): batch 4, ragged prompts up to 4096 tokens,
# 16 new tokens each
SERVE_PROMPTS = (4096, 3072, 2048, 1024)
SERVE_NEW_TOKENS = 16
SERVE_TP = 8
DEEPSEEK_LAYERS = 4    # the dense front layer and 3 MoE layers: 2.255 B parameters
# Serving Whisper-small: one 30 s segment a request (enc_seq 1500 frames);
# decoder prompts of 228 tokens, the longest whisper/decoding.py builds
# (<|startofprev|>, n_text_ctx // 2 - 1 = 223 previous-text tokens and the 4
# start-of-transcript tokens), 132, 36 and 4 (the start-of-transcript
# sequence alone); Whisper's text context is 448 tokens
WHISPER_PROMPTS = (228, 132, 36, 4)
# K3 at Zamba2's, OLMoE's and Whisper's decoder serving prefill (B, S, H, K,
# D); the GQA and ragged cases; Zamba2's train microbatch (path 7)
FLASH_SHAPES = {"serving": (4, 4096, 32, 32, 80), "olmoe": (4, 4096, 16, 16, 128),
                "whisper": (4, 228, 12, 12, 64),
                "gqa": (2, 256, 8, 2, 64), "ragged": (1, 200, 32, 32, 80),
                "train": (1, 4096, 32, 32, 80), "whisper_train": (4, 448, 12, 12, 64)}
# the timed cases, and the launches each timing averages over: one call at
# Whisper's shapes is a few microseconds, near the cost of its timing events
FLASH_TIMED = {"serving": 1, "olmoe": 1, "whisper": 50, "whisper_train": 50}
# K4 (B, S, H, P, N, chunk) at Zamba2's serving prefill (shared B/C), the
# per-head and ragged cases, at xLSTM-1.3B's mLSTM prefill (per-head B/C:
# k and q) and at Zamba2's train microbatch (path 7: shared B/C, no initial
# state); timed at the two prefills
SSD_SHAPES = {"serving": (4, 4096, 80, 64, 64, 64), "per_head": (2, 512, 8, 64, 64, 64),
              "ragged": (2, 1000, 80, 64, 64, 64), "mlstm": (4, 4096, 4, 1024, 512, 64),
              "train": (1, 4096, 80, 64, 64, 64)}
SSD_PER_HEAD = ("per_head", "mlstm")
# the cases called as paths 7 and 9 call K3 and K4 (Zamba2's and Whisper's
# decoder train microbatch): through the entry point on inputs that require
# a gradient, so through the autograd Function, whose backward is then held
# bit for bit against the plain version's autograd
TRAIN_CASES = ("train", "whisper_train")
SSD_TIMED = {"serving": "ssd", "mlstm": "ssd_mlstm"}
# parity: Zamba2 at full widths in fp32, cut to one shared-attention group;
# xLSTM-1.3B cut to one group (7 mLSTMs, one sLSTM); OLMoE and
# DeepSeek-V2-Lite at full widths in fp32, cut to 2 layers
PARITY_LAYERS, PARITY_BATCH, PARITY_PROMPT = 6, 2, 512
# the shard sites a served Zamba2 prefill reaches at the published depth
# (tests/test_torch_sharding.py counts them on the CPU)
ZAMBA2_SHARD_SITES_PER_PREFILL = 155
XLSTM_PARITY_LAYERS = 8
DECODER_PARITY_LAYERS = 2
PARITY_TOL = 1e-3      # same algorithms, fp32 sums in other orders
CONTINUATION_TOL = 2e-2  # tests/test_models_smoke.py's decode-vs-prefill tolerance
# Training Zamba2-2.7B (path 7): global batch 2 x 4096 in 2 microbatches;
# step 0 cold, steps 1-3 timed; the step-0 loss against the plain path's
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICROBATCHES, TRAIN_STEPS = 2, 4096, 2, 4
# relative: bf16 kernels against bf16 plain versions; 44 times the 2.26e-5
# the card showed (H100 80GB HBM3, 700 W)
TRAIN_LOSS_TOL = 1e-3
# training parity (fp32, one group): loss and grad norm, and each leaf's
# max-abs gradient difference against that leaf's max-abs gradient
TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ = 2, 512
TRAIN_PARITY_LOSS_TOL, TRAIN_PARITY_GRAD_TOL = 1e-4, 1e-3
# data-parallel training (path 8): the example's defaults, 5 steps
DP_STEPS = 5
DP_LOSS_TOL, DP_GRAD_TOL = 1e-5, 1e-4
# Training Whisper-small through the Trainer (path 9): global batch 8 x 448
# (Whisper's text context) in 2 microbatches, 10 steps, a checkpoint every 3
# (keeping 2), a failure injected at step 8; then serving 8 new tokens for
# path 6's prompts from the last checkpoint.  Replayed steps against their
# first pass, and the final loss against an uninterrupted run's
# (tests/test_train_substrate.py's restart tolerance), relative
TRAINER_BATCH, TRAINER_SEQ, TRAINER_MICROBATCHES, TRAINER_STEPS = 8, 448, 2, 10
TRAINER_CKPT_EVERY, TRAINER_CKPT_KEEP, TRAINER_FAIL_AT = 3, 2, 8
TRAINER_SERVE_NEW_TOKENS = 8
REPLAY_TOL, UNINTERRUPTED_TOL = 1e-6, 1e-5
# Path 10c: cold compile_schedule with and without PCCL_VERIFY=1, the
# median of 3, for ring and RHD all-reduce, ring and DEX all-to-all
VERIFY_COST_CASES = (("all_reduce", "ring"), ("all_reduce", "rhd"), ("all_to_all", "ring"),
                     ("all_to_all", "dex"))
VERIFY_COST_NS = (8, 16, 64, 128)
VERIFY_COST_REPS = 3
# the reduced run of the training CLI in a fresh process (no --device)
CLI_ARGS = ("--arch", "whisper-small", "--reduced", "--steps", "6", "--batch", "4", "--seq", "64",
            "--ckpt-every", "2", "--fail-at", "3")

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
    # K3/K4 fp32: sums over up to T = 4096 products (K3) and 64-step chunk
    # products with exp decays (K4) in another order than the plain version
    ("flash", "bfloat16"): (2e-2, 2e-2),
    ("flash", "float32"): (1e-4, 1e-4),
    ("ssd", "bfloat16"): (2e-2, 2e-2),
    ("ssd", "float32"): (1e-4, 1e-4),
}


class SmokeFailure(RuntimeError):
    pass


class _Launches:
    """The kernels' launch counts, ``repro_torch.kernels.build.LAUNCHES``,
    looked up at each use: the package is importable only once ``main``
    has put it on the path."""

    def __getattr__(self, name):
        from repro_torch.kernels.build import LAUNCHES as counts

        return getattr(counts, name)


LAUNCHES = _Launches()


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


def time_ms(torch, fn, reps: int, inner: int = 1) -> float:
    """Median device time of one call, by CUDA events around ``inner``
    calls in a row, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
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


def expected_route(dtype_name: str, widths=(64, 64, 64)) -> str:
    """K1's, K3's and K4's route at the main-path shapes: the tensor cores
    for bf16 (K, N and D are multiples of 16), K4 on ``wgmma`` where its
    (P, N, chunk) = ``widths`` are all 64 and on ``wgmma_tiled`` where the
    chunk is 64 and P and N other multiples of 64 (the mLSTM's P = 1024, N
    = 512); the CUDA cores for fp32 and for K4's other widths."""
    P, N, chunk = widths
    if dtype_name != "bfloat16" or chunk != 64 or P % 64 or N % 64:
        return "fma"
    return "wgmma" if P == N == 64 else "wgmma_tiled"


def ssd_widths(cfg) -> tuple:
    """(P, N, chunk) of the K4 scans of ``cfg``'s model: Mamba-2's heads, or
    the mLSTM's (d_model · proj_factor / H, d_model / H)."""
    if cfg.family == "ssm":
        H = cfg.n_heads
        return int(cfg.xlstm.proj_factor * cfg.d_model) // H, cfg.d_model // H, cfg.xlstm.chunk
    if cfg.ssm is not None:
        return cfg.ssm.head_dim, cfg.ssm.d_state, cfg.ssm.chunk
    return (64, 64, 64)


def ptxas_summary(source) -> list:
    """Registers, shared memory and spills ``ptxas -v`` reported for each
    tensor-core kernel (``*sm90*_kernel*``) of ``source``'s build."""
    from repro_torch.kernels import build

    rows, name, props = [], None, {}
    for line in build.ptxas_report(source).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            props = next((r for r in rows if r["entry"] == name), None)
            if props is None:
                props = {"entry": name}
                rows.append(props)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            props["spill_stores"], props["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            props["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            props["static_smem"] = int(sm.group(1)) if sm else 0
    return [r for r in rows if re.search(r"sm90\w*_kernel", r["entry"])]


def sass_count(source, opcode: str) -> int:
    """How many ``opcode`` instructions the built library's SASS holds."""
    from repro_torch.kernels import build

    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    proc = subprocess.run([str(cuobjdump), "-sass", str(build.library_path(source))],
                          capture_output=True, text=True, timeout=120)
    check(proc.returncode == 0, f"cuobjdump failed on {source.name}: {proc.stderr.strip()}")
    return len(re.findall(rf"\b{opcode}\b", proc.stdout))


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
    route = expected_route(dtype_name)
    before = LAUNCHES.by_route("matmul")
    got = matmul_cuda(x, w)
    check(LAUNCHES.by_route("matmul")[route] == before[route] + 1,
          f"matmul[{dtype_name}] did not take the {route} route")
    log(f"  matmul[{dtype_name}] took the {route} route")
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
                         bound_by=b_by, library_ms=lib_ms, shape=[M, K, N], kernel_route=route)
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


def train_gradient_check(torch, fn, kernel, plain, inputs, kw, what: str) -> None:
    """``plain``'s autograd gradient of ``fn``'s first output, as the
    Function gives it (its backward launches no ``kernel``, a name of
    ``LAUNCHES``), equals direct
    autograd of ``plain`` on the same inputs, bit for bit."""
    out = fn(*inputs, **kw)
    out = out[0] if isinstance(out, tuple) else out
    check(out.grad_fn is not None, f"{what}: the entry point recorded no gradient")
    dy = torch.randn_like(out)
    wrt = [t for t in inputs if t.requires_grad]
    before = LAUNCHES.total(kernel)
    got = torch.autograd.grad(out, wrt, dy)
    check(LAUNCHES.total(kernel) == before, f"{what}: the Function's backward launched the kernel")
    del out
    ref = plain(*inputs, **kw)
    ref = ref[0] if isinstance(ref, tuple) else ref
    want = torch.autograd.grad(ref, wrt, dy)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"{what}: the gradient through the Function differs from the plain version's autograd")
    log(f"  {what}: gradient through the Function == the plain version's autograd, bit for bit "
        f"({len(wrt)} inputs), no launch in the backward")


def flash_kernel_phase(torch, gen, dtype_name: str) -> dict:
    """K3 against its plain version at the three serving shapes (Zamba2's,
    OLMoE's, Whisper's decoder), GQA and ragged shapes, and at path 7's and
    path 9's train shapes through ``flash_attention`` with a gradient (its
    autograd Function, forward and backward); timed at the serving shapes
    and Whisper's train shape beside SDPA (``flash`` for Zamba2's,
    ``flash_<case>`` for the others)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash import attention_reference, flash_attention, flash_attention_cuda

    dt = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    out = {}
    for case, (B, S, H, K, D) in FLASH_SHAPES.items():
        train = case in TRAIN_CASES
        q, k, v = (torch.randn(B, S, h, D, generator=gen, device=dev).to(dt).requires_grad_(train)
                   for h in (H, K, K))
        for causal in ((True,) if case != "ragged" else (True, False)):
            route = expected_route(dtype_name)
            before = LAUNCHES.by_route("flash")
            entry = flash_attention if train else flash_attention_cuda
            got = entry(q, k, v, causal=causal)
            check(LAUNCHES.by_route("flash")[route] == before[route] + 1,
                  f"flash[{dtype_name}] {case} did not take the {route} route")
            check(train == (got.grad_fn is not None),
                  f"flash[{dtype_name}] {case}: autograd Function used {got.grad_fn is not None}")
            with torch.no_grad():
                # the plain version one batch row at a time: its fp32 (S, T)
                # scores for the whole serving batch would take ~9 GB each
                want = torch.cat([attention_reference(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                                      causal=causal) for b in range(B)])
                log(f"  flash {case} {(B, S, H, K, D)} causal={causal}, {route} route"
                    + (", through the autograd Function:" if train else ":"))
                err = compare(torch, got, want, "flash", dtype_name)
            del got, want
        key = "flash" if case == "serving" else f"flash_{case}"
        if train:
            train_gradient_check(torch, flash_attention, "flash", attention_reference,
                                 (q, k, v), {"causal": True}, f"flash[{dtype_name}] {case}")
            out[key] = dict(max_abs_err=err, shape=[B, S, H, K, D], kernel_route=route,
                            grad_bit_equal=True)
        if case not in FLASH_TIMED:
            del q, k, v
            continue
        inner = FLASH_TIMED[case]
        with torch.no_grad():  # the forward alone, no graph recorded around the library call
            ms = time_ms(torch, lambda: flash_attention_cuda(q, k, v, causal=True), 3, inner)
            plain_ms = time_ms(torch, lambda: [attention_reference(q[b:b + 1], k[b:b + 1],
                                                                   v[b:b + 1])
                                               for b in range(B)], 2, inner)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                           is_causal=True),
                             5, inner)
            del qt, kt, vt
        flops = 2.0 * B * H * S * S * D  # causal: half of QKᵀ and PV, 2 ops per MAC
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        b_ms, b_by = bound(flops, nbytes, dtype_name)
        out[key] = dict(out.get(key, {}), max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, shape=[B, S, H, K, D],
                        kernel_route=route, launches_timed=inner)
        log(f"  flash[{dtype_name}] {(B, S, H, K, D)} causal: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms (per batch row), SDPA {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), {flops / ms / 1e9:.1f} TFLOP/s; mean of {inner} launches in a row")
        del q, k, v
    return out


def _device_us(event) -> float:
    us = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if us is None else us


K4_PASSES = ("states", "recurrence", "outputs")


def _k4_pass(kernel_name: str):
    """Which of K4's three passes a kernel of either route is, or None."""
    return next((p for p in K4_PASSES if f"ssd_{p}" in kernel_name), None)


def ssd_pass_times(torch, fn, reps: int = 3) -> dict:
    """Device ms of each of K4's passes per call of ``fn``, from the
    profiler's device-side events (warm)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = _k4_pass(e.key)
        if e.device_type == torch.autograd.DeviceType.CUDA and name:
            out[name] = out.get(name, 0.0) + _device_us(e) / 1e3 / reps
    return out


def ssd_pass_bytes(X, la, Bm, chunk: int, route: str) -> dict:
    """Bytes each of K4's passes must move at these operands (each read
    once, each write once): states reads X, B, la and writes the fp32 chunk
    states and totals; recurrence reads those and the fp32 initial state and
    writes the states before each chunk (bf16 on the wgmma route, a bf16 hi
    + lo pair on wgmma_tiled, fp32 on fma) and the final state; outputs
    reads X, B, C, la and the states before each chunk, and writes Y.  On
    the fma route the masked C Bᵀ scores move from outputs to states:
    states also reads C and writes the fp32 (B, H, nc, L, L) scores, which
    outputs reads in place of B."""
    B, S, H, P = X.shape
    N, e = Bm.shape[-1], X.element_size()
    nc = -(-S // chunk)
    x, bc, lab = X.numel() * e, Bm.numel() * e, la.numel() * 4
    chunk_states, totals = B * H * nc * P * N * 4, B * H * nc * 4
    before = B * H * nc * P * N * (2 if route == "wgmma" else 4)  # fp32, or bf16 hi + lo
    scores = B * H * nc * chunk * chunk * 4 if route == "fma" else 0
    return {"states": x + bc * (2 if scores else 1) + lab + chunk_states + totals + scores,
            "recurrence": chunk_states + totals + B * H * P * N * (4 + e) + before,
            "outputs": x + bc * (1 if scores else 2) + lab + before + scores + x}


def ssd_kernel_phase(torch, gen, dtype_name: str) -> dict:
    """K4 against its plain version with a non-zero initial state at the
    serving shape (shared B/C), per-head B/C, a ragged S and the mLSTM's
    widths, and at path 7's train shape with no initial state through
    ``ssd`` with a gradient (its autograd Function, forward and backward);
    timed at Zamba2's and the mLSTM's prefill, each pass too."""
    from repro_torch.kernels.ssd import ssd, ssd_cuda, ssd_reference

    dt = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    out = {}
    for case, (B, S, H, P, N, L) in SSD_SHAPES.items():
        train = case in TRAIN_CASES
        bc = (B, S, H, N) if case in SSD_PER_HEAD else (B, S, N)
        X = torch.randn(B, S, H, P, generator=gen, device=dev).to(dt)
        la = -torch.rand(B, S, H, generator=gen, device=dev) * 0.3
        Bm = (torch.randn(*bc, generator=gen, device=dev) * 0.3).to(dt)
        Cm = (torch.randn(*bc, generator=gen, device=dev) * 0.3).to(dt)
        init = None if train else torch.randn(B, H, P, N, generator=gen, device=dev) * 0.1
        for t in (X, la, Bm, Cm):
            t.requires_grad_(train)
        route = expected_route(dtype_name, (P, N, L))
        before = LAUNCHES.by_route("ssd")
        entry = ssd if train else ssd_cuda
        Y, fin = entry(X, la, Bm, Cm, chunk=L, initial_state=init)
        check(LAUNCHES.by_route("ssd")[route] == before[route] + 1,
              f"ssd[{dtype_name}] {case} did not take the {route} route")
        check(train == (Y.grad_fn is not None),
              f"ssd[{dtype_name}] {case}: autograd Function used {Y.grad_fn is not None}")
        with torch.no_grad():
            Yr, finr = ssd_reference(X, la, Bm, Cm, chunk=L, initial_state=init)
            log(f"  ssd {case} X {(B, S, H, P)} B/C {bc} chunk {L}, "
                + ("no initial state, through the autograd Function" if train else "initial state")
                + f", {route} route:")
            err = compare(torch, Y, Yr, "ssd", dtype_name)
            err = max(err, compare(torch, fin, finr, "ssd", dtype_name))
        check(fin.dtype == dt, f"ssd[{dtype_name}] final state in {fin.dtype}, not X's dtype")
        del Y, Yr, fin, finr
        if train:
            train_gradient_check(torch, ssd, "ssd", ssd_reference, (X, la, Bm, Cm),
                                 {"chunk": L, "initial_state": None}, f"ssd[{dtype_name}] {case}")
            out[f"ssd_{case}"] = dict(max_abs_err=err, shape=[B, S, H, P, N, L], kernel_route=route,
                                      grad_bit_equal=True)
        if case not in SSD_TIMED:
            del X, la, Bm, Cm, init
            continue
        ms = time_ms(torch, lambda: ssd_cuda(X, la, Bm, Cm, chunk=L, initial_state=init), 5)
        passes = ssd_pass_times(torch, lambda: ssd_cuda(X, la, Bm, Cm, chunk=L, initial_state=init))
        plain_ms = time_ms(torch, lambda: ssd_reference(X, la, Bm, Cm, chunk=L,
                                                        initial_state=init), 2)
        nc = -(-S // L)
        # per (b, h, chunk): C Bᵀ (L·L·N), W X (L·L·P), C Rᵀ and the state update (L·P·N each)
        flops = 2.0 * B * H * nc * (L * L * N + L * L * P + 2 * L * P * N)
        nbytes = (2 * X.numel() + Bm.numel() + Cm.numel() + B * H * P * N) * X.element_size() \
            + (la.numel() + init.numel()) * 4
        b_ms, b_by = bound(flops, nbytes, dtype_name)
        pass_bytes = ssd_pass_bytes(X, la, Bm, L, route)
        # what the route itself cannot beat: its fp32 FMAs at the CUDA
        # cores' peak, and the bytes of its passes (the fp32 scratch)
        fma_ms = flops / PEAK_FLOPS["float32"] * 1e3
        scratch_ms = sum(pass_bytes.values()) / PEAK_BYTES_PER_S * 1e3
        out[SSD_TIMED[case]] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None, shape=[B, S, H, P, N, L], kernel_route=route, pass_ms=passes,
            pass_bytes=pass_bytes, flops=flops, fp32_fma_bound_ms=fma_ms,
            pass_bytes_bound_ms=scratch_ms)
        log(f"  ssd[{dtype_name}] {case} X {(B, S, H, P)} N {N} chunk {L}, {route} route: kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}; "
            f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e9:.3f} GB), {flops / ms / 1e9:.1f} TFLOP/s; "
            f"at the fp32 FMA peak {fma_ms:.3f} ms, the passes' "
            f"{sum(pass_bytes.values()) / 1e9:.2f} GB at the memory rate {scratch_ms:.3f} ms")
        log(f"  ssd[{dtype_name}] device ms per pass ({route} route, torch.profiler): "
            + (", ".join(f"{k} {passes[k]:.3f} ms ({pass_bytes[k] / 1e6:.1f} MB, "
                         f"{pass_bytes[k] / passes[k] / 1e9:.2f} TB/s)"
                         for k in K4_PASSES if k in passes)
               or "not measured (the profiler saw no device time)"))
        del X, la, Bm, Cm, init
    return out


# --------------------------------------------------------- main path phase


def main_path(torch, gen, device) -> dict:
    """The port's main path, as a user calls it.  Returns what it produced,
    for the checks made after the counted window."""
    from repro_torch import PcclSession
    from repro_torch.comm import fusion
    from repro_torch.core import cost_model as cm

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
        k1_before = LAUNCHES.by_route("matmul")
        out = fusion.fused_matmul_reduce_scatter(
            comm_ring, xm, w, block_m=BLOCKS[0], block_n=BLOCKS[1], block_k=BLOCKS[2]
        )
        torch.cuda.synchronize(device)
        check(session.exec_stats().fused_dispatches == before + 1,
              f"fused mm+RS [{name}] did not take the fused path")
        route = expected_route(name)
        k1 = {r: LAUNCHES.by_route("matmul")[r] - k1_before[r] for r in k1_before}
        check(device.type != "cuda" or k1 == {**{r: 0 for r in k1}, route: TP},
              f"fused mm+RS [{name}] launched K1 {k1}, not {TP} on the {route} route")
        log(f"  fused mm+RS [{name}] K1 launches by route: {k1}")
        log(f"  phase fused matmul→reduce-scatter [{name}] x {tuple(xm.shape)} w {tuple(w.shape)}: "
            f"{time.perf_counter() - t:.3f} s")
        results[f"mm_rs_{name}"] = (xm, w, out)

    gamma = torch.randn(D_MODEL, generator=gen, device=device) + 1.0
    t = time.perf_counter()
    before = session.exec_stats().fused_dispatches
    k2_before = LAUNCHES.total("rmsnorm")
    results["ar_rms"] = fusion.fused_all_reduce_rmsnorm(comm, x, gamma, eps=EPS)
    torch.cuda.synchronize(device)
    check(session.exec_stats().fused_dispatches == before + 1,
          "fused AR+RMSNorm did not take the fused path")
    check(device.type != "cuda" or LAUNCHES.total("rmsnorm") > k2_before,
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


# ------------------------------------------------------- serve path phase


def model_config(arch: str, use_pallas: bool, **cut):
    from repro_torch.configs import get_config

    return replace(get_config(arch), use_pallas=use_pallas, **cut)


def prefill_launches(cfg) -> dict:
    """K3's and K4's launches per prefill of ``cfg``'s model with the
    kernels on: Zamba2 runs K3 once per shared-attention group and K4 in
    every Mamba-2 layer; xLSTM runs K4 in every mLSTM (its numerator scan:
    the denominator's runs the plain version, as in the reference) and no
    K3; Whisper runs K3 in every decoder layer's causal self-attention and
    none in its encoder or its cross-attention (plain, as in the reference);
    a decoder runs K3 in every GQA layer, and MLA runs none (its attention
    is plain einsums, as in the reference)."""
    if cfg.family == "hybrid":
        return {"flash": cfg.n_layers // cfg.hybrid.shared_attn_every, "ssd": cfg.n_layers}
    if cfg.family == "ssm":
        groups = cfg.n_layers // cfg.xlstm.slstm_every
        return {"flash": 0, "ssd": groups * (cfg.xlstm.slstm_every - 1)}
    if cfg.family == "audio":
        return {"flash": cfg.n_layers, "ssd": 0}
    return {"flash": 0 if cfg.mla else cfg.n_layers, "ssd": 0}


def serve_path(torch, cfg, device, prompts, new_tokens, seed=SEED, keep_logits=False) -> dict:
    """Serving, as a user calls it: a ServeEngine on the card with random
    weights, ``generate`` on ragged requests.  Returns what it produced,
    for the checks made after the counted window (with ``keep_logits``,
    a copy of every step's logits on the card)."""
    import numpy as np

    from repro_torch import PcclSession
    from repro_torch.core import cost_model as cm
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    from repro_torch.sharding import SITES

    t = time.perf_counter()
    engine = ServeEngine(cfg, EngineConfig(batch_size=len(prompts),
                                           max_len=max(prompts) + new_tokens, tp=SERVE_TP),
                         seed=seed, session=PcclSession(cm.H100_DGX, device=device),
                         device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log(f"  engine built, {sum(p.numel() for p in engine.params.parameters()) / 1e9:.3f} B "
        f"parameters: {time.perf_counter() - t:.3f} s")

    # watch the model's two entry points: the logits each returns, and the
    # kernel launches made before decode began
    seen = {"finite": [], "at_first_decode": None, "logits": []}
    prefill, decode_step = engine.model.prefill, engine.model.decode_step

    def watched_prefill(*args, **kwargs):
        logits, state = prefill(*args, **kwargs)
        seen["finite"].append(torch.isfinite(logits).all())
        seen["prefill_logits_shape"] = tuple(logits.shape)
        if keep_logits:
            seen["logits"].append(logits.clone())
        return logits, state

    def watched_decode(*args, **kwargs):
        if seen["at_first_decode"] is None:
            seen["at_first_decode"] = (LAUNCHES.total("flash"), LAUNCHES.total("ssd"))
            seen["sites_at_first_decode"] = SITES.total()
            seen["k3_routes_at_first_decode"] = LAUNCHES.by_route("flash")
            seen["k4_routes_at_first_decode"] = LAUNCHES.by_route("ssd")
        logits, state = decode_step(*args, **kwargs)
        seen["finite"].append(torch.isfinite(logits).all())
        if keep_logits:
            seen["logits"].append(logits.clone())
        return logits, state

    engine.model.prefill, engine.model.decode_step = watched_prefill, watched_decode
    SITES.reset()
    seen["k3_routes_before"] = LAUNCHES.by_route("flash")
    seen["k4_routes_before"] = LAUNCHES.by_route("ssd")
    rng = np.random.default_rng(seed)
    requests = [Request(prompt=rng.integers(0, cfg.vocab, size=n).astype(np.int32),
                        max_new_tokens=new_tokens) for n in prompts]
    t = time.perf_counter()
    engine.generate(requests)
    wall = time.perf_counter() - t
    engine.model.prefill, engine.model.decode_step = prefill, decode_step
    return dict(engine=engine, requests=requests, seen=seen, wall=wall,
                launches_end=(LAUNCHES.total("flash"), LAUNCHES.total("ssd")))


def check_serve(torch, r, cfg) -> dict:
    """What the serve path produced: kernel launches per phase, finite
    logits, tokens in range; the engine's timings and communication report."""
    engine, seen, requests = r["engine"], r["seen"], r["requests"]
    want_k3, want_k4 = prefill_launches(cfg).values()
    k3_prefill, k4_prefill = seen["at_first_decode"]
    k3_end, k4_end = r["launches_end"]
    log(f"  launches: prefill K3 {k3_prefill}, K4 {k4_prefill}; decode K3 {k3_end - k3_prefill}, "
        f"K4 {k4_end - k4_prefill}")
    check(k3_prefill == want_k3, f"prefill launched K3 {k3_prefill} times, not {want_k3}")
    check(k4_prefill == want_k4, f"prefill launched K4 {k4_prefill} times, not {want_k4}")
    check((k3_end, k4_end) == (k3_prefill, k4_prefill), "decode launched K3 or K4")
    for kname, want, route in (("k3", want_k3, expected_route(cfg.dtype)),
                               ("k4", want_k4, expected_route(cfg.dtype, ssd_widths(cfg)))):
        routes = {r: seen[f"{kname}_routes_at_first_decode"][r] - seen[f"{kname}_routes_before"][r]
                  for r in seen[f"{kname}_routes_before"]}
        log(f"  prefill {kname.upper()} launches by route: {routes}")
        check(routes == {**{r: 0 for r in routes}, route: want},
              f"prefill launched {kname.upper()} {routes}, not {want} on the {route} route")
    check(seen["prefill_logits_shape"] == (len(requests), 1, cfg.vocab),
          f"prefill logits shape {seen['prefill_logits_shape']}")
    check(all(bool(f.item()) for f in seen["finite"]), "serving produced non-finite logits")
    check(all(len(q.generated) == q.max_new_tokens for q in requests), "a request came up short")
    check(all(0 <= t < cfg.vocab for q in requests for t in q.generated),
          "a generated token is out of the vocabulary")
    tm = engine.timings
    n_new = sum(len(q.generated) for q in requests)
    prompt_tokens = sum(len(q.prompt) for q in requests)
    out = dict(prefill_ms=tm["prefill_s"] * 1e3,
               decode_ms_per_token=tm["decode_s"] * 1e3 / max(tm["decode_steps"], 1),
               tokens_per_s=n_new / (tm["prefill_s"] + tm["decode_s"]),
               decode_tokens_per_s=len(requests) * tm["decode_steps"] / max(tm["decode_s"], 1e-9),
               wall_s=r["wall"], prefill_launches={"flash": k3_prefill, "ssd": k4_prefill})
    rep = engine.comm_report()
    log(f"  {len(requests)} requests, prompts {[len(q.prompt) for q in requests]} "
        f"({prompt_tokens} tokens, left-padded to {max(len(q.prompt) for q in requests)}), "
        f"{n_new} new tokens: prefill {out['prefill_ms']:.1f} ms, decode "
        f"{out['decode_ms_per_token']:.2f} ms per step of {len(requests)} tokens "
        f"({out['decode_tokens_per_s']:.1f} tokens/s), {out['tokens_per_s']:.1f} new tokens/s "
        f"end to end, generate {r['wall']:.3f} s")
    log(f"  comm_report: TP={rep['tp']} all_reduce {rep['algorithm']}, planned "
        f"{rep['sim_comm_s'] * 1e3:.3f} ms over {rep['events']} collectives (H100_DGX fabric model)")
    log(f"  first tokens: {[q.generated[:4] for q in requests]}")
    return out


def _kernel_times(torch, prof):
    """Device time (ms) of a profiled window by kernel class, from the
    profiler's device-side events; the heaviest kernels of ``other``; and
    K4's time in each of its passes (both routes)."""
    cuda = torch.autograd.DeviceType.CUDA
    out = {"flash (K3)": 0.0, "ssd (K4)": 0.0, "matmul (cuBLAS)": 0.0, "other": 0.0}
    other, k4 = [], {}
    for e in prof.key_averages():
        # a span's device-side copy (a user annotation) is no kernel
        if e.device_type != cuda or getattr(e, "is_user_annotation", False) \
                or e.key in TRAIN_SPANS.values():
            continue
        us = _device_us(e)
        name = e.key.lower()
        k4_pass = _k4_pass(name)
        if "flash_fwd_kernel" in name or "flash_sm90_kernel" in name:
            key = "flash (K3)"
        elif k4_pass:
            key = "ssd (K4)"
            k4[k4_pass] = k4.get(k4_pass, 0.0) + us / 1e3
        elif any(w in name for w in ("gemm", "cutlass", "xmma", "cublas", "nvjet")):
            key = "matmul (cuBLAS)"
        else:
            key = "other"
            other.append((us / 1e3, e.count, e.key[:60]))
        out[key] += us / 1e3
    return out, sorted(other, reverse=True)[:4], k4


def served_batch(torch, engine, prompts) -> dict:
    """A prefill batch as ``generate`` builds it: random prompts left-padded
    to the longest, and the stub frontend's inputs."""
    import numpy as np

    S = max(prompts)
    toks = np.zeros((len(prompts), S), np.int64)
    rng = np.random.default_rng(SEED)
    for i, n in enumerate(prompts):
        toks[i, S - n:] = rng.integers(0, engine.cfg.vocab, size=n)
    return {"tokens": torch.from_numpy(toks).to(engine.device),
            **engine._extra_inputs(len(prompts))}


def profile_serve(torch, engine, prompts, wall_prefill_ms, wall_decode_ms, steps=2) -> dict:
    """Where a warm prefill and a warm decode step spend the card's time:
    device time by kernel class (``torch.profiler``), and the share of the
    unprofiled wall time the card was busy."""
    from torch.profiler import ProfilerActivity, profile

    batch = served_batch(torch, engine, prompts)
    # device-side events only on the card (the CPU rehearsal records host ops)
    acts = [ProfilerActivity.CUDA] if engine.device.type == "cuda" else [ProfilerActivity.CPU]
    out = {}
    with torch.inference_mode():
        with profile(activities=acts) as prof:
            logits, state = engine.model.prefill(engine.params, batch,
                                                 max_len=engine.ecfg.max_len)
            torch.cuda.synchronize()
        out["prefill"] = (*_kernel_times(torch, prof), wall_prefill_ms, 1)
        nxt = logits[:, -1].argmax(-1, keepdim=True)
        with profile(activities=acts) as prof:
            for _ in range(steps):
                logits, state = engine.model.decode_step(engine.params, state, nxt)
                nxt = logits[:, -1].argmax(-1, keepdim=True)
            torch.cuda.synchronize()
        out["decode step"] = (*_kernel_times(torch, prof), wall_decode_ms, steps)
    stats = {}
    for what, (times, other, k4, wall, n) in out.items():
        times = {k: v / n for k, v in times.items()}
        busy = sum(times.values())
        if busy == 0.0:
            log(f"  profile {what}: the profiler saw no device time")
            continue
        parts = ", ".join(f"{k} {v:.2f}" for k, v in times.items())
        log(f"  profile {what}: device busy {busy:.2f} ms of {wall:.2f} ms wall "
            f"({100 * busy / wall:.1f} % busy, {100 * (1 - busy / wall):.1f} % idle); {parts} ms")
        log(f"    heaviest of other (ms, launches, kernel): "
            + "; ".join(f"{ms / n:.2f}, {c // n}, {k}" for ms, c, k in other))
        if k4:
            log("    K4 by pass: " + ", ".join(f"{k} {k4[k] / n:.2f}" for k in K4_PASSES if k in k4)
                + " ms")
        stats[what] = dict(device_ms=busy, wall_ms=wall, **times,
                           k4_pass_ms={k: v / n for k, v in k4.items()})
    return stats


class SlstmTimer:
    """Host time of every ``apply_slstm`` call while installed, each call
    bracketed by a synchronize: the sLSTM loop is host-bound, so its wall
    time is its cost.  It wraps the port's ``ssm.apply_slstm``, which
    ``XLSTMLM`` looks up at each call."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        from repro_torch.models import ssm

        self.ssm, self.apply, self.ms = ssm, ssm.apply_slstm, []

        def timed(*args, **kwargs):
            self.torch.cuda.synchronize()
            t = time.perf_counter()
            out = self.apply(*args, **kwargs)
            self.torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t) * 1e3)
            return out

        ssm.apply_slstm = timed
        return self

    def __exit__(self, *exc):
        self.ssm.apply_slstm = self.apply


def slstm_share(torch, engine, prompts) -> dict:
    """One warm prefill of the served batch with the sLSTM layers timed
    apart: their share of the prefill's wall time."""
    S = max(prompts)
    batch = served_batch(torch, engine, prompts)
    with torch.inference_mode(), SlstmTimer(torch) as timer:
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.model.prefill(engine.params, batch, max_len=engine.ecfg.max_len)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t) * 1e3
    slstm = sum(timer.ms)
    steps = len(timer.ms) * S
    log(f"  sLSTM loop: {slstm:.1f} ms of a {total:.1f} ms prefill ({100 * slstm / total:.1f} %), "
        f"{len(timer.ms)} layers x {S} steps, {1e3 * slstm / steps:.1f} us a step; per layer "
        + ", ".join(f"{ms:.1f}" for ms in timer.ms) + " ms")
    return {"slstm_ms": slstm, "prefill_ms": total, "slstm_share": slstm / total,
            "slstm_us_per_step": 1e3 * slstm / steps, "slstm_layers": len(timer.ms)}


class EncoderAttentionTimer:
    """Device time of the plain attention (``attention._attend``: the score
    einsum, mask, fp32 softmax and the einsum with V) of every encoder layer
    while installed, by CUDA events around each call; a call counts when
    ``apply_gqa`` runs it in ``bidir`` mode.  It wraps the port's
    ``attention.apply_gqa`` and ``attention._attend``, which are looked up
    at each call."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        from repro_torch.models import attention

        self.attn, self.apply_gqa, self.attend = attention, attention.apply_gqa, attention._attend
        self.events, bidir = [], [False]

        def apply_gqa(*args, **kwargs):
            bidir[0] = kwargs.get("mode") == "bidir"
            try:
                return self.apply_gqa(*args, **kwargs)
            finally:
                bidir[0] = False

        def attend(*args, **kwargs):
            if not bidir[0]:
                return self.attend(*args, **kwargs)
            start, end = (self.torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = self.attend(*args, **kwargs)
            end.record()
            self.events.append((start, end))
            return out

        attention.apply_gqa, attention._attend = apply_gqa, attend
        return self

    def __exit__(self, *exc):
        self.attn.apply_gqa, self.attn._attend = self.apply_gqa, self.attend

    def ms(self) -> list:
        self.torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def encoder_attention_share(torch, engine, prompts) -> dict:
    """One warm prefill of the served batch with the encoder's plain
    attention timed apart: its device time and share of the prefill."""
    cfg = engine.cfg
    batch = served_batch(torch, engine, prompts)
    with torch.inference_mode(), EncoderAttentionTimer(torch) as timer:
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.model.prefill(engine.params, batch, max_len=engine.ecfg.max_len)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t) * 1e3
        ms = timer.ms()
    check(len(ms) == cfg.enc_dec.n_enc_layers,
          f"timed {len(ms)} encoder attentions, not {cfg.enc_dec.n_enc_layers}")
    enc_ms = sum(ms)
    B, T, H, Dh = len(prompts), cfg.enc_dec.enc_seq, cfg.n_heads, cfg.resolved_head_dim
    log(f"  encoder attention (plain, fp32 scores {(B, H, T, T)}, {len(ms)} layers): "
        f"{enc_ms:.2f} ms of a {total:.2f} ms prefill ({100 * enc_ms / total:.1f} %), "
        f"{enc_ms / len(ms):.3f} ms a layer; {4.0 * B * H * T * T * Dh * len(ms) / 1e9:.1f} GFLOP "
        f"and {B * H * T * T * 4 * len(ms) / 1e9:.2f} GB of fp32 scores")
    return {"encoder_attention_ms": enc_ms, "encoder_attention_prefill_ms": total,
            "encoder_attention_share": enc_ms / total}


def parity_phase(torch, device, arch="zamba2-2.7b", n_layers=PARITY_LAYERS, seed=SEED + 1) -> dict:
    """``arch`` at full widths in fp32, cut to ``n_layers`` (Zamba2: 6,
    one shared-attention group; xLSTM: 8, one group): prefill logits with
    K3/K4 against the plain path, and teacher-forced decode against a
    longer prefill."""
    from repro_torch.models import build_model

    gen = torch.Generator(device=device).manual_seed(seed)
    cut = dict(n_layers=n_layers, dtype="float32")
    kernels = build_model(model_config(arch, True, **cut))
    plain = build_model(model_config(arch, False, **cut))
    params = kernels.init(gen, device)
    cfg = kernels.cfg
    tokens = torch.randint(0, cfg.vocab, (PARITY_BATCH, PARITY_PROMPT), generator=gen,
                           device=device)
    out = {}
    k4_before = LAUNCHES.by_route("ssd")
    want_k4 = prefill_launches(cfg)["ssd"]
    with torch.inference_mode():
        got, _ = kernels.prefill(params, {"tokens": tokens})
        k4 = {r: LAUNCHES.by_route("ssd")[r] - k4_before[r] for r in k4_before}
        check(device.type != "cuda" or k4 == {**{r: 0 for r in k4}, "fma": want_k4},
              f"{arch} fp32 parity prefill launched K4 {k4}, not {want_k4} on the fma route")
        log(f"  {arch} fp32 parity prefill K4 launches by route: {k4}")
        want, _ = plain.prefill(params, {"tokens": tokens})
        err = (got - want).abs().max().item()
        ok = bool(torch.isclose(got, want, rtol=PARITY_TOL, atol=PARITY_TOL).all().item())
        log(f"  {arch} prefill logits, kernels vs plain path (fp32, {n_layers} layers, batch "
            f"{PARITY_BATCH} x {PARITY_PROMPT}): max_abs_err={err:.3e} "
            f"(tol rtol=atol={PARITY_TOL}, max |logit| {want.abs().max().item():.3f})")
        check(bool(torch.isfinite(got).all().item()) and ok,
              f"{arch} prefill with the kernels disagrees with the plain path")
        out["prefill_max_abs_err"] = err
        _, state = kernels.prefill(params, {"tokens": tokens[:, :-2]})
        for i in (PARITY_PROMPT - 2, PARITY_PROMPT - 1):
            step, state = kernels.decode_step(params, state, tokens[:, i:i + 1])
        err = (step[:, -1] - got[:, -1]).abs().max().item()
        ok = bool(torch.isclose(step[:, -1], got[:, -1], rtol=CONTINUATION_TOL,
                                atol=CONTINUATION_TOL).all().item())
        log(f"  {arch} decode after a {PARITY_PROMPT - 2}-token prefill vs the "
            f"{PARITY_PROMPT}-token prefill's last logits: max_abs_err={err:.3e} "
            f"(tol {CONTINUATION_TOL})")
        check(ok, f"{arch}: teacher-forced decode disagrees with the longer prefill")
        out["continuation_max_abs_err"] = err
    return out


class RouteRecorder:
    """The top-k expert ids (on the device) of every MoE routing call, in
    call order, while installed: it wraps the port's ``moe.route``, which
    ``apply_moe`` looks up at each call."""

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.route, self.calls = moe, moe.route, []

        def route(p, cfg, x):
            r = self.route(p, cfg, x)
            self.calls.append(r.experts)
            return r

        moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route


def routing_flips(a, b) -> int:
    """(row, token, layer) triples whose top-k expert sets differ between
    two lists of per-layer expert ids of the same shapes."""
    check(len(a) == len(b), f"routing calls differ in number: {len(a)} vs {len(b)}")
    return sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum().item())
               for x, y in zip(a, b))


def no_drop(cfg):
    """``cfg`` with capacity_factor E/K: C = S, so no copy is dropped.  Decode
    equals a longer prefill only then (src/repro/configs/base.py:146-147):
    at 1.25 a prefill drops the latest copies of every overflowing expert,
    and a decode step (C = 1 per expert, K distinct experts) drops none."""
    return replace(cfg, moe=replace(cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def continuation(torch, model, params, tokens, what: str, extra=None) -> dict:
    """Teacher-forced decode of the last two tokens after a shorter prefill
    against the full prefill's last logits, counting the routing flips
    between each decode step and the prefill at the same token.  ``extra``
    are the frontend's inputs, the same for both prefills."""
    S, L = tokens.shape[1], model.cfg.n_layers
    extra = extra or {}
    with RouteRecorder() as rec:
        want, _ = model.prefill(params, {"tokens": tokens, **extra})
        full = list(rec.calls)
        _, state = model.prefill(params, {"tokens": tokens[:, :-2], **extra})
        rec.calls.clear()
        for i in (S - 2, S - 1):
            step, state = model.decode_step(params, state, tokens[:, i:i + 1])
    moe_layers = len(full)
    decoded = rec.calls
    flips = routing_flips([f[:, S - 2 + j:S - 1 + j] for j in range(2) for f in full], decoded) \
        if moe_layers else 0
    err = (step[:, -1] - want[:, -1]).abs().max().item()
    ok = bool(torch.isclose(step[:, -1], want[:, -1], rtol=CONTINUATION_TOL,
                            atol=CONTINUATION_TOL).all().item())
    log(f"  {what}: decode after a {S - 2}-token prefill vs the {S}-token prefill's last "
        f"logits ({L} layers): max_abs_err={err:.3e} (tol {CONTINUATION_TOL}); routing flips "
        f"between decode and prefill: {flips} of {2 * tokens.shape[0] * moe_layers} "
        f"(row, token, layer) triples")
    check(ok, f"{what}: teacher-forced decode disagrees with the longer prefill"
          + (f" ({flips} routing flips)" if flips else " (a numeric difference, no routing flip)"))
    return {"continuation_max_abs_err": err, "continuation_routing_flips": flips}


def decoder_parity_phase(torch, device) -> dict:
    """OLMoE at full widths in fp32, 2 layers: prefill logits with K3 (the
    fma route) against the plain path at the config's capacity 1.25,
    counting routing flips; then, for OLMoE and for DeepSeek-V2-Lite (MLA's
    absorbed decode against its expanded prefill), teacher-forced decode
    against a longer prefill with no copy dropped."""
    from repro_torch.models import build_model

    out = {}
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    cut = dict(n_layers=DECODER_PARITY_LAYERS, dtype="float32")
    kernels = build_model(model_config("olmoe-1b-7b", True, **cut))
    plain = build_model(model_config("olmoe-1b-7b", False, **cut))
    cfg = kernels.cfg
    params = kernels.init(gen, device)
    tokens = torch.randint(0, cfg.vocab, (PARITY_BATCH, PARITY_PROMPT), generator=gen,
                           device=device)
    with torch.inference_mode():
        k3_before = LAUNCHES.by_route("flash")
        with RouteRecorder() as rec:
            got, _ = kernels.prefill(params, {"tokens": tokens})
            k3 = {r: LAUNCHES.by_route("flash")[r] - k3_before[r] for r in k3_before}
            with_k3 = list(rec.calls)
            rec.calls.clear()
            want, _ = plain.prefill(params, {"tokens": tokens})
        check(device.type != "cuda" or k3 == {"wgmma": 0, "fma": cfg.n_layers},
              f"OLMoE fp32 parity prefill launched K3 {k3}, not {cfg.n_layers} on the fma route")
        log(f"  OLMoE fp32 parity prefill K3 launches by route: {k3}")
        flips = routing_flips(with_k3, rec.calls)
        err = (got - want).abs().max().item()
        ok = bool(torch.isclose(got, want, rtol=PARITY_TOL, atol=PARITY_TOL).all().item())
        log(f"  OLMoE prefill logits, K3 vs plain path (fp32, {cfg.n_layers} layers, capacity "
            f"{cfg.moe.capacity_factor}, batch {PARITY_BATCH} x {PARITY_PROMPT}): "
            f"max_abs_err={err:.3e} (tol rtol=atol={PARITY_TOL}, max |logit| "
            f"{want.abs().max().item():.3f}); routing flips: {flips} of "
            f"{PARITY_BATCH * PARITY_PROMPT * len(with_k3)} (row, token, layer) triples")
        check(bool(torch.isfinite(got).all().item()) and ok,
              "OLMoE prefill with K3 disagrees with the plain path"
              + (f" ({flips} routing flips)" if flips else " (a numeric difference, no routing flip)"))
        out.update(olmoe_prefill_max_abs_err=err, olmoe_prefill_routing_flips=flips)
        log("  continuation checks run at capacity_factor E/K (C = S, no copy dropped): "
            "decode equals a longer prefill only without drops (src/repro/configs/base.py:146-147)")
        cont = continuation(torch, build_model(no_drop(cfg)), params, tokens,
                            "OLMoE, capacity E/K = 8.0")
        out.update({f"olmoe_{k}": v for k, v in cont.items()})
        del params, got, want
        ds = build_model(no_drop(model_config("deepseek-v2-lite-16b", True, **cut)))
        params = ds.init(gen, device)
        tokens = torch.randint(0, ds.cfg.vocab, tokens.shape, generator=gen, device=device)
        cont = continuation(torch, ds, params, tokens,
                            f"DeepSeek-V2-Lite MLA, capacity E/K = {ds.cfg.moe.capacity_factor:.3f}")
        out.update({f"deepseek_{k}": v for k, v in cont.items()})
    return out


def whisper_parity_phase(torch, device) -> dict:
    """Whisper-small at full widths and depth in fp32, random encoder
    frames, batch 2 with a 228-token prompt: prefill logits with K3 (the
    fma route, one per decoder layer) against the plain path, and
    teacher-forced decode against a longer prefill."""
    from repro_torch.models import build_model

    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    kernels = build_model(model_config("whisper-small", True, dtype="float32"))
    plain = build_model(model_config("whisper-small", False, dtype="float32"))
    cfg = kernels.cfg
    params = kernels.init(gen, device)
    S = max(WHISPER_PROMPTS)
    tokens = torch.randint(0, cfg.vocab, (PARITY_BATCH, S), generator=gen, device=device)
    frames = {"enc_frames": torch.randn(PARITY_BATCH, cfg.enc_dec.enc_seq, cfg.d_model,
                                        generator=gen, device=device)}
    out = {}
    with torch.inference_mode():
        k3_before = LAUNCHES.by_route("flash")
        got, _ = kernels.prefill(params, {"tokens": tokens, **frames})
        k3 = {r: LAUNCHES.by_route("flash")[r] - k3_before[r] for r in k3_before}
        check(device.type != "cuda" or k3 == {"wgmma": 0, "fma": cfg.n_layers},
              f"Whisper fp32 parity prefill launched K3 {k3}, not {cfg.n_layers} on the fma route")
        log(f"  Whisper fp32 parity prefill K3 launches by route: {k3}")
        want, _ = plain.prefill(params, {"tokens": tokens, **frames})
        err = (got - want).abs().max().item()
        ok = bool(torch.isclose(got, want, rtol=PARITY_TOL, atol=PARITY_TOL).all().item())
        log(f"  Whisper prefill logits, K3 vs plain path (fp32, {cfg.enc_dec.n_enc_layers} + "
            f"{cfg.n_layers} layers, batch {PARITY_BATCH} x {S}, {cfg.enc_dec.enc_seq} random "
            f"frames): max_abs_err={err:.3e} (tol rtol=atol={PARITY_TOL}, max |logit| "
            f"{want.abs().max().item():.3f})")
        check(bool(torch.isfinite(got).all().item()) and ok,
              "Whisper prefill with K3 disagrees with the plain path")
        out["prefill_max_abs_err"] = err
        out.update(continuation(torch, kernels, params, tokens, "Whisper-small", frames))
    return out


# ---------------------------------------------------------- training phases


def train_launches(cfg, microbatches: int) -> dict:
    """K3's and K4's launches per train step: a prefill's per microbatch,
    twice where remat wraps the layers (the backward pass recomputes each
    wrapped body's forward, which launches the kernels again; their
    Function's backward launches nothing)."""
    passes = 1 if cfg.remat == "none" else 2
    return {k: v * passes * microbatches for k, v in prefill_launches(cfg).items()}


# profiler spans (``record_function``) of the windows TrainTimer times
TRAIN_SPANS = {"flash": "smoke::plain_backward_k3", "ssd": "smoke::plain_backward_k4",
               "adamw": "smoke::adamw_update"}


class TrainTimer:
    """While installed: CUDA events around every backward of the kernels'
    autograd Function (the plain version's autograd), by kernel, and around
    every AdamW update of the train step, each window also a profiler span
    (:data:`TRAIN_SPANS`); and the calls of each plain version made outside
    that backward, which on a path with the kernels on must be none for K3
    and K4 (the forward pass, the remat recompute included, launches the
    kernels).  It wraps module attributes the port looks up at each call."""

    def __init__(self, torch):
        self.torch = torch

    def _events(self):
        return tuple(self.torch.cuda.Event(enable_timing=True) for _ in range(2))

    def __enter__(self):
        from repro_torch.kernels import autograd
        from repro_torch.kernels.flash import ops as flash_ops
        from repro_torch.kernels.ssd import ops as ssd_ops
        from repro_torch.models import attention, ssm
        from repro_torch.train import train_step

        self.events = {"flash": [], "ssd": [], "adamw": []}
        self.outside = {"flash": 0, "ssd": 0, "model_ssd": 0, "model_attend": 0}
        self.depth = 0
        self.saved = [(autograd.PlainGradient, "backward", autograd.PlainGradient.backward),
                      (flash_ops, "attention_reference", flash_ops.attention_reference),
                      (ssd_ops, "ssd_reference", ssd_ops.ssd_reference),
                      (ssm, "ssd_reference", ssm.ssd_reference),
                      (attention, "_attend", attention._attend),
                      (train_step, "adamw_update", train_step.adamw_update)]

        def counted(fn, name):
            def plain(*args, **kwargs):
                if self.depth == 0:
                    self.outside[name] += 1
                return fn(*args, **kwargs)
            return plain

        flash_ops.attention_reference = counted(flash_ops.attention_reference, "flash")
        ssd_ops.ssd_reference = counted(ssd_ops.ssd_reference, "ssd")
        ssm.ssd_reference = counted(ssm.ssd_reference, "model_ssd")
        attention._attend = counted(attention._attend, "model_attend")
        kernel_of = {flash_ops.attention_reference: "flash", ssd_ops._plain: "ssd"}
        backward = self.saved[0][2]

        def timed_backward(ctx, *grads):
            kind = kernel_of[ctx.plain]
            start, end = self._events()
            start.record()
            self.depth += 1
            try:
                with self.torch.profiler.record_function(TRAIN_SPANS[kind]):
                    out = backward(ctx, *grads)
            finally:
                self.depth -= 1
            end.record()
            self.events[kind].append((start, end))
            return out

        update = self.saved[-1][2]

        def timed_update(*args, **kwargs):
            start, end = self._events()
            start.record()
            with self.torch.profiler.record_function(TRAIN_SPANS["adamw"]):
                out = update(*args, **kwargs)
            end.record()
            self.events["adamw"].append((start, end))
            return out

        autograd.PlainGradient.backward = staticmethod(timed_backward)
        train_step.adamw_update = timed_update
        return self

    def __exit__(self, *exc):
        for owner, name, value in self.saved:
            setattr(owner, name, staticmethod(value) if name == "backward" else value)

    def ms(self) -> dict:
        """Device ms of each timed kind, summed over its windows."""
        self.torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v) for k, v in self.events.items()}


def _routes(kernel: str) -> dict:
    return LAUNCHES.by_route(kernel)


def train_setup(torch, cfg, device, *, rows=TRAIN_BATCH, seq=TRAIN_SEQ,
                microbatches=TRAIN_MICROBATCHES, steps=TRAIN_STEPS) -> dict:
    """What a user builds before training: random weights from the seed,
    an AdamW state (``OptimizerConfig()``), ``make_train_step``, and the
    pipeline's batches on the card."""
    from repro_torch.data import DataConfig, SyntheticLMData, to_device
    from repro_torch.models import build_model
    from repro_torch.train import OptimizerConfig, init_opt_state, make_train_step

    t = time.perf_counter()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(SEED), device)
    data = SyntheticLMData(cfg, DataConfig(global_batch=rows, seq_len=seq, seed=SEED))
    setup = dict(model=model, params=params, state=init_opt_state(params),
                 step=make_train_step(model, OptimizerConfig(), microbatches=microbatches),
                 batches=[to_device(data.global_batch(i), device) for i in range(steps)],
                 tokens=rows * seq)
    torch.cuda.synchronize()
    log(f"  model, AdamW state and {steps} batches of {rows} x {seq} on the card, "
        f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} B parameters: "
        f"{time.perf_counter() - t:.3f} s")
    return setup


def train_path(torch, r) -> dict:
    """Training, as a user calls it: ``train_step`` over the batches of
    ``r`` (from :func:`train_setup`), step 0 cold and under a
    :class:`TrainTimer`, the rest timed.  Adds what it produced to ``r``,
    for the checks made after the counted window."""

    params, state, step = r["params"], r["state"], r["step"]
    watched = {k: v.detach().clone() for k, v in params.named_parameters()
               if k in ("ln_f.scale", "shared.attn.wq", "lm_head")}
    per_step, metrics = [], []
    timer = TrainTimer(torch)
    cuda = next(iter(params.parameters())).is_cuda
    t = time.perf_counter()
    for i, batch in enumerate(r["batches"]):
        before = (_routes("flash"), _routes("ssd"))
        if i == 0:
            with timer:
                params, state, m = step(params, state, batch)
            torch.cuda.synchronize()
            cold, t = time.perf_counter() - t, time.perf_counter()
        elif i == len(r["batches"]) - 1 and cuda:
            # the last (warm) step's own memory: what it allocates over
            # what is resident before it, and its arguments' bytes
            torch.cuda.synchronize()
            held = {"peak_before": torch.cuda.max_memory_allocated(),
                    "allocated_before": torch.cuda.memory_allocated(),
                    "arguments": storage_bytes(torch, params, state, batch)}
            torch.cuda.reset_peak_memory_stats()
            params, state, m = step(params, state, batch)
            torch.cuda.synchronize()
            held["peak"] = torch.cuda.max_memory_allocated()
            r["warm_step_memory"] = held
        else:
            params, state, m = step(params, state, batch)
        per_step.append({name: {k: n - b[k] for k, n in _routes(name).items()}
                         for name, b in zip(("flash", "ssd"), before)})
        metrics.append(m)
    torch.cuda.synchronize()
    warm = (time.perf_counter() - t) / max(len(r["batches"]) - 1, 1)
    changed = {k: not torch.equal(v, params.state_dict()[k]) for k, v in watched.items()}
    r.update(params=params, state=state, per_step=per_step, metrics=metrics, cold_s=cold,
             warm_s=warm, changed=changed, outside=dict(timer.outside))
    return r


def storage_bytes(torch, *trees) -> int:
    """Bytes of the distinct storages of the tensors of ``trees`` (modules,
    dicts, lists and tuples of tensors): each once, whatever its views."""
    seen = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            s = x.untyped_storage()
            seen[s.data_ptr()] = s.nbytes()
        elif isinstance(x, torch.nn.Module):
            for t in (*x.parameters(), *x.buffers()):
                walk(t)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    for tree in trees:
        walk(tree)
    return sum(seen.values())


def plain_train_loss(torch, cfg, params, batch, microbatches: int) -> float:
    """The plain path's loss (``use_pallas=False``) on the same parameters
    and batch under ``no_grad``: the mean of its microbatches' losses, as
    the train step's."""
    from repro_torch.models import build_model
    from repro_torch.train.train_step import _microbatches

    plain = build_model(replace(cfg, use_pallas=False))
    with torch.no_grad():
        parts = [plain.loss(params, one)[0] for one in _microbatches(batch, microbatches)]
    return float(sum(parts) / microbatches)


def check_train(torch, r, cfg, plain_loss: float) -> dict:
    """What the train path produced: finite losses and gradient norms,
    parameters that moved, each step's K3 and K4 launches and route, no
    plain version run outside the Function's backward, and the step-0 loss
    against the plain path's."""
    want = train_launches(cfg, TRAIN_MICROBATCHES)
    routes = {"flash": expected_route(cfg.dtype), "ssd": expected_route(cfg.dtype, ssd_widths(cfg))}
    for i, launched in enumerate(r["per_step"]):
        for name, n in want.items():
            route = routes[name]
            check(launched[name] == {**{k: 0 for k in launched[name]}, route: n},
                  f"train step {i} launched {name} {launched[name]}, not {n} on the {route} route")
    log(f"  launches a step (2 microbatches, remat {cfg.remat}): "
        + ", ".join(f"{k} {v}" for k, v in r["per_step"][0].items()))
    check(r["outside"]["flash"] == r["outside"]["ssd"] == r["outside"]["model_ssd"]
          == r["outside"]["model_attend"] == 0,
          f"a plain version ran outside the kernels' backward: {r['outside']}")
    log(f"  plain versions called outside the Function's backward in step 0: {r['outside']}")
    losses = [float(m["loss"]) for m in r["metrics"]]
    norms = [float(m["grad_norm"]) for m in r["metrics"]]
    log(f"  losses {[f'{x:.5f}' for x in losses]}, grad norms {[f'{x:.4f}' for x in norms]}")
    check(all(math.isfinite(x) for x in losses + norms), "a loss or grad norm is not finite")
    check(all(r["changed"].values()), f"parameters did not change: {r['changed']}")
    rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    log(f"  step-0 loss with the kernels {losses[0]:.6f} vs the plain path's {plain_loss:.6f}: "
        f"rel {rel:.3e} (tol {TRAIN_LOSS_TOL})")
    check(rel <= TRAIN_LOSS_TOL, "the step-0 loss with the kernels disagrees with the plain path")
    log(f"  step 0 (cold) {r['cold_s']:.3f} s; warm {1e3 * r['warm_s']:.1f} ms a step, "
        f"{r['tokens'] / r['warm_s']:.1f} tokens/s")
    return {"losses": losses, "grad_norms": norms, "plain_step0_loss": plain_loss,
            "step0_rel_err": rel, "cold_step_s": r["cold_s"], "warm_ms_per_step": 1e3 * r["warm_s"],
            "tokens_per_s": r["tokens"] / r["warm_s"], "launches_per_step": r["per_step"][0]}


def span_device_ms(torch, prof, label: str) -> float:
    """Device ms of the kernels launched inside every ``label`` span: the
    kernels of its host-side ops and of their children, found through the
    profiler's launch correlation (the span's own device-side copy, a user
    annotation, is left out)."""
    cpu = torch.autograd.DeviceType.CPU

    def kernels_us(e):
        return (sum(k.duration for k in e.kernels if k.name != label)
                + sum(kernels_us(c) for c in e.cpu_children))

    return sum(kernels_us(e) for e in prof.events()
               if e.device_type == cpu and e.name == label) / 1e3


def profile_train(torch, r, expect=("flash", "ssd")) -> dict:
    """Two more warm steps under the profiler, with the plain backward of K3
    and K4 and the AdamW update timed by CUDA events.  The first records
    the device only: device time by class, and each window's width by its
    events, which also holds the host's time inside it while the device
    idles.  The second records host ops too, which link each kernel to the
    window (profiler span) that launched it: the device time of the kernels
    inside each window, which must be some for each kernel in ``expect``."""
    from torch.profiler import ProfilerActivity, profile

    batch = r["batches"][-1]
    # device-side events only on the card (the CPU rehearsal records host ops)
    on_card = next(r["params"].parameters()).device.type == "cuda"

    def profiled_step(acts):
        with TrainTimer(torch) as timer, profile(activities=acts) as prof:
            r["params"], r["state"], _ = r["step"](r["params"], r["state"], batch)
            torch.cuda.synchronize()
        return timer, prof

    timer, prof = profiled_step([ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU])
    times, other, k4 = _kernel_times(torch, prof)
    ev = timer.ms()
    busy = sum(times.values())
    wall = 1e3 * r["warm_s"]
    if busy == 0.0:
        log("  profile train step: the profiler saw no device time")
        return {"events_ms": ev}
    log(f"  profile train step: device busy {busy:.1f} ms of {wall:.1f} ms wall "
        f"({100 * busy / wall:.1f} % busy, {100 * (1 - busy / wall):.1f} % idle); "
        + ", ".join(f"{k} {v:.1f}" for k, v in times.items()) + " ms")
    # an event window holds the device's idle time inside it too (the host's
    # Python between launches): shares of the wall
    log(f"    CUDA event windows: plain backward of K3 {ev['flash']:.1f} ms ({100 * ev['flash'] / wall:.1f} %"
        f" of the step's wall), of K4 {ev['ssd']:.1f} ms ({100 * ev['ssd'] / wall:.1f} %), AdamW "
        f"{ev['adamw']:.1f} ms ({100 * ev['adamw'] / wall:.1f} %)")
    log("    heaviest of other (ms, launches, kernel): "
        + "; ".join(f"{ms:.1f}, {c}, {k}" for ms, c, k in other))
    del prof
    _, prof = profiled_step([ProfilerActivity.CPU, ProfilerActivity.CUDA])
    busy2 = sum(_kernel_times(torch, prof)[0].values())
    spans = {k: span_device_ms(torch, prof, label) for k, label in TRAIN_SPANS.items()}
    # the device's own time inside each window: shares of the device's busy time
    log(f"    device time inside the windows (a second step, host ops recorded; device busy "
        f"{busy2:.1f} ms): plain backward of K3 {spans['flash']:.1f} ms "
        f"({100 * spans['flash'] / busy2:.1f} % of device busy), of K4 {spans['ssd']:.1f} ms "
        f"({100 * spans['ssd'] / busy2:.1f} %), AdamW {spans['adamw']:.1f} ms "
        f"({100 * spans['adamw'] / busy2:.1f} %)")
    check(all(spans[k] > 0.0 for k in expect) and sum(spans.values()) <= busy2 * 1.001,
          f"the windows' device time {spans} does not fit the step's device busy {busy2:.1f} ms")
    return {"device_ms": busy, "wall_ms": wall, **times, "events_ms": ev,
            "span_device_ms": spans, "span_step_device_ms": busy2, "k4_pass_ms": k4}


def train_parity_phase(torch, device, arch, n_layers, seed) -> dict:
    """``arch`` at full widths in fp32, cut to ``n_layers`` (one group):
    ``loss`` and every parameter's gradient with K3/K4 (the fma route)
    against the plain path, on a batch of 2 x 512."""
    from repro_torch.models import build_model

    gen = torch.Generator(device=device).manual_seed(seed)
    cut = dict(n_layers=n_layers, dtype="float32")
    kernels = build_model(model_config(arch, True, **cut))
    plain = build_model(model_config(arch, False, **cut))
    cfg = kernels.cfg
    params = kernels.init(gen, device)
    params.requires_grad_(True)
    names = [k for k, _ in params.named_parameters()]
    batch = {"tokens": torch.randint(0, cfg.vocab, (TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ),
                                     generator=gen, device=device)}
    before = (_routes("flash"), _routes("ssd"))
    with TrainTimer(torch) as timer:
        loss_k, _ = kernels.loss(params, batch)
        grads_k = torch.autograd.grad(loss_k, list(params.parameters()))
    launched = {name: {r: n - b[r] for r, n in _routes(name).items()}
                for name, b in zip(("flash", "ssd"), before)}
    want = train_launches(cfg, 1)
    for name, n in want.items():
        check(device.type != "cuda" or launched[name] == {**{r: 0 for r in launched[name]},
                                                          "fma": n},
              f"{arch} fp32 train parity launched {name} {launched[name]}, not {n} on the fma route")
    check(device.type != "cuda" or timer.outside["flash"] == timer.outside["ssd"] == 0,
          f"{arch}: a kernel's plain version ran outside its backward: {timer.outside}")
    loss_p, _ = plain.loss(params, batch)
    grads_p = torch.autograd.grad(loss_p, list(params.parameters()))
    loss_k, loss_p = loss_k.detach(), loss_p.detach()
    err = abs(float(loss_k) - float(loss_p))
    worst, worst_name = 0.0, ""
    for name, gk, gp in zip(names, grads_k, grads_p):
        scale = gp.abs().max().item()
        diff = (gk - gp).abs().max().item()
        ratio = diff / scale if scale > 0 else (0.0 if diff == 0 else math.inf)
        if ratio > worst:
            worst, worst_name = ratio, name
    norm_k = torch.sqrt(sum(g.square().sum() for g in grads_k)).item()
    norm_p = torch.sqrt(sum(g.square().sum() for g in grads_p)).item()
    norm_rel = abs(norm_k - norm_p) / norm_p
    log(f"  {arch} fp32 train parity ({n_layers} layers, batch {TRAIN_PARITY_BATCH} x "
        f"{TRAIN_PARITY_SEQ}), launches {launched}: loss {float(loss_k):.6f} vs plain "
        f"{float(loss_p):.6f}, |diff| {err:.3e} (tol {TRAIN_PARITY_LOSS_TOL}); worst leaf "
        f"max|dg| / max|g| {worst:.3e} ({worst_name}; tol {TRAIN_PARITY_GRAD_TOL}); grad norm "
        f"{norm_k:.6f} vs {norm_p:.6f}, rel {norm_rel:.3e} (tol {TRAIN_PARITY_LOSS_TOL})")
    check(math.isfinite(float(loss_k)) and err <= TRAIN_PARITY_LOSS_TOL,
          f"{arch}: the loss with the kernels disagrees with the plain path")
    check(worst <= TRAIN_PARITY_GRAD_TOL, f"{arch}: gradient of {worst_name} disagrees")
    check(norm_rel <= TRAIN_PARITY_LOSS_TOL, f"{arch}: the global grad norm disagrees")
    return {"loss_abs_err": err, "worst_grad_rel_err": worst, "worst_grad_leaf": worst_name,
            "grad_norm_rel_err": norm_rel, "launches": launched}


def _example():
    """``examples/pccl_dp_training_torch.py`` as a module."""
    import importlib.util

    path = SRC.parent / "examples" / "pccl_dp_training_torch.py"
    spec = importlib.util.spec_from_file_location("pccl_dp_training_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def dp_path(torch, device, steps=DP_STEPS, **override) -> dict:
    """The data-parallel example's step as a user calls it: the example's
    config and defaults (``override`` shrinks them for a rehearsal), its
    ranks stacked on the card, the gradients all-reduced through
    ``PcclSession(H100_DGX)``'s planned communicator; CUDA events around
    each all-reduce.  Step 0 cold, the rest timed."""
    from repro_torch import PcclSession
    from repro_torch.core import cost_model as cm
    from repro_torch.data import DataConfig, SyntheticLMData, to_device
    from repro_torch.models import build_model
    from repro_torch.train import OptimizerConfig, init_opt_state, make_dp_train_step

    ex = _example()
    args = ex.parser().parse_args([])
    for k, v in override.items():
        setattr(args, k, v)
    cfg = ex.dp_config(args.d_model, args.layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(SEED), device)
    n_params = sum(p.numel() for p in params.parameters())
    comm = PcclSession(cm.H100_DGX, device=device).communicator("data", ex.RANKS)
    algorithm = comm.chosen_algorithm("all_reduce", 4.0 * n_params)
    data = SyntheticLMData(cfg, DataConfig(global_batch=args.batch, seq_len=args.seq))
    batches = [to_device(data.global_batch(i), device) for i in range(steps)]
    step = make_dp_train_step(model, OptimizerConfig(lr=1e-3, total_steps=args.steps,
                                                     warmup_steps=10), comm, ex.RANKS)
    state = init_opt_state(params)
    start = {k: v.detach().clone() for k, v in params.named_parameters()}
    events, all_reduce = [], comm.all_reduce

    def timed_all_reduce(x):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = all_reduce(x)
        e.record()
        events.append((s, e))
        return out

    comm.all_reduce = timed_all_reduce
    losses = []
    t = time.perf_counter()
    for i in range(steps):
        if i == 1:
            torch.cuda.synchronize()
            cold, t = time.perf_counter() - t, time.perf_counter()
            events.clear()
        params, state, m = step(params, state, batches[i])
        losses.append(m["loss"])
    torch.cuda.synchronize()
    warm = (time.perf_counter() - t) / max(steps - 1, 1)
    ar_ms = sum(s.elapsed_time(e) for s, e in events) / max(steps - 1, 1)
    comm.all_reduce = all_reduce
    log(f"  {n_params / 1e6:.1f} M parameters (fp32), {ex.RANKS} ranks stacked, batch "
        f"{args.batch} x {args.seq}: PCCL chose '{algorithm}' for the "
        f"{4.0 * n_params / 1e6:.0f} MB gradient all-reduce (H100_DGX fabric model), "
        f"{len(start)} leaves a step")
    return dict(model=model, params=params, start=start, comm=comm, batch0=batches[0],
                losses=losses, algorithm=algorithm, cold_s=cold, warm_s=warm, ar_ms=ar_ms,
                tokens=args.batch * args.seq, n=ex.RANKS)


def check_dp(torch, r) -> dict:
    """Step 0 again from the starting weights: every rank's row of each
    all-reduced leaf the same bits, the ranks' mean loss the full batch's
    loss (and the step's), the mean gradient the full batch's."""
    from repro_torch.models import ParamTree
    from repro_torch.train import dp_gradients

    params = ParamTree.from_state_dict(r["start"])
    n = r["n"]
    losses, reduced = dp_gradients(r["model"], params, r["batch0"], r["comm"], n)
    for name, red in reduced.items():
        check(all(torch.equal(red[i], red[0]) for i in range(1, n)),
              f"the all-reduced rows of {name} differ across ranks")
    log(f"  every rank's row of all {len(reduced)} all-reduced leaves: bit-identical")
    full_loss, _ = r["model"].loss(params, r["batch0"])
    names = [k for k, _ in params.named_parameters()]
    full = dict(zip(names, torch.autograd.grad(full_loss, list(params.parameters()))))
    full_loss = full_loss.detach()
    step0 = float(r["losses"][0])
    loss_err = max(abs(step0 - float(full_loss)), abs(float(losses.mean()) - float(full_loss)))
    worst = max(((reduced[k][0] / n - g).abs().max().item() / max(g.abs().max().item(), 1e-30), k)
                for k, g in full.items())
    log(f"  step-0 loss {step0:.6f} vs one full-batch loss {float(full_loss):.6f}: "
        f"|diff| {loss_err:.3e} (tol {DP_LOSS_TOL}); mean gradient vs the full batch's: worst "
        f"max|dg| / max|g| {worst[0]:.3e} ({worst[1]}; tol {DP_GRAD_TOL})")
    check(loss_err <= DP_LOSS_TOL, "the data-parallel loss disagrees with the full batch's")
    check(worst[0] <= DP_GRAD_TOL, f"the all-reduced gradient of {worst[1]} disagrees")
    losses = [float(x) for x in r["losses"]]
    check(all(math.isfinite(x) for x in losses), "a data-parallel loss is not finite")
    share = r["ar_ms"] / (1e3 * r["warm_s"])
    log(f"  losses {[f'{x:.4f}' for x in losses]}; step 0 (cold) {r['cold_s']:.3f} s; warm "
        f"{1e3 * r['warm_s']:.1f} ms a step, all-reduce {r['ar_ms']:.1f} ms of it ({100 * share:.1f} "
        f"%, CUDA events), {r['tokens'] / r['warm_s']:.1f} tokens/s")
    return {"algorithm": r["algorithm"], "losses": losses, "warm_ms_per_step": 1e3 * r["warm_s"],
            "all_reduce_ms_per_step": r["ar_ms"], "all_reduce_share": share,
            "tokens_per_s": r["tokens"] / r["warm_s"], "step0_loss_err": loss_err,
            "worst_grad_rel_err": worst[0]}


# ------------------------------------------------------ the Trainer (path 9)


def checkpoint_bytes(cfg) -> int:
    """Bytes of one checkpoint of ``cfg``'s train state: fp32 parameters and
    two fp32 moments (and the int32 step)."""
    from repro_torch.models import build_model
    from repro_torch.models.module import param_count

    return 3 * 4 * param_count(build_model(cfg).specs()) + 4


def check_disk(directory, cfg, count: int) -> dict:
    """Room under ``directory`` for ``count`` checkpoints of ``cfg``: the
    kept ones, the one being written and the one the trainer's last save
    replaces.  Raises when there is not."""
    import shutil

    need = count * checkpoint_bytes(cfg)
    free = shutil.disk_usage(directory).free
    log(f"  checkpoints under {directory}: {free / 1e9:.1f} GB free, {count} checkpoints of "
        f"{checkpoint_bytes(cfg) / 1e9:.2f} GB need {need / 1e9:.1f} GB")
    check(free >= need, f"{directory} has {free / 1e9:.1f} GB free; path 9's {count} checkpoints "
          f"of {cfg.name} need {need / 1e9:.1f} GB (set TMPDIR to a larger disk)")
    return {"free_gb": free / 1e9, "need_gb": need / 1e9}


class TrainerProbe:
    """Watches a :class:`~repro_torch.train.Trainer` as it runs, through the
    instance attributes it calls: each step's K3 launches by route and the
    time its device work ended (a synchronize after the step), the time the
    injected failure fired and the device memory then, each save's wait for
    the previous writer and its blocking time (the device → host copy and
    the writer's start), each write's seconds in the writer thread, and
    each restore's wait for the writer, its load and copy time and the
    device memory after it."""

    def __init__(self, torch, trainer):
        from repro_torch.runtime.fault import InjectedFailure

        self.steps, self.saves, self.writes, self.restores, self.failure = [], [], [], [], None
        build, check_step = trainer._build, trainer.injector.check

        def built():
            build()
            step_fn = trainer._step_fn

            def step(params, state, batch):
                before = _routes("flash")
                out = step_fn(params, state, batch)
                torch.cuda.synchronize()
                self.steps.append({"flash": {k: n - before[k]
                                             for k, n in _routes("flash").items()},
                                   "end": time.perf_counter()})
                return out

            trainer._step_fn = step

        def checked(step):
            try:
                check_step(step)
            except InjectedFailure:
                self.failure = {"step": step, "t": time.perf_counter(),
                                "memory_gib": torch.cuda.memory_allocated() / 2**30}
                raise

        trainer._build, trainer.injector.check = built, checked
        mgr = trainer.ckpt
        save, write, restore = mgr.save, mgr._write, mgr.restore

        def timed_save(step, tree, extra=None):
            t = time.perf_counter()
            mgr.wait()
            t1 = time.perf_counter()
            save(step, tree, extra)
            self.saves.append({"step": step, "wait_ms": 1e3 * (t1 - t),
                               "blocking_ms": 1e3 * (time.perf_counter() - t1)})

        def timed_write(step, *args):
            t = time.perf_counter()
            write(step, *args)
            self.writes.append({"step": step, "s": time.perf_counter() - t})

        def timed_restore(template, step=None):
            t = time.perf_counter()
            mgr.wait()
            t1 = time.perf_counter()
            out = restore(template, step)
            torch.cuda.synchronize()
            self.restores.append({"step": out[1], "wait_ms": 1e3 * (t1 - t),
                                  "load_ms": 1e3 * (time.perf_counter() - t1),
                                  "memory_gib": torch.cuda.memory_allocated() / 2**30})
            return out

        mgr.save, mgr._write, mgr.restore = timed_save, timed_write, timed_restore


def make_trainer(torch, cfg, device, ckpt_dir=None, fail_at=()):
    """Path 9's Trainer, as a user builds it: the pipeline's batches of 8 x
    448, AdamW warming up over one step, a checkpoint every 3 steps (2
    kept, written asynchronously) under ``ckpt_dir``, failures at
    ``fail_at``."""
    from repro_torch.ckpt import CheckpointConfig
    from repro_torch.data import DataConfig
    from repro_torch.runtime.fault import FailureInjector
    from repro_torch.train import OptimizerConfig, Trainer, TrainerConfig

    return Trainer(
        cfg, DataConfig(global_batch=TRAINER_BATCH, seq_len=TRAINER_SEQ, seed=SEED),
        OptimizerConfig(lr=1e-4, total_steps=TRAINER_STEPS, warmup_steps=1),
        TrainerConfig(total_steps=TRAINER_STEPS, ckpt_every=TRAINER_CKPT_EVERY, log_every=1,
                      microbatches=TRAINER_MICROBATCHES, seed=SEED),
        ckpt_cfg=None if ckpt_dir is None else CheckpointConfig(
            str(ckpt_dir), keep=TRAINER_CKPT_KEEP, async_write=True),
        failure_injector=FailureInjector(fail_at_steps=fail_at), device=device)


def trainer_path(torch, cfg, device, ckpt_dir) -> dict:
    """Training through the Trainer, as a user runs it: checkpoints, the
    injected failure, the restart from the newest committed checkpoint and
    the replay, the final save."""
    trainer = make_trainer(torch, cfg, device, ckpt_dir, fail_at=(TRAINER_FAIL_AT,))
    probe = TrainerProbe(torch, trainer)
    t = time.perf_counter()
    out = trainer.run()
    torch.cuda.synchronize()
    # the run's own restores (a later restore of its checkpoints is probed too)
    return dict(trainer=trainer, probe=probe, out=out, restores=list(probe.restores),
                wall_s=time.perf_counter() - t)


def _dir_bytes(path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def check_trainer(torch, r, cfg) -> dict:
    """What the Trainer did: every step's K3 launches on the tensor-core
    route, one restart from step 6 with steps 6 and 7 replayed, finite
    losses and norms, the replays equal to their first pass, the
    checkpoints on disk, the failed attempt's state released before the
    restore; and its times."""
    out, probe, mgr = r["out"], r["probe"], r["trainer"].ckpt
    hist = out["history"]
    steps = [h["step"] for h in hist]
    want_steps = list(range(TRAINER_FAIL_AT)) + list(range(6, TRAINER_STEPS))
    check(steps == want_steps, f"the Trainer ran steps {steps}, not {want_steps}")
    check([x["step"] for x in r["restores"]] == [6], f"restored {r['restores']}, not step 6 once")
    check(probe.failure is not None and probe.failure["step"] == TRAINER_FAIL_AT,
          f"the failure fired as {probe.failure}")
    want = train_launches(cfg, TRAINER_MICROBATCHES)["flash"]
    route = expected_route(cfg.dtype)
    check(len(probe.steps) == len(hist), f"{len(probe.steps)} steps probed, {len(hist)} run")
    for i, launched in enumerate(probe.steps):
        check(launched["flash"] == {**{k: 0 for k in launched["flash"]}, route: want},
              f"Trainer step {steps[i]} launched K3 {launched['flash']}, not {want} on {route}")
    log(f"  K3 a step: {probe.steps[0]['flash']} ({cfg.n_layers} decoder layers x forward and "
        f"remat recompute x {TRAINER_MICROBATCHES} microbatches), {len(hist)} steps")
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    check(all(math.isfinite(x) for x in losses + norms), "a loss or grad norm is not finite")
    first = {h["step"]: h for h in hist[:TRAINER_FAIL_AT]}
    replay = hist[TRAINER_FAIL_AT:TRAINER_FAIL_AT + 2]
    rel = max(abs(h["loss"] - first[h["step"]]["loss"]) / abs(first[h["step"]]["loss"])
              for h in replay)
    bit_equal = all(h["loss"] == first[h["step"]]["loss"]
                    and h["grad_norm"] == first[h["step"]]["grad_norm"] for h in replay)
    log(f"  losses {[round(x, 5) for x in losses]}; replayed steps 6, 7 against their first pass: "
        f"max rel {rel:.3e} (tol {REPLAY_TOL}), loss and grad norm bit-identical: {bit_equal}")
    check(rel <= REPLAY_TOL, "a replayed step's loss differs from its first pass")
    check(mgr.latest_step() == TRAINER_STEPS and mgr.steps() == [TRAINER_STEPS - 1, TRAINER_STEPS],
          f"checkpoints on disk {mgr.steps()}")
    tmp = sorted(p.name for p in mgr.dir.glob(".tmp_step_*"))
    check(not tmp, f"temporary checkpoint directories left: {tmp}")
    restored = r["restores"][0]
    # the restart builds a fresh state and restores into it: the failed
    # attempt's parameters and moments must be gone by then
    check(restored["memory_gib"] <= probe.failure["memory_gib"] + 1.0,
          f"{restored['memory_gib']:.2f} GiB after the restore against "
          f"{probe.failure['memory_gib']:.2f} GiB at the failure: the failed state is still held")
    times = [h["step_time_s"] for h in hist]
    warm = statistics.median(t for i, t in enumerate(times) if i not in (0, TRAINER_FAIL_AT))
    tokens = TRAINER_BATCH * TRAINER_SEQ
    restart_s = probe.steps[TRAINER_FAIL_AT]["end"] - probe.failure["t"]
    gb = _dir_bytes(mgr.dir / f"step_{TRAINER_STEPS:09d}") / 1e9
    stats = {
        "steps": steps, "losses": losses, "grad_norms": norms, "replay_rel_err": rel,
        "replay_bit_identical": bit_equal, "step_ms": [1e3 * t for t in times],
        "cold_step_ms": 1e3 * times[0], "warm_ms_per_step": 1e3 * warm,
        "tokens_per_s": tokens / warm, "saves": probe.saves, "writes": probe.writes,
        "restore": restored, "failure_memory_gib": probe.failure["memory_gib"],
        "restart_s": restart_s, "ckpt_gb": gb, "write_gb_per_s": [gb / w["s"] for w in probe.writes],
        "wall_s": r["wall_s"], "launches_per_step": probe.steps[0]["flash"],
    }
    log(f"  step 0 (cold) {1e3 * times[0]:.1f} ms; warm {1e3 * warm:.1f} ms a step (median of "
        f"{len(times) - 2}), {tokens / warm:.1f} decoder tokens/s")
    log("  saves: " + "; ".join(f"step {x['step']}: waited {x['wait_ms']:.1f} ms, blocked "
                                f"{x['blocking_ms']:.1f} ms" for x in probe.saves))
    log("  writes: " + "; ".join(f"step {x['step']}: {x['s']:.2f} s" for x in probe.writes)
        + f"; {gb:.3f} GB a checkpoint on disk")
    log(f"  restore of step 6: waited {restored['wait_ms']:.1f} ms for the writer, loaded and "
        f"copied in {restored['load_ms']:.1f} ms; device memory {probe.failure['memory_gib']:.2f} "
        f"GiB at the failure, {restored['memory_gib']:.2f} GiB after the restore")
    log(f"  restart: {restart_s:.3f} s from the failure to the end of the first replayed step, "
        f"against {warm:.3f} s for a warm step")
    return stats


def restore_round_trip(torch, r, cfg, device):
    """The last checkpoint restored into a tree initialised from another
    seed: every leaf equal to the Trainer's final parameters and moments."""
    from repro_torch.ckpt.checkpoint import flatten
    from repro_torch.train import init_opt_state

    model = r["trainer"].model
    params = model.init(torch.Generator(device=device).manual_seed(SEED + 7), device)
    t = time.perf_counter()
    (params, state), step, extra = r["trainer"].ckpt.restore((params, init_opt_state(params)))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t)
    got = dict(flatten((params, state)))
    want = dict(flatten((r["out"]["params"], r["out"]["opt_state"])))
    check(step == TRAINER_STEPS and list(got) == list(want),
          f"restored step {step} with {len(got)} leaves, want {len(want)}")
    equal = [k for k in want if torch.equal(got[k], want[k])]
    log(f"  step-{step} checkpoint restored into a fresh tree (seed {SEED + 7}) in {ms:.1f} ms: "
        f"{len(equal)} of {len(want)} leaves equal the Trainer's final state")
    check(len(equal) == len(want), "a restored leaf differs from the Trainer's final state")
    return params, {"restore_ms": ms, "leaves": len(want), "extra": extra}


def serve_tokens(torch, cfg, device, params, prompts):
    """Greedy tokens of a ServeEngine on ``params`` for ``prompts``, and the
    prefill logits of the same batch (a trained model's greedy tokens can
    all be the data's commonest token, so the tokens alone say little)."""
    import numpy as np

    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    engine = ServeEngine(cfg, EngineConfig(batch_size=len(prompts),
                                           max_len=max(prompts) + TRAINER_SERVE_NEW_TOKENS),
                         params=params, device=device)
    rng = np.random.default_rng(SEED)
    requests = [Request(prompt=rng.integers(0, cfg.vocab, size=n).astype(np.int32),
                        max_new_tokens=TRAINER_SERVE_NEW_TOKENS) for n in prompts]
    engine.generate(requests)
    check(all(len(q.generated) == TRAINER_SERVE_NEW_TOKENS for q in requests),
          "a request came up short")
    check(all(0 <= x < cfg.vocab for q in requests for x in q.generated),
          "a generated token is out of the vocabulary")
    with torch.inference_mode():
        logits, _ = engine.model.prefill(engine.params, served_batch(torch, engine, prompts),
                                         max_len=engine.ecfg.max_len)
    return [q.generated for q in requests], logits


def uninterrupted_path(torch, cfg, device, r) -> dict:
    """The same Trainer without the failure and without checkpoints: its
    final loss against the interrupted run's, and how far apart the two
    runs' parameters and moments ended."""
    from repro_torch.ckpt.checkpoint import flatten

    trainer = make_trainer(torch, cfg, device)
    out = trainer.run()
    torch.cuda.synchronize()
    a, b = out["final_metrics"]["loss"], r["out"]["final_metrics"]["loss"]
    rel = abs(a - b) / abs(b)
    mine = dict(flatten((out["params"], out["opt_state"])))
    theirs = dict(flatten((r["out"]["params"], r["out"]["opt_state"])))
    worst = max(((mine[k].float() - theirs[k].float()).abs().max().item(), k) for k in mine)
    params_equal = all(torch.equal(mine[k], theirs[k]) for k in mine if k.startswith("0."))
    state_equal = all(torch.equal(mine[k], theirs[k]) for k in mine)
    first_pass = {h["step"]: h["loss"] for h in r["out"]["history"]}
    step_rel = max(abs(h["loss"] - first_pass[h["step"]]) / abs(first_pass[h["step"]])
                   for h in out["history"])
    warm = statistics.median(h["step_time_s"] for h in out["history"][1:])
    log(f"  uninterrupted run (no checkpoint writer beside its steps): warm {1e3 * warm:.1f} ms a "
        f"step, {TRAINER_BATCH * TRAINER_SEQ / warm:.1f} decoder tokens/s")
    log(f"  uninterrupted run: final loss {a:.7f} vs the interrupted run's {b:.7f}, rel {rel:.3e} "
        f"(tol {UNINTERRUPTED_TOL}); worst step's loss rel {step_rel:.3e}; worst leaf max-abs "
        f"difference {worst[0]:.3e} ({worst[1]}); parameters bit-identical {params_equal}, "
        f"with the moments {state_equal}")
    check(rel <= UNINTERRUPTED_TOL, "the interrupted run's final loss differs from an uninterrupted run's")
    return dict(trainer=trainer, out=out, stats={
        "final_loss_rel_err": rel, "worst_step_loss_rel_err": step_rel,
        "worst_leaf_max_abs": worst[0], "worst_leaf": worst[1],
        "params_bit_identical": params_equal, "state_bit_identical": state_equal,
        "warm_ms_per_step": 1e3 * warm, "tokens_per_s": TRAINER_BATCH * TRAINER_SEQ / warm})


def cli_path(torch, ckpt_dir) -> dict:
    """``python -m repro_torch.launch.train`` in a fresh process with no
    ``--device``: a reduced Whisper with a checkpoint every 2 steps and a
    failure at step 3, on the card by default."""
    import os

    cmd = [sys.executable, "-m", "repro_torch.launch.train", *CLI_ARGS, "--ckpt-dir", str(ckpt_dir)]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t
    lines = proc.stdout.strip().splitlines()
    log(f"  {' '.join(cmd[1:])}: exit {proc.returncode} in {wall:.1f} s; first line {lines[:1]}, "
        f"last two {lines[-2:]}")
    check(proc.returncode == 0, f"the training CLI failed: {proc.stderr[-2000:]}")
    check(bool(lines) and re.fullmatch(r"\[train\] whisper-small on cuda(:\d+)?", lines[0]) is not None,
          f"the training CLI did not report the card as its device: {lines[:1]}")
    check(any("injected node failure at step 3" in x and "restarting from latest checkpoint" in x
              for x in lines), "the training CLI printed no restart")
    check("[trainer] resumed from step 2" in lines, "the training CLI did not resume from step 2")
    check(lines[-2].startswith("final: {") and lines[-1].startswith(
        "DP gradient all-reduce algorithm chosen by PCCL: "), "the training CLI's last lines")
    return {"exit": proc.returncode, "wall_s": wall, "device_line": lines[0],
            "last_lines": lines[-2:]}


def trainer_phase(torch, reset_counts, read_counts):
    """Main path 9 with the counts set to 0 just before it (the Trainer's
    run, the restore of its last checkpoint and serving from it) and read
    just after; then its checks, the uninterrupted run, a profiled step and
    the CLI.  Returns (the counts, K3's launches by route, the stats)."""
    from repro_torch.data import to_device
    from repro_torch.train import make_train_step

    log("== main path 9: train whisper-small at published widths and depth through the Trainer "
        f"(K3 in the decoder's forward), a failure at step {TRAINER_FAIL_AT}, restart from the "
        "last checkpoint, serve from the final one")
    whisper_train = model_config("whisper-small", True)
    cuda = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
        # the 2 kept, the one being written, the final save's replacement
        trainer_stats = {"disk": check_disk(ckpt_dir, whisper_train, TRAINER_CKPT_KEEP + 2)}
        reset_counts()
        run9 = trainer_path(torch, whisper_train, cuda, ckpt_dir)
        restored, trainer_stats["round_trip"] = restore_round_trip(torch, run9, whisper_train, cuda)
        served, logits = serve_tokens(torch, whisper_train, cuda, restored, WHISPER_PROMPTS)
        path9 = read_counts()
        routes9 = {"flash": LAUNCHES.by_route("flash")}
        log(f"  phase main path 9: {time.perf_counter() - t:.3f} s; kernel launches {path9}")
        check(path9["flash"] > 0, "main path 9 never launched K3")
        trainer_stats.update(check_trainer(torch, run9, whisper_train))
        trainer_stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"  peak device memory across the run, the restart and serving: "
            f"{trainer_stats['peak_gib']:.2f} GiB")
        run9["out"]["params"].requires_grad_(False)  # as the restored tree: serving alike
        direct, direct_logits = serve_tokens(torch, whisper_train, cuda, run9["out"]["params"],
                                             WHISPER_PROMPTS)
        same_logits = torch.equal(logits, direct_logits)
        log(f"  served from the step-{TRAINER_STEPS} checkpoint: {[g[:4] for g in served]}; from the "
            f"Trainer's final parameters the same tokens: {served == direct}, the same prefill "
            f"logits bit for bit: {same_logits}")
        check(served == direct, "serving from the checkpoint gave other tokens than the trained tree")
        check(same_logits, "serving from the checkpoint gave other prefill logits than the trained tree")
        trainer_stats["served_tokens"] = served
        del logits, direct_logits
        del restored
    t = time.perf_counter()
    clean = uninterrupted_path(torch, whisper_train, cuda, run9)
    trainer_stats["uninterrupted"] = clean["stats"]
    del run9
    gc.collect()
    torch.cuda.empty_cache()
    t9 = clean["trainer"]
    # the profiled step runs with no checkpoint writer beside it: its wall is
    # the uninterrupted run's warm step
    trainer_stats["profile"] = profile_train(torch, dict(
        params=clean["out"]["params"], state=clean["out"]["opt_state"],
        step=make_train_step(t9.model, t9.opt_cfg, microbatches=TRAINER_MICROBATCHES),
        batches=[to_device(t9.data.global_batch(0), cuda)],
        warm_s=clean["stats"]["warm_ms_per_step"] / 1e3), expect=("flash",))
    del clean, t9
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase uninterrupted run and profile: {time.perf_counter() - t:.3f} s")
    log("== the training CLI in a fresh process, on the card by default")
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as cli_dir:
        trainer_stats["cli"] = cli_path(torch, cli_dir)
    log(f"  phase CLI: {time.perf_counter() - t:.3f} s")
    return path9, routes9, trainer_stats


# ------------------------------------------ path 10: verified path 1, the CLIs


def fp32_calls(torch, comm, comm_ef, comm_ring, x, xm, w, gamma) -> dict:
    """Path 1's calls in fp32 on fixed inputs: the four planned collectives,
    ring_ef8, fused mm → RS (K1) and fused AR → RMSNorm (K2)."""
    from repro_torch.comm import fusion

    out = {coll: getattr(comm, coll)(x) for coll in ("all_reduce", "reduce_scatter", "all_to_all")}
    out["all_gather"] = comm.all_gather(out["reduce_scatter"])
    out["ring_ef8"] = comm_ef.all_reduce(x)
    out["mm_rs"] = fusion.fused_matmul_reduce_scatter(
        comm_ring, xm, w, block_m=BLOCKS[0], block_n=BLOCKS[1], block_k=BLOCKS[2])
    out["ar_rms"] = fusion.fused_all_reduce_rmsnorm(comm, x, gamma, eps=EPS)
    torch.cuda.synchronize()
    return out


class VerifyCounter:
    """Counts the schedules ``compile_schedule``'s ``PCCL_VERIFY`` hook
    verifies, by wrapping ``repro_torch.analysis.verify.assert_verified``
    (the hook looks it up at each miss) for the length of a ``with``."""

    def __enter__(self):
        from repro_torch.analysis import verify

        self.module, self.real, self.fingerprints = verify, verify.assert_verified, []

        def counted(schedule, **kw):
            self.fingerprints.append(schedule.fingerprint())
            return self.real(schedule, **kw)

        verify.assert_verified = counted
        return self

    def __exit__(self, *exc):
        self.module.assert_verified = self.real


def verified_path(torch, gen, device, reset_counts, read_counts) -> dict:
    """Main path 10a: path 1 again with ``PCCL_VERIFY=1`` after
    ``clear_exec_caches()``, the counts set to 0 just before it and read
    just after; path 1's calls in fp32 on fixed inputs, bit for bit as
    without the variable; a schedule with a transfer dropped refused before
    any table is built."""
    import os

    from repro_torch import PcclSession
    from repro_torch.analysis.verify import ScheduleVerificationError
    from repro_torch.comm import exec_engine
    from repro_torch.comm import primitives as prims
    from repro_torch.core import cost_model as cm
    from repro_torch.core import schedules as S

    check("PCCL_VERIFY" not in os.environ, "PCCL_VERIFY is set before path 10")
    fixed = torch.Generator(device=device).manual_seed(SEED + 10)
    K = D_FF // TP
    x = torch.randn(TP, TOKENS, D_MODEL, generator=fixed, device=device)
    xm = torch.randn(TP, TOKENS, K, generator=fixed, device=device)
    w = torch.randn(K, D_MODEL, generator=fixed, device=device) / math.sqrt(K)
    gamma = torch.randn(D_MODEL, generator=fixed, device=device) + 1.0

    def comms():
        session = PcclSession(cm.H100_DGX, device=device)
        return (session.communicator("x", TP),
                session.communicator("x", TP, rel_error_tol=cm.compressed_ef_error_bound(TP)),
                session.communicator("x", TP, algorithm="ring"))

    exec_engine.clear_exec_caches()
    t = time.perf_counter()
    plain = fp32_calls(torch, *comms(), x, xm, w, gamma)
    log(f"  fp32 calls without PCCL_VERIFY: {time.perf_counter() - t:.3f} s")

    exec_engine.clear_exec_caches()
    os.environ["PCCL_VERIFY"] = "1"
    try:
        with VerifyCounter() as counter:
            reset_counts()
            t = time.perf_counter()
            main_path(torch, gen, device)
            verified = fp32_calls(torch, *comms(), x, xm, w, gamma)
            wall = time.perf_counter() - t
            counts = read_counts()
            routes = LAUNCHES.by_route("matmul")
            tables = (len(exec_engine._COMPILED), len(exec_engine._DEVICE_TABLES))
            bad_base = S.ring_reduce_scatter(TP, 4.0 * TOKENS * D_MODEL)
            rounds = list(bad_base.rounds)
            rounds[2] = S.Round(rounds[2].transfers[:-1], rounds[2].size)
            bad = S.Schedule(bad_base.collective, bad_base.algorithm, bad_base.n,
                             bad_base.buffer_bytes, tuple(rounds))
            try:
                prims.reduce_scatter(x, bad)
            except ScheduleVerificationError as e:
                refused = str(e).splitlines()
            else:
                raise SmokeFailure("a schedule with a transfer dropped was not refused")
            after = (len(exec_engine._COMPILED), len(exec_engine._DEVICE_TABLES))
    finally:
        del os.environ["PCCL_VERIFY"]
    n_verified = len(counter.fingerprints)
    log(f"  phase main path 10a: {wall:.3f} s; kernel launches {counts}, K1 by route {routes}; "
        f"{n_verified} schedules verified ({len(set(counter.fingerprints))} distinct)")
    check(n_verified > 0, "PCCL_VERIFY=1 verified no schedule")
    check(device.type != "cuda" or (counts["matmul"] > 0 and counts["rmsnorm"] > 0),
          "main path 10 never launched K1 or K2")
    gates = kernel_gate_counts()
    log(f"  kernel lint gate (misses = analyses, hits = memo) under PCCL_VERIFY=1: {gates}")
    for kernel in ("matmul", "rmsnorm"):
        gated = sum(g["misses"] + g["hits"] for label, g in gates.items()
                    if label.startswith(kernel + ":"))
        check(gated == counts[kernel], f"{kernel}: {counts[kernel]} launches but {gated} passed "
                                       "the kernel lint gate")
    check(bad.fingerprint() in counter.fingerprints, "the dropped-transfer schedule was not verified")
    check(after == tables, f"the refused schedule changed the caches: {tables} -> {after}")
    log(f"  dropped transfer refused: {refused[0]} {refused[1].strip()}; caches (compiled, device "
        f"tables) {tables} -> {after}")
    for name, got in verified.items():
        check(torch.equal(got, plain[name]), f"{name} [float32] differs under PCCL_VERIFY=1")
    log(f"  {', '.join(verified)} [float32] under PCCL_VERIFY=1 vs without: bit-identical")
    del plain, verified
    comm, _, _ = comms()
    return {"counts": counts, "routes": routes, "verified": n_verified,
            "distinct_verified": len(set(counter.fingerprints)), "wall_s": wall,
            "refused": refused[0], "kernel_gate": gates, "x": x, "comm": comm}


def kernel_gate_counts() -> dict:
    """The ``PCCL_VERIFY`` kernel gate's misses and hits by kernel and route
    (empty before any wrapper passed it)."""
    lint = sys.modules.get("repro_torch.analysis.kernel_lint")
    return lint.gate_counts() if lint is not None else {}


def pcclcomm_path(torch, r) -> dict:
    """Path 10b: the four collectives through the deprecated ``PcclComm``
    shim on the card, bit for bit as the cold session's communicator."""
    import warnings

    from repro_torch import PcclSession
    from repro_torch.comm import PcclComm
    from repro_torch.core import cost_model as cm

    x = r["x"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        # on the card as a user makes it: no device, so CUDA
        shim = PcclComm(axis_name="x", n=TP, hw=cm.H100_DGX,
                        device=None if x.device.type == "cuda" else x.device)
    check(any(w.category is DeprecationWarning and "PcclComm is deprecated" in str(w.message)
              for w in caught), "PcclComm gave no DeprecationWarning")
    check(shim._comm.device.type == x.device.type, f"PcclComm runs on {shim._comm.device}")
    cold = PcclSession(cm.H100_DGX, thread_fabric=False, device=x.device).communicator("x", TP)
    shard = cold.reduce_scatter(x)
    algos = {}
    for coll in ("all_reduce", "reduce_scatter", "all_gather", "all_to_all"):
        src = shard if coll == "all_gather" else x
        got, want = getattr(shim, coll)(src), getattr(cold, coll)(src)
        check(torch.equal(got, want), f"PcclComm.{coll} [float32] differs from the communicator")
        algos[coll] = shim.chosen_algorithm(coll, src[0].numel() * src.element_size())
    log(f"  PcclComm (DeprecationWarning seen) vs a cold session's communicator, four collectives "
        f"[float32]: bit-identical; algorithms {algos}")
    return {"algorithms": algos}


def verify_cost(torch) -> dict:
    """Path 10c: the host time of a cold ``compile_schedule`` with and
    without ``PCCL_VERIFY=1`` (median of ``VERIFY_COST_REPS``), the
    fingerprint memoized before either."""
    import os

    from repro_torch.comm import exec_engine
    from repro_torch.core import schedules as S

    rows = []
    for coll, algo in VERIFY_COST_CASES:
        for n in VERIFY_COST_NS:
            sched = S.get_schedule(coll, algo, n, 4.0 * 2**20)
            sched.fingerprint()
            ms = {}
            for flag in ("0", "1"):
                os.environ["PCCL_VERIFY"] = flag
                times = []
                for _ in range(VERIFY_COST_REPS):
                    exec_engine.clear_exec_caches()
                    t = time.perf_counter()
                    exec_engine.compile_schedule(sched)
                    times.append((time.perf_counter() - t) * 1e3)
                ms[flag] = statistics.median(times)
            del os.environ["PCCL_VERIFY"]
            rows.append({"collective": coll, "algorithm": algo, "n": n,
                         "rounds": sched.num_rounds, "compile_ms": ms["0"],
                         "verified_compile_ms": ms["1"]})
            log(f"  cold compile_schedule {coll}/{algo} n={n} ({sched.num_rounds} rounds): "
                f"{ms['0']:.3f} ms, with PCCL_VERIFY=1 {ms['1']:.3f} ms "
                f"(+{ms['1'] - ms['0']:.3f} ms, x{ms['1'] / ms['0']:.2f})")
    exec_engine.clear_exec_caches()
    return {"rows": rows}


def fresh_process(cmd, timeout=600) -> dict:
    """``cmd`` in a fresh Python with ``PYTHONPATH=src`` from the checkout's
    root; its exit code, wall and lines, all printed."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("PCCL_VERIFY", None)
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, *cmd], cwd=SRC.parent, env=env, capture_output=True,
                          text=True, timeout=timeout)
    wall = time.perf_counter() - t
    lines = proc.stdout.strip().splitlines()
    log(f"  $ python {' '.join(cmd)}: exit {proc.returncode} in {wall:.1f} s")
    for line in lines:
        log(f"    | {line}")
    check(proc.returncode == 0, f"python {' '.join(cmd)} failed: {proc.stderr[-2000:]}")
    return {"exit": proc.returncode, "wall_s": wall, "lines": lines}


def cli_phase(torch) -> dict:
    """Path 10d: the analysis CLI, the lint, both examples (side by side:
    host work and small models) and then, alone, the serve CLI at
    Zamba2-2.7B's published widths and depth, each in a fresh process on
    the card by default."""
    light = {
        "analysis": ["-m", "repro_torch.analysis"],
        "lint": ["-m", "repro_torch.analysis.lint_concurrency"],
        "serve_decode": ["examples/serve_decode_torch.py"],
        "quickstart": ["examples/quickstart_torch.py"],
    }
    with ThreadPoolExecutor(len(light)) as pool:
        runs = dict(zip(light, pool.map(fresh_process, light.values())))
    check(runs["analysis"]["lines"][-1] == "[verify] PASS", "the analysis CLI did not PASS")
    check(runs["analysis"]["lines"][0].startswith("[verify] dataflow (78 schedules): ok"),
          "the analysis CLI did not verify the 78 schedules")
    check(runs["lint"]["lines"] == ["concurrency lint: 0 finding(s) in src/repro_torch"],
          "the lint found something in src/repro_torch")
    check(runs["serve_decode"]["lines"][0].startswith("[zamba2-2.7b] generated 48 tokens"),
          "the serve_decode example served no 48 tokens")
    check(any("on cuda" in line and "rounds" in line for line in runs["quickstart"]["lines"]),
          "the quickstart did not run its session on the card")
    torch.cuda.empty_cache()
    serve = fresh_process(["-m", "repro_torch.launch.serve", "--arch", "zamba2-2.7b",
                           "--no-reduced"])
    lines = serve["lines"]
    check(re.fullmatch(r"\[serve\] zamba2-2\.7b \(published config, d_model 2560, 54 layers\) "
                       r"on cuda(:\d+)?", lines[0]) is not None,
          f"the serve CLI did not serve the published Zamba2 on the card: {lines[:1]}")
    m = re.fullmatch(r"generated (\d+) tokens in ([\d.]+)s \(([\d.]+) tok/s, batch=4\)", lines[1])
    check(m is not None and int(m.group(1)) == 64, f"the serve CLI's result line: {lines[1:2]}")
    peak = re.fullmatch(r"peak device memory: ([\d.]+) GiB", lines[-1])
    check(peak is not None, f"the serve CLI printed no peak memory: {lines[-1:]}")
    runs["serve"] = {**serve, "tokens_per_s": float(m.group(3)), "generate_s": float(m.group(2)),
                     "peak_gib": float(peak.group(1))}
    return runs


def path10_phase(torch, gen, reset_counts, read_counts):
    """Main path 10 and its parts b–d.  Returns (the counts, K1's launches
    by route, the stats)."""
    log("== main path 10: path 1 again with PCCL_VERIFY=1 (every schedule verified before it "
        "compiles), Mistral-Large-123B widths, TP=8")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    r = verified_path(torch, gen, torch.device("cuda"), reset_counts, read_counts)
    counts, routes = r.pop("counts"), r.pop("routes")
    stats = {"verified_path": {k: v for k, v in r.items() if k not in ("x", "comm")}}
    log("== path 10b: the deprecated PcclComm shim on the card")
    stats["pcclcomm"] = pcclcomm_path(torch, r)
    del r
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase paths 10a-b: {time.perf_counter() - t:.3f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("== path 10c: what PCCL_VERIFY=1 costs a cold compile_schedule (host time)")
    t = time.perf_counter()
    stats["verify_cost"] = verify_cost(torch)
    log(f"  phase 10c: {time.perf_counter() - t:.3f} s")
    log("== path 10d: the analysis and lint CLIs, the examples and the serve CLI in fresh "
        "processes, on the card by default")
    t = time.perf_counter()
    stats["fresh_processes"] = cli_phase(torch)
    log(f"  phase 10d: {time.perf_counter() - t:.3f} s")
    return counts, routes, stats


PATH13_LIMIT_S = 60  # path 13's time limit
GATE_HITS = 1000       # gate hits timed per kernel


def lint_cases(main: bool = True) -> list:
    from repro_torch.analysis.kernel_lint import main_path_cases, shipped_kernel_cases

    return shipped_kernel_cases() + (main_path_cases() if main else [])


def kernel_lint_static() -> dict:
    """13a: the kernel lint in this process over every shipped case and
    main-path shape: all clean."""
    import contextlib
    import io

    from repro_torch.analysis.kernel_lint import run_shipped

    t = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        failures = run_shipped(verbose=True)
    wall = time.perf_counter() - t
    lines = printed.getvalue().splitlines()
    for line in lines:
        log(f"  {line}")
    check(failures == 0, f"the kernel lint failed {failures} case(s)")
    check(len(lines) == len(lint_cases()) and all(": clean (" in x for x in lines),
          "the kernel lint did not print one clean line per case")
    log(f"  13a: {len(lines)} cases clean in {wall:.3f} s (host)")
    return {"cases": len(lines), "wall_s": wall}


def kernel_lint_geometry(torch) -> dict:
    """13b: every modelled launch of every shipped case and main-path shape
    against the library's geometry export (the launcher's own function):
    grid, threads, dynamic smem equal; static + dynamic smem within the
    card's opt-in limit."""
    from repro_torch.analysis.kernel_lint import DEFAULT_SMEM_BUDGET
    from repro_torch.analysis.launch_probe import geometry_mismatches

    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    check(optin == DEFAULT_SMEM_BUDGET,
          f"the card's opt-in shared memory {optin} B is not the lint's {DEFAULT_SMEM_BUDGET} B")
    sites, most = 0, {}
    for label, fn, args, kwargs in lint_cases():
        modelled, device, problems = geometry_mismatches(fn, args, kwargs, optin)
        check(not problems, f"{label}: launch model and library disagree: {problems}")
        sites += len(modelled)
        for site, dev in zip(modelled, device):
            used = dev["smem"] + dev["static_smem"]
            if used >= most.get(site.name, {}).get("smem_bytes", -1):
                most[site.name] = {"smem_bytes": used, "static_smem": dev["static_smem"],
                                   "threads": dev["threads"], "case": label}
    for name, m in sorted(most.items()):
        log(f"  13b: {name}: at most {m['smem_bytes']} B of shared memory a block "
            f"({m['static_smem']} B static), {m['threads']} threads ({m['case']})")
    log(f"  13b: {sites} launches, grid, threads and dynamic smem equal to the library's; "
        f"opt-in limit {optin} B")
    return {"launches": sites, "optin_bytes": optin, "smem_by_kernel": most}


def kernel_lint_probe(torch) -> dict:
    """13c: every route at ragged shapes, launched into NaN-filled outputs
    between sentinel guard bands: every element written, no guard touched."""
    from repro_torch.analysis.launch_probe import GUARD, materialize, probe_outputs

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    elements = buffers = 0
    for label, fn, args, kwargs in lint_cases(main=False):
        args, kwargs = materialize(torch, args, kwargs, torch.device("cuda"), gen)
        for name, r in probe_outputs(torch, fn, args, kwargs).items():
            check(r["unwritten"] == 0, f"{label}: {r['unwritten']} of {r['elements']} elements "
                                       f"of {name} never written")
            check(r["touched"] == 0, f"{label}: {r['touched']} guard elements of {name} written")
            elements += r["elements"]
            buffers += 1
    log(f"  13c: {buffers} outputs of {len(lint_cases(main=False))} ragged cases, {elements} "
        f"elements, all written; no element of the {GUARD}-element guard bands touched")
    return {"outputs": buffers, "elements": elements}


def kernel_lint_gate(torch) -> dict:
    """13d: each kernel at its main-path shapes, one warm call without
    ``PCCL_VERIFY`` and one with it: the same bytes.  The gate's miss is the
    gated call's host time less the ungated call's (both only enqueue the
    kernel; the miss adds the analysis); a hit is timed over GATE_HITS
    calls of the gate."""
    import os

    from repro_torch.analysis import kernel_lint
    from repro_torch.analysis.launch_probe import materialize
    from repro_torch.kernels.build import verify_launch

    check("PCCL_VERIFY" not in os.environ, "PCCL_VERIFY is set before path 13d")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    out = {}
    for label, fn, args, kwargs in lint_cases()[len(lint_cases(main=False)):]:
        args, kwargs = materialize(torch, args, kwargs, torch.device("cuda"), gen)
        fn(*args, **kwargs)  # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        plain = fn(*args, **kwargs)
        plain_ms = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        kernel_lint.clear_verified_cache()
        os.environ["PCCL_VERIFY"] = "1"
        try:
            t = time.perf_counter()
            gated = fn(*args, **kwargs)
            gated_ms = (time.perf_counter() - t) * 1e3
            [gate] = kernel_lint.gate_counts()
            t = time.perf_counter()
            for _ in range(GATE_HITS):
                verify_launch(gate, fn, args, kwargs)
            hit_us = (time.perf_counter() - t) * 1e6 / GATE_HITS
            counts = kernel_lint.gate_counts()[gate]
        finally:
            del os.environ["PCCL_VERIFY"]
        torch.cuda.synchronize()
        pairs = zip(plain, gated) if isinstance(plain, tuple) else [(plain, gated)]
        check(all(torch.equal(a, b) for a, b in pairs),
              f"{label}: the bytes differ with PCCL_VERIFY=1")
        check(counts == {"misses": 1, "hits": GATE_HITS}, f"{label}: gate counts {counts}")
        out[label] = {"gate": gate, "miss_ms": gated_ms - plain_ms, "call_ms": plain_ms,
                      "hit_us": hit_us}
        log(f"  13d: {label} [{gate}]: same bytes with PCCL_VERIFY=1; host time of the call "
            f"{plain_ms:.3f} ms without the gate, {gated_ms:.3f} ms with its miss; a hit "
            f"{hit_us:.2f} us a launch")
        del args, kwargs, plain, gated
        torch.cuda.empty_cache()
    kernel_lint.clear_verified_cache()
    return out


def path13_phase(torch, smi: str) -> dict:
    """Path 13: the kernel lint on the card (13a-d), within PATH13_LIMIT_S."""
    log("== path 13: the kernel lint: static over every case (13a), launch models against the "
        "libraries' geometry (13b), NaN-filled outputs with guard bands (13c), the "
        "PCCL_VERIFY gate's cost at the main-path shapes (13d)")
    t = time.perf_counter()
    stats = {"static": kernel_lint_static(), "geometry": kernel_lint_geometry(torch),
             "probe": kernel_lint_probe(torch), "gate": kernel_lint_gate(torch)}
    stats["wall_s"] = time.perf_counter() - t
    log(f"  phase path 13: {stats['wall_s']:.3f} s on {smi}")
    check(stats["wall_s"] <= PATH13_LIMIT_S,
          f"path 13 took {stats['wall_s']:.1f} s, over its {PATH13_LIMIT_S} s")
    return stats


# ---------------------------------------------------------------------- main


PATH11_CELLS = (("zamba2-2.7b", "train_4k", "single"), ("olmoe-1b-7b", "train_4k", "single"),
                ("zamba2-2.7b", "train_4k", "multi"),
                ("deepseek-v2-lite-16b", "prefill_32k", "single"),
                ("deepseek-v2-lite-16b", "train_4k", "single"),
                ("xlstm-1.3b", "train_4k", "single"))
# the same cells counted on the CPU with torch 2.13 (python -m
# repro_torch.launch.dryrun --mesh single|multi): a rank's FLOPs, every
# collective's bytes, the temporaries and PCCL's speedup, which the card's
# torch must come within PATH11_REL of
PATH11_TORCH213 = {
    "zamba2-2.7b__train_4k__single": {
        "flops": 1.01779715653632e14, "speedup": 2.992489, "temp_size_in_bytes": 53753422964,
        "all-gather": 328095764460, "all-reduce": 88779648721, "all-to-all": 47643653160,
        "reduce-scatter": 743768777880},
    "olmoe-1b-7b__train_4k__single": {
        "flops": 5.3177519439872e13, "speedup": 1.053743, "temp_size_in_bytes": 59886842128,
        "all-gather": 180645281280, "all-reduce": 16674924493, "all-to-all": 190709760,
        "reduce-scatter": 15023808000},
    "zamba2-2.7b__train_4k__multi": {
        "flops": 1.02666024124416e14, "speedup": 2.414182, "temp_size_in_bytes": 32171804020,
        "all-gather": 472798654760, "all-reduce": 196646419273, "all-to-all": 14824851200,
        "reduce-scatter": 366621149840},
    "deepseek-v2-lite-16b__prefill_32k__single": {
        "flops": 5.8235513995264e13, "speedup": 1.109473, "temp_size_in_bytes": 90129550448,
        "all-gather": 52037736960, "all-reduce": 97517611200, "all-to-all": 562560000,
        "reduce-scatter": 68074321920},
    "deepseek-v2-lite-16b__train_4k__single": {
        "flops": 1.06765186236416e14, "speedup": 1.124727, "temp_size_in_bytes": 905463530512,
        "all-gather": 694082695680, "all-reduce": 179820826615, "all-to-all": 3637877760,
        "reduce-scatter": 695430904320},
    "xlstm-1.3b__train_4k__single": {
        "flops": 1.09163592548352e14, "speedup": 3.820779, "temp_size_in_bytes": 65472712280,
        "all-gather": 220047463680, "all-reduce": 50221699842, "all-to-all": 23781703680,
        "reduce-scatter": 92141806080},
}
PATH11_REL = 0.05
# the quantities held to PATH11_REL: all but those PERF.md §6 lists as not
# met (printed beside theirs): Zamba2's 512-rank all-gather, where a
# product's backward views a gradient split along the sequence as rows
# (torch 2.13 keeps a strided split, which 2.11 cannot place: the port
# gathers it)
PATH11_NOT_MET = {("zamba2-2.7b__train_4k__multi", "all-gather")}
PATH11_HELD = {(cell, k) for cell, record in PATH11_TORCH213.items() for k in record
               if (cell, k) not in PATH11_NOT_MET}
PATH11_TIMEOUT = 600   # seconds a background count may take
ROOFLINE_CODE = """
import json
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import one_rank_roofline
cfg = get_config("zamba2-2.7b")
print("ROOFLINE " + json.dumps({
    "prefill": one_rank_roofline(cfg, "prefill", %d, %d, max_len=%d),
    "train": one_rank_roofline(cfg, "train", %d, %d, microbatches=%d)}))
"""


def start_background(name: str, cmd) -> dict:
    """``python cmd`` in a fresh process from the checkout's root, running
    beside what the script does next (:func:`finish_background`)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("PCCL_VERIFY", None)
    log(f"  started in the background: {name}: python {' '.join(cmd)[:120]}")
    # below the smoke's own priority: the host-bound paths it runs beside come first
    proc = subprocess.Popen([sys.executable, *cmd], cwd=SRC.parent, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            preexec_fn=lambda: os.nice(10))
    return {"name": name, "cmd": cmd, "proc": proc, "t0": time.perf_counter()}


def finish_background(job, quiet: bool = False) -> list:
    """Wait for a background process; its lines, all printed (``quiet``:
    the last 20).  Fails unless it exits 0."""
    try:
        out, err = job["proc"].communicate(timeout=PATH11_TIMEOUT)
    except subprocess.TimeoutExpired:
        job["proc"].kill()
        job["proc"].communicate()
        raise
    wall = time.perf_counter() - job["t0"]
    lines = out.strip().splitlines()
    log(f"  {job['name']}: exit {job['proc'].returncode} after {wall:.1f} s")
    for line in lines[-20:] if quiet else lines:
        log(f"    | {line[:400]}")
    check(job["proc"].returncode == 0, f"{job['name']} failed: {err[-3000:]}")
    return lines


def path11a(torch, cfg, reference, reset_counts, read_counts, device=None) -> tuple:
    """Path 2 again under a one-rank NCCL mesh with the default rules:
    the same tokens and every step's logits bit for bit, K3 and K4 as
    often and on the same route, and the shard sites a prefill reaches.
    (On the CPU, for a rehearsal, the group is gloo's.)"""
    import os
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.sharding import default_rules, use_partitioning

    device = device or torch.device("cuda")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", rank=0, world_size=1)
    try:
        mesh = init_device_mesh(device.type, (1, 1), mesh_dim_names=("data", "model"))
        log(f"  mesh: {mesh}")
        reset_counts()
        with use_partitioning(mesh, default_rules()):
            served = serve_path(torch, cfg, device, SERVE_PROMPTS, SERVE_NEW_TOKENS,
                                keep_logits=True)
        counts = read_counts()
        routes = {"flash": LAUNCHES.by_route("flash"), "ssd": LAUNCHES.by_route("ssd")}
        log(f"  kernel launches {counts}")
        stats = check_serve(torch, served, cfg)
        sites = served["seen"]["sites_at_first_decode"]
        log(f"  shard sites per prefill: {sites} (the CPU count: {ZAMBA2_SHARD_SITES_PER_PREFILL})")
        check(sites == ZAMBA2_SHARD_SITES_PER_PREFILL,
              f"a prefill under the mesh reached {sites} shard sites, "
              f"not {ZAMBA2_SHARD_SITES_PER_PREFILL}")
        tokens = [list(q.generated) for q in served["requests"]]
        logits = [x.cpu() for x in served["seen"]["logits"]]
        same_logits = (len(logits) == len(reference["logits"])
                       and all(torch.equal(a, b) for a, b in zip(logits, reference["logits"])))
        log(f"  tokens as path 2's: {tokens == reference['tokens']}; {len(logits)} steps' logits "
            f"bit for bit as path 2's: {same_logits}")
        check(tokens == reference["tokens"], "the tokens under the mesh differ from path 2's")
        check(same_logits, "a step's logits under the mesh differ from path 2's")
        del served
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    stats.update(shard_sites_per_prefill=sites, logit_steps=len(logits))
    return counts, routes, stats


PATH11_OUT = SRC.parent / "results" / "torch_dryrun"


def start_path11_jobs() -> list:
    """Path 11's host-only processes: the dry run's cells (11c), the reduced
    sweep (11d) and the one-rank rooflines (11b, last), started early so
    that they count beside the card's paths."""
    jobs = []
    try:
        for arch, shape, mesh in PATH11_CELLS:
            jobs.append(start_background(f"11c {arch} x {shape} x {mesh}", [
                "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
                "--mesh", mesh, "--force", "--out", str(PATH11_OUT)]))
        jobs.append(start_background("11d the reduced sweep",
                                     ["-m", "repro_torch.launch.dryrun", "--reduced"]))
        prompt = max(SERVE_PROMPTS)
        code = ROOFLINE_CODE % (len(SERVE_PROMPTS), prompt, prompt + SERVE_NEW_TOKENS,
                                TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICROBATCHES)
        jobs.append(start_background("11b one-rank rooflines", ["-c", code]))
    except BaseException:
        stop_background(jobs)
        raise
    return jobs


def stop_background(jobs) -> None:
    for job in jobs:  # every process the smoke started ends with it
        if job["proc"].poll() is None:
            job["proc"].kill()
            job["proc"].communicate()


def path11_phase(torch, zamba2, path2_run, serve_stats, train_stats, reset_counts, read_counts,
                 device=None, jobs=None):
    """Path 11: the dry run's counts (11c) and the one-rank rooflines (11b)
    in fresh processes (``jobs``, :func:`start_path11_jobs`'s, or started
    here) beside 11a, Zamba2 served under a one-rank mesh."""
    out_dir = PATH11_OUT
    jobs = jobs if jobs is not None else start_path11_jobs()
    reduced = jobs[len(PATH11_CELLS)]
    try:
        log("== main path 11a: serve zamba2-2.7b under a one-rank NCCL mesh "
            "(use_partitioning, default_rules), path 2's requests")
        t = time.perf_counter()
        counts, routes, stats = path11a(torch, zamba2, path2_run, reset_counts, read_counts,
                                        device)
        log(f"  phase main path 11a: {time.perf_counter() - t:.3f} s")

        log("== main path 11b: the port's one-rank roofline against the card")
        lines = finish_background(jobs[-1])
        roof = json.loads(next(x for x in lines if x.startswith("ROOFLINE "))[len("ROOFLINE "):])
        measured = {"prefill": serve_stats["warm_prefill_ms"],
                    "train": train_stats["warm_ms_per_step"]}
        stats["roofline"] = {}
        for kind, ms in measured.items():
            r = roof[kind]
            comp, mem = 1e3 * r["compute_s"], 1e3 * r["memory_s"]
            log(f"  {kind} (path {'2 warm prefill' if kind == 'prefill' else '7 warm step'}): "
                f"measured {ms:.1f} ms; roofline compute {comp:.2f} ms ({r['flops']:.4g} FLOPs), "
                f"memory {mem:.2f} ms ({r['hbm_bytes']:.4g} B, an estimate); measured / roofline: "
                f"compute {ms / comp:.2f}, memory {ms / mem:.2f}")
            stats["roofline"][kind] = {**r, "measured_ms": ms, "measured_over_compute": ms / comp,
                                       "measured_over_memory": ms / mem}
        held = train_stats.get("warm_step_memory")
        if held is not None:
            r = roof["train"]
            step_peak = held["peak"] - held["allocated_before"]
            memory = {"predicted_arguments": r["argument_size_in_bytes"],
                      "measured_arguments": held["arguments"],
                      "predicted_temp": r["temp_size_in_bytes"], "measured_temp": step_peak}
            memory["arguments_ratio"] = memory["predicted_arguments"] / memory["measured_arguments"]
            memory["temp_ratio"] = memory["predicted_temp"] / step_peak
            log(f"  train memory (path 7's warm step; the count runs the plain path, fp32 "
                f"parameters and moments): arguments predicted {r['argument_size_in_bytes']:.6g} B, "
                f"the step's own {held['arguments']} B (ratio {memory['arguments_ratio']:.4f}); "
                f"temporaries predicted {r['temp_size_in_bytes']:.6g} B, measured peak less the "
                f"bytes allocated before the step {step_peak} B (ratio {memory['temp_ratio']:.4f})")
            stats["roofline"]["train"]["memory"] = memory
        card = (f"{serve_stats['peak_gib'] * 2**30:.6g} B" if "peak_gib" in serve_stats
                else "not measured")
        log(f"  prefill memory (path 2, not held: the count runs the plain path, which writes "
            f"the attention scores K3 never does): predicted peak {roof['prefill']['peak_bytes']:.6g} "
            f"B, arguments {roof['prefill']['argument_size_in_bytes']:.6g} B; the card's peak "
            f"over path 2's generate {card}")

        log("== main path 11c: python -m repro_torch.launch.dryrun, 256 and 512 ranks, "
            "fresh processes")
        from repro_torch.configs import ARCH_IDS
        from repro_torch.launch.dryrun import MEMORY_FIELDS
        from repro_torch.sharding import RULES_INSTALLED, rules

        stats["torch"] = torch.__version__
        stats["rules_installed"] = RULES_INSTALLED
        stats["einsum_on_shards"] = not rules.flattens_splits()
        log(f"  torch {torch.__version__}: the port's DTensor rules installed for "
            f"{RULES_INSTALLED}; MLA's and the SSD's products on each rank's shards: "
            f"{stats['einsum_on_shards']} (torch's view rule "
            f"{'flattens' if rules.flattens_splits() else 'refuses to flatten'} two splits)")
        stats["dryrun"] = {}
        for job, (arch, shape, mesh) in zip(jobs, PATH11_CELLS):
            lines = finish_background(job)
            check(any(x.endswith("device memory allocated: 0 bytes") for x in lines),
                  f"the dry run of {arch} x {shape} x {mesh} allocated device memory")
            rec = json.loads((out_dir / f"{arch}__{shape}__{mesh}.json").read_text())
            check(rec["status"] == "ok", f"{arch} x {shape} x {mesh}: {rec.get('error')}")
            pricing = rec["pccl_pricing"]
            mem = rec["memory_per_rank"]
            log(f"  {arch} x {shape} x {mesh} ({rec['chips']} ranks): per rank "
                f"{rec['per_rank']['flops']:.4g} FLOPs, {rec['per_rank']['hbm_bytes']:.4g} HBM B, "
                f"collective B by op {json.dumps(rec['collectives']['bytes_by_op'])}; memory "
                + ", ".join(f"{k} {mem[k]:.6g}" for k in MEMORY_FIELDS)
                + f", total {mem['total']:.4g} B (fits 80 GB: {mem['fits']}); PCCL speedup "
                f"{pricing['speedup']:.4f}; fallbacks {rec['fallbacks']['count']} "
                f"{json.dumps(rec['fallbacks']['ops'])}")
            check(rec["fallbacks"]["count"] == 0,
                  f"{arch} x {shape} x {mesh}: {rec['fallbacks']['count']} ops fell back "
                  f"({rec['fallbacks']['ops']})")
            stats["dryrun"][f"{arch}__{shape}__{mesh}"] = {
                "per_rank": rec["per_rank"], "bytes_by_op": rec["collectives"]["bytes_by_op"],
                "count_by_op": rec["collectives"]["count_by_op"],
                "memory_per_rank": rec["memory_per_rank"], "speedup": pricing["speedup"],
                "pccl_comm_s": pricing["pccl_comm_s"], "fixed_comm_s": pricing["fixed_comm_s"],
                "count_s": rec["count_s"], "depth": rec["depth"],
                "fallbacks": rec["fallbacks"]["count"], "fallback_ops": rec["fallbacks"]["ops"]}
            record = PATH11_TORCH213[f"{arch}__{shape}__{mesh}"]
            here = {"flops": rec["per_rank"]["flops"], "speedup": pricing["speedup"],
                    "temp_size_in_bytes": mem["temp_size_in_bytes"],
                    **rec["collectives"]["bytes_by_op"]}
            ratios = {k: here.get(k, 0.0) / v for k, v in record.items()}
            log(f"    against torch 2.13's count: " + ", ".join(
                f"{k} {here.get(k, 0.0):.6g} / {v:.6g} = {ratios[k]:.4f}"
                + ("" if (f"{arch}__{shape}__{mesh}", k) in PATH11_HELD else " (not held)")
                for k, v in record.items()))
            stats["dryrun"][f"{arch}__{shape}__{mesh}"]["over_torch213"] = ratios
            held = {k: r for k, r in ratios.items() if (f"{arch}__{shape}__{mesh}", k) in PATH11_HELD}
            check(all(abs(r - 1) <= PATH11_REL for r in held.values()),
                  f"{arch} x {shape} x {mesh} on torch {torch.__version__}: {held} of the "
                  f"torch 2.13 counts, not within {PATH11_REL:.0%}")

        log("== main path 11d: python -m repro_torch.launch.dryrun --reduced, every architecture's "
            "reduced config x train, prefill and decode on a 2 x 2 mesh")
        lines = finish_background(reduced, quiet=True)
        cells = [json.loads(x[len("REDUCED "):]) for x in lines if x.startswith("REDUCED ")]
        for rec in cells:
            log(f"  {rec['arch']} x {rec['kind']}: {rec['status']}, fallbacks "
                f"{rec.get('fallbacks')} {json.dumps(rec.get('fallback_ops', {}))}, FLOPs a rank "
                f"{rec.get('flops')}" + (f", {rec['error'][:300]}" if "error" in rec else ""))
        check(len(cells) == 3 * len(ARCH_IDS), f"11d counted {len(cells)} cells")
        bad = [(r["arch"], r["kind"]) for r in cells if r["status"] != "ok" or r["fallbacks"]]
        check(not bad, f"11d: cells that failed or fell back on torch {torch.__version__}: {bad}")
        stats["reduced_sweep"] = {f"{r['arch']}__{r['kind']}": {
            k: r.get(k) for k in ("status", "flops", "fallbacks", "fallback_ops", "count_s")}
            for r in cells}
    finally:
        stop_background(jobs)
    return counts, routes, stats


# -------------------------------- path 12: one process per rank, gloo

P12_RANKS = 4
P12_REPS = 3            # timed calls of each collective, after the counted one
P12_MESH = (2, 2)       # ("data", "model")
P12_BATCH, P12_SEQ = 4, 448
P12_STEPS, P12_CKPT_EVERY, P12_FAIL_AT = 3, 2, 2
# relative: the sharded step against the one-process Trainer, bf16
# activations whose tensor-parallel partial sums meet in bf16 in another
# order (the CPU test holds fp32 at 1e-4 absolute)
P12_LOSS_TOL = 1e-4
P12_THREADS = 2         # intra-op threads a rank: 4 ranks beside this process on 8 cores
P12_TIMEOUT = 420       # seconds a spawn may take before every rank is killed
P12_COLLECTIVES = ("all_reduce", "reduce_scatter", "all_gather", "all_to_all")
P12D_BATCH, P12D_PROMPT, P12D_STEPS = 4, 228, 4  # 12d: rows, prompt tokens, greedy steps
# |a - b| <= tol + tol * |b|, as CONTINUATION_TOL holds logits; 12d runs
# fp32 activations: in bf16 (an ulp is 3e-2 at 4) the tensor-parallel
# partial sums and the split softmax, met in another order, reached 2.5e-2
P12D_LOGITS_TOL = 2e-2


def path12_cases(tokens=TOKENS, d_model=D_MODEL, d_ff=D_FF) -> list:
    """12a's cases: path 1's collectives at its per-rank shapes on
    ``P12_RANKS`` processes, in fp32 (the bit gate), at the algorithms the
    planner picks at those sizes on ``H100_DGX``; the all-reduce the planner
    gives ``ring_ef8`` under its error bound; fused mm+RS in bf16 (K1 on
    wgmma) and fp32 (K1 on fma) on the ring, fused AR+RMSNorm in bf16."""
    from repro_torch.core import cost_model as cm

    base = dict(n=P12_RANKS, hw="H100_DGX")
    cases = [dict(base, path="comm", collective=c, seed=SEED + 20 + i,
                  local=(tokens // P12_RANKS if c == "all_gather" else tokens, d_model))
             for i, c in enumerate(P12_COLLECTIVES)]
    cases.append(dict(base, path="comm", collective="all_reduce", local=(tokens, d_model),
                      seed=SEED + 24, rel_error_tol=cm.compressed_ef_error_bound(P12_RANKS)))
    k = d_ff // TP
    cases += [dict(base, path="fused_mm_rs", local=(tokens, k), side=(k, d_model), dtype=dt,
                   algorithm="ring", seed=SEED + 25 + j, reps=P12_REPS if dt == "bfloat16" else 0)
              for j, dt in enumerate(("bfloat16", "float32"))]
    cases.append(dict(base, path="fused_ar_rms", local=(tokens, d_model), side=(d_model,),
                      dtype="bfloat16", seed=SEED + 27))
    return cases


def stacked_case(torch, case, device):
    """What the rank-stacked engine gives for ``case`` on this process's
    device: the communicator over ``"x"`` at the case's algorithm."""
    from repro_torch import PcclSession
    from repro_torch.comm import fusion
    from repro_torch.core import cost_model as cm
    from repro_torch.launch import procs

    dtype = getattr(torch, case.get("dtype", "float32"))
    x = torch.as_tensor(procs.stacked_input(case), device=device).to(dtype)
    comm = PcclSession(getattr(cm, case["hw"]), device=device).communicator(
        "x", case["n"], algorithm=case.get("algorithm", "auto"),
        rel_error_tol=case.get("rel_error_tol"))
    if case["path"] == "fused_mm_rs":
        w = torch.as_tensor(procs.side_input(case), device=device).to(dtype)
        return fusion.fused_matmul_reduce_scatter(comm, x, w)
    if case["path"] == "fused_ar_rms":
        gamma = torch.as_tensor(procs.side_input(case), device=device).to(dtype)
        return fusion.fused_all_reduce_rmsnorm(comm, x, gamma)
    return getattr(comm, case["collective"])(x)


def path12a(torch, store_dir, device, cases) -> dict:
    """Path 1's collectives, ring_ef8 and both seams on ``P12_RANKS``
    processes over gloo, each rank's fp32 result held bit for bit against
    its row of the rank-stacked engine on this device (SHA-256 of the
    bytes), the seams against their unfused compositions; the route and
    the staged bytes of every rank; K1's and K2's launches per process."""
    from repro_torch.launch import procs

    t = time.perf_counter()
    ranks = procs.spawn(procs.collectives_program, P12_RANKS,
                        (cases, device.type, P12_REPS, True), store_dir=store_dir,
                        timeout_s=P12_TIMEOUT, threads=P12_THREADS)
    log(f"  12a: {P12_RANKS} processes ran {len(cases)} cases in {time.perf_counter() - t:.1f} s")
    staged_route = "gloo-staged" if device.type == "cuda" else "gloo"
    # each rank's launches in the counted call of each case (not the timed
    # calls, nor the unfused composition the seams are held against)
    launches = [{k: {route: sum(c["launches"][k][route] for c in r["cases"])
                     for route in r["cases"][0]["launches"][k]}
                 for k in r["cases"][0]["launches"]} for r in ranks]
    stats = {"cases": [], "staged_bytes": [r["staged_bytes"] for r in ranks],
             "route_rounds": [r["route_rounds"] for r in ranks], "launches": launches}
    for i, case in enumerate(cases):
        outs = [r["cases"][i]["out"] for r in ranks]
        algorithm = ranks[0]["cases"][i]["algorithm"]
        name = case.get("collective", case["path"])
        stacked = stacked_case(torch, case, device)
        rows = [procs.digest_of(stacked[r]) for r in range(P12_RANKS)]
        del stacked
        if case["path"].startswith("fused"):
            check(all(f == u for f, u in outs), f"12a {name} [{case.get('dtype')}]: a rank's fused "
                  "result differs from its unfused composition")
            outs = [f for f, _ in outs]
        same = outs == rows
        ms = [r["cases"][i].get("ms") for r in ranks]
        log(f"  12a {name} [{case.get('dtype', 'float32')}] ({algorithm}), local "
            f"{tuple(case['local'])}: every rank bit for bit as its rank-stacked row: {same}; "
            f"ms per call by rank {[None if m is None else round(m, 3) for m in ms]}")
        check(same, f"12a {name} ({algorithm}): a rank's result differs from the rank-stacked engine")
        stats["cases"].append({"name": name, "dtype": case.get("dtype", "float32"),
                               "local": list(case["local"]), "algorithm": algorithm, "ms": ms})
    ef8 = next(st["algorithm"] for st, case in zip(stats["cases"], cases)
               if case.get("rel_error_tol"))
    check(ef8 == "ring_ef8", f"auto under the ring_ef8 tolerance picked {ef8}")
    for r, rank in enumerate(ranks):
        check(set(rank["route_rounds"]) == {staged_route},
              f"12a rank {r} took routes {rank['route_rounds']}, not only {staged_route}")
        check((rank["staged_bytes"] > 0) == (device.type == "cuda"),
              f"12a rank {r} staged {rank['staged_bytes']} bytes through the host")
    log(f"  12a routes by rank: {stats['route_rounds']}; bytes staged through the host by rank: "
        f"{stats['staged_bytes']}")
    if device.type == "cuda":
        # one K1 a tile of the stream program: the bf16 seam on wgmma, the
        # fp32 one on fma; one K2 at the all-reduce's arrival
        want = {"wgmma": P12_RANKS, "fma": P12_RANKS}
        for r, counts in enumerate(launches):
            check(counts["matmul"] == want,
                  f"12a rank {r} launched K1 {counts['matmul']}, not {want}")
            check(counts["rmsnorm"] == {"triton": 1}, f"12a rank {r} launched K2 {counts['rmsnorm']}")
        log(f"  12a K1 and K2 launches in each process: matmul {want}, rmsnorm "
            f"{launches[0]['rmsnorm']}")
    return stats


def nccl_refusal(store_dir) -> str:
    """NCCL with two ranks on this one card: the text of its refusal (a
    gate that it is refused as recorded, not a route of the port)."""
    from repro_torch.launch import procs

    case = dict(n=2, seed=SEED, local=(8,), path="comm", collective="all_reduce",
                backend="native", hw="H100_DGX")
    try:
        procs.spawn(procs.collectives_program, 2, ([case], "cuda"), store_dir=store_dir,
                    backend="nccl", timeout_s=180)
    except RuntimeError as e:
        lines = [x for x in str(e).splitlines() if "Duplicate GPU" in x]
        check(bool(lines), f"two NCCL ranks on one card failed otherwise: {str(e)[-600:]}")
        return lines[0].strip()
    check(False, "two NCCL ranks on one card ran: the path's premise no longer holds")


def path12b(torch, store_dir, cfg, device) -> dict:
    """Whisper-small through the Trainer on a ``P12_MESH`` mesh of
    ``P12_RANKS`` processes, a checkpoint, an injected failure and the
    restart (12b), then data slice 1 "fails", the mesh shrinks and the
    state re-shards onto the survivors, which take one more step (12c);
    beside it, the one-process Trainer on the same batches."""
    from repro_torch.data import DataConfig
    from repro_torch.launch import procs
    from repro_torch.sharding import default_rules
    from repro_torch.train import OptimizerConfig, Trainer, TrainerConfig

    data = DataConfig(global_batch=P12_BATCH, seq_len=P12_SEQ)
    tc = TrainerConfig(total_steps=P12_STEPS, ckpt_every=P12_CKPT_EVERY, log_every=100)
    # TP over "model", DP over "data"; parameters whole over "data" (no
    # FSDP): the gradient all-reduce over "data", TP's collectives over "model"
    rules = default_rules(fsdp=False)
    t = time.perf_counter()
    ranks = procs.spawn(procs.trainer_program, P12_RANKS, (cfg, data, OptimizerConfig(), tc),
                        dict(mesh_shape=P12_MESH, rules=rules, device=device.type,
                             ckpt_dir=str(Path(store_dir) / "ckpt"), fail_at=(P12_FAIL_AT,),
                             shrink=True),
                        store_dir=store_dir, timeout_s=P12_TIMEOUT, threads=P12_THREADS)
    log(f"  12b-c: {P12_RANKS} processes in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    alone = Trainer(cfg, data, OptimizerConfig(), tc, device=device).run()
    one = [h["loss"] for h in alone["history"]]
    del alone
    gc.collect()
    log(f"  12b: the one-process Trainer on the same batches in {time.perf_counter() - t:.1f} s: "
        f"losses {[round(x, 6) for x in one]}")
    per_step = train_launches(cfg, 1)["flash"]
    stats = {"ranks": [], "one_process_losses": one}
    for r, rank in enumerate(ranks):
        steps, losses = rank["steps"], rank["losses"]
        by_step = dict(zip(steps, losses))
        err = max(abs(by_step[s] - one[s]) / abs(one[s]) for s in range(P12_STEPS))
        warm = rank["step_time_s"][1:]
        ms = 1e3 * statistics.median(warm)
        peak = rank["peak_bytes"]
        log(f"  12b rank {r}: steps {steps}, resumed from {rank['resumed_from']}, checkpoints "
            f"{rank['ckpt_steps']}; losses {[round(x, 6) for x in losses]}, max |Δ|/|loss| "
            f"against one process {err:.3e} (tol {P12_LOSS_TOL}); warm ms a step {ms:.1f} (steps "
            f"{[round(1e3 * x, 1) for x in rank['step_time_s']]}); peak "
            f"{'n/a' if peak is None else f'{peak / 2**30:.2f} GiB'}; K3 {rank['launches']['flash']}; "
            f"staged {rank['staged_bytes']} B in {rank['route_rounds']}")
        check(steps == list(range(P12_STEPS)), f"12b rank {r} ran steps {steps}")
        check(rank["resumed_from"] == [P12_CKPT_EVERY],
              f"12b rank {r} resumed from {rank['resumed_from']}, not the step-{P12_CKPT_EVERY} "
              "checkpoint")
        check(err <= P12_LOSS_TOL,
              f"12b rank {r}: loss {err:.3e} (relative) from the one-process Trainer's")
        if device.type == "cuda":
            check(rank["launches"]["flash"] == {"wgmma": per_step * P12_STEPS, "fma": 0},
                  f"12b rank {r} launched K3 {rank['launches']['flash']}, not "
                  f"{per_step * P12_STEPS} on wgmma")
        stats["ranks"].append({"losses": losses, "steps": steps, "warm_ms_per_step": ms,
                               "step_ms": [1e3 * x for x in rank["step_time_s"]],
                               "peak_bytes": peak, "staged_bytes": rank["staged_bytes"],
                               "route_rounds": rank["route_rounds"],
                               "flash": rank["launches"]["flash"], "wall_s": rank["wall_s"],
                               "max_rel_loss_err": err})
    survivors = [r for r in ranks if not r["failed"]]
    log(f"  12c: the mesh shrank to {ranks[0]['shrunk_shape']}; survivors {len(survivors)}; "
        f"every value re-sharded bit for bit: {[r['reshard_exact'] for r in survivors]}; their "
        f"step's loss {[r['survivor_loss'] for r in survivors]}")
    check(all(tuple(r["shrunk_shape"]) == (P12_MESH[0] - 1, P12_MESH[1]) for r in ranks),
          "12c: the shrunk mesh has the wrong shape")
    check(len(survivors) == P12_RANKS - P12_MESH[1], "12c: the wrong ranks survived")
    check(all(r["reshard_exact"] for r in survivors), "12c: a re-sharded value changed")
    check(len({r["survivor_loss"] for r in survivors}) == 1
          and math.isfinite(survivors[0]["survivor_loss"]), "12c: the survivors' step disagrees")
    stats["shrink"] = {"shape": list(ranks[0]["shrunk_shape"]),
                       "survivor_loss": survivors[0]["survivor_loss"]}
    return stats


def path12d(torch, store_dir, cfg, device) -> dict:
    """Whisper-small with 12b's weights (the Trainer's seed) served on the
    ``P12_MESH`` mesh of ``P12_RANKS`` processes through the model's own
    prefill and decode steps, against one process on the same device: the
    same greedy tokens, every step's logits within ``P12D_LOGITS_TOL``."""
    from repro_torch.launch import procs
    from repro_torch.sharding import default_rules
    from repro_torch.train import TrainerConfig

    kw = dict(batch=P12D_BATCH, prompt=P12D_PROMPT, steps=P12D_STEPS,
              max_len=P12D_PROMPT + P12D_STEPS, seed=TrainerConfig().seed)
    cfg = replace(cfg, dtype="float32")  # K3 on its fp32 route
    t = time.perf_counter()
    ranks = procs.spawn(procs.serve_program, P12_RANKS, (cfg,),
                        dict(kw, mesh_shape=P12_MESH, rules=default_rules(fsdp=False),
                             device=device.type),
                        store_dir=store_dir, timeout_s=P12_TIMEOUT, threads=P12_THREADS)
    log(f"  12d: {P12_RANKS} processes in {time.perf_counter() - t:.1f} s")
    one = procs.serve_program(cfg, **kw, device=device.type)
    log(f"  12d: one process: tokens {one['tokens']}, {one['wall_s']:.2f} s, K3 "
        f"{one['launches'].get('flash')}")
    stats = {"one_process_wall_s": one["wall_s"], "ranks": []}
    for r, rank in enumerate(ranks):
        err = max(float(abs(a - b).max()) for a, b in zip(rank["logits"], one["logits"]))
        excess = max(float((abs(a - b) - P12D_LOGITS_TOL * (1 + abs(b))).max())
                     for a, b in zip(rank["logits"], one["logits"]))
        log(f"  12d rank {r}: tokens {rank['tokens']}; max |logit - one process's| {err:.3e}, "
            f"within tol + tol * |logit| (tol {P12D_LOGITS_TOL}): {excess <= 0}; prefill and "
            f"{P12D_STEPS} steps in {rank['wall_s']:.2f} s; K3 {rank['launches'].get('flash')}")
        check(rank["tokens"] == one["tokens"],
              f"12d rank {r}: greedy tokens {rank['tokens']} differ from one process's")
        check(excess <= 0, f"12d rank {r}: logits {err:.3e} from one process's")
        stats["ranks"].append({"max_abs_logit_err": err, "wall_s": rank["wall_s"],
                               "flash": rank["launches"].get("flash")})
    stats["tokens"] = one["tokens"]
    return stats


def path12_phase(torch, cfg, device=None, cases=None):
    """Path 12: 12a, the NCCL probe, 12b and 12c; returns (K1, K2 and K3
    launches summed over the processes, the stats)."""
    device = device or torch.device("cuda")
    cases = cases if cases is not None else path12_cases()
    stats = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p12_") as store:
        log(f"== main path 12a: path 1's collectives, ring_ef8 and both seams on {P12_RANKS} "
            f"processes over gloo (one per rank; CUDA payloads staged through pinned host memory)")
        t = time.perf_counter()
        stats["12a"] = path12a(torch, str(Path(store) / "a"), device, cases)
        log(f"  phase main path 12a: {time.perf_counter() - t:.3f} s")
        if device.type == "cuda":
            t = time.perf_counter()
            stats["nccl_refusal"] = nccl_refusal(str(Path(store) / "nccl"))
            log(f"  NCCL, two ranks on this card: {stats['nccl_refusal']} "
                f"({time.perf_counter() - t:.1f} s)")
        log(f"== main path 12b-c: train {cfg.name} at published widths and depth through the "
            f"Trainer on a ('data', 'model') = {P12_MESH} mesh of {P12_RANKS} processes, a failure "
            f"at step {P12_FAIL_AT}, the restart; then data slice 1 fails, shrink_mesh, "
            "reshard_tree and one step on the survivors")
        t = time.perf_counter()
        stats["12bc"] = path12b(torch, str(Path(store) / "b"), cfg, device)
        log(f"  phase main path 12b-c: {time.perf_counter() - t:.3f} s")
        log(f"== main path 12d: serve {cfg.name} on the {P12_MESH} mesh of {P12_RANKS} processes "
            f"(12b's weights; the model's prefill and {P12D_STEPS} decode steps), against one "
            "process")
        t = time.perf_counter()
        stats["12d"] = path12d(torch, str(Path(store) / "d"), cfg, device)
        log(f"  phase main path 12d: {time.perf_counter() - t:.3f} s")
    launches = {
        "matmul": {k: sum(r["matmul"][k] for r in stats["12a"]["launches"])
                   for k in ("wgmma", "fma")},
        "rmsnorm": sum(r["rmsnorm"]["triton"] for r in stats["12a"]["launches"]),
        "flash": {k: sum(r["flash"][k] for r in stats["12bc"]["ranks"])
                  + sum(r["flash"][k] for r in stats["12d"]["ranks"]) for k in ("wgmma", "fma")},
    }
    return launches, stats


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
    from repro_torch.kernels.flash import kernel as k3
    from repro_torch.kernels.matmul import kernel as k1
    from repro_torch.kernels.rmsnorm import rmsnorm_triton
    from repro_torch.kernels.ssd import kernel as k4

    def timed_build(source):
        t = time.perf_counter()
        build.build(source)
        return time.perf_counter() - t

    t = time.perf_counter()
    sources = (*k1.SOURCES.values(), *k3.SOURCES.values(), *k4.SOURCES.values())
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        took = list(pool.map(timed_build, sources))
    for source, sec in zip(sources, took):
        build.load(source)
        log(f"build: nvcc {source.name} for sm_90a: {sec:.2f} s")
    log(f"build: all CUDA sources: {time.perf_counter() - t:.2f} s")
    for source in (k1.SOURCE_SM90, k3.SOURCE_SM90, k4.SOURCE_SM90, k4.SOURCE_SM90_TILED):
        entries = ptxas_summary(source)
        check(len(entries) > 0, f"ptxas reported no tensor-core kernel in {source.name}")
        for e in entries:
            log(f"ptxas {source.name} {e['entry']}: {e.get('registers')} registers, "
                f"{e.get('static_smem')} bytes static smem, spill stores "
                f"{e.get('spill_stores')} B, spill loads {e.get('spill_loads')} B")
            check(e.get("spill_stores") == 0 and e.get("spill_loads") == 0,
                  f"{e['entry']} spills registers")
        hgmma = sass_count(source, "HGMMA")
        log(f"sass {source.name}: {hgmma} HGMMA instructions")
        check(hgmma > 0, f"{source.name} holds no HGMMA: not on the tensor cores")
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
    log(f"  phase kernels K1, K2: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    for name in ("bfloat16", "float32"):
        kernels[name].update(flash_kernel_phase(torch, gen, name))
        torch.cuda.empty_cache()
        kernels[name].update(ssd_kernel_phase(torch, gen, name))
        torch.cuda.empty_cache()
    log(f"  phase kernels K3, K4: {time.perf_counter() - t:.3f} s")

    path13_stats = path13_phase(torch, smi)
    torch.cuda.empty_cache()

    reset_counts, read_counts = LAUNCHES.reset, LAUNCHES.totals

    log(f"== main path 1: Mistral-Large-123B widths, TP={TP} rank-stacked, {TOKENS} tokens/rank")
    reset_counts()
    t = time.perf_counter()
    results = main_path(torch, gen, torch.device("cuda"))
    path1 = read_counts()
    routes1 = LAUNCHES.by_route("matmul")
    log(f"  phase main path 1: {time.perf_counter() - t:.3f} s; kernel launches {path1}")
    check(path1["matmul"] > 0, "main path 1 never launched K1")
    check(path1["rmsnorm"] > 0, "main path 1 never launched K2")
    log(f"  peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    log("== checks of the main path's results")
    t = time.perf_counter()
    check_main_path(torch, results)
    log(f"  phase checks: {time.perf_counter() - t:.3f} s")
    log("== warm timings of the main path")
    t = time.perf_counter()
    warm_timings(torch, results)
    del results
    torch.cuda.empty_cache()
    log(f"  phase warm timings: {time.perf_counter() - t:.3f} s")

    def serve_phase(number: int, cfg, what: str, extra=None, prompts=SERVE_PROMPTS, keep=None):
        """Serve ``cfg`` with the counts set to 0 just before and read just
        after the counted ``generate``; then the checks, a warm
        ``generate``, the profile and ``extra(engine)``'s measurements.
        ``keep`` (a dict) receives the counted run's tokens and every
        step's logits, on the host.  The engine is freed on return."""
        log(f"== main path {number}: serve {cfg.name} ({what}, d_model {cfg.d_model}, "
            f"{cfg.dtype}), prompts {prompts}, {SERVE_NEW_TOKENS} new tokens")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t = time.perf_counter()
        served = serve_path(torch, cfg, torch.device("cuda"), prompts, SERVE_NEW_TOKENS,
                            keep_logits=keep is not None)
        counts = read_counts()
        routes = {"flash": LAUNCHES.by_route("flash"),
                  "ssd": LAUNCHES.by_route("ssd")}
        log(f"  phase main path {number}: {time.perf_counter() - t:.3f} s; kernel launches {counts}")
        for name, per_prefill in prefill_launches(cfg).items():
            check(per_prefill == 0 or counts[name] > 0, f"main path {number} never launched {name}")
        stats = check_serve(torch, served, cfg)
        stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if keep is not None:
            keep.update(tokens=[list(q.generated) for q in served["requests"]],
                        logits=[x.cpu() for x in served["seen"]["logits"]])
            served["seen"]["logits"].clear()
        log(f"  peak device memory: {stats['peak_gib']:.2f} GiB")
        t = time.perf_counter()
        engine = served["engine"]
        again = [type(q)(prompt=q.prompt, max_new_tokens=q.max_new_tokens)
                 for q in served["requests"]]
        engine.generate(again)
        warm = engine.timings
        log(f"  warm generate: prefill {warm['prefill_s'] * 1e3:.1f} ms, decode "
            f"{warm['decode_s'] * 1e3 / warm['decode_steps']:.2f} ms per step; same tokens: "
            f"{[q.generated for q in again] == [q.generated for q in served['requests']]}")
        stats.update(warm_prefill_ms=warm["prefill_s"] * 1e3,
                     warm_decode_ms_per_token=warm["decode_s"] * 1e3 / warm["decode_steps"])
        stats["profile"] = profile_serve(torch, engine, prompts, stats["warm_prefill_ms"],
                                         stats["warm_decode_ms_per_token"])
        if extra is not None:
            stats.update(extra(engine))
        del served, engine, again
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  phase warm generate: {time.perf_counter() - t:.3f} s")
        return counts, routes, stats

    zamba2 = model_config("zamba2-2.7b", True)
    path2_run = {}  # path 11a's reference: path 2's tokens and logits, no mesh
    path2, routes2, serve_stats = serve_phase(2, zamba2, f"{zamba2.n_layers} Mamba-2 layers",
                                              keep=path2_run)
    olmoe = model_config("olmoe-1b-7b", True)
    path3, routes3, olmoe_stats = serve_phase(
        3, olmoe, f"{olmoe.n_layers} MoE layers, {olmoe.moe.n_experts} experts top-{olmoe.moe.top_k}")
    deepseek = model_config("deepseek-v2-lite-16b", True, n_layers=DEEPSEEK_LAYERS)
    _, _, deepseek_stats = serve_phase(
        4, deepseek, f"MLA, depth cut to {deepseek.n_layers} layers of 27, "
        f"{deepseek.moe.n_shared} shared + {deepseek.moe.n_experts} experts top-{deepseek.moe.top_k}")
    xlstm = model_config("xlstm-1.3b", True)
    P, N, _ = ssd_widths(xlstm)
    path5, routes5, xlstm_stats = serve_phase(
        5, xlstm, f"{xlstm.n_layers} blocks, {xlstm.n_layers // xlstm.xlstm.slstm_every} groups of "
        f"{xlstm.xlstm.slstm_every - 1} mLSTMs (K4 at P {P}, N {N}) and one sLSTM",
        extra=lambda engine: slstm_share(torch, engine, SERVE_PROMPTS))
    whisper = model_config("whisper-small", True)
    path6, routes6, whisper_stats = serve_phase(
        6, whisper, f"{whisper.enc_dec.n_enc_layers} encoder + {whisper.n_layers} decoder layers, "
        f"{whisper.enc_dec.enc_seq} encoder frames a request",
        extra=lambda engine: encoder_attention_share(torch, engine, WHISPER_PROMPTS),
        prompts=WHISPER_PROMPTS)

    log("== parity: Zamba2 and xLSTM prefill with the kernels against the plain path on the card")
    t = time.perf_counter()
    parity = parity_phase(torch, torch.device("cuda"))
    torch.cuda.empty_cache()
    xlstm_parity = parity_phase(torch, torch.device("cuda"), "xlstm-1.3b", XLSTM_PARITY_LAYERS,
                                SEED + 3)
    torch.cuda.empty_cache()
    log(f"  phase parity: {time.perf_counter() - t:.3f} s")
    log("== parity: the decoder family (OLMoE, DeepSeek-V2-Lite) on the card, fp32")
    t = time.perf_counter()
    decoder_parity = decoder_parity_phase(torch, torch.device("cuda"))
    torch.cuda.empty_cache()
    log(f"  phase decoder parity: {time.perf_counter() - t:.3f} s")
    log("== parity: Whisper-small (EncDecLM) at full depth on the card, fp32")
    t = time.perf_counter()
    whisper_parity = whisper_parity_phase(torch, torch.device("cuda"))
    torch.cuda.empty_cache()
    log(f"  phase Whisper parity: {time.perf_counter() - t:.3f} s")
    log("== main path 7: train zamba2-2.7b at published widths and depth (K3 and K4 in the "
        "forward pass, their plain versions' autograd backward), AdamW, remat full")
    zamba2_train = model_config("zamba2-2.7b", True)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    trained = train_setup(torch, zamba2_train, torch.device("cuda"))
    # the plain path's loss on the same weights and first batch, before any update
    plain_loss = plain_train_loss(torch, zamba2_train, trained["params"], trained["batches"][0],
                                  TRAIN_MICROBATCHES)
    reset_counts()
    train_path(torch, trained)
    path7 = read_counts()
    routes7 = {"flash": LAUNCHES.by_route("flash"),
               "ssd": LAUNCHES.by_route("ssd")}
    log(f"  phase main path 7: {time.perf_counter() - t:.3f} s; kernel launches {path7}")
    check(path7["flash"] > 0 and path7["ssd"] > 0, "main path 7 never launched K3 or K4")
    train_stats = check_train(torch, trained, zamba2_train, plain_loss)
    held = trained["warm_step_memory"]
    train_stats["peak_gib"] = max(held["peak_before"], torch.cuda.max_memory_allocated()) / 2**30
    train_stats["warm_step_memory"] = held
    log(f"  peak device memory: {train_stats['peak_gib']:.2f} GiB; the last (warm) step: "
        f"{held['allocated_before']} B allocated before it, {held['peak']} B at its peak "
        f"(+{held['peak'] - held['allocated_before']} B), its arguments {held['arguments']} B")
    t = time.perf_counter()
    train_stats["profile"] = profile_train(torch, trained)
    del trained
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase train profile: {time.perf_counter() - t:.3f} s")

    log("== main path 8: data-parallel training through PCCL (examples/pccl_dp_training_torch.py "
        "defaults), 8 ranks stacked on the card")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    dp = dp_path(torch, torch.device("cuda"))
    path8 = read_counts()
    log(f"  phase main path 8: {time.perf_counter() - t:.3f} s; kernel launches {path8} "
        "(the example's model runs the plain path, as the JAX example's)")
    dp_stats = check_dp(torch, dp)
    dp_stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del dp
    gc.collect()
    torch.cuda.empty_cache()

    log("== parity: training Zamba2 and xLSTM (one group, fp32) with the kernels against the "
        "plain path on the card")
    t = time.perf_counter()
    train_parity = {"zamba2": train_parity_phase(torch, torch.device("cuda"), "zamba2-2.7b",
                                                 PARITY_LAYERS, SEED + 5)}
    torch.cuda.empty_cache()
    train_parity["xlstm"] = train_parity_phase(torch, torch.device("cuda"), "xlstm-1.3b",
                                               XLSTM_PARITY_LAYERS, SEED + 6)
    torch.cuda.empty_cache()
    log(f"  phase train parity: {time.perf_counter() - t:.3f} s")
    jobs11 = start_path11_jobs()  # host only: they count beside paths 9 and 10
    try:
        path9, routes9, trainer_stats = trainer_phase(torch, reset_counts, read_counts)
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        path10, routes10, path10_stats = path10_phase(torch, gen, reset_counts, read_counts)
        log(f"  phase main path 10 with 10b-d: {time.perf_counter() - t:.3f} s")
        t = time.perf_counter()
        path11, routes11, path11_stats = path11_phase(torch, zamba2, path2_run, serve_stats,
                                                      train_stats, reset_counts, read_counts,
                                                      jobs=jobs11)
        log(f"  phase main path 11 with 11b-c: {time.perf_counter() - t:.3f} s")
    finally:
        stop_background(jobs11)
    t = time.perf_counter()
    whisper_p12 = model_config("whisper-small", True)
    path12, path12_stats = path12_phase(torch, whisper_p12)
    log(f"  phase main path 12 with the NCCL probe: {time.perf_counter() - t:.3f} s; kernel "
        f"launches summed over the processes {path12}")
    check(path12["matmul"]["wgmma"] > 0 and path12["rmsnorm"] > 0 and path12["flash"]["wgmma"] > 0,
          "main path 12 never launched K1, K2 or K3 in its processes")
    log("serve: " + json.dumps({**serve_stats, **parity}))
    log("serve olmoe: " + json.dumps(olmoe_stats))
    log("serve deepseek: " + json.dumps(deepseek_stats))
    log("serve xlstm: " + json.dumps({**xlstm_stats, **xlstm_parity}))
    log("decoder parity: " + json.dumps(decoder_parity))
    log("serve whisper: " + json.dumps({**whisper_stats, **whisper_parity}))
    log("train zamba2: " + json.dumps({**train_stats, "parity": train_parity}))
    log("train dp: " + json.dumps(dp_stats))
    log("train whisper (Trainer): " + json.dumps(trainer_stats))
    log("verified path 1, PcclComm, PCCL_VERIFY cost, CLIs: " + json.dumps(path10_stats))
    log("path 11 (mesh, roofline, dry run): " + json.dumps(path11_stats))
    log("path 12 (processes over gloo, the sharded Trainer, the elastic re-mesh): "
        + json.dumps(path12_stats))
    log(f"path 13 (the kernel lint on the card, {smi}): " + json.dumps(path13_stats))
    log(f"total: {time.perf_counter() - t_start:.1f} s")

    # the bf16 kernels of each path; K1, K3 and K4 on their tensor-core route
    sources = {
        "matmul": ("cuda", "src/repro_torch/kernels/matmul/csrc/matmul_sm90.cu",
                   "src/repro/kernels/matmul/kernel.py:52",
                   {"matmul": path1["matmul"] + path10["matmul"]
                    + sum(path12["matmul"].values())},
                   {r: routes1[r] + routes10[r] + path12["matmul"][r] for r in routes1}),
        "rmsnorm": ("triton", "src/repro_torch/kernels/rmsnorm/kernel.py",
                    "src/repro/kernels/rmsnorm/kernel.py:37",
                    {"rmsnorm": path1["rmsnorm"] + path10["rmsnorm"] + path12["rmsnorm"]}, None),
        "flash": ("cuda", "src/repro_torch/kernels/flash/csrc/flash_sm90.cu",
                  "src/repro/kernels/flash/kernel.py:79",
                  {"flash": path2["flash"] + path3["flash"] + path6["flash"] + path7["flash"]
                   + path9["flash"] + path11["flash"] + sum(path12["flash"].values())},
                  {r: routes2["flash"][r] + routes3["flash"][r] + routes6["flash"][r]
                   + routes7["flash"][r] + routes9["flash"][r] + routes11["flash"][r]
                   + path12["flash"][r] for r in routes2["flash"]}),
        "ssd": ("cuda", "src/repro_torch/kernels/ssd/csrc/ssd_sm90.cu",
                "src/repro/kernels/ssd/kernel.py:80",
                {"ssd": path2["ssd"] + path7["ssd"] + path11["ssd"]},
                {r: routes2["ssd"][r] + routes7["ssd"][r] + routes11["ssd"][r]
                 for r in routes2["ssd"]}),
        # K4's tiled tensor-core route at the mLSTM's widths (P-tiles, N-slices)
        "ssd_mlstm": ("cuda", "src/repro_torch/kernels/ssd/csrc/ssd_sm90_tiled.cu",
                      "src/repro/kernels/ssd/kernel.py:80", {"ssd_mlstm": path5["ssd"]},
                      routes5["ssd"]),
    }
    for name in sources:
        log(f"  {name}[float32]: " + json.dumps(kernels["float32"][name]))
    want5 = prefill_launches(xlstm)["ssd"]  # one prefill in path 5's counted generate
    check(kernels["bfloat16"]["ssd_mlstm"]["kernel_route"] == "wgmma_tiled"
          and kernels["float32"]["ssd_mlstm"]["kernel_route"] == "fma"
          and routes5["ssd"] == {"wgmma": 0, "wgmma_tiled": want5, "fma": 0},
          f"K4 at the mLSTM's widths took {routes5['ssd']}, not {want5} on the wgmma_tiled route")
    record = {"kernels": []}
    for name, (route, source, replaces, counts, by_route) in sources.items():
        k = kernels["bfloat16"][name]
        entry = {
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"], "dtype": "bfloat16", "shape": k["shape"],
        }
        if by_route is not None:
            entry.update(kernel_route=k["kernel_route"], launches_by_route=by_route)
        if "pass_ms" in k:
            entry.update(pass_ms=k["pass_ms"], pass_bytes_bound_ms=k["pass_bytes_bound_ms"])
        if name in ("matmul", "rmsnorm"):
            # launches on path 1, on path 10 (path 1 again under PCCL_VERIFY=1)
            # and on path 12a, summed over its processes
            p12 = path12[name] if name == "rmsnorm" else sum(path12[name].values())
            entry["launches_by_path"] = {"collectives": path1[name], "verified": path10[name],
                                         "processes": p12}
        if name == "flash":
            # launches on path 2 (Zamba2), path 3 (OLMoE), path 6 (Whisper),
            # path 7 (training Zamba2) and path 9 (training Whisper through the
            # Trainer, and serving from its checkpoint); timed at the three
            # prefills and Whisper's train shape
            entry["launches_by_path"] = {"zamba2": path2["flash"], "olmoe": path3["flash"],
                                         "whisper": path6["flash"], "zamba2_train": path7["flash"],
                                         "whisper_trainer": path9["flash"],
                                         "zamba2_mesh": path11["flash"],
                                         "whisper_processes": sum(path12["flash"].values())}
            entry["at_olmoe_prefill"] = kernels["bfloat16"]["flash_olmoe"]
            entry["at_whisper_prefill"] = kernels["bfloat16"]["flash_whisper"]
            entry["at_train"] = kernels["bfloat16"]["flash_train"]
            entry["at_whisper_train"] = kernels["bfloat16"]["flash_whisper_train"]
        if name == "ssd":
            entry["launches_by_path"] = {"zamba2": path2["ssd"], "zamba2_train": path7["ssd"],
                                         "zamba2_mesh": path11["ssd"]}
            entry["at_train"] = kernels["bfloat16"]["ssd_train"]
        record["kernels"].append(entry)
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
