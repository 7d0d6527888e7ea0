"""The benchmark's frozen counting: peaks, and the least operations and
bytes each counted call needs, from its shapes alone.

A count here is what the inputs need, whatever route or pass structure a
kernel uses to compute it, so a later change to a kernel cannot move its
own yardstick.  Each input byte is read once and each output byte written
once.  Imports nothing but the standard library.
"""

from __future__ import annotations

# Published dense peaks of one NVIDIA H100 SXM at its 700 W limit.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the chip could take: the larger of operations over
    the peak rate and bytes over the memory rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def k1(M: int, K: int, N: int, dtype: str) -> tuple:
    """K1, ``(M, K) @ (K, N)``: (flops, bytes)."""
    return 2.0 * M * K * N, float(M * K + K * N + M * N) * ITEMSIZE[dtype]


def k2(rows: int, d: int, dtype: str) -> tuple:
    """K2, RMSNorm of ``(rows, d)`` with an fp32 weight of ``d``: (flops, bytes)."""
    return 4.0 * rows * d, 2.0 * rows * d * ITEMSIZE[dtype] + 4.0 * d


def k3(B: int, S: int, H: int, KV: int, D: int, dtype: str) -> tuple:
    """K3, causal attention of ``(B, S, H, D)`` queries over ``KV`` heads:
    half of Q Kᵀ and of P V, two operations a multiply-add."""
    flops = 2.0 * B * H * S * S * D
    nbytes = float(2 * B * S * H * D + 2 * B * S * KV * D) * ITEMSIZE[dtype]
    return flops, nbytes


def k4(B: int, S: int, H: int, P: int, N: int, chunk: int, shared_bc: bool, dtype: str) -> tuple:
    """K4, the chunked SSD scan of X ``(B, S, H, P)`` with states of ``N``:
    per (b, head, chunk) W X (L·L·P), C Rᵀ and the state update (L·P·N
    each); C Bᵀ (L·L·N) per head, or once per (b, chunk) where B and C are
    shared across heads.  Bytes: X read and Y written, B and C, the final
    state; the fp32 log-decays and initial state."""
    L = chunk
    nc = -(-S // L)
    flops = 2.0 * B * nc * ((1 if shared_bc else H) * L * L * N + H * (L * L * P + 2 * L * P * N))
    bc = B * S * (1 if shared_bc else H) * N
    nbytes = float(2 * B * S * H * P + 2 * bc + B * H * P * N) * ITEMSIZE[dtype] \
        + 4.0 * (B * S * H + B * H * P * N)
    return flops, nbytes


def collective_bytes(kind: str, local_in: int, n: int) -> float:
    """The bytes a rank-stacked collective moves on one card at the least:
    the stacked input read once and the stacked result written once.
    ``local_in`` is one rank's input in bytes."""
    out = {"all_reduce": local_in, "reduce_scatter": local_in // n,
           "all_gather": local_in * n, "all_to_all": local_in}[kind]
    return float(n * (local_in + out))


def model_flops(n_params: float, tokens: float, train: bool) -> float:
    """The model's operations for ``tokens``: 6·N·D to train, 2·N·D forward."""
    return (6.0 if train else 2.0) * n_params * tokens
