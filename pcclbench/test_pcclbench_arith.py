"""The frozen counting arithmetic against counts made by hand."""

import json
import math

import pytest

from pcclbench import arith


def test_k1_at_the_layer_shape():
    # (32768 × 3584) @ (3584 × 12288): 2·M·K·N operations; bf16 operands and result
    flops, nbytes = arith.k1(32768, 3584, 12288, "bfloat16")
    assert flops == 2 * 32768 * 3584 * 12288 == 2_886_218_022_912
    assert nbytes == 2 * (32768 * 3584 + 3584 * 12288 + 32768 * 12288) == 1_128_267_776
    # operations bound it: 2.918 ms at 989 TFLOP/s
    assert arith.bound_s(flops, nbytes, "bfloat16") == pytest.approx(2.918319e-3, rel=1e-6)


def test_k2_rmsnorm():
    flops, nbytes = arith.k2(32768, 12288, "bfloat16")
    assert nbytes == 32768 * 12288 * 2 * 2 + 12288 * 4 == 1_610_661_888
    assert flops == 4 * 32768 * 12288
    assert arith.bound_s(flops, nbytes, "bfloat16") == pytest.approx(0.480795e-3, rel=1e-5)


def test_k3_causal():
    # Zamba2's shared attention: (4, 4096, 32 heads, 32 KV heads, 80)
    flops, nbytes = arith.k3(4, 4096, 32, 32, 80, "bfloat16")
    assert flops == 4 * 32 * 4096 * 4096 * 80 * 2  # half of 2·S²·D for each of two products, 2 ops a MAC
    assert nbytes == 4 * 4096 * 80 * 2 * (32 + 32 + 32 + 32)
    assert arith.bound_s(flops, nbytes, "bfloat16") * 1e3 == pytest.approx(0.3474, rel=1e-3)


def test_k4_shared_and_per_head_bc():
    B, S, H, P, N, L = 4, 4096, 80, 64, 64, 64
    nc = S // L
    per_bh = L * L * P + 2 * L * P * N  # W X, C Rᵀ, the state update
    shared, _ = arith.k4(B, S, H, P, N, L, True, "float32")
    assert shared == 2 * B * nc * (L * L * N + H * per_bh)
    per_head, _ = arith.k4(B, S, H, P, N, L, False, "float32")
    assert per_head == 2 * B * nc * H * (L * L * N + per_bh)
    # the fp32 bound at Zamba2's prefill, C Bᵀ once per (b, chunk): 0.483 ms
    assert shared / arith.PEAK_FLOPS["float32"] * 1e3 == pytest.approx(0.48278, rel=1e-4)
    _, nbytes = arith.k4(B, S, H, P, N, L, True, "bfloat16")
    assert nbytes == (2 * B * S * H * P + 2 * B * S * N + B * H * P * N) * 2 + 4 * (B * S * H + B * H * P * N)


@pytest.mark.parametrize("kind, out_local", [("all_reduce", 1024), ("reduce_scatter", 128),
                                             ("all_gather", 8192), ("all_to_all", 1024)])
def test_collective_bytes(kind, out_local):
    # 8 ranks, 1024 B a rank in: every rank's input read once, its result written once
    assert arith.collective_bytes(kind, 1024, 8) == 8 * (1024 + out_local)


def test_model_flops():
    assert arith.model_flops(2.7e9, 8192, train=True) == 6 * 2.7e9 * 8192
    assert arith.model_flops(2.7e9, 8192, train=False) == 2 * 2.7e9 * 8192
