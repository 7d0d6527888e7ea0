"""The port's kernel lint against the JAX package's, on the CPU.

(a) The checks copied from ``repro.analysis.kernel_lint`` give the
reference's exact reports (kinds, labels, programs, details) on its seven
shipped Pallas call sites and on the mutation corpus of
``tests/test_kernel_lint.py`` (loaded from that file, not edited), each
reference ``CallSite`` converted into the port's model with the
reference's semantics.  (b) The port's own corpus: mutants of the launch
models (``kernels/*/launch.py``, edited as text and re-executed) and of
the kernel bodies (the ``.cu`` sources and the Triton function), killed
statically at >= 85 %, every grid, output, mask, raster, role, smem and
body mutant killed; the survivors are input maps that stay in bounds,
listed by name.  (c) Every shipped case and main-path shape is clean, in
time.  (d) The ``PCCL_VERIFY=1`` gate in the wrappers, its memo and
``donation_compatible`` against the reference's.
"""

import dataclasses
import importlib.util
import inspect
import re
import sys
import threading
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.analysis import kernel_lint as ref_lint
from repro.analysis import pallas_model as ref_model
from repro.comm import exec_engine as ref_engine
from repro_torch.analysis import kernel_lint as lint
from repro_torch.analysis import launch_model as model
from repro_torch.comm import exec_engine
from repro_torch.kernels.build import verify_launch
from repro_torch.kernels.flash import launch as k3_launch
from repro_torch.kernels.flash.kernel import flash_attention_cuda
from repro_torch.kernels.matmul import launch as k1_launch
from repro_torch.kernels.matmul.kernel import matmul_cuda
from repro_torch.kernels.rmsnorm import kernel as k2
from repro_torch.kernels.rmsnorm import launch as k2_launch
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_triton
from repro_torch.kernels.rounds import launch as round_launch
from repro_torch.kernels.rounds.kernel import stacked_round_cuda
from repro_torch.kernels.ssd import launch as k4_launch
from repro_torch.kernels.ssd.kernel import ssd_cuda

REPO = Path(__file__).resolve().parents[1]
KERNELS = REPO / "src" / "repro_torch" / "kernels"
BF16, F32 = torch.bfloat16, torch.float32
# the reference's kinds that no model-side check of the port emits
_BODY_KINDS = {"scratch-no-reset", "scratch-carry-axis", "scratch-carry-parallel",
               "missing-store-cast", "low-precision-read", "dead-param", "vmem-budget"}


def _kinds(reports):
    return {v.kind for r in reports for v in r.violations}


def _meta(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ------------------------------------------- (a) parity with the reference


def _port_site(ref):
    """A reference ``CallSite`` as the port's model, with its semantics."""
    def blocks(bs):
        return tuple(model.BlockModel(b.block_shape, b.index_map) for b in bs)

    return model.CallSite(
        name=ref.name, grid=ref.grid,
        in_blocks=blocks(ref.in_blocks), in_shapes=ref.in_shapes, in_dtypes=ref.in_dtypes,
        out_blocks=blocks(ref.out_blocks), out_shapes=ref.out_shapes,
        out_dtypes=ref.out_dtypes, input_output_aliases=ref.input_output_aliases,
        dimension_semantics=ref.dimension_semantics,
    )


def _facts(report, kinds=None):
    return (report.site, report.grid, report.programs_checked,
            [(v.kind, v.site, v.operand, v.program, v.box, v.detail)
             for v in report.violations if kinds is None or v.kind not in kinds])


REF_CASES = ref_lint.shipped_kernel_cases()


@pytest.mark.parametrize("case", REF_CASES, ids=[c[0] for c in REF_CASES])
def test_copied_checks_match_the_reference_on_its_shipped_cases(case):
    label, fn, args, kwargs = case
    sites = ref_model.capture_call_sites(fn, *args, **kwargs)
    assert sites, label
    for ref in sites:
        want = ref_lint.analyze_call_site(ref)
        got = lint.analyze_call_site(_port_site(ref))
        assert want.ok and got.ok, (str(want), str(got))
        assert _facts(got) == _facts(want, _BODY_KINDS)


def _reference_mutation_corpus():
    """``_gen_mutants`` of tests/test_kernel_lint.py, imported from its file."""
    path = REPO / "tests" / "test_kernel_lint.py"
    spec = importlib.util.spec_from_file_location("_reference_kernel_lint_tests", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module._gen_mutants()


def test_copied_checks_match_the_reference_on_its_mutants():
    mutants = _reference_mutation_corpus()
    assert len(mutants) >= 50
    killed = 0
    for name, op, role, site, summary in mutants:
        want = ref_lint.analyze_call_site(site, summary=summary)
        got = lint.analyze_call_site(_port_site(site))
        assert _facts(got) == _facts(want, _BODY_KINDS), (name, op, role)
        killed += bool(got.violations)
    # the model-side checks alone kill most of the corpus (the rest are the
    # reference's body rules and in-bounds input maps)
    assert killed >= 0.7 * len(mutants), (killed, len(mutants))


def test_reference_semantics_keep_the_sequential_carry_exemption():
    """A Pallas output revisited along a sequential axis is a carry; along a
    parallel axis, or in any CUDA grid, it is a race."""
    site = model.CallSite(
        name="carry", grid=(4,),
        in_blocks=(model.BlockModel((32, 128), lambda i: (i, 0)),), in_shapes=((128, 128),),
        in_dtypes=("float32",),
        out_blocks=(model.BlockModel((32, 128), lambda i: (0, 0)),), out_shapes=((32, 128),),
        out_dtypes=("float32",), dimension_semantics=("arbitrary",))
    assert lint.analyze_call_site(site).ok
    parallel = dataclasses.replace(site, dimension_semantics=("parallel",))
    assert _kinds([lint.analyze_call_site(parallel)]) == {"write-race"}
    cuda = dataclasses.replace(
        site, route="cuda", threads=128,
        in_blocks=(model.Footprint(lambda i: [model.Box((32 * i, 0), (32, 128))]),),
        out_blocks=(model.Footprint(lambda i: [model.Box((0, 0), (32, 128))]),))
    assert _kinds([lint.analyze_call_site(cuda)]) == {"write-race"}


# ---------------------------------------------- (b) the port's own corpus

# probes: ragged shapes on every route of every kernel
PROBES = {
    k1_launch: [
        ((_meta(2348, 200, dtype=BF16), _meta(200, 520, dtype=BF16)), {}),
        ((_meta(300, 130), _meta(130, 200)), {}),
        ((_meta(300, 130), _meta(130, 600)), {}),  # fma: three column tiles, the last ragged
    ],
    k2_launch: [((_meta(3, 5, 100, dtype=BF16), _meta(100)), {})],
    k3_launch: [
        ((_meta(2, 300, 4, 80, dtype=BF16), _meta(2, 300, 2, 80, dtype=BF16),
          _meta(2, 300, 2, 80, dtype=BF16)), {"causal": True}),
        ((_meta(1, 200, 4, 64, dtype=BF16), _meta(1, 333, 2, 64, dtype=BF16),
          _meta(1, 333, 2, 64, dtype=BF16)), {"causal": False}),
        ((_meta(2, 150, 4, 48), _meta(2, 150, 2, 48), _meta(2, 150, 2, 48)), {"causal": True}),
        ((_meta(1, 100, 2, 80), _meta(1, 70, 1, 80), _meta(1, 70, 1, 80)), {"causal": False}),
    ],
    k4_launch: [
        ((_meta(2, 200, 3, 64, dtype=BF16), _meta(2, 200, 3), _meta(2, 200, 64, dtype=BF16),
          _meta(2, 200, 64, dtype=BF16)), {"chunk": 64, "initial_state": _meta(2, 3, 64, 64)}),
        ((_meta(1, 130, 2, 64, dtype=BF16), _meta(1, 130, 2), _meta(1, 130, 2, 64, dtype=BF16),
          _meta(1, 130, 2, 64, dtype=BF16)), {"chunk": 64}),
        ((_meta(2, 100, 3, 16), _meta(2, 100, 3), _meta(2, 100, 8), _meta(2, 100, 8)),
         {"chunk": 32}),
        ((_meta(1, 90, 5, 24), _meta(1, 90, 5), _meta(1, 90, 5, 10), _meta(1, 90, 5, 10)),
         {"chunk": 32, "initial_state": _meta(1, 5, 24, 10)}),
        ((_meta(1, 100, 2, 130, dtype=BF16), _meta(1, 100, 2), _meta(1, 100, 2, 70, dtype=BF16),
          _meta(1, 100, 2, 70, dtype=BF16)), {"chunk": 48}),
        # wgmma_tiled: two P-tiles and two N-slices, shared B/C, ragged S; one
        # P-tile and three N-slices (fewer than the ring's stages), per head
        ((_meta(1, 300, 2, 128, dtype=BF16), _meta(1, 300, 2), _meta(1, 300, 128, dtype=BF16),
          _meta(1, 300, 128, dtype=BF16)), {"chunk": 64, "initial_state": _meta(1, 2, 128, 128)}),
        ((_meta(2, 130, 3, 64, dtype=BF16), _meta(2, 130, 3), _meta(2, 130, 3, 192, dtype=BF16),
          _meta(2, 130, 3, 192, dtype=BF16)), {"chunk": 64}),
        # fma: four heads a tile (shared B/C, P = 64), the last tile past H, three
        # chunks' scores in one block; two tiles of P = 300 a head; two heads a
        # tile (P = 128) and two 64-step tiles a chunk of 128
        ((_meta(1, 150, 5, 64), _meta(1, 150, 5), _meta(1, 150, 40), _meta(1, 150, 40)),
         {"chunk": 64}),
        ((_meta(1, 100, 2, 300), _meta(1, 100, 2), _meta(1, 100, 2, 70), _meta(1, 100, 2, 70)),
         {"chunk": 48}),
        ((_meta(1, 300, 3, 128), _meta(1, 300, 3), _meta(1, 300, 72), _meta(1, 300, 72)),
         {"chunk": 128}),
    ],
    round_launch: [
        # 16-byte units, a ragged last tile; one element a thread; a reduce by every table
        ((_meta(2, 8, 12000, dtype=BF16), None, None, None, 2, 8), {}),
        ((_meta(8, 4, 3, dtype=BF16), None, None, None, 8, 4), {}),
        ((_meta(8, 8, 2052), _meta(8, dtype=torch.int64), _meta(8, 2, dtype=torch.int64),
          _meta(8, 2, dtype=torch.int64), 8, 2), {"reduce": True}),
    ]
}

# (module, category, name, old text, new text, occurrence): one edit of a
# launch model.  Categories: grid, raster, role, output, mask, smem must be
# killed; input may survive only if its reads stay in bounds.
MODEL_MUTANTS = [
    # K1
    (k1_launch, "grid", "wgmma grid ceil->floor", "grid=(tiles_m * tiles_n,)",
     "grid=((M // BM) * (N // BN),)", 0),
    (k1_launch, "grid", "wgmma row tiles ceil->floor", "tiles_m, tiles_n, n_k = cdiv(M, BM),",
     "tiles_m, tiles_n, n_k = M // BM,", 0),
    (k1_launch, "raster", "raster min(GROUP_M, ...) dropped",
     "group_m = min(GROUP_M, tiles_m - first_m)", "group_m = GROUP_M", 0),
    (k1_launch, "raster", "raster tile map swapped",
     "(first_m + in_group % group_m) * BM, (in_group // group_m) * BN",
     "(in_group // group_m) * BM, (first_m + in_group % group_m) * BN", 0),
    (k1_launch, "raster", "raster groups of columns", "per_group = GROUP_M * tiles_n",
     "per_group = GROUP_M * tiles_m", 0),
    (k1_launch, "output", "wgmma out tile swapped", "return [Box((m0, n0), (BM, BN))]",
     "return [Box((n0, m0), (BM, BN))]", 0),
    (k1_launch, "output", "wgmma out block dims swapped", "return [Box((m0, n0), (BM, BN))]",
     "return [Box((m0, n0), (BN, BM))]", 0),
    (k1_launch, "mask", "wgmma out mask on N dropped",
     "out_blocks=(Footprint(out, masked=(0, 1)),)", "out_blocks=(Footprint(out, masked=(0,)),)",
     0),
    (k1_launch, "mask", "wgmma out mask on M dropped",
     "out_blocks=(Footprint(out, masked=(0, 1)),)", "out_blocks=(Footprint(out, masked=(1,)),)",
     0),
    (k1_launch, "input", "wgmma x read without TMA", "Footprint(x, tma=True)", "Footprint(x)", 0),
    (k1_launch, "input", "wgmma x reads K only", "return [Box((m0, 0), (BM, n_k * BK))]",
     "return [Box((m0, 0), (BM, K))]", 0),
    (k1_launch, "grid", "fma grid rows ceil->floor", "grid=(cdiv(M, BM), cdiv(N, BN))",
     "grid=(M // BM, cdiv(N, BN))", 0),
    (k1_launch, "grid", "fma grid columns ceil->floor", "grid=(cdiv(M, BM), cdiv(N, BN))",
     "grid=(cdiv(M, BM), N // BN)", 0),
    (k1_launch, "grid", "fma grid axes swapped", "grid=(cdiv(M, BM), cdiv(N, BN))",
     "grid=(cdiv(N, BN), cdiv(M, BM))", 0),
    (k1_launch, "output", "fma out tile map swapped",
     "return [Box((bx * BM, by * BN), (BM, BN))]", "return [Box((by * BM, bx * BN), (BM, BN))]",
     0),
    (k1_launch, "output", "fma out half-width tile", "return [Box((bx * BM, by * BN), (BM, BN))]",
     "return [Box((bx * BM, by * BN), (BM, BN // 2))]", 0),
    (k1_launch, "mask", "fma out mask on M dropped",
     "out_blocks=(Footprint(out, masked=(0, 1)),)", "out_blocks=(Footprint(out, masked=(1,)),)",
     1),
    (k1_launch, "input", "fma x mask on K dropped",
     "in_blocks=(Footprint(x, masked=(0, 1)),", "in_blocks=(Footprint(x, masked=(0,)),", 0),
    (k1_launch, "smem", "wgmma one stage too many",
     "smem = 1024 + STAGES * stage_bytes + 2 * STAGES * 8",
     "smem = 1024 + (STAGES + 1) * stage_bytes + 2 * STAGES * 8", 0),
    (k1_launch, "smem", "wgmma attribute not what is launched", "smem_attr=smem,",
     "smem_attr=smem - 1024,", 0),
    (k1_launch, "smem", "fma ring over budget", "smem = 4 * STAGES * BK * (BM + XPAD + BN)",
     "smem = 4 * 4 * STAGES * BK * (BM + XPAD + BN)", 0),
    (k1_launch, "smem", "fma one ring slot fewer launched", "smem = 4 * STAGES * BK",
     "smem = 4 * (STAGES - 1) * BK", 0),
    (k1_launch, "smem", "fma attribute not set", "smem_attr=smem,  # launch's attribute",
     "smem_attr=None,  # launch's attribute", 0),
    # K2
    (k2_launch, "grid", "rmsnorm one row short", "launch_geometry(rows, d)\n\n    def row",
     "launch_geometry(rows - 1, d)\n\n    def row", 0),
    (k2_launch, "output", "rmsnorm half a row", "return [Box((r, 0), (1, block))]",
     "return [Box((r, 0), (1, block // 2))]", 0),
    (k2_launch, "output", "rmsnorm every program on row 0", "return [Box((r, 0), (1, block))]",
     "return [Box((0, 0), (1, block))]", 0),
    (k2_launch, "mask", "rmsnorm store mask dropped",
     "out_blocks=(Footprint(row, masked=(1,)),)", "out_blocks=(Footprint(row),)", 0),
    (k2_launch, "input", "rmsnorm weight mask dropped", "Footprint(weight, masked=(0,))",
     "Footprint(weight)", 0),
    (k2_launch, "input", "rmsnorm weight reads one element", "return [Box((0,), (block,))]",
     "return [Box((0,), (1,))]", 0),
    # K3
    (k3_launch, "grid", "wgmma q tiles ceil->floor", "nq = cdiv(S, BQ)", "nq = S // BQ", 0),
    (k3_launch, "grid", "fma q tiles ceil->floor", "nq = cdiv(S, BQ)", "nq = S // BQ", 1),
    (k3_launch, "grid", "wgmma grid over kv heads", "grid=(B * H, nq),", "grid=(B * K, nq),", 0),
    (k3_launch, "grid", "fma grid axes swapped", "grid=(B * H, nq),", "grid=(nq, B * H),", 1),
    (k3_launch, "output", "wgmma o half the columns",
     "return [Box((b, q0, h, 0), (1, BQ, 1, 8 * (D // 8)))]",
     "return [Box((b, q0, h, 0), (1, BQ, 1, 8 * (D // 16)))]", 0),
    (k3_launch, "output", "wgmma heavy-first map off by one",
     "q0 = (nq - 1 - y) * BQ  # heavy", "q0 = (nq - y) * BQ  # heavy", 0),
    (k3_launch, "output", "fma q tile half a tile",
     "q0 = (nq - 1 - y) * BQ  # heavy", "q0 = (nq - 1 - y) * (BQ // 2)  # heavy", 1),
    (k3_launch, "output", "fma (b, h) split by kv heads", "b, h = divmod(bh, H)",
     "b, h = divmod(bh, K)", 1),
    (k3_launch, "mask", "wgmma o mask dropped", "out_blocks=(Footprint(out, masked=(1,)),)",
     "out_blocks=(Footprint(out),)", 0),
    (k3_launch, "mask", "fma o mask dropped", "out_blocks=(Footprint(qo, masked=(1,)),)",
     "out_blocks=(Footprint(qo),)", 0),
    (k3_launch, "input", "fma k mask dropped",
     "in_blocks=(Footprint(qo, masked=(1,)), Footprint(kv, masked=(1,)),",
     "in_blocks=(Footprint(qo, masked=(1,)), Footprint(kv),", 0),
    (k3_launch, "input", "wgmma causal limit dropped",
     "n_kv = min(n_kv, (min(q0 + BQ, S) - 1) // BKV + 1)", "n_kv = n_kv", 0),
    (k3_launch, "input", "wgmma GQA map dropped", "h // (H // K)", "h", 0),
    (k3_launch, "input", "fma GQA map dropped", "h // (H // K)", "h", 1),
    (k3_launch, "smem", "wgmma twice the stages",
     "2 * (2 * NB * box_bytes) + 5 * 8  # :212", "4 * (2 * NB * box_bytes) + 5 * 8  # :212", 0),
    (k3_launch, "smem", "fma one K/V stage not launched",
     "smem = 4 * (BQ * DP + STAGES * BK * (DP + VP))",
     "smem = 4 * (BQ * DP + (STAGES - 1) * BK * (DP + VP))", 0),
    (k3_launch, "smem", "fma V rows unpadded", "smem = 4 * (BQ * DP + STAGES * BK * (DP + VP))",
     "smem = 4 * (BQ * DP + STAGES * BK * (DP + D4))", 0),
    (k3_launch, "smem", "fma attribute not set", "smem_attr=smem,", "smem_attr=None,", 1),
    (k3_launch, "smem", "wgmma attribute not set", "smem_attr=smem,", "smem_attr=None,", 0),
    # K4
    (k4_launch, "role", "states scores block missing", 'grid=(sb + pl["states_blocks"],)',
     'grid=(pl["states_blocks"],)', 0),
    (k4_launch, "role", "states role split shifted by one",
     "for b, ch, hg, m0, n0 in ([] if x < sb else", "for b, ch, hg, m0, n0 in ([] if x <= sb else",
     0),
    (k4_launch, "role", "scores tiles a block one fewer", 'y = x * pl["SCORE_TILES"] + q',
     'y = x * (pl["SCORE_TILES"] - 1) + q', 0),
    (k4_launch, "grid", "recurrence grid ceil->floor", "grid=(cdiv(BH * PN // V, RT),)",
     "grid=(BH * PN // V // RT,)", 0),
    (k4_launch, "grid", "fma outputs one block short", 'grid=(pl["outputs_blocks"],)',
     'grid=(pl["outputs_blocks"] - 1,)', 0),
    (k4_launch, "grid", "fma scores blocks ceil->floor",
     'score_blocks=cdiv(score_items, c["SCORE_TILES"])',
     'score_blocks=score_items // c["SCORE_TILES"]', 0),
    (k4_launch, "grid", "fma states chunks ceil->floor", "nc = cdiv(S, L)", "nc = S // L", 0),
    (k4_launch, "grid", "wgmma states one chunk short", "grid=(B * H * nc,),  # states_geometry",
     "grid=(B * H * (nc - 1),),  # states_geometry", 0),
    (k4_launch, "output", "fma states first N-slice only",
     'else Box((b, hg, ch, m0, n0), (1, 1, 1, pl["WIDE"], T)))',
     'else Box((b, hg, ch, m0, 0), (1, 1, 1, pl["WIDE"], T)))', 0),
    (k4_launch, "output", "fma flat states one head a tile",
     "Box((b, h0, ch, 0, n0), (1, nh, 1, P, T))", "Box((b, h0, ch, 0, n0), (1, 1, 1, P, T))", 0),
    (k4_launch, "output", "fma outputs steps of the chunk's first tile only",
     "((b, ch * L + t0), (1, min(T, L - t0)))", "((b, ch * L), (1, min(T, L - t0)))", 0),
    (k4_launch, "output", "totals from every P-tile",
     'if n0 == 0 and ((h - hg) << pl["lg"]) >= m0]', "if n0 == 0]", 0),
    (k4_launch, "output", "recurrence before one chunk short", "Box((r, 0, e), (nr, nc, ne))",
     "Box((r, 0, e), (nr, nc - 1, ne))", 0),
    (k4_launch, "output", "recurrence half the threads", "return [Box((x * span,), (span,))]",
     "return [Box((x * span,), (span // 2,))]", 0),
    (k4_launch, "output", "wgmma outputs half of P",
     "(1, L, 1, P))]\n\n    def bcs", "(1, L, 1, P // 2))]\n\n    def bcs", 0),
    (k4_launch, "output", "chunk map b and c swapped", "return x // nc, h, x % nc",
     "return x % nc, h, x // nc", 0),
    (k4_launch, "mask", "fma Y mask on P dropped", "out_blocks=(Footprint(ys, masked=(1, 2, 3)),)",
     "out_blocks=(Footprint(ys, masked=(1, 2)),)", 0),
    (k4_launch, "mask", "fma Y mask on S dropped", "out_blocks=(Footprint(ys, masked=(1, 2, 3)),)",
     "out_blocks=(Footprint(ys, masked=(2, 3)),)", 0),
    (k4_launch, "mask", "fma states mask on P dropped",
     "out_blocks=(Footprint(states, masked=(1, 3, 4)),",
     "out_blocks=(Footprint(states, masked=(1, 4)),", 0),
    (k4_launch, "mask", "recurrence before mask dropped",
     "out_blocks=(Footprint(pairs if pair else rows, masked=(0,)), Footprint(flat, masked=(0,))),",
     "out_blocks=(Footprint(pairs if pair else rows), Footprint(flat, masked=(0,))),", 0),
    (k4_launch, "mask", "recurrence fin mask dropped",
     "out_blocks=(Footprint(pairs if pair else rows, masked=(0,)), Footprint(flat, masked=(0,))),",
     "out_blocks=(Footprint(pairs if pair else rows, masked=(0,)), Footprint(flat)),", 0),
    (k4_launch, "mask", "wgmma Y mask dropped",
     'out_names=("Y",), out_blocks=(Footprint(xy, masked=(1,)),)',
     'out_names=("Y",), out_blocks=(Footprint(xy),)', 0),
    (k4_launch, "smem", "fma states one ring slot fewer launched",
     '+ c["STATES_STAGES"] * stage1),  # states_smem',
     '+ (c["STATES_STAGES"] - 1) * stage1),  # states_smem', 0),
    (k4_launch, "smem", "fma outputs one ring slot fewer launched",
     '+ c["OUTPUTS_STAGES"] * stage3))  # outputs_smem',
     '+ (c["OUTPUTS_STAGES"] - 1) * stage3))  # outputs_smem', 0),
    (k4_launch, "smem", "wgmma states over budget", "smem = 1024 + 3 * tile_bytes",
     "smem = 1024 + 30 * tile_bytes", 0),
    (k4_launch, "smem", "fma outputs attribute not set", 'smem_attr=pl["smem3"],',
     "smem_attr=None,", 0),
    (k4_launch, "input", "wgmma X half the chunk",
     "(1, L, 1, P))]\n\n    def bs", "(1, L // 2, 1, P))]\n\n    def bs", 0),
    (k4_launch, "input", "la mask dropped", "Footprint(las, masked=(1, 2))",
     "Footprint(las, masked=(2,))", 0),
    (k4_launch, "input", "recurrence totals first chunk only", "Box((r, 0), (nr, nc))",
     "Box((r, 0), (nr, 1))", 0),
    (k4_launch, "grid", "wgmma_tiled states chunks ceil->floor", "nc, ptiles = cdiv(S, L), P // W",
     "nc, ptiles = S // L, P // W", 0),
    (k4_launch, "grid", "wgmma_tiled states P-tiles one short",
     "grid=(B * H * nc * ptiles,),  # states_geometry",
     "grid=(B * H * nc * (ptiles - 1),),  # states_geometry", 0),
    (k4_launch, "grid", "wgmma_tiled outputs P-tiles one short",
     "grid=(B * H * nc * ptiles,),  # outputs_geometry",
     "grid=(B * H * nc * (ptiles - 1),),  # outputs_geometry", 0),
    (k4_launch, "output", "wgmma_tiled states N-slices dropped",
     "return [Box((b, h, ch, p0, 0), (1, 1, 1, W, N))]",
     "return [Box((b, h, ch, p0, 0), (1, 1, 1, W, W))]", 0),
    (k4_launch, "output", "wgmma_tiled recurrence before's lo dropped", "(nr, nc, 2, ne))",
     "(nr, nc, 1, ne))", 0),
    (k4_launch, "output", "wgmma_tiled outputs every P-tile at p0 = 0",
     "return (x % ptiles) * W, b, h, ch", "return 0, b, h, ch", 1),
    (k4_launch, "output", "wgmma_tiled totals from every P-tile", "if p0 == 0 else []",
     "if True else []", 0),
    (k4_launch, "mask", "wgmma_tiled Y mask dropped",
     'out_names=("Y",), out_blocks=(Footprint(xy, masked=(1,)),)',
     'out_names=("Y",), out_blocks=(Footprint(xy),)', 1),
    (k4_launch, "smem", "wgmma_tiled states over budget",
     "tiles, staging = 2 + stages,", "tiles, staging = 30 + stages,", 0),
    (k4_launch, "smem", "wgmma_tiled outputs without the alignment slack",
     "smem = 1024 + carved  # OUTPUTS_SMEM", "smem = carved  # OUTPUTS_SMEM", 0),
    (k4_launch, "input", "wgmma_tiled states la mask dropped", "Footprint(las, masked=(1,))",
     "Footprint(las)", 2),
    (k4_launch, "input", "fma outputs scores one column over",
     "else Box((b, ch, t0, 0), (1, 1, T, L))", "else Box((b, ch, t0, 0), (1, 1, T, L + 1))", 0),
    # the round kernel
    (round_launch, "grid", "round tiles ceil->floor",
     "tiles = cdiv(E * size // unit,", "tiles = (E * size // unit) // (", 0),
    (round_launch, "output", "round tile of one unit a thread",
     'tile = c["THREADS"] * c["UNROLL"] * unit // size', 'tile = c["THREADS"] * unit // size', 0),
    (round_launch, "grid", "round receivers and slots swapped", "grid=(tiles, k, n)",
     "grid=(tiles, n, k)", 0),
    (round_launch, "mask", "round ragged tile unmasked", "out_blocks=(Footprint(pair, masked=(2,)),)",
     "out_blocks=(Footprint(pair),)", 0),
]

# (source, kernel, name, old, new, occurrence): one edit of a kernel body
BODY_MUTANTS = [
    ("matmul/csrc/matmul.cu", "matmul_kernel", "fma store without from_f32",
     "dst[j] = from_f32<T>(acc[i][4 * h + j]);", "dst[j] = acc[i][4 * h + j];", 0),
    ("matmul/csrc/matmul.cu", "matmul_kernel", "fma 16-byte store without from_f32",
     "make_float4(from_f32<float>(acc[i][4 * h]), from_f32<float>(acc[i][4 * h + 1]),\n"
     "                          from_f32<float>(acc[i][4 * h + 2]), from_f32<float>(acc[i][4 * h + 3]))",
     "make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3])", 0),
    ("matmul/csrc/matmul.cu", "matmul_kernel", "fma dead parameter",
     "int M, int N, int K) {", "int M, int N, int K, int unused) {", 0),
    ("matmul/csrc/matmul_sm90.cu", "matmul_sm90_kernel", "wgmma store without bf16 packing",
     "pack_bf16x2(acc[4 * j], acc[4 * j + 1])", "__float_as_uint(acc[4 * j])", 0),
    ("flash/csrc/flash.cu", "flash_fwd_kernel", "fma store without from_f32",
     "from_f32<T>(acc[r][i][e] * inv)", "(acc[r][i][e] * inv)", 0),
    ("flash/csrc/flash.cu", "flash_fwd_kernel", "fma 16-byte store without from_f32",
     "from_f32<float>(acc[r][i][0] * inv), from_f32<float>(acc[r][i][1] * inv),\n"
     "              from_f32<float>(acc[r][i][2] * inv), from_f32<float>(acc[r][i][3] * inv)",
     "acc[r][i][0] * inv, acc[r][i][1] * inv, acc[r][i][2] * inv, acc[r][i][3] * inv", 0),
    ("flash/csrc/flash.cu", "flash_fwd_kernel", "fma dead q_offset_blocks",
     "float sm_scale) {", "float sm_scale, int q_offset_blocks) {", 0),
    ("flash/csrc/flash_sm90.cu", "flash_sm90_kernel", "wgmma dead parameter",
     "float scale_log2) {", "float scale_log2, int unused) {", 0),
    ("ssd/csrc/ssd.cu", "ssd_outputs_kernel", "outputs store without from_f32",
     "from_f32<T>(yd[i][j] + ecum[t] * yo[i][j])", "(yd[i][j] + ecum[t] * yo[i][j])", 0),
    ("ssd/csrc/ssd.cu", "ssd_outputs_kernel", "outputs 16-byte store without from_f32",
     "make_float4(from_f32<float>(yd[i][4 * h] + ecum[t] * yo[i][4 * h]),\n"
     "                            from_f32<float>(yd[i][4 * h + 1] + ecum[t] * yo[i][4 * h + 1]),\n"
     "                            from_f32<float>(yd[i][4 * h + 2] + ecum[t] * yo[i][4 * h + 2]),\n"
     "                            from_f32<float>(yd[i][4 * h + 3] + ecum[t] * yo[i][4 * h + 3]))",
     "make_float4(yd[i][4 * h] + ecum[t] * yo[i][4 * h],"
     " yd[i][4 * h + 1] + ecum[t] * yo[i][4 * h + 1],"
     " yd[i][4 * h + 2] + ecum[t] * yo[i][4 * h + 2],"
     " yd[i][4 * h + 3] + ecum[t] * yo[i][4 * h + 3])",
     0),
    ("ssd/csrc/ssd.cu", "ssd_states_kernel", "fma states dead parameter",
     "int P, int N, int L, int bc_per_head) {",
     "int P, int N, int L, int bc_per_head, int unused) {", 0),
    ("ssd/csrc/ssd_common.cuh", "ssd_recurrence_kernel", "fin stored without from_f32",
     "fin[i] = from_f32<FT>(R);", "fin[i] = R;", 0),
    ("ssd/csrc/ssd_common.cuh", "ssd_recurrence_kernel", "before stored without from_f32",
     "r[(int64_t)(c0 + u) * PN] = from_f32<RT>(R);", "r[(int64_t)(c0 + u) * PN] = R;", 0),
    ("ssd/csrc/ssd_sm90.cu", "ssd_states_sm90_kernel", "states dead parameter",
     "int nc, int bc_per_head) {", "int nc, int bc_per_head, int chunk) {", 0),
    ("ssd/csrc/ssd_sm90.cu", "ssd_outputs_sm90_kernel", "Y stored without bf16 packing",
     "pack_bf16x2(acc[4 * j], acc[4 * j + 1]);", "__float_as_uint(acc[4 * j]);", 0),
    ("ssd/csrc/ssd_sm90_tiled.cu", "ssd_outputs_sm90_tiled_kernel",
     "wgmma_tiled Y stored without bf16 packing", "pack_bf16x2(acc[4 * q], acc[4 * q + 1]);",
     "__float_as_uint(acc[4 * q]);", 0),
    ("ssd/csrc/ssd_sm90_tiled.cu", "ssd_recurrence_pair_kernel",
     "wgmma_tiled before's lo stored without bf16 packing",
     "make_uint2(pack_bf16x2(R.x - h0.x, R.y - h0.y), pack_bf16x2(R.z - h1.x, R.w - h1.y));",
     "make_uint2(__float_as_uint(R.x - h0.x), __float_as_uint(R.z - h1.x));", 0),
    ("ssd/csrc/ssd_sm90_tiled.cu", "ssd_states_sm90_tiled_kernel",
     "wgmma_tiled states dead parameter", "int N, int nc,\n                             int bc_per_head) {",
     "int N, int nc,\n                             int bc_per_head, int chunk) {", 0),
    ("rounds/csrc/rounds.cu", "stacked_round_kernel", "round dead parameter",
     "long long dst_slots, long long row_units) {",
     "long long dst_slots, long long row_units, int k) {", 0),
]

TRITON_MUTANTS = [
    ("rmsnorm x load without fp32 upcast", "mask=mask, other=0.0).to(tl.float32)\n    w",
     "mask=mask, other=0.0)\n    w", "low-precision-read"),
    ("rmsnorm store without its cast", "y.to(o_ptr.dtype.element_ty)", "y", "missing-store-cast"),
    ("rmsnorm dead parameter", "eps, BLOCK: tl.constexpr):", "eps, unused, BLOCK: tl.constexpr):",
     "dead-param"),
    ("rmsnorm eps multiplied by zero", "tl.rsqrt(var + eps)", "tl.rsqrt(var + eps * 0)",
     "dead-param"),
]


def _replace_nth(text, old, new, nth):
    at = -1
    for _ in range(nth + 1):
        at = text.index(old, at + 1)
    return text[:at] + new + text[at + len(old):]


def _mutated(module, old, new, nth):
    """``module`` re-executed from its source with one edit."""
    source = inspect.getsource(module)
    assert source.count(old) > nth, (module.__name__, old)
    namespace = {"__name__": module.__name__ + "_mutant", "__file__": module.__file__}
    exec(compile(_replace_nth(source, old, new, nth), module.__file__, "exec"), namespace)
    return namespace


def _killed_by(call_sites, probes):
    kinds = set()
    for args, kwargs in probes:
        try:
            sites = call_sites(*args, **kwargs)
        except Exception as e:  # a model that crashes does not pass either
            kinds.add(f"crash: {type(e).__name__}")
            continue
        kinds |= _kinds(lint.analyze_call_site(s) for s in sites)
    return kinds


def _body_sites(tmp_path, source, kernel_name, text):
    """Every probe's call sites, with ``kernel_name``'s body read from
    ``text`` (written beside the test)."""
    path = tmp_path / f"{kernel_name}_{abs(hash(text))}{Path(source).suffix}"
    path.write_text(text)
    for module, probes in PROBES.items():
        for args, kwargs in probes:
            for site in module.call_sites(*args, **kwargs):
                k = site.kernel
                if isinstance(k, model.CudaKernel) and k.name == kernel_name:
                    yield dataclasses.replace(site, kernel=dataclasses.replace(k, source=path))


def _triton_kernel(tmp_path, old, new):
    source = inspect.getsource(k2._rmsnorm_kernel)
    assert source.count(old) == 1, old
    path = tmp_path / f"mutant_{abs(hash((old, new)))}.py"
    header = "from __future__ import annotations\n\ntl = None\n\n\n"
    path.write_text(header + source.replace(old, new))
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module._rmsnorm_kernel


def _corpus(tmp_path):
    """(name, category, kinds that killed it) of every mutant."""
    results = []
    for module, category, name, old, new, nth in MODEL_MUTANTS:
        ns = _mutated(module, old, new, nth)
        results.append((name, category, _killed_by(ns["call_sites"], PROBES[module])))
    for source, kernel_name, name, old, new, nth in BODY_MUTANTS:
        text = _replace_nth((KERNELS / source).read_text(), old, new, nth)
        kinds = _kinds(lint.analyze_call_site(s)
                       for s in _body_sites(tmp_path, source, kernel_name, text))
        results.append((name, "body", kinds))
    [[(args, kwargs)]] = [PROBES[k2_launch]]
    for name, old, new, _ in TRITON_MUTANTS:
        body = _triton_kernel(tmp_path, old, new)
        kinds = _kinds(lint.analyze_call_site(dataclasses.replace(s, kernel=body))
                       for s in k2_launch.call_sites(*args, **kwargs))
        results.append((name, "body", kinds))
    return results


def test_port_mutation_corpus_kill_rate(tmp_path):
    results = _corpus(tmp_path)
    assert len(results) >= 50
    survivors = [(name, cat) for name, cat, kinds in results if not kinds]
    for name, cat in survivors:
        assert cat == "input", f"{cat} mutant survived: {name}"
    killed = len(results) - len(survivors)
    assert killed / len(results) >= 0.85, (killed, len(results), survivors)
    # the survivors are exactly the input maps that stay in bounds
    assert sorted(name for name, _ in survivors) == sorted([
        "wgmma x reads K only", "rmsnorm weight reads one element", "wgmma causal limit dropped",
        "wgmma GQA map dropped", "wgmma X half the chunk", "recurrence totals first chunk only",
    ])


def _site(module, i=0, probe=0):
    args, kwargs = PROBES[module][probe]
    return module.call_sites(*args, **kwargs)[i]


def test_pinned_mutants_are_killed(tmp_path):
    """One mutant per rule, pinned apart from the corpus."""
    def kinds_of(module, old, new, nth=0, probe=0):
        ns = _mutated(module, old, new, nth)
        return _killed_by(ns["call_sites"], [PROBES[module][probe]])

    assert kinds_of(k1_launch, "grid=(cdiv(M, BM), cdiv(N, BN))",
                    "grid=(M // BM, cdiv(N, BN))", probe=1) == {"coverage-gap"}
    assert "write-race" in kinds_of(k1_launch, "return [Box((bx * BM, by * BN), (BM, BN))]",
                                    "return [Box((bx * BM, 0), (BM, BN))]", probe=2)
    assert kinds_of(k2_launch, "out_blocks=(Footprint(row, masked=(1,)),)",
                    "out_blocks=(Footprint(row),)") == {"oob-write"}
    assert kinds_of(k3_launch, "in_blocks=(Footprint(qo, masked=(1,)), Footprint(kv, masked=(1,)),",
                    "in_blocks=(Footprint(qo, masked=(1,)), Footprint(kv),",
                    probe=2) == {"oob-read"}
    assert "smem-budget" in kinds_of(k4_launch, "smem = 1024 + 3 * tile_bytes",
                                     "smem = 1024 + 30 * tile_bytes")
    assert kinds_of(k4_launch, "for b, ch, hg, m0, n0 in ([] if x < sb else",
                    "for b, ch, hg, m0, n0 in ([] if x <= sb else", probe=4) == {"coverage-gap"}
    big = dataclasses.replace(_site(k1_launch), grid=(1 << 18,))
    assert _kinds([lint.analyze_call_site(big)]) == {"grid-unenumerable"}
    assert _kinds([lint.analyze_call_site(dataclasses.replace(_site(k1_launch), grid=(0,)))]) == {
        "grid-empty"}
    limits = dataclasses.replace(_site(k1_launch, probe=1), threads=2048)
    assert _kinds([lint.analyze_call_site(limits)]) == {"grid-limit"}
    text = (KERNELS / "flash/csrc/flash.cu").read_text().replace(
        "float sm_scale) {", "float sm_scale, int q_offset_blocks) {")
    [dead] = [v for s in _body_sites(tmp_path, "flash/csrc/flash.cu", "flash_fwd_kernel", text)
              for v in lint.analyze_call_site(s).violations][:1]
    assert (dead.kind, dead.operand) == ("dead-param", "q_offset_blocks")
    for name, old, new, kind in TRITON_MUTANTS:
        body = _triton_kernel(tmp_path, old, new)
        got = lint.analyze_call_site(dataclasses.replace(_site(k2_launch), kernel=body))
        assert _kinds([got]) == {kind}, name


def test_the_exact_coverage_attributes_gaps_and_races():
    site = _site(k1_launch, probe=1)  # fma (300x130)@(130x200): grid (3, 2)
    gap = dataclasses.replace(site, grid=(2, 2))
    [v] = lint.analyze_call_site(gap).violations
    assert (v.kind, v.box) == ("coverage-gap", (256, 0))
    assert "8800 of 60000 elements" in v.detail
    race = site.with_out_block(0, model.Footprint(
        lambda bx, by: [model.Box((min(bx, 1) * 128, by * 128), (128, 128))], masked=(0, 1)))
    kinds = [v.kind for v in lint.analyze_call_site(race).violations]
    assert kinds == ["write-race", "coverage-gap"]


def test_the_body_rules_see_every_cuda_kernel():
    """A body rule that cannot read a kernel raises rather than passing."""
    for module, probes in PROBES.items():
        for args, kwargs in probes:
            for site in module.call_sites(*args, **kwargs):
                summary = lint.summarize_kernel(site.kernel, in_params=site.in_names,
                                                out_params=site.out_names)
                assert summary.parsed and summary.params, site.name
    with pytest.raises(model.CaptureError):
        lint.summarize_kernel(model.CudaKernel(KERNELS / "matmul/csrc/matmul.cu", "no_kernel"))
    outputs = {s.name: lint.summarize_kernel(s.kernel).out_params
               for s in k4_launch.call_sites(*PROBES[k4_launch][2][0], **PROBES[k4_launch][2][1])}
    assert outputs == {"ssd_states_kernel": (), "ssd_recurrence_kernel": ("before", "fin"),
                       "ssd_outputs_kernel": ("Y",)}


# ------------------------------------------- constants read from the sources

MODEL_CONSTANTS = {
    "matmul/csrc/matmul_sm90.cu": ("BM", "BN", "BK", "STAGES", "THREADS", "GROUP_M"),
    "matmul/csrc/matmul.cu": ("BM", "BN", "BK", "STAGES", "THREADS", "XPAD"),
    "flash/csrc/flash_sm90.cu": ("BQ", "BKV", "THREADS"),
    "flash/csrc/flash.cu": ("BQ", "BK", "STAGES", "THREADS", "WQ"),
    "ssd/csrc/ssd.cu": ("THREADS", "TILE", "BK", "BKN", "SCORE_BK", "PAD", "WIDE", "HEADS",
                        "SCORE_TILES", "STATES_ITEMS", "OUTPUTS_ITEMS", "FILL", "STATES_STAGES",
                        "OUTPUTS_STAGES", "FACTS"),
    "ssd/csrc/ssd_sm90.cu": ("L", "THREADS"),
    "ssd/csrc/ssd_sm90_tiled.cu": ("L", "THREADS", "STATES_STAGES", "OUTPUTS_STAGES", "OUT_ROW",
                                   "PAIR_VEC"),
    "ssd/csrc/ssd_common.cuh": ("RECURRENCE_THREADS",),
    "rounds/csrc/rounds.cu": ("THREADS", "UNROLL"),
}


@pytest.mark.parametrize("source", sorted(MODEL_CONSTANTS))
def test_model_constants_are_literals_in_the_sources(source, tmp_path):
    path = KERNELS / source
    found = model.source_constants(path, MODEL_CONSTANTS[source])
    assert all(isinstance(v, int) and v > 0 for v in found.values())
    # every source_constants call of the launch models asks only for these
    for module in (k1_launch, k3_launch, k4_launch, round_launch):
        text = inspect.getsource(module)
        for names in re.findall(r"source_constants\(\w+, \(([^)]*)\)\)", text):
            asked = set(re.findall(r'"(\w+)"', names))
            assert any(asked <= set(v) for v in MODEL_CONSTANTS.values()), asked
    name = MODEL_CONSTANTS[source][0]
    text = path.read_text()
    broken = tmp_path / path.name
    broken.write_text(re.sub(rf"(constexpr int {name} = )\d+", r"\g<1>2 * 32", text, count=1))
    with pytest.raises(ValueError, match="not an integer literal"):
        model.source_constants(broken, (name,))
    broken.write_text(text.replace(f"int {name} =", "int X_ ="))
    with pytest.raises(ValueError, match="no constexpr"):
        model.source_constants(broken, (name,))


def test_a_tile_change_in_the_source_moves_the_model(monkeypatch, tmp_path):
    """The model follows the source: STAGES 4 -> 5 puts K1's wgmma route over
    Hopper's shared memory."""
    source = tmp_path / "matmul_sm90.cu"
    source.write_text((KERNELS / "matmul/csrc/matmul_sm90.cu").read_text().replace(
        "constexpr int STAGES = 4;", "constexpr int STAGES = 5;"))
    monkeypatch.setattr(k1_launch, "SOURCE_SM90", source)
    assert "smem-budget" in _kinds([lint.analyze_call_site(_site(k1_launch))])


def _note(source: Path) -> str:
    """The comment lines of ``source``'s head, as one line of prose."""
    lines = []
    for line in source.read_text().splitlines():
        if not line.startswith("//"):
            break
        lines.append(line[2:].strip())
    return " ".join(" ".join(lines).split())


def _k1_figures(_):
    f = k1_launch.fma_feed(32768, 12288, 3584)
    return [f"{f['tile'][0]}x{f['tile'][1]} register tile",
            f"{f['fmas']} FMAs: {f['fmas'] / f['loads']:.1f} FMAs a 16-byte load, "
            f"{f['fmas'] / (4 * f['loads']):.1f} a word",
            f"{f['smem']:,} a block"]


def _k3_figures(D):
    f = k3_launch.fma_feed(D)
    qk, pv, words = f["qk_loads"], f["pv_loads"] + f["pv_shuffles"], 4 * f["pv_loads"] + 4
    figures = [f"{f['smem']:,} B at D = {D}"]
    if D == 128:
        figures += [f"owns the {f['tile'][0]}x{f['tile'][1]} scores",
                    f"{f['tile'][0]} q and {f['tile'][1]} k loads feed {f['qk_fmas']} FMAs "
                    f"({f['qk_fmas'] / qk:g} a 16-byte load, {f['qk_fmas'] / (4 * qk):g} a word)",
                    f"{f['pv_shuffles']} shuffles and {f['pv_loads']} loads feed {f['pv_fmas']} "
                    f"FMAs a column ({f['pv_fmas'] / pv:g} a load or shuffle, "
                    f"{f['pv_fmas'] / words:.1f} a word"]
    else:
        figures += [f"D = {D}: {f['pv_loads']} loads, {f['pv_fmas']} FMAs, "
                    f"{f['pv_fmas'] / words:.1f} a word"]
    return figures


def _k4_figures(shape):
    f = k4_launch.fma_feed(*shape)
    [(loads, fmas)] = set(f["products"].values())  # every product of passes 1 and 3 alike
    assert fmas / (4 * loads) >= 4 and max(f["smem"]) <= 232448
    return [f"{f['tile'][0]}x{f['tile'][1]} register tile",
            f"{loads} loads feed {fmas} FMAs, {fmas / loads:.1f} FMAs a 16-byte load, "
            f"{fmas / (4 * loads):.1f} a word",
            f"{f['stages'][0]} stages in pass 1 ({f['smem'][0]:,} B a block at L = 64",
            f"{f['stages'][1]} in pass 3 ({f['smem'][1]:,} B a block)"]


@pytest.mark.parametrize("source, figures, arg", [
    ("matmul/csrc/matmul.cu", _k1_figures, None),
    ("flash/csrc/flash.cu", _k3_figures, 128),
    ("flash/csrc/flash.cu", _k3_figures, 80),
    ("ssd/csrc/ssd.cu", _k4_figures, (4, 4096, 80, 64, 64, 64, False)),
    ("ssd/csrc/ssd.cu", _k4_figures, (4, 4096, 4, 1024, 512, 64, True)),
], ids=["k1", "k3-d128", "k3-d80", "k4-zamba2", "k4-mlstm"])
def test_fma_source_notes_state_the_launch_models_figures(source, figures, arg):
    """The CUDA-core routes' source notes give the register tile, FMAs a
    shared-memory load and word, and shared memory a block that the launch
    models work out from the sources' tile sizes (which the card run
    prints beside each time), so neither drifts from the code alone."""
    note = _note(KERNELS / source)
    for figure in figures(arg):
        assert figure in note, figure


# --------------------------------------------- (c) shipped and main-path cases


SHIPPED = lint.shipped_kernel_cases()


@pytest.mark.parametrize("case", SHIPPED, ids=[c[0] for c in SHIPPED])
def test_shipped_cases_are_clean(case):
    label, fn, args, kwargs = case
    reports = lint.analyze_callable(fn, *args, **kwargs)
    assert reports and all(r.ok and r.programs_checked > 0 for r in reports), [
        str(r) for r in reports]


def test_shipped_cases_reach_every_launch_site():
    seen = set()
    for label, fn, args, kwargs in SHIPPED:
        seen |= {(s.name, s.source) for s in model.capture_call_sites(fn, *args, **kwargs)}
    assert {name for name, _ in seen} == {
        "matmul_sm90_kernel", "matmul_kernel", "_rmsnorm_kernel", "flash_sm90_kernel",
        "flash_fwd_kernel", "ssd_states_kernel", "ssd_outputs_kernel", "ssd_states_sm90_kernel",
        "ssd_outputs_sm90_kernel", "ssd_recurrence_kernel", "ssd_states_sm90_tiled_kernel",
        "ssd_recurrence_pair_kernel", "ssd_outputs_sm90_tiled_kernel", "stacked_round_kernel"}


def test_main_path_shapes_are_clean_in_time():
    t = time.perf_counter()
    for label, fn, args, kwargs in lint.main_path_cases():
        for r in lint.analyze_callable(fn, *args, **kwargs):
            assert r.ok, f"{label}: {r}"
            assert r.programs_checked <= lint.MAX_PROGRAMS
    assert time.perf_counter() - t < 60


def test_capture_refuses_what_it_cannot_model():
    with pytest.raises(model.CaptureError):
        model.capture_call_sites(lambda x: x, _meta(4))
    with pytest.raises(model.CaptureError):  # head dim over 128: nothing launches
        model.capture_call_sites(flash_attention_cuda, _meta(1, 8, 1, 256), _meta(1, 8, 1, 256),
                                 _meta(1, 8, 1, 256))


# --------------------------------------------------------------- (d) the gate


def _cpu_cases():
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=F32):
        return torch.randn(*shape, generator=g).to(dtype)

    return [
        ("matmul:wgmma", matmul_cuda, (r(100, 64, dtype=BF16), r(64, 72, dtype=BF16)), {}),
        ("matmul:fma", matmul_cuda, (r(30, 20), r(20, 10)), {}),
        ("rmsnorm:triton", rmsnorm_triton, (r(4, 6), r(6)), {"eps": 1e-5}),
        ("flash:fma", flash_attention_cuda, (r(1, 9, 2, 8), r(1, 9, 1, 8), r(1, 9, 1, 8)),
         {"causal": True}),
        ("ssd:fma", ssd_cuda, (r(1, 20, 2, 4), r(1, 20, 2), r(1, 20, 3), r(1, 20, 3)),
         {"chunk": 8}),
        ("round:inplace", stacked_round_cuda,
         (r(4, 4, 24), torch.arange(4).flip(0), torch.arange(8).view(4, 2) % 2 + 2,
          torch.arange(8).view(4, 2) % 2, 4, 2),
         {"out": r(4, 4, 24), "reduce": True, "route": "inplace"}),
    ]


@pytest.mark.parametrize("case", _cpu_cases(), ids=lambda c: c[0])
def test_gate_runs_before_the_device_check(case, monkeypatch):
    """A clean model passes the gate, then the wrapper's device check raises;
    a corrupted model raises KernelLintError first; a hit analyzes nothing."""
    label, fn, args, kwargs = case
    monkeypatch.setenv("PCCL_VERIFY", "1")
    lint.clear_verified_cache()
    with pytest.raises(ValueError, match="CUDA device"):
        fn(*args, **kwargs)
    assert lint.gate_counts() == {label: {"misses": 1, "hits": 0}}
    calls = []
    real = lint.analyze_callable
    monkeypatch.setattr(lint, "analyze_callable", lambda *a, **k: calls.append(1) or real(*a, **k))
    with pytest.raises(ValueError, match="CUDA device"):
        fn(*args, **kwargs)
    assert calls == [] and lint.gate_counts()[label] == {"misses": 1, "hits": 1}

    module = importlib.import_module(model.LAUNCH_MODELS[f"{fn.__module__}.{fn.__qualname__}"])
    clean = module.call_sites

    def corrupted(*a, **k):  # one block short: a gap, or an empty grid
        sites = clean(*a, **k)
        return [dataclasses.replace(sites[0], grid=(sites[0].grid[0] - 1,) + sites[0].grid[1:])]

    monkeypatch.setattr(module, "call_sites", corrupted)
    lint.clear_verified_cache()
    with pytest.raises(lint.KernelLintError):
        fn(*args, **kwargs)
    lint.clear_verified_cache()


def test_gate_is_off_without_the_variable(monkeypatch):
    monkeypatch.delenv("PCCL_VERIFY", raising=False)
    lint.clear_verified_cache()
    for label, fn, args, kwargs in _cpu_cases():
        with pytest.raises(ValueError, match="CUDA device"):
            fn(*args, **kwargs)
    assert lint.gate_counts() == {}


ROUND_MAIN = [c for c in lint.main_path_cases() if c[1] is stacked_round_cuda]


@pytest.mark.parametrize("case", ROUND_MAIN, ids=[c[0] for c in ROUND_MAIN])
def test_main_path_round_cases_meet_the_gate_as_the_wrapper_does(case, monkeypatch):
    """``chip_smoke.py`` path 13d times the gate's hits with a main-path
    case's own arguments: for the round kernel they must be the ones its
    wrapper hands the gate, so the first call is the one miss and the
    case's replay a hit."""
    label, fn, args, kwargs = case
    monkeypatch.setenv("PCCL_VERIFY", "1")
    lint.clear_verified_cache()
    with pytest.raises(ValueError, match="CUDA device"):
        fn(*args, **kwargs)
    [gate] = lint.gate_counts()
    verify_launch(gate, fn, args, kwargs)
    assert lint.gate_counts() == {gate: {"misses": 1, "hits": 1}}
    lint.clear_verified_cache()


def test_gate_memo_is_bounded_and_cleared_by_clear_exec_caches(monkeypatch):
    monkeypatch.setenv("PCCL_VERIFY", "1")
    lint.clear_verified_cache()
    w = torch.ones(8)
    for rows in range(1, lint._VERIFIED_MAX + 1):
        lint.verify_entry_point("rmsnorm:triton", rmsnorm_triton, (torch.ones(rows, 8), w))
    assert len(lint._VERIFIED) == lint._VERIFIED_MAX
    lint.verify_entry_point("rmsnorm:triton", rmsnorm_triton, (torch.ones(1000, 8), w))
    assert len(lint._VERIFIED) == 1  # full: cleared whole, then the new signature
    exec_engine.clear_exec_caches()
    assert len(lint._VERIFIED) == 0 and lint.gate_counts() == {}


def test_clear_exec_caches_does_not_import_the_lint():
    import subprocess

    code = ("import sys; from repro_torch.comm import exec_engine; "
            "exec_engine.clear_exec_caches(); "
            "print('repro_torch.analysis.kernel_lint' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_gate_memo_under_racing_threads(monkeypatch):
    monkeypatch.setenv("PCCL_VERIFY", "1")
    lint.clear_verified_cache()
    errors = []
    w = torch.ones(4)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def worker(seed):
        try:
            for i in range(40):
                rows = 1 + (seed * 7 + i) % 300
                lint.verify_entry_point("rmsnorm:triton", rmsnorm_triton,
                                        (torch.ones(rows, 4), w))
        except Exception as e:  # collected for the assertion below
            errors.append(e)

    try:
        threads = [threading.Thread(target=worker, args=(s,)) for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert not errors
    counts = lint.gate_counts()["rmsnorm:triton"]
    assert counts["misses"] + counts["hits"] == 16 * 40
    assert len(lint._VERIFIED) <= lint._VERIFIED_MAX
    lint.clear_verified_cache()


@pytest.mark.parametrize("collective", ["all_reduce", "reduce_scatter", "all_gather",
                                        "all_to_all"])
def test_donation_compatible_matches_the_reference(collective):
    for shape in [(8, 16), (8, 16, 3), (4, 6), (2, 3, 5), (8,), (1, 1), (3, 9, 2), (16, 64)]:
        assert exec_engine.donation_compatible(collective, shape) == \
            ref_engine.donation_compatible(collective, shape), (collective, shape)
    assert exec_engine.donation_compatible("broadcast", (8, 8)) is False


def test_kernel_lint_exports_resolve():
    import repro_torch.analysis as analysis

    assert analysis.KernelReport is lint.KernelReport
    assert analysis.verify_entry_point is lint.verify_entry_point
    assert analysis.whole_array_box is model.whole_array_box
    assert analysis.capture_call_sites is model.capture_call_sites
    assert set(lint.UNPORTED_RULES) | set(lint.KINDS) >= set(ref_lint.KINDS) - {"vmem-budget"}
