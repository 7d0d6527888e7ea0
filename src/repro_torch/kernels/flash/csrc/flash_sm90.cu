// K3 on the tensor cores: bf16 causal / non-causal GQA flash-attention
// forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash/kernel.py::flash_attention_pallas
// (body _flash_fwd_kernel) for bf16 operands with D % 16 == 0 and D <= 128;
// fp32 and other D stay on the CUDA-core kernel in flash.cu.  The same
// function: q (B,S,H,D), k/v (B,T,K,D); q head h reads kv head h / (H/K)
// by coordinate (no repeat); online softmax with running max m, normaliser
// l and accumulator O in fp32; the output O / max(l, 1e-30) in bf16.  Two
// numeric differences from the Pallas kernel and the plain version, both
// within the bf16 tolerance: sm_scale (times log2 e, for exp2) multiplies
// the fp32 scores instead of q, and P is rounded to bf16 before P V.
//
// What bounds it on the card: at Zamba2 prefill (4, 4096, 32, 80) causal it
// does 2*B*H*S^2*D ~ 3.4e11 operations on ~0.34 GB of q, k, v and o: ~1000
// operations per byte, far above the H100's ~295 for bf16, so it is bound
// by the tensor cores (989 TFLOP/s).
//
// What the design does about it: one block per (b*H + h, 128-row q tile),
// heavy (late, causal) tiles launched first.  Two consumer warpgroups own
// 64 q rows each; one producer thread loads the Q tile once and streams
// 128-row K and V tiles through a 2-stage ring with TMA (4-D tensor maps
// over (D, heads, seq, B), 128-byte swizzle, full/empty mbarriers armed
// with the stage's byte count).  S = Q K^T is wgmma.m64n128k16 with both
// operands K-major in shared memory, D/16 k-steps; the online softmax runs
// on the fp32 accumulator fragments in registers (quad shuffles for the
// row max and sum, exp2f); P is rounded to bf16 in registers and fed back
// as the register A operand of O += P V (the accumulator layout of
// m64n128 is the A-fragment layout of its k16 slices), with V the
// MN-major B operand (D contiguous) and N = D.  KV tiles above the causal
// diagonal are skipped; only the diagonal and ragged-edge tiles are
// masked.  setmaxnreg moves registers from the producer warpgroup (24) to
// the consumers (240).
//
// Head dims that are not a multiple of 64 (Zamba2's D = 80): a row of 160
// bytes does not fit one 128-byte swizzle atom, so D is loaded as two
// 64-column TMA boxes; the tensor map's inner extent is D, so TMA
// zero-fills columns D..127.  Q K^T runs over the D/16 k-steps that hold
// data (5 for D = 80), each inside one box; P V reaches the second box of
// V through the descriptor's leading byte offset (the stride between
// 64-column blocks of an MN-major operand).  Ragged S and T arrive as zeros
// from TMA, are masked in the scores, and are not stored.

#include "../../csrc/sm90.cuh"

namespace {

using namespace sm90;

constexpr int BQ = 128;                   // q rows per block, 64 per consumer warpgroup
constexpr int BKV = 128;                  // kv rows per tile
constexpr int THREADS = 384;              // 2 consumer warpgroups + 1 producer warpgroup
constexpr int BOX_BYTES = 128 * 64 * 2;   // one TMA box: 128 rows x 64 bf16
constexpr float NEG = -1e30f;

// D(64x128, fp32) (+)= A(64x16, smem, K-major) * B(16x128, smem, K-major): S = Q K^T
__device__ __forceinline__ void wgmma_m64n128k16_ss_tb0(float* d, uint64_t da, uint64_t db,
                                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64xN, fp32) += A(64x16, bf16 registers) * B(16xN, smem, MN-major): O += P V
template <int N>
__device__ __forceinline__ void wgmma_rs_tb1(float* d, const uint32_t* a, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs_tb1<16>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb1<32>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb1<48>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb1<64>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb1<80>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb1<96>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb1<112>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb1<128>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// NB = 64-column boxes per row of D (1 for D <= 64, else 2)
template <int NB>
constexpr int smem_bytes() {
  return 1024 + NB * BOX_BYTES /* Q */ + 2 * (2 * NB * BOX_BYTES) /* 2 stages of K, V */ + 5 * 8;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o, int S,
                  int T, int H, int K, int causal, float scale_log2) {
  constexpr int NB = (D + 63) / 64;
  constexpr int Q_BYTES = NB * BOX_BYTES;
  constexpr int STAGE_BYTES = 2 * NB * BOX_BYTES;  // K then V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t qs = base;
  const uint32_t bars = base + Q_BYTES + 2 * STAGE_BYTES;
  const uint32_t qbar = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (3 + s); };
  auto ks = [&](int s) { return base + Q_BYTES + s * STAGE_BYTES; };

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / K);  // GQA: kv head of q head h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heavy (late) tiles first
  int n_kv = (T + BKV - 1) / BKV;
  if (causal) n_kv = min(n_kv, (min(q0 + BQ, S) - 1) / BKV + 1);  // causal => S == T

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer warpgroup: one thread issues every TMA load
    regs_dealloc<24>();
    if (threadIdx.x == 256) {
      prefetch_tensormap(&qmap);
      prefetch_tensormap(&kmap);
      prefetch_tensormap(&vmap);
      mbar_arrive_expect_tx(qbar, Q_BYTES);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) tma_load_4d(qs + nb * BOX_BYTES, &qmap, qbar, 64 * nb, h, q0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < n_kv; ++kt) {
        mbar_wait(empty(stage), phase ^ 1);
        mbar_arrive_expect_tx(full(stage), STAGE_BYTES);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          tma_load_4d(ks(stage) + nb * BOX_BYTES, &kmap, full(stage), 64 * nb, kh, kt * BKV, b);
          tma_load_4d(ks(stage) + (NB + nb) * BOX_BYTES, &vmap, full(stage), 64 * nb, kh, kt * BKV, b);
        }
        if (++stage == 2) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // consumer warpgroup wg: q rows q0 + 64*wg .. +63
    regs_alloc<240>();
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    // fragment rows: this thread holds rows r0 (h = 0) and r0 + 8 (h = 1);
    // element 4j + 2h + e is column 8j + 2*(lane%4) + e
    const int r0 = q0 + wg * 64 + (t / 32) * 16 + lane / 4;
    const int c0 = 2 * (lane % 4);
    const uint32_t qa = qs + wg * (64 * 128);  // this warpgroup's rows in each Q box

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    float m_0 = NEG, m_1 = NEG, l_0 = 0.0f, l_1 = 0.0f;  // l: this thread's partial sums

    mbar_wait(qbar, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < n_kv; ++kt) {
      mbar_wait(full(stage), phase);
      const uint32_t kb = ks(stage);
      const uint32_t vb = kb + NB * BOX_BYTES;

      float s[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = 0.0f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * BOX_BYTES + 32 * (kk % 4);
        wgmma_m64n128k16_ss_tb0(s, desc_sw128(qa + off, 16, 1024), desc_sw128(kb + off, 16, 1024),
                                kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      const int k0 = kt * BKV;
      const bool need_mask = (k0 + BKV > T) || (causal && k0 + BKV - 1 > q0 + wg * 64);
      float mx0 = NEG, mx1 = NEG;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        float v = s[i] * scale_log2;
        if (need_mask) {
          const int col = k0 + 8 * (i / 4) + c0 + (i % 2);
          const int row = r0 + 8 * ((i / 2) % 2);
          if (col >= T || (causal && col > row)) v = NEG;
        }
        s[i] = v;
        if ((i / 2) % 2 == 0) mx0 = fmaxf(mx0, v);
        else mx1 = fmaxf(mx1, v);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m_0, mx0), mn1 = fmaxf(m_1, mx1);
      const float al0 = exp2f(m_0 - mn0), al1 = exp2f(m_1 - mn1);
      m_0 = mn0;
      m_1 = mn1;
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if ((i / 2) % 2 == 0) {
          s[i] = exp2f(s[i] - mn0);
          sum0 += s[i];
        } else {
          s[i] = exp2f(s[i] - mn1);
          sum1 += s[i];
        }
      }
      l_0 = l_0 * al0 + sum0;
      l_1 = l_1 * al1 + sum1;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= ((i / 2) % 2 == 0) ? al0 : al1;

      // P in bf16 as the A fragments of the 8 k16 slices of the kv tile
      uint32_t p[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] = pack_bf16x2(s[2 * i], s[2 * i + 1]);
      fence_regs(acc);
      fence_regs(p);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        // V: +16 kv rows of 128 bytes per k-step; column blocks of 64 a box apart
        wgmma_rs_tb1<D>(acc, &p[4 * kk], desc_sw128(vb + 2048 * kk, BOX_BYTES, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (t == 0) mbar_arrive(empty(stage));
      if (++stage == 2) {
        stage = 0;
        phase ^= 1;
      }
    }

    l_0 += __shfl_xor_sync(0xffffffffu, l_0, 1);
    l_0 += __shfl_xor_sync(0xffffffffu, l_0, 2);
    l_1 += __shfl_xor_sync(0xffffffffu, l_1, 1);
    l_1 += __shfl_xor_sync(0xffffffffu, l_1, 2);
    const float inv0 = 1.0f / fmaxf(l_0, 1e-30f), inv1 = 1.0f / fmaxf(l_1, 1e-30f);
    const int64_t row_stride = (int64_t)H * D;
    __nv_bfloat16* ob = o + ((int64_t)b * S * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + c0;
      if (r0 < S) {
        *reinterpret_cast<uint32_t*>(ob + r0 * row_stride + col) =
            pack_bf16x2(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      }
      if (r0 + 8 < S) {
        *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * row_stride + col) =
            pack_bf16x2(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int T, int H,
           int K, int causal, float sm_scale, void* stream) {
  constexpr int NB = (D + 63) / 64;
  CUtensorMap qmap, kmap, vmap;
  const cuuint32_t box[4] = {64, 1, BQ, 1};  // BQ == BKV
  const cuuint64_t qdims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t qstrides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                  (cuuint64_t)S * H * D * 2};
  const cuuint64_t kdims[4] = {(cuuint64_t)D, (cuuint64_t)K, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t kstrides[3] = {(cuuint64_t)D * 2, (cuuint64_t)K * D * 2,
                                  (cuuint64_t)T * K * D * 2};
  int err = make_map_bf16(&qmap, q, 4, qdims, qstrides, box);
  if (err == 0) err = make_map_bf16(&kmap, k, 4, kdims, kstrides, box);
  if (err == 0) err = make_map_bf16(&vmap, v, 4, kdims, kstrides, box);
  if (err != 0) return err;
  constexpr int smem = smem_bytes<NB>();
  cudaError_t e = cudaFuncSetAttribute(flash_sm90_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float log2e = 1.4426950408889634f;
  dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_sm90_kernel<D><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), S, T, H, K, causal, sm_scale * log2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  bf16 tensors, contiguous and 16-byte
// aligned: q and o (B,S,H,D), k and v (B,T,K,D), H % K == 0, D in
// {16, 32, ..., 128}, causal => S == T.  Returns 0 when the kernel
// launched, else cudaGetLastError() or an sm90.cuh code.
extern "C" int pccl_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, int B,
                                   int S, int T, int H, int K, int D, int causal, float sm_scale,
                                   void* stream) {
#define PCCL_FLASH_D(d) \
  case d:               \
    return launch<d>(q, k, v, o, B, S, T, H, K, causal, sm_scale, stream);
  switch (D) {
    PCCL_FLASH_D(16)
    PCCL_FLASH_D(32)
    PCCL_FLASH_D(48)
    PCCL_FLASH_D(64)
    PCCL_FLASH_D(80)
    PCCL_FLASH_D(96)
    PCCL_FLASH_D(112)
    PCCL_FLASH_D(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PCCL_FLASH_D
}
