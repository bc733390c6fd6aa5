// GEMM core of the fused projections: C = A @ B (plain), or the dual product
// act(A @ Bg) * (A @ Bu) (the MLP's gate/up step), with A (M, K), B (K, N)
// and C (M, N) row-major; f32 accumulation, output in the input dtype.
//
// Shared by qkv_matmul.cu (the fused QKV projection, and the MLP's down
// product) and fused_mlp.cu. They replace the Pallas bodies of
// nxdi_tpu/ops/kernels/fused_proj.py (_matmul_kernel, _qkv_stacked_kernel,
// _fused_mlp_kernel, _fused_mlp_stacked_kernel); the dual epilogue computes
// act(g) * u in f32 and rounds it to the input dtype, the TPU kernel's
// rounding point before its down product.
//
// What bounds a call on this card depends on M, so the wrapper
// (ops/kernels/fused_proj.py::gemm_plan) picks a body per call and passes
// its plan (body, tile, K splits and slice) here.
//
// Both bf16 bodies run one main loop (gemm_tma_body), warp-specialised: a
// producer warp issues TMA loads (128-byte swizzle) of a 64-deep K tile of A
// and of B into a ring of stages guarded by one mbarrier pair each, and
// consumer warpgroups, 64 rows each, run wgmma m64nNk16 on the stages that
// have landed, f32 accumulators in registers. B is the row-major (K, N)
// weight, read by wgmma as a transposed (MN-major) operand, so no copy of
// the weights is made. In the dual mode the B tile's first half is the
// gate's and its second half the up's columns of one output tile, so one
// accumulator holds g and u of the same outputs and the epilogue forms
// act(g) * u. Rows past M arrive as zeros from TMA (a warpgroup whose rows
// all lie past M, beside the 8 tail rows of 520 or 1032, multiplies them).
//
//  - gemm_stream_kernel (M <= 64: the decode step and the small mixed
//    buckets). Bound by the weight bytes: every product streams its (K, N)
//    weight once (12.6 MB for the 2048 x 3072 QKV weight: 3.8 us at 3.35
//    TB/s). One 128-column tile per block would give 24 blocks (QKV) or 16
//    (the down product) on 132 SMs, too few to keep the several MB in flight
//    the memory needs. So the grid is (N tiles x K slices): every block
//    streams one K slice of one column tile through a 4-stage ring (64 KB
//    of weight in flight), one consumer warpgroup on a 64-row tile (rows
//    past M zero), and the plan cuts K so that a block lands on every SM
//    (97 KB of shared memory: two fit, but one each with longer slices
//    streamed faster, scripts/bench_gemm_plans.py). The grid each product
//    gets at each M is gemm_plan's (tests/test_torch_gemm_plan.py).
//  - gemm_wgmma_kernel (M > 64: the packed mixed steps of 128 to 1032
//    rows). Bound by operations (52 GFLOP for the MLP at 520 rows: 53 us at
//    989 TFLOP/s). Two consumer warpgroups on a 128-row tile share each B
//    tile, 128 columns wide (6 stages of 32 KB) or 256 (4 stages of 48 KB,
//    fewer L2 bytes per operation); the plan picks the width, and splits K
//    where the tiles fill the waves badly (the down product at 520 rows).
//  - gemm_splitk_reduce_kernel: a split call writes f32 partials to a
//    (splits, [2,] M, N) workspace, and this pass sums them in slice order
//    (no atomics: the result is the same bits on every call) and applies
//    the epilogue, the dual one included, with its rounding point.
//  - gemm_simt_kernel (f32): 64 x 64 tiles, 16-deep, 256 threads of 4 x 4
//    outputs, f32 on the CUDA cores, so f32 inputs keep f32 products (the
//    correctness runs; no plan beyond it).
//
// K and N must be multiples of 8 (TMA's rows are whole 16-byte chunks).
#pragma once

#include <mutex>

#include "tma_wgmma.cuh"

namespace {

enum GemmAct : int { ACT_SILU = 0, ACT_GELU = 1, ACT_GELU_TANH = 2, ACT_RELU = 3 };
// body codes shared with ops/kernels/fused_proj.py (GEMM_BODIES)
enum GemmBody : int { GEMM_SIMT = 0, GEMM_STREAM = 1, GEMM_WGMMA = 2 };

template <int ACT>
__device__ __forceinline__ float gemm_act(float x) {
  if constexpr (ACT == ACT_SILU) {
    return x / (1.f + expf(-x));
  } else if constexpr (ACT == ACT_GELU) {
    return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
  } else if constexpr (ACT == ACT_GELU_TANH) {
    return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
  } else {
    return fmaxf(x, 0.f);
  }
}

struct GemmArgs {
  const void* a;   // (M, K)
  const void* b;   // (K, N) — the up weight in dual mode
  const void* bg;  // (K, N) — dual mode: the gate weight
  void* c;         // (M, N)
  float* ws;       // split K: (splits, [2,] M, N) f32 partials; null without split
  int M, N, K;
  int k_slice;     // K elements per split (a multiple of the K tile)
};

// The wrapper's choice for one call (fused_proj.py::GemmPlan.args): body,
// output tile rows and columns, K splits, K elements per split.
struct GemmPlan {
  int body, bm, bn, splits, k_slice;
};

// Store two outputs at (row, col), col even: into the workspace as f32
// partials of split `s` (plane 0, or plane 1 for the dual's second operand),
// or rounded to bf16 into C.
__device__ __forceinline__ void gemm_store2(const GemmArgs& p, int s, int plane, int nplanes,
                                            int row, int col, float v0, float v1) {
  if (p.ws) {
    float* w = p.ws + ((long long)(s * nplanes + plane) * p.M + row) * p.N + col;
    *reinterpret_cast<float2*>(w) = make_float2(v0, v1);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.c) + (long long)row * p.N +
                                       col) = __floats2bfloat162_rn(v0, v1);
  }
}

// the epilogue of one pair of outputs: plain (v0, v1), or dual (g, u pairs)
template <bool DUAL, int ACT>
__device__ __forceinline__ void gemm_emit(const GemmArgs& p, int s, int row, int col, float v0,
                                          float v1, float g0, float g1) {
  if constexpr (DUAL) {
    if (p.ws) {
      gemm_store2(p, s, 0, 2, row, col, g0, g1);
      gemm_store2(p, s, 1, 2, row, col, v0, v1);
    } else {
      gemm_store2(p, 0, 0, 1, row, col, gemm_act<ACT>(g0) * v0, gemm_act<ACT>(g1) * v1);
    }
  } else {
    gemm_store2(p, s, 0, 1, row, col, v0, v1);
  }
}

// ---------------------------------------------------------------------------
// The TMA + mbarrier + wgmma main loop of both bf16 bodies
// ---------------------------------------------------------------------------

constexpr int kWBK = 64;              // K tile; a K slice is whole K tiles
constexpr int kWBox = kWBK * 64 * 2;  // one B box: 64 k-rows x 64 columns, 8 KB
// NWG consumer warpgroups of 64 rows each, B tiles BW columns wide: the
// streaming body (NWG 1, BW 128) rings 4 stages of 24 KB (two such blocks
// fit on an SM); the wgmma body (NWG 2) 6 stages of 32 KB (BW 128) or 4 of
// 48 KB (256)
template <int BW, int NWG>
constexpr int kWStages = NWG == 1 ? 4 : BW == 128 ? 6 : 4;
template <int BW, int NWG>
constexpr int kWStage = NWG * 64 * kWBK * 2 + (BW / 64) * kWBox;
template <int BW, int NWG>
constexpr size_t gemm_tma_smem() {
  return (size_t)kWStages<BW, NWG> * kWStage<BW, NWG> + 1024 +
         2 * kWStages<BW, NWG> * sizeof(uint64_t);
}

// D (64 x 128, f32) = A (64 x 16, K-major) * B (16 x 128, MN-major: the
// row-major weight, hence imm-trans-b = 1) + (accumulate ? D : 0)
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 256, f32) = A (64 x 16, K-major) * B (16 x 256, MN-major: the
// row-major weight, hence imm-trans-b = 1) + (accumulate ? D : 0)
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int BW>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da, uint64_t db, int accumulate) {
  if constexpr (BW == 128) {
    wgmma_m64n128k16(d, da, db, accumulate);
  } else {
    wgmma_m64n256k16(d, da, db, accumulate);
  }
}

// grid (M / (64 NWG), N / out width, splits). A tile: 64 NWG rows x 64 k,
// row r at r * 128 B (swizzled); B: BW / 64 boxes of 64 k-rows x 64
// columns, k-row r of a box at r * 128 B. Plain: the boxes are columns
// n0..n0+BW-1 of B (out width BW). Dual: the first half are the gate's and
// the second half the up's columns n0..n0+BW/2-1 (out width BW / 2), so
// accumulator chunk j holds g and chunk j + BW/16 holds u of the same
// outputs. Warps 0 .. 4 NWG - 1 consume; warp 4 NWG produces.
template <bool DUAL, int ACT, int BW, int NWG>
__device__ __forceinline__ void gemm_tma_body(const CUtensorMap* tmA, const CUtensorMap* tmB0,
                                              const CUtensorMap* tmB1, const GemmArgs& p) {
  extern __shared__ uint8_t wsm_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(wsm_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  constexpr int kST = kWStages<BW, NWG>, kStage = kWStage<BW, NWG>, kBoxes = BW / 64;
  constexpr int kBM = 64 * NWG, kTileA = kBM * kWBK * 2;
  const uint32_t sm0 = smem_u32(sm);
  const uint32_t full0 = sm0 + kST * kStage;
  const uint32_t empty0 = full0 + kST * 8;
  // the warp index, broadcast so the compiler knows it is warp-uniform: the
  // role branches then hold no divergence around wgmma
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  constexpr int kOutN = DUAL ? BW / 2 : BW;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kOutN;
  const int kb = blockIdx.z * p.k_slice, ke = min(p.K, kb + p.k_slice);
  const int n_k = (ke - kb + kWBK - 1) / kWBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * NWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // producer
    if (lane == 0) {
      tma_prefetch(tmA);
      tma_prefetch(tmB0);
      tma_prefetch(tmB1);
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kST;
        if (kt >= kST) mbar_wait(empty0 + 8 * s, ((kt / kST) - 1) & 1);
        const uint32_t full = full0 + 8 * s, st = sm0 + s * kStage;
        const int k0 = kb + kt * kWBK;
        mbar_expect_tx(full, kStage);
        tma_load_2d(st, tmA, k0, m0, full);
#pragma unroll
        for (int i = 0; i < kBoxes; ++i) {
          const bool up = DUAL && i >= kBoxes / 2;  // dual: the up's boxes follow the gate's
          const int col = n0 + 64 * (DUAL ? i % (kBoxes / 2) : i);
          tma_load_2d(st + kTileA + i * kWBox, up ? tmB1 : tmB0, col, k0, full);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 (a warpgroup whose
  // rows all lie past M multiplies TMA's zeros; skipping its products
  // measured no faster)
  const int wg = warp >> 2;
  // no zeroing: the first product overwrites (scale-d 0)
  float acc[BW / 2];
  int prev = -1;
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % kST;
    mbar_wait(full0 + 8 * s, (kt / kST) & 1);
    const uint32_t a = sm0 + s * kStage + wg * (64 * 128);
    const uint32_t b = sm0 + s * kStage + kTileA;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kWBK / 16; ++kk) {
      // A: K-major, 8-row groups 1024 B apart, k16 steps 32 B into a row;
      // B: MN-major, 8-k-row groups 1024 B apart, each next 64-column box
      // 8 KB on, k16 steps 16 rows (2 KB) down
      wgmma_tile<BW>(acc, wgmma_desc(a + 32 * kk, 16, 1024),
                     wgmma_desc(b + 2048 * kk, kWBox, 1024), (kt | kk) != 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the group of tile kt - 1 has finished reading its stage
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (prev >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);
    }
    prev = s;
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

  // accumulator chunk j, value e: row 16 * (warp % 4) + lane / 4 + 8 * (e / 2),
  // column 8 j + 2 (lane % 4) + e % 2
  const int row0 = m0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
  constexpr int kChunks = kOutN / 8, kU = DUAL ? kOutN / 8 : 0;  // u's chunk offset
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int col = n0 + 8 * j + 2 * (lane & 3);
    if (col >= p.N) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      if (row >= p.M) continue;
      if constexpr (DUAL) {
        gemm_emit<DUAL, ACT>(p, blockIdx.z, row, col, acc[4 * (j + kU) + 2 * half],
                             acc[4 * (j + kU) + 2 * half + 1], acc[4 * j + 2 * half],
                             acc[4 * j + 2 * half + 1]);
      } else {
        gemm_emit<DUAL, ACT>(p, blockIdx.z, row, col, acc[4 * j + 2 * half],
                             acc[4 * j + 2 * half + 1], 0.f, 0.f);
      }
    }
  }
}

// Small M: split-K weight streaming, one 64-row warpgroup (two blocks fit
// on an SM; the plan gives each SM one).
template <bool DUAL, int ACT>
__global__ void __launch_bounds__(160, 2)
    gemm_stream_kernel(const __grid_constant__ CUtensorMap tmA,
                       const __grid_constant__ CUtensorMap tmB0,
                       const __grid_constant__ CUtensorMap tmB1, GemmArgs p) {
  gemm_tma_body<DUAL, ACT, 128, 1>(&tmA, &tmB0, &tmB1, p);
}

// Large M: two 64-row warpgroups sharing each B tile, one block per SM.
template <bool DUAL, int ACT, int BW>
__global__ void __launch_bounds__(288, 1)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tmA,
                      const __grid_constant__ CUtensorMap tmB0,
                      const __grid_constant__ CUtensorMap tmB1, GemmArgs p) {
  gemm_tma_body<DUAL, ACT, BW, 2>(&tmA, &tmB0, &tmB1, p);
}

// ---------------------------------------------------------------------------
// Split-K reduction: partials summed in slice order, then the epilogue
// ---------------------------------------------------------------------------

template <bool DUAL, int ACT>
__global__ void __launch_bounds__(256) gemm_splitk_reduce_kernel(const float* ws,
                                                                 __nv_bfloat16* c, int M, int N,
                                                                 int splits) {
  const long long plane = (long long)M * N;
  const long long e = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (e >= plane) return;
  constexpr int kPlanes = DUAL ? 2 : 1;
  float4 u = make_float4(0.f, 0.f, 0.f, 0.f), g = u;
  for (int s = 0; s < splits; ++s) {
    const float4 a = *reinterpret_cast<const float4*>(ws + (s * kPlanes) * plane + e);
    g.x += a.x; g.y += a.y; g.z += a.z; g.w += a.w;
    if constexpr (DUAL) {
      const float4 b = *reinterpret_cast<const float4*>(ws + (s * kPlanes + 1) * plane + e);
      u.x += b.x; u.y += b.y; u.z += b.z; u.w += b.w;
    }
  }
  if constexpr (DUAL) {
    g = make_float4(gemm_act<ACT>(g.x) * u.x, gemm_act<ACT>(g.y) * u.y,
                    gemm_act<ACT>(g.z) * u.z, gemm_act<ACT>(g.w) * u.w);
  }
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(c + e);
  o[0] = __floats2bfloat162_rn(g.x, g.y);
  o[1] = __floats2bfloat162_rn(g.z, g.w);
}

// ---------------------------------------------------------------------------
// CUDA-core body (f32)
// ---------------------------------------------------------------------------

constexpr int kSBM = 64, kSBN = 64, kSBK = 16;

template <bool DUAL, int ACT>
__global__ void __launch_bounds__(256) gemm_simt_kernel(GemmArgs p) {
  __shared__ float sA[kSBK][kSBM + 4];  // transposed: sA[k][m]
  __shared__ float sB[DUAL ? 2 : 1][kSBK][kSBN];
  const float* A = static_cast<const float*>(p.a);
  const float* Bs[2] = {static_cast<const float*>(p.b), static_cast<const float*>(p.bg)};
  const int m0 = blockIdx.y * kSBM, n0 = blockIdx.x * kSBN;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  constexpr int kNB = DUAL ? 2 : 1;
  float acc[kNB][4][4];
#pragma unroll
  for (int bi = 0; bi < kNB; ++bi)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[bi][i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += kSBK) {
    for (int i = tid; i < kSBM * kSBK; i += 256) {
      const int r = i / kSBK, k = i % kSBK;
      sA[k][r] = (m0 + r < p.M && k0 + k < p.K) ? A[(long long)(m0 + r) * p.K + k0 + k] : 0.f;
    }
#pragma unroll
    for (int bi = 0; bi < kNB; ++bi) {
      for (int i = tid; i < kSBK * kSBN; i += 256) {
        const int k = i / kSBN, c = i % kSBN;
        sB[bi][k][c] = (k0 + k < p.K && n0 + c < p.N)
                           ? Bs[bi][(long long)(k0 + k) * p.N + n0 + c] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSBK; ++k) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[k][ty * 4 + i];
#pragma unroll
      for (int bi = 0; bi < kNB; ++bi) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float b = sB[bi][k][tx * 4 + j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[bi][i][j] = fmaf(a[i], b, acc[bi][i][j]);
        }
      }
    }
    __syncthreads();
  }
  float* C = static_cast<float*>(p.c);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= p.N) continue;
      float v = acc[0][i][j];
      if constexpr (DUAL) v = gemm_act<ACT>(acc[1][i][j]) * v;
      C[(long long)row * p.N + col] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// A 2-D bf16 tensor map over a row-major (rows, cols) matrix with a
// (box_rows, 64) box and 128-byte swizzle. Maps are cached by (pointer,
// shape, box): the stacked weights recur with one pointer per layer, and
// the activations recur at the allocator's addresses, so a steady engine
// encodes nothing per launch.
struct GemmMapEntry {
  const void* ptr;
  long long rows, cols;
  int box_rows;
  CUtensorMap map;
};

bool gemm_tensor_map(CUtensorMap* out, const void* ptr, long long rows, long long cols,
                     int box_rows) {
  constexpr int kSlots = 512;
  static GemmMapEntry cache[kSlots];
  static std::mutex mu;
  const size_t h = (reinterpret_cast<uintptr_t>(ptr) >> 4) * 0x9E3779B97F4A7C15ull ^
                   (size_t)rows * 31 ^ (size_t)cols * 131 ^ (size_t)box_rows;
  GemmMapEntry& e = cache[(h >> 7) % kSlots];
  std::lock_guard<std::mutex> lock(mu);
  if (e.ptr == ptr && e.rows == rows && e.cols == cols && e.box_rows == box_rows) {
    *out = e.map;
    return true;
  }
  const EncodeTiledFn encode = tma_encode_fn();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  CUtensorMap m;
  if (encode(&m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
      CUDA_SUCCESS)
    return false;
  e.ptr = ptr; e.rows = rows; e.cols = cols; e.box_rows = box_rows; e.map = m;
  *out = m;
  return true;
}

// Launch one of the TMA bodies: NWG 1 is the streaming body, NWG 2 the
// wgmma body. The kernel is opted into its dynamic shared memory once per
// instantiation (a function-local static), not on every launch.
template <bool DUAL, int ACT, int BW, int NWG>
cudaError_t gemm_launch_tma(const GemmArgs& p, int splits, cudaStream_t stream) {
  void (*kernel)(CUtensorMap, CUtensorMap, CUtensorMap, GemmArgs);
  if constexpr (NWG == 1) {
    kernel = gemm_stream_kernel<DUAL, ACT>;
  } else {
    kernel = gemm_wgmma_kernel<DUAL, ACT, BW>;
  }
  constexpr size_t smem = gemm_tma_smem<BW, NWG>();
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  constexpr int kBM = 64 * NWG, kOutN = DUAL ? BW / 2 : BW;
  CUtensorMap ta, tb0, tb1;
  if (!gemm_tensor_map(&ta, p.a, p.M, p.K, kBM) ||
      !gemm_tensor_map(&tb0, DUAL ? p.bg : p.b, p.K, p.N, kWBK) ||
      !gemm_tensor_map(&tb1, p.b, p.K, p.N, kWBK))
    return cudaErrorInvalidValue;
  dim3 grid((p.M + kBM - 1) / kBM, (p.N + kOutN - 1) / kOutN, splits);
  kernel<<<grid, 128 * NWG + 32, smem, stream>>>(ta, tb0, tb1, p);
  return cudaGetLastError();
}

// Launch one GEMM (or dual GEMM) on `stream` as `plan` says; returns
// cudaGetLastError(). A split plan needs `ws` of splits x [2 x] M x N floats.
template <bool DUAL, int ACT>
cudaError_t gemm_launch(int dtype, const GemmPlan& plan, GemmArgs p, void* ws,
                        cudaStream_t stream) {
  if (p.K % 8 || p.N % 8) return cudaErrorInvalidValue;
  if (p.M == 0 || p.N == 0) return cudaSuccess;
  if (dtype == NXDI_F32) {
    if (plan.body != GEMM_SIMT) return cudaErrorInvalidValue;
    dim3 grid((p.N + kSBN - 1) / kSBN, (p.M + kSBM - 1) / kSBM);
    gemm_simt_kernel<DUAL, ACT><<<grid, 256, 0, stream>>>(p);
    return cudaGetLastError();
  }
  if (dtype != NXDI_BF16) return cudaErrorInvalidValue;
  const int S = plan.splits, ks = plan.k_slice;
  // whole K tiles per slice, every slice non-empty, the slices cover K
  if (S < 1 || ks <= 0 || ks % kWBK || (long long)(S - 1) * ks >= p.K ||
      (long long)S * ks < p.K || (S > 1 && !ws))
    return cudaErrorInvalidValue;
  p.k_slice = ks;
  p.ws = S > 1 ? static_cast<float*>(ws) : nullptr;
  const int bw = DUAL ? 2 * plan.bn : plan.bn;  // the B tile's width
  cudaError_t err;
  const bool wg = plan.body == GEMM_WGMMA && plan.bm == 128;
  if (plan.body == GEMM_STREAM && plan.bm == 64 && bw == 128) {
    err = gemm_launch_tma<DUAL, ACT, 128, 1>(p, S, stream);
  } else if (wg && bw == 128) {
    err = gemm_launch_tma<DUAL, ACT, 128, 2>(p, S, stream);
  } else if (wg && bw == 256) {
    err = gemm_launch_tma<DUAL, ACT, 256, 2>(p, S, stream);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || S == 1) return err;
  const long long groups = (long long)p.M * p.N / 4;
  gemm_splitk_reduce_kernel<DUAL, ACT><<<(unsigned)((groups + 255) / 256), 256, 0, stream>>>(
      p.ws, static_cast<__nv_bfloat16*>(p.c), p.M, p.N, S);
  return cudaGetLastError();
}

// Byte offset of layer `layer` of a stacked weight with `layer_stride`
// elements per layer.
inline const void* gemm_layer(const void* base, int dtype, int layer, long long layer_stride) {
  const size_t es = dtype == NXDI_BF16 ? 2 : 4;
  return static_cast<const char*>(base) + (size_t)layer * (size_t)layer_stride * es;
}

}  // namespace
