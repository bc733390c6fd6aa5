// Tiled GEMM core of the fused projections: C = A @ B (plain), or the dual
// product act(A @ Bg) * (A @ Bu) (the MLP's gate/up step), with A (M, K),
// B (K, N) and C (M, N) row-major.
//
// Shared by qkv_matmul.cu (the fused QKV projection, and the MLP's down
// product) and fused_mlp.cu. They replace the Pallas bodies of
// nxdi_tpu/ops/kernels/fused_proj.py (_matmul_kernel, _qkv_stacked_kernel,
// _fused_mlp_kernel, _fused_mlp_stacked_kernel): f32 accumulation, output in
// the input dtype; the dual epilogue computes act(g) * u in f32 and rounds it
// to the input dtype, the TPU kernel's rounding point before its down product.
//
// Two bodies:
//  - gemm_tc_kernel (bf16): 64 x 64 output tile per block of 4 warps, each
//    warp 32 x 32 (2 x 4 mma.sync m16n8k16 tiles, f32 accumulators); A and B
//    tiles (64-deep) in a 3-stage cp.async ring in shared memory; A fragments
//    by 32-bit shared loads, B fragments by ldmatrix.trans (B is row-major
//    (K, N), the mma wants it column-major). Edges of M, N and K are
//    zero-filled in the loads and masked in the stores, so any M works; K and
//    N must be multiples of 8 (16-byte rows of the cp.async chunks).
//  - gemm_simt_kernel (f32): 64 x 64 tiles, 16-deep, 256 threads of 4 x 4
//    outputs each, f32 on the CUDA cores, so f32 inputs keep f32 products.
//
// Bound on this card: at decode (M = 8) every product streams its weight
// once — bytes, ~3.8 us for the 2048 x 3072 QKV weight at 3.35 TB/s — and the
// 64-row tile wastes tensor-core work that costs nothing there; at a packed
// step of 520 rows the MLP's 52 GFLOP make it compute-bound (~53 us at 989
// TFLOP/s). mma.sync from a 3-stage ring reaches part of either; a
// warp-specialised wgmma/TMA pipeline and split-K for small M are later work.
#pragma once

#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

enum GemmAct : int { ACT_SILU = 0, ACT_GELU = 1, ACT_GELU_TANH = 2, ACT_RELU = 3 };

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
  int M, N, K;
};

// ---------------------------------------------------------------------------
// Tensor-core body (bf16)
// ---------------------------------------------------------------------------

constexpr int kGBM = 64, kGBN = 64, kGBK = 64, kGStages = 3;
constexpr int kGLda = kGBK + 8;  // padded rows: conflict-free fragment loads
constexpr int kGLdb = kGBN + 8;
constexpr int kGATile = kGBM * kGLda;  // elements
constexpr int kGBTile = kGBK * kGLdb;

template <bool DUAL>
size_t gemm_tc_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)kGStages * (kGATile + (DUAL ? 2 : 1) * kGBTile);
}

__device__ __forceinline__ void gemm_mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void gemm_ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// one (rows x cols) tile of a row-major (R, C) bf16 matrix into a padded
// shared tile (leading dimension ld), 16-byte chunks, out-of-range chunks
// zero-filled (C is a multiple of 8, so a chunk is wholly in or out)
template <int ROWS, int COLS>
__device__ __forceinline__ void gemm_stage(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
                                           int R, int C, int r0, int c0) {
  constexpr int cpr = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * cpr; i += blockDim.x) {
    const int r = i / cpr, c = (i % cpr) * 8;
    const bool ok = r0 + r < R && c0 + c < C;
    const __nv_bfloat16* g = ok ? src + (long long)(r0 + r) * C + c0 + c : src;
    __pipeline_memcpy_async(dst + r * ld + c, g, 16, ok ? 0 : 16);
  }
}

template <bool DUAL, int ACT>
__global__ void __launch_bounds__(128) gemm_tc_kernel(GemmArgs p) {
  extern __shared__ __align__(16) __nv_bfloat16 gsm[];
  using bf = __nv_bfloat16;
  constexpr int kNB = DUAL ? 2 : 1;
  constexpr int kStage = kGATile + kNB * kGBTile;
  const bf* A = static_cast<const bf*>(p.a);
  const bf* Bu = static_cast<const bf*>(p.b);
  const bf* Bg = static_cast<const bf*>(p.bg);
  const int m0 = blockIdx.y * kGBM, n0 = blockIdx.x * kGBN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  auto stage = [&](int s, int kt) {
    bf* base = gsm + s * kStage;
    const int k0 = kt * kGBK;
    gemm_stage<kGBM, kGBK>(base, kGLda, A, p.M, p.K, m0, k0);
    gemm_stage<kGBK, kGBN>(base + kGATile, kGLdb, Bu, p.K, p.N, k0, n0);
    if constexpr (DUAL) gemm_stage<kGBK, kGBN>(base + kGATile + kGBTile, kGLdb, Bg, p.K, p.N, k0, n0);
  };

  float acc[kNB][2][4][4];
#pragma unroll
  for (int bi = 0; bi < kNB; ++bi)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[bi][mi][ni][e] = 0.f;

  const int n_k = (p.K + kGBK - 1) / kGBK;
#pragma unroll
  for (int s = 0; s < kGStages - 1; ++s) {
    if (s < n_k) stage(s, s);
    __pipeline_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    __pipeline_wait_prior(kGStages - 2);  // tile kt has landed
    __syncthreads();                      // ... for every thread; tile kt - 1 is consumed
    if (kt + kGStages - 1 < n_k) stage((kt + kGStages - 1) % kGStages, kt + kGStages - 1);
    __pipeline_commit();
    const bf* sA = gsm + (kt % kGStages) * kStage;
#pragma unroll
    for (int kk = 0; kk < kGBK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const bf* ap = sA + (wm + mi * 16 + grp) * kGLda + kk + 2 * tig;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(ap);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * kGLda);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(ap + 8);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * kGLda + 8);
      }
      const int brow = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int bi = 0; bi < kNB; ++bi) {
        const bf* sB = sA + kGATile + bi * kGBTile;
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bf4[4];
          gemm_ldmatrix_x4_trans(bf4, sB + brow * kGLdb + wn + np * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            gemm_mma(acc[bi][mi][2 * np], af[mi], bf4[0], bf4[1]);
            gemm_mma(acc[bi][mi][2 * np + 1], af[mi], bf4[2], bf4[3]);
          }
        }
      }
    }
  }
  __pipeline_wait_prior(0);  // no copy outlives the block

  bf* C = static_cast<bf*>(p.c);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + mi * 16 + grp + 8 * half;
      if (row >= p.M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn + ni * 8 + 2 * tig;
        if (col >= p.N) continue;
        float v0 = acc[0][mi][ni][2 * half], v1 = acc[0][mi][ni][2 * half + 1];
        if constexpr (DUAL) {
          v0 = gemm_act<ACT>(acc[1][mi][ni][2 * half]) * v0;
          v1 = gemm_act<ACT>(acc[1][mi][ni][2 * half + 1]) * v1;
        }
        *reinterpret_cast<__nv_bfloat162*>(C + (long long)row * p.N + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
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

// Launch one GEMM (or dual GEMM) on `stream`; returns cudaGetLastError().
template <bool DUAL, int ACT>
cudaError_t gemm_launch(int dtype, const GemmArgs& p, cudaStream_t stream) {
  if (p.K % 8 || p.N % 8) return cudaErrorInvalidValue;
  if (p.M == 0 || p.N == 0) return cudaSuccess;
  if (dtype == NXDI_BF16) {
    const size_t smem = gemm_tc_smem_bytes<DUAL>();
    cudaError_t err = cudaFuncSetAttribute(gemm_tc_kernel<DUAL, ACT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((p.N + kGBN - 1) / kGBN, (p.M + kGBM - 1) / kGBM);
    gemm_tc_kernel<DUAL, ACT><<<grid, 128, smem, stream>>>(p);
    return cudaGetLastError();
  }
  if (dtype == NXDI_F32) {
    dim3 grid((p.N + kSBN - 1) / kSBN, (p.M + kSBM - 1) / kSBM);
    gemm_simt_kernel<DUAL, ACT><<<grid, 256, 0, stream>>>(p);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

// Byte offset of layer `layer` of a stacked weight with `layer_stride`
// elements per layer.
inline const void* gemm_layer(const void* base, int dtype, int layer, long long layer_stride) {
  const size_t es = dtype == NXDI_BF16 ? 2 : 4;
  return static_cast<const char*>(base) + (size_t)layer * (size_t)layer_stride * es;
}

}  // namespace
