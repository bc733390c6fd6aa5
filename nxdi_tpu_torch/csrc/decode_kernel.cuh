// The single-position decode kernel shared by three entry points, one per
// source so the modes compile in parallel: flash_decode.cu (kFused),
// window_decode.cu (kWindow), paged_decode.cu (kPaged). What each mode
// replaces, and the design, are described below.
//
//  - kFused: deferred-write decode over the OLD cache with this step's fresh
//    K/V row folded in. Replaces
//    nxdi_tpu/ops/kernels/flash_attention.py::flash_attention_decode_fused
//    and ::flash_attention_decode_fused_stacked (Pallas body
//    _fused_decode_kernel): cache slots j < kv_len whose position
//    kv_start[b] + j is STRICTLY before q_pos[b] (the slot at q_pos still
//    holds a stale row), then the fresh row (always visible); all f32. The
//    stacked entry is the same kernel: the wrapper passes cache[layer_idx].
//  - kWindow: decode over a contiguous (B, KV, Sk, D) window whose slot at
//    q_pos already holds this step's row. Replaces ::flash_attention_decode
//    (Pallas body _decode_kernel): the causal mask is inclusive, there is no
//    fresh row, and probabilities are rounded to the input dtype before P.V,
//    as the Pallas kernel feeds its MXU.
//  - kPaged: kWindow's arithmetic with K/V read through a block table from
//    the paged pool (total_slots, KV, D). Replaces ::paged_attention_decode
//    (Pallas body _paged_decode_kernel): logical position j lives in slot
//    bt[b][j / bs] * bs + j % bs; negative table entries are holes, and
//    blocks past q_pos are never read. k_scale arrives folded into `scale`,
//    v_scale multiplies the output.
//
// Window/chunk masks apply to kFused and kWindow. Every mode clamps the
// softmax denominator at 1e-20, so a row with no visible key outputs 0.
//
// Design: one block (8 warps) per (b, kv-head); the G = H/KV query rows of
// the group share every K/V row read. The attended positions are split over
// the warps in 32-position tiles (lane = position for Q.K, lane = output
// column for P.V), each warp keeps its own (m, l, acc) and the block merges
// them in shared memory. Each tile's V rows are copied into the warp's shared
// memory with cp.async, issued before the Q.K work so the copy overlaps it;
// P.V then reads V from shared memory. Each lane loads its whole K row as
// 16-byte chunks issued together. The paged mode looks each lane's slot up
// in the table and computes its address in 64 bits; the TPU kernel instead
// read a whole (block_size, KV, D) block for all kv heads at once, which at
// block 128, KV 8, D 64 in bf16 is 128 KiB for K alone and would not fit one
// block's shared memory beside V. Here a block reads only its own head's
// strided rows (row stride KV * D), so any block size works.
//
// Bound: decode streams the attended K/V rows from device memory once
// (33.5 MB per layer at B=8, KV=8, 2048 slots, D=64 in bf16: ~10 us at
// 3.35 TB/s). B*KV = 64 blocks fill under half of the 132 SMs; splitting the
// kv range over blocks (flash-decoding with a second merge pass) is the later
// step.
#pragma once

#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;

enum class Mode { kFused, kWindow, kPaged };

struct DecodeArgs {
  const void* q;
  const void* kc;
  const void* vc;
  const void* kn;       // kFused only: this step's fresh rows
  const void* vn;
  void* out;
  const int* q_pos;
  const int* kv_start;  // may be null: slot j is position j
  const int* bt;        // kPaged only: (B, nb) block table, -1 = hole
  int H, KV, D, kv_len, nb, bs;
  long long qsb, qsh, csb, csh, css, nsb, nsh, osb, osh;
  float scale, v_scale;
  int window, chunk;
};

// A 16-byte chunk of a K row, unpacked to f32.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

// f32 merge area, rounded up to 16 bytes, then one 32 x D V tile per warp
__host__ __device__ size_t decode_float_bytes(int G, int D) {
  return (sizeof(float) * (size_t)(G * D + 2 * kWarps * G + kWarps * G * D + G) + 15) & ~size_t(15);
}
size_t decode_smem_bytes(int G, int D, size_t elem) {
  return decode_float_bytes(G, D) + kWarps * 32 * (size_t)D * elem;
}

template <typename T, int GMAX, int DMAX, Mode MODE>
__global__ void __launch_bounds__(kWarps * 32) decode_kernel(DecodeArgs a) {
  constexpr bool kFresh = MODE == Mode::kFused;   // fold in the fresh row, strict mask
  constexpr bool kRoundP = MODE != Mode::kFused;  // P rounded to T before P.V
  constexpr bool kPaged = MODE == Mode::kPaged;

  extern __shared__ __align__(16) float smem[];
  const int D = a.D, G = a.H / a.KV;
  T* sV = reinterpret_cast<T*>(reinterpret_cast<char*>(smem) + decode_float_bytes(G, D)) +
          (threadIdx.x >> 5) * 32 * D;  // this warp's V tile [32][D]
  float* sQ = smem;                    // [G][D]
  float* sM = sQ + G * D;              // [kWarps][G]
  float* sL = sM + kWarps * G;         // [kWarps][G]
  float* sAcc = sL + kWarps * G;       // [kWarps][G][D]
  float* sS2 = sAcc + kWarps * G * D;  // [G] fresh-row scores

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / a.KV, kvh = blockIdx.x % a.KV;
  const int qp = a.q_pos[b];
  const int ks = a.kv_start ? a.kv_start[b] : 0;

  const T* kc = static_cast<const T*>(a.kc) + b * a.csb + kvh * a.csh;
  const T* vc = static_cast<const T*>(a.vc) + b * a.csb + kvh * a.csh;
  const int* btr = kPaged ? a.bt + (long long)b * a.nb : nullptr;

  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    sQ[i] = to_f32(static_cast<const T*>(a.q)[b * a.qsb + (kvh * G + g) * a.qsh + d]);
  }
  __syncthreads();

  if constexpr (kFresh) {
    // fresh-row scores (the fresh row sits at q_pos: every mask admits it)
    const T* kn = static_cast<const T*>(a.kn) + b * a.nsb + kvh * a.nsh;
    for (int g = warp; g < G; g += kWarps) {
      float part = 0.f;
      for (int d = lane; d < D; d += 32) part = fmaf(sQ[g * D + d], to_f32(kn[d]), part);
      part = warp_sum(part);
      if (lane == 0) sS2[g] = part * a.scale;
    }
  }

  // attended positions [j_begin, j_end): up to q_pos (exclusive when the
  // fresh row replaces the slot at q_pos), inside kv_len
  const int j_end = max(0, min(a.kv_len, qp - ks + (kFresh ? 0 : 1)));
  int j_begin = 0;
  if (a.window > 0) j_begin = max(0, min(j_end, qp - a.window + 1 - ks)) & ~31;

  constexpr int kT = DMAX / 32;  // output columns per lane
  float m[GMAX], l[GMAX], acc[GMAX][kT], s[GMAX], p[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NXDI_NEG_INF;
    l[g] = 0.f;
    p[g] = 0.f;
#pragma unroll
    for (int t = 0; t < kT; ++t) acc[g][t] = 0.f;
  }

  const int cpr = D * (int)sizeof(T) / 16;  // 16-byte chunks per row
  const int n_tiles = (j_end - j_begin + 31) / 32;
  for (int tile = warp; tile < n_tiles; tile += kWarps) {
    const int jb = j_begin + tile * 32;
    const int j = jb + lane;
    const int n_here = min(32, j_end - jb);
    const bool in_range = j < j_end;
    // this lane's slot: position j itself, or through the block table
    long long slot = j;
    bool live = in_range;
    if constexpr (kPaged) {
      const int blk = in_range ? btr[j / a.bs] : -1;
      live = blk >= 0;
      slot = live ? (long long)blk * a.bs + j % a.bs : 0;
    }
    // stage V rows [jb, jb + n_here) into shared memory asynchronously
    if constexpr (kPaged) {
      // each row's slot comes from the lane that looked it up; hole rows
      // are zero-filled (the loop is warp-uniform for the shuffles)
      for (int base = 0; base < n_here * cpr; base += 32) {
        const int i = base + lane;
        const int row = min(i / cpr, 31), c = i % cpr;
        const long long rslot = __shfl_sync(0xffffffffu, slot, row);
        const int rlive = __shfl_sync(0xffffffffu, (int)live, row);
        if (i < n_here * cpr)
          __pipeline_memcpy_async(reinterpret_cast<char*>(sV + row * D) + c * 16,
                                  reinterpret_cast<const char*>(vc + rslot * a.css) + c * 16,
                                  16, rlive ? 0 : 16);
      }
    } else {
      for (int i = lane; i < n_here * cpr; i += 32) {
        const int row = i / cpr, c = i % cpr;
        __pipeline_memcpy_async(reinterpret_cast<char*>(sV + row * D) + c * 16,
                                reinterpret_cast<const char*>(vc + (long long)(jb + row) * a.css) +
                                    c * 16,
                                16);
      }
    }
    __pipeline_commit();
    const bool valid = live && pos_visible(ks + j, qp, kFresh, a.window, a.chunk);
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
    {  // this lane's K row: every 16-byte chunk in flight at once
      constexpr int EPC = Chunk<T>::N;
      constexpr int KC = DMAX / EPC;
      uint4 kreg[KC];
      const uint4* krow = reinterpret_cast<const uint4*>(kc + slot * a.css);
#pragma unroll
      for (int c = 0; c < KC; ++c)
        kreg[c] = (live && c * EPC < D) ? krow[c] : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        if (c * EPC < D) {
          float kf[EPC];
          Chunk<T>::unpack(kreg[c], kf);
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
            if (g < G) {
#pragma unroll
              for (int e = 0; e < EPC; e += 4) {
                const float4 q4 = *reinterpret_cast<const float4*>(&sQ[g * D + c * EPC + e]);
                s[g] = fmaf(q4.x, kf[e], fmaf(q4.y, kf[e + 1],
                            fmaf(q4.z, kf[e + 2], fmaf(q4.w, kf[e + 3], s[g]))));
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        const float sc = valid ? s[g] * a.scale : NXDI_NEG_INF;
        const float m_new = fmaxf(m[g], warp_max(sc));
        const float corr = expf(m[g] - m_new);
        p[g] = valid ? expf(sc - m_new) : 0.f;
        l[g] = l[g] * corr + warp_sum(p[g]);
        m[g] = m_new;
        if (kRoundP) p[g] = round_through<T>(p[g]);
#pragma unroll
        for (int t = 0; t < kT; ++t) acc[g][t] *= corr;
      }
    }
    __pipeline_wait_prior(0);
    __syncwarp();
    for (int jj = 0; jj < n_here; ++jj) {
      float pj[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) pj[g] = __shfl_sync(0xffffffffu, p[g], jj);
      const T* vrow = sV + jj * D;
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        const int d = lane + 32 * t;
        if (d < D) {
          const float vv = to_f32(vrow[d]);
#pragma unroll
          for (int g = 0; g < GMAX; ++g)
            if (g < G) acc[g][t] = fmaf(pj[g], vv, acc[g][t]);
        }
      }
    }
    __syncwarp();  // the next tile overwrites this warp's V tile
  }

#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      if (lane == 0) {
        sM[warp * G + g] = m[g];
        sL[warp * G + g] = l[g];
      }
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        const int d = lane + 32 * t;
        if (d < D) sAcc[(warp * G + g) * D + d] = acc[g][t];
      }
    }
  }
  __syncthreads();

  const T* vn = kFresh ? static_cast<const T*>(a.vn) + b * a.nsb + kvh * a.nsh : nullptr;
  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    float M = NXDI_NEG_INF;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sM[w * G + g]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sM[w * G + g] - M);
      L = fmaf(sL[w * G + g], f, L);
      A = fmaf(sAcc[(w * G + g) * D + d], f, A);
    }
    if constexpr (kFresh) {
      const float s2 = sS2[g];
      const float m_new = fmaxf(M, s2);
      const float corr = expf(M - m_new);
      const float p2 = expf(s2 - m_new);
      L = L * corr + p2;
      A = A * corr + p2 * to_f32(vn[d]);
    }
    L = fmaxf(L, 1e-20f);
    static_cast<T*>(a.out)[b * a.osb + (kvh * G + g) * a.osh + d] = from_f32<T>(A * a.v_scale / L);
  }
}

template <typename T, int GMAX, int DMAX, Mode MODE>
cudaError_t launch(const DecodeArgs& a, int B, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes(a.H / a.KV, a.D, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(decode_kernel<T, GMAX, DMAX, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  decode_kernel<T, GMAX, DMAX, MODE><<<B * a.KV, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DMAX, Mode MODE>
cudaError_t dispatch_g(const DecodeArgs& a, int B, cudaStream_t stream) {
  const int G = a.H / a.KV;
  if (G <= 4) return launch<T, 4, DMAX, MODE>(a, B, stream);
  if (G <= 8) return launch<T, 8, DMAX, MODE>(a, B, stream);
  if (G <= 16) return launch<T, 16, DMAX, MODE>(a, B, stream);
  return cudaErrorInvalidValue;
}

template <Mode MODE>
int dispatch(int dtype, const DecodeArgs& a, int B, void* stream) {
  if (a.D % 8 != 0 || a.D > 128 || a.H % a.KV != 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == NXDI_F32)
    return (int)(a.D <= 64 ? dispatch_g<float, 64, MODE>(a, B, s)
                           : dispatch_g<float, 128, MODE>(a, B, s));
  if (dtype == NXDI_BF16)
    return (int)(a.D <= 64 ? dispatch_g<__nv_bfloat16, 64, MODE>(a, B, s)
                           : dispatch_g<__nv_bfloat16, 128, MODE>(a, B, s));
  return (int)cudaErrorInvalidValue;
}

}  // namespace
