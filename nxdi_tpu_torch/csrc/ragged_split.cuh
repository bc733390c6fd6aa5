// The split and combine kernels of ragged paged attention (ragged_paged.cu
// describes the scheme), shared by ragged_paged.cu and the one-byte stores'
// instantiations in ragged_paged_1b.cu.
#pragma once

#include "prefill_kernel.cuh"

// outside the unnamed namespace: ragged_paged.cu passes it to the one-byte
// instantiations
struct SplitArgs {
  const void* q;
  const void* kc;
  const void* vc;
  void* out;
  const int* tok_pos;
  const int* bt;     // (R, nb) tables, -1 = hole
  const int* plan;   // the work list: its header counts the items
  float* acc;        // (slots, H, D) partial sums
  float* ml;         // (slots, H, 2) partial max and denominator
  int H, KV, D, nb, bs;
  long long qsh, qss, osh, oss;
  float scale, v_scale;
};

namespace {

constexpr int kSplitWarps = 4;  // a chunk is walked in 32-key tiles, one warp each
// q heads per pass over a chunk: 4 when the G q heads of a kv head fit
// (Llama-3.2-1B's), else 16
constexpr int kSplitRows = 16;
constexpr int kItemInts = 7;    // token, row, kv begin, kv end, chunk, chunks, first slot
constexpr int kCombInts = 3;    // token, first slot, chunks

// the plan's sections, from the counts in its header (prefill_kernel.cuh
// lays them out)
__device__ __forceinline__ const int* plan_items(const int* plan) {
  return plan + kPlanHeader + plan[1] + plan[kPlanWgCount] * kWgInts;
}
__device__ __forceinline__ const int* plan_comb(const int* plan) {
  return plan_items(plan) + (long long)plan[2] * kItemInts;
}


// f32 merge area (rounded to 16 bytes), then one 32 x D V tile per warp
__host__ __device__ inline size_t split_float_bytes(int D) {
  return round16(sizeof(float) * (size_t)(kSplitRows * D + 2 * kSplitWarps * kSplitRows +
                                          kSplitWarps * kSplitRows * D));
}

// a 16-byte chunk of a K row, unpacked to f32
__device__ __forceinline__ void unpack16(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float* f, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
// 16 one-byte store elements
template <typename S, typename std::enable_if<sizeof(S) == 1, int>::type = 0>
__device__ __forceinline__ void unpack16(const uint4& u, float* f, S) {
  const S* e = reinterpret_cast<const S*>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = to_f32(e[i]);
}

// T: q's and the output's type; S: the pool's store type (T or one byte)
template <typename T, typename S, int DMAX, int RMAX>
__global__ void __launch_bounds__(kSplitWarps * 32) ragged_split_kernel(SplitArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D, G = a.H / a.KV;
  // (laid out within split_float_bytes, which is sized for kSplitRows)
  float* sQ = smem;                         // [RMAX][D]
  float* sM = sQ + RMAX * D;                // [kSplitWarps][RMAX]
  float* sL = sM + kSplitWarps * RMAX;      // [kSplitWarps][RMAX]
  float* sAcc = sL + kSplitWarps * RMAX;    // [kSplitWarps][RMAX][D]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  S* sV = reinterpret_cast<S*>(reinterpret_cast<char*>(smem) + split_float_bytes(D)) +
          warp * 32 * D;  // this warp's V tile [32][D]

  const int n_items = a.plan[2];
  const int* items = plan_items(a.plan);
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
  const int* it = items + (long long)item * kItemInts;
  const int t = it[0], row = it[1], lo = it[2], hi = it[3], c = it[4], nch = it[5],
            slot0 = it[6];
  const int pos = a.tok_pos[t];
  const int kvh = blockIdx.y;
  const int* btr = a.bt + (long long)row * a.nb;
  const long long rs = (long long)a.KV * D;  // pool row stride
  const S* kc = static_cast<const S*>(a.kc) + kvh * D;
  const S* vc = static_cast<const S*>(a.vc) + kvh * D;
  const T* q = static_cast<const T*>(a.q);
  T* out = static_cast<T*>(a.out);
  const int cpr = D * (int)sizeof(S) / 16;  // 16-byte chunks per row
  const int n_tiles = (hi - lo + 31) / 32;
  constexpr int kT = DMAX / 32;  // output columns per lane

  // q row g of a pass: q head kvh * G + pass + g of token t
  for (int pass = 0; pass < G; pass += RMAX) {
    const int rows = min(RMAX, G - pass);
    for (int i = tid; i < rows * D; i += blockDim.x) {
      const int h = kvh * G + pass + i / D, d = i % D;
      sQ[i] = to_f32(q[h * a.qsh + t * a.qss + d]);
    }
    __syncthreads();

    float m[RMAX], l[RMAX], acc[RMAX][kT], s[RMAX], p[RMAX];
#pragma unroll
    for (int g = 0; g < RMAX; ++g) {
      m[g] = NXDI_NEG_INF;
      l[g] = 0.f;
      p[g] = 0.f;
#pragma unroll
      for (int u = 0; u < kT; ++u) acc[g][u] = 0.f;
    }

    for (int tile = warp; tile < n_tiles; tile += kSplitWarps) {
      const int jb = lo + tile * 32;
      const int j = jb + lane;
      const int n_here = min(32, hi - jb);
      const int blk = j < hi ? btr[j / a.bs] : -1;
      const bool live = blk >= 0;
      const long long slot = live ? (long long)blk * a.bs + j % a.bs : 0;
      // stage V rows [jb, jb + n_here): each row's slot from the lane that
      // looked it up; hole rows zero-filled
      for (int base = 0; base < n_here * cpr; base += 32) {
        const int i = base + lane;
        const int r = min(i / cpr, 31), ch = i % cpr;
        const long long rslot = __shfl_sync(0xffffffffu, slot, r);
        const int rlive = __shfl_sync(0xffffffffu, (int)live, r);
        if (i < n_here * cpr)
          __pipeline_memcpy_async(reinterpret_cast<char*>(sV + r * D) + ch * 16,
                                  reinterpret_cast<const char*>(vc + rslot * rs) + ch * 16, 16,
                                  rlive ? 0 : 16);
      }
      __pipeline_commit();
#pragma unroll
      for (int g = 0; g < RMAX; ++g) s[g] = 0.f;
      {  // this lane's K row, every 16-byte chunk in flight at once, against
         // every q row of the pass
        constexpr int EPC = 16 / sizeof(S), KC = DMAX / EPC;
        uint4 kreg[KC];
        const uint4* krow = reinterpret_cast<const uint4*>(kc + slot * rs);
#pragma unroll
        for (int ch = 0; ch < KC; ++ch)
          kreg[ch] = (live && ch * EPC < D) ? krow[ch] : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int ch = 0; ch < KC; ++ch) {
          if (ch * EPC < D) {
            float kf[EPC];
            unpack16(kreg[ch], kf, S());
#pragma unroll
            for (int g = 0; g < RMAX; ++g) {
              if (g < rows) {
#pragma unroll
                for (int e = 0; e < EPC; e += 4) {
                  const float4 q4 = *reinterpret_cast<const float4*>(&sQ[g * D + ch * EPC + e]);
                  s[g] = fmaf(q4.x, kf[e], fmaf(q4.y, kf[e + 1],
                              fmaf(q4.z, kf[e + 2], fmaf(q4.w, kf[e + 3], s[g]))));
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < RMAX; ++g) {
        if (g < rows) {
          const bool valid = live && j <= pos;
          const float sc = valid ? s[g] * a.scale : NXDI_NEG_INF;
          const float m_new = fmaxf(m[g], warp_max(sc));
          const float corr = expf(m[g] - m_new);
          p[g] = valid ? expf(sc - m_new) : 0.f;
          l[g] = l[g] * corr + warp_sum(p[g]);
          m[g] = m_new;
          p[g] = round_through<T>(p[g]);
#pragma unroll
          for (int u = 0; u < kT; ++u) acc[g][u] *= corr;
        }
      }
      __pipeline_wait_prior(0);
      __syncwarp();
      for (int jj = 0; jj < n_here; ++jj) {
        float pj[RMAX];
#pragma unroll
        for (int g = 0; g < RMAX; ++g)  // rows is the warp's own: no lane skips a shuffle
          pj[g] = g < rows ? __shfl_sync(0xffffffffu, p[g], jj) : 0.f;
        const S* vrow = sV + jj * D;
#pragma unroll
        for (int u = 0; u < kT; ++u) {
          const int d = lane + 32 * u;
          if (d < D) {
            const float vv = to_f32(vrow[d]);
#pragma unroll
            for (int g = 0; g < RMAX; ++g)
              if (g < rows) acc[g][u] = fmaf(pj[g], vv, acc[g][u]);
          }
        }
      }
      __syncwarp();  // the next tile overwrites this warp's V tile
    }

#pragma unroll
    for (int g = 0; g < RMAX; ++g) {
      if (g < rows) {
        if (lane == 0) {
          sM[warp * RMAX + g] = m[g];
          sL[warp * RMAX + g] = l[g];
        }
#pragma unroll
        for (int u = 0; u < kT; ++u) {
          const int d = lane + 32 * u;
          if (d < D) sAcc[(warp * RMAX + g) * D + d] = acc[g][u];
        }
      }
    }
    __syncthreads();

    // merge the warps; write the output (one chunk) or the chunk's partials
    for (int i = tid; i < rows * D; i += blockDim.x) {
      const int g = i / D, d = i % D;
      float M = NXDI_NEG_INF;
      for (int w = 0; w < kSplitWarps; ++w) M = fmaxf(M, sM[w * RMAX + g]);
      float L = 0.f, A = 0.f;
      for (int w = 0; w < kSplitWarps; ++w) {
        const float f = expf(sM[w * RMAX + g] - M);
        L = fmaf(sL[w * RMAX + g], f, L);
        A = fmaf(sAcc[(w * RMAX + g) * D + d], f, A);
      }
      const int h = kvh * G + pass + g;
      if (nch == 1) {
        out[h * a.osh + t * a.oss + d] = from_f32<T>(A * a.v_scale / fmaxf(L, 1e-20f));
      } else {
        const long long sl = (long long)(slot0 + c) * a.H + h;
        a.acc[sl * D + d] = A;
        if (d == 0) {
          a.ml[2 * sl] = M;
          a.ml[2 * sl + 1] = L;
        }
      }
    }
    __syncthreads();  // the next pass (or item) overwrites sQ and the merge area
  }
  }  // items
}

// One warp per (token to combine, q head), 8 to a block (grid: tokens, or
// fewer walked with a stride, x H / 8): every lane forms the chunks'
// weights exp(m_k - M) and the denominator in chunk order (the loads are
// the same for all lanes), then merges its columns' partial sums in chunk
// order. A token with no chunk writes 0.
template <typename T>
__global__ void __launch_bounds__(256) ragged_combine_kernel(const int* plan, const float* acc,
                                                             const float* ml, void* out_, int H,
                                                             int D, long long osh, long long oss,
                                                             float v_scale) {
  const int h = blockIdx.y * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (h >= H) return;
  const int n_comb = plan[4];
  const int* comb = plan_comb(plan);
  for (int entry = blockIdx.x; entry < n_comb; entry += gridDim.x) {
  const int* e = comb + (long long)entry * kCombInts;
  const int t = e[0], first = e[1], nch = e[2];
  float M = NXDI_NEG_INF;
#pragma unroll 8
  for (int k = 0; k < nch; ++k) M = fmaxf(M, ml[2 * ((long long)(first + k) * H + h)]);
  float L = 0.f;
#pragma unroll 8
  for (int k = 0; k < nch; ++k) {
    const long long sl = (long long)(first + k) * H + h;
    L = fmaf(ml[2 * sl + 1], expf(ml[2 * sl] - M), L);
  }
  const float inv = nch > 0 ? v_scale / fmaxf(L, 1e-20f) : 0.f;
  T* out = static_cast<T*>(out_);
  for (int d = lane; d < D; d += 32) {
    float A = 0.f;
#pragma unroll 8
    for (int k = 0; k < nch; ++k) {
      const long long sl = (long long)(first + k) * H + h;
      A = fmaf(acc[sl * D + d], expf(ml[2 * sl] - M), A);
    }
    out[h * osh + t * oss + d] = from_f32<T>(A * inv);
  }
  }  // tokens to combine
}

template <typename T, typename S, int DMAX, int RMAX>
cudaError_t launch_split(const SplitArgs& a, int n_items, cudaStream_t stream) {
  const size_t smem = split_float_bytes(a.D) + kSplitWarps * 32 * (size_t)a.D * sizeof(S);
  cudaError_t err = cudaFuncSetAttribute(ragged_split_kernel<T, S, DMAX, RMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ragged_split_kernel<T, S, DMAX, RMAX>
      <<<dim3(n_items, a.KV), kSplitWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename S, int DMAX>
cudaError_t launch_split_rows(const SplitArgs& a, int n_items, int rows, cudaStream_t stream) {
  return rows <= 4 ? launch_split<T, S, DMAX, 4>(a, n_items, stream)
                   : launch_split<T, S, DMAX, kSplitRows>(a, n_items, stream);
}

// The split kernel over the items (one token each: its G q heads a pass),
// then the combine; n_items and n_comb are the grids.
template <typename T, typename S = T>
cudaError_t run_split(const SplitArgs& a, int n_items, int n_comb, cudaStream_t stream) {
  if (n_items > 0) {
    const int G = a.H / a.KV;
    const cudaError_t err = a.D <= 64 ? launch_split_rows<T, S, 64>(a, n_items, G, stream)
                                      : launch_split_rows<T, S, 128>(a, n_items, G, stream);
    if (err != cudaSuccess) return err;
  }
  if (n_comb > 0) {
    const dim3 grid(n_comb, (a.H + 7) / 8);
    ragged_combine_kernel<T><<<grid, 256, 0, stream>>>(a.plan, a.acc, a.ml, a.out, a.H, a.D,
                                                       a.osh, a.oss, a.v_scale);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

}  // namespace
