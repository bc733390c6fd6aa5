// The split and combine kernels of ragged paged attention (ragged_paged.cu
// describes the scheme), shared by ragged_paged.cu and the one-byte stores'
// instantiations in ragged_paged_1b.cu and ragged_split_1b.cu.
//
// The split kernel has two bodies. A split item has the shape of a decode
// kernel block (one query position, the G q heads of one kv head, a chunk of
// one row's table), so with bf16 q at head dims that are multiples of 16 it
// runs the decode kernel's tensor-core tile loop (mma_tiles.cuh: mma.sync
// with the q heads as the rows of an m16 tile, 16 heads a pass; P rounded
// to bf16 as before; K/V tiles by cp.async, a one-byte pool's raw tiles
// converted exactly to bf16 in shared memory, so its output equals the bf16
// pool's on the pool up-cast to bf16, bit for bit). Elsewhere (f32 q, other
// head dims) it runs on the CUDA cores: each lane loads its own K row into
// registers, V lands by cp.async, and P.V walks the tile's positions.
#pragma once

#include "mma_tiles.cuh"
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
// bf16 q over a one-byte pool (the tensor-core body), at head dims up to 64
// and up to 128: a warp's raw tiles in flight and its bf16 tiles. Small, so
// that a decode-only bucket's items (one tile a warp at chunk 128) fit on
// the card at once.
constexpr int kSplitRaw[2] = {1, 1};
constexpr int kSplitCvt[2] = {1, 1};
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

// The tensor-core body's shared memory: each warp's ring, with the merge
// area (m, l [NW][16], acc [NW][16][D], f32) over the rings once the tiles
// are done
// (a bf16 pool's tiles double-buffered, as the decode kernel's)
template <typename S, int DMAX>
constexpr int kSplitStages = kOneByte<S> ? kSplitRaw[DMAX > 64] : 2;
// Warps of the tensor-core body: 4, or 2 at head dim 256 (Gemma's), where
// four warps' bf16 rings (66 KB each) would pass the 227 KB a block may
// use, as the decode kernel's dec_warps halves them there
template <int DMAX>
__host__ __device__ constexpr int split_mma_warps() {
  return DMAX > 128 ? 2 : kSplitWarps;
}
template <typename S, int DMAX>
__host__ __device__ inline size_t split_mma_ring_bytes(int D) {
  return mma_ring_bytes<S, kSplitStages<S, DMAX>, kSplitCvt[DMAX > 64]>(D);
}
template <typename S, int DMAX>
inline size_t split_mma_smem(int D) {
  constexpr int NW = split_mma_warps<DMAX>();
  const size_t rings = NW * split_mma_ring_bytes<S, DMAX>(D);
  const size_t merge = sizeof(float) * (size_t)(2 * NW * 16 + NW * 16 * D);
  return rings > merge ? rings : merge;
}

// bf16 q: each item's chunk on the tensor-core tile loop, 16 of the kv
// head's q heads a pass; the warps merged as the CUDA-core body merges them
template <typename S, int DMAX>
__device__ __forceinline__ void split_items_mma(const SplitArgs& a, float* smem) {
  using T = __nv_bfloat16;
  constexpr int NW = split_mma_warps<DMAX>(), RM = 16;
  const int D = a.D, G = a.H / a.KV;
  const int tid = threadIdx.x, warp = tid >> 5;
  char* my_ring = reinterpret_cast<char*>(smem) + (size_t)warp * split_mma_ring_bytes<S, DMAX>(D);
  const int kvh = blockIdx.y;
  const long long rs = (long long)a.KV * D;  // pool row stride
  const S* kc = static_cast<const S*>(a.kc) + kvh * D;
  const S* vc = static_cast<const S*>(a.vc) + kvh * D;
  const T* q = static_cast<const T*>(a.q);
  T* out = static_cast<T*>(a.out);
  const int n_items = a.plan[2];
  const int* items = plan_items(a.plan);
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int* it = items + (long long)item * kItemInts;
    const int t = it[0], row = it[1], lo = it[2], hi = it[3], c = it[4], nch = it[5],
              slot0 = it[6];
    const int pos = a.tok_pos[t];
    const int* btr = a.bt + (long long)row * a.nb;
    auto slot_of = [&](int j) -> long long {
      const int blk = btr[j / a.bs];
      return blk < 0 ? -1 : (long long)blk * a.bs + j % a.bs;
    };
    for (int pass = 0; pass < G; pass += RM) {
      const int rows = min(RM, G - pass);
      MmaTiles<S, DMAX, NW, kSplitStages<S, DMAX>, kSplitCvt[DMAX > 64]> tiles(my_ring, kc, vc,
                                                                               rs, D, lo, hi);
      tiles.start(slot_of);
      // q row r of the pass: q head kvh * G + pass + r of token t, two columns a word
      const T* qt = q + (long long)(kvh * G + pass) * a.qsh + (long long)t * a.qss;
      uint32_t qf[DMAX / 16][4];
      mma_q_frags<DMAX>(qf, D, [&](int r, int col) -> uint32_t {
        return r < rows ? *reinterpret_cast<const uint32_t*>(qt + r * a.qsh + col) : 0u;
      });
      MmaState<DMAX> st;
      tiles.template run<true>(st, qf, a.scale, slot_of, [&](int j) { return j <= pos; });
      // the merge area over the rings: m, l [NW][rows], acc [NW][rows][D]
      float* sM = smem;
      float* sL = sM + NW * rows;
      float* sAcc = sL + NW * rows;
      __syncthreads();  // every warp is done with its ring
      mma_state_store<DMAX>(st, sM, sL, sAcc, rows, D);
      __syncthreads();
      // merge the warps; write the output (one chunk) or the chunk's partials
      for (int i = tid; i < rows * D; i += blockDim.x) {
        const int g = i / D, d = i % D;
        float M = NXDI_NEG_INF;
        for (int w = 0; w < NW; ++w) M = fmaxf(M, sM[w * rows + g]);
        float L = 0.f, A = 0.f;
        for (int w = 0; w < NW; ++w) {
          const float f = expf(sM[w * rows + g] - M);
          L = fmaf(sL[w * rows + g], f, L);
          A = fmaf(sAcc[(w * rows + g) * D + d], f, A);
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
      __syncthreads();  // the next pass (or item) overwrites the rings and the merge area
    }
  }
}

// T: q's and the output's type; S: the pool's store type (T or one byte).
// MMA: the tensor-core body (bf16 q, head dim a multiple of 16), else the
// CUDA cores.
template <typename T, typename S, int DMAX, int RMAX, bool MMA>
__global__ void __launch_bounds__(kSplitWarps * 32) ragged_split_kernel(SplitArgs a) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (MMA) {
    static_assert(std::is_same<T, __nv_bfloat16>::value, "the tensor cores take bf16 q");
    split_items_mma<S, DMAX>(a, smem);
  } else {
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
      {  // this lane's K row against every q row of the pass, its 16-byte
         // chunks in flight at once (up to head dim 128 in f32; above, in
         // batches of KB, which keeps the batch's registers at 64)
        constexpr int EPC = 16 / sizeof(S), KC = DMAX / EPC;
        constexpr int KB = KC > 32 ? 16 : KC;
        const uint4* krow = reinterpret_cast<const uint4*>(kc + slot * rs);
#pragma unroll
        for (int c0 = 0; c0 < KC; c0 += KB) {
          uint4 kreg[KB];
#pragma unroll
          for (int ch = 0; ch < KB; ++ch)
            kreg[ch] = (live && (c0 + ch) * EPC < D) ? krow[c0 + ch] : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
          for (int ch = 0; ch < KB; ++ch) {
            if ((c0 + ch) * EPC < D) {
              float kf[EPC];
              unpack16(kreg[ch], kf, S());
#pragma unroll
              for (int g = 0; g < RMAX; ++g) {
                if (g < rows) {
#pragma unroll
                  for (int e = 0; e < EPC; e += 4) {
                    const float4 q4 =
                        *reinterpret_cast<const float4*>(&sQ[g * D + (c0 + ch) * EPC + e]);
                    s[g] = fmaf(q4.x, kf[e], fmaf(q4.y, kf[e + 1],
                                fmaf(q4.z, kf[e + 2], fmaf(q4.w, kf[e + 3], s[g]))));
                  }
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

// (the CUDA-core body at head dim 256 in f32: an 80 KB merge area and four
// 32 KB V tiles, 209 KB in all)
template <typename T, typename S, int DMAX, int RMAX, bool MMA = false>
cudaError_t launch_split(const SplitArgs& a, int n_items, cudaStream_t stream) {
  const size_t smem = MMA ? split_mma_smem<S, DMAX>(a.D)
                          : split_float_bytes(a.D) + kSplitWarps * 32 * (size_t)a.D * sizeof(S);
  cudaError_t err = cudaFuncSetAttribute(ragged_split_kernel<T, S, DMAX, RMAX, MMA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int warps = MMA ? split_mma_warps<DMAX>() : kSplitWarps;
  ragged_split_kernel<T, S, DMAX, RMAX, MMA>
      <<<dim3(n_items, a.KV), warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename S, int DMAX>
cudaError_t launch_split_rows(const SplitArgs& a, int n_items, int rows, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (a.D % 16 == 0) return launch_split<T, S, DMAX, 16, true>(a, n_items, stream);
  }
  if constexpr (kOneByte<S> && !std::is_same<T, float>::value) {
    return cudaErrorInvalidValue;  // (the one-byte wrapper takes head dims that are multiples of 16)
  } else {
    return rows <= 4 ? launch_split<T, S, DMAX, 4>(a, n_items, stream)
                     : launch_split<T, S, DMAX, kSplitRows>(a, n_items, stream);
  }
}

// The split kernel over the items (one token each: its G q heads a pass),
// then the combine; n_items and n_comb are the grids. bf16 q at head dims
// that are multiples of 16 (every one-byte pool's: the wrapper requires it)
// runs the tensor-core body. Head dims up to 256: DMAX 64, 128 or 256 (the
// combine walks any D, 32 columns a step).
template <typename T, typename S = T>
cudaError_t run_split(const SplitArgs& a, int n_items, int n_comb, cudaStream_t stream) {
  if (n_items > 0) {
    const int G = a.H / a.KV;
    const cudaError_t err = a.D <= 64    ? launch_split_rows<T, S, 64>(a, n_items, G, stream)
                            : a.D <= 128 ? launch_split_rows<T, S, 128>(a, n_items, G, stream)
                                         : launch_split_rows<T, S, 256>(a, n_items, G, stream);
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
