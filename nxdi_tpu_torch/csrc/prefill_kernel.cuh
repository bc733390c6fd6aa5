// Causal flash attention for prefill (context encoding), contiguous, paged or
// ragged: the kernels shared by flash_prefill.cu, paged_prefill.cu and
// ragged_paged.cu.
//
// Replaces nxdi_tpu/ops/kernels/flash_attention.py::flash_attention_prefill
// (Pallas body _prefill_kernel). Same function: q (B,H,Sq,D) attends k/v
// (B,KV,Sk,D) with positions affine per row (q_start[b] + i, kv_start[b] + j),
// optional sliding-window and chunk masks, GQA head h -> kv head h / (H/KV)
// without repeating K/V, an f32 online softmax with mask value -30000 and the
// denominator clamped at 1e-20, and probabilities rounded to the input dtype
// before the P.V product (as the Pallas kernel feeds the MXU).
//
// The paged entry (nxdi_paged_prefill, paged_prefill.cu) replaces
// ::paged_attention_prefill (Pallas body _paged_prefill_kernel): the same
// kernels read K/V through a block table from the pool (total_slots, KV, D)
// — logical position j lives in slot bt[b][j / bs] * bs + j % bs, a head's
// rows KV * D elements apart, slot offsets in 64 bits — so a prefix-cached or
// chunked prefill attends the prefix and the chunk itself (already scattered
// into the pool) in token order. Holes (negative entries) are zero-filled
// and masked; tiles past the q tile's last position are never read. k_scale
// arrives folded into `scale`, v_scale multiplies the output. The paged and
// ragged modes also read a one-byte pool (float8_e4m3fn, float8_e5m2, int8;
// template parameter S): the mma.sync body loads each K/V tile's rows 8
// elements at a time and writes them to shared memory as bf16, the
// CUDA-core body converts 4 at a time to f32 — exact in both, so the only
// rounding is the store's own. These loads are synchronous (the bf16 tiles
// keep their cp.async double buffer), so they now serve f32 q, head dims
// other than 64 and 128, and the earlier design when its code is passed.
// bf16 q at head dim 64 or 128 over a one-byte pool runs the one-byte TMA +
// wgmma body of prefill_wgmma.cuh (the paged prefill, replacing
// flash_attention.py::paged_attention_prefill, pl.pallas_call at :946,
// bound by operations: 0.0033 ms for a 512-token chunk after 512 cached;
// and the ragged kernel's wgmma items): wgmma multiplies bf16 only by bf16
// and q stays bf16 as on the TPU, so the raw one-byte boxes land by TMA
// and idle producer warps convert them to bf16 in shared memory, where the
// tensor cores read them (flash_attention.py::paged_prefill_body,
// ragged_paged_attention.py::ragged_direct_body).
//
// The ragged entry (nxdi_ragged_paged, ragged_paged.cu) replaces
// nxdi_tpu/ops/kernels/ragged_paged_attention.py::ragged_paged_attention for
// the q tiles its work list hands these kernels: tiles that hold the tokens
// of one row only (the prefill chunks of a packed stream), one block per
// (listed 64-token tile, q head). The tile's tags are loaded by the block
// itself (the TPU kernel's scalar prefetch): a bitmask of the rows present
// and the largest position of each, and each present row's table is walked
// up to that position, masking on row and position; padding tokens (row -1)
// and tokens with no visible key output exactly 0. A bitmask, not the TPU
// kernel's per-tile [min, max] row range: the engine packs prefill chunks
// first and decode rows after them, so slots do not ascend along the stream.
// The bitmask bounds a call to 64 rows; under the split plan (ragged_paged_
// attention.py::ragged_plan, split=True) every listed tile holds the tokens
// of one row, so the block finds that row and its largest position without
// the mask and any number of rows works. Decode tokens and tiles holding
// several rows go to ragged_paged.cu's split kernel (flash decoding over kv
// chunks).
//
// Three entry points, one per source so they compile in parallel:
// flash_prefill.cu (contiguous K/V), paged_prefill.cu (through the block
// table) and ragged_paged.cu; the addressing mode is a template parameter, so
// the contiguous kernels compile as if the others did not exist. Two bodies
// here (the contiguous and paged bf16 prefills at head dims 64 and 128 run
// the TMA + wgmma body of prefill_wgmma.cuh instead); both loop over 64-row
// kv tiles up to the causal limit of their 64-row q tile (one block per
// (b, h, q tile)) and mask the ragged edges of Sq and Sk themselves, so no
// block size has to divide them:
//  - prefill_tc_kernel (bf16, head dim a multiple of 16): 4 warps, each owning
//    16 q rows; Q.K^T and P.V on the tensor cores with mma.sync m16n8k16
//    (f32 accumulation), the score tile kept in registers and re-packed as the
//    A operand of P.V; K/V tiles double-buffered in shared memory by cp.async;
//    the softmax runs in log2 units (exp2) and only diagonal tiles are masked.
//  - prefill_kernel (f32, or other head dims): 8 warps of 8 q rows; K and V
//    staged in shared memory as f32 and multiplied on the CUDA cores in f32,
//    so f32 inputs keep f32 products.
//
// Bound: a paged or ragged prefill chunk is bound by operations on the
// tensor cores (a 512-token chunk after 512 cached: 3.4 us at 989 TFLOP/s in
// bf16); mma.sync reaches a few per cent of that. The paged mode runs the
// wgmma body (TMA boxes per pool block) where its wrapper can, and so do
// the ragged mode's one-row tiles over a one-byte pool (as wgmma items);
// a bf16 pool's direct tiles taking it is the next step.
#pragma once

#include <cuda_pipeline.h>

#include "common.cuh"

// outside the unnamed namespace: the paged and ragged entries pass it to
// their one-byte instantiations (paged_prefill_1b.cu, ragged_paged_1b.cu)
struct PrefillArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const int* q_start;
  const int* kv_start;  // may be null: kv row j is position j
  const int* bt;        // paged: (B, nb) block table; ragged: (R, nb); -1 = hole
  const int* row_ids;   // ragged: (Sq,) row of each packed token, -1 = padding
  const int* tok_pos;   // ragged: (Sq,) position of each packed token in its row
  const int* tiles;     // ragged: the q tiles to run, one block each
  const int* n_listed;  // ragged: how many of them (on the device; n_tiles is the grid)
  const int* plan;      // ragged: the whole work list (the wgmma items' counts and place)
  int H, KV, Sq, Sk, D, nb, bs, R, n_tiles;
  int one_row;          // ragged: every listed tile holds one row's tokens (and padding)
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  float scale, v_scale;
  int window, chunk;
};

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 8;                 // q rows per warp
constexpr int kBQ = kWarps * kRows;      // q rows per block
constexpr int kBK = 64;                  // kv rows per tile
// output columns per lane of the CUDA-core body: 4 (D <= 128) or 8 (D <= 256:
// Gemma's head dim, every mode)
constexpr int kMaxTAt128 = 4;
constexpr int kMaxRaggedRows = 64;       // rows of a stream with mixed tiles (one 64-bit mask)
// The ragged work list (ragged_paged_attention.py::ragged_plan): a header of
// kPlanHeader ints (T, direct tiles, split items, partial slots, tokens to
// combine, chunk, wgmma items, 0), then the direct tiles (one int each), the
// wgmma items (kWgInts each: first token, tokens, row, first position), the
// split items and the tokens to combine.
constexpr int kPlanHeader = 8;
constexpr int kPlanWgCount = 6;  // the header's count of wgmma items
constexpr int kWgInts = 4;

// K/V addressing: contiguous rows, a block table per batch row, or the ragged
// stream's per-token rows
enum KvMode : int { KV_CONTIG = 0, KV_PAGED = 1, KV_RAGGED = 2 };

// prefill body codes shared with the wrappers (flash_attention.py::PREFILL_BODIES)
enum PrefillBody : int { PREFILL_SIMT = 0, PREFILL_MMA = 1, PREFILL_WGMMA = 2 };

// The rows a ragged q tile touches, in shared memory after the tiles. A
// tile holds at most 64 tokens, so at most 64 rows, whatever R is.
struct RaggedMeta {
  unsigned long long mask;           // rows present in the tile (R <= 64)
  int n_rows, n_items;               // present rows; (row, kv tile) work items
  int rows[kMaxRaggedRows];          // present row ids, ascending
  int limit[kMaxRaggedRows];         // kv positions [0, limit) any of its tokens can see
  int ntile[kMaxRaggedRows];         // kv tiles of the row
  int max_pos[kMaxRaggedRows];       // by row id (R <= 64), or [0] for a one-row tile
};

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// Ragged: whether this block lies past the listed tiles. The grid may be
// larger than the list (a launch sized from shapes, as a CUDA graph holds
// it); such a block exits at once.
template <int MODE>
__device__ __forceinline__ bool past_listed_tiles(const PrefillArgs& a) {
  if constexpr (MODE == KV_RAGGED) {
    return (int)blockIdx.x >= *a.n_listed;
  } else {
    return false;
  }
}

// First token of the block's q tile: the listed tile (ragged) or blockIdx.x.
template <int MODE>
__device__ __forceinline__ int q_tile_start(const PrefillArgs& a, int rows) {
  if constexpr (MODE == KV_RAGGED) {
    return a.tiles[blockIdx.x] * rows;
  } else {
    return blockIdx.x * rows;
  }
}

// Storage row of kv position j (< Sk): j itself, or (paged, ragged) its slot
// through the batch row's block table btr, -1 for a hole. A template
// parameter, so the contiguous kernels compile exactly as without paging.
template <int MODE>
__device__ __forceinline__ long long kv_slot(const int* btr, int bs, int j) {
  if constexpr (MODE == KV_CONTIG) {
    return j;
  } else {
    const int blk = btr[j / bs];
    return blk < 0 ? -1 : (long long)blk * bs + j % bs;
  }
}

// Whether kv tile [j0, j0 + n) (clipped to Sk) is free of holes.
template <int MODE>
__device__ __forceinline__ bool tile_clean(const int* btr, int bs, int j0, int n, int Sk) {
  if constexpr (MODE == KV_CONTIG) {
    return true;
  } else {
    const int hi = min(j0 + n, Sk) - 1;
    bool ok = true;
    for (int e = j0 / bs; e <= hi / bs; ++e) ok = ok && btr[e] >= 0;
    return ok;
  }
}

// Ragged: gather the tile's present rows and the largest position of each,
// and lay out the (row, kv tile) work items. A one-row tile (a.one_row) takes
// its row and largest position by two atomicMax; otherwise a bitmask of row
// ids (R <= 64) and the largest position by row id. Every thread calls it;
// it ends on a barrier.
template <int TILE_KV>
__device__ void ragged_meta_build(RaggedMeta* meta, const PrefillArgs& a, int q0, int q_rows) {
  const int tid = threadIdx.x;
  for (int i = tid; i < kMaxRaggedRows; i += blockDim.x) meta->max_pos[i] = -1;
  if (tid == 0) {
    meta->mask = 0ull;
    meta->rows[0] = -1;
  }
  __syncthreads();
  for (int i = tid; i < q_rows; i += blockDim.x) {
    const int t = q0 + i;
    if (t < a.Sq) {
      const int r = a.row_ids[t];
      if (r >= 0 && r < a.R) {
        if (a.one_row) {
          atomicMax(&meta->rows[0], r);
          atomicMax(&meta->max_pos[0], a.tok_pos[t]);
        } else {
          atomicOr(&meta->mask, 1ull << r);
          atomicMax(&meta->max_pos[r], a.tok_pos[t]);
        }
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0, items = 0;
    auto add = [&](int r, int top) {
      const int lim = min(top + 1, a.nb * a.bs);
      if (lim <= 0) return;
      meta->rows[n] = r;
      meta->limit[n] = lim;
      meta->ntile[n] = (lim + TILE_KV - 1) / TILE_KV;
      items += meta->ntile[n];
      ++n;
    };
    if (a.one_row) {
      if (meta->rows[0] >= 0) add(meta->rows[0], meta->max_pos[0]);
    } else {
      unsigned long long m = meta->mask;
      while (m) {
        const int r = __ffsll((long long)m) - 1;
        m &= m - 1;
        add(r, meta->max_pos[r]);
      }
    }
    meta->n_rows = n;
    meta->n_items = items;
  }
  __syncthreads();
}

// The kv tile a work item reads: the row's table and extent (ragged) or the
// batch row's (contiguous, paged).
struct KvTile {
  int row, kt, limit;
  const int* table;
};

// Work-item cursor: item (k, kt) is kv tile kt of the k-th present row
// (ragged), or kv tile kt (contiguous, paged: k stays 0).
template <int MODE>
__device__ __forceinline__ void cursor_next(int& k, int& kt, const RaggedMeta* meta) {
  ++kt;
  if constexpr (MODE == KV_RAGGED) {
    if (kt == meta->ntile[k]) {
      ++k;
      kt = 0;
    }
  }
}

template <int MODE>
__device__ __forceinline__ KvTile cursor_tile(int k, int kt, const RaggedMeta* meta,
                                              const PrefillArgs& a, const int* btr) {
  if constexpr (MODE == KV_RAGGED) {
    const int r = meta->rows[k];
    return KvTile{r, kt, meta->limit[k], a.bt + (long long)r * a.nb};
  } else {
    return KvTile{0, kt, a.Sk, btr};
  }
}

__host__ __device__ inline size_t prefill_smem_bytes(int D) {
  return sizeof(float) * (size_t)(kBQ * D + kBK * (D + 4) + kBK * D + kWarps * kRows * kBK);
}

template <typename T, int MODE, typename S = T, int kMaxT = kMaxTAt128>
__global__ void __launch_bounds__(kWarps * 32) prefill_kernel(PrefillArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D;
  const int DP = D + 4;  // padded K rows: conflict-free float4 reads per lane
  float* sQ = smem;                // [kBQ][D]
  float* sK = sQ + kBQ * D;        // [kBK][DP]
  float* sV = sK + kBK * DP;       // [kBK][D]
  float* sP = sV + kBK * D;        // [kWarps][kRows][kBK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  if (past_listed_tiles<MODE>(a)) return;
  const int q0 = q_tile_start<MODE>(a, kBQ);
  int qs = 0;
  if constexpr (MODE != KV_RAGGED) qs = a.q_start[b];
  const int ks = a.kv_start ? a.kv_start[b] : 0;
  const int* btr = MODE == KV_PAGED ? a.bt + (long long)b * a.nb : nullptr;

  const T* q = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const S* k = static_cast<const S*>(a.k) + b * a.ksb + kvh * a.ksh;
  const S* v = static_cast<const S*>(a.v) + b * a.vsb + kvh * a.vsh;
  T* out = static_cast<T*>(a.out) + b * a.osb + h * a.osh;

  const int D4 = D / 4;
  for (int i = tid; i < kBQ * D4; i += blockDim.x) {
    const int r = i / D4, c = (i % D4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < a.Sq) val = load4(q + (long long)(q0 + r) * a.qss + c);
    *reinterpret_cast<float4*>(&sQ[r * D + c]) = val;
  }

  const int r0 = warp * kRows;
  float m[kRows], l[kRows], acc[kRows][kMaxT];
  int rpos[kRows], rrow[kRows];  // each row's position (and ragged row id)
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = NXDI_NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) acc[r][t] = 0.f;
    if constexpr (MODE == KV_RAGGED) {
      const int tq = q0 + r0 + r;
      rrow[r] = tq < a.Sq ? a.row_ids[tq] : -1;
      rpos[r] = tq < a.Sq ? a.tok_pos[tq] : 0;
    } else {
      rrow[r] = 0;
      rpos[r] = qs + q0 + r0 + r;
    }
  }
  float* myP = sP + warp * kRows * kBK;

  RaggedMeta* meta = nullptr;
  int n_items;
  if constexpr (MODE == KV_RAGGED) {
    meta = reinterpret_cast<RaggedMeta*>(reinterpret_cast<char*>(smem) +
                                         round16(prefill_smem_bytes(D)));
    ragged_meta_build<kBK>(meta, a, q0, kBQ);
    n_items = meta->n_items;
  } else {
    const int q_hi = qs + min(q0 + kBQ, a.Sq) - 1;  // last real q position
    n_items = (a.Sk + kBK - 1) / kBK;
    for (int kt = 0; kt < n_items; ++kt)
      if (ks + kt * kBK > q_hi) {  // this and later tiles wholly in the future
        n_items = kt;
        break;
      }
  }
  int ck = 0, ckt = 0;
  for (int it = 0; it < n_items; ++it) {
    const KvTile tile = cursor_tile<MODE>(ck, ckt, meta, a, btr);
    const int kt = tile.kt;
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < kBK * D4; i += blockDim.x) {
      const int j = i / D4, c = (i % D4) * 4;
      const int s = kt * kBK + j;
      float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kv4;
      const long long slot = s < tile.limit ? kv_slot<MODE>(tile.table, a.bs, s) : -1;
      if (slot >= 0) {
        kv4 = load4(k + slot * a.kss + c);
        vv4 = load4(v + slot * a.vss + c);
      }
      *reinterpret_cast<float4*>(&sK[j * DP + c]) = kv4;
      *reinterpret_cast<float4*>(&sV[j * D + c]) = vv4;
    }
    __syncthreads();

    // scores for this warp's rows, columns lane and lane + 32
    float s0[kRows], s1[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s0[r] = s1[r] = 0.f;
    for (int d = 0; d < D; d += 4) {
      const float4 k0 = *reinterpret_cast<const float4*>(&sK[lane * DP + d]);
      const float4 k1 = *reinterpret_cast<const float4*>(&sK[(lane + 32) * DP + d]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(&sQ[(r0 + r) * D + d]);
        s0[r] = fmaf(qv.x, k0.x, fmaf(qv.y, k0.y, fmaf(qv.z, k0.z, fmaf(qv.w, k0.w, s0[r]))));
        s1[r] = fmaf(qv.x, k1.x, fmaf(qv.y, k1.y, fmaf(qv.z, k1.z, fmaf(qv.w, k1.w, s1[r]))));
      }
    }

    const int j0 = kt * kBK + lane, j1 = j0 + 32;
    const bool live0 = j0 < tile.limit && kv_slot<MODE>(tile.table, a.bs, j0) >= 0;
    const bool live1 = j1 < tile.limit && kv_slot<MODE>(tile.table, a.bs, j1) >= 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool mine = MODE != KV_RAGGED || rrow[r] == tile.row;
      const bool v0 = live0 && mine && pos_visible(ks + j0, rpos[r], false, a.window, a.chunk);
      const bool v1 = live1 && mine && pos_visible(ks + j1, rpos[r], false, a.window, a.chunk);
      const float sc0 = v0 ? s0[r] * a.scale : NXDI_NEG_INF;
      const float sc1 = v1 ? s1[r] * a.scale : NXDI_NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(sc0, sc1)));
      const float corr = expf(m[r] - m_new);
      const float p0 = v0 ? expf(sc0 - m_new) : 0.f;
      const float p1 = v1 ? expf(sc1 - m_new) : 0.f;
      l[r] = l[r] * corr + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int t = 0; t < kMaxT; ++t) acc[r][t] *= corr;
      myP[r * kBK + lane] = round_through<T>(p0);
      myP[r * kBK + lane + 32] = round_through<T>(p1);
    }
    __syncwarp();

    for (int c = 0; c < kBK; c += 4) {
      float4 p4[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) p4[r] = *reinterpret_cast<const float4*>(&myP[r * kBK + c]);
#pragma unroll
      for (int t = 0; t < kMaxT; ++t) {
        const int d = lane + 32 * t;
        if (d < D) {
          const float va = sV[(c + 0) * D + d], vb = sV[(c + 1) * D + d];
          const float vc = sV[(c + 2) * D + d], vd = sV[(c + 3) * D + d];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[r][t] = fmaf(p4[r].x, va, fmaf(p4[r].y, vb, fmaf(p4[r].z, vc, fmaf(p4[r].w, vd, acc[r][t]))));
        }
      }
    }
    __syncwarp();
    cursor_next<MODE>(ck, ckt, meta);
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + r0 + r;
    if (row >= a.Sq) continue;
    const float inv = a.v_scale / fmaxf(l[r], 1e-20f);
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      const int d = lane + 32 * t;
      if (d < D) out[(long long)row * a.oss + d] = from_f32<T>(acc[r][t] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core body (bf16)
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcBQ = 16 * kTcWarps;  // q rows per block
constexpr int kTcBK = 64;             // kv rows per tile

__host__ __device__ inline size_t prefill_tc_smem_bytes(int D) {
  return sizeof(__nv_bfloat16) * (size_t)(5 * kTcBK * (D + 8));  // Q + 2 K + 2 V tiles
}

// rows [row0, row0 + 64) of a (rows, D) bf16 or one-byte matrix into a
// padded bf16 smem tile, row j read from storage row kv_slot<MODE>(btr, bs,
// j); rows at or past `limit` and holes are zero-filled. bf16 rows are
// copied by cp.async; one-byte rows are loaded 8 elements at a time and
// converted.
template <int MODE, typename S>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const S* src, long long stride,
                                           int row0, int limit, int D, int DP, const int* btr,
                                           int bs) {
  const int cpr = D / 8;  // 8-element chunks per row (16 bytes of bf16)
  for (int i = threadIdx.x; i < kTcBK * cpr; i += blockDim.x) {
    const int r = i / cpr, c = i % cpr;
    const long long slot = row0 + r < limit ? kv_slot<MODE>(btr, bs, row0 + r) : -1;
    const bool ok = slot >= 0;
    const S* g = src + (ok ? slot : 0) * stride + c * 8;
    if constexpr (kOneByte<S>) {
      const uint2 u = ok ? *reinterpret_cast<const uint2*>(g) : make_uint2(0u, 0u);
      store_converted<__nv_bfloat16, S, 8>(dst + r * DP + c * 8, u);
    } else {
      __pipeline_memcpy_async(dst + r * DP + c * 8, g, 16, ok ? 0 : 16);
    }
  }
}

template <int DMAX, int MODE, typename S = __nv_bfloat16>
__global__ void __launch_bounds__(kTcWarps * 32) prefill_tc_kernel(PrefillArgs a) {
  extern __shared__ __align__(16) __nv_bfloat16 tsm[];
  const int D = a.D, DP = D + 8;
  __nv_bfloat16* sQ = tsm;                  // [64][DP]
  __nv_bfloat16* sK = sQ + kTcBK * DP;      // [2][64][DP]
  __nv_bfloat16* sV = sK + 2 * kTcBK * DP;  // [2][64][DP]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  if (past_listed_tiles<MODE>(a)) return;
  const int q0 = q_tile_start<MODE>(a, kTcBQ);
  int qs = 0;
  if constexpr (MODE != KV_RAGGED) qs = a.q_start[b];
  const int ks = a.kv_start ? a.kv_start[b] : 0;
  const int* btr = MODE == KV_PAGED ? a.bt + (long long)b * a.nb : nullptr;
  using bf = __nv_bfloat16;
  const bf* q = static_cast<const bf*>(a.q) + b * a.qsb + h * a.qsh;
  const S* k = static_cast<const S*>(a.k) + b * a.ksb + kvh * a.ksh;
  const S* v = static_cast<const S*>(a.v) + b * a.vsb + kvh * a.vsh;
  bf* out = static_cast<bf*>(a.out) + b * a.osb + h * a.osh;

  RaggedMeta* meta = nullptr;
  int n_items;
  if constexpr (MODE == KV_RAGGED) {
    meta = reinterpret_cast<RaggedMeta*>(reinterpret_cast<char*>(tsm) +
                                         round16(prefill_tc_smem_bytes(D)));
    ragged_meta_build<kTcBK>(meta, a, q0, kTcBQ);
    n_items = meta->n_items;
  } else {
    const int q_hi = qs + min(q0 + kTcBQ, a.Sq) - 1;  // last real q position
    n_items = (a.Sk + kTcBK - 1) / kTcBK;
    for (int kt = 0; kt < n_items; ++kt)
      if (ks + kt * kTcBK > q_hi) {  // this and later tiles wholly in the future
        n_items = kt;
        break;
      }
  }

  // work items: cursor (ck, ckt) is the tile being computed, (pk, pkt) the
  // one being prefetched
  int ck = 0, ckt = 0, pk = 0, pkt = 0;
  stage_rows<KV_CONTIG>(sQ, q, a.qss, q0, a.Sq, D, DP, nullptr, 1);
  if (n_items > 0) {
    const KvTile t0 = cursor_tile<MODE>(pk, pkt, meta, a, btr);
    stage_rows<MODE>(sK, k, a.kss, 0, t0.limit, D, DP, t0.table, a.bs);
    stage_rows<MODE>(sV, v, a.vss, 0, t0.limit, D, DP, t0.table, a.bs);
    cursor_next<MODE>(pk, pkt, meta);
  }
  __pipeline_commit();

  constexpr int KS = DMAX / 16;  // k-steps over the head dim
  constexpr int NT = DMAX / 8;   // 8-wide output column tiles
  // Q's A fragments stay in registers for the whole block up to head dim
  // 128; at 256 the output tile alone takes 128 registers a lane, so Q's
  // fragments are read from shared memory at each k-step instead
  constexpr bool kQRegs = DMAX <= 128;
  uint32_t qf[kQRegs ? KS : 1][4];
  float o[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr float kNegInfLog2 = NXDI_NEG_INF * kLog2e;
  const float scale_log2 = a.scale * kLog2e;
  float m[2] = {kNegInfLog2, kNegInfLog2}, l[2] = {0.f, 0.f};
  const int r_lo = warp * 16 + grp;  // this lane's two rows in the q tile: r_lo, r_lo + 8
  int rpos[2], rrow[2];              // their positions (and ragged row ids)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if constexpr (MODE == KV_RAGGED) {
      const int tq = q0 + r_lo + 8 * half;
      rrow[half] = tq < a.Sq ? a.row_ids[tq] : -1;
      rpos[half] = tq < a.Sq ? a.tok_pos[tq] : 0;
    } else {
      rrow[half] = 0;
      rpos[half] = qs + q0 + r_lo + 8 * half;
    }
  }

  for (int it = 0; it < n_items; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_items) {
      const KvTile tn = cursor_tile<MODE>(pk, pkt, meta, a, btr);
      stage_rows<MODE>(sK + (buf ^ 1) * kTcBK * DP, k, a.kss, tn.kt * kTcBK, tn.limit, D, DP,
                       tn.table, a.bs);
      stage_rows<MODE>(sV + (buf ^ 1) * kTcBK * DP, v, a.vss, tn.kt * kTcBK, tn.limit, D, DP,
                       tn.table, a.bs);
      cursor_next<MODE>(pk, pkt, meta);
      __pipeline_commit();
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    if (kQRegs && it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        if (kk * 16 < D) {
          const bf* base = sQ + kk * 16 + 2 * tig;
          qf[kk][0] = *reinterpret_cast<const uint32_t*>(base + r_lo * DP);
          qf[kk][1] = *reinterpret_cast<const uint32_t*>(base + (r_lo + 8) * DP);
          qf[kk][2] = *reinterpret_cast<const uint32_t*>(base + r_lo * DP + 8);
          qf[kk][3] = *reinterpret_cast<const uint32_t*>(base + (r_lo + 8) * DP + 8);
        }
      }
    }
    const KvTile tile = cursor_tile<MODE>(ck, ckt, meta, a, btr);
    const int kt = tile.kt;
    const bf* tK = sK + buf * kTcBK * DP;
    const bf* tV = sV + buf * kTcBK * DP;

    // S = Q K^T for this warp's 16 rows x 64 kv columns
    float sc[8][4];
    if constexpr (kQRegs) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
        const bf* krow = tK + (nt * 8 + grp) * DP + 2 * tig;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          if (kk * 16 < D) {
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
            mma_bf16(sc[nt], qf[kk], b0, b1);
          }
        }
      }
    } else {
      // the same products in the same order per score (k-steps ascending),
      // one k-step's Q fragment at a time
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        if (kk * 16 < D) {
          const bf* base = sQ + kk * 16 + 2 * tig;
          const uint32_t qk[4] = {*reinterpret_cast<const uint32_t*>(base + r_lo * DP),
                                  *reinterpret_cast<const uint32_t*>(base + (r_lo + 8) * DP),
                                  *reinterpret_cast<const uint32_t*>(base + r_lo * DP + 8),
                                  *reinterpret_cast<const uint32_t*>(base + (r_lo + 8) * DP + 8)};
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const bf* krow = tK + (nt * 8 + grp) * DP + 2 * tig + kk * 16;
            mma_bf16(sc[nt], qk, *reinterpret_cast<const uint32_t*>(krow),
                     *reinterpret_cast<const uint32_t*>(krow + 8));
          }
        }
      }
    }

    // mask + online softmax, rows r_lo (c0, c1) and r_lo + 8 (c2, c3), in
    // log2 units (scores times log2(e), exp2): the same softmax, cheaper exp.
    // A tile wholly before this warp's first row needs no mask (no window or
    // chunk, inside Sk, no hole; ragged: every row of the warp in the tile's
    // row): only tiles on the diagonal build one.
    bool full;
    if constexpr (MODE == KV_RAGGED) {
      const int jlast = (kt + 1) * kTcBK - 1;
      const bool mine = rrow[0] == tile.row && rrow[1] == tile.row && rpos[0] >= jlast &&
                        rpos[1] >= jlast;
      full = __all_sync(0xffffffffu, mine) && jlast < tile.limit &&
             tile_clean<MODE>(tile.table, a.bs, kt * kTcBK, kTcBK, tile.limit);
    } else {
      full = a.window <= 0 && a.chunk <= 0 && (kt + 1) * kTcBK <= a.Sk &&
             ks + (kt + 1) * kTcBK - 1 <= qs + q0 + warp * 16 &&
             tile_clean<MODE>(btr, a.bs, kt * kTcBK, kTcBK, a.Sk);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qp = rpos[half];
      const bool mine = MODE != KV_RAGGED || rrow[half] == tile.row;
      float mx = kNegInfLog2;
      uint32_t visible = 0xffffffffu;  // bit 2 * nt + e: column visible to this row
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float val = sc[nt][2 * half + e] * scale_log2;
          if (!full) {
            const int j = kt * kTcBK + nt * 8 + 2 * tig + e;
            const bool vis = mine && j < tile.limit &&
                             kv_slot<MODE>(tile.table, a.bs, j) >= 0 &&
                             pos_visible(ks + j, qp, false, a.window, a.chunk);
            val = vis ? val : kNegInfLog2;
            visible &= ~((uint32_t)!vis << (2 * nt + e));
          }
          sc[nt][2 * half + e] = val;
          mx = fmaxf(mx, val);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[half], mx);
      const float corr = exp2f(m[half] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ((visible >> (2 * nt + e)) & 1u) ? exp2f(sc[nt][2 * half + e] - m_new) : 0.f;
          sc[nt][2 * half + e] = p;
          rs += p;
        }
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[half] = l[half] * corr + rs;
      m[half] = m_new;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        o[t][2 * half] *= corr;
        o[t][2 * half + 1] *= corr;
      }
    }

    // O += P V: P (rounded to bf16) is the A operand straight from registers
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      const int vrow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int t = 0; t < NT; t += 2) {
        if (t * 8 < D) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, tV + vrow * DP + t * 8 + (lane >> 4) * 8);
          mma_bf16(o[t], pa, vb[0], vb[1]);
          mma_bf16(o[t + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // the next iteration's copies overwrite the other buffer
    cursor_next<MODE>(ck, ckt, meta);
  }
  __pipeline_wait_prior(0);  // no copy outlives the block, even with no kv tile

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r_lo + 8 * half;
    if (row >= a.Sq) continue;
    const float inv = a.v_scale / fmaxf(l[half], 1e-20f);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int d = t * 8 + 2 * tig;
      if (d < D) {
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * a.oss + d) =
            __floats2bfloat162_rn(o[t][2 * half] * inv, o[t][2 * half + 1] * inv);
      }
    }
  }
}

// dynamic shared memory of a launch: the tiles, and the ragged row metadata
template <int MODE>
size_t with_meta(size_t tiles) {
  return MODE == KV_RAGGED ? round16(tiles) + sizeof(RaggedMeta) : tiles;
}

template <int DMAX, int MODE, typename S = __nv_bfloat16>
cudaError_t launch_tc(const PrefillArgs& a, int B, cudaStream_t stream) {
  const size_t smem = with_meta<MODE>(prefill_tc_smem_bytes(a.D));
  cudaError_t err = cudaFuncSetAttribute(prefill_tc_kernel<DMAX, MODE, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(MODE == KV_RAGGED ? a.n_tiles : (a.Sq + kTcBQ - 1) / kTcBQ, B * a.H);
  prefill_tc_kernel<DMAX, MODE, S><<<grid, kTcWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int MODE, typename S = T, int MAXT = kMaxTAt128>
cudaError_t launch_cols(const PrefillArgs& a, int B, cudaStream_t stream) {
  const size_t smem = with_meta<MODE>(prefill_smem_bytes(a.D));
  cudaError_t err = cudaFuncSetAttribute(prefill_kernel<T, MODE, S, MAXT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(MODE == KV_RAGGED ? a.n_tiles : (a.Sq + kBQ - 1) / kBQ, B * a.H);
  prefill_kernel<T, MODE, S, MAXT><<<grid, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// The CUDA-core body: head dims above 128 take 8 output columns a lane; its
// f32 tiles then fill 214 KB of shared memory (the ragged mode's row
// metadata adds 1 KB: 210 KB in all, under the 227 KB a block may opt in
// to), so a block runs alone on its SM
template <typename T, int MODE, typename S = T>
cudaError_t launch(const PrefillArgs& a, int B, cudaStream_t stream) {
  if (a.D > 32 * kMaxTAt128) return launch_cols<T, MODE, S, 8>(a, B, stream);
  return launch_cols<T, MODE, S>(a, B, stream);
}

// head dims: multiples of 8 up to 256 (Gemma's) in every mode
inline bool prefill_args_ok(const PrefillArgs& a, int MODE) {
  return a.D % 8 == 0 && a.D <= 256 && a.H % a.KV == 0 &&
         (MODE != KV_RAGGED || (a.R >= 1 && (a.one_row || a.R <= kMaxRaggedRows)));
}

// The mma.sync body's instantiation for head dim D (a multiple of 16): DMAX
// 64, 128 or 256. At 256 its five 64-row bf16 tiles take 165 KB of shared
// memory and it reads Q's fragments from there (kQRegs).
template <int MODE, typename S = __nv_bfloat16>
cudaError_t launch_tc_d(const PrefillArgs& a, int B, cudaStream_t stream) {
  if (a.D <= 64) return launch_tc<64, MODE, S>(a, B, stream);
  if (a.D <= 128) return launch_tc<128, MODE, S>(a, B, stream);
  return launch_tc<256, MODE, S>(a, B, stream);
}

// K/V in q's dtype: f32 runs the CUDA-core body, bf16 the mma.sync body at
// head dims that are multiples of 16 and the CUDA-core body otherwise.
template <int MODE>
int run(int dtype, const PrefillArgs& a, int B, void* stream) {
  if (!prefill_args_ok(a, MODE)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.Sq == 0 || B == 0 || (MODE == KV_RAGGED && a.n_tiles == 0)) return (int)cudaSuccess;
  if (dtype == NXDI_F32) return (int)launch<float, MODE>(a, B, s);
  if (dtype == NXDI_BF16 && a.D % 16 == 0) return (int)launch_tc_d<MODE>(a, B, s);
  if (dtype == NXDI_BF16) return (int)launch<__nv_bfloat16, MODE>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

// A one-byte pool `kv_dtype` (the paged and ragged modes, instantiated by
// paged_prefill_1b.cu and ragged_paged_1b.cu alone) at a head dim that is a
// multiple of 16 up to 256: bf16 q runs the mma.sync body, f32 the
// CUDA-core body, each converting its K/V tiles as they land (at 256 the
// bf16 stages hold the converted tiles: no raw stage beside them).
template <int MODE>
int run_one_byte(int dtype, int kv_dtype, const PrefillArgs& a, int B, void* stream) {
  static_assert(MODE != KV_CONTIG, "a one-byte store is the paged pool's");
  if (!prefill_args_ok(a, MODE) || a.D % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.Sq == 0 || B == 0 || (MODE == KV_RAGGED && a.n_tiles == 0)) return (int)cudaSuccess;
  return with_one_byte_store(kv_dtype, [&](auto tag) -> int {
    using S = decltype(tag);
    if (dtype == NXDI_F32) return (int)launch<float, MODE, S>(a, B, s);
    if (dtype == NXDI_BF16) return (int)launch_tc_d<MODE, S>(a, B, s);
    return (int)cudaErrorInvalidValue;
  });
}

}  // namespace
