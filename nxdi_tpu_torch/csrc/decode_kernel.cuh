// The single-position decode kernels shared by three entry points, one per
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
//    With `lines` (continuous batching, and the K-step and loop bodies) row
//    b reads cache line lines[b], clipped into the cache's n_lines as the
//    JAX package's gather clips; a frozen row (its write dropped, its
//    position pinned) is an ordinary row whose output nobody reads.
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
//    v_scale multiplies the output. The pool may hold a one-byte store
//    (float8_e4m3fn, float8_e5m2 or int8: the JAX kernel reads the pool in
//    its store dtype and casts it to q's). With bf16 q the tensor-core body
//    streams raw one-byte tiles by cp.async into a ring and converts them
//    in shared memory (mma_tiles.cuh), so the output equals the bf16 pool's
//    on the pool up-cast to bf16, bit for bit, and a tile moves half the
//    bytes. With f32 q each warp loads its tile's K and V rows synchronously
//    and converts them to f32 as they land (store_converted), then runs the
//    CUDA-core body. Every one-byte value is exact in bf16 and f32, so the
//    only rounding is the store's own.
//
// Window/chunk masks apply to kFused and kWindow. Every mode clamps the
// softmax denominator at 1e-20, so a row with no visible key outputs 0.
//
// The ring mode (kFused and kWindow, `ring` = W > 0; 0 = affine positions):
// the cache is a W-slot ring (kvcache/kv_cache.py::WindowKVLayout) where
// position p lives in slot p % W, so slot j holds position
// q - ((q - j) mod W) for the row's query position q (the JAX package's
// WindowKVLayout.read). Slots past q hold negative positions while the ring
// has not filled and are never visible; once it has wrapped every slot is in
// (q - W, q]. kFused's stale slot q % W reports position q, which its strict
// mask excludes. The window's start cannot bound the range (the positions
// are not monotone in j), so a ring row scans [0, min(kv_len, q [+1])) and
// the window and chunk masks apply per position.
//
// Bound: bytes. Decode streams the attended K/V rows from device memory
// once (phase 3b's paged point: 8 rows at positions 0...2000, KV 8, D 64 in
// bf16, 16 MB: 4.8 us at 3.35 TB/s) and does 2 G D flops per K/V row.
//
// Design: flash decoding. The kv range [0, kv_len) is cut into C chunks of
// chunk_len positions, and decode_split_kernel runs one block per (chunk,
// kv head, row): it serves all G = H / KV q heads of the kv head, so each
// K/V row is read once. A group above GMAX (16: the m16 tile's rows; the
// multi-query families, Falcon-7B's 71 heads and StarCoder's 48 on one kv
// head) is cut into ceil(G / GMAX) head tiles of up to GMAX heads, one more
// factor of the grid's kv-head axis (KV x tiles): each block runs the same
// body over its tile's heads and reads its kv head's K/V rows again, which
// under multi-query (a one-head cache) L2 serves. (Keeping every tile in
// one block reads K/V once, but at G 48, D 128 it wants ~290 registers a
// thread: later work.) C comes from shapes only (kv_len, B, KV x tiles and
// the SM count: flash_attention.py::decode_chunk aims at two blocks per SM), so
// the launch never waits on q_pos or the table; a block whose chunk holds
// no visible position writes an empty state and exits. Inside a block each
// warp walks 32-position tiles of the chunk, its K and V rows streamed into
// shared memory by cp.async, double-buffered: the next tile's copies are in
// flight while this tile is computed. Rows are padded to an odd number of
// 16-byte units, so no access pattern below hits a bank twice. In bf16 at
// head dims that are multiples of 16 the tile runs on the tensor cores
// (mma.sync m16n8k16; the loop lives in mma_tiles.cuh, shared with the
// ragged split kernel): the G q heads are the rows of one 16-row tile, the
// tile's positions the columns; S = Q K^T from Q fragments held in
// registers for the whole block, the mask (one q_pos, so one ballot of
// visible columns) and the online softmax on the accumulators, and
// O += P V with P packed from the score registers (rounded to bf16 in the
// window and paged modes; in the fused mode split into a bf16 hi + lo pair,
// so P.V keeps f32 accuracy) and V^T by ldmatrix.trans. Elsewhere (f32,
// other head dims) it runs on the CUDA cores (lane = position for Q.K,
// lane = a column pair for P.V), whose per-position instructions, not the
// bytes, set the time at phase 3b's point (scripts/probe_decode.py cuts
// them out). The warps' (m, l, acc) are merged in shared memory (in warp
// order). With C = 1 the block writes the output itself (the earlier
// design: one block per (row, kv head)); with C > 1 it writes f32 partials
// to scratch the wrapper allocates, and decode_combine_kernel (a warp per
// (row, q head)) merges them in chunk order (no atomics: a second call
// gives the same bits), folds in the fresh row (kFused), applies v_scale
// and rounds to q's dtype.
// The paged mode looks each lane's slot up in the table (64-bit offsets);
// a block reads only its own head's strided rows (row stride KV * D), so
// any block size works. ragged_paged.cu's split and combine kernels are the
// same scheme over a packed token stream.
#pragma once

#include "mma_tiles.cuh"

// outside the unnamed namespace: paged_decode.cu passes it to the one-byte
// instantiations in paged_decode_1b.cu
struct DecodeArgs {
  const void* q;
  const void* kc;
  const void* vc;
  const void* kn;       // kFused only: this step's fresh rows
  const void* vn;
  void* out;
  float* ws;            // C > 1: (B, H, C, D) partial sums, then (B, H, C, 2) max and sum
  const int* q_pos;
  const int* kv_start;  // may be null: slot j is position j
  const int* lines;     // kFused, may be null: row b reads cache line lines[b] (clipped to n_lines)
  const int* bt;        // kPaged only: (B, nb) block table, -1 = hole
  int B, H, KV, D, kv_len, nb, bs, chunk_len, n_chunks, n_lines;
  long long qsb, qsh, csb, csh, css, nsb, nsh, osb, osh;
  float scale, v_scale;
  int window, chunk;
  int ring;             // kFused / kWindow: a W-slot ring cache (0: slot j is kv_start + j)
};

namespace {

enum class Mode { kFused, kWindow, kPaged };

constexpr int kDecTile = kMmaTile;  // kv positions per warp tile
constexpr int kDecStages = 2;  // a warp's K/V tiles in flight (a third measured no faster)
// A one-byte pool on the tensor-core body, at head dims up to 64 and up to
// 128: a warp's raw tiles in flight and its bf16 tiles (mma_tiles.cuh;
// scripts/stages_decode_1b.py times other splits)
constexpr int kDecRaw[2] = {1, 1};
constexpr int kDecCvt[2] = {1, 1};

// Warps per block: 4, or 2 or 1 where a warp's double-buffered K/V tiles
// are large (f32 at head dim 128, bf16 at 256; f32 at 256), to stay within
// shared memory.
template <typename T, int DMAX>
__host__ __device__ constexpr int dec_warps() {
  return sizeof(T) * DMAX > 512 ? 1 : sizeof(T) * DMAX > 256 ? 2 : 4;
}

// head tiles of up to gmax q heads a kv head's group of g takes
__host__ __device__ inline int dec_head_tiles(int g, int gmax) { return (g + gmax - 1) / gmax; }

// Shared memory of a block: Q as f32 [G][D] (16-byte rounded), then per
// warp its stages: kDecStages stages of K [32][pitch] and V [32][pitch] in
// T (pitch: tile_pitch, an odd number of 16-byte units, so a lane reading
// its own K row, the mma's fragment loads and ldmatrix hit no bank twice),
// or for a one-byte pool on the tensor cores the raw and bf16 tiles of
// mma_tiles.cuh. The warps' merge area (m, l [NW][G], acc [NW][G][D], the fresh
// scores [G]) reuses the stages once the tiles are done.
__host__ __device__ inline size_t dec_q_bytes(int G, int D) {
  return (sizeof(float) * (size_t)G * D + 15) & ~size_t(15);
}
__host__ __device__ inline size_t dec_stage_elems(int D, int es) {
  return (size_t)kDecTile * 2 * tile_pitch(D, es);
}
template <typename T, typename S, int DMAX, bool MMA>
__host__ __device__ inline size_t dec_warp_bytes(int D) {
  if constexpr (MMA && kOneByte<S>) {
    return mma_ring_bytes<S, kDecRaw[DMAX > 64], kDecCvt[DMAX > 64]>(D);
  } else {
    return (size_t)kDecStages * dec_stage_elems(D, sizeof(T)) * sizeof(T);
  }
}
template <typename T, typename S, int DMAX, bool MMA>
inline size_t dec_smem_bytes(int NW, int G, int D) {
  const size_t stages = (size_t)NW * dec_warp_bytes<T, S, DMAX, MMA>(D);
  const size_t merge = sizeof(float) * (size_t)(2 * NW * G + NW * G * D + G);
  return dec_q_bytes(G, D) + (stages > merge ? stages : merge);
}

// The slots [lo, hi) row b's query sees: up to q_pos (exclusive when the
// fresh row replaces the slot at q_pos), inside kv_len, from the window's
// start and from the start of q_pos's chunk, so a block whose slots all lie
// before either exits at once (flash_attention.py::decode_visible_range
// mirrors it). A ring row (ring > 0, kv_start null) takes the same hi and
// lo = 0.
template <Mode MODE>
__device__ __forceinline__ void dec_visible(const DecodeArgs& a, int qp, int ks, int& lo,
                                            int& hi) {
  hi = max(0, min(a.kv_len, qp - ks + (MODE == Mode::kFused ? 0 : 1)));
  lo = a.window > 0 && a.ring == 0 ? max(0, min(hi, qp - a.window + 1 - ks)) : 0;
  if (a.chunk > 0 && a.ring == 0) lo = max(lo, min(hi, floordiv(qp, a.chunk) * a.chunk - ks));
}

// The position slot j holds: kv_start + j, or on a ring q - ((q - j) mod W)
__device__ __forceinline__ int dec_pos(const DecodeArgs& a, int qp, int ks, int j) {
  if (a.ring > 0) {
    int d = (qp - j) % a.ring;
    if (d < 0) d += a.ring;
    return qp - d;
  }
  return ks + j;
}

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  __device__ static float2 load(const float* p) { return *reinterpret_cast<const float2*>(p); }
};
template <>
struct Pair<__nv_bfloat16> {
  __device__ static float2 load(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};

// a 16-byte piece of a K row, unpacked to f32
__device__ __forceinline__ void dec_unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void dec_unpack(const uint4& u, float* f, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// MMA: the bf16 body at head dims that are multiples of 16 (the tensor
// cores, G q heads as the rows of one m16 tile: mma_tiles.cuh); otherwise
// the CUDA cores. S: the cache's store type (T, or a one-byte store in the
// paged mode: raw tiles by cp.async on the tensor cores; with f32 q, tiles
// loaded synchronously and converted as they land in shared memory).
template <typename T, typename S, int GMAX, int DMAX, Mode MODE, bool MMA>
__global__ void __launch_bounds__(dec_warps<T, DMAX>() * 32) decode_split_kernel(DecodeArgs a) {
  constexpr int NW = dec_warps<T, DMAX>();
  constexpr bool kFresh = MODE == Mode::kFused;   // fold in the fresh row, strict mask
  constexpr bool kRoundP = MODE != Mode::kFused;  // P rounded to T before P.V
  constexpr bool kPaged = MODE == Mode::kPaged;
  constexpr int ES = sizeof(T), EPC = 16 / ES;   // elements per 16-byte piece

  extern __shared__ __align__(16) float smem[];
  const int D = a.D, C = a.n_chunks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, b = blockIdx.z;
  // the block's head tile: kv head kvh's q heads h0 ... h0 + G - 1 (the
  // whole group when it fits in GMAX rows)
  const int group = a.H / a.KV, n_tiles = dec_head_tiles(group, GMAX);
  const int kvh = blockIdx.y / n_tiles, tile = blockIdx.y % n_tiles;
  const int h0 = kvh * group + tile * GMAX, G = min(GMAX, group - tile * GMAX);
  const int qp = a.q_pos[b];
  const int ks = a.kv_start ? a.kv_start[b] : 0;
  const bool direct = C == 1;

  // this block's positions: the row's visible range inside the chunk
  int lo, hi;
  dec_visible<MODE>(a, qp, ks, lo, hi);
  lo = max(lo, c * a.chunk_len);
  hi = min(hi, (int)min((long long)a.kv_len, (long long)(c + 1) * a.chunk_len));
  const long long part = ((long long)b * a.H + h0) * C + c;  // (b, head h0, c)
  if (hi <= lo && !direct) {  // nothing visible here: an empty state
    for (int i = tid; i < G * D; i += blockDim.x) {
      const int g = i / D, d = i % D;
      a.ws[(part + (long long)g * C) * D + d] = 0.f;
      if (d == 0) {
        float* ml = a.ws + (long long)a.B * a.H * C * D + 2 * (part + (long long)g * C);
        ml[0] = NXDI_NEG_INF;
        ml[1] = 0.f;
      }
    }
    return;
  }

  float* sQ = smem;  // [G][D]
  char* stage_base = reinterpret_cast<char*>(smem) + dec_q_bytes(G, D);

  const long long line = a.lines ? min(max(a.lines[b], 0), a.n_lines - 1) : b;
  const S* kc = static_cast<const S*>(a.kc) + line * a.csb + kvh * a.csh;
  const S* vc = static_cast<const S*>(a.vc) + line * a.csb + kvh * a.csh;
  const int* btr = kPaged ? a.bt + (long long)b * a.nb : nullptr;

  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    sQ[i] = to_f32(static_cast<const T*>(a.q)[b * a.qsb + (h0 + g) * a.qsh + d]);
  }

  // the slot of position j (< hi), or -1 for a hole
  auto slot_of = [&](int j) -> long long {
    if constexpr (kPaged) {
      const int blk = btr[j / a.bs];
      return blk < 0 ? -1 : (long long)blk * a.bs + j % a.bs;
    } else {
      return j;
    }
  };
  char* my_ring = stage_base + (size_t)warp * dec_warp_bytes<T, S, DMAX, MMA>(D);

  // the warp's state goes to the merge area (over the stages) after the tiles
  float* sM = reinterpret_cast<float*>(stage_base);  // [NW][G]
  float* sL = sM + NW * G;                           // [NW][G]
  float* sAcc = sL + NW * G;                         // [NW][G][D]
  float* sS2 = sAcc + NW * G * D;                    // [G] fresh-row scores

  if constexpr (MMA) {
    // the tensor-core tile loop (mma_tiles.cuh): the ring's first tiles in
    // flight, then each lane's Q fragments from sQ
    constexpr int kStages = kOneByte<S> ? kDecRaw[DMAX > 64] : kDecStages;
    MmaTiles<S, DMAX, NW, kStages, kDecCvt[DMAX > 64]> tiles(my_ring, kc, vc, a.css, D, lo, hi);
    tiles.start(slot_of);
    __syncthreads();  // sQ
    uint32_t qf[DMAX / 16][4];
    mma_q_frags<DMAX>(qf, D, [&](int r, int col) -> uint32_t {
      return r < G ? pack_bf16(sQ[r * D + col], sQ[r * D + col + 1]) : 0u;
    });
    MmaState<DMAX> st;
    tiles.template run<kRoundP>(st, qf, a.scale, slot_of, [&](int j) {
      return pos_visible(dec_pos(a, qp, ks, j), qp, kFresh, a.window, a.chunk);
    });
    __syncthreads();  // every warp is done with its stages
    mma_state_store<DMAX>(st, sM, sL, sAcc, G, D);
  } else {
    const int kp = tile_pitch(D, ES);
    const size_t stage = dec_stage_elems(D, ES);
    T* my_stages = reinterpret_cast<T*>(my_ring);
    const int cpr = D * ES / 16;  // 16-byte pieces per row
    // stage this warp's tile t (positions lo + 32 t ...) into stage s: K and V
    // rows asynchronously, each row's slot from the lane that looked it up;
    // holes and rows past the range zero-filled (the loop is warp-uniform for
    // the shuffles)
    auto issue = [&](int t, int s) {
      const int j = lo + t * kDecTile + lane;
      const long long slot = j < hi ? slot_of(j) : -1;
      T* sK = my_stages + s * stage;
      T* sV = sK + kDecTile * kp;
      if constexpr (kOneByte<S>) {
        // one-byte store (f32 q): 16 elements a load, converted to T into the stage
        const int spr = D / 16;  // 16-element pieces per row
        for (int base = 0; base < kDecTile * spr; base += 32) {
          const int i = base + lane;
          const int r = i / spr, pc = i % spr;
          const long long rslot = __shfl_sync(0xffffffffu, slot, r);
          uint4 ku = make_uint4(0u, 0u, 0u, 0u), vu = ku;
          if (rslot >= 0) {
            ku = *reinterpret_cast<const uint4*>(kc + rslot * a.css + pc * 16);
            vu = *reinterpret_cast<const uint4*>(vc + rslot * a.css + pc * 16);
          }
          store_converted<T, S, 16>(sK + r * kp + pc * 16, ku);
          store_converted<T, S, 16>(sV + r * kp + pc * 16, vu);
        }
      } else {
        for (int base = 0; base < kDecTile * cpr; base += 32) {
          const int i = base + lane;
          const int r = i / cpr, pc = i % cpr;
          const long long rslot = __shfl_sync(0xffffffffu, slot, r);
          const long long src = (rslot < 0 ? 0 : rslot) * a.css + pc * EPC;
          const int zfill = rslot < 0 ? 16 : 0;
          __pipeline_memcpy_async(sK + r * kp + pc * EPC, kc + src, 16, zfill);
          __pipeline_memcpy_async(sV + r * kp + pc * EPC, vc + src, 16, zfill);
        }
      }
      __pipeline_commit();  // (one-byte: an empty group; the waits count the same)
    };
    // whether this lane's position of tile t is attended
    auto lane_visible = [&](int t) {
      const int j = lo + t * kDecTile + lane;
      return j < hi && slot_of(j) >= 0 &&
             pos_visible(dec_pos(a, qp, ks, j), qp, kFresh, a.window, a.chunk);
    };

    const int n_tiles = hi > lo ? (hi - lo + kDecTile - 1) / kDecTile : 0;
    const int n_mine = n_tiles > warp ? (n_tiles - warp + NW - 1) / NW : 0;
    // the first kDecStages - 1 tiles in flight (a group each, empty past the
    // warp's last tile, so every wait below counts the same groups)
    for (int k = 0; k < kDecStages - 1; ++k) {
      if (k < n_mine) {
        issue(warp + k * NW, k);
      } else {
        __pipeline_commit();
      }
    }
    __syncthreads();  // sQ
    // put tile i + kDecStages - 1 in flight and wait for tile i's copies
    auto next = [&](int i) {
      const int k = i + kDecStages - 1;
      if (k < n_mine) {
        issue(warp + k * NW, k % kDecStages);
      } else {
        __pipeline_commit();
      }
      __pipeline_wait_prior(kDecStages - 1);
      __syncwarp();
    };

    // CUDA cores: lane = position for Q.K, lane = a column pair for P.V
    constexpr int kT = DMAX / 64;  // column pairs per lane
    float m[GMAX], l[GMAX], acc[GMAX][kT][2], s[GMAX], p[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      m[g] = NXDI_NEG_INF;
      l[g] = 0.f;
      p[g] = 0.f;
#pragma unroll
      for (int t = 0; t < kT; ++t) acc[g][t][0] = acc[g][t][1] = 0.f;
    }
    for (int i = 0; i < n_mine; ++i) {
      const int t = warp + i * NW;
      next(i);
      const T* sK = my_stages + (i % kDecStages) * stage;
      const T* sV = sK + kDecTile * kp;
      const int n_here = min(kDecTile, hi - (lo + t * kDecTile));
      const bool valid = lane_visible(t);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
      {  // this lane's K row from shared memory against every q head
        constexpr int KC = DMAX / EPC;
        const uint4* krow = reinterpret_cast<const uint4*>(sK + lane * kp);
#pragma unroll
        for (int pc = 0; pc < KC; ++pc) {
          if (pc < cpr) {
            float kf[EPC];
            dec_unpack(krow[pc], kf, T());
#pragma unroll
            for (int g = 0; g < GMAX; ++g) {
              if (g < G) {
#pragma unroll
                for (int e = 0; e < EPC; e += 4) {
                  const float4 q4 = *reinterpret_cast<const float4*>(&sQ[g * D + pc * EPC + e]);
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
          for (int u = 0; u < kT; ++u) {
            acc[g][u][0] *= corr;
            acc[g][u][1] *= corr;
          }
        }
      }
      // P.V: lane owns columns 2 lane + 64 u and the one after
      for (int jj = 0; jj < n_here; ++jj) {
        float pj[GMAX];
#pragma unroll
        for (int g = 0; g < GMAX; ++g) pj[g] = __shfl_sync(0xffffffffu, p[g], jj);
#pragma unroll
        for (int u = 0; u < kT; ++u) {
          const int d = 2 * lane + 64 * u;
          if (d < D) {
            const float2 vv = Pair<T>::load(sV + jj * kp + d);
#pragma unroll
            for (int g = 0; g < GMAX; ++g) {
              if (g < G) {
                acc[g][u][0] = fmaf(pj[g], vv.x, acc[g][u][0]);
                acc[g][u][1] = fmaf(pj[g], vv.y, acc[g][u][1]);
              }
            }
          }
        }
      }
      __syncwarp();  // the next tile's copies overwrite this stage
    }
    __syncthreads();  // every warp is done with its stages
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        if (lane == 0) {
          sM[warp * G + g] = m[g];
          sL[warp * G + g] = l[g];
        }
#pragma unroll
        for (int u = 0; u < kT; ++u) {
          const int d = 2 * lane + 64 * u;
          if (d < D) {
            sAcc[(warp * G + g) * D + d] = acc[g][u][0];
            sAcc[(warp * G + g) * D + d + 1] = acc[g][u][1];
          }
        }
      }
    }
  }

  // merge the warps (in warp order)
  const T* vn = nullptr;
  if constexpr (kFresh) {
    if (direct) {  // the fresh row's scores (it sits at q_pos: every mask admits it)
      const T* kn = static_cast<const T*>(a.kn) + b * a.nsb + kvh * a.nsh;
      vn = static_cast<const T*>(a.vn) + b * a.nsb + kvh * a.nsh;
      for (int g = warp; g < G; g += NW) {
        float dot = 0.f;
        for (int d = lane; d < D; d += 32) dot = fmaf(sQ[g * D + d], to_f32(kn[d]), dot);
        dot = warp_sum(dot);
        if (lane == 0) sS2[g] = dot * a.scale;
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    float M = NXDI_NEG_INF;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sM[w * G + g]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float f = expf(sM[w * G + g] - M);
      L = fmaf(sL[w * G + g], f, L);
      A = fmaf(sAcc[(w * G + g) * D + d], f, A);
    }
    if (direct) {
      if constexpr (kFresh) {
        const float s2 = sS2[g];
        const float m_new = fmaxf(M, s2);
        const float corr = expf(M - m_new);
        const float p2 = expf(s2 - m_new);
        L = L * corr + p2;
        A = A * corr + p2 * to_f32(vn[d]);
      }
      L = fmaxf(L, 1e-20f);
      static_cast<T*>(a.out)[b * a.osb + (h0 + g) * a.osh + d] =
          from_f32<T>(A * a.v_scale / L);
    } else {
      const long long sl = part + (long long)g * C;
      a.ws[sl * D + d] = A;
      if (d == 0) {
        float* ml = a.ws + (long long)a.B * a.H * C * D + 2 * sl;
        ml[0] = M;
        ml[1] = L;
      }
    }
  }
}

// One warp per (row, q head), 8 to a block. Lane k % 32 holds chunk k's
// max and sum and forms its weight exp(m_k - M); the denominator and each
// column's partial sums are then merged in chunk order with the weights
// broadcast from their lanes; the fresh row is folded in (kFused), v_scale
// applied, and the output rounded to q's dtype.
// U: columns a lane (D <= 32 U)
template <typename T, Mode MODE, int U>
__global__ void __launch_bounds__(256) decode_combine_kernel(DecodeArgs a) {
  const int idx = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (idx >= a.B * a.H) return;
  const int b = idx / a.H, h = idx % a.H, C = a.n_chunks, D = a.D;
  const int kvh = h / (a.H / a.KV);
  const float* acc = a.ws + (long long)idx * C * D;
  const float* ml = a.ws + (long long)a.B * a.H * C * D + 2LL * idx * C;
  float s2 = 0.f, vf[U] = {};  // kFused: the fresh row's score and V
  if constexpr (MODE == Mode::kFused) {  // loaded first, beside the partials
    const T* q = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
    const T* kn = static_cast<const T*>(a.kn) + b * a.nsb + kvh * a.nsh;
    const T* vn = static_cast<const T*>(a.vn) + b * a.nsb + kvh * a.nsh;
    float dot = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int d = lane + 32 * u;
      if (d < D) {
        dot = fmaf(to_f32(q[d]), to_f32(kn[d]), dot);
        vf[u] = to_f32(vn[d]);
      }
    }
    s2 = warp_sum(dot) * a.scale;
  }
  float M = NXDI_NEG_INF;
  for (int k = lane; k < C; k += 32) M = fmaxf(M, ml[2 * k]);
  M = warp_max(M);
  float L = 0.f, A[U] = {};  // columns lane + 32 u
  float w = 0.f, lk = 0.f;
  for (int k = 0; k < C; ++k) {
    if ((k & 31) == 0) {  // the next 32 chunks' weights, one per lane
      const int kl = k + lane;
      w = kl < C ? expf(ml[2 * kl] - M) : 0.f;
      lk = kl < C ? ml[2 * kl + 1] : 0.f;
    }
    const float wk = __shfl_sync(0xffffffffu, w, k & 31);
    L = fmaf(__shfl_sync(0xffffffffu, lk, k & 31), wk, L);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int d = lane + 32 * u;
      if (d < D) A[u] = fmaf(acc[(long long)k * D + d], wk, A[u]);
    }
  }
  float corr = 1.f, p2 = 0.f;
  if constexpr (MODE == Mode::kFused) {
    const float m_new = fmaxf(M, s2);
    corr = expf(M - m_new);
    p2 = expf(s2 - m_new);
    L = L * corr + p2;
  }
  const float inv = a.v_scale / fmaxf(L, 1e-20f);
  T* out = static_cast<T*>(a.out) + b * a.osb + h * a.osh;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int d = lane + 32 * u;
    if (d < D) {
      float x = A[u];
      if constexpr (MODE == Mode::kFused) x = x * corr + p2 * vf[u];
      out[d] = from_f32<T>(x * inv);
    }
  }
}

template <typename T, int GMAX, int DMAX, Mode MODE, bool MMA, typename S = T>
cudaError_t launch(const DecodeArgs& a, cudaStream_t stream) {
  constexpr int NW = dec_warps<T, DMAX>();
  // opted in once per instantiation to the most any G <= GMAX, D <= DMAX needs
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_split_kernel<T, S, GMAX, DMAX, MODE, MMA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dec_smem_bytes<T, S, DMAX, MMA>(NW, GMAX, DMAX));
  if (attr != cudaSuccess) return attr;
  const int group = a.H / a.KV, tiles = dec_head_tiles(group, GMAX);
  const size_t smem = dec_smem_bytes<T, S, DMAX, MMA>(NW, group < GMAX ? group : GMAX, a.D);
  decode_split_kernel<T, S, GMAX, DMAX, MODE, MMA>
      <<<dim3(a.n_chunks, a.KV * tiles, a.B), NW * 32, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_chunks == 1) return err;
  decode_combine_kernel<T, MODE, (DMAX > 128 ? 8 : 4)><<<(a.B * a.H + 7) / 8, 256, 0, stream>>>(a);
  return cudaGetLastError();
}

// GMAX: the q heads of a block. The tensor cores take one m16 tile of
// them; the CUDA cores the least of 4, 8 and 16 that holds the group. A
// group above 16 runs in head tiles of 16 on either body.
template <typename T, int DMAX, Mode MODE, bool MMA>
cudaError_t dispatch_g(const DecodeArgs& a, cudaStream_t stream) {
  const int G = a.H / a.KV;
  if constexpr (MMA) return launch<T, 16, DMAX, MODE, true>(a, stream);
  if (G <= 4) return launch<T, 4, DMAX, MODE, false>(a, stream);
  if (G <= 8) return launch<T, 8, DMAX, MODE, false>(a, stream);
  return launch<T, 16, DMAX, MODE, false>(a, stream);
}

inline bool decode_args_ok(const DecodeArgs& a) {
  return a.D % 8 == 0 && a.D <= 256 && a.KV > 0 && a.H % a.KV == 0 && a.chunk_len > 0 &&
         a.n_chunks >= 1 && (long long)a.n_chunks * a.chunk_len >= a.kv_len &&
         (a.n_chunks == 1 || a.ws);
}

// The instantiation for head dim D: DMAX 64, 128 or 256 (Gemma's)
template <typename T, Mode MODE, bool MMA>
cudaError_t dispatch_d(const DecodeArgs& a, cudaStream_t s) {
  if (a.D <= 64) return dispatch_g<T, 64, MODE, MMA>(a, s);
  if (a.D <= 128) return dispatch_g<T, 128, MODE, MMA>(a, s);
  return dispatch_g<T, 256, MODE, MMA>(a, s);
}

// Checks the arguments and launches: the split kernel over C = n_chunks
// chunks of chunk_len positions (C * chunk_len >= kv_len), then, with
// C > 1, the combine over the scratch `ws`. bf16 at head dims that are
// multiples of 16 runs the tensor-core body, the rest the CUDA-core body.
// The cache holds q's dtype. At head dim 256 a block has 2 warps in bf16
// and 1 in f32 (dec_warps), and the tensor-core body's output tile takes
// 128 registers a lane.
template <Mode MODE>
int dispatch(int dtype, const DecodeArgs& a, void* stream) {
  if (!decode_args_ok(a)) return (int)cudaErrorInvalidValue;
  if (a.B == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == NXDI_F32) return (int)dispatch_d<float, MODE, false>(a, s);
  if (dtype == NXDI_BF16 && a.D % 16 == 0) return (int)dispatch_d<__nv_bfloat16, MODE, true>(a, s);
  if (dtype == NXDI_BF16) return (int)dispatch_d<__nv_bfloat16, MODE, false>(a, s);
  return (int)cudaErrorInvalidValue;
}

// The paged mode over a one-byte store `kv_dtype` (instantiated by
// paged_decode_1b.cu alone) at a head dim that is a multiple of 16 up to
// 256: tiles are converted as they land (bf16 q: the tensor-core body;
// f32: the CUDA cores, 16 q heads a block: a larger group in head tiles).
// At 256 (Gemma's) a block has 2 warps with bf16 q (each a raw ring of
// 17 KB and a bf16 tile of 33 KB) and 1 with f32 (dec_warps), as over a
// bf16 pool.
template <typename T, bool MMA, typename S>
cudaError_t launch_one_byte_d(const DecodeArgs& a, cudaStream_t s) {
  if (a.D <= 64) return launch<T, 16, 64, Mode::kPaged, MMA, S>(a, s);
  if (a.D <= 128) return launch<T, 16, 128, Mode::kPaged, MMA, S>(a, s);
  return launch<T, 16, 256, Mode::kPaged, MMA, S>(a, s);
}

template <Mode MODE>
int dispatch_one_byte(int dtype, int kv_dtype, const DecodeArgs& a, void* stream) {
  static_assert(MODE == Mode::kPaged, "a one-byte store is the paged pool's");
  if (!decode_args_ok(a) || a.D % 16 != 0) return (int)cudaErrorInvalidValue;
  if (a.B == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_one_byte_store(kv_dtype, [&](auto tag) -> int {
    using S = decltype(tag);
    if (dtype == NXDI_F32) return (int)launch_one_byte_d<float, false, S>(a, s);
    if (dtype == NXDI_BF16) return (int)launch_one_byte_d<__nv_bfloat16, true, S>(a, s);
    return (int)cudaErrorInvalidValue;
  });
}

}  // namespace
