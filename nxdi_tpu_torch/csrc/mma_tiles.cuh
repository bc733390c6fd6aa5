// The tensor-core tile loop shared by the split decode kernel
// (decode_kernel.cuh, bf16 q at head dims that are multiples of 16) and the
// ragged split kernel (ragged_split.cuh, the same): one query position's
// G <= 16 q heads (a head tile of a larger group) against the kv positions
// [lo, hi) of one block, walked in
// 32-position tiles, warp w of NW taking tiles w, w + NW, ... The caller
// maps a position to its slot (-1: a hole) and says whether the position is
// attended; the loop keeps the warp's online softmax state (m, l, O) in
// registers, and the caller merges the warps.
//
// The body (PR 6's, moved here unchanged): mma.sync m16n8k16 with the G q
// heads as the rows of one 16-row tile (rows >= G zero) and a tile's 32
// positions as four n8 column tiles; S = Q K^T from Q fragments the caller
// holds in registers, the mask (one query position, so one ballot of
// visible columns) and the online softmax on the accumulators, then
// O += P V with P packed from the score registers (rounded to bf16, or in
// the fused decode mode split into a bf16 hi + lo pair so P.V keeps f32
// accuracy) and V^T by ldmatrix.trans.
//
// Staging, by the pool's store S:
//  - bf16 (q's type): a ring of STAGES tiles of K and V rows streamed into
//    shared memory by cp.async, STAGES - 1 tiles ahead of the one computed.
//  - one byte (float8_e4m3fn, float8_e5m2, int8): a ring of STAGES raw
//    tiles (K and V rows as stored, D bytes a row) streamed by cp.async.
//    Once tile i has landed, each lane converts one K row and one V row of
//    it into a bf16 tile (one of CVT), 16 stored bytes a step, unrolled, and
//    the raw slot takes tile i + STAGES at once, so its copies are in
//    flight while tile i is computed from the bf16 tile by the body above,
//    unchanged. Conversions are exact (fp8 by cvt.rn.f16x2.e4m3x2 /
//    .e5m2x2, int8 through f32; every store value is a bf16), so the
//    products see the values of the pool up-cast to bf16, and the output
//    equals the bf16 body's on that pool bit for bit. (Converting V alone
//    and K's mma fragments from the raw bytes as they are read put the
//    conversions on the mma's dependency chain, and measured slower.) The
//    kernels take STAGES = CVT = 1: deeper rings cost blocks per SM, and
//    the decode is bound by latency at low occupancy, not by the bytes in
//    flight (scripts/stages_decode_1b.py).
// A hole, or a row past hi, is zero-filled through the copy's source size
// (its V must not carry stale bits: P = 0 times NaN is NaN). Rows are padded
// to an odd number of 16-byte units, so the fragment loads, ldmatrix and
// the conversion's 16-byte accesses hit no bank twice.
#pragma once

#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int kMmaTile = 32;  // kv positions per warp tile

// a staged row's pitch in elements of es bytes: an odd number of 16-byte units
__host__ __device__ inline int tile_pitch(int D, int es) {
  return ((D * es / 16) | 1) * 16 / es;
}

// Shared memory of one warp's ring: bf16 store, STAGES tiles of K and V
// rows; one-byte store, STAGES raw tiles of K and V rows, then CVT bf16
// tiles of K and V rows.
template <typename S, int STAGES, int CVT>
__host__ __device__ inline size_t mma_ring_bytes(int D) {
  if constexpr (kOneByte<S>) {
    return (size_t)STAGES * 2 * kMmaTile * tile_pitch(D, 1) +
           (size_t)CVT * 2 * kMmaTile * tile_pitch(D, 2) * 2;
  } else {
    return (size_t)STAGES * 2 * kMmaTile * tile_pitch(D, sizeof(S)) * sizeof(S);
  }
}

// A warp's state: rows grp and grp + 8 of the m16 tile (lane = 4 grp + tig),
// O's columns 8 u + 2 tig and the next
template <int DMAX>
struct MmaState {
  float o[DMAX / 8][4];
  float m[2], l[2];
};

// Q's A fragments for every k16 step: qpair(r, col) packs q head r's
// columns col and col + 1 as a bf16x2 word (0 for r >= G)
template <int DMAX, typename QPair>
__device__ __forceinline__ void mma_q_frags(uint32_t (&qf)[DMAX / 16][4], int D, QPair qpair) {
  const int lane = threadIdx.x & 31, grp = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    if (kk * 16 < D) {
      qf[kk][0] = qpair(grp, kk * 16 + 2 * tig);
      qf[kk][1] = qpair(grp + 8, kk * 16 + 2 * tig);
      qf[kk][2] = qpair(grp, kk * 16 + 8 + 2 * tig);
      qf[kk][3] = qpair(grp + 8, kk * 16 + 8 + 2 * tig);
    }
  }
}

// The hi and lo bf16 halves of two f32 values (x = hi + lo to 16
// mantissa bits): the fused mode's P, kept f32-accurate through bf16 mma.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// One warp's tiles of [lo, hi): S = Q K^T, mask, online softmax, O += P V.
// `ring`: this warp's mma_ring_bytes<S, STAGES, CVT>(D) of shared memory
// (16-byte aligned). kc / vc: the head's rows, slot s at s * css elements.
// slot_of(j): position j's slot, -1 for a hole; visible(j): whether
// position j (< hi, not a hole) is attended. start() puts the ring's first
// tiles in flight (before the caller waits for Q); run() walks the tiles.
// Every lane of the warp calls both (the loop is warp-uniform for the
// shuffles).
template <typename S, int DMAX, int NW, int STAGES, int CVT>
struct MmaTiles {
  using T = __nv_bfloat16;
  static constexpr bool k1B = kOneByte<S>;
  static_assert(k1B || std::is_same<S, T>::value, "a bf16 or a one-byte store");
  static_assert(STAGES >= 1 && (k1B ? CVT >= 1 : STAGES >= 2), "a ring of tiles");
  // tiles issued before the first wait: one-byte, STAGES (a raw slot is
  // refilled once its tile is converted); bf16, STAGES - 1 (a slot is
  // refilled when the next tile starts)
  static constexpr int kAhead = k1B ? STAGES : STAGES - 1;

  S* ring;
  const S* kc;
  const S* vc;
  long long css;
  int D, lo, hi, n_mine, rp, cpr;
  int rps, lr, lp;   // one-byte copies when cpr divides 32: rows a step, lane's row and piece
  size_t ring_tile;  // K + V rows of one ring tile (elements)

  __device__ __forceinline__ MmaTiles(char* ring_, const S* kc_, const S* vc_, long long css_,
                                      int D_, int lo_, int hi_)
      : ring(reinterpret_cast<S*>(ring_)), kc(kc_), vc(vc_), css(css_), D(D_), lo(lo_), hi(hi_) {
    const int warp = threadIdx.x >> 5;
    const int n_tiles = hi > lo ? (hi - lo + kMmaTile - 1) / kMmaTile : 0;
    n_mine = n_tiles > warp ? (n_tiles - warp + NW - 1) / NW : 0;
    rp = tile_pitch(D, sizeof(S));
    cpr = D * (int)sizeof(S) / 16;
    ring_tile = (size_t)2 * kMmaTile * rp;
    const int lane = threadIdx.x & 31;
    rps = 32 % cpr == 0 ? 32 / cpr : 0;
    lr = lane / cpr;
    lp = lane % cpr;
  }

  // my tile i's K and V rows into ring slot s, a row's slot from the lane
  // that looked it up; holes and rows past hi zero-filled
  template <typename SlotOf>
  __device__ __forceinline__ void issue(int i, int s, SlotOf& slot_of) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int j = lo + (warp + i * NW) * kMmaTile + lane;
    const long long slot = j < hi ? slot_of(j) : -1;
    S* sK = ring + s * ring_tile;
    S* sV = sK + kMmaTile * rp;
    constexpr int EPC = 16 / sizeof(S);
    auto copy = [&](int r, int pc) {
      const long long rslot = __shfl_sync(0xffffffffu, slot, r);
      const long long src = (rslot < 0 ? 0 : rslot) * css + pc * EPC;
      const int zfill = rslot < 0 ? 16 : 0;
      __pipeline_memcpy_async(sK + r * rp + pc * EPC, kc + src, 16, zfill);
      __pipeline_memcpy_async(sV + r * rp + pc * EPC, vc + src, 16, zfill);
    };
    if (k1B && rps > 0) {  // (D / 16 pieces a row divide 32: no division a step)
#pragma unroll
      for (int k = 0; k < DMAX / 16; ++k) {
        if (k < cpr) copy(k * rps + lr, lp);
      }
    } else {
      for (int base = 0; base < kMmaTile * cpr; base += 32) {
        const int idx = base + lane;
        copy(idx / cpr, idx % cpr);
      }
    }
    __pipeline_commit();
  }

  // a raw tile's 32 rows into a bf16 tile: lane = row, 16 stored bytes a step
  __device__ __forceinline__ void convert_rows(const S* raw, T* dst, int kp) const {
    const int lane = threadIdx.x & 31;
    const uint4* src = reinterpret_cast<const uint4*>(raw + lane * rp);
    uint4* out = reinterpret_cast<uint4*>(dst + lane * kp);
#pragma unroll
    for (int pc = 0; pc < DMAX / 16; ++pc) {
      if (pc < cpr) {
        uint4 lo16, hi16;
        one_byte_16_bf16<S>(src[pc], lo16, hi16);
        out[2 * pc] = lo16;
        out[2 * pc + 1] = hi16;
      }
    }
  }

  // the ring's first tiles in flight (a group each, empty past my last, so
  // every wait below counts the same groups)
  template <typename SlotOf>
  __device__ __forceinline__ void start(SlotOf slot_of) {
    for (int k = 0; k < kAhead; ++k) {
      if (k < n_mine) {
        issue(k, k, slot_of);
      } else {
        __pipeline_commit();
      }
    }
  }

  // kRoundP: P rounded to bf16 before P.V (else the hi + lo pair); `st` is
  // initialised here
  template <bool kRoundP, typename SlotOf, typename Visible>
  __device__ __forceinline__ void run(MmaState<DMAX>& st, const uint32_t (&qf)[DMAX / 16][4],
                                      float scale, SlotOf slot_of, Visible visible) {
    constexpr int KS = DMAX / 16, NT = DMAX / 8;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int grp = lane >> 2, tig = lane & 3;
    const int kp = tile_pitch(D, 2);  // a bf16 row's pitch (elements)
    T* cvt = reinterpret_cast<T*>(ring + (k1B ? STAGES * ring_tile : 0));
    const int cvt_tile = 2 * kMmaTile * kp;  // one bf16 tile of K and V rows (elements)

#pragma unroll
    for (int t = 0; t < NT; ++t) st.o[t][0] = st.o[t][1] = st.o[t][2] = st.o[t][3] = 0.f;
    st.m[0] = st.m[1] = NXDI_NEG_INF;
    st.l[0] = st.l[1] = 0.f;

    for (int i = 0; i < n_mine; ++i) {
      const int j0 = lo + (warp + i * NW) * kMmaTile;
      const T* sK;  // this tile's K and V rows in bf16 (pitch kp)
      const T* sV;
      if constexpr (k1B) {
        __pipeline_wait_prior(STAGES - 1);  // tile i's copies
        __syncwarp();
        const S* raw = ring + (i % STAGES) * ring_tile;
        T* cK = cvt + (i % CVT) * cvt_tile;
        convert_rows(raw, cK, kp);
        convert_rows(raw + kMmaTile * rp, cK + kMmaTile * kp, kp);
        __syncwarp();
        // the raw slot is read: it takes tile i + STAGES, in flight while
        // tile i is computed
        if (i + STAGES < n_mine) {
          issue(i + STAGES, i % STAGES, slot_of);
        } else {
          __pipeline_commit();
        }
        sK = cK;
        sV = cK + kMmaTile * kp;
      } else {
        const int k = i + STAGES - 1;  // tile k in flight, then wait for tile i
        if (k < n_mine) {
          issue(k, k % STAGES, slot_of);
        } else {
          __pipeline_commit();
        }
        __pipeline_wait_prior(STAGES - 1);
        __syncwarp();
        sK = ring + (i % STAGES) * ring_tile;
        sV = sK + kMmaTile * rp;
      }
      const int j = j0 + lane;
      const unsigned vis = __ballot_sync(0xffffffffu, j < hi && slot_of(j) >= 0 && visible(j));
      float sc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
        const T* krow = sK + (nt * 8 + grp) * kp + 2 * tig;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          if (kk * 16 < D) {
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
            mma_bf16(sc[nt], qf[kk], b0, b1);
          }
        }
      }
      // mask + online softmax per row (the mask is the columns': one q_pos)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float mx = NXDI_NEG_INF;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool v = (vis >> (nt * 8 + 2 * tig + e)) & 1u;
            float& x = sc[nt][2 * half + e];
            x = v ? x * scale : NXDI_NEG_INF;
            mx = fmaxf(mx, x);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(st.m[half], mx);
        const float corr = expf(st.m[half] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool v = (vis >> (nt * 8 + 2 * tig + e)) & 1u;
            float& x = sc[nt][2 * half + e];
            x = v ? expf(x - m_new) : 0.f;
            rs += x;
          }
        }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        st.l[half] = st.l[half] * corr + rs;
        st.m[half] = m_new;
#pragma unroll
        for (int u = 0; u < NT; ++u) {
          st.o[u][2 * half] *= corr;
          st.o[u][2 * half + 1] *= corr;
        }
      }
      // O += P V: P (rounded to bf16; fused: f32 as a hi + lo pair) is the A
      // operand straight from the score registers, V^T from ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ph[4], pl[4];
        const float* s0 = sc[2 * kk];
        const float* s1 = sc[2 * kk + 1];
        if constexpr (kRoundP) {
          ph[0] = pack_bf16(s0[0], s0[1]);
          ph[1] = pack_bf16(s0[2], s0[3]);
          ph[2] = pack_bf16(s1[0], s1[1]);
          ph[3] = pack_bf16(s1[2], s1[3]);
        } else {
          split_bf16(s0[0], s0[1], ph[0], pl[0]);
          split_bf16(s0[2], s0[3], ph[1], pl[1]);
          split_bf16(s1[0], s1[1], ph[2], pl[2]);
          split_bf16(s1[2], s1[3], ph[3], pl[3]);
        }
        const int vrow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int u = 0; u < NT; u += 2) {
          if (u * 8 < D) {
            uint32_t vb[4];
            ldmatrix_x4_trans(vb, sV + vrow * kp + u * 8 + (lane >> 4) * 8);
            mma_bf16(st.o[u], ph, vb[0], vb[1]);
            mma_bf16(st.o[u + 1], ph, vb[2], vb[3]);
            if constexpr (!kRoundP) {
              mma_bf16(st.o[u], pl, vb[0], vb[1]);
              mma_bf16(st.o[u + 1], pl, vb[2], vb[3]);
            }
          }
        }
      }
      __syncwarp();  // the next tile's copies (bf16) or conversion overwrite what this one read
    }
  }
};

// The warp's state into the merge area: m and l [NW][G], O [NW][G][D]
template <int DMAX>
__device__ __forceinline__ void mma_state_store(const MmaState<DMAX>& st, float* sM, float* sL,
                                                float* sAcc, int G, int D) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int g = grp + 8 * half;
    if (g < G) {
      if (tig == 0) {
        sM[warp * G + g] = st.m[half];
        sL[warp * G + g] = st.l[half];
      }
#pragma unroll
      for (int u = 0; u < DMAX / 8; ++u) {
        const int d = u * 8 + 2 * tig;
        if (d < D) {
          sAcc[(warp * G + g) * D + d] = st.o[u][2 * half];
          sAcc[(warp * G + g) * D + d + 1] = st.o[u][2 * half + 1];
        }
      }
    }
  }
}

}  // namespace
