// Flash-attention prefill for Hopper: the bf16 body of the contiguous mode
// (flash_prefill.cu) and of the paged mode (paged_prefill.cu), and the
// one-byte pool's body of the paged mode and of the ragged mode's wgmma
// items (paged_prefill_1b.cu, ragged_paged_1b.cu), at head dims 64 and 128,
// on TMA + wgmma with warp specialisation.
//
// Replaces nxdi_tpu/ops/kernels/flash_attention.py::flash_attention_prefill
// (Pallas body _prefill_kernel, pl.pallas_call at :234) for those cases and
// computes exactly its function, as prefill_kernel.cuh states it: positions
// q_start[b] + i and kv_start[b] + j, causal with the sliding-window and
// chunk masks, GQA h -> h / G without repeating K/V, an f32 online softmax
// (mask value -30000, the denominator clamped at 1e-20), probabilities
// rounded to bf16 before P.V. The other bodies stay for their cases (the
// wrapper, flash_attention.py::prefill_body, picks): prefill_tc_kernel
// (mma.sync) for other bf16 head dims and for the ragged mode's direct
// tiles (ragged_paged.cu); prefill_kernel (CUDA cores) for f32.
//
// The paged mode (PAGED; replaces ::paged_attention_prefill, Pallas body
// _paged_prefill_kernel, pl.pallas_call at :946; flash_attention.py::
// paged_prefill_body picks it for bf16 at D 64/128 when the block size is
// 8, 16, 32, 64 or a multiple of 128): a chunk of Sq queries at positions
// q_start[b] + i attends its row's logical positions through the block
// table, causal and inclusive, holes skipped, k_scale folded into `scale`
// and v_scale on the output. K and V come from tensor maps over the pool
// layer (total_slots, KV, D) as dims (D, KV, total_slots), boxes of 64
// columns x 1 head x min(bs, 128) slots: a 128-row kv tile is one box per
// 64 columns at bs >= 128, or 128 / bs boxes at smaller blocks, each at
// slot bt[b][j / bs] * bs + j % bs (the producer reads the table). A hole
// is never loaded: the stage's expected bytes count the boxes issued, the
// hole's V rows are zeroed in shared memory (stale bits could be NaN, and
// P.V would carry 0 * NaN), and the consumers mask its columns; a tile of
// holes only is skipped by producer and consumers alike. The pool layer's
// address does not change between calls, so its maps are cached by
// (pointer, shape, box); only Q's map is encoded per call.
//
// The one-byte body (prefill_wgmma_1b_kernel; bf16 q over a float8_e4m3fn,
// float8_e5m2 or int8 pool, k_scale in `scale`, v_scale on the output as
// above; replaces ::paged_attention_prefill at :946 for such pools, bound
// by operations: 0.0033 ms for a 512-token chunk after 512 cached, and
// the direct tiles of ragged_paged_attention.py::ragged_paged_attention,
// :199). wgmma multiplies bf16 only by bf16 (fp8 only by fp8) and q stays
// bf16, as on the TPU, so the tensor cores need K and V in bf16 in shared
// memory, not in device memory. The producer warpgroup's warp 8 loads each
// live pool block's raw rows by TMA (a uint8 map over the pool layer,
// boxes of D bytes x 1 head x min(bs, 128) slots, no swizzle) into a ring
// of raw stages at half a bf16 stage's bytes; warps 9-11, idle in the bf16
// body, convert each landed raw stage into a bf16 stage laid out exactly as
// the bf16 body's swizzled boxes land (fp8 by cvt.rn.f16x2.e4m3x2 /
// .e5m2x2, then to bf16; int8 through f32), write a hole's V rows as 0,
// fence the stores to the async proxy and arrive on the stage's full
// barrier; the consumers are the bf16 body's, unchanged. Every conversion
// is exact, so the only rounding is the store's own (the JAX body's
// k_ref[...].astype(compute_dtype)) and the output equals the bf16 body's
// on the up-cast pool bit for bit. Shared memory holds Q, bf16 stages and
// raw stages: 5 + 2 at D 64 (208 KB), 2 + 2 at D 128 (224 KB of the 227
// KB), the raw stages letting the loads run ahead of the conversion and the
// bf16 stages the conversion ahead of the products (kFq1bStages gives the
// measurements that chose the split). The
// producer warpgroup keeps 56 registers (the converters hold a raw chunk
// and its 16 bf16), the consumers 224. The ragged mode takes its work from
// the plan (ragged_paged_attention.py::ragged_plan): each wgmma item is up
// to 128 consecutive tokens of one row at consecutive positions, one q
// tile, Q read by TMA from the stream at its first token (zero-filled past
// T), positions tok_pos of the first token plus i, only its own tokens
// written; blocks walk items x q heads up to the count in the plan's
// header, so a CUDA graph's launch sized for the bucket serves every plan.
//
// Bound: operations. At the Llama-3.2-1B prefill (B 8, H 32, S 1024, D 64)
// one layer is 3.4e10 flop, 35 us at the 989 TFLOP/s bf16 peak, and only
// wgmma reaches that rate (mma.sync with cp.async copies, every thread
// spending registers and instructions on them, reaches a tenth). At D 64 the
// softmax is as dear as the products: a score's ex2 takes the SM's 16
// special-function lanes as long as its 256 flops take the tensor cores,
// and the max, the FMA, the sum and the bf16 pack issue beside it, so the
// softmax's instruction count sets much of the time (scripts/
// ablate_prefill.py measures the body with parts removed).
//
// Design: persistent blocks, one per SM, walk the (b, h, 128-row q tile)
// work in a static order; a q tile's kv tiles run up to its last row's
// causal limit.
//  - Warps 0-7 are two consumer warpgroups, 64 q rows each; warps 8-11 are
//    the producer warpgroup. It gives its registers away (setmaxnreg: 168
//    at entry, the producer drops to 40 and the consumers take 232, which
//    balances the block's 384 x 168) and one lane of warp 8 issues the TMA
//    loads: each q tile's Q once (a full and an empty mbarrier: the next
//    tile's Q lands while the last P.V and the epilogue of this one run),
//    then K and V tiles of 128 rows into a ring of stages (4 at D 64, 3 at
//    D 128), each guarded by a full and an empty mbarrier. Rows are
//    64-column boxes with the 128-byte swizzle.
//  - S = Q K^T is wgmma m64n128k16 with Q and K read K-major from their
//    row-major tiles; P.V is wgmma with P (rounded to bf16) as the A operand
//    straight from the S registers, and V read MN-major from its row-major
//    tile, as gemm_kernel.cuh reads its weights. No transpose is staged.
//  - The online softmax stays in f32 registers in log2 units (ex2.approx);
//    each row's visible kv positions are one interval (causal, Sk, window
//    and chunk starts) computed once, so only a tile the interval cuts (the
//    diagonal, the Sk edge, window and chunk edges) is masked, with two
//    compares per score.
//  - Tensor maps are encoded per call over the model's strided (B, S, H, D)
//    -transposed views (dims D, heads, S, B) and passed as __grid_constant__
//    parameters: the pointers change every layer, so no cache applies. TMA
//    zero-fills rows past Sq and Sk; the masks and the epilogue skip them.
//    It needs a 16-byte aligned base and strides that are multiples of 16
//    bytes (the wrapper checks and raises).
//  - Pingpong: the two consumer warpgroups take turns on the tensor cores
//    (named barriers), each issuing one kv tile's S and the previous one's
//    P.V together, so one's softmax runs under the other's products.
//  - Longest first, no atomics: block i takes work items i, i + grid, ...
//    of an order that lists the last q tiles (the most kv tiles) first, so
//    the short ones fill the tail; the ring, its barrier phases and the
//    next tile's loads run on across a block's items.
#pragma once

#include <initializer_list>
#include <mutex>

#include "prefill_kernel.cuh"
#include "tma_wgmma.cuh"

namespace {

constexpr int kFqBQ = 128;  // q rows per work item (two consumer warpgroups)
constexpr int kFqBK = 128;  // kv rows per tile
constexpr int kFqBox = 128 * 128;  // one 64-column box of 128 rows, 16 KB

template <int D>
constexpr int kFqStages = D == 64 ? 4 : 3;
template <int D>
constexpr size_t fq_smem() {
  // Q, then stages of K and V, D / 64 boxes each; barriers after (Q full
  // and empty, a full and an empty per stage); 1 KB for the swizzle's
  // alignment
  return (size_t)(D / 64) * kFqBox * (1 + 2 * kFqStages<D>) + 1024 +
         8 * (2 + 2 * kFqStages<D>);
}

// S (64 x 128, f32) = A (64 x 16, K-major, shared) * B (16 x 128, K-major: the
// row-major K tile, hence imm-trans-b = 0) + (accumulate ? S : 0)
__device__ __forceinline__ void wgmma_ss_m64n128k16_kk(float* d, uint64_t da, uint64_t db,
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
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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

// O (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64, MN-major:
// the row-major V tile, hence imm-trans-b = 1), or = without accumulate
__device__ __forceinline__ void wgmma_rs_m64n64k16(float* d, const uint32_t* a, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// O (64 x 128, f32): as wgmma_rs_m64n64k16, 128 columns
__device__ __forceinline__ void wgmma_rs_m64n128k16(float* d, const uint32_t* a, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// 2^x on the SFU (ex2.approx, flush-to-zero): the softmax's exponent; a
// score masked to -30000 log2(e) flushes to 0 as in exp2f
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One warpgroup's running state: its lane's two rows' output accumulator,
// max and denominator (log2 units), and visible kv intervals.
template <int D>
struct FqRows {
  float o[D / 2];
  float m[2], l[2];
  int vlo[2], vhi[2];
};

// S = Q K^T for one warpgroup, issued (the caller fences and commits): qa, the
// warpgroup's Q rows (rows 128 B apart in 8-row groups 1024 B apart, k16
// steps 32 B along a row, the second 64 columns in the next box); kb, the
// stage's K tile, read K-major the same way.
template <int D>
__device__ __forceinline__ void fq_scores(float* sc, uint32_t qa, uint32_t kb) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kFqBox + 32 * (kk % 4);
    wgmma_ss_m64n128k16_kk(sc, wgmma_desc(qa + off, 16, 1024), wgmma_desc(kb + off, 16, 1024),
                           kk != 0);
  }
}

// The (masked, MASK) online softmax of one tile's scores, in place: P in sc,
// the running max and denominator updated, O rescaled. t_lo: the kv
// position of the tile's first column. HOLES (the paged mode): column c is
// also masked when bit c >> box_shift of `holes` is set.
template <int D, bool MASK, bool HOLES = false>
__device__ __forceinline__ void fq_softmax(FqRows<D>& st, float* sc, int t_lo, float scale_log2,
                                           int tig, uint32_t holes = 0, int box_shift = 0) {
  // mask (MASK) + online softmax; accumulator chunk j, value e: row
  // r_lo + 8 (e / 2), column 8 j + 2 tig + e % 2. The max is taken over the
  // raw scores (scale > 0) and the scale folds into the exponent's FMA, so
  // a score costs a max, an FMA, an ex2 and an add; they run in four
  // independent chains (8 consumer warps an SM do not hide a chain's
  // latency). A masked score counts as -30000 (log2 units: the running max
  // starts there) and its probability is 0.
  const float neg_inf = __int_as_float(0xff800000u);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c_lo = st.vlo[half] - t_lo, c_hi = st.vhi[half] - t_lo;  // visible columns
    float mx4[4] = {neg_inf, neg_inf, neg_inf, neg_inf};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * tig + e;
        float& v = sc[4 * j + 2 * half + e];
        if constexpr (MASK) {
          bool vis = c >= c_lo && c <= c_hi;
          if constexpr (HOLES) vis = vis && !((holes >> (c >> box_shift)) & 1u);
          v = vis ? v : neg_inf;
        }
        mx4[(2 * j + e) & 3] = fmaxf(mx4[(2 * j + e) & 3], v);
      }
    }
    float mx = fmaxf(fmaxf(mx4[0], mx4[1]), fmaxf(mx4[2], mx4[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(st.m[half], mx * scale_log2);
    const float corr = fast_exp2(st.m[half] - m_new);
    float rs4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = sc[4 * j + 2 * half + e];
        // ex2(-inf) is 0: a masked score's probability
        v = fast_exp2(fmaf(v, scale_log2, -m_new));
        rs4[(2 * j + e) & 3] += v;
      }
    }
    float rs = (rs4[0] + rs4[1]) + (rs4[2] + rs4[3]);
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    st.l[half] = st.l[half] * corr + rs;
    st.m[half] = m_new;
    if (__any_sync(0xffffffffu, corr != 1.f)) {  // no row's max moved: O stands
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        st.o[4 * j + 2 * half] *= corr;
        st.o[4 * j + 2 * half + 1] *= corr;
      }
    }
  }
}

// P (rounded to bf16) packed as the register A operand of O += P V: the
// m16n8k16 A-fragment of each warp's 16 rows, k16 step kk from score
// chunks 2 kk and 2 kk + 1.
__device__ __forceinline__ void fq_pack(uint32_t (&pa)[kFqBK / 16][4], const float* sc) {
#pragma unroll
  for (int kk = 0; kk < kFqBK / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// O += P V for one warpgroup, issued (the caller fences and commits): vb,
// the stage's V tile, read MN-major; k16 steps 16 rows (2 KB) down its
// boxes, the next 64 columns one box on.
template <int D>
__device__ __forceinline__ void fq_pv(FqRows<D>& st, const uint32_t (&pa)[kFqBK / 16][4],
                                      uint32_t vb) {
#pragma unroll
  for (int kk = 0; kk < kFqBK / 16; ++kk) {
    const uint64_t dv = wgmma_desc(vb + 2048 * kk, kFqBox, 1024);
    if constexpr (D == 64) {
      wgmma_rs_m64n64k16(st.o, pa[kk], dv, 1);
    } else {
      wgmma_rs_m64n128k16(st.o, pa[kk], dv, 1);
    }
  }
}

// One q tile of the persistent walk. Contiguous and paged: tile t of
// B * H * (Sq / 128) counts q tiles from the last (longest first), (b, h)
// fastest. Ragged: tile t is q head t % H of the plan's wgmma item t / H
// (the plan lists them longest first). b: the row whose table (paged,
// ragged) is read; qb: Q's and the output's batch row; rows q0 .. q_end - 1
// of Q are the tile's own, at positions qs + q0 + i.
struct FqWork {
  int b, h, kvh, qb, q0, q_end, qs, ks, n_kv;
};

// The wgmma items of a ragged plan (its header counts them)
__device__ __forceinline__ const int* fq_wg_items(const PrefillArgs& a) {
  return a.plan + kPlanHeader + a.plan[1];
}

template <int MODE>
__device__ __forceinline__ int fq_n_work(const PrefillArgs& a, int B) {
  if constexpr (MODE == KV_RAGGED) {
    return a.plan[kPlanWgCount] * a.H;
  } else {
    return B * a.H * ((a.Sq + kFqBQ - 1) / kFqBQ);
  }
}

template <int MODE>
__device__ __forceinline__ FqWork fq_work(const PrefillArgs& a, int t, int B) {
  FqWork w;
  int q_hi;  // the last real q row's position
  if constexpr (MODE == KV_RAGGED) {
    const int* it = fq_wg_items(a) + (t / a.H) * kWgInts;  // token, tokens, row, position
    w.h = t % a.H;
    w.b = it[2];
    w.qb = 0;
    w.q0 = it[0];
    w.q_end = it[0] + it[1];
    w.qs = it[3] - it[0];
    w.ks = 0;
    q_hi = it[3] + it[1] - 1;
  } else {
    const int BH = B * a.H, n_qt = (a.Sq + kFqBQ - 1) / kFqBQ;
    const int bh = t % BH;
    w.b = bh / a.H;
    w.h = bh % a.H;
    w.qb = w.b;
    w.q0 = (n_qt - 1 - t / BH) * kFqBQ;
    w.q_end = a.Sq;
    w.qs = a.q_start[w.b];
    w.ks = a.kv_start ? a.kv_start[w.b] : 0;
    q_hi = w.qs + min(w.q0 + kFqBQ, a.Sq) - 1;
  }
  w.kvh = w.h / (a.H / a.KV);
  // kv tiles up to the last real q row's causal limit
  w.n_kv = q_hi < w.ks ? 0 : min((a.Sk + kFqBK - 1) / kFqBK, (q_hi - w.ks) / kFqBK + 1);
  return w;
}

// The table a work item reads (paged, ragged), null for the contiguous mode
template <int MODE>
__device__ __forceinline__ const int* fq_table(const PrefillArgs& a, const FqWork& w) {
  return MODE == KV_CONTIG ? nullptr : a.bt + (long long)w.b * a.nb;
}

// Paged, ragged: the boxes of kv tile kt that are holes, bit i for box i of
// the tile's 128 / min(bs, 128) (a negative table entry, or past the
// table); every bit set: the tile is skipped (flash_attention.py::
// paged_prefill_boxes mirrors the boxes).
__device__ __forceinline__ uint32_t fq_tile_holes(const PrefillArgs& a, const int* btr, int kt) {
  const int rows = min(a.bs, kFqBK);
  uint32_t holes = 0;
  for (int i = 0; i < kFqBK / rows; ++i) {
    const int e = (kt * kFqBK + i * rows) / a.bs;
    if (e >= a.nb || btr[e] < 0) holes |= 1u << i;
  }
  return holes;
}

// the hole bits of a tile with no live box (0 for the contiguous mode)
template <int MODE>
__device__ __forceinline__ uint32_t fq_all_holes(const PrefillArgs& a) {
  return MODE == KV_CONTIG ? 0u : (1u << (kFqBK / min(a.bs, kFqBK))) - 1u;
}

__device__ __forceinline__ void st_shared_zero16(uint32_t addr) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(addr), "r"(0) : "memory");
}

// The consumer warpgroups (warps 0-7) over the block's work items: S = Q K^T
// and O += P V on wgmma from the stages of a ring of kST (K, V) bf16 tiles,
// guarded by full (landed) and empty (read) mbarriers, the online softmax in
// registers, the output written per row. Both producers (the bf16 TMA
// loads, the one-byte pool's converters) fill the same ring.
template <int D, int MODE, int kST>
__device__ __forceinline__ void fq_consume(const PrefillArgs& a, int B, uint32_t sq, uint32_t sk0,
                                           uint32_t qfull, uint32_t qempty, uint32_t full0,
                                           uint32_t empty0, int warp, int lane) {
  constexpr bool TABLE = MODE != KV_CONTIG;
  constexpr int kTile = (D / 64) * kFqBox;  // bytes of one Q, K or V tile
  const int n_work = fq_n_work<MODE>(a, B);
  const uint32_t all_holes = fq_all_holes<MODE>(a);
  // warpgroup wg owns q rows q0 + 64 wg .. + 63 of each tile
  const int wg = warp >> 2;
  const int grp = lane >> 2, tig = lane & 3;
  const int r_lo = 64 * wg + 16 * (warp & 3) + grp;  // this lane's rows: r_lo, r_lo + 8
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr float kNegInfLog2 = NXDI_NEG_INF * kLog2e;
  const float scale_log2 = a.scale * kLog2e;
  const uint32_t qa = sq + wg * 8192;  // this warpgroup's 64 Q rows in each box
  const int bar_mine = 1 + wg, bar_other = 2 - wg;
  auto stage_of = [&](int i) { return sk0 + 2 * (i % kST) * kTile; };
  auto warp_arrive = [&](uint32_t bar) {  // this warp is done with what bar guards
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  int it = 0;  // ring position, across this block's q tiles
  for (int t = blockIdx.x, n = 0; t < n_work; t += gridDim.x, ++n) {
    const FqWork w = fq_work<MODE>(a, t, B);
    // the kv positions a row at position qp sees, [lo, hi]: causal, inside
    // Sk, after the window's start and the chunk's start (kv <= q puts kv
    // in q's chunk iff kv >= q's chunk start), so a mask is two compares
    // per score; for this lane's two rows, and (both nondecreasing in qp)
    // the positions every row of the tile sees
    auto visible_lo = [&](int qp) {
      int lo = w.ks;
      if (a.window > 0) lo = max(lo, qp - a.window + 1);
      if (a.chunk > 0) lo = max(lo, floordiv(qp, a.chunk) * a.chunk);
      return lo;
    };
    const int sk_hi = w.ks + a.Sk - 1;
    FqRows<D> st;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) st.o[i] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qp = w.qs + w.q0 + r_lo + 8 * half;
      st.vlo[half] = visible_lo(qp);
      st.vhi[half] = min(qp, sk_hi);
      st.m[half] = kNegInfLog2;
      st.l[half] = 0.f;
    }
    const int blk_vlo = visible_lo(w.qs + w.q0 + kFqBQ - 1);
    const int blk_vhi = min(w.qs + w.q0, sk_hi);

    // Pingpong: each warpgroup alternates a product phase (this kv tile's
    // S = Q K^T and the previous one's O += P V, issued together) with a
    // softmax phase, and named barriers 1 and 2 hand the tensor cores
    // from one warpgroup to the other, so one's softmax runs under the
    // other's products. Warpgroup 0 goes first; each step a warpgroup
    // waits its turn (bar.sync on its barrier, 256 threads: its own 128
    // and the other's 128 arriving), issues, and passes the turn on
    // (bar.arrive on the other's); warpgroup 1's last pass of a q tile is
    // left out, so every arrival meets a sync. Only a kv tile some row's
    // visible interval cuts (the diagonal, the Sk edge, window or chunk
    // edges) is masked; the test is the q tile's, so no warp diverges and
    // the unmasked softmax holds no mask code.
    // paged, ragged: the q tile's kv tiles that hold a live box, in order
    // (the producer skips the others too); contiguous: every kv tile
    const int* btr = fq_table<MODE>(a, w);
    auto next_live = [&](int kt) {
      if constexpr (TABLE) {
        while (kt < w.n_kv && fq_tile_holes(a, btr, kt) == all_holes) ++kt;
      }
      return kt;
    };
    int n_live = w.n_kv;
    if constexpr (TABLE) {
      n_live = 0;
      for (int kt = next_live(0); kt < w.n_kv; kt = next_live(kt + 1)) ++n_live;
    }
    const int box_shift = TABLE ? __ffs(min(a.bs, kFqBK)) - 1 : 0;
    uint32_t pa[kFqBK / 16][4];  // the previous kv tile's P, packed as the A operand
    float sc[64];
    mbar_wait(qfull, n & 1);
    if (wg == 1) asm volatile("bar.arrive %0, 256;\n" ::"r"(bar_other) : "memory");
    int kt = next_live(0);  // the i-th live kv tile (i < n_live)
    for (int i = 0; i <= n_live; ++i) {
      if (i < n_live) mbar_wait(full0 + 8 * ((it + i) % kST), ((it + i) / kST) & 1);
      asm volatile("bar.sync %0, 256;\n" ::"r"(bar_mine) : "memory");
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      if (i < n_live) fq_scores<D>(sc, qa, stage_of(it + i));
      if (i > 0) fq_pv<D>(st, pa, stage_of(it + i - 1) + kTile);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (wg == 0 || i < n_live)
        asm volatile("bar.arrive %0, 256;\n" ::"r"(bar_other) : "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (i > 0) warp_arrive(empty0 + 8 * ((it + i - 1) % kST));
      if (i + 1 >= n_live && i < n_live) warp_arrive(qempty);  // the last S is done
      if (i < n_live) {
        const int t_lo = w.ks + kt * kFqBK;  // kv position of the tile's first column
        uint32_t holes = 0;
        if constexpr (TABLE) holes = fq_tile_holes(a, btr, kt);
        if (t_lo >= blk_vlo && t_lo + kFqBK - 1 <= blk_vhi && holes == 0) {
          fq_softmax<D, false>(st, sc, t_lo, scale_log2, tig);
        } else {
          fq_softmax<D, true, TABLE>(st, sc, t_lo, scale_log2, tig, holes, box_shift);
        }
        fq_pack(pa, sc);  // (O's rescale above: the previous P V has completed)
        kt = next_live(kt + 1);
      }
    }
    if (n_live == 0) warp_arrive(qempty);
    it += n_live;

    using bf = __nv_bfloat16;
    bf* out = static_cast<bf*>(a.out) + w.qb * a.osb + w.h * a.osh;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = w.q0 + r_lo + 8 * half;
      if (row >= w.q_end) continue;
      const float inv = a.v_scale / fmaxf(st.l[half], 1e-20f);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * a.oss + 8 * j + 2 * tig) =
            __floats2bfloat162_rn(st.o[4 * j + 2 * half] * inv,
                                  st.o[4 * j + 2 * half + 1] * inv);
      }
    }
  }
}

// The bf16 body (contiguous or paged K/V in bf16): one lane of warp 8 loads
// Q and the K/V tiles by TMA straight into the ring's bf16 stages.
template <int D, int MODE>
__global__ void __launch_bounds__(384, 1)
    prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, PrefillArgs a, int B) {
  extern __shared__ uint8_t fsm_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(fsm_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  constexpr int kST = kFqStages<D>, kNB = D / 64;
  constexpr int kTile = kNB * kFqBox;  // bytes of one Q, K or V tile
  const uint32_t sq = smem_u32(sm);
  const uint32_t sk0 = sq + kTile;  // ring stage s: K at sk0 + 2 s kTile, V kTile on
  const uint32_t qfull = sq + (1 + 2 * kST) * kTile, qempty = qfull + 8;
  const uint32_t full0 = qempty + 8, empty0 = full0 + 8 * kST;

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    mbar_init(qempty, 8);  // one arrival per consumer warp
    for (int s = 0; s < kST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {
      tma_prefetch(&tq);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
      const int n_work = fq_n_work<MODE>(a, B);
      const uint32_t all_holes = fq_all_holes<MODE>(a);
      int it = 0;  // ring position, across this block's q tiles
      for (int t = blockIdx.x, n = 0; t < n_work; t += gridDim.x, ++n) {
        const FqWork w = fq_work<MODE>(a, t, B);
        if (n > 0) mbar_wait(qempty, (n - 1) & 1);  // the last tile's S products are done
        mbar_expect_tx(qfull, kTile);
#pragma unroll
        for (int c = 0; c < kNB; ++c)
          tma_load_4d(sq + c * kFqBox, &tq, 64 * c, w.h, w.q0, w.qb, qfull);
        const int* btr = fq_table<MODE>(a, w);
        for (int kt = 0; kt < w.n_kv; ++kt) {
          uint32_t holes = 0;
          if constexpr (MODE == KV_PAGED) {
            holes = fq_tile_holes(a, btr, kt);
            if (holes == all_holes) continue;  // nothing to load or attend
          }
          const int s = it % kST;
          if (it >= kST) mbar_wait(empty0 + 8 * s, ((it / kST) - 1) & 1);
          const uint32_t full = full0 + 8 * s, st = sk0 + 2 * s * kTile;
          if constexpr (MODE == KV_PAGED) {
            const int rows = min(a.bs, kFqBK);
            const uint32_t box_bytes = rows * 128;  // 64 bf16 columns a row
            if (holes) {  // the holes' V rows read as 0 (before the barrier's arrival)
              for (int i = 0; i < kFqBK / rows; ++i) {
                if (!((holes >> i) & 1u)) continue;
#pragma unroll
                for (int c = 0; c < kNB; ++c)
                  for (uint32_t o = 0; o < box_bytes; o += 16)
                    st_shared_zero16(st + kTile + c * kFqBox + i * box_bytes + o);
              }
              asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            }
            const int live = kFqBK / rows - __popc(holes);
            mbar_expect_tx(full, 2 * kNB * live * box_bytes);
            for (int i = 0; i < kFqBK / rows; ++i) {
              if ((holes >> i) & 1u) continue;
              const int j = kt * kFqBK + i * rows;
              const int slot = btr[j / a.bs] * a.bs + j % a.bs;
#pragma unroll
              for (int c = 0; c < kNB; ++c) {
                tma_load_3d(st + c * kFqBox + i * box_bytes, &tk, 64 * c, w.kvh, slot, full);
                tma_load_3d(st + kTile + c * kFqBox + i * box_bytes, &tv, 64 * c, w.kvh, slot,
                            full);
              }
            }
          } else {
            mbar_expect_tx(full, 2 * kTile);
#pragma unroll
            for (int c = 0; c < kNB; ++c) {
              tma_load_4d(st + c * kFqBox, &tk, 64 * c, w.kvh, kt * kFqBK, w.b, full);
              tma_load_4d(st + kTile + c * kFqBox, &tv, 64 * c, w.kvh, kt * kFqBK, w.b, full);
            }
          }
          ++it;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    fq_consume<D, MODE, kST>(a, B, sq, sk0, qfull, qempty, full0, empty0, warp, lane);
  }
}

// ---------------------------------------------------------------------------
// The one-byte pool's body (paged and ragged modes)
// ---------------------------------------------------------------------------

constexpr int kFqCvtWarps = 3;  // warps 9-11 convert; warp 8's lane 0 issues the TMA loads

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, const uint4& v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// One landed raw stage (K then V, 128 rows of D bytes each, as TMA wrote
// them) into a bf16 stage laid out exactly as the bf16 body's TMA boxes
// land: 64-column boxes of 128-byte rows, the 16-byte chunk c of row r at
// chunk c ^ (r % 8) (the 128-byte swizzle the consumers' descriptors read).
// Thread ct of the kFqCvtWarps converting warps takes 16-byte raw chunks
// ct, ct + 96, ...; a hole's V rows are written as 0 (stale bits could be
// NaN, and P.V would carry 0 * NaN), its K rows are left (their columns
// are masked).
template <int D, typename S>
__device__ __forceinline__ void fq_convert(uint32_t dst, uint32_t src, uint32_t holes,
                                           int box_shift, int ct) {
  constexpr int kC16 = D / 16;          // 16-byte raw chunks a row
  constexpr int kPer = kFqBK * kC16;    // of a K or V tile
  constexpr int kTile = (D / 64) * kFqBox;
  for (int i = ct; i < 2 * kPer; i += 32 * kFqCvtWarps) {
    const int v = i >= kPer;  // 0: K, 1: V
    const int rem = i - v * kPer;
    const int row = rem / kC16, c = rem % kC16;
    const bool hole = (holes >> (row >> box_shift)) & 1u;
    if (hole && !v) continue;
    uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
    if (!hole) one_byte_16_bf16<S>(ld_shared_v4(src + v * kFqBK * D + row * D + 16 * c), lo, hi);
    // columns 16 c .. 16 c + 15: the row's chunks 2 c % 8 and the next, in box c / 4
    const uint32_t base = dst + v * kTile + (c / 4) * kFqBox + row * 128;
    const int j = (2 * c) & 7;
    st_shared_v4(base + ((j ^ (row & 7)) << 4), lo);
    st_shared_v4(base + (((j + 1) ^ (row & 7)) << 4), hi);
  }
}

// bf16 stages and raw one-byte stages of the one-byte body: at D 64, 5 bf16
// and 2 raw (Q 16 KB + 5 x 32 KB + 2 x 16 KB = 208 KB); at D 128, 2 of each
// (32 + 2 x 64 + 2 x 32 = 224 KB of the 227 KB a block may hold; two bf16
// stages are the least the consumers take, since they read stage i's K
// beside stage i - 1's V). The conversion, not the loads' latency, is what
// the ring must absorb, so bf16 stages count more than raw ones:
// scripts/stages_prefill_1b.py on an NVIDIA H100 80GB HBM3 at 700 W, a
// 512-token chunk after 3584 cached (B 4, e4m3): 5 + 2 0.310 ms, 4 + 2
// 0.316, 4 + 4 0.321, 3 + 3 0.322, 2 + 2 0.343 (the bf16 body 0.290); at
// D 128, 2 + 2 0.579, 2 + 1 0.584 (bf16 0.322); at phase 3e's shape every
// split at D 64 but 2 + 2 within 0.0001 ms.
template <int D>
constexpr int kFq1bStages = D == 64 ? 5 : 2;
template <int D>
constexpr int kFq1bRaw = D == 64 ? 2 : 2;
template <int D>
constexpr size_t fq_1b_smem() {
  // Q, the bf16 stages (K, V), the raw stages (K, V: one byte an element);
  // barriers: Q full and empty, a full and an empty per stage of each ring;
  // 1 KB for the swizzle's alignment
  return (size_t)(D / 64) * kFqBox * (1 + 2 * kFq1bStages<D>) +
         (size_t)2 * kFqBK * D * kFq1bRaw<D> + 1024 + 8 * (2 + 2 * kFq1bStages<D> + 2 * kFq1bRaw<D>);
}

// The one-byte body (paged or ragged): warp 8's lane 0 loads Q by TMA into
// the bf16 Q tile and each live pool block's raw K/V rows by TMA into a
// ring of raw stages (boxes of D bytes x 1 head x min(bs, 128) slots, no
// swizzle); warps 9-11 convert each landed raw stage into the next bf16
// stage (fq_convert) and arrive on its full barrier; the consumers run
// unchanged (fq_consume). Register budget: the producer warpgroup drops to
// 56 (the converters hold a raw chunk, its 16 bf16 and their addresses),
// the consumers take 224 (56 x 128 + 224 x 256 = 168 x 384).
template <int D, int MODE, typename S>
__global__ void __launch_bounds__(384, 1)
    prefill_wgmma_1b_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, PrefillArgs a, int B) {
  static_assert(MODE != KV_CONTIG, "a one-byte store is the paged pool's");
  extern __shared__ uint8_t fsm_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(fsm_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  constexpr int kST = kFq1bStages<D>, kRS = kFq1bRaw<D>, kNB = D / 64;
  constexpr int kTile = kNB * kFqBox;  // bytes of one bf16 Q, K or V tile
  constexpr int kRaw = kFqBK * D;      // bytes of one raw K or V tile
  const uint32_t sq = smem_u32(sm);
  const uint32_t sk0 = sq + kTile;  // bf16 stage s: K at sk0 + 2 s kTile, V kTile on
  const uint32_t raw0 = sk0 + 2 * kST * kTile;  // raw stage s: K at raw0 + 2 s kRaw, V kRaw on
  const uint32_t qfull = raw0 + 2 * kRS * kRaw, qempty = qfull + 8;
  const uint32_t full0 = qempty + 8, empty0 = full0 + 8 * kST;
  const uint32_t rfull0 = empty0 + 8 * kST, rempty0 = rfull0 + 8 * kRS;

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    mbar_init(qempty, 8);  // one arrival per consumer warp
    for (int s = 0; s < kST; ++s) {
      mbar_init(full0 + 8 * s, kFqCvtWarps);  // one arrival per converting warp
      mbar_init(empty0 + 8 * s, 8);
    }
    for (int s = 0; s < kRS; ++s) {
      mbar_init(rfull0 + 8 * s, 1);
      mbar_init(rempty0 + 8 * s, kFqCvtWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int n_work = fq_n_work<MODE>(a, B);
    const uint32_t all_holes = fq_all_holes<MODE>(a);
    const int rows = min(a.bs, kFqBK);
    if (warp == 8) {
      if (lane == 0) {  // the TMA loads: Q, then the raw K/V boxes
        tma_prefetch(&tq);
        tma_prefetch(&tk);
        tma_prefetch(&tv);
        const uint32_t box_bytes = rows * D;  // D bytes a row
        int it = 0;  // raw ring position, across this block's q tiles
        for (int t = blockIdx.x, n = 0; t < n_work; t += gridDim.x, ++n) {
          const FqWork w = fq_work<MODE>(a, t, B);
          if (n > 0) mbar_wait(qempty, (n - 1) & 1);  // the last tile's S products are done
          mbar_expect_tx(qfull, kTile);
#pragma unroll
          for (int c = 0; c < kNB; ++c)
            tma_load_4d(sq + c * kFqBox, &tq, 64 * c, w.h, w.q0, w.qb, qfull);
          const int* btr = fq_table<MODE>(a, w);
          for (int kt = 0; kt < w.n_kv; ++kt) {
            const uint32_t holes = fq_tile_holes(a, btr, kt);
            if (holes == all_holes) continue;  // nothing to load or attend
            const int s = it % kRS;
            if (it >= kRS) mbar_wait(rempty0 + 8 * s, ((it / kRS) - 1) & 1);
            const uint32_t rfull = rfull0 + 8 * s, rk = raw0 + 2 * s * kRaw;
            const int live = kFqBK / rows - __popc(holes);
            mbar_expect_tx(rfull, 2 * live * box_bytes);
            for (int i = 0; i < kFqBK / rows; ++i) {
              if ((holes >> i) & 1u) continue;
              const int j = kt * kFqBK + i * rows;
              const int slot = btr[j / a.bs] * a.bs + j % a.bs;
              tma_load_3d(rk + i * box_bytes, &tk, 0, w.kvh, slot, rfull);
              tma_load_3d(rk + kRaw + i * box_bytes, &tv, 0, w.kvh, slot, rfull);
            }
            ++it;
          }
        }
      }
    } else {  // warps 9-11: each landed raw stage into the next bf16 stage
      const int ct = threadIdx.x - 9 * 32;
      const int box_shift = __ffs(rows) - 1;
      int it = 0;  // position in both rings (they advance together)
      for (int t = blockIdx.x; t < n_work; t += gridDim.x) {
        const FqWork w = fq_work<MODE>(a, t, B);
        const int* btr = fq_table<MODE>(a, w);
        for (int kt = 0; kt < w.n_kv; ++kt) {
          const uint32_t holes = fq_tile_holes(a, btr, kt);
          if (holes == all_holes) continue;
          const int rs = it % kRS, cs = it % kST;
          mbar_wait(rfull0 + 8 * rs, (it / kRS) & 1);
          if (it >= kST) mbar_wait(empty0 + 8 * cs, ((it / kST) - 1) & 1);
          fq_convert<D, S>(sk0 + 2 * cs * kTile, raw0 + 2 * rs * kRaw, holes, box_shift, ct);
          // the generic-proxy stores, visible to wgmma's reads (async proxy)
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncwarp();
          if (lane == 0) {
            mbar_arrive(rempty0 + 8 * rs);
            mbar_arrive(full0 + 8 * cs);
          }
          ++it;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    fq_consume<D, MODE, kST>(a, B, sq, sk0, qfull, qempty, full0, empty0, warp, lane);
  }
}

// A 4-D bf16 tensor map over a strided (B, S, heads, D)-like view: dims
// (D, heads, S, B) with element strides (1, sh, ss, sb), boxes of 64
// columns x 1 head x 128 rows x 1 batch row, 128-byte swizzle.
bool fq_tensor_map(CUtensorMap* out, const void* ptr, int D, int heads, int S, int B,
                   long long sh, long long ss, long long sb) {
  const EncodeTiledFn encode = tma_encode_fn();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, 128, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// A 3-D tensor map over a paged pool layer (total_slots, KV, D): dims (D,
// KV, total_slots), boxes of 1 head x `rows` slots. A bf16 pool (elem 2):
// 64-column boxes, 128-byte swizzle, as the consumers read them. A one-byte
// pool (elem 1): whole D-byte rows, no swizzle (the converters read them
// and write the swizzled bf16 stage). Cached by (pointer, shape, box,
// element), as gemm_kernel.cuh caches its maps: a pool layer's address
// does not change between calls.
struct FqPoolMapEntry {
  const void* ptr;
  int D, KV, slots, rows, elem;
  CUtensorMap map;
};

bool fq_pool_map(CUtensorMap* out, const void* ptr, int D, int KV, int slots, int rows,
                 int elem = 2) {
  constexpr int kSlots = 256;
  static FqPoolMapEntry cache[kSlots];
  static std::mutex mu;
  const size_t h = (reinterpret_cast<uintptr_t>(ptr) >> 4) * 0x9E3779B97F4A7C15ull ^
                   (size_t)slots * 31 ^ (size_t)KV * 131 ^ (size_t)D * 7 ^ (size_t)rows ^
                   (size_t)elem * 8191;
  FqPoolMapEntry& e = cache[(h >> 7) % kSlots];
  std::lock_guard<std::mutex> lock(mu);
  if (e.ptr == ptr && e.D == D && e.KV == KV && e.slots == slots && e.rows == rows &&
      e.elem == elem) {
    *out = e.map;
    return true;
  }
  const EncodeTiledFn encode = tma_encode_fn();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)KV, (cuuint64_t)slots};
  const cuuint64_t strides[2] = {(cuuint64_t)D * elem, (cuuint64_t)KV * D * elem};
  const cuuint32_t box[3] = {elem == 2 ? 64u : (cuuint32_t)D, 1, (cuuint32_t)rows};
  const cuuint32_t es[3] = {1, 1, 1};
  CUtensorMap m;
  if (encode(&m, elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
             const_cast<void*>(ptr), dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
             elem == 2 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
      CUDA_SUCCESS)
    return false;
  e.ptr = ptr; e.D = D; e.KV = KV; e.slots = slots; e.rows = rows; e.elem = elem; e.map = m;
  *out = m;
  return true;
}

// The number of SMs: the persistent grid's size
inline int fq_sm_count() {
  static const int n_sm = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return n_sm;
}

// Launch a body over its maps: persistent, one block per SM (at most one
// per work item) walks the work in a static order. Each kernel is opted
// into its dynamic shared memory once per instantiation.
template <auto kernel>
cudaError_t fq_launch(size_t smem, long long n_work, const PrefillArgs& a, int B,
                      const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                      cudaStream_t stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const int grid = (int)max(1ll, min(n_work, (long long)max(fq_sm_count(), 1)));
  kernel<<<grid, 384, smem, stream>>>(tq, tk, tv, a, B);
  return cudaGetLastError();
}

// TMA: 16-byte aligned bases, strides in whole 16-byte units (element
// strides of `elem` bytes)
inline bool fq_tma_ok(std::initializer_list<const void*> ptrs,
                      std::initializer_list<long long> strides, int elem = 2) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (long long st : strides)
    if ((st * elem) % 16) return false;
  return true;
}

// The contiguous mode: maps over the strided Q, K and V views, per call.
template <int D>
cudaError_t launch_wgmma(const PrefillArgs& a, int B, cudaStream_t stream) {
  if (!fq_tma_ok({a.q, a.k, a.v}, {a.qsb, a.qsh, a.qss, a.ksb, a.ksh, a.kss, a.vsb, a.vsh, a.vss}))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!fq_tensor_map(&tq, a.q, D, a.H, a.Sq, B, a.qsh, a.qss, a.qsb) ||
      !fq_tensor_map(&tk, a.k, D, a.KV, a.Sk, B, a.ksh, a.kss, a.ksb) ||
      !fq_tensor_map(&tv, a.v, D, a.KV, a.Sk, B, a.vsh, a.vss, a.vsb))
    return cudaErrorInvalidValue;
  return fq_launch<prefill_wgmma_kernel<D, KV_CONTIG>>(fq_smem<D>(),
                   (long long)B * a.H * ((a.Sq + kFqBQ - 1) / kFqBQ), a, B, tq, tk, tv, stream);
}

// The block sizes the paged and ragged tile walk takes: 128-row kv tiles of
// whole boxes of min(bs, 128) rows, at most 16 boxes (bf16: each box at
// least one 1 KB swizzle atom, 8 rows of 128 bytes)
inline bool fq_block_ok(int bs) {
  return (bs >= 8 && bs <= 64 && (bs & (bs - 1)) == 0) || bs % kFqBK == 0;
}

// The paged mode: Q's map per call, the pool layer's maps from the cache.
template <int D>
cudaError_t launch_wgmma_paged(const PrefillArgs& a, int B, int total_slots,
                               cudaStream_t stream) {
  if (!fq_block_ok(a.bs) || !fq_tma_ok({a.q, a.k, a.v}, {a.qsb, a.qsh, a.qss}))
    return cudaErrorInvalidValue;
  const int rows = min(a.bs, kFqBK);
  CUtensorMap tq, tk, tv;
  if (!fq_tensor_map(&tq, a.q, D, a.H, a.Sq, B, a.qsh, a.qss, a.qsb) ||
      !fq_pool_map(&tk, a.k, D, a.KV, total_slots, rows) ||
      !fq_pool_map(&tv, a.v, D, a.KV, total_slots, rows))
    return cudaErrorInvalidValue;
  return fq_launch<prefill_wgmma_kernel<D, KV_PAGED>>(fq_smem<D>(),
                   (long long)B * a.H * ((a.Sq + kFqBQ - 1) / kFqBQ), a, B, tq, tk, tv, stream);
}

// The one-byte body over a pool of store S, paged (B rows of Sq queries) or
// ragged (the plan's wgmma items: `n_items` is the launch's count, from the
// host plan or the bucket's capacity; the kernel reads the real one from
// the plan's header). Q's map per call (over the stream's buffer for the
// ragged mode: dims D, H, T, 1), the pool's raw maps from the cache. Any
// failure (a block size the walk does not take, TMA's alignment, a map
// cuTensorMapEncodeTiled refuses) is an error: the wrapper raises.
template <int D, int MODE, typename S>
cudaError_t launch_wgmma_1b(const PrefillArgs& a, int B, int n_items, int total_slots,
                            cudaStream_t stream) {
  static_assert(MODE == KV_PAGED || MODE == KV_RAGGED, "paged or ragged");
  if (!fq_block_ok(a.bs) || !fq_tma_ok({a.q}, {a.qsb, a.qsh, a.qss}) ||
      !fq_tma_ok({a.k, a.v}, {(long long)D, (long long)a.KV * D}, 1))
    return cudaErrorInvalidValue;
  const int rows = min(a.bs, kFqBK);
  CUtensorMap tq, tk, tv;
  if (!fq_tensor_map(&tq, a.q, D, a.H, a.Sq, B, a.qsh, a.qss, a.qsb) ||
      !fq_pool_map(&tk, a.k, D, a.KV, total_slots, rows, 1) ||
      !fq_pool_map(&tv, a.v, D, a.KV, total_slots, rows, 1))
    return cudaErrorInvalidValue;
  const long long n_work = MODE == KV_RAGGED
                               ? (long long)n_items * a.H
                               : (long long)B * a.H * ((a.Sq + kFqBQ - 1) / kFqBQ);
  return fq_launch<prefill_wgmma_1b_kernel<D, MODE, S>>(fq_1b_smem<D>(), n_work, a, B, tq, tk,
                                                         tv, stream);
}

// bf16 q over a one-byte pool (kv_dtype) at head dim 64 or 128 on the
// one-byte body
template <int MODE>
int run_wgmma_1b(int kv_dtype, const PrefillArgs& a, int B, int n_items, int total_slots,
                 void* stream) {
  if (a.D != 64 && a.D != 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_one_byte_store(kv_dtype, [&](auto tag) -> int {
    using S = decltype(tag);
    return (int)(a.D == 64 ? launch_wgmma_1b<64, MODE, S>(a, B, n_items, total_slots, s)
                           : launch_wgmma_1b<128, MODE, S>(a, B, n_items, total_slots, s));
  });
}

}  // namespace
