// Shared helpers for the nxdi_tpu_torch CUDA kernels (sm_90a).
//
// Every entry point has a plain C interface (loaded with ctypes), launches on
// the stream it is given, allocates nothing, and returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define NXDI_NEG_INF (-30000.0f)

// dtype codes shared with the Python wrappers (ops/kernels/_build.py). The
// one-byte codes are KV stores only: q, the outputs and the fresh rows are
// f32 or bf16.
enum NxdiDtype : int {
  NXDI_F32 = 0,
  NXDI_BF16 = 1,
  NXDI_E4M3 = 2,  // torch.float8_e4m3fn
  NXDI_E5M2 = 3,  // torch.float8_e5m2
  NXDI_I8 = 4,    // torch.int8
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
// the one-byte stores: every value is exact in f32 and in bf16, so a
// converted tile carries no rounding beyond the store's own
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e5m2 x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename S>
constexpr bool kOneByte = sizeof(S) == 1;

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round a float through the storage type (bf16 rounds, f32 is exact).
template <typename T>
__device__ __forceinline__ float round_through(float x) {
  return to_f32(from_f32<T>(x));
}

// Load 4 consecutive elements as floats (address aligned to 4 elements).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  float2 a = __bfloat1622float2(q[0]);
  float2 b = __bfloat1622float2(q[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// 4 consecutive one-byte store elements (4-byte aligned) as floats
template <typename S, typename std::enable_if<sizeof(S) == 1, int>::type = 0>
__device__ __forceinline__ float4 load4(const S* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  const S* e = reinterpret_cast<const S*>(&u);
  return make_float4(to_f32(e[0]), to_f32(e[1]), to_f32(e[2]), to_f32(e[3]));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Python-style floor division (positions are non-negative on every path, but
// the chunk mask must agree with the reference's // for any input).
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// The position mask shared by prefill and decode: causal (inclusive or
// strict), optional sliding window, optional chunk. window/chunk <= 0 = off.
__device__ __forceinline__ bool pos_visible(int kv_pos, int q_pos, bool strict, int window,
                                            int chunk) {
  bool m = strict ? (kv_pos < q_pos) : (kv_pos <= q_pos);
  if (window > 0) m = m && (kv_pos > q_pos - window);
  if (chunk > 0) m = m && (floordiv(kv_pos, chunk) == floordiv(q_pos, chunk));
  return m;
}

// Tensor-core helpers shared by the mma.sync bodies (prefill_kernel.cuh's
// prefill_tc_kernel, decode_kernel.cuh's bf16 split kernel).

// C (16 x 8, f32) += A (16 x 16, bf16, row) * B (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// N one-byte store elements (the bytes of `u`) written to shared memory as
// N elements of the compute type T (f32 or bf16): the conversion of a
// one-byte K/V tile as it lands. dst is 16-byte aligned.
template <typename T, typename S, int N, typename U>
__device__ __forceinline__ void store_converted(T* dst, const U& u) {
  static_assert(sizeof(U) == N, "N bytes in, N elements out");
  const S* e = reinterpret_cast<const S*>(&u);
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<float4*>(dst)[i] =
          make_float4(to_f32(e[4 * i]), to_f32(e[4 * i + 1]), to_f32(e[4 * i + 2]),
                      to_f32(e[4 * i + 3]));
  } else {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      uint4 o;
      o.x = pack_bf16(to_f32(e[8 * i]), to_f32(e[8 * i + 1]));
      o.y = pack_bf16(to_f32(e[8 * i + 2]), to_f32(e[8 * i + 3]));
      o.z = pack_bf16(to_f32(e[8 * i + 4]), to_f32(e[8 * i + 5]));
      o.w = pack_bf16(to_f32(e[8 * i + 6]), to_f32(e[8 * i + 7]));
      reinterpret_cast<uint4*>(dst)[i] = o;
    }
  }
}

// Two one-byte store elements (the low 16 bits of `u`, the first in the low
// byte) as a bf16x2 word, exactly: fp8 by cvt.rn.f16x2.e4m3x2 / .e5m2x2,
// then f16 -> f32 -> bf16; int8 through f32. Every store value is a bf16.
template <typename S>
__device__ __forceinline__ uint32_t one_byte_pair_bf16(uint32_t u) {
  if constexpr (std::is_same<S, int8_t>::value) {
    return pack_bf16(static_cast<float>(static_cast<int8_t>(u & 0xffu)),
                     static_cast<float>(static_cast<int8_t>((u >> 8) & 0xffu)));
  } else {
    constexpr __nv_fp8_interpretation_t kind =
        std::is_same<S, __nv_fp8_e4m3>::value ? __NV_E4M3 : __NV_E5M2;
    const __half2_raw h =
        __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(u & 0xffffu), kind);
    const float2 f = __half22float2(__half2(h));
    return pack_bf16(f.x, f.y);
  }
}

// 16 one-byte elements (a uint4) as 16 bf16 (lo: the first 8, hi: the rest)
template <typename S>
__device__ __forceinline__ void one_byte_16_bf16(const uint4& u, uint4& lo, uint4& hi) {
  lo.x = one_byte_pair_bf16<S>(u.x);
  lo.y = one_byte_pair_bf16<S>(u.x >> 16);
  lo.z = one_byte_pair_bf16<S>(u.y);
  lo.w = one_byte_pair_bf16<S>(u.y >> 16);
  hi.x = one_byte_pair_bf16<S>(u.z);
  hi.y = one_byte_pair_bf16<S>(u.z >> 16);
  hi.z = one_byte_pair_bf16<S>(u.w);
  hi.w = one_byte_pair_bf16<S>(u.w >> 16);
}

// Call f(S{}) with S the C++ type of a one-byte store code (a generic
// lambda reads it as decltype of its argument); cudaErrorInvalidValue for
// any other code.
template <typename F>
int with_one_byte_store(int kv_dtype, F&& f) {
  switch (kv_dtype) {
    case NXDI_E4M3: return f(__nv_fp8_e4m3{});
    case NXDI_E5M2: return f(__nv_fp8_e5m2{});
    case NXDI_I8: return f(int8_t{});
    default: return (int)cudaErrorInvalidValue;
  }
}
