// In-place commit of fresh K/V rows into the layer-stacked KV cache.
//
// Replaces nxdi_tpu/ops/kernels/kv_commit.py::kv_commit_rows. Same function:
// row t of batch line b lands at slot slots[b, t] of cache line lines[b] (or b
// when no routing is given) in every layer; a slot outside [0, S) or a line
// outside [0, B_cache) drops the row. The TPU kernel's 128-slot
// read-modify-write window (and its collision contract) is a TPU mechanism:
// here each row is written directly, so T > 1 is allowed.
//
// Design: one block per (layer, batch line); the block copies the line's
// KV*T rows of K and of V with 16-byte stores. The kernel only moves bytes,
// so it is dtype-agnostic: the wrapper passes row sizes in bytes.
//
// Bound: 2*L*B*KV*T*D elements read and written (262 KB per decode step at
// the Llama-3.2-1B slice shape) — well under a microsecond of bandwidth, so
// the launch itself is the cost. empty_launch_kernel measures that floor: a
// kernel that does nothing, launched at the commit's shape (L * B blocks of
// 128 threads). Inside the step's CUDA graph the launch costs no host time.

#include "common.cuh"

namespace {

__global__ void kv_commit_kernel(char* kc, char* vc, const char* kr, const char* vr,
                                 const int* slots, const int* lines, int B, int Bc, int KV,
                                 int S, int T, long long krow, long long vrow) {
  const int l = blockIdx.x / B, b = blockIdx.x % B;
  const int line = lines ? lines[b] : b;
  if (line < 0 || line >= Bc) return;
  for (int t = 0; t < T; ++t) {
    const int slot = slots[b * T + t];
    if (slot < 0 || slot >= S) continue;
    for (int side = 0; side < 2; ++side) {
      const long long row = side ? vrow : krow;
      char* cache = side ? vc : kc;
      const char* rows = side ? vr : kr;
      const long long chunks = row / 16;
      for (long long i = threadIdx.x; i < KV * chunks; i += blockDim.x) {
        const int h = (int)(i / chunks);
        const long long c = i % chunks;
        const long long dst = ((((long long)l * Bc + line) * KV + h) * S + slot) * row;
        const long long src = ((((long long)l * B + b) * KV + h) * T + t) * row;
        reinterpret_cast<uint4*>(cache + dst)[c] = reinterpret_cast<const uint4*>(rows + src)[c];
      }
    }
  }
}

__global__ void empty_launch_kernel() {}

}  // namespace

// An empty kernel of `blocks` x `threads`: the device time of a launch alone.
extern "C" int nxdi_empty_launch(int blocks, int threads, void* stream) {
  empty_launch_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

extern "C" int nxdi_kv_commit_rows(void* kc, void* vc, const void* kr, const void* vr,
                                   const int* slots, const int* lines, int L, int B, int Bc,
                                   int KV, int S, int T, long long krow_bytes,
                                   long long vrow_bytes, void* stream) {
  if (krow_bytes % 16 != 0 || vrow_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
  if (L == 0 || B == 0 || T == 0) return (int)cudaSuccess;
  kv_commit_kernel<<<L * B, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(kc), static_cast<char*>(vc), static_cast<const char*>(kr),
      static_cast<const char*>(vr), slots, lines, B, Bc, KV, S, T, krow_bytes, vrow_bytes);
  return (int)cudaGetLastError();
}
