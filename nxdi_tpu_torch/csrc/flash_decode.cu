// Deferred-write decode attention (the kFused mode of decode_kernel.cuh).
//
// Replaces nxdi_tpu/ops/kernels/flash_attention.py::flash_attention_decode_fused
// and ::flash_attention_decode_fused_stacked; see decode_kernel.cuh.
#include "decode_kernel.cuh"

// `lines` (may be null): row b reads cache line lines[b] of the n_lines the
// cache holds (contiguous continuous batching; the JAX package gathers the
// lines first). `chunk_len`, `n_chunks`: the kv split
// (flash_attention.py::decode_chunk); `ws`: B x H x n_chunks x (D + 2) floats
// of scratch, null when n_chunks is 1. `ring` > 0: the cache is a ring of
// that many slots (kv_start null; see decode_kernel.cuh).
extern "C" int nxdi_flash_decode_fused(int dtype, const void* q, const void* kc, const void* vc,
                                       const void* kn, const void* vn, void* out,
                                       const int* q_pos, const int* kv_start,
                                       const int* lines, int n_lines, int B, int H,
                                       int KV, int D, int kv_len, long long qsb, long long qsh,
                                       long long csb, long long csh, long long css,
                                       long long nsb, long long nsh, long long osb,
                                       long long osh, float scale, int window, int chunk,
                                       int ring, int chunk_len, int n_chunks, float* ws,
                                       void* stream) {
  DecodeArgs a{};
  a.q = q; a.kc = kc; a.vc = vc; a.kn = kn; a.vn = vn; a.out = out; a.ws = ws;
  a.q_pos = q_pos; a.kv_start = kv_start; a.lines = lines; a.n_lines = n_lines;
  a.B = B; a.H = H; a.KV = KV; a.D = D; a.kv_len = kv_len;
  a.chunk_len = chunk_len; a.n_chunks = n_chunks;
  a.qsb = qsb; a.qsh = qsh; a.csb = csb; a.csh = csh; a.css = css;
  a.nsb = nsb; a.nsh = nsh; a.osb = osb; a.osh = osh;
  a.scale = scale; a.v_scale = 1.f; a.window = window; a.chunk = chunk; a.ring = ring;
  return dispatch<Mode::kFused>(dtype, a, stream);
}
