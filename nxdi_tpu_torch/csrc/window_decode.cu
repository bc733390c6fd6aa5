// Decode over a window that already holds this step's row (the kWindow mode
// of decode_kernel.cuh).
//
// Replaces nxdi_tpu/ops/kernels/flash_attention.py::flash_attention_decode;
// see decode_kernel.cuh.
#include "decode_kernel.cuh"

// `chunk_len`, `n_chunks`, `ws`: the kv split, and `ring`, as in flash_decode.cu.
extern "C" int nxdi_flash_decode_window(int dtype, const void* q, const void* k, const void* v,
                                        void* out, const int* q_pos, const int* kv_start, int B,
                                        int H, int KV, int D, int Sk, long long qsb,
                                        long long qsh, long long csb, long long csh,
                                        long long css, long long osb, long long osh, float scale,
                                        int window, int chunk, int ring, int chunk_len,
                                        int n_chunks, float* ws, void* stream) {
  DecodeArgs a{};
  a.q = q; a.kc = k; a.vc = v; a.out = out; a.ws = ws; a.q_pos = q_pos; a.kv_start = kv_start;
  a.B = B; a.H = H; a.KV = KV; a.D = D; a.kv_len = Sk;
  a.chunk_len = chunk_len; a.n_chunks = n_chunks;
  a.qsb = qsb; a.qsh = qsh; a.csb = csb; a.csh = csh; a.css = css; a.osb = osb; a.osh = osh;
  a.scale = scale; a.v_scale = 1.f; a.window = window; a.chunk = chunk; a.ring = ring;
  return dispatch<Mode::kWindow>(dtype, a, stream);
}
