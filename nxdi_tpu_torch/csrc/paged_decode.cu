// Decode through the block table of the paged pool (the kPaged mode of
// decode_kernel.cuh).
//
// Replaces nxdi_tpu/ops/kernels/flash_attention.py::paged_attention_decode;
// see decode_kernel.cuh.
#include "decode_kernel.cuh"

// The one-byte stores' instantiations, in their own source so that nvcc
// compiles them beside this one (paged_decode_1b.cu).
int paged_decode_one_byte(int dtype, int kv_dtype, const DecodeArgs& a, void* stream);

// `kv_dtype`: the pool's store: q's dtype or a one-byte store code.
// `chunk_len`, `n_chunks`, `ws`: the kv split over the table's NB * bs
// positions, as in flash_decode.cu.
extern "C" int nxdi_paged_decode(int dtype, int kv_dtype, const void* q, const void* kc,
                                 const void* vc, void* out, const int* q_pos, const int* bt, int B,
                                 int H, int KV, int D, int NB, int bs, long long qsb, long long qsh,
                                 long long osb, long long osh, float scale, float v_scale,
                                 int chunk_len, int n_chunks, float* ws, void* stream) {
  if (bs <= 0) return (int)cudaErrorInvalidValue;
  DecodeArgs a{};
  a.q = q; a.kc = kc; a.vc = vc; a.out = out; a.ws = ws; a.q_pos = q_pos; a.bt = bt;
  a.B = B; a.H = H; a.KV = KV; a.D = D; a.kv_len = NB * bs; a.nb = NB; a.bs = bs;
  a.chunk_len = chunk_len; a.n_chunks = n_chunks;
  // pool (total_slots, KV, D): a head's rows sit KV * D elements apart
  a.qsb = qsb; a.qsh = qsh; a.csb = 0; a.csh = D; a.css = (long long)KV * D;
  a.osb = osb; a.osh = osh;
  a.scale = scale; a.v_scale = v_scale;
  return kv_dtype == dtype ? dispatch<Mode::kPaged>(dtype, a, stream)
                           : paged_decode_one_byte(dtype, kv_dtype, a, stream);
}
