// The device loop's window graph: W iterations of one decode step, each
// behind a CUDA graph IF node whose condition the card sets from the loop
// state (t < cap and some row not done).
//
// Counterpart of the lax.while_loop of nxdi_tpu/models/base.py
// ::device_loop_token_gen. A CUDA graph has no data-dependent trip count in
// this toolkit's PyTorch, so the window is built here with the CUDA graph API:
// the decode step is captured once by PyTorch into a graph (`body`), and the
// window is W copies of [loop_pred_kernel -> IF node{child graph: body}],
// then loop_tail_kernel, which writes the loop's `finished` flag and its
// iteration count to pinned host memory. A skipped IF body launches nothing.
// The host launches the window until it reads `finished` (one window late).
//
// The loop state (t, done) lives in device memory the body updates in place.

#include <cuda_runtime.h>

namespace {

__global__ void loop_pred_kernel(cudaGraphConditionalHandle handle, const int* t, int cap,
                                 const unsigned char* done, int B) {
  int live = 0;
  for (int b = threadIdx.x; b < B; b += blockDim.x) live |= !done[b];
  live = __syncthreads_or(live);
  if (threadIdx.x == 0) cudaGraphSetConditional(handle, (*t < cap && live) ? 1u : 0u);
}

__global__ void loop_tail_kernel(const int* t, int cap, const unsigned char* done, int B,
                                 volatile int* host_state) {
  int live = 0;
  for (int b = threadIdx.x; b < B; b += blockDim.x) live |= !done[b];
  live = __syncthreads_or(live);
  if (threadIdx.x == 0) {
    host_state[1] = *t;
    __threadfence_system();
    host_state[0] = (*t < cap && live) ? 0 : 1;
  }
}

}  // namespace

// Builds and instantiates the window graph; `*exec_out` receives the
// cudaGraphExec_t. `host_state` is pinned, device-visible host memory of two
// ints: [finished, t]. The body graph is copied (child graph nodes), so the
// caller may keep or drop it.
extern "C" int nxdi_loop_window_build(void* body, int W, const int* t, int cap,
                                      const unsigned char* done, int B, int* host_state,
                                      void** exec_out) {
  cudaGraph_t g;
  cudaError_t err = cudaGraphCreate(&g, 0);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNode_t prev = nullptr;
  for (int i = 0; i < W && err == cudaSuccess; ++i) {
    cudaGraphConditionalHandle h;
    err = cudaGraphConditionalHandleCreate(&h, g, 0, cudaGraphCondAssignDefault);
    if (err != cudaSuccess) break;
    void* pargs[] = {&h, (void*)&t, &cap, (void*)&done, &B};
    cudaKernelNodeParams kp = {};
    kp.func = (void*)loop_pred_kernel;
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(128);
    kp.kernelParams = pargs;
    cudaGraphNode_t pn;
    err = cudaGraphAddKernelNode(&pn, g, prev ? &prev : nullptr, prev ? 1 : 0, &kp);
    if (err != cudaSuccess) break;
    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = h;
    cp.conditional.type = cudaGraphCondTypeIf;
    cp.conditional.size = 1;
    cudaGraphNode_t cn;
    err = cudaGraphAddNode(&cn, g, &pn, 1, &cp);
    if (err != cudaSuccess) break;
    cudaGraphNode_t child;
    err = cudaGraphAddChildGraphNode(&child, cp.conditional.phGraph_out[0], nullptr, 0,
                                     static_cast<cudaGraph_t>(body));
    prev = cn;
  }
  if (err == cudaSuccess) {
    void* targs[] = {(void*)&t, &cap, (void*)&done, &B, &host_state};
    cudaKernelNodeParams kp = {};
    kp.func = (void*)loop_tail_kernel;
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(128);
    kp.kernelParams = targs;
    cudaGraphNode_t tn;
    err = cudaGraphAddKernelNode(&tn, g, prev ? &prev : nullptr, prev ? 1 : 0, &kp);
  }
  cudaGraphExec_t exec = nullptr;
  if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, g, 0);
  cudaGraphDestroy(g);
  if (err != cudaSuccess) return (int)err;
  *exec_out = exec;
  return (int)cudaSuccess;
}

extern "C" int nxdi_loop_window_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                              static_cast<cudaStream_t>(stream));
}

extern "C" int nxdi_loop_window_destroy(void* exec) {
  return (int)cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
}
