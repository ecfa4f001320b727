// One max-log-MAP half-iteration of one LTE turbo constituent decoder over
// (code block x window) columns, from precomputed branch metrics and
// window-edge states: the port's second MAP kernel, the one the decoder
// takes when the window length L is odd (turbo_map.cu steps two trellis
// stages at a time and needs an even L).
//
// Replaces the TPU kernel srslte_emane_tpu/ops/fec/turbodecoder_pallas.py
// `_map_kernel` (v1, launched by `map_window_tiles`) and computes the same
// function: the wrapper (ops/fec/turbodecoder_cuda.py, `map_decode_v1_cuda`)
// supplies the branch metrics of the four combos u*2 + z, the alpha at node
// 0 and the beta at node L of every window (halo pre-scans from uniform
// metrics, the exact alpha_0 and the tail-derived beta_K, all in torch, as
// the reference runs them in XLA outside its kernel).  The kernel runs a
// backward pass that stores beta at node t+1 in scratch, then a forward pass
// with the posterior m0 - m1 fused in; both passes subtract the max over the
// 8 states at every step.  Everything is float32.  LOGMAP adds the
// half-scale max* correction in the recursions.
//
// Layout: one thread per column, the 8 alpha/beta states in registers, any
// L >= 1.  Branch metrics are time-major (L, 4, n_cols), the window-edge
// states (8, n_cols), the beta scratch [t][state][column]: the threads of a
// warp touch neighbouring addresses at every step.
//
// What bounds it on an H100: each column is a chain of 2L dependent steps
// (latency at low occupancy, as for turbo_map.cu), and the bytes: per step
// 16 B of branch metrics read twice, 32 B of beta written and read back,
// 4 B of output, so 100 B per column step against turbo_map.cu's ~40 in
// f32.  The design keeps states in registers and every access coalesced;
// it takes no shared memory and no synchronisation.  It is the rare path
// (no LTE code-block size gives an odd L with the decoder's window choice),
// so it is kept simple.

#include <cuda_runtime.h>

#include "trellis.cuh"

namespace {

using namespace trellis;

constexpr int kBlock = 64;

__device__ __forceinline__ void load_g(const float* g, int t, size_t n, int c, float (&gg)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) gg[j] = g[((size_t)t * 4 + j) * n + c];
}

// g: (L, 4, n_cols); a0, b0: (8, n_cols); llr: (L, n_cols); scratch: (L, 8, n_cols).
template <bool LOGMAP>
__global__ void __launch_bounds__(kBlock)
map_v1_kernel(const float* __restrict__ g, const float* __restrict__ a0,
              const float* __restrict__ b0, float* __restrict__ llr,
              float* __restrict__ scratch, int n_cols, int L) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_cols) return;
  const size_t n = n_cols;
  float gg[4];

  // ---- backward: scratch[t] = beta at node t+1 ----
  float beta[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) beta[s] = b0[s * n + c];
  for (int t = L - 1; t >= 0; --t) {
#pragma unroll
    for (int s = 0; s < 8; ++s) scratch[((size_t)t * 8 + s) * n + c] = beta[s];
    load_g(g, t, n, c, gg);
    bwd_step<LOGMAP>(beta, gg);
    normalise(beta);
  }

  // ---- forward with the posterior combine fused in ----
  float alpha[8], bn[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) alpha[s] = a0[s * n + c];
  for (int t = 0; t < L; ++t) {
    load_g(g, t, n, c, gg);
#pragma unroll
    for (int s = 0; s < 8; ++s) bn[s] = scratch[((size_t)t * 8 + s) * n + c];
    llr[(size_t)t * n + c] = posterior(alpha, gg, bn);
    fwd_step<LOGMAP>(alpha, gg);
    normalise(alpha);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  All buffers float32.  Returns
// the cudaError_t of the launch.
extern "C" int turbo_map_v1_launch(const void* g, const void* a0, const void* b0, void* llr,
                                   void* scratch, int n_cols, int L, int logmap, void* stream) {
  if (n_cols <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_cols + kBlock - 1) / kBlock), block(kBlock);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* gp = static_cast<const float*>(g);
  const auto* ap = static_cast<const float*>(a0);
  const auto* bp = static_cast<const float*>(b0);
  auto* out = static_cast<float*>(llr);
  auto* sc = static_cast<float*>(scratch);
  if (logmap)
    map_v1_kernel<true><<<grid, block, 0, st>>>(gp, ap, bp, out, sc, n_cols, L);
  else
    map_v1_kernel<false><<<grid, block, 0, st>>>(gp, ap, bp, out, sc, n_cols, L);
  return static_cast<int>(cudaGetLastError());
}
