// One max-log-MAP half-iteration of one LTE turbo constituent decoder, for
// a batch of (code block x window) columns: the Hopper kernel of the port.
//
// Replaces the TPU kernel srslte_emane_tpu/ops/fec/turbodecoder_pallas2.py
// `_map_kernel` (launched by `map_window_tiles`) and computes the same
// function: a HALO-step warm-up from uniform metrics, the exact alpha_0 /
// tail-derived beta_K injected on the first / last window and then
// max-normalised, a backward pass storing beta at node t+1, a forward pass
// with the posterior m0 - m1 fused in, branch metrics [a, b, -b, -a] built
// on the fly from pre-halved inputs, radix-2 steps.  In narrow mode the
// inputs and the beta scratch are bf16 (recursions stay f32 in registers)
// and beta is renormalised after every radix-2 pair.  LOGMAP adds the
// half-scale max* correction in the recursions.
//
// Layout: one thread per column; the 8 alpha/beta states live in
// registers.  Inputs are time-major (L + 2H, n_cols) and the beta scratch
// is [t][state][column], so the threads of a warp touch neighbouring
// addresses on every step.  The wrapper (ops/fec/turbodecoder_cuda.py)
// builds the time-major inputs, allocates output and scratch, and launches
// on PyTorch's current stream.
//
// What bounds it on an H100: every column is a sequential chain of
// 2(L + H) dependent trellis steps, so the kernel is bound by instruction
// latency at low occupancy (24,576 columns = 768 warps at the 20 MHz bench
// shape, under 6 warps per SM), and by the beta scratch traffic: at K=5504
// the bf16 scratch is 68 MB, more than the 50 MB L2, written once and read
// once per half-iteration.  What this design does about it: states in
// registers (no shared memory, no synchronisation), small blocks (64
// threads) so the few warps spread over all 132 SMs, coalesced scratch and
// input accesses, bf16 scratch in narrow mode.  Keeping beta on chip
// (shorter windows, or several threads per column) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kBlock = 64;

// 8-state RSC trellis, state s = r0*4 + r1*2 + r2 (turbodecoder._trellis).
__host__ __device__ constexpr int next_state(int s, int u) {
  return ((u ^ ((s >> 1) & 1) ^ (s & 1)) << 2) | (((s >> 2) & 1) << 1) | ((s >> 1) & 1);
}
__host__ __device__ constexpr int parity(int s, int u) {
  return u ^ ((s >> 2) & 1) ^ ((s >> 1) & 1);
}
// branch-metric combo of the transition (s, u): u*2 + z
__host__ __device__ constexpr int combo(int s, int u) { return u * 2 + parity(s, u); }
// the two predecessors (k = 0, 1) of state sp and their inputs
__host__ __device__ constexpr int prev_state(int sp, int k) {
  return (((sp >> 1) & 1) << 2) | ((sp & 1) << 1) | k;
}
__host__ __device__ constexpr int prev_u(int sp, int k) { return (sp >> 2) ^ (sp & 1) ^ k; }

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <bool LOGMAP>
__device__ __forceinline__ float max_star(float a, float b) {
  float m = fmaxf(a, b);
  if (LOGMAP) m += 0.5f * log1pf(expf(-2.0f * fabsf(a - b)));
  return m;
}

template <typename T>
__device__ __forceinline__ void branch(const T* ls, const T* lp, size_t i, float (&g)[4]) {
  const float x = load(ls + i), y = load(lp + i);
  g[0] = x + y;
  g[1] = x - y;
  g[2] = -g[1];
  g[3] = -g[0];
}

template <bool LOGMAP>
__device__ __forceinline__ void bwd_step(float (&beta)[8], const float (&g)[4]) {
  float nb[8];
#pragma unroll
  for (int s = 0; s < 8; ++s)
    nb[s] = max_star<LOGMAP>(beta[next_state(s, 0)] + g[combo(s, 0)],
                             beta[next_state(s, 1)] + g[combo(s, 1)]);
#pragma unroll
  for (int s = 0; s < 8; ++s) beta[s] = nb[s];
}

template <bool LOGMAP>
__device__ __forceinline__ void fwd_step(float (&alpha)[8], const float (&g)[4]) {
  float na[8];
#pragma unroll
  for (int s = 0; s < 8; ++s)
    na[s] = max_star<LOGMAP>(alpha[prev_state(s, 0)] + g[combo(prev_state(s, 0), prev_u(s, 0))],
                             alpha[prev_state(s, 1)] + g[combo(prev_state(s, 1), prev_u(s, 1))]);
#pragma unroll
  for (int s = 0; s < 8; ++s) alpha[s] = na[s];
}

__device__ __forceinline__ void normalise(float (&x)[8]) {
  float m = x[0];
#pragma unroll
  for (int s = 1; s < 8; ++s) m = fmaxf(m, x[s]);
#pragma unroll
  for (int s = 0; s < 8; ++s) x[s] -= m;
}

// ls, lp: (L + 2H, n_cols) pre-halved LLRs, time-major, zero outside [0, K);
// beta_tail: (n_cols / W, 8); llr: (L, n_cols); scratch: (L, 8, n_cols).
template <typename T, bool LOGMAP>
__global__ void __launch_bounds__(kBlock)
map_kernel(const T* __restrict__ ls, const T* __restrict__ lp,
           const float* __restrict__ beta_tail, float* __restrict__ llr,
           T* __restrict__ scratch, int n_cols, int W, int L, int H) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_cols) return;
  const size_t n = n_cols;
  const int w = c % W;
  float g[4];

  // ---- backward: halo warm-up from uniform over [H+L, 2H+L) ----
  float beta[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < H; ++i) {
    branch(ls, lp, (size_t)(2 * H + L - 1 - i) * n + c, g);
    bwd_step<LOGMAP>(beta, g);
  }
  if (w == W - 1) {
#pragma unroll
    for (int s = 0; s < 8; ++s) beta[s] = beta_tail[(size_t)(c / W) * 8 + s];
  }
  normalise(beta);

  // ---- backward over the window, storing beta at node tt+1, radix-2 ----
  for (int i = 0; i < L / 2; ++i) {
    const int tt = L - 1 - 2 * i;
#pragma unroll
    for (int s = 0; s < 8; ++s) store(scratch + ((size_t)tt * 8 + s) * n + c, beta[s]);
    branch(ls, lp, (size_t)(H + tt) * n + c, g);
    bwd_step<LOGMAP>(beta, g);
#pragma unroll
    for (int s = 0; s < 8; ++s) store(scratch + ((size_t)(tt - 1) * 8 + s) * n + c, beta[s]);
    branch(ls, lp, (size_t)(H + tt - 1) * n + c, g);
    bwd_step<LOGMAP>(beta, g);
    // bf16 scratch: keep stored magnitudes inside bf16's resolution (the
    // common offset cancels in m0 - m1)
    if (sizeof(T) == 2) normalise(beta);
  }

  // ---- forward: halo warm-up over [0, H) ----
  float alpha[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < H; ++i) {
    branch(ls, lp, (size_t)i * n + c, g);
    fwd_step<LOGMAP>(alpha, g);
  }
  if (w == 0) {
    alpha[0] = 0.f;
#pragma unroll
    for (int s = 1; s < 8; ++s) alpha[s] = kNeg;
  }
  normalise(alpha);

  // ---- forward with the posterior combine fused in ----
  for (int tt = 0; tt < L; ++tt) {
    branch(ls, lp, (size_t)(H + tt) * n + c, g);
    float tsu[8][2], bn[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      tsu[s][0] = alpha[s] + g[combo(s, 0)];
      tsu[s][1] = alpha[s] + g[combo(s, 1)];
      bn[s] = load(scratch + ((size_t)tt * 8 + s) * n + c);
    }
    float m0 = tsu[0][0] + bn[next_state(0, 0)];
    float m1 = tsu[0][1] + bn[next_state(0, 1)];
#pragma unroll
    for (int s = 1; s < 8; ++s) {
      m0 = fmaxf(m0, tsu[s][0] + bn[next_state(s, 0)]);
      m1 = fmaxf(m1, tsu[s][1] + bn[next_state(s, 1)]);
    }
    llr[(size_t)tt * n + c] = m0 - m1;
#pragma unroll
    for (int s = 0; s < 8; ++s)
      alpha[s] = max_star<LOGMAP>(tsu[prev_state(s, 0)][prev_u(s, 0)],
                                  tsu[prev_state(s, 1)][prev_u(s, 1)]);
  }
}

template <typename T>
cudaError_t launch(const void* ls, const void* lp, const float* beta_tail, float* llr,
                   void* scratch, int n_cols, int W, int L, int H, int logmap,
                   cudaStream_t stream) {
  const dim3 grid((n_cols + kBlock - 1) / kBlock), block(kBlock);
  if (logmap)
    map_kernel<T, true><<<grid, block, 0, stream>>>(
        static_cast<const T*>(ls), static_cast<const T*>(lp), beta_tail, llr,
        static_cast<T*>(scratch), n_cols, W, L, H);
  else
    map_kernel<T, false><<<grid, block, 0, stream>>>(
        static_cast<const T*>(ls), static_cast<const T*>(lp), beta_tail, llr,
        static_cast<T*>(scratch), n_cols, W, L, H);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  narrow: inputs and scratch are
// bf16 (else float32).  Returns the cudaError_t of the launch.
extern "C" int turbo_map_launch(const void* ls, const void* lp, const void* beta_tail,
                                void* llr, void* scratch, int n_cols, int W, int L,
                                int H, int narrow, int logmap, void* stream) {
  if (n_cols <= 0 || W <= 0 || L <= 0 || L % 2 || H < 0 || n_cols % W)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* bt = static_cast<const float*>(beta_tail);
  auto* out = static_cast<float*>(llr);
  const cudaError_t err =
      narrow ? launch<__nv_bfloat16>(ls, lp, bt, out, scratch, n_cols, W, L, H, logmap, st)
             : launch<float>(ls, lp, bt, out, scratch, n_cols, W, L, H, logmap, st);
  return static_cast<int>(err);
}
