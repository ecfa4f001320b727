// One max-log-MAP half-iteration of one LTE turbo constituent decoder for a
// batch of code blocks, windowed: the Hopper kernel of the port's main path.
//
// Replaces the TPU kernel srslte_emane_tpu/ops/fec/turbodecoder_pallas2.py
// `_map_kernel` (launched by `map_window_tiles`) and computes the same
// function on the same windows (W per code block, length L, halo H): a
// H-step warm-up from uniform metrics, the exact alpha_0 / tail-derived
// beta_K on the first / last window, then max-normalised; a backward pass
// storing beta at node t+1, a forward pass with the posterior m0 - m1 fused
// in; branch metrics [a, b, -b, -a] from pre-halved inputs; radix-2 steps.
// Narrow mode rounds the halved inputs and the stored beta to bf16 (the
// recursions stay f32) and renormalises beta after every radix-2 pair.
// LOGMAP adds the half-scale max* correction in the recursions.
//
// What bounds it (H100 SXM, 3.35 TB/s, 33.5 T non-FMA f32 op/s): at 768 x
// K=5504 it must read ls and lp and write the LLRs, (B, K) f32 each, so
// 50.7 MB or 15 us; its ~17.6 k f32 add/max per (code block, window)
// column, 0.43 G in all, take ~13 us.  So it is memory-bound at ~15 us.
// In practice each column is a chain of 2(L + H) dependent trellis steps,
// and how many chains an SM holds (shared memory) and how fast one chain
// steps (instruction issue) set the time.
//
// What the design it replaces lost time to: one thread per column in
// blocks of 64 (under 6 warps per SM) loading every step's inputs from
// device memory, time-major inputs gathered outside the kernel, and a beta
// scratch of (L, 8, columns) in device memory (68 MB in bf16 at the shape
// above, more than the 50 MB L2, written and read back every launch).
//
// This design:
//  * windowing in the kernel: it reads ls, lp (B, K) f32 as they are.  A
//    thread block owns `cols` consecutive (code block, window) columns and
//    stages each column's window with its halos, [w*L - H, (w+1)*L + H) of
//    its code block, halved and rounded to the storage type, zero outside
//    [0, K), as (ls, lp) pairs in shared memory: a warp per column,
//    coalesced loads, once.  The trellis loops read only shared memory;
//  * one thread per column, the 8 states in registers: a step is 8
//    independent add/max pairs, no shuffles and no synchronisation after
//    staging (8 lanes per column exchanging states by shuffles measured
//    slower: the shuffles put their latency on every step, PERF.md §6);
//  * beta in shared memory, checkpointed: the backward pass keeps only the
//    f32 beta at the start of every kPairs radix-2 pairs.  The forward
//    pass takes the window segment by segment from row 0: it recomputes
//    the segment's 2 * kPairs rows from their checkpoint into a small
//    buffer (the same f32 steps from the same state, so the same bits) and
//    runs alpha and the posterior over them.  One more backward pass buys
//    a per-column footprint of ~1.6 KB instead of ~3.8 KB, so an SM holds
//    128 columns in whole warps instead of 60 in half-empty ones;
//  * layouts [row or segment][half][column] of 4-state vectors and an odd
//    stride per staged column, so a warp's shared accesses do not conflict;
//  * the posterior writes each LLR over the staged input of that step,
//    which it has read, and the block writes its (cols x L) LLRs,
//    contiguous in (B, K), coalesced at the end.
// The kernel equals its plain version bit for bit (ops/fec/
// turbodecoder_cuda.py `map_decode_ref`).
//
// For the decoder's loop on the device: with a non-null `run`, every block
// reads *run first and returns at once when it is 0, so the turbo decoder
// can enqueue a whole budget of half-iterations and let the CRC epilogue
// (csrc/turbo_iter.cu) stop them without the host; with a non-null `rows`,
// [n, r_0, ..., r_{n-1}], only the first n rows of the grid compute, row b
// reading and writing data row r_b (the compaction cascade's stage, its
// width and rows written by the epilogue).  Null pointers launch as before;
// neither changes what a computed column does.
//
// Budget (K=5504: L=172, H=40, 11 segments): per column 352 B of
// checkpoints, 256 B of segment rows and 1,012 B of staged pairs in bf16
// (512 B and 2,024 B in f32).  The default block of 128 threads takes 32
// columns in bf16 (51.8 KB; 19 in f32, 54.9 KB), four blocks per SM, one
// computing warp per scheduler; all four warps stage, each with the loads
// of kStageCols windows in flight at once.  ptxas -v: 124-126 registers
// (the staging loads; four blocks of 128 threads still fit the register
// file), no spills; the occupancy calculator gives 4 blocks per SM
// (NVIDIA H100 80GB HBM3, 700 W).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "trellis.cuh"

namespace {

using namespace trellis;

constexpr int kThreads = 128;  // threads per block: all stage, one per column computes
constexpr int kWarps = kThreads / 32;
// staging: 32-step chunks of a window (L + 2H <= 256 + 80 for every LTE
// code-block size with the decoder's window count), and columns per warp
// whose loads are in flight at once
constexpr int kChunks = 11;
constexpr int kStageCols = 4;
constexpr int kSmem = 232448;  // shared memory one block may use (227 KB)

// the storage type's staged (ls, lp) pair and its 4-state vector
template <typename T>
struct Storage;
template <>
struct Storage<float> {
  using pair = float2;
  using quad = float4;
  __device__ static float2 make(float x, float y) { return make_float2(x, y); }
  __device__ static float2 get(float2 v) { return v; }
  __device__ static float4 pack(const float* v) { return make_float4(v[0], v[1], v[2], v[3]); }
  __device__ static void unpack(float4 q, float* v) {
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
};
template <>
struct Storage<__nv_bfloat16> {
  using pair = __nv_bfloat162;
  struct __align__(8) quad { __nv_bfloat162 lo, hi; };
  __device__ static __nv_bfloat162 make(float x, float y) { return __floats2bfloat162_rn(x, y); }
  __device__ static float2 get(__nv_bfloat162 v) { return __bfloat1622float2(v); }
  __device__ static quad pack(const float* v) {
    return {__floats2bfloat162_rn(v[0], v[1]), __floats2bfloat162_rn(v[2], v[3])};
  }
  __device__ static void unpack(quad q, float* v) {
    const float2 a = __bfloat1622float2(q.lo), b = __bfloat1622float2(q.hi);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
};

// radix-2 pairs of the backward recursion per segment: beta is kept as an
// f32 checkpoint per segment, and a segment's 2 * kPairs rows are
// recomputed from it just before the forward pass reads them
constexpr int kPairs = 8;

// Shared memory of one block: the checkpoints as float4 [segment][half]
// [cols], one segment's beta rows as quads [2 * kPairs][2][cols], then
// each column's window of L + 2H pairs at an odd stride.
template <typename T>
struct Layout {
  int stride, n_seg, cp_bytes, beta_bytes, bytes;
  __host__ __device__ Layout(int cols, int L, int H) {
    stride = (L + 2 * H) | 1;
    n_seg = (L / 2 + kPairs - 1) / kPairs;
    cp_bytes = n_seg * 2 * cols * 16;
    beta_bytes = cp_bytes + 2 * kPairs * 2 * cols * (int)sizeof(typename Storage<T>::quad);
    bytes = beta_bytes + cols * stride * (int)sizeof(typename Storage<T>::pair);
  }
};

// ls, lp: (B, K) f32 as given, K = W * L, n_cols = B * W; beta_tail:
// (B, 8); llr: (B, K) f32; run: null, or a flag that is 0 when the pass is
// not to run; rows: null, or the row list above.  blockDim.x = kThreads;
// cols <= kThreads columns per block.
template <typename T, bool LOGMAP>
__global__ void __launch_bounds__(kThreads)
map_kernel(const float* __restrict__ ls, const float* __restrict__ lp,
           const float* __restrict__ beta_tail, float* __restrict__ llr,
           int n_cols, int W, int L, int H, int cols, const int* __restrict__ run,
           const int* __restrict__ rows) {
  if (run != nullptr && *run == 0) return;
  if (rows != nullptr) n_cols = rows[0] * W;  // the listed rows' columns only
  if (static_cast<int>(blockIdx.x) * cols >= n_cols) return;
  // the data row of batch row b: itself, or the list's b-th entry
  const auto row = [rows](int b) -> long long { return rows != nullptr ? rows[1 + b] : b; };
  using S = Storage<T>;
  using quad = typename S::quad;
  using pair = typename S::pair;
  extern __shared__ __align__(16) unsigned char smem[];
  const int c0 = blockIdx.x * cols;
  const Layout<T> lay(cols, L, H);
  float4* cp = reinterpret_cast<float4*>(smem);  // cp[(segment*2 + half)*cols + column]
  quad* bs = reinterpret_cast<quad*>(smem + lay.cp_bytes);  // bs[(row*2 + half)*cols + column]
  pair* xy = reinterpret_cast<pair*>(smem + lay.beta_bytes);
  const int K = W * L, span = L + 2 * H;

  // ---- stage each column's window [w*L - H, (w+1)*L + H), zero outside
  // [0, K): a warp per column, kStageCols columns at once, every load of
  // their windows in flight together, halved and rounded into the pairs ----
  const int n_here = min(cols, n_cols - c0), warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int m = warp; m < n_here; m += kStageCols * kWarps) {
    float x[kStageCols][kChunks], y[kStageCols][kChunks];
#pragma unroll
    for (int q = 0; q < kStageCols; ++q) {
      const int cl = m + q * kWarps, c = c0 + cl, k0 = (c % W) * L - H;
      const long long base = cl < n_here ? row(c / W) * K : 0;
#pragma unroll
      for (int u = 0; u < kChunks; ++u) {
        const int i = 32 * u + lane, k = k0 + i;
        const bool in_k = cl < n_here && i < span && k >= 0 && k < K;
        x[q][u] = in_k ? ls[base + k] : 0.f;
        y[q][u] = in_k ? lp[base + k] : 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < kStageCols; ++q) {
      const int cl = m + q * kWarps;
#pragma unroll
      for (int u = 0; u < kChunks; ++u)
        if (cl < n_here && 32 * u + lane < span)
          xy[cl * lay.stride + 32 * u + lane] = S::make(x[q][u] * 0.5f, y[q][u] * 0.5f);
    }
  }
  __syncthreads();

  const int cl = threadIdx.x, c = c0 + cl;
  pair* in = xy + min(cl, cols - 1) * lay.stride;
  auto branch = [&](float2 v, float (&g)[4]) {
    g[0] = v.x + v.y;
    g[1] = v.x - v.y;
    g[2] = -g[1];
    g[3] = -g[0];
  };
  if (cl < cols && c < n_cols) {
    const int w = c % W, n_pairs = L / 2;
    float g[4];
    // One radix-2 pair of the backward recursion from row tt (odd): beta at
    // node tt+1 in, node tt-1 out.  With slot >= 0 the rows tt and tt-1
    // (beta at nodes tt+1 and tt) are stored at slots slot and slot-1.
    auto bwd_pair = [&](float (&beta)[8], int tt, int slot) {
      const float2 v1 = S::get(in[H + tt]), v0 = S::get(in[H + tt - 1]);
      if (slot >= 0) {
        bs[(slot * 2) * cols + cl] = S::pack(beta);
        bs[(slot * 2 + 1) * cols + cl] = S::pack(beta + 4);
      }
      branch(v1, g);
      bwd_step<LOGMAP>(beta, g);
      if (slot >= 0) {
        bs[((slot - 1) * 2) * cols + cl] = S::pack(beta);
        bs[((slot - 1) * 2 + 1) * cols + cl] = S::pack(beta + 4);
      }
      branch(v0, g);
      bwd_step<LOGMAP>(beta, g);
      // bf16 storage: keep stored magnitudes inside bf16's resolution (the
      // common offset cancels in m0 - m1)
      if (sizeof(T) == 2) normalise(beta);
    };

    // ---- backward: halo warm-up over [H+L, 2H+L), exact beta_K ----
    float beta[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float2 nx = S::get(in[2 * H + L - 1]);
#pragma unroll 2
    for (int i = 2 * H + L - 1; i >= H + L; --i) {
      branch(nx, g);
      nx = S::get(in[i - 1]);
      bwd_step<LOGMAP>(beta, g);
    }
    if (w == W - 1) {
#pragma unroll
      for (int s = 0; s < 8; ++s) beta[s] = beta_tail[row(c / W) * 8 + s];
    }
    normalise(beta);

    // ---- backward over the window: a checkpoint at each segment's start ----
#pragma unroll 2
    for (int i = 0; i < n_pairs; ++i) {
      if (i % kPairs == 0) {
        cp[((i / kPairs) * 2) * cols + cl] = make_float4(beta[0], beta[1], beta[2], beta[3]);
        cp[((i / kPairs) * 2 + 1) * cols + cl] = make_float4(beta[4], beta[5], beta[6], beta[7]);
      }
      bwd_pair(beta, L - 1 - 2 * i, -1);
    }

    // ---- forward: halo warm-up over [0, H), exact alpha_0 ----
    float alpha[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    nx = S::get(in[0]);
#pragma unroll 2
    for (int i = 0; i < H; ++i) {
      branch(nx, g);
      nx = S::get(in[i + 1]);
      fwd_step<LOGMAP>(alpha, g);
    }
    if (w == 0) {
      alpha[0] = 0.f;
#pragma unroll
      for (int s = 1; s < 8; ++s) alpha[s] = kNeg;
    }
    normalise(alpha);

    // ---- segment by segment from row 0: recompute the segment's beta rows
    // from its checkpoint (the same f32 steps, so the same bits), then the
    // forward recursion over them with the posterior combine fused in ----
    for (int j = (n_pairs - 1) / kPairs; j >= 0; --j) {
      const int i0 = j * kPairs, i1 = min(i0 + kPairs, n_pairs);
      const int lo = L - 2 * i1, hi = L - 2 * i0;  // the segment's rows
      const float4 ca = cp[(j * 2) * cols + cl], cb = cp[(j * 2 + 1) * cols + cl];
      float bt[8] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
#pragma unroll
      for (int u = 0; u < kPairs; ++u)
        if (i0 + u < i1) bwd_pair(bt, L - 1 - 2 * (i0 + u), L - 1 - 2 * (i0 + u) - lo);
      // beta at node tt+1 is loaded one step ahead, like the inputs
      nx = S::get(in[H + lo]);
      quad q0 = bs[cl], q1 = bs[cols + cl];
#pragma unroll 2
      for (int tt = lo; tt < hi; ++tt) {
        branch(nx, g);
        nx = S::get(in[H + tt + 1]);
        float tsu[8][2], bn[8], v0[8], v1[8];
        S::unpack(q0, bn);
        S::unpack(q1, bn + 4);
        const int sn = min(tt + 1, hi - 1) - lo;
        q0 = bs[(sn * 2) * cols + cl];
        q1 = bs[(sn * 2 + 1) * cols + cl];
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          tsu[s][0] = alpha[s] + g[combo(s, 0)];
          tsu[s][1] = alpha[s] + g[combo(s, 1)];
          v0[s] = tsu[s][0] + bn[next_state(s, 0)];
          v1[s] = tsu[s][1] + bn[next_state(s, 1)];
        }
        // the staged input of step tt is read (later segments read only
        // higher steps): its slot takes the LLR
        *reinterpret_cast<float*>(in + H + tt) = max8(v0) - max8(v1);
#pragma unroll
        for (int s = 0; s < 8; ++s)
          alpha[s] = max_star<LOGMAP>(tsu[prev_state(s, 0)][prev_u(s, 0)],
                                      tsu[prev_state(s, 1)][prev_u(s, 1)]);
      }
    }
  }
  __syncthreads();

  // ---- the block's LLRs, contiguous in (B, K): coalesced, a warp per column ----
  for (int k = warp; k < n_here; k += kWarps)
    for (int tt = lane; tt < L; tt += 32)
      llr[row((c0 + k) / W) * K + (long long)((c0 + k) % W) * L + tt] =
          *reinterpret_cast<const float*>(xy + k * lay.stride + H + tt);
}

// Dynamic shared memory above 48 KB must be allowed per kernel first; the
// cap is set to cover `bytes` on every call, so a smaller launch after a
// larger one still fits.
template <typename F>
cudaError_t allow_smem(F* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes > 48 * 1024 ? bytes : 48 * 1024);
}

// The default block: the most columns (up to kThreads) of which four
// blocks fit one SM's shared memory (233,472 bytes, 1 KB of it reserved
// per block), so each of the SM's four schedulers runs one computing warp.
template <typename T>
int default_cols(int L, int H) {
  int cols = kThreads;
  while (cols > 1 && 4 * (Layout<T>(cols, L, H).bytes + 1024) > 233472) --cols;
  return cols >= 32 ? cols / 32 * 32 : cols;  // whole warps beat more, emptier ones
}

template <typename T, bool LOGMAP>
cudaError_t launch(const float* ls, const float* lp, const float* beta_tail, float* llr,
                   int n_cols, int W, int L, int H, const int* run, const int* rows,
                   cudaStream_t stream) {
  const int cols = default_cols<T>(L, H);
  const Layout<T> lay(cols, L, H);
  if (lay.bytes > kSmem) return cudaErrorInvalidValue;
  const auto kernel = map_kernel<T, LOGMAP>;
  const cudaError_t err = allow_smem(kernel, lay.bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(n_cols + cols - 1) / cols, kThreads, lay.bytes, stream>>>(
      ls, lp, beta_tail, llr, n_cols, W, L, H, cols, run, rows);
  return cudaGetLastError();
}

template <typename T, bool LOGMAP>
int blocks_per_sm(int L, int H) {
  const int cols = default_cols<T>(L, H);
  const Layout<T> lay(cols, L, H);
  const auto kernel = map_kernel<T, LOGMAP>;
  int n = 0;
  if (lay.bytes > kSmem || allow_smem(kernel, lay.bytes) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, lay.bytes))
    return -1;
  return n;
}

}  // namespace

// Columns per block of a launch with these arguments.
extern "C" int turbo_map_cols(int L, int H, int narrow) {
  return narrow ? default_cols<__nv_bfloat16>(L, H) : default_cols<float>(L, H);
}

// Thread blocks of the kernel that one SM holds at once for these
// arguments (the card's occupancy calculator), or -1 on an error.
extern "C" int turbo_map_blocks_per_sm(int L, int H, int narrow, int logmap) {
  using bf16 = __nv_bfloat16;
  if (narrow) return logmap ? blocks_per_sm<bf16, true>(L, H) : blocks_per_sm<bf16, false>(L, H);
  return logmap ? blocks_per_sm<float, true>(L, H) : blocks_per_sm<float, false>(L, H);
}

// Plain C entry point, loaded with ctypes.  ls, lp, llr: (B, K) float32
// with K = W * L and n_cols = B * W; beta_tail: (B, 8) float32.  narrow:
// bf16 storage (else float32).  run: null, or an int on the card that
// skips the pass when it is 0; rows: null, or an int list on the card,
// [n, r_0, ..., r_{n-1}] with n <= B, of the rows to compute.  Returns the
// cudaError_t of the launch.
extern "C" int turbo_map_launch(const void* ls, const void* lp, const void* beta_tail,
                                void* llr, int n_cols, int W, int L, int H, int narrow,
                                int logmap, const void* run, const void* rows,
                                void* stream) {
  if (n_cols <= 0 || W <= 0 || L <= 0 || L % 2 || H < 0 || H > L || n_cols % W ||
      L + 2 * H > 32 * kChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(ls);
  const auto* y = static_cast<const float*>(lp);
  const auto* bt = static_cast<const float*>(beta_tail);
  auto* out = static_cast<float*>(llr);
  const auto* r = static_cast<const int*>(run);
  const auto* rl = static_cast<const int*>(rows);
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (narrow)
    err = logmap ? launch<bf16, true>(x, y, bt, out, n_cols, W, L, H, r, rl, st)
                 : launch<bf16, false>(x, y, bt, out, n_cols, W, L, H, r, rl, st);
  else
    err = logmap ? launch<float, true>(x, y, bt, out, n_cols, W, L, H, r, rl, st)
                 : launch<float, false>(x, y, bt, out, n_cols, W, L, H, r, rl, st);
  return static_cast<int>(err);
}
