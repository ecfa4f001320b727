// One max-log-MAP half-iteration of one LTE turbo constituent decoder for a
// batch of code blocks, windowed, any window length: the port's second MAP
// kernel, the one the decoder takes when the window length L is odd
// (turbo_map.cu steps two trellis stages at a time and needs an even L).
//
// Replaces the TPU kernel srslte_emane_tpu/ops/fec/turbodecoder_pallas.py
// `_map_kernel` (v1, launched by `map_window_tiles`) together with the halo
// pre-scans and branch metrics that its wrapper `map_decode_pallas` computes
// outside it, and computes the same function on the same windows (W per code
// block, length L, halo H): for every (code block, window) column an H-step
// warm-up of alpha and of beta from the all-zero state over the halo on each
// side; window 0 then takes the exact alpha_0 = (0, NEG, ..., NEG) as it is,
// window W-1 the tail-derived beta_K less its max, every other window keeps
// its warm-up state; a backward pass storing beta at node t+1, a forward
// pass with the posterior m0 - m1 fused in.  Radix-1 steps, everything f32,
// and the max over the 8 states is subtracted after EVERY alpha and beta
// step, warm-up steps included.  LOGMAP adds the half-scale max* correction
// in the recursions.
//
// Branch metrics, bit for bit the plain version's 0.5 * (su + sz): from the
// staged (x, y) = (ls, lp) of a step, g0 = 0.5 * (x + y), g1 = 0.5 * (x - y),
// g2 = -g1, g3 = -g0.  The halving and the negations are exact, and the
// halving is written as __fmul_rn, which the compiler never contracts with
// the add that follows into an FMA, so every add and max rounds as the plain
// version's does.
//
// What bounds it (H100 SXM, 3.35 TB/s, 33.5 T non-FMA f32 op/s): it must
// read ls and lp and write the LLRs, (B, K) f32 each, and do per column 2H
// warm-up steps of 41 f32 add/max (2 for the branch metrics, a 24-operation
// step, its 15-operation normalisation) and L steps of 111: 2, the beta step
// and its normalisation 24 + 15, the alpha step and its normalisation 24 +
// 15, and 31 for the posterior (16 adds of beta to the alpha step's own
// alpha + g sums, 14 max, 1 subtraction).  At 768 x K=5504 (L=172, H=40)
// that is 50.7 MB or 15.1 us against 0.55 G operations or 16.4 us: bound by
// operations.  In practice each column is a chain of
// 2H + 3L dependent steps, each six operations deep (add, max, a three-level
// max tree, subtract), and how many chains an SM holds (shared memory) and
// how fast one steps set the time.
//
// What the design it replaces lost time to: the wrapper ran the two halo
// pre-scans as 2 x 40 steps of a dozen small torch kernels each (6.7-13.8 ms
// around a kernel of 16-245 us) and built a padded, strided, permuted
// (L + 2H, 4, columns) branch-metric tensor, four times the bytes of ls and
// lp; the kernel read those metrics twice from device memory, one dependent
// load per step, in blocks of 64 threads, and kept beta as an (L, 8, columns)
// f32 scratch in device memory (135 MB at the shape above, more than the
// 50 MB L2, written and read back every launch).
//
// This design, as turbo_map.cu's:
//  * windowing in the kernel: it reads ls, lp (B, K) f32 as they are.  A
//    thread block owns `cols` consecutive columns and stages each column's
//    window with its halos, [w*L - H, (w+1)*L + H) of its code block, zero
//    outside [0, K), as f32 (ls, lp) pairs in shared memory: a warp per
//    column, kStageCols columns' loads in flight at once, 32 * kChunks steps
//    of a window per pass (one pass for L + 2H <= 352).  For L <= 40 the
//    halo is the whole neighbouring window (H = L): the staged range
//    covers that by construction.  The trellis loops read only shared
//    memory;
//  * the halo warm-ups and the edge rules in the kernel, from the staged
//    pairs;
//  * one thread per column, the 8 states in registers, no shuffles and no
//    synchronisation after staging;
//  * beta in shared memory, checkpointed: the backward pass keeps only the
//    f32 beta at the start of every kSeg steps.  The forward pass takes the
//    window segment by segment from row 0: it recomputes the segment's rows
//    from their checkpoint into a small buffer (the same f32 steps from the
//    same state, so the same bits) and runs alpha and the posterior over
//    them.  The segment at row 0 is the partial one when L is not a multiple
//    of kSeg;
//  * layouts [row or segment][half][column] of 4-state vectors and an odd
//    stride per staged column, so a warp's shared accesses do not conflict;
//  * the posterior writes each LLR over the staged input of that step, which
//    it has read, and the block writes its (cols x L) LLRs, contiguous in
//    (B, K), coalesced at the end.
// The kernel equals its plain version bit for bit (ops/fec/
// turbodecoder_cuda.py `map_decode_v1_ref`).
//
// Budget, per column: 8 * ((L + 2H) | 1) B of staged pairs, 32 B per
// checkpoint (one every kSeg = 8 steps), 256 B of segment rows.  A block
// takes the most columns (up to its 128 threads, in whole warps from 32 up)
// of which four blocks fit one SM's shared memory:
//   L=172, H=40 (K=5504, W=32): 2,024 + 704 + 256 = 2,984 B, 19 columns;
//   L=65,  H=40 (K=1040, W=16): 1,160 + 288 + 256 = 1,704 B, 32 columns;
//   L=33,  H=33 (K=1056, W=32):   792 + 160 + 256 = 1,208 B, 32 columns;
//   L=11,  H=11 (K=1056, W=96):   264 +  64 + 256 =   584 B, 96 columns;
//   L=1536, H=40 (K=6144, W=4): 12,936 + 6,144 + 256 = 19,336 B, 2 columns.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, the kernel is bound by
// the rate at which a scheduler dispatches one warp's operations: a
// computing warp steps its chain at the same rate whether one or four run
// on an SM, and more, emptier warps per scheduler were slower
// (scripts/torch_map_breakdown.py).  Segments of 8 steps read within 2 % of
// 16 at L=172 and L=33 and 14 % faster at L=65, where they make the block a
// whole warp.  ptxas -v: 96 registers, no spills; the occupancy calculator
// gives 4 blocks per SM at these shapes (5 at L=33 and L=1536).
//
// Long windows: staging loops over passes of 352 steps, so a window of any
// length is staged while it fits.  When not even one column fits a quarter
// of an SM's shared memory (L above about 4,700 at H=40; the decoder's own
// window count never exceeds L=256), a block takes one column and an SM
// fewer blocks: a whole code block of the largest LTE size as one window
// (K=6144, W=1) takes 74,632 B, three blocks per SM.  A window that does not
// fit a block's 227 KB at all (L above about 19,000, three times the largest
// code block) is refused.

#include <climits>

#include <cuda_runtime.h>

#include "trellis.cuh"

namespace {

using namespace trellis;

constexpr int kThreads = 128;  // threads per block: all stage, one per column computes
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;  // blocks an SM's shared memory is sized for
constexpr int kChunks = 11;      // 32-step chunks of a window staged per pass
constexpr int kStageCols = 4;    // columns per warp whose loads are in flight at once
constexpr int kSeg = 8;          // steps per checkpointed segment of the backward pass
constexpr int kSmem = 232448;    // shared memory one block may use (227 KB)
constexpr int kSmemPerSm = 233472;  // of one SM, 1 KB of it reserved per block

// the four branch metrics of a step from its (ls, lp) pair, combo u*2 + z
__device__ __forceinline__ void branch(float2 v, float (&g)[4]) {
  g[0] = __fmul_rn(0.5f, v.x + v.y);
  g[1] = __fmul_rn(0.5f, v.x - v.y);
  g[2] = -g[1];
  g[3] = -g[0];
}

// Posterior m0 - m1 of a step and the alpha step behind it, normalised:
// both from tsu[s][u] = alpha[s] + g[combo(s, u)]; bn is beta at the next
// node.
template <bool LOGMAP>
__device__ __forceinline__ float posterior_and_step(float (&alpha)[8], const float (&g)[4],
                                                    const float (&bn)[8]) {
  float tsu[8][2], v0[8], v1[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    tsu[s][0] = alpha[s] + g[combo(s, 0)];
    tsu[s][1] = alpha[s] + g[combo(s, 1)];
    v0[s] = tsu[s][0] + bn[next_state(s, 0)];
    v1[s] = tsu[s][1] + bn[next_state(s, 1)];
  }
#pragma unroll
  for (int s = 0; s < 8; ++s)
    alpha[s] = max_star<LOGMAP>(tsu[prev_state(s, 0)][prev_u(s, 0)],
                                tsu[prev_state(s, 1)][prev_u(s, 1)]);
  normalise(alpha);
  return max8(v0) - max8(v1);
}

__device__ __forceinline__ void exact_alpha0(float (&alpha)[8]) {
  alpha[0] = 0.f;
#pragma unroll
  for (int s = 1; s < 8; ++s) alpha[s] = kNeg;
}

// Shared memory of one block: the checkpoints as float4
// [segment][half][cols], one segment's beta rows [kSeg][2][cols], then each
// column's window of L + 2H pairs at an odd stride.  Segment j holds the
// rows [max(L - (j+1)*kSeg, 0), L - j*kSeg); its checkpoint is beta at node
// L - j*kSeg.
struct Layout {
  int stride, n_seg, cp_bytes, beta_bytes, bytes;
  __host__ __device__ Layout(int cols, int L, int H) {
    stride = (L + 2 * H) | 1;
    n_seg = (L + kSeg - 1) / kSeg;
    cp_bytes = n_seg * 2 * cols * 16;
    beta_bytes = cp_bytes + kSeg * 2 * cols * 16;
    bytes = beta_bytes + cols * stride * 8;
  }
};

// ls, lp: (B, K) f32 as given, K = W * L, n_cols = B * W; beta_tail:
// (B, 8); llr: (B, K) f32.  blockDim.x = kThreads; cols <= kThreads
// columns per block.
template <bool LOGMAP>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
map_v1_kernel(const float* __restrict__ ls, const float* __restrict__ lp,
              const float* __restrict__ beta_tail, float* __restrict__ llr,
              int n_cols, int W, int L, int H, int cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c0 = blockIdx.x * cols;
  const Layout lay(cols, L, H);
  float4* cp = reinterpret_cast<float4*>(smem);  // cp[(segment*2 + half)*cols + column]
  float4* bs = reinterpret_cast<float4*>(smem + lay.cp_bytes);  // bs[(row*2 + half)*cols + column]
  float2* xy = reinterpret_cast<float2*>(smem + lay.beta_bytes);
  const int K = W * L, span = L + 2 * H;

  // ---- stage each column's window [w*L - H, (w+1)*L + H), zero outside
  // [0, K): a warp per column, kStageCols columns at once, 32 * kChunks
  // steps per pass with every load of the pass in flight together ----
  const int n_here = min(cols, n_cols - c0), warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int m = warp; m < n_here; m += kStageCols * kWarps) {
    for (int i0 = 0; i0 < span; i0 += 32 * kChunks) {
      float x[kStageCols][kChunks], y[kStageCols][kChunks];
#pragma unroll
      for (int q = 0; q < kStageCols; ++q) {
        const int cl = m + q * kWarps, c = c0 + cl, k0 = (c % W) * L - H;
        const long long base = (long long)(c / W) * K;
#pragma unroll
        for (int u = 0; u < kChunks; ++u) {
          const int i = i0 + 32 * u + lane, k = k0 + i;
          const bool in_k = cl < n_here && i < span && k >= 0 && k < K;
          x[q][u] = in_k ? ls[base + k] : 0.f;
          y[q][u] = in_k ? lp[base + k] : 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < kStageCols; ++q) {
        const int cl = m + q * kWarps;
#pragma unroll
        for (int u = 0; u < kChunks; ++u) {
          const int i = i0 + 32 * u + lane;
          if (cl < n_here && i < span) xy[cl * lay.stride + i] = make_float2(x[q][u], y[q][u]);
        }
      }
    }
  }
  __syncthreads();

  const int cl = threadIdx.x, c = c0 + cl;
  if (cl < cols && c < n_cols) {
    float2* in = xy + cl * lay.stride;
    const int w = c % W;
    float g[4];
    auto load8 = [&](const float4* p, int row, float (&v)[8]) {
      const float4 a = p[(row * 2) * cols + cl], b = p[(row * 2 + 1) * cols + cl];
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    };
    auto store8 = [&](float4* p, int row, const float (&v)[8]) {
      p[(row * 2) * cols + cl] = make_float4(v[0], v[1], v[2], v[3]);
      p[(row * 2 + 1) * cols + cl] = make_float4(v[4], v[5], v[6], v[7]);
    };

    // ---- backward: halo warm-up over [H+L, 2H+L), then the edge rule:
    // the last window takes beta_K less its max.  Each step's pair is
    // loaded one step ahead. ----
    float beta[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float2 nx = in[2 * H + L - 1];
#pragma unroll 4
    for (int i = 2 * H + L - 1; i >= H + L; --i) {
      branch(nx, g);
      nx = in[i - 1];
      bwd_step<LOGMAP>(beta, g);
      normalise(beta);
    }
    if (w == W - 1) {
#pragma unroll
      for (int s = 0; s < 8; ++s) beta[s] = beta_tail[(size_t)(c / W) * 8 + s];
      normalise(beta);
    }

    // ---- backward over the window: a checkpoint at each segment's start ----
    nx = in[H + L - 1];
#pragma unroll 4
    for (int i = 0; i < L; ++i) {
      if (i % kSeg == 0) store8(cp, i / kSeg, beta);
      branch(nx, g);
      nx = in[max(H + L - 2 - i, 0)];
      bwd_step<LOGMAP>(beta, g);
      normalise(beta);
    }

    // ---- forward: halo warm-up over [0, H), then the edge rule: window 0
    // takes the exact alpha_0 as it is ----
    float alpha[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    nx = in[0];
#pragma unroll 4
    for (int i = 0; i < H; ++i) {
      branch(nx, g);
      nx = in[i + 1];
      fwd_step<LOGMAP>(alpha, g);
      normalise(alpha);
    }
    if (w == 0) exact_alpha0(alpha);

    // ---- segment by segment from row 0: recompute the segment's beta rows
    // from its checkpoint (the same f32 steps, so the same bits), then the
    // forward recursion over them with the posterior combine fused in ----
    for (int j = lay.n_seg - 1; j >= 0; --j) {
      const int hi = L - j * kSeg, lo = max(hi - kSeg, 0);  // the segment's rows
      float bt[8];
      load8(cp, j, bt);
#pragma unroll
      for (int u = 0; u < kSeg; ++u) {
        const int tt = hi - 1 - u;
        if (tt >= lo) {
          store8(bs, tt - lo, bt);  // beta at node tt+1
          if (tt > lo) {
            branch(in[H + tt], g);
            bwd_step<LOGMAP>(bt, g);
            normalise(bt);
          }
        }
      }
      // the pair and beta at node tt+1 are loaded one step ahead
      nx = in[H + lo];
      float bn[8], bnn[8];
      load8(bs, 0, bnn);
#pragma unroll 4
      for (int tt = lo; tt < hi; ++tt) {
        branch(nx, g);
        nx = in[min(H + tt + 1, span - 1)];
#pragma unroll
        for (int s = 0; s < 8; ++s) bn[s] = bnn[s];
        load8(bs, min(tt + 1, hi - 1) - lo, bnn);
        // the staged input of step tt is read (later segments read only
        // higher steps): its slot takes the LLR
        in[H + tt].x = posterior_and_step<LOGMAP>(alpha, g, bn);
      }
    }
  }
  __syncthreads();

  // ---- the block's LLRs, contiguous in (B, K): coalesced, a warp per column ----
  for (int k = warp; k < n_here; k += kWarps)
    for (int tt = lane; tt < L; tt += 32)
      llr[(long long)(c0 + k) * L + tt] = xy[k * lay.stride + H + tt].x;
}

// Dynamic shared memory above 48 KB must be allowed per kernel first; the
// cap is set to cover `bytes` on every call, so a smaller launch after a
// larger one still fits.
template <typename F>
cudaError_t allow_smem(F* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes > 48 * 1024 ? bytes : 48 * 1024);
}

// Columns per block: the most (up to kThreads) of which kBlocksPerSm blocks
// fit one SM's shared memory, so each of the SM's four schedulers runs a
// computing warp.  A window so long that not even one column fits a quarter
// of an SM takes one column per block, and fewer blocks per SM, while it fits
// a block's shared memory at all (L up to about 19,000); 0 beyond that.
int block_cols(int L, int H) {
  if (L + 2 * H > kSmem / 8) return 0;  // also keeps Layout's byte counts inside an int
  int cols = kThreads;
  while (cols > 0 && kBlocksPerSm * (Layout(cols, L, H).bytes + 1024) > kSmemPerSm) --cols;
  if (cols == 0) return Layout(1, L, H).bytes <= kSmem ? 1 : 0;
  return cols >= 32 ? cols / 32 * 32 : cols;  // whole warps beat more, emptier ones
}

bool valid_shape(int n_cols, int W, int L, int H) {
  return n_cols > 0 && W > 0 && L > 0 && H >= 0 && H <= L && n_cols % W == 0 &&
         (long long)W * L <= INT_MAX;
}

template <bool LOGMAP>
cudaError_t launch(const float* ls, const float* lp, const float* beta_tail, float* llr,
                   int n_cols, int W, int L, int H, cudaStream_t stream) {
  const int cols = block_cols(L, H);
  if (cols == 0) return cudaErrorInvalidValue;
  const Layout lay(cols, L, H);
  const auto kernel = map_v1_kernel<LOGMAP>;
  const cudaError_t err = allow_smem(kernel, lay.bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(n_cols + cols - 1) / cols, kThreads, lay.bytes, stream>>>(
      ls, lp, beta_tail, llr, n_cols, W, L, H, cols);
  return cudaGetLastError();
}

template <bool LOGMAP>
int blocks_per_sm(int L, int H) {
  int n = 0;
  const int cols = block_cols(L, H);
  if (cols == 0) return -1;
  const Layout lay(cols, L, H);
  const auto kernel = map_v1_kernel<LOGMAP>;
  if (allow_smem(kernel, lay.bytes) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, lay.bytes))
    return -1;
  return n;
}

}  // namespace

// Columns per block of a launch with these arguments, or 0 when the window
// does not fit a block's shared memory and the launch is refused.
extern "C" int turbo_map_v1_cols(int L, int H) {
  return L > 0 && H >= 0 && H <= L ? block_cols(L, H) : 0;
}

// Thread blocks that one SM holds at once with these arguments (the card's
// occupancy calculator), or -1 on an error.
extern "C" int turbo_map_v1_blocks_per_sm(int L, int H, int logmap) {
  if (L <= 0 || H < 0 || H > L) return -1;
  return logmap ? blocks_per_sm<true>(L, H) : blocks_per_sm<false>(L, H);
}

// Plain C entry points, loaded with ctypes.  ls, lp, llr: (B, K) float32
// with K = W * L and n_cols = B * W; beta_tail: (B, 8) float32.  Returns
// the cudaError_t of the launch; refuses a shape for which turbo_map_v1_cols
// is 0.
extern "C" int turbo_map_v1_launch(const void* ls, const void* lp, const void* beta_tail,
                                   void* llr, int n_cols, int W, int L, int H, int logmap,
                                   void* stream) {
  if (!valid_shape(n_cols, W, L, H)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(ls);
  const auto* y = static_cast<const float*>(lp);
  const auto* bt = static_cast<const float*>(beta_tail);
  auto* out = static_cast<float*>(llr);
  return static_cast<int>(logmap ? launch<true>(x, y, bt, out, n_cols, W, L, H, st)
                                 : launch<false>(x, y, bt, out, n_cols, W, L, H, st));
}
