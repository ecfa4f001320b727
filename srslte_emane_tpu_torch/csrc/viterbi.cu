// Tail-biting Viterbi decode of the LTE K=7, rate-1/3 convolutional code
// (generators 133, 171, 165 octal) for a batch of rows: the Hopper kernel
// behind every convolutional decode of the port (PDCCH, PBCH, UCI on PUSCH,
// NPBCH, the dynamic block's DCIs).
//
// Replaces srslte_emane_tpu/ops/fec/viterbi.py:53 `viterbi_decode`, both of
// its `lax.scan`s (the add-compare-select over the trellis and the
// traceback), and computes the same function: from the branch metrics
// bm (R, K, 8) f32 of ops/fec/viterbi.py `branch_metrics`, a 64-state ACS
// over T = tb_iter * K steps that reads bm[:, t % K] (the frame repeated
// tb_iter times), a decision `cand1 > cand0` per state (a tie keeps
// predecessor 0, as jnp.argmax does), the metrics less their maximum after
// every step, the final state as the first maximum, and a traceback from
// step T-1 down to mid = (tb_iter / 2) * K that writes the bits of steps
// [mid, mid + K) as (R, K) int8.
//
// What bounds it (H100 SXM, 3.35 TB/s, 33.5 T non-FMA f32 op/s): the bytes
// are tiny (bm R*K*32 B in, bits R*K B out: 18 KB for the 128-row PBCH
// decode), and the work is R*T*(64*4 + 63) f32 add/compare/max/subtract, so
// for many rows the f32 issue rate bounds it.  For the few hundred to few
// thousand rows a subframe gives, neither is close: each row is a chain of
// T dependent steps, each of which has to see every state's metric of the
// step before (the maximum over 64 states), so the time is T times the
// latency of one step.
//
// What the design does about it:
//  * a warp per row, every row of the call in one launch (kWarps rows per
//    block, the grid over the rows, a partial last block masked): the rows
//    spread over the card, and no step waits on anything outside its warp;
//  * lane l holds states 2l and 2l+1, whose predecessors are both l and
//    l+32, held by lanes l>>1 and 16+(l>>1) in slot l&1: four shuffles
//    fetch them, the lane's four branch-metric combos (kPredCombo) sit in
//    registers, and the step's maximum is a 5-round xor-shuffle reduction;
//  * no device-memory traffic inside the loop: the row's bm is staged in
//    shared memory once, and two ballots pack the step's 64 decisions into
//    two words (bit l of word j: state 2l+j) kept in shared memory for the
//    steps the traceback visits (8 * (T - mid) bytes, 1 KB at K=64); lane 0
//    then runs the traceback from them in the same launch;
//  * a second variant for a K whose row does not fit that budget (K above
//    1,210 at tb_iter 3, four rows to a block; NB-IoT's NPDSCH reaches it
//    from a TBS of 1,195): the same warp per row, the same ACS and
//    traceback, but the branch metrics stay in device memory and are read
//    through L2, and the decision words go to a scratch tensor in device
//    memory that the wrapper allocates (8 B per row per traceback step).
//    The wrapper picks the variant by shape (`viterbi_fits`).
// Bit for bit against the plain loop (ops/fec/viterbi.py
// `viterbi_decode_ref`) by construction: the only arithmetic is the
// rounded add of a metric and a branch metric, an exact compare and
// maximum, and the rounded subtraction of the maximum; nothing is
// re-associated or contracted into an FMA.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // rows per block, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSmem = 232448;  // a block's most dynamic shared memory on the H100
constexpr unsigned kFull = 0xffffffffu;

// kPredCombo[s][j]: the output combo (d0 + 2 d1 + 4 d2) of the branch into
// state s from its predecessor j, (s >> 1) | (j << 5); ops/fec/viterbi.py
// `_tables` computes the same table from the generators (the CPU tests
// hold the two equal).
__constant__ int8_t kPredCombo[64][2] = {
    {0, 7}, {7, 0}, {6, 1}, {1, 6}, {7, 0}, {0, 7}, {1, 6}, {6, 1},
    {3, 4}, {4, 3}, {5, 2}, {2, 5}, {4, 3}, {3, 4}, {2, 5}, {5, 2},
    {4, 3}, {3, 4}, {2, 5}, {5, 2}, {3, 4}, {4, 3}, {5, 2}, {2, 5},
    {7, 0}, {0, 7}, {1, 6}, {6, 1}, {0, 7}, {7, 0}, {6, 1}, {1, 6},
    {1, 6}, {6, 1}, {7, 0}, {0, 7}, {6, 1}, {1, 6}, {0, 7}, {7, 0},
    {2, 5}, {5, 2}, {4, 3}, {3, 4}, {5, 2}, {2, 5}, {3, 4}, {4, 3},
    {5, 2}, {2, 5}, {3, 4}, {4, 3}, {2, 5}, {5, 2}, {4, 3}, {3, 4},
    {6, 1}, {1, 6}, {0, 7}, {7, 0}, {1, 6}, {6, 1}, {7, 0}, {0, 7},
};

// shared memory of one row: its bm (K x 8 f32), then two decision words
// for each of the T - mid steps the traceback visits
__host__ __device__ int row_bytes(int K, int tb_iter) {
  return 32 * K + 8 * (tb_iter - tb_iter / 2) * K;
}

long long block_bytes(int K, int tb_iter) {
  return static_cast<long long>(kWarps) * row_bytes(K, tb_iter);
}

// kGlobal: the variant for a K beyond the shared-memory budget, with the
// branch metrics read from device memory and the decision words kept in
// `scratch` ((R, T - mid) uint2); otherwise both live in shared memory and
// `scratch` is not read.
template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
viterbi_kernel(const float* __restrict__ bm, int8_t* __restrict__ bits,
               uint2* __restrict__ scratch, int R, int K, int tb_iter) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= R) return;  // a whole warp: no block-wide barrier below
  const int T = tb_iter * K, mid = (tb_iter / 2) * K;
  const float* src = bm + static_cast<size_t>(row) * 8 * K;
  const float* sbm;
  uint2* dec;
  if constexpr (kGlobal) {
    sbm = src;
    dec = scratch + static_cast<size_t>(row) * (T - mid);
  } else {
    float* stage = reinterpret_cast<float*>(smem + warp * row_bytes(K, tb_iter));
    for (int i = lane; i < 8 * K; i += 32) stage[i] = src[i];
    sbm = stage;
    dec = reinterpret_cast<uint2*>(stage + 8 * K);
  }
  const int c00 = kPredCombo[2 * lane][0], c01 = kPredCombo[2 * lane][1];
  const int c10 = kPredCombo[2 * lane + 1][0], c11 = kPredCombo[2 * lane + 1][1];
  const int lane_a = lane >> 1, lane_b = 16 + (lane >> 1);  // hold states l, l+32
  const bool odd = lane & 1;
  __syncwarp();

  float m0 = 0.0f, m1 = 0.0f;  // metrics of states 2l, 2l+1
  int k = 0;                    // t % K
  for (int t = 0; t < T; ++t) {
    const float* b = sbm + 8 * k;
    const float a0 = __shfl_sync(kFull, m0, lane_a), a1 = __shfl_sync(kFull, m1, lane_a);
    const float z0 = __shfl_sync(kFull, m0, lane_b), z1 = __shfl_sync(kFull, m1, lane_b);
    const float pa = odd ? a1 : a0;  // predecessor 0: state l
    const float pb = odd ? z1 : z0;  // predecessor 1: state l + 32
    const float x0 = __fadd_rn(pa, b[c00]), y0 = __fadd_rn(pb, b[c01]);
    const float x1 = __fadd_rn(pa, b[c10]), y1 = __fadd_rn(pb, b[c11]);
    const bool d0 = y0 > x0, d1 = y1 > x1;  // a tie keeps predecessor 0
    const float n0 = d0 ? y0 : x0, n1 = d1 ? y1 : x1;
    const unsigned w0 = __ballot_sync(kFull, d0), w1 = __ballot_sync(kFull, d1);
    if (lane == 0 && t >= mid) dec[t - mid] = make_uint2(w0, w1);
    float mx = fmaxf(n0, n1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    m0 = __fsub_rn(n0, mx);
    m1 = __fsub_rn(n1, mx);
    if (++k == K) k = 0;
  }

  // the final state: the first maximum, reduced on (value, state)
  float v = m0;
  int s = 2 * lane;
  if (m1 > m0) v = m1, s = 2 * lane + 1;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int os = __shfl_xor_sync(kFull, s, off);
    if (ov > v || (ov == v && os < s)) v = ov, s = os;
  }

  if (lane != 0) return;  // lane 0 wrote every decision word it reads
  int8_t* out = bits + static_cast<size_t>(row) * K;
  for (int t = T - 1; t >= mid; --t) {
    if (t < mid + K) out[t - mid] = static_cast<int8_t>(s & 1);
    const uint2 w = dec[t - mid];
    const unsigned top = (((s & 1) ? w.y : w.x) >> (s >> 1)) & 1u;
    s = (s >> 1) | static_cast<int>(top << 5);
  }
}

}  // namespace

// 1 if either variant takes this K and tb_iter: the global-memory variant
// takes every K up to 65,536 (NB-IoT's largest TBS, 2,536 bits, gives
// K = 2,552).
extern "C" int viterbi_global_fits(int K, int tb_iter) {
  return K > 0 && K <= (1 << 16) && tb_iter > 0 && tb_iter <= (1 << 10);
}

// 1 if a block's shared memory holds kWarps rows of this K and tb_iter.
extern "C" int viterbi_fits(int K, int tb_iter) {
  return viterbi_global_fits(K, tb_iter) && block_bytes(K, tb_iter) <= kMaxSmem;
}

// Thread blocks of the kernel that one SM holds at once for this K and
// tb_iter (the card's occupancy calculator; the variant viterbi_launch
// takes), or -1 on an error.
extern "C" int viterbi_blocks_per_sm(int K, int tb_iter) {
  if (!viterbi_global_fits(K, tb_iter)) return -1;
  int n = 0;
  if (!viterbi_fits(K, tb_iter))
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, viterbi_kernel<true>, kThreads, 0) ==
                   cudaSuccess
               ? n
               : -1;
  const int bytes = static_cast<int>(block_bytes(K, tb_iter));
  if (cudaFuncSetAttribute(viterbi_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes > 48 * 1024 ? bytes : 48 * 1024) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, viterbi_kernel<false>, kThreads, bytes) !=
          cudaSuccess)
    return -1;
  return n;
}

// Plain C entry point, loaded with ctypes.  bm: (R, K, 8) float32
// contiguous on the card; bits: (R, K) int8; scratch: for a shape that
// viterbi_fits refuses, (R, (tb_iter - tb_iter / 2) * K) pairs of uint32
// (the decision words), else unused and may be null.  Returns the
// cudaError_t of the launch: cudaErrorInvalidValue for a shape that
// viterbi_global_fits refuses or a missing scratch, and cudaSuccess without
// a launch for R = 0.
extern "C" int viterbi_launch(const void* bm, void* bits, void* scratch, int R, int K,
                              int tb_iter, void* stream) {
  if (R < 0 || !viterbi_global_fits(K, tb_iter)) return static_cast<int>(cudaErrorInvalidValue);
  const bool shared = viterbi_fits(K, tb_iter);
  if (!shared && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (R + kWarps - 1) / kWarps;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(bm);
  auto* out = static_cast<int8_t*>(bits);
  if (!shared) {
    viterbi_kernel<true><<<blocks, kThreads, 0, st>>>(x, out, static_cast<uint2*>(scratch), R,
                                                      K, tb_iter);
    return static_cast<int>(cudaGetLastError());
  }
  const int bytes = static_cast<int>(block_bytes(K, tb_iter));
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        viterbi_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  viterbi_kernel<false><<<blocks, kThreads, bytes, st>>>(x, out, nullptr, R, K, tb_iter);
  return static_cast<int>(cudaGetLastError());
}
