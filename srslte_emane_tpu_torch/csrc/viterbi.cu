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
// are tiny (bm R*K*32 B in, bits R*K B out), and the arithmetic is
// R*T*(64*4 + 63) f32 operations, far from either limit at the row counts a
// subframe gives (1 to a few thousand).  Each row is a chain of T dependent
// steps, each of which must see every state's metric of the step before
// (the maximum over the 64 states), so:
//  * at few rows one warp's step bounds it: the latency of its dependent
//    chain (the shuffles between lanes, the maximum's rounds) and the
//    issue of its instructions, one warp's alone on its scheduler;
//  * at thousands of rows the SMs' issue rate bounds it: the instructions a
//    row needs per step, shuffles and integer selects the dearest.
//
// What the design does about both: kLanes = 8 lanes per row, 8 states per
// lane, 4 rows per warp (the earlier kernel gave a row a warp, 2 states a
// lane: 4 shuffles, 2 ballots and 5 dependent xor rounds per step, 11
// shuffle-pipe operations a row, about 6 shuffle latencies deep).  For
// lane j of a row:
//  * it holds the states 8j..8j+7, slot t holding state 8j + (t ^ j)
//    (kSpread = 1);
//  * their predecessors are 4j..4j+3 (in lane j>>1, "A") and
//    32+4j..32+4j+3 (in lane 4+(j>>1), "B").  Every lane sends its slot r
//    in round r of 8 shuffles; an even lane reads A in rounds 0-3 and B in
//    4-7, an odd lane the other way round, and with that slot layout the
//    two predecessors of slot t arrive in rounds t >> 1 and (t >> 1) ^ 4 on
//    every lane (the first of them predecessor 0 on an even lane, 1 on an
//    odd one).  The 8 shuffles are independent, and nothing selects what a
//    lane sends or where a received metric goes;
//  * the code is linear, so the branch into state 8j + (t ^ j) from
//    predecessor u carries combo kPredCombo[8j][0] ^ kPredCombo[j][0] ^
//    kPredCombo[t][u], and kPredCombo[t][1] = kPredCombo[t][0] ^ 7: a lane
//    reads 4 branch metrics per step at offsets fixed for the lane (xored
//    with 7 on an odd lane);
//  * the step's maximum: a tree of 7 fmaxf in the lane, then the row's 8
//    lane maxima in 7 independent shuffles and a tree of 7.  The step's
//    chain crosses 2 shuffle latencies, and a row issues 3.75 shuffles per
//    step ((8 + 7) for 4 rows) instead of 11;
//  * the decisions: only on the steps the traceback visits (the first
//    K * (tb_iter / 2) steps skip them), each as sg * (v - u) > 0 (sg = -1
//    on an odd lane), added as 2^(its state's bit) onto the float 2^23,
//    whose low mantissa byte is then the lane's 8 decisions: one byte per
//    lane per step, a row's 8 bytes one 64-bit word in which bit s is state
//    s.  Full-rate float adds and multiplies take the place of the integer
//    selects that pack predicates into bits, and no ballot is needed;
//  * the words for the steps the traceback visits (8 * (T - mid) bytes per
//    row) stay in shared memory; one lane per row runs the traceback, its
//    reads 8 at a time (they do not depend on the state, only the bit it
//    takes does);
//  * the branch metrics are staged in shared memory once, step-major
//    ([k][row of the block][8]), so the 4 rows of a warp read 4 different
//    32-byte lines of 8 banks each: no bank conflict;
//  * a block is one warp (4 rows), every row of the call in one launch; a
//    partial last warp runs its missing rows as copies of its last row and
//    writes nothing for them, so every shuffle has all 32 lanes;
//  * a second variant for a K whose 4 rows do not fit a block's shared
//    memory (K above 1,210 at tb_iter 3; NB-IoT's NPDSCH reaches it from a
//    TBS of 1,195): the same steps and traceback, but the branch metrics
//    stay in device memory and are read through L1, and the decision words
//    go to a scratch tensor in device memory that the wrapper allocates
//    (8 B per row per traceback step); each step's branch metrics are read
//    a step ahead, out of the way of the L1's latency.  The wrapper picks
//    the variant by shape (`viterbi_fits`).
// Bit for bit against the plain loop (ops/fec/viterbi.py
// `viterbi_decode_ref`) by construction: the only arithmetic on metrics is
// the rounded add of a metric and a branch metric, an exact compare and
// maximum, and the rounded subtraction of the maximum; nothing is
// re-associated or contracted into an FMA.  fmaxf may give either sign of
// a zero where the plain loop's maximum gives the other, which changes no
// comparison and no nonzero value, so no decision and no bit; v - u is
// positive exactly when v > u (with subnormals kept, as nvcc's default
// keeps them), and its product with -1 is exact.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 8;                    // lanes per row
constexpr int kStates = 64 / kLanes;         // states per lane
constexpr int kHalf = kStates / 2;           // predecessors a lane reads from each of A and B
// lane j keeps state kStates * j + (t ^ (kSpread * j)) in slot t, and a
// candidate's second predecessor arrives kDelta rounds from its first: the
// layout in which every lane sends its slot r in round r and each slot's
// two predecessors arrive in rounds fixed for the slot on every lane (4
// lanes a row, 16 states a lane, was slower at every shape of the paths:
// scripts/torch_viterbi_compare.py builds it as `lanes4`)
constexpr int kSpread = kLanes == 8 ? 1 : 5, kDelta = kLanes == 8 ? 4 : 10;
static_assert(kLanes == 8 || kLanes == 4, "the layout is worked out for 4 or 8 lanes a row");
constexpr int kRows = 32 / kLanes;           // rows per warp, and per block
constexpr int kMaxSmem = 232448;             // a block's most dynamic shared memory on the H100
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBatch = 8;                    // traceback steps whose words are read together
static_assert(kStates == 8 || kStates == 16, "a lane's decisions are one byte or two");
// a lane's decisions of one step, bit i: state kStates * j + i
using Dec = std::conditional_t<kStates == 8, uint8_t, uint16_t>;

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

// kPredCombo[t][0] for t < 16, four bits each, as a constant the compiler
// folds into the unrolled step (the CPU tests hold it to the table)
constexpr unsigned long long kLowCombos = 0x5234254361071670ull;

__host__ __device__ constexpr int low_combo(int t) {
  return static_cast<int>((kLowCombos >> (4 * t)) & 0xf);
}

// shared memory of one block: its rows' bm (K x kRows x 8 f32, step-major),
// then one decision word per row for each of the T - mid steps the
// traceback visits (8 * kRows bytes per step)
__host__ __device__ long long block_bytes(int K, int tb_iter) {
  return static_cast<long long>(kRows) * (32LL * K + 8LL * (tb_iter - tb_iter / 2) * K);
}

// 1.0f where x > 0, else 0.0f (one FSET)
__device__ __forceinline__ float positive(float x) {
  float y;
  asm("set.gt.f32.f32 %0, %1, 0f00000000;" : "=f"(y) : "f"(x));
  return y;
}

// One trellis step of a row: the predecessors' metrics fetched in 8
// independent shuffles (every lane sends its slot r in round r), the
// add-compare-select of the lane's 8 states on the branch metrics q (q[x]:
// the lane's combo base ^ x; slot t on rounds t >> 1 and (t >> 1) ^
// kDelta), and the row's maximum taken
// off (a tree of 7 in the lane, then the row's 8 lane maxima fetched in 7
// independent shuffles and a tree of 7).  kDecide: the step's decisions
// as this lane's bits (slot t's at weight wt[t]: bit t ^ (kSpread * j),
// its state's place in the row's word) in the low bits of the word; the
// steps the traceback does not visit skip
// them.  A decision is `pred 1 > pred 0`, on an odd lane `u > v`: the sign
// sg (-1 there, else 1) times v - u is positive (a tie, either zero, is
// not), and the bits add up in floating point, exactly, to 2^23, the
// float whose low mantissa bits are then the lane's bits: full-rate adds
// and multiplies in place of predicate-to-integer selects.
template <bool kDecide>
__device__ __forceinline__ unsigned acs_step(float (&m)[kStates], const float (&q)[8], float sg,
                                             const float (&wt)[kStates], int src_lo,
                                             int src_hi) {
  float rcv[kStates];  // odd lane: B in rounds < kHalf, A after; even: A then B
#pragma unroll
  for (int r = 0; r < kStates; ++r)
    rcv[r] = __shfl_sync(kFull, m[r], r < kHalf ? src_lo : src_hi, kLanes);
  float n[kStates], tree[kStates];
  float word = 8388608.0f;  // 2^23
#pragma unroll
  for (int t = 0; t < kStates; ++t) {
    const int c = low_combo(t);
    const float u = __fadd_rn(rcv[t >> 1], q[c]);                 // even: pred 0; odd: pred 1
    const float v = __fadd_rn(rcv[(t >> 1) ^ kDelta], q[c ^ 7]);  // even: pred 1; odd: pred 0
    n[t] = tree[t] = fmaxf(u, v);
    if constexpr (kDecide)
      word = __fmaf_rn(positive(__fmul_rn(__fsub_rn(v, u), sg)), wt[t], word);
  }
#pragma unroll
  for (int w = 1; w < kStates; w <<= 1)
#pragma unroll
    for (int t = 0; t < kStates; t += 2 * w) tree[t] = fmaxf(tree[t], tree[t + w]);
  float part[kLanes];  // the row's lanes' maxima: 7 independent shuffles
  part[0] = tree[0];
#pragma unroll
  for (int i = 1; i < kLanes; ++i) part[i] = __shfl_xor_sync(kFull, tree[0], i, kLanes);
#pragma unroll
  for (int w = 1; w < kLanes; w <<= 1)
#pragma unroll
    for (int i = 0; i < kLanes; i += 2 * w) part[i] = fmaxf(part[i], part[i + w]);
  const float mx = part[0];
#pragma unroll
  for (int t = 0; t < kStates; ++t) m[t] = __fsub_rn(n[t], mx);
  return __float_as_uint(word);
}

// q[x]: the branch metric of the lane's combo base ^ x at b, the step k of
// the frame; then b and k one step on (the frame repeats after K steps).
template <int kBStride>
__device__ __forceinline__ void read_step(float (&q)[8], const float*& b, int& k,
                                          const float* sbm, int base, int K) {
#pragma unroll
  for (int x = 0; x < 8; ++x) q[x] = b[base ^ x];
  if (++k == K) k = 0, b = sbm; else b += kBStride;
}

// The branch metrics of the step at b into q.  From shared memory they are
// read at the step; from device memory (kGlobal: the L1's latency) a step
// ahead, through qn, which then holds the next step's.
template <bool kGlobal, int kBStride>
__device__ __forceinline__ void step_metrics(float (&q)[8], float (&qn)[8], const float*& b,
                                             int& k, const float* sbm, int base, int K) {
  if constexpr (kGlobal) {
#pragma unroll
    for (int x = 0; x < 8; ++x) q[x] = qn[x];
    read_step<kBStride>(qn, b, k, sbm, base, K);
  } else {
    read_step<kBStride>(q, b, k, sbm, base, K);
  }
}

// The state before state s, from the decision word of its step.
__device__ __forceinline__ int prev_state(int s, unsigned long long w) {
  return (s >> 1) | static_cast<int>(((w >> s) & 1ull) << 5);
}

// kGlobal: the variant for a K beyond the shared-memory budget, with the
// branch metrics read from device memory and the decision words kept in
// `scratch` ((R, T - mid) words); otherwise both live in shared memory and
// `scratch` is not read.
template <bool kGlobal>
__global__ void __launch_bounds__(32)
viterbi_kernel(const float* __restrict__ bm, int8_t* __restrict__ bits,
               unsigned long long* __restrict__ scratch, int R, int K, int tb_iter) {
  extern __shared__ __align__(16) unsigned char smem[];
  // floats from one step's branch metrics to the next; words from one
  // step's decision word to the next, and this lane's Decs
  constexpr int kBStride = kGlobal ? 8 : 8 * kRows, kDStride = kGlobal ? 1 : kRows;
  constexpr int kOStride = kDStride * static_cast<int>(8 / sizeof(Dec));
  const int lane = threadIdx.x, g = lane / kLanes, j = lane % kLanes;
  const int first = blockIdx.x * kRows;
  const int rows = min(kRows, R - first);  // rows of this warp
  const bool live = g < rows;              // else a copy of the last row, writing nothing
  const int gr = live ? g : rows - 1;      // the row this group computes, in the warp
  const int row = first + gr;
  const int T = tb_iter * K, mid = (tb_iter / 2) * K, D = T - mid;

  const float* sbm;         // bm of this row at step 0
  unsigned long long* dec;  // the row's decision word of traceback step 0
  if constexpr (kGlobal) {
    sbm = bm + static_cast<size_t>(row) * 8 * K;
    dec = scratch + static_cast<size_t>(row) * D;
  } else {
    float4* stage = reinterpret_cast<float4*>(smem);
    const float4* src = reinterpret_cast<const float4*>(bm + static_cast<size_t>(first) * 8 * K);
    const int n = rows * 2 * K;  // float4s of the warp's rows, row-major
#pragma unroll 4
    for (int i = lane; i < n; i += 32) {
      const int r = i / (2 * K), h = i - r * 2 * K;  // h = 2k + half
      stage[(h >> 1) * 2 * kRows + 2 * r + (h & 1)] = src[i];
    }
    sbm = reinterpret_cast<const float*>(smem) + 8 * gr;
    dec = reinterpret_cast<unsigned long long*>(smem + 32LL * kRows * K) + g;
    __syncwarp();
  }

  // the rounds' source lanes in the row (A: j >> 1, B: kLanes / 2 + (j >> 1))
  const bool odd = j & 1;
  const float sg = odd ? -1.0f : 1.0f;
  const int src_lo = (j >> 1) + (odd ? kLanes / 2 : 0);  // rounds r < kHalf
  const int src_hi = (j >> 1) + (odd ? 0 : kLanes / 2);  // rounds r >= kHalf
  // this lane's branch-metric offset: the combo of the branch from
  // predecessor 0 into its slot 0, kPredCombo[kStates * j + a][0] for
  // a = kSpread * j, which the code's linearity splits in two; xored with
  // 7 on an odd lane (which gets B in the rounds an even one gets A)
  const int spread = kSpread * j;
  const int base = kPredCombo[kStates * j][0] ^ low_combo(spread) ^ (odd ? 7 : 0);
  float wt[kStates];  // slot t's decision weight: 2^(bit of its state in the lane's bits)
#pragma unroll
  for (int t = 0; t < kStates; ++t) wt[t] = static_cast<float>(1 << (t ^ spread));

  float m[kStates];
#pragma unroll
  for (int t = 0; t < kStates; ++t) m[t] = 0.0f;
  float q[8], qn[8];  // the branch metrics of the step, and (kGlobal) of the next
  const float* b = sbm;
  int k = 0;  // b's step of the frame
  if constexpr (kGlobal) read_step<kBStride>(qn, b, k, sbm, base, K);
#pragma unroll 2
  for (int t = 0; t < mid; ++t) {  // steps the traceback does not visit
    step_metrics<kGlobal, kBStride>(q, qn, b, k, sbm, base, K);
    acs_step<false>(m, q, sg, wt, src_lo, src_hi);
  }
  Dec* out = reinterpret_cast<Dec*>(dec) + j;  // this lane's bits of the row's word
#pragma unroll 2
  for (int t = mid; t < T; ++t, out += kOStride) {
    step_metrics<kGlobal, kBStride>(q, qn, b, k, sbm, base, K);
    const unsigned word = acs_step<true>(m, q, sg, wt, src_lo, src_hi);
    if (live) *out = static_cast<Dec>(word);
  }

  // the final state: the first maximum, reduced on (value, state)
  float v = m[0];
  int s = kStates * j + spread;
#pragma unroll
  for (int t = 1; t < kStates; ++t) {
    const int st = kStates * j + (t ^ spread);
    if (m[t] > v || (m[t] == v && st < s)) v = m[t], s = st;
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off, kLanes);
    const int os = __shfl_xor_sync(kFull, s, off, kLanes);
    if (ov > v || (ov == v && os < s)) v = ov, s = os;
  }
  __syncwarp();  // every lane's decision bytes before lane 0 of the row reads them

  // the traceback from step T - 1 down to mid, kBatch words read at a time
  // (the reads do not depend on the state): first the steps after the
  // middle copy, then the copy's K steps, whose bits it writes
  if (!live || j != 0) return;
  const unsigned long long* wp = dec + static_cast<size_t>(D - 1) * kDStride;
  int t = T - 1;
  for (; t - (kBatch - 1) >= mid + K; t -= kBatch) {
    unsigned long long w[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) w[i] = wp[-i * kDStride];
    wp -= kBatch * kDStride;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) s = prev_state(s, w[i]);
  }
  for (; t >= mid + K; --t, wp -= kDStride) s = prev_state(s, *wp);
  int8_t* bout = bits + static_cast<size_t>(row) * K + (t - mid);
  for (; t - (kBatch - 1) >= mid; t -= kBatch) {
    unsigned long long w[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) w[i] = wp[-i * kDStride];
    wp -= kBatch * kDStride;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      bout[-i] = static_cast<int8_t>(s & 1);
      s = prev_state(s, w[i]);
    }
    bout -= kBatch;
  }
  for (; t >= mid; --t, wp -= kDStride, --bout) {
    *bout = static_cast<int8_t>(s & 1);
    s = prev_state(s, *wp);
  }
}

}  // namespace

// 1 if either variant takes this K and tb_iter: the global-memory variant
// takes every K up to 65,536 (NB-IoT's largest TBS, 2,536 bits, gives
// K = 2,552).
extern "C" int viterbi_global_fits(int K, int tb_iter) {
  return K > 0 && K <= (1 << 16) && tb_iter > 0 && tb_iter <= (1 << 10);
}

// 1 if a block's shared memory holds its kRows rows of this K and tb_iter.
extern "C" int viterbi_fits(int K, int tb_iter) {
  return viterbi_global_fits(K, tb_iter) && block_bytes(K, tb_iter) <= kMaxSmem;
}

// Rows a block (one warp) decodes.
extern "C" int viterbi_rows_per_block() { return kRows; }

// Thread blocks of the kernel that one SM holds at once for this K and
// tb_iter (the card's occupancy calculator; the variant viterbi_launch
// takes), or -1 on an error.
extern "C" int viterbi_blocks_per_sm(int K, int tb_iter) {
  if (!viterbi_global_fits(K, tb_iter)) return -1;
  int n = 0;
  if (!viterbi_fits(K, tb_iter))
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, viterbi_kernel<true>, 32, 0) ==
                   cudaSuccess
               ? n
               : -1;
  const int bytes = static_cast<int>(block_bytes(K, tb_iter));
  if (cudaFuncSetAttribute(viterbi_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes > 48 * 1024 ? bytes : 48 * 1024) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, viterbi_kernel<false>, 32, bytes) !=
          cudaSuccess)
    return -1;
  return n;
}

// Plain C entry point, loaded with ctypes.  bm: (R, K, 8) float32
// contiguous on the card; bits: (R, K) int8; scratch: for a shape that
// viterbi_fits refuses, (R, (tb_iter - tb_iter / 2) * K) 64-bit decision
// words (8 bytes each: bit s is state s), else unused and may be null.
// Returns the cudaError_t of the launch: cudaErrorInvalidValue for a shape
// that viterbi_global_fits refuses or a missing scratch, and cudaSuccess
// without a launch for R = 0.
extern "C" int viterbi_launch(const void* bm, void* bits, void* scratch, int R, int K,
                              int tb_iter, void* stream) {
  if (R < 0 || !viterbi_global_fits(K, tb_iter)) return static_cast<int>(cudaErrorInvalidValue);
  const bool shared = viterbi_fits(K, tb_iter);
  if (!shared && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (R + kRows - 1) / kRows;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(bm);
  auto* out = static_cast<int8_t*>(bits);
  if (!shared) {
    viterbi_kernel<true><<<blocks, 32, 0, st>>>(
        x, out, static_cast<unsigned long long*>(scratch), R, K, tb_iter);
    return static_cast<int>(cudaGetLastError());
  }
  const int bytes = static_cast<int>(block_bytes(K, tb_iter));
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        viterbi_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  viterbi_kernel<false><<<blocks, 32, bytes, st>>>(x, out, nullptr, R, K, tb_iter);
  return static_cast<int>(cudaGetLastError());
}
