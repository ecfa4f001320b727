// The turbo decoder's half-iteration epilogue and stop test, on the card:
// what keeps the early-stop loop of an LTE turbo decode off the host.
//
// Replaces the body and the condition of the JAX decoder's early-stop
// `lax.while_loop`s (srslte_emane_tpu/ops/fec/turbodecoder.py:421 without
// the cascade, :434 the full batch, :448 each compacted stage; the body's
// epilogue :373-400, the condition :402-406) and the `lax.cond`s that
// route between them (:463, :474, :479).  In JAX the loop, its Pallas MAP
// kernel and this epilogue are one device program.  The port enqueues one
// loop of 2 * max_iter (MAP, epilogue) pairs per decode and never reads:
// the MAP kernels (csrc/turbo_map.cu, csrc/turbo_map_v1.cu) read a `run`
// flag and a row list that this file's kernels write, and after the stop
// each launch reads the flag and returns.
//
// The cascade without gathers: the batch's state stays whole, and a stage
// is a row list [n, r_0, ..., r_{n-1}] of the rows that its passes compute
// (stage 0: every row; stage 1: the first B/2 rows of a stable partition
// with the unfinished rows first, as the reference's argsort(done)[:B/2];
// stage 2: B/4 rows likewise).  Rows are independent, so a pass over the
// listed rows gives the reference's sub-batch bits; every unfinished row
// is listed whenever a pass runs, so the unfinished count over the batch
// is the sub-batch's.
//
// `iter_kernel`, one thread block per listed row, per pass of parity p (0:
// constituent 1 in natural order, 1: constituent 2 in QPP order):
//  * new_ext = (post - ls_in) * 0.75, one rounded subtract then one
//    rounded multiply (no FMA: __fsub_rn, __fmul_rn), kept in shared
//    memory in the pass's order;
//  * the hard bits post < 0, put in natural order (through perm on odd
//    passes: bits[perm[i]] = post[i] < 0, i.e. bits = (post < 0)[inv_perm]);
//  * the CRC as the XOR of the 24-bit remainder masks of the set bits
//    (ops/fec/crc.py `remainder_masks`: crc(m) is linear over GF(2)); the
//    row passes iff it is 0 (never without masks: no CRC);
//  * the freeze: bits_out takes the bits unless the row was done;
//    pass_out |= ok & !done; done |= ok;
//  * the next pass's input in place of this one's: ls2 + ext[perm] after an
//    even pass, ls + ext[inv_perm] after an odd one (one rounded add);
//  * the last block to finish (an atomic ticket after __threadfence) adds
//    the pass's rows to map_rows, advances the half-iteration counter h and
//    runs `advance`.
// `advance` (one block): the loop's condition (h < 2 * max_iter) &
// (undone > stop) for the stage; while it fails and a narrower stage is
// left, the next stage's row list, and its condition; then the flag.  So
// the reference's entry at the narrowest stage that fits and its fall
// through to the next stage both happen on the card.  `arm_kernel` runs
// it once at the decode's start, as JAX evaluates the condition before the
// first trip.
//
// ctl, int32 on the card: [h, run, ticket, map_rows, undone at the last
// test, stage, 0, 0]; rows, int32: [n, r_0, ..., r_{B-1}].
//
// What bounds it (H100 SXM, 3.35 TB/s): memory.  Per element it reads
// post, ls_in and one of ls / ls2 (f32) and writes ls_in (f32) and the bits
// (int8): 17 B, 71.9 MB at 768 x K=5504, 21.5 us; the tables (perm,
// inv_perm, the masks: 4 B per position each) stay in L2.  The design:
// a block per row (the rows of one launch are independent; the per-row CRC
// and the in-place update need only block barriers), coalesced loads and
// stores in natural index order, the permuted reads in shared memory
// (5 B per position, 30 KB at K=6144), and the cross-row work (the stop
// test, the next stage's list) in the one block that finishes last, so a
// pass is one launch.  `turbo_iter_decode` enqueues a decode's whole loop
// from C: the host pays one launch call per kernel, not a Python call.
// Bit for bit against its plain version (ops/fec/turbo_iter_cuda.py
// `turbo_iter_ref`): the same rounded operations in the same order, and
// exact integer work otherwise.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 8192;  // 5 B of shared memory per position: 40 KB
constexpr float kExtScale = 0.75f;
enum { kH = 0, kRun = 1, kTicket = 2, kRows = 3, kUndone = 4, kStage = 5 };

// The stages of a decode with n_stages of them (1: no cascade; 3: the
// cascade): the rows each computes and the unfinished count it stops at.
__device__ int stage_width(int stage, int B) { return B >> stage; }
__device__ int stage_stop(int stage, int B, int n_stages) {
  return stage + 1 < n_stages ? B >> (stage + 1) : 0;
}

// The block-wide sum of v, on every thread (no shared state outlives it).
__device__ int block_sum(int v) {
  __shared__ int part[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += part[w];
  return total;
}

// Rows of `done` (B of them) that are 0, on every thread of the block.
// Volatile loads: other blocks wrote `done` in this launch.
__device__ int count_undone(const unsigned char* done, int B) {
  const volatile unsigned char* d = done;
  int c = 0;
  for (int i = threadIdx.x; i < B; i += kThreads) c += d[i] == 0;
  return block_sum(c);
}

// rows = [width, the first `width` rows of the stable partition of 0..B-1
// with the unfinished rows first] (the reference's argsort(done)[:width]).
// Each thread takes a contiguous chunk; a scan of the chunks' unfinished
// counts places them.
__device__ void partition(int* rows, const unsigned char* done, int B, int width) {
  __shared__ int before[kThreads + 1];  // unfinished rows before chunk t
  const volatile unsigned char* d = done;
  const int chunk = (B + kThreads - 1) / kThreads;
  const int lo = min(B, threadIdx.x * chunk), hi = min(B, lo + chunk);
  int mine = 0;
  for (int i = lo; i < hi; ++i) mine += d[i] == 0;
  __syncthreads();
  before[threadIdx.x + 1] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    before[0] = 0;
    for (int t = 1; t <= kThreads; ++t) before[t] += before[t - 1];
  }
  __syncthreads();
  const int total = before[kThreads];
  int u = before[threadIdx.x], f = total + lo - before[threadIdx.x];
  for (int i = lo; i < hi; ++i) {
    const int at = d[i] == 0 ? u++ : f++;
    if (at < width) rows[1 + at] = i;
  }
  if (threadIdx.x == 0) rows[0] = width;
  __syncthreads();
}

// The loop's condition for the next pass, after h half-iterations, with
// `undone` unfinished rows: (h < 2 * max_iter) & (undone > the stage's
// stop); while it fails and a narrower stage is left, enter that stage
// (its row list) and test again.  Then the flag.  All threads of one block.
__device__ void advance(int* ctl, int* rows, const unsigned char* done, int B, int max_iter,
                        int n_stages, int undone) {
  const int h = ctl[kH];
  int stage = ctl[kStage];
  bool go = h < 2 * max_iter && undone > stage_stop(stage, B, n_stages);
  while (!go && stage + 1 < n_stages) {
    ++stage;
    partition(rows, done, B, stage_width(stage, B));
    go = h < 2 * max_iter && undone > stage_stop(stage, B, n_stages);
  }
  __syncthreads();  // every thread has read ctl before thread 0 writes it
  if (threadIdx.x == 0) {
    ctl[kStage] = stage;
    ctl[kRun] = go;
    ctl[kUndone] = undone;
  }
}

__global__ void __launch_bounds__(kThreads)
iter_kernel(const float* __restrict__ post, float* __restrict__ ls_in,
            const float* __restrict__ ls, const float* __restrict__ ls2,
            const int* __restrict__ perm, const int* __restrict__ inv_perm,
            const int* __restrict__ masks, int8_t* __restrict__ bits_out, unsigned char* done,
            unsigned char* __restrict__ pass_out, int* ctl, int* rows, int B, int K,
            int parity, int max_iter, int n_stages) {
  if (ctl[kRun] == 0) return;
  const int width = rows[0];
  if (static_cast<int>(blockIdx.x) >= width) return;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_ext = reinterpret_cast<float*>(smem);  // new_ext in the pass's order
  unsigned char* s_bit = smem + 4 * K;            // hard bits in natural order
  __shared__ unsigned part[kWarps];
  __shared__ bool last;
  const int row = rows[1 + blockIdx.x];
  const size_t off = static_cast<size_t>(row) * K;
  const bool was_done = done[row] != 0;

  for (int i = threadIdx.x; i < K; i += kThreads) {
    const float p = post[off + i];
    s_ext[i] = __fmul_rn(__fsub_rn(p, ls_in[off + i]), kExtScale);
    s_bit[parity ? perm[i] : i] = p < 0.0f;
  }
  __syncthreads();  // every read of this row's ls_in is done: update in place

  unsigned rem = 0;
  for (int j = threadIdx.x; j < K; j += kThreads) {
    const unsigned char b = s_bit[j];
    if (b && masks != nullptr) rem ^= static_cast<unsigned>(masks[j]);
    if (!was_done) bits_out[off + j] = static_cast<int8_t>(b);
    ls_in[off + j] = parity ? __fadd_rn(ls[off + j], s_ext[inv_perm[j]])
                            : __fadd_rn(ls2[off + j], s_ext[perm[j]]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) rem ^= __shfl_xor_sync(0xffffffffu, rem, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = rem;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned r = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) r ^= part[w];
    const bool ok = masks != nullptr && r == 0;
    if (ok && !was_done) pass_out[row] = 1;
    if (ok) done[row] = 1;
    __threadfence();  // this row's writes before the ticket
    last = atomicAdd(&ctl[kTicket], 1) == width - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x == 0) {
    ctl[kTicket] = 0;
    ctl[kRows] += width;
    ctl[kH] += 1;
  }
  const int undone = count_undone(done, B);  // its barriers publish ctl to the block
  advance(ctl, rows, done, B, max_iter, n_stages, undone);
}

// A decode's start: every row listed, stage 0, then `advance` from h.
__global__ void __launch_bounds__(kThreads)
arm_kernel(const unsigned char* done, int* ctl, int* rows, int B, int max_iter, int n_stages) {
  for (int i = threadIdx.x; i < B; i += kThreads) rows[1 + i] = i;
  if (threadIdx.x == 0) {
    rows[0] = B;
    ctl[kTicket] = 0;
    ctl[kStage] = 0;
  }
  const int undone = count_undone(done, B);  // its barriers publish ctl to the block
  advance(ctl, rows, done, B, max_iter, n_stages, undone);
}

bool valid(int B, int K, int max_iter, int n_stages) {
  return B > 0 && K > 0 && K <= kMaxK && max_iter >= 0 && (n_stages == 1 || n_stages == 3);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  post, ls_in, ls, ls2: (B, K)
// float32; perm, inv_perm: (K,) int32 (the QPP interleaver and its
// inverse); masks: (K,) int32 CRC remainder masks, or null for no CRC;
// bits_out: (B, K) int8; done, pass_out: (B,) bool; ctl: (8,) int32;
// rows: (B + 1,) int32; all contiguous on one card.  parity: 0 or 1, the
// pass's constituent; n_stages: 1 (no cascade) or 3.  Each returns the
// cudaError_t of its launches.
extern "C" int turbo_iter_launch(const void* post, void* ls_in, const void* ls, const void* ls2,
                                 const void* perm, const void* inv_perm, const void* masks,
                                 void* bits_out, void* done, void* pass_out, void* ctl,
                                 void* rows, int B, int K, int parity, int max_iter,
                                 int n_stages, void* stream) {
  if (!valid(B, K, max_iter, n_stages) || (parity != 0 && parity != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  iter_kernel<<<B, kThreads, 5 * K, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(post), static_cast<float*>(ls_in),
      static_cast<const float*>(ls), static_cast<const float*>(ls2),
      static_cast<const int*>(perm), static_cast<const int*>(inv_perm),
      static_cast<const int*>(masks), static_cast<int8_t*>(bits_out),
      static_cast<unsigned char*>(done), static_cast<unsigned char*>(pass_out),
      static_cast<int*>(ctl), static_cast<int*>(rows), B, K, parity, max_iter, n_stages);
  return static_cast<int>(cudaGetLastError());
}

// A decode's start (one block): every row listed, stage 0, the flag.
extern "C" int turbo_iter_arm(const void* done, void* ctl, void* rows, int B, int max_iter,
                              int n_stages, void* stream) {
  if (B <= 0 || max_iter < 0 || (n_stages != 1 && n_stages != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  arm_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(done), static_cast<int*>(ctl), static_cast<int*>(rows),
      B, max_iter, n_stages);
  return static_cast<int>(cudaGetLastError());
}

// The MAP kernels' C entry points (csrc/turbo_map.cu, csrc/turbo_map_v1.cu),
// whose addresses the caller passes in from their own libraries.
typedef int (*MapLaunch)(const void* ls, const void* lp, const void* beta_tail, void* llr,
                         int n_cols, int W, int L, int H, int narrow, int logmap,
                         const void* run, const void* rows, void* stream);
typedef int (*MapV1Launch)(const void* ls, const void* lp, const void* beta_tail, void* llr,
                           int n_cols, int W, int L, int H, int logmap, const void* run,
                           const void* rows, void* stream);

// A decode's whole loop, enqueued from C so that the host pays a launch
// call and not a Python call per kernel: the arm launch, then 2 * max_iter
// slots of a MAP launch (map_launch: turbo_map_launch, or
// turbo_map_v1_launch when v1 is set, on ls_in with lp1 / beta_k1 on even
// slots and lp2 / beta_k2 on odd ones, into post, predicated on ctl[run]
// and restricted to the row list) and an epilogue launch of the same
// parity.  Slot s runs pass h = s or nothing: the passes are consecutive
// until the flag clears, and it never sets again.  lp1, lp2, post: (B, K)
// float32; beta_k1, beta_k2: (B, 8) float32; the rest as for
// turbo_iter_launch.  Returns the first non-zero cudaError_t, or 0.
extern "C" int turbo_iter_decode(const void* map_launch, int v1, const void* lp1,
                                 const void* lp2, const void* beta_k1, const void* beta_k2,
                                 void* post, int W, int L, int H, int narrow, int logmap,
                                 void* ls_in, const void* ls, const void* ls2, const void* perm,
                                 const void* inv_perm, const void* masks, void* bits_out,
                                 void* done, void* pass_out, void* ctl, void* rows, int B, int K,
                                 int max_iter, int n_stages, void* stream) {
  if (map_launch == nullptr || !valid(B, K, max_iter, n_stages))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = turbo_iter_arm(done, ctl, rows, B, max_iter, n_stages, stream);
  const int* run = static_cast<const int*>(ctl) + kRun;
  for (int slot = 0; slot < 2 * max_iter && err == 0; ++slot) {
    const int p = slot & 1;
    const void* lp = p ? lp2 : lp1;
    const void* bk = p ? beta_k2 : beta_k1;
    err = v1 ? reinterpret_cast<MapV1Launch>(const_cast<void*>(map_launch))(
                   ls_in, lp, bk, post, B * W, W, L, H, logmap, run, rows, stream)
             : reinterpret_cast<MapLaunch>(const_cast<void*>(map_launch))(
                   ls_in, lp, bk, post, B * W, W, L, H, narrow, logmap, run, rows, stream);
    if (err == 0)
      err = turbo_iter_launch(post, ls_in, ls, ls2, perm, inv_perm, masks, bits_out, done,
                              pass_out, ctl, rows, B, K, p, max_iter, n_stages, stream);
  }
  return err;
}
