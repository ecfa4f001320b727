// The DL-SCH / UL-SCH transport-block encode of 36.212 §5.1 for a batch of
// rows, one code block per thread block, from payload bits to codeword bits:
// the TB CRC24A, code-block segmentation with its fillers and CB CRC24Bs,
// the rate-1/3 turbo encoder (both constituents, the QPP interleaver, the
// tail bits) and the rate matcher's bit selection, straight into the (B, G)
// int8 codeword.
//
// It replaces no Pallas kernel: the JAX package leaves this encode to XLA
// (srslte_emane_tpu/phch/sch.py `encode_tb`), and the port's plain version,
// phch/sch.py `encode_tb` over ops/fec/{crc,turbo,rm_turbo}.py, runs it as
// float32 GEMMs with remainders, gathers and cats: a hundred-odd small
// launches and float32 intermediates.  It computes the same bits.
//
// What bounds it (H100 SXM, 3.35 TB/s): bytes.  It must read the payload
// (one int8 a bit) and write the codeword (one int8 a bit): at the
// benchmark's shape, 128 rows of TBS 51,024 into G = 90,000, 18.05 MB, or
// 5.4 us; its tables (a few KB, and the rate matcher's source table of
// 2 V bytes a code-block size) stay in L2.  The work per bit is a few
// integer operations.  What the design does about that:
//  * every intermediate stays in shared memory: a block (256 threads, one a
//    32-bit word of a code block, K <= 6,144, each) loads its code
//    block's bits once, 16 bytes a thread, into d0 (the systematic stream,
//    one byte a bit), computes the CRCs and both constituents from there
//    into d1 and d2, and writes its E bits of the codeword once, coalesced;
//  * a CRC is linear, so each thread folds one 32-bit word of the message
//    through a byte-wise table (4 lookups), weighs it by x^(32 (255 - t))
//    mod g (a table), and the block XORs the words' remainders: no serial
//    loop over the bits.  The message ends at word 255; zeros before it
//    change no CRC;
//  * the RSC constituents: thread t encodes word t of the block (32 input
//    bits) on a state x byte table (4 lookups) from state 0, a scan over
//    the words finds each word's true entry state (the state is 3 bits,
//    and a word moves it by A^32 plus its zero-state end state), and each
//    thread encodes its word again from that state: two passes of 4
//    lookups, no 6,144-step loop.  The interleaver (f1 i + f2 i^2) mod K is
//    stepped by differences, on the fly;
//  * the d-streams sit in shared memory at kStride apart; the rate
//    matcher's table (`rm_turbo._cyclic_tables`' z_src, remapped to that
//    layout on the host) gives output bit j of rv as d[z[(start_rv + j) mod
//    V]], start_rv from the launch's rv or from each row's rv_b, so one
//    kernel serves `rate_match_tx` and `rate_match_tx_dyn`, Ncb included;
//  * the TB CRC24A lies in the last code block, whose block needs the whole
//    TB's.  For C > 1 a first kernel (`sch_tb_crc_kernel`, the same grid)
//    leaves each code block's share of it, weighed by x^(bits after it)
//    mod g, in a scratch tensor, and the last block XORs them: two
//    launches.  For C = 1 the block computes it itself: one launch.
// Each block adds one to a device counter (one atomicAdd), so that a run
// can count the code blocks encoded, a CUDA graph's replays included.
//
// Host tables (ops/fec/sch_encode_cuda.py, built and checked on the CPU):
// tabs, at the kTab* offsets: the two CRCs' byte tables and word weights,
// the RSC table (entry s * 256 + v: parity byte | next state << 8, MSB
// first, state r0 + 2 r1 + 4 r2), A^p s for p < 7, the tail bits of each
// final state; plan, kPlanLen ints per code block (the P_* fields); zmap.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 6144;
// a block's threads: one 32-bit word each of a code block, 8 blocks an SM
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStride = 6176;  // d-stream s starts at byte s * kStride: 32 * ceil((kMaxK + 4) / 32)
static_assert(kStride % 32 == 0 && kStride >= kMaxK + 24, "words may read 24 bytes past K");
constexpr unsigned kFull = 0xffffffffu;

// tabs offsets (sch_encode_cuda.TAB_*)
constexpr int kTabCrcA = 0, kTabCrcB = 256, kTabPowA = 512, kTabPowB = 768;  // 256 each
constexpr int kTabRsc = 1024, kTabApow = 3072, kTabTail = 3128;
// plan fields (sch_encode_cuda.P_*)
constexpr int kK = 0, kF = 1, kSrc = 2, kNdata = 3, kNtb = 4, kTbPow = 5, kOut = 6, kE = 7,
              kV = 8, kZoff = 9, kStart = 10, kF1 = 14, kF2 = 15, kPlanLen = 16;

// 8 bits, one per byte (bit 0), the first at the lowest address -> one byte,
// the first bit its MSB
__device__ __forceinline__ uint32_t pack8(uint64_t v) {
  return static_cast<uint32_t>(((v & 0x0101010101010101ull) * 0x8040201008040201ull) >> 56);
}

// the inverse: byte p, MSB first -> 8 bytes of 0/1, the MSB at the lowest address
__device__ __forceinline__ uint64_t expand8(uint32_t p) {
  const uint64_t x = (static_cast<uint64_t>(p) * 0x0101010101010101ull) & 0x0102040810204080ull;
  return ((x + 0x7f7f7f7f7f7f7f7full) >> 7) & 0x0101010101010101ull;
}

// one byte through a CRC's table: the remainder of (s(x) x^8 + byte(x) x^24) mod g
__device__ __forceinline__ uint32_t crc_byte(uint32_t s, uint32_t byte, const uint32_t* tab) {
  return ((s << 8) & 0xffffffu) ^ tab[((s >> 16) ^ byte) & 0xffu];
}

// a(x) b(x) mod g for 24-bit a, b: a carry-less product, whose high 23
// bits are then reduced through the table
__device__ uint32_t mulmod(uint32_t a, uint32_t b, const uint32_t* tab) {
  uint64_t p = 0;
#pragma unroll
  for (int i = 0; i < 24; ++i) p ^= static_cast<uint64_t>((a >> i) & 1u ? b : 0u) << i;
  const uint32_t hi = static_cast<uint32_t>(p >> 24);
  uint32_t r = crc_byte(0u, hi >> 16, tab);
  r = crc_byte(r, (hi >> 8) & 0xffu, tab);
  r = crc_byte(r, hi & 0xffu, tab);
  return r ^ static_cast<uint32_t>(p & 0xffffffu);
}

// dst[i] = bit 0 of src[i] for i < n, by the whole block: 16-byte loads
// between src's first and last 16-byte boundaries (each thread's chunks
// independent, so their loads overlap), single bytes at the two ends.
__device__ void load_bits(uint8_t* dst, const int8_t* __restrict__ src, int n) {
  const int t = threadIdx.x;
  const int head = min(n, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15));
  const int chunks = (n - head) >> 4;
  const int tail = head + 16 * chunks;
  if (t < head) dst[t] = static_cast<uint8_t>(src[t] & 1);
  if (t < n - tail) dst[tail + t] = static_cast<uint8_t>(src[tail + t] & 1);
  const uint4* v = reinterpret_cast<const uint4*>(src + head);
  uint8_t* o = dst + head;
  if ((reinterpret_cast<uintptr_t>(o) & 3) == 0) {
#pragma unroll 4
    for (int c = t; c < chunks; c += kThreads) {
      const uint4 w = __ldg(v + c);
      uint32_t* q = reinterpret_cast<uint32_t*>(o + 16 * c);
      q[0] = w.x & 0x01010101u;
      q[1] = w.y & 0x01010101u;
      q[2] = w.z & 0x01010101u;
      q[3] = w.w & 0x01010101u;
    }
  } else {
#pragma unroll 4
    for (int c = t; c < chunks; c += kThreads) {
      const uint4 w = __ldg(v + c);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int k = 0; k < 16; ++k)
        o[16 * c + k] = static_cast<uint8_t>((words[k >> 2] >> (8 * (k & 3))) & 1u);
    }
  }
}

// The CRC remainder (zero initial state) of the n bits bits[0, n), one a
// byte (bit 0), n a multiple of 8 and at most 32 * kThreads, bits 8-byte
// aligned; every thread of the block calls it and gets the remainder.
// Thread t folds word t of the message padded in front to kThreads words.
__device__ uint32_t block_crc(const uint8_t* bits, int n, const uint32_t* tab,
                              const int32_t* __restrict__ pow, uint32_t* red) {
  const int t = threadIdx.x;
  const int first = 32 * t - (32 * kThreads - n);  // the word's first bit; below 0: padding
  uint32_t s = 0;
  if (first > -32) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int off = first + 8 * u;
      const uint32_t byte =
          off >= 0 ? pack8(*reinterpret_cast<const uint64_t*>(bits + off)) : 0u;
      s = crc_byte(s, byte, tab);
    }
    s = mulmod(s, static_cast<uint32_t>(__ldg(pow + t)), tab);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s ^= __shfl_xor_sync(kFull, s, o);
  if ((t & 31) == 0) red[t >> 5] = s;
  __syncthreads();
  uint32_t r = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) r ^= red[w];
  __syncthreads();  // red is free again
  return r;
}

// Block (b, r), blockIdx.x = b * C + r: code block r's share of row b's TB
// CRC24A, its payload bits' remainder times x^(tbs - their end) mod g.
__global__ void __launch_bounds__(kThreads)
    sch_tb_crc_kernel(const int8_t* __restrict__ payload, int tbs, int C,
                      const int32_t* __restrict__ plan, const int32_t* __restrict__ tabs,
                      int32_t* __restrict__ partial) {
  __shared__ __align__(16) uint8_t bits[kMaxK + 8];
  __shared__ uint32_t tab[256];
  __shared__ uint32_t red[kWarps];
  const int t = threadIdx.x;
  const int b = blockIdx.x / C, r = blockIdx.x % C;
  const int32_t* p = plan + r * kPlanLen;
  const int ntb = p[kNtb];
  const int pad = (8 - ntb % 8) % 8;  // zeros in front, to whole bytes
  const int8_t* row = payload + static_cast<size_t>(b) * tbs + p[kSrc];
  for (int i = t; i < 256; i += kThreads) tab[i] = static_cast<uint32_t>(tabs[kTabCrcA + i]);
  if (t < pad) bits[t] = 0;
  load_bits(bits + pad, row, ntb);
  __syncthreads();
  const uint32_t rem = block_crc(bits, ntb + pad, tab, tabs + kTabPowA, red);
  if (t == 0) partial[blockIdx.x] = static_cast<int32_t>(mulmod(rem, p[kTbPow], tab));
}

// Block (b, r), blockIdx.x = b * C + r: code block r of row b, from its
// payload bits to its E bits of the codeword.
__global__ void __launch_bounds__(kThreads)
    sch_encode_kernel(const int8_t* __restrict__ payload, int8_t* __restrict__ out, int tbs,
                      int G, int C, const int32_t* __restrict__ plan,
                      const int16_t* __restrict__ zmap, const int32_t* __restrict__ tabs,
                      const int32_t* __restrict__ partial, int rv, const void* __restrict__ rv_b,
                      int rv_bytes, unsigned long long* __restrict__ count) {
  __shared__ __align__(16) uint8_t d[3 * kStride];  // d0 | d1 | d2, each K + 4 bits
  __shared__ uint16_t rsc[8 * 256];
  __shared__ uint32_t tab[256];
  __shared__ uint8_t apow[7 * 8];
  __shared__ uint32_t red[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x / C, r = blockIdx.x % C;
  const int32_t* p = plan + r * kPlanLen;
  const int K = p[kK], F = p[kF], src = p[kSrc], ndata = p[kNdata];
  const int crc_at = C > 1 ? kTabCrcB : kTabCrcA;
  for (int i = t; i < 256; i += kThreads) tab[i] = static_cast<uint32_t>(tabs[crc_at + i]);
  for (int i = t; i < 8 * 256; i += kThreads) rsc[i] = static_cast<uint16_t>(tabs[kTabRsc + i]);
  if (t < 7 * 8) apow[t] = static_cast<uint8_t>(tabs[kTabApow + t]);

  // d0: the fillers, then the code block's bits of the TB + CRC24A stream
  uint8_t* d0 = d;
  uint32_t tbcrc = 0;  // C > 1: the XOR of the code blocks' shares
  if (C > 1 && src + ndata > tbs)
    for (int q = 0; q < C; ++q) tbcrc ^= static_cast<uint32_t>(partial[b * C + q]);
  const int npay = max(0, min(ndata, tbs - src));  // payload bits; the rest, the TB CRC's
  for (int i = t; i < F; i += kThreads) d0[i] = 0;
  load_bits(d0 + F, payload + static_cast<size_t>(b) * tbs + src, npay);
  for (int i = npay + t; i < ndata; i += kThreads)
    d0[F + i] = static_cast<uint8_t>((tbcrc >> (23 - (src + i - tbs))) & 1u);
  __syncthreads();
  if (C == 1) {  // the TB CRC24A, over the fillers and the payload
    const uint32_t rem = block_crc(d0, F + tbs, tab, tabs + kTabPowA, red);
    if (t < 24) d0[F + tbs + t] = static_cast<uint8_t>((rem >> (23 - t)) & 1u);
  } else {  // the CB CRC24B, over the fillers and the data
    const uint32_t rem = block_crc(d0, K - 24, tab, tabs + kTabPowB, red);
    if (t < 24) d0[K - 24 + t] = static_cast<uint8_t>((rem >> (23 - t)) & 1u);
  }
  __syncthreads();

  // the constituents: thread t encodes word t (bits 32t .. 32t + 31) of
  // the input (w1) and of the interleaved input (w2), MSB first
  const int nw = (K + 31) >> 5;
  int nb = 0;  // the word's bytes inside K
  uint32_t w1 = 0, w2 = 0, y = 0;  // y: a pair of states, constituent 1 in bits 0-2, 2 in 3-5
  if (t < nw) {
    nb = min(4, (K - 32 * t) >> 3);
    const uint64_t* x = reinterpret_cast<const uint64_t*>(d0 + 32 * t);
#pragma unroll
    for (int u = 0; u < 4; ++u) w1 = (w1 << 8) | pack8(x[u]);
    const long long i0 = 32 * t, f1 = p[kF1], f2 = p[kF2];
    int pi = static_cast<int>((f1 * i0 + f2 * i0 * i0) % K);  // pi(i0)
    int step = static_cast<int>((f1 + f2 * (2 * i0 + 1)) % K);  // pi(i + 1) - pi(i)
    const int accel = static_cast<int>((2 * f2) % K);
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      w2 = (w2 << 1) | d0[pi];
      pi += step;
      if (pi >= K) pi -= K;
      step += accel;
      if (step >= K) step -= K;
    }
    uint32_t s1 = 0, s2 = 0;  // pass 1: the word's end states from state 0
    for (int u = 0; u < nb; ++u) {
      const int sh = 24 - 8 * u;
      s1 = rsc[(s1 << 8) | ((w1 >> sh) & 0xffu)] >> 8;
      s2 = rsc[(s2 << 8) | ((w2 >> sh) & 0xffu)] >> 8;
    }
    y = s1 | (s2 << 3);
  }
  // A^q applied to both states of a pair
  auto apply = [&](int q, uint32_t v) -> uint32_t {
    return apow[q * 8 + (v & 7u)] | (static_cast<uint32_t>(apow[q * 8 + (v >> 3)]) << 3);
  };
  // entry state of word t: the sum over words j < t of A^(32 (t - 1 - j))
  // times word j's end state from 0 (every word before the last is 32 bits;
  // A^32 = A^4, since A^7 = I).  An inclusive scan in the warp ...
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t v = __shfl_up_sync(kFull, y, o);
    if (lane >= o) y ^= apply((4 * o) % 7, v);
  }
  uint32_t e = __shfl_up_sync(kFull, y, 1);
  if (lane == 0) e = 0;
  __shared__ uint32_t totals[kWarps];
  if (lane == 31) totals[warp] = y;
  __syncthreads();
  // ... then the warps before: a warp of 32 words moves a state by A^(32 * 32) = A^2
  uint32_t enter = 0;
  for (int w = 0; w < warp; ++w) enter = apply(2, enter) ^ totals[w];
  e ^= apply((4 * lane) % 7, enter);

  if (t < nw) {  // pass 2: the parity bits from the true entry states
    uint8_t* d1 = d + kStride;
    uint8_t* d2 = d + 2 * kStride;
    uint32_t s1 = e & 7u, s2 = e >> 3;
    for (int u = 0; u < nb; ++u) {
      const int sh = 24 - 8 * u;
      const uint32_t a = rsc[(s1 << 8) | ((w1 >> sh) & 0xffu)];
      const uint32_t c = rsc[(s2 << 8) | ((w2 >> sh) & 0xffu)];
      s1 = a >> 8;
      s2 = c >> 8;
      *reinterpret_cast<uint64_t*>(d1 + 32 * t + 8 * u) = expand8(a & 0xffu);
      *reinterpret_cast<uint64_t*>(d2 + 32 * t + 8 * u) = expand8(c & 0xffu);
    }
    if (t == nw - 1) {  // the tails: (x_K, z_K, x_K+1, z_K+1, x_K+2, z_K+2) per encoder
      const uint32_t t1 = static_cast<uint32_t>(tabs[kTabTail + s1]);
      const uint32_t t2 = static_cast<uint32_t>(tabs[kTabTail + s2]);
      const uint32_t d0_tail[4] = {t1, t1 >> 3, t2, t2 >> 3};
      const uint32_t d1_tail[4] = {t1 >> 1, t1 >> 4, t2 >> 1, t2 >> 4};
      const uint32_t d2_tail[4] = {t1 >> 2, t1 >> 5, t2 >> 2, t2 >> 5};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        d0[K + k] = static_cast<uint8_t>(d0_tail[k] & 1u);
        d1[K + k] = static_cast<uint8_t>(d1_tail[k] & 1u);
        d2[K + k] = static_cast<uint8_t>(d2_tail[k] & 1u);
      }
    }
  }
  __syncthreads();

  // bit selection: out[j] = d[z[(start + j) mod V]], j < E
  const int E = p[kE], V = p[kV];
  const int16_t* z = zmap + p[kZoff];
  int q = rv;
  if (rv_bytes == 4) q = static_cast<const int32_t*>(rv_b)[b] & 3;
  if (rv_bytes == 8) q = static_cast<int>(static_cast<const int64_t*>(rv_b)[b] & 3);
  int idx = (p[kStart + q] + t) % V;
  const int skip = kThreads % V;
  int8_t* o = out + static_cast<size_t>(b) * G + p[kOut];
#pragma unroll 4
  for (int j = t; j < E; j += kThreads) {
    o[j] = static_cast<int8_t>(d[__ldg(z + idx)]);
    idx += skip;
    if (idx >= V) idx -= V;
  }
  if (t == 0) atomicAdd(count, 1ull);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  payload: (B, tbs) int8 0/1;
// out: (B, G) int8; plan: (C, kPlanLen) int32; zmap: int16; tabs: int32;
// partial: (B * C,) int32 scratch for C > 1; rv 0-3, or rv_b: (B,) int32
// (rv_bytes 4) or int64 (8) when rv_bytes is not 0; count: one int64.
// All on the card, contiguous.  Enqueues sch_tb_crc_kernel (C > 1) and
// sch_encode_kernel on the stream; returns the cudaError_t after each launch
// (cudaErrorInvalidValue for arguments the kernels do not take, and
// cudaSuccess without a launch for B = 0).
extern "C" int sch_encode_launch(const void* payload, void* out, int B, int tbs, int G, int C,
                                 const void* plan, const void* zmap, const void* tabs,
                                 void* partial, int rv, const void* rv_b, int rv_bytes,
                                 void* count, void* stream) {
  const bool rv_ok = rv_bytes == 0 ? rv >= 0 && rv <= 3
                                   : (rv_bytes == 4 || rv_bytes == 8) && rv_b != nullptr;
  if (B < 0 || tbs < 1 || G < 0 || C < 1 || !rv_ok ||
      static_cast<long long>(B) * C > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* bits = static_cast<const int8_t*>(payload);
  const auto* rows = static_cast<const int32_t*>(plan);
  const auto* t = static_cast<const int32_t*>(tabs);
  auto* shares = static_cast<int32_t*>(partial);
  if (C > 1) {
    sch_tb_crc_kernel<<<B * C, kThreads, 0, st>>>(bits, tbs, C, rows, t, shares);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sch_encode_kernel<<<B * C, kThreads, 0, st>>>(
      bits, static_cast<int8_t*>(out), tbs, G, C, rows, static_cast<const int16_t*>(zmap), t,
      shares, rv, rv_b, rv_bytes, static_cast<unsigned long long*>(count));
  return static_cast<int>(cudaGetLastError());
}
