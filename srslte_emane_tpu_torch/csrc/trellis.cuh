// The 8-state LTE RSC trellis and the per-step recursions shared by the
// MAP kernels (turbo_map.cu, turbo_map_v1.cu).  State s = r0*4 + r1*2 + r2,
// as in ops/fec/turbodecoder._trellis; branch metrics g[4] are indexed by
// the combo u*2 + z of a transition's input u and parity z.
#pragma once

#include <cuda_runtime.h>

namespace trellis {

constexpr float kNeg = -1e30f;

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

// max* (log-MAP, half-scale correction) or plain max (max-log-MAP)
template <bool LOGMAP>
__device__ __forceinline__ float max_star(float a, float b) {
  float m = fmaxf(a, b);
  if (LOGMAP) m += 0.5f * log1pf(expf(-2.0f * fabsf(a - b)));
  return m;
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

// max over 8 values as a tree (3 dependent steps; every max is exact, so
// the order moves no bit)
__device__ __forceinline__ float max8(const float (&x)[8]) {
  return fmaxf(fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3])),
               fmaxf(fmaxf(x[4], x[5]), fmaxf(x[6], x[7])));
}

__device__ __forceinline__ void normalise(float (&x)[8]) {
  const float m = max8(x);
#pragma unroll
  for (int s = 0; s < 8; ++s) x[s] -= m;
}

// Posterior m0 - m1 at one step: m_u = max_s alpha[s] + g[combo(s, u)] +
// beta'[next_state(s, u)], beta' the stored beta at the next node.
__device__ __forceinline__ float posterior(const float (&alpha)[8], const float (&g)[4],
                                           const float (&bn)[8]) {
  float m0 = alpha[0] + g[combo(0, 0)] + bn[next_state(0, 0)];
  float m1 = alpha[0] + g[combo(0, 1)] + bn[next_state(0, 1)];
#pragma unroll
  for (int s = 1; s < 8; ++s) {
    m0 = fmaxf(m0, alpha[s] + g[combo(s, 0)] + bn[next_state(s, 0)]);
    m1 = fmaxf(m1, alpha[s] + g[combo(s, 1)] + bn[next_state(s, 1)]);
  }
  return m0 - m1;
}

}  // namespace trellis
