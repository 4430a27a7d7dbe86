// M3P2I multi-modal importance weights, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel m3p2i_aip_tpu/ops/pallas_kernels.py::_weights_kernel
// (wrapper multimodal_weights_pallas, :189).  From the [K, T] rollout costs
// it computes the discounted cost-to-go tc[k] = sum_t cost[k, t] * gamma[t],
// shifts each of three sample groups by its own minimum (group 0: k < half_K,
// group 1: k >= half_K, group 2: all k), and runs the adaptive inverse
// temperature search of the reference (m3p2i.py:24-64): beta starts at 1 on
// every call and is multiplied by 0.9 while eta = sum exp(-c / beta) > eta_u,
// or by 1.2 while eta < eta_l, for at most 64 iterations.  Output: the three
// normalised weight vectors, rows of out[3, K].
//
// The entry point takes B seeds at once, so it also replaces the TPU kernel's
// grid=(B,) call
// (pallas_kernels.py:173, the custom_vmap rule _mmw_vmap :157, which the
// multi-seed runner reaches under jax.vmap): cost [B, K, T], one shared
// gamma [T], out [B, 3, K].  Block b solves seed b alone, with its own tc[K]
// in shared memory, its own three betas and its own early-exit flag, so a
// seed's beta search stops when that seed's three etas are in bounds and
// never waits on another seed.  A single seed's weights are the B = 1 launch.
//
// What bounds it on the H100: nothing the card is short of.  At K = 200,
// T = 15 it reads 12 KB and does a few hundred thousand flops, so it is
// bound by latency: the chain of dependent block reductions in the beta
// search (up to 64 rounds of three block sums) and the launch itself.
//
// What the design does about it: ONE block holds the whole problem, so every
// reduction is a warp shuffle plus one shared-memory pass, with no second
// kernel and no global-memory round trip; tc stays in shared memory for all
// 64 rounds.  The three groups share each round (one three-wide block sum),
// and one thread decides the round's betas in shared memory, so all threads
// take the early exit together and never diverge on it.  K up to 1024 runs
// one sample per thread; a larger K strides.  A batch of B seeds is B such
// blocks, one per seed, on B SMs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kBetaIters = 64;  // the reference's unbounded while, bounded

template <bool kMin>
__device__ __forceinline__ float combine(float a, float b) {
  return kMin ? fminf(a, b) : a + b;
}

template <bool kMin>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = combine<kMin>(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;
}

// Reduces v[0..2] over the block; every thread gets the results in res[0..2].
template <bool kMin>
__device__ void block_reduce3(float v[3], float* scratch /* [3][32] */,
                              float* res /* [3] */) {
  const float identity = kMin ? INFINITY : 0.0f;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    float w = warp_reduce<kMin>(v[g]);
    if (lane == 0) scratch[g * 32 + warp] = w;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      float w = lane < n_warps ? scratch[g * 32 + lane] : identity;
      w = warp_reduce<kMin>(w);
      if (lane == 0) res[g] = w;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ bool in_group(int g, int k, int half_K) {
  return g == 2 || (g == 0 ? k < half_K : k >= half_K);
}

__global__ void multimodal_weights_kernel(const float* __restrict__ cost,   // [B, K, T]
                                          const float* __restrict__ gamma,  // [T]
                                          float* __restrict__ out,          // [B, 3, K]
                                          int K, int T, int half_K,
                                          float eta_u, float eta_l) {
  // block b: seed b's [K, T] costs and [3, K] weights
  cost += static_cast<size_t>(blockIdx.x) * K * T;
  out += static_cast<size_t>(blockIdx.x) * 3 * K;
  extern __shared__ float tc[];  // [K] discounted cost-to-go
  __shared__ float scratch[3 * 32];
  __shared__ float mins[3];
  __shared__ float etas[3];
  __shared__ float beta[3];
  __shared__ int done;

  // 1. tc[k]: one sample per thread, summed in horizon order
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float s = 0.0f;
    for (int t = 0; t < T; ++t) s += cost[k * T + t] * gamma[t];
    tc[k] = s;
  }
  __syncthreads();

  // 2. the three masked minima
  float v[3] = {INFINITY, INFINITY, INFINITY};
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      if (in_group(g, k, half_K)) v[g] = fminf(v[g], tc[k]);
    }
  }
  block_reduce3<true>(v, scratch, mins);

  // 3. the beta search: each round is one three-wide block sum
  if (threadIdx.x == 0) {
    beta[0] = beta[1] = beta[2] = 1.0f;
    done = 0;
  }
  __syncthreads();
  for (int it = 0; it < kBetaIters; ++it) {
    v[0] = v[1] = v[2] = 0.0f;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        if (in_group(g, k, half_K)) v[g] += expf(-(tc[k] - mins[g]) / beta[g]);
      }
    }
    block_reduce3<false>(v, scratch, etas);
    if (threadIdx.x == 0) {
      bool out_of_bounds = false;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float eta = etas[g];
        if (eta > eta_u) {
          beta[g] *= 0.9f;
          out_of_bounds = true;
        } else if (eta < eta_l) {
          beta[g] *= 1.2f;
          out_of_bounds = true;
        }
      }
      done = out_of_bounds ? 0 : 1;
    }
    __syncthreads();
    if (done) break;  // the same shared value for every thread
  }

  // 4. normalise: the final sums use the final betas
  v[0] = v[1] = v[2] = 0.0f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      if (in_group(g, k, half_K)) v[g] += expf(-(tc[k] - mins[g]) / beta[g]);
    }
  }
  block_reduce3<false>(v, scratch, etas);
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      out[g * K + k] = in_group(g, k, half_K)
                           ? expf(-(tc[k] - mins[g]) / beta[g]) / etas[g]
                           : 0.0f;
    }
  }
}

}  // namespace

extern "C" int m3p2i_multimodal_weights(const float* cost, const float* gamma, float* out, int B,
                                        int K, int T, int half_K, float eta_u, float eta_l,
                                        void* stream) {
  if (B <= 0 || B > 65535 || K <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int threads = ((K + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = static_cast<size_t>(K) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  multimodal_weights_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      cost, gamma, out, K, T, half_K, eta_u, eta_l);
  return static_cast<int>(cudaGetLastError());
}
