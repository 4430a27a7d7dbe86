// The round-by-round multi-modal weights kernel (one block per seed, one
// thread per sample, one three-wide block sum a beta round: the form of
// csrc/multimodal_weights.cu before its candidates ran ahead) with clock64
// stamps on thread 0, which splits its time into parts.  Built and launched
// by weights_ab.py; the weights it writes are the round-by-round kernel's.
//
// clocks[0 .. 8]: the cost-to-go, the minima (block reduction included),
// then summed over the beta rounds: the terms (sub, division, expf), the
// warp trees, the shared-memory write and the first __syncthreads, warp 0's
// tree and the second __syncthreads, thread 0's decision and the third
// __syncthreads; then the final pass; clocks[8]: the rounds run.
// clocks[9], clocks[10]: %globaltimer (ns) at the start and the end.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kBetaIters = 64;

template <bool kMin>
__device__ __forceinline__ float combine(float a, float b) {
  return kMin ? fminf(a, b) : a + b;
}

template <bool kMin>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = combine<kMin>(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ bool in_group(int g, int k, int half_K) {
  return g == 2 || (g == 0 ? k < half_K : k >= half_K);
}

__global__ void weights_clock_kernel(const float* __restrict__ cost, const float* __restrict__ gamma,
                                     float* __restrict__ out, int K, int T, int half_K, float eta_u,
                                     float eta_l, long long* __restrict__ clocks) {
  extern __shared__ float tc[];
  __shared__ float scratch[3 * 32];
  __shared__ float mins[3];
  __shared__ float etas[3];
  __shared__ float beta[3];
  __shared__ int done;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = (blockDim.x + 31) >> 5;
  long long acc[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  const long long ns0 = global_ns();
  long long t0 = clock64(), t1;

  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float s = 0.0f;
    for (int t = 0; t < T; ++t) s += cost[k * T + t] * gamma[t];
    tc[k] = s;
  }
  __syncthreads();
  t1 = clock64(); acc[0] += t1 - t0; t0 = t1;

  float v[3] = {INFINITY, INFINITY, INFINITY};
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      if (in_group(g, k, half_K)) v[g] = fminf(v[g], tc[k]);
    }
  }
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    const float w = warp_reduce<true>(v[g]);
    if (lane == 0) scratch[g * 32 + warp] = w;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      float w = lane < n_warps ? scratch[g * 32 + lane] : INFINITY;
      w = warp_reduce<true>(w);
      if (lane == 0) mins[g] = w;
    }
  }
  if (threadIdx.x == 0) {
    beta[0] = beta[1] = beta[2] = 1.0f;
    done = 0;
  }
  __syncthreads();
  t1 = clock64(); acc[1] += t1 - t0; t0 = t1;

  int rounds = 0;
  for (int it = 0; it < kBetaIters; ++it) {
    ++rounds;
    v[0] = v[1] = v[2] = 0.0f;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        if (in_group(g, k, half_K)) v[g] += expf(-(tc[k] - mins[g]) / beta[g]);
      }
    }
    t1 = clock64(); acc[2] += t1 - t0; t0 = t1;
    float w3[3];
#pragma unroll
    for (int g = 0; g < 3; ++g) w3[g] = warp_reduce<false>(v[g]);
    t1 = clock64(); acc[3] += t1 - t0; t0 = t1;
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      if (lane == 0) scratch[g * 32 + warp] = w3[g];
    }
    __syncthreads();
    t1 = clock64(); acc[4] += t1 - t0; t0 = t1;
    if (warp == 0) {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        float w = lane < n_warps ? scratch[g * 32 + lane] : 0.0f;
        w = warp_reduce<false>(w);
        if (lane == 0) etas[g] = w;
      }
    }
    __syncthreads();
    t1 = clock64(); acc[5] += t1 - t0; t0 = t1;
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
    t1 = clock64(); acc[6] += t1 - t0; t0 = t1;
    if (done) break;
  }

  v[0] = v[1] = v[2] = 0.0f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      if (in_group(g, k, half_K)) v[g] += expf(-(tc[k] - mins[g]) / beta[g]);
    }
  }
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    const float w = warp_reduce<false>(v[g]);
    if (lane == 0) scratch[g * 32 + warp] = w;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      float w = lane < n_warps ? scratch[g * 32 + lane] : 0.0f;
      w = warp_reduce<false>(w);
      if (lane == 0) etas[g] = w;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      out[g * K + k] = in_group(g, k, half_K) ? expf(-(tc[k] - mins[g]) / beta[g]) / etas[g] : 0.0f;
    }
  }
  t1 = clock64(); acc[7] += t1 - t0;
  if (threadIdx.x == 0) {
    const long long ns1 = global_ns();
    for (int i = 0; i < 8; ++i) clocks[i] = acc[i];
    clocks[8] = rounds;
    clocks[9] = ns0;
    clocks[10] = ns1;
  }
}

}  // namespace

extern "C" int m3p2i_weights_clock(const float* cost, const float* gamma, float* out, int K, int T,
                                   int half_K, float eta_u, float eta_l, long long* clocks,
                                   void* stream) {
  if (K <= 0 || T <= 0 || K > 12288) return static_cast<int>(cudaErrorInvalidValue);
  int threads = ((K + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  weights_clock_kernel<<<1, threads, K * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      cost, gamma, out, K, T, half_K, eta_u, eta_l, clocks);
  return static_cast<int>(cudaGetLastError());
}
