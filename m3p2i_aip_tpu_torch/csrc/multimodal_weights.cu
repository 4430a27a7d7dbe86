// M3P2I multi-modal importance weights, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel m3p2i_aip_tpu/ops/pallas_kernels.py::_weights_kernel
// (wrapper multimodal_weights_pallas, :189).  From the [K, T] rollout costs
// it computes the discounted cost-to-go tc[k] = sum_t cost[k, t] * gamma[t],
// shifts each of three sample groups by its own minimum (group 0: k < half_K,
// group 1: k >= half_K, group 2: all k), and runs the adaptive inverse
// temperature search of the reference (m3p2i.py:24-64): beta starts at 1 on
// every call and is multiplied by 0.9 while eta = sum exp(-c / beta) > eta_u,
// or by 1.2 while eta < eta_l, for at most 64 rounds.  Output: the three
// normalised weight vectors, rows of out[3, K].
//
// The entry point takes B seeds at once, so it also replaces the TPU kernel's
// grid=(B,) call (pallas_kernels.py:173, the custom_vmap rule _mmw_vmap :157,
// which the multi-seed runner reaches under jax.vmap): cost [B, K, T], one
// shared gamma [T], out [B, 3, K].  Block b solves seed b alone.  A single
// seed's weights are the B = 1 launch.
//
// What bounds it on the H100: nothing the card is short of.  At K = 200,
// T = 15 it reads 12 KB and does a few hundred thousand flops, so it is
// bound by latency: the beta search is a chain of up to 64 rounds, each a
// sum over K that the next round's beta depends on, and the launch itself.
//
// What the design does about it: the rounds are run ahead.  A group's next
// beta is its last one times the last step's factor as long as eta stays on
// the same side of the bounds, so from the last known beta the block
// evaluates kCandidates betas at once, candidate j = beta * d * ... * d (j
// sequential float products, the bits the round-by-round loop gives them),
// a team of warps each (one warp up to K = 256).  One barrier gathers their
// etas, and every warp walks them in round order: the first candidate
// inside [eta_l, eta_u] (or at the 64-round cap) ends the group's search,
// and the first whose factor differs starts the next step from there in the
// other direction.  A group inside the bounds keeps its beta, so each group
// searches alone and ends at its own first in-bounds round, as in the joint
// loop.  The first step, with no direction known, splits its candidates
// between down and up.  A tied group needs no search at all, and a term's
// division is a reciprocal product with two fma corrections, which rounds
// as the division does without its branches.

// Each eta is the sum the round-by-round form (one thread a sample, a block
// of ceil(K / 32) warps up to 1024 threads, K > 1024 strided) formed, in
// its order: every "parent thread" t's partial (samples t, t + 1024, ... in
// order), a shuffle tree (16, 8, 4, 2, 1) over each parent warp, and the
// same tree over the parent warps' partials padded with zeros.  A candidate
// warp holds kSlots parent warps a pass on kLanes lanes each; a lane holds
// kSlots samples of one parent warp, kLanes apart, runs the tree's first
// levels in registers (the same pairs) and the last by shuffles within its
// kLanes lanes.  The weights and the beta decisions are therefore bit for
// bit those of the round-by-round kernel; the build has no fast math and
// no contraction.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 512;       // the block; 128 registers a thread at most
constexpr int kParentThreads = 1024;   // the round-by-round block, whose sums the etas keep
constexpr int kSmemMaxK = 49152;       // tc[K] in dynamic shared memory (192 KB, opted in); above, in global scratch
constexpr int kMaxB = 65535;           // seeds a launch takes, one block each
constexpr int kBetaIters = 64;         // the reference's unbounded while, bounded
constexpr int kCandidates = 8;         // betas evaluated a step, a team of warps each
constexpr int kLanes = 4;              // lanes that share one parent warp's 32 samples
constexpr int kSlots = 32 / kLanes;    // samples a lane holds = parent warps a warp pass holds
constexpr int kSplitDown = kCandidates / 2;  // the first step's candidates 1 .. kSplitDown go down
constexpr float kDown = 0.9f, kUp = 1.2f;

static_assert(kLanes >= 1 && kLanes <= 32 && 32 % kLanes == 0, "a parent warp's lanes divide the warp");
static_assert(kCandidates >= 2 && kCandidates <= 32 && 32 * kCandidates <= kMaxThreads,
              "one warp per candidate at least, and a lane per candidate in the walk");
static_assert(2 * kSlots <= 32, "a bit per term in the redo mask");

// Candidate j's round after the step's first: j, or on the first step
// (split), j for the down chain 1 .. kSplitDown and j - kSplitDown above.
__device__ __forceinline__ int candidate_rounds(bool split, int j) {
  return split && j > kSplitDown ? j - kSplitDown : j;
}

// Candidate j's beta from a step's first beta s: candidate_rounds(j)
// products by the predicted factor d (on the first step 0.9 for the down
// chain, 1.2 above).
__device__ __forceinline__ float candidate_beta(float s, float d, bool split, int j) {
  const float f = split ? (j <= kSplitDown ? kDown : kUp) : d;
  const int n = candidate_rounds(split, j);
  float c = s;
#pragma unroll
  for (int i = 1; i < kCandidates; ++i) c = i <= n ? c * f : c;  // one rounded product a round, as the loop forms it
  return c;
}

// -x / b rounded to nearest, without the division's branches, from y = 1/b
// rounded to nearest: q = RN(-x y) and two corrections q += RN(r y), with
// r = -x - b q exact by fma (Markstein's theorem: the second rounds
// correctly) where in_range(x) and in_range(b).  Every beta of the search
// is: 0.9^64 <= beta <= 1.2^64.  (For x = 0 it gives +0 or -0; expf reads
// both as 1.)
__device__ __forceinline__ float neg_quotient(float x, float b, float y) {
  const float a = -x;
  float q = a * y;
  float r = __fmaf_rn(-b, q, a);
  q = __fmaf_rn(r, y, q);
  r = __fmaf_rn(-b, q, a);
  return __fmaf_rn(r, y, q);
}

__device__ __forceinline__ bool in_range(float x) {
  const float m = fabsf(x);
  return x == 0.0f || (m >= 0x1p-60f && m <= 0x1p60f);
}

// Adds one candidate's terms exp(-(tc[k] - min) / beta) to the partials of
// a lane's kSlots parent threads (`first` + kLanes i, samples t, t +
// parent_threads, ... in order; the slots' terms are independent), x[0] /
// x[1] the sample's half group, x[2] all.  kChecked: some shift may lie out
// of neg_quotient's range, and those terms divide.
template <bool kChecked>
__device__ __forceinline__ void add_terms(const float* tc, int K, int half_K, int parent_threads, int first,
                                          bool valid, const float (&mins)[3], const float (&cb)[3],
                                          const float (&rc)[3], float (&x)[3][kSlots]) {
  for (int base = 0; base < K; base += parent_threads) {  // the warp's count, for the vote
    float c[kSlots], eh[kSlots], ea[kSlots];
    unsigned redo = 0;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int k = base + first + kLanes * i;
      const bool in = valid && k < K, lo = k < half_K;
      c[i] = in ? tc[k] : (lo ? mins[0] : mins[1]);  // not a sample: a zero shift, never summed
      const float xh = c[i] - (lo ? mins[0] : mins[1]), xa = in ? c[i] - mins[2] : 0.0f;
      eh[i] = expf(neg_quotient(xh, lo ? cb[0] : cb[1], lo ? rc[0] : rc[1]));
      ea[i] = expf(neg_quotient(xa, cb[2], rc[2]));
      if (kChecked) redo |= (in_range(xh) ? 0u : 1u) << i | (in_range(xa) ? 0u : 1u) << (kSlots + i);
    }
    if (kChecked && __any_sync(0xffffffffu, redo != 0)) {
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const bool lo = base + first + kLanes * i < half_K;
        if (redo >> i & 1u) eh[i] = expf(-(c[i] - (lo ? mins[0] : mins[1])) / (lo ? cb[0] : cb[1]));
        if (redo >> (kSlots + i) & 1u) ea[i] = expf(-(c[i] - mins[2]) / cb[2]);
      }
    }
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {  // + 0.0f to the other half's partial, or past K, is exact
      const int k = base + first + kLanes * i;
      const bool in = valid && k < K;
      x[0][i] += in && k < half_K ? eh[i] : 0.0f;
      x[1][i] += in && k >= half_K ? eh[i] : 0.0f;
      x[2][i] += in ? ea[i] : 0.0f;
    }
  }
}

__device__ __forceinline__ float warp_min_all(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// kScratch: the [K] discounted cost-to-go lies in the block's row of the
// global scratch (K > kSmemMaxK; 256 KB at K = 65536, held in L2), else in
// shared memory.  Either way every read and sum below is the same, so the
// weights are too; the shared form keeps its shared-memory loads.
template <bool kScratch>
__global__ void __launch_bounds__(kMaxThreads)
multimodal_weights_kernel(const float* __restrict__ cost,   // [B, K, T]
                          const float* __restrict__ gamma,  // [T]
                          float* __restrict__ out,          // [B, 3, K]
                          float* __restrict__ scratch,      // [B, K] with kScratch, else unused
                          int K, int T, int half_K, float eta_u, float eta_l,
                          int team /* warps a candidate */, int parent_threads) {
  cost += static_cast<size_t>(blockIdx.x) * K * T;
  out += static_cast<size_t>(blockIdx.x) * 3 * K;
  extern __shared__ float smem_tc[];
  float* tc = kScratch ? scratch + static_cast<size_t>(blockIdx.x) * K : smem_tc;
  __shared__ float part[kCandidates][3][32];    // each candidate's parent-warp partials
  __shared__ float etas[2][kCandidates][3];     // each candidate's etas and betas, by step parity
  __shared__ float betas[2][kCandidates][3];
  __shared__ float red[6][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;

  // 1. tc[k]: one sample per thread, summed in horizon order
  for (int k = tid; k < K; k += blockDim.x) {
    float s = 0.0f;
    for (int t = 0; t < T; ++t) s += cost[static_cast<size_t>(k) * T + t] * gamma[t];
    tc[k] = s;
  }
  __syncthreads();

  // 2. the three masked minima and maxima (exact in any order), on every
  // thread; `safe`: every tc is finite, and 0 or of a size whose shifts
  // (multiples of 2^-53, at most 2^59) neg_quotient divides exactly
  float mins[3] = {INFINITY, INFINITY, INFINITY}, maxs[3] = {-INFINITY, -INFINITY, -INFINITY};
  bool sized = true;
  for (int k = tid; k < K; k += blockDim.x) {
    const float v = tc[k], m = fabsf(v);
    if (k < half_K) {
      mins[0] = fminf(mins[0], v);
      maxs[0] = fmaxf(maxs[0], v);
    } else {
      mins[1] = fminf(mins[1], v);
      maxs[1] = fmaxf(maxs[1], v);
    }
    mins[2] = fminf(mins[2], v);
    maxs[2] = fmaxf(maxs[2], v);
    sized = sized && (v == 0.0f || (m >= 0x1p-30f && m <= 0x1p58f));  // false for inf and NaN
  }
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    const float lo = warp_min_all(mins[g]), hi = -warp_min_all(-maxs[g]);
    if (lane == 0) {
      red[g][warp] = lo;
      red[3 + g][warp] = hi;
    }
  }
  const bool safe = __syncthreads_and(sized);
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    mins[g] = warp_min_all(lane < n_warps ? red[g][lane] : INFINITY);
    maxs[g] = -warp_min_all(lane < n_warps ? -red[3 + g][lane] : INFINITY);
  }

  // 3. the beta searches, kCandidates rounds a step.  The search state is
  // the same in every thread: each walks the same etas the same way.
  float start[3] = {1.0f, 1.0f, 1.0f};  // the step's first beta
  float dir[3] = {kDown, kDown, kDown}; // the factor its candidates assume
  int round[3] = {0, 0, 0};             // the step's first round
  bool done[3] = {false, false, false};
  float beta[3], eta[3];                // each group's final beta and normaliser
  bool split = true;
  // a tied group needs no search: every term is exp(-0) = 1, so eta is the
  // group's size n at every beta, and the loop's decision never changes
  const int n0 = min(max(half_K, 0), K);
  const int sizes[3] = {n0, K - n0, K};
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    const float n = static_cast<float>(sizes[g]);
    if (safe && maxs[g] == mins[g]) {
      float b = 1.0f;
      for (int i = 0; i < kBetaIters && (n > eta_u || n < eta_l); ++i) b *= n > eta_u ? kDown : kUp;
      done[g] = true;
      beta[g] = b;
      eta[g] = n;
    }
  }
  const int n_parent_warps = parent_threads >> 5;
  const int n_passes = (n_parent_warps + kSlots - 1) / kSlots;
  const int cand = warp / team, member = warp % team;
  const int q = lane % kLanes;  // position of the lane's first sample in its parent warp
  for (int step = 0; !(done[0] && done[1] && done[2]); ++step) {
    const int buf = step & 1;
    float cb[3], rc[3];  // this warp's candidate betas and their reciprocals
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      cb[g] = candidate_beta(start[g], dir[g], split, cand);
      rc[g] = __frcp_rn(cb[g]);
    }
    for (int pass = member; pass < n_passes; pass += team) {
      const int w = pass * kSlots + lane / kLanes;  // the lane's parent warp
      float x[3][kSlots];
#pragma unroll
      for (int i = 0; i < kSlots; ++i) x[0][i] = x[1][i] = x[2][i] = 0.0f;
      if (safe) {
        add_terms<false>(tc, K, half_K, parent_threads, 32 * w + q, w < n_parent_warps, mins, cb, rc, x);
      } else {
        add_terms<true>(tc, K, half_K, parent_threads, 32 * w + q, w < n_parent_warps, mins, cb, rc, x);
      }
      // the parent warp's tree: offsets >= kLanes pair slots in registers,
      // the rest pair lanes
#pragma unroll
      for (int off = 16; off >= kLanes; off >>= 1) {
#pragma unroll
        for (int i = 0; i < off / kLanes; ++i) {
#pragma unroll
          for (int g = 0; g < 3; ++g) x[g][i] += x[g][i + off / kLanes];
        }
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int g = 0; g < 3; ++g) x[g][0] += __shfl_down_sync(0xffffffffu, x[g][0], off);
      }
      if (q == 0 && w < n_parent_warps) {
#pragma unroll
        for (int g = 0; g < 3; ++g) part[cand][g][w] = x[g][0];
      }
    }
    if (team == 1) {
      __syncwarp();
    } else {
      __syncthreads();
    }
    {  // the tree over the parent warps, zero-padded to 32
      float v[3];
#pragma unroll
      for (int g = 0; g < 3; ++g) v[g] = lane < n_parent_warps ? part[cand][g][lane] : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const float o = __shfl_down_sync(0xffffffffu, v[g], off);
          v[g] += off < n_parent_warps ? o : 0.0f;  // a zero partner: + 0.0f, exact
        }
      }
      if (member == 0 && lane == 0) {
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          etas[buf][cand][g] = v[g];
          betas[buf][cand][g] = cb[g];
        }
      }
    }
    __syncthreads();
    // each warp walks each open group's candidates in round order, lane j
    // holding candidate j: the first that ends the search or turns ends the step
    const int j = lane < kCandidates ? lane : kCandidates - 1;
    float e[3], e0[3];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      e[g] = etas[buf][j][g];
      e0[g] = etas[buf][0][g];
    }
    int at[3];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const bool stop = round[g] + candidate_rounds(split, j) == kBetaIters || !(e[g] > eta_u || e[g] < eta_l);
      const bool stop0 = round[g] == kBetaIters || !(e0[g] > eta_u || e0[g] < eta_l);
      // the chain: lanes lo .. hi, each the last one's beta times d
      const float d = split ? (e0[g] > eta_u ? kDown : kUp) : dir[g];
      const int lo = !split ? 0 : d == kDown ? 1 : kSplitDown + 1;
      const int hi = !split ? kCandidates - 1 : d == kDown ? kSplitDown : kCandidates - 1;
      const unsigned turn =
          __ballot_sync(0xffffffffu, lane >= lo && lane <= hi && (stop || (e[g] > eta_u ? kDown : kUp) != d));
      at[g] = turn ? __ffs(turn) - 1 : hi;
      if (split && (stop0 || lo > hi)) at[g] = 0;  // the root ends the search, or no chain goes on
    }
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const float e_at = etas[buf][at[g]][g], c_at = betas[buf][at[g]][g];
      const int r_at = round[g] + candidate_rounds(split, at[g]);
      if (done[g]) continue;
      if (r_at == kBetaIters || !(e_at > eta_u || e_at < eta_l)) {
        done[g] = true;
        beta[g] = c_at;
        eta[g] = e_at;
      } else {  // the next step starts after candidate `at`, in its direction
        dir[g] = e_at > eta_u ? kDown : kUp;
        start[g] = c_at * dir[g];
        round[g] = r_at + 1;
      }
    }
    split = false;
  }

  // 4. normalise by the final round's eta
  float rb[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) rb[g] = __frcp_rn(beta[g]);
  for (int k = tid; k < K; k += blockDim.x) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const bool in = g == 2 || (g == 0 ? k < half_K : k >= half_K);
      float q = neg_quotient(tc[k] - mins[g], beta[g], rb[g]);
      if (!safe && !in_range(tc[k] - mins[g])) q = -(tc[k] - mins[g]) / beta[g];
      out[static_cast<size_t>(g) * K + k] = in ? expf(q) / eta[g] : 0.0f;
    }
  }
}

}  // namespace

// scratch: [B, K] floats of device memory when K > kSmemMaxK (the cost-to-go
// then lives there), else null.  Above 48 KB a block's shared memory is an
// opt-in (cudaFuncAttributeMaxDynamicSharedMemorySize), made once per device
// by m3p2i_multimodal_weights_prepare before the first launch there, so that
// no launch changes a function attribute: a launch captured into a CUDA graph
// may not.
extern "C" int m3p2i_multimodal_weights(const float* cost, const float* gamma, float* out, float* scratch,
                                        int B, int K, int T, int half_K, float eta_u, float eta_l,
                                        void* stream) {
  if (B <= 0 || B > kMaxB || K <= 0 || T <= 0 || (K > kSmemMaxK) != (scratch != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int parent_threads = ((K + 31) / 32) * 32;
  if (parent_threads > kParentThreads) parent_threads = kParentThreads;
  const int passes = (parent_threads / 32 + kSlots - 1) / kSlots;
  int team = kMaxThreads / (32 * kCandidates);
  if (team > passes) team = passes;
  const dim3 grid(B), block(32 * kCandidates * team);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scratch != nullptr) {
    multimodal_weights_kernel<true><<<grid, block, 0, s>>>(cost, gamma, out, scratch, K, T, half_K, eta_u, eta_l,
                                                           team, parent_threads);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = static_cast<size_t>(K) * sizeof(float);
  multimodal_weights_kernel<false><<<grid, block, smem, s>>>(cost, gamma, out, nullptr, K, T, half_K, eta_u, eta_l,
                                                            team, parent_threads);
  return static_cast<int>(cudaGetLastError());
}

// The shared-memory opt-in of the kernel's block, on the calling thread's
// current device: the largest cost-to-go it keeps there (kSmemMaxK floats,
// 192 KB beside ~4 KB of static arrays, within the 227 KB a block may have).
// The limit only admits launches; each launch still takes K floats.
extern "C" int m3p2i_multimodal_weights_prepare() {
  return static_cast<int>(cudaFuncSetAttribute(multimodal_weights_kernel<false>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(kSmemMaxK * sizeof(float))));
}
