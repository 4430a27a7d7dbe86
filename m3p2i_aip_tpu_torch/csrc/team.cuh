// A team of W lanes of one warp that shares one sample: the lanes hold the
// same copy of the sample's state, split its independent contact tests, and
// exchange the results through shuffles that name only the team's lanes (so
// a team past K at the ragged edge can leave as a whole).  Shared by the
// rollout kernels that run a team per sample (point_rollout.cu,
// panda_rollout.cu).
#pragma once

#include <cuda_runtime.h>

namespace {

template <int W>
struct Team {
  unsigned mask;  // the team's lanes within the warp
  int base;       // the warp lane of team lane 0
  int lane;       // 0 .. W - 1

  // the team of the calling thread (W divides 32, so a team never straddles a warp)
  __device__ __forceinline__ static Team of_thread() {
    const int warp_lane = threadIdx.x % 32;
    const int base = warp_lane / W * W;
    return Team{(W == 32 ? 0xffffffffu : (1u << W) - 1u) << base, base, warp_lane % W};
  }
  // lane `src`'s value of v, on every lane of the team
  __device__ __forceinline__ float from(float v, int src) const { return __shfl_sync(mask, v, src, W); }
  // bit l set where team lane l's `pred` holds
  __device__ __forceinline__ unsigned ballot(bool pred) const { return (__ballot_sync(mask, pred) & mask) >> base; }
};

// a[i] for a lane-dependent i, by selects (no local-memory indexing)
template <int N>
__device__ __forceinline__ float pick(const float (&a)[N], int i) {
  float v = a[0];
#pragma unroll
  for (int d = 1; d < N; ++d) v = i == d ? a[d] : v;
  return v;
}

}  // namespace
