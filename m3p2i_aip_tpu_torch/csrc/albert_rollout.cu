// Albert MPPI rollout, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel m3p2i_aip_tpu/ops/pallas_albert_rollout.py::_albert_kernel
// (:55; factory make_albert_rollout :290).  Each of the K samples rolls its
// 13-channel action sequence through T control steps of the albert mobile
// manipulator (m3p2i_aip_tpu/models/albert.py::step): per substep the
// differential-drive base and the 9-channel arm velocity drive, the arm
// clip, the box's ground friction and integration, and two Jacobi base-vs-box
// PBD contact passes; then the base-composed 7-joint FK of the end effector
// and the ee_reach / push_reach / reposition / navigation costs
// (AlbertObjective).  Out per step: the cost and the base's xy.
//
// The entry point takes B seeds at once, so it also replaces the TPU kernel's
// grid=(B,) call
// (pallas_albert_rollout.py:425, built by _get_batched_call :414 for the
// custom_vmap rule :455-474 that the multi-seed runner reaches under
// jax.vmap): seed b rolls its own K samples from its own start state and
// task, and every per-seed operand carries a seed stride (task [B, 5],
// state0 [B, 30], acts [B, K, T, 13], cost [B, K, T], traj [B, K, T, 2]).
// The seed is blockIdx.y; a single rollout is the B = 1 launch of the same
// body.
//
// What bounds it on the H100: latency.  At K = 128 there are 128 independent
// serial chains of T x substeps = 24 substeps, each a few hundred dependent
// flops (the drive, the box's friction, two contact projections), and almost
// no data (80 KB of actions in, 18 KB out).  With one thread a sample the
// time was one sample's chain (0.068-0.072 ms at K = 8, 32 and 128 alike,
// ~11.5k cycles a step): the two contact passes about half of it, the FK and
// the cost a quarter, the drive and the friction the rest; every division,
// square root, sine and cosine carries a slow-path branch, so its basic
// block runs alone, and one warp per scheduler hides no latency.
//
// What the design does about it: a team of kTeam lanes of one warp per
// sample, in place of one thread.  Every lane keeps the same copy of the
// sample's state in registers and runs the physics in one thread's order
// (the drive, the arm clip, the friction, the two passes).  The FK and the
// cost read the post-step state but feed no later step, so they leave the
// chain: at the end of step t, lane t % kTeam keeps a snapshot of what they
// read (the 12 joints and the box's xy), and after every kTeam-th step (and
// the last) the whole team runs albert_ee and the cost once, each lane on
// its own snapshot, and writes its own step's cost and xy.  At T = 12 the
// chain holds the FK and the cost twice in place of 12 times; lanes of a
// partial last round hold no step and write nothing.  Along the physics,
// the work whose result no output reads is skipped behind a branch, exactly:
// a box at rest divides by the friction guard, so its two divisions are one
// constant; the box's cosine and sine are formed anew only when its yaw's
// bits change (a box that neither slides nor turns keeps them); the ratio
// test of circle_vs_obb runs only with the base centre inside the box, and
// resolve's three divisions only for a live contact (pbd2d.cuh).  A step's
// actions are loaded a step ahead.  The substeps stay a run-time count: an
// instantiation with the scenes' 2 unrolled (111 registers) was measured
// slower, 0.040 against 0.034 ms in free space and 0.060 against 0.052 ms
// at B = 20, and so were the primitives without their skips (0.046 ms in
// free space).  Splitting the physics' independent divisions or the
// drive's sines over lanes and gathering them by shuffles was measured
// slower (a shuffle costs about what a division's fast path does), and so
// was voting the skips warp-wide; the team's lanes therefore split only
// the FK and the cost.
//
// Every lane that computes a value runs the operations of the one-thread
// kernel in its order, and only the snapshot moves between lanes (by a
// select on the owning lane), so the outputs are that kernel's bits and do
// not depend on kTeam, on the block or on B: a batched launch equals B
// single launches bit for bit.  A team never straddles a warp and a team
// past K leaves as a whole.  Blocks are two warps, eight samples: 16 blocks
// at K = 128, 320 at B = 20, one wave (ptxas: 114 registers, a 32-byte
// stack frame for the sines' slow paths, no spills; 1056 blocks a wave).
//
// What bounds it now: one sample's physics chain, whose length depends on
// the data (a sample whose base pushes a turning box runs every division
// and sine, one in free space few of them); the card is still idle, so the
// time is flat in K, and a batch takes as long as its slowest sample.  On
// an NVIDIA H100 80GB HBM3 at 700 W, replayed from a CUDA graph: 0.034 ms
// at K = 128 x T = 12 in free space and 0.045 ms with the base against the
// box (0.067-0.074 ms with one thread a sample), 0.052 ms for B = 20 seeds
// (0.077).

// Semantics kept from the plain version (ops/albert_rollout.py, over
// models/albert.step and AlbertObjective.compute), where the TPU kernel
// differs from it:
//   * the EE is the finger midpoint (left + right) / 2, as panda_fk.fk forms
//     it (the TPU kernel offset the finger base by (q_l - q_r) / 2);
//   * the cost is a nested select on the task id, not an indicator sum;
//   * without a box the push_reach / reposition costs still read the
//     (parked) box state, as AlbertObjective does (the TPU kernel fell back
//     to the navigation cost there).
//
// Floating point: built without fast math and with -fmad=false; every
// expression keeps the plain version's operation order.  h, the drive decay,
// the wheel geometry and the cost radii come in the param buffer, formed in
// double on the host and rounded once; the box's mu_g, friction and angular
// radius are formed there in float32 by the expressions albert.step uses.
// The hover sigmoid is 1 / (1 + expf(-x)), as cost_functions.sigmoid writes it.

#include <cuda_runtime.h>
#include <math.h>

#include "panda_fk.cuh"
#include "pbd2d.cuh"
#include "team.cuh"

namespace {

// lanes per sample: kTeam divides 32 (a team never straddles a warp) and
// holds one step's FK and cost on each lane of a round; kThreads is whole
// warps (tests/test_torch_kernel_sources.py holds them)
constexpr int kTeam = 8;
constexpr int kThreads = 64;
constexpr int kSamplesPerBlock = kThreads / kTeam;
constexpr int kStateLen = 30;  // q(12), qd(12), box x, y, yaw, vx, vy, om
constexpr int kNu = 13;
constexpr float kGravity = 9.8f;
constexpr float kMountZ = 0.4f;  // albert.ARM_MOUNT (its x and y are zero)

// param buffer layout (floats), shared with ops/albert_rollout.py::_param_buffer
enum Scalar {
  P_H = 0, P_DECAY, P_WHEEL_R, P_WHEEL_B, P_WM_BASE, P_RR,
  P_MU_G, P_ANG_RAD, P_FRIC, P_HX, P_HY, P_WM_BOX, P_WI_BOX,
  P_APPROACH_R, P_HOVER_GATE_R, P_CLEARANCE_R,
  N_SCALARS
};
static_assert(N_SCALARS == 16, "ops/albert_rollout.py _N_SCALARS");

__device__ __forceinline__ float norm2(float x, float y) { return sqrtf(x * x + y * y); }

__device__ __forceinline__ float norm3(float x, float y, float z) { return sqrtf(x * x + y * y + z * z); }

// albert.fk -> panda_fk.fk: the EE (finger midpoint) of arm joints q[3..11],
// the chain starting at the base frame Rz(q[2]) at [q0, q1, mount z]
__device__ __forceinline__ void albert_ee(const float q[12], float ee[3]) {
  const float c = cosf(q[2]), s = sinf(q[2]);
  float pos[3] = {q[0], q[1], kMountZ};
  float R[3][3] = {{c, -s, 0.0f}, {s, c, 0.0f}, {0.0f, 0.0f, 1.0f}};
  fk_joint<0>(pos, R, q[3]);
  fk_joint<1>(pos, R, q[4]);
  fk_joint<2>(pos, R, q[5]);
  fk_joint<3>(pos, R, q[6]);
  fk_joint<4>(pos, R, q[7]);
  fk_joint<5>(pos, R, q[8]);
  fk_joint<6>(pos, R, q[9]);
  add_rot_const(pos, R, kHandXYZ[0], kHandXYZ[1], kHandXYZ[2]);
  mul_const(R, kHandMat);
  float fb[3] = {pos[0], pos[1], pos[2]};
  add_rot_const(fb, R, kFingerXYZ[0], kFingerXYZ[1], kFingerXYZ[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float left = fb[i] + R[i][1] * q[10];
    const float right = fb[i] - R[i][1] * q[11];
    ee[i] = (left + right) / 2.0f;
  }
}

// AlbertObjective.compute on one post-step state: the base xy q[0..1], the
// EE, the box xy
__device__ __forceinline__ float step_cost(const float* sp, float task_id, float gx, float gy, float gz,
                                           const float q[12], float bx, float by, const float ee[3]) {
  const float nav = norm2(q[0] - gx, q[1] - gy);
  float cost;
  if (task_id == 9.0f) {  // push_reach: push the box, the EE hovering over it
    const float r2bx = bx - q[0], r2by = by - q[1];
    const float b2gx = gx - bx, b2gy = gy - by;
    const float d_rb = norm2(r2bx, r2by);
    const float d_bg = norm2(b2gx, b2gy);
    const float cos_theta = (-r2bx * b2gx + -r2by * b2gy) / fmaxf(d_rb * d_bg, 1e-9f);
    const float approach = 5.0f * fmaxf(d_rb - sp[P_APPROACH_R], 0.0f);
    const float push = 3.0f * (d_rb + d_bg * 10.0f) + 1.5f * (1.0f + cos_theta) + approach;
    const float gate = (sp[P_HOVER_GATE_R] - d_rb) / 0.03f;
    const float hover_w = 1.5f + 2.5f * (1.0f / (1.0f + expf(-gate)));
    cost = push + hover_w * norm3(ee[0] - bx, ee[1] - by, ee[2] - gz);
  } else if (task_id == 7.0f) {  // ee_reach: EE at the goal, base-progress shaping
    cost = 10.0f * norm3(ee[0] - gx, ee[1] - gy, ee[2] - gz) + 3.0f * nav;
  } else if (task_id == 8.0f) {  // reposition: navigation outside the keep-out
    const float d_rb = norm2(bx - q[0], by - q[1]);
    cost = nav + 10.0f * fmaxf(sp[P_CLEARANCE_R] - d_rb, 0.0f);
  } else {  // navigation
    cost = nav;
  }
  return cost;
}

__global__ void __launch_bounds__(kThreads)
albert_rollout_kernel(const float* __restrict__ params, const float* __restrict__ task,
                      const float* __restrict__ state0, const float* __restrict__ acts,
                      float* __restrict__ cost_out, float* __restrict__ traj_out, int K, int T,
                      int substeps, int has_box) {
  __shared__ float sp[N_SCALARS];
  if (threadIdx.x < N_SCALARS) sp[threadIdx.x] = params[threadIdx.x];
  __syncthreads();
  const int k = blockIdx.x * kSamplesPerBlock + threadIdx.x / kTeam;
  if (k >= K) return;  // all lanes of a team share k, so the team leaves as a whole
  const auto tm = Team<kTeam>::of_thread();
  // seed b = blockIdx.y: its task, start state and samples
  const size_t b = blockIdx.y;
  task += b * 5;
  state0 += b * kStateLen;
  acts += b * K * T * kNu;
  cost_out += b * K * T;
  traj_out += b * K * T * 2;

  const float h = sp[P_H], decay = sp[P_DECAY];
  // task: [task_id, goal x, y, z, k0]; k0 is unused (the albert is single-mode)
  const float task_id = task[0];
  const float gx = task[1], gy = task[2], gz = task[3];

  float q[12], qd[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    q[i] = state0[i];
    qd[i] = state0[12 + i];
  }
  float bx = state0[24], by = state0[25], byaw = state0[26];
  float bvx = state0[27], bvy = state0[28], bom = state0[29];
  // this lane's snapshot of what the FK and the cost read: the post-step
  // state of step t0 + lane of the current round of kTeam steps
  float sq[12], sbx = bx, sby = by;
#pragma unroll
  for (int i = 0; i < 12; ++i) sq[i] = q[i];
  // ground friction's ratio for a box at rest, whose guarded speeds divide by 1e-9
  const float rest_ratio = sp[P_MU_G] * kGravity * h / 1e-9f;
  // the box's cosine and sine, formed anew only when its yaw's bits change
  float yaw_c = byaw, cyaw = cosf(byaw), syaw = sinf(byaw);
  float un[11];  // the next step's actions u[2..12], loaded a step ahead
#pragma unroll
  for (int i = 0; i < 11; ++i) un[i] = acts[static_cast<size_t>(k) * T * kNu + 2 + i];

  for (int t = 0; t < T; ++t) {
    float ua[9];  // arm + finger velocity targets, u[2..10]
#pragma unroll
    for (int i = 0; i < 9; ++i) ua[i] = un[i];
    const float ul = un[9], ur = un[10];
    if (t + 1 < T) {
      const float* u = acts + (static_cast<size_t>(k) * T + t + 1) * kNu;
#pragma unroll
      for (int i = 0; i < 11; ++i) un[i] = u[2 + i];
    }

#pragma unroll
    for (int sub = 0; sub < substeps; ++sub) {
      // ---- diff-drive base + arm velocity drive, integrate, arm clip ------
      const float v = sp[P_WHEEL_R] * (ul + ur) / 2.0f;
      const float om = sp[P_WHEEL_R] * (ur - ul) / sp[P_WHEEL_B];
      const float th = q[2];
      const float target[3] = {v * cosf(th), v * sinf(th), om};
#pragma unroll
      for (int i = 0; i < 3; ++i) qd[i] = target[i] + (qd[i] - target[i]) * decay;
#pragma unroll
      for (int i = 0; i < 9; ++i) qd[3 + i] = ua[i] + (qd[3 + i] - ua[i]) * decay;
#pragma unroll
      for (int i = 0; i < 12; ++i) q[i] = q[i] + qd[i] * h;
#pragma unroll
      for (int i = 0; i < 9; ++i) q[3 + i] = fminf(fmaxf(q[3 + i], kJointLo[i]), kJointHi[i]);

      if (has_box) {
        // ---- box ground friction (pbd2d.ground_friction) + integration ----
        const float mu_g_h = sp[P_MU_G] * kGravity * h;
        const float speed = norm2(bvx, bvy);
        const float den_v = fmaxf(speed, 1e-9f), den_om = fmaxf(fabsf(bom) * sp[P_ANG_RAD], 1e-9f);
        float r_v = rest_ratio, r_om = rest_ratio;
        if (den_v != 1e-9f) r_v = mu_g_h / den_v;
        if (den_om != 1e-9f) r_om = mu_g_h / den_om;
        const float scale = fmaxf(1.0f - r_v, 0.0f);
        bvx = bvx * scale;
        bvy = bvy * scale;
        const float om_scale = fmaxf(1.0f - r_om, 0.0f);
        bom = bom * om_scale;
        bx = bx + bvx * h;
        by = by + bvy * h;
        byaw = byaw + bom * h;
        // ---- two Jacobi passes: the base circle vs the box -----------------
#pragma unroll
        for (int pass = 0; pass < 2; ++pass) {
          if (__float_as_uint(byaw) != __float_as_uint(yaw_c)) {
            yaw_c = byaw;
            cyaw = cosf(byaw);
            syaw = sinf(byaw);
          }
          const Contact c = circle_vs_obb(q[0], q[1], sp[P_RR], bx, by, cyaw, syaw, sp[P_HX], sp[P_HY]);
          const Resolved o = resolve(c.pen, c.nx, c.ny, c.px, c.py, q[0], q[1], qd[0], qd[1], 0.0f,
                                     sp[P_WM_BASE], 0.0f, bx, by, bvx, bvy, bom, sp[P_WM_BOX], sp[P_WI_BOX], h,
                                     sp[P_FRIC], 1.0f);
          q[0] = q[0] + o.dax;
          q[1] = q[1] + o.day;
          qd[0] = qd[0] + o.dvax;
          qd[1] = qd[1] + o.dvay;
          bx = bx + o.dbx;
          by = by + o.dby;
          byaw = byaw + o.dyaw_b;
          bvx = bvx + o.dvbx;
          bvy = bvy + o.dvby;
          bom = bom + o.dom_b;
        }
      }
    }

    // ---- the FK and the cost, off the chain: lane t % kTeam keeps this
    // step's state; the team scores a whole round at once ------------------
    const int slot = t % kTeam;
    const bool mine = tm.lane == slot;
#pragma unroll
    for (int i = 0; i < 12; ++i) sq[i] = mine ? q[i] : sq[i];
    sbx = mine ? bx : sbx;
    sby = mine ? by : sby;
    if (slot == kTeam - 1 || t == T - 1) {
      float ee[3];
      albert_ee(sq, ee);
      const float cost = step_cost(sp, task_id, gx, gy, gz, sq, sbx, sby, ee);
      if (tm.lane <= slot) {  // a partial last round: lanes past T hold no step
        const size_t o = static_cast<size_t>(k) * T + (t - slot + tm.lane);
        cost_out[o] = cost;
        traj_out[2 * o] = sq[0];
        traj_out[2 * o + 1] = sq[1];
      }
    }
  }
}

}  // namespace

extern "C" int m3p2i_albert_rollout(const float* params, const float* task, const float* state0,
                                    const float* acts, float* cost, float* traj, int B, int K,
                                    int T, int substeps, int has_box, int n_params, void* stream) {
  if (B <= 0 || B > 65535 || K <= 0 || T <= 0 || substeps <= 0 || n_params != N_SCALARS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static_assert(kStateLen == 30, "ops/albert_rollout.py STATE_LEN");
  const dim3 grid((K + kSamplesPerBlock - 1) / kSamplesPerBlock, B);
  albert_rollout_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      params, task, state0, acts, cost, traj, K, T, substeps, has_box);
  return static_cast<int>(cudaGetLastError());
}
