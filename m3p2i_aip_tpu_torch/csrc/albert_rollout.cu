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
// serial chains of T x substeps steps, each a few hundred dependent flops
// (the drive, two contact projections, a 7-joint FK with 8 sin/cos pairs),
// and almost no data (80 KB of actions in, 18 KB out).  Four warps on a
// 132-SM card: the time is the length of one sample's dependency chain.
//
// What the design does about it: one thread per sample with the whole
// T x substeps nest in registers (the 12 joint positions and velocities, the
// box's pose and twist, the FK chain); nothing touches global memory inside
// the nest but the per-step action read and the cost / xy write.  The start
// state is one 30-float vector read by every thread (all K rollouts start from
// the synced real state).  Scene constants come from a 16-float param buffer
// built once per scene in ops/albert_rollout.py.  The FK tables and their
// constant-folded products are shared with the panda kernel (panda_fk.cuh);
// the chain starts from the sample's own base frame, Rz(yaw) at
// [x, y, 0.4], so the first joint's products are not folded.  The contact
// primitives are the point kernel's (pbd2d.cuh).  Blocks are two warps, so
// K = 128 is two blocks, and a batch of B seeds is B rows of two.
//
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

namespace {

constexpr int kThreads = 64;
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

__global__ void __launch_bounds__(kThreads)
albert_rollout_kernel(const float* __restrict__ params, const float* __restrict__ task,
                      const float* __restrict__ state0, const float* __restrict__ acts,
                      float* __restrict__ cost_out, float* __restrict__ traj_out, int K, int T,
                      int substeps, int has_box) {
  __shared__ float sp[N_SCALARS];
  if (threadIdx.x < N_SCALARS) sp[threadIdx.x] = params[threadIdx.x];
  __syncthreads();
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
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

  for (int t = 0; t < T; ++t) {
    const float* u = acts + (static_cast<size_t>(k) * T + t) * kNu;
    float ua[9];  // arm + finger velocity targets, u[2..10]
#pragma unroll
    for (int i = 0; i < 9; ++i) ua[i] = u[2 + i];
    const float ul = u[11], ur = u[12];

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
        const float scale = fmaxf(1.0f - mu_g_h / fmaxf(speed, 1e-9f), 0.0f);
        bvx = bvx * scale;
        bvy = bvy * scale;
        const float om_scale = fmaxf(1.0f - mu_g_h / fmaxf(fabsf(bom) * sp[P_ANG_RAD], 1e-9f), 0.0f);
        bom = bom * om_scale;
        bx = bx + bvx * h;
        by = by + bvy * h;
        byaw = byaw + bom * h;
        // ---- two Jacobi passes: the base circle vs the box -----------------
#pragma unroll
        for (int pass = 0; pass < 2; ++pass) {
          const Contact c = circle_vs_obb(q[0], q[1], sp[P_RR], bx, by, cosf(byaw), sinf(byaw), sp[P_HX], sp[P_HY]);
          const Resolved o = resolve(c.pen, c.nx, c.ny, c.px, c.py, q[0], q[1], qd[0], qd[1], 0.0f,
                                     sp[P_WM_BASE], 0.0f, bx, by, bvx, bvy, bom, sp[P_WM_BOX], sp[P_WI_BOX],
                                     h, sp[P_FRIC], 1.0f);
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

    // ---- costs (AlbertObjective.compute) on the post-step state ----------
    float ee[3];
    albert_ee(q, ee);
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

    const size_t o = static_cast<size_t>(k) * T + t;
    cost_out[o] = cost;
    traj_out[2 * o] = q[0];
    traj_out[2 * o + 1] = q[1];
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
  const dim3 grid((K + kThreads - 1) / kThreads, B);
  albert_rollout_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      params, task, state0, acts, cost, traj, K, T, substeps, has_box);
  return static_cast<int>(cudaGetLastError());
}
