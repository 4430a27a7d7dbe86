// Panda MPPI rollout, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel m3p2i_aip_tpu/ops/pallas_panda_rollout.py::_panda_kernel
// (:185; factory make_panda_rollout :676).  Each of the K samples rolls its
// 9-channel joint-velocity sequence through T control steps of the panda
// scene (m3p2i_aip_tpu/models/panda_env.py::step): the velocity drive with
// velocity / acceleration / position limits, matrix FK, grasp attach and
// detach, gravity, support surfaces (cubeA also stacks on cubeB), contact
// settling, the static AABB pushout, the held cube following the hand, the
// arm-probe and cubeA-cubeB contacts; then the reach / pick / place costs
// (PandaObjective) with the mode split by global sample index and the
// zup_gate clearance term.  Out per step: the cost and the EE's xy.
//
// The entry point takes B seeds at once, so it also replaces the TPU kernel's
// grid=(B,) call
// (pallas_panda_rollout.py:851, built by _get_batched_call :836 for the
// custom_vmap rule :881-900 that the multi-seed runner reaches under
// jax.vmap): seed b rolls its own K samples from its own start state and
// task, and every per-seed operand carries a seed stride (task [B, 10],
// state0 [B, 56], acts [B, K, T, 9], cost [B, K, T], traj [B, K, T, 2]).
// The seed is blockIdx.y; a single rollout is the B = 1 launch of the same
// body, and a batched call never shards K (each seed's k0 is 0).
//
// What bounds it on the H100: latency.  At K = 200 there are 200 independent
// serial chains of T x substeps = 24 substeps, each a few thousand dependent
// flops, and almost no data (8.6 KB of actions in, 29 KB out).  With one
// thread a sample the time was one sample's chain (0.43 ms at K = 8, 64 and
// 200 alike), and most of that chain was 31 sphere-vs-box contact tests a
// substep (three bodies x S statics of the pushout, seven arm probes x
// table, shelf and cubeB, cubeA vs cubeB), each an IEEE square root, three
// IEEE divisions and a branch.
//
// What the design does about it: a team of kTeam lanes of one warp per
// sample, in place of one thread, as the TPU kernel packed the probes on
// sublanes.  Every lane keeps the same copy of the sample's state in
// registers (joints, the three bodies, cubeA's quaternion and spin, the
// grasp) and does the same serial work: the joint drive and limits, the FK,
// grasp attach / detach, the quaternion integration, each body's gravity,
// support search and landing, the held cube, the costs.  The contact tests,
// which do not depend on each other, are split over the lanes:
//   * pushout: (body b, static s) pair j = b * S + s on lane j % kTeam of
//     round j / kTeam (two rounds at the scene's S = 3), together with the
//     probes' table and shelf tests (probe pi on lane pi), which need only
//     the FK;
//   * after the pushout and the held cube: probe pi against cubeB on lane pi
//     and cubeA against cubeB on lane kProbes, in one round.
// Each test runs the unchanged sphere_aabb arithmetic, and its results reach
// every lane through __shfl_sync within the team; every lane then adds them
// in the order of one sequential thread (the pushout in (body, static)
// order with the s == 0 assignment, the forces by static, by body and then
// by probe, cubeA-cubeB last), so all lanes hold the same bits and the
// output does not depend on kTeam, on the block or on B: a batched launch
// equals B single launches bit for bit, and this kernel gives the bits of
// the one-thread kernel it replaced.  sphere_aabb and mat_to_quat select
// their operands instead of branching (a select yields the branch's IEEE
// result), so the lanes of a warp, which test different boxes, do not
// split on them.  A team never straddles a warp, and its shuffles name only
// its own lanes, so a team past K at the ragged edge leaves as a whole.
//
// Three more cuts of the chain, each exact: the FK's 14 sines and cosines
// run on the lanes (joint j's on lane j, then shuffled), where one thread
// ran all 14 range reductions; the bodies' landing selects instead of
// branching, so the three bodies interleave; and the scenes' static count
// S = 3 is a template argument (every loop over the statics and supports
// unrolled, every gather index a constant; any other S runs the kS = 0
// instantiation, which reads S at run time).
//
// What bounds it now: still one sample's chain (the time is flat from
// K = 200 to 1000 and grows ~10% to 4000, all one wave), about a third of
// the one-thread kernel's.  Per substep the chain holds four contact tests
// in the first round (two pushout rounds and the two static probe tests)
// and one in the second; each test's IEEE square root and divisions carry
// slow-path branches that keep the tests from interleaving, and they are
// the largest share, ahead of the replicated drive and FK, the bodies and
// the costs.  The scene constants (statics, supports, body constants, dt and
// friends) come from a small param buffer built once per scene in
// ops/panda_rollout.py and staged to shared memory; the FK tables and joint
// limits are constexpr, and every product with a table entry goes through
// cdot(), which drops exact zeros and turns +-1 into a sign at compile time
// (the TPU kernel's trace-time _term / _fold_sum).  The kernel has no matrix
// product and moves ~40 KB, so TMA, wgmma and clusters have no role in it.
// Blocks are two warps, eight samples: 25 blocks at K = 200, 500 at B = 20,
// one wave at the 168 registers ptxas gives the S = 3 instantiation (a
// 64-byte stack frame for the sines' slow paths, no spills).
//
// Orientation integration: the TPU kernel carries cubeA's orientation as a
// rotation matrix integrated with Rodrigues, which differs from the XLA
// step's quaternion integration by O(|w h|^3).  This kernel carries cubeA's
// QUATERNION and integrates it as panda_env.step does (quat_integrate; the
// held cube's quaternion through mat_to_quat), so it follows the plain
// version's arithmetic, tumbling cube included.  The orientation and spin of
// dyn-obs and cubeB feed no output (their spin only ever turns their own
// orientation), so the kernel does not carry them.
//
// Floating point: built without fast math and with -fmad=false; every
// expression keeps the operation order of the plain version
// (ops/panda_rollout.py::panda_rollout_plain over models/panda_env.step), and
// constants formed from python scalars come in the param buffer, formed in
// double on the host and rounded once.

#include <cuda_runtime.h>
#include <math.h>

#include "panda_fk.cuh"
#include "team.cuh"

namespace {

constexpr int kMaxS = 8;  // static AABBs (the supports are the statics + the ground)
// lanes per sample: kTeam divides 32 (a team never straddles a warp) and
// holds the kProbes probes and the cubeA-cubeB test on lane kProbes;
// kThreads is whole warps (tests/test_torch_kernel_sources.py holds them)
constexpr int kTeam = 8;
constexpr int kThreads = 64;
constexpr int kSamplesPerBlock = kThreads / kTeam;
constexpr int kProbes = 7;  // arm probe spheres: link4-6 origins, hand, fingers, tip
constexpr int kPairRounds = (3 * kMaxS + kTeam - 1) / kTeam;  // rounds of (body, static) pushout pairs
constexpr float kGravity = 9.8f;
constexpr float kFingertipZ = 0.045f;

// param buffer layout (floats), shared with ops/panda_rollout.py::_param_buffer
enum Scalar {
  P_H = 0, P_ONE_M_DECAY, P_H2, P_GRASP, P_PHD, P_SIDE_DX, P_SIDE_DZ, P_TILT,
  P_MU_G_H, P_BASE_X, P_BASE_Y, P_BASE_Z,
  N_SCALARS = 16
};
constexpr int kBodyStride = 6;  // half x, y, z, mass, gravity flag, r_eff
constexpr int kStatStride = 6;  // min x, y, z, max x, y, z
constexpr int kSupStride = 5;   // min x, y, max x, y, top z

__device__ constexpr float kVelLim[9] = {2.175f, 2.175f, 2.175f, 2.175f, 2.61f, 2.61f, 2.61f, 0.2f, 0.2f};
__device__ constexpr float kAccLim[9] = {50.0f, 50.0f, 50.0f, 50.0f, 80.0f, 80.0f, 80.0f, 10.0f, 10.0f};

__device__ __forceinline__ float clampf(float v, float lo, float hi) { return fminf(fmaxf(v, lo), hi); }

__device__ __forceinline__ float norm3(float x, float y, float z) { return sqrtf(x * x + y * y + z * z); }

struct Links {
  float p4[3], p5[3], p6[3];   // link4..link6 origins (the arm probes)
  float hand[3], H[3][3];      // hand frame
  float left[3], right[3], ee[3], tip[3];
};

// panda_fk.fk: 7 joints (their angles' cosines c and sines s given), the
// hand, the fingers, the EE midpoint and the tip
__device__ __forceinline__ void fk(const float q[9], const float c[7], const float s[7], const float* sp, Links& L) {
  float pos[3] = {sp[P_BASE_X], sp[P_BASE_Y], sp[P_BASE_Z]};
  float R[3][3] = {{1.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f}, {0.0f, 0.0f, 1.0f}};
  fk_joint<0>(pos, R, c[0], s[0]);
  fk_joint<1>(pos, R, c[1], s[1]);
  fk_joint<2>(pos, R, c[2], s[2]);
  fk_joint<3>(pos, R, c[3], s[3]);
#pragma unroll
  for (int i = 0; i < 3; ++i) L.p4[i] = pos[i];
  fk_joint<4>(pos, R, c[4], s[4]);
#pragma unroll
  for (int i = 0; i < 3; ++i) L.p5[i] = pos[i];
  fk_joint<5>(pos, R, c[5], s[5]);
#pragma unroll
  for (int i = 0; i < 3; ++i) L.p6[i] = pos[i];
  fk_joint<6>(pos, R, c[6], s[6]);
  add_rot_const(pos, R, kHandXYZ[0], kHandXYZ[1], kHandXYZ[2]);
  mul_const(R, kHandMat);
  float fb[3] = {pos[0], pos[1], pos[2]};
  add_rot_const(fb, R, kFingerXYZ[0], kFingerXYZ[1], kFingerXYZ[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    L.hand[i] = pos[i];
#pragma unroll
    for (int j = 0; j < 3; ++j) L.H[i][j] = R[i][j];
    L.left[i] = fb[i] + R[i][1] * q[7];
    L.right[i] = fb[i] - R[i][1] * q[8];
    L.ee[i] = (L.left[i] + L.right[i]) / 2.0f;
    L.tip[i] = L.ee[i] + R[i][2] * kFingertipZ;
  }
}

// the position of arm probe pi (a lane-dependent index) of the links
__device__ __forceinline__ void probe_pos(const Links& L, int pi, float c[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float v[kProbes] = {L.p4[i], L.p5[i], L.p6[i], L.hand[i], L.left[i], L.right[i], L.tip[i]};
    c[i] = pick(v, pi);
  }
}

// quat.py:16 quat_to_rotmat, (x, y, z, w)
__device__ __forceinline__ void quat_to_rotmat(const float q[4], float M[3][3]) {
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  M[0][0] = 2.0f * (w * w + x * x) - 1.0f;
  M[0][1] = 2.0f * (x * y - w * z);
  M[0][2] = 2.0f * (x * z + w * y);
  M[1][0] = 2.0f * (x * y + w * z);
  M[1][1] = 2.0f * (w * w + y * y) - 1.0f;
  M[1][2] = 2.0f * (y * z - w * x);
  M[2][0] = 2.0f * (x * z - w * y);
  M[2][1] = 2.0f * (y * z + w * x);
  M[2][2] = 2.0f * (w * w + z * z) - 1.0f;
}

__device__ __forceinline__ void quat_normalize(float q[4]) {
  const float n = fmaxf(sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]), 1e-12f);
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
}

// quat.py:94 quat_integrate: normalize(q + 0.5 * (om, 0) * q * h)
__device__ __forceinline__ void quat_integrate(float q[4], const float om[3], float h) {
  const float aw = 0.0f, ax = om[0], ay = om[1], az = om[2];
  const float bx = q[0], by = q[1], bz = q[2], bw = q[3];
  const float m[4] = {
      aw * bx + ax * bw + ay * bz - az * by,
      aw * by - ax * bz + ay * bw + az * bx,
      aw * bz + ax * by - ay * bx + az * bw,
      aw * bw - ax * bx - ay * by - az * bz,
  };
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = q[i] + 0.5f * m[i] * h;
  quat_normalize(q);
}

// quat.py:101 mat_to_quat: the Shepperd selection (trace > 0, else the
// largest diagonal), by selects: one square root, and each component either
// 0.25 s or its case's numerator over s
__device__ __forceinline__ void mat_to_quat(const float M[3][3], float q[4]) {
  const float m00 = M[0][0], m01 = M[0][1], m02 = M[0][2];
  const float m10 = M[1][0], m11 = M[1][1], m12 = M[1][2];
  const float m20 = M[2][0], m21 = M[2][1], m22 = M[2][2];
  const float tr = m00 + m11 + m22;
  const bool c0 = tr > 0.0f;
  const bool c1 = !c0 && m00 >= m11 && m00 >= m22;
  const bool c2 = !c0 && !c1 && m11 >= m22;
  const float a = c0 ? 1.0f + tr
                     : (c1 ? 1.0f + m00 - m11 - m22 : (c2 ? 1.0f - m00 + m11 - m22 : 1.0f - m00 - m11 + m22));
  const float s = sqrtf(fmaxf(a, 1e-12f)) * 2.0f;
  const float n0 = c0 ? m21 - m12 : (c2 ? m01 + m10 : m02 + m20);
  const float n1 = c0 ? m02 - m20 : (c1 ? m01 + m10 : m12 + m21);
  const float n2 = c0 ? m10 - m01 : (c1 ? m02 + m20 : m12 + m21);
  const float n3 = c1 ? m21 - m12 : (c2 ? m02 - m20 : m10 - m01);
  q[0] = c1 ? 0.25f * s : n0 / s;
  q[1] = c2 ? 0.25f * s : n1 / s;
  q[2] = (c0 || c1 || c2) ? n2 / s : 0.25f * s;
  q[3] = c0 ? 0.25f * s : n3 / s;
  quat_normalize(q);
}

// panda_env._sphere_vs_aabb: penetration + outward normal; an inside center
// pushes out along the least-separation axis, ties sharing the push.  Both
// cases' normals come from one division per axis, on selected operands.
__device__ __forceinline__ float sphere_aabb(const float c[3], float r, const float lo[3], const float hi[3],
                                             float n[3]) {
  float diff[3], sep_lo[3], sep_hi[3], sep[3];
  bool inside = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    diff[i] = c[i] - clampf(c[i], lo[i], hi[i]);
    inside = inside && (c[i] > lo[i]) && (c[i] < hi[i]);
    sep_lo[i] = c[i] - lo[i];
    sep_hi[i] = hi[i] - c[i];
    sep[i] = fminf(sep_lo[i], sep_hi[i]);
  }
  const float dist = norm3(diff[0], diff[1], diff[2]);
  const float min_sep = fminf(fminf(sep[0], sep[1]), sep[2]);
  float oh[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) oh[i] = sep[i] <= min_sep ? 1.0f : 0.0f;
  const float cnt = oh[0] + oh[1] + oh[2];
  const float g = fmaxf(dist, 1e-9f);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float qv = (inside ? oh[i] : diff[i]) / (inside ? cnt : g);
    n[i] = inside ? (sep_hi[i] < sep_lo[i] ? 1.0f : -1.0f) * qv : qv;
  }
  return inside ? r + min_sep : r - dist;
}

// quat.py:188 general_ori_ee2cube_mat, tilt 0: ee z and y each parallel (up
// to sign) to some cube axis; `axes` holds the cube axes as rows
__device__ __forceinline__ float min_one_minus_abs_cos(const float v[3], const float axes[3][3]) {
  float m = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float cosv = fabsf(v[0] * axes[a][0] + v[1] * axes[a][1] + v[2] * axes[a][2]);
    m = fminf(m, 1.0f - cosv);
  }
  return m;
}

// kS > 0: the scene's static count S at compile time (every loop over the
// statics and supports unrolled, every gather index a constant); kS = 0
// reads it from S_arg
template <int kS>
__global__ void __launch_bounds__(kThreads)
panda_rollout_kernel(const float* __restrict__ params, const float* __restrict__ task,
                     const float* __restrict__ state0, const float* __restrict__ acts,
                     float* __restrict__ cost_out, float* __restrict__ traj_out, int K, int K_total,
                     int T, int S_arg, int substeps, int table_slot, int shelf_slot, int multi_modal,
                     int n_params) {
  const int S = kS > 0 ? kS : S_arg;
  extern __shared__ float sp[];
  for (int i = threadIdx.x; i < n_params; i += blockDim.x) sp[i] = params[i];
  __syncthreads();
  const int k = blockIdx.x * kSamplesPerBlock + threadIdx.x / kTeam;
  if (k >= K) return;  // all lanes of a team share k, so the team leaves as a whole
  const auto tm = Team<kTeam>::of_thread();
  // seed b = blockIdx.y: its task, start state and samples
  const size_t b = blockIdx.y;
  task += b * 10;
  state0 += b * 56;
  acts += b * K * T * 9;
  cost_out += b * K * T;
  traj_out += b * K * T * 2;

  const int P = S + 1;
  const float* body = sp + N_SCALARS;
  const float* stat = body + 3 * kBodyStride;
  const float* sup = stat + kStatStride * S;
  const float h = sp[P_H];

  // task: [task_id, goal pos (3), goal quat (4, xyzw), k0, zup_gate]
  const float task_id = task[0];
  const float goal[3] = {task[1], task[2], task[3]};
  float GR[3][3];
  {
    const float gq[4] = {task[4], task[5], task[6], task[7]};
    quat_to_rotmat(gq, GR);
  }
  const float gk = static_cast<float>(k) + task[8];  // global sample index
  const bool mode1 = gk >= static_cast<float>(K_total / 2) && gk < static_cast<float>(K_total);
  const float zup_gate = task[9];

  // start state, 56 floats (ops/panda_rollout.py::pack_state): q, qd,
  // body pos [3][3], body vel [3][3], cubeA om, cubeA quat, attached,
  // attach pos, attach rot [3][3]
  float q[9], qd[9], Pb[3][3], Vb[3][3], omA[3], quatA[4], apos[3], aR[3][3];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    q[i] = state0[i];
    qd[i] = state0[9 + i];
  }
#pragma unroll
  for (int b = 0; b < 3; ++b)
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      Pb[b][i] = state0[18 + 3 * b + i];
      Vb[b][i] = state0[27 + 3 * b + i];
    }
#pragma unroll
  for (int i = 0; i < 3; ++i) omA[i] = state0[36 + i];
#pragma unroll
  for (int i = 0; i < 4; ++i) quatA[i] = state0[39 + i];
  float att = state0[43];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    apos[i] = state0[44 + i];
#pragma unroll
    for (int j = 0; j < 3; ++j) aR[i][j] = state0[47 + 3 * i + j];
  }

  const float half_w = body[kBodyStride * 1 + 0];
  const float held_finger = half_w * 0.96f;
  const float release_gap = 2.0f * half_w + 0.005f;
  const float* hB = body + kBodyStride * 2;  // cubeB half sizes
  const float* tbl_st = stat + kStatStride * table_slot;
  const float* shf_st = stat + kStatStride * shelf_slot;
  // this lane's pushout pairs (lanes past the last pair repeat it; never read)
  int pair_b[kPairRounds], pair_s[kPairRounds];
#pragma unroll
  for (int r = 0; r < kPairRounds; ++r) {
    const int j = min(r * kTeam + tm.lane, 3 * S - 1);
    pair_b[r] = j / S;
    pair_s[r] = j % S;
  }
  // this lane's probe (lane kProbes repeats the last one in the static tests; never read)
  const int probe = min(tm.lane, kProbes - 1);
  const bool cube_lane = tm.lane == kProbes;  // tests cubeA vs cubeB
  const int joint = min(tm.lane, 6);  // the FK joint whose angle's cosine and sine this lane takes
  Links L;

  for (int t = 0; t < T; ++t) {
    const float* u = acts + (static_cast<size_t>(k) * T + t) * 9;
    float ucl[9];
#pragma unroll
    for (int c = 0; c < 9; ++c) ucl[c] = fminf(fmaxf(u[c], -kVelLim[c]), kVelLim[c]);
    const bool closing = u[7] < 0.0f;
    // contact-force channels the motion cost reads (x, y): table, shelf, cubeB
    float tbl[2] = {0.0f, 0.0f}, shf[2] = {0.0f, 0.0f}, cbf[2] = {0.0f, 0.0f};

    for (int sub = 0; sub < substeps; ++sub) {
      // ---- joint velocity drive + integrate + limits --------------------
#pragma unroll
      for (int c = 0; c < 9; ++c) {
        const float dv = (ucl[c] - qd[c]) * sp[P_ONE_M_DECAY];
        const float acc_h = kAccLim[c] * h;
        qd[c] = qd[c] + clampf(dv, -acc_h, acc_h);
        q[c] = clampf(q[c] + qd[c] * h, kJointLo[c], kJointHi[c]);
      }
      if (att > 0.5f) {  // the fingers rest ON the gripped cube
        q[7] = fmaxf(q[7], held_finger);
        q[8] = fmaxf(q[8], held_finger);
      }
      // cubeA's quaternion integrated ahead (the grasp reads the old one)
      float quat_next[4] = {quatA[0], quatA[1], quatA[2], quatA[3]};
      quat_integrate(quat_next, omA, h);
      // joint j's cosine and sine on lane j, then on every lane
      float cq[7], sq[7];
      {
        const float qj = pick(q, joint), cl = cosf(qj), sl = sinf(qj);
#pragma unroll
        for (int j = 0; j < 7; ++j) {
          cq[j] = tm.from(cl, j);
          sq[j] = tm.from(sl, j);
        }
      }
      fk(q, cq, sq, sp, L);

      // ---- grasp attach / detach ----------------------------------------
      const float cube[3] = {Pb[1][0], Pb[1][1], Pb[1][2]};  // substep start
      const bool near = norm3(L.tip[0] - cube[0], L.tip[1] - cube[1], L.tip[2] - cube[2]) < sp[P_GRASP];
      if (att < 0.5f && closing && near) {
        float RA[3][3];
        quat_to_rotmat(quatA, RA);
        const float d[3] = {cube[0] - L.hand[0], cube[1] - L.hand[1], cube[2] - L.hand[2]};
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          apos[j] = d[0] * L.H[0][j] + d[1] * L.H[1][j] + d[2] * L.H[2][j];
#pragma unroll
          for (int i = 0; i < 3; ++i) aR[j][i] = L.H[0][j] * RA[0][i] + L.H[1][j] * RA[1][i] + L.H[2][j] * RA[2][i];
        }
        att = 1.0f;
      }
      // only an OPENING gripper that has cleared the cube width releases
      if (!closing && q[7] + q[8] > release_gap) att = 0.0f;

      // ---- bodies: gravity, integrate, support, settling -----------------
      // (every body reads only its own and cubeB's substep-start state, so
      // all three move before the pushout; the landing selects, so the
      // three bodies interleave)
#pragma unroll
      for (int i = 0; i < 4; ++i) quatA[i] = quat_next[i];
      float np[3][3];
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const float* bc = body + kBodyStride * b;
        const bool grav = bc[4] > 0.5f;
        Vb[b][2] = Vb[b][2] + (0.0f + (-kGravity * bc[4])) * h;
#pragma unroll
        for (int i = 0; i < 3; ++i) np[b][i] = Pb[b][i] + Vb[b][i] * h;
        // support: the highest surface under the footprint, below the body
        const float old_bottom = Pb[b][2] - bc[2] + 1e-3f;
        float sup_h = -INFINITY;
#pragma unroll
        for (int p = 0; p < kMaxS + 1; ++p) {
          if (p < P) {
            const float* sv = sup + kSupStride * p;
            const bool over = np[b][0] >= sv[0] && np[b][0] <= sv[2] && np[b][1] >= sv[1] && np[b][1] <= sv[3];
            if (over && sv[4] <= old_bottom) sup_h = fmaxf(sup_h, sv[4]);
          }
        }
        if (b == 1) {  // cubeA rests on cubeB's top face too
          const float cb_top = Pb[2][2] + hB[2];
          const bool over_b = fabsf(np[b][0] - Pb[2][0]) <= hB[0] && fabsf(np[b][1] - Pb[2][1]) <= hB[1];
          if (over_b && cb_top <= Pb[1][2] - bc[2] + 1e-3f) sup_h = fmaxf(sup_h, cb_top);
        }
        const float rest_z = sup_h + bc[2];
        const bool landing = np[b][2] <= rest_z && grav;
        const float speed = sqrtf(Vb[b][0] * Vb[b][0] + Vb[b][1] * Vb[b][1]);
        const float scale = fmaxf(1.0f - sp[P_MU_G_H] / fmaxf(speed, 1e-9f), 0.0f);
        np[b][2] = landing ? rest_z : np[b][2];
        Vb[b][2] = landing ? 0.0f : Vb[b][2];
        Vb[b][0] = landing ? Vb[b][0] * scale : Vb[b][0];
        Vb[b][1] = landing ? Vb[b][1] * scale : Vb[b][1];
        if (b == 1) {  // contact settling: turn the body z-axis toward world z
          const float x = quatA[0], y = quatA[1], z = quatA[2], w = quatA[3];
          const float ux = 2.0f * (x * z + w * y), uy = 2.0f * (y * z - w * x);
          const float uz = 2.0f * (w * w + z * z) - 1.0f;
          const bool flat = uz > 0.5f;
          omA[0] = landing ? omA[0] * 0.8f + (flat ? 5.0f * uy : 0.0f) : omA[0];
          omA[1] = landing ? omA[1] * 0.8f + (flat ? 5.0f * (-ux) : 0.0f) : omA[1];
          omA[2] = landing ? omA[2] * 0.8f + 0.0f : omA[2];
        }
      }

      // ---- first contact round, over the team ---------------------------
      // lateral pushout vs the statics (the body as a sphere of r_eff): this
      // lane's pairs, each a correction and its force
      float pcx[kPairRounds], pcy[kPairRounds], pcz[kPairRounds], pfx[kPairRounds], pfy[kPairRounds];
#pragma unroll
      for (int r = 0; r < kPairRounds; ++r) {
        pcx[r] = pcy[r] = pcz[r] = pfx[r] = pfy[r] = 0.0f;
        if (r * kTeam < 3 * S) {
          const float* bc = body + kBodyStride * pair_b[r];
          const float* st = stat + kStatStride * pair_s[r];
          float c[3], n[3];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const float v[3] = {np[0][i], np[1][i], np[2][i]};
            c[i] = pick(v, pair_b[r]);
          }
          const float pen = sphere_aabb(c, bc[5], st, st + 3, n);
          if (pen > 0.0f && fabsf(n[2]) < 0.9f) {
            pcx[r] = pen * n[0];
            pcy[r] = pen * n[1];
            pcz[r] = pen * n[2];
          }
          pfx[r] = pcx[r] / sp[P_H2] * bc[3];
          pfy[r] = pcy[r] / sp[P_H2] * bc[3];
        }
      }
      // arm collision sensing: this lane's probe vs the table and the shelf
      float pc[3], ftx, fty, fsx, fsy;
      probe_pos(L, probe, pc);
      {
        float n[3];
        const float hit = fmaxf(sphere_aabb(pc, 0.05f, tbl_st, tbl_st + 3, n), 0.0f);
        ftx = (hit * n[0]) * 2000.0f;
        fty = (hit * n[1]) * 2000.0f;
      }
      {
        float n[3];
        const float hit = fmaxf(sphere_aabb(pc, 0.05f, shf_st, shf_st + 3, n), 0.0f);
        fsx = (hit * n[0]) * 2000.0f;
        fsy = (hit * n[1]) * 2000.0f;
      }

      // ---- the pushout, gathered in (body, static) order ------------------
      // the statics' pushout forces, summed over the bodies (table, shelf)
      // and cubeB's, summed over the statics, before they are accumulated
      float fsum_tbl[2] = {0.0f, 0.0f}, fsum_shf[2] = {0.0f, 0.0f}, fsum_cb[2] = {0.0f, 0.0f};
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        float corr[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int s = 0; s < kMaxS; ++s) {
          if (s < S) {
            const int j = b * S + s, src = j % kTeam, r = j / kTeam;
            const float cs[3] = {tm.from(pick(pcx, r), src), tm.from(pick(pcy, r), src), tm.from(pick(pcz, r), src)};
#pragma unroll
            for (int i = 0; i < 3; ++i) corr[i] = s == 0 ? cs[i] : corr[i] + cs[i];
            const float fx = tm.from(pick(pfx, r), src), fy = tm.from(pick(pfy, r), src);
            if (s == table_slot) {
              fsum_tbl[0] = b == 0 ? fx : fsum_tbl[0] + fx;
              fsum_tbl[1] = b == 0 ? fy : fsum_tbl[1] + fy;
            }
            if (s == shelf_slot) {
              fsum_shf[0] = b == 0 ? fx : fsum_shf[0] + fx;
              fsum_shf[1] = b == 0 ? fy : fsum_shf[1] + fy;
            }
            if (b == 2) {
              fsum_cb[0] = s == 0 ? fx : fsum_cb[0] + fx;
              fsum_cb[1] = s == 0 ? fy : fsum_cb[1] + fy;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) Pb[b][i] = np[b][i] + corr[i];
      }
      tbl[0] = tbl[0] - fsum_tbl[0];
      tbl[1] = tbl[1] - fsum_tbl[1];
      shf[0] = shf[0] - fsum_shf[0];
      shf[1] = shf[1] - fsum_shf[1];
      cbf[0] = cbf[0] + fsum_cb[0];
      cbf[1] = cbf[1] + fsum_cb[1];

      // ---- the attached cube follows the hand ----------------------------
      if (att > 0.5f) {
        float HR[3][3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float hv = L.H[i][0] * apos[0] + L.H[i][1] * apos[1] + L.H[i][2] * apos[2];
          const float held = L.hand[i] + hv;
          Vb[1][i] = (held - cube[i]) / h;  // against the substep-start position
          Pb[1][i] = held;
#pragma unroll
          for (int j = 0; j < 3; ++j) HR[i][j] = L.H[i][0] * aR[0][j] + L.H[i][1] * aR[1][j] + L.H[i][2] * aR[2][j];
        }
        mat_to_quat(HR, quatA);
      }

      // ---- second contact round: probe pi vs cubeB on lane pi, and the ---
      // held or free cubeA vs cubeB on lane kProbes (it pushes cubeB)
      const float cb_lo[3] = {Pb[2][0] - hB[0], Pb[2][1] - hB[1], Pb[2][2] - hB[2]};
      const float cb_hi[3] = {Pb[2][0] + hB[0], Pb[2][1] + hB[1], Pb[2][2] + hB[2]};
      float hit_b, nb[3], fbx, fby;
      {
        float c[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) c[i] = cube_lane ? Pb[1][i] : pc[i];
        hit_b = fmaxf(sphere_aabb(c, cube_lane ? body[kBodyStride * 1 + 5] : 0.04f, cb_lo, cb_hi, nb), 0.0f);
        fbx = (hit_b * nb[0]) * 2000.0f;
        fby = (hit_b * nb[1]) * 2000.0f;
      }
      // the probes' forces in probe order, then cubeA-cubeB's
#pragma unroll
      for (int pi = 0; pi < kProbes; ++pi) {
        tbl[0] = tbl[0] - tm.from(ftx, pi);
        tbl[1] = tbl[1] - tm.from(fty, pi);
        shf[0] = shf[0] - tm.from(fsx, pi);
        shf[1] = shf[1] - tm.from(fsy, pi);
      }
#pragma unroll
      for (int pi = 0; pi <= kProbes; ++pi) {
        cbf[0] = cbf[0] - tm.from(fbx, pi);
        cbf[1] = cbf[1] - tm.from(fby, pi);
      }
      {
        const float hit = tm.from(hit_b, kProbes), nx = tm.from(nb[0], kProbes), ny = tm.from(nb[1], kProbes);
        const float on = hit > 0.0f ? 1.0f : 0.0f;
        Pb[2][0] = Pb[2][0] + -on * nx * hit * 0.5f;
        Pb[2][1] = Pb[2][1] + -on * ny * hit * 0.5f;
      }
    }

    // ---- costs (PandaObjective.compute) on the post-step state -----------
    const float nsub = static_cast<float>(substeps);
    const float fx = tbl[0] / nsub + 4.0f * (shf[0] / nsub) + cbf[0] / nsub;
    const float fy = tbl[1] / nsub + 4.0f * (shf[1] / nsub) + cbf[1] / nsub;
    const float motion = fabsf(fx) + fabsf(fy) > 0.1f ? 1000.0f : 0.0f;

    float RA[3][3], axes[3][3];
    quat_to_rotmat(quatA, RA);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int i = 0; i < 3; ++i) axes[a][i] = RA[i][a];
    const float ee_y[3] = {L.H[0][1], L.H[1][1], L.H[2][1]};
    const float ee_z[3] = {L.H[0][2], L.H[1][2], L.H[2][2]};
    const float* cA = Pb[1];

    float cost;
    const float idx = clampf(task_id - 4.0f, 0.0f, 2.0f);
    if (idx == 0.0f) {  // reach
      float g[3] = {cA[0], cA[1], cA[2] + sp[P_PHD]};
      float cost_z = min_one_minus_abs_cos(ee_z, axes);
      if (multi_modal && mode1) {  // tilted side grasp
        g[0] = cA[0] + sp[P_SIDE_DX];
        g[2] = cA[2] + sp[P_SIDE_DZ];
        int sel = 0;
        float best = fabsf(axes[0][0]);
        if (fabsf(axes[1][0]) > best) { sel = 1; best = fabsf(axes[1][0]); }
        if (fabsf(axes[2][0]) > best) sel = 2;
        cost_z = fabsf(sp[P_TILT] - (ee_z[0] * axes[sel][0] + ee_z[1] * axes[sel][1] + ee_z[2] * axes[sel][2]));
      }
      const float tilt_cost = cost_z + min_one_minus_abs_cos(ee_y, axes);
      cost = 10.0f * norm3(L.ee[0] - g[0], L.ee[1] - g[1], L.ee[2] - g[2]) + 3.0f * tilt_cost;
    } else if (idx == 1.0f) {  // pick
      const float goal_cost = norm3(goal[0] - cA[0], goal[1] - cA[1], goal[2] - cA[2]);
      float ori = 0.0f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // goal axes x and y: best |cos| over the cube axes
        float m = -INFINITY;
#pragma unroll
        for (int j = 0; j < 3; ++j)
          m = fmaxf(m, fabsf(GR[0][i] * RA[0][j] + GR[1][i] * RA[1][j] + GR[2][i] * RA[2][j]));
        ori = i == 0 ? 1.0f - m : ori + (1.0f - m);
      }
      const float regrasp = 10.0f * norm3(L.ee[0] - cA[0], L.ee[1] - cA[1], L.ee[2] - cA[2]) * (1.0f - att);
      // z-up clearance: height deficit of the cube wedged beside a static
      const float* hA = body + kBodyStride * 1;
      float zup = 0.0f;
      for (int s = 0; s < S; ++s) {
        const float* st = stat + kStatStride * s;
        const bool overlap = cA[0] > st[0] - hA[0] && cA[0] < st[3] + hA[0] && cA[1] > st[1] - hA[1] &&
                             cA[1] < st[4] + hA[1];
        const bool wedged = (cA[2] - hA[2] - 0.02f) < st[5];
        const float needed = fmaxf(st[5] + hA[2] + 0.02f - cA[2], 0.0f);
        zup = fmaxf(zup, overlap && wedged ? needed : 0.0f);
      }
      cost = 10.0f * goal_cost + 15.0f * ori + regrasp + motion + 30.0f * zup * att * zup_gate;
    } else {  // place
      cost = 2.0f * (1.0f - norm3(L.left[0] - L.right[0], L.left[1] - L.right[1], L.left[2] - L.right[2]));
    }

    if (tm.lane == 0) {
      const size_t o = static_cast<size_t>(k) * T + t;
      cost_out[o] = cost;
      traj_out[2 * o] = L.ee[0];
      traj_out[2 * o + 1] = L.ee[1];
    }
  }
}

}  // namespace

extern "C" int m3p2i_panda_rollout(const float* params, const float* task, const float* state0,
                                   const float* acts, float* cost, float* traj, int B, int K,
                                   int K_total, int T, int S, int substeps, int table_slot,
                                   int shelf_slot, int multi_modal, int n_params, void* stream) {
  if (B <= 0 || B > 65535 || K <= 0 || T <= 0 || substeps <= 0 || S < 1 || S > kMaxS ||
      table_slot < 0 || table_slot >= S ||
      shelf_slot < 0 || shelf_slot >= S || table_slot == shelf_slot ||
      n_params != N_SCALARS + 3 * kBodyStride + kStatStride * S + kSupStride * (S + 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((K + kSamplesPerBlock - 1) / kSamplesPerBlock, B);
  const size_t smem = static_cast<size_t>(n_params) * sizeof(float);
  // the shipped panda scenes have S = 3 statics (table, table stand, shelf stand)
  const auto kernel = S == 3 ? panda_rollout_kernel<3> : panda_rollout_kernel<0>;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      params, task, state0, acts, cost, traj, K, K_total, T, S, substeps, table_slot, shelf_slot,
      multi_modal, n_params);
  return static_cast<int>(cudaGetLastError());
}
