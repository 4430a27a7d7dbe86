// Point-family MPPI rollout, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel m3p2i_aip_tpu/ops/pallas_rollout.py::_rollout_kernel
// (factory make_point_rollout, :611).  Each of the K samples rolls its action
// sequence through T control steps of the planar PBD engine
// (m3p2i_aip_tpu/models/point_env.py::step): velocity drive (2- or 3-dof omni,
// or differential drive), the robot speed cap, ground friction with the
// sample's friction scale, substeps x pos_iters rounds of the five Jacobi
// contact passes, and the arena clamp; then the point costs
// (PointObjective.compute) with the mode split by global sample index, and
// the suction force of the pull cost carried into the next step.
//
// The entry point takes B seeds at once, so it also replaces the TPU kernel's
// grid=(B,) call
// (pallas_rollout.py:802, built by _get_batched_call :785 for the
// custom_vmap rule :832-851 that the multi-seed runner reaches under
// jax.vmap): seed b rolls its own K samples from its own start state, task
// and friction scales, and every per-seed operand carries a seed stride
// (task [B, 4], state0 [B, n_state], fric_k [B, K, D], acts [B, K, T, n_u],
// cost [B, K, T], traj [B, K, T, 2]).  The seed is blockIdx.y; a single
// rollout is the B = 1 launch of the same body.  As in the JAX rule, a
// batched call never shards K, so each seed's global offset k0 is 0.
//
// What bounds it on the H100: latency.  Each sample is a serial chain of
// T * substeps * pos_iters position iterations (60 on the main path) of five
// contact passes, and the data is small (2.5 KB of actions in and 36 KB out
// at K = 200, ~60 KB for all operands): no pass is bound by bytes or by the
// card's operation rate.  The time is the length of one sample's dependency
// chain.
//
// What the design does about it: a team of kTeam lanes of one warp per
// sample, in place of one thread.  Every lane keeps the same copy of the
// sample's state in registers (the robot, the D dynamic boxes, the suction
// carries, the dyn-obs contact force) and does the same per-substep work
// (drive, speed cap, ground friction, integration, arena clamp, costs).  In
// each contact pass the team splits the contacts that do not depend on each
// other over its lanes, the way the TPU kernel packed them on sublanes:
//   * passes 1 and 5: box d on lane d;
//   * pass 2: ordered pair (i, j) on slot i * kMaxD + j, lane = slot % kTeam,
//     round = slot / kTeam, each pair's four corners on its lane;
//   * pass 3: for each box d, static si on lane si % kTeam, in rounds of
//     kTeam statics (two rounds for the main path's D = 2 boxes x S = 5);
//   * pass 4: static si on lane si % kTeam;
//   * the wall-crush probe of the costs: static si on lane si % kTeam, then
//     a max across the team (a max does not depend on the order).
// Every correction reaches every lane through __shfl_sync within the team,
// and every lane adds them in the order the plain version's sums add them
// (ops/rollout.py::point_rollout_plain over models/point_env.step), so all
// lanes hold the same bits.  Those sums are PyTorch's CUDA reductions, whose
// order is fixed by their layout: a reduction over dimensions that are not
// the innermost (the [.., S, 4, 2] position, velocity and force rows, the
// [.., S, 2] robot rows) puts element i into accumulator i % 4 and adds the
// four in order; one over the innermost ones (the [.., S, 4] yaw and spin
// rows, the [.., 4] corner rows) is a pairwise tree over 32 lanes.  Pass 3's
// position, velocity and force corrections are therefore summed per corner
// over the statics, then over the corners; its yaw and spin by the same
// tree (static s + 8 into s on the lane, then s + 4, s + 2, s + 1 across the
// team, then (c0 + c2) + (c1 + c3)); pass 4's over the statics into four
// accumulators; pass 2 sums each pair's four corners on its lane before the
// pairs are gathered.  These orders were measured on the card's torch build
// (PERF.md names it); models/point_env.step names the layouts they follow,
// and tests/test_torch_cuda.py::test_point_kernel_equals_plain_bit_for_bit
// holds the kernel to the plain version bit for bit at S = 5 and S = 16.
// Built without FMA contraction and without fast math,
// each correction is the same IEEE result it is in the plain version, so
// the kernel follows the plain version bit for bit wherever their
// arithmetic does, and its output does not depend on kTeam, on the block or
// on B: a batched launch equals B single launches bit for bit.  A team never
// straddles a warp, and its shuffles name only its own lanes, so a team past
// K at the ragged edge leaves as a whole without touching the others.
//
// Zero corrections are skipped.  A contact that is not live (pen <= 0)
// projects to corrections that are exactly +-0, and a sum that starts at +0
// and only adds can never be -0, so adding such a zero leaves its bits as
// they are.  Each round therefore ballots its live corners: only those are
// gathered, and a round in which no lane of the team has a live contact
// skips its projections and keeps only its contact tests.  The exception is
// pass 1's box state, which is not a fresh sum: its corrections are always
// projected and added, so a -0 coordinate turns +0 exactly where a
// sequential loop would turn it.  The time therefore depends on the data:
// a sample in contact pays the projections and the gathers of its live
// corners, and a warp pays the union of its four teams' rounds.
//
// What bounds it now: still one sample's chain, but per position iteration
// that chain holds one contact test per pass (two rounds of four-corner
// tests in pass 3 on the main path) and one projection in pass 1, plus the
// projections and gathers of the contacts that are live; the replicated
// per-substep work (drive, friction, integration of D boxes, the costs) and
// the serial T loop stay on every lane.  The scene constants (statics,
// per-box constants) come from a small param buffer built once per scene in
// make_point_rollout and staged to shared memory (stride 7 is odd, so lanes
// reading their own static rows hit distinct banks).  The kernel has no
// matrix product and moves ~60 KB, so TMA, wgmma and thread block clusters
// have no role in it.  Blocks are two warps, eight samples: 25 blocks at
// K = 200, 500 at B = 20, one wave at the 168 registers ptxas gives it.
//
// Semantics kept from the TPU kernel (and the XLA step it mirrors):
//   * every contact pass is Jacobi: pass 1 takes all D contacts from the
//     pre-pass robot pose and sums the robot corrections afterwards; pass 2
//     takes all box pairs from frozen poses and adds the deltas at the end;
//     pass 3 works per box over all S statics x 4 corners with
//     relax = 1 / n_active; passes 4 and 5 sum the robot corrections;
//   * the dyn-obs contact force read by the motion cost is accumulated with
//     the XLA step's signs in passes 1-3 and divided by substeps * pos_iters;
//   * task id is clipped to [0, 3] with 8 (reposition) mapped to 0;
//   * mode1 is (k + k0) >= K_total / 2, by global sample index;
//   * the suction carry starts at zero and is gated by `towards` and mode;
//   * the 1e-9 / 1e-6 division guards sit where the JAX code has them.

#include <cuda_runtime.h>
#include <math.h>

#include "pbd2d.cuh"
#include "team.cuh"

namespace {

constexpr int kMaxD = 4;    // dynamic boxes
constexpr int kMaxS = 16;   // static boxes
// lanes per sample: kTeam divides 32 (a team never straddles a warp) and is
// a multiple of kMaxD (passes 1 and 5 take one round, a pass-2 round holds
// whole rows i); 4 corners x kTeam lanes are the plain version's 32-lane
// reduction tree and two rounds hold kMaxS statics (pass 3's yaw and spin);
// kThreads is whole warps (tests/test_torch_kernel_sources.py holds them)
constexpr int kTeam = 8;
constexpr int kThreads = 64;
constexpr int kSamplesPerBlock = kThreads / kTeam;
constexpr float kGravity = 9.8f;

// param buffer layout (floats), shared with ops/rollout.py::_param_buffer
enum Scalar {
  P_H = 0, P_DECAY, P_WMR_H, P_WMR, P_RR, P_ROBOT_FRIC, P_MAX_SPEED, P_KP,
  P_ARENA, P_ARENA_LIM, P_EDGE_LIM, P_POCKET_LIM, P_WHEEL_R, P_WHEEL_B,
  N_SCALARS = 16
};
constexpr int kDynStride = 6;   // hx, hy, inv_mass, inv_inertia, ang_rad, friction
constexpr int kStatStride = 7;  // x, y, cos, sin, hx, hy, friction

__global__ void __launch_bounds__(kThreads)
point_rollout_kernel(const float* __restrict__ params, const float* __restrict__ task,
                     const float* __restrict__ state0, const float* __restrict__ fric_k,
                     const float* __restrict__ acts, float* __restrict__ cost_out,
                     float* __restrict__ traj_out, int K, int K_total, int T, int D,
                     int S, int substeps, int pos_iters, int box, int obs,
                     int robot_type, int n_q, int n_u, int multi_modal,
                     int boxer_align, int n_params) {
  extern __shared__ float sp[];
  for (int i = threadIdx.x; i < n_params; i += blockDim.x) sp[i] = params[i];
  __syncthreads();
  const int k = blockIdx.x * kSamplesPerBlock + threadIdx.x / kTeam;
  if (k >= K) return;  // all lanes of a team share k, so the team leaves as a whole
  const auto tm = Team<kTeam>::of_thread();
  // seed b = blockIdx.y: its task, start state, friction scales and samples
  const size_t b = blockIdx.y;
  task += b * 4;
  state0 += b * (2 * n_q + 6 * D);
  fric_k += b * K * D;
  acts += b * K * T * n_u;
  cost_out += b * K * T;
  traj_out += b * K * T * 2;

  const float h = sp[P_H], decay = sp[P_DECAY], wm_r = sp[P_WMR], rr = sp[P_RR];
  const float* dynp = sp + N_SCALARS;
  const float* statp = sp + N_SCALARS + kDynStride * D;
  const bool boxer = robot_type == 2;

  // task: clip the id to [0, 3], reposition (8) runs navigation
  const float task_raw = task[0];
  const float task_id = task_raw == 8.0f ? 0.0f : clampf(task_raw, 0.0f, 3.0f);
  const float gx = task[1], gy = task[2];
  const float gk = static_cast<float>(k) + task[3];  // global sample index
  const bool mode1 = gk >= static_cast<float>(K_total / 2) && gk < static_cast<float>(K_total);

  // state: q[n_q], qd[n_q], dyn_pos[D][2], dyn_yaw[D], dyn_vel[D][2], dyn_om[D]
  float qx = state0[0], qy = state0[1];
  float qyaw = n_q == 3 ? state0[2] : 0.0f;
  float qdx = state0[n_q], qdy = state0[n_q + 1];
  float qdyaw = n_q == 3 ? state0[n_q + 2] : 0.0f;
  const float* dyn0 = state0 + 2 * n_q;
  float X[kMaxD], Y[kMaxD], YAW[kMaxD], VX[kMaxD], VY[kMaxD], OM[kMaxD], FR[kMaxD];
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) {
    if (d < D) {
      X[d] = dyn0[2 * d];
      Y[d] = dyn0[2 * d + 1];
      YAW[d] = dyn0[2 * D + d];
      VX[d] = dyn0[3 * D + 2 * d];
      VY[d] = dyn0[3 * D + 2 * d + 1];
      OM[d] = dyn0[5 * D + d];
      FR[d] = dynp[kDynStride * d + 5] * fric_k[k * D + d];
    } else {
      X[d] = Y[d] = YAW[d] = VX[d] = VY[d] = OM[d] = FR[d] = 0.0f;
    }
  }
  float ext_rx = 0.0f, ext_ry = 0.0f, ext_bx = 0.0f, ext_by = 0.0f;
  // the box this lane takes in passes 1 and 5 (lanes past D repeat box D - 1,
  // and their results are never read)
  const int lane_d = min(tm.lane, D - 1);

  for (int t = 0; t < T; ++t) {
    const float* u = acts + (static_cast<size_t>(k) * T + t) * n_u;
    const float u0 = u[0], u1 = u[1], u2 = n_u == 3 ? u[2] : 0.0f;
    float f_obs_x = 0.0f, f_obs_y = 0.0f;

    for (int sub = 0; sub < substeps; ++sub) {
      // ---- velocity drive and integration (point_env.step) -------------
      qdx = qdx + ext_rx * sp[P_WMR_H];
      qdy = qdy + ext_ry * sp[P_WMR_H];
      if (boxer) {
        const float v = sp[P_WHEEL_R] * (u0 + u1) / 2.0f;
        const float om = sp[P_WHEEL_R] * (u1 - u0) * (1.0f / sp[P_WHEEL_B]);
        const float txv = v * cosf(qyaw), tyv = v * sinf(qyaw);
        qdx = txv + (qdx - txv) * decay;
        qdy = tyv + (qdy - tyv) * decay;
        qdyaw = om + (qdyaw - om) * decay;
      } else {
        qdx = u0 + (qdx - u0) * decay;
        qdy = u1 + (qdy - u1) * decay;
        if (n_q == 3) qdyaw = u2 + (qdyaw - u2) * decay;
      }
      // robot speed cap: a substep never out-runs the contact envelope (a
      // python scalar over a tensor is, in PyTorch, the tensor's reciprocal
      // times the scalar; a tensor over a python scalar, the tensor times
      // the scalar's float32 reciprocal)
      const float qsp = sqrtf(qdx * qdx + qdy * qdy);
      const float qcap = fminf(1.0f, (1.0f / fmaxf(qsp, 1e-9f)) * 6.0f);
      qdx = qdx * qcap;
      qdy = qdy * qcap;
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) {
        if (d < D) {
          if (d == box) {
            const float im_h = dynp[kDynStride * d + 2] * h;
            VX[d] = VX[d] + ext_bx * im_h;
            VY[d] = VY[d] + ext_by * im_h;
          }
          const float mu = (FR[d] + 1.0f) * 0.5f;  // PhysX average with the plane
          const float speed = sqrtf(VX[d] * VX[d] + VY[d] * VY[d]);
          const float scale = fmaxf(0.0f, 1.0f - mu * kGravity * h / fmaxf(speed, 1e-9f));
          VX[d] = VX[d] * scale;
          VY[d] = VY[d] * scale;
          const float om_scale = fmaxf(
              0.0f, 1.0f - mu * kGravity * h / fmaxf(fabsf(OM[d]) * dynp[kDynStride * d + 4], 1e-9f));
          OM[d] = OM[d] * om_scale;
          const float sp2 = sqrtf(VX[d] * VX[d] + VY[d] * VY[d]);
          const float cap = fminf(1.0f, (1.0f / fmaxf(sp2, 1e-9f)) * sp[P_MAX_SPEED]);
          VX[d] = VX[d] * cap;
          VY[d] = VY[d] * cap;
          X[d] = X[d] + VX[d] * h;
          Y[d] = Y[d] + VY[d] * h;
          YAW[d] = YAW[d] + OM[d] * h;
        }
      }
      qx = qx + qdx * h;
      qy = qy + qdy * h;
      if (n_q == 3) qyaw = qyaw + qdyaw * h;

      for (int it = 0; it < pos_iters; ++it) {
        // pass 1: robot vs every dynamic box (box d on lane d), from the
        // pre-pass robot pose
        float sqx = 0.0f, sqy = 0.0f, sqdx = 0.0f, sqdy = 0.0f;
        {
          const float* bp = dynp + kDynStride * lane_d;
          const float bx = pick(X, lane_d), by = pick(Y, lane_d), byaw = pick(YAW, lane_d);
          const Contact c = circle_vs_obb(qx, qy, rr, bx, by, cosf(byaw), sinf(byaw), bp[0], bp[1]);
          const Resolved o = resolve(c.pen, c.nx, c.ny, c.px, c.py, qx, qy, qdx, qdy, 0.0f, wm_r, 0.0f,
                                     bx, by, pick(VX, lane_d), pick(VY, lane_d), pick(OM, lane_d),
                                     bp[2], bp[3], h, (sp[P_ROBOT_FRIC] + pick(FR, lane_d)) / 2.0f, 1.0f);
          const unsigned act = tm.ballot(tm.lane < D && c.pen > 0.0f);
#pragma unroll
          for (int d = 0; d < kMaxD; ++d) {
            if (d < D) {
              // the box state is not a fresh sum, so its (signed zero)
              // corrections are added whether the contact is live or not
              X[d] += tm.from(o.dbx, d);
              Y[d] += tm.from(o.dby, d);
              YAW[d] += tm.from(o.dyaw_b, d);
              VX[d] += tm.from(o.dvbx, d);
              VY[d] += tm.from(o.dvby, d);
              OM[d] += tm.from(o.dom_b, d);
              if ((act >> d) & 1u) {
                if (d == obs) {
                  f_obs_x -= tm.from(o.fx, d);
                  f_obs_y -= tm.from(o.fy, d);
                }
                sqx += tm.from(o.dax, d);
                sqy += tm.from(o.day, d);
                sqdx += tm.from(o.dvax, d);
                sqdy += tm.from(o.dvay, d);
              }
            }
          }
        }
        qx += sqx;
        qy += sqy;
        qdx += sqdx;
        qdy += sqdy;

        // pass 2: dynamic vs dynamic, every ordered pair (i, j) from frozen
        // poses; slot i * kMaxD + j sits on lane slot % kTeam of round
        // slot / kTeam.  Each lane sums its pair's four corners as the plain
        // version's sums do (positions, velocities and forces in corner
        // order, yaw and spin as (c0 + c2) + (c1 + c3)), and the pairs with a
        // live corner are gathered in slot order
        if (D > 1) {
          float dX[kMaxD], dY[kMaxD], dYAW[kMaxD], dVX[kMaxD], dVY[kMaxD], dOM[kMaxD];
#pragma unroll
          for (int d = 0; d < kMaxD; ++d) dX[d] = dY[d] = dYAW[d] = dVX[d] = dVY[d] = dOM[d] = 0.0f;
          float dfx = 0.0f, dfy = 0.0f;  // the dyn-obs's pass-2 force
#pragma unroll
          for (int r = 0; r < kMaxD * kMaxD / kTeam; ++r) {
            if (r * kTeam / kMaxD >= D) continue;  // no row i < D in this round
            const int slot = r * kTeam + tm.lane;
            const bool valid = slot / kMaxD < D && slot % kMaxD < D && slot / kMaxD != slot % kMaxD;
            const int i = min(slot / kMaxD, D - 1), j = min(slot % kMaxD, D - 1);
            const float* pi = dynp + kDynStride * i;
            const float* pj = dynp + kDynStride * j;
            const float xi = pick(X, i), yi = pick(Y, i), yawi = pick(YAW, i);
            const float xj = pick(X, j), yj = pick(Y, j), yawj = pick(YAW, j);
            const CornerContacts cc = corners_vs_obb(xi, yi, cosf(yawi), sinf(yawi), pi[0], pi[1],
                                                     xj, yj, cosf(yawj), sinf(yawj), pj[0], pj[1]);
            bool live = false;
#pragma unroll
            for (int m = 0; m < 4; ++m) live = live || cc.pen[m] > 0.0f;
            const unsigned act = tm.ballot(valid && live);
            if (act == 0u) continue;  // no live corner in the team's round
            const float vxi = pick(VX, i), vyi = pick(VY, i), omi = pick(OM, i);
            const float vxj = pick(VX, j), vyj = pick(VY, j), omj = pick(OM, j);
            const float fr = (pick(FR, i) + pick(FR, j)) / 2.0f;
            Resolved o[4];
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              o[m] = resolve(cc.pen[m], cc.nx, cc.ny, cc.wx[m], cc.wy[m], xi, yi, vxi, vyi, omi, pi[2],
                             pi[3], xj, yj, vxj, vyj, omj, pj[2], pj[3], h, fr, 0.5f);
            }
            const Resolved ps = corner_sum(o);
#pragma unroll
            for (int l = 0; l < kTeam; ++l) {
              const int gi = (r * kTeam + l) / kMaxD, gj = (r * kTeam + l) % kMaxD;
              if (gi == gj || !((act >> l) & 1u)) continue;
              dX[gi] += tm.from(ps.dax, l);
              dX[gj] += tm.from(ps.dbx, l);
              dYAW[gi] += tm.from(ps.dyaw_a, l);
              dYAW[gj] += tm.from(ps.dyaw_b, l);
              dVX[gi] += tm.from(ps.dvax, l);
              dVX[gj] += tm.from(ps.dvbx, l);
              dOM[gi] += tm.from(ps.dom_a, l);
              dOM[gj] += tm.from(ps.dom_b, l);
              dY[gi] += tm.from(ps.day, l);
              dY[gj] += tm.from(ps.dby, l);
              dVY[gi] += tm.from(ps.dvay, l);
              dVY[gj] += tm.from(ps.dvby, l);
              if (gi == obs) {
                dfx += tm.from(ps.fx, l);
                dfy += tm.from(ps.fy, l);
              }
              if (gj == obs) {
                dfx -= tm.from(ps.fx, l);
                dfy -= tm.from(ps.fy, l);
              }
            }
          }
#pragma unroll
          for (int d = 0; d < kMaxD; ++d) {
            X[d] += dX[d];
            Y[d] += dY[d];
            YAW[d] += dYAW[d];
            VX[d] += dVX[d];
            VY[d] += dVY[d];
            OM[d] += dOM[d];
          }
          f_obs_x += dfx;
          f_obs_y += dfy;
        }

        // pass 3: each dynamic box vs all statics x 4 corners, full strength;
        // static si on lane si % kTeam, rounds of kTeam statics.  The
        // corrections are added as the plain version's sums over (static,
        // corner) add them: positions, velocities and forces per corner over
        // the statics in order, then the four corners in order; yaw and
        // spin by the pairwise tree of a 32-lane reduction, static s + 8 into
        // s, then s + 4, s + 2 and s + 1 across the team, then
        // (c0 + c2) + (c1 + c3)
#pragma unroll
        for (int d = 0; d < kMaxD; ++d) {
          if (d < D) {
            const float* bp = dynp + kDynStride * d;
            const float c = cosf(YAW[d]), s = sinf(YAW[d]);
            Resolved acc[4], mine[4];  // per corner: over the statics; this lane's statics
#pragma unroll
            for (int m = 0; m < 4; ++m) acc[m] = mine[m] = Resolved{};
            bool any_live = false;
#pragma unroll 1
            for (int s0 = 0; s0 < S; s0 += kTeam) {
              const float* st = statp + kStatStride * min(s0 + tm.lane, S - 1);
              const CornerContacts cc = corners_vs_obb(X[d], Y[d], c, s, bp[0], bp[1],
                                                       st[0], st[1], st[2], st[3], st[4], st[5]);
              unsigned act[4], any = 0u;
#pragma unroll
              for (int m = 0; m < 4; ++m) {
                act[m] = tm.ballot(s0 + tm.lane < S && cc.pen[m] > 0.0f);
                any |= act[m];
              }
              if (any == 0u) continue;  // no live corner in the team's round
              any_live = true;
              float n_act = 0.0f;
#pragma unroll
              for (int m = 0; m < 4; ++m) n_act += cc.pen[m] > 0.0f ? 1.0f : 0.0f;
              const float relax = 1.0f / fmaxf(n_act, 1.0f);
#pragma unroll
              for (int m = 0; m < 4; ++m) {
                const Resolved o = resolve(cc.pen[m], cc.nx, cc.ny, cc.wx[m], cc.wy[m],
                                           X[d], Y[d], VX[d], VY[d], OM[d], bp[2], bp[3],
                                           st[0], st[1], 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, h,
                                           (FR[d] + st[6]) / 2.0f, relax);
                if ((act[m] >> tm.lane) & 1u) {
                  mine[m].dyaw_a += o.dyaw_a;
                  mine[m].dom_a += o.dom_a;
                }
#pragma unroll
                for (int l = 0; l < kTeam; ++l) {
                  if ((act[m] >> l) & 1u) {
                    acc[m].dax += tm.from(o.dax, l);
                    acc[m].day += tm.from(o.day, l);
                    acc[m].dvax += tm.from(o.dvax, l);
                    acc[m].dvay += tm.from(o.dvay, l);
                    if (d == obs) {
                      acc[m].fx += tm.from(o.fx, l);
                      acc[m].fy += tm.from(o.fy, l);
                    }
                  }
                }
              }
            }
            float tyaw = 0.0f, tom = 0.0f;
            if (any_live) {
              float ty[4], to[4];
#pragma unroll
              for (int m = 0; m < 4; ++m) {
                ty[m] = mine[m].dyaw_a;
                to[m] = mine[m].dom_a;
#pragma unroll
                for (int off = kTeam / 2; off > 0; off /= 2) {
                  ty[m] += __shfl_down_sync(tm.mask, ty[m], off, kTeam);
                  to[m] += __shfl_down_sync(tm.mask, to[m], off, kTeam);
                }
              }
              tyaw = tm.from((ty[0] + ty[2]) + (ty[1] + ty[3]), 0);
              tom = tm.from((to[0] + to[2]) + (to[1] + to[3]), 0);
            }
            X[d] += ((acc[0].dax + acc[1].dax) + acc[2].dax) + acc[3].dax;
            Y[d] += ((acc[0].day + acc[1].day) + acc[2].day) + acc[3].day;
            YAW[d] += tyaw;
            VX[d] += ((acc[0].dvax + acc[1].dvax) + acc[2].dvax) + acc[3].dvax;
            VY[d] += ((acc[0].dvay + acc[1].dvay) + acc[2].dvay) + acc[3].dvay;
            OM[d] += tom;
            if (d == obs) {
              f_obs_x += ((acc[0].fx + acc[1].fx) + acc[2].fx) + acc[3].fx;
              f_obs_y += ((acc[0].fy + acc[1].fy) + acc[2].fy) + acc[3].fy;
            }
          }
        }

        // pass 4: robot vs all statics (static si on lane si % kTeam), full
        // strength; added as the plain version's sum over the statics adds:
        // static s into accumulator s % 4, then the four in order
        {
          float ax[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ay[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          float avx[4] = {0.0f, 0.0f, 0.0f, 0.0f}, avy[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
          for (int s0 = 0; s0 < S; s0 += kTeam) {
            const float* st = statp + kStatStride * min(s0 + tm.lane, S - 1);
            const Contact c = circle_vs_obb(qx, qy, rr, st[0], st[1], st[2], st[3], st[4], st[5]);
            const unsigned act = tm.ballot(s0 + tm.lane < S && c.pen > 0.0f);
            if (act == 0u) continue;
            const Resolved o = resolve(c.pen, c.nx, c.ny, c.px, c.py, qx, qy, qdx, qdy, 0.0f, wm_r, 0.0f,
                                       st[0], st[1], 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, h,
                                       (sp[P_ROBOT_FRIC] + st[6]) / 2.0f, 1.0f);
#pragma unroll
            for (int l = 0; l < kTeam; ++l) {
              if ((act >> l) & 1u) {
                ax[l % 4] += tm.from(o.dax, l);
                ay[l % 4] += tm.from(o.day, l);
                avx[l % 4] += tm.from(o.dvax, l);
                avy[l % 4] += tm.from(o.dvay, l);
              }
            }
          }
          qx += ((ax[0] + ax[1]) + ax[2]) + ax[3];
          qy += ((ay[0] + ay[1]) + ay[2]) + ay[3];
          qdx += ((avx[0] + avx[1]) + avx[2]) + avx[3];
          qdy += ((avy[0] + avy[1]) + avy[2]) + avy[3];
        }

        // pass 5: robot vs the dynamic boxes held immovable (box d on lane d)
        sqx = sqy = sqdx = sqdy = 0.0f;
        {
          const float* bp = dynp + kDynStride * lane_d;
          const float bx = pick(X, lane_d), by = pick(Y, lane_d), byaw = pick(YAW, lane_d);
          const Contact c = circle_vs_obb(qx, qy, rr, bx, by, cosf(byaw), sinf(byaw), bp[0], bp[1]);
          const unsigned act = tm.ballot(tm.lane < D && c.pen > 0.0f);
          if (act != 0u) {
            const Resolved o = resolve(c.pen, c.nx, c.ny, c.px, c.py, qx, qy, qdx, qdy, 0.0f, wm_r, 0.0f,
                                       bx, by, pick(VX, lane_d), pick(VY, lane_d), pick(OM, lane_d),
                                       0.0f, 0.0f, h, 0.0f, 1.0f);
#pragma unroll
            for (int d = 0; d < kMaxD; ++d) {
              if ((act >> d) & 1u) {
                sqx += tm.from(o.dax, d);
                sqy += tm.from(o.day, d);
                sqdx += tm.from(o.dvax, d);
                sqdy += tm.from(o.dvay, d);
              }
            }
          }
        }
        qx += sqx;
        qy += sqy;
        qdx += sqdx;
        qdy += sqdy;
      }

      // closed-arena invariant
      if (sp[P_ARENA] > 0.0f) {
        qx = clampf(qx, -sp[P_ARENA_LIM], sp[P_ARENA_LIM]);
        qy = clampf(qy, -sp[P_ARENA_LIM], sp[P_ARENA_LIM]);
      }
    }

    // ---- costs (PointObjective.compute) ---------------------------------
    const float n_norm = static_cast<float>(substeps * pos_iters);
    const float inv_norm = 1.0f / n_norm;
    const float coll = fabsf(f_obs_x * inv_norm) + fabsf(f_obs_y * inv_norm);
    const float motion_cost = coll > 0.1f ? 1000.0f : 0.0f;

    float bx = 0.0f, by = 0.0f;
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) {
      if (d == box) {
        bx = X[d];
        by = Y[d];
      }
    }
    const float r2bx = qx - bx, r2by = qy - by;
    const float b2gx = gx - bx, b2gy = gy - by;
    const float d_rb = sqrtf(r2bx * r2bx + r2by * r2by);
    const float d_bg = sqrtf(b2gx * b2gx + b2gy * b2gy);
    const float dist_cost = d_rb + d_bg * 10.0f;
    const float cos_theta = (r2bx * b2gx + r2by * b2gy) / fmaxf(d_rb * d_bg, 1e-9f);

    const float ngx = qx - gx, ngy = qy - gy;
    const float nav = sqrtf(ngx * ngx + ngy * ngy) + motion_cost;
    const float push_align = (boxer && boxer_align) ? 1.5f * (1.0f + cos_theta) : fmaxf(cos_theta, 0.0f);
    const float push = 3.0f * dist_cost + 1.0f * push_align;

    // pull: suction (rollout threshold 1.8), velocity and alignment costs
    const float pdx = bx - qx, pdy = by - qy;
    const bool towards = (qdx * pdx + qdy * pdy) > 0.0f;
    const float mag = 1.0f / fmaxf(d_rb, 1e-6f);
    const float gate = mag > 1.8f ? 1.0f : 0.0f;
    const float fbx = clampf(-sp[P_KP] * (pdx * mag) * gate, -500.0f, 500.0f);
    const float fby = clampf(-sp[P_KP] * (pdy * mag) * gate, -500.0f, 500.0f);
    const float frx = clampf(sp[P_KP] * (pdx * mag) * gate, -500.0f, 500.0f);
    const float fry = clampf(sp[P_KP] * (pdy * mag) * gate, -500.0f, 500.0f);
    const bool off = towards || (multi_modal && !mode1);
    const float vel_cost = (towards && d_rb <= 0.5f) ? 0.6f : 0.0f;
    // wall crush: max robot-circle penetration into the statics (static si
    // on lane si % kTeam, then the max across the team)
    float crush_pen = -INFINITY;
#pragma unroll 1
    for (int s0 = 0; s0 < S; s0 += kTeam) {
      const float* st = statp + kStatStride * min(s0 + tm.lane, S - 1);
      crush_pen = fmaxf(crush_pen, circle_vs_obb(qx, qy, rr, st[0], st[1], st[2], st[3], st[4], st[5]).pen);
    }
#pragma unroll
    for (int off_l = kTeam / 2; off_l > 0; off_l /= 2) {
      crush_pen = fmaxf(crush_pen, __shfl_xor_sync(tm.mask, crush_pen, off_l, kTeam));
    }
    if (sp[P_ARENA] > 0.0f) {
      if (fmaxf(fabsf(qx), fabsf(qy)) > sp[P_EDGE_LIM]) crush_pen = 1.0f;
      if (multi_modal && boxer) {
        const bool goal_in_pocket = fmaxf(fabsf(gx), fabsf(gy)) > sp[P_POCKET_LIM];
        if (goal_in_pocket && d_bg < 1.0f) crush_pen = 1.0f;
      }
    }
    const float crush = crush_pen > 0.02f ? 1000.0f : 0.0f;
    const float pull = 3.0f * dist_cost + 3.0f * vel_cost + 7.0f * fmaxf(-cos_theta, 0.0f) + crush;
    const float push_pull = mode1 ? pull : push;

    float cost;
    if (task_id == 0.0f) {
      cost = nav;
    } else if (task_id == 1.0f) {
      cost = push;
    } else if (task_id == 2.0f) {
      cost = pull;
    } else {
      cost = push_pull;
    }
    // suction for the NEXT step: pull applies it to every sample (mode-gated
    // by `off` when multi-modal), push_pull to the pull half only
    const bool sel = task_id == 2.0f || (task_id == 3.0f && mode1);
    const bool apply = sel && !off;
    ext_bx = apply ? fbx : 0.0f;
    ext_by = apply ? fby : 0.0f;
    ext_rx = apply ? frx : 0.0f;
    ext_ry = apply ? fry : 0.0f;

    if (tm.lane == 0) {
      const size_t o = static_cast<size_t>(k) * T + t;
      cost_out[o] = cost;
      traj_out[2 * o] = qx;
      traj_out[2 * o + 1] = qy;
    }
  }
}

}  // namespace

extern "C" int m3p2i_point_rollout(const float* params, const float* task, const float* state0,
                                   const float* fric_k, const float* acts, float* cost, float* traj,
                                   int B, int K, int K_total, int T, int D, int S, int substeps,
                                   int pos_iters, int box, int obs, int robot_type, int n_q,
                                   int n_u, int multi_modal, int boxer_align, int n_params,
                                   void* stream) {
  if (B <= 0 || B > 65535 || K <= 0 || T <= 0 || D < 1 || D > kMaxD || S < 1 || S > kMaxS ||
      n_params != N_SCALARS + kDynStride * D + kStatStride * S || box < 0 || box >= D ||
      obs < 0 || obs >= D) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((K + kSamplesPerBlock - 1) / kSamplesPerBlock, B);
  const size_t smem = static_cast<size_t>(n_params) * sizeof(float);
  point_rollout_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      params, task, state0, fric_k, acts, cost, traj, K, K_total, T, D, S, substeps,
      pos_iters, box, obs, robot_type, n_q, n_u, multi_modal, boxer_align, n_params);
  return static_cast<int>(cudaGetLastError());
}

