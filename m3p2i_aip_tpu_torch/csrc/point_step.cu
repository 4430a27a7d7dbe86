// The point family's real-env step, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's real-env step
// (m3p2i_aip_tpu/models/point_env.py::step) is XLA code, which the TPU runs
// fused inside the jitted tick.  Its plain PyTorch version
// (models/point_env.step) is ~4,600 small kernels a control tick on the
// card, and the compiled point tick spent most of its device time there.
// This kernel is that function in one launch, for B states at once (B = 1
// for one robot, B = 20 for a seed batch; any leading batch dims of the
// state, flattened): velocity drive (2- or 3-dof omni, or differential
// drive), the robot speed cap, the external (suction) forces on the robot
// and on every dynamic box, ground friction with each state's friction
// scale, integration, substeps x pos_iters rounds of the five Jacobi contact
// passes, the arena clamp, and each actor's contact force [A, 3] (robot,
// dynamic boxes, statics; z = 0) over substeps x pos_iters.
//
// What bounds it on the H100: latency.  A state's step is a serial chain of
// substeps x pos_iters position iterations (4 on the main path) of five
// contact passes, over ~300 bytes of state: no pass is bound by bytes or by
// the card's operation rate.  The time is the chain's length plus one
// launch.
//
// What the design does about it: the step body of the point rollout kernel
// (csrc/point_rollout.cu, K1), whose head note gives the design and the sum
// orders, on one state: a team of kTeam lanes of one warp, the state in
// every lane's registers, the independent contacts of each pass split over
// the lanes (passes 1 and 5: box d on lane d; pass 2: ordered pair (i, j) on
// slot i * kMaxD + j; passes 3 and 4: static s on lane s % kTeam), every
// correction added on every lane in the order PyTorch's CUDA reductions add
// the plain version's sums (the same layouts, with or without a leading
// batch dim), live-contact ballots that skip the +-0 corrections of dead
// contacts, and no FMA contraction (cuda_build's -fmad=false).  The state is
// blockIdx.x; a block is one team.  Beyond K1 it carries every force the
// plain step accumulates:
//   * the robot's (passes 1 and 4) and every dynamic box's (passes 1-3), on
//     every lane;
//   * each static's (passes 3 and 4) on its own lane: pass 3's as the plain
//     version's sum over (box, corner) adds it, per corner over the boxes in
//     order, then the four corners in order; pass 4's element by element;
//   * and it takes the caller's ext.robot and ext.dyn (K1 derives its own
//     suction from the costs).
// The scene constants come from a param buffer built once per scene
// (ops/point_step.py::param_buffer: the scalars as the plain step rounds its
// python floats, the per-box and per-static constants as it computes them on
// the card), staged to shared memory.  Each state's inputs are read through
// a row stride, so a strided action row or a broadcast input needs no copy.

#include <cuda_runtime.h>
#include <math.h>

#include "pbd2d.cuh"
#include "team.cuh"

namespace {

constexpr int kMaxD = 4;   // dynamic boxes
constexpr int kMaxS = 16;  // static boxes
// lanes per state: as K1's team (kTeam divides 32 and is a multiple of
// kMaxD; two rounds hold kMaxS statics; 4 corners x kTeam lanes are pass
// 3's 32-lane yaw tree); the block is the team
constexpr int kTeam = 8;
constexpr int kRounds = kMaxS / kTeam;  // rounds of statics in passes 3 and 4
constexpr float kGravity = 9.8f;

// param buffer layout (floats), shared with ops/point_step.py::param_buffer
enum Scalar {
  P_H = 0, P_DECAY, P_WMR_H, P_WMR, P_RR, P_ROBOT_FRIC, P_MAX_SPEED, P_ARENA, P_ARENA_LIM,
  P_WHEEL_R, P_WHEEL_B, N_SCALARS
};
constexpr int kDynStride = 6;   // hx, hy, inv_mass, inv_inertia, ang_rad, friction
constexpr int kStatStride = 7;  // x, y, cos, sin, hx, hy, friction
// then one float per actor: the force row it takes (-1: none, kRowRobot,
// kRowDyn + box slot, kRowStat + static slot)
constexpr int kRowRobot = 0;
constexpr int kRowDyn = 1;
constexpr int kRowStat = kRowDyn + kMaxD;

// the operands, in ops/point_step.py's order (INPUTS, OUTPUTS)
enum Input { I_Q = 0, I_QD, I_DYN_POS, I_DYN_YAW, I_DYN_VEL, I_DYN_OM, I_FRIC_SCALE, I_U, I_EXT_ROBOT, I_EXT_DYN, N_INPUTS };
enum Output { O_Q = 0, O_QD, O_DYN_POS, O_DYN_YAW, O_DYN_VEL, O_DYN_OM, O_CONTACT_FORCE, N_OUTPUTS };

struct Operands {
  const float* in[N_INPUTS];
  long long stride[N_INPUTS];  // floats between two states' rows (0: one row for every state)
  float* out[N_OUTPUTS];       // contiguous, one row a state
};

__global__ void __launch_bounds__(kTeam)
point_env_step_kernel(const float* __restrict__ params, const Operands ops, int D, int S, int A,
                      int substeps, int pos_iters, int robot_type, int n_q, int n_u, int n_params) {
  extern __shared__ float sp[];
  __shared__ float stat_force[kMaxS][2];
  for (int i = threadIdx.x; i < n_params; i += blockDim.x) sp[i] = params[i];
  __syncthreads();
  const auto tm = Team<kTeam>::of_thread();
  const size_t b = blockIdx.x;
  const float* in[N_INPUTS];
#pragma unroll
  for (int i = 0; i < N_INPUTS; ++i) in[i] = ops.in[i] + b * ops.stride[i];

  const float h = sp[P_H], decay = sp[P_DECAY], wm_r = sp[P_WMR], rr = sp[P_RR];
  const float* dynp = sp + N_SCALARS;
  const float* statp = sp + N_SCALARS + kDynStride * D;
  const float* rows = statp + kStatStride * S;
  const bool boxer = robot_type == 2;

  float qx = in[I_Q][0], qy = in[I_Q][1];
  float qyaw = n_q == 3 ? in[I_Q][2] : 0.0f;
  float qdx = in[I_QD][0], qdy = in[I_QD][1];
  float qdyaw = n_q == 3 ? in[I_QD][2] : 0.0f;
  const float u0 = in[I_U][0], u1 = in[I_U][1], u2 = n_u == 3 ? in[I_U][2] : 0.0f;
  const float ext_rx = in[I_EXT_ROBOT][0], ext_ry = in[I_EXT_ROBOT][1];
  float X[kMaxD], Y[kMaxD], YAW[kMaxD], VX[kMaxD], VY[kMaxD], OM[kMaxD], FR[kMaxD], EX[kMaxD], EY[kMaxD];
  float FDX[kMaxD], FDY[kMaxD];  // the dynamic boxes' contact forces (f_dyn)
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) {
    if (d < D) {
      X[d] = in[I_DYN_POS][2 * d];
      Y[d] = in[I_DYN_POS][2 * d + 1];
      YAW[d] = in[I_DYN_YAW][d];
      VX[d] = in[I_DYN_VEL][2 * d];
      VY[d] = in[I_DYN_VEL][2 * d + 1];
      OM[d] = in[I_DYN_OM][d];
      FR[d] = dynp[kDynStride * d + 5] * in[I_FRIC_SCALE][d];
      EX[d] = in[I_EXT_DYN][2 * d];
      EY[d] = in[I_EXT_DYN][2 * d + 1];
    } else {
      X[d] = Y[d] = YAW[d] = VX[d] = VY[d] = OM[d] = FR[d] = EX[d] = EY[d] = 0.0f;
    }
    FDX[d] = FDY[d] = 0.0f;
  }
  float FRX = 0.0f, FRY = 0.0f;  // the robot's (f_rob)
  float FSX[kRounds], FSY[kRounds];  // this lane's statics' (f_stat), static r * kTeam + lane
#pragma unroll
  for (int r = 0; r < kRounds; ++r) FSX[r] = FSY[r] = 0.0f;
  // the box this lane takes in passes 1 and 5 (lanes past D repeat box D - 1,
  // and their results are never read)
  const int lane_d = min(tm.lane, D - 1);

  for (int sub = 0; sub < substeps; ++sub) {
    // ---- velocity drive and integration ---------------------------------
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
    // robot speed cap (a python scalar over a tensor is, in PyTorch, the
    // tensor's reciprocal times the scalar)
    const float qsp = sqrtf(qdx * qdx + qdy * qdy);
    const float qcap = fminf(1.0f, (1.0f / fmaxf(qsp, 1e-9f)) * 6.0f);
    qdx = qdx * qcap;
    qdy = qdy * qcap;
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) {
      if (d < D) {
        const float im_h = dynp[kDynStride * d + 2] * h;
        VX[d] = VX[d] + EX[d] * im_h;
        VY[d] = VY[d] + EY[d] * im_h;
        const float mu = (FR[d] + 1.0f) * 0.5f;  // PhysX average with the plane
        const float speed = sqrtf(VX[d] * VX[d] + VY[d] * VY[d]);
        const float scale = fmaxf(0.0f, 1.0f - mu * kGravity * h / fmaxf(speed, 1e-9f));
        VX[d] = VX[d] * scale;
        VY[d] = VY[d] * scale;
        const float om_scale =
            fmaxf(0.0f, 1.0f - mu * kGravity * h / fmaxf(fabsf(OM[d]) * dynp[kDynStride * d + 4], 1e-9f));
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
      // pre-pass robot pose; the robot's sums over the boxes, each box's
      // force its own
      float sqx = 0.0f, sqy = 0.0f, sqdx = 0.0f, sqdy = 0.0f, sfx = 0.0f, sfy = 0.0f;
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
              const float fx = tm.from(o.fx, d), fy = tm.from(o.fy, d);
              FDX[d] -= fx;
              FDY[d] -= fy;
              sfx += fx;
              sfy += fy;
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
      FRX += sfx;
      FRY += sfy;

      // pass 2: dynamic vs dynamic, every ordered pair (i, j) from frozen
      // poses; slot i * kMaxD + j on lane slot % kTeam of round slot / kTeam;
      // each lane sums its pair's four corners, and the pairs with a live
      // corner are gathered in slot order
      if (D > 1) {
        float dX[kMaxD], dY[kMaxD], dYAW[kMaxD], dVX[kMaxD], dVY[kMaxD], dOM[kMaxD], dFX[kMaxD], dFY[kMaxD];
#pragma unroll
        for (int d = 0; d < kMaxD; ++d) dX[d] = dY[d] = dYAW[d] = dVX[d] = dVY[d] = dOM[d] = dFX[d] = dFY[d] = 0.0f;
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
            const float fx = tm.from(ps.fx, l), fy = tm.from(ps.fy, l);
            dFX[gi] += fx;
            dFY[gi] += fy;
            dFX[gj] -= fx;
            dFY[gj] -= fy;
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
          FDX[d] += dFX[d];
          FDY[d] += dFY[d];
        }
      }

      // pass 3: each dynamic box vs all statics x 4 corners, full strength;
      // static si on lane si % kTeam, rounds of kTeam statics.  A box's
      // corrections and force are added as the plain version's sums over
      // (static, corner) add them (positions, velocities and forces per
      // corner over the statics, then the corners in order; yaw and spin by
      // the 32-lane tree); each static's force as the sum over (box, corner)
      // adds it: per corner over the boxes, then the corners in order
      {
        float SX[kRounds][4], SY[kRounds][4];  // this lane's statics' forces, per corner over the boxes
#pragma unroll
        for (int r = 0; r < kRounds; ++r) {
#pragma unroll
          for (int m = 0; m < 4; ++m) SX[r][m] = SY[r][m] = 0.0f;
        }
#pragma unroll
        for (int d = 0; d < kMaxD; ++d) {
          if (d < D) {
            const float* bp = dynp + kDynStride * d;
            const float c = cosf(YAW[d]), s = sinf(YAW[d]);
            Resolved acc[4], mine[4];  // per corner: over the statics; this lane's statics
#pragma unroll
            for (int m = 0; m < 4; ++m) acc[m] = mine[m] = Resolved{};
            bool any_live = false;
#pragma unroll
            for (int r = 0; r < kRounds; ++r) {
              const int s0 = r * kTeam;
              if (s0 >= S) break;
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
                  SX[r][m] += o.fx;
                  SY[r][m] += o.fy;
                }
#pragma unroll
                for (int l = 0; l < kTeam; ++l) {
                  if ((act[m] >> l) & 1u) {
                    acc[m].dax += tm.from(o.dax, l);
                    acc[m].day += tm.from(o.day, l);
                    acc[m].dvax += tm.from(o.dvax, l);
                    acc[m].dvay += tm.from(o.dvay, l);
                    acc[m].fx += tm.from(o.fx, l);
                    acc[m].fy += tm.from(o.fy, l);
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
            FDX[d] += ((acc[0].fx + acc[1].fx) + acc[2].fx) + acc[3].fx;
            FDY[d] += ((acc[0].fy + acc[1].fy) + acc[2].fy) + acc[3].fy;
          }
        }
#pragma unroll
        for (int r = 0; r < kRounds; ++r) {
          FSX[r] -= ((SX[r][0] + SX[r][1]) + SX[r][2]) + SX[r][3];
          FSY[r] -= ((SY[r][0] + SY[r][1]) + SY[r][2]) + SY[r][3];
        }
      }

      // pass 4: robot vs all statics (static si on lane si % kTeam), full
      // strength; the robot's sums over the statics as the plain version
      // adds them: static s into accumulator s % 4, then the four in order;
      // each static's force on its own lane
      {
        float ax[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ay[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float avx[4] = {0.0f, 0.0f, 0.0f, 0.0f}, avy[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float afx[4] = {0.0f, 0.0f, 0.0f, 0.0f}, afy[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int r = 0; r < kRounds; ++r) {
          const int s0 = r * kTeam;
          if (s0 >= S) break;
          const float* st = statp + kStatStride * min(s0 + tm.lane, S - 1);
          const Contact c = circle_vs_obb(qx, qy, rr, st[0], st[1], st[2], st[3], st[4], st[5]);
          const unsigned act = tm.ballot(s0 + tm.lane < S && c.pen > 0.0f);
          if (act == 0u) continue;
          const Resolved o = resolve(c.pen, c.nx, c.ny, c.px, c.py, qx, qy, qdx, qdy, 0.0f, wm_r, 0.0f,
                                     st[0], st[1], 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, h,
                                     (sp[P_ROBOT_FRIC] + st[6]) / 2.0f, 1.0f);
          if ((act >> tm.lane) & 1u) {
            FSX[r] -= o.fx;
            FSY[r] -= o.fy;
          }
#pragma unroll
          for (int l = 0; l < kTeam; ++l) {
            if ((act >> l) & 1u) {
              ax[l % 4] += tm.from(o.dax, l);
              ay[l % 4] += tm.from(o.day, l);
              avx[l % 4] += tm.from(o.dvax, l);
              avy[l % 4] += tm.from(o.dvay, l);
              afx[l % 4] += tm.from(o.fx, l);
              afy[l % 4] += tm.from(o.fy, l);
            }
          }
        }
        qx += ((ax[0] + ax[1]) + ax[2]) + ax[3];
        qy += ((ay[0] + ay[1]) + ay[2]) + ay[3];
        qdx += ((avx[0] + avx[1]) + avx[2]) + avx[3];
        qdy += ((avy[0] + avy[1]) + avy[2]) + avy[3];
        FRX += ((afx[0] + afx[1]) + afx[2]) + afx[3];
        FRY += ((afy[0] + afy[1]) + afy[2]) + afy[3];
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

  // ---- the state and each actor's contact force over n_norm -------------
  if (tm.lane == 0) {
    float* q = ops.out[O_Q] + b * n_q;
    float* qd = ops.out[O_QD] + b * n_q;
    q[0] = qx;
    q[1] = qy;
    qd[0] = qdx;
    qd[1] = qdy;
    if (n_q == 3) {
      q[2] = qyaw;
      qd[2] = qdyaw;
    }
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) {
      if (d < D) {
        ops.out[O_DYN_POS][(b * D + d) * 2] = X[d];
        ops.out[O_DYN_POS][(b * D + d) * 2 + 1] = Y[d];
        ops.out[O_DYN_YAW][b * D + d] = YAW[d];
        ops.out[O_DYN_VEL][(b * D + d) * 2] = VX[d];
        ops.out[O_DYN_VEL][(b * D + d) * 2 + 1] = VY[d];
        ops.out[O_DYN_OM][b * D + d] = OM[d];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int s = r * kTeam + tm.lane;
    if (s < S) {
      stat_force[s][0] = FSX[r];
      stat_force[s][1] = FSY[r];
    }
  }
  __syncwarp(tm.mask);
  // a tensor over a python scalar is, in PyTorch, the tensor times the
  // scalar's float32 reciprocal
  const float inv_norm = 1.0f / static_cast<float>(substeps * pos_iters);
  float* force = ops.out[O_CONTACT_FORCE] + b * A * 3;
  for (int a = tm.lane; a < A; a += kTeam) {
    const int row = static_cast<int>(rows[a]);
    float fx = 0.0f, fy = 0.0f;
    if (row == kRowRobot) {
      fx = FRX;
      fy = FRY;
    } else if (row >= kRowDyn && row < kRowStat) {
      fx = pick(FDX, row - kRowDyn);
      fy = pick(FDY, row - kRowDyn);
    } else if (row >= kRowStat) {
      fx = stat_force[row - kRowStat][0];
      fy = stat_force[row - kRowStat][1];
    }
    force[3 * a] = fx * inv_norm;
    force[3 * a + 1] = fy * inv_norm;
    force[3 * a + 2] = 0.0f * inv_norm;
  }
}

}  // namespace

extern "C" int m3p2i_point_step(const float* params, const void* const* inputs, const long long* strides,
                                void* const* outputs, int B, int D, int S, int A, int substeps,
                                int pos_iters, int robot_type, int n_q, int n_u, int n_params,
                                void* stream) {
  const int rows = n_params - (N_SCALARS + kDynStride * D + kStatStride * S);
  if (B <= 0 || D < 1 || D > kMaxD || S < 1 || S > kMaxS || A < 1 + D + S || rows != A ||
      substeps < 1 || pos_iters < 1 || robot_type < 0 || robot_type > 2 ||
      n_q != (robot_type == 0 ? 2 : 3) || n_u != (robot_type == 1 ? 3 : 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Operands ops;
  for (int i = 0; i < N_INPUTS; ++i) {
    ops.in[i] = static_cast<const float*>(inputs[i]);
    ops.stride[i] = strides[i];
  }
  for (int i = 0; i < N_OUTPUTS; ++i) ops.out[i] = static_cast<float*>(outputs[i]);
  const size_t smem = static_cast<size_t>(n_params) * sizeof(float);
  point_env_step_kernel<<<B, kTeam, smem, static_cast<cudaStream_t>(stream)>>>(
      params, ops, D, S, A, substeps, pos_iters, robot_type, n_q, n_u, n_params);
  return static_cast<int>(cudaGetLastError());
}
