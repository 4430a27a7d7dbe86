// Panda forward-kinematics tables and chain helpers shared by the rollout
// kernels (m3p2i_aip_tpu_torch/models/panda_fk.py): the joint offsets and
// roll twists, the hand and finger offsets, the joint limits, and the
// compile-time-folded products with them (cdot: exact zeros dropped, +-1
// turned into a sign, the TPU kernels' trace-time _term / _fold_sum).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

// m3p2i_aip_tpu/models/panda_fk.py tables as float32 (roll cos(+-pi/2) of a
// float32 angle is -4.371139e-08, not 0, exactly as numpy forms it); device
// constants, folded into the unrolled code where they are indexed by constants
constexpr float kC = -4.371138828673793e-08f;
__device__ constexpr float kJointXYZ[7][3] = {
    {0.0f, 0.0f, 0.333f}, {0.0f, 0.0f, 0.0f}, {0.0f, -0.316f, 0.0f}, {0.0825f, 0.0f, 0.0f},
    {-0.0825f, 0.384f, 0.0f}, {0.0f, 0.0f, 0.0f}, {0.088f, 0.0f, 0.0f}};
// roll about x of each joint frame: 0 none, -1 = -pi/2, +1 = +pi/2
__device__ constexpr int kRollSign[7] = {0, -1, 1, 1, -1, 1, 1};
__device__ constexpr float kRollNeg[3][3] = {{1.0f, 0.0f, 0.0f}, {0.0f, kC, 1.0f}, {0.0f, -1.0f, kC}};
__device__ constexpr float kRollPos[3][3] = {{1.0f, 0.0f, 0.0f}, {0.0f, kC, -1.0f}, {0.0f, 1.0f, kC}};
__device__ constexpr float kHandMat[3][3] = {
    {0.7071067690849304f, 0.7071067690849304f, 0.0f},
    {-0.7071067690849304f, 0.7071067690849304f, 0.0f},
    {0.0f, 0.0f, 1.0f}};
__device__ constexpr float kHandXYZ[3] = {0.0f, 0.0f, 0.107f};
__device__ constexpr float kFingerXYZ[3] = {0.0f, 0.0f, 0.0584f};
__device__ constexpr float kJointLo[9] = {-2.8973f, -1.7628f, -2.8973f, -3.0718f, -2.8973f, -0.0175f, -2.8973f, 0.0f, 0.0f};
__device__ constexpr float kJointHi[9] = {2.8973f, 1.7628f, 2.8973f, -0.0698f, 2.8973f, 3.7525f, 2.8973f, 0.04f, 0.04f};

// a * c for a compile-time constant c: +-1 become a sign
__device__ __forceinline__ float tmul(float a, float c) {
  return c == 1.0f ? a : (c == -1.0f ? -a : a * c);
}

// a0 c0 + a1 c1 + a2 c2 over the NONZERO compile-time constants c, in order
__device__ __forceinline__ float cdot(float a0, float a1, float a2, float c0, float c1, float c2) {
  float acc = 0.0f;
  bool any = false;
  if (c0 != 0.0f) { acc = tmul(a0, c0); any = true; }
  if (c1 != 0.0f) { acc = any ? acc + tmul(a1, c1) : tmul(a1, c1); any = true; }
  if (c2 != 0.0f) { acc = any ? acc + tmul(a2, c2) : tmul(a2, c2); }
  return acc;
}

// pos += R @ off for a constant offset
__device__ __forceinline__ void add_rot_const(float pos[3], const float R[3][3], float o0, float o1, float o2) {
  if (o0 == 0.0f && o1 == 0.0f && o2 == 0.0f) return;
#pragma unroll
  for (int i = 0; i < 3; ++i) pos[i] = pos[i] + cdot(R[i][0], R[i][1], R[i][2], o0, o1, o2);
}

// R = R @ M for a constant matrix M
__device__ __forceinline__ void mul_const(float R[3][3], const float (&M)[3][3]) {
  float out[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) out[i][j] = cdot(R[i][0], R[i][1], R[i][2], M[0][j], M[1][j], M[2][j]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = out[i][j];
}

// joint J with c = cos(q_J), s = sin(q_J)
template <int J>
__device__ __forceinline__ void fk_joint(float pos[3], float R[3][3], float c, float s) {
  constexpr float o0 = kJointXYZ[J][0], o1 = kJointXYZ[J][1], o2 = kJointXYZ[J][2];
  add_rot_const(pos, R, o0, o1, o2);
  if (kRollSign[J] < 0) mul_const(R, kRollNeg);
  if (kRollSign[J] > 0) mul_const(R, kRollPos);
  // R @ Rz(q) with Rz = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float r0 = R[i][0], r1 = R[i][1];
    R[i][0] = r0 * c + r1 * s;
    R[i][1] = r0 * (-s) + r1 * c;
  }
}

template <int J>
__device__ __forceinline__ void fk_joint(float pos[3], float R[3][3], float qj) {
  fk_joint<J>(pos, R, cosf(qj), sinf(qj));
}

}  // namespace
