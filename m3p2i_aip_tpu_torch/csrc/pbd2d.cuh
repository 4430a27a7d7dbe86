// Planar PBD contact primitives shared by the point-family kernels (the
// rollout, the real-env step) and the albert rollout: a circle against an
// oriented box, a box's four corners against an oriented box, one Jacobi
// projection of a single contact, and the sum of a box pair's four corners.
// Device counterparts of m3p2i_aip_tpu_torch/sim/pbd2d.py (circle_vs_obb,
// corners_vs_obb, resolve_contact), with the plain versions' operation order.
//
// The divisions whose quotient no output reads are skipped behind a branch:
// the ratio test that picks the pushout axis runs only for a centre inside
// the box, and the projection's three divisions only for a live contact
// (pen > 0; a dead one's lam, jn and jt are +0 either way), so every value
// is the one the plain version's branch-free expressions give.  Against the
// branch-free form, same bits, on an NVIDIA H100 80GB HBM3 at 700 W: the
// point kernel 2-3% faster on its check inputs and 8% on its slowest
// closed-loop input, its batched call 4% faster on random actions and 2%
// slower on its slowest closed-loop input (a warp whose lanes test
// different contacts runs both sides); the albert kernel 13-15% faster.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

struct Contact {
  float pen, nx, ny, px, py;
};

// Corrections of one contact projection (pbd2d.resolve_contact).
struct Resolved {
  float dax, day, dyaw_a, dvax, dvay, dom_a;
  float dbx, dby, dyaw_b, dvbx, dvby, dom_b;
  float fx, fy;  // equivalent force on A
};

__device__ __forceinline__ float sgn_pos(float v) { return v >= 0.0f ? 1.0f : -1.0f; }

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// Circle (center cx, cy; radius r) vs oriented box; normal pushes the circle.
__device__ Contact circle_vs_obb(float cx, float cy, float r, float bx, float by,
                                 float bc, float bs, float hx, float hy) {
  const float dx = cx - bx, dy = cy - by;
  const float lx = bc * dx + bs * dy;
  const float ly = -bs * dx + bc * dy;
  const float clx = clampf(lx, -hx, hx);
  const float cly = clampf(ly, -hy, hy);
  const bool inside = fabsf(lx) < hx && fabsf(ly) < hy;
  bool use_x = false;  // read only where inside
  if (inside) use_x = fabsf(lx) / hx >= fabsf(ly) / hy;
  const float sgx = sgn_pos(lx), sgy = sgn_pos(ly);
  const float sx = inside ? (use_x ? sgx * hx : lx) : clx;
  const float sy = inside ? (use_x ? ly : sgy * hy) : cly;
  const float ddx = lx - sx, ddy = ly - sy;
  const float dist = sqrtf(ddx * ddx + ddy * ddy);
  const float guard = fmaxf(dist, 1e-9f);
  const float nlx = inside ? (use_x ? sgx : 0.0f) : ddx / guard;
  const float nly = inside ? (use_x ? 0.0f : sgy) : ddy / guard;
  Contact c;
  c.pen = inside ? r + dist : r - dist;
  c.nx = bc * nlx - bs * nly;
  c.ny = bs * nlx + bc * nly;
  c.px = bx + (bc * sx - bs * sy);
  c.py = by + (bs * sx + bc * sy);
  return c;
}

// One Jacobi projection of a single contact (masked when pen <= 0).
__device__ Resolved resolve(float pen, float nx, float ny, float px, float py,
                            float ax, float ay, float avx, float avy, float aom,
                            float wm_a, float wi_a, float bx, float by, float bvx,
                            float bvy, float bom, float wm_b, float wi_b, float h,
                            float friction, float relax) {
  const bool active = pen > 0.0f;
  const float d = active ? pen : 0.0f;
  const float rax = px - ax, ray = py - ay;
  const float rbx = px - bx, rby = py - by;
  const float ca = rax * ny - ray * nx;
  const float cb = rbx * ny - rby * nx;
  const float w_sum = wm_a + wi_a * (ca * ca) + wm_b + wi_b * (cb * cb);
  const float w_guard = fmaxf(w_sum, 1e-9f);
  float lam = 0.0f;
  if (active) lam = relax * d / w_guard;

  Resolved o;
  o.dax = (wm_a * lam) * nx;
  o.day = (wm_a * lam) * ny;
  o.dyaw_a = wi_a * lam * ca;
  o.dbx = -(wm_b * lam) * nx;
  o.dby = -(wm_b * lam) * ny;
  o.dyaw_b = -wi_b * lam * cb;

  // velocity solve: restitution 0 on the normal, Coulomb friction tangential
  const float vrx = (avx - aom * ray) - (bvx - bom * rby);
  const float vry = (avy + aom * rax) - (bvy + bom * rbx);
  const float vn = vrx * nx + vry * ny;
  float jn = 0.0f;
  if (active) jn = (active && vn < 0.0f) ? -vn / w_guard : 0.0f;
  const float tx = -ny, ty = nx;
  const float ta = rax * ty - ray * tx;
  const float tb = rbx * ty - rby * tx;
  const float wt_sum = wm_a + wi_a * (ta * ta) + wm_b + wi_b * (tb * tb);
  const float vt = vrx * tx + vry * ty;
  // the plain version divides by the python scalar h, which PyTorch's CUDA
  // division turns into a product with its float32 reciprocal
  const float inv_h = 1.0f / h;
  float jt = 0.0f;
  if (active) {
    const float jt_un = -vt / fmaxf(wt_sum, 1e-9f);
    const float jt_max = friction * (jn + lam * inv_h);
    jt = active ? clampf(jt_un, -jt_max, jt_max) : 0.0f;
  }

  o.dvax = (wm_a * jn) * nx + (wm_a * jt) * tx;
  o.dvay = (wm_a * jn) * ny + (wm_a * jt) * ty;
  o.dom_a = wi_a * jn * ca + wi_a * jt * ta;
  o.dvbx = -(wm_b * jn) * nx - (wm_b * jt) * tx;
  o.dvby = -(wm_b * jn) * ny - (wm_b * jt) * ty;
  o.dom_b = -wi_b * jn * cb - wi_b * jt * tb;
  const float f = (jn + lam * inv_h) * inv_h;
  o.fx = f * nx;
  o.fy = f * ny;
  return o;
}

// The four corners of box A against box B's dominant face (chosen from A's
// center): penetrations, world corner points, one world normal.
struct CornerContacts {
  float pen[4], wx[4], wy[4];
  float nx, ny;
};

__device__ CornerContacts corners_vs_obb(float ax, float ay, float ac, float as,
                                         float hxa, float hya, float bx, float by,
                                         float bc, float bs, float hxb, float hyb) {
  const float dx = ax - bx, dy = ay - by;
  const float clx = bc * dx + bs * dy;
  const float cly = -bs * dx + bc * dy;
  const bool use_x = fabsf(clx) / hxb >= fabsf(cly) / hyb;
  const float sgn = use_x ? sgn_pos(clx) : sgn_pos(cly);
  const float half_axis = use_x ? hxb : hyb;
  const float nlx = use_x ? sgn : 0.0f;
  const float nly = use_x ? 0.0f : sgn;
  CornerContacts cc;
  cc.nx = bc * nlx - bs * nly;
  cc.ny = bs * nlx + bc * nly;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lxa = (i < 2 ? 1.0f : -1.0f) * hxa;
    const float lya = (i % 2 == 0 ? 1.0f : -1.0f) * hya;
    const float wx = ax + (ac * lxa - as * lya);
    const float wy = ay + (as * lxa + ac * lya);
    const float ex = wx - bx, ey = wy - by;
    const float lx = bc * ex + bs * ey;
    const float ly = -bs * ex + bc * ey;
    const float local_a = use_x ? lx : ly;
    const float sep_other = use_x ? hyb - fabsf(ly) : hxb - fabsf(lx);
    const float pen_val = half_axis - sgn * local_a;
    cc.pen[i] = (pen_val > 0.0f && sep_other > 0.0f) ? pen_val : -1.0f;
    cc.wx[i] = wx;
    cc.wy[i] = wy;
  }
  return cc;
}

// The four corners' corrections of one box pair summed as the plain
// version's sums over the corners add them: the [.., 4, 2] position,
// velocity and force rows in corner order, the contiguous [.., 4] yaw and
// spin rows as (c0 + c2) + (c1 + c3)
__device__ __forceinline__ Resolved corner_sum(const Resolved (&o)[4]) {
  Resolved r;
  r.dax = ((o[0].dax + o[1].dax) + o[2].dax) + o[3].dax;
  r.day = ((o[0].day + o[1].day) + o[2].day) + o[3].day;
  r.dvax = ((o[0].dvax + o[1].dvax) + o[2].dvax) + o[3].dvax;
  r.dvay = ((o[0].dvay + o[1].dvay) + o[2].dvay) + o[3].dvay;
  r.dbx = ((o[0].dbx + o[1].dbx) + o[2].dbx) + o[3].dbx;
  r.dby = ((o[0].dby + o[1].dby) + o[2].dby) + o[3].dby;
  r.dvbx = ((o[0].dvbx + o[1].dvbx) + o[2].dvbx) + o[3].dvbx;
  r.dvby = ((o[0].dvby + o[1].dvby) + o[2].dvby) + o[3].dvby;
  r.fx = ((o[0].fx + o[1].fx) + o[2].fx) + o[3].fx;
  r.fy = ((o[0].fy + o[1].fy) + o[2].fy) + o[3].fy;
  r.dyaw_a = (o[0].dyaw_a + o[2].dyaw_a) + (o[1].dyaw_a + o[3].dyaw_a);
  r.dom_a = (o[0].dom_a + o[2].dom_a) + (o[1].dom_a + o[3].dom_a);
  r.dyaw_b = (o[0].dyaw_b + o[2].dyaw_b) + (o[1].dyaw_b + o[3].dyaw_b);
  r.dom_b = (o[0].dom_b + o[2].dom_b) + (o[1].dom_b + o[3].dom_b);
  return r;
}

}  // namespace
