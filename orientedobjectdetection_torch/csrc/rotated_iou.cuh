// Per-pair rotated-box intersection shared by the port's CUDA kernels
// (nms_pair_mask.cu, box_iou_rotated.cu).
//
// The arithmetic is the plain version's, orientedobjectdetection_torch/
// ops/iou.py (itself the JAX package's ops/iou.py:_intersect_area_rel):
// corners relative to each box centre, a per-pair midpoint frame, a
// Liang-Barsky clip of each of the 8 edges against the other box's 4
// half-planes, summed by Green's theorem. The caller shrinks the second
// operand by a relative 1e-6 before it takes the corners (the plain
// version's tie-break for coincident edges) and applies the physical bound
// min(inter, min(area1, area2)) and the exact IEEE division itself.

#pragma once

#include <cuda_runtime.h>

namespace rotated_iou {

// Relative shrink of the second operand's sides.
constexpr float kShrink = 1.0f - 1e-6f;

// Counter-clockwise corners of a box centred on the origin, in the order of
// ops/boxes.py:obb2poly (TL, TR, BR, BL in the box frame).
__device__ __forceinline__ void rel_corners(float w, float h, float a,
                                            float* cx, float* cy) {
  float s, c;
  sincosf(a, &s, &c);
  const float wx = w / 2.0f * c, wy = w / 2.0f * s;
  const float hx = -h / 2.0f * s, hy = h / 2.0f * c;
  cx[0] = -wx - hx; cy[0] = -wy - hy;
  cx[1] = wx - hx;  cy[1] = wy - hy;
  cx[2] = wx + hx;  cy[2] = wy + hy;
  cx[3] = -wx + hx; cy[3] = -wy + hy;
}

// Sum of cross(p(t0), p(t1)) over the parts of A's 4 edges inside B.
__device__ __forceinline__ float edge_contributions(const float* ax,
                                                    const float* ay,
                                                    const float* bx,
                                                    const float* by) {
  float ebx[4], eby[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ebx[k] = bx[(k + 1) & 3] - bx[k];
    eby[k] = by[(k + 1) & 3] - by[k];
  }
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float px = ax[i], py = ay[i];
    const float dx = ax[(i + 1) & 3] - px, dy = ay[(i + 1) & 3] - py;
    float lo = -1e9f, hi = 1e9f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // inside B's half-plane k: cross(eb_k, p - vb_k) >= 0
      const float num = ebx[k] * (py - by[k]) - eby[k] * (px - bx[k]);
      const float den = ebx[k] * dy - eby[k] * dx;
      const float t = -num / (fabsf(den) > 1e-12f ? den : 1e-12f);
      float lower = den > 1e-12f ? t : -1e9f;
      const float upper = den < -1e-12f ? t : 1e9f;
      if (fabsf(den) <= 1e-12f && num < 0.0f) lower = 1e9f;
      lo = fmaxf(lo, lower);
      hi = fminf(hi, upper);
    }
    const float t0 = fmaxf(lo, 0.0f), t1 = fminf(hi, 1.0f);
    if (t1 > t0) {
      const float x0 = px + t0 * dx, y0 = py + t0 * dy;
      const float x1 = px + t1 * dx, y1 = py + t1 * dy;
      total += x0 * y1 - y0 * x1;
    }
  }
  return total;
}

// Intersection area (>= 0, before the physical bound) of a first box with
// centre (x1, y1) and centre-relative corners (c1x, c1y) and a second box
// (x2, y2), (c2x, c2y), evaluated in the frame of the pair's midpoint.
__device__ __forceinline__ float intersection_area(
    const float* c1x, const float* c1y, float x1, float y1,
    const float* c2x, const float* c2y, float x2, float y2) {
  const float ux = 0.5f * (x1 - x2);
  const float uy = 0.5f * (y1 - y2);
  float p1x[4], p1y[4], p2x[4], p2y[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    p1x[k] = c1x[k] + ux;
    p1y[k] = c1y[k] + uy;
    p2x[k] = c2x[k] - ux;
    p2y[k] = c2y[k] - uy;
  }
  const float area2 = edge_contributions(p1x, p1y, p2x, p2y) +
                      edge_contributions(p2x, p2y, p1x, p1y);
  return fmaxf(0.5f * area2, 0.0f);
}

}  // namespace rotated_iou
