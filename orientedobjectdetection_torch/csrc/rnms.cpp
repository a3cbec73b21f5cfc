// Host-side rotated-box geometry core (C++17, no dependencies): the port's
// copy of orientedobjectdetection_tpu/native/rnms.cpp.
//
// The reference inherits its host rotated NMS and IoU from mmcv's native
// kernels (csrc box_iou_rotated / nms_rotated, used via
// `core/post_processing/bbox_nms_rotated.py:3` and `datasets/dota.py:16`
// for the huge-image merge). On the card the port's NMS is the pair-mask
// kernel (nms_pair_mask.cu) and a scan; this file serves the HOST call
// sites (`ops/nms.py:nms_rotated_np(device='cpu')`), where boxes arrive as
// ragged numpy arrays: greedy NMS skips suppressed rows, and nothing
// materializes the N^2 pair matrix.
//
// Geometry: corners from the obb2poly convention, convex clip
// (Sutherland-Hodgman), intersection capped by min(area1, area2), IoU
// denominator area1 + area2 - inter (+eps). Suppression is `iou > thr`
// with a stable descending-score order (ties -> lower index first), as
// ops/nms.py:nms_rotated.
//
// A plain C ABI, loaded with ctypes (native.py builds it with g++).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

// (cx, cy, w, h, a) -> 4 corners, ops/boxes.py:obb2poly order (TL TR BR BL
// in the box frame, CCW in image coords for the y-down raster convention
// shared by every consumer).
inline void corners(const float* b, Pt out[4]) {
  const double cx = b[0], cy = b[1], w2 = b[2] * 0.5, h2 = b[3] * 0.5;
  const double c = std::cos((double)b[4]), s = std::sin((double)b[4]);
  const double wx = w2 * c, wy = w2 * s, hx = -h2 * s, hy = h2 * c;
  out[0] = {cx - wx - hx, cy - wy - hy};
  out[1] = {cx + wx - hx, cy + wy - hy};
  out[2] = {cx + wx + hx, cy + wy + hy};
  out[3] = {cx - wx + hx, cy - wy + hy};
}

inline double cross(const Pt& o, const Pt& a, const Pt& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

inline double shoelace(const Pt* p, int n) {
  double a = 0;
  for (int i = 0; i < n; ++i) {
    const Pt& u = p[i];
    const Pt& v = p[(i + 1) % n];
    a += u.x * v.y - u.y * v.x;
  }
  return std::abs(a) * 0.5;
}

// Sutherland–Hodgman: clip `subj` (n verts) by the half-plane on the
// inner side of edge (e0, e1) of a CCW polygon. Writes into `out`,
// returns vertex count. Max vertex count for rect∩rect is 8.
inline int clip_edge(const Pt* subj, int n, Pt e0, Pt e1, Pt* out) {
  int m = 0;
  for (int i = 0; i < n; ++i) {
    const Pt& cur = subj[i];
    const Pt& nxt = subj[(i + 1) % n];
    const double dc = cross(e0, e1, cur);
    const double dn = cross(e0, e1, nxt);
    if (dc >= 0) {
      out[m++] = cur;
      if (dn < 0) {
        const double t = dc / (dc - dn);
        out[m++] = {cur.x + t * (nxt.x - cur.x), cur.y + t * (nxt.y - cur.y)};
      }
    } else if (dn >= 0) {
      const double t = dc / (dc - dn);
      out[m++] = {cur.x + t * (nxt.x - cur.x), cur.y + t * (nxt.y - cur.y)};
    }
  }
  return m;
}

// Intersection area of two rotated rects given their corner rings.
// The rings from `corners` wind consistently, so the clip keeps the
// inner side; orientation is normalized by taking |shoelace| at the end.
inline double inter_area(const Pt a[4], const Pt b[4]) {
  // ensure CCW winding for the clip polygon b (cheap signed-area test)
  Pt bb[4];
  double sa = 0;
  for (int i = 0; i < 4; ++i) {
    const Pt& u = b[i];
    const Pt& v = b[(i + 1) % 4];
    sa += u.x * v.y - u.y * v.x;
  }
  if (sa < 0) {
    bb[0] = b[3]; bb[1] = b[2]; bb[2] = b[1]; bb[3] = b[0];
  } else {
    bb[0] = b[0]; bb[1] = b[1]; bb[2] = b[2]; bb[3] = b[3];
  }
  Pt poly[16], tmp[16];
  Pt subj[4];
  sa = 0;
  for (int i = 0; i < 4; ++i) {
    const Pt& u = a[i];
    const Pt& v = a[(i + 1) % 4];
    sa += u.x * v.y - u.y * v.x;
  }
  if (sa < 0) {
    subj[0] = a[3]; subj[1] = a[2]; subj[2] = a[1]; subj[3] = a[0];
  } else {
    subj[0] = a[0]; subj[1] = a[1]; subj[2] = a[2]; subj[3] = a[3];
  }
  int n = 4;
  Pt* src = subj;
  Pt* cur = poly;
  Pt* nxt = tmp;
  for (int e = 0; e < 4 && n > 0; ++e) {
    n = clip_edge(src, n, bb[e], bb[(e + 1) % 4], cur);
    src = cur;
    std::swap(cur, nxt);
  }
  return n > 0 ? shoelace(src, n) : 0.0;
}

// Circumscribed-circle rejection: two rects cannot intersect when their
// center distance exceeds the sum of their half-diagonals. One fused
// multiply-add per pair vs ~100 ns for the full clip — the dominant case
// in sparse sets (DOTA patch merge).
inline double half_diag(const float* b) {
  return 0.5 * std::sqrt((double)b[2] * b[2] + (double)b[3] * b[3]);
}

inline bool maybe_overlap(const float* b1, const float* b2, double r1,
                          double r2) {
  const double dx = (double)b1[0] - b2[0], dy = (double)b1[1] - b2[1];
  const double r = r1 + r2;
  return dx * dx + dy * dy <= r * r;
}

}  // namespace

extern "C" {

// Pairwise rotated IoU/IoF matrix: b1 (n,5), b2 (m,5) row-major f32 ->
// out (n*m) f32. mode_iof != 0 normalizes by the first set's area.
void oodt_rbox_iou(const float* b1, int64_t n, const float* b2, int64_t m,
                   int mode_iof, float* out) {
  std::vector<Pt> c2(m * 4);
  std::vector<double> a2(m), r2(m);
  for (int64_t j = 0; j < m; ++j) {
    corners(b2 + j * 5, &c2[j * 4]);
    a2[j] = (double)b2[j * 5 + 2] * (double)b2[j * 5 + 3];
    r2[j] = half_diag(b2 + j * 5);
  }
  for (int64_t i = 0; i < n; ++i) {
    Pt c1[4];
    corners(b1 + i * 5, c1);
    const double a1 = (double)b1[i * 5 + 2] * (double)b1[i * 5 + 3];
    const double r1 = half_diag(b1 + i * 5);
    for (int64_t j = 0; j < m; ++j) {
      if (!maybe_overlap(b1 + i * 5, b2 + j * 5, r1, r2[j])) {
        out[i * m + j] = 0.0f;
        continue;
      }
      double inter = inter_area(c1, &c2[j * 4]);
      inter = std::min(inter, std::min(a1, a2[j]));
      const double denom = mode_iof ? a1 : (a1 + a2[j] - inter);
      out[i * m + j] = (float)(inter / (denom + 1e-6));
    }
  }
}

// Greedy rotated NMS. boxes (n,5) f32, scores (n) f32. Writes surviving
// indices (descending score) into keep_out (capacity n); returns count.
//
// Near-linear in practice: boxes are binned on a uniform grid (cell edge =
// the largest box diagonal), and each kept box only visits the cells its
// circumscribed circle can reach — on a DOTA-scale merge (100k boxes over
// an 8k x 8k frame) this replaces the O(kept * alive) scan with a few
// dozen candidates per kept box.
int64_t oodt_rnms_rotated(const float* boxes, const float* scores, int64_t n,
                          float iou_thr, int64_t* keep_out) {
  if (n <= 0) return 0;
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return scores[a] > scores[b];
  });
  std::vector<Pt> cs(n * 4);
  std::vector<double> areas(n), radii(n);
  std::vector<int64_t> rank(n);  // order position, for "later in order"
  double xmin = 1e300, ymin = 1e300, xmax = -1e300, ymax = -1e300;
  double rmax = 1e-6;
  for (int64_t i = 0; i < n; ++i) {
    corners(boxes + i * 5, &cs[i * 4]);
    areas[i] = (double)boxes[i * 5 + 2] * (double)boxes[i * 5 + 3];
    radii[i] = half_diag(boxes + i * 5);
    rmax = std::max(rmax, radii[i]);
    xmin = std::min(xmin, (double)boxes[i * 5]);
    xmax = std::max(xmax, (double)boxes[i * 5]);
    ymin = std::min(ymin, (double)boxes[i * 5 + 1]);
    ymax = std::max(ymax, (double)boxes[i * 5 + 1]);
    rank[order[i]] = i;
  }
  // uniform grid over the center bounding box, cell edge 2*rmax (so a
  // kept box's reach spans <= (2 + ceil(r_i/rmax)) cells per axis)
  const double cell = 2.0 * rmax;
  const int64_t gw =
      std::max<int64_t>(1, (int64_t)((xmax - xmin) / cell) + 1);
  const int64_t gh =
      std::max<int64_t>(1, (int64_t)((ymax - ymin) / cell) + 1);
  auto cell_of = [&](const float* b) -> int64_t {
    int64_t cx = (int64_t)(((double)b[0] - xmin) / cell);
    int64_t cy = (int64_t)(((double)b[1] - ymin) / cell);
    cx = std::min(std::max<int64_t>(cx, 0), gw - 1);
    cy = std::min(std::max<int64_t>(cy, 0), gh - 1);
    return cy * gw + cx;
  };
  // counting-sort boxes into cells
  std::vector<int64_t> cell_start(gw * gh + 1, 0), cell_items(n);
  for (int64_t i = 0; i < n; ++i) ++cell_start[cell_of(boxes + i * 5) + 1];
  for (int64_t c = 0; c < gw * gh; ++c) cell_start[c + 1] += cell_start[c];
  {
    std::vector<int64_t> cursor(cell_start.begin(), cell_start.end() - 1);
    for (int64_t i = 0; i < n; ++i)
      cell_items[cursor[cell_of(boxes + i * 5)]++] = i;
  }
  std::vector<char> dead(n, 0);
  int64_t k = 0;
  for (int64_t oi = 0; oi < n; ++oi) {
    const int64_t i = order[oi];
    if (dead[i]) continue;
    keep_out[k++] = i;
    const double reach = radii[i] + rmax;
    const double bx = boxes[i * 5], by = boxes[i * 5 + 1];
    int64_t cx0 = (int64_t)((bx - reach - xmin) / cell);
    int64_t cx1 = (int64_t)((bx + reach - xmin) / cell);
    int64_t cy0 = (int64_t)((by - reach - ymin) / cell);
    int64_t cy1 = (int64_t)((by + reach - ymin) / cell);
    cx0 = std::min(std::max<int64_t>(cx0, 0), gw - 1);
    cx1 = std::min(std::max<int64_t>(cx1, 0), gw - 1);
    cy0 = std::min(std::max<int64_t>(cy0, 0), gh - 1);
    cy1 = std::min(std::max<int64_t>(cy1, 0), gh - 1);
    for (int64_t cy = cy0; cy <= cy1; ++cy) {
      for (int64_t cx = cx0; cx <= cx1; ++cx) {
        const int64_t c = cy * gw + cx;
        for (int64_t s = cell_start[c]; s < cell_start[c + 1]; ++s) {
          const int64_t j = cell_items[s];
          if (dead[j] || rank[j] <= oi) continue;
          if (!maybe_overlap(boxes + i * 5, boxes + j * 5, radii[i],
                             radii[j]))
            continue;
          double inter = inter_area(&cs[i * 4], &cs[j * 4]);
          inter = std::min(inter, std::min(areas[i], areas[j]));
          const double iou =
              inter / (areas[i] + areas[j] - inter + 1e-6);
          if (iou > iou_thr) dead[j] = 1;
        }
      }
    }
  }
  return k;
}

// Greedy axis-aligned NMS over (x1, y1, x2, y2) boxes — the HBB
// specialization (reference `mmcv.ops.nms` use sites, SURVEY §2.9).
int64_t oodt_nms_hbb(const float* boxes, const float* scores, int64_t n,
                     float iou_thr, int64_t* keep_out) {
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return scores[a] > scores[b];
  });
  std::vector<double> areas(n);
  for (int64_t i = 0; i < n; ++i) {
    const float* b = boxes + i * 4;
    areas[i] = std::max(0.0, (double)b[2] - b[0]) *
               std::max(0.0, (double)b[3] - b[1]);
  }
  std::vector<char> dead(n, 0);
  int64_t k = 0;
  for (int64_t oi = 0; oi < n; ++oi) {
    const int64_t i = order[oi];
    if (dead[i]) continue;
    keep_out[k++] = i;
    const float* bi = boxes + i * 4;
    for (int64_t oj = oi + 1; oj < n; ++oj) {
      const int64_t j = order[oj];
      if (dead[j]) continue;
      const float* bj = boxes + j * 4;
      const double ix = std::min(bi[2], bj[2]) - std::max(bi[0], bj[0]);
      const double iy = std::min(bi[3], bj[3]) - std::max(bi[1], bj[1]);
      const double inter = std::max(ix, 0.0) * std::max(iy, 0.0);
      const double iou = inter / (areas[i] + areas[j] - inter + 1e-6);
      if (iou > iou_thr) dead[j] = 1;
    }
  }
  return k;
}

}  // extern "C"
