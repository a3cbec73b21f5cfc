// Rotated IoU / IoF matrix for label assignment, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel orientedobjectdetection_tpu/ops/iou_pallas.py:
// box_iou_rotated_pallas (kernel body _iou_tile_kernel, tile skip
// _live_tiles). For a small "row" set (batch, G, 5), the ground-truth or
// ignore boxes of each image, and a large "column" set (N, 5), the anchors,
// usually shared by the batch, it writes the (batch, G, N) float32 matrix
//
//     out[b, g, j] = inter / max(denom, 1e-6)
//     denom = area_first + area_second - inter   (iou)
//           = area_first                         (iof)
//
// in ONE launch for the whole batch: grid (N/256, G/32, batch). Which of the
// two sets is the FIRST operand is a template flag, because the operands are
// not symmetric: the second one is shrunk by a relative 1e-6 and the IoF
// denominator is the first one's area. The assigner's IoU has the rows (gt)
// first; its IoF has the columns (anchors) first, and the wrapper returns
// that matrix as a transposed view.
//
// Per-pair arithmetic (rotated_iou.cuh, shared with nms_pair_mask.cu) is the
// plain version's, orientedobjectdetection_torch/ops/iou.py: pair-midpoint
// frame, 1e-6 shrink, physical bound min(inter, min(area1, area2)), exact
// IEEE division. It does NOT take the TPU kernel's joint-mean frame and 1e-4
// shrink, which exist for that kernel's global frame and bias the IoU by
// ~2e-4: the assigner compares this matrix with thresholds and with its own
// row maxima, so it should carry the plain version's values.
//
// What bounds it on an H100: at the assignment shape (batch 8, G = 32 rows,
// N = 196,416 anchors of a 1024^2 image) the output is 201 MB of float32,
// ~60 us at 3.35 TB/s, and every pair that reaches the clip math costs ~600
// fp32 operations (the TPU kernel's cost model), so all 50 M pairs would
// take ~450 us at 67 TFLOP/s. Anchors arrive level by level in grid order
// and a gt box reaches only the anchors around it, so few pairs are live and
// the output bytes are the bound.
//
// What the design does about it: the TPU kernel's reachability test (two
// boxes whose bounding rects, inflated to r = (w + h) / 2 >= the
// circumradius, do not meet have IoU 0) moves from a host-built tile bitmap
// into the kernel, per pair: four compares before the clip math. A warp is
// 32 consecutive anchors, three or four grid locations, so the branch skips
// whole warps wherever a gt is out of reach, and a skipped pair still writes
// its 0: no separate memset. One thread owns one anchor column (corners and
// sincosf once, in registers) and walks the block's 32 rows, staged in
// shared memory with their corners computed once per box; a warp stores 128
// consecutive bytes per row. Padded rows (zero boxes) have r = 0 and area 0:
// out of reach of almost every anchor, and exactly 0, never NaN, where they
// are reached. Fusing the row and column max/argmax the assigner takes next,
// which would drop the output matrix, is later work.

#include <cuda_runtime.h>

#include "rotated_iou.cuh"

namespace {

using rotated_iou::intersection_area;
using rotated_iou::kShrink;
using rotated_iou::rel_corners;

constexpr int kThreads = 256;  // anchor columns per block
constexpr int kRows = 32;      // rows staged per block

struct RowBoxes {
  float cx[4][kRows];  // corners relative to the box centre
  float cy[4][kRows];
  float x[kRows];      // centre
  float y[kRows];
  float area[kRows];   // w * h of the unshrunk box
  float reach[kRows];  // (w + h) / 2
};

// kRowsFirst: the row set is the first operand (unshrunk, IoF denominator);
// otherwise the column set is.
template <bool kRowsFirst>
__global__ void __launch_bounds__(kThreads)
iou_matrix_kernel(const float* __restrict__ rows,
                  const float* __restrict__ cols, float* __restrict__ out,
                  int g, int n, size_t row_batch_stride,
                  size_t col_batch_stride, bool iof) {
  __shared__ RowBoxes s;

  const int b = blockIdx.z;
  const int g0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int j = blockIdx.x * kThreads + tid;
  rows += static_cast<size_t>(b) * row_batch_stride;
  cols += static_cast<size_t>(b) * col_batch_stride;
  out += static_cast<size_t>(b) * g * n;
  const int nrows = min(kRows, g - g0);

  if (tid < nrows) {
    const float* bx = rows + static_cast<size_t>(g0 + tid) * 5;
    const float k = kRowsFirst ? 1.0f : kShrink;
    float ccx[4], ccy[4];
    rel_corners(bx[2] * k, bx[3] * k, bx[4], ccx, ccy);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s.cx[c][tid] = ccx[c];
      s.cy[c][tid] = ccy[c];
    }
    s.x[tid] = bx[0];
    s.y[tid] = bx[1];
    s.area[tid] = bx[2] * bx[3];
    s.reach[tid] = 0.5f * (bx[2] + bx[3]);
  }
  __syncthreads();
  if (j >= n) return;

  const float* qb = cols + static_cast<size_t>(j) * 5;
  const float qx = qb[0], qy = qb[1], qw = qb[2], qh = qb[3];
  const float q_area = qw * qh;
  const float q_reach = 0.5f * (qw + qh);
  float qcx[4], qcy[4];
  {
    const float k = kRowsFirst ? kShrink : 1.0f;
    rel_corners(qw * k, qh * k, qb[4], qcx, qcy);
  }

  for (int r = 0; r < nrows; ++r) {
    float v = 0.0f;
    const float rx = s.x[r], ry = s.y[r];
    const float reach = s.reach[r] + q_reach;
    if (fabsf(rx - qx) <= reach && fabsf(ry - qy) <= reach) {
      float rcx[4], rcy[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        rcx[c] = s.cx[c][r];
        rcy[c] = s.cy[c][r];
      }
      const float r_area = s.area[r];
      float inter = kRowsFirst
          ? intersection_area(rcx, rcy, rx, ry, qcx, qcy, qx, qy)
          : intersection_area(qcx, qcy, qx, qy, rcx, rcy, rx, ry);
      inter = fminf(inter, fminf(r_area, q_area));
      const float first_area = kRowsFirst ? r_area : q_area;
      const float denom = iof ? first_area : r_area + q_area - inter;
      v = inter / fmaxf(denom, 1e-6f);
    }
    out[static_cast<size_t>(g0 + r) * n + j] = v;
  }
}

}  // namespace

// rows (batch or 1, g, 5), cols (batch or 1, n, 5) float32, out
// (batch, g, n) float32, all contiguous on the current device.
// rows_batched / cols_batched say whether that set has one slice per image
// (else one slice shared by the batch). mode: 0 iou, 1 iof (intersection
// over the FIRST operand's area). rows_first: the row set is the first
// operand. Launches on `stream` without synchronising and returns
// cudaGetLastError() of the launch.
extern "C" int box_iou_rotated(const void* rows, const void* cols, void* out,
                               int batch, int g, int n, int rows_batched,
                               int cols_batched, int mode, int rows_first,
                               void* stream) {
  if (batch == 0 || g == 0 || n == 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads, (g + kRows - 1) / kRows,
                  batch);
  const size_t row_stride = rows_batched ? static_cast<size_t>(g) * 5 : 0;
  const size_t col_stride = cols_batched ? static_cast<size_t>(n) * 5 : 0;
  const auto* r = static_cast<const float*>(rows);
  const auto* c = static_cast<const float*>(cols);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (rows_first) {
    iou_matrix_kernel<true><<<grid, kThreads, 0, s>>>(
        r, c, o, g, n, row_stride, col_stride, mode == 1);
  } else {
    iou_matrix_kernel<false><<<grid, kThreads, 0, s>>>(
        r, c, o, g, n, row_stride, col_stride, mode == 1);
  }
  return static_cast<int>(cudaGetLastError());
}
