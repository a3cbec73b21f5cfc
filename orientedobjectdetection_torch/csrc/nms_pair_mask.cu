// NMS pair mask for rotated boxes, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel orientedobjectdetection_tpu/ops/iou_pallas.py:
// nms_pair_mask_pallas (kernel body _pair_mask_kernel). For score-sorted,
// class-major boxes (B, N, 5) and class ids (B, N) it writes the (B, N, N)
// uint8 mask
//
//     mask[b, i, j] = IoU(box_i, box_j) > thr  and  i < j  and  cls_i == cls_j
//
// in ONE launch for the whole batch: grid (N/64, N/64, B), one block per
// (image, 64x64 tile).
//
// Per-pair arithmetic (rotated_iou.cuh, shared with box_iou_rotated.cu) is
// the plain version's, orientedobjectdetection_torch/ops/iou.py (itself the
// JAX package's ops/iou.py:_intersect_area_rel):
// corners relative to each box center, a per-pair midpoint frame, the second
// operand shrunk by 1e-6, a Liang-Barsky clip of each of the 8 edges against
// the other box's 4 half-planes summed by Green's theorem, and an exact IEEE
// division inter / max(union, 1e-6). It does NOT take the TPU kernel's
// global-frame 1e-4 shrink or its approximate reciprocal, so away from a
// rounding-sized band around thr it gives the plain version's bits.
//
// What bounds it on an H100: at B=8, N=2000 the output alone is 32 MB of
// uint8 (~10 us at 3.35 TB/s), and each pair the clip math must evaluate costs
// ~300 fp32 operations (the TPU kernel's cost model), so the ~2.0 M upper-
// triangle pairs per image would take ~72 us at 67 TFLOP/s: compute-bound
// without the class skip. With class-major order only same-class pairs need
// the clip math (~1/15 of them for DOTA's 15 classes), which leaves the
// output bytes as the bound.
//
// What the design does about it: the TPU kernel's two tile skips are early
// exits that only write zeros: tiles entirely on or below the diagonal, and
// tiles whose row-max class is below their column-min class (padded
// candidates carry class num_classes and sort last, so their tiles skip
// too). Live tiles stage their 64 row and 64 column boxes in shared memory
// with the sincos corner geometry computed once per box, then each of 256
// threads evaluates 16 pairs (one column, every 4th row). A warp writes 32
// consecutive mask bytes per row. Bit-packing the mask and fusing the greedy
// scan are later work.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "rotated_iou.cuh"

namespace {

using rotated_iou::intersection_area;
using rotated_iou::kShrink;
using rotated_iou::rel_corners;

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kRowGroups = kThreads / kTile;      // 4
constexpr int kRowsPerThread = kTile / kRowGroups;  // 16

struct TileBoxes {
  float cx[4][kTile];  // corners relative to the box centre
  float cy[4][kTile];
  float x[kTile];      // centre
  float y[kTile];
  float area[kTile];   // w * h of the unshrunk box
};

__global__ void __launch_bounds__(kThreads)
pair_mask_kernel(const float* __restrict__ boxes,
                 const int32_t* __restrict__ cls,
                 uint8_t* __restrict__ out, int n, float thr) {
  __shared__ TileBoxes rows, cols;
  __shared__ int32_t s_cls_row[kTile], s_cls_col[kTile];
  __shared__ int s_row_max, s_col_min;

  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  boxes += static_cast<size_t>(b) * n * 5;
  cls += static_cast<size_t>(b) * n;
  out += static_cast<size_t>(b) * n * n;

  const int tid = threadIdx.x;
  const int tx = tid % kTile;        // column within the tile
  const int ty = tid / kTile;        // first row within the tile

  // Tile skip 1: no pair with j > i (the tile is on or below the diagonal).
  bool live = c0 + kTile - 1 > r0;
  if (live) {
    // Tile skip 2: with class-major order, no same-class pair is possible
    // when every row class is below every column class.
    if (tid == 0) {
      s_row_max = INT_MIN;
      s_col_min = INT_MAX;
    }
    __syncthreads();
    if (tid < kTile && r0 + tid < n) {
      s_cls_row[tid] = cls[r0 + tid];
      atomicMax(&s_row_max, s_cls_row[tid]);
    } else if (tid >= kTile && tid < 2 * kTile && c0 + tx < n) {
      s_cls_col[tx] = cls[c0 + tx];
      atomicMin(&s_col_min, s_cls_col[tx]);
    }
    __syncthreads();
    live = s_row_max >= s_col_min;
  }
  if (!live) {
    const int j = c0 + tx;
    if (j < n) {
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int i = r0 + ty + r * kRowGroups;
        if (i < n) out[static_cast<size_t>(i) * n + j] = 0;
      }
    }
    return;
  }

  // Stage the tile's boxes: corners once per box. Rows are the first
  // operand; columns the second, shrunk by a relative 1e-6 (the plain
  // version's boundary tie-break).
  if (tid < kTile && r0 + tid < n) {
    const float* bx = boxes + static_cast<size_t>(r0 + tid) * 5;
    float ccx[4], ccy[4];
    rel_corners(bx[2], bx[3], bx[4], ccx, ccy);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      rows.cx[k][tid] = ccx[k];
      rows.cy[k][tid] = ccy[k];
    }
    rows.x[tid] = bx[0];
    rows.y[tid] = bx[1];
    rows.area[tid] = bx[2] * bx[3];
  } else if (tid >= kTile && tid < 2 * kTile && c0 + tx < n) {
    const float* bx = boxes + static_cast<size_t>(c0 + tx) * 5;
    float ccx[4], ccy[4];
    rel_corners(bx[2] * kShrink, bx[3] * kShrink, bx[4], ccx, ccy);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      cols.cx[k][tx] = ccx[k];
      cols.cy[k][tx] = ccy[k];
    }
    cols.x[tx] = bx[0];
    cols.y[tx] = bx[1];
    cols.area[tx] = bx[2] * bx[3];
  }
  __syncthreads();

  const int j = c0 + tx;
  if (j >= n) return;
  const float qx = cols.x[tx], qy = cols.y[tx], q_area = cols.area[tx];
  const int32_t q_cls = s_cls_col[tx];
  float qcx[4], qcy[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    qcx[k] = cols.cx[k][tx];
    qcy[k] = cols.cy[k][tx];
  }

  for (int r = 0; r < kRowsPerThread; ++r) {
    const int ti = ty + r * kRowGroups;
    const int i = r0 + ti;
    if (i >= n) break;
    uint8_t m = 0;
    if (j > i && s_cls_row[ti] == q_cls) {
      float rcx[4], rcy[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        rcx[k] = rows.cx[k][ti];
        rcy[k] = rows.cy[k][ti];
      }
      const float p_area = rows.area[ti];
      const float inter =
          fminf(intersection_area(rcx, rcy, rows.x[ti], rows.y[ti], qcx, qcy,
                                  qx, qy),
                fminf(p_area, q_area));
      const float iou = inter / fmaxf(p_area + q_area - inter, 1e-6f);
      m = iou > thr ? 1 : 0;
    }
    out[static_cast<size_t>(i) * n + j] = m;
  }
}

}  // namespace

// boxes (batch, n, 5) float32, cls (batch, n) int32, out (batch, n, n) uint8,
// all contiguous on the current device. Launches on `stream` without
// synchronising and returns cudaGetLastError() of the launch.
extern "C" int nms_pair_mask(const void* boxes, const void* cls, void* out,
                             int batch, int n, float thr, void* stream) {
  if (batch == 0 || n == 0) return 0;
  const int tiles = (n + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles, batch);
  pair_mask_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const int32_t*>(cls),
      static_cast<uint8_t*>(out), n, thr);
  return static_cast<int>(cudaGetLastError());
}
