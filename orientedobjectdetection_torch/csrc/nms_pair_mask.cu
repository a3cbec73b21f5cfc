// NMS pair mask for rotated boxes, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel orientedobjectdetection_tpu/ops/iou_pallas.py:
// nms_pair_mask_pallas (kernel body _pair_mask_kernel). For score-sorted,
// class-major boxes (B, N, 5) and class ids (B, N) it writes the (B, N, N)
// uint8 mask
//
//     mask[b, i, j] = IoU(box_i, box_j) > thr  and  i < j  and  cls_i == cls_j
//
// in ONE launch for the whole batch: grid (N/64 x N/128, B), one block per
// (image, band of 64 rows, chunk of 128 columns).
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
// uint8 (~10 us at 3.35 TB/s). Each pair that reaches the clip math costs
// ~300 fp32 operations (the TPU kernel's cost model): all ~2.0 M upper-
// triangle pairs per image would take ~72 us at 67 TFLOP/s, and with
// class-major order only same-class pairs need it (~1/15 of them for 15
// even classes; far more on a real request, whose top 2000 (box, class)
// candidates fall into few classes). The first design (one block per 64x64
// tile, 8192 blocks) ran the clip on every same-class pair in a live tile,
// stored one byte per lane and paid two __syncthreads and shared atomics per
// tile: 0.14 ms on 15 even classes, 0.74 ms on RetinaNet's serving
// candidates, 15x and more above the output bytes.
//
// What this design does about it:
// - An exact reject before the clip math, per pair: two boxes whose centres
//   lie farther apart on either axis than the sum of their (w + h) / 2 (each
//   at least the box's circumradius) cannot meet, and a box of zero (or
//   negative) area has IoU <= 0 with anything by the physical bound; their
//   mask is 0. Plain twin: ops/iou_kernels.py:pairs_in_reach. The class
//   offsets of ops/nms.py move other classes out of reach too.
// - The pairs that pass are compacted per warp: each lane tests its 16
//   pairs, pushes the survivors into a warp queue in shared memory, and the
//   warp's 32 lanes run the clip on 32 queued pairs at a time, so the clip
//   costs by pairs in reach, not by pairs tested.
// - One block per band of 64 rows and chunk of two 64-column tiles walks
//   its tiles. Chunks keep the blocks even where every pair is live (the
//   top band of a one-class image has 32 live tiles at N = 2000, the bottom
//   one 1). Below the diagonal, and where the band's largest row class is
//   below the tile's smallest column class (the class-major skip; padded
//   candidates carry class num_classes and sort last), a tile only gets
//   zeros: no staging, no barrier. The band's row boxes are staged once, at
//   its first live tile (corners from one sincosf each). Class ranges come
//   from warp reductions (__reduce_max_sync / __reduce_min_sync) that every
//   warp computes for itself: no shared atomics, and for class ids in any
//   order the skip only prunes.
// - A lane stores 16 mask bytes of one row at once (16-byte stores when
//   N % 16 == 0, 4-byte stores when N % 4 == 0, bytes otherwise).
// Bit-packing the mask and fusing the greedy scan are later work: both
// change what the kernel returns.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit, B = 8, N = 2000: 0.031 ms on 15 even synthetic classes (bound
// 0.0097 ms, the output bytes); 0.168 ms on a RetinaNet request's
// candidates (16.0 M same-class pairs, 1.85 M of them in reach) and
// 0.065 ms on an Oriented R-CNN request's (5.7 M, 0.16 M). On those the
// clip math of the pairs in reach takes most of the time: a copy without
// it runs 0.053 / 0.028 ms, a copy without the reject 0.70 / 0.31 ms.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "rotated_iou.cuh"

namespace {

using rotated_iou::intersection_area;
using rotated_iou::kShrink;
using rotated_iou::rel_corners;

constexpr int kBand = 64;                 // rows per block, columns per tile
constexpr int kChunk = 2;                 // tiles per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 16;                  // columns per lane
constexpr int kSegs = kBand / kSeg;       // 4 lanes per row
constexpr unsigned kFull = 0xffffffffu;

// Reach of a box for the reject: (w + h) / 2, or -inf for a box whose area
// is not positive, so that no pair with it passes.
__device__ __forceinline__ float reach_of(float w, float h) {
  return w * h > 0.0f ? 0.5f * (w + h) : -__int_as_float(0x7f800000);
}

struct TileBoxes {
  float cx[4][kBand];  // corners relative to the box centre
  float cy[4][kBand];
  float x[kBand];      // centre
  float y[kBand];
  float area[kBand];   // w * h of the unshrunk box
};

// Stage box k into slot `slot` of `s`, its sides shrunk by `shrink` before
// the corners are taken; returns its reject key (x, y, reach, class).
__device__ __forceinline__ float4 stage_box(const float* boxes,
                                            const int32_t* cls, int k,
                                            float shrink, TileBoxes& s,
                                            int slot) {
  const float* bx = boxes + static_cast<size_t>(k) * 5;
  float ccx[4], ccy[4];
  rel_corners(bx[2] * shrink, bx[3] * shrink, bx[4], ccx, ccy);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    s.cx[c][slot] = ccx[c];
    s.cy[c][slot] = ccy[c];
  }
  s.x[slot] = bx[0];
  s.y[slot] = bx[1];
  s.area[slot] = bx[2] * bx[3];
  return make_float4(bx[0], bx[1], reach_of(bx[2], bx[3]),
                     __int_as_float(cls[k]));
}

__device__ __forceinline__ void store_segment(uint8_t* row, int j0, int n,
                                              uint4 bits, int width) {
  if (j0 >= n) return;
  if (width == 16) {                      // n % 16 == 0: j0 + 16 <= n
    *reinterpret_cast<uint4*>(row + j0) = bits;
    return;
  }
  if (width == 4) {                       // n % 4 == 0
    uint32_t* words = reinterpret_cast<uint32_t*>(row + j0);
    words[0] = bits.x;
    if (j0 + 4 < n) words[1] = bits.y;
    if (j0 + 8 < n) words[2] = bits.z;
    if (j0 + 12 < n) words[3] = bits.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < kSeg; ++k) {
    const uint32_t word = k < 4 ? bits.x : k < 8 ? bits.y
                        : k < 12 ? bits.z : bits.w;
    if (j0 + k < n) row[j0 + k] = (word >> (8 * (k & 3))) & 0xffu;
  }
}

__global__ void __launch_bounds__(kThreads)
pair_mask_kernel(const float* __restrict__ boxes,
                 const int32_t* __restrict__ cls,
                 uint8_t* __restrict__ out, int n, int chunks, float thr,
                 int width) {
  __shared__ TileBoxes rows, cols;
  __shared__ float4 s_row_key[kBand];         // row x, y, reach, class
  __shared__ float4 s_key[kBand];             // column x, y, reach, class
  __shared__ uint4 s_mask[kBand][kSegs];      // the tile's mask bytes
  __shared__ uint16_t s_queue[kWarps][32 * kSeg];  // (row << 6) | column

  const int b = blockIdx.y;
  const int r0 = blockIdx.x / chunks * kBand;
  const int t0 = blockIdx.x % chunks * kChunk;
  boxes += static_cast<size_t>(b) * n * 5;
  cls += static_cast<size_t>(b) * n;
  out += static_cast<size_t>(b) * n * n;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int lr = tid / kSegs;        // the row this lane stores, in the band
  const int seg = tid % kSegs;       // its 16 columns in each tile
  const int i = r0 + lr;
  const bool row_ok = i < n;

  uint8_t* out_row = out + static_cast<size_t>(i) * n;
  const int t1 = min(t0 + kChunk, (n + kBand - 1) / kBand);
  // the band's largest class, in every warp, where a tile of the chunk
  // lies above the diagonal
  int row_max = INT_MIN;
  if (t1 * kBand - 1 > r0) {
    row_max = __reduce_max_sync(
        kFull, max(r0 + lane < n ? cls[r0 + lane] : INT_MIN,
                   r0 + 32 + lane < n ? cls[r0 + 32 + lane] : INT_MIN));
  }
  // this lane's row for the reject, read once the rows are staged
  bool staged = false;
  float4 row_key = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int t = t0; t < t1; ++t) {
    const int c0 = t * kBand;
    const int j0 = c0 + seg * kSeg;
    uint4 bits = make_uint4(0u, 0u, 0u, 0u);
    // Block-uniform: a tile with no pair j > i (below the diagonal), or
    // whose classes all exceed the band's, only gets zeros.
    bool live = c0 + kBand - 1 > r0;
    if (live) {
      const int col_min = __reduce_min_sync(
          kFull, min(c0 + lane < n ? cls[c0 + lane] : INT_MAX,
                     c0 + 32 + lane < n ? cls[c0 + 32 + lane] : INT_MAX));
      live = row_max >= col_min;
    }
    if (live) {
      __syncthreads();   // the previous live tile is done with cols, s_key
      if (tid < kBand) {
        // columns: second operand, shrunk by a relative 1e-6 (the plain
        // version's boundary tie-break)
        if (c0 + tid < n) {
          s_key[tid] = stage_box(boxes, cls, c0 + tid, kShrink, cols, tid);
        }
      } else if (!staged && tid < 2 * kBand) {
        // rows, at the first live tile: first operand, unshrunk
        const int k = tid - kBand;
        if (r0 + k < n) {
          s_row_key[k] = stage_box(boxes, cls, r0 + k, 1.0f, rows, k);
        }
      }
      __syncthreads();
      if (!staged) {
        staged = true;
        if (row_ok) row_key = s_row_key[lr];
      }
      const float rx = row_key.x, ry = row_key.y, rreach = row_key.z;
      const int rcls = __float_as_int(row_key.w);

      // The reject, per pair: bit k of `need` is column j0 + k.
      uint32_t need = 0;
      if (row_ok) {
#pragma unroll
        for (int k = 0; k < kSeg; ++k) {
          const int j = j0 + k;
          if (j > i && j < n) {
            const float4 key = s_key[seg * kSeg + k];
            const float reach = rreach + key.z;
            if (__float_as_int(key.w) == rcls &&
                fabsf(key.x - rx) <= reach && fabsf(key.y - ry) <= reach) {
              need |= 1u << k;
            }
          }
        }
      }
      // Compact the warp's surviving pairs into its queue; the warp then
      // clips 32 of them at a time and sets their bytes in s_mask.
      const int cnt = __popc(need);
      int incl = cnt;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += v;
      }
      const int total = __shfl_sync(kFull, incl, 31);
      if (total > 0) {                    // warp-uniform
        s_mask[lr][seg] = make_uint4(0u, 0u, 0u, 0u);
        int pos = incl - cnt;
        while (need) {
          const int k = __ffs(need) - 1;
          need &= need - 1;
          s_queue[warp][pos++] =
              static_cast<uint16_t>((lr << 6) | (seg * kSeg + k));
        }
        __syncwarp();
        uint8_t* mask = reinterpret_cast<uint8_t*>(s_mask);
        for (int q = lane; q < total; q += 32) {
          const int e = s_queue[warp][q];
          const int pr = e >> 6, pc = e & 63;
          float rcx[4], rcy[4], qcx[4], qcy[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            rcx[k] = rows.cx[k][pr];
            rcy[k] = rows.cy[k][pr];
            qcx[k] = cols.cx[k][pc];
            qcy[k] = cols.cy[k][pc];
          }
          const float p_area = rows.area[pr], q_area = cols.area[pc];
          const float inter =
              fminf(intersection_area(rcx, rcy, rows.x[pr], rows.y[pr], qcx,
                                      qcy, cols.x[pc], cols.y[pc]),
                    fminf(p_area, q_area));
          const float iou = inter / fmaxf(p_area + q_area - inter, 1e-6f);
          if (iou > thr) mask[pr * kBand + pc] = 1;
        }
        __syncwarp();
        bits = s_mask[lr][seg];
      }
    }
    if (row_ok) store_segment(out_row, j0, n, bits, width);
  }
}

}  // namespace

// boxes (batch, n, 5) float32, cls (batch, n) int32, out (batch, n, n) uint8,
// all contiguous on the current device. Launches on `stream` without
// synchronising and returns cudaGetLastError() of the launch.
extern "C" int nms_pair_mask(const void* boxes, const void* cls, void* out,
                             int batch, int n, float thr, void* stream) {
  if (batch == 0 || n == 0) return 0;
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int width = n % 16 == 0 ? 16 : n % 4 == 0 ? 4 : 1;
  const int bands = (n + kBand - 1) / kBand;
  const int chunks = (bands + kChunk - 1) / kChunk;
  const dim3 grid(bands * chunks, batch);
  pair_mask_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const int32_t*>(cls),
      static_cast<uint8_t*>(out), n, chunks, thr, width);
  return static_cast<int>(cudaGetLastError());
}
