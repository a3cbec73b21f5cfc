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
// in ONE launch for the whole batch. Which of the two sets is the FIRST
// operand is a template flag, because the operands are not symmetric: the
// second one is shrunk by a relative 1e-6 and the IoF denominator is the
// first one's area. The assigner's IoU has the rows (gt) first; its IoF has
// the columns (anchors) first, and the wrapper returns that matrix as a
// transposed view.
//
// Per-pair arithmetic (rotated_iou.cuh, shared with nms_pair_mask.cu) is the
// plain version's, orientedobjectdetection_torch/ops/iou.py: pair-midpoint
// frame, 1e-6 shrink, physical bound min(inter, min(area1, area2)), exact
// IEEE division. It does NOT take the TPU kernel's joint-mean frame and 1e-4
// shrink, which exist for that kernel's global frame and bias the IoU by
// ~2e-4: the assigner compares this matrix with thresholds and with its own
// row maxima, so it should carry the plain version's values.
//
// What bounds it on an H100: the output, B * G * N * 4 bytes (201 MB at
// batch 8, G = 32 rows, N = 196,416 anchors of a 1024^2 image: 0.061 ms at
// 3.35 TB/s; 3.2 GB at the loader's G = 512: 0.96 ms). Every pair that
// reaches the clip math costs ~600 fp32 operations (the TPU kernel's cost
// model) and ~1,000 instructions with 32 IEEE divisions, but a gt box reaches
// only the anchors around it (about 2% of the pairs), so the bytes bound it.
//
// Three things keep a thread-per-anchor design (each thread walking 32 rows,
// blocks of 256 consecutive anchors) at 4x the bound: the coarse anchors
// (stride 64 and 128, 256 px and wider) reach every gt, so their few blocks
// hold half the clip work, each warp walking up to 32 clips in a row while
// the rest of the card has finished its stores; zero-size padded rows at
// the origin reach every coarse anchor near it; and 4-byte stores with the
// default cache policy. What this design does about it:
// - An exact reject before the clip math, the pair mask's (plain twin
//   ops/iou_kernels.py:pairs_in_reach): centres farther apart on either axis
//   than the sum of the boxes' (w + h) / 2 (each at least the circumradius),
//   or a box of zero area. Such a pair is 0 without a clip.
// - A block owns 32 rows by 256 columns, and those columns are 8 chunks of
//   32 consecutive anchors spread evenly over the whole set (chunk
//   slot * tiles + tile). Anchors come level by level, so every block gets
//   its share of the coarse levels, and the clip work is even over the grid
//   whatever the set's order.
// - A block first streams zeros over its whole tile with 16-byte streaming
//   stores (__stcs: the matrix is 4x the 50 MB L2; scalar ones where
//   N % 4 != 0), then stages and tests, so its stores are in flight while
//   it waits for its loads. A chunk row is one 128-byte line.
// - Each warp (32 consecutive columns) first culls the rows that reach none
//   of its columns (one row a lane, then an OR over the warp), then each
//   lane runs the exact test only on the rows left.
// - The block's pairs in reach are compacted into one list in shared
//   memory and spread over all 256 threads, which store each result over
//   its zero (after the block's barriers, so the later store wins): no lane
//   walks its clips while its warp waits, and most blocks end after the
//   test.
// - 51 registers at most and 29 KB of shared memory, so five blocks share
//   an SM: more stores in flight while other blocks clip.
// Measured by chip_smoke.py and utils/kernel_variants.py on an NVIDIA H100
// 80GB HBM3 at a 700 W power limit: 0.113-0.114 ms at batch 8, G = 32
// (bound 0.061; PyTorch's zero_ of a buffer that size 0.063), 1.37-1.38 ms
// at G = 512 (bound 0.962; zero_ 0.978), 0.118 ms on a train step's inputs.
// A copy without the clip math runs 0.087 / 1.38 ms: the store stream, not
// the clips, holds it now.
// Not used: wgmma (no matrix product here), TMA (a block reads 5 KB and
// writes a plain stream), approximate division (it would change the
// assigner's == ties against its own row maxima). Fusing the row and column
// max/argmax the assigner takes next, which would drop the output matrix,
// is later work: other assigners need the whole matrix.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "rotated_iou.cuh"

namespace {

using rotated_iou::intersection_area;
using rotated_iou::kShrink;
using rotated_iou::rel_corners;

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 5;            // at most 51 registers a thread
constexpr int kRows = 32;                  // rows per block: one bit each
constexpr int kCols = kThreads;            // columns per block, one a thread
constexpr int kChunk = 32;                 // consecutive columns per chunk
constexpr int kSlots = kCols / kChunk;     // chunks per block
constexpr int kGroup = kChunk < 32 ? kChunk : 32;  // lanes sharing a cull
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Reach of a box for the reject: (w + h) / 2, or -inf for a box whose area
// is not positive, so that no pair with it passes.
__device__ __forceinline__ float reach_of(float w, float h) {
  return w * h > 0.0f ? 0.5f * (w + h) : -__int_as_float(0x7f800000);
}

// Can a row of centre c and reach r reach a column whose centre minus its
// reach is at least lo and plus its reach at most hi? A margin of 1e-5 of
// the magnitudes covers the rounding of both this and the exact test, so
// the cull never drops a pair the exact test keeps; a row of reach -inf and
// an empty group (lo = +inf, hi = -inf) compare with NaN: culled.
__device__ __forceinline__ bool near(float c, float r, float lo, float hi) {
  const float m =
      1e-5f * (fabsf(c) + fabsf(r) + fmaxf(fabsf(lo), fabsf(hi)));
  return c + r >= lo - m && c - r <= hi + m;
}

struct Smem {
  float ccx[4][kCols];       // column corners relative to the centre
  float ccy[4][kCols];
  float cx[kCols];           // column centre and unshrunk area
  float cy[kCols];
  float carea[kCols];
  float4 rkey[kRows];        // row centre x, y, reach and unshrunk area
  float rcx[4][kRows];       // row corners relative to the centre
  float rcy[4][kRows];
  union alignas(16) {
    float raw[kCols * 5];             // the columns as loaded
    uint16_t list[kRows * kCols];     // then (row << 8) | column in reach
  } u;
  int warp_total[kWarps];
};

// kRowsFirst: the row set is the first operand (unshrunk, IoF denominator);
// otherwise the column set is.
template <bool kRowsFirst>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
iou_matrix_kernel(const float* __restrict__ rows,
                  const float* __restrict__ cols, float* __restrict__ out,
                  int g, int n, int tiles, int row_tiles,
                  size_t row_batch_stride, size_t col_batch_stride, bool iof,
                  bool vec_loads, bool vec_stores) {
  __shared__ Smem s;

  // block -> (row tile, column tile, image), row tiles fastest
  const int row_tile = blockIdx.x % row_tiles;
  const int tile = blockIdx.x / row_tiles % tiles;
  const int b = blockIdx.x / row_tiles / tiles;
  const int g0 = row_tile * kRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  rows += static_cast<size_t>(b) * row_batch_stride;
  cols += static_cast<size_t>(b) * col_batch_stride;
  out += static_cast<size_t>(b) * g * n;
  const int nrows = min(kRows, g - g0);
  // first column of the block's chunk `slot`; column c of the tile
  auto chunk_start = [&](int slot) {
    return (static_cast<long long>(slot) * tiles + tile) * kChunk;
  };
  auto column = [&](int c) { return chunk_start(c / kChunk) + c % kChunk; };

  // 0. Zeros over the whole tile first, so the stores stream while the
  // block stages and tests: a thread writes 4 consecutive columns of one
  // chunk row. A pair in reach overwrites its zero after the barriers below.
  constexpr int kQuads = kChunk / 4;      // per chunk row
  for (int i = tid; i < kRows * kCols / 4; i += kThreads) {
    const int r = i / (kCols / 4);
    const long long j4 = column(i % (kCols / 4) * 4);
    if (r >= nrows || j4 >= n) continue;
    float* dst = out + static_cast<size_t>(g0 + r) * n + j4;
    if (vec_stores) {                     // n % 4 == 0: j4 + 4 <= n
      __stcs(reinterpret_cast<float4*>(dst),
             make_float4(0.0f, 0.0f, 0.0f, 0.0f));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (j4 + e < n) __stcs(dst + e, 0.0f);
      }
    }
  }
  static_assert(kQuads * 4 == kChunk, "a chunk holds whole quads");

  // 1. Stage the columns' raw boxes (chunk by chunk, kChunk * 5 / 4 float4
  // each), and the rows with their corners.
  constexpr int kVecs = kChunk * 5 / 4;
  for (int i = tid; i < kSlots * kVecs; i += kThreads) {
    const long long j0 = chunk_start(i / kVecs);
    const int k = i % kVecs;
    if (vec_loads && j0 + kChunk <= n) {
      reinterpret_cast<float4*>(s.u.raw)[i] =
          __ldg(reinterpret_cast<const float4*>(cols + j0 * 5) + k);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long f = j0 * 5 + k * 4 + e;
        s.u.raw[i * 4 + e] = f < 5LL * n ? cols[f] : 0.0f;
      }
    }
  }
  if (tid < nrows) {
    const float* bx = rows + static_cast<size_t>(g0 + tid) * 5;
    const float k = kRowsFirst ? 1.0f : kShrink;
    float ccx[4], ccy[4];
    rel_corners(bx[2] * k, bx[3] * k, bx[4], ccx, ccy);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s.rcx[c][tid] = ccx[c];
      s.rcy[c][tid] = ccy[c];
    }
    s.rkey[tid] = make_float4(bx[0], bx[1], reach_of(bx[2], bx[3]),
                              bx[2] * bx[3]);
  }
  __syncthreads();

  // 2. This thread's column (column tid of the tile), its corners into
  // shared memory, and the reject against every row: bit r of `need` is row
  // g0 + r. Rows that reach no column of this thread's group of kGroup
  // consecutive columns are culled first, a few rows per lane.
  const float* qb = s.u.raw + tid * 5;
  const float qx = qb[0], qy = qb[1], qw = qb[2], qh = qb[3];
  {
    const float k = kRowsFirst ? kShrink : 1.0f;
    float qcx[4], qcy[4];
    rel_corners(qw * k, qh * k, qb[4], qcx, qcy);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s.ccx[c][tid] = qcx[c];
      s.ccy[c][tid] = qcy[c];
    }
    s.cx[tid] = qx;
    s.cy[tid] = qy;
    s.carea[tid] = qw * qh;
  }
  const float q_reach =
      column(tid) < n ? reach_of(qw, qh) : -__int_as_float(0x7f800000);
  uint32_t near_rows = nrows == 32 ? kFull : (1u << nrows) - 1;
  {
    float lo_x = qx - q_reach, hi_x = qx + q_reach;
    float lo_y = qy - q_reach, hi_y = qy + q_reach;
#pragma unroll
    for (int d = kGroup / 2; d > 0; d >>= 1) {
      lo_x = fminf(lo_x, __shfl_xor_sync(kFull, lo_x, d));
      hi_x = fmaxf(hi_x, __shfl_xor_sync(kFull, hi_x, d));
      lo_y = fminf(lo_y, __shfl_xor_sync(kFull, lo_y, d));
      hi_y = fmaxf(hi_y, __shfl_xor_sync(kFull, hi_y, d));
    }
    uint32_t mine = 0;
    for (int r = lane % kGroup; r < nrows; r += kGroup) {
      const float4 key = s.rkey[r];
      if (near(key.x, key.z, lo_x, hi_x) && near(key.y, key.z, lo_y, hi_y)) {
        mine |= 1u << r;
      }
    }
#pragma unroll
    for (int d = kGroup / 2; d > 0; d >>= 1) {
      mine |= __shfl_xor_sync(kFull, mine, d);
    }
    near_rows = mine;
  }
  uint32_t need = 0;
  for (uint32_t m = near_rows; m; m &= m - 1) {
    const int r = __ffs(m) - 1;
    const float4 key = s.rkey[r];
    const float reach = key.z + q_reach;
    if (fabsf(key.x - qx) <= reach && fabsf(key.y - qy) <= reach) {
      need |= 1u << r;
    }
  }

  // 3. The block's pairs in reach: each thread's offset in the list.
  const int cnt = __popc(need);
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s.warp_total[warp] = incl;
  __syncthreads();   // every thread has also read its raw column
  int pos = incl - cnt, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = s.warp_total[w];
    pos += w < warp ? t : 0;
    total += t;
  }
  if (total == 0) return;                 // block-uniform

  // 4. Clip the listed pairs with all threads, each result over its zero.
  while (need) {
    const int r = __ffs(need) - 1;
    need &= need - 1;
    s.u.list[pos++] = static_cast<uint16_t>((r << 8) | tid);
  }
  __syncthreads();
  for (int q = tid; q < total; q += kThreads) {
    const int e = s.u.list[q];
    const int r = e >> 8, c = e & 0xff;
    float rcx[4], rcy[4], qcx[4], qcy[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      rcx[k] = s.rcx[k][r];
      rcy[k] = s.rcy[k][r];
      qcx[k] = s.ccx[k][c];
      qcy[k] = s.ccy[k][c];
    }
    const float4 key = s.rkey[r];
    const float rx = key.x, ry = key.y, px = s.cx[c], py = s.cy[c];
    const float r_area = key.w, q_area = s.carea[c];
    float inter = kRowsFirst
        ? intersection_area(rcx, rcy, rx, ry, qcx, qcy, px, py)
        : intersection_area(qcx, qcy, px, py, rcx, rcy, rx, ry);
    inter = fminf(inter, fminf(r_area, q_area));
    const float first_area = kRowsFirst ? r_area : q_area;
    const float denom = iof ? first_area : r_area + q_area - inter;
    out[static_cast<size_t>(g0 + r) * n + column(c)] =
        inter / fmaxf(denom, 1e-6f);
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
  const long long chunks = (static_cast<long long>(n) + kChunk - 1) / kChunk;
  const long long tiles = (chunks + kSlots - 1) / kSlots;
  const long long row_tiles = (g + kRows - 1) / kRows;
  const long long blocks = tiles * row_tiles * batch;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t row_stride = rows_batched ? static_cast<size_t>(g) * 5 : 0;
  const size_t col_stride = cols_batched ? static_cast<size_t>(n) * 5 : 0;
  const auto* r = static_cast<const float*>(rows);
  const auto* c = static_cast<const float*>(cols);
  auto* o = static_cast<float*>(out);
  // 16-byte loads need every image's columns aligned, stores every row
  const bool vec_loads = reinterpret_cast<uintptr_t>(c) % 16 == 0 &&
                         (col_stride * 4) % 16 == 0;
  const bool vec_stores = reinterpret_cast<uintptr_t>(o) % 16 == 0 &&
                          n % 4 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  const int nx = static_cast<int>(tiles), ny = static_cast<int>(row_tiles);
  if (rows_first) {
    iou_matrix_kernel<true><<<grid, kThreads, 0, s>>>(
        r, c, o, g, n, nx, ny, row_stride, col_stride, mode == 1,
        vec_loads, vec_stores);
  } else {
    iou_matrix_kernel<false><<<grid, kThreads, 0, s>>>(
        r, c, o, g, n, nx, ny, row_stride, col_stride, mode == 1,
        vec_loads, vec_stores);
  }
  return static_cast<int>(cudaGetLastError());
}
