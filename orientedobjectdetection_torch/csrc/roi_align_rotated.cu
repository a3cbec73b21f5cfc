// RoIAlignRotated (7x7 bins, 2x2 samples per bin) over an FPN pyramid with
// per-RoI level routing, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel orientedobjectdetection_tpu/ops/roi_align_pallas.py:
// roi_align_rotated_pallas (kernel body _make_kernel). It computes the
// contract of the gather formulation,
// orientedobjectdetection_torch/ops/roi_align_rotated.py: for RoI
// (cx, cy, w, h, theta) routed to pyramid level l, a 14x14 sample grid at
// ((k + 0.5) / 14 - 0.5) * (w, h), rotated by theta (negated when
// `clockwise`), shifted to (cx, cy), times the level's scale, minus 0.5;
// four bilinear corners per sample, a corner whose integer coordinate lies
// outside [0, W) x [0, H) contributing 0 (masked, not clamped, as mmcv); the
// mean of each bin's 2x2 samples; exact zeros for RoIs with w <= 1e-3 or
// h <= 1e-3.
//
// What is NOT carried over from the TPU kernel: its per-RoI window copy, the
// bilinear weights as two bf16 matrices multiplied on the matrix unit, the
// origin rounding and the gather fallback for RoIs larger than the window.
// They work around slow gathers on that machine. Here a thread reads the
// cells it needs directly, so every RoI geometry takes the same path and the
// weights stay float32.
//
// What bounds it on an H100: at the serving shape (batch 8, 2000 RoIs per
// image, C = 256) the output is 200,704,000 elements, 401 MB in bf16 and
// 803 MB in float32, and the feature cells the samples touch, each read once,
// come to about as much again: 0.22 / 0.45 ms at 3.35 TB/s. The arithmetic
// is 196 x 4 FMAs per channel and RoI, about 6 GFLOP, 0.1 ms at 67 TFLOP/s.
// So bytes bound it. This first design does not reach that bound: measured
// by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power limit it
// takes 1.9-2.0 ms in either type, so the 784 one-element loads and 1568
// shared-memory reads each thread issues limit it, not the bytes.
//
// Design (simple first): one block per (RoI, image), one thread per channel.
// Features are channels-last, so the C values of one cell are one coalesced
// read by the block and the C values of one output bin one coalesced store.
// The 196 samples' corner cells and weights are the same for every channel:
// the block computes them once into 6 KB of shared memory (cell index -1 for
// a masked corner), then each thread walks 49 bins x 4 samples x 4 corners,
// accumulating in a float32 register, and rounds once to the output type.
// The RoI's level is computed by the caller (so that log2 here cannot route
// a RoI differently from the plain version) and selects one of up to four
// base pointers carried by value. Padding RoIs write their zeros here: the
// output buffer is uninitialised. Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kGrid = 14;              // samples per side: 7 bins x 2
constexpr int kSamples = kGrid * kGrid;
constexpr int kBinsSide = 7;
constexpr int kBins = kBinsSide * kBinsSide;
constexpr int kMaxThreads = 256;

struct Pyramid {
  const void* feat[kMaxLevels];  // (batch, h, w, channels), channels-last
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];       // feature cells per image pixel
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
roi_align_rotated_kernel(Pyramid pyr, const float* __restrict__ rois,
                         const int* __restrict__ levels, T* __restrict__ out,
                         int num_rois, int channels, bool clockwise) {
  __shared__ int s_cell[4][kSamples];    // y * W + x, or -1 when masked
  __shared__ float s_wgt[4][kSamples];

  const int tid = threadIdx.x;
  const size_t roi_idx =
      static_cast<size_t>(blockIdx.y) * num_rois + blockIdx.x;
  const float* roi = rois + roi_idx * 5;
  T* o = out + roi_idx * (static_cast<size_t>(kBins) * channels);
  const float cx = roi[0], cy = roi[1], w = roi[2], h = roi[3];

  if (!(w > 1e-3f && h > 1e-3f)) {       // padding RoI: exact zeros
    for (int i = tid; i < kBins * channels; i += blockDim.x) {
      from_float(0.0f, o + i);
    }
    return;
  }

  const int lvl = levels[roi_idx];
  const void* feat = pyr.feat[0];
  int fh = pyr.h[0], fw = pyr.w[0];
  float scale = pyr.scale[0];
#pragma unroll
  for (int l = 1; l < kMaxLevels; ++l) {
    if (lvl == l) {
      feat = pyr.feat[l];
      fh = pyr.h[l];
      fw = pyr.w[l];
      scale = pyr.scale[l];
    }
  }

  float sn, cs;
  sincosf(clockwise ? -roi[4] : roi[4], &sn, &cs);
  for (int p = tid; p < kSamples; p += blockDim.x) {
    const float gx = (static_cast<float>(p % kGrid) + 0.5f) / kGrid - 0.5f;
    const float gy = (static_cast<float>(p / kGrid) + 0.5f) / kGrid - 0.5f;
    const float lx = gx * w, ly = gy * h;
    const float px = cx + lx * cs - ly * sn;
    const float py = cy + lx * sn + ly * cs;
    const float fx = px * scale - 0.5f;
    const float fy = py * scale - 0.5f;
    const float x0f = floorf(fx), y0f = floorf(fy);
    const float wx1 = fx - x0f, wy1 = fy - y0f;
    const float wx0 = 1.0f - wx1, wy0 = 1.0f - wy1;
    // every coordinate below -1 or above the last cell is masked for both
    // corners, so the clamp only keeps the conversion to int in range
    const int x0 = static_cast<int>(fminf(fmaxf(x0f, -2.0f),
                                          static_cast<float>(fw)));
    const int y0 = static_cast<int>(fminf(fmaxf(y0f, -2.0f),
                                          static_cast<float>(fh)));
    const bool xin0 = x0 >= 0 && x0 < fw, xin1 = x0 + 1 >= 0 && x0 + 1 < fw;
    const bool yin0 = y0 >= 0 && y0 < fh, yin1 = y0 + 1 >= 0 && y0 + 1 < fh;
    s_cell[0][p] = (xin0 && yin0) ? y0 * fw + x0 : -1;
    s_cell[1][p] = (xin1 && yin0) ? y0 * fw + x0 + 1 : -1;
    s_cell[2][p] = (xin0 && yin1) ? (y0 + 1) * fw + x0 : -1;
    s_cell[3][p] = (xin1 && yin1) ? (y0 + 1) * fw + x0 + 1 : -1;
    s_wgt[0][p] = wx0 * wy0;
    s_wgt[1][p] = wx1 * wy0;
    s_wgt[2][p] = wx0 * wy1;
    s_wgt[3][p] = wx1 * wy1;
  }
  __syncthreads();

  const T* base = static_cast<const T*>(feat) +
                  static_cast<size_t>(blockIdx.y) * fh * fw * channels;
  for (int c = tid; c < channels; c += blockDim.x) {
    for (int bin = 0; bin < kBins; ++bin) {
      const int p00 = (2 * (bin / kBinsSide)) * kGrid + 2 * (bin % kBinsSide);
      float acc = 0.0f;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int p = p00 + (s >> 1) * kGrid + (s & 1);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int cell = s_cell[k][p];
          if (cell >= 0) {
            acc += s_wgt[k][p] *
                   to_float(base[static_cast<size_t>(cell) * channels + c]);
          }
        }
      }
      from_float(acc * 0.25f, o + static_cast<size_t>(bin) * channels + c);
    }
  }
}

}  // namespace

// feats: `num_levels` (<= 4) device pointers to contiguous
// (batch, hs[l], ws[l], channels) tensors of one type (is_bf16: bfloat16,
// else float32); feats, hs, ws and scales are HOST arrays of num_levels
// entries. rois (batch, num_rois, 5) float32, levels (batch, num_rois) int32
// in [0, num_levels), out (batch, num_rois, 7, 7, channels) of the features'
// type, all contiguous on the current device. Launches on `stream` without
// synchronising and returns cudaGetLastError() of the launch.
extern "C" int roi_align_rotated(const void* const* feats, const int* hs,
                                 const int* ws, const float* scales,
                                 int num_levels, const void* rois,
                                 const void* levels, void* out, int batch,
                                 int num_rois, int channels, int is_bf16,
                                 int clockwise, void* stream) {
  if (batch == 0 || num_rois == 0 || channels == 0) return 0;
  if (num_levels < 1 || num_levels > kMaxLevels || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Pyramid pyr;
  for (int l = 0; l < kMaxLevels; ++l) {
    const int src = l < num_levels ? l : 0;
    pyr.feat[l] = feats[src];
    pyr.h[l] = hs[src];
    pyr.w[l] = ws[src];
    pyr.scale[l] = scales[src];
  }
  const int threads = std::min(kMaxThreads, ((channels + 31) / 32) * 32);
  const dim3 grid(num_rois, batch);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const float*>(rois);
  const auto* lv = static_cast<const int*>(levels);
  if (is_bf16) {
    roi_align_rotated_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        pyr, r, lv, static_cast<__nv_bfloat16*>(out), num_rois, channels,
        clockwise != 0);
  } else {
    roi_align_rotated_kernel<float><<<grid, threads, 0, s>>>(
        pyr, r, lv, static_cast<float*>(out), num_rois, channels,
        clockwise != 0);
  }
  return static_cast<int>(cudaGetLastError());
}
