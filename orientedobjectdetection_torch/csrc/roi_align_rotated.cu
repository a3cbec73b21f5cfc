// RoIAlignRotated (7x7 bins, 2x2 samples per bin, or 1 with sampling ratio
// 1) over an FPN pyramid with per-RoI level routing, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel orientedobjectdetection_tpu/ops/roi_align_pallas.py:
// roi_align_rotated_pallas (kernel body _make_kernel). It computes the
// contract of the gather formulation,
// orientedobjectdetection_torch/ops/roi_align_rotated.py: for RoI
// (cx, cy, w, h, theta) routed to pyramid level l, a 14x14 sample grid at
// ((k + 0.5) / 14 - 0.5) * (w, h) (7x7 at ((k + 0.5) / 7 - 0.5) with
// sampling ratio 1, the Rotated Faster R-CNN config's), rotated by theta
// (negated when
// `clockwise`), shifted to (cx, cy), times the level's scale, minus 0.5;
// four bilinear corners per sample, a corner whose integer coordinate lies
// outside [0, W) x [0, H) contributing 0 (masked, not clamped, as mmcv); the
// mean of each bin's samples; exact zeros for RoIs with w <= 1e-3 or
// h <= 1e-3.
//
// What is NOT carried over from the TPU kernel: its per-RoI window copy, the
// bilinear weights as two bf16 matrices multiplied on the matrix unit, the
// origin rounding and the gather fallback for RoIs larger than the window.
// They work around slow gathers on that machine. Here a lane reads the
// cells it needs directly, so every RoI geometry takes the same path and the
// weights stay float32.
//
// What bounds it on an H100: at the serving shape (batch 8, 2000 RoIs per
// image, C = 256) the output is 200,704,000 elements, 401 MB in bf16 and
// 803 MB in float32, and the feature cells the samples touch, each read once,
// come to about as much again: 0.22 / 0.45 ms at 3.35 TB/s. The arithmetic
// is 196 x 4 FMAs per channel and RoI, about 6 GFLOP, 0.1 ms at 67 TFLOP/s.
// So bytes bound it. The first design (one block per RoI, one thread per
// channel) issued 784 one-element loads, 1568 scalar shared-memory reads and
// 49 one-element stores per thread and took 1.9-2.0 ms in either type: the
// instructions issued limited it, not the bytes.
//
// Design. Every (sample, corner) read of a bin is a read of one cell's C
// contiguous channels (features are channels-last), so:
// - Channels in 16-byte vectors. A lane owns 16 bytes of channels (8 bf16
//   or 4 float32); a RoI's "team" of C / 8 (bf16) or C / 4 (float32) lanes,
//   one warp or two at C = 256, reads a corner as one coalesced 512-byte
//   request per warp and stores a bin as one 16-byte store per lane: 8x
//   (bf16) and 4x (float32) fewer load and store instructions.
// - Loads in flight. A lane issues the 16 independent corner loads of a bin
//   before it accumulates any of them (float32 accumulation, one rounding to
//   the output type per element).
// - A sample's corner data read once per lane. The block computes the
//   geometry of one row of bins (2 x 14 samples) of each of its RoIs at a
//   time into shared memory, each sample's four corner offsets as an int4
//   (-1 for a masked corner) and four weights as a float4: two 16-byte
//   broadcast reads per sample instead of eight scalar ones. The row buffer
//   is double-buffered, so one __syncthreads separates two rows of bins.
// - Several RoIs per block: 4 teams, 128 threads in bf16 and 256 in
//   float32 at C = 256 (4 came out a few per cent faster than 8 or 16 on
//   the card). Blocks walk one image's RoIs in order, so most of a bf16
//   image's level 0 (33.5 MB) stays in the 50 MB L2 while its RoIs are
//   pooled.
// - Evict-first output stores (st.global.cs): the output is written once
//   and never read here, so it should not push features out of L2.
// - Any C and any alignment: the vector path runs when C is a multiple of
//   the vector width and every level is 16-byte aligned (the wrapper
//   decides, ops/roi_align_kernels.py:vector_path, and this file checks);
//   otherwise the scalar path, the same code with one element per lane,
//   runs with the same arithmetic.
// The RoI's level is computed by the caller (so that log2 here cannot route
// a RoI differently from the plain version) and selects one of up to four
// base pointers carried by value. Padding RoIs write their zeros here: the
// output buffer is uninitialised. Offsets within an image's level are
// 32-bit (the wrapper requires (H + 2) * (W + 2) * C < 2^31); the rest are
// 64-bit.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit, B = 8, R = 2000, C = 256: 0.645 ms in bf16 and 1.294 ms in float32
// on synthetic RoIs (bounds 0.2226 / 0.4450 ms), 0.564 ms on an Oriented
// R-CNN request's proposals (bound 0.1937 ms). Both types now move the
// bytes their loads request at the same ~9 TB/s, so L1/L2 traffic limits
// it, not instructions; putting the RoIs in spatial order gained 3.5% on
// real proposals, too little for a sort per request.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kBinsSide = 7;
constexpr int kMaxRatio = 2;           // samples per bin side
// samples of one row of bins at the largest ratio: 2 rows of 14
constexpr int kMaxRowSamples = kMaxRatio * kBinsSide * kMaxRatio;
constexpr int kThreads = 256;
constexpr int kMaxTeams = 4;           // RoIs per block

struct Pyramid {
  const void* feat[kMaxLevels];  // (batch, h, w, channels), channels-last
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];       // feature cells per image pixel
};

// One RoI's sample-grid parameters and its level, shared by the block.
struct RoiGeometry {
  const void* feat;    // the level's (batch, fh, fw, channels) features
  float cx, cy, w, h, sn, cs, scale;
  int fw, fh;
};

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  // round to nearest even, as torch's cast
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// What one lane loads, accumulates and stores: kVec channels of type T.
template <typename T, int kVec>
struct Lane;

template <>
struct Lane<__nv_bfloat16, 8> {     // 16 bytes: 8 bf16 channels
  using Raw = uint4;
  __device__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void fma(float* acc, float w, const Raw& r) {
    acc[0] += w * bf16_lo(r.x); acc[1] += w * bf16_hi(r.x);
    acc[2] += w * bf16_lo(r.y); acc[3] += w * bf16_hi(r.y);
    acc[4] += w * bf16_lo(r.z); acc[5] += w * bf16_hi(r.z);
    acc[6] += w * bf16_lo(r.w); acc[7] += w * bf16_hi(r.w);
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                      pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7])));
  }
};

template <>
struct Lane<float, 4> {             // 16 bytes: 4 float32 channels
  using Raw = float4;
  __device__ static Raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static void fma(float* acc, float w, const Raw& r) {
    acc[0] += w * r.x; acc[1] += w * r.y;
    acc[2] += w * r.z; acc[3] += w * r.w;
  }
  __device__ static void store(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <>
struct Lane<__nv_bfloat16, 1> {     // scalar path, bf16
  using Raw = unsigned short;
  __device__ static Raw zero() { return 0; }
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ static void fma(float* acc, float w, const Raw& r) {
    acc[0] += w * __uint_as_float(static_cast<uint32_t>(r) << 16);
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    __stcs(reinterpret_cast<unsigned short*>(p),
           __bfloat16_as_ushort(__float2bfloat16_rn(v[0])));
  }
};

template <>
struct Lane<float, 1> {             // scalar path, float32
  using Raw = float;
  __device__ static Raw zero() { return 0.f; }
  __device__ static Raw load(const float* p) { return __ldg(p); }
  __device__ static void fma(float* acc, float w, const Raw& r) {
    acc[0] += w * r;
  }
  __device__ static void store(float* p, const float* v) { __stcs(p, v[0]); }
};

// Block: `teams` RoIs of one image (blockIdx.y), consecutive from
// blockIdx.x * teams, each pooled by a team of `team` threads; thread
// t belongs to team t / team. A lane walks the channel vectors
// lane, lane + team, ... < channels / kVec. kRatio samples per bin side.
template <typename T, int kVec, int kRatio>
__global__ void __launch_bounds__(kThreads, 2)
roi_align_rotated_kernel(Pyramid pyr, const float* __restrict__ rois,
                         const int* __restrict__ levels, T* __restrict__ out,
                         int num_rois, int channels, int team, int teams,
                         bool clockwise) {
  using L = Lane<T, kVec>;
  constexpr int kGrid = kBinsSide * kRatio;        // samples per side
  constexpr int kRowSamples = kRatio * kGrid;      // of one row of bins
  constexpr int kBinSamples = kRatio * kRatio;
  __shared__ RoiGeometry s_roi[kMaxTeams];
  __shared__ int4 s_cell[2][kMaxTeams][kMaxRowSamples];  // offsets, -1 masked
  __shared__ float4 s_wgt[2][kMaxTeams][kMaxRowSamples];

  const int tid = threadIdx.x;
  const int vecs = channels / kVec;
  const int first_roi = blockIdx.x * teams;
  const size_t image = blockIdx.y;

  // Each RoI's parameters and level, once per block.
  for (int k = tid; k < teams; k += blockDim.x) {
    const int r = first_roi + k;
    RoiGeometry g{};
    if (r < num_rois) {
      const float* roi = rois + (image * num_rois + r) * 5;
      const int lvl = levels[image * num_rois + r];
      g.cx = roi[0];
      g.cy = roi[1];
      g.w = roi[2];
      g.h = roi[3];
      sincosf(clockwise ? -roi[4] : roi[4], &g.sn, &g.cs);
      g.feat = pyr.feat[0];
      g.fw = pyr.w[0];
      g.fh = pyr.h[0];
      g.scale = pyr.scale[0];
#pragma unroll
      for (int l = 1; l < kMaxLevels; ++l) {
        if (lvl == l) {
          g.feat = pyr.feat[l];
          g.fw = pyr.w[l];
          g.fh = pyr.h[l];
          g.scale = pyr.scale[l];
        }
      }
    }
    s_roi[k] = g;
  }
  __syncthreads();

  // This thread's RoI, the base of its level for this image and its output.
  const int k = tid / team;
  const int lane = tid - k * team;
  const int roi_idx = first_roi + k;
  bool live = false;
  const T* base = nullptr;
  T* o = nullptr;
  if (k < teams && roi_idx < num_rois) {
    const RoiGeometry g = s_roi[k];
    live = g.w > 1e-3f && g.h > 1e-3f;
    base = static_cast<const T*>(g.feat) +
           image * static_cast<size_t>(g.fh) * g.fw * channels;
    o = out + (image * num_rois + roi_idx) *
              (static_cast<size_t>(kBinsSide * kBinsSide) * channels);
    if (!live) {                    // padding RoI: exact zeros
      float zeros[kVec] = {};
      for (int bin = 0; bin < kBinsSide * kBinsSide; ++bin) {
        for (int v = lane; v < vecs; v += team) {
          L::store(o + static_cast<size_t>(bin) * channels + v * kVec,
                   zeros);
        }
      }
    }
  }

  // Geometry of one row of bins (sample rows kRatio * by to
  // kRatio * by + kRatio - 1) of every RoI of the block into buffer `buf`:
  // corner offsets into the level (in elements, -1 when masked) and
  // bilinear weights.
  auto stage_row = [&](int by, int buf) {
    for (int i = tid; i < teams * kRowSamples; i += blockDim.x) {
      const int kk = i / kRowSamples;
      const int s = i - kk * kRowSamples;
      const RoiGeometry g = s_roi[kk];
      const int p = (kRatio * by + s / kGrid) * kGrid + s % kGrid;
      const float gx = (static_cast<float>(p % kGrid) + 0.5f) / kGrid - 0.5f;
      const float gy = (static_cast<float>(p / kGrid) + 0.5f) / kGrid - 0.5f;
      const float lx = gx * g.w, ly = gy * g.h;
      const float px = g.cx + lx * g.cs - ly * g.sn;
      const float py = g.cy + lx * g.sn + ly * g.cs;
      const float fx = px * g.scale - 0.5f;
      const float fy = py * g.scale - 0.5f;
      const float x0f = floorf(fx), y0f = floorf(fy);
      const float wx1 = fx - x0f, wy1 = fy - y0f;
      const float wx0 = 1.0f - wx1, wy0 = 1.0f - wy1;
      // every coordinate below -1 or above the last cell is masked for both
      // corners, so the clamp only keeps the conversion to int in range
      const int x0 = static_cast<int>(fminf(fmaxf(x0f, -2.0f),
                                            static_cast<float>(g.fw)));
      const int y0 = static_cast<int>(fminf(fmaxf(y0f, -2.0f),
                                            static_cast<float>(g.fh)));
      const bool xin0 = x0 >= 0 && x0 < g.fw;
      const bool xin1 = x0 + 1 >= 0 && x0 + 1 < g.fw;
      const bool yin0 = y0 >= 0 && y0 < g.fh;
      const bool yin1 = y0 + 1 >= 0 && y0 + 1 < g.fh;
      const int c00 = (y0 * g.fw + x0) * channels;
      const int row = g.fw * channels;
      s_cell[buf][kk][s] = make_int4(
          (xin0 && yin0) ? c00 : -1, (xin1 && yin0) ? c00 + channels : -1,
          (xin0 && yin1) ? c00 + row : -1,
          (xin1 && yin1) ? c00 + row + channels : -1);
      s_wgt[buf][kk][s] = make_float4(wx0 * wy0, wx1 * wy0, wx0 * wy1,
                                      wx1 * wy1);
    }
  };

  stage_row(0, 0);
  __syncthreads();
  for (int by = 0; by < kBinsSide; ++by) {
    const int buf = by & 1;
    if (by + 1 < kBinsSide) stage_row(by + 1, buf ^ 1);
    if (live) {
      for (int bx = 0; bx < kBinsSide; ++bx) {
        // the bin's samples x 4 corners: one 16-byte read of offsets and
        // one of weights per sample
        int q[kBinSamples];                  // the samples, in s_cell
        int4 cell[kBinSamples];
#pragma unroll
        for (int s = 0; s < kBinSamples; ++s) {
          q[s] = (s / kRatio) * kGrid + kRatio * bx + s % kRatio;
          cell[s] = s_cell[buf][k][q[s]];
        }
        T* ob = o + static_cast<size_t>(by * kBinsSide + bx) * channels;
        for (int v = lane; v < vecs; v += team) {
          const T* src = base + v * kVec;
          typename L::Raw raw[4 * kBinSamples];
#pragma unroll
          for (int s = 0; s < kBinSamples; ++s) {  // all loads in flight
            const int4 c = cell[s];
            raw[4 * s + 0] = c.x >= 0 ? L::load(src + c.x) : L::zero();
            raw[4 * s + 1] = c.y >= 0 ? L::load(src + c.y) : L::zero();
            raw[4 * s + 2] = c.z >= 0 ? L::load(src + c.z) : L::zero();
            raw[4 * s + 3] = c.w >= 0 ? L::load(src + c.w) : L::zero();
          }
          // a masked corner loaded zeros: adding its w * 0 leaves the sum
          float acc[kVec] = {};
#pragma unroll
          for (int s = 0; s < kBinSamples; ++s) {
            const float4 w = s_wgt[buf][k][q[s]];
            L::fma(acc, w.x, raw[4 * s + 0]);
            L::fma(acc, w.y, raw[4 * s + 1]);
            L::fma(acc, w.z, raw[4 * s + 2]);
            L::fma(acc, w.w, raw[4 * s + 3]);
          }
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[e] *= 1.0f / kBinSamples;
          L::store(ob + v * kVec, acc);
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, int kVec, int kRatio>
void launch(const Pyramid& pyr, const float* rois, const int* levels, T* out,
            int batch, int num_rois, int channels, bool clockwise,
            cudaStream_t stream) {
  const int vecs = channels / kVec;
  const int team = vecs < kThreads ? vecs : kThreads;
  int teams = kThreads / team;
  if (teams > kMaxTeams) teams = kMaxTeams;
  const int threads = ((teams * team + 31) / 32) * 32;
  const dim3 grid((num_rois + teams - 1) / teams, batch);
  roi_align_rotated_kernel<T, kVec, kRatio><<<grid, threads, 0, stream>>>(
      pyr, rois, levels, out, num_rois, channels, team, teams, clockwise);
}

template <typename T, int kVec>
void launch_ratio(int ratio, const Pyramid& pyr, const float* rois,
                  const int* levels, T* out, int batch, int num_rois,
                  int channels, bool clockwise, cudaStream_t stream) {
  if (ratio == 1) {
    launch<T, kVec, 1>(pyr, rois, levels, out, batch, num_rois, channels,
                       clockwise, stream);
  } else {
    launch<T, kVec, 2>(pyr, rois, levels, out, batch, num_rois, channels,
                       clockwise, stream);
  }
}

}  // namespace

// feats: `num_levels` (<= 4) device pointers to contiguous
// (batch, hs[l], ws[l], channels) tensors of one type (is_bf16: bfloat16,
// else float32); feats, hs, ws and scales are HOST arrays of num_levels
// entries. rois (batch, num_rois, 5) float32, levels (batch, num_rois) int32
// in [0, num_levels), out (batch, num_rois, 7, 7, channels) of the features'
// type, all contiguous on the current device. `vector`: take the 16-byte
// path, which needs channels a multiple of 16 bytes and every level and the
// output 16-byte aligned (checked here too: cudaErrorMisalignedAddress
// otherwise). `sampling_ratio`: 1 or 2 samples per bin side. Launches on
// `stream` without synchronising and returns cudaGetLastError() of the
// launch.
extern "C" int roi_align_rotated(const void* const* feats, const int* hs,
                                 const int* ws, const float* scales,
                                 int num_levels, const void* rois,
                                 const void* levels, void* out, int batch,
                                 int num_rois, int channels, int is_bf16,
                                 int vector, int clockwise,
                                 int sampling_ratio, void* stream) {
  if (batch == 0 || num_rois == 0 || channels == 0) return 0;
  if (num_levels < 1 || num_levels > kMaxLevels || batch > 65535 ||
      sampling_ratio < 1 || sampling_ratio > kMaxRatio) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Pyramid pyr;
  for (int l = 0; l < kMaxLevels; ++l) {
    const int src = l < num_levels ? l : 0;
    pyr.feat[l] = feats[src];
    pyr.h[l] = hs[src];
    pyr.w[l] = ws[src];
    pyr.scale[l] = scales[src];
    // corner offsets, masked ones included, stay within 32 bits
    if ((hs[src] + 2LL) * (ws[src] + 2LL) * channels >= INT_MAX) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int elt = is_bf16 ? 2 : 4;
  if (vector) {
    bool aligned = (channels * elt) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
    for (int l = 0; l < num_levels; ++l) {
      aligned = aligned && reinterpret_cast<uintptr_t>(feats[l]) % 16 == 0;
    }
    if (!aligned) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const float*>(rois);
  const auto* lv = static_cast<const int*>(levels);
  const bool cw = clockwise != 0;
  const int sr = sampling_ratio;
  if (is_bf16) {
    auto* o = static_cast<__nv_bfloat16*>(out);
    if (vector) {
      launch_ratio<__nv_bfloat16, 8>(sr, pyr, r, lv, o, batch, num_rois,
                                     channels, cw, s);
    } else {
      launch_ratio<__nv_bfloat16, 1>(sr, pyr, r, lv, o, batch, num_rois,
                                     channels, cw, s);
    }
  } else {
    auto* o = static_cast<float*>(out);
    if (vector) {
      launch_ratio<float, 4>(sr, pyr, r, lv, o, batch, num_rois, channels,
                             cw, s);
    } else {
      launch_ratio<float, 1>(sr, pyr, r, lv, o, batch, num_rois, channels,
                             cw, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
