// JPEG decoder and encoder on the host (C++17, no dependencies), bit-exact
// with libjpeg-turbo's default paths, which OpenCV's imread / imdecode /
// imwrite run for the JAX package.
//
// Decoder: SOF0 / SOF1 (baseline and extended Huffman), SOF2 (progressive:
// spectral selection, successive approximation, EOB runs), SOF9 / SOF10
// (arithmetic-coded sequential and progressive, jdarith.c's decoder and
// its DAC conditioning) with 8-bit samples, and SOF3 (lossless, Huffman:
// predictors 1-7 and the point transform, jdlossls.c's undifferencing) with
// samples of 2-8 bits; 1, 3 or 4 components, sampling factors 1-4 whose
// ratios to the largest are integral, DRI / RSTn restart intervals, byte
// stuffing and fill bytes. Reconstruction as libjpeg-turbo's defaults do it:
//   - jidctint.c's "islow" IDCT (CONST_BITS 13, PASS1_BITS 2) and its
//     range-limit table (0x3FF mask);
//   - jdsample.c's fancy upsampling: h2v1 (biases 1, 2) and h2v2 (biases
//     8, 7, the context rows replicated at the top and bottom) where the
//     downsampled width exceeds 2, libjpeg-turbo's h1v2 (biases 1, 2),
//     and plain replication otherwise;
//   - jdcolor.c's YCbCr -> RGB tables (SCALEBITS 16, ONE_HALF rounding) and
//     its YCCK -> CMYK conversion;
//   - libjpeg-turbo's colour-space guess: JFIF means YCbCr; an Adobe APP14
//     transform 0 means RGB (3 components) or CMYK (4), 1 YCbCr, 2 YCCK;
//     component ids 'R', 'G', 'B' mean RGB; other files YCbCr, CMYK with 4
//     components, and RGB when lossless (where libjpeg-turbo 3 converts no
//     colour space, so OpenCV reads neither grey, YCbCr nor YCCK lossless
//     files: they are refused as it refuses them).
// The output is (H, W, 3) BGR; grey is repeated to 3 channels, as OpenCV's
// IMREAD_COLOR does, and CMYK (the values as stored: Adobe's inverted CMYK)
// becomes BGR as OpenCV's icvCvt_CMYK2BGR_8u_C4C3R computes it. Missing
// Huffman tables default to the standard ones, as libjpeg-turbo's decoder
// does for Motion-JPEG frames. oodt_jpeg_decode_segment decodes a
// tables-only stream and then an abbreviated one (a TIFF file's JPEGTables
// and one strip or tile), converting YCbCr to RGB or no colour at all.
//
// Encoder: what cv2.imwrite(".jpg") writes with OpenCV's defaults, and
// nothing else: JFIF 1.01 APP0 (density 1:1, no thumbnail); quality 95
// through jpeg_quality_scaling with baseline clamping; the tables in
// zigzag order; jccolor.c's RGB -> YCbCr; jcsample.c's h2v2 downsampling
// (alternating bias 1, 2; right and bottom edges replicated to the MCU);
// jfdctint.c's islow FDCT; libjpeg-turbo's reciprocal quantization; the
// Annex K.3 Huffman tables; dummy blocks at the MCU edges as jccoefct.c
// makes them; EOI. Grey images are written as one component.
//
// Every read is checked against the buffer's length; a corrupt or
// truncated file gives an error message, never a crash. Hierarchical files
// (SOF5-7, SOF13-15, DHP, EXP), 12-bit DCT files, lossless files of more
// than 8 bits and lossless arithmetic-coded ones (SOF11) are refused as
// OpenCV refuses them (libjpeg-turbo has no hierarchical or lossless
// arithmetic decoder, and OpenCV reads 8-bit samples alone).
//
// A plain C ABI, loaded with ctypes (native.py builds it with rnms.cpp and
// tiff.cpp into one library). No global state is written: calls from
// several threads run in parallel.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

struct JpegError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError{msg}; }

// a form OpenCV returns no image for either
const char* const kNotRead = ": OpenCV does not read it either";

// jpeg_natural_order, padded with 63s for corrupt run lengths
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// T.81 Table D.2 as jaricom.c packs it: Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS; state 113 is the fixed probability 0.5
const int32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

// Annex K.3 (jstdhuff.c): code counts of lengths 1-16, then the symbols
const uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1,
                                1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[16] = {0, 3, 1, 1, 1, 1, 1, 1,
                                  1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3,
                                5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[16] = {0, 2, 1, 2, 4, 4, 3, 4,
                                  7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// jcparam.c's tables, natural order
const int kLumQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const int kQuality = 95;           // OpenCV's IMWRITE_JPEG_QUALITY default
const int64_t kMaxPixels = int64_t(1) << 30;   // OpenCV's image size limit

// jidctint.c / jfdctint.c constants, CONST_BITS 13
const int kConstBits = 13;
const int kPass1Bits = 2;
const int64_t FIX_0_298631336 = 2446;
const int64_t FIX_0_390180644 = 3196;
const int64_t FIX_0_541196100 = 4433;
const int64_t FIX_0_765366865 = 6270;
const int64_t FIX_0_899976223 = 7373;
const int64_t FIX_1_175875602 = 9633;
const int64_t FIX_1_501321110 = 12299;
const int64_t FIX_1_847759065 = 15137;
const int64_t FIX_1_961570560 = 16069;
const int64_t FIX_2_053119869 = 16819;
const int64_t FIX_2_562915447 = 20995;
const int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

inline int32_t descale(int32_t x, int n) {
  return (x + (int32_t(1) << (n - 1))) >> n;
}

// ---- tables built once ----------------------------------------------------
struct Tables {
  uint8_t idct_limit[1024];        // post-IDCT range limit, index & 0x3FF
  int cr_r[256], cb_b[256];        // jdcolor.c
  int32_t cr_g[256], cb_g[256];
  int32_t rgb_ycc[8 * 256];        // jccolor.c
  Tables() {
    for (int i = 0; i < 1024; i++) {
      // libjpeg's prepare_range_limit_table read at CENTERJSAMPLE + i
      int v;
      if (i < 128) v = 128 + i;
      else if (i < 512) v = 255;
      else if (i < 896) v = 0;
      else v = i - 896;
      idct_limit[i] = uint8_t(v);
    }
    const int64_t one_half = int64_t(1) << 15;
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = int((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = int((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = int32_t(-fix(0.71414) * x);
      cb_g[i] = int32_t(-fix(0.34414) * x + one_half);
    }
    const int32_t cbcr_offset = int32_t(128) << 16;
    for (int i = 0; i < 256; i++) {
      // R, G, B -> Y; R, G, B -> Cb; G, B -> Cr (R -> Cr is B -> Cb:
      // 0.5 with a rounding of 0.5 - epsilon)
      int32_t* tab = rgb_ycc;
      tab[0 * 256 + i] = int32_t(fix(0.29900) * i);
      tab[1 * 256 + i] = int32_t(fix(0.58700) * i);
      tab[2 * 256 + i] = int32_t(fix(0.11400) * i + one_half);
      tab[3 * 256 + i] = int32_t(-fix(0.16874) * i);
      tab[4 * 256 + i] = int32_t(-fix(0.33126) * i);
      tab[5 * 256 + i] = int32_t(fix(0.50000) * i + cbcr_offset + one_half - 1);
      tab[6 * 256 + i] = int32_t(-fix(0.41869) * i);
      tab[7 * 256 + i] = int32_t(-fix(0.08131) * i);
    }
  }
};

const Tables& tables() {
  static const Tables t;           // initialised once, thread-safe
  return t;
}

inline uint8_t clamp255(int v) {
  return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ---- Huffman decoding -----------------------------------------------------
struct HuffDecoder {
  bool defined = false;
  uint8_t fast_len[512];           // 9-bit lookahead: length, 0 if longer
  uint8_t fast_val[512];
  // an AC table's 9-bit lookahead where the code and its value bits fit:
  // value * 256 + run * 16 + bits used, else 0
  int32_t fast_ac[512];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  int max_val = 0;                 // a DC table's largest symbol
};

void build_decoder(HuffDecoder& h, const uint8_t* bits, const uint8_t* vals,
                   int n, bool dc) {
  if (n > 256) fail("bad Huffman table (more than 256 codes)");
  // a DC symbol over 15 (16 in a lossless scan) is refused where a scan
  // uses the table, as libjpeg checks it
  h.max_val = 0;
  for (int i = 0; i < n; i++) h.max_val = std::max(h.max_val, int(vals[i]));
  std::memcpy(h.vals, vals, size_t(n));
  std::memset(h.fast_len, 0, sizeof(h.fast_len));
  int32_t code = 0;
  int k = 0;
  for (int len = 1; len <= 16; len++) {
    int count = bits[len - 1];
    // libjpeg's rule: the codes of a length fit in it, and none is all ones
    if (count && code + count >= (1 << len))
      fail("bad Huffman table (codes overflow)");
    if (count) {
      h.valoffset[len] = k - code;
      for (int i = 0; i < count; i++, k++, code++) {
        if (len <= 9) {
          int shift = 9 - len;
          for (int j = 0; j < (1 << shift); j++) {
            h.fast_len[(code << shift) | j] = uint8_t(len);
            h.fast_val[(code << shift) | j] = vals[k];
          }
        }
      }
      h.maxcode[len] = code - 1;
    } else {
      h.maxcode[len] = -1;
    }
    code <<= 1;
  }
  h.maxcode[17] = 0x7FFFFFFF;
  for (int i = 0; i < 512; i++) {
    h.fast_ac[i] = 0;
    int len = h.fast_len[i], rs = h.fast_val[i];
    int size = rs & 15;
    if (dc || !len || !size || len + size > 9) continue;
    int bits = (i >> (9 - len - size)) & ((1 << size) - 1);
    int value = (size && bits < (1 << (size - 1))) ?
        bits - (1 << size) + 1 : bits;
    h.fast_ac[i] = value * 256 + (rs >> 4) * 16 + len + size;
  }
  h.defined = true;
}

// The entropy-coded bits of a scan: MSB-aligned 64-bit accumulator. At a
// marker or the end of the data it feeds zero bits and counts them; a
// block that consumes one of them is truncated data.
struct BitReader {
  const uint8_t* data;
  size_t len;
  size_t pos;
  uint64_t acc = 0;
  int nbits = 0;
  int fake = 0;
  bool at_marker = false;

  void fill() {
    while (nbits <= 56) {
      uint64_t b = 0;
      if (!at_marker && pos < len) {
        b = data[pos];
        if (b == 0xFF) {
          size_t q = pos + 1;
          while (q < len && data[q] == 0xFF) q++;     // fill bytes
          if (q < len && data[q] == 0x00) {
            pos = q + 1;                              // stuffed 0xFF
          } else {
            at_marker = true;                         // stay on the 0xFF
            b = 0;
            fake += 8;
          }
        } else {
          pos++;
        }
      } else {
        fake += 8;
      }
      acc |= b << (56 - nbits);
      nbits += 8;
    }
  }

  inline uint32_t peek16() {
    if (nbits < 16) fill();
    return uint32_t(acc >> 48);
  }

  inline void skip(int n) {
    acc <<= n;
    nbits -= n;
  }

  inline int get(int n) {          // n <= 16
    if (n == 0) return 0;
    if (nbits < n) fill();
    int v = int(acc >> (64 - n));
    acc <<= n;
    nbits -= n;
    return v;
  }

  void check() const {
    if (nbits < fake) fail("truncated or corrupt entropy-coded data");
  }

  // a restart: drop the bits left, then expect RSTn
  void restart(int expected) {
    acc = 0;
    nbits = 0;
    fake = 0;
    at_marker = false;
    while (pos < len && data[pos] != 0xFF) pos++;
    while (pos < len && data[pos] == 0xFF) pos++;
    if (pos >= len) fail("truncated data: a restart marker is missing");
    if (data[pos] != 0xD0 + expected)
      fail("corrupt data: restart marker out of order");
    pos++;
  }

  inline int decode(const HuffDecoder& h) {
    uint32_t look = peek16();
    int fast = int(look >> 7);
    int len = h.fast_len[fast];
    if (len) {
      skip(len);
      return h.fast_val[fast];
    }
    for (len = 10; len <= 16; len++) {
      int32_t code = int32_t(look >> (16 - len));
      if (code <= h.maxcode[len]) {
        skip(len);
        return h.vals[h.valoffset[len] + code];
      }
    }
    fail("corrupt data: bad Huffman code");
  }
};

// jdarith.c's decoder: the C and A registers and T.81's statistics bins.
// At a marker it feeds zero bytes, as the standard has it; running past the
// end of the data is truncation.
struct ArithReader {
  const uint8_t* data;
  size_t len;
  size_t pos;
  int64_t c = 0, a = 0;
  int ct = -16;
  bool at_marker = false;

  void start() {
    c = 0;
    a = 0;
    ct = -16;                      // two bytes are read first
  }

  int byte() {
    if (pos >= len) fail("truncated arithmetic-coded data");
    return data[pos++];
  }

  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int d = 0;
        if (!at_marker) {
          size_t ff = pos;
          d = byte();
          if (d == 0xFF) {
            do d = byte();
            while (d == 0xFF);
            if (d == 0) {
              d = 0xFF;                               // a stuffed zero
            } else {
              at_marker = true;                       // stay on the 0xFF
              pos = ff;
              d = 0;
            }
          }
        }
        c = (c << 8) | d;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    int nl = int(qe & 0xFF);
    qe >>= 8;
    int nm = int(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {                                   // MPS after exchange
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {                                        // LPS
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {                                   // LPS after exchange
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // a restart: find RSTn (the data before it is dropped), then start over
  void restart(int expected) {
    at_marker = false;
    while (pos < len && data[pos] != 0xFF) pos++;
    while (pos < len && data[pos] == 0xFF) pos++;
    if (pos >= len) fail("truncated data: a restart marker is missing");
    if (data[pos] != 0xD0 + expected)
      fail("corrupt data: restart marker out of order");
    pos++;
    start();
  }
};

inline int extend(int v, int s) {
  return (s && v < (1 << (s - 1))) ? v - (1 << s) + 1 : v;
}

// the DC predictor's sum, wrapping as libjpeg's int does in practice (a
// corrupt file can run it past 32 bits)
inline int wrap_add(int a, int b) {
  return int(uint32_t(a) + uint32_t(b));
}

// ---- the decoder -----------------------------------------------------------
struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;              // downsampled size
  int nbw = 0, nbh = 0;            // blocks a non-interleaved scan covers
  int bw = 0, bh = 0;              // blocks stored (MCU-padded)
  int16_t* coefs = nullptr;
  uint16_t* samples = nullptr;     // lossless: undifferenced, dw x dh
  bool quant_latched = false;
  uint16_t quant[64];
  int dc_tbl = 0, ac_tbl = 0;
  int pred = 0;
  int dc_context = 0;              // arithmetic DC conditioning
  int pt = 0;                      // lossless point transform
};

enum Space { kGrey, kYcc, kRgb, kCmyk, kYcck };

struct Decoder {
  const uint8_t* data;
  size_t len;
  size_t pos = 0;
  bool frame = false, progressive = false, any_scan = false;
  bool lossless = false, arith = false;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int precision = 8;
  int width = 0, height = 0, ncomp = 0, maxh = 1, maxv = 1;
  int mcux = 0, mcuy = 0;
  int restart_interval = 0;
  Component comp[4];
  bool quant_defined[4] = {false, false, false, false};
  uint16_t quant[4][64];
  HuffDecoder dc[4], ac[4];
  // arithmetic conditioning (DAC; SOI's defaults) and statistics bins
  // (16 tables each, as libjpeg numbers them)
  int dc_l[16], dc_u[16], ac_k[16];
  uint8_t dc_stats[4][64], ac_stats[4][256];
  uint8_t fixed_bin = 113;

  Decoder(const uint8_t* d, size_t n) : data(d), len(n) {
    build_decoder(dc[0], kDcLumBits, kDcVals, 12, true);
    build_decoder(dc[1], kDcChromBits, kDcVals, 12, true);
    build_decoder(ac[0], kAcLumBits, kAcLumVals, 162, false);
    build_decoder(ac[1], kAcChromBits, kAcChromVals, 162, false);
    for (int i = 0; i < 16; i++) {
      dc_l[i] = 0;
      dc_u[i] = 1;
      ac_k[i] = 5;
    }
  }
  ~Decoder() {
    for (auto& c : comp) {
      std::free(c.coefs);
      std::free(c.samples);
    }
  }
  Decoder(const Decoder&) = delete;
  Decoder& operator=(const Decoder&) = delete;

  int byte() {
    if (pos >= len) fail("truncated file");
    return data[pos++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  // the next marker code; bytes before it that are not 0xFF are skipped
  int next_marker() {
    for (;;) {
      while (pos < len && data[pos] != 0xFF) pos++;
      while (pos < len && data[pos] == 0xFF) pos++;
      if (pos >= len) fail("truncated file: it ends before its EOI marker");
      int m = data[pos++];
      if (m != 0) return m;              // 0xFF 0x00 is stuffed data
    }
  }

  // a segment's body: [start, end)
  size_t segment(size_t* end) {
    int n = word();
    if (n < 2 || pos + size_t(n - 2) > len) fail("truncated marker segment");
    *end = pos + size_t(n - 2);
    return pos;
  }

  void refuse_marker(int m) {
    if (m >= 0xC5 && m <= 0xC7)
      fail("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) + ")" +
           kNotRead);
    if (m == 0xCB)
      fail(std::string("lossless arithmetic-coded JPEG (SOF11)") + kNotRead);
    if (m >= 0xCD && m <= 0xCF)
      fail("hierarchical arithmetic-coded JPEG (SOF" +
           std::to_string(m - 0xC0) + ")" + kNotRead);
    if (m == 0xDE || m == 0xDF)
      fail(std::string("hierarchical JPEG (") +
           (m == 0xDE ? "DHP" : "EXP") + ")" + kNotRead);
  }

  static bool is_frame(int m) {
    return m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3 || m == 0xC9 ||
           m == 0xCA;
  }

  // a frame header's precision, size and components, checked (the
  // segment's body up to the components)
  void frame_header(int m, size_t* end) {
    segment(end);
    precision = byte();
    height = word();
    width = word();
    ncomp = byte();
    lossless = m == 0xC3;
    if (!lossless && precision == 12)
      fail(std::string("12-bit JPEG") + kNotRead);
    if (lossless && precision > 8 && precision <= 16)
      fail("lossless JPEG of " + std::to_string(precision) + "-bit samples" +
           kNotRead);
    if (lossless ? precision < 2 || precision > 16 : precision != 8)
      fail("corrupt file: " + std::to_string(precision) + "-bit samples");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      fail("JPEG of " + std::to_string(ncomp) + " components is not read");
    if (height == 0)
      fail("JPEG whose height comes in a DNL marker is not read");
    if (width == 0) fail("corrupt file: zero width");
    if (int64_t(width) * height > kMaxPixels)
      fail("image of " + std::to_string(width) + " x " +
           std::to_string(height) + " pixels exceeds 2^30");
  }

  void read_frame(int m) {
    if (frame) fail("corrupt file: a second frame header");
    size_t end;
    frame_header(m, &end);
    if (pos + size_t(3 * ncomp) > end)
      fail("truncated frame header");
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("corrupt frame header: sampling factors or table index");
      if (c.h > maxh) maxh = c.h;
      if (c.v > maxv) maxv = c.v;
    }
    pos = end;
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      if (maxh % c.h || maxv % c.v)
        fail("fractional sampling factors are not read");
    }
    mcux = (width + 8 * maxh - 1) / (8 * maxh);
    mcuy = (height + 8 * maxv - 1) / (8 * maxv);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.dw = int((int64_t(width) * c.h + maxh - 1) / maxh);
      c.dh = int((int64_t(height) * c.v + maxv - 1) / maxv);
      c.nbw = (c.dw + 7) / 8;
      c.nbh = (c.dh + 7) / 8;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      // calloc: pages a truncated file never reaches are never touched
      if (lossless) {
        if (c.h != maxh || c.v != maxv)
          fail("lossless JPEG with subsampled components (ROADMAP A.4d)");
        c.samples = static_cast<uint16_t*>(
            std::calloc(size_t(c.dw) * size_t(c.dh), sizeof(uint16_t)));
        if (!c.samples) fail("out of memory");
      } else {
        c.coefs = static_cast<int16_t*>(
            std::calloc(size_t(c.bw) * size_t(c.bh) * 64, sizeof(int16_t)));
        if (!c.coefs) fail("out of memory");
      }
    }
    progressive = m == 0xC2 || m == 0xCA;
    arith = m == 0xC9 || m == 0xCA;
    frame = true;
  }

  void read_dqt() {
    size_t end;
    segment(&end);
    while (pos < end) {
      int pt = byte();
      int pq = pt >> 4, tq = pt & 15;
      if (tq > 3 || pq > 1) fail("corrupt quantization table");
      if (pos + size_t(pq ? 128 : 64) > end)
        fail("truncated quantization table");
      for (int i = 0; i < 64; i++)
        quant[tq][kNatural[i]] = uint16_t(pq ? word() : byte());
      quant_defined[tq] = true;
    }
    pos = end;
  }

  void read_dht() {
    size_t end;
    segment(&end);
    while (pos < end) {
      int tc = byte();
      int cls = tc >> 4, th = tc & 15;
      if (cls > 1 || th > 3) fail("corrupt Huffman table index");
      if (pos + 16 > end) fail("truncated Huffman table");
      uint8_t bits[16];
      int n = 0;
      for (int i = 0; i < 16; i++) {
        bits[i] = uint8_t(byte());
        n += bits[i];
      }
      if (n > 256 || pos + size_t(n) > end) fail("truncated Huffman table");
      build_decoder(cls ? ac[th] : dc[th], bits, data + pos, n, cls == 0);
      pos += size_t(n);
    }
    pos = end;
  }

  void read_dac() {
    size_t end;
    segment(&end);
    while (pos + 2 <= end) {
      int index = byte(), val = byte();
      if (index >= 32) fail("corrupt DAC segment (table index)");
      if (index >= 16) {
        ac_k[index - 16] = val;
      } else {
        dc_l[index] = val & 15;
        dc_u[index] = val >> 4;
        if (dc_l[index] > dc_u[index]) fail("corrupt DAC segment (bounds)");
      }
    }
    pos = end;
  }

  void read_app(int m) {
    size_t end;
    size_t start = segment(&end);
    size_t n = end - start;
    const uint8_t* p = data + start;
    if (m == 0xE0 && n >= 14 && std::memcmp(p, "JFIF\0", 5) == 0)
      jfif = true;
    if (m == 0xEE && n >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = p[11];
    }
    pos = end;
  }

  void read_scan() {
    if (!frame) fail("corrupt file: a scan before the frame header");
    size_t end;
    segment(&end);
    int ns = byte();
    if (ns < 1 || ns > ncomp || pos + size_t(2 * ns + 3) > end)
      fail("corrupt scan header");
    Component* sc[4];
    for (int i = 0; i < ns; i++) {
      int id = byte();
      int t = byte();
      Component* c = nullptr;
      for (int k = 0; k < ncomp; k++)
        if (comp[k].id == id) c = &comp[k];
      if (!c) fail("corrupt scan header: unknown component");
      for (int k = 0; k < i; k++)
        if (sc[k] == c) fail("corrupt scan header: a component twice");
      c->dc_tbl = t >> 4;
      c->ac_tbl = t & 15;
      if (c->dc_tbl > 3 || c->ac_tbl > 3)
        fail("corrupt scan header: table index");
      sc[i] = c;
    }
    int ss = byte(), se = byte(), a = byte();
    int ah = a >> 4, al = a & 15;
    pos = end;
    if (lossless) {
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= precision)
        fail("corrupt lossless scan parameters");
      for (int i = 0; i < ns; i++) {
        const HuffDecoder& h = dc[sc[i]->dc_tbl];
        if (!h.defined) fail("a Huffman table the scan needs is not defined");
        if (h.max_val > 16) fail("bad Huffman table (DC symbol over 16)");
        sc[i]->pt = al;
      }
      lossless_scan(sc, ns, ss, al);
      any_scan = true;
      return;
    }
    if (progressive) {
      bool bad = false;
      if (ss == 0) {
        if (se != 0) bad = true;
      } else if (ss > se || se > 63 || ns != 1) {
        bad = true;
      }
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) fail("corrupt progressive scan parameters");
    } else {
      ss = 0;
      se = 63;
      ah = al = 0;
    }
    // tables the scan needs, and the quantization tables latched
    for (int i = 0; i < ns; i++) {
      Component* c = sc[i];
      if (!arith && ss == 0 && ah == 0) {
        if (!dc[c->dc_tbl].defined)
          fail("a Huffman table the scan needs is not defined");
        if (dc[c->dc_tbl].max_val > 15)
          fail("bad Huffman table (DC symbol over 15)");
      }
      if (!arith && se > 0 && !ac[c->ac_tbl].defined)
        fail("a Huffman table the scan needs is not defined");
      if (!c->quant_latched) {
        if (!quant_defined[c->tq])
          fail("a quantization table is not defined");
        std::memcpy(c->quant, quant[c->tq], sizeof(c->quant));
        c->quant_latched = true;
      }
      c->pred = 0;
    }
    if (arith) {
      arith_scan(sc, ns, ss, se, ah, al);
      any_scan = true;
      return;
    }
    BitReader br{data, len, pos};
    int eobrun = 0;
    int restarts = 0;
    auto block = [&](Component* c, int16_t* coef) {
      if (!progressive) {
        decode_baseline(br, *c, coef);
      } else if (ss == 0) {
        if (ah == 0) {
          int s = br.decode(dc[c->dc_tbl]);
          c->pred = wrap_add(c->pred, extend(br.get(s), s));
          coef[0] = int16_t(uint32_t(c->pred) << al);
        } else if (br.get(1)) {
          coef[0] = int16_t(coef[0] | (1 << al));
        }
      } else if (ah == 0) {
        ac_first(br, ac[c->ac_tbl], coef, ss, se, al, eobrun);
      } else {
        ac_refine(br, ac[c->ac_tbl], coef, ss, se, al, eobrun);
      }
      br.check();
    };
    auto restart = [&](int64_t index) {
      if (restart_interval && index > 0 && index % restart_interval == 0) {
        br.restart(restarts & 7);
        restarts++;
        eobrun = 0;
        for (int i = 0; i < ns; i++) sc[i]->pred = 0;
      }
    };
    scan_blocks(sc, ns, restart, block);
    pos = br.pos;
    any_scan = true;
  }

  // a scan's blocks in order: a component's blocks row by row, or the
  // MCUs of several, restart(index) before each
  template <class Restart, class Block>
  void scan_blocks(Component** sc, int ns, Restart& restart, Block& block) {
    if (ns == 1) {
      Component* c = sc[0];
      int64_t index = 0;
      for (int by = 0; by < c->nbh; by++)
        for (int bx = 0; bx < c->nbw; bx++, index++) {
          restart(index);
          block(c, c->coefs + (size_t(by) * c->bw + bx) * 64);
        }
    } else {
      int64_t index = 0;
      for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++, index++) {
          restart(index);
          for (int i = 0; i < ns; i++) {
            Component* c = sc[i];
            for (int y = 0; y < c->v; y++)
              for (int x = 0; x < c->h; x++) {
                size_t by = size_t(my) * c->v + y, bx = size_t(mx) * c->h + x;
                block(c, c->coefs + (by * c->bw + bx) * 64);
              }
          }
        }
    }
  }

  // ---- arithmetic decoding (jdarith.c) ----
  void arith_scan(Component** sc, int ns, int ss, int se, int ah, int al) {
    ArithReader ar{data, len, pos};
    auto reset = [&]() {           // start_pass / process_restart
      for (int i = 0; i < ns; i++) {
        Component* c = sc[i];
        if (!progressive || (ss == 0 && ah == 0)) {
          std::memset(dc_stats[c->dc_tbl], 0, sizeof(dc_stats[0]));
          c->pred = 0;
          c->dc_context = 0;
        }
        if (!progressive || ss)
          std::memset(ac_stats[c->ac_tbl], 0, sizeof(ac_stats[0]));
      }
    };
    reset();
    ar.start();
    int restarts = 0;
    auto restart = [&](int64_t index) {
      if (restart_interval && index > 0 && index % restart_interval == 0) {
        ar.restart(restarts & 7);
        restarts++;
        reset();
      }
    };
    auto block = [&](Component* c, int16_t* coef) {
      if (!progressive) {
        arith_dc(ar, *c, coef, 0);
        arith_ac_first(ar, *c, coef, 1, 63, 0);
      } else if (ss == 0) {
        if (ah == 0) arith_dc(ar, *c, coef, al);
        else if (ar.decode(&fixed_bin)) coef[0] = int16_t(coef[0] | (1 << al));
      } else if (ah == 0) {
        arith_ac_first(ar, *c, coef, ss, se, al);
      } else {
        arith_ac_refine(ar, *c, coef, ss, se, al);
      }
    };
    scan_blocks(sc, ns, restart, block);
    pos = ar.pos;
  }

  void arith_dc(ArithReader& ar, Component& c, int16_t* coef, int al) {
    const int tbl = c.dc_tbl;
    uint8_t* st = dc_stats[tbl] + c.dc_context;
    if (ar.decode(st) == 0) {
      c.dc_context = 0;
    } else {
      int sign = ar.decode(st + 1);
      st += 2 + sign;
      int m = ar.decode(st);
      if (m != 0) {
        st = dc_stats[tbl] + 20;
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000)
            fail("corrupt arithmetic-coded data (DC magnitude)");
          st += 1;
        }
      }
      if (m < ((1 << dc_l[tbl]) >> 1)) c.dc_context = 0;
      else if (m > ((1 << dc_u[tbl]) >> 1)) c.dc_context = 12 + sign * 4;
      else c.dc_context = 4 + sign * 4;
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      c.pred = (c.pred + v) & 0xFFFF;
    }
    coef[0] = int16_t(uint32_t(c.pred) << al);
  }

  void arith_ac_first(ArithReader& ar, Component& c, int16_t* coef, int ss,
                      int se, int al) {
    const int tbl = c.ac_tbl;
    for (int k = ss; k <= se; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (ar.decode(st)) break;                      // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) fail("corrupt arithmetic-coded data (spectral "
                           "overflow)");
      }
      int sign = ar.decode(&fixed_bin);
      st += 2;
      int m = ar.decode(st);
      if (m != 0 && ar.decode(st)) {
        m <<= 1;
        st = ac_stats[tbl] + (k <= ac_k[tbl] ? 189 : 217);
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000)
            fail("corrupt arithmetic-coded data (AC magnitude)");
          st += 1;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      coef[kNatural[k]] = int16_t(uint32_t(v) << al);
    }
  }

  void arith_ac_refine(ArithReader& ar, Component& c, int16_t* coef, int ss,
                       int se, int al) {
    const int tbl = c.ac_tbl;
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int kex = se;
    for (; kex > 0; kex--)
      if (coef[kNatural[kex]]) break;
    for (int k = ss; k <= se; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;           // EOB
      for (;;) {
        int16_t& co = coef[kNatural[k]];
        if (co) {                                    // previously nonzero
          if (ar.decode(st + 2)) co = int16_t(co < 0 ? co + m1 : co + p1);
          break;
        }
        if (ar.decode(st + 1)) {                     // newly nonzero
          co = int16_t(ar.decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) fail("corrupt arithmetic-coded data (spectral "
                           "overflow)");
      }
    }
  }

  // ---- lossless decoding (jdlhuff.c, jdlossls.c) ----
  // The first row after the start or a restart predicts from the left (its
  // first sample from 2^(P - Pt - 1)); a row's first sample from above; the
  // rest by predictor psv. Sums wrap at 16 bits.
  void lossless_scan(Component** sc, int ns, int psv, int pt) {
    const int w = width, h = height;
    if (restart_interval && restart_interval % w)
      fail("lossless JPEG whose restart interval is not whole rows is not "
           "read");
    const int rows_per_restart = restart_interval ? restart_interval / w : 0;
    BitReader br{data, len, pos};
    int restarts = 0;
    for (int y = 0; y < h; y++) {
      bool first = y == 0 || (rows_per_restart && y % rows_per_restart == 0);
      if (first && y > 0) {
        br.restart(restarts & 7);
        restarts++;
      }
      for (int x = 0; x < w; x++)
        for (int i = 0; i < ns; i++) {
          Component* c = sc[i];
          int s = br.decode(dc[c->dc_tbl]);
          int diff = s == 16 ? 32768 : extend(br.get(s), s);
          br.check();
          uint16_t* row = c->samples + size_t(y) * size_t(w);
          const uint16_t* up = row - w;
          int pred;
          if (first) {
            pred = x == 0 ? 1 << (precision - pt - 1) : row[x - 1];
          } else if (x == 0) {
            pred = up[0];
          } else {
            int ra = row[x - 1], rb = up[x], rc = up[x - 1];
            switch (psv) {
              case 1: pred = ra; break;
              case 2: pred = rb; break;
              case 3: pred = rc; break;
              case 4: pred = ra + rb - rc; break;
              case 5: pred = ra + ((rb - rc) >> 1); break;
              case 6: pred = rb + ((ra - rc) >> 1); break;
              default: pred = (ra + rb) >> 1; break;
            }
          }
          row[x] = uint16_t((diff + pred) & 0xFFFF);
        }
    }
    pos = br.pos;
  }

  void decode_baseline(BitReader& br, Component& c, int16_t* coef) {
    const HuffDecoder& dct = dc[c.dc_tbl];
    const HuffDecoder& act = ac[c.ac_tbl];
    int s = br.decode(dct);
    c.pred = wrap_add(c.pred, extend(br.get(s), s));
    coef[0] = int16_t(c.pred);
    for (int k = 1; k < 64; k++) {
      int32_t fast = act.fast_ac[br.peek16() >> 7];
      if (fast) {                  // the code and its value in 9 bits
        br.skip(fast & 15);
        k += (fast >> 4) & 15;
        coef[kNatural[k]] = int16_t((fast - (fast & 255)) / 256);
        continue;
      }
      int rs = br.decode(act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        coef[kNatural[k]] = int16_t(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  static void ac_first(BitReader& br, const HuffDecoder& h, int16_t* coef,
                       int ss, int se, int al, int& eobrun) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    for (int k = ss; k <= se; k++) {
      int rs = br.decode(h);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        coef[kNatural[k]] = int16_t(extend(br.get(s), s) * (1 << al));
      } else {
        if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          eobrun--;
          break;
        }
      }
    }
  }

  static void ac_refine(BitReader& br, const HuffDecoder& h, int16_t* coef,
                        int ss, int se, int al, int& eobrun) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    auto correct = [&](int16_t& c) {
      if (br.get(1) && (c & p1) == 0)
        c = int16_t(c >= 0 ? c + p1 : c + m1);
    };
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = br.decode(h);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;     // s != 1 is a corrupt file; as libjpeg
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t& c = coef[kNatural[k]];
          if (c != 0) {
            correct(c);
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= se);
        if (s) coef[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t& c = coef[kNatural[k]];
        if (c != 0) correct(c);
      }
      eobrun--;
    }
  }

  void parse() {
    if (len < 3 || data[0] != 0xFF || data[1] != 0xD8)
      fail("not a JPEG file");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;                          // EOI
      refuse_marker(m);
      size_t end;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC9: case 0xCA:
          read_frame(m);
          break;
        case 0xC4:
          read_dht();
          break;
        case 0xCC:
          read_dac();
          break;
        case 0xDB:
          read_dqt();
          break;
        case 0xDD:
          segment(&end);
          if (end - pos < 2) fail("truncated DRI segment");
          restart_interval = word();
          pos = end;
          break;
        case 0xDA:
          read_scan();
          break;
        case 0xD8: case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4:
        case 0xD5: case 0xD6: case 0xD7: case 0x01:
          break;                                     // no segment
        default:
          if (m >= 0xE0 && m <= 0xEF) {
            read_app(m);
          } else {
            segment(&end);
            pos = end;
          }
      }
    }
    if (!frame || !any_scan) fail("corrupt file: no image data");
  }

  // header only: the frame's size, and refusals met up to it
  void parse_size() {
    if (len < 3 || data[0] != 0xFF || data[1] != 0xD8)
      fail("not a JPEG file");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) fail("corrupt file: no frame header");
      refuse_marker(m);
      if (is_frame(m)) {
        size_t end;
        frame_header(m, &end);
        if (pos + size_t(3 * ncomp) > end) fail("truncated frame header");
        for (int i = 0; i < ncomp; i++) {
          comp[i].id = byte();
          pos += 2;
        }
        check_output(0);
        return;
      }
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      if (m >= 0xE0 && m <= 0xEF) {
        read_app(m);
        continue;
      }
      size_t end;
      segment(&end);
      pos = end;
    }
  }

  // a tables-only stream (a TIFF file's JPEGTables): SOI, tables, EOI
  void parse_tables() {
    if (len < 3 || data[0] != 0xFF || data[1] != 0xD8)
      fail("JPEGTables is not a JPEG stream");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) return;
      if (is_frame(m) || m == 0xDA) fail("JPEGTables holds image data");
      size_t end;
      switch (m) {
        case 0xC4: read_dht(); break;
        case 0xDB: read_dqt(); break;
        case 0xCC: read_dac(); break;
        case 0xDD:
          segment(&end);
          if (end - pos < 2) fail("truncated DRI segment");
          restart_interval = word();
          pos = end;
          break;
        case 0xD8: case 0x01: break;
        default:
          refuse_marker(m);
          if (m >= 0xD0 && m <= 0xD7) break;
          segment(&end);
          pos = end;
      }
    }
  }

  // libjpeg-turbo's colour-space guess (jdapimin.c)
  Space space() const {
    if (ncomp == 1) return kGrey;
    if (ncomp == 3) {
      if (jfif) return kYcc;
      if (adobe) return adobe_transform == 0 ? kRgb : kYcc;
      if (comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B')
        return kRgb;
      return lossless ? kRgb : kYcc;
    }
    if (adobe) return adobe_transform == 0 ? kCmyk : kYcck;
    return kCmyk;
  }

  // kind 0: OpenCV's BGR; 1: YCbCr converted to RGB; 2: the components
  // as decoded. libjpeg-turbo 3 converts no colour space of a lossless
  // file (OpenCV's IMREAD_COLOR then gets no image).
  void check_output(int kind) const {
    if (kind == 1 && ncomp != 3) fail("YCbCr JPEG of other than 3 components");
    if (!lossless) return;
    Space sp = kind == 1 ? kYcc : space();
    if (kind != 2 && (sp == kGrey || sp == kYcc || sp == kYcck))
      fail(std::string("lossless ") +
           (sp == kGrey ? "grey" : sp == kYcc ? "YCbCr" : "YCCK") +
           " JPEG read in colour" + kNotRead);
  }

  // ---- reconstruction ----
  void idct_block(const int16_t* in, const uint16_t* q, uint8_t* out,
                  size_t stride) {
    const uint8_t* limit = tables().idct_limit;
    int ws[64];
    for (int col = 0; col < 8; col++) {
      const int16_t* ip = in + col;
      const uint16_t* qp = q + col;
      int* wp = ws + col;
      if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
          ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
        int dcval = int(ip[0]) * int(qp[0]) * (1 << kPass1Bits);
        for (int i = 0; i < 8; i++) wp[8 * i] = dcval;
        continue;
      }
      int64_t z2 = int64_t(ip[16]) * qp[16];
      int64_t z3 = int64_t(ip[48]) * qp[48];
      int64_t z1 = (z2 + z3) * FIX_0_541196100;
      int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
      int64_t tmp3 = z1 + z2 * FIX_0_765366865;
      z2 = int64_t(ip[0]) * qp[0];
      z3 = int64_t(ip[32]) * qp[32];
      int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
      int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = int64_t(ip[56]) * qp[56];
      tmp1 = int64_t(ip[40]) * qp[40];
      tmp2 = int64_t(ip[24]) * qp[24];
      tmp3 = int64_t(ip[8]) * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp0 *= FIX_0_298631336;
      tmp1 *= FIX_2_053119869;
      tmp2 *= FIX_3_072711026;
      tmp3 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = kConstBits - kPass1Bits;
      wp[0] = int(descale(tmp10 + tmp3, sh));
      wp[56] = int(descale(tmp10 - tmp3, sh));
      wp[8] = int(descale(tmp11 + tmp2, sh));
      wp[48] = int(descale(tmp11 - tmp2, sh));
      wp[16] = int(descale(tmp12 + tmp1, sh));
      wp[40] = int(descale(tmp12 - tmp1, sh));
      wp[24] = int(descale(tmp13 + tmp0, sh));
      wp[32] = int(descale(tmp13 - tmp0, sh));
    }
    const int sh = kConstBits + kPass1Bits + 3;
    for (int row = 0; row < 8; row++) {
      const int* wp = ws + 8 * row;
      uint8_t* op = out + size_t(row) * stride;
      if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 &&
          wp[5] == 0 && wp[6] == 0 && wp[7] == 0) {
        uint8_t v = limit[int(descale(wp[0], kPass1Bits + 3)) & 0x3FF];
        std::memset(op, v, 8);
        continue;
      }
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * FIX_0_541196100;
      int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
      int64_t tmp3 = z1 + z2 * FIX_0_765366865;
      int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (int64_t(1) << kConstBits);
      int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (int64_t(1) << kConstBits);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp0 *= FIX_0_298631336;
      tmp1 *= FIX_2_053119869;
      tmp2 *= FIX_3_072711026;
      tmp3 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      op[0] = limit[int(descale(tmp10 + tmp3, sh)) & 0x3FF];
      op[7] = limit[int(descale(tmp10 - tmp3, sh)) & 0x3FF];
      op[1] = limit[int(descale(tmp11 + tmp2, sh)) & 0x3FF];
      op[6] = limit[int(descale(tmp11 - tmp2, sh)) & 0x3FF];
      op[2] = limit[int(descale(tmp12 + tmp1, sh)) & 0x3FF];
      op[5] = limit[int(descale(tmp12 - tmp1, sh)) & 0x3FF];
      op[3] = limit[int(descale(tmp13 + tmp0, sh)) & 0x3FF];
      op[4] = limit[int(descale(tmp13 - tmp0, sh)) & 0x3FF];
    }
  }

  // a component's IDCT samples and how its rows upsample to the image's
  struct Plane {
    std::vector<uint8_t> data;
    size_t stride = 0;
    int dw = 0, dh = 0, rh = 1, rv = 1;
    std::vector<int> sum;          // h2v2's column sums of one output row
  };

  void idct_plane(const Component& c, Plane& p) {
    p.stride = size_t(c.nbw) * 8;
    p.data.resize(p.stride * size_t(c.nbh) * 8);
    for (int by = 0; by < c.nbh; by++)
      for (int bx = 0; bx < c.nbw; bx++)
        idct_block(c.coefs + (size_t(by) * c.bw + bx) * 64, c.quant,
                   p.data.data() + size_t(by) * 8 * p.stride + size_t(bx) * 8,
                   p.stride);
    p.dw = c.dw;
    p.dh = c.dh;
    p.rh = maxh / c.h;
    p.rv = maxv / c.v;
    p.sum.resize(size_t(c.dw));
  }

  // output row y of a component, width samples: a row of the plane, or
  // buf (at least 2 * dw + width bytes) filled by the upsampler
  const uint8_t* row(Plane& p, int y, uint8_t* buf) {
    const uint8_t* data = p.data.data();
    const int dw = p.dw, dh = p.dh;
    if (p.rh == 1 && p.rv == 1) return data + size_t(y) * p.stride;
    if (p.rh == 2 && p.rv == 1 && dw > 2) {          // h2v1 fancy
      const uint8_t* s = data + size_t(y) * p.stride;
      buf[0] = s[0];
      buf[1] = uint8_t((3 * s[0] + s[1] + 2) >> 2);
      for (int i = 1; i < dw - 1; i++) {
        int v3 = 3 * s[i];
        buf[2 * i] = uint8_t((v3 + s[i - 1] + 1) >> 2);
        buf[2 * i + 1] = uint8_t((v3 + s[i + 1] + 2) >> 2);
      }
      buf[2 * dw - 2] = uint8_t((3 * s[dw - 1] + s[dw - 2] + 1) >> 2);
      buf[2 * dw - 1] = s[dw - 1];
      return buf;
    }
    if (p.rh == 1 && p.rv == 2) {                    // h1v2 fancy
      int r = y >> 1;
      int near = (y & 1) ? (r + 1 < dh ? r + 1 : dh - 1) : (r > 0 ? r - 1 : 0);
      int bias = (y & 1) ? 2 : 1;
      const uint8_t* s = data + size_t(r) * p.stride;
      const uint8_t* t = data + size_t(near) * p.stride;
      for (int x = 0; x < width; x++)
        buf[x] = uint8_t((3 * s[x] + t[x] + bias) >> 2);
      return buf;
    }
    if (p.rh == 2 && p.rv == 2 && dw > 2) {          // h2v2 fancy
      int r = y >> 1;
      int near = (y & 1) ? (r + 1 < dh ? r + 1 : dh - 1) : (r > 0 ? r - 1 : 0);
      const uint8_t* s = data + size_t(r) * p.stride;
      const uint8_t* t = data + size_t(near) * p.stride;
      int* sum = p.sum.data();
      for (int i = 0; i < dw; i++) sum[i] = 3 * s[i] + t[i];
      buf[0] = uint8_t((4 * sum[0] + 8) >> 4);
      buf[1] = uint8_t((3 * sum[0] + sum[1] + 7) >> 4);
      for (int i = 1; i < dw - 1; i++) {
        int s3 = 3 * sum[i];
        buf[2 * i] = uint8_t((s3 + sum[i - 1] + 8) >> 4);
        buf[2 * i + 1] = uint8_t((s3 + sum[i + 1] + 7) >> 4);
      }
      buf[2 * dw - 2] = uint8_t((3 * sum[dw - 1] + sum[dw - 2] + 8) >> 4);
      buf[2 * dw - 1] = uint8_t((4 * sum[dw - 1] + 7) >> 4);
      return buf;
    }
    const uint8_t* s = data + size_t(y / p.rv) * p.stride;   // replication
    for (int x = 0; x < width; x++) buf[x] = s[x / p.rh];
    return buf;
  }

  // a lossless component's samples scaled by its point transform
  // (jdsample's JSAMPLE cast: the low 8 bits)
  void lossless_plane(const Component& c, Plane& p) {
    p.stride = size_t(c.dw);
    p.data.resize(p.stride * size_t(c.dh));
    const size_t n = p.data.size();
    for (size_t i = 0; i < n; i++)
      p.data[i] = uint8_t(uint32_t(c.samples[i]) << c.pt);
    p.dw = c.dw;
    p.dh = c.dh;
    p.rh = p.rv = 1;
  }

  // kind as check_output's; out holds (height, width, 3) for kinds 0 and
  // 1, (height, width, ncomp) for kind 2
  void reconstruct(uint8_t* out, int kind = 0) {
    check_output(kind);
    const Tables& t = tables();
    Plane planes[4];
    size_t widest = size_t(width);
    for (int i = 0; i < ncomp; i++) {
      if (lossless) lossless_plane(comp[i], planes[i]);
      else idct_plane(comp[i], planes[i]);
      widest = std::max(widest, size_t(2 * planes[i].dw));
    }
    std::vector<uint8_t> bufs(4 * widest);
    const Space sp = kind == 1 ? kYcc : space();
    const int channels = kind == 2 ? ncomp : 3;
    const uint8_t* p[4];
    for (int y = 0; y < height; y++) {
      uint8_t* o = out + size_t(y) * width * channels;
      for (int i = 0; i < ncomp; i++)
        p[i] = row(planes[i], y, bufs.data() + i * widest);
      if (kind == 2) {
        for (int x = 0; x < width; x++)
          for (int i = 0; i < ncomp; i++) o[ncomp * x + i] = p[i][x];
        continue;
      }
      if (ncomp == 1) {
        for (int x = 0; x < width; x++)
          o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = p[0][x];
        continue;
      }
      // 0, 1, 2: where red, green and blue go
      const int ri = kind == 1 ? 0 : 2, bi = kind == 1 ? 2 : 0;
      if (ncomp == 3 && sp == kRgb) {
        for (int x = 0; x < width; x++) {
          o[3 * x + ri] = p[0][x];
          o[3 * x + 1] = p[1][x];
          o[3 * x + bi] = p[2][x];
        }
        continue;
      }
      if (ncomp == 3) {
        for (int x = 0; x < width; x++) {
          int yy = p[0][x], cb = p[1][x], cr = p[2][x];
          o[3 * x + bi] = clamp255(yy + t.cb_b[cb]);
          o[3 * x + 1] = clamp255(yy + ((t.cb_g[cb] + t.cr_g[cr]) >> 16));
          o[3 * x + ri] = clamp255(yy + t.cr_r[cr]);
        }
        continue;
      }
      // CMYK as stored (YCCK through jdcolor.c's ycck_cmyk_convert), then
      // OpenCV's icvCvt_CMYK2BGR_8u_C4C3R
      for (int x = 0; x < width; x++) {
        int c = p[0][x], m = p[1][x], ye = p[2][x], k = p[3][x];
        if (sp == kYcck) {
          int yy = c, cb = m, cr = ye;
          c = clamp255(255 - (yy + t.cr_r[cr]));
          m = clamp255(255 - (yy + ((t.cb_g[cb] + t.cr_g[cr]) >> 16)));
          ye = clamp255(255 - (yy + t.cb_b[cb]));
        }
        o[3 * x + 2] = uint8_t(k - (((255 - c) * k) >> 8));
        o[3 * x + 1] = uint8_t(k - (((255 - m) * k) >> 8));
        o[3 * x] = uint8_t(k - (((255 - ye) * k) >> 8));
      }
    }
  }
};

// ---- the encoder -----------------------------------------------------------
struct HuffEncoder {
  uint32_t code[256];
  uint8_t size[256];
};

void build_encoder(HuffEncoder& e, const uint8_t* bits, const uint8_t* vals) {
  std::memset(e.size, 0, sizeof(e.size));
  uint32_t code = 0;
  int k = 0;
  for (int len = 1; len <= 16; len++) {
    for (int i = 0; i < bits[len - 1]; i++, k++) {
      e.code[vals[k]] = code++;
      e.size[vals[k]] = uint8_t(len);
    }
    code <<= 1;
  }
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int nbits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  inline void put(uint32_t bits, int n) {
    if (n == 0) return;
    acc = (acc << n) | (bits & ((uint32_t(1) << n) - 1));
    nbits += n;
    if (nbits < 32) return;
    while (nbits >= 8) {
      uint8_t b = uint8_t(acc >> (nbits - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits % 8) put(0x7F, 8 - nbits % 8);        // pad with 1s
    while (nbits >= 8) {
      uint8_t b = uint8_t(acc >> (nbits - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      nbits -= 8;
    }
  }
};

inline int nbits_of(int v) {
  int n = 0;
  while (v) {
    n++;
    v >>= 1;
  }
  return n;
}

struct Divisors {                  // jcdctmgr.c's compute_reciprocal, 16-bit
  uint32_t recip[64], corr[64];
  int shift[64];
};

void compute_divisors(Divisors& d, const int* qtable) {
  for (int i = 0; i < 64; i++) {
    uint32_t divisor = uint32_t(qtable[i]) << 3;
    // quantval >= 1, so the divisor is at least 8
    int b = 31 - __builtin_clz(divisor);
    int r = 16 + b;
    uint32_t fq = uint32_t((uint64_t(1) << r) / divisor);
    uint32_t fr = uint32_t((uint64_t(1) << r) % divisor);
    uint32_t c = divisor / 2;
    if (fr == 0) {
      fq >>= 1;
      r--;
    } else if (fr <= divisor / 2) {
      c++;
    } else {
      fq++;
    }
    d.recip[i] = fq & 0xFFFF;
    d.corr[i] = c & 0xFFFF;
    d.shift[i] = r;                // total right shift of the product
  }
}

void fdct_quantize(const uint8_t* src, size_t stride, const Divisors& d,
                   int16_t* coef) {
  // samples lie in [-128, 127]: every product and sum fits 32 bits
  int32_t data[64];
  for (int y = 0; y < 8; y++)
    for (int x = 0; x < 8; x++)
      data[8 * y + x] = int32_t(src[size_t(y) * stride + x]) - 128;
  // pass 1: rows
  for (int row = 0; row < 8; row++) {
    int32_t* p = data + 8 * row;
    int32_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int32_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int32_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int32_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int16_t((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = int16_t((tmp10 - tmp11) * (1 << kPass1Bits));
    int32_t z1 = (tmp12 + tmp13) * int32_t(FIX_0_541196100);
    const int sh = kConstBits - kPass1Bits;
    p[2] = int16_t(descale(z1 + tmp13 * int32_t(FIX_0_765366865), sh));
    p[6] = int16_t(descale(z1 + tmp12 * -int32_t(FIX_1_847759065), sh));
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * int32_t(FIX_1_175875602);
    tmp4 *= int32_t(FIX_0_298631336);
    tmp5 *= int32_t(FIX_2_053119869);
    tmp6 *= int32_t(FIX_3_072711026);
    tmp7 *= int32_t(FIX_1_501321110);
    z1 *= -int32_t(FIX_0_899976223);
    z2 *= -int32_t(FIX_2_562915447);
    z3 *= -int32_t(FIX_1_961570560);
    z4 *= -int32_t(FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    p[7] = int16_t(descale(tmp4 + z1 + z3, sh));
    p[5] = int16_t(descale(tmp5 + z2 + z4, sh));
    p[3] = int16_t(descale(tmp6 + z2 + z3, sh));
    p[1] = int16_t(descale(tmp7 + z1 + z4, sh));
  }
  // pass 2: columns
  for (int col = 0; col < 8; col++) {
    int32_t* p = data + col;
    int32_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int32_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int32_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int32_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int16_t(descale(tmp10 + tmp11, kPass1Bits));
    p[32] = int16_t(descale(tmp10 - tmp11, kPass1Bits));
    int32_t z1 = (tmp12 + tmp13) * int32_t(FIX_0_541196100);
    const int sh = kConstBits + kPass1Bits;
    p[16] = int16_t(descale(z1 + tmp13 * int32_t(FIX_0_765366865), sh));
    p[48] = int16_t(descale(z1 + tmp12 * -int32_t(FIX_1_847759065), sh));
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * int32_t(FIX_1_175875602);
    tmp4 *= int32_t(FIX_0_298631336);
    tmp5 *= int32_t(FIX_2_053119869);
    tmp6 *= int32_t(FIX_3_072711026);
    tmp7 *= int32_t(FIX_1_501321110);
    z1 *= -int32_t(FIX_0_899976223);
    z2 *= -int32_t(FIX_2_562915447);
    z3 *= -int32_t(FIX_1_961570560);
    z4 *= -int32_t(FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    p[56] = int16_t(descale(tmp4 + z1 + z3, sh));
    p[40] = int16_t(descale(tmp5 + z2 + z4, sh));
    p[24] = int16_t(descale(tmp6 + z2 + z3, sh));
    p[8] = int16_t(descale(tmp7 + z1 + z4, sh));
  }
  for (int i = 0; i < 64; i++) {
    int32_t v = data[i];
    uint32_t a = uint32_t(v < 0 ? -v : v);
    uint32_t q = uint32_t((uint32_t((a + d.corr[i]) & 0xFFFF) * d.recip[i]) >>
                          d.shift[i]);
    coef[i] = int16_t(v < 0 ? -int32_t(q & 0xFFFF) : int32_t(q & 0xFFFF));
  }
}

void encode_block(BitWriter& bw, const int16_t* coef, int& last_dc,
                  const HuffEncoder& dct, const HuffEncoder& act) {
  int diff = coef[0] - last_dc;
  last_dc = coef[0];
  int a = diff < 0 ? -diff : diff;
  int n = nbits_of(a);
  if (n > 11) fail("DC coefficient out of range");
  bw.put(dct.code[n], dct.size[n]);
  bw.put(uint32_t(diff < 0 ? diff - 1 : diff), n);
  int run = 0;
  for (int k = 1; k < 64; k++) {
    int v = coef[kNatural[k]];
    if (v == 0) {
      run++;
      continue;
    }
    while (run > 15) {
      bw.put(act.code[0xF0], act.size[0xF0]);
      run -= 16;
    }
    a = v < 0 ? -v : v;
    n = nbits_of(a);
    if (n > 10) fail("AC coefficient out of range");
    int sym = (run << 4) + n;
    bw.put(act.code[sym], act.size[sym]);
    bw.put(uint32_t(v < 0 ? v - 1 : v), n);
    run = 0;
  }
  if (run > 0) bw.put(act.code[0], act.size[0]);
}

void put_word(std::vector<uint8_t>& o, int v) {
  o.push_back(uint8_t(v >> 8));
  o.push_back(uint8_t(v & 0xFF));
}

void put_dht(std::vector<uint8_t>& o, int index, const uint8_t* bits,
             const uint8_t* vals, int n) {
  o.push_back(0xFF);
  o.push_back(0xC4);
  put_word(o, 2 + 1 + 16 + n);
  o.push_back(uint8_t(index));
  o.insert(o.end(), bits, bits + 16);
  o.insert(o.end(), vals, vals + n);
}

std::vector<uint8_t> encode(const uint8_t* img, int h, int w, int channels) {
  if (h < 1 || w < 1 || h > 65535 || w > 65535)
    fail("JPEG sides are 1 to 65535 pixels");
  if (channels != 1 && channels != 3) fail("1 or 3 channels are written");
  const Tables& t = tables();
  int scale = kQuality < 50 ? 5000 / kQuality : 200 - kQuality * 2;
  int qt[2][64];
  for (int i = 0; i < 64; i++) {
    for (int k = 0; k < 2; k++) {
      const int* basic = k ? kChromQuant : kLumQuant;
      int64_t v = (basic[i] * int64_t(scale) + 50) / 100;
      if (v <= 0) v = 1;
      if (v > 255) v = 255;              // baseline clamping
      qt[k][i] = int(v);
    }
  }
  std::vector<uint8_t> o;
  o.reserve(size_t(w) * h * channels / 4 + 1024);
  const uint8_t soi_app0[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F',
                              'I',  'F',  0x00, 0x01, 0x01, 0x00, 0x00, 0x01,
                              0x00, 0x01, 0x00, 0x00};
  o.insert(o.end(), soi_app0, soi_app0 + sizeof(soi_app0));
  int ntables = channels == 3 ? 2 : 1;
  for (int k = 0; k < ntables; k++) {
    o.push_back(0xFF);
    o.push_back(0xDB);
    put_word(o, 67);
    o.push_back(uint8_t(k));
    for (int i = 0; i < 64; i++) o.push_back(uint8_t(qt[k][kNatural[i]]));
  }
  o.push_back(0xFF);
  o.push_back(0xC0);
  put_word(o, 8 + 3 * channels);
  o.push_back(8);
  put_word(o, h);
  put_word(o, w);
  o.push_back(uint8_t(channels));
  if (channels == 1) {
    const uint8_t c[] = {1, 0x11, 0};
    o.insert(o.end(), c, c + 3);
  } else {
    const uint8_t c[] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
    o.insert(o.end(), c, c + 9);
  }
  put_dht(o, 0x00, kDcLumBits, kDcVals, 12);
  put_dht(o, 0x10, kAcLumBits, kAcLumVals, 162);
  if (channels == 3) {
    put_dht(o, 0x01, kDcChromBits, kDcVals, 12);
    put_dht(o, 0x11, kAcChromBits, kAcChromVals, 162);
  }
  o.push_back(0xFF);
  o.push_back(0xDA);
  put_word(o, 6 + 2 * channels);
  o.push_back(uint8_t(channels));
  if (channels == 1) {
    const uint8_t c[] = {1, 0x00};
    o.insert(o.end(), c, c + 2);
  } else {
    const uint8_t c[] = {1, 0x00, 2, 0x11, 3, 0x11};
    o.insert(o.end(), c, c + 6);
  }
  o.push_back(0);
  o.push_back(63);
  o.push_back(0);

  HuffEncoder dc_lum, ac_lum, dc_chrom, ac_chrom;
  build_encoder(dc_lum, kDcLumBits, kDcVals);
  build_encoder(ac_lum, kAcLumBits, kAcLumVals);
  build_encoder(dc_chrom, kDcChromBits, kDcVals);
  build_encoder(ac_chrom, kAcChromBits, kAcChromVals);
  Divisors div[2];
  compute_divisors(div[0], qt[0]);
  compute_divisors(div[1], qt[1]);
  BitWriter bw(o);
  int16_t coef[64];

  if (channels == 1) {
    // one component, non-interleaved: ceil(W/8) x ceil(H/8) blocks of the
    // image with its right and bottom edges replicated
    int nbw = (w + 7) / 8, nbh = (h + 7) / 8;
    size_t stride = size_t(nbw) * 8;
    std::vector<uint8_t> plane(stride * size_t(nbh) * 8);
    for (int y = 0; y < nbh * 8; y++) {
      const uint8_t* s = img + size_t(y < h ? y : h - 1) * w;
      uint8_t* d = &plane[size_t(y) * stride];
      std::memcpy(d, s, size_t(w));
      std::memset(d + w, s[w - 1], stride - size_t(w));
    }
    int last = 0;
    for (int by = 0; by < nbh; by++)
      for (int bx = 0; bx < nbw; bx++) {
        fdct_quantize(&plane[size_t(by) * 8 * stride + size_t(bx) * 8],
                      stride, div[0], coef);
        encode_block(bw, coef, last, dc_lum, ac_lum);
      }
    bw.flush();
    o.push_back(0xFF);
    o.push_back(0xD9);
    return o;
  }

  // 4:2:0 YCbCr: Y blocks ceil(W/8) x ceil(H/8) in MCUs of 2 x 2, Cb and
  // Cr ceil(W/16) x ceil(H/16)
  int mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
  int ybw = (w + 7) / 8, ybh = (h + 7) / 8;
  size_t ystride = size_t(ybw) * 8, cstride = size_t(mcux) * 8;
  int yrows = mcuy * 16, crows = mcuy * 8;
  std::vector<uint8_t> Y(ystride * yrows), Cb(cstride * crows),
      Cr(cstride * crows);
  // full-resolution chroma of two image rows at a time, the right edge
  // replicated to 2 x the downsampled width
  size_t fw = cstride * 2;
  std::vector<uint8_t> cb2(fw * 2), cr2(fw * 2);
  const int32_t* tab = t.rgb_ycc;
  int chroma_rows = (h + 1) / 2;
  for (int r = 0; r < chroma_rows; r++) {
    for (int k = 0; k < 2; k++) {
      int y = 2 * r + k;
      int sy = y < h ? y : h - 1;
      const uint8_t* s = img + size_t(sy) * w * 3;
      uint8_t* yd = y < yrows ? &Y[size_t(y) * ystride] : nullptr;
      uint8_t* cbd = &cb2[size_t(k) * fw];
      uint8_t* crd = &cr2[size_t(k) * fw];
      for (int x = 0; x < w; x++) {
        int b = s[3 * x], g = s[3 * x + 1], rr = s[3 * x + 2];
        uint8_t yy = uint8_t((tab[rr] + tab[256 + g] + tab[512 + b]) >> 16);
        if (yd) yd[x] = yy;
        cbd[x] = uint8_t((tab[768 + rr] + tab[1024 + g] + tab[1280 + b]) >>
                         16);
        crd[x] = uint8_t((tab[1280 + rr] + tab[1536 + g] + tab[1792 + b]) >>
                         16);
      }
      if (yd) std::memset(yd + w, yd[w - 1], ystride - size_t(w));
      std::memset(cbd + w, cbd[w - 1], fw - size_t(w));
      std::memset(crd + w, crd[w - 1], fw - size_t(w));
    }
    for (size_t c = 0; c < cstride; c++) {
      int bias = (c & 1) ? 2 : 1;
      Cb[size_t(r) * cstride + c] = uint8_t(
          (cb2[2 * c] + cb2[2 * c + 1] + cb2[fw + 2 * c] +
           cb2[fw + 2 * c + 1] + bias) >> 2);
      Cr[size_t(r) * cstride + c] = uint8_t(
          (cr2[2 * c] + cr2[2 * c + 1] + cr2[fw + 2 * c] +
           cr2[fw + 2 * c + 1] + bias) >> 2);
    }
  }
  // the bottom edges replicated to the MCU rows
  for (int y = 2 * chroma_rows; y < yrows; y++)
    std::memcpy(&Y[size_t(y) * ystride],
                &Y[size_t(2 * chroma_rows - 1) * ystride], ystride);
  for (int r = chroma_rows; r < crows; r++) {
    std::memcpy(&Cb[size_t(r) * cstride],
                &Cb[size_t(chroma_rows - 1) * cstride], cstride);
    std::memcpy(&Cr[size_t(r) * cstride],
                &Cr[size_t(chroma_rows - 1) * cstride], cstride);
  }
  int last_y = 0, last_cb = 0, last_cr = 0;
  int16_t yblk[4][64];
  for (int my = 0; my < mcuy; my++)
    for (int mx = 0; mx < mcux; mx++) {
      // jccoefct.c: a block past the component's last column is a dummy
      // of zeros with its left neighbour's DC; a row past its last row, of
      // the block before it
      for (int j = 0; j < 2; j++)
        for (int i = 0; i < 2; i++) {
          int by = 2 * my + j, bx = 2 * mx + i;
          int16_t* b = yblk[2 * j + i];
          if (by >= ybh) {
            std::memset(b, 0, sizeof(yblk[0]));
            b[0] = yblk[2 * j + i - 1][0];
          } else if (bx >= ybw) {
            std::memset(b, 0, sizeof(yblk[0]));
            b[0] = yblk[2 * j + i - 1][0];
          } else {
            fdct_quantize(&Y[size_t(by) * 8 * ystride + size_t(bx) * 8],
                          ystride, div[0], b);
          }
        }
      for (int k = 0; k < 4; k++)
        encode_block(bw, yblk[k], last_y, dc_lum, ac_lum);
      fdct_quantize(&Cb[size_t(my) * 8 * cstride + size_t(mx) * 8], cstride,
                    div[1], coef);
      encode_block(bw, coef, last_cb, dc_chrom, ac_chrom);
      fdct_quantize(&Cr[size_t(my) * 8 * cstride + size_t(mx) * 8], cstride,
                    div[1], coef);
      encode_block(bw, coef, last_cr, dc_chrom, ac_chrom);
    }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

void set_error(char* err, int64_t errlen, const std::string& msg) {
  if (!err || errlen <= 0) return;
  size_t n = msg.size() < size_t(errlen - 1) ? msg.size() : size_t(errlen - 1);
  std::memcpy(err, msg.data(), n);
  err[n] = 0;
}

}  // namespace

extern "C" {

// The frame's size: dims = {height, width, components}. Returns 0, or -1
// with a message in err.
int oodt_jpeg_size(const uint8_t* data, int64_t len, int64_t* dims,
                   char* err, int64_t errlen) {
  try {
    Decoder d(data, size_t(len));
    d.parse_size();
    dims[0] = d.height;
    dims[1] = d.width;
    dims[2] = d.ncomp;
    return 0;
  } catch (const JpegError& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

// Decode into out, (height, width, 3) uint8 BGR of the size oodt_jpeg_size
// gave. Returns 0, or -1 with a message in err.
int oodt_jpeg_decode(const uint8_t* data, int64_t len, uint8_t* out,
                     int64_t height, int64_t width, char* err,
                     int64_t errlen) {
  try {
    Decoder d(data, size_t(len));
    d.parse();
    if (d.height != height || d.width != width)
      fail("the frame's size is not the one given");
    d.reconstruct(out);
    return 0;
  } catch (const JpegError& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

// Decode a tables-only stream (tables, tlen bytes; none when tlen is 0),
// then the abbreviated stream in data: a TIFF file's JPEGTables and one of
// its strips or tiles. mode 1 converts YCbCr to RGB (libtiff's
// JPEGCOLORMODE_RGB), mode 0 converts nothing (the components must not be
// subsampled). out is (height, width, channels): the stream's width, and
// its first height rows (a last strip's stream may be taller). Returns 0,
// or -1 with a message in err.
int oodt_jpeg_decode_segment(const uint8_t* tables, int64_t tlen,
                             const uint8_t* data, int64_t len, int64_t mode,
                             uint8_t* out, int64_t height, int64_t width,
                             int64_t channels, char* err, int64_t errlen) {
  try {
    Decoder d(tables, tlen > 0 ? size_t(tlen) : 0);
    if (tables && tlen > 0) d.parse_tables();
    d.data = data;
    d.len = size_t(len);
    d.pos = 0;
    d.parse();
    const int kind = mode == 1 ? 1 : 2;
    if (d.width != width || d.height < height)
      fail("the stream is " + std::to_string(d.width) + " x " +
           std::to_string(d.height) + ", not the strip's or tile's " +
           std::to_string(width) + " x " + std::to_string(height));
    if ((kind == 1 ? 3 : d.ncomp) != channels)
      fail("the stream's components are not the image's samples");
    if (kind == 2)
      for (int i = 0; i < d.ncomp; i++)
        if (d.comp[i].h != 1 || d.comp[i].v != 1)
          fail("subsampled JPEG components outside YCbCr are not read");
    if (d.height == height) {
      d.reconstruct(out, kind);
    } else {
      std::vector<uint8_t> all(size_t(d.height) * size_t(width) *
                               size_t(channels));
      d.reconstruct(all.data(), kind);
      std::memcpy(out, all.data(), size_t(height) * size_t(width) *
                                       size_t(channels));
    }
    return 0;
  } catch (const JpegError& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

// Encode (h, w, channels) uint8 (BGR, or grey with channels 1) as
// cv2.imwrite writes a .jpg. Returns the file's size, writing it into out
// when it fits in cap bytes (call again with a larger buffer otherwise),
// or -1 with a message in err.
int64_t oodt_jpeg_encode(const uint8_t* img, int64_t h, int64_t w,
                         int64_t channels, uint8_t* out, int64_t cap,
                         char* err, int64_t errlen) {
  try {
    if (h > 65535 || w > 65535) fail("JPEG sides are 1 to 65535 pixels");
    std::vector<uint8_t> o = encode(img, int(h), int(w), int(channels));
    if (int64_t(o.size()) <= cap) std::memcpy(out, o.data(), o.size());
    return int64_t(o.size());
  } catch (const JpegError& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

}  // extern "C"
