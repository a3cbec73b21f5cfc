// TIFF reader and writer on the host (C++17, no dependencies), after what
// OpenCV's imread / imdecode (libtiff's RGBA interface, tif_getimage.c) and
// imwrite / imencode (libtiff's LZW encoder) do for the JAX package.
//
// Reader: classic TIFF and BigTIFF in both byte orders, the first IFD (the
// first page, as cv2.imread reads it), strips or tiles (edge tiles cropped),
// PlanarConfiguration 1 and 2, FillOrder 1 and 2 (each byte's bits reversed
// before it is decompressed, but for JPEG, as libtiff's TIFFReverseBits),
// compression none, LZW (and old-style, LSB-first LZW, as libtiff's
// LZWDecodeCompat), PackBits, deflate (8 and 32946, with the inflater
// below), JPEG (7: the JPEGTables stream, then each strip's or tile's
// abbreviated stream, through jpeg.cpp's oodt_jpeg_decode_segment), CCITT
// RLE (2), RLEW (32771), T.4 (3, 1-D and 2-D) and T.6 (4) (tif_fax3.c's
// decoder, step for step) and SGILog (34676 run-length LogL / LogLuv, 34677
// LogLuv24, tif_luv.c), Predictor 2 at 8 and 16 bits. Unsigned and signed
// samples alike are read by their bits. The samples become RGB as
// tif_getimage.c makes them:
//   - MinIsBlack / MinIsWhite at 1 and 8 bits through its map
//     (x * 255 / range, inverted for MinIsWhite); 16 bits by the high byte
//     (OpenCV refuses 2 bits, and 4 outside a palette: so does this);
//   - RGB at 8 bits, and 16 bits as (v + 128) / 257;
//   - unassociated alpha (ExtraSamples 2) premultiplied as
//     (v * a + 127) / 255; associated alpha as stored (it is then dropped);
//   - palette images (1-8 bits) through the colormap, cut to 8 bits by
//     >> 8 unless every entry is below 256 (libtiff's checkcmap);
//   - separated CMYK (InkSet 1, 8 bits) as k * (255 - c) / 255, k = 255 - K;
//   - YCbCr at 8 bits with subsampling 1, 2 or 4 (contiguous), or 1 x 1
//     (planar), through TIFFYCbCrToRGBInit's tables (YCbCrCoefficients,
//     ReferenceBlackWhite); JPEG-compressed YCbCr as libjpeg converts it
//     (JPEGCOLORMODE_RGB);
//   - CIE L*a*b* (8 and 16 bits, contiguous) through tif_color.c's
//     TIFFCIELab16ToXYZ and TIFFXYZToRGB with its sRGB display table;
//   - LogL as 8-bit grey and LogLuv as 8-bit RGB, as the SGILog codec gives
//     them to the RGBA interface (L16toGry, Luv32toRGB, Luv24toRGB).
// The output is the stored raster as (height, width, 3) BGR; the caller
// applies the Orientation tag (oodt_tiff_info gives it) as OpenCV does.
// The forms OpenCV does not read are refused, saying so: float, complex and
// 32-bit signed samples, the floating-point predictor, ICC and ITU
// L*a*b*, old-style JPEG (6), LZMA, ZSTD, WebP, LERC and JPEG XL
// compression (OpenCV gives an all-black image for JPEG XL), 12-bit JPEG
// strips, 2-bit samples, 4-bit grey, more than 4 samples a pixel and
// uncompressed tiles of other than a multiple of 1024 bytes; so is
// anything that does not decode. Every offset and count is checked against
// the file's length, and an image past 2^30 pixels is refused before
// anything is allocated.
//
// Writer: what cv2.imwrite(".tif") writes for grey, BGR or BGRA samples of
// 8, 16, 32 or 64 bits, unsigned, signed or float: "II*\0", the strips,
// then the IFD at an even offset (12 entries: ImageWidth, ImageLength,
// BitsPerSample, Compression, Photometric, StripOffsets, SamplesPerPixel,
// RowsPerStrip, StripByteCounts, PlanarConfiguration 1, Predictor 2,
// SampleFormat), then the values that do not fit an entry in libtiff's
// order. Rows per strip are OpenCV's 8192 / row bytes (at least 1).
// Integer samples: each strip is Predictor 2 (modulo the sample's width)
// then tif_lzw.c's encoder, its hash, its 12-bit table reset and its ratio
// check included. Float samples: uncompressed (Compression 1), no
// Predictor entry.
//
// A plain C ABI, loaded with ctypes (native.py builds it with rnms.cpp and
// jpeg.cpp into one library, linking nothing else). No global state is
// written (the CCITT and bit-reversal tables are built once, at first use):
// calls from several threads run in parallel.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <new>
#include <string>
#include <vector>

extern "C" int oodt_jpeg_decode_segment(const uint8_t* tables, int64_t tlen,
                                        const uint8_t* data, int64_t len,
                                        int64_t mode, uint8_t* out,
                                        int64_t height, int64_t width,
                                        int64_t channels, char* err,
                                        int64_t errlen);

namespace {

struct TiffError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw TiffError{msg}; }

const char* const kOpenCvToo = ": OpenCV does not read it either";
const uint64_t kMaxPixels = uint64_t(1) << 30;   // OpenCV's image size limit

// uninitialised bytes: pages a truncated file never reaches stay untouched
struct Buffer {
  std::unique_ptr<uint8_t, decltype(&std::free)> p{nullptr, &std::free};
  size_t size = 0;
  explicit Buffer(size_t n) : size(n) {
    p.reset(static_cast<uint8_t*>(std::malloc(n ? n : 1)));
    if (!p) fail("out of memory");
  }
  uint8_t* data() { return p.get(); }
};

// ---- deflate (RFC 1950 / 1951) ---------------------------------------------
struct Inflater {
  const uint8_t* in;
  size_t n;
  size_t pos = 0;
  uint64_t buf = 0;
  int cnt = 0;
  uint64_t used = 0;               // bits consumed, checked against 8 * n

  void need(int k) {
    while (cnt < k) {
      uint64_t b = pos < n ? in[pos] : 0;    // zeros past the end
      pos++;
      buf |= b << cnt;
      cnt += 8;
    }
  }
  void drop(int k) {
    buf >>= k;
    cnt -= k;
    used += uint64_t(k);
    if (used > 8 * uint64_t(n)) fail("truncated deflate data");
  }
  int bits(int k) {
    if (k == 0) return 0;
    need(k);
    int v = int(buf & ((uint64_t(1) << k) - 1));
    drop(k);
    return v;
  }

  struct Huff {
    int16_t count[16];
    int16_t symbol[320];
    int32_t fast[512];             // next 9 bits -> symbol * 16 + length
  };

  static void build(Huff& h, const uint8_t* lengths, int n, bool lenient) {
    std::memset(h.count, 0, sizeof(h.count));
    for (int i = 0; i < n; i++) h.count[lengths[i]]++;
    int left = 1;
    for (int len = 1; len < 16; len++) {
      left <<= 1;
      left -= h.count[len];
      if (left < 0) fail("corrupt deflate data (over-subscribed code)");
    }
    if (left > 0 && !lenient && h.count[0] != n)
      fail("corrupt deflate data (incomplete code)");
    int16_t offs[16];
    offs[1] = 0;
    for (int len = 1; len < 15; len++) offs[len + 1] = offs[len] + h.count[len];
    for (int i = 0; i < n; i++)
      if (lengths[i]) h.symbol[offs[lengths[i]]++] = int16_t(i);
    for (int i = 0; i < 512; i++) h.fast[i] = -1;
    int code = 0, k = 0;
    for (int len = 1; len <= 9; len++) {
      for (int i = 0; i < h.count[len]; i++, code++, k++) {
        int rev = 0;
        for (int b = 0; b < len; b++) rev |= ((code >> b) & 1) << (len - 1 - b);
        for (int j = rev; j < 512; j += 1 << len)
          h.fast[j] = h.symbol[k] * 16 + len;
      }
      code <<= 1;
    }
  }

  int decode(const Huff& h) {
    need(9);
    int32_t f = h.fast[buf & 511];
    if (f >= 0) {
      drop(f & 15);
      return f >> 4;
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len < 16; len++) {
      code |= bits(1);
      int count = h.count[len];
      if (code - count < first) return h.symbol[index + (code - first)];
      index += count;
      first += count;
      first <<= 1;
      code <<= 1;
    }
    fail("corrupt deflate data (bad code)");
  }

  // inflate into out until `want` bytes are made (the rest of the stream
  // is not read, as libtiff stops there)
  void run(uint8_t* out, size_t want) {
    static const int16_t lbase[29] = {3,  4,  5,  6,  7,  8,  9,  10,
                                      11, 13, 15, 17, 19, 23, 27, 31,
                                      35, 43, 51, 59, 67, 83, 99, 115,
                                      131, 163, 195, 227, 258};
    static const int16_t lext[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                     1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                                     4, 4, 4, 4, 5, 5, 5, 5, 0};
    static const int32_t dbase[30] = {
        1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
        33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
        1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
    static const int16_t dext[30] = {0, 0, 0, 0, 1, 1, 2,  2,  3,  3,
                                     4, 4, 5, 5, 6, 6, 7,  7,  8,  8,
                                     9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
    if (n < 2) fail("truncated deflate data");
    int cmf = in[0], flg = in[1];
    if ((cmf & 15) != 8 || (cmf * 256 + flg) % 31 != 0 || (flg & 32))
      fail("corrupt deflate data (zlib header)");
    pos = 2;
    used = 16;
    size_t at = 0;
    Huff lit, dist;
    for (;;) {
      int last = bits(1);
      int type = bits(2);
      if (type == 0) {
        drop(cnt & 7);
        int len = bits(16), nlen = bits(16);
        if ((len ^ 0xFFFF) != nlen) fail("corrupt deflate data (stored)");
        for (int i = 0; i < len; i++) {
          int b = bits(8);
          if (at < want) out[at++] = uint8_t(b);
          if (at == want) return;
        }
      } else if (type == 1 || type == 2) {
        uint8_t lengths[320];
        if (type == 1) {
          int i = 0;
          for (; i < 144; i++) lengths[i] = 8;
          for (; i < 256; i++) lengths[i] = 9;
          for (; i < 280; i++) lengths[i] = 7;
          for (; i < 288; i++) lengths[i] = 8;
          build(lit, lengths, 288, true);
          for (i = 0; i < 30; i++) lengths[i] = 5;
          build(dist, lengths, 30, true);
        } else {
          int nlen = bits(5) + 257, ndist = bits(5) + 1, ncode = bits(4) + 4;
          if (nlen > 286 || ndist > 30)
            fail("corrupt deflate data (counts)");
          static const uint8_t order[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                            11, 4,  12, 3, 13, 2, 14, 1, 15};
          uint8_t cl[19] = {0};
          for (int i = 0; i < ncode; i++) cl[order[i]] = uint8_t(bits(3));
          Huff lencode;
          build(lencode, cl, 19, false);
          int i = 0;
          while (i < nlen + ndist) {
            int sym = decode(lencode);
            if (sym < 16) {
              lengths[i++] = uint8_t(sym);
            } else {
              int len = 0, rep;
              if (sym == 16) {
                if (i == 0) fail("corrupt deflate data (repeat)");
                len = lengths[i - 1];
                rep = 3 + bits(2);
              } else if (sym == 17) {
                rep = 3 + bits(3);
              } else {
                rep = 11 + bits(7);
              }
              if (i + rep > nlen + ndist) fail("corrupt deflate data (repeat)");
              while (rep--) lengths[i++] = uint8_t(len);
            }
          }
          if (lengths[256] == 0) fail("corrupt deflate data (no end code)");
          build(lit, lengths, nlen, false);
          build(dist, lengths + nlen, ndist, true);
        }
        for (;;) {
          int sym = decode(lit);
          if (sym < 256) {
            out[at++] = uint8_t(sym);
            if (at == want) return;
          } else if (sym == 256) {
            break;
          } else {
            sym -= 257;
            if (sym >= 29) fail("corrupt deflate data (length)");
            int len = lbase[sym] + bits(lext[sym]);
            int ds = decode(dist);
            if (ds >= 30) fail("corrupt deflate data (distance)");
            size_t d = size_t(dbase[ds] + bits(dext[ds]));
            if (d > at) fail("corrupt deflate data (distance too far)");
            for (int k = 0; k < len; k++, at++) {
              out[at] = out[at - d];
              if (at + 1 == want) return;
            }
          }
        }
      } else {
        fail("corrupt deflate data (block type 3)");
      }
      if (last) break;
    }
    fail("not enough deflate data for the strip or tile");
  }
};

// ---- LZW (tif_lzw.c) -------------------------------------------------------
const int kBitsMin = 9, kBitsMax = 12;
const int kClear = 256, kEoi = 257, kFirst = 258;
const int kCodeMax = (1 << kBitsMax) - 1;
const int kHashSize = 9001;        // tif_lzw.c's HSIZE, 91% occupancy
const int kHashShift = 13 - 8;
const long kCheckGap = 10000;

// tif_lzw.c's LZWDecodeCompat: LSB-first codes, the width raised one code
// later than LZWDecode raises it, and no code before the first clear
void lzw_decode_compat(const uint8_t* in, size_t n, uint8_t* out,
                       size_t want) {
  const int size = kCodeMax + 1 + 1024;
  std::vector<int32_t> prefix(size, -1), length(size, 0);
  std::vector<uint8_t> suffix(size, 0), first(size, 0);
  for (int i = 0; i < 256; i++) {
    suffix[i] = first[i] = uint8_t(i);
    length[i] = 1;
  }
  size_t pos = 0, at = 0;
  uint64_t acc = 0;
  int cnt = 0, nbits = kBitsMin, free_ent = kFirst, old = -1;
  int maxcode = (1 << kBitsMin) - 1;
  auto next = [&]() -> int {
    while (cnt < nbits) {
      if (pos >= n) return -1;
      acc |= uint64_t(in[pos++]) << cnt;
      cnt += 8;
    }
    int code = int(acc & ((1u << nbits) - 1));
    acc >>= nbits;
    cnt -= nbits;
    return code;
  };
  while (at < want) {
    int code = next();
    if (code < 0 || code == kEoi) break;
    if (code == kClear) {
      do {
        free_ent = kFirst;
        std::fill(length.begin() + kFirst, length.end(), 0);
        nbits = kBitsMin;
        maxcode = (1 << kBitsMin) - 1;
        code = next();
      } while (code == kClear);
      if (code < 0 || code == kEoi) break;
      if (code > kClear) fail("corrupt LZW data (a code after a clear)");
      out[at++] = uint8_t(code);
      old = code;
      continue;
    }
    if (old < 0 || free_ent >= size)
      fail("corrupt LZW data (no clear code first)");
    prefix[free_ent] = old;
    first[free_ent] = first[old];
    length[free_ent] = length[old] + 1;
    suffix[free_ent] = code < free_ent ? first[code] : first[old];
    if (++free_ent > maxcode) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      maxcode = (1 << nbits) - 1;
    }
    old = code;
    if (code < 256) {
      out[at++] = uint8_t(code);
      continue;
    }
    int len = length[code];
    if (len == 0) fail("corrupt LZW data (a code past the table)");
    // a string longer than the room left: its first bytes, as libtiff's
    // restart logic gives them
    size_t keep = std::min(size_t(len), want - at);
    int c = code;
    for (int k = len; k > int(keep); k--) c = prefix[c];
    for (size_t k = keep; k > 0; k--, c = prefix[c])
      out[at + k - 1] = suffix[c];
    at += keep;
  }
  if (at < want) fail("not enough LZW data for the strip or tile");
}

void lzw_decode(const uint8_t* in, size_t n, uint8_t* out, size_t want) {
  if (n >= 2 && in[0] == 0 && (in[1] & 1)) {     // LZWPreDecode's test
    lzw_decode_compat(in, n, out, want);
    return;
  }
  // libtiff's table runs 1024 entries past the 12-bit codes
  const int size = kCodeMax + 1 + 1024;
  std::vector<int32_t> prefix(size);
  std::vector<uint8_t> suffix(size), first(size);
  std::vector<int32_t> length(size);
  for (int i = 0; i < 256; i++) {
    prefix[i] = -1;
    suffix[i] = first[i] = uint8_t(i);
    length[i] = 1;
  }
  size_t pos = 0, at = 0;
  uint32_t acc = 0;
  int cnt = 0, nbits = kBitsMin, free_ent = kFirst, old = -1;
  auto next = [&]() -> int {
    while (cnt < nbits) {
      if (pos >= n) return -1;
      acc = (acc << 8) | in[pos++];
      cnt += 8;
    }
    cnt -= nbits;
    return int((acc >> cnt) & ((1u << nbits) - 1));
  };
  auto emit = [&](int code) {
    int len = length[code];
    size_t end = at + size_t(len);
    int c = code;
    for (size_t k = end; k > at; k--, c = prefix[c])
      if (k - 1 < want) out[k - 1] = suffix[c];
    at = end;
  };
  while (at < want) {
    int code = next();
    if (code < 0) break;
    if (code == kEoi) break;
    if (code == kClear) {
      free_ent = kFirst;
      nbits = kBitsMin;
      code = next();
      if (code < 0 || code == kEoi) break;
      if (code >= kClear) fail("corrupt LZW data (a code after a clear)");
      emit(code);
      old = code;
      continue;
    }
    if (old < 0) {
      if (code >= 256) fail("corrupt LZW data (no clear code first)");
      emit(code);
      old = code;
      continue;
    }
    if (code > free_ent || free_ent >= size)
      fail("corrupt LZW data (a code past the table)");
    prefix[free_ent] = old;
    length[free_ent] = length[old] + 1;
    first[free_ent] = first[old];
    suffix[free_ent] = code < free_ent ? first[code] : first[old];
    free_ent++;
    if (free_ent > (1 << nbits) - 2 && nbits < kBitsMax) nbits++;
    emit(code);
    old = code;
  }
  if (at < want) fail("not enough LZW data for the strip or tile");
}

// tif_lzw.c's LZWEncode and LZWPostEncode over one strip
void lzw_encode(const uint8_t* bp, size_t cc, std::vector<uint8_t>& o) {
  std::vector<int64_t> hash(kHashSize, -1);
  std::vector<uint16_t> codes(kHashSize);
  long incount = 0, outcount = 0, checkpoint = kCheckGap, ratio = 0;
  uint64_t nextdata = 0;
  int nextbits = 0, free_ent = kFirst, maxcode = (1 << kBitsMin) - 1;
  int nbits = kBitsMin;
  auto put = [&](int c) {
    nextdata = (nextdata << nbits) | uint64_t(c);
    nextbits += nbits;
    o.push_back(uint8_t(nextdata >> (nextbits - 8)));
    nextbits -= 8;
    if (nextbits >= 8) {
      o.push_back(uint8_t(nextdata >> (nextbits - 8)));
      nextbits -= 8;
    }
    outcount += nbits;
  };
  auto reset = [&]() {
    std::fill(hash.begin(), hash.end(), int64_t(-1));
    ratio = 0;
    incount = 0;
    outcount = 0;
    free_ent = kFirst;
    put(kClear);
    nbits = kBitsMin;
    maxcode = (1 << kBitsMin) - 1;
  };
  int ent = -1;
  if (cc > 0) {
    put(kClear);
    ent = *bp++;
    cc--;
    incount++;
  }
  while (cc > 0) {
    int c = *bp++;
    cc--;
    incount++;
    int64_t fcode = (int64_t(c) << kBitsMax) + ent;
    int h = (c << kHashShift) ^ ent;
    if (hash[h] == fcode) {
      ent = codes[h];
      continue;
    }
    if (hash[h] >= 0) {
      int disp = h == 0 ? 1 : kHashSize - h;
      bool hit = false;
      do {
        if ((h -= disp) < 0) h += kHashSize;
        if (hash[h] == fcode) {
          ent = codes[h];
          hit = true;
          break;
        }
      } while (hash[h] >= 0);
      if (hit) continue;
    }
    put(ent);
    ent = c;
    codes[h] = uint16_t(free_ent++);
    hash[h] = fcode;
    if (free_ent == kCodeMax - 1) {
      reset();
    } else if (free_ent > maxcode) {
      nbits++;
      maxcode = (1 << nbits) - 1;
    } else if (incount >= checkpoint) {
      checkpoint = incount + kCheckGap;
      long rat;
      if (incount > 0x007fffff) {
        rat = outcount >> 8;
        rat = rat == 0 ? 0x7fffffff : incount / rat;
      } else {
        rat = (incount << 8) / outcount;
      }
      if (rat <= ratio) reset();
      else ratio = rat;
    }
  }
  if (ent != -1) {
    put(ent);
    free_ent++;
    if (free_ent == kCodeMax - 1) {
      outcount = 0;
      put(kClear);
      nbits = kBitsMin;
    } else if (free_ent > maxcode) {
      nbits++;
    }
  }
  put(kEoi);
  if (nextbits > 0) o.push_back(uint8_t((nextdata << (8 - nextbits)) & 0xFF));
}

// ---- PackBits (tif_packbits.c) ---------------------------------------------
void packbits_decode(const uint8_t* in, size_t n, uint8_t* out, size_t want) {
  size_t pos = 0, at = 0;
  while (pos < n && at < want) {
    int c = in[pos++];
    if (c >= 128) c -= 256;
    if (c < 0) {
      if (c == -128) continue;
      size_t run = size_t(1 - c);
      if (pos >= n) break;
      if (run > want - at) run = want - at;
      std::memset(out + at, in[pos++], run);
      at += run;
    } else {
      size_t run = size_t(c) + 1;
      if (run > want - at) run = want - at;
      if (pos + run > n) break;
      std::memcpy(out + at, in + pos, run);
      at += run;
      pos += run;
    }
  }
  if (at < want) fail("not enough PackBits data for the strip or tile");
}

// ---- CCITT RLE, RLEW, T.4 and T.6 (tif_fax3.c) -----------------------------
// libtiff's decoder, step for step: its bit accumulator (each byte's bits
// taken LSB first after FillOrder's reversal table, so that RLEW's word
// alignment lands where libtiff's does), mkg3states' lookup tables (12 bits
// for the white codes, 13 for the black, 7 for the 2-D modes) and its way
// on from an unexpected code (the row is closed and decoding goes on, as
// libtiff warns and goes on). Data that ends early closes the row it ends
// in, as libtiff's decoder does, and leaves the block's later rows at 0 bits,
// which OpenCV, reading on past the error, returns for RLE, RLEW and T.6:
// RLEW's own files need it, since libtiff's word alignment can run a row
// past the data.
enum {
  kFaxNull, kFaxPass, kFaxHoriz, kFaxV0, kFaxVR, kFaxVL, kFaxExt, kFaxTermW,
  kFaxTermB, kFaxMakeUpW, kFaxMakeUpB, kFaxMakeUp, kFaxEol
};

struct FaxEntry {
  uint8_t state = kFaxNull, width = 0;
  uint32_t param = 0;
};

struct FaxCode {
  int run;
  const char* bits;                // the code, first bit first
};

const FaxCode kWhiteCodes[] = {
    {0, "00110101"}, {1, "000111"}, {2, "0111"}, {3, "1000"}, {4, "1011"},
    {5, "1100"}, {6, "1110"}, {7, "1111"}, {8, "10011"}, {9, "10100"},
    {10, "00111"}, {11, "01000"}, {12, "001000"}, {13, "000011"},
    {14, "110100"}, {15, "110101"}, {16, "101010"}, {17, "101011"},
    {18, "0100111"}, {19, "0001100"}, {20, "0001000"}, {21, "0010111"},
    {22, "0000011"}, {23, "0000100"}, {24, "0101000"}, {25, "0101011"},
    {26, "0010011"}, {27, "0100100"}, {28, "0011000"}, {29, "00000010"},
    {30, "00000011"}, {31, "00011010"}, {32, "00011011"}, {33, "00010010"},
    {34, "00010011"}, {35, "00010100"}, {36, "00010101"}, {37, "00010110"},
    {38, "00010111"}, {39, "00101000"}, {40, "00101001"}, {41, "00101010"},
    {42, "00101011"}, {43, "00101100"}, {44, "00101101"}, {45, "00000100"},
    {46, "00000101"}, {47, "00001010"}, {48, "00001011"}, {49, "01010010"},
    {50, "01010011"}, {51, "01010100"}, {52, "01010101"}, {53, "00100100"},
    {54, "00100101"}, {55, "01011000"}, {56, "01011001"}, {57, "01011010"},
    {58, "01011011"}, {59, "01001010"}, {60, "01001011"}, {61, "00110010"},
    {62, "00110011"}, {63, "00110100"}, {64, "11011"}, {128, "10010"},
    {192, "010111"}, {256, "0110111"}, {320, "00110110"}, {384, "00110111"},
    {448, "01100100"}, {512, "01100101"}, {576, "01101000"},
    {640, "01100111"}, {704, "011001100"}, {768, "011001101"},
    {832, "011010010"}, {896, "011010011"}, {960, "011010100"},
    {1024, "011010101"}, {1088, "011010110"}, {1152, "011010111"},
    {1216, "011011000"}, {1280, "011011001"}, {1344, "011011010"},
    {1408, "011011011"}, {1472, "010011000"}, {1536, "010011001"},
    {1600, "010011010"}, {1664, "011000"}, {1728, "010011011"}};
const FaxCode kBlackCodes[] = {
    {0, "0000110111"}, {1, "010"}, {2, "11"}, {3, "10"}, {4, "011"},
    {5, "0011"}, {6, "0010"}, {7, "00011"}, {8, "000101"}, {9, "000100"},
    {10, "0000100"}, {11, "0000101"}, {12, "0000111"}, {13, "00000100"},
    {14, "00000111"}, {15, "000011000"}, {16, "0000010111"},
    {17, "0000011000"}, {18, "0000001000"}, {19, "00001100111"},
    {20, "00001101000"}, {21, "00001101100"}, {22, "00000110111"},
    {23, "00000101000"}, {24, "00000010111"}, {25, "00000011000"},
    {26, "000011001010"}, {27, "000011001011"}, {28, "000011001100"},
    {29, "000011001101"}, {30, "000001101000"}, {31, "000001101001"},
    {32, "000001101010"}, {33, "000001101011"}, {34, "000011010010"},
    {35, "000011010011"}, {36, "000011010100"}, {37, "000011010101"},
    {38, "000011010110"}, {39, "000011010111"}, {40, "000001101100"},
    {41, "000001101101"}, {42, "000011011010"}, {43, "000011011011"},
    {44, "000001010100"}, {45, "000001010101"}, {46, "000001010110"},
    {47, "000001010111"}, {48, "000001100100"}, {49, "000001100101"},
    {50, "000001010010"}, {51, "000001010011"}, {52, "000000100100"},
    {53, "000000110111"}, {54, "000000111000"}, {55, "000000100111"},
    {56, "000000101000"}, {57, "000001011000"}, {58, "000001011001"},
    {59, "000000101011"}, {60, "000000101100"}, {61, "000001011010"},
    {62, "000001100110"}, {63, "000001100111"}, {64, "0000001111"},
    {128, "000011001000"}, {192, "000011001001"}, {256, "000001011011"},
    {320, "000000110011"}, {384, "000000110100"}, {448, "000000110101"},
    {512, "0000001101100"}, {576, "0000001101101"}, {640, "0000001001010"},
    {704, "0000001001011"}, {768, "0000001001100"}, {832, "0000001001101"},
    {896, "0000001110010"}, {960, "0000001110011"}, {1024, "0000001110100"},
    {1088, "0000001110101"}, {1152, "0000001110110"},
    {1216, "0000001110111"}, {1280, "0000001010010"},
    {1344, "0000001010011"}, {1408, "0000001010100"},
    {1472, "0000001010101"}, {1536, "0000001011010"},
    {1600, "0000001011011"}, {1664, "0000001100100"},
    {1728, "0000001100101"}};
const FaxCode kExtendedCodes[] = {     // the make-up codes of both colours
    {1792, "00000001000"}, {1856, "00000001100"}, {1920, "00000001101"},
    {1984, "000000010010"}, {2048, "000000010011"}, {2112, "000000010100"},
    {2176, "000000010101"}, {2240, "000000010110"}, {2304, "000000010111"},
    {2368, "000000011100"}, {2432, "000000011101"}, {2496, "000000011110"},
    {2560, "000000011111"}};

struct FaxTables {
  FaxEntry main[1 << 7], white[1 << 12], black[1 << 13];

  // mkg3states' FillTable: every index whose low bits are the code
  static void fill(FaxEntry* table, int size, const char* bits, int state,
                   uint32_t param) {
    int width = int(std::strlen(bits)), code = 0;
    for (int i = 0; i < width; i++) code |= (bits[i] - '0') << i;
    for (int at = code; at < (1 << size); at += 1 << width)
      table[at] = FaxEntry{uint8_t(state), uint8_t(width), param};
  }

  FaxTables() {
    for (const FaxCode& c : kWhiteCodes)
      fill(white, 12, c.bits, c.run < 64 ? kFaxTermW : kFaxMakeUpW,
           uint32_t(c.run));
    for (const FaxCode& c : kBlackCodes)
      fill(black, 13, c.bits, c.run < 64 ? kFaxTermB : kFaxMakeUpB,
           uint32_t(c.run));
    for (const FaxCode& c : kExtendedCodes) {
      fill(white, 12, c.bits, kFaxMakeUp, uint32_t(c.run));
      fill(black, 13, c.bits, kFaxMakeUp, uint32_t(c.run));
    }
    fill(white, 12, "00000000000", kFaxEol, 0);     // an EOL's 11 zeros
    fill(black, 13, "00000000000", kFaxEol, 0);
    fill(main, 7, "0001", kFaxPass, 0);
    fill(main, 7, "001", kFaxHoriz, 0);
    fill(main, 7, "1", kFaxV0, 0);
    fill(main, 7, "011", kFaxVR, 1);
    fill(main, 7, "000011", kFaxVR, 2);
    fill(main, 7, "0000011", kFaxVR, 3);
    fill(main, 7, "010", kFaxVL, 1);
    fill(main, 7, "000010", kFaxVL, 2);
    fill(main, 7, "0000010", kFaxVL, 3);
    fill(main, 7, "0000001", kFaxExt, 0);
    fill(main, 7, "0000000", kFaxEol, 0);
  }
};

const FaxTables& fax_tables() {
  static const FaxTables tables;   // built once, read by every thread
  return tables;
}

const uint8_t* bit_reversal(bool reverse) {
  struct Table {
    uint8_t v[2][256];
    Table() {
      for (int i = 0; i < 256; i++) {
        int r = 0;
        for (int b = 0; b < 8; b++) r |= ((i >> b) & 1) << (7 - b);
        v[0][i] = uint8_t(i);
        v[1][i] = uint8_t(r);
      }
    }
  };
  static const Table table;
  return table.v[reverse ? 1 : 0];
}

struct Fax {
  enum Mode { kRle, kRlew, kG3, kG3TwoD, kG4 };
  const FaxTables& tab = fax_tables();
  const uint8_t* file;             // RLEW aligns on the file's 16-bit words
  const uint8_t* bitmap;           // each byte's bits, LSB first
  Mode mode;
  int lastx;                       // pixels a row
  size_t nruns;
  std::vector<uint32_t> runs;      // two halves of nruns: rows and reference
  // the state of one call (Fax3PreDecode resets it for each strip or tile)
  const uint8_t* cp = nullptr;
  const uint8_t* ep = nullptr;
  uint32_t acc = 0;
  int avail = 0, eolcnt = 0;
  size_t cur = 0, ref = 0, thisrun = 0, pa = 0, pb = 0;
  int a0 = 0, run_length = 0, b1 = 0;

  Fax(const uint8_t* f, int compression, uint32_t t4, bool lsb_first,
      uint64_t width)
      : file(f), bitmap(bit_reversal(!lsb_first)), lastx(int(width)) {
    mode = compression == 2 ? kRle : compression == 32771 ? kRlew
           : compression == 4 ? kG4 : (t4 & 1) ? kG3TwoD : kG3;
    bool two_d = mode == kG3TwoD || mode == kG4;
    nruns = (size_t(width) + 1 + 31) / 32 * 32 * (two_d ? 2 : 1);
    runs.assign(2 * nruns + 2, 0);
  }

  struct End {};                   // the data ended early
  [[noreturn]] static void truncated() { throw End{}; }
  [[noreturn]] static void overflow() {
    fail("corrupt CCITT data (a row of too many runs)");
  }
  void need8(int k) {
    if (avail < k) {
      if (cp >= ep) {
        if (avail == 0) truncated();
        avail = k;                 // pad with zeros
      } else {
        acc |= uint32_t(bitmap[*cp++]) << avail;
        avail += 8;
      }
    }
  }
  void need16(int k) {
    if (avail < k) {
      if (cp >= ep) {
        if (avail == 0) truncated();
        avail = k;
      } else {
        acc |= uint32_t(bitmap[*cp++]) << avail;
        if ((avail += 8) < k) {
          if (cp >= ep) {
            avail = k;
          } else {
            acc |= uint32_t(bitmap[*cp++]) << avail;
            avail += 8;
          }
        }
      }
    }
  }
  uint32_t get(int k) const { return acc & ((uint32_t(1) << k) - 1); }
  void clr(int k) {
    avail -= k;
    acc >>= k;
  }
  const FaxEntry& lookup8(int k, const FaxEntry* table) {
    need8(k);
    const FaxEntry& e = table[get(k)];
    clr(e.width);
    return e;
  }
  const FaxEntry& lookup16(int k, const FaxEntry* table) {
    need16(k);
    const FaxEntry& e = table[get(k)];
    clr(e.width);
    return e;
  }

  void setvalue(int x) {
    if (pa >= thisrun + nruns) overflow();
    runs[pa++] = uint32_t(run_length + x);
    a0 += x;
    run_length = 0;
  }
  void cleanup_runs() {
    if (run_length) setvalue(0);
    if (a0 != lastx) {             // libtiff warns of a bad line length
      while (a0 > lastx && pa > thisrun) a0 -= int(runs[--pa]);
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if ((pa - thisrun) & 1) setvalue(0);
        setvalue(lastx - a0);
      } else if (a0 > lastx) {
        setvalue(lastx);
        setvalue(0);
      }
    }
  }
  void check_b1() {
    if (pa != thisrun)
      while (b1 <= a0 && b1 < lastx) {
        if (pb + 1 >= ref + nruns) overflow();
        b1 += int(runs[pb] + runs[pb + 1]);
        pb += 2;
      }
  }
  // one colour's run: make-up codes, then a terminating code; false on an
  // unexpected code
  bool span(bool black) {
    for (;;) {
      const FaxEntry& e = black ? lookup16(13, tab.black)
                                : lookup16(12, tab.white);
      if (e.state == (black ? kFaxTermB : kFaxTermW)) {
        setvalue(int(e.param));
        return true;
      }
      if (e.state == (black ? kFaxMakeUpB : kFaxMakeUpW) ||
          e.state == kFaxMakeUp) {
        a0 += int(e.param);
        run_length += int(e.param);
        continue;
      }
      if (e.state == kFaxEol) eolcnt = 1;
      return false;
    }
  }
  void expand1d() {                // EXPAND1D
    for (;;) {
      if (!span(false) || a0 >= lastx) break;
      if (!span(true) || a0 >= lastx) break;
      if (runs[pa - 1] == 0 && runs[pa - 2] == 0) pa -= 2;
    }
    cleanup_runs();
  }
  void expand2d() {                // EXPAND2D
    while (a0 < lastx) {
      if (pa >= thisrun + nruns) overflow();
      const FaxEntry& e = lookup8(7, tab.main);
      switch (e.state) {
        case kFaxPass:
          check_b1();
          if (pb + 1 >= ref + nruns) overflow();
          b1 += int(runs[pb++]);
          run_length += b1 - a0;
          a0 = b1;
          b1 += int(runs[pb++]);
          break;
        case kFaxHoriz: {
          bool black = (pa - thisrun) & 1;
          if (!span(black) || !span(!black)) {
            eolcnt = 0;            // an EOL here is only an unexpected code
            cleanup_runs();
            return;
          }
          check_b1();
          break;
        }
        case kFaxV0:
        case kFaxVR:
          check_b1();
          setvalue(b1 - a0 + int(e.param));
          if (pb >= ref + nruns) overflow();
          b1 += int(runs[pb++]);
          break;
        case kFaxVL:
          check_b1();
          if (b1 < a0 + int(e.param)) {
            cleanup_runs();
            return;
          }
          setvalue(b1 - a0 - int(e.param));
          if (pb <= ref) overflow();
          b1 -= int(runs[--pb]);
          break;
        case kFaxExt:              // uncompressed mode: not read by libtiff
          runs[pa++] = uint32_t(lastx - a0);
          cleanup_runs();
          return;
        case kFaxEol:
          runs[pa++] = uint32_t(lastx - a0);
          need8(4);
          clr(4);
          eolcnt = 1;
          cleanup_runs();
          return;
        default:
          cleanup_runs();
          return;
      }
    }
    if (run_length) {
      if (run_length + a0 < lastx) {   // a final V0 is expected
        need8(1);
        if (!get(1)) {
          cleanup_runs();
          return;
        }
        clr(1);
      }
      setvalue(0);
    }
    cleanup_runs();
  }
  void sync_eol() {                // SYNC_EOL
    if (eolcnt == 0) {
      for (;;) {
        need16(11);
        if (get(11) == 0) break;
        clr(1);
      }
    }
    for (;;) {
      need8(8);
      if (get(8)) break;
      clr(8);
    }
    while (get(1) == 0) clr(1);
    clr(1);
    eolcnt = 0;
  }
  // _TIFFFax3fillruns: white runs clear, black runs set, each run cut to
  // the row (the runs too, as the next row's reference)
  void fill(uint8_t* row) {
    size_t erun = pa;
    if ((erun - thisrun) & 1) runs[erun++] = 0;
    std::memset(row, 0, size_t(lastx + 7) / 8);
    uint32_t x = 0, last = uint32_t(lastx);
    for (size_t r = thisrun; r < erun; r += 2) {
      for (int k = 0; k < 2; k++) {
        uint32_t run = runs[r + size_t(k)];
        if (x + run > last || run > last)
          run = runs[r + size_t(k)] = last - x;
        if (k == 1)
          for (uint32_t i = x; i < x + run; i++)
            row[i >> 3] |= uint8_t(0x80 >> (i & 7));
        x += run;
      }
    }
  }

  // one strip's or tile's data into rows of row_bytes packed 1-bit pixels
  void decode(const uint8_t* in, size_t n, uint8_t* out, size_t rows,
              size_t row_bytes) {
    cp = in;
    ep = in + n;
    acc = 0;
    avail = 0;
    eolcnt = 0;
    cur = 0;
    ref = nruns;
    runs[ref] = uint32_t(lastx);   // the white reference line
    runs[ref + 1] = 0;
    std::memset(out, 0, rows * row_bytes);
    for (size_t y = 0; y < rows; y++) {
      uint8_t* row = out + y * row_bytes;
      a0 = 0;
      run_length = 0;
      pa = thisrun = cur;
      try {
        if (!decode_row(row)) return;
      } catch (const End&) {       // Fax3PrematureEOF: close, fill, stop
        cleanup_runs();
        fill(row);
        return;
      }
    }
  }

  // one row; false when T.6's EOFB came first (the row is filled, and
  // libtiff's decoder stops there)
  bool decode_row(uint8_t* row) {
    switch (mode) {
      case kRle:
      case kRlew:
        expand1d();
        fill(row);
        if (mode == kRle) {
          clr(avail & 7);
        } else {
          clr(avail & 15);
          if (avail == 0 && ((cp - file) & 1)) cp++;
        }
        break;
      case kG3:
        sync_eol();
        expand1d();
        fill(row);
        break;
      case kG3TwoD: {
        sync_eol();
        need8(1);
        bool one_d = get(1);
        clr(1);
        pb = ref;
        b1 = int(runs[pb++]);
        if (one_d) expand1d();
        else expand2d();
        fill(row);
        if (pa < thisrun + nruns) setvalue(0);
        std::swap(cur, ref);
        break;
      }
      case kG4:
        pb = ref;
        b1 = int(runs[pb++]);
        expand2d();
        fill(row);
        if (eolcnt) return false;
        setvalue(0);
        std::swap(cur, ref);
        break;
    }
    return true;
  }
};

// ---- SGILog (tif_luv.c) ----------------------------------------------------
// What the codec gives libtiff's RGBA interface, which asks it for 8-bit
// data (SGILOGDATAFMT_8BIT): LogL16 as grey (L16toGry), LogLuv32 and
// LogLuv24 as RGB through XYZ (Luv32toRGB, Luv24toRGB, XYZtoRGB24), in
// double arithmetic as there; LogLuv24's chroma through uvcode.h's table.
const double kLn2 = 0.69314718055994530942;
const double kUvScale = 410.;
const float kUvSquare = 0.003500f, kUvVStart = 0.016940f;
const double kUNeutral = 0.210526316, kVNeutral = 0.473684211;
const int kUvCodes = 16289, kUvRows = 163;

struct UvRow {
  float ustart;
  int16_t nus, ncum;
};

const UvRow kUvRow[kUvRows] = {
    {0.247663f, 4, 0}, {0.243779f, 6, 4}, {0.241684f, 7, 10},
    {0.237874f, 9, 17}, {0.235906f, 10, 26}, {0.232153f, 12, 36},
    {0.228352f, 14, 48}, {0.226259f, 15, 62}, {0.222371f, 17, 77},
    {0.220410f, 18, 94}, {0.214710f, 21, 112}, {0.212714f, 22, 133},
    {0.210721f, 23, 155}, {0.204976f, 26, 178}, {0.202986f, 27, 204},
    {0.199245f, 29, 231}, {0.195525f, 31, 260}, {0.193560f, 32, 291},
    {0.189878f, 34, 323}, {0.186216f, 36, 357}, {0.186216f, 36, 393},
    {0.182592f, 38, 429}, {0.179003f, 40, 467}, {0.175466f, 42, 507},
    {0.172001f, 44, 549}, {0.172001f, 44, 593}, {0.168612f, 46, 637},
    {0.168612f, 46, 683}, {0.163575f, 49, 729}, {0.158642f, 52, 778},
    {0.158642f, 52, 830}, {0.158642f, 52, 882}, {0.153815f, 55, 934},
    {0.153815f, 55, 989}, {0.149097f, 58, 1044}, {0.149097f, 58, 1102},
    {0.142746f, 62, 1160}, {0.142746f, 62, 1222}, {0.142746f, 62, 1284},
    {0.138270f, 65, 1346}, {0.138270f, 65, 1411}, {0.138270f, 65, 1476},
    {0.132166f, 69, 1541}, {0.132166f, 69, 1610}, {0.126204f, 73, 1679},
    {0.126204f, 73, 1752}, {0.126204f, 73, 1825}, {0.120381f, 77, 1898},
    {0.120381f, 77, 1975}, {0.120381f, 77, 2052}, {0.120381f, 77, 2129},
    {0.112962f, 82, 2206}, {0.112962f, 82, 2288}, {0.112962f, 82, 2370},
    {0.107450f, 86, 2452}, {0.107450f, 86, 2538}, {0.107450f, 86, 2624},
    {0.107450f, 86, 2710}, {0.100343f, 91, 2796}, {0.100343f, 91, 2887},
    {0.100343f, 91, 2978}, {0.095126f, 95, 3069}, {0.095126f, 95, 3164},
    {0.095126f, 95, 3259}, {0.095126f, 95, 3354}, {0.088276f, 100, 3449},
    {0.088276f, 100, 3549}, {0.088276f, 100, 3649}, {0.088276f, 100, 3749},
    {0.081523f, 105, 3849}, {0.081523f, 105, 3954}, {0.081523f, 105, 4059},
    {0.081523f, 105, 4164}, {0.074861f, 110, 4269}, {0.074861f, 110, 4379},
    {0.074861f, 110, 4489}, {0.074861f, 110, 4599}, {0.068290f, 115, 4709},
    {0.068290f, 115, 4824}, {0.068290f, 115, 4939}, {0.068290f, 115, 5054},
    {0.063573f, 119, 5169}, {0.063573f, 119, 5288}, {0.063573f, 119, 5407},
    {0.063573f, 119, 5526}, {0.057219f, 124, 5645}, {0.057219f, 124, 5769},
    {0.057219f, 124, 5893}, {0.057219f, 124, 6017}, {0.050985f, 129, 6141},
    {0.050985f, 129, 6270}, {0.050985f, 129, 6399}, {0.050985f, 129, 6528},
    {0.050985f, 129, 6657}, {0.044859f, 134, 6786}, {0.044859f, 134, 6920},
    {0.044859f, 134, 7054}, {0.044859f, 134, 7188}, {0.040571f, 138, 7322},
    {0.040571f, 138, 7460}, {0.040571f, 138, 7598}, {0.040571f, 138, 7736},
    {0.036339f, 142, 7874}, {0.036339f, 142, 8016}, {0.036339f, 142, 8158},
    {0.036339f, 142, 8300}, {0.032139f, 146, 8442}, {0.032139f, 146, 8588},
    {0.032139f, 146, 8734}, {0.032139f, 146, 8880}, {0.027947f, 150, 9026},
    {0.027947f, 150, 9176}, {0.027947f, 150, 9326}, {0.023739f, 154, 9476},
    {0.023739f, 154, 9630}, {0.023739f, 154, 9784}, {0.023739f, 154, 9938},
    {0.019504f, 158, 10092}, {0.019504f, 158, 10250}, {0.019504f, 158, 10408},
    {0.016976f, 161, 10566}, {0.016976f, 161, 10727}, {0.016976f, 161, 10888},
    {0.016976f, 161, 11049}, {0.012639f, 165, 11210}, {0.012639f, 165, 11375},
    {0.012639f, 165, 11540}, {0.009991f, 168, 11705}, {0.009991f, 168, 11873},
    {0.009991f, 168, 12041}, {0.009016f, 170, 12209}, {0.009016f, 170, 12379},
    {0.009016f, 170, 12549}, {0.006217f, 173, 12719}, {0.006217f, 173, 12892},
    {0.005097f, 175, 13065}, {0.005097f, 175, 13240}, {0.005097f, 175, 13415},
    {0.003909f, 177, 13590}, {0.003909f, 177, 13767}, {0.002340f, 177, 13944},
    {0.002389f, 170, 14121}, {0.001068f, 164, 14291}, {0.001653f, 157, 14455},
    {0.000717f, 150, 14612}, {0.001614f, 143, 14762}, {0.000270f, 136, 14905},
    {0.000484f, 129, 15041}, {0.001103f, 123, 15170}, {0.001242f, 115, 15293},
    {0.001188f, 109, 15408}, {0.001011f, 103, 15517}, {0.000709f, 97, 15620},
    {0.000301f, 89, 15717}, {0.002416f, 82, 15806}, {0.003251f, 76, 15888},
    {0.003246f, 69, 15964}, {0.004141f, 62, 16033}, {0.005963f, 55, 16095},
    {0.008839f, 47, 16150}, {0.010490f, 40, 16197}, {0.016994f, 31, 16237},
    {0.023659f, 21, 16268},
};

double logl16_to_y(int p16) {
  int le = p16 & 0x7fff;
  if (!le) return 0.;
  double y = std::exp(kLn2 / 256. * (le + .5) - kLn2 * 64.);
  return !(p16 & 0x8000) ? y : -y;
}

double logl10_to_y(int p10) {
  if (p10 == 0) return 0.;
  return std::exp(kLn2 / 64. * (p10 + .5) - kLn2 * 12.);
}

uint8_t gamma_byte(double v) {     // 2.0 gamma, as tif_luv.c assumes
  return uint8_t(v <= 0. ? 0 : v >= 1. ? 255 : int(256. * std::sqrt(v)));
}

void xyz_to_rgb24(const float* xyz, uint8_t* rgb) {
  double r = 2.690 * xyz[0] + -1.276 * xyz[1] + -0.414 * xyz[2];
  double g = -1.022 * xyz[0] + 1.978 * xyz[1] + 0.044 * xyz[2];
  double b = 0.061 * xyz[0] + -0.224 * xyz[1] + 1.163 * xyz[2];
  rgb[0] = gamma_byte(r);
  rgb[1] = gamma_byte(g);
  rgb[2] = gamma_byte(b);
}

void uv_to_xyz(double u, double v, double l, float* xyz) {
  double s = 1. / (6. * u - 16. * v + 12.);
  double x = 9. * u * s, y = 4. * v * s;
  xyz[0] = float(x / y * l);
  xyz[1] = float(l);
  xyz[2] = float((1. - x - y) / y * l);
}

void luv32_to_rgb(uint32_t p, uint8_t* rgb) {
  float xyz[3] = {0, 0, 0};
  double l = logl16_to_y(int32_t(p) >> 16);
  if (l > 0.)
    uv_to_xyz(1. / kUvScale * ((p >> 8 & 0xff) + .5),
              1. / kUvScale * ((p & 0xff) + .5), l, xyz);
  xyz_to_rgb24(xyz, rgb);
}

void luv24_to_rgb(uint32_t p, uint8_t* rgb) {
  float xyz[3] = {0, 0, 0};
  double l = logl10_to_y(int(p >> 14 & 0x3ff));
  if (l > 0.) {
    int c = int(p & 0x3fff);
    double u = kUNeutral, v = kVNeutral;
    if (c < kUvCodes) {            // uv_decode's binary search
      int lower = 0, upper = kUvRows;
      while (upper - lower > 1) {
        int vi = (lower + upper) >> 1, ui = c - kUvRow[vi].ncum;
        if (ui > 0) {
          lower = vi;
        } else if (ui < 0) {
          upper = vi;
        } else {
          lower = vi;
          break;
        }
      }
      int ui = c - kUvRow[lower].ncum;
      u = kUvRow[lower].ustart + (ui + .5) * kUvSquare;
      v = kUvVStart + (lower + .5) * kUvSquare;
    }
    uv_to_xyz(u, v, l, xyz);
  }
  xyz_to_rgb24(xyz, rgb);
}

// one row of LogL16Decode's or LogLuvDecode32's run-length byte planes (the
// high plane first) from *bp, cc bytes left; false when the row runs out
template <typename T>
bool sgilog_planes(const uint8_t*& bp, size_t& cc, T* tp, size_t npixels,
                   int planes) {
  std::fill(tp, tp + npixels, T(0));
  for (int shft = 8 * (planes - 1); shft >= 0; shft -= 8) {
    size_t i = 0;
    while (i < npixels && cc > 0) {
      if (*bp >= 128) {            // a run
        if (cc < 2) break;
        int rc = *bp++ + (2 - 128);
        T b = T(uint32_t(*bp++) << shft);
        cc -= 2;
        while (rc-- && i < npixels) tp[i++] |= b;
      } else {                     // literals (a nul count does nothing)
        int rc = *bp++;
        while (--cc && rc-- && i < npixels)
          tp[i++] |= T(uint32_t(*bp++) << shft);
      }
    }
    if (i != npixels) return false;
  }
  return true;
}

// ---- the directory ----------------------------------------------------------
enum {
  kNone = 1, kRle = 2, kG3 = 3, kG4 = 4, kLzw = 5, kOldJpeg = 6, kJpeg = 7,
  kDeflate = 8, kAdobeDeflate = 32946, kPackBits = 32773, kRlew = 32771,
  kSgiLog = 34676, kSgiLog24 = 34677
};
enum { kWhite = 0, kBlack = 1, kRgb = 2, kPalette = 3, kSeparated = 5,
       kYcbcr = 6, kLab = 8, kLogL = 32844, kLogLuv = 32845 };

struct Entry {
  int type = 0;
  uint64_t count = 0, at = 0;      // at: the offset of the values
  bool present = false;
};

struct Tiff {
  const uint8_t* d;
  size_t n;
  bool le = true, big = false;
  uint64_t width = 0, height = 0, rows = 0xFFFFFFFFu, tw = 0, th = 0;
  int bps = 1, spp = 1, compression = kNone, photometric = -1, planar = 1;
  int predictor = 1, orientation = 1, inkset = 1, alpha = 0, extra = 0;
  int sub_h = 2, sub_v = 2, fill_order = 1;
  int sgilog = 0;                  // kLogL or kLogLuv: read as 8 bits
  uint32_t t4 = 0;                 // T4Options
  bool tiled = false;
  // WhitePoint: CIE D50 unless given (TIFFGetFieldDefaulted)
  float white[2] = {96.4250f / (96.4250f + 100.0f + 82.4680f),
                    100.0f / (96.4250f + 100.0f + 82.4680f)};
  float luma[3] = {0.299f, 0.587f, 0.114f};
  float refbw[6] = {0, 255, 128, 255, 128, 255};
  std::vector<uint64_t> offsets, counts;
  std::vector<uint16_t> cmap;
  const uint8_t* tables = nullptr;
  size_t tables_len = 0;

  Tiff(const uint8_t* data, size_t len) : d(data), n(len) {}

  void check(uint64_t at, uint64_t size) const {
    if (at > n || size > n - at) fail("truncated file (an offset or count "
                                      "past its end)");
  }
  uint64_t u(uint64_t at, int size) const {
    check(at, uint64_t(size));
    uint64_t v = 0;
    for (int i = 0; i < size; i++) {
      int k = le ? size - 1 - i : i;
      v = (v << 8) | d[at + uint64_t(k)];
    }
    return v;
  }

  static int type_size(int type) {
    switch (type) {
      case 1: case 2: case 6: case 7: return 1;
      case 3: case 8: return 2;
      case 4: case 9: case 11: case 13: return 4;
      case 5: case 10: case 12: case 16: case 17: case 18: return 8;
    }
    return 0;
  }

  std::vector<uint64_t> ints(const Entry& e) const {
    int s = type_size(e.type);
    if (e.type != 1 && e.type != 3 && e.type != 4 && e.type != 16 &&
        e.type != 13 && e.type != 18)
      fail("a TIFF tag of type " + std::to_string(e.type) + " where an "
           "integer was expected");
    if (e.count > n) fail("a TIFF tag's count exceeds the file");
    std::vector<uint64_t> v(size_t(e.count));
    check(e.at, e.count * uint64_t(s));
    for (size_t i = 0; i < v.size(); i++) v[i] = u(e.at + i * uint64_t(s), s);
    return v;
  }
  uint64_t one(const Entry& e) const {
    std::vector<uint64_t> v = ints(e);
    if (v.empty()) fail("a TIFF tag without a value");
    return v[0];
  }
  std::vector<float> rationals(const Entry& e) const {
    if (e.type != 5) fail("a TIFF rational tag of another type");
    std::vector<float> v(size_t(std::min<uint64_t>(e.count, 16)));
    check(e.at, e.count * 8);
    for (size_t i = 0; i < v.size(); i++) {
      uint64_t num = u(e.at + 8 * i, 4), den = u(e.at + 8 * i + 4, 4);
      v[i] = den ? float(double(num) / double(den)) : 0.0f;
    }
    return v;
  }

  void parse() {
    if (n < 8) fail("not a TIFF file");
    if (d[0] == 'I' && d[1] == 'I') le = true;
    else if (d[0] == 'M' && d[1] == 'M') le = false;
    else fail("not a TIFF file");
    int magic = int(u(2, 2));
    uint64_t ifd;
    if (magic == 42) {
      ifd = u(4, 4);
    } else if (magic == 43) {
      big = true;
      if (u(4, 2) != 8 || u(6, 2) != 0) fail("corrupt BigTIFF header");
      ifd = u(8, 8);
    } else {
      fail("not a TIFF file");
    }
    uint64_t count = u(ifd, big ? 8 : 2);
    uint64_t esize = big ? 20 : 12;
    uint64_t base = ifd + (big ? 8 : 2);
    if (count == 0 || count > n / esize) fail("corrupt TIFF directory");
    check(base, count * esize);
    Entry e_offsets, e_counts, e_cmap, e_extra, e_sub, e_refbw, e_luma,
        e_tables, e_bps, e_format, e_white;
    bool has_photometric = false;
    for (uint64_t i = 0; i < count; i++) {
      uint64_t at = base + i * esize;
      int tag = int(u(at, 2));
      Entry e;
      e.type = int(u(at + 2, 2));
      e.count = u(at + 4, big ? 8 : 4);
      e.present = true;
      uint64_t inline_size = big ? 8 : 4;
      uint64_t vat = at + (big ? 12 : 8);
      int ts = type_size(e.type);
      if (ts == 0) continue;       // an unknown type: libtiff skips the tag
      if (e.count > n) fail("a TIFF tag's count exceeds the file");
      e.at = e.count * uint64_t(ts) <= inline_size ? vat
                                                   : u(vat, big ? 8 : 4);
      switch (tag) {
        case 256: width = one(e); break;
        case 257: height = one(e); break;
        case 258: e_bps = e; break;
        case 259: compression = int(one(e)); break;
        case 262: photometric = int(one(e)); has_photometric = true; break;
        case 266: fill_order = int(one(e)); break;
        case 273: e_offsets = e; break;
        case 274: orientation = int(one(e)); break;
        case 277: spp = int(one(e)); break;
        case 278: rows = one(e); break;
        case 279: e_counts = e; break;
        case 284: planar = int(one(e)); break;
        case 292: t4 = uint32_t(one(e)); break;
        case 317: predictor = int(one(e)); break;
        case 318: e_white = e; break;
        case 320: e_cmap = e; break;
        case 322: tw = one(e); tiled = true; break;
        case 323: th = one(e); tiled = true; break;
        case 324: e_offsets = e; break;
        case 325: e_counts = e; break;
        case 332: inkset = int(one(e)); break;
        case 338: e_extra = e; break;
        case 339: e_format = e; break;
        case 347: e_tables = e; break;
        case 529: e_luma = e; break;
        case 530: e_sub = e; break;
        case 532: e_refbw = e; break;
        default: break;
      }
    }
    if (!has_photometric) photometric = -1;
    if (width == 0 || height == 0) fail("TIFF without a size");
    if (width > kMaxPixels || height > kMaxPixels ||
        width * height > kMaxPixels)
      fail("image of " + std::to_string(width) + " x " +
           std::to_string(height) + " pixels exceeds 2^30");
    if (spp < 1 || spp > 16) fail("TIFF of " + std::to_string(spp) +
                                  " samples a pixel");
    if (spp > 4)                   // OpenCV's readHeader takes 4 at most
      fail("TIFF of " + std::to_string(spp) + " samples a pixel" +
           kOpenCvToo);
    if (e_bps.present) {
      std::vector<uint64_t> v = ints(e_bps);
      if (v.empty()) fail("TIFF BitsPerSample without a value");
      for (uint64_t b : v)
        if (b != v[0]) fail("TIFF with other bit depths per sample");
      bps = int(v[0]);
    }
    if (e_format.present) {
      // signed samples are read by their bits, as libtiff's RGBA interface
      // reads them
      std::vector<uint64_t> v = ints(e_format);
      for (uint64_t f : v) {
        if (f == 3)
          fail("TIFF with floating-point samples: OpenCV does not read them "
               "either");
        if (f == 5 || f == 6)
          fail("TIFF with complex samples: OpenCV does not read them "
               "either");
        if (f == 2 && bps > 16)
          fail(std::to_string(bps) + "-bit signed TIFF samples: OpenCV does "
               "not read them either");
        if (f != 1 && f != 2 && f != 4)
          fail("TIFF SampleFormat " + std::to_string(f) + " is not read");
      }
    }
    switch (compression) {
      case kNone: case kLzw: case kJpeg: case kDeflate: case kAdobeDeflate:
      case kPackBits: case kRle: case kG3: case kG4: case kRlew:
      case kSgiLog: case kSgiLog24:
        break;
      case kOldJpeg:
        fail(std::string("old-style JPEG-compressed TIFF (6)") + kOpenCvToo);
      case 34925: fail(std::string("LZMA-compressed TIFF") + kOpenCvToo);
      case 50000: fail(std::string("ZSTD-compressed TIFF") + kOpenCvToo);
      case 50001: fail(std::string("WebP-compressed TIFF") + kOpenCvToo);
      case 50002:                  // OpenCV returns an all-black image
        fail(std::string("JPEG XL-compressed TIFF") + kOpenCvToo);
      case 34887: fail(std::string("LERC-compressed TIFF") + kOpenCvToo);
      default:
        fail("TIFF compression " + std::to_string(compression) +
             " is not read");
    }
    if (compression == kJpeg && bps == 12)
      fail(std::string("12-bit JPEG-compressed TIFF") + kOpenCvToo);
    if (bps != 1 && bps != 2 && bps != 4 && bps != 8 && bps != 16)
      fail(std::to_string(bps) + "-bit TIFF samples are not read");
    if (planar != 1 && planar != 2) fail("corrupt TIFF PlanarConfiguration");
    if (planar == 2 && spp == 1) planar = 1;
    if (e_extra.present) {
      std::vector<uint64_t> v = ints(e_extra);
      extra = int(v.size());
      if (extra >= spp) fail("corrupt TIFF ExtraSamples");
      if (!v.empty()) {
        if (v[0] == 0) alpha = spp > 3 ? 1 : 0;
        else if (v[0] == 1 || v[0] == 2) alpha = int(v[0]);
      }
    }
    int colour = spp - extra;
    if (photometric < 0) {
      if (colour == 1) photometric = kBlack;
      else if (colour == 3) photometric = kRgb;
      else fail("TIFF without PhotometricInterpretation");
    }
    if (extra == 0 && spp == 4 && photometric == kRgb) alpha = 1;
    // OpenCV's readHeader takes 1, 8 or 16 bits here, and 4 in a palette
    if (bps == 2 || (bps == 4 && photometric != kPalette))
      fail(std::to_string(bps) + "-bit TIFF samples" +
           (bps == 4 ? " outside a palette" : "") +
           ": OpenCV does not read them either");
    // the colour forms of tif_getimage.c's put routines
    switch (photometric) {
      case kWhite: case kBlack:
        if (planar == 1 && spp != 1 && bps < 8)
          fail("TIFF of " + std::to_string(bps) + "-bit grey with extra "
               "samples is not read");
        if (planar == 2 && bps != 8 && bps != 16)
          fail("planar TIFF of " + std::to_string(bps) + "-bit grey is not "
               "read");
        break;
      case kRgb:
        if (colour < 3) fail("RGB TIFF of fewer than 3 colour samples");
        if (bps != 8 && bps != 16)
          fail(std::to_string(bps) + "-bit RGB TIFF is not read");
        break;
      case kPalette:
        if (bps > 8) fail(std::to_string(bps) + "-bit palette TIFF is not "
                          "read");
        if (planar == 2) fail("planar palette TIFF is not read");
        if (planar == 1 && spp != 1 && bps < 8)
          fail("palette TIFF with extra samples is not read");
        if (!e_cmap.present) fail("palette TIFF without a colormap");
        {
          std::vector<uint64_t> v = ints(e_cmap);
          if (v.size() != size_t(3) << bps)
            fail("palette TIFF with a colormap of another size");
          cmap.resize(v.size());
          for (size_t i = 0; i < v.size(); i++) cmap[i] = uint16_t(v[i]);
        }
        break;
      case kSeparated:
        if (inkset != 1) fail("separated TIFF of InkSet " +
                              std::to_string(inkset) + " is not read");
        if (spp < 4) fail("separated TIFF of fewer than 4 samples");
        if (bps != 8) fail(std::to_string(bps) + "-bit CMYK TIFF is not "
                           "read");
        break;
      case kYcbcr:
        if (bps != 8 || spp != 3)
          fail("YCbCr TIFF other than 3 samples of 8 bits is not read");
        if (e_sub.present) {
          std::vector<uint64_t> v = ints(e_sub);
          if (v.size() != 2) fail("corrupt TIFF YCbCrSubSampling");
          sub_h = int(v[0]);
          sub_v = int(v[1]);
        }
        if (compression != kJpeg) {
          int key = (sub_h << 4) | sub_v;
          if (key != 0x44 && key != 0x42 && key != 0x41 && key != 0x22 &&
              key != 0x21 && key != 0x12 && key != 0x11)
            fail("YCbCr TIFF subsampling " + std::to_string(sub_h) + " x " +
                 std::to_string(sub_v) + " is not read");
          if (planar == 2 && key != 0x11)
            fail("planar YCbCr TIFF with subsampling is not read");
        } else if (planar == 2) {
          fail("planar JPEG-compressed YCbCr TIFF is not read");
        }
        if (e_luma.present) {
          std::vector<float> v = rationals(e_luma);
          if (v.size() == 3) std::copy(v.begin(), v.end(), luma);
        }
        if (e_refbw.present) {
          std::vector<float> v = rationals(e_refbw);
          if (v.size() == 6) std::copy(v.begin(), v.end(), refbw);
        }
        break;
      case kLab:                   // TIFFRGBAImageOK's and PickContigCase's
        if (spp != 3 || planar != 1 || (bps != 8 && bps != 16))
          fail("CIE L*a*b* TIFF other than 3 contiguous samples of 8 or 16 "
               "bits" + std::string(kOpenCvToo));
        if (e_white.present) {
          std::vector<float> v = rationals(e_white);
          if (v.size() == 2) std::copy(v.begin(), v.end(), white);
        }
        if (white[1] == 0.0f) fail("TIFF WhitePoint of y 0");
        break;
      case 9:
        fail(std::string("ICC L*a*b* TIFF") + kOpenCvToo);
      case 10:
        fail(std::string("ITU L*a*b* TIFF") + kOpenCvToo);
      case kLogL: case kLogLuv:    // the codec's 8-bit data, as grey or RGB
        if (photometric == kLogL
                ? compression != kSgiLog || spp != 1
                : (compression != kSgiLog && compression != kSgiLog24) ||
                      spp != 3 || planar != 1)
          fail(std::string(photometric == kLogL ? "LogL" : "LogLuv") +
               " TIFF other than SGILog-compressed " +
               (photometric == kLogL ? "(34676) grey"
                                     : "(34676 or 34677) contiguous RGB") +
               kOpenCvToo);
        sgilog = photometric;
        photometric = photometric == kLogL ? kBlack : kRgb;
        bps = 8;
        break;
      default:
        fail("TIFF PhotometricInterpretation " + std::to_string(photometric) +
             " is not read");
    }
    if ((compression == kSgiLog || compression == kSgiLog24) && !sgilog)
      fail(std::string("SGILog-compressed TIFF other than LogL or LogLuv") +
           kOpenCvToo);
    if (compression == kRle || compression == kG3 || compression == kG4 ||
        compression == kRlew) {
      if (bps != 1 || spp != 1 ||
          (photometric != kWhite && photometric != kBlack &&
           photometric != kPalette))
        fail(std::string("CCITT-compressed TIFF other than 1-bit grey or "
                         "palette") + kOpenCvToo);
    }
    if (compression == kJpeg) {
      if (bps != 8)
        fail(std::to_string(bps) + "-bit JPEG-compressed TIFF is not read");
      if (e_tables.present) {
        if (e_tables.type != 7 && e_tables.type != 1)
          fail("corrupt TIFF JPEGTables");
        check(e_tables.at, e_tables.count);
        tables = d + e_tables.at;
        tables_len = size_t(e_tables.count);
      }
    }
    if (predictor != 1 && (compression == kLzw || compression == kDeflate ||
                           compression == kAdobeDeflate)) {
      if (predictor == 3)
        fail(std::string("TIFF floating-point predictor (3)") + kOpenCvToo);
      if (predictor != 2)
        fail("TIFF Predictor " + std::to_string(predictor) + " is not read");
      if (bps != 8 && bps != 16)
        fail("TIFF Predictor 2 at " + std::to_string(bps) + " bits is not "
             "read");
      if (photometric == kYcbcr && (sub_h != 1 || sub_v != 1))
        fail("subsampled YCbCr TIFF with a predictor is not read");
    } else {
      predictor = 1;               // libtiff ignores it there
    }
    if (orientation < 1 || orientation > 8) orientation = 1;
    if (tiled) {
      if (tw == 0 || th == 0) fail("corrupt TIFF tile size");
      if (tw > kMaxPixels || th > kMaxPixels || tw * th > kMaxPixels)
        fail("TIFF tiles past 2^30 pixels");
      // OpenCV 5.0 gives no image for an uncompressed tile of other than
      // a multiple of 1024 bytes (libtiff: "Invalid tile byte count")
      const uint64_t lanes = planar == 2 ? 1 : uint64_t(spp);
      const uint64_t tile_bytes = (tw * lanes * uint64_t(bps) + 7) / 8 * th;
      if (compression == kNone && tile_bytes % 1024)
        fail("uncompressed TIFF tiles of " + std::to_string(tile_bytes) +
             " bytes (not a multiple of 1024): OpenCV does not read them "
             "either");
    } else {
      if (rows == 0) fail("corrupt TIFF RowsPerStrip");
      if (rows > height) rows = height;
    }
    if (!e_offsets.present || !e_counts.present)
      fail("TIFF without strip or tile offsets and byte counts");
    offsets = ints(e_offsets);
    counts = ints(e_counts);
    if (offsets.size() < blocks() || counts.size() < blocks())
      fail("TIFF with fewer strips or tiles than its size needs");
  }

  uint64_t across() const { return tiled ? (width + tw - 1) / tw : 1; }
  uint64_t down() const {
    return tiled ? (height + th - 1) / th : (height + rows - 1) / rows;
  }
  uint64_t planes() const { return planar == 2 ? uint64_t(spp) : 1; }
  uint64_t blocks() const { return across() * down() * planes(); }
};

// ---- colour (tif_getimage.c) ------------------------------------------------
struct Ycc {                       // TIFFYCbCrToRGBInit's tables
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256], y[256];
  Ycc(const float* luma, const float* refbw) {
    const int shift = 16;
    auto fix = [](float x) { return int32_t(x * float(1L << 16) + 0.5f); };
    auto clampf = [](float f, float lo, float hi) {
      return !(f >= lo) ? lo : (f > hi ? hi : f);
    };
    float f1 = 2 - 2 * luma[0];
    int32_t d1 = fix(clampf(f1, 0.0f, 2.0f));
    float f2 = luma[0] * f1 / luma[1];
    int32_t d2 = -fix(clampf(f2, 0.0f, 2.0f));
    float f3 = 2 - 2 * luma[2];
    int32_t d3 = fix(clampf(f3, 0.0f, 2.0f));
    float f4 = luma[2] * f3 / luma[1];
    int32_t d4 = -fix(clampf(f4, 0.0f, 2.0f));
    auto code2v = [](int32_t c, float rb, float rw, float cr) {
      float den = (rw - rb) != 0 ? (rw - rb) : 1.0f;
      return (float(c - int32_t(rb)) * cr) / den;
    };
    auto clampw = [](float f, float lo, float hi) {
      return f < lo ? lo : (f > hi ? hi : f);
    };
    const int32_t one_half = int32_t(1) << (shift - 1);
    for (int i = 0, x = -128; i < 256; i++, x++) {
      int32_t cr = int32_t(clampw(code2v(x, refbw[4] - 128.0f,
                                         refbw[5] - 128.0f, 127),
                                  -128.0f * 32, 128.0f * 32));
      int32_t cb = int32_t(clampw(code2v(x, refbw[2] - 128.0f,
                                         refbw[3] - 128.0f, 127),
                                  -128.0f * 32, 128.0f * 32));
      cr_r[i] = int32_t((int64_t(d1) * cr + one_half) >> shift);
      cb_b[i] = int32_t((int64_t(d3) * cb + one_half) >> shift);
      cr_g[i] = d2 * cr;
      cb_g[i] = d4 * cb + one_half;
      y[i] = int32_t(clampw(code2v(x + 128, refbw[0], refbw[1], 255),
                            -128.0f * 32, 128.0f * 32));
    }
  }
  void bgr(int yy, int cb, int cr, uint8_t* o) const {
    auto clamp = [](int32_t v) {
      return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
    };
    int32_t r = y[yy] + cr_r[cr];
    int32_t g = y[yy] + int32_t((int64_t(cb_g[cb]) + cr_g[cr]) >> 16);
    int32_t b = y[yy] + cb_b[cb];
    o[0] = clamp(b);
    o[1] = clamp(g);
    o[2] = clamp(r);
  }
};

// CIE L*a*b* to RGB as tif_color.c does it for the RGBA interface:
// TIFFCIELabToRGBInit with display_sRGB (whose three guns agree, so one
// table serves them), TIFFCIELab16ToXYZ and TIFFXYZToRGB, in float
struct Lab {
  static const int kRange = 1500;  // CIELABTORGB_TABLE_RANGE
  float step, x0, y0, z0;
  float gun[kRange + 1];

  explicit Lab(const float* white) {
    const double gamma = 1.0 / double(2.4f);
    for (int i = 0; i <= kRange; i++)
      gun[i] = float(255u) * float(std::pow(double(i) / kRange, gamma));
    step = (100.0f - 1.0f) / kRange;
    y0 = 100.0f;
    x0 = white[0] / white[1] * y0;
    z0 = (1.0f - white[0] - white[1]) / white[1] * y0;
  }
  uint8_t value(float lum) const {
    lum = lum > 1.0f ? lum : 1.0f;
    lum = lum < 100.0f ? lum : 100.0f;
    size_t i = size_t((lum - 1.0f) / step);
    i = std::min(size_t(kRange), i);
    float v = gun[i];
    uint32_t c = uint32_t(v > 0 ? v + 0.5 : v - 0.5);
    return uint8_t(std::min(c, 255u));
  }
  // L in [0, 65535], a* and b* as 256 times their value
  void bgr(uint32_t l, int32_t a, int32_t b, uint8_t* o) const {
    float lum = float(l) * 100.0f / 65535.0f, x, y, z, cby;
    if (lum < 8.856f) {
      y = (lum * y0) / 903.292f;
      cby = 7.787f * (y / y0) + 16.0f / 116.0f;
    } else {
      cby = (lum + 16.0f) / 116.0f;
      y = y0 * cby * cby * cby;
    }
    float tmp = float(a) / 256.0f / 500.0f + cby;
    x = tmp < 0.2069f ? x0 * (tmp - 0.13793f) / 7.787f : x0 * tmp * tmp * tmp;
    tmp = cby - float(b) / 256.0f / 200.0f;
    z = tmp < 0.2069f ? z0 * (tmp - 0.13793f) / 7.787f : z0 * tmp * tmp * tmp;
    o[2] = value(3.2410f * x + -1.5374f * y + -0.4986f * z);
    o[1] = value(-0.9692f * x + 1.8760f * y + 0.0416f * z);
    o[0] = value(0.0556f * x + -0.2040f * y + 1.0570f * z);
  }
};

inline uint8_t to8(uint32_t v) { return uint8_t((v + 128) / 257); }
inline uint8_t premul(uint32_t v, uint32_t a) {
  return uint8_t((v * a + 127) / 255);
}

struct Image {
  const Tiff& t;
  uint8_t* out;                    // (height, width, 3) BGR
  uint8_t grey_map[256];           // the BW map for 1-8 bits
  uint8_t pal[256][3];             // RGB
  std::unique_ptr<Ycc> ycc;
  std::unique_ptr<Lab> lab;

  Image(const Tiff& tiff, uint8_t* o) : t(tiff), out(o) {
    if (t.photometric == kWhite || t.photometric == kBlack) {
      int range = t.bps == 16 ? 255 : (1 << t.bps) - 1;
      for (int x = 0; x <= range; x++)
        grey_map[x] = uint8_t(t.photometric == kWhite
                                  ? ((range - x) * 255) / range
                                  : (x * 255) / range);
    }
    if (t.photometric == kPalette) {
      size_t m = size_t(1) << t.bps;
      const uint16_t* r = t.cmap.data();
      const uint16_t* g = r + m;
      const uint16_t* b = g + m;
      bool wide = false;
      for (size_t i = 0; i < m; i++)
        if (r[i] >= 256 || g[i] >= 256 || b[i] >= 256) wide = true;
      std::memset(pal, 0, sizeof(pal));
      for (size_t i = 0; i < m; i++) {
        pal[i][0] = uint8_t(wide ? r[i] >> 8 : r[i]);
        pal[i][1] = uint8_t(wide ? g[i] >> 8 : g[i]);
        pal[i][2] = uint8_t(wide ? b[i] >> 8 : b[i]);
      }
    }
    if (t.photometric == kYcbcr && t.compression != kJpeg)
      ycc.reset(new Ycc(t.luma, t.refbw));
    if (t.photometric == kLab) lab.reset(new Lab(t.white));
  }

  // one row of a block's samples, s(x, c) = row[x * xs + c * cs], uint16,
  // into the image at (y, x0 .. x0 + w)
  void put_row(const uint16_t* row, size_t xs, size_t cs, uint64_t y,
               uint64_t x0, uint64_t w, int photometric, bool separate) {
    uint8_t* o = out + (y * t.width + x0) * 3;
    const int bps = t.bps;
    for (uint64_t x = 0; x < w; x++, o += 3) {
      const uint16_t* p = row + x * xs;
      switch (photometric) {
        case kWhite: case kBlack: {
          uint8_t v;
          if (!separate) {
            v = grey_map[bps == 16 ? p[0] >> 8 : p[0]];
          } else {                 // planar grey: processed as RGB
            uint32_t g = bps == 16 ? to8(p[0]) : p[0];
            if (t.alpha == 2) {
              uint32_t a = bps == 16 ? to8(p[cs]) : p[cs];
              g = premul(g, a);
            }
            v = uint8_t(g);
          }
          o[0] = o[1] = o[2] = v;
          break;
        }
        case kRgb: {
          uint32_t r = p[0], g = p[cs], b = p[2 * cs];
          if (bps == 16) {
            r = to8(r);
            g = to8(g);
            b = to8(b);
          }
          if (t.alpha == 2) {
            uint32_t a = p[3 * cs];
            if (bps == 16) a = to8(a);
            r = premul(r, a);
            g = premul(g, a);
            b = premul(b, a);
          }
          o[0] = uint8_t(b);
          o[1] = uint8_t(g);
          o[2] = uint8_t(r);
          break;
        }
        case kPalette: {
          const uint8_t* c = pal[p[0]];
          o[0] = c[2];
          o[1] = c[1];
          o[2] = c[0];
          break;
        }
        case kSeparated: {
          uint32_t k = 255 - p[3 * cs];
          o[2] = uint8_t((k * (255 - p[0])) / 255);
          o[1] = uint8_t((k * (255 - p[cs])) / 255);
          o[0] = uint8_t((k * (255 - p[2 * cs])) / 255);
          break;
        }
        case kYcbcr:               // planar, 1 x 1
          ycc->bgr(p[0], p[cs], p[2 * cs], o);
          break;
        case kLab:                 // a* and b* signed
          if (bps == 8)
            lab->bgr(uint32_t(p[0]) * 257, int8_t(p[cs]) * 256,
                     int8_t(p[2 * cs]) * 256, o);
          else
            lab->bgr(p[0], int16_t(p[cs]), int16_t(p[2 * cs]), o);
          break;
      }
    }
  }
};

// ---- decoding ---------------------------------------------------------------
struct Decoder {
  Tiff t;
  std::unique_ptr<Fax> fax;        // its runs carry over between blocks
  explicit Decoder(const uint8_t* d, size_t n) : t(d, n) {}

  // a strip's or tile's stored bytes, each byte's bits reversed for
  // FillOrder 2 into `copy` (CCITT reverses them as it reads)
  const uint8_t* raw(uint64_t index, size_t& n, std::vector<uint8_t>& copy) {
    uint64_t off = t.offsets[size_t(index)], cnt = t.counts[size_t(index)];
    t.check(off, cnt);
    n = size_t(cnt);
    if (t.fill_order != 2 || t.compression == kRle ||
        t.compression == kG3 || t.compression == kG4 ||
        t.compression == kRlew)
      return t.d + off;
    const uint8_t* rev = bit_reversal(true);
    copy.resize(n);
    for (size_t i = 0; i < n; i++) copy[i] = rev[t.d[off + i]];
    return copy.data();
  }

  // a strip's or tile's bytes decompressed: want bytes (rows of row_bytes)
  void decompress(uint64_t index, uint8_t* out, size_t want,
                  size_t row_bytes) {
    std::vector<uint8_t> copy;
    size_t n;
    const uint8_t* in = raw(index, n, copy);
    switch (t.compression) {
      case kNone:
        if (n < want) fail("truncated TIFF strip or tile");
        std::memcpy(out, in, want);
        break;
      case kLzw:
        lzw_decode(in, n, out, want);
        break;
      case kPackBits:
        packbits_decode(in, n, out, want);
        break;
      case kDeflate: case kAdobeDeflate: {
        Inflater f{in, n};
        f.run(out, want);
        break;
      }
      case kRle: case kG3: case kG4: case kRlew:
        if (!fax)
          fax.reset(new Fax(t.d, t.compression, t.t4, t.fill_order == 2,
                            t.tiled ? t.tw : t.width));
        fax->decode(in, n, out, want / row_bytes, row_bytes);
        break;
    }
  }

  // SGILog: each row's LogL16, LogLuv32 or LogLuv24 pixels as 8-bit grey
  // or RGB (LogLuvDecodeStrip / Tile: row by row through the block's data)
  void sgilog_block(Image& img, uint64_t block, uint64_t bw, uint64_t rows,
                    uint64_t x0, uint64_t y0, uint64_t w, uint64_t h) {
    std::vector<uint8_t> copy;
    size_t cc;
    const uint8_t* bp = raw(block, cc, copy);
    const size_t npixels = size_t(bw);
    const bool luv = t.sgilog == kLogLuv;
    std::vector<int16_t> l16(luv ? 0 : npixels);
    std::vector<uint32_t> luv32(luv ? npixels : 0);
    std::vector<uint16_t> row(npixels * (luv ? 3 : 1));
    uint8_t rgb[3];
    for (uint64_t r = 0; r < rows; r++) {
      bool ok;
      if (!luv) {
        ok = sgilog_planes(bp, cc, l16.data(), npixels, 2);
      } else if (t.compression == kSgiLog) {
        ok = sgilog_planes(bp, cc, luv32.data(), npixels, 4);
      } else {                     // LogLuvDecode24: 3 bytes a pixel
        size_t i = 0;
        for (; i < npixels && cc >= 3; i++, bp += 3, cc -= 3)
          luv32[i] = uint32_t(bp[0]) << 16 | uint32_t(bp[1]) << 8 | bp[2];
        ok = i == npixels;
      }
      if (!ok) fail("not enough SGILog data for the strip or tile");
      if (r >= h) continue;
      for (size_t x = 0; x < npixels; x++) {
        if (!luv) {
          row[x] = gamma_byte(logl16_to_y(l16[x]));
          continue;
        }
        if (t.compression == kSgiLog) luv32_to_rgb(luv32[x], rgb);
        else luv24_to_rgb(luv32[x], rgb);
        for (int c = 0; c < 3; c++) row[3 * x + size_t(c)] = rgb[c];
      }
      img.put_row(row.data(), luv ? 3 : 1, 1, y0 + r, x0, w, t.photometric,
                  false);
    }
  }

  void run(uint8_t* out) {
    Image img(t, out);
    const uint64_t bw = t.tiled ? t.tw : t.width;
    const uint64_t bh = t.tiled ? t.th : t.rows;
    const bool separate = t.planar == 2;
    const int spp = t.spp;
    const int lanes = separate ? 1 : spp;          // samples in a plane row
    const bool ycc_sub = t.photometric == kYcbcr && t.compression != kJpeg &&
                         (t.sub_h != 1 || t.sub_v != 1);
    for (uint64_t by = 0; by < t.down(); by++) {
      for (uint64_t bx = 0; bx < t.across(); bx++) {
        uint64_t x0 = bx * bw, y0 = by * bh;
        uint64_t rows = t.tiled ? bh : std::min(bh, t.height - y0);
        uint64_t w = std::min(bw, t.width - x0);   // pixels kept
        uint64_t h = std::min(rows, t.height - y0);
        uint64_t block = by * t.across() + bx;
        if (t.compression == kJpeg) {
          jpeg_block(img, block, bw, rows, x0, y0, w, h);
          continue;
        }
        if (ycc_sub) {
          ycc_block(img, block, bw, rows, x0, y0, w, h);
          continue;
        }
        if (t.sgilog) {
          sgilog_block(img, block, bw, rows, x0, y0, w, h);
          continue;
        }
        const size_t row_bytes = size_t((bw * uint64_t(lanes) *
                                         uint64_t(t.bps) + 7) / 8);
        const size_t plane_bytes = row_bytes * size_t(rows);
        std::vector<Buffer> planes;
        for (uint64_t p = 0; p < t.planes(); p++) {
          planes.emplace_back(plane_bytes);
          decompress(p * t.across() * t.down() + block, planes.back().data(),
                     plane_bytes, row_bytes);
          if (t.bps == 16 && !t.le) {
            uint8_t* q = planes.back().data();
            for (size_t i = 0; i + 1 < plane_bytes; i += 2)
              std::swap(q[i], q[i + 1]);
          }
          if (t.predictor == 2) undo_predictor(planes.back().data(), row_bytes,
                                               size_t(rows), size_t(bw), lanes);
        }
        // tif_getimage.c's grey and palette put routines step a tile cut
        // at the right edge (w < bw) on by bw - w bytes a row, not pixels:
        // where a pixel is more than a byte (16-bit grey, 8-bit grey or
        // palette with extra samples), its rows are read from there, as
        // OpenCV reads them
        const size_t pixel_bytes = size_t(spp) * size_t(t.bps) / 8;
        const bool skewed =
            t.tiled && !separate && w < bw && pixel_bytes > 1 &&
            (t.photometric == kWhite || t.photometric == kBlack ||
             t.photometric == kPalette);
        const size_t stride = skewed ? size_t(w) * pixel_bytes +
                                           size_t(bw - w)
                                     : row_bytes;
        // one row of samples, contiguous (x * spp + c) or planar (c * bw + x)
        std::vector<uint16_t> row(size_t(bw) * size_t(spp));
        for (uint64_t r = 0; r < h; r++) {
          for (size_t p = 0; p < planes.size(); p++) {
            const uint8_t* src = planes[p].data() + size_t(r) * stride;
            uint16_t* dst = row.data() + p * size_t(bw);
            size_t count = size_t(skewed ? w : bw) * size_t(lanes);
            unpack(src, dst, count);
          }
          if (separate)
            img.put_row(row.data(), 1, size_t(bw), y0 + r, x0, w,
                        t.photometric, true);
          else
            img.put_row(row.data(), size_t(spp), 1, y0 + r, x0, w,
                        t.photometric, false);
        }
      }
    }
  }

  void unpack(const uint8_t* src, uint16_t* dst, size_t count) const {
    switch (t.bps) {
      case 8:
        for (size_t i = 0; i < count; i++) dst[i] = src[i];
        break;
      case 16:
        std::memcpy(dst, src, count * 2);
        break;
      default: {
        int b = t.bps, per = 8 / b, mask = (1 << b) - 1;
        for (size_t i = 0; i < count; i++) {
          int shift = 8 - b * (int(i % size_t(per)) + 1);
          dst[i] = uint16_t((src[i / size_t(per)] >> shift) & mask);
        }
      }
    }
  }

  void undo_predictor(uint8_t* data, size_t row_bytes, size_t rows, size_t bw,
                      int lanes) const {
    size_t stride = size_t(lanes);
    for (size_t r = 0; r < rows; r++) {
      if (t.bps == 8) {
        uint8_t* p = data + r * row_bytes;
        for (size_t i = stride; i < bw * stride; i++)
          p[i] = uint8_t(p[i] + p[i - stride]);
      } else {
        uint16_t* p = reinterpret_cast<uint16_t*>(data + r * row_bytes);
        for (size_t i = stride; i < bw * stride; i++)
          p[i] = uint16_t(p[i] + p[i - stride]);
      }
    }
  }

  // subsampled YCbCr: units of sub_h x sub_v luma samples, then Cb and Cr
  void ycc_block(Image& img, uint64_t block, uint64_t bw, uint64_t rows,
                 uint64_t x0, uint64_t y0, uint64_t w, uint64_t h) {
    const uint64_t sh = uint64_t(t.sub_h), sv = uint64_t(t.sub_v);
    const uint64_t ua = (bw + sh - 1) / sh, ud = (rows + sv - 1) / sv;
    const uint64_t unit = sh * sv + 2;
    Buffer data(size_t(ua * ud * unit));
    decompress(block, data.data(), data.size, data.size);
    for (uint64_t uy = 0; uy < ud; uy++)
      for (uint64_t ux = 0; ux < ua; ux++) {
        const uint8_t* u = data.data() + (uy * ua + ux) * unit;
        int cb = u[sh * sv], cr = u[sh * sv + 1];
        for (uint64_t j = 0; j < sv; j++)
          for (uint64_t i = 0; i < sh; i++) {
            uint64_t y = uy * sv + j, x = ux * sh + i;
            if (y >= h || x >= w) continue;
            img.ycc->bgr(u[j * sh + i], cb, cr,
                         img.out + ((y0 + y) * t.width + x0 + x) * 3);
          }
      }
  }

  // JPEG (7): the tables, then the strip's or tile's stream
  void jpeg_block(Image& img, uint64_t block, uint64_t bw, uint64_t rows,
                  uint64_t x0, uint64_t y0, uint64_t w, uint64_t h) {
    uint64_t off = t.offsets[size_t(block)], cnt = t.counts[size_t(block)];
    t.check(off, cnt);
    const int mode = t.photometric == kYcbcr ? 1 : 0;
    const int channels = t.photometric == kYcbcr ? 3 : t.spp;
    if (t.planar == 2) fail("planar JPEG-compressed TIFF is not read");
    Buffer rgb(size_t(bw * rows) * size_t(channels));
    char err[256];
    if (oodt_jpeg_decode_segment(t.tables, int64_t(t.tables_len),
                                 t.d + off, int64_t(cnt), mode, rgb.data(),
                                 int64_t(rows), int64_t(bw), channels, err,
                                 sizeof(err)))
      fail(std::string("JPEG strip or tile: ") + err);
    std::vector<uint16_t> row(size_t(bw) * size_t(channels));
    int photometric = t.photometric == kYcbcr ? kRgb : t.photometric;
    for (uint64_t r = 0; r < h; r++) {
      const uint8_t* src = rgb.data() + size_t(r * bw) * size_t(channels);
      for (size_t i = 0; i < row.size(); i++) row[i] = src[i];
      img.put_row(row.data(), size_t(channels), 1, y0 + r, x0, w,
                  photometric, false);
    }
  }
};

// ---- the writer -------------------------------------------------------------
std::vector<uint8_t> encode(const uint8_t* img, uint64_t h, uint64_t w,
                            int channels, int bps, int format) {
  if (h < 1 || w < 1 || h > 0xFFFFFFFFu || w > 0xFFFFFFFFu)
    fail("TIFF sides are 1 to 2^32 - 1 pixels");
  if (channels != 1 && channels != 3 && channels != 4)
    fail("1, 3 or 4 channels are written");
  if (bps != 1 && bps != 2 && bps != 4 && bps != 8)
    fail("samples of 1, 2, 4 or 8 bytes are written");
  // floats are stored uncompressed; integers through Predictor 2 and LZW
  const bool lzw = format != 3;
  const uint64_t step = w * uint64_t(channels) * uint64_t(bps);
  const uint64_t px = uint64_t(channels) * uint64_t(bps);
  uint64_t rps = std::max<uint64_t>(1, std::min<uint64_t>(h, 8192 / step));
  const uint64_t nstrips = (h + rps - 1) / rps;
  std::vector<uint8_t> o = {'I', 'I', 42, 0, 0, 0, 0, 0};
  std::vector<uint64_t> offsets, counts;
  std::vector<uint8_t> rows(size_t(rps * step));
  for (uint64_t s = 0; s < nstrips; s++) {
    uint64_t r0 = s * rps, nr = std::min(rps, h - r0);
    for (uint64_t r = 0; r < nr; r++) {
      const uint8_t* src = img + (r0 + r) * step;
      uint8_t* dst = rows.data() + r * step;
      std::memcpy(dst, src, size_t(step));
      if (channels >= 3)                          // BGR(A) -> RGB(A)
        for (uint64_t x = 0; x < w; x++)
          for (int b = 0; b < bps; b++)
            std::swap(dst[x * px + b], dst[x * px + 2 * bps + b]);
      if (!lzw) continue;
      // Predictor 2: each sample less the one a pixel before, modulo its
      // width (little-endian words)
      for (uint64_t i = w - 1; i >= 1; i--)
        for (int c = 0; c < channels; c++) {
          uint8_t* cur = dst + i * px + c * bps;
          const uint8_t* prev = cur - px;
          unsigned borrow = 0;
          for (int b = 0; b < bps; b++) {
            unsigned d = unsigned(cur[b]) - prev[b] - borrow;
            cur[b] = uint8_t(d);
            borrow = (d >> 8) & 1;
          }
        }
    }
    offsets.push_back(o.size());
    if (lzw) {
      lzw_encode(rows.data(), size_t(nr * step), o);
    } else {
      o.insert(o.end(), rows.begin(), rows.begin() + ptrdiff_t(nr * step));
    }
    counts.push_back(o.size() - offsets.back());
  }
  if (o.size() & 1) o.push_back(0);
  if (o.size() > 0xFFFFFFFFu) fail("TIFF past 4 GiB is not written");
  const uint32_t ifd = uint32_t(o.size());
  // libtiff writes StripByteCounts as SHORT when there are several strips
  // of fewer than 0xFFFF / 10 bytes (LZW's worst case) or, uncompressed,
  // of at most 0xFFFF bytes, else LONG
  const bool short_counts = nstrips > 1 && (lzw ? rps * step < 0xFFFF / 10
                                                : rps * step <= 0xFFFF);
  struct Tag {
    int tag, type;
    uint64_t count;
    std::vector<uint64_t> values;
  };
  auto shortlong = [](uint64_t v) { return v <= 0xFFFF ? 3 : 4; };
  std::vector<Tag> tags = {
      {256, shortlong(w), 1, {w}},
      {257, shortlong(h), 1, {h}},
      {258, 3, uint64_t(channels),
       std::vector<uint64_t>(size_t(channels), uint64_t(8 * bps))},
      {259, 3, 1, {uint64_t(lzw ? kLzw : 1)}},
      {262, 3, 1, {uint64_t(channels >= 3 ? kRgb : kBlack)}},
      {273, 4, nstrips, offsets},
      {277, 3, 1, {uint64_t(channels)}},
      {278, shortlong(rps), 1, {rps}},
      {279, short_counts ? 3 : 4, nstrips, counts},
      {284, 3, 1, {1}},
      {317, 3, 1, {2}},
      {339, 3, uint64_t(channels),
       std::vector<uint64_t>(size_t(channels), uint64_t(format))}};
  if (!lzw)                                       // no Predictor
    tags.erase(tags.begin() + 10);
  // the values that do not fit an entry, in libtiff's order
  const int order[] = {258, 279, 273, 339};
  uint64_t data_at = uint64_t(ifd) + 2 + 12 * tags.size() + 4;
  std::vector<uint64_t> at(tags.size(), 0);
  for (int want : order)
    for (size_t i = 0; i < tags.size(); i++) {
      const Tag& g = tags[i];
      uint64_t size = g.count * (g.type == 3 ? 2 : 4);
      if (g.tag == want && size > 4) {
        at[i] = data_at;
        data_at += size;
      }
    }
  if (data_at > 0xFFFFFFFFu) fail("TIFF past 4 GiB is not written");
  auto put = [&](uint64_t v, int size) {
    for (int i = 0; i < size; i++) o.push_back(uint8_t(v >> (8 * i)));
  };
  put(tags.size(), 2);
  for (size_t i = 0; i < tags.size(); i++) {
    const Tag& g = tags[i];
    int s = g.type == 3 ? 2 : 4;
    put(uint64_t(g.tag), 2);
    put(uint64_t(g.type), 2);
    put(g.count, 4);
    if (g.count * uint64_t(s) > 4) {
      put(at[i], 4);
    } else {
      for (uint64_t v : g.values) put(v, s);
      for (uint64_t k = g.count * uint64_t(s); k < 4; k++) o.push_back(0);
    }
  }
  put(0, 4);
  for (int want : order)
    for (size_t i = 0; i < tags.size(); i++) {
      const Tag& g = tags[i];
      int s = g.type == 3 ? 2 : 4;
      if (g.tag == want && g.count * uint64_t(s) > 4)
        for (uint64_t v : g.values) put(v, s);
    }
  o[4] = uint8_t(ifd);
  o[5] = uint8_t(ifd >> 8);
  o[6] = uint8_t(ifd >> 16);
  o[7] = uint8_t(ifd >> 24);
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

// The first page's stored size and orientation: dims = {height, width,
// orientation}. Returns 0, or -1 with a message in err.
int oodt_tiff_info(const uint8_t* data, int64_t len, int64_t* dims, char* err,
                   int64_t errlen) {
  try {
    Tiff t(data, size_t(len));
    t.parse();
    dims[0] = int64_t(t.height);
    dims[1] = int64_t(t.width);
    dims[2] = t.orientation;
    return 0;
  } catch (const TiffError& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

// Decode the first page into out, (height, width, 3) uint8 BGR of the size
// oodt_tiff_info gave, in stored order (the orientation not applied).
// Returns 0, or -1 with a message in err.
int oodt_tiff_decode(const uint8_t* data, int64_t len, uint8_t* out,
                     int64_t height, int64_t width, char* err,
                     int64_t errlen) {
  try {
    Decoder d(data, size_t(len));
    d.t.parse();
    if (int64_t(d.t.height) != height || int64_t(d.t.width) != width)
      fail("the image's size is not the one given");
    d.run(out);
    return 0;
  } catch (const TiffError& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

// Encode (h, w, channels) samples (grey, BGR or BGRA) of bps bytes each,
// little-endian, of SampleFormat format (1 unsigned, 2 signed, 3 float) as
// cv2.imwrite writes a .tif. Returns the file's size, writing it into out
// when it fits in cap bytes (call again with a larger buffer otherwise),
// or -1 with a message in err.
int64_t oodt_tiff_encode(const uint8_t* img, int64_t h, int64_t w,
                         int64_t channels, int64_t bps, int64_t format,
                         uint8_t* out, int64_t cap, char* err,
                         int64_t errlen) {
  try {
    std::vector<uint8_t> o = encode(img, uint64_t(h), uint64_t(w),
                                    int(channels), int(bps), int(format));
    if (int64_t(o.size()) <= cap) std::memcpy(out, o.data(), o.size());
    return int64_t(o.size());
  } catch (const TiffError& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

}  // extern "C"
