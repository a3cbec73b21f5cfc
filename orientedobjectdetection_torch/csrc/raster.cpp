// Readers of the PNM, PAM, PFM, Sun raster and Radiance HDR forms, and the
// Radiance HDR writer, on the host (C++17, no dependencies), after what
// OpenCV 5.0's imdecode (grfmt_pxm.cpp, grfmt_pam.cpp, grfmt_pfm.cpp,
// grfmt_sunras.cpp, grfmt_hdr.cpp with rgbe.cpp) gives with IMREAD_COLOR
// and its imencode writes for the JAX package.
//
// Each reader walks the bytes as OpenCV's byte stream does: a read past the
// end fails the decode, and so does every check OpenCV makes (its messages
// are kept where a form is refused). The output is what IMREAD_COLOR gives:
// (height, width, 3) uint8 BGR, but for a grey PFM ("Pf"), which OpenCV
// converts to (height, width) uint8 and returns so.
//
//   - PNM (P1-P6): the header's numbers after any whitespace and '#'
//     comments, each ended by one byte it consumes (P1's one-digit samples
//     are not); maxval 1-65535. ASCII samples above maxval are cut to it,
//     and 8-bit ones scaled to 0-255 as v * 255 / maxval; binary 8-bit
//     samples are taken as stored, unscaled; 16-bit ones (maxval > 255) by
//     their high byte, unscaled. P1 / P4: 1 is black.
//   - PAM (P7): WIDTH, HEIGHT, DEPTH, MAXVAL (decimal numbers), TUPLTYPE
//     and ENDHDR lines (names in capitals), '#' comments. MAXVAL 1 reads every
//     row's bytes as packed bits (OpenCV's reader does, whatever DEPTH is);
//     otherwise DEPTH 1 is grey and DEPTH 3 is taken as BGR as stored (the
//     order OpenCV's writer stores), 16-bit samples by their high byte.
//     DEPTH 2 and 4 are refused: OpenCV's reader converts only the first
//     width / DEPTH pixels of each row and leaves the rest unset.
//   - PFM (PF / Pf): width, height and scale each up to the next
//     whitespace byte; a negative scale is little-endian; rows bottom-up;
//     RGB to BGR; the samples times 1 / |scale| in float32, then rounded
//     and saturated to uint8.
//   - Sun raster: RT_OLD and RT_STANDARD at 1, 8, 24 and 32 bits, no
//     colour map or an RMT_EQUAL_RGB one (entries past it black); rows
//     padded to 16 bits; 24-bit pixels BGR, 32-bit ones XBGR. OpenCV 5.0
//     reads no other type: RT_BYTE_ENCODED (the RLE), RT_FORMAT_RGB and the
//     rest are refused, as is an RMT_EQUAL_RGB map of no entries.
//   - Radiance HDR: "#?RADIANCE" or "#?RGBE", header lines up to
//     "FORMAT=32-bit_rle_rgbe", then an empty line, then "-Y <h> +X <w>"
//     (the one orientation OpenCV reads); flat pixels, new-style RLE
//     scanlines (widths 8 to 32767), old-style RLE read as flat pixels, as
//     OpenCV reads them; each (r, g, b, e) to float32 as r * 2^(e - 136),
//     then rounded from v * 255 and saturated to uint8.
//
// Writer: oodt_hdr_encode, what cv2.imencode(".hdr") writes of float32 BGR:
// the header above, then RGBE_WritePixels_RLE's scanlines (flat where the
// width is under 8 or over 32767).
//
// A plain C ABI, loaded with ctypes (native.py builds it into one library
// with the other host sources). No global state: calls from several
// threads run in parallel.

#include <cctype>
#include <cerrno>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

struct RasterError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw RasterError{msg}; }

const char* const kOpenCvToo = ": OpenCV does not read it either";
// OpenCV's limits (CV_IO_MAX_IMAGE_WIDTH, _HEIGHT, _PIXELS)
const int64_t kMaxSide = int64_t(1) << 20;
const int64_t kMaxPixels = int64_t(1) << 30;

enum Form { kPnm = 1, kPam, kPfm, kSun, kHdr };

// OpenCV's RLByteStream over the file's bytes: a read past the end fails
struct Stream {
  const uint8_t* data;
  size_t len, pos = 0;
  Stream(const uint8_t* d, size_t n) : data(d), len(n) {}
  int byte() {
    if (pos >= len) fail("the file ends early");
    return data[pos++];
  }
  void bytes(uint8_t* out, size_t n) {
    if (n > len - pos) fail("the file ends early");
    std::memcpy(out, data + pos, n);
    pos += n;
  }
  uint32_t be32() {
    uint32_t v = 0;
    for (int i = 0; i < 4; i++) v = v << 8 | uint32_t(byte());
    return v;
  }
};

void check_size(int64_t w, int64_t h) {
  if (w <= 0 || h <= 0) fail("an image of no pixels");
  if (w > kMaxSide || h > kMaxSide || w * h > kMaxPixels)
    fail("past OpenCV's image size limit" + std::string(kOpenCvToo));
}

// saturate_cast<uchar>(float): rounded half to even; what cvRound cannot
// hold (NaN, the infinities, |v| >= 2^31) gives 0
inline uint8_t sat_u8(float v) {
  if (!(std::fabs(v) < 2147483648.0f)) return 0;
  float r = std::nearbyint(v);
  return r <= 0 ? 0 : r >= 255 ? 255 : uint8_t(r);
}

// ---- PNM ----------------------------------------------------------------
// grfmt_pxm.cpp's ReadNumber: whitespace and '#' comments before the
// digits; the byte after the digits is consumed unless maxdigits stopped it
int read_number(Stream& s, int maxdigits) {
  int code = s.byte();
  while (!std::isdigit(code)) {
    if (code == '#') {
      do code = s.byte(); while (code != '\n' && code != '\r');
      code = s.byte();
    } else if (std::isspace(code)) {
      while (std::isspace(code)) code = s.byte();
    } else {
      fail("PXM: unexpected byte " + std::to_string(code) + " in a number");
    }
  }
  int64_t val = 0;
  int digits = 0;
  do {
    val = val * 10 + (code - '0');
    if (val > INT_MAX) fail("PXM: a number past INT_MAX");
    digits++;
    if (maxdigits != 0 && digits >= maxdigits) break;
    code = s.byte();
  } while (std::isdigit(code));
  return int(val);
}

struct Image {
  int64_t h = 0, w = 0, c = 3;
};

struct Pnm {
  Stream s;
  int kind = 0, bpp = 0, maxval = 1;
  bool binary = false;
  Image img;
  Pnm(const uint8_t* d, size_t n) : s(d, n) {}
  void header() {
    if (s.byte() != 'P') fail("not a PNM file");
    kind = s.byte();
    if (kind < '1' || kind > '6') fail("not a PNM file");
    bpp = (kind == '1' || kind == '4') ? 1 : (kind == '2' || kind == '5')
                                                 ? 8 : 24;
    binary = kind >= '4';
    img.w = read_number(s, INT_MAX);
    img.h = read_number(s, INT_MAX);
    if (bpp > 1) maxval = read_number(s, INT_MAX);
    if (maxval > 65535) fail("PNM maxval past 65535" + std::string(kOpenCvToo));
    if (maxval <= 0) fail("PNM maxval 0" + std::string(kOpenCvToo));
    check_size(img.w, img.h);
  }
  void decode(uint8_t* out) {
    const int64_t w = img.w, h = img.h;
    const bool wide = maxval > 255;
    const int nch = bpp == 24 ? 3 : 1;
    uint8_t lut[256] = {0};          // ASCII 8-bit samples to 0-255
    if (!wide)
      for (int i = 0; i <= maxval; i++)
        lut[i] = uint8_t(i * 255 / maxval);
    std::vector<uint8_t> row(size_t(w * nch));
    std::vector<uint8_t> raw;
    if (binary)
      raw.resize(bpp == 1 ? size_t((w + 7) / 8)
                          : size_t(w * nch * (wide ? 2 : 1)));
    for (int64_t y = 0; y < h; y++) {
      uint8_t* o = out + y * w * 3;
      if (bpp == 1) {
        if (binary) {
          s.bytes(raw.data(), raw.size());
          for (int64_t x = 0; x < w; x++)
            row[size_t(x)] = raw[size_t(x >> 3)] >> (7 - (x & 7)) & 1;
        } else {
          for (int64_t x = 0; x < w; x++)
            row[size_t(x)] = read_number(s, 1) != 0;
        }
        for (int64_t x = 0; x < w; x++)       // 1 is black
          o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = row[size_t(x)] ? 0 : 255;
        continue;
      }
      if (binary) {
        s.bytes(raw.data(), raw.size());
        for (int64_t i = 0; i < w * nch; i++)   // the high byte of 16
          row[size_t(i)] = wide ? raw[size_t(2 * i)] : raw[size_t(i)];
      } else {
        for (int64_t i = 0; i < w * nch; i++) {
          int code = read_number(s, 0);
          if (code > maxval) code = maxval;
          row[size_t(i)] = wide ? uint8_t(code >> 8) : lut[code];
        }
      }
      for (int64_t x = 0; x < w; x++) {
        if (nch == 1) {
          o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = row[size_t(x)];
        } else {                                  // RGB -> BGR
          o[3 * x] = row[size_t(3 * x + 2)];
          o[3 * x + 1] = row[size_t(3 * x + 1)];
          o[3 * x + 2] = row[size_t(3 * x)];
        }
      }
    }
  }
};

// ---- PAM ----------------------------------------------------------------
enum PamField { kNone, kComment, kEnd, kHeight, kWidth, kDepth, kMaxval,
                kTupltype };

struct Pam {
  Stream s;
  Image img;
  int64_t depth = 0, maxval = 0;
  Pam(const uint8_t* d, size_t n) : s(d, n) {}

  // one header line: its field and value (grfmt_pam.cpp's
  // ReadPAMHeaderLine)
  PamField line(std::string& value) {
    int code = s.byte();
    while (code == ' ' || code == '\t') code = s.byte();
    if (code == '#') {
      do code = s.byte(); while (code != '\n' && code != '\r');
      return kComment;
    }
    if (code == '\n' || code == '\r') return kNone;
    std::string ident;
    while (!std::isspace(code) && ident.size() < 255) {
      ident.push_back(char(code));
      code = s.byte();
    }
    value.clear();
    if (ident == "ENDHDR") {
      if (code != '\n' && code != '\r')
        fail("PAM: ENDHDR not at the end of its line" +
             std::string(kOpenCvToo));
      return kEnd;
    }
    if (code != '\n' && code != '\r') {
      while (code == ' ' || code == '\t') code = s.byte();
      while (code != '\n' && code != '\r' && value.size() < 255) {
        value.push_back(char(code));
        code = s.byte();
      }
    }
    while (!value.empty() && std::isspace(uint8_t(value.back())))
      value.pop_back();
    static const struct {
      const char* name;
      PamField field;
    } fields[] = {{"HEIGHT", kHeight}, {"WIDTH", kWidth}, {"DEPTH", kDepth},
                  {"MAXVAL", kMaxval}, {"TUPLTYPE", kTupltype}};
    for (const auto& f : fields)
      if (ident == f.name) return f.field;
    fail("PAM: unknown header field '" + ident + "'" + kOpenCvToo);
  }

  // a decimal number, the whole value
  static int64_t number(const std::string& v) {
    errno = 0;
    char* end = nullptr;
    long n = std::strtol(v.c_str(), &end, 10);
    if (v.empty() || *end != 0 || errno != 0)
      fail("PAM: '" + v + "' is not a number" + kOpenCvToo);
    return int64_t(int(n));
  }

  void header() {
    if (s.byte() != 'P' || s.byte() != '7') fail("not a PAM file");
    int code = s.byte();
    if (code != '\n' && code != '\r') fail("not a PAM file");
    bool have[4] = {false, false, false, false};   // h, w, depth, maxval
    int fmt = 0;   // 0 none, 1 BLACKANDWHITE, 2 GRAYSCALE, 3 GRAYSCALE_ALPHA,
                   // 4 RGB, 5 RGB_ALPHA
    std::string value;
    for (;;) {
      PamField f = line(value);
      if (f == kEnd) break;
      if (f == kNone || f == kComment) continue;
      if (f == kTupltype) {
        static const char* names[] = {"BLACKANDWHITE", "GRAYSCALE",
                                      "GRAYSCALE_ALPHA", "RGB", "RGB_ALPHA"};
        fmt = 0;
        for (int i = 0; i < 5; i++)
          if (std::strcmp(names[i], value.c_str()) == 0) fmt = i + 1;
        if (!fmt) fail("PAM: unknown TUPLTYPE '" + value + "'" + kOpenCvToo);
        continue;
      }
      int k = f == kHeight ? 0 : f == kWidth ? 1 : f == kDepth ? 2 : 3;
      if (have[k]) fail("PAM: a header field given twice" +
                        std::string(kOpenCvToo));
      int64_t v = number(value);
      if (k == 0) img.h = v;
      if (k == 1) img.w = v;
      if (k == 2) depth = v;
      if (k == 3) {
        maxval = v;
        if (maxval > 65535)
          fail("PAM MAXVAL past 65535" + std::string(kOpenCvToo));
      }
      have[k] = true;
    }
    if (!(have[0] && have[1] && have[2] && have[3]))
      fail("PAM header without WIDTH, HEIGHT, DEPTH and MAXVAL" +
           std::string(kOpenCvToo));
    if (!fmt) {
      if (depth == 1 && maxval == 1) fmt = 1;
      else if (depth == 1 && maxval < 256) fmt = 2;
      else if (depth == 3 && maxval < 256) fmt = 4;
      else
        fail("PAM of DEPTH " + std::to_string(depth) + " and MAXVAL " +
             std::to_string(maxval) + " without a TUPLTYPE" + kOpenCvToo);
    }
    static const int channels[] = {0, 1, 1, 2, 3, 4};
    if (depth != channels[fmt])
      fail("PAM TUPLTYPE of " + std::to_string(channels[fmt]) +
           " channels with DEPTH " + std::to_string(depth) + kOpenCvToo);
    check_size(img.w, img.h);
    if (maxval != 1 && (depth == 2 || depth == 4))
      fail("PAM of DEPTH " + std::to_string(depth) +
           ": OpenCV 5.0 converts the first width / DEPTH pixels of each "
           "row and leaves the rest unset");
  }

  void decode(uint8_t* out) {
    const int64_t w = img.w, h = img.h;
    const bool wide = maxval > 255;
    std::vector<uint8_t> raw(size_t(w * depth * (wide ? 2 : 1)));
    for (int64_t y = 0; y < h; y++) {
      uint8_t* o = out + y * w * 3;
      s.bytes(raw.data(), raw.size());
      for (int64_t x = 0; x < w; x++) {
        if (maxval == 1) {                   // packed bits, 1 white
          uint8_t v = (raw[size_t(x >> 3)] >> (7 - (x & 7)) & 1) ? 255 : 0;
          o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = v;
        } else if (depth == 1) {
          uint8_t v = raw[size_t(wide ? 2 * x : x)];
          o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = v;
        } else {                             // as stored, taken as BGR
          for (int c = 0; c < 3; c++)
            o[3 * x + c] = raw[size_t(wide ? 2 * (3 * x + c) : 3 * x + c)];
        }
      }
    }
  }
};

// ---- PFM ----------------------------------------------------------------
struct Pfm {
  Stream s;
  Image img;
  double scale = 0;
  Pfm(const uint8_t* d, size_t n) : s(d, n) {}

  // grfmt_pfm.cpp's read_number: the bytes up to the next whitespace byte
  std::string token() {
    std::string t;
    for (int i = 0; i < 2048; i++) {
      int c = s.byte();
      if (c >= 128) fail("PFM: a header byte past 127" +
                         std::string(kOpenCvToo));
      if (std::isspace(c)) break;
      t.push_back(char(c));
    }
    return t;
  }

  void header() {
    if (s.byte() != 'P') fail("not a PFM file");
    int kind = s.byte();
    if (kind != 'F' && kind != 'f') fail("not a PFM file");
    img.c = kind == 'F' ? 3 : 1;
    if (s.byte() != '\n') fail("PFM: no line break after the type" +
                               std::string(kOpenCvToo));
    img.w = std::atoi(token().c_str());
    img.h = std::atoi(token().c_str());
    scale = std::atof(token().c_str());
    check_size(img.w, img.h);
    if (!(std::fabs(scale) > 0.0))
      fail("PFM scale 0" + std::string(kOpenCvToo));
  }

  void decode(uint8_t* out) {
    const int64_t w = img.w, h = img.h, c = img.c;
    const bool swap = scale >= 0.0;          // big-endian samples
    const float k = float(1.f / std::fabs(scale));
    std::vector<uint8_t> raw(size_t(w * c * 4));
    for (int64_t y = h - 1; y >= 0; y--) {   // rows bottom-up
      s.bytes(raw.data(), raw.size());
      uint8_t* o = out + y * w * c;
      for (int64_t i = 0; i < w * c; i++) {
        uint8_t b[4];
        std::memcpy(b, raw.data() + 4 * i, 4);
        if (swap) {
          std::swap(b[0], b[3]);
          std::swap(b[1], b[2]);
        }
        float v;
        std::memcpy(&v, b, 4);
        int64_t at = c == 3 ? 3 * (i / 3) + (2 - i % 3) : i;   // RGB -> BGR
        o[at] = sat_u8(v * k);
      }
    }
  }
};

// ---- Sun raster -----------------------------------------------------------
const uint32_t kSunMagic = 0x59A66A95;
enum { kRasOld = 0, kRasStandard = 1 };
enum { kMapNone = 0, kMapEqualRgb = 1 };

struct Sun {
  Stream s;
  Image img;
  uint32_t bpp = 0, type = 0, maptype = 0, maplength = 0;
  uint8_t palette[256][3] = {};              // BGR, entries past the map 0
  Sun(const uint8_t* d, size_t n) : s(d, n) {}

  void header() {
    if (s.be32() != kSunMagic) fail("not a Sun raster file");
    uint32_t w = s.be32(), h = s.be32();
    bpp = s.be32();
    if (int32_t(w) <= 0 || int32_t(h) <= 0)
      fail("a Sun raster of no pixels");
    if (bpp != 1 && bpp != 8 && bpp != 24 && bpp != 32)
      fail("Sun raster of depth " + std::to_string(bpp) + kOpenCvToo);
    s.be32();                                // the data's length
    type = s.be32();
    maptype = s.be32();
    maplength = s.be32();
    if (type != kRasOld && type != kRasStandard)
      fail("Sun raster of type " + std::to_string(type) +
           (type == 2 ? " (RT_BYTE_ENCODED)" : type == 3 ? " (RT_FORMAT_RGB)"
                                                         : "") +
           ": OpenCV 5.0 reads RT_OLD and RT_STANDARD alone" + kOpenCvToo);
    uint32_t pal_bytes = bpp <= 8 ? (1u << bpp) * 3 : 0;
    bool ok = (maptype == kMapNone && maplength == 0) ||
              (maptype == kMapEqualRgb && maplength > 0 &&
               maplength <= pal_bytes && bpp <= 8);
    if (!ok)
      fail("Sun raster colour map of type " + std::to_string(maptype) +
           " and " + std::to_string(maplength) + " bytes at depth " +
           std::to_string(bpp) + kOpenCvToo);
    img.w = int64_t(int32_t(w));
    img.h = int64_t(int32_t(h));
    check_size(img.w, img.h);
    if (maplength) {
      std::vector<uint8_t> map(maplength);
      s.bytes(map.data(), maplength);
      uint32_t n = maplength / 3;
      for (uint32_t i = 0; i < n; i++) {
        palette[i][0] = map[i + 2 * n];
        palette[i][1] = map[i + n];
        palette[i][2] = map[i];
      }
    } else if (bpp <= 8) {                   // grey ramp
      uint32_t n = 1u << bpp;
      for (uint32_t i = 0; i < n; i++)
        palette[i][0] = palette[i][1] = palette[i][2] =
            uint8_t(i * 255 / (n - 1));
    }
  }

  void decode(uint8_t* out) {
    const int64_t w = img.w, h = img.h;
    const size_t pitch = size_t(((w * bpp + 7) / 8 + 1) & ~int64_t(1));
    std::vector<uint8_t> row(bpp == 32 ? size_t(w * 4) : pitch);
    for (int64_t y = 0; y < h; y++) {
      uint8_t* o = out + y * w * 3;
      s.bytes(row.data(), row.size());
      for (int64_t x = 0; x < w; x++) {
        const uint8_t* p;
        if (bpp <= 8) {
          int idx = bpp == 1 ? row[size_t(x >> 3)] >> (7 - (x & 7)) & 1
                             : row[size_t(x)];
          p = palette[idx];
        } else {
          p = row.data() + (bpp == 24 ? 3 * x : 4 * x + 1);
        }
        o[3 * x] = p[0];
        o[3 * x + 1] = p[1];
        o[3 * x + 2] = p[2];
      }
    }
  }
};

// ---- Radiance HDR -----------------------------------------------------------
struct Hdr {
  Stream s;
  Image img;
  Hdr(const uint8_t* d, size_t n) : s(d, n) {}

  // fgets into a 128-byte buffer: up to 127 bytes, through a newline
  bool gets(std::string& line) {
    line.clear();
    if (s.pos >= s.len) return false;
    while (line.size() < 127 && s.pos < s.len) {
      char c = char(s.data[s.pos++]);
      line.push_back(c);
      if (c == '\n') break;
    }
    return true;
  }

  // sscanf's %d: whitespace, a sign, digits
  static bool scan_int(const char*& p, int& out) {
    while (std::isspace(uint8_t(*p))) p++;
    const char* start = p;
    if (*p == '+' || *p == '-') p++;
    if (!std::isdigit(uint8_t(*p))) return false;
    while (std::isdigit(uint8_t(*p))) p++;
    long long v = std::strtoll(std::string(start, p).c_str(), nullptr, 10);
    out = int(v);
    return true;
  }

  void header() {
    if (!(s.len >= 6 && (std::memcmp(s.data, "#?RGBE", 6) == 0 ||
                         (s.len >= 10 &&
                          std::memcmp(s.data, "#?RADIANCE", 10) == 0))))
      fail("not a Radiance HDR file");
    std::string line;
    if (!gets(line)) fail("RGBE read error");
    for (;;) {
      if (line.empty() || line[0] == '\n')
        fail("RGBE bad file format: no FORMAT specifier found" +
             std::string(kOpenCvToo));
      if (line == "FORMAT=32-bit_rle_rgbe\n") break;
      if (!gets(line)) fail("RGBE read error: the header ends early");
    }
    if (!gets(line)) fail("RGBE read error: the header ends early");
    if (line != "\n")
      fail("RGBE bad file format: missing blank line after FORMAT "
           "specifier" + std::string(kOpenCvToo));
    if (!gets(line)) fail("RGBE read error: the header ends early");
    const char* p = line.c_str();
    int hh = 0, ww = 0;
    bool ok = p[0] == '-' && p[1] == 'Y';
    if (ok) {
      p += 2;
      ok = scan_int(p, hh);
    }
    if (ok) {
      while (std::isspace(uint8_t(*p))) p++;
      ok = p[0] == '+' && p[1] == 'X';
      if (ok) {
        p += 2;
        ok = scan_int(p, ww);
      }
    }
    if (!ok)
      fail("RGBE bad file format: missing image size specifier (OpenCV "
           "reads \"-Y <height> +X <width>\" alone)" + std::string(kOpenCvToo));
    img.h = hh;
    img.w = ww;
    check_size(img.w, img.h);
  }

  static void put(uint8_t* o, const uint8_t rgbe[4]) {
    float r = 0, g = 0, b = 0;
    if (rgbe[3]) {
      float f = float(std::ldexp(1.0, int(rgbe[3]) - (128 + 8)));
      r = rgbe[0] * f;
      g = rgbe[1] * f;
      b = rgbe[2] * f;
    }
    o[0] = sat_u8(b * 255.0f);
    o[1] = sat_u8(g * 255.0f);
    o[2] = sat_u8(r * 255.0f);
  }

  void flat(uint8_t* o, int64_t n) {
    uint8_t rgbe[4];
    for (int64_t i = 0; i < n; i++, o += 3) {
      s.bytes(rgbe, 4);
      put(o, rgbe);
    }
  }

  void decode(uint8_t* out) {
    const int64_t w = img.w, h = img.h;
    if (w < 8 || w > 0x7fff) {
      flat(out, w * h);
      return;
    }
    std::vector<uint8_t> line(size_t(4 * w));
    uint8_t* o = out;
    for (int64_t left = h; left > 0; left--) {
      uint8_t rgbe[4];
      s.bytes(rgbe, 4);
      if (rgbe[0] != 2 || rgbe[1] != 2 || (rgbe[2] & 0x80)) {
        put(o, rgbe);                         // flat from here on
        flat(o + 3, w * left - 1);
        return;
      }
      if ((int64_t(rgbe[2]) << 8 | rgbe[3]) != w)
        fail("RGBE bad file format: wrong scanline width" +
             std::string(kOpenCvToo));
      uint8_t* p = line.data();
      for (int c = 0; c < 4; c++) {
        uint8_t* end = line.data() + (c + 1) * w;
        while (p < end) {
          uint8_t buf[2];
          s.bytes(buf, 2);
          int count = buf[0] > 128 ? buf[0] - 128 : buf[0];
          if (count == 0 || count > end - p)
            fail("RGBE bad file format: bad scanline data" +
                 std::string(kOpenCvToo));
          if (buf[0] > 128) {
            std::memset(p, buf[1], size_t(count));
            p += count;
          } else {
            *p++ = buf[1];
            if (count > 1) {
              s.bytes(p, size_t(count - 1));
              p += count - 1;
            }
          }
        }
      }
      for (int64_t x = 0; x < w; x++, o += 3) {
        uint8_t px[4] = {line[size_t(x)], line[size_t(x + w)],
                         line[size_t(x + 2 * w)], line[size_t(x + 3 * w)]};
        put(o, px);
      }
    }
  }
};

// rgbe.cpp's float2rgbe (its float to unsigned char conversions as x86
// makes them: through a 32-bit integer)
void float2rgbe(uint8_t rgbe[4], float r, float g, float b) {
  float v = r;
  if (g > v) v = g;
  if (b > v) v = b;
  if (v < 1e-32) {
    rgbe[0] = rgbe[1] = rgbe[2] = rgbe[3] = 0;
    return;
  }
  int e;
  v = float(std::frexp(double(v), &e) * 256.0 / double(v));
  rgbe[0] = uint8_t(int32_t(r * v));
  rgbe[1] = uint8_t(int32_t(g * v));
  rgbe[2] = uint8_t(int32_t(b * v));
  rgbe[3] = uint8_t(e + 128);
}

// rgbe.cpp's RGBE_WriteBytes_RLE
void write_rle(const uint8_t* data, int n, std::vector<uint8_t>& o) {
  const int kMinRun = 4;
  int cur = 0;
  while (cur < n) {
    int beg = cur, run = 0, old_run = 0;
    while (run < kMinRun && beg < n) {
      beg += run;
      old_run = run;
      run = 1;
      while (beg + run < n && run < 127 && data[beg] == data[beg + run])
        run++;
    }
    if (old_run > 1 && old_run == beg - cur) {
      o.push_back(uint8_t(128 + old_run));
      o.push_back(data[cur]);
      cur = beg;
    }
    while (cur < beg) {
      int k = beg - cur;
      if (k > 128) k = 128;
      o.push_back(uint8_t(k));
      o.insert(o.end(), data + cur, data + cur + k);
      cur += k;
    }
    if (run >= kMinRun) {
      o.push_back(uint8_t(128 + run));
      o.push_back(data[beg]);
      cur += run;
    }
  }
}

std::vector<uint8_t> hdr_encode(const float* img, int64_t h, int64_t w) {
  if (h < 1 || w < 1 || h > INT_MAX || w > INT_MAX)
    fail("HDR sides are 1 to 2^31 - 1 pixels");
  std::string head = "#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y " +
                     std::to_string(h) + " +X " + std::to_string(w) + "\n";
  std::vector<uint8_t> o(head.begin(), head.end());
  uint8_t rgbe[4];
  if (w < 8 || w > 0x7fff) {
    for (int64_t i = 0; i < h * w; i++) {
      const float* p = img + 3 * i;
      float2rgbe(rgbe, p[2], p[1], p[0]);
      o.insert(o.end(), rgbe, rgbe + 4);
    }
    return o;
  }
  std::vector<uint8_t> buf(size_t(4 * w));
  for (int64_t y = 0; y < h; y++) {
    o.push_back(2);
    o.push_back(2);
    o.push_back(uint8_t(w >> 8));
    o.push_back(uint8_t(w & 0xFF));
    for (int64_t x = 0; x < w; x++) {
      const float* p = img + 3 * (y * w + x);
      float2rgbe(rgbe, p[2], p[1], p[0]);
      for (int c = 0; c < 4; c++) buf[size_t(x + c * w)] = rgbe[c];
    }
    for (int c = 0; c < 4; c++) write_rle(buf.data() + c * w, int(w), o);
  }
  return o;
}

int form_of(const uint8_t* d, size_t n) {
  if (n >= 4 && d[0] == 0x59 && d[1] == 0xA6 && d[2] == 0x6A && d[3] == 0x95)
    return kSun;
  if (n >= 6 && d[0] == '#' && d[1] == '?') return kHdr;
  if (n >= 2 && d[0] == 'P') {
    if (d[1] == '7') return kPam;
    if (d[1] == 'F' || d[1] == 'f') return kPfm;
    if (d[1] >= '1' && d[1] <= '6') return kPnm;
  }
  fail("not a PNM, PAM, PFM, Sun raster or Radiance HDR file");
}

template <class Reader>
void run(const uint8_t* data, size_t len, int64_t* dims, uint8_t* out) {
  Reader r(data, len);
  r.header();
  if (!out) {
    dims[0] = r.img.h;
    dims[1] = r.img.w;
    dims[2] = r.img.c;
    return;
  }
  if (dims[0] != r.img.h || dims[1] != r.img.w || dims[2] != r.img.c)
    fail("the image's size is not the one given");
  r.decode(out);
}

// the size (out null) or the pixels of a file
void dispatch(const uint8_t* data, size_t len, int64_t* dims, uint8_t* out) {
  switch (form_of(data, len)) {
    case kPnm: run<Pnm>(data, len, dims, out); break;
    case kPam: run<Pam>(data, len, dims, out); break;
    case kPfm: run<Pfm>(data, len, dims, out); break;
    case kSun: run<Sun>(data, len, dims, out); break;
    default: run<Hdr>(data, len, dims, out); break;
  }
}

void set_error(char* err, int64_t errlen, const std::string& msg) {
  if (!err || errlen <= 0) return;
  size_t n = msg.size() < size_t(errlen - 1) ? msg.size() : size_t(errlen - 1);
  std::memcpy(err, msg.data(), n);
  err[n] = 0;
}

}  // namespace

extern "C" {

// dims = {height, width, channels} of the decoded image (channels 1 for a
// grey PFM, else 3). Returns 0, or -1 with a message in err.
int oodt_raster_info(const uint8_t* data, int64_t len, int64_t* dims,
                     char* err, int64_t errlen) {
  try {
    dispatch(data, size_t(len), dims, nullptr);
    return 0;
  } catch (const RasterError& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

// Decode into out, (height, width, channels) uint8 of the size
// oodt_raster_info gave. Returns 0, or -1 with a message in err.
int oodt_raster_decode(const uint8_t* data, int64_t len, uint8_t* out,
                       int64_t height, int64_t width, int64_t channels,
                       char* err, int64_t errlen) {
  try {
    int64_t dims[3] = {height, width, channels};
    dispatch(data, size_t(len), dims, out);
    return 0;
  } catch (const RasterError& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

// Encode (h, w, 3) float32 BGR as cv2.imencode(".hdr") writes it. Returns
// the file's size, writing it into out when it fits in cap bytes (call
// again with a larger buffer otherwise), or -1 with a message in err.
int64_t oodt_hdr_encode(const float* img, int64_t h, int64_t w, uint8_t* out,
                        int64_t cap, char* err, int64_t errlen) {
  try {
    std::vector<uint8_t> o = hdr_encode(img, h, w);
    if (int64_t(o.size()) <= cap) std::memcpy(out, o.data(), o.size());
    return int64_t(o.size());
  } catch (const RasterError& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

}  // extern "C"
