// The lossless WebP (VP8L) reader and writer on the host (C++17, no
// dependencies), after what OpenCV 5.0 with libwebp 1.5 (0x0210) gives
// cv2.imdecode with IMREAD_COLOR, and the lossless file cv2.imencode(".webp")
// writes with its defaults, for the JAX package.
//
// Reader: a RIFF "WEBP" file whose image is VP8L, as libwebp's decoder and
// demuxer take it: a simple file (its first chunk VP8L), or VP8X holding a
// VP8L chunk (ICCP, EXIF, XMP, ALPH and unknown chunks skipped; the image of
// the canvas's size), or an animation (VP8X's flag, ANIM, ANMF frames): the
// first frame on a transparent black canvas at its offset, not blended. A
// RIFF size past the data, a chunk past the RIFF, a first chunk other than
// VP8 / VP8L / VP8X are refused; lossy images (VP8, with or without ALPH)
// are refused by name. VP8L in full: the predictor (14 modes; 14 and 15 as
// mode 0), cross-colour, subtract-green and colour-indexing transforms (1,
// 2, 4 or 8 pixels a byte; indices past the table transparent black), each
// at most once; colour caches of 1-11 bits; LZ77 with the 120 plane codes;
// meta prefix codes; simple and normal prefix codes, which must be complete
// (or of one symbol), as libwebp builds them; a read past the data fails.
// The output is IMREAD_COLOR's (height, width, 3) uint8 BGR, alpha dropped;
// the EXIF orientation (VP8X's EXIF flag) is the Python side's.
//
// Writer: oodt_webp_encode, a lossless VP8L file of (h, w, c) uint8 BGR or
// BGRA that decodes to what cv2.imencode(".webp", img)'s file decodes to:
// alpha_is_used where some alpha is below 255, pixels of alpha 0 written as
// transparent black (libwebp's lossless cleanup without "exact"). The coder
// is the port's own and simple: subtract-green, one predictor mode a 16 x 16
// tile (the least sum of absolute residuals over a quarter of its
// pixels), hash-chain LZ77 (24 links, 2^16 pixels back) with plane
// codes, a 10-bit colour cache, one prefix-code group of length-limited
// Huffman codes. Its bytes are not libwebp's (ROADMAP C).
//
// A plain C ABI, loaded with ctypes (native.py builds it into one library
// with the other host sources). No global state: calls from several
// threads run in parallel.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct WebpError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw WebpError{msg}; }

const char* const kOpenCvToo = ": OpenCV does not read it either";
const char* const kLossy =
    "reading lossy WebP images (VP8) is not ported yet (ROADMAP A.4d)";

uint32_t le24(const uint8_t* p) { return p[0] | p[1] << 8 | p[2] << 16; }
uint32_t le32(const uint8_t* p) { return le24(p) | uint32_t(p[3]) << 24; }

// ---- the bit reader ----------------------------------------------------------
struct Bits {
  const uint8_t* data;
  size_t len;
  size_t pos = 0;         // next byte to load
  uint64_t val = 0;       // bits held, LSB first
  int n = 0;              // how many
  int64_t consumed = 0;   // bits consumed
  Bits(const uint8_t* d, size_t l) : data(d), len(l) {}
  void fill() {
    while (n <= 56) {
      uint64_t b = pos < len ? data[pos] : 0;
      ++pos;
      val |= b << n;
      n += 8;
    }
  }
  uint32_t peek(int k) {
    if (n < k) fill();
    return uint32_t(val & ((uint64_t(1) << k) - 1));
  }
  void skip(int k) {
    val >>= k;
    n -= k;
    consumed += k;
    if (consumed > int64_t(len) * 8) fail("the VP8L data ends early");
  }
  uint32_t read(int k) {
    if (!k) return 0;
    uint32_t v = peek(k);
    skip(k);
    return v;
  }
};

// ---- prefix codes --------------------------------------------------------------
const int kMaxLength = 15;
const int kRootBits = 10;

struct Code {
  // a root table of kRootBits: (symbol << 4 | length), or 0xFFFF for a
  // longer code, decoded canonically
  std::vector<uint32_t> root;
  int count[kMaxLength + 1] = {};
  std::vector<int> sorted;   // symbols by (length, symbol)
  int single = -1;           // the symbol of a code of one symbol (0 bits)
};

uint32_t reverse(uint32_t code, int len) {
  uint32_t r = 0;
  for (int i = 0; i < len; ++i) r |= ((code >> i) & 1) << (len - 1 - i);
  return r;
}

// libwebp's BuildHuffmanTable: lengths of 0-15, not all 0, a complete code
// unless exactly one symbol has a length
void build(Code& c, const std::vector<int>& lengths) {
  std::fill(c.count, c.count + kMaxLength + 1, 0);
  int used = 0, only = -1;
  for (size_t s = 0; s < lengths.size(); ++s) {
    if (lengths[s] < 0 || lengths[s] > kMaxLength) fail("a code length past 15");
    ++c.count[lengths[s]];
    if (lengths[s]) {
      ++used;
      only = int(s);
    }
  }
  if (!used) fail("a prefix code of no symbol");
  c.sorted.clear();
  c.root.assign(size_t(1) << kRootBits, 0xFFFFFFFFu);
  if (used == 1) {
    c.single = only;
    return;
  }
  c.single = -1;
  int left = 1;
  for (int l = 1; l <= kMaxLength; ++l) {
    left = 2 * left - c.count[l];
    if (left < 0) fail("an over-subscribed prefix code");
  }
  if (left) fail("an incomplete prefix code");
  for (int l = 1; l <= kMaxLength; ++l)
    for (size_t s = 0; s < lengths.size(); ++s)
      if (lengths[s] == l) c.sorted.push_back(int(s));
  uint32_t code = 0;
  size_t k = 0;
  for (int l = 1; l <= kMaxLength; ++l) {
    for (int i = 0; i < c.count[l]; ++i, ++k, ++code) {
      if (l <= kRootBits) {
        uint32_t r = reverse(code, l);
        for (uint32_t at = r; at < (1u << kRootBits); at += 1u << l)
          c.root[at] = uint32_t(c.sorted[k]) << 4 | uint32_t(l);
      }
    }
    code <<= 1;
  }
}

int read_symbol(const Code& c, Bits& br) {
  if (c.single >= 0) return c.single;
  uint32_t e = c.root[br.peek(kRootBits)];
  if (e != 0xFFFFFFFFu) {
    br.skip(int(e & 15));
    return int(e >> 4);
  }
  // canonical, bit by bit (codes longer than the root table)
  int code = 0, first = 0, index = 0;
  for (int l = 1; l <= kMaxLength; ++l) {
    code |= int(br.read(1));
    int count = c.count[l];
    if (code - first < count) return c.sorted[size_t(index + code - first)];
    index += count;
    first = (first + count) << 1;
    code <<= 1;
  }
  fail("a prefix code past its table");
}

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                  7, 8, 9, 10, 11, 12, 13, 14, 15};

struct Stats {
  int64_t transforms = 0, cache_bits = 0, meta_bits = 0, modes = 0,
          copies = 0, cache_hits = 0, plane_codes = 0, palette_bits = 0;
};

void read_code(Bits& br, int alphabet, Code& out) {
  // (a simple code's symbols past the alphabet are dropped, as libwebp
  // builds the code of the alphabet's lengths alone)
  std::vector<int> lengths(size_t(std::max(alphabet, 256)), 0);
  if (br.read(1)) {                                     // simple
    int symbols = int(br.read(1)) + 1;
    int first_bits = int(br.read(1));
    lengths[br.read(first_bits ? 8 : 1)] = 1;
    if (symbols == 2) lengths[br.read(8)] = 1;
    lengths.resize(size_t(alphabet));
  } else {                                              // normal
    lengths.resize(size_t(alphabet));
    std::vector<int> cl(19, 0);
    int n = int(br.read(4)) + 4;
    for (int i = 0; i < n; ++i) cl[size_t(kCodeLengthOrder[i])] = int(br.read(3));
    Code lc;
    build(lc, cl);
    int max_symbol = alphabet;
    if (br.read(1)) {
      int nbits = 2 + 2 * int(br.read(3));
      max_symbol = 2 + int(br.read(nbits));
      if (max_symbol > alphabet) fail("a code length count past its alphabet");
    }
    int symbol = 0, prev = 8;
    while (symbol < alphabet) {
      if (max_symbol-- == 0) break;
      int len = read_symbol(lc, br);
      if (len < 16) {
        lengths[size_t(symbol++)] = len;
        if (len) prev = len;
      } else {
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        int repeat = int(br.read(kExtra[len - 16])) + kOffset[len - 16];
        if (symbol + repeat > alphabet) fail("a code length run past its alphabet");
        int v = len == 16 ? prev : 0;
        while (repeat-- > 0) lengths[size_t(symbol++)] = v;
      }
    }
  }
  build(out, lengths);
}

// the 120 plane codes' (dy, dx) as libwebp packs them: yoffset = v >> 4,
// xoffset = 8 - (v & 15)
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

int64_t plane_distance(int64_t width, int code) {
  if (code > 120) return code - 120;
  int v = kCodeToPlane[code - 1];
  int64_t d = int64_t(v >> 4) * width + (8 - (v & 15));
  return d >= 1 ? d : 1;
}

int64_t prefix_value(int symbol, Bits& br) {
  if (symbol < 4) return symbol + 1;
  int extra = (symbol - 2) >> 1;
  int64_t offset = int64_t(2 + (symbol & 1)) << extra;
  return offset + br.read(extra) + 1;
}

int64_t subsample(int64_t size, int bits) {
  return (size + (int64_t(1) << bits) - 1) >> bits;
}

struct Group {
  Code codes[5];   // green + lengths + cache, red, blue, alpha, distance
};

struct Transform {
  int type;
  int bits;
  int64_t xsize;                 // the width it applies to
  std::vector<uint32_t> data;   // its sub-image, or the colour map
};

uint32_t add_pixels(uint32_t a, uint32_t b) {
  uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

// decode an entropy-coded image of xsize x ysize (level 0: the main image,
// whose transforms and meta codes are read here too)
std::vector<uint32_t> decode_stream(Bits& br, int64_t xsize, int64_t ysize,
                                    bool level0,
                                    std::vector<Transform>* transforms,
                                    Stats& st) {
  if (level0) {
    int seen = 0;
    while (br.read(1)) {
      Transform t;
      t.type = int(br.read(2));
      if (seen & (1 << t.type)) fail("a transform given twice");
      seen |= 1 << t.type;
      st.transforms |= 1 << t.type;
      t.xsize = xsize;
      t.bits = 0;
      if (t.type == 0 || t.type == 1) {
        t.bits = int(br.read(3)) + 2;
        t.data = decode_stream(br, subsample(xsize, t.bits),
                               subsample(ysize, t.bits), false, nullptr, st);
      } else if (t.type == 3) {
        int colours = int(br.read(8)) + 1;
        t.bits = colours > 16 ? 0 : colours > 4 ? 1 : colours > 2 ? 2 : 3;
        st.palette_bits = t.bits + 1;
        std::vector<uint32_t> map =
            decode_stream(br, colours, 1, false, nullptr, st);
        t.data.assign(size_t(1) << (8 >> t.bits), 0);
        uint32_t acc = 0;
        for (size_t i = 0; i < map.size(); ++i) {
          acc = add_pixels(acc, map[i]);
          t.data[i] = acc;
        }
        xsize = subsample(xsize, t.bits);
      }
      transforms->push_back(std::move(t));
    }
  }
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = int(br.read(4));
    if (cache_bits < 1 || cache_bits > 11)
      fail("a colour cache of " + std::to_string(cache_bits) + " bits");
  }
  if (level0) st.cache_bits = cache_bits;
  int meta_bits = 0;
  int64_t meta_x = 0;
  std::vector<uint32_t> meta;
  int groups = 1;
  if (level0 && br.read(1)) {
    meta_bits = int(br.read(3)) + 2;
    st.meta_bits = meta_bits;
    meta_x = subsample(xsize, meta_bits);
    meta = decode_stream(br, meta_x, subsample(ysize, meta_bits), false,
                         nullptr, st);
    for (uint32_t& m : meta) {
      m = (m >> 8) & 0xffff;
      groups = std::max(groups, int(m) + 1);
    }
  }
  const int cache_size = cache_bits ? 1 << cache_bits : 0;
  std::vector<Group> g(static_cast<size_t>(groups));
  const int alphabets[5] = {256 + 24 + cache_size, 256, 256, 256, 40};
  for (Group& gr : g)
    for (int k = 0; k < 5; ++k) read_code(br, alphabets[k], gr.codes[k]);
  const int64_t total = xsize * ysize;
  std::vector<uint32_t> px(static_cast<size_t>(total));
  std::vector<uint32_t> cache(size_t(cache_size), 0);
  const uint32_t cache_shift = 32 - uint32_t(cache_bits);
  int64_t at = 0, cached = 0;
  auto insert = [&](int64_t upto) {
    for (; cached < upto; ++cached)
      cache[(0x1e35a7bdu * px[size_t(cached)]) >> cache_shift] =
          px[size_t(cached)];
  };
  while (at < total) {
    int64_t y = at / xsize, x = at - y * xsize;
    const Group& gr = meta.empty()
        ? g[0]
        : g[meta[size_t((y >> meta_bits) * meta_x + (x >> meta_bits))]];
    int s = read_symbol(gr.codes[0], br);
    if (s < 256) {
      uint32_t r = uint32_t(read_symbol(gr.codes[1], br));
      uint32_t b = uint32_t(read_symbol(gr.codes[2], br));
      uint32_t a = uint32_t(read_symbol(gr.codes[3], br));
      px[size_t(at++)] = a << 24 | r << 16 | uint32_t(s) << 8 | b;
    } else if (s < 256 + 24) {
      int64_t length = prefix_value(s - 256, br);
      int dsym = read_symbol(gr.codes[4], br);
      int64_t dcode = prefix_value(dsym, br);
      if (dcode <= 120) ++st.plane_codes;
      int64_t dist = plane_distance(xsize, int(std::min<int64_t>(dcode, 1 << 30)));
      if (dist > at || length > total - at)
        fail("a backward reference past the image");
      for (int64_t k = 0; k < length; ++k, ++at)
        px[size_t(at)] = px[size_t(at - dist)];
      ++st.copies;
    } else {
      int key = s - 280;
      if (key >= cache_size) fail("a colour cache index past the cache");
      insert(at);
      px[size_t(at++)] = cache[size_t(key)];
      ++st.cache_hits;
    }
    if (cache_size) insert(at);
  }
  return px;
}

uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

int clip255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

uint32_t select(uint32_t a, uint32_t b, uint32_t c) {   // libwebp's Select
  int d = 0;
  for (int s = 0; s < 32; s += 8) {
    int ac = int((a >> s) & 0xff), bc = int((b >> s) & 0xff),
        cc = int((c >> s) & 0xff);
    d += std::abs(bc - cc) - std::abs(ac - cc);
  }
  return d <= 0 ? a : b;
}

uint32_t clamp_full(uint32_t l, uint32_t t, uint32_t tl) {
  uint32_t o = 0;
  for (int s = 0; s < 32; s += 8)
    o |= uint32_t(clip255(int((l >> s) & 0xff) + int((t >> s) & 0xff) -
                          int((tl >> s) & 0xff))) << s;
  return o;
}

uint32_t clamp_half(uint32_t l, uint32_t t, uint32_t tl) {
  uint32_t avg = average2(l, t), o = 0;
  for (int s = 0; s < 32; s += 8) {
    int a = int((avg >> s) & 0xff), b = int((tl >> s) & 0xff);
    o |= uint32_t(clip255(a + (a - b) / 2)) << s;
  }
  return o;
}

// the prediction of mode m for the pixel at p (in a row-major image of
// width w, p on a row past the first and a column past the first)
uint32_t predict(int m, const uint32_t* p, int64_t w) {
  const uint32_t L = p[-1], T = p[-w], TL = p[-w - 1], TR = p[-w + 1];
  switch (m) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select(T, L, TL);
    case 12: return clamp_full(L, T, TL);
    case 13: return clamp_half(L, T, TL);
    default: return 0xff000000u;
  }
}

void inverse(const Transform& t, std::vector<uint32_t>& px, int64_t h,
             Stats& st) {
  const int64_t w = t.xsize;
  if (t.type == 2) {                                     // subtract green
    for (uint32_t& v : px) {
      uint32_t g = (v >> 8) & 0xff;
      uint32_t rb = ((v & 0x00ff00ffu) + (g << 16 | g)) & 0x00ff00ffu;
      v = (v & 0xff00ff00u) | rb;
    }
  } else if (t.type == 0) {                              // predictor
    const int64_t tiles = subsample(w, t.bits);
    px[0] = add_pixels(px[0], 0xff000000u);
    for (int64_t x = 1; x < w; ++x) px[size_t(x)] = add_pixels(px[size_t(x)], px[size_t(x - 1)]);
    for (int64_t y = 1; y < h; ++y) {
      uint32_t* row = px.data() + y * w;
      row[0] = add_pixels(row[0], row[-w]);
      const uint32_t* modes = t.data.data() + (y >> t.bits) * tiles;
      for (int64_t x = 1; x < w; ++x) {
        int m = int((modes[x >> t.bits] >> 8) & 0xf);
        st.modes |= int64_t(1) << m;
        row[x] = add_pixels(row[x], predict(m, row + x, w));
      }
    }
  } else if (t.type == 1) {                              // cross colour
    const int64_t tiles = subsample(w, t.bits);
    for (int64_t y = 0; y < h; ++y)
      for (int64_t x = 0; x < w; ++x) {
        uint32_t c = t.data[size_t((y >> t.bits) * tiles + (x >> t.bits))];
        int8_t g2r = int8_t(c & 0xff), g2b = int8_t((c >> 8) & 0xff),
               r2b = int8_t((c >> 16) & 0xff);
        uint32_t& v = px[size_t(y * w + x)];
        int8_t green = int8_t((v >> 8) & 0xff);
        int red = int((v >> 16) & 0xff), blue = int(v & 0xff);
        red = (red + ((int(g2r) * green) >> 5)) & 0xff;
        blue += (int(g2b) * green) >> 5;
        blue += (int(r2b) * int8_t(red)) >> 5;
        blue &= 0xff;
        v = (v & 0xff00ff00u) | uint32_t(red) << 16 | uint32_t(blue);
      }
  } else {                                               // colour indexing
    const int64_t packed = subsample(w, t.bits);
    std::vector<uint32_t> out(size_t(w * h));
    const int per_byte = 1 << t.bits, bpp = 8 >> t.bits;
    const uint32_t mask = (1u << bpp) - 1;
    for (int64_t y = 0; y < h; ++y) {
      const uint32_t* src = px.data() + y * packed;
      uint32_t bundle = 0;
      for (int64_t x = 0; x < w; ++x) {
        if ((x & (per_byte - 1)) == 0) bundle = (*src++ >> 8) & 0xff;
        out[size_t(y * w + x)] = t.data[bundle & mask];
        bundle >>= bpp;
      }
    }
    px.swap(out);
  }
}

// a VP8L bitstream -> (h, w) ARGB
std::vector<uint32_t> decode_vp8l(const uint8_t* d, size_t len, int64_t* h,
                                  int64_t* w, Stats& st) {
  if (len < 5 || d[0] != 0x2f) fail("not a VP8L bitstream");
  Bits br(d, len);
  br.read(8);
  *w = int64_t(br.read(14)) + 1;
  *h = int64_t(br.read(14)) + 1;
  br.read(1);                                      // alpha_is_used
  if (br.read(3) != 0) fail("a VP8L version other than 0");
  std::vector<Transform> transforms;
  std::vector<uint32_t> px = decode_stream(br, *w, *h, true, &transforms, st);
  for (size_t i = transforms.size(); i-- > 0;) inverse(transforms[i], px, *h, st);
  return px;
}

// ---- the container -----------------------------------------------------------
struct Chunk {
  uint32_t tag;
  const uint8_t* data;
  size_t size;
};

uint32_t fourcc(const char* s) { return le32(reinterpret_cast<const uint8_t*>(s)); }

std::vector<Chunk> chunks(const uint8_t* d, size_t len) {
  std::vector<Chunk> out;
  size_t at = 0;
  while (at + 8 <= len) {
    size_t size = le32(d + at + 4);
    if (size > len - at - 8) fail("a chunk past the end of the file");
    out.push_back({le32(d + at), d + at + 8, size});
    at += 8 + size + (size & 1);
  }
  return out;
}

struct Image {
  const uint8_t* vp8l = nullptr;
  size_t size = 0;
  int64_t canvas_w = 0, canvas_h = 0;
  int64_t x = 0, y = 0, w = 0, h = 0;   // an animation's first frame
  bool framed = false;
};

Image locate(const uint8_t* d, size_t len) {
  if (len < 12 || std::memcmp(d, "RIFF", 4) || std::memcmp(d + 8, "WEBP", 4))
    fail("not a WebP file");
  size_t riff = le32(d + 4);
  if (riff < 12 || riff > len - 8) fail("the file ends before its RIFF size");
  std::vector<Chunk> cs = chunks(d + 12, riff - 4);
  if (cs.empty()) fail("a WebP file of no chunk");
  Image im;
  const Chunk& first = cs[0];
  if (first.tag == fourcc("VP8 ")) fail(kLossy);
  // libwebp's VP8L reader of a still may read on past its chunk, to the
  // end of the data (a corrupt bitstream can need the pad byte)
  if (first.tag == fourcc("VP8L")) {
    im.vp8l = first.data;
    im.size = size_t(d + len - first.data);
    return im;
  }
  if (first.tag != fourcc("VP8X") || first.size < 10)
    fail("a WebP file whose first chunk is not VP8, VP8L or VP8X" +
         std::string(kOpenCvToo));
  const uint8_t flags = first.data[0];
  im.canvas_w = int64_t(le24(first.data + 4)) + 1;
  im.canvas_h = int64_t(le24(first.data + 7)) + 1;
  if (flags & 0x02) {                                   // an animation
    bool anim = false;
    for (size_t i = 1; i < cs.size(); ++i) {
      if (cs[i].tag == fourcc("ANIM")) anim = true;
      if (cs[i].tag != fourcc("ANMF")) continue;
      if (!anim || cs[i].size < 16) fail("an animation without ANIM" +
                                         std::string(kOpenCvToo));
      const uint8_t* f = cs[i].data;
      im.framed = true;
      im.x = 2 * int64_t(le24(f));
      im.y = 2 * int64_t(le24(f + 3));
      im.w = int64_t(le24(f + 6)) + 1;
      im.h = int64_t(le24(f + 9)) + 1;
      if (im.x + im.w > im.canvas_w || im.y + im.h > im.canvas_h)
        fail("a frame past the canvas" + std::string(kOpenCvToo));
      for (const Chunk& c : chunks(f + 16, cs[i].size - 16)) {
        if (c.tag == fourcc("VP8 ")) fail(kLossy);
        if (c.tag == fourcc("VP8L")) {
          im.vp8l = c.data;
          im.size = c.size;
          return im;
        }
      }
      fail("an animation frame of no image");
    }
    fail("an animation of no frame" + std::string(kOpenCvToo));
  }
  for (size_t i = 1; i < cs.size(); ++i) {
    if (cs[i].tag == fourcc("VP8 ")) fail(kLossy);
    if (cs[i].tag == fourcc("VP8L")) {
      im.vp8l = cs[i].data;
      im.size = size_t(d + len - cs[i].data);
      return im;
    }
  }
  fail("a WebP file of no image" + std::string(kOpenCvToo));
}

int64_t vp8l_dims(const Image& im, int64_t* w) {
  if (im.size < 5 || im.vp8l[0] != 0x2f) fail("not a VP8L bitstream");
  uint32_t bits = le32(im.vp8l + 1);
  *w = int64_t(bits & 0x3fff) + 1;
  return int64_t((bits >> 14) & 0x3fff) + 1;
}

// dims: {height, width}, written without out, checked with it
void decode(const uint8_t* d, size_t len, int64_t* dims, uint8_t* out,
            Stats* st) {
  Image im = locate(d, len);
  int64_t w, h = vp8l_dims(im, &w);
  if (!im.framed && im.canvas_w && (im.canvas_w != w || im.canvas_h != h))
    fail("an image of another size than its canvas" + std::string(kOpenCvToo));
  int64_t cw = im.canvas_w ? im.canvas_w : w, ch = im.canvas_h ? im.canvas_h : h;
  if (im.framed && (im.w != w || im.h != h))
    fail("a frame of another size than its image" + std::string(kOpenCvToo));
  if (!out) {
    dims[0] = ch;
    dims[1] = cw;
    return;
  }
  if (dims[0] != ch || dims[1] != cw)
    fail("an output of another size than the canvas");
  Stats local;
  std::vector<uint32_t> px = decode_vp8l(im.vp8l, im.size, &h, &w,
                                         st ? *st : local);
  std::memset(out, 0, size_t(3 * cw * ch));
  for (int64_t y = 0; y < h; ++y)
    for (int64_t x = 0; x < w; ++x) {
      uint32_t v = px[size_t(y * w + x)];
      uint8_t* o = out + 3 * ((im.y + y) * cw + im.x + x);
      o[0] = uint8_t(v);
      o[1] = uint8_t(v >> 8);
      o[2] = uint8_t(v >> 16);
    }
}

// ---- the writer ----------------------------------------------------------------
struct BitWriter {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int n = 0;
  void put(uint32_t v, int k) {
    if (!k) return;
    acc |= uint64_t(v) << n;
    n += k;
    while (n >= 8) {
      out.push_back(uint8_t(acc));
      acc >>= 8;
      n -= 8;
    }
  }
  void flush() {
    if (n) out.push_back(uint8_t(acc));
    acc = 0;
    n = 0;
  }
};

// Huffman code lengths of at most `limit` bits for the counts (a complete
// code wherever two or more symbols are used)
std::vector<int> code_lengths(const std::vector<uint32_t>& counts, int limit) {
  const size_t n = counts.size();
  std::vector<int> len(n, 0);
  std::vector<uint64_t> c(counts.begin(), counts.end());
  for (;;) {
    std::vector<size_t> used;
    for (size_t i = 0; i < n; ++i)
      if (c[i]) used.push_back(i);
    if (used.size() < 2) {
      for (size_t i : used) len[i] = 1;
      return len;
    }
    // the tree: leaves 0..m-1, then internal nodes
    const size_t m = used.size();
    std::vector<int> parent(2 * m, -1);
    typedef std::pair<uint64_t, int> Node;
    std::priority_queue<Node, std::vector<Node>, std::greater<Node>> q;
    for (size_t i = 0; i < m; ++i) q.push({c[used[i]], int(i)});
    int next = int(m);
    while (q.size() > 1) {
      Node a = q.top();
      q.pop();
      Node b = q.top();
      q.pop();
      parent[size_t(a.second)] = parent[size_t(b.second)] = next;
      q.push({a.first + b.first, next++});
    }
    int longest = 0;
    for (size_t i = 0; i < m; ++i) {
      int d = 0;
      for (int p = parent[i]; p >= 0; p = parent[size_t(p)]) ++d;
      len[used[i]] = d;
      longest = std::max(longest, d);
    }
    if (longest <= limit) return len;
    for (size_t i : used) c[i] = (c[i] >> 1) | 1;       // flatten and retry
  }
}

// canonical codes (bit-reversed for LSB-first writing) from lengths
std::vector<uint32_t> canonical(const std::vector<int>& len) {
  std::vector<uint32_t> codes(len.size(), 0);
  int used = 0;
  for (int l : len) used += l > 0;
  if (used < 2) return codes;                       // one symbol: 0 bits
  uint32_t code = 0;
  for (int l = 1; l <= kMaxLength; ++l) {
    for (size_t s = 0; s < len.size(); ++s)
      if (len[s] == l) codes[s] = reverse(code++, l);
    code <<= 1;
  }
  return codes;
}

struct Writer {
  std::vector<int> len;
  std::vector<uint32_t> code;
  bool single = false;
  void put(BitWriter& bw, int s) const {
    if (!single) bw.put(code[size_t(s)], len[size_t(s)]);
  }
};

// write a prefix code for the counts, as a simple code where libwebp
// allows one, and return its writer
Writer write_code(BitWriter& bw, const std::vector<uint32_t>& counts) {
  Writer wr;
  std::vector<int> used;
  for (size_t s = 0; s < counts.size(); ++s)
    if (counts[s]) used.push_back(int(s));
  if (used.empty()) used.push_back(0);
  if (used.size() <= 2 && used.back() < 256) {
    bw.put(1, 1);
    bw.put(uint32_t(used.size() - 1), 1);
    bool wide = used[0] > 1;
    bw.put(wide, 1);
    bw.put(uint32_t(used[0]), wide ? 8 : 1);
    if (used.size() == 2) bw.put(uint32_t(used[1]), 8);
    wr.len.assign(counts.size(), 0);
    for (int s : used) wr.len[size_t(s)] = 1;
    wr.single = used.size() == 1;
    wr.code = canonical(wr.len);
    return wr;
  }
  std::vector<uint32_t> c(counts);
  if (used.size() == 1) c[size_t(used[0] == 0 ? 1 : 0)] = 1;   // two symbols
  wr.len = code_lengths(c, kMaxLength);
  wr.code = canonical(wr.len);
  // the lengths as code-length symbols: 0-15, 17 / 18 zero runs, 16 repeats
  std::vector<std::pair<int, int>> tokens;           // (symbol, extra)
  const std::vector<int>& L = wr.len;
  size_t i = 0;
  int prev = 8;
  while (i < L.size()) {
    size_t j = i;
    while (j < L.size() && L[j] == L[i]) ++j;
    size_t run = j - i;
    if (L[i] == 0) {
      while (run >= 11) {
        size_t k = std::min<size_t>(run, 138);
        tokens.push_back({18, int(k - 11)});
        run -= k;
      }
      if (run >= 3) {
        tokens.push_back({17, int(run - 3)});
        run = 0;
      }
      while (run--) tokens.push_back({0, 0});
    } else {
      if (L[i] != prev) {
        tokens.push_back({L[i], 0});
        prev = L[i];
        --run;
      }
      while (run >= 3) {
        size_t k = std::min<size_t>(run, 6);
        tokens.push_back({16, int(k - 3)});
        run -= k;
      }
      while (run--) tokens.push_back({L[i], 0});
    }
    i = j;
  }
  std::vector<uint32_t> cl_counts(19, 0);
  for (auto& t : tokens) ++cl_counts[size_t(t.first)];
  std::vector<int> cl = code_lengths(cl_counts, 7);
  int ncl = 19;
  while (ncl > 4 && cl[size_t(kCodeLengthOrder[ncl - 1])] == 0) --ncl;
  bw.put(0, 1);                                      // normal
  bw.put(uint32_t(ncl - 4), 4);
  for (int k = 0; k < ncl; ++k) bw.put(uint32_t(cl[size_t(kCodeLengthOrder[k])]), 3);
  bw.put(0, 1);                                      // every symbol's length
  Writer clw;
  clw.len = cl;
  clw.code = canonical(cl);
  int cl_used = 0;
  for (int l : cl) cl_used += l > 0;
  clw.single = cl_used < 2;
  for (auto& t : tokens) {
    clw.put(bw, t.first);
    if (t.first == 16) bw.put(uint32_t(t.second), 2);
    if (t.first == 17) bw.put(uint32_t(t.second), 3);
    if (t.first == 18) bw.put(uint32_t(t.second), 7);
  }
  return wr;
}

void prefix_encode(int64_t value, int* symbol, int* extra_bits,
                   uint32_t* extra) {
  // value >= 1, as libwebp's GetCopyDistance inverts it
  int64_t v = value - 1;
  if (v < 4) {
    *symbol = int(v);
    *extra_bits = 0;
    *extra = 0;
    return;
  }
  int hb = 63 - __builtin_clzll(uint64_t(v));
  int second = int((v >> (hb - 1)) & 1);
  *extra_bits = hb - 1;
  *symbol = 2 * hb + second;
  *extra = uint32_t(v & ((int64_t(1) << *extra_bits) - 1));
}

struct Token {
  int kind;        // 0 literal, 1 copy, 2 cache
  uint32_t argb;   // the literal, or the cache index
  int64_t length, dist_code;
};

const int kCacheBits = 10;

// LZ77 with a hash chain over 3 pixels, and the colour cache
std::vector<Token> tokenize(const std::vector<uint32_t>& px, int64_t w,
                            int cache_bits) {
  const int64_t n = int64_t(px.size());
  std::vector<Token> toks;
  const int kHashBits = 16, kChain = 24, kMaxLen = 4096, kMinLen = 3;
  // a window of 2^16 pixels (more than a row of the widest image), whose
  // chain and pixels stay in the cache
  const int64_t kWindow = std::min<int64_t>(int64_t(1) << 16, n);
  std::vector<int64_t> head(size_t(1) << kHashBits, -1), prev(size_t(n), -1);
  auto hash = [&](int64_t i) {
    uint64_t h = uint64_t(px[size_t(i)]) * 0x9E3779B97F4A7C15ull ^
                 uint64_t(px[size_t(i + 1)]) * 0xC2B2AE3D27D4EB4Full ^
                 uint64_t(px[size_t(i + 2)]) * 0x165667B19E3779F9ull;
    return size_t(h >> (64 - kHashBits));
  };
  // distances a plane code names (the smallest code for each)
  std::unordered_map<int64_t, int> plane;
  for (int c = 120; c >= 1; --c) plane[plane_distance(w, c)] = c;
  std::vector<uint32_t> cache(size_t(1) << cache_bits, 0);
  std::vector<bool> filled(size_t(1) << cache_bits, false);
  const uint32_t shift = 32 - uint32_t(cache_bits);
  auto insert = [&](uint32_t v) {
    size_t k = (0x1e35a7bdu * v) >> shift;
    cache[k] = v;
    filled[k] = true;
  };
  auto link = [&](int64_t i) {
    if (i + 2 < n) {
      size_t h = hash(i);
      prev[size_t(i)] = head[h];
      head[h] = i;
    }
  };
  int64_t i = 0;
  while (i < n) {
    int64_t best_len = 0, best_dist = 0;
    if (i + kMinLen <= n) {
      // the pixel above and the previous one, then the chain
      auto try_at = [&](int64_t j) {
        if (j < 0 || j >= i || i - j > kWindow) return;
        int64_t l = 0, lim = std::min<int64_t>(kMaxLen, n - i);
        while (l < lim && px[size_t(j + l)] == px[size_t(i + l)]) ++l;
        if (l > best_len) {
          best_len = l;
          best_dist = i - j;
        }
      };
      try_at(i - 1);
      try_at(i - w);
      int chain = 0;
      for (int64_t j = head[hash(i)]; j >= 0 && chain < kChain && i - j <= kWindow;
           j = prev[size_t(j)], ++chain)
        try_at(j);
    }
    if (best_len >= kMinLen) {
      auto it = plane.find(best_dist);
      int64_t code = it != plane.end() ? it->second : best_dist + 120;
      toks.push_back({1, 0, best_len, code});
      for (int64_t k = 0; k < best_len; ++k) {
        link(i + k);
        insert(px[size_t(i + k)]);
      }
      i += best_len;
      continue;
    }
    uint32_t v = px[size_t(i)];
    size_t key = (0x1e35a7bdu * v) >> shift;
    if (filled[key] && cache[key] == v)
      toks.push_back({2, uint32_t(key), 0, 0});
    else
      toks.push_back({0, v, 0, 0});
    insert(v);
    link(i);
    ++i;
  }
  return toks;
}

// one entropy-coded image: [colour cache], [no meta codes at level 0], five
// prefix codes, the tokens
void write_stream(BitWriter& bw, const std::vector<uint32_t>& px, int64_t w,
                  bool level0, bool lz77) {
  const int cache_bits = lz77 ? kCacheBits : 0;
  std::vector<Token> toks;
  if (lz77) {
    toks = tokenize(px, w, cache_bits);
  } else {
    for (uint32_t v : px) toks.push_back({0, v, 0, 0});
  }
  if (cache_bits) {
    bw.put(1, 1);
    bw.put(uint32_t(cache_bits), 4);
  } else {
    bw.put(0, 1);
  }
  if (level0) bw.put(0, 1);                          // no meta prefix codes
  const int cache_size = cache_bits ? 1 << cache_bits : 0;
  std::vector<uint32_t> counts[5] = {
      std::vector<uint32_t>(size_t(280 + cache_size), 0),
      std::vector<uint32_t>(256, 0), std::vector<uint32_t>(256, 0),
      std::vector<uint32_t>(256, 0), std::vector<uint32_t>(40, 0)};
  for (const Token& t : toks) {
    if (t.kind == 0) {
      ++counts[0][(t.argb >> 8) & 0xff];
      ++counts[1][(t.argb >> 16) & 0xff];
      ++counts[2][t.argb & 0xff];
      ++counts[3][t.argb >> 24];
    } else if (t.kind == 2) {
      ++counts[0][280 + t.argb];
    } else {
      int s, eb;
      uint32_t ex;
      prefix_encode(t.length, &s, &eb, &ex);
      ++counts[0][size_t(256 + s)];
      prefix_encode(t.dist_code, &s, &eb, &ex);
      ++counts[4][size_t(s)];
    }
  }
  Writer wr[5];
  for (int k = 0; k < 5; ++k) wr[k] = write_code(bw, counts[k]);
  for (const Token& t : toks) {
    if (t.kind == 0) {
      wr[0].put(bw, int((t.argb >> 8) & 0xff));
      wr[1].put(bw, int((t.argb >> 16) & 0xff));
      wr[2].put(bw, int(t.argb & 0xff));
      wr[3].put(bw, int(t.argb >> 24));
    } else if (t.kind == 2) {
      wr[0].put(bw, int(280 + t.argb));
    } else {
      int s, eb;
      uint32_t ex;
      prefix_encode(t.length, &s, &eb, &ex);
      wr[0].put(bw, 256 + s);
      bw.put(ex, eb);
      prefix_encode(t.dist_code, &s, &eb, &ex);
      wr[4].put(bw, s);
      bw.put(ex, eb);
    }
  }
}

uint32_t sub_pixels(uint32_t a, uint32_t b) {
  uint32_t ag = 0x00ff00ffu + (a & 0xff00ff00u) - (b & 0xff00ff00u);
  uint32_t rb = 0xff00ff00u + (a & 0x00ff00ffu) - (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

int residual_cost(uint32_t r) {
  int c = 0;
  for (int s = 0; s < 32; s += 8) {
    int v = int((r >> s) & 0xff);
    c += v < 128 ? v : 256 - v;
  }
  return c;
}

std::vector<uint8_t> encode(const uint8_t* img, int64_t h, int64_t w,
                            int64_t channels) {
  if (channels != 1 && channels != 3 && channels != 4)
    fail("OpenCV's WebP writer takes 1, 3 or 4 channels");
  if (h < 1 || w < 1 || h > 16383 || w > 16383)
    fail("a WebP's sides are 1 to 16383 pixels: cv2.imencode fails too "
         "(WebP encoding failed with lossless_mode=1)");
  const int64_t n = h * w;
  std::vector<uint32_t> px(static_cast<size_t>(n));
  bool alpha = false;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* p = img + i * channels;
    uint32_t b = p[0], g = channels == 1 ? p[0] : p[1],
             r = channels == 1 ? p[0] : p[2], a = channels == 4 ? p[3] : 255;
    if (a != 255) alpha = true;
    px[size_t(i)] = a ? (a << 24 | r << 16 | g << 8 | b) : 0;
  }
  BitWriter bw;
  bw.put(0x2f, 8);
  bw.put(uint32_t(w - 1), 14);
  bw.put(uint32_t(h - 1), 14);
  bw.put(alpha, 1);
  bw.put(0, 3);
  // subtract green
  for (uint32_t& v : px) {
    uint32_t g = (v >> 8) & 0xff;
    uint32_t r = ((v >> 16) - g) & 0xff, b = (v - g) & 0xff;
    v = (v & 0xff00ff00u) | r << 16 | b;
  }
  bw.put(1, 1);
  bw.put(2, 2);
  // the predictor: one mode a tile, the least sum of absolute residuals
  const int bits = 4;
  const int64_t tx = subsample(w, bits), ty = subsample(h, bits);
  std::vector<uint32_t> modes(size_t(tx * ty), 0xff000000u | 11u << 8);
  std::vector<uint32_t> res(static_cast<size_t>(n));
  for (int64_t by = 0; by < ty; ++by)
    for (int64_t bx = 0; bx < tx; ++bx) {
      const int64_t y0 = by << bits, x0 = bx << bits;
      const int64_t y1 = std::min(h, y0 + (1 << bits)),
                    x1 = std::min(w, x0 + (1 << bits));
      int64_t best = -1;
      int best_mode = 0;
      // each mode scored on every other row and column of the tile
      for (int m = 0; m < 14; ++m) {
        int64_t cost = 0;
        for (int64_t y = std::max<int64_t>(y0, 1); y < y1 && (best < 0 || cost < best); y += 2)
          for (int64_t x = std::max<int64_t>(x0, 1); x < x1; x += 2) {
            const uint32_t* p = px.data() + y * w + x;
            cost += residual_cost(sub_pixels(*p, predict(m, p, w)));
          }
        if (best < 0 || cost < best) {
          best = cost;
          best_mode = m;
        }
      }
      modes[size_t(by * tx + bx)] = 0xff000000u | uint32_t(best_mode) << 8;
    }
  res[0] = sub_pixels(px[0], 0xff000000u);
  for (int64_t x = 1; x < w; ++x) res[size_t(x)] = sub_pixels(px[size_t(x)], px[size_t(x - 1)]);
  for (int64_t y = 1; y < h; ++y) {
    res[size_t(y * w)] = sub_pixels(px[size_t(y * w)], px[size_t((y - 1) * w)]);
    for (int64_t x = 1; x < w; ++x) {
      int m = int((modes[size_t((y >> bits) * tx + (x >> bits))] >> 8) & 0xf);
      const uint32_t* p = px.data() + y * w + x;
      res[size_t(y * w + x)] = sub_pixels(*p, predict(m, p, w));
    }
  }
  bw.put(1, 1);
  bw.put(0, 2);
  bw.put(bits - 2, 3);
  write_stream(bw, modes, tx, false, false);
  bw.put(0, 1);                                      // no more transforms
  write_stream(bw, res, w, true, true);
  bw.flush();
  std::vector<uint8_t>& vp8l = bw.out;
  const size_t pad = vp8l.size() & 1;
  std::vector<uint8_t> o = {'R', 'I', 'F', 'F', 0, 0, 0, 0, 'W', 'E', 'B',
                            'P', 'V', 'P', '8', 'L'};
  auto le = [&](uint32_t v) {
    for (int k = 0; k < 4; ++k) o.push_back(uint8_t(v >> (8 * k)));
  };
  le(uint32_t(vp8l.size()));
  o.insert(o.end(), vp8l.begin(), vp8l.end());
  if (pad) o.push_back(0);
  uint32_t riff = uint32_t(o.size() - 8);
  for (int k = 0; k < 4; ++k) o[size_t(4 + k)] = uint8_t(riff >> (8 * k));
  return o;
}

void set_error(char* err, int64_t errlen, const std::string& msg) {
  if (err && errlen > 0) {
    size_t n = msg.size() < size_t(errlen - 1) ? msg.size()
                                               : size_t(errlen - 1);
    std::memcpy(err, msg.data(), n);
    err[n] = 0;
  }
}

}  // namespace

extern "C" {

// dims = {height, width} of the decoded image (the canvas). Returns 0, or
// -1 with a message in err.
int oodt_webp_info(const uint8_t* data, int64_t len, int64_t* dims, char* err,
                   int64_t errlen) {
  try {
    decode(data, size_t(len), dims, nullptr, nullptr);
    return 0;
  } catch (const WebpError& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

// Decode into out, (height, width, 3) uint8 BGR of the size oodt_webp_info
// gave; stats (8 values) gets what the bitstream used: the transforms (a bit
// a type), the colour cache's bits, the meta codes' bits, the predictor
// modes (a bit a mode), the backward references, the colour cache's hits,
// the plane codes, the colour-indexing bits + 1. Returns 0, or -1 with a
// message in err.
int oodt_webp_decode(const uint8_t* data, int64_t len, uint8_t* out,
                     int64_t height, int64_t width, int64_t* stats, char* err,
                     int64_t errlen) {
  try {
    int64_t dims[2] = {height, width};
    Stats st;
    decode(data, size_t(len), dims, out, &st);
    const int64_t s[8] = {st.transforms, st.cache_bits, st.meta_bits, st.modes,
                          st.copies, st.cache_hits, st.plane_codes,
                          st.palette_bits};
    std::memcpy(stats, s, sizeof(s));
    return 0;
  } catch (const WebpError& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

// Encode (h, w, channels) uint8 grey, BGR or BGRA as a lossless WebP.
// Returns the file's size, writing it into out when it fits in cap bytes
// (call again with a larger buffer otherwise), or -1 with a message in err.
int64_t oodt_webp_encode(const uint8_t* img, int64_t h, int64_t w,
                         int64_t channels, uint8_t* out, int64_t cap,
                         char* err, int64_t errlen) {
  try {
    std::vector<uint8_t> o = encode(img, h, w, channels);
    if (int64_t(o.size()) <= cap) std::memcpy(out, o.data(), o.size());
    return int64_t(o.size());
  } catch (const WebpError& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

}  // extern "C"
