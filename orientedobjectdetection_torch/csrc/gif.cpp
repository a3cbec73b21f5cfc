// The GIF reader and writer on the host (C++17, no dependencies), after
// what OpenCV 5.0's own GIF codec (grfmt_gif.cpp, not giflib) gives
// cv2.imdecode with IMREAD_COLOR and writes for cv2.imencode(".gif") with
// its defaults, for the JAX package.
//
// Reader: the first image of a GIF87a or GIF89a file, as OpenCV reads it.
//   - The whole file is walked first, as OpenCV counts its frames: every
//     block up to the trailer (0x3B) must be an extension (0x21) or an
//     image (0x2C) whose sub-blocks all lie in the file; a file that ends
//     before its trailer, or holds another block, is refused, and so is a
//     file of no image. (OpenCV reads the 3-byte sub-block of an
//     application extension other than NETSCAPE2.0 as 2 bytes.)
//   - The extensions before the first image are read: a graphic control
//     extension must be 4 bytes long and of disposal 0-3, and the last one
//     sets the transparent index (or none); the others are skipped.
//   - The logical screen starts as the global table's background colour,
//     or black where there is no global table (a background index past the
//     global table is refused). The image must lie inside the screen; a
//     pixel of the transparent index keeps the screen's colour, another
//     takes its local table's colour where the index is inside that table,
//     else the global table's, and an index past both is refused (a file of
//     neither table takes OpenCV's own: grey i at index i, white at 1).
//     Codes past 255 (minimum code sizes 9-11) are taken modulo 256.
//   - LZW as OpenCV decodes it: minimum code sizes 2-11, codes LSB first
//     across the sub-blocks, a byte read only when the bits held are fewer
//     than the code width, widths growing to 12 bits, clear codes, a full
//     table left uncleared (no entries are added then). An end code resets
//     the coder as a clear does and stops the codes of the bits held until
//     the next byte is read (none is, at the last byte). A code that would
//     write past the image's last pixel is refused; a code after the last
//     pixel is dropped unchecked, but the data must then end (OpenCV fails
//     at the next byte it reads); data that ends before the last pixel is
//     refused. Interlaced images fill rows 0, 8, ..., 4, 12, ..., 2, 6, ...,
//     1, 3, ... .
//   The output is IMREAD_COLOR's (height, width, 3) uint8 BGR: OpenCV's
//   BGRA screen with its alpha dropped.
//
// Writer: oodt_gif_encode, the bytes cv2.imencode(".gif", img) gives of
// uint8 BGR or BGRA with OpenCV's defaults (IMWRITE_GIF_FAST_FLOYD_DITHER):
// GIF89a, a 256-entry global table of 8 levels of red and green (36 * r)
// and 4 of blue (85 * b), entry r << 5 | g << 2 | b; a NETSCAPE2.0 loop
// extension (forever); a graphic control extension of disposal 3, delay
// 100; one full image, no local table, LZW of minimum code size 8 in
// 255-byte sub-blocks, a clear code first and again as soon as the table
// fills. The indices are Floyd-Steinberg error diffusion onto the table in
// float32, left to right on every row (7/16 right, 3/16, 5/16 and
// 1/16 below), each channel rounded to its nearest level (halves up). A
// BGRA pixel of alpha 0 is transparent: index 146, diffusing no error;
// where there is one, the file names 146 transparent, entry 146 holds the
// last transparent pixel's colour and the other pixels that round to 146
// take 142.
//
// A plain C ABI, loaded with ctypes (native.py builds it into one library
// with the other host sources). No global state: calls from several
// threads run in parallel.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

struct GifError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw GifError{msg}; }

const char* const kOpenCvToo = ": OpenCV does not read it either";
const int64_t kMaxPixels = int64_t(1) << 30;  // CV_IO_MAX_IMAGE_PIXELS

// OpenCV's RLByteStream over the file's bytes: a read past the end fails
struct Stream {
  const uint8_t* data;
  size_t len, pos = 0;
  Stream(const uint8_t* d, size_t n) : data(d), len(n) {}
  int byte() {
    if (pos >= len) fail("the file ends early");
    return data[pos++];
  }
  int word() {
    int lo = byte();
    return lo | byte() << 8;
  }
  void skip(size_t n) {
    if (n > len - pos) fail("the file ends early");
    pos += n;
  }
  void skip_sub_blocks() {
    for (int n = byte(); n; n = byte()) skip(size_t(n));
  }
};

struct Screen {
  int width = 0, height = 0;
  int global_size = 0;             // entries, 0 without a global table
  const uint8_t* global = nullptr;  // RGB
  int background = 0;
  size_t body = 0;                 // the first block after the header
};

Screen read_screen(Stream& s) {
  Screen sc;
  if (s.len < 6 || (std::memcmp(s.data, "GIF87a", 6) != 0 &&
                    std::memcmp(s.data, "GIF89a", 6) != 0))
    fail("not a GIF file");
  s.skip(6);
  sc.width = s.word();
  sc.height = s.word();
  int flags = s.byte();
  sc.background = s.byte();
  s.byte();                                            // aspect ratio
  if (flags & 0x80) {
    sc.global_size = 1 << ((flags & 7) + 1);
    sc.global = s.data + s.pos;
    s.skip(size_t(3 * sc.global_size));
  }
  if (!sc.width || !sc.height)
    fail("a logical screen of no pixels" + std::string(kOpenCvToo));
  if (int64_t(sc.width) * sc.height > kMaxPixels)
    fail("past OpenCV's image size limit" + std::string(kOpenCvToo));
  sc.body = s.pos;
  // OpenCV counts the frames first: every block to the trailer
  int frames = 0;
  for (int kind = s.byte(); kind != 0x3B; kind = s.byte()) {
    if (kind == 0x21 && s.byte() == 0xFF) {
      // an application extension, as OpenCV reads it for the loop count:
      // a 3-byte sub-block after an identifier other than NETSCAPE2.0
      // loses its first byte
      bool netscape = false;
      for (int n = s.byte(); n; n = s.byte()) {
        if (n == 11) {
          netscape = s.len - s.pos >= 11 &&
                     std::memcmp(s.data + s.pos, "NETSCAPE2.0", 11) == 0;
          s.skip(11);
        } else if (n == 3) {
          s.skip(netscape ? 3 : 2);
        } else {
          s.skip(size_t(n));
        }
      }
    } else if (kind == 0x21) {
      s.skip_sub_blocks();
    } else if (kind == 0x2C) {
      ++frames;
      s.skip(8);
      int f = s.byte();
      if (f & 0x80) s.skip(size_t(3) << ((f & 7) + 1));
      s.byte();                                        // LZW code size
      s.skip_sub_blocks();
    } else {
      fail("a block of type " + std::to_string(kind) +
           " before the trailer" + kOpenCvToo);
    }
  }
  if (!frames) fail("a GIF of no image" + std::string(kOpenCvToo));
  if (sc.global_size && sc.background >= sc.global_size)
    fail("a background index past the global colour table" +
         std::string(kOpenCvToo));
  return sc;
}

// The LZW code stream of one image (after its minimum code size) -> its
// width * height colour indices, as OpenCV's lzwDecode reads them.
void lzw_decode(Stream& s, int min_size, int64_t total, uint8_t* out) {
  if (min_size < 2 || min_size > 11)
    fail("LZW minimum code size " + std::to_string(min_size) + kOpenCvToo);
  const int clear = 1 << min_size, end = clear + 1;
  // each entry: its prefix entry (-1 for a single index), its last index,
  // its first index and its length
  std::vector<int32_t> prefix(4096), length(4096);
  std::vector<uint8_t> last(4096), first(4096);
  for (int c = 0; c < clear; ++c) {
    prefix[c] = -1;
    last[c] = first[c] = uint8_t(c);
    length[c] = 1;
  }
  int size = min_size + 1, next = end + 1, prev = -1;
  int64_t idx = 0;
  uint32_t src = 0;
  int bits = 0;
  std::vector<uint8_t> str(4096);
  int block = s.byte();
  while (block) {
    if (bits < size) {
      // a byte is read only for a code it completes, and none after a
      // code past the last pixel
      if (idx > total) fail("the image data runs past its last pixel");
      src |= uint32_t(s.byte()) << bits;
      bits += 8;
      --block;
    }
    while (bits >= size) {
      int code = int(src & ((1u << size) - 1));
      src >>= size;
      bits -= size;
      if (code == clear || code == end) {
        size = min_size + 1;
        next = end + 1;
        prev = -1;
        if (code == end) break;
        continue;
      }
      if (idx >= total) {          // past the last pixel: counted, unchecked
        ++idx;
        continue;
      }
      int head;
      if (prev < 0) {
        if (code >= clear) fail("an LZW code past the table");
        head = code;
      } else if (code < next || (code == next && next < 4096)) {
        head = code == next ? first[prev] : first[code];
        if (next < 4096) {
          prefix[next] = prev;
          last[next] = uint8_t(head);
          first[next] = first[prev];
          length[next] = length[prev] + 1;
          ++next;
        }
      } else {
        fail("an LZW code past the table");
      }
      int n = length[code];
      if (idx + n > total) fail("the image data runs past its last pixel");
      for (int e = code, k = n - 1; k >= 0; --k, e = prefix[e])
        str[size_t(k)] = last[size_t(e)];
      std::memcpy(out + idx, str.data(), size_t(n));
      idx += n;
      if (next == (1 << size) && size < 12) ++size;
      prev = code;
    }
    if (!block) block = s.byte();
  }
  if (idx < total) fail("the image data ends early");
}

// dims: {height, width}, written without out, checked with it
void decode(const uint8_t* data, size_t len, int64_t* dims, uint8_t* out) {
  Stream s(data, len);
  Screen sc = read_screen(s);
  if (!out) {
    dims[0] = sc.height;
    dims[1] = sc.width;
    return;
  }
  if (dims[0] != sc.height || dims[1] != sc.width)
    fail("an output of another size than the logical screen");
  s.pos = sc.body;
  bool transparent = false;
  int transparent_index = 0;
  int kind = s.byte();
  for (; kind == 0x21; kind = s.byte()) {
    if (s.byte() == 0xF9) {
      transparent = false;
      if (s.byte() != 4)
        fail("a graphic control extension not 4 bytes long" +
             std::string(kOpenCvToo));
      int flags = s.byte();
      s.word();                                        // delay
      transparent_index = s.byte();
      int disposal = (flags >> 2) & 7;
      if (disposal > 3)
        fail("disposal method " + std::to_string(disposal) + kOpenCvToo);
      transparent = flags & 1;
    }
    s.skip_sub_blocks();
  }
  if (kind != 0x2C) fail("no image after the extensions");
  int left = s.word(), top = s.word(), fw = s.word(), fh = s.word();
  if (left + fw > sc.width || top + fh > sc.height)
    fail("an image past the logical screen" + std::string(kOpenCvToo));
  if (!fw || !fh) fail("an image of no pixels" + std::string(kOpenCvToo));
  int flags = s.byte();
  int local_size = 0;
  const uint8_t* local = nullptr;
  if (flags & 0x80) {
    local_size = 1 << ((flags & 7) + 1);
    local = s.data + s.pos;
    s.skip(size_t(3 * local_size));
  }
  // with neither table, OpenCV's own: grey i at index i, white at 1
  uint8_t grey[3 * 256];
  if (!local_size && !sc.global_size) {
    for (int i = 0; i < 256; ++i) grey[3 * i] = grey[3 * i + 1] =
        grey[3 * i + 2] = uint8_t(i == 1 ? 255 : i);
    local = grey;
    local_size = 256;
  }
  const int64_t total = int64_t(fw) * fh;
  std::vector<uint8_t> indices(static_cast<size_t>(total));
  lzw_decode(s, s.byte(), total, indices.data());
  uint8_t bg[3] = {0, 0, 0};
  if (sc.global_size)
    for (int c = 0; c < 3; ++c) bg[c] = sc.global[3 * sc.background + 2 - c];
  const int64_t w = sc.width, h = sc.height;
  for (int64_t i = 0; i < w * h; ++i) std::memcpy(out + 3 * i, bg, 3);
  // the frame's rows in stored order: plain, or the four interlaced passes
  std::vector<int> rows;
  if (flags & 0x40) {
    static const int kPass[4][2] = {{0, 8}, {4, 8}, {2, 4}, {1, 2}};
    for (const auto& p : kPass)
      for (int y = p[0]; y < fh; y += p[1]) rows.push_back(y);
  } else {
    for (int y = 0; y < fh; ++y) rows.push_back(y);
  }
  for (int r = 0; r < fh; ++r) {
    const uint8_t* src = indices.data() + int64_t(r) * fw;
    uint8_t* dst = out + 3 * ((top + rows[size_t(r)]) * w + left);
    for (int x = 0; x < fw; ++x, dst += 3) {
      int v = src[x];
      if (transparent && v == transparent_index) continue;
      const uint8_t* rgb;
      if (v < local_size)
        rgb = local + 3 * v;
      else if (v < sc.global_size)
        rgb = sc.global + 3 * v;
      else
        fail("a colour index past the colour tables" +
             std::string(kOpenCvToo));
      dst[0] = rgb[2];
      dst[1] = rgb[1];
      dst[2] = rgb[0];
    }
  }
}

// ---- the writer -------------------------------------------------------------
const int kTransparentIndex = 146;  // OpenCV's, and what 146 becomes then
const int kTransparentStandIn = 142;

// Floyd-Steinberg diffusion onto the fixed table: (h, w) indices. The
// errors sum in float32, from 0, and each value is the pixel plus its
// error in float32, as OpenCV's ditheringKernel computes them.
std::vector<uint8_t> dither(const uint8_t* img, int64_t h, int64_t w,
                            int64_t channels, bool any_transparent) {
  std::vector<uint8_t> out(static_cast<size_t>(h * w));
  // the errors of the current row and the next, a column either side
  std::vector<float> cur(size_t(3 * (w + 2))), nxt(size_t(3 * (w + 2)));
  static const float kStep[3] = {85.0f, 36.0f, 36.0f};   // B, G, R
  static const int kTop[3] = {3, 7, 7};
  for (int64_t y = 0; y < h; ++y) {
    std::fill(nxt.begin(), nxt.end(), 0.0f);
    for (int64_t x = 0; x < w; ++x) {
      const uint8_t* px = img + (y * w + x) * channels;
      const bool clear = channels == 4 && px[3] == 0;
      int q[3];
      for (int c = 0; c < 3; ++c) {
        float v = float(px[c]) + cur[size_t(3 * (x + 1) + c)];
        int k = int(std::floor(v / kStep[c] + 0.5f));
        k = k < 0 ? 0 : (k > kTop[c] ? kTop[c] : k);
        q[c] = k;
        float e = clear ? 0.0f : v - float(k) * kStep[c];
        cur[size_t(3 * (x + 2) + c)] += e * 7 / 16;
        nxt[size_t(3 * x + c)] += e * 3 / 16;
        nxt[size_t(3 * (x + 1) + c)] += e * 5 / 16;
        nxt[size_t(3 * (x + 2) + c)] += e * 1 / 16;
      }
      int index = q[2] << 5 | q[1] << 2 | q[0];
      if (clear)
        index = kTransparentIndex;
      else if (any_transparent && index == kTransparentIndex)
        index = kTransparentStandIn;
      out[size_t(y * w + x)] = uint8_t(index);
    }
    std::swap(cur, nxt);
  }
  return out;
}

// OpenCV's LZW: minimum code size 8, a clear code first and after the code
// that fills the table's last entry; codes LSB first
std::vector<uint8_t> lzw_encode(const std::vector<uint8_t>& idx) {
  const int clear = 256, end = 257;
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int bits = 0;
  auto put = [&](int code, int size) {
    acc |= uint64_t(code) << bits;
    bits += size;
    while (bits >= 8) {
      out.push_back(uint8_t(acc));
      acc >>= 8;
      bits -= 8;
    }
  };
  // the table as a child array: (entry, index) -> entry, -1 where none
  std::vector<int16_t> child(size_t(4096) * 256, -1);
  std::vector<int> used;
  int size = 9, next = end + 1;
  put(clear, size);
  int s = idx.empty() ? -1 : idx[0];
  for (size_t i = 1; i < idx.size(); ++i) {
    int px = idx[i];
    int16_t c = child[size_t(s) * 256 + size_t(px)];
    if (c >= 0) {
      s = c;
      continue;
    }
    put(s, size);
    child[size_t(s) * 256 + size_t(px)] = int16_t(next);
    used.push_back(s * 256 + px);
    ++next;
    if (next == 4096) {
      put(clear, size);
      for (int u : used) child[size_t(u)] = -1;
      used.clear();
      size = 9;
      next = end + 1;
    } else if (next > (1 << size)) {
      ++size;
    }
    s = px;
  }
  if (s >= 0) put(s, size);
  put(end, size);
  if (bits) out.push_back(uint8_t(acc));
  return out;
}

std::vector<uint8_t> encode(const uint8_t* img, int64_t h, int64_t w,
                            int64_t channels) {
  if (channels != 3 && channels != 4)
    fail("OpenCV's GIF writer takes 3 or 4 channels: (-215:Assertion "
         "failed) false in function 'ditheringKernel'");
  if (h < 1 || w < 1 || h > 65535 || w > 65535)
    fail("a GIF's sides are 1 to 65535 pixels: cv2.imencode fails too");
  bool any = false;
  int64_t last = -1;
  if (channels == 4)
    for (int64_t i = 0; i < h * w; ++i)
      if (img[4 * i + 3] == 0) {
        any = true;
        last = i;
      }
  std::vector<uint8_t> idx = dither(img, h, w, channels, any);
  std::vector<uint8_t> o = {'G', 'I', 'F', '8', '9', 'a'};
  auto word = [&](int64_t v) {
    o.push_back(uint8_t(v));
    o.push_back(uint8_t(v >> 8));
  };
  word(w);
  word(h);
  o.insert(o.end(), {0xF7, 0x00, 0x00});
  for (int i = 0; i < 256; ++i) {
    uint8_t rgb[3] = {uint8_t((i >> 5) * 36), uint8_t(((i >> 2) & 7) * 36),
                      uint8_t((i & 3) * 85)};
    if (any && i == kTransparentIndex)
      for (int c = 0; c < 3; ++c) rgb[c] = img[4 * last + 2 - c];
    o.insert(o.end(), rgb, rgb + 3);
  }
  static const uint8_t kLoop[] = {0x21, 0xFF, 0x0B, 'N', 'E', 'T', 'S', 'C',
                                  'A', 'P', 'E', '2', '.', '0', 0x03, 0x01,
                                  0x00, 0x00, 0x00};
  o.insert(o.end(), kLoop, kLoop + sizeof(kLoop));
  o.insert(o.end(), {0x21, 0xF9, 0x04, uint8_t(any ? 0x0D : 0x0C), 0x64,
                     0x00, uint8_t(any ? kTransparentIndex : 0), 0x00});
  o.push_back(0x2C);
  word(0);
  word(0);
  word(w);
  word(h);
  o.push_back(0x07);
  o.push_back(8);
  std::vector<uint8_t> code = lzw_encode(idx);
  for (size_t at = 0; at < code.size(); at += 255) {
    size_t n = code.size() - at < 255 ? code.size() - at : 255;
    o.push_back(uint8_t(n));
    o.insert(o.end(), code.begin() + long(at), code.begin() + long(at + n));
  }
  o.push_back(0x00);
  o.push_back(0x3B);
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

// dims = {height, width} of the logical screen. Returns 0, or -1 with a
// message in err (every check of the file's structure is made here).
int oodt_gif_info(const uint8_t* data, int64_t len, int64_t* dims, char* err,
                  int64_t errlen) {
  try {
    decode(data, size_t(len), dims, nullptr);
    return 0;
  } catch (const GifError& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

// Decode the first image into out, (height, width, 3) uint8 BGR of the
// size oodt_gif_info gave. Returns 0, or -1 with a message in err.
int oodt_gif_decode(const uint8_t* data, int64_t len, uint8_t* out,
                    int64_t height, int64_t width, char* err,
                    int64_t errlen) {
  try {
    int64_t dims[2] = {height, width};
    decode(data, size_t(len), dims, out);
    return 0;
  } catch (const GifError& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

// Encode (h, w, channels) uint8 BGR or BGRA as cv2.imencode(".gif") writes
// it. Returns the file's size, writing it into out when it fits in cap
// bytes (call again with a larger buffer otherwise), or -1 with a message
// in err.
int64_t oodt_gif_encode(const uint8_t* img, int64_t h, int64_t w,
                        int64_t channels, uint8_t* out, int64_t cap,
                        char* err, int64_t errlen) {
  try {
    std::vector<uint8_t> o = encode(img, h, w, channels);
    if (int64_t(o.size()) <= cap) std::memcpy(out, o.data(), o.size());
    return int64_t(o.size());
  } catch (const GifError& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

}  // extern "C"
