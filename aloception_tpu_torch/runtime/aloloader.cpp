// Native image code for aloception_tpu_torch: PNG and BMP decoded at their
// native size, from a file or from memory, the bilinear resize + normalize
// of the batch loader into caller-owned float buffers, cv2's fixed-point
// bilinear resize of uint8 images, the polygon fill of COCO segmentations
// and the thick lines and rectangles of the views, and the bit packer of
// the recording's MPEG-4 Part 2 intra VOPs.
//
// Counterpart of aloception_tpu/runtime/aloloader.cpp (threaded decode +
// resize + normalize), which links libjpeg and libpng. The machine that
// holds the card has neither, only zlib; JPEG and WebP are decoded by
// Pillow's libjpeg-turbo and libwebp (runtime/loader.py), and this file
// carries the decoders Pillow cannot stand in for:
//   - PNG: every colour type at 1-16 bits, interlaced or not, inflated
//     with zlib (Pillow reduces 16-bit colour to 8 bits); a colour PNG read
//     as grey through libpng's png_set_rgb_to_gray as cv2 sets it up
//     (rgb_to_grey_png), its 8- and 16-bit gamma tables included.
//   - BMP: uncompressed 8 (palette), 24 and 32 bits; read as grey through
//     cv2's icvCvt_BGR2Gray (14-bit fixed point), or, for 32 bits with
//     bit fields in a header of 56 bytes or more, the float32 weighted sum
//     cv2 truncates (grey_14, grey_float); 32 bits with bit fields read as
//     stored keep their alpha.
// Decoding raises nothing: every entry returns a status and writes the
// reason of a failure into the caller's message buffer.
//
// Build: g++ -O3 -march=native -std=c++17 -shared -fPIC aloloader.cpp -lz
//        -o libaloloader.so
//
// C ABI (ctypes; the caller releases nothing but what alo_decode hands out,
// with alo_free):
//   alo_decode(path, mode, &h, &w, &c, &bytes_per_sample, &data, err,
//              errlen) -> 0 or an error code
//     mode: 0 = colour (RGB, 8 bit, as cv2.IMREAD_COLOR after BGR->RGB),
//           1 = grey (8 bit, cv2.IMREAD_GRAYSCALE),
//           2 = grey at the stored depth (cv2.IMREAD_ANYDEPTH),
//           3 = as stored (channels and depth, RGB(A) order).
//   alo_resize_normalize(src, h, w, out, H, W, mode, mean, std): an RGB
//     uint8 image to (H, W, 3) float32 as the JAX loader does: mode 0 = raw
//     0..255, 1 = /255, 2 = resnet.
//   alo_decode_buffer(buf, len, mode, ...): alo_decode of a PNG or BMP
//     held in memory (cv2.imdecode).
//   alo_fill_poly(mask, h, w, xy, n): cv2.fillPoly(mask, [xy], 1) with
//     8-connected edges, integer vertices.
//   alo_resize_linear_u8(src, h, w, c, dst, H, W): cv2.resize(src, (W, H),
//     interpolation=INTER_LINEAR) of an (h, w, c) uint8 image.
//   alo_line(img, h, w, c, x1, y1, x2, y2, color, thickness) and
//   alo_rectangle(...): cv2.line and cv2.rectangle (LINE_8, thickness >= 2)
//     on an (h, w, c) uint8 image.
//   alo_mpeg4_intra_vop(levels, mb_w, mb_h, qp, seconds, increment,
//     increment_bits, tables, out, cap) -> bytes written, or -1 if more
//     than cap: one I-VOP of ISO/IEC 14496-2 (aloscene/renderer/video.py
//     says what it codes and lays out the tables).

#include <zlib.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum Status {
  kOk = 0,
  kNoFile = 1,      // cannot open or read the file
  kUnknown = 2,     // not a PNG or BMP
  kCorrupt = 3,     // the data is damaged or truncated
  kUnsupported = 4  // a valid file with a feature the decoder does not take
};

enum Mode { kColor = 0, kGray = 1, kAnyDepth = 2, kUnchanged = 3 };

struct Image {
  std::vector<uint8_t> data;  // HWC, row-major, 1 or 2 bytes a sample
  int h = 0, w = 0, c = 0, bytes = 1;
};

struct Failure {
  int code;
  std::string msg;
};

// ------------------------------------------------------------------- PNG ----
inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | p[3];
}

inline int paeth(int a, int b, int c) {
  int p = a + b - c, pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

bool unfilter(uint8_t* rows, int nrows, size_t rowbytes, int bpp) {
  std::vector<uint8_t> zero(rowbytes, 0);
  const uint8_t* prev = zero.data();
  for (int y = 0; y < nrows; ++y) {
    uint8_t* r = rows + y * (rowbytes + 1);
    int f = r[0];
    uint8_t* x = r + 1;
    for (size_t i = 0; i < rowbytes; ++i) {
      int a = i >= size_t(bpp) ? x[i - bpp] : 0, b = prev[i];
      int c = i >= size_t(bpp) ? prev[i - bpp] : 0;
      switch (f) {
        case 0: break;
        case 1: x[i] = uint8_t(x[i] + a); break;
        case 2: x[i] = uint8_t(x[i] + b); break;
        case 3: x[i] = uint8_t(x[i] + ((a + b) >> 1)); break;
        case 4: x[i] = uint8_t(x[i] + paeth(a, b, c)); break;
        default: return false;
      }
    }
    prev = x;
  }
  return true;
}

// libpng's gamma lookup of 8-bit samples (png_build_8bit_table with
// floating-point arithmetic): identity unless the gamma is significant.
bool significant(int64_t g) { return g < 95000 || g > 105000; }

void gamma_table_8(int64_t g, uint16_t* table) {
  for (int v = 0; v < 256; ++v)
    table[v] = uint16_t(!significant(g) || v == 0 || v == 255
                            ? v
                            : floor(255 * pow(v / 255., g * .00001) + .5));
}

int64_t reciprocal(int64_t a) { return int64_t(floor(1e10 / double(a) + .5)); }

// libpng's 16-bit gamma tables, flattened: a sample v is looked up at
// (v >> 8) << (8 - shift) | (v & 0xff) >> shift, its top 16 - shift bits.
// png_build_16bit_table (floating point; the identity, rescaled, when the
// gamma is not significant) ...
std::vector<uint16_t> gamma_table_16(int shift, int64_t g) {
  const int bits = 16 - shift;
  const uint32_t max = (1u << bits) - 1;
  const double fmax = 1.0 / max;
  std::vector<uint16_t> t(size_t(1) << bits);
  for (uint32_t ig = 0; ig <= max; ++ig)
    t[ig] = uint16_t(significant(g)
                         ? floor(65535. * pow(ig * fmax, g * .00001) + .5)
                         : shift ? (ig * 65535u + (1u << (15 - shift))) / max
                                 : ig);
  return t;
}

// ... and png_build_16to8_table: the 16-bit value whose high byte is the
// nearest 8-bit output, for a sample that is cut to 8 bits afterwards.
std::vector<uint16_t> gamma_table_16_to_8(int shift, int64_t g) {
  const uint32_t max = (1u << (16 - shift)) - 1;
  std::vector<uint16_t> t(size_t(max) + 1, 65535);
  uint32_t last = 0;
  for (uint32_t i = 0; i < 255; ++i) {
    const uint32_t v = i * 257 + 128;
    const uint32_t corrected =
        v < 65535 ? uint32_t(floor(65535 * pow(v / 65535., g * .00001) + .5))
                  : v;
    const uint32_t bound = (corrected * max + 32768) / 65535 + 1;
    for (; last < bound && last <= max; ++last) t[last] = uint16_t(i * 257);
  }
  return t;
}

// cv2 reads a colour PNG as grey with png_set_rgb_to_gray(png, 1, 0.299,
// 0.587): libpng's coefficients 9797 and 19234 (of 32768; blue the rest),
// applied before its 16 -> 8 bit strip and after the alpha is stripped.
// Without a significant file gamma, 8 bits truncate and 16 bits round, and a
// pixel whose three samples are equal keeps them. With one, libpng's
// png_do_rgb_to_gray goes through its gamma tables: at 8 bits the to-linear
// and from-linear tables, equal samples kept; at 16 bits tables of the top
// 16 - shift bits of a sample (shift: the bits sBIT marks insignificant, at
// least 5 when the result is cut to 8 bits), equal samples through the
// overall (about identity) table, which rounds to 8 bits when they are cut.
// The file gamma is libpng 1.6.58's: sRGB wherever its chunk is (over any
// gAMA), else a gAMA in range, else 1; iCCP and cICP chunks give none.
// Overwrites s (n pixels of `chans` samples) with one grey sample a pixel,
// 16 bits wide at depth 16.
void rgb_to_grey_png(std::vector<uint16_t>* s, size_t n, int chans, int depth,
                     bool cut_to_8, int64_t gama, bool srgb, int sbit) {
  const int64_t rc = 9797, gc = 19234, bc = 32768 - rc - gc;
  if (gama < 16 || gama > 625000000) gama = 0;  // libpng ignores it
  const int64_t file_gamma = srgb ? 45455 : (gama ? gama : 100000);
  const bool gamma = significant(file_gamma);
  const int64_t screen = reciprocal(file_gamma);
  std::vector<uint16_t>& v = *s;
  if (gamma && depth == 16) {
    int shift = sbit > 0 && sbit < 16 ? 16 - sbit : 0;
    if (cut_to_8) shift = std::max(shift, 5);
    shift = std::min(shift, 8);
    const auto to1 = gamma_table_16(shift, reciprocal(file_gamma));
    const auto from1 = gamma_table_16(shift, reciprocal(screen));
    // png_reciprocal2 and png_product2 of the file and screen gammas
    const auto same =
        cut_to_8
            ? gamma_table_16_to_8(
                  shift, int64_t(floor(file_gamma * 1e-5 * screen + .5)))
            : gamma_table_16(
                  shift, int64_t(floor(1e15 / file_gamma / screen + .5)));
    auto at = [shift](const std::vector<uint16_t>& t, int64_t x) {
      return int64_t(t[((x >> 8) << (8 - shift)) | ((x & 0xff) >> shift)]);
    };
    for (size_t i = 0; i < n; ++i) {
      const int64_t r = v[i * chans], g = v[i * chans + 1],
                    b = v[i * chans + 2];
      v[i] = uint16_t(
          r == g && r == b
              ? at(same, r)
              : at(from1, (rc * at(to1, r) + gc * at(to1, g) +
                           bc * at(to1, b) + 16384) >> 15));
    }
    return;
  }
  uint16_t to1[256], from1[256];
  if (gamma) {
    gamma_table_8(reciprocal(file_gamma), to1);
    gamma_table_8(reciprocal(screen), from1);
  }
  for (size_t i = 0; i < n; ++i) {
    const int64_t r = v[i * chans], g = v[i * chans + 1],
                  b = v[i * chans + 2];
    int64_t y;
    if (r == g && r == b)
      y = r;
    else if (depth == 16)
      y = (rc * r + gc * g + bc * b + 16384) >> 15;
    else if (gamma)
      y = from1[(rc * to1[r] + gc * to1[g] + bc * to1[b] + 16384) >> 15];
    else
      y = (rc * r + gc * g + bc * b) >> 15;
    v[i] = uint16_t(y);
  }
}

Failure decode_png(const uint8_t* buf, size_t len, int mode, Image* img) {
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (len < 8 || memcmp(buf, sig, 8) != 0) return {kUnknown, "not a PNG"};
  size_t pos = 8;
  int W = 0, H = 0, depth = 0, ctype = -1, interlace = 0;
  std::vector<uint8_t> idat, palette;
  int64_t gama = 0;              // the gAMA chunk's value, 1e5 = gamma 1
  bool srgb = false;
  int sbit = 0;                  // the most significant bits sBIT gives
  bool ended = false;
  while (pos + 12 <= len) {
    uint32_t n = be32(buf + pos);
    const uint8_t* type = buf + pos + 4;
    if (pos + 12 + size_t(n) > len)
      return {kCorrupt, "corrupt PNG: truncated chunk"};
    const uint8_t* d = buf + pos + 8;
    if (!memcmp(type, "IHDR", 4)) {
      if (n < 13) return {kCorrupt, "corrupt PNG: IHDR"};
      W = int(be32(d));
      H = int(be32(d + 4));
      depth = d[8];
      ctype = d[9];
      interlace = d[12];
    } else if (!memcmp(type, "PLTE", 4)) {
      palette.assign(d, d + n);
    } else if (!memcmp(type, "gAMA", 4) && n == 4) {
      gama = int64_t(be32(d));
    } else if (!memcmp(type, "sRGB", 4)) {
      srgb = true;
    } else if (!memcmp(type, "sBIT", 4)) {
      // libpng ignores one of the wrong length for the colour type, or with
      // a value outside 1 to the sample depth; a colour image's is the
      // largest of its red, green and blue
      static const int length[7] = {1, 0, 3, 3, 2, 0, 4};
      const int sample = ctype == 3 ? 8 : depth;
      bool valid = ctype >= 0 && ctype <= 6 && int(n) == length[ctype];
      for (uint32_t k = 0; valid && k < n; ++k)
        valid = d[k] > 0 && d[k] <= sample;
      if (valid)
        for (uint32_t k = 0; k < n && k < 3; ++k)
          sbit = std::max(sbit, int(d[k]));
    } else if (!memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), d, d + n);
    } else if (!memcmp(type, "IEND", 4)) {
      ended = true;
      break;
    }
    pos += 12 + size_t(n);
  }
  if (W <= 0 || H <= 0 || ctype < 0) return {kCorrupt, "corrupt PNG: no IHDR"};
  if (idat.empty()) return {kCorrupt, "corrupt PNG: no image data"};
  (void)ended;
  int chans;
  switch (ctype) {
    case 0: chans = 1; break;
    case 2: chans = 3; break;
    case 3: chans = 1; break;
    case 4: chans = 2; break;
    case 6: chans = 4; break;
    default: return {kCorrupt, "corrupt PNG: colour type"};
  }
  if (!(depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16) ||
      (ctype != 0 && ctype != 3 && depth < 8) || (ctype == 3 && depth > 8))
    return {kCorrupt, "corrupt PNG: bit depth"};
  if (ctype == 3 && palette.size() < 3)
    return {kCorrupt, "corrupt PNG: missing palette"};
  const int bits_px = chans * depth;
  const int bpp = std::max(1, bits_px / 8);
  // the sub-images: one, or Adam7's seven
  static const int x0[7] = {0, 4, 0, 2, 0, 1, 0}, y0[7] = {0, 0, 4, 0, 2, 0, 1};
  static const int dx[7] = {8, 8, 4, 4, 2, 2, 1}, dy[7] = {8, 8, 8, 4, 4, 2, 2};
  const int passes = interlace ? 7 : 1;
  size_t total = 0;
  int pw[7], ph[7];
  for (int p = 0; p < passes; ++p) {
    pw[p] = interlace ? (W - x0[p] + dx[p] - 1) / dx[p] : W;
    ph[p] = interlace ? (H - y0[p] + dy[p] - 1) / dy[p] : H;
    if (pw[p] > 0 && ph[p] > 0)
      total += size_t(ph[p]) * ((size_t(pw[p]) * bits_px + 7) / 8 + 1);
  }
  std::vector<uint8_t> raw(total);
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return {kCorrupt, "zlib inflateInit failed"};
  zs.next_in = idat.data();
  zs.avail_in = uInt(idat.size());
  zs.next_out = raw.data();
  zs.avail_out = uInt(raw.size());
  int zr = inflate(&zs, Z_FINISH);
  size_t got = raw.size() - zs.avail_out;
  inflateEnd(&zs);
  if ((zr != Z_STREAM_END && zr != Z_BUF_ERROR && zr != Z_OK) || got < total)
    return {kCorrupt, "corrupt PNG: image data does not inflate"};
  // samples as uint16, HW x chans (palette expanded to RGB)
  const int out_chans = ctype == 3 ? 3 : chans;
  std::vector<uint16_t> s(size_t(W) * H * out_chans);
  size_t off = 0;
  for (int p = 0; p < passes; ++p) {
    if (pw[p] <= 0 || ph[p] <= 0) continue;
    size_t rowbytes = (size_t(pw[p]) * bits_px + 7) / 8;
    if (!unfilter(raw.data() + off, ph[p], rowbytes, bpp))
      return {kCorrupt, "corrupt PNG: bad filter"};
    for (int y = 0; y < ph[p]; ++y) {
      const uint8_t* r = raw.data() + off + y * (rowbytes + 1) + 1;
      int oy = interlace ? y0[p] + y * dy[p] : y;
      for (int x = 0; x < pw[p]; ++x) {
        int ox = interlace ? x0[p] + x * dx[p] : x;
        uint16_t* o = &s[(size_t(oy) * W + ox) * out_chans];
        for (int k = 0; k < chans; ++k) {
          size_t bit = (size_t(x) * chans + k) * depth;
          unsigned v;
          if (depth == 16)
            v = (r[bit / 8] << 8) | r[bit / 8 + 1];
          else if (depth == 8)
            v = r[bit / 8];
          else
            v = (r[bit / 8] >> (8 - depth - bit % 8)) & ((1 << depth) - 1);
          if (ctype == 3) {
            if (3 * v + 2 >= palette.size())
              return {kCorrupt, "corrupt PNG: palette index"};
            o[0] = palette[3 * v];
            o[1] = palette[3 * v + 1];
            o[2] = palette[3 * v + 2];
          } else {
            o[k] = uint16_t(v);
          }
        }
      }
    }
    off += size_t(ph[p]) * (rowbytes + 1);
  }
  // what libpng's png_set_expand gives grey below 8 bits
  const int sdepth = ctype == 3 ? 8 : std::max(depth, 8);
  if (ctype != 3 && depth < 8) {
    int scale = 255 / ((1 << depth) - 1);
    for (auto& v : s) v = uint16_t(v * scale);
  }
  const size_t n = size_t(W) * H;
  const bool grey = out_chans <= 2;
  img->w = W;
  img->h = H;
  if (mode == kGray || mode == kAnyDepth) {
    // cv2 asks libpng for grey: rgb_to_gray on a colour source, alpha
    // stripped; 16 bits cut to the high byte after it unless kAnyDepth
    if (!grey)
      rgb_to_grey_png(&s, n, out_chans, sdepth, mode == kGray, gama, srgb,
                      sbit);
    const int step = grey ? out_chans : 1;
    const bool wide = sdepth == 16 && mode == kAnyDepth;
    img->c = 1;
    img->bytes = wide ? 2 : 1;
    img->data.resize(n * img->bytes);
    for (size_t i = 0; i < n; ++i) {
      uint16_t v = s[i * step];
      if (wide)
        memcpy(&img->data[i * 2], &v, 2);
      else
        img->data[i] = uint8_t(sdepth == 16 ? v >> 8 : v);
    }
    return {kOk, ""};
  }
  // colour: 16 -> 8 bits by the high byte (libpng's png_set_strip_16), alpha
  // dropped; unchanged: the stored samples, a grey + alpha image as RGBA
  // (cv2 asks libpng for grey to RGB when it keeps the alpha)
  const int c = mode == kColor ? 3 : (out_chans == 2 ? 4 : out_chans);
  img->c = c;
  img->bytes = mode == kColor || sdepth != 16 ? 1 : 2;
  img->data.resize(n * c * img->bytes);
  for (size_t i = 0; i < n; ++i) {
    const uint16_t* px = &s[i * out_chans];
    for (int k = 0; k < c; ++k) {
      uint16_t v = grey ? (k == 3 ? px[1] : px[0]) : px[k];
      if (img->bytes == 2)
        memcpy(&img->data[(i * c + k) * 2], &v, 2);
      else
        img->data[i * c + k] = uint8_t(sdepth == 16 ? v >> 8 : v);
    }
  }
  return {kOk, ""};
}

// ------------------------------------------------------------------- BMP ----
inline uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
         (uint32_t(p[3]) << 24);
}

// cv2's icvCvt_BGR2Gray: (1868 B + 9617 G + 4899 R) / 2^14, rounded.
inline uint8_t grey_14(const uint8_t* bgr) {
  return uint8_t((1868 * bgr[0] + 9617 * bgr[1] + 4899 * bgr[2] + 8192) >> 14);
}

// What cv2 gives for a 32-bit BMP with bit fields and a header of 56 bytes
// or more: floor((0.299f R + 0.587f G) + 0.114f B) in float32, each product
// and sum rounded to float32. The products are taken in double, where they
// are exact, and rounded by the casts, so that no compiler fuses them.
inline uint8_t grey_float(const uint8_t* bgr) {
  const float r = float(double(0.299f) * bgr[2]);
  const float g = float(double(0.587f) * bgr[1]);
  const float b = float(double(0.114f) * bgr[0]);
  const float rg = r + g;
  return uint8_t(floorf(rg + b));
}

Failure decode_bmp(const uint8_t* buf, size_t len, int mode, Image* img) {
  if (len < 54 || buf[0] != 'B' || buf[1] != 'M') return {kUnknown, "not BMP"};
  uint32_t data_off = le32(buf + 10), hsize = le32(buf + 14);
  if (hsize < 40 || 14 + size_t(hsize) > len)
    return {kUnsupported, "unsupported BMP header"};
  int W = int32_t(le32(buf + 18)), Hs = int32_t(le32(buf + 22));
  int bits = buf[28] | (buf[29] << 8);
  uint32_t comp = le32(buf + 30), ncolors = le32(buf + 46);
  if (comp != 0 && !(comp == 3 && bits == 32))
    return {kUnsupported, "unsupported BMP: compressed"};
  if (bits != 8 && bits != 24 && bits != 32)
    return {kUnsupported, "unsupported BMP: " + std::to_string(bits) + " bits"};
  bool bottom_up = Hs > 0;
  int H = bottom_up ? Hs : -Hs;
  if (W <= 0 || H <= 0) return {kCorrupt, "corrupt BMP: size"};
  size_t stride = ((size_t(W) * bits + 31) / 32) * 4;
  if (data_off + stride * H > len) return {kCorrupt, "corrupt BMP: truncated"};
  const uint8_t* pal = buf + 14 + hsize;
  if (bits == 8) {
    if (ncolors == 0) ncolors = 256;
    if (14 + hsize + 4 * size_t(ncolors) > len)
      return {kCorrupt, "corrupt BMP: palette"};
  }
  // cv2 turns a BMP grey row by row as it decodes: 14-bit fixed point,
  // except for 32 bits with bit fields in a header that holds an alpha
  // mask (56 bytes or more)
  const bool to_grey = mode == kGray || mode == kAnyDepth;
  const bool float_grey = bits == 32 && comp == 3 && hsize >= 56;
  // read as stored, 32 bits with bit fields keep an alpha, as cv2's: the
  // fourth byte where the header holds no alpha mask (under 56 bytes), the
  // masked byte where it does, 255 where that mask is 0
  const bool alpha = mode == kUnchanged && bits == 32 && comp == 3;
  int alpha_byte = 3;
  if (alpha && hsize >= 56) {
    const uint32_t amask = le32(buf + 14 + 52);
    alpha_byte = -1;
    for (int k = 0; k < 4; ++k)
      if (amask == 0xFFu << (8 * k)) alpha_byte = k;
    if (amask != 0 && alpha_byte < 0)
      return {kUnsupported,
              "unsupported BMP: an alpha mask that is not one byte"};
  }
  img->w = W;
  img->h = H;
  img->c = to_grey ? 1 : (alpha ? 4 : 3);
  img->bytes = 1;
  img->data.resize(size_t(W) * H * img->c);
  for (int y = 0; y < H; ++y) {
    const uint8_t* r = buf + data_off + stride * (bottom_up ? H - 1 - y : y);
    for (int x = 0; x < W; ++x) {
      const uint8_t* bgr;
      if (bits == 8) {
        if (r[x] >= ncolors) return {kCorrupt, "corrupt BMP: palette index"};
        bgr = pal + 4 * r[x];
      } else {
        bgr = r + size_t(x) * (bits / 8);
      }
      if (to_grey) {
        img->data[size_t(y) * W + x] =
            float_grey ? grey_float(bgr) : grey_14(bgr);
        continue;
      }
      uint8_t* o = &img->data[(size_t(y) * W + x) * img->c];
      o[0] = bgr[2];
      o[1] = bgr[1];
      o[2] = bgr[0];
      if (alpha) o[3] = alpha_byte < 0 ? 255 : bgr[alpha_byte];
    }
  }
  return {kOk, ""};
}

// ----------------------------------------------------------------------------
bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  bool ok = fseek(f, 0, SEEK_END) == 0;
  long len = ok ? ftell(f) : -1;
  ok = ok && len > 0 && fseek(f, 0, SEEK_SET) == 0;
  if (ok) {
    out->resize(size_t(len));
    ok = fread(out->data(), 1, size_t(len), f) == size_t(len);
  }
  fclose(f);
  return ok;
}

Failure decode_buffer(const uint8_t* buf, size_t len, int mode, Image* img) {
  if (len >= 8 && buf[0] == 137 && buf[1] == 'P')
    return decode_png(buf, len, mode, img);
  if (len >= 2 && buf[0] == 'B' && buf[1] == 'M')
    return decode_bmp(buf, len, mode, img);
  return {kUnknown, "not a PNG or BMP file"};
}

Failure decode_file(const char* path, int mode, Image* img) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return {kNoFile, "cannot read the file"};
  return decode_buffer(buf.data(), buf.size(), mode, img);
}

// --------------------------------------------------- resize + normalize ----
// bilinear, half-pixel centres, edge-clamped (the JAX loader's arithmetic)
void resize_normalize(const uint8_t* src, int h, int w, float* out, int oh,
                      int ow, int mode, const float* mean,
                      const float* stddev) {
  const float sy = float(h) / oh;
  const float sx = float(w) / ow;
  for (int y = 0; y < oh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = (int)floorf(fy);
    float wy = fy - y0;
    int y0c = y0 < 0 ? 0 : (y0 >= h ? h - 1 : y0);
    int y1c = y0 + 1 < 0 ? 0 : (y0 + 1 >= h ? h - 1 : y0 + 1);
    for (int x = 0; x < ow; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = (int)floorf(fx);
      float wx = fx - x0;
      int x0c = x0 < 0 ? 0 : (x0 >= w ? w - 1 : x0);
      int x1c = x0 + 1 < 0 ? 0 : (x0 + 1 >= w ? w - 1 : x0 + 1);
      const uint8_t* p00 = src + (size_t(y0c) * w + x0c) * 3;
      const uint8_t* p01 = src + (size_t(y0c) * w + x1c) * 3;
      const uint8_t* p10 = src + (size_t(y1c) * w + x0c) * 3;
      const uint8_t* p11 = src + (size_t(y1c) * w + x1c) * 3;
      float* o = out + (size_t(y) * ow + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float v = (1 - wy) * ((1 - wx) * p00[c] + wx * p01[c]) +
                  wy * ((1 - wx) * p10[c] + wx * p11[c]);
        if (mode == 1) {
          v /= 255.f;
        } else if (mode == 2) {
          v = (v / 255.f - mean[c]) / stddev[c];
        }
        o[c] = v;
      }
    }
  }
}

// ------------------------------------------------------------ fillPoly ----
// cv2.fillPoly of OpenCV 5 (shift 0, LINE_8), found equal to it on random
// polygons inside and across the image border: each edge drawn by the
// 8-connected line iterator (clipped to the image), then a scanline fill
// between 16.16 fixed-point edges, which run between the clipped ends of an
// edge that leaves the image; a row fills from the ceiling of its left edge
// to the floor of its right one.
const int XY_SHIFT = 16;
const int64_t XY_ONE = int64_t(1) << XY_SHIFT;

struct Pt {
  int64_t x, y;
};

bool clip_line(int64_t w, int64_t h, Pt& p1, Pt& p2) {
  int64_t right = w - 1, bottom = h - 1;
  if (w <= 0 || h <= 0) return false;
  int64_t &x1 = p1.x, &y1 = p1.y, &x2 = p2.x, &y2 = p2.y;
  int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
  int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    int64_t a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      x1 += (int64_t)((double)(a - y1) * (x2 - x1) / (y2 - y1));
      y1 = a;
      c1 = (x1 < 0) + (x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      x2 += (int64_t)((double)(a - y2) * (x2 - x1) / (y2 - y1));
      y2 = a;
      c2 = (x2 < 0) + (x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        y1 += (int64_t)((double)(a - x1) * (y2 - y1) / (x2 - x1));
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        y2 += (int64_t)((double)(a - x2) * (y2 - y1) / (x2 - x1));
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

void draw_line(uint8_t* img, int w, int h, Pt p1, Pt p2) {
  if ((uint64_t)p1.x >= (uint64_t)w || (uint64_t)p2.x >= (uint64_t)w ||
      (uint64_t)p1.y >= (uint64_t)h || (uint64_t)p2.y >= (uint64_t)h) {
    if (!clip_line(w, h, p1, p2)) return;
  }
  int64_t dx = p2.x - p1.x, dy = p2.y - p1.y;
  int64_t sx = 1, sy = 1;
  if (dx < 0) {  // left to right
    dx = -dx;
    dy = -dy;
    std::swap(p1, p2);
  }
  if (dy < 0) {
    dy = -dy;
    sy = -1;
  }
  bool vert = dy > dx;
  if (vert) {
    std::swap(dx, dy);
    std::swap(sx, sy);
  }
  int64_t err = dx - (dy + dy), plus_delta = dx + dx, minus_delta = -(dy + dy);
  // minus: step along the major axis; plus: also along the minor one
  int64_t minus_x = sx, minus_y = 0, plus_x = 0, plus_y = sy;
  if (vert) {
    std::swap(minus_x, minus_y);
    std::swap(plus_x, plus_y);
  }
  int64_t x = p1.x, y = p1.y;
  for (int64_t i = 0; i <= dx; ++i) {
    img[size_t(y) * w + x] = 1;
    int64_t mask = err < 0 ? -1 : 0;
    err += minus_delta + (plus_delta & mask);
    x += minus_x + (plus_x & mask);
    y += minus_y + (plus_y & mask);
  }
}

struct Edge {
  int y0, y1;
  int64_t x, dx;
  Edge* next;
};

void fill_poly(uint8_t* img, int w, int h, const int* xy, int n) {
  if (n <= 0) return;
  std::vector<Edge> edges;
  edges.reserve(n + 1);
  Pt pt0{int64_t(xy[2 * (n - 1)]) << XY_SHIFT, xy[2 * (n - 1) + 1]};
  for (int i = 0; i < n; ++i) {
    Pt pt1{int64_t(xy[2 * i]) << XY_SHIFT, xy[2 * i + 1]};
    Pt pt0c = pt0, pt1c = pt1;
    Pt t0{(pt0.x + (XY_ONE >> 1)) >> XY_SHIFT, pt0.y};
    Pt t1{(pt1.x + (XY_ONE >> 1)) >> XY_SHIFT, pt1.y};
    draw_line(img, w, h, t0, t1);
    // an edge that leaves the image runs between its clipped ends
    if ((uint64_t)t0.x >= (uint64_t)w || (uint64_t)t1.x >= (uint64_t)w ||
        (uint64_t)t0.y >= (uint64_t)h || (uint64_t)t1.y >= (uint64_t)h) {
      clip_line(w, h, t0, t1);
      pt0c.y = t0.y;
      pt1c.y = t1.y;
      pt0c.x = t0.x << XY_SHIFT;
      pt1c.x = t1.x << XY_SHIFT;
    }
    if (pt0.y != pt1.y) {
      Edge e{};
      e.dx = pt1c.y == pt0c.y ? 0 : (pt1c.x - pt0c.x) / (pt1c.y - pt0c.y);
      if (pt0.y < pt1.y) {
        e.y0 = int(pt0.y);
        e.y1 = int(pt1.y);
        e.x = pt0c.x + (pt0.y - pt0c.y) * e.dx;
      } else {
        e.y0 = int(pt1.y);
        e.y1 = int(pt0.y);
        e.x = pt1c.x + (pt1.y - pt1c.y) * e.dx;
      }
      edges.push_back(e);
    }
    pt0 = pt1;
  }
  // FillEdgeCollection
  int total = int(edges.size());
  if (total < 2) return;
  int y_max = INT_MIN, y_min = INT_MAX;
  int64_t x_max = INT64_MIN, x_min = INT64_MAX;
  for (auto& e : edges) {
    int64_t x1 = e.x + int64_t(e.y1 - e.y0) * e.dx;
    y_min = std::min(y_min, e.y0);
    y_max = std::max(y_max, e.y1);
    x_min = std::min({x_min, e.x, x1});
    x_max = std::max({x_max, e.x, x1});
  }
  if (y_max < 0 || y_min >= h || x_max < 0 || x_min >= (int64_t(w) << XY_SHIFT))
    return;
  std::sort(edges.begin(), edges.end(), [](const Edge& a, const Edge& b) {
    return a.y0 != b.y0 ? a.y0 < b.y0 : a.x != b.x ? a.x < b.x : a.dx < b.dx;
  });
  Edge tmp{};
  tmp.y0 = INT_MAX;
  edges.push_back(tmp);
  tmp.next = nullptr;
  int i = 0;
  Edge* e = &edges[0];
  y_max = std::min(y_max, h);
  for (int y = e->y0; y < y_max; ++y) {
    Edge *last, *prelast, *keep_prelast;
    int draw = 0;
    bool clipline = y < 0;
    prelast = &tmp;
    last = tmp.next;
    while (last || e->y0 == y) {
      if (last && last->y1 == y) {
        prelast->next = last->next;
        last = last->next;
        continue;
      }
      keep_prelast = prelast;
      if (last && (e->y0 > y || last->x < e->x)) {
        prelast = last;
        last = last->next;
      } else if (i < total) {
        prelast->next = e;
        e->next = last;
        prelast = e;
        e = &edges[++i];
      } else {
        break;
      }
      if (draw) {
        if (!clipline) {
          int x1, x2;
          // the pixels whose left side lies between the two edges
          if (keep_prelast->x > prelast->x) {
            x1 = int((prelast->x + XY_ONE - 1) >> XY_SHIFT);
            x2 = int(keep_prelast->x >> XY_SHIFT);
          } else {
            x1 = int((keep_prelast->x + XY_ONE - 1) >> XY_SHIFT);
            x2 = int(prelast->x >> XY_SHIFT);
          }
          if (x1 < w && x2 >= 0) {
            if (x1 < 0) x1 = 0;
            if (x2 >= w) x2 = w - 1;
            if (x2 >= x1) memset(img + size_t(y) * w + x1, 1, x2 - x1 + 1);
          }
        }
        keep_prelast->x += keep_prelast->dx;
        prelast->x += prelast->dx;
      }
      draw ^= 1;
    }
    // bubble sort of the active edges by x
    keep_prelast = nullptr;
    do {
      prelast = &tmp;
      last = tmp.next;
      Edge* last_exchange = nullptr;
      while (last != keep_prelast && last->next != nullptr) {
        Edge* te = last->next;
        if (last->x > te->x) {
          prelast->next = te;
          last->next = te->next;
          te->next = last;
          prelast = te;
          last_exchange = prelast;
        } else {
          prelast = last;
          last = te;
        }
      }
      if (last_exchange == nullptr) break;
      keep_prelast = last_exchange;
    } while (keep_prelast != tmp.next && keep_prelast != &tmp);
  }
}

// ------------------------------------------------- lines and rectangles ----
// cv2.line and cv2.rectangle of OpenCV 5 with LINE_8 and a thickness of 2
// or more, found equal to them on random segments inside, across and far
// beyond the image border. A thick segment is a convex quadrilateral in
// 16.16 fixed point (ThickLine -> FillConvexPoly, its edges drawn by the
// fixed-point Line2) with a filled circle at the ends it caps; cv2.line
// first clips the segment to the image grown by the thickness on every
// side and caps both ends, a rectangle's closed polyline caps each side's
// end and is not clipped.
struct Canvas {
  uint8_t* img;
  int w, h, c;
  const uint8_t* color;
  void put(int64_t x, int64_t y) const {
    if (x >= 0 && x < w && y >= 0 && y < h)
      memcpy(img + (size_t(y) * w + x) * c, color, c);
  }
  void hline(int64_t y, int64_t x1, int64_t x2) const {
    uint8_t* row = img + size_t(y) * w * c;
    for (int64_t x = x1; x <= x2; ++x) memcpy(row + x * c, color, c);
  }
};

void line2(const Canvas& cv, Pt p1, Pt p2) {
  if (!clip_line(int64_t(cv.w) << XY_SHIFT, int64_t(cv.h) << XY_SHIFT, p1, p2))
    return;
  int64_t dx = p2.x - p1.x, dy = p2.y - p1.y;
  int64_t j = dx < 0 ? -1 : 0, ax = (dx ^ j) - j;
  int64_t i = dy < 0 ? -1 : 0, ay = (dy ^ i) - i;
  int64_t x_step, y_step, ecount;
  if (ax > ay) {
    dy = (dy ^ j) - j;
    if (j) std::swap(p1, p2);
    x_step = XY_ONE;
    y_step = dy * XY_ONE / (ax | 1);
    ecount = (p2.x - p1.x) >> XY_SHIFT;
  } else {
    dx = (dx ^ i) - i;
    if (i) std::swap(p1, p2);
    x_step = dx * XY_ONE / (ay | 1);
    y_step = XY_ONE;
    ecount = (p2.y - p1.y) >> XY_SHIFT;
  }
  p1.x += XY_ONE >> 1;
  p1.y += XY_ONE >> 1;
  cv.put((p2.x + (XY_ONE >> 1)) >> XY_SHIFT, (p2.y + (XY_ONE >> 1)) >> XY_SHIFT);
  if (ax > ay) {
    int64_t x = p1.x >> XY_SHIFT, y = p1.y;
    for (; ecount >= 0; --ecount, ++x, y += y_step) cv.put(x, y >> XY_SHIFT);
  } else {
    int64_t x = p1.x, y = p1.y >> XY_SHIFT;
    for (; ecount >= 0; --ecount, x += x_step, ++y) cv.put(x >> XY_SHIFT, y);
  }
}

// FillConvexPoly with vertices in 16.16 fixed point (shift = XY_SHIFT)
void fill_convex(const Canvas& cv, const Pt* v, int npts) {
  const int64_t delta = XY_ONE >> 1;
  int64_t xmin = v[0].x, xmax = v[0].x, ymin = v[0].y, ymax = v[0].y;
  int imin = 0;
  Pt p0 = v[npts - 1];
  for (int i = 0; i < npts; ++i) {
    const Pt& p = v[i];
    if (p.y < ymin) {
      ymin = p.y;
      imin = i;
    }
    ymax = std::max(ymax, p.y);
    xmax = std::max(xmax, p.x);
    xmin = std::min(xmin, p.x);
    line2(cv, p0, p);
    p0 = p;
  }
  xmin = (xmin + delta) >> XY_SHIFT;
  xmax = (xmax + delta) >> XY_SHIFT;
  ymin = (ymin + delta) >> XY_SHIFT;
  ymax = (ymax + delta) >> XY_SHIFT;
  if (npts < 3 || xmax < 0 || ymax < 0 || xmin >= cv.w || ymin >= cv.h) return;
  ymax = std::min<int64_t>(ymax, cv.h - 1);
  struct {
    int idx, di;
    int64_t x, dx, ye;
  } edge[2];
  edge[0].idx = edge[1].idx = imin;
  edge[0].ye = edge[1].ye = ymin;
  edge[0].di = 1;
  edge[1].di = npts - 1;
  edge[0].x = edge[1].x = -XY_ONE;
  edge[0].dx = edge[1].dx = 0;
  int edges = npts;
  int64_t y = ymin;
  do {
    for (int i = 0; i < 2; ++i) {
      if (y < edge[i].ye) continue;
      int idx0 = edge[i].idx, di = edge[i].di;
      int idx = idx0 + di;
      if (idx >= npts) idx -= npts;
      for (; edges-- > 0;) {
        int64_t ty = (v[idx].y + delta) >> XY_SHIFT;
        if (ty > y) {
          int64_t xs = v[idx0].x, xe = v[idx].x;
          edge[i].ye = ty;
          edge[i].dx = ((xe - xs) * 2 + (ty - y)) / (2 * (ty - y));
          edge[i].x = xs;
          edge[i].idx = idx;
          break;
        }
        idx0 = idx;
        idx += di;
        if (idx >= npts) idx -= npts;
      }
    }
    if (edges < 0) break;
    if (y >= 0) {
      int left = edge[0].x > edge[1].x ? 1 : 0, right = 1 - left;
      int64_t x1 = (edge[left].x + delta) >> XY_SHIFT;
      int64_t x2 = (edge[right].x + delta) >> XY_SHIFT;
      if (x2 >= 0 && x1 < cv.w) {
        if (x1 < 0) x1 = 0;
        if (x2 >= cv.w) x2 = cv.w - 1;
        cv.hline(y, x1, x2);
      }
    }
    edge[0].x += edge[0].dx;
    edge[1].x += edge[1].dx;
  } while (++y <= ymax);
}

// Circle with fill on
void fill_circle(const Canvas& cv, int64_t cx, int64_t cy, int64_t radius) {
  int64_t err = 0, dx = radius, dy = 0, plus = 1, minus = (radius << 1) - 1;
  const int64_t W = cv.w, H = cv.h;
  bool inside = cx >= radius && cx < W - radius && cy >= radius &&
                cy < H - radius;
  while (dx >= dy) {
    int64_t y11 = cy - dy, y12 = cy + dy, y21 = cy - dx, y22 = cy + dx;
    int64_t x11 = cx - dx, x12 = cx + dx, x21 = cx - dy, x22 = cx + dy;
    if (inside) {
      cv.hline(y11, x11, x12);
      cv.hline(y12, x11, x12);
      cv.hline(y21, x21, x22);
      cv.hline(y22, x21, x22);
    } else if (x11 < W && x12 >= 0 && y21 < H && y22 >= 0) {
      x11 = std::max<int64_t>(x11, 0);
      x12 = std::min<int64_t>(x12, W - 1);
      if (y11 >= 0 && y11 < H) cv.hline(y11, x11, x12);
      if (y12 >= 0 && y12 < H) cv.hline(y12, x11, x12);
      if (x21 < W && x22 >= 0) {
        x21 = std::max<int64_t>(x21, 0);
        x22 = std::min<int64_t>(x22, W - 1);
        if (y21 >= 0 && y21 < H) cv.hline(y21, x21, x22);
        if (y22 >= 0 && y22 < H) cv.hline(y22, x21, x22);
      }
    }
    dy++;
    err += plus;
    plus += 2;
    int64_t mask = (err <= 0) - 1;
    err -= minus & mask;
    dx += mask;
    minus -= mask & 2;
  }
}

// ThickLine with integer ends (shift 0); flags: 1 caps p0, 2 caps p1
void thick_line(const Canvas& cv, Pt p0, Pt p1, int thickness, int flags) {
  p0.x <<= XY_SHIFT;
  p0.y <<= XY_SHIFT;
  p1.x <<= XY_SHIFT;
  p1.y <<= XY_SHIFT;
  double dx = (p0.x - p1.x) / double(XY_ONE), dy = (p1.y - p0.y) / double(XY_ONE);
  double r = dx * dx + dy * dy;
  int odd = thickness & 1;
  int64_t th = int64_t(thickness) << (XY_SHIFT - 1);
  if (fabs(r) > 2.220446049250313e-16) {
    r = (th + odd * XY_ONE * 0.5) / sqrt(r);
    int64_t dpx = llrint(dy * r), dpy = llrint(dx * r);
    Pt pt[4] = {{p0.x + dpx, p0.y + dpy}, {p0.x - dpx, p0.y - dpy},
                {p1.x - dpx, p1.y - dpy}, {p1.x + dpx, p1.y + dpy}};
    fill_convex(cv, pt, 4);
  }
  for (int i = 0; i < 2; ++i) {
    if (flags & (i + 1)) {
      fill_circle(cv, (p0.x + (XY_ONE >> 1)) >> XY_SHIFT,
                  (p0.y + (XY_ONE >> 1)) >> XY_SHIFT,
                  (th + (XY_ONE >> 1)) >> XY_SHIFT);
    }
    p0 = p1;
  }
}

// ------------------------------------------ cv2.resize INTER_LINEAR, uint8 ----
// cv2's fixed-point bilinear of uint8 images (resizeGeneric_ with
// HResizeLinear and VResizeLinear), found equal to cv2.resize on random
// sizes up and down: 11-bit coefficients rounded from float32 fractions;
// along x a source column left of 0 or at the last one or beyond takes
// that border column alone; the horizontal pass sums into ints; along y
// the fraction is not clamped, the two rows are clamped to the image, and
// each output byte is VResizeLinearVec_32s8u's: both sums shifted right by
// 4 and saturated to int16, multiplied keeping the high 16 bits, added,
// then (s + 2) >> 2 saturated to uint8.
const float kCoefScale = 2048.f;

void linear_taps(int dsize, int ssize, bool clamp, std::vector<int>* ofs,
                 std::vector<int>* coef) {
  double scale = double(ssize) / dsize;
  ofs->resize(dsize);
  coef->resize(2 * size_t(dsize));
  for (int d = 0; d < dsize; ++d) {
    float f = float((d + 0.5) * scale - 0.5);
    int s = int(floorf(f));
    f -= s;
    if (clamp && s < 0) {
      f = 0;
      s = 0;
    }
    if (clamp && s >= ssize - 1) {
      f = 0;
      s = ssize - 1;
    }
    (*ofs)[d] = s;
    (*coef)[2 * d] = int(lrintf((1.f - f) * kCoefScale));
    (*coef)[2 * d + 1] = int(lrintf(f * kCoefScale));
  }
}

inline int sat16(int v) { return v < -32768 ? -32768 : v > 32767 ? 32767 : v; }

void resize_linear_u8(const uint8_t* src, int h, int w, int c, uint8_t* dst,
                      int oh, int ow) {
  std::vector<int> xofs, yofs, alpha, beta;
  linear_taps(ow, w, true, &xofs, &alpha);
  linear_taps(oh, h, false, &yofs, &beta);
  const int n = ow * c;
  std::vector<int> rows(2 * size_t(n));
  auto hpass = [&](int sy, int* out) {
    const uint8_t* s = src + size_t(sy) * w * c;
    for (int dx = 0; dx < ow; ++dx) {
      int sx = xofs[dx];
      int sx1 = sx + 1 < w ? sx + 1 : sx;
      int a0 = alpha[2 * dx], a1 = alpha[2 * dx + 1];
      for (int k = 0; k < c; ++k)
        out[dx * c + k] = s[sx * c + k] * a0 + s[sx1 * c + k] * a1;
    }
  };
  int* r0 = rows.data();
  int* r1 = rows.data() + n;
  for (int dy = 0; dy < oh; ++dy) {
    int sy0 = std::min(std::max(yofs[dy], 0), h - 1);
    int sy1 = std::min(std::max(yofs[dy] + 1, 0), h - 1);
    hpass(sy0, r0);
    hpass(sy1, r1);
    int b0 = beta[2 * dy], b1 = beta[2 * dy + 1];
    uint8_t* d = dst + size_t(dy) * n;
    for (int x = 0; x < n; ++x) {
      int v = int16_t(((sat16(r0[x] >> 4) * b0) >> 16) +
                      ((sat16(r1[x] >> 4) * b1) >> 16));
      v = (v + 2) >> 2;
      d[x] = uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
}

// ---- MPEG-4 Part 2 intra VOPs (ISO/IEC 14496-2) --------------------------
// The packed tables of aloscene/renderer/video.py (packed_tables): each
// entry is code << 8 | length, 0 where TCOEF has no code.
const int kMcbpc = 0, kCbpy = 4, kDcLum = 20, kDcChrom = 33, kTcoef = 46;
const int kMaxLevel = 32;

struct Bits {
  uint8_t* out;
  int64_t cap, n = 0;
  uint64_t acc = 0;  // the bits not yet written, in its low `held` bits
  int held = 0;

  void put(uint32_t value, int len) {  // len <= 32
    acc = (acc << len) | (value & ((uint64_t(1) << len) - 1));
    held += len;
    while (held >= 8) {
      held -= 8;
      if (n < cap) out[n] = uint8_t(acc >> held);
      ++n;
    }
  }
  void code(uint32_t entry) { put(entry >> 8, int(entry & 0xFF)); }
  // next_start_code(): a 0, then 1s to the byte
  void stuff() {
    put(0, 1);
    if (held) put((1u << (8 - held)) - 1, 8 - held);
  }
};

int bit_length(int v) {
  int n = 0;
  for (; v; v >>= 1) ++n;
  return n;
}

struct Tcoef {
  const uint32_t* t;
  int lmax[2][64], rmax[2][kMaxLevel];

  explicit Tcoef(const uint32_t* tables) : t(tables + kTcoef) {
    for (int last = 0; last < 2; ++last) {
      for (int l = 0; l < kMaxLevel; ++l) rmax[last][l] = -1;
      for (int run = 0; run < 64; ++run) {
        lmax[last][run] = 0;
        for (int l = 1; l < kMaxLevel; ++l)
          if (at(last, run, l)) {
            lmax[last][run] = l;
            rmax[last][l] = std::max(rmax[last][l], run);
          }
      }
    }
  }
  uint32_t at(int last, int run, int level) const {
    return t[(last * 64 + run) * kMaxLevel + level];
  }
  // one (last, run, level) event: the table, else escape 1 (level - LMAX),
  // escape 2 (run - RMAX - 1) or escape 3 (fixed length)
  void event(Bits* b, int last, int run, int level) const {
    const int lv = std::abs(level), sign = level < 0;
    const int lm = lmax[last][run];
    const int rm = lv < kMaxLevel ? rmax[last][lv] : -1;
    const int run2 = rm >= 0 ? run - rm - 1 : -1;
    const uint32_t esc = 0x3 << 8 | 7;  // 0000011
    if (lv <= lm) {
      b->code(at(last, run, lv));
    } else if (lm && lv - lm <= lm) {
      b->code(esc);
      b->put(0, 1);
      b->code(at(last, run, lv - lm));
    } else if (run2 >= 0 && lv <= lmax[last][run2]) {
      b->code(esc);
      b->put(2, 2);
      b->code(at(last, run2, lv));
    } else {
      b->code(esc);
      b->put(3, 2);
      b->put(last, 1);
      b->put(run, 6);
      b->put(1, 1);
      b->put(level & 0xFFF, 12);
      b->put(1, 1);
      return;
    }
    b->put(sign, 1);
  }
};

int dc_scaler(int qp, bool luminance) {
  if (qp <= 4) return 8;
  if (luminance) return qp <= 8 ? 2 * qp : qp <= 24 ? qp + 8 : 2 * qp - 16;
  return qp <= 24 ? (qp + 13) / 2 : qp - 6;
}

// levels: (mb_h * mb_w, 6, 64) int16, zig-zag order, each block's quantised
// DC first; the macroblocks across, then down.
int64_t intra_vop(const int16_t* levels, int mb_w, int mb_h, int qp,
                  int seconds, int increment, int increment_bits,
                  const uint32_t* tables, uint8_t* out, int64_t cap) {
  Bits b{out, cap};
  const Tcoef tcoef(tables);
  b.put(0x1B6, 32);
  b.put(0, 2);  // vop_coding_type: I
  for (int s = 0; s < seconds; ++s) b.put(1, 1);  // modulo_time_base
  b.put(0, 1);
  b.put(1, 1);
  b.put(uint32_t(increment), increment_bits);
  b.put(1, 1);
  b.put(1, 1);  // vop_coded
  b.put(0, 3);  // intra_dc_vlc_thr: the DC VLC everywhere
  b.put(uint32_t(qp), 5);
  const int scale[2] = {dc_scaler(qp, true), dc_scaler(qp, false)};
  // reconstructed DCs by plane, with a border row and column of 1024
  const int lw = 2 * mb_w + 1, cw = mb_w + 1;
  std::vector<int> dcs[3] = {
      std::vector<int>(size_t(lw) * (2 * mb_h + 1), 1024),
      std::vector<int>(size_t(cw) * (mb_h + 1), 1024),
      std::vector<int>(size_t(cw) * (mb_h + 1), 1024)};
  for (int m = 0; m < mb_w * mb_h; ++m) {
    const int r = m / mb_w, c = m % mb_w;
    const int16_t* mb = levels + size_t(m) * 6 * 64;
    bool coded[6];
    for (int k = 0; k < 6; ++k) {
      coded[k] = false;
      for (int i = 1; i < 64; ++i) coded[k] |= mb[k * 64 + i] != 0;
    }
    b.code(tables[kMcbpc + coded[4] * 2 + coded[5]]);
    b.put(0, 1);  // ac_pred_flag
    b.code(tables[kCbpy + coded[0] * 8 + coded[1] * 4 + coded[2] * 2 +
                  coded[3]]);
    for (int k = 0; k < 6; ++k) {
      const int16_t* blk = mb + k * 64;
      const bool lum = k < 4;
      const int br = lum ? 2 * r + k / 2 : r, bc = lum ? 2 * c + k % 2 : c;
      const int w = lum ? lw : cw;
      int* f = dcs[lum ? 0 : k - 3].data();
      // the block sits at (br + 1, bc + 1): row and column 0 are the border
      const int fa = f[(br + 1) * w + bc], fb = f[br * w + bc],
                fc = f[br * w + bc + 1];
      const int pred = std::abs(fa - fb) < std::abs(fb - fc) ? fc : fa;
      const int s = scale[lum ? 0 : 1];
      const int diff = blk[0] - (pred + s / 2) / s;
      f[(br + 1) * w + bc + 1] = blk[0] * s;
      const int size = bit_length(std::abs(diff));
      b.code(tables[(lum ? kDcLum : kDcChrom) + size]);
      if (size) {
        b.put(uint32_t(diff > 0 ? diff : diff - 1), size);
        if (size > 8) b.put(1, 1);
      }
      if (!coded[k]) continue;
      int last_nz = 63;
      while (!blk[last_nz]) --last_nz;
      int run = 0;
      for (int i = 1; i <= last_nz; ++i) {
        if (!blk[i]) {
          ++run;
          continue;
        }
        tcoef.event(&b, i == last_nz, run, blk[i]);
        run = 0;
      }
    }
  }
  b.stuff();
  return b.n <= cap ? b.n : -1;
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    snprintf(err, size_t(errlen), "%s", msg.c_str());
  }
}

}  // namespace

extern "C" {

int alo_decode(const char* path, int mode, int* h, int* w, int* c,
               int* bytes_per_sample, void** data, char* err, int errlen) {
  Image img;
  Failure f = decode_file(path, mode, &img);
  *data = nullptr;
  if (f.code != kOk) {
    set_error(err, errlen, f.msg);
    return f.code;
  }
  *h = img.h;
  *w = img.w;
  *c = img.c;
  *bytes_per_sample = img.bytes;
  void* out = malloc(img.data.size());
  if (!out) {
    set_error(err, errlen, "out of memory");
    return kCorrupt;
  }
  memcpy(out, img.data.data(), img.data.size());
  *data = out;
  return kOk;
}

void alo_free(void* p) { free(p); }

// Bilinear resize + normalize of an (h, w, 3) uint8 RGB image into (oh, ow,
// 3) float32.
void alo_resize_normalize(const uint8_t* src, int h, int w, float* out,
                          int oh, int ow, int mode, const float* mean,
                          const float* stddev) {
  resize_normalize(src, h, w, out, oh, ow, mode, mean, stddev);
}

// Set the pixels of the polygon xy (n integer vertices, x then y) to 1 in
// an (h, w) uint8 mask.
void alo_fill_poly(uint8_t* mask, int h, int w, const int* xy, int n) {
  fill_poly(mask, w, h, xy, n);
}

int alo_decode_buffer(const uint8_t* buf, size_t len, int mode, int* h, int* w,
                      int* c, int* bytes_per_sample, void** data, char* err,
                      int errlen) {
  Image img;
  Failure f = decode_buffer(buf, len, mode, &img);
  *data = nullptr;
  if (f.code != kOk) {
    set_error(err, errlen, f.msg);
    return f.code;
  }
  *h = img.h;
  *w = img.w;
  *c = img.c;
  *bytes_per_sample = img.bytes;
  void* out = malloc(img.data.size());
  if (!out) {
    set_error(err, errlen, "out of memory");
    return kCorrupt;
  }
  memcpy(out, img.data.data(), img.data.size());
  *data = out;
  return kOk;
}

void alo_resize_linear_u8(const uint8_t* src, int h, int w, int c,
                          uint8_t* dst, int oh, int ow) {
  resize_linear_u8(src, h, w, c, dst, oh, ow);
}

void alo_line(uint8_t* img, int h, int w, int c, int64_t x1, int64_t y1,
              int64_t x2, int64_t y2, const uint8_t* color, int thickness) {
  Canvas cv{img, w, h, c, color};
  Pt p1{x1 + thickness, y1 + thickness}, p2{x2 + thickness, y2 + thickness};
  if (!clip_line(w + 2 * int64_t(thickness), h + 2 * int64_t(thickness), p1,
                 p2))
    return;
  p1.x -= thickness;
  p1.y -= thickness;
  p2.x -= thickness;
  p2.y -= thickness;
  thick_line(cv, p1, p2, thickness, 3);
}

void alo_rectangle(uint8_t* img, int h, int w, int c, int64_t x1, int64_t y1,
                   int64_t x2, int64_t y2, const uint8_t* color,
                   int thickness) {
  Canvas cv{img, w, h, c, color};
  Pt pt[4] = {{x1, y1}, {x2, y1}, {x2, y2}, {x1, y2}};
  Pt p0 = pt[3];
  for (int i = 0; i < 4; ++i) {
    thick_line(cv, p0, pt[i], thickness, 2);
    p0 = pt[i];
  }
}

int64_t alo_mpeg4_intra_vop(const int16_t* levels, int mb_w, int mb_h,
                            int qp, int seconds, int increment,
                            int increment_bits, const uint32_t* tables,
                            uint8_t* out, int64_t cap) {
  return intra_vop(levels, mb_w, mb_h, qp, seconds, increment,
                   increment_bits, tables, out, cap);
}

}  // extern "C"
