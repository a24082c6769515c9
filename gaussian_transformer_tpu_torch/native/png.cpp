// png.cpp: the native IO tier's own PNG decoder, compiled into gt_native.
//
// It replaces libpng (and zlib) in the tier, so that a PNG decodes wherever
// g++ is: the H100's machine has no png.h (it has zlib.h, which the tier
// does not rely on either). It reads every PNG: each colour type at each legal bit depth (gray
// 1/2/4/8/16, RGB 8/16, palette 1/2/4/8, gray+alpha 8/16, RGBA 8/16), all
// five filters, Adam7 interlacing, PLTE and tRNS.
//   * inflate (RFC 1950/1951): stored, fixed and dynamic blocks, the zlib
//     header and its Adler-32, with a 9-bit lookahead table per code;
//   * chunks: IHDR, PLTE, tRNS, IDAT (across any number of chunks) and
//     IEND; a critical chunk's CRC is checked, as libpng checks it, and
//     ancillary chunks are skipped (neither reference applies gAMA, sRGB or
//     iCCP), unread;
//   * unfiltering (None, Sub, Up, Average, Paeth) per pass of Adam7.
// Two outputs, each bit for bit with the JAX package's path it replaces:
//   * RGB, the JAX tier's libpng path (png_set_expand, strip_16,
//     strip_alpha, gray_to_rgb): palette to RGB, gray below 8 bits scaled
//     up (1-bit x255, 2-bit x85, 4-bit x17), 16 bits cut to the high byte,
//     alpha and tRNS dropped;
//   * RGBA, Pillow's Image.open(p).convert("RGBA") of the Blender reader:
//     the same, but tRNS becomes alpha (palette alphas, or 0 where the
//     8-bit samples equal the gray or RGB key as Pillow compares it) and
//     16-bit gray, which Pillow reads as I;16, is clipped to 255 rather
//     than cut to its high byte.
// A file it cannot read returns a status and a message naming the fault.
//
// Bounds: inflate is serial (one bit stream), so a file decodes on one
// thread and the pool in gt_native.cpp decodes files in parallel; the
// Average and Paeth filters are serial along a row too. No state outlives
// a call.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum Status { kOk = 0, kUnreadable = -1, kCorrupt = -20, kTooLarge = -21 };

struct Failure {
  int status;
  std::string what;
};

[[noreturn]] void fail(std::string what, int status = kCorrupt) { throw Failure{status, std::move(what)}; }

// ---------------------------------------------------------------- inflate ---

constexpr int kFast = 9;

struct Huffman {
  uint16_t fast[1 << kFast];  // (length << 12) | symbol for codes of kFast bits or fewer; 0 if longer
  int16_t count[16];          // codes of each length
  int16_t symbol[320];        // symbols in canonical order
};

// Builds the canonical code of `n` lengths. Over-subscribed codes are an
// error; an incomplete code is kept (an unused code then fails to decode).
void build(Huffman& h, const uint8_t* lengths, int n) {
  memset(h.count, 0, sizeof h.count);
  for (int i = 0; i < n; i++) h.count[lengths[i]]++;
  h.count[0] = 0;
  int left = 1;
  for (int len = 1; len < 16; len++) {
    left = (left << 1) - h.count[len];
    if (left < 0) fail("corrupt image data (an over-subscribed Huffman code)");
  }
  int16_t offs[16];
  offs[1] = 0;
  for (int len = 1; len < 15; len++) offs[len + 1] = (int16_t)(offs[len] + h.count[len]);
  for (int i = 0; i < n; i++)
    if (lengths[i]) h.symbol[offs[lengths[i]]++] = (int16_t)i;
  memset(h.fast, 0, sizeof h.fast);
  int code = 0, k = 0;
  for (int len = 1; len <= kFast; len++) {
    for (int i = 0; i < h.count[len]; i++, k++, code++) {
      int rev = 0;
      for (int b = 0; b < len; b++) rev |= ((code >> b) & 1) << (len - 1 - b);
      for (int j = rev; j < (1 << kFast); j += 1 << len) h.fast[j] = (uint16_t)((len << 12) | h.symbol[k]);
    }
    code <<= 1;
  }
}

struct Inflater {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int n = 0;  // valid bits at the bottom of buf, the next bit first
  std::vector<uint8_t>& out;

  Inflater(const uint8_t* d, size_t size, std::vector<uint8_t>& o) : p(d), end(d + size), out(o) {}

  void refill() {
    while (n <= 56 && p < end) {
      buf |= (uint64_t)*p++ << n;
      n += 8;
    }
  }
  int bits(int k) {
    if (n < k) {
      refill();
      if (n < k) fail("corrupt image data (the compressed stream ends early)");
    }
    int v = (int)(buf & ((1ull << k) - 1));
    buf >>= k;
    n -= k;
    return v;
  }
  int decode(const Huffman& h) {
    if (n < 15) refill();
    uint16_t e = h.fast[buf & ((1 << kFast) - 1)];
    if (e && (e >> 12) <= n) {
      buf >>= e >> 12;
      n -= e >> 12;
      return e & 0xFFF;
    }
    int code = 0, first = 0, index = 0;  // puff.c's decode, a bit at a time
    for (int len = 1; len < 16; len++) {
      code |= bits(1);
      int count = h.count[len];
      if (code - count < first) return h.symbol[index + (code - first)];
      index += count;
      first += count;
      first <<= 1;
      code <<= 1;
    }
    fail("corrupt image data (an invalid Huffman code)");
  }

  void codes(const Huffman& lit, const Huffman& dist) {
    static const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                                          31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
    static const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                          2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
    static const uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
                                           33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
                                           1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
    static const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                           6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
    for (;;) {
      int sym = decode(lit);
      if (sym < 256) {
        out.push_back((uint8_t)sym);
      } else if (sym == 256) {
        return;
      } else {
        sym -= 257;
        if (sym >= 29) fail("corrupt image data (an invalid length code)");
        int len = kLenBase[sym] + bits(kLenExtra[sym]);
        int d = decode(dist);
        if (d >= 30) fail("corrupt image data (an invalid distance code)");
        size_t back = kDistBase[d] + (size_t)bits(kDistExtra[d]);
        if (back > out.size()) fail("corrupt image data (a distance too far back)");
        size_t from = out.size() - back;
        for (int i = 0; i < len; i++) out.push_back(out[from + i]);
      }
    }
  }

  void run() {
    if (end - p < 2) fail("corrupt image data (no zlib header)");
    int cmf = p[0], flg = p[1];
    if ((cmf & 15) != 8 || (cmf >> 4) > 7 || ((cmf << 8) | flg) % 31 != 0) fail("corrupt image data (a bad zlib header)");
    if (flg & 0x20) fail("corrupt image data (a zlib preset dictionary)");
    p += 2;
    for (bool last = false; !last;) {
      last = bits(1);
      int type = bits(2);
      if (type == 0) {  // stored
        buf >>= n & 7;
        n -= n & 7;
        int len = bits(16), nlen = bits(16);
        if (len != (~nlen & 0xFFFF)) fail("corrupt image data (a stored block's length check)");
        for (int i = 0; i < len; i++) out.push_back((uint8_t)bits(8));
      } else if (type == 1) {  // fixed
        static Huffman lit, dist;
        static bool built = [] {
          uint8_t l[288], d[30];
          for (int i = 0; i < 144; i++) l[i] = 8;
          for (int i = 144; i < 256; i++) l[i] = 9;
          for (int i = 256; i < 280; i++) l[i] = 7;
          for (int i = 280; i < 288; i++) l[i] = 8;
          for (int i = 0; i < 30; i++) d[i] = 5;
          build(lit, l, 288);
          build(dist, d, 30);
          return true;
        }();
        (void)built;
        codes(lit, dist);
      } else if (type == 2) {  // dynamic
        static const uint8_t kOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};
        int nlen = bits(5) + 257, ndist = bits(5) + 1, ncode = bits(4) + 4;
        if (nlen > 286 || ndist > 30) fail("corrupt image data (too many length or distance codes)");
        uint8_t lengths[320] = {};
        for (int i = 0; i < ncode; i++) lengths[kOrder[i]] = (uint8_t)bits(3);
        Huffman lencode, lit, dist;
        build(lencode, lengths, 19);
        memset(lengths, 0, sizeof lengths);
        for (int i = 0; i < nlen + ndist;) {
          int sym = decode(lencode);
          if (sym < 16) {
            lengths[i++] = (uint8_t)sym;
            continue;
          }
          int len = 0, rep;
          if (sym == 16) {
            if (i == 0) fail("corrupt image data (a repeat with no previous length)");
            len = lengths[i - 1];
            rep = 3 + bits(2);
          } else if (sym == 17) {
            rep = 3 + bits(3);
          } else {
            rep = 11 + bits(7);
          }
          if (i + rep > nlen + ndist) fail("corrupt image data (too many code lengths)");
          while (rep--) lengths[i++] = (uint8_t)len;
        }
        if (lengths[256] == 0) fail("corrupt image data (no end-of-block code)");
        build(lit, lengths, nlen);
        build(dist, lengths + nlen, ndist);
        codes(lit, dist);
      } else {
        fail("corrupt image data (an invalid block type)");
      }
    }
    buf >>= n & 7;  // the Adler-32, big-endian, after the last block
    n -= n & 7;
    uint32_t want = 0;
    for (int i = 0; i < 4; i++) want = (want << 8) | (uint32_t)bits(8);
    uint32_t a = 1, b = 0;
    const uint8_t* d = out.data();
    for (size_t left = out.size(); left;) {
      size_t k = left < 5552 ? left : 5552;
      left -= k;
      while (k--) {
        a += *d++;
        b += a;
      }
      a %= 65521;
      b %= 65521;
    }
    if (((b << 16) | a) != want) fail("corrupt image data (an Adler-32 mismatch)");
  }
};

// ------------------------------------------------------------------ PNG ----

uint32_t be32(const uint8_t* p) { return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3]; }

uint32_t crc32(const uint8_t* p, size_t n) {
  static uint32_t table[256];
  static bool built = [] {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = c & 1 ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    return true;
  }();
  (void)built;
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Png {
  uint32_t width = 0, height = 0;
  int depth = 0, color_type = 0, interlace = 0, channels = 0;
  uint8_t palette[256][4];
  int npalette = 0;
  bool has_trns = false;
  uint16_t key[3] = {};
  std::vector<uint16_t> samples;  // [height][width][channels] at the file's depth
};

int channels_of(int color_type) {
  switch (color_type) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
  }
  return 0;
}

bool depth_ok(int color_type, int depth) {
  switch (color_type) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
  }
  return false;
}

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  return pa <= pb && pa <= pc ? a : pb <= pc ? b : c;
}

// Unfilters one pass in place ([rows][1 + stride]) and stores its samples.
void unfilter_pass(Png& png, uint8_t* data, size_t stride, uint32_t pw, uint32_t ph, uint32_t x0, uint32_t y0,
                   uint32_t dx, uint32_t dy) {
  const int c = png.channels, depth = png.depth;
  const size_t bpp = depth < 8 ? 1 : (size_t)c * depth / 8;
  std::vector<uint8_t> zero(stride, 0);
  const uint8_t* prev = zero.data();
  for (uint32_t y = 0; y < ph; y++) {
    uint8_t* row = data + (size_t)y * (stride + 1);
    int ft = row[0];
    uint8_t* cur = row + 1;
    switch (ft) {
      case 0: break;
      case 1:
        for (size_t x = bpp; x < stride; x++) cur[x] = (uint8_t)(cur[x] + cur[x - bpp]);
        break;
      case 2:
        for (size_t x = 0; x < stride; x++) cur[x] = (uint8_t)(cur[x] + prev[x]);
        break;
      case 3:
        for (size_t x = 0; x < bpp && x < stride; x++) cur[x] = (uint8_t)(cur[x] + (prev[x] >> 1));
        for (size_t x = bpp; x < stride; x++) cur[x] = (uint8_t)(cur[x] + ((cur[x - bpp] + prev[x]) >> 1));
        break;
      case 4:
        for (size_t x = 0; x < bpp && x < stride; x++) cur[x] = (uint8_t)(cur[x] + prev[x]);
        for (size_t x = bpp; x < stride; x++) cur[x] = (uint8_t)(cur[x] + paeth(cur[x - bpp], prev[x], prev[x - bpp]));
        break;
      default:
        fail("bad filter type " + std::to_string(ft));
    }
    prev = cur;
    uint16_t* out = png.samples.data() + ((size_t)(y0 + y * dy) * png.width + x0) * c;
    const size_t step = (size_t)dx * c;
    const size_t n = (size_t)pw * c;
    if (depth == 8) {
      for (size_t i = 0; i < n; i++) out[i / c * step + i % c] = cur[i];
    } else if (depth == 16) {
      for (size_t i = 0; i < n; i++) out[i / c * step + i % c] = (uint16_t)(cur[2 * i] << 8 | cur[2 * i + 1]);
    } else {
      const int per = 8 / depth, mask = (1 << depth) - 1;
      for (size_t i = 0; i < n; i++) {
        int shift = 8 - depth * (int)(i % per + 1);
        out[i / c * step + i % c] = (uint16_t)((cur[i / per] >> shift) & mask);
      }
    }
  }
}

Png parse(const uint8_t* data, size_t size) {
  static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  if (size < 8 || memcmp(data, kSig, 8) != 0) fail("not a PNG file (bad signature)");
  Png png;
  std::vector<uint8_t> idat;
  bool have_ihdr = false, have_plte = false;
  size_t pos = 8;
  for (;;) {
    if (size - pos < 12) fail("the file ends before IEND");
    uint32_t len = be32(data + pos);
    const uint8_t* type = data + pos + 4;
    std::string name((const char*)type, 4);
    if (len > 0x7FFFFFFFu || size - pos - 12 < len) fail("the file ends inside a " + name + " chunk");
    const uint8_t* body = type + 4;
    bool critical = !(type[0] & 0x20);
    if (critical && crc32(type, 4 + (size_t)len) != be32(body + len)) fail("CRC error in the " + name + " chunk");
    pos += 12 + (size_t)len;
    if (!have_ihdr && name != "IHDR") fail("the first chunk is not IHDR");
    if (name == "IHDR") {
      if (have_ihdr || len != 13) fail("bad IHDR");
      have_ihdr = true;
      png.width = be32(body);
      png.height = be32(body + 4);
      png.depth = body[8];
      png.color_type = body[9];
      png.interlace = body[12];
      if (png.width == 0 || png.height == 0 || png.width > 0x7FFFFFFFu || png.height > 0x7FFFFFFFu)
        fail("bad image size " + std::to_string(png.width) + "x" + std::to_string(png.height));
      if (!depth_ok(png.color_type, png.depth))
        fail("bad bit depth " + std::to_string(png.depth) + " for color type " + std::to_string(png.color_type));
      if (body[10] != 0 || body[11] != 0 || png.interlace > 1) fail("bad compression, filter or interlace method");
      png.channels = channels_of(png.color_type);
      if ((uint64_t)png.width * png.height > (1ull << 28)) fail("an image over 2^28 pixels", kTooLarge);
    } else if (name == "PLTE") {
      if (len % 3 || len == 0 || len > 768) fail("bad PLTE length " + std::to_string(len));
      png.npalette = (int)len / 3;
      for (int i = 0; i < 256; i++) {
        bool in = i < png.npalette;
        for (int k = 0; k < 3; k++) png.palette[i][k] = in ? body[3 * i + k] : 0;
        png.palette[i][3] = 255;
      }
      have_plte = true;
    } else if (name == "tRNS") {
      if (png.color_type == 3) {  // Pillow takes entries past PLTE's too (libpng drops such a tRNS)
        for (uint32_t i = 0; i < len && i < 256; i++) png.palette[i][3] = body[i];
        png.has_trns = len > 0;
      } else if (png.color_type == 0 && len >= 2) {
        png.key[0] = (uint16_t)(body[0] << 8 | body[1]);
        png.has_trns = true;
      } else if (png.color_type == 2 && len >= 6) {
        for (int k = 0; k < 3; k++) png.key[k] = (uint16_t)(body[2 * k] << 8 | body[2 * k + 1]);
        png.has_trns = true;
      }
    } else if (name == "IDAT") {
      idat.insert(idat.end(), body, body + len);
    } else if (name == "IEND") {
      break;
    } else if (critical) {
      fail("unknown critical chunk " + name);
    }
  }
  if (png.color_type == 3 && !have_plte) fail("a palette image without PLTE");
  if (idat.empty()) fail("no IDAT chunk");

  static const uint32_t kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                        {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
  static const uint32_t kWhole[1][4] = {{0, 0, 1, 1}};
  const uint32_t(*passes)[4] = png.interlace ? kAdam7 : kWhole;
  int npasses = png.interlace ? 7 : 1;
  size_t expected = 0;
  for (int i = 0; i < npasses; i++) {
    uint32_t x0 = passes[i][0], y0 = passes[i][1], dx = passes[i][2], dy = passes[i][3];
    uint64_t pw = png.width > x0 ? (png.width - x0 + dx - 1) / dx : 0;
    uint64_t ph = png.height > y0 ? (png.height - y0 + dy - 1) / dy : 0;
    if (pw && ph) expected += ph * (1 + (pw * png.channels * png.depth + 7) / 8);
  }
  std::vector<uint8_t> raw;
  raw.reserve(expected);
  Inflater(idat.data(), idat.size(), raw).run();
  if (raw.size() < expected) fail("the image data is too short");
  png.samples.assign((size_t)png.width * png.height * png.channels, 0);
  size_t at = 0;
  for (int i = 0; i < npasses; i++) {
    uint32_t x0 = passes[i][0], y0 = passes[i][1], dx = passes[i][2], dy = passes[i][3];
    uint32_t pw = png.width > x0 ? (png.width - x0 + dx - 1) / dx : 0;
    uint32_t ph = png.height > y0 ? (png.height - y0 + dy - 1) / dy : 0;
    if (!pw || !ph) continue;
    size_t stride = ((size_t)pw * png.channels * png.depth + 7) / 8;
    unfilter_pass(png, raw.data() + at, stride, pw, ph, x0, y0, dx, dy);
    at += (size_t)ph * (stride + 1);
  }
  return png;
}

// 8-bit value of a sample: gray below 8 bits scaled up (libpng's expand),
// 16 bits cut to the high byte (strip_16).
inline uint8_t to8(uint16_t v, int depth) {
  switch (depth) {
    case 16: return (uint8_t)(v >> 8);
    case 1: return (uint8_t)(v * 255);
    case 2: return (uint8_t)(v * 85);
    case 4: return (uint8_t)(v * 17);
  }
  return (uint8_t)v;
}

void output(const Png& png, bool rgba, uint8_t* dst) {
  const int c = png.channels, oc = rgba ? 4 : 3, depth = png.depth;
  // Pillow's tRNS key, as its RGBA conversion compares it with the 8-bit
  // samples: a gray key below 2^depth (1-bit: times 255; 16-bit: its low
  // byte against the clipped gray), an RGB key (16-bit: its low bytes
  // against the high bytes; 8-bit: a key over 255 matches nothing).
  int gray_key = -1, rgb_key[3] = {-1, -1, -1};
  if (png.has_trns && png.color_type == 0)
    gray_key = depth == 16 ? png.key[0] & 0xFF : png.key[0] >= (1 << depth) ? -1 : depth == 1 ? png.key[0] * 255 : png.key[0];
  if (png.has_trns && png.color_type == 2)
    for (int k = 0; k < 3; k++) rgb_key[k] = depth == 16 ? png.key[k] & 0xFF : png.key[k];
  const size_t n = (size_t)png.width * png.height;
  const uint16_t* s = png.samples.data();
  for (size_t i = 0; i < n; i++, s += c) {
    uint8_t* o = dst + i * oc;
    int alpha = 255;
    switch (png.color_type) {
      case 3: {
        const uint8_t* e = png.palette[s[0]];
        o[0] = e[0];
        o[1] = e[1];
        o[2] = e[2];
        alpha = e[3];
        break;
      }
      case 0: {
        // Pillow reads 16-bit gray as I;16, and its RGBA conversion clips.
        uint8_t g = rgba && depth == 16 ? (uint8_t)(s[0] > 255 ? 255 : s[0]) : to8(s[0], depth);
        o[0] = o[1] = o[2] = g;
        if (gray_key >= 0 && g == gray_key) alpha = 0;
        break;
      }
      case 2:
        for (int k = 0; k < 3; k++) o[k] = to8(s[k], depth);
        if (png.has_trns && o[0] == rgb_key[0] && o[1] == rgb_key[1] && o[2] == rgb_key[2]) alpha = 0;
        break;
      case 4:
        o[0] = o[1] = o[2] = to8(s[0], depth);
        alpha = to8(s[1], depth);
        break;
      case 6:
        for (int k = 0; k < 3; k++) o[k] = to8(s[k], depth);
        alpha = to8(s[3], depth);
        break;
    }
    if (rgba) o[3] = (uint8_t)alpha;
  }
}

}  // namespace

// Decode a PNG held in memory to RGB8 (channels 3) or RGBA8 (channels 4),
// malloc'd, width x height x channels. Returns null and sets *status and
// `why` when it cannot.
uint8_t* gt_png_decode(const uint8_t* data, size_t size, int channels, int* w, int* h, int* status,
                       std::string* why) {
  try {
    Png png = parse(data, size);
    uint8_t* out = (uint8_t*)malloc((size_t)png.width * png.height * channels);
    if (!out) fail("out of memory", kUnreadable);
    output(png, channels == 4, out);
    *w = (int)png.width;
    *h = (int)png.height;
    *status = kOk;
    return out;
  } catch (const Failure& f) {
    *status = f.status;
    if (why) *why = f.what;
  } catch (const std::exception& e) {
    *status = kUnreadable;
    if (why) *why = e.what();
  }
  return nullptr;
}

// A PNG's samples as the file holds them, for Pillow's modes: width x height
// x channels values at the file's depth (1, 2, 4 and 8 bits one a byte, 16
// bits one a uint16), malloc'd; *channels and *depth from IHDR. Palette and
// tRNS are the caller's to read. Returns null and sets *status and `why`
// when it cannot.
void* gt_png_samples(const uint8_t* data, size_t size, int* w, int* h, int* channels, int* depth, int* status,
                     std::string* why) {
  try {
    Png png = parse(data, size);
    const size_t n = png.samples.size(), each = png.depth == 16 ? 2 : 1;
    void* out = malloc(n * each);
    if (!out) fail("out of memory", kUnreadable);
    if (each == 2)
      memcpy(out, png.samples.data(), n * 2);
    else
      for (size_t i = 0; i < n; i++) ((uint8_t*)out)[i] = (uint8_t)png.samples[i];
    *w = (int)png.width;
    *h = (int)png.height;
    *channels = png.channels;
    *depth = png.depth;
    *status = kOk;
    return out;
  } catch (const Failure& f) {
    *status = f.status;
    if (why) *why = f.what;
  } catch (const std::exception& e) {
    *status = kUnreadable;
    if (why) *why = e.what();
  }
  return nullptr;
}
