// jpeg_encode.cpp: the native IO tier's own JPEG encoder, compiled into
// gt_native.
//
// It writes the bytes that Pillow's Image.save(path) writes for an "L" or
// "RGB" image with no options, through its libjpeg-turbo, with no libjpeg
// here (the H100's machine has no jpeglib.h). That is libjpeg-turbo's
// baseline path with jpeg_set_defaults' settings, each stage following the
// source it names:
//   * markers (jcmarker.c): SOI; APP0 JFIF 1.01, density unit 0, 1x1, no
//     thumbnail; a COM segment when the caller passes one (Pillow writes the
//     comment the source image carried, right after APP0); one DQT per
//     table, 8-bit; SOF0; one DHT per table, DC before AC, in the order the
//     scan uses them; SOS; EOI. No restart markers.
//   * quantisation tables (jcparam.c): Annex K's at quality 75 (scale 50,
//     (q * 50 + 50) / 100, clamped to 1..255 by force_baseline);
//   * colour conversion (jccolor.c rgb_ycc_convert): 16-bit fixed-point
//     tables, ONE_HALF in Y, CBCR_OFFSET + ONE_HALF - 1 in Cb and Cr;
//   * edge handling (jcprepct.c, jcsample.c, jccoefct.c): an odd last row
//     repeated to fill the two-row conversion group, each row's last
//     column repeated out to the downsampler's width, then the last
//     downsampled row repeated to the iMCU's height; blocks of the MCU
//     past the image are dummies: zero AC, the quantised DC of the block
//     before them;
//   * downsampling (jcsample.c): Y full size, Cb and Cr h2v2 (4:2:0) with
//     the alternating 1, 2 bias; "L" is one component at 1x1;
//   * the forward DCT (jfdctint.c jpeg_fdct_islow: CONST_BITS 13,
//     PASS1_BITS 2) on level-shifted samples, its output scaled by 8;
//   * quantisation (jcdctmgr.c quantize with compute_reciprocal's divisors,
//     as libjpeg-turbo's SIMD build runs it: 16-bit reciprocal, correction
//     and shift of quantval * 8);
//   * Huffman coding (jchuff.c) with Annex K's tables (no optimize): DC
//     differences per component, AC runs with ZRL and EOB, FF bytes
//     stuffed with 00, the last byte padded with one bits.
//
// Bounds: Huffman coding is serial within a scan (one bit stream), so an
// image encodes on one thread; callers encode files in parallel. The DCT
// and the colour conversion are integer operations on every sample. No
// state outlives a call.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "jpeg_tables.h"

namespace {

using namespace gt_jpeg;

// jcparam.c std_luminance_quant_tbl / std_chrominance_quant_tbl (natural order).
const uint16_t kStdQuant[2][64] = {
    {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
     14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
     18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99},
    {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99,
     99, 99, 47, 66, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99}};

constexpr int kQuality = 75;

struct Out {
  std::vector<uint8_t> bytes;
  uint64_t acc = 0;  // bits not yet written, the oldest highest
  int nacc = 0;

  void byte(int b) { bytes.push_back((uint8_t)b); }
  void word(int w) {
    byte(w >> 8);
    byte(w & 0xFF);
  }
  void marker(int m) {
    byte(0xFF);
    byte(m);
  }
  void bits(uint32_t code, int size) {
    acc = (acc << size) | (code & ((1u << size) - 1));
    nacc += size;
    while (nacc >= 8) {
      int b = (int)(acc >> (nacc - 8)) & 0xFF;
      byte(b);
      if (b == 0xFF) byte(0);
      nacc -= 8;
    }
  }
  void flush() {  // jchuff.c flush_bits: pad with ones
    if (nacc) bits(0x7F, 8 - nacc);
    acc = 0;
  }
};

// jchuff.c jpeg_make_c_derived_tbl: code and size by symbol.
struct CHuff {
  uint32_t code[256] = {};
  int8_t size[256] = {};
  const uint8_t* bits;
  const uint8_t* vals;
  int nvals = 0;
};

CHuff derive(const uint8_t* bits, const uint8_t* vals) {
  CHuff t;
  t.bits = bits;
  t.vals = vals;
  int p = 0;
  uint32_t code = 0;
  for (int l = 1; l <= 16; l++) {
    for (int i = 0; i < bits[l]; i++, p++) {
      t.code[vals[p]] = code++;
      t.size[vals[p]] = (int8_t)l;
    }
    code <<= 1;
  }
  t.nvals = p;
  return t;
}

// jcdctmgr.c compute_reciprocal with 16-bit DCTELEMs (the SIMD build's).
struct Divisor {
  uint32_t recip, corr;
  int shift;  // total right shift of (x + corr) * recip
};

Divisor reciprocal(uint32_t divisor) {
  int b = 31 - __builtin_clz(divisor);
  int r = 16 + b;
  uint32_t fq = (uint32_t)((1ull << r) / divisor);
  uint32_t fr = (uint32_t)((1ull << r) % divisor);
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2) {
    c++;
  } else {
    fq++;
  }
  return {fq, c, r};
}

// jfdctint.c jpeg_fdct_islow, in place on [8][8].
constexpr int kConstBits = 13, kPass1Bits = 2;
enum : int32_t {
  F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373, F1175 = 9633,
  F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172,
};

inline int32_t descale(int64_t x, int n) { return (int32_t)((x + ((int64_t)1 << (n - 1))) >> n); }

void fdct_islow(int32_t* d) {
  for (int pass = 0; pass < 2; pass++) {
    const int step = pass ? 8 : 1, stride = pass ? 1 : 8;
    const int even = pass ? kPass1Bits : 0, odd = pass ? kConstBits + kPass1Bits : kConstBits - kPass1Bits;
    for (int ctr = 0; ctr < 8; ctr++) {
      int32_t* p = d + ctr * stride;
      int64_t t0 = p[0] + p[7 * step], t7 = p[0] - p[7 * step];
      int64_t t1 = p[step] + p[6 * step], t6 = p[step] - p[6 * step];
      int64_t t2 = p[2 * step] + p[5 * step], t5 = p[2 * step] - p[5 * step];
      int64_t t3 = p[3 * step] + p[4 * step], t4 = p[3 * step] - p[4 * step];
      int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
      if (pass) {
        p[0] = descale(t10 + t11, even);
        p[4 * step] = descale(t10 - t11, even);
      } else {
        p[0] = (int32_t)((t10 + t11) * (1 << kPass1Bits));
        p[4 * step] = (int32_t)((t10 - t11) * (1 << kPass1Bits));
      }
      int64_t z1 = (t12 + t13) * F0541;
      p[2 * step] = descale(z1 + t13 * F0765, odd);
      p[6 * step] = descale(z1 + t12 * -F1847, odd);
      z1 = t4 + t7;
      int64_t z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
      int64_t z5 = (z3 + z4) * F1175;
      t4 *= F0298;
      t5 *= F2053;
      t6 *= F3072;
      t7 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      p[7 * step] = descale(t4 + z1 + z3, odd);
      p[5 * step] = descale(t5 + z2 + z4, odd);
      p[3 * step] = descale(t6 + z2 + z3, odd);
      p[step] = descale(t7 + z1 + z4, odd);
    }
  }
}

struct Plane {
  int w = 0, h = 0;  // padded to whole blocks (and iMCU rows)
  std::vector<uint8_t> px;
  uint8_t* row(int y) { return px.data() + (size_t)y * w; }
};

struct Comp {
  int id, h, v, tq, td, ta;
  int wib, hib;  // blocks holding image samples
  Plane plane;
  Divisor div[64];
  int last_dc = 0;
};

// The planes, as jcprepct.c and jcsample.c leave them for the coefficient
// controller: image rows and columns, then edge copies out to the blocks
// and the iMCU rows.
void make_planes(const uint8_t* src, int width, int height, std::vector<Comp>& comps, int mcu_rows) {
  const int nc = (int)comps.size();
  const int vmax = nc == 3 ? 2 : 1;
  // jccolor.c rgb_ycc_start: the conversion tables.
  const int64_t half = 1 << 15, cbcr_offset = (int64_t)128 << 16;
  auto fix = [](double x) { return (int64_t)(x * 65536 + 0.5); };
  std::vector<int64_t> tab(8 * 256);
  for (int i = 0; i < 256; i++) {
    tab[i] = fix(0.29900) * i;
    tab[i + 256] = fix(0.58700) * i;
    tab[i + 512] = fix(0.11400) * i + half;
    tab[i + 768] = -fix(0.16874) * i;
    tab[i + 1024] = -fix(0.33126) * i;
    tab[i + 1280] = fix(0.50000) * i + cbcr_offset + half - 1;  // B->Cb, and R->Cr
    tab[i + 1536] = -fix(0.41869) * i;
    tab[i + 1792] = -fix(0.08131) * i;
  }
  // Full-size colour rows, as many as whole conversion groups (vmax rows)
  // hold: an odd last row repeated (expand_bottom_edge).
  const int full_rows = (height + vmax - 1) / vmax * vmax;
  const int full_w = comps[nc - 1].wib * 8 * (nc == 3 ? 2 : 1);  // the downsampler's input width
  std::vector<std::vector<uint8_t>> full(nc, std::vector<uint8_t>((size_t)full_rows * full_w));
  for (int y = 0; y < full_rows; y++) {
    const uint8_t* in = src + (size_t)(y < height ? y : height - 1) * width * nc;
    if (nc == 1) {
      memcpy(full[0].data() + (size_t)y * full_w, in, width);
    } else {
      uint8_t* o[3] = {full[0].data() + (size_t)y * full_w, full[1].data() + (size_t)y * full_w,
                       full[2].data() + (size_t)y * full_w};
      for (int x = 0; x < width; x++) {
        int r = in[3 * x], g = in[3 * x + 1], b = in[3 * x + 2];
        o[0][x] = (uint8_t)((tab[r] + tab[g + 256] + tab[b + 512]) >> 16);
        o[1][x] = (uint8_t)((tab[r + 768] + tab[g + 1024] + tab[b + 1280]) >> 16);
        o[2][x] = (uint8_t)((tab[r + 1280] + tab[g + 1536] + tab[b + 1792]) >> 16);
      }
    }
  }
  for (int ci = 0; ci < nc; ci++) {
    Comp& c = comps[ci];
    const int ratio = vmax / c.v;  // 1 full size, 2 h2v2
    const int out_w = c.wib * 8, in_w = out_w * ratio;
    c.plane.w = out_w;
    c.plane.h = mcu_rows * c.v * 8;
    c.plane.px.assign((size_t)c.plane.w * c.plane.h, 0);
    const int rows = full_rows / ratio;
    for (int y = 0; y < full_rows; y++) {  // expand_right_edge, on the full-size rows
      uint8_t* r = full[ci].data() + (size_t)y * full_w;
      memset(r + width, r[width - 1], in_w - width);
    }
    for (int y = 0; y < rows; y++) {
      uint8_t* o = c.plane.row(y);
      if (ratio == 1) {
        memcpy(o, full[ci].data() + (size_t)y * full_w, out_w);
        continue;
      }
      const uint8_t* i0 = full[ci].data() + (size_t)(2 * y) * full_w;
      const uint8_t* i1 = i0 + full_w;
      int bias = 1;  // h2v2_downsample: 1, 2, 1, 2, ...
      for (int x = 0; x < out_w; x++) {
        o[x] = (uint8_t)((i0[2 * x] + i0[2 * x + 1] + i1[2 * x] + i1[2 * x + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
    for (int y = rows; y < c.plane.h; y++) memcpy(c.plane.row(y), c.plane.row(rows - 1), out_w);
  }
}

void quantize_block(Comp& c, int by, int bx, int16_t* out) {
  int32_t ws[64];
  for (int y = 0; y < 8; y++) {
    const uint8_t* r = c.plane.row(by * 8 + y) + bx * 8;
    for (int x = 0; x < 8; x++) ws[y * 8 + x] = (int32_t)r[x] - 128;
  }
  fdct_islow(ws);
  for (int i = 0; i < 64; i++) {
    const Divisor& d = c.div[i];
    int32_t t = ws[i];
    uint32_t a = (uint32_t)(t < 0 ? -t : t);
    int32_t q = (int32_t)(((uint64_t)(a + d.corr) * d.recip) >> d.shift);
    out[i] = (int16_t)(t < 0 ? -q : q);
  }
}

void encode_block(Out& out, Comp& c, const int16_t* blk, const CHuff& dc, const CHuff& ac) {
  auto nbits_of = [](int v) { return v ? 32 - __builtin_clz((unsigned)v) : 0; };
  int t = blk[0] - c.last_dc, t2 = t;
  c.last_dc = blk[0];
  if (t < 0) {
    t = -t;
    t2--;
  }
  int nb = nbits_of(t);
  out.bits(dc.code[nb], dc.size[nb]);
  if (nb) out.bits((uint32_t)t2, nb);
  int run = 0;
  for (int k = 1; k < 64; k++) {
    int v = blk[kNatural[k]];
    if (!v) {
      run++;
      continue;
    }
    while (run > 15) {
      out.bits(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    int a = v < 0 ? -v : v, a2 = v < 0 ? v - 1 : v;
    nb = nbits_of(a);
    int sym = (run << 4) + nb;
    out.bits(ac.code[sym], ac.size[sym]);
    out.bits((uint32_t)a2, nb);
    run = 0;
  }
  if (run) out.bits(ac.code[0], ac.size[0]);
}

}  // namespace

extern "C" {

// Encode uint8 samples [height][width][comps] (comps 1: "L", 3: "RGB") as
// Pillow's save writes them; `comment` (len bytes, may be null) becomes a
// COM segment. Returns 0 and a malloc'd file in *out, or -1 for bad
// arguments, -3 when out of memory.
int gt_jpeg_encode(const uint8_t* samples, int width, int height, int comps, const uint8_t* comment,
                   int comment_len, uint8_t** out, uint64_t* out_len) {
  if (!samples || width < 1 || height < 1 || width > 65535 || height > 65535 || (comps != 1 && comps != 3) ||
      comment_len < 0 || comment_len > 65533 || (comment_len && !comment))
    return -1;
  try {
    const int hmax = comps == 3 ? 2 : 1;
    const int mcu_cols = (width + 8 * hmax - 1) / (8 * hmax), mcu_rows = (height + 8 * hmax - 1) / (8 * hmax);
    std::vector<Comp> cs;
    for (int ci = 0; ci < comps; ci++) {
      int f = ci == 0 ? hmax : 1, t = ci == 0 ? 0 : 1;
      Comp c{ci + 1, f, f, t, t, t, (width * f + 8 * hmax - 1) / (8 * hmax), (height * f + 8 * hmax - 1) / (8 * hmax)};
      cs.push_back(std::move(c));
    }
    // jcparam.c jpeg_add_quant_table at quality 75 with force_baseline.
    const int scale = kQuality < 50 ? 5000 / kQuality : 200 - kQuality * 2;
    uint16_t qt[2][64];
    for (int t = 0; t < 2; t++)
      for (int i = 0; i < 64; i++) {
        long v = ((long)kStdQuant[t][i] * scale + 50) / 100;
        qt[t][i] = (uint16_t)(v < 1 ? 1 : v > 255 ? 255 : v);
      }
    for (Comp& c : cs)
      for (int i = 0; i < 64; i++) c.div[i] = reciprocal((uint32_t)qt[c.tq][i] << 3);
    make_planes(samples, width, height, cs, mcu_rows);

    const CHuff dc[2] = {derive(kStdBits[0], kStdDcVals), derive(kStdBits[1], kStdDcVals)};
    const CHuff ac[2] = {derive(kStdBits[2], kStdAcLuma), derive(kStdBits[3], kStdAcChroma)};

    Out o;
    o.bytes.reserve((size_t)width * height * comps / 4 + 1024);
    o.marker(0xD8);
    static const uint8_t kJfif[16] = {0, 16, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
    o.marker(0xE0);
    o.bytes.insert(o.bytes.end(), kJfif, kJfif + 16);
    if (comment_len) {
      o.marker(0xFE);
      o.word(comment_len + 2);
      o.bytes.insert(o.bytes.end(), comment, comment + comment_len);
    }
    for (int t = 0; t < (comps == 3 ? 2 : 1); t++) {
      o.marker(0xDB);
      o.word(67);
      o.byte(t);
      for (int i = 0; i < 64; i++) o.byte(qt[t][kNatural[i]]);
    }
    o.marker(0xC0);
    o.word(8 + 3 * comps);
    o.byte(8);
    o.word(height);
    o.word(width);
    o.byte(comps);
    for (const Comp& c : cs) {
      o.byte(c.id);
      o.byte(c.h << 4 | c.v);
      o.byte(c.tq);
    }
    for (int t = 0; t < (comps == 3 ? 2 : 1); t++)
      for (const CHuff* h : {&dc[t], &ac[t]}) {
        o.marker(0xC4);
        o.word(2 + 1 + 16 + h->nvals);
        o.byte((h == &ac[t]) << 4 | t);
        for (int l = 1; l <= 16; l++) o.byte(h->bits[l]);
        for (int i = 0; i < h->nvals; i++) o.byte(h->vals[i]);
      }
    o.marker(0xDA);
    o.word(6 + 2 * comps);
    o.byte(comps);
    for (const Comp& c : cs) {
      o.byte(c.id);
      o.byte(c.td << 4 | c.ta);
    }
    o.byte(0);
    o.byte(63);
    o.byte(0);

    // jccoefct.c compress_data: MCU by MCU, the blocks of each component in
    // raster order within it; dummy blocks past the image's blocks.
    int16_t blocks[4][64];
    for (int my = 0; my < mcu_rows; my++)
      for (int mx = 0; mx < mcu_cols; mx++)
        for (Comp& c : cs) {
          int n = 0;
          for (int yi = 0; yi < c.v; yi++)
            for (int xi = 0; xi < c.h; xi++, n++) {
              int by = my * c.v + yi, bx = mx * c.h + xi;
              int16_t* b = blocks[n];
              if (by < c.hib && bx < c.wib) {
                quantize_block(c, by, bx, b);
              } else {  // a dummy: the DC of the block before it (a bottom row's: the row above's last)
                int16_t dcv = by < c.hib ? blocks[n - 1][0] : blocks[yi * c.h - 1][0];
                memset(b, 0, sizeof blocks[0]);
                b[0] = dcv;
              }
              encode_block(o, c, b, dc[c.td], ac[c.ta]);
            }
        }
    o.flush();
    o.marker(0xD9);
    uint8_t* buf = (uint8_t*)malloc(o.bytes.size());
    if (!buf) return -3;
    memcpy(buf, o.bytes.data(), o.bytes.size());
    *out = buf;
    *out_len = o.bytes.size();
    return 0;
  } catch (const std::bad_alloc&) {
    return -3;
  }
}

}  // extern "C"
