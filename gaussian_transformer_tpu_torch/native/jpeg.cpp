// jpeg.cpp: the native IO tier's own JPEG decoder, compiled into gt_native.
//
// It replaces libjpeg in the tier, so that a JPEG decodes wherever g++ is
// (the H100's machine has no jpeglib.h), and it decodes the same bits as
// libjpeg-turbo with the settings the JAX package's tier and Pillow use:
// out_color_space RGB, the islow integer IDCT, fancy upsampling, block
// smoothing on. Each stage follows the libjpeg-turbo source it names:
//   * markers (jdmarker.c): SOI, APPn (JFIF in APP0, Adobe in APP14), COM,
//     DQT (8- and 16-bit), DHT, DRI, SOF0/SOF1/SOF2, SOS, EOI, RSTn;
//   * Huffman decoding, sequential (jdhuff.c) and progressive (jdphuff.c:
//     DC first/refine, AC first/refine with EOB runs and correction bits),
//     into one coefficient buffer per component; restart markers reset the
//     DC predictors and the EOB run; data cut short reads as zero bits
//     and leaves every later block of the scan zero, as libjpeg does
//     ("Premature end of JPEG file" is a warning there, not an error);
//   * dequantisation and the islow IDCT (jidctint.c) with its range limit
//     and wrap mask (jdmaster.c prepare_range_limit_table);
//   * fancy upsampling (jdsample.c: h2v1 and h2v2 triangles with their
//     biases, plain replication for chroma 2 samples wide or less, edge rows
//     and columns repeated as jdmainct.c repeats them);
//   * YCbCr->RGB with 16-bit fixed-point tables (jdcolor.c); RGB where an
//     Adobe marker says transform 0 or the component ids spell "RGB";
//     grayscale replicated to three channels.
// What it does not decode returns a status of its own (see Status) and a
// message naming the feature: arithmetic coding, precision other than 8,
// lossless and hierarchical frames, 2 or 4 components, sampling factors
// other than luma h, v in {1, 2} over 1x1 chroma, and a progressive file
// whose AC scans stop early enough that libjpeg would smooth its blocks.
//
// Bounds: Huffman decoding is serial within a scan (one bit stream), so a
// file decodes on one thread; the thread pool in gt_native.cpp decodes
// files in parallel. The IDCT, the upsampling and the colour conversion
// are integer operations on every sample, bound by the host's operations,
// not by memory. No state outlives a call.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// jutils.c jpeg_natural_order, with its 16 guard entries for corrupt runs.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// Statuses: gt_load_images passes them on per image, and gt_image_error
// returns them with the message.
enum Status {
  kOk = 0,
  kUnreadable = -1,
  kCorrupt = -2,
  kArithmetic = -3,
  kPrecision = -4,
  kLossless = -5,
  kHierarchical = -6,
  kComponents = -7,
  kSampling = -8,
  kSmoothing = -9,
};

struct Failure {
  int status;
  std::string what;
};

[[noreturn]] void fail(int status, std::string what) { throw Failure{status, std::move(what)}; }

struct HuffSpec {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
};

// jdhuff.c jpeg_make_d_derived_tbl, with a 9-bit lookahead table:
// look[prefix] = (length << 8) | symbol for codes of 9 bits or fewer.
constexpr int kLook = 9;
struct Huff {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look[1 << kLook];
};

void derive(const HuffSpec& spec, bool dc, int index, Huff& t) {
  if (!spec.defined)
    fail(kCorrupt, std::string(dc ? "DC" : "AC") + " Huffman table " + std::to_string(index) + " is not defined");
  char size[257];
  int32_t code_of[257];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    if (p + spec.bits[l] > 256) fail(kCorrupt, "bad Huffman table");
    for (int i = 0; i < spec.bits[l]; i++) size[p++] = (char)l;
  }
  size[p] = 0;
  int n = p;
  int32_t code = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code_of[p++] = code++;
    if (code >= (1 << si)) fail(kCorrupt, "bad Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (spec.bits[l]) {
      t.valoffset[l] = p - code_of[p];
      p += spec.bits[l];
      t.maxcode[l] = code_of[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.valoffset[17] = 0;
  t.maxcode[17] = 0xFFFFF;
  memcpy(t.vals, spec.vals, 256);
  memset(t.look, 0, sizeof t.look);
  p = 0;
  for (int l = 1; l <= kLook; l++) {
    for (int i = 0; i < spec.bits[l]; i++, p++) {
      int lo = code_of[p] << (kLook - l);
      for (int k = 0; k < (1 << (kLook - l)); k++) t.look[lo + k] = (uint16_t)((l << 8) | spec.vals[p]);
    }
  }
  if (dc)
    for (int i = 0; i < n; i++)
      if (spec.vals[i] > 15) fail(kCorrupt, "bad DC Huffman table");
}

// The entropy-coded data: jdhuff.c's bit buffer over the file's bytes.
// Stuffed FF 00 reads as FF; a marker (or the end of the file, which libjpeg
// reads as a fake EOI) ends the data, and from there the bits read as zeros.
// `short_data` is libjpeg's insufficient_data: a bit past the data was used.
struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int n = 0;           // valid bits at the bottom of buf
  int marker = 0;      // libjpeg's unread_marker
  bool short_data = false;

  int byte() { return p < end ? *p++ : -1; }

  void fill(int need) {  // jpeg_fill_bit_buffer
    if (marker == 0) {
      while (n < 57) {
        int c = byte();
        if (c < 0) { marker = 0xD9; break; }
        if (c == 0xFF) {
          do c = byte(); while (c == 0xFF);
          if (c < 0) { marker = 0xD9; break; }
          if (c != 0) { marker = c; break; }
          c = 0xFF;
        }
        buf = (buf << 8) | (uint64_t)c;
        n += 8;
      }
      if (marker == 0) return;
    }
    if (need > n) {
      short_data = true;
      buf <<= 57 - n;
      n = 57;
    }
  }

  int bits(int k) {  // CHECK_BIT_BUFFER + GET_BITS
    if (n < k) fill(k);
    n -= k;
    return (int)((buf >> n) & ((1u << k) - 1));
  }

  int bit() { return bits(1); }

  int huff(const Huff& t) {  // HUFF_DECODE
    int l;
    if (n < kLook) {
      fill(0);
      if (n < kLook) { l = 1; goto slow; }
    }
    {
      int e = t.look[(buf >> (n - kLook)) & ((1 << kLook) - 1)];
      if (e) {
        n -= e >> 8;
        return e & 0xFF;
      }
      l = kLook + 1;
    }
  slow:  // jpeg_huff_decode
    int32_t code = bits(l);
    while (l <= 16 && code > t.maxcode[l]) {
      code = (code << 1) | bit();
      l++;
    }
    if (l > 16) return 0;  // libjpeg warns and fakes a zero
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }

  // jdmarker.c next_marker: skip to the next FF xx (xx not 00, not FF).
  void next_marker() {
    for (;;) {
      int c = byte();
      while (c >= 0 && c != 0xFF) c = byte();
      do c = byte(); while (c == 0xFF);
      if (c < 0) { marker = 0xD9; return; }
      if (c != 0) { marker = c; return; }
    }
  }
};

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r + (int)((~0u << s) + 1) : r; }

struct Component {
  int id, h, v, tq;
  int wib, hib;        // width_in_blocks, height_in_blocks
  int bw, bh;          // the coefficient buffer's blocks (MCU-padded)
  int dw, dh;          // downsampled_width, downsampled_height
  int dc_tbl = 0, ac_tbl = 0;
  bool latched = false;
  int16_t q[64];       // the quantisation table latched at the first scan
  int coef_bits[64];   // progressive: the last Al of each coefficient, -1 before any scan
  std::vector<int16_t> coef;
  int16_t* block(int by, int bx) { return coef.data() + ((size_t)by * bw + bx) * 64; }
};

struct Decoder {
  const uint8_t* data;
  size_t size;
  Reader in;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {};
  HuffSpec dc_spec[4], ac_spec[4];
  int restart_interval = 0;
  bool have_sof = false, progressive = false;
  int width = 0, height = 0, hmax = 1, vmax = 1;
  std::vector<Component> comps;

  Decoder(const uint8_t* d, size_t n) : data(d), size(n) { in.p = d; in.end = d + n; }

  int u8() {
    int c = in.byte();
    if (c < 0) fail(kCorrupt, "the file ends inside a marker segment");
    return c;
  }
  int u16() { int a = u8(); return (a << 8) | u8(); }

  void skip(int n) {
    if ((size_t)(in.end - in.p) < (size_t)n) fail(kCorrupt, "the file ends inside a marker segment");
    in.p += n;
  }

  // The next marker's code: the first must be SOI.
  int read_marker() {
    if (in.marker == 0) in.next_marker();
    int m = in.marker;
    in.marker = 0;
    return m;
  }

  void sof(int m) {
    if (have_sof) fail(kCorrupt, "two SOF markers");
    int len = u16();
    int precision = u8();
    height = u16();
    width = u16();
    int nc = u8();
    if (len != 8 + 3 * nc) fail(kCorrupt, "bad SOF length");
    comps.resize(nc);
    for (auto& c : comps) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
    }
    have_sof = true;
    if (m == 0xC3 || m == 0xCB) fail(kLossless, "lossless JPEG (SOF" + std::to_string(m - 0xC0) + ")");
    if ((m >= 0xC5 && m <= 0xC7) || (m >= 0xCD && m <= 0xCF))
      fail(kHierarchical, "hierarchical JPEG (SOF" + std::to_string(m - 0xC0) + ")");
    if (m >= 0xC9) fail(kArithmetic, "arithmetic coding (SOF" + std::to_string(m - 0xC0) + ")");
    if (precision != 8) fail(kPrecision, std::to_string(precision) + "-bit samples");
    if (width <= 0 || height <= 0) fail(kCorrupt, "an image of size 0 (or a DNL height)");
    progressive = m == 0xC2;
    if (nc != 1 && nc != 3)
      fail(kComponents, std::to_string(nc) + " components" + (nc == 4 ? " (CMYK/YCCK)" : ""));
    std::string factors;
    for (auto& c : comps) {
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail(kCorrupt, "bad sampling factors");
      factors += (factors.empty() ? "" : ",") + std::to_string(c.h) + "x" + std::to_string(c.v);
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    if (nc == 3) {
      const Component& y = comps[0];
      bool ok = y.h == hmax && y.v == vmax;
      for (int i = 1; i < 3; i++) {
        int rh = hmax / comps[i].h, rv = vmax / comps[i].v;
        ok = ok && hmax % comps[i].h == 0 && vmax % comps[i].v == 0 && rh <= 2 && rv <= 2 && rh >= rv &&
             comps[i].h == comps[1].h && comps[i].v == comps[1].v;
      }
      if (!ok) fail(kSampling, "sampling factors " + factors + " (the decoder takes luma h, v in {1, 2} "
                                                          "over 1x1 chroma: 4:4:4, 4:2:2, 4:2:0)");
    }
    for (auto& c : comps) {
      c.wib = (int)(((long)width * c.h + 8L * hmax - 1) / (8L * hmax));
      c.hib = (int)(((long)height * c.v + 8L * vmax - 1) / (8L * vmax));
      c.dw = (int)(((long)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((long)height * c.v + vmax - 1) / vmax);
      c.bw = (c.wib + c.h - 1) / c.h * c.h;
      c.bh = (c.hib + c.v - 1) / c.v * c.v;
      for (int& b : c.coef_bits) b = -1;
    }
  }

  void dqt() {
    int len = u16() - 2;
    while (len > 0) {
      int pq = u8();
      int prec = pq >> 4, t = pq & 15;
      if (t > 3) fail(kCorrupt, "bad DQT table index");
      if (len < 1 + 64 * (prec ? 2 : 1)) fail(kCorrupt, "a short DQT table");
      for (int i = 0; i < 64; i++) qt[t][kNatural[i]] = (uint16_t)(prec ? u16() : u8());
      qt_defined[t] = true;
      len -= 1 + 64 * (prec ? 2 : 1);
    }
    if (len != 0) fail(kCorrupt, "bad DQT length");
  }

  void dht() {
    int len = u16() - 2;
    while (len > 16) {
      int index = u8();
      HuffSpec s;
      int count = 0;
      for (int i = 1; i <= 16; i++) count += s.bits[i] = (uint8_t)u8();
      len -= 17;
      if (count > 256 || count > len) fail(kCorrupt, "bad Huffman table");
      for (int i = 0; i < count; i++) s.vals[i] = (uint8_t)u8();
      len -= count;
      s.defined = true;
      if ((index & 0xEF) > 3) fail(kCorrupt, "bad DHT table index");
      ((index & 0x10) ? ac_spec : dc_spec)[index & 3] = s;
    }
    if (len != 0) fail(kCorrupt, "bad DHT length");
  }

  void app(int m) {
    int len = u16() - 2;
    if (len < 0) fail(kCorrupt, "bad marker length");
    const uint8_t* d = in.p;
    skip(len);
    if (m == 0xE0 && len >= 14 && memcmp(d, "JFIF\0", 5) == 0) saw_jfif = true;
    if (m == 0xEE && len >= 12 && memcmp(d, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = d[11];
    }
  }

  // One scan: SOS's header, then its entropy-coded data.
  void sos() {
    if (!have_sof) fail(kCorrupt, "SOS before SOF");
    int len = u16();
    int ns = u8();
    if (len != 6 + 2 * ns || ns < 1 || ns > 4) fail(kCorrupt, "bad SOS length");
    std::vector<Component*> sc(ns);
    bool taken[4] = {};
    for (int i = 0; i < ns; i++) {
      int cid = u8(), tbl = u8();
      int ci = 0;
      while (ci < (int)comps.size() && !(comps[ci].id == cid && !taken[ci])) ci++;
      if (ci == (int)comps.size()) fail(kCorrupt, "SOS names an unknown component");
      taken[ci] = true;
      sc[i] = &comps[ci];
      sc[i]->dc_tbl = tbl >> 4;
      sc[i]->ac_tbl = tbl & 15;
      if (sc[i]->dc_tbl > 3 || sc[i]->ac_tbl > 3) fail(kCorrupt, "bad Huffman table index");
    }
    int ss = u8(), se = u8(), a = u8();
    int ah = a >> 4, al = a & 15;
    for (Component* c : sc) {  // jdinput.c latch_quant_tables
      if (c->latched) continue;
      if (!qt_defined[c->tq]) fail(kCorrupt, "quantisation table " + std::to_string(c->tq) + " is not defined");
      for (int k = 0; k < 64; k++) c->q[k] = (int16_t)qt[c->tq][k];
      c->latched = true;
      c->coef.assign((size_t)c->bw * c->bh * 64, 0);
    }
    in.buf = 0;
    in.n = 0;
    in.short_data = false;
    if (progressive)
      progressive_scan(sc, ss, se, ah, al);
    else
      sequential_scan(sc);
  }

  // The scan's MCUs: for an interleaved scan, h x v blocks of each component
  // per MCU over the MCU grid; for one component, its own block grid.
  struct McuBlock {
    int comp, dy, dx;  // the scan's component, and the block's place in its part of the MCU
  };
  struct Layout {
    int mcus_x, mcus_y;
    std::vector<McuBlock> blocks;
  };

  Layout layout(const std::vector<Component*>& sc) {
    Layout lo;
    if (sc.size() == 1) {
      lo.mcus_x = sc[0]->wib;
      lo.mcus_y = sc[0]->hib;
      lo.blocks.push_back({0, 0, 0});
    } else {
      lo.mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
      lo.mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
      for (int i = 0; i < (int)sc.size(); i++)
        for (int y = 0; y < sc[i]->v; y++)
          for (int x = 0; x < sc[i]->h; x++) lo.blocks.push_back({i, y, x});
      if (lo.blocks.size() > 10) fail(kCorrupt, "more than 10 blocks in an MCU");
    }
    return lo;
  }

  int16_t* mcu_block(const std::vector<Component*>& sc, const Layout& lo, int b, int mx, int my) {
    const McuBlock& k = lo.blocks[b];
    Component* c = sc[k.comp];
    if (sc.size() == 1) return c->block(my, mx);
    return c->block(my * c->v + k.dy, mx * c->h + k.dx);
  }

  // jdhuff.c/jdphuff.c process_restart and jdmarker.c read_restart_marker.
  int next_restart = 0;
  void restart(int* last_dc, int ndc, int* eobrun) {
    in.n = 0;
    if (in.marker == 0) in.next_marker();
    if (in.marker == 0xD0 + next_restart) {
      in.marker = 0;
    } else {  // jdmarker.c jpeg_resync_to_restart
      for (;;) {
        int m = in.marker, action;
        if (m < 0xC0) action = 2;
        else if (m < 0xD0 || m > 0xD7) action = 3;
        else if (m == 0xD0 + ((next_restart + 1) & 7) || m == 0xD0 + ((next_restart + 2) & 7)) action = 3;
        else if (m == 0xD0 + ((next_restart - 1) & 7) || m == 0xD0 + ((next_restart - 2) & 7)) action = 2;
        else action = 1;
        if (action == 1) { in.marker = 0; break; }
        if (action == 3) break;
        in.next_marker();
      }
    }
    next_restart = (next_restart + 1) & 7;
    for (int i = 0; i < ndc; i++) last_dc[i] = 0;
    if (eobrun) *eobrun = 0;
    if (in.marker == 0) in.short_data = false;
  }

  void sequential_scan(const std::vector<Component*>& sc) {
    Huff dct[4], act[4];
    for (size_t i = 0; i < sc.size(); i++) {
      derive(dc_spec[sc[i]->dc_tbl], true, sc[i]->dc_tbl, dct[i]);
      derive(ac_spec[sc[i]->ac_tbl], false, sc[i]->ac_tbl, act[i]);
    }
    Layout lo = layout(sc);
    int last_dc[4] = {};
    int togo = restart_interval;
    next_restart = 0;
    for (int my = 0; my < lo.mcus_y; my++) {
      for (int mx = 0; mx < lo.mcus_x; mx++) {
        if (restart_interval && togo == 0) {
          restart(last_dc, 4, nullptr);
          togo = restart_interval;
        }
        if (!in.short_data) {
          for (size_t b = 0; b < lo.blocks.size(); b++) {
            int ci = lo.blocks[b].comp;
            int16_t* blk = mcu_block(sc, lo, (int)b, mx, my);
            int s = in.huff(dct[ci]);
            if (s) s = extend(in.bits(s), s);
            last_dc[ci] += s;
            blk[0] = (int16_t)last_dc[ci];
            const Huff& at = act[ci];
            for (int k = 1; k < 64; k++) {
              int rs = in.huff(at);
              int r = rs >> 4;
              s = rs & 15;
              if (s) {
                k += r;
                blk[kNatural[k]] = (int16_t)extend(in.bits(s), s);
              } else {
                if (r != 15) break;
                k += 15;
              }
            }
          }
        }
        if (restart_interval) togo--;
      }
    }
  }

  void progressive_scan(const std::vector<Component*>& sc, int ss, int se, int ah, int al) {
    bool dc = ss == 0;
    bool bad = dc ? se != 0 : (ss > se || se > 63 || sc.size() != 1);
    if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
    if (bad) fail(kCorrupt, "bad progressive scan parameters");
    for (Component* c : sc)
      for (int k = ss; k <= se; k++) c->coef_bits[k] = al;
    Huff tbl[4];
    for (size_t i = 0; i < sc.size(); i++) {
      if (dc && ah == 0) derive(dc_spec[sc[i]->dc_tbl], true, sc[i]->dc_tbl, tbl[i]);
      if (!dc) derive(ac_spec[sc[i]->ac_tbl], false, sc[i]->ac_tbl, tbl[i]);
    }
    Layout lo = layout(sc);
    int last_dc[4] = {};
    int eobrun = 0;
    int togo = restart_interval;
    next_restart = 0;
    const int p1 = 1 << al, m1 = (int)(~0u << al);
    for (int my = 0; my < lo.mcus_y; my++) {
      for (int mx = 0; mx < lo.mcus_x; mx++) {
        if (restart_interval && togo == 0) {
          restart(last_dc, 4, &eobrun);
          togo = restart_interval;
        }
        if (dc && ah == 0) {  // decode_mcu_DC_first
          if (!in.short_data) {
            for (size_t b = 0; b < lo.blocks.size(); b++) {
              int ci = lo.blocks[b].comp;
              int s = in.huff(tbl[ci]);
              if (s) s = extend(in.bits(s), s);
              last_dc[ci] += s;
              mcu_block(sc, lo, (int)b, mx, my)[0] = (int16_t)(int)((unsigned)last_dc[ci] << al);
            }
          }
        } else if (dc) {  // decode_mcu_DC_refine (zero bits change nothing)
          for (size_t b = 0; b < lo.blocks.size(); b++)
            if (in.bit()) mcu_block(sc, lo, (int)b, mx, my)[0] |= (int16_t)p1;
        } else if (ah == 0) {  // decode_mcu_AC_first
          if (!in.short_data) {
            if (eobrun > 0) {
              eobrun--;
            } else {
              int16_t* blk = mcu_block(sc, lo, 0, mx, my);
              for (int k = ss; k <= se; k++) {
                int rs = in.huff(tbl[0]);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                  k += r;
                  blk[kNatural[k]] = (int16_t)(int)((unsigned)extend(in.bits(s), s) << al);
                } else if (r == 15) {
                  k += 15;
                } else {
                  eobrun = 1 << r;
                  if (r) eobrun += in.bits(r);
                  eobrun--;
                  break;
                }
              }
            }
          }
        } else if (!in.short_data) {  // decode_mcu_AC_refine
          ac_refine(mcu_block(sc, lo, 0, mx, my), tbl[0], ss, se, p1, m1, eobrun);
        }
        if (restart_interval) togo--;
      }
    }
  }

  void ac_refine(int16_t* blk, const Huff& t, int ss, int se, int p1, int m1, int& eobrun) {
    auto correct = [&](int16_t& c) {
      if (in.bit() && (c & p1) == 0) c = (int16_t)(c + (c >= 0 ? p1 : m1));
    };
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = in.huff(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = in.bit() ? p1 : m1;  // the size of a new coefficient is always 1
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += in.bits(r);
          break;
        }
        do {
          int16_t& c = blk[kNatural[k]];
          if (c != 0) {
            correct(c);
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t& c = blk[kNatural[k]];
        if (c != 0) correct(c);
      }
      eobrun--;
    }
  }

  void parse() {
    if (size < 2 || data[0] != 0xFF || data[1] != 0xD8) fail(kCorrupt, "not a JPEG file (no SOI)");
    in.p = data + 2;
    for (;;) {
      int m = read_marker();
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        sof(m);
      } else if (m == 0xC4) {
        dht();
      } else if (m == 0xCC) {
        fail(kArithmetic, "arithmetic coding (DAC)");
      } else if (m == 0xDB) {
        dqt();
      } else if (m == 0xDD) {
        if (u16() != 4) fail(kCorrupt, "bad DRI length");
        restart_interval = u16();
      } else if (m == 0xDA) {
        sos();
      } else if (m == 0xD9) {
        break;
      } else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
        app(m);
      } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
        // RSTn outside a scan and TEM carry no parameters.
      } else {
        fail(kCorrupt, "unknown marker 0x" + std::to_string(m));
      }
    }
    if (!have_sof) fail(kCorrupt, "no SOF marker");
    for (auto& c : comps)
      if (!c.latched) fail(kCorrupt, "a component appears in no scan");
    if (progressive) check_smoothing();
  }

  // jdcoefct.c smoothing_ok: libjpeg-turbo smooths a progressive image whose
  // first 10 coefficients (zigzag 0-9) are not all final, once every DC is
  // known in part. The decoder does not smooth, so it refuses such a file
  // (in practice one cut short before its last AC scans began).
  void check_smoothing() {
    static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (auto& c : comps) {
      for (int p : kPos)
        if (c.q[p] == 0) return;
      if (c.coef_bits[0] < 0) return;
      for (int k = 1; k < 10; k++) useful = useful || c.coef_bits[k] != 0;
    }
    if (useful)
      fail(kSmoothing, "a progressive JPEG whose scans stop before its AC coefficients are final "
                       "(libjpeg's block smoothing is not implemented)");
  }

  // ------------------------------------------------------------ output ----

  static void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride, const uint8_t* limit);
  void output(uint8_t* rgb);
};

// jidctint.c jpeg_idct_islow, in the same integer steps.
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373, F1175 = 9633,
                  F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

void Decoder::idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride, const uint8_t* limit) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* col = in + c;
    const int16_t* qc = q + c;
    int* w = ws + c;
    if (col[8] == 0 && col[16] == 0 && col[24] == 0 && col[32] == 0 && col[40] == 0 && col[48] == 0 &&
        col[56] == 0) {
      int dcval = (int)((unsigned)(col[0] * qc[0]) << kPass1Bits);
      for (int r = 0; r < 8; r++) w[8 * r] = dcval;
      continue;
    }
    int64_t z2 = col[16] * qc[16], z3 = col[48] * qc[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    z2 = col[0] * qc[0];
    z3 = col[32] * qc[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = col[56] * qc[56];
    tmp1 = col[40] * qc[40];
    tmp2 = col[24] * qc[24];
    tmp3 = col[8] * qc[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    w[0] = (int)descale(tmp10 + tmp3, sh);
    w[56] = (int)descale(tmp10 - tmp3, sh);
    w[8] = (int)descale(tmp11 + tmp2, sh);
    w[48] = (int)descale(tmp11 - tmp2, sh);
    w[16] = (int)descale(tmp12 + tmp1, sh);
    w[40] = (int)descale(tmp12 - tmp1, sh);
    w[24] = (int)descale(tmp13 + tmp0, sh);
    w[32] = (int)descale(tmp13 - tmp0, sh);
  }
  for (int r = 0; r < 8; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + (size_t)r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 && w[7] == 0) {
      uint8_t dc = limit[(int)descale(w[0], kPass1Bits + 3) & 1023];
      memset(o, dc, 8);
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << kConstBits);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits + kPass1Bits + 3;
    o[0] = limit[(int)descale(tmp10 + tmp3, sh) & 1023];
    o[7] = limit[(int)descale(tmp10 - tmp3, sh) & 1023];
    o[1] = limit[(int)descale(tmp11 + tmp2, sh) & 1023];
    o[6] = limit[(int)descale(tmp11 - tmp2, sh) & 1023];
    o[2] = limit[(int)descale(tmp12 + tmp1, sh) & 1023];
    o[5] = limit[(int)descale(tmp12 - tmp1, sh) & 1023];
    o[3] = limit[(int)descale(tmp13 + tmp0, sh) & 1023];
    o[4] = limit[(int)descale(tmp13 - tmp0, sh) & 1023];
  }
}

// One output row of a chroma plane upsampled to full width (jdsample.c):
// `near` is the chroma row the output row lies in, `far` the row above or
// below it (h2v2), or null (h2v1).
void upsample_row(const uint8_t* near, const uint8_t* far, int dw, int out_w, uint8_t* out) {
  if (dw <= 2) {  // h2v1_upsample / h2v2_upsample: replication
    for (int x = 0; x < out_w; x++) out[x] = near[x >> 1];
    return;
  }
  if (!far) {  // h2v1_fancy_upsample
    out[0] = near[0];
    out[1] = (uint8_t)((near[0] * 3 + near[1] + 2) >> 2);
    for (int x = 1; x < dw - 1; x++) {
      int v = near[x] * 3;
      out[2 * x] = (uint8_t)((v + near[x - 1] + 1) >> 2);
      out[2 * x + 1] = (uint8_t)((v + near[x + 1] + 2) >> 2);
    }
    out[2 * dw - 2] = (uint8_t)((near[dw - 1] * 3 + near[dw - 2] + 1) >> 2);
    out[2 * dw - 1] = near[dw - 1];
    return;
  }
  // h2v2_fancy_upsample: column sums 3 * near + far, then the same triangle.
  int last = near[0] * 3 + far[0];
  int cur = last;
  for (int x = 0; x < dw; x++) {
    int next = x + 1 < dw ? near[x + 1] * 3 + far[x + 1] : cur;
    out[2 * x] = (uint8_t)((cur * 3 + last + 8) >> 4);
    out[2 * x + 1] = (uint8_t)((cur * 3 + next + 7) >> 4);
    last = cur;
    cur = next;
  }
}

void Decoder::output(uint8_t* rgb) {
  // jdmaster.c prepare_range_limit_table, as the IDCT indexes it (x & 1023).
  uint8_t limit[1024];
  for (int i = 0; i < 1024; i++) limit[i] = (uint8_t)(i < 128 ? i + 128 : i < 512 ? 255 : i < 896 ? 0 : i - 896);
  std::vector<std::vector<uint8_t>> planes(comps.size());
  std::vector<int> strides(comps.size());
  for (size_t ci = 0; ci < comps.size(); ci++) {
    Component& c = comps[ci];
    int stride = strides[ci] = c.wib * 8;
    planes[ci].resize((size_t)stride * c.hib * 8);
    for (int by = 0; by < c.hib; by++)
      for (int bx = 0; bx < c.wib; bx++)
        idct_islow(c.block(by, bx), c.q, planes[ci].data() + (size_t)by * 8 * stride + bx * 8, stride, limit);
  }
  if (comps.size() == 1) {  // gray_rgb_convert
    for (int y = 0; y < height; y++) {
      const uint8_t* g = planes[0].data() + (size_t)y * strides[0];
      uint8_t* o = rgb + (size_t)y * width * 3;
      for (int x = 0; x < width; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
    }
    return;
  }
  // jdcolor.c build_ycc_rgb_table (SCALEBITS 16).
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  const int64_t half = 1 << 15;
  auto fix = [](double v) { return (int64_t)(v * 65536 + 0.5); };
  for (int i = 0; i < 256; i++) {
    int64_t x = i - 128;
    cr_r[i] = (int)((fix(1.40200) * x + half) >> 16);
    cb_b[i] = (int)((fix(1.77200) * x + half) >> 16);
    cr_g[i] = (int32_t)(-fix(0.71414) * x);
    cb_g[i] = (int32_t)(-fix(0.34414) * x + half);
  }
  // jdapimin.c default_decompress_parms: JFIF, else Adobe's transform, else
  // component ids "RGB", say RGB; anything else is YCbCr.
  bool rgb_ids = comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
  bool ycc = saw_jfif || (saw_adobe ? adobe_transform != 0 : !rgb_ids);
  int rh = hmax / comps[1].h, rv = vmax / comps[1].v;
  std::vector<uint8_t> up1(width + 2), up2(width + 2);
  for (int y = 0; y < height; y++) {
    const uint8_t* Y = planes[0].data() + (size_t)y * strides[0];
    const uint8_t* ch[2];
    for (int k = 0; k < 2; k++) {
      const Component& c = comps[1 + k];
      uint8_t* up = k ? up2.data() : up1.data();
      const uint8_t* base = planes[1 + k].data();
      int stride = strides[1 + k];
      if (rh == 1) {
        ch[k] = base + (size_t)y * stride;
        continue;
      }
      int cy = rv == 2 ? y >> 1 : y;
      const uint8_t* near = base + (size_t)cy * stride;
      const uint8_t* far = nullptr;
      if (rv == 2 && c.dw > 2) {
        int fy = (y & 1) ? cy + 1 : cy - 1;
        fy = fy < 0 ? 0 : fy > c.dh - 1 ? c.dh - 1 : fy;
        far = base + (size_t)fy * stride;
      }
      upsample_row(near, far, c.dw, width, up);
      ch[k] = up;
    }
    uint8_t* o = rgb + (size_t)y * width * 3;
    if (!ycc) {  // rgb_rgb_convert
      for (int x = 0; x < width; x++) {
        o[3 * x] = Y[x];
        o[3 * x + 1] = ch[0][x];
        o[3 * x + 2] = ch[1][x];
      }
      continue;
    }
    for (int x = 0; x < width; x++) {  // ycc_rgb_convert
      int yy = Y[x], cb = ch[0][x], cr = ch[1][x];
      int r = yy + cr_r[cr];
      int g = yy + ((cb_g[cb] + cr_g[cr]) >> 16);
      int b = yy + cb_b[cb];
      o[3 * x] = (uint8_t)(r < 0 ? 0 : r > 255 ? 255 : r);
      o[3 * x + 1] = (uint8_t)(g < 0 ? 0 : g > 255 ? 255 : g);
      o[3 * x + 2] = (uint8_t)(b < 0 ? 0 : b > 255 ? 255 : b);
    }
  }
}

}  // namespace

// Decode a JPEG held in memory to RGB8 (malloc'd, width x height x 3).
// Returns null and sets *status (a Status) and `why` when it cannot.
uint8_t* gt_jpeg_decode(const uint8_t* data, size_t size, int* w, int* h, int* status, std::string* why) {
  try {
    Decoder d(data, size);
    d.parse();
    uint8_t* out = (uint8_t*)malloc((size_t)d.width * d.height * 3);
    if (!out) fail(kUnreadable, "out of memory");
    d.output(out);
    *w = d.width;
    *h = d.height;
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

// The frame's size from the first SOFn (any of them), reading markers up to
// it. 0 when found, -2 when the data ends before one or is no JPEG.
int gt_jpeg_size(const uint8_t* data, size_t size, int* w, int* h) {
  if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) return -2;
  size_t p = 2;
  while (p + 4 <= size) {
    if (data[p] != 0xFF) { p++; continue; }
    int m = data[p + 1];
    if (m == 0xFF) { p++; continue; }
    if (m == 0x00 || m == 0x01 || (m >= 0xD0 && m <= 0xD8)) { p += 2; continue; }
    size_t len = ((size_t)data[p + 2] << 8) | data[p + 3];
    if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      if (p + 9 > size) return -2;
      *h = (data[p + 5] << 8) | data[p + 6];
      *w = (data[p + 7] << 8) | data[p + 8];
      return 0;
    }
    if (m == 0xD9 || m == 0xDA) return -2;
    p += 2 + len;
  }
  return -2;
}
