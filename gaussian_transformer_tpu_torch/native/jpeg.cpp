// jpeg.cpp: the native IO tier's own JPEG decoder, compiled into gt_native.
//
// It replaces libjpeg in the tier, so that a JPEG decodes wherever g++ is
// (the H100's machine has no jpeglib.h), and it decodes the same bits as
// libjpeg-turbo 2.1.5 with the settings the JAX package's tier and Pillow
// use: out_color_space RGB, the islow integer IDCT, fancy upsampling, block
// smoothing on. Each stage follows the libjpeg-turbo source it names:
//   * markers (jdmarker.c): SOI, APPn (JFIF in APP0, Adobe in APP14), COM,
//     DQT (8- and 16-bit), DHT, DAC, DRI, SOF0/1/2 and SOF9/10, SOS, EOI,
//     RSTn;
//   * Huffman decoding, sequential (jdhuff.c) and progressive (jdphuff.c:
//     DC first/refine, AC first/refine with EOB runs and correction bits),
//     into one coefficient buffer per component; restart markers reset the
//     DC predictors and the EOB run; data cut short reads as zero bits
//     and leaves every later block of the scan zero, as libjpeg does
//     ("Premature end of JPEG file" is a warning there, not an error); a
//     Huffman slot that a sequential scan uses and no DHT defined takes
//     Annex K's table (jstdhuff.c, as jdhuff.c applies it: slots 0 and 1;
//     jdphuff.c does not, so a progressive file still needs its DHTs);
//   * arithmetic decoding (jdarith.c, jaricom.c), sequential and
//     progressive, with DAC conditioning and restarts;
//   * block smoothing of a progressive file whose scans stop before its
//     low AC coefficients are final (jdcoefct.c smoothing_ok and
//     decompress_smooth_data, libjpeg-turbo 2.1's 5x5 form with DC
//     interpolation, each iMCU row with the bits of the scan that last
//     reached it; libjpeg-turbo 3.1 smooths a cut 4:2:0 file a level or a
//     few apart from 2.1.5, and this follows 2.1.5, the JAX tier's);
//   * dequantisation and the islow IDCT (jidctint.c), in the arithmetic of
//     libjpeg-turbo's x86-64 SIMD version, which the references run (it
//     differs from jidctint.c's range limit on the extreme coefficients of
//     a corrupt block);
//   * upsampling (jdsample.c, as jinit_upsampler picks it with fancy
//     upsampling on): h2v1 and h2v2 triangles with their biases for
//     components over 2 samples wide, h1v2_fancy_upsample, and replication
//     (int_upsample) for every other integral ratio, h, v in 1..4 per
//     component and at most 10 blocks in an MCU; edge rows and columns
//     repeated as jdmainct.c repeats them;
//   * YCbCr->RGB with 16-bit fixed-point tables (jdcolor.c); RGB where an
//     Adobe marker says transform 0 or the component ids spell "RGB";
//     grayscale replicated to three channels.
// What libjpeg-turbo 2.1.5 refuses it refuses too, with a status of its own
// (see Status) and a message naming the feature: precision other than 8,
// lossless and hierarchical frames, 2 or 4 components, and sampling whose
// ratio to the largest factor is fractional. (Pillow's libjpeg-turbo 3
// decodes 8-bit lossless files; the tier follows the JAX tier's 2.1.5.)
//
// Bounds: entropy decoding is serial within a scan (one bit stream), so a
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

#include "jpeg_tables.h"

namespace {

using namespace gt_jpeg;

// Statuses: gt_load_images passes them on per image, and gt_image_error
// returns them with the message.
enum Status {
  kOk = 0,
  kUnreadable = -1,
  kCorrupt = -2,
  kPrecision = -4,
  kLossless = -5,
  kHierarchical = -6,
  kComponents = -7,
  kSampling = -8,
  kTruncated = -9,  // the samples decode only: Pillow's open refuses a file cut before EOI
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

HuffSpec standard_table(bool dc, int index) {
  HuffSpec s;
  s.defined = true;
  memcpy(s.bits, kStdBits[(dc ? 0 : 2) + index], 17);
  if (dc)
    memcpy(s.vals, kStdDcVals, 12);
  else
    memcpy(s.vals, index ? kStdAcChroma : kStdAcLuma, 162);
  return s;
}

// `standard`: a sequential scan, whose decoder (jdhuff.c jinit_huff_decoder)
// installs Annex K's tables in slots 0 and 1 that no DHT defined; the
// progressive decoder (jdphuff.c) does not.
void derive(HuffSpec& spec, bool dc, int index, Huff& t, bool standard) {
  if (index > 3) fail(kCorrupt, "Huffman table index " + std::to_string(index));
  if (!spec.defined && standard && index < 2) spec = standard_table(dc, index);
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

  // Past the end of the file, libjpeg's source manager supplies a fake EOI
  // at each refill: the bytes read FF D9 FF D9 ... (a marker segment cut
  // short reads them as its data, as libjpeg reads them).
  size_t fake = 0;
  int byte() { return p < end ? *p++ : (fake++ % 2 ? 0xD9 : 0xFF); }

  void fill(int need) {  // jpeg_fill_bit_buffer
    if (marker == 0) {
      while (n < 57) {
        int c = byte();
        if (c == 0xFF) {
          do c = byte(); while (c == 0xFF);
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
      while (c != 0xFF) c = byte();
      do c = byte(); while (c == 0xFF);
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
  int prev_bits[10];   // coef_bits[0..9] before the component's last scan (libjpeg-turbo 2.1)
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
  uint8_t arith_dc_L[16], arith_dc_U[16], arith_ac_K[16];  // DAC conditioning (jdmarker.c defaults)
  int restart_interval = 0;
  bool have_sof = false, progressive = false, arith = false;
  int width = 0, height = 0, hmax = 1, vmax = 1;
  int scans = 0;             // cinfo->input_scan_number
  int imcu_rows = 0;         // cinfo->total_iMCU_rows
  int last_good_imcu = 0;    // master->last_good_iMCU_row: the last iMCU row a scan read whole
  std::vector<Component> comps;

  Decoder(const uint8_t* d, size_t n) : data(d), size(n) {
    in.p = d;
    in.end = d + n;
    memset(arith_dc_L, 0, sizeof arith_dc_L);
    memset(arith_dc_U, 1, sizeof arith_dc_U);
    memset(arith_ac_K, 5, sizeof arith_ac_K);
  }

  int u8() { return in.byte(); }
  int u16() { int a = u8(); return (a << 8) | u8(); }

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
    if (precision != 8) fail(kPrecision, std::to_string(precision) + "-bit samples");
    if (width <= 0 || height <= 0) fail(kCorrupt, "an image of size 0 (or a DNL height)");
    progressive = m == 0xC2 || m == 0xCA;
    arith = m >= 0xC9;
    if (nc != 1 && nc != 3)
      fail(kComponents, std::to_string(nc) + " components" + (nc == 4 ? " (CMYK/YCCK)" : ""));
    std::string factors;
    for (auto& c : comps) {
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail(kCorrupt, "bad sampling factors");
      factors += (factors.empty() ? "" : ",") + std::to_string(c.h) + "x" + std::to_string(c.v);
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    for (auto& c : comps)  // jdsample.c jinit_upsampler: JERR_FRACT_SAMPLE_NOTIMPL
      if (hmax % c.h || vmax % c.v)
        fail(kSampling, "sampling factors " + factors + " (a fractional upsampling ratio, which libjpeg refuses)");
    imcu_rows = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      c.wib = (int)(((long)width * c.h + 8L * hmax - 1) / (8L * hmax));
      c.hib = (int)(((long)height * c.v + 8L * vmax - 1) / (8L * vmax));
      c.dw = (int)(((long)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((long)height * c.v + vmax - 1) / vmax);
      c.bw = (c.wib + c.h - 1) / c.h * c.h;
      c.bh = (c.hib + c.v - 1) / c.v * c.v;
      for (int& b : c.coef_bits) b = -1;
      for (int& b : c.prev_bits) b = -1;
    }
  }

  void dac() {  // jdmarker.c get_dac
    int len = u16() - 2;
    while (len > 0) {
      int index = u8(), val = u8();
      len -= 2;
      if (index >= 32) fail(kCorrupt, "bad DAC table index");
      if (index >= 16) {
        arith_ac_K[index - 16] = (uint8_t)val;
      } else {
        arith_dc_L[index] = (uint8_t)(val & 15);
        arith_dc_U[index] = (uint8_t)(val >> 4);
        if (arith_dc_L[index] > arith_dc_U[index]) fail(kCorrupt, "bad DAC value");
      }
    }
    if (len != 0) fail(kCorrupt, "bad DAC length");
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

  void app(int m) {  // jdmarker.c get_interesting_appn / skip_variable
    int len = u16() - 2;
    uint8_t d[14];
    int n = len < 0 ? 0 : len < 14 ? len : 14;
    for (int i = 0; i < n; i++) d[i] = (uint8_t)u8();
    for (int i = n; i < len; i++) u8();
    if (m == 0xE0 && n >= 14 && memcmp(d, "JFIF\0", 5) == 0) saw_jfif = true;
    if (m == 0xEE && n >= 12 && memcmp(d, "Adobe", 5) == 0) {
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
    }
    int ss = u8(), se = u8(), a = u8();
    int ah = a >> 4, al = a & 15;
    scans++;
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
    if (progressive) {
      bool dc = ss == 0;
      bool bad = dc ? se != 0 : (ss > se || se > 63 || sc.size() != 1);
      if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
      if (bad) fail(kCorrupt, "bad progressive scan parameters");
      for (Component* c : sc) {  // jdphuff.c start_pass_phuff_decoder's coef_bits and prev_coef_bits
        for (int k = std::min(ss, 1); k <= std::max(se, 9); k++)
          if (k < 10) c->prev_bits[k] = scans > 1 ? c->coef_bits[k] : 0;
        for (int k = ss; k <= se; k++) c->coef_bits[k] = al;
      }
    }
    if (arith)
      arith_scan(sc, ss, se, ah, al);
    else if (progressive)
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

  // jdcoefct.c consume_data: as an iMCU row of a scan begins, it becomes
  // the last good row unless the scan's data has run out
  // (insufficient_data); the row in which the data ends counts as good. An
  // interleaved scan's MCU row is an iMCU row; a one-component scan's iMCU
  // row is v of its block rows.
  void mcu_row_start(const std::vector<Component*>& sc, int my) {
    int v = sc.size() > 1 ? 1 : sc[0]->v;
    if (my % v == 0 && !in.short_data) last_good_imcu = my / v;
  }

  // jdhuff.c/jdphuff.c process_restart and jdmarker.c read_restart_marker.
  int next_restart = 0;
  void restart(int* last_dc, int ndc, int* eobrun) {
    in.n = 0;
    read_restart_marker();
    for (int i = 0; i < ndc; i++) last_dc[i] = 0;
    if (eobrun) *eobrun = 0;
    if (in.marker == 0) in.short_data = false;
  }

  void read_restart_marker() {
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
  }

  void sequential_scan(const std::vector<Component*>& sc) {
    Huff dct[4], act[4];
    for (size_t i = 0; i < sc.size(); i++) {
      derive(dc_spec[sc[i]->dc_tbl], true, sc[i]->dc_tbl, dct[i], true);
      derive(ac_spec[sc[i]->ac_tbl], false, sc[i]->ac_tbl, act[i], true);
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
    Huff tbl[4];
    for (size_t i = 0; i < sc.size(); i++) {
      if (dc && ah == 0) derive(dc_spec[sc[i]->dc_tbl], true, sc[i]->dc_tbl, tbl[i], false);
      if (!dc) derive(ac_spec[sc[i]->ac_tbl], false, sc[i]->ac_tbl, tbl[i], false);
    }
    Layout lo = layout(sc);
    int last_dc[4] = {};
    int eobrun = 0;
    int togo = restart_interval;
    next_restart = 0;
    const int p1 = 1 << al, m1 = (int)(~0u << al);
    for (int my = 0; my < lo.mcus_y; my++) {
      mcu_row_start(sc, my);
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

  // ------------------------------------------------------ arithmetic ----

  // jdarith.c's decoder state: C and A registers, the bit counter (-16 at a
  // start, -1 after an error, which stops the scan's decoding), statistics
  // bins per table.
  int64_t ac_c = 0, ac_a = 0;
  int ac_ct = -16;
  uint8_t dc_stats[16][64], ac_stats[16][256], fixed_bin[4] = {113, 0, 0, 0};

  int arith_byte() {  // arith_decode's data fetch: a marker supplies zeros from there on
    if (in.marker) return 0;
    int data = in.byte();
    if (data == 0xFF) {
      do data = in.byte(); while (data == 0xFF);
      if (data == 0) return 0xFF;
      in.marker = data;
      return 0;
    }
    return data;
  }

  int arith_decode(uint8_t* st) {  // jdarith.c arith_decode, sections D.2.4-D.2.6
    // jaricom.c jpeg_aritab: Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS.
#define V(i, qe, nlps, nmps, sw) (((int64_t)(qe) << 16) | ((int64_t)(nmps) << 8) | ((int64_t)(sw) << 7) | (nlps))
    static const int64_t kAritab[114] = {
        V(0, 0x5a1d, 1, 1, 1),     V(1, 0x2586, 14, 2, 0),    V(2, 0x1114, 16, 3, 0),    V(3, 0x080b, 18, 4, 0),
        V(4, 0x03d8, 20, 5, 0),    V(5, 0x01da, 23, 6, 0),    V(6, 0x00e5, 25, 7, 0),    V(7, 0x006f, 28, 8, 0),
        V(8, 0x0036, 30, 9, 0),    V(9, 0x001a, 33, 10, 0),   V(10, 0x000d, 35, 11, 0),  V(11, 0x0006, 9, 12, 0),
        V(12, 0x0003, 10, 13, 0),  V(13, 0x0001, 12, 13, 0),  V(14, 0x5a7f, 15, 15, 1),  V(15, 0x3f25, 36, 16, 0),
        V(16, 0x2cf2, 38, 17, 0),  V(17, 0x207c, 39, 18, 0),  V(18, 0x17b9, 40, 19, 0),  V(19, 0x1182, 42, 20, 0),
        V(20, 0x0cef, 43, 21, 0),  V(21, 0x09a1, 45, 22, 0),  V(22, 0x072f, 46, 23, 0),  V(23, 0x055c, 48, 24, 0),
        V(24, 0x0406, 49, 25, 0),  V(25, 0x0303, 51, 26, 0),  V(26, 0x0240, 52, 27, 0),  V(27, 0x01b1, 54, 28, 0),
        V(28, 0x0144, 56, 29, 0),  V(29, 0x00f5, 57, 30, 0),  V(30, 0x00b7, 59, 31, 0),  V(31, 0x008a, 60, 32, 0),
        V(32, 0x0068, 62, 33, 0),  V(33, 0x004e, 63, 34, 0),  V(34, 0x003b, 32, 35, 0),  V(35, 0x002c, 33, 9, 0),
        V(36, 0x5ae1, 37, 37, 1),  V(37, 0x484c, 64, 38, 0),  V(38, 0x3a0d, 65, 39, 0),  V(39, 0x2ef1, 67, 40, 0),
        V(40, 0x261f, 68, 41, 0),  V(41, 0x1f33, 69, 42, 0),  V(42, 0x19a8, 70, 43, 0),  V(43, 0x1518, 72, 44, 0),
        V(44, 0x1177, 73, 45, 0),  V(45, 0x0e74, 74, 46, 0),  V(46, 0x0bfb, 75, 47, 0),  V(47, 0x09f8, 77, 48, 0),
        V(48, 0x0861, 78, 49, 0),  V(49, 0x0706, 79, 50, 0),  V(50, 0x05cd, 48, 51, 0),  V(51, 0x04de, 50, 52, 0),
        V(52, 0x040f, 50, 53, 0),  V(53, 0x0363, 51, 54, 0),  V(54, 0x02d4, 52, 55, 0),  V(55, 0x025c, 53, 56, 0),
        V(56, 0x01f8, 54, 57, 0),  V(57, 0x01a4, 55, 58, 0),  V(58, 0x0160, 56, 59, 0),  V(59, 0x0125, 57, 60, 0),
        V(60, 0x00f6, 58, 61, 0),  V(61, 0x00cb, 59, 62, 0),  V(62, 0x00ab, 61, 63, 0),  V(63, 0x008f, 61, 32, 0),
        V(64, 0x5b12, 65, 65, 1),  V(65, 0x4d04, 80, 66, 0),  V(66, 0x412c, 81, 67, 0),  V(67, 0x37d8, 82, 68, 0),
        V(68, 0x2fe8, 83, 69, 0),  V(69, 0x293c, 84, 70, 0),  V(70, 0x2379, 86, 71, 0),  V(71, 0x1edf, 87, 72, 0),
        V(72, 0x1aa9, 87, 73, 0),  V(73, 0x174e, 72, 74, 0),  V(74, 0x1424, 72, 75, 0),  V(75, 0x119c, 74, 76, 0),
        V(76, 0x0f6b, 74, 77, 0),  V(77, 0x0d51, 75, 78, 0),  V(78, 0x0bb6, 77, 79, 0),  V(79, 0x0a40, 77, 48, 0),
        V(80, 0x5832, 80, 81, 1),  V(81, 0x4d1c, 88, 82, 0),  V(82, 0x438e, 89, 83, 0),  V(83, 0x3bdd, 90, 84, 0),
        V(84, 0x34ee, 91, 85, 0),  V(85, 0x2eae, 92, 86, 0),  V(86, 0x299a, 93, 87, 0),  V(87, 0x2516, 86, 71, 0),
        V(88, 0x5570, 88, 89, 1),  V(89, 0x4ca9, 95, 90, 0),  V(90, 0x44d9, 96, 91, 0),  V(91, 0x3e22, 97, 92, 0),
        V(92, 0x3824, 99, 93, 0),  V(93, 0x32b4, 99, 94, 0),  V(94, 0x2e17, 93, 86, 0),  V(95, 0x56a8, 95, 96, 1),
        V(96, 0x4f46, 101, 97, 0), V(97, 0x47e5, 102, 98, 0), V(98, 0x41cf, 103, 99, 0), V(99, 0x3c3d, 104, 100, 0),
        V(100, 0x375e, 99, 93, 0), V(101, 0x5231, 105, 102, 0), V(102, 0x4c0f, 106, 103, 0),
        V(103, 0x4639, 107, 104, 0), V(104, 0x415e, 103, 99, 0), V(105, 0x5627, 105, 106, 1),
        V(106, 0x50e7, 108, 107, 0), V(107, 0x4b85, 109, 103, 0), V(108, 0x5597, 110, 109, 0),
        V(109, 0x504f, 111, 107, 0), V(110, 0x5a10, 110, 111, 1), V(111, 0x5522, 112, 109, 0),
        V(112, 0x59eb, 112, 111, 1), V(113, 0x5a1d, 113, 113, 0)};
#undef V
    while (ac_a < 0x8000) {
      if (--ac_ct < 0) {
        ac_c = (ac_c << 8) | arith_byte();
        if ((ac_ct += 8) < 0)
          if (++ac_ct == 0) ac_a = 0x8000;  // got 2 initial bytes: A = 0x10000 after the shift below
      }
      ac_a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    int nl = (int)(qe & 0xFF);
    qe >>= 8;
    int nm = (int)(qe & 0xFF);
    qe >>= 8;
    int64_t temp = ac_a - qe;
    ac_a = temp;
    temp <<= ac_ct;
    if (ac_c >= temp) {
      ac_c -= temp;
      if (ac_a < qe) {
        ac_a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        ac_a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (ac_a < 0x8000) {
      if (ac_a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // jdarith.c start_pass / process_restart: the statistics a scan uses are
  // zeroed, with the DC predictors and contexts, and the decoder restarts.
  void arith_reset(const std::vector<Component*>& sc, int ss, int ah, int* last_dc, int* dc_context) {
    for (size_t ci = 0; ci < sc.size(); ci++) {
      if (!progressive || (ss == 0 && ah == 0)) {
        memset(dc_stats[sc[ci]->dc_tbl], 0, 64);
        last_dc[ci] = 0;
        dc_context[ci] = 0;
      }
      if (!progressive || ss) memset(ac_stats[sc[ci]->ac_tbl], 0, 256);
    }
    ac_c = 0;
    ac_a = 0;
    ac_ct = -16;
  }

  // Section F.1.4.4.1: one DC difference, with its conditioning category.
  bool arith_dc(Component* c, int ci, int* last_dc, int* dc_context) {
    int tbl = c->dc_tbl;
    uint8_t* st = dc_stats[tbl] + dc_context[ci];
    if (arith_decode(st) == 0) {
      dc_context[ci] = 0;
      return true;
    }
    int sign = arith_decode(st + 1);  // Figures F.21-F.24: sign, magnitude category, bits
    st += 2 + sign;
    int m = arith_decode(st);
    if (m != 0) {
      st = dc_stats[tbl] + 20;  // X1 (Table F.4)
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
    if (m < (int)((1L << arith_dc_L[tbl]) >> 1))
      dc_context[ci] = 0;
    else if (m > (int)((1L << arith_dc_U[tbl]) >> 1))
      dc_context[ci] = 12 + sign * 4;
    else
      dc_context[ci] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    last_dc[ci] = (last_dc[ci] + v) & 0xFFFF;
    return true;
  }

  void arith_scan(const std::vector<Component*>& sc, int ss, int se, int ah, int al) {
    for (Component* c : sc)
      if (c->dc_tbl > 15 || c->ac_tbl > 15) fail(kCorrupt, "bad arithmetic table index");
    Layout lo = layout(sc);
    int last_dc[4] = {}, dc_context[4] = {};
    arith_reset(sc, ss, ah, last_dc, dc_context);
    int togo = restart_interval;
    next_restart = 0;
    const int p1 = 1 << al, m1 = (int)(~0u << al);
    for (int my = 0; my < lo.mcus_y; my++) {
      mcu_row_start(sc, my);
      for (int mx = 0; mx < lo.mcus_x; mx++) {
        if (restart_interval) {
          if (togo == 0) {
            read_restart_marker();
            arith_reset(sc, ss, ah, last_dc, dc_context);
            togo = restart_interval;
          }
          togo--;
        }
        if (ac_ct == -1) continue;  // after an error libjpeg does nothing
        if (!progressive || (ss == 0 && ah == 0)) {  // decode_mcu / decode_mcu_DC_first
          for (size_t b = 0; b < lo.blocks.size(); b++) {
            int ci = lo.blocks[b].comp;
            Component* c = sc[ci];
            if (!arith_dc(c, ci, last_dc, dc_context)) { ac_ct = -1; break; }
            int16_t* blk = mcu_block(sc, lo, (int)b, mx, my);
            blk[0] = progressive ? (int16_t)(int)((unsigned)last_dc[ci] << al) : (int16_t)last_dc[ci];
            if (!progressive && !arith_ac_first(c->ac_tbl, blk, 1, 63, 0)) { ac_ct = -1; break; }
          }
        } else if (ss == 0) {  // decode_mcu_DC_refine
          for (size_t b = 0; b < lo.blocks.size(); b++)
            if (arith_decode(fixed_bin)) mcu_block(sc, lo, (int)b, mx, my)[0] |= (int16_t)p1;
        } else if (ah == 0) {  // decode_mcu_AC_first
          if (!arith_ac_first(sc[0]->ac_tbl, mcu_block(sc, lo, 0, mx, my), ss, se, al)) ac_ct = -1;
        } else {  // decode_mcu_AC_refine
          if (!arith_ac_refine(sc[0]->ac_tbl, mcu_block(sc, lo, 0, mx, my), ss, se, p1, m1)) ac_ct = -1;
        }
      }
    }
  }

  // Figure F.20 (decode_mcu's AC loop and decode_mcu_AC_first).
  bool arith_ac_first(int tbl, int16_t* blk, int ss, int se, int al) {
    for (int k = ss; k <= se; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (arith_decode(st)) break;  // EOB
      while (arith_decode(st + 1) == 0) {
        st += 3;
        if (++k > se) return false;  // spectral overflow
      }
      int sign = arith_decode(fixed_bin);
      st += 2;
      int m = arith_decode(st);
      if (m != 0) {
        if (arith_decode(st)) {
          m <<= 1;
          st = ac_stats[tbl] + (k <= arith_ac_K[tbl] ? 189 : 217);
          while (arith_decode(st)) {
            if ((m <<= 1) == 0x8000) return false;  // magnitude overflow
            st += 1;
          }
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (arith_decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = (int16_t)(int)((unsigned)v << al);
    }
    return true;
  }

  bool arith_ac_refine(int tbl, int16_t* blk, int ss, int se, int p1, int m1) {
    int kex = se;  // EOBx: the previous stage's end of block
    for (; kex > 0; kex--)
      if (blk[kNatural[kex]]) break;
    for (int k = ss; k <= se; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex)
        if (arith_decode(st)) break;  // EOB
      for (;;) {
        int16_t& c = blk[kNatural[k]];
        if (c) {  // previously nonzero
          if (arith_decode(st + 2)) c = (int16_t)(c + (c < 0 ? m1 : p1));
          break;
        }
        if (arith_decode(st + 1)) {  // newly nonzero
          c = (int16_t)(arith_decode(fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) return false;  // spectral overflow
      }
    }
    return true;
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
        dac();
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
    if (scans == 0) fail(kCorrupt, "no SOS marker (the file ends before its first scan)");  // JERR_SOF_NO_SOS
    // A component no scan reached (a file cut short) has no quantisation
    // table latched: libjpeg's IDCT multipliers stay zero, and it decodes
    // to mid-gray. No smoothing then either (smoothing_ok).
    for (auto& c : comps)
      if (!c.latched) {
        memset(c.q, 0, sizeof c.q);
        c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      }
  }

  // jdcoefct.c smoothing_ok (libjpeg-turbo 2.1): smooth a progressive image
  // whose first 10 coefficients (zigzag 0-9) are not all final, once every
  // DC is known in part and no quantiser of those 10 is zero.
  bool smoothing_ok() const {
    if (!progressive) return false;
    bool useful = false;
    for (auto& c : comps) {
      for (int k = 0; k < 10; k++)
        if (c.q[kNatural[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; k++) useful = useful || c.coef_bits[k] != 0;
    }
    return useful;
  }

  void smooth_component(Component& c, uint8_t* plane, int stride);

  // ------------------------------------------------------------ output ----

  static void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride);
  void output(uint8_t* rgb);
};

// The islow IDCT as libjpeg-turbo's x86-64 SIMD version computes it
// (jidctint-avx2.asm / jidctint-sse2.asm, which the JAX tier's and
// Pillow's libjpeg-turbo run): jidctint.c's integer steps, with the
// products paired as pmaddwd pairs them, and the SIMD's 16- and 32-bit
// arithmetic. On coefficients in range it equals jidctint.c bit for bit;
// on the extreme ones of a corrupt or cut-short block it wraps and
// saturates as the SIMD does (dequantisation in 16 bits, 16-bit sums
// before the multiplies, a saturated 16-bit workspace, 32-bit sums, a
// saturated 8-bit output), where jidctint.c's range limit would wrap.
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373, F1175 = 9633,
                  F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline int32_t add32(int32_t a, int32_t b) { return (int32_t)((uint32_t)a + (uint32_t)b); }
inline int32_t sub32(int32_t a, int32_t b) { return (int32_t)((uint32_t)a - (uint32_t)b); }
inline int32_t wrap16(int32_t x) { return (int16_t)(uint16_t)(uint32_t)x; }
inline int32_t sat16(int32_t x) { return x < -32768 ? -32768 : x > 32767 ? 32767 : x; }
inline int32_t descale32(int32_t x, int n) { return add32(x, 1 << (n - 1)) >> n; }

// One 8-point pass over in[0], in[step], ..., in[7 * step] (16-bit values),
// out[0..7] before the descale.
template <typename T>
inline __attribute__((always_inline)) void idct8(const T* in, int step, int32_t* out) {
  const int32_t z2 = in[2 * step], z3 = in[6 * step];
  const int32_t tmp3 = z2 * (F0541 + F0765) + z3 * F0541;
  const int32_t tmp2 = z2 * F0541 + z3 * (F0541 - F1847);
  const int32_t tmp0 = (int32_t)((uint32_t)wrap16(in[0] + in[4 * step]) << kConstBits);
  const int32_t tmp1 = (int32_t)((uint32_t)wrap16(in[0] - in[4 * step]) << kConstBits);
  const int32_t tmp10 = add32(tmp0, tmp3), tmp13 = sub32(tmp0, tmp3), tmp11 = add32(tmp1, tmp2),
                tmp12 = sub32(tmp1, tmp2);
  const int32_t i7 = in[7 * step], i5 = in[5 * step], i3 = in[3 * step], i1 = in[step];
  const int32_t z3o = wrap16(i7 + i3), z4o = wrap16(i5 + i1);
  const int32_t zz3 = z3o * (F1175 - F1961) + z4o * F1175;
  const int32_t zz4 = z3o * F1175 + z4o * (F1175 - F0390);
  const int32_t t0 = add32(i7 * (F0298 - F0899) + i1 * -F0899, zz3);
  const int32_t t3 = add32(i7 * -F0899 + i1 * (F1501 - F0899), zz4);
  const int32_t t1 = add32(i5 * (F2053 - F2562) + i3 * -F2562, zz4);
  const int32_t t2 = add32(i5 * -F2562 + i3 * (F3072 - F2562), zz3);
  out[0] = add32(tmp10, t3);
  out[7] = sub32(tmp10, t3);
  out[1] = add32(tmp11, t2);
  out[6] = sub32(tmp11, t2);
  out[2] = add32(tmp12, t1);
  out[5] = sub32(tmp12, t1);
  out[3] = add32(tmp13, t0);
  out[4] = sub32(tmp13, t0);
}

// packssdw then packsswb (the 16-bit saturation is inside the 8-bit one),
// then + 128.
inline uint8_t to_sample(int32_t x) {
  int32_t v = descale32(x, kConstBits + kPass1Bits + 3);
  return (uint8_t)((v < -128 ? -128 : v > 127 ? 127 : v) + 128);
}

// A column or row whose AC inputs are all zero takes the value the full
// pass gives it, without the pass (as jidctint.c does, with the SIMD's
// saturation): the shortcuts change no bit.
void Decoder::idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  int ac = 0;
  for (int k = 8; k < 64; k++) ac |= in[k];
  int16_t ws[64];
  int32_t o[8];
  if (!ac) {  // the SIMD's test: every coefficient of rows 1-7 zero; psllw wraps
    for (int c = 0; c < 8; c++) {
      int16_t dc = (int16_t)wrap16(wrap16(in[c] * q[c]) * (1 << kPass1Bits));
      for (int r = 0; r < 8; r++) ws[8 * r + c] = dc;
    }
  } else {
    for (int c = 0; c < 8; c++) {
      const int16_t* col = in + c;
      if (!(col[8] | col[16] | col[24] | col[32] | col[40] | col[48] | col[56])) {
        int16_t dc = (int16_t)sat16(wrap16(col[0] * q[c]) * (1 << kPass1Bits));
        for (int r = 0; r < 8; r++) ws[8 * r + c] = dc;
        continue;
      }
      int32_t dq[8];
      for (int r = 0; r < 8; r++) dq[r] = wrap16(col[8 * r] * q[8 * r + c]);  // pmullw
      idct8(dq, 1, o);
      for (int r = 0; r < 8; r++) ws[8 * r + c] = (int16_t)sat16(descale32(o[r], kConstBits - kPass1Bits));
    }
  }
  for (int r = 0; r < 8; r++) {
    const int16_t* w = ws + 8 * r;
    uint8_t* row = out + (size_t)r * stride;
    if (!(w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7])) {
      memset(row, to_sample(w[0] * (1 << kConstBits)), 8);
      continue;
    }
    idct8(w, 1, o);
    for (int c = 0; c < 8; c++) row[c] = to_sample(o[c]);
  }
}

// jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1): each block is
// transformed from a copy in which the low AC coefficients (zigzag 1-9)
// not known yet are estimated from the DC values of the 5x5 blocks around
// it, and, while no AC scan has begun, the DC is interpolated too. An iMCU
// row that the last scan reached takes that scan's coefficient bits; a
// later one, the previous scan's. The neighbour rows and columns are
// clamped as libjpeg clamps them, quirks included (its conditions are on
// the iMCU row and the block row within it).
void Decoder::smooth_component(Component& c, uint8_t* plane, int stride) {
  const int last_imcu = imcu_rows - 1, v = c.v, last_col = c.wib - 1;
  int cur_bits[10], prev_bits[10];
  for (int k = 0; k < 10; k++) {
    cur_bits[k] = c.coef_bits[k];
    prev_bits[k] = scans > 1 ? c.prev_bits[k] : -1;
  }
  auto q = [&](int natural) { return (int64_t)(uint16_t)c.q[natural]; };
  const int64_t Q00 = q(0), Q01 = q(1), Q10 = q(8), Q20 = q(16), Q11 = q(9), Q02 = q(2), Q03 = q(3), Q12 = q(10),
                Q21 = q(17), Q30 = q(24);
  auto predict = [](int64_t num, int64_t qk, int al) {
    int pred = (int)(((qk << 7) + (num >= 0 ? num : -num)) / (qk << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    return num >= 0 ? pred : -pred;
  };
  int16_t ws[64];
  for (int r = 0; r <= last_imcu; r++) {
    int block_rows = v;
    if (r == last_imcu) {
      block_rows = c.hib % v;
      if (block_rows == 0) block_rows = v;
    }
    const int* bits = r > last_good_imcu ? prev_bits : cur_bits;
    bool change_dc = true;
    for (int k = 1; k < 10; k++) change_dc = change_dc && bits[k] == -1;
    for (int br = 0; br < block_rows; br++) {
      const int row = r * v + br;
      const int prev = br > 0 || r > 0 ? row - 1 : row;
      const int pprev = br > 1 || r > 1 ? row - 2 : prev;
      const int next = br < block_rows - 1 || r < last_imcu ? row + 1 : row;
      const int nnext = br < block_rows - 2 || r + 1 < last_imcu ? row + 2 : next;
      const int rows[5] = {pprev, prev, row, next, nnext};
      int dc[5][5];  // [row -2..+2][column -2..+2], a sliding window
      for (int i = 0; i < 5; i++)
        for (int j = 0; j < 5; j++) dc[i][j] = c.block(rows[i], 0)[0];
      for (int bn = 0; bn <= last_col; bn++) {
        memcpy(ws, c.block(row, bn), sizeof ws);
        if (bn == 0 && bn < last_col)
          for (int i = 0; i < 5; i++) dc[i][3] = c.block(rows[i], 1)[0];
        if (bn + 1 < last_col)
          for (int i = 0; i < 5; i++) dc[i][4] = c.block(rows[i], bn + 2)[0];
        const int64_t DC01 = dc[0][0], DC02 = dc[0][1], DC03 = dc[0][2], DC04 = dc[0][3], DC05 = dc[0][4],
                      DC06 = dc[1][0], DC07 = dc[1][1], DC08 = dc[1][2], DC09 = dc[1][3], DC10 = dc[1][4],
                      DC11 = dc[2][0], DC12 = dc[2][1], DC13 = dc[2][2], DC14 = dc[2][3], DC15 = dc[2][4],
                      DC16 = dc[3][0], DC17 = dc[3][1], DC18 = dc[3][2], DC19 = dc[3][3], DC20 = dc[3][4],
                      DC21 = dc[4][0], DC22 = dc[4][1], DC23 = dc[4][2], DC24 = dc[4][3], DC25 = dc[4][4];
        int al;
        if ((al = bits[1]) != 0 && ws[1] == 0)  // AC01
          ws[1] = (int16_t)predict(
              Q00 * (change_dc ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 + 3 * DC10 -
                                  3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
                                  13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25)
                               : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)),
              Q01, al);
        if ((al = bits[2]) != 0 && ws[8] == 0)  // AC10
          ws[8] = (int16_t)predict(
              Q00 * (change_dc ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 + 38 * DC08 +
                                  13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
                                  3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                               : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)),
              Q10, al);
        if ((al = bits[3]) != 0 && ws[16] == 0)  // AC20
          ws[16] = (int16_t)predict(
              Q00 * (change_dc ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 - 5 * DC14 +
                                  2 * DC17 + 7 * DC18 + 2 * DC19 + DC23)
                               : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)),
              Q20, al);
        if ((al = bits[4]) != 0 && ws[9] == 0)  // AC11
          ws[9] = (int16_t)predict(
              Q00 * (change_dc ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25)
                               : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 + DC04 - DC06 +
                                  10 * DC07 - 10 * DC09)),
              Q11, al);
        if ((al = bits[5]) != 0 && ws[2] == 0)  // AC02
          ws[2] = (int16_t)predict(
              Q00 * (change_dc ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 + 7 * DC14 +
                                  DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19)
                               : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)),
              Q02, al);
        if (change_dc) {
          if ((al = bits[6]) != 0 && ws[3] == 0)  // AC03
            ws[3] = (int16_t)predict(Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19), Q03, al);
          if ((al = bits[7]) != 0 && ws[10] == 0)  // AC12
            ws[10] = (int16_t)predict(Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19), Q12, al);
          if ((al = bits[8]) != 0 && ws[17] == 0)  // AC21
            ws[17] = (int16_t)predict(Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19), Q21, al);
          if ((al = bits[9]) != 0 && ws[24] == 0)  // AC30
            ws[24] = (int16_t)predict(Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19), Q30, al);
          ws[0] = (int16_t)predict(
              Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 + 6 * DC07 + 42 * DC08 +
                     6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 +
                     6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 -
                     2 * DC25),
              Q00, 0);
        }
        idct_islow(ws, c.q, plane + (size_t)row * 8 * stride + bn * 8, stride);
        for (int i = 0; i < 5; i++)
          for (int j = 0; j < 4; j++) dc[i][j] = dc[i][j + 1];
      }
    }
  }
}

// One output row of a component upsampled to the image's width, as
// jdsample.c's upsampler for its ratio (rh, rv) writes it. `plane` holds the
// component's rows; row y of the output lies in row y / rv of it.
void upsample_row(const uint8_t* plane, int stride, int dw, int dh, int rh, int rv, int y, int out_w,
                  uint8_t* out) {
  const int cy = y / rv;
  const uint8_t* near = plane + (size_t)cy * stride;
  auto far_row = [&](void) {  // jdmainct.c's context rows: the edge rows repeated
    int fy = (y % 2) ? cy + 1 : cy - 1;
    fy = fy < 0 ? 0 : fy > dh - 1 ? dh - 1 : fy;
    return plane + (size_t)fy * stride;
  };
  if (rh == 2 && rv == 1 && dw > 2) {  // h2v1_fancy_upsample
    out[0] = near[0];
    out[1] = (uint8_t)((near[0] * 3 + near[1] + 2) >> 2);
    for (int x = 1; x < dw - 1; x++) {
      int v = near[x] * 3;
      out[2 * x] = (uint8_t)((v + near[x - 1] + 1) >> 2);
      out[2 * x + 1] = (uint8_t)((v + near[x + 1] + 2) >> 2);
    }
    out[2 * dw - 2] = (uint8_t)((near[dw - 1] * 3 + near[dw - 2] + 1) >> 2);
    out[2 * dw - 1] = near[dw - 1];
  } else if (rh == 1 && rv == 2) {  // h1v2_fancy_upsample
    const uint8_t* far = far_row();
    const int bias = (y % 2) ? 2 : 1;
    for (int x = 0; x < dw; x++) out[x] = (uint8_t)((near[x] * 3 + far[x] + bias) >> 2);
  } else if (rh == 2 && rv == 2 && dw > 2) {  // h2v2_fancy_upsample: column sums 3 * near + far, then a triangle
    const uint8_t* far = far_row();
    int last = near[0] * 3 + far[0];
    int cur = last;
    for (int x = 0; x < dw; x++) {
      int next = x + 1 < dw ? near[x + 1] * 3 + far[x + 1] : cur;
      out[2 * x] = (uint8_t)((cur * 3 + last + 8) >> 4);
      out[2 * x + 1] = (uint8_t)((cur * 3 + next + 7) >> 4);
      last = cur;
      cur = next;
    }
  } else {  // h2v1_upsample, h2v2_upsample, int_upsample: replication
    for (int x = 0; x < out_w; x++) out[x] = near[x / rh];
  }
}

void Decoder::output(uint8_t* rgb) {
  const bool smooth = smoothing_ok();
  const int nc = (int)comps.size();
  std::vector<std::vector<uint8_t>> planes(nc);
  std::vector<int> strides(nc);
  for (int ci = 0; ci < nc; ci++) {
    Component& c = comps[ci];
    int stride = strides[ci] = c.wib * 8;
    planes[ci].resize((size_t)stride * c.hib * 8);
    if (smooth) {
      smooth_component(c, planes[ci].data(), stride);
      continue;
    }
    for (int by = 0; by < c.hib; by++)
      for (int bx = 0; bx < c.wib; bx++)
        idct_islow(c.block(by, bx), c.q, planes[ci].data() + (size_t)by * 8 * stride + bx * 8, stride);
  }
  // Each component's row at full resolution, upsampled where its factors
  // are below the largest (jdsample.c: full size where they are equal).
  std::vector<std::vector<uint8_t>> up(nc, std::vector<uint8_t>((size_t)width + 8 * hmax));
  auto row_of = [&](int ci, int y) -> const uint8_t* {
    const Component& c = comps[ci];
    int rh = hmax / c.h, rv = vmax / c.v;
    if (rh == 1 && rv == 1) return planes[ci].data() + (size_t)y * strides[ci];
    upsample_row(planes[ci].data(), strides[ci], c.dw, c.dh, rh, rv, y, width, up[ci].data());
    return up[ci].data();
  };
  if (nc == 1) {  // gray_rgb_convert
    for (int y = 0; y < height; y++) {
      const uint8_t* g = row_of(0, y);
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
  for (int y = 0; y < height; y++) {
    const uint8_t* Y = row_of(0, y);
    const uint8_t* cb_row = row_of(1, y);
    const uint8_t* cr_row = row_of(2, y);
    uint8_t* o = rgb + (size_t)y * width * 3;
    if (!ycc) {  // rgb_rgb_convert
      for (int x = 0; x < width; x++) {
        o[3 * x] = Y[x];
        o[3 * x + 1] = cb_row[x];
        o[3 * x + 2] = cr_row[x];
      }
      continue;
    }
    for (int x = 0; x < width; x++) {  // ycc_rgb_convert
      int yy = Y[x], cb = cb_row[x], cr = cr_row[x];
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

// Decode a JPEG held in memory to RGB8 (malloc'd, width x height x 3), or
// with `native` to the samples Pillow opens it to: one channel ("L") for a
// one-component file, RGB for three (*channels says which), and a file
// whose data ends before EOI refused, as Pillow's load refuses it. Returns null
// and sets *status (a Status) and `why` when it cannot.
static uint8_t* decode(const uint8_t* data, size_t size, bool native, int* w, int* h, int* channels, int* status,
                       std::string* why) {
  try {
    Decoder d(data, size);
    d.parse();
    if (native && d.in.fake)  // libjpeg reads on (a warning); Pillow's load raises "image file is truncated"
      fail(kTruncated, "image file is truncated (the data ends before EOI)");
    const size_t n = (size_t)d.width * d.height;
    uint8_t* out = (uint8_t*)malloc(n * 3);
    if (!out) fail(kUnreadable, "out of memory");
    d.output(out);
    *channels = 3;
    if (native && d.comps.size() == 1) {  // gray_rgb_convert replicated the plane: keep one copy
      for (size_t i = 0; i < n; i++) out[i] = out[3 * i];
      *channels = 1;
    }
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

uint8_t* gt_jpeg_decode(const uint8_t* data, size_t size, int* w, int* h, int* status, std::string* why) {
  int channels;
  return decode(data, size, false, w, h, &channels, status, why);
}

uint8_t* gt_jpeg_samples(const uint8_t* data, size_t size, int* w, int* h, int* channels, int* status,
                         std::string* why) {
  return decode(data, size, true, w, h, channels, status, why);
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
