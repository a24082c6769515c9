/* A small PNG and JPEG writer on libpng and libjpeg, for the port's image
 * tests and fixtures (tests/torch_image_files.py builds and drives it).
 * Pillow writes no Adam7, no 16-bit RGB, no chosen PNG filters or zlib
 * strategies, no 4:4:0 or 4:1:1 sampling and no arithmetic coding; this
 * writer writes all of them.
 *
 *   writer png OUT W H COLOR_TYPE DEPTH INTERLACE FILTERS LEVEL STRATEGY PLTE TRNS < rows
 *     rows: H rows of packed PNG samples (big-endian 16-bit), no filter byte;
 *     FILTERS: a PNG_FILTER_* mask (248 = PNG_ALL_FILTERS); STRATEGY: zlib's;
 *     PLTE, TRNS: hex strings ("-" for none).
 *   writer jpeg OUT W H COMPONENTS QUALITY SAMPLING PROGRESSIVE ARITH OPTIMIZE RESTART_ROWS
 *               RESTART_BLOCKS [SCANS] < pixels
 *     pixels: H x W x COMPONENTS bytes (gray or RGB); SAMPLING: "HxV,HxV,HxV";
 *     SCANS: a progressive scan script, scans split by ";", each
 *     "c,c,.../Ss/Se/Ah/Al" (component indices, then jpeg_scan_info's fields).
 *
 * Build: cc -O2 torch_image_writer.c -o writer -lpng -ljpeg
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>
#include <png.h>

static unsigned char *read_all(size_t n) {
  unsigned char *buf = malloc(n ? n : 1);
  if (fread(buf, 1, n, stdin) != n) {
    fprintf(stderr, "short input: wanted %zu bytes\n", n);
    exit(2);
  }
  return buf;
}

static int unhex(const char *s, unsigned char *out) {
  if (strcmp(s, "-") == 0) return 0;
  int n = (int)strlen(s) / 2;
  for (int i = 0; i < n; i++) sscanf(s + 2 * i, "%2hhx", &out[i]);
  return n;
}

static int write_png(int argc, char **argv) {
  if (argc != 13) return 64;
  const char *out = argv[2];
  int w = atoi(argv[3]), h = atoi(argv[4]), ct = atoi(argv[5]), depth = atoi(argv[6]);
  int interlace = atoi(argv[7]), filters = atoi(argv[8]), level = atoi(argv[9]), strategy = atoi(argv[10]);
  static unsigned char plte[768], trns[256];
  int nplte = unhex(argv[11], plte), ntrns = unhex(argv[12], trns);
  int channels = ct == 0 ? 1 : ct == 2 ? 3 : ct == 3 ? 1 : ct == 4 ? 2 : 4;
  size_t rowbytes = ((size_t)w * channels * depth + 7) / 8;
  unsigned char *data = read_all(rowbytes * h);
  FILE *f = fopen(out, "wb");
  if (!f) return 3;
  png_structp png = png_create_write_struct(PNG_LIBPNG_VER_STRING, NULL, NULL, NULL);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) return 4;
  png_init_io(png, f);
  png_set_IHDR(png, info, w, h, depth, ct, interlace ? PNG_INTERLACE_ADAM7 : PNG_INTERLACE_NONE,
               PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
  png_set_filter(png, PNG_FILTER_TYPE_BASE, filters);
  png_set_compression_level(png, level);
  png_set_compression_strategy(png, strategy);
  if (nplte) {
    png_color pal[256];
    for (int i = 0; i < nplte / 3; i++) {
      pal[i].red = plte[3 * i];
      pal[i].green = plte[3 * i + 1];
      pal[i].blue = plte[3 * i + 2];
    }
    png_set_PLTE(png, info, pal, nplte / 3);
  }
  if (ntrns) {
    png_color_16 key;
    memset(&key, 0, sizeof key);
    if (ct == 0) key.gray = (png_uint_16)(trns[0] << 8 | trns[1]);
    if (ct == 2) {
      key.red = (png_uint_16)(trns[0] << 8 | trns[1]);
      key.green = (png_uint_16)(trns[2] << 8 | trns[3]);
      key.blue = (png_uint_16)(trns[4] << 8 | trns[5]);
    }
    png_set_tRNS(png, info, ct == 3 ? trns : NULL, ct == 3 ? ntrns : 0, ct == 3 ? NULL : &key);
  }
  png_write_info(png, info);
  png_bytep *rows = malloc(sizeof(png_bytep) * (h ? h : 1));
  for (int y = 0; y < h; y++) rows[y] = data + (size_t)y * rowbytes;
  png_write_image(png, rows);
  png_write_end(png, NULL);
  png_destroy_write_struct(&png, &info);
  fclose(f);
  return 0;
}

static int write_jpeg(int argc, char **argv) {
  if (argc != 13 && argc != 14) return 64;
  const char *out = argv[2];
  int w = atoi(argv[3]), h = atoi(argv[4]), nc = atoi(argv[5]), quality = atoi(argv[6]);
  const char *sampling = argv[7];
  int progressive = atoi(argv[8]), arith = atoi(argv[9]), optimize = atoi(argv[10]);
  int restart_rows = atoi(argv[11]), restart_blocks = atoi(argv[12]);
  unsigned char *data = read_all((size_t)w * h * nc);
  FILE *f = fopen(out, "wb");
  if (!f) return 3;
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr err;
  c.err = jpeg_std_error(&err);
  jpeg_create_compress(&c);
  jpeg_stdio_dest(&c, f);
  c.image_width = w;
  c.image_height = h;
  c.input_components = nc;
  c.in_color_space = nc == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&c);
  jpeg_set_quality(&c, quality, TRUE);
  for (int i = 0; i < nc; i++) {
    int hs = 1, vs = 1;
    const char *p = sampling;
    for (int k = 0; k < i && p; k++) {
      p = strchr(p, ',');
      if (p) p++;
    }
    if (p) sscanf(p, "%dx%d", &hs, &vs);
    c.comp_info[i].h_samp_factor = hs;
    c.comp_info[i].v_samp_factor = vs;
  }
  c.arith_code = arith ? TRUE : FALSE;
  c.optimize_coding = optimize ? TRUE : FALSE;
  c.restart_in_rows = restart_rows;
  c.restart_interval = restart_blocks;
  if (progressive) jpeg_simple_progression(&c);
  static jpeg_scan_info scans[64];
  if (argc == 14) {
    int n = 0;
    for (const char *p = argv[13]; p && *p && n < 64; n++) {
      jpeg_scan_info *s = &scans[n];
      s->comps_in_scan = 0;
      while (*p >= '0' && *p <= '9') {
        s->component_index[s->comps_in_scan++] = (int)strtol(p, (char **)&p, 10);
        if (*p == ',') p++;
      }
      sscanf(p, "/%d/%d/%d/%d", &s->Ss, &s->Se, &s->Ah, &s->Al);
      p = strchr(p, ';');
      if (p) p++;
    }
    c.scan_info = scans;
    c.num_scans = n;
  }
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = data + (size_t)c.next_scanline * w * nc;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(f);
  return 0;
}

int main(int argc, char **argv) {
  if (argc > 1 && strcmp(argv[1], "png") == 0) return write_png(argc, argv);
  if (argc > 1 && strcmp(argv[1], "jpeg") == 0) return write_jpeg(argc, argv);
  fprintf(stderr, "usage: see the comment at the top of torch_image_writer.c\n");
  return 64;
}
