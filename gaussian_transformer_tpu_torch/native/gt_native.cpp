// gt_native: the native IO tier of gaussian_transformer_tpu_torch.
//
// C++ replacements for the single-threaded Python IO of a scene load:
//   * COLMAP points3D.bin / images.bin parsers (one read, one pass over it)
//   * a binary-little-endian float32 PLY vertex-table reader and writer
//   * a thread-pool JPEG/PNG decoder with a bilinear resize, to RGB (the
//     JAX tier's output) or RGBA (gt_load_images_rgba)
//   * an image's samples in the mode Pillow opens it in (gt_image_samples),
//     for the COLMAP converter's pyramid, which jpeg_encode.cpp's
//     gt_jpeg_encode writes back
// The C ABI is the JAX package's native tier's (native/gt_native.cpp at the
// repository root), plus gt_codecs(), gt_load_images_rgba(),
// gt_image_error(), gt_image_samples() and gt_jpeg_encode(). Images go
// through the tier's own codecs, compiled into the same library (jpeg.cpp,
// png.cpp, jpeg_encode.cpp), so they need no library: no libjpeg, libpng or
// zlib. Python binds it through ctypes (native/__init__.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <thread>
#include <atomic>

#include <strings.h>

// jpeg.cpp
uint8_t* gt_jpeg_decode(const uint8_t* data, size_t size, int* w, int* h, int* status, std::string* why);
int gt_jpeg_size(const uint8_t* data, size_t size, int* w, int* h);
uint8_t* gt_jpeg_samples(const uint8_t* data, size_t size, int* w, int* h, int* channels, int* status,
                         std::string* why);
// png.cpp
uint8_t* gt_png_decode(const uint8_t* data, size_t size, int channels, int* w, int* h, int* status,
                       std::string* why);
void* gt_png_samples(const uint8_t* data, size_t size, int* w, int* h, int* channels, int* depth, int* status,
                     std::string* why);

extern "C" {

void gt_free(void* p) { free(p); }

// Bit 0: JPEG decoding; bit 1: PNG decoding. Both are always built in.
int gt_codecs(void) { return 3; }

// ---------------------------------------------------------------- COLMAP ----

// The whole file in memory: the parsers then walk a buffer (a seek per
// record through stdio costs a system call each, slower than Python's
// struct loop on 300k points).
static bool slurp(const char* path, std::vector<uint8_t>& buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  bool ok = fseek(f, 0, SEEK_END) == 0;
  long size = ok ? ftell(f) : -1;
  ok = ok && size >= 0 && fseek(f, 0, SEEK_SET) == 0;
  if (ok) {
    buf.resize((size_t)size);
    ok = fread(buf.data(), 1, buf.size(), f) == buf.size();
  }
  fclose(f);
  return ok;
}

// A bounds-checked reader over the buffer.
struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool take(void* dst, size_t n) {
    if ((size_t)(end - p) < n) return false;
    memcpy(dst, p, n);
    p += n;
    return true;
  }
  bool skip(uint64_t n) {
    if ((uint64_t)(end - p) < n) return false;
    p += n;
    return true;
  }
};

// points3D.bin: u64 count; per point: u64 id, 3xf64 xyz, 3xu8 rgb, f64 error,
// u64 track_len, track_len x (u32 image_id, u32 point2D_idx).
int gt_read_points3d_bin(const char* path, double** xyz_out, uint8_t** rgb_out,
                         double** err_out, uint64_t* n_out) {
  std::vector<uint8_t> buf;
  if (!slurp(path, buf)) return -1;
  Cursor c{buf.data(), buf.data() + buf.size()};
  uint64_t n;
  if (!c.take(&n, 8) || n > buf.size() / 51) return -2;
  double* xyz = (double*)malloc(n * 3 * sizeof(double) + 1);
  uint8_t* rgb = (uint8_t*)malloc(n * 3 + 1);
  double* err = (double*)malloc(n * sizeof(double) + 1);
  if (!xyz || !rgb || !err) { free(xyz); free(rgb); free(err); return -3; }
  for (uint64_t i = 0; i < n; i++) {
    uint64_t id, track_len;
    if (!c.take(&id, 8) || !c.take(xyz + 3 * i, 24) || !c.take(rgb + 3 * i, 3) ||
        !c.take(err + i, 8) || !c.take(&track_len, 8) || track_len > (uint64_t)(c.end - c.p) / 8 ||
        !c.skip(track_len * 8)) {
      free(xyz); free(rgb); free(err); return -4;
    }
  }
  *xyz_out = xyz; *rgb_out = rgb; *err_out = err; *n_out = n;
  return 0;
}

// images.bin: u64 count; per image: u32 image_id, 4xf64 qvec, 3xf64 tvec,
// u32 camera_id, name '\0'-terminated, u64 n_points2D, n x (2xf64 xy, u64 id).
// Names are returned as a single '\n'-joined blob.
int gt_read_images_bin(const char* path, int32_t** ids_out, double** qvec_out,
                       double** tvec_out, int32_t** cam_ids_out, char** names_out,
                       uint64_t* names_len_out, uint64_t* n_out) {
  std::vector<uint8_t> buf;
  if (!slurp(path, buf)) return -1;
  Cursor c{buf.data(), buf.data() + buf.size()};
  uint64_t n;
  if (!c.take(&n, 8) || n > buf.size() / 73) return -2;
  int32_t* ids = (int32_t*)malloc(n * 4 + 1);
  double* qvec = (double*)malloc(n * 4 * 8 + 1);
  double* tvec = (double*)malloc(n * 3 * 8 + 1);
  int32_t* cam_ids = (int32_t*)malloc(n * 4 + 1);
  std::string names;
  auto fail = [&](int rc) {
    free(ids); free(qvec); free(tvec); free(cam_ids); return rc;
  };
  if (!ids || !qvec || !tvec || !cam_ids) return fail(-3);
  for (uint64_t i = 0; i < n; i++) {
    uint32_t image_id, camera_id;
    if (!c.take(&image_id, 4) || !c.take(qvec + 4 * i, 32) || !c.take(tvec + 3 * i, 24) ||
        !c.take(&camera_id, 4)) return fail(-4);
    ids[i] = (int32_t)image_id;
    cam_ids[i] = (int32_t)camera_id;
    const uint8_t* z = (const uint8_t*)memchr(c.p, 0, (size_t)(c.end - c.p));
    if (!z) return fail(-5);
    names.append((const char*)c.p, (size_t)(z - c.p));
    names.push_back('\n');
    c.p = z + 1;
    uint64_t npts;
    if (!c.take(&npts, 8) || npts > (uint64_t)(c.end - c.p) / 24 || !c.skip(npts * 24)) return fail(-6);
  }
  char* nm = (char*)malloc(names.size() + 1);
  memcpy(nm, names.data(), names.size());
  nm[names.size()] = 0;
  *ids_out = ids; *qvec_out = qvec; *tvec_out = tvec; *cam_ids_out = cam_ids;
  *names_out = nm; *names_len_out = names.size(); *n_out = n;
  return 0;
}

// ------------------------------------------------------------------- PLY ----

// Reads a binary_little_endian PLY whose vertex element is all float32
// properties. Returns row-major [rows, cols] data plus '\n'-joined names.
int gt_read_ply_f32(const char* path, float** data_out, char** names_out,
                    uint64_t* rows_out, uint32_t* cols_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char line[4096];
  uint64_t rows = 0;
  std::string names;
  uint32_t cols = 0;
  bool in_vertex = false;
  bool binary_le = false;
  if (!fgets(line, sizeof line, f) || strncmp(line, "ply", 3) != 0) { fclose(f); return -2; }
  while (fgets(line, sizeof line, f)) {
    if (strncmp(line, "format binary_little_endian", 27) == 0) binary_le = true;
    else if (strncmp(line, "element vertex", 14) == 0) {
      rows = strtoull(line + 14, nullptr, 10);
      in_vertex = true;
    } else if (strncmp(line, "element", 7) == 0) in_vertex = false;
    else if (in_vertex && (strncmp(line, "property float32 ", 17) == 0 ||
                           strncmp(line, "property float ", 15) == 0)) {
      const char* nm = line + (line[14] == '3' ? 17 : 15);
      while (*nm == ' ') nm++;
      std::string s(nm);
      while (!s.empty() && (s.back() == '\n' || s.back() == '\r')) s.pop_back();
      names += s; names += '\n';
      cols++;
    } else if (in_vertex && strncmp(line, "property", 8) == 0) { fclose(f); return -5; }
    else if (strncmp(line, "end_header", 10) == 0) break;
  }
  if (!binary_le || cols == 0) { fclose(f); return -3; }
  float* data = (float*)malloc(rows * cols * 4);
  if (!data) { fclose(f); return -3; }
  if (fread(data, 4, rows * cols, f) != rows * cols) { fclose(f); free(data); return -4; }
  fclose(f);
  char* nm = (char*)malloc(names.size() + 1);
  memcpy(nm, names.data(), names.size()); nm[names.size()] = 0;
  *data_out = data; *names_out = nm; *rows_out = rows; *cols_out = cols;
  return 0;
}

// Writes a binary_little_endian float32 vertex PLY. names = '\n'-joined.
int gt_write_ply_f32(const char* path, const char* names, const float* data,
                     uint64_t rows, uint32_t cols) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f, "ply\nformat binary_little_endian 1.0\nelement vertex %llu\n",
          (unsigned long long)rows);
  const char* p = names;
  uint32_t written = 0;
  while (*p && written < cols) {
    const char* e = strchr(p, '\n');
    size_t len = e ? (size_t)(e - p) : strlen(p);
    fprintf(f, "property float %.*s\n", (int)len, p);
    written++;
    if (!e) break;
    p = e + 1;
  }
  fprintf(f, "end_header\n");
  size_t nw = fwrite(data, 4, rows * cols, f);
  fclose(f);
  return nw == rows * cols ? 0 : -2;
}

// ---------------------------------------------------------------- images ----

static bool is_png(const char* path) {
  size_t len = strlen(path);
  return len > 4 && strcasecmp(path + len - 4, ".png") == 0;
}

// Decode one image (PNG by extension, JPEG otherwise) to 3 (RGB) or 4
// (RGBA) channels; returns a malloc'd buffer, or null with *status (< 0)
// and, when `why` is given, the reason.
static uint8_t* decode_image(const char* path, int channels, int* w, int* h, int* status,
                             std::string* why = nullptr) {
  std::vector<uint8_t> buf;
  if (!slurp(path, buf)) {
    *status = -1;
    if (why) *why = "cannot read the file";
    return nullptr;
  }
  if (is_png(path)) return gt_png_decode(buf.data(), buf.size(), channels, w, h, status, why);
  uint8_t* rgb = gt_jpeg_decode(buf.data(), buf.size(), w, h, status, why);
  if (!rgb || channels == 3) return rgb;
  size_t n = (size_t)(*w) * (*h);  // a JPEG as RGBA: opaque, as Pillow's convert("RGBA")
  uint8_t* rgba = (uint8_t*)malloc(n * 4);
  if (rgba)
    for (size_t i = 0; i < n; i++) {
      memcpy(rgba + 4 * i, rgb + 3 * i, 3);
      rgba[4 * i + 3] = 255;
    }
  free(rgb);
  if (!rgba) {
    *status = -1;
    if (why) *why = "out of memory";
  }
  return rgba;
}

// Bilinear resize of c-channel 8-bit images.
static void resize(const uint8_t* src, int sw, int sh, uint8_t* dst, int dw, int dh, int c) {
  for (int y = 0; y < dh; y++) {
    float fy = (y + 0.5f) * sh / dh - 0.5f;
    int y0 = fy < 0 ? 0 : (int)fy;
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < dw; x++) {
      float fx = (x + 0.5f) * sw / dw - 0.5f;
      int x0 = fx < 0 ? 0 : (int)fx;
      int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      for (int k = 0; k < c; k++) {
        float a = src[(y0 * (size_t)sw + x0) * c + k] * (1 - wx) + src[(y0 * (size_t)sw + x1) * c + k] * wx;
        float b = src[(y1 * (size_t)sw + x0) * c + k] * (1 - wx) + src[(y1 * (size_t)sw + x1) * c + k] * wx;
        dst[(y * (size_t)dw + x) * c + k] = (uint8_t)(a * (1 - wy) + b * wy + 0.5f);
      }
    }
  }
}

// Load n images (JPEG/PNG by extension) into one [n, out_h, out_w, channels]
// u8 buffer with a thread pool. paths = '\n'-joined. Returns 0 and per-image
// status (0 ok; else the decoder's status) in status_out.
static int load_images(const char* paths, int n, int out_w, int out_h, int threads, int channels, uint8_t* dst,
                       int32_t* status_out) {
  std::vector<std::string> files;
  {
    const char* p = paths;
    while (*p && (int)files.size() < n) {
      const char* e = strchr(p, '\n');
      files.emplace_back(p, e ? (size_t)(e - p) : strlen(p));
      if (!e) break;
      p = e + 1;
    }
  }
  if ((int)files.size() != n || (channels != 3 && channels != 4)) return -1;
  std::atomic<int> next(0);
  size_t stride = (size_t)out_w * out_h * channels;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int w = 0, h = 0, status = -1;
      uint8_t* buf = decode_image(files[i].c_str(), channels, &w, &h, &status);
      if (!buf) { status_out[i] = status; continue; }
      if (w == out_w && h == out_h) {
        memcpy(dst + i * stride, buf, stride);
      } else {
        resize(buf, w, h, dst + i * stride, out_w, out_h, channels);
      }
      free(buf);
      status_out[i] = 0;
    }
  };
  int nt = threads > 0 ? threads : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > n) nt = n > 0 ? n : 1;
  std::vector<std::thread> pool;
  for (int t = 0; t < nt; t++) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return 0;
}

// RGB, as the JAX tier's libpng/libjpeg path gives it (an RGBA PNG loses its alpha).
int gt_load_images(const char* paths, int n, int out_w, int out_h, int threads, uint8_t* dst, int32_t* status_out) {
  return load_images(paths, n, out_w, out_h, threads, 3, dst, status_out);
}

// RGBA, as Pillow's Image.open(p).convert("RGBA") gives it.
int gt_load_images_rgba(const char* paths, int n, int out_w, int out_h, int threads, uint8_t* dst,
                        int32_t* status_out) {
  return load_images(paths, n, out_w, out_h, threads, 4, dst, status_out);
}

// Probe an image's dimensions without full decode (JPEG header / PNG IHDR).
int gt_image_size(const char* path, int* w, int* h) {
  if (is_png(path)) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    uint8_t hdr[26];
    if (fread(hdr, 1, 26, f) != 26) { fclose(f); return -2; }
    fclose(f);
    *w = (hdr[16] << 24) | (hdr[17] << 16) | (hdr[18] << 8) | hdr[19];
    *h = (hdr[20] << 24) | (hdr[21] << 16) | (hdr[22] << 8) | hdr[23];
    return 0;
  }
  // The JPEG's SOFn, from the file's head (the whole file if it is further).
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  std::vector<uint8_t> head(1 << 16);
  head.resize(fread(head.data(), 1, head.size(), f));
  fclose(f);
  if (gt_jpeg_size(head.data(), head.size(), w, h) == 0) return 0;
  std::vector<uint8_t> buf;
  if (head.size() < (1 << 16) || !slurp(path, buf)) return -3;
  return gt_jpeg_size(buf.data(), buf.size(), w, h) == 0 ? 0 : -3;
}

// Why an image does not decode: writes the reason into msg (at most len
// bytes, "" when it decodes) and returns its decoder's status (0 when it
// decodes).
int gt_image_error(const char* path, char* msg, int len) {
  int w = 0, h = 0, status = 0;
  std::string why;
  uint8_t* out = decode_image(path, 3, &w, &h, &status, &why);
  free(out);
  snprintf(msg, (size_t)len, "%s", why.c_str());
  return status;
}

// An image's samples as Pillow opens it, the format told by its content
// (the PNG signature, else JPEG): info = {format (0 JPEG, 1 PNG), width,
// height, channels, depth}; *out a malloc'd buffer (gt_jpeg_samples,
// gt_png_samples). Returns 0, or the decoder's status with the reason in
// msg (at most len bytes).
int gt_image_samples(const char* path, int32_t* info, void** out, char* msg, int len) {
  std::vector<uint8_t> buf;
  std::string why;
  int w = 0, h = 0, channels = 0, depth = 8, status = -1;
  *out = nullptr;
  if (!slurp(path, buf)) {
    why = "cannot read the file";
  } else if (buf.size() >= 8 && memcmp(buf.data(), "\x89PNG\r\n\x1a\n", 8) == 0) {
    info[0] = 1;
    *out = gt_png_samples(buf.data(), buf.size(), &w, &h, &channels, &depth, &status, &why);
  } else {
    info[0] = 0;
    *out = gt_jpeg_samples(buf.data(), buf.size(), &w, &h, &channels, &status, &why);
  }
  info[1] = w;
  info[2] = h;
  info[3] = channels;
  info[4] = depth;
  snprintf(msg, (size_t)len, "%s", why.c_str());
  return *out ? 0 : status;
}

}  // extern "C"
