// Native host data path of langsplatv2_tpu_torch (a copy of the JAX
// package's native/feature_loader.cpp: the port imports nothing of it).
//
// Each language-feature training iteration of the reference pays a Python
// cost: np.load of the seg map and the feature table, a nearest-neighbour
// resize and a fancy-indexing gather to a [512, H, W] feature image
// (reference scene/cameras.py:59-96). This loader memory-maps the .npy
// files, nearest-resizes the chosen SAM level's seg row and gathers the
// per-pixel CLIP features straight into a caller buffer, parallel over
// pixel rows. Exposed through ctypes (langsplatv2_tpu_torch/native/
// __init__.py); a numpy path keeps the package working without a
// compiler.
//
// Also a COLMAP points3D.bin reader (reference
// scene/colmap_loader.py:125-179), the other host-side parse that scales
// with scene size.
//
// Built with the host g++ at first use (-O3 -shared -fPIC) into
// build/langsplatv2_tpu_torch/native/.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyArray {
  void* map_base = nullptr;   // mmap base (munmap target)
  size_t map_len = 0;
  const char* data = nullptr; // first element
  char dtype = 0;             // 'f' float, 'i' int, 'u' uint
  int itemsize = 0;
  std::vector<int64_t> shape;

  ~NpyArray() {
    if (map_base) munmap(map_base, map_len);
  }
};

// Minimal .npy v1/v2 header parser (little-endian, C-order only).
bool npy_open(const char* path, NpyArray* out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return false;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return false; }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return false;
  const unsigned char* p = static_cast<const unsigned char*>(base);
  if (st.st_size < 10 || memcmp(p, "\x93NUMPY", 6) != 0) {
    munmap(base, st.st_size);
    return false;
  }
  int major = p[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = p[8] | (p[9] << 8);
    header_off = 10;
  } else {
    header_len = p[8] | (p[9] << 8) | (size_t(p[10]) << 16) | (size_t(p[11]) << 24);
    header_off = 12;
  }
  std::string header(reinterpret_cast<const char*>(p + header_off), header_len);
  if (header.find("'fortran_order': True") != std::string::npos) {
    munmap(base, st.st_size);
    return false;
  }
  size_t dpos = header.find("'descr':");
  if (dpos == std::string::npos) { munmap(base, st.st_size); return false; }
  size_t q1 = header.find('\'', dpos + 8);
  size_t q2 = header.find('\'', q1 + 1);
  std::string descr = header.substr(q1 + 1, q2 - q1 - 1);  // e.g. "<f4"
  if (descr.size() < 3 || (descr[0] != '<' && descr[0] != '|')) {
    munmap(base, st.st_size);
    return false;
  }
  out->dtype = descr[1];
  out->itemsize = atoi(descr.c_str() + 2);
  size_t spos = header.find("'shape':");
  size_t o1 = header.find('(', spos);
  size_t o2 = header.find(')', o1);
  std::string dims = header.substr(o1 + 1, o2 - o1 - 1);
  out->shape.clear();
  const char* cur = dims.c_str();
  while (*cur) {
    while (*cur == ' ' || *cur == ',') cur++;
    if (!*cur) break;
    out->shape.push_back(strtoll(cur, const_cast<char**>(&cur), 10));
  }
  out->map_base = base;
  out->map_len = st.st_size;
  out->data = reinterpret_cast<const char*>(p) + header_off + header_len;
  return true;
}

inline float half_to_float(uint16_t h) {
  uint32_t sign = (h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t man = h & 0x3ffu;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;
    } else {  // subnormal
      exp = 127 - 15 + 1;
      while (!(man & 0x400u)) { man <<= 1; exp--; }
      man &= 0x3ffu;
      bits = sign | (exp << 23) | (man << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7f800000u | (man << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float f;
  memcpy(&f, &bits, 4);
  return f;
}

inline int64_t seg_at(const NpyArray& seg, int level, int64_t y, int64_t x) {
  int64_t h = seg.shape[1], w = seg.shape[2];
  int64_t idx = (int64_t)level * h * w + y * w + x;
  switch (seg.itemsize) {
    case 1: return reinterpret_cast<const int8_t*>(seg.data)[idx];
    case 2: return reinterpret_cast<const int16_t*>(seg.data)[idx];
    case 4: return reinterpret_cast<const int32_t*>(seg.data)[idx];
    default: return reinterpret_cast<const int64_t*>(seg.data)[idx];
  }
}

}  // namespace

extern "C" {

// Load one view's language feature image.
//   seg_path:  <image>_s.npy  [L, h, w] int  (-1 = unassigned)
//   feat_path: <image>_f.npy  [N, D] float32/float16
//   level: SAM granularity row, H/W: target (camera) resolution.
//   out_feat: [D, H, W] float32 (caller-allocated)
//   out_mask: [H, W] uint8 (caller-allocated)
// Returns D on success, -1 on failure.
int64_t lsv2_load_language_feature(
    const char* seg_path, const char* feat_path, int level,
    int64_t H, int64_t W, float* out_feat, uint8_t* out_mask) {
  NpyArray seg, feat;
  if (!npy_open(seg_path, &seg) || seg.shape.size() != 3 ||
      (seg.dtype != 'i' && seg.dtype != 'u')) return -1;
  if (!npy_open(feat_path, &feat) || feat.shape.size() != 2 ||
      feat.dtype != 'f') return -1;
  if (level < 0 || level >= seg.shape[0]) return -1;
  const int64_t n_seg = feat.shape[0], D = feat.shape[1];
  const int64_t sh = seg.shape[1], sw = seg.shape[2];
  const bool f16 = feat.itemsize == 2;
  const float* f32 = reinterpret_cast<const float*>(feat.data);
  const uint16_t* f16p = reinterpret_cast<const uint16_t*>(feat.data);

  int n_threads = std::max(1u, std::thread::hardware_concurrency());
  n_threads = std::min<int64_t>(n_threads, H);
  std::vector<std::thread> ts;
  ts.reserve(n_threads);
  for (int t = 0; t < n_threads; t++) {
    ts.emplace_back([&, t]() {
      for (int64_t y = t; y < H; y += n_threads) {
        // cv2.INTER_NEAREST source index: floor(dst * src / dst_size).
        int64_t sy = std::min<int64_t>(sh - 1, (int64_t)((double)y * sh / H));
        for (int64_t x = 0; x < W; x++) {
          int64_t sx = std::min<int64_t>(sw - 1, (int64_t)((double)x * sw / W));
          int64_t s = seg_at(seg, level, sy, sx);
          bool valid = s >= 0 && s < n_seg;
          out_mask[y * W + x] = s != -1;
          int64_t row = valid ? s : (s < 0 ? (n_seg + (s % n_seg)) % n_seg : 0);
          // (negative rows wrap like numpy fancy indexing; masked anyway)
          for (int64_t d = 0; d < D; d++) {
            float v = f16 ? half_to_float(f16p[row * D + d])
                          : f32[row * D + d];
            out_feat[d * H * W + y * W + x] = v;
          }
        }
      }
    });
  }
  for (auto& th : ts) th.join();
  return D;
}

// Read COLMAP points3D.bin: returns point count, fills caller arrays if
// capacity suffices (xyz [n,3] f64, rgb [n,3] u8, error [n] f64).
// Call once with capacity 0 to query the count.
int64_t lsv2_read_points3d_bin(
    const char* path, int64_t capacity,
    double* xyz, uint8_t* rgb, double* error) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint64_t n;
  if (fread(&n, 8, 1, f) != 1) { fclose(f); return -1; }
  if (capacity < (int64_t)n) { fclose(f); return (int64_t)n; }
  std::vector<char> buf;
  for (uint64_t i = 0; i < n; i++) {
    uint64_t pid;
    double v[3];
    uint8_t c[3];
    double err;
    uint64_t track_len;
    if (fread(&pid, 8, 1, f) != 1 || fread(v, 8, 3, f) != 3 ||
        fread(c, 1, 3, f) != 3 || fread(&err, 8, 1, f) != 1) {
      fclose(f);
      return -1;
    }
    memcpy(xyz + i * 3, v, 24);
    memcpy(rgb + i * 3, c, 3);
    error[i] = err;
    if (fread(&track_len, 8, 1, f) != 1) { fclose(f); return -1; }
    if (fseek(f, (long)(track_len * 8), SEEK_CUR) != 0) { fclose(f); return -1; }
  }
  fclose(f);
  return (int64_t)n;
}

}  // extern "C"
