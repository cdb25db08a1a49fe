// Native batch-assembly core for the feature pipeline.
//
// Role: the hot host-side path of the data layer — per-batch .npy feature
// reads + zero-padded batch assembly.  The reference does this with python
// np.load calls inside DataLoader worker processes per batch
// (reference data/dataset.py:146-151, 162-176); here a C++ thread pool
// parses the npy headers and streams each file's payload directly into its
// slice of the final padded batch buffer — one pass, no intermediate
// arrays, no GIL.
//
// Exposed C ABI (consumed via ctypes from bist_tpu_torch/native/loader.py):
//   npy_header_probe(path, int64 shape_out[8]) -> ndim (or -errno)
//   assemble_f32_batch(paths, n_items, t_pad, row_elems, out, n_threads)
//       -> 0 on success; each item i is a float32 .npy of shape
//          (T_i, ...) with prod(tail shape) == row_elems; rows T_i..t_pad-1
//          are zero-filled.  Items whose T_i > t_pad are truncated.
//
// Build (loader.py, at first use, into build/bist_tpu_torch/):
//   g++ -O3 -shared -fPIC npy_loader.cpp -o npyloader-<hash>.so -lpthread

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyInfo {
  int64_t shape[8];
  int ndim = 0;
  long header_bytes = 0;
  bool is_f32 = false;
  bool fortran = false;
};

// Parse a .npy v1/v2 header already read into `buf`.
bool parse_header(const char* buf, size_t len, NpyInfo* info) {
  if (len < 10 || memcmp(buf, "\x93NUMPY", 6) != 0) return false;
  int major = buf[6];
  size_t hlen, hstart;
  if (major == 1) {
    hlen = *reinterpret_cast<const uint16_t*>(buf + 8);
    hstart = 10;
  } else {
    hlen = *reinterpret_cast<const uint32_t*>(buf + 8);
    hstart = 12;
  }
  if (hstart + hlen > len) return false;
  std::string h(buf + hstart, hlen);
  info->header_bytes = static_cast<long>(hstart + hlen);
  info->is_f32 = h.find("'descr': '<f4'") != std::string::npos ||
                 h.find("'descr':'<f4'") != std::string::npos;
  info->fortran = h.find("'fortran_order': True") != std::string::npos;
  size_t sp = h.find("'shape':");
  if (sp == std::string::npos) return false;
  size_t open = h.find('(', sp);
  size_t close = h.find(')', open);
  if (open == std::string::npos || close == std::string::npos) return false;
  std::string dims = h.substr(open + 1, close - open - 1);
  info->ndim = 0;
  const char* p = dims.c_str();
  while (*p && info->ndim < 8) {
    while (*p == ' ' || *p == ',') p++;
    if (!*p) break;
    info->shape[info->ndim++] = strtoll(p, const_cast<char**>(&p), 10);
  }
  return true;
}

bool read_header_file(const char* path, NpyInfo* info) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  char buf[4096];
  size_t n = fread(buf, 1, sizeof(buf), f);
  bool ok = parse_header(buf, n, info);
  fclose(f);
  return ok;
}

}  // namespace

extern "C" {

// Probe shape: returns ndim (>0) and fills shape_out, or -1 on failure.
int npy_header_probe(const char* path, int64_t* shape_out) {
  NpyInfo info;
  if (!read_header_file(path, &info)) return -1;
  for (int i = 0; i < info.ndim; i++) shape_out[i] = info.shape[i];
  return info.ndim;
}

// Read one f32 .npy into out[0:rows*row_elems], zero-padding rows beyond the
// file's leading dim, truncating beyond t_pad.  Returns rows read or -1.
static long load_one(const char* path, float* out, long t_pad,
                     long row_elems) {
  NpyInfo info;
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char buf[4096];
  size_t n = fread(buf, 1, sizeof(buf), f);
  if (!parse_header(buf, n, &info) || !info.is_f32 || info.fortran ||
      info.ndim < 1) {
    fclose(f);
    return -1;
  }
  long t = info.shape[0];
  long tail = 1;
  for (int i = 1; i < info.ndim; i++) tail *= info.shape[i];
  if (tail != row_elems) {
    fclose(f);
    return -1;
  }
  long rows = t < t_pad ? t : t_pad;
  if (fseek(f, info.header_bytes, SEEK_SET) != 0) {
    fclose(f);
    return -1;
  }
  size_t want = static_cast<size_t>(rows) * row_elems;
  size_t got = fread(out, sizeof(float), want, f);
  fclose(f);
  if (got != want) return -1;
  if (rows < t_pad) {
    memset(out + want, 0,
           sizeof(float) * static_cast<size_t>(t_pad - rows) * row_elems);
  }
  return rows;
}

// Assemble a zero-padded (n_items, t_pad, row_elems) f32 batch from npy
// files, in parallel.  Returns 0 on success, else the 1-based index of the
// first failed item (negated).
int assemble_f32_batch(const char** paths, int n_items, long t_pad,
                       long row_elems, float* out, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0), failed(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_items || failed.load() != 0) return;
      float* dst = out + static_cast<size_t>(i) * t_pad * row_elems;
      if (load_one(paths[i], dst, t_pad, row_elems) < 0) failed.store(i + 1);
    }
  };
  std::vector<std::thread> threads;
  int nt = n_threads < n_items ? n_threads : n_items;
  for (int t = 0; t < nt; t++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return -failed.load();
}

}  // extern "C"
