// Native data loader: IDX (MNIST) and numeric-CSV parsing.
//
// The host-side readers of deeplearning4j_tpu_torch's builtin datasets: the
// IDX files of MNIST (`datasets/mnist.py` read_idx) and numeric CSVs
// (`datasets/fetchers.py` CSVDataFetcher). The parse runs off the Python
// interpreter, and the CSV parse is split across row ranges with
// std::thread. Each caller keeps a pure-Python path that gives the same
// arrays.
//
// C ABI only: loaded from Python with ctypes (`native/__init__.py`), built
// with g++ into deeplearning4j_tpu_torch/_build/.

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct FileBuf {
  std::vector<char> data;
  bool ok = false;
};

FileBuf read_file(const char* path) {
  FileBuf fb;
  FILE* f = std::fopen(path, "rb");
  if (!f) return fb;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n < 0) {
    std::fclose(f);
    return fb;
  }
  fb.data.resize(static_cast<size_t>(n));
  size_t got = n ? std::fread(fb.data.data(), 1, static_cast<size_t>(n), f) : 0;
  std::fclose(f);
  fb.ok = (got == static_cast<size_t>(n));
  return fb;
}

inline uint32_t be32(const unsigned char* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

}  // namespace

extern "C" {

// Reads the IDX header.  Returns the dtype code (0x08 = u8, ...) on
// success, -1 on IO error, -2 on malformed header.  Writes ndim and dims.
int dl4j_idx_header(const char* path, int* ndim, int64_t* dims /*cap 8*/) {
  FileBuf fb = read_file(path);
  if (!fb.ok || fb.data.size() < 4) return -1;
  const unsigned char* p = reinterpret_cast<unsigned char*>(fb.data.data());
  if (p[0] != 0 || p[1] != 0) return -2;
  int dtype = p[2];
  int nd = p[3];
  if (nd <= 0 || nd > 8 || fb.data.size() < size_t(4 + 4 * nd)) return -2;
  *ndim = nd;
  for (int i = 0; i < nd; ++i) dims[i] = be32(p + 4 + 4 * i);
  return dtype;
}

// Reads the IDX payload (u8 only) into out.  Returns bytes written, or
// negative error.
int64_t dl4j_idx_read(const char* path, uint8_t* out, int64_t cap) {
  FileBuf fb = read_file(path);
  if (!fb.ok || fb.data.size() < 4) return -1;
  const unsigned char* p = reinterpret_cast<unsigned char*>(fb.data.data());
  if (p[0] != 0 || p[1] != 0 || p[2] != 0x08) return -2;
  int nd = p[3];
  if (nd <= 0 || nd > 8 || fb.data.size() < size_t(4 + 4 * nd)) return -2;
  int64_t total = 1;
  for (int i = 0; i < nd; ++i) total *= be32(p + 4 + 4 * i);
  size_t off = 4 + 4 * size_t(nd);
  if (fb.data.size() - off < size_t(total) || total > cap) return -3;
  std::memcpy(out, fb.data.data() + off, size_t(total));
  return total;
}

// First pass over a numeric CSV: row/column count (after optional header).
// Returns 0 on success, -1 IO error, -2 ragged/invalid.
int dl4j_csv_dims(const char* path, int skip_header, int64_t* rows,
                  int64_t* cols) {
  FileBuf fb = read_file(path);
  if (!fb.ok) return -1;
  const char* s = fb.data.data();
  const char* end = s + fb.data.size();
  int64_t r = 0, c = -1;
  int skipped = 0;
  while (s < end) {
    const char* nl = static_cast<const char*>(
        std::memchr(s, '\n', size_t(end - s)));
    const char* line_end = nl ? nl : end;
    if (line_end > s) {  // non-empty line
      if (skip_header && !skipped) {
        skipped = 1;
      } else {
        int64_t nc = 1;
        for (const char* q = s; q < line_end; ++q)
          if (*q == ',') ++nc;
        if (c < 0) c = nc;
        else if (c != nc) return -2;
        ++r;
      }
    }
    if (!nl) break;
    s = nl + 1;
  }
  *rows = r;
  *cols = c < 0 ? 0 : c;
  return 0;
}

namespace {

// Parses rows [r0, r1) given precomputed line offsets.  Returns false on a
// non-numeric field (caller falls back to Python).
bool parse_rows(const char* base, const std::vector<const char*>& starts,
                const std::vector<const char*>& ends, int64_t r0, int64_t r1,
                int64_t cols, float* out, std::atomic<bool>* bad) {
  for (int64_t r = r0; r < r1; ++r) {
    const char* s = starts[size_t(r)];
    const char* line_end = ends[size_t(r)];
    for (int64_t c = 0; c < cols; ++c) {
      char* next = nullptr;
      // empty field (s at the separator/newline) or strtod running past
      // the line (it skips '\n' as whitespace) must reject, not fabricate
      double v = (s < line_end) ? std::strtod(s, &next) : 0.0;
      if (next == s || next == nullptr || next > line_end) {
        bad->store(true, std::memory_order_relaxed);
        return false;
      }
      out[r * cols + c] = static_cast<float>(v);
      s = next;
      while (s < line_end && (*s == ',' || *s == ' ' || *s == '\t')) ++s;
    }
  }
  return true;
}

}  // namespace

// Parses a numeric CSV into a row-major float32 buffer of [rows, cols]
// (shape from dl4j_csv_dims).  Returns 0 on success, -2 on non-numeric
// field, -1 on IO error.  nthreads <= 0 picks hardware concurrency.
int dl4j_csv_read(const char* path, int skip_header, float* out, int64_t rows,
                  int64_t cols, int nthreads) {
  FileBuf fb = read_file(path);
  if (!fb.ok) return -1;
  // NUL-terminate so strtod can't run off the buffer on the last line.
  fb.data.push_back('\0');
  const char* s = fb.data.data();
  const char* end = s + fb.data.size() - 1;
  std::vector<const char*> starts, ends;
  starts.reserve(size_t(rows));
  ends.reserve(size_t(rows));
  int skipped = 0;
  while (s < end && int64_t(starts.size()) < rows) {
    const char* nl = static_cast<const char*>(
        std::memchr(s, '\n', size_t(end - s)));
    const char* line_end = nl ? nl : end;
    if (line_end > s) {
      if (skip_header && !skipped) {
        skipped = 1;
      } else {
        starts.push_back(s);
        ends.push_back(line_end);
      }
    }
    if (!nl) break;
    s = nl + 1;
  }
  if (int64_t(starts.size()) != rows) return -2;
  int nt = nthreads > 0 ? nthreads
                        : int(std::thread::hardware_concurrency());
  if (nt < 1) nt = 1;
  if (int64_t(nt) > rows) nt = int(rows ? rows : 1);
  std::atomic<bool> bad{false};
  if (nt == 1) {
    parse_rows(fb.data.data(), starts, ends, 0, rows, cols, out, &bad);
  } else {
    std::vector<std::thread> ts;
    int64_t chunk = (rows + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
      int64_t r0 = t * chunk, r1 = std::min<int64_t>(rows, r0 + chunk);
      if (r0 >= r1) break;
      ts.emplace_back([&, r0, r1] {
        parse_rows(fb.data.data(), starts, ends, r0, r1, cols, out, &bad);
      });
    }
    for (auto& th : ts) th.join();
  }
  return bad.load() ? -2 : 0;
}

}  // extern "C"
