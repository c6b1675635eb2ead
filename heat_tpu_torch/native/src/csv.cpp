// Native CSV parser for heat_tpu_torch (the port's own copy of
// heat_tpu/native/src/csv.cpp).
//
// Replaces a per-rank Python byte-range CSV parser (Heat's load_csv splits
// the file by byte offsets and parses lines with Python `float()`). Here the
// whole file is mmap'ed once, row boundaries are found with memchr, and rows
// are parsed in parallel with std::from_chars into a caller-provided numeric
// buffer.
//
// C ABI (ctypes-friendly), all functions return 0 on success or a negative
// error code:
//   -1 open/stat/mmap failure        -2 malformed number
//   -3 inconsistent column count     -4 bad arguments
#include <atomic>
#include <charconv>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Mapped {
  const char *data = nullptr;
  size_t size = 0;
  int fd = -1;
};

bool map_file(const char *path, Mapped &m) {
  m.fd = ::open(path, O_RDONLY);
  if (m.fd < 0) return false;
  struct stat st;
  if (::fstat(m.fd, &st) != 0) {
    ::close(m.fd);
    return false;
  }
  m.size = static_cast<size_t>(st.st_size);
  if (m.size == 0) {
    m.data = nullptr;
    return true;
  }
  void *p = ::mmap(nullptr, m.size, PROT_READ, MAP_PRIVATE, m.fd, 0);
  if (p == MAP_FAILED) {
    ::close(m.fd);
    return false;
  }
  m.data = static_cast<const char *>(p);
  return true;
}

void unmap_file(Mapped &m) {
  if (m.data) ::munmap(const_cast<char *>(m.data), m.size);
  if (m.fd >= 0) ::close(m.fd);
}

struct Line {
  const char *begin;
  const char *end;  // exclusive, '\r' already trimmed
};

// Collect non-empty data lines after skipping `header_lines`.
void collect_lines(const char *data, size_t size, int64_t header_lines,
                   std::vector<Line> &lines) {
  const char *p = data;
  const char *limit = data + size;
  for (int64_t h = 0; h < header_lines && p < limit; ++h) {
    const char *nl = static_cast<const char *>(memchr(p, '\n', limit - p));
    p = nl ? nl + 1 : limit;
  }
  while (p < limit) {
    const char *nl = static_cast<const char *>(memchr(p, '\n', limit - p));
    const char *end = nl ? nl : limit;
    const char *trimmed = end;
    while (trimmed > p && (trimmed[-1] == '\r' || trimmed[-1] == ' '))
      --trimmed;
    if (trimmed > p) lines.push_back({p, trimmed});
    p = nl ? nl + 1 : limit;
  }
}

// Collect the data lines OWNED by the byte range [offset, offset+length)
// (file-absolute offsets; pass length < 0 for "to EOF").  Header lines are
// skipped first.  Ownership follows the reference's per-rank byte-range
// convention (Heat's load_csv): a line belongs to the
// range containing its FIRST byte, and its owner parses it to the end even
// when it straddles the range boundary — so ranges that partition the file
// yield disjoint, covering row sets.
void collect_lines_range(const char *data, size_t size, int64_t header_lines,
                         int64_t offset, int64_t length,
                         std::vector<Line> &lines) {
  const char *p = data;
  const char *limit = data + size;
  for (int64_t h = 0; h < header_lines && p < limit; ++h) {
    const char *nl = static_cast<const char *>(memchr(p, '\n', limit - p));
    p = nl ? nl + 1 : limit;
  }
  if (offset < 0) offset = 0;
  const char *lo = data + (static_cast<size_t>(offset) > size
                               ? size
                               : static_cast<size_t>(offset));
  const char *hi = limit;
  if (length >= 0 && static_cast<size_t>(offset) + static_cast<size_t>(length) < size)
    hi = data + offset + length;
  if (p < lo) {
    // first owned line begins at the first byte after a '\n' at or past
    // lo-1 (data[lo-1]=='\n' means a line starts exactly at lo)
    const char *scan = lo - 1;
    const char *nl = static_cast<const char *>(memchr(scan, '\n', limit - scan));
    p = nl ? nl + 1 : limit;
  }
  while (p < limit && p < hi) {
    const char *nl = static_cast<const char *>(memchr(p, '\n', limit - p));
    const char *end = nl ? nl : limit;
    const char *trimmed = end;
    while (trimmed > p && (trimmed[-1] == '\r' || trimmed[-1] == ' '))
      --trimmed;
    if (trimmed > p) lines.push_back({p, trimmed});
    p = nl ? nl + 1 : limit;
  }
}

int64_t count_fields(const Line &ln, char sep) {
  int64_t n = 1;
  for (const char *p = ln.begin; p < ln.end; ++p)
    if (*p == sep) ++n;
  return n;
}

// Parse one row into out[0..cols); returns 0, -2 or -3.
template <typename T>
int parse_row(const Line &ln, char sep, T *out, int64_t cols) {
  const char *p = ln.begin;
  for (int64_t c = 0; c < cols; ++c) {
    const char *fend = static_cast<const char *>(
        memchr(p, sep, ln.end - p));
    if (!fend) fend = ln.end;
    if (c == cols - 1 && fend != ln.end) return -3;  // too many fields
    if (c < cols - 1 && fend == ln.end) return -3;   // too few fields
    while (p < fend && (*p == ' ' || *p == '\t')) ++p;
    const char *vend = fend;
    while (vend > p && (vend[-1] == ' ' || vend[-1] == '\t')) --vend;
    // std::from_chars rejects an explicit leading '+', which Python's
    // float() (Heat's parser) accepts; skip it. Underscore numerals ("1_5")
    // still return -2 here and reach the Python route, whose last-resort
    // per-field float() pass (core/io.py load_csv) parses them like Heat
    if (p + 1 < vend && *p == '+' && *(p + 1) != '-') ++p;
    double v;
    auto res = std::from_chars(p, vend, v);
    if (res.ec != std::errc() || res.ptr != vend) return -2;
    if (v != v) {
      // from_chars accepts "nan(123)" but Python float() raises on the
      // parenthesized form; divert it so native never parses what the
      // reference rejects (bare "nan" stays accepted — float() takes it)
      for (const char *q = p; q < vend; ++q)
        if (*q == '(') return -2;
    }
    out[c] = static_cast<T>(v);
    p = fend + 1;
  }
  return 0;
}

template <typename T>
int64_t parse_all(const std::vector<Line> &lines, char sep, T *out,
                  int64_t rows, int64_t cols, int32_t nthreads) {
  if (static_cast<int64_t>(lines.size()) != rows) return -3;
  if (nthreads < 1) nthreads = 1;
  int64_t hw = static_cast<int64_t>(std::thread::hardware_concurrency());
  if (hw > 0 && nthreads > hw) nthreads = static_cast<int32_t>(hw);
  if (nthreads > rows) nthreads = rows > 0 ? static_cast<int32_t>(rows) : 1;
  std::atomic<int> err{0};
  auto work = [&](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1 && err.load(std::memory_order_relaxed) == 0;
         ++r) {
      int rc = parse_row(lines[r], sep, out + r * cols, cols);
      if (rc != 0) err.store(rc, std::memory_order_relaxed);
    }
  };
  if (nthreads == 1) {
    work(0, rows);
  } else {
    std::vector<std::thread> ts;
    int64_t per = (rows + nthreads - 1) / nthreads;
    for (int32_t t = 0; t < nthreads; ++t) {
      int64_t r0 = t * per;
      int64_t r1 = std::min(rows, r0 + per);
      if (r0 >= r1) break;
      ts.emplace_back(work, r0, r1);
    }
    for (auto &t : ts) t.join();
  }
  return err.load();
}

}  // namespace

extern "C" {

int64_t ht_csv_dims(const char *path, int64_t header_lines, char sep,
                    int64_t *rows, int64_t *cols) {
  if (!path || !rows || !cols) return -4;
  Mapped m;
  if (!map_file(path, m)) return -1;
  std::vector<Line> lines;
  if (m.data) collect_lines(m.data, m.size, header_lines, lines);
  *rows = static_cast<int64_t>(lines.size());
  *cols = lines.empty() ? 0 : count_fields(lines.front(), sep);
  unmap_file(m);
  return 0;
}

// Handle-based one-pass API: mmap + line index built once, reused by the
// parse call so large files are not scanned twice for dims then data.
struct CsvHandle {
  Mapped m;
  std::vector<Line> lines;
  int64_t cols = 0;
};

void *ht_csv_open(const char *path, int64_t header_lines, char sep,
                  int64_t *rows, int64_t *cols) {
  if (!path || !rows || !cols) return nullptr;
  CsvHandle *h = new CsvHandle();
  if (!map_file(path, h->m)) {
    delete h;
    return nullptr;
  }
  if (h->m.data) collect_lines(h->m.data, h->m.size, header_lines, h->lines);
  h->cols = h->lines.empty() ? 0 : count_fields(h->lines.front(), sep);
  *rows = static_cast<int64_t>(h->lines.size());
  *cols = h->cols;
  return h;
}

// Range variant of ht_csv_open: only the lines owned by byte range
// [offset, offset+length) are indexed (length < 0 -> to EOF).  The handle
// feeds the same ht_csv_parse_h / ht_csv_close.
void *ht_csv_open_range(const char *path, int64_t header_lines, char sep,
                        int64_t offset, int64_t length, int64_t *rows,
                        int64_t *cols) {
  if (!path || !rows || !cols) return nullptr;
  CsvHandle *h = new CsvHandle();
  if (!map_file(path, h->m)) {
    delete h;
    return nullptr;
  }
  if (h->m.data)
    collect_lines_range(h->m.data, h->m.size, header_lines, offset, length,
                        h->lines);
  h->cols = h->lines.empty() ? 0 : count_fields(h->lines.front(), sep);
  *rows = static_cast<int64_t>(h->lines.size());
  *cols = h->cols;
  return h;
}

int64_t ht_csv_parse_h(void *handle, char sep, int32_t dtype, void *out,
                       int64_t rows, int64_t cols, int32_t nthreads) {
  if (!handle || !out || rows < 0 || cols <= 0) return -4;
  CsvHandle *h = static_cast<CsvHandle *>(handle);
  if (dtype == 0)
    return parse_all(h->lines, sep, static_cast<float *>(out), rows, cols,
                     nthreads);
  if (dtype == 1)
    return parse_all(h->lines, sep, static_cast<double *>(out), rows, cols,
                     nthreads);
  return -4;
}

void ht_csv_close(void *handle) {
  if (!handle) return;
  CsvHandle *h = static_cast<CsvHandle *>(handle);
  unmap_file(h->m);
  delete h;
}

}  // extern "C"
