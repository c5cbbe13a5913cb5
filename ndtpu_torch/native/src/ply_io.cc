// libndtpu_io: multi-threaded text-PLY parser (the port's copy of
// ndtpu/native/src/ply_io.cc).
//
// Host-side reader of the training data. The reference parses PLY text one
// Python line at a time (ndnet/datasets/CARLA_Seg.py:115-137); this parser
// memory-maps the file, splits the body into per-thread byte ranges
// aligned to line boundaries, and parses rows with strtod.
//
// C ABI (ctypes-friendly):
//   ndtpu_ply_open(path, *n_vertices, *n_columns) -> handle (or NULL)
//   ndtpu_ply_read(handle, points_out[3N], classes_out[N]) -> 0, or -1
//     when the body holds fewer than N rows
//   ndtpu_ply_close(handle)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct PlyFile {
  int fd = -1;
  const char* data = nullptr;
  size_t size = 0;
  size_t body_offset = 0;
  int64_t n_vertices = -1;
  int n_columns = 0;
};

// Find end of header; fills n_vertices. Returns offset past "end_header\n".
bool parse_header(PlyFile* f) {
  const char* p = f->data;
  const char* end = f->data + f->size;
  if (f->size < 4 || strncmp(p, "ply", 3) != 0) return false;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!nl) return false;
    if (!strncmp(p, "element vertex", 14)) {
      f->n_vertices = strtoll(p + 14, nullptr, 10);
    }
    if (!strncmp(p, "end_header", 10)) {
      f->body_offset = (nl + 1) - f->data;
      return true;
    }
    p = nl + 1;
  }
  return false;
}

// Count whitespace-separated fields in the first body line.
int count_columns(const PlyFile* f) {
  const char* p = f->data + f->body_offset;
  const char* end = f->data + f->size;
  int cols = 0;
  bool in_tok = false;
  while (p < end && *p != '\n') {
    bool ws = (*p == ' ' || *p == '\t' || *p == '\r');
    if (!ws && !in_tok) { cols++; in_tok = true; }
    if (ws) in_tok = false;
    p++;
  }
  return cols;
}

// Parse rows in [begin, end); begin must point at a line start. Stores
// the number of rows parsed in *parsed.
void parse_range(const char* begin, const char* end, int n_columns,
                 int64_t row0, int64_t max_rows,
                 double* points, uint16_t* classes, int64_t* parsed) {
  const char* p = begin;
  int64_t row = row0;
  while (p < end && row < max_rows) {
    char* next = nullptr;
    double x = strtod(p, &next);
    if (next == p) break;  // no progress — blank tail
    p = next;
    double y = strtod(p, &next); p = next;
    double z = strtod(p, &next); p = next;
    double last = z;
    for (int c = 3; c < n_columns; ++c) {
      last = strtod(p, &next);
      p = next;
    }
    points[row * 3 + 0] = x;
    points[row * 3 + 1] = y;
    points[row * 3 + 2] = z;
    if (classes) {
      classes[row] = n_columns > 3 ? static_cast<uint16_t>(last) : 0;
    }
    row++;
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!nl) break;
    p = nl + 1;
  }
  *parsed = row - row0;
}

}  // namespace

extern "C" {

void* ndtpu_ply_open(const char* path, int64_t* n_vertices, int* n_columns) {
  PlyFile* f = new PlyFile();
  f->fd = open(path, O_RDONLY);
  if (f->fd < 0) { delete f; return nullptr; }
  struct stat st;
  if (fstat(f->fd, &st) != 0 || st.st_size == 0) {
    close(f->fd); delete f; return nullptr;
  }
  f->size = static_cast<size_t>(st.st_size);
  void* m = mmap(nullptr, f->size, PROT_READ, MAP_PRIVATE, f->fd, 0);
  if (m == MAP_FAILED) { close(f->fd); delete f; return nullptr; }
  f->data = static_cast<const char*>(m);
  if (!parse_header(f)) {
    munmap(const_cast<char*>(f->data), f->size);
    close(f->fd); delete f; return nullptr;
  }
  f->n_columns = count_columns(f);
  if (f->n_vertices < 0) {
    // count lines in the body
    const char* p = f->data + f->body_offset;
    const char* end = f->data + f->size;
    int64_t n = 0;
    while (p < end) {
      const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
      if (!nl) { if (end - p > 1) n++; break; }
      n++; p = nl + 1;
    }
    f->n_vertices = n;
  }
  *n_vertices = f->n_vertices;
  *n_columns = f->n_columns;
  return f;
}

int ndtpu_ply_read(void* handle, double* points, uint16_t* classes) {
  PlyFile* f = static_cast<PlyFile*>(handle);
  if (!f || !f->data) return -1;
  const char* body = f->data + f->body_offset;
  const char* end = f->data + f->size;
  size_t body_size = end - body;

  unsigned n_threads = std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  if (n_threads > 16) n_threads = 16;
  if (f->n_vertices < 4096) n_threads = 1;

  if (n_threads == 1) {
    int64_t parsed = 0;
    parse_range(body, end, f->n_columns, 0, f->n_vertices, points, classes,
                &parsed);
    return parsed == f->n_vertices ? 0 : -1;
  }

  // split body into line-aligned chunks; count rows before each chunk so
  // every thread knows its starting row index
  std::vector<const char*> starts{body};
  for (unsigned t = 1; t < n_threads; ++t) {
    const char* guess = body + (body_size * t) / n_threads;
    const char* nl = static_cast<const char*>(
        memchr(guess, '\n', end - guess));
    starts.push_back(nl ? nl + 1 : end);
  }
  starts.push_back(end);

  std::vector<int64_t> row0(n_threads, 0);
  for (unsigned t = 1; t < n_threads; ++t) {
    // count newlines in previous chunk
    int64_t rows = 0;
    const char* p = starts[t - 1];
    while (p < starts[t]) {
      const char* nl = static_cast<const char*>(
          memchr(p, '\n', starts[t] - p));
      if (!nl) { if (starts[t] - p > 1) rows++; break; }
      rows++; p = nl + 1;
    }
    row0[t] = row0[t - 1] + rows;
  }

  std::vector<int64_t> parsed(n_threads, 0);
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < n_threads; ++t) {
    threads.emplace_back(parse_range, starts[t], starts[t + 1], f->n_columns,
                         row0[t], f->n_vertices, points, classes,
                         &parsed[t]);
  }
  for (auto& th : threads) th.join();
  int64_t total = 0;
  for (int64_t rows : parsed) total += rows;
  return total == f->n_vertices ? 0 : -1;
}

void ndtpu_ply_close(void* handle) {
  PlyFile* f = static_cast<PlyFile*>(handle);
  if (!f) return;
  if (f->data) munmap(const_cast<char*>(f->data), f->size);
  if (f->fd >= 0) close(f->fd);
  delete f;
}

}  // extern "C"
