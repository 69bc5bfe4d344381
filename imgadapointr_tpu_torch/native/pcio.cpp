// pcio: native point-cloud file IO and host-side sampling for the data loader.
//
// The port's own copy of the JAX package's reader (native/pcio.cpp), bound
// by imgadapointr_tpu_torch/datasets/native_io.py through ctypes: a call
// releases the GIL, so loader threads read files in parallel.
//
// Exposed C ABI:
//   pcio_read_cloud(path, out, capacity) -> n_points (xyz interleaved f32);
//       -1 for a file it cannot parse (the caller's Python parser takes it),
//       -2 for one that declares more than capacity points
//   pcio_declared_points(path) -> the point count a file's header declares
//   pcio_sample(points, n, out, n_out, seed) -> random permutation sample
//       with zero-padding (== datasets.transforms.RandomSamplePoints)
//   pcio_load_batch(paths, batch, out, n_points, seed, raw_capacity) ->
//       parallel read+sample of a whole batch into one contiguous buffer
//
// Supported formats: PCD v0.7 (ascii / binary), PLY (ascii /
// binary_little_endian), NPY ('<f4' or '<f8', shape (N, 3), C order).
//
// Differences from the JAX package's copy, each so that a file reads into
// the bits the port's Python parsers (utils/io_module.py) give: ASCII
// values are parsed by strtod to double and then rounded to float, as
// numpy's parsers do (the JAX copy's operator>> parses straight to float);
// a file shorter than its header declares, an .npy of another shape than
// (N, 3), and a cloud larger than the buffer are refused rather than cut.
// The files are read with C stdio (fopen, getline, fread) and plain
// buffers, not C++ iostreams.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

namespace {

constexpr int kMaxFields = 64;
constexpr int kMaxName = 64;

struct Field {
  char name[kMaxName];
  char type;
  int size;
  int count;
};

// A FILE* and a getline buffer, both released with the object.
struct Reader {
  FILE* f = nullptr;
  char* line = nullptr;
  size_t cap = 0;
  explicit Reader(const char* path) : f(std::fopen(path, "rb")) {}
  ~Reader() {
    if (f) std::fclose(f);
    std::free(line);
  }
  // The next line without its line end; false at the end of the file.
  bool next() {
    ssize_t n = getline(&line, &cap, f);
    if (n < 0) return false;
    while (n > 0 && (line[n - 1] == '\n' || line[n - 1] == '\r')) line[--n] = '\0';
    return true;
  }
};

bool starts_with(const char* s, const char* p) { return std::strncmp(s, p, std::strlen(p)) == 0; }

// The whitespace-separated values of an ASCII row, each parsed by strtod
// and rounded to float once; false if a value is missing or malformed.
bool parse_row(const char* p, int n_values, float* vals) {
  for (int j = 0; j < n_values; ++j) {
    char* end = nullptr;
    const double v = std::strtod(p, &end);
    if (end == p) return false;
    vals[j] = (float)v;
    p = end;
  }
  return true;
}

// The next whitespace-separated token of *p into tok (at most cap - 1
// characters); false when none is left.
bool token(const char** p, char* tok, size_t cap) {
  const char* s = *p;
  while (*s && std::isspace((unsigned char)*s)) ++s;
  if (!*s) return false;
  size_t n = 0;
  while (s[n] && !std::isspace((unsigned char)s[n])) ++n;
  const size_t k = std::min(n, cap - 1);
  std::memcpy(tok, s, k);
  tok[k] = '\0';
  *p = s + n;
  return true;
}

float read_as_float(const char* ptr, char type, int size) {
  if (type == 'F' && size == 4) { float v; std::memcpy(&v, ptr, 4); return v; }
  if (type == 'F' && size == 8) { double v; std::memcpy(&v, ptr, 8); return (float)v; }
  if (type == 'I' && size == 4) { int32_t v; std::memcpy(&v, ptr, 4); return (float)v; }
  if (type == 'U' && size == 4) { uint32_t v; std::memcpy(&v, ptr, 4); return (float)v; }
  if (type == 'U' && size == 1) { return (float)*(const uint8_t*)ptr; }
  if (type == 'I' && size == 2) { int16_t v; std::memcpy(&v, ptr, 2); return (float)v; }
  if (type == 'U' && size == 2) { uint16_t v; std::memcpy(&v, ptr, 2); return (float)v; }
  return 0.0f;
}

// Rows of stride bytes, x/y/z at the given fields, from a binary body.
int64_t read_binary_rows(FILE* f, int64_t n, int stride, const int* offsets, const char* types,
                         const int* sizes, const int xyz[3], float* out) {
  std::vector<char> buf((size_t)stride * (size_t)n);
  if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) return -1;
  for (int64_t i = 0; i < n; ++i) {
    const char* row = buf.data() + (size_t)i * stride;
    for (int c = 0; c < 3; ++c) {
      const int k = xyz[c];
      out[i * 3 + c] = read_as_float(row + offsets[k], types[k], sizes[k]);
    }
  }
  return n;
}

int64_t read_pcd(Reader& r, float* out, int64_t capacity) {
  Field fields[kMaxFields];
  int n_fields = 0;
  int64_t n = 0;
  char data_kind[32] = "";
  char tok[kMaxName];
  while (r.next()) {
    const char* p = r.line;
    if (!token(&p, tok, sizeof tok) || tok[0] == '#') continue;
    for (char* c = tok; *c; ++c) *c = (char)std::toupper((unsigned char)*c);
    if (!std::strcmp(tok, "FIELDS")) {
      while (n_fields < kMaxFields && token(&p, fields[n_fields].name, kMaxName)) {
        fields[n_fields].type = 'F';
        fields[n_fields].size = 4;
        fields[n_fields].count = 1;
        ++n_fields;
      }
    } else if (!std::strcmp(tok, "SIZE")) {
      for (int i = 0; i < n_fields && token(&p, tok, sizeof tok); ++i) fields[i].size = std::atoi(tok);
    } else if (!std::strcmp(tok, "TYPE")) {
      for (int i = 0; i < n_fields && token(&p, tok, sizeof tok); ++i) fields[i].type = tok[0];
    } else if (!std::strcmp(tok, "COUNT")) {
      for (int i = 0; i < n_fields && token(&p, tok, sizeof tok); ++i) fields[i].count = std::atoi(tok);
    } else if (!std::strcmp(tok, "POINTS")) {
      if (token(&p, tok, sizeof tok)) n = std::atoll(tok);
    } else if (!std::strcmp(tok, "WIDTH") && n == 0) {
      if (token(&p, tok, sizeof tok)) n = std::atoll(tok);
    } else if (!std::strcmp(tok, "DATA")) {
      token(&p, data_kind, sizeof data_kind);
      break;
    }
  }
  if (n_fields == 0 || n <= 0) return -1;
  int xyz[3] = {-1, -1, -1};
  int offsets[kMaxFields], sizes[kMaxFields];
  char types[kMaxFields];
  int stride = 0, n_values = 0;
  for (int i = 0; i < n_fields; ++i) {
    offsets[i] = stride;
    sizes[i] = fields[i].size;
    types[i] = fields[i].type;
    stride += fields[i].size * fields[i].count;
    n_values += fields[i].count;
    for (int c = 0; c < 3; ++c)
      if (!std::strcmp(fields[i].name, c == 0 ? "x" : c == 1 ? "y" : "z")) xyz[c] = i;
  }
  if (xyz[0] < 0 || xyz[1] < 0 || xyz[2] < 0 || stride <= 0) return -1;
  if (capacity < 0) return n;  // the declared count only
  if (n > capacity) return -2;
  if (!std::strcmp(data_kind, "ascii")) {
    std::vector<float> vals((size_t)n_values);
    for (int64_t i = 0; i < n; ++i) {
      if (!r.next() || !parse_row(r.line, n_values, vals.data())) return -1;
      for (int c = 0; c < 3; ++c) out[i * 3 + c] = vals[xyz[c]];
    }
    return n;
  }
  if (!std::strcmp(data_kind, "binary")) return read_binary_rows(r.f, n, stride, offsets, types, sizes, xyz, out);
  return -1;  // binary_compressed unsupported (PCN ships plain formats)
}

int type_size(const char* t) {
  if (!std::strcmp(t, "float") || !std::strcmp(t, "float32") || !std::strcmp(t, "int") ||
      !std::strcmp(t, "int32") || !std::strcmp(t, "uint") || !std::strcmp(t, "uint32")) return 4;
  if (!std::strcmp(t, "double") || !std::strcmp(t, "float64")) return 8;
  if (!std::strcmp(t, "uchar") || !std::strcmp(t, "uint8") || !std::strcmp(t, "char") || !std::strcmp(t, "int8")) return 1;
  if (!std::strcmp(t, "short") || !std::strcmp(t, "ushort") || !std::strcmp(t, "int16") || !std::strcmp(t, "uint16")) return 2;
  return 4;
}

char type_class(const char* t) {
  if (t[0] == 'f' || t[0] == 'd') return 'F';
  if (t[0] == 'u') return 'U';
  return 'I';
}

int64_t read_ply(Reader& r, float* out, int64_t capacity) {
  if (!r.next()) return -1;  // "ply"
  char fmt[64] = "";
  int64_t n = 0;
  char names[kMaxFields][kMaxName];
  char ptypes[kMaxFields][kMaxName];
  int n_props = 0;
  bool in_vertex = false;
  char tok[kMaxName];
  while (r.next()) {
    const char* p = r.line;
    if (starts_with(r.line, "format")) {
      token(&p, tok, sizeof tok);
      token(&p, fmt, sizeof fmt);
    } else if (starts_with(r.line, "element vertex")) {
      token(&p, tok, sizeof tok);
      token(&p, tok, sizeof tok);
      if (token(&p, tok, sizeof tok)) n = std::atoll(tok);
      in_vertex = true;
    } else if (starts_with(r.line, "element")) {
      in_vertex = false;
    } else if (starts_with(r.line, "property") && in_vertex && n_props < kMaxFields) {
      token(&p, tok, sizeof tok);
      if (token(&p, ptypes[n_props], kMaxName) && token(&p, names[n_props], kMaxName)) ++n_props;
    } else if (starts_with(r.line, "end_header")) {
      break;
    }
  }
  if (n <= 0 || n_props == 0) return -1;
  int xyz[3] = {-1, -1, -1};
  int offsets[kMaxFields], sizes[kMaxFields];
  char types[kMaxFields];
  int stride = 0;
  for (int i = 0; i < n_props; ++i) {
    offsets[i] = stride;
    sizes[i] = type_size(ptypes[i]);
    types[i] = type_class(ptypes[i]);
    stride += sizes[i];
    for (int c = 0; c < 3; ++c)
      if (!std::strcmp(names[i], c == 0 ? "x" : c == 1 ? "y" : "z")) xyz[c] = i;
  }
  if (xyz[0] < 0 || xyz[1] < 0 || xyz[2] < 0) return -1;
  if (capacity < 0) return n;  // the declared count only
  if (n > capacity) return -2;
  if (!std::strcmp(fmt, "ascii")) {
    std::vector<float> vals((size_t)n_props);
    for (int64_t i = 0; i < n; ++i) {
      if (!r.next() || !parse_row(r.line, n_props, vals.data())) return -1;
      for (int c = 0; c < 3; ++c) out[i * 3 + c] = vals[xyz[c]];
    }
    return n;
  }
  if (!std::strcmp(fmt, "binary_little_endian")) return read_binary_rows(r.f, n, stride, offsets, types, sizes, xyz, out);
  return -1;
}

int64_t read_npy(Reader& r, float* out, int64_t capacity) {
  char magic[6];
  if (std::fread(magic, 1, 6, r.f) != 6 || std::memcmp(magic, "\x93NUMPY", 6) != 0) return -1;
  uint8_t ver[2];
  if (std::fread(ver, 1, 2, r.f) != 2) return -1;
  uint32_t hlen = 0;
  if (ver[0] == 1) {
    uint16_t h;
    if (std::fread(&h, 1, 2, r.f) != 2) return -1;
    hlen = h;
  } else if (std::fread(&hlen, 1, 4, r.f) != 4) {
    return -1;
  }
  std::vector<char> header((size_t)hlen + 1, '\0');
  if (std::fread(header.data(), 1, hlen, r.f) != hlen) return -1;
  const char* h = header.data();
  const bool f8 = std::strstr(h, "'<f8'") != nullptr;
  const bool f4 = std::strstr(h, "'<f4'") != nullptr;
  if (!f4 && !f8) return -1;
  if (std::strstr(h, "'fortran_order': True")) return -1;
  const char* sp = std::strchr(h, '(');
  const char* ep = sp ? std::strchr(sp, ')') : nullptr;
  if (!sp || !ep) return -1;
  // shape (rows, cols): exactly two numbers
  int64_t dims[3] = {0, 0, 0};
  int n_dims = 0;
  const char* p = sp + 1;
  while (p < ep && n_dims < 3) {
    while (p < ep && (*p == ' ' || *p == ',')) ++p;
    if (p >= ep) break;
    char* end = nullptr;
    dims[n_dims++] = std::strtoll(p, &end, 10);
    if (end == p) return -1;
    p = end;
  }
  if (n_dims != 2) return -1;
  const int64_t rows = dims[0], cols = dims[1];
  if (cols != 3 || rows <= 0) return -1;
  if (capacity < 0) return rows;  // the declared count only
  if (rows > capacity) return -2;
  const size_t esz = f8 ? 8 : 4;
  std::vector<char> buf((size_t)rows * (size_t)cols * esz);
  if (std::fread(buf.data(), 1, buf.size(), r.f) != buf.size()) return -1;
  for (int64_t i = 0; i < rows; ++i) {
    for (int c = 0; c < 3; ++c) {
      const char* q = buf.data() + ((size_t)i * cols + c) * esz;
      if (f8) {
        double v;
        std::memcpy(&v, q, 8);
        out[i * 3 + c] = (float)v;
      } else {
        std::memcpy(&out[i * 3 + c], q, 4);
      }
    }
  }
  return rows;
}

}  // namespace

extern "C" {

// Returns the number of points written (xyz-interleaved f32), -1 for a file
// it cannot parse, -2 for one of more than capacity points; with a negative
// capacity, the number of points the file declares.
int64_t pcio_read_cloud(const char* path, float* out, int64_t capacity) {
  const char* dot = std::strrchr(path, '.');
  if (!dot) return -1;
  char ext[8] = "";
  const size_t n = std::strlen(dot);
  if (n >= sizeof ext) return -1;
  for (size_t i = 0; i <= n; ++i) ext[i] = (char)std::tolower((unsigned char)dot[i]);
  Reader r(path);
  if (!r.f) return -1;
  if (!std::strcmp(ext, ".pcd")) return read_pcd(r, out, capacity);
  if (!std::strcmp(ext, ".ply")) return read_ply(r, out, capacity);
  if (!std::strcmp(ext, ".npy")) return read_npy(r, out, capacity);
  return -1;
}

// The number of points a file's header declares, or -1.
int64_t pcio_declared_points(const char* path) {
  return pcio_read_cloud(path, nullptr, -1);
}

// Random permutation sample of n_out points, zero-padded when n < n_out
// (== datasets.transforms.RandomSamplePoints semantics).
void pcio_sample(const float* points, int64_t n, float* out, int64_t n_out,
                 uint64_t seed) {
  std::vector<int64_t> perm(n);
  for (int64_t i = 0; i < n; ++i) perm[i] = i;
  std::mt19937_64 rng(seed);
  std::shuffle(perm.begin(), perm.end(), rng);
  const int64_t m = std::min(n, n_out);
  for (int64_t i = 0; i < m; ++i) {
    std::memcpy(out + i * 3, points + perm[i] * 3, 3 * sizeof(float));
  }
  for (int64_t i = m; i < n_out; ++i) {
    out[i * 3] = out[i * 3 + 1] = out[i * 3 + 2] = 0.0f;
  }
}

// Parallel batched read+sample: paths[batch] → out (batch, n_points, 3).
// Returns the number of files successfully read.
int64_t pcio_load_batch(const char** paths, int64_t batch, float* out,
                        int64_t n_points, uint64_t seed, int64_t raw_capacity) {
  std::vector<int64_t> ok(batch, 0);
  const unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  const int64_t workers = std::min<int64_t>(batch, hw);
  std::vector<std::thread> threads;
  for (int64_t w = 0; w < workers; ++w) {
    threads.emplace_back([&, w]() {
      std::vector<float> raw((size_t)raw_capacity * 3);
      for (int64_t i = w; i < batch; i += workers) {
        int64_t n = pcio_read_cloud(paths[i], raw.data(), raw_capacity);
        if (n <= 0) continue;
        pcio_sample(raw.data(), n, out + (size_t)i * n_points * 3, n_points,
                    seed + (uint64_t)i * 0x9E3779B97F4A7C15ull);
        ok[i] = 1;
      }
    });
  }
  for (auto& t : threads) t.join();
  int64_t total = 0;
  for (auto v : ok) total += v;
  return total;
}

}  // extern "C"
