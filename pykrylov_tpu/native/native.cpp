// Native host-side data pipeline for pykrylov_tpu.
//
// The reference delegated its sparse-matrix I/O and storage to pysparse's
// C extensions (SURVEY §2.5: `examples/bmark.py:34`,
// `linop/linop.py:688-720`); this library's equivalent is a small C++
// kernel set for the host-side work that feeds the device: MatrixMarket
// parsing and COO -> ELL / DIA format packing.  The device compute path is
// JAX/XLA; these routines only prepare buffers, so they expose a
// plain extern "C" ABI consumed from Python via ctypes (no pybind11 in the
// image).
//
// Build: g++ -O3 -march=native -shared -fPIC native.cpp -o _native.so
// (done lazily by pykrylov_tpu/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <utility>
#include <vector>

namespace {

struct MMHandle {
  std::vector<double> vals;   // interleaved re,im when complex
  std::vector<int32_t> rows;
  std::vector<int32_t> cols;
  int64_t m = 0, n = 0;
  int field = 0;     // 0 real, 1 integer, 2 pattern, 3 complex
  int symmetry = 0;  // 0 general, 1 symmetric, 2 skew-symmetric, 3 hermitian
};

// Skip spaces/tabs.
inline const char* skip_ws(const char* p) {
  while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
  return p;
}

bool line_starts(const std::string& s, const char* prefix) {
  return s.rfind(prefix, 0) == 0;
}

std::string lower(std::string s) {
  for (auto& c : s) c = (char)tolower((unsigned char)c);
  return s;
}

}  // namespace

extern "C" {

// Parse a MatrixMarket coordinate file.  Returns an opaque handle (or
// nullptr, with a message in errbuf).  Metadata comes back through the out
// params; the caller then sizes numpy arrays and calls mm_copy + mm_free.
void* mm_parse(const char* path, int64_t* out_nnz, int64_t* out_m,
               int64_t* out_n, int* out_field, int* out_symmetry,
               char* errbuf, int errlen) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    snprintf(errbuf, errlen, "cannot open %s", path);
    return nullptr;
  }
  auto fail = [&](const char* msg) -> void* {
    snprintf(errbuf, errlen, "%s", msg);
    fclose(f);
    return nullptr;
  };

  char buf[1 << 16];
  if (!fgets(buf, sizeof buf, f)) return fail("empty file");
  std::string header = lower(buf);
  if (!line_starts(header, "%%matrixmarket"))
    return fail("not a MatrixMarket file");
  if (header.find("matrix") == std::string::npos ||
      header.find("coordinate") == std::string::npos)
    return fail("only 'matrix coordinate' files supported natively");

  auto h = new MMHandle();
  if (header.find("complex") != std::string::npos) h->field = 3;
  else if (header.find("integer") != std::string::npos) h->field = 1;
  else if (header.find("pattern") != std::string::npos) h->field = 2;
  else h->field = 0;
  if (header.find("skew-symmetric") != std::string::npos) h->symmetry = 2;
  else if (header.find("symmetric") != std::string::npos) h->symmetry = 1;
  else if (header.find("hermitian") != std::string::npos) h->symmetry = 3;
  else h->symmetry = 0;

  // Comments, then the size line.
  int64_t nnz = -1;
  while (fgets(buf, sizeof buf, f)) {
    const char* p = skip_ws(buf);
    if (*p == '%' || *p == '\n' || *p == '\0') continue;
    char* end;
    h->m = strtoll(p, &end, 10);
    h->n = strtoll(end, &end, 10);
    nnz = strtoll(end, &end, 10);
    break;
  }
  if (nnz < 0 || h->m <= 0 || h->n <= 0) {
    delete h;
    return fail("bad size line");
  }

  h->rows.reserve(nnz);
  h->cols.reserve(nnz);
  h->vals.reserve(h->field == 3 ? 2 * nnz : nnz);

  while ((int64_t)h->rows.size() < nnz && fgets(buf, sizeof buf, f)) {
    const char* p = skip_ws(buf);
    if (*p == '%' || *p == '\n' || *p == '\0') continue;
    char* end;
    long r = strtol(p, &end, 10);
    long c = strtol(end, &end, 10);
    h->rows.push_back((int32_t)(r - 1));  // 1-based -> 0-based
    h->cols.push_back((int32_t)(c - 1));
    if (h->field == 2) {
      h->vals.push_back(1.0);
    } else if (h->field == 3) {
      h->vals.push_back(strtod(end, &end));
      h->vals.push_back(strtod(end, &end));
    } else {
      h->vals.push_back(strtod(end, &end));
    }
  }
  fclose(f);
  if ((int64_t)h->rows.size() != nnz) {
    delete h;
    snprintf(errbuf, errlen, "expected %lld entries, got %lld",
             (long long)nnz, (long long)h->rows.size());
    return nullptr;
  }
  *out_nnz = nnz;
  *out_m = h->m;
  *out_n = h->n;
  *out_field = h->field;
  *out_symmetry = h->symmetry;
  return h;
}

void mm_copy(void* handle, double* vals, int32_t* rows, int32_t* cols) {
  auto h = static_cast<MMHandle*>(handle);
  memcpy(vals, h->vals.data(), h->vals.size() * sizeof(double));
  memcpy(rows, h->rows.data(), h->rows.size() * sizeof(int32_t));
  memcpy(cols, h->cols.data(), h->cols.size() * sizeof(int32_t));
}

void mm_free(void* handle) { delete static_cast<MMHandle*>(handle); }

// Fill padded-row ELL storage from row-sorted COO triples.
// ell_data (m*K) and ell_cols (m*K) must be zero-initialized.
// Returns 0 on success, -1 if some row exceeds K slots.
int ell_fill(int64_t nnz, const int32_t* rows, const int32_t* cols,
             const double* vals, int64_t m, int64_t K, double* ell_data,
             int32_t* ell_cols) {
  std::vector<int32_t> slot(m, 0);
  for (int64_t i = 0; i < nnz; ++i) {
    const int32_t r = rows[i];
    const int32_t s = slot[r]++;
    if (s >= K) return -1;
    ell_data[(int64_t)r * K + s] = vals[i];
    ell_cols[(int64_t)r * K + s] = cols[i];
  }
  return 0;
}

// Fill DIA storage: dia_data is (ndiag, m) zero-initialized; offsets are
// the sorted distinct diagonals.  Returns 0, or -1 on an unknown offset.
int dia_fill(int64_t nnz, const int32_t* rows, const int32_t* cols,
             const double* vals, int64_t m, int64_t ndiag,
             const int64_t* offsets, double* dia_data) {
  // offsets are sorted: binary search each nnz's diagonal.
  for (int64_t i = 0; i < nnz; ++i) {
    const int64_t off = (int64_t)cols[i] - rows[i];
    int64_t lo = 0, hi = ndiag - 1, k = -1;
    while (lo <= hi) {
      const int64_t mid = (lo + hi) / 2;
      if (offsets[mid] == off) { k = mid; break; }
      if (offsets[mid] < off) lo = mid + 1; else hi = mid - 1;
    }
    if (k < 0) return -1;
    dia_data[k * m + rows[i]] += vals[i];  // duplicates accumulate
  }
  return 0;
}

// Per-row nonzero counts (bincount for int32 rows).
void row_counts(int64_t nnz, const int32_t* rows, int64_t m,
                int64_t* counts) {
  memset(counts, 0, m * sizeof(int64_t));
  for (int64_t i = 0; i < nnz; ++i) counts[rows[i]]++;
}

}  // extern "C"
