// Host IO hot paths of gunrock_tpu_torch: an mmap Matrix Market (.mtx)
// parser and the stable two-pass counting sort from COO to compressed rows
// (the reference's mmio reader and its from_coo counting sort, SURVEY.md
// section 7). The C interface is loaded through ctypes by
// gunrock_tpu_torch/_native/__init__.py, which builds this file with the
// host C++ compiler at first use.
//
// The parser returns what io/matrix_market.py's Python path returns, bit
// for bit, on every file that either path accepts; where one raises, both
// do. The Python path reads a latin-1 text file line by line and hands the
// entries to np.loadtxt, so this parser follows the same rules:
//   - lines end in "\n", "\r\n" or "\r" (universal newlines);
//   - whitespace is what str.split() and loadtxt split on in a latin-1
//     line: \t \v \f, 0x1c-0x1f, space, 0x85 and 0xa0;
//   - the banner's fourth and fifth words name the field and the symmetry;
//   - "%" lines and blank lines before the size line are skipped; the size
//     line holds exactly three non-negative decimal integers;
//   - among the entries a "#" starts a comment (loadtxt's default), a line
//     with no token is skipped, every token is a number in Python's float
//     grammar, and every entry has as many columns as the first;
//   - an index is truncated to an integer as float64 -> int64, less one,
//     wrapped to int32; it must be finite and below 2^63 in magnitude;
//   - the value is the third column cast to float32, or 1.0 for a pattern
//     matrix or two-column entries;
//   - the mirrors of a symmetric matrix's off-diagonal entries are appended
//     after all entries, in entry order.
// Numbers are converted exactly: Clinger's fast path where the significand
// has at most 15 digits and the power of ten at most 22, else strtod on a
// bounded copy of the token (the mapping is not NUL-terminated).

#include <algorithm>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <new>
#include <stdexcept>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct SpaceTable {
  bool on[256] = {};
  SpaceTable() {
    for (int c : {0x09, 0x0b, 0x0c, 0x1c, 0x1d, 0x1e, 0x1f, 0x20, 0x85, 0xa0})
      on[c] = true;
  }
};
const SpaceTable kSpace;

inline bool is_space(char c) { return kSpace.on[(unsigned char)c]; }

struct ParseError {
  std::string msg;
};

[[noreturn]] void fail(int64_t line, const std::string& msg) {
  throw ParseError{line > 0 ? "line " + std::to_string(line) + ": " + msg
                            : msg};
}

// The file's lines, each without its line break, numbered from 1.
struct Lines {
  const char* p;
  const char* end;
  int64_t number = 0;

  bool next(const char*& b, const char*& e) {
    if (p >= end) return false;
    b = p;
    while (p < end && *p != '\n' && *p != '\r') ++p;
    e = p;
    if (p < end) p += (*p == '\r' && p + 1 < end && p[1] == '\n') ? 2 : 1;
    ++number;
    return true;
  }
};

// Splits [p, end) into whitespace-separated tokens.
struct Tokens {
  const char* p;
  const char* end;

  bool next(const char*& b, const char*& e) {
    while (p < end && is_space(*p)) ++p;
    if (p >= end) return false;
    b = p;
    while (p < end && !is_space(*p)) ++p;
    e = p;
    return true;
  }
};

inline char lower(char c) { return (c >= 'A' && c <= 'Z') ? c - 'A' + 'a' : c; }

bool equals_lower(const char* b, const char* e, const char* word) {
  size_t n = strlen(word);
  if ((size_t)(e - b) != n) return false;
  for (size_t i = 0; i < n; ++i)
    if (lower(b[i]) != word[i]) return false;
  return true;
}

const double kPow10[] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
                         1e8,  1e9,  1e10, 1e11, 1e12, 1e13, 1e14, 1e15,
                         1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

// One token as a double, under Python's float grammar (no underscores):
// [sign] (digits [. [digits]] | . digits) [(e|E) [sign] digits], or
// [sign] inf | infinity | nan in any case. False if it is not a number.
bool parse_number(const char* b, const char* e, double* out) {
  const char* q = b;
  bool neg = false;
  if (q < e && (*q == '+' || *q == '-')) neg = (*q++ == '-');
  if (q < e && !(*q >= '0' && *q <= '9') && *q != '.') {
    double v;
    if (equals_lower(q, e, "inf") || equals_lower(q, e, "infinity"))
      v = std::numeric_limits<double>::infinity();
    else if (equals_lower(q, e, "nan"))
      v = std::numeric_limits<double>::quiet_NaN();
    else
      return false;
    *out = neg ? -v : v;
    return true;
  }
  uint64_t m = 0;  // the significant digits, at most 15 of them
  int nd = 0;
  int64_t e10 = 0;
  bool digits = false, slow = false;
  for (; q < e && *q >= '0' && *q <= '9'; ++q) {
    digits = true;
    if (m == 0 && *q == '0') continue;
    if (nd == 15) { slow = true; continue; }
    m = m * 10 + (uint64_t)(*q - '0');
    ++nd;
  }
  if (q < e && *q == '.') {
    for (++q; q < e && *q >= '0' && *q <= '9'; ++q) {
      digits = true;
      if (m == 0 && *q == '0') { --e10; continue; }
      if (nd == 15) { slow = true; continue; }
      m = m * 10 + (uint64_t)(*q - '0');
      ++nd;
      --e10;
    }
  }
  if (!digits) return false;
  if (q < e && (*q == 'e' || *q == 'E')) {
    ++q;
    bool eneg = false;
    if (q < e && (*q == '+' || *q == '-')) eneg = (*q++ == '-');
    if (q >= e || !(*q >= '0' && *q <= '9')) return false;
    int64_t x = 0;
    for (; q < e && *q >= '0' && *q <= '9'; ++q)
      if (x < 100000) x = x * 10 + (*q - '0');
    e10 += eneg ? -x : x;
  }
  if (q != e) return false;
  if (!slow && m == 0) {
    *out = neg ? -0.0 : 0.0;
    return true;
  }
  if (!slow && e10 >= -22 && e10 <= 22) {
    double v = (double)m;  // exact: m < 10^15 < 2^53
    v = e10 >= 0 ? v * kPow10[e10] : v / kPow10[-e10];
    *out = neg ? -v : v;
    return true;
  }
  char small[128];
  std::string big;
  size_t n = (size_t)(e - b);
  char* buf = small;
  if (n >= sizeof(small)) {
    big.assign(b, e);
    buf = &big[0];
  } else {
    memcpy(small, b, n);
    small[n] = '\0';
  }
  *out = strtod(buf, nullptr);
  return true;
}

int32_t to_index(double v, int64_t line) {
  if (!std::isfinite(v) || std::fabs(v) >= 9223372036854775808.0)
    fail(line, "an index must be a finite number below 2^63");
  return (int32_t)(uint32_t)(uint64_t)((int64_t)v - 1);
}

struct MtxData {
  std::vector<int32_t> rows, cols;
  std::vector<float> vals;
  int64_t n_rows = 0, n_cols = 0;
  bool symmetric = false, pattern = false;
};

int64_t size_token(const char* b, const char* e, int64_t line) {
  int64_t v = 0;
  for (const char* q = b; q < e; ++q) {
    if (!(*q >= '0' && *q <= '9'))
      fail(line, "the size line must hold three non-negative integers");
    int d = *q - '0';
    if (v > (std::numeric_limits<int64_t>::max() - d) / 10)
      fail(line, "a size above 2^63 - 1");
    v = v * 10 + d;
  }
  return v;
}

void parse(const char* base, size_t size, MtxData* out) {
  Lines lines{base, base + size};
  const char *b, *e;
  if (!lines.next(b, e) || (size_t)(e - b) < 14 ||
      memcmp(b, "%%MatrixMarket", 14) != 0)
    fail(0, "missing MatrixMarket banner");
  const char* words[5];
  const char* ends[5];
  int nw = 0;
  Tokens banner{b, e};
  while (nw < 5 && banner.next(words[nw], ends[nw])) ++nw;
  if (nw < 5 || !equals_lower(words[1], ends[1], "matrix"))
    fail(1, "unsupported banner");
  if (!equals_lower(words[2], ends[2], "coordinate"))
    fail(1, "only coordinate (sparse) matrices are supported");
  if (equals_lower(words[3], ends[3], "complex"))
    fail(1, "complex matrices not supported");
  out->pattern = equals_lower(words[3], ends[3], "pattern");
  if (!out->pattern && !equals_lower(words[3], ends[3], "real") &&
      !equals_lower(words[3], ends[3], "integer"))
    fail(1, "unsupported field '" + std::string(words[3], ends[3]) + "'");
  // skew-symmetric stays directed with no mirrors (reference mmio parity)
  out->symmetric = equals_lower(words[4], ends[4], "symmetric") ||
                   equals_lower(words[4], ends[4], "hermitian");
  if (!out->symmetric && !equals_lower(words[4], ends[4], "general") &&
      !equals_lower(words[4], ends[4], "skew-symmetric"))
    fail(1, "unsupported symmetry '" + std::string(words[4], ends[4]) + "'");

  // comments and blank lines, then the size line
  bool found = false;
  while (lines.next(b, e)) {
    if (b < e && *b == '%') continue;
    const char* q = b;
    while (q < e && is_space(*q)) ++q;
    if (q == e) continue;
    found = true;
    break;
  }
  if (!found) fail(0, "missing size line");
  int64_t sizes[3];
  int ns = 0;
  Tokens size_line{b, e};
  const char *tb, *te;
  while (size_line.next(tb, te)) {
    if (ns == 3)
      fail(lines.number, "the size line must hold three non-negative integers");
    sizes[ns++] = size_token(tb, te, lines.number);
  }
  if (ns != 3)
    fail(lines.number, "the size line must hold three non-negative integers");
  out->n_rows = sizes[0];
  out->n_cols = sizes[1];
  const int64_t nnz = sizes[2];

  // an entry takes at least four bytes ("1 1\n"): never reserve past that
  size_t cap = (size_t)std::min<int64_t>(nnz, (int64_t)(size / 4 + 1));
  out->rows.reserve(out->symmetric ? 2 * cap : cap);
  out->cols.reserve(out->symmetric ? 2 * cap : cap);
  out->vals.reserve(out->symmetric ? 2 * cap : cap);

  int ncols = -1;
  int64_t got = 0;
  while (got < nnz && lines.next(b, e)) {
    const char* hash = (const char*)memchr(b, '#', (size_t)(e - b));
    if (hash) e = hash;
    Tokens toks{b, e};
    double v[3] = {0.0, 0.0, 0.0};
    int nt = 0;
    while (toks.next(tb, te)) {
      double x;
      if (!parse_number(tb, te, &x))
        fail(lines.number, "'" + std::string(tb, te) + "' is not a number");
      if (nt < 3) v[nt] = x;
      ++nt;
    }
    if (nt == 0) continue;
    if (ncols < 0) {
      ncols = nt;
      if (ncols < 2) fail(lines.number, "an entry needs a row and a column");
    } else if (nt != ncols) {
      fail(lines.number, std::to_string(nt) + " columns, the entries before have " +
                             std::to_string(ncols));
    }
    out->rows.push_back(to_index(v[0], lines.number));
    out->cols.push_back(to_index(v[1], lines.number));
    out->vals.push_back(!out->pattern && ncols >= 3 ? (float)v[2] : 1.0f);
    ++got;
  }
  if (got != nnz)
    fail(0, "expected " + std::to_string(nnz) + " entries, found " +
                std::to_string(got));
  if (out->symmetric) {
    for (int64_t i = 0; i < got; ++i) {
      if (out->rows[i] == out->cols[i]) continue;
      out->rows.push_back(out->cols[i]);
      out->cols.push_back(out->rows[i]);
      out->vals.push_back(out->vals[i]);
    }
  }
}

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" {

// Parse a .mtx file. Returns an opaque handle, or nullptr with `err` filled
// (and errno set when the file could not be opened or mapped). The entry
// count is that of the expanded edge list (mirrors included).
void* gr_mtx_parse(const char* path, int64_t* n_rows, int64_t* n_cols,
                   int64_t* nnz_out, int* symmetric, int* pattern, char* err,
                   int errlen) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) {
    int saved = errno;
    set_err(err, errlen, std::string("cannot open file: ") + strerror(saved));
    errno = saved;
    return nullptr;
  }
  struct stat st;
  if (fstat(fd, &st) != 0 || S_ISDIR(st.st_mode)) {
    int saved = S_ISDIR(st.st_mode) ? EISDIR : errno;
    close(fd);
    set_err(err, errlen, std::string("cannot read file: ") + strerror(saved));
    errno = saved;
    return nullptr;
  }
  size_t size = (size_t)st.st_size;
  const char* base = nullptr;
  if (size > 0) {
    void* m = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (m == MAP_FAILED) {
      int saved = errno;
      close(fd);
      set_err(err, errlen, std::string("mmap failed: ") + strerror(saved));
      errno = saved;
      return nullptr;
    }
    base = (const char*)m;
    madvise(m, size, MADV_SEQUENTIAL);
  }
  close(fd);
  MtxData* data = nullptr;
  std::string msg;
  try {
    data = new MtxData();
    parse(base, size, data);
  } catch (const ParseError& e) {
    msg = e.msg;
  } catch (const std::bad_alloc&) {
    msg = "out of memory";
  } catch (const std::length_error&) {
    msg = "out of memory";
  }
  if (base) munmap((void*)base, size);
  if (!msg.empty()) {
    delete data;
    set_err(err, errlen, msg);
    errno = 0;
    return nullptr;
  }
  *n_rows = data->n_rows;
  *n_cols = data->n_cols;
  *nnz_out = (int64_t)data->rows.size();
  *symmetric = data->symmetric ? 1 : 0;
  *pattern = data->pattern ? 1 : 0;
  return data;
}

void gr_mtx_copy(void* h, int32_t* rows, int32_t* cols, float* vals) {
  auto* d = (MtxData*)h;
  memcpy(rows, d->rows.data(), d->rows.size() * sizeof(int32_t));
  memcpy(cols, d->cols.data(), d->cols.size() * sizeof(int32_t));
  memcpy(vals, d->vals.data(), d->vals.size() * sizeof(float));
}

void gr_mtx_free(void* h) { delete (MtxData*)h; }

// Stable two-pass counting sort by (major, minor): exactly
// np.lexsort((minor, major)). Writes the compressed offsets, the sorted
// minor indices and values, and the permutation (sorted position ->
// original index). Returns 0, 1 if an index lies outside [0, n_major) or
// [0, n_minor) (nothing written), 2 when out of memory.
int gr_coo_to_compressed(int64_t nnz, int32_t n_major, int32_t n_minor,
                         const int32_t* major, const int32_t* minor,
                         const float* vals, int64_t* offsets,
                         int32_t* minor_out, float* vals_out,
                         int64_t* perm_out) {
  for (int64_t i = 0; i < nnz; ++i)
    if (major[i] < 0 || major[i] >= n_major || minor[i] < 0 ||
        minor[i] >= n_minor)
      return 1;
  try {
    // pass 1: stable counting sort by minor
    std::vector<int64_t> count((size_t)n_minor + 1, 0);
    for (int64_t i = 0; i < nnz; ++i) ++count[(size_t)minor[i] + 1];
    for (int32_t k = 0; k < n_minor; ++k)
      count[(size_t)k + 1] += count[(size_t)k];
    std::vector<int64_t> perm1((size_t)nnz);
    for (int64_t i = 0; i < nnz; ++i)
      perm1[(size_t)count[(size_t)minor[i]]++] = i;

    // pass 2: stable counting sort of that order by major
    std::vector<int64_t> count2((size_t)n_major + 1, 0);
    for (int64_t i = 0; i < nnz; ++i) ++count2[(size_t)major[i] + 1];
    for (int32_t k = 0; k < n_major; ++k)
      count2[(size_t)k + 1] += count2[(size_t)k];
    for (int32_t k = 0; k <= n_major; ++k) offsets[k] = count2[(size_t)k];
    for (int64_t i = 0; i < nnz; ++i) {
      int64_t src = perm1[(size_t)i];
      int64_t dst = count2[(size_t)major[src]]++;
      perm_out[dst] = src;
      minor_out[dst] = minor[src];
      vals_out[dst] = vals[src];
    }
  } catch (const std::bad_alloc&) {
    return 2;
  }
  return 0;
}

}  // extern "C"
