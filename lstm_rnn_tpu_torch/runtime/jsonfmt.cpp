// Fast JSON serialization of big float64 arrays for network checkpoints.
//
// The reference writes checkpoints with rapidjson from C++
// (TrainableLayer.cu:212-248, main.cpp:701-741); the Python json encoder
// spends ~1.5 us per float on shortest-repr formatting, which at LVCSR
// scale (10k-state softmax, ~5M weights -> >100 MB JSON) makes every
// --autosave cost many seconds of pure host serialization.
//
// Counterpart of lstm_rnn_tpu/runtime/jsonfmt.cpp, which writes values
// that parse back to the same doubles; this one writes the same BYTES as
// Python's json module, so a network file or an autosave is byte for byte
// what the pure-Python dump writes: every value as Python's repr of the
// double (float_repr_style 'short': std::to_chars's shortest round-trip
// digits, in fixed notation for decimal exponents -4..15 with ".0" after
// an integral value, else d[.ddd]e+XX with at least two exponent digits),
// NaN / Infinity / -Infinity as json.dump(allow_nan=True) writes them, and
// the values joined by the caller's separator (json.dump's indentation).
//
// Contract: lrt_format_f64_json writes the n values joined by `sep` into
// `out` and returns the byte count, or -1 if `cap` could be exceeded (the
// caller sizes cap >= n * (24 + sep_len): the longest repr of a double is
// 24 characters).

#include <charconv>
#include <cmath>
#include <cstdlib>
#include <cstring>

namespace {

// Python's repr of a finite double at p; returns the end.
char* repr_f64(double v, char* p) {
  char buf[32];
  char* end = std::to_chars(buf, buf + sizeof buf - 1, v,
                            std::chars_format::scientific).ptr;
  *end = '\0';  // for atoi
  const char* s = buf;
  if (*s == '-') *p++ = *s++;
  const char* e = static_cast<const char*>(std::memchr(s, 'e', end - s));
  const int exp = std::atoi(e + 1);
  char digits[24];
  int nd = 0;
  for (const char* q = s; q < e; ++q)
    if (*q != '.') digits[nd++] = *q;
  if (exp < -4 || exp >= 16) {
    *p++ = digits[0];
    if (nd > 1) {
      *p++ = '.';
      std::memcpy(p, digits + 1, nd - 1);
      p += nd - 1;
    }
    *p++ = 'e';
    *p++ = exp < 0 ? '-' : '+';
    const int a = exp < 0 ? -exp : exp;
    if (a >= 100) *p++ = char('0' + a / 100);
    *p++ = char('0' + a / 10 % 10);
    *p++ = char('0' + a % 10);
  } else if (exp < 0) {
    *p++ = '0';
    *p++ = '.';
    for (int i = 0; i < -exp - 1; ++i) *p++ = '0';
    std::memcpy(p, digits, nd);
    p += nd;
  } else if (nd <= exp + 1) {
    std::memcpy(p, digits, nd);
    p += nd;
    for (int i = nd; i <= exp; ++i) *p++ = '0';
    *p++ = '.';
    *p++ = '0';
  } else {
    std::memcpy(p, digits, exp + 1);
    p += exp + 1;
    *p++ = '.';
    std::memcpy(p, digits + exp + 1, nd - exp - 1);
    p += nd - exp - 1;
  }
  return p;
}

}  // namespace

extern "C" {

long long lrt_format_f64_json(const double* a, long long n, const char* sep,
                              long long sep_len, char* out, long long cap) {
  if (cap < n * (24 + sep_len)) return -1;
  char* p = out;
  for (long long i = 0; i < n; ++i) {
    if (i) {
      std::memcpy(p, sep, sep_len);
      p += sep_len;
    }
    const double v = a[i];
    if (std::isnan(v)) {
      std::memcpy(p, "NaN", 3);
      p += 3;
    } else if (std::isinf(v)) {
      if (v < 0) *p++ = '-';
      std::memcpy(p, "Infinity", 8);
      p += 8;
    } else {
      p = repr_f64(v, p);
    }
  }
  return p - out;
}

}  // extern "C"
