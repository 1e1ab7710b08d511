// C ABI for the native LAGAN-semantics engine (ctypes entry points).
// Buffers returned must be released with le_free.
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <array>
#include <string>
#include <vector>

#include "lagan_common.h"
#include "lagan_stages.h"

namespace {

char* dup_out(const std::string& s) {
  char* p = (char*)std::malloc(s.size() + 1);
  std::memcpy(p, s.data(), s.size());
  p[s.size()] = 0;
  return p;
}

}  // namespace

extern "C" {

// chaos over -pairs regions.  pairs_text: lines "-s1 B E -s2 B E".
char* le_chaos(const char* seq1, long n1, const char* name1, const char* seq2,
               long n2, const char* name2, const char* pairs_text, int wl,
               int nd, int co, int rsc, int gfc, int ext) {
  lagan::MappedSeq s1, s2;
  lagan::map_sequence(seq1, n1, false, &s1);
  lagan::map_sequence(seq2, n2, false, &s2);
  std::vector<std::array<int, 4>> pairs;
  const char* p = pairs_text;
  while (*p) {
    int a, b, c, d, consumed = 0;
    if (std::sscanf(p, " -s1 %d %d -s2 %d %d%n", &a, &b, &c, &d, &consumed) ==
        4) {
      pairs.push_back({a, b, c, d});
      p += consumed;
    } else {
      break;
    }
  }
  std::string out;
  lagan::chaos_pairs(s1, name1, s2, name2, pairs, wl, nd, co, rsc, gfc != 0,
                     ext != 0, &out);
  return dup_out(out);
}

// 6-frame translated chaos (fchaos -t); hits in DNA coordinates.
char* le_chaos_trans(const char* seq1, long n1, const char* name1,
                     const char* seq2, long n2, const char* name2, int both,
                     int wl, int nd, int co, int rsc, int gfc, int ext) {
  std::string out;
  lagan::chaos_translated(seq1, n1, name1, seq2, n2, name2, both != 0, wl,
                          nd, co, rsc, gfc != 0, ext != 0, &out);
  return dup_out(out);
}

// chaos's work counters, see lagan::chaos_stats.
void le_chaos_stats(long long* out) { lagan::chaos_stats(out); }

char* le_anchors(const char* hits_text, int gfc) {
  std::string out;
  lagan::anchors_text(hits_text, gfc != 0, &out);
  return dup_out(out);
}

char* le_order(const char* seq1, long n1, const char* name1, const char* seq2,
               long n2, const char* name2, const char* anchors) {
  lagan::MappedSeq s1, s2;
  lagan::map_sequence(seq1, n1, true, &s1);
  lagan::map_sequence(seq2, n2, true, &s2);
  std::string out;
  lagan::order_mfa(s1, name1, s2, name2, anchors, &out);
  return dup_out(out);
}

void le_free(char* p) { std::free(p); }

// --- split order pipeline around the device band DP ------------------------

void* le_order_prepare(const char* seq1, long n1, const char* seq2, long n2,
                       const char* anchors) {
  lagan::MappedSeq s1, s2;
  lagan::map_sequence(seq1, n1, true, &s1);
  lagan::map_sequence(seq2, n2, true, &s2);
  return lagan::order_prepare(s1, s2, anchors);
}

// dims_out: [d1, d2, ndiags, max_band_width]
void le_order_dims(void* h, long long* dims_out) {
  lagan::order_band_dims(h, dims_out, dims_out + 1, dims_out + 2,
                         dims_out + 3);
}

void le_order_band(void* h, int* starts, int* ends, int* isneck_eff) {
  lagan::order_band_rows(h, starts, ends, isneck_eff);
}

// Mapped sequence for the device DP: lets[0] (the order-mode zero
// sentinel) through lets[numlets + 16] (trailing pad); caller allocates
// numlets + 17 bytes. which: 1 or 2.
void le_order_seq(void* h, int which, char* out) {
  lagan::order_mapped_seq(h, which, out);
}

char* le_order_finish(void* h, const char* name1, const char* name2,
                      const unsigned char* ptrs, long long wmax) {
  std::string out;
  lagan::order_finish_mfa(h, name1, name2, ptrs, wmax, &out);
  return dup_out(out);
}

void le_order_release(void* h) { lagan::order_release(h); }

}  // extern "C"
