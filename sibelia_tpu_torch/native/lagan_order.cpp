// order stage of the native LAGAN-semantics engine.
//
// Replicates the reference anchored global aligner (reference:
// src/lagan/src/order.c with the limited-memory diagonal matrix of
// diagmatrix.c) with full pointer retention instead of neck chain saving:
//  * anchor parsing/clipping (order.c:224-269, list built ascending);
//  * band shapes: squares between anchors with the MAX_SQ_SIZE recursive
//    split, barrels along anchors (order.c:271-382, width 15, overlap 0);
//  * neck placement (diagmatrix.c:69-119) and the score renormalization the
//    reference applies at each neck (diagmatrix.c:268-293), including its
//    use of the already-updated M value in the N/O clamps when the
//    normalizer is non-positive;
//  * the 3-state integer DP with the reference's exact tie preferences and
//    pointer bits (order.c:609-705), dummy value INT_MIN + (1 << 28) for
//    out-of-band neighbors;
//  * the traceback state machine with gap-run continuation bits
//    (order.c:485-556).  Saved neck chains are unnecessary here because all
//    pointer nibbles are retained: a chain saved at a neck equals the
//    continuation of the same state machine through those cells.
//  * -mfa output skips alignment column 0 (order.c:771-801).
#include <cstdio>
#include <cstring>
#include <cstdint>
#include <climits>
#include <string>
#include <vector>
#include <algorithm>

#include "lagan_common.h"
#include "lagan_stages.h"

namespace lagan {
namespace {

const int kGlWidth = 15;                       // order.c:43
const int kOverlap = 0;                        // order.c:42
const long long kMaxSqSize = 500LL * (1 << 20);  // order.c:12
const int64_t kDummy = (int64_t)(INT_MIN + (1 << 28));  // diagmatrix.c:36

struct Anchor {
  int s1s, s1e, s2s, s2e;
};

struct Alel {
  int64_t M, N, O;
};

struct Band {
  int d1, d2;                 // numlets1 + 1, numlets2 + 1
  std::vector<int> starts, ends;   // per anti-diagonal band [start, end]
  std::vector<int> isneck;         // nonzero at neck diagonals
};

inline bool iscb(char c) { return c == '.'; }

// mkSquare (order.c:322-358) including the too-big recursive split.
void mk_square(int s1, int s2, int e1, int e2, int* dn, int dt, Band* b) {
  long long size = ((long long)e1 - s1) * ((long long)e2 - s2);
  if (size > kMaxSqSize) {
    mk_square(s1, s2, (s1 + e1) / 2 + kGlWidth, (s2 + e2) / 2 + kGlWidth, dn,
              (*dn + dt) / 2, b);
    mk_square((s1 + e1) / 2 - kGlWidth, (s2 + e2) / 2 - kGlWidth, e1, e2, dn,
              dt, b);
    return;
  }
  for (; *dn < dt; ++(*dn)) {
    int dists0, dists1;
    if (*dn < b->d2) {
      dists0 = s1 - 1;
      dists1 = *dn - e2;
    } else {
      dists0 = b->d2 - e2;
      dists1 = s1 - (*dn - b->d2) - 1;
    }
    b->starts[*dn] = std::max(dists0, dists1);
    if (*dn < b->d2) {
      dists0 = e1 - 1;
      dists1 = *dn - s2;
    } else {
      dists0 = b->d2 - s2;
      dists1 = e1 - (*dn - b->d2) - 1;
    }
    b->ends[*dn] = std::min(dists0, dists1);
  }
}

// mkBarrel (order.c:271-320)
void mk_barrel(int s1, int s2, int e1, int e2, int width, int* dn, int dt,
               Band* b) {
  int sd = s1 + s2 - 1;
  int elem = (sd < b->d2) ? s1 : b->d2 - s2;
  double fl = 0;
  double slope = (double)(e2 - s2) / (double)(e1 - s1);
  double cloc = elem;
  if (e2 - s2 == 0 && e1 - s1 == 0) slope = 1;
  for (; sd < *dn; ++sd) {
    if (fl >= slope || (int)cloc == (int)(cloc + slope)) {
      cloc += slope;
      fl -= slope;
    } else {
      --elem;
      ++fl;
    }
    if (sd <= b->d2) ++elem;
  }
  fl = 0;
  for (; *dn < dt; ++(*dn)) {
    if (fl >= slope || (int)cloc == (int)(cloc + slope)) {
      cloc += slope;
      fl -= slope;
    } else {
      elem -= 1;
      ++fl;
    }
    if (*dn <= b->d2) ++elem;
    int dlen;
    if (*dn < std::min(b->d2, b->d1))
      dlen = *dn;
    else if (*dn < std::max(b->d2, b->d1))
      dlen = std::min(b->d2, b->d1);
    else
      dlen = b->d2 + b->d1 - *dn;
    b->starts[*dn] = std::max(elem - width, 0);
    b->ends[*dn] = std::min(elem + width, dlen - 1);
  }
}

// doShapes (order.c:360-382); anchors ascending.
void do_shapes(const std::vector<Anchor>& ancs, Band* b) {
  int p1 = std::max(kOverlap, kGlWidth) + 1;
  int p2 = std::max(kOverlap, kGlWidth) + 1;
  int dn = 1;
  int width = kGlWidth;
  for (const Anchor& a : ancs) {
    int t1 = a.s1s;
    int t2 = a.s2s;
    int dt = t1 + t2 - 1 + kOverlap;
    mk_square(p1 - std::max(kOverlap, width), p2 - std::max(kOverlap, width),
              t1 + std::max(kOverlap, width), t2 + std::max(kOverlap, width),
              &dn, dt, b);
    p1 = a.s1e;
    p2 = a.s2e;
    dt = p1 + p2 - 1 - kOverlap;
    mk_barrel(t1, t2, p1, p2, width, &dn, dt, b);
  }
  mk_square(p1 - std::max(kOverlap, width), p2 - std::max(kOverlap, width),
            b->d1, b->d2, &dn, b->d1 + b->d2, b);
}

// neck placement (DMinitDiag, diagmatrix.c:69-119)
void find_necks(Band* b) {
  int n = b->d1 + b->d2;
  b->isneck.assign((size_t)n + 2, 0);
  long long j = 0;
  int k = b->ends[1] - b->starts[1] + 1, ko = -1, kf;
  int ctr = 0, sav = 0;
  for (int i = 1; i < n; ++i) {
    kf = (i == n - 1) ? -1 : b->ends[i + 1] - b->starts[i + 1] + 1;
    j += k;
    bool cond = (k < kf) || (k <= kf && ctr >= 1000 && k <= 200);
    if (ko >= k && cond) {
      ctr = 0;
      if (sav) b->isneck[sav] = (int)j;
      j = k + ko;
      sav = i;
    }
    ++ctr;
    ko = k;
    k = kf;
  }
  if (sav) b->isneck[sav] = (int)j;
}

struct AncParse {
  std::vector<Anchor> ancs;  // ascending (readAncFile prepends)
};

void parse_anchors(const std::string& text, int n1, int n2, AncParse* out) {
  // readAncFile (order.c:224-269) with s1start=1, s1end=n1, s2start=1,
  // s2end=n2 (the no -s1/-s2 case).
  std::vector<Anchor> rev;
  size_t pos = 0;
  while (pos < text.size()) {
    size_t eol = text.find('\n', pos);
    if (eol == std::string::npos) eol = text.size();
    std::string line = text.substr(pos, eol - pos);
    pos = eol + 1;
    Anchor a;
    if (std::sscanf(line.c_str(), "(%d %d)=(%d %d)", &a.s1s, &a.s1e, &a.s2s,
                    &a.s2e) != 4)
      continue;
    if (!((a.s1s >= 1 && a.s1e <= n1) && (a.s2s >= 1 && a.s2e <= n2)))
      continue;
    if (a.s1s <= 0 && a.s1e <= 0) continue;
    if (a.s2s <= 0 && a.s2e <= 0) continue;
    if (a.s1s > 1 + n1 && a.s1e > 1 + n1) continue;
    if (a.s2s > 1 + n2 && a.s2e > 1 + n2) continue;
    a.s1s = std::max(a.s1s, 1);
    a.s1e = std::min(a.s1e, n1);
    a.s2s = std::max(a.s2s, 1);
    a.s2e = std::min(a.s2e, n2);
    rev.push_back(a);
  }
  out->ancs.assign(rev.rbegin(), rev.rend());
}

class OrderDP {
 public:
  OrderDP(const char* s1, int n1, const char* s2, int n2, const Band& b)
      : s1_(s1), s2_(s2), band_(b) {
    d1_ = b.d1;
    d2_ = b.d2;
    ndiags_ = d1_ + d2_ - 1;
    ptr_offset_.assign((size_t)ndiags_ + 2, 0);
    size_t tot = 0;
    for (int dn = 1; dn <= ndiags_; ++dn) {
      ptr_offset_[dn] = tot;
      tot += (size_t)(band_.ends[dn] - band_.starts[dn] + 1);
    }
    ptrs_.assign(tot, 0);
  }

  // Runs the DP and the traceback; returns the move list (forward order,
  // column 0 included).  Moves: 0 mismatch, 1 match, 2 insertion (seq1),
  // 3 deletion (seq2).
  std::vector<char> run();

 private:
  inline int diag_of(int x, int y) const { return x + y - 1; }
  inline int elem_of(int dn, int x, int y) const {
    return (dn < d2_) ? (x - 1) : d2_ - y;
  }
  const Alel* get_elem(int x, int y) const {
    int dn = x + y - 1;
    if (dn <= 0 || dn >= d1_ + d2_) return &dummy_;
    int elem = elem_of(dn, x, y);
    if (elem < band_.starts[dn] || elem > band_.ends[dn]) return &dummy_;
    return &ring_[dn % 3][(size_t)(elem - band_.starts[dn])];
  }
  int get_ptr(int x, int y) const {
    int dn = x + y - 1;
    if (dn <= 0 || dn >= d1_ + d2_) return 0xF;
    int elem = elem_of(dn, x, y);
    if (elem < band_.starts[dn] || elem > band_.ends[dn]) return 0xF;
    return ptrs_[ptr_offset_[dn] + (size_t)(elem - band_.starts[dn])];
  }
  void renorm(int diag);  // DMnextNecks score renormalization

  const char* s1_;
  const char* s2_;
  const Band& band_;
  int d1_, d2_, ndiags_;
  std::vector<Alel> ring_[3];
  std::vector<uint8_t> ptrs_;
  std::vector<size_t> ptr_offset_;
  static const Alel dummy_;
};

const Alel OrderDP::dummy_ = {kDummy, kDummy, kDummy};

void OrderDP::renorm(int currdiag) {
  // diagmatrix.c:268-293.  norm is the max M of the current diagonal; when
  // norm <= 0 the reference clamps N and O against the already-shifted M.
  int size = band_.ends[currdiag] - band_.starts[currdiag] + 1;
  std::vector<Alel>& cd = ring_[currdiag % 3];
  int64_t norm = cd[0].M;
  for (int j = 1; j < size; ++j) norm = std::max(cd[j].M, norm);
  for (int i = 0; i < 3; ++i) {
    int dg = currdiag - i;
    if (dg < 1) continue;  // the reference would index a stale ring slot
    int sz = band_.ends[dg] - band_.starts[dg] + 1;
    std::vector<Alel>& dd = ring_[dg % 3];
    for (int j = 0; j < sz; ++j) {
      int64_t t1 = dd[j].M - norm;
      dd[j].M = (norm > 0) ? std::min(dd[j].M, t1) : std::max(dd[j].M, t1);
      t1 = dd[j].N - norm;
      dd[j].N = (norm > 0) ? std::min(dd[j].N, t1) : std::max(dd[j].M, t1);
      t1 = dd[j].O - norm;
      dd[j].O = (norm > 0) ? std::min(dd[j].O, t1) : std::max(dd[j].M, t1);
    }
  }
}

std::vector<char> OrderDP::run() {
  // makeAlign (order.c:609-705)
  ring_[1 % 3].assign((size_t)(band_.ends[1] - band_.starts[1] + 1), Alel{0, 0, 0});
  ring_[1 % 3][0].N = ring_[1 % 3][0].O = kOrderGapStart;
  ring_[1 % 3][0].M = 0;
  ptrs_[ptr_offset_[1]] = 0;

  for (int i = 2; i <= ndiags_; ++i) {
    int size = band_.ends[i] - band_.starts[i] + 1;
    ring_[i % 3].assign((size_t)size, Alel{0, 0, 0});  // calloc per diag
    int x, y;
    if (i < d2_) {
      x = band_.starts[i] + 1;
      y = i - band_.starts[i];
    } else {
      x = i - d2_ + band_.starts[i] + 1;
      y = d2_ - band_.starts[i];
    }
    for (int j = 0; j < size; ++j, ++x, --y) {
      const Alel* p1 = get_elem(x - 1, y - 1);
      const Alel* p0 = get_elem(x - 1, y);
      const Alel* p2 = get_elem(x, y - 1);
      Alel& curr = ring_[i % 3][(size_t)j];
      char c1 = s1_[x - 1], c2 = s2_[y - 1];
      int64_t s1v = p1->M;
      int64_t s2v = p1->N + (iscb(c2) ? 0 : kOrderGapCont);
      int64_t s3v = p1->O + (iscb(c1) ? 0 : kOrderGapCont);
      curr.M = matchscore((unsigned char)c1, (unsigned char)c2);
      if (s1v >= s2v) {
        curr.M += (s1v >= s3v) ? s1v : s3v;
      } else {
        curr.M += (s2v >= s3v) ? s2v : s3v;
      }
      uint8_t ptr;
      s1v = curr.M + (iscb(c2) ? 0 : kOrderGapStart);
      s2v = p0->N + (iscb(c2) ? 0 : kOrderGapCont);
      if (s1v >= s2v) {
        curr.N = s1v;
        ptr = 0;
      } else {
        curr.N = s2v;
        ptr = 4;
      }
      s1v = curr.M + (iscb(c1) ? 0 : kOrderGapStart);
      s2v = p2->O + (iscb(c1) ? 0 : kOrderGapCont);
      if (s1v >= s2v) {
        curr.O = s1v;
      } else {
        curr.O = s2v;
        ptr |= 8;
      }
      if (curr.M >= curr.N) {
        if (curr.M < curr.O) ptr |= 2;
      } else {
        if (curr.N >= curr.O)
          ptr |= 1;
        else
          ptr |= 2;
      }
      ptrs_[ptr_offset_[i] + (size_t)j] = ptr;
    }
    if (i < ndiags_ - 2 && band_.isneck[i]) renorm(i);
  }

  // getChain from (d1, d2) with full pointer retention (order.c:485-556).
  std::vector<char> moves;
  int x = d1_, y = d2_;
  int inrun = 0;
  int zz = get_ptr(x, y);
  do {
    int which = zz & 0x3;
    if (which == 0x3) break;  // off-band: the reference's neck/null case
    if (inrun == 1) {
      if (zz & 0x4) which = 1;
    } else if (inrun == 2) {
      if (zz & 0x8) which = 2;
    }
    if (which == 0) {
      inrun = 0;
      moves.push_back(s1_[x - 1] == s2_[y - 1] ? 1 : 0);
      zz = get_ptr(--x, --y);
    } else if (which == 1) {
      inrun = 1;
      moves.push_back(2);
      zz = get_ptr(--x, y);
    } else {
      inrun = 2;
      moves.push_back(3);
      zz = get_ptr(x, --y);
    }
  } while (x > 0 && y > 0);
  std::reverse(moves.begin(), moves.end());
  return moves;
}

void print_mfa_row(const char* seq, const std::vector<char>& moves, char skip,
                   std::string* out) {
  // printMFAAlign row loop (order.c:776-800): 60 columns, column 0 skipped.
  int s = 1;
  size_t len = moves.size();
  for (size_t c = 1; c < len; c += 60) {
    for (size_t k = c; k < c + 60 && k < len; ++k) {
      if (moves[k] != skip)
        out->push_back(seq[s++]);
      else
        out->push_back('-');
    }
    out->push_back('\n');
  }
}

}  // namespace

void order_mfa(const MappedSeq& s1, const char* name1, const MappedSeq& s2,
               const char* name2, const std::string& anchors_text,
               std::string* out) {
  AncParse ap;
  parse_anchors(anchors_text, s1.numlets, s2.numlets, &ap);
  Band b;
  b.d1 = s1.numlets + 1;
  b.d2 = s2.numlets + 1;
  b.starts.assign((size_t)(b.d1 + b.d2 + 2), 0);
  b.ends.assign((size_t)(b.d1 + b.d2 + 2), 0);
  do_shapes(ap.ancs, &b);
  find_necks(&b);
  OrderDP dp(s1.lets, s1.numlets, s2.lets, s2.numlets, b);
  std::vector<char> moves = dp.run();
  out->append(">");
  out->append(name1);
  out->append("\n");
  print_mfa_row(s1.lets, moves, 3, out);  // 3 = DELETION skips seq1 emission
  out->append(">");
  out->append(name2);
  out->append("\n");
  print_mfa_row(s2.lets, moves, 2, out);  // 2 = INSERTION skips seq2
}

// ---------------------------------------------------------------------------
// Split pipeline: native band construction + traceback around the device
// band DP (see lagan_stages.h).
// ---------------------------------------------------------------------------

namespace {

struct OrderPrepImpl {
  MappedSeq s1, s2;
  Band band;
};

}  // namespace

void* order_prepare(const MappedSeq& s1, const MappedSeq& s2,
                    const std::string& anchors_text) {
  OrderPrepImpl* h = new OrderPrepImpl();
  h->s1 = s1;
  h->s2 = s2;
  h->s1.lets = &h->s1.store[16];
  h->s2.lets = &h->s2.store[16];
  AncParse ap;
  parse_anchors(anchors_text, s1.numlets, s2.numlets, &ap);
  h->band.d1 = s1.numlets + 1;
  h->band.d2 = s2.numlets + 1;
  h->band.starts.assign((size_t)(h->band.d1 + h->band.d2 + 2), 0);
  h->band.ends.assign((size_t)(h->band.d1 + h->band.d2 + 2), 0);
  do_shapes(ap.ancs, &h->band);
  find_necks(&h->band);
  return h;
}

void order_band_dims(void* hv, long long* d1, long long* d2,
                     long long* ndiags, long long* maxw) {
  OrderPrepImpl* h = (OrderPrepImpl*)hv;
  *d1 = h->band.d1;
  *d2 = h->band.d2;
  long long nd = h->band.d1 + h->band.d2 - 1;
  *ndiags = nd;
  long long w = 0;
  for (long long i = 1; i <= nd; ++i) {
    long long s = h->band.ends[(size_t)i] - h->band.starts[(size_t)i] + 1;
    if (s > w) w = s;
  }
  *maxw = w;
}

void order_band_rows(void* hv, int* starts, int* ends, int* isneck_eff) {
  OrderPrepImpl* h = (OrderPrepImpl*)hv;
  long long nd = h->band.d1 + h->band.d2 - 1;
  for (long long i = 1; i <= nd; ++i) {
    starts[i - 1] = h->band.starts[(size_t)i];
    ends[i - 1] = h->band.ends[(size_t)i];
    // the host loop renormalizes only when i < ndiags - 2
    isneck_eff[i - 1] =
        (i < nd - 2 && h->band.isneck[(size_t)i]) ? 1 : 0;
  }
}

void order_mapped_seq(void* hv, int which, char* out) {
  OrderPrepImpl* h = (OrderPrepImpl*)hv;
  const MappedSeq& s = which == 1 ? h->s1 : h->s2;
  std::memcpy(out, s.lets, (size_t)s.numlets + 17);
}

void order_finish_mfa(void* hv, const char* name1, const char* name2,
                      const unsigned char* ptrs, long long wmax,
                      std::string* out) {
  OrderPrepImpl* h = (OrderPrepImpl*)hv;
  const Band& b = h->band;
  int d1 = b.d1, d2 = b.d2;
  int ndiags = d1 + d2 - 1;
  const char* s1 = h->s1.lets;
  const char* s2 = h->s2.lets;
  // get_ptr over the device pointer matrix (row = diag - 1)
  auto get_ptr = [&](int x, int y) -> int {
    int dn = x + y - 1;
    if (dn <= 0 || dn >= d1 + d2) return 0xF;
    int elem = (dn < d2) ? (x - 1) : d2 - y;
    if (elem < b.starts[(size_t)dn] || elem > b.ends[(size_t)dn]) return 0xF;
    return ptrs[(size_t)(dn - 1) * (size_t)wmax
                + (size_t)(elem - b.starts[(size_t)dn])];
  };
  (void)ndiags;
  std::vector<char> moves;
  int x = d1, y = d2;
  int inrun = 0;
  int zz = get_ptr(x, y);
  do {
    int which = zz & 0x3;
    if (which == 0x3) break;
    if (inrun == 1) {
      if (zz & 0x4) which = 1;
    } else if (inrun == 2) {
      if (zz & 0x8) which = 2;
    }
    if (which == 0) {
      inrun = 0;
      moves.push_back(s1[x - 1] == s2[y - 1] ? 1 : 0);
      zz = get_ptr(--x, --y);
    } else if (which == 1) {
      inrun = 1;
      moves.push_back(2);
      zz = get_ptr(--x, y);
    } else {
      inrun = 2;
      moves.push_back(3);
      zz = get_ptr(x, --y);
    }
  } while (x > 0 && y > 0);
  std::reverse(moves.begin(), moves.end());
  out->append(">");
  out->append(name1);
  out->append("\n");
  print_mfa_row(s1, moves, 3, out);
  out->append(">");
  out->append(name2);
  out->append("\n");
  print_mfa_row(s2, moves, 2, out);
}

void order_release(void* hv) { delete (OrderPrepImpl*)hv; }

}  // namespace lagan
