// mlagan (progressive multiple aligner) port for the native LAGAN engine.
//
// Re-implements the observable behavior of the reference mlagan program and
// its profile-alignment core (reference: src/lagan/src/mlagan.c,
// multial.c, with the shared banded diagonal matrix of diagmatrix.c) for
// the flag set C-Sibelia uses (no tree, no fastreject, no postir):
//  * similarity-graph merge tree built from per-pair anchor densities
//    (mlagan.c:593-705), first-token names, strstr lookup;
//  * per-merge sum-of-pairs profile DP with the match/gap caches
//    (multial.c:500-560), per-column gap open/cont/end counts, the scaled
//    gap parameters (gapstart -200 then += gapcont at startup, then
//    per-merge * (numseq-1), multial.c:919 and mlagan.c:994);
//  * anchor shapes with the MISMATCH_CUTOFF filter, the multial mkSquare
//    back-fill pass and barrel slope clamp (multial.c:612-784);
//  * neck renormalization as in the order stage (shared diagmatrix.c);
//  * the multial traceback state machine (inrun from the M-predecessor
//    bits, multial.c:246-352) with full pointer retention;
//  * anchor remapping through each merge (remapHLLs with its float scale
//    arithmetic and score/length cutoffs), merging and re-chaining
//    (mergeHLLs/reanchorHLL with mlagan's findBestChain, which differs
//    from the anchors-stage chain: no gap penalty, keep-last-element);
//  * printFASTAAlign output (column 0 skipped, 60-column rows, trailing
//    blank line).
//
// Anchors are supplied per pair in file order (descending seq1 end), as
// read from rechaos output by getAnchsFromFile (mlagan.c:159-201; the
// list is built by prepending, so it becomes ascending internally).
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <cmath>
#include <string>
#include <vector>
#include <list>
#include <algorithm>

#include "lagan_common.h"

namespace lagan_ml {

const int MAX_SEQ = 63;
const int CNTS_A = 0, CNTS_T = 1, CNTS_C = 2, CNTS_G = 3;
const int CNTS_CB = 4, CNTS_GS = 5, CNTS_GC = 6, CNTS_GE = 7;
const int CNTS_LEN = 8;
const int MISMATCH_CUTOFF = 8;
const int ANCHOR_LENGTH_CUTOFF = 10;
const int ANCHOR_SCORE_CUTOFF = 1500;
const long long kMaxSqSize = 100LL * (1 << 20);  // multial.c:18
const int kGlWidth = 15;
const int kOverlap = 0;
const int64_t kDummy = (int64_t)(-2147483648LL + (1 << 28));

// effective base gap parameters after mlagan startup (nucmatrix -400/-25:
// gapend = -200, gapstart = -200, then main's gapstart += gapcont)
const int kBaseGapStart = -225;
const int kBaseGapEnd = -200;
const int kBaseGapCont = -25;

struct Hll {
  int s1s, s2s, s1e, s2e;
  float score;
  Hll* next = nullptr;
  Hll* bkptr = nullptr;
  float sofar = 0;
  char dirty = 0;
};

struct Seq {
  std::string lets;  // leading 'N' at index 0 (VER_MLAGAN read)
  int numlets = 0;
  std::string name;
  int index = 0;
};

struct Align {
  int index = 0;
  int score = 0;
  int algnlen = 0;
  int numseq = 0;
  std::vector<Seq*> seqs;
  std::vector<uint64_t> algn;        // algnlen+1 entries, last 0
  std::vector<uint8_t> cnts[CNTS_LEN];  // algnlen+1 entries
};

inline int let_index(char c) {  // alpha = "ATCG.N" (multial.c:32)
  switch (c) {
    case 'A': return 0;
    case 'T': return 1;
    case 'C': return 2;
    case 'G': return 3;
    case '.': return 4;
    case 'N': return 5;
    default: return 5;
  }
}

inline bool is_gap(const Align& a, int seqn, int loc) {
  return !((a.algn[(size_t)loc] >> seqn) & 1);
}

// ---------------------------------------------------------------------------
// caches (multial.c:500-560); rebuilt per merge with scaled gap params
// ---------------------------------------------------------------------------

struct Caches {
  std::vector<int> matchcache, gapcache;
  int gapstart, gapend, gapcont;

  Caches() : matchcache((size_t)1 << 24), gapcache((size_t)1 << 24) {
    build_match();
  }
  void build_match() {
    static const char lets[5] = "ATCG";
    for (int a = 0; a <= MAX_SEQ; ++a)
      for (int t = 0; t <= MAX_SEQ; ++t)
        for (int c = 0; c <= MAX_SEQ; ++c)
          for (int g = 0; g <= MAX_SEQ; ++g) {
            int num[4] = {a, t, c, g};
            int score = 0;
            for (int i = 0; i < 4; ++i) {
              score += num[i] * (num[i] - 1) / 2 *
                       lagan::matchscore((unsigned char)lets[i],
                                         (unsigned char)lets[i]);
              for (int j = i + 1; j < 4; ++j)
                score += num[i] * num[j] *
                         lagan::matchscore((unsigned char)lets[i],
                                           (unsigned char)lets[j]);
            }
            matchcache[(size_t)(a | (t << 6) | (c << 12) | (g << 18))] =
                score;
          }
  }
  void build_gap(int gs, int gc, int ge) {
    gapstart = gs;
    gapcont = gc;
    gapend = ge;
    for (int s = 0; s <= MAX_SEQ; ++s)
      for (int c = 0; c <= MAX_SEQ; ++c)
        for (int e = 0; e <= MAX_SEQ; ++e)
          for (int n = 0; n <= MAX_SEQ; ++n)
            gapcache[(size_t)(s | (c << 6) | (e << 12) | (n << 18))] =
                std::min(c, n - c) * gapcont + std::min(s, n - s) * gapstart +
                std::min(e, n - e) * gapend;
  }
};

// ---------------------------------------------------------------------------
// band shapes (multial.c:612-784)
// ---------------------------------------------------------------------------

struct Band {
  int d1, d2;
  std::vector<int> starts, ends, isneck;
};

void mk_barrel(int s1, int s2, int e1, int e2, int width, int* dn, int dt,
               Band* b) {
  int sd = s1 + s2 - 1;
  int elem = (sd < b->d2) ? s1 : b->d2 - s2;
  double fl = 0;
  double slope = (double)(e2 - s2) / (double)(e1 - s1);
  double cloc = elem;
  if (e2 - s2 == 0 && e1 - s1 == 0) slope = 1;
  else if (e1 - s1 == 0) slope = 100000;  // multial.c:622-623
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
    b->starts[(size_t)*dn] = std::max(elem - width, 0);
    b->ends[(size_t)*dn] = std::min(elem + width, dlen - 1);
  }
}

void mk_square(int s1, int s2, int e1, int e2, int* dn, int dt, Band* b) {
  long long size = ((long long)e1 - s1) * ((long long)e2 - s2);
  if (size > kMaxSqSize) {
    mk_square(s1, s2, (s1 + e1) / 2 + kGlWidth, (s2 + e2) / 2 + kGlWidth, dn,
              (*dn + dt) / 2, b);
    mk_square((s1 + e1) / 2 - kGlWidth, (s2 + e2) / 2 - kGlWidth, e1, e2, dn,
              dt, b);
    return;
  }
  // back-fill pass (multial.c:681-711): widen already-assigned diagonals
  // behind the square until the opening is <= 5 cells
  int dn2 = *dn - 1;
  while (true) {
    int dists0, dists1, dlen, sval, eval;
    if (dn2 < b->d2) {
      dists0 = s1 - 1;
      dists1 = dn2 - e2;
    } else {
      dists0 = b->d2 - e2;
      dists1 = s1 - (dn2 - b->d2) - 1;
    }
    sval = std::max(std::max(dists0, dists1), 0);
    b->starts[(size_t)dn2] = std::min(b->starts[(size_t)dn2], sval);
    if (dn2 < b->d2) {
      dists0 = e1 - 1;
      dists1 = dn2 - s2;
    } else {
      dists0 = b->d2 - s2;
      dists1 = e1 - (dn2 - b->d2) - 1;
    }
    if (dn2 < std::min(b->d2, b->d1))
      dlen = dn2;
    else if (dn2 < std::max(b->d2, b->d1))
      dlen = std::min(b->d2, b->d1);
    else
      dlen = b->d2 + b->d1 - dn2;
    eval = std::min(std::min(dists0, dists1), dlen - 1);
    b->ends[(size_t)dn2] = std::max(b->ends[(size_t)dn2], eval);
    if (eval - sval <= 5) break;
    --dn2;
  }
  for (; *dn < dt; ++(*dn)) {
    int dists0, dists1, dlen;
    if (*dn < b->d2) {
      dists0 = s1 - 1;
      dists1 = *dn - e2;
    } else {
      dists0 = b->d2 - e2;
      dists1 = s1 - (*dn - b->d2) - 1;
    }
    b->starts[(size_t)*dn] = std::max(std::max(dists0, dists1), 0);
    if (*dn < b->d2) {
      dists0 = e1 - 1;
      dists1 = *dn - s2;
    } else {
      dists0 = b->d2 - s2;
      dists1 = e1 - (*dn - b->d2) - 1;
    }
    if (*dn < std::min(b->d2, b->d1))
      dlen = *dn;
    else if (*dn < std::max(b->d2, b->d1))
      dlen = std::min(b->d2, b->d1);
    else
      dlen = b->d2 + b->d1 - *dn;
    b->ends[(size_t)*dn] = std::min(std::min(dists0, dists1), dlen - 1);
  }
}

void do_shapes(Hll* myres, Band* b) {
  int p1 = std::max(kOverlap, kGlWidth) + 1;
  int p2 = std::max(kOverlap, kGlWidth) + 1;
  int dn = 1;
  int width = kGlWidth;
  while (myres) {
    while (true) {  // validity filter (multial.c:750-759)
      if (!myres ||
          (myres->s1s >= 1 && myres->s2s >= 1 && myres->s1e >= 1 &&
           myres->s2e >= 1 && myres->s1s < b->d1 && myres->s2s < b->d2 &&
           myres->s1s < myres->s1e && myres->s2s < myres->s2e &&
           myres->s1e < b->d1 && myres->s2e < b->d2 &&
           std::abs((myres->s1e - myres->s1s) - (myres->s2e - myres->s2s)) <=
               MISMATCH_CUTOFF))
        break;
      myres = myres->next;
    }
    if (!myres) break;
    int t1 = myres->s1s;
    int t2 = myres->s2s;
    int dt = t1 + t2 - 1 + kOverlap;
    mk_square(p1 - std::max(kOverlap, width), p2 - std::max(kOverlap, width),
              t1 + std::max(kOverlap, width), t2 + std::max(kOverlap, width),
              &dn, dt, b);
    p1 = myres->s1e;
    p2 = myres->s2e;
    dt = p1 + p2 - 1 - kOverlap;
    mk_barrel(t1, t2, p1, p2, width, &dn, dt, b);
    myres = myres->next;
  }
  mk_square(p1 - std::max(kOverlap, width), p2 - std::max(kOverlap, width),
            b->d1, b->d2, &dn, b->d1 + b->d2, b);
}

void find_necks(Band* b) {  // diagmatrix.c:69-119
  int n = b->d1 + b->d2;
  b->isneck.assign((size_t)n + 2, 0);
  long long j = 0;
  int k = b->ends[1] - b->starts[1] + 1, ko = -1, kf;
  int ctr = 0, sav = 0;
  for (int i = 1; i < n; ++i) {
    kf = (i == n - 1) ? -1 : b->ends[(size_t)(i + 1)] - b->starts[(size_t)(i + 1)] + 1;
    j += k;
    bool cond = (k < kf) || (k <= kf && ctr >= 1000 && k <= 200);
    if (ko >= k && cond) {
      ctr = 0;
      if (sav) b->isneck[(size_t)sav] = (int)j;
      j = k + ko;
      sav = i;
    }
    ++ctr;
    ko = k;
    k = kf;
  }
  if (sav) b->isneck[(size_t)sav] = (int)j;
}

// ---------------------------------------------------------------------------
// profile DP (doNW, multial.c:799-909)
// ---------------------------------------------------------------------------

struct Alel {
  int64_t M, N, O;
};

class ProfileDP {
 public:
  ProfileDP(const Align& a1, const Align& a2, const Band& b, Caches& caches)
      : a1_(a1), a2_(a2), band_(b), c_(caches) {
    d1_ = b.d1;
    d2_ = b.d2;
    ndiags_ = d1_ + d2_ - 1;
    ptr_offset_.assign((size_t)ndiags_ + 2, 0);
    size_t tot = 0;
    for (int dn = 1; dn <= ndiags_; ++dn) {
      ptr_offset_[(size_t)dn] = tot;
      tot += (size_t)(band_.ends[(size_t)dn] - band_.starts[(size_t)dn] + 1);
    }
    ptrs_.assign(tot, 0);
  }

  // moves: 1 INSERTION (x), 2 DELETION (y), 3 BOTH; forward order, column
  // 0 (the sentinel cell) included.
  std::vector<uint8_t> run();

 private:
  const Alel* get_elem(int x, int y) const {
    int dn = x + y - 1;
    if (dn <= 0 || dn >= d1_ + d2_) return &dummy_;
    int elem = (dn < d2_) ? (x - 1) : d2_ - y;
    if (elem < band_.starts[(size_t)dn] || elem > band_.ends[(size_t)dn])
      return &dummy_;
    return &ring_[dn % 3][(size_t)(elem - band_.starts[(size_t)dn])];
  }
  int get_ptr(int x, int y) const {
    int dn = x + y - 1;
    if (dn <= 0 || dn >= d1_ + d2_) return 0xF;
    int elem = (dn < d2_) ? (x - 1) : d2_ - y;
    if (elem < band_.starts[(size_t)dn] || elem > band_.ends[(size_t)dn])
      return 0xF;
    return ptrs_[ptr_offset_[(size_t)dn] +
                 (size_t)(elem - band_.starts[(size_t)dn])];
  }
  void renorm(int currdiag);

  int matchsc(int ai, int bi) const {
    const auto& ac = a1_.cnts;
    const auto& bc = a2_.cnts;
    return c_.matchcache[(size_t)((ac[0][(size_t)ai] + bc[0][(size_t)bi]) |
                                  ((ac[1][(size_t)ai] + bc[1][(size_t)bi]) << 6) |
                                  ((ac[2][(size_t)ai] + bc[2][(size_t)bi]) << 12) |
                                  ((ac[3][(size_t)ai] + bc[3][(size_t)bi]) << 18))] +
           c_.gapcache[(size_t)((ac[CNTS_GS][(size_t)ai] + bc[CNTS_GS][(size_t)bi]) |
                                ((ac[CNTS_GC][(size_t)ai] + bc[CNTS_GC][(size_t)bi]) << 6) |
                                ((ac[CNTS_GE][(size_t)ai] + bc[CNTS_GE][(size_t)bi]) << 12) |
                                ((a1_.numseq + a2_.numseq -
                                  (ac[CNTS_CB][(size_t)ai] + bc[CNTS_CB][(size_t)bi])) << 18))];
  }
  int score_opp(const Align& o, int ow) const {
    return c_.matchcache[(size_t)(o.cnts[0][(size_t)ow] |
                                  (o.cnts[1][(size_t)ow] << 6) |
                                  (o.cnts[2][(size_t)ow] << 12) |
                                  (o.cnts[3][(size_t)ow] << 18))];
  }
  int end_gap0(int ai, int bi) const {
    return c_.gapcache[(size_t)(((a1_.cnts[CNTS_GE][(size_t)ai] +
                                  a2_.cnts[CNTS_GE][(size_t)bi]) << 12) |
                                ((a1_.numseq + a2_.numseq -
                                  (a2_.cnts[CNTS_CB][(size_t)bi] +
                                   a1_.cnts[CNTS_CB][(size_t)ai])) << 18))];
  }
  int end_gap1(int ai, int bi) const {
    return c_.gapcache[(size_t)((((a2_.numseq - a2_.cnts[CNTS_GS][(size_t)bi] -
                                   a2_.cnts[CNTS_GC][(size_t)bi]) +
                                  a1_.cnts[CNTS_GE][(size_t)ai]) << 12) |
                                ((a1_.numseq + a2_.numseq -
                                  (a2_.cnts[CNTS_CB][(size_t)bi] +
                                   a1_.cnts[CNTS_CB][(size_t)ai])) << 18))];
  }
  int end_gap2(int ai, int bi) const {
    return c_.gapcache[(size_t)((((a1_.numseq - a1_.cnts[CNTS_GS][(size_t)ai] -
                                   a1_.cnts[CNTS_GC][(size_t)ai]) +
                                  a2_.cnts[CNTS_GE][(size_t)bi]) << 12) |
                                ((a1_.numseq + a2_.numseq -
                                  (a2_.cnts[CNTS_CB][(size_t)bi] +
                                   a1_.cnts[CNTS_CB][(size_t)ai])) << 18))];
  }
  // openGap(ali, w, other, ow) — multial.c:593-609
  int open_gap(const Align& ali, int w, const Align& other, int ow) const {
    int alopen = ali.cnts[CNTS_GC][(size_t)w] + ali.cnts[CNTS_GE][(size_t)w];
    return c_.gapcache[(size_t)((ali.numseq -
                                 (alopen + ali.cnts[CNTS_CB][(size_t)w]) +
                                 other.cnts[CNTS_GS][(size_t)ow]) |
                                ((alopen + other.cnts[CNTS_GC][(size_t)ow]) << 6) |
                                (other.cnts[CNTS_GE][(size_t)ow] << 12) |
                                ((ali.numseq + other.numseq -
                                  (ali.cnts[CNTS_CB][(size_t)w] +
                                   other.cnts[CNTS_CB][(size_t)ow])) << 18))];
  }
  // contGap(ali, myw, other, ow, sopp) — multial.c:585-591
  int cont_gap(const Align& ali, int myw, const Align& other, int ow,
               const std::vector<int>& sopp) const {
    return c_.gapcache[(size_t)(other.cnts[CNTS_GS][(size_t)ow] |
                                ((ali.numseq + other.cnts[CNTS_GC][(size_t)ow]) << 6) |
                                (other.cnts[CNTS_GE][(size_t)ow] << 12) |
                                ((ali.numseq + other.numseq -
                                  (ali.cnts[CNTS_CB][(size_t)myw] +
                                   other.cnts[CNTS_CB][(size_t)ow])) << 18))] +
           sopp[(size_t)ow];
  }

  const Align& a1_;
  const Align& a2_;
  const Band& band_;
  Caches& c_;
  int d1_, d2_, ndiags_;
  std::vector<Alel> ring_[3];
  std::vector<uint8_t> ptrs_;
  std::vector<size_t> ptr_offset_;
  static const Alel dummy_;
};

const Alel ProfileDP::dummy_ = {kDummy, kDummy, kDummy};

void ProfileDP::renorm(int currdiag) {  // diagmatrix.c:268-293
  int size = band_.ends[(size_t)currdiag] - band_.starts[(size_t)currdiag] + 1;
  std::vector<Alel>& cd = ring_[currdiag % 3];
  int64_t norm = cd[0].M;
  for (int j = 1; j < size; ++j) norm = std::max(cd[j].M, norm);
  for (int i = 0; i < 3; ++i) {
    int dg = currdiag - i;
    if (dg < 1) continue;
    int sz = band_.ends[(size_t)dg] - band_.starts[(size_t)dg] + 1;
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

std::vector<uint8_t> ProfileDP::run() {
  std::vector<int> sopp1((size_t)a1_.algnlen + 1, 0);
  std::vector<int> sopp2((size_t)a2_.algnlen + 1, 0);
  for (int i = 0; i < a1_.algnlen; ++i) sopp1[(size_t)i] = score_opp(a1_, i);
  for (int i = 0; i < a2_.algnlen; ++i) sopp2[(size_t)i] = score_opp(a2_, i);

  ring_[1 % 3].assign(
      (size_t)(band_.ends[1] - band_.starts[1] + 1), Alel{0, 0, 0});
  ring_[1 % 3][0] = Alel{0, 0, 0};  // curr->M = N = O = 0 (multial.c:819-820)
  ptrs_[ptr_offset_[1]] = 0;

  for (int i = 2; i <= ndiags_; ++i) {
    int size = band_.ends[(size_t)i] - band_.starts[(size_t)i] + 1;
    ring_[i % 3].assign((size_t)size, Alel{0, 0, 0});
    int x, y;
    if (i < d2_) {
      x = band_.starts[(size_t)i] + 1;
      y = i - band_.starts[(size_t)i];
    } else {
      x = i - d2_ + band_.starts[(size_t)i] + 1;
      y = d2_ - band_.starts[(size_t)i];
    }
    for (int j = 0; j < size; ++j, ++x, --y) {
      int gapstartN = open_gap(a2_, y, a1_, x);
      int gapstartO = open_gap(a1_, x, a2_, y);
      int gapcontN = cont_gap(a2_, y, a1_, x - 1, sopp1);
      int gapcontO = cont_gap(a1_, x, a2_, y - 1, sopp2);

      const Alel* p1 = get_elem(x - 1, y - 1);
      const Alel* p0 = get_elem(x - 1, y);
      const Alel* p2 = get_elem(x, y - 1);
      Alel& curr = ring_[i % 3][(size_t)j];

      curr.M = matchsc(x - 1, y - 1);
      int64_t z1 = p1->M + end_gap0(x - 1, y - 1);
      int64_t z2 = p1->N + end_gap1(x - 1, y - 1);
      int64_t z3 = p1->O + end_gap2(x - 1, y - 1);
      uint8_t ptr;
      if (z1 >= z2) {
        if (z1 >= z3) { curr.M += z1; ptr = 0; }
        else          { curr.M += z3; ptr = 2; }
      } else {
        if (z2 >= z3) { curr.M += z2; ptr = 1; }
        else          { curr.M += z3; ptr = 2; }
      }
      int64_t s2 = p0->N + gapcontN;
      int64_t s3 = p2->O + gapcontO;
      int64_t s1 = curr.M + gapstartN;
      if (s1 >= s2) { curr.N = s1; }
      else          { curr.N = s2; ptr |= 4; }
      s1 = curr.M + gapstartO;
      if (s1 >= s3) { curr.O = s1; }
      else          { curr.O = s3; ptr |= 8; }
      ptrs_[ptr_offset_[(size_t)i] + (size_t)j] = ptr;
    }
    if (band_.isneck[(size_t)i]) renorm(i);
  }

  // getChain from (d1, d2), state 0 (multial.c:246-352) with full pointer
  // retention; moves reversed to forward order afterwards.
  std::vector<uint8_t> moves;
  int x = d1_, y = d2_;
  int inrun = 0;
  int zz = get_ptr(x, y);
  do {
    int which = zz & 0x3;
    if (which == 0x3) break;
    if (inrun == 1 && (zz & 0x4))
      which = 1;
    else if (inrun == 2 && (zz & 0x8))
      which = 2;
    else
      which = 0;
    if (which == 0) {
      inrun = zz & 0x3;
      moves.push_back(3);  // BOTH
      zz = get_ptr(--x, --y);
    } else if (which == 1) {
      inrun = 1;
      moves.push_back(1);  // INSERTION
      zz = get_ptr(--x, y);
    } else {
      inrun = 2;
      moves.push_back(2);  // DELETION
      zz = get_ptr(x, --y);
    }
  } while (x > 0 && y > 0);
  std::reverse(moves.begin(), moves.end());
  return moves;
}

// ---------------------------------------------------------------------------
// alignment construction (mkSimAlign / unifyAlign, multial.c:952-988,185-243)
// ---------------------------------------------------------------------------

Align* mk_sim_align(Seq* s) {
  Align* res = new Align;
  res->score = 0;
  res->numseq = 1;
  res->algnlen = s->numlets;
  res->seqs.push_back(s);
  res->algn.assign((size_t)res->algnlen + 1, 0);
  for (int j = 0; j < CNTS_LEN; ++j)
    res->cnts[j].assign((size_t)res->algnlen + 1, 0);
  int oldk = -1;
  for (int i = 0; i < res->algnlen; ++i) {
    res->algn[(size_t)i] = 1;
    int k = let_index(s->lets[(size_t)i]);
    if (k < 5) res->cnts[k][(size_t)i]++;
    if (oldk == 4) res->cnts[4][(size_t)i]++;
    oldk = k;
  }
  res->algn[(size_t)res->algnlen] = 0;
  return res;
}

Align* unify_align(Align* a1, Align* a2, const std::vector<uint8_t>& uni) {
  // uni: per-column moves (bit0 = a1 consumed, bit1 = a2 consumed)
  Align* res = new Align;
  res->numseq = a1->numseq + a2->numseq;
  res->algnlen = (int)uni.size();
  res->algn.assign((size_t)res->algnlen + 1, 0);
  for (int j = 0; j < CNTS_LEN; ++j)
    res->cnts[j].assign((size_t)res->algnlen + 1, 0);
  {
    int s1 = 0, s2 = 0;
    for (int i = 0; i <= res->algnlen; ++i) {
      uint64_t u = (i < res->algnlen) ? uni[(size_t)i] : 0;
      res->algn[(size_t)i] = 0;
      if (u & 1) res->algn[(size_t)i] |= a1->algn[(size_t)s1++];
      if (u & 2)
        res->algn[(size_t)i] |= (a2->algn[(size_t)s2++] << a1->numseq);
    }
  }
  for (int i = 0; i < a1->numseq; ++i) res->seqs.push_back(a1->seqs[(size_t)i]);
  for (int i = 0; i < a2->numseq; ++i) res->seqs.push_back(a2->seqs[(size_t)i]);

  // per-sequence gap matrix and count rebuild (multial.c:213-238)
  std::vector<std::string> mat((size_t)res->numseq);
  for (int i = 0; i < res->numseq; ++i) {
    mat[(size_t)i].resize((size_t)res->algnlen + 1);
    int k = 0;
    for (int j = 0; j <= res->algnlen; ++j)
      mat[(size_t)i][(size_t)j] =
          is_gap(*res, i, j) ? '-' : res->seqs[(size_t)i]->lets[(size_t)k++];
  }
  for (int i = 0; i <= res->algnlen; ++i) {
    for (int j = 0; j < res->numseq; ++j) {
      char ch = mat[(size_t)j][(size_t)i];
      switch (ch) {
        case 'A': res->cnts[CNTS_A][(size_t)i]++; if (i > 1 && mat[(size_t)j][(size_t)(i - 1)] == '-') res->cnts[CNTS_GE][(size_t)i]++; break;
        case 'T': res->cnts[CNTS_T][(size_t)i]++; if (i > 1 && mat[(size_t)j][(size_t)(i - 1)] == '-') res->cnts[CNTS_GE][(size_t)i]++; break;
        case 'C': res->cnts[CNTS_C][(size_t)i]++; if (i > 1 && mat[(size_t)j][(size_t)(i - 1)] == '-') res->cnts[CNTS_GE][(size_t)i]++; break;
        case 'G': res->cnts[CNTS_G][(size_t)i]++; if (i > 1 && mat[(size_t)j][(size_t)(i - 1)] == '-') res->cnts[CNTS_GE][(size_t)i]++; break;
        case '-':
          if (i > 0 && mat[(size_t)j][(size_t)(i - 1)] == '-')
            res->cnts[CNTS_GC][(size_t)i]++;
          else
            res->cnts[CNTS_GS][(size_t)i]++;
          break;
        default: break;
      }
    }
  }
  return res;
}

// ---------------------------------------------------------------------------
// anchor list machinery (swap/merge/remap/reanchor)
// ---------------------------------------------------------------------------

void swap_hll(Hll* h) {
  for (; h; h = h->next) {
    std::swap(h->s1s, h->s2s);
    std::swap(h->s1e, h->s2e);
  }
}

int hll_intersection(const Hll* h1, const Hll* h2) {
  if (!h1 || !h2) return 0;
  int i = std::max(h1->s1s, h2->s1s);
  int j = std::min(h1->s1e, h2->s1e);
  int r1 = (i < j) ? j - i : 0;
  i = std::max(h1->s2s, h2->s2s);
  j = std::min(h1->s2e, h2->s2e);
  int r2 = (i < j) ? j - i : 0;
  return std::min(r1, r2);
}

int hll_union(const Hll* h1, const Hll* h2) {
  if (!h1 && !h2) return 0;
  if (!h1) return std::max(h2->s1e - h2->s1s, h2->s2e - h2->s2s);
  if (!h2) return std::max(h1->s1e - h1->s1s, h1->s2e - h1->s2s);
  int i = std::min(h1->s1s, h2->s1s);
  int j = std::max(h1->s1e, h2->s1e);
  int r1 = (i < j) ? j - i : 0;
  i = std::min(h1->s2s, h2->s2s);
  j = std::max(h1->s2e, h2->s2e);
  int r2 = (i < j) ? j - i : 0;
  return std::max(r1, r2);
}

float score_merge(const Hll* h1, const Hll* h2) {
  float i = (float)hll_intersection(h1, h2);
  float u = (float)hll_union(h1, h2);
  return (h1->score + h2->score) * (i / u);
}

Hll* merge_hlls(Hll* a1, int wh1, Hll* a2, int wh2) {  // multial.c:1407-1462
  if (wh1) swap_hll(a1);
  if (wh2) swap_hll(a2);
  if (a1 == a2) return a1;
  Hll* res = nullptr;
  while (a1 && a2) {
    if (hll_intersection(a1, a2)) {
      int mscore = (int)score_merge(a1, a2);
      float mx = std::max(std::max(a1->score, a2->score), (float)mscore);
      if (mx == (float)mscore) {
        Hll* t = new Hll;
        t->s1s = std::min(a1->s1s, a2->s1s);
        t->s1e = std::max(a1->s1e, a2->s1e);
        t->s2s = std::min(a1->s2s, a2->s2s);
        t->s2e = std::max(a1->s2e, a2->s2e);
        t->score = (float)mscore;
        t->next = res;
        res = t;
      }
    }
    if (std::min(a1->s1e, a2->s1e) == a2->s1e) {
      Hll* t = a2->next;
      a2->next = res;
      res = a2;
      a2 = t;
    } else {
      Hll* t = a1->next;
      a1->next = res;
      res = a1;
      a1 = t;
    }
  }
  while (a1) {
    Hll* t = a1->next;
    a1->next = res;
    res = a1;
    a1 = t;
  }
  while (a2) {
    Hll* t = a2->next;
    a2->next = res;
    res = a2;
    a2 = t;
  }
  return res;
}

// mlagan's chain selector (mlagan.c:272-303): no gap penalty, dominated
// ends pruned with >=, result = last surviving element.
Hll* find_best_chain_ml(std::vector<std::pair<int, char>>& order,
                        std::vector<Hll*>& hits) {
  struct Entry {
    int index;
    Hll* hit;
  };
  std::list<Entry> lst;
  lst.push_back(Entry{INT32_MIN, nullptr});
  auto find_lt = [&](int key) {
    auto last = lst.begin();
    for (auto it = std::next(lst.begin()); it != lst.end(); ++it) {
      if (it->index >= key) break;
      last = it;
    }
    return last;
  };
  for (size_t e = 0; e < order.size(); ++e) {
    Hll* h = hits[(size_t)order[e].first];
    if (order[e].second) {  // start event
      auto help = find_lt(h->s2s);
      if (help->hit) {
        h->bkptr = help->hit;
        h->sofar = help->hit->sofar + h->score;
      } else {
        h->bkptr = nullptr;
        h->sofar = h->score;
      }
    } else {
      auto help = find_lt(h->s2e);
      if (help->hit && h->sofar <= help->hit->sofar) continue;
      auto ins = lst.insert(std::next(help), Entry{h->s2e, h});
      while (std::next(ins) != lst.end() &&
             ins->hit->sofar >= std::next(ins)->hit->sofar)
        lst.erase(std::next(ins));
    }
  }
  return lst.back().hit;
}

Hll* reanchor_hll(Hll* mylist) {  // mlagan.c:321-352
  if (!mylist) return nullptr;
  std::vector<Hll*> hits;
  for (Hll* t = mylist; t; t = t->next) {
    t->dirty = 1;
    hits.push_back(t);
  }
  // event array in list order; glibc-msort semantics of the inconsistent
  // comparator: starts stable, equal-position end events reversed.
  struct Ev {
    int number;
    char isstart;
    int hit;
  };
  std::vector<Ev> ev;
  ev.reserve(hits.size() * 2);
  for (size_t i = 0; i < hits.size(); ++i) {
    ev.push_back(Ev{hits[i]->s1s, 1, (int)i});
    ev.push_back(Ev{hits[i]->s1e, 0, (int)i});
  }
  std::stable_sort(ev.begin(), ev.end(), [](const Ev& a, const Ev& b) {
    if (a.number != b.number) return a.number < b.number;
    return a.isstart > b.isstart;
  });
  for (size_t i = 0; i < ev.size();) {
    size_t j = i + 1;
    while (j < ev.size() && ev[j].number == ev[i].number &&
           ev[j].isstart == ev[i].isstart)
      ++j;
    if (!ev[i].isstart && j - i > 1)
      std::reverse(ev.begin() + (long)i, ev.begin() + (long)j);
    i = j;
  }
  std::vector<std::pair<int, char>> order;
  order.reserve(ev.size());
  for (const Ev& e : ev) order.push_back({e.hit, e.isstart});
  Hll* best = find_best_chain_ml(order, hits);
  for (Hll* t = best; t; t = t->bkptr) t->dirty = 0;
  // free dropped, rebuild ascending via bkptr-walk prepend (remakeHLL)
  for (Hll* t = mylist; t;) {
    Hll* nx = t->next;
    if (t->dirty) delete t;
    t = nx;
  }
  Hll* res = nullptr;
  for (Hll* t = best; t; t = t->bkptr) {
    t->next = res;
    t->dirty = 1;
    res = t;
  }
  return res;
}

int countpos(const Align& a, int seqnum) {
  int j = 0;
  for (int i = 0; i < a.algnlen; ++i)
    if (!is_gap(a, seqnum, i)) ++j;
  return j;
}

// remapHLLs (multial.c:1103-1305): rewrite one coordinate axis of the
// anchor list through the uni alignment's gap structure.
Hll* remap_hlls(Hll* anchs, int which, const Align& aln, int seqnum) {
  if (!anchs) return anchs;
  int mylen = countpos(aln, seqnum);
  for (Hll* t = anchs; t; t = t->next) {
    if (t->s1s < 1) t->s1s = 1;
    if (t->s2s < 1) t->s2s = 1;
    if (!which && t->s1e > mylen) t->s1e = mylen;
    else if (which && t->s2e > mylen) t->s2e = mylen;
  }
  Hll head;
  head.next = anchs;
  Hll* prev = &head;
  int mybp = 0, stmybp = 0;
  char isfrst = 1;
  // searchint models the reference's pointer into the current field
  enum Field { S1S, S1E, S2S, S2E };
  Field fld = which ? S2S : S1S;
  auto getf = [&](Hll* h) -> int& {
    switch (fld) {
      case S1S: return h->s1s;
      case S1E: return h->s1e;
      case S2S: return h->s2s;
      default: return h->s2e;
    }
  };
  Hll* cur = anchs;
  for (int i = 1; i <= aln.algnlen; ++i) {
    if (is_gap(aln, seqnum, i)) {
      if (isfrst) continue;
      float scale;
      int osize;
      if (!which) {
        scale = (cur->s1e == stmybp)
                    ? 0.0f
                    : (float)(mybp - stmybp) / (float)(cur->s1e - stmybp);
        osize = (int)((cur->s2e - cur->s2s) * scale);
      } else {
        scale = (cur->s2e == stmybp)
                    ? 0.0f
                    : (float)(mybp - stmybp) / (float)(cur->s2e - stmybp);
        osize = (int)((cur->s1e - cur->s1s) * scale);
      }
      if (cur->score * scale < (float)ANCHOR_SCORE_CUTOFF) {
        if (!which) {
          cur->score -= cur->score * scale;
          cur->s1s = mybp + 1;
          cur->s2s = cur->s2s + osize + 1;
          isfrst = 1;
          fld = S1S;
        } else {
          cur->score -= cur->score * scale;
          cur->s1s = cur->s1s + osize + 1;
          cur->s2s = mybp + 1;
          isfrst = 1;
          fld = S2S;
        }
        if (cur->s1s >= cur->s1e || cur->s2s >= cur->s2e) {
          Hll* t = cur;
          prev->next = cur->next;
          cur = cur->next;
          delete t;
          if (!cur) break;
          fld = which ? S2S : S1S;
        }
        continue;
      }
      Hll* t = new Hll;
      t->next = cur->next;
      cur->next = t;
      t->s1e = cur->s1e;
      t->s2e = cur->s2e;
      if (!which) {
        t->score = cur->score * scale;
        cur->score -= t->score;
        cur->s1e = i;
        cur->s2e = cur->s2s + osize;
        t->s1s = mybp + 1;
        t->s2s = cur->s2e + 1;
        isfrst = 1;
        fld = S1S;
      } else {
        t->score = cur->score * scale;
        cur->score -= t->score;
        cur->s1e = cur->s1s + osize;
        cur->s2e = i;
        t->s1s = cur->s1e + 1;
        t->s2s = mybp + 1;
        isfrst = 1;
        fld = S2S;
      }
      prev = cur;
      cur = t;
      if (cur->s1s >= cur->s1e || cur->s2s >= cur->s2e) {
        Hll* t2 = cur;
        prev->next = cur->next;
        cur = cur->next;
        delete t2;
        if (!cur) break;
        fld = which ? S2S : S1S;
      }
      continue;
    }
    ++mybp;
    if (mybp == getf(cur)) {
      if (isfrst) {
        getf(cur) = i;
        fld = which ? S2E : S1E;
        stmybp = mybp;
        isfrst = !isfrst;
      }
    }
    if (cur && mybp == getf(cur)) {
      if (!isfrst) {
        getf(cur) = i;
        if ((which == 0 && cur->s1e - cur->s1s < ANCHOR_LENGTH_CUTOFF) ||
            (which == 1 && cur->s2e - cur->s2s < ANCHOR_LENGTH_CUTOFF)) {
          Hll* t = cur;
          prev->next = cur->next;
          cur = cur->next;
          delete t;
        } else {
          prev = cur;
          cur = cur->next;
        }
        if (!cur) break;
        fld = which ? S2S : S1S;
        isfrst = !isfrst;
      }
    }
  }
  return head.next;
}

}  // namespace lagan_ml

namespace lagan_ml {

// ---------------------------------------------------------------------------
// main flow (mlagan.c: tree build, RPN, progressive merging)
// ---------------------------------------------------------------------------

struct Context {
  int nseq = 0;
  std::vector<Seq> seqs;
  std::vector<Align*> simaligns;               // index-addressed rows
  std::vector<std::vector<Hll*>> hlls;         // hlls[i][j], i < j
  Caches caches;
  // prolagan profile inputs (prolagan.c:187-228): gapped rows + the file
  // index of each row's member sequence, in profile row order.
  std::vector<std::string> prof_rows[2];
  std::vector<int> prof_members[2];
  Align* profile[2] = {nullptr, nullptr};
  bool name_missing = false;
};

Align* make_align_pair(Context& ctx, Align* a1, Align* a2, Hll* anchors,
                       std::vector<uint8_t>* uni_out) {
  int numseq = a1->numseq + a2->numseq;
  ctx.caches.build_gap(kBaseGapStart * (numseq - 1),
                       kBaseGapCont * (numseq - 1),
                       kBaseGapEnd * (numseq - 1));
  Band b;
  b.d1 = a1->algnlen;
  b.d2 = a2->algnlen;
  b.starts.assign((size_t)(a1->algnlen + a2->algnlen + 2), 0);
  b.ends.assign((size_t)(a1->algnlen + a2->algnlen + 2), 0);
  do_shapes(anchors, &b);
  find_necks(&b);
  ProfileDP dp(*a1, *a2, b, ctx.caches);
  *uni_out = dp.run();
  return unify_align(a1, a2, *uni_out);
}

// minimal Align wrapper over the move list so remap_hlls can query gaps
Align moves_as_align(const std::vector<uint8_t>& moves) {
  Align u;
  u.numseq = 2;
  u.algnlen = (int)moves.size();
  u.algn.assign(moves.size() + 1, 0);
  for (size_t i = 0; i < moves.size(); ++i) u.algn[i] = moves[i];
  return u;
}

Align* process_align(Context& ctx, Align* a1, Align* a2, int* index_out) {
  Align *first, *second;
  int index, hllindex;
  if (a1->index > a2->index) {
    first = a2;
    second = a1;
    index = a2->index;
    hllindex = a1->index;
  } else {
    first = a1;
    second = a2;
    index = a1->index;
    hllindex = a2->index;
  }
  *index_out = index;

  std::vector<uint8_t> uni;
  Align* result =
      make_align_pair(ctx, first, second, ctx.hlls[(size_t)index][(size_t)hllindex], &uni);
  result->index = index;

  // freeHLLs(aligns[first->index]->hlls[hllindex])
  for (Hll* t = ctx.hlls[(size_t)index][(size_t)hllindex]; t;) {
    Hll* nx = t->next;
    delete t;
    t = nx;
  }
  ctx.hlls[(size_t)index][(size_t)hllindex] = nullptr;

  Align uni_aln = moves_as_align(uni);

  // doRemapHLLs (mlagan.c:377-410)
  int n = ctx.nseq;
  for (int pass = 0; pass < 2; ++pass) {
    int mapi = pass == 0 ? index : hllindex;
    for (int i = 0; i < mapi; ++i) {
      if (ctx.hlls[(size_t)i][(size_t)mapi] != nullptr && i != index) {
        ctx.hlls[(size_t)i][(size_t)mapi] = remap_hlls(
            ctx.hlls[(size_t)i][(size_t)mapi], 1, uni_aln, (mapi != index));
      }
    }
    for (int i = mapi + 1; i < n; ++i) {
      if (ctx.hlls[(size_t)mapi][(size_t)i] != nullptr && i != hllindex) {
        ctx.hlls[(size_t)mapi][(size_t)i] = remap_hlls(
            ctx.hlls[(size_t)mapi][(size_t)i], 0, uni_aln, (mapi != index));
      }
    }
  }

  // doReanchorHLLs (mlagan.c:412-449)
  for (int i = 0; i < index; ++i) {
    ctx.hlls[(size_t)i][(size_t)index] = reanchor_hll(
        merge_hlls(ctx.hlls[(size_t)i][(size_t)index], 0,
                   ctx.hlls[(size_t)i][(size_t)hllindex], 0));
    ctx.hlls[(size_t)i][(size_t)hllindex] = nullptr;
  }
  for (int i = index + 1; i < hllindex; ++i) {
    ctx.hlls[(size_t)index][(size_t)i] = reanchor_hll(
        merge_hlls(ctx.hlls[(size_t)index][(size_t)i], 0,
                   ctx.hlls[(size_t)i][(size_t)hllindex], 1));
    ctx.hlls[(size_t)i][(size_t)hllindex] = nullptr;
  }
  for (int i = hllindex + 1; i < n; ++i) {
    ctx.hlls[(size_t)index][(size_t)i] = reanchor_hll(
        merge_hlls(ctx.hlls[(size_t)index][(size_t)i], 0,
                   ctx.hlls[(size_t)hllindex][(size_t)i], 0));
    ctx.hlls[(size_t)hllindex][(size_t)i] = nullptr;
  }

  if (first->numseq > 1) delete first;
  if (second->numseq > 1) delete second;
  return result;
}

Align* find_align_by_name(Context& ctx, const std::string& name) {
  for (int i = 0; i < ctx.nseq; ++i)
    if (ctx.simaligns[(size_t)i]->seqs[0]->name.find(name) != std::string::npos)
      return ctx.simaligns[(size_t)i];
  return nullptr;  // reference exits; unreachable for well-formed trees
}

// graphCollapsal + buildTree (mlagan.c:593-705)
std::string build_merge_tree(Context& ctx) {
  int n = ctx.nseq;
  std::vector<std::vector<float>> dist((size_t)n,
                                       std::vector<float>((size_t)n, -1));
  for (int i = 0; i < n - 1; ++i) {
    for (int j = i + 1; j < n; ++j) {
      float sum = 0, length = 0, count = 0;
      for (Hll* t = ctx.hlls[(size_t)i][(size_t)j]; t; t = t->next) {
        sum += t->score;
        length += (float)(t->s1e - t->s1s);
        count += 1;
      }
      dist[(size_t)i][(size_t)j] = (count != 0 && sum > 0) ? sum / length : 0;
    }
  }
  std::vector<std::string> names((size_t)n);
  for (int i = 0; i < n; ++i) {
    const std::string& full = ctx.simaligns[(size_t)i]->seqs[0]->name;
    size_t sp = full.find_first_of(" \t");
    names[(size_t)i] = (sp == std::string::npos) ? full : full.substr(0, sp);
  }
  std::string result;
  while (true) {
    float mx = -1;
    int mli = -1, mlj = -1;
    for (int i = 0; i < n - 1; ++i)
      for (int j = i + 1; j < n; ++j)
        if (dist[(size_t)i][(size_t)j] > mx) {
          mx = dist[(size_t)i][(size_t)j];
          mli = i;
          mlj = j;
        }
    if (mx < 0) break;
    std::string joined = "(" + names[(size_t)mli] + " " + names[(size_t)mlj] + ")";
    names[(size_t)mli] = result = joined;
    dist[(size_t)mli][(size_t)mlj] = -1;
    for (int i = 0; i < mli; ++i) {
      if (dist[(size_t)i][(size_t)mli] >= 0)
        dist[(size_t)i][(size_t)mli] =
            (dist[(size_t)i][(size_t)mli] + dist[(size_t)i][(size_t)mlj]) / 2;
      dist[(size_t)i][(size_t)mlj] = -1;
    }
    for (int i = mli + 1; i < mlj; ++i) {
      if (dist[(size_t)mli][(size_t)i] >= 0)
        dist[(size_t)mli][(size_t)i] =
            (dist[(size_t)mli][(size_t)i] + dist[(size_t)i][(size_t)mlj]) / 2;
      dist[(size_t)i][(size_t)mlj] = -1;
    }
    for (int i = mlj + 1; i < n; ++i) {
      if (dist[(size_t)mli][(size_t)i] >= 0)
        dist[(size_t)mli][(size_t)i] =
            (dist[(size_t)mli][(size_t)i] + dist[(size_t)mlj][(size_t)i]) / 2;
      dist[(size_t)mlj][(size_t)i] = -1;
    }
  }
  return result;
}

// treeToRPN (mlagan.c:526-565): rpn slots hold an align or null (operator)
int tree_to_rpn(Context& ctx, const char* treestr,
                std::vector<Align*>& stack, int* depth) {
  int i = 0;
  while (treestr[i] != '(') ++i;
  ++i;
  while (treestr[i] != ')' && treestr[i] != '\0') {
    if (treestr[i] == '(') {
      i += tree_to_rpn(ctx, treestr + i, stack, depth);
    } else if (isalnum((unsigned char)treestr[i])) {
      std::string buf;
      while (!isspace((unsigned char)treestr[i]) && treestr[i] != '(' &&
             treestr[i] != ')')
        buf.push_back(treestr[i++]);
      stack[(size_t)(*depth)++] = find_align_by_name(ctx, buf);
    } else if (treestr[i] == ')') {
      break;
    } else {
      ++i;
    }
  }
  if (treestr[i] == ')') {
    ++(*depth);  // null slot = operator
    return i + 1;
  }
  return i;
}

// ---------------------------------------------------------------------------
// prolagan: profile-profile progressive alignment (prolagan.c)
// ---------------------------------------------------------------------------

// readProfile + appendAlignProfile (prolagan.c:162-228): build an Align
// from gapped FASTA rows; the per-row seq pointers are the UNGAPPED member
// sequences (getSeqNumber replacement, prolagan.c:151-160).
Align* mk_profile_align(Context& ctx, int which) {
  const auto& rows = ctx.prof_rows[(size_t)which];
  const auto& members = ctx.prof_members[(size_t)which];
  Align* res = new Align;
  res->score = 0;
  res->numseq = 0;
  res->index = 32;
  // VER_MLAGAN read prepends 'N'; algnlen includes it (filebuffer.c:131-139)
  res->algnlen = (int)rows[0].size() + 1;
  res->algn.assign((size_t)res->algnlen + 1, 0);
  for (int j = 0; j < CNTS_LEN; ++j)
    res->cnts[j].assign((size_t)res->algnlen + 1, 0);
  for (size_t r = 0; r < rows.size(); ++r) {
    std::string lets = "N";
    for (char raw : rows[r]) {
      char c = (char)toupper((unsigned char)raw);
      // FileBuffer alphabet "ATCGN-." (filebuffer.c:10); others become N
      if (!strchr("ATCGN-.", c)) c = 'N';
      lets.push_back(c);
    }
    // appendAlignProfile (prolagan.c:162-185); columns 1..algnlen-1
    for (int i = 1; i < res->algnlen; ++i) {
      if (lets[(size_t)i] != '-') {
        int k = let_index(lets[(size_t)i]);
        if (k < 4) res->cnts[k][(size_t)i]++;
        res->algn[(size_t)i] |= (1ULL << r);
        if (lets[(size_t)i - 1] == '-') res->cnts[CNTS_GE][(size_t)i]++;
      } else if (lets[(size_t)i - 1] != '-') {
        res->cnts[CNTS_GS][(size_t)i]++;
      } else {
        res->cnts[CNTS_GC][(size_t)i]++;
      }
    }
    res->seqs.push_back(&ctx.seqs[(size_t)members[r]]);
    res->numseq++;
  }
  for (int m : members)
    if (res->index > m) res->index = m;  // prolagan.c:1003,1013
  return res;
}

// processAnchors (prolagan.c:537-562): merge the anchor graph as if the
// operands were being aligned — orderAligns + doReanchorHLLs only; no DP
// happens until the final profile-profile merge.
Align* process_anchors_pl(Context& ctx, Align* a1, Align* a2) {
  Align *first, *second;
  int index, hllindex;
  if (a1->index > a2->index) {
    first = a2; second = a1;
    index = a2->index; hllindex = a1->index;
  } else {
    first = a1; second = a2;
    index = a1->index; hllindex = a2->index;
  }
  (void)first; (void)second;
  int n = ctx.nseq;
  // doReanchorHLLs (prolagan.c:497-535)
  for (int i = 0; i < index; ++i) {
    ctx.hlls[(size_t)i][(size_t)index] = reanchor_hll(
        merge_hlls(ctx.hlls[(size_t)i][(size_t)index], 0,
                   ctx.hlls[(size_t)i][(size_t)hllindex], 0));
    ctx.hlls[(size_t)i][(size_t)hllindex] = nullptr;
  }
  for (int i = index + 1; i < hllindex; ++i) {
    ctx.hlls[(size_t)index][(size_t)i] = reanchor_hll(
        merge_hlls(ctx.hlls[(size_t)index][(size_t)i], 0,
                   ctx.hlls[(size_t)i][(size_t)hllindex], 1));
    ctx.hlls[(size_t)i][(size_t)hllindex] = nullptr;
  }
  for (int i = hllindex + 1; i < n; ++i) {
    ctx.hlls[(size_t)index][(size_t)i] = reanchor_hll(
        merge_hlls(ctx.hlls[(size_t)index][(size_t)i], 0,
                   ctx.hlls[(size_t)hllindex][(size_t)i], 0));
    ctx.hlls[(size_t)hllindex][(size_t)i] = nullptr;
  }
  Align* result = new Align;  // dummy carrier: only ->index is consumed
  result->score = -1;
  result->numseq = a1->numseq + a2->numseq;
  result->algnlen = -1;
  result->index = index;
  return result;
}

// prolagan's findAlignByName matches the FIRST WORD of the sequence name
// exactly (starts_with, prolagan.c:120-128), unlike mlagan's strstr.
Align* pl_find_align_by_name(Context& ctx, const std::string& name) {
  for (int i = 0; i < ctx.nseq; ++i) {
    const std::string& full = ctx.simaligns[(size_t)i]->seqs[0]->name;
    size_t sp = full.find_first_of(" \t");
    std::string first = (sp == std::string::npos) ? full : full.substr(0, sp);
    if (first == name) return ctx.simaligns[(size_t)i];
  }
  ctx.name_missing = true;  // reference exits(2); surfaced as null result
  return nullptr;
}

int pl_tree_to_rpn(Context& ctx, const char* treestr,
                   std::vector<Align*>& stack, int* depth) {
  int i = 0;
  while (treestr[i] != '(') ++i;
  ++i;
  while (treestr[i] != ')' && treestr[i] != '\0') {
    if (treestr[i] == '(') {
      i += pl_tree_to_rpn(ctx, treestr + i, stack, depth);
    } else if (isalnum((unsigned char)treestr[i])) {
      std::string buf;
      while (!isspace((unsigned char)treestr[i]) && treestr[i] != '(' &&
             treestr[i] != ')')
        buf.push_back(treestr[i++]);
      stack[(size_t)(*depth)++] = pl_find_align_by_name(ctx, buf);
    } else if (treestr[i] == ')') {
      break;
    } else {
      ++i;
    }
  }
  if (treestr[i] == ')') {
    ++(*depth);
    return i + 1;
  }
  return i;
}

std::string print_fasta_align(const Align& a) {
  std::string out;
  std::vector<int> inds((size_t)a.numseq, 1);
  for (int i = 0; i < a.numseq; ++i) {
    out += ">";
    out += a.seqs[(size_t)i]->name;
    out += "\n";
    for (int c = 1; c < a.algnlen; c += 60) {
      for (int k = c; k < c + 60 && k < a.algnlen; ++k) {
        if (a.algn[(size_t)k] & (1ULL << i))
          out.push_back(a.seqs[(size_t)i]->lets[(size_t)inds[(size_t)i]++]);
        else
          out.push_back('-');
      }
      out += "\n";
    }
  }
  out += "\n";
  return out;
}

}  // namespace lagan_ml

extern "C" {

void* ml_create(int nseq) {
  auto* ctx = new lagan_ml::Context;
  ctx->nseq = nseq;
  ctx->seqs.resize((size_t)nseq);
  ctx->hlls.assign((size_t)nseq,
                   std::vector<lagan_ml::Hll*>((size_t)nseq, nullptr));
  return ctx;
}

void ml_set_seq(void* h, int i, const char* raw, long n, const char* name) {
  auto* ctx = (lagan_ml::Context*)h;
  lagan::MappedSeq ms;
  lagan::map_sequence(raw, n, true, &ms);  // order-mode table = "ATCGN-."
  lagan_ml::Seq& s = ctx->seqs[(size_t)i];
  // VER_MLAGAN read: leading 'N', numlets includes it (filebuffer.c:131-139)
  s.lets = "N";
  s.lets.append(ms.lets + 1, (size_t)ms.numlets);
  s.numlets = (int)s.lets.size();
  s.name = name;
  s.index = i + 1;
}

// anchors in file order (descending); prepended as in getAnchsFromFile
void ml_add_anchor(void* h, int i, int j, int s1s, int s1e, int s2s, int s2e,
                   float score) {
  auto* ctx = (lagan_ml::Context*)h;
  auto* t = new lagan_ml::Hll;
  t->s1s = s1s;
  t->s1e = s1e;
  t->s2s = s2s;
  t->s2e = s2e;
  t->score = score;
  t->next = ctx->hlls[(size_t)i][(size_t)j];
  ctx->hlls[(size_t)i][(size_t)j] = t;
}

char* ml_run(void* h) {
  auto* ctx = (lagan_ml::Context*)h;
  int n = ctx->nseq;
  for (int i = 0; i < n; ++i) {
    lagan_ml::Align* a = lagan_ml::mk_sim_align(&ctx->seqs[(size_t)i]);
    a->index = i;
    ctx->simaligns.push_back(a);
  }
  std::string tree = lagan_ml::build_merge_tree(*ctx);
  std::vector<lagan_ml::Align*> rpn((size_t)(lagan_ml::MAX_SEQ * 2), nullptr);
  int depth = 0;
  lagan_ml::tree_to_rpn(*ctx, tree.c_str(), rpn, &depth);
  // procStack (mlagan.c:567-590)
  std::vector<lagan_ml::Align*> stack((size_t)lagan_ml::MAX_SEQ, nullptr);
  int sp = 0, index = 0;
  for (int i = 0; i < depth; ++i) {
    if (rpn[(size_t)i]) {
      stack[(size_t)sp++] = rpn[(size_t)i];
    } else {
      stack[(size_t)(sp - 2)] = lagan_ml::process_align(
          *ctx, stack[(size_t)(sp - 2)], stack[(size_t)(sp - 1)], &index);
      stack[(size_t)--sp] = nullptr;
    }
  }
  std::string out = lagan_ml::print_fasta_align(*stack[0]);
  char* res = (char*)std::malloc(out.size() + 1);
  std::memcpy(res, out.data(), out.size());
  res[out.size()] = 0;
  return res;
}

void ml_destroy(void* h) { delete (lagan_ml::Context*)h; }

// ---------------------------------------------------------------------------
// prolagan C surface: two gapped profiles + cross-profile anchors + tree
// (prolagan.c main, :951-1114)
// ---------------------------------------------------------------------------

// which: 0/1. rows: '\n'-joined gapped FASTA rows in profile row order.
// members[r]: file index of row r's sequence (getSeqNumber replacement).
void pl_set_profile(void* h, int which, const char* rows, const int* members,
                    int nrows) {
  auto* ctx = (lagan_ml::Context*)h;
  ctx->prof_rows[which].clear();
  ctx->prof_members[which].assign(members, members + nrows);
  const char* p = rows;
  for (int r = 0; r < nrows; ++r) {
    const char* e = strchr(p, '\n');
    if (!e) e = p + strlen(p);
    ctx->prof_rows[which].emplace_back(p, e);
    p = (*e == '\n') ? e + 1 : e;
  }
}

// Run the prolagan flow: remap cross-profile anchors into profile-column
// coordinates (prolagan.c:1030-1047), collapse the anchor graph along the
// tree (processAnchors), then one profile-profile DP (processAlign).
// pro_of[i] must give the profile (0/1) owning file sequence i.
char* pl_run(void* h, const char* treestr, const int* pro_of) {
  auto* ctx = (lagan_ml::Context*)h;
  int n = ctx->nseq;
  for (int i = 0; i < n; ++i) {
    lagan_ml::Align* a = lagan_ml::mk_sim_align(&ctx->seqs[(size_t)i]);
    a->index = i;
    ctx->simaligns.push_back(a);
  }
  lagan_ml::Align* p1 = lagan_ml::mk_profile_align(*ctx, 0);
  lagan_ml::Align* p2 = lagan_ml::mk_profile_align(*ctx, 1);
  // row number of file seq i within its profile (pro1ptr/pro2ptr)
  std::vector<int> rownum((size_t)n, -1);
  for (int w = 0; w < 2; ++w)
    for (size_t r = 0; r < ctx->prof_members[w].size(); ++r)
      rownum[(size_t)ctx->prof_members[w][(size_t)r]] = (int)r;
  // remap each cross-profile anchor list through both profiles' gap
  // structure. s1 axis belongs to the lower file index; reference's
  // else-branch indexing slip (prolagan.c:1045 uses the wrong loop
  // counter, UB when the profiles interleave) is corrected to the row of
  // the sequence actually being remapped.
  for (int i = 0; i < n - 1; ++i) {
    for (int j = i + 1; j < n; ++j) {
      lagan_ml::Hll*& l = ctx->hlls[(size_t)i][(size_t)j];
      if (!l || pro_of[i] == pro_of[j]) continue;
      l = lagan_ml::remap_hlls(l, 0, *(pro_of[i] ? p2 : p1), rownum[(size_t)i]);
      l = lagan_ml::remap_hlls(l, 1, *(pro_of[j] ? p2 : p1), rownum[(size_t)j]);
    }
  }
  // treeToRPN + procStack (prolagan.c:628-697): every interior node but
  // the last merges anchors; the last aligns the two profiles.
  std::vector<lagan_ml::Align*> rpn((size_t)(lagan_ml::MAX_SEQ * 2), nullptr);
  int depth = 0;
  lagan_ml::pl_tree_to_rpn(*ctx, treestr, rpn, &depth);
  if (ctx->name_missing || depth < 2) return nullptr;
  std::vector<lagan_ml::Align*> stack((size_t)lagan_ml::MAX_SEQ, nullptr);
  int sp = 0;
  for (int i = 0; i < depth - 1; ++i) {
    if (rpn[(size_t)i]) {
      stack[(size_t)sp++] = rpn[(size_t)i];
    } else {
      if (sp < 2) return nullptr;
      stack[(size_t)(sp - 2)] = lagan_ml::process_anchors_pl(
          *ctx, stack[(size_t)(sp - 2)], stack[(size_t)(sp - 1)]);
      stack[(size_t)--sp] = nullptr;
    }
  }
  if (rpn[(size_t)(depth - 1)] != nullptr) return nullptr;  // malformed tree
  lagan_ml::Align *first, *second;
  int index, hllindex;
  if (p1->index > p2->index) {
    first = p2; second = p1;
    index = p2->index; hllindex = p1->index;
  } else {
    first = p1; second = p2;
    index = p1->index; hllindex = p2->index;
  }
  std::vector<uint8_t> uni;
  lagan_ml::Align* final_aln = lagan_ml::make_align_pair(
      *ctx, first, second, ctx->hlls[(size_t)index][(size_t)hllindex], &uni);
  std::string out = lagan_ml::print_fasta_align(*final_aln);
  char* res = (char*)std::malloc(out.size() + 1);
  std::memcpy(res, out.data(), out.size());
  res[out.size()] = 0;
  return res;
}

}  // extern "C"
