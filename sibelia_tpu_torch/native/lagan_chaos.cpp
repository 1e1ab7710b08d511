// chaos stage of the native LAGAN-semantics engine.
//
// Re-implements the observable behavior of the reference seed finder
// (reference: src/lagan/src/fchaos.c, thrtrie.c, skiplist.c) over in-memory
// buffers, emitting byte-identical hit text.  Structural choices are our
// own, and each lives as long as its Region (one -s1/-s2 region pair):
//  * a flat threaded trie: trivially copyable nodes (backptr, height, and
//    the start and count of their leaf locations), the children in one int
//    array with a stride of the alphabet's class count (4 for DNA, 11 for
//    peptides), the leaf locations in one CSR array;
//  * flat hit records: a word-match record (LList of thrtrie.h) owns the
//    slots base .. base + n - 1 of region-wide arrays (score, chain node,
//    diagonal-list entry), one slot for each of its leaf's n locations;
//  * parent-linked chains: the chain node of a slot holds the word match's
//    two positions and the slot of its best predecessor (-1 where the chain
//    starts), so chaining copies nothing; the rescoring walks the links
//    back and reverses them.  A chain is fixed once made (the destructive
//    kill touches scores alone), so the walk gives the sequence that the
//    reference's copied index arrays hold;
//  * an ordered std::list for the diagonal index, walked linearly (it may
//    be locally unsorted, see below, so a sorted structure would differ).
// Every ordering and arithmetic decision that reaches the output is
// replicated:
//  * threaded-trie job queue processing order incl. swap-with-last removal
//    and generation (dirty) bookkeeping (thrtrie.c:244-324);
//  * a leaf's locations in ascending position (the order of the trie's
//    inserts), which is the order its slots are chained and flushed in;
//  * per-position emission lists are built by prepending, so records are
//    processed in reverse emission order (thrtrie.c:290-292, fchaos.c:552);
//  * chaining scores are single-precision with int truncation in chain()
//    (fchaos.c:400-428) and destructive invalidation of non-best
//    predecessors (fchaos.c:467-476);
//  * the diagonal skiplist's find returns the last entry strictly below the
//    key (skiplist.c:162-179) and the insert-position tracking of findPrev
//    (fchaos.c:444-462) is replicated verbatim, including the case where it
//    leaves the list locally unsorted;
//  * BLAST-style extension, chunk rescoring, overlap merging and the
//    two-pass dedup with its bespoke merge sort (fchaos.c:238-333,
//    1003-1254) are ported operation-for-operation.
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <climits>
#include <cstdint>
#include <array>
#include <atomic>
#include <string>
#include <vector>
#include <list>
#include <algorithm>

#include "lagan_common.h"
#include "lagan_stages.h"

namespace lagan {
namespace {

const int kLookback = 20;  // fchaos.c:41
const int kMGapLen = 5;    // fchaos.c:43
const int kGapPenC = -1;   // fchaos.c:44
const int kGapPenO = 0;    // fchaos.c:45
const int kDropCutoff = 1500;  // fchaos.c:61

// process-wide sums over every region run (chaos_stats)
std::atomic<long long> g_words{0};  // word matches chained (slots)
std::atomic<long long> g_links{0};  // chain links walked by rescore_hit

inline int code(char c) {
  switch (c) {  // triealpha "ATCG" (fchaos.c:71) => A=0 T=1 C=2 G=3
    case 'A': return 0;
    case 'T': return 1;
    case 'C': return 2;
    case 'G': return 3;
    default: return -1;
  }
}

struct TrieNode {
  int backptr;
  int height;
  int lstart;  // the leaf's locations: locs_[lstart .. lstart + lcount)
  int lcount;
};

struct DiagEntry {
  int index;
  int ll;
  int offset;
};
typedef std::list<DiagEntry> DiagList;
typedef DiagList::iterator DiagIt;

// One emitted word-match record (LList of thrtrie.h): its slots in the
// region's hit arrays are base + offset, one for each location of leaf.
struct LL {
  int leaf;
  int degleft;
  int location;
  int64_t base;
};

// The chain node of a slot: the word match's positions in seq1 and seq2
// and the slot of its best predecessor (-1: the chain starts here).
struct ChainNode {
  int l1;
  int l2;
  int64_t parent;
};

struct HitNode {
  Hit h;
  HitNode* next;
};

struct Params {
  int wl, nd, co, rsc;
  bool gfc, ext;
  // mode parameters (defaults = the nucleotide CLI defaults,
  // fchaos.c:38-62; -p/-t override them, fchaos.c:636-660)
  int lookback = kLookback;
  int mgaplen = kMGapLen;
  int gap_start = kChaosGapStart;
  int gap_ext = kChaosGapExt;
  const signed char* cls = nullptr;  // char -> trie class; null = ATCG
  int n_cls = 4;
  bool prot = false;                 // blosum62s scoring
};

// A region's two sequences and their substitution table (nucmatrix, or
// blosum62s in the translated mode), with the scoring loops that the
// rescoring and the merger share.  The table is read through a pointer
// taken at construction.
class Scorer {
 public:
  Scorer(const char* q, int qn, const char* d, int dn, bool prot)
      : q_(q), qn_(qn), d_(d), dn_(dn), sm_(prot ? blosum().m : subst().m) {}

  int extend_blast(int s1i, int s2i, int dir) const {
    // fchaos.c:1003-1018
    int peak = 0, peakloc = 0, currscore = 0, i = 1;
    while (peak - currscore < kDropCutoff) {
      int a = s1i + dir * i, b = s2i + dir * i;
      if (a < 0 || b < 0 || !q_[a] || !d_[b] || a >= qn_ || b >= dn_) break;
      currscore += at(a, b);
      if (currscore > peak) {
        peak = currscore;
        peakloc = i;
      }
      ++i;
    }
    return peakloc;
  }

  int extend_merge(int s1l, int s2l, int s1r, int s2r, int* dir) {
    // fchaos.c:1020-1052 incl. the negative-coordinate shift clamps.
    if (s1l < 0) { int err = -s1l; s1l += err; s2l += err; }
    if (s2l < 0) { int err = -s2l; s1l += err; s2l += err; }
    int length = std::min(s1r - s1l, s2r - s2l);
    *dir = (s1r - s1l == length) ? 0 : (s2r - s2l == length) ? 1 : -1;
    if (length <= 0) return 0;
    fwd_.resize((size_t)length + 1);
    bwd_.resize((size_t)length + 1);
    int* fwd = fwd_.data();
    int* bwd = bwd_.data();
    fwd[0] = bwd[length] = 0;
    for (int i = 1; i <= length; ++i) {
      fwd[i] = fwd[i - 1] + at(s1l + i, s2l + i);
      bwd[length - i] = bwd[length - i + 1] + at(s1r - i, s2r - i);
    }
    int bestscore = -9999999, bestloc = 0;
    for (int i = 0; i < length; ++i) {
      if (fwd[i] + bwd[i + 1] > bestscore) {
        bestscore = fwd[i] + bwd[i + 1];
        bestloc = i;
      }
    }
    return bestloc;
  }

  int rescore(int s1l, int s2l, int len) const {
    // fchaos.c:1054-1066
    if (s1l < 0) { int err = -s1l; s1l += err; s2l += err; len -= err; }
    if (s2l < 0) { int err = -s2l; s1l += err; s2l += err; len -= err; }
    int tot = 0;
    for (int i = 0; i < len; ++i) tot += at(s1l + i, s2l + i);
    return tot;
  }

 private:
  int at(int a, int b) const {
    return sm_[(unsigned char)q_[a]][(unsigned char)d_[b]];
  }
  const char* q_;
  int qn_;
  const char* d_;
  int dn_;
  const int (*sm_)[256];
  std::vector<int> fwd_, bwd_;
};

class Region {
 public:
  Region(const char* q, int qn, const char* d, int dn, int numsiglets,
         const Params& p)
      : q_(q), qn_(qn), d_(d), dn_(dn), numsiglets_(numsiglets), p_(p),
        sc_(q, qn, d, dn, p.prot) {
    dlist_.push_back(DiagEntry{INT_MIN, -1, -1});  // sentinel
  }

  HitNode* run();

 private:
  int make_node(int h) {
    nodes_.push_back(TrieNode{0, h, 0, 0});
    kids_.resize(kids_.size() + (size_t)p_.n_cls, -1);
    return (int)nodes_.size() - 1;
  }
  int& kid(int node, int c) { return kids_[(size_t)node * p_.n_cls + c]; }
  int loc(int leaf, int offset) const {
    return locs_[(size_t)nodes_[leaf].lstart + offset];
  }
  int insert_word(int pos);
  void insert_string();
  void get_next_words(int wordpos, std::vector<LL>* out);
  int chain_score(const LL& cur, int off2, const LL& prev, int off1,
                  int diff1, int gap, float baseval) const;
  void find_prev(const LL& cur, int offset, float baseval);
  void rescore_hit(int64_t slot, Hit* hit);
  void flush(int pos, HitNode** allhits);

  DiagIt find_lt(int key) {  // last entry with index < key (>= sentinel)
    DiagIt last = dlist_.begin();
    for (DiagIt it = std::next(dlist_.begin()); it != dlist_.end(); ++it) {
      if (it->index >= key) break;
      last = it;
    }
    return last;
  }

  int cls(char c) const {
    return p_.cls ? (int)p_.cls[(unsigned char)c] : code(c);
  }

  const char* q_;
  int qn_;
  const char* d_;
  int dn_;
  int numsiglets_;
  Params p_;
  Scorer sc_;
  // the trie
  std::vector<TrieNode> nodes_;
  std::vector<int> kids_;  // node * n_cls + class -> child, -1 for none
  std::vector<int> locs_;
  // the records, each position's as a range, and their slots
  std::vector<LL> lls_;
  std::vector<std::pair<size_t, size_t>> per_pos_;
  std::vector<float> scores_;
  std::vector<ChainNode> chains_;
  std::vector<DiagIt> sles_;
  DiagList dlist_;
  std::vector<int> inds1_, inds2_;  // rescore_hit's chain, reused
  long long links_ = 0;

  struct Job {
    int node;
    int numdeg;
    int degloc[2];
    char dirty;
  };
  std::vector<Job> jobs_;
};

int Region::insert_word(int pos) {  // thrtrie.c:106-124; the leaf or -1
  int node = 0;
  for (int dpt = 0; dpt < p_.wl; ++dpt) {
    int c = cls(q_[pos + dpt]);
    if (c < 0) return -1;
    if (kid(node, c) < 0) {
      int nn = make_node(p_.wl - dpt - 1);
      kid(node, c) = nn;
    }
    node = kid(node, c);
  }
  return node;
}

void Region::insert_string() {  // thrtrie.c:172-198
  make_node(p_.wl);  // root
  std::vector<int> leaf_at((size_t)std::max(qn_, 1), -1);
  leaf_at[0] = insert_word(0);
  nodes_[0].backptr = 0;
  for (int p = 1; p < qn_; ++p) {
    int curr = 0, prev = 0;
    leaf_at[(size_t)p] = insert_word(p);
    for (int i = 0; i < p_.wl; ++i) {
      int letprev = cls(q_[p + i - 1]);
      int letcurr = cls(q_[p + i]);
      if (letprev < 0) break;
      prev = kid(prev, letprev);
      if (prev < 0) break;  // defensive; paths exist for valid input
      nodes_[prev].backptr = curr;
      if (letcurr < 0) break;
      curr = kid(curr, letcurr);
      if (curr < 0) break;
    }
  }
  int letcurr = cls(q_[qn_ - 1]);  // thrtrie.c:195-197
  if (letcurr >= 0 && kid(0, letcurr) >= 0)
    nodes_[kid(0, letcurr)].backptr = 0;
  // the leaves' locations, each leaf's in ascending position (the order
  // of the reference's appends)
  for (int leaf : leaf_at)
    if (leaf >= 0) ++nodes_[leaf].lcount;
  int total = 0;
  for (TrieNode& n : nodes_) {
    n.lstart = total;
    total += n.lcount;
    n.lcount = 0;
  }
  locs_.resize((size_t)total);
  for (size_t p = 0; p < leaf_at.size(); ++p) {
    int leaf = leaf_at[p];
    if (leaf >= 0)
      locs_[(size_t)(nodes_[leaf].lstart + nodes_[leaf].lcount++)] = (int)p;
  }
}

void Region::get_next_words(int wordpos, std::vector<LL>* out) {
  // thrtrie.c:244-324.  `out` holds records in emission order; the caller
  // stores them reversed to match the reference's prepend-built list.
  int letter = cls(d_[wordpos]);
  if (letter >= 0 && jobs_.empty())
    jobs_.push_back(Job{0, 0, {0, 0}, 0});
  if (jobs_.empty()) return;
  char mydirty = jobs_[0].dirty;
  size_t mynjobs = jobs_.size();

  // remjob (thrtrie.c:226-228): swap-with-last; returns the dirty flag the
  // reference would read at slot i afterwards (the swapped-in job's, which
  // for a self-swap is the removed job's own copy).
  auto remjob = [&](size_t i) -> char {
    char d = jobs_.back().dirty;
    jobs_[i] = jobs_.back();
    jobs_.pop_back();
    return d;
  };
  auto addjob = [&](int node, int thisdeg, char dirty, int oldindex) {
    Job j;
    j.node = node;
    j.dirty = dirty;
    j.degloc[0] = j.degloc[1] = 0;
    if (oldindex >= 0) {
      j.numdeg = jobs_[oldindex].numdeg;
      for (int k = 0; k < j.numdeg; ++k)
        j.degloc[k] = jobs_[oldindex].degloc[k];
    } else {
      j.numdeg = 0;
    }
    if (thisdeg >= 0) j.degloc[j.numdeg++] = thisdeg;
    jobs_.push_back(j);
  };
  auto emit = [&](const Job& j) {
    out->push_back(LL{j.node, j.numdeg, 0, 0});
  };

  for (size_t i = 0; i < mynjobs; ++i) {
    // the reference stores myflags in a CHAR (thrtrie.c:250,264:
    // `myflags = -1 - (1 << triealphasize) + 1`): for alphabets wider
    // than 8 classes (protein: 11) the init and the per-class bits
    // truncate, and the promoted sign-extended value makes high classes
    // alias bit 7 — so class dedup partially fails and words are
    // re-emitted.  That inflates numhits (deflating baseval) and is
    // byte-visible in every translated/protein output; replicated
    // exactly via int8_t.  For the 4-class DNA alphabet the semantics
    // are identical to a full-width int.
    int8_t myflags = (int8_t)(-1 - (1 << p_.n_cls) + 1);
    char first = 0;
    if (jobs_[i].numdeg > 0 &&
        jobs_[i].degloc[0] <
            wordpos - (p_.wl - nodes_[jobs_[i].node].height)) {
      if (remjob(i) == mydirty) {
        --mynjobs;
        --i;
      }
      continue;
    }
    do {
      // the reference's NULL-node branch (thrtrie.c:272-279) is unreachable
      // for valid inputs (backptr threading always completes); omitted.
      if (nodes_[jobs_[i].node].height == 0 || first)
        jobs_[i].node = nodes_[jobs_[i].node].backptr;
      first = 1;
      if (p_.nd - jobs_[i].numdeg > 0) {
        for (int j = 0; j < p_.n_cls; ++j) {
          int child = kid(jobs_[i].node, j);
          if (!(myflags & (1 << j)) && child >= 0) {
            addjob(child, (j == letter) ? -1 : wordpos, !mydirty, (int)i);
            if (nodes_[jobs_[i].node].height == 1) emit(jobs_.back());
            myflags = (int8_t)(myflags | (1 << j));
          }
        }
      } else {
        int child = (letter >= 0) ? kid(jobs_[i].node, letter) : -1;
        if (letter >= 0 && child >= 0) {
          jobs_[i].node = child;
          jobs_[i].dirty = !mydirty;
          if (nodes_[jobs_[i].node].height == 0) emit(jobs_[i]);
          myflags = (int8_t)-1;
        }
      }
      if (myflags == -1) break;
    } while (jobs_[i].node != nodes_[jobs_[i].node].backptr);
    if (jobs_[i].dirty == mydirty) {
      if (remjob(i) == mydirty) {
        --mynjobs;
        --i;
      }
    }
  }
}

int Region::chain_score(const LL& cur, int off2, const LL& prev, int off1,
                        int diff1, int gap, float baseval) const {
  // fchaos.c:400-428: float accumulation with int truncation.
  int diff2 = loc(cur.leaf, off2) - loc(prev.leaf, off1);
  int score = p_.wl - cur.degleft;
  gap = std::abs(gap) * kGapPenC + kGapPenO;
  if (diff2 <= 0 || diff2 >= p_.lookback) return -1;
  if (diff1 >= p_.wl && diff2 >= p_.wl)
    return (int)((float)score * baseval + (float)gap);
  int mindiff = diff1 > diff2 ? diff2 : diff1;
  return (int)((float)mindiff * baseval + (float)gap);
}

void Region::find_prev(const LL& cur, int offset, float baseval) {
  // fchaos.c:433-513 with the skiplist replaced by the ordered list; the
  // mysles tracking follows the reference's three update sites exactly.
  const int64_t slot = cur.base + offset;
  const int position = cur.location;
  int myloc = loc(cur.leaf, offset);
  int diag = position - myloc;
  float bestscore = 0;
  int64_t best = -1;
  int myscore = p_.wl - cur.degleft;

  DiagIt found = find_lt(diag - p_.mgaplen + 1);
  sles_[(size_t)slot] = found;  // (1) — always set; may be the sentinel
  DiagIt it = found;
  if (it->index <= diag - p_.mgaplen) ++it;  // always true for found < key
  if (it != dlist_.end() && it->index < diag) sles_[(size_t)slot] = it;  // (2)
  while (it != dlist_.end() && it->index < diag + p_.mgaplen) {
    DiagIt nxt = std::next(it);
    if (nxt != dlist_.end() && it->index < diag && nxt->index >= diag)
      sles_[(size_t)slot] = it;  // (3)
    const LL& temp = lls_[(size_t)it->ll];
    int k = it->offset;
    int j = position - temp.location;
    int tempscore =
        chain_score(cur, offset, temp, k, j, it->index - diag, baseval);
    if (tempscore > 0) {
      float& tscore = scores_[(size_t)(temp.base + k)];
      if (tscore + (float)tempscore > bestscore) {
        bestscore = tscore + (float)tempscore;
        best = temp.base + k;
      } else {
        tscore = -1;  // destructive kill (fchaos.c:474)
      }
    }
    it = nxt;
  }
  scores_[(size_t)slot] = best >= 0 ? bestscore : (float)myscore;
  chains_[(size_t)slot] = ChainNode{myloc, position, best};
}

void Region::rescore_hit(int64_t slot, Hit* hit) {
  // fchaos.c:1069-1133; rebuilds chunks and total score from the chain,
  // whose links are walked back from the slot and reversed.
  inds1_.clear();
  inds2_.clear();
  for (int64_t c = slot; c >= 0; c = chains_[(size_t)c].parent) {
    inds1_.push_back(chains_[(size_t)c].l1);
    inds2_.push_back(chains_[(size_t)c].l2);
  }
  std::reverse(inds1_.begin(), inds1_.end());
  std::reverse(inds2_.begin(), inds2_.end());
  const std::vector<int>& inds1 = inds1_;
  const std::vector<int>& inds2 = inds2_;
  int numind = (int)inds1.size();
  links_ += numind;
  int temp = 0;
  if (p_.ext) temp = sc_.extend_blast(inds1[0], inds2[0], -1);
  int ts1 = inds1[0] - temp;
  int ts2 = inds2[0] - temp;
  hit->s1s = ts1;
  hit->s2s = ts2;
  std::vector<Chunk>& chunks = hit->chunks;
  chunks.push_back(Chunk{0, 0, 0});
  int totscore = 0;
  int i = 0;
  for (i = 0; i < numind - 1; ++i) {
    int offset = (inds1[i] - inds2[i]) - (inds1[i + 1] - inds2[i + 1]);
    if (!offset) continue;
    int dir;
    int t = sc_.extend_merge(inds1[i] + p_.wl - 1, inds2[i] + p_.wl - 1,
                             inds1[i + 1], inds2[i + 1], &dir);
    int te1 = inds1[i] + p_.wl - 1 + t;
    int te2 = inds2[i] + p_.wl - 1 + t;
    int myscore = sc_.rescore(ts1, ts2, te1 - ts1 + 1);
    totscore += myscore;
    totscore += p_.gap_start + p_.gap_ext * std::abs(offset);
    chunks.back().length = te1 - ts1 + 1;
    chunks.back().score = myscore;
    chunks.push_back(Chunk{offset, 0, 0});
    if (dir) {
      ts1 = te1 + std::abs(offset) + 1;
      ts2 = te2 + 1;
    } else {
      ts2 = te2 + std::abs(offset) + 1;
      ts1 = te1 + 1;
    }
  }
  temp = 0;
  if (p_.ext)
    temp = sc_.extend_blast(inds1[i] + p_.wl - 1, inds2[i] + p_.wl - 1, 1);
  int myscore = sc_.rescore(ts1, ts2, inds1[i] + p_.wl - ts1 + temp);
  chunks.back().length = inds1[i] + p_.wl - ts1 + temp;
  chunks.back().score = myscore;
  totscore += myscore;
  hit->score = (float)totscore;
  hit->s1e = inds1[i] + p_.wl - 1 + temp;
  hit->s2e = inds2[i] + p_.wl - 1 + temp;
}

void Region::flush(int pos, HitNode** allhits) {
  // savenfreeLList (fchaos.c:1136-1173): record order as stored (already the
  // reference's processing order), offsets ascending; saveScore prepends.
  auto range = per_pos_[(size_t)pos];
  for (size_t r = range.first; r < range.second; ++r) {
    const LL& ll = lls_[r];
    int n = nodes_[ll.leaf].lcount;
    for (int i = 0; i < n; ++i) {
      if (scores_[(size_t)(ll.base + i)] > (float)p_.co) {
        HitNode* hn = new HitNode;
        rescore_hit(ll.base + i, &hn->h);
        if (hn->h.score > (float)p_.rsc) {
          hn->next = *allhits;
          *allhits = hn;
        } else {
          delete hn;
        }
      }
    }
    for (int i = 0; i < n; ++i) dlist_.erase(sles_[(size_t)(ll.base + i)]);
  }
}

HitNode* Region::run() {
  HitNode* allhits = nullptr;
  insert_string();
  per_pos_.assign((size_t)dn_, {0, 0});
  std::vector<LL> emitted;
  for (int i = 0; i < dn_; ++i) {
    emitted.clear();
    get_next_words(i, &emitted);
    int numhits = 1;
    for (const LL& ll : emitted) numhits += nodes_[ll.leaf].lcount;
    float baseval = (float)std::log((double)numsiglets_ / (double)numhits) /
                    (float)p_.wl;
    size_t start_idx = lls_.size();
    size_t slots = scores_.size();
    for (auto rit = emitted.rbegin(); rit != emitted.rend(); ++rit) {
      LL ll = *rit;
      ll.location = i - p_.wl + 1;
      ll.base = (int64_t)slots;
      slots += (size_t)nodes_[ll.leaf].lcount;
      lls_.push_back(ll);
    }
    scores_.resize(slots);
    chains_.resize(slots);
    sles_.resize(slots);
    per_pos_[(size_t)i] = {start_idx, lls_.size()};
    for (size_t r = start_idx; r < lls_.size(); ++r) {
      const LL& t = lls_[r];
      int n = nodes_[t.leaf].lcount;
      for (int j = 0; j < n; ++j) find_prev(t, j, baseval);
      for (int j = 0; j < n; ++j) {
        size_t slot = (size_t)(t.base + j);
        int key = t.location - loc(t.leaf, j);
        sles_[slot] = dlist_.insert(std::next(sles_[slot]),
                                    DiagEntry{key, (int)r, j});
      }
    }
    if (i - p_.lookback >= 0) flush(i - p_.lookback, &allhits);
  }
  for (int j = (dn_ - p_.lookback >= 0) ? dn_ - p_.lookback : 0; j < dn_; ++j)
    flush(j, &allhits);
  g_words += (long long)scores_.size();
  g_links += links_;
  return allhits;
}

// --- dedup & merge (fchaos.c:238-333, 1175-1254) --------------------------

bool duplicates(const HitNode* f, const HitNode* s) {
  return s->h.s2s >= f->h.s2s && s->h.s2e <= f->h.s2e;
}

class Merger {
 public:
  Merger(const char* q, int qn, const char* d, int dn, const Params& p)
      : sc_(q, qn, d, dn, p.prot), p_(p) {}

  bool merge_overlap(Hit& h1, Hit& h2) {
    // fchaos.c:1175-1254; newscore is an int in the reference, so the float
    // combination is truncated before the comparisons.
    if (h1.s2e < h2.s2s && h1.s1e < h2.s1s) return 0;
    int offset = (h1.s1e - h1.s2e) - (h2.s1s - h2.s2s);
    if (std::abs(offset) > p_.mgaplen) return 0;
    int gappen = p_.gap_start + p_.gap_ext * std::abs(offset);
    if ((float)(-gappen) > h1.score || (float)(-gappen) > h2.score) return 0;
    int s1l = h1.s1e - h1.chunks.back().length;
    int s2l = h1.s2e - h1.chunks.back().length;
    int s1r = h2.s1s + h2.chunks.front().length;
    int s2r = h2.s2s + h2.chunks.front().length;
    if (s1r <= s1l || s2r <= s2l) return 0;
    if (offset) {
      int dir;
      int bestloc = sc_.extend_merge(s1l, s2l, s1r, s2r, &dir);
      int myscore = sc_.rescore(s1l, s2l, bestloc);
      int s1n, s2n;
      if (dir) {
        s1n = s1l + bestloc + std::abs(offset) + 1;
        s2n = s2l + bestloc + 1;
      } else {
        s2n = s2l + bestloc + std::abs(offset) + 1;
        s1n = s1l + bestloc + 1;
      }
      int nextscore = sc_.rescore(s1n, s2n, s2r - s2n);
      int newscore =
          (int)(h1.score + h2.score -
                (float)(h2.chunks.front().score - nextscore) -
                (float)(h1.chunks.back().score - myscore) + (float)gappen);
      if ((float)newscore < h1.score || (float)newscore < h2.score) return 0;
      h1.score = (float)newscore;
      h1.chunks.back().length = bestloc;
      h2.chunks.front().score = nextscore;
      h2.chunks.front().offset = offset;
      h2.chunks.front().length = s2r - s2n;
      h1.chunks.back().score = myscore;
      h1.chunks.insert(h1.chunks.end(), h2.chunks.begin(), h2.chunks.end());
    } else {
      int myscore = sc_.rescore(s1l, s2l, s1r - s1l);
      int newscore = (int)(h1.score + h2.score -
                           (float)(h1.chunks.back().score - myscore) +
                           (float)gappen);
      if ((float)newscore < h1.score || (float)newscore < h2.score) return 0;
      h1.score = (float)newscore;
      h1.chunks.back().score = myscore;
      h1.chunks.back().length = s1r - s1l;
      h1.chunks.insert(h1.chunks.end(), h2.chunks.begin() + 1,
                       h2.chunks.end());
    }
    h1.s2e = h2.s2e;
    h1.s1e = h2.s1e;
    return 1;
  }

 private:
  Scorer sc_;
  Params p_;
};

bool hit_less(const HitNode* a, const HitNode* b) {  // fchaos.c:238-241
  return a->h.s1s < b->h.s1s ||
         (a->h.s1s == b->h.s1s && a->h.s1e > b->h.s1e);
}

HitNode* merge2(HitNode* l1, HitNode* l2) {  // fchaos.c:243-271
  if (!l1) return l2;
  if (!l2) return l1;
  HitNode* total = nullptr;
  HitNode* tail = nullptr;
  while (l1 || l2) {
    HitNode** pick = (l1 && (!l2 || hit_less(l1, l2))) ? &l1 : &l2;
    HitNode* n = *pick;
    *pick = n->next;
    if (!total)
      total = tail = n;
    else {
      tail->next = n;
      tail = n;
    }
  }
  tail->next = nullptr;
  return total;
}

HitNode* sort_list(HitNode* head) {  // fchaos.c:273-295 merge sort
  if (!head || !head->next) return head;
  HitNode* premid = head;
  HitNode* other = head->next;
  while (other && other->next) {
    other = other->next->next;
    premid = premid->next;
  }
  HitNode* mid = premid->next;
  premid->next = nullptr;
  head = sort_list(head);
  mid = sort_list(mid);
  return merge2(head, mid);
}

HitNode* remove_dups(HitNode* allhits, Merger& m) {  // fchaos.c:301-333
  for (HitNode* i = allhits; i; i = i->next) {
    HitNode* jprev = i;
    for (HitNode* j = i->next; j && j->h.s2s >= i->h.s2e;) {
      if (duplicates(i, j) || m.merge_overlap(i->h, j->h)) {
        jprev->next = j->next;
        delete j;
        j = jprev->next;
      } else {
        jprev = j;
        j = j->next;
      }
    }
  }
  allhits = sort_list(allhits);
  for (HitNode* i = allhits; i; i = i->next) {
    HitNode* jprev = i;
    for (HitNode* j = i->next; j && j->h.s1s <= i->h.s1e;) {
      if (duplicates(i, j) || m.merge_overlap(i->h, j->h)) {
        jprev->next = j->next;
        delete j;
        j = jprev->next;
      } else {
        jprev = j;
        j = j->next;
      }
    }
  }
  return allhits;
}

void print_hits(HitNode* res, const char* name1, const char* name2,
                int s1start, int s2start, bool gfc, std::string* out,
                char direction = '+', int minus_len = 0) {
  // printHLL (fchaos.c:120-228); direction '-' mirrors seq2 through
  // minus_len (the dbase length the reference passes), fchaos.c:176-228.
  char buf[1024];
  for (HitNode* t = res; t;) {
    Hit& h = t->h;
    if (s1start > 0) {
      h.s1s += s1start - 1;
      h.s1e += s1start - 1;
    }
    if (direction == '+' && s2start > 0) {
      h.s2s += s2start - 1;
      h.s2e += s2start - 1;
    }
    if (direction == '+') {
      std::snprintf(buf, sizeof(buf),
                    "%s %d %d; %s %d %d; score = %f (+)\n",
                    name1, h.s1s + 1, h.s1e + 1, name2, h.s2s + 1,
                    h.s2e + 1, (double)h.score);
    } else {
      std::snprintf(buf, sizeof(buf),
                    "%s %d %d; %s %d %d; score = %f (-)\n",
                    name1, h.s1s + 1, h.s1e + 1, name2, minus_len - h.s2s,
                    minus_len - h.s2e, (double)h.score);
    }
    out->append(buf);
    if (gfc) {
      int currx = h.s1s + 1;
      int curry = direction == '+' ? h.s2s + 1 : minus_len - h.s2s;
      for (size_t c = 0; c < h.chunks.size(); ++c) {
        const Chunk& ch = h.chunks[c];
        if (ch.length) {
          if (direction == '+')
            std::snprintf(buf, sizeof(buf), "%d %d %d %d\n", currx, curry,
                          ch.length, ch.score);
          else
            std::snprintf(buf, sizeof(buf), "%d %d %d %d \n", currx, curry,
                          ch.length, ch.score);
          out->append(buf);
          currx += ch.length;
          curry += direction == '+' ? ch.length : -ch.length;
        }
        if (c + 1 >= h.chunks.size()) break;
        const Chunk& nx = h.chunks[c + 1];
        if (direction == '+') {
          if (nx.offset > 0)
            curry += nx.offset;
          else
            currx -= nx.offset;
        } else {
          if (nx.offset < 0)
            currx -= nx.offset;
          else
            curry -= nx.offset;
        }
      }
    }
    HitNode* dead = t;
    t = t->next;
    delete dead;
  }
}

}  // namespace


// --- translated (6-frame peptide) mode ------------------------------------

namespace {

char to_peptide(const char* w, bool revcomp) {  // translate.c:8-27
  static const char* table =
      "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSS*CWCLFLF";
  int mask = revcomp ? 3 : 0;
  int sum = 0;
  for (int i = 0; i < 3; ++i) {
    sum *= 4;
    char c = w[(i ^ mask) - (revcomp ? 1 : 0)];
    switch (c) {
      case 'a': case 'A': sum += (0 ^ mask); break;
      case 'c': case 'C': sum += (1 ^ mask); break;
      case 'g': case 'G': sum += (2 ^ mask); break;
      case 't': case 'T': sum += (3 ^ mask); break;
      default: return 'X';  // 'N'/'n' (translate.c:20); inputs sanitized
    }
  }
  return table[sum];
}

struct TransSeq {
  std::string pep;
  std::string name;  // "<name>_f[+-]<frame%3>" (translate.c:64-65)
  int numsiglets;
};

TransSeq trans_seq(const char* lets, int n, const char* name, int frame) {
  // translate.c:30-67
  TransSeq out;
  bool revcomp = frame > 2;
  int fr = frame % 3;
  int m = (n - fr) / 3;
  if (m < 0) m = 0;
  out.pep.resize((size_t)m);
  int numx = 0;
  for (int i = 0; i < m; ++i) {
    char c = revcomp ? to_peptide(lets + (n - 3 * (i + 1) - fr), true)
                     : to_peptide(lets + ((int64_t)i * 3 + fr), false);
    out.pep[(size_t)i] = c;
    if (c == 'X') ++numx;
  }
  out.numsiglets = m - numx;
  char buf[32];
  std::snprintf(buf, sizeof(buf), "_f%c%d", revcomp ? '-' : '+', fr);
  out.name = std::string(name) + buf;
  return out;
}

void transloc_hits(HitNode* h, int fr1, int fr2, int len1, int len2) {
  // fchaos.c:778-802 (transloc): peptide -> DNA coordinates
  for (; h; h = h->next) {
    Hit& x = h->h;
    if (fr1 <= 2) {
      x.s1s = x.s1s * 3 + fr1;
      x.s1e = x.s1e * 3 + fr1;
    } else {
      int t = (len1 - x.s1s) * 3 + fr1 % 3;
      x.s1s = (len1 - x.s1e) * 3 + fr1 % 3;
      x.s1e = t;
    }
    if (fr2 <= 2) {
      x.s2s = x.s2s * 3 + fr2;
      x.s2e = x.s2e * 3 + fr2;
    } else {
      int t = (len2 - x.s2s) * 3 + fr2 % 3;
      x.s2s = (len2 - x.s2e) * 3 + fr2 % 3;
      x.s2e = t;
    }
  }
}

}  // namespace

void chaos_translated(const char* dna1, long n1, const char* name1,
                      const char* dna2, long n2, const char* name2,
                      bool both, int wl, int nd, int co, int rsc, bool gfc,
                      bool ext, std::string* out) {
  // doTranslated (fchaos.c:804-875).  -t sets wordlen 4, mgaplen 3,
  // lookback 8 and blosum62s scoring with -100/-100 gap penalties
  // (fchaos.c:652-660 + readSubstMatrix on a matrix file without
  // trailing gap entries).
  Params p{wl, nd, co, rsc, gfc, ext};
  p.lookback = 8;
  p.mgaplen = 3;
  p.gap_start = kChaosProtGapStart;
  p.gap_ext = kChaosProtGapExt;
  p.cls = prot_classes().cls;
  p.n_cls = prot_classes().n;
  p.prot = true;

  TransSeq qf[6], df[6];
  for (int i = 0; i < 6; ++i) {
    qf[i] = trans_seq(dna1, (int)n1, name1, i);
    df[i] = trans_seq(dna2, (int)n2, name2, i);
  }
  auto run_pair = [&](int i, int j, char dir) {
    const TransSeq& a = qf[i];
    const TransSeq& b = df[j];
    int qn = (int)a.pep.size(), dn = (int)b.pep.size();
    std::string qbuf(16, '\0'), dbuf(16, '\0');
    qbuf.append(a.pep);
    qbuf.append(16, '\0');
    dbuf.append(b.pep);
    dbuf.append(16, '\0');
    Region region(qbuf.data() + 16, qn, dbuf.data() + 16, dn, a.numsiglets,
                  p);
    HitNode* allhits = region.run();
    Merger m(qbuf.data() + 16, qn, dbuf.data() + 16, dn, p);
    allhits = remove_dups(allhits, m);
    transloc_hits(allhits, i, j, qn, dn);
    print_hits(allhits, a.name.c_str(), b.name.c_str(), 0, 0, gfc, out, dir,
               (int)n2);
  };
  for (int i = 0; i < 6; ++i)
    for (int j = (i / 3) * 3; j < (i / 3 + 1) * 3; ++j)
      run_pair(i, j, '+');
  if (both)
    for (int i = 0; i < 6; ++i)
      for (int j = (i > 2) ? 0 : 3; j < ((i > 2) ? 3 : 6); ++j)
        run_pair(i, j, '-');
}

void chaos_pairs(const MappedSeq& s1, const char* name1, const MappedSeq& s2,
                 const char* name2,
                 const std::vector<std::array<int, 4>>& pairs, int wl, int nd,
                 int co, int rsc, bool gfc, bool ext, std::string* out) {
  Params p{wl, nd, co, rsc, gfc, ext};
  size_t pi = 0;
  while (pi < pairs.size()) {
    // procPairs (fchaos.c:743-776): skip regions where both sides are
    // shorter than wordlen + 1.
    int a = 0, b = 0, c = 0, d = 0;
    bool have = false;
    while (pi < pairs.size()) {
      a = pairs[pi][0];
      b = pairs[pi][1];
      c = pairs[pi][2];
      d = pairs[pi][3];
      ++pi;
      if (!(b - a + 1 < wl + 1 && d - c + 1 < wl + 1)) {
        have = true;
        break;
      }
    }
    if (!have) break;
    int qn = b - a + 1;
    int dn = d - c + 1;
    // region slices, NUL-padded on both sides (the reference pokes a NUL at
    // the region end and never reads past its extension bounds).
    std::string qbuf(16, '\0'), dbuf(16, '\0');
    qbuf.append(s1.lets + (a - 1), (size_t)qn);
    qbuf.append(16, '\0');
    dbuf.append(s2.lets + (c - 1), (size_t)dn);
    dbuf.append(16, '\0');
    Region region(qbuf.data() + 16, qn, dbuf.data() + 16, dn, s1.numsiglets,
                  p);
    HitNode* allhits = region.run();
    Merger m(qbuf.data() + 16, qn, dbuf.data() + 16, dn, p);
    allhits = remove_dups(allhits, m);
    print_hits(allhits, name1, name2, a, c, gfc, out);
  }
}

void chaos_stats(long long* out) {
  out[0] = g_words.load();
  out[1] = g_links.load();
}

}  // namespace lagan
