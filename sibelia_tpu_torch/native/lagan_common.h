// Shared definitions for the native LAGAN-semantics engine.
// See lagan_chaos.cpp for the fidelity contract.
#ifndef SIBELIA_TPU_LAGAN_COMMON_H
#define SIBELIA_TPU_LAGAN_COMMON_H

#include <cstring>
#include <cctype>
#include <string>
#include <vector>

namespace lagan {

// Substitution scores (reference: src/lagan/nucmatrix.txt, loaded by
// readSubstMatrix in fchaos.c:603-632 / order.c:126-153).
struct SubstMatrix {
  int m[256][256];
  SubstMatrix() {
    static const char sym[7] = "ACGT.N";
    static const int val[6][6] = {
        {91, -114, -31, -123, 0, -43},
        {-114, 100, -125, -31, 0, -43},
        {-31, -125, 100, -114, 0, -43},
        {-123, -31, -114, 91, 0, -43},
        {0, 0, 0, 0, 0, 0},
        {-43, -43, -43, -43, 0, -43},
    };
    std::memset(m, 0, sizeof(m));
    for (int i = 0; i < 6; ++i)
      for (int j = 0; j < 6; ++j)
        m[(unsigned char)sym[i]][(unsigned char)sym[j]] = val[i][j];
  }
};

inline const SubstMatrix& subst() {
  static const SubstMatrix s;
  return s;
}

inline int matchscore(unsigned char a, unsigned char b) {
  return subst().m[a][b];
}


// Protein substitution scores (reference: src/lagan/blosum62s.txt, loaded
// for -p / -t by readSubstMatrix, fchaos.c:644,659).  The file carries no
// trailing gap numbers, so the reference's gappenext keeps its default
// -50 and line 629 doubles it: translated/protein chaos gap penalties are
// -100 open and -100 extend.
struct BlosumMatrix {
  int m[256][256];
  BlosumMatrix() {
    static const char sym[25] = "ARNDCQEGHILKMFPSTWYVBZX*";
    static const int val[24][24] = {
        {223, -55, -111, -111, 0, -55, -55, 0, -111, -55, -55, -55, -55, -111, -55, 55, 0, -167, -111, 0, -111, -55, 0, -223},
        {-55, 278, 0, -111, -167, 55, 0, -111, 0, -167, -111, 111, -55, -167, -111, -55, -55, -167, -111, -167, -55, 0, -55, -223},
        {-111, 0, 334, 55, -167, 0, 0, 0, 55, -167, -167, 0, -111, -167, -111, 55, 0, -223, -111, -167, 167, 0, -55, -223},
        {-111, -111, 55, 334, -167, 0, 111, -55, -55, -167, -223, -55, -167, -167, -55, 0, -55, -223, -167, -167, 223, 55, -55, -223},
        {0, -167, -167, -167, 502, -167, -223, -167, -167, -55, -55, -167, -55, -111, -167, -55, -55, -111, -111, -55, -167, -167, -111, -223},
        {-55, 55, 0, 0, -167, 278, 111, -111, 0, -167, -111, 55, 0, -167, -55, 0, -55, -111, -55, -111, 0, 167, -55, -223},
        {-55, 0, 0, 111, -223, 111, 278, -111, 0, -167, -167, 55, -111, -167, -55, 0, -55, -167, -111, -111, 55, 223, -55, -223},
        {0, -111, 0, -55, -167, -111, -111, 334, -111, -223, -223, -111, -167, -167, -111, 0, -111, -111, -167, -167, -55, -111, -55, -223},
        {-111, 0, 55, -55, -167, 0, 0, -111, 446, -167, -167, -55, -111, -55, -111, -55, -111, -111, 111, -167, 0, 0, -55, -223},
        {-55, -167, -167, -167, -55, -167, -167, -223, -167, 223, 111, -167, 55, 0, -167, -111, -55, -167, -55, 167, -167, -167, -55, -223},
        {-55, -111, -167, -223, -55, -111, -167, -223, -167, 111, 223, -111, 111, 0, -167, -111, -55, -111, -55, 55, -223, -167, -55, -223},
        {-55, 111, 0, -55, -167, 55, 55, -111, -55, -167, -111, 278, -55, -167, -55, 0, -55, -167, -111, -111, 0, 55, -55, -223},
        {-55, -55, -111, -167, -55, 0, -111, -167, -111, 55, 111, -55, 278, 0, -111, -55, -55, -55, -55, 55, -167, -55, -55, -223},
        {-111, -167, -167, -167, -111, -167, -167, -167, -55, 0, 0, -167, 0, 334, -223, -111, -111, 55, 167, -55, -167, -167, -55, -223},
        {-55, -111, -111, -55, -167, -55, -55, -111, -111, -167, -167, -55, -111, -223, 390, -55, -55, -223, -167, -111, -111, -55, -111, -223},
        {55, -55, 55, 0, -55, 0, 0, 0, -55, -111, -111, 0, -55, -111, -55, 223, 55, -167, -111, -111, 0, 0, 0, -223},
        {0, -55, 0, -55, -55, -55, -55, -111, -111, -55, -55, -55, -55, -111, -55, 55, 278, -111, -111, 0, -55, -55, 0, -223},
        {-167, -167, -223, -223, -111, -111, -167, -111, -111, -167, -111, -167, -55, 55, -223, -167, -111, 613, 111, -167, -223, -167, -111, -223},
        {-111, -111, -111, -167, -111, -55, -111, -167, 111, -55, -55, -111, -55, 167, -167, -111, -111, 111, 390, -55, -167, -111, -55, -223},
        {0, -167, -167, -167, -55, -111, -111, -167, -167, 167, 55, -111, 55, -55, -111, -111, 0, -167, -55, 223, -167, -111, -55, -223},
        {-111, -55, 167, 223, -167, 0, 55, -55, 0, -167, -223, 0, -167, -167, -111, 0, -55, -223, -167, -167, 223, 55, -55, -223},
        {-55, 0, 0, 55, -167, 167, 223, -111, 0, -167, -167, 55, -55, -167, -55, 0, -55, -167, -111, -111, 55, 223, -55, -223},
        {0, -55, -55, -55, -111, -55, -55, -55, -55, -55, -55, -55, -55, -55, -111, 0, 0, -111, -55, -55, -55, -55, -55, -223},
        {-223, -223, -223, -223, -223, -223, -223, -223, -223, -223, -223, -223, -223, -223, -223, -223, -223, -223, -223, -223, -223, -223, -223, 55},
    };
    std::memset(m, 0, sizeof(m));
    for (int i = 0; i < 24; ++i)
      for (int j = 0; j < 24; ++j)
        m[(unsigned char)sym[i]][(unsigned char)sym[j]] = val[i][j];
  }
};

inline const BlosumMatrix& blosum() {
  static const BlosumMatrix b;
  return b;
}

const int kChaosProtGapStart = -100;
const int kChaosProtGapExt = -100;

// Trie alphabet classes: prottriealpha "PCMH[DE][KR][NQ][ST][ILV][FYW][AG]"
// parsed as makeAlpha does (thrtrie.c:19-39): 11 classes; X and * are
// non-significant (class -1).
struct ProtClasses {
  signed char cls[256];
  int n;
  ProtClasses() {
    for (int i = 0; i < 256; ++i) cls[i] = -1;
    const char* a = "PCMH[DE][KR][NQ][ST][ILV][FYW][AG]";
    int i = 0, isin = 0;
    while (*a) {
      if (!isin && *a == '[') isin = 1;
      else if (isin && *a == ']') { isin = 0; ++i; }
      else if (isin) cls[(unsigned char)*a] = (signed char)i;
      else cls[(unsigned char)*a] = (signed char)i++;
      ++a;
    }
    n = i;
  }
};

inline const ProtClasses& prot_classes() {
  static const ProtClasses p;
  return p;
}

// chaos doubles nucmatrix's continue penalty and uses it for open and extend
// (fchaos.c:627-629): both -50.  order reads -400/-25 directly.
const int kChaosGapStart = -50;
const int kChaosGapExt = -50;
const int kOrderGapStart = -400;
const int kOrderGapCont = -25;

// Input mapping (reference: filebuffer.c:92-198).  16 zero bytes of padding
// on each side make the reference's benign out-of-range reads deterministic.
struct MappedSeq {
  std::string store;
  char* lets;
  int numlets;
  int numsiglets;
};

inline void map_sequence(const char* raw, long n, bool order_mode,
                         MappedSeq* out) {
  const char* alpha = order_mode ? "ATCGN-." : "ATCGNPCMHDEKRQSILVFYWX*";
  char table[256];
  for (int i = 0; i < 256; ++i) {
    int u = std::toupper(i);
    table[i] = (u != 0 && std::strchr(alpha, (char)u) != nullptr) ? (char)u : 'N';
  }
  int numNs = 0;
  out->store.assign(16, '\0');
  if (order_mode) out->store.push_back('\0');  // order's res[0] sentinel
  for (long i = 0; i < n; ++i) {
    unsigned char c = (unsigned char)raw[i];
    if (c == 'N') ++numNs;  // raw-byte count only (filebuffer.c:148)
    out->store.push_back(table[c]);
  }
  out->store.append(17, '\0');
  // order mode: lets[0] is the zero sentinel, lets[1..numlets] the bases
  // (mirrors FileRead's res[0] = 0 for VER_ORDER); chaos mode: lets[0] is
  // the first base.
  out->lets = &out->store[16];
  out->numlets = (int)n;
  out->numsiglets = (int)n - numNs;
}

// A chaos local alignment (hll of fchaos.h) with its gap-free chunks.
struct Chunk {
  int offset;
  int length;
  int score;
};

struct Hit {
  int s1s, s1e, s2s, s2e;
  float score;
  std::vector<Chunk> chunks;
};

}  // namespace lagan

#endif  // SIBELIA_TPU_LAGAN_COMMON_H
