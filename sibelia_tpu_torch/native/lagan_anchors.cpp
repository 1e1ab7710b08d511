// anchors stage of the native LAGAN-semantics engine.
//
// Replicates the reference chain selector (reference: src/lagan/src/anchors.c
// with the skiplist of skiplist.c) over text buffers:
//  * the tolerant line parser (rolltonum + the two sscanf's,
//    anchors.c:193-242) including its sliding last-two-numbers window;
//  * with -gfc, chunk lines attach to the preceding hit REVERSED
//    (anchors.c:254-266 prepends while reading);
//  * hits are held in reverse file order (parseCHAOS prepends) and the event
//    array ordering reproduces glibc's merge sort under the reference's
//    inconsistent comparator (anchors.c:45-58): equal-position start events
//    keep insertion order, equal-position end events reverse it;
//  * the sweep (anchors.c:124-165) with single-precision score accumulation
//    and the Pareto pruning of dominated chain ends;
//  * output walks the best chain's back-pointers (descending coordinates),
//    hits with chunks expand into their chunk lines (anchors.c:167-191).
//
// Default gap parameters (rechaos.pl passes none) are gapopen = gapcont = 0.
#include <cstdio>
#include <cstring>
#include <cctype>
#include <climits>
#include <string>
#include <vector>
#include <list>
#include <algorithm>

#include "lagan_common.h"
#include "lagan_stages.h"

namespace lagan {
namespace {

struct AChunk {
  int y, x, length, score;  // y/x naming as parsed (anchors.c:257)
};

struct AHit {
  int a_s, a_e;  // first printed pair (file-1 coordinates)
  int b_s, b_e;  // second pair (file-2 coordinates)
  float score;
  std::vector<AChunk> chunks;  // reversed file order, as the reference holds
  AHit* bkptr = nullptr;
  float sofar = 0;
};

const float kGapOpen = 0.0f;
const float kGapCont = 0.0f;

// rolltonum (anchors.c:193-226): returns the offset of the first of the last
// two whitespace-preceded digit runs before a ';', or the string end.
size_t rolltonum(const char* str) {
  const char* got1 = nullptr;
  const char* got2 = nullptr;
  int in = 0;
  size_t i = 0;
  while (true) {
    char c = str[i];
    if (c == 0) break;
    if (c == ';' && got1 && got2) return (size_t)(got1 - str);
    if (isdigit((unsigned char)c)) {
      if (!in && (i == 0 || isspace((unsigned char)str[i - 1]))) {
        if (got1)
          got2 = &str[i];
        else
          got1 = &str[i];
        in = 1;
      }
    } else if (in && isspace((unsigned char)c)) {
      if (got2) {
        got1 = got2;
        got2 = nullptr;
      }
      in = 0;
    } else {
      in = 0;
      got1 = got2 = nullptr;
    }
    ++i;
  }
  return i;
}

bool parse_hit_line(const char* line, AHit* tt) {  // getlineLagan
  size_t off = rolltonum(line);
  int h = 0;
  if (std::sscanf(line + off, "%d %d;%n", &tt->a_s, &tt->a_e, &h) < 2)
    return false;
  off += rolltonum(line + off + h) + (size_t)h;
  float sc;
  if (std::sscanf(line + off, "%d %d; score = %f (%*c)", &tt->b_s, &tt->b_e,
                  &sc) < 3)
    return false;
  tt->score = sc;
  return true;
}

bool parse_chunk_line(const char* line, AChunk* c) {
  // The reference consumes chunk groups with fscanf("%d %d %d %d"); for the
  // text this pipeline generates, that is exactly a line of four integers.
  int n = 0;
  if (std::sscanf(line, "%d %d %d %d %n", &c->y, &c->x, &c->length, &c->score,
                  &n) < 4)
    return false;
  while (line[n] != 0) {
    if (!isspace((unsigned char)line[n])) return false;
    ++n;
  }
  return true;
}

struct Event {
  int number;
  char isstart;
  AHit* hit;
};

}  // namespace

void anchors_text(const std::string& hits_text, bool gfc, std::string* out) {
  // parseCHAOS: build the hit list in reverse file order; chunks attach to
  // the most recent hit, prepended.
  std::vector<AHit*> file_order;
  size_t pos = 0;
  AHit* pending = nullptr;
  while (pos < hits_text.size()) {
    size_t eol = hits_text.find('\n', pos);
    if (eol == std::string::npos) eol = hits_text.size();
    std::string line = hits_text.substr(pos, eol - pos);
    pos = eol + 1;
    AChunk ch;
    if (gfc && pending && parse_chunk_line(line.c_str(), &ch)) {
      pending->chunks.insert(pending->chunks.begin(), ch);
      continue;
    }
    AHit tt;
    if (parse_hit_line(line.c_str(), &tt)) {
      AHit* hp = new AHit(tt);
      file_order.push_back(hp);
      pending = gfc ? hp : nullptr;
    }
  }
  if (file_order.empty()) return;

  // event array in list order (reverse file order), then the glibc-msort
  // ordering under the reference comparator.
  std::vector<Event> ev;
  ev.reserve(file_order.size() * 2);
  for (auto it = file_order.rbegin(); it != file_order.rend(); ++it) {
    ev.push_back(Event{(*it)->b_s, 1, *it});
    ev.push_back(Event{(*it)->b_e, 0, *it});
  }
  std::stable_sort(ev.begin(), ev.end(), [](const Event& a, const Event& b) {
    if (a.number != b.number) return a.number < b.number;
    return a.isstart > b.isstart;  // starts first
  });
  // reverse runs of equal (number, end) events — glibc msort with the
  // inconsistent comparator reverses equal end events.
  for (size_t i = 0; i < ev.size();) {
    size_t j = i + 1;
    while (j < ev.size() && ev[j].number == ev[i].number &&
           ev[j].isstart == ev[i].isstart)
      ++j;
    if (!ev[i].isstart && j - i > 1) std::reverse(ev.begin() + i, ev.begin() + j);
    i = j;
  }

  // sweep (anchors.c:124-165); the skiplist is an ordered list keyed by the
  // file-1 end coordinate with a sentinel head.
  struct Entry {
    int index;
    AHit* hit;
  };
  std::list<Entry> lst;
  lst.push_back(Entry{INT_MIN, nullptr});
  auto find_lt = [&](int key) {
    auto last = lst.begin();
    for (auto it = std::next(lst.begin()); it != lst.end(); ++it) {
      if (it->index >= key) break;
      last = it;
    }
    return last;
  };
  auto gap_pen = [](const AHit* next, const AHit* prev) -> float {
    return (float)(next->a_s - prev->a_e) * kGapCont + kGapOpen;
  };
  auto wh_rulez = [](const AHit* one, const AHit* two) -> bool {
    float gapdiff = (float)(two->a_e - one->a_e) * kGapCont;
    return two->sofar - one->sofar - gapdiff > 0;
  };
  for (const Event& e : ev) {
    if (e.isstart) {
      auto help = find_lt(e.hit->a_s);
      if (help->hit && gap_pen(e.hit, help->hit) + help->hit->sofar > 0) {
        e.hit->bkptr = help->hit;
        e.hit->sofar =
            help->hit->sofar + e.hit->score + gap_pen(e.hit, help->hit);
      } else {
        e.hit->bkptr = nullptr;
        e.hit->sofar = e.hit->score;
      }
    } else {
      auto help = find_lt(e.hit->a_e);
      if (help->hit && wh_rulez(e.hit, help->hit)) continue;
      auto ins = lst.insert(std::next(help), Entry{e.hit->a_e, e.hit});
      while (std::next(ins) != lst.end() &&
             !wh_rulez(ins->hit, std::next(ins)->hit))
        lst.erase(std::next(ins));
    }
  }
  float best = -1;
  AHit* bestptr = nullptr;
  for (auto it = std::next(lst.begin()); it != lst.end(); ++it) {
    if (it->hit->sofar > best) {
      best = it->hit->sofar;
      bestptr = it->hit;
    }
  }

  // doOutput (anchors.c:167-191)
  char buf[256];
  for (AHit* t = bestptr; t; t = t->bkptr) {
    if (!gfc || t->chunks.empty()) {
      std::snprintf(buf, sizeof(buf), "(%d %d)=(%d %d) %f\n", t->a_s, t->a_e,
                    t->b_s, t->b_e, (double)t->score);
      out->append(buf);
    } else {
      for (const AChunk& c : t->chunks) {
        std::snprintf(buf, sizeof(buf), "(%d %d)=(%d %d) %d\n", c.y,
                      c.y + c.length - 1, c.x, c.x + c.length - 1, c.score);
        out->append(buf);
      }
    }
  }
  for (AHit* h : file_order) delete h;
}

}  // namespace lagan
