// Native k-mer ranking + bifurcation enumeration kernels (host runtime).
//
// C++ twins of sibelia_tpu/index/ranking.py::kmer_ranks_numpy and
// sibelia_tpu/index/enumeration.py::enumerate_bifurcations with identical
// outputs.  Replaces the reference's divsufsort + LCP construction and
// suffix-group scan (reference: src/vertexenumeration.cpp:103,292; :44-65;
// :193-256) on the host path.
//
// Ranking: base-4 packing of up to 32 chars into overlapped u64 keys, one
// LSD radix argsort (pair-scatter, position-stable), then chunked prefix
// doubling over the active set (groups that can still split), dropping
// singleton groups each round.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <thread>
#include <mutex>
#include <algorithm>
#include <chrono>
#include <unordered_map>
#include <functional>
#include <sys/mman.h>
#include <sys/resource.h>
#include <sys/types.h>
#include <fcntl.h>
#include <unistd.h>

namespace {

// ---------------------------------------------------------------------------
// External-memory (bounded-RSS) mode.
//
// When SIBELIA_TPU_SPILL_DIR is set, arenas above a size threshold are
// backed by unlinked temp files (MAP_SHARED) instead of anonymous
// memory, and the streaming phases drop processed windows from the
// mapping with MADV_DONTNEED.  File-backed pages are page-cache pages:
// dropping them bounds the process RSS without losing data (dirty pages
// stay in the cache and are written back by the kernel; re-access is a
// minor fault while cached, a disk read once evicted).  On a large-RAM
// host this costs almost nothing; on a small host it degrades to
// disk-streamed passes — the TPU-era equivalent of the reference's
// TempFile-streamed external suffix array
// (reference: src/vertexenumeration.cpp:99-157, src/platform.cpp:44-128).
// Temp files are unlinked at creation, so any exit reclaims the disk.
// ---------------------------------------------------------------------------

const char* spill_dir() {
  static const char* d = [] {
    const char* v = std::getenv("SIBELIA_TPU_SPILL_DIR");
    if (!v || !v[0]) return (const char*)nullptr;
    char* copy = (char*)std::malloc(std::strlen(v) + 1);
    std::strcpy(copy, v);
    return (const char*)copy;
  }();
  return d;
}

bool spill_on() { return spill_dir() != nullptr; }

// arenas below this stay anonymous even in spill mode (mini-index
// calls); SIBELIA_TPU_SPILL_MIN overrides (bytes; tests force 0)
size_t spill_min() {
  static size_t v = [] {
    const char* e = std::getenv("SIBELIA_TPU_SPILL_MIN");
    if (e && e[0]) return (size_t)std::strtoull(e, nullptr, 10);
    return (size_t)64 << 20;
  }();
  return v;
}
// streaming phases drop processed windows at this element granularity
const int64_t kSpillWindow = (int64_t)1 << 25;  // 32M elements
// random-scatter phases drop their whole destination every this many
// processed elements per thread (bounds dirty-page accumulation)
const int64_t kSpillQuantum = (int64_t)1 << 24;  // 16M elements
// whole-array drop cadence for the global scatter destinations (the
// costly madvise storms; accumulation between drops stays ~6 GB)
const int64_t kSpillDropQuantum = (int64_t)1 << 26;  // 64M elements

// Whether to request transparent huge pages on arena mappings.  Huge
// pages cut first-touch faults ~500x, but when the kernel's THP defrag
// mode is "always" or "madvise" the fault path runs SYNCHRONOUS direct
// compaction, which on busy/small hosts costs tens of seconds of sys
// time per arena — far worse than the 4 KiB faults it saves.  So THP is
// requested only when the active defrag mode is asynchronous ("defer",
// "defer+madvise") or "never"; SIBELIA_TPU_HUGEPAGE=0/1 forces.
bool hugepage_ok() {
  static int ok = [] {
    const char* v = std::getenv("SIBELIA_TPU_HUGEPAGE");
    if (v && v[0] == '0') return 0;
    if (v && v[0] == '1') return 1;
    FILE* f = std::fopen("/sys/kernel/mm/transparent_hugepage/defrag", "r");
    if (!f) return 0;
    char buf[256] = {0};
    size_t got = std::fread(buf, 1, sizeof(buf) - 1, f);
    std::fclose(f);
    (void)got;
    const char* b = std::strchr(buf, '[');
    if (!b) return 0;
    return (std::strncmp(b, "[defer", 6) == 0 ||
            std::strncmp(b, "[never", 6) == 0)
               ? 1
               : 0;
  }();
  return ok != 0;
}

// ---------------------------------------------------------------------------
// Arena slab.  On this class of VM kernel, page acquisition from the
// host costs ~1 s/GB while the process RSS is small (and inside one
// large MAP_POPULATE call), but ~5 s/GB for every later allocation once
// RSS crosses ~2 GB (measured; the cost is per 4 KiB page regardless of
// THP or populate).  The CLI therefore reserves ONE populated slab
// sized for the whole in-RAM arena set right after reading the input
// (rank_slab_reserve), and HVec carves from it; allocations that do not
// fit fall back to plain mmap.  Slab memory is never returned
// (arenas are persistent for the process lifetime anyway).
// ---------------------------------------------------------------------------
struct Slab {
  char* base = nullptr;
  size_t cap = 0, used = 0;
  std::mutex mu;
};
Slab& g_slab() {
  static Slab s;
  return s;
}
void* slab_try_alloc(size_t nb) {
  Slab& s = g_slab();
  std::lock_guard<std::mutex> g(s.mu);
  if (!s.base) return nullptr;
  size_t aligned = (s.used + ((size_t)2 << 20) - 1) &
                   ~(((size_t)2 << 20) - 1);
  if (aligned + nb > s.cap) return nullptr;
  void* p = s.base + aligned;
  s.used = aligned + nb;
  return p;
}

// Grow-only scratch buffer backed by anonymous mmap (THP requested only
// when safe, see hugepage_ok).  The arenas below are per-call scratch
// measured in hundreds of MB.  Growth discards contents (every user
// fills its range before reading), so no copy is ever made.
template <typename T>
struct HVec {
  T* ptr = nullptr;
  size_t cap = 0;     // elements
  size_t bytes = 0;   // mapped bytes
  bool spilled = false;  // file-backed (MAP_SHARED on an unlinked file)
  bool from_slab = false;  // carved from the populated slab (never unmapped)
  size_t size() const { return cap; }
  T* data() { return ptr; }
  const T* data() const { return ptr; }
  T& operator[](size_t i) { return ptr[i]; }
  const T& operator[](size_t i) const { return ptr[i]; }
  void release() {
    if (!ptr) return;
    if (from_slab) {
      // slab regions are leaked back (the slab lives for the process)
      ptr = nullptr;
      cap = 0;
      bytes = 0;
      from_slab = false;
      return;
    }
    if (bytes) munmap(ptr, bytes); else std::free(ptr);
    ptr = nullptr;
    cap = 0;
    bytes = 0;
    spilled = false;
  }
  // Drop resident pages from the mapping.  Safe at ANY time on spilled
  // arenas (data persists in the page cache / file; re-access refaults),
  // a strict no-op otherwise — callers sprinkle these freely.
  void drop() {
    if (spilled && ptr) madvise(ptr, bytes, MADV_DONTNEED);
  }
  void drop_range(size_t lo_elem, size_t hi_elem) {
    if (!spilled || !ptr || hi_elem <= lo_elem) return;
    size_t lo = (lo_elem * sizeof(T) + 4095) & ~(size_t)4095;
    size_t hi = (hi_elem * sizeof(T)) & ~(size_t)4095;
    if (hi > bytes) hi = bytes;
    if (hi > lo) madvise((char*)ptr + lo, hi - lo, MADV_DONTNEED);
  }
  bool no_spill = false;  // set on buffers that ARE the in-RAM budget
  void resize(size_t n) {
    if (n <= cap) return;
    size_t want = n + n / 8;  // slack so stagewise growth remaps rarely
    size_t nb = (want * sizeof(T) + ((size_t)2 << 20) - 1) &
                ~(((size_t)2 << 20) - 1);
    const char* sd = no_spill ? nullptr : spill_dir();
    if (sd && nb >= spill_min()) {
      // spilled arenas take exact size: the supergenome only shrinks
      // across stages, and at the 1 GB cap the 12.5% slack would cost
      // ~12 GB of scarce temp disk
      nb = (n * sizeof(T) + ((size_t)2 << 20) - 1) &
           ~(((size_t)2 << 20) - 1);
    }
    if (sd && nb >= spill_min()) {
      int fd = open(sd, O_TMPFILE | O_RDWR, 0600);
      if (fd < 0) {
        char tmpl[4096];
        std::snprintf(tmpl, sizeof(tmpl), "%s/sibelia_spill_XXXXXX", sd);
        fd = mkstemp(tmpl);
        if (fd >= 0) unlink(tmpl);
      }
      if (fd >= 0) {
        if (ftruncate(fd, (off_t)nb) == 0) {
          void* p = mmap(nullptr, nb, PROT_READ | PROT_WRITE, MAP_SHARED,
                         fd, 0);
          close(fd);
          if (p != MAP_FAILED) {
            release();
            ptr = (T*)p;
            cap = nb / sizeof(T);
            bytes = nb;
            spilled = true;
            return;
          }
        } else {
          close(fd);
        }
      }
      std::fprintf(stderr,
                   "sibelia_tpu: spill-file creation failed in %s; "
                   "using anonymous memory\n", sd);
    }
    // MAP_POPULATE: on this class of VM kernel, per-page demand faults
    // cost ~20 us each once the process holds >~1 GB RSS (measured:
    // ~5.5 s/GB), while the batched populate-at-mmap path stays at
    // ~0.3 s/GB regardless of held RSS.  Arenas are fully written by
    // their first user anyway, so populating up front costs nothing
    // extra on a normal kernel and removes the dominant hidden cost on
    // this one.  SIBELIA_TPU_POPULATE=0 opts out.
    static const bool populate = [] {
      const char* v = std::getenv("SIBELIA_TPU_POPULATE");
      return !(v && v[0] == '0');
    }();
    auto dispose_old = [&] {
      if (!ptr || from_slab) return;  // slab regions leak back
      if (bytes) munmap(ptr, bytes); else std::free(ptr);
    };
    if (void* sp2 = slab_try_alloc(nb)) {
      dispose_old();
      ptr = (T*)sp2;
      cap = nb / sizeof(T);
      bytes = nb;
      spilled = false;
      from_slab = true;
      return;
    }
    void* p = mmap(nullptr, nb, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS |
                       (populate ? MAP_POPULATE : 0),
                   -1, 0);
    if (p == MAP_FAILED) {
      p = std::malloc(nb);
      if (!p) {
        std::fprintf(stderr, "sibelia_tpu: arena alloc failed\n");
        std::abort();
      }
      dispose_old();
      ptr = (T*)p;
      cap = nb / sizeof(T);
      bytes = 0;  // malloc-backed
      spilled = false;
      from_slab = false;
      return;
    }
    if (hugepage_ok()) madvise(p, nb, MADV_HUGEPAGE);
    dispose_old();
    ptr = (T*)p;
    cap = nb / sizeof(T);
    bytes = nb;
    spilled = false;
    from_slab = false;
  }
};

// Phase timing, enabled by SIBELIA_TPU_PROF=1 (stderr); sys-time and
// minor-fault deltas included (first-touch/fault pathologies show up as
// sys time attributed to otherwise cheap phases).
struct Prof {
  const char* name;
  std::chrono::steady_clock::time_point t0;
  struct rusage r0;
  static bool enabled() {
    static int e = [] {
      const char* v = std::getenv("SIBELIA_TPU_PROF");
      return (v && v[0] == '1') ? 1 : 0;
    }();
    return e != 0;
  }
  explicit Prof(const char* n) : name(n) {
    if (enabled()) {
      t0 = std::chrono::steady_clock::now();
      getrusage(RUSAGE_SELF, &r0);
    }
  }
  ~Prof() {
    if (enabled()) {
      double ms = std::chrono::duration<double, std::milli>(
                      std::chrono::steady_clock::now() - t0)
                      .count();
      struct rusage r1;
      getrusage(RUSAGE_SELF, &r1);
      double sys_ms =
          (r1.ru_stime.tv_sec - r0.ru_stime.tv_sec) * 1e3 +
          (r1.ru_stime.tv_usec - r0.ru_stime.tv_usec) * 1e-3;
      long flt = r1.ru_minflt - r0.ru_minflt;
      std::fprintf(stderr, "[prof] %-22s %8.1f ms (sys %.0f ms, %ldk flt)\n",
                   name, ms, sys_ms, flt / 1000);
    }
  }
};

// Parallel-for over contiguous slices (no-op threading below ~512k items).
template <typename F>
void parallel_for(int64_t n, F f) {
  unsigned hw = std::thread::hardware_concurrency();
  int T = (n >= (1 << 19) && hw > 1) ? (int)std::min<unsigned>(hw, 8) : 1;
  if (T == 1) {
    f((int64_t)0, n);
    return;
  }
  std::vector<std::thread> th;
  for (int t = 0; t < T; ++t)
    th.emplace_back([&, t]() { f(n * t / T, n * (t + 1) / T); });
  for (auto& x : th) x.join();
}

// Position-stable LSD radix argsort of u64 keys, starting from the
// identity permutation (all call sites sort fresh iotas).  Keys and
// 32-bit indices ping-pong between persistent arena buffers (no per-call
// allocation or page-fault churn; 12 B/element/pass of traffic).  16-bit
// digits (≤4 passes); constant-digit passes are skipped, so narrow keys
// (e.g. dense ranks) pay only for the bits they use.  The counting and
// scatter phases are parallelized over contiguous slices with
// per-(thread, digit) cursors, which preserves stability.
struct SortArena {
  HVec<uint64_t> k[2];
  HVec<uint32_t> i[2];  // u32 indices cover the 1 GB-cap supergenome
  HVec<int64_t> i64[2];
  std::vector<std::vector<int64_t>> cnt;
};
SortArena& sort_arena() {
  static SortArena a;
  return a;
}

void sort_arena_release() {
  SortArena& a = sort_arena();
  for (int s = 0; s < 2; ++s) {
    a.k[s].release();
    a.i[s].release();
    a.i64[s].release();
  }
}

// Above this element count, single-use arenas are unmapped as soon as
// their phase ends: at genome scale the persistent-arena policy (which
// exists to avoid re-fault churn on the many small mini-index calls)
// would otherwise hold tens of GB across the whole pipeline.
const int64_t kReleaseThreshold = (int64_t)1 << 27;  // 134M


template <typename IdxT, typename OutT>
void radix_argsort_impl(const uint64_t* keys, OutT* idx, int64_t n,
                        HVec<uint64_t>* kbuf, HVec<IdxT>* ibuf,
                        std::vector<std::vector<int64_t>>& cntbuf,
                        uint64_t* sorted_out = nullptr,
                        std::function<void(int64_t, int64_t)> drop_out =
                            nullptr,
                        uint64_t* alias_k0 = nullptr,
                        IdxT* alias_i0 = nullptr) {
  // alias_k0/alias_i0 (in-RAM only): the caller's key/index arrays serve
  // as ping-pong partner 0, halving the sort-arena footprint (the keys
  // are consumed and the index array is pure output at every call site,
  // and page acquisition costs ~5.5 s/GB on this kernel — see HVec).
  int T = 1;
  if (n >= (1 << 19)) {
    unsigned hw = std::thread::hardware_concurrency();
    T = (int)std::min<unsigned>(hw ? hw : 1, 8);
  }
  const bool aliased = alias_k0 != nullptr;
  uint64_t* kb[2];
  IdxT* ib[2];
  for (int s = aliased ? 1 : 0; s < 2; ++s) {
    if ((int64_t)kbuf[s].size() < n) kbuf[s].resize((size_t)n);
    if ((int64_t)ibuf[s].size() < n) ibuf[s].resize((size_t)n);
    kb[s] = kbuf[s].data();
    ib[s] = ibuf[s].data();
  }
  if (aliased) {
    kb[0] = alias_k0;
    ib[0] = alias_i0;
  }
  if ((int)cntbuf.size() < T) cntbuf.resize((size_t)T);
  for (int t = 0; t < T; ++t)
    if (cntbuf[(size_t)t].size() < (1 << 16))
      cntbuf[(size_t)t].resize((size_t)(1 << 16));
  const bool sp = aliased ? false : kbuf[0].spilled;
  int cur = 0;
  if (aliased) {
    // keys already live in kb[0]; only the identity permutation fills
    parallel_for(n, [&](int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; ++i) ib[0][i] = (IdxT)i;
    });
  } else {
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t w = lo; w < hi; w += kSpillWindow) {
      int64_t we = std::min(hi, w + kSpillWindow);
      for (int64_t i = w; i < we; ++i) {
        kb[0][(size_t)i] = keys[i];
        ib[0][(size_t)i] = (IdxT)i;
      }
      if (sp) {
        kbuf[0].drop_range((size_t)w, (size_t)we);
        ibuf[0].drop_range((size_t)w, (size_t)we);
      }
    }
  });
  }
  for (int pass = 0; pass < 4; ++pass) {
    int shift = pass * 16;
    const uint64_t* kc = kb[cur];
    const IdxT* ic = ib[cur];
    auto count_slice = [&](int t) {
      auto& c = cntbuf[(size_t)t];
      std::fill(c.begin(), c.begin() + (1 << 16), 0);
      int64_t lo = n * t / T, hi = n * (t + 1) / T;
      for (int64_t i = lo; i < hi; ++i) ++c[(kc[i] >> shift) & 0xFFFF];
    };
    if (T == 1) {
      count_slice(0);
    } else {
      std::vector<std::thread> th;
      for (int t = 0; t < T; ++t) th.emplace_back(count_slice, t);
      for (auto& x : th) x.join();
    }
    // merged exclusive prefix over (digit, thread); skip constant digits
    bool trivial = false;
    {
      int64_t total = 0;
      for (int d = 0; d < (1 << 16); ++d) {
        int64_t dsum = 0;
        for (int t = 0; t < T; ++t) dsum += cntbuf[(size_t)t][(size_t)d];
        if (dsum == n) { trivial = true; break; }
        for (int t = 0; t < T; ++t) {
          int64_t c = cntbuf[(size_t)t][(size_t)d];
          cntbuf[(size_t)t][(size_t)d] = total;
          total += c;
        }
      }
    }
    if (trivial) continue;
    uint64_t* kn = kb[cur ^ 1];
    IdxT* in = ib[cur ^ 1];
    auto scatter_slice = [&](int t) {
      auto& c = cntbuf[(size_t)t];
      int64_t lo = n * t / T, hi = n * (t + 1) / T;
      int64_t chunk = sp ? kSpillQuantum : (hi - lo > 0 ? hi - lo : 1);
      for (int64_t cs = lo; cs < hi; cs += chunk) {
        int64_t ce = std::min(hi, cs + chunk);
        for (int64_t i = cs; i < ce; ++i) {
          int64_t slot = c[(kc[i] >> shift) & 0xFFFF]++;
          kn[slot] = kc[i];
          in[slot] = ic[i];
        }
        if (sp) {
          // source range is dead after this pass; destination pages are
          // dropped periodically from thread 0 (they re-dirty near the
          // 65536 bucket cursors, bounding accumulation)
          kbuf[cur].drop_range((size_t)cs, (size_t)ce);
          ibuf[cur].drop_range((size_t)cs, (size_t)ce);
          if (t == 0 && ce < hi) {
            kbuf[cur ^ 1].drop();
            ibuf[cur ^ 1].drop();
          }
        }
      }
    };
    if (T == 1) {
      scatter_slice(0);
    } else {
      std::vector<std::thread> th;
      for (int t = 0; t < T; ++t) th.emplace_back(scatter_slice, t);
      for (auto& x : th) x.join();
    }
    cur ^= 1;
  }
  if (aliased && cur == 0) return;  // result already in the caller arrays
  const IdxT* ic = ib[cur];
  const uint64_t* kc = kb[cur];
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t w = lo; w < hi; w += kSpillWindow) {
      int64_t we = std::min(hi, w + kSpillWindow);
      for (int64_t i = w; i < we; ++i) idx[i] = (OutT)ic[i];
      if (sorted_out)
        for (int64_t i = w; i < we; ++i) sorted_out[i] = kc[i];
      if (sp) {
        kbuf[cur].drop_range((size_t)w, (size_t)we);
        ibuf[cur].drop_range((size_t)w, (size_t)we);
        if (drop_out) drop_out(w, we);
      }
    }
  });
}

void radix_argsort_u64(const uint64_t* keys, int64_t* idx, int64_t n) {
  SortArena& ar = sort_arena();
  if (n <= (int64_t)UINT32_MAX) {
    radix_argsort_impl<uint32_t, int64_t>(keys, idx, n, ar.k, ar.i, ar.cnt);
  } else {
    radix_argsort_impl<int64_t, int64_t>(keys, idx, n, ar.k, ar.i64,
                                         ar.cnt);
  }
}

// Variant that additionally overwrites `keys` with the sorted keys, so
// callers can walk group boundaries sequentially instead of gathering
// keys[order[i]] through a random-access stream.  The u32-index variant
// serves every supergenome under the 1 GB input cap (n < 2^32): 32-bit
// cursors and outputs halve the scatter traffic of the sort.
// External-memory argsort: MSD bucketing by the top 16 key bits (one
// bounded global scatter), then per-bucket position-stable sorts in
// small in-RAM temporaries.  Bounded residency: the source is
// window-dropped behind both passes, the scatter destination is dropped
// periodically from thread 0 (it re-dirties only near the 65536 bucket
// cursors), and finished bucket regions are dropped as the final pass
// streams them.  Only ONE global scatter pays the dirty-page
// accumulation (vs 4 LSD passes), and kbuf[0]/ibuf[0] are not needed at
// all, cutting the spill files by a third.  Output identical to the LSD
// path: within a bucket, sorting (key, position) pairs IS
// position-stable key order.
void radix_argsort_u64_sk_extmem(
    uint64_t* keys, uint32_t* idx, int64_t n,
    std::function<void(int64_t, int64_t)> drop_out) {
  SortArena& ar = sort_arena();
  if ((int64_t)ar.k[1].size() < n) ar.k[1].resize((size_t)n);
  if ((int64_t)ar.i[1].size() < n) ar.i[1].resize((size_t)n);
  uint64_t* kd = ar.k[1].data();
  uint32_t* id_ = ar.i[1].data();
  unsigned hw = std::thread::hardware_concurrency();
  int T = (n >= (1 << 19) && hw > 1) ? (int)std::min<unsigned>(hw, 8) : 1;
  const int B = 1 << 16;
  if ((int)ar.cnt.size() < T) ar.cnt.resize((size_t)T);
  for (int t = 0; t < T; ++t)
    if (ar.cnt[(size_t)t].size() < (size_t)B)
      ar.cnt[(size_t)t].resize((size_t)B);
  // pass 1: per-thread histograms of the top 16 bits (src dropped behind)
  {
    auto count_slice = [&](int t) {
      auto& c = ar.cnt[(size_t)t];
      std::fill(c.begin(), c.begin() + B, 0);
      int64_t lo = n * t / T, hi = n * (t + 1) / T;
      for (int64_t w = lo; w < hi; w += kSpillWindow) {
        int64_t we = std::min(hi, w + kSpillWindow);
        for (int64_t i = w; i < we; ++i) ++c[keys[i] >> 48];
        if (drop_out) drop_out(w, we);
      }
    };
    std::vector<std::thread> th;
    for (int t = 0; t < T; ++t) th.emplace_back(count_slice, t);
    for (auto& x : th) x.join();
  }
  // merged exclusive prefix over (bucket, thread): per-thread cursors
  std::vector<int64_t> bucket_off((size_t)B + 1);
  {
    int64_t total = 0;
    for (int d = 0; d < B; ++d) {
      bucket_off[(size_t)d] = total;
      for (int t = 0; t < T; ++t) {
        int64_t c = ar.cnt[(size_t)t][(size_t)d];
        ar.cnt[(size_t)t][(size_t)d] = total;
        total += c;
      }
    }
    bucket_off[(size_t)B] = total;
  }
  // pass 2: the one global scatter (stable: per-(thread, bucket) cursors)
  {
    auto scatter_slice = [&](int t) {
      auto& c = ar.cnt[(size_t)t];
      int64_t lo = n * t / T, hi = n * (t + 1) / T;
      int64_t chunk = kSpillDropQuantum;
      for (int64_t cs = lo; cs < hi; cs += chunk) {
        int64_t ce = std::min(hi, cs + chunk);
        for (int64_t i = cs; i < ce; ++i) {
          int64_t slot = c[keys[i] >> 48]++;
          kd[slot] = keys[i];
          id_[slot] = (uint32_t)i;
        }
        if (drop_out) drop_out(cs, ce);
        if (t == 0 && ce < hi) {
          ar.k[1].drop();
          ar.i[1].drop();
        }
      }
    };
    std::vector<std::thread> th;
    for (int t = 0; t < T; ++t) th.emplace_back(scatter_slice, t);
    for (auto& x : th) x.join();
  }
  // pass 3: per-bucket stable sort ((key, pos) pairs), streamed back out
  {
    auto sort_chunk = [&](int t) {
      struct Rec { uint64_t k; uint32_t i; };
      std::vector<Rec> tmp;
      int64_t last_lo = -1;
      for (int d = t; d < B; d += T) {
        int64_t lo = bucket_off[(size_t)d], hi = bucket_off[(size_t)d + 1];
        int64_t g = hi - lo;
        if (g <= 0) continue;
        tmp.resize((size_t)g);
        for (int64_t i = 0; i < g; ++i)
          tmp[(size_t)i] = Rec{kd[lo + i], id_[lo + i]};
        std::sort(tmp.begin(), tmp.end(), [](const Rec& a, const Rec& b) {
          return a.k != b.k ? a.k < b.k : a.i < b.i;
        });
        for (int64_t i = 0; i < g; ++i) {
          keys[lo + i] = tmp[(size_t)i].k;
          idx[lo + i] = tmp[(size_t)i].i;
        }
        if (last_lo < 0) last_lo = lo;
        if (hi - last_lo >= kSpillWindow) {
          // interleaved bucket ownership makes per-thread ranges
          // non-contiguous; dropping [last_lo, hi) of the scratch is
          // still safe (refault) and bounds the straggler pages
          ar.k[1].drop_range((size_t)last_lo, (size_t)hi);
          ar.i[1].drop_range((size_t)last_lo, (size_t)hi);
          if (drop_out) drop_out(last_lo, hi);
          last_lo = hi;
        }
      }
    };
    std::vector<std::thread> th;
    for (int t = 0; t < T; ++t) th.emplace_back(sort_chunk, t);
    for (auto& x : th) x.join();
    ar.k[1].drop();
    ar.i[1].drop();
  }
}

void radix_argsort_u64_sk(uint64_t* keys, uint32_t* idx, int64_t n,
                          std::function<void(int64_t, int64_t)> drop_out =
                              nullptr) {
  SortArena& ar = sort_arena();
  if (spill_on() && n >= (int64_t)(spill_min() / 8)) {
    radix_argsort_u64_sk_extmem(keys, idx, n, drop_out);
    return;
  }
  if (!spill_on()) {
    // in-RAM: the caller's keys/idx arrays are ping-pong partner 0
    radix_argsort_impl<uint32_t, uint32_t>(keys, idx, n, ar.k, ar.i,
                                           ar.cnt, keys, drop_out, keys,
                                           idx);
    return;
  }
  radix_argsort_impl<uint32_t, uint32_t>(keys, idx, n, ar.k, ar.i, ar.cnt,
                                         keys, drop_out);
}

// Persistent buffers for compute_ranks (reused across calls; enumeration
// runs dozens of times per pipeline and per-call allocation/page-fault
// churn dominated the steady-state sort cost before this).
struct RankArena {
  // rank/order/next_sep are u32: the 1 GB input cap bounds the
  // supergenome below 2^32 positions, and these three are the largest
  // persistent per-position arrays (halves their footprint + traffic).
  // The legacy doubling path's working arrays (r/active/sub/nact) stay
  // int64 (negative sentinels / non-default backend).
  HVec<uint32_t> next_sep, rank, order;
  HVec<int64_t> r, active, sub, nact;
  HVec<uint32_t> p, shifted;   // packed 16-char words (32-bit)
  HVec<uint64_t> big, key;
  HVec<uint8_t> grp, ngrp, gflag;
  HVec<uint32_t> cursor;
  HVec<int64_t> qa, qb;   // LCP refinement: query base/member positions
  HVec<int32_t> ql;       // answered match lengths (capped at k)
  HVec<int32_t> wh;       // word-granular next-mismatch horizon
  HVec<uint64_t> hk[3];   // block-mix signature lanes + one scratch
  HVec<uint64_t> hab;     // interleaved (a,b) signatures (in-RAM resolve)
  HVec<uint64_t> vbits;   // window-validity bitmap (resolve + group scan)
  int64_t vbits_k = -1;   // k the bitmap was built for (reset per call)
  // 32-level result cache: consecutive stages often rank an UNCHANGED
  // sequence (a stage that collapses nothing leaves the genome intact),
  // and the 32-char base ranks are k-independent for every k >= 16.
  // Keyed by a content checksum, so validity is self-verifying; on every
  // hit a random sample of the stored order is re-verified against the
  // packed words (see cache_spot_verify) so a checksum collision cannot
  // silently corrupt ranks.
  HVec<uint32_t> c_rank, c_order;
  HVec<uint8_t> c_gflag;
  uint64_t c_sum = 0;
  int64_t c_n = -1;
  bool c_valid = false;
  // final-level cache: at k > 32 the block-mix fold/resolve dominate
  // repeat enumerations of an UNCHANGED sequence at the SAME k (the
  // block-generation pass always re-ranks at the last stage's k).
  // Snapshot the refined (rank, order, gflag) keyed by (checksum, k);
  // a hit is spot-verified against the packed words like the 32-level
  // cache (k-aware: extra group starts within equal-32-key runs are
  // legal).
  HVec<uint32_t> f_rank, f_order;
  HVec<uint8_t> f_gflag;
  uint64_t f_sum = 0;
  int64_t f_n = -1, f_k = -1;
  bool f_valid = false;
};
RankArena& rank_arena() {
  static RankArena a;
  return a;
}

// Drop every spilled arena's residency (end-of-call; keeps inter-stage
// RSS at the page-cache level instead of the arena level).
void rank_arena_drop_all() {
  if (!spill_on()) return;
  RankArena& a = rank_arena();
  a.next_sep.drop();
  a.rank.drop();
  a.order.drop();
  a.p.drop();
  a.shifted.drop();
  a.big.drop();
  a.gflag.drop();
  for (int s = 0; s < 3; ++s) a.hk[s].drop();
  a.c_rank.drop();
  a.c_order.drop();
  a.c_gflag.drop();
  a.cursor.drop();
  SortArena& sa = sort_arena();
  for (int s = 0; s < 2; ++s) {
    sa.k[s].drop();
    sa.i[s].drop();
    sa.i64[s].drop();
  }
}
std::mutex& rank_mutex() {
  static std::mutex m;
  return m;
}

// ---------------------------------------------------------------------------
// LCP-based group refinement (k > 32) — replaces chunked prefix doubling.
//
// After the initial 32-char ranking, every multi-member rank group is
// resolved to full-k lexicographic order with ONE suffix comparison per
// non-first member (vs. log2(k/32) full passes of doubling).  On collapsed
// genomes (the stage-2+ state of the pipeline) nearly every position sits
// in a twin group whose pair offset is one of a handful of strain-to-strain
// alignment offsets, so the comparisons batch by offset: offsets with many
// queries get an O(n/16) word-equality horizon (one xor per 16 chars, a
// backward scan, then O(1) per query); rare offsets compare packed words
// directly with early exit at k.
//
// Chars are compared through the packed sliding words ar.p (16 chars per
// word, built by the pack phase), in which '#'(0) aliases 'T' ((c-1)&3).
// This is safe: members of one initial group that are VALID (window
// crossing no separator) never contain '#' inside their k-window, so
// valid-vs-valid comparisons are exact.  INVALID members (sentinel-key
// positions, plus valid all-T windows that collide with the sentinel
// key) are excluded from refinement entirely: they keep the group's base
// rank and thus sort first within the group, while valid classes are
// ranked after them (base + #invalid + class offset).  The backend
// contract is therefore GROUPING of valid positions (equal final rank
// <=> identical k-window) plus the valid-filtered sorted ORDER — NOT
// exact rank values: a group that mixes valid and invalid members gets
// rank values shifted relative to the numpy doubling twin (which splits
// the sentinel group by rank chains).  The enumeration filters invalid
// members out of every group, so pipeline output is identical either
// way.  See tests/test_ranking_backends.py and
// tests/test_enumeration.py::_assert_valid_parity.
// ---------------------------------------------------------------------------

bool lcp_refine_enabled() {
  static int e = [] {
    const char* v = std::getenv("SIBELIA_TPU_LCP_REFINE");
    return (v && v[0] == '0') ? 0 : 1;
  }();
  return e != 0;
}

// ---------------------------------------------------------------------------
// Block-mix refinement (k > 32) — the default k>32 backend.
//
// The initial radix sort yields EXACT dense ranks of every 32-window
// (bucket-start representatives).  A k-window is the concatenation of
// overlapping 32-windows, so k-window equality is exactly equality of the
// covering 32-rank tuple — no string hashing is ever done.  The tuple is
// folded with a sparse-table scheme: H_L(i) summarizes the ranks covering
// [i, i+L); H_{2L}(i) = combine(H_L(i), H_L(i+L)); the final overlapped
// combine H_k(i) = combine(H_L(i), H_L(i + k - L)) covers the k-window in
// ceil(log2(k/32)) + 1 elementwise passes.  Equal k-windows therefore get
// equal 128-bit signatures deterministically; distinct k-windows collide
// with probability < 2^-75 per run at the 1 GB input cap (two independent
// 64-bit mixes).  Group members with equal signatures form a class
// without any per-member suffix walk — the win over the LCP backend,
// whose per-member queries walk the full k on collapsed genomes where
// nearly every window has full-length twins.  Class ORDER (lexicographic)
// is computed exactly: one bounded lcp_direct walk per class
// representative pair, which early-exits at the true divergence point.
// Contract and invalid-member policy are identical to the LCP backend
// (see above).  SIBELIA_TPU_BLOCKMIX=0 falls back to the LCP backend.
// ---------------------------------------------------------------------------

bool blockmix_enabled() {
  static int e = [] {
    const char* v = std::getenv("SIBELIA_TPU_BLOCKMIX");
    return (v && v[0] == '0') ? 0 : 1;
  }();
  return e != 0;
}

static inline uint64_t mixA(uint64_t a, uint64_t b) {
  // combine two 64-bit signatures; multiplies + xor-shift finalizer
  uint64_t x = a * 0x9E3779B97F4A7C15ULL + b * 0xC2B2AE3D27D4EB4FULL
               + 0x165667B19E3779F9ULL;
  x ^= x >> 29; x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 32;
  return x;
}

static inline uint64_t mixB(uint64_t a, uint64_t b) {
  uint64_t x = a * 0xFF51AFD7ED558CCDULL + b * 0x2545F4914F6CDD1DULL
               + 0x9E3779B97F4A7C15ULL;
  x ^= x >> 30; x *= 0x94D049BB133111EBULL;
  x ^= x >> 31;
  return x;
}

// First differing char index inside a 32-bit packed word pair (earlier
// chars occupy higher bits).
static inline int64_t first_diff_char32(uint32_t x) {
  return (int64_t)(__builtin_clz(x) >> 1);
}

// Match length of suffixes p,q via direct packed-word compare: chars
// [l0, cap) are scanned 16 at a time; [0, l0) is known equal.  words_end
// is the element count of pp (n + pad): the scan is explicitly bounded so
// it can never read past the buffer regardless of pad/zero-fill policy.
// If the buffer is exhausted without a mismatch, the suffixes are equal
// to the horizon and full match (cap) is reported — positions that deep
// are invalid windows whose exact refinement is out of contract anyway.
static inline int64_t lcp_direct(const uint32_t* pp, int64_t p, int64_t q,
                                 int64_t l0, int64_t cap,
                                 int64_t words_end) {
  int64_t hi = p > q ? p : q;
  int64_t scan_cap = cap < words_end - hi ? cap : words_end - hi;
  int64_t l = l0;
  while (l < scan_cap) {
    uint32_t x = pp[p + l] ^ pp[q + l];
    if (x) {
      int64_t len = l + first_diff_char32(x);
      return len < cap ? len : cap;
    }
    l += 16;
  }
  return cap;
}

struct LcpRefineCtx {
  const uint8_t* codes;
  const uint32_t* pp;
  const uint32_t* next_sep;
  int64_t n, k, pad;
  int64_t char_at(int64_t i) const { return i < n ? (int64_t)codes[i] : 0; }
  // window validity as the enumeration defines it: crosses no separator
  // nor the end of the string ('#' and padding count as separators)
  bool window_valid(int64_t p) const { return p + k <= next_sep[p]; }
};

// Order-and-split of one group's members (positions ascending, all known
// equal over [0, l0)) into full-k equality classes in lexicographic
// order.  lcp_of(j) gives match length of members[j] vs members[0] for
// the top-level call (batched answers); recursion recomputes directly.
// Appends (class_size) splits by writing ranks: members of the c-th class
// get rank = group_rank_base + (index of class start in final order).
struct GroupResolver {
  const LcpRefineCtx& ctx;
  uint32_t* rank;
  std::unordered_map<int64_t, size_t> bucket_of;  // (L*8+ch) -> bucket idx

  explicit GroupResolver(const LcpRefineCtx& c, uint32_t* r)
      : ctx(c), rank(r) {}

  // members: positions ascending; lv[j] = match length vs members[0]
  // (lv[0] unused), capped at k.  base_rank = bucket-start rank of the
  // whole set; writes final ranks.  Returns nothing.
  void resolve(std::vector<int64_t>& members, std::vector<int64_t>& lv,
               int64_t base_rank, int64_t l0) {
    size_t g = members.size();
    int64_t m0 = members[0];
    // order buckets: the m0-class (lcp >= k) plus one bucket per distinct
    // (L, divergence char); bucket order = lexicographic path order
    struct Bucket {
      int64_t L;       // divergence depth vs m0 (== k for the m0 class)
      int64_t ch;      // member char at depth L (unused for m0 class)
      std::vector<int64_t> mem;
    };
    std::vector<Bucket> buckets;
    buckets.push_back(Bucket{ctx.k, -1, {m0}});
    for (size_t j = 1; j < g; ++j) {
      int64_t L = lv[j];
      if (L >= ctx.k) {
        buckets[0].mem.push_back(members[j]);
        continue;
      }
      int64_t ch = ctx.char_at(members[j] + L);
      // O(1) bucket lookup keyed by (L, ch) — a linear scan over buckets
      // is near-quadratic for wide groups (many distinct divergences)
      auto it = bucket_of.find(L * 8 + ch);
      if (it != bucket_of.end()) {
        buckets[it->second].mem.push_back(members[j]);
      } else {
        bucket_of.emplace(L * 8 + ch, buckets.size());
        buckets.push_back(Bucket{L, ch, {members[j]}});
      }
    }
    bucket_of.clear();
    // sort buckets lexicographically: compare along the m0 path — at
    // depth min(L1, L2) the deeper bucket carries m0's char
    std::stable_sort(buckets.begin(), buckets.end(),
                     [&](const Bucket& x, const Bucket& y) {
                       int64_t L = x.L < y.L ? x.L : y.L;
                       int64_t cx = (x.L > L) ? ctx.char_at(m0 + L) : x.ch;
                       int64_t cy = (y.L > L) ? ctx.char_at(m0 + L) : y.ch;
                       return cx < cy;
                     });
    int64_t off = 0;
    for (auto& b : buckets) {
      if (b.mem.size() == 1 || b.L >= ctx.k) {
        // singleton, or the m0 class (all full-k equal): one class
        for (int64_t m : b.mem) rank[m] = (uint32_t)(base_rank + off);
        off += (int64_t)b.mem.size();
      } else {
        // same divergence char: equal over [0, b.L + 1); recurse with
        // direct comparisons (rare — repeats branching identically)
        std::vector<int64_t> sub_lv(b.mem.size(), 0);
        int64_t s0 = b.mem[0];
        for (size_t j = 1; j < b.mem.size(); ++j)
          sub_lv[j] = lcp_direct(ctx.pp, s0, b.mem[j], b.L + 1, ctx.k,
                                 ctx.n + ctx.pad);
        int64_t sz = (int64_t)b.mem.size();
        resolve(b.mem, sub_lv, base_rank + off, b.L + 1);
        off += sz;
      }
    }
  }
};
// Build (or reuse) the window-validity bitmap for the current call:
// bit p == the k-window at p crosses no separator (p + k <= next_sep[p]).
// n/8 bytes — LLC-resident at pipeline sizes, so random validity probes
// in the resolve and group-scan loops cost ~nothing vs a 4 B next_sep
// gather per row.  ar.vbits_k tracks which k it holds; compute_ranks
// resets it, so a bitmap can never leak across calls with a different
// next_sep.
void build_validity_bits(RankArena& ar, int64_t n, int64_t k) {
  if (ar.vbits_k == k) return;
  int64_t nw = (n + 63) >> 6;
  if ((int64_t)ar.vbits.size() < nw) ar.vbits.resize((size_t)nw);
  uint64_t* vb = ar.vbits.data();
  const uint32_t* nsp = ar.next_sep.data();
  parallel_for(nw, [&](int64_t lo2, int64_t hi2) {
    for (int64_t w2 = lo2; w2 < hi2; ++w2) {
      uint64_t bits = 0;
      int64_t base2 = w2 << 6;
      int64_t end2 = std::min<int64_t>(n, base2 + 64);
      for (int64_t p2 = base2; p2 < end2; ++p2)
        if (p2 + k <= (int64_t)nsp[p2]) bits |= 1ULL << (p2 - base2);
      vb[(size_t)w2] = bits;
    }
  });
  ar.vbits_k = k;
}

void compute_ranks(const uint8_t* codes, int64_t n, int64_t k,
                   RankArena& ar) {
  ar.vbits_k = -1;  // next_sep about to be rebuilt for this call
  int64_t m = k < 32 ? k : 32;
  int64_t b = 1;
  while (b * 2 <= m && b < 16) b *= 2;
  int64_t off = m - b;
  const int64_t pad = 40;
  if (n + pad >= (int64_t)UINT32_MAX) {
    // u32 positions cover every input under the reference's 1 GB cap
    // (supergenome < 2^32); the Python layer enforces the cap before
    // reaching here (cli/sibelia.py input guard)
    std::fprintf(stderr,
                 "sibelia_tpu: supergenome exceeds the u32 position space "
                 "(input beyond the 1 GB cap)\n");
    std::abort();
  }

  // content checksum (position-sensitive, commutative => parallel)
  uint64_t csum = 0;
  {
    unsigned hw = std::thread::hardware_concurrency();
    int T = (n >= (1 << 19) && hw > 1) ? (int)std::min<unsigned>(hw, 8) : 1;
    std::vector<uint64_t> part((size_t)T, 0);
    auto wk = [&](int t) {
      int64_t lo = n * t / T, hi = n * (t + 1) / T;
      uint64_t acc = 0;
      for (int64_t i = lo; i < hi; ++i)
        acc += mixA(((uint64_t)codes[i] << 40) | (uint64_t)i, 0);
      part[(size_t)t] = acc;
    };
    if (T == 1) {
      wk(0);
    } else {
      std::vector<std::thread> th;
      for (int t = 0; t < T; ++t) th.emplace_back(wk, t);
      for (auto& x : th) x.join();
    }
    for (int t = 0; t < T; ++t) csum += part[(size_t)t];
  }
  bool cache_hit = (k > 32 && b == 16 && blockmix_enabled() && ar.c_valid
                    && ar.c_n == n && ar.c_sum == csum
                    && n < kReleaseThreshold);
  bool cache_store = (k > 32 && b == 16 && blockmix_enabled()
                      && !cache_hit && n < kReleaseThreshold);
  // The final-level cache only ever pays off when the SAME (sequence, k)
  // is enumerated twice in one process — the `-g` serialize flow, which
  // rebuilds the index at lastk right after block generation
  // (cli/sibelia.py sets SIBELIA_TPU_FCACHE=1 there).  Everywhere else
  // the store is pure cost: ~0.6 GB of arena acquisition (~5.5 s/GB on
  // this kernel, see HVec) plus a 3-array copy per k>32 enumeration.
  static const bool fcache_on = [] {
    const char* v = std::getenv("SIBELIA_TPU_FCACHE");
    return v && v[0] == '1';
  }();
  bool fcache_hit = (fcache_on && k > 32 && b == 16 && blockmix_enabled()
                     && ar.f_valid && ar.f_n == n && ar.f_k == k
                     && ar.f_sum == csum && n < kReleaseThreshold);
  bool fcache_store = (fcache_on && k > 32 && b == 16 && blockmix_enabled()
                       && !fcache_hit && n < kReleaseThreshold);

  // next separator at or after i (padding positions count as separators,
  // as in the numpy twin's zero padding)
  if ((int64_t)ar.next_sep.size() < n + pad) ar.next_sep.resize(n + pad);
  {
    int64_t ns = n + pad;
    for (int64_t w = n + pad; w > 0; w -= kSpillWindow) {
      int64_t wl = std::max<int64_t>(0, w - kSpillWindow);
      for (int64_t i = w - 1; i >= wl; --i) {
        uint8_t c = (i < n) ? codes[i] : 0;
        if (c == 0) ns = std::min(ns, i);
        ar.next_sep[(size_t)i] = (uint32_t)ns;
      }
      ar.next_sep.drop_range((size_t)wl, (size_t)w);
    }
  }

  if ((int64_t)ar.p.size() < n + pad) ar.p.resize(n + pad);
  if ((int64_t)ar.shifted.size() < n + pad) ar.shifted.resize(n + pad);
  uint32_t* pp = ar.p.data();
  uint32_t* sh = ar.shifted.data();
  {
    Prof _p_pack("pack");
    auto hv_of = [&](uint32_t* q) {
      return q == ar.p.data() ? &ar.p : &ar.shifted;
    };
    parallel_for(n + pad, [&](int64_t lo, int64_t hi) {
      for (int64_t w = lo; w < hi; w += kSpillWindow) {
        int64_t we = std::min(hi, w + kSpillWindow);
        for (int64_t i = w; i < we; ++i) {
          uint32_t c = (i < n) ? codes[i] : 0;
          pp[i] = (c - 1) & 3;
        }
        hv_of(pp)->drop_range((size_t)w, (size_t)we);
      }
    });
    int64_t width = 1;
    while (width < b) {
      parallel_for(n + pad, [&](int64_t lo, int64_t hi) {
        for (int64_t w = lo; w < hi; w += kSpillWindow) {
          int64_t we = std::min(hi, w + kSpillWindow);
          for (int64_t i = w; i < we; ++i) {
            uint32_t x = (i + width < n + pad) ? pp[i + width] : 0;
            sh[i] = (pp[i] << (2 * width)) | x;
          }
          hv_of(pp)->drop_range((size_t)w, (size_t)we);
          hv_of(sh)->drop_range((size_t)w, (size_t)we);
        }
      });
      std::swap(pp, sh);
      width *= 2;
    }
  }
  // keep the final packed words in ar.p and drop the ping-pong partner:
  // every later consumer reads through `pp`
  if (pp != ar.p.data()) {
    parallel_for(n + pad, [&](int64_t lo, int64_t hi) {
      for (int64_t w = lo; w < hi; w += kSpillWindow) {
        int64_t we = std::min(hi, w + kSpillWindow);
        std::memcpy(ar.p.data() + w, pp + w,
                    (size_t)(we - w) * sizeof(uint32_t));
        ar.p.drop_range((size_t)w, (size_t)we);
      }
    });
    pp = ar.p.data();
  }
  // keep the ping-pong partner mapped below the release threshold: on
  // this kernel, munmapped pages are reclaimed host-side and the next
  // enumeration's refault pays ~20 us/page (~2 s per stage measured);
  // retaining the arena makes the refill free
  if (n + pad >= kReleaseThreshold) ar.shifted.release();

  if ((int64_t)ar.order.size() < n) ar.order.resize(n);
  if ((int64_t)ar.rank.size() < n) ar.rank.resize(n);
  if ((int64_t)ar.gflag.size() < n) ar.gflag.resize(n);
  uint32_t* order = ar.order.data();
  uint32_t* rank = ar.rank.data();
  uint8_t* gflag = ar.gflag.data();
  if (fcache_hit) {
    // spot-verify the stored FINAL order against the packed words:
    // sampled adjacent sorted slots must be 32-key-ordered, and a
    // 32-key difference must carry a group start (equal 32-keys may
    // legally split deeper, so gflag=1 there is fine)
    const uint32_t* f_ord = ar.f_order.data();
    const uint8_t* f_gf = ar.f_gflag.data();
    const uint32_t* nsp = ar.next_sep.data();
    auto key_at = [&](int64_t p) -> uint64_t {
      bool valid = (p + m) <= (int64_t)nsp[p];
      return valid ? (((uint64_t)pp[p] << 32) | pp[off + p])
                   : 0xFFFFFFFFFFFFFFFFULL;
    };
    uint64_t sdd = ar.f_sum | 1;
    for (int t = 0; t < 64 && fcache_hit; ++t) {
      sdd = sdd * 6364136223846793005ULL + 1442695040888963407ULL;
      int64_t j = (int64_t)(sdd % (uint64_t)n);
      if (j == 0) continue;
      uint64_t ka = key_at((int64_t)f_ord[j - 1]);
      uint64_t kb = key_at((int64_t)f_ord[j]);
      if (ka > kb || (ka != kb && f_gf[j] != 1)) fcache_hit = false;
    }
    if (fcache_hit) {
      Prof _p("rank_full_cache_hit");
      parallel_for(n, [&](int64_t lo, int64_t hi) {
        std::memcpy(rank + lo, ar.f_rank.data() + lo,
                    (size_t)(hi - lo) * sizeof(uint32_t));
        std::memcpy(order + lo, ar.f_order.data() + lo,
                    (size_t)(hi - lo) * sizeof(uint32_t));
        std::memcpy(gflag + lo, ar.f_gflag.data() + lo,
                    (size_t)(hi - lo));
      });
      return;
    }
    std::fprintf(stderr,
                 "sibelia_tpu: full-rank cache checksum collision "
                 "detected; recomputing\n");
    ar.f_valid = false;
    fcache_store = true;
  }
  if (cache_hit) {
    // spot-verify the stored order against the packed words before
    // trusting the checksum: 64 random sorted slots must be key-ordered
    // and gflag-consistent with their predecessor (a checksum collision
    // would have to survive this to corrupt ranks)
    const uint32_t* c_ord = ar.c_order.data();
    const uint8_t* c_gf = ar.c_gflag.data();
    const uint32_t* nsp = ar.next_sep.data();
    auto key_at = [&](int64_t p) -> uint64_t {
      bool valid = (p + m) <= (int64_t)nsp[p];
      return valid ? (((uint64_t)pp[p] << 32) | pp[off + p])
                   : 0xFFFFFFFFFFFFFFFFULL;
    };
    uint64_t s = ar.c_sum | 1;
    for (int t = 0; t < 64 && cache_hit; ++t) {
      s = s * 6364136223846793005ULL + 1442695040888963407ULL;
      int64_t j = (int64_t)(s % (uint64_t)n);
      if (j == 0) continue;
      uint64_t ka = key_at((int64_t)c_ord[j - 1]);
      uint64_t kb = key_at((int64_t)c_ord[j]);
      if (ka > kb || (c_gf[j] != (ka != kb ? 1 : 0))) cache_hit = false;
    }
    if (!cache_hit) {
      std::fprintf(stderr,
                   "sibelia_tpu: rank cache checksum collision detected; "
                   "recomputing\n");
      ar.c_valid = false;
      cache_store = (k > 32 && b == 16 && blockmix_enabled()
                     && n < kReleaseThreshold);
    }
  }
  if (cache_hit) {
    Prof _p("rank32_cache_hit");
    parallel_for(n, [&](int64_t lo, int64_t hi) {
      std::memcpy(rank + lo, ar.c_rank.data() + lo,
                  (size_t)(hi - lo) * sizeof(uint32_t));
      std::memcpy(order + lo, ar.c_order.data() + lo,
                  (size_t)(hi - lo) * sizeof(uint32_t));
      std::memcpy(gflag + lo, ar.c_gflag.data() + lo, (size_t)(hi - lo));
    });
  } else {
  if ((int64_t)ar.big.size() < n) ar.big.resize(n);
  uint64_t* big = ar.big.data();
  const uint32_t* nsep = ar.next_sep.data();
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t w = lo; w < hi; w += kSpillWindow) {
      int64_t we = std::min(hi, w + kSpillWindow);
      for (int64_t i = w; i < we; ++i) {
        bool valid = (i + m) <= nsep[i];
        big[i] = valid ? (((uint64_t)pp[i] << 32) | pp[off + i])
                       : 0xFFFFFFFFFFFFFFFFULL;
      }
      ar.big.drop_range((size_t)w, (size_t)we);
      ar.p.drop_range((size_t)w, (size_t)we);
      ar.next_sep.drop_range((size_t)w, (size_t)we);
    }
  });
  {
    Prof _p("radix_sort_initial");
    // big is overwritten with the sorted keys: the rank/flag passes then
    // walk it sequentially instead of gathering big[order[i]]
    radix_argsort_u64_sk(big, order, n, [&](int64_t lo, int64_t hi) {
      ar.big.drop_range((size_t)lo, (size_t)hi);
      ar.order.drop_range((size_t)lo, (size_t)hi);
    });
  }

  {
    Prof _p("rank_assign");
    // group-start flags + bucket-start ranks in two parallel passes: each
    // chunk records its last group start, a tiny serial pass turns those
    // into carry-ins, then the rank scatter runs per chunk (order is a
    // permutation, so slices never write the same rank slot).
    unsigned hw = std::thread::hardware_concurrency();
    int T = (n >= (1 << 19) && hw > 1) ? (int)std::min<unsigned>(hw, 8) : 1;
    std::vector<int64_t> last_start((size_t)T, -1);
    auto phase1 = [&](int t) {
      int64_t lo = n * t / T, hi = n * (t + 1) / T;
      int64_t ls = -1;
      for (int64_t w = lo; w < hi; w += kSpillWindow) {
        int64_t we = std::min(hi, w + kSpillWindow);
        for (int64_t i = w; i < we; ++i) {
          bool ng = (i == 0) || (big[i] != big[i - 1]);
          gflag[i] = ng;
          if (ng) ls = i;
        }
        ar.gflag.drop_range((size_t)w, (size_t)we);
        ar.big.drop_range((size_t)w, (size_t)we);  // phase 2 refaults
      }
      last_start[(size_t)t] = ls;
    };
    auto run_all = [&](auto& fn) {
      if (T == 1) {
        fn(0);
      } else {
        std::vector<std::thread> th;
        for (int t = 0; t < T; ++t) th.emplace_back(fn, t);
        for (auto& x : th) x.join();
      }
    };
    run_all(phase1);
    std::vector<int64_t> carry((size_t)T, 0);
    {
      int64_t c = 0;
      for (int t = 0; t < T; ++t) {
        carry[(size_t)t] = c;
        if (last_start[(size_t)t] >= 0) c = last_start[(size_t)t];
      }
    }
    auto phase2 = [&](int t) {
      int64_t lo = n * t / T, hi = n * (t + 1) / T;
      int64_t start = carry[(size_t)t];
      int64_t chunk = ar.rank.spilled ? kSpillQuantum : (hi - lo + 1);
      for (int64_t cs = lo; cs < hi; cs += chunk) {
        int64_t ce = std::min(hi, cs + chunk);
        for (int64_t i = cs; i < ce; ++i) {
          if (i + 32 < ce) __builtin_prefetch(&rank[order[i + 32]], 1);
          if (gflag[i]) start = i;
          rank[order[i]] = (uint32_t)start;
        }
        // sequential inputs dropped behind; the random rank writes
        // necessarily keep ~the whole rank array resident for this
        // phase (4 B/pos — within budget), so no in-phase whole-array
        // drops: they only add refault + TLB-shootdown cost
        ar.big.drop_range((size_t)cs, (size_t)ce);
        ar.order.drop_range((size_t)cs, (size_t)ce);
        ar.gflag.drop_range((size_t)cs, (size_t)ce);
      }
    };
    run_all(phase2);
  }

  if (cache_store) {
    // snapshot the pristine 32-level result before any k>32 refinement
    // rewrites rank/order/gflag in place
    if ((int64_t)ar.c_rank.size() < n) ar.c_rank.resize((size_t)n);
    if ((int64_t)ar.c_order.size() < n) ar.c_order.resize((size_t)n);
    if ((int64_t)ar.c_gflag.size() < n) ar.c_gflag.resize((size_t)n);
    parallel_for(n, [&](int64_t lo, int64_t hi) {
      std::memcpy(ar.c_rank.data() + lo, rank + lo,
                  (size_t)(hi - lo) * sizeof(uint32_t));
      std::memcpy(ar.c_order.data() + lo, order + lo,
                  (size_t)(hi - lo) * sizeof(uint32_t));
      std::memcpy(ar.c_gflag.data() + lo, gflag + lo, (size_t)(hi - lo));
    });
    ar.c_sum = csum;
    ar.c_n = n;
    ar.c_valid = true;
  }
  }  // cache-hit else

  if (n >= kReleaseThreshold) {
    // sorted keys and radix scratch are dead from here on
    ar.big.release();
    sort_arena_release();
  }

  if (k <= 32) return;

  if (blockmix_enabled()) {
    LcpRefineCtx ctx{codes, pp, ar.next_sep.data(), n, k, pad};
    // 1) fold the covering 32-rank tuple into 128-bit signatures
    int64_t ext = n + k + 64;
    // In-RAM: tiled fold.  Each tile computes ALL doubling levels for a
    // C-sized output window inside an (C + k)-entry scratch that stays
    // cache-resident, reading rank[] once and writing the interleaved
    // signatures once — 20 B/row of DRAM traffic total, vs
    // 2 lanes x (log2(k/32)+1) full read+write passes (hundreds of
    // B/row at k=5000) for the streaming fold.  Adjacent tiles re-read
    // a k-entry halo of rank ((C+k)/C ~ 1.08x duplication).  Values are
    // bit-identical to the streaming fold: every read chain stays below
    // ext (te + k <= ext - 64), so the j-clamp never fires for output
    // rows, exactly as it never fires for them in the streaming form.
    // Spill mode keeps the streaming fold (windows drop as they go).
    const bool tiled_fold = !spill_on() && n < kReleaseThreshold;
    if (!tiled_fold)
      for (int s = 0; s < 3; ++s)
        if ((int64_t)ar.hk[s].size() < ext) ar.hk[s].resize((size_t)ext);
    uint64_t* ha = tiled_fold ? nullptr : ar.hk[0].data();
    uint64_t* hb = tiled_fold ? nullptr : ar.hk[1].data();
    uint64_t* sc = tiled_fold ? nullptr : ar.hk[2].data();
    if (tiled_fold) {
      Prof _p("blockmix_fold");
      {
        Prof _p2("fold_hab_alloc");
        if ((int64_t)ar.hab.size() < 2 * n) ar.hab.resize((size_t)(2 * n));
      }
      uint64_t* hab = ar.hab.data();
      const uint32_t* rk = rank;
      const int64_t C = (int64_t)1 << 16;
      int64_t ntiles = (n + C - 1) / C;
      Prof _p3("fold_tiles");
      parallel_for(ntiles, [&](int64_t tlo, int64_t thi) {
        std::vector<uint64_t> a0, a1, b0, b1;
        for (int64_t tt = tlo; tt < thi; ++tt) {
          int64_t t = tt * C;
          int64_t te = std::min(n, t + C);
          int64_t span = std::min(ext, t + C + k) - t;
          if ((int64_t)a0.size() < span) {
            a0.resize((size_t)span);
            a1.resize((size_t)span);
            b0.resize((size_t)span);
            b1.resize((size_t)span);
          }
          for (int64_t ii = 0; ii < span; ++ii) {
            int64_t gi = t + ii;
            uint64_t r = (gi < n) ? (uint64_t)rk[gi]
                                  : 0xFFFFFFFFFFFFFFFFULL;
            a0[(size_t)ii] = mixA(r, 0);
            b0[(size_t)ii] = mixB(r, 0);
          }
          uint64_t* pa = a0.data();
          uint64_t* qa = a1.data();
          uint64_t* pb = b0.data();
          uint64_t* qb = b1.data();
          int64_t L = 32, sp = span;
          while (L * 2 <= k) {
            int64_t ns2 = sp - L;
            for (int64_t ii = 0; ii < ns2; ++ii)
              qa[ii] = mixA(pa[ii], pa[ii + L]);
            for (int64_t ii = 0; ii < ns2; ++ii)
              qb[ii] = mixB(pb[ii], pb[ii + L]);
            std::swap(pa, qa);
            std::swap(pb, qb);
            sp = ns2;
            L *= 2;
          }
          int64_t off3 = k - L;
          for (int64_t ii = 0; ii < te - t; ++ii) {
            hab[2 * (t + ii)] = mixA(pa[ii], pa[ii + off3]);
            hab[2 * (t + ii) + 1] = mixB(pb[ii], pb[ii + off3]);
          }
        }
      });
    } else {
      Prof _p("blockmix_fold");
      auto hk_of = [&](uint64_t* q) {
        for (int s = 0; s < 3; ++s)
          if (q == ar.hk[s].data()) return &ar.hk[s];
        return (HVec<uint64_t>*)nullptr;
      };
      parallel_for(ext, [&](int64_t lo, int64_t hi) {
        for (int64_t w = lo; w < hi; w += kSpillWindow) {
          int64_t we = std::min(hi, w + kSpillWindow);
          for (int64_t i = w; i < we; ++i) {
            uint64_t r = (i < n) ? (uint64_t)rank[i]
                                 : 0xFFFFFFFFFFFFFFFFULL;
            ha[i] = mixA(r, 0);
            hb[i] = mixB(r, 0);
          }
          hk_of(ha)->drop_range((size_t)w, (size_t)we);
          hk_of(hb)->drop_range((size_t)w, (size_t)we);
          ar.rank.drop_range((size_t)w, (size_t)we);
        }
      });
      auto fold_lane = [&](uint64_t*& lane, int64_t off3, int64_t lim,
                           bool lane_a) {
        parallel_for(lim, [&](int64_t lo, int64_t hi) {
          for (int64_t w = lo; w < hi; w += kSpillWindow) {
            int64_t we = std::min(hi, w + kSpillWindow);
            for (int64_t i = w; i < we; ++i) {
              int64_t j = i + off3 < ext ? i + off3 : ext - 1;
              sc[i] = lane_a ? mixA(lane[i], lane[j])
                             : mixB(lane[i], lane[j]);
            }
            hk_of(lane)->drop_range((size_t)w, (size_t)we);
            hk_of(sc)->drop_range((size_t)w, (size_t)we);
          }
        });
        std::swap(lane, sc);
      };
      int64_t L = 32;
      while (L * 2 <= k) {
        fold_lane(ha, L, ext, true);
        fold_lane(hb, L, ext, false);
        L *= 2;
      }
      // final overlapped combine: covers exactly k chars
      fold_lane(ha, k - L, n, true);
      fold_lane(hb, k - L, n, false);
    }
    // 2) per-bucket resolution: classes by signature, order by one
    // bounded suffix walk per class-representative pair
    {
      Prof _p("blockmix_resolve");
      unsigned hw = std::thread::hardware_concurrency();
      int T = (n >= (1 << 19) && hw > 1) ? (int)std::min<unsigned>(hw, 8)
                                         : 1;
      // Spill mode: the per-member (position -> ha/hb/valid) gathers are
      // random, so they would keep the full signature arrays resident no
      // matter how often windows are dropped.  Rows are therefore
      // processed in KEY RANGES [rlo, rhi) aligned to bucket starts: one
      // sequential pass over POSITIONS scatters each in-range position's
      // (ha, hb, valid) into row-aligned prep buffers
      // (row = rank[i] + cursor[rank[i]-rlo]++, position order
      // preserved because the stream ascends), and the bucket resolution
      // then reads signatures sequentially BY ROW.  The big arrays are
      // only ever streamed; the prep buffers are bounded by
      // SIBELIA_TPU_SPILL_BUDGET_MB (default 2048).  Resolved buckets
      // write final ranks strictly inside their own range (ranges are
      // bucket-aligned), so later ranges' streams never see them as
      // in-range keys.  In-RAM mode keeps the direct gathers (a single
      // range, no prep) — byte parity between the two is covered by
      // tests/test_spill.py.
      const bool use_prep = spill_on();
      // In-RAM mode pays the per-member signature/validity gathers as
      // demand misses in the bucket loop.  This box (and TPU-host VMs
      // generally) is gather-THROUGHPUT-bound (~50M random lines/s per
      // core, software prefetch measured neutral), so the win is fewer
      // random LINES per row, not deeper pipelining: the two 8 B
      // signature lanes are interleaved into one 16 B record (one line
      // instead of two, written by the fold's fused final combine) and
      // the 4 B next_sep probe is replaced by a 1-bit validity bitmap
      // (n/8 B — LLC-resident at pipeline sizes).  Same gate as the
      // fused combine above.
      const bool interleave = !use_prep && n < kReleaseThreshold;
      if (interleave) build_validity_bits(ar, n, k);
      const uint64_t* habp = interleave ? ar.hab.data() : nullptr;
      const uint64_t* vbp = interleave ? ar.vbits.data() : nullptr;
      int64_t range_rows = n;
      if (use_prep) {
        const char* e = std::getenv("SIBELIA_TPU_SPILL_BUDGET_MB");
        int64_t mb = 0;
        if (e && e[0]) {
          mb = std::strtoll(e, nullptr, 10);
        } else {
          // default: an eighth of MemAvailable (each range costs a full
          // sequential re-stream of rank+ha+hb+next_sep, so small
          // budgets multiply resolve wall-clock), clamped to [2, 8] GB
          int64_t avail_kb = 0;
          if (FILE* f = std::fopen("/proc/meminfo", "r")) {
            char line[256];
            while (std::fgets(line, sizeof(line), f)) {
              if (std::sscanf(line, "MemAvailable: %lld kB",
                              (long long*)&avail_kb) == 1)
                break;
            }
            std::fclose(f);
          }
          mb = avail_kb > 0 ? (avail_kb / 1024) / 8 : 2048;
          if (mb < 2048) mb = 2048;
          if (mb > 8192) mb = 8192;
        }
        range_rows = std::max<int64_t>((mb << 20) / 21, (int64_t)4096);
        if (range_rows > n) range_rows = n;
      }
      static HVec<uint64_t> prep_a, prep_b;
      static HVec<uint8_t> prep_v;
      static HVec<uint32_t> prep_cur;
      if (use_prep) {
        // the prep buffers ARE the in-RAM budget: anonymous memory
        // (random scatter into file-backed pages would churn writeback)
        prep_a.no_spill = prep_b.no_spill = true;
        prep_v.no_spill = prep_cur.no_spill = true;
      }
      int64_t rlo = 0;
      while (rlo < n) {
      int64_t rhi = rlo + range_rows < n ? rlo + range_rows : n;
      while (rhi < n && !gflag[rhi]) ++rhi;
      if (use_prep) {
        // size to the ACTUAL range: the boundary extension above can
        // push rhi past rlo + range_rows by a whole rank group, so the
        // buffers must be (re)sized after rhi is known (resize is
        // grow-only and contents are refilled per range)
        prep_a.resize((size_t)(rhi - rlo));
        prep_b.resize((size_t)(rhi - rlo));
        prep_v.resize((size_t)(rhi - rlo));
        prep_cur.resize((size_t)(rhi - rlo));
        std::memset(prep_cur.data(), 0,
                    (size_t)(rhi - rlo) * sizeof(uint32_t));
        // serial ascending stream keeps members in position order
        for (int64_t w = 0; w < n; w += kSpillWindow) {
          int64_t we = std::min(n, w + kSpillWindow);
          for (int64_t i2 = w; i2 < we; ++i2) {
            int64_t kk = (int64_t)rank[i2];
            if (kk < rlo || kk >= rhi) continue;
            int64_t row = kk + (int64_t)prep_cur[kk - rlo]++ - rlo;
            prep_a[(size_t)row] = ha[i2];
            prep_b[(size_t)row] = hb[i2];
            prep_v[(size_t)row] = (i2 + k) <= (int64_t)ar.next_sep[i2];
          }
          ar.rank.drop_range((size_t)w, (size_t)we);
          ar.next_sep.drop_range((size_t)w, (size_t)we);
          for (int s = 0; s < 3; ++s)
            ar.hk[s].drop_range((size_t)w, (size_t)we);
        }
      }
      std::vector<int64_t> b_i((size_t)T + 1);
      b_i[0] = rlo;
      b_i[(size_t)T] = rhi;
      for (int t = 1; t < T; ++t) {
        int64_t x = rlo + (rhi - rlo) * t / T;
        while (x < rhi && !gflag[x]) ++x;
        b_i[(size_t)t] = x;
      }
      for (int t = 1; t < T; ++t)
        if (b_i[(size_t)t] < b_i[(size_t)(t - 1)])
          b_i[(size_t)t] = b_i[(size_t)(t - 1)];
      // Each bucket's final layout — stable by (rank, position) — is
      // written DIRECTLY into order/gflag here: invalid members first
      // (they keep the base rank, position order), then classes in
      // lexicographic order with members in position order.  Buckets are
      // disjoint order[] spans, so chunks never race, and the global
      // counting scatter (the former final_order_sort pass, a random
      // 64M-slot write) is skipped entirely for this backend.
      auto HA = [&](int64_t row, int64_t p) {
        return use_prep ? prep_a[(size_t)(row - rlo)]
                        : (interleave ? habp[2 * p] : ha[p]);
      };
      auto HB = [&](int64_t row, int64_t p) {
        return use_prep ? prep_b[(size_t)(row - rlo)]
                        : (interleave ? habp[2 * p + 1] : hb[p]);
      };
      auto VAL = [&](int64_t row, int64_t p) {
        return use_prep
                   ? (prep_v[(size_t)(row - rlo)] != 0)
                   : (interleave ? ((vbp[p >> 6] >> (p & 63)) & 1) != 0
                                 : ctx.window_valid(p));
      };
      auto resolve_chunk = [&](int tid) {
        struct Mem { uint64_t a, b; int64_t pos; };
        std::vector<Mem> mem;
        std::vector<int64_t> inval;
        std::vector<int64_t> reps, rsz;  // class rep + class size
        // sampled signature-equality audit: every 256th hash-equal merge
        // is confirmed with one bounded suffix walk, converting a
        // (astronomically unlikely, < 2^-75/run) 128-bit collision from
        // silent rank corruption into a hard failure
        int64_t audit_tick = 0;
        auto audit_equal = [&](int64_t p, int64_t q) {
          if ((++audit_tick & 255) != 0) return;
          if (lcp_direct(ctx.pp, p, q, 32, k, n + pad) < k) {
            std::fprintf(stderr,
                         "sibelia_tpu: block-mix signature collision "
                         "detected (positions %lld, %lld); aborting\n",
                         (long long)p, (long long)q);
            std::abort();
          }
        };
        int64_t i = b_i[(size_t)tid], iend = b_i[(size_t)(tid + 1)];
        int64_t last_drop = i;
        while (i < iend) {
          // the rank writes below land at order[row] — random 4 B
          // scatters, one per row; prefetch ~96 rows ahead (each loop
          // iteration consumes >=1 row, twins consume 2)
          if (i + 97 < iend) {
            __builtin_prefetch(&rank[order[i + 96]], 1);
            __builtin_prefetch(&rank[order[i + 97]], 1);
          }
          if (i - last_drop >= kSpillQuantum) {
            // consumed order/gflag windows only; the randomly-probed
            // arrays are handled by the prep stream (spill mode) or
            // must stay resident (in-RAM), so whole-drops here would
            // just thrash
            ar.order.drop_range((size_t)last_drop, (size_t)i);
            ar.gflag.drop_range((size_t)last_drop, (size_t)i);
            last_drop = i;
          }
          int64_t j = i + 1;
          while (j < iend && !gflag[j]) ++j;
          int64_t g = j - i;
          if (g >= 2) {
            if (g == 2 && VAL(i, order[i]) && VAL(i + 1, order[i + 1])) {
              // twin fast path (the dominant case)
              int64_t m0 = order[i], m1 = order[i + 1];
              if (HA(i, m0) == HA(i + 1, m1) &&
                  HB(i, m0) == HB(i + 1, m1)) {
                audit_equal(m0, m1);
                rank[m0] = i;
                rank[m1] = i;
              } else {
                int64_t L = lcp_direct(ctx.pp, m0, m1, 32, k, n + pad);
                if (ctx.char_at(m0 + L) < ctx.char_at(m1 + L)) {
                  rank[m0] = i;
                  rank[m1] = i + 1;
                } else {
                  rank[m1] = i;
                  rank[m0] = i + 1;
                  order[i] = m1;
                  order[i + 1] = m0;
                }
                gflag[i + 1] = 1;
              }
            } else {
              mem.clear();
              inval.clear();
              for (int64_t t2 = i; t2 < j; ++t2) {
                int64_t p = order[t2];
                if (!VAL(t2, p)) {
                  inval.push_back(p);  // keeps base rank i (sorts first)
                  continue;
                }
                mem.push_back(Mem{HA(t2, p), HB(t2, p), p});
              }
              int64_t n_invalid = (int64_t)inval.size();
              // layout prefix: invalid members, position order (order[]
              // within a bucket is position order already)
              for (int64_t t2 = 0; t2 < n_invalid; ++t2) {
                order[i + t2] = inval[(size_t)t2];
                gflag[i + t2] = (t2 == 0);
              }
              int64_t slot = i + n_invalid;
              if ((int64_t)mem.size() >= 2) {
                // classes = runs of equal signatures; pos as tie key
                // keeps class members in position order (std::sort is
                // not stable)
                std::sort(mem.begin(), mem.end(),
                          [](const Mem& x, const Mem& y) {
                            if (x.a != y.a) return x.a < y.a;
                            if (x.b != y.b) return x.b < y.b;
                            return x.pos < y.pos;
                          });
                reps.clear();
                rsz.clear();
                for (size_t t2 = 0; t2 < mem.size(); ++t2) {
                  if (t2 == 0 || mem[t2].a != mem[t2 - 1].a ||
                      mem[t2].b != mem[t2 - 1].b) {
                    reps.push_back((int64_t)t2);
                    rsz.push_back(1);
                  } else {
                    audit_equal(mem[t2 - 1].pos, mem[t2].pos);
                    ++rsz.back();
                  }
                }
                if (reps.size() == 1) {
                  for (const Mem& m : mem) {
                    rank[m.pos] = i + n_invalid;
                    order[slot] = m.pos;
                    gflag[slot] = (slot == i + n_invalid);
                    ++slot;
                  }
                } else {
                  // order class reps lexicographically (exact):
                  // members of one bucket agree over the first 32 chars
                  std::vector<size_t> ord(reps.size());
                  for (size_t t2 = 0; t2 < ord.size(); ++t2) ord[t2] = t2;
                  std::sort(ord.begin(), ord.end(),
                            [&](size_t x, size_t y) {
                              int64_t p = mem[(size_t)reps[x]].pos;
                              int64_t q = mem[(size_t)reps[y]].pos;
                              int64_t L =
                                  lcp_direct(ctx.pp, p, q, 32, k, n + pad);
                              if (L >= k) return false;
                              return ctx.char_at(p + L) < ctx.char_at(q + L);
                            });
                  for (size_t oi = 0; oi < ord.size(); ++oi) {
                    size_t c = ord[oi];
                    int64_t base = slot;
                    int64_t first = reps[(size_t)c];
                    for (int64_t t2 = 0; t2 < rsz[(size_t)c]; ++t2) {
                      int64_t p = mem[(size_t)(first + t2)].pos;
                      rank[p] = base;
                      order[slot] = p;
                      gflag[slot] = (slot == base);
                      ++slot;
                    }
                  }
                }
              } else if (mem.size() == 1) {
                rank[mem[0].pos] = i + n_invalid;
                order[slot] = mem[0].pos;
                gflag[slot] = 1;
              }
            }
          }
          i = j;
        }
      };
      if (T == 1) {
        resolve_chunk(0);
      } else {
        std::vector<std::thread> th;
        for (int t = 0; t < T; ++t) th.emplace_back(resolve_chunk, t);
        for (auto& x : th) x.join();
      }
      rlo = rhi;
      }  // range loop
      if (use_prep) {
        prep_a.drop();
        prep_b.drop();
        prep_v.drop();
        prep_cur.drop();
        ar.rank.drop();
        for (int s = 0; s < 3; ++s) ar.hk[s].drop();
      }
    }
    if (fcache_store) {
      Prof _p("rank_full_cache_store");
      if ((int64_t)ar.f_rank.size() < n) ar.f_rank.resize((size_t)n);
      if ((int64_t)ar.f_order.size() < n) ar.f_order.resize((size_t)n);
      if ((int64_t)ar.f_gflag.size() < n) ar.f_gflag.resize((size_t)n);
      parallel_for(n, [&](int64_t lo, int64_t hi) {
        std::memcpy(ar.f_rank.data() + lo, rank + lo,
                    (size_t)(hi - lo) * sizeof(uint32_t));
        std::memcpy(ar.f_order.data() + lo, order + lo,
                    (size_t)(hi - lo) * sizeof(uint32_t));
        std::memcpy(ar.f_gflag.data() + lo, gflag + lo,
                    (size_t)(hi - lo));
      });
      ar.f_sum = csum;
      ar.f_n = n;
      ar.f_k = k;
      ar.f_valid = true;
    }
    return;  // order/gflag written in place; no final scatter needed
  } else if (lcp_refine_enabled()) {
    Prof _p_lcp("lcp_refine");
    const int64_t HORIZON_MIN = 512;  // queries per offset to amortize O(n/16)
    LcpRefineCtx ctx{codes, pp, ar.next_sep.data(), n, k, pad};
    // 1) collect one (first member, member) query per extra group member
    if ((int64_t)ar.qa.size() < n) ar.qa.resize(n);
    if ((int64_t)ar.qb.size() < n) ar.qb.resize(n);
    if ((int64_t)ar.ql.size() < n) ar.ql.resize(n);
    int64_t* qa = ar.qa.data();
    int64_t* qb = ar.qb.data();
    int32_t* ql = ar.ql.data();
    int64_t Q = 0;
    {
      int64_t i = 0;
      while (i < n) {
        int64_t j = i + 1;
        while (j < n && !gflag[j]) ++j;
        if (j - i >= 2) {
          int64_t m0 = order[i];
          for (int64_t t = i + 1; t < j; ++t) {
            qa[Q] = m0;
            qb[Q] = order[t];
            ++Q;
          }
        }
        i = j;
      }
    }
    // 2) answer queries, batched by offset d = qb - qa (members are in
    // ascending position order within a group, so d > 0)
    {
      std::vector<std::pair<int64_t, std::vector<int64_t>>> byd;
      {
        std::unordered_map<int64_t, int64_t> slot;
        for (int64_t qi = 0; qi < Q; ++qi) {
          int64_t d = qb[qi] - qa[qi];
          auto it = slot.find(d);
          if (it == slot.end()) {
            slot.emplace(d, (int64_t)byd.size());
            byd.emplace_back(d, std::vector<int64_t>{qi});
          } else {
            byd[(size_t)it->second].second.push_back(qi);
          }
        }
      }
      if ((int64_t)ar.wh.size() < (n + pad) / 16 + 2)
        ar.wh.resize((n + pad) / 16 + 2);
      unsigned hw = std::thread::hardware_concurrency();
      int T = (Q >= (1 << 18) && hw > 1 && byd.size() > 1)
                  ? (int)std::min<unsigned>(hw, 8)
                  : 1;
      if (T > (int)byd.size()) T = (int)byd.size();
      // second horizon buffer for the extra threads
      static std::vector<std::vector<int32_t>> wh_extra;
      if ((int)wh_extra.size() < T - 1) wh_extra.resize((size_t)(T - 1));
      auto answer_bucket = [&](int64_t d, const std::vector<int64_t>& qs,
                               int32_t* wh) {
        if ((int64_t)qs.size() < HORIZON_MIN) {
          for (int64_t qi : qs)
            ql[qi] = (int32_t)lcp_direct(pp, qa[qi], qb[qi], 0, k, n + pad);
          return;
        }
        // word-granular horizon: wh[w] = first grid word >= w whose
        // 16-char window differs from the window d chars ahead
        int64_t nw = (n + pad - 16 - d) / 16 + 1;
        if (nw < 0) nw = 0;
        int32_t nxt = (int32_t)nw;
        for (int64_t w = nw - 1; w >= 0; --w) {
          int64_t a = w * 16;
          if ((uint32_t)(pp[a] ^ pp[a + d])) nxt = (int32_t)w;
          wh[w] = nxt;
        }
        for (int64_t qi : qs) {
          int64_t p = qa[qi];
          int64_t len;
          uint32_t x0 = (uint32_t)(pp[p] ^ pp[p + d]);
          if (x0) {
            len = first_diff_char32(x0);
          } else {
            int64_t w = ((p & ~15LL) + 16) >> 4;
            if (w >= nw) {
              len = k;
            } else {
              int64_t w1 = wh[w];
              if (w1 >= nw) {
                len = k;
              } else {
                uint32_t x = (uint32_t)(pp[w1 * 16] ^ pp[w1 * 16 + d]);
                len = w1 * 16 + (x ? first_diff_char32(x) : 0) - p;
              }
            }
          }
          ql[qi] = (int32_t)(len < k ? len : k);
        }
      };
      if (T <= 1) {
        for (auto& e : byd) answer_bucket(e.first, e.second, ar.wh.data());
      } else {
        // static split of buckets by cumulative query count
        std::vector<std::vector<int64_t>> assign((size_t)T);
        std::vector<int64_t> load((size_t)T, 0);
        for (int64_t bi = 0; bi < (int64_t)byd.size(); ++bi) {
          int best = 0;
          for (int t = 1; t < T; ++t)
            if (load[(size_t)t] < load[(size_t)best]) best = t;
          assign[(size_t)best].push_back(bi);
          load[(size_t)best] += (int64_t)byd[(size_t)bi].second.size();
        }
        std::vector<std::thread> th;
        for (int t = 0; t < T; ++t) {
          th.emplace_back([&, t]() {
            int32_t* wh = ar.wh.data();
            if (t > 0) {
              auto& buf = wh_extra[(size_t)(t - 1)];
              if ((int64_t)buf.size() < (n + pad) / 16 + 2)
                buf.resize((size_t)((n + pad) / 16 + 2));
              wh = buf.data();
            }
            for (int64_t bi : assign[(size_t)t])
              answer_bucket(byd[(size_t)bi].first, byd[(size_t)bi].second,
                            wh);
          });
        }
        for (auto& x : th) x.join();
      }
    }
    // 3) per-group resolution: twin fast path inline, general groups via
    // the recursive bucket resolver; parallel over group-aligned chunks
    // (each group's ranks are written only from its own chunk)
    {
      unsigned hw = std::thread::hardware_concurrency();
      int T = (n >= (1 << 19) && hw > 1) ? (int)std::min<unsigned>(hw, 8) : 1;
      // chunk bounds on group starts, with each chunk's starting query
      // index recovered by counting members before it
      std::vector<int64_t> b_i((size_t)T + 1), b_q((size_t)T + 1);
      b_i[0] = 0;
      b_i[(size_t)T] = n;
      for (int t = 1; t < T; ++t) {
        int64_t x = n * t / T;
        while (x < n && !gflag[x]) ++x;
        b_i[(size_t)t] = x;
      }
      for (int t = 1; t < T; ++t)
        if (b_i[(size_t)t] < b_i[(size_t)(t - 1)])
          b_i[(size_t)t] = b_i[(size_t)(t - 1)];
      // query index at chunk start = (#non-first members of multi-groups
      // before it); count per chunk in parallel, then prefix
      std::vector<int64_t> qcnt((size_t)T, 0);
      {
        std::vector<std::thread> th;
        for (int t = 0; t < T; ++t) {
          th.emplace_back([&, t]() {
            int64_t i = b_i[(size_t)t], iend = b_i[(size_t)(t + 1)];
            int64_t c = 0;
            while (i < iend) {
              int64_t j = i + 1;
              while (j < iend && !gflag[j]) ++j;
              if (j - i >= 2) c += j - i - 1;
              i = j;
            }
            qcnt[(size_t)t] = c;
          });
        }
        for (auto& x : th) x.join();
      }
      b_q[0] = 0;
      for (int t = 0; t < T; ++t) b_q[(size_t)(t + 1)] = b_q[(size_t)t] + qcnt[(size_t)t];
      auto resolve_chunk = [&](int tid) {
        GroupResolver res(ctx, rank);
        std::vector<int64_t> members, lv;
        int64_t i = b_i[(size_t)tid], iend = b_i[(size_t)(tid + 1)];
        int64_t qi = b_q[(size_t)tid];
        while (i < iend) {
          int64_t j = i + 1;
          while (j < iend && !gflag[j]) ++j;
          int64_t g = j - i;
          if (g == 2 && ctx.window_valid(order[i]) &&
              ctx.window_valid(order[i + 1])) {
            // twin fast path (the dominant case)
            int64_t m0 = order[i], m1 = order[i + 1];
            int64_t L = ql[qi];
            ++qi;
            if (L >= k) {
              rank[m0] = i;
              rank[m1] = i;
            } else if (ctx.char_at(m0 + L) < ctx.char_at(m1 + L)) {
              rank[m0] = i;
              rank[m1] = i + 1;
            } else {
              rank[m1] = i;
              rank[m0] = i + 1;
            }
          } else if (g > 1) {
            // Invalid members (sentinel-key positions; includes the valid
            // all-T key collision's invalid cohabitants) are excluded from
            // refinement: they keep the base rank i (sorting first,
            // position-stable), and valid classes are ranked after the
            // invalid block so every rank bucket's members stay disjoint
            // (the final counting scatter requires it).  Their exact order
            // is out of contract — the enumeration filters them from every
            // group.  This also short-circuits the giant all-sentinel
            // group at contig boundaries, which used to be fully ordered
            // with full-k LCP queries for no semantic effect.
            members.clear();
            lv.clear();
            int64_t n_invalid = 0;
            int64_t m0 = order[i];
            bool m0_valid = ctx.window_valid(m0);
            if (!m0_valid) ++n_invalid;
            for (int64_t t2 = i + 1; t2 < j; ++t2) {
              int64_t mt = order[t2];
              int64_t L = (int64_t)ql[qi];
              ++qi;
              if (!ctx.window_valid(mt)) {
                ++n_invalid;
                continue;
              }
              if (members.empty() && !m0_valid) {
                members.push_back(mt);  // becomes the reference member
                lv.push_back(0);
              } else if (members.empty()) {
                members.push_back(m0);
                lv.push_back(0);
                members.push_back(mt);
                lv.push_back(L);
              } else if (m0_valid) {
                members.push_back(mt);
                lv.push_back(L);  // ql answers are vs m0 == members[0]
              } else {
                // reference member changed: recompute match length
                members.push_back(mt);
                lv.push_back(lcp_direct(ctx.pp, members[0], mt, 0, k,
                                        ctx.n + ctx.pad));
              }
            }
            if (m0_valid && members.empty()) {
              members.push_back(m0);
              lv.push_back(0);
            }
            if ((int64_t)members.size() >= 2)
              res.resolve(members, lv, i + n_invalid, 32);
            else if (members.size() == 1)
              rank[members[0]] = i + n_invalid;
            // invalid members keep rank i (set by the initial rank pass)
          }
          i = j;
        }
      };
      if (T == 1) {
        resolve_chunk(0);
      } else {
        std::vector<std::thread> th;
        for (int t = 0; t < T; ++t) th.emplace_back(resolve_chunk, t);
        for (auto& x : th) x.join();
      }
    }
  } else {
  // r with negative sentinels past the end (numpy tail -(arange(k+1)+2));
  // the doubling working arrays stay int64 (widen from the u32 arenas)
  if ((int64_t)ar.r.size() < n + k + 1) ar.r.resize(n + k + 1);
  int64_t* r = ar.r.data();
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) r[i] = (int64_t)rank[i];
  });
  for (int64_t i = 0; i < k + 1; ++i) r[n + i] = -(i + 2);

  if ((int64_t)ar.active.size() < n) ar.active.resize(n);
  if ((int64_t)ar.grp.size() < n) ar.grp.resize(n);
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i)
      ar.active[(size_t)i] = (int64_t)order[i];
    std::memcpy(ar.grp.data() + lo, gflag + lo, (size_t)(hi - lo));
  });

  Prof _p_dbl("doubling_rounds");
  // Each round refines rank groups by the rank `step` positions ahead.
  // Groups are contiguous runs of `active` (current sorted order), and on
  // collapsed genomes they are small but numerous (every position keeps a
  // twin), so a global radix sort per round is mostly wasted motion:
  // instead each group is stable-sorted locally by its members' lookahead
  // ranks — identical result (parent groups already ordered by prefix
  // rank; ties keep previous relative order), linear-time rounds.
  // Lookahead ranks are captured for ALL members before any rank is
  // rewritten (the numpy twin's gather/sort/write phase separation).
  if ((int64_t)ar.sub.size() < n) ar.sub.resize(n);
  int64_t* cvals = ar.sub.data();  // captured r[pos + step] per active slot
  if ((int64_t)ar.nact.size() < n) ar.nact.resize(n);
  int64_t* scratch = ar.nact.data();  // per-thread group sort scratch
  int64_t n_active = n;
  int64_t length = 32;
  while (length < k) {
    int64_t step = std::min(length, k - length);
    {  // drop singleton groups
      int64_t* act = ar.active.data();
      uint8_t* grp = ar.grp.data();
      int64_t w = 0, i = 0;
      while (i < n_active) {
        int64_t j = i + 1;
        while (j < n_active && !grp[j]) ++j;
        if (j - i >= 2) {
          for (int64_t t = i; t < j; ++t) {
            act[w] = act[t];
            grp[w] = (t == i) ? 1 : 0;
            ++w;
          }
        }
        i = j;
      }
      n_active = w;
    }
    int64_t na = n_active;
    if (Prof::enabled())
      std::fprintf(stderr, "[prof]   round len=%lld step=%lld na=%lld\n",
                   (long long)length, (long long)step, (long long)na);
    if (na == 0) break;
    int64_t* act = ar.active.data();
    uint8_t* grp = ar.grp.data();
    // phase 1: capture lookahead ranks
    parallel_for(na, [&](int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; ++i) cvals[i] = r[act[i] + step];
    });
    // phase 2: per-group stable sort by cvals; chunks aligned to group
    // starts so threads own whole groups
    unsigned hw = std::thread::hardware_concurrency();
    int T = (na >= (1 << 19) && hw > 1) ? (int)std::min<unsigned>(hw, 8) : 1;
    std::vector<int64_t> bounds((size_t)T + 1);
    bounds[0] = 0;
    bounds[(size_t)T] = na;
    for (int t = 1; t < T; ++t) {
      int64_t x = na * t / T;
      while (x < na && !grp[x]) ++x;
      bounds[(size_t)t] = x;
    }
    for (int t = 1; t < T; ++t)
      if (bounds[(size_t)t] < bounds[(size_t)(t - 1)])
        bounds[(size_t)t] = bounds[(size_t)(t - 1)];
    auto work = [&](int tid) {
      int64_t i = bounds[(size_t)tid], iend = bounds[(size_t)(tid + 1)];
      int64_t* tmp = scratch + i;  // scratch slice owned by this chunk
      while (i < iend) {
        int64_t j = i + 1;
        while (j < iend && !grp[j]) ++j;
        int64_t g = j - i;
        int64_t base = r[act[i]];
        if (g == 2) {  // the dominant case: a position and its twin
          int64_t c0 = cvals[i], c1 = cvals[i + 1];
          if (c1 < c0) {
            std::swap(act[i], act[i + 1]);
            std::swap(cvals[i], cvals[i + 1]);
          }
          bool split = cvals[i] != cvals[i + 1];
          r[act[i]] = base;
          r[act[i + 1]] = split ? base + 1 : base;
          grp[i + 1] = split ? 1 : 0;
        } else {
          // stable sort member slots by captured lookahead rank
          for (int64_t t2 = 0; t2 < g; ++t2) tmp[t2] = i + t2;
          std::stable_sort(tmp, tmp + g, [&](int64_t a, int64_t b) {
            return cvals[a] < cvals[b];
          });
          // write back in sorted order via a small local copy
          std::vector<int64_t> acts((size_t)g), cs((size_t)g);
          for (int64_t t2 = 0; t2 < g; ++t2) {
            acts[(size_t)t2] = act[tmp[t2]];
            cs[(size_t)t2] = cvals[tmp[t2]];
          }
          int64_t sub_off = 0;
          for (int64_t t2 = 0; t2 < g; ++t2) {
            if (t2 > 0 && cs[(size_t)t2] != cs[(size_t)(t2 - 1)])
              sub_off = t2;
            act[i + t2] = acts[(size_t)t2];
            cvals[i + t2] = cs[(size_t)t2];
            grp[i + t2] = (t2 == 0) || (sub_off == t2);
            r[acts[(size_t)t2]] = base + sub_off;
          }
        }
        i = j;
      }
    };
    if (T == 1) {
      work(0);
    } else {
      std::vector<std::thread> th;
      for (int t = 0; t < T; ++t) th.emplace_back(work, t);
      for (auto& x : th) x.join();
    }
    length += step;
  }
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) rank[i] = (uint32_t)r[i];
  });
  }

  // final order, stable by (rank, position): ranks are global bucket
  // starts, so one stable counting scatter places every element directly
  // (no sort); a group starts exactly where a bucket cursor is first used.
  // u32 cursors/positions cover the whole 1 GB-cap supergenome (< 2^32).
  Prof _p_fin("final_order_sort");
  if ((int64_t)ar.cursor.size() < n) ar.cursor.resize(n);
  std::memset(ar.cursor.data(), 0, (size_t)n * sizeof(uint32_t));
  uint32_t* cursor = ar.cursor.data();
  for (int64_t i = 0; i < n; ++i) {
    int64_t rk = (int64_t)rank[i];
    uint32_t c = cursor[rk]++;
    order[rk + c] = (uint32_t)i;
    gflag[rk + c] = (c == 0);
  }
}

}  // namespace

extern "C" {

// Slab carve/containment for sibling libraries (the engine dlsym's
// these so its node/sequence arrays ride the same hugetlb pool).
void* rank_slab_alloc(long long nb) {
  return slab_try_alloc((size_t)nb);
}
int rank_slab_contains(const void* p) {
  Slab& s = g_slab();
  return s.base && (const char*)p >= s.base &&
         (const char*)p < s.base + s.cap;
}

// The slab's mapped and carved bytes (both 0 when none is mapped).
void rank_slab_stats(int64_t* cap, int64_t* used) {
  Slab& s = g_slab();
  std::lock_guard<std::mutex> g(s.mu);
  *cap = s.base ? (int64_t)s.cap : 0;
  *used = s.base ? (int64_t)s.used : 0;
}

// Reserve the populated arena slab (see Slab above).  Called by the CLI
// right after reading the input, while process RSS is still small —
// that is the only window where acquisition runs at the cheap rate.
// No-op in spill mode, if already reserved, or if the mmap fails.
void rank_slab_reserve(int64_t bytes) {
  if (spill_on() || bytes <= 0) return;
  Slab& s = g_slab();
  std::lock_guard<std::mutex> g(s.mu);
  if (s.base) return;
  size_t nb = ((size_t)bytes + ((size_t)2 << 20) - 1) &
              ~(((size_t)2 << 20) - 1);
  static const bool populate = [] {
    const char* v = std::getenv("SIBELIA_TPU_POPULATE");
    return !(v && v[0] == '0');
  }();
  // Prefer the hugetlb pool (the CLI tops it up, best-effort): pool
  // pages return to the GUEST pool on munmap and are never reclaimed
  // host-side, so after the first process has paid for them, every
  // later run re-acquires the whole slab at ~0.2 s/GB instead of
  // ~5 s/GB of host acquisition.  Falls back to plain anonymous memory
  // when the pool is absent or too small.
#ifdef MAP_HUGETLB
  void* p = mmap(nullptr, nb, PROT_READ | PROT_WRITE,
                 MAP_PRIVATE | MAP_ANONYMOUS | MAP_HUGETLB |
                     (populate ? MAP_POPULATE : 0),
                 -1, 0);
  if (p != MAP_FAILED) {
    s.base = (char*)p;
    s.cap = nb;
    s.used = 0;
    return;
  }
#endif
  void* p2 = mmap(nullptr, nb, PROT_READ | PROT_WRITE,
                  MAP_PRIVATE | MAP_ANONYMOUS |
                      (populate ? MAP_POPULATE : 0),
                  -1, 0);
  if (p2 == MAP_FAILED) return;
  s.base = (char*)p2;
  s.cap = nb;
  s.used = 0;
}

// codes: u8[n] with values 0..4 (0 = separator '#'); outputs rank[n] and
// order[n] (int64).  Contract vs kmer_ranks_numpy: identical GROUPING of
// valid windows (equal rank <=> identical k-window) and identical
// valid-filtered sorted order; rank VALUES and the placement of invalid
// (separator-crossing) positions may differ in groups that mix valid and
// invalid members (see the LCP-refinement header comment above).
void kmer_ranks_native(const uint8_t* codes, int64_t n, int64_t k,
                       int64_t* rank_out, int64_t* order_out) {
  if (n <= 0) return;
  std::lock_guard<std::mutex> lock(rank_mutex());
  RankArena& ar = rank_arena();
  compute_ranks(codes, n, k, ar);
  const uint32_t* rk = ar.rank.data();
  const uint32_t* od = ar.order.data();
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) rank_out[i] = (int64_t)rk[i];
    for (int64_t i = lo; i < hi; ++i) order_out[i] = (int64_t)od[i];
  });
  rank_arena_drop_all();
}

// Full bifurcation enumeration over the supergenome
// (enumerate_bifurcations twin).  Returns a handle; fetch per-strand
// arrays sorted by (chr, pos) and destroy.
struct EnumResult {
  int64_t count;
  std::vector<int64_t> chr[2], pos[2];
  std::vector<uint32_t> id[2];
};

void* enum_run(const uint8_t* codes, int64_t n, const int64_t* block_starts,
               int64_t n_blocks, int64_t n_chr, int64_t k) {
  EnumResult* res = new EnumResult;
  res->count = 0;
  if (n <= 0) return res;
  std::lock_guard<std::mutex> lock(rank_mutex());
  RankArena& ar = rank_arena();
  {
    Prof _p("compute_ranks_total");
    compute_ranks(codes, n, k, ar);
  }
  Prof _p_scan0("enum_scan+map");
  const uint32_t* order = ar.order.data();
  const uint8_t* gflag = ar.gflag.data();
  // validity: the k-window crosses no separator == next_sep distance.
  // Probed via the n/8 B validity bitmap (LLC-resident; built by the
  // k>32 resolve already, or here) instead of a 4 B next_sep gather per
  // row — the scan is gather-throughput-bound.  A separator position
  // itself has next_sep[p] == p, so the bit also subsumes the
  // codes[p] == 0 member filter.
  build_validity_bits(ar, n, k);
  const uint64_t* vbp = ar.vbits.data();

  // scan rank groups (gflag marks group starts in sorted order) over
  // valid positions; parallel over group-aligned chunks — each thread
  // numbers its groups locally, a prefix pass over the (≤8) chunk counts
  // rebases the ids, so the result is identical to the serial scan
  struct Sel {
    int64_t sgpos;
    uint32_t id;
  };
  unsigned hw_scan = std::thread::hardware_concurrency();
  int TS = (n >= (1 << 19) && hw_scan > 1)
               ? (int)std::min<unsigned>(hw_scan, 8)
               : 1;
  std::vector<int64_t> bounds((size_t)TS + 1);
  bounds[0] = 0;
  bounds[(size_t)TS] = n;
  for (int t = 1; t < TS; ++t) {
    int64_t x = n * t / TS;
    while (x < n && !gflag[x]) ++x;
    bounds[(size_t)t] = x;
  }
  for (int t = 1; t < TS; ++t)
    if (bounds[(size_t)t] < bounds[(size_t)(t - 1)])
      bounds[(size_t)t] = bounds[(size_t)(t - 1)];
  std::vector<std::vector<Sel>> lsel((size_t)TS);
  std::vector<int64_t> lcount((size_t)TS, 0);
  auto scan_chunk = [&](int tid) {
    int64_t i = bounds[(size_t)tid], iend = bounds[(size_t)(tid + 1)];
    std::vector<Sel>& sel = lsel[(size_t)tid];
    int64_t count = 0;
    std::vector<int64_t> members;
    int64_t last_drop = i;
    while (i < iend) {
      if (i - last_drop >= kSpillQuantum) {
        ar.order.drop_range((size_t)last_drop, (size_t)i);
        ar.gflag.drop_range((size_t)last_drop, (size_t)i);
        last_drop = i;
      }
      int64_t j = i;
      members.clear();
      int prev_or = 0, next_or = 0;
      bool terminal = false;
      for (; j < iend && (j == i || !gflag[j]); ++j) {
        int64_t p = order[(size_t)j];
        if (((vbp[p >> 6] >> (p & 63)) & 1) == 0) continue;
        members.push_back(p);
        uint8_t pc = codes[p - 1];  // supergenome starts with '#', p >= 1
        uint8_t nc = (p + k <= n - 1) ? codes[p + k] : codes[n - 1];
        prev_or |= 1 << pc;
        next_or |= 1 << nc;
        if (pc == 0 || nc == 0) terminal = true;
      }
      if (!members.empty()) {
        auto is_bif = [](int bits) {
          return __builtin_popcount(bits) > 1 || (bits & 1) != 0;
        };
        bool bif = is_bif(prev_or) || is_bif(next_or);
        bool counted = bif && ((int64_t)members.size() > 1 || terminal);
        if (counted) {
          for (int64_t p : members)
            sel.push_back(Sel{p, (uint32_t)count});
          ++count;
        }
      }
      i = j;
    }
    lcount[(size_t)tid] = count;
  };
  if (TS == 1) {
    scan_chunk(0);
  } else {
    std::vector<std::thread> th;
    for (int t = 0; t < TS; ++t) th.emplace_back(scan_chunk, t);
    for (auto& x : th) x.join();
  }
  int64_t count = 0;
  std::vector<int64_t> id_off((size_t)TS, 0);
  for (int t = 0; t < TS; ++t) {
    id_off[(size_t)t] = count;
    count += lcount[(size_t)t];
  }
  res->count = count;

  // map to (strand, chr, local) and sort per strand by (chr, pos) —
  // STREAMING: convert each thread-local Sel chunk and free it before
  // touching the next (at genome scale the instance tables are GBs;
  // the old merge kept Sel + merged + Inst staging co-resident)
  struct Inst {
    int64_t chr, pos;
    uint32_t id;
  };
  std::vector<Inst> strand_insts[2];
  {
    size_t total_sel = 0;
    for (int t = 0; t < TS; ++t) total_sel += lsel[(size_t)t].size();
    // chunks are position-ordered per strand-half, so sizes split
    // roughly evenly; reserve the upper bound once per strand
    strand_insts[0].reserve(total_sel);
    strand_insts[1].reserve(total_sel);
  }
  for (int t = 0; t < TS; ++t) {
    uint32_t off = (uint32_t)id_off[(size_t)t];
    for (const Sel& s0 : lsel[(size_t)t]) {
      // block = last start <= pos (upper_bound - 1), clipped as in
      // numpy
      int64_t lo = 0, hi = n_blocks;
      while (lo < hi) {
        int64_t mid = (lo + hi) / 2;
        if (block_starts[mid] <= s0.sgpos)
          lo = mid + 1;
        else
          hi = mid;
      }
      int64_t blk = lo - 1;
      if (blk < 0) blk = 0;
      if (blk > 2 * n_chr - 1) blk = 2 * n_chr - 1;
      int64_t chr = (blk < n_chr) ? blk : blk - n_chr;
      int64_t local = s0.sgpos - block_starts[blk];
      int strand = (blk >= n_chr) ? 1 : 0;
      strand_insts[strand].push_back(Inst{chr, local, s0.id + off});
    }
    std::vector<Sel>().swap(lsel[(size_t)t]);  // free the chunk
  }
  for (int s = 0; s < 2; ++s) {
    std::sort(strand_insts[s].begin(), strand_insts[s].end(),
              [](const Inst& a, const Inst& b) {
                return a.chr != b.chr ? a.chr < b.chr : a.pos < b.pos;
              });
    res->chr[s].reserve(strand_insts[s].size());
    res->pos[s].reserve(strand_insts[s].size());
    res->id[s].reserve(strand_insts[s].size());
    for (const Inst& it : strand_insts[s]) {
      res->chr[s].push_back(it.chr);
      res->pos[s].push_back(it.pos);
      res->id[s].push_back(it.id);
    }
    std::vector<Inst>().swap(strand_insts[s]);
  }
  rank_arena_drop_all();
  return res;
}

int64_t enum_count(void* h) { return ((EnumResult*)h)->count; }

int64_t enum_strand_size(void* h, int s) {
  return (int64_t)((EnumResult*)h)->chr[s].size();
}

void enum_fetch(void* h, int s, int64_t* chr_out, int64_t* pos_out,
                uint32_t* id_out) {
  EnumResult* r = (EnumResult*)h;
  size_t m = r->chr[s].size();
  std::memcpy(chr_out, r->chr[s].data(), m * sizeof(int64_t));
  std::memcpy(pos_out, r->pos[s].data(), m * sizeof(int64_t));
  std::memcpy(id_out, r->id[s].data(), m * sizeof(uint32_t));
}

// 32-bit fetch: per-chromosome positions and chromosome indices are
// bounded far below 2^31 by the reference's 1 GB input cap, so the
// int64 internals narrow losslessly; callers skip a whole astype pass
// over the instance tables.
void enum_fetch32(void* h, int s, int32_t* chr_out, int32_t* pos_out,
                  uint32_t* id_out) {
  EnumResult* r = (EnumResult*)h;
  size_t m = r->chr[s].size();
  for (size_t i = 0; i < m; ++i) chr_out[i] = (int32_t)r->chr[s][i];
  for (size_t i = 0; i < m; ++i) pos_out[i] = (int32_t)r->pos[s][i];
  std::memcpy(id_out, r->id[s].data(), m * sizeof(uint32_t));
}

void enum_destroy(void* h) { delete (EnumResult*)h; }

}  // extern "C"
