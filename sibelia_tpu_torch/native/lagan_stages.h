// Internal API between the three LAGAN stage translation units.
#ifndef SIBELIA_TPU_LAGAN_STAGES_H
#define SIBELIA_TPU_LAGAN_STAGES_H

#include <array>
#include <string>
#include <vector>

#include "lagan_common.h"

namespace lagan {

// chaos over a list of 1-based inclusive region pairs (the -pairs protocol,
// fchaos.c:743-776); appends the reference binary's stdout text to *out.
void chaos_translated(const char* dna1, long n1, const char* name1,
                      const char* dna2, long n2, const char* name2,
                      bool both, int wl, int nd, int co, int rsc, bool gfc,
                      bool ext, std::string* out);
void chaos_pairs(const MappedSeq& s1, const char* name1, const MappedSeq& s2,
                 const char* name2,
                 const std::vector<std::array<int, 4>>& pairs, int wl, int nd,
                 int co, int rsc, bool gfc, bool ext, std::string* out);
// the process-wide sums of chaos's work since the library was loaded, over
// every region of both entry points: out[0] word matches chained, out[1]
// chain links walked by the rescoring.
void chaos_stats(long long* out);

// anchors: parses chaos-format hit text, selects the maximal consistent
// chain, appends the anchor lines (reference: anchors.c stdout format).
void anchors_text(const std::string& hits_text, bool gfc, std::string* out);

// order: anchored banded global alignment; anchors_text holds the sorted
// anchor lines handed to -anc.  Appends the -mfa output.
void order_mfa(const MappedSeq& s1, const char* name1, const MappedSeq& s2,
               const char* name2, const std::string& anchors_text,
               std::string* out);

// Split order pipeline for the device band DP: band construction and
// traceback stay native (exact reuse of the host engine's shapes/necks
// and pointer-walk), the O(band area) score recurrence runs on the
// accelerator (kernels/order_device.py).  `ptrs` is the device-computed
// pointer matrix, row (diag-1), wmax columns, nibble layout identical to
// the host DP.
void* order_prepare(const MappedSeq& s1, const MappedSeq& s2,
                    const std::string& anchors_text);
void order_band_dims(void* h, long long* d1, long long* d2,
                     long long* ndiags, long long* maxw);
void order_band_rows(void* h, int* starts, int* ends, int* isneck_eff);
void order_mapped_seq(void* h, int which, char* out);
void order_finish_mfa(void* h, const char* name1, const char* name2,
                      const unsigned char* ptrs, long long wmax,
                      std::string* out);
void order_release(void* h);

}  // namespace lagan

#endif  // SIBELIA_TPU_LAGAN_STAGES_H
