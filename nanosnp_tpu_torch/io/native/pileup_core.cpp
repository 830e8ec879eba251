// NanoSNP-TPU native host kernel: mpileup text -> per-position 18-channel
// count tensors + candidate flags + alt-allele summaries.
//
// Row parsing mirrors the reference TensorMaker string semantics
// (tensor_maker.cpp:83-114); aggregation is shared with the direct BAM
// engine (pileup_common.hpp). Rows are parsed fully in parallel (OpenMP)
// into flat arrays; window assembly happens downstream as a vectorized
// gather. Verified row-for-row against the reference binary.
//
// Built into libnanosnp.so together with bam_core.cpp (see native.py).

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <string>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

#if defined(__AVX512BW__)
#include <immintrin.h>
#endif

#include "pileup_common.hpp"

using nsp::IndelObs;
using nsp::PosResult;

namespace {

struct TextTables {
  bool normal[256];   // ACGTNacgtn*#
  int8_t single[256]; // -> SingleIdx or -1
  TextTables() {
    std::memset(normal, 0, sizeof(normal));
    for (const char* p = "ACGTNacgtn*#"; *p; ++p) normal[(int)*p] = true;
    std::memset(single, -1, sizeof(single));
    const char* fw = "ACGT";
    const char* rv = "acgt";
    for (int i = 0; i < 4; ++i) {
      single[(int)fw[i]] = nsp::S_A + i;
      single[(int)rv[i]] = nsp::S_a + i;
    }
    single[(int)'*'] = nsp::S_STAR;
    single[(int)'#'] = nsp::S_POUND;
    // N/n observed but contribute nothing (reference ignores them)
  }
};
const TextTables TT;

// Per-thread reusable buffers: every std::string/vector keeps its heap
// capacity across rows, so indel-dense data stops hammering the allocator
// (the per-event alloc cost dominated s1 at high indel rates).
struct RowScratch {
  struct KeyCount {
    std::string key;
    int count;
  };
  std::vector<KeyCount> keys;     // active prefix [0, n_keys)
  size_t n_keys = 0;
  std::vector<IndelObs> indels;   // sized to the row's distinct events
};

// Bulk scan of the base string from p: count the 10 single-observation
// chars (ACGT acgt * #; N/n/$ and friends are no-ops) until the first
// structural char ('+', '-' indel introducers or '^' mapq-skip). Returns
// the offset of that char, or len if none. AVX-512BW path classifies 64
// bytes per iteration (mpileup base strings are overwhelmingly plain base
// runs: read starts '^X' appear once per read, indels on a few % of rows).
int64_t scan_singles(const char* p, int64_t len, int32_t* singles) {
#if defined(__AVX512BW__)
  static const char kChars[10] = {'A', 'C', 'G', 'T', 'a', 'c', 'g', 't',
                                  '*', '#'};
  const __m512i vplus = _mm512_set1_epi8('+');
  const __m512i vminus = _mm512_set1_epi8('-');
  const __m512i vcaret = _mm512_set1_epi8('^');
  int64_t cnt[10] = {0};
  int64_t i = 0;
  while (i < len) {
    int64_t rem = len - i;
    __mmask64 loadm =
        rem >= 64 ? ~(__mmask64)0 : (((__mmask64)1 << rem) - 1);
    __m512i v = _mm512_maskz_loadu_epi8(loadm, p + i);
    __mmask64 special = (_mm512_cmpeq_epi8_mask(v, vplus) |
                         _mm512_cmpeq_epi8_mask(v, vminus) |
                         _mm512_cmpeq_epi8_mask(v, vcaret)) &
                        loadm;
    __mmask64 valid = loadm;
    int64_t step = rem >= 64 ? 64 : rem;
    if (special) {
      int tz = __builtin_ctzll((uint64_t)special);
      valid = tz ? (((__mmask64)1 << tz) - 1) : 0;
      step = tz;
    }
    if (valid) {
      for (int c = 0; c < 10; ++c) {
        __mmask64 m =
            _mm512_cmpeq_epi8_mask(v, _mm512_set1_epi8(kChars[c])) & valid;
        cnt[c] += __builtin_popcountll((uint64_t)m);
      }
    }
    i += step;
    if (special) break;
  }
  // SingleIdx layout matches kChars order (S_A..S_t, S_STAR, S_POUND)
  for (int c = 0; c < 10; ++c) singles[c] += (int32_t)cnt[c];
  return i;
#else
  int64_t i = 0;
  for (; i < len; ++i) {
    char b = p[i];
    if (b == '+' || b == '-' || b == '^') break;
    int8_t s = TT.single[(uint8_t)b];
    if (s >= 0) ++singles[s];
  }
  return i;
#endif
}

// singles_out exposes the per-row observations so the caller can build
// alt_info lazily (candidates only, ~2-5% of rows); scratch->indels holds
// the row's distinct indel observations after the call.
void parse_row(const char* bases, int64_t blen, const char* ref_seq,
               int64_t ref_len, int64_t pos1, double snp_min_af,
               double indel_min_af, int max_indel, int32_t* counts,
               PosResult* out, int32_t* singles_out, RowScratch* scratch) {
  int32_t* singles = singles_out;
  std::memset(singles, 0, nsp::NUM_SINGLE * sizeof(int32_t));
  // distinct printed indel keys, preserving the reference's cov_stats
  // granularity (case encodes strand). Per position there are only a
  // handful of distinct events, so a flat vector with linear probing +
  // one final sort beats rb-tree inserts ~2x on indel-dense data; the
  // final sort restores std::map (lexicographic) iteration order.
  std::vector<RowScratch::KeyCount>& indel_keys = scratch->keys;
  size_t nk = 0;

  int64_t i = 0;
  while (i < blen) {
    i += scan_singles(bases + i, blen - i, singles);
    if (i >= blen) break;
    char b = bases[i];
    if (b == '^') {
      i += 2;  // '^' + the mapq char (which may itself be any byte)
      continue;
    }
    // b is '+' or '-'
    ++i;
    int64_t adv = 0;
    while (i < blen && bases[i] >= '0' && bases[i] <= '9') {
      adv = adv * 10 + (bases[i] - '0');
      ++i;
    }
    if (adv <= max_indel) {
      const char* kp = bases + i;
      bool found = false;
      for (size_t t = 0; t < nk; ++t) {
        auto& kc = indel_keys[t];
        if ((int64_t)kc.key.size() == adv + 1 && kc.key[0] == b &&
            std::memcmp(kc.key.data() + 1, kp, (size_t)adv) == 0) {
          ++kc.count;
          found = true;
          break;
        }
      }
      if (!found) {
        if (nk == indel_keys.size()) indel_keys.emplace_back();
        auto& kc = indel_keys[nk++];
        kc.count = 1;
        kc.key.clear();                 // keeps capacity
        kc.key.push_back(b);
        kc.key.append(kp, (size_t)adv);
      }
    }
    i += adv;
  }
  scratch->n_keys = nk;
  // no sort: aggregate_position is order-independent (sums/maxes) and
  // build_alt_info re-sorts through its std::map

  std::vector<IndelObs>& indels = scratch->indels;
  if (indels.size() < nk) indels.resize(nk);
  for (size_t t = 0; t < nk; ++t) {
    const std::string& k = indel_keys[t].key;
    IndelObs& ob = indels[t];
    ob.is_del = (k[0] == '-');
    ob.fwd = nsp::tables().fwd[(uint8_t)k[1]];
    ob.count = indel_keys[t].count;
    ob.seq.clear();                       // keeps capacity
    // ob.seq materialized lazily (materialize_indel_seqs) — only
    // candidate rows (~2%) feed build_alt_info
    ob.del_len = ob.is_del ? (int)k.size() - 1 : 0;
  }
  if (indels.size() > nk) indels.resize(nk);  // shrink pool to the row

  nsp::aggregate_position(singles, indels, ref_seq, ref_len, pos1,
                          snp_min_af, indel_min_af, counts, out, nullptr);
}

// fill insertion seqs (uppercased) for rows that need alt_info
void materialize_indel_seqs(RowScratch* scratch) {
  for (size_t t = 0; t < scratch->n_keys; ++t) {
    const std::string& k = scratch->keys[t].key;
    IndelObs& ob = scratch->indels[t];
    if (ob.is_del) continue;
    for (size_t p = 1; p < k.size(); ++p)
      ob.seq += (char)std::toupper(k[p]);
  }
}

}  // namespace

extern "C" {

// newline-aligned chunk starts for parallel text sweeps: starts[k] points
// at the first byte of a line, starts[n_chunks] = end
static void chunk_starts(const char* buf, int64_t len, int n_chunks,
                         std::vector<const char*>& starts) {
  starts.assign((size_t)n_chunks + 1, buf + len);
  starts[0] = buf;
  for (int k = 1; k < n_chunks; ++k) {
    const char* guess = buf + len * k / n_chunks;
    if (guess <= starts[k - 1]) { starts[k] = starts[k - 1]; continue; }
    const char* nl =
        (const char*)memchr(guess, '\n', (size_t)(buf + len - guess));
    starts[k] = nl ? nl + 1 : buf + len;
  }
}

int64_t nsp_count_rows(const char* buf, int64_t len, int n_threads) {
#ifdef _OPENMP
  const int nt = n_threads > 0 ? n_threads : omp_get_num_procs();
#else
  const int nt = 1;
  (void)n_threads;
#endif
  std::vector<const char*> starts;
  chunk_starts(buf, len, nt, starts);
  int64_t n = 0;
#pragma omp parallel for reduction(+ : n) num_threads(nt)
  for (int k = 0; k < nt; ++k) {
    const char* p = starts[k];
    const char* end = starts[k + 1];
    while (p < end) {
      const char* nl = (const char*)memchr(p, '\n', end - p);
      if (!nl) { ++n; break; }
      if (nl > p) ++n;
      p = nl + 1;
    }
  }
  return n;
}

int64_t nsp_parse_mpileup(
    const char* buf, int64_t len,
    const char* ref_seq, int64_t ref_len,
    double snp_min_af, double indel_min_af, int min_coverage, int max_indel,
    const uint8_t* bed_mask, const uint8_t* confident_mask,
    int n_threads,
    int64_t* positions, int32_t* counts, int32_t* depths,
    uint8_t* is_candidate, double* afs,
    char* alt_buf, int64_t alt_cap, int64_t* alt_off) {
  // Per-region thread count, NOT omp_set_num_threads: that call is
  // process-global, so a prior n_threads=1 parse would silently pin every
  // later n_threads=0 ("all cores") parse to one thread.
#ifdef _OPENMP
  const int nt = n_threads > 0 ? n_threads : omp_get_num_procs();
#else
  const int nt = 1;
  (void)nt;
#endif

  // parallel newline-aligned line split (serial memchr over the whole
  // buffer was ~25% of wall at 4 threads)
  std::vector<std::pair<const char*, const char*>> lines;
  {
    std::vector<const char*> starts;
    chunk_starts(buf, len, nt, starts);
    std::vector<std::vector<std::pair<const char*, const char*>>> part(nt);
#pragma omp parallel for num_threads(nt) schedule(static)
    for (int k = 0; k < nt; ++k) {
      auto& lk = part[k];
      lk.reserve((size_t)((starts[k + 1] - starts[k]) / 64) + 4);
      const char* p = starts[k];
      const char* end = starts[k + 1];
      while (p < end) {
        const char* nl = (const char*)memchr(p, '\n', end - p);
        const char* eol = nl ? nl : end;
        if (eol > p) lk.emplace_back(p, eol);
        p = eol + 1;
      }
    }
    size_t total = 0;
    std::vector<size_t> off(nt + 1, 0);
    for (int k = 0; k < nt; ++k) {
      off[k] = total;
      total += part[k].size();
    }
    off[nt] = total;
    lines.resize(total);
#pragma omp parallel for num_threads(nt) schedule(static)
    for (int k = 0; k < nt; ++k) {
      if (!part[k].empty())
        std::memcpy(lines.data() + off[k], part[k].data(),
                    part[k].size() * sizeof(lines[0]));
    }
  }
  const int64_t n = (int64_t)lines.size();

  // per-thread alt-info pools: only candidate rows (~2-5%) carry alt
  // strings, so a dense vector<string>(n) wasted allocation + touch
  struct AltRec { int64_t row, start, size; };
  std::vector<std::string> alt_pool(nt);
  std::vector<std::vector<AltRec>> alt_recs(nt);
  std::vector<uint8_t> keep(n, 1);

#pragma omp parallel num_threads(nt)
 {
  RowScratch scratch;
#ifdef _OPENMP
  const int tid = omp_get_thread_num();
#else
  const int tid = 0;
#endif
  std::string& pool = alt_pool[tid];
  std::vector<AltRec>& recs = alt_recs[tid];
  std::string alt_tmp;
#pragma omp for schedule(static)
  for (int64_t r = 0; r < n; ++r) {
    const char* p = lines[r].first;
    const char* eol = lines[r].second;
    const char* t1 = (const char*)memchr(p, '\t', eol - p);
    if (!t1) { keep[r] = 0; continue; }
    int64_t pos1 = 0;
    const char* q = t1 + 1;
    bool has_digit = false;
    while (q < eol && *q >= '0' && *q <= '9') {
      pos1 = pos1 * 10 + (*q++ - '0');
      has_digit = true;
    }
    if (!has_digit || pos1 <= 0) { keep[r] = 0; continue; }
    if (bed_mask && (pos1 - 1 >= ref_len || !bed_mask[pos1 - 1])) {
      keep[r] = 0;
      continue;
    }
    const char* c = q;
    for (int skip = 0; skip < 3 && c; ++skip) {
      c = (const char*)memchr(c, '\t', eol - c);
      if (c) ++c;
    }
    if (!c) { keep[r] = 0; continue; }
    const char* bases = c;
    const char* bend = (const char*)memchr(bases, '\t', eol - bases);
    if (!bend) bend = eol;

    int32_t* row_counts = counts + r * nsp::NUM_CH;
    PosResult res;
    int32_t singles[nsp::NUM_SINGLE];
    parse_row(bases, bend - bases, ref_seq, ref_len, pos1, snp_min_af,
              indel_min_af, max_indel, row_counts, &res, singles, &scratch);

    char ref_base = (pos1 - 1 < ref_len)
                        ? (char)std::toupper(ref_seq[pos1 - 1]) : 'N';
    bool ok_bed = true;
    if (confident_mask) {
      ok_bed = false;
      int64_t lo = pos1 - 1;
      int64_t hi = std::min<int64_t>(pos1 + res.max_del_length + 1, ref_len);
      for (int64_t k = lo; k < hi; ++k) {
        if (confident_mask[k]) { ok_bed = true; break; }
      }
    }
    bool cand = ok_bed && nsp::tables().nt4[(uint8_t)ref_base] < 4 &&
                res.pass_af && res.depth >= min_coverage;
    positions[r] = pos1;
    depths[r] = (int32_t)res.depth;
    afs[r] = res.af;
    is_candidate[r] = cand ? 1 : 0;
    if (cand) {
      materialize_indel_seqs(&scratch);
      nsp::build_alt_info(singles, scratch.indels, ref_seq, ref_len, pos1,
                          &alt_tmp);
      recs.push_back({r, (int64_t)pool.size(), (int64_t)alt_tmp.size()});
      pool += alt_tmp;
    }
  }
 }  // omp parallel

  // schedule(static) hands thread k a contiguous row range, so walking
  // alt_recs in thread order visits rows in ascending order
  int64_t w = 0;
  int64_t alt_used = 0;
  int rk = 0;
  size_t ri = 0;
  while (rk < nt && alt_recs[rk].empty()) ++rk;
  for (int64_t r = 0; r < n; ++r) {
    if (!keep[r]) continue;
    if (w != r) {
      positions[w] = positions[r];
      depths[w] = depths[r];
      afs[w] = afs[r];
      is_candidate[w] = is_candidate[r];
      std::memcpy(counts + w * nsp::NUM_CH, counts + r * nsp::NUM_CH,
                  nsp::NUM_CH * sizeof(int32_t));
    }
    int64_t sl = 0;
    if (rk < nt && alt_recs[rk][ri].row == r) {
      const AltRec& rec = alt_recs[rk][ri];
      sl = rec.size;
      if (alt_used + sl <= alt_cap)
        std::memcpy(alt_buf + alt_used, alt_pool[rk].data() + rec.start,
                    (size_t)sl);
      if (++ri >= alt_recs[rk].size()) {
        ri = 0;
        ++rk;
        while (rk < nt && alt_recs[rk].empty()) ++rk;
      }
    }
    alt_off[2 * w] = alt_used;
    alt_off[2 * w + 1] = alt_used + sl;
    alt_used += sl;
    ++w;
  }
  if (alt_used > alt_cap) return -alt_used;
  return w;
}

}  // extern "C"
