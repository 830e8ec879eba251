// Shared per-position aggregation: normalized observation counts ->
// 18-channel tensor + candidate decision + alt-info string.
//
// Two producers feed this: the mpileup text parser (pileup_core.cpp) and
// the direct BAM pileup engine (bam_core.cpp). Semantics mirror the
// reference TensorMaker (tensor_maker.cpp:61-249) and candidate filter
// (make_candidate_snp_tensor/main.cpp:196-201); both producers are
// differential-tested against the reference binary.
#pragma once

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace nsp {

enum Channel {
  CH_A = 0, CH_C, CH_G, CH_T, CH_I, CH_I1, CH_D, CH_D1, CH_STAR,
  CH_a, CH_c, CH_g, CH_t, CH_i, CH_i1, CH_d, CH_d1, CH_POUND,
  NUM_CH
};

// normalized single-base observation indices (strand-split ACGT + del
// placeholders); N bases are dropped before this layer
enum SingleIdx {
  S_A = 0, S_C, S_G, S_T,        // forward
  S_a, S_c, S_g, S_t,            // reverse
  S_STAR, S_POUND,
  NUM_SINGLE
};

struct Tables {
  uint8_t nt4[256];
  int8_t ch[256];
  bool fwd[256];    // mpileup chars marking forward strand: ACGTN*
  Tables() {
    std::memset(nt4, 4, sizeof(nt4));
    const char* b = "ACGT";
    for (int i = 0; i < 4; ++i) {
      nt4[(int)b[i]] = i;
      nt4[(int)std::tolower(b[i])] = i;
    }
    std::memset(ch, -1, sizeof(ch));
    ch[(int)'A'] = CH_A; ch[(int)'C'] = CH_C; ch[(int)'G'] = CH_G;
    ch[(int)'T'] = CH_T; ch[(int)'a'] = CH_a; ch[(int)'c'] = CH_c;
    ch[(int)'g'] = CH_g; ch[(int)'t'] = CH_t;
    ch[(int)'*'] = CH_STAR; ch[(int)'#'] = CH_POUND;
    std::memset(fwd, 0, sizeof(fwd));
    for (const char* p = "ACGTN*"; *p; ++p) fwd[(int)*p] = true;
  }
};
inline const Tables& tables() {
  static const Tables t;
  return t;
}

// one distinct indel observation at a position
struct IndelObs {
  bool is_del;
  bool fwd;
  std::string seq;  // uppercase inserted bases; empty for deletions
  int del_len = 0;  // for deletions
  int count = 0;
};

struct PosResult {
  int64_t depth = 0;
  double af = 0.0;
  bool pass_af = false;
  int max_del_length = 0;
};

inline void build_alt_info(
    const int32_t* singles, const std::vector<IndelObs>& indels,
    const char* ref_seq, int64_t ref_len, int64_t pos1,
    std::string* alt_info);

// singles: counts in SingleIdx layout. indels: distinct observations.
// counts out: NUM_CH int32 (ref-negation applied). alt_info (if non-null):
// "key cnt key cnt " over sorted alt keys (prefer passing nullptr and
// calling build_alt_info only for candidate rows).
inline void aggregate_position(
    const int32_t* singles, const std::vector<IndelObs>& indels,
    const char* ref_seq, int64_t ref_len, int64_t pos1,
    double snp_min_af, double indel_min_af,
    int32_t* counts, PosResult* out, std::string* alt_info) {
  const Tables& T = tables();
  char raw_ref = (pos1 - 1 < ref_len && pos1 >= 1) ? ref_seq[pos1 - 1] : 'N';
  char chr_base, chr_base_lower;
  if (T.nt4[(uint8_t)raw_ref] < 4) {
    chr_base = (char)std::toupper(raw_ref);
    chr_base_lower = (char)std::tolower(raw_ref);
  } else {
    chr_base = 'A';
    chr_base_lower = 'a';
  }

  std::memset(counts, 0, NUM_CH * sizeof(int32_t));
  static const int single_to_ch[NUM_SINGLE] = {
      CH_A, CH_C, CH_G, CH_T, CH_a, CH_c, CH_g, CH_t, CH_STAR, CH_POUND};
  int64_t depth = 0;
  int32_t base_counts[4] = {0, 0, 0, 0};
  for (int s = 0; s < NUM_SINGLE; ++s) {
    int32_t cnt = singles[s];
    if (!cnt) continue;
    counts[single_to_ch[s]] += cnt;
    depth += cnt;
    if (s < 8) base_counts[s % 4] += cnt;
  }

  int max_ins0 = 0, max_ins1 = 0, max_del0 = 0, max_del1 = 0;
  int max_del_length = 0;
  int32_t ins_total = 0, del_total = 0;
  for (const auto& ob : indels) {
    if (!ob.is_del) {
      ins_total += ob.count;
      if (ob.fwd) {
        counts[CH_I] += ob.count;
        max_ins0 = std::max(max_ins0, ob.count);
      } else {
        counts[CH_i] += ob.count;
        max_ins1 = std::max(max_ins1, ob.count);
      }
    } else {
      del_total += ob.count;
      max_del_length = std::max(max_del_length, ob.del_len);
      if (ob.fwd) {
        counts[CH_D] += ob.count;
        max_del0 = std::max(max_del0, ob.count);
      } else {
        counts[CH_d] += ob.count;
        max_del1 = std::max(max_del1, ob.count);
      }
    }
  }

  counts[CH_I1] = max_ins0;
  counts[CH_i1] = max_ins1;
  counts[CH_D1] = max_del0;
  counts[CH_d1] = max_del1;

  int64_t denom = depth ? depth : 1;
  struct Item { char key; int32_t cnt; };
  Item items[6];
  int n_items = 0;
  // std::map order of pileup_dict keys: A C D G I T
  const char key_order[6] = {'A', 'C', 'D', 'G', 'I', 'T'};
  for (char kc : key_order) {
    int32_t cnt;
    if (kc == 'I') cnt = ins_total;
    else if (kc == 'D') cnt = del_total;
    else cnt = base_counts[tables().nt4[(uint8_t)kc]];
    if (cnt) items[n_items++] = {kc, cnt};
  }
  // stable insertion sort by descending count (<=6 items; std::stable_sort
  // pays a temp-buffer/merge setup that dominated this 12M-calls/s path)
  for (int a = 1; a < n_items; ++a) {
    Item v = items[a];
    int bkt = a;
    while (bkt > 0 && items[bkt - 1].cnt < v.cnt) {
      items[bkt] = items[bkt - 1];
      --bkt;
    }
    items[bkt] = v;
  }

  bool pass_af = n_items > 0 && items[0].key != chr_base;
  bool pass_snp = false, pass_indel = false;
  for (int t = 0; t < n_items; ++t) {
    if (items[t].key == chr_base) continue;
    double freq = (double)items[t].cnt / (double)denom;
    if (items[t].key == 'I' || items[t].key == 'D') {
      pass_indel = pass_indel || (freq >= indel_min_af);
    } else {
      pass_snp = pass_snp || (freq >= snp_min_af);
    }
  }

  double af = (n_items > 1) ? (double)items[1].cnt / (double)denom : 0.0;
  if (n_items > 0 && items[0].key != chr_base)
    af = (double)items[0].cnt / (double)denom;

  int32_t fwd_sum = counts[CH_A] + counts[CH_C] + counts[CH_G] + counts[CH_T];
  counts[T.ch[(uint8_t)chr_base]] = -fwd_sum;
  int32_t rev_sum = counts[CH_a] + counts[CH_c] + counts[CH_g] + counts[CH_t];
  counts[T.ch[(uint8_t)chr_base_lower]] = -rev_sum;

  out->depth = depth;
  out->af = af;
  out->pass_af = pass_af || pass_snp || pass_indel;
  out->max_del_length = max_del_length;
  if (alt_info)
    build_alt_info(singles, indels, ref_seq, ref_len, pos1, alt_info);
}

// "key cnt key cnt " over sorted alt keys — only candidates ever print it,
// so callers run the counts-only aggregate first and call this for the
// ~2-5% of rows that pass the candidate filter.
inline void build_alt_info(
    const int32_t* singles, const std::vector<IndelObs>& indels,
    const char* ref_seq, int64_t ref_len, int64_t pos1,
    std::string* alt_info) {
  const Tables& T = tables();
  char raw_ref = (pos1 - 1 < ref_len && pos1 >= 1) ? ref_seq[pos1 - 1] : 'N';
  char chr_base = (T.nt4[(uint8_t)raw_ref] < 4)
                      ? (char)std::toupper(raw_ref) : 'A';
  std::map<std::string, int> alt_dict;
  for (int s = 0; s < 8; ++s) {
    int32_t cnt = singles[s];
    if (!cnt) continue;
    char up = "ACGT"[s % 4];
    if (up != chr_base) alt_dict[std::string("X") + up] += cnt;
  }
  std::string alt_key;
  for (const auto& ob : indels) {
    if (!ob.is_del) {
      alt_key.assign(1, 'I');
      alt_key += chr_base;
      alt_key += ob.seq;
    } else {
      alt_key.assign(1, 'D');
      for (int p = 1; p <= ob.del_len; ++p)
        alt_key += (pos1 + p - 1 < ref_len) ? ref_seq[pos1 + p - 1] : 'N';
    }
    alt_dict[alt_key] += ob.count;
  }
  alt_info->clear();
  char tmp[32];
  for (auto& kv : alt_dict) {
    *alt_info += kv.first;
    int n = std::snprintf(tmp, sizeof(tmp), " %d ", kv.second);
    alt_info->append(tmp, n);
  }
}

}  // namespace nsp
