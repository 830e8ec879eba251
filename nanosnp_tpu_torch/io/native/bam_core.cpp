// NanoSNP-TPU native BAM engine: streaming BGZF + BAM record parsing + two
// pileup consumers, no htslib dependency (zlib only).
//
//   nsp_bam_open/close      one streaming pass over the BAM: builds a BGZF
//                           block table (file offset <-> inflated offset)
//                           and an in-memory record index (ref, start, end,
//                           inflated offset/length) for region queries
//                           without BAI files. Memory stays O(index): the
//                           compressed file is NOT retained; region queries
//                           pread + inflate only their covering blocks.
//   nsp_bam_pileup_region   direct BAM -> 18-channel position tensors for
//                           [start0, end0), replacing the reference's
//                           samtools-mpileup text round-trip
//                           (make_predict_data.sh steps 1-3). mpileup
//                           semantics: --min-MQ / --excl-flags filters,
//                           per-column --max-depth cap (first reads in BAM
//                           order win), insertions attach to the preceding
//                           counted base, deleted positions emit * / #
//                           placeholders (--reverse-del), N bases count
//                           toward depth-cap slots but contribute nothing.
//   nsp_bam_read_matrices   read-by-position matrices (base code / baseq /
//                           mapq / HP tag) for the haplotype feature stage,
//                           replacing the pysam per-read-per-column loops
//                           (create_pileup_haplotype.py:86-134). Row order:
//                           host sorts by (first covered requested column,
//                           BAM order) to reproduce pysam's pileup
//                           iteration order.
//
// Chunked processing keeps memory at O(region) — the caller walks a contig
// in overlapping windows (features assemble 33-wide candidate windows, so
// chunks overlap by the flank and are trimmed host-side).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

#include <sys/stat.h>
#include <unistd.h>

#include <zlib.h>

#ifdef _OPENMP
#include <omp.h>
#endif

#include "pileup_common.hpp"

namespace {

struct BamRef {
  std::string name;
  int64_t length;
};

struct BamRecord {
  int32_t ref_id;
  int64_t pos;
  uint8_t mapq;
  uint16_t flag;
  uint32_t n_cigar;
  const uint32_t* cigar;
  int32_t l_seq;
  const uint8_t* seq4;
  const uint8_t* qual;
  const uint8_t* aux;
  size_t aux_len;
};

struct RecordIdx {
  int32_t ref_id;
  int32_t start;     // 0-based
  int32_t end;       // 0-based exclusive (start + ref span)
  uint64_t off;      // inflated-stream offset of the block_size field
  uint32_t len;      // 4 + block_size bytes
};

struct BgzfBlock {
  uint64_t file_off;
  uint64_t infl_off;
  uint32_t comp_len;
  uint32_t infl_len;
};

struct OpenBam {
  FILE* f = nullptr;
  int fd = -1;   // fileno(f): pread-based block fetch needs no file lock
  std::vector<BamRef> refs;
  std::unordered_map<std::string, int> ref_ids;
  std::vector<RecordIdx> index;           // sorted by (ref_id, start)
  std::vector<size_t> ref_index_begin;    // per ref: first index entry
  std::vector<uint32_t> ref_max_span;     // per ref: max record end-start
  std::vector<BgzfBlock> blocks;          // ascending infl_off
  uint64_t total_inflated = 0;
  std::mutex io_mu;                       // serializes file reads

  // FIFO cache of inflated blocks: overlapping region queries (phaser
  // windows, s1 chunk flanks, s4 group sweeps) stop re-inflating the same
  // BGZF blocks. Insertion-order eviction suits the sequential scans that
  // dominate; keyed by block index, bounded by NSP_BAM_CACHE_MB (default
  // 256, 0 disables). Guarded by io_mu.
  // shared_ptr values: hits copy their bytes OUTSIDE io_mu (the pointer
  // keeps an evicted block alive until every in-flight fetch drops it)
  std::unordered_map<size_t, std::shared_ptr<const std::vector<uint8_t>>>
      block_cache;
  std::deque<size_t> fifo_order;          // oldest at front
  size_t cache_bytes = 0;

  ~OpenBam() {
    if (f) std::fclose(f);
  }
};

size_t cache_cap_bytes() {
  static size_t cap = [] {
    const char* v = std::getenv("NSP_BAM_CACHE_MB");
    long mb = v ? std::atol(v) : 256;
    return (size_t)(mb > 0 ? mb : 0) << 20;
  }();
  return cap;
}

std::mutex g_mu;
std::unordered_map<int64_t, OpenBam*> g_open;
int64_t g_next_handle = 1;

// Inflate one gzip member starting at file_off. Appends inflated bytes to
// `out`; sets comp_len/infl_len. Returns false at EOF or on error.
bool inflate_member(FILE* f, uint64_t file_off, std::vector<uint8_t>& out,
                    uint32_t* comp_len, uint32_t* infl_len) {
  if (std::fseek(f, (long)file_off, SEEK_SET) != 0) return false;
  std::vector<uint8_t> in_buf(1 << 17);
  std::vector<uint8_t> chunk(1 << 16);
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, 15 + 16) != Z_OK) return false;
  size_t out_before = out.size();
  uint64_t consumed = 0;
  int ret = Z_OK;
  bool ok = true;
  while (ret != Z_STREAM_END) {
    if (zs.avail_in == 0) {
      size_t got = std::fread(in_buf.data(), 1, in_buf.size(), f);
      if (got == 0) { ok = false; break; }
      zs.next_in = in_buf.data();
      zs.avail_in = (uInt)got;
    }
    uInt avail_before = zs.avail_in;
    zs.next_out = chunk.data();
    zs.avail_out = (uInt)chunk.size();
    ret = inflate(&zs, Z_NO_FLUSH);
    if (ret != Z_OK && ret != Z_STREAM_END) { ok = false; break; }
    consumed += avail_before - zs.avail_in;
    out.insert(out.end(), chunk.data(),
               chunk.data() + (chunk.size() - zs.avail_out));
  }
  inflateEnd(&zs);
  if (!ok) return false;
  *comp_len = (uint32_t)consumed;
  *infl_len = (uint32_t)(out.size() - out_before);
  return true;
}

enum { OP_M = 0, OP_I, OP_D, OP_N, OP_S, OP_H, OP_P, OP_EQ, OP_X };

// generic aux-field scan: on a tag match sets *typep to the type char and
// *valp / *szp to the value bytes (after the type byte) and their size
bool aux_find(const uint8_t* aux, size_t aux_len, const char tag[2],
              char* typep, const uint8_t** valp, size_t* szp) {
  const uint8_t* p = aux;
  const uint8_t* end = aux + aux_len;
  while (p + 3 <= end) {
    char t0 = (char)p[0], t1 = (char)p[1], type = (char)p[2];
    p += 3;
    size_t sz = 0;
    switch (type) {
      case 'A': case 'c': case 'C': sz = 1; break;
      case 's': case 'S': sz = 2; break;
      case 'i': case 'I': case 'f': sz = 4; break;
      case 'Z': case 'H': {
        const uint8_t* q = p;
        while (q < end && *q) ++q;
        sz = (size_t)(q - p) + 1;
        break;
      }
      case 'B': {
        if (p + 5 > end) return false;
        char sub = (char)p[0];
        uint32_t cnt;
        std::memcpy(&cnt, p + 1, 4);
        size_t esz = (sub == 'c' || sub == 'C') ? 1
                     : (sub == 's' || sub == 'S') ? 2 : 4;
        sz = 5 + (size_t)cnt * esz;
        break;
      }
      default:
        return false;
    }
    if (p + sz > end || p + sz < p) return false;
    if (t0 == tag[0] && t1 == tag[1]) {
      *typep = type;
      *valp = p;
      *szp = sz;
      return true;
    }
    p += sz;
  }
  return false;
}

// htslib long-CIGAR convention (SAM spec §4.2.2 / hts.c): records with
// >65535 CIGAR ops are written with a placeholder "<l_seq>S<ref_span>N"
// 2-op CIGAR and the real ops in a CG:B,I aux tag. samtools/minimap2 emit
// this for ultra-long ONT reads, so the pileup / read-matrix walkers must
// see the real ops (the placeholder would silently soft-clip the whole
// read out of every downstream stage). Returns with r->cigar pointing into
// the CG array (same lifetime as the record buffer). A CG array whose
// query-consuming ops don't sum to l_seq is ignored (guards seq/qual
// overruns on malformed files).
void resolve_long_cigar(BamRecord* r) {
  if (r->n_cigar != 2 ||
      (r->cigar[0] & 0xf) != OP_S ||
      (int64_t)(r->cigar[0] >> 4) != (int64_t)r->l_seq ||
      (r->cigar[1] & 0xf) != OP_N)
    return;
  char type;
  const uint8_t* val;
  size_t sz;
  if (!aux_find(r->aux, r->aux_len, "CG", &type, &val, &sz)) return;
  if (type != 'B' || sz < 5 || (char)val[0] != 'I') return;
  uint32_t cnt;
  std::memcpy(&cnt, val + 1, 4);
  if (cnt == 0 || sz != 5 + (size_t)cnt * 4) return;
  const uint32_t* ops = (const uint32_t*)(val + 5);
  int64_t qlen = 0;
  for (uint32_t ci = 0; ci < cnt; ++ci) {
    uint32_t op = ops[ci] & 0xf;
    if (op == OP_M || op == OP_I || op == OP_S || op == OP_EQ || op == OP_X)
      qlen += ops[ci] >> 4;
  }
  if (qlen != (int64_t)r->l_seq) return;
  r->cigar = ops;
  r->n_cigar = cnt;
}

// parse a record laid out at `p` (block_size field first); returns false if
// fewer than `avail` bytes suffice
bool parse_record(const uint8_t* p, size_t avail, BamRecord* r,
                  uint32_t* rec_len) {
  if (avail < 4) return false;
  int32_t block_size = *(const int32_t*)p;
  if (block_size < 32) return false;
  if (avail < 4 + (size_t)block_size) return false;
  const uint8_t* b = p + 4;
  r->ref_id = *(const int32_t*)(b + 0);
  r->pos = *(const int32_t*)(b + 4);
  uint8_t l_read_name = b[8];
  r->mapq = b[9];
  r->n_cigar = *(const uint16_t*)(b + 12);
  r->flag = *(const uint16_t*)(b + 14);
  r->l_seq = *(const int32_t*)(b + 16);
  const uint8_t* q = b + 32 + l_read_name;
  r->cigar = (const uint32_t*)q;
  q += 4ull * r->n_cigar;
  r->seq4 = q;
  q += ((uint64_t)r->l_seq + 1) / 2;
  r->qual = q;
  q += r->l_seq;
  r->aux = q;
  if (q > b + block_size) return false;
  r->aux_len = (size_t)(b + block_size - q);
  *rec_len = 4 + (uint32_t)block_size;
  resolve_long_cigar(r);
  return true;
}

inline int seq_base16(const uint8_t* seq4, int64_t i) {
  uint8_t b = seq4[i >> 1];
  return (i & 1) ? (b & 0xf) : (b >> 4);
}

const char SEQ16_CHAR[16] = {'=', 'A', 'C', 'M', 'G', 'R', 'S', 'V',
                             'T', 'W', 'Y', 'H', 'K', 'D', 'B', 'N'};
const int8_t SEQ16_NT4[16] = {4, 0, 1, 4, 2, 4, 4, 4,
                              3, 4, 4, 4, 4, 4, 4, 4};

int64_t ref_span_of(const BamRecord& r) {
  int64_t span = 0;
  for (uint32_t ci = 0; ci < r.n_cigar; ++ci) {
    uint32_t op = r.cigar[ci] & 0xf;
    if (op == OP_M || op == OP_EQ || op == OP_X || op == OP_D || op == OP_N)
      span += r.cigar[ci] >> 4;
  }
  return span;
}

bool aux_int(const BamRecord& r, const char tag[2], int64_t* out) {
  char type;
  const uint8_t* p;
  size_t sz;
  if (!aux_find(r.aux, r.aux_len, tag, &type, &p, &sz)) return false;
  switch (type) {
    case 'c': *out = *(const int8_t*)p; return true;
    case 'C': *out = *(const uint8_t*)p; return true;
    case 's': { int16_t v; std::memcpy(&v, p, 2); *out = v; return true; }
    case 'S': { uint16_t v; std::memcpy(&v, p, 2); *out = v; return true; }
    case 'i': { int32_t v; std::memcpy(&v, p, 4); *out = v; return true; }
    case 'I': { uint32_t v; std::memcpy(&v, p, 4); *out = v; return true; }
    default: return false;
  }
}

// fetch inflated bytes [lo, hi) into buf (thread-safe per handle)
void build_ref_max_span(OpenBam* b) {
  b->ref_max_span.assign(b->refs.size(), 0);
  for (const RecordIdx& ri : b->index) {
    uint32_t span = (uint32_t)(ri.end > ri.start ? ri.end - ri.start : 0);
    if (ri.ref_id >= 0 && (size_t)ri.ref_id < b->ref_max_span.size() &&
        span > b->ref_max_span[ri.ref_id])
      b->ref_max_span[ri.ref_id] = span;
  }
}

// Inflate one BGZF member into exactly `cap` bytes at `dst` using pread
// (no shared-FILE* seek, so no lock needed). Returns false on error or if
// the member does not inflate to exactly `cap` bytes.
bool inflate_member_pread(int fd, uint64_t file_off, uint8_t* dst,
                          uint32_t cap) {
  uint8_t in_buf[1 << 16];
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, 15 + 16) != Z_OK) return false;
  zs.next_out = dst;
  zs.avail_out = cap;
  uint64_t off = file_off;
  int ret = Z_OK;
  bool ok = true;
  while (ret != Z_STREAM_END) {
    if (zs.avail_in == 0) {
      ssize_t got = pread(fd, in_buf, sizeof(in_buf), (off_t)off);
      if (got <= 0) { ok = false; break; }
      off += (uint64_t)got;
      zs.next_in = in_buf;
      zs.avail_in = (uInt)got;
    }
    ret = inflate(&zs, Z_NO_FLUSH);
    if (ret != Z_OK && ret != Z_STREAM_END) { ok = false; break; }
    if (ret != Z_STREAM_END && zs.avail_out == 0) { ok = false; break; }
  }
  ok = ok && zs.avail_out == 0;
  inflateEnd(&zs);
  return ok;
}

bool fetch_inflated(OpenBam* b, uint64_t lo, uint64_t hi,
                    std::vector<uint8_t>& buf, uint64_t* base) {
  if (hi > b->total_inflated) hi = b->total_inflated;
  if (lo >= hi) {
    buf.clear();
    *base = lo;
    return true;
  }
  // first block with infl_off + infl_len > lo
  size_t i0 = (size_t)(std::upper_bound(
                           b->blocks.begin(), b->blocks.end(), lo,
                           [](uint64_t v, const BgzfBlock& blk) {
                             return v < blk.infl_off + blk.infl_len;
                           }) -
                       b->blocks.begin());
  if (i0 >= b->blocks.size()) return false;
  const uint64_t base0 = b->blocks[i0].infl_off;
  *base = base0;
  size_t i1 = i0;
  uint64_t total = 0;
  while (i1 < b->blocks.size() && b->blocks[i1].infl_off < hi) {
    total += b->blocks[i1].infl_len;
    ++i1;
  }
  buf.resize(total);
  size_t cap = cache_cap_bytes();
  // pass 1 (locked): grab shared_ptrs of cache hits, collect misses.
  // Lock hold is O(entries) pointer copies — the byte memcpy of hits and
  // the inflate of misses both run OUTSIDE io_mu (a warm-cache fetch used
  // to memcpy its whole span, up to 64 MB, under the lock, serializing
  // concurrent chunk threads on fully cached regions).
  std::vector<size_t> missing;
  std::vector<std::pair<size_t,
                        std::shared_ptr<const std::vector<uint8_t>>>> hits;
  hits.reserve(i1 - i0);
  {
    std::lock_guard<std::mutex> lk(b->io_mu);
    for (size_t i = i0; i < i1; ++i) {
      auto it = b->block_cache.find(i);
      if (it != b->block_cache.end())
        hits.emplace_back(i, it->second);
      else
        missing.push_back(i);
    }
  }
  for (auto& [i, blk] : hits)
    std::memcpy(buf.data() + (b->blocks[i].infl_off - base0), blk->data(),
                blk->size());
  hits.clear();
  // pass 2 (unlocked): inflate misses straight into their span slots, and
  // prebuild their cache entries so the publish lock only swaps pointers
  std::vector<std::pair<size_t,
                        std::shared_ptr<const std::vector<uint8_t>>>> fresh;
  if (cap) fresh.reserve(missing.size());
  for (size_t i : missing) {
    uint8_t* dst = buf.data() + (b->blocks[i].infl_off - base0);
    if (!inflate_member_pread(b->fd, b->blocks[i].file_off, dst,
                              b->blocks[i].infl_len))
      return false;
    if (cap)
      fresh.emplace_back(i, std::make_shared<const std::vector<uint8_t>>(
                                dst, dst + b->blocks[i].infl_len));
  }
  // pass 3 (locked): publish — pointer inserts + FIFO bookkeeping only
  if (cap && !fresh.empty()) {
    std::lock_guard<std::mutex> lk(b->io_mu);
    for (auto& [i, blk] : fresh) {
      if (b->block_cache.count(i)) continue;   // another thread won
      b->cache_bytes += blk->size();
      b->block_cache.emplace(i, std::move(blk));
      b->fifo_order.push_back(i);
      while (b->cache_bytes > cap && !b->fifo_order.empty()) {
        size_t victim = b->fifo_order.front();
        b->fifo_order.pop_front();
        auto vit = b->block_cache.find(victim);
        if (vit != b->block_cache.end()) {
          b->cache_bytes -= vit->second->size();
          b->block_cache.erase(vit);
        }
      }
    }
  }
  return true;
}

// iterate records overlapping [start, end) on ref_id; fetches the covering
// inflated span once up front
struct RegionIter {
  OpenBam* b;
  std::vector<uint8_t> window;
  uint64_t base = 0;
  std::vector<const RecordIdx*> entries;
  size_t next_i = 0;
  bool ok = false;

  RegionIter(OpenBam* b_, int ref_id, int64_t start, int64_t end) : b(b_) {
    uint64_t lo = UINT64_MAX, hi = 0;
    // entries for this ref are [rb, re), sorted by start. Scanning from rb
    // every query made region lookups O(reads-per-contig) — s4 issues
    // ~1000 chunk queries per contig, turning the stage quadratic in
    // coverage x contig length. A record overlapping [start, end) must
    // have ri.start in (start - max_span, end), so binary-search the left
    // edge with the per-ref max record span.
    size_t rb = b->ref_index_begin[ref_id];
    size_t re = b->ref_index_begin[ref_id + 1];
    int64_t min_start = start - (int64_t)(
        ref_id < (int)b->ref_max_span.size() ? b->ref_max_span[ref_id] : 0);
    size_t first = (size_t)(std::lower_bound(
                                b->index.begin() + rb, b->index.begin() + re,
                                min_start,
                                [](const RecordIdx& ri, int64_t v) {
                                  return ri.start < v;
                                }) -
                            b->index.begin());
    for (size_t i = first; i < re; ++i) {
      const RecordIdx& ri = b->index[i];
      if (ri.start >= end) break;
      if (ri.end <= start) continue;
      entries.push_back(&ri);
      lo = std::min(lo, ri.off);
      hi = std::max(hi, ri.off + ri.len);
    }
    if (entries.empty()) {
      ok = true;
      return;
    }
    ok = fetch_inflated(b, lo, hi, window, &base);
  }

  // inflated-stream offset of the record last returned by next(): unique
  // and stable per record, usable as a read identity across calls
  uint64_t last_off = 0;

  bool next(BamRecord* r) {
    while (ok && next_i < entries.size()) {
      const RecordIdx* ri = entries[next_i++];
      uint64_t rel = ri->off - base;
      if (rel + ri->len > window.size()) continue;  // corrupt span: skip
      uint32_t rec_len;
      if (parse_record(window.data() + rel, ri->len, r, &rec_len)) {
        last_off = ri->off;
        return true;
      }
    }
    return false;
  }
};

// ---------------------------------------------------------------------------
// Sidecar index (.nsi): persists the BGZF block table + record index so
// reopening a BAM (resume, multi-host fan-out where every host opens the
// same file) skips the full-file streaming scan. Native-endian internal
// format, validated against the BAM's (size, mtime).
// ---------------------------------------------------------------------------

static const uint32_t NSI_MAGIC = 0x3249534e;  // "NSI2"

static bool bam_stat(const char* path, uint64_t* size, uint64_t* mtime) {
  struct stat st;
  if (stat(path, &st) != 0) return false;
  *size = (uint64_t)st.st_size;
  // ns precision when available: same-second in-place rewrites must
  // invalidate the sidecar
  *mtime = (uint64_t)st.st_mtim.tv_sec * 1000000000ull
           + (uint64_t)st.st_mtim.tv_nsec;
  return true;
}

// crc of the first 64 KB: catches same-size same-mtime rewrites (e.g. a
// tagged copy regenerated twice within the filesystem's mtime resolution)
static bool bam_head_crc(const char* path, uint32_t* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::vector<uint8_t> buf(64 << 10);
  size_t got = std::fread(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  *out = crc32(0, buf.data(), (uInt)got);
  return true;
}

static std::string sidecar_path(const char* path) {
  return std::string(path) + ".nsi";
}

static bool sidecar_enabled() {
  const char* v = std::getenv("NSP_BAM_INDEX");
  return !(v && v[0] == '0');
}

template <typename T>
static bool rd(FILE* f, T* out) { return std::fread(out, sizeof(T), 1, f) == 1; }
template <typename T>
static bool wr(FILE* f, const T& v) { return std::fwrite(&v, sizeof(T), 1, f) == 1; }

static bool try_load_sidecar(OpenBam* b, const char* path) {
  if (!sidecar_enabled()) return false;
  uint64_t size, mtime;
  if (!bam_stat(path, &size, &mtime)) return false;
  FILE* f = std::fopen(sidecar_path(path).c_str(), "rb");
  if (!f) return false;
  bool ok = false;
  uint32_t head_crc = 0;
  if (!bam_head_crc(path, &head_crc)) { std::fclose(f); return false; }
  do {
    uint32_t magic; uint64_t s, m, n;
    uint32_t hc;
    if (!rd(f, &magic) || magic != NSI_MAGIC) break;
    if (!rd(f, &s) || !rd(f, &m) || s != size || m != mtime) break;
    if (!rd(f, &hc) || hc != head_crc) break;
    if (!rd(f, &b->total_inflated)) break;
    if (!rd(f, &n) || n > (1u << 24)) break;
    b->refs.resize(n);
    bool bad = false;
    for (auto& r : b->refs) {
      uint32_t ln; int64_t len;
      if (!rd(f, &ln) || ln > (1u << 16) || !rd(f, &len)) { bad = true; break; }
      r.name.resize(ln);
      if (ln && std::fread(&r.name[0], 1, ln, f) != ln) { bad = true; break; }
      r.length = len;
    }
    if (bad) break;
    if (!rd(f, &n)) break;
    b->blocks.resize(n);
    if (n && std::fread(b->blocks.data(), sizeof(BgzfBlock), n, f) != n) break;
    if (!rd(f, &n)) break;
    b->index.resize(n);
    if (n && std::fread(b->index.data(), sizeof(RecordIdx), n, f) != n) break;
    for (size_t i = 0; i < b->refs.size(); ++i)
      b->ref_ids[b->refs[i].name] = (int)i;
    ok = true;
  } while (false);
  std::fclose(f);
  if (!ok) {
    b->refs.clear(); b->ref_ids.clear(); b->blocks.clear(); b->index.clear();
  }
  return ok;
}

static void write_sidecar(const OpenBam* b, const char* path) {
  if (!sidecar_enabled()) return;
  uint64_t size, mtime;
  if (!bam_stat(path, &size, &mtime)) return;
  // pid+address-suffixed temp: concurrent writers (multi-host fan-out or
  // two threads opening the same BAM) each rename their own complete file
  // into place
  std::string tmp = sidecar_path(path) + ".tmp." + std::to_string(getpid())
      + "." + std::to_string((uintptr_t)b % 100000);
  FILE* f = std::fopen(tmp.c_str(), "wb");
  if (!f) return;  // read-only location: silently skip
  uint32_t head_crc = 0;
  if (!bam_head_crc(path, &head_crc)) { std::fclose(f); std::remove(tmp.c_str()); return; }
  bool ok = wr(f, NSI_MAGIC) && wr(f, size) && wr(f, mtime) &&
            wr(f, head_crc) && wr(f, b->total_inflated);
  ok = ok && wr(f, (uint64_t)b->refs.size());
  for (const auto& r : b->refs) {
    ok = ok && wr(f, (uint32_t)r.name.size()) && wr(f, r.length) &&
         (r.name.empty() ||
          std::fwrite(r.name.data(), 1, r.name.size(), f) == r.name.size());
  }
  ok = ok && wr(f, (uint64_t)b->blocks.size()) &&
       (b->blocks.empty() ||
        std::fwrite(b->blocks.data(), sizeof(BgzfBlock), b->blocks.size(), f)
            == b->blocks.size());
  ok = ok && wr(f, (uint64_t)b->index.size()) &&
       (b->index.empty() ||
        std::fwrite(b->index.data(), sizeof(RecordIdx), b->index.size(), f)
            == b->index.size());
  std::fclose(f);
  if (ok) std::rename(tmp.c_str(), sidecar_path(path).c_str());
  else std::remove(tmp.c_str());
}


// ---------------------------------------------------------------------------
// BGZF/BAM writer: emit a haplotagged copy of the BAM (whatshap-haplotag's
// user-visible artifact) without any external tool. Records stream through
// in index order; reads present in the (read_id -> HP) map get an HP:c aux
// (existing HP stripped first), everything else passes through unchanged.
// ---------------------------------------------------------------------------

struct BgzfWriter {
  FILE* f = nullptr;
  std::vector<uint8_t> pend;   // uncompressed bytes awaiting a block

  explicit BgzfWriter(FILE* f_) : f(f_) { pend.reserve(1 << 16); }

  bool flush_block() {
    if (pend.empty()) return true;
    // deflate raw
    std::vector<uint8_t> comp(pend.size() + (pend.size() >> 2) + 64);
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (deflateInit2(&zs, 6, Z_DEFLATED, -15, 8,
                     Z_DEFAULT_STRATEGY) != Z_OK)
      return false;
    zs.next_in = pend.data();
    zs.avail_in = (uInt)pend.size();
    zs.next_out = comp.data();
    zs.avail_out = (uInt)comp.size();
    int ret = deflate(&zs, Z_FINISH);
    deflateEnd(&zs);
    if (ret != Z_STREAM_END) return false;
    uint32_t clen = (uint32_t)zs.total_out;
    uint32_t crc = crc32(0, pend.data(), (uInt)pend.size());
    uint32_t isize = (uint32_t)pend.size();
    uint32_t bsize = clen + 25;          // total block length - 1
    uint8_t hdr[18] = {0x1f, 0x8b, 8, 4, 0, 0, 0, 0, 0, 0xff,
                       6, 0, 'B', 'C', 2, 0,
                       (uint8_t)(bsize & 0xff), (uint8_t)(bsize >> 8)};
    bool ok = std::fwrite(hdr, 1, 18, f) == 18 &&
              std::fwrite(comp.data(), 1, clen, f) == clen &&
              std::fwrite(&crc, 4, 1, f) == 1 &&
              std::fwrite(&isize, 4, 1, f) == 1;
    pend.clear();
    return ok;
  }

  bool write(const uint8_t* data, size_t len) {
    while (len) {
      size_t room = (size_t)(60 << 10) - pend.size();
      size_t take = len < room ? len : room;
      pend.insert(pend.end(), data, data + take);
      data += take;
      len -= take;
      if (pend.size() >= (size_t)(60 << 10) && !flush_block()) return false;
    }
    return true;
  }

  bool finish() {
    if (!flush_block()) return false;
    static const uint8_t EOF_BLK[28] = {
        0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff, 0x06, 0x00,
        0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00,
        0, 0, 0, 0, 0, 0, 0, 0};
    return std::fwrite(EOF_BLK, 1, 28, f) == 28;
  }
};

// strip every "HP" aux item; returns the new aux bytes
std::vector<uint8_t> strip_hp_aux(const uint8_t* aux, size_t len) {
  std::vector<uint8_t> out;
  out.reserve(len);
  const uint8_t* p = aux;
  const uint8_t* end = aux + len;
  while (p + 3 <= end) {
    const uint8_t* item = p;
    char type = (char)p[2];
    p += 3;
    size_t sz = 0;
    switch (type) {
      case 'A': case 'c': case 'C': sz = 1; break;
      case 's': case 'S': sz = 2; break;
      case 'i': case 'I': case 'f': sz = 4; break;
      case 'Z': case 'H': {
        const uint8_t* q = p;
        while (q < end && *q) ++q;
        sz = (size_t)(q - p) + 1;
        break;
      }
      case 'B': {
        if (p + 5 > end) { p = end; sz = 0; break; }
        char sub = (char)p[0];
        uint32_t cnt = *(const uint32_t*)(p + 1);
        size_t esz = (sub == 'c' || sub == 'C') ? 1
                     : (sub == 's' || sub == 'S') ? 2 : 4;
        sz = 5 + (size_t)cnt * esz;
        break;
      }
      default: p = end; sz = 0; break;
    }
    if (p + sz > end) break;
    p += sz;
    if (!(item[0] == 'H' && item[1] == 'P'))
      out.insert(out.end(), item, p);
  }
  return out;
}

}  // namespace

extern "C" {

// ---- parallel cold-open scan (r5) -----------------------------------
// The original cold open inflated the whole file on ONE thread (the
// streaming loop below, kept as the fallback): ~20-25 s of the 100 Mbp
// world's s1 wall was this serial scan. BGZF members carry their own
// compressed size (BC extra subfield) and per-member ISIZE, so the block
// table can be built by hopping headers WITHOUT inflating; record parsing
// then proceeds in bounded batches whose member inflates run in parallel.
// Produces bit-identical blocks/index/total_inflated (and therefore a
// bit-identical .nsi sidecar) to the serial path.

// Serial header walk: fills b->blocks/total_inflated without inflating.
// Returns false (caller must reset + fall back) on any non-BGZF member.
static bool build_block_table_bgzf(OpenBam* b) {
  struct stat st;
  if (fstat(b->fd, &st) != 0) return false;
  const uint64_t fsize = (uint64_t)st.st_size;
  uint64_t file_off = 0, infl_off = 0;
  uint8_t hdr[12], extra[256], isz[4];
  while (file_off + 12 <= fsize) {
    if (pread(b->fd, hdr, 12, (off_t)file_off) != 12) return false;
    if (hdr[0] != 0x1f || hdr[1] != 0x8b) {
      if (infl_off == 0) return false;  // not gzip at all
      break;                            // trailing garbage: stop (like serial)
    }
    if (hdr[2] != 8 || !(hdr[3] & 4)) return false;  // no FEXTRA: not BGZF
    const uint16_t xlen = (uint16_t)(hdr[10] | (hdr[11] << 8));
    if (xlen == 0 || xlen > sizeof(extra)) return false;
    if (pread(b->fd, extra, xlen, (off_t)(file_off + 12)) != (ssize_t)xlen)
      return false;
    uint32_t comp_len = 0;
    for (uint32_t o = 0; o + 4 <= xlen;) {
      const uint16_t slen = (uint16_t)(extra[o + 2] | (extra[o + 3] << 8));
      if (extra[o] == 'B' && extra[o + 1] == 'C' && slen == 2 &&
          o + 6 <= xlen) {
        comp_len = (uint32_t)(extra[o + 4] | (extra[o + 5] << 8)) + 1;
        break;
      }
      o += 4 + slen;
    }
    if (comp_len < 28 || file_off + comp_len > fsize) return false;
    if (pread(b->fd, isz, 4, (off_t)(file_off + comp_len - 4)) != 4)
      return false;
    const uint32_t infl_len =
        (uint32_t)(isz[0] | (isz[1] << 8) | (isz[2] << 16)) |
        ((uint32_t)isz[3] << 24);
    if (infl_len > (1u << 17)) return false;  // BGZF caps blocks at 64 KiB
    if (infl_len > 0)
      b->blocks.push_back(BgzfBlock{file_off, infl_off, comp_len, infl_len});
    file_off += comp_len;
    infl_off += infl_len;
  }
  b->total_inflated = infl_off;
  return infl_off > 0;
}

// Batched scan over the prebuilt block table: each 64 MiB batch inflates
// its members in parallel (offsets are known so every member writes its
// own slot), then the BAM header / record headers are walked serially
// (cheap). `carry` holds the unparsed tail crossing a batch boundary.
static bool scan_records_batched(OpenBam* b) {
#ifdef _OPENMP
  const char* env = std::getenv("NSP_BAM_OPEN_THREADS");
  int nt = env ? std::atoi(env) : 0;
  if (nt <= 0) nt = omp_get_num_procs();
#else
  const int nt = 1;
#endif
  // batch bound override (tests force tiny batches to exercise the
  // carry / batch-boundary record logic)
  const char* benv = std::getenv("NSP_BAM_SCAN_BATCH");
  const uint64_t BATCH_INFL =
      benv && std::atoll(benv) > 0 ? (uint64_t)std::atoll(benv) : 64ull << 20;
  std::vector<uint8_t> buf, carry;
  bool header_done = false;
  size_t bi = 0;
  while (bi < b->blocks.size()) {
    size_t bj = bi;
    uint64_t span = 0;
    while (bj < b->blocks.size() &&
           (bj == bi || span + b->blocks[bj].infl_len <= BATCH_INFL)) {
      span += b->blocks[bj].infl_len;
      ++bj;
    }
    const uint64_t base = b->blocks[bi].infl_off;
    const size_t coff = carry.size();
    buf.resize(coff + span);
    if (coff) std::memcpy(buf.data(), carry.data(), coff);
    bool ok = true;
#pragma omp parallel for num_threads(nt) schedule(dynamic, 8) \
    reduction(&& : ok)
    for (size_t i = bi; i < bj; ++i) {
      ok = ok && inflate_member_pread(
                     b->fd, b->blocks[i].file_off,
                     buf.data() + coff + (b->blocks[i].infl_off - base),
                     b->blocks[i].infl_len);
    }
    if (!ok) return false;
    const uint64_t abs0 = base - coff;  // absolute offset of buf[0]
    size_t q = 0;
    if (!header_done) {
      // header must start at absolute 0; nothing is consumed until the
      // whole ref list is complete (carry keeps growing across batches)
      if (abs0 != 0) return false;
      if (buf.size() >= 12) {
        if (std::memcmp(buf.data(), "BAM\1", 4) != 0) return false;
        const int32_t l_text = *(const int32_t*)(buf.data() + 4);
        if (l_text >= 0 && buf.size() >= 8 + (uint64_t)l_text + 4) {
          const int32_t n_ref = *(const int32_t*)(buf.data() + 8 + l_text);
          uint64_t off2 = 12 + (uint64_t)l_text;
          std::vector<BamRef> refs;
          bool complete = n_ref >= 0;
          for (int i = 0; complete && i < n_ref; ++i) {
            if (buf.size() < off2 + 4) { complete = false; break; }
            const int32_t l_name = *(const int32_t*)(buf.data() + off2);
            if (l_name <= 0 || buf.size() < off2 + 8 + (uint64_t)l_name) {
              complete = false;
              break;
            }
            BamRef br;
            br.name.assign((const char*)buf.data() + off2 + 4, l_name - 1);
            br.length = *(const int32_t*)(buf.data() + off2 + 4 + l_name);
            refs.push_back(std::move(br));
            off2 += 8 + (uint64_t)l_name;
          }
          if (complete) {
            b->refs = std::move(refs);
            for (size_t i = 0; i < b->refs.size(); ++i)
              b->ref_ids[b->refs[i].name] = (int)i;
            q = off2;
            header_done = true;
          }
        }
      }
    }
    if (header_done) {
      while (true) {
        BamRecord r;
        uint32_t rec_len;
        if (!parse_record(buf.data() + q, buf.size() - q, &r, &rec_len))
          break;
        if (r.ref_id >= 0) {
          RecordIdx ri{};
          ri.ref_id = r.ref_id;
          ri.start = (int32_t)r.pos;
          ri.end = (int32_t)(r.pos + ref_span_of(r));
          ri.off = abs0 + q;
          ri.len = rec_len;
          b->index.push_back(ri);
        }
        q += rec_len;
      }
    }
    carry.assign(buf.begin() + q, buf.end());
    bi = bj;
  }
  return header_done;
}

int64_t nsp_bam_open(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  OpenBam* b = new OpenBam();
  b->f = f;
  b->fd = fileno(f);

  if (try_load_sidecar(b, path)) {
    b->ref_index_begin.assign(b->refs.size() + 1, b->index.size());
    for (size_t i = b->index.size(); i-- > 0;)
      b->ref_index_begin[b->index[i].ref_id] = i;
    for (size_t i = b->refs.size(); i-- > 0;)
      if (b->ref_index_begin[i] > b->ref_index_begin[i + 1])
        b->ref_index_begin[i] = b->ref_index_begin[i + 1];
    build_ref_max_span(b);
    std::lock_guard<std::mutex> lk(g_mu);
    int64_t h = g_next_handle++;
    g_open[h] = b;
    return h;
  }

  // fast path: BGZF header walk + batched parallel inflate. On any
  // non-BGZF structure, reset and fall through to the serial streaming
  // pass (which handles arbitrary concatenated gzip members).
  // NSP_BAM_SERIAL_SCAN=1 forces the fallback (differential testing).
  const char* force_serial = std::getenv("NSP_BAM_SERIAL_SCAN");
  const bool use_fast = !(force_serial && force_serial[0] == '1');
  const char* dbg = std::getenv("NSP_BAM_SCAN_DEBUG");
  double t_hdr = 0, t_scan = 0;
  bool fast_ok = false;
  if (use_fast) {
    struct timespec a, m, z;
    clock_gettime(CLOCK_MONOTONIC, &a);
    const bool tbl = build_block_table_bgzf(b);
    clock_gettime(CLOCK_MONOTONIC, &m);
    fast_ok = tbl && scan_records_batched(b);
    clock_gettime(CLOCK_MONOTONIC, &z);
    t_hdr = (m.tv_sec - a.tv_sec) + 1e-9 * (m.tv_nsec - a.tv_nsec);
    t_scan = (z.tv_sec - m.tv_sec) + 1e-9 * (z.tv_nsec - m.tv_nsec);
    if (dbg && dbg[0] == '1')
      std::fprintf(stderr, "[nsi] header_walk %.3fs batched_scan %.3fs\n",
                   t_hdr, t_scan);
  }
  if (fast_ok) {
    std::stable_sort(b->index.begin(), b->index.end(),
                     [](const RecordIdx& a, const RecordIdx& c) {
                       return a.ref_id != c.ref_id ? a.ref_id < c.ref_id
                                                   : a.start < c.start;
                     });
    const int n_ref = (int)b->refs.size();
    b->ref_index_begin.assign(n_ref + 1, b->index.size());
    for (size_t i = b->index.size(); i-- > 0;)
      b->ref_index_begin[b->index[i].ref_id] = i;
    for (int i = n_ref - 1; i >= 0; --i)
      if (b->ref_index_begin[i] > b->ref_index_begin[i + 1])
        b->ref_index_begin[i] = b->ref_index_begin[i + 1];
    build_ref_max_span(b);
    write_sidecar(b, path);
    std::lock_guard<std::mutex> lk(g_mu);
    int64_t h = g_next_handle++;
    g_open[h] = b;
    return h;
  }
  b->blocks.clear();
  b->index.clear();
  b->refs.clear();
  b->ref_ids.clear();
  b->total_inflated = 0;

  // streaming pass: block table + rolling record-header parse
  std::vector<uint8_t> carry;     // inflated bytes not yet consumed
  uint64_t carry_base = 0;        // inflated offset of carry[0]
  uint64_t file_off = 0;
  uint64_t infl_off = 0;
  bool header_done = false;
  uint64_t parse_pos = 0;         // absolute inflated parse position

  auto fail = [&]() -> int64_t {
    delete b;
    return -2;
  };

  while (true) {
    uint32_t comp_len = 0, infl_len = 0;
    size_t before = carry.size();
    {
      // peek 2 bytes for EOF/magic
      if (std::fseek(f, (long)file_off, SEEK_SET) != 0) break;
      uint8_t magic[2];
      if (std::fread(magic, 1, 2, f) != 2) break;  // clean EOF
      if (magic[0] != 0x1f || magic[1] != 0x8b) {
        if (infl_off == 0) return fail();  // not gzip at all
        break;                              // trailing garbage: stop
      }
    }
    if (!inflate_member(f, file_off, carry, &comp_len, &infl_len)) {
      if (infl_off == 0) return fail();
      break;  // truncated tail: keep what we have
    }
    (void)before;
    if (infl_len > 0) {
      b->blocks.push_back(BgzfBlock{file_off, infl_off, comp_len, infl_len});
    }
    file_off += comp_len;
    infl_off += infl_len;

    // parse whatever is now complete in carry
    auto avail = [&]() { return carry_base + carry.size() - parse_pos; };
    auto ptr = [&]() { return carry.data() + (parse_pos - carry_base); };
    if (!header_done) {
      // need magic+l_text+text+n_ref+refs; parse opportunistically
      if (avail() >= 12) {
        const uint8_t* p = ptr();
        if (std::memcmp(p, "BAM\1", 4) != 0) return fail();
        int32_t l_text = *(const int32_t*)(p + 4);
        uint64_t need = 8 + (uint64_t)l_text + 4;
        if (avail() >= need) {
          int32_t n_ref = *(const int32_t*)(p + 8 + l_text);
          // try to parse the full ref list
          uint64_t off2 = 12 + (uint64_t)l_text;
          std::vector<BamRef> refs;
          bool complete = true;
          for (int i = 0; i < n_ref; ++i) {
            if (avail() < off2 + 4) { complete = false; break; }
            int32_t l_name = *(const int32_t*)(ptr() + off2);
            if (avail() < off2 + 8 + (uint64_t)l_name) { complete = false; break; }
            BamRef br;
            br.name.assign((const char*)ptr() + off2 + 4, l_name - 1);
            br.length = *(const int32_t*)(ptr() + off2 + 4 + l_name);
            refs.push_back(std::move(br));
            off2 += 8 + (uint64_t)l_name;
          }
          if (complete) {
            b->refs = std::move(refs);
            for (size_t i = 0; i < b->refs.size(); ++i)
              b->ref_ids[b->refs[i].name] = (int)i;
            parse_pos += off2;
            header_done = true;
          }
        }
      }
    }
    if (header_done) {
      while (true) {
        BamRecord r;
        uint32_t rec_len;
        if (!parse_record(ptr(), avail(), &r, &rec_len)) break;
        if (r.ref_id >= 0) {
          RecordIdx ri{};
          ri.ref_id = r.ref_id;
          ri.start = (int32_t)r.pos;
          ri.end = (int32_t)(r.pos + ref_span_of(r));
          ri.off = parse_pos;
          ri.len = rec_len;
          b->index.push_back(ri);
        }
        parse_pos += rec_len;
      }
      // drop consumed carry prefix
      uint64_t consumed = parse_pos - carry_base;
      if (consumed > (1 << 20)) {
        carry.erase(carry.begin(), carry.begin() + consumed);
        carry_base = parse_pos;
      }
    }
  }
  b->total_inflated = infl_off;
  if (!header_done) return fail();

  std::stable_sort(b->index.begin(), b->index.end(),
                   [](const RecordIdx& a, const RecordIdx& c) {
                     return a.ref_id != c.ref_id ? a.ref_id < c.ref_id
                                                 : a.start < c.start;
                   });
  int n_ref = (int)b->refs.size();
  b->ref_index_begin.assign(n_ref + 1, b->index.size());
  for (size_t i = b->index.size(); i-- > 0;) {
    b->ref_index_begin[b->index[i].ref_id] = i;
  }
  for (int i = n_ref - 1; i >= 0; --i) {
    if (b->ref_index_begin[i] > b->ref_index_begin[i + 1])
      b->ref_index_begin[i] = b->ref_index_begin[i + 1];
  }
  build_ref_max_span(b);

  write_sidecar(b, path);

  std::lock_guard<std::mutex> lk(g_mu);
  int64_t h = g_next_handle++;
  g_open[h] = b;
  return h;
}

void nsp_bam_close(int64_t handle) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_open.find(handle);
  if (it != g_open.end()) {
    delete it->second;
    g_open.erase(it);
  }
}

int64_t nsp_bam_n_refs(int64_t handle) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_open.find(handle);
  return it == g_open.end() ? -1 : (int64_t)it->second->refs.size();
}

int64_t nsp_bam_ref_info(int64_t handle, char* name_buf, int64_t name_cap,
                         int64_t* lengths, int64_t max_refs) {
  OpenBam* b;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_open.find(handle);
    if (it == g_open.end()) return -1;
    b = it->second;
  }
  int64_t n = std::min<int64_t>((int64_t)b->refs.size(), max_refs);
  int64_t off = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t l = (int64_t)b->refs[i].name.size() + 1;
    if (off + l <= name_cap)
      std::memcpy(name_buf + off, b->refs[i].name.c_str(), (size_t)l);
    off += l;
    lengths[i] = b->refs[i].length;
  }
  return n;
}

// Pileup over [start0, end0) (0-based). Output arrays must hold up to
// (end0 - start0) rows. Returns rows written, or -needed_alt_cap when the
// alt buffer is too small, or -1/-2 on errors.
int64_t nsp_bam_pileup_region(
    int64_t handle, const char* ref_name, int64_t start0, int64_t end0,
    const char* ref_seq, int64_t ref_len,
    double snp_min_af, double indel_min_af, int min_coverage, int max_indel,
    int min_mq, int excl_flags, int max_depth,
    int64_t* positions, int32_t* counts, int32_t* depths,
    uint8_t* is_candidate, double* afs,
    char* alt_buf, int64_t alt_cap, int64_t* alt_off) {
  OpenBam* b;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_open.find(handle);
    if (it == g_open.end()) return -1;
    b = it->second;
  }
  auto rid = b->ref_ids.find(ref_name);
  if (rid == b->ref_ids.end()) return -2;
  if (end0 > ref_len) end0 = ref_len;
  if (start0 < 0) start0 = 0;
  int64_t w = end0 - start0;
  if (w <= 0) return 0;

  // Per-thread reusable buffers: the previous per-call
  // vector<vector<Obs>> cost one malloc per indel-bearing position plus
  // 24 B/position of header churn per chunk; the flat linked pool below
  // is allocation-free in steady state (measured ~1.5x single-thread on
  // indel-dense data, output-identical).
  thread_local std::vector<int32_t> singles;
  thread_local std::vector<int32_t> col_n;
  singles.assign((size_t)w * nsp::NUM_SINGLE, 0);
  col_n.assign((size_t)w, 0);

  // Distinct indel observations at mpileup cov_stats granularity —
  // (seq, strand) for insertions, (len, strand) for deletions — stored as
  // per-position chains over one flat node pool. Key packs
  // is_del|fwd|len|(<=13 seq nibbles straight from the BAM 4-bit codes);
  // longer insertion seqs overflow to a side string pool (bit 55).
  struct ObsNode { uint64_t key; int32_t count; int32_t next; };
  constexpr uint64_t KEY_DEL = 1ULL << 63;
  constexpr uint64_t KEY_FWD = 1ULL << 62;
  constexpr uint64_t KEY_OVF = 1ULL << 55;
  constexpr int MAX_PACKED = 13;
  thread_local std::vector<int32_t> head;
  thread_local std::vector<ObsNode> pool;
  thread_local std::vector<std::string> ovf;
  head.assign((size_t)w, -1);
  pool.clear();
  ovf.clear();

  auto chain_add = [&](int64_t off, uint64_t key, const std::string* oseq) {
    for (int32_t ni = head[off]; ni >= 0; ni = pool[ni].next) {
      ObsNode& nd = pool[ni];
      if (!oseq) {
        if (nd.key == key) { ++nd.count; return; }
      } else if ((nd.key & ~0xFFFFFFFFFFFFFFULL) == (key & ~0xFFFFFFFFFFFFFFULL)
                 && (nd.key & KEY_OVF) && (key & KEY_OVF) &&
                 ((nd.key >> 56) & 0x3F) == ((key >> 56) & 0x3F) &&
                 ovf[nd.key & 0xFFFFFFFF] == *oseq) {
        ++nd.count;
        return;
      }
    }
    if (oseq) {
      key = (key & ~0xFFFFFFFFULL) | (uint64_t)ovf.size();
      ovf.push_back(*oseq);
    }
    pool.push_back(ObsNode{key, 1, head[off]});
    head[off] = (int32_t)pool.size() - 1;
  };
  std::string oseq_buf;
  auto record_ins = [&](int64_t off, bool fwd, const uint8_t* seq4,
                        int64_t qpos, int64_t ln) {
    uint64_t key = (fwd ? KEY_FWD : 0) | ((uint64_t)ln << 56);
    if (ln <= MAX_PACKED) {
      for (int64_t k = 0; k < ln; ++k)
        key |= (uint64_t)seq_base16(seq4, qpos + k) << (4 * k);
      chain_add(off, key, nullptr);
    } else {
      oseq_buf.clear();
      for (int64_t k = 0; k < ln; ++k)
        oseq_buf += SEQ16_CHAR[seq_base16(seq4, qpos + k)];
      chain_add(off, key | KEY_OVF, &oseq_buf);
    }
  };
  auto record_del = [&](int64_t off, bool fwd, int32_t len) {
    chain_add(off, KEY_DEL | (fwd ? KEY_FWD : 0) | ((uint64_t)len << 56),
              nullptr);
  };

  // Depth-cap semantics (make_predict_data.sh --max-depth 144):
  //   max_depth > 0  "column" mode (default): per-column cap, first
  //                  covering reads in BAM order win; the cap re-fills at
  //                  every column.
  //   max_depth < 0  "push" mode (|max_depth| cap): htslib bam_plp_push
  //                  admission — a read is dropped ENTIRELY when, at its
  //                  start, the buffer of still-active admitted reads
  //                  (end >= this start) is full. Reproduces samtools'
  //                  coverage-spike shadow: reads starting inside a
  //                  saturated window never contribute, so coverage dips
  //                  below the cap just downstream of a spike. Admission
  //                  state is per region call (chunk boundaries reset it;
  //                  s1 chunks are Mbp-scale so the edge effect is a few
  //                  read lengths). Unverified against a real samtools
  //                  binary (none in this container) — differential-test
  //                  before relying on it for byte parity (ROADMAP #3).
  bool push_mode = max_depth < 0;
  if (push_mode) max_depth = -max_depth;
  thread_local std::vector<int64_t> active_ends;  // min-heap of read ends
  active_ends.clear();

  RegionIter iter(b, rid->second, start0, end0);
  if (!iter.ok) return -3;
  BamRecord r;
  while (iter.next(&r)) {
    if (r.flag & excl_flags) continue;
    if (r.mapq < min_mq) continue;
    if (push_mode && max_depth > 0) {
      while (!active_ends.empty() && active_ends.front() < r.pos) {
        std::pop_heap(active_ends.begin(), active_ends.end(),
                      std::greater<int64_t>());
        active_ends.pop_back();
      }
      if ((int)active_ends.size() >= max_depth) continue;  // whole read
      int64_t span = 0;
      for (uint32_t ci = 0; ci < r.n_cigar; ++ci) {
        uint32_t op = r.cigar[ci] & 0xf;
        if (op == OP_M || op == OP_EQ || op == OP_X || op == OP_D ||
            op == OP_N)
          span += r.cigar[ci] >> 4;
      }
      active_ends.push_back(r.pos + (span > 0 ? span - 1 : 0));
      std::push_heap(active_ends.begin(), active_ends.end(),
                     std::greater<int64_t>());
    }
    bool fwd = !(r.flag & 16);
    int64_t rpos = r.pos;
    int64_t qpos = 0;
    int64_t last_base_pos1 = -1;
    bool last_base_counted = false;
    for (uint32_t ci = 0; ci < r.n_cigar; ++ci) {
      uint32_t c = r.cigar[ci];
      uint32_t op = c & 0xf;
      int64_t ln = c >> 4;
      switch (op) {
        case OP_M: case OP_EQ: case OP_X: {
          for (int64_t k = 0; k < ln; ++k) {
            int64_t p0 = rpos + k;
            last_base_pos1 = p0 + 1;
            last_base_counted = false;
            if (p0 < start0 || p0 >= end0) {
              last_base_counted = true;  // cap tracked only inside window
              continue;
            }
            int64_t x = p0 - start0;
            if (!push_mode && max_depth > 0 && col_n[x] >= max_depth)
              continue;
            ++col_n[x];
            last_base_counted = true;
            int b4 = SEQ16_NT4[seq_base16(r.seq4, qpos + k)];
            if (b4 < 4) {
              ++singles[(size_t)x * nsp::NUM_SINGLE +
                        (fwd ? nsp::S_A : nsp::S_a) + b4];
            }
          }
          rpos += ln;
          qpos += ln;
          break;
        }
        case OP_I: {
          if (last_base_pos1 > 0 && last_base_counted && ln <= max_indel &&
              last_base_pos1 - 1 >= start0 && last_base_pos1 - 1 < end0) {
            record_ins(last_base_pos1 - 1 - start0, fwd, r.seq4, qpos, ln);
          }
          qpos += ln;
          break;
        }
        case OP_D: {
          if (last_base_pos1 > 0 && last_base_counted && ln <= max_indel &&
              last_base_pos1 - 1 >= start0 && last_base_pos1 - 1 < end0) {
            record_del(last_base_pos1 - 1 - start0, fwd, (int32_t)ln);
          }
          for (int64_t k = 0; k < ln; ++k) {
            int64_t p0 = rpos + k;
            if (p0 < start0 || p0 >= end0) continue;
            int64_t x = p0 - start0;
            if (!push_mode && max_depth > 0 && col_n[x] >= max_depth)
              continue;
            ++col_n[x];
            ++singles[(size_t)x * nsp::NUM_SINGLE +
                      (fwd ? nsp::S_STAR : nsp::S_POUND)];
          }
          rpos += ln;
          break;
        }
        case OP_N: rpos += ln; break;
        case OP_S: qpos += ln; break;
        default: break;
      }
    }
  }

  int64_t n_out = 0;
  int64_t alt_used = 0;
  std::string alt_str;
  std::vector<nsp::IndelObs> indels;
  for (int64_t x = 0; x < w; ++x) {
    if (col_n[x] == 0) continue;   // mpileup emits only covered positions
    int64_t pos1 = start0 + x + 1;
    indels.clear();
    for (int32_t ni = head[x]; ni >= 0; ni = pool[ni].next) {
      const ObsNode& nd = pool[ni];
      nsp::IndelObs ob;
      ob.is_del = (nd.key & KEY_DEL) != 0;
      ob.fwd = (nd.key & KEY_FWD) != 0;
      ob.del_len = ob.is_del ? (int)((nd.key >> 56) & 0x3F) : 0;
      ob.count = nd.count;
      // ob.seq stays empty: aggregate_position never reads it, and only
      // candidate rows (~2%) need it for build_alt_info below
      indels.push_back(std::move(ob));
    }
    nsp::PosResult res;
    int32_t* row_counts = counts + n_out * nsp::NUM_CH;
    nsp::aggregate_position(&singles[(size_t)x * nsp::NUM_SINGLE], indels,
                            ref_seq, ref_len, pos1, snp_min_af, indel_min_af,
                            row_counts, &res, nullptr);
    char ref_base = (char)std::toupper(ref_seq[pos1 - 1]);
    bool cand = nsp::tables().nt4[(uint8_t)ref_base] < 4 && res.pass_af &&
                res.depth >= min_coverage;
    positions[n_out] = pos1;
    depths[n_out] = (int32_t)res.depth;
    afs[n_out] = res.af;
    is_candidate[n_out] = cand ? 1 : 0;
    if (cand) {
      size_t t = 0;
      for (int32_t ni = head[x]; ni >= 0; ni = pool[ni].next, ++t) {
        const ObsNode& nd = pool[ni];
        if (nd.key & KEY_DEL) continue;
        nsp::IndelObs& ob = indels[t];
        if (nd.key & KEY_OVF) {
          ob.seq = ovf[nd.key & 0xFFFFFFFF];
        } else {
          int len = (int)((nd.key >> 56) & 0x3F);
          ob.seq.clear();
          for (int k = 0; k < len; ++k)
            ob.seq += SEQ16_CHAR[(nd.key >> (4 * k)) & 0xF];
        }
      }
      nsp::build_alt_info(&singles[(size_t)x * nsp::NUM_SINGLE], indels,
                          ref_seq, ref_len, pos1, &alt_str);
    }
    int64_t sl = cand ? (int64_t)alt_str.size() : 0;
    alt_off[2 * n_out] = alt_used;
    alt_off[2 * n_out + 1] = alt_used + sl;
    if (sl && alt_used + sl <= alt_cap)
      std::memcpy(alt_buf + alt_used, alt_str.data(), (size_t)sl);
    alt_used += sl;
    ++n_out;
  }
  if (alt_used > alt_cap) return -std::max<int64_t>(alt_used, 1);
  return n_out;
}

// Read matrices at requested positions (see file header). Returns n_reads,
// -(10 + needed) when max_reads is insufficient, or -1/-2 on errors.
int64_t nsp_bam_read_matrices(
    int64_t handle, const char* ref_name,
    const int64_t* positions1, int64_t n_pos,
    int min_mq, int excl_flags,
    int64_t max_reads,
    int32_t* base_out, int32_t* baseq_out, int32_t* mapq_out,
    int32_t* hap_out, int32_t* first_col_out,
    int64_t* readid_out /* may be null: per-row stable record id */,
    int64_t* nonacgt_out /* may be null: count of non-ACGT read bases at
                            requested positions (the reference's
                            base_to_int KeyError trigger,
                            create_pileup_haplotype.py:122) */) {
  if (nonacgt_out) *nonacgt_out = 0;
  OpenBam* b;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_open.find(handle);
    if (it == g_open.end()) return -1;
    b = it->second;
  }
  auto rid = b->ref_ids.find(ref_name);
  if (rid == b->ref_ids.end()) return -2;
  if (n_pos <= 0) return 0;
  int64_t lo = positions1[0] - 1, hi = positions1[n_pos - 1];

  RegionIter iter(b, rid->second, lo, hi);
  if (!iter.ok) return -3;
  BamRecord r;
  int64_t n_reads = 0;
  while (iter.next(&r)) {
    if (r.flag & excl_flags) continue;
    if (r.mapq < min_mq) continue;
    bool fits = n_reads < max_reads;
    bool touched = false;
    int32_t first_col = -1;
    int32_t* brow = nullptr;
    int32_t* qrow = nullptr;
    int32_t* mrow = nullptr;
    if (fits) {
      brow = base_out + n_reads * n_pos;
      qrow = baseq_out + n_reads * n_pos;
      mrow = mapq_out + n_reads * n_pos;
      std::memset(brow, 0, (size_t)n_pos * sizeof(int32_t));
      std::memset(qrow, 0, (size_t)n_pos * sizeof(int32_t));
      std::memset(mrow, 0, (size_t)n_pos * sizeof(int32_t));
    }
    int64_t rpos = r.pos;
    int64_t qpos = 0;
    for (uint32_t ci = 0; ci < r.n_cigar; ++ci) {
      uint32_t c = r.cigar[ci];
      uint32_t op = c & 0xf;
      int64_t ln = c >> 4;
      if (op == OP_M || op == OP_EQ || op == OP_X) {
        const int64_t* it2 = std::lower_bound(positions1, positions1 + n_pos,
                                              rpos + 1);
        for (; it2 < positions1 + n_pos && *it2 <= rpos + ln; ++it2) {
          int64_t col = it2 - positions1;
          int64_t k = *it2 - 1 - rpos;
          int b4 = SEQ16_NT4[seq_base16(r.seq4, qpos + k)];
          if (fits) {
            // non-ACGT read base stays 0 (the reference's base_to_int
            // lookup would throw and poison its whole chunk —
            // create_pileup_haplotype.py:122,213; we keep the site)
            brow[col] = (b4 < 4) ? b4 + 1 : 0;
            if (b4 < 4) {
              qrow[col] = r.qual[qpos + k];
              mrow[col] = r.mapq;
            }
          }
          if (b4 < 4) {
            if (first_col < 0) first_col = (int32_t)col;
            touched = true;
          } else if (nonacgt_out) {
            ++*nonacgt_out;
          }
        }
        rpos += ln;
        qpos += ln;
      } else if (op == OP_D) {
        const int64_t* it2 = std::lower_bound(positions1, positions1 + n_pos,
                                              rpos + 1);
        for (; it2 < positions1 + n_pos && *it2 <= rpos + ln; ++it2) {
          int64_t col = it2 - positions1;
          if (fits) {
            brow[col] = -1;
            mrow[col] = r.mapq;
          }
          if (first_col < 0) first_col = (int32_t)col;
          touched = true;
        }
        rpos += ln;
      } else if (op == OP_N) {
        rpos += ln;
      } else if (op == OP_I || op == OP_S) {
        qpos += ln;
      }
    }
    if (touched) {
      if (fits) {
        int64_t hp = 3;
        int64_t val;
        if (aux_int(r, "HP", &val)) hp = val;
        hap_out[n_reads] = (int32_t)hp;
        first_col_out[n_reads] = first_col;
        if (readid_out) readid_out[n_reads] = (int64_t)iter.last_off;
      }
      ++n_reads;
    }
  }
  if (n_reads > max_reads) return -(10 + n_reads);
  return n_reads;
}


// Write a haplotagged copy of the BAM. read_ids/hps: n pairs of (stable
// record id = inflated-stream offset, HP value 1/2). ref_name limits output
// to one contig's records (header always included); null = whole file.
// Returns number of records written, negative on error.
int64_t nsp_bam_write_tagged(
    int64_t handle, const char* ref_name,
    const int64_t* read_ids, const int32_t* hps, int64_t n,
    const char* out_path) {
  OpenBam* b;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_open.find(handle);
    if (it == g_open.end()) return -1;
    b = it->second;
  }
  int want_ref = -1;
  if (ref_name && ref_name[0]) {
    auto rid = b->ref_ids.find(ref_name);
    if (rid == b->ref_ids.end()) return -2;
    want_ref = rid->second;
  }
  std::unordered_map<uint64_t, int32_t> hp_of;
  hp_of.reserve((size_t)n * 2);
  for (int64_t i = 0; i < n; ++i)
    hp_of[(uint64_t)read_ids[i]] = hps[i];

  FILE* out = std::fopen(out_path, "wb");
  if (!out) return -3;
  BgzfWriter w(out);
  int64_t written = 0;
  bool ok = true;

  // header = inflated bytes before the first indexed record (magic + text +
  // ref list, byte-identical to the source)
  uint64_t hdr_end = b->total_inflated;
  for (const auto& ri : b->index)
    hdr_end = std::min<uint64_t>(hdr_end, ri.off);
  {
    std::vector<uint8_t> hdr;
    uint64_t base = 0;
    if (!fetch_inflated(b, 0, hdr_end, hdr, &base) || base != 0 ||
        hdr.size() < hdr_end) {
      std::fclose(out);
      return -4;
    }
    ok = w.write(hdr.data(), (size_t)hdr_end);
  }

  // stream records in index order, windowed fetches bounded by ~8 MB
  std::vector<uint8_t> rec;
  size_t i0 = 0;
  while (ok && i0 < b->index.size()) {
    if (want_ref >= 0 && b->index[i0].ref_id != want_ref) { ++i0; continue; }
    uint64_t lo = b->index[i0].off;
    size_t i1 = i0;
    uint64_t hi = lo;
    while (i1 < b->index.size() &&
           (want_ref < 0 || b->index[i1].ref_id == want_ref) &&
           b->index[i1].off + b->index[i1].len - lo <= (8u << 20)) {
      hi = std::max<uint64_t>(hi, b->index[i1].off + b->index[i1].len);
      ++i1;
    }
    if (i1 == i0) i1 = i0 + 1, hi = lo + b->index[i0].len;
    std::vector<uint8_t> window;
    uint64_t base = 0;
    if (!fetch_inflated(b, lo, hi, window, &base)) { ok = false; break; }
    for (size_t i = i0; i < i1 && ok; ++i) {
      const RecordIdx& ri = b->index[i];
      if (want_ref >= 0 && ri.ref_id != want_ref) continue;
      uint64_t rel = ri.off - base;
      if (rel + ri.len > window.size()) continue;
      const uint8_t* p = window.data() + rel;
      auto it = hp_of.find(ri.off);
      if (it == hp_of.end()) {
        ok = w.write(p, ri.len);
      } else {
        BamRecord r;
        uint32_t rec_len;
        if (!parse_record(p, ri.len, &r, &rec_len)) continue;
        std::vector<uint8_t> aux = strip_hp_aux(r.aux, r.aux_len);
        size_t fixed = (size_t)(r.aux - (p + 4));   // bytes before aux
        rec.clear();
        rec.resize(4);
        rec.insert(rec.end(), p + 4, p + 4 + fixed);
        rec.insert(rec.end(), aux.begin(), aux.end());
        rec.push_back('H');
        rec.push_back('P');
        rec.push_back('c');
        rec.push_back((uint8_t)(int8_t)it->second);
        uint32_t new_size = (uint32_t)(rec.size() - 4);
        std::memcpy(rec.data(), &new_size, 4);
        ok = w.write(rec.data(), rec.size());
      }
      if (ok) ++written;
    }
    i0 = i1;
  }
  ok = ok && w.finish();
  std::fclose(out);
  if (!ok) { std::remove(out_path); return -5; }
  return written;
}


// Split a haplotagged BAM into h1/h2 copies by the HP aux (reference
// scripts/split_bam_by_tag.py: HP==1 -> h1, HP==2 -> h2, untagged reads
// dropped). ref_name limits to one contig; null = whole file. Returns
// records written (h1 + h2), negative on error.
int64_t nsp_bam_split_by_tag(
    int64_t handle, const char* ref_name,
    const char* h1_path, const char* h2_path) {
  OpenBam* b;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_open.find(handle);
    if (it == g_open.end()) return -1;
    b = it->second;
  }
  int want_ref = -1;
  if (ref_name && ref_name[0]) {
    auto rid = b->ref_ids.find(ref_name);
    if (rid == b->ref_ids.end()) return -2;
    want_ref = rid->second;
  }
  FILE* f1 = std::fopen(h1_path, "wb");
  if (!f1) return -3;
  FILE* f2 = std::fopen(h2_path, "wb");
  if (!f2) { std::fclose(f1); return -3; }
  BgzfWriter w1(f1), w2(f2);
  bool ok = true;
  int64_t written = 0;

  uint64_t hdr_end = b->total_inflated;
  for (const auto& ri : b->index)
    hdr_end = std::min<uint64_t>(hdr_end, ri.off);
  {
    std::vector<uint8_t> hdr;
    uint64_t base = 0;
    ok = fetch_inflated(b, 0, hdr_end, hdr, &base) && base == 0 &&
         hdr.size() >= hdr_end &&
         w1.write(hdr.data(), (size_t)hdr_end) &&
         w2.write(hdr.data(), (size_t)hdr_end);
  }

  size_t i0 = 0;
  while (ok && i0 < b->index.size()) {
    if (want_ref >= 0 && b->index[i0].ref_id != want_ref) { ++i0; continue; }
    uint64_t lo = b->index[i0].off;
    size_t i1 = i0;
    uint64_t hi = lo;
    while (i1 < b->index.size() &&
           (want_ref < 0 || b->index[i1].ref_id == want_ref) &&
           b->index[i1].off + b->index[i1].len - lo <= (8u << 20)) {
      hi = std::max<uint64_t>(hi, b->index[i1].off + b->index[i1].len);
      ++i1;
    }
    if (i1 == i0) i1 = i0 + 1, hi = lo + b->index[i0].len;
    std::vector<uint8_t> window;
    uint64_t base = 0;
    if (!fetch_inflated(b, lo, hi, window, &base)) { ok = false; break; }
    for (size_t i = i0; i < i1 && ok; ++i) {
      const RecordIdx& ri = b->index[i];
      if (want_ref >= 0 && ri.ref_id != want_ref) continue;
      uint64_t rel = ri.off - base;
      if (rel + ri.len > window.size()) continue;
      const uint8_t* p = window.data() + rel;
      BamRecord r;
      uint32_t rec_len;
      if (!parse_record(p, ri.len, &r, &rec_len)) continue;
      int64_t hp;
      if (!aux_int(r, "HP", &hp)) continue;   // untagged: dropped
      if (hp == 1) ok = w1.write(p, ri.len);
      else if (hp == 2) ok = w2.write(p, ri.len);
      else continue;
      if (ok) ++written;
    }
    i0 = i1;
  }
  ok = ok && w1.finish() && w2.finish();
  std::fclose(f1);
  std::fclose(f2);
  if (!ok) { std::remove(h1_path); std::remove(h2_path); return -5; }
  return written;
}

}  // extern "C"
