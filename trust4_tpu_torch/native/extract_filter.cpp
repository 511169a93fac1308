// Native candidate-read filter: exact HasHitInSet against the static
// germline index, plus the low-complexity guard.
//
// Semantics are a line-for-line match of the host implementation in
// trust4_tpu/engine/overlap.py (which itself mirrors the reference's
// SeqSet.hpp:3144-3327 HasHitInSet, :1341-1501 GetHitsFromRead,
// :763-1063 GetOverlapsFromHits, :342-499 LIS, and
// FastqExtractor.cpp:105-134 IsLowComplexity / IsGoodCandidate), so the
// candidate set is bit-identical.  Per-read independence makes the batch
// entry trivially parallel with std::thread (no fork, safe next to JAX).
//
// C ABI only; loaded via ctypes (trust4_tpu/pipeline/extract_native.py).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdlib>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <condition_variable>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

// Work-stealing parallel-for (twin of overlap_engine.cpp steal_for): workers
// grab fixed-size blocks from an atomic cursor so a straggler chunk of
// expensive reads can't idle the other cores.  Caller thread is worker 0.
template <class F>
void steal_for(int n, int n_threads, int block, F&& body) {
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      int lo = next.fetch_add(block, std::memory_order_relaxed);
      if (lo >= n) break;
      int hi = lo + block < n ? lo + block : n;
      body(lo, hi);
    }
  };
  std::vector<std::thread> ts;
  ts.reserve((size_t)(n_threads > 1 ? n_threads - 1 : 0));
  for (int t = 1; t < n_threads; t++) ts.emplace_back(worker);
  worker();
  for (auto& t : ts) t.join();
}

}  // namespace

namespace {

struct Hit {
  int strand_key;  // 0 for strand -1, 1 for +1
  int seq_idx;
  int read_off;
  int seq_off;
  int repeats;
};

struct Coord {
  int read_off;
  int seq_off;
  int diff;
};

struct RC {  // (readOffset, seqOffset) pair in a chain
  int a;
  int b;
  bool operator==(const RC &o) const { return a == o.a && b == o.b; }
};

struct Filter {
  int kmer_len;
  int radius;
  int hit_len_required;
  int n_seqs;
  // code -> postings (seq_idx, offset), insertion order.
  std::unordered_map<uint64_t, std::vector<std::pair<int, int>>> index;
  // Direct-addressed CSR view of `index` (kmer_len <= 12 only; built
  // lazily before the first batch): csr_off[code]..csr_off[code+1] slices
  // csr_posts.  Turns the per-window hash probe into two array reads.
  bool csr_built = false;
  std::vector<int32_t> csr_off;
  std::vector<std::pair<int, int>> csr_posts;
};

void finalize_index(Filter &F) {
  if (F.csr_built) return;
  F.csr_built = true;
  if (F.kmer_len > 12) return;  // 4^k table would exceed 64MB
  size_t slots = (size_t)1 << (2 * F.kmer_len);
  F.csr_off.assign(slots + 1, 0);
  size_t total = 0;
  for (const auto &kv : F.index) {
    F.csr_off[kv.first + 1] = (int32_t)kv.second.size();
    total += kv.second.size();
  }
  for (size_t i = 1; i <= slots; i++) F.csr_off[i] += F.csr_off[i - 1];
  F.csr_posts.resize(total);
  for (const auto &kv : F.index)
    std::copy(kv.second.begin(), kv.second.end(),
              F.csr_posts.begin() + F.csr_off[kv.first]);
}

inline int nuc2num(unsigned char c) {
  switch (c) {
    case 'A': return 0;
    case 'C': return 1;
    case 'G': return 2;
    case 'T': return 3;
    case 'N': return 0;  // reference quirk: N encodes as 0 (defs.h:8-9)
    default: return -1;
  }
}

// Window codes + validity for a sequence (ops/kmer.py semantics: packed
// first-base-high, val = nuc2num & 3, window invalid iff it covers 'N').
void window_codes(const char *s, int len, int k, std::vector<uint64_t> &codes,
                  std::vector<uint8_t> &valid) {
  int n = len - k + 1;
  codes.clear();
  valid.clear();
  if (n <= 0) return;
  codes.resize(n);
  valid.resize(n);
  uint64_t code = 0;
  uint64_t mask = (k >= 32) ? ~uint64_t(0) : ((uint64_t(1) << (2 * k)) - 1);
  int last_n = -1;  // last position holding 'N'
  for (int i = 0; i < len; i++) {
    code = ((code << 2) | uint64_t(nuc2num((unsigned char)s[i]) & 3)) & mask;
    if (s[i] == 'N') last_n = i;
    if (i >= k - 1) {
      codes[i - k + 1] = code;
      valid[i - k + 1] = (last_n < i - k + 1) ? 1 : 0;
    }
  }
}

void revcomp(const char *s, int len, std::string &out) {
  out.resize(len);
  for (int i = 0; i < len; i++) {
    char c = s[len - 1 - i];
    int v = (c >= 'A' && c <= 'Z') ? nuc2num((unsigned char)c) : -1;
    if (c == 'N' || v < 0)
      out[i] = 'N';
    else
      out[i] = "ACGT"[3 - v];
  }
}

inline long iabs(long x) { return x < 0 ? -x : x; }
inline double fabs_(double x) { return x < 0 ? -x : x; }

// ---- LIS (overlap.py:52-146; SeqSet.hpp:342-499) -------------------------

int binary_search_lis(const std::vector<int> &top, int size, int val_a,
                      const std::vector<RC> &hits) {
  int l = 0, r = size - 1;
  while (l <= r) {
    int m = (l + r) / 2;
    if (val_a == hits[top[m]].a) return m;
    if (val_a < hits[top[m]].a)
      r = m - 1;
    else
      l = m + 1;
  }
  return l - 1;
}

void longest_increasing_subsequence(const std::vector<RC> &hits,
                                    std::vector<RC> &out_lis) {
  out_lis.clear();
  int size = (int)hits.size();
  if (size == 0) return;
  double avg_diff = 0.0;
  for (int i = 1; i < size; i++) avg_diff += hits[i].a - hits[i].b;
  avg_diff /= size;

  std::vector<int> top(size, 0), link(size, -1);
  int ret = 1;
  for (int i = 1; i < size; i++) {
    const RC &hi = hits[i];
    int tag;
    if (hits[top[ret - 1]].a <= hi.a)
      tag = ret - 1;
    else
      tag = binary_search_lis(top, ret, hi.a, hits);
    if (tag == -1) {
      top[0] = i;
      link[i] = -1;
    } else if (hi.a > hits[top[tag]].a) {
      if (tag == ret - 1) {
        top[ret] = i;
        ret += 1;
        link[i] = top[tag];
      } else if (hi.a < hits[top[tag + 1]].a) {
        top[tag + 1] = i;
        link[i] = top[tag];
      }
    } else if (hi.a == hits[top[tag]].a) {  // repeats
      if (fabs_(hi.a - hi.b - avg_diff) <
          fabs_(hits[top[tag]].a - hits[top[tag]].b - avg_diff)) {
        top[tag] = i;
        link[i] = tag > 0 ? top[tag - 1] : -1;
      }
    }
  }

  std::vector<RC> lis;
  lis.reserve(ret);
  int k = top[ret - 1];
  for (int t = 0; t < ret; t++) {
    lis.push_back(hits[k]);
    k = link[k];
  }
  for (int a = 0, b = ret - 1; a < b; a++, b--) std::swap(lis[a], lis[b]);

  // Same-seq-offset dedup, keep least divergence.
  std::vector<RC> out;
  out.reserve(ret);
  int i = 0;
  while (i < ret) {
    int j = i + 1;
    while (j < ret && lis[i].b == lis[j].b) j++;
    if (j == i + 1) {
      out.push_back(lis[i]);
    } else {
      int mintag = i;
      double min_diff = fabs_(lis[i].a - lis[i].b - avg_diff);
      for (int l = i + 1; l < j; l++) {
        double d = fabs_(lis[l].a - lis[l].b - avg_diff);
        if (d < min_diff) {
          min_diff = d;
          mintag = l;
        }
      }
      out.push_back(lis[mintag]);
    }
    i = j;
  }
  int out_ret = (int)out.size();

  // Replacement pass (same count, less divergent hits).
  if (out_ret > 0) {
    int a = 0, b = 0;
    while (a < out_ret && b < size) {
      if (hits[b].b < out[a].b) {
        b++;
      } else if (a + 1 < out_ret && out[a + 1].b <= hits[b].b) {
        a++;
      } else if (out[a] == hits[b]) {
        b++;
      } else {
        if (out[a].a <= hits[b].a &&
            (a == out_ret - 1 || hits[b].a < out[a + 1].a) &&
            fabs_(hits[b].a - hits[b].b - avg_diff) <
                fabs_(out[a].a - out[a].b - avg_diff)) {
          out[a] = hits[b];
        }
        b++;
      }
    }
  }
  out_lis = std::move(out);
}

// ---- Overlap construction (overlap.py:309-482) ---------------------------

int total_hit_length_on(const std::vector<int> &offs, int kl) {
  int ret = 0, i = 0, n = (int)offs.size();
  while (i < n) {
    int j = i + 1;
    while (j < n && offs[j] <= offs[j - 1] + kl - 1) j++;
    ret += offs[j - 1] - offs[i] + kl;
    i = j;
  }
  return ret;
}

struct Overlap {
  int match_cnt;
  int strand;
};

// filter_==1 path for an all-ref hit group (single strand+seq bucket).
// Matches overlap.py:322-482 restricted to is_ref seqs.
int get_overlaps_from_hits(const Filter &F, const std::vector<Hit> &hits,
                           int hit_len_required,
                           std::vector<Overlap> &overlaps) {
  int kl = F.kmer_len;
  int hit_size = (int)hits.size();
  int ref_min_hit[2] = {3, 3};
  bool remove_only_repeats[2] = {false, false};

  {
    int i = 0;
    while (i < hit_size) {
      int st = hits[i].strand_key;
      int j = i + 1;
      while (j < hit_size && hits[j].strand_key == st &&
             hits[j].seq_idx == hits[i].seq_idx)
        j++;
      // all seqs are refs: possible_overlap_cnt/longest_hits untouched
      if (!remove_only_repeats[st]) {
        int cnt = 0;
        for (int k = i; k < j; k++)
          if (hits[k].repeats <= 10000) cnt++;
        if (cnt >= 3) remove_only_repeats[st] = true;  // novel_min_hit[st]
      }
      i = j + 1;  // reference quirk: `i = j` inside a `++i` for-loop
    }
  }

  int i = 0;
  while (i < hit_size) {
    int st = hits[i].strand_key;
    int seq_idx = hits[i].seq_idx;
    int j = i + 1;
    while (j < hit_size && hits[j].strand_key == st &&
           hits[j].seq_idx == seq_idx)
      j++;

    int min_hit_required = ref_min_hit[st];
    if (j - i < min_hit_required) {
      i = j;
      continue;
    }
    if (remove_only_repeats[st]) {
      bool has_unique = false;
      for (int k = i; k < j; k++)
        if (hits[k].repeats <= 10000) {
          has_unique = true;
          break;
        }
      if (!has_unique) {
        i = j;
        continue;
      }
    }

    // (readOffset, seqOffset, diff) sorted by (diff, seqOffset, readOffset).
    std::vector<Coord> hcd;
    hcd.reserve(j - i);
    for (int k = i; k < j; k++)
      hcd.push_back({hits[k].read_off, hits[k].seq_off,
                     hits[k].read_off - hits[k].seq_off});
    std::sort(hcd.begin(), hcd.end(), [](const Coord &x, const Coord &y) {
      if (x.diff != y.diff) return x.diff < y.diff;
      if (x.seq_off != y.seq_off) return x.seq_off < y.seq_off;
      return x.read_off < y.read_off;
    });
    int group_n = j - i;
    int adjust_radius = F.radius;  // all seqs are refs

    int s = 0;
    while (s < group_n) {
      int e = s + 1;
      while (e < group_n) {
        int diff = hcd[e].diff - hcd[e - 1].diff;
        if (iabs(diff) > adjust_radius) break;
        e++;
      }

      if (e - s < min_hit_required || (e - s) * kl < hit_len_required) {
        s = e;
        continue;
      }
      if (remove_only_repeats[st]) {
        // Reference quirk: indexes the GLOBAL hit array with group-local
        // positions (SeqSet.hpp:929-935).
        bool has_unique = false;
        int hi = e < hit_size ? e : hit_size;
        for (int k = s; k < hi; k++)
          if (hits[k].repeats <= 10000) {
            has_unique = true;
            break;
          }
        if (!has_unique) {
          s = e;
          continue;
        }
      }

      std::vector<RC> concordant;
      concordant.reserve(e - s);
      for (int k = s; k < e; k++)
        concordant.push_back({hcd[k].read_off, hcd[k].seq_off});
      if (adjust_radius > 0)
        std::sort(concordant.begin(), concordant.end(),
                  [](const RC &x, const RC &y) {
                    if (x.b != y.b) return x.b < y.b;
                    return x.a < y.a;
                  });
      std::vector<RC> lis;
      longest_increasing_subsequence(concordant, lis);
      if ((int)lis.size() * kl < hit_len_required) {
        s = e;
        continue;
      }
      // conservative_chain false, is_long_seq_set false: full chain.
      std::vector<int> read_offs, seq_offs;
      read_offs.reserve(lis.size());
      seq_offs.reserve(lis.size());
      for (const RC &p : lis) {
        read_offs.push_back(p.a);
        seq_offs.push_back(p.b);
      }
      int hit_len = total_hit_length_on(read_offs, kl);
      if (hit_len < hit_len_required) {
        s = e;
        continue;
      }
      if (total_hit_length_on(seq_offs, kl) < hit_len_required) {
        s = e;
        continue;
      }
      overlaps.push_back({2 * hit_len, st == 1 ? 1 : -1});
      s = e;
    }
    i = j;
  }
  return (int)overlaps.size();
}

// ---- HasHitInSet, mode 0, CSR fast path ----------------------------------
// Same decisions as has_hit_in_set below (the oracle for kmer_len > 12):
// direct-addressed postings lookup and flat per-seq counters replace the
// hash probe + std::map bucketing, which dominate extraction wall-clock.

int has_hit_in_set_fast(const Filter &F, const char *read, int len) {
  int kl = F.kmer_len;
  if (len < kl) return 0;

  thread_local std::vector<uint64_t> codes;
  thread_local std::vector<uint8_t> valid;
  thread_local std::string rc;
  thread_local std::vector<Hit> hits[2];  // [strand_key]
  thread_local std::vector<int32_t> cnt, last_ro, touched;
  if ((int)cnt.size() < F.n_seqs) {
    cnt.assign(F.n_seqs, 0);
    last_ro.assign(F.n_seqs, -1);
  }

  int max_cnt[2] = {-1, -1};
  int max_seq[2] = {-1, -1};

  auto scan = [&](const char *s, int slen, int st_key) {
    std::vector<Hit> &hb = hits[st_key];
    hb.clear();
    window_codes(s, slen, kl, codes, valid);
    int n = (int)codes.size();
    uint64_t prev_code = 0;
    touched.clear();
    for (int w = 0; w < n; w++) {
      uint64_t code = codes[w];
      if ((w == 0 || code != prev_code) && valid[w]) {
        int32_t b = F.csr_off[code], e = F.csr_off[code + 1];
        int repeats = e - b;
        for (int32_t t = b; t < e; t++) {
          const auto &p = F.csr_posts[t];
          hb.push_back({st_key, p.first, w, p.second, repeats});
          if (cnt[p.first] == 0) {
            touched.push_back(p.first);
            cnt[p.first] = 1;
            last_ro[p.first] = w;
          } else if (last_ro[p.first] != w) {
            cnt[p.first]++;
            last_ro[p.first] = w;
          }
        }
      }
      prev_code = code;
    }
    // Max read-hit-count bucket; ties keep the smallest seq_idx, matching
    // the oracle's ascending-(strand, seq) map scan with strict '>'.
    for (int32_t sidx : touched) {
      if (cnt[sidx] > max_cnt[st_key] ||
          (cnt[sidx] == max_cnt[st_key] && sidx < max_seq[st_key])) {
        max_cnt[st_key] = cnt[sidx];
        max_seq[st_key] = sidx;
      }
      cnt[sidx] = 0;
      last_ro[sidx] = -1;
    }
  };

  scan(read, len, 1);
  revcomp(read, len, rc);
  scan(rc.c_str(), len, 0);
  if (hits[0].empty() && hits[1].empty()) return 0;

  int hlr = F.hit_len_required;
  thread_local std::vector<Hit> bucket;
  auto chain_bucket = [&](int k, std::vector<Overlap> &ovs) {
    bucket.clear();
    for (const Hit &h : hits[k])
      if (h.seq_idx == max_seq[k]) bucket.push_back(h);
    if (!bucket.empty()) get_overlaps_from_hits(F, bucket, hlr, ovs);
  };

  std::vector<Overlap> overlaps;
  int max_tag;
  if (max_cnt[0] + kl - 1 >= hlr && max_cnt[1] + kl - 1 >= hlr) {
    std::vector<Overlap> tmp0, tmp1;
    chain_bucket(0, tmp0);
    chain_bucket(1, tmp1);
    if (!tmp0.empty() && !tmp1.empty()) {
      if (tmp0[0].match_cnt >= tmp1[0].match_cnt) {
        max_tag = 0;
        overlaps = std::move(tmp0);
      } else {
        max_tag = 1;
        overlaps = std::move(tmp1);
      }
    } else if (!tmp0.empty()) {
      max_tag = 0;
      overlaps = std::move(tmp0);
    } else {
      max_tag = 1;
      overlaps = std::move(tmp1);
    }
  } else {
    max_tag = max_cnt[1] >= max_cnt[0] ? 1 : 0;
    if (max_seq[max_tag] != -1) chain_bucket(max_tag, overlaps);
  }

  if (overlaps.empty()) return 0;
  return max_tag == 0 ? -1 : 1;
}

// ---- HasHitInSet, mode 0 (overlap.py:957-1054) ---------------------------

int has_hit_in_set(const Filter &F, const char *read, int len,
                   std::vector<Hit> &hits_buf) {
  if (!F.csr_off.empty()) return has_hit_in_set_fast(F, read, len);
  int kl = F.kmer_len;
  if (len < kl) return 0;

  // GetHitsFromRead on a ref-only set: skip_limit=0, no down-sampling,
  // barcode=-1 (overlap.py:216-289).
  hits_buf.clear();
  std::vector<uint64_t> codes;
  std::vector<uint8_t> valid;
  std::string rc;
  static const std::vector<std::pair<int, int>> kEmpty;

  auto scan = [&](const char *s, int slen, int st) {
    window_codes(s, slen, kl, codes, valid);
    int n = (int)codes.size();
    uint64_t prev_code = 0;
    for (int w = 0; w < n; w++) {
      uint64_t code = codes[w];
      if (w == 0 || code != prev_code) {
        const std::vector<std::pair<int, int>> *postings = &kEmpty;
        if (valid[w]) {
          auto it = F.index.find(code);
          if (it != F.index.end()) postings = &it->second;
        }
        int repeats = (int)postings->size();
        for (const auto &p : *postings)
          hits_buf.push_back({st == 1 ? 1 : 0, p.first, w, p.second, repeats});
      }
      prev_code = code;
    }
  };

  scan(read, len, 1);
  revcomp(read, len, rc);
  scan(rc.c_str(), len, -1);
  if (hits_buf.empty()) return 0;

  // Bucket per (strand_key, seq), append order preserved.
  std::map<std::pair<int, int>, std::vector<Hit>> buckets;
  for (const Hit &h : hits_buf)
    buckets[{h.strand_key, h.seq_idx}].push_back(h);

  int max_cnt[2] = {-1, -1};
  int max_seq_idx[2] = {-1, -1};
  for (const auto &kv : buckets) {  // std::map: (strand, idx) ascending
    int k = kv.first.first;
    const std::vector<Hit> &bh = kv.second;
    int read_hit_count = 1;
    for (size_t j = 1; j < bh.size(); j++)
      if (bh[j].read_off != bh[j - 1].read_off) read_hit_count++;
    if (read_hit_count > max_cnt[k]) {
      max_cnt[k] = read_hit_count;
      max_seq_idx[k] = kv.first.second;
    }
  }

  int hlr = F.hit_len_required;
  std::vector<Overlap> overlaps;
  int max_tag;
  if (max_cnt[0] + kl - 1 >= hlr && max_cnt[1] + kl - 1 >= hlr) {
    std::vector<Overlap> tmp0, tmp1;
    auto it0 = buckets.find({0, max_seq_idx[0]});
    auto it1 = buckets.find({1, max_seq_idx[1]});
    if (it0 != buckets.end())
      get_overlaps_from_hits(F, it0->second, hlr, tmp0);
    if (it1 != buckets.end())
      get_overlaps_from_hits(F, it1->second, hlr, tmp1);
    if (!tmp0.empty() && !tmp1.empty()) {
      if (tmp0[0].match_cnt >= tmp1[0].match_cnt) {
        max_tag = 0;
        overlaps = std::move(tmp0);
      } else {
        max_tag = 1;
        overlaps = std::move(tmp1);
      }
    } else if (!tmp0.empty()) {
      max_tag = 0;
      overlaps = std::move(tmp0);
    } else {
      max_tag = 1;
      overlaps = std::move(tmp1);
    }
  } else {
    max_tag = max_cnt[1] >= max_cnt[0] ? 1 : 0;
    auto it = buckets.find({max_tag, max_seq_idx[max_tag]});
    if (it != buckets.end())
      get_overlaps_from_hits(F, it->second, hlr, overlaps);
  }

  if (overlaps.empty()) return 0;
  return max_tag == 0 ? -1 : 1;
}

// ---- Low complexity (extract.py:20-39; FastqExtractor.cpp:105-127) -------

bool is_low_complexity(const char *s, int n) {
  long cnt[5] = {0, 0, 0, 0, 0};
  for (int i = 0; i < n; i++) {
    char c = s[i];
    if (c == 'N') {
      cnt[4]++;
    } else {
      int v = nuc2num((unsigned char)c);
      if (v < 0)
        cnt[4]++;  // Python cnt[-1] aliases cnt[4]
      else
        cnt[v]++;
    }
  }
  if (cnt[0] >= n / 2 || cnt[1] >= n / 2 || cnt[2] >= n / 2 ||
      cnt[3] >= n / 2 || cnt[4] >= n / 10)
    return true;
  int low = 0;
  for (int i = 0; i < 4; i++)
    if (cnt[i] <= 2) low++;
  return low >= 2;
}

}  // namespace

extern "C" {

void *t4x_create(int kmer_len, int radius) {
  Filter *F = new Filter;
  F->kmer_len = kmer_len;
  F->radius = radius;
  F->hit_len_required = 31;
  F->n_seqs = 0;
  return F;
}

void t4x_destroy(void *h) { delete (Filter *)h; }

void t4x_set_hit_len(void *h, int hl) {
  ((Filter *)h)->hit_len_required = hl;
}

// Index build matching KmerIndex.build_from_read (ops/kmer_index.py:79-96):
// skip invalid windows; insert when w == 1 or code differs from previous
// position's rolling code (window 0 compares against restart state 0).
void t4x_add_seq(void *h, const char *seq) {
  Filter *F = (Filter *)h;
  int kl = F->kmer_len;
  int sid = F->n_seqs++;
  int len = (int)strlen(seq);
  std::vector<uint64_t> codes;
  std::vector<uint8_t> valid;
  window_codes(seq, len, kl, codes, valid);
  int n = (int)codes.size();
  for (int w = 0; w < n; w++) {
    if (!valid[w]) continue;
    if (w != 1) {
      uint64_t prev = (w == 0) ? 0 : codes[w - 1];
      if (codes[w] == prev) continue;
    }
    F->index[codes[w]].push_back({sid, w});
  }
  F->csr_built = false;
  F->csr_off.clear();
  F->csr_posts.clear();
}

// out[i] = 0 if read i is not a candidate (low-complexity or no chained
// hit), else the HasHitInSet strand (-1 / 1).
void t4x_filter_batch(void *h, const char **reads, const int *lens, int n,
                      int threads, int8_t *out) {
  Filter *F = (Filter *)h;
  finalize_index(*F);
  auto work = [&](int lo, int hi) {
    std::vector<Hit> buf;
    for (int i = lo; i < hi; i++) {
      if (is_low_complexity(reads[i], lens[i])) {
        out[i] = 0;
        continue;
      }
      out[i] = (int8_t)has_hit_in_set(*F, reads[i], lens[i], buf);
    }
  };
  if (threads <= 1 || n < 64) {
    work(0, n);
    return;
  }
  steal_for(n, threads, 256, [&](int lo, int hi) { work(lo, hi); });
}

// Build the index's lookup table now rather than at the first query.
void t4x_finalize(void *h) { finalize_index(*(Filter *)h); }

// The index's direct-addressed tables, for a copy to the card
// (csrc/extract_filter.cuh Tables): 4^k + 1 int32 starts and the int32
// (sequence, offset) pairs they slice, and meta = {k, radius, hit length,
// sequences}.  Returns 0, or -1 when the index has no such tables (k > 12)
// or a k-mer's postings are not grouped by ascending sequence, which the
// card's kernel relies on (t4x_add_seq appends them so).
int t4x_csr_view(void *h, const int32_t **off, int64_t *n_off,
                 const int32_t **posts, int64_t *n_posts, int32_t *meta) {
  Filter *F = (Filter *)h;
  finalize_index(*F);
  if (F->csr_off.empty()) return -1;
  for (size_t c = 0; c + 1 < F->csr_off.size(); c++)
    for (int32_t t = F->csr_off[c] + 1; t < F->csr_off[c + 1]; t++)
      if (F->csr_posts[t].first < F->csr_posts[t - 1].first) return -1;
  static_assert(sizeof(std::pair<int, int>) == 2 * sizeof(int32_t),
                "postings are int32 pairs");
  *off = F->csr_off.data();
  *n_off = (int64_t)F->csr_off.size();
  *posts = reinterpret_cast<const int32_t *>(F->csr_posts.data());
  *n_posts = (int64_t)F->csr_posts.size();
  meta[0] = F->kmer_len;
  meta[1] = F->radius;
  meta[2] = F->hit_len_required;
  meta[3] = F->n_seqs;
  return 0;
}

// Raw HasHitInSet without the low-complexity guard (for parity tests).
int t4x_has_hit(void *h, const char *read, int len) {
  finalize_index(*(Filter *)h);
  std::vector<Hit> buf;
  return has_hit_in_set(*(Filter *)h, read, len, buf);
}

int t4x_is_low_complexity(const char *s, int n) {
  return is_low_complexity(s, n) ? 1 : 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Full streaming extraction loop (reference: FastqExtractor.cpp:549-724
// batched flow; reader semantics: trust4_tpu/io/fastx.py / ReadFiles.hpp).
// Reads FASTQ/FASTA(.gz) record streams, applies the candidate test
// (either mate good => keep, short-circuit order FastqExtractor.cpp:471-477)
// with std::thread batches, and writes survivors in input order — no
// per-record Python work, which is what made the host extractor flat
// across -t.
// ---------------------------------------------------------------------------

#include <zlib.h>

namespace {

struct Rec {
  std::string id;
  std::string seq;
  std::string qual;  // empty => FASTA record
  bool has_qual = false;
};

// Buffered line reader over gzFile (zlib reads plain files transparently).
struct LineReader {
  gzFile f = nullptr;
  std::vector<char> buf;
  size_t pos = 0, avail = 0;
  bool eof_ = false;

  bool open(const char *path) {
    f = gzopen(path, "rb");
    if (!f) return false;
    gzbuffer(f, 1 << 20);
    buf.resize(1 << 20);
    pos = avail = 0;
    eof_ = false;
    return true;
  }
  void close() {
    if (f) gzclose(f);
    f = nullptr;
  }
  // Next line without the trailing '\n' (keeps '\r'; callers strip like
  // the Python reader).  Returns false at EOF.
  bool next(std::string &line) {
    line.clear();
    for (;;) {
      if (pos >= avail) {
        if (eof_) return !line.empty();
        int n = gzread(f, buf.data(), (unsigned)buf.size());
        if (n <= 0) {
          eof_ = true;
          return !line.empty();
        }
        avail = (size_t)n;
        pos = 0;
      }
      char *start = buf.data() + pos;
      char *nl = (char *)memchr(start, '\n', avail - pos);
      if (nl) {
        line.append(start, nl - start);
        pos = (nl - buf.data()) + 1;
        return true;
      }
      line.append(start, avail - pos);
      pos = avail;
    }
  }
};

inline void rstrip_crlf(std::string &s) {
  while (!s.empty() && (s.back() == '\n' || s.back() == '\r')) s.pop_back();
}

inline void strip_ws(std::string &s) {
  size_t b = 0, e = s.size();
  auto isws = [](char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' ||
           c == '\f';
  };
  while (b < e && isws(s[b])) b++;
  while (e > b && isws(s[e - 1])) e--;
  if (b > 0 || e < s.size()) s = s.substr(b, e - b);
}

// Header token up to first space/tab, '/1'/'/2' suffix stripped
// (io/fastx.py:31-49; ReadFiles.hpp:179-185).
inline void parse_id(const std::string &line, std::string &id) {
  size_t end = line.size();
  // line excludes '\n'; drop trailing '\r' like rstrip
  while (end > 1 && (line[end - 1] == '\r')) end--;
  size_t i = 1;
  size_t stop = end;
  for (size_t j = 1; j < end; j++) {
    if (line[j] == ' ' || line[j] == '\t') {
      stop = j;
      break;
    }
  }
  id.assign(line, i, stop - i);
  size_t n = id.size();
  if (n >= 2 && id[n - 2] == '/' && (id[n - 1] == '1' || id[n - 1] == '2'))
    id.resize(n - 2);
}

// Multi-file record stream (files chain transparently, io/fastx.py:77-82).
struct RecStream {
  std::vector<std::string> paths;
  size_t at = 0;
  LineReader rd;
  std::string line;
  bool have_line = false;
  bool open_ok = true;

  explicit RecStream(const char *joined) {
    const char *p = joined;
    while (p && *p) {
      const char *nl = strchr(p, '\n');
      if (nl) {
        if (nl > p) paths.emplace_back(p, nl - p);
        p = nl + 1;
      } else {
        paths.emplace_back(p);
        break;
      }
    }
    advance_file();
  }
  ~RecStream() { rd.close(); }

  void advance_file() {
    rd.close();
    have_line = false;
    while (at < paths.size()) {
      if (rd.open(paths[at].c_str())) {
        at++;
        have_line = rd.next(line);
        return;
      }
      open_ok = false;
      at++;
    }
  }

  bool next(Rec &r) {
    for (;;) {
      if (!have_line) {
        if (at >= paths.size()) return false;
        advance_file();
        if (!have_line) {
          if (at >= paths.size()) return false;
          continue;
        }
      }
      if (!line.empty() && line[0] == '@') {
        parse_id(line, r.id);
        if (!rd.next(r.seq)) r.seq.clear();
        strip_ws(r.seq);
        std::string plus;
        rd.next(plus);  // '+'
        if (!rd.next(r.qual)) r.qual.clear();
        rstrip_crlf(r.qual);
        r.has_qual = true;
        have_line = rd.next(line);
        if (!have_line && at < paths.size()) advance_file();
        return true;
      } else if (!line.empty() && line[0] == '>') {
        parse_id(line, r.id);
        r.seq.clear();
        std::string part;
        for (;;) {
          have_line = rd.next(line);
          if (!have_line) {
            if (at < paths.size()) {
              advance_file();
              // Python treats each file independently; a FASTA record
              // never spans files.
            }
            break;
          }
          if (!line.empty() && (line[0] == '>' || line[0] == '@')) break;
          part = line;
          strip_ws(part);
          r.seq += part;
        }
        r.qual.clear();
        r.has_qual = false;
        return true;
      } else {
        have_line = rd.next(line);
        if (!have_line && at < paths.size()) advance_file();
      }
    }
  }
};

void write_rec(FILE *out, const Rec &r) {
  if (r.has_qual) {
    fputc('@', out);
    fwrite(r.id.data(), 1, r.id.size(), out);
    fputc('\n', out);
    fwrite(r.seq.data(), 1, r.seq.size(), out);
    fwrite("\n+\n", 1, 3, out);
    fwrite(r.qual.data(), 1, r.qual.size(), out);
    fputc('\n', out);
  } else {
    fputc('>', out);
    fwrite(r.id.data(), 1, r.id.size(), out);
    fputc('\n', out);
    fwrite(r.seq.data(), 1, r.seq.size(), out);
    fputc('\n', out);
  }
}

// The stream's phases (read, filter, write, and the bulk stream's wait for
// a read batch): each lap() adds the time since the previous one to a
// phase, so a batch costs a clock read a phase.  steady_clock is
// CLOCK_MONOTONIC on Linux, the clock of Python's time.perf_counter().
struct PhaseClock {
  int64_t ns[4] = {0, 0, 0, 0};
  int64_t t = now();
  static int64_t now() {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
  }
  void lap(int phase) {
    int64_t t1 = now();
    ns[phase] += t1 - t;
    t = t1;
  }
  void report(int64_t *out, int n = 3) const {
    if (out)
      for (int i = 0; i < n; i++) out[i] = ns[i];
  }
};

// The bulk stream's read side: one thread fills a ring of two batch slots
// (records parsed into a slot's strings in place, never copied) while the
// caller filters and writes the other.  A slot with n == 0 ends the
// stream; the reader publishes it and returns.  Two slots, not more: a
// slot's first fill touches fresh memory and costs several times a
// refill, so each further slot adds a slow fill at the stream's start.
struct ReadAhead {
  static const int BATCH = 16384, SLOTS = 2;
  struct Slot {
    std::vector<Rec> b1, b2;
    int n = 0;
  };
  RecStream &s1;
  RecStream *s2;
  Slot ring[SLOTS];
  std::mutex mu;
  std::condition_variable cv;
  int64_t filled = 0, taken = 0;  // slots published / handed back
  bool stop = false;
  int64_t busy_ns = 0;  // the reader's own time
  std::thread th;

  ReadAhead(RecStream &a, RecStream *b) : s1(a), s2(b) {
    th = std::thread([this] { run(); });
  }
  ~ReadAhead() { join(); }

  // Stops the reader (it returns at its next wait) and joins it; returns
  // its busy time.
  int64_t join() {
    {
      std::lock_guard<std::mutex> g(mu);
      stop = true;
    }
    cv.notify_all();
    if (th.joinable()) th.join();
    return busy_ns;
  }

  void run() {
    for (int64_t k = 0;; k++) {
      {
        std::unique_lock<std::mutex> g(mu);
        cv.wait(g, [&] { return stop || k - taken < SLOTS; });
        if (stop) return;
      }
      int64_t t0 = PhaseClock::now();
      Slot &s = ring[k % SLOTS];
      if (k < SLOTS) {  // a slot's records are made at its first use
        s.b1.resize(BATCH);
        if (s2) s.b2.resize(BATCH);
      }
      int n = 0;
      while (n < BATCH && s1.next(s.b1[n])) {
        if (s2 && !s2->next(s.b2[n])) break;  // ragged pair -> stop like zip()
        n++;
      }
      s.n = n;
      busy_ns += PhaseClock::now() - t0;
      {
        std::lock_guard<std::mutex> g(mu);
        filled = k + 1;
      }
      cv.notify_all();
      if (n == 0) return;
    }
  }
  // Batch k, once the reader has filled it.
  Slot &wait(int64_t k) {
    std::unique_lock<std::mutex> g(mu);
    cv.wait(g, [&] { return filled > k; });
    return ring[k % SLOTS];
  }
  // Batch k's slot back to the reader.
  void release(int64_t k) {
    {
      std::lock_guard<std::mutex> g(mu);
      taken = k + 1;
    }
    cv.notify_all();
  }
};

}  // namespace

extern "C" {

// A batch decider for the bulk stream: what decides a batch's reads in
// place of the threads (the card, csrc/extract_filter.cu
// t4_extract_decide).  The stream packs up to reads_cap reads, their
// bases back to back into bases (bases_cap bytes) and their n + 1 starts
// into offs, calls decide(ctx, n, bases used), and reads out[i]: 0 (not
// a candidate), -1 or 1 (the HasHitInSet strand) or T4X_UNDECIDED (a cap
// of the decider's; the stream decides that read itself).  decide returns
// 0, or nonzero to end the stream with -2.
struct t4x_decider {
  int (*decide)(void *ctx, int n, int64_t n_bases);
  void *ctx;
  uint8_t *bases;
  int64_t bases_cap;
  int32_t *offs;
  int8_t *out;
  int32_t reads_cap;
};

}  // extern "C"

namespace {

const int8_t T4X_UNDECIDED = 2;

// The candidate test of a batch's n reads (and their mates) through a
// decider: every read goes to it in chunks that fit its staging, a read
// it leaves undecided (or that alone exceeds its staging) is decided
// here on `threads` workers, and good[i] takes today's mate rule: the
// mate counts only when the first read fails.  decided[0] and [1] count
// the tests the rule makes (every first read, and the mates it reaches)
// that the decider and this side decided.  Returns 0, or the decider's
// nonzero return.
int decide_batch(const Filter &F, const t4x_decider &D,
                 const std::vector<Rec> &b1, const std::vector<Rec> *b2,
                 int n, int threads, std::vector<int8_t> &dec,
                 std::vector<int8_t> &good, int64_t *decided) {
  const int total = b2 ? 2 * n : n;
  auto seq_of = [&](int i) -> const std::string & {
    return i < n ? b1[i].seq : (*b2)[i - n].seq;
  };
  dec.resize(total);
  for (int i = 0; i < total;) {
    int m = 0;
    int64_t used = 0;
    D.offs[0] = 0;
    while (i + m < total && m < D.reads_cap) {
      const std::string &s = seq_of(i + m);
      if (used + (int64_t)s.size() > D.bases_cap) break;
      memcpy(D.bases + used, s.data(), s.size());
      used += (int64_t)s.size();
      D.offs[++m] = (int32_t)used;
    }
    if (m == 0) {  // one read longer than the staging
      dec[i++] = T4X_UNDECIDED;
      continue;
    }
    int rc = D.decide(D.ctx, m, used);
    if (rc != 0) return rc;
    memcpy(dec.data() + i, D.out, (size_t)m);
    i += m;
  }
  // Undecided first reads, then the undecided mates the rule reaches.
  std::vector<int> todo;
  int64_t tested = n, on_this_side = 0;
  auto on_host = [&]() {
    auto work = [&](int lo, int hi) {
      std::vector<Hit> buf;
      for (int t = lo; t < hi; t++) {
        const std::string &s = seq_of(todo[t]);
        int8_t g = 0;
        if (!is_low_complexity(s.data(), (int)s.size()))
          g = (int8_t)has_hit_in_set(F, s.data(), (int)s.size(), buf);
        dec[todo[t]] = g;
      }
    };
    int m = (int)todo.size();
    if (threads <= 1 || m < 64)
      work(0, m);
    else
      steal_for(m, threads, 16, work);
    on_this_side += m;
  };
  for (int i = 0; i < n; i++)
    if (dec[i] == T4X_UNDECIDED) todo.push_back(i);
  on_host();
  if (b2) {
    todo.clear();
    for (int i = 0; i < n; i++) {
      if (dec[i]) continue;
      tested++;
      if (dec[n + i] == T4X_UNDECIDED) todo.push_back(n + i);
    }
    on_host();
  }
  decided[0] += tested - on_this_side;
  decided[1] += on_this_side;
  for (int i = 0; i < n; i++)
    good[i] = dec[i] ? dec[i] : (b2 ? dec[n + i] : 0);
  return 0;
}

}  // namespace

extern "C" {

// Stream paths1 (newline-joined; paths2 NULL or same count for paired),
// filter with the existing handle's index (candidate = either mate passes,
// mate tested only when the first fails), write survivors in input order
// to out1/out2.  Returns candidate count, -1 on I/O failure, or -2 when
// the decider failed.  A reader thread inflates and parses batch k+1
// while batch k is filtered: by `threads` workers, or with a decider
// (NULL: none) by it, the calling thread packing its batches and
// deciding what it leaves undecided (decide_batch).  phase_ns (NULL or 4
// slots) receives the nanoseconds spent reading (opening, then the reader
// thread's inflating and parsing), filtering (threads, or the decider
// with its packing), writing (closing included) and, on the calling
// thread, waiting for a read batch (the opening included): the calling
// thread's time is the last three.  decided (NULL or 2 slots) receives
// the candidate tests the mate rule made that the decider decided and
// that this side decided (all of them without a decider).
int64_t t4x_extract_stream(void *h, const char *paths1, const char *paths2,
                           const char *out1, const char *out2, int threads,
                           int64_t *phase_ns, const t4x_decider *decider,
                           int64_t *decided) {
  Filter *F = (Filter *)h;
  finalize_index(*F);
  PhaseClock clock;
  RecStream s1(paths1);
  RecStream *s2 = paths2 && paths2[0] ? new RecStream(paths2) : nullptr;
  if (!s1.open_ok || (s2 && !s2->open_ok)) {
    delete s2;
    return -1;
  }
  FILE *o1 = fopen(out1, "w");
  FILE *o2 = s2 ? fopen(out2, "w") : nullptr;
  if (!o1 || (s2 && !o2)) {
    if (o1) fclose(o1);
    if (o2) fclose(o2);
    delete s2;
    return -1;
  }
  clock.lap(3);
  int64_t open_ns = clock.ns[3];

  std::vector<int8_t> good(ReadAhead::BATCH), dec;
  int64_t kept = 0, counts[2] = {0, 0};
  int failed = 0;
  ReadAhead ra(s1, s2);

  for (int64_t k = 0;; k++) {
    ReadAhead::Slot &slot = ra.wait(k);
    clock.lap(3);
    int n = slot.n;
    if (n == 0) break;
    const std::vector<Rec> &b1 = slot.b1, &b2 = slot.b2;

    if (decider) {
      failed = decide_batch(*F, *decider, b1, s2 ? &b2 : nullptr, n,
                            threads, dec, good, counts);
      if (failed) break;
    } else {
      std::atomic<int64_t> mates{0};
      auto work = [&](int lo, int hi) {
        std::vector<Hit> buf;
        int64_t tested = 0;
        for (int i = lo; i < hi; i++) {
          const Rec &r = b1[i];
          int8_t g = 0;
          if (!is_low_complexity(r.seq.data(), (int)r.seq.size()))
            g = (int8_t)has_hit_in_set(*F, r.seq.data(), (int)r.seq.size(),
                                       buf);
          if (!g && s2) {
            tested++;
            const Rec &m = b2[i];
            if (!is_low_complexity(m.seq.data(), (int)m.seq.size()))
              g = (int8_t)has_hit_in_set(*F, m.seq.data(),
                                         (int)m.seq.size(), buf);
          }
          good[i] = g;
        }
        mates += tested;
      };
      if (threads <= 1 || n < 64) {
        work(0, n);
      } else {
        steal_for(n, threads, 256, [&](int lo, int hi) { work(lo, hi); });
      }
      counts[1] += n + mates.load();
    }
    clock.lap(1);

    for (int i = 0; i < n; i++) {
      if (!good[i]) continue;
      write_rec(o1, b1[i]);
      if (s2) write_rec(o2, b2[i]);
      kept++;
    }
    ra.release(k);
    clock.lap(2);
  }
  clock.ns[0] = open_ns + ra.join();
  clock.lap(3);

  fclose(o1);
  if (o2) fclose(o2);
  delete s2;
  clock.lap(2);
  clock.report(phase_ns, 4);
  if (decided) {
    decided[0] = counts[0];
    decided[1] = counts[1];
  }
  return failed ? -2 : kept;
}

}  // extern "C"

// ---- Barcoded extraction stream (FastqExtractor.cpp:407-545 flow) --------
//
// The common single-cell case (sequence-sourced --readFormat segments, no
// whitelist/translate) runs fully native; pipeline/extract.py keeps the
// Python loop for comment-sourced formats and correction.  Segments
// arrive flattened as (cat, start, end, strand) int32 rows; extraction
// reproduces ReadFormatter.extract exactly (negative offsets from the
// end, clamp, concat, whole-buffer reverse(+complement for sequence)
// when any segment is minus-strand).

namespace {

struct FmtSeg {
  int start, end, strand;
};

struct Fmt {
  std::vector<FmtSeg> segs[4];
  bool need(int cat) const {
    const auto &v = segs[cat];
    if (v.empty()) return false;
    if (v.size() == 1 && v[0].start == 0 && v[0].end == -1 &&
        v[0].strand == 1)
      return false;
    return true;
  }
  // ReadFormatter.hpp:288-405 (sequence-sourced only).
  void extract(const std::string &seq, int cat, bool need_complement,
               std::string &out) const {
    if (!need(cat)) {
      out = seq;
      return;
    }
    out.clear();
    int len = (int)seq.size();
    int strand = 1;
    for (const FmtSeg &g : segs[cat]) {
      int start = g.start, end = g.end;
      if (start < 0) start = len + start;
      if (end >= len)
        end = len - 1;
      else if (end < 0)
        end = len + end;
      // Reads shorter than a negative --readFormat offset can leave
      // start/end negative even after the one adjustment above.  The
      // reference reads out of bounds there; our contract is the Python
      // oracle's slice semantics seq[start:end+1] — one more negative
      // wrap, then clamp to the read (ADVICE r4;
      // tests/test_extract_bc_native.py short-read cases).
      long s = start, e = (long)end + 1;
      if (s < 0) { s += len; if (s < 0) s = 0; }
      if (e < 0) { e += len; if (e < 0) e = 0; }
      if (e > len) e = len;
      if (e > s)
        out.append(seq, (size_t)s, (size_t)(e - s));
      if (g.strand == -1) strand = -1;
    }
    if (strand == -1) {
      std::reverse(out.begin(), out.end());
      if (need_complement)
        for (char &c : out) {
          switch (c) {
            case 'A': c = 'T'; break;
            case 'C': c = 'G'; break;
            case 'G': c = 'C'; break;
            case 'T': c = 'A'; break;
            default: c = 'N';
          }
        }
    }
  }
};

void write_formatted(FILE *out, const std::string &id, const Rec &r,
                     const Fmt &F, int cat, std::string &sbuf,
                     std::string &qbuf) {
  F.extract(r.seq, cat, true, sbuf);
  if (r.has_qual) {
    F.extract(r.qual, cat, false, qbuf);
    fputc('@', out);
    fwrite(id.data(), 1, id.size(), out);
    fputc('\n', out);
    fwrite(sbuf.data(), 1, sbuf.size(), out);
    fwrite("\n+\n", 1, 3, out);
    fwrite(qbuf.data(), 1, qbuf.size(), out);
    fputc('\n', out);
  } else {
    fputc('>', out);
    fwrite(id.data(), 1, id.size(), out);
    fputc('\n', out);
    fwrite(sbuf.data(), 1, sbuf.size(), out);
    fputc('\n', out);
  }
}

// 4-ary whitelist trie with single-substitution correction
// (BarcodeCorrector.hpp; pipeline/barcode.py BarcodeCorrector is the
// oracle — including its quirks: the quality tiebreak indexes the RAW
// barcode-record quality with the EXTRACTED barcode's position, ties
// without quality keep the first candidate).
struct BcTrie {
  struct Node {
    int32_t next[4] = {-1, -1, -1, -1};
    int64_t count = 0;
    bool end = false;
  };
  std::vector<Node> nodes;
  BcTrie() { nodes.emplace_back(); }
  static inline int tag(char c) {
    switch (c) {
      case 'A': return 0;
      case 'C': return 1;
      case 'G': return 2;
      case 'T': return 3;
    }
    return -1;
  }
  void insert(const char *s, int len, int weight) {
    for (int i = 0; i < len; i++)
      if (tag(s[i]) < 0) return;
    int p = 0;
    for (int i = 0; i < len; i++) {
      int t = tag(s[i]);
      if (nodes[p].next[t] < 0) {
        nodes[p].next[t] = (int32_t)nodes.size();
        nodes.emplace_back();
      }
      p = nodes[p].next[t];
    }
    nodes[p].end = true;
    nodes[p].count += weight;
  }
  // -1 when absent, else the (possibly updated) count.
  int64_t search_update(const char *s, int len, int weight) {
    int p = 0;
    for (int i = 0; i < len; i++) {
      int t = tag(s[i]);
      if (t < 0 || nodes[p].next[t] < 0) return -1;
      p = nodes[p].next[t];
    }
    nodes[p].count += weight;
    return nodes[p].count;
  }
  // pipeline/barcode.py BarcodeCorrector.correct: returns -1/0/1 and
  // writes the corrected barcode into bc in place.
  int correct(std::string &bc, const std::string &qual, bool has_qual) {
    if (search_update(bc.data(), (int)bc.size(), 0) != -1) return 0;
    int best_i = -1, best_j = -1;
    int64_t best_cnt = -1;
    int best_low_qual = 255;
    static const char *ACGT = "ACGT";
    std::string test = bc;
    for (int i = 0; i < (int)bc.size(); i++) {
      char orig = bc[i];
      for (int j = 0; j < 4; j++) {
        if (ACGT[j] == orig) continue;
        test[i] = ACGT[j];
        int64_t cnt = search_update(test.data(), (int)test.size(), 0);
        if (cnt != -1) {
          if (cnt > best_cnt) {
            best_cnt = cnt;
            best_i = i;
            best_j = j;
            if (has_qual && i < (int)qual.size())
              best_low_qual = (unsigned char)qual[i];
          } else if (cnt == best_cnt && has_qual && i < (int)qual.size() &&
                     (unsigned char)qual[i] < best_low_qual) {
            best_low_qual = (unsigned char)qual[i];
            best_i = i;
            best_j = j;
          }
        }
      }
      test[i] = orig;
    }
    if (best_i < 0) return -1;
    bc[best_i] = ACGT[best_j];
    return 1;
  }
};

}  // namespace

extern "C" {

void *t4x_bc_create() { return new BcTrie(); }
void t4x_bc_destroy(void *h) { delete (BcTrie *)h; }

// Load whitelist entries (newline-joined blob; caller handles gzip).
void t4x_bc_load(void *h, const char *blob, int64_t blen) {
  BcTrie *T = (BcTrie *)h;
  const char *p = blob;
  const char *end = blob + blen;
  while (p < end) {
    const char *nl = (const char *)memchr(p, '\n', end - p);
    const char *e = nl ? nl : end;
    while (e > p && (e[-1] == '\r' || e[-1] == ' ')) e--;
    if (e > p) T->insert(p, (int)(e - p), 1);
    p = nl ? nl + 1 : end;
  }
}

// First case_cnt observed (extracted) barcodes feed the frequency
// counts (BarcodeCorrector.hpp:134-147).  fmt_rows as in
// t4x_extract_stream_bc.  Returns records consumed or -1 on I/O error.
int64_t t4x_bc_collect_background(void *h, const char *bc_paths,
                                  const int32_t *fmt_rows, int n_segs,
                                  int64_t case_cnt) {
  BcTrie *T = (BcTrie *)h;
  Fmt fmt;
  for (int i = 0; i < n_segs; i++) {
    const int32_t *r = fmt_rows + 4 * i;
    if (r[0] < 0 || r[0] > 3) return -1;
    fmt.segs[r[0]].push_back({r[1], r[2], r[3]});
  }
  RecStream sb(bc_paths);
  if (!sb.open_ok) return -1;
  Rec r;
  std::string bcbuf;
  int64_t n = 0;
  while (n < case_cnt && sb.next(r)) {
    fmt.extract(r.seq, 2, true, bcbuf);
    T->search_update(bcbuf.data(), (int)bcbuf.size(), 1);
    n++;
  }
  return n;
}

// Whitelist-corrected variant of t4x_extract_stream_bc: corr is a
// BcTrie handle (may be NULL = no correction).  Uncorrectable barcodes
// write "missing_barcode" (skip_err != 0 drops the read instead),
// exactly as pipeline/extract.py output_barcode.
int64_t t4x_extract_stream_bc2(void *h, const char *paths1,
                               const char *paths2, const char *bc_paths,
                               const char *umi_paths, int umi_alias,
                               const char *out1, const char *out2,
                               const char *out_bc, const char *out_umi,
                               const int32_t *fmt_rows, int n_segs,
                               int threads, void *corr, int skip_err,
                               int64_t *phase_ns);

// Returns the candidate count, or -1 on I/O failure.  umi_alias != 0
// means the UMI record IS the barcode record (same file, different
// format slice); fmt_rows = (n_segs, 4) int32 {cat, start, end, strand}.
int64_t t4x_extract_stream_bc(void *h, const char *paths1,
                              const char *paths2, const char *bc_paths,
                              const char *umi_paths, int umi_alias,
                              const char *out1, const char *out2,
                              const char *out_bc, const char *out_umi,
                              const int32_t *fmt_rows, int n_segs,
                              int threads) {
  return t4x_extract_stream_bc2(h, paths1, paths2, bc_paths, umi_paths,
                                umi_alias, out1, out2, out_bc, out_umi,
                                fmt_rows, n_segs, threads, nullptr, 0,
                                nullptr);
}

int64_t t4x_extract_stream_bc2(void *h, const char *paths1,
                               const char *paths2, const char *bc_paths,
                               const char *umi_paths, int umi_alias,
                               const char *out1, const char *out2,
                               const char *out_bc, const char *out_umi,
                               const int32_t *fmt_rows, int n_segs,
                               int threads, void *corr, int skip_err,
                               int64_t *phase_ns) {
  Filter *F = (Filter *)h;
  BcTrie *C = (BcTrie *)corr;
  finalize_index(*F);
  PhaseClock clock;
  Fmt fmt;
  for (int i = 0; i < n_segs; i++) {
    const int32_t *r = fmt_rows + 4 * i;
    if (r[0] < 0 || r[0] > 3) return -1;
    fmt.segs[r[0]].push_back({r[1], r[2], r[3]});
  }
  RecStream s1(paths1);
  RecStream *s2 = paths2 && paths2[0] ? new RecStream(paths2) : nullptr;
  RecStream *sb = bc_paths && bc_paths[0] ? new RecStream(bc_paths) : nullptr;
  RecStream *su = (!umi_alias && umi_paths && umi_paths[0])
                      ? new RecStream(umi_paths)
                      : nullptr;
  bool want_umi = umi_alias || su;
  auto cleanup = [&]() {
    delete s2;
    delete sb;
    delete su;
  };
  if (!s1.open_ok || (s2 && !s2->open_ok) || (sb && !sb->open_ok) ||
      (su && !su->open_ok)) {
    cleanup();
    return -1;
  }
  FILE *o1 = fopen(out1, "w");
  FILE *o2 = s2 ? fopen(out2, "w") : nullptr;
  FILE *ob = sb ? fopen(out_bc, "w") : nullptr;
  FILE *ou = want_umi ? fopen(out_umi, "w") : nullptr;
  if (!o1 || (s2 && !o2) || (sb && !ob) || (want_umi && !ou)) {
    if (o1) fclose(o1);
    if (o2) fclose(o2);
    if (ob) fclose(ob);
    if (ou) fclose(ou);
    cleanup();
    return -1;
  }

  const int BATCH = 16384;
  std::vector<Rec> b1(BATCH), b2(s2 ? BATCH : 0), bb(sb ? BATCH : 0),
      bu(su ? BATCH : 0);
  std::vector<int8_t> good(BATCH);
  int64_t kept = 0;
  std::string sbuf, qbuf, bcbuf;

  for (;;) {
    int n = 0;
    while (n < BATCH && s1.next(b1[n])) {
      if (s2 && !s2->next(b2[n])) break;  // stop at shortest, like zip()
      if (sb && !sb->next(bb[n])) break;
      if (su && !su->next(bu[n])) break;
      n++;
    }
    clock.lap(0);
    if (n == 0) break;

    auto work = [&](int lo, int hi) {
      std::vector<Hit> buf;
      for (int i = lo; i < hi; i++) {
        const Rec &r = b1[i];
        int8_t g = 0;
        if (!is_low_complexity(r.seq.data(), (int)r.seq.size()))
          g = (int8_t)has_hit_in_set(*F, r.seq.data(), (int)r.seq.size(),
                                     buf);
        if (!g && s2) {
          const Rec &m = b2[i];
          if (!is_low_complexity(m.seq.data(), (int)m.seq.size()))
            g = (int8_t)has_hit_in_set(*F, m.seq.data(),
                                       (int)m.seq.size(), buf);
        }
        if (g && sb) {
          // Barcode==read artifact guard (FastqExtractor.cpp:520-526).
          const Rec &rb = bb[i];
          if ((rb.seq == r.seq || (s2 && rb.seq == b2[i].seq)) &&
              is_low_complexity(rb.seq.data(), (int)rb.seq.size()))
            g = 0;
        }
        good[i] = g;
      }
    };
    if (threads <= 1 || n < 64) {
      work(0, n);
    } else {
      steal_for(n, threads, 256, [&](int lo, int hi) { work(lo, hi); });
    }
    clock.lap(1);

    for (int i = 0; i < n; i++) {
      if (!good[i]) continue;
      const std::string &id = b1[i].id;
      if (sb) {
        // Decide the barcode line BEFORE any writes: a skipped read
        // (skip_err with missing/uncorrectable barcode) must leave no
        // trace in ANY output (pipeline/extract.py output_barcode).
        const Rec &rb = bb[i];
        bool missing = rb.seq.empty();
        if (!missing) {
          fmt.extract(rb.seq, 2, true, bcbuf);
          if (C != nullptr) {
            int result = C->correct(bcbuf, rb.qual, rb.has_qual);
            if (result < 0) missing = true;
          }
        }
        if (missing && skip_err) continue;
        fputc('>', ob);
        fwrite(id.data(), 1, id.size(), ob);
        fputc('\n', ob);
        if (!missing) {
          fwrite(bcbuf.data(), 1, bcbuf.size(), ob);
        } else {
          fwrite("missing_barcode", 1, 15, ob);
        }
        fputc('\n', ob);
      }
      write_formatted(o1, id, b1[i], fmt, 0, sbuf, qbuf);
      if (s2) write_formatted(o2, id, b2[i], fmt, 1, sbuf, qbuf);
      if (want_umi) {
        const Rec &ru = umi_alias ? bb[i] : bu[i];
        fputc('>', ou);
        fwrite(id.data(), 1, id.size(), ou);
        fputc('\n', ou);
        if (!ru.seq.empty()) {
          fmt.extract(ru.seq, 3, true, bcbuf);
          fwrite(bcbuf.data(), 1, bcbuf.size(), ou);
        } else {
          fwrite("missing_barcode", 1, 15, ou);
        }
        fputc('\n', ou);
      }
      kept++;
    }
    clock.lap(2);
  }

  fclose(o1);
  if (o2) fclose(o2);
  if (ob) fclose(ob);
  if (ou) fclose(ou);
  cleanup();
  clock.lap(2);
  clock.report(phase_ns);
  return kept;
}

}  // extern "C"

// ===========================================================================
// Assembler ingest, single-end (+barcode/+umi) case (pipeline/assembler.py
// ingest + process_read's no-mate path): parse up to three FASTQs in
// lockstep, skip missing_barcode records, intern barcode/UMI strings in
// first-appearance order, drop low-complexity reads, and return flat
// arrays.  The paired/mate-merge path stays in Python (it needs the DP
// mate-overlap logic and is bulk-RNA-only where ingest is not the
// bottleneck).
// ===========================================================================

namespace {

// The ASSEMBLER's IsLowComplexity replica (pipeline/assembler.py
// is_low_complexity): counts exactly A/C/G/T/N and IGNORES any other
// byte.  This differs from is_low_complexity() above, which maps other
// bytes into the N bucket (the extractor Python's cnt[-1] aliasing); the
// reference's own main.cpp:183-205 indexes cnt[-1] for such bytes (UB),
// so each side mirrors the Python function it replaces.
bool asm_is_low_complexity(const char *s, int n) {
  long cnt[5] = {0, 0, 0, 0, 0};
  for (int i = 0; i < n; i++) {
    switch (s[i]) {
      case 'A': cnt[0]++; break;
      case 'C': cnt[1]++; break;
      case 'G': cnt[2]++; break;
      case 'T': cnt[3]++; break;
      case 'N': cnt[4]++; break;
      default: break;
    }
  }
  if (cnt[0] >= n / 2 || cnt[1] >= n / 2 || cnt[2] >= n / 2 ||
      cnt[3] >= n / 2 || cnt[4] >= n / 10)
    return true;
  int low = 0;
  for (int i = 0; i < 4; i++)
    if (cnt[i] <= 2) low++;
  return low >= 2;
}

}  // namespace

extern "C" {

// Returns n_kept, or -1 on I/O failure / capacity overflow (caller falls
// back to the Python loop).  All caps are byte/entry capacities of the
// caller-allocated outputs.  have_qual: 1 when quals should be captured.
// out_meta: {first_read_len, n_barcodes, n_reads_total} int64.
int64_t t4x_ingest_single(
    const char *reads_paths, const char *bc_path, const char *umi_path,
    int keep_missing_barcode, int want_bc_totals,
    char *reads_blob, int64_t reads_cap, int64_t *read_offs,
    char *quals_blob, char *ids_blob, int64_t ids_cap, int64_t *id_offs,
    int32_t *bc_ids, int32_t *umi_ids, int64_t n_cap,
    char *bct_blob, int64_t bct_cap, int64_t *bct_offs, int64_t bct_n_cap,
    int64_t *bc_totals, int64_t *out_meta) {
  RecStream rs(reads_paths);
  RecStream *bs = bc_path && bc_path[0] ? new RecStream(bc_path) : nullptr;
  RecStream *us = umi_path && umi_path[0] ? new RecStream(umi_path) : nullptr;
  if (!rs.open_ok || (bs && !bs->open_ok) || (us && !us->open_ok)) {
    delete bs;
    delete us;
    return -1;
  }
  // Interning: barcodes/UMIs are short ACGT strings (16bp/10bp in the
  // 10x format), so the common case packs into a uint64 key — integer
  // hashing instead of per-record string hashing + key allocation
  // (~1.5s at the 897k single-cell scale).  Anything unpackable (>31bp
  // or non-ACGT, e.g. N-containing barcodes) falls back to the string
  // map; ids stay first-seen-ordered either way.
  std::unordered_map<uint64_t, int32_t> bc_pmap, umi_pmap;
  std::unordered_map<std::string, int32_t> bc_map, umi_map;
  bc_pmap.reserve(1 << 16);
  umi_pmap.reserve(1 << 16);
  auto pack_key = [](const std::string &q, uint64_t &out) -> bool {
    size_t L = q.size();
    if (L == 0 || L > 31) return false;
    uint64_t v = 1;  // length sentinel bit keeps different lengths apart
    for (size_t x = 0; x < L; x++) {
      uint64_t b2;
      switch (q[x]) {
        case 'A': b2 = 0; break;
        case 'C': b2 = 1; break;
        case 'G': b2 = 2; break;
        case 'T': b2 = 3; break;
        default: return false;
      }
      v = (v << 2) | b2;
    }
    out = v;
    return true;
  };
  auto intern = [&](const std::string &q,
                    std::unordered_map<uint64_t, int32_t> &pmap,
                    std::unordered_map<std::string, int32_t> &smap,
                    int32_t next_id, int32_t &id_out) -> bool {
    // returns true when q is NEW (id_out = next_id, caller registers)
    uint64_t k;
    if (pack_key(q, k)) {
      auto it = pmap.find(k);
      if (it != pmap.end()) {
        id_out = it->second;
        return false;
      }
      pmap.emplace(k, next_id);
      id_out = next_id;
      return true;
    }
    auto it = smap.find(q);
    if (it != smap.end()) {
      id_out = it->second;
      return false;
    }
    smap.emplace(q, next_id);
    id_out = next_id;
    return true;
  };
  int32_t n_bc_ids = 0, n_umi_ids = 0;
  int64_t n = 0, r_at = 0, i_at = 0, bct_at = 0;
  int64_t first_read_len = -1, n_total = 0;
  Rec r, b, u;
  read_offs[0] = 0;
  id_offs[0] = 0;
  bct_offs[0] = 0;
  bool fail = false;
  while (rs.next(r)) {
    int32_t bc = -1, um = -1;
    if (bs) {
      if (!bs->next(b)) {
        // Ragged barcode file: the Python loop raises (next() with no
        // default) — bail so the fallback path surfaces the error.
        fail = true;
        break;
      }
      if (us && !us->next(u)) {
        fail = true;
        break;
      }
      if (!keep_missing_barcode && b.seq == "missing_barcode") continue;
      if (intern(b.seq, bc_pmap, bc_map, n_bc_ids, bc)) {
        if (bc >= bct_n_cap ||
            bct_at + (int64_t)b.seq.size() > bct_cap) {
          fail = true;
          break;
        }
        n_bc_ids++;
        memcpy(bct_blob + bct_at, b.seq.data(), b.seq.size());
        bct_at += (int64_t)b.seq.size();
        bct_offs[bc + 1] = bct_at;
        if (want_bc_totals) bc_totals[bc] = 0;
      }
      if (want_bc_totals) bc_totals[bc] += 1;
    } else if (us) {
      if (!us->next(u)) {
        fail = true;
        break;
      }
    }
    if (us) {
      if (intern(u.seq, umi_pmap, umi_map, n_umi_ids, um)) n_umi_ids++;
    }
    n_total++;
    if (!r.has_qual) {
      // FASTA record: the Python path carries qual=None (trim semantics
      // differ) — bail to the fallback loop.
      fail = true;
      break;
    }
    if (first_read_len == -1) first_read_len = (int64_t)r.seq.size();
    if (asm_is_low_complexity(r.seq.data(), (int)r.seq.size())) continue;
    if (n >= n_cap || r_at + (int64_t)r.seq.size() > reads_cap ||
        i_at + (int64_t)r.id.size() > ids_cap) {
      fail = true;
      break;
    }
    memcpy(reads_blob + r_at, r.seq.data(), r.seq.size());
    if (quals_blob) {
      // qual length == read length in well-formed FASTQ; guard anyway.
      size_t ql = r.qual.size() < r.seq.size() ? r.qual.size()
                                               : r.seq.size();
      memcpy(quals_blob + r_at, r.qual.data(), ql);
      for (size_t x = ql; x < r.seq.size(); x++)
        quals_blob[r_at + x] = '!';
    }
    r_at += (int64_t)r.seq.size();
    memcpy(ids_blob + i_at, r.id.data(), r.id.size());
    i_at += (int64_t)r.id.size();
    bc_ids[n] = bc;
    umi_ids[n] = um;
    n++;
    read_offs[n] = r_at;
    id_offs[n] = i_at;
  }
  delete bs;
  delete us;
  if (fail) return -1;
  out_meta[0] = first_read_len;
  out_meta[1] = (int64_t)n_bc_ids;
  out_meta[2] = n_total;
  return n;
}

}  // extern "C"
