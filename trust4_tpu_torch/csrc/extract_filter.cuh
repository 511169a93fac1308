// One read's exact candidate decision for the bulk extraction stream:
// the low-complexity guard, then HasHitInSet against the static germline
// index.  A transcription of native/extract_filter.cpp (is_low_complexity,
// has_hit_in_set_fast, get_overlaps_from_hits,
// longest_increasing_subsequence, total_hit_length_on), decision for
// decision, with its quirks kept:
//   - N encodes as 0, and a window covering an N is looked up by no one;
//     a byte other than ACGTN counts 3 on the read's strand and is an N on
//     its reverse complement;
//   - window w is looked up when it is valid and w == 0 or its code
//     differs from window w-1's;
//   - a sequence counts once a window; the most-counted sequence of a
//     strand wins, the smallest index on a tie;
//   - both strands are chained when both counts reach the hit length
//     (max_cnt + k - 1 >= hlr), and the larger first overlap wins, the
//     reverse strand on a tie;
//   - the repeats check of a run indexes the strand's bucket in its scan
//     order with the run's positions in the sorted copy;
//   - the LIS's mean divergence sums from its second hit on.
//
// The decision is written for a warp of kLanes lanes over N lane slots
// (a round of kLanes windows, their postings shared out evenly),
// as dp_lanes.cuh writes the DP sweeps: every lane-local step is a loop
// over the slots, and lane(s) says which lane slot s is.  On the card
// (WarpLanes in extract_filter.cu) N = 1, each thread is a lane, and the
// shared counts and the bucket take atomics; in the g++ host build
// (HostLanes below, the CPU tests) one thread runs the 32 lanes in turn.
// What the lanes share (a warp's counts, its best sequence, its bucket)
// does not depend on the order in which they run: counts and maxima
// commute, and the bucket is sorted before it is chained.
//
// Fixed caps bound what a warp holds: a read longer than kMaxLen, or a
// strand whose best sequence has more than kBucketCap hits, is returned
// as kUndecided, and the caller decides that read with the host's
// has_hit_in_set.  So the decision is exact for every read whatever the
// caps; the tests build the header with tiny caps to take that route.
// Postings of one k-mer are grouped by ascending sequence index
// (t4x_csr_view checks it), which is what lets a window count a sequence
// once by comparing it with the posting before.

#pragma once

#include <stdint.h>

#ifndef T4XF_MAX_LEN
#define T4XF_MAX_LEN 4095
#endif
#ifndef T4XF_BUCKET_CAP
#define T4XF_BUCKET_CAP 256
#endif

namespace t4xf {

constexpr int kLanes = 32;
constexpr int kMaxLen = T4XF_MAX_LEN;
constexpr int kBucketCap = T4XF_BUCKET_CAP;
constexpr int kUndecided = 2;
constexpr int kRepeatsMax = 10000;  // a hit of more postings is a repeat
// A count and a sequence index in one word for the strand's maximum: the
// count above kSeqBits, the index inverted below, so that the larger word
// is the larger count and, on a tie, the smaller index.
constexpr int kSeqBits = 20;
constexpr uint32_t kSeqMask = (1u << kSeqBits) - 1;
static_assert(kMaxLen < (1 << (32 - kSeqBits)), "a count must fit its bits");

// The index's direct-addressed tables (the CSR view of
// native/extract_filter.cpp's Filter): off[code]..off[code+1] slice the
// (sequence, offset) pairs of posts.
struct Tables {
  const int32_t* off;
  const int32_t* posts;
  int k, radius, hlr, n_seqs;
};

// A hit of the chained strand's best sequence: read offset, sequence
// offset, and whether its k-mer has at most kRepeatsMax postings.
struct Hit {
  int32_t a, b, unique;
};

// The chain's scratch, used by one lane: the bucket sorted by (diff, b,
// a), a run sorted by (b, a), the LIS's top and link, the LIS and the
// deduplicated chain.
struct Scratch {
  int32_t ha[kBucketCap], hb[kBucketCap];
  int32_t ca[kBucketCap], cb[kBucketCap];
  int32_t top[kBucketCap], link[kBucketCap];
  int32_t la[kBucketCap], lb[kBucketCap];
  int32_t oa[kBucketCap], ob[kBucketCap];
};

// What a warp's lanes share for one read (on the card, in the warp's
// slice of shared memory).
struct Shared {
  uint32_t* cnt;     // n_seqs counts, zero between strands
  uint32_t* best;    // the strand's packed maximum, 0 with no posting
  uint32_t* n_hits;  // the bucket's hits, counted past the cap
  int32_t* wb;       // kLanes: a round's windows' first postings,
  int32_t* wn;       // kLanes: their numbers of postings
  int32_t* pre;      // kLanes + 1: the postings before each
  Hit* bucket;       // kBucketCap
  Scratch* scratch;  // the lead lane's
};

__host__ __device__ inline int nuc2num(int c) {
  switch (c) {
    case 'A': return 0;
    case 'C': return 1;
    case 'G': return 2;
    case 'T': return 3;
    case 'N': return 0;
    default: return -1;
  }
}

// Base i of the read's strand st (1: as read, 0: its reverse complement
// as native revcomp writes it): its 2-bit value and whether it is an N.
__host__ __device__ inline int base_at(const uint8_t* read, int len, int st,
                                       int i, bool* is_n) {
  if (st == 1) {
    const int c = read[i];
    *is_n = c == 'N';
    return nuc2num(c) & 3;
  }
  const int c = read[len - 1 - i];
  const int v = (c >= 'A' && c <= 'Z') ? nuc2num(c) : -1;
  *is_n = c == 'N' || v < 0;
  return *is_n ? 0 : 3 - v;
}

// Whether window w of strand st is looked up, and its code.
__host__ __device__ inline bool lookup(const Tables& T, const uint8_t* read,
                                       int len, int st, int w,
                                       uint32_t* code) {
  uint32_t c = 0, prev = 0;
  bool valid = true;
  const int from = w > 0 ? w - 1 : 0;
  for (int i = from; i < w + T.k; ++i) {
    bool n;
    const uint32_t v = base_at(read, len, st, i, &n);
    if (i < w + T.k - 1) prev = (prev << 2) | v;
    if (i >= w) {
      c = (c << 2) | v;
      if (n) valid = false;
    }
  }
  *code = c;
  return valid && (w == 0 || c != prev);
}

// The low-complexity guard's five counts of the bytes a lane holds.
__host__ __device__ inline void lowc_count(const uint8_t* read, int len,
                                           int lane, int* cnt) {
  for (int i = lane; i < len; i += kLanes) {
    const int c = read[i];
    const int v = c == 'N' ? 4 : nuc2num(c);
    cnt[v < 0 ? 4 : v]++;
  }
}

__host__ __device__ inline bool low_complexity(const int* cnt, int n) {
  if (cnt[0] >= n / 2 || cnt[1] >= n / 2 || cnt[2] >= n / 2 ||
      cnt[3] >= n / 2 || cnt[4] >= n / 10)
    return true;
  int low = 0;
  for (int i = 0; i < 4; i++)
    if (cnt[i] <= 2) low++;
  return low >= 2;
}

// Round j of strand st's windows, windows j * kLanes .. + kLanes - 1,
// lane l looking up window j * kLanes + l: its postings start at
// wb[l] and number wn[l] (0 when it is not looked up), and pre[l] of the
// round's postings come before them (pre[kLanes] in all).  The lanes then
// share the round's postings out evenly, whichever windows hold them: a
// k-mer of many postings would otherwise keep its lane, and the warp,
// looping while the other lanes wait.
template <class X>
__host__ __device__ inline void round_windows(const X& x, const Tables& T,
                                              const uint8_t* read, int len,
                                              int st, int j, Shared& sh) {
  const int nw = len - T.k + 1;
  for (int s = 0; s < X::N; ++s) {
    const int lane = x.lane(s), w = j * kLanes + lane;
    uint32_t code;
    int b = 0, n = 0;
    if (w < nw && lookup(T, read, len, st, w, &code)) {
      b = T.off[code];
      n = T.off[code + 1] - b;
    }
    sh.wb[lane] = b;
    sh.wn[lane] = n;
  }
  x.sync();
  x.prefix(sh.wn, sh.pre);
  x.sync();
}

// The window (lane) of the round's posting idx < pre[kLanes].
__host__ __device__ inline int owner(const Shared& sh, int idx) {
  int lo = 0, hi = kLanes;  // pre[lo] <= idx < pre[hi]
  while (hi - lo > 1) {
    const int m = (lo + hi) / 2;
    if (sh.pre[m] <= idx)
      lo = m;
    else
      hi = m;
  }
  return lo;
}

// Strand st's looked-up windows count every sequence among their
// postings once a window, into the counts and the strand's best.
template <class X>
__host__ __device__ inline void count_strand(const X& x, const Tables& T,
                                             const uint8_t* read, int len,
                                             int st, Shared& sh) {
  const int nw = len - T.k + 1;
  for (int j = 0; j * kLanes < nw; j++) {
    round_windows(x, T, read, len, st, j, sh);
    const int total = sh.pre[kLanes];
    for (int s = 0; s < X::N; ++s)
      for (int idx = x.lane(s); idx < total; idx += kLanes) {
        const int l = owner(sh, idx);
        const int t = sh.wb[l] + idx - sh.pre[l];
        const int seq = T.posts[2 * t];
        if (t > sh.wb[l] && T.posts[2 * t - 2] == seq) continue;
        const uint32_t c = x.add(&sh.cnt[seq]) + 1;
        x.max(sh.best, (c << kSeqBits) | (kSeqMask - uint32_t(seq)));
      }
    x.sync();
  }
}

// Strand st's hits on sequence target, appended to the bucket (the count
// goes on past the cap, which makes the read undecided).
template <class X>
__host__ __device__ inline void collect_strand(const X& x, const Tables& T,
                                               const uint8_t* read, int len,
                                               int st, int target,
                                               Shared& sh) {
  const int nw = len - T.k + 1;
  for (int j = 0; j * kLanes < nw; j++) {
    round_windows(x, T, read, len, st, j, sh);
    const int total = sh.pre[kLanes];
    for (int s = 0; s < X::N; ++s)
      for (int idx = x.lane(s); idx < total; idx += kLanes) {
        const int l = owner(sh, idx);
        const int t = sh.wb[l] + idx - sh.pre[l];
        if (T.posts[2 * t] != target) continue;
        const uint32_t at = x.add(sh.n_hits);
        if (at < uint32_t(kBucketCap))
          sh.bucket[at] = Hit{j * kLanes + l, T.posts[2 * t + 1],
                              sh.wn[l] <= kRepeatsMax};
      }
    x.sync();
  }
}

__host__ __device__ inline double fabs_(double v) { return v < 0 ? -v : v; }

// Hits i and j of a by (primary, secondary) ascending: whether i goes
// after j.
__host__ __device__ inline bool after(int p_i, int s_i, int p_j, int s_j) {
  return p_i > p_j || (p_i == p_j && s_i > s_j);
}

// longest_increasing_subsequence on the run (ca, cb)[0..size): the
// deduplicated, replaced chain in (oa, ob)[0..return).
__host__ __device__ inline int lis(Scratch& S, int size) {
  const int32_t* a = S.ca;
  const int32_t* b = S.cb;
  double avg = 0.0;
  for (int i = 1; i < size; i++) avg += a[i] - b[i];
  avg /= size;
  for (int i = 0; i < size; i++) {
    S.top[i] = 0;
    S.link[i] = -1;
  }
  int ret = 1;
  for (int i = 1; i < size; i++) {
    int tag;
    if (a[S.top[ret - 1]] <= a[i]) {
      tag = ret - 1;
    } else {
      int l = 0, r = ret - 1;
      tag = -2;
      while (l <= r) {
        const int m = (l + r) / 2;
        if (a[i] == a[S.top[m]]) {
          tag = m;
          break;
        }
        if (a[i] < a[S.top[m]])
          r = m - 1;
        else
          l = m + 1;
      }
      if (tag == -2) tag = l - 1;
    }
    if (tag == -1) {
      S.top[0] = i;
      S.link[i] = -1;
    } else if (a[i] > a[S.top[tag]]) {
      if (tag == ret - 1) {
        S.top[ret] = i;
        ret += 1;
        S.link[i] = S.top[tag];
      } else if (a[i] < a[S.top[tag + 1]]) {
        S.top[tag + 1] = i;
        S.link[i] = S.top[tag];
      }
    } else if (a[i] == a[S.top[tag]]) {
      const int t = S.top[tag];
      if (fabs_(a[i] - b[i] - avg) < fabs_(a[t] - b[t] - avg)) {
        S.top[tag] = i;
        S.link[i] = tag > 0 ? S.top[tag - 1] : -1;
      }
    }
  }
  // The chain, first hit first.
  for (int t = ret - 1, k = S.top[ret - 1]; t >= 0; t--) {
    S.la[t] = a[k];
    S.lb[t] = b[k];
    k = S.link[k];
  }
  // Same sequence offset: keep the least divergent.
  int n = 0;
  for (int i = 0; i < ret;) {
    int j = i + 1;
    while (j < ret && S.lb[i] == S.lb[j]) j++;
    int keep = i;
    double least = fabs_(S.la[i] - S.lb[i] - avg);
    for (int l = i + 1; l < j; l++) {
      const double d = fabs_(S.la[l] - S.lb[l] - avg);
      if (d < least) {
        least = d;
        keep = l;
      }
    }
    S.oa[n] = S.la[keep];
    S.ob[n] = S.lb[keep];
    n++;
    i = j;
  }
  // Replacement pass: a less divergent hit of the run in a chain slot.
  for (int p = 0, q = 0; p < n && q < size;) {
    if (b[q] < S.ob[p]) {
      q++;
    } else if (p + 1 < n && S.ob[p + 1] <= b[q]) {
      p++;
    } else if (S.oa[p] == a[q] && S.ob[p] == b[q]) {
      q++;
    } else {
      if (S.oa[p] <= a[q] && (p == n - 1 || a[q] < S.oa[p + 1]) &&
          fabs_(a[q] - b[q] - avg) < fabs_(S.oa[p] - S.ob[p] - avg)) {
        S.oa[p] = a[q];
        S.ob[p] = b[q];
      }
      q++;
    }
  }
  return n;
}

__host__ __device__ inline int total_hit_length_on(const int32_t* offs,
                                                   int n, int kl) {
  int ret = 0;
  for (int i = 0; i < n;) {
    int j = i + 1;
    while (j < n && offs[j] <= offs[j - 1] + kl - 1) j++;
    ret += offs[j - 1] - offs[i] + kl;
    i = j;
  }
  return ret;
}

// get_overlaps_from_hits on one strand's bucket of m hits (one sequence):
// the first overlap's match count, or -1 with none.  Sorts the bucket
// into its scan order, (read offset, sequence offset).
__host__ __device__ inline int first_overlap(const Tables& T, Hit* bucket,
                                             int m, Scratch& S) {
  for (int i = 1; i < m; i++) {
    const Hit h = bucket[i];
    int j = i;
    for (; j > 0 && after(bucket[j - 1].a, bucket[j - 1].b, h.a, h.b); j--)
      bucket[j] = bucket[j - 1];
    bucket[j] = h;
  }
  int unique = 0;
  for (int i = 0; i < m; i++) unique += bucket[i].unique;
  const bool remove_only_repeats = unique >= 3;
  if (m < 3) return -1;

  // (a, b) by (a - b, b, a).
  for (int i = 0; i < m; i++) {
    const int a = bucket[i].a, b = bucket[i].b;
    int j = i;
    for (; j > 0; j--) {
      const int pa = S.ha[j - 1], pb = S.hb[j - 1];
      if (!(pa - pb > a - b || (pa - pb == a - b && after(pb, pa, b, a))))
        break;
      S.ha[j] = pa;
      S.hb[j] = pb;
    }
    S.ha[j] = a;
    S.hb[j] = b;
  }

  const int kl = T.k, hlr = T.hlr;
  for (int s = 0; s < m;) {
    int e = s + 1;
    while (e < m) {
      const int d = (S.ha[e] - S.hb[e]) - (S.ha[e - 1] - S.hb[e - 1]);
      if ((d < 0 ? -d : d) > T.radius) break;
      e++;
    }
    if (e - s < 3 || (e - s) * kl < hlr) {
      s = e;
      continue;
    }
    if (remove_only_repeats) {
      bool has_unique = false;
      for (int k = s; k < e; k++)
        if (bucket[k].unique) {
          has_unique = true;
          break;
        }
      if (!has_unique) {
        s = e;
        continue;
      }
    }
    const int size = e - s;
    for (int i = 0; i < size; i++) {
      const int a = S.ha[s + i], b = S.hb[s + i];
      int j = i;
      if (T.radius > 0)
        for (; j > 0 && after(S.cb[j - 1], S.ca[j - 1], b, a); j--) {
          S.ca[j] = S.ca[j - 1];
          S.cb[j] = S.cb[j - 1];
        }
      S.ca[j] = a;
      S.cb[j] = b;
    }
    const int n = lis(S, size);
    if (n * kl < hlr) {
      s = e;
      continue;
    }
    const int hit_len = total_hit_length_on(S.oa, n, kl);
    if (hit_len < hlr || total_hit_length_on(S.ob, n, kl) < hlr) {
      s = e;
      continue;
    }
    return 2 * hit_len;
  }
  return -1;
}

// The strand's best sequence's first overlap (collect_strand on the lanes,
// first_overlap on the lead): its match count, -1 with none, or
// kUndecided's negative, -kUndecided - 1, past the bucket's cap.
template <class X>
__host__ __device__ inline int chain(const X& x, const Tables& T,
                                     const uint8_t* read, int len, int st,
                                     int target, Shared& sh) {
  *sh.n_hits = 0;
  x.sync();
  collect_strand(x, T, read, len, st, target, sh);
  const int m = int(*sh.n_hits);
  if (m > kBucketCap) return -kUndecided - 1;
  int r = -1;
  if (x.lead()) r = first_overlap(T, sh.bucket, m, *sh.scratch);
  r = x.bcast(r);
  x.sync();
  return r;
}

// The read's decision: 0 (not a candidate), -1 or 1 (the HasHitInSet
// strand) or kUndecided.  Every lane of the warp calls it; the counts
// must be zero on entry, and are on return.
template <class X>
__host__ __device__ inline int decide_read(const X& x, const Tables& T,
                                           const uint8_t* read, int len,
                                           Shared& sh) {
  int c5[5] = {0, 0, 0, 0, 0};
  for (int s = 0; s < X::N; ++s) lowc_count(read, len, x.lane(s), c5);
  for (int i = 0; i < 5; i++) c5[i] = x.sum(c5[i]);
  if (low_complexity(c5, len)) return 0;
  if (len < T.k) return 0;
  if (len > kMaxLen) return kUndecided;

  int max_cnt[2], max_seq[2];
  for (int st = 1; st >= 0; st--) {
    *sh.best = 0;
    x.sync();
    count_strand(x, T, read, len, st, sh);
    const uint32_t best = *sh.best;
    max_cnt[st] = best ? int(best >> kSeqBits) : -1;
    max_seq[st] = best ? int(kSeqMask - (best & kSeqMask)) : -1;
    for (int s = 0; s < X::N; ++s)
      for (int i = x.lane(s); i < T.n_seqs; i += kLanes) sh.cnt[i] = 0;
    x.sync();
  }
  if (max_seq[0] < 0 && max_seq[1] < 0) return 0;

  const int kl = T.k, hlr = T.hlr;
  if (max_cnt[0] + kl - 1 >= hlr && max_cnt[1] + kl - 1 >= hlr) {
    const int m0 = chain(x, T, read, len, 0, max_seq[0], sh);
    if (m0 < -1) return kUndecided;
    const int m1 = chain(x, T, read, len, 1, max_seq[1], sh);
    if (m1 < -1) return kUndecided;
    if (m0 < 0 && m1 < 0) return 0;
    if (m0 >= 0 && m1 >= 0) return m0 >= m1 ? -1 : 1;
    return m0 >= 0 ? -1 : 1;
  }
  const int tag = max_cnt[1] >= max_cnt[0] ? 1 : 0;
  if (max_seq[tag] < 0) return 0;
  const int m = chain(x, T, read, len, tag, max_seq[tag], sh);
  if (m < -1) return kUndecided;
  if (m < 0) return 0;
  return tag == 0 ? -1 : 1;
}

// The host build's warp: one thread runs the kLanes lanes in turn.
struct HostLanes {
  static constexpr int N = kLanes;
  __host__ __device__ int lane(int s) const { return s; }
  __host__ __device__ bool lead() const { return true; }
  __host__ __device__ uint32_t add(uint32_t* p) const { return (*p)++; }
  __host__ __device__ void max(uint32_t* p, uint32_t v) const {
    if (v > *p) *p = v;
  }
  __host__ __device__ int sum(int v) const { return v; }
  __host__ __device__ int bcast(int v) const { return v; }
  __host__ __device__ void sync() const {}
  // pre[l] = n[0] + ... + n[l - 1], for l = 0 .. kLanes.
  __host__ __device__ void prefix(const int32_t* n, int32_t* pre) const {
    int p = 0;
    for (int l = 0; l < kLanes; l++) {
      pre[l] = p;
      p += n[l];
    }
    pre[kLanes] = p;
  }
};

}  // namespace t4xf
