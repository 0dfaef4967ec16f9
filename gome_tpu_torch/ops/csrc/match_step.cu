// Batched match step for NVIDIA Hopper (sm_90a): T sequential book ops for
// every row of an [S, T] op grid, one warp per row.
//
// Replaces gome_tpu/ops/pallas_match.py::_kernel / pallas_batch_step (the
// Pallas TPU kernel; pallas_call at pallas_match.py:306). The semantics are
// those of gome_tpu/engine/step.py::step_rows_impl; the plain PyTorch
// version of the same math is gome_tpu_torch/engine/step.py::step_rows,
// looped over T in gome_tpu_torch/ops/match_step.py::batch_step_reference.
//
// What bounds it on this card. A row reads its [2, cap] book once and
// writes it once, reads its T ops and writes T * (7 * K + 7) outputs: bytes
// bound a wide, shallow grid (S=10,240, T=32, cap 256, K 16, int32: about
// 0.37 GB, 0.11 ms at 3.35 TB/s). The ops of one row are strictly
// sequential (every op reads the book the previous op wrote), so a deep
// grid whose work sits in a few rows (the engine's dense Zipf grids: one
// row with hundreds of live ops, the rest NOP padding) is bound by the
// latency of one row's op chain. On the H100 the per-row memory phases
// (load, tail scan, write-back, zero outputs) come close to the byte
// bound; the wide grid is held back by the op work on top of them, bound
// by instruction issue with about 20 rows per SM, and the deep grid by the
// hot row's chain of shared-memory round trips, reductions and barriers,
// slowed by the cold rows that share its SM (chip_smoke.py phase 4 and
// PERF.md have the numbers).
//
// What the design does about it:
//   * one warp runs a row's ops warp-synchronously: shuffles, ballots and
//     __syncwarp. Rows up to 32 KB (cap up to ~800 at int32) are rows of
//     one warp, one to a CTA, with no block-wide barrier anywhere. A
//     larger row (the engine's escalated caps, and every row in device
//     memory) gets a CTA of four warps: warp 0 runs the ops and hands the
//     linear parts, moves and cancel scans, to all four warps as jobs over
//     a named barrier; the four share the once-per-row steps. On the
//     main-path grid this beat one warp per row and two warps per row;
//   * the row's book is copied into shared memory once with cp.async and
//     written back once, in canonical order, in 16-byte stores; the first
//     32 ops and the index past which every op is a NOP load while the
//     book does. Ops are loaded 32 at a time, coalesced, one chunk ahead,
//     and broadcast by __shfl_sync; the 7 per-op scalars are buffered one
//     per lane and stored coalesced per chunk of 32 ops. No global load
//     sits on the per-op chain;
//   * every loop touches live slots only. Matching scans the opposite side
//     in 32-slot chunks from the best slot and stops after the chunk where
//     the price stops crossing or the saturating cumulative reaches the
//     volume (sides are priority-sorted, so crossing slots are a prefix);
//     it goes on only as far as slot K to echo the K record slots. The
//     insert position is a 32-way search of the sorted own side; a cancel
//     scans [0, count) 16 bytes of oids per lane and step, with its sums
//     kept per lane and reduced once;
//   * each side is a ring: logical slot i sits at physical (head + i) mod
//     cap, and `hi` marks the logical slots [hi, cap) known to be zero in
//     every field. Compaction advances the head and zeroes the vacated
//     slots; an insert or a cancel moves the shorter of the two runs on
//     either side of the slot (the head run, or the tail run up to hi).
//     Each move drops or zero-fills exactly the slot the reference drops or
//     zero-fills, so tails that hold stale values stay exact;
//   * an op only plans its own side's move, clear and insert; one code path
//     applies the plan, and the once-per-row steps are not inlined, so the
//     op loop's code stays small enough for the instruction caches;
//   * NOP ops cost no book work: a chunk's NOPs and cancels get their zero
//     records in 16-byte stores after the chunk, and the NOPs past the last
//     live op get all their outputs in one bulk zero fill;
//   * the kernel is templated on the value type (int32 books saturate their
//     prefix sums at SAT32_MAX, int64 books wrap);
//   * caps whose book does not fit shared memory (above ~5,800 at int32,
//     ~3,200 at int64) run the same algorithm on the output rows in device
//     memory and rotate each side into canonical order at the end.
//
// The kernel never writes its inputs: callers keep the pre-grid books for
// replay and rollback. It launches on the caller's stream and returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarpsPerCta = 4;
// Rows at least this large get a CTA of kMaxWarpsPerCta warps, smaller rows
// a CTA of one warp (launch rule in gome_match_step).
constexpr size_t kTeamRowBytes = 32768;
constexpr long long kSat32 = (1LL << 30) - 1;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kActionAdd = 1;
constexpr int kActionDel = 2;

// Pointer table, in the order ops/match_step.py::batch_step passes it:
// books in (price, lots, seq, oid, uid, count, next_seq), books out (same),
// ops (action, side, is_market, price, volume, oid, uid), outputs in
// StepOutput order.
enum Ptr {
  kInPrice, kInLots, kInSeq, kInOid, kInUid, kInCount, kInNextSeq,
  kOutPrice, kOutLots, kOutSeq, kOutOid, kOutUid, kOutCount, kOutNextSeq,
  kOpAction, kOpSide, kOpMarket, kOpPrice, kOpVolume, kOpOid, kOpUid,
  kFillPrice, kFillQty, kMakerOid, kMakerUid, kMakerPrefill,
  kMakerRemaining, kTakerAfter, kNFills, kFillOverflow, kTakerRemaining,
  kRested, kBookOverflow, kCancelFound, kCancelVolume,
  kNumPtrs
};

struct Params {
  void* p[kNumPtrs];
  int rows;
  int t_len;
  int cap;
  int k;
};

// Saturating add for 32-bit books (operands in [0, SAT32_MAX], so the sum
// cannot overflow before the clamp); wrapping add for 64-bit books.
__device__ __forceinline__ int sat_add(int a, int b) {
  const int s = a + b;
  return s < static_cast<int>(kSat32) ? s : static_cast<int>(kSat32);
}
__device__ __forceinline__ long long sat_add(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}
__device__ __forceinline__ int sat_in(int x) {
  return x < static_cast<int>(kSat32) ? x : static_cast<int>(kSat32);
}
__device__ __forceinline__ long long sat_in(long long x) { return x; }

__device__ __forceinline__ int lane_id() { return threadIdx.x & (kWarp - 1); }

// Barrier of a row's team: its one warp, or the W warps of a CTA that
// runs one row (named barrier 1, so warps may reach it from different
// points of the code).
__device__ __forceinline__ void team_sync(int threads) {
  if (threads == kWarp) {
    __syncwarp();
  } else {
    asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
  }
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int d = kWarp / 2; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// Warp total of nonnegative fills: two 32-bit reductions for int32 books
// (each lane's fill is below 2^31), a shuffle tree for int64.
__device__ __forceinline__ long long warp_total(int f) {
  const unsigned u = static_cast<unsigned>(f);
  return (static_cast<long long>(__reduce_add_sync(kFull, u >> 16)) << 16) +
         __reduce_add_sync(kFull, u & 0xffffu);
}
__device__ __forceinline__ long long warp_total(long long f) {
  return warp_sum(f);
}

// A 16-byte vector of V: int4 for 32-bit values, longlong2 for 64-bit.
template <typename V>
struct Vec16;
template <>
struct Vec16<int> {
  using type = int4;
};
template <>
struct Vec16<long long> {
  using type = longlong2;
};

// Element e (a constant once unrolled) of a 16-byte vector, and the
// vector from its elements: register moves, no local-memory arrays.
__device__ __forceinline__ int elem(const int4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}
__device__ __forceinline__ long long elem(const longlong2& v, int e) {
  return e == 0 ? v.x : v.y;
}
__device__ __forceinline__ void set_elem(int4& v, int e, int x) {
  if (e == 0) v.x = x;
  else if (e == 1) v.y = x;
  else if (e == 2) v.z = x;
  else v.w = x;
}
__device__ __forceinline__ void set_elem(longlong2& v, int e, long long x) {
  if (e == 0) v.x = x;
  else v.y = x;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Physical slot of a logical position p in [-1, 2 * cap) of a ring.
__device__ __forceinline__ int wrap(int p, int cap) {
  p = p < 0 ? p + cap : p;
  return p >= cap ? p - cap : p;
}

// The row's working book: five arrays of 2 * cap slots, side s from
// s * cap on (the CTA's shared memory, or the output rows).
template <typename T>
struct Book {
  T* price;
  T* lots;
  int* seq;
  T* oid;
  T* uid;
};

// One side of the working book, used as a ring: logical slot i (priority
// order) is array index off + (head + i) % cap.
struct Side {
  int off;    // side * cap
  int head;   // physical slot of logical slot 0, in [0, cap)
  int hi;     // logical slots [hi, cap) are zero in all five fields
  int count;  // resting orders (logical slots [0, count)); may exceed cap
};

__device__ __forceinline__ int at(const Side& s, int i, int cap) {
  return s.off + wrap(s.head + i, cap);
}

template <typename T>
struct Records {
  T* price;
  T* qty;
  T* moid;
  T* muid;
  T* prefill;
  T* remaining;
  T* taker;
};

// Move logical slots [a, e) of a side to [a + d, e + d), d = +1 or -1, in
// place: ascending for d = -1, descending for d = +1, 2 * team slots per
// step (every thread of the team reads its two sources before any writes).
// `rank` is the thread's place in its row's team of `team` threads.
template <typename T>
__device__ __forceinline__ void move_slots(const Book<T>& b, const Side& s,
                                           int cap, int a, int e, int d,
                                           int rank, int team) {
  const int n = e - a;
  for (int k = 0; k < n; k += 2 * team) {
    int dst[2], sq[2];
    T pr[2], lo[2], oi[2], ui[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = k + h * team + rank;
      dst[h] = -1;
      if (j < n) {
        const int i = d < 0 ? a + j : e - 1 - j;
        const int src = at(s, i, cap);
        dst[h] = at(s, i + d, cap);
        pr[h] = b.price[src];
        lo[h] = b.lots[src];
        sq[h] = b.seq[src];
        oi[h] = b.oid[src];
        ui[h] = b.uid[src];
      }
    }
    team_sync(team);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (dst[h] >= 0) {
        b.price[dst[h]] = pr[h];
        b.lots[dst[h]] = lo[h];
        b.seq[dst[h]] = sq[h];
        b.oid[dst[h]] = oi[h];
        b.uid[dst[h]] = ui[h];
      }
    }
    team_sync(team);
  }
}

// Zero logical slots [a, e) of a side in every field.
template <typename T>
__device__ __forceinline__ void zero_slots(const Book<T>& b, const Side& s,
                                           int cap, int a, int e) {
  for (int i = a + lane_id(); i < e; i += kWarp) {
    const int p = at(s, i, cap);
    b.price[p] = 0;
    b.lots[p] = 0;
    b.seq[p] = 0;
    b.oid[p] = 0;
    b.uid[p] = 0;
  }
  __syncwarp();
}

// Number of live slots of a priority-sorted side that keep priority over a
// new order at `price` (bids >= price, asks <= price): a prefix, found by a
// 32-way search. Needs count < cap.
template <typename T>
__device__ __forceinline__ int insert_pos(const Book<T>& b, const Side& s,
                                          int cap, bool is_buy, T price) {
  const int lane = lane_id();
  int lo = 0, hi = s.count;
  while (true) {
    const int step = hi - lo > kWarp ? (hi - lo + kWarp - 1) / kWarp : 1;
    const int probe = lo + (lane + 1) * step - 1;
    bool beats = false;
    if (probe < hi) {
      const T pr = b.price[at(s, probe, cap)];
      beats = is_buy ? pr >= price : pr <= price;
    }
    const int nlo = lo + __popc(__ballot_sync(kFull, beats)) * step;
    if (step == 1) return nlo;
    hi = min(nlo + step - 1, hi);
    lo = nlo;
  }
}

// The own side's update after an op, applied by one code path: move
// logical [a, e) by d, zero logical slot `clear` (old head), add dh to the
// head, write the new order at logical slot `put` (new head). -1: none.
struct Plan {
  int a, e, d, clear, dh, put;
};

struct AddResult {
  int n_fills;
  int rested;
  int book_overflow;
};

// ADD: match against `opp`, write the K records, compact `opp`; plan the
// rest of the remainder in `own`. taker_remaining comes back in rem_out.
template <typename T>
__device__ __forceinline__ AddResult add_op(
    const Book<T>& b, Side& opp, Side& own, int cap, int K,
    const Records<T>& r, size_t rec, bool is_buy, bool mkt, T price,
    T volume, int& nseq, T& rem_out, Plan& plan) {
  const int lane = lane_id();
  const int oc = min(opp.count, cap);
  T carry = 0;          // saturating sum of crossing lots before the chunk
  long long total = 0;  // sum of the fills
  int nf = 0, nr = 0;
  bool stop = false;    // no later slot can fill
  for (int base = 0; base < cap && (!stop || base < K); base += kWarp) {
    const int i = base + lane;
    int p = 0;
    T pr = 0, lots = 0;
    if (i < cap) {
      p = at(opp, i, cap);
      pr = b.price[p];
      lots = b.lots[p];
    }
    T cum = carry, f = 0;
    if (!stop) {
      const bool crosses = mkt || (is_buy ? pr <= price : pr >= price);
      const bool cross = i < oc && crosses;
      const T c = cross ? lots : T(0);
      T incl = sat_in(c);
#pragma unroll
      for (int d = 1; d < kWarp; d <<= 1) {
        const T n = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl = sat_add(incl, n);
      }
      T excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = 0;
      cum = sat_add(carry, excl);
      carry = sat_add(carry, __shfl_sync(kFull, incl, kWarp - 1));
      f = volume - cum;
      if (f < 0) f = 0;
      if (f > c) f = c;
      stop = __ballot_sync(kFull, !cross) != 0 || !(carry < volume);
    }
    const T nl = lots - f;
    const bool filled = f > 0;
    if (i < K) {
      const size_t o = rec + i;
      r.price[o] = pr;
      r.qty[o] = f;
      r.moid[o] = b.oid[p];
      r.muid[o] = b.uid[p];
      r.prefill[o] = lots;
      r.remaining[o] = nl;
      r.taker[o] = filled ? T(volume - (cum + f)) : T(0);
    }
    if (filled) b.lots[p] = nl;
    const unsigned fb = __ballot_sync(kFull, filled);
    if (fb) total += warp_total(filled ? f : T(0));
    nf += __popc(fb);
    nr += __popc(__ballot_sync(kFull, filled && nl == 0));
  }
  __syncwarp();
  if (nr > 0) {
    // Left shift by nr: the first nr slots leave, their physical slots
    // become the zeroed tail.
    zero_slots(b, opp, cap, 0, nr);
    opp.head = wrap(opp.head + nr, cap);
    opp.hi = max(opp.hi - nr, 0);
    opp.count -= nr;
  }
  const long long rem = static_cast<long long>(volume) - total;
  rem_out = static_cast<T>(rem);
  AddResult res{nf, 0, 0};
  if (rem > 0 && !mkt) {
    if (own.count >= cap) {
      res.book_overflow = 1;
    } else {
      const int pos = insert_pos(b, own, cap, is_buy, price);
      const int end = min(own.hi, cap - 1);  // a live slot cap-1 is dropped
      plan = pos < end - pos ? Plan{0, pos, -1, -1, -1, pos}
                             : Plan{pos, end, +1, -1, 0, pos};
      // pos can pass hi only when the row came in with count > cap.
      own.hi = max(min(own.hi + 1, cap), pos + 1);
      own.count += 1;
      res.rested = 1;
    }
    nseq += 1;
  }
  return res;
}

// Sums over a cancel's hits (live slots with this oid and exact price).
struct Part {
  int hits;
  int pos;        // sum of the hit slots (at most cap * cap <= 2^28)
  long long vol;  // sum of their lots
};

// This thread's share of a cancel scan of the live run [0, live) of the
// side at array offset `off` with ring head `head`: the run's (at most
// two) physical segments, 16 bytes of oids per thread and step where the
// arrays allow it, team threads apart.
template <typename T>
__device__ __forceinline__ Part cancel_scan(const Book<T>& b, int off, int head,
                                            int live, int cap, T price, T oid,
                                            bool vec, int rank, int team) {
  const int first = min(live, cap - head);  // live run before the wrap
  const T* oids = b.oid + off;
  const T* prices = b.price + off;
  const T* lots = b.lots + off;
  Part t{0, 0, 0};
#pragma unroll 1
  for (int seg = 0; seg < 2; ++seg) {
    const int lo = seg == 0 ? head : 0;
    const int hi = seg == 0 ? head + first : live - first;
    const int shift = seg == 0 ? -head : cap - head;
    if (vec) {
      constexpr int E = 16 / sizeof(T);
      using V = typename Vec16<T>::type;
      const int g_end = (hi + E - 1) / E;
#pragma unroll 2
      for (int g = lo / E + rank; g < g_end; g += team) {
        const V o = reinterpret_cast<const V*>(oids)[g];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int q = g * E + e;
          if (elem(o, e) == oid && q >= lo && q < hi && prices[q] == price) {
            ++t.hits;
            t.pos += q + shift;
            t.vol += static_cast<long long>(lots[q]);
          }
        }
      }
    } else {
      for (int q = lo + rank; q < hi; q += team) {
        if (oids[q] == oid && prices[q] == price) {
          ++t.hits;
          t.pos += q + shift;
          t.vol += static_cast<long long>(lots[q]);
        }
      }
    }
  }
  return t;
}

// The team's totals of a cancel scan, in every thread of the team. A team
// of several warps adds the warps' sums through `parts` (shared memory);
// its barrier ends the job.
template <typename T>
__device__ __forceinline__ Part cancel_totals(const Book<T>& b, int off,
                                              int head, int live, int cap,
                                              T price, T oid, bool vec,
                                              int rank, int team,
                                              Part* parts) {
  Part t = cancel_scan(b, off, head, live, cap, price, oid, vec, rank, team);
  t.hits = __reduce_add_sync(kFull, t.hits);
  if (t.hits != 0) {
    t.pos = __reduce_add_sync(kFull, t.pos);
    t.vol = warp_sum(t.vol);
  }
  if (team == kWarp) return t;
  if (lane_id() == 0) parts[threadIdx.x / kWarp] = t;
  team_sync(team);
  t = Part{0, 0, 0};
  for (int w = 0; w < team / kWarp; ++w) {
    t.hits += parts[w].hits;
    t.pos += parts[w].pos;
    t.vol += parts[w].vol;
  }
  return t;
}

// DEL: plan the removal of the cancel whose hit totals are `t`. The
// position and volume are sums over the hits, as in the reference
// (duplicate oids).
template <typename T>
__device__ __forceinline__ int del_plan(Side& own, int cap, const Part& t,
                                        T& vol_out, Plan& plan) {
  if (t.hits == 0) {
    vol_out = 0;
    return 0;
  }
  vol_out = static_cast<T>(t.vol);
  const int lo = t.pos < cap ? t.pos : cap;
  if (lo < own.hi) {  // at or past hi every slot is zero: nothing moves
    plan = lo < own.hi - 1 - lo ? Plan{0, lo, +1, 0, +1, -1}
                                : Plan{lo + 1, own.hi, -1, own.hi - 1, 0, -1};
    own.hi -= 1;
  }
  own.count -= 1;
  return 1;
}

// Work that warp 0 hands to the helper warps of a several-warp team.
enum JobKind { kJobMove, kJobScan, kJobDone };

template <typename T>
struct Job {
  int kind;
  int off, head;  // the side (kJobMove, kJobScan)
  int a, e, d;    // kJobMove: the move; kJobDone: a, e = final buy, sale heads
  int live;       // kJobScan
  T price, oid;   // kJobScan
};

template <typename T>
struct OpChunk {
  int action, side, market;
  T price, volume, oid, uid;
};

template <typename T>
__device__ __forceinline__ OpChunk<T> load_ops(const Params& prm, size_t o0,
                                               int n) {
  OpChunk<T> c{0, 0, 0, 0, 0, 0, 0};
  const int lane = lane_id();
  if (lane < n) {
    const size_t o = o0 + lane;
    c.action = static_cast<const int*>(prm.p[kOpAction])[o];
    c.side = static_cast<const int*>(prm.p[kOpSide])[o];
    c.market = static_cast<const int*>(prm.p[kOpMarket])[o];
    c.price = static_cast<const T*>(prm.p[kOpPrice])[o];
    c.volume = static_cast<const T*>(prm.p[kOpVolume])[o];
    c.oid = static_cast<const T*>(prm.p[kOpOid])[o];
    c.uid = static_cast<const T*>(prm.p[kOpUid])[o];
  }
  return c;
}

// Zero the records of the ops in a chunk whose bit is set in `mask`
// (records of ops [0, n) start at element rec0 of each field).
template <typename T>
__device__ __forceinline__ void zero_records(const Records<T>& r, size_t rec0,
                                             int n, int K, unsigned mask,
                                             bool vec) {
  const int lane = lane_id();
  T* const f[7] = {r.price, r.qty, r.moid, r.muid, r.prefill, r.remaining,
                   r.taker};
  if (vec) {
    const int per = K * static_cast<int>(sizeof(T)) / 16;
    const int nv = n * per;
    const int4 z = make_int4(0, 0, 0, 0);
    for (int v = lane; v < nv; v += kWarp) {
      if (!((mask >> (v / per)) & 1u)) continue;
#pragma unroll
      for (int j = 0; j < 7; ++j) reinterpret_cast<int4*>(f[j] + rec0)[v] = z;
    }
  } else {
    const int ne = n * K;
    for (int e = lane; e < ne; e += kWarp) {
      if (!((mask >> (e / K)) & 1u)) continue;
#pragma unroll
      for (int j = 0; j < 7; ++j) f[j][rec0 + e] = 0;
    }
  }
}

// -- once per row (not inlined: they stay out of the op loop's code). Each
// thread of the row's team (rank of team threads) takes its share. -------

// Copy n elements into the working book: 16-byte cp.async into shared
// memory when `async` (the caller waits), else one element per step.
template <typename V>
__device__ __noinline__ void copy_in(V* dst, const V* src, int n, bool async,
                                     int rank, int team) {
  if (async) {
    const int nv = n * static_cast<int>(sizeof(V)) / 16;
    for (int v = rank; v < nv; v += team) {
      const unsigned d = static_cast<unsigned>(
          __cvta_generic_to_shared(reinterpret_cast<char*>(dst) + 16 * v));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(reinterpret_cast<const char*>(src) + 16 * v)
                   : "memory");
    }
  } else {
    for (int i = rank; i < n; i += team) dst[i] = src[i];
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// This thread's last slot at or past `live`, in a side whose ring starts
// at physical 0, that is nonzero in any field (-1 if none).
template <typename T>
__device__ __noinline__ int zero_mark(const T* price, const T* lots,
                                      const int* seq, const T* oid,
                                      const T* uid, int live, int cap,
                                      int rank, int team) {
  int last = -1;
#pragma unroll 4
  for (int i = live + rank; i < cap; i += team) {
    if (price[i] != 0 || lots[i] != 0 || seq[i] != 0 || oid[i] != 0 ||
        uid[i] != 0)
      last = i;
  }
  return last;
}

// Write a ring of cap slots to `out` in logical order: one 16-byte store
// per step when `vec` (cap a multiple of the vector width, 16-byte aligned
// arrays), gathering from the ring with one vector load where the run does
// not wrap.
template <typename V>
__device__ __noinline__ void copy_out(V* out, const V* ring, int head, int cap,
                                      bool vec, int rank, int team) {
  if (vec) {
    constexpr int E = 16 / sizeof(V);
    using W = typename Vec16<V>::type;
    const int nv = cap / E;
    for (int v = rank; v < nv; v += team) {
      const int q = wrap(head + v * E, cap);
      W x;
      if (q % E == 0) {
        x = reinterpret_cast<const W*>(ring)[q / E];
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) set_elem(x, e, ring[wrap(q + e, cap)]);
      }
      reinterpret_cast<W*>(out)[v] = x;
    }
  } else {
    for (int i = rank; i < cap; i += team) out[i] = ring[wrap(head + i, cap)];
  }
}

// Zero n 4-byte words from p: single words up to the first 16-byte
// boundary and after the last, 16-byte stores between.
__device__ __noinline__ void zero_words(int* p, size_t n, int rank, int team) {
  const size_t lead =
      min(n, ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / 4);
  for (size_t i = rank; i < lead; i += team) p[i] = 0;
  int* q = p + lead;
  const size_t m = n - lead;
  const size_t nv = m / 4;
  const int4 z = make_int4(0, 0, 0, 0);
  for (size_t v = rank; v < nv; v += team) reinterpret_cast<int4*>(q)[v] = z;
  for (size_t i = nv * 4 + rank; i < m; i += team) q[i] = 0;
}

template <typename V>
__device__ __forceinline__ void zero_span(V* p, size_t n, int rank, int team) {
  zero_words(reinterpret_cast<int*>(p), n * sizeof(V) / 4, rank, team);
}

// In place: a[i] = old a[(h + i) % n], by three reversals.
template <typename V>
__device__ __noinline__ void rotate_left(V* a, int n, int h, int rank,
                                         int team) {
  const int lo[3] = {0, h, 0}, hi[3] = {h, n, n};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int m = (hi[r] - lo[r]) / 2;
    for (int k = rank; k < m; k += team) {
      const V x = a[lo[r] + k];
      a[lo[r] + k] = a[hi[r] - 1 - k];
      a[hi[r] - 1 - k] = x;
    }
    team_sync(team);
  }
}

__host__ __device__ __forceinline__ size_t row_bytes(int cap, int vb) {
  const size_t b = static_cast<size_t>(2) * cap * (4 * vb + 4);
  return (b + 15) / 16 * 16;
}

// One row per CTA. W == 1: the CTA's one warp runs it. W > 1: the CTA's W
// warps run it; warp 0 runs its ops and hands the linear parts (moves
// and cancel scans) to the team as jobs; the once-per-row steps are shared.
template <typename T, bool kShared, int W>
__global__ void __launch_bounds__(kMaxWarpsPerCta * kWarp)
match_step_kernel(const Params prm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Job<T> s_job;
  __shared__ Part s_part[kMaxWarpsPerCta];
  __shared__ int s_mark[kMaxWarpsPerCta][2];

  constexpr int kTeam = W * kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = lane_id();
  const int rank = W == 1 ? lane : static_cast<int>(threadIdx.x);
  const bool lead = W == 1 || warp == 0;
  const int row = static_cast<int>(blockIdx.x);
  if (row >= prm.rows) return;
  const int cap = prm.cap;
  const int K = prm.k;
  const int t_len = prm.t_len;
  const size_t row_off = static_cast<size_t>(row) * 2 * cap;

  const T* in_price = static_cast<const T*>(prm.p[kInPrice]) + row_off;
  const T* in_lots = static_cast<const T*>(prm.p[kInLots]) + row_off;
  const int* in_seq = static_cast<const int*>(prm.p[kInSeq]) + row_off;
  const T* in_oid = static_cast<const T*>(prm.p[kInOid]) + row_off;
  const T* in_uid = static_cast<const T*>(prm.p[kInUid]) + row_off;
  T* out_price = static_cast<T*>(prm.p[kOutPrice]) + row_off;
  T* out_lots = static_cast<T*>(prm.p[kOutLots]) + row_off;
  int* out_seq = static_cast<int*>(prm.p[kOutSeq]) + row_off;
  T* out_oid = static_cast<T*>(prm.p[kOutOid]) + row_off;
  T* out_uid = static_cast<T*>(prm.p[kOutUid]) + row_off;

  // Working book: this row's slice of shared memory, or the output rows.
  Book<T> b;
  if (kShared) {
    T* base = reinterpret_cast<T*>(smem_raw);
    b = Book<T>{base, base + 2 * cap, reinterpret_cast<int*>(base + 8 * cap),
                base + 4 * cap, base + 6 * cap};
  } else {
    b = Book<T>{out_price, out_lots, out_seq, out_oid, out_uid};
  }
  // 16-byte copies need even caps (so every row and field starts on 16
  // bytes) and aligned tensors.
  const bool async = kShared && cap % 2 == 0 && aligned16(in_price) &&
                     aligned16(in_lots) && aligned16(in_seq) &&
                     aligned16(in_oid) && aligned16(in_uid);
  copy_in(b.price, in_price, 2 * cap, async, rank, kTeam);
  copy_in(b.lots, in_lots, 2 * cap, async, rank, kTeam);
  copy_in(b.seq, in_seq, 2 * cap, async, rank, kTeam);
  copy_in(b.oid, in_oid, 2 * cap, async, rank, kTeam);
  copy_in(b.uid, in_uid, 2 * cap, async, rank, kTeam);
  // While the book loads: the first 32 ops, and t_end, past which every op
  // is a NOP (those get their zero outputs in bulk).
  const size_t op_row = static_cast<size_t>(row) * t_len;
  OpChunk<T> next{0, 0, 0, 0, 0, 0, 0};
  if (lead) next = load_ops<T>(prm, op_row, min(kWarp, t_len));
  const int* action = static_cast<const int*>(prm.p[kOpAction]) + op_row;
  int last = -1;
#pragma unroll 4
  for (int t = lane; t < t_len; t += kWarp)
    if (action[t] != 0) last = t;
  const int t_end = min(t_len, (__reduce_max_sync(kFull, last) + kWarp) /
                                   kWarp * kWarp);
  if (async) cp_async_wait_all();
  team_sync(kTeam);

  const int* in_count = static_cast<const int*>(prm.p[kInCount]);
  Side buy{0, 0, 0, in_count[2 * row]};
  Side sale{cap, 0, 0, in_count[2 * row + 1]};
  {
    const int live_b = min(buy.count, cap), live_s = min(sale.count, cap);
    int mb = __reduce_max_sync(
        kFull, zero_mark(b.price, b.lots, b.seq, b.oid, b.uid, live_b, cap,
                         rank, kTeam));
    int ms = __reduce_max_sync(
        kFull, zero_mark(b.price + cap, b.lots + cap, b.seq + cap,
                         b.oid + cap, b.uid + cap, live_s, cap, rank, kTeam));
    if (W > 1) {
      if (lane == 0) {
        s_mark[warp][0] = mb;
        s_mark[warp][1] = ms;
      }
      team_sync(kTeam);
      for (int w = 0; w < W; ++w) {
        mb = max(mb, s_mark[w][0]);
        ms = max(ms, s_mark[w][1]);
      }
    }
    buy.hi = max(mb + 1, live_b);
    sale.hi = max(ms + 1, live_s);
  }
  int nseq = static_cast<const int*>(prm.p[kInNextSeq])[row];

  const Records<T> rec{
      static_cast<T*>(prm.p[kFillPrice]), static_cast<T*>(prm.p[kFillQty]),
      static_cast<T*>(prm.p[kMakerOid]), static_cast<T*>(prm.p[kMakerUid]),
      static_cast<T*>(prm.p[kMakerPrefill]),
      static_cast<T*>(prm.p[kMakerRemaining]),
      static_cast<T*>(prm.p[kTakerAfter])};
  bool vec_rec = (K * sizeof(T)) % 16 == 0;
#pragma unroll
  for (int j = kFillPrice; j <= kTakerAfter; ++j)
    vec_rec = vec_rec && aligned16(prm.p[j]);
  // 16-byte access to a side's slots: cap a multiple of the vector width
  // (every side starts on 16 bytes), aligned arrays.
  const bool vec_t = cap % (16 / sizeof(T)) == 0 && aligned16(b.oid) &&
                     aligned16(out_price) && aligned16(out_lots) &&
                     aligned16(out_oid) && aligned16(out_uid);
  const bool vec_seq = cap % 4 == 0 && aligned16(b.seq) && aligned16(out_seq);

  if (!lead) {
    // A helper warp: run warp 0's jobs until it is done with the ops.
    for (;;) {
      team_sync(kTeam);
      const Job<T> j = s_job;
      if (j.kind == kJobDone) {
        buy.head = j.a;
        sale.head = j.e;
        break;
      }
      if (j.kind == kJobMove) {
        move_slots(b, Side{j.off, j.head, 0, 0}, cap, j.a, j.e, j.d, rank,
                   kTeam);
      } else {
        cancel_totals(b, j.off, j.head, j.live, cap, j.price, j.oid, vec_t,
                      rank, kTeam, s_part);
      }
    }
  } else {
    for (int t0 = 0; t0 < t_end; t0 += kWarp) {
      const OpChunk<T> cur = next;
      const int n = min(kWarp, t_len - t0);
      if (t0 + kWarp < t_end)
        next = load_ops<T>(prm, op_row + t0 + kWarp,
                           min(kWarp, t_end - t0 - kWarp));
      unsigned live = __ballot_sync(kFull, cur.action != 0);
      const unsigned adds = __ballot_sync(kFull, cur.action == kActionAdd);

      // This lane's op's scalars (op t0 + lane).
      int s_nf = 0, s_rested = 0, s_overflow = 0, s_found = 0;
      T s_rem = 0, s_cvol = 0;
      while (live) {
        const int j = __ffs(live) - 1;
        live &= live - 1;
        const int action = __shfl_sync(kFull, cur.action, j);
        if (action != kActionAdd && action != kActionDel) continue;
        const bool is_buy = __shfl_sync(kFull, cur.side, j) == 0;
        const T price = __shfl_sync(kFull, cur.price, j);
        const T oid = __shfl_sync(kFull, cur.oid, j);
        Side own = is_buy ? buy : sale;
        Side opp = is_buy ? sale : buy;
        Plan plan{0, 0, 0, -1, 0, -1};
        T rem = 0, uid = 0;
        if (action == kActionAdd) {
          const bool mkt = __shfl_sync(kFull, cur.market, j) != 0;
          const T volume = __shfl_sync(kFull, cur.volume, j);
          uid = __shfl_sync(kFull, cur.uid, j);
          const AddResult a =
              add_op(b, opp, own, cap, K, rec, (op_row + t0 + j) * K, is_buy,
                     mkt, price, volume, nseq, rem, plan);
          if (lane == j) {
            s_nf = a.n_fills;
            s_rested = a.rested;
            s_overflow = a.book_overflow;
            s_rem = rem;
          }
        } else {
          const int live_own = min(own.count, cap);
          if (W > 1) {
            if (lane == 0)
              s_job = Job<T>{kJobScan, own.off, own.head, 0, 0, 0, live_own,
                             price, oid};
            team_sync(kTeam);
          }
          const Part t = cancel_totals(b, own.off, own.head, live_own, cap,
                                       price, oid, vec_t, rank, kTeam, s_part);
          T vol;
          const int found = del_plan(own, cap, t, vol, plan);
          if (lane == j) {
            s_found = found;
            s_cvol = vol;
          }
        }
        // The own side's move, clear and insert: one code path for all ops.
        if (plan.a < plan.e) {
          if (W > 1) {
            if (lane == 0)
              s_job = Job<T>{kJobMove, own.off, own.head, plan.a, plan.e,
                             plan.d, 0, 0, 0};
            team_sync(kTeam);
          }
          move_slots(b, own, cap, plan.a, plan.e, plan.d, rank, kTeam);
        }
        if (plan.clear >= 0)
          zero_slots(b, own, cap, plan.clear, plan.clear + 1);
        own.head = wrap(own.head + plan.dh, cap);
        if (plan.put >= 0) {
          if (lane == 0) {
            const int q = at(own, plan.put, cap);
            b.price[q] = price;
            b.lots[q] = rem;
            b.seq[q] = nseq;
            b.oid[q] = oid;
            b.uid[q] = uid;
          }
          __syncwarp();
        }
        buy = is_buy ? own : opp;
        sale = is_buy ? opp : own;
      }
      if (lane < n) {
        const size_t o = op_row + t0 + lane;
        static_cast<int*>(prm.p[kNFills])[o] = s_nf;
        static_cast<int*>(prm.p[kFillOverflow])[o] = s_nf > K ? s_nf - K : 0;
        static_cast<T*>(prm.p[kTakerRemaining])[o] = s_rem;
        static_cast<int*>(prm.p[kRested])[o] = s_rested;
        static_cast<int*>(prm.p[kBookOverflow])[o] = s_overflow;
        static_cast<int*>(prm.p[kCancelFound])[o] = s_found;
        static_cast<T*>(prm.p[kCancelVolume])[o] = s_cvol;
      }
      const unsigned in_chunk = n == kWarp ? kFull : (1u << n) - 1u;
      const unsigned no_records = ~adds & in_chunk;
      if (no_records)
        zero_records(rec, (op_row + t0) * K, n, K, no_records, vec_rec);
    }
    if (W > 1) {
      if (lane == 0)
        s_job = Job<T>{kJobDone, 0, 0, buy.head, sale.head, 0, 0, 0, 0};
      team_sync(kTeam);
    }
  }

  if (t_end < t_len) {
    const size_t o = op_row + t_end, n = t_len - t_end;
    zero_span(rec.price + o * K, n * K, rank, kTeam);
    zero_span(rec.qty + o * K, n * K, rank, kTeam);
    zero_span(rec.moid + o * K, n * K, rank, kTeam);
    zero_span(rec.muid + o * K, n * K, rank, kTeam);
    zero_span(rec.prefill + o * K, n * K, rank, kTeam);
    zero_span(rec.remaining + o * K, n * K, rank, kTeam);
    zero_span(rec.taker + o * K, n * K, rank, kTeam);
    zero_span(static_cast<int*>(prm.p[kNFills]) + o, n, rank, kTeam);
    zero_span(static_cast<int*>(prm.p[kFillOverflow]) + o, n, rank, kTeam);
    zero_span(static_cast<T*>(prm.p[kTakerRemaining]) + o, n, rank, kTeam);
    zero_span(static_cast<int*>(prm.p[kRested]) + o, n, rank, kTeam);
    zero_span(static_cast<int*>(prm.p[kBookOverflow]) + o, n, rank, kTeam);
    zero_span(static_cast<int*>(prm.p[kCancelFound]) + o, n, rank, kTeam);
    zero_span(static_cast<T*>(prm.p[kCancelVolume]) + o, n, rank, kTeam);
  }

  if (kShared) {
    copy_out(out_price, b.price, buy.head, cap, vec_t, rank, kTeam);
    copy_out(out_lots, b.lots, buy.head, cap, vec_t, rank, kTeam);
    copy_out(out_seq, b.seq, buy.head, cap, vec_seq, rank, kTeam);
    copy_out(out_oid, b.oid, buy.head, cap, vec_t, rank, kTeam);
    copy_out(out_uid, b.uid, buy.head, cap, vec_t, rank, kTeam);
    copy_out(out_price + cap, b.price + cap, sale.head, cap, vec_t, rank,
             kTeam);
    copy_out(out_lots + cap, b.lots + cap, sale.head, cap, vec_t, rank, kTeam);
    copy_out(out_seq + cap, b.seq + cap, sale.head, cap, vec_seq, rank, kTeam);
    copy_out(out_oid + cap, b.oid + cap, sale.head, cap, vec_t, rank, kTeam);
    copy_out(out_uid + cap, b.uid + cap, sale.head, cap, vec_t, rank, kTeam);
  } else {
    for (int s = 0; s < 2; ++s) {
      const int h = s == 0 ? buy.head : sale.head;
      if (h == 0) continue;
      rotate_left(b.price + s * cap, cap, h, rank, kTeam);
      rotate_left(b.lots + s * cap, cap, h, rank, kTeam);
      rotate_left(b.seq + s * cap, cap, h, rank, kTeam);
      rotate_left(b.oid + s * cap, cap, h, rank, kTeam);
      rotate_left(b.uid + s * cap, cap, h, rank, kTeam);
    }
  }
  if (rank == 0) {
    int* out_count = static_cast<int*>(prm.p[kOutCount]);
    out_count[2 * row] = buy.count;
    out_count[2 * row + 1] = sale.count;
    static_cast<int*>(prm.p[kOutNextSeq])[row] = nseq;
  }
}

template <typename T, bool kShared, int W>
int launch(const Params& prm, size_t smem, cudaStream_t stream) {
  auto kernel = match_step_kernel<T, kShared, W>;
  if (kShared) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<prm.rows, W * kWarp, kShared ? smem : 0, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& prm, bool shared, size_t per_row,
             cudaStream_t st) {
  if (!shared) return launch<T, false, kMaxWarpsPerCta>(prm, 0, st);
  if (per_row >= kTeamRowBytes)
    return launch<T, true, kMaxWarpsPerCta>(prm, per_row, st);
  return launch<T, true, 1>(prm, per_row, st);
}

}  // namespace

extern "C" {

// Bytes of shared memory one row's working book takes.
size_t gome_match_step_smem_bytes(int cap, int value_bytes) {
  return row_bytes(cap, value_bytes);
}

// Largest working book (bytes) the shared-memory instantiation can hold on
// the current device, or -1 on error (the kernel's static shared memory,
// under 256 bytes, is kept aside).
long long gome_match_step_smem_limit(void) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return static_cast<long long>(optin) - 256;
}

// Launch the match step on `stream`. ptrs holds kNumPtrs device pointers
// (see Ptr). value_bytes is 4 (int32 books) or 8 (int64). use_shared picks
// the shared-memory instantiation. Returns a cudaError_t (0 on success).
// Every row gets a CTA of its own: of four warps for rows of at least
// kTeamRowBytes and for rows in device memory, else of one warp.
int gome_match_step(void* const* ptrs, int rows, int t_len, int cap, int k,
                    int value_bytes, int use_shared, void* stream) {
  if (rows <= 0 || t_len <= 0 || cap <= 0 || k <= 0 || k > cap)
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm;
  for (int i = 0; i < kNumPtrs; ++i) prm.p[i] = ptrs[i];
  prm.rows = rows;
  prm.t_len = t_len;
  prm.cap = cap;
  prm.k = k;
  const size_t per_row = row_bytes(cap, value_bytes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (value_bytes == 4) return dispatch<int>(prm, use_shared, per_row, st);
  if (value_bytes == 8) return dispatch<long long>(prm, use_shared, per_row, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* gome_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
