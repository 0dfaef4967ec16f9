// Batched match step for NVIDIA Hopper (sm_90a): T sequential book ops for
// every row of an [S, T] op grid, one CTA per row.
//
// Replaces gome_tpu/ops/pallas_match.py::_kernel / pallas_batch_step (the
// Pallas TPU kernel; pallas_call at pallas_match.py:306). The semantics are
// those of gome_tpu/engine/step.py::step_rows_impl, written out here for one
// book held by one thread block; the plain PyTorch version of the same math
// is gome_tpu_torch/engine/step.py::step_rows, looped over T in
// gome_tpu_torch/ops/match_step.py::batch_step_reference.
//
// What bounds it on this card. Each row reads its [2, cap] book once and
// writes it once, reads its T ops, and writes T * (7 * K + 7) outputs: at
// S=10,240, cap=256, K=16, T=32, int32 that is about 0.37 GB, 0.11 ms at
// 3.35 TB/s. The op chain of one row is strictly sequential (every op reads
// the book the previous op wrote), so the work is latency-bound per row:
// each op is a block-wide scan, a few block reductions and up to two
// data-dependent shifts, each of which costs __syncthreads() round trips.
//
// What the design does about it:
//   * the book stays in shared memory for all T ops (read from and written
//     to device memory once per row, like the TPU kernel's VMEM residency);
//     rows run in parallel, many CTAs per SM, to hide the barrier latency;
//   * the prefix sum is a warp-shuffle scan plus one shared-memory pass over
//     the warp totals; in 32-bit books every add saturates at SAT32_MAX,
//     which gives min(true prefix, SAT32_MAX) in any summation order, the
//     value the reference's Hillis-Steele scan produces;
//   * compaction, insert and cancel are shared-memory gathers: every thread
//     reads the sources of its slots into registers, one barrier, then
//     writes (one barrier per field, reads of the next field overlap the
//     writes of the previous one). The TPU's log-shift trick is not needed;
//   * every StepOutput leaf (fill_qty and taker_after included) is written
//     straight into its [S, T, K] / [S, T] output: no packs or transposes;
//   * the kernel is templated on the value type (int32, int64): the default
//     int64 BookConfig runs here too;
//   * caps whose book does not fit the 227 KB of shared memory (10 rows x
//     cap: above ~5,800 at int32, ~3,200 at int64) run a second
//     instantiation of the same kernel on the output rows in device memory.
//
// The kernel never writes its inputs: callers keep the pre-grid books for
// replay and rollback. It launches on the caller's stream and returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 32;
constexpr int kMaxThreads = 1024;
constexpr int kMaxSlotsPerThread = 16;
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
  int s = a + b;
  return s < kSat32 ? s : static_cast<int>(kSat32);
}
__device__ __forceinline__ long long sat_add(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}
__device__ __forceinline__ int sat_in(int x) {
  return x < kSat32 ? x : static_cast<int>(kSat32);
}
__device__ __forceinline__ long long sat_in(long long x) { return x; }

// Sum three values over the block; every thread gets the totals.
__device__ __forceinline__ void block_sum3(long long& a, long long& b,
                                           long long& c,
                                           long long (*red)[kMaxWarps]) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int nwarps = blockDim.x / kWarp;
#pragma unroll
  for (int d = kWarp / 2; d > 0; d >>= 1) {
    a += __shfl_xor_sync(kFull, a, d);
    b += __shfl_xor_sync(kFull, b, d);
    c += __shfl_xor_sync(kFull, c, d);
  }
  __syncthreads();  // the previous reduction's readers are done with red
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
    red[2][warp] = c;
  }
  __syncthreads();
  a = b = c = 0;
  for (int w = 0; w < nwarps; ++w) {
    a += red[0][w];
    b += red[1][w];
    c += red[2][w];
  }
}

// One field of a data-dependent shift, slots [lo, cap):
//   new[i] = entry            if insert and i == lo
//          = old[i + d]       if i + d < cap
//          = 0                otherwise.
// Stage reads the sources into registers; commit writes them after a
// barrier. The caller puts one __syncthreads() between stage and commit of
// a field and one after the last commit.
template <typename V, int P>
__device__ __forceinline__ void shift_stage(const V* f, int cap, int lo, int d,
                                            bool insert, V entry, V (&buf)[P]) {
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int i = threadIdx.x * P + j;
    if (i < cap && i >= lo) {
      const int s = i + d;
      buf[j] = (insert && i == lo) ? entry : (s < cap ? f[s] : V(0));
    }
  }
}

template <typename V, int P>
__device__ __forceinline__ void shift_commit(V* f, int cap, int lo,
                                             const V (&buf)[P]) {
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int i = threadIdx.x * P + j;
    if (i < cap && i >= lo) f[i] = buf[j];
  }
}

template <typename T>
struct SideRef {
  T* price;
  T* lots;
  int* seq;
  T* oid;
  T* uid;
};

template <typename T, int P>
__device__ void shift_side(const SideRef<T>& s, int cap, int lo, int d,
                           bool insert, T e_price, T e_lots, int e_seq,
                           T e_oid, T e_uid) {
  T buf[P];
  int sbuf[P];
  shift_stage<T, P>(s.price, cap, lo, d, insert, e_price, buf);
  __syncthreads();
  shift_commit<T, P>(s.price, cap, lo, buf);
  shift_stage<T, P>(s.lots, cap, lo, d, insert, e_lots, buf);
  __syncthreads();
  shift_commit<T, P>(s.lots, cap, lo, buf);
  shift_stage<int, P>(s.seq, cap, lo, d, insert, e_seq, sbuf);
  __syncthreads();
  shift_commit<int, P>(s.seq, cap, lo, sbuf);
  shift_stage<T, P>(s.oid, cap, lo, d, insert, e_oid, buf);
  __syncthreads();
  shift_commit<T, P>(s.oid, cap, lo, buf);
  shift_stage<T, P>(s.uid, cap, lo, d, insert, e_uid, buf);
  __syncthreads();
  shift_commit<T, P>(s.uid, cap, lo, buf);
  __syncthreads();
}

template <typename T, int P, bool kShared>
__global__ void __launch_bounds__(kMaxThreads)
match_step_kernel(const Params prm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T scan_buf[kMaxWarps];
  __shared__ long long red[3][kMaxWarps];

  const int row = blockIdx.x;
  const int cap = prm.cap;
  const int K = prm.k;
  const int t_len = prm.t_len;
  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid / kWarp;
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

  // Working book [2 * cap] per field: shared memory, or the output rows.
  T *w_price, *w_lots, *w_oid, *w_uid;
  int* w_seq;
  if (kShared) {
    T* base = reinterpret_cast<T*>(smem_raw);
    w_price = base;
    w_lots = base + 2 * cap;
    w_oid = base + 4 * cap;
    w_uid = base + 6 * cap;
    w_seq = reinterpret_cast<int*>(base + 8 * cap);
  } else {
    w_price = out_price;
    w_lots = out_lots;
    w_oid = out_oid;
    w_uid = out_uid;
    w_seq = out_seq;
  }
  for (int i = tid; i < 2 * cap; i += blockDim.x) {
    w_price[i] = in_price[i];
    w_lots[i] = in_lots[i];
    w_seq[i] = in_seq[i];
    w_oid[i] = in_oid[i];
    w_uid[i] = in_uid[i];
  }
  const int* in_count = static_cast<const int*>(prm.p[kInCount]);
  int cnt[2] = {in_count[2 * row], in_count[2 * row + 1]};
  int nseq = static_cast<const int*>(prm.p[kInNextSeq])[row];
  __syncthreads();

  const int* op_action = static_cast<const int*>(prm.p[kOpAction]);
  const int* op_side = static_cast<const int*>(prm.p[kOpSide]);
  const int* op_market = static_cast<const int*>(prm.p[kOpMarket]);
  const T* op_price = static_cast<const T*>(prm.p[kOpPrice]);
  const T* op_volume = static_cast<const T*>(prm.p[kOpVolume]);
  const T* op_oid = static_cast<const T*>(prm.p[kOpOid]);
  const T* op_uid = static_cast<const T*>(prm.p[kOpUid]);
  T* r_price = static_cast<T*>(prm.p[kFillPrice]);
  T* r_qty = static_cast<T*>(prm.p[kFillQty]);
  T* r_moid = static_cast<T*>(prm.p[kMakerOid]);
  T* r_muid = static_cast<T*>(prm.p[kMakerUid]);
  T* r_prefill = static_cast<T*>(prm.p[kMakerPrefill]);
  T* r_remaining = static_cast<T*>(prm.p[kMakerRemaining]);
  T* r_taker = static_cast<T*>(prm.p[kTakerAfter]);

  for (int t = 0; t < t_len; ++t) {
    const size_t o = static_cast<size_t>(row) * t_len + t;
    const size_t rec = o * K;
    const int action = op_action[o];
    const int is_buy = op_side[o] == 0;
    const int own = is_buy ? 0 : 1;
    const int opp = 1 - own;
    const T price = op_price[o];
    const T volume = op_volume[o];
    const T oid = op_oid[o];

    int n_fills = 0, rested = 0, book_overflow = 0, cancel_found = 0;
    T taker_remaining = 0, cancel_volume = 0;

    if (action == kActionAdd) {
      const int mkt = op_market[o] != 0;
      const SideRef<T> os{w_price + opp * cap, w_lots + opp * cap,
                          w_seq + opp * cap, w_oid + opp * cap,
                          w_uid + opp * cap};
      const int oc = cnt[opp];
      // Crossing lots of this thread's slots and their (saturating) sum.
      T run = 0;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int i = tid * P + j;
        if (i < cap && i < oc) {
          const T pr = os.price[i];
          if (mkt || (is_buy ? pr <= price : pr >= price))
            run = sat_add(run, sat_in(os.lots[i]));
        }
      }
      // Block-wide exclusive scan of the thread totals.
      T incl = run;
#pragma unroll
      for (int d = 1; d < kWarp; d <<= 1) {
        const T n = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl = sat_add(incl, n);
      }
      T cum = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) cum = 0;
      if (lane == kWarp - 1) scan_buf[warp] = incl;
      __syncthreads();
      T woff = 0;
      for (int w = 0; w < warp; ++w) woff = sat_add(woff, scan_buf[w]);
      cum = sat_add(woff, cum);

      // Fills, fill records, new lots (own slots only).
      long long total = 0, nf = 0, nr = 0;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int i = tid * P + j;
        if (i < cap) {
          const T lots = os.lots[i];
          T c = 0;
          if (i < oc) {
            const T pr = os.price[i];
            if (mkt || (is_buy ? pr <= price : pr >= price)) c = lots;
          }
          T f = volume - cum;
          if (f < 0) f = 0;
          if (f > c) f = c;
          const T nl = lots - f;
          if (f > 0) {
            ++nf;
            if (nl == 0) ++nr;
          }
          total += f;
          if (i < K) {
            r_price[rec + i] = os.price[i];
            r_qty[rec + i] = f;
            r_moid[rec + i] = os.oid[i];
            r_muid[rec + i] = os.uid[i];
            r_prefill[rec + i] = lots;
            r_remaining[rec + i] = nl;
            r_taker[rec + i] = f > 0 ? T(volume - (cum + f)) : T(0);
          }
          os.lots[i] = nl;
          cum = sat_add(cum, sat_in(c));
        }
      }
      block_sum3(total, nf, nr, red);
      n_fills = static_cast<int>(nf);
      const int n_removed = static_cast<int>(nr);
      if (n_removed > 0) {
        shift_side<T, P>(os, cap, 0, n_removed, false, T(0), T(0), 0, T(0),
                         T(0));
        cnt[opp] -= n_removed;
      }
      const long long rem = static_cast<long long>(volume) - total;
      taker_remaining = static_cast<T>(rem);
      const bool do_rest = rem > 0 && !mkt;
      if (do_rest) {
        const bool overflow = cnt[own] >= cap;
        if (!overflow) {
          const SideRef<T> ws{w_price + own * cap, w_lots + own * cap,
                              w_seq + own * cap, w_oid + own * cap,
                              w_uid + own * cap};
          long long pos = 0, z1 = 0, z2 = 0;
#pragma unroll
          for (int j = 0; j < P; ++j) {
            const int i = tid * P + j;
            if (i < cap && i < cnt[own]) {
              const T pr = ws.price[i];
              if (is_buy ? pr >= price : pr <= price) ++pos;
            }
          }
          block_sum3(pos, z1, z2, red);
          shift_side<T, P>(ws, cap, static_cast<int>(pos), -1, true, price,
                           taker_remaining, nseq + 1, oid, op_uid[o]);
          cnt[own] += 1;
        }
        rested = !overflow;
        book_overflow = overflow;
        nseq += 1;
      }
    } else {
      if (action == kActionDel) {
        const SideRef<T> ws{w_price + own * cap, w_lots + own * cap,
                            w_seq + own * cap, w_oid + own * cap,
                            w_uid + own * cap};
        long long hits = 0, pos = 0, vol = 0;
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const int i = tid * P + j;
          if (i < cap && i < cnt[own] && ws.oid[i] == oid &&
              ws.price[i] == price) {
            ++hits;
            pos += i;
            vol += static_cast<long long>(ws.lots[i]);
          }
        }
        block_sum3(hits, pos, vol, red);
        if (hits > 0) {
          // pos is the sum of the hit slots (one slot for unique oids).
          const int lo = pos < cap ? static_cast<int>(pos) : cap;
          shift_side<T, P>(ws, cap, lo, 1, false, T(0), T(0), 0, T(0), T(0));
          cnt[own] -= 1;
          cancel_found = 1;
        }
        cancel_volume = static_cast<T>(vol);
      }
      // Non-ADD ops carry zero records.
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int i = tid * P + j;
        if (i < K) {
          r_price[rec + i] = 0;
          r_qty[rec + i] = 0;
          r_moid[rec + i] = 0;
          r_muid[rec + i] = 0;
          r_prefill[rec + i] = 0;
          r_remaining[rec + i] = 0;
          r_taker[rec + i] = 0;
        }
      }
    }
    if (tid == 0) {
      static_cast<int*>(prm.p[kNFills])[o] = n_fills;
      static_cast<int*>(prm.p[kFillOverflow])[o] =
          n_fills > K ? n_fills - K : 0;
      static_cast<T*>(prm.p[kTakerRemaining])[o] = taker_remaining;
      static_cast<int*>(prm.p[kRested])[o] = rested;
      static_cast<int*>(prm.p[kBookOverflow])[o] = book_overflow;
      static_cast<int*>(prm.p[kCancelFound])[o] = cancel_found;
      static_cast<T*>(prm.p[kCancelVolume])[o] = cancel_volume;
    }
  }

  if (kShared) {
    __syncthreads();
    for (int i = tid; i < 2 * cap; i += blockDim.x) {
      out_price[i] = w_price[i];
      out_lots[i] = w_lots[i];
      out_seq[i] = w_seq[i];
      out_oid[i] = w_oid[i];
      out_uid[i] = w_uid[i];
    }
  }
  if (tid == 0) {
    int* out_count = static_cast<int*>(prm.p[kOutCount]);
    out_count[2 * row] = cnt[0];
    out_count[2 * row + 1] = cnt[1];
    static_cast<int*>(prm.p[kOutNextSeq])[row] = nseq;
  }
}

template <typename T, int P, bool kShared>
int launch(const Params& prm, int threads, size_t smem, cudaStream_t stream) {
  auto kernel = match_step_kernel<T, P, kShared>;
  if (kShared) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<prm.rows, threads, kShared ? smem : 0, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kShared>
int dispatch_p(const Params& prm, int per, int threads, size_t smem,
               cudaStream_t stream) {
  switch (per) {
    case 1: return launch<T, 1, kShared>(prm, threads, smem, stream);
    case 2: return launch<T, 2, kShared>(prm, threads, smem, stream);
    case 4: return launch<T, 4, kShared>(prm, threads, smem, stream);
    case 8: return launch<T, 8, kShared>(prm, threads, smem, stream);
    case 16: return launch<T, 16, kShared>(prm, threads, smem, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Bytes of shared memory one row's working book takes.
size_t gome_match_step_smem_bytes(int cap, int value_bytes) {
  return static_cast<size_t>(2) * cap * (4 * value_bytes + 4);
}

// Largest working book (bytes) the shared-memory instantiation can hold on
// the current device, or -1 on error.
long long gome_match_step_smem_limit(void) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  // Static shared memory: scan_buf (up to 8 B x 32) and red (3 x 8 B x 32).
  const int static_bytes = kMaxWarps * 8 + 3 * kMaxWarps * 8;
  return static_cast<long long>(optin) - static_bytes;
}

// Launch the match step on `stream`. ptrs holds kNumPtrs device pointers
// (see Ptr). value_bytes is 4 (int32 books) or 8 (int64). use_shared picks
// the shared-memory instantiation. Returns a cudaError_t (0 on success).
int gome_match_step(void* const* ptrs, int rows, int t_len, int cap, int k,
                    int value_bytes, int use_shared, void* stream) {
  if (rows <= 0 || t_len <= 0 || cap <= 0 || k <= 0 || k > cap)
    return static_cast<int>(cudaErrorInvalidValue);
  int per = 1;
  while (per * kMaxThreads < cap) per <<= 1;
  if (per > kMaxSlotsPerThread) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((cap + per - 1) / per + kWarp - 1) / kWarp * kWarp;
  Params prm;
  for (int i = 0; i < kNumPtrs; ++i) prm.p[i] = ptrs[i];
  prm.rows = rows;
  prm.t_len = t_len;
  prm.cap = cap;
  prm.k = k;
  const size_t smem = gome_match_step_smem_bytes(cap, value_bytes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (value_bytes == 4) {
    return use_shared ? dispatch_p<int, true>(prm, per, threads, smem, st)
                      : dispatch_p<int, false>(prm, per, threads, smem, st);
  }
  if (value_bytes == 8) {
    return use_shared
               ? dispatch_p<long long, true>(prm, per, threads, smem, st)
               : dispatch_p<long long, false>(prm, per, threads, smem, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* gome_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
