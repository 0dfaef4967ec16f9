// The Hawkes bin scan (K5): the thinned Hawkes event chain of one order-flow
// grid, given the grid's random draws.
//
// Replaces the `lax.scan` in gome_tpu/sim/flow.py::_bin_events (XLA code, no
// Pallas kernel): per bin t, with the six intensities lambda of the bin
// before,
//
//   occur[t] = u_ev[t] < 1 - exp(-(sum_i lambda_i) * dt)
//   etype[t] = argmax_i (g_ty[t, i] + log(lambda_i + 1e-12))
//   oid[t]   = the order-id counter (advanced after the bin by occur * ADD)
//   lambda   = fma(lambda - mu, decay, mu) + occur * alpha[:, etype]
//
// What bounds it: the serial dependency chain, not bytes (a grid of 1,024
// bins moves 40 KB). Bin t + 1 needs lambda after bin t. Evaluated one bin
// at a time, a bin costs its longest path, log -> the argmax -> the update,
// about 161 cycles on an H100 (latency_probe_kernel below times the parts),
// and a single thread issuing six logf, an expf and the rest also waits on
// instruction issue: about 345 cycles a bin. No design, speculating or not,
// goes below T updates of lambda in order, each a subtract and an FMA whose
// rounding depends on the last (latency_probe_kernel's last case): that is
// the bound chip_smoke.py states. The design below is held by a round's
// latency instead: the spine, three logf, the warps' exchange and the pick,
// about 500 cycles for the ~4.2 bins it keeps.
//
// Design: speculate. A bin has seven outcomes (no event, or an event of
// type 0-5), and each outcome's next lambda is one rounded update away, so
// the bins after t can be evaluated before bin t's outcome is known. One
// round evaluates 29 candidates side by side, one per lane:
//
//   level 0 (lane 0):       bin t from lambda;
//   level L = 1..4 (lanes 7L - 6 .. 7L): bin t + L from the intensities
//     after L - 1 event-free bins ("the spine") and then bin t + L - 1's
//     outcome c = 0..6 (lane 7L - 6 + c; c = 0 is the spine again).
//
// The realized path follows the spine until its first event, at level k,
// then takes the level k + 1 lane of that event's type: bins t .. t + k + 1
// in one round, or t .. t + 4 when the spine has no event before level 4
// (4.2 bins a round at the stationary intensity, 2 when every bin has an
// event). A ballot of the lanes' occurrence bits finds the spine's first
// event and three ballots of their outcome codes its type, so every lane
// knows the whole round; the last kept lane's next lambda is shuffled to
// all.
//
// Each lane runs exactly the serial path's rounded operations on exactly
// the intensities the serial path would hold at its bin, so the kept path is
// bit-equal to the plain version by construction: every float operation is
// an explicitly rounded intrinsic in the order of
// gome_tpu_torch/ops/hawkes_scan.py::hawkes_scan_reference, the decay is one
// fused multiply-add (as XLA's CPU compiler contracts the reference's
// `mu + (lam - mu) * decay`), the kept lane adds alpha's column or 0.0f as
// the reference does (the spine leaves the + 0.0f out: the FMA never returns
// -0 while mu is not -0, and x + 0 is x for every other x), expf / logf
// are the full-precision CUDA library functions PyTorch's own exp and log
// kernels call, `u < p` is strict, and the argmax keeps the first maximum
// with the serial scan's rule (a later value wins only when larger).
//
// A warp issues one instruction a cycle, and a lane's six logf alone are
// about 170 instructions, so the work of a round is split over four warps,
// one per SM sub-partition: warps 0 and 1 ("log warps") each take the logs
// of three types for all 29 candidates and hold those three intensities;
// warp 2 (the "occurrence warp") holds all six, takes the sum, the expf and
// u < p, and writes the outputs; the three meet once a round at a named
// barrier to swap their partial argmax and occurrence bits, then each picks
// the realized path itself. Warp 3 stages the draws of the next 512-bin
// chunk into shared memory with cp.async, completed on an mbarrier, and
// writes each finished chunk's outputs back, so the chain never waits on
// device memory. Nothing is read back to the host.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NE = 6;           // event types
constexpr int DEPTH = 4;        // speculative levels after bin t
constexpr int CHUNK = 512;      // bins staged in shared memory at a time
constexpr int LOG_WARPS = 2;    // warps 0 and 1
constexpr int PER_LOG = NE / LOG_WARPS;
constexpr int OCC_WARP = LOG_WARPS;        // warp 2
constexpr int STAGER = LOG_WARPS + 1;      // warp 3
constexpr int CHAIN = 32 * (LOG_WARPS + 1);
constexpr int THREADS = 32 * (STAGER + 1);
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  float mu[NE];
  float alpha[NE * NE];  // alpha[i][j]: an event of type j adds it to lambda_i
  float decay;
  float neg_dt;
};

struct Shared {
  float alpha_t[NE * NE];  // [etype][i]: one column per event
  float u[2][CHUNK];
  float g[2][CHUNK * NE];
  int out[2][CHUNK];       // etype | occur << 3
  int oid[2][CHUNK];
  float best[2][LOG_WARPS][32];  // per round (two slots): a log warp's
  int arg[2][LOG_WARPS + 1][32]; // partial max and argmax; [OCC_WARP]: occur
  uint64_t full[2];        // the stager filled a chunk buffer
  uint64_t done[2];        // the chain warps finished a chunk buffer
};

// The lane of level k's spine candidate (level 0 is lane 0).
__host__ __device__ constexpr int spine_lane(int k) {
  return k == 0 ? 0 : 7 * k - 6;
}

__host__ __device__ constexpr unsigned spine_mask() {
  unsigned m = 0;
  for (int k = 0; k <= DEPTH; ++k) m |= 1u << spine_lane(k);
  return m;
}

__device__ __forceinline__ float decay(float x, float mu, float d) {
  return __fmaf_rn(__fsub_rn(x, mu), d, mu);
}

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{ .reg .b64 st; mbarrier.arrive.shared::cta.b64 st, [%0]; }"
               ::"r"(smem(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t ok;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(ok) : "r"(smem(bar)), "r"(parity) : "memory");
  } while (!ok);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem(dst)),
               "l"(src) : "memory");
}

// One chain warp. ROLE < LOG_WARPS: a log warp for types ROLE * PER_LOG ..;
// ROLE == OCC_WARP: the occurrence warp, which also writes the outputs.
template <int ROLE>
__device__ __forceinline__ void chain(const Params& p, Shared& sm,
                                      const float* __restrict__ lam_in,
                                      const int* __restrict__ oid_in, int T,
                                      float* __restrict__ lam_out,
                                      int* __restrict__ next_oid, int lane) {
  constexpr bool OCC = ROLE == OCC_WARP;
  constexpr int E = OCC ? NE : PER_LOG;  // the intensities this warp holds
  constexpr int I0 = OCC ? 0 : ROLE * PER_LOG;
  constexpr unsigned SPINE = spine_mask();
  int level = 0, c = 0;  // lanes past the last candidate mirror lane 0
  if (lane >= 1 && lane < 1 + 7 * DEPTH) {
    level = (lane - 1) / 7 + 1;
    c = (lane - 1) % 7;
  }
  float add[E], mu[E], lam[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    add[j] = c > 0 ? sm.alpha_t[(c - 1) * NE + I0 + j] : 0.0f;
    mu[j] = p.mu[I0 + j];
    lam[j] = lam_in[I0 + j];
  }
  int oid = *oid_in;
  const int chunks = (T + CHUNK - 1) / CHUNK;
  int slot = 0;
  for (int ci = 0; ci < chunks; ++ci) {
    const int b = ci & 1, cb = ci * CHUNK, ce = min(cb + CHUNK, T);
    mbar_wait(&sm.full[b], (ci >> 1) & 1);
    const float* su = sm.u[b];
    const float* sg = sm.g[b];
    int t = cb;
    while (t < ce) {
      // A round: levels 0 .. cap, cut at the chunk's end.
      const int cap = min(DEPTH, ce - 1 - t);
      const int cap_lane = spine_lane(cap);
      const unsigned below_cap = SPINE & ((1u << cap_lane) - 1u);
      const int k = min(t + level, ce - 1) - cb;  // this lane's bin
      // The lane's candidate intensities.
      float s[E], base[E], x[E];
#pragma unroll
      for (int j = 0; j < E; ++j) s[j] = base[j] = lam[j];
#pragma unroll
      for (int d = 1; d < DEPTH; ++d) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          s[j] = decay(s[j], mu[j], p.decay);  // + 0.0f changes no bit
          base[j] = level - 1 == d ? s[j] : base[j];
        }
      }
#pragma unroll
      for (int j = 0; j < E; ++j)
        x[j] = level == 0 ? lam[j]
                          : __fadd_rn(decay(base[j], mu[j], p.decay), add[j]);
      if constexpr (OCC) {
        float total = x[0];
#pragma unroll
        for (int i = 1; i < NE; ++i) total = __fadd_rn(total, x[i]);
        const float p_event =
            __fsub_rn(1.0f, expf(__fmul_rn(total, p.neg_dt)));
        sm.arg[slot][OCC_WARP][lane] = su[k] < p_event;
      } else {
        // Warp 0 starts from type 0 as the serial scan does; warp 1 lets no
        // value below or equal to -inf (or NaN) win, so the two partials
        // meet in the serial scan's first maximum.
        float best = ROLE == 0 ? 0.0f : -__int_as_float(0x7f800000);
        int arg = I0;
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float v = __fadd_rn(sg[k * NE + I0 + j],
                                    logf(__fadd_rn(x[j], 1e-12f)));
          if ((ROLE == 0 && j == 0) || v > best) {
            best = v;
            arg = I0 + j;
          }
        }
        sm.best[slot][ROLE][lane] = best;
        sm.arg[slot][ROLE][lane] = arg;
      }
      asm volatile("bar.sync 1, %0;" ::"n"(CHAIN) : "memory");
      float best = sm.best[slot][0][lane];
      int e = sm.arg[slot][0][lane];
#pragma unroll
      for (int w = 1; w < LOG_WARPS; ++w) {
        const float v = sm.best[slot][w][lane];
        const int a = sm.arg[slot][w][lane];
        if (v > best) {
          best = v;
          e = a;
        }
      }
      const int occ = sm.arg[slot][OCC_WARP][lane];
      slot ^= 1;
      // The first spine event below cap ends the spine (it needs only the
      // occurrence bits); the lane of the next level with that event's
      // code holds the round's last bin.
      const unsigned events = __ballot_sync(FULL, occ) & below_cap;
      const unsigned first = events & (0u - events);
      int after = 7 * (DEPTH - 1) + 1, bins = DEPTH + 1;
#pragma unroll
      for (int d = DEPTH - 2; d >= 0; --d) {
        if (first == (1u << spine_lane(d))) {
          after = 7 * d + 1;
          bins = d + 2;
        }
      }
      // Every lane's outcome code 0..6 in three ballots.
      const int code = occ ? e + 1 : 0;
      const unsigned b0 = __ballot_sync(FULL, code & 1);
      const unsigned b1 = __ballot_sync(FULL, code & 2);
      const unsigned b2 = __ballot_sync(FULL, code & 4);
      float next[E];
#pragma unroll
      for (int j = 0; j < E; ++j)
        next[j] = __fadd_rn(decay(x[j], mu[j], p.decay),
                            occ ? sm.alpha_t[e * NE + I0 + j] : 0.0f);
      const int first_code = ((b0 & first) ? 1 : 0) | ((b1 & first) ? 2 : 0) |
                             ((b2 & first) ? 4 : 0);
      const int last = first ? after + first_code : cap_lane;
#pragma unroll
      for (int j = 0; j < E; ++j) lam[j] = __shfl_sync(FULL, next[j], last);
      if constexpr (OCC) {
        const unsigned adds = __ballot_sync(FULL, occ & ((e >> 1) != 1));
        const unsigned kept = first ? (SPINE & ((first << 1) - 1u)) | (1u << last)
                                    : SPINE & ((2u << cap_lane) - 1u);
        if ((kept >> lane) & 1) {
          sm.out[b][t + level - cb] = e | (occ << 3);
          // only an ADD takes an order id
          sm.oid[b][t + level - cb] =
              oid + __popc(adds & kept & ((1u << lane) - 1u));
        }
        oid += __popc(adds & kept);
      }
      t += first ? bins : cap + 1;
    }
    mbar_arrive(&sm.done[b]);
  }
  if constexpr (OCC) {
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < NE; ++i) lam_out[i] = lam[i];
      *next_oid = oid;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
hawkes_scan_kernel(Params p, const float* __restrict__ lam_in,
                   const int* __restrict__ oid_in,
                   const float* __restrict__ u_ev,
                   const float* __restrict__ g_ty, int T,
                   int* __restrict__ occur, int* __restrict__ etype,
                   int* __restrict__ oid_out, float* __restrict__ lam_out,
                   int* __restrict__ next_oid) {
  __shared__ Shared sm;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid < NE * NE) sm.alpha_t[(tid % NE) * NE + tid / NE] = p.alpha[tid];
  if (tid == 0) {
    mbar_init(&sm.full[0], 32);
    mbar_init(&sm.full[1], 32);
    mbar_init(&sm.done[0], CHAIN);
    mbar_init(&sm.done[1], CHAIN);
  }
  __syncthreads();
  const int chunks = (T + CHUNK - 1) / CHUNK;
  if (warp == STAGER) {
    // Chunk ci goes to buffer ci & 1 once the chain is done with chunk
    // ci - 2, whose outputs are written back first.
    auto write_back = [&](int ci) {
      const int b = ci & 1, cb = ci * CHUNK, n = min(CHUNK, T - cb);
      mbar_wait(&sm.done[b], (ci >> 1) & 1);
      for (int j = lane; j < n; j += 32) {
        const int v = sm.out[b][j];
        occur[cb + j] = v >> 3;
        etype[cb + j] = v & 7;
        oid_out[cb + j] = sm.oid[b][j];
      }
    };
    for (int ci = 0; ci < chunks; ++ci) {
      const int b = ci & 1, cb = ci * CHUNK, n = min(CHUNK, T - cb);
      if (ci >= 2) write_back(ci - 2);
      for (int j = lane; j < n; j += 32) cp_async4(&sm.u[b][j], u_ev + cb + j);
      const float* g = g_ty + static_cast<size_t>(cb) * NE;
      for (int j = lane; j < n * NE; j += 32) cp_async4(&sm.g[b][j], g + j);
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
                   ::"r"(smem(&sm.full[b])) : "memory");
    }
    for (int ci = max(0, chunks - 2); ci < chunks; ++ci) write_back(ci);
  } else if (warp == 0) {
    chain<0>(p, sm, lam_in, oid_in, T, lam_out, next_oid, lane);
  } else if (warp == 1) {
    chain<1>(p, sm, lam_in, oid_in, T, lam_out, next_oid, lane);
  } else {
    chain<OCC_WARP>(p, sm, lam_in, oid_in, T, lam_out, next_oid, lane);
  }
}

// Latency probe for K5's bounds: one warp times `n` dependent steps of each
// operation on a bin's path with clock64(), in the kernel's own rounded
// intrinsics and library calls: [0] x + c, [1] logf(x + c) (the kernel's
// log(lambda + eps)), [2] expf(x * c) (its exp(sum * -dt)), [3] (x > c) ?
// x - c : x + c (a compare and select plus an add); the steps that can pick
// a realized candidate: [4] a shuffle whose source lane is the previous
// result, [5] a ballot of a compare, [6] a shared-memory load whose address
// is the previous result; and [7] an event-free bin's update of one
// intensity, fma(x - mu, decay, mu) (subtract, fused multiply-add). Each
// chain's value is stored before the closing clock read, so the
// read waits for the chain; lane 0 writes the cycles.
__global__ void latency_probe_kernel(int n, float x0,
                                     long long* __restrict__ cycles,
                                     float* __restrict__ sink) {
  __shared__ int s_idx[32];
  const int lane = threadIdx.x;
  s_idx[lane] = lane;
  __syncwarp();
  long long t0, t1;
  auto done = [&](int k, float value) {
    *reinterpret_cast<volatile float*>(sink + k * 32 + lane) = value;
    t1 = clock64();
    if (lane == 0) cycles[k] = t1 - t0;
  };
  float x = x0;
  t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < n; ++i) x = __fadd_rn(x, 1e-7f);
  done(0, x);
  x = x0;
  t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < n; ++i) x = logf(__fadd_rn(x, 1.5f));
  done(1, x);
  x = x0;
  t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < n; ++i) x = expf(__fmul_rn(x, -0.5f));
  done(2, x);
  x = x0;
  t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < n; ++i)
    x = x > 0.25f ? __fadd_rn(x, -0.25f) : __fadd_rn(x, 0.25f);
  done(3, x);
  int v = lane;
  t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < n; ++i) v = __shfl_sync(FULL, v, v);
  done(4, static_cast<float>(v));
  unsigned m = lane;
  t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < n; ++i) m = __ballot_sync(FULL, m != 0u) >> 1;
  done(5, static_cast<float>(m));
  v = lane;
  t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < n; ++i) v = s_idx[v];
  done(6, static_cast<float>(v));
  x = x0;
  t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < n; ++i)
    x = __fmaf_rn(__fsub_rn(x, 0.7f), 0.96078944f, 0.7f);
  done(7, x);
}

}  // namespace

// cycles: device int64[8], sink: device float[8 * 32]; launched on `stream`.
extern "C" int gome_hawkes_latency_probe(int n, float x0, long long* cycles,
                                         float* sink, void* stream) {
  latency_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      n, x0, cycles, sink);
  return static_cast<int>(cudaGetLastError());
}

// params (host memory): mu[6], alpha[36] (row i, column j), decay, -dt.
// Every other pointer is device memory; the launch goes on `stream` and the
// function returns the launch's cudaError_t (0 when it was accepted).
extern "C" int gome_hawkes_scan(const float* params, const float* lam_in,
                                const int* oid_in, const float* u_ev,
                                const float* g_ty, int T, int* occur,
                                int* etype, int* oid_out, float* lam_out,
                                int* next_oid, void* stream) {
  Params p;
  for (int i = 0; i < NE; ++i) p.mu[i] = params[i];
  for (int i = 0; i < NE * NE; ++i) p.alpha[i] = params[NE + i];
  p.decay = params[NE + NE * NE];
  p.neg_dt = params[NE + NE * NE + 1];
  hawkes_scan_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p, lam_in, oid_in, u_ev, g_ty, T, occur, etype, oid_out, lam_out,
      next_oid);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gome_hawkes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
