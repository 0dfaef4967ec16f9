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
// What bounds it: the serial dependency chain, not bytes. Bin t + 1 needs
// lambda after bin t, so the bins cannot run side by side; a grid of 1,024
// bins moves 40 KB. The chain per bin is logf(lambda + eps) -> + g ->
// the six-way argmax -> the alpha column -> the update, with the sum, expf
// and compare beside it; latency_probe_kernel below times its parts.
//
// Design: one block runs the one chain. All threads stage a chunk of the
// draws in shared memory (coalesced loads), thread 0 walks the chunk's bins
// with lambda in registers and the alpha columns in shared memory, and all
// threads write the chunk's outputs back. One thread, not six lanes of a
// warp: a shuffle costs about as much latency as the five dependent adds
// and compares it would save, and one thread keeps the sum and the argmax
// in exactly the plain version's order. Every float operation is an
// explicitly rounded intrinsic, taken in the order of
// gome_tpu_torch/ops/hawkes_scan.py::hawkes_scan_reference: the decay is
// one fused multiply-add, as XLA's CPU compiler contracts the reference's
// `mu + (lam - mu) * decay`, and nothing else is fused. expf / logf are
// the full-precision CUDA library functions PyTorch's own exp and log
// kernels call, so the kernel and the plain version on the card agree bit
// for bit. Nothing is read back to the host.

#include <cuda_runtime.h>

namespace {

constexpr int NE = 6;         // event types
constexpr int CHUNK = 1024;   // bins staged in shared memory at a time
constexpr int THREADS = 256;  // stagers; thread 0 also runs the chain

struct Params {
  float mu[NE];
  float alpha[NE * NE];  // alpha[i][j]: an event of type j adds it to lambda_i
  float decay;
  float neg_dt;
};

__global__ void __launch_bounds__(THREADS)
hawkes_scan_kernel(Params p, const float* __restrict__ lam_in,
                   const int* __restrict__ oid_in,
                   const float* __restrict__ u_ev,
                   const float* __restrict__ g_ty, int T,
                   int* __restrict__ occur, int* __restrict__ etype,
                   int* __restrict__ oid_out, float* __restrict__ lam_out,
                   int* __restrict__ next_oid) {
  __shared__ float s_u[CHUNK];
  __shared__ float s_g[CHUNK * NE];
  __shared__ int s_occ[CHUNK];
  __shared__ int s_ety[CHUNK];
  __shared__ int s_oid[CHUNK];
  __shared__ float s_alpha_t[NE * NE];  // [etype][i]: one column per event

  const int tid = threadIdx.x;
  if (tid < NE * NE) s_alpha_t[(tid % NE) * NE + tid / NE] = p.alpha[tid];

  float lam[NE];
  int oid = 0;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < NE; ++i) lam[i] = lam_in[i];
    oid = *oid_in;
  }

  for (int base = 0; base < T; base += CHUNK) {
    const int n = min(CHUNK, T - base);
    for (int k = tid; k < n; k += THREADS) s_u[k] = u_ev[base + k];
    const float* g = g_ty + static_cast<size_t>(base) * NE;
    for (int k = tid; k < n * NE; k += THREADS) s_g[k] = g[k];
    __syncthreads();
    if (tid == 0) {
      for (int k = 0; k < n; ++k) {
        float total = lam[0];
#pragma unroll
        for (int i = 1; i < NE; ++i) total = __fadd_rn(total, lam[i]);
        const float p_event =
            __fsub_rn(1.0f, expf(__fmul_rn(total, p.neg_dt)));
        const int occ = s_u[k] < p_event;
        int e = 0;
        float best = 0.0f;
#pragma unroll
        for (int i = 0; i < NE; ++i) {
          const float v =
              __fadd_rn(s_g[k * NE + i], logf(__fadd_rn(lam[i], 1e-12f)));
          if (i == 0 || v > best) {  // the first maximum, as torch.argmax
            best = v;
            e = i;
          }
        }
        s_occ[k] = occ;
        s_ety[k] = e;
        s_oid[k] = oid;
        oid += occ & ((e >> 1) != 1);  // only an ADD takes an order id
#pragma unroll
        for (int i = 0; i < NE; ++i) {
          const float x =
              __fmaf_rn(__fsub_rn(lam[i], p.mu[i]), p.decay, p.mu[i]);
          lam[i] = __fadd_rn(x, occ ? s_alpha_t[e * NE + i] : 0.0f);
        }
      }
    }
    __syncthreads();
    for (int k = tid; k < n; k += THREADS) {
      occur[base + k] = s_occ[k];
      etype[base + k] = s_ety[k];
      oid_out[base + k] = s_oid[k];
    }
  }
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < NE; ++i) lam_out[i] = lam[i];
    *next_oid = oid;
  }
}

// Latency probe for K5's bound: one thread times `n` dependent steps of
// each operation on a bin's path with clock64(), in the kernel's own
// rounded intrinsics and library calls: [0] x + c, [1] logf(x + c) (the
// kernel's log(lambda + eps)), [2] expf(x * c) (its exp(sum * -dt)),
// [3] (x > c) ? x - c : x + c (a compare and select plus an add). Each
// chain's value is stored before the closing clock read, so the read
// waits for the chain.
__global__ void latency_probe_kernel(int n, float x0,
                                     long long* __restrict__ cycles,
                                     float* __restrict__ sink) {
  long long t0, t1;
  float x = x0;
  t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < n; ++i) x = __fadd_rn(x, 1e-7f);
  *reinterpret_cast<volatile float*>(sink) = x;
  t1 = clock64();
  cycles[0] = t1 - t0;
  x = x0;
  t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < n; ++i) x = logf(__fadd_rn(x, 1.5f));
  *reinterpret_cast<volatile float*>(sink + 1) = x;
  t1 = clock64();
  cycles[1] = t1 - t0;
  x = x0;
  t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < n; ++i) x = expf(__fmul_rn(x, -0.5f));
  *reinterpret_cast<volatile float*>(sink + 2) = x;
  t1 = clock64();
  cycles[2] = t1 - t0;
  x = x0;
  t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < n; ++i)
    x = x > 0.25f ? __fadd_rn(x, -0.25f) : __fadd_rn(x, 0.25f);
  *reinterpret_cast<volatile float*>(sink + 3) = x;
  t1 = clock64();
  cycles[3] = t1 - t0;
}

}  // namespace

// cycles: device int64[4], sink: device float[4]; launched on `stream`.
extern "C" int gome_hawkes_latency_probe(int n, float x0, long long* cycles,
                                         float* sink, void* stream) {
  latency_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
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
