// K2 hunt: preamble hunt of every row's [prev | cur] window, one CUDA
// block per row, one thread per lag.
//
// Replaces the hunt of singlecarrier_tpu/ops/decode_pallas.py::
// _hunt_decode_core (decode_pallas.py:742-876), inlined in the Pallas
// kernel ops/fused_rx.py::_fused_rx_kernel_premix.  Per decimation phase
// c the window planes are staged in shared memory as the hunt operand
// (int8 mode: clip(rint(16 w), +/-127), round half to even as
// fused_rx.py:89-91; bf16 mode: bf16(w)); thread l forms the 8 segment
// correlations sum_k x[2 + l + 16s + k] * pn[16s + k] (exact for int8,
// ascending k for bf16) and pw[c][l] = sum_s (re^2 + im^2).  The espan
// denominator is the direct 128-term sum of the phase-summed squared
// planes (ascending phases, decode_pallas.py:845-852) -- a direct sum,
// not a prefix-sum difference, whose cancellation would move the
// noise-block knife edge.  stat = pw / (en + 1e-12) in IEEE division;
// argmax takes the first maximum over lags and a strict > across
// ascending phases (decode_pallas.py:856-876).
//
// Bound on the card: per row ~0.5 M correlation adds from shared memory
// against 2 x 7.5 KB (bf16) of planes read.  The simple design reads each
// window element once per phase and does the correlation on CUDA cores;
// int8 tensor-core MMA (the TPU kernel's int8 MXU matmul) is later work.
#include "common.cuh"

using namespace sc;

namespace {

constexpr int HUNT_THREADS = 384;          // >= N_SYM lags, 12 warps
constexpr int HUNT_WARPS = HUNT_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

struct Best {
  float v;    // statistic
  float pw;   // raw power at that lag
  int i;      // lag
};

// a beats b: larger statistic, ties to the lower lag (first maximum)
__device__ __forceinline__ bool beats(const Best& a, const Best& b) {
  return a.v > b.v || (a.v == b.v && a.i < b.i);
}

__device__ __forceinline__ Best warp_best(Best x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Best y{__shfl_xor_sync(FULL, x.v, o), __shfl_xor_sync(FULL, x.pw, o),
           __shfl_xor_sync(FULL, x.i, o)};
    if (beats(y, x)) x = y;
  }
  return x;
}

__global__ void __launch_bounds__(HUNT_THREADS) hunt_kernel(
    const void* __restrict__ decim, const void* __restrict__ dprev0,
    int in_bf16, const float* __restrict__ pn, int* __restrict__ lag_out,
    int* __restrict__ ph_out, float* __restrict__ peak_out, long long N,
    int C, int int8_hunt, float hunt_scale, float peak_scale) {
  __shared__ float xs[2][WP];
  __shared__ float ssum[WP];
  __shared__ float pns[P];
  __shared__ Best wbest[CYC][HUNT_WARPS];
  const long long n = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (tid < P) pns[tid] = pn[tid];
  for (int j = tid; j < WP; j += HUNT_THREADS) ssum[j] = 0.f;

  float pw[CYC];
#pragma unroll
  for (int c = 0; c < CYC; ++c) {
    __syncthreads();   // previous phase's operand fully read
    for (int j = tid; j < WP; j += HUNT_THREADS) {
      const float vr = window_at(decim, dprev0, in_bf16, N, C, n, c, 0, j);
      const float vi = window_at(decim, dprev0, in_bf16, N, C, n, c, 1, j);
      ssum[j] = ssum[j] + (vr * vr + vi * vi);
      if (int8_hunt) {
        xs[0][j] = fminf(fmaxf(rintf(vr * hunt_scale), -127.f), 127.f);
        xs[1][j] = fminf(fmaxf(rintf(vi * hunt_scale), -127.f), 127.f);
      } else {
        xs[0][j] = bf16_round(vr);
        xs[1][j] = bf16_round(vi);
      }
    }
    __syncthreads();
    float acc = 0.f;
    if (tid < N_SYM) {
      for (int s = 0; s < NSEG; ++s) {
        const float* xr = xs[0] + OFF + tid + s * SEG;
        const float* xi = xs[1] + OFF + tid + s * SEG;
        const float* v = pns + s * SEG;
        float re = 0.f, im = 0.f;
#pragma unroll
        for (int k = 0; k < SEG; ++k) {
          re = re + xr[k] * v[k];
          im = im + xi[k] * v[k];
        }
        acc = acc + (re * re + im * im);
      }
    }
    pw[c] = acc;
  }
  __syncthreads();   // ssum complete

  float en = 0.f;
  if (tid < N_SYM) {
    for (int k = 0; k < P; ++k) en = en + ssum[OFF + tid + k];
  }
#pragma unroll
  for (int c = 0; c < CYC; ++c) {
    Best x{-1.f, 0.f, tid};
    if (tid < N_SYM) x = Best{pw[c] / (en + 1e-12f), pw[c], tid};
    x = warp_best(x);
    if (lane == 0) wbest[c][warp] = x;
  }
  __syncthreads();
  if (tid == 0) {
    float best_m = -1.f, best_pk = -1.f;
    int best_lag = 0, best_ph = 0;
    for (int c = 0; c < CYC; ++c) {
      Best x = wbest[c][0];
      for (int w = 1; w < HUNT_WARPS; ++w)
        if (beats(wbest[c][w], x)) x = wbest[c][w];
      if (x.v > best_m) {
        best_m = x.v;
        best_pk = x.pw;
        best_lag = x.i;
        best_ph = c;
      }
    }
    lag_out[n] = best_lag;
    ph_out[n] = best_ph;
    peak_out[n] = (2.f * best_pk) * peak_scale;
  }
}

}  // namespace

extern "C" int sc_hunt(const void* decim, const void* dprev0, const void* pn,
                       void* lag, void* phase, void* peak, int N, int C,
                       int in_bf16, int int8_hunt, float hunt_scale,
                       float peak_scale, void* stream) {
  hunt_kernel<<<dim3((unsigned)N), HUNT_THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(
      decim, dprev0, in_bf16, static_cast<const float*>(pn),
      static_cast<int*>(lag), static_cast<int*>(phase),
      static_cast<float*>(peak), (long long)N, C, int8_hunt, hunt_scale,
      peak_scale);
  return (int)cudaGetLastError();
}
