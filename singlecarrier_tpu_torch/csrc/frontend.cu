// K1 frontend_decim: int16 PCM -> decim planes, one CUDA block per row.
//
// Replaces the front-end stage of the Pallas kernel
// singlecarrier_tpu/ops/fused_rx.py::_fused_rx_kernel_premix
// (fused_rx.py:166-209, the math of
// ops/frontend_pallas.py::_kernel_decim_aligned).  The Pallas grid walks
// time blocks in order and keeps the FIR halo in VMEM; here blocks run
// in no order, so row b*C + ch recomputes its 48-sample halo from row
// (b-1)*C + ch's raw tail with phase p0*adv^(b-1) -- the same products
// the previous grid step stored, hence the same bf16 values.
//
// Per row: stage u = [halo | z] (2 planes x 1928 f32, bf16-rounded) in
// shared memory, then every output decim[c][p][n][s] =
// sum_k w[k] * u[p][5s + c + k] in ascending k, in f32 (-fmad=false: the
// plain PyTorch version's exact sequence), rounded to the output dtype.
//
// Bound on the card: 3.76 KB of PCM in and 7.5 KB (bf16) out per row,
// against 49 x 3760 multiply-adds from shared memory.  The design keeps
// one pass over device memory (u never leaves shared memory; the stride-5
// tap reads are bank-conflict free); moving the MACs to tensor cores as
// the banded matmul of the TPU kernel is later work.
#include "common.cuh"

using namespace sc;

namespace {

constexpr int FE_THREADS = 256;

template <typename OutT>
__device__ __forceinline__ OutT to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void __launch_bounds__(FE_THREADS) frontend_decim_kernel(
    const int16_t* __restrict__ pcm, const float* __restrict__ p0r,
    const float* __restrict__ p0i, const float* __restrict__ tail0_r,
    const float* __restrict__ tail0_i, const float* __restrict__ adv,
    const float* __restrict__ tab, const float* __restrict__ taps,
    OutT* __restrict__ out, int B, int C, float inv_scale) {
  __shared__ float u[2][HALO + N_SAMP];
  __shared__ float w[NTAPS];
  const long long row = blockIdx.x;
  const long long N = (long long)B * C;
  const int b = (int)(row / C);
  const int ch = (int)(row - (long long)b * C);
  const int tid = threadIdx.x;
  if (tid < NTAPS) w[tid] = taps[tid];

  // mixer phase entering block b: p0 * adv^b
  const float q_r = p0r[ch], q_i = p0i[ch];
  const float a_r = adv[b], a_i = adv[B + b];
  const float pr = q_r * a_r - q_i * a_i;
  const float pi = q_r * a_i + q_i * a_r;
  const int16_t* x_row = pcm + row * N_SAMP;
  for (int t = tid; t < N_SAMP; t += FE_THREADS) {
    const float x = (float)x_row[t] * inv_scale;
    const float tr = tab[t], ti = tab[N_SAMP + t];
    u[0][HALO + t] = bf16_round(x * (pr * tr - pi * ti));
    u[1][HALO + t] = bf16_round(x * (pr * ti + pi * tr));
  }
  if (tid < HALO) {
    if (b == 0) {
      u[0][tid] = bf16_round(tail0_r[ch * HALO + tid]);
      u[1][tid] = bf16_round(tail0_i[ch * HALO + tid]);
    } else {
      const float c_r = adv[b - 1], c_i = adv[B + b - 1];
      const float sr = q_r * c_r - q_i * c_i;
      const float si = q_r * c_i + q_i * c_r;
      const int t = N_SAMP - HALO + tid;
      const float x = (float)pcm[(row - C) * N_SAMP + t] * inv_scale;
      const float tr = tab[t], ti = tab[N_SAMP + t];
      u[0][tid] = bf16_round(x * (sr * tr - si * ti));
      u[1][tid] = bf16_round(x * (sr * ti + si * tr));
    }
  }
  __syncthreads();

  for (int idx = tid; idx < 2 * CYC * N_SYM; idx += FE_THREADS) {
    const int cp = idx / N_SYM;            // c * 2 + p
    const int s = idx - cp * N_SYM;
    const float* up = u[cp & 1] + CYC * s + (cp >> 1);
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < NTAPS; ++k) acc = acc + w[k] * up[k];
    out[((long long)cp * N + row) * N_SYM + s] = to_out<OutT>(acc);
  }
}

}  // namespace

extern "C" int sc_frontend_decim(const void* pcm, const void* p0r,
                                 const void* p0i, const void* tail0_r,
                                 const void* tail0_i, const void* adv,
                                 const void* tab, const void* taps, void* out,
                                 int B, int C, int out_bf16, float inv_scale,
                                 void* stream) {
  const dim3 grid((unsigned)((long long)B * C));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    frontend_decim_kernel<__nv_bfloat16><<<grid, FE_THREADS, 0, st>>>(
        static_cast<const int16_t*>(pcm), static_cast<const float*>(p0r),
        static_cast<const float*>(p0i), static_cast<const float*>(tail0_r),
        static_cast<const float*>(tail0_i), static_cast<const float*>(adv),
        static_cast<const float*>(tab), static_cast<const float*>(taps),
        static_cast<__nv_bfloat16*>(out), B, C, inv_scale);
  } else {
    frontend_decim_kernel<float><<<grid, FE_THREADS, 0, st>>>(
        static_cast<const int16_t*>(pcm), static_cast<const float*>(p0r),
        static_cast<const float*>(p0i), static_cast<const float*>(tail0_r),
        static_cast<const float*>(tail0_i), static_cast<const float*>(adv),
        static_cast<const float*>(tab), static_cast<const float*>(taps),
        static_cast<float*>(out), B, C, inv_scale);
  }
  return (int)cudaGetLastError();
}
