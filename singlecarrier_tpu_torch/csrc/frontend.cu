// The front-end kernels: int16 PCM -> decim planes, one CUDA block per row.
//
// K1 frontend_decim_kernel replaces the front-end stage of the Pallas
// kernel singlecarrier_tpu/ops/fused_rx.py::_fused_rx_kernel_premix
// (fused_rx.py:166-209, the math of
// ops/frontend_pallas.py::_kernel_decim_aligned).  The Pallas grid walks
// time blocks in order and keeps the FIR halo in VMEM; here blocks run
// in no order, so row b*C + ch recomputes its 48-sample halo from row
// (b-1)*C + ch's raw tail with phase p0*adv^(b-1) -- the same products
// the previous grid step stored, hence the same bf16 values.
//
// frontend_rows_kernel replaces the stand-alone front-end
// singlecarrier_tpu/ops/frontend_pallas.py::_kernel_decim_aligned (:200)
// and ::_kernel_decim (:149; the same math without the lane alignment):
// every row is given its own mixer phase and its already-downmixed f32
// halo, which is rounded to bf16 before it is summed
// (frontend_pallas.py:238).  Output [cyc][2][N][N_SYM] (transposed, f32
// or bf16) or [N][cyc][2][N_SYM] (row-major, always f32).
//
// frontend_decim_folded_kernel and frontend_rows_folded_kernel are the
// mixer-folded forms of the two (fused_rx.py::_fused_rx_kernel_folded
// :217 and frontend_pallas.py::_kernel_decim_folded :286): ONE raw plane
// u = [halo | bf16(x)], complex taps c_k = w_k e^{jw(k-48)} (rounded to
// bf16), and the mixer applied after the decimation as a rotation by
// phase * table[5s + c].  The rows form un-rotates every row's downmixed
// f32 halo back to raw samples; the batch form takes the halo of a row
// with b > 0 straight from the previous row's raw PCM tail (what the
// Pallas ring holds) and un-rotates only block 0's carried seed.  They
// share stage_raw, unrotate and folded_sums.
//
// frontend_full_kernel replaces frontend_pallas.py::_kernel (:45): the
// downmix and the full-rate 49-tap FIR, all in f32 with no bf16 rounding
// anywhere, y[p][t] = sum_k (taps[k] * gain) * u[p][t + k] in ascending k
// -> [N][2][N_SAMP] f32.  3.76 KB in and 15 KB out per row against
// 49 x 3760 f32 multiply-adds: on paper the byte and the operation terms
// of its bound nearly meet.
//
// The premix pair shares stage_block (downmix into shared memory) and
// decim_sums:
// per row, u = [halo | z] (2 planes x 1928 f32, bf16-rounded) sits in
// shared memory, then every output y[c][p][s] = sum_k w[k] *
// u[p][5s + c + k] in ascending k, in f32 (-fmad=false: the plain
// PyTorch version's exact sequence), rounded to the output dtype.
//
// Bound on the card: bytes.  3.76 KB of PCM in and 7.5 KB (bf16) or
// 15 KB (f32) out per row, against 49 x 3760 multiply-adds from shared
// memory, which is what the kernels spend their time on today.  The
// design keeps one pass over device memory (u never leaves shared
// memory; the stride-5 tap reads are bank-conflict free); moving the
// MACs to tensor cores as the banded matmul of the TPU kernel is later
// work.
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

// z = bf16(x * (p * table[t])) for the raw sample at index t of a block
// entered with mixer phase (pr, pi).
__device__ __forceinline__ void downmix(const int16_t* __restrict__ x_row,
                                        const float* __restrict__ tab, int t,
                                        float pr, float pi, float inv_scale,
                                        float& zr, float& zi) {
  const float x = (float)x_row[t] * inv_scale;
  const float tr = tab[t], ti = tab[N_SAMP + t];
  zr = bf16_round(x * (pr * tr - pi * ti));
  zi = bf16_round(x * (pr * ti + pi * tr));
}

// u[.][HALO + t] = downmixed block of this row.
__device__ __forceinline__ void stage_block(
    float (&u)[2][HALO + N_SAMP], const int16_t* __restrict__ x_row,
    const float* __restrict__ tab, float pr, float pi, float inv_scale,
    int tid) {
  for (int t = tid; t < N_SAMP; t += FE_THREADS)
    downmix(x_row, tab, t, pr, pi, inv_scale, u[0][HALO + t],
            u[1][HALO + t]);
}

// The 49-tap decimating sums of one row, in tap order.  ROW_MAJOR writes
// out[row][c][p][s], else out[c][p][row][s].
template <typename OutT, bool ROW_MAJOR>
__device__ __forceinline__ void decim_sums(
    const float (&u)[2][HALO + N_SAMP], const float (&w)[NTAPS],
    OutT* __restrict__ out, long long N, long long row, int tid) {
  for (int idx = tid; idx < 2 * CYC * N_SYM; idx += FE_THREADS) {
    const int cp = idx / N_SYM;            // c * 2 + p
    const int s = idx - cp * N_SYM;
    const float* up = u[cp & 1] + CYC * s + (cp >> 1);
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < NTAPS; ++k) acc = acc + w[k] * up[k];
    const long long o = ROW_MAJOR ? (row * (2 * CYC) + cp) * N_SYM + s
                                  : ((long long)cp * N + row) * N_SYM + s;
    out[o] = to_out<OutT>(acc);
  }
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
  stage_block(u, pcm + row * N_SAMP, tab, pr, pi, inv_scale, tid);
  if (tid < HALO) {
    if (b == 0) {
      u[0][tid] = bf16_round(tail0_r[ch * HALO + tid]);
      u[1][tid] = bf16_round(tail0_i[ch * HALO + tid]);
    } else {
      const float c_r = adv[b - 1], c_i = adv[B + b - 1];
      const float sr = q_r * c_r - q_i * c_i;
      const float si = q_r * c_i + q_i * c_r;
      downmix(pcm + (row - C) * N_SAMP, tab, N_SAMP - HALO + tid, sr, si,
              inv_scale, u[0][tid], u[1][tid]);
    }
  }
  __syncthreads();
  decim_sums<OutT, false>(u, w, out, N, row, tid);
}

template <typename OutT, bool ROW_MAJOR>
__global__ void __launch_bounds__(FE_THREADS) frontend_rows_kernel(
    const int16_t* __restrict__ pcm, const float* __restrict__ ph_r,
    const float* __restrict__ ph_i, const float* __restrict__ tail_r,
    const float* __restrict__ tail_i, const float* __restrict__ tab,
    const float* __restrict__ taps, OutT* __restrict__ out, long long N,
    float inv_scale) {
  __shared__ float u[2][HALO + N_SAMP];
  __shared__ float w[NTAPS];
  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < NTAPS) w[tid] = taps[tid];
  stage_block(u, pcm + row * N_SAMP, tab, ph_r[row], ph_i[row], inv_scale,
              tid);
  if (tid < HALO) {
    u[0][tid] = bf16_round(tail_r[row * HALO + tid]);
    u[1][tid] = bf16_round(tail_i[row * HALO + tid]);
  }
  __syncthreads();
  decim_sums<OutT, ROW_MAJOR>(u, w, out, N, row, tid);
}

// ---------------------------------------------------------- mixer fold

// u[HALO + t] = bf16(x[t]): the raw block of this row.
__device__ __forceinline__ void stage_raw(float (&u)[HALO + N_SAMP],
                                          const int16_t* __restrict__ x_row,
                                          float inv_scale, int tid) {
  for (int t = tid; t < N_SAMP; t += FE_THREADS)
    u[HALO + t] = bf16_round((float)x_row[t] * inv_scale);
}

// Raw sample m of a downmixed halo (t_r, t_i) carried with phase (pr, pi):
// Re[tail * conj(phase) * e^{-jw(m - HALO + 1)}], rounded to bf16.
__device__ __forceinline__ float unrotate(float t_r, float t_i, float pr,
                                          float pi, float eur, float eui) {
  const float a = t_r * pr + t_i * pi;
  const float b = t_i * pr - t_r * pi;
  return bf16_round(a * eur + b * eui);
}

// The folded decimating sums of one row: A + jB = sum_k c_k u[5s + c + k]
// in tap order, rotated by (pr + j pi) * table[5s + c].  Output index as
// decim_sums.
template <typename OutT, bool ROW_MAJOR>
__device__ __forceinline__ void folded_sums(
    const float (&u)[HALO + N_SAMP], const float (&wre)[NTAPS],
    const float (&wim)[NTAPS], const float* __restrict__ tab, float pr,
    float pi, OutT* __restrict__ out, long long N, long long row, int tid) {
  for (int idx = tid; idx < CYC * N_SYM; idx += FE_THREADS) {
    const int c = idx / N_SYM;
    const int s = idx - c * N_SYM;
    const int t0 = CYC * s + c;
    const float* up = u + t0;
    float A = 0.f, B = 0.f;
#pragma unroll
    for (int k = 0; k < NTAPS; ++k) {
      A = A + wre[k] * up[k];
      B = B + wim[k] * up[k];
    }
    const float ta = tab[t0], tb = tab[N_SAMP + t0];
    const float mr = pr * ta - pi * tb;
    const float mi = pr * tb + pi * ta;
    const float yr = mr * A - mi * B;
    const float yi = mr * B + mi * A;
    const long long o =
        ROW_MAJOR ? (row * (2 * CYC) + 2 * c) * N_SYM + s
                  : ((long long)(2 * c) * N + row) * N_SYM + s;
    const long long plane = ROW_MAJOR ? (long long)N_SYM : N * N_SYM;
    out[o] = to_out<OutT>(yr);
    out[o + plane] = to_out<OutT>(yi);
  }
}

template <typename OutT>
__global__ void __launch_bounds__(FE_THREADS) frontend_decim_folded_kernel(
    const int16_t* __restrict__ pcm, const float* __restrict__ p0r,
    const float* __restrict__ p0i, const float* __restrict__ tail0_r,
    const float* __restrict__ tail0_i, const float* __restrict__ adv,
    const float* __restrict__ tab, const float* __restrict__ ctaps,
    const float* __restrict__ unrot, OutT* __restrict__ out, int B, int C,
    float inv_scale) {
  __shared__ float u[HALO + N_SAMP];
  __shared__ float wre[NTAPS], wim[NTAPS];
  const long long row = blockIdx.x;
  const long long N = (long long)B * C;
  const int b = (int)(row / C);
  const int ch = (int)(row - (long long)b * C);
  const int tid = threadIdx.x;
  if (tid < NTAPS) {
    wre[tid] = ctaps[tid];
    wim[tid] = ctaps[NTAPS + tid];
  }
  const float q_r = p0r[ch], q_i = p0i[ch];
  const float a_r = adv[b], a_i = adv[B + b];
  const float pr = q_r * a_r - q_i * a_i;
  const float pi = q_r * a_i + q_i * a_r;
  stage_raw(u, pcm + row * N_SAMP, inv_scale, tid);
  if (tid < HALO) {
    if (b == 0) {
      u[tid] = unrotate(tail0_r[ch * HALO + tid], tail0_i[ch * HALO + tid],
                        pr, pi, unrot[tid], unrot[HALO + tid]);
    } else {
      u[tid] = bf16_round(
          (float)pcm[(row - C) * N_SAMP + N_SAMP - HALO + tid] * inv_scale);
    }
  }
  __syncthreads();
  folded_sums<OutT, false>(u, wre, wim, tab, pr, pi, out, N, row, tid);
}

template <typename OutT, bool ROW_MAJOR>
__global__ void __launch_bounds__(FE_THREADS) frontend_rows_folded_kernel(
    const int16_t* __restrict__ pcm, const float* __restrict__ ph_r,
    const float* __restrict__ ph_i, const float* __restrict__ tail_r,
    const float* __restrict__ tail_i, const float* __restrict__ tab,
    const float* __restrict__ ctaps, const float* __restrict__ unrot,
    OutT* __restrict__ out, long long N, float inv_scale) {
  __shared__ float u[HALO + N_SAMP];
  __shared__ float wre[NTAPS], wim[NTAPS];
  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < NTAPS) {
    wre[tid] = ctaps[tid];
    wim[tid] = ctaps[NTAPS + tid];
  }
  const float pr = ph_r[row], pi = ph_i[row];
  stage_raw(u, pcm + row * N_SAMP, inv_scale, tid);
  if (tid < HALO)
    u[tid] = unrotate(tail_r[row * HALO + tid], tail_i[row * HALO + tid], pr,
                      pi, unrot[tid], unrot[HALO + tid]);
  __syncthreads();
  folded_sums<OutT, ROW_MAJOR>(u, wre, wim, tab, pr, pi, out, N, row, tid);
}

// ------------------------------------------------- full-rate front-end

__global__ void __launch_bounds__(FE_THREADS) frontend_full_kernel(
    const int16_t* __restrict__ pcm, const float* __restrict__ ph_r,
    const float* __restrict__ ph_i, const float* __restrict__ tail_r,
    const float* __restrict__ tail_i, const float* __restrict__ tab,
    const float* __restrict__ taps, float* __restrict__ out,
    float inv_scale, float gain) {
  __shared__ float u[2][HALO + N_SAMP];
  __shared__ float w[NTAPS];
  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < NTAPS) w[tid] = taps[tid] * gain;
  const float pr = ph_r[row], pi = ph_i[row];
  const int16_t* x_row = pcm + row * N_SAMP;
  for (int t = tid; t < N_SAMP; t += FE_THREADS) {
    const float x = (float)x_row[t] * inv_scale;
    const float tr = tab[t], ti = tab[N_SAMP + t];
    u[0][HALO + t] = x * (pr * tr - pi * ti);
    u[1][HALO + t] = x * (pr * ti + pi * tr);
  }
  if (tid < HALO) {
    u[0][tid] = tail_r[row * HALO + tid];
    u[1][tid] = tail_i[row * HALO + tid];
  }
  __syncthreads();
  for (int idx = tid; idx < 2 * N_SAMP; idx += FE_THREADS) {
    const int p = idx / N_SAMP;
    const int t = idx - p * N_SAMP;
    const float* up = u[p] + t;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < NTAPS; ++k) acc = acc + w[k] * up[k];
    out[row * (2 * N_SAMP) + idx] = acc;
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

// layout: 0 = transposed f32, 1 = transposed bf16, 2 = row-major f32.
extern "C" int sc_frontend_rows(const void* pcm, const void* ph_r,
                                const void* ph_i, const void* tail_r,
                                const void* tail_i, const void* tab,
                                const void* taps, void* out, int N,
                                int layout, float inv_scale, void* stream) {
  const dim3 grid((unsigned)N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int16_t* x = static_cast<const int16_t*>(pcm);
  const float* pr = static_cast<const float*>(ph_r);
  const float* pi = static_cast<const float*>(ph_i);
  const float* tr = static_cast<const float*>(tail_r);
  const float* ti = static_cast<const float*>(tail_i);
  const float* tb = static_cast<const float*>(tab);
  const float* tp = static_cast<const float*>(taps);
  if (layout == 1) {
    frontend_rows_kernel<__nv_bfloat16, false><<<grid, FE_THREADS, 0, st>>>(
        x, pr, pi, tr, ti, tb, tp, static_cast<__nv_bfloat16*>(out),
        (long long)N, inv_scale);
  } else if (layout == 2) {
    frontend_rows_kernel<float, true><<<grid, FE_THREADS, 0, st>>>(
        x, pr, pi, tr, ti, tb, tp, static_cast<float*>(out), (long long)N,
        inv_scale);
  } else {
    frontend_rows_kernel<float, false><<<grid, FE_THREADS, 0, st>>>(
        x, pr, pi, tr, ti, tb, tp, static_cast<float*>(out), (long long)N,
        inv_scale);
  }
  return (int)cudaGetLastError();
}

extern "C" int sc_frontend_decim_folded(
    const void* pcm, const void* p0r, const void* p0i, const void* tail0_r,
    const void* tail0_i, const void* adv, const void* tab, const void* ctaps,
    const void* unrot, void* out, int B, int C, int out_bf16,
    float inv_scale, void* stream) {
  const dim3 grid((unsigned)((long long)B * C));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int16_t* x = static_cast<const int16_t*>(pcm);
  const float* pr = static_cast<const float*>(p0r);
  const float* pi = static_cast<const float*>(p0i);
  const float* tr = static_cast<const float*>(tail0_r);
  const float* ti = static_cast<const float*>(tail0_i);
  const float* av = static_cast<const float*>(adv);
  const float* tb = static_cast<const float*>(tab);
  const float* ct = static_cast<const float*>(ctaps);
  const float* un = static_cast<const float*>(unrot);
  if (out_bf16) {
    frontend_decim_folded_kernel<__nv_bfloat16><<<grid, FE_THREADS, 0, st>>>(
        x, pr, pi, tr, ti, av, tb, ct, un, static_cast<__nv_bfloat16*>(out),
        B, C, inv_scale);
  } else {
    frontend_decim_folded_kernel<float><<<grid, FE_THREADS, 0, st>>>(
        x, pr, pi, tr, ti, av, tb, ct, un, static_cast<float*>(out), B, C,
        inv_scale);
  }
  return (int)cudaGetLastError();
}

// layout as sc_frontend_rows.
extern "C" int sc_frontend_rows_folded(
    const void* pcm, const void* ph_r, const void* ph_i, const void* tail_r,
    const void* tail_i, const void* tab, const void* ctaps,
    const void* unrot, void* out, int N, int layout, float inv_scale,
    void* stream) {
  const dim3 grid((unsigned)N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int16_t* x = static_cast<const int16_t*>(pcm);
  const float* pr = static_cast<const float*>(ph_r);
  const float* pi = static_cast<const float*>(ph_i);
  const float* tr = static_cast<const float*>(tail_r);
  const float* ti = static_cast<const float*>(tail_i);
  const float* tb = static_cast<const float*>(tab);
  const float* ct = static_cast<const float*>(ctaps);
  const float* un = static_cast<const float*>(unrot);
  if (layout == 1) {
    frontend_rows_folded_kernel<__nv_bfloat16, false>
        <<<grid, FE_THREADS, 0, st>>>(x, pr, pi, tr, ti, tb, ct, un,
                                      static_cast<__nv_bfloat16*>(out),
                                      (long long)N, inv_scale);
  } else if (layout == 2) {
    frontend_rows_folded_kernel<float, true><<<grid, FE_THREADS, 0, st>>>(
        x, pr, pi, tr, ti, tb, ct, un, static_cast<float*>(out),
        (long long)N, inv_scale);
  } else {
    frontend_rows_folded_kernel<float, false><<<grid, FE_THREADS, 0, st>>>(
        x, pr, pi, tr, ti, tb, ct, un, static_cast<float*>(out),
        (long long)N, inv_scale);
  }
  return (int)cudaGetLastError();
}

extern "C" int sc_frontend_full(const void* pcm, const void* ph_r,
                                const void* ph_i, const void* tail_r,
                                const void* tail_i, const void* tab,
                                const void* taps, void* out, int N,
                                float inv_scale, float gain, void* stream) {
  frontend_full_kernel<<<dim3((unsigned)N), FE_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(pcm), static_cast<const float*>(ph_r),
      static_cast<const float*>(ph_i), static_cast<const float*>(tail_r),
      static_cast<const float*>(tail_i), static_cast<const float*>(tab),
      static_cast<const float*>(taps), static_cast<float*>(out), inv_scale,
      gain);
  return (int)cudaGetLastError();
}
