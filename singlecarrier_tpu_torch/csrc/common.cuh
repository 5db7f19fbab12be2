// Shared geometry and helpers of the RX kernels (sm_90a).
//
// The kernels compile in the reference numerology (ModemConfig defaults;
// ops/_build.py KERNEL_GEOMETRY checks a config against it).  Decim
// planes are laid out [cyc][2][N][N_SYM] (phase, real/imag plane, row,
// symbol) with row n = b*C + ch, f32 or bf16; the hunt window of row n
// is [OFF zeros | prev block | this block | zeros], prev being row n - C
// or, for n < C, the carried planes dprev0 [cyc][2][C][N_SYM].
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sc {

constexpr int N_SAMP = 1880;       // frame_size
constexpr int CYC = 5;             // fs / rs
constexpr int N_SYM = 376;         // symbols_per_block
constexpr int NTAPS = 49;
constexpr int HALO = NTAPS - 1;
constexpr int P = 128;             // preamble chips
constexpr int NSEG = 8;            // corr_segments
constexpr int SEG = P / NSEG;
constexpr int D = 248;             // frame_symbols
constexpr int L = 5;               // eq_length
constexpr int OFF = L / 2;
constexpr int NFFT = 512;          // cfo_nfft
constexpr int PKT = 384;           // pkt_window
constexpr int WP = 768;            // hunt window width
constexpr int N_OUT = D + 8;       // packed output row

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float load_plane(const void* p, long long i,
                                            int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// Value j (0 <= j < WP) of the hunt window of row n, phase c, plane p.
__device__ __forceinline__ float window_at(const void* decim,
                                           const void* dprev0, int bf16,
                                           long long N, int C, long long n,
                                           int c, int p, int j) {
  j -= OFF;
  if (j < 0) return 0.f;
  const long long cp = c * 2 + p;
  if (j < N_SYM) {
    return n < C ? load_plane(dprev0, (cp * C + n) * N_SYM + j, bf16)
                 : load_plane(decim, (cp * N + n - C) * N_SYM + j, bf16);
  }
  j -= N_SYM;
  if (j < N_SYM) return load_plane(decim, (cp * N + n) * N_SYM + j, bf16);
  return 0.f;
}

}  // namespace sc
