// The front-end kernels: int16 PCM -> decim planes; a CUDA block works on
// one row at a time (the blocks of the four decimating kernels are
// persistent and take many rows in turn).
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
// do the premix pair's multiply-adds (two sums over one plane where the
// premix pair does one over each of two) and are laid out the same way,
// below: stage_raw, unrotate and folded_window_sums.
//
// frontend_full_kernel replaces frontend_pallas.py::_kernel (:45): the
// downmix and the full-rate 49-tap FIR, all in f32 with no bf16 rounding
// anywhere, y[p][t] = sum_k (taps[k] * gain) * u[p][t + k] in ascending k
// -> [N][2][N_SAMP] f32.  3.76 KB in and 15 KB out per row against
// 49 x 3760 f32 multiply-adds: on paper the byte and the operation terms
// of its bound nearly meet.  It is laid out as the premix pair below, with
// the premix pair's operands, but nothing is rounded and nothing fuses
// (see its own comment).
//
// The premix pair shares stage_block (downmix into shared memory) and
// window_sums: per row, u = [halo | z] (2 planes x 1928 f32 holding bf16
// values) sits in shared memory, then every output y[c][p][s] = sum_k
// w[k] * u[p][5s + c + k] in ascending k, in f32, rounded to the output
// dtype: the plain PyTorch version's exact sequence.  All four
// decimating kernels take their sums from tap_sums and store with
// store_task.
//
// cfg.frontend_dtype is a template parameter of the four decimating
// kernels (ROUND: "bf16", the default; fused_rx.py:378, :495-528,
// frontend_pallas.py:469).  With "f32" the samples (z, the raw plane,
// the halos) are staged unrounded and the taps arrive unrounded, so the
// products are not exact and the tap sums run unfused, tap_sums<false>,
// two FP32 instructions a term as in frontend_full; the fold's rotation
// is f32 in both.  The planes are still rounded to cfg.decim_dtype when
// they are stored.
//
// Bound on the card: bytes (3.76 KB of PCM in and 7.5 KB (bf16) or 15 KB
// (f32) out per row), but tap-order f32 sums on the CUDA cores cannot
// reach it, nor half of it: a row is 2 x 1880 x 49 = 184,240
// multiply-adds, and 132 SMs x 128 lanes issue one FFMA a lane a clock,
// which is 5.8 ms per 1,048,576 rows at the 1.98 GHz the card holds under
// this kernel (6.5 ms at 1.755 GHz) against 3.5 ms for the bytes; the
// staging is another sixth of the instructions.  That FFMA floor is what
// binds, and the design is laid out to come near it:
//
//   * a window in registers.  Neighbouring outputs of a plane share 48
//     of their 49 inputs (the five phases together are the full-rate
//     filter output y[p][t]).  A task is WIN_SYMS symbols of one plane:
//     WIN_T = 5 * WIN_SYMS consecutive outputs from WIN_T + 48 inputs,
//     which a thread reads from shared memory ONCE, 16 bytes a load, in
//     ascending t; each input feeds every accumulator it belongs to
//     while it is in a register, so accumulator i receives its terms in
//     ascending k.  68 loaded values for 980 multiply-adds, where a
//     thread per output read 49 values for 49: the shared-memory pipe
//     (26 ms of the 29.6 ms the one-output form took) is out of the way.
//     Tasks 20 floats apart are five 16-byte units apart: no bank
//     conflict.  Step m needs taps m - 19 .. m only, so the compiler
//     keeps a sliding part of the 49 in registers (56 registers a thread,
//     six blocks an SM).
//   * one instruction a multiply-add.  The build keeps -fmad=false, and
//     the decimating tap loop, and only it, fuses by hand (see tap_sums
//     for why that moves no bit).
//   * persistent blocks that send for the next row's operands (cp.async,
//     16 bytes a thread) before they start a row's sums, so device-memory
//     latency hides behind the multiply-adds; staging from 16 bytes of
//     PCM and 2 x 32 bytes of mixer table a thread; stores of WIN_SYMS
//     neighbouring symbols a thread, so that a warp writes contiguous
//     runs of each phase plane.
//
// The tensor cores were not taken: mma/wgmma would form the same exact
// products but add them in the unit's own order and width, not in
// ascending k in f32, so planes would differ from the plain version on
// bf16 ties, and decisions can follow; and the FFMA floor is already
// under the hunt's and the decode's times.
#include <cuda_pipeline_primitives.h>

#include "common.cuh"

using namespace sc;

namespace {

// A front-end operand: rounded to bf16 (ROUND: cfg.frontend_dtype
// "bf16"), else left in f32.
template <bool ROUND>
__device__ __forceinline__ float fe_operand(float x) {
  if constexpr (ROUND) return bf16_round(x);
  return x;
}

// z = bf16(x * (p * table[t])) (ROUND; else unrounded) for the raw sample
// x_row[i], i = t unless said otherwise, of a block entered with mixer
// phase (pr, pi).
template <bool ROUND>
__device__ __forceinline__ void downmix(const int16_t* __restrict__ x_row,
                                        const float* __restrict__ tab, int t,
                                        int i, float pr, float pi,
                                        float inv_scale, float& zr,
                                        float& zi) {
  const float x = (float)x_row[i] * inv_scale;
  const float tr = tab[t], ti = tab[N_SAMP + t];
  zr = fe_operand<ROUND>(x * (pr * tr - pi * ti));
  zi = fe_operand<ROUND>(x * (pr * ti + pi * tr));
}

// ------------------------------------------------------ the premix pair

// Terms of each tap sum that are formed.  A build with -DSC_FE_TAPS=1
// times the staging and the stores alone (kernel_ab --stages).
#ifndef SC_FE_TAPS
#define SC_FE_TAPS NTAPS
#endif

// A task is WIN_SYMS consecutive symbols of one plane of a row: outputs
// y[p][WIN_T j .. WIN_T j + WIN_T - 1] from u[p][WIN_T j .. WIN_T j +
// WIN_LEN - 1]; thread p * WIN_TASKS_PLANE + j takes task (p, j).  Where
// N_SYM is not whole tasks the last task of a plane is ragged: it sums
// past the block (u is padded to N_STAGE samples) and stores only the
// symbols the row has.
// 4 symbols a task; above 5 cycles, where the cycle count is even, 2, so
// that the WIN_T accumulators stay near the reference's 20 registers (odd
// cycle counts above 5 keep 4: WIN_T must be whole 16-byte loads)
constexpr int WIN_SYMS = CYC > 5 && CYC % 2 == 0 ? 2 : 4;
constexpr int WIN_T = CYC * WIN_SYMS;
constexpr int WIN_LEN = WIN_T + HALO;
constexpr int WIN_VEC = 4;                            // floats a shared load
constexpr int WIN_TASKS_PLANE = (N_SYM + WIN_SYMS - 1) / WIN_SYMS;
constexpr int WIN_TASKS = 2 * WIN_TASKS_PLANE;       // of one row
// a thread a task (at least 96: symbols_per_block is at least P + 1), or
// where that would pass the 1024 threads a block may hold (2-symbol
// tasks past 1024 symbols) WIN_REP a thread: tasks tid + WIN_THREADS r
constexpr int WIN_REP = (WIN_TASKS + 1023) / 1024;
constexpr int WIN_THREADS =
    ((WIN_TASKS + WIN_REP - 1) / WIN_REP + 31) / 32 * 32;
// blocks an SM (__launch_bounds__, persistent_grid): six at the reference
// (56 registers a thread, no spills) and wherever the geometry lies in
// cycles <= 5 and 376 symbols; past that as many as the register file
// holds at about WIN_T + 36 registers a thread
constexpr int WIN_BLOCKS_SM =
    CYC <= 5 && N_SYM <= 376
        ? 6
        : imax(1, 65536 / (WIN_THREADS * (WIN_T + 36)));
constexpr int STAGE_VEC = 8;                          // samples per 16 B of PCM
// samples of a row staged (the ragged last task reads up to its end)
constexpr int N_STAGE = roundup(imax(N_SAMP, WIN_T * WIN_TASKS_PLANE),
                                STAGE_VEC);
// u[p] 16-byte aligned (a halo of 4k + 2 samples pads it by two)
constexpr int U_LEN = roundup(HALO + N_STAGE, 4);
constexpr int W_PAD = (NTAPS + 3) / 4 * 4;
// What the geometry allows of the 16-byte paths, at compile time: the
// staging loop whole (N_STAGE == N_SAMP, whole 8-sample steps), the
// mixer table's imaginary half 16-byte aligned, whole tasks (and with
// them the float4 / 8-byte plane stores), and the bytes a cp.async of a
// PCM row moves (rows N_SAMP int16 apart; 0: element copies).
constexpr bool STAGE_WHOLE = N_STAGE == N_SAMP;
constexpr bool TAB_VEC = N_SAMP % 4 == 0;
constexpr bool TASKS_WHOLE = N_SYM % WIN_SYMS == 0;
constexpr int PCM_BYTES = N_SAMP % 8 == 0   ? 16
                          : N_SAMP % 4 == 0 ? 8
                          : N_SAMP % 2 == 0 ? 4
                                            : 0;
// The halo of ntaps - 1 samples (48 at the reference; 8 to 48, even):
// the bytes a cp.async of a row's raw PCM tail moves (its start, N_SAMP -
// HALO samples into the row, and its length must both be whole copies),
// and of a downmixed f32 tail ([., HALO] rows, 16-byte copies where HALO
// is whole float4s, else 8), and the samples a block keeps of the raw
// tail (whole 16-byte units, so that the tails after it stay aligned).
constexpr int XH_BYTES = HALO % 8 == 0   ? PCM_BYTES
                         : HALO % 4 == 0 ? imin(PCM_BYTES, 8)
                                         : imin(PCM_BYTES, 4);
constexpr int TAIL_BYTES = HALO % 4 == 0 ? 16 : 8;
constexpr int XH_LEN = roundup(HALO, 8);
static_assert((WIN_SYMS == 4 || WIN_SYMS == 2) && WIN_T % WIN_VEC == 0 &&
              U_LEN % 4 == 0 && HALO % 2 == 0 &&
              WIN_THREADS >= 2 * HALO && WIN_THREADS >= 70 &&
              WIN_THREADS >= W_PAD && WIN_TASKS % 2 == 0 &&
              WIN_THREADS <= 1024,
              "window front-end geometry");

// What a block keeps in shared memory: u of the row in work, and the raw
// operands of the row after it, which arrive while the sums run.
struct __align__(16) PremixSmem {
  float u[2][U_LEN];        // [halo | z], bf16 values (or f32: ROUND false)
  float w[W_PAD];           // taps (frontend_full: times the gain)
  int16_t x[N_STAGE];       // PCM of the next row
  int16_t xh[XH_LEN];       // batch form: raw tail of row n - C
  float tail[2][HALO];      // downmixed halo as given (rows; block 0)
  float ph[8];              // rows: phase; batch: p0, adv^b, adv^(b-1)
};

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}

// WIN_SYMS neighbouring symbols of one phase plane, one store, kept out
// of L1 (the row-major layout took twice the time with plain stores).
// Where N_SYM is not whole tasks, the rows are not 16 (8) bytes apart:
// the first `n` symbols a store each.
__device__ __forceinline__ void store_syms(float* o,
                                           const float (&v)[WIN_SYMS],
                                           int n) {
  if constexpr (TASKS_WHOLE && WIN_SYMS == 2) {
    __stcg(reinterpret_cast<float2*>(o), make_float2(v[0], v[1]));
  } else if constexpr (TASKS_WHOLE) {
    __stcg(reinterpret_cast<float4*>(o), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int s = 0; s < WIN_SYMS; ++s)
      if (s < n) __stcg(o + s, v[s]);
  }
}
__device__ __forceinline__ void store_syms(__nv_bfloat16* o,
                                           const float (&v)[WIN_SYMS],
                                           int n) {
  if constexpr (TASKS_WHOLE && WIN_SYMS == 2) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __stcg(reinterpret_cast<unsigned*>(o),
           *reinterpret_cast<const unsigned*>(&lo));
  } else if constexpr (TASKS_WHOLE) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    __stcg(reinterpret_cast<uint2*>(o),
           make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                      *reinterpret_cast<const unsigned*>(&hi)));
  } else {
#pragma unroll
    for (int s = 0; s < WIN_SYMS; ++s)
      if (s < n) o[s] = __float2bfloat16_rn(v[s]);
  }
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b,
                                          const void* c, const void* d) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) &
          15) == 0;
}

// dst[0 .. n) = src[0 .. n), asynchronously BYTES a thread where the
// pointers allow (vec; n * sizeof(T) is a multiple of BYTES), by threads
// first .. first + n * sizeof(T) / BYTES - 1; else (or BYTES 0) element
// by element.
template <typename T, int BYTES = 16>
__device__ __forceinline__ void fetch(T* dst, const T* __restrict__ src,
                                      int n, bool vec, int tid, int first) {
  if constexpr (BYTES > 0) {
    constexpr int PER = BYTES / sizeof(T);
    if (vec) {
      for (int q = tid - first; q >= 0 && q < n / PER; q += WIN_THREADS)
        __pipeline_memcpy_async(dst + PER * q, src + PER * q, BYTES);
      return;
    }
  }
  for (int i = tid; i < n; i += WIN_THREADS) dst[i] = src[i];
}

// A downmixed f32 tail of HALO samples, as fetch moves it.
__device__ __forceinline__ void fetch_tail(float* dst,
                                           const float* __restrict__ src,
                                           bool vec, int tid, int first) {
  fetch<float, TAIL_BYTES>(dst, src, HALO, vec, tid, first);
}

// sm.u[.][HALO + t] = downmixed block of the row whose PCM is in sm.x,
// entered with mixer phase (pr, pi), rounded to bf16 (ROUND: the premix
// pair with bf16 operands) or left in f32 (frontend_full, and the premix
// pair with f32 operands): 8 samples a thread and step.
template <bool ROUND>
__device__ __forceinline__ void stage_block(PremixSmem& sm,
                                            const float* __restrict__ tab,
                                            bool vec, float pr, float pi,
                                            float inv_scale, int tid) {
  for (int t = STAGE_VEC * tid; t < N_STAGE; t += STAGE_VEC * WIN_THREADS) {
    float tr[STAGE_VEC], ti[STAGE_VEC];
    if (vec && (STAGE_WHOLE || (TAB_VEC && t + STAGE_VEC <= N_SAMP))) {
      load4(tab + t, tr);
      load4(tab + t + 4, tr + 4);
      load4(tab + N_SAMP + t, ti);
      load4(tab + N_SAMP + t + 4, ti + 4);
    } else {
      // past the block (the padding to N_STAGE) the table reads as 0, so
      // the padding stages as zeros
#pragma unroll
      for (int e = 0; e < STAGE_VEC; ++e) {
        const bool in = STAGE_WHOLE || t + e < N_SAMP;
        tr[e] = in ? tab[t + e] : 0.f;
        ti[e] = in ? tab[N_SAMP + t + e] : 0.f;
      }
    }
    const uint4 raw = *reinterpret_cast<const uint4*>(&sm.x[t]);
    const unsigned word[4] = {raw.x, raw.y, raw.z, raw.w};
    float zr[STAGE_VEC], zi[STAGE_VEC];
#pragma unroll
    for (int e = 0; e < STAGE_VEC; ++e) {
      const short s = (short)(word[e >> 1] >> (16 * (e & 1)));
      const float x = (float)s * inv_scale;
      zr[e] = x * (pr * tr[e] - pi * ti[e]);
      zi[e] = x * (pr * ti[e] + pi * tr[e]);
      if constexpr (ROUND) {
        zr[e] = bf16_round(zr[e]);
        zi[e] = bf16_round(zi[e]);
      }
    }
    if constexpr (HALO % 4 == 0) {
#pragma unroll
      for (int e = 0; e < STAGE_VEC; e += 4) {
        *reinterpret_cast<float4*>(&sm.u[0][HALO + t + e]) =
            make_float4(zr[e], zr[e + 1], zr[e + 2], zr[e + 3]);
        *reinterpret_cast<float4*>(&sm.u[1][HALO + t + e]) =
            make_float4(zi[e], zi[e + 1], zi[e + 2], zi[e + 3]);
      }
    } else {                 // a halo of 4k + 2 samples: 8-byte stores
#pragma unroll
      for (int e = 0; e < STAGE_VEC; e += 2) {
        *reinterpret_cast<float2*>(&sm.u[0][HALO + t + e]) =
            make_float2(zr[e], zr[e + 1]);
        *reinterpret_cast<float2*>(&sm.u[1][HALO + t + e]) =
            make_float2(zi[e], zi[e + 1]);
      }
    }
  }
}

// acc[i] = sum_k ws[k] * up[i + k], i < WIN_T: the 49-tap sums of one
// task, the window in shared memory at up, the taps at ws (every
// front-end).  The thread slides the window through registers: input
// m = 0 .. WIN_LEN - 1 is loaded once and added into accumulator i with
// tap k = m - i wherever 0 <= k < 49, so every accumulator starts from
// 0.f and takes its 49 terms in ascending k, as the plain versions do.
//
// FUSED (the four decimating front-ends with bf16 operands, ROUND): the
// multiply-add is fused by hand (-fmad=false stays the build's flag) and
// returns the bits of the unfused one BECAUSE BOTH OPERANDS ARE bf16
// VALUES: the taps are rounded to bf16 (w[k] = bf16(2.2 taps[k]), or the
// real or imaginary part of a folded tap) and every u was rounded to bf16
// on its way into shared memory.  Their product has at most 16
// significant bits and is exact in f32, so fmaf(w, u, acc) = round(acc +
// w u) = acc + round(w u).  That
// holds for u = 0 and wherever the product does not underflow: for the
// premix taps of alpha = 0.35 (smallest 5.4e-4) for every |u| > 2.35e-38,
// and a u made from int16 PCM by the downmix, or a tail carried from one,
// is zero or some twenty orders of magnitude above that; for the folded
// taps (one is 1.5e-16 at 49 taps, 3.7e-18 at 25) for |u| >= 2^-80
// (2^-60 at the other RRC lengths), and a raw sample, or a carried tail
// un-rotated, is zero or at least 2^-15
// (tests/test_torch_frontend_window.py holds each statement).  It does
// NOT hold for f32 taps or f32 samples: not in the downmix, the halo's
// un-rotation, the fold's rotation, in frontend_full or in the decimating
// four with cfg.frontend_dtype "f32", which take the loop unfused (FUSED
// false): each product and each sum rounded on its own by __fmul_rn and
// __fadd_rn, which no build flag contracts, so two FP32 instructions a
// term where the fused loop needs one.
template <bool FUSED>
__device__ __forceinline__ void tap_sums(const float* __restrict__ ws,
                                         const float* __restrict__ up,
                                         float (&acc)[WIN_T]) {
  float w[W_PAD];
#pragma unroll
  for (int k = 0; k < W_PAD; k += 4)           // broadcast loads
    load4(ws + k, &w[k]);
#pragma unroll
  for (int i = 0; i < WIN_T; ++i) acc[i] = 0.f;
#pragma unroll
  for (int m0 = 0; m0 < WIN_LEN; m0 += WIN_VEC) {
    float v[WIN_VEC];
    load4(up + m0, v);
#pragma unroll
    for (int e = 0; e < WIN_VEC; ++e) {
#pragma unroll
      for (int i = 0; i < WIN_T; ++i) {
        const int k = m0 + e - i;
        if (k >= 0 && k < SC_FE_TAPS) {
          if constexpr (FUSED)
            acc[i] = __fmaf_rn(w[k], v[e], acc[i]);
          else
            acc[i] = __fadd_rn(acc[i], __fmul_rn(w[k], v[e]));
        }
      }
    }
  }
}

// Task j's WIN_SYMS symbols of plane p in every phase c, from its WIN_T
// full-rate outputs y: ROW_MAJOR writes out[row][c][p][s], else
// out[c][p][row][s].
template <typename OutT, bool ROW_MAJOR>
__device__ __forceinline__ void store_task(OutT* __restrict__ out,
                                           const float (&y)[WIN_T], int p,
                                           int j, long long N,
                                           long long row) {
#pragma unroll
  for (int c = 0; c < CYC; ++c) {
    const int cp = 2 * c + p;
    const long long o =
        (ROW_MAJOR ? (row * (2 * CYC) + cp) : ((long long)cp * N + row)) *
            N_SYM + WIN_SYMS * j;
    float v[WIN_SYMS];
#pragma unroll
    for (int s = 0; s < WIN_SYMS; ++s) v[s] = y[CYC * s + c];
    store_syms(out + o, v, N_SYM - WIN_SYMS * j);
  }
}

// The premix sums of the row in sm.u, a task (plane p, symbols 4j ..
// 4j + 3) a thread (WIN_REP), fused where the operands are bf16 values
// (ROUND).
template <typename OutT, bool ROW_MAJOR, bool ROUND>
__device__ __forceinline__ void window_sums(const PremixSmem& sm,
                                            OutT* __restrict__ out,
                                            long long N, long long row,
                                            int tid) {
#pragma unroll
  for (int r = 0; r < WIN_REP; ++r) {
    const int task = tid + WIN_THREADS * r;
    if (task >= WIN_TASKS) return;
    const int p = task / WIN_TASKS_PLANE;
    const int j = task - p * WIN_TASKS_PLANE;
    float acc[WIN_T];
    tap_sums<ROUND>(sm.w, &sm.u[p][WIN_T * j], acc);
    store_task<OutT, ROW_MAJOR>(out, acc, p, j, N, row);
  }
}

// Both kernels are persistent: block i takes rows i, i + gridDim.x, ..
// and, between the barrier that ends a row's staging and the row's sums,
// sends for the next row's operands, so device-memory latency hides
// behind the multiply-adds.

template <typename OutT, bool ROUND>
__global__ void __launch_bounds__(WIN_THREADS, WIN_BLOCKS_SM)
    frontend_decim_kernel(
        const int16_t* __restrict__ pcm, const float* __restrict__ p0r,
        const float* __restrict__ p0i, const float* __restrict__ tail0_r,
        const float* __restrict__ tail0_i, const float* __restrict__ adv,
        const float* __restrict__ tab, const float* __restrict__ taps,
        OutT* __restrict__ out, int B, int C, float inv_scale) {
  SC_BLOCK_SMEM(PremixSmem, sm);
  const long long N = (long long)B * C;
  const int tid = threadIdx.x;
  const bool vec = aligned16(pcm, tail0_r, tail0_i, tab);
  if (tid < W_PAD) sm.w[tid] = tid < NTAPS ? taps[tid] : 0.f;

  // operands of row n: its PCM; its halo (block 0: the carried tail;
  // else row n - C's raw tail); p0[ch], adv^b and adv^(b-1)
  auto fetch_row = [&](long long row) {
    const int b = (int)(row / C);
    const int ch = (int)(row - (long long)b * C);
    fetch<int16_t, PCM_BYTES>(sm.x, pcm + row * N_SAMP, N_SAMP, vec, tid, 0);
    if (b == 0) {
      fetch_tail(sm.tail[0], tail0_r + ch * HALO, vec, tid, 0);
      fetch_tail(sm.tail[1], tail0_i + ch * HALO, vec, tid, 32);
    } else {
      fetch<int16_t, XH_BYTES>(sm.xh, pcm + (row - C) * N_SAMP + N_SAMP - HALO,
                               HALO, vec, tid, 32);
    }
    if (tid >= 64 && tid < 70) {
      const int i = tid - 64, bm = b > 0 ? b - 1 : 0;
      const float* src = i < 2 ? (i == 0 ? p0r : p0i) + ch
                               : adv + (i & 1) * B + (i < 4 ? b : bm);
      __pipeline_memcpy_async(&sm.ph[i], src, 4);
    }
    __pipeline_commit();
  };

  long long row = blockIdx.x;
  if (row < N) fetch_row(row);
  for (; row < N; row += gridDim.x) {
    __pipeline_wait_prior(0);
    __syncthreads();        // the row's operands are in; sm.u is free
    // mixer phase entering block b: p0 * adv^b
    const float q_r = sm.ph[0], q_i = sm.ph[1];
    const float pr = q_r * sm.ph[2] - q_i * sm.ph[3];
    const float pi = q_r * sm.ph[3] + q_i * sm.ph[2];
    stage_block<ROUND>(sm, tab, vec, pr, pi, inv_scale, tid);
    const int m = tid - (WIN_THREADS - HALO);
    if (m >= 0) {
      if (row < C) {
        sm.u[0][m] = fe_operand<ROUND>(sm.tail[0][m]);
        sm.u[1][m] = fe_operand<ROUND>(sm.tail[1][m]);
      } else {
        // the halo of a row with b > 0: the same products the previous
        // block's row formed, with the phase p0 * adv^(b-1)
        const float sr = q_r * sm.ph[4] - q_i * sm.ph[5];
        const float si = q_r * sm.ph[5] + q_i * sm.ph[4];
        downmix<ROUND>(sm.xh, tab, N_SAMP - HALO + m, m, sr, si, inv_scale,
                       sm.u[0][m], sm.u[1][m]);
      }
    }
    __syncthreads();        // sm.u is whole; the raw operands are used up
    if (row + gridDim.x < N) fetch_row(row + gridDim.x);
    window_sums<OutT, false, ROUND>(sm, out, N, row, tid);
  }
}

template <typename OutT, bool ROW_MAJOR, bool ROUND>
__global__ void __launch_bounds__(WIN_THREADS, WIN_BLOCKS_SM)
    frontend_rows_kernel(
        const int16_t* __restrict__ pcm, const float* __restrict__ ph_r,
        const float* __restrict__ ph_i, const float* __restrict__ tail_r,
        const float* __restrict__ tail_i, const float* __restrict__ tab,
        const float* __restrict__ taps, OutT* __restrict__ out, long long N,
        float inv_scale) {
  SC_BLOCK_SMEM(PremixSmem, sm);
  const int tid = threadIdx.x;
  const bool vec = aligned16(pcm, tail_r, tail_i, tab);
  if (tid < W_PAD) sm.w[tid] = tid < NTAPS ? taps[tid] : 0.f;

  auto fetch_row = [&](long long row) {
    fetch<int16_t, PCM_BYTES>(sm.x, pcm + row * N_SAMP, N_SAMP, vec, tid, 0);
    fetch_tail(sm.tail[0], tail_r + row * HALO, vec, tid, 0);
    fetch_tail(sm.tail[1], tail_i + row * HALO, vec, tid, 32);
    if (tid >= 64 && tid < 66)
      __pipeline_memcpy_async(&sm.ph[tid - 64],
                              (tid == 64 ? ph_r : ph_i) + row, 4);
    __pipeline_commit();
  };

  long long row = blockIdx.x;
  if (row < N) fetch_row(row);
  for (; row < N; row += gridDim.x) {
    __pipeline_wait_prior(0);
    __syncthreads();        // the row's operands are in; sm.u is free
    stage_block<ROUND>(sm, tab, vec, sm.ph[0], sm.ph[1], inv_scale, tid);
    const int m = tid - (WIN_THREADS - HALO);
    if (m >= 0) {
      sm.u[0][m] = fe_operand<ROUND>(sm.tail[0][m]);
      sm.u[1][m] = fe_operand<ROUND>(sm.tail[1][m]);
    }
    __syncthreads();        // sm.u is whole; the raw operands are used up
    if (row + gridDim.x < N) fetch_row(row + gridDim.x);
    window_sums<OutT, ROW_MAJOR, ROUND>(sm, out, N, row, tid);
  }
}

// ---------------------------------------------------------- mixer fold

// What a folded block keeps in shared memory: the raw plane of the row in
// work, the two tap sets and the halo un-rotation, and the raw operands
// of the row after it.
struct __align__(16) FoldSmem {
  float u[U_LEN];           // [halo | bf16(x)], bf16 values (or f32)
  float w[2][W_PAD];        // real, imaginary parts of the folded taps
  float eu[2][HALO];        // halo un-rotation: cos, sin of w(m - HALO + 1)
  int16_t x[N_STAGE];       // PCM of the next row
  int16_t xh[XH_LEN];       // batch form: raw tail of row n - C
  float tail[2][HALO];      // downmixed halo as given (rows; block 0)
  float ph[4];              // rows: phase; batch: p0, adv^b
};

__device__ __forceinline__ void load_fold_tables(
    FoldSmem& sm, const float* __restrict__ ctaps,
    const float* __restrict__ unrot, int tid) {
  for (int i = tid; i < 2 * W_PAD; i += WIN_THREADS) {
    const int q = i / W_PAD, k = i - q * W_PAD;
    sm.w[q][k] = k < NTAPS ? ctaps[q * NTAPS + k] : 0.f;
  }
  if (tid < 2 * HALO) sm.eu[tid / HALO][tid % HALO] = unrot[tid];
}

// sm.u[HALO + t] = bf16(x[t]) (ROUND; else x[t]): the raw block of the
// row whose PCM is in sm.x, 8 samples a thread and step.
template <bool ROUND>
__device__ __forceinline__ void stage_raw(FoldSmem& sm, float inv_scale,
                                          int tid) {
  for (int t = STAGE_VEC * tid; t < N_STAGE; t += STAGE_VEC * WIN_THREADS) {
    const uint4 raw = *reinterpret_cast<const uint4*>(&sm.x[t]);
    const unsigned word[4] = {raw.x, raw.y, raw.z, raw.w};
    float z[STAGE_VEC];
#pragma unroll
    for (int e = 0; e < STAGE_VEC; ++e)      // the padding stages as zeros
      z[e] = STAGE_WHOLE || t + e < N_SAMP
                 ? fe_operand<ROUND>(
                       (float)(short)(word[e >> 1] >> (16 * (e & 1))) *
                       inv_scale)
                 : 0.f;
    if constexpr (HALO % 4 == 0) {
#pragma unroll
      for (int e = 0; e < STAGE_VEC; e += 4)
        *reinterpret_cast<float4*>(&sm.u[HALO + t + e]) =
            make_float4(z[e], z[e + 1], z[e + 2], z[e + 3]);
    } else {                 // a halo of 4k + 2 samples: 8-byte stores
#pragma unroll
      for (int e = 0; e < STAGE_VEC; e += 2)
        *reinterpret_cast<float2*>(&sm.u[HALO + t + e]) =
            make_float2(z[e], z[e + 1]);
    }
  }
}

// Raw sample m of a downmixed halo (t_r, t_i) carried with phase (pr, pi):
// Re[tail * conj(phase) * e^{-jw(m - HALO + 1)}], rounded to bf16 (ROUND).
// Every product and sum rounded on its own: the operands are f32.
template <bool ROUND>
__device__ __forceinline__ float unrotate(float t_r, float t_i, float pr,
                                          float pi, float eur, float eui) {
  const float a = t_r * pr + t_i * pi;
  const float b = t_i * pr - t_r * pi;
  return fe_operand<ROUND>(a * eur + b * eui);
}

// The folded sums of the row in sm.u.  Lanes 2j and 2j + 1 share task j
// (WIN_SYMS symbols of the one raw plane): both slide the same window,
// so their shared-memory loads are broadcasts, lane q against tap set q
// (A = sum_k Re c_k u, B = sum_k Im c_k u; tap_sums).  A shuffle a
// sum hands each lane its partner's, and each lane forms its part of the
// rotation by (mr + j mi) = (pr + j pi) * table[t]: the even lane yr =
// mr A - mi B, the odd lane yi = mr B + mi A, each product and sum
// rounded on its own as the plain version rounds them (written as
// mr own + (-/+ mi) other: a - b is a + (-b) in IEEE arithmetic).  Each
// lane then stores its phase planes (p = q).  Thread tid takes tasks
// tid + WIN_THREADS r, r < WIN_REP, every lane of the warp in every
// ballot; WIN_THREADS is whole warps, so a pair stays lanes 2j, 2j + 1.
template <typename OutT, bool ROW_MAJOR, bool ROUND>
__device__ __forceinline__ void folded_window_sums(
    const FoldSmem& sm, const float* __restrict__ tab, bool vec, float pr,
    float pi, OutT* __restrict__ out, long long N, long long row, int tid) {
#pragma unroll
  for (int r = 0; r < WIN_REP; ++r) {
    const int task = tid + WIN_THREADS * r;
    const unsigned pairs = __ballot_sync(0xffffffffu, task < WIN_TASKS);
    if (task < WIN_TASKS) {
      const int j = task >> 1, q = task & 1;
      float acc[WIN_T];
      tap_sums<ROUND>(sm.w[q], &sm.u[WIN_T * j], acc);
      const float* ta = tab + WIN_T * j;
#pragma unroll
      for (int i0 = 0; i0 < WIN_T; i0 += 4) {
        float tr[4], ti[4];
        if (vec && TAB_VEC &&
            (TASKS_WHOLE || WIN_T * j + i0 + 4 <= N_SAMP)) {
          load4(ta + i0, tr);
          load4(ta + N_SAMP + i0, ti);
        } else {         // past the block: outputs that are not stored
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool in = TASKS_WHOLE || WIN_T * j + i0 + e < N_SAMP;
            tr[e] = in ? ta[i0 + e] : 0.f;
            ti[e] = in ? ta[N_SAMP + i0 + e] : 0.f;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float other = __shfl_xor_sync(pairs, acc[i0 + e], 1);
          const float mr = pr * tr[e] - pi * ti[e];
          const float mi = pr * ti[e] + pi * tr[e];
          acc[i0 + e] = mr * acc[i0 + e] + (q ? mi : -mi) * other;
        }
      }
      store_task<OutT, ROW_MAJOR>(out, acc, q, j, N, row);
    }
  }
}

// Both kernels are persistent, as the premix pair: the next row's
// operands arrive while a row's sums run.

template <typename OutT, bool ROUND>
__global__ void __launch_bounds__(WIN_THREADS, WIN_BLOCKS_SM)
    frontend_decim_folded_kernel(
        const int16_t* __restrict__ pcm, const float* __restrict__ p0r,
        const float* __restrict__ p0i, const float* __restrict__ tail0_r,
        const float* __restrict__ tail0_i, const float* __restrict__ adv,
        const float* __restrict__ tab, const float* __restrict__ ctaps,
        const float* __restrict__ unrot, OutT* __restrict__ out, int B,
        int C, float inv_scale) {
  SC_BLOCK_SMEM(FoldSmem, sm);
  const long long N = (long long)B * C;
  const int tid = threadIdx.x;
  const bool vec = aligned16(pcm, tail0_r, tail0_i, tab);
  load_fold_tables(sm, ctaps, unrot, tid);

  // operands of row n: its PCM; its halo's source (block 0: the carried
  // tail; else row n - C's raw tail); p0[ch] and adv^b
  auto fetch_row = [&](long long row) {
    const int b = (int)(row / C);
    const int ch = (int)(row - (long long)b * C);
    fetch<int16_t, PCM_BYTES>(sm.x, pcm + row * N_SAMP, N_SAMP, vec, tid, 0);
    if (b == 0) {
      fetch_tail(sm.tail[0], tail0_r + ch * HALO, vec, tid, 0);
      fetch_tail(sm.tail[1], tail0_i + ch * HALO, vec, tid, 32);
    } else {
      fetch<int16_t, XH_BYTES>(sm.xh, pcm + (row - C) * N_SAMP + N_SAMP - HALO,
                               HALO, vec, tid, 32);
    }
    if (tid >= 64 && tid < 68) {
      const int i = tid - 64;
      const float* src =
          i < 2 ? (i == 0 ? p0r : p0i) + ch : adv + (i & 1) * B + b;
      __pipeline_memcpy_async(&sm.ph[i], src, 4);
    }
    __pipeline_commit();
  };

  long long row = blockIdx.x;
  if (row < N) fetch_row(row);
  for (; row < N; row += gridDim.x) {
    __pipeline_wait_prior(0);
    __syncthreads();        // the row's operands are in; sm.u is free
    // mixer phase entering block b: p0 * adv^b
    const float q_r = sm.ph[0], q_i = sm.ph[1];
    const float pr = q_r * sm.ph[2] - q_i * sm.ph[3];
    const float pi = q_r * sm.ph[3] + q_i * sm.ph[2];
    stage_raw<ROUND>(sm, inv_scale, tid);
    const int m = tid - (WIN_THREADS - HALO);
    if (m >= 0) {
      sm.u[m] = row < C ? unrotate<ROUND>(sm.tail[0][m], sm.tail[1][m], pr,
                                          pi, sm.eu[0][m], sm.eu[1][m])
                        : fe_operand<ROUND>((float)sm.xh[m] * inv_scale);
    }
    __syncthreads();        // sm.u is whole; the raw operands are used up
    if (row + gridDim.x < N) fetch_row(row + gridDim.x);
    folded_window_sums<OutT, false, ROUND>(sm, tab, vec, pr, pi, out, N,
                                           row, tid);
  }
}

template <typename OutT, bool ROW_MAJOR, bool ROUND>
__global__ void __launch_bounds__(WIN_THREADS, WIN_BLOCKS_SM)
    frontend_rows_folded_kernel(
        const int16_t* __restrict__ pcm, const float* __restrict__ ph_r,
        const float* __restrict__ ph_i, const float* __restrict__ tail_r,
        const float* __restrict__ tail_i, const float* __restrict__ tab,
        const float* __restrict__ ctaps, const float* __restrict__ unrot,
        OutT* __restrict__ out, long long N, float inv_scale) {
  SC_BLOCK_SMEM(FoldSmem, sm);
  const int tid = threadIdx.x;
  const bool vec = aligned16(pcm, tail_r, tail_i, tab);
  load_fold_tables(sm, ctaps, unrot, tid);

  auto fetch_row = [&](long long row) {
    fetch<int16_t, PCM_BYTES>(sm.x, pcm + row * N_SAMP, N_SAMP, vec, tid, 0);
    fetch_tail(sm.tail[0], tail_r + row * HALO, vec, tid, 0);
    fetch_tail(sm.tail[1], tail_i + row * HALO, vec, tid, 32);
    if (tid >= 64 && tid < 66)
      __pipeline_memcpy_async(&sm.ph[tid - 64],
                              (tid == 64 ? ph_r : ph_i) + row, 4);
    __pipeline_commit();
  };

  long long row = blockIdx.x;
  if (row < N) fetch_row(row);
  for (; row < N; row += gridDim.x) {
    __pipeline_wait_prior(0);
    __syncthreads();        // the row's operands are in; sm.u is free
    const float pr = sm.ph[0], pi = sm.ph[1];
    stage_raw<ROUND>(sm, inv_scale, tid);
    const int m = tid - (WIN_THREADS - HALO);
    if (m >= 0)
      sm.u[m] = unrotate<ROUND>(sm.tail[0][m], sm.tail[1][m], pr, pi,
                                sm.eu[0][m], sm.eu[1][m]);
    __syncthreads();        // sm.u is whole; the raw operands are used up
    if (row + gridDim.x < N) fetch_row(row + gridDim.x);
    folded_window_sums<OutT, ROW_MAJOR, ROUND>(sm, tab, vec, pr, pi, out, N,
                                               row, tid);
  }
}

// ------------------------------------------------- full-rate front-end

// frontend_full_kernel is laid out as the premix pair, and its function
// is theirs without a rounding: f32 samples, f32 taps, f32 sums.
//
//   * Bound: 3.76 KB in and 15 KB out a row (bytes 0.1877 ms at 32,768
//     rows) and 184,240 multiply-adds a row.  Unfused they are 368,480
//     FP32 instructions, FMUL and FADD, which 132 SMs x 128 lanes issue
//     in 0.361 ms at 32,768 rows at 1.98 GHz: twice the decimating four's
//     FFMA floor, and what binds.
//   * Persistent blocks of WIN_THREADS threads, WIN_BLOCKS_SM an SM
//     (persistent_grid); after the barrier that ends a row's staging the
//     block sends for the next row's PCM, halo and phase with cp.async,
//     as frontend_rows_kernel (frontend.cu:400-438) does with the same
//     operands.
//   * Staging unrounded: stage_block<false> (frontend.cu:196-235), 16
//     bytes of PCM and 2 x 32 bytes of mixer table a thread, into
//     u[2][1928] f32 in shared memory; the halo copied as given.
//   * The taps w_k = taps[k] * gain formed once a block in shared memory,
//     not rounded.
//   * The window in registers, unfused: a thread a task of WIN_SYMS
//     symbols = WIN_T consecutive full-rate outputs of one plane from
//     WIN_LEN inputs, 188 tasks a row on 192 threads, through
//     tap_sums<false> (frontend.cu:263-291): each product and each sum
//     rounded on its own, from 0.f in ascending k.  The f32 products are
//     not exact, so a fused multiply-add would return other bits
//     (tests/test_torch_frontend_window.py holds the counter-case).
//   * Stores through shared memory.  A task's WIN_T outputs go to a row
//     buffer y in shared memory (five float4 writes, tasks 20 floats
//     apart: no bank conflict); after a barrier the block writes the
//     row's 15,040 contiguous bytes of the row-major [N][2][N_SAMP]
//     output 16 bytes a thread, a warp's 512 bytes together, with __stcg
//     (plain stores took the row-major f32 planes of frontend_rows twice
//     the time).  Five float4 stores straight from the registers, 80
//     bytes apart across a warp, doubled the staging-and-stores time of
//     kernel_ab --stages and cost the whole kernel some 2%.  Where the
//     row buffer and the operands would pass the 227 KB a block may hold
//     (FULL_ROW_BUFFER false: about 12,900 samples a block and more, 8
//     cycles at 1616 symbols) a task stores its outputs straight from
//     the registers, a value a store.
//   * Six blocks an SM: 53 registers a thread and 34,944 bytes of shared
//     memory a block (ptxas -v), under the 56 and the 227 KB / 6 that
//     allows; no spill.

// What a full-rate block keeps in shared memory: the premix pair's
// operands, and the row's outputs on their way to device memory.
constexpr int Y_PLANE = WIN_T * WIN_TASKS_PLANE;   // N_SAMP, or past it
constexpr bool FULL_ROW_BUFFER =
    sizeof(PremixSmem) + 2 * Y_PLANE * sizeof(float) <= 232448;
struct __align__(16) FullSmem {
  PremixSmem in;
  float y[FULL_ROW_BUFFER ? 2 * Y_PLANE : 4];   // [p][t] of the row in work
};

// The sums of the row in sm.in.u, a task (plane p, outputs WIN_T j ..
// WIN_T j + WIN_T - 1) a thread (WIN_REP), into sm.y: task tid's outputs
// are floats WIN_T tid .. of the row, 20 floats apart a thread, so the
// float4 writes of a quarter warp take every bank once.  Without the row
// buffer, into row `row` of out (those of the row's N_SAMP outputs).
__device__ __forceinline__ void full_window_sums(FullSmem& sm, int tid,
                                                 float* __restrict__ out,
                                                 long long row) {
#pragma unroll
  for (int r = 0; r < WIN_REP; ++r) {
    const int task = tid + WIN_THREADS * r;
    if (task >= WIN_TASKS) return;
    const int p = task / WIN_TASKS_PLANE;
    const int j = task - p * WIN_TASKS_PLANE;
    float acc[WIN_T];
    tap_sums<false>(sm.in.w, &sm.in.u[p][WIN_T * j], acc);
    if constexpr (FULL_ROW_BUFFER) {
      float* y = sm.y + WIN_T * task;
#pragma unroll
      for (int i = 0; i < WIN_T; i += 4)
        *reinterpret_cast<float4*>(y + i) =
            make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
    } else {
      float* o = out + row * (2 * N_SAMP) + p * N_SAMP + WIN_T * j;
#pragma unroll
      for (int i = 0; i < WIN_T; ++i)
        if (TASKS_WHOLE || WIN_T * j + i < N_SAMP) __stcg(o + i, acc[i]);
    }
  }
}

__global__ void __launch_bounds__(WIN_THREADS, WIN_BLOCKS_SM)
    frontend_full_kernel(
        const int16_t* __restrict__ pcm, const float* __restrict__ ph_r,
        const float* __restrict__ ph_i, const float* __restrict__ tail_r,
        const float* __restrict__ tail_i, const float* __restrict__ tab,
        const float* __restrict__ taps, float* __restrict__ out,
        long long N, float inv_scale, float gain) {
  SC_BLOCK_SMEM(FullSmem, sm);
  PremixSmem& in = sm.in;
  const int tid = threadIdx.x;
  const bool vec = aligned16(pcm, tail_r, tail_i, tab);
  if (tid < W_PAD) in.w[tid] = tid < NTAPS ? taps[tid] * gain : 0.f;

  auto fetch_row = [&](long long row) {
    fetch<int16_t, PCM_BYTES>(in.x, pcm + row * N_SAMP, N_SAMP, vec, tid, 0);
    fetch_tail(in.tail[0], tail_r + row * HALO, vec, tid, 0);
    fetch_tail(in.tail[1], tail_i + row * HALO, vec, tid, 32);
    if (tid >= 64 && tid < 66)
      __pipeline_memcpy_async(&in.ph[tid - 64],
                              (tid == 64 ? ph_r : ph_i) + row, 4);
    __pipeline_commit();
  };

  long long row = blockIdx.x;
  if (row < N) fetch_row(row);
  for (; row < N; row += gridDim.x) {
    __pipeline_wait_prior(0);
    __syncthreads();        // the row's operands are in; u and y are free
    stage_block<false>(in, tab, vec, in.ph[0], in.ph[1], inv_scale, tid);
    const int m = tid - (WIN_THREADS - HALO);
    if (m >= 0) {
      in.u[0][m] = in.tail[0][m];
      in.u[1][m] = in.tail[1][m];
    }
    __syncthreads();        // u is whole; the raw operands are used up
    if (row + gridDim.x < N) fetch_row(row + gridDim.x);
    full_window_sums(sm, tid, out, row);
    if constexpr (FULL_ROW_BUFFER) {
      __syncthreads();      // y is whole
      if constexpr (Y_PLANE == N_SAMP && N_SAMP % 2 == 0) {
        float4* o = reinterpret_cast<float4*>(out + row * (2 * N_SAMP));
        const float4* y = reinterpret_cast<const float4*>(sm.y);
        for (int q = tid; q < 2 * N_SAMP / 4; q += WIN_THREADS)
          __stcg(o + q, y[q]);
      } else {               // a ragged last task: planes Y_PLANE apart
        float* o = out + row * (2 * N_SAMP);
        for (int i = tid; i < 2 * N_SAMP; i += WIN_THREADS) {
          const int p = i >= N_SAMP;
          __stcg(o + i, sm.y[p * Y_PLANE + i - p * N_SAMP]);
        }
      }
    }
  }
}

// Blocks of a persistent front-end kernel for N rows:
// as many as the card holds at once, at most one a row.
unsigned persistent_grid(long long N) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long held = (long long)(sms > 0 ? sms : 1) * WIN_BLOCKS_SM;
  return (unsigned)(N < held ? (N > 0 ? N : 1) : held);
}

// Launch a persistent front-end kernel whose block holds an S on N rows
// (its shared memory dynamic where S is past the static limit).
template <class S, class K, class... Args>
cudaError_t launch(K kernel, long long N, cudaStream_t st, Args... args) {
  const cudaError_t ready = allow_smem<S>(kernel);
  if (ready != cudaSuccess) return ready;
  kernel<<<persistent_grid(N), WIN_THREADS, SMEM_LAUNCH_BYTES<S>, st>>>(
      args...);
  return cudaGetLastError();
}

template <bool ROUND>
cudaError_t launch_decim(const int16_t* x, const float* p0r,
                         const float* p0i, const float* tr, const float* ti,
                         const float* av, const float* tb, const float* tp,
                         void* out, int B, int C, int out_bf16,
                         float inv_scale, cudaStream_t st) {
  const long long N = (long long)B * C;
  if (out_bf16)
    return launch<PremixSmem>(
        frontend_decim_kernel<__nv_bfloat16, ROUND>, N, st, x, p0r, p0i, tr,
        ti, av, tb, tp, static_cast<__nv_bfloat16*>(out), B, C, inv_scale);
  return launch<PremixSmem>(frontend_decim_kernel<float, ROUND>, N, st, x,
                            p0r, p0i, tr, ti, av, tb, tp,
                            static_cast<float*>(out), B, C, inv_scale);
}

template <bool ROUND>
cudaError_t launch_rows(const int16_t* x, const float* pr, const float* pi,
                        const float* tr, const float* ti, const float* tb,
                        const float* tp, void* out, int N, int layout,
                        float inv_scale, cudaStream_t st) {
  if (layout == 1)
    return launch<PremixSmem>(
        frontend_rows_kernel<__nv_bfloat16, false, ROUND>, N, st, x, pr, pi,
        tr, ti, tb, tp, static_cast<__nv_bfloat16*>(out), (long long)N,
        inv_scale);
  if (layout == 2)
    return launch<PremixSmem>(frontend_rows_kernel<float, true, ROUND>, N,
                              st, x, pr, pi, tr, ti, tb, tp,
                              static_cast<float*>(out), (long long)N,
                              inv_scale);
  return launch<PremixSmem>(frontend_rows_kernel<float, false, ROUND>, N, st,
                            x, pr, pi, tr, ti, tb, tp,
                            static_cast<float*>(out), (long long)N,
                            inv_scale);
}

template <bool ROUND>
cudaError_t launch_decim_folded(const int16_t* x, const float* p0r,
                                const float* p0i, const float* tr,
                                const float* ti, const float* av,
                                const float* tb, const float* ct,
                                const float* un, void* out, int B, int C,
                                int out_bf16, float inv_scale,
                                cudaStream_t st) {
  const long long N = (long long)B * C;
  if (out_bf16)
    return launch<FoldSmem>(
        frontend_decim_folded_kernel<__nv_bfloat16, ROUND>, N, st, x, p0r,
        p0i, tr, ti, av, tb, ct, un, static_cast<__nv_bfloat16*>(out), B, C,
        inv_scale);
  return launch<FoldSmem>(frontend_decim_folded_kernel<float, ROUND>, N, st,
                          x, p0r, p0i, tr, ti, av, tb, ct, un,
                          static_cast<float*>(out), B, C, inv_scale);
}

template <bool ROUND>
cudaError_t launch_rows_folded(const int16_t* x, const float* pr,
                               const float* pi, const float* tr,
                               const float* ti, const float* tb,
                               const float* ct, const float* un, void* out,
                               int N, int layout, float inv_scale,
                               cudaStream_t st) {
  if (layout == 1)
    return launch<FoldSmem>(
        frontend_rows_folded_kernel<__nv_bfloat16, false, ROUND>, N, st, x,
        pr, pi, tr, ti, tb, ct, un, static_cast<__nv_bfloat16*>(out),
        (long long)N, inv_scale);
  if (layout == 2)
    return launch<FoldSmem>(frontend_rows_folded_kernel<float, true, ROUND>,
                            N, st, x, pr, pi, tr, ti, tb, ct, un,
                            static_cast<float*>(out), (long long)N,
                            inv_scale);
  return launch<FoldSmem>(frontend_rows_folded_kernel<float, false, ROUND>,
                          N, st, x, pr, pi, tr, ti, tb, ct, un,
                          static_cast<float*>(out), (long long)N, inv_scale);
}

const int16_t* i16p(const void* p) { return static_cast<const int16_t*>(p); }
const float* f32p(const void* p) { return static_cast<const float*>(p); }

}  // namespace

// The decimating front-ends' last int before the stream, f32_operands, is
// cfg.frontend_dtype "f32": the ROUND false instantiation.
extern "C" int sc_frontend_decim(const void* pcm, const void* p0r,
                                 const void* p0i, const void* tail0_r,
                                 const void* tail0_i, const void* adv,
                                 const void* tab, const void* taps, void* out,
                                 int B, int C, int out_bf16, float inv_scale,
                                 int f32_operands, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(f32_operands ? launch_decim<false> : launch_decim<true>)(
      i16p(pcm), f32p(p0r), f32p(p0i), f32p(tail0_r), f32p(tail0_i),
      f32p(adv), f32p(tab), f32p(taps), out, B, C, out_bf16, inv_scale, st);
}

// layout: 0 = transposed f32, 1 = transposed bf16, 2 = row-major f32.
extern "C" int sc_frontend_rows(const void* pcm, const void* ph_r,
                                const void* ph_i, const void* tail_r,
                                const void* tail_i, const void* tab,
                                const void* taps, void* out, int N,
                                int layout, float inv_scale, int f32_operands,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(f32_operands ? launch_rows<false> : launch_rows<true>)(
      i16p(pcm), f32p(ph_r), f32p(ph_i), f32p(tail_r), f32p(tail_i),
      f32p(tab), f32p(taps), out, N, layout, inv_scale, st);
}

extern "C" int sc_frontend_decim_folded(
    const void* pcm, const void* p0r, const void* p0i, const void* tail0_r,
    const void* tail0_i, const void* adv, const void* tab, const void* ctaps,
    const void* unrot, void* out, int B, int C, int out_bf16,
    float inv_scale, int f32_operands, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      (f32_operands ? launch_decim_folded<false> : launch_decim_folded<true>)(
          i16p(pcm), f32p(p0r), f32p(p0i), f32p(tail0_r), f32p(tail0_i),
          f32p(adv), f32p(tab), f32p(ctaps), f32p(unrot), out, B, C,
          out_bf16, inv_scale, st);
  return (int)err;
}

// layout as sc_frontend_rows.
extern "C" int sc_frontend_rows_folded(
    const void* pcm, const void* ph_r, const void* ph_i, const void* tail_r,
    const void* tail_i, const void* tab, const void* ctaps,
    const void* unrot, void* out, int N, int layout, float inv_scale,
    int f32_operands, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      (f32_operands ? launch_rows_folded<false> : launch_rows_folded<true>)(
          i16p(pcm), f32p(ph_r), f32p(ph_i), f32p(tail_r), f32p(tail_i),
          f32p(tab), f32p(ctaps), f32p(unrot), out, N, layout, inv_scale,
          st);
  return (int)err;
}

extern "C" int sc_frontend_full(const void* pcm, const void* ph_r,
                                const void* ph_i, const void* tail_r,
                                const void* tail_i, const void* tab,
                                const void* taps, void* out, int N,
                                float inv_scale, float gain, void* stream) {
  return (int)launch<FullSmem>(
      frontend_full_kernel, N, static_cast<cudaStream_t>(stream),
      static_cast<const int16_t*>(pcm), static_cast<const float*>(ph_r),
      static_cast<const float*>(ph_i), static_cast<const float*>(tail_r),
      static_cast<const float*>(tail_i), static_cast<const float*>(tab),
      static_cast<const float*>(taps), static_cast<float*>(out),
      (long long)N, inv_scale, gain);
}

// The front-ends' layout at this geometry, for reports: the block's
// shared bytes of the premix pair, the folded pair and the full-rate
// kernel (dynamic where past 48 KB), threads a block, blocks an SM.
extern "C" int sc_frontend_layout(int* out) {
  out[0] = (int)sizeof(PremixSmem);
  out[1] = (int)sizeof(FoldSmem);
  out[2] = (int)sizeof(FullSmem);
  out[3] = WIN_THREADS;
  out[4] = WIN_BLOCKS_SM;
  return 0;
}
