// The decode kernels: packet -> full decode, a warp per row, the CFO DFT
// by a block of rows.
//
// decode_packet is _decode_core of
// singlecarrier_tpu/ops/decode_pallas.py (:398-597): energy gate, CFO
// DFT (P x NFFT, f32; 128 x 512 at the reference numerology),
// derotation (cosf/sinf), LS train (sliding Gram, ridge, off-tap prior,
// unrolled L x L complex Cholesky), one guarded refit over the first R
// data symbols, decode, three guarded phase/frequency refines (Taylor
// cos/sin, small-angle ratio) and the descramble XOR, into slots 0..D+4
// of the packed [N, D + 8] f32 row of fused_rx.py:551-561.
//
// Three configuration knobs of the JAX kernel are template parameters
// of every decode kernel (KNOBS, a bit each), chosen by the entry point:
//
//   * KNOB_CFO16, cfg.cfo_dtype "bf16" (decode_pallas.py:429-437): the
//     DFT's operands chips * pn and the table are bf16 values (the
//     wrapper rounds the table); their products are exact in f32, so
//     the sums keep the f32 DFT's order and bits with one fused
//     multiply-add a term where the f32 DFT needs two instructions
//     (mac);
//   * KNOB_DIRECT, cfg.ls_gram "direct" (_gram_direct :206-221): the
//     Gram of both fits as L(L+1)/2 product-and-reduce pairs, in place
//     of the lag products and their prefix corrections;
//   * KNOB_BVMAT, cfg.ls_bvec "matmul" (_pn_bvec_band :140-155, _fit
//     :294-300): the train fit's b-vector b[i] = sum_u w[u] pn[u - i]
//     summed in ascending u, a lane a sum (JAX's band matmul without its
//     zero terms), in place of the lane-strided reduce.
//
// Three entry points differ only in how they fill the warp's packet:
//
//   * K3 extract_decode_kernel -- from the decim planes at the hunt's
//     (phase, lag): the phase select + barrel shift of
//     _hunt_decode_core (decode_pallas.py:884-911; a plain gather here),
//     as inlined in ops/fused_rx.py::_fused_rx_kernel_premix and in
//     _hunt_decode_decim_kernel (:933).  Writes lag, phase and peak to
//     slots D+5..D+7.
//   * decode_extract_kernel -- replaces _decode_extract_kernel (:1140):
//     from windows[n][phase][plane][lag + i] of the [N, cyc, 2, wp]
//     hunt windows, which already hold the eq_length//2 left pad.
//   * decode_packets_kernel -- replaces _decode_kernel (:370): straight
//     from the extracted packet planes pkt_r[n][i], pkt_i[n][i].
//   The last two leave slots D+5..D+7 zero.
//
// extract_gate_kernel is the gate stage of the same Pallas kernels
// (stage="gate", decode_pallas.py:417-427): K3's extraction narrowed to
// the 128 preamble chips the energy gate sums, read straight from the
// planes into registers, then the row zeroed except gated (D+3), energy
// (D+4) and the hunt's slots.  It takes no table and runs no decode.
//
// A block owns DEC_ROWS rows (8; 4 where 8 would not fit), a warp each:
// the 384-symbol packet planes sit in shared memory, per-symbol decode
// arrays in registers (symbol t = lane + 32 j; past 16 symbols a lane or
// 16 taps in local memory), and every reduction is a butterfly whose result all
// lanes hold bit-equal, so the small solves run redundantly on every lane
// with no broadcast.
//
// The CFO DFT is the one stage the block runs together (cfo_dft_block):
// the P x NFFT f32 table (dft_r, dft_i: 512 KB at 128 x 512, more than L1
// holds) is walked in tiles of KC rows of k and the GB bins of a group
// (every bin in one group up to 512 bins, two groups at 1024, eight
// of 512 at 4096 bins; a ragged last group where 256 or 512 does not
// divide NFFT; groups of half as many bins in a block of 4 rows), copied
// into shared memory with cp.async, double-buffered, and each tile
// element is read from shared memory once for all the rows of the block.
// A thread keeps the four running sums of BPT bins x DEC_ROWS rows in
// registers; the rows' (chip * pn) operands are a small table in shared
// memory, read as broadcast 16-byte loads.  Every (row, bin) keeps its arithmetic: s1..s4
// in ascending k, each product rounded before its sum (-fmad=false), then
// sr = s1 - s2, si = s3 + s4 and the power, which the row's warp reads
// back for the first-maximum argmax and the parabola (from the tiles'
// place, or past 1024 bins from a region of its own).  So the table
// leaves L2 once per block, not once per row.
//
// Bound on the card: operations.  The CFO DFT is 128 x 512 x 4 f32
// multiply-adds per row, two instructions each without contraction; the
// rest is ~50 warp reductions per row, three small solves and a
// cosf/sinf pair per packet sample.  The DFT runs at that f32 rate; the
// stages after it are the larger part of the kernel's time.
//
// With -DSC_STAGE_CLOCKS lane 0 of every warp adds the clock64() ticks
// it spent in each stage to sc_stage_cycles (read by
// sc_decode_stage_cycles); without it the stamps compile to nothing.
#include <cuda_pipeline_primitives.h>

#include "common.cuh"

using namespace sc;

namespace {

constexpr int GATE_WARPS = 4;              // rows per block of the gate stage
// symbols per lane: the data symbols, and at least the P chips the
// train fit runs over
constexpr int MAXJ = imax((D + 31) / 32, P / 32);
// The loops over a lane's symbols (t = lane + 32 j) unroll whole up to
// 16 symbols a lane (496 data symbols) and 16 taps.  Past that their
// arrays would not fit the registers anyway, and unrolled copies (47 of
// them, or 8 of a 32-tap inner loop) only lengthen the build: there they
// loop, their arrays in local memory.
constexpr int UJ = MAXJ <= 16 && L <= 16 ? MAXJ : 1;
constexpr int MSK_LEN = roundup(D, 4);     // the packets stay 16 B aligned
constexpr int BINS = NFFT / 32;            // DFT bins per lane (argmax)
// The DFT's bins go in groups of GB, BPT a thread: a group walks the
// table's tiles (its KC x GB part of them) with its sums in registers,
// and holds its powers there until the last group is done.  Where GB
// does not divide NFFT the last group is ragged: its threads past the
// last bin sum what the tile holds there and keep nothing.
constexpr int BPT = NFFT < 512 ? 1 : 2;
// Past 1024 bins the powers of the block's rows (128 KB at 4096 and 8
// rows) would not fit the table tiles, nor the registers: each group
// writes its powers to a region of their own (after the LS warps), and a
// tile holds 2 rows of k, not 4.
constexpr bool PW_SEPARATE = NFFT > 1024;
constexpr int KC = PW_SEPARATE ? 2 : 4;    // table rows of k per tile
constexpr bool LS_SMEM = L > 7;            // the LS solve in shared memory
// The block's dynamic shared bytes at `rows` rows (warps): BlockSmem's
// constants, packets, operand table and tiles, then the LS warps and the
// separate powers (the layout below; static_assert'ed against it).
constexpr unsigned dec_smem_at(int rows) {
  return 4u * (P + MSK_LEN + rows * 2 * PKT) + 8u * P * rows +
         16u * KC * rows * 32 * BPT +
         (LS_SMEM ? rows * 4u * (2 * L * L + 2 * L) : 0u) +
         (PW_SEPARATE ? rows * 4u * NFFT : 0u);
}
// A block owns 8 rows, or 4 where 8 rows' packets, LS warps and
// separate powers would pass the 227 KB a block may hold (long packets
// past 1024 bins): each (row, bin) and each row's decode keeps its
// arithmetic, only the table is read once for 4 rows and not 8.
constexpr int DEC_ROWS = dec_smem_at(8) <= 232448 ? 8 : 4;
constexpr int DEC_THREADS = DEC_ROWS * 32;
constexpr int GB = DEC_THREADS * BPT;      // bins of a group
constexpr int GROUPS = (NFFT + GB - 1) / GB;
constexpr bool GROUPS_RAGGED = NFFT % GB != 0;
constexpr int NCHUNK = P / KC;
constexpr int TILE_F = KC * GB;            // floats of one plane's tile
constexpr int N_STAGES = 8;                // stage clocks
constexpr unsigned FULL = 0xffffffffu;

// the decode kernels' knob bits (the KNOBS template parameter)
constexpr int KNOB_CFO16 = 1;              // cfo_dtype "bf16"
constexpr int KNOB_DIRECT = 2;             // ls_gram "direct"
constexpr int KNOB_BVMAT = 4;              // ls_bvec "matmul"
constexpr int GRAM_N = L * (L + 1) / 2;    // lower-triangle Gram entries

static_assert(NFFT % 32 == 0 && P % KC == 0, "DFT tiling");
static_assert(DEC_ROWS % 2 == 0, "operand table read two rows a load");
static_assert(TILE_F % (4 * DEC_THREADS) == 0, "16-byte copies a thread");

// ticks per stage, summed over the warps of every launch since the last
// reset: extraction, CFO DFT, CFO peak, derotation, train, refit, refine,
// descramble and output
__device__ unsigned long long sc_stage_cycles[N_STAGES];

struct StageClock {
#ifdef SC_STAGE_CLOCKS
  long long t;
  bool on;
  __device__ __forceinline__ void start(bool lane0) {
    on = lane0;
    t = clock64();
  }
  __device__ __forceinline__ void stamp(int stage) {
    if (on) {
      const long long now = clock64();
      atomicAdd(&sc_stage_cycles[stage], (unsigned long long)(now - t));
      t = now;
    }
  }
#else
  __device__ __forceinline__ void start(bool) {}
  __device__ __forceinline__ void stamp(int) {}
#endif
};

// Past 16 taps the LS solve and fits, and the decode around them, are
// compiled once each (a knob set) and called, not inlined into each of the
// 24 entry points (3 kernels x 8 knob sets): inlined, their unrolled L x L
// loops took a library's build to ten minutes at 32 taps.  Up to 16 taps
// they inline as before.
#if SC_L > 16
#define SC_LS_CALL __noinline__
#define SC_DECODE_CALL __noinline__
#else
#define SC_LS_CALL
#define SC_DECODE_CALL __forceinline__
#endif

struct Params {
  int refit_sym, refit_iters, refine_iters;
  float peak_gate, ls_reg, ls_offtap, ls_offtap_refit, cfo_scale, derot_k;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(FULL, v, o);
  return v;
}

struct Coef {
  float r[L], i[L];
};

// decode_pallas._solve_chol: A (lower triangle, Hermitian) x = b.
__device__ void solve_chol(float (&Ar)[L][L], float (&Ai)[L][L],
                           const float (&br)[L], const float (&bi)[L],
                           Coef& x) {
  float cr[L][L], ci[L][L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    float s = Ar[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k)
      s = s - (cr[j][k] * cr[j][k] + ci[j][k] * ci[j][k]);
    const float d = sqrtf(fmaxf(s, 1e-30f));
    cr[j][j] = d;
    ci[j][j] = 0.f;
    const float inv = 1.f / d;
#pragma unroll
    for (int i = j + 1; i < L; ++i) {
      float tr = Ar[i][j], ti = Ai[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) {
        tr = tr - (cr[i][k] * cr[j][k] + ci[i][k] * ci[j][k]);
        ti = ti - (ci[i][k] * cr[j][k] - cr[i][k] * ci[j][k]);
      }
      cr[i][j] = tr * inv;
      ci[i][j] = ti * inv;
    }
  }
  float yr[L], yi[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    float tr = br[i], ti = bi[i];
#pragma unroll
    for (int k = 0; k < i; ++k) {
      tr = tr - (cr[i][k] * yr[k] - ci[i][k] * yi[k]);
      ti = ti - (cr[i][k] * yi[k] + ci[i][k] * yr[k]);
    }
    const float inv = 1.f / cr[i][i];
    yr[i] = tr * inv;
    yi[i] = ti * inv;
  }
#pragma unroll
  for (int i = L - 1; i >= 0; --i) {
    float tr = yr[i], ti = yi[i];
#pragma unroll
    for (int k = i + 1; k < L; ++k) {
      tr = tr - (cr[k][i] * x.r[k] + ci[k][i] * x.i[k]);
      ti = ti - (cr[k][i] * x.i[k] - ci[k][i] * x.r[k]);
    }
    const float inv = 1.f / cr[i][i];
    x.r[i] = tr * inv;
    x.i[i] = ti * inv;
  }
}

// decode_pallas._fit: LS fit of sum_i coeff_i w[t+i] ~ target[t] over
// t < count, for the window planes (wr, wi) of length count + L - 1 in
// shared memory.  REAL: the target is pns[t] (the preamble); else
// (tr_, ti_)[j] for t = lane + 32 j.  The Gram is the sliding one (lag
// products g_d summed once, then corrected at the window's ends) or,
// DIRECT, every entry of the lower triangle summed on its own.  The
// b-vector is the reduce one (products summed a lane a stride, then
// across the warp) or, BVMAT (train fit: REAL), b[i] = sum_k w[i + k]
// pn[k] in ascending k, lane i (real) and lane L + i (imaginary, of
// -w_i) a sum, handed to every lane by a shuffle.
template <bool REAL, bool DIRECT, bool BVMAT>
__device__ void fit(const float* wr, const float* wi, int count,
                    const float* pns, const float (&tr_)[MAXJ],
                    const float (&ti_)[MAXJ], float reg, float offtap,
                    int lane, Coef& out) {
  static_assert(REAL || !BVMAT, "the matmul b-vector is the train fit's");
  float gr[L], gi[L], br[L], bi[L];
  float gd_r[GRAM_N], gd_i[GRAM_N];     // DIRECT: entry (i, j), j <= i
#pragma unroll
  for (int d = 0; d < L; ++d) gr[d] = gi[d] = br[d] = bi[d] = 0.f;
  if constexpr (DIRECT) {
#pragma unroll
    for (int e = 0; e < GRAM_N; ++e) gd_r[e] = gd_i[e] = 0.f;
  }
#pragma unroll (UJ)
  for (int j = 0; j < MAXJ; ++j) {
    const int u = lane + 32 * j;
    if (u < count) {
      if constexpr (DIRECT) {
        float s_r[L], s_i[L];
#pragma unroll
        for (int i = 0; i < L; ++i) s_r[i] = wr[u + i], s_i[i] = wi[u + i];
#pragma unroll
        for (int i = 0, e = 0; i < L; ++i)
#pragma unroll
          for (int k = 0; k <= i; ++k, ++e) {
            gd_r[e] = gd_r[e] + (s_r[i] * s_r[k] + s_i[i] * s_i[k]);
            if (k < i)        // the diagonal's imaginary part is 0
              gd_i[e] = gd_i[e] + (s_r[i] * s_i[k] - s_i[i] * s_r[k]);
          }
      } else {
        const float a_r = wr[u], a_i = wi[u];
#pragma unroll
        for (int d = 0; d < L; ++d) {
          const float b_r = wr[u + d], b_i = wi[u + d];
          gr[d] = gr[d] + (a_r * b_r + a_i * b_i);
          gi[d] = gi[d] + (a_r * b_i - a_i * b_r);
        }
      }
      if constexpr (!BVMAT) {
#pragma unroll
        for (int i = 0; i < L; ++i) {
          const float s_r = wr[u + i], s_i = wi[u + i];
          if (REAL) {
            const float t = pns[u];
            br[i] = br[i] + s_r * t;
            bi[i] = bi[i] + (-(s_i * t));
          } else {
            br[i] = br[i] + (s_r * tr_[j] + s_i * ti_[j]);
            bi[i] = bi[i] + (s_r * ti_[j] - s_i * tr_[j]);
          }
        }
      }
    }
  }
  float Ar[L][L], Ai[L][L], b_r[L], b_i[L];
  if constexpr (DIRECT) {
#pragma unroll
    for (int i = 0, e = 0; i < L; ++i)
#pragma unroll
      for (int k = 0; k <= i; ++k, ++e) {
        Ar[i][k] = warp_sum(gd_r[e]);
        Ai[i][k] = k < i ? warp_sum(gd_i[e]) : 0.f;
      }
  }
#pragma unroll
  for (int d = 0; d < L; ++d) {
    float s_r = 0.f, s_i = 0.f;
    if constexpr (!DIRECT) {
      s_r = warp_sum(gr[d]);
      s_i = warp_sum(gi[d]);
    }
    if constexpr (!BVMAT) {
      b_r[d] = warp_sum(br[d]);
      b_i[d] = warp_sum(bi[d]);
    }
    if constexpr (!DIRECT) {
      Ar[d][0] = s_r;
      Ai[d][0] = -s_i;
#pragma unroll
      for (int j = 1; j < L - d; ++j) {
        // g_d[u] = conj(w[u]) w[u+d] at u = j-1 (leaving) and count+j-1
        const int u0 = j - 1, u1 = count + j - 1;
        const float g0 = wr[u0] * wr[u0 + d] + wi[u0] * wi[u0 + d];
        const float g1 = wr[u1] * wr[u1 + d] + wi[u1] * wi[u1 + d];
        s_r = (s_r - g0) + g1;
        Ar[d + j][j] = s_r;
        const float h0 = wr[u0] * wi[u0 + d] - wi[u0] * wr[u0 + d];
        const float h1 = wr[u1] * wi[u1 + d] - wi[u1] * wr[u1 + d];
        s_i = (s_i - h0) + h1;
        Ai[d + j][j] = -s_i;
      }
    }
  }
  if constexpr (BVMAT) {
    float acc = 0.f;
    if (lane < 2 * L) {
      const int i = lane < L ? lane : lane - L;
      const float* w = lane < L ? wr : wi;
      const float sgn = lane < L ? 1.f : -1.f;
      for (int k = 0; k < P; ++k) acc = acc + (sgn * w[i + k]) * pns[k];
    }
#pragma unroll
    for (int i = 0; i < L; ++i) {
      b_r[i] = __shfl_sync(FULL, acc, i);
      b_i[i] = __shfl_sync(FULL, acc, L + i);
    }
  }
  float tr_mean = Ar[0][0];
#pragma unroll
  for (int i = 1; i < L; ++i) tr_mean = tr_mean + Ar[i][i];
  const float ridge_c = (reg * tr_mean) / (float)L + 1e-12f;
  const float ridge_o = (offtap * tr_mean) / (float)L + 1e-12f;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    Ar[i][i] = Ar[i][i] + (i == L / 2 ? ridge_c : ridge_o);
    Ai[i][i] = 0.f;
  }
  solve_chol(Ar, Ai, b_r, b_i, out);
}

// Count of preamble sign matches of Re(apply(window, coef)) over P.
__device__ float matches_of(const float* wr, const float* wi, const Coef& c,
                            const float* pns, int lane) {
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < P / 32; ++j) {
    const int t = lane + 32 * j;
    float ar = 0.f;
#pragma unroll
    for (int i = 0; i < L; ++i)
      ar = (ar + c.r[i] * wr[t + i]) - c.i[i] * wi[t + i];
    m = m + (ar * pns[t] > 0.f ? 1.f : 0.f);
  }
  return warp_sum(m);
}

// apply: raw[t] = sum_i coef_i w[t+i] for t = lane + 32 j < count.
__device__ __forceinline__ void apply(const float* wr, const float* wi,
                                      const Coef& c, int count, int lane,
                                      float (&ar)[MAXJ], float (&ai)[MAXJ]) {
#pragma unroll (UJ)
  for (int j = 0; j < MAXJ; ++j) {
    const int t = lane + 32 * j;
    float r = 0.f, m = 0.f;
    if (t < count) {
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const float w_r = wr[t + i], w_i = wi[t + i];
        r = (r + c.r[i] * w_r) - c.i[i] * w_i;
        m = (m + c.r[i] * w_i) + c.i[i] * w_r;
      }
    }
    ar[j] = r;
    ai[j] = m;
  }
}

// decode_pallas._slice_hard: QPSK decisions in the raw domain.
__device__ __forceinline__ void slice_hard(float ar, float ai, float& dib,
                                           float& hr, float& hh) {
  const bool ib = (ar - ai) < 0.f, qb = (ar + ai) < 0.f;
  const float hi = ib ? -1.f : 1.f, hq = qb ? -1.f : 1.f;
  hr = 0.5f * (hi + hq);
  hh = 0.5f * (hq - hi);
  dib = (ib ? 1.f : 0.f) * 2.f + (qb ? 1.f : 0.f);
}

// decode_pallas._cossin_small: Taylor cos/sin for |x| <= ~0.8 rad.
__device__ __forceinline__ void cossin_small(float x, float& c, float& s) {
  const float x2 = x * x;
  c = 1.f + x2 * (-0.5f + x2 * (float)(1.0 / 24.0));
  s = x * (1.f + x2 * ((float)(-1.0 / 6.0) + x2 * (float)(1.0 / 120.0)));
}

// The refine guard metric (_derr): D * mean decision distance of the
// amplitude-normalized symbols, and their hard decisions.
__device__ float derr(const float (&xr)[MAXJ], const float (&xi)[MAXJ],
                      float (&dib)[MAXJ], float (&hr)[MAXJ],
                      float (&hh)[MAXJ], int lane) {
  float mg = 0.f;
#pragma unroll (UJ)
  for (int j = 0; j < MAXJ; ++j) {
    slice_hard(xr[j], xi[j], dib[j], hr[j], hh[j]);
    if (lane + 32 * j < D) mg = mg + sqrtf(xr[j] * xr[j] + xi[j] * xi[j]);
  }
  mg = warp_sum(mg) / (float)D + 1e-9f;
  float e = 0.f;
#pragma unroll (UJ)
  for (int j = 0; j < MAXJ; ++j) {
    if (lane + 32 * j < D) {
      const float er = xr[j] / mg - hr[j];
      const float ei = xi[j] / mg - hh[j];
      e = e + sqrtf(er * er + ei * ei);
    }
  }
  return warp_sum(e);
}

// s + a b, the DFT's multiply-add.  Fused only where both operands are
// bf16 values (EXACT: cfg.cfo_dtype "bf16"): their product has at most 16
// significant bits and is exact in f32, so fmaf(a, b, s) = round(s + a b)
// = s + round(a b), the unfused sum's bits in one instruction.  The f32
// DFT's products are not exact: there each is rounded before its sum
// (-fmad=false), as the plain version rounds them.
template <bool EXACT>
__device__ __forceinline__ float mac(float s, float a, float b) {
  if constexpr (EXACT) return __fmaf_rn(a, b, s);
  return s + a * b;
}

// The block's dynamic shared memory (every member 16-byte aligned).
struct BlockSmem {
  float pns[P];
  float msk[MSK_LEN];
  float pkt[DEC_ROWS][2][PKT];     // each row's packet planes
  float2 ttab[P][DEC_ROWS];        // (chip k * pn[k]) of each row, (re, im)
  float tile[2][2][TILE_F];        // [buffer][dft_r | dft_i][KC][GB];
                                   // after the DFT: the power [row][NFFT]
                                   // (up to 1024 bins, dft_powers)
};
static_assert(sizeof(float) * (P + MSK_LEN) % 16 == 0, "pkt stays aligned");
static_assert(PW_SEPARATE || 2 * 2 * TILE_F >= DEC_ROWS * NFFT,
              "the power fits the tiles");
static_assert(L <= 32, "solve_chol_smem gives lane i row i of the factor");

// ---- the LS solve above 7 taps, in shared memory ----
//
// Past 7 taps each lane's copies of the Gram and of its Cholesky factor
// (2 L^2 floats each, the same on every lane) would not fit the register
// file.  There each warp keeps one copy in shared memory (LsWarp, after
// BlockSmem in the block's dynamic shared memory): the Gram's and the
// b-vector's sums are formed an entry at a time, each in fit's order (its
// lane's terms in ascending j, then the butterfly), and the factor a
// column at a time, lane i forming row i's entry in solve_chol's order.
// So every element has the bits fit and solve_chol give it, and up to 7
// taps they run as they are.

struct LsWarp {
  float ar[L][L], ai[L][L];   // the Gram's lower triangle, then its factor
  float br[L], bi[L];         // the b-vector
};

// the block's dynamic shared memory: BlockSmem, then (LS_SMEM) a LsWarp
// a warp, then (PW_SEPARATE) the DFT powers [DEC_ROWS][NFFT]
constexpr unsigned PW_OFFSET =
    sizeof(BlockSmem) + (LS_SMEM ? DEC_ROWS * sizeof(LsWarp) : 0);
constexpr unsigned DEC_SMEM =
    PW_OFFSET + (PW_SEPARATE ? DEC_ROWS * NFFT * sizeof(float) : 0);
static_assert(DEC_SMEM == dec_smem_at(DEC_ROWS) && DEC_SMEM <= 232448,
              "a block's 227 KB of shared memory");

// the DFT powers of the block's rows, [DEC_ROWS][NFFT]: in the table
// tiles once they are done, or past 1024 bins in their own region
__device__ __forceinline__ float* dft_powers(BlockSmem& sm) {
  if constexpr (PW_SEPARATE) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    return reinterpret_cast<float*>(smem_raw + PW_OFFSET);
  } else {
    return &sm.tile[0][0][0];
  }
}

__device__ __forceinline__ LsWarp& ls_warp() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<LsWarp*>(smem_raw +
                                   sizeof(BlockSmem))[threadIdx.x >> 5];
}

// solve_chol on the warp's ls: the factor over the Gram's lower triangle
// in place, then both substitutions on every lane, into x.
__device__ SC_LS_CALL void solve_chol_smem(LsWarp& ls, int lane, Coef& x) {
#pragma unroll 1
  for (int j = 0; j < L; ++j) {
    float s = ls.ar[j][j];
    for (int k = 0; k < j; ++k)
      s = s - (ls.ar[j][k] * ls.ar[j][k] + ls.ai[j][k] * ls.ai[j][k]);
    const float d = sqrtf(fmaxf(s, 1e-30f));
    const float inv = 1.f / d;
    const int i = lane;                 // row i of column j
    if (i > j && i < L) {
      float tr = ls.ar[i][j], ti = ls.ai[i][j];
      for (int k = 0; k < j; ++k) {
        tr = tr - (ls.ar[i][k] * ls.ar[j][k] + ls.ai[i][k] * ls.ai[j][k]);
        ti = ti - (ls.ai[i][k] * ls.ar[j][k] - ls.ar[i][k] * ls.ai[j][k]);
      }
      ls.ar[i][j] = tr * inv;
      ls.ai[i][j] = ti * inv;
    }
    __syncwarp();                       // every lane has read ls.ar[j][j]
    if (lane == 0) {
      ls.ar[j][j] = d;
      ls.ai[j][j] = 0.f;
    }
    __syncwarp();
  }
  float yr[L], yi[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    float tr = ls.br[i], ti = ls.bi[i];
#pragma unroll
    for (int k = 0; k < i; ++k) {
      tr = tr - (ls.ar[i][k] * yr[k] - ls.ai[i][k] * yi[k]);
      ti = ti - (ls.ar[i][k] * yi[k] + ls.ai[i][k] * yr[k]);
    }
    const float inv = 1.f / ls.ar[i][i];
    yr[i] = tr * inv;
    yi[i] = ti * inv;
  }
#pragma unroll
  for (int i = L - 1; i >= 0; --i) {
    float tr = yr[i], ti = yi[i];
#pragma unroll
    for (int k = i + 1; k < L; ++k) {
      tr = tr - (ls.ar[k][i] * x.r[k] + ls.ai[k][i] * x.i[k]);
      ti = ti - (ls.ar[k][i] * x.i[k] - ls.ai[k][i] * x.r[k]);
    }
    const float inv = 1.f / ls.ar[i][i];
    x.r[i] = tr * inv;
    x.i[i] = ti * inv;
  }
  __syncwarp();                         // ls is free for the next fit
}

// fit with the Gram, the b-vector and the solve in the warp's ls.
template <bool REAL, bool DIRECT, bool BVMAT>
__device__ SC_LS_CALL void fit_smem(const float* wr, const float* wi,
                                    int count, const float* pns,
                                    const float (&tr_)[MAXJ],
                                    const float (&ti_)[MAXJ], float reg,
                                    float offtap, int lane, LsWarp& ls,
                                    Coef& out) {
  static_assert(REAL || !BVMAT, "the matmul b-vector is the train fit's");
  if constexpr (DIRECT) {
#pragma unroll 1
    for (int i = 0; i < L; ++i) {
#pragma unroll 1
      for (int k = 0; k <= i; ++k) {
        float gr = 0.f, gi = 0.f;
#pragma unroll (UJ)
        for (int j = 0; j < MAXJ; ++j) {
          const int u = lane + 32 * j;
          if (u < count) {
            const float ar = wr[u + i], ai = wi[u + i];
            const float br = wr[u + k], bi = wi[u + k];
            gr = gr + (ar * br + ai * bi);
            if (k < i)        // the diagonal's imaginary part is 0
              gi = gi + (ar * bi - ai * br);
          }
        }
        gr = warp_sum(gr);
        gi = k < i ? warp_sum(gi) : 0.f;
        if (lane == 0) {
          ls.ar[i][k] = gr;
          ls.ai[i][k] = gi;
        }
      }
    }
  } else {
#pragma unroll 1
    for (int d = 0; d < L; ++d) {
      float gr = 0.f, gi = 0.f;
#pragma unroll (UJ)
      for (int j = 0; j < MAXJ; ++j) {
        const int u = lane + 32 * j;
        if (u < count) {
          const float a_r = wr[u], a_i = wi[u];
          const float b_r = wr[u + d], b_i = wi[u + d];
          gr = gr + (a_r * b_r + a_i * b_i);
          gi = gi + (a_r * b_i - a_i * b_r);
        }
      }
      float s_r = warp_sum(gr), s_i = warp_sum(gi);
      if (lane == 0) {
        ls.ar[d][0] = s_r;
        ls.ai[d][0] = -s_i;
      }
      for (int j = 1; j < L - d; ++j) {
        // g_d[u] = conj(w[u]) w[u+d] at u = j-1 (leaving) and count+j-1
        const int u0 = j - 1, u1 = count + j - 1;
        const float g0 = wr[u0] * wr[u0 + d] + wi[u0] * wi[u0 + d];
        const float g1 = wr[u1] * wr[u1 + d] + wi[u1] * wi[u1 + d];
        s_r = (s_r - g0) + g1;
        const float h0 = wr[u0] * wi[u0 + d] - wi[u0] * wr[u0 + d];
        const float h1 = wr[u1] * wi[u1 + d] - wi[u1] * wr[u1 + d];
        s_i = (s_i - h0) + h1;
        if (lane == 0) {
          ls.ar[d + j][j] = s_r;
          ls.ai[d + j][j] = -s_i;
        }
      }
    }
  }
  if constexpr (BVMAT) {
    // sum s = lane + 32 h of the 2 L (b_r[s], or past L b_i[s - L]): a
    // lane forms one up to 16 taps, two past
#pragma unroll
    for (int h = 0; h < (2 * L + 31) / 32; ++h) {
      const int s = lane + 32 * h;
      float acc = 0.f;
      if (s < 2 * L) {
        const int i = s < L ? s : s - L;
        const float* w = s < L ? wr : wi;
        const float sgn = s < L ? 1.f : -1.f;
        for (int k = 0; k < P; ++k) acc = acc + (sgn * w[i + k]) * pns[k];
        (s < L ? ls.br[i] : ls.bi[i]) = acc;
      }
    }
  } else {
#pragma unroll 1
    for (int i = 0; i < L; ++i) {
      float br = 0.f, bi = 0.f;
#pragma unroll (UJ)
      for (int j = 0; j < MAXJ; ++j) {
        const int u = lane + 32 * j;
        if (u < count) {
          const float s_r = wr[u + i], s_i = wi[u + i];
          if (REAL) {
            const float t = pns[u];
            br = br + s_r * t;
            bi = bi + (-(s_i * t));
          } else {
            br = br + (s_r * tr_[j] + s_i * ti_[j]);
            bi = bi + (s_r * ti_[j] - s_i * tr_[j]);
          }
        }
      }
      br = warp_sum(br);
      bi = warp_sum(bi);
      if (lane == 0) {
        ls.br[i] = br;
        ls.bi[i] = bi;
      }
    }
  }
  __syncwarp();                         // the Gram and b are whole
  float tr_mean = ls.ar[0][0];
  for (int i = 1; i < L; ++i) tr_mean = tr_mean + ls.ar[i][i];
  const float ridge_c = (reg * tr_mean) / (float)L + 1e-12f;
  const float ridge_o = (offtap * tr_mean) / (float)L + 1e-12f;
  __syncwarp();                         // every lane has read the diagonal
  if (lane < L) {
    ls.ar[lane][lane] =
        ls.ar[lane][lane] + (lane == L / 2 ? ridge_c : ridge_o);
    ls.ai[lane][lane] = 0.f;
  }
  __syncwarp();
  solve_chol_smem(ls, lane, out);
}

// Tile (group, chunk): table rows KC chunk .. + KC - 1, the group's GB
// columns of each (one contiguous run where one group is every bin).
__device__ __forceinline__ void load_tile(BlockSmem& sm, int buf, int group,
                                          int chunk,
                                          const float* __restrict__ dft_r,
                                          const float* __restrict__ dft_i) {
  for (int i = 4 * threadIdx.x; i < TILE_F; i += 4 * DEC_THREADS) {
    const int k = i / GB, col = i - k * GB;
    if constexpr (GROUPS_RAGGED)
      if (group * GB + col >= NFFT) continue;    // past the last bin
    const int src = (chunk * KC + k) * NFFT + group * GB + col;
    __pipeline_memcpy_async(&sm.tile[buf][0][i], dft_r + src, 16);
    __pipeline_memcpy_async(&sm.tile[buf][1][i], dft_i + src, 16);
  }
  __pipeline_commit();
}

// The CFO DFT of the block's rows, run by all its threads: the power
// |(chips * pn) x DFT|^2 of every (row, bin) into dft_powers (as
// [DEC_ROWS][NFFT]).  Every warp has filled its packet (zeros for a row
// past the last); on return the power is visible to the whole block.
// CFO16: the operands chips * pn are rounded to bf16 (the table arrives
// rounded), so every product is exact and the sums are the f32 DFT's.
template <bool CFO16>
__device__ __forceinline__ void cfo_dft_block(
    BlockSmem& sm, const float* __restrict__ dft_r,
    const float* __restrict__ dft_i) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  load_tile(sm, 0, 0, 0, dft_r, dft_i);
  const float* pr = sm.pkt[warp][0];
  const float* pi = sm.pkt[warp][1];
  for (int k = lane; k < P; k += 32) {
    float tr = pr[OFF + k] * sm.pns[k], ti = pi[OFF + k] * sm.pns[k];
    if constexpr (CFO16) {
      tr = bf16_round(tr);
      ti = bf16_round(ti);
    }
    sm.ttab[k][warp] = make_float2(tr, ti);
  }
  // each group's powers (PW_SEPARATE: written as each group ends)
  float pwk[PW_SEPARATE ? 1 : GROUPS][DEC_ROWS][BPT];
  float* pw = dft_powers(sm);
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    float s1[DEC_ROWS][BPT], s2[DEC_ROWS][BPT], s3[DEC_ROWS][BPT],
        s4[DEC_ROWS][BPT];
#pragma unroll
    for (int r = 0; r < DEC_ROWS; ++r)
#pragma unroll
      for (int b = 0; b < BPT; ++b)
        s1[r][b] = s2[r][b] = s3[r][b] = s4[r][b] = 0.f;
    for (int ch = 0; ch < NCHUNK; ++ch) {
      const int it = g * NCHUNK + ch;      // tiles in the order loaded
      if (it + 1 < GROUPS * NCHUNK) {
        load_tile(sm, (it + 1) & 1, (it + 1) / NCHUNK, (it + 1) % NCHUNK,
                  dft_r, dft_i);
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();        // tile it (and, first, the operand table)
      const float* wr = sm.tile[it & 1][0] + tid;
      const float* wi = sm.tile[it & 1][1] + tid;
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        float r[BPT], m[BPT];
#pragma unroll
        for (int b = 0; b < BPT; ++b) {
          r[b] = wr[kk * GB + DEC_THREADS * b];
          m[b] = wi[kk * GB + DEC_THREADS * b];
        }
        const float4* t4 =
            reinterpret_cast<const float4*>(&sm.ttab[ch * KC + kk][0]);
#pragma unroll
        for (int rp = 0; rp < DEC_ROWS / 2; ++rp) {
          const float4 t = t4[rp];     // rows 2 rp and 2 rp + 1: (re, im)
#pragma unroll
          for (int b = 0; b < BPT; ++b) {
            s1[2 * rp][b] = mac<CFO16>(s1[2 * rp][b], t.x, r[b]);
            s2[2 * rp][b] = mac<CFO16>(s2[2 * rp][b], t.y, m[b]);
            s3[2 * rp][b] = mac<CFO16>(s3[2 * rp][b], t.x, m[b]);
            s4[2 * rp][b] = mac<CFO16>(s4[2 * rp][b], t.y, r[b]);
            s1[2 * rp + 1][b] = mac<CFO16>(s1[2 * rp + 1][b], t.z, r[b]);
            s2[2 * rp + 1][b] = mac<CFO16>(s2[2 * rp + 1][b], t.w, m[b]);
            s3[2 * rp + 1][b] = mac<CFO16>(s3[2 * rp + 1][b], t.z, m[b]);
            s4[2 * rp + 1][b] = mac<CFO16>(s4[2 * rp + 1][b], t.w, r[b]);
          }
        }
      }
      __syncthreads();        // the buffer may be filled again
    }
#pragma unroll
    for (int r = 0; r < DEC_ROWS; ++r)
#pragma unroll
      for (int b = 0; b < BPT; ++b) {
        const float sr = s1[r][b] - s2[r][b], si = s3[r][b] + s4[r][b];
        const float p = sr * sr + si * si;
        if constexpr (PW_SEPARATE) {
          const int bin = g * GB + tid + DEC_THREADS * b;
          if (!GROUPS_RAGGED || bin < NFFT) pw[r * NFFT + bin] = p;
        } else {
          pwk[g][r][b] = p;
        }
      }
  }
  if constexpr (!PW_SEPARATE) {
#pragma unroll
    for (int g = 0; g < GROUPS; ++g)
#pragma unroll
      for (int r = 0; r < DEC_ROWS; ++r)
#pragma unroll
        for (int b = 0; b < BPT; ++b) {
          const int bin = g * GB + tid + DEC_THREADS * b;
          if (!GROUPS_RAGGED || bin < NFFT) pw[r * NFFT + bin] = pwk[g][r][b];
        }
  }
  __syncthreads();
}

// _decode_core on the warp's packet after the block's CFO DFT (pr, pi:
// PKT f32 each in shared memory, first chip at OFF; pwf: the row's NFFT
// DFT powers).  Writes slots 0..D+4 of the output row o.
template <int KNOBS>
__device__ SC_DECODE_CALL void decode_packet(
    float* pr, float* pi, const float* pwf, const float* pns,
    const float* msk, float peak, const Params& prm, int lane, float* o,
    StageClock& clk) {
  // ---- energy gate ----
  float e = 0.f;
#pragma unroll
  for (int j = 0; j < P / 32; ++j) {
    const float a = pr[OFF + lane + 32 * j], b = pi[OFF + lane + 32 * j];
    e = e + (a * a + b * b);
  }
  const float energy = warp_sum(e);
  const bool gated = peak > energy * prm.peak_gate;

  // ---- CFO: first-max argmax of the DFT power, parabolic peak ----
  float bv = -1.f;
  int bi = 0;
#pragma unroll
  for (int q = 0; q < BINS; ++q) {
    const float p = pwf[lane + 32 * q];
    if (p > bv) {
      bv = p;
      bi = lane + 32 * q;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v = __shfl_xor_sync(FULL, bv, o);
    const int i = __shfl_xor_sync(FULL, bi, o);
    if (v > bv || (v == bv && i < bi)) {
      bv = v;
      bi = i;
    }
  }
  const float p0 = bv;
  const float pm = pwf[(bi + NFFT - 1) % NFFT];
  const float pp = pwf[(bi + 1) % NFFT];
  const float denom = (pm - 2.f * p0) + pp;
  const float delta = fabsf(denom) > 1e-20f ? (0.5f * (pm - pp)) / denom
                                            : 0.f;
  float kf = (float)bi + delta;
  if (kf > NFFT / 2.f) kf = kf - (float)NFFT;
  const float cfo = gated ? kf * prm.cfo_scale : 0.f;
  clk.stamp(2);

  // ---- de-rotate the packet (in place) ----
  const float kc = prm.derot_k * cfo;
  for (int i = lane; i < PKT; i += 32) {
    const float ang = kc * ((float)i - (float)OFF);
    const float rc = cosf(ang), rsn = sinf(ang);
    const float a = pr[i], b = pi[i];
    pr[i] = a * rc - b * rsn;
    pi[i] = a * rsn + b * rc;
  }
  __syncwarp();
  clk.stamp(3);

  // ---- LS train on the preamble ----
  const float zero[MAXJ] = {};
  Coef cf;
  constexpr bool DIRECT = (KNOBS & KNOB_DIRECT) != 0;
  if constexpr (LS_SMEM)
    fit_smem<true, DIRECT, (KNOBS & KNOB_BVMAT) != 0>(
        pr, pi, P, pns, zero, zero, prm.ls_reg, prm.ls_offtap, lane,
        ls_warp(), cf);
  else
    fit<true, DIRECT, (KNOBS & KNOB_BVMAT) != 0>(
        pr, pi, P, pns, zero, zero, prm.ls_reg, prm.ls_offtap, lane, cf);
  const float matches = matches_of(pr, pi, cf, pns, lane);
  clk.stamp(4);

  // ---- guarded decision-directed refit on the first R data symbols ----
  const int R = prm.refit_sym;
  const float* dr = pr + (OFF + P - L / 2);
  const float* di = pi + (OFF + P - L / 2);
  float ar[MAXJ], ai[MAXJ], dib[MAXJ], hr[MAXJ], hh[MAXJ];
  for (int it = 0; it < prm.refit_iters; ++it) {
    apply(dr, di, cf, R, lane, ar, ai);
    float mr = 0.f, mh = 0.f;
#pragma unroll (UJ)
    for (int j = 0; j < MAXJ; ++j) {
      slice_hard(ar[j], ai[j], dib[j], hr[j], hh[j]);
      if (lane + 32 * j < R) {
        mr = mr + sqrtf(ar[j] * ar[j] + ai[j] * ai[j]);
        mh = mh + sqrtf(hr[j] * hr[j] + hh[j] * hh[j]);
      }
    }
    const float mag_raw = warp_sum(mr) / (float)R;
    const float mag_h = warp_sum(mh) / (float)R + 1e-12f;
    const float scale = mag_raw / mag_h;
#pragma unroll (UJ)
    for (int j = 0; j < MAXJ; ++j) {
      hr[j] = hr[j] * scale;
      hh[j] = hh[j] * scale;
    }
    Coef c2;
    if constexpr (LS_SMEM)
      fit_smem<false, DIRECT, false>(dr, di, R, pns, hr, hh, 1e-3f,
                                     prm.ls_offtap_refit, lane, ls_warp(),
                                     c2);
    else
      fit<false, DIRECT, false>(dr, di, R, pns, hr, hh, 1e-3f,
                                prm.ls_offtap_refit, lane, c2);
    const float m2 = matches_of(pr, pi, c2, pns, lane);
    const float keep = m2 >= matches ? 1.f : 0.f;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      cf.r[i] = keep * c2.r[i] + (1.f - keep) * cf.r[i];
      cf.i[i] = keep * c2.i[i] + (1.f - keep) * cf.i[i];
    }
  }

  clk.stamp(5);

  // ---- decode + clamped guarded phase/frequency refinement ----
  apply(dr, di, cf, D, lane, ar, ai);
  const float a_max = (float)(3.14159265358979323846 / 8.0);
  const float b_max = (float)(3.14159265358979323846 / 8.0 / D);
  float cur_err = 0.f;
  if (prm.refine_iters) cur_err = derr(ar, ai, dib, hr, hh, lane);
  for (int it = 0; it < prm.refine_iters; ++it) {
    float zr[MAXJ], zi[MAXJ];
#pragma unroll (UJ)
    for (int j = 0; j < MAXJ; ++j) {
      zr[j] = ar[j] * hr[j] + ai[j] * hh[j];
      zi[j] = ai[j] * hr[j] - ar[j] * hh[j];
    }
    float incr = 0.f, inci = 0.f;
#pragma unroll (UJ)
    for (int j = 0; j < MAXJ; ++j) {
      // symbol t - 1 of t = lane + 32 j: lane - 1, or lane 31 of j - 1
      const float up_r = __shfl_up_sync(FULL, zr[j], 1);
      const float up_i = __shfl_up_sync(FULL, zi[j], 1);
      const float wr_ = __shfl_sync(FULL, zr[j > 0 ? j - 1 : 0], 31);
      const float wi_ = __shfl_sync(FULL, zi[j > 0 ? j - 1 : 0], 31);
      const float qr = lane ? up_r : wr_, qi = lane ? up_i : wi_;
      const int t = lane + 32 * j;
      if (t >= 1 && t < D) {
        incr = incr + (zr[j] * qr + zi[j] * qi);
        inci = inci + (zi[j] * qr - zr[j] * qi);
      }
    }
    incr = warp_sum(incr);
    inci = warp_sum(inci);
    const float b = fminf(fmaxf(inci / (fabsf(incr) + 1e-20f), -b_max),
                          b_max);
    float z0r = 0.f, z0i = 0.f;
#pragma unroll (UJ)
    for (int j = 0; j < MAXJ; ++j) {
      const int t = lane + 32 * j;
      float dc, dsn;
      cossin_small(-b * (float)t, dc, dsn);
      if (t < D) {
        z0r = z0r + (zr[j] * dc - zi[j] * dsn);
        z0i = z0i + (zr[j] * dsn + zi[j] * dc);
      }
    }
    z0r = warp_sum(z0r);
    z0i = warp_sum(z0i);
    const float a = fminf(fmaxf(z0i / (fabsf(z0r) + 1e-20f), -a_max), a_max);
    float ar2[MAXJ], ai2[MAXJ], dib2[MAXJ], hr2[MAXJ], hh2[MAXJ];
#pragma unroll (UJ)
    for (int j = 0; j < MAXJ; ++j) {
      float c2, s2;
      cossin_small(-a - b * (float)(lane + 32 * j), c2, s2);
      ar2[j] = ar[j] * c2 - ai[j] * s2;
      ai2[j] = ar[j] * s2 + ai[j] * c2;
    }
    const float new_err = derr(ar2, ai2, dib2, hr2, hh2, lane);
    const float keep = new_err <= cur_err ? 1.f : 0.f;
    cur_err = keep * new_err + (1.f - keep) * cur_err;
#pragma unroll (UJ)
    for (int j = 0; j < MAXJ; ++j) {
      ar[j] = keep * ar2[j] + (1.f - keep) * ar[j];
      ai[j] = keep * ai2[j] + (1.f - keep) * ai[j];
      dib[j] = keep * dib2[j] + (1.f - keep) * dib[j];
      hr[j] = keep * hr2[j] + (1.f - keep) * hr[j];
      hh[j] = keep * hh2[j] + (1.f - keep) * hh[j];
    }
  }
  float eq_err;
  if (prm.refine_iters) {
    eq_err = cur_err * (float)(1.0 / D);
  } else {
    float mg = 0.f;
#pragma unroll (UJ)
    for (int j = 0; j < MAXJ; ++j) {
      slice_hard(ar[j], ai[j], dib[j], hr[j], hh[j]);
      if (lane + 32 * j < D) mg = mg + sqrtf(ar[j] * ar[j] + ai[j] * ai[j]);
    }
    mg = warp_sum(mg) / (float)D + 1e-9f;
    float s = 0.f;
#pragma unroll (UJ)
    for (int j = 0; j < MAXJ; ++j) {
      if (lane + 32 * j < D) {
        const float er = ar[j] / mg - hr[j], ei = ai[j] / mg - hh[j];
        s = s + sqrtf(er * er + ei * ei);
      }
    }
    eq_err = warp_sum(s) / (float)D;
  }

  clk.stamp(6);

  // ---- descramble (XOR of {0..3} dibits) + packed output row ----
#pragma unroll (UJ)
  for (int j = 0; j < MAXJ; ++j) {
    const int t = lane + 32 * j;
    if (t < D) {
      const int dd = (int)dib[j], mm = (int)msk[t];
      o[t] = (float)(((dd / 2 + mm / 2) % 2) * 2 + (dd % 2 + mm % 2) % 2);
    }
  }
  if (lane == 0) {
    o[D] = matches;
    o[D + 1] = eq_err;
    o[D + 2] = cfo;
    o[D + 3] = gated ? 1.f : 0.f;
    o[D + 4] = energy;
  }
  clk.stamp(7);
}

// Block prologue shared by the entry points: the PN and descramble
// tables on their way into shared memory (SC_DECODE_BODY's barrier makes
// them visible), then this warp's row n, packet planes and output row.
// A warp past the last row stays (the block runs the CFO DFT together)
// with a zero packet.
#define SC_DECODE_PROLOGUE()                                              \
  extern __shared__ __align__(16) unsigned char smem_raw[];               \
  BlockSmem& sm = *reinterpret_cast<BlockSmem*>(smem_raw);                \
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;             \
  StageClock clk;                                                         \
  clk.start(lane == 0);                                                   \
  for (int i = threadIdx.x; i < P; i += blockDim.x) sm.pns[i] = pn[i];    \
  for (int i = threadIdx.x; i < D; i += blockDim.x) sm.msk[i] = mask[i];  \
  const long long n = (long long)blockIdx.x * DEC_ROWS + warp;            \
  const bool live = n < N;                                                \
  float* pr = sm.pkt[warp][0];                                            \
  float* pi = sm.pkt[warp][1];                                            \
  if (!live)                                                              \
    for (int i = lane; i < PKT; i += 32) pr[i] = pi[i] = 0.f

// The rest of every entry point: the block's CFO DFT, then each live
// warp's decode of its row.
#define SC_DECODE_BODY(peak)                                              \
  __syncthreads();              /* the tables and every row's packet */   \
  clk.stamp(0);                                                           \
  cfo_dft_block<(KNOBS & KNOB_CFO16) != 0>(sm, dft_r, dft_i);            \
  clk.stamp(1);                                                           \
  if (!live) return;                                                      \
  float* o = out + n * N_OUT;                                             \
  decode_packet<KNOBS>(pr, pi, dft_powers(sm) + warp * NFFT, sm.pns,     \
                       sm.msk, peak, prm, lane, o, clk)

__device__ __forceinline__ void write_tail(float* o, int lane, float lag,
                                           float ph, float peak) {
  if (lane == 0) {
    o[D + 5] = lag;
    o[D + 6] = ph;
    o[D + 7] = peak;
  }
}

template <int KNOBS>
__global__ void __launch_bounds__(DEC_THREADS) extract_decode_kernel(
    const void* __restrict__ decim, const void* __restrict__ dprev0,
    int in_bf16, const int* __restrict__ lag_in,
    const int* __restrict__ ph_in, const float* __restrict__ peak_in,
    const float* __restrict__ dft_r, const float* __restrict__ dft_i,
    const float* __restrict__ pn, const float* __restrict__ mask,
    float* __restrict__ out, long long N, int C, Params prm) {
  SC_DECODE_PROLOGUE();
  const int lag = live ? lag_in[n] : 0, ph = live ? ph_in[n] : 0;
  const float peak = live ? peak_in[n] : 0.f;
  // packet[i] = window[ph][lag + i]: the window is [OFF zeros | the
  // previous block's row | this block's row | zeros]
  if (live) {
    const long long cp = ph * 2;
    const long long prev_r = n < C ? (cp * C + n) * N_SYM
                                   : (cp * N + n - C) * N_SYM;
    const long long prev_i = n < C ? ((cp + 1) * C + n) * N_SYM
                                   : ((cp + 1) * N + n - C) * N_SYM;
    const void* prev = n < C ? dprev0 : decim;
    const long long cur_r = (cp * N + n) * N_SYM;
    const long long cur_i = ((cp + 1) * N + n) * N_SYM;
    for (int i = lane; i < PKT; i += 32) {
      const int j = lag + i - OFF;
      float a = 0.f, b = 0.f;
      if (j >= 0 && j < N_SYM) {
        a = load_plane(prev, prev_r + j, in_bf16);
        b = load_plane(prev, prev_i + j, in_bf16);
      } else if (j >= N_SYM && j < 2 * N_SYM) {
        a = load_plane(decim, cur_r + j - N_SYM, in_bf16);
        b = load_plane(decim, cur_i + j - N_SYM, in_bf16);
      }
      pr[i] = a;
      pi[i] = b;
    }
  }
  SC_DECODE_BODY(peak);
  write_tail(o, lane, (float)lag, (float)ph, peak);
}

// _decode_core stopped after its energy gate: chip k of the row's packet
// is window[ph][lag + OFF + k], summed in decode_packet's order.
__global__ void __launch_bounds__(GATE_WARPS * 32) extract_gate_kernel(
    const void* __restrict__ decim, const void* __restrict__ dprev0,
    int in_bf16, const int* __restrict__ lag_in,
    const int* __restrict__ ph_in, const float* __restrict__ peak_in,
    float* __restrict__ out, long long N, int C, float peak_gate) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n = (long long)blockIdx.x * GATE_WARPS + warp;
  if (n >= N) return;
  float* o = out + n * N_OUT;
  const int lag = lag_in[n], ph = ph_in[n];
  const float peak = peak_in[n];
  float e = 0.f;
#pragma unroll
  for (int j = 0; j < P / 32; ++j) {
    const int i = lag + OFF + lane + 32 * j;
    const float a = window_at(decim, dprev0, in_bf16, N, C, n, ph, 0, i);
    const float b = window_at(decim, dprev0, in_bf16, N, C, n, ph, 1, i);
    e = e + (a * a + b * b);
  }
  const float energy = warp_sum(e);
  const bool gated = peak > energy * peak_gate;
  for (int i = lane; i < D + 5; i += 32)
    o[i] = i == D + 3 ? (gated ? 1.f : 0.f) : i == D + 4 ? energy : 0.f;
  write_tail(o, lane, (float)lag, (float)ph, peak);
}

template <int KNOBS>
__global__ void __launch_bounds__(DEC_THREADS) decode_extract_kernel(
    const float* __restrict__ windows, int wp,
    const int* __restrict__ lag_in, const int* __restrict__ ph_in,
    const float* __restrict__ peak_in, const float* __restrict__ dft_r,
    const float* __restrict__ dft_i, const float* __restrict__ pn,
    const float* __restrict__ mask, float* __restrict__ out, long long N,
    Params prm) {
  SC_DECODE_PROLOGUE();
  if (live) {
    const int lag = lag_in[n], ph = ph_in[n];
    // packet[i] = windows[n][ph][plane][lag + i]; zero past the window
    const float* wr = windows + ((n * CYC + ph) * 2) * (long long)wp;
    const float* wi = wr + wp;
    for (int i = lane; i < PKT; i += 32) {
      const int j = lag + i;
      pr[i] = j < wp ? wr[j] : 0.f;
      pi[i] = j < wp ? wi[j] : 0.f;
    }
  }
  SC_DECODE_BODY(peak_in[n]);
  write_tail(o, lane, 0.f, 0.f, 0.f);
}

template <int KNOBS>
__global__ void __launch_bounds__(DEC_THREADS) decode_packets_kernel(
    const float* __restrict__ pkt_r, const float* __restrict__ pkt_i,
    const float* __restrict__ peak_in, const float* __restrict__ dft_r,
    const float* __restrict__ dft_i, const float* __restrict__ pn,
    const float* __restrict__ mask, float* __restrict__ out, long long N,
    Params prm) {
  SC_DECODE_PROLOGUE();
  if (live)
    for (int i = lane; i < PKT; i += 32) {
      pr[i] = pkt_r[n * PKT + i];
      pi[i] = pkt_i[n * PKT + i];
    }
  SC_DECODE_BODY(peak_in[n]);
  write_tail(o, lane, 0.f, 0.f, 0.f);
}

}  // namespace

namespace {
unsigned decode_blocks(int N) {
  return (unsigned)((N + DEC_ROWS - 1) / DEC_ROWS);
}
const float* f32p(const void* p) { return static_cast<const float*>(p); }
const int* i32p(const void* p) { return static_cast<const int*>(p); }

// The KNOBS bits of the entry points' knob arguments.
int knob_bits(int cfo_bf16, int gram_direct, int bvec_matmul) {
  return (cfo_bf16 ? KNOB_CFO16 : 0) | (gram_direct ? KNOB_DIRECT : 0) |
         (bvec_matmul ? KNOB_BVMAT : 0);
}

// Calls F::template run<KNOBS>() for the runtime knob bits.
template <class F>
cudaError_t with_knobs(int knobs, F f) {
  switch (knobs) {
    case 0: return f.template run<0>();
    case 1: return f.template run<1>();
    case 2: return f.template run<2>();
    case 3: return f.template run<3>();
    case 4: return f.template run<4>();
    case 5: return f.template run<5>();
    case 6: return f.template run<6>();
    default: return f.template run<7>();
  }
}

struct ExtractDecode {
  const void *decim, *dprev0, *lag, *phase, *peak, *dft_r, *dft_i, *pn,
      *mask;
  void* out;
  int N, C, in_bf16;
  Params prm;
  cudaStream_t st;
  template <int KNOBS>
  cudaError_t run() const {
    static const cudaError_t ready =
        allow_smem_bytes(extract_decode_kernel<KNOBS>, (int)DEC_SMEM);
    if (ready != cudaSuccess) return ready;
    extract_decode_kernel<KNOBS>
        <<<decode_blocks(N), DEC_THREADS, DEC_SMEM, st>>>(
            decim, dprev0, in_bf16, i32p(lag), i32p(phase), f32p(peak),
            f32p(dft_r), f32p(dft_i), f32p(pn), f32p(mask),
            static_cast<float*>(out), (long long)N, C, prm);
    return cudaGetLastError();
  }
};

struct DecodeExtract {
  const void *windows, *lag, *phase, *peak, *dft_r, *dft_i, *pn, *mask;
  void* out;
  int N, wp;
  Params prm;
  cudaStream_t st;
  template <int KNOBS>
  cudaError_t run() const {
    static const cudaError_t ready =
        allow_smem_bytes(decode_extract_kernel<KNOBS>, (int)DEC_SMEM);
    if (ready != cudaSuccess) return ready;
    decode_extract_kernel<KNOBS>
        <<<decode_blocks(N), DEC_THREADS, DEC_SMEM, st>>>(
            f32p(windows), wp, i32p(lag), i32p(phase), f32p(peak),
            f32p(dft_r), f32p(dft_i), f32p(pn), f32p(mask),
            static_cast<float*>(out), (long long)N, prm);
    return cudaGetLastError();
  }
};

struct DecodePackets {
  const void *pkt_r, *pkt_i, *peak, *dft_r, *dft_i, *pn, *mask;
  void* out;
  int N;
  Params prm;
  cudaStream_t st;
  template <int KNOBS>
  cudaError_t run() const {
    static const cudaError_t ready =
        allow_smem_bytes(decode_packets_kernel<KNOBS>, (int)DEC_SMEM);
    if (ready != cudaSuccess) return ready;
    decode_packets_kernel<KNOBS>
        <<<decode_blocks(N), DEC_THREADS, DEC_SMEM, st>>>(
            f32p(pkt_r), f32p(pkt_i), f32p(peak), f32p(dft_r), f32p(dft_i),
            f32p(pn), f32p(mask), static_cast<float*>(out), (long long)N,
            prm);
    return cudaGetLastError();
  }
};
}  // namespace

// The decode entry points' last three ints before the stream are the
// knobs: cfo_bf16 (cfg.cfo_dtype "bf16"), gram_direct (cfg.ls_gram
// "direct"), bvec_matmul (cfg.ls_bvec "matmul").
extern "C" int sc_extract_decode(
    const void* decim, const void* dprev0, const void* lag,
    const void* phase, const void* peak, const void* dft_r,
    const void* dft_i, const void* pn, const void* mask, void* out, int N,
    int C, int in_bf16, int refit_sym, int refit_iters, int refine_iters,
    float peak_gate, float ls_reg, float ls_offtap, float ls_offtap_refit,
    float cfo_scale, float derot_k, int cfo_bf16, int gram_direct,
    int bvec_matmul, void* stream) {
  const Params prm{refit_sym, refit_iters, refine_iters, peak_gate,
                   ls_reg, ls_offtap, ls_offtap_refit, cfo_scale, derot_k};
  return (int)with_knobs(
      knob_bits(cfo_bf16, gram_direct, bvec_matmul),
      ExtractDecode{decim, dprev0, lag, phase, peak, dft_r, dft_i, pn, mask,
                    out, N, C, in_bf16, prm,
                    static_cast<cudaStream_t>(stream)});
}

// The gate stage of sc_extract_decode: the same planes, hunt results and
// packed rows, and of the decode's operands only peak_gate.
extern "C" int sc_extract_gate(
    const void* decim, const void* dprev0, const void* lag,
    const void* phase, const void* peak, void* out, int N, int C,
    int in_bf16, float peak_gate, void* stream) {
  extract_gate_kernel<<<(unsigned)((N + GATE_WARPS - 1) / GATE_WARPS),
                        GATE_WARPS * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      decim, dprev0, in_bf16, i32p(lag), i32p(phase), f32p(peak),
      static_cast<float*>(out), (long long)N, C, peak_gate);
  return (int)cudaGetLastError();
}

extern "C" int sc_decode_extract(
    const void* windows, const void* lag, const void* phase,
    const void* peak, const void* dft_r, const void* dft_i, const void* pn,
    const void* mask, void* out, int N, int wp, int refit_sym,
    int refit_iters, int refine_iters, float peak_gate, float ls_reg,
    float ls_offtap, float ls_offtap_refit, float cfo_scale, float derot_k,
    int cfo_bf16, int gram_direct, int bvec_matmul, void* stream) {
  const Params prm{refit_sym, refit_iters, refine_iters, peak_gate,
                   ls_reg, ls_offtap, ls_offtap_refit, cfo_scale, derot_k};
  return (int)with_knobs(
      knob_bits(cfo_bf16, gram_direct, bvec_matmul),
      DecodeExtract{windows, lag, phase, peak, dft_r, dft_i, pn, mask, out,
                    N, wp, prm, static_cast<cudaStream_t>(stream)});
}

extern "C" int sc_decode_packets(
    const void* pkt_r, const void* pkt_i, const void* peak,
    const void* dft_r, const void* dft_i, const void* pn, const void* mask,
    void* out, int N, int refit_sym, int refit_iters, int refine_iters,
    float peak_gate, float ls_reg, float ls_offtap, float ls_offtap_refit,
    float cfo_scale, float derot_k, int cfo_bf16, int gram_direct,
    int bvec_matmul, void* stream) {
  const Params prm{refit_sym, refit_iters, refine_iters, peak_gate,
                   ls_reg, ls_offtap, ls_offtap_refit, cfo_scale, derot_k};
  return (int)with_knobs(
      knob_bits(cfo_bf16, gram_direct, bvec_matmul),
      DecodePackets{pkt_r, pkt_i, peak, dft_r, dft_i, pn, mask, out, N,
                    prm, static_cast<cudaStream_t>(stream)});
}

// Copies the stage clocks (N_STAGES 64-bit tick sums, zero unless built
// with -DSC_STAGE_CLOCKS) to host memory after the stream's work, and
// clears them if ``reset``.
extern "C" int sc_decode_stage_cycles(void* host_out, int reset,
                                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaStreamSynchronize(st);
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(host_out, sc_stage_cycles,
                               sizeof(sc_stage_cycles));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[N_STAGES] = {};
    err = cudaMemcpyToSymbol(sc_stage_cycles, zero, sizeof(zero));
  }
  return (int)err;
}

// The decode kernels' layout at this geometry, for reports: the block's
// dynamic shared bytes, rows (warps) a block, and whether the LS solve
// sits in shared memory (more than 7 taps).
extern "C" int sc_decode_layout(int* out) {
  out[0] = (int)DEC_SMEM;
  out[1] = DEC_ROWS;
  out[2] = LS_SMEM ? 1 : 0;
  return 0;
}
