// K2 hunt: preamble hunt of every row's [prev | cur] window.
//
// Replaces the hunt of singlecarrier_tpu/ops/decode_pallas.py::
// _hunt_decode_core (decode_pallas.py:742-876), inlined in the Pallas
// kernel ops/fused_rx.py::_fused_rx_kernel_premix.  Per decimation phase
// c the window is turned into the hunt operand x (int8 mode:
// clip(rint(16 w), +/-127), round half to even as fused_rx.py:89-91;
// bf16 mode: bf16(w); f32 mode: w as it is); the NSEG segment
// correlations of lag l (8 of 16 chips at the reference; 1 to 16 of 128
// to 8 chips) are sum_k x[2 + l + SEG s + k] * pn[SEG s + k] (exact for
// int8, ascending k otherwise) and pw[c][l] = sum_s (re^2 + im^2), each
// square rounded to f32, added in f32 in ascending s.  The statistic is
// chosen by cfg.hunt_norm, a template parameter of both bodies
// (decode_pallas.py:818-878):
//
//   * espan (the default): the denominator is the direct 128-term sum of
//     the phase-summed squared planes (ascending phases, decode_pallas.py:
//     845-852) -- a direct sum, not a prefix-sum difference, whose
//     cancellation would move the noise-block knife edge;
//   * energy: the same direct sum over each phase's own squared planes,
//     en[c][l] = sum_k sq_c[l + k] in ascending k, cyc sums where espan
//     forms one;
//   * none: no denominator, the statistic is pw itself.
//
// stat = pw / (en + 1e-12) in IEEE division; argmax takes the first
// maximum over lags and a strict > across ascending phases
// (decode_pallas.py:856-876).  The peak is the raw power at the chosen
// lag in every mode.  NaN windows (a corrupted or restored state) follow
// the JAX kernel too: a phase whose statistic holds a NaN does not win
// (its per-phase max is NaN), a NaN quantises to 0 (XLA's cast), and a
// row whose every phase is skipped keeps the initial best: lag 0, phase
// 0, peak 2 (-1) scaled as any peak.
//
// Two bodies, chosen by the operand mode:
//
//   * int8 (hunt_mma_kernel): a warp owns a row.  The correlation is a
//     Toeplitz product on the tensor cores: y[t][s] = sum_k x[2 + t + k]
//     * pn[16s + k] for t = 0..495 is 31 tiles of
//     mma.sync.m16n8k16.s8 (M = 16 values of t, N = 8 segments, K = 16
//     chips), and segment s of lag l is y[l + 16s][s], so one pass over t
//     serves all 8 segments from the same 16 operand bytes.  The five
//     phases' two planes are quantised once into int8 in shared memory
//     (512 bytes a plane: the window past x[2 + 511] is never read) from
//     16-byte global loads, with the squared planes summed in registers
//     in the same pass.  A thread's A fragment (4 consecutive operand
//     bytes at a byte offset) is a funnel shift of two aligned words; the
//     B fragment (the +/-1 PN segment matrix) is one register, loaded
//     once.  The epilogue stays in registers: the thread of a quad that
//     holds columns 2q, 2q+1 adds its two square-sums to the running sum
//     it receives from its left neighbour two tiles later (segments of a
//     lag sit one tile apart), so the sum runs in ascending s, and the
//     last thread of the quad has pw of 16 lags per tile.  Each lane
//     forms the espan sums of 13 adjacent lags in one sliding pass over
//     the phase-summed squares (one load feeds 13 accumulators, each in
//     ascending k).
//     Under hunt_norm energy the pass over a phase's squares runs once a
//     phase, before its tiles, on planes loaded again (they are in L2);
//     under none it does not run.
//   * bf16 / f32 operands (hunt_toeplitz_kernel): the same Toeplitz
//     reuse on the CUDA cores, one block per row.  The operand is
//     rounded to bf16 in bf16 mode (ROUND) and left as the planes hold it
//     in f32 mode.  Thread t holds the 16 operand values x[2 + t .. + 15]
//     of both planes in registers and forms the 8 segment sums from them
//     in ascending k, as the plain version rounds (a bf16 tensor-core
//     product would not); the square-sums go through shared memory by
//     (segment, lag), and thread l adds its lag's 8 in ascending s.
//     Segments of 64 and 128 chips walk their values in slices of 16.
//     The espan or energy sum is the direct 128-term sum, one thread a
//     lag.
//
// Bound on the card: operations (the int8 multiply-adds at the tensor
// cores' rate) by a little over the bytes of the planes.  What the int8
// body spends is neither: it is instruction issue for the quantising
// pass, the fragment loads, the epilogue and the 48 k espan additions a
// row.
#include "common.cuh"

namespace sc {
constexpr int NSEG = SC_NSEG;      // corr_segments
constexpr int SEG = P / NSEG;
constexpr int OFF = SC_L / 2;      // the window's left pad, eq_length // 2
static_assert(NSEG == 1 || NSEG == 2 || NSEG == 4 || NSEG == 8 || NSEG == 16,
              "corr_segments 1, 2, 4, 8, 16");
}  // namespace sc

using namespace sc;

namespace {

constexpr unsigned FULL = 0xffffffffu;

// cfg.hunt_norm, the statistic's denominator (a template parameter)
constexpr int NORM_ESPAN = 0;     // phase-summed window energy
constexpr int NORM_ENERGY = 1;    // each phase's own window energy
constexpr int NORM_NONE = 2;      // none: the raw power

struct Best {
  float v;    // statistic
  float pw;   // raw power at that lag
  int i;      // lag
  int c;      // phase
};

// a beats b: larger statistic, ties to the lower phase, then the lower
// lag (the first maximum over lags, a strict > across ascending phases)
__device__ __forceinline__ bool beats(const Best& a, const Best& b) {
  return a.v > b.v ||
         (a.v == b.v && (a.c < b.c || (a.c == b.c && a.i < b.i)));
}

__device__ __forceinline__ Best warp_best(Best x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Best y{__shfl_xor_sync(FULL, x.v, o), __shfl_xor_sync(FULL, x.pw, o),
           __shfl_xor_sync(FULL, x.i, o), __shfl_xor_sync(FULL, x.c, o)};
    if (beats(y, x)) x = y;
  }
  return x;
}

// ------------------------------------------------------------ int8 body

// The mma's N = 8 columns are the preamble's 16-chip chunks, B[k][q] =
// pn[16 q + k], whatever the segments: z[t][q] = sum_k x[2 + t + k]
// pn[16 q + k], and chunk q of lag l is z[l + 16 q][q], one tile after
// chunk q - 1.  A segment of 16 chips is a chunk (the reference
// numerology); one of 32 chips is two (GRP 2: the quad thread that holds
// columns 2 tig and 2 tig + 1 adds the two int32 sums, then squares);
// one of 64 or 128 chips is four or eight (GRP 4, 8: it spans two quad
// threads or the whole quad, and its int32 sums travel along the quad
// with the running power until the segment's last thread squares them);
// one of 8 chips is half a chunk (SUB 2: each half has its own B
// fragment, zero on the other half's chips, so every tile takes SUB mma a
// plane, and the zero chips add exact zeros).
constexpr int MMA_WARPS = 4;               // rows per block
constexpr int CHUNK = 8;                   // values per 16-byte bf16 load
constexpr int NCH = P / 16;                // 16-chip chunks: the mma's N
constexpr int SUB = SEG < 16 ? 16 / SEG : 1;   // segments a chunk holds
constexpr int GRP = SEG > 16 ? SEG / 16 : 1;   // chunks a segment spans
constexpr int SEG_THREADS = GRP > 2 ? GRP / 2 : 1;  // quad threads it spans
// 16-lag tiles, an even count (the quad shares out two at a time)
constexpr int LAG_TILES = roundup((N_SYM + 15) / 16, 2);
constexpr int TILES = LAG_TILES + NCH - 1; // 16-row tiles of t = l + 16 q
constexpr int XCH = (16 * TILES + 16 + 255) / 256;   // chunks a lane loads
constexpr int XN = 32 * CHUNK * XCH;       // operand values x[OFF + 0..XN)
constexpr int XW = XN / 4;                 // words of an int8 plane
constexpr int PREV_CHUNKS = N_SYM / CHUNK; // chunks of the prev block
constexpr int EN_W = 16 * LAG_TILES;       // espan sums kept (lags padded)
constexpr int NL = EN_W / 32 + 1;          // adjacent lags a lane sums
// squares the espan pass reads: x's XN, or where the lane that holds lag
// N_SYM - 1 reads past them for its lags past N_SYM - 1, which no
// statistic uses (378-384, 631-640, 871-896, 1148-1152 and 1396-1408
// symbols), up to its last read, the rest zeros
constexpr int XS = imax(XN, (N_SYM - 1) / NL * NL + P + NL - 1);

static_assert(NCH == 8 && SUB * NCH == NSEG * GRP && SUB <= 2 && GRP <= 8,
              "8 chunks; segments of 8 to 128 chips");
// the highest word a lane's funnel shift reads: 4 (TILES - 1) + 3 + wbase
static_assert(4 * (TILES - 1) + 7 < XW, "tiles stay in x");
static_assert(N_SYM - 1 + P - 1 < XN, "espan sums stay in x");
static_assert(32 * NL >= EN_W && EN_W >= N_SYM && EN_W <= XN &&
                  (N_SYM - 1) / NL * NL + P + NL - 1 <= XS,
              "espan lanes");

struct alignas(16) MmaWarpSmem {
  uint32_t x[CYC][2][XW];   // int8 operand planes, x[OFF + j] at byte j
  float ssum[XS];           // phase-summed squares, then the espan sums
};
// the block's four warps' (28,672 B at the reference; past 48 KB, so
// dynamic, at 10 cycles or 624 symbols)
struct MmaSmem {
  MmaWarpSmem w[MMA_WARPS];
};

// 8 window values j0..j0+7 (j0 a multiple of 8) of a plane row
template <bool BF16>
__device__ __forceinline__ void load8(const void* row, int j0,
                                      float (&v)[CHUNK]) {
  if (BF16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(row) + j0));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[2 * e] = __uint_as_float(w[e] << 16);
      v[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  } else {
    const float4* p = reinterpret_cast<const float4*>(
        static_cast<const float*>(row) + j0);
    const float4 a = __ldg(p), b = __ldg(p + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

template <bool BF16>
__device__ __forceinline__ const void* plane_row(const void* base,
                                                 long long row) {
  return BF16 ? static_cast<const void*>(
                    static_cast<const __nv_bfloat16*>(base) + row * N_SYM)
              : static_cast<const void*>(
                    static_cast<const float*>(base) + row * N_SYM);
}

// clip(rint(v * scale), +/-127) of 4 values, packed as int8: rounded
// first, then clamped as integers (rounding a clamped value equals
// clamping the rounded one: the limits are integers).  The conversion
// takes a NaN to 0, as XLA's cast to int8 does (a float clamp, fmaxf,
// would make it -127), and saturates infinities.
__device__ __forceinline__ uint32_t quant4(const float* v, float scale) {
  uint32_t w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int q = min(max(__float2int_rn(v[e] * scale), -127), 127);
    w |= (static_cast<uint32_t>(q) & 0xffu) << (8 * e);
  }
  return w;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(b), "r"(0));
}

// Window value j of a plane row, one load
template <bool BF16>
__device__ __forceinline__ float load1(const void* row, int j) {
  if (BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(row)[j]);
  return static_cast<const float*>(row)[j];
}

// Chunk q (window values x[OFF + 8q .. 8q + 7]) of phase c's two planes
// of row n: the previous block's row, then this block's, then zeros.
// Where N_SYM is not whole chunks the rows are not 16 bytes apart: a
// value a load.
template <bool BF16>
__device__ __forceinline__ void load_chunk(const void* decim,
                                           const void* dprev0, long long N,
                                           int C, long long n, int c, int q,
                                           float (&vr)[CHUNK],
                                           float (&vi)[CHUNK]) {
  if constexpr (N_SYM % CHUNK != 0) {
    const void* prev_r =
        n < C ? plane_row<BF16>(dprev0, (c * 2LL) * C + n)
              : plane_row<BF16>(decim, (c * 2LL) * N + n - C);
    const void* prev_i =
        n < C ? plane_row<BF16>(dprev0, (c * 2LL + 1) * C + n)
              : plane_row<BF16>(decim, (c * 2LL + 1) * N + n - C);
    const void* cur_r = plane_row<BF16>(decim, (c * 2LL) * N + n);
    const void* cur_i = plane_row<BF16>(decim, (c * 2LL + 1) * N + n);
#pragma unroll
    for (int e = 0; e < CHUNK; ++e) {
      const int j = CHUNK * q + e;
      vr[e] = j < N_SYM       ? load1<BF16>(prev_r, j)
              : j < 2 * N_SYM ? load1<BF16>(cur_r, j - N_SYM)
                              : 0.f;
      vi[e] = j < N_SYM       ? load1<BF16>(prev_i, j)
              : j < 2 * N_SYM ? load1<BF16>(cur_i, j - N_SYM)
                              : 0.f;
    }
    return;
  }
  if (2 * N_SYM < XN && q >= 2 * PREV_CHUNKS) {   // past the window
#pragma unroll
    for (int e = 0; e < CHUNK; ++e) vr[e] = vi[e] = 0.f;
    return;
  }
  if (q < PREV_CHUNKS) {
    if (n < C) {
      load8<BF16>(plane_row<BF16>(dprev0, (c * 2LL) * C + n), CHUNK * q, vr);
      load8<BF16>(plane_row<BF16>(dprev0, (c * 2LL + 1) * C + n), CHUNK * q,
                  vi);
    } else {
      load8<BF16>(plane_row<BF16>(decim, (c * 2LL) * N + n - C), CHUNK * q,
                  vr);
      load8<BF16>(plane_row<BF16>(decim, (c * 2LL + 1) * N + n - C),
                  CHUNK * q, vi);
    }
  } else {
    load8<BF16>(plane_row<BF16>(decim, (c * 2LL) * N + n),
                CHUNK * (q - PREV_CHUNKS), vr);
    load8<BF16>(plane_row<BF16>(decim, (c * 2LL + 1) * N + n),
                CHUNK * (q - PREV_CHUNKS), vi);
  }
}

// The window-energy sums of the warp's squares sq (chunks lane + 32 h):
// en[l] = sum_k sq[l + k], k ascending, NL lags a lane, into
// sm.ssum (the squares' place) for l < EN_W.  Returns whether one of
// this lane's sums of a lag l < N_SYM is NaN: then the statistic
// pw / (en + 1e-12) of the phases they serve holds a NaN (the int8 power
// is finite), and those phases do not win.
__device__ __forceinline__ bool window_energy(MmaWarpSmem& sm,
                                              const float (&sq)[XCH][CHUNK],
                                              int lane) {
#pragma unroll
  for (int h = 0; h < XCH; ++h) {
    float4* dst = reinterpret_cast<float4*>(&sm.ssum[CHUNK * (lane + 32 * h)]);
    dst[0] = make_float4(sq[h][0], sq[h][1], sq[h][2], sq[h][3]);
    dst[1] = make_float4(sq[h][4], sq[h][5], sq[h][6], sq[h][7]);
  }
  if constexpr (XS > XN)
    for (int i = XN + lane; i < XS; i += 32) sm.ssum[i] = 0.f;
  __syncwarp();

  float en[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) en[i] = 0.f;
  const bool en_lane = lane * NL < N_SYM;
  if (en_lane) {
    const float* s = sm.ssum + lane * NL;
#pragma unroll
    for (int j = 0; j < NL - 1; ++j) {
      const float v = s[j];
#pragma unroll
      for (int i = 0; i <= j; ++i) en[i] = en[i] + v;
    }
#pragma unroll 4
    for (int j = NL - 1; j < P; ++j) {
      const float v = s[j];
#pragma unroll
      for (int i = 0; i < NL; ++i) en[i] = en[i] + v;
    }
#pragma unroll
    for (int j = P; j < P + NL - 1; ++j) {
      const float v = s[j];
#pragma unroll
      for (int i = j - P + 1; i < NL; ++i) en[i] = en[i] + v;
    }
  }
  __syncwarp();               // every lane has read its squares
  float* en_s = sm.ssum;      // the energy sums take their place
#pragma unroll
  for (int i = 0; i < NL; ++i)
    if (lane * NL + i < EN_W) en_s[lane * NL + i] = en[i];
  __syncwarp();
  // A NaN square reaches every sum whose window holds it, and the
  // windows of a lane's lags overlap in all but NL - 1 positions: a NaN
  // sum among them makes its first or its last one of a lag < N_SYM NaN
  // (the lane that holds lag N_SYM - 1 stops at sum LAST; a lane past it
  // summed nothing).
  constexpr int LAST = (N_SYM - 1) % NL;
  const float last = lane * NL + NL - 1 < N_SYM ? en[NL - 1] : en[LAST];
  return isnan(en[0]) || isnan(last);
}

template <bool BF16, int NORM>
__global__ void __launch_bounds__(MMA_WARPS * 32) hunt_mma_kernel(
    const void* __restrict__ decim, const void* __restrict__ dprev0,
    const float* __restrict__ pn, int* __restrict__ lag_out,
    int* __restrict__ ph_out, float* __restrict__ peak_out, long long N,
    int C, float hunt_scale, float peak_scale) {
  SC_BLOCK_SMEM(MmaSmem, wsm);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n = (long long)blockIdx.x * MMA_WARPS + warp;
  if (n >= N) return;        // a warp works alone: no block barrier below
  MmaWarpSmem& sm = wsm.w[warp];
  const int g = lane >> 2, tig = lane & 3;   // mma row group, quad thread

  // B fragments: B[k][q] = pn[16 q + k]; this thread holds k = 4 tig..+3
  // of column q = g; fragment u keeps the chips of segment u of the chunk
  // (SUB 2: half a chunk each) and zeros the others
  uint32_t bfrag[SUB];
#pragma unroll
  for (int u = 0; u < SUB; ++u) {
    bfrag[u] = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * tig + i;
      if (SUB == 1 || k / (16 / SUB) == u)
        bfrag[u] |= (static_cast<uint32_t>(static_cast<int>(
                        pn[16 * g + k])) & 0xffu) << (8 * i);
    }
  }

  // ---- pass 1: quantise the planes, sum the squares over the phases ----
  float ss[XCH][CHUNK];
#pragma unroll
  for (int h = 0; h < XCH; ++h)
#pragma unroll
    for (int e = 0; e < CHUNK; ++e) ss[h][e] = 0.f;
  for (int c = 0; c < CYC; ++c) {
#pragma unroll
    for (int h = 0; h < XCH; ++h) {
      const int q = lane + 32 * h;           // chunk: x values 8q..8q+7
      float vr[CHUNK], vi[CHUNK];
      load_chunk<BF16>(decim, dprev0, N, C, n, c, q, vr, vi);
      if constexpr (NORM == NORM_ESPAN) {
#pragma unroll
        for (int e = 0; e < CHUNK; ++e)
          ss[h][e] = ss[h][e] + (vr[e] * vr[e] + vi[e] * vi[e]);
      }
      *reinterpret_cast<uint2*>(&sm.x[c][0][2 * q]) =
          make_uint2(quant4(vr, hunt_scale), quant4(vr + 4, hunt_scale));
      *reinterpret_cast<uint2*>(&sm.x[c][1][2 * q]) =
          make_uint2(quant4(vi, hunt_scale), quant4(vi + 4, hunt_scale));
    }
  }
  // ---- espan: en[l] = sum_k ssum[l + k], k ascending, NL lags a lane ----
  bool row_nan = false;       // espan: this lane saw a NaN energy, which
                              // skips every phase
  if constexpr (NORM == NORM_ESPAN)
    row_nan = window_energy(sm, ss, lane);
  else
    __syncwarp();             // the operand planes are whole
  const float* en_s = sm.ssum;

  // ---- pass 2: Toeplitz mma, ascending-s sum along the quad, argmax ----
  // no lag wins a row whose every phase is skipped: lag 0, phase 0, the
  // peak 2 (-1) / s^2 of the JAX kernel's initial best
  Best best{-1.f, -1.f, 0, 0};
  const int wbase = tig + (g >> 2);       // first operand word of tile 0
  const int sh = 8 * (g & 3);             // byte offset inside it
  const int lag0 = 16 * (tig >> 1) + g + 8 * (tig & 1);
  for (int c = 0; c < CYC; ++c) {
    const Best before = best;   // the best of the phases before this one
    bool phase_nan = false;     // energy: phase c's statistic holds a NaN
    if constexpr (NORM == NORM_ENERGY) {
      // this phase's own window energies, from its planes loaded again
      float sq[XCH][CHUNK];
#pragma unroll
      for (int h = 0; h < XCH; ++h) {
        float vr[CHUNK], vi[CHUNK];
        load_chunk<BF16>(decim, dprev0, N, C, n, c, lane + 32 * h, vr, vi);
#pragma unroll
        for (int e = 0; e < CHUNK; ++e)
          sq[h][e] = vr[e] * vr[e] + vi[e] * vi[e];
      }
      __syncwarp();           // the last phase's sums are read
      phase_nan = __any_sync(FULL, window_energy(sm, sq, lane));
    }
    const uint32_t* xr = sm.x[c][0] + wbase;
    const uint32_t* xi = sm.x[c][1] + wbase;
    // rows g (A) and g + 8 (B) of the tile: the even column's square-sums
    // of the previous tile (GRP 2 and more: its int32 sums), the running
    // sums of the last two tiles (GRP 4 and 8: with the int32 sums of the
    // segment in progress)
    float qeA[SUB], qeB[SUB];
    int erA = 0, eiA = 0, erB = 0, eiB = 0;
    int j1[4] = {0, 0, 0, 0}, j2[4] = {0, 0, 0, 0};   // GRP 4, 8 only
#pragma unroll
    for (int u = 0; u < SUB; ++u) qeA[u] = qeB[u] = 0.f;
    float p1A = 0.f, p1B = 0.f, p2A = 0.f, p2B = 0.f;
    float fA = 0.f, fB = 0.f;
#pragma unroll
    for (int T = 0; T < TILES; ++T) {
      const uint32_t ar0 = __funnelshift_r(xr[4 * T], xr[4 * T + 1], sh);
      const uint32_t ar1 = __funnelshift_r(xr[4 * T + 2], xr[4 * T + 3], sh);
      const uint32_t ai0 = __funnelshift_r(xi[4 * T], xi[4 * T + 1], sh);
      const uint32_t ai1 = __funnelshift_r(xi[4 * T + 2], xi[4 * T + 3], sh);
      int dr[SUB][4], di[SUB][4];
#pragma unroll
      for (int u = 0; u < SUB; ++u) {
        mma_s8(dr[u], ar0, ar1, bfrag[u]);
        mma_s8(di[u], ai0, ai1, bfrag[u]);
      }
      // this thread continues lag tile T - 2 tig - 1: chunk 2 tig is
      // column 2 tig of tile T - 1, chunk 2 tig + 1 column 2 tig + 1 of
      // tile T; its left neighbour left that lag tile two tiles ago
      float rA = __shfl_up_sync(FULL, p2A, 1);
      float rB = __shfl_up_sync(FULL, p2B, 1);
      if (tig == 0) rA = rB = 0.f;
      float accA, accB;
      if constexpr (GRP == 1) {
        // re^2 + im^2 < 2^24: exact in int32 and in f32; the segments
        // of the two chunks in ascending s
        accA = rA;
        accB = rB;
#pragma unroll
        for (int u = 0; u < SUB; ++u) {
          accA = accA + qeA[u];
          accB = accB + qeB[u];
        }
#pragma unroll
        for (int u = 0; u < SUB; ++u) {
          accA = accA + static_cast<float>(dr[u][1] * dr[u][1] +
                                           di[u][1] * di[u][1]);
          accB = accB + static_cast<float>(dr[u][3] * dr[u][3] +
                                           di[u][3] * di[u][3]);
          qeA[u] = static_cast<float>(dr[u][0] * dr[u][0] +
                                      di[u][0] * di[u][0]);
          qeB[u] = static_cast<float>(dr[u][2] * dr[u][2] +
                                      di[u][2] * di[u][2]);
        }
      } else if constexpr (GRP == 2) {
        // one segment of two chunks: the int32 sums added, then squared
        // (< 2^31 in int32, rounded once to f32 as the plain version's
        // re^2 + im^2 of exact squares is)
        const int sAr = erA + dr[0][1], sAi = eiA + di[0][1];
        const int sBr = erB + dr[0][3], sBi = eiB + di[0][3];
        accA = rA + static_cast<float>(sAr * sAr + sAi * sAi);
        accB = rB + static_cast<float>(sBr * sBr + sBi * sBi);
        erA = dr[0][0], eiA = di[0][0];
        erB = dr[0][2], eiB = di[0][2];
      } else {
        // one segment of GRP chunks over GRP / 2 quad threads: each adds
        // its two chunks' int32 sums to those its left neighbour left two
        // tiles ago (none at the segment's first thread); the last squares
        // them.  |re| reaches 127 x 128 and re^2 2^28, so each square is
        // rounded to f32, then their sum, as the plain version's
        // corr * corr of each plane and p2 re + p2 im round them
        int j[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) j[e] = __shfl_up_sync(FULL, j2[e], 1);
        const bool first = tig % SEG_THREADS == 0;
        const bool last = tig % SEG_THREADS == SEG_THREADS - 1;
        const int sAr = (first ? 0 : j[0]) + erA + dr[0][1];
        const int sAi = (first ? 0 : j[1]) + eiA + di[0][1];
        const int sBr = (first ? 0 : j[2]) + erB + dr[0][3];
        const int sBi = (first ? 0 : j[3]) + eiB + di[0][3];
        if (last) {
          accA = rA + (static_cast<float>(sAr * sAr) +
                       static_cast<float>(sAi * sAi));
          accB = rB + (static_cast<float>(sBr * sBr) +
                       static_cast<float>(sBi * sBi));
        } else {
          accA = rA;
          accB = rB;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) j2[e] = j1[e];
        j1[0] = sAr, j1[1] = sAi, j1[2] = sBr, j1[3] = sBi;
        erA = dr[0][0], eiA = di[0][0];
        erB = dr[0][2], eiB = di[0][2];
      }
      p2A = p1A; p1A = accA;
      p2B = p1B; p1B = accB;
      // quad thread 3 now holds pw of lag tile T - 7, rows g and g + 8;
      // every second tile the quad shares out the last two tiles' four
      if (T >= NCH - 1) {
        if ((T - (NCH - 1)) % 2 == 0) {
          fA = accA;
          fB = accB;
        } else {
          const int src = lane | 3;
          const float r0 = __shfl_sync(FULL, fA, src);
          const float r1 = __shfl_sync(FULL, fB, src);
          const float r2 = __shfl_sync(FULL, accA, src);
          const float pw = tig == 0 ? r0 : tig == 1 ? r1 : tig == 2 ? r2
                                                                    : accB;
          const int lag = 16 * (T - NCH) + lag0;
          float v = pw;
          if constexpr (NORM != NORM_NONE) v = pw / (en_s[lag] + 1e-12f);
          if (lag < N_SYM && v > best.v) best = Best{v, pw, lag, c};
        }
      }
    }
    // a phase whose statistic holds a NaN does not win: the JAX kernel
    // takes one max per phase, NaN there, and NaN > best is false
    if (phase_nan) best = before;
  }
  if (__any_sync(FULL, row_nan)) best = Best{-1.f, -1.f, 0, 0};
  best = warp_best(best);
  if (lane == 0) {
    lag_out[n] = best.i;
    ph_out[n] = best.c;
    peak_out[n] = (2.f * best.pw) * peak_scale;
  }
}

// ---------------------------------------------------- bf16 / f32 operands

// the operand values x[OFF + 0 .. N_SYM + P - 2]: one a thread, or
// where that would pass the 1024 threads a block may hold (past 897
// symbols), TOE_REP a thread, value (and t and lag) tid + TOE_THREADS r
constexpr int TOE_VALUES = N_SYM + P - 1;
constexpr int TOE_REP = (TOE_VALUES + 1023) / 1024;
constexpr int TOE_THREADS = roundup((TOE_VALUES + TOE_REP - 1) / TOE_REP, 32);
constexpr int TOE_LEN = TOE_REP * TOE_THREADS;     // values held
constexpr int TOE_WARPS = TOE_THREADS / 32;
constexpr int T_ROWS = N_SYM + SEG * (NSEG - 1);   // values of t = l + SEG s
constexpr int Q_STRIDE = roundup(N_SYM, 4) + 4;    // segment rows 16 B apart
constexpr int TOE_SLICE = 16;    // values a thread holds of a longer segment

static_assert(T_ROWS + SEG - 1 <= TOE_LEN && TOE_THREADS <= 1024,
              "a thread per t, or TOE_REP");

// the block's shared arrays as one layout (19,136 B at the reference;
// past 48 KB at 16 segments and more than about 600 symbols, and at 8
// from about 1000)
struct ToeSmem {
  float xs[2][TOE_LEN];            // the operand, x[OFF + j]
  float ssum[TOE_LEN];             // squares (summed over phases)
  __align__(16) float pns[P];
  float qs[NSEG][Q_STRIDE];        // re^2 + im^2 by (segment, lag)
  Best wbest[TOE_WARPS];
  unsigned wnan[TOE_WARPS];        // phases with a NaN statistic
};

// x[OFF + j] of row n's window, phase c, plane p, for 0 <= j <
// TOE_LEN: the previous block's row, this block's, then zeros
__device__ __forceinline__ float operand_at(const void* decim,
                                            const void* dprev0, int bf16,
                                            long long N, int C, long long n,
                                            int c, int p, int j) {
  if constexpr (2 * N_SYM < TOE_LEN)
    if (j >= 2 * N_SYM) return 0.f;
  const long long cp = c * 2 + p;
  if (j >= N_SYM) return load_plane(decim, (cp * N + n) * N_SYM + j - N_SYM,
                                    bf16);
  return n < C ? load_plane(dprev0, (cp * C + n) * N_SYM + j, bf16)
               : load_plane(decim, (cp * N + n - C) * N_SYM + j, bf16);
}

// The hunt operand of a window value: bf16(w) in bf16 mode (ROUND), else
// w as the planes hold it.
template <bool ROUND>
__device__ __forceinline__ float hunt_operand(float w) {
  if constexpr (ROUND) return bf16_round(w);
  return w;
}

// The body of hunt_toeplitz_kernel over the block's shared arrays.
// Thread tid takes operand value, t and lag tid + TOE_THREADS r for each
// r < TOE_REP (one of each up to 897 symbols).
template <bool ROUND, int NORM>
__device__ __forceinline__ void toeplitz_row(
    float (&xs)[2][TOE_LEN], float (&ssum)[TOE_LEN], float (&pns)[P],
    float (&qs)[NSEG][Q_STRIDE], Best (&wbest)[TOE_WARPS],
    unsigned (&wnan)[TOE_WARPS], const void* __restrict__ decim,
    const void* __restrict__ dprev0, int in_bf16,
    const float* __restrict__ pn, int* __restrict__ lag_out,
    int* __restrict__ ph_out, float* __restrict__ peak_out, long long N,
    int C, float peak_scale) {
  const long long n = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (tid < P) pns[tid] = pn[tid];
  float sq[TOE_REP];                       // ssum[j], summed over phases
  float pw[TOE_REP][CYC], en[TOE_REP][CYC];   // en: energy only
  float vr[TOE_REP], vi[TOE_REP];
#pragma unroll
  for (int r = 0; r < TOE_REP; ++r) {
    const int j = tid + TOE_THREADS * r;
    sq[r] = 0.f;
    vr[r] = operand_at(decim, dprev0, in_bf16, N, C, n, 0, 0, j);
    vi[r] = operand_at(decim, dprev0, in_bf16, N, C, n, 0, 1, j);
  }
#pragma unroll
  for (int c = 0; c < CYC; ++c) {
    __syncthreads();   // the previous phase's operand and sums fully read
#pragma unroll
    for (int r = 0; r < TOE_REP; ++r) {
      const int j = tid + TOE_THREADS * r;
      if constexpr (NORM == NORM_ESPAN)
        sq[r] = sq[r] + (vr[r] * vr[r] + vi[r] * vi[r]);
      if constexpr (NORM == NORM_ENERGY)
        ssum[j] = vr[r] * vr[r] + vi[r] * vi[r];
      xs[0][j] = hunt_operand<ROUND>(vr[r]);
      xs[1][j] = hunt_operand<ROUND>(vi[r]);
      if (c + 1 < CYC) { // the next phase's loads fly under this one's sums
        vr[r] = operand_at(decim, dprev0, in_bf16, N, C, n, c + 1, 0, j);
        vi[r] = operand_at(decim, dprev0, in_bf16, N, C, n, c + 1, 1, j);
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < TOE_REP; ++r) {
      const int t = tid + TOE_THREADS * r;
      if constexpr (SEG > 32) {
        // segments of 64 or 128 chips: the SEG values walked in slices of
        // TOE_SLICE (a register window of SEG would spill), each
        // segment's sums still in ascending k
        if (t < T_ROWS) {
          float re[NSEG], im[NSEG];
#pragma unroll
          for (int s = 0; s < NSEG; ++s) re[s] = im[s] = 0.f;
#pragma unroll 1
          for (int k0 = 0; k0 < SEG; k0 += TOE_SLICE) {
            float xr[TOE_SLICE], xi[TOE_SLICE];
#pragma unroll
            for (int k = 0; k < TOE_SLICE; ++k) {
              xr[k] = xs[0][t + k0 + k];
              xi[k] = xs[1][t + k0 + k];
            }
#pragma unroll
            for (int s = 0; s < NSEG; ++s) {
              const float4* v4 =
                  reinterpret_cast<const float4*>(pns + s * SEG + k0);
#pragma unroll
              for (int k4 = 0; k4 < TOE_SLICE / 4; ++k4) {
                const float4 v = v4[k4];
                const float vk[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  re[s] = re[s] + xr[4 * k4 + e] * vk[e];
                  im[s] = im[s] + xi[4 * k4 + e] * vk[e];
                }
              }
            }
          }
#pragma unroll
          for (int s = 0; s < NSEG; ++s) {
            const int l = t - SEG * s;     // segment s of lag l is y[t][s]
            if (l >= 0 && l < N_SYM) qs[s][l] = re[s] * re[s] + im[s] * im[s];
          }
        }
      } else if (t < T_ROWS) {
        // one pass over t serves the 8 segments from the same 16 values
        float xr[SEG], xi[SEG];
#pragma unroll
        for (int k = 0; k < SEG; ++k) {
          xr[k] = xs[0][t + k];
          xi[k] = xs[1][t + k];
        }
#pragma unroll
        for (int s = 0; s < NSEG; ++s) {
          const float4* v4 = reinterpret_cast<const float4*>(pns + s * SEG);
          float re = 0.f, im = 0.f;
#pragma unroll
          for (int k4 = 0; k4 < SEG / 4; ++k4) {
            const float4 v = v4[k4];
            const float vk[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              re = re + xr[4 * k4 + e] * vk[e];
              im = im + xi[4 * k4 + e] * vk[e];
            }
          }
          const int l = t - SEG * s;       // segment s of lag l is y[t][s]
          if (l >= 0 && l < N_SYM) qs[s][l] = re * re + im * im;
        }
      }
      if constexpr (NORM == NORM_ENERGY) {
        float e = 0.f;
        if (t < N_SYM) {
          for (int k = 0; k < P; ++k) e = e + ssum[t + k];
        }
        en[r][c] = e;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < TOE_REP; ++r) {
      const int l = tid + TOE_THREADS * r;
      float acc = 0.f;
      if (l < N_SYM) {
#pragma unroll
        for (int s = 0; s < NSEG; ++s) acc = acc + qs[s][l];
      }
      pw[r][c] = acc;
    }
  }
  if constexpr (NORM == NORM_ESPAN) {
#pragma unroll
    for (int r = 0; r < TOE_REP; ++r) ssum[tid + TOE_THREADS * r] = sq[r];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < TOE_REP; ++r) {
      const int l = tid + TOE_THREADS * r;
      float e = 0.f;
      if (l < N_SYM) {
        for (int k = 0; k < P; ++k) e = e + ssum[l + k];
      }
#pragma unroll
      for (int c = 0; c < CYC; ++c) en[r][c] = e;
    }
  }
  float v[TOE_REP][CYC];
  unsigned nan_ph = 0;                     // bit c: phase c holds a NaN
#pragma unroll
  for (int r = 0; r < TOE_REP; ++r) {
    if (tid + TOE_THREADS * r < N_SYM) {
#pragma unroll
      for (int c = 0; c < CYC; ++c) {
        v[r][c] = pw[r][c];
        if constexpr (NORM != NORM_NONE)
          v[r][c] = pw[r][c] / (en[r][c] + 1e-12f);
        if (isnan(v[r][c])) nan_ph |= 1u << c;
      }
    }
  }
  // a phase whose statistic holds a NaN does not win: the JAX kernel
  // takes one max per phase, NaN there, and NaN > best is false
  nan_ph = __reduce_or_sync(FULL, nan_ph);
  if (lane == 0) wnan[warp] = nan_ph;
  __syncthreads();
  nan_ph = __reduce_or_sync(FULL, lane < TOE_WARPS ? wnan[lane] : 0u);
  // a row whose every phase is skipped: lag 0, phase 0, the peak 2 (-1)
  // of the JAX kernel's initial best.  The thread's first lag takes its
  // phases' first maximum by a strict >; a later lag (TOE_REP) is ranked
  // as lags of two threads are, by beats.
  Best x{-1.f, -1.f, tid, 0};
#pragma unroll
  for (int r = 0; r < TOE_REP; ++r) {
    const int l = tid + TOE_THREADS * r;
    if (l < N_SYM) {
#pragma unroll
      for (int c = 0; c < CYC; ++c) {
        const Best y{v[r][c], pw[r][c], l, c};
        if (!((nan_ph >> c) & 1u) && (r == 0 ? v[r][c] > x.v : beats(y, x)))
          x = y;
      }
    }
  }
  x = warp_best(x);
  if (lane == 0) wbest[warp] = x;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < TOE_WARPS; ++w)
      if (beats(wbest[w], x)) x = wbest[w];
    lag_out[n] = x.i;
    ph_out[n] = x.c;
    peak_out[n] = (2.f * x.pw) * peak_scale;
  }
}

// The arrays are static shared memory where they fit 48 KB (every
// geometry but 16 segments at more than about 600 symbols), else a
// ToeSmem in the dynamic shared memory.
template <bool ROUND, int NORM>
__global__ void __launch_bounds__(TOE_THREADS) hunt_toeplitz_kernel(
    const void* __restrict__ decim, const void* __restrict__ dprev0,
    int in_bf16, const float* __restrict__ pn, int* __restrict__ lag_out,
    int* __restrict__ ph_out, float* __restrict__ peak_out, long long N,
    int C, float peak_scale) {
  if constexpr (!SMEM_DYNAMIC<ToeSmem>) {
    __shared__ float xs[2][TOE_LEN];         // the operand, x[OFF + j]
    __shared__ float ssum[TOE_LEN];          // squares (summed over phases)
    __shared__ __align__(16) float pns[P];
    __shared__ float qs[NSEG][Q_STRIDE];     // re^2 + im^2 by (segment, lag)
    __shared__ Best wbest[TOE_WARPS];
    __shared__ unsigned wnan[TOE_WARPS];     // phases with a NaN statistic
    toeplitz_row<ROUND, NORM>(xs, ssum, pns, qs, wbest, wnan, decim, dprev0,
                              in_bf16, pn, lag_out, ph_out, peak_out, N, C,
                              peak_scale);
  } else {
    extern __shared__ __align__(16) unsigned char sc_dyn_smem[];
    ToeSmem& ts = *reinterpret_cast<ToeSmem*>(sc_dyn_smem);
    toeplitz_row<ROUND, NORM>(ts.xs, ts.ssum, ts.pns, ts.qs, ts.wbest,
                              ts.wnan, decim, dprev0, in_bf16, pn, lag_out,
                              ph_out, peak_out, N, C, peak_scale);
  }
}

template <int NORM>
cudaError_t launch_hunt(const void* decim, const void* dprev0,
                        const float* pn, int* lg, int* ph, float* pk, int N,
                        int C, int in_bf16, int int8_hunt, int f32_operand,
                        float hunt_scale, float peak_scale,
                        cudaStream_t st) {
  if (int8_hunt) {
    const auto kernel = in_bf16 ? hunt_mma_kernel<true, NORM>
                                : hunt_mma_kernel<false, NORM>;
    const cudaError_t ready = allow_smem<MmaSmem>(kernel);
    if (ready != cudaSuccess) return ready;
    const dim3 grid((unsigned)((N + MMA_WARPS - 1) / MMA_WARPS));
    kernel<<<grid, MMA_WARPS * 32, SMEM_LAUNCH_BYTES<MmaSmem>, st>>>(
        decim, dprev0, pn, lg, ph, pk, (long long)N, C, hunt_scale,
        peak_scale);
  } else {
    const auto kernel = f32_operand ? hunt_toeplitz_kernel<false, NORM>
                                    : hunt_toeplitz_kernel<true, NORM>;
    const cudaError_t ready = allow_smem<ToeSmem>(kernel);
    if (ready != cudaSuccess) return ready;
    kernel<<<dim3((unsigned)N), TOE_THREADS, SMEM_LAUNCH_BYTES<ToeSmem>,
             st>>>(decim, dprev0, in_bf16, pn, lg, ph, pk, (long long)N, C,
                   peak_scale);
  }
  return cudaGetLastError();
}

}  // namespace

// f32_operand: hunt_dtype "f32" (the bf16/f32 body leaves the operand
// unrounded; the int8 body ignores it); norm: NORM_ESPAN, NORM_ENERGY or
// NORM_NONE.
extern "C" int sc_hunt(const void* decim, const void* dprev0, const void* pn,
                       void* lag, void* phase, void* peak, int N, int C,
                       int in_bf16, int int8_hunt, float hunt_scale,
                       float peak_scale, int f32_operand, int norm,
                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pnf = static_cast<const float*>(pn);
  int* lg = static_cast<int*>(lag);
  int* ph = static_cast<int*>(phase);
  float* pk = static_cast<float*>(peak);
  if (norm == NORM_ENERGY)
    return (int)launch_hunt<NORM_ENERGY>(decim, dprev0, pnf, lg, ph, pk, N,
                                         C, in_bf16, int8_hunt, f32_operand,
                                         hunt_scale, peak_scale, st);
  if (norm == NORM_NONE)
    return (int)launch_hunt<NORM_NONE>(decim, dprev0, pnf, lg, ph, pk, N, C,
                                       in_bf16, int8_hunt, f32_operand,
                                       hunt_scale, peak_scale, st);
  return (int)launch_hunt<NORM_ESPAN>(decim, dprev0, pnf, lg, ph, pk, N, C,
                                      in_bf16, int8_hunt, f32_operand,
                                      hunt_scale, peak_scale, st);
}

// The hunt's layout at this geometry, for reports: the block's shared
// bytes of the int8 body and of the Toeplitz body (dynamic where past 48
// KB), and the Toeplitz body's threads a block.
extern "C" int sc_hunt_layout(int* out) {
  out[0] = (int)sizeof(MmaSmem);
  out[1] = (int)sizeof(ToeSmem);
  out[2] = TOE_THREADS;
  return 0;
}
