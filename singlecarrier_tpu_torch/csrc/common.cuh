// Shared geometry and helpers of the RX kernels (sm_90a).
//
// The kernels compile the modem's shapes in.  Each SC_* name below is a
// -D define that ops/_build.py kernel_geometry gives for a config; left
// undefined it takes the reference numerology's value (ModemConfig
// defaults), so the default library is built with no define at all.
// ops/_build.py kernel_limits states the numerologies the kernels are
// written for; the static_asserts here and in each source hold them.
// Here stand the shapes every source compiles in; a source names the
// others it uses itself (the hunt its segments and OFF, the decode its
// packet, equalizer and DFT), so that its preprocessed text, which keys
// its object (ops/_build.py), changes only with the shapes it reads.
// Decim planes are laid out [cyc][2][N][N_SYM] (phase, real/imag plane,
// row, symbol) with row n = b*C + ch, f32 or bf16; the hunt window of row
// n is [OFF zeros | prev block | this block | zeros], prev being row n - C
// or, for n < C, the carried planes dprev0 [cyc][2][C][N_SYM].
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#ifndef SC_N_SAMP
#define SC_N_SAMP 1880
#endif
#ifndef SC_CYC
#define SC_CYC 5
#endif
#ifndef SC_NTAPS
#define SC_NTAPS 49
#endif
#ifndef SC_P
#define SC_P 128
#endif
#ifndef SC_NSEG
#define SC_NSEG 8
#endif
#ifndef SC_D
#define SC_D 248
#endif
#ifndef SC_L
#define SC_L 5
#endif
#ifndef SC_NFFT
#define SC_NFFT 512
#endif
#ifndef SC_PKT
#define SC_PKT 384
#endif

namespace sc {

constexpr int N_SAMP = SC_N_SAMP;  // frame_size
constexpr int CYC = SC_CYC;        // fs / rs
constexpr int N_SYM = N_SAMP / CYC;  // symbols_per_block
constexpr int NTAPS = SC_NTAPS;
constexpr int HALO = NTAPS - 1;
constexpr int P = SC_P;            // preamble chips

constexpr int roundup(int x, int m) { return (x + m - 1) / m * m; }
constexpr int imax(int a, int b) { return a > b ? a : b; }
constexpr int imin(int a, int b) { return a < b ? a : b; }

static_assert(N_SAMP % CYC == 0, "a block is whole symbols");
static_assert(P == 128, "preamble_length 128");
static_assert(NTAPS % 2 == 1 && NTAPS >= 9 && NTAPS <= 49,
              "ntaps odd, 9 to 49");
static_assert(CYC >= 2 && CYC <= 10, "cycles 2 to 10");
static_assert(N_SAMP <= 16160 && N_SYM >= P && N_SYM <= 1616,
              "frame_size at most 16160, P <= symbols_per_block <= 1616");

// A block's shared memory past the 48 KB a kernel has unasked is dynamic:
// the launch names its size and the kernel is allowed it once
// (cudaFuncSetAttribute).  Every layout that fits stays static.
constexpr int STATIC_SMEM_MAX = 48 * 1024;

template <class S>
constexpr bool SMEM_DYNAMIC = (int)sizeof(S) > STATIC_SMEM_MAX;
// the dynamic bytes a launch of a kernel that holds an S names
template <class S>
constexpr unsigned SMEM_LAUNCH_BYTES = SMEM_DYNAMIC<S> ? sizeof(S) : 0;
// allow `kernel` `bytes` of dynamic shared memory (asked once for each
// instantiation: past 48 KB a launch fails unless asked)
template <class K>
cudaError_t allow_smem_bytes(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}
// allow `kernel` an S in dynamic shared memory where it needs one
template <class S, class K>
cudaError_t allow_smem(K kernel) {
  if constexpr (SMEM_DYNAMIC<S>)
    return allow_smem_bytes(kernel, (int)sizeof(S));
  else
    return cudaSuccess;
}
struct SmemNone {};
}  // namespace sc

// `name`, a reference to the block's S: a static __shared__ S where it
// fits STATIC_SMEM_MAX, else the kernel's dynamic shared memory.
#define SC_BLOCK_SMEM(S, name)                                               \
  extern __shared__ __align__(16) unsigned char sc_dyn_smem[];               \
  __shared__ std::conditional_t<sc::SMEM_DYNAMIC<S>, sc::SmemNone, S>        \
      sc_static_smem;                                                        \
  S& name = *reinterpret_cast<S*>(sc::SMEM_DYNAMIC<S>                        \
                                      ? static_cast<void*>(sc_dyn_smem)      \
                                      : static_cast<void*>(&sc_static_smem))

namespace sc {

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float load_plane(const void* p, long long i,
                                            int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

}  // namespace sc
