// Fused sweep of Pauli-word rotations over a statevector, Hopper (sm_90a).
//
// Replaces flow_guided_krylov_tpu/ops/pallas_trotter.py::make_x_sweep, the
// Pallas TPU kernel for the Trotter propagator of spin-lattice SKQD.  For a
// list of words (cos t, sin t, x, z, n_y), applied in order, each word maps
//
//   psi'[k] = cos t * psi[k] - i sin t * s_k * i^n_y * psi[k ^ x],
//   s_k = (-1)^popcount((k ^ x) & z),
//
// on a 2^n statevector held as separate re and im float32 arrays.
//
// Gathered tiles.  A tile is the 2^T amplitudes that share every bit
// outside T chosen bit positions (tile_mask): block b owns the tile whose
// other bits spell b, and every word's x lies inside tile_mask, so a word
// only mixes amplitudes of one tile and the whole list costs one read and
// one write of the state.  The Pallas kernel's contiguous tile is the case
// tile_mask = 2^T - 1; ops/x_sweep.py's planner builds tiles such as bits
// {0..3, 14..23} for TFIM-24's high X words.  A tile holds global bits
// 0..3 wherever its words leave room (the planner adds them), so global
// loads come in runs of 16 floats, whole 32-byte sectors, and move as
// float4 where a thread's first two register vectors are bits 0 and 1.
// Plain 16-byte loads, not TMA: a tile is read once, straight into
// registers, and a strided TMA box would land it in shared memory first,
// a pass this design avoids.
//
// What bounds it: the device-memory floor is 16 bytes per amplitude (re
// and im in, re and im out), 268 MB a sweep at n = 24, 0.080 ms at 3.35
// TB/s.  The first version moved every word through shared memory (16 B an
// amplitude and a __syncthreads() per word, about 0.015 ms a word at
// n = 24 on an H100), so words, not bytes, set its time.  Here each thread
// holds sub-cubes of 16 amplitudes in registers, spanned by the phase's
// four register vectors (tile coordinates), and applies there every
// consecutive word whose x lies in their span.  ops/x_sweep.py::
// sweep_table cuts the word list into such phases without reordering it;
// the block goes through shared memory only between phases.  The first
// phase loads its sub-cubes from device memory and the last one stores
// them there, so a sweep of P phases makes P - 1 shared-memory round
// trips: TFIM-24's 14 low single-bit X words take 4 phases (3 round trips)
// instead of 14.  A phase's vectors are single tile bits, except for a
// word that flips more than four bits: it gets a phase of its own whose
// first vector is its whole x, so any x inside the tile runs here.  A
// tile of fewer than four bits (a state of fewer than 16 amplitudes) pads
// with zero vectors: a thread then holds copies of one amplitude, which
// every word updates alike.
//
// Overlap: a 2^14 tile needs 128 KB of shared memory, so one block of 512
// threads (16 warps, two 16-amplitude sub-cubes each, 125 registers a
// thread) runs per SM, and load, compute and store of one tile do not
// overlap another's.  Within a block, each thread issues all 32 loads of
// a sub-cube before it computes, 64 KB in flight per SM, more than the
// ~25 KB an SM needs at the memory's rate and latency.  The word records
// (at most 1,024 a launch) are staged in shared memory once, beside the
// tile.  Measured on an H100 (700 W) at n = 24 with chip_smoke.py's
// phase_sweep_parts (back to back): a sweep with no word (one load, one
// store) takes 0.11-0.15 ms, 53-74 % of the bound, and every further
// phase adds about 0.05 ms, so phases, not words or bytes, set the time
// now (TFIM-24's 14 low words: 4 phases, 0.29 ms).  PR 2's kernel paid
// about 0.015 ms a word, so lists of many short phases run slower here.
// Tried and dropped: 1,024 threads of one sub-cube (spills at 64
// registers, slower), and 2^13 tiles (512 threads of 127 registers still
// fill an SM's register file, so no second block overlaps; no faster,
// and a gathered 2^13 tile holds only 2 low bits and ran 2x slower).
//
// Shared-memory layout: amplitude k of the tile sits at k ^ ((k >> 4) & 15)
// (float2), so that the 16 lanes of a half-warp, which differ in the four
// lowest bits outside the pivots, hit 16 different bank pairs.
//
// Products and sums are rounded one by one (__fmul_rn, __fadd_rn,
// __fsub_rn: no FMA contraction), word after word in list order, in the
// arithmetic of the plain torch version (ops/x_sweep.py::
// _pauli_rotation_pair), so the two agree to the last bit.  The sign uses
// the global index: the block's bits of z give one parity, the tile bits
// the rest.
//
// The diagonal half-phase.  A second-order Trotter substep is
// diag . sweeps . diag, diag = exp(-i dt/2 D) with D the sum of the
// Hamiltonian's diagonal words.  x_sweep_phase_kernel multiplies each
// amplitude by its state's (cos, -sin) right after the load, before the
// first word (kLoadSide), and after the last word, before the store
// (kStoreSide), or both in a launch that is the whole substep; the
// substep hands the leading half-phase to its first launch and the
// trailing one to its last, two products as the chain has, never one
// full-phase product.  Each product rounds as krylov/skqd.py::_diag_mul:
// re*hr - im*hi and re*hi + im*hr, each product and sum on its own
// (__fmul_rn, __fsub_rn, __fadd_rn), so a fused substep equals the chain
// of 2^n phase tables and elementwise passes bit for bit.  The phase is a
// compile-time variant (sweep_tiles<kPhased>), so x_sweep_kernel, the
// launch without a phase, compiles to the code it had before; the side is
// a launch argument read once a sub-cube (one phase kernel: each
// instantiation of the sweep costs nvcc seconds at first use).
//
// Class index: where a Hamiltonian's D takes few distinct angles (TFIM-28:
// 15, the even domain-wall counts), a state's phase is a class, one byte
// a state, up to 256 classes, read beside the state's amplitudes (4
// classes in one 4-byte load where the amplitudes move as float4).  The
// table of (cos, -sin) pairs, float32, classes in ascending angle, is
// staged in shared memory beside the word records.  Past 256 classes the
// substep keeps its 2^n tables (ops/x_sweep.py).
// Measured on an H100 (700 W) at TFIM-28 (chip_smoke.py --only
// half_phase, back to back): the substep's first launch takes 4.49 ms
// with its phase against 4.15 without, its last 3.07 against 2.85; the
// _diag_mul each phase replaces took 6.27 ms (six elementwise passes).
//
// The class build, two passes over the states, each state's float32
// angle worked out in registers in the arithmetic of
// krylov/skqd.py::_half_phase: D = 0, then D = D + (+-c_w) in word order,
// the angle f32(dt/2) * D, every sum and product rounded on its own.
// Pass 1 (phase_collect_kernel) puts the distinct angles into a bounded
// set: a block's own shared-memory hash set first, then a device-wide
// open-addressing set of 2^12 slots, counted; past the cap it stops and
// says so.  The host sorts them and takes cos and sin in float64.  Pass 2
// (phase_classify_kernel) writes each state's class, a binary search of
// the sorted angles staged in shared memory.  The class index is the only allocation of 2^n size.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRegBits = 4;                  // 16 amplitudes a sub-cube
constexpr int kCube = 1 << kRegBits;
constexpr int kMaxTileBits = 14;
constexpr int kCols = 8;                     // int32 fields of a word record
constexpr int kMaxWords = 1024;              // records staged in shared memory

// A word record, as ops/x_sweep.py::sweep_table packs it:
//   0 cos(theta) bits, 1 sin(theta) bits (float32, rounded from float64),
//   2 x (global), 3 z (global), 4 n_y mod 4,
//   5 x | z << 4 in register coordinates of the word's phase, | 1 << 8 on
//     the phase's first word, | the z bits outside the phase's pivots
//     (tile coords) << 16,
//   6 v0 | v1 << 16, 7 v2 | v3 << 16: the phase's register vectors (tile
//     coords).  Their pivots (lowest bits) are distinct, and with the
//     tile's other bits they span the tile; a zero vector pads a tile of
//     fewer than 4 bits.

__device__ __forceinline__ uint32_t pdep(uint32_t v, uint32_t mask) {
  uint32_t r = 0;
  for (uint32_t m = mask; m; m &= m - 1) {
    if (v & 1) r |= m & (0u - m);
    v >>= 1;
  }
  return r;
}

__device__ __forceinline__ uint32_t phys(uint32_t k) {
  return k ^ ((k >> 4) & 15u);
}

// +1 or -1 for register index j: bit j of a parity pattern
__device__ __forceinline__ float sign_of(uint32_t pattern, int j) {
  return __uint_as_float(0x3f800000u | (((pattern >> j) & 1u) << 31));
}

// bit j = parity(j & zr) ^ outside: the sign of the word at register
// index j, z restricted to the sub-cube's bits (zr) and the parity of the
// rest of the global index (outside)
__device__ __forceinline__ uint32_t parity_pattern(uint32_t zr,
                                                   uint32_t outside) {
  uint32_t p = outside ? 0xFFFFu : 0u;
  if (zr & 1u) p ^= 0xAAAAu;
  if (zr & 2u) p ^= 0xCCCCu;
  if (zr & 4u) p ^= 0xF0F0u;
  if (zr & 8u) p ^= 0xFF00u;
  return p;
}

// A pure-X word (z = 0, n_y = 0), the plain version's signless branch:
// new = (c * self.re + s * src.im, c * self.im - s * src.re).  XR, its x
// in register coordinates, is a template argument, so every register
// index is known at compile time.
template <int XR>
__device__ __forceinline__ void apply_x(float2 (&a)[kCube], float c,
                                        float s) {
  constexpr int kLow = XR & -XR;
#pragma unroll
  for (int j = 0; j < kCube; ++j) {
    if (j & kLow) continue;
    const float2 x = a[j];
    const float2 y = a[j ^ XR];
    a[j] = make_float2(__fadd_rn(__fmul_rn(c, x.x), __fmul_rn(s, y.y)),
                       __fsub_rn(__fmul_rn(c, x.y), __fmul_rn(s, y.x)));
    a[j ^ XR] = make_float2(__fadd_rn(__fmul_rn(c, y.x), __fmul_rn(s, x.y)),
                            __fsub_rn(__fmul_rn(c, y.y), __fmul_rn(s, x.x)));
  }
}

// cos t * self - i sin t * sign * i^ny * src, with i^ny * src as a swap
// (n_y odd) and the factors fr, fi = +-1, folded into gr = sign * fr and
// gi = sign * fi: products of +-1, exact, so the result has the plain
// version's bits.
template <bool SWAP>
__device__ __forceinline__ float2 rotate(float2 self, float2 src, float gr,
                                         float gi, float c, float s) {
  const float pr = __fmul_rn(gr, SWAP ? src.y : src.x);
  const float pi = __fmul_rn(gi, SWAP ? src.x : src.y);
  return make_float2(__fadd_rn(__fmul_rn(c, self.x), __fmul_rn(s, pi)),
                     __fsub_rn(__fmul_rn(c, self.y), __fmul_rn(s, pr)));
}

template <int XR, bool SWAP>
__device__ __forceinline__ void apply(float2 (&a)[kCube], uint32_t pattern,
                                      float fr, float fi, float c, float s) {
  constexpr int kLow = XR & -XR;
#pragma unroll
  for (int j = 0; j < kCube; ++j) {
    if (j & kLow) continue;
    const int j2 = j ^ XR;
    const float2 x = a[j];
    const float2 y = a[j2];
    // new[j] reads psi[j2]: the sign is that of j2's global index
    const float s2 = sign_of(pattern, j2);
    const float s1 = sign_of(pattern, j);
    a[j] = rotate<SWAP>(x, y, __fmul_rn(s2, fr), __fmul_rn(s2, fi), c, s);
    a[j2] = rotate<SWAP>(y, x, __fmul_rn(s1, fr), __fmul_rn(s1, fi), c, s);
  }
}

#define FGK_CASES(CALL)                                                  \
  switch (xr) {                                                          \
    case 1: CALL(1); break;   case 2: CALL(2); break;                    \
    case 3: CALL(3); break;   case 4: CALL(4); break;                    \
    case 5: CALL(5); break;   case 6: CALL(6); break;                    \
    case 7: CALL(7); break;   case 8: CALL(8); break;                    \
    case 9: CALL(9); break;   case 10: CALL(10); break;                  \
    case 11: CALL(11); break; case 12: CALL(12); break;                  \
    case 13: CALL(13); break; case 14: CALL(14); break;                   \
    case 15: CALL(15); break; default: break;                            \
  }

// One word on a sub-cube.  xr, zr: x and z in register coordinates;
// outside: the parity of z on the rest of the source's global index.
__device__ __forceinline__ void apply_word(float2 (&a)[kCube], int xr,
                                           uint32_t zr, uint32_t outside,
                                           bool pure_x, int ny, float c,
                                           float s) {
  if (pure_x) {
#define FGK_X(X) apply_x<X>(a, c, s)
    FGK_CASES(FGK_X)
#undef FGK_X
    return;
  }
  const uint32_t pattern = parity_pattern(zr, outside);
  const float fr = (ny == 1 || ny == 2) ? -1.0f : 1.0f;
  const float fi = ny >= 2 ? -1.0f : 1.0f;
  if (ny & 1) {
#define FGK_SWAP(X) apply<X, true>(a, pattern, fr, fi, c, s)
    FGK_CASES(FGK_SWAP)
#undef FGK_SWAP
  } else {
#define FGK_KEEP(X) apply<X, false>(a, pattern, fr, fi, c, s)
    FGK_CASES(FGK_KEEP)
#undef FGK_KEEP
  }
}

// offset of register index j: the xor of b[i] over the set bits i of j
__device__ __forceinline__ uint32_t spread(int j, const uint32_t (&b)[4]) {
  return ((j & 1) ? b[0] : 0u) ^ ((j & 2) ? b[1] : 0u)
         ^ ((j & 4) ? b[2] : 0u) ^ ((j & 8) ? b[3] : 0u);
}

// (a.x + i a.y) * (h.x + i h.y), each product and sum rounded on its own,
// as krylov/skqd.py::_diag_mul: re*hr - im*hi, re*hi + im*hr
__device__ __forceinline__ float2 phase_mul(float2 a, float2 h) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, h.x), __fmul_rn(a.y, h.y)),
                     __fadd_rn(__fmul_rn(a.x, h.y), __fmul_rn(a.y, h.x)));
}

// Every register amplitude of a sub-cube times its state's half-phase,
// from the (cos, -sin) table the block staged in shared memory; where the
// amplitudes move as float4, the classes of four consecutive states come
// in one 4-byte load.
__device__ __forceinline__ void apply_phase(float2 (&a)[kCube],
                                            const uint8_t* __restrict__ cls,
                                            const float2* tab, uint32_t gq,
                                            const uint32_t (&bg)[4],
                                            bool vec) {
  if (vec) {
#pragma unroll
    for (int h = 0; h < kCube / 4; ++h) {
      const uint32_t v = __ldg(reinterpret_cast<const unsigned int*>(
          cls + (gq ^ spread(4 * h, bg))));
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[4 * h + i] = phase_mul(a[4 * h + i], tab[(v >> (8 * i)) & 0xFFu]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kCube; ++j)
      a[j] = phase_mul(a[j], tab[__ldg(cls + (gq ^ spread(j, bg)))]);
  }
}

constexpr int kLoadSide = 1;     // half-phase after the load
constexpr int kStoreSide = 2;    // half-phase before the store

// The sweep of one launch.  Without kPhased it is the sweep alone (cls,
// phase, n_phase and at unused); with it, `at` (kLoadSide, kStoreSide or
// both, the same for every thread) adds the half-phase at either end.
template <bool kPhased>
__device__ __forceinline__ void sweep_tiles(
    const float* __restrict__ re_in, const float* __restrict__ im_in,
    float* __restrict__ re_out, float* __restrict__ im_out,
    const int32_t* __restrict__ words_in, int n_words, int n_qubits,
    uint32_t tile_mask, const uint8_t* __restrict__ cls,
    const float2* __restrict__ phase, int n_phase, int at) {
  extern __shared__ float2 amp[];          // the tile's (re, im) pairs
  const int tile_bits = __popc(tile_mask);
  // the word records, staged once: every thread reads each of them
  int32_t* words = reinterpret_cast<int32_t*>(amp + (1u << tile_bits));
  for (int k = threadIdx.x; k < n_words * kCols; k += blockDim.x)
    words[k] = words_in[k];
  // the phase table, staged beside the records
  float2* tab = reinterpret_cast<float2*>(words + n_words * kCols);
  if constexpr (kPhased) {
    for (int k = threadIdx.x; k < n_phase; k += blockDim.x)
      tab[k] = phase[k];
  }
  __syncthreads();
  const uint32_t tile_full = (1u << tile_bits) - 1u;
  const uint32_t all = n_qubits >= 32 ? ~0u : (1u << n_qubits) - 1u;
  const uint32_t base = pdep(blockIdx.x, all & ~tile_mask);
  const uint32_t cubes =
      tile_bits > kRegBits ? 1u << (tile_bits - kRegBits) : 1u;

  int w = 0;
  do {
    // the phase: words [w, end) on the register vectors v0..v3
    uint32_t vec_rec[2] = {0u, 0u};
    if (n_words) {
      vec_rec[0] = static_cast<uint32_t>(words[w * kCols + 6]);
      vec_rec[1] = static_cast<uint32_t>(words[w * kCols + 7]);
    } else {
      for (int i = 0; i < kRegBits && i < tile_bits; ++i)
        vec_rec[i >> 1] |= (1u << i) << (16 * (i & 1));
    }
    int end = n_words ? w + 1 : 0;
    while (end < n_words && !((words[end * kCols + 5] >> 8) & 1)) ++end;
    const bool first = w == 0;
    const bool last = end >= n_words;
    // register vector i: its tile offset bt, its swizzled shared-memory
    // offset qt and its global offset bg (phys and pdep are linear over
    // xor, so the offset of a sum of vectors is the xor of theirs), and
    // the pivots, which the cube's own bits leave free
    uint32_t bt[4], qt[4], bg[4], reg_t = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bt[i] = (vec_rec[i >> 1] >> (16 * (i & 1))) & 0xFFFFu;
      qt[i] = phys(bt[i]);
      bg[i] = pdep(bt[i], tile_mask);
      reg_t |= bt[i] & (0u - bt[i]);
    }
    const uint32_t rest_t = tile_full & ~reg_t;
    const uint32_t rest_g = pdep(rest_t, tile_mask);
    // float4 moves: registers 0..3 are 4 consecutive global indices
    const bool vec = bg[0] == 1u && bg[1] == 2u;
    // cube q = threadIdx.x + i * blockDim.x (blockDim.x a power of two):
    // its tile and global offsets are the thread's part, deposited once,
    // or-ed with the part of i on the remaining rest bits
    uint32_t hi_t = rest_t, hi_g = rest_g;
    for (uint32_t b = blockDim.x; b > 1; b >>= 1) {
      hi_t &= hi_t - 1;
      hi_g &= hi_g - 1;
    }
    const uint32_t kq0 = pdep(threadIdx.x, rest_t);
    const uint32_t gq0 = base | pdep(threadIdx.x, rest_g);

    for (uint32_t q = threadIdx.x, rep = 0; q < cubes;
         q += blockDim.x, ++rep) {
      const uint32_t kq = kq0 | pdep(rep, hi_t);
      const uint32_t gq = gq0 | pdep(rep, hi_g);
      const uint32_t pk = phys(kq);
      float2 a[kCube];
      if (first && vec) {
#pragma unroll
        for (int h = 0; h < kCube / 4; ++h) {
          const uint32_t g = gq ^ spread(4 * h, bg);
          const float4 r = __ldg(reinterpret_cast<const float4*>(re_in + g));
          const float4 i = __ldg(reinterpret_cast<const float4*>(im_in + g));
          a[4 * h + 0] = make_float2(r.x, i.x);
          a[4 * h + 1] = make_float2(r.y, i.y);
          a[4 * h + 2] = make_float2(r.z, i.z);
          a[4 * h + 3] = make_float2(r.w, i.w);
        }
      } else if (first) {
#pragma unroll
        for (int j = 0; j < kCube; ++j) {
          const uint32_t g = gq ^ spread(j, bg);
          a[j] = make_float2(__ldg(re_in + g), __ldg(im_in + g));
        }
      } else {
#pragma unroll
        for (int j = 0; j < kCube; ++j) a[j] = amp[pk ^ spread(j, qt)];
      }
      if constexpr (kPhased) {
        if (first && (at & kLoadSide))
          apply_phase(a, cls, tab, gq, bg, vec);
      }

      for (int v = w; v < end; ++v) {
        const int32_t* rec = words + v * kCols;
        const uint32_t zg = static_cast<uint32_t>(rec[3]);
        const uint32_t xz = static_cast<uint32_t>(rec[5]);
        const uint32_t zrest = xz >> 16;
        const int ny = rec[4] & 3;
        const uint32_t outside = (__popc(base & zg) + __popc(kq & zrest)) & 1;
        apply_word(a, xz & 15, (xz >> 4) & 15, outside, zg == 0 && ny == 0,
                   ny, __int_as_float(rec[0]), __int_as_float(rec[1]));
      }
      if constexpr (kPhased) {
        if (last && (at & kStoreSide))
          apply_phase(a, cls, tab, gq, bg, vec);
      }

      if (last && vec) {
#pragma unroll
        for (int h = 0; h < kCube / 4; ++h) {
          const uint32_t g = gq ^ spread(4 * h, bg);
          *reinterpret_cast<float4*>(re_out + g) = make_float4(
              a[4 * h].x, a[4 * h + 1].x, a[4 * h + 2].x, a[4 * h + 3].x);
          *reinterpret_cast<float4*>(im_out + g) = make_float4(
              a[4 * h].y, a[4 * h + 1].y, a[4 * h + 2].y, a[4 * h + 3].y);
        }
      } else if (last) {
#pragma unroll
        for (int j = 0; j < kCube; ++j) {
          const uint32_t g = gq ^ spread(j, bg);
          re_out[g] = a[j].x;
          im_out[g] = a[j].y;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kCube; ++j) amp[pk ^ spread(j, qt)] = a[j];
      }
    }
    if (!last) __syncthreads();
    w = end;
  } while (w < n_words);
}

__global__ void __launch_bounds__(kThreads, 1)
x_sweep_kernel(const float* __restrict__ re_in,
               const float* __restrict__ im_in,
               float* __restrict__ re_out, float* __restrict__ im_out,
               const int32_t* __restrict__ words_in, int n_words,
               int n_qubits, uint32_t tile_mask) {
  sweep_tiles<false>(re_in, im_in, re_out, im_out, words_in, n_words,
                     n_qubits, tile_mask, nullptr, nullptr, 0, 0);
}

__global__ void __launch_bounds__(kThreads, 1)
x_sweep_phase_kernel(const float* __restrict__ re_in,
                     const float* __restrict__ im_in,
                     float* __restrict__ re_out, float* __restrict__ im_out,
                     const int32_t* __restrict__ words_in, int n_words,
                     int n_qubits, uint32_t tile_mask,
                     const uint8_t* __restrict__ cls,
                     const float2* __restrict__ phase, int n_phase, int at) {
  sweep_tiles<true>(re_in, im_in, re_out, im_out, words_in, n_words,
                    n_qubits, tile_mask, cls, phase, n_phase, at);
}

// ---------------------------------------------------------------------------
// The class-index build
// ---------------------------------------------------------------------------

constexpr uint32_t kEmpty = 0xFFFFFFFFu;   // a free slot (a NaN's bits)
constexpr int kLocalSlots = 1024;          // a block's own set
constexpr int kLocalProbes = 16;
constexpr int kBuildThreads = 256;
constexpr int kMaxDiag = 2048;             // diagonal words staged a block
constexpr int kMaxClasses = 256;           // a one-byte class
constexpr int kOverflow = 1;               // state[1]: too many classes
constexpr int kMissing = 2;                // state[1]: an angle not found

// the float32 half-phase angle of state k, as krylov/skqd.py::_half_phase
// sums it: D = 0, then D = D + (+-c_w) in word order, each sum rounded,
// and the angle f32(dt/2) * D.  A zero angle is +0.
__device__ __forceinline__ float half_angle(uint32_t k, const int32_t* diag,
                                            int n_diag, float half_dt) {
  float d = 0.0f;
  for (int w = 0; w < n_diag; ++w) {
    const float c = __int_as_float(diag[2 * w]);
    const uint32_t z = static_cast<uint32_t>(diag[2 * w + 1]);
    d = __fadd_rn(d, (__popc(k & z) & 1) ? -c : c);
  }
  const float a = __fmul_rn(half_dt, d);
  return a == 0.0f ? 0.0f : a;
}

__device__ __forceinline__ uint32_t hash_key(uint32_t key) {
  return key * 2654435761u;
}

// adds key to the device-wide set; false once it holds max_classes keys
// (state[1] then says so) or has no free slot
__device__ bool insert_global(uint32_t* set, uint32_t mask, int* state,
                              int max_classes, uint32_t key) {
  if (*reinterpret_cast<volatile int*>(state + 1) & kOverflow) return false;
  uint32_t h = hash_key(key) & mask;
  for (uint32_t probe = 0; probe <= mask; ++probe) {
    const uint32_t cur = *reinterpret_cast<volatile uint32_t*>(set + h);
    if (cur == key) return true;
    if (cur == kEmpty) {
      const uint32_t old = atomicCAS(set + h, kEmpty, key);
      if (old == kEmpty) {
        if (atomicAdd(state, 1) >= max_classes) {
          atomicOr(state + 1, kOverflow);
          return false;
        }
        return true;
      }
      if (old == key) return true;
    }
    h = (h + 1) & mask;
  }
  atomicOr(state + 1, kOverflow);
  return false;
}

// adds key to the block's set; false when its probes find no room
__device__ __forceinline__ bool insert_local(uint32_t* local, uint32_t key) {
  uint32_t h = hash_key(key) >> (32 - 10);
  for (int probe = 0; probe < kLocalProbes; ++probe) {
    const uint32_t cur = local[h];
    if (cur == key) return true;
    if (cur == kEmpty) {
      const uint32_t old = atomicCAS(local + h, kEmpty, key);
      if (old == kEmpty || old == key) return true;
    }
    h = (h + 1) & (kLocalSlots - 1);
  }
  return false;
}

// Pass 1: the distinct angles of every state into `set` (slots: mask + 1,
// a power of two, all kEmpty), counted in state[0].  A NaN angle, or more
// than max_classes of them, sets kOverflow in state[1].
__global__ void __launch_bounds__(kBuildThreads)
phase_collect_kernel(const int32_t* __restrict__ diag_in, int n_diag,
                     int n_qubits, float half_dt, uint32_t* set,
                     uint32_t mask, int* state, int max_classes) {
  __shared__ int32_t diag[2 * kMaxDiag];
  __shared__ uint32_t local[kLocalSlots];
  for (int k = threadIdx.x; k < 2 * n_diag; k += blockDim.x)
    diag[k] = diag_in[k];
  for (int k = threadIdx.x; k < kLocalSlots; k += blockDim.x)
    local[k] = kEmpty;
  __syncthreads();
  const uint64_t dim = 1ull << n_qubits;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  uint32_t last = kEmpty;
  for (uint64_t k = blockIdx.x * blockDim.x + threadIdx.x; k < dim;
       k += stride) {
    const float a = half_angle(static_cast<uint32_t>(k), diag, n_diag,
                               half_dt);
    if (a != a) {
      atomicOr(state + 1, kOverflow);
      break;
    }
    const uint32_t key = __float_as_uint(a);
    if (key == last) continue;
    last = key;
    if (!insert_local(local, key)
        && !insert_global(set, mask, state, max_classes, key))
      break;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kLocalSlots; k += blockDim.x)
    if (local[k] != kEmpty) insert_global(set, mask, state, max_classes,
                                          local[k]);
}

// Pass 2: each state's class, the index of its angle in `keys` (n_keys
// distinct angles in ascending order).  An angle not there sets kMissing.
__global__ void __launch_bounds__(kBuildThreads)
phase_classify_kernel(const int32_t* __restrict__ diag_in, int n_diag,
                      int n_qubits, float half_dt,
                      const float* __restrict__ keys_in, int n_keys,
                      uint8_t* __restrict__ cls, int* state) {
  __shared__ int32_t diag[2 * kMaxDiag];
  __shared__ float keys[kMaxClasses];
  for (int k = threadIdx.x; k < 2 * n_diag; k += blockDim.x)
    diag[k] = diag_in[k];
  for (int k = threadIdx.x; k < n_keys; k += blockDim.x)
    keys[k] = keys_in[k];
  __syncthreads();
  const uint64_t dim = 1ull << n_qubits;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t k = blockIdx.x * blockDim.x + threadIdx.x; k < dim;
       k += stride) {
    const float a = half_angle(static_cast<uint32_t>(k), diag, n_diag,
                               half_dt);
    int lo = 0, hi = n_keys;          // the first key >= a
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (keys[mid] < a) lo = mid + 1; else hi = mid;
    }
    if (lo == n_keys || keys[lo] != a) {
      atomicOr(state + 1, kMissing);
      lo = 0;
    }
    cls[k] = static_cast<uint8_t>(lo);
  }
}

unsigned build_blocks(int n_qubits) {
  const unsigned long long want =
      ((1ull << n_qubits) + kBuildThreads - 1) / kBuildThreads;
  return want < 132u * 16u ? static_cast<unsigned>(want) : 132u * 16u;
}

// The launch of a sweep over 2^n_qubits amplitudes in tiles of tile_mask,
// with n_words records and extra_smem bytes staged beside them; false for
// arguments the kernel does not take.
bool sweep_shape(int n_qubits, unsigned tile_mask, int n_words,
                 size_t extra_smem, unsigned* blocks, int* threads,
                 size_t* smem) {
  const int tile_bits = __builtin_popcount(tile_mask);
  if (n_qubits < 1 || n_qubits > 31 || tile_bits < 1
      || tile_bits > kMaxTileBits || (tile_mask >> n_qubits) != 0
      || n_words < 0 || n_words > kMaxWords)
    return false;
  *smem = (sizeof(float2) << tile_bits) + sizeof(int32_t) * kCols * n_words
          + extra_smem;
  *blocks = 1u << (n_qubits - tile_bits);
  const int cubes = tile_bits > kRegBits ? 1 << (tile_bits - kRegBits) : 1;
  *threads = cubes < kThreads ? cubes : kThreads;
  return true;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the CUDA error code (0 on success).
// re_in, im_in, re_out, im_out hold 2^n_qubits floats each, 16-byte
// aligned; words holds n_words records of kCols int32 from
// ops/x_sweep.py::sweep_table for this tile_mask, at most 1,024.
// tile_mask has between 1 and 14 set bits, all below n_qubits <= 31.
int fgk_x_sweep(const float* re_in, const float* im_in, float* re_out,
                float* im_out, const void* words, int n_words, int n_qubits,
                unsigned tile_mask, void* stream) {
  unsigned blocks;
  int threads;
  size_t smem;
  if (!sweep_shape(n_qubits, tile_mask, n_words, 0, &blocks, &threads,
                   &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      x_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  x_sweep_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      re_in, im_in, re_out, im_out, static_cast<const int32_t*>(words),
      n_words, n_qubits, tile_mask);
  return static_cast<int>(cudaGetLastError());
}

// fgk_x_sweep with the half-phase: at = 1 after the load, 2 before the
// store, 3 both.  cls holds 2^n_qubits one-byte classes, each below
// n_phase <= 256; phase holds n_phase float32 (cos, -sin) pairs.
int fgk_x_sweep_phase(const float* re_in, const float* im_in, float* re_out,
                      float* im_out, const void* words, int n_words,
                      int n_qubits, unsigned tile_mask, const void* cls,
                      const void* phase, int n_phase, int at, void* stream) {
  unsigned blocks;
  int threads;
  size_t smem;
  if (at < 1 || at > (kLoadSide | kStoreSide) || n_phase < 1
      || n_phase > kMaxClasses
      || !sweep_shape(n_qubits, tile_mask, n_words,
                      sizeof(float2) * n_phase, &blocks, &threads, &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      x_sweep_phase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  x_sweep_phase_kernel<<<blocks, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      re_in, im_in, re_out, im_out, static_cast<const int32_t*>(words),
      n_words, n_qubits, tile_mask, static_cast<const uint8_t*>(cls),
      static_cast<const float2*>(phase), n_phase, at);
  return static_cast<int>(cudaGetLastError());
}

// Pass 1 of the class build over 2^n_qubits states (n_qubits <= 31):
// diag holds n_diag <= 2,048 (float32 bits of c, z) int32 pairs; set
// holds `slots` uint32 (a power of two), all 0xFFFFFFFF; state holds two
// int32, zero.  On return state[0] counts the distinct angles in set, and
// state[1] is nonzero when they were more than max_classes, or one was
// NaN.
int fgk_phase_collect(const void* diag, int n_diag, int n_qubits,
                      float half_dt, void* set, unsigned slots, void* state,
                      int max_classes, void* stream) {
  if (n_qubits < 0 || n_qubits > 31 || n_diag < 0 || n_diag > kMaxDiag
      || slots == 0 || (slots & (slots - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  phase_collect_kernel<<<build_blocks(n_qubits), kBuildThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(diag), n_diag, n_qubits, half_dt,
      static_cast<uint32_t*>(set), slots - 1, static_cast<int*>(state),
      max_classes);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2: each state's one-byte class from the n_keys <= 256 distinct
// angles of pass 1 in ascending order.  state[1] gets 2 when an angle is
// not among them.
int fgk_phase_classify(const void* diag, int n_diag, int n_qubits,
                       float half_dt, const void* keys, int n_keys, void* cls,
                       void* state, void* stream) {
  if (n_qubits < 0 || n_qubits > 31 || n_diag < 0 || n_diag > kMaxDiag
      || n_keys < 1 || n_keys > kMaxClasses)
    return static_cast<int>(cudaErrorInvalidValue);
  phase_classify_kernel<<<build_blocks(n_qubits), kBuildThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(diag), n_diag, n_qubits, half_dt,
      static_cast<const float*>(keys), n_keys, static_cast<uint8_t*>(cls),
      static_cast<int*>(state));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
