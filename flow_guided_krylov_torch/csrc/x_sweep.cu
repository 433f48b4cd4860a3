// Fused sweep of Pauli-word rotations over a statevector, Hopper (sm_90a).
//
// Replaces flow_guided_krylov_tpu/ops/pallas_trotter.py::make_x_sweep, the
// Pallas TPU kernel for the Trotter propagator of spin-lattice SKQD.  For a
// list of words (cos t, sin t, x, z, n_y), applied in order, each word maps
//
//   psi'[k] = cos t * psi[k] - i sin t * s_k * i^n_y * psi[k ^ x],
//   s_k = (-1)^popcount((k ^ x) & z),
//
// on a 2^n statevector held as separate re and im float32 arrays.  Every
// word's x lies below 2^T, so a word only mixes amplitudes inside one tile
// of 2^T consecutive indices: all the words then cost one read and one
// write of the state.
//
// What bounds it: the device-memory floor is 16 bytes per amplitude (re
// and im in, re and im out), 268 MB a sweep at n = 24.  One block owns one
// tile: it loads the tile into shared memory with 16-byte loads, applies
// every word there, and stores once.  The TPU kernel turned each XOR into
// a one-hot permutation matmul on its matrix unit; here an XOR is a
// shared-memory address.  For each word a thread owns the pairs (k, k ^ x)
// whose k has the lowest set bit of x clear: it reads both amplitudes,
// writes both new ones, and one __syncthreads() separates two words.  Each
// word then moves 16 bytes per amplitude through shared memory, and that
// bounds the kernel once a list has more than a few words: on an H100
// (700 W) a sweep at n = 24 costs about 0.015 ms per word on top of the one
// load and store, 0.34-0.36 ms for TFIM-24's 14 low words.
//
// T: the tile holds 2^T (re, im) pairs, 8 bytes each: 64 KB at T = 13 and
// 128 KB at T = 14, both above the 48 KB default, hence
// cudaFuncSetAttribute.  A larger T puts more words inside the tile (at
// TFIM-24, 14 of its 24 X words at T = 14) but leaves one resident block
// per SM instead of two, so loads and compute of neighbouring blocks
// overlap less.  Measured on an H100 (700 W) at n = 24: at the same 12
// words T = 13 takes 24 % less time than T = 14, but a TFIM-24 evolve
// takes 82.8 ms at T = 14 against 88.8 ms at T = 13, because T = 13 leaves
// one more word to the plain per-rotation path.  ops/x_sweep.py sets
// TILE_BITS = 14.
//
// Products and sums are rounded one by one (__fmul_rn, __fadd_rn,
// __fsub_rn: no FMA contraction), in the order of the plain torch version
// (ops/x_sweep.py::_pauli_rotation_pair), so the two agree to the
// last bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxTileBits = 14;

// One Pauli word, as ops/x_sweep.py packs it (five 4-byte fields).
struct Word {
  float c;        // cos(theta), rounded to float32
  float s;        // sin(theta), rounded to float32
  uint32_t x;     // flip mask, 0 < x < 2^T
  uint32_t z;     // sign mask
  int32_t ny;     // number of Y factors, mod 4
};

// cos t * self - i sin t * sign * i^ny * src, for (re, im) pairs.
__device__ __forceinline__ float2 rotate(float2 self, float2 src, float sign,
                                         int ny, float c, float s) {
  float pr, pi;   // i^ny * src
  switch (ny) {
    case 0: pr = src.x; pi = src.y; break;
    case 1: pr = -src.y; pi = src.x; break;
    case 2: pr = -src.x; pi = -src.y; break;
    default: pr = src.y; pi = -src.x; break;
  }
  pr = __fmul_rn(sign, pr);
  pi = __fmul_rn(sign, pi);
  return make_float2(__fadd_rn(__fmul_rn(c, self.x), __fmul_rn(s, pi)),
                     __fsub_rn(__fmul_rn(c, self.y), __fmul_rn(s, pr)));
}

__device__ __forceinline__ float parity_sign(uint32_t v) {
  return (__popc(v) & 1) ? -1.0f : 1.0f;
}

__global__ void __launch_bounds__(kThreads)
x_sweep_kernel(const float* __restrict__ re_in,
               const float* __restrict__ im_in,
               float* __restrict__ re_out, float* __restrict__ im_out,
               const Word* __restrict__ words, int n_words, int tile_bits) {
  extern __shared__ float2 amp[];          // the tile's (re, im) pairs
  const uint32_t tile = 1u << tile_bits;
  const uint32_t base = static_cast<uint32_t>(blockIdx.x) << tile_bits;

  if (tile >= 4) {
    const float4* r4 = reinterpret_cast<const float4*>(re_in + base);
    const float4* i4 = reinterpret_cast<const float4*>(im_in + base);
#pragma unroll 4
    for (uint32_t v = threadIdx.x; v < tile / 4; v += blockDim.x) {
      const float4 r = r4[v];
      const float4 i = i4[v];
      amp[4 * v + 0] = make_float2(r.x, i.x);
      amp[4 * v + 1] = make_float2(r.y, i.y);
      amp[4 * v + 2] = make_float2(r.z, i.z);
      amp[4 * v + 3] = make_float2(r.w, i.w);
    }
  } else {
    for (uint32_t k = threadIdx.x; k < tile; k += blockDim.x)
      amp[k] = make_float2(re_in[base + k], im_in[base + k]);
  }
  __syncthreads();

  for (int w = 0; w < n_words; ++w) {
    const Word wd = words[w];
    const uint32_t low = wd.x & (0u - wd.x);   // lowest set bit of x
    const int ny = wd.ny & 3;
#pragma unroll 4
    for (uint32_t p = threadIdx.x; p < tile / 2; p += blockDim.x) {
      // insert a zero at the position of `low` into p: k has that bit clear
      const uint32_t k = ((p & ~(low - 1)) << 1) | (p & (low - 1));
      const uint32_t k2 = k ^ wd.x;
      const float2 a = amp[k];
      const float2 b = amp[k2];
      // new[k] reads psi[k2], whose global index is base | k2, and back
      amp[k] = rotate(a, b, parity_sign((base | k2) & wd.z), ny, wd.c, wd.s);
      amp[k2] = rotate(b, a, parity_sign((base | k) & wd.z), ny, wd.c, wd.s);
    }
    __syncthreads();
  }

  if (tile >= 4) {
    float4* r4 = reinterpret_cast<float4*>(re_out + base);
    float4* i4 = reinterpret_cast<float4*>(im_out + base);
#pragma unroll 4
    for (uint32_t v = threadIdx.x; v < tile / 4; v += blockDim.x) {
      const float2 a0 = amp[4 * v + 0], a1 = amp[4 * v + 1];
      const float2 a2 = amp[4 * v + 2], a3 = amp[4 * v + 3];
      r4[v] = make_float4(a0.x, a1.x, a2.x, a3.x);
      i4[v] = make_float4(a0.y, a1.y, a2.y, a3.y);
    }
  } else {
    for (uint32_t k = threadIdx.x; k < tile; k += blockDim.x) {
      re_out[base + k] = amp[k].x;
      im_out[base + k] = amp[k].y;
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the CUDA error code (0 on success).
// re_in, im_in, re_out, im_out hold 2^n_qubits floats each, 16-byte
// aligned; words holds n_words Word records in device memory, every x
// inside the tile.  1 <= tile_bits <= min(n_qubits, 14), n_qubits <= 31.
int fgk_x_sweep(const float* re_in, const float* im_in, float* re_out,
                float* im_out, const void* words, int n_words, int n_qubits,
                int tile_bits, void* stream) {
  if (n_qubits < 1 || n_qubits > 31 || tile_bits < 1
      || tile_bits > kMaxTileBits || tile_bits > n_qubits || n_words < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float2) << tile_bits;
  cudaError_t err = cudaFuncSetAttribute(
      x_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = 1u << (n_qubits - tile_bits);
  const int pairs = 1 << (tile_bits - 1);
  const int threads = pairs < kThreads ? (pairs < 32 ? 32 : pairs) : kThreads;
  x_sweep_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      re_in, im_in, re_out, im_out, static_cast<const Word*>(words), n_words,
      tile_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
