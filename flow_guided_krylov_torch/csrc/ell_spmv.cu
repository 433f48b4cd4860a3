// Fixed-degree ELL sparse matvec for subspace Hamiltonians, Hopper (sm_90a).
//
// Replaces flow_guided_krylov_tpu/ops/pallas_spmv.py::make_ell_spmv, the
// Pallas TPU kernel behind SKQD's "ell" Lanczos propagator.  For a stack
// of B in {1, 2} vectors (Re psi and Im psi in one launch):
//
//   out[b, i] = diag[i] * psi[b, i] + sum_{c=0}^{C-1} elems_t[c, i] * psi[b, tgt_t[c, i]]
//
// over tables stored transposed, (C, N) row-major, as in the JAX package.
//
// What bounds it: memory.  Each row streams C (element, target) pairs,
// 8 bytes each, and does 2B flops per pair; the psi gathers hit L2 (psi is
// 58 KB per vector at N = 14,400, 0.85 MB at N = 213,444).  The design
// follows from that: one thread per row, so that at a fixed c the 32
// threads of a warp read 32 neighbouring table entries (one 128-byte line
// for elems, one for targets); both vectors are accumulated from the same
// table read, so the tables cross the memory bus once per Lanczos step
// instead of twice.  With one thread per row a small table has few
// threads (14,400 for N2: a few warps per SM), so each thread loads a
// group of table entries and their psi values before it adds any of them,
// so that 16 psi gathers are in flight per thread.
//
// The sum starts from diag * psi and adds c = 0..C-1 in order with
// separately rounded products and sums (no FMA contraction), which is the
// order and rounding of the plain torch version, so the two agree to the
// last bit.  No padding: rows past N are cut by a bounds check.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int B>
__global__ void ell_spmv_kernel(const float* __restrict__ diag,
                                const float* __restrict__ elems_t,
                                const int32_t* __restrict__ tgt_t,
                                const float* __restrict__ psi,
                                float* __restrict__ out,
                                int64_t n, int64_t c) {
  // connection rows fetched per group: U table pairs and B * U = 16 psi
  // gathers in flight per thread before the in-order accumulation
  constexpr int U = 16 / B;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (i >= n) return;
  const float d = diag[i];
  float acc[B];
#pragma unroll
  for (int b = 0; b < B; ++b) acc[b] = __fmul_rn(d, psi[b * n + i]);
  int64_t k = 0;
  for (; k + U <= c; k += U) {
    float e[U];
    int32_t t[U];
    float g[B][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      e[u] = __ldg(elems_t + (k + u) * n + i);
      t[u] = __ldg(tgt_t + (k + u) * n + i);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int b = 0; b < B; ++b) g[b][u] = __ldg(psi + b * n + t[u]);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int b = 0; b < B; ++b)
        acc[b] = __fadd_rn(acc[b], __fmul_rn(e[u], g[b][u]));
  }
  for (; k < c; ++k) {
    const float e = __ldg(elems_t + k * n + i);
    const int32_t t = __ldg(tgt_t + k * n + i);
#pragma unroll
    for (int b = 0; b < B; ++b)
      acc[b] = __fadd_rn(acc[b], __fmul_rn(e, __ldg(psi + b * n + t)));
  }
#pragma unroll
  for (int b = 0; b < B; ++b) out[b * n + i] = acc[b];
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// All pointers are device pointers; psi and out hold b rows of n floats.
int fgk_ell_spmv(const float* diag, const float* elems_t,
                 const int32_t* tgt_t, const float* psi, float* out,
                 int64_t n, int64_t c, int b, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == 1) {
    ell_spmv_kernel<1><<<blocks, threads, 0, s>>>(diag, elems_t, tgt_t, psi,
                                                  out, n, c);
  } else if (b == 2) {
    ell_spmv_kernel<2><<<blocks, threads, 0, s>>>(diag, elems_t, tgt_t, psi,
                                                  out, n, c);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
