// Fixed-degree ELL sparse matvec for subspace Hamiltonians, Hopper (sm_90a).
//
// Replaces flow_guided_krylov_tpu/ops/pallas_spmv.py::make_ell_spmv, the
// Pallas TPU kernel behind SKQD's "ell" Lanczos propagator.  For a stack
// of B in {1, 2} vectors (Re psi and Im psi in one launch):
//
//   out[b, i] = diag[i] * psi[b, i] + sum_s seg_s[b, i],
//   seg_s[b, i] = sum_{c in segment s} elems_t[c, i] * psi[b, tgt_t[c, i]]
//
// over tables stored transposed, (C, N) row-major, as in the JAX package.
// The C connections of a row are cut into S contiguous segments of
// L = ceil(C / S) (the last may be shorter or empty); ops/ell_spmv.py
// picks S from (N, C).
//
// What bounds it: memory.  The tables cross the bus once, 8 bytes per
// entry (70 MB at N2's 14,400 x 609), and psi is read and out written
// once: 0.021 ms at 3.35 TB/s on N2.  Each entry's psi gather depends on
// its target load, so the kernel needs many loads in flight to reach that.
// The first version (one thread per row) had 14,400 threads at N2, about
// 3 warps per SM, and ran at 12-13 % of the bound.  This design:
//
// * Splits each row's C range over S warps.  A block holds G groups of 32
//   consecutive rows, each group worked by S warps (one segment each), so
//   at a fixed c a warp's 32 lanes read 32 neighbouring table entries (one
//   128-byte line for elems, one for targets) and N2 runs N * S / 32 =
//   14,400 warps at S = 32.  Each lane loads U entries and their psi values
//   before it adds any of them, so a lane keeps U * B gathers in flight.
// * Combines the S partial sums of a row through shared memory in the
//   fixed order s = 0..S-1 after diag * psi: no atomics, one order.
// * Keeps psi on chip where it fits, as the Pallas kernel kept it in VMEM:
//   with PSI_SMEM the block copies psi (B * N floats, 115 KB at N2 with
//   B = 2) into shared memory once and gathers from there, not from L2.
//   Such a block is persistent (grid = resident blocks, a loop over row
//   groups), so psi is staged once per block and not once per row group.
//   Larger psi is gathered through L1/L2 with __ldg, one row group per
//   block.  The wrapper routes by size.
// * No cp.async or TMA ring for the table: each table entry is used once
//   and the U-deep register prefetch of every warp already keeps the
//   loads in flight; a ring would add a shared-memory pass and barriers
//   without cutting bytes.
//
// Rounding: each segment sums from 0 in c order, then out = diag * psi +
// seg_0 + seg_1 + ... in that order, with separately rounded products and
// sums (__fmul_rn / __fadd_rn: no FMA contraction).  ops/ell_spmv.py's
// plain version computes the same segments in the same order, so the two
// agree to the last bit.  No padding: rows past N are cut by a bounds
// check.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;   // 32 warps: G = 32 / S row groups

// psi[k] from shared memory (SMEM) or through the read-only cache
template <bool SMEM>
__device__ __forceinline__ float gather(const float* p, int64_t k) {
  if constexpr (SMEM) return p[k];
  else return __ldg(p + k);
}

template <int B, bool PSI_SMEM>
__global__ void __launch_bounds__(kThreads, 1)
ell_spmv_kernel(const float* __restrict__ diag,
                const float* __restrict__ elems_t,
                const int32_t* __restrict__ tgt_t,
                const float* __restrict__ psi,
                float* __restrict__ out,
                int64_t n, int64_t c, int segs) {
  // table rows fetched per group: U (element, target) pairs and B * U psi
  // gathers in flight per lane before the in-order accumulation
  constexpr int U = 16 / B;
  extern __shared__ float smem[];
  float* part = smem;                          // [warps][B][32] partial sums
  float* sp = smem + (kThreads / 32) * B * 32;  // [B][n] psi, PSI_SMEM only
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int groups = (blockDim.x >> 5) / segs;   // row groups per block
  const int g = warp / segs;
  const int s = warp % segs;
  const int64_t seg_len = (c + segs - 1) / segs;
  const int64_t c0 = s * seg_len < c ? s * seg_len : c;
  const int64_t c1 = c0 + seg_len < c ? c0 + seg_len : c;
  const int64_t n_groups = (n + 31) / 32;

  if (PSI_SMEM) {
    // stage psi with 16-byte loads, several in flight per thread (a
    // dependent load per element would leave the copy latency-bound)
    const int64_t total = B * n;
    int64_t done = 0;
    if ((reinterpret_cast<uintptr_t>(psi) & 15) == 0) {
      const float4* p4 = reinterpret_cast<const float4*>(psi);
      float4* s4 = reinterpret_cast<float4*>(sp);
      done = total / 4 * 4;
#pragma unroll 8
      for (int64_t k = threadIdx.x; k < total / 4; k += blockDim.x)
        s4[k] = __ldg(p4 + k);
    }
#pragma unroll 8
    for (int64_t k = done + threadIdx.x; k < total; k += blockDim.x)
      sp[k] = __ldg(psi + k);
    __syncthreads();
  }

  for (int64_t first = static_cast<int64_t>(blockIdx.x) * groups;
       first < n_groups; first += static_cast<int64_t>(gridDim.x) * groups) {
    const int64_t i = (first + g) * 32 + lane;
    const bool live = g < groups && i < n;
    float acc[B];
#pragma unroll
    for (int b = 0; b < B; ++b) acc[b] = 0.0f;
    if (live) {
      int64_t k = c0;
      for (; k + U <= c1; k += U) {
        float e[U];
        int32_t t[U];
        float v[B][U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          e[u] = __ldg(elems_t + (k + u) * n + i);
          t[u] = __ldg(tgt_t + (k + u) * n + i);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int b = 0; b < B; ++b)
            v[b][u] = gather<PSI_SMEM>(PSI_SMEM ? sp : psi, b * n + t[u]);
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int b = 0; b < B; ++b)
            acc[b] = __fadd_rn(acc[b], __fmul_rn(e[u], v[b][u]));
      }
      for (; k < c1; ++k) {
        const float e = __ldg(elems_t + k * n + i);
        const int32_t t = __ldg(tgt_t + k * n + i);
#pragma unroll
        for (int b = 0; b < B; ++b)
          acc[b] = __fadd_rn(acc[b], __fmul_rn(
              e, gather<PSI_SMEM>(PSI_SMEM ? sp : psi, b * n + t)));
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b) part[(warp * B + b) * 32 + lane] = acc[b];
    __syncthreads();
    if (s == 0 && live) {
#pragma unroll
      for (int b = 0; b < B; ++b) {
        float r = __fmul_rn(diag[i], psi[b * n + i]);
        for (int q = 0; q < segs; ++q)
          r = __fadd_rn(r, part[((warp + q) * B + b) * 32 + lane]);
        out[b * n + i] = r;
      }
    }
    __syncthreads();
  }
}

template <int B, bool PSI_SMEM>
int launch(const float* diag, const float* elems_t, const int32_t* tgt_t,
           const float* psi, float* out, int64_t n, int64_t c, int segs,
           cudaStream_t stream) {
  auto kernel = ell_spmv_kernel<B, PSI_SMEM>;
  size_t smem = sizeof(float) * (kThreads / 32) * B * 32;
  if (PSI_SMEM) smem += sizeof(float) * B * n;
  const int threads = 32 * segs * ((kThreads / 32) / segs);
  const int64_t n_groups = (n + 31) / 32;
  const int groups = threads / (32 * segs);
  int64_t blocks = (n_groups + groups - 1) / groups;
  // the launch's attributes and residency, asked once per (device, shared
  // memory size, block size) and kept: the queries cost host time on
  // every Lanczos step otherwise
  static int last_dev = -1, last_threads = 0, resident = 0;
  static size_t last_smem = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev != last_dev || smem != last_smem || threads != last_threads) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             static_cast<int>(smem))) != cudaSuccess
        || (err = cudaDeviceGetAttribute(
                &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess
        || (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, threads, smem)) != cudaSuccess)
      return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    last_dev = dev;
    last_smem = smem;
    last_threads = threads;
    resident = sms * per_sm;
  }
  if (PSI_SMEM && blocks > resident) blocks = resident;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      diag, elems_t, tgt_t, psi, out, n, c, segs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the CUDA error code (0 on success).
// All pointers are device pointers; psi and out hold b rows of n floats.
// segs in {1, 2, 4, 8, 16, 32}; psi_smem = 1 stages psi in shared memory
// (4 * b * n bytes must fit beside 4 KB-8 KB of partial sums).
int fgk_ell_spmv(const float* diag, const float* elems_t,
                 const int32_t* tgt_t, const float* psi, float* out,
                 int64_t n, int64_t c, int b, int segs, int psi_smem,
                 void* stream) {
  if (n <= 0) return 0;
  if (segs < 1 || segs > kThreads / 32 || (segs & (segs - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == 1)
    return psi_smem ? launch<1, true>(diag, elems_t, tgt_t, psi, out, n, c, segs, s)
                    : launch<1, false>(diag, elems_t, tgt_t, psi, out, n, c, segs, s);
  if (b == 2)
    return psi_smem ? launch<2, true>(diag, elems_t, tgt_t, psi, out, n, c, segs, s)
                    : launch<2, false>(diag, elems_t, tgt_t, psi, out, n, c, segs, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
