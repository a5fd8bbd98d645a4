// xnor-popcount binary GEMM over packed words for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/binary_contraction.py
// (binary_contraction, _kernel).  Its plain PyTorch version is
// repro_torch/kernels/ref.py::popcount_dot, which this kernel reproduces
// bit for bit.
//
//   out[m, n] = 2 * (popcount(xnor(x[m, :], w[n, :])) - pad_bits) - k_true
//   pad_bits  = KW * 32 - k_true
//
// Layout: x (M, KW) and w (N, KW) uint32 words (int32 views), row-major;
// out (M, N) int32.  The TPU kernel padded M, N and K to its block sizes;
// here the block masks its own ragged edges and takes no block knobs.
//
// Launch: one 64 x 64 output tile per block of 256 threads, 4 x 4 outputs
// a thread (rows ty + 16 i, columns tx + 16 j).  K is swept 32 words at a
// time: both operands' 64 x 32 word slabs are staged through shared memory
// (each warp loads one row's 32 words coalesced; rows padded to 33 words so
// the column reads are free of bank conflicts), then every thread does
// 16 __popc(~(a ^ b)) per K word into int32 registers.
//
// What bounds it on the card: operations.  A word-op is one xor, one not,
// one popcount and one add; the popcount issues at 16 per SM per clock on
// sm_90 (a quarter of the 64-lane int32 rate), so M*N*KW popcounts at
// 132 x 16 x 1.98 GHz is the bound.  Each staged word is reused 64 times,
// so the bytes are far below it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
binary_contraction_kernel(const uint32_t* __restrict__ x,
                          const uint32_t* __restrict__ w,
                          int32_t* __restrict__ out, int m, int n, int kw,
                          int k_true) {
  __shared__ uint32_t xs[kBM][kBK + 1];
  __shared__ uint32_t ws[kBN][kBK + 1];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < kw; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int kk = k0 + c;
      const int gm = m0 + r, gn = n0 + r;
      xs[r][c] = (gm < m && kk < kw) ? x[(size_t)gm * kw + kk] : 0u;
      ws[r][c] = (gn < n && kk < kw) ? w[(size_t)gn * kw + kk] : 0u;
    }
    __syncthreads();
    const int kend = min(kBK, kw - k0);
    for (int kk = 0; kk < kend; ++kk) {
      uint32_t a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[tx + 16 * j][kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += __popc(~(a[i] ^ b[j]));
    }
    __syncthreads();
  }

  const int pad_bits = kw * 32 - k_true;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < n) out[(size_t)gm * n + gn] = 2 * (acc[i][j] - pad_bits) - k_true;
    }
  }
}

}  // namespace

extern "C" int binary_contraction_launch(const void* x, const void* w,
                                         void* out, int m, int n, int kw,
                                         int k_true, void* stream) {
  if (m > 0 && n > 0) {
    const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
    binary_contraction_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const uint32_t*)w, (int32_t*)out, m, n, kw,
        k_true);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* binary_contraction_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
