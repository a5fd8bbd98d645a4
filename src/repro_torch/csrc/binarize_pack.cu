// Sign-binarise + sequence-aligned bit packing for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/binarize_pack.py
// (binarize_pack, _kernel).  Its plain PyTorch version is
// repro_torch/kernels/ref.py::binarize_pack, which this kernel reproduces
// bit for bit.
//
// Layout: x (M, K) float32 row-major -> out (M, G, 9) uint32 (written
// through an int32 view), G = ceil(K / 288).  Per 288-element K block,
// word j holds bit j of each of its 32 consecutive 9-element sequences:
// bit i of the word is sequence i, and a bit is 1 where x >= 0.  K is
// padded with -1, so padded positions give bit 0.
//
// Launch: one warp per (row, K block), 8 warps a block.  The warp reads
// the block's 288 floats coalesced (lane l reads elements l, l + 32, ...)
// into shared memory; lane i then reads its own sequence's 9 values at a
// stride of 9 floats, which is odd and so free of bank conflicts, and 9
// __ballot_sync calls give the 9 words directly.
//
// What bounds it on the card: bytes.  It reads each float once and writes
// one bit of output per float, with a compare and a ballot per element:
// far below the card's integer rate, so the HBM read of x is the limit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kBlockK = 288;   // 32 sequences x 9 taps
constexpr int kTaps = 9;

__global__ void binarize_pack_kernel(const float* __restrict__ x,
                                     uint32_t* __restrict__ out,
                                     long long pairs, int k, int g_blocks) {
  __shared__ float stage[kWarps][kBlockK];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long pair = (long long)blockIdx.x * kWarps + warp;
  if (pair >= pairs) return;               // warp-uniform: the whole warp
  const long long row = pair / g_blocks;
  const int k0 = (int)(pair % g_blocks) * kBlockK;
  const float* src = x + row * (long long)k;
  float* st = stage[warp];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    const int kk = k0 + lane + 32 * t;
    st[lane + 32 * t] = kk < k ? src[kk] : -1.0f;
  }
  __syncwarp();
  uint32_t mine = 0;
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    const uint32_t word =
        __ballot_sync(0xffffffffu, st[lane * kTaps + j] >= 0.0f);
    if (lane == j) mine = word;
  }
  if (lane < kTaps) out[pair * kTaps + lane] = mine;
}

}  // namespace

extern "C" int binarize_pack_launch(const void* x, void* out, long long m,
                                    int k, int g_blocks, void* stream) {
  const long long pairs = m * g_blocks;
  if (pairs > 0) {
    const long long blocks = (pairs + kWarps - 1) / kWarps;
    binarize_pack_kernel<<<(unsigned)blocks, kWarps * 32, 0,
                           (cudaStream_t)stream>>>(
        (const float*)x, (uint32_t*)out, pairs, k, g_blocks);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* binarize_pack_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
