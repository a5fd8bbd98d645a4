// Substream-parallel simplified-Huffman tile decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/huffman_decode.py
// (huffman_decode, _kernel and decode_step).  Its plain PyTorch version is
// repro_torch/kernels/ref.py::decode_tiled, which this kernel reproduces
// bit for bit, edge rules included.
//
// Layout: words (T, W, S) uint32 (passed as an int32 view), lane s of row w
// = word w of substream s, MSB-first.  Output (T, C, S) int32 9-bit
// sequences.  The 160-entry decode table holds node 0 at [0, 32), node 1
// at [32, 96) and node 2 at [96, 160); node 3 is the escape (raw 9 bits).
//
// The decode step itself is huffman_decode_step.cuh, which the fused
// decode + GEMM kernel shares.
//
// Launch: one block per tile, one thread per substream (S = 128 threads).
// The table sits in shared memory; thread s reads word w of its substream
// at tile[w * S + s], so each row is read coalesced across the block, and
// writes out[t, c, s] coalesced too.
//
// What bounds it on the card: the per-substream chain is serial — each
// code's length decides where the next one starts — so a thread does C
// dependent peek/classify/lookup steps (about 25 integer operations each).
// Those issue on the SM's 64 INT32 lanes, a quarter of the f32 rate, so
// the operations bound (C*S*25 int ops per tile) comes out about equal to
// the bytes bound (W*S*4 in, C*S*4 out per tile): the chain, not the
// bytes, is the limit to expect.  Tiles are independent: the design leans
// on having thousands of tiles in flight (one block each) to hide that
// chain's latency, not on wide loads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "huffman_decode_step.cuh"

namespace {

using repro_torch::huffman_decode_code;
using repro_torch::kTableSize;

__global__ void huffman_decode_kernel(const uint32_t* __restrict__ words,
                                      const int32_t* __restrict__ table,
                                      int32_t* __restrict__ out,
                                      int w_rows, int s_lanes, int c_codes) {
  __shared__ int32_t tab[kTableSize];
  for (int i = threadIdx.x; i < kTableSize; i += blockDim.x) tab[i] = table[i];
  __syncthreads();

  const int s = threadIdx.x;
  const uint32_t* tile = words + (size_t)blockIdx.x * w_rows * s_lanes;
  int32_t* dst = out + (size_t)blockIdx.x * c_codes * s_lanes;
  int bitpos = 0;
  for (int ci = 0; ci < c_codes; ++ci) {
    dst[ci * s_lanes + s] =
        huffman_decode_code(tile, w_rows, s_lanes, s, tab, bitpos);
  }
}

}  // namespace

extern "C" int huffman_decode_launch(const void* words, const void* table,
                                     void* out, int n_tiles, int w_rows,
                                     int s_lanes, int c_codes, void* stream) {
  if (n_tiles > 0) {
    huffman_decode_kernel<<<n_tiles, s_lanes, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, (const int32_t*)table, (int32_t*)out, w_rows,
        s_lanes, c_codes);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* huffman_decode_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
