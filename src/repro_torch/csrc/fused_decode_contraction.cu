// Fused Huffman decode + MSB-first repack + xnor-popcount GEMM for Hopper
// (sm_90a): the paper's datapath, where compressed weights are decoded on
// the way into the xnor/popcount contraction and never reach device memory
// uncompressed.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_decode_contraction.py
// (fused_decode_matmul, _kernel).  Its plain PyTorch version is
// repro_torch/kernels/ref.py::fused_decode_matmul, which this kernel
// reproduces bit for bit.
//
// Layout (repro_torch/core/compression.py::compress_gemm_fused):
//   words (NB, GB, W, S=128) uint32 -- tile (nb, gb) decodes, through S
//         substreams of C codes each, to 4C weight rows x 32 sequences (one
//         288-bit K block), row-major: code c of substream s is row
//         4c + s / 32, sequence s % 32;
//   x     (M, GB, 9) uint32 packed activations (word j = tap j of 32
//         sequences, bit i = sequence i);
//   out   (M, n_true) int32 = 2 * (acc - (GB * 288 - k_true)) - k_true.
//
// Launch: 128 threads a block (one per substream), grid (M tiles, NB).  A
// block owns the output tile of rows [m0, m0 + BM) x the 4C weight rows of
// its nb, BM = 32 * 128 / 4C, so each thread keeps 32 int32 accumulators:
// column t % 4C, rows t / 4C + i * (128 / 4C).  Per K block gb:
//   1. decode unit: thread s decodes its substream's C codes (the serial
//      cursor of huffman_decode_step.cuh, with the table in shared memory);
//      code c of warp v is row 4c + v, sequence = lane, so
//   2. packing unit: 9 __ballot_sync calls of the warp over bit 8 - j of
//      its lanes' values give the row's 9 MSB-first words, straight from
//      registers into a (4C, 9) word tile in shared memory;
//   3. the activations' (BM, 9) words of block gb are staged in shared
//      memory (row stride 9, odd, so reads are free of bank conflicts);
//   4. each thread adds sum_j __popc(~(x[r][j] ^ w[col][j])) to its 32
//      accumulators.
// The accumulators stay in registers across GB; the epilogue applies the
// +-1 correction.
//
// What bounds it on the card: operations.  The popcounts (M * 4C * NB * GB
// * 9) issue at 16 per SM per clock; the decode adds about 25 integer
// operations a code, once per tile in the bound.  This first version
// decodes each tile once per M tile (BM rows), not once overall: with
// C = 8 that is 200 decode operations a thread beside 288 popcounts, the
// price of keeping the decoded weights out of device memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "huffman_decode_step.cuh"

namespace {

using repro_torch::huffman_decode_code;
using repro_torch::kTableSize;

constexpr int kSub = 128;     // substreams = threads
constexpr int kAcc = 32;      // output accumulators a thread
constexpr int kTaps = 9;

__global__ void __launch_bounds__(kSub)
fused_decode_contraction_kernel(const uint32_t* __restrict__ words,
                                const uint32_t* __restrict__ x,
                                const int32_t* __restrict__ table,
                                int32_t* __restrict__ out, int m, int n_true,
                                int ngb, int w_rows, int codes, int k_true) {
  extern __shared__ uint32_t smem[];
  __shared__ int32_t tab[kTableSize];
  const int bn = 4 * codes;             // weight rows a tile
  const int bm = kAcc * kSub / bn;      // activation rows a block
  uint32_t* wp = smem;                  // (bn, 9) repacked weight words
  uint32_t* xs = smem + bn * kTaps;     // (bm, 9) activation words
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nb = blockIdx.y;
  const int m0 = blockIdx.x * bm;
  const int col = t % bn;
  const int row0 = t / bn;
  const int rstep = kSub / bn;
  for (int i = t; i < kTableSize; i += kSub) tab[i] = table[i];

  int acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0;

  for (int gb = 0; gb < ngb; ++gb) {
    __syncthreads();   // the table is in; the last step's readers are done
    const uint32_t* tile = words + ((size_t)nb * ngb + gb) * w_rows * kSub;
    int bitpos = 0;
    for (int ci = 0; ci < codes; ++ci) {
      const int32_t v = huffman_decode_code(tile, w_rows, kSub, t, tab,
                                            bitpos);
      uint32_t mine = 0;
#pragma unroll
      for (int j = 0; j < kTaps; ++j) {
        const uint32_t word =
            __ballot_sync(0xffffffffu, (v >> (8 - j)) & 1);
        if (lane == j) mine = word;
      }
      if (lane < kTaps) wp[(ci * 4 + warp) * kTaps + lane] = mine;
    }
    for (int i = t; i < bm * kTaps; i += kSub) {
      const int gm = m0 + i / kTaps;
      xs[i] = gm < m ? x[((size_t)gm * ngb + gb) * kTaps + i % kTaps] : 0u;
    }
    __syncthreads();
    uint32_t b[kTaps];
#pragma unroll
    for (int j = 0; j < kTaps; ++j) b[j] = wp[col * kTaps + j];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const uint32_t* a = xs + (row0 + i * rstep) * kTaps;
      int s = 0;
#pragma unroll
      for (int j = 0; j < kTaps; ++j) s += __popc(~(a[j] ^ b[j]));
      acc[i] += s;
    }
  }

  const int pad_bits = ngb * 288 - k_true;
  const int gn = nb * bn + col;
  if (gn >= n_true) return;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int gm = m0 + row0 + i * rstep;
    if (gm < m) out[(size_t)gm * n_true + gn] = 2 * (acc[i] - pad_bits) - k_true;
  }
}

}  // namespace

extern "C" int fused_decode_contraction_launch(
    const void* words, const void* x, const void* table, void* out, int m,
    int n_true, int nb, int ngb, int w_rows, int codes, int k_true,
    void* stream) {
  const int bn = 4 * codes;
  const int bm = kAcc * kSub / bn;
  if (m > 0 && nb > 0) {
    const dim3 grid((m + bm - 1) / bm, nb);
    const size_t smem = (size_t)(bn + bm) * kTaps * sizeof(uint32_t);
    fused_decode_contraction_kernel<<<grid, kSub, smem,
                                      (cudaStream_t)stream>>>(
        (const uint32_t*)words, (const uint32_t*)x, (const int32_t*)table,
        (int32_t*)out, m, n_true, ngb, w_rows, codes, k_true);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* fused_decode_contraction_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
