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

namespace {

constexpr int kTableSize = 160;

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
    const int word_idx = bitpos >> 5;
    const uint32_t off = (uint32_t)(bitpos & 31);
    // a cursor past the last word reads 0; the next word clamps at W - 1
    // (the reference's one-hot gather and min(word_idx + 1, W - 1))
    const uint32_t w0 = word_idx < w_rows ? tile[word_idx * s_lanes + s] : 0u;
    const int nidx = min(word_idx + 1, w_rows - 1);
    const uint32_t w1 = tile[nidx * s_lanes + s];
    const uint32_t lo = off ? (w1 >> (32u - off)) : 0u;
    const uint32_t window = ((w0 << off) | lo) >> 20;   // 12-bit peek
    const uint32_t top3 = window >> 9;
    int32_t val;
    int len;
    if (top3 < 4) {                 // prefix 0: 5-bit index
      val = tab[(window >> 6) & 31];
      len = 6;
    } else if ((top3 >> 1) == 2) {  // prefix 10: 6-bit index
      val = tab[32 + ((window >> 4) & 63)];
      len = 8;
    } else if (top3 == 6) {         // prefix 110: 6-bit index
      val = tab[96 + ((window >> 3) & 63)];
      len = 9;
    } else {                        // prefix 111: escape, raw 9 bits
      val = (int32_t)(window & 511);
      len = 12;
    }
    dst[ci * s_lanes + s] = val;
    bitpos += len;
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
