// One step of the simplified-Huffman substream decode, shared by the tile
// decode (huffman_decode.cu) and the fused decode + xnor-popcount GEMM
// (fused_decode_contraction.cu).
//
// Counterpart of decode_step in repro/kernels/huffman_decode.py; its plain
// PyTorch version is one iteration of repro_torch/kernels/ref.py::
// decode_tiled, edge rules included: a cursor past the last word reads 0,
// and the next-word index clamps at W - 1.
//
// The 160-entry decode table holds node 0 at [0, 32), node 1 at [32, 96)
// and node 2 at [96, 160); node 3 is the escape (raw 9 bits).  About 25
// integer operations a code (DECODE_OPS_PER_CODE in chip_smoke.py).

#pragma once

#include <stdint.h>

namespace repro_torch {

constexpr int kTableSize = 160;

// Decode the code at ``bitpos`` of substream ``s`` of a (W, S) tile whose
// row w holds word w of every substream; advance ``bitpos`` past it.
__device__ __forceinline__ int32_t huffman_decode_code(
    const uint32_t* __restrict__ tile, int w_rows, int s_lanes, int s,
    const int32_t* tab, int& bitpos) {
  const int word_idx = bitpos >> 5;
  const uint32_t off = (uint32_t)(bitpos & 31);
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
  bitpos += len;
  return val;
}

}  // namespace repro_torch
