// Fused Huffman decode + MSB-first repack + binary GEMM on the tensor cores
// for Hopper (sm_90a): the paper's datapath, where compressed weights are
// decoded on the way into the +-1 contraction and never reach device
// memory uncompressed.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_decode_contraction.py
// (fused_decode_matmul, _kernel).  Its plain PyTorch version is
// repro_torch/kernels/ref.py::fused_decode_matmul, which this kernel
// reproduces bit for bit.
//
// Layout (repro_torch/core/compression.py::compress_gemm_fused):
//   words (NB, GB, W, S=128) uint32 -- tile (nb, gb) decodes, through S
//         substreams of C codes each, to bn = 4C weight rows x 32 sequences
//         (one 288-bit K block), row-major: code c of substream s is row
//         4c + s / 32, sequence s % 32;
//   x     (M, GB, 9) uint32 packed activations (word j = tap j of 32
//         sequences, bit i = sequence i): KW = 9 GB words a row;
//   out   (M, n_true) int32 = 2 * (matches - pad) - k_true, matches = the
//         xnor popcount over all GB * 288 bit positions, pad = GB * 288 -
//         k_true.
//
// Products: mma.sync m16n8k256 b1 x b1 -> s32 with .and.popc, on the
// packed words as they are (no expansion to bytes).  With pa and pb the
// set bits of an activation row and a weight row over the KW real words
// and pand = popcount(a AND w), matches = KW*32 - pa - pb + 2 pand, so
//   out = k_true - 2 pa - 2 pb + 4 pand
// exactly, whatever the padded bits hold.  The MMA gives pand; one more
// MMA per m16 tile against an all-ones B gives pa; pb is counted from the
// decoded slab.  One k256 step is 8 words of K; the MMA's k index is only
// a label, so A and B need just the same word -> k map: lane t4 = lane % 4
// feeds words 2 t4 and 2 t4 + 1 of the step (one 8-byte shared-memory
// load) as its k blocks t4 and 4 + t4.  Words past a row's end, or past a
// decoded chunk, are zero in A and in the slab, so they add nothing.  A
// probe (fused_decode_contraction_mma_rate) times this MMA against the
// int8 one (m16n8k32 s8) on the card: on sm_90a it runs at the s8 MMA's
// instruction rate with 8x its k.
//
// Launch: 256 threads, grid (m_splits, NB).  A block owns one N slab (the
// bn rows of one nb; a 32-column tile when bn < 32) and walks the M tiles
// split, split + m_splits, ... of BM rows; warp tile 64 x 32 (4 m16 x 4 n8
// MMAs a k step), 8 warps: BM = 512 / 256 / 128 at bn 32 / 64 / 128.
//   * Decode once a block: before its first M tile the block decodes the
//     slab's GB tiles into shared memory as (k step, column, 8) words: the
//     paper's decoded-sequence cache.  Threads 0-127 and 128-255 each take
//     a tile, and each thread decodes substream s of two tiles at once
//     (two independent chains through huffman_decode_step.cuh, the table
//     in shared memory), from the substream's words copied into its own
//     column of shared memory; 9 warp ballots repack each code, the words
//     past the chunk in its last k step are zeroed, and after a barrier
//     each column's set bits are added to pb.  m_splits
//     is only as large as the grid needs to fill the card, so a tile is
//     decoded m_splits times in all.  Where the whole slab does not fit in
//     shared memory (slab_tiles < GB), the block decodes a chunk of
//     slab_tiles tiles before each chunk of each M tile.
//   * Activations: one k step of an M tile ((BM, 8) words) a stage, staged
//     by cp.async (16-byte copies where KW and the chunks allow, else
//     4-byte) into a ring of 4 buffers, so three stages load under the
//     products of the fourth; rows past M are zero-filled.
// The launch plan (m_splits, slab_tiles, shared memory, copy width) is
// computed here (make_plan, from the same layout() the kernel carves its
// shared memory by); fused_decode_contraction_plan reports it.
//
// What bounds it on the card: M * N * GB * 288 multiply-accumulates on the
// binary tensor cores (8x the int8 dense rate of 1,979 Tops/s: the b1 MMA
// runs at the s8 instruction rate with 8x its k) or the bytes of x and of
// the int32 output, whichever is larger -- at ReActNet-A's shapes the
// bytes; the int8 form of the same work takes 8x the binary one, the
// popcount form 32x.  The decode costs about 25 integer operations a
// code, m_splits times a tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "binary_mma.cuh"
#include "huffman_decode_step.cuh"

namespace {

using repro_torch::cp_async;
using repro_torch::cp_async_commit;
using repro_torch::cp_async_wait;
using repro_torch::huffman_decode_code;
using repro_torch::mma_b1;
using repro_torch::kTableSize;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 128;       // substreams of a tile = threads of a half
constexpr int kTaps = 9;
constexpr int kWarpRows = 64;   // a warp's output tile: 4 m16 x 4 n8
constexpr int kWarpCols = 32;
constexpr int kStep = 8;        // words of K a k256 step
constexpr int kStages = 4;      // activation buffers in the ring
constexpr int kChains = 2;      // tiles a decoding thread interleaves
constexpr int kMaxW = 4;        // tile words a chain loads in registers
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may take

// Rows of an M tile: 8 warps of 64 x 32 output tiles over a BN-column slab.
template <int BN>
__host__ __device__ constexpr int block_rows() {
  return kWarpRows * (kWarps / (BN / kWarpCols));
}

// A block's dynamic shared memory, in 32-bit words from its start: the
// table, pb (bn,), the activation ring (stages, bm, 8), the slab (k steps
// of slab_tiles tiles, bn, 8) and the decode's substream words (chains,
// W, 256); ``words`` is the total.  The kernel carves its buffer by this
// and the launch sizes it by this.
struct Layout {
  int pb, xs, ws, wst, words;
};

__host__ __device__ inline Layout layout(int bn, int bm, int slab_tiles,
                                         int w_rows) {
  Layout l;
  l.pb = kTableSize;
  l.xs = l.pb + bn;
  l.ws = l.xs + kStages * bm * kStep;
  l.wst = l.ws + (slab_tiles * kTaps + kStep - 1) / kStep * bn * kStep;
  l.words = l.wst + kChains * w_rows * kThreads;
  return l;
}

// Where a stage is: the block's M tile k, chunk c of the slab, k step kl
// of the chunk.
struct Cursor {
  int k, c, kl;
};

template <int BN, bool kChunked>
__global__ void __launch_bounds__(kThreads, 2)
fused_decode_contraction_kernel(const uint32_t* __restrict__ words,
                                const uint32_t* __restrict__ x,
                                const int32_t* __restrict__ table,
                                int32_t* __restrict__ out, int m, int n_true,
                                int ngb, int w_rows, int codes, int k_true,
                                int slab_tiles, int m_splits, int vec) {
  constexpr int kWarpsN = BN / kWarpCols;
  constexpr int BM = block_rows<BN>();
  extern __shared__ uint32_t smem[];
  const Layout lay = layout(BN, BM, slab_tiles, w_rows);
  int32_t* tab = reinterpret_cast<int32_t*>(smem);
  int32_t* pb = reinterpret_cast<int32_t*>(smem + lay.pb);  // weight-row bits
  uint32_t* xs = smem + lay.xs;                // ring of (BM, 8) words
  uint32_t* ws = smem + lay.ws;                // slab (k step, BN, 8)
  uint32_t* wst = smem + lay.wst;              // (chains, W, 256) words

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int split = blockIdx.x;
  const int nb = blockIdx.y;
  const int bn = 4 * codes;
  const int kw = ngb * kTaps;
  const int n_mtiles = (m + BM - 1) / BM;
  const int my_tiles =
      split < n_mtiles ? (n_mtiles - split + m_splits - 1) / m_splits : 0;
  const int n_chunks = (ngb + slab_tiles - 1) / slab_tiles;
  const int r0 = (warp / kWarpsN) * kWarpRows;
  const int c0 = (warp % kWarpsN) * kWarpCols;

  for (int i = t; i < kTableSize; i += kThreads) tab[i] = table[i];

  auto chunk_words = [&](int c) {
    return min(slab_tiles, ngb - c * slab_tiles) * kTaps;
  };
  auto advance = [&](Cursor& q) {
    if (++q.kl * kStep >= chunk_words(q.c)) {
      q.kl = 0;
      if (++q.c == n_chunks) q.c = 0, ++q.k;
    }
  };

  // cp.async of a stage into ring buffer buf: words [w0, w0 + 8) of the
  // tile's rows, zero past the chunk (and past M).
  auto stage_in = [&](const Cursor& q, int buf) {
    const int row0 = (split + q.k * m_splits) * BM;
    const int w0 = q.c * slab_tiles * kTaps + q.kl * kStep;
    const int w_end = q.c * slab_tiles * kTaps + chunk_words(q.c);
    uint32_t* dst = xs + buf * BM * kStep;
    if (vec) {
      for (int e = t; e < BM * 2; e += kThreads) {
        const int gm = row0 + (e >> 1);
        const int w = w0 + 4 * (e & 1);
        const int n = gm < m ? min(max(w_end - w, 0), 4) : 0;
        cp_async(dst + 4 * e, n ? x + (size_t)gm * kw + w : x, 4 * n, true);
      }
    } else {
      for (int e = t; e < BM * kStep; e += kThreads) {
        const int gm = row0 + (e >> 3);
        const int w = w0 + (e & 7);
        const bool ok = gm < m && w < w_end;
        cp_async(dst + e, ok ? x + (size_t)gm * kw + w : x, ok ? 4 : 0,
                 false);
      }
    }
  };

  // Decode chunk c's tiles into the slab, zero its words past the chunk
  // (and pb at chunk 0).  Tile lt of a round is base + 2u + half for chain
  // u.
  auto decode = [&](int c) {
    const int gb0 = c * slab_tiles;
    const int count = min(slab_tiles, ngb - gb0);
    if (c == 0 && t < BN) pb[t] = 0;
    const int tail = count * kTaps % kStep;    // real words of the last step
    if (tail)
      for (int i = t; i < BN * (kStep - tail); i += kThreads)
        ws[((count * kTaps / kStep) * BN + i / (kStep - tail)) * kStep +
           tail + i % (kStep - tail)] = 0u;
    const int s = t & (kSub - 1);
    const int v = s >> 5;
    const int half = t >> 7;
    for (int base = 0; base < count; base += 2 * kChains) {
      uint32_t buf[kChains][kMaxW];
#pragma unroll
      for (int u = 0; u < kChains; ++u) {
        const int lt = min(base + 2 * u + half, count - 1);
        const uint32_t* tile =
            words + ((size_t)nb * ngb + gb0 + lt) * w_rows * kSub + s;
#pragma unroll
        for (int w = 0; w < kMaxW; ++w)
          buf[u][w] = w < w_rows ? tile[w * kSub] : 0u;
      }
#pragma unroll
      for (int u = 0; u < kChains; ++u) {
        const int lt = min(base + 2 * u + half, count - 1);
        const uint32_t* tile =
            words + ((size_t)nb * ngb + gb0 + lt) * w_rows * kSub + s;
        uint32_t* col = wst + u * w_rows * kThreads + t;
#pragma unroll
        for (int w = 0; w < kMaxW; ++w)
          if (w < w_rows) col[w * kThreads] = buf[u][w];
        for (int w = kMaxW; w < w_rows; ++w)
          col[w * kThreads] = tile[w * kSub];
      }
      int bitpos[kChains];
#pragma unroll
      for (int u = 0; u < kChains; ++u) bitpos[u] = 0;
      for (int ci = 0; ci < codes; ++ci) {
        int32_t val[kChains];
#pragma unroll
        for (int u = 0; u < kChains; ++u)
          val[u] = huffman_decode_code(wst + u * w_rows * kThreads, w_rows,
                                       kThreads, t, tab, bitpos[u]);
#pragma unroll
        for (int u = 0; u < kChains; ++u) {
          const int lt = base + 2 * u + half;
          if (lt >= count) continue;          // warp-uniform
          uint32_t mine = 0;
#pragma unroll
          for (int j = 0; j < kTaps; ++j) {
            const uint32_t word =
                __ballot_sync(0xffffffffu, (val[u] >> (8 - j)) & 1);
            if (lane == j) mine = word;
          }
          if (lane < kTaps) {
            const int w = lt * kTaps + lane;
            ws[((w >> 3) * BN + ci * 4 + v) * kStep + (w & 7)] = mine;
          }
        }
      }
    }
  };

  // pb += the set bits of chunk c's slab columns (after a barrier).
  auto count_ones = [&](int c) {
    const int col = t % BN;
    int ones = 0;
    for (int w = t / BN; w < chunk_words(c); w += kThreads / BN)
      ones += __popc(ws[((w >> 3) * BN + col) * kStep + (w & 7)]);
    atomicAdd(pb + col, ones);
  };

  Cursor pf = {0, 0, 0};
  for (int p = 0; p < kStages - 1; ++p) {
    if (pf.k < my_tiles) {
      stage_in(pf, p);
      advance(pf);
    }
    cp_async_commit();
  }
  __syncthreads();                      // the table is in
  if (!kChunked && my_tiles > 0) {      // the whole slab, once, before any
    decode(0);                          // accumulator is live
    __syncthreads();
    count_ones(0);
  }

  int acc[4][4][4], pa[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pa[i][e] = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q][e] = 0;
    }

  Cursor cur = {0, 0, 0};
  for (int s = 0; cur.k < my_tiles; ++s) {
    if (pf.k < my_tiles) {
      stage_in(pf, (s + kStages - 1) % kStages);
      advance(pf);
    }
    cp_async_commit();
    if (kChunked && cur.kl == 0) decode(cur.c);
    cp_async_wait<kStages - 1>();
    __syncthreads();                    // stage s and the slab are in
    if (kChunked && cur.kl == 0) count_ones(cur.c);
    const int row0 = (split + cur.k * m_splits) * BM;
    const bool live = row0 + r0 < m && c0 < bn;
    if (live) {
      const uint32_t* xa = xs + (s % kStages) * BM * kStep + 2 * t4;
      const uint32_t* wb = ws + cur.kl * BN * kStep + 2 * t4;
      uint2 a[4][2], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          a[i][h] = *reinterpret_cast<const uint2*>(
              xa + (r0 + 16 * i + 8 * h + g) * kStep);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        b[q] = *reinterpret_cast<const uint2*>(wb + (c0 + 8 * q + g) * kStep);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mma_b1(acc[i][q], a[i][0], a[i][1], b[q].x, b[q].y);
        mma_b1(pa[i], a[i][0], a[i][1], 0xffffffffu, 0xffffffffu);
      }
    }
    const bool last = cur.c == n_chunks - 1 &&
                      (cur.kl + 1) * kStep >= chunk_words(cur.c);
    if (last) {                         // the M tile is complete
      if (live) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + r0 + 16 * i + 8 * h + g;
            if (row >= m) continue;
            const int base = k_true - 2 * pa[i][2 * h];
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = c0 + 8 * q + 2 * t4 + e;
                const int gn = nb * bn + col;
                if (col < bn && gn < n_true)
                  out[(size_t)row * n_true + gn] =
                      base - 2 * pb[col] + 4 * acc[i][q][2 * h + e];
              }
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pa[i][e] = 0;
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q][e] = 0;
        }
    }
    __syncthreads();                    // readers done before reuse
    advance(cur);
  }
}

// The launch of one call: M split only as far as two blocks an SM need;
// the slab's tiles that fit in shared memory (all GB, or a chunk whose
// starts stay 16-byte aligned); 16-byte activation copies where KW and
// every chunk start allow (the launch also needs x 16-byte aligned).
struct Plan {
  int bm, m_splits, slab_tiles, smem_bytes, vec;
};

template <int BN>
Plan make_plan(int m, int nb, int ngb, int w_rows, int sms) {
  constexpr int BM = block_rows<BN>();
  Plan p;
  p.bm = BM;
  int tiles = ngb;
  while (tiles > 1 && layout(BN, BM, tiles, w_rows).words * 4 > kSmemMax)
    --tiles;
  if (tiles < ngb && tiles >= 4) tiles -= tiles % 4;
  p.slab_tiles = tiles;
  p.smem_bytes = layout(BN, BM, tiles, w_rows).words * 4;
  const int n_mtiles = std::max(1, (m + BM - 1) / BM);
  const int want = std::min((2 * sms + nb - 1) / nb, n_mtiles);
  const int per_split = (n_mtiles + want - 1) / want;
  p.m_splits = (n_mtiles + per_split - 1) / per_split;
  p.vec = ngb * kTaps % 4 == 0 && (tiles == ngb || tiles % 4 == 0);
  return p;
}

template <int BN, bool kChunked>
cudaError_t launch(const void* words, const void* x, const void* table,
                   void* out, int m, int n_true, int nb, int ngb, int w_rows,
                   int codes, int k_true, const Plan& p, int vec,
                   cudaStream_t stream) {
  static int attr_bytes = 48 * 1024;   // the default dynamic limit
  if (p.smem_bytes > attr_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_decode_contraction_kernel<BN, kChunked>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
    if (e != cudaSuccess) return e;
    attr_bytes = p.smem_bytes;
  }
  fused_decode_contraction_kernel<BN, kChunked>
      <<<dim3(p.m_splits, nb), kThreads, p.smem_bytes, stream>>>(
          (const uint32_t*)words, (const uint32_t*)x, (const int32_t*)table,
          (int32_t*)out, m, n_true, ngb, w_rows, codes, k_true, p.slab_tiles,
          p.m_splits, vec);
  return cudaGetLastError();
}

template <int BN, bool kChunked>
cudaError_t info(int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(
      &attr, fused_decode_contraction_kernel<BN, kChunked>);
  if (e != cudaSuccess) return e;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return cudaSuccess;
}

// The probe: back-to-back independent MMAs from registers, 16 a warp per
// iteration, kind 0 = m16n8k32 s8, 1 = m16n8k256 b1 .and.popc (the
// kernel's).
template <int KIND>
__global__ void __launch_bounds__(kThreads)
mma_rate_kernel(int iters, int* out) {
  int acc[16][4];
#pragma unroll
  for (int k = 0; k < 16; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[k][e] = 0;
  const uint32_t a0 = threadIdx.x, a1 = a0 * 3u, a2 = a0 * 5u, a3 = a0 * 7u;
  const uint32_t b0 = a0 * 11u, b1 = a0 * 13u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (KIND == 0)
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(acc[k][0]), "+r"(acc[k][1]), "+r"(acc[k][2]),
              "+r"(acc[k][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else
        mma_b1(acc[k], make_uint2(a0, a2), make_uint2(a1, a3), b0, b1);
    }
  }
  int s = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) s += acc[k][e];
  if (s == 0x12345678) out[0] = s;      // keeps the MMAs live
}

template <int BN>
cudaError_t dispatch(const void* words, const void* x, const void* table,
                     void* out, int m, int n_true, int nb, int ngb,
                     int w_rows, int codes, int k_true, int sms,
                     cudaStream_t stream) {
  const Plan p = make_plan<BN>(m, nb, ngb, w_rows, sms);
  if (p.smem_bytes > kSmemMax) return cudaErrorInvalidValue;
  const int vec = p.vec && ((uintptr_t)x & 15) == 0;
  if (p.slab_tiles < ngb)
    return launch<BN, true>(words, x, table, out, m, n_true, nb, ngb, w_rows,
                            codes, k_true, p, vec, stream);
  return launch<BN, false>(words, x, table, out, m, n_true, nb, ngb, w_rows,
                           codes, k_true, p, vec, stream);
}

template <int BN>
void report(int m, int nb, int ngb, int w_rows, int sms, int* plan) {
  const Plan p = make_plan<BN>(m, nb, ngb, w_rows, sms);
  plan[0] = p.bm, plan[1] = p.m_splits, plan[2] = p.slab_tiles;
  plan[3] = p.smem_bytes, plan[4] = p.vec;
}

}  // namespace

// bn = 4 * codes must divide 128; the slab kernel is the 32-column one for
// bn <= 32, and its chunked instantiation runs where the slab does not
// fit.  sms: the card's SM count, which the plan fills twice over.
// Anything the kernel does not take returns cudaErrorInvalidValue.
extern "C" int fused_decode_contraction_launch(
    const void* words, const void* x, const void* table, void* out, int m,
    int n_true, int nb, int ngb, int w_rows, int codes, int k_true, int sms,
    void* stream) {
  const int bn = 4 * codes;
  if (codes < 1 || 128 % bn || sms < 1 || nb > 65535)
    return (int)cudaErrorInvalidValue;
  if (m <= 0 || nb <= 0 || ngb <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (bn <= 32)
    return (int)dispatch<32>(words, x, table, out, m, n_true, nb, ngb, w_rows,
                             codes, k_true, sms, st);
  if (bn == 64)
    return (int)dispatch<64>(words, x, table, out, m, n_true, nb, ngb, w_rows,
                             codes, k_true, sms, st);
  return (int)dispatch<128>(words, x, table, out, m, n_true, nb, ngb, w_rows,
                            codes, k_true, sms, st);
}

// The plan a launch with these arguments takes: plan = {BM, m_splits,
// slab_tiles, dynamic shared memory bytes, 16-byte copies (for an aligned
// x)}.
extern "C" int fused_decode_contraction_plan(int m, int nb, int ngb,
                                             int w_rows, int codes, int sms,
                                             int* plan) {
  const int bn = 4 * codes;
  if (codes < 1 || 128 % bn || sms < 1 || nb < 1 || ngb < 1)
    return (int)cudaErrorInvalidValue;
  if (bn <= 32)
    report<32>(m, nb, ngb, w_rows, sms, plan);
  else if (bn == 64)
    report<64>(m, nb, ngb, w_rows, sms, plan);
  else
    report<128>(m, nb, ngb, w_rows, sms, plan);
  return 0;
}

// Registers and local (spill) bytes a thread of the slab kernel that a
// launch with ``codes`` runs, whole-slab (chunked = 0) or chunked.
extern "C" int fused_decode_contraction_info(int codes, int chunked,
                                             int* regs, int* local_bytes) {
  const int bn = 4 * codes;
  if (codes < 1 || 128 % bn) return (int)cudaErrorInvalidValue;
  if (bn <= 32)
    return (int)(chunked ? info<32, true>(regs, local_bytes)
                         : info<32, false>(regs, local_bytes));
  if (bn == 64)
    return (int)(chunked ? info<64, true>(regs, local_bytes)
                         : info<64, false>(regs, local_bytes));
  return (int)(chunked ? info<128, true>(regs, local_bytes)
                       : info<128, false>(regs, local_bytes));
}

// The MMA probe (kind 0 = s8, 1 = b1 .and.popc) on ``blocks`` blocks of 8
// warps, ``iters`` x 16 MMAs a warp; the caller times it.
extern "C" int fused_decode_contraction_mma_rate(int kind, int blocks,
                                                 int iters, void* out,
                                                 void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (kind == 0)
    mma_rate_kernel<0><<<blocks, kThreads, 0, st>>>(iters, (int*)out);
  else
    mma_rate_kernel<1><<<blocks, kThreads, 0, st>>>(iters, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_decode_contraction_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
