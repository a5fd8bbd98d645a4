// xnor-popcount binary GEMM over packed words on the binary tensor cores
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/binary_contraction.py
// (binary_contraction, _kernel).  Its plain PyTorch version is
// repro_torch/kernels/ref.py::popcount_dot, which this kernel reproduces
// bit for bit.
//
//   out[m, n] = 2 * (popcount(xnor(x[m, :], w[n, :])) - pad_bits) - k_true
//   pad_bits  = KW * 32 - k_true
//
// Layout: x (M, KW) and w (N, KW) uint32 words (int32 views), row-major,
// any KW; out (M, N) int32.  ReActNet-A runs its 3x3 convs (KW = 9 Cin /
// 32, N = Cin) and its 1x1 convs (KW = 9 Cin / 288, N = Cout) through it.
//
// Products: mma.sync m16n8k256 b1 x b1 -> s32 with .and.popc on the words
// as they are (binary_mma.cuh, with the fused kernel's word -> k map).
// With pa and pb the set bits of an activation row and a weight row over
// its KW words and pand = popcount(a AND w), matches = KW*32 - pa - pb +
// 2 pand, so
//   out = k_true - 2 pa - 2 pb + 4 pand
// exactly, whatever the padded bits hold.  The MMA gives pand; pb is
// counted once, from the staged slab; pa is counted from each staged k
// step by one thread a row.  Words past KW in the last k step are zero in
// both operands, so they add nothing.
//
// Launch: 256 threads, grid (m_splits, N slabs).  A block owns one slab of
// BN = 32, 64 or 128 weight columns (the smallest that holds N, else 128)
// and walks the M tiles split, split + m_splits, ... of BM rows; warp tile
// 64 x 32 (4 m16 x 4 n8 MMAs a k step), 8 warps: BM = 512 / 256 / 128 at
// BN 32 / 64 / 128.
//   * Weights staged once a block: before its first M tile the block
//     copies its slab, (k step, column, 8) words, into shared memory by
//     cp.async and counts each column's set bits into pb.  m_splits is
//     only as large as the grid needs to fill the card (the blocks an SM
//     holds, times the SMs), so a slab is read m_splits times in all.
//     Where the whole slab does not fit in shared memory beside the ring
//     (slab_steps < the k steps of a row), the block stages a chunk of
//     slab_steps k steps before each chunk of each M tile, and counts pb
//     during its first M tile.
//   * Activations: one k step of an M tile ((BM, 8) words) a stage, staged
//     by cp.async (16-byte copies where KW % 4 == 0, else 4-byte) into a
//     ring of 4 buffers, so three stages load under the products of the
//     fourth; rows past M and words past KW are zero-filled.
//   * Output: each warp passes its tile through shared memory 8 rows at a
//     time, and a quarter-warp writes a row's 32 columns as 16-byte
//     stores: whole 128-byte lines (4-byte stores where N % 4 != 0 or at
//     the ragged edge).
// The launch plan (BN, BM, m_splits, slab_steps, shared memory, copy
// width) is computed here (make_plan, from the same layout() the kernel
// carves its shared memory by); binary_contraction_plan reports it.
//
// What bounds it on the card: the bytes of x, w and the int32 output at
// every ReActNet-A shape (the 1x1 convs' output is 93% of their bytes);
// the M * N * KW * 32 multiply-accumulates on the binary tensor cores
// (8x the int8 dense rate) take a tenth of that.  The first version's
// __popc(~(a ^ b)) on CUDA cores was bound by the popcount's issue rate,
// 6x the bytes.  Where this one stays above the bytes (long K, one M
// tile a block), the k loop holds it: chip_smoke.py's k sweep times a k
// step at about 1.1 us a block on an H100 (PERF.md), far above the issue
// time of its 128 MMAs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "binary_mma.cuh"

namespace {

using repro_torch::cp_async;
using repro_torch::cp_async_commit;
using repro_torch::cp_async_wait;
using repro_torch::mma_b1;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = 64;   // a warp's output tile: 4 m16 x 4 n8
constexpr int kWarpCols = 32;
constexpr int kStep = 8;        // words of K a k256 step
constexpr int kStages = 4;      // activation buffers in the ring
constexpr int kEpiRows = 8;     // output rows a warp stages at a time
constexpr int kEpiStride = 40;  // their words a row: 32 + 8, so the
                                // fragments' 8-byte writes miss no bank
constexpr int kMaxBlocksSM = 2;   // by registers: 128 a thread
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may take
constexpr int kSmemSM = 233472;   // shared memory of an SM, 1 KB a block
                                  // reserved by the runtime

// Rows of an M tile: 8 warps of 64 x 32 output tiles over a BN-column slab.
template <int BN>
__host__ __device__ constexpr int block_rows() {
  return kWarpRows * (kWarps / (BN / kWarpCols));
}

// A block's dynamic shared memory, in 32-bit words from its start: pb
// (bn,), pa (bm,), the activation ring (stages, bm, 8), the slab
// (slab_steps, bn, 8) and each warp's output rows (warps, 8, 40); ``words``
// is the total.  The kernel carves its buffer by this and the launch
// sizes it by this.
struct Layout {
  int pa, xs, ws, eb, words;
};

__host__ __device__ inline Layout layout(int bn, int bm, int slab_steps) {
  Layout l;
  l.pa = bn;
  l.xs = l.pa + bm;
  l.ws = l.xs + kStages * bm * kStep;
  l.eb = l.ws + slab_steps * bn * kStep;
  l.words = l.eb + kWarps * kEpiRows * kEpiStride;
  return l;
}

// Where a stage is: the block's M tile k, k step s of its rows.
struct Cursor {
  int k, s;
};

__device__ __forceinline__ int popc8(const uint32_t* p) {
  const uint4 u = reinterpret_cast<const uint4*>(p)[0];
  const uint4 v = reinterpret_cast<const uint4*>(p)[1];
  return __popc(u.x) + __popc(u.y) + __popc(u.z) + __popc(u.w) +
         __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

template <int BN, bool kChunked>
__global__ void __launch_bounds__(kThreads, kMaxBlocksSM)
binary_contraction_kernel(const uint32_t* __restrict__ x,
                          const uint32_t* __restrict__ w,
                          int32_t* __restrict__ out, int m, int n, int kw,
                          int k_true, int slab_steps, int m_splits, int vec) {
  constexpr int kWarpsN = BN / kWarpCols;
  constexpr int BM = block_rows<BN>();
  constexpr int kRowsT = (BM + kThreads - 1) / kThreads;  // pa rows a thread
  extern __shared__ __align__(16) uint32_t smem[];
  const Layout lay = layout(BN, BM, slab_steps);
  int32_t* pb = reinterpret_cast<int32_t*>(smem);  // weight-column bits
  int32_t* pas = reinterpret_cast<int32_t*>(smem + lay.pa);  // row bits
  uint32_t* xs = smem + lay.xs;                    // ring of (BM, 8) words
  uint32_t* ws = smem + lay.ws;                    // slab (k step, BN, 8)

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int split = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int bn = min(BN, n - n0);              // real columns of the slab
  const int steps = max(1, (kw + kStep - 1) / kStep);
  const int n_mtiles = (m + BM - 1) / BM;
  const int my_tiles =
      split < n_mtiles ? (n_mtiles - split + m_splits - 1) / m_splits : 0;
  const int r0 = (warp / kWarpsN) * kWarpRows;
  const int c0 = (warp % kWarpsN) * kWarpCols;
  uint32_t* eb = smem + lay.eb + warp * kEpiRows * kEpiStride;

  // cp.async of k steps [s0, s0 + count) of the slab into ws, zero past
  // KW and past N.
  auto stage_slab = [&](int s0, int count) {
    if (vec) {
      for (int e = t; e < count * BN * 2; e += kThreads) {
        const int col = (e >> 1) % BN;
        const int wd = (s0 + (e >> 1) / BN) * kStep + 4 * (e & 1);
        const int nw = col < bn ? min(max(kw - wd, 0), 4) : 0;
        cp_async(ws + 4 * e, nw ? w + (size_t)(n0 + col) * kw + wd : w,
                 4 * nw, true);
      }
    } else {
      for (int e = t; e < count * BN * kStep; e += kThreads) {
        const int col = (e >> 3) % BN;
        const int wd = (s0 + (e >> 3) / BN) * kStep + (e & 7);
        const bool ok = col < bn && wd < kw;
        cp_async(ws + e, ok ? w + (size_t)(n0 + col) * kw + wd : w,
                 ok ? 4 : 0, false);
      }
    }
  };

  // pb += the set bits of the staged slab's columns (after a barrier).
  auto count_ones = [&](int count) {
    for (int e = t; e < count * BN; e += kThreads)
      atomicAdd(pb + e % BN, popc8(ws + e * kStep));
  };

  // cp.async of a stage into ring buffer buf: words [8 s, 8 s + 8) of the
  // tile's rows, zero past KW and past M.
  auto stage_in = [&](const Cursor& q, int buf) {
    const int row0 = (split + q.k * m_splits) * BM;
    const int w0 = q.s * kStep;
    uint32_t* dst = xs + buf * BM * kStep;
    if (vec) {
      for (int e = t; e < BM * 2; e += kThreads) {
        const int gm = row0 + (e >> 1);
        const int wd = w0 + 4 * (e & 1);
        const int nw = gm < m ? min(max(kw - wd, 0), 4) : 0;
        cp_async(dst + 4 * e, nw ? x + (size_t)gm * kw + wd : x, 4 * nw,
                 true);
      }
    } else {
      for (int e = t; e < BM * kStep; e += kThreads) {
        const int gm = row0 + (e >> 3);
        const int wd = w0 + (e & 7);
        const bool ok = gm < m && wd < kw;
        cp_async(dst + e, ok ? x + (size_t)gm * kw + wd : x, ok ? 4 : 0,
                 false);
      }
    }
  };

  auto advance = [&](Cursor& q) {
    if (++q.s == steps) q.s = 0, ++q.k;
  };

  if (t < BN) pb[t] = 0;
  if (!kChunked && my_tiles > 0) stage_slab(0, steps);
  cp_async_commit();                    // the slab's group (or none)
  Cursor pf = {0, 0};
  for (int p = 0; p < kStages - 1; ++p) {
    if (pf.k < my_tiles) {
      stage_in(pf, p);
      advance(pf);
    }
    cp_async_commit();
  }
  if (!kChunked && my_tiles > 0) {      // the whole slab, once
    cp_async_wait<kStages - 1>();       // its group is the oldest
    __syncthreads();
    count_ones(steps);
  }

  int par[kRowsT];                      // pa of rows t, t + 256, ...
#pragma unroll
  for (int r = 0; r < kRowsT; ++r) par[r] = 0;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][q][e] = 0;

  const bool quads = (n & 3) == 0;      // 16-byte aligned column quads
  Cursor cur = {0, 0};
  for (int it = 0; cur.k < my_tiles; ++it) {
    const int kl = kChunked ? cur.s % slab_steps : cur.s;
    if (kChunked && kl == 0) {          // the next chunk of the slab; every
      stage_slab(cur.s, min(slab_steps, steps - cur.s));  // warp is done
      cp_async_commit();                // with the last (end-of-step
      cp_async_wait<0>();               // barrier)
      __syncthreads();
      if (cur.k == 0) count_ones(min(slab_steps, steps - cur.s));
    }
    if (pf.k < my_tiles) {
      stage_in(pf, (it + kStages - 1) % kStages);
      advance(pf);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();                    // stage it (and pb) are in
    const uint32_t* stage = xs + (it % kStages) * BM * kStep;
#pragma unroll
    for (int r = 0; r < kRowsT; ++r)
      if (t + kThreads * r < BM)
        par[r] += popc8(stage + (t + kThreads * r) * kStep);
    const int row0 = (split + cur.k * m_splits) * BM;
    const bool live = row0 + r0 < m && c0 < bn;
    if (live) {
      const uint32_t* xa = stage + 2 * t4;
      const uint32_t* wb = ws + kl * BN * kStep + 2 * t4;
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
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mma_b1(acc[i][q], a[i][0], a[i][1], b[q].x, b[q].y);
    }
    if (cur.s == steps - 1) {           // the M tile is complete
#pragma unroll
      for (int r = 0; r < kRowsT; ++r) {
        if (t + kThreads * r < BM) pas[t + kThreads * r] = par[r];
        par[r] = 0;
      }
      __syncthreads();                  // pa is in
      if (live) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int lrow = r0 + 16 * i + 8 * h;  // the 8 rows' first
            const int base = k_true - 2 * pas[lrow + g];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int col = c0 + 8 * q + 2 * t4;
              *reinterpret_cast<int2*>(eb + g * kEpiStride + 8 * q + 2 * t4) =
                  make_int2(base - 2 * pb[col] + 4 * acc[i][q][2 * h],
                            base - 2 * pb[col + 1] + 4 * acc[i][q][2 * h + 1]);
            }
            __syncwarp();
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {  // a quarter-warp a row
              const int er = 4 * rr + (lane >> 3);
              const int row = row0 + lrow + er;
              const int col = c0 + 4 * (lane & 7);
              const int4 v = *reinterpret_cast<const int4*>(
                  eb + er * kEpiStride + 4 * (lane & 7));
              if (row < m) {
                int32_t* o = out + (size_t)row * n + n0 + col;
                if (quads && col + 3 < bn) {
                  *reinterpret_cast<int4*>(o) = v;
                } else {
                  if (col < bn) o[0] = v.x;
                  if (col + 1 < bn) o[1] = v.y;
                  if (col + 2 < bn) o[2] = v.z;
                  if (col + 3 < bn) o[3] = v.w;
                }
              }
            }
            __syncwarp();
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][q][e] = 0;
    }
    __syncthreads();                    // readers done before reuse
    advance(cur);
  }
}

// The launch of one call: N in slabs of BN columns; the k steps of the
// slab that fit in shared memory beside the ring (all of them, or a
// chunk); M split only as far as the blocks the SMs hold need; 16-byte
// copies where KW allows (the launch also needs x and w 16-byte aligned).
struct Plan {
  int bn, bm, n_slabs, m_splits, slab_steps, smem_bytes, vec;
};

template <int BN>
Plan make_plan(int m, int n, int kw, int sms) {
  constexpr int BM = block_rows<BN>();
  Plan p;
  p.bn = BN;
  p.bm = BM;
  p.n_slabs = (n + BN - 1) / BN;
  const int steps = std::max(1, (kw + kStep - 1) / kStep);
  int chunk = steps;
  while (chunk > 1 && layout(BN, BM, chunk).words * 4 > kSmemMax) --chunk;
  p.slab_steps = chunk;
  p.smem_bytes = layout(BN, BM, chunk).words * 4;
  const int per_sm = std::max(
      1, std::min(kMaxBlocksSM, kSmemSM / (p.smem_bytes + 1024)));
  const int n_mtiles = std::max(1, (m + BM - 1) / BM);
  const int want =
      std::min((per_sm * sms + p.n_slabs - 1) / p.n_slabs, n_mtiles);
  const int per_split = (n_mtiles + want - 1) / want;
  p.m_splits = (n_mtiles + per_split - 1) / per_split;
  p.vec = kw % 4 == 0;
  return p;
}

Plan plan_for(int m, int n, int kw, int sms) {
  if (n <= 32) return make_plan<32>(m, n, kw, sms);
  if (n <= 64) return make_plan<64>(m, n, kw, sms);
  return make_plan<128>(m, n, kw, sms);
}

template <int BN, bool kChunked>
cudaError_t launch(const void* x, const void* w, void* out, int m, int n,
                   int kw, int k_true, const Plan& p, int vec,
                   cudaStream_t stream) {
  static int attr_bytes = 48 * 1024;   // the default dynamic limit
  if (p.smem_bytes > attr_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        binary_contraction_kernel<BN, kChunked>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
    if (e != cudaSuccess) return e;
    attr_bytes = p.smem_bytes;
  }
  binary_contraction_kernel<BN, kChunked>
      <<<dim3(p.m_splits, p.n_slabs), kThreads, p.smem_bytes, stream>>>(
          (const uint32_t*)x, (const uint32_t*)w, (int32_t*)out, m, n, kw,
          k_true, p.slab_steps, p.m_splits, vec);
  return cudaGetLastError();
}

template <int BN>
cudaError_t dispatch(const void* x, const void* w, void* out, int m, int n,
                     int kw, int k_true, const Plan& p, cudaStream_t stream) {
  const int vec = p.vec && ((uintptr_t)x & 15) == 0 &&
                  ((uintptr_t)w & 15) == 0;
  const int steps = std::max(1, (kw + kStep - 1) / kStep);
  if (p.slab_steps < steps)
    return launch<BN, true>(x, w, out, m, n, kw, k_true, p, vec, stream);
  return launch<BN, false>(x, w, out, m, n, kw, k_true, p, vec, stream);
}

template <int BN, bool kChunked>
cudaError_t info(int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(
      &attr, binary_contraction_kernel<BN, kChunked>);
  if (e != cudaSuccess) return e;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return cudaSuccess;
}

}  // namespace

// sms: the card's SM count, which the plan fills (two blocks an SM where
// shared memory allows).  Anything the kernel does not take returns
// cudaErrorInvalidValue.
extern "C" int binary_contraction_launch(const void* x, const void* w,
                                         void* out, int m, int n, int kw,
                                         int k_true, int sms, void* stream) {
  if (sms < 1 || kw < 0 || k_true < 0 || k_true > 32 * kw)
    return (int)cudaErrorInvalidValue;
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  const Plan p = plan_for(m, n, kw, sms);
  if (p.smem_bytes > kSmemMax || p.n_slabs > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (p.bn == 32)
    return (int)dispatch<32>(x, w, out, m, n, kw, k_true, p, st);
  if (p.bn == 64)
    return (int)dispatch<64>(x, w, out, m, n, kw, k_true, p, st);
  return (int)dispatch<128>(x, w, out, m, n, kw, k_true, p, st);
}

// The plan a launch with these arguments takes: plan = {BN, BM, N slabs,
// m_splits, slab_steps, dynamic shared memory bytes, 16-byte copies (for
// x and w 16-byte aligned)}.
extern "C" int binary_contraction_plan(int m, int n, int kw, int sms,
                                       int* plan) {
  if (sms < 1 || m < 1 || n < 1 || kw < 0) return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(m, n, kw, sms);
  plan[0] = p.bn, plan[1] = p.bm, plan[2] = p.n_slabs, plan[3] = p.m_splits;
  plan[4] = p.slab_steps, plan[5] = p.smem_bytes, plan[6] = p.vec;
  return 0;
}

// Registers and local (spill) bytes a thread of the kernel with a slab of
// ``bn`` columns (32, 64 or 128) runs, whole slab (chunked = 0) or chunked.
extern "C" int binary_contraction_info(int bn, int chunked, int* regs,
                                       int* local_bytes) {
  if (bn == 32)
    return (int)(chunked ? info<32, true>(regs, local_bytes)
                         : info<32, false>(regs, local_bytes));
  if (bn == 64)
    return (int)(chunked ? info<64, true>(regs, local_bytes)
                         : info<64, false>(regs, local_bytes));
  if (bn == 128)
    return (int)(chunked ? info<128, true>(regs, local_bytes)
                         : info<128, false>(regs, local_bytes));
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* binary_contraction_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
