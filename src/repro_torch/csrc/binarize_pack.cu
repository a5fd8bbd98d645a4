// Sign-binarise + sequence-aligned bit packing for Hopper (sm_90a), two
// entries:
//
//   binarize_pack_launch          x (M, K) float32 -> (M, G, 9) words,
//                                 G = ceil(K / 288);
//   binarize_pack_patches_launch  x (N, H, W, Cin) float32 NHWC -> the
//                                 packed 3x3 patches (N*Ho*Wo, G, 9),
//                                 G = ceil(9 * Cin / 288) = ceil(Cin / 32),
//                                 without building the im2col columns.
//
// Replaces the Pallas TPU kernel repro/kernels/binarize_pack.py
// (binarize_pack, _kernel) and, for the patches, the reference's pair
// ref.pack_bits_runtime(ops._im2col_bits(x, stride)) (repro/kernels/
// ops.py:105-117).  Their plain PyTorch versions are repro_torch/kernels/
// ref.py::binarize_pack and ::binarize_pack_patches, which these kernels
// reproduce bit for bit.
//
// Packed layout: per 288-element K block, word j holds tap j of its 32
// consecutive 9-element sequences: bit i of the word is element 9 i + j of
// the block, 1 where x >= 0.  K is padded with -1 (bit 0).  For patches
// the features are (Cin, kh, kw), channel outermost, so block gb is
// channels 32 gb .. 32 gb + 31 x the 9 taps j = 3 kh + kw, and word j of
// (pixel, gb) is the channel word of input pixel (ho s + kh - 1,
// wo s + kw - 1): bit i = x[n, y, x, 32 gb + i] >= 0, 0 outside the image
// (the BNN's symmetric (1, 1) padding of -1) and past Cin.
//
// Both kernels run in two phases on 256 threads:
//   1. load: a contiguous run of floats becomes its natural sign words in
//      shared memory (bit b % 32 of word b / 32 is element b).  Where the
//      run is 16-byte aligned and a multiple of 4 long, each lane loads a
//      float4 and the 8 lanes of a word OR their nibbles by three
//      shuffles; else each lane loads one float and a warp ballot gives
//      the word.  Four loads a lane are in flight before their use.
//   2. emit: (M, K) -- a warp per 288-element block: lane i cuts its
//      9-bit sequence out of the words with a funnel shift, and 9 ballots
//      give the 9 packed words (rows of K <= 288 hold ceil(K / 9)
//      sequences, so 32 / that many rows share a warp's 9 ballots).
//      Patches -- a thread per output word copies the channel word of the
//      input pixel its tap reads.
// (M, K) blocks take a run of whole 288-element blocks (whole rows when
// K <= 288); patch blocks take a tile of output rows x a range of channel
// groups, with the input rows they read (one halo row each side).  The
// Python wrapper (kernels/binarize_pack.py) picks the tiling; each launch
// below sizes its shared memory from it, and the patch launch takes fewer
// rows (then groups) a block where their input rows would not fit.
//
// What bounds it on the card: bytes.  Each float is read once from device
// memory (a patch block's halo rows again from L2), one bit is written
// for it, or for each of the 9 taps that read it; the compare, shuffle
// and ballot work is far below the card's integer rate.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockK = 288;   // 32 sequences x 9 taps
constexpr int kTaps = 9;
constexpr int kUnroll = 4;     // loads in flight a lane
constexpr int kSmemMax = 48 * 1024;   // the default dynamic shared memory

__device__ __forceinline__ uint32_t nibble(float4 v) {
  return (uint32_t)(v.x >= 0.0f) | (uint32_t)(v.y >= 0.0f) << 1 |
         (uint32_t)(v.z >= 0.0f) << 2 | (uint32_t)(v.w >= 0.0f) << 3;
}

// The 8 lanes of a word (lanes 8k .. 8k + 7, float4s 8k .. 8k + 7 of it)
// OR their nibbles; every lane of the group returns the word.
__device__ __forceinline__ uint32_t gather_word(uint32_t nib, int lane) {
  uint32_t w = nib << (4 * (lane & 7));
  w |= __shfl_xor_sync(0xffffffffu, w, 1);
  w |= __shfl_xor_sync(0xffffffffu, w, 2);
  w |= __shfl_xor_sync(0xffffffffu, w, 4);
  return w;
}

// Natural sign words of src[0 .. n) into words[0 .. ceil(n / 32)), by all
// threads of the block.  kVec: src is 16-byte aligned and n % 4 == 0.
template <bool kVec>
__device__ void load_sign_words(const float* __restrict__ src, int n,
                                uint32_t* words) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (kVec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    const int nq = n >> 2;
    for (int base = warp * 32; base < nq; base += kWarps * 32 * kUnroll) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = base + u * kWarps * 32 + lane;
        v[u] = q < nq ? __ldg(s4 + q) : make_float4(-1.f, -1.f, -1.f, -1.f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = base + u * kWarps * 32 + lane;
        const uint32_t w = gather_word(nibble(v[u]), lane);
        if ((lane & 7) == 0 && q < nq) words[q >> 3] = w;
      }
    }
  } else {
    for (int base = warp * 32; base < n; base += kWarps * 32 * kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = base + u * kWarps * 32 + lane;
        v[u] = e < n ? __ldg(src + e) : -1.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e0 = base + u * kWarps * 32;
        const uint32_t w = __ballot_sync(0xffffffffu, v[u] >= 0.0f);
        if (lane == 0 && e0 < n) words[e0 >> 5] = w;
      }
    }
  }
}

// Block b of the (M, K) entry covers flat elements row * K + 288 g ..
// + min(288, K - 288 g): consecutive blocks are consecutive runs of x.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
binarize_pack_kernel(const float* __restrict__ x, uint32_t* __restrict__ out,
                     long long blocks, int k, int g_blocks, int per_cta) {
  extern __shared__ uint32_t bits[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b0 = (long long)blockIdx.x * per_cta;
  const long long b1 = min(b0 + per_cta, blocks);
  const long long row0 = b0 / g_blocks;
  const long long f0 = row0 * k + (long long)kBlockK * (b0 - row0 * g_blocks);
  const long long rl = (b1 - 1) / g_blocks;
  const int gl = (int)(b1 - 1 - rl * g_blocks);
  const long long f1 = rl * k + min(kBlockK * gl + kBlockK, k);
  load_sign_words<kVec>(x + f0, (int)(f1 - f0), bits);
  __syncthreads();
  // A warp step packs R blocks: lane l cuts sequence l % S of block l / S
  // (S = 32, R = 1, unless K <= 288: then S = ceil(K / 9) sequences hold
  // data and R = 32 / S rows share the 9 ballots).
  const int g0 = (int)(b0 - row0 * g_blocks);
  const int n_blocks = (int)(b1 - b0);
  const int S = g_blocks == 1 ? (k + 8) / 9 : 32;
  const int R = 32 / S;
  const uint32_t mask = S == 32 ? 0xffffffffu : (1u << S) - 1u;
  for (int lb0 = warp * R; lb0 < n_blocks; lb0 += kWarps * R) {   // 32-bit
    const int lb = lb0 + lane / S;
    const int sq = lane % S;
    uint32_t v = 0;
    if (lane < R * S && lb < n_blocks) {
      const int dr = (g0 + lb) / g_blocks;     // row - row0
      const int gg = g0 + lb - dr * g_blocks;
      const int start = dr * k + kBlockK * (gg - g0);       // bit - f0
      const int cnt =
          min(max(min(kBlockK, k - kBlockK * gg) - 9 * sq, 0), 9);
      if (cnt > 0) {
        const int p = start + 9 * sq;
        v = __funnelshift_r(bits[p >> 5], bits[(p >> 5) + 1], p & 31) &
            ((1u << cnt) - 1u);
      }
    }
    uint32_t mine = 0;
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      const uint32_t word = __ballot_sync(0xffffffffu, (v >> j) & 1u);
      if (lane == j) mine = word;
    }
    for (int rnd = 0; rnd * 32 < kTaps * R; ++rnd) {
      const int o = rnd * 32 + lane;
      const int r = o / kTaps;
      const int j = o - r * kTaps;
      const uint32_t word = __shfl_sync(0xffffffffu, mine, j);
      if (o < kTaps * R && lb0 + r < n_blocks)
        out[(b0 + lb0 + r) * kTaps + j] = (word >> (S * r)) & mask;
    }
  }
}

struct PatchShape {
  int n, h, w, cin, stride, ho, wo, g;
  int rows, gbs, row_tiles, gb_tiles;   // a block's output rows and groups

  // Channel words a block stages: the input rows its output rows read
  // (one halo row each side, at most H) x W pixels x its groups.
  long long stage_words() const {
    return (long long)std::min((rows - 1) * stride + 3, h) * w * gbs;
  }
};

// Block (image, row tile, group tile) stages the channel words of the
// input rows its output rows read: word ((y - y_lo) * W + x) * gbc + l is
// channels 32 (gb0 + l) .. of pixel (y, x).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
binarize_pack_patches_kernel(const float* __restrict__ x,
                             uint32_t* __restrict__ out, PatchShape s) {
  extern __shared__ uint32_t stage[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int cta = blockIdx.x;
  const int gt = cta % s.gb_tiles;
  cta /= s.gb_tiles;
  const int rt = cta % s.row_tiles;
  const int img = cta / s.row_tiles;
  const int gb0 = gt * s.gbs;
  const int gbc = min(s.gbs, s.g - gb0);
  const int ho0 = rt * s.rows;
  const int ho1 = min(ho0 + s.rows, s.ho);
  const int y_lo = max(0, ho0 * s.stride - 1);
  const int y_hi = min(s.h, (ho1 - 1) * s.stride + 2);
  const int n_words = (y_hi - y_lo) * s.w * gbc;
  const float* base = x + ((size_t)img * s.h + y_lo) * s.w * s.cin;
  if (kVec) {            // Cin % 32 == 0: a word is 32 aligned floats
    for (int w0 = warp * 4; w0 < n_words; w0 += kWarps * 4 * kUnroll) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int wd = w0 + u * kWarps * 4 + (lane >> 3);
        if (wd < n_words) {
          const int pix = wd / gbc;
          const float* src = base + (size_t)pix * s.cin +
                             32 * (gb0 + wd - pix * gbc) + 4 * (lane & 7);
          v[u] = __ldg(reinterpret_cast<const float4*>(src));
        } else {
          v[u] = make_float4(-1.f, -1.f, -1.f, -1.f);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int wd = w0 + u * kWarps * 4 + (lane >> 3);
        const uint32_t word = gather_word(nibble(v[u]), lane);
        if ((lane & 7) == 0 && wd < n_words) stage[wd] = word;
      }
    }
  } else {               // a lane a channel, a ballot a word
    for (int w0 = warp; w0 < n_words; w0 += kWarps * kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int wd = w0 + u * kWarps;
        const int pix = wd / gbc;
        const int c = 32 * (gb0 + wd - pix * gbc) + lane;
        v[u] = wd < n_words && c < s.cin
                   ? __ldg(base + (size_t)pix * s.cin + c) : -1.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int wd = w0 + u * kWarps;
        const uint32_t word = __ballot_sync(0xffffffffu, v[u] >= 0.0f);
        if (lane == 0 && wd < n_words) stage[wd] = word;
      }
    }
  }
  __syncthreads();
  const int per_pix = kTaps * gbc;
  const int n_out = (ho1 - ho0) * s.wo * per_pix;
  for (int o = threadIdx.x; o < n_out; o += kThreads) {
    const int pl = o / per_pix;
    const int rem = o - pl * per_pix;
    const int l = rem / kTaps;
    const int j = rem - l * kTaps;
    const int hol = pl / s.wo;
    const int wx = pl - hol * s.wo;
    const int kh = j / 3;
    const int yy = (ho0 + hol) * s.stride + kh - 1;
    const int xx = wx * s.stride + (j - 3 * kh) - 1;
    const uint32_t val = yy >= 0 && yy < s.h && xx >= 0 && xx < s.w
                             ? stage[((yy - y_lo) * s.w + xx) * gbc + l]
                             : 0u;
    out[((((size_t)img * s.ho + ho0 + hol) * s.wo + wx) * s.g + gb0 + l) *
            kTaps + j] = val;
  }
}

}  // namespace

// per_cta: 288-element blocks a thread block packs; its shared memory
// holds their sign words and two more (per_cta * 9 + 2 words).
extern "C" int binarize_pack_launch(const void* x, void* out, long long m,
                                    int k, int g_blocks, int per_cta,
                                    void* stream) {
  const long long blocks = m * g_blocks;
  if (blocks <= 0) return (int)cudaGetLastError();
  const int smem_bytes = (per_cta * kTaps + 2) * 4;
  if (per_cta < 1 || smem_bytes > kSmemMax)
    return (int)cudaErrorInvalidValue;
  const long long ctas = (blocks + per_cta - 1) / per_cta;
  const bool vec = k % 4 == 0 && ((uintptr_t)x & 15) == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    binarize_pack_kernel<true><<<(unsigned)ctas, kThreads, smem_bytes, st>>>(
        (const float*)x, (uint32_t*)out, blocks, k, g_blocks, per_cta);
  else
    binarize_pack_kernel<false><<<(unsigned)ctas, kThreads, smem_bytes, st>>>(
        (const float*)x, (uint32_t*)out, blocks, k, g_blocks, per_cta);
  return (int)cudaGetLastError();
}

// rows / gbs: the most output rows and channel groups a thread block
// emits; rows are halved (then gbs) while their staged words exceed the
// default shared memory.  The grid is n * row_tiles * gb_tiles.
extern "C" int binarize_pack_patches_launch(
    const void* x, void* out, int n, int h, int w, int cin, int stride,
    int rows, int gbs, void* stream) {
  PatchShape s;
  s.n = n, s.h = h, s.w = w, s.cin = cin, s.stride = stride;
  s.ho = (h - 1) / stride + 1;
  s.wo = (w - 1) / stride + 1;
  s.g = (cin + 31) / 32;
  s.rows = rows, s.gbs = gbs;
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0) return (int)cudaGetLastError();
  if (stride < 1 || rows < 1 || gbs < 1) return (int)cudaErrorInvalidValue;
  while (s.rows > 1 && s.stage_words() * 4 > kSmemMax)
    s.rows = (s.rows + 1) / 2;
  while (s.gbs > 1 && s.stage_words() * 4 > kSmemMax)
    s.gbs = (s.gbs + 1) / 2;
  if (s.stage_words() * 4 > kSmemMax) return (int)cudaErrorInvalidValue;
  const int smem_bytes = (int)s.stage_words() * 4;
  s.row_tiles = (s.ho + s.rows - 1) / s.rows;
  s.gb_tiles = (s.g + s.gbs - 1) / s.gbs;
  const long long ctas = (long long)n * s.row_tiles * s.gb_tiles;
  const bool vec = cin % 32 == 0 && ((uintptr_t)x & 15) == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    binarize_pack_patches_kernel<true>
        <<<(unsigned)ctas, kThreads, smem_bytes, st>>>((const float*)x,
                                                       (uint32_t*)out, s);
  else
    binarize_pack_patches_kernel<false>
        <<<(unsigned)ctas, kThreads, smem_bytes, st>>>((const float*)x,
                                                       (uint32_t*)out, s);
  return (int)cudaGetLastError();
}

extern "C" const char* binarize_pack_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
