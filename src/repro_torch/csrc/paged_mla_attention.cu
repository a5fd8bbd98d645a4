// MLA's absorbed paged attention for Hopper (sm_90a), both products on
// tensor cores.
//
// Replaces the MLA branch (has_q2, the second score operand q2 . k2) of the
// Pallas TPU kernel repro/kernels/paged_attention.py (paged_mixed_attention,
// _kernel and _dequant).  Its plain PyTorch version is
// repro_torch/kernels/paged_attention.py::paged_mixed_attention_plain; GQA
// calls go to csrc/paged_attention.cu.
//
// Inputs: q (S, Q, H, D) and q2 (S, Q, H, D2) f32; one latent KV head: a
// latent pool c (n_pages, rows, 1, D) that is both key and value, and a
// rope pool pe (n_pages, rows, 1, D2), both f32 or bf16, or int8 codebook
// codes with f32 scale pools (n_pages, rows) for each and a (256,) f32
// codebook; table (S, P) int32 physical page per logical page; lengths (S,)
// valid positions including this block; q_lens (S,) real query tokens per
// slot.  Query i < q_lens[s] of slot s sits at position
// lengths[s] - q_lens[s] + i and attends keys at positions <= its own (and
// > position - window when window > 0).  Logical page j covers positions
// [j * logical, (j + 1) * logical); physical rows at or past `logical` are
// layout padding and never read, nor is page 0, the dummy sink.  The score
// of a key is (q . c + q2 . pe) * scale (then softcap); the output row is
// the softmax-weighted sum of c, (S, Q, H, D) f32; rows i >= q_lens[s]
// write zeros.  D <= 512, D2 <= 64.
//
// Launch: one block of 16 warps per (slot, query token, block of heads):
// 64 heads when the launch has at least 264 such blocks (two an SM, as a
// prefill chunk does), else 32 (a decode step's few tokens then spread
// over twice the blocks).  All rows of a block share one query position,
// so the causal and window mask is per key.  The block stages its q || q2
// rows in shared memory as f32 once, then walks key tiles of 16 positions
// from the window's start to the query's position through the slot's page
// table; warp w handles key row w of every tile:
//  * cp.async copies the tile's latent and rope rows into shared memory;
//    positions outside [lo, qpos] are zero-filled, never read.  bf16 and
//    codec rows land in a raw tile and are widened, or decoded (codebook
//    entry times the per-(page, token) scale, one rounded multiply), into
//    one f32 key tile once per block, for all its heads; the next tile's
//    copy is issued as soon as this one is decoded and runs under its
//    products.  f32 rows land in the key tile itself (f32 pools serve the
//    tests and the codec's reference, not the serve path), so their next
//    copy waits for the products.  "onehot" decodes by the 256-entry
//    masked sum, as the reference's vector-unit lookup did: the same bits,
//    kept as the bit-identity reference.
//  * S = [q || q2] . [c || pe]^T (rows x 16 keys, K = D + D2 padded to 8)
//    on mma.sync m16n8k8 TF32 with f32 accumulation.  Each warp takes one
//    16-row tile and a slice of K.  Over bf16 pools at 64 rows it takes
//    both 8-key tiles (each split q fragment feeds two MMAs) and a quarter
//    of K; otherwise one 8-key tile (which keeps 3xTF32 within the
//    registers) and a half (64 rows) or a quarter (32 rows) of K.  The K
//    slices meet in shared memory in a fixed order.
//  * The online softmax runs in f32 on the score tile (8 or 16 threads a
//    row): scale, softcap, mask, running max and sum.
//  * O += P . c on the same key tile: warp w owns 32 rows x 64 columns of
//    O (64 rows) or 32 x 32 (32 rows) in registers.
//  TF32 keeps 10 mantissa bits, too few for ATTN_TOL at D = 576, so every
//  f32 operand is split into TF32 hi + lo (cvt.rna, lo = x - hi).  bf16
//  values are exact in TF32, so with bf16 pools only q and p are split
//  (two MMAs a product); f32 pools and decoded codec values take 3xTF32
//  (lo.hi + hi.lo + hi.hi).  The codec and f32-pool paths share every
//  instruction after the decode into shared memory, so the codec kernel
//  gives the fp kernel's bits on pools decoded up front into f32.
//
// Shared memory at D = 512, D2 = 64 and 64 rows (ks = 580 floats a row):
// q 148,480 B, the f32 key tile 37,120 B, a raw tile of 18,432 B (bf16)
// or 9,216 B plus scales and codebook (codec), the score tile 5,120 B,
// two partial score tiles of the K quarters 10,240 B (bf16; 3xTF32 splits
// K in halves and needs none) and 512 B of row stats: 219,904 (bf16) /
// 201,600 (codec) / 191,232 (f32) of the 232,448 B a block may have, so
// one block an SM.  Registers: 128 a thread at most (512 threads); on an
// H100 build (nvcc 12.9) 117-127, no spills (chip_smoke.py prints each
// instantiation's count).
//
// What bounds it on the card: at Q = 64 (PERF.md's serve shape) the
// products are 5.5 GFLOP: 0.082 ms on f32 CUDA cores, 0.011 ms at the
// 495 TFLOP/s TF32 dense rate (x2 to x3 for the split); q and the output
// in f32 are most of the bytes (0.043 ms).  At Q = 1 the bytes take
// 0.0008 ms and a dozen blocks walk at most 17 tiles, so latency bounds
// it.  The design reads and decodes each latent row once per block of
// heads and runs both products on the tensor cores.  What it still pays: shared-memory traffic and the split of q
// and p on every tile (q is re-read from shared memory for each 16-key
// tile), the decode pass, five block barriers a tile, and the 3xTF32
// MMAs of the codec.  wgmma, TMA, split-K over keys for Q = 1 and
// persistent blocks are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kKeys = 16;            // key positions a tile (2 MMA col tiles)
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kPStride = kKeys + 4;  // score tile row stride (floats)
constexpr int kMaxD = 512, kMaxD2 = 64;
constexpr int kMaxSmem = 232448;     // dynamic shared memory a block may use
constexpr int kMinBlocks64 = 2 * 132;  // 64-row blocks to fill 132 SMs twice
constexpr int kLevels = 256;         // codebook entries
constexpr int kZeroCode = 128;       // codebook index of code 0

enum Mode { kFp = 0, kGather = 1, kOneHot = 2 };

struct Args {
  const float* q;
  const float* q2;
  const void* c_pages;
  const void* pe_pages;
  const float* c_scales;
  const float* pe_scales;
  const float* codebook;
  const int32_t* table;
  const int32_t* lengths;
  const int32_t* q_lens;
  float* out;
  int qn, h, d, d2, page_rows, logical, pages_per_slot, window;
  float softcap, scale;
};

// The score product's warps: kMT row tiles x (2 / key tiles a warp) key
// tile groups x K slices.  A 64-row block over bf16 pools gives each warp
// both key tiles (each split q fragment feeds both); 3xTF32 (f32 and
// codec pools) and 32-row blocks give it one, which keeps 3xTF32 within
// 128 registers a thread.
__host__ __device__ constexpr int score_ntiles(int rows, bool split_key) {
  return rows == 64 && !split_key ? 2 : 1;
}
__host__ __device__ constexpr int score_slices(int rows, bool split_key) {
  return kWarps * score_ntiles(rows, split_key) / (2 * (rows / 16));
}

// Shared-memory layout (byte offsets), from the rows a block, D, D2 and
// the pool type.  A q row and a key-tile row hold D values at column 0 and
// D2 at column dp, zero-padded to kp columns; the row stride ks = kp + 4
// keeps the MMA fragment loads free of bank conflicts.  One f32 key tile;
// bf16 and codec rows land in a raw tile first and are widened or decoded
// into it.
struct Layout {
  int dp, kp, ks;
  int c_bytes, pe_bytes;       // bytes of one pool row
  int c_chunk, pe_chunk;       // cp.async size for a row (16, 8 or 4)
  int c_stride, pe_stride;     // raw tile row strides (16-byte multiples)
  int q_off, f_off, raw_off, s_off, red_off, stat_off, sc_off, cb_off, total;
};

int round_up(int x, int m) { return (x + m - 1) / m * m; }

int chunk(int bytes) {
  return bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : bytes % 4 == 0 ? 4 : 0;
}

Layout make_layout(int rows, int d, int d2, int elem, bool direct,
                   bool codec) {
  Layout L;
  L.dp = round_up(d, 8);
  L.kp = L.dp + round_up(d2, 8);
  L.ks = L.kp + 4;
  L.c_bytes = d * elem;
  L.pe_bytes = d2 * elem;
  L.c_chunk = chunk(L.c_bytes);
  L.pe_chunk = chunk(L.pe_bytes);
  L.c_stride = round_up(L.c_bytes, 16);
  L.pe_stride = round_up(L.pe_bytes, 16);
  int off = 0;
  L.q_off = off;
  off += rows * L.ks * 4;
  L.f_off = off;
  off += kKeys * L.ks * 4;
  L.raw_off = off;
  if (!direct) off += kKeys * (L.c_stride + L.pe_stride);
  L.s_off = off;                                 // scores, then p
  off += rows * kPStride * 4;
  L.red_off = off;                               // partials of slices 2..
  off += (score_slices(rows, elem != 2) - 2) * rows * kPStride * 4;
  L.stat_off = off;                              // alpha, 1 / l per row
  off += 2 * rows * 4;
  L.sc_off = off;                                // [pool][key]
  if (codec) off += 2 * kKeys * 4;
  L.cb_off = off;
  if (codec) off += kLevels * 4;
  L.total = off;
  return L;
}

// A codec code decoded: codebook entry times the row's scale, one rounded
// multiply ("onehot" sums the 256 entries masked by index == code: the
// same bits)
template <int kMode>
__device__ __forceinline__ float decode_code(int code, float row_scale,
                                             const float* cb) {
  const int idx = code + kZeroCode;
  float c;
  if constexpr (kMode == kGather) {
    c = cb[idx];
  } else {
    c = 0.f;
    for (int i = 0; i < kLevels; ++i) c += i == idx ? cb[i] : 0.f;
  }
  return __fmul_rn(c, row_scale);
}

// Element e of a staged bf16 or codec row: the widened bf16 value, or the
// decoded codec value (f32 rows are used where they land).
template <typename T, int kMode>
__device__ __forceinline__ float element(const T* row, int e, float row_scale,
                                         const float* cb) {
  if constexpr (kMode == kFp)
    return __bfloat162float(row[e]);
  else
    return decode_code<kMode>((int)row[e], row_scale, cb);
}

// 8 bf16 values (16 bytes) of a staged row widened into f32 at `dst`
__device__ __forceinline__ void widen8(const __nv_bfloat16* src, float* dst) {
  const uint4 w = *(const uint4*)src;
  ((float4*)dst)[0] = make_float4(
      __uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
      __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
  ((float4*)dst)[1] = make_float4(
      __uint_as_float(w.z << 16), __uint_as_float(w.z & 0xffff0000u),
      __uint_as_float(w.w << 16), __uint_as_float(w.w & 0xffff0000u));
}

// cp.async of `bytes` (16, 8 or 4); zero-fills the destination when !ok
// and then reads nothing.
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = ok ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(d), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo in TF32, hi = x rounded to nearest (ties away), lo the rest
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// c += a . b on one m16n8k8 TF32 tile, f32 accumulation
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b with a split into hi + lo; b split too (kSplitB, 3xTF32:
// lo.hi + hi.lo + hi.hi) or exact in TF32 (two MMAs); small terms first
template <bool kSplitB>
__device__ __forceinline__ void mma_split(float (&c)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const float (&b)[2]) {
  if constexpr (kSplitB) {
    uint32_t bh0, bl0, bh1, bl1;
    split(b[0], bh0, bl0);
    split(b[1], bh1, bl1);
    mma(c, al, bh0, bh1);
    mma(c, ah, bl0, bl1);
    mma(c, ah, bh0, bh1);
  } else {
    const uint32_t b0 = __float_as_uint(b[0]), b1 = __float_as_uint(b[1]);
    mma(c, al, b0, b1);
    mma(c, ah, b0, b1);
  }
}

// A fragment of a 16 x 8 tile at `p` (row stride `ld`), split hi + lo
__device__ __forceinline__ void load_a(const float* p, int ld,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(p[0], hi[0], lo[0]);
  split(p[8 * ld], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * ld + 4], hi[3], lo[3]);
}

// A float row of n values from device memory into shared memory: float4
// when n is a multiple of 4 (rows then start 16-byte aligned), else floats.
__device__ __forceinline__ void load_row(float* dst, const float* src, int n,
                                         int lane) {
  if (n % 4 == 0) {
    for (int e = lane; e < n / 4; e += 32)
      ((float4*)dst)[e] = ((const float4*)src)[e];
  } else {
    for (int e = lane; e < n; e += 32) dst[e] = src[e];
  }
}

template <typename T, int kMode, int kRows>
__global__ void __launch_bounds__(kThreads, 1)
    paged_mla_attention_kernel(const Args a, const Layout L) {
  constexpr bool kDirect = std::is_same<T, float>::value;
  constexpr bool kSplitKey = !std::is_same<T, __nv_bfloat16>::value;
  // score: kMT row tiles x kNGroups key-tile groups x kSlices K slices
  constexpr int kMT = kRows / 16, kNTW = score_ntiles(kRows, kSplitKey);
  constexpr int kNGroups = 2 / kNTW;
  constexpr int kSlices = score_slices(kRows, kSplitKey);
  // P . V: kRows / 32 row halves x kColWarps column blocks of kNT tiles
  constexpr int kColWarps = kWarps / (kRows / 32), kNT = 64 / kColWarps;
  // softmax: kTPR threads a row, kKPT keys a thread
  constexpr int kTPR = kThreads / kRows, kKPT = kKeys / kTPR;
  static_assert(kKeys == kWarps, "one warp a key row");
  static_assert(kRows == 32 || kRows == 64, "32 or 64 rows a block");
  static_assert(kSlices >= 2, "slice 1 reduces into the score tile");
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = (float*)(smem + L.q_off);
  float* fs = (float*)(smem + L.f_off);
  unsigned char* raw = smem + L.raw_off;
  float* ps = (float*)(smem + L.s_off);
  float* red = (float*)(smem + L.red_off);
  float* alpha_s = (float*)(smem + L.stat_off);
  float* linv_s = alpha_s + kRows;
  float* scs = (float*)(smem + L.sc_off);
  float* cb = (float*)(smem + L.cb_off);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int h0 = blockIdx.x * kRows, qi = blockIdx.y, s = blockIdx.z;
  const int rows = min(kRows, a.h - h0);
  const int d = a.d, d2 = a.d2;
  const long long row0 = ((long long)s * a.qn + qi) * a.h + h0;
  float* out = a.out + row0 * d;

  const int qlen = a.q_lens[s];
  if (qi >= qlen) {                    // ragged padding: finite zeros
    for (int i = tid; i < rows * d; i += kThreads) out[i] = 0.f;
    return;
  }
  const int qpos = a.lengths[s] - qlen + qi;
  const int lo = a.window > 0 ? max(0, qpos - a.window + 1) : 0;
  const int t0 = lo / kKeys, t1 = qpos >= 0 ? qpos / kKeys : t0 - 1;
  const int32_t* trow = a.table + (long long)s * a.pages_per_slot;

  // padding columns, rows past H and masked key rows must read as zeros
  for (int i = tid; i < L.total / 16; i += kThreads)
    ((float4*)smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // staging and decoding: warp w handles key row w of every tile
  auto pool_row = [&](int t) -> long long {  // (page, token) or -1
    const int p = t * kKeys + warp;
    return t <= t1 && p >= lo && p <= qpos
        ? (long long)trow[p / a.logical] * a.page_rows + p % a.logical : -1;
  };
  auto stage = [&](long long prow) {   // the warp's row of the next tile
    const bool ok = prow >= 0;
    const long long src = ok ? prow : 0;
    const int nc = L.c_bytes / L.c_chunk, np = L.pe_bytes / L.pe_chunk;
    unsigned char* c_dst = kDirect ? (unsigned char*)(fs + warp * L.ks)
                                   : raw + warp * L.c_stride;
    unsigned char* pe_dst = kDirect
        ? c_dst + L.dp * 4 : raw + kKeys * L.c_stride + warp * L.pe_stride;
    for (int c = lane; c < nc; c += 32)
      cp_async(c_dst + c * L.c_chunk, (const char*)a.c_pages
               + src * L.c_bytes + c * L.c_chunk, L.c_chunk, ok);
    for (int c = lane; c < np; c += 32)
      cp_async(pe_dst + c * L.pe_chunk, (const char*)a.pe_pages
               + src * L.pe_bytes + c * L.pe_chunk, L.pe_chunk, ok);
    if constexpr (kMode != kFp) {
      if (lane < 2)
        cp_async(scs + lane * kKeys + warp,
                 (lane ? a.pe_scales : a.c_scales) + src, 4, ok);
    }
    cp_async_commit();
  };

  // the next tile's row is looked up one tile ahead, off the critical path
  long long prow_next = pool_row(t0 + 1);
  if (t0 <= t1) stage(pool_row(t0));
  for (int r = warp; r < rows; r += kWarps) {  // q || q2 rows, once
    load_row(qs + r * L.ks, a.q + (row0 + r) * d, d, lane);
    load_row(qs + r * L.ks + L.dp, a.q2 + (row0 + r) * d2, d2, lane);
  }
  if constexpr (kMode != kFp)
    for (int i = tid; i < kLevels; i += kThreads) cb[i] = a.codebook[i];

  const int mt = warp % kMT, ng = (warp / kMT) % kNGroups;
  const int slice = warp / (kMT * kNGroups);
  const int steps = L.kp / 8;
  const int k_begin = slice * steps / kSlices;
  const int k_end = (slice + 1) * steps / kSlices;
  const int rh = warp / kColWarps, cbk = warp % kColWarps;
  const int n_tiles = L.dp / 8;
  const int srow = tid / kTPR, sj = tid % kTPR;
  float m = -INFINITY, l = 0.f;
  float o[2][kNT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mi][ni][e] = 0.f;

  // One raw tile (bf16 and codec): tile t + 1's copy is issued once tile
  // t is decoded and runs under tile t's products.  One f32 tile (f32
  // pools, tests and the codec's reference): tile t + 1's copy waits
  // for tile t's products.
  for (int t = t0; t <= t1; ++t) {
    cp_async_wait_all();
    __syncthreads();                   // tile t landed; tile t - 1 done
    if constexpr (!kDirect) {          // widen / decode once per block
      const T* rc = (const T*)(raw + warp * L.c_stride);
      const T* rp = (const T*)(raw + kKeys * L.c_stride + warp * L.pe_stride);
      const float cs = scs[warp], ps2 = scs[kKeys + warp];
      float* f = fs + warp * L.ks;
      // bf16 8 values a step; codec codes one a step (a wider decode
      // step spills the 64-row kernel's registers)
      if (kMode == kFp && d % 8 == 0 && d2 % 8 == 0) {
        if constexpr (kMode == kFp) {
          for (int v = lane; v < d / 8; v += 32)
            widen8(rc + v * 8, f + v * 8);
          for (int v = lane; v < d2 / 8; v += 32)
            widen8(rp + v * 8, f + L.dp + v * 8);
        }
      } else {
        for (int e = lane; e < d; e += 32)
          f[e] = element<T, kMode>(rc, e, cs, cb);
        for (int e = lane; e < d2; e += 32)
          f[L.dp + e] = element<T, kMode>(rp, e, ps2, cb);
      }
      __syncthreads();
      if (t < t1) {
        stage(prow_next);
        prow_next = pool_row(t + 2);
      }
    }

    {                                  // S = [q || q2] . [c || pe]^T
      // kChains chains (K step mod kChains) for each of the warp's key
      // tiles; the unrolled steps let a step's loads overlap the MMAs
      // before it.  3xTF32 keeps one chain (its registers)
      constexpr int kChains = kSplitKey ? 1 : 2;
      float acc[kChains][kNTW][4] = {};
      const float* qa = qs + (mt * 16 + g) * L.ks + t4 + k_begin * 8;
      const float* kb = fs + (ng * kNTW * 8 + g) * L.ks + t4 + k_begin * 8;
      const int n_steps = k_end - k_begin;
      auto step = [&](int i, float (&c)[kNTW][4]) {
        uint32_t ah[4], al[4];
        load_a(qa + i * 8, L.ks, ah, al);
#pragma unroll
        for (int n = 0; n < kNTW; ++n) {
          const float* k = kb + n * 8 * L.ks + i * 8;
          const float b[2] = {k[0], k[4]};
          mma_split<kSplitKey>(c[n], ah, al, b);
        }
      };
      int i = 0;
      for (; i + kChains <= n_steps; i += kChains) {
#pragma unroll
        for (int u = 0; u < kChains; ++u) step(i + u, acc[u]);
      }
      if (i < n_steps) step(i, acc[0]);
#pragma unroll
      for (int u = 1; u < kChains; ++u)
#pragma unroll
        for (int n = 0; n < kNTW; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[0][n][e] += acc[u][n][e];
      // slices meet in a fixed order: slice 0 + slice 1 (in ps) + the
      // partials of slices 2.. (in red)
      float* dst = slice == 0 ? nullptr
          : slice == 1 ? ps : red + (slice - 2) * kRows * kPStride;
#pragma unroll
      for (int n = 0; n < kNTW; ++n) {
        const int at = (mt * 16 + g) * kPStride + (ng * kNTW + n) * 8 + 2 * t4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int off = at + (e >> 1) * 8 * kPStride + (e & 1);
          if (slice > 0) dst[off] = acc[0][n][e];
        }
      }
      __syncthreads();
      if (slice == 0) {
#pragma unroll
        for (int n = 0; n < kNTW; ++n) {
          const int at =
              (mt * 16 + g) * kPStride + (ng * kNTW + n) * 8 + 2 * t4;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int off = at + (e >> 1) * 8 * kPStride + (e & 1);
            float x = acc[0][n][e] + ps[off];
#pragma unroll
            for (int r = 0; r < kSlices - 2; ++r)
              x += red[r * kRows * kPStride + off];
            ps[off] = x;
          }
        }
      }
      __syncthreads();
    }

    {                                  // online softmax, kTPR threads a row
      float* pr = ps + srow * kPStride + kKPT * sj;
      const int p0 = t * kKeys + kKPT * sj;
      float sv[kKPT];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < kKPT; ++u) {
        float x = pr[u] * a.scale;
        if (a.softcap != 0.f) x = tanhf(x / a.softcap) * a.softcap;
        sv[u] = p0 + u >= lo && p0 + u <= qpos ? x : -INFINITY;
        mx = fmaxf(mx, sv[u]);
      }
#pragma unroll
      for (int off = kTPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m, mx);  // finite: a tile holds a valid key
      const float alpha = expf(m - m_new);   // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kKPT; ++u) {
        const float e = sv[u] == -INFINITY ? 0.f : expf(sv[u] - m_new);
        pr[u] = e;
        sum += e;
      }
#pragma unroll
      for (int off = kTPR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l = __fmaf_rn(l, alpha, sum);
      m = m_new;
      if (sj == 0) alpha_s[srow] = alpha;
      __syncthreads();
    }

    {                                  // O = O * alpha + P . c
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = rh * 32 + mi * 16 + g;
        const float a0 = alpha_s[r], a1 = alpha_s[r + 8];
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni) {
          o[mi][ni][0] *= a0;
          o[mi][ni][1] *= a0;
          o[mi][ni][2] *= a1;
          o[mi][ni][3] *= a1;
        }
      }
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t ph[2][4], pl[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          load_a(ps + (rh * 32 + mi * 16 + g) * kPStride + ks * 8 + t4,
                 kPStride, ph[mi], pl[mi]);
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni) {
          const int n = cbk * kNT + ni;
          if (n >= n_tiles) break;
          const float* vb = fs + (ks * 8 + t4) * L.ks + n * 8 + g;
          const float b[2] = {vb[0], vb[4 * L.ks]};
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            mma_split<kSplitKey>(o[mi][ni], ph[mi], pl[mi], b);
        }
      }
    }
    if constexpr (kDirect) {
      if (t < t1) {
        __syncthreads();               // every warp is done with the tile
        stage(prow_next);
        prow_next = pool_row(t + 2);
      }
    }
  }

  if (sj == 0) linv_s[srow] = 1.f / fmaxf(l, 1e-20f);
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half_row = 0; half_row < 2; ++half_row) {
      const int r = rh * 32 + mi * 16 + g + 8 * half_row;
      if (r >= rows) continue;
      const float inv = linv_s[r];
      float* orow = out + (long long)r * d;
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) {
        const int col = (cbk * kNT + ni) * 8 + 2 * t4;
        const float x0 = o[mi][ni][2 * half_row] * inv;
        const float x1 = o[mi][ni][2 * half_row + 1] * inv;
        if (d % 2 == 0 && col < d) {   // rows and col even: 8-byte aligned
          *(float2*)(orow + col) = make_float2(x0, x1);
        } else {
          if (col < d) orow[col] = x0;
          if (col + 1 < d) orow[col + 1] = x1;
        }
      }
    }
  }
}

template <typename T, int kMode, int kRows>
int launch(dim3 grid, cudaStream_t st, const Args& a, const Layout& L) {
  auto kernel = paged_mla_attention_kernel<T, kMode, kRows>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, L.total, st>>>(a, L);
  return (int)cudaGetLastError();
}

template <int kRows>
int launch_rows(int pools, dim3 grid, cudaStream_t st, const Args& a,
                const Layout& L) {
  switch (pools) {
    case 0: return launch<float, kFp, kRows>(grid, st, a, L);
    case 1: return launch<__nv_bfloat16, kFp, kRows>(grid, st, a, L);
    case 2: return launch<int8_t, kGather, kRows>(grid, st, a, L);
    default: return launch<int8_t, kOneHot, kRows>(grid, st, a, L);
  }
}

template <typename T, int kMode>
int info(int rows, int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(
      &attr, rows == 64 ? paged_mla_attention_kernel<T, kMode, 64>
                        : paged_mla_attention_kernel<T, kMode, 32>);
  if (e != cudaSuccess) return (int)e;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

Layout layout_for(int rows, int pools, int d, int d2) {
  const int elem = pools == 0 ? 4 : pools == 1 ? 2 : 1;
  return make_layout(rows, d, d2, elem, pools == 0, pools >= 2);
}

bool takes(const Layout& L, int d, int d2) {
  return d > 0 && d <= kMaxD && d2 > 0 && d2 <= kMaxD2 && L.c_chunk &&
         L.pe_chunk && L.total <= kMaxSmem;
}

// Rows (query heads) a block: 64 when the launch has blocks enough to fill
// the card twice over, else 32 (a decode step's few tokens then spread
// over twice the blocks).
int rows_for(int n_slots, int qn, int h) {
  const long long blocks64 = (long long)n_slots * qn * ((h + 63) / 64);
  return blocks64 >= kMinBlocks64 ? 64 : 32;
}

}  // namespace

// pools: 0 = float32, 1 = bfloat16, 2 = int8 codes decoded by "gather",
// 3 = int8 codes decoded by "onehot" (c_scales, pe_scales and codebook are
// read only for 2 and 3).  0 < d <= 512, 0 < d2 <= 64, and each pool row a
// multiple of 4 bytes; anything else returns cudaErrorInvalidValue.
extern "C" int paged_mla_attention_launch(
    const void* q, const void* q2, const void* c_pages, const void* pe_pages,
    int pools, const void* c_scales, const void* pe_scales,
    const void* codebook, const void* table, const void* lengths,
    const void* q_lens, void* out, int n_slots, int qn, int h, int d, int d2,
    int page_rows, int logical, int pages_per_slot, int window,
    float softcap, float scale, void* stream) {
  if (pools < 0 || pools > 3) return (int)cudaErrorInvalidValue;
  const int rows = rows_for(n_slots, qn, h);
  const Layout L = layout_for(rows, pools, d, d2);
  if (!takes(L, d, d2)) return (int)cudaErrorInvalidValue;
  if (n_slots == 0 || qn == 0 || h == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((h + rows - 1) / rows), (unsigned)qn,
                  (unsigned)n_slots);
  cudaStream_t st = (cudaStream_t)stream;
  const Args a{(const float*)q, (const float*)q2, c_pages, pe_pages,
               (const float*)c_scales, (const float*)pe_scales,
               (const float*)codebook, (const int32_t*)table,
               (const int32_t*)lengths, (const int32_t*)q_lens, (float*)out,
               qn, h, d, d2, page_rows, logical, pages_per_slot, window,
               softcap, scale};
  return rows == 64 ? launch_rows<64>(pools, grid, st, a, L)
                    : launch_rows<32>(pools, grid, st, a, L);
}

// The kernel's registers a thread, local (spill) bytes a thread and dynamic
// shared memory a block for a launch of n_slots x qn tokens of h heads with
// these pools and widths (the rows a block follow from the launch's shape).
extern "C" int paged_mla_attention_info(int pools, int n_slots, int qn, int h,
                                        int d, int d2, int* rows,
                                        int* regs, int* local_bytes,
                                        int* smem_bytes) {
  if (pools < 0 || pools > 3) return (int)cudaErrorInvalidValue;
  *rows = rows_for(n_slots, qn, h);
  *smem_bytes = layout_for(*rows, pools, d, d2).total;
  switch (pools) {
    case 0: return info<float, kFp>(*rows, regs, local_bytes);
    case 1: return info<__nv_bfloat16, kFp>(*rows, regs, local_bytes);
    case 2: return info<int8_t, kGather>(*rows, regs, local_bytes);
    default: return info<int8_t, kOneHot>(*rows, regs, local_bytes);
  }
}

extern "C" const char* paged_mla_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
