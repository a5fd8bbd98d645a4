// Ragged GQA paged attention over slot page tables for Hopper (sm_90a),
// both products on tensor cores.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py
// (paged_mixed_attention, _kernel and _dequant) for fp pools and for the
// int8 KV-page codec.  Its plain PyTorch version is
// repro_torch/kernels/paged_attention.py::paged_mixed_attention_plain.
// Calls with the MLA second score operand go to csrc/paged_mla_attention.cu.
//
// Inputs: q (S, Q, H, D) f32 (GQA callers fold the 1/sqrt(D) in); page
// pools k (n_pages, rows, KH, D) and v (n_pages, rows, KH, Dv) in f32 or
// bf16, or int8 codebook codes with f32 scale pools k_scales / v_scales
// (n_pages, rows) and a (256,) f32 codebook; table (S, P) int32 physical
// page per logical page; lengths (S,) valid positions including this
// block; q_lens (S,) real query tokens per slot.  Query i < q_lens[s] of
// slot s sits at position lengths[s] - q_lens[s] + i and attends keys at
// positions <= its own (and > position - window when window > 0).
// Logical page j covers positions [j * logical, (j + 1) * logical);
// physical rows at or past `logical` are layout padding and never read,
// nor is page 0, the dummy sink.  Rows i >= q_lens[s] write zeros.
// Output (S, Q, H, Dv) f32.  D, Dv <= 256; G = H / KH any.
//
// Launch: the rows of a block are query tokens x query heads of one KV
// head: one block per (slot, KV head, tile of T tokens), T = rows / G
// tokens of all G heads (when G > rows, one token and rows heads, the
// group split over blocks).  The wrapper picks 64 rows when the launch
// has a block for every SM, else 32, else 16 (a decode step's few tokens
// then spread over more blocks).  All rows of a block read the same K/V
// rows, so each 16-key tile is staged, and for codec pools decoded, once
// per block, for the G heads and T tokens at once.  Rows hold different
// query positions, so the causal / window mask is per (row, key), and the
// block walks keys from its first token's window start to its last
// token's position through the slot's page table.  A block has one warp
// per 16-row tile (two for Dv > 128, each one half of Dv, both computing
// the score) and at least four warps; the warps past the row tiles stage
// and decode, so that the compute warps never wait on either:
//  * cp.async copies a tile's K and V rows into shared memory, double
//    buffered, a tile ahead of the products (two for codec pools).  A
//    staging thread keeps its key's (logical page, row) from tile to tile
//    without a division and loads its page-table entry a tile before it
//    is used.  Positions outside the block's span are zero-filled and
//    never read.  f32 and bf16 rows are read by the products where they
//    land (a bf16 value widened is exact in TF32).  Codec rows land raw
//    and are decoded once per block, a tile ahead of the products, into
//    the other of two f32 K/V buffers: codebook entry times the
//    per-(page, token) scale, one rounded multiply.  "onehot" decodes by
//    the 256-entry masked sum, as the reference's vector-unit lookup did:
//    the same bits, kept as the bit-identity reference.  One block
//    barrier a tile.
//  * A compute warp computes S = q . k^T for its 16 rows x 16 keys on
//    mma.sync m16n8k8 TF32 with f32 accumulation (K = D zero-padded to a
//    multiple of 32): four chains (K step mod 4) for each 8-key tile,
//    each term of the split issued over all eight accumulators before
//    the next, so that no MMA waits on the one before it.  The MMA's k
//    index is a label: k = t4 and t4 + 4 stand for dims 2 t4 and 2 t4 + 1
//    of a K step in q and in the keys alike, so a lane loads its q hi/lo
//    fragment as one 16-byte word a row and its key pair as one word.  It
//    runs the online softmax on S in registers (scale, softcap, a mask
//    per (row, key), running max, partial sums; 4 lanes a row, 2
//    shuffles; exponents against a finite reference, without a branch)
//    and adds P . v into its 16 x 128 f32 accumulator.  P never leaves
//    the registers: the key order of the P . v product is permuted so
//    that the score accumulator is the A fragment (lane (g, t4) holds keys
//    2 t4, 2 t4 + 1 of each 8-key tile and reads V rows 2 t4 and
//    2 t4 + 1).  A warp skips the tiles none of its rows may see (a causal
//    chunk's early tokens and late keys).
//  TF32 keeps 10 mantissa bits, too few for 1e-4 at D = 128 (the CPU
//  emulation in tests/test_torch_gqa_split.py: 2.3e-4 for one rounding of
//  q, 1.4e-4 of p), so q (split once, into shared memory) and p are split
//  into TF32 hi + lo (cvt.rna, lo = x - hi).  bf16 pool values are exact
//  in TF32: two MMAs a product.  f32 pools and decoded codec values take
//  3xTF32 (lo.hi + hi.lo + hi.hi).  The codec and f32-pool kernels share
//  every instruction after the fill of the f32 K/V tiles, with the same K
//  partition and summation order, so the codec kernel gives the fp
//  kernel's bits on pools decoded up front into f32.
//
// Shared memory at D = Dv = 128: q hi/lo 34,816 B (32 rows) or 69,632 B
// (64 rows); two staged tiles of 17,408 B (bf16) or 34,304 B (f32); codec:
// two raw tiles with scales 8,448 B, two f32 K/V buffers 34,304 B and the
// codebook.  About 52-113 KB a block; at most 219,904 B (D = 256, 64
// rows, codec).  Registers: at most 255 a thread (256 threads); on an
// H100 build (nvcc 12.9) 186-194, no spills (chip_smoke.py prints each
// instantiation's count).
//
// What bounds it on the card: at Q = 64 (PERF.md's serve shape) the two
// products are 0.33 GFLOP, 0.0049 ms on f32 CUDA cores, 0.0007 ms at the
// 495 TFLOP/s TF32 rate (x2 to x3 for the split), and the bytes (bf16
// K/V, the real tokens' q rows and the output in f32) 0.0025 ms.  What sets its time is the
// serial walk of one warp over up to 17 tiles with its online softmax:
// 128 (bf16) or 192 (3xTF32) MMAs a tile from one warp, and with one or
// two compute warps an SM nothing hides the latencies between dependent
// steps.  At Q = 1, 12 of a tile's 16 MMA rows are empty (G = 4).  wgmma, TMA, split-K over keys for
// Q = 1 and persistent blocks are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kKeys = 16;            // key positions a tile
constexpr int kMaxThreads = 256;     // 4 row tiles x 2 column halves
constexpr int kMinThreads = 128;     // warps past the row tiles only stage
constexpr int kNT = 16;              // 8-column tiles of O a warp holds
constexpr int kChains = 4;           // score chains (K step mod kChains)
constexpr int kGroup = 8;            // accumulators a term is issued over
constexpr int kMaxD = 256;
constexpr int kMaxSmem = 232448;     // dynamic shared memory a block may use
constexpr int kLevels = 256;         // codebook entries
constexpr int kZeroCode = 128;       // codebook index of code 0

enum Mode { kFp = 0, kGather = 1, kOneHot = 2 };

struct Args {
  const float* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scales;
  const float* v_scales;
  const float* codebook;
  const int32_t* table;
  const int32_t* lengths;
  const int32_t* q_lens;
  float* out;
  int qn, h, kh, d, dv, page_rows, logical, pages_per_slot, window;
  int hb, tokens, head_blocks;   // heads and tokens a block; blocks a group
  int step_pg, step_off;         // 16 positions in logical pages + rows
  float softcap, scale;
};

// Shared-memory layout (byte offsets) from the rows a block, D, Dv and the
// pool type.  A q row holds kp dims (D zero-padded to whole groups of score
// chains, so that no MMA is predicated) as TF32 (hi, lo) pairs, stride
// 2 kp + 16 words.  A stage buffer holds a tile's K rows and V rows as
// they are in the pool (codec: then its 16 K and 16 V scales); V rows hold
// vp values (Dv padded to whole groups of 8 column tiles).  f32 K rows sit
// at stride kp + 8 and f32 V rows at vp + 4, bf16 rows at 4 words mod 32,
// which keep the fragment loads free of bank conflicts; codec raw rows at
// 16-byte strides and the f32 tiles they decode into as f32 rows.
struct Layout {
  int rows, threads, col_halves;
  int compute_threads;         // the warps of the row tiles; the rest stage
  int kp, vp;                  // D, Dv padded (see above)
  int qs;                      // q row stride (words)
  int kst, vst;                // staged row strides (pool elements)
  int kfs, vfs;                // decoded f32 row strides (codec)
  int k_chunk, v_chunk;        // cp.async size of a row's pieces (0: bytes)
  int k_pieces, v_pieces;      // pieces a row
  int q_off, stage_off, stage_bytes, v_off, sc_off;
  int fk_off, fv_off, f_bytes, cb_off, total;
};

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// cp.async size for rows of `bytes` from `base`: 16, 8 or 4, or 0 (the
// rows are copied by plain loads)
int chunk(int bytes, const void* base) {
  const uintptr_t p = (uintptr_t)base;
  for (int c = 16; c >= 4; c /= 2)
    if (bytes % c == 0 && p % c == 0) return c;
  return 0;
}

// a staged row's stride in pool elements
int stage_stride(int width8, int elem) {
  if (elem == 4) return width8 + 4;
  if (elem == 2) return 2 * (round_up(width8 / 2 - 4, 32) + 4);
  return round_up(width8, 16);
}

Layout make_layout(int rows, int d, int dv, int elem, bool codec,
                   const void* k_pages, const void* v_pages) {
  Layout L;
  L.col_halves = dv > 8 * kNT ? 2 : 1;
  L.rows = rows;
  L.compute_threads = 32 * (rows / 16) * L.col_halves;
  L.threads = L.compute_threads < kMinThreads ? kMinThreads
                                              : L.compute_threads;
  L.kp = round_up(d, 8 * kChains);
  L.vp = L.col_halves == 1 ? round_up(dv, 8 * kGroup) : 2 * 8 * kNT;
  L.qs = 2 * L.kp + 16;
  L.kst = elem == 4 ? L.kp + 8 : stage_stride(L.kp, elem);
  L.vst = stage_stride(L.vp, elem);
  L.kfs = L.kp + 8;
  L.vfs = L.vp + 4;
  L.k_chunk = chunk(d * elem, k_pages);
  L.v_chunk = chunk(dv * elem, v_pages);
  L.k_pieces = L.k_chunk ? d * elem / L.k_chunk : d * elem;
  L.v_pieces = L.v_chunk ? dv * elem / L.v_chunk : dv * elem;
  int off = 0;
  L.q_off = off;
  off += rows * L.qs * 4;
  L.stage_off = off;
  L.v_off = kKeys * L.kst * elem;
  L.sc_off = round_up(L.v_off + kKeys * L.vst * elem, 16);
  L.stage_bytes = round_up(L.sc_off + (codec ? 2 * kKeys * 4 : 0), 16);
  off += 2 * L.stage_bytes;
  L.fk_off = off;                       // two decoded buffers of K, V
  L.fv_off = off + kKeys * L.kfs * 4;
  L.f_bytes = kKeys * (L.kfs + L.vfs) * 4;
  if (codec) off += 2 * L.f_bytes;
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

// Pieces part, part + parts, ... of a pool row (cp.async of `chunk` bytes,
// or byte copies when chunk is 0); zeros when !ok
__device__ __forceinline__ void copy_row(unsigned char* dst, const char* src,
                                         int pieces, int chunk, int part,
                                         int parts, bool ok) {
  if (chunk) {
    for (int c = part; c < pieces; c += parts)
      cp_async(dst + c * chunk, src + c * chunk, chunk, ok);
  } else {
    for (int b = part; b < pieces; b += parts) dst[b] = ok ? src[b] : 0;
  }
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

// The A fragment of q for one K step, hi and lo: rows g (at `row`) and
// g + 8 (ld words on), each one 16-byte load of the lane's two dims (k =
// t4 and t4 + 4) with their hi and lo parts
__device__ __forceinline__ void load_q(const uint32_t* row, int ld,
                                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const uint4 x = *(const uint4*)row;
  const uint4 y = *(const uint4*)(row + 8 * ld);
  ah[0] = x.x;
  ah[1] = y.x;
  ah[2] = x.z;
  ah[3] = y.z;
  al[0] = x.y;
  al[1] = y.y;
  al[2] = x.w;
  al[3] = y.w;
}

// A key row's two adjacent dims (the lane's k = t4 and t4 + 4), one load
__device__ __forceinline__ void k_pair(const float* p, float& b0,
                                       float& b1) {
  const float2 x = *(const float2*)p;
  b0 = x.x;
  b1 = x.y;
}
__device__ __forceinline__ void k_pair(const __nv_bfloat16* p, float& b0,
                                       float& b1) {
  const uint32_t x = *(const uint32_t*)p;
  b0 = __uint_as_float(x << 16);
  b1 = __uint_as_float(x & 0xffff0000u);
}

// A B fragment (b0, b1): split into TF32 hi + lo (kSplitB), or taken as
// it is (a bf16 value, exact in TF32; lo unused)
template <bool kSplitB>
__device__ __forceinline__ void b_operand(float b0, float b1,
                                          uint32_t (&bh)[2],
                                          uint32_t (&bl)[2]) {
  if constexpr (kSplitB) {
    split(b0, bh[0], bl[0]);
    split(b1, bh[1], bl[1]);
  } else {
    bh[0] = __float_as_uint(b0);
    bh[1] = __float_as_uint(b1);
  }
}

// c[c0 + j] += a[j] . b[j] for kN independent tiles, a
// split into hi + lo; b split too (kSplitB, 3xTF32: lo.hi + hi.lo +
// hi.hi) or exact in TF32 (lo.b + hi.b); small terms first.  Each term is
// issued for every tile before the next term, so no MMA waits on the one
// before it.
template <bool kSplitB, int kN, int kM>
__device__ __forceinline__ void mma_passes(float (&c)[kM][4], int c0,
                                           const uint32_t (&ah)[kN][4],
                                           const uint32_t (&al)[kN][4],
                                           const uint32_t (&bh)[kN][2],
                                           const uint32_t (&bl)[kN][2]) {
#pragma unroll
  for (int j = 0; j < kN; ++j)
    mma(c[c0 + j], al[j], bh[j][0], bh[j][1]);
  if constexpr (kSplitB) {
#pragma unroll
    for (int j = 0; j < kN; ++j)
      mma(c[c0 + j], ah[j], bl[j][0], bl[j][1]);
  }
#pragma unroll
  for (int j = 0; j < kN; ++j)
    mma(c[c0 + j], ah[j], bh[j][0], bh[j][1]);
}

// A tile's 16 raw code rows (stride rs) decoded with their scales into f32
// rows (stride fs) by warps w of nw: rows w, w + nw, ... and lanes over
// four codes a step (one 4-byte load, one 16-byte store) when the width
// allows, else one
template <int kMode>
__device__ __forceinline__ void decode_tile(const int8_t* raw, int rs,
                                            const float* sc, float* f,
                                            int fs, int width,
                                            const float* cb, int w, int nw,
                                            int lane) {
  if (width % 4 == 0) {
    for (int c = 4 * lane; c < width; c += 128) {
#pragma unroll 4
      for (int r = w; r < kKeys; r += nw) {
        const char4 x = *(const char4*)(raw + r * rs + c);
        const float s = sc[r];
        *(float4*)(f + r * fs + c) = make_float4(
            decode_code<kMode>(x.x, s, cb), decode_code<kMode>(x.y, s, cb),
            decode_code<kMode>(x.z, s, cb), decode_code<kMode>(x.w, s, cb));
      }
    }
  } else {
    for (int r = w; r < kKeys; r += nw)
      for (int c = lane; c < width; c += 32)
        f[r * fs + c] = decode_code<kMode>(raw[r * rs + c], sc[r], cb);
  }
}

__device__ __forceinline__ float as_f32(float x) { return x; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kMaxThreads, 1)
    paged_attention_kernel(const Args a, const Layout L) {
  // the products read f32 or bf16 rows where they land, decoded f32 rows
  // for codec pools
  using CT = typename std::conditional<kMode == kFp, T, float>::type;
  constexpr bool kSplitKey = !std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* qs = (uint32_t*)(smem + L.q_off);
  float* cb = (float*)(smem + L.cb_off);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = L.threads >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int hblk = blockIdx.x % a.head_blocks;
  const int i0 = blockIdx.x / a.head_blocks * a.tokens;
  const int kvh = blockIdx.y, s = blockIdx.z;
  const int group = a.h / a.kh;
  const int h0 = kvh * group + hblk * a.hb;          // the block's first head
  const int nh = min(a.hb, group - hblk * a.hb);     // and its heads
  const int rows = L.rows;
  const int d = a.d, dv = a.dv;
  const int qlen = a.q_lens[s];
  const int first = a.lengths[s] - qlen;             // token 0's position

  // row r of the block: token i0 + r / hb, head h0 + r % hb; -1 when the
  // row lies outside the output (past Q, past the block's heads)
  auto out_row = [&](int r) -> long long {
    const int i = i0 + r / a.hb, hoff = r % a.hb;
    if (r >= a.tokens * a.hb || i >= a.qn || hoff >= nh) return -1;
    return ((long long)s * a.qn + i) * a.h + h0 + hoff;
  };
  if (i0 >= qlen) {                    // ragged padding: finite zeros
    for (int r = warp; r < rows; r += nwarps) {
      const long long o = out_row(r);
      if (o >= 0)
        for (int e = lane; e < dv; e += 32) a.out[o * dv + e] = 0.f;
    }
    return;
  }
  const int i_last = min(i0 + a.tokens, qlen) - 1;
  const int lo = a.window > 0 ? max(0, first + i0 - a.window + 1) : 0;
  const int hi = first + i_last;
  const int t0 = lo / kKeys, t1 = hi / kKeys;
  const int32_t* trow = a.table + (long long)s * a.pages_per_slot;

  // padding columns and rows must read as zeros
  for (int i = tid; i < L.total / 16; i += L.threads)
    ((float4*)smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // staging: the warps past the row tiles copy (all warps when every warp
  // computes).  Thread (key, part) copies pieces part, part + parts, ...
  // of row `key` of each tile's K and V rows and (parts 0 and 1) their
  // scales.  Its key's (logical page, row) advances by 16 positions a tile
  // without a division, and its page-table entry is loaded one tile ahead,
  // so that the load is first used a tile later.
  const bool helpers = L.threads > L.compute_threads;
  const int st_tid = helpers ? tid - L.compute_threads : tid;
  const bool stager = st_tid >= 0;
  const int key = st_tid & (kKeys - 1), part = st_tid >> 4;
  const int parts =
      (helpers ? L.threads - L.compute_threads : L.threads) >> 4;
  const int elem = (int)sizeof(T);
  const long long k_tok = (long long)a.kh * d * elem;  // bytes a position
  const long long v_tok = (long long)a.kh * dv * elem;
  const char* k_base = (const char*)a.k_pages + (long long)kvh * d * elem;
  const char* v_base = (const char*)a.v_pages + (long long)kvh * dv * elem;
  int la_t = t0, la_lp = (t0 * kKeys + key) / a.logical;
  int la_off = (t0 * kKeys + key) % a.logical;
  auto look_up = [&](int& page, int& off) {  // tile la_t's entry; advance
    const int p = la_t * kKeys + key;
    page = la_t <= t1 && p >= lo && p <= hi ? trow[la_lp] : -1;
    off = la_off;
    ++la_t;
    la_lp += a.step_pg;
    la_off += a.step_off;
    if (la_off >= a.logical) {
      la_off -= a.logical;
      ++la_lp;
    }
  };
  auto stage = [&](int page, int off, int buf) {
    unsigned char* sb = smem + L.stage_off + buf * L.stage_bytes;
    const bool ok = page >= 0;
    const long long tok = ok ? (long long)page * a.page_rows + off : 0;
    copy_row(sb + key * L.kst * elem, k_base + tok * k_tok, L.k_pieces,
             L.k_chunk, part, parts, ok);
    copy_row(sb + L.v_off + key * L.vst * elem, v_base + tok * v_tok,
             L.v_pieces, L.v_chunk, part, parts, ok);
    if constexpr (kMode != kFp) {
      float* sc = (float*)(sb + L.sc_off);
      if (part < 2)
        cp_async(sc + part * kKeys + key,
                 (part ? a.v_scales : a.k_scales) + tok, 4, ok);
    }
    cp_async_commit();
  };
  // codec tiles are decoded a tile ahead of the products, into the other
  // f32 buffer, by the warps past the row tiles (all warps when every
  // warp computes), and so staged two tiles ahead
  const bool decoder = !helpers || stager;
  const int dwarp = helpers ? warp - L.compute_threads / 32 : warp;
  const int dwarps = helpers ? nwarps - L.compute_threads / 32 : nwarps;
  auto decode = [&](int buf) {         // stage buffer buf -> f32 buffer buf
    const unsigned char* sb = smem + L.stage_off + buf * L.stage_bytes;
    const float* sc = (const float*)(sb + L.sc_off);
    float* fk = (float*)(smem + L.fk_off + buf * L.f_bytes);
    float* fv = (float*)(smem + L.fv_off + buf * L.f_bytes);
    decode_tile<kMode>((const int8_t*)sb, L.kst, sc, fk, L.kfs, d, cb, dwarp,
                       dwarps, lane);
    decode_tile<kMode>((const int8_t*)(sb + L.v_off), L.vst, sc + kKeys, fv,
                       L.vfs, dv, cb, dwarp, dwarps, lane);
  };
  int page_next = -1, off_next = 0;
  if (stager) {
    look_up(page_next, off_next);
    stage(page_next, off_next, 0);
    look_up(page_next, off_next);
    if constexpr (kMode != kFp) {
      stage(page_next, off_next, 1);
      look_up(page_next, off_next);
    }
  }

  // q rows, split once into TF32 hi + lo (rows past q_lens stay zero).
  // The MMA's k index is a label: K step k0's k = t4 and t4 + 4 stand for
  // dims k0 + 2 t4 and k0 + 2 t4 + 1, in q and in the keys alike, so that
  // a lane's two dims are adjacent; a row stores each group of 8 dims as
  // (hi, lo) of dims 0, 1, 2, ..., 7 (16 words)
  for (int r = warp; r < rows; r += nwarps) {
    const long long o = out_row(r);
    if (o < 0 || i0 + r / a.hb >= qlen) continue;
    const float* qrow = a.q + o * d;
    for (int e = lane; e < d; e += 32) {
      uint32_t x, y;
      split(qrow[e], x, y);
      qs[r * L.qs + 2 * e] = x;
      qs[r * L.qs + 2 * e + 1] = y;
    }
  }
  if constexpr (kMode != kFp) {
    for (int i = tid; i < kLevels; i += L.threads) cb[i] = a.codebook[i];
    cp_async_wait_all();
    __syncthreads();                   // tiles t0, t0 + 1 and cb landed
    if (decoder) decode(0);
  }

  // this thread's rows (g and g + 8 of the warp's tile): position and
  // window start; -1 / 0 for rows without a real query
  const int mt = warp / L.col_halves, half = warp % L.col_halves;
  int qpos[2], qlo[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = mt * 16 + g + 8 * j;
    const bool real = out_row(r) >= 0 && i0 + r / a.hb < qlen;
    qpos[j] = real ? first + i0 + r / a.hb : -1;
    qlo[j] = real && a.window > 0 ? max(0, qpos[j] - a.window + 1) : 0;
  }
  // the keys any row of the warp may see: [wlo, whi]
  int wlo = qpos[0] >= 0 ? qlo[0] : INT_MAX, whi = max(qpos[0], qpos[1]);
  if (qpos[1] >= 0) wlo = min(wlo, qlo[1]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    wlo = min(wlo, __shfl_xor_sync(0xffffffffu, wlo, off));
    whi = max(whi, __shfl_xor_sync(0xffffffffu, whi, off));
  }

  const int col0 = half * 8 * kNT;
  const int n_tiles = min(kNT, (L.vp - col0) / 8);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[kNT][4];
#pragma unroll
  for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[ni][e] = 0.f;

  for (int t = t0; t <= t1; ++t) {
    const int buf = (t - t0) & 1;
    cp_async_wait_all();
    __syncthreads();                   // tile t ready; tile t - 1 done
    const CT* kt;
    const CT* vt;
    int ks, vs;
    if constexpr (kMode != kFp) {
      // tile t is decoded (f32 buffer buf) and tile t + 1 landed (stage
      // buffer buf ^ 1): copy tile t + 2 into buf, decode t + 1 into
      // buf ^ 1, beside tile t's products
      if (t + 2 <= t1 && stager) {
        stage(page_next, off_next, buf);
        look_up(page_next, off_next);
      }
      if (t < t1 && decoder) decode(buf ^ 1);
      kt = (const float*)(smem + L.fk_off + buf * L.f_bytes);
      vt = (const float*)(smem + L.fv_off + buf * L.f_bytes);
      ks = L.kfs;
      vs = L.vfs;
    } else {
      if (t < t1 && stager) {
        stage(page_next, off_next, buf ^ 1);
        look_up(page_next, off_next);
      }
      const unsigned char* sb = smem + L.stage_off + buf * L.stage_bytes;
      kt = (const CT*)sb;
      vt = (const CT*)(sb + L.v_off);
      ks = L.kst;
      vs = L.vst;
    }
    if (t * kKeys > whi || t * kKeys + kKeys - 1 < wlo) continue;

    // S = q . k^T: two 8-key tiles x kChains chains (K step mod kChains):
    // kN independent accumulators, j = chain * 2 + key tile
    constexpr int kN = 2 * kChains;
    static_assert(kN == kGroup, "a score group is one term group");
    float sacc[kN][4] = {};
    const uint32_t* qa = qs + (mt * 16 + g) * L.qs + 4 * t4;
    const CT* kb = kt + g * ks + 2 * t4;
    const int steps = L.kp / 8;
#pragma unroll 2
    for (int i = 0; i < steps; i += kChains) {
      uint32_t ah[kN][4], al[kN][4], bh[kN][2], bl[kN][2];
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const int k0 = (i + j / 2) * 8;
        float b0, b1;
        load_q(qa + 2 * k0, L.qs, ah[j], al[j]);
        k_pair(kb + (j % 2) * 8 * ks + k0, b0, b1);
        b_operand<kSplitKey>(b0, b1, bh[j], bl[j]);
      }
      mma_passes<kSplitKey>(sacc, 0, ah, al, bh, bl);
    }

    // online softmax on the score tile: lane (g, t4) holds keys
    // n * 8 + 2 t4 + (e & 1) of rows g (e < 2) and g + 8
    float sv[2][4], mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sacc[n][e];
#pragma unroll
        for (int u = 1; u < kChains; ++u) x += sacc[2 * u + n][e];
        sv[n][e] = x * a.scale;
      }
    if (a.softcap != 0.f) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sv[n][e] = tanhf(sv[n][e] / a.softcap) * a.softcap;
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = e >> 1, p = t * kKeys + n * 8 + 2 * t4 + (e & 1);
        sv[n][e] = p >= qlo[j] && p <= qpos[j] ? sv[n][e] : -INFINITY;
        mx[j] = fmaxf(mx[j], sv[n][e]);
      }
    // exponents against a finite reference (0 while a row has seen no
    // key), so that masked keys and a first max give expf(-inf) = 0
    // without a branch
    float alpha[2], ref[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      const float m_new = fmaxf(m[j], mx[j]);
      ref[j] = m_new == -INFINITY ? 0.f : m_new;
      alpha[j] = expf(m[j] - ref[j]);
      m[j] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = e >> 1;
        sv[n][e] = expf(sv[n][e] - ref[j]);
        sum[j] += sv[n][e];
      }
#pragma unroll
    for (int j = 0; j < 2; ++j) l[j] = __fmaf_rn(l[j], alpha[j], sum[j]);
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) {
      o[ni][0] *= alpha[0];
      o[ni][1] *= alpha[0];
      o[ni][2] *= alpha[1];
      o[ni][3] *= alpha[1];
    }

    // O += P . v: the score accumulator of 8-key tile n is the A fragment
    // of K step n, its keys in the order 0, 2, 4, 6, 1, 3, 5, 7
    // (8 column tiles at a time, each term issued for all 8)
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      uint32_t ph[4], pl[4];
      split(sv[n][0], ph[0], pl[0]);
      split(sv[n][2], ph[1], pl[1]);
      split(sv[n][1], ph[2], pl[2]);
      split(sv[n][3], ph[3], pl[3]);
      const CT* vb = vt + (n * 8 + 2 * t4) * vs + col0 + g;
#pragma unroll
      for (int c0 = 0; c0 < kNT; c0 += kN) {
        if (c0 >= n_tiles) break;
        uint32_t ah[kN][4], al[kN][4], bh[kN][2], bl[kN][2];
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          const int ni = c0 + j;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ah[j][e] = ph[e];
            al[j][e] = pl[e];
          }
          b_operand<kSplitKey>(as_f32(vb[ni * 8]), as_f32(vb[vs + ni * 8]),
                               bh[j], bl[j]);
        }
        mma_passes<kSplitKey>(o, c0, ah, al, bh, bl);
      }
    }
  }

  // row sums from the 4 lanes of each row, then the output rows
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const long long orow = out_row(mt * 16 + g + 8 * j);
    if (orow < 0) continue;
    const float inv = qpos[j] >= 0 ? 1.f / fmaxf(l[j], 1e-20f) : 0.f;
    float* dst = a.out + orow * dv;
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) {
      const int col = col0 + ni * 8 + 2 * t4;
      if (ni >= n_tiles) break;
      const float x0 = o[ni][2 * j] * inv, x1 = o[ni][2 * j + 1] * inv;
      if (dv % 2 == 0 && col < dv) {   // row and col even: 8-byte aligned
        *(float2*)(dst + col) = make_float2(x0, x1);
      } else {
        if (col < dv) dst[col] = x0;
        if (col + 1 < dv) dst[col + 1] = x1;
      }
    }
  }
}

template <typename T, int kMode>
int launch(dim3 grid, cudaStream_t st, const Args& a, const Layout& L) {
  auto kernel = paged_attention_kernel<T, kMode>;
  static int smem_allowed = 0;         // the attribute, set when it grows
  if (L.total > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = L.total;
  }
  kernel<<<grid, L.threads, L.total, st>>>(a, L);
  return (int)cudaGetLastError();
}

template <typename T, int kMode>
int info(int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t e =
      cudaFuncGetAttributes(&attr, paged_attention_kernel<T, kMode>);
  if (e != cudaSuccess) return (int)e;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

Layout layout_for(int pools, int rows, int d, int dv, const void* k_pages,
                  const void* v_pages) {
  const int elem = pools == 0 ? 4 : pools == 1 ? 2 : 1;
  return make_layout(rows, d, dv, elem, pools >= 2, k_pages, v_pages);
}

bool takes(int pools, int rows, int d, int dv, const Layout& L) {
  return pools >= 0 && pools <= 3 && (rows == 16 || rows == 32 ||
                                      rows == 64) &&
         d > 0 && d <= kMaxD && dv > 0 && dv <= kMaxD &&
         L.total <= kMaxSmem;
}

}  // namespace

// pools: 0 = float32, 1 = bfloat16, 2 = int8 codes decoded by "gather",
// 3 = int8 codes decoded by "onehot" (k_scales, v_scales and codebook are
// read only for 2 and 3); rows: query rows a block (16, 32 or 64; tokens x
// heads of one KV head).  0 < d, dv <= 256; anything else returns
// cudaErrorInvalidValue.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages, int pools,
    const void* k_scales, const void* v_scales, const void* codebook,
    const void* table, const void* lengths, const void* q_lens, void* out,
    int n_slots, int qn, int h, int kh, int d, int dv, int rows,
    int page_rows, int logical, int pages_per_slot, int window,
    float softcap, float scale, void* stream) {
  const Layout L = layout_for(pools, rows, d, dv, k_pages, v_pages);
  if (!takes(pools, rows, d, dv, L) || kh <= 0 || h % kh || logical <= 0)
    return (int)cudaErrorInvalidValue;
  if (n_slots == 0 || qn == 0 || h == 0) return (int)cudaGetLastError();
  const int group = h / kh;
  const int hb = group < rows ? group : rows;
  const int tokens = rows / hb;
  const int head_blocks = (group + hb - 1) / hb;
  const dim3 grid((unsigned)((qn + tokens - 1) / tokens * head_blocks),
                  (unsigned)kh, (unsigned)n_slots);
  cudaStream_t st = (cudaStream_t)stream;
  const Args a{(const float*)q, k_pages, v_pages, (const float*)k_scales,
               (const float*)v_scales, (const float*)codebook,
               (const int32_t*)table, (const int32_t*)lengths,
               (const int32_t*)q_lens, (float*)out, qn, h, kh, d, dv,
               page_rows, logical, pages_per_slot, window, hb, tokens,
               head_blocks, kKeys / logical, kKeys % logical, softcap,
               scale};
  switch (pools) {
    case 0: return launch<float, kFp>(grid, st, a, L);
    case 1: return launch<__nv_bfloat16, kFp>(grid, st, a, L);
    case 2: return launch<int8_t, kGather>(grid, st, a, L);
    default: return launch<int8_t, kOneHot>(grid, st, a, L);
  }
}

// The kernel's registers a thread, local (spill) bytes a thread and dynamic
// shared memory a block for these pools, rows a block and widths (16-byte
// aligned pools).
extern "C" int paged_attention_info(int pools, int rows, int d, int dv,
                                    int* regs, int* local_bytes,
                                    int* smem_bytes) {
  const Layout L = layout_for(pools, rows, d, dv, nullptr, nullptr);
  if (!takes(pools, rows, d, dv, L)) return (int)cudaErrorInvalidValue;
  *smem_bytes = L.total;
  switch (pools) {
    case 0: return info<float, kFp>(regs, local_bytes);
    case 1: return info<__nv_bfloat16, kFp>(regs, local_bytes);
    case 2: return info<int8_t, kGather>(regs, local_bytes);
    default: return info<int8_t, kOneHot>(regs, local_bytes);
  }
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
