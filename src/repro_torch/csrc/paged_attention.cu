// Ragged paged attention over slot page tables for Hopper (sm_90a).
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
// physical rows at or past `logical` are layout padding and never read.
// Page 0 is the dummy sink: no valid position maps to it, so it is never
// read.  Rows i >= q_lens[s] write zeros.  Output (S, Q, H, Dv) f32.
//
// Launch: one warp per (slot, query token, head), four warps a block.
// Lanes split D (lane l holds elements l, l + 32, ...; kPerLane of them, a
// template parameter: 4 for D <= 128, 8 for 256, so a narrow head keeps a
// narrow register file); each load of a key row is coalesced across the
// warp, and a butterfly shuffle sums each score.  The warp walks only the positions its token may see,
// through the slot's page table, with an online softmax in f32.
//
// Codec pools: each block stages the codebook in shared memory once; code
// c of the row at (page, token) decodes to cb[c + 128] * scale[page, token]
// (one scale serves every KV head of the token), one rounded f32
// multiply, and only then enters the dot and the value sum.  Every
// instruction after the element load is shared with the fp pools (one
// template), and the multiply-adds are pinned (__fmaf_rn), so the codec
// kernel gives the fp kernel's bits on pools decoded up front into f32.
// "gather" reads the codebook entry directly; "onehot" sums the 256
// entries masked by (index == code), as the reference's vector-unit lookup
// did: the same bits, 256 times the work, kept as the bit-identity
// reference.
//
// What bounds it on the card: the K/V bytes it reads for a decode block
// (int8 codes halve them against bf16), the score and value products for a
// long prefill block.  Each warp reads its KV head's rows once; the G =
// H / KH warps of one GQA group read the same rows, which the L1/L2 caches
// absorb.  This first version keeps one key per loop step per warp, far
// from either bound: the serial per-key steps of every warp (and, for
// codec pools, the decode of each element in each of the G warps) set its
// time.  Simple and right; tiling keys through shared memory and tensor
// cores, and decoding each row once per GQA group, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kLevels = 256;         // codebook entries
constexpr int kZeroCode = 128;       // codebook index of code 0

enum Mode { kFp = 0, kGather = 1, kOneHot = 2 };

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Element e of a K or V row: the fp value, or the decoded codec value.
template <typename T, int kMode>
__device__ __forceinline__ float element(const T* row, int e, float row_scale,
                                         const float* cb) {
  if constexpr (kMode == kFp) {
    return load_f32(row + e);
  } else {
    const int idx = (int)row[e] + kZeroCode;
    float c;
    if constexpr (kMode == kGather) {
      c = cb[idx];
    } else {
      c = 0.f;
      for (int i = 0; i < kLevels; ++i) c += i == idx ? cb[i] : 0.f;
    }
    return __fmul_rn(c, row_scale);
  }
}

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
  int n_slots, qn, h, kh, d, dv, page_rows, logical, pages_per_slot;
  int window;
  float softcap, scale;
};

template <typename T, int kMode, int kPerLane>
__global__ void paged_attention_kernel(const Args a) {
  __shared__ float cb[kMode == kFp ? 1 : kLevels];
  if constexpr (kMode != kFp) {
    for (int i = threadIdx.x; i < kLevels; i += blockDim.x)
      cb[i] = a.codebook[i];
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= (long long)a.n_slots * a.qn * a.h) return;
  const int head = (int)(warp % a.h);
  const int qi = (int)((warp / a.h) % a.qn);
  const int s = (int)(warp / ((long long)a.h * a.qn));
  const int d = a.d, dv = a.dv;
  float* o = a.out + warp * dv;        // (S, Q, H, Dv): row (s, qi, head)

  const int qlen = a.q_lens[s];
  if (qi >= qlen) {                    // ragged padding: finite zeros
    for (int j = lane; j < dv; j += 32) o[j] = 0.f;
    return;
  }
  const int qpos = a.lengths[s] - qlen + qi;
  const int kvh = head / (a.h / a.kh);
  const T* k_pages = (const T*)a.k_pages;
  const T* v_pages = (const T*)a.v_pages;
  const float* qrow = a.q + warp * d;
  float qv[kPerLane], acc[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int e = lane + 32 * j;
    qv[j] = e < d ? qrow[e] : 0.f;
    acc[j] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const int32_t* trow = a.table + (long long)s * a.pages_per_slot;
  const int lo = a.window > 0 ? max(0, qpos - a.window + 1) : 0;
  for (int p = lo; p <= qpos; ++p) {
    const long long prow =             // (page, token) of position p
        (long long)trow[p / a.logical] * a.page_rows + p % a.logical;
    const long long row = prow * a.kh + kvh;
    float ks = 1.f, vs = 1.f;
    if constexpr (kMode != kFp) {
      ks = a.k_scales[prow];
      vs = a.v_scales[prow];
    }
    const T* krow = k_pages + row * d;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int e = lane + 32 * j;
      if (e < d) part = __fmaf_rn(qv[j], element<T, kMode>(krow, e, ks, cb),
                                  part);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    float sc = part * a.scale;
    if (a.softcap != 0.f) sc = tanhf(sc / a.softcap) * a.softcap;
    const float m_new = fmaxf(m, sc);
    const float alpha = expf(m - m_new);   // 0 on the first key
    const float pe = expf(sc - m_new);
    l = __fmaf_rn(l, alpha, pe);
    const T* vrow = v_pages + row * dv;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int e = lane + 32 * j;
      if (e < dv)
        acc[j] = __fmaf_rn(pe, element<T, kMode>(vrow, e, vs, cb),
                           __fmul_rn(acc[j], alpha));
    }
    m = m_new;
  }
  const float inv = 1.f / fmaxf(l, 1e-20f);
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int e = lane + 32 * j;
    if (e < dv) o[e] = acc[j] * inv;
  }
}

template <typename T, int kMode>
int launch(int per_lane, unsigned blocks, cudaStream_t st, const Args& a) {
  switch (per_lane) {
    case 4:
      paged_attention_kernel<T, kMode, 4>
          <<<blocks, 32 * kWarpsPerBlock, 0, st>>>(a);
      break;
    case 8:
      paged_attention_kernel<T, kMode, 8>
          <<<blocks, 32 * kWarpsPerBlock, 0, st>>>(a);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// pools: 0 = float32, 1 = bfloat16, 2 = int8 codes decoded by "gather",
// 3 = int8 codes decoded by "onehot" (k_scales, v_scales and codebook are
// read only for 2 and 3); per_lane: elements of D and Dv a lane holds (4
// or 8; D, Dv <= 32 * per_lane)
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages, int pools,
    const void* k_scales, const void* v_scales, const void* codebook,
    const void* table, const void* lengths, const void* q_lens, void* out,
    int n_slots, int qn, int h, int kh, int d, int dv, int per_lane,
    int page_rows, int logical, int pages_per_slot, int window,
    float softcap, float scale, void* stream) {
  const long long warps = (long long)n_slots * qn * h;
  if (warps == 0) return (int)cudaGetLastError();
  if ((d > dv ? d : dv) > 32 * per_lane)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks =
      (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t st = (cudaStream_t)stream;
  const Args a{(const float*)q, k_pages, v_pages, (const float*)k_scales,
               (const float*)v_scales, (const float*)codebook,
               (const int32_t*)table, (const int32_t*)lengths,
               (const int32_t*)q_lens, (float*)out, n_slots, qn, h, kh, d,
               dv, page_rows, logical, pages_per_slot, window, softcap,
               scale};
  int code;
  switch (pools) {
    case 0: code = launch<float, kFp>(per_lane, blocks, st, a); break;
    case 1:
      code = launch<__nv_bfloat16, kFp>(per_lane, blocks, st, a);
      break;
    case 2:
      code = launch<int8_t, kGather>(per_lane, blocks, st, a);
      break;
    case 3:
      code = launch<int8_t, kOneHot>(per_lane, blocks, st, a);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return code ? code : (int)cudaGetLastError();
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
