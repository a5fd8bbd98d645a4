// Ragged paged attention over slot page tables for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py
// (paged_mixed_attention, _kernel) for fp pools.  Its plain PyTorch version
// is repro_torch/kernels/paged_attention.py::paged_mixed_attention_plain.
//
// Inputs: q (S, Q, H, D) f32, already scaled; page pools k (n_pages, rows,
// KH, D) and v (n_pages, rows, KH, Dv) in f32 or bf16; table (S, P) int32
// physical page per logical page; lengths (S,) valid positions including
// this block; q_lens (S,) real query tokens per slot.  Query i < q_lens[s]
// of slot s sits at position lengths[s] - q_lens[s] + i and attends keys at
// positions <= its own (and > position - window when window > 0).  Logical
// page j covers positions [j * logical, (j + 1) * logical); physical rows
// at or past `logical` are layout padding and never read.  Page 0 is the
// dummy sink: no valid position maps to it, so it is never read.  Rows
// i >= q_lens[s] write zeros.  Output (S, Q, H, Dv) f32.
//
// Launch: one warp per (slot, query token, head), four warps a block.
// Lanes split D (lane l holds elements l, l + 32, ...: 4 a lane at D = 128,
// each load of a key row coalesced across the warp); a butterfly shuffle
// sums each score.  The warp walks only the positions its token may see,
// through the slot's page table, with an online softmax in f32.
//
// What bounds it on the card: the K/V bytes it reads.  Each warp reads its
// KV head's rows once; the G = H / KH warps of one GQA group read the same
// rows, which the L1/L2 caches absorb.  This first version keeps one key
// per loop step per warp — simple and right; tiling keys through shared
// memory and tensor cores is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxPerLane = 8;       // D, Dv <= 256
constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void paged_attention_kernel(
    const float* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int32_t* __restrict__ table,
    const int32_t* __restrict__ lengths, const int32_t* __restrict__ q_lens,
    float* __restrict__ out, int n_slots, int qn, int h, int kh, int d,
    int dv, int page_rows, int logical, int pages_per_slot, int window,
    float softcap, float scale) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= (long long)n_slots * qn * h) return;
  const int head = (int)(warp % h);
  const int qi = (int)((warp / h) % qn);
  const int s = (int)(warp / ((long long)h * qn));
  float* o = out + warp * dv;          // (S, Q, H, Dv): row (s, qi, head)

  const int qlen = q_lens[s];
  if (qi >= qlen) {                    // ragged padding: finite zeros
    for (int j = lane; j < dv; j += 32) o[j] = 0.f;
    return;
  }
  const int qpos = lengths[s] - qlen + qi;
  const int kvh = head / (h / kh);
  const float* qrow = q + warp * d;
  float qv[kMaxPerLane], acc[kMaxPerLane];
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int e = lane + 32 * j;
    qv[j] = e < d ? qrow[e] : 0.f;
    acc[j] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const int32_t* trow = table + (long long)s * pages_per_slot;
  const int lo = window > 0 ? max(0, qpos - window + 1) : 0;
  for (int p = lo; p <= qpos; ++p) {
    const long long row =
        ((long long)trow[p / logical] * page_rows + p % logical) * kh + kvh;
    const T* krow = k_pages + row * d;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      const int e = lane + 32 * j;
      if (e < d) part += qv[j] * load_f32(krow + e);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    float sc = part * scale;
    if (softcap != 0.f) sc = tanhf(sc / softcap) * softcap;
    const float m_new = fmaxf(m, sc);
    const float alpha = expf(m - m_new);   // 0 on the first key
    const float pe = expf(sc - m_new);
    l = l * alpha + pe;
    const T* vrow = v_pages + row * dv;
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      const int e = lane + 32 * j;
      if (e < dv) acc[j] = acc[j] * alpha + pe * load_f32(vrow + e);
    }
    m = m_new;
  }
  const float inv = 1.f / fmaxf(l, 1e-20f);
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int e = lane + 32 * j;
    if (e < dv) o[e] = acc[j] * inv;
  }
}

}  // namespace

// dtype: 0 = float32 pools, 1 = bfloat16 pools
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages, int dtype,
    const void* table, const void* lengths, const void* q_lens, void* out,
    int n_slots, int qn, int h, int kh, int d, int dv, int page_rows,
    int logical, int pages_per_slot, int window, float softcap, float scale,
    void* stream) {
  const long long warps = (long long)n_slots * qn * h;
  if (warps == 0) return (int)cudaGetLastError();
  const unsigned blocks =
      (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 threads(32 * kWarpsPerBlock);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    paged_attention_kernel<float><<<blocks, threads, 0, st>>>(
        (const float*)q, (const float*)k_pages, (const float*)v_pages,
        (const int32_t*)table, (const int32_t*)lengths,
        (const int32_t*)q_lens, (float*)out, n_slots, qn, h, kh, d, dv,
        page_rows, logical, pages_per_slot, window, softcap, scale);
  } else if (dtype == 1) {
    paged_attention_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const float*)q, (const __nv_bfloat16*)k_pages,
        (const __nv_bfloat16*)v_pages, (const int32_t*)table,
        (const int32_t*)lengths, (const int32_t*)q_lens, (float*)out, n_slots,
        qn, h, kh, d, dv, page_rows, logical, pages_per_slot, window, softcap,
        scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
