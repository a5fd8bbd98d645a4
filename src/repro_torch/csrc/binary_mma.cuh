// cp.async staging and the binary tensor-core MMA, shared by the two
// xnor-popcount GEMMs: binary_contraction.cu (packed weights staged as
// they are) and fused_decode_contraction.cu (weights Huffman-decoded into
// shared memory).
//
// mma_b1 is mma.sync m16n8k256 b1 x b1 -> s32 with .and.popc: on sm_90a it
// issues at the s8 m16n8k32 MMA's instruction rate with 8x its k
// (fused_decode_contraction_mma_rate times both).  One k256 step is 8
// packed words of K.  The k index is only a label, so A and B need just
// the same word -> k map; both kernels use lane t4 = lane % 4 feeding
// words 2 t4 and 2 t4 + 1 of the step (one 8-byte shared-memory load) as
// its k blocks t4 and 4 + t4.

#pragma once

#include <stdint.h>

namespace repro_torch {

// Copy ``bytes`` (0 .. 16, or 0 .. 4 when !vec) of src to shared dst and
// zero the rest of the 16-byte (vec) or 4-byte copy.
__device__ __forceinline__ void cp_async(uint32_t* dst, const uint32_t* src,
                                         int bytes, bool vec) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most kPending of this thread's committed groups are in
// flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// d += popcount(a AND b) over k256.
__device__ __forceinline__ void mma_b1(int (&d)[4], uint2 a_lo, uint2 a_hi,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a_lo.x), "r"(a_hi.x), "r"(a_lo.y), "r"(a_hi.y), "r"(b0), "r"(b1));
}

}  // namespace repro_torch
