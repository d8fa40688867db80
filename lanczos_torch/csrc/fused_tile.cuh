// The dense fused kernel's register-tiled product and its operand loads, shared by the
// per-tile and the row-walk kernel of ablate_fused.cu, so that an ablation variant runs
// exactly `full`'s arithmetic in every stage it keeps.  This is the design carried over
// from the TPU kernel (dense products over per-tile windows); the production kernel,
// fused_resample.cu, no longer uses it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int MR = 8;  // rows of a thread's register tile (the shared-memory operand)
constexpr int NR = 4;  // columns of a thread's register tile (the global-memory operand)

struct Geometry {
  int H, W, OH, OW, tile, tile_p, kv, cb, cb_p, kh, kh_p;
};

__device__ __forceinline__ void load4(const float* __restrict__ p, float (&v)[NR]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* __restrict__ p, float (&v)[NR]) {
  // four bf16 in 8 bytes, element 0 in the low half of the first word
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xffff0000u);
}

__device__ __forceinline__ float round_mid(float v, const float*) { return v; }

__device__ __forceinline__ float round_mid(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// eight consecutive values of the shared-memory operand (16-byte aligned), as float
__device__ __forceinline__ void load_a(const float* p, float (&a)[MR]) {
  const float4 a0 = *reinterpret_cast<const float4*>(p);
  const float4 a1 = *reinterpret_cast<const float4*>(p + 4);
  a[0] = a0.x, a[1] = a0.y, a[2] = a0.z, a[3] = a0.w;
  a[4] = a1.x, a[5] = a1.y, a[6] = a1.z, a[7] = a1.w;
}

__device__ __forceinline__ void load_a(const __nv_bfloat16* p, float (&a)[MR]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[2 * i] = __uint_as_float(w[i] << 16);
    a[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// acc[m][n] = sum_k At[k * lda + m0 + m] * B[k * ldb + n0 + n] over k < K.
// At lives in shared memory (k-major, 16-byte aligned rows); B in global memory.
template <typename AT, typename WT>
__device__ __forceinline__ void micro_tile(const AT* __restrict__ At, int lda,
                                           const WT* __restrict__ B, int ldb, int K, int m0,
                                           int n0, float (&acc)[MR][NR]) {
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int n = 0; n < NR; ++n) acc[m][n] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[MR];
    load_a(At + k * lda + m0, a);
    float b[NR];
    load4(B + (size_t)k * ldb + n0, b);
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int n = 0; n < NR; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
  }
}

}  // namespace
