// Fused separable Lanczos resample, uint8 planar -> uint8 planar, for Hopper (sm_90a).
//
// Replaces lanczos_tpu/ops/resample_pallas.py::_fused_kernel_mxu (the TPU kernel of
// the `precise` main path): fp32 and bf16, each linear, with the FSR dering clamp
// (DERING), with the uint8-quantized intermediate (QUANT), or with both.  The plan (per
// row-tile vertical matrices, deduplicated per column-block horizontal matrices, band
// starts, and for dering the band-relative positions of each output's two central
// taps) is built on the host by lanczos_torch/ops/resample_cuda.py; this kernel reads
// the starts and never recomputes them.
//
// One block computes one (column block b, row tile i, plane p) output tile:
//   1. load the uint8 band x[p, starts_v[i] + k, starts_h[b] + j] (k < kv, j < kh)
//      into shared memory as float, zero past H and W;
//   2. vertical pass  midT[j][r] = sum_k band[k][j] * wvT[i][k][r]   (tile x kh);
//      DERING: clamp to [min, max] of band[cv[i][0][r]][j], band[cv[i][1][r]][j];
//      QUANT: trunc(clip(., 0, 255)); then into shared memory (rounded to bf16 in the
//      bf16 instantiations, after the clamp and the quantize);
//   3. horizontal pass out[r][c] = sum_j midT[j][r] * wh[uniq_h[b]][j][c];
//      DERING: clamp to [min, max] of the stored midT[ch[u][0][c]][r], midT[ch[u][1][c]][r];
//   4. trunc(clip(., 0, 255)) and a store masked at the ragged bottom/right edges.
// The TPU grid ran in order and carried a double-buffered band between steps;
// Hopper blocks run in parallel in no order, so each block loads its own band.  The
// TPU computed the dering bounds as extra one-hot rows and columns of its matrices,
// because Mosaic cannot gather lanes; here the thread that owns a value reads its two
// bounds from shared memory (as 8-float vectors, from rows padded by 4 words so that a
// warp's loads spread over the banks), so dering adds no products.
//
// What bounds it on the H100: not its arithmetic.  Both passes are dense products over
// the per-tile matrices, so at 4K->8K (tile 64, cb 128, kv 37, kh 69) a frame costs
// about 90 multiply-adds per output pixel, ~18 GFLOP, against ~124 MB of compulsory
// uint8 traffic; but deleting either pass's products saves only 0-14% of the time, and
// an asynchronous band ring gains 4-5% (the ablation kernels, ablate_fused.cu; PERF.md),
// so the time goes to the serialized load / vertical / horizontal phases of too few
// blocks in flight.  The work is plain fp32 FMA on the SIMT cores with an 8x4 register
// tile per thread (fused_tile.cuh: two 16-byte shared loads and one 16-byte L1/L2 load
// of weights per 32 FMAs); the weights stay in global memory, where all blocks share
// them through L2.
//
// Layouts (all row-major, contiguous; the wrapper checks them):
//   x      (nc, H, W) uint8            out    (nc, OH, OW) uint8
//   wvT    (num_tiles, kv, tile_p) WT  wh     (n_uniq, kh, cb_p) WT
//   starts_v (num_tiles,) int32        starts_h, uniq_h (n_cb,) int32
//   cv     (num_tiles, 2, tile_p) int32  ch  (n_uniq, 2, cb_p) int32  (DERING only)
// with tile_p = tile rounded up to 8 and cb_p = cb rounded up to 4, zero padded.

#include "fused_tile.cuh"

namespace {

constexpr int kDeringPad = 4;  // words added to both shared row strides when dering

// eight consecutive floats of shared memory (16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float (&v)[MR]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// jnp.clip(v, min(a, b), max(a, b))
__device__ __forceinline__ float clamp_between(float v, float a, float b) {
  return fminf(fmaxf(v, fminf(a, b)), fmaxf(a, b));
}

template <typename WT, bool DERING, bool QUANT>
__global__ void __launch_bounds__(kThreads)
    fused_resample_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                          const WT* __restrict__ wvT, const WT* __restrict__ wh,
                          const int* __restrict__ starts_v, const int* __restrict__ starts_h,
                          const int* __restrict__ uniq_h, const int* __restrict__ cv,
                          const int* __restrict__ ch, Geometry g) {
  extern __shared__ float4 smem4[];
  const int tile_p = g.tile_p, kh_p = g.kh_p, cb_p = g.cb_p;
  // Row strides: the dering instantiations pad both by 4 words, so that
  // the bound loads below (rows of the band or of midT some 2 apart
  // across a warp) spread over the banks instead of sharing a few.
  const int sb = kh_p + (DERING ? kDeringPad : 0), sm = tile_p + (DERING ? kDeringPad : 0);
  float* band = reinterpret_cast<float*>(smem4);  // (kv, sb)
  float* midT = band + g.kv * sb;                 // (kh_p, sm)

  const int b = blockIdx.x, i = blockIdx.y, p = blockIdx.z;
  const int r0 = starts_v[i], c0 = starts_h[b];
  const uint8_t* __restrict__ xp = x + (size_t)p * g.H * g.W;

  // 1. band, zero past the image and past kh
  for (int e = threadIdx.x; e < g.kv * sb; e += kThreads) {
    const int k = e / sb, j = e - k * sb;
    const int r = r0 + k, c = c0 + j;
    band[e] = (j < g.kh && r < g.H && c < g.W) ? (float)xp[(size_t)r * g.W + c] : 0.f;
  }
  __syncthreads();

  float acc[MR][NR];

  // 2. vertical: midT (kh_p x tile_p) = band^T (kh_p x kv) . wvT[i] (kv x tile_p)
  const WT* __restrict__ wv_i = wvT + (size_t)i * g.kv * tile_p;
  const int* __restrict__ cv_i = cv + (size_t)i * 2 * tile_p;
  const int nn_v = tile_p / NR;
  for (int t = threadIdx.x; t < (kh_p / MR) * nn_v; t += kThreads) {
    const int m0 = (t / nn_v) * MR, n0 = (t % nn_v) * NR;
    micro_tile(band, sb, wv_i, tile_p, g.kv, m0, n0, acc);
    if (DERING) {  // clamp to the band rows of tile row n0 + n's central taps
#pragma unroll
      for (int n = 0; n < NR; ++n) {
        float lo[MR], hi[MR];
        load8(band + __ldg(cv_i + n0 + n) * sb + m0, lo);
        load8(band + __ldg(cv_i + tile_p + n0 + n) * sb + m0, hi);
#pragma unroll
        for (int m = 0; m < MR; ++m) acc[m][n] = clamp_between(acc[m][n], lo[m], hi[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int n = 0; n < NR; ++n) {
        float v = acc[m][n];
        if (QUANT) v = truncf(fminf(fmaxf(v, 0.f), 255.f));
        midT[(m0 + m) * sm + n0 + n] = round_mid(v, wv_i);
      }
  }
  __syncthreads();

  // 3./4. horizontal: out tile (tile_p x cb_p) = midT^T (tile_p x kh) . wh[u] (kh x cb_p)
  const int u = uniq_h[b];
  const WT* __restrict__ wh_b = wh + (size_t)u * g.kh * cb_p;
  const int* __restrict__ ch_b = ch + (size_t)u * 2 * cb_p;
  const int rows = min(g.tile, g.OH - i * g.tile), cols = min(g.cb, g.OW - b * g.cb);
  uint8_t* __restrict__ op = out + ((size_t)p * g.OH + (size_t)i * g.tile) * g.OW + (size_t)b * g.cb;
  const int nn_h = cb_p / NR;
  for (int t = threadIdx.x; t < (tile_p / MR) * nn_h; t += kThreads) {
    const int m0 = (t / nn_h) * MR, n0 = (t % nn_h) * NR;
    micro_tile(midT, sm, wh_b, cb_p, g.kh, m0, n0, acc);
    if (DERING) {  // clamp to the stored midT rows of column n0 + n's central taps
#pragma unroll
      for (int n = 0; n < NR; ++n) {
        float lo[MR], hi[MR];
        load8(midT + __ldg(ch_b + n0 + n) * sm + m0, lo);
        load8(midT + __ldg(ch_b + cb_p + n0 + n) * sm + m0, hi);
#pragma unroll
        for (int m = 0; m < MR; ++m) acc[m][n] = clamp_between(acc[m][n], lo[m], hi[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      if (m0 + m >= rows) break;
#pragma unroll
      for (int n = 0; n < NR; ++n) {
        if (n0 + n < cols) {
          const float v = fminf(fmaxf(acc[m][n], 0.f), 255.f);
          op[(size_t)(m0 + m) * g.OW + n0 + n] = (uint8_t)__float2uint_rz(v);
        }
      }
    }
  }
}

template <typename WT, bool DERING, bool QUANT>
cudaError_t launch(const uint8_t* x, uint8_t* out, const void* wvT, const void* wh,
                   const int* starts_v, const int* starts_h, const int* uniq_h, const int* cv,
                   const int* ch, const Geometry& g, int nc, int n_cb, int num_tiles,
                   cudaStream_t stream) {
  const int pad = DERING ? kDeringPad : 0;
  const size_t smem =
      sizeof(float) * ((size_t)g.kv * (g.kh_p + pad) + (size_t)g.kh_p * (g.tile_p + pad));
  auto* kernel = fused_resample_kernel<WT, DERING, QUANT>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(n_cb, num_tiles, nc);
  kernel<<<grid, kThreads, smem, stream>>>(x, out, static_cast<const WT*>(wvT),
                                           static_cast<const WT*>(wh), starts_v, starts_h,
                                           uniq_h, cv, ch, g);
  return cudaGetLastError();
}

template <typename WT>
cudaError_t launch_variant(int dering, int quant, const uint8_t* x, uint8_t* out,
                           const void* wvT, const void* wh, const int* sv, const int* sh,
                           const int* uh, const int* cv, const int* ch, const Geometry& g,
                           int nc, int n_cb, int num_tiles, cudaStream_t st) {
  if (dering && quant)
    return launch<WT, true, true>(x, out, wvT, wh, sv, sh, uh, cv, ch, g, nc, n_cb, num_tiles, st);
  if (dering)
    return launch<WT, true, false>(x, out, wvT, wh, sv, sh, uh, cv, ch, g, nc, n_cb, num_tiles, st);
  if (quant)
    return launch<WT, false, true>(x, out, wvT, wh, sv, sh, uh, cv, ch, g, nc, n_cb, num_tiles, st);
  return launch<WT, false, false>(x, out, wvT, wh, sv, sh, uh, cv, ch, g, nc, n_cb, num_tiles, st);
}

}  // namespace

extern "C" int lanczos_fused_resample(const void* x, void* out, const void* wvT, const void* wh,
                                      const void* starts_v, const void* starts_h,
                                      const void* uniq_h, const void* cv, const void* ch,
                                      int nc, int H, int W, int OH, int OW, int tile,
                                      int tile_p, int kv, int cb, int cb_p, int kh, int kh_p,
                                      int n_cb, int num_tiles, int bf16, int dering, int quant,
                                      void* stream) {
  const Geometry g{H, W, OH, OW, tile, tile_p, kv, cb, cb_p, kh, kh_p};
  auto* xs = static_cast<const uint8_t*>(x);
  auto* os = static_cast<uint8_t*>(out);
  auto* sv = static_cast<const int*>(starts_v);
  auto* sh = static_cast<const int*>(starts_h);
  auto* uh = static_cast<const int*>(uniq_h);
  auto* cvs = static_cast<const int*>(cv);
  auto* chs = static_cast<const int*>(ch);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch_variant<__nv_bfloat16>(dering, quant, xs, os, wvT, wh, sv, sh, uh, cvs, chs,
                                           g, nc, n_cb, num_tiles, st)
           : launch_variant<float>(dering, quant, xs, os, wvT, wh, sv, sh, uh, cvs, chs, g, nc,
                                   n_cb, num_tiles, st);
  return (int)e;
}

extern "C" const char* lanczos_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
