// Fused separable Lanczos resample, uint8 planar -> uint8 planar, for Hopper (sm_90a).
//
// Replaces lanczos_tpu/ops/resample_pallas.py::_fused_kernel_mxu (the TPU kernel of
// the `precise` main path): fp32 and bf16, each linear, with the FSR dering clamp
// (DERING), with the uint8-quantized intermediate (QUANT), or with both.  The plan (per
// row-tile vertical weights, deduplicated per column-block horizontal weights, band
// starts, and for dering the band-relative positions of each output's two central
// taps) is built on the host by lanczos_torch/ops/resample_cuda.py; this kernel reads
// the starts and never recomputes them.
//
// What bounds it on the H100: device memory.  A frame must move its input once and its
// output once (at 4K->8K, 3 planes: 24.9 MB + 99.5 MB = 124.4 MB, 0.037 ms at
// 3.35 TB/s) and needs 2*support multiply-adds per value and pass (0.9 G at 4K->8K,
// 0.027 ms at the SIMT fp32 peak).  The TPU kernel's passes were dense products over
// per-tile windows, about 90 multiply-adds a pixel, because the matrix unit made the
// zeros of its banded matrices free; on SIMT cores they are ten times the work.  What
// this design does about it:
//   - band-sparse products: the host cuts each group of four output rows (columns) down
//     to the one window of the band that any of the four touches (group_windows: 7 taps
//     at 2x where a row has 6), so a thread's 8x4 register tile runs win_v (win_h) steps
//     instead of kv (kh): about 12 multiply-adds a pixel at 2x.  Any plan fits: long or
//     scattered runs only lengthen the windows;
//   - 16-byte global traffic: the band is loaded as aligned 16-byte vectors (from the
//     16-byte boundary at or below the block's first column; zero past the image) and
//     kept in shared memory as uint8, converted where the vertical pass reads it; the
//     output tile is staged in shared memory as uint8 and leaves as 16-byte stores, a
//     whole 128-byte row segment per 8 threads.  Byte paths serve a width that is not a
//     multiple of 16 (input W, output OW or the block's first column) and the ragged
//     right edge;
//   - no division in the loops that run per value: steps count up, offsets come from
//     the plan's tables (one division per 8x4 register tile splits its index);
//   - the block's weights, window bases and central-tap offsets are copied into shared
//     memory beside the band, all by cp.async, so one round trip to L2 or device memory
//     covers everything the block reads (loads that pass through registers wait loop by
//     loop, and weights read from global memory where they are used miss L1 at every
//     window step of the vertical pass: every row tile has its own);
//   - shared memory per block falls to the uint8 band, the fp32 intermediate, the staged
//     tile and those tables (about 38 KB at tile 64 x cb 128), and registers are held to
//     64 a thread, so that four blocks share an SM and one block's copies and stores hide
//     behind another's arithmetic;
//   - bf16 keeps its meaning (weights rounded on the host, the intermediate rounded to
//     bf16 after the clamp and the quantize) but buys no arithmetic: its products are
//     the same fp32 FMAs, so it costs what fp32 costs.
//
// One block computes one (column block b, row tile i, plane p) output tile:
//   1. band[k][c] = x[p, starts_v[i] + k, cA + c], cA = starts_h[b] rounded down to 16;
//   2. vertical pass, thread tile 8 band columns x 4 output rows (one group):
//        midT[j][r] = sum_s wv[i][s][r/4][r%4] * band[base_v[i][r/4] + s][j]
//      DERING: clamp to [min, max] of band[cv[i][0][r]][j], band[cv[i][1][r]][j];
//      QUANT: trunc(clip(., 0, 255)); bf16: round to bf16; store to shared memory;
//   3. horizontal pass, thread tile 8 output rows x 4 output columns (one group):
//        out[r][c] = sum_s midT[base_h[u][c/4] + s][r] * wh[u][s][c/4][c%4], u = uniq_h[b]
//      DERING: clamp to the stored midT[ch[u][0][c]][r], midT[ch[u][1][c]][r];
//   4. trunc(clip(., 0, 255)) into the staged tile, then the store, masked at the ragged
//      bottom and right edges.
// Sums are fused multiply-adds in step order: the plain PyTorch version takes the same
// taps in the same order, each rounded once as fmaf rounds it (lanczos_torch/ops/_fma.py),
// and gives identical bytes.
//
// Layouts (all row-major, contiguous; the wrapper checks them):
//   x      (nc, H, W) uint8                   out    (nc, OH, OW) uint8
//   wv     (num_tiles, win_v, tile_p/4, 4) f32   base_v (num_tiles, tile_p/4) int32
//   wh     (n_uniq, win_h, cb_p/4, 4) f32        base_h (n_uniq, cb_p/4) int32
//   starts_v (num_tiles,) int32               starts_h, uniq_h (n_cb,) int32
//   cv     (num_tiles, 2, tile_p) int32       ch     (n_uniq, 2, cb_p) int32  (DERING only)
// with tile_p = tile rounded up to 8 and cb_p = cb rounded up to 4, zero padded, and
// base + win inside the band for every group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Geometry {
  int H, W, OH, OW, tile, tile_p, kv, cb, cb_p, kh, win_v, win_h;
  int bw;       // bytes of a band row in shared memory (a multiple of 16)
  int mw;       // columns of the intermediate in shared memory (a multiple of 8)
  int stage_w;  // bytes of a staged output row: 16 << stage_lg
  int stage_lg, chunk_lg;  // log2 of 16-byte chunks per staged row, per band row (rounded up)
  int vec_in, vec_out;     // 16-byte paths allowed by W, OW and the pointers
  int nrg_v_lg, nrg_h_lg;  // log2 of tile_p / 4 and tile_p / 8 where powers of two, else -1
};

template <bool BF16>
__device__ __forceinline__ float round_mid(float v) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// jnp.clip(v, min(a, b), max(a, b))
__device__ __forceinline__ float clamp_between(float v, float a, float b) {
  return fminf(fmaxf(v, fminf(a, b)), fmaxf(a, b));
}

// byte i of w as float: the byte goes into the mantissa of 2^23, which is then taken off
template <int I>
__device__ __forceinline__ float byte_to_float(unsigned w) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + I)) - 8388608.f;
}

// eight consecutive uint8 of shared memory (8-byte aligned) as floats
__device__ __forceinline__ void load8_u8(const uint8_t* p, float (&a)[8]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  a[0] = byte_to_float<0>(raw.x), a[1] = byte_to_float<1>(raw.x);
  a[2] = byte_to_float<2>(raw.x), a[3] = byte_to_float<3>(raw.x);
  a[4] = byte_to_float<0>(raw.y), a[5] = byte_to_float<1>(raw.y);
  a[6] = byte_to_float<2>(raw.y), a[7] = byte_to_float<3>(raw.y);
}

// rows r0..r0+3 and r0+half..r0+half+3 of one column of midT (16-byte aligned)
__device__ __forceinline__ void load8_f32(const float* p, int half, float (&a)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + half);
  a[0] = lo.x, a[1] = lo.y, a[2] = lo.z, a[3] = lo.w;
  a[4] = hi.x, a[5] = hi.y, a[6] = hi.z, a[7] = hi.w;
}

__device__ __forceinline__ void fma_tile(const float (&a)[8], const float4 w,
                                         float (&acc)[8][4]) {
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    acc[m][0] = fmaf(a[m], w.x, acc[m][0]);
    acc[m][1] = fmaf(a[m], w.y, acc[m][1]);
    acc[m][2] = fmaf(a[m], w.z, acc[m][2]);
    acc[m][3] = fmaf(a[m], w.w, acc[m][3]);
  }
}

// trunc(clip(v, 0, 255)) of four outputs as the bytes of one word, v[0] lowest: each is
// truncated to a signed integer (NaN to 0), then cvt.pack saturates two at a time to
// uint8 (below 0 to 0, above 255 to 255) into the low half above its third operand's
__device__ __forceinline__ unsigned quantize4(const float (&v)[4]) {
  unsigned hi, word;
  asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, %3;\n"
      : "=r"(hi)
      : "r"(__float2int_rz(v[3])), "r"(__float2int_rz(v[2])), "r"(0u));
  asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, %3;\n"
      : "=r"(word)
      : "r"(__float2int_rz(v[1])), "r"(__float2int_rz(v[0])), "r"(hi));
  return word;
}

// asynchronous copies global -> shared: 16 bytes through L1 (tables other blocks of the SM
// share), 16 bytes past L1 with src_bytes of 16 or 0 (0 fills with zeros), and 4 bytes
__device__ __forceinline__ void cp_async16_ca(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async16_cg(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// where 16-byte chunk q of staged row r lives: chunks are swizzled by the row's group
// of four, so that the eight row groups a warp stores at once fall on different banks
__device__ __forceinline__ int stage_chunk(int r, int q, int mask) {
  return q ^ ((r >> 2) & mask);
}

// t / n and t % n of a thread tile's index: a shift where n is a power of two (lg >= 0)
__device__ __forceinline__ void split(int t, int n, int lg, int& hi, int& lo) {
  hi = lg >= 0 ? t >> lg : t / n;
  lo = t - hi * n;
}

template <bool BF16, bool DERING, bool QUANT>
__global__ void __launch_bounds__(kThreads, 4)
    fused_resample_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                          const float4* __restrict__ wv, const float4* __restrict__ wh,
                          const int* __restrict__ base_v, const int* __restrict__ base_h,
                          const int* __restrict__ starts_v, const int* __restrict__ starts_h,
                          const int* __restrict__ uniq_h, const int* __restrict__ cv,
                          const int* __restrict__ ch, Geometry g) {
  extern __shared__ uint4 smem16[];
  const int tile_p = g.tile_p, bw = g.bw;
  const int nrg_v = tile_p >> 2, ncg = g.cb_p >> 2;
  uint8_t* band = reinterpret_cast<uint8_t*>(smem16);                 // (kv, bw)
  float* midT = reinterpret_cast<float*>(band + g.kv * bw);           // (mw, tile_p)
  uint8_t* stage = reinterpret_cast<uint8_t*>(midT + g.mw * tile_p);  // (tile_p, stage_w)
  float4* wv_s = reinterpret_cast<float4*>(stage + tile_p * g.stage_w);  // (win_v, nrg_v)
  float4* wh_s = wv_s + g.win_v * nrg_v;                                 // (win_h, ncg)
  int* cv_s = reinterpret_cast<int*>(wh_s + g.win_h * ncg);              // (2, tile_p) DERING
  int* ch_s = cv_s + (DERING ? 2 * tile_p : 0);                          // (2, cb_p) DERING
  int* base_v_s = ch_s + (DERING ? 2 * g.cb_p : 0);                      // (nrg_v,)
  int* base_h_s = base_v_s + nrg_v;                                      // (ncg,)

  const int b = blockIdx.x, i = blockIdx.y, p = blockIdx.z;
  const int r0 = starts_v[i], c0 = starts_h[b], u = uniq_h[b];
  const int cA = c0 & ~15;  // first column of the band in shared memory
  const int joff = c0 & 8;  // band byte of intermediate column 0
  const int dj = c0 & 7;    // intermediate column of the plan's band column 0
  const uint8_t* __restrict__ xp = x + (size_t)p * g.H * g.W;

  // 1. the block's tables and its band, all as asynchronous copies in flight together:
  //    16-byte chunks, the band's zero past the image
  {
    const float4* __restrict__ wv_i = wv + (size_t)i * g.win_v * nrg_v;
    const float4* __restrict__ wh_u = wh + (size_t)u * g.win_h * ncg;
    for (int e = threadIdx.x; e < g.win_v * nrg_v; e += kThreads) cp_async16_ca(wv_s + e, wv_i + e);
    for (int e = threadIdx.x; e < g.win_h * ncg; e += kThreads) cp_async16_ca(wh_s + e, wh_u + e);
    for (int e = threadIdx.x; e < nrg_v; e += kThreads)
      cp_async4(base_v_s + e, base_v + (size_t)i * nrg_v + e);
    for (int e = threadIdx.x; e < ncg; e += kThreads)
      cp_async4(base_h_s + e, base_h + (size_t)u * ncg + e);
    if (DERING) {
      const int4* __restrict__ cv_i = reinterpret_cast<const int4*>(cv + (size_t)i * 2 * tile_p);
      const int4* __restrict__ ch_u = reinterpret_cast<const int4*>(ch + (size_t)u * 2 * g.cb_p);
      for (int e = threadIdx.x; e < tile_p >> 1; e += kThreads)
        cp_async16_ca(reinterpret_cast<int4*>(cv_s) + e, cv_i + e);
      for (int e = threadIdx.x; e < g.cb_p >> 1; e += kThreads)
        cp_async16_ca(reinterpret_cast<int4*>(ch_s) + e, ch_u + e);
    }
    const int per_row = 1 << g.chunk_lg, nch = bw >> 4;
    for (int e = threadIdx.x; e < (g.kv << g.chunk_lg); e += kThreads) {
      const int k = e >> g.chunk_lg, q = e & (per_row - 1);
      if (q >= nch) continue;
      const int r = r0 + k, c = cA + 16 * q;
      const bool in = r < g.H && c < g.W;
      const uint8_t* src = xp + (size_t)r * g.W + c;
      uint4* dst = reinterpret_cast<uint4*>(band + k * bw + 16 * q);
      if (g.vec_in) {
        cp_async16_cg(dst, in ? src : xp, in ? 16 : 0);
      } else {
        unsigned w0 = 0u, w1 = 0u, w2 = 0u, w3 = 0u;
        const int n = in ? min(16, g.W - c) : 0;
        for (int t = 0; t < n; ++t) {
          const unsigned v = (unsigned)__ldg(src + t) << (8 * (t & 3));
          if (t < 4) w0 |= v;
          else if (t < 8) w1 |= v;
          else if (t < 12) w2 |= v;
          else w3 |= v;
        }
        *dst = make_uint4(w0, w1, w2, w3);
      }
    }
    cp_async_wait_all();
  }
  __syncthreads();

  float acc[8][4];

  // 2. vertical: thread tile = 8 intermediate columns x one group of 4 tile rows
  for (int t = threadIdx.x; t < (g.mw >> 3) * nrg_v; t += kThreads) {
    int jg, rg;
    split(t, nrg_v, g.nrg_v_lg, jg, rg);
    const uint8_t* bcol = band + joff + 8 * jg;
    const uint8_t* bp = bcol + base_v_s[rg] * bw;
    const float4* wp = wv_s + rg;
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;
#pragma unroll 2
    for (int s = 0; s < g.win_v; ++s) {
      float a[8];
      load8_u8(bp + s * bw, a);
      fma_tile(a, wp[s * nrg_v], acc);
    }
    if (DERING) {  // clamp to the band rows of tile row 4 rg + n's central taps
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float lo[8], hi[8];
        load8_u8(bcol + cv_s[4 * rg + n] * bw, lo);
        load8_u8(bcol + cv_s[tile_p + 4 * rg + n] * bw, hi);
#pragma unroll
        for (int m = 0; m < 8; ++m) acc[m][n] = clamp_between(acc[m][n], lo[m], hi[m]);
      }
    }
    float* mcol = midT + 8 * jg * tile_p + 4 * rg;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      float v[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        v[n] = acc[m][n];
        if (QUANT) v[n] = truncf(fminf(fmaxf(v[n], 0.f), 255.f));
        v[n] = round_mid<BF16>(v[n]);
      }
      *reinterpret_cast<float4*>(mcol + m * tile_p) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  __syncthreads();

  // 3. horizontal: thread tile = rows {4 rg.., half + 4 rg..} x one group of 4 columns;
  //    4. trunc-clip into the staged tile
  const int mask = min(1 << g.stage_lg, 8) - 1;
  {
    const int nrg = tile_p >> 3, half = tile_p >> 1;
    for (int t = threadIdx.x; t < ncg * nrg; t += kThreads) {
      int cg, rg;
      split(t, nrg, g.nrg_h_lg, cg, rg);
      const float* mrow = midT + dj * tile_p + 4 * rg;
      const float* mp = mrow + base_h_s[cg] * tile_p;
      const float4* wp = wh_s + cg;
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;
#pragma unroll 1
      for (int s = 0; s < g.win_h; ++s) {
        float a[8];
        load8_f32(mp + s * tile_p, half, a);
        fma_tile(a, wp[s * ncg], acc);
      }
      if (DERING) {  // clamp to the stored midT rows of column 4 cg + n's central taps
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          float lo[8], hi[8];
          load8_f32(mrow + ch_s[4 * cg + n] * tile_p, half, lo);
          load8_f32(mrow + ch_s[g.cb_p + 4 * cg + n] * tile_p, half, hi);
#pragma unroll
          for (int m = 0; m < 8; ++m) acc[m][n] = clamp_between(acc[m][n], lo[m], hi[m]);
        }
      }
      // rows 4 rg .. 4 rg + 3 share one swizzled chunk, rows half + 4 rg .. another
      const int r_lo = 4 * rg, r_hi = half + 4 * rg;
      uint8_t* s_lo = stage + r_lo * g.stage_w + 16 * stage_chunk(r_lo, cg >> 2, mask) + 4 * (cg & 3);
      uint8_t* s_hi = stage + r_hi * g.stage_w + 16 * stage_chunk(r_hi, cg >> 2, mask) + 4 * (cg & 3);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        *reinterpret_cast<unsigned*>(s_lo + m * g.stage_w) = quantize4(acc[m]);
        *reinterpret_cast<unsigned*>(s_hi + m * g.stage_w) = quantize4(acc[m + 4]);
      }
    }
  }
  __syncthreads();

  // the staged tile to the output, masked at the ragged bottom and right edges
  const int rows = min(g.tile, g.OH - i * g.tile), cols = min(g.cb, g.OW - b * g.cb);
  uint8_t* __restrict__ op = out + ((size_t)p * g.OH + (size_t)i * g.tile) * g.OW + (size_t)b * g.cb;
  if (g.vec_out && ((b * g.cb) & 15) == 0) {
    const int per_row = 1 << g.stage_lg;
    for (int e = threadIdx.x; e < (rows << g.stage_lg); e += kThreads) {
      const int r = e >> g.stage_lg, q = e & (per_row - 1);
      if (16 * q >= cols) continue;
      const uint8_t* src = stage + r * g.stage_w + 16 * stage_chunk(r, q, mask);
      uint8_t* dst = op + (size_t)r * g.OW + 16 * q;
      if (16 * q + 16 <= cols) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int t = 0; t < cols - 16 * q; ++t) dst[t] = src[t];
      }
    }
  } else {  // rows that are not 16-byte aligned: a warp a row, neighbouring bytes
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < rows; r += kWarps)
      for (int c = lane; c < cols; c += 32)
        op[(size_t)r * g.OW + c] =
            stage[r * g.stage_w + 16 * stage_chunk(r, c >> 4, mask) + (c & 15)];
  }
}

template <bool BF16, bool DERING, bool QUANT>
cudaError_t launch(const uint8_t* x, uint8_t* out, const void* wv, const void* wh,
                   const int* base_v, const int* base_h, const int* starts_v,
                   const int* starts_h, const int* uniq_h, const int* cv, const int* ch,
                   const Geometry& g, int nc, int n_cb, int num_tiles, cudaStream_t stream) {
  const size_t smem = (size_t)g.kv * g.bw + sizeof(float) * (size_t)g.mw * g.tile_p +
                      (size_t)g.tile_p * g.stage_w +
                      sizeof(float) * ((size_t)g.win_v * g.tile_p + (size_t)g.win_h * g.cb_p) +
                      sizeof(int) * (size_t)(g.tile_p / 4 + g.cb_p / 4) +
                      (DERING ? sizeof(int) * 2 * (size_t)(g.tile_p + g.cb_p) : 0);
  auto* kernel = fused_resample_kernel<BF16, DERING, QUANT>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(n_cb, num_tiles, nc);
  kernel<<<grid, kThreads, smem, stream>>>(x, out, static_cast<const float4*>(wv),
                                           static_cast<const float4*>(wh), base_v, base_h,
                                           starts_v, starts_h, uniq_h, cv, ch, g);
  return cudaGetLastError();
}

int ceil_log2(int v) {
  int lg = 0;
  while ((1 << lg) < v) ++lg;
  return lg;
}

}  // namespace

extern "C" int lanczos_fused_resample(const void* x, void* out, const void* wv, const void* wh,
                                      const void* base_v, const void* base_h,
                                      const void* starts_v, const void* starts_h,
                                      const void* uniq_h, const void* cv, const void* ch,
                                      int nc, int H, int W, int OH, int OW, int tile,
                                      int tile_p, int kv, int cb, int cb_p, int kh, int win_v,
                                      int win_h, int bw, int mw, int stage_w, int n_cb,
                                      int num_tiles, int bf16, int dering, int quant,
                                      void* stream) {
  if (tile_p % 8 || cb_p % 4 || bw % 16 || mw % 8 || bw < mw + 8 || mw < kh + 7 ||
      stage_w != 16 << ceil_log2(stage_w / 16) || stage_w < cb_p)
    return (int)cudaErrorInvalidValue;
  Geometry g{H, W, OH, OW, tile, tile_p, kv, cb, cb_p, kh, win_v, win_h, bw, mw, stage_w};
  g.stage_lg = ceil_log2(stage_w / 16);
  g.chunk_lg = ceil_log2(bw / 16);
  g.vec_in = W % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  g.vec_out = OW % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  g.nrg_v_lg = (tile_p / 4 & (tile_p / 4 - 1)) ? -1 : ceil_log2(tile_p / 4);
  g.nrg_h_lg = (tile_p / 8 & (tile_p / 8 - 1)) ? -1 : ceil_log2(tile_p / 8);
  auto* xs = static_cast<const uint8_t*>(x);
  auto* os = static_cast<uint8_t*>(out);
  auto* bv = static_cast<const int*>(base_v);
  auto* bh = static_cast<const int*>(base_h);
  auto* sv = static_cast<const int*>(starts_v);
  auto* sh = static_cast<const int*>(starts_h);
  auto* uh = static_cast<const int*>(uniq_h);
  auto* cvs = static_cast<const int*>(cv);
  auto* chs = static_cast<const int*>(ch);
  auto st = static_cast<cudaStream_t>(stream);
#define LANCZOS_LAUNCH(B, D, Q) \
  launch<B, D, Q>(xs, os, wv, wh, bv, bh, sv, sh, uh, cvs, chs, g, nc, n_cb, num_tiles, st)
  cudaError_t e;
  switch ((bf16 ? 4 : 0) | (dering ? 2 : 0) | (quant ? 1 : 0)) {
    case 0: e = LANCZOS_LAUNCH(false, false, false); break;
    case 1: e = LANCZOS_LAUNCH(false, false, true); break;
    case 2: e = LANCZOS_LAUNCH(false, true, false); break;
    case 3: e = LANCZOS_LAUNCH(false, true, true); break;
    case 4: e = LANCZOS_LAUNCH(true, false, false); break;
    case 5: e = LANCZOS_LAUNCH(true, false, true); break;
    case 6: e = LANCZOS_LAUNCH(true, true, false); break;
    default: e = LANCZOS_LAUNCH(true, true, true); break;
  }
#undef LANCZOS_LAUNCH
  return (int)e;
}

extern "C" const char* lanczos_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
