// The dense fused kernel and its ablation copies, uint8 planar -> uint8 planar, for Hopper
// (sm_90a): the linear fused resample as the TPU kernel shaped it, both passes dense
// products over per-tile windows (about 90 multiply-adds a pixel at 2x where 9 are
// needed), and variants that each delete or restructure one stage, so that timing one
// against `full` shows what that stage costs on the card.  `full` was the production
// kernel until fused_resample.cu became band-sparse; it stays here so that every run
// times the earlier design beside the new one.
//
// Replaces tools/ablate_mxu.py::make_kernel (the per-tile kernel below) and
// ::make_swpipe_kernel (the row-walk kernel below), the TPU's ablation probes of
// _fused_kernel_mxu.  Both kernels share the register-tiled product (fused_tile.cuh), so a
// variant runs `full`'s arithmetic in every stage it keeps.  What bounds them: not
// device memory (124.4 MB a 4K->8K frame, 0.037 ms) but the serialized load, vertical
// and horizontal phases of blocks at 3 an SM, with the dense products behind (PERF.md).
//
// Per-tile kernel, one block per (column block, row tile, plane):
//   kFull     the dense stages (fp32 or bf16 weights): band, vertical, horizontal;
//   kNotrunc  the store's float clamp and truncating conversion replaced by one
//             saturating conversion and an integer clamp (TPU notrunc; same bytes);
//   kBfmid    the intermediate held in shared memory as bf16 (rounded there in both
//             precisions; the bf16 path already rounds it, so with bf16 weights only
//             its width changes);
//   kManout   the output tile staged in shared memory and written with 16-byte stores
//             (TPU manout, a manual output DMA; same bytes);
//   kNovert   the vertical products deleted: intermediate row r copies band row r % kv;
//   kNohoriz  the horizontal products deleted: output column c copies intermediate
//             column c % kh.  (The TPU's f32novertlo/f32nomidlo/f32nowhlo deleted hi/lo
//             correction products, which this SIMT fp32 kernel does not have.)
// Row-walk kernel, one block per (column block, kWalk consecutive row tiles, plane):
//   kRollband keeps the overlap of consecutive bands (two slots) and loads only new rows;
//   kBand3    a 3-slot ring of raw uint8 bands filled by cp.async two tiles ahead;
//   kSwpipe   double-buffered band and intermediate, one barrier a tile: the load of
//             tile s+1, the vertical pass of tile s and the horizontal pass of tile s-1
//             run in the same interval.
// Every variant but kBfmid, kNovert and kNohoriz gives kFull's bytes, which are those of
// the dense plain version (lanczos_torch/tools/ablate_fused.py) and lie within the fused
// kernel's limits of the production kernel's; those three give the bytes of their own
// plain versions.
//
// Layouts (dense_layout in the tool): x (nc, H, W) u8, out (nc, OH, OW) u8,
// wvT (num_tiles, kv, tile_p) WT, wh (n_uniq, kh, cb_p) WT, starts_v (num_tiles,),
// starts_h, uniq_h (n_cb,) int32.  kBand3 needs W % 4 == 0 (the wrapper checks).

#include <type_traits>

#include "fused_tile.cuh"

namespace {

enum Stage : int {
  kFull,
  kNotrunc,
  kBfmid,
  kManout,
  kNovert,
  kNohoriz,
  kRollband,
  kBand3,
  kSwpipe,
};
constexpr int kWalk = 8;  // row tiles one row-walk block computes

// an intermediate value into shared memory: as kFull (float, rounded to bf16 in the
// bf16 instantiations), or as bf16 (kBfmid)
template <typename WT>
__device__ __forceinline__ void put_mid(float* p, float v, const WT* w) {
  *p = round_mid(v, w);
}
template <typename WT>
__device__ __forceinline__ void put_mid(__nv_bfloat16* p, float v, const WT*) {
  *p = __float2bfloat16_rn(v);
}

// step 1: the uint8 band as float, zero past H, W and kh
__device__ __forceinline__ void load_band(float* band, const uint8_t* __restrict__ xp, int r0,
                                          int c0, const Geometry& g) {
  for (int e = threadIdx.x; e < g.kv * g.kh_p; e += kThreads) {
    const int k = e / g.kh_p, j = e - k * g.kh_p;
    const int r = r0 + k, c = c0 + j;
    band[e] = (j < g.kh && r < g.H && c < g.W) ? (float)xp[(size_t)r * g.W + c] : 0.f;
  }
}

// step 2: midT (kh_p x tile_p) = band^T . wvT[i]; NOVERT copies band rows
template <bool NOVERT, typename WT, typename MidT>
__device__ __forceinline__ void vertical(const float* band, const WT* __restrict__ wv_i,
                                         MidT* midT, const Geometry& g) {
  const int nn_v = g.tile_p / NR;
  for (int t = threadIdx.x; t < (g.kh_p / MR) * nn_v; t += kThreads) {
    const int m0 = (t / nn_v) * MR, n0 = (t % nn_v) * NR;
    float acc[MR][NR];
    if (NOVERT) {
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int n = 0; n < NR; ++n) acc[m][n] = band[((n0 + n) % g.kv) * g.kh_p + m0 + m];
    } else {
      micro_tile(band, g.kh_p, wv_i, g.tile_p, g.kv, m0, n0, acc);
    }
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int n = 0; n < NR; ++n) put_mid(midT + (m0 + m) * g.tile_p + n0 + n, acc[m][n], wv_i);
  }
}

__device__ __forceinline__ float mid_value(const float* p) { return *p; }
__device__ __forceinline__ float mid_value(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// steps 3-4: out tile = midT^T . wh[u], trunc-clipped, masked at the ragged
// edges; NOHORIZ copies intermediate columns, NOTRUNC and MANOUT change the store
template <int STAGE, typename WT, typename MidT>
__device__ __forceinline__ void horizontal(const MidT* midT, const WT* __restrict__ wh_b,
                                           uint8_t* __restrict__ op, uint8_t* ostage,
                                           int rows, int cols, const Geometry& g) {
  const int nn_h = g.cb_p / NR, os = (g.cb_p + 15) & ~15;
  for (int t = threadIdx.x; t < (g.tile_p / MR) * nn_h; t += kThreads) {
    const int m0 = (t / nn_h) * MR, n0 = (t % nn_h) * NR;
    float acc[MR][NR];
    if (STAGE == kNohoriz) {
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int n = 0; n < NR; ++n)
          acc[m][n] = mid_value(midT + ((n0 + n) % g.kh) * g.tile_p + m0 + m);
    } else {
      micro_tile(midT, g.tile_p, wh_b, g.cb_p, g.kh, m0, n0, acc);
    }
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      if (m0 + m >= rows) break;
#pragma unroll
      for (int n = 0; n < NR; ++n) {
        if (n0 + n < cols) {
          const uint8_t q =
              STAGE == kNotrunc
                  ? (uint8_t)min(__float2uint_rz(acc[m][n]), 255u)
                  : (uint8_t)__float2uint_rz(fminf(fmaxf(acc[m][n], 0.f), 255.f));
          if (STAGE == kManout)
            ostage[(m0 + m) * os + n0 + n] = q;
          else
            op[(size_t)(m0 + m) * g.OW + n0 + n] = q;
        }
      }
    }
  }
  if (STAGE == kManout) {  // the staged tile, in 16-byte stores where rows allow
    __syncthreads();
    const uintptr_t bits = reinterpret_cast<uintptr_t>(op) | (uintptr_t)g.OW | (uintptr_t)cols;
    const bool vec = (bits & 15) == 0;
    if (vec) {
      const int nv = cols / 16;
      for (int e = threadIdx.x; e < rows * nv; e += kThreads) {
        const int r = e / nv, v = e - r * nv;
        *reinterpret_cast<uint4*>(op + (size_t)r * g.OW + 16 * v) =
            *reinterpret_cast<const uint4*>(ostage + r * os + 16 * v);
      }
    } else {
      for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
        const int r = e / cols, c = e - r * cols;
        op[(size_t)r * g.OW + c] = ostage[r * os + c];
      }
    }
  }
}

template <typename WT, int STAGE>
__global__ void __launch_bounds__(kThreads)
    ablate_tile_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                       const WT* __restrict__ wvT, const WT* __restrict__ wh,
                       const int* __restrict__ starts_v, const int* __restrict__ starts_h,
                       const int* __restrict__ uniq_h, Geometry g) {
  using MidT = typename std::conditional<STAGE == kBfmid, __nv_bfloat16, float>::type;
  extern __shared__ float4 smem4[];
  float* band = reinterpret_cast<float*>(smem4);                      // (kv, kh_p)
  MidT* midT = reinterpret_cast<MidT*>(band + g.kv * g.kh_p);         // (kh_p, tile_p)
  uint8_t* ostage = reinterpret_cast<uint8_t*>(midT + g.kh_p * g.tile_p);  // kManout

  const int b = blockIdx.x, i = blockIdx.y, p = blockIdx.z;
  load_band(band, x + (size_t)p * g.H * g.W, starts_v[i], starts_h[b], g);
  __syncthreads();
  vertical<STAGE == kNovert>(band, wvT + (size_t)i * g.kv * g.tile_p, midT, g);
  __syncthreads();
  const int rows = min(g.tile, g.OH - i * g.tile), cols = min(g.cb, g.OW - b * g.cb);
  uint8_t* op = out + ((size_t)p * g.OH + (size_t)i * g.tile) * g.OW + (size_t)b * g.cb;
  horizontal<STAGE>(midT, wh + (size_t)uniq_h[b] * g.kh * g.cb_p, op, ostage, rows, cols, g);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait2() { asm volatile("cp.async.wait_group 2;\n" ::); }

// words of raw uint8 band per row in the cp.async ring: the aligned words covering
// [c0, c0 + kh) for any c0 % 4
__host__ __device__ __forceinline__ int ring_words(int kh) { return (kh + 6) / 4; }

template <typename WT, int STAGE>
__global__ void __launch_bounds__(kThreads)
    ablate_walk_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                       const WT* __restrict__ wvT, const WT* __restrict__ wh,
                       const int* __restrict__ starts_v, const int* __restrict__ starts_h,
                       const int* __restrict__ uniq_h, Geometry g, int num_tiles) {
  extern __shared__ float4 smem4[];
  const int bsz = g.kv * g.kh_p, msz = g.kh_p * g.tile_p;
  float* smem = reinterpret_cast<float*>(smem4);
  // kRollband: band[2], mid;  kBand3: band, mid, raw ring[3];  kSwpipe: band[2], mid[2]
  float* bands[2] = {smem, smem + bsz};
  float* mids[2] = {STAGE == kBand3 ? smem + bsz : smem + 2 * bsz,
                    smem + 2 * bsz + msz};
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + bsz + msz);
  const int nw = ring_words(g.kh);

  const int b = blockIdx.x, p = blockIdx.z;
  const int i0 = blockIdx.y * kWalk, n = min(kWalk, num_tiles - i0);
  const int c0 = starts_h[b];
  const uint8_t* __restrict__ xp = x + (size_t)p * g.H * g.W;
  const WT* __restrict__ wh_b = wh + (size_t)uniq_h[b] * g.kh * g.cb_p;
  const int cols = min(g.cb, g.OW - b * g.cb);
  auto out_tile = [&](int i) {
    return out + ((size_t)p * g.OH + (size_t)i * g.tile) * g.OW + (size_t)b * g.cb;
  };
  auto rows_of = [&](int i) { return min(g.tile, g.OH - i * g.tile); };
  auto wv_of = [&](int i) { return wvT + (size_t)i * g.kv * g.tile_p; };

  if constexpr (STAGE == kRollband) {
    int prev = 0;
    for (int s = 0; s < n; ++s) {
      const int i = i0 + s, r0 = starts_v[i];
      float* cur = bands[s & 1];
      const float* old = bands[(s + 1) & 1];
      const int delta = r0 - prev;
      const int keep = (s > 0 && delta >= 0) ? max(0, g.kv - delta) : 0;
      for (int e = threadIdx.x; e < bsz; e += kThreads) {
        const int k = e / g.kh_p, j = e - k * g.kh_p;
        if (k < keep) {
          cur[e] = old[e + delta * g.kh_p];
        } else {
          const int r = r0 + k, c = c0 + j;
          cur[e] = (j < g.kh && r < g.H && c < g.W) ? (float)xp[(size_t)r * g.W + c] : 0.f;
        }
      }
      prev = r0;
      __syncthreads();
      vertical<false>(cur, wv_of(i), mids[0], g);
      __syncthreads();
      horizontal<kFull>(mids[0], wh_b, out_tile(i), nullptr, rows_of(i), cols, g);
    }
  } else if constexpr (STAGE == kBand3) {
    const int cw0 = c0 & ~3, shift = c0 - cw0;
    auto issue = [&](int s) {  // raw band of tile i0 + s into ring slot s % 3
      if (s < n) {
        const int r0 = starts_v[i0 + s];
        uint32_t* slot = ring + (s % 3) * g.kv * nw;
        for (int e = threadIdx.x; e < g.kv * nw; e += kThreads) {
          const int k = e / nw, w = e - k * nw;
          const int r = r0 + k, c = cw0 + 4 * w;
          const bool in = r < g.H && c < g.W;
          cp_async4(slot + e, in ? xp + (size_t)r * g.W + c : xp, in ? 4 : 0);
        }
      }
      cp_async_commit();  // an empty group past the walk keeps the count uniform
    };
    issue(0);
    issue(1);
    for (int s = 0; s < n; ++s) {
      const int i = i0 + s;
      issue(s + 2);
      cp_async_wait2();
      __syncthreads();
      const uint8_t* raw = reinterpret_cast<const uint8_t*>(ring + (s % 3) * g.kv * nw);
      for (int e = threadIdx.x; e < bsz; e += kThreads) {
        const int k = e / g.kh_p, j = e - k * g.kh_p;
        bands[0][e] = j < g.kh ? (float)raw[k * 4 * nw + shift + j] : 0.f;
      }
      __syncthreads();
      vertical<false>(bands[0], wv_of(i), mids[0], g);
      __syncthreads();
      horizontal<kFull>(mids[0], wh_b, out_tile(i), nullptr, rows_of(i), cols, g);
    }
  } else {  // kSwpipe
    load_band(bands[0], xp, starts_v[i0], c0, g);
    __syncthreads();
    for (int s = 0; s <= n; ++s) {
      if (s + 1 < n) load_band(bands[(s + 1) & 1], xp, starts_v[i0 + s + 1], c0, g);
      if (s < n) vertical<false>(bands[s & 1], wv_of(i0 + s), mids[s & 1], g);
      if (s > 0)
        horizontal<kFull>(mids[(s - 1) & 1], wh_b, out_tile(i0 + s - 1), nullptr,
                          rows_of(i0 + s - 1), cols, g);
      __syncthreads();
    }
  }
}

template <typename WT, int STAGE>
cudaError_t launch(const uint8_t* x, uint8_t* out, const void* wvT, const void* wh,
                   const int* sv, const int* sh, const int* uh, const Geometry& g, int nc,
                   int n_cb, int num_tiles, cudaStream_t stream) {
  const size_t bsz = 4 * (size_t)g.kv * g.kh_p, msz = 4 * (size_t)g.kh_p * g.tile_p;
  size_t smem;
  if (STAGE == kRollband)
    smem = 2 * bsz + msz;
  else if (STAGE == kBand3)
    smem = bsz + msz + 3 * 4 * (size_t)g.kv * ring_words(g.kh);
  else if (STAGE == kSwpipe)
    smem = 2 * bsz + 2 * msz;
  else
    smem = bsz + (STAGE == kBfmid ? msz / 2 : msz) +
           (STAGE == kManout ? (size_t)g.tile_p * ((g.cb_p + 15) & ~15) : 0);
  constexpr bool walk = STAGE == kRollband || STAGE == kBand3 || STAGE == kSwpipe;
  const auto* w1 = static_cast<const WT*>(wvT);
  const auto* w2 = static_cast<const WT*>(wh);
  if constexpr (walk) {
    auto* kernel = ablate_walk_kernel<WT, STAGE>;
    if (smem > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    const dim3 grid(n_cb, (num_tiles + kWalk - 1) / kWalk, nc);
    kernel<<<grid, kThreads, smem, stream>>>(x, out, w1, w2, sv, sh, uh, g, num_tiles);
  } else {
    auto* kernel = ablate_tile_kernel<WT, STAGE>;
    if (smem > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    const dim3 grid(n_cb, num_tiles, nc);
    kernel<<<grid, kThreads, smem, stream>>>(x, out, w1, w2, sv, sh, uh, g);
  }
  return cudaGetLastError();
}

template <typename WT>
cudaError_t launch_stage(int stage, const uint8_t* x, uint8_t* out, const void* wvT,
                         const void* wh, const int* sv, const int* sh, const int* uh,
                         const Geometry& g, int nc, int n_cb, int num_tiles, cudaStream_t st) {
  switch (stage) {
    case kFull: return launch<WT, kFull>(x, out, wvT, wh, sv, sh, uh, g, nc, n_cb, num_tiles, st);
    case kNotrunc: return launch<WT, kNotrunc>(x, out, wvT, wh, sv, sh, uh, g, nc, n_cb, num_tiles, st);
    case kBfmid: return launch<WT, kBfmid>(x, out, wvT, wh, sv, sh, uh, g, nc, n_cb, num_tiles, st);
    case kManout: return launch<WT, kManout>(x, out, wvT, wh, sv, sh, uh, g, nc, n_cb, num_tiles, st);
    case kNovert: return launch<WT, kNovert>(x, out, wvT, wh, sv, sh, uh, g, nc, n_cb, num_tiles, st);
    case kNohoriz: return launch<WT, kNohoriz>(x, out, wvT, wh, sv, sh, uh, g, nc, n_cb, num_tiles, st);
    case kRollband: return launch<WT, kRollband>(x, out, wvT, wh, sv, sh, uh, g, nc, n_cb, num_tiles, st);
    case kBand3: return launch<WT, kBand3>(x, out, wvT, wh, sv, sh, uh, g, nc, n_cb, num_tiles, st);
    case kSwpipe: return launch<WT, kSwpipe>(x, out, wvT, wh, sv, sh, uh, g, nc, n_cb, num_tiles, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int lanczos_ablate_fused(const void* x, void* out, const void* wvT, const void* wh,
                                    const void* starts_v, const void* starts_h,
                                    const void* uniq_h, int nc, int H, int W, int OH, int OW,
                                    int tile, int tile_p, int kv, int cb, int cb_p, int kh,
                                    int kh_p, int n_cb, int num_tiles, int bf16, int stage,
                                    void* stream) {
  const Geometry g{H, W, OH, OW, tile, tile_p, kv, cb, cb_p, kh, kh_p};
  auto* xs = static_cast<const uint8_t*>(x);
  auto* os = static_cast<uint8_t*>(out);
  auto* sv = static_cast<const int*>(starts_v);
  auto* sh = static_cast<const int*>(starts_h);
  auto* uh = static_cast<const int*>(uniq_h);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch_stage<__nv_bfloat16>(stage, xs, os, wvT, wh, sv, sh, uh, g, nc, n_cb,
                                         num_tiles, st)
           : launch_stage<float>(stage, xs, os, wvT, wh, sv, sh, uh, g, nc, n_cb, num_tiles, st);
  return (int)e;
}
