// Shift-FMA resample of integer upscales, uint8 planar -> uint8 planar, for Hopper (sm_90a).
//
// Replaces lanczos_tpu/ops/resample_pallas.py::_fused_kernel_v2 (with _shift_pass): the
// TPU's v2 kernel, its exactness anchor and the fallback of integer-scale dering configs
// that have no fused plan.  For D = 1 (N_v, N_h <= 16) every output is a sum of 2*s
// unit-stride taps of its phase's row of the weight table:
//   mid[r][x] = sum_t tbl_v[r % N_v][t] * xp[r / N_v + fp_v[r % N_v] + 1 + t][x]
//   out[r][c] = sum_t tbl_h[c % N_h][t] * mid[r][c / N_h + fp_h[c % N_h] + 1 + t]
// over the input padded by s per side (xp), optionally clamped to the [min, max] of the
// two central taps (t = s - 1, s) in both passes, then trunc(clip(., 0, 255)).  The
// floors fp and the padded-coordinate maps rows/cols (source pixel, or -1 for a zero)
// are computed on the host (lanczos_torch/ops/resample_shift_cuda.py): the floors with
// Python's floor division, which C++ '/' would truncate for align="center"; the maps
// with numpy's pad rules, so no padded copy of the image is ever made.
//
// Exactness: every sum is taken in tap order, the first tap a rounded product
// (__fmul_rn) and each later one a fused multiply-add (__fmaf_rn: the exact acc + w * x
// rounded once), and the kernel gives exactly the bytes of its plain PyTorch version, which
// rounds each tap once too (lanczos_torch/ops/_fma.py).  One rounding a tap keeps a
// constant plane constant, as the reference's tap chains (which XLA's CPU backend
// contracts into FMAs) do; a multiply and then an add rounds twice and drops some of its
// outputs a level.
//
// What bounds it on the H100: device memory, as the fused kernel: at 4K->8K, 3 planes,
// 124.4 MB of compulsory uint8 traffic (0.037 ms at 3.35 TB/s) against 0.9 G
// multiply-adds (0.027 ms at the SIMT fp32 peak if every instruction slot were
// arithmetic).  What this design does about it:
//   - a thread owns whole phase periods: in the vertical pass 4 band columns x 4 source
//     rows (all N_v phases of each), in the horizontal pass 2 rows x 4 source columns
//     (all N_h phases of each).  It loads the 4 + 2*s source values of its run once into
//     registers (the support is a template parameter: s = 2 and 3; other supports take
//     the generic instantiation, which reads shared memory per tap) and walks the
//     phases with the phase's weights in registers, so no output is a chain of
//     dependent shared-memory loads;
//   - no division or remainder per value: phases and source positions are loop
//     counters (one division per thread run splits its index);
//   - 16-byte global traffic: the uint8 band is copied as aligned 16-byte vectors
//     wherever a chunk lies inside the image, where the pad maps are the identity
//     shifted by s (the band's origin is moved left to the 16-byte boundary of the
//     source), and byte by byte through the maps only in chunks that touch an edge or
//     where W is not a multiple of 16; the vertical pass realigns with a funnel shift.
//     Outputs are staged in shared memory as uint8 and leave as 16-byte stores;
//   - blocks of 128 threads at no more than 80 registers and about 30 KB of shared memory
//     (64 x 128 outputs, N = 2), so 6 blocks share an SM and the copies, the passes and
//     the store of different blocks overlap.
//
// One block computes one (column chunk, row tile, plane) tile of tr x tc outputs,
// tr = N_v * rpb and tc = N_h * cpb with rpb a multiple of 4 and cpb of 16: the band of
// rpb + 2s padded rows, the vertical pass into an fp32 intermediate in shared memory,
// the horizontal pass into the staged tile, and the store, masked at the ragged bottom
// and right edges.  The TPU kernel's phase-planar store and the transpose after it were
// a Mosaic workaround; this kernel writes the interleaved output directly.
//
// Layouts: x (nc, H, W) u8; out (nc, OH, OW) u8; tbl_v (N_v, 2s) f32; tbl_h (N_h, 2s)
// f32; fp_v (N_v,), fp_h (N_h,) int32 in {-1, 0}; rows (H + 2s,), cols (W + 2s,) int32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 4;  // source rows (columns) of one thread's run

struct Shape {
  int H, W, OH, OW, nv, nh, s, rpb, cpb;
  int mwid;      // floats of an intermediate row: cpb + 2s rounded up to 4
  int bwid;      // bytes of a band row (a multiple of 16)
  int chunk_lg;  // log2 of the 16-byte chunks of a band row, rounded up
  int vec_in, vec_out;
};

template <int I>
__device__ __forceinline__ float byte_to_float(unsigned w) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + I)) - 8388608.f;
}

__device__ __forceinline__ float clamp_between(float v, float a, float b) {
  return fminf(fmaxf(v, fminf(a, b)), fmaxf(a, b));
}

// trunc(clip(v, 0, 255)): the conversion to unsigned truncates and takes negatives (and
// NaN) to 0, so one integer clamp is left
__device__ __forceinline__ uint8_t quantize(float v) {
  return (uint8_t)min(__float2uint_rz(v), 255u);
}

// asynchronous copies global -> shared: 16 bytes past L1 with src_bytes of 16 or 0 (0
// fills with zeros), and 4 bytes
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

// One phase's outputs from a register window: sum_t w[t] * v[q + OFF + t] in tap order,
// one rounding a tap, optionally clamped to the two central taps.  OFF is the
// phase's floor + 1 (0 or 1); every index is a constant, so the window stays in registers.
template <int S, bool DERING>
struct Window {
  static constexpr int kTaps = 2 * S;
  static constexpr int kLen = kRun + kTaps;  // source values a run of kRun outputs reads

  // outputs of the kRun source positions of one phase from the window v
  template <int OFF>
  static __device__ __forceinline__ void phase(const float (&w)[kTaps], const float (&v)[kLen],
                                               float (&o)[kRun]) {
#pragma unroll
    for (int q = 0; q < kRun; ++q) {
      float acc = __fmul_rn(w[0], v[q + OFF]);
#pragma unroll
      for (int t = 1; t < kTaps; ++t) acc = __fmaf_rn(w[t], v[q + OFF + t], acc);
      if (DERING) acc = clamp_between(acc, v[q + OFF + S - 1], v[q + OFF + S]);
      o[q] = acc;
    }
  }
};

// the generic instantiation's sum: taps from shared memory, stride apart
template <bool DERING, typename T>
__device__ __forceinline__ float tap_sum_mem(const float* __restrict__ w, const T* __restrict__ v,
                                             int stride, int taps, int s) {
  float acc = __fmul_rn(w[0], (float)v[0]);
  for (int t = 1; t < taps; ++t) acc = __fmaf_rn(w[t], (float)v[t * stride], acc);
  if (DERING) acc = clamp_between(acc, (float)v[(s - 1) * stride], (float)v[s * stride]);
  return acc;
}

// S > 0: the support, known at compile time; S == 0: any support, read from g.s
template <int S, bool DERING>
__global__ void __launch_bounds__(kThreads, 6)
    shift_resample_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                          const float* __restrict__ tbl_v, const float* __restrict__ tbl_h,
                          const int* __restrict__ fp_v, const int* __restrict__ fp_h,
                          const int* __restrict__ rows, const int* __restrict__ cols, Shape g) {
  extern __shared__ uint4 smem16[];
  const int s = S > 0 ? S : g.s, taps = 2 * s;
  const int nv = g.nv, nh = g.nh, tr = nv * g.rpb, tc = nh * g.cpb;
  const int ev = g.rpb + taps, mwid = g.mwid, bwid = g.bwid;
  uint8_t* band = reinterpret_cast<uint8_t*>(smem16);              // (ev, bwid)
  float* mid = reinterpret_cast<float*>(band + ev * bwid);         // (tr, mwid)
  uint8_t* stage = reinterpret_cast<uint8_t*>(mid + tr * mwid);    // (tr, tc)
  float* wv = reinterpret_cast<float*>(stage + tr * tc);           // (nv, taps)
  float* wh = wv + nv * taps;                                      // (nh, taps)
  int* fv_s = reinterpret_cast<int*>(wh + nh * taps);               // (nv,) fp_v
  int* fh_s = fv_s + nv;                                             // (nh,) fp_h

  const int y0 = blockIdx.y * tr, x0 = blockIdx.x * tc;
  const int k0 = blockIdx.y * g.rpb, j0 = blockIdx.x * g.cpb;  // first padded row, column
  const int delta = (j0 - s) & 15;  // band byte of padded column j0: its source column mod 16
  const int jA = j0 - delta;        // padded column of band byte 0 (may be negative)
  const int hp = g.H + taps, wp = g.W + taps;
  const uint8_t* __restrict__ xp = x + (size_t)blockIdx.z * g.H * g.W;

  // the tables and the band, as asynchronous copies in flight together.  The band in
  // 16-byte chunks: a copy where the chunk lies inside the image (there the maps are the
  // identity shifted by s), else byte by byte through the maps; zero past the padded
  // image (read by no valid output)
  for (int e = threadIdx.x; e < nv * taps; e += kThreads) cp_async4(wv + e, tbl_v + e);
  for (int e = threadIdx.x; e < nh * taps; e += kThreads) cp_async4(wh + e, tbl_h + e);
  for (int e = threadIdx.x; e < nv; e += kThreads) cp_async4(fv_s + e, fp_v + e);
  for (int e = threadIdx.x; e < nh; e += kThreads) cp_async4(fh_s + e, fp_h + e);
  {
    const int per_row = 1 << g.chunk_lg, nch = bwid >> 4;
    for (int e = threadIdx.x; e < (ev << g.chunk_lg); e += kThreads) {
      const int k = e >> g.chunk_lg, q = e & (per_row - 1);
      if (q >= nch) continue;
      const int r = k0 + k, jc = jA + 16 * q;
      const int sr = r < hp ? __ldg(rows + r) : -1;
      const uint8_t* __restrict__ src = xp + (size_t)max(sr, 0) * g.W;
      uint4* dst = reinterpret_cast<uint4*>(band + k * bwid + 16 * q);
      if (g.vec_in && (sr < 0 || (jc >= s && jc - s + 16 <= g.W))) {
        cp_async16_cg(dst, sr < 0 ? xp : src + (jc - s), sr < 0 ? 0 : 16);
      } else {
        unsigned w0 = 0u, w1 = 0u, w2 = 0u, w3 = 0u;
        for (int t = 0; t < 16 && sr >= 0; ++t) {
          const int j = jc + t;
          const int sc = (j >= 0 && j < wp) ? __ldg(cols + j) : -1;
          const unsigned v = sc >= 0 ? (unsigned)__ldg(src + sc) << (8 * (t & 3)) : 0u;
          if (t < 4) w0 |= v;
          else if (t < 8) w1 |= v;
          else if (t < 12) w2 |= v;
          else w3 |= v;
        }
        *dst = make_uint4(w0, w1, w2, w3);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  if constexpr (S > 0) {
    using Win = Window<S, DERING>;
    constexpr int kTaps = Win::kTaps, kLen = Win::kLen;
    // vertical pass: runs of kRun source rows x 4 band columns
    {
      const int ng = mwid >> 2, shift = 8 * (delta & 3);
      for (int it = threadIdx.x; it < (g.rpb / kRun) * ng; it += kThreads) {
        const int qg = it / ng, cg = it - qg * ng;
        const unsigned* bp =
            reinterpret_cast<const unsigned*>(band + qg * kRun * bwid) + ((delta + 4 * cg) >> 2);
        float v[4][kLen];
#pragma unroll
        for (int k = 0; k < kLen; ++k) {
          const unsigned* wp2 = bp + k * (bwid >> 2);
          const unsigned word = __funnelshift_r(wp2[0], wp2[1], shift);
          v[0][k] = byte_to_float<0>(word), v[1][k] = byte_to_float<1>(word);
          v[2][k] = byte_to_float<2>(word), v[3][k] = byte_to_float<3>(word);
        }
        for (int p = 0; p < nv; ++p) {
          float w[kTaps], o[4][kRun];
#pragma unroll
          for (int t = 0; t < kTaps; ++t) w[t] = wv[p * kTaps + t];
          if (fv_s[p] + 1) {
#pragma unroll
            for (int c = 0; c < 4; ++c) Win::template phase<1>(w, v[c], o[c]);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c) Win::template phase<0>(w, v[c], o[c]);
          }
#pragma unroll
          for (int q = 0; q < kRun; ++q)
            *reinterpret_cast<float4*>(mid + ((qg * kRun + q) * nv + p) * mwid + 4 * cg) =
                make_float4(o[0][q], o[1][q], o[2][q], o[3][q]);
        }
      }
    }
    __syncthreads();
    // horizontal pass: two rows x runs of kRun source columns, into the staged tile
    {
      const int ng = g.cpb / kRun;
      constexpr int kVecs = (kLen + 3) / 4;
      for (int it = threadIdx.x; it < (tr >> 1) * ng; it += kThreads) {
        const int rp = it / ng, cg = it - rp * ng;
        float win[2][kLen];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4* mp =
              reinterpret_cast<const float4*>(mid + (2 * rp + h) * mwid + kRun * cg);
          float v[4 * kVecs];
#pragma unroll
          for (int k = 0; k < kVecs; ++k) {
            const float4 m = mp[k];
            v[4 * k] = m.x, v[4 * k + 1] = m.y, v[4 * k + 2] = m.z, v[4 * k + 3] = m.w;
          }
#pragma unroll
          for (int k = 0; k < kLen; ++k) win[h][k] = v[k];
        }
        uint8_t* sp = stage + 2 * rp * tc + kRun * cg * nh;
        for (int p = 0; p < nh; ++p) {
          float w[kTaps], o[2][kRun];
#pragma unroll
          for (int t = 0; t < kTaps; ++t) w[t] = wh[p * kTaps + t];
          if (fh_s[p] + 1) {
            Win::template phase<1>(w, win[0], o[0]);
            Win::template phase<1>(w, win[1], o[1]);
          } else {
            Win::template phase<0>(w, win[0], o[0]);
            Win::template phase<0>(w, win[1], o[1]);
          }
#pragma unroll
          for (int q = 0; q < kRun; ++q) {
            sp[q * nh + p] = quantize(o[0][q]);
            sp[tc + q * nh + p] = quantize(o[1][q]);
          }
        }
      }
    }
  } else {
    // any support: one source position per thread step, taps read from shared memory
    for (int it = threadIdx.x; it < g.rpb * mwid; it += kThreads) {
      const int q = it / mwid, c = it - q * mwid;
      for (int p = 0; p < nv; ++p)
        mid[(q * nv + p) * mwid + c] = tap_sum_mem<DERING>(
            wv + p * taps, band + (q + fv_s[p] + 1) * bwid + delta + c, bwid, taps, s);
    }
    __syncthreads();
    for (int it = threadIdx.x; it < tr * g.cpb; it += kThreads) {
      const int r = it / g.cpb, c = it - r * g.cpb;
      for (int p = 0; p < nh; ++p)
        stage[r * tc + c * nh + p] = quantize(
            tap_sum_mem<DERING>(wh + p * taps, mid + r * mwid + c + fh_s[p] + 1, 1, taps, s));
    }
  }
  __syncthreads();

  // the staged tile to the output, masked at the ragged bottom and right edges
  const int rows_n = min(tr, g.OH - y0), cols_n = min(tc, g.OW - x0);
  uint8_t* __restrict__ op = out + ((size_t)blockIdx.z * g.OH + y0) * g.OW + x0;
  if (g.vec_out) {  // tc is a multiple of 16, so every chunk of every row is aligned
    const int cpr = (cols_n + 15) >> 4;  // 16-byte chunks of a row
    for (int e = threadIdx.x; e < rows_n * cpr; e += kThreads) {
      const int r = e / cpr, c = 16 * (e - r * cpr);
      const uint8_t* src = stage + r * tc + c;
      uint8_t* dst = op + (size_t)r * g.OW + c;
      if (c + 16 <= cols_n) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int t = 0; t < cols_n - c; ++t) dst[t] = src[t];
      }
    }
  } else {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < rows_n; r += kWarps)
      for (int c = lane; c < cols_n; c += 32) op[(size_t)r * g.OW + c] = stage[r * tc + c];
  }
}

template <int S, bool DERING>
cudaError_t launch(const uint8_t* x, uint8_t* out, const float* tbl_v, const float* tbl_h,
                   const int* fp_v, const int* fp_h, const int* rows, const int* cols, int nc,
                   const Shape& g, cudaStream_t stream) {
  const int taps = 2 * g.s, tr = g.nv * g.rpb, tc = g.nh * g.cpb;
  const size_t smem = (size_t)(g.rpb + taps) * g.bwid + sizeof(float) * (size_t)tr * g.mwid +
                      (size_t)tr * tc + sizeof(float) * (size_t)(g.nv + g.nh) * (taps + 1);
  auto* kernel = shift_resample_kernel<S, DERING>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((g.OW + tc - 1) / tc, (g.OH + tr - 1) / tr, nc);
  kernel<<<grid, kThreads, smem, stream>>>(x, out, tbl_v, tbl_h, fp_v, fp_h, rows, cols, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lanczos_shift_resample(const void* x, void* out, const void* tbl_v,
                                      const void* tbl_h, const void* fp_v, const void* fp_h,
                                      const void* rows, const void* cols, int nc, int H, int W,
                                      int OH, int OW, int nv, int nh, int s, int tr, int tc,
                                      int dering, void* stream) {
  if (nv < 1 || nh < 1 || s < 1 || tr % (nv * kRun) || tc % (nh * 16))
    return (int)cudaErrorInvalidValue;
  Shape g{H, W, OH, OW, nv, nh, s, tr / nv, tc / nh};
  g.mwid = (g.cpb + 2 * s + 3) & ~3;
  g.bwid = (g.mwid + 19 + 15) & ~15;
  g.chunk_lg = 0;
  while ((16 << g.chunk_lg) < g.bwid) ++g.chunk_lg;
  g.vec_in = W % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  g.vec_out = OW % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto* xs = static_cast<const uint8_t*>(x);
  auto* os = static_cast<uint8_t*>(out);
  auto* tv = static_cast<const float*>(tbl_v);
  auto* th = static_cast<const float*>(tbl_h);
  auto* fv = static_cast<const int*>(fp_v);
  auto* fh = static_cast<const int*>(fp_h);
  auto* rs = static_cast<const int*>(rows);
  auto* cs = static_cast<const int*>(cols);
  auto st = static_cast<cudaStream_t>(stream);
#define LANCZOS_SHIFT(S, D) launch<S, D>(xs, os, tv, th, fv, fh, rs, cs, nc, g, st)
  cudaError_t e;
  if (s == 3)
    e = dering ? LANCZOS_SHIFT(3, true) : LANCZOS_SHIFT(3, false);
  else if (s == 2)
    e = dering ? LANCZOS_SHIFT(2, true) : LANCZOS_SHIFT(2, false);
  else
    e = dering ? LANCZOS_SHIFT(0, true) : LANCZOS_SHIFT(0, false);
#undef LANCZOS_SHIFT
  return (int)e;
}
