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
// Exactness: every sum is a multiply then an add, in tap order (__fmul_rn/__fadd_rn, so
// nvcc's default --fmad=true cannot contract them into FMAs), and the kernel gives
// exactly the bytes of its plain PyTorch version.
//
// One block computes one (column chunk, row tile, plane) tile of tr x tc outputs, both
// whole phase periods: it loads the uint8 band of tr/N_v + 2s padded rows and
// tc/N_h + 2s padded columns into shared memory, runs the vertical pass into an fp32
// intermediate in shared memory, then the horizontal pass into the output, masked at the
// ragged bottom and right edges.  The TPU kernel's phase-planar store and the transpose
// after it were a Mosaic workaround; this kernel writes the interleaved output directly.
// What bounds it on the H100: about 2*s multiply-adds per pass per value, read from
// shared memory, against ~124 MB of compulsory uint8 traffic at 4K->8K: shared-memory
// bandwidth and integer index arithmetic, not device memory.
//
// Layouts: x (nc, H, W) u8; out (nc, OH, OW) u8; tbl_v (N_v, 2s) f32; tbl_h (N_h, 2s)
// f32; fp_v (N_v,), fp_h (N_h,) int32 in {-1, 0}; rows (H + 2s,), cols (W + 2s,) int32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// sum_t w[t] * v[t * stride] in tap order, optionally clamped to the central taps
template <bool DERING, typename T>
__device__ __forceinline__ float tap_sum(const float* __restrict__ w, const T* __restrict__ v,
                                         int stride, int taps, int s) {
  float acc = __fmul_rn(w[0], (float)v[0]);
  for (int t = 1; t < taps; ++t) acc = __fadd_rn(acc, __fmul_rn(w[t], (float)v[t * stride]));
  if (DERING) {
    const float a = (float)v[(s - 1) * stride], b = (float)v[s * stride];
    acc = fminf(fmaxf(acc, fminf(a, b)), fmaxf(a, b));
  }
  return acc;
}

template <bool DERING>
__global__ void __launch_bounds__(kThreads)
    shift_resample_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                          const float* __restrict__ tbl_v, const float* __restrict__ tbl_h,
                          const int* __restrict__ fp_v, const int* __restrict__ fp_h,
                          const int* __restrict__ rows, const int* __restrict__ cols, int H,
                          int W, int OH, int OW, int nv, int nh, int s, int tr, int tc) {
  extern __shared__ float4 smem4[];
  const int taps = 2 * s;
  const int ev = tr / nv + taps, eh = tc / nh + taps;
  float* wv = reinterpret_cast<float*>(smem4);         // (nv, taps)
  float* wh = wv + nv * taps;                          // (nh, taps)
  int* f1v = reinterpret_cast<int*>(wh + nh * taps);   // (nv,) fp_v + 1
  int* f1h = f1v + nv;                                 // (nh,) fp_h + 1
  float* mid = reinterpret_cast<float*>(f1h + nh);     // (tr, eh)
  uint8_t* band = reinterpret_cast<uint8_t*>(mid + tr * eh);  // (ev, eh)

  const int y0 = blockIdx.y * tr, x0 = blockIdx.x * tc;
  const int k0 = y0 / nv, j0 = x0 / nh;  // first padded row and column of the band
  const int hp = H + taps, wp = W + taps;
  const uint8_t* __restrict__ xp = x + (size_t)blockIdx.z * H * W;

  for (int e = threadIdx.x; e < nv * taps; e += kThreads) wv[e] = tbl_v[e];
  for (int e = threadIdx.x; e < nh * taps; e += kThreads) wh[e] = tbl_h[e];
  for (int e = threadIdx.x; e < nv; e += kThreads) f1v[e] = fp_v[e] + 1;
  for (int e = threadIdx.x; e < nh; e += kThreads) f1h[e] = fp_h[e] + 1;
  // the band, through the pad maps; zero past the padded image (read by no valid output)
  for (int e = threadIdx.x; e < ev * eh; e += kThreads) {
    const int r = k0 + e / eh, c = j0 + e % eh;
    const int sr = r < hp ? __ldg(rows + r) : -1, sc = c < wp ? __ldg(cols + c) : -1;
    band[e] = (sr >= 0 && sc >= 0) ? xp[(size_t)sr * W + sc] : 0;
  }
  __syncthreads();

  // vertical pass: tr rows of the intermediate over the band's eh columns
  for (int e = threadIdx.x; e < tr * eh; e += kThreads) {
    const int r = e / eh, c = e - r * eh, p = r % nv;
    mid[e] = tap_sum<DERING>(wv + p * taps, band + (r / nv + f1v[p]) * eh + c, eh, taps, s);
  }
  __syncthreads();

  // horizontal pass and the masked trunc-clip store
  const int rows_n = min(tr, OH - y0), cols_n = min(tc, OW - x0);
  uint8_t* __restrict__ op = out + ((size_t)blockIdx.z * OH + y0) * OW + x0;
  for (int e = threadIdx.x; e < rows_n * tc; e += kThreads) {
    const int r = e / tc, c = e - r * tc;
    if (c >= cols_n) continue;
    const int p = c % nh;
    const float v = tap_sum<DERING>(wh + p * taps, mid + r * eh + c / nh + f1h[p], 1, taps, s);
    op[(size_t)r * OW + c] = (uint8_t)__float2uint_rz(fminf(fmaxf(v, 0.f), 255.f));
  }
}

template <bool DERING>
cudaError_t launch(const uint8_t* x, uint8_t* out, const float* tbl_v, const float* tbl_h,
                   const int* fp_v, const int* fp_h, const int* rows, const int* cols, int nc,
                   int H, int W, int OH, int OW, int nv, int nh, int s, int tr, int tc,
                   cudaStream_t stream) {
  const int taps = 2 * s, eh = tc / nh + taps, ev = tr / nv + taps;
  const size_t smem =
      sizeof(float) * ((size_t)(nv + nh) * (taps + 1) + (size_t)tr * eh) + (size_t)ev * eh;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        shift_resample_kernel<DERING>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((OW + tc - 1) / tc, (OH + tr - 1) / tr, nc);
  shift_resample_kernel<DERING><<<grid, kThreads, smem, stream>>>(
      x, out, tbl_v, tbl_h, fp_v, fp_h, rows, cols, H, W, OH, OW, nv, nh, s, tr, tc);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lanczos_shift_resample(const void* x, void* out, const void* tbl_v,
                                      const void* tbl_h, const void* fp_v, const void* fp_h,
                                      const void* rows, const void* cols, int nc, int H, int W,
                                      int OH, int OW, int nv, int nh, int s, int tr, int tc,
                                      int dering, void* stream) {
  auto* xs = static_cast<const uint8_t*>(x);
  auto* os = static_cast<uint8_t*>(out);
  auto* tv = static_cast<const float*>(tbl_v);
  auto* th = static_cast<const float*>(tbl_h);
  auto* fv = static_cast<const int*>(fp_v);
  auto* fh = static_cast<const int*>(fp_h);
  auto* rs = static_cast<const int*>(rows);
  auto* cs = static_cast<const int*>(cols);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      dering ? launch<true>(xs, os, tv, th, fv, fh, rs, cs, nc, H, W, OH, OW, nv, nh, s, tr, tc, st)
             : launch<false>(xs, os, tv, th, fv, fh, rs, cs, nc, H, W, OH, OW, nv, nh, s, tr, tc,
                             st);
  return (int)e;
}
