// Phase-uniform banded resample (v1), uint8 planar -> uint8 planar, for Hopper (sm_90a).
//
// Replaces lanczos_tpu/ops/resample_pallas.py::_fused_kernel (v1, with _shift_pass): the
// kernel the TPU runs where no fused plan fits and an axis is not an integer upscale,
// e.g. a Lanczos-3 thumbnail of an 8K frame (1/16, support 48 per side).  Per axis, with
// N/D the reduced scale and the input padded by that axis's support s,
//   mid[r][x] = sum_t tbl_v[ph_v[r]][t] * xp[base_v[r] + t][x]          (t < taps_v = 2 s_v)
//   out[r][c] = sum_t tbl_h[ph_h[c]][t] * mid[r][base_h[c] + t]          (t < taps_h = 2 s_h)
// then trunc(clip(., 0, 255)).  base[o] = (o / N) * D + floor((2 (o % N) D + off) / (2 N)) + 1
// and ph[o] = o % N are computed on the host (lanczos_torch/ops/resample_phase_cuda.py)
// with Python's floor division, which C++ '/' would truncate for align="center"; so are
// the padded-coordinate maps rows/cols (source pixel, or -1 for a zero) with numpy's pad
// rules, so no padded copy of the image is ever made.  The tables hold what the config's
// precision asks: fp32, or for a rational axis in bf16 the weights rounded to bf16.
//
// Exactness: every sum is a multiply then an add, in tap order (__fmul_rn/__fadd_rn, so
// nvcc's default --fmad=true cannot contract them into FMAs), and the kernel gives
// exactly the bytes of its plain PyTorch version.  The TPU kernel summed a rational axis
// as dense per-tile hi/lo bf16 products; this kernel is band-sparse (each output reads
// only its 2 s taps), so against the TPU only the order of those sums differs.
//
// One block computes one (column tile, row tile, plane) tile of tr x tc outputs: it loads
// the uint8 band those outputs read (at most ev padded rows by eh padded columns, sized
// on the host to fit shared memory, the tile shrinking for steep downscales) through the
// pad maps (staged in shared memory first), runs the vertical pass into an intermediate
// in shared memory (MidT: float, or bf16 where the config rounds the intermediate to bf16
// before a rational horizontal pass, as the TPU kernel does), then the horizontal pass
// into the output, masked at the ragged bottom and right edges.
// What bounds it on the H100: the latency of its serial tap chains (a shared load, a
// weight load, a multiply and an add per tap, in order), not arithmetic throughput or
// device memory.  At 3/2 an output costs about 2 x 6 taps and small blocks fill the SM;
// at 1/16 an intermediate value costs 96 vertical taps (the intermediate spans every
// input column the tile reads) and an output 96 horizontal ones, and a block fills
// shared memory, so it runs 32 warps alone on its SM (PERF.md: 2.05 -> 0.76 ms at 8K ->
// 480x270 against 256 threads).  Input traffic is ~1.3-1.8x the image (tile overlaps,
// mostly from L2).
//
// Layouts: x (nc, H, W) u8; out (nc, OH, OW) u8; tbl_v (N_v, taps_v), tbl_h (N_h,
// taps_h) f32; base_v, ph_v (OH,), base_h, ph_h (OW,) int32; rows (H + taps_v,),
// cols (W + taps_h,) int32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Threads a block: 256, or 1024 where at most one block fits an SM (a steep downscale's
// band fills shared memory): then the block alone has to bring the warps that hide the
// latency of its serial tap chains.  The kernel reads blockDim.x.
constexpr int kMaxThreads = 1024;
constexpr size_t kSmemPerSM = 228 * 1024;

struct Geometry {
  int H, W, OH, OW, taps_v, taps_h, tr, tc, ev, eh;
};

__host__ __device__ __forceinline__ int round16(int n) { return (n + 15) / 16 * 16; }

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename MidT>
__global__ void __launch_bounds__(kMaxThreads)
    phase_resample_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                          const float* __restrict__ tbl_v, const float* __restrict__ tbl_h,
                          const int* __restrict__ base_v, const int* __restrict__ ph_v,
                          const int* __restrict__ base_h, const int* __restrict__ ph_h,
                          const int* __restrict__ rows, const int* __restrict__ cols,
                          Geometry g) {
  extern __shared__ float4 smem4[];
  const int nt = blockDim.x;
  const int es = g.eh;  // row stride of the band and of the intermediate
  int* src_r = reinterpret_cast<int*>(smem4);  // (ev,) source row of each band row, or -1
  int* src_c = src_r + g.ev;                   // (eh,) source column of each, or -1
  uint8_t* band = reinterpret_cast<uint8_t*>(smem4) + round16(4 * (g.ev + g.eh));  // (ev, eh)
  MidT* mid = reinterpret_cast<MidT*>(band + round16(g.ev * es));                  // (tr, eh)

  const int y0 = blockIdx.y * g.tr, x0 = blockIdx.x * g.tc;
  const int rows_n = min(g.tr, g.OH - y0), cols_n = min(g.tc, g.OW - x0);
  // this tile's band: padded rows [r0, r0 + ev), padded columns [c0, c0 + eh)
  const int r0 = __ldg(base_v + y0), c0 = __ldg(base_h + x0);
  const int ev = __ldg(base_v + y0 + rows_n - 1) - r0 + g.taps_v;
  const int eh = __ldg(base_h + x0 + cols_n - 1) - c0 + g.taps_h;
  const int hp = g.H + g.taps_v, wp = g.W + g.taps_h;
  const uint8_t* __restrict__ xp = x + (size_t)blockIdx.z * g.H * g.W;

  // the band, through the pad maps (staged first, so that each byte costs one load);
  // zero past the padded image (read by no valid output).  A warp loads a row, its
  // lanes neighbouring columns.
  for (int e = threadIdx.x; e < ev; e += nt) src_r[e] = r0 + e < hp ? __ldg(rows + r0 + e) : -1;
  for (int e = threadIdx.x; e < eh; e += nt) src_c[e] = c0 + e < wp ? __ldg(cols + c0 + e) : -1;
  __syncthreads();
  for (int r = threadIdx.x / 32; r < ev; r += nt / 32) {
    const int sr = src_r[r];
    const uint8_t* __restrict__ row = xp + (size_t)max(sr, 0) * g.W;
#pragma unroll 4
    for (int c = threadIdx.x % 32; c < eh; c += 32) {
      const int sc = src_c[c];
      band[r * es + c] = (sr >= 0 && sc >= 0) ? __ldg(row + sc) : 0;
    }
  }
  __syncthreads();

  // vertical pass: rows_n rows of the intermediate over the band's eh columns
  for (int e = threadIdx.x; e < rows_n * eh; e += nt) {
    const int r = e / eh, c = e - r * eh, y = y0 + r;
    const float* __restrict__ w = tbl_v + __ldg(ph_v + y) * g.taps_v;
    const uint8_t* v = band + (__ldg(base_v + y) - r0) * es + c;
    float acc = __fmul_rn(__ldg(w), (float)v[0]);
    for (int t = 1; t < g.taps_v; ++t)
      acc = __fadd_rn(acc, __fmul_rn(__ldg(w + t), (float)v[t * es]));
    store(mid + r * es + c, acc);
  }
  __syncthreads();

  // horizontal pass and the masked trunc-clip store
  uint8_t* __restrict__ op = out + ((size_t)blockIdx.z * g.OH + y0) * g.OW + x0;
  for (int e = threadIdx.x; e < rows_n * cols_n; e += nt) {
    const int r = e / cols_n, c = e - r * cols_n, xo = x0 + c;
    const float* __restrict__ w = tbl_h + __ldg(ph_h + xo) * g.taps_h;
    const MidT* m = mid + r * es + (__ldg(base_h + xo) - c0);
    float acc = __fmul_rn(__ldg(w), to_float(m[0]));
    for (int t = 1; t < g.taps_h; ++t)
      acc = __fadd_rn(acc, __fmul_rn(__ldg(w + t), to_float(m[t])));
    op[(size_t)r * g.OW + c] = (uint8_t)__float2uint_rz(fminf(fmaxf(acc, 0.f), 255.f));
  }
}

template <typename MidT>
cudaError_t launch(const uint8_t* x, uint8_t* out, const float* tbl_v, const float* tbl_h,
                   const int* base_v, const int* ph_v, const int* base_h, const int* ph_h,
                   const int* rows, const int* cols, int nc, const Geometry& g,
                   cudaStream_t stream) {
  const size_t smem = (size_t)round16(4 * (g.ev + g.eh)) + round16(g.ev * g.eh) +
                      sizeof(MidT) * (size_t)g.tr * g.eh;
  auto* kernel = phase_resample_kernel<MidT>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((g.OW + g.tc - 1) / g.tc, (g.OH + g.tr - 1) / g.tr, nc);
  const int threads = smem > kSmemPerSM / 2 ? kMaxThreads : 256;
  kernel<<<grid, threads, smem, stream>>>(x, out, tbl_v, tbl_h, base_v, ph_v, base_h, ph_h,
                                           rows, cols, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lanczos_phase_resample(const void* x, void* out, const void* tbl_v,
                                      const void* tbl_h, const void* base_v, const void* ph_v,
                                      const void* base_h, const void* ph_h, const void* rows,
                                      const void* cols, int nc, int H, int W, int OH, int OW,
                                      int taps_v, int taps_h, int tr, int tc, int ev, int eh,
                                      int bf16_mid, void* stream) {
  const Geometry g{H, W, OH, OW, taps_v, taps_h, tr, tc, ev, eh};
  auto* xs = static_cast<const uint8_t*>(x);
  auto* os = static_cast<uint8_t*>(out);
  auto* tv = static_cast<const float*>(tbl_v);
  auto* th = static_cast<const float*>(tbl_h);
  auto* bv = static_cast<const int*>(base_v);
  auto* pv = static_cast<const int*>(ph_v);
  auto* bh = static_cast<const int*>(base_h);
  auto* phh = static_cast<const int*>(ph_h);
  auto* rs = static_cast<const int*>(rows);
  auto* cs = static_cast<const int*>(cols);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16_mid ? launch<__nv_bfloat16>(xs, os, tv, th, bv, pv, bh, phh, rs, cs, nc, g, st)
               : launch<float>(xs, os, tv, th, bv, pv, bh, phh, rs, cs, nc, g, st);
  return (int)e;
}
