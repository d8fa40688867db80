// Phase-uniform banded resample (v1), uint8 planar -> uint8 planar, for Hopper (sm_90a).
//
// Replaces lanczos_tpu/ops/resample_pallas.py::_fused_kernel (v1, with _shift_pass): the
// kernel the TPU runs where no fused plan fits and an axis is not an integer upscale,
// e.g. a Lanczos-3 thumbnail of an 8K frame (1/16, support 48 per side), FSR "Quality"
// 1440p->4K (3/2) or an anamorphic desqueeze (4/3 on one axis).  Per axis, with N/D the
// reduced scale and the input padded by that axis's support s,
//   mid[r][x] = sum_t tbl_v[ph_v[r]][t] * xp[base_v[r] + t][x]          (t < taps_v = 2 s_v)
//   out[r][c] = sum_t tbl_h[ph_h[c]][t] * mid[r][base_h[c] + t]          (t < taps_h = 2 s_h)
// then trunc(clip(., 0, 255)).  base[o] = (o / N) * D + floor((2 (o % N) D + off) / (2 N)) + 1
// and ph[o] = o % N are computed on the host (lanczos_torch/ops/resample_phase_cuda.py)
// with Python's floor division, which C++ '/' would truncate for align="center"; so are
// the padded-coordinate maps rows/cols (source pixel, or -1 for a zero) with numpy's pad
// rules, so no padded copy of the image is ever made.  The tables hold what the config's
// precision asks: fp32, or for a rational axis in bf16 the weights rounded to bf16; where
// the config rounds the intermediate to bf16 before a rational horizontal pass, so does
// every design here.
//
// Exactness: every sum is a multiply then an add, in tap order (__fmul_rn/__fadd_rn, so
// nvcc's default --fmad=true cannot contract them into FMAs), and every design gives
// exactly the bytes of the plain PyTorch version.  (The streamed pass starts a sum from
// +0 where the plain version starts from the first product; that can change the sign of
// an exactly zero partial sum and nothing else, and no byte.)  The TPU kernel summed a
// rational axis as dense per-tile hi/lo bf16 products; these kernels are band-sparse
// (each output reads only its 2 s taps), so against the TPU only the order of those sums
// differs.
//
// What bounds v1 on the H100: device memory by the count (8K->480x270 moves 99.9 MB for
// 0.63 G multiply-adds: 0.030 ms at 3.35 TB/s against 0.019 at the SIMT peak), but an
// unfused multiply and add a tap and a conversion a byte put the instruction slots of a good
// kernel at about the same time, so loads have to overlap arithmetic and nothing else
// may be in the loop.  Three designs, chosen per plan on the host (choose_design):
//
//  1. stream (steep downscales, N = 1: the thumbnail).  Two kernels.  The vertical pass
//     is all the work (96% of the multiply-adds, all the traffic): phase_stream_v walks
//     down the input rows of a stripe of columns once.  A lane owns 4 neighbouring
//     columns (one 32-bit word of the row) and keeps the 2a output rows that are live at
//     an input row (6 at Lanczos-3, whatever D) as 2a x 4 independent accumulators; a row
//     adds w * x into each, so every output receives its taps in tap order, each byte is
//     converted once instead of 2a times, and no sum is a chain.  The weights of the live
//     outputs at one row are laid out by the host as one row of a (D, 2a) table: two
//     16-byte broadcast shared loads.  Each warp copies its own 128-column stripe through
//     a ring of three 32-row stages with 16-byte cp.async, so it never waits for the
//     block and copies overlap arithmetic; rows of the pad come through the row map (or
//     as zeros), a width that is not a multiple of 16 takes a byte path.  The grid is
//     (stripes of 128 columns, chunks of output rows, planes), a warp a block: over a
//     thousand independent warps instead of 765 fat tiles, no 1.2-1.3x band overlap across columns, and a
//     chunk re-reads only 2a - 1 periods of rows.  The intermediate goes to device memory
//     ((nc, OH, W) fp32 or bf16, 24.9 or 12.4 MB at the thumbnail: it stays in L2) and
//     phase_stream_h runs the horizontal pass over it: a block stages 32 rows of the
//     band its columns read (through the column map) in shared memory, lanes run along
//     rows (stride odd: no bank conflicts where neighbouring outputs are D apart), warps
//     along output columns.  Against one kernel that owns a tile and streams it, the
//     split costs the intermediate's round trip and saves the column overlap (a 32-column
//     tile reads 592 columns for 512) and a block that fills an SM; the tile design of
//     this file (design 3) is that one-kernel alternative and PERF.md has both times.
//  2. window (N <= 16 phases, up to 8 taps: 3/2, 4/3, an integer axis beside them).  What
//     csrc/shift_resample.cu does for integer upscales, with D in place of 1: a thread
//     owns whole phase periods (N outputs from D inputs), loads the inputs of its run
//     once into a register window (vertical: 4 band columns x K periods of rows;
//     horizontal: 2 rows x K periods of columns) and walks the phases with the phase's
//     weights in registers, so taps of different outputs are independent and no output is
//     a chain of shared loads; phases and positions are loop counters.  N, D and the
//     support are template parameters for 1/1, 2/1, 3/2 and 4/3 at Lanczos-3 with zero
//     alignment (window indices must be constants to stay in registers); other plans take
//     the generic instantiation of the same block, which reads its taps from shared
//     memory 4 columns a word.  The band arrives by 16-byte cp.async where a chunk lies
//     inside the image (origin moved left to the source's 16-byte boundary, realigned
//     with a funnel shift) and byte by byte through the maps at the edges or where W is
//     not a multiple of 16; outputs are staged as uint8 and leave as 16-byte stores.
//     Blocks of 128 threads and 20-40 KB, several an SM.
//  3. generic (everything else: many phases such as 37/25, moderate downscales).  The
//     tile kernel this file had before, with its tables, band offsets and phases staged
//     in shared memory once a block and the per-value divisions replaced by a warp-level
//     walk.  It is also selectable by argument (PhaseOps(design="generic")) as the
//     earlier design beside which the other two are timed.
//
// Layouts: x (nc, H, W) u8; out (nc, OH, OW) u8; tbl_v (N_v, taps_v), tbl_h (N_h,
// taps_h) f32; base_v, ph_v (OH,), base_h, ph_h (OW,) int32; rows (H + taps_v,),
// cols (W + taps_h,) int32; the streamed pass's wt (D, 2a rounded up to 4) f32 and
// intermediate (nc, OH, W) f32 or bf16; the window design's rel_v (N_v,), rel_h (N_h,)
// int32 (each phase's first tap, from its period's first).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__host__ __device__ __forceinline__ int round16(int n) { return (n + 15) / 16 * 16; }

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <int I>
__device__ __forceinline__ float byte_to_float(unsigned w) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + I)) - 8388608.f;
}

// trunc(clip(v, 0, 255))
__device__ __forceinline__ uint8_t quantize(float v) {
  return (uint8_t)__float2uint_rz(fminf(fmaxf(v, 0.f), 255.f));
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
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// ---------------------------------------------------------------------------------------
// design 3, generic: one block a tile of tr x tc outputs, any plan
// ---------------------------------------------------------------------------------------

// Threads a block: 256, or 1024 where at most one block fits an SM (a steep downscale's
// band fills shared memory): then the block alone has to bring the warps that hide the
// latency of its serial tap chains.  The kernel reads blockDim.x.
constexpr int kMaxThreads = 1024;
constexpr size_t kSmemPerSM = 228 * 1024;

struct Geometry {
  int H, W, OH, OW, taps_v, taps_h, tr, tc, ev, eh;
  int nv, nh;            // phases of each axis
  int wv_rows, wh_rows;  // rows of the staged tables: min(phases, tile)
};

// One block computes one (column tile, row tile, plane) tile: it loads the uint8 band
// those outputs read (at most ev padded rows by eh padded columns, sized on the host to
// fit shared memory, the tile shrinking for steep downscales) through the pad maps, runs
// the vertical pass into an intermediate in shared memory (MidT: float, or bf16 where
// the config rounds it), then the horizontal pass into the output, masked at the ragged
// bottom and right edges.  Each value is one thread's serial tap chain; a warp walks 32
// neighbouring columns of one row, and the tables are read from shared memory.
template <typename MidT>
__global__ void __launch_bounds__(kMaxThreads)
    phase_resample_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                          const float* __restrict__ tbl_v, const float* __restrict__ tbl_h,
                          const int* __restrict__ base_v, const int* __restrict__ ph_v,
                          const int* __restrict__ base_h, const int* __restrict__ ph_h,
                          const int* __restrict__ rows, const int* __restrict__ cols,
                          Geometry g) {
  extern __shared__ float4 smem4[];
  const int nt = blockDim.x, nw = nt >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int es = g.eh;  // row stride of the band and of the intermediate
  int* src_r = reinterpret_cast<int*>(smem4);  // (ev,) source row of each band row, or -1
  int* src_c = src_r + g.ev;                   // (eh,) source column of each, or -1
  int* off_v = src_c + g.eh;                   // (tr,) band row of each output row's tap 0
  int* off_h = off_v + g.tr;                   // (tc,) band column of each output column's
  int* wrow_v = off_h + g.tc;                  // (tr,) row of wv of each output row
  int* wrow_h = wrow_v + g.tr;                 // (tc,) row of wh of each output column
  float* wv = reinterpret_cast<float*>(wrow_h + g.tc);  // (wv_rows, taps_v)
  float* wh = wv + g.wv_rows * g.taps_v;                // (wh_rows, taps_h)
  const int head = 4 * (g.ev + g.eh + 2 * g.tr + 2 * g.tc + g.wv_rows * g.taps_v +
                        g.wh_rows * g.taps_h);
  uint8_t* band = reinterpret_cast<uint8_t*>(smem4) + round16(head);  // (ev, eh)
  MidT* mid = reinterpret_cast<MidT*>(band + round16(g.ev * es));     // (tr, eh)

  const int y0 = blockIdx.y * g.tr, x0 = blockIdx.x * g.tc;
  const int rows_n = min(g.tr, g.OH - y0), cols_n = min(g.tc, g.OW - x0);
  // this tile's band: padded rows [r0, r0 + ev), padded columns [c0, c0 + eh)
  const int r0 = __ldg(base_v + y0), c0 = __ldg(base_h + x0);
  const int ev = __ldg(base_v + y0 + rows_n - 1) - r0 + g.taps_v;
  const int eh = __ldg(base_h + x0 + cols_n - 1) - c0 + g.taps_h;
  const int hp = g.H + g.taps_v, wp = g.W + g.taps_h;
  const uint8_t* __restrict__ xp = x + (size_t)blockIdx.z * g.H * g.W;

  // the pad maps of the band, each output's band offset and table row, and the tables:
  // the whole table where it has no more rows than the tile, else the tile's own rows
  const bool whole_v = g.nv <= g.tr, whole_h = g.nh <= g.tc;
  for (int e = threadIdx.x; e < ev; e += nt) src_r[e] = r0 + e < hp ? __ldg(rows + r0 + e) : -1;
  for (int e = threadIdx.x; e < eh; e += nt) src_c[e] = c0 + e < wp ? __ldg(cols + c0 + e) : -1;
  for (int e = threadIdx.x; e < rows_n; e += nt) {
    off_v[e] = __ldg(base_v + y0 + e) - r0;
    wrow_v[e] = whole_v ? __ldg(ph_v + y0 + e) : e;
  }
  for (int e = threadIdx.x; e < cols_n; e += nt) {
    off_h[e] = __ldg(base_h + x0 + e) - c0;
    wrow_h[e] = whole_h ? __ldg(ph_h + x0 + e) : e;
  }
  for (int e = threadIdx.x; e < g.wv_rows * g.taps_v; e += nt) {
    const int r = e / g.taps_v;
    wv[e] = whole_v ? __ldg(tbl_v + e)
                    : (r < rows_n ? __ldg(tbl_v + __ldg(ph_v + y0 + r) * g.taps_v + e - r * g.taps_v)
                                  : 0.f);
  }
  for (int e = threadIdx.x; e < g.wh_rows * g.taps_h; e += nt) {
    const int c = e / g.taps_h;
    wh[e] = whole_h ? __ldg(tbl_h + e)
                    : (c < cols_n ? __ldg(tbl_h + __ldg(ph_h + x0 + c) * g.taps_h + e - c * g.taps_h)
                                  : 0.f);
  }
  __syncthreads();
  // the band, through the staged maps; zero past the padded image (read by no valid
  // output).  A warp loads a row, its lanes neighbouring columns.
  for (int r = warp; r < ev; r += nw) {
    const int sr = src_r[r];
    const uint8_t* __restrict__ row = xp + (size_t)max(sr, 0) * g.W;
#pragma unroll 4
    for (int c = lane; c < eh; c += 32) {
      const int sc = src_c[c];
      band[r * es + c] = (sr >= 0 && sc >= 0) ? __ldg(row + sc) : 0;
    }
  }
  __syncthreads();

  // vertical pass: rows_n rows of the intermediate over the band's eh columns.  A warp
  // takes 32 neighbouring columns of one row a step; its (row, segment) advances by
  // carry, so the one division is per thread, not per value.
  {
    const int cseg = (eh + 31) >> 5, total = rows_n * cseg;
    const int dq = nw / cseg, dr = nw - dq * cseg;
    int r = warp / cseg, sg = warp - r * cseg;
    for (int idx = warp; idx < total; idx += nw) {
      const int c = (sg << 5) + lane;
      if (c < eh) {
        const float* w = wv + wrow_v[r] * g.taps_v;
        const uint8_t* v = band + off_v[r] * es + c;
        float acc = __fmul_rn(w[0], (float)v[0]);
        for (int t = 1; t < g.taps_v; ++t)
          acc = __fadd_rn(acc, __fmul_rn(w[t], (float)v[t * es]));
        store(mid + r * es + c, acc);
      }
      r += dq, sg += dr;
      if (sg >= cseg) sg -= cseg, ++r;
    }
  }
  __syncthreads();

  // horizontal pass and the masked trunc-clip store
  {
    uint8_t* __restrict__ op = out + ((size_t)blockIdx.z * g.OH + y0) * g.OW + x0;
    const int cseg = (cols_n + 31) >> 5, total = rows_n * cseg;
    const int dq = nw / cseg, dr = nw - dq * cseg;
    int r = warp / cseg, sg = warp - r * cseg;
    for (int idx = warp; idx < total; idx += nw) {
      const int c = (sg << 5) + lane;
      if (c < cols_n) {
        const float* w = wh + wrow_h[c] * g.taps_h;
        const MidT* m = mid + r * es + off_h[c];
        float acc = __fmul_rn(w[0], to_float(m[0]));
        for (int t = 1; t < g.taps_h; ++t)
          acc = __fadd_rn(acc, __fmul_rn(w[t], to_float(m[t])));
        op[(size_t)r * g.OW + c] = quantize(acc);
      }
      r += dq, sg += dr;
      if (sg >= cseg) sg -= cseg, ++r;
    }
  }
}

template <typename MidT>
cudaError_t launch_generic(const uint8_t* x, uint8_t* out, const float* tbl_v,
                           const float* tbl_h, const int* base_v, const int* ph_v,
                           const int* base_h, const int* ph_h, const int* rows,
                           const int* cols, int nc, const Geometry& g, cudaStream_t stream) {
  const size_t smem =
      (size_t)round16(4 * (g.ev + g.eh + 2 * g.tr + 2 * g.tc + g.wv_rows * g.taps_v +
                           g.wh_rows * g.taps_h)) +
      round16(g.ev * g.eh) + sizeof(MidT) * (size_t)g.tr * g.eh;
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

// ---------------------------------------------------------------------------------------
// design 1, stream: the vertical pass walks down the rows, the horizontal pass follows
// ---------------------------------------------------------------------------------------

// Warps a block: one.  Warps share nothing but the weights, and the card balances many
// small blocks better than few large ones (PERF.md has blocks of 2 and 4 warps beside it).
constexpr int kStreamWarps = 1;
constexpr int kStreamThreads = 32 * kStreamWarps;
constexpr int kStripe = 128;    // columns of one warp: 4 a lane
constexpr int kStageRows = 32;  // input rows of one stage of a warp's ring
constexpr int kStages = 3;
constexpr int kStageBytes = kStageRows * kStripe;

struct StreamV {
  int H, W, OH;
  int d;     // input rows a period (N = 1: an output row a period)
  int b0;    // padded row of output 0's first tap
  int taps;  // live * d
  int rpc;   // output rows of one chunk (blockIdx.y)
  int vec_in, vec_mid;
};

__device__ __forceinline__ void store_mid4(float* p, const float (&a)[4], int n, int vec) {
  if (vec && n >= 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  } else {
    for (int b = 0; b < 4 && b < n; ++b) p[b] = a[b];
  }
}
__device__ __forceinline__ void store_mid4(__nv_bfloat16* p, const float (&a)[4], int n,
                                           int vec) {
  if (vec && n >= 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
    *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                              *reinterpret_cast<const unsigned*>(&hi));
  } else {
    for (int b = 0; b < 4 && b < n; ++b) p[b] = __float2bfloat16_rn(a[b]);
  }
}

// LIVE = taps / d = 2a output rows are live at every input row.  At padded row
// b0 + q d + j (j < d) they are rows q, q - 1, ..., q - (LIVE - 1), and the row is tap
// k d + j of the one of age k: wt[j][k] = tbl_v[0][k d + j].  acc[k] belongs to the row
// of age k; after a period the oldest is complete and the others age by one.
template <int LIVE, typename MidT>
__global__ void __launch_bounds__(kStreamThreads)
    phase_stream_v_kernel(const uint8_t* __restrict__ x, MidT* __restrict__ mid,
                          const float* __restrict__ wt, const int* __restrict__ rows,
                          StreamV g) {
  constexpr int LW = (LIVE + 3) / 4 * 4;
  extern __shared__ uint4 smem16[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem16);  // (warps, kStages, kStageRows, kStripe)
  float* wts = reinterpret_cast<float*>(ring + kStreamWarps * kStages * kStageBytes);  // (d, LW)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int e = threadIdx.x; e < g.d * LW; e += kStreamThreads) wts[e] = __ldg(wt + e);
  __syncthreads();
  const int cw0 = (blockIdx.x * kStreamWarps + warp) * kStripe;  // the warp's first column
  if (cw0 >= g.W) return;  // no barrier below: a warp runs on its own
  const int ra = blockIdx.y * g.rpc, rb = min(ra + g.rpc, g.OH);
  const int i0 = ra * g.d + g.b0;                // first padded row of the chunk
  const int nrows = (rb - ra + LIVE - 1) * g.d;  // padded rows it walks
  const int hp = g.H + g.taps;
  const int nstages = (nrows + kStageRows - 1) / kStageRows;
  const uint8_t* __restrict__ xp = x + (size_t)blockIdx.z * g.H * g.W;
  uint8_t* my = ring + warp * (kStages * kStageBytes);
  const int col0 = cw0 + 4 * lane;

  // stage s of the ring: padded rows i0 + s kStageRows ... of the warp's stripe, each through the
  // row map; zero past the chunk, past the padded image and past the right edge
  auto copy_stage = [&](int s) {
    if (s < nstages) {
      uint8_t* dst = my + (s % kStages) * kStageBytes;
      if (g.vec_in) {
#pragma unroll
        for (int k = 0; k < kStageBytes / 16 / 32; ++k) {
          const int e = lane + 32 * k, row = e >> 3, ch = e & 7;
          const int rr = s * kStageRows + row, col = cw0 + 16 * ch;
          const int sr = (rr < nrows && i0 + rr < hp) ? __ldg(rows + i0 + rr) : -1;
          const bool ok = sr >= 0 && col < g.W;
          cp_async16_cg(dst + row * kStripe + 16 * ch, ok ? xp + (size_t)sr * g.W + col : xp,
                        ok ? 16 : 0);
        }
      } else {
        for (int row = 0; row < kStageRows; ++row) {
          const int rr = s * kStageRows + row;
          const int sr = (rr < nrows && i0 + rr < hp) ? __ldg(rows + i0 + rr) : -1;
          unsigned word = 0u;
          for (int b = 0; b < 4 && sr >= 0; ++b)
            if (col0 + b < g.W) word |= (unsigned)__ldg(xp + (size_t)sr * g.W + col0 + b) << (8 * b);
          reinterpret_cast<unsigned*>(dst)[row * 32 + lane] = word;
        }
      }
    }
    cp_async_commit();
  };

  float acc[LIVE][4];
#pragma unroll
  for (int k = 0; k < LIVE; ++k)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[k][c] = 0.f;
  int j = 0, q = ra;  // row of the period, and the period: the newest live output row
  for (int s = 0; s < kStages - 1; ++s) copy_stage(s);
  for (int s = 0; s < nstages; ++s) {
    cp_async_wait_group<kStages - 2>();  // stage s has arrived (this lane's copies)
    __syncwarp();                        // ... and every lane's; stage s - 1 is read out
    copy_stage(s + kStages - 1);
    const unsigned* st = reinterpret_cast<const unsigned*>(my + (s % kStages) * kStageBytes);
    const int nr = min(kStageRows, nrows - s * kStageRows);
#pragma unroll 4
    for (int row = 0; row < nr; ++row) {
      const unsigned word = st[row * 32 + lane];
      float w[LW];
#pragma unroll
      for (int k4 = 0; k4 < LW / 4; ++k4) {
        const float4 f = *reinterpret_cast<const float4*>(wts + j * LW + 4 * k4);
        w[4 * k4] = f.x, w[4 * k4 + 1] = f.y, w[4 * k4 + 2] = f.z, w[4 * k4 + 3] = f.w;
      }
      const float xv[4] = {byte_to_float<0>(word), byte_to_float<1>(word),
                           byte_to_float<2>(word), byte_to_float<3>(word)};
#pragma unroll
      for (int k = 0; k < LIVE; ++k)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[k][c] = __fadd_rn(acc[k][c], __fmul_rn(w[k], xv[c]));
      if (++j == g.d) {  // the period ends: the oldest row is complete, the others age
        j = 0;
        const int r = q - (LIVE - 1);
        if (r >= ra)
          store_mid4(mid + ((size_t)blockIdx.z * g.OH + r) * g.W + col0, acc[LIVE - 1],
                     g.W - col0, g.vec_mid);
#pragma unroll
        for (int k = LIVE - 1; k > 0; --k)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[k][c] = acc[k - 1][c];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[0][c] = 0.f;
        ++q;
      }
    }
  }
}

template <int LIVE, typename MidT>
cudaError_t launch_stream_v(const uint8_t* x, void* mid, const float* wt, const int* rows,
                            int nc, const StreamV& g, cudaStream_t stream) {
  constexpr int LW = (LIVE + 3) / 4 * 4;
  const size_t smem = (size_t)kStreamWarps * kStages * kStageBytes + sizeof(float) * g.d * LW;
  auto* kernel = phase_stream_v_kernel<LIVE, MidT>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int per_block = kStreamWarps * kStripe;
  const dim3 grid((g.W + per_block - 1) / per_block, (g.OH + g.rpc - 1) / g.rpc, nc);
  kernel<<<grid, kStreamThreads, smem, stream>>>(x, static_cast<MidT*>(mid), wt, rows, g);
  return cudaGetLastError();
}

constexpr int kHThreads = 256, kHWarps = kHThreads / 32;
constexpr int kHRows = 32;  // rows of one block: a lane each
constexpr int kHBatch = 4;   // loads of the band a thread keeps in flight

struct StreamH {
  int W, OH, OW, taps, tc, eh, nh, wh_rows;
};

// The horizontal pass over the intermediate in device memory.  One block computes 32 rows
// x tc output columns: it stages the eh padded columns they read, through the column map,
// as fp32 with an odd row stride; then a warp takes an output column and its lanes the 32
// rows, so neighbouring lanes read neighbouring banks whatever D, and the column's
// weights are one broadcast load a tap.  Outputs are staged and stored a row a warp.
template <typename MidT>
__global__ void __launch_bounds__(kHThreads)
    phase_stream_h_kernel(const MidT* __restrict__ mid, uint8_t* __restrict__ out,
                          const float* __restrict__ tbl_h, const int* __restrict__ base_h,
                          const int* __restrict__ ph_h, const int* __restrict__ cols,
                          StreamH g) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int es = g.eh | 1;
  int* src_c = reinterpret_cast<int*>(smem4);  // (eh,)
  int* off_h = src_c + g.eh;                   // (tc,)
  int* wrow_h = off_h + g.tc;                  // (tc,)
  float* wh = reinterpret_cast<float*>(wrow_h + g.tc);  // (wh_rows, taps)
  float* band = wh + g.wh_rows * g.taps;                // (32, es)
  uint8_t* stage = reinterpret_cast<uint8_t*>(band + kHRows * es);  // (32, tc)

  const int y0 = blockIdx.y * kHRows, x0 = blockIdx.x * g.tc;
  const int rows_n = min(kHRows, g.OH - y0), cols_n = min(g.tc, g.OW - x0);
  const int c0 = __ldg(base_h + x0);
  const int eh = __ldg(base_h + x0 + cols_n - 1) - c0 + g.taps;
  const int wp = g.W + g.taps;
  const bool whole_h = g.nh <= g.tc;
  for (int e = threadIdx.x; e < eh; e += kHThreads)
    src_c[e] = c0 + e < wp ? __ldg(cols + c0 + e) : -1;
  for (int e = threadIdx.x; e < cols_n; e += kHThreads) {
    off_h[e] = __ldg(base_h + x0 + e) - c0;
    wrow_h[e] = whole_h ? __ldg(ph_h + x0 + e) : e;
  }
  for (int e = threadIdx.x; e < g.wh_rows * g.taps; e += kHThreads) {
    const int c = e / g.taps;
    wh[e] = whole_h ? __ldg(tbl_h + e)
                    : (c < cols_n ? __ldg(tbl_h + __ldg(ph_h + x0 + c) * g.taps + e - c * g.taps)
                                  : 0.f);
  }
  __syncthreads();
  // the band: a warp takes rows warp, warp + 8, ... in segments of 32 columns, kHBatch
  // segments at a time, all their loads in flight before the first is stored
  const MidT* __restrict__ mp = mid + ((size_t)blockIdx.z * g.OH + y0) * g.W;
  {
    const int nseg = (eh + 31) >> 5;
    int r = warp, sg = 0;
    while (r < rows_n) {
      float v[kHBatch];
      int dst[kHBatch];
#pragma unroll
      for (int u = 0; u < kHBatch; ++u) {
        const int c = (sg << 5) + lane;
        const bool ok = r < rows_n && c < eh;
        const int sc = ok ? src_c[c] : -1;
        v[u] = sc >= 0 ? to_float(mp[(size_t)r * g.W + sc]) : 0.f;
        dst[u] = ok ? r * es + c : -1;
        if (++sg == nseg) sg = 0, r += kHWarps;
      }
#pragma unroll
      for (int u = 0; u < kHBatch; ++u)
        if (dst[u] >= 0) band[dst[u]] = v[u];
    }
  }
  __syncthreads();
  if (lane < rows_n) {
    for (int c = warp; c < cols_n; c += kHWarps) {
      const float* w = wh + wrow_h[c] * g.taps;
      const float* m = band + lane * es + off_h[c];
      float acc = __fmul_rn(w[0], m[0]);
      for (int t = 1; t < g.taps; ++t) acc = __fadd_rn(acc, __fmul_rn(w[t], m[t]));
      stage[lane * g.tc + c] = quantize(acc);
    }
  }
  __syncthreads();
  uint8_t* __restrict__ op = out + ((size_t)blockIdx.z * g.OH + y0) * g.OW + x0;
  for (int r = warp; r < rows_n; r += kHWarps)
    for (int c = lane; c < cols_n; c += 32) op[(size_t)r * g.OW + c] = stage[r * g.tc + c];
}

template <typename MidT>
cudaError_t launch_stream_h(const void* mid, uint8_t* out, const float* tbl_h,
                            const int* base_h, const int* ph_h, const int* cols, int nc,
                            const StreamH& g, cudaStream_t stream) {
  const size_t smem = 4 * ((size_t)g.eh + 2 * g.tc + g.wh_rows * g.taps + kHRows * (g.eh | 1)) +
                      (size_t)kHRows * g.tc;
  auto* kernel = phase_stream_h_kernel<MidT>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((g.OW + g.tc - 1) / g.tc, (g.OH + kHRows - 1) / kHRows, nc);
  kernel<<<grid, kHThreads, smem, stream>>>(static_cast<const MidT*>(mid), out, tbl_h, base_h,
                                            ph_h, cols, g);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------------------
// design 2, window: a thread owns whole phase periods in a register window
// ---------------------------------------------------------------------------------------

constexpr int kWinThreads = 128, kWinWarps = kWinThreads / 32;

// One axis at compile time: N/D at support S with zero alignment, where phase p's first
// tap is p D / N inputs after its period's first.  A thread's run is K periods (about 4
// inputs), read from a window of kLen inputs.  Axis<0, 0, 0> is any axis at run time.
template <int N_, int D_, int S_>
struct Axis {
  static constexpr int N = N_, D = D_, kTaps = 2 * S_;
  static constexpr int kN1 = N_ > 0 ? N_ : 1, kD1 = D_ > 0 ? D_ : 1;  // divisors, never 0
  static constexpr int K = N_ > 0 ? (4 + kD1 - 1) / kD1 : 1;
  static constexpr int kRun = K * D_;
  static constexpr int kMaxRel = (kN1 - 1) * D_ / kN1;
  static constexpr int kLen = (K - 1) * D_ + kMaxRel + kTaps;
  static __host__ __device__ constexpr int rel(int p) { return p * D_ / kN1; }
};
using AxisAny = Axis<0, 0, 0>;

struct WinShape {
  int H, W, OH, OW;
  int nv, dv, sv, f0v, pv, maxrel_v;  // phases, inputs a period, support, padded row of
  int nh, dh, sh, f0h, ph, maxrel_h;  // output 0's period, periods a block, largest rel
  int ev;        // padded rows of a block's band
  int mwid;      // columns of the intermediate: a multiple of 4
  int mstr;      // its row stride in floats: mwid + 4
  int bwid;      // bytes of a band row (a multiple of 16)
  int chunk_lg;  // log2 of the 16-byte chunks of a band row, rounded up
  int vec_in, vec_out;
};

template <bool ROUND>
__device__ __forceinline__ float round_mid(float v) {
  return ROUND ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// vertical pass of a compile-time axis: runs of K periods of rows x 4 band columns
template <class A, bool ROUND>
__device__ __forceinline__ void vertical_window(const uint8_t* band, float* mid,
                                                const float* wv, const WinShape& g,
                                                int delta) {
  constexpr int K = A::K, L = A::kLen, T = A::kTaps;
  const int ng = g.mwid >> 2, shift = 8 * (delta & 3), bw4 = g.bwid >> 2;
  for (int it = threadIdx.x; it < (g.pv / K) * ng; it += kWinThreads) {
    const int qg = it / ng, cg = it - qg * ng;
    const unsigned* bp =
        reinterpret_cast<const unsigned*>(band + qg * A::kRun * g.bwid) + ((delta + 4 * cg) >> 2);
    float v[4][L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const unsigned word = __funnelshift_r(bp[k * bw4], bp[k * bw4 + 1], shift);
      v[0][k] = byte_to_float<0>(word), v[1][k] = byte_to_float<1>(word);
      v[2][k] = byte_to_float<2>(word), v[3][k] = byte_to_float<3>(word);
    }
#pragma unroll
    for (int p = 0; p < A::N; ++p) {
      float w[T];
#pragma unroll
      for (int t = 0; t < T; ++t) w[t] = wv[p * T + t];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float o[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float acc = __fmul_rn(w[0], v[c][k * A::D + A::rel(p)]);
#pragma unroll
          for (int t = 1; t < T; ++t)
            acc = __fadd_rn(acc, __fmul_rn(w[t], v[c][k * A::D + A::rel(p) + t]));
          o[c] = round_mid<ROUND>(acc);
        }
        *reinterpret_cast<float4*>(mid + ((qg * K + k) * A::N + p) * g.mstr + 4 * cg) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
  }
}

// vertical pass of any axis: a period x 4 band columns a step, taps read from the band
template <bool ROUND>
__device__ __forceinline__ void vertical_any(const uint8_t* band, float* mid, const float* wv,
                                             const int* rel_v, const WinShape& g, int delta) {
  const int ng = g.mwid >> 2, shift = 8 * (delta & 3), bw4 = g.bwid >> 2, taps = 2 * g.sv;
  for (int it = threadIdx.x; it < g.pv * ng; it += kWinThreads) {
    const int q = it / ng, cg = it - q * ng;
    const unsigned* bp = reinterpret_cast<const unsigned*>(band) + ((delta + 4 * cg) >> 2);
    for (int p = 0; p < g.nv; ++p) {
      const float* w = wv + p * taps;
      const unsigned* tp = bp + (q * g.dv + rel_v[p]) * bw4;
      float a0, a1, a2, a3;
      {
        const unsigned word = __funnelshift_r(tp[0], tp[1], shift);
        a0 = __fmul_rn(w[0], byte_to_float<0>(word)), a1 = __fmul_rn(w[0], byte_to_float<1>(word));
        a2 = __fmul_rn(w[0], byte_to_float<2>(word)), a3 = __fmul_rn(w[0], byte_to_float<3>(word));
      }
      for (int t = 1; t < taps; ++t) {
        const unsigned word = __funnelshift_r(tp[t * bw4], tp[t * bw4 + 1], shift);
        a0 = __fadd_rn(a0, __fmul_rn(w[t], byte_to_float<0>(word)));
        a1 = __fadd_rn(a1, __fmul_rn(w[t], byte_to_float<1>(word)));
        a2 = __fadd_rn(a2, __fmul_rn(w[t], byte_to_float<2>(word)));
        a3 = __fadd_rn(a3, __fmul_rn(w[t], byte_to_float<3>(word)));
      }
      *reinterpret_cast<float4*>(mid + (q * g.nv + p) * g.mstr + 4 * cg) = make_float4(
          round_mid<ROUND>(a0), round_mid<ROUND>(a1), round_mid<ROUND>(a2), round_mid<ROUND>(a3));
    }
  }
}

// horizontal pass of a compile-time axis: 2 rows x runs of K periods of columns, into
// the staged tile.  The window is loaded as the widest vectors the run's start allows.
template <class A>
__device__ __forceinline__ void horizontal_window(const float* mid, uint8_t* stage,
                                                  const float* wh, const WinShape& g) {
  constexpr int K = A::K, L = A::kLen, T = A::kTaps;
  constexpr int VW = A::kRun % 4 == 0 ? 4 : (A::kRun % 2 == 0 ? 2 : 1);
  constexpr int NV = (L + VW - 1) / VW;
  const int ng = g.ph / K, tr = g.nv * g.pv, tc = g.nh * g.ph;
  for (int it = threadIdx.x; it < (tr >> 1) * ng; it += kWinThreads) {
    const int rp = it / ng, cg = it - rp * ng;
    float win[2][NV * VW];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* mp = mid + (2 * rp + h) * g.mstr + A::kRun * cg;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        if constexpr (VW == 4) {
          const float4 m = reinterpret_cast<const float4*>(mp)[k];
          win[h][4 * k] = m.x, win[h][4 * k + 1] = m.y, win[h][4 * k + 2] = m.z,
                     win[h][4 * k + 3] = m.w;
        } else if constexpr (VW == 2) {
          const float2 m = reinterpret_cast<const float2*>(mp)[k];
          win[h][2 * k] = m.x, win[h][2 * k + 1] = m.y;
        } else {
          win[h][k] = mp[k];
        }
      }
    }
    uint8_t* sp = stage + 2 * rp * tc + cg * K * A::N;
#pragma unroll
    for (int p = 0; p < A::N; ++p) {
      float w[T];
#pragma unroll
      for (int t = 0; t < T; ++t) w[t] = wh[p * T + t];
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float acc = __fmul_rn(w[0], win[h][k * A::D + A::rel(p)]);
#pragma unroll
          for (int t = 1; t < T; ++t)
            acc = __fadd_rn(acc, __fmul_rn(w[t], win[h][k * A::D + A::rel(p) + t]));
          sp[h * tc + k * A::N + p] = quantize(acc);
        }
      }
    }
  }
}

// horizontal pass of any axis: a row x a period a step, taps read from the intermediate
__device__ __forceinline__ void horizontal_any(const float* mid, uint8_t* stage,
                                               const float* wh, const int* rel_h,
                                               const WinShape& g) {
  const int tr = g.nv * g.pv, tc = g.nh * g.ph, taps = 2 * g.sh;
  for (int it = threadIdx.x; it < tr * g.ph; it += kWinThreads) {
    const int r = it / g.ph, q = it - r * g.ph;
    for (int p = 0; p < g.nh; ++p) {
      const float* w = wh + p * taps;
      const float* m = mid + r * g.mstr + q * g.dh + rel_h[p];
      float acc = __fmul_rn(w[0], m[0]);
      for (int t = 1; t < taps; ++t) acc = __fadd_rn(acc, __fmul_rn(w[t], m[t]));
      stage[r * tc + q * g.nh + p] = quantize(acc);
    }
  }
}

// One block computes one (column chunk, row tile, plane) tile of tr x tc outputs,
// tr = N_v pv and tc = N_h ph: whole periods, tc a multiple of 16.  Output row q N_v + p
// reads padded rows q D_v + f0v + rel_v[p] + t, so the block's band starts at padded row
// (blockIdx.y pv) D_v + f0v and padded column (blockIdx.x ph) D_h + f0h.
template <class VA, class HA, bool ROUND>
__global__ void __launch_bounds__(kWinThreads, 4)
    phase_window_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                        const float* __restrict__ tbl_v, const float* __restrict__ tbl_h,
                        const int* __restrict__ rel_v, const int* __restrict__ rel_h,
                        const int* __restrict__ rows, const int* __restrict__ cols,
                        WinShape g) {
  extern __shared__ uint4 smem16[];
  const int taps_v = 2 * g.sv, taps_h = 2 * g.sh;
  const int tr = g.nv * g.pv, tc = g.nh * g.ph, bwid = g.bwid;
  uint8_t* band = reinterpret_cast<uint8_t*>(smem16);              // (ev, bwid)
  float* mid = reinterpret_cast<float*>(band + g.ev * bwid);       // (tr, mstr)
  uint8_t* stage = reinterpret_cast<uint8_t*>(mid + tr * g.mstr);  // (tr, tc)
  float* wv = reinterpret_cast<float*>(stage + tr * tc);           // (nv, taps_v)
  float* wh = wv + g.nv * taps_v;                                  // (nh, taps_h)
  int* rv_s = reinterpret_cast<int*>(wh + g.nh * taps_h);          // (nv,) rel_v
  int* rh_s = rv_s + g.nv;                                         // (nh,) rel_h

  const int y0 = blockIdx.y * tr, x0 = blockIdx.x * tc;
  const int k0 = blockIdx.y * g.pv * g.dv + g.f0v;  // first padded row
  const int j0 = blockIdx.x * g.ph * g.dh + g.f0h;  // first padded column
  const int delta = (j0 - g.sh) & 15;  // band byte of padded column j0: its source column mod 16
  const int jA = j0 - delta;           // padded column of band byte 0 (may be negative)
  const int hp = g.H + taps_v, wp = g.W + taps_h;
  const uint8_t* __restrict__ xp = x + (size_t)blockIdx.z * g.H * g.W;

  // the tables and the band, as asynchronous copies in flight together.  The band in
  // 16-byte chunks: a copy where the chunk lies inside the image (there the maps are the
  // identity shifted by the support), else byte by byte through the maps; zero past the
  // padded image (read by no valid output)
  for (int e = threadIdx.x; e < g.nv * taps_v; e += kWinThreads) cp_async4(wv + e, tbl_v + e);
  for (int e = threadIdx.x; e < g.nh * taps_h; e += kWinThreads) cp_async4(wh + e, tbl_h + e);
  for (int e = threadIdx.x; e < g.nv; e += kWinThreads) cp_async4(rv_s + e, rel_v + e);
  for (int e = threadIdx.x; e < g.nh; e += kWinThreads) cp_async4(rh_s + e, rel_h + e);
  {
    const int per_row = 1 << g.chunk_lg, nch = bwid >> 4;
    for (int e = threadIdx.x; e < (g.ev << g.chunk_lg); e += kWinThreads) {
      const int k = e >> g.chunk_lg, q = e & (per_row - 1);
      if (q >= nch) continue;
      const int r = k0 + k, jc = jA + 16 * q;
      const int sr = r < hp ? __ldg(rows + r) : -1;
      const uint8_t* __restrict__ src = xp + (size_t)max(sr, 0) * g.W;
      uint4* dst = reinterpret_cast<uint4*>(band + k * bwid + 16 * q);
      if (g.vec_in && (sr < 0 || (jc >= g.sh && jc - g.sh + 16 <= g.W))) {
        cp_async16_cg(dst, sr < 0 ? xp : src + (jc - g.sh), sr < 0 ? 0 : 16);
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

  if constexpr (VA::N > 0) {
    vertical_window<VA, ROUND>(band, mid, wv, g, delta);
  } else {
    vertical_any<ROUND>(band, mid, wv, rv_s, g, delta);
  }
  __syncthreads();
  if constexpr (HA::N > 0) {
    horizontal_window<HA>(mid, stage, wh, g);
  } else {
    horizontal_any(mid, stage, wh, rh_s, g);
  }
  __syncthreads();

  // the staged tile to the output, masked at the ragged bottom and right edges
  const int rows_n = min(tr, g.OH - y0), cols_n = min(tc, g.OW - x0);
  uint8_t* __restrict__ op = out + ((size_t)blockIdx.z * g.OH + y0) * g.OW + x0;
  if (g.vec_out) {  // tc is a multiple of 16, so every chunk of every row is aligned
    const int cpr = (cols_n + 15) >> 4;  // 16-byte chunks of a row
    for (int e = threadIdx.x; e < rows_n * cpr; e += kWinThreads) {
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
    for (int r = warp; r < rows_n; r += kWinWarps)
      for (int c = lane; c < cols_n; c += 32) op[(size_t)r * g.OW + c] = stage[r * tc + c];
  }
}

struct WinArgs {
  const uint8_t* x;
  uint8_t* out;
  const float *tbl_v, *tbl_h;
  const int *rel_v, *rel_h, *rows, *cols;
  int nc;
  cudaStream_t stream;
};

template <class VA, class HA, bool ROUND>
cudaError_t launch_window(const WinArgs& a, const WinShape& g) {
  if (g.pv % VA::K || g.ph % HA::K) return cudaErrorInvalidValue;
  if ((VA::N > 0 && g.sv * 2 != VA::kTaps) || (HA::N > 0 && g.sh * 2 != HA::kTaps))
    return cudaErrorInvalidValue;
  const int tr = g.nv * g.pv, tc = g.nh * g.ph;
  const size_t smem = (size_t)g.ev * g.bwid + sizeof(float) * (size_t)tr * g.mstr +
                      (size_t)tr * tc + sizeof(float) * (size_t)(g.nv * 2 * g.sv + g.nh * 2 * g.sh) +
                      sizeof(int) * (size_t)(g.nv + g.nh);
  auto* kernel = phase_window_kernel<VA, HA, ROUND>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((g.OW + tc - 1) / tc, (g.OH + tr - 1) / tr, a.nc);
  kernel<<<grid, kWinThreads, smem, a.stream>>>(a.x, a.out, a.tbl_v, a.tbl_h, a.rel_v, a.rel_h,
                                                 a.rows, a.cols, g);
  return cudaGetLastError();
}

template <class VA, class HA>
cudaError_t launch_window_mid(const WinArgs& a, const WinShape& g, int round_mid) {
  return round_mid ? launch_window<VA, HA, true>(a, g) : launch_window<VA, HA, false>(a, g);
}

}  // namespace

extern "C" int lanczos_phase_resample(const void* x, void* out, const void* tbl_v,
                                      const void* tbl_h, const void* base_v, const void* ph_v,
                                      const void* base_h, const void* ph_h, const void* rows,
                                      const void* cols, int nc, int H, int W, int OH, int OW,
                                      int taps_v, int taps_h, int tr, int tc, int ev, int eh,
                                      int nv, int nh, int bf16_mid, void* stream) {
  const Geometry g{H,  W,  OH, OW, taps_v,      taps_h,     tr, tc, ev, eh,
                   nv, nh, nv <= tr ? nv : tr, nh <= tc ? nh : tc};
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
      bf16_mid ? launch_generic<__nv_bfloat16>(xs, os, tv, th, bv, pv, bh, phh, rs, cs, nc, g, st)
               : launch_generic<float>(xs, os, tv, th, bv, pv, bh, phh, rs, cs, nc, g, st);
  return (int)e;
}

// The streamed vertical pass: x (nc, H, W) u8 -> mid (nc, OH, W), fp32 or bf16.
extern "C" int lanczos_phase_stream_v(const void* x, void* mid, const void* wt, const void* rows,
                                      int nc, int H, int W, int OH, int d, int b0, int live,
                                      int rpc, int bf16_mid, void* stream) {
  if (d < 1 || rpc < 1 || H != OH * d) return (int)cudaErrorInvalidValue;
  StreamV g{H, W, OH, d, b0, live * d, rpc};
  g.vec_in = W % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  g.vec_mid = W % 4 == 0 && reinterpret_cast<uintptr_t>(mid) % 16 == 0;
  auto* xs = static_cast<const uint8_t*>(x);
  auto* ws = static_cast<const float*>(wt);
  auto* rs = static_cast<const int*>(rows);
  auto st = static_cast<cudaStream_t>(stream);
#define LANCZOS_STREAM_V(L)                                                  \
  (bf16_mid ? launch_stream_v<L, __nv_bfloat16>(xs, mid, ws, rs, nc, g, st) \
            : launch_stream_v<L, float>(xs, mid, ws, rs, nc, g, st))
  cudaError_t e;
  if (live == 6)
    e = LANCZOS_STREAM_V(6);
  else if (live == 4)
    e = LANCZOS_STREAM_V(4);
  else if (live == 8)
    e = LANCZOS_STREAM_V(8);
  else
    e = cudaErrorInvalidValue;
#undef LANCZOS_STREAM_V
  return (int)e;
}

// The horizontal pass over the streamed intermediate: mid (nc, OH, W) -> out (nc, OH, OW) u8.
extern "C" int lanczos_phase_stream_h(const void* mid, void* out, const void* tbl_h,
                                      const void* base_h, const void* ph_h, const void* cols,
                                      int nc, int W, int OH, int OW, int taps, int tc, int eh,
                                      int nh, int bf16_mid, void* stream) {
  if (tc < 1 || eh < taps) return (int)cudaErrorInvalidValue;
  const StreamH g{W, OH, OW, taps, tc, eh, nh, nh <= tc ? nh : tc};
  auto* os = static_cast<uint8_t*>(out);
  auto* th = static_cast<const float*>(tbl_h);
  auto* bh = static_cast<const int*>(base_h);
  auto* phh = static_cast<const int*>(ph_h);
  auto* cs = static_cast<const int*>(cols);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = bf16_mid
                            ? launch_stream_h<__nv_bfloat16>(mid, os, th, bh, phh, cs, nc, g, st)
                            : launch_stream_h<float>(mid, os, th, bh, phh, cs, nc, g, st);
  return (int)e;
}

// The window design.  templ: both axes are compile-time axes (zero alignment, support 3,
// the pair one of those below); else every plan takes the run-time instantiation.
extern "C" int lanczos_phase_window(const void* x, void* out, const void* tbl_v,
                                    const void* tbl_h, const void* rel_v, const void* rel_h,
                                    const void* rows, const void* cols, int nc, int H, int W,
                                    int OH, int OW, int nv, int dv, int sv, int f0v, int pv,
                                    int maxrel_v, int nh, int dh, int sh, int f0h, int ph,
                                    int maxrel_h, int templ, int round_mid, void* stream) {
  if (nv < 1 || nh < 1 || sv < 1 || sh < 1 || pv < 1 || ph < 1 || (nv * pv) % 2 ||
      (nh * ph) % 16)
    return (int)cudaErrorInvalidValue;
  WinShape g{H, W, OH, OW, nv, dv, sv, f0v, pv, maxrel_v, nh, dh, sh, f0h, ph, maxrel_h};
  g.ev = (pv - 1) * dv + maxrel_v + 2 * sv;
  g.mwid = ((ph - 1) * dh + maxrel_h + 2 * sh + 3) & ~3;
  g.mstr = g.mwid + 4;
  g.bwid = (g.mwid + 19 + 15) & ~15;
  g.chunk_lg = 0;
  while ((16 << g.chunk_lg) < g.bwid) ++g.chunk_lg;
  g.vec_in = W % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  g.vec_out = OW % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const WinArgs a{static_cast<const uint8_t*>(x),  static_cast<uint8_t*>(out),
                  static_cast<const float*>(tbl_v), static_cast<const float*>(tbl_h),
                  static_cast<const int*>(rel_v),   static_cast<const int*>(rel_h),
                  static_cast<const int*>(rows),    static_cast<const int*>(cols),
                  nc,                               static_cast<cudaStream_t>(stream)};
  if (!templ) return (int)launch_window_mid<AxisAny, AxisAny>(a, g, round_mid);
  using A11 = Axis<1, 1, 3>;
  using A21 = Axis<2, 1, 3>;
  using A32 = Axis<3, 2, 3>;
  using A43 = Axis<4, 3, 3>;
  const int key = ((nv * 16 + dv) << 8) | (nh * 16 + dh);
#define LANCZOS_PAIR(NV, DV, NH, DH) ((((NV) * 16 + (DV)) << 8) | ((NH) * 16 + (DH)))
  switch (key) {
    case LANCZOS_PAIR(3, 2, 3, 2): return (int)launch_window_mid<A32, A32>(a, g, round_mid);
    case LANCZOS_PAIR(4, 3, 4, 3): return (int)launch_window_mid<A43, A43>(a, g, round_mid);
    case LANCZOS_PAIR(1, 1, 4, 3): return (int)launch_window_mid<A11, A43>(a, g, round_mid);
    case LANCZOS_PAIR(1, 1, 3, 2): return (int)launch_window_mid<A11, A32>(a, g, round_mid);
    case LANCZOS_PAIR(2, 1, 3, 2): return (int)launch_window_mid<A21, A32>(a, g, round_mid);
    case LANCZOS_PAIR(4, 3, 1, 1): return (int)launch_window<A43, A11, false>(a, g);
    case LANCZOS_PAIR(3, 2, 1, 1): return (int)launch_window<A32, A11, false>(a, g);
    case LANCZOS_PAIR(3, 2, 2, 1): return (int)launch_window<A32, A21, false>(a, g);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LANCZOS_PAIR
}
