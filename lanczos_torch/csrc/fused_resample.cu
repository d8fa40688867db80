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
//   - the band is kept in shared memory as uint8, converted where the vertical pass
//     reads it; the output tile is staged in shared memory as uint8 and leaves in whole
//     16-byte chunks;
//   - no division in the loops that run per value: steps count up, offsets come from
//     the plan's tables (one division per 8x4 register tile splits its index);
//   - a tile's weights, window bases and central-tap offsets are copied into shared
//     memory beside its band, so one round trip to L2 or device memory covers everything
//     the tile reads (weights read from global memory where they are used miss L1 at
//     every window step of the vertical pass: every row tile has its own);
//   - bf16 keeps its meaning (weights rounded on the host, the intermediate rounded to
//     bf16 after the clamp and the quantize) but buys no arithmetic: its products are
//     the same fp32 FMAs, so it costs what fp32 costs.
//
// Each output tile (column block b, row tile i, plane p) takes the same four steps:
//   1. band[k][c] = x[p, starts_v[i] + k, cA + c], cA = starts_h[b] rounded down to 16
//      (zero past the image), with the tile's tables;
//   2. vertical pass, thread tile 8 band columns x 4 output rows (one group):
//        midT[j][r] = sum_s wv[i][s][r/4][r%4] * band[base_v[i][r/4] + s][j]
//      DERING: clamp to [min, max] of band[cv[i][0][r]][j], band[cv[i][1][r]][j];
//      QUANT: trunc(clip(., 0, 255)); bf16: round to bf16; store to shared memory;
//   3. horizontal pass, thread tile 8 output rows x 4 output columns (one group):
//        out[r][c] = sum_s midT[base_h[u][c/4] + s][r] * wh[u][s][c/4][c%4], u = uniq_h[b]
//      DERING: clamp to the stored midT[ch[u][0][c]][r], midT[ch[u][1][c]][r];
//   4. trunc(clip(., 0, 255)) into the staged tile, then the store, clipped at the
//      ragged bottom and right edges.
// Sums are fused multiply-adds in step order: the plain PyTorch version takes the same
// taps in the same order, each rounded once as fmaf rounds it (lanczos_torch/ops/_fma.py),
// and gives identical bytes.  Two kernels run those steps, with the same pass functions:
//
// fused_resample_kernel_ring, the pipelined kernel (wherever TMA can address the tensors):
// a persistent grid of up to three blocks an SM (as many as hold a ring of two stages
// each), each walking a run of the schedule (plane, column block, row tile), row tiles
// fastest, so that a block goes down one column strip.  One producer warpgroup (its
// registers cut to 24 by setmaxnreg) has one thread issue each tile's band as a TMA load
// (a 3-D tensor map over (planes, H, W): rows past H and columns past W arrive as zeros)
// and its tables as bulk copies, into a ring of up to four stages whose full and empty
// mbarriers it shares with two consumer warpgroups (their registers raised to 72).  The
// consumers run steps 2 and 3, synchronising among themselves on a named barrier, and
// stage the tile in quarters (rows 4k + q), each of which leaves as a TMA store through a
// tensor map of those rows, so the store drains while the next tile's passes run.  A
// quarter's rows are 128-byte swizzled where they are 128 bytes: the eight row groups a
// warp writes at once then fall on different banks.  A stage's horizontal tables are
// copied only when its column strip changes.  Where the time goes (tools/probe_kernels.py
// fused): the consumers' passes; the loads and the stores run under them.
//
// The ring's ILV form reads and writes interleaved frames (nc, H, W, C) -> (nc, OH, OW, C)
// as they lie, so the wrapper launches no layout copy: a tile is all C channels of its
// column block.  Its band arrives through a map over the frames' rows of W * C bytes; the
// vertical pass sums down byte columns and never asks which channel a byte holds; the
// horizontal pass reads pixel j's channel ch at intermediate column C * j + ch, a thread
// tile being four pixels of one channel (the same taps in the same order as the planar
// form); the staged quarters hold rows of cb * C interleaved bytes and leave through maps
// over (nc, OH, OW * C).  Its plan has blocks of its own width (cb * C at most 256 bytes,
// TMA's box limit, cb a multiple of 16 as for planes; resample_cuda.interleaved_block), with
// tables the same for every channel.
//
// fused_resample_kernel, one tile a block: a grid of (column block, row tile, plane),
// 256 threads, 64 registers so that four blocks share an SM.  All threads copy the band
// (16-byte cp.async chunks, or bytes where W or the pointer is not 16-byte aligned) and
// the tables, then run the passes between __syncthreads, then store the staged tile (16
// bytes a thread, or bytes on unaligned rows).  It takes the launches the ring cannot:
// W or OW not a multiple of 16, an unaligned pointer, a block width that is no multiple
// of 16, a box side over 256, or a ring of two stages that does not fit.
//
// Layouts (all row-major, contiguous; the wrapper checks them):
//   x      (nc, H, W) uint8                   out    (nc, OH, OW) uint8
//     (ILV: (nc, H, W, C) and (nc, OH, OW, C), bw and mw counted in bytes of C * kh)
//   wv     (num_tiles, win_v, tile_p/4, 4) f32   base_v (num_tiles, tile_p/4) int32
//   wh     (n_uniq, win_h, cb_p/4, 4) f32        base_h (n_uniq, cb_p/4) int32
//   starts_v (num_tiles,) int32               starts_h, uniq_h (n_cb,) int32
//   cv     (num_tiles, 2, tile_p) int32       ch     (n_uniq, 2, cb_p) int32  (DERING only)
// with tile_p = tile rounded up to 8 and cb_p = cb rounded up to 4, zero padded, and
// base + win inside the band for every group.

#include <cuda.h>  // CUtensorMap and its enums; the driver's encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads that run the passes, in either kernel
constexpr int kWarps = kThreads / 32;
constexpr int kProducers = 128;  // the ring kernel's producer warpgroup
constexpr int kRingThreads = kProducers + kThreads;
constexpr int kRingBlocks = 3;  // the most ring blocks an SM
constexpr int kMaxStages = 4;
constexpr int kStaged = 2;  // output tiles a block stages, each stored while the next is computed
constexpr int kRingSmem = 227 * 1024;

struct Geometry {
  int H, W, OH, OW, tile, tile_p, kv, cb, cb_p, kh, win_v, win_h;
  int bw;       // bytes of a band row in shared memory (a multiple of 16)
  int mw;       // columns of the intermediate in shared memory (a multiple of 8)
  int stage_w;  // bytes of a staged output row: 16 << stage_lg
  int nc, n_cb, num_tiles;
  int stage_lg, chunk_lg;  // log2 of 16-byte chunks per staged row, per band row (rounded up)
  int vec_in, vec_out;     // 16-byte paths allowed by W, OW and the pointers
  int nrg_v_lg, nrg_h_lg;  // log2 of tile_p / 4 and tile_p / 8 where powers of two, else -1
  int C;                   // channels of an interleaved frame (the ring's ILV form), else 1
};

// The ring kernel's shared memory, in bytes from a 1024-byte aligned base: the staged
// output (kStaged tiles of four quarters) at 0, then the ring's stages (a tile's band at 0
// of its stage, then its tables), the intermediate, the mbarriers and, for each stage,
// the unique block whose horizontal tables it holds.  resample_cuda.ring_layout is the
// same sum.
struct Ring {
  int stages, total;  // stages in the ring; tiles in the schedule
  int band_bytes, wv_bytes, wh_bytes, bv_bytes, bh_bytes, cv_bytes, ch_bytes;
  int wv_off, wh_off, bv_off, bh_off, cv_off, ch_off, stage_bytes;
  int quarter, ring_off, mid_off, bar_off, smem;
  int swizzle;  // quarters of 128-byte rows, in TMA's 128-byte swizzle
  int rw;       // bytes of a staged output row: cb, or cb * C interleaved
};

struct OutMaps {
  CUtensorMap q[4];  // output rows 4k + q of every plane
};

// the intermediate's rounding of two values: to bf16 (one cvt.rn.bf16x2.f32, each value rounded
// as __float2bfloat16_rn rounds it), or none
template <bool BF16>
__device__ __forceinline__ void round_mid2(float& a, float& b) {
  if (BF16) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    a = __low2float(h), b = __high2float(h);
  }
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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four floats to 16-byte aligned shared memory as one 16-byte store (st.shared.v4).  Written
// as a float4 store, ptxas split most of the vertical pass's stores into four 4-byte stores
// (its accumulators do not lie in aligned register quads), each four-way on the banks
__device__ __forceinline__ void st_shared_v4(float* p, float a, float b, float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(smem_u32(p)), "f"(a), "f"(b),
               "f"(c), "f"(d)
               : "memory");
}

// asynchronous copies global -> shared: 16 bytes through L1 (tables other blocks of the SM
// share), 16 bytes past L1 with src_bytes of 16 or 0 (0 fills with zeros), and 4 bytes
__device__ __forceinline__ void cp_async16_ca(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async16_cg(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// mbarriers, TMA and bulk copies (the ring kernel)
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until at most N committed groups of stores still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// this thread's shared-memory writes, visible to the TMA store that follows the barrier
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the consumer warpgroups alone (named barrier 1)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

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

// the one-tile kernel's staged tile: rows of stage_w bytes, chunks swizzled by row group
struct TileStage {
  uint8_t* p;
  int pitch, mask;
  // byte 4 cg of row r; rows r + 1 .. r + 3 (r a multiple of 4) lie pitch bytes apart
  __device__ __forceinline__ uint8_t* at(int r, int cg) const {
    return p + r * pitch + 16 * stage_chunk(r, cg >> 2, mask) + 4 * (cg & 3);
  }
};

// the ring kernel's staged tile: row r is row r >> 2 of quarter r & 3, each quarter as a
// TMA box of cb-byte rows lays it out (XOR of address bits 4-6 with 7-9 when swizzled)
struct QuarterStage {
  uint8_t* p;
  int pitch, cb, swizzle;
  __device__ __forceinline__ uint8_t* at(int r, int cg) const {
    int lin = (r >> 2) * cb + 4 * cg;
    if (swizzle) lin ^= (lin >> 3) & 0x70;
    return p + (r & 3) * pitch + lin;
  }
};

// the interleaved ring's staged tile: row r is row r >> 2 of quarter r & 3, rows of rw =
// cb * C bytes, pixel c's channel ch at byte C * c + ch.  With rw = 16 mod 32 the eight row
// groups of a warp's byte stores fall on eight disjoint runs of four banks
struct InterleavedStage {
  uint8_t* p;
  int pitch, rw, C;
};

// step 2 of one tile, by threads tid, tid + kThreads, ...: thread tile = 8 intermediate columns
// x one group of 4 tile rows, tile t = (t / (tile_p / 4), t % (tile_p / 4)) with bits 3 and 4 of
// t swapped where tile_p / 4 is a multiple of 16 (tests/test_torch_vertical_tiling.py), so that
// a half-warp takes 8 row groups of 2 column groups and not 16 of one: the rows of its band
// loads step about 2 band rows a group, 112 or 176 bytes a row, and fall on twice the banks;
// a quarter-warp's stores still write neighbouring 16-byte groups of one column
template <bool BF16, bool DERING, bool QUANT>
__device__ __forceinline__ void vertical_pass(int tid, const uint8_t* band, const float4* wv_s,
                                              const int* base_v_s, const int* cv_s,
                                              float* midT, int joff, const Geometry& g) {
  const int tile_p = g.tile_p, bw = g.bw, nrg_v = tile_p >> 2;
  const bool swap = (nrg_v & 15) == 0;
  const int n = (g.mw >> 3) * nrg_v;
  float acc[8][4];
  for (int t = tid; t < ((n + 31) & ~31); t += kThreads) {  // whole warps: the swap stays in one
    const int u = swap ? (t & ~24) | (t >> 1 & 8) | (t << 1 & 16) : t;
    if (u >= n) continue;
    int jg, rg;
    split(u, nrg_v, g.nrg_v_lg, jg, rg);
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
      }
      round_mid2<BF16>(v[0], v[1]);
      round_mid2<BF16>(v[2], v[3]);
      st_shared_v4(mcol + m * tile_p, v[0], v[1], v[2], v[3]);
    }
  }
}

// steps 3 and 4 (into the staged tile) of one tile.  ILV: the intermediate's columns are
// interleaved bytes, pixel j's channel ch at column C * j + ch (past dj), and a thread tile
// is four pixels of one channel, so that each midT load still feeds its four outputs
template <bool DERING, bool ILV, class Stage>
__device__ __forceinline__ void horizontal_pass(int tid, const float* midT, const float4* wh_s,
                                                const int* base_h_s, const int* ch_s, int dj,
                                                const Geometry& g, const Stage& stage) {
  const int tile_p = g.tile_p, ncg = g.cb_p >> 2;
  const int nrg = tile_p >> 3, half = tile_p >> 1;
  const int C = ILV ? g.C : 1, step = C * tile_p;  // midT floats from one pixel to the next
  float acc[8][4];
  // thread tile = rows {4 rg.., half + 4 rg..} x one group of 4 columns (of channel ch)
  for (int t = tid; t < ncg * C * nrg; t += kThreads) {
    int cg, rg;
    split(t, nrg, g.nrg_h_lg, cg, rg);
    const int ch = ILV ? cg % C : 0;
    if (ILV) cg /= C;
    const float* mrow = midT + (dj + ch) * tile_p + 4 * rg;
    const float* mp = mrow + base_h_s[cg] * step;
    const float4* wp = wh_s + cg;
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;
#pragma unroll 1
    for (int s = 0; s < g.win_h; ++s) {
      float a[8];
      load8_f32(mp + s * step, half, a);
      fma_tile(a, wp[s * ncg], acc);
    }
    if (DERING) {  // clamp to the stored midT rows of column 4 cg + n's central taps
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float lo[8], hi[8];
        load8_f32(mrow + ch_s[4 * cg + n] * step, half, lo);
        load8_f32(mrow + ch_s[g.cb_p + 4 * cg + n] * step, half, hi);
#pragma unroll
        for (int m = 0; m < 8; ++m) acc[m][n] = clamp_between(acc[m][n], lo[m], hi[m]);
      }
    }
    if constexpr (ILV) {  // the four pixels' bytes lie C apart
      uint8_t* s_lo = stage.p + rg * stage.rw + C * 4 * cg + ch;
      uint8_t* s_hi = s_lo + (half >> 2) * stage.rw;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const unsigned lo = quantize4(acc[m]), hi = quantize4(acc[m + 4]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s_lo[m * stage.pitch + e * C] = (uint8_t)(lo >> (8 * e));
          s_hi[m * stage.pitch + e * C] = (uint8_t)(hi >> (8 * e));
        }
      }
    } else {
      uint8_t* s_lo = stage.at(4 * rg, cg);
      uint8_t* s_hi = stage.at(half + 4 * rg, cg);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        *reinterpret_cast<unsigned*>(s_lo + m * stage.pitch) = quantize4(acc[m]);
        *reinterpret_cast<unsigned*>(s_hi + m * stage.pitch) = quantize4(acc[m + 4]);
      }
    }
  }
}

// (row tile, column block, plane) of schedule entry t: row tiles fastest
__device__ __forceinline__ void tile_of(int t, const Geometry& g, int& i, int& b, int& p) {
  const int strip = t / g.num_tiles;
  i = t - strip * g.num_tiles;
  p = strip / g.n_cb;
  b = strip - p * g.n_cb;
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
  vertical_pass<BF16, DERING, QUANT>(threadIdx.x, band, wv_s, base_v_s, cv_s, midT, c0 & 8, g);
  __syncthreads();
  const int mask = min(1 << g.stage_lg, 8) - 1;
  horizontal_pass<DERING, false>(threadIdx.x, midT, wh_s, base_h_s, ch_s, c0 & 7, g,
                                 TileStage{stage, g.stage_w, mask});
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

template <bool BF16, bool DERING, bool QUANT, bool ILV>
__global__ void __launch_bounds__(kRingThreads, kRingBlocks)
    fused_resample_kernel_ring(const __grid_constant__ CUtensorMap in_map,
                               const __grid_constant__ OutMaps out_maps,
                               const float4* __restrict__ wv, const float4* __restrict__ wh,
                               const int* __restrict__ base_v, const int* __restrict__ base_h,
                               const int* __restrict__ starts_v,
                               const int* __restrict__ starts_h,
                               const int* __restrict__ uniq_h, const int* __restrict__ cv,
                               const int* __restrict__ ch, Geometry g, Ring R) {
  extern __shared__ uint8_t ring_smem[];
  uint8_t* smem = ring_smem + ((1024 - (smem_u32(ring_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R.bar_off);  // (kMaxStages,)
  uint64_t* empty = full + kMaxStages;                              // (kMaxStages,)
  int* held = reinterpret_cast<int*>(empty + kMaxStages);           // (kMaxStages,)
  // this block's run of the schedule
  const int t0 = (int)((long long)blockIdx.x * R.total / gridDim.x);
  const int t1 = (int)((long long)(blockIdx.x + 1) * R.total / gridDim.x);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 1);
      held[s] = -1;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_async_shared();
  }
  __syncthreads();

  if (threadIdx.x < kProducers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      const int nrg_v = g.tile_p >> 2, ncg = g.cb_p >> 2;
      int s = 0, n = 0;  // the stage, and the times the ring has wrapped
      for (int t = t0; t < t1; ++t) {
        int i, b, p;
        tile_of(t, g, i, b, p);
        const int u = uniq_h[b];
        mbar_wait(empty + s, (n & 1) ^ 1);  // the consumers are done with its last tile
        uint8_t* st = smem + R.ring_off + s * R.stage_bytes;
        const bool new_h = held[s] != u;
        int bytes = R.band_bytes + R.wv_bytes + R.bv_bytes + R.cv_bytes;
        if (new_h) bytes += R.wh_bytes + R.bh_bytes + R.ch_bytes;
        mbar_expect_tx(full + s, bytes);
        tma_load_3d(st, &in_map, (ILV ? g.C * starts_h[b] : starts_h[b]) & ~15, starts_v[i], p,
                    full + s);
        bulk_load(st + R.wv_off, wv + (size_t)i * g.win_v * nrg_v, R.wv_bytes, full + s);
        bulk_load(st + R.bv_off, base_v + (size_t)i * nrg_v, R.bv_bytes, full + s);
        if (DERING) bulk_load(st + R.cv_off, cv + (size_t)i * 2 * g.tile_p, R.cv_bytes, full + s);
        if (new_h) {
          bulk_load(st + R.wh_off, wh + (size_t)u * g.win_h * ncg, R.wh_bytes, full + s);
          bulk_load(st + R.bh_off, base_h + (size_t)u * ncg, R.bh_bytes, full + s);
          if (DERING) bulk_load(st + R.ch_off, ch + (size_t)u * 2 * g.cb_p, R.ch_bytes, full + s);
          held[s] = u;
        }
        if (++s == R.stages) s = 0, ++n;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 72;\n");
    const int tid = threadIdx.x - kProducers;
    float* midT = reinterpret_cast<float*>(smem + R.mid_off);  // (mw, tile_p)
    int s = 0, n = 0;
    for (int t = t0; t < t1; ++t) {
      int i, b, p;
      tile_of(t, g, i, b, p);
      const int c0 = ILV ? g.C * starts_h[b] : starts_h[b];  // the band's first byte column
      const uint8_t* st = smem + R.ring_off + s * R.stage_bytes;
      uint8_t* staged = smem + (t - t0) % kStaged * 4 * R.quarter;  // in turn
      mbar_wait(full + s, n & 1);  // the tile's band and tables have landed
      vertical_pass<BF16, DERING, QUANT>(tid, st, reinterpret_cast<const float4*>(st + R.wv_off),
                                         reinterpret_cast<const int*>(st + R.bv_off),
                                         reinterpret_cast<const int*>(st + R.cv_off), midT,
                                         c0 & 8, g);
      if (tid == 0) bulk_wait_read<kStaged - 1>();  // the last store from this staging has read it
      consumer_sync();
      if constexpr (ILV)
        horizontal_pass<DERING, true>(tid, midT, reinterpret_cast<const float4*>(st + R.wh_off),
                                      reinterpret_cast<const int*>(st + R.bh_off),
                                      reinterpret_cast<const int*>(st + R.ch_off), c0 & 7, g,
                                      InterleavedStage{staged, R.quarter, R.rw, g.C});
      else
        horizontal_pass<DERING, false>(tid, midT, reinterpret_cast<const float4*>(st + R.wh_off),
                                       reinterpret_cast<const int*>(st + R.bh_off),
                                       reinterpret_cast<const int*>(st + R.ch_off), c0 & 7, g,
                                       QuarterStage{staged, R.quarter, g.cb, R.swizzle});
      fence_async_shared();
      consumer_sync();
      if (tid == 0) {
        mbar_arrive(empty + s);
        for (int q = 0; q < 4; ++q)
          tma_store_3d(&out_maps.q[q], staged + q * R.quarter, b * R.rw, i * (g.tile >> 2), p);
        bulk_commit();
      }
      if (++s == R.stages) s = 0, ++n;
    }
    if (tid == 0) bulk_wait_all();
  }
}

template <bool BF16, bool DERING, bool QUANT>
cudaError_t launch(const uint8_t* x, uint8_t* out, const void* wv, const void* wh,
                   const int* base_v, const int* base_h, const int* starts_v,
                   const int* starts_h, const int* uniq_h, const int* cv, const int* ch,
                   const Geometry& g, cudaStream_t stream) {
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
  const dim3 grid(g.n_cb, g.num_tiles, g.nc);
  kernel<<<grid, kThreads, smem, stream>>>(x, out, static_cast<const float4*>(wv),
                                           static_cast<const float4*>(wh), base_v, base_h,
                                           starts_v, starts_h, uniq_h, cv, ch, g);
  return cudaGetLastError();
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

Ring ring_layout(const Geometry& g, bool dering, int stages) {
  Ring R{};
  R.stages = stages;
  R.total = g.nc * g.n_cb * g.num_tiles;
  R.band_bytes = g.kv * g.bw;
  R.wv_bytes = 4 * g.win_v * g.tile_p;
  R.wh_bytes = 4 * g.win_h * g.cb_p;
  R.bv_bytes = g.tile_p;
  R.bh_bytes = g.cb_p;
  R.cv_bytes = dering ? 8 * g.tile_p : 0;
  R.ch_bytes = dering ? 8 * g.cb_p : 0;
  R.wv_off = R.band_bytes;
  R.wh_off = R.wv_off + R.wv_bytes;
  R.bv_off = R.wh_off + R.wh_bytes;
  R.bh_off = R.bv_off + R.bv_bytes;
  R.cv_off = R.bh_off + R.bh_bytes;
  R.ch_off = R.cv_off + R.cv_bytes;
  R.stage_bytes = round_up(R.ch_off + R.ch_bytes, 128);
  // quarters 1024-byte aligned for the swizzle, interleaved ones (never swizzled) to 128
  R.rw = g.cb * g.C;
  R.quarter = round_up(g.tile_p / 4 * R.rw, g.C > 1 ? 128 : 1024);
  R.ring_off = 4 * kStaged * R.quarter;
  R.mid_off = R.ring_off + stages * R.stage_bytes;
  R.bar_off = R.mid_off + 4 * g.mw * g.tile_p;
  R.smem = 1024 + R.bar_off + kMaxStages * (2 * 8 + 4);
  R.swizzle = R.rw == 128 && g.C == 1;
  return R;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, so the library links no libcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                : nullptr;
  }();
  return fn;
}

// a 3-D uint8 map (planes, rows, columns) with a box of rows x cols of one plane
bool encode_u8(CUtensorMap* map, const void* base, int cols, int rows, int planes,
               uint64_t row_stride, uint64_t plane_stride, int box_cols, int box_rows,
               bool swizzle) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {row_stride, plane_stride};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims, strides, box,
             steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// multiprocessors of the current device, read once a device
int multiprocessors() {
  static int count[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (count[dev] == 0) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

template <bool BF16, bool DERING, bool QUANT, bool ILV>
cudaError_t launch_ring(const uint8_t* x, uint8_t* out, const void* wv, const void* wh,
                        const int* base_v, const int* base_h, const int* starts_v,
                        const int* starts_h, const int* uniq_h, const int* cv, const int* ch,
                        const Geometry& g, const Ring& R, int blocks, cudaStream_t stream) {
  // rows of bytes: W (OW) a plane's row, or W * C (OW * C) an interleaved frame's
  const int row = g.W * g.C, orow = g.OW * g.C;
  CUtensorMap in_map;
  OutMaps out_maps;
  if (!encode_u8(&in_map, x, row, g.H, g.nc, (uint64_t)row, (uint64_t)g.H * row, g.bw, g.kv,
                 false))
    return cudaErrorInvalidValue;
  for (int q = 0; q < 4; ++q)
    if (!encode_u8(&out_maps.q[q], out + (size_t)q * orow, orow, (g.OH - q + 3) / 4, g.nc,
                   4ull * orow, (uint64_t)g.OH * orow, R.rw, g.tile / 4, R.swizzle))
      return cudaErrorInvalidValue;
  auto* kernel = fused_resample_kernel_ring<BF16, DERING, QUANT, ILV>;
  // the attributes once a device and size (each setting is a driver call the launch waits on)
  static int allowed[64];  // per device: the shared memory the kernel may take, 0 before any
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) dev = -1;
  if (dev < 0 || allowed[dev] != R.smem) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R.smem);
    if (e == cudaSuccess)  // all of the SM's 228 KB to shared memory, so that `blocks` fit
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    if (dev >= 0) allowed[dev] = R.smem;
  }
  const int grid = min(R.total, blocks * multiprocessors());
  if (grid < 1) return cudaErrorInvalidValue;
  kernel<<<grid, kRingThreads, R.smem, stream>>>(
      in_map, out_maps, static_cast<const float4*>(wv), static_cast<const float4*>(wh), base_v,
      base_h, starts_v, starts_h, uniq_h, cv, ch, g, R);
  return cudaGetLastError();
}

int ceil_log2(int v) {
  int lg = 0;
  while ((1 << lg) < v) ++lg;
  return lg;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// stages > 0 runs the ring kernel with that many stages and `blocks` blocks an SM (the
// wrapper's resample_cuda.ring_shape chooses both), 0 the one-tile-a-block kernel.
// channels > 1 (the ring only): x is (nc, H, W, channels) and out (nc, OH, OW, channels),
// interleaved, each tile all channels of its column block, on a plan of its own block width
// (resample_cuda.interleaved_block)
extern "C" int lanczos_fused_resample(const void* x, void* out, const void* wv, const void* wh,
                                      const void* base_v, const void* base_h,
                                      const void* starts_v, const void* starts_h,
                                      const void* uniq_h, const void* cv, const void* ch,
                                      int nc, int H, int W, int OH, int OW, int tile,
                                      int tile_p, int kv, int cb, int cb_p, int kh, int win_v,
                                      int win_h, int bw, int mw, int stage_w, int n_cb,
                                      int num_tiles, int bf16, int dering, int quant,
                                      int channels, int stages, int blocks, void* stream) {
  const int C = channels > 1 ? channels : 1;
  if (tile_p % 8 || cb_p % 4 || bw % 16 || mw % 8 || bw < mw + 8 || mw < C * kh + 7 ||
      stage_w != 16 << ceil_log2(stage_w / 16) || stage_w < cb_p || (C > 1 && stages < 1))
    return (int)cudaErrorInvalidValue;
  Geometry g{H, W, OH, OW, tile, tile_p, kv, cb, cb_p, kh, win_v, win_h, bw, mw, stage_w,
             nc, n_cb, num_tiles};
  g.C = C;
  g.stage_lg = ceil_log2(stage_w / 16);
  g.chunk_lg = ceil_log2(bw / 16);
  g.vec_in = W % 16 == 0 && aligned16(x);
  g.vec_out = OW % 16 == 0 && aligned16(out);
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
  cudaError_t e;
#define LANCZOS_SWITCH(CALL)                                   \
  switch ((bf16 ? 4 : 0) | (dering ? 2 : 0) | (quant ? 1 : 0)) { \
    case 0: e = CALL(false, false, false); break;              \
    case 1: e = CALL(false, false, true); break;               \
    case 2: e = CALL(false, true, false); break;               \
    case 3: e = CALL(false, true, true); break;                \
    case 4: e = CALL(true, false, false); break;               \
    case 5: e = CALL(true, false, true); break;                \
    case 6: e = CALL(true, true, false); break;                \
    default: e = CALL(true, true, true); break;                \
  }
  if (stages > 0) {
    // what TMA and the ring need (resample_cuda.ring_shape asks the same of a launch)
    const Ring R = ring_layout(g, dering != 0, stages);
    if (stages > kMaxStages || blocks < 1 || blocks > kRingBlocks || W * C % 16 ||
        OW * C % 16 || cb % 16 || R.rw > 256 || tile % 4 || tile_p % 16 || bw > 256 ||
        kv > 256 || OH < 4 ||
        !aligned16(x) || !aligned16(out) || !aligned16(wv) || !aligned16(wh) ||
        !aligned16(base_v) || !aligned16(base_h) || (dering && (!aligned16(cv) || !aligned16(ch))) ||
        R.smem > kRingSmem)
      return (int)cudaErrorInvalidValue;
#define LANCZOS_RING(B, D, Q) \
  launch_ring<B, D, Q, false>(xs, os, wv, wh, bv, bh, sv, sh, uh, cvs, chs, g, R, blocks, st)
#define LANCZOS_RING_ILV(B, D, Q) \
  launch_ring<B, D, Q, true>(xs, os, wv, wh, bv, bh, sv, sh, uh, cvs, chs, g, R, blocks, st)
    if (C > 1) {
      LANCZOS_SWITCH(LANCZOS_RING_ILV)
    } else {
      LANCZOS_SWITCH(LANCZOS_RING)
    }
#undef LANCZOS_RING_ILV
#undef LANCZOS_RING
  } else {
#define LANCZOS_LAUNCH(B, D, Q) \
  launch<B, D, Q>(xs, os, wv, wh, bv, bh, sv, sh, uh, cvs, chs, g, st)
    LANCZOS_SWITCH(LANCZOS_LAUNCH)
#undef LANCZOS_LAUNCH
  }
#undef LANCZOS_SWITCH
  return (int)e;
}

extern "C" const char* lanczos_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
