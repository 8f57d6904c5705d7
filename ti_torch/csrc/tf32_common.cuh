// Tensor-core building blocks of the hand-written f32 kernels in
// split-precision TF32 ("3xTF32": pair_layer_tf32x3.cu, kernel B1,
// pair_tangent_tf32x3.cu, kernel B3, fused_edge_mlp_tf32x3.cu, kernel B4,
// fused_edge_mlp_jvp_tf32x3.cu, kernel B5, and div_kernel_tf32x3.cu, kernel
// B7): the swizzled f32 shared-memory tile, the mma.sync TF32 wrapper, the
// 3xTF32 product of a warp's 32 x 32 block over the weights as
// ops/pair_layer_kernel.pack_tf32_weights packs them (A split by rounding,
// or by truncation in B4 and B5), the staging of row tiles by cp.async,
// its epilogues, LayerNorm -> SiLU on the rows of a 64-row tile, and for the
// tangent kernels the same keeping its pre-LN rows and statistics, and its
// tangent replayed at them. The LayerNorms here take F = 128 (a warp a row),
// and F = 256 in ln_silu_wide (a warp a row, 8 columns a lane); the kernels
// hold their other F = 64 and F = 256 forms (half_sum: a half-warp a row).
#pragma once

#include "pair_common.cuh"

namespace pk {
namespace tf32x3 {

constexpr int TR = 64;       // pair rows of a CTA's tile
constexpr int LDX = 2 * F;   // row stride of X = [s_j | e_ij]
constexpr int FN = F / 8;    // n-tiles of an F-wide product

// element offset of (row, col) in a swizzled f32 tile of row stride ld:
// 16-byte chunk c of row r lives at chunk c ^ 2 (r & 3), so the 8-byte
// fragment accesses of a half-warp (4 rows x 2 chunks) and a row's 16-byte
// accesses fall on 32 distinct banks
__device__ __forceinline__ int swz(int row, int col, int ld) {
  return row * ld + ((((col >> 2) ^ ((row & 3) << 1)) << 2) | (col & 3));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// c += a (16 x 8, row) * b (8 x 8, col), TF32 operands, f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's accumulators: acc[rt][p][c] is the element at row
// row0 + 16 rt + g + 8 (c / 2), column 8 p + 2 t + (c % 2) of its 32 x 32 block
using Acc = float[2][4][4];

__device__ __forceinline__ void acc_zero(Acc& acc) {
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[rt][p][c] = 0.f;
}

// acc += A[row0 .. row0 + 31][0 .. 8 KS) * W[:, n-tiles nt0 .. nt0 + 3] in
// 3xTF32 (KS even). A is a swizzled f32 tile of row stride lda; W is one
// packed matrix of NTM n-tiles a k-step: the uint4 at ((ks * NTM + nt) * 32 +
// lane) holds this thread's (b0, b1) hi and lo of n-tile nt at k-step ks.
// Two k-steps at a time: their weight fragments load first; per row tile the
// six products of each n-tile go into a fresh accumulator, which is then
// added to acc in f32. The tensor core truncates its sums: with all 96 mma of
// a K = 256 product into acc, the kernel erred at 2.1e-6 of max |plain| a
// layer (f32 FMA: 4.8e-7) and the trajectory of the exact slice left its bar
// of rtol 1e-4 / atol 1e-5; this way 5.7e-7.
// This thread's weight fragments of k-steps ks, ks + 1 for n-tiles nt0 ..
// nt0 + 3 of a packed matrix of NTM n-tiles a k-step (wp already at nt0 and
// the lane).
template <int NTM>
__device__ __forceinline__ void load_b2(uint4 (&b)[2][4], const uint4* __restrict__ wp, int ks) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t kw = ks + h;
#pragma unroll
    for (int p = 0; p < 4; ++p) b[h][p] = __ldg(wp + (kw * NTM + p) * 32);
  }
}

// acc += the products of k-steps ks, ks + 1 (weight fragments b) for the
// warp's two row tiles, each row tile's into a fresh accumulator (see mma3)
__device__ __forceinline__ void mma3_pair(Acc& acc, const float* A, int lda, int row0, int ks,
                                          const uint4 (&b)[2][4]) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int rt = 0; rt < 2; ++rt) {
    const int r = row0 + 16 * rt + g;
    float z[4][4] = {};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 8 * (ks + h) + 2 * t;
      const float2 u = *reinterpret_cast<const float2*>(A + swz(r, k, lda));
      const float2 w = *reinterpret_cast<const float2*>(A + swz(r + 8, k, lda));
      const float a[4] = {u.x, w.x, u.y, w.y};  // (g, k), (g + 8, k), (g, k + 4), (g + 8, k + 4)
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        hi[c] = to_tf32(a[c]);
        lo[c] = to_tf32(a[c] - __uint_as_float(hi[c]));
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        mma_tf32(z[p], lo, b[h][p].x, b[h][p].y);  // a_lo b_hi
        mma_tf32(z[p], hi, b[h][p].z, b[h][p].w);  // a_hi b_lo
        mma_tf32(z[p], hi, b[h][p].x, b[h][p].y);  // a_hi b_hi
      }
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[rt][p][c] += z[p][c];
  }
}

// acc += A[row0 .. row0 + 31][0 .. 8 KS) * W[:, n-tiles nt0 .. nt0 + 3] in
// 3xTF32 (KS even). A is a swizzled f32 tile of row stride lda; W is one
// packed matrix of NTM n-tiles a k-step: the uint4 at ((ks * NTM + nt) * 32 +
// lane) holds this thread's (b0, b1) hi and lo of n-tile nt at k-step ks.
// Two k-steps at a time: their weight fragments load first; per row tile the
// six products of each n-tile go into a fresh accumulator, which is then
// added to acc in f32. The tensor core truncates its sums: with all 96 mma of
// a K = 256 product into acc, the kernel erred at 2.1e-6 of max |plain| a
// layer (f32 FMA: 4.8e-7) and the trajectory of the exact slice left its bar
// of rtol 1e-4 / atol 1e-5; this way 5.7e-7.
template <int KS, int NTM>
__device__ __forceinline__ void mma3(Acc& acc, const float* A, int lda, int row0,
                                     const uint4* __restrict__ W, int nt0) {
  const uint4* wp = W + (size_t)nt0 * 32 + lane_id();
#pragma unroll 1
  for (int ks = 0; ks < KS; ks += 2) {
    uint4 b[2][4];
    load_b2<NTM>(b, wp, ks);
    mma3_pair(acc, A, lda, row0, ks, b);
  }
}

// mma3 with the weight fragments of the next two k-steps loaded before the
// products of these two, so their trip from L2 overlaps the products; the
// same sums in the same order. It takes 32 more registers: B3 (one CTA an
// SM) has them, B1 (two CTAs an SM at the 128-register cap) does not.
template <int KS, int NTM>
__device__ __forceinline__ void mma3_ahead(Acc& acc, const float* A, int lda, int row0,
                                           const uint4* __restrict__ W, int nt0) {
  const uint4* wp = W + (size_t)nt0 * 32 + lane_id();
  uint4 b[2][4];
  load_b2<NTM>(b, wp, 0);
#pragma unroll 1
  for (int ks = 0; ks < KS; ks += 2) {
    uint4 nb[2][4];
    load_b2<NTM>(nb, wp, ks + 2 < KS ? ks + 2 : ks);
    mma3_pair(acc, A, lda, row0, ks, b);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int p = 0; p < 4; ++p) b[h][p] = nb[h][p];
  }
}

// acc += the products of k-steps ks, ks + 1 for the warp's two row tiles, as
// mma3_pair, with A split by truncation: hi is a with its low 13 bits
// cleared (a TF32 value), lo = a - hi (exact in f32; the tensor core reads
// its top bits), so |a - hi - lo_tf32| <= 2^-21 |a|
__device__ __forceinline__ void mma3t_pair(Acc& acc, const float* A, int lda, int row0, int ks,
                                           const uint4 (&b)[2][4]) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int rt = 0; rt < 2; ++rt) {
    const int r = row0 + 16 * rt + g;
    float z[4][4] = {};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 8 * (ks + h) + 2 * t;
      const float2 u = *reinterpret_cast<const float2*>(A + swz(r, k, lda));
      const float2 w = *reinterpret_cast<const float2*>(A + swz(r + 8, k, lda));
      const float a[4] = {u.x, w.x, u.y, w.y};  // (g, k), (g + 8, k), (g, k + 4), (g + 8, k + 4)
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        hi[c] = __float_as_uint(a[c]) & 0xffffe000u;
        lo[c] = __float_as_uint(a[c] - __uint_as_float(hi[c]));
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        mma_tf32(z[p], lo, b[h][p].x, b[h][p].y);  // a_lo b_hi
        mma_tf32(z[p], hi, b[h][p].z, b[h][p].w);  // a_hi b_lo
        mma_tf32(z[p], hi, b[h][p].x, b[h][p].y);  // a_hi b_hi
      }
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[rt][p][c] += z[p][c];
  }
}

// acc += A[row0 .. row0 + 31][0 .. 8 KS) * W[:, n-tiles nt0 .. nt0 + 3] with
// the truncation split of mma3t_pair: as mma3_ahead (the next two k-steps'
// weight fragments loaded first) where AHEAD, else as mma3 (32 registers
// fewer)
template <int KS, int NTM, bool AHEAD = true>
__device__ __forceinline__ void mma3t(Acc& acc, const float* A, int lda, int row0,
                                      const uint4* __restrict__ W, int nt0) {
  const uint4* wp = W + (size_t)nt0 * 32 + lane_id();
  uint4 b[2][4];
  if constexpr (AHEAD) load_b2<NTM>(b, wp, 0);
#pragma unroll 1
  for (int ks = 0; ks < KS; ks += 2) {
    if constexpr (AHEAD) {
      uint4 nb[2][4];
      load_b2<NTM>(nb, wp, ks + 2 < KS ? ks + 2 : ks);
      mma3t_pair(acc, A, lda, row0, ks, b);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int p = 0; p < 4; ++p) b[h][p] = nb[h][p];
    } else {
      load_b2<NTM>(b, wp, ks);
      mma3t_pair(acc, A, lda, row0, ks, b);
    }
  }
}

// rows r0 .. r0 + ROWS - 1 of a (rows x W) matrix into a swizzled ROWS-row
// tile of row stride ld by cp.async, zero from row nrows on (no commit, no wait)
template <int ROWS = TR>
__device__ __forceinline__ void stage_rows(float* T, int ld, const float* __restrict__ src, int W,
                                           size_t r0, int nrows) {
  const int w4 = W / 4;
  for (int idx = threadIdx.x; idx < ROWS * w4; idx += NT) {
    const int r = idx / w4, f = 4 * (idx % w4);
    float* d = T + swz(r, f, ld);
    if (r < nrows)
      cp_async16(d, src + (r0 + r) * W + f);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// acc + bias into the warp's block of a swizzled tile (bias indexed by the
// tile's column)
__device__ __forceinline__ void acc_store(float* T, int ld, int row0, int col0, const Acc& acc,
                                          const float* __restrict__ bias) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int col = col0 + 8 * p + 2 * t;
    const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 16 * rt + g + 8 * h;
        *reinterpret_cast<float2*>(T + swz(r, col, ld)) =
            make_float2(acc[rt][p][2 * h] + bb.x, acc[rt][p][2 * h + 1] + bb.y);
      }
  }
}

// acc into the warp's block of a swizzled tile (a tangent product: no bias)
__device__ __forceinline__ void acc_put(float* T, int ld, int row0, int col0, const Acc& acc) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(T + swz(row0 + 16 * rt + g + 8 * h, col0 + 8 * p + 2 * t, ld)) =
            make_float2(acc[rt][p][2 * h], acc[rt][p][2 * h + 1]);
}

// h = p * (acc + bias) * mask, in place over p in the warp's block of T
// (the same thread stored p there)
__device__ __forceinline__ void acc_gate(float* T, int row0, int col0, const Acc& acc,
                                         const float* __restrict__ bias, const float* mask) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int col = col0 + 8 * p + 2 * t;
    const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 16 * rt + g + 8 * h;
        float2* at = reinterpret_cast<float2*>(T + swz(r, col, F));
        const float2 pv = *at;
        const float m = mask[r];
        *at = make_float2(pv.x * (acc[rt][p][2 * h] + bb.x) * m,
                          pv.y * (acc[rt][p][2 * h + 1] + bb.y) * m);
      }
  }
}

// the sum over the 16 lanes of the thread's half-warp (at F = 64 a half-warp
// holds a row, 4 columns a lane)
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// LayerNorm (f32 statistics, eps 1e-5) -> SiLU in place on a swizzled
// TR x F tile: warp w takes rows 8w .. 8w + 7, lane l columns 4l .. 4l + 3
__device__ __forceinline__ void ln_silu_rows(float* T, int ld, const float* __restrict__ scale,
                                             const float* __restrict__ bias) {
  const int lane = lane_id(), w = warp_id();
  const float4 sc = __ldg(reinterpret_cast<const float4*>(scale + 4 * lane));
  const float4 bi = __ldg(reinterpret_cast<const float4*>(bias + 4 * lane));
#pragma unroll 1
  for (int rr = 0; rr < TR / NW; ++rr) {
    float4* at = reinterpret_cast<float4*>(T + swz(8 * w + rr, 4 * lane, ld));
    const float4 v = *at;
    const float mu = warp_sum(v.x + v.y + v.z + v.w) * (1.f / F);
    const float d0 = v.x - mu, d1 = v.y - mu, d2 = v.z - mu, d3 = v.w - mu;
    const float rstd = 1.f / sqrtf(warp_sum(d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3) * (1.f / F) + 1e-5f);
    *at = make_float4(silu(d0 * rstd * sc.x + bi.x), silu(d1 * rstd * sc.y + bi.y),
                      silu(d2 * rstd * sc.z + bi.z), silu(d3 * rstd * sc.w + bi.w));
  }
}

// LayerNorm (f32 statistics, eps 1e-5) -> SiLU in place on rows RW w .. RW w +
// RW - 1 of a swizzled tile F (a multiple of 128) wide, for warp w: lane l takes
// the columns 128 c + 4 l .. + 3 of each 128-wide chunk c, read from the tile
// once for the mean, once for the variance and once to write (holding a row's
// 8 values at F = 256 across the two reductions spilled registers in B1)
template <int RW>
__device__ __forceinline__ void ln_silu_wide(float* T, int ld, int w, const float* __restrict__ scale,
                                             const float* __restrict__ bias) {
  constexpr int CH = F / 128;
  const int lane = lane_id();
#pragma unroll 1
  for (int rr = 0; rr < RW; ++rr) {
    const int r = RW * w + rr;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(T + swz(r, 128 * c + 4 * lane, ld));
      sum += v.x + v.y + v.z + v.w;
    }
    const float mu = warp_sum(sum) * (1.f / F);
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(T + swz(r, 128 * c + 4 * lane, ld));
      const float d0 = v.x - mu, d1 = v.y - mu, d2 = v.z - mu, d3 = v.w - mu;
      sq += d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3;
    }
    const float rstd = 1.f / sqrtf(warp_sum(sq) * (1.f / F) + 1e-5f);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      float4* at = reinterpret_cast<float4*>(T + swz(r, 128 * c + 4 * lane, ld));
      const float4 v = *at;
      const float4 sc = __ldg(reinterpret_cast<const float4*>(scale + 128 * c + 4 * lane));
      const float4 bi = __ldg(reinterpret_cast<const float4*>(bias + 128 * c + 4 * lane));
      *at = make_float4(silu((v.x - mu) * rstd * sc.x + bi.x), silu((v.y - mu) * rstd * sc.y + bi.y),
                        silu((v.z - mu) * rstd * sc.z + bi.z), silu((v.w - mu) * rstd * sc.w + bi.w));
    }
  }
}

// LayerNorm (f32 statistics, eps 1e-5) -> SiLU in place on the rows below
// nrows of a swizzled tile, as ln_silu_rows; each row's pre-LN values go to
// H (a residual tile) and its mean and 1/std to stat[r], stat[R + r]
__device__ __forceinline__ void ln_silu_keep(float* T, int ld, float* H, float* stat, int nrows,
                                             const float* __restrict__ scale,
                                             const float* __restrict__ bias) {
  const int lane = lane_id(), w = warp_id();
  const float4 sc = __ldg(reinterpret_cast<const float4*>(scale + 4 * lane));
  const float4 bi = __ldg(reinterpret_cast<const float4*>(bias + 4 * lane));
#pragma unroll 1
  for (int rr = 0; rr < TR / NW; ++rr) {
    const int r = 8 * w + rr;
    if (r >= nrows) break;
    float4* at = reinterpret_cast<float4*>(T + swz(r, 4 * lane, ld));
    const float4 v = *at;
    *reinterpret_cast<float4*>(H + swz(r, 4 * lane, F)) = v;
    const float mu = warp_sum(v.x + v.y + v.z + v.w) * (1.f / F);
    const float d0 = v.x - mu, d1 = v.y - mu, d2 = v.z - mu, d3 = v.w - mu;
    const float rstd = 1.f / sqrtf(warp_sum(d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3) * (1.f / F) + 1e-5f);
    if (lane == 0) {
      stat[r] = mu;
      stat[R + r] = rstd;
    }
    *at = make_float4(silu(d0 * rstd * sc.x + bi.x), silu(d1 * rstd * sc.y + bi.y),
                      silu(d2 * rstd * sc.z + bi.z), silu(d3 * rstd * sc.w + bi.w));
  }
}

// Tangent of LayerNorm -> SiLU in place on a swizzled TR-row tile: row r is
// replayed at the pre-LN primal H[rowj[r]] and its statistics; padding rows
// (rowj < 0) become zero. Warp w takes rows 8w .. 8w + 7, lane l columns
// 4l .. 4l + 3.
__device__ __forceinline__ void ln_silu_tan_rows(float* T, int ld, const float* H,
                                                 const float* stat, const int* rowj,
                                                 const float* __restrict__ scale,
                                                 const float* __restrict__ bias) {
  const int lane = lane_id(), w = warp_id();
  const float4 s4 = __ldg(reinterpret_cast<const float4*>(scale + 4 * lane));
  const float4 b4 = __ldg(reinterpret_cast<const float4*>(bias + 4 * lane));
  const float sc[4] = {s4.x, s4.y, s4.z, s4.w}, bi[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll 2
  for (int rr = 0; rr < TR / NW; ++rr) {
    const int r = 8 * w + rr, j = rowj[r];
    float4* at = reinterpret_cast<float4*>(T + swz(r, 4 * lane, ld));
    if (j < 0) {
      *at = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const float4 d4 = *at, h4 = *reinterpret_cast<const float4*>(H + swz(j, 4 * lane, F));
    const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
    const float mu = stat[j], rstd = stat[R + j];
    const float cen[4] = {h4.x - mu, h4.y - mu, h4.z - mu, h4.w - mu};
    float cd = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) cd += cen[c] * dv[c];
    const float dmu = warp_sum(dv[0] + dv[1] + dv[2] + dv[3]) * (1.f / F);
    const float dvar = 2.f * (warp_sum(cd) * (1.f / F));
    const float drstd = -0.5f * rstd * rstd * rstd * dvar;
    float o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float dl = ((dv[c] - dmu) * rstd + cen[c] * drstd) * sc[c];
      const float l = cen[c] * rstd * sc[c] + bi[c];
      const float sig = 1.f / (1.f + expf(-l));
      o[c] = sig * (1.f + l * (1.f - sig)) * dl;
    }
    *at = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// a packed matrix: it starts at twice its offset of the row-major buffer
__device__ __forceinline__ const uint4* wmat(const float* wpk, size_t off) {
  return reinterpret_cast<const uint4*>(wpk + 2 * off);
}

}  // namespace tf32x3
}  // namespace pk
