// Tensor-core building blocks of the hand-written bf16 kernels
// (pair_tangent_mma.cu, pair_layer_mma.cu): the swizzled shared-memory tile,
// ldmatrix and mma.sync wrappers, the weight fragments read in the packed
// order of ops/pair_layer_kernel.pack_mma_weights, and LayerNorm and its
// tangent in the accumulator fragment's thread layout.
//
// One warp owns 16 rows of a product and NTL n-tiles of 8 columns. With
// g = lane / 4 and t = lane % 4, accumulator acc[nt][c] is the element at
//   row  row0 + g + 8 * (c / 2),   column 8 * nt + 2 * t + (c % 2)
// (the C fragment of mma.m16n8k16). A full row of F = 128 columns sits in the
// four threads of a quad, so a row statistic is a thread-local sum and two
// shuffles. Between two products the activations live in shared memory as
// bf16 (the products round there anyway), and each thread keeps working on
// the elements its fragment gave it.
//
// Shared-memory tiles are bf16, row-major with a row stride ld of F or 2F
// values, and swizzled in 16-byte chunks: chunk c of row r lives at chunk
// c ^ (r & 7). ldmatrix's eight row addresses and the fragment's 4-byte
// accesses then fall on 32 distinct banks.
#pragma once

#include "pair_common.cuh"

namespace pk {

constexpr int FT = F / 8;    // n-tiles (8 columns) across the feature width
constexpr int FP = F / 16;   // n-tile pairs: one 16-byte weight load per thread
constexpr unsigned FULL = 0xffffffffu;

// element offset of (row, col) in a swizzled tile of row stride ld
__device__ __forceinline__ int swz(int row, int col, int ld) {
  return row * ld + ((((col >> 3) ^ (row & 7)) << 3) | (col & 7));
}

// Arithmetic on pairs of bf16 values: one instruction rounds both results
// once to bf16 (a product of two bf16 values is exact in f32, so mul2 is
// the f32 product rounded once). The _rn forms are never contracted into an
// fma, so every rounding site stays where the plain version has it.
using bf162 = __nv_bfloat162;
__device__ __forceinline__ bf162 as_bf162(uint32_t u) {
  bf162 v;
  *reinterpret_cast<uint32_t*>(&v) = u;
  return v;
}
__device__ __forceinline__ bf162 mul2(bf162 a, bf162 b) { return __hmul2_rn(a, b); }
__device__ __forceinline__ bf162 add2(bf162 a, bf162 b) { return __hadd2_rn(a, b); }
__device__ __forceinline__ bf162 round2(float lo, float hi) { return __floats2bfloat162_rn(lo, hi); }
__device__ __forceinline__ bf162 both2(float v) { return __float2bfloat162_rn(v); }
__device__ __forceinline__ float2 f2(bf162 v) { return __bfloat1622float2(v); }
// two neighbouring bf16 values (col even) of a swizzled tile
__device__ __forceinline__ bf162 lds_b2(const bf16* tile, int row, int col, int ld) {
  return *reinterpret_cast<const bf162*>(tile + swz(row, col, ld));
}
__device__ __forceinline__ void sts_b2(bf16* tile, int row, int col, int ld, bf162 v) {
  *reinterpret_cast<bf162*>(tile + swz(row, col, ld)) = v;
}
__device__ __forceinline__ bf162 ldg_b2(const bf16* p) {
  return as_bf162(__ldg(reinterpret_cast<const uint32_t*>(p)));
}

// A fragment (16 rows x 16 k) of a swizzled tile: rows row0.., columns k0..
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16* tile, int ld, int row0,
                                       int k0) {
  const int lane = lane_id();
  const bf16* p = tile + swz(row0 + (lane & 15), k0 + ((lane >> 4) << 3), ld);
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 operands, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NTL>
__device__ __forceinline__ void frag_zero(float (&acc)[NTL][4]) {
#pragma unroll
  for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;
}

// unroll factors of the products' k loop; a full-width product holds 64
// accumulators and spills when it is unrolled further
constexpr int KTU = 4, KTU_WIDE = 2;

// acc += A[row0 .. row0+15][0 .. 16*KT) * W[:, 16*np0 .. 16*(np0+NP)) on the
// tensor cores. A is a swizzled shared tile of row stride lda; W is one
// packed (in, out) matrix of NPT n-tile pairs a row of tiles: the
// uint4 at ((kt * NPT + np) * 32 + lane) holds this thread's B
// fragments of n-tiles 2np and 2np+1 at k-tile kt, so a warp's load is one
// coalesced 512-byte read, served by L1 to the CTA's other warps. The next
// k-tile's fragments load while this one's products run.
template <int NP, int KT, int NPT>
__device__ __forceinline__ void mma_rows(float (&acc)[2 * NP][4], const bf16* A, int lda,
                                         int row0, const uint4* __restrict__ W, int np0) {
  const uint4* wp = W + (size_t)np0 * 32 + lane_id();
  uint4 cur[NP], nxt[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) cur[p] = __ldg(wp + p * 32);
  constexpr int U = NP >= FP ? KTU_WIDE : KTU;
#pragma unroll U
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) {
#pragma unroll
      for (int p = 0; p < NP; ++p) nxt[p] = __ldg(wp + ((kt + 1) * NPT + p) * 32);
    }
    uint32_t a[4];
    ldsm_a(a, A, lda, row0, 16 * kt);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      mma_bf16(acc[2 * p], a, cur[p].x, cur[p].y);
      mma_bf16(acc[2 * p + 1], a, cur[p].z, cur[p].w);
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) cur[p] = nxt[p];
  }
}

// The same for 32 rows (two row tiles, row0 .. and row0 + 16 ..): each weight
// fragment a warp loads feeds two products, which halves the L1 traffic of
// the products that need no full rows.
template <int NP, int KT, int NPT>
__device__ __forceinline__ void mma_rows2(float (&acc0)[2 * NP][4], float (&acc1)[2 * NP][4],
                                          const bf16* A, int lda, int row0,
                                          const uint4* __restrict__ W, int np0) {
  const uint4* wp = W + (size_t)np0 * 32 + lane_id();
  uint4 cur[NP], nxt[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) cur[p] = __ldg(wp + p * 32);
#pragma unroll KTU
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) {
#pragma unroll
      for (int p = 0; p < NP; ++p) nxt[p] = __ldg(wp + ((kt + 1) * NPT + p) * 32);
    }
    uint32_t a0[4], a1[4];
    ldsm_a(a0, A, lda, row0, 16 * kt);
    ldsm_a(a1, A, lda, row0 + 16, 16 * kt);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      mma_bf16(acc0[2 * p], a0, cur[p].x, cur[p].y);
      mma_bf16(acc1[2 * p], a1, cur[p].x, cur[p].y);
      mma_bf16(acc0[2 * p + 1], a0, cur[p].z, cur[p].w);
      mma_bf16(acc1[2 * p + 1], a1, cur[p].z, cur[p].w);
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) cur[p] = nxt[p];
  }
}

// the product's bf16 output plus the bias in bf16 (b points at the fragment's
// first column), as bf16 pairs: out[nt][h] holds columns 8 nt + 2 t, + 1 of
// row row0 + g + 8 h
template <int NTL>
__device__ __forceinline__ void frag_bias_pack(const float (&acc)[NTL][4],
                                               const float* __restrict__ b,
                                               bf162 (&out)[NTL][2]) {
  const int t = lane_id() & 3;
#pragma unroll
  for (int nt = 0; nt < NTL; ++nt) {
    const float2 bb = __ldg(reinterpret_cast<const float2*>(b + 8 * nt + 2 * t));
    const bf162 b2 = round2(bb.x, bb.y);
    out[nt][0] = add2(round2(acc[nt][0], acc[nt][1]), b2);
    out[nt][1] = add2(round2(acc[nt][2], acc[nt][3]), b2);
  }
}

// a fragment of bf16 pairs into a swizzled tile, its first column at col0
template <int NTL>
__device__ __forceinline__ void frag_store2(bf16* tile, int ld, int row0, int col0,
                                            const bf162 (&v)[NTL][2]) {
  const int g = lane_id() >> 2, t = lane_id() & 3;
#pragma unroll
  for (int nt = 0; nt < NTL; ++nt) {
    sts_b2(tile, row0 + g, col0 + 8 * nt + 2 * t, ld, v[nt][0]);
    sts_b2(tile, row0 + g + 8, col0 + 8 * nt + 2 * t, ld, v[nt][1]);
  }
}

// 1 / (1 + exp(-l)) on the card's exp2 and reciprocal units (a few f32 ulp,
// far below the bf16 rounding the result gets when it is stored)
__device__ __forceinline__ float sigmoidf(float l) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(-1.4426950408889634f * l));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  return r;
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  x += __shfl_xor_sync(FULL, x, 2);
  return x;
}

// A full-width product of the MLP fronts: rows row0 .. row0 + 15 of
// A[.][0 .. 16*KT) * W (an (in, F) matrix), rounded to bf16 (plus the bf16 bias
// where one is given), into the same rows of the swizzled tile out, which may
// be A itself: the warp owns these rows.
template <int KT>
__device__ __forceinline__ void front_product(bf16* out, int ldo, const bf16* A, int lda,
                                              int row0, const uint4* __restrict__ W,
                                              const float* __restrict__ b = nullptr) {
  const int g = lane_id() >> 2, t = lane_id() & 3;
  float acc[FT][4];
  frag_zero(acc);
  mma_rows<FP, KT, FP>(acc, A, lda, row0, W, 0);
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < FT; ++nt) {
    bf162 lo = round2(acc[nt][0], acc[nt][1]), hi = round2(acc[nt][2], acc[nt][3]);
    if (b) {
      const float2 bb = __ldg(reinterpret_cast<const float2*>(b + 8 * nt + 2 * t));
      const bf162 b2 = round2(bb.x, bb.y);
      lo = add2(lo, b2);
      hi = add2(hi, b2);
    }
    sts_b2(out, row0 + g, 8 * nt + 2 * t, ldo, lo);
    sts_b2(out, row0 + g + 8, 8 * nt + 2 * t, ldo, hi);
  }
  __syncwarp();
}

// LayerNorm (f32 statistics, eps 1e-5) -> SiLU of rows row0 .. row0 + 15 of the
// swizzled tile src into the same rows of dst (bf16). Each thread works on
// the elements the accumulator fragment gave it (rows row0 + g and + 8,
// columns 8 nt + 2 t, + 1), so a row statistic is a thread-local sum and two
// shuffles; the values stay in shared memory and the loops over the n-tiles
// stay rolled, which keeps the registers (and the code) small. The rows' mean
// and 1/std are kept in stat[2 * (row & 31)] for the tangent lanes that
// replay this LayerNorm. scale and bias are in shared memory.
__device__ __forceinline__ void tile_ln_silu(const bf16* src, int lds, bf16* dst, int ldd,
                                             int row0, const float* scale, const float* bias,
                                             float* stat) {
  const int g = lane_id() >> 2, t = lane_id() & 3;
  const int r[2] = {row0 + g, row0 + g + 8};
  float mu[2], rstd[2], s[2] = {0.f, 0.f}, q[2] = {0.f, 0.f};
#pragma unroll 4
  for (int nt = 0; nt < FT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 v = f2(lds_b2(src, r[h], 8 * nt + 2 * t, lds));
      s[h] += v.x + v.y;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) mu[h] = quad_sum(s[h]) * (1.f / F);
#pragma unroll 4
  for (int nt = 0; nt < FT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 v = f2(lds_b2(src, r[h], 8 * nt + 2 * t, lds));
      q[h] += (v.x - mu[h]) * (v.x - mu[h]) + (v.y - mu[h]) * (v.y - mu[h]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rstd[h] = 1.f / sqrtf(quad_sum(q[h]) * (1.f / F) + 1e-5f);
    if (t == 0) {
      stat[2 * (r[h] & (R - 1))] = mu[h];
      stat[2 * (r[h] & (R - 1)) + 1] = rstd[h];
    }
  }
#pragma unroll 4
  for (int nt = 0; nt < FT; ++nt) {
    const int col = 8 * nt + 2 * t;
    const float2 sc = *reinterpret_cast<const float2*>(scale + col);
    const float2 bi = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 v = f2(lds_b2(src, r[h], col, lds));
      const float l0 = (v.x - mu[h]) * rstd[h] * sc.x + bi.x;
      const float l1 = (v.y - mu[h]) * rstd[h] * sc.y + bi.y;
      sts_b2(dst, r[h], col, ldd, round2(l0 * sigmoidf(l0), l1 * sigmoidf(l1)));
    }
  }
  __syncwarp();
}

// Tangent of LayerNorm -> SiLU on rows row0 .. row0 + 15 of the swizzled
// tangent tile dv, in place, replayed at the primal's pre-LN tile HP
// (swizzled, R x F: stacked row r replays tile row r & 31) and its kept
// statistics. Same thread layout and rolled loops as tile_ln_silu.
__device__ __forceinline__ void tile_ln_silu_tan(bf16* dv, int ld, int row0, const bf16* HP,
                                                 const float* stat, const float* scale,
                                                 const float* bias) {
  const int g = lane_id() >> 2, t = lane_id() & 3;
  const int r[2] = {row0 + g, row0 + g + 8};
  const int jr[2] = {r[0] & (R - 1), r[1] & (R - 1)};
  float mu[2], rstd[2], dmu[2], drstd[2], sd[2] = {0.f, 0.f}, cd[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mu[h] = stat[2 * jr[h]];
    rstd[h] = stat[2 * jr[h] + 1];
  }
#pragma unroll 4
  for (int nt = 0; nt < FT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 hp = f2(lds_b2(HP, jr[h], 8 * nt + 2 * t, F));
      const float2 d = f2(lds_b2(dv, r[h], 8 * nt + 2 * t, ld));
      sd[h] += d.x + d.y;
      cd[h] += (hp.x - mu[h]) * d.x + (hp.y - mu[h]) * d.y;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    dmu[h] = quad_sum(sd[h]) * (1.f / F);
    const float dvar = 2.f * (quad_sum(cd[h]) * (1.f / F));
    drstd[h] = -0.5f * rstd[h] * rstd[h] * rstd[h] * dvar;
  }
#pragma unroll 4
  for (int nt = 0; nt < FT; ++nt) {
    const int col = 8 * nt + 2 * t;
    const float2 sc = *reinterpret_cast<const float2*>(scale + col);
    const float2 bi = *reinterpret_cast<const float2*>(bias + col);
    const float s2[2] = {sc.x, sc.y}, b2[2] = {bi.x, bi.y};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 hp = f2(lds_b2(HP, jr[h], col, F));
      const float2 d = f2(lds_b2(dv, r[h], col, ld));
      const float cen[2] = {hp.x - mu[h], hp.y - mu[h]}, dd[2] = {d.x, d.y};
      float out[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = ((dd[e] - dmu[h]) * rstd[h] + cen[e] * drstd[h]) * s2[e];
        const float l = cen[e] * rstd[h] * s2[e] + b2[e];
        const float sig = sigmoidf(l);
        out[e] = sig * (1.f + l * (1.f - sig)) * dl;
      }
      sts_b2(dv, r[h], col, ld, round2(out[0], out[1]));
    }
  }
  __syncwarp();
}

// Sum v[q][0..1] (columns col, col + 1 of one n-tile, col = 8 nt + 2 t, each
// already summed over the thread's two rows) over the warp's 8 row groups
// and write out[q * F + column]. The first exchange halves what each thread
// carries (lanes 16.. keep column col + 1), so a value costs 1.5 shuffles.
template <int NQ>
__device__ __forceinline__ void rows_sum_store(const float (&v)[NQ][2], float* out, int col) {
  const int lane = lane_id();
  const bool hi = (lane & 16) != 0;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const float got = __shfl_xor_sync(FULL, hi ? v[q][0] : v[q][1], 16);
    float keep = (hi ? v[q][1] : v[q][0]) + got;
    keep += __shfl_xor_sync(FULL, keep, 8);
    keep += __shfl_xor_sync(FULL, keep, 4);
    if ((lane & 12) == 0) out[q * F + col + (hi ? 1 : 0)] = keep;
  }
}

}  // namespace pk
