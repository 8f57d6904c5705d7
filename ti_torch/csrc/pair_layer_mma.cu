// Kernels B1 and B2 in the bf16_agg profile on Hopper's tensor cores (sm_90a):
// one cPaiNN message layer on the dense pair grid.
//
// Replaces ti_tpu/ops/pair_layer_kernel.py::_pair_layer_kernel (B1) and
// ::_pair_layer_kernel_cb (B2, C chains per grid step), the Pallas TPU kernels
// built by _build_pair_layer, for bf16 weights. It computes what pair_layer.cu
// computes in bf16_agg, with the same layouts and the same rounding sites: per
// pair row p = i*N + j the geometry, the positional encoding of dist,
// phi([s_j | e_ij]) * w(PE) with both MLPs Dense-LN-SiLU x2 -> Dense 5F (each
// product accumulated in f32 and rounded once to bf16, plus its bf16 bias;
// LayerNorm with f32 statistics), the diagonal mask, the sums over j in f32,
// the chirality term and e + de. pair_layer.cu keeps its bf16_agg kernel
// (variant "fma", timed beside this one) and f32 as "fma".
//
// What bounds it on this card: operations, 15 F^2 multiply-adds per pair row
// on the bf16 tensor cores (at 8192 chains, N = 19: 1.45 TFLOP, 1.47 ms at
// 989 TFLOP/s; the 1.5 GB of e in and e_out out take 0.45 ms). For a design
// that reads its weights from L2 the floor is lower down: every CTA streams
// the layer's 15 F^2 bf16 weights (491,520 bytes) from L2 into the SM, which
// at 8192 chains and one 64-row tile a CTA is 51,883 x 0.49 MB = 25.5 GB.
// Measured (PERF.md section 6): the products take most of the warps' clocks
// and the epilogues (LayerNorm, the fill of X and PE, the sums) the rest;
// prefetching the fragments into L1 did not help, sharing them across tiles
// did a little. The likeliest limit left in the products is the L1 and
// shared-memory traffic of mma.sync: every warp loads its own copy of the
// fragments it uses (wgmma, reading B once a warpgroup from shared memory, is
// later work).
//
// What the design does about it:
// - tight row tiles (as pair_layer_tf32x3.cu). e is the (B*N*N, F) matrix it
//   is; a row tile is TR = 64 consecutive pair rows holding G = 64 / N whole
//   (chain, dst atom) groups, 57 real rows at N = 19. Group Q of the launch is
//   (b, i) = (Q / N, Q % N), its rows Q*N + j. The sums over j are segmented
//   sums over each group's N rows from shared memory, in the order j = 0..N-1,
//   with no atomics: two launches on the same inputs agree to the bit;
// - every product is mma.sync.m16n8k16 with bf16 operands and f32
//   accumulators, the A operand from swizzled shared memory through ldmatrix,
//   the B operand from global memory (L2, then L1 for the CTA's other warps)
//   in the fragment order of ops/pair_layer_kernel.pack_mma_weights. Warp w
//   owns rows 16 (w % 4) .. of every tile of its CTA and column block w / 4
//   of each F-wide product;
// - B2: a CTA takes TB = 1..3 consecutive row tiles at F = 128 (the
//   wrapper's mma_tiles maps chain_block to TB; at F = 256 TB is 1), and each
//   weight fragment a warp loads feeds the same rows of all of them, which
//   divides the L2 weight stream by TB. Three tiles fill the shared memory of
//   a CTA; four do not fit, and walking four in two rounds of two was slower
//   than three at once (PERF.md, section 6), so there are no rounds. At F =
//   128 a CTA of one tile has 8 warps (two CTAs an SM, each warp half the
//   columns of a product); a CTA of more has 16 (one an SM, each warp a
//   quarter of the columns), so an SM keeps 16 warps to hide latency either
//   way. Each group's code and order of
//   summation are B1's, so B2's outputs equal B1's to the bit;
// - each product's accumulators are rounded once to bf16 plus the bf16 bias,
//   into shared memory where the plain version rounds; LayerNorm and SiLU run
//   on those rows (a half-warp a row, f32 statistics, eps 1e-5); the 5F
//   product is formed one F-wide chunk at a time and consumed at once, and the
//   elementwise products gates * v_j, scale * dir and cg * dir are bf16-pair
//   instructions (one rounding each, as the plain version). Only e_out, dv
//   and ds reach device memory.
//
// Shared memory of a tile: X = [s_j | e_ij] (64 x 2F), Y = PE (64 x F) and
// H (64 x F) bf16, swizzled in 16-byte chunks (mma_common.cuh), and the rows'
// dist, mask and dir: 64 (8F + 20) bytes, 66,816 at F = 128 and 132,352 at
// F = 256. Every instantiation is held to 128 registers a thread (two CTAs of
// 256 threads an SM, or one of 512).
//
// F and the tile sizes are named constants (pair_common.cuh, mma_common.cuh).
// The source is built three times (ops/_build.py): at F = 128 (pair_layer_mma),
// with -DPK_F=64 (pair_layer_mma_f64, the validation CLIs' default width) and
// with -DPK_F=256 (pair_layer_mma_f256, the 10506 profile's 29 atoms x F =
// 256). At F = 64 a tile is 34,048 bytes and six would fit a CTA; B2 takes up
// to four (min(C, 4): C = 4 is the largest chain block a path runs, and each
// tile count is a kernel of its own). A CTA of one tile has F / 16 = 4 warps,
// each all 64 columns of a product (the accumulators and weight fragments of
// the 8-warp CTA at F = 128), four CTAs an SM; a CTA of 2-4 tiles has 16
// warps, each a quarter of the columns (one CTA an SM): 16 warps an SM
// either way. A row of 64 columns is one 16-byte chunk a lane of a
// quarter-warp, so LayerNorm takes a row a quarter-warp. At F = 256 one tile fills a CTA's shared memory, so B2 takes one tile
// a CTA whatever chain_block, and that CTA has 16 warps, each a quarter of
// the columns of a product: a warp holds the same accumulators and weight
// fragments as in the 8-warp CTA of one tile at F = 128, so the register
// budget is the same. Each CTA streams the layer's 15 F^2 bf16 weights
// (1,966,080 bytes at F = 256) from L2, as at F = 128.

#include "mma_common.cuh"

namespace pk {
namespace lmma {

constexpr int TR = 64;          // pair rows of a row tile
constexpr int LDX = 2 * F;      // row stride of X
// 16-byte chunks a lane takes of a row in LayerNorm: a half-warp a row at F =
// 128 and 256; at F = 64 a quarter-warp a row, one chunk a lane
constexpr int LCH = F == 64 ? 1 : F / 128;
constexpr int WARPS1 = FP;      // warps of a CTA of one tile: 4 at F = 64, 8 at 128, 16 at 256

// one tile's shared memory: X, Y, H (bf16 element offsets), then dist (TR f32),
// mask (TR f32) and dir (3 x TR pairs of equal bf16)
constexpr int X_OFF = 0, Y_OFF = TR * LDX, H_OFF = Y_OFF + TR * F;
constexpr size_t TILE_BF16 = (size_t)TR * 4 * F;
constexpr size_t TILE_BYTES = sizeof(bf16) * TILE_BF16 + sizeof(float) * 5 * TR;
constexpr size_t TSTRIDE = TILE_BYTES / sizeof(bf16);  // tile c starts at c * TSTRIDE
// row tiles a CTA: as many as fit its shared memory, three at F = 128, one at
// 256; four at F = 64, where six fit
constexpr int MAX_TILES = F == 64 ? 4 : (int)(232448 / TILE_BYTES);
static_assert(TILE_BYTES % 16 == 0, "tiles start on 16-byte boundaries");
static_assert(MAX_TILES * TILE_BYTES <= 232448, "a CTA's tiles fit its shared memory");
static_assert(MAX_TILES == (F == 64 ? 4 : F == 128 ? 3 : 1),
              "four tiles a CTA at F = 64, three at F = 128, one at 256");

// the shared memory of a CTA of TB row tiles
__host__ __device__ constexpr size_t smem_bytes(int TB) { return TB * TILE_BYTES; }

__device__ __forceinline__ float* tile_geo(bf16* base, int c) {
  return reinterpret_cast<float*>(base + c * TSTRIDE + TILE_BF16);
}

// acc[c] = A_c[row0 .. row0 + 15][k0 .. k0 + 16 KT) * W[:, n-tile pairs np0 ..
// np0 + NP) for the CTA's TB tiles (A_c = A + c * TSTRIDE, a swizzled tile
// of row stride lda). W is one packed matrix of NPT n-tile pairs a row of
// tiles (pack_mma_weights): each weight fragment the warp loads feeds TB row
// tiles, and the next k-tile's fragments load while this one's products run.
template <int TB, int NP, int KT, int NPT>
__device__ __forceinline__ void mma_tiles(float (&acc)[TB][2 * NP][4], const bf16* A, int lda,
                                          int k0, int row0, const uint4* __restrict__ W,
                                          int np0) {
  const uint4* wp = W + (size_t)np0 * 32 + lane_id();
  uint4 cur[NP], nxt[NP];
#pragma unroll
  for (int c = 0; c < TB; ++c) frag_zero(acc[c]);
#pragma unroll
  for (int p = 0; p < NP; ++p) cur[p] = __ldg(wp + p * 32);
#pragma unroll 2
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) {
#pragma unroll
      for (int p = 0; p < NP; ++p) nxt[p] = __ldg(wp + ((kt + 1) * NPT + p) * 32);
    }
#pragma unroll
    for (int c = 0; c < TB; ++c) {
      uint32_t a[4];
      ldsm_a(a, A + c * TSTRIDE, lda, row0, k0 + 16 * kt);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        mma_bf16(acc[c][2 * p], a, cur[p].x, cur[p].y);
        mma_bf16(acc[c][2 * p + 1], a, cur[p].z, cur[p].w);
      }
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) cur[p] = nxt[p];
  }
}

// the products' bf16 outputs plus the bf16 bias (b points at the warp's first
// column) into rows row0 .. row0 + 15, columns col0 .. col0 + 8 NT8 of each
// of the TB tiles of out (row stride ldo)
template <int TB, int NT8>
__device__ __forceinline__ void store_tiles(bf16* out, int ldo, int col0, int row0,
                                            const float (&acc)[TB][NT8][4],
                                            const float* __restrict__ b) {
#pragma unroll
  for (int c = 0; c < TB; ++c) {
    bf162 v[NT8][2];
    frag_bias_pack(acc[c], b, v);
    frag_store2(out + c * TSTRIDE, ldo, row0, col0, v);
  }
}

// LayerNorm (f32 statistics, eps 1e-5) -> SiLU in place on the F columns
// col0 .. of every row of the TB tiles of T (row stride ld): a half-warp
// takes a row, a lane LCH 16-byte chunks of 8 columns (at F = 64 a
// quarter-warp a row, a lane one chunk); scale and bias come from global
// memory once a call
template <int TB, int NWARP>
__device__ __forceinline__ void ln_silu_tiles(bf16* T, int ld, int col0,
                                              const float* __restrict__ scale,
                                              const float* __restrict__ bias) {
  if constexpr (F == 64) {
    const int lane = lane_id(), ql = lane & 7;
    float sc[8], bi[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(scale + 8 * ql + 4 * h));
      const float4 o = __ldg(reinterpret_cast<const float4*>(bias + 8 * ql + 4 * h));
      sc[4 * h] = a.x, sc[4 * h + 1] = a.y, sc[4 * h + 2] = a.z, sc[4 * h + 3] = a.w;
      bi[4 * h] = o.x, bi[4 * h + 1] = o.y, bi[4 * h + 2] = o.z, bi[4 * h + 3] = o.w;
    }
#pragma unroll 1
    for (int rr = 4 * (threadIdx.x >> 5) + (lane >> 3); rr < TB * TR; rr += 4 * NWARP) {
      const int r = rr % TR;
      bf16* row = T + (rr / TR) * TSTRIDE;
      uint4* at = reinterpret_cast<uint4*>(row + swz(r, col0 + 8 * ql, ld));
      const uint4 u = *at;
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
      float v[8], s = 0.f;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float2 f = f2(as_bf162(w[h]));
        v[2 * h] = f.x;
        v[2 * h + 1] = f.y;
        s += f.x + f.y;
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
      const float mu = s * (1.f / F);
      float q = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) q += (v[e] - mu) * (v[e] - mu);
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) q += __shfl_xor_sync(FULL, q, o);
      const float rstd = 1.f / sqrtf(q * (1.f / F) + 1e-5f);
      uint32_t out[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float l0 = (v[2 * h] - mu) * rstd * sc[2 * h] + bi[2 * h];
        const float l1 = (v[2 * h + 1] - mu) * rstd * sc[2 * h + 1] + bi[2 * h + 1];
        const bf162 o = round2(l0 * sigmoidf(l0), l1 * sigmoidf(l1));
        out[h] = *reinterpret_cast<const uint32_t*>(&o);
      }
      *at = make_uint4(out[0], out[1], out[2], out[3]);
    }
    return;
  }
  const int lane = lane_id(), hl = lane & 15;
  float sc[LCH][8], bi[LCH][8];
#pragma unroll
  for (int m = 0; m < LCH; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(scale + 8 * (hl + 16 * m) + 4 * h));
      const float4 o = __ldg(reinterpret_cast<const float4*>(bias + 8 * (hl + 16 * m) + 4 * h));
      sc[m][4 * h] = a.x, sc[m][4 * h + 1] = a.y, sc[m][4 * h + 2] = a.z, sc[m][4 * h + 3] = a.w;
      bi[m][4 * h] = o.x, bi[m][4 * h + 1] = o.y, bi[m][4 * h + 2] = o.z, bi[m][4 * h + 3] = o.w;
    }
#pragma unroll 1
  for (int rr = 2 * (threadIdx.x >> 5) + (lane >> 4); rr < TB * TR; rr += 2 * NWARP) {
    const int r = rr % TR;
    bf16* row = T + (rr / TR) * TSTRIDE;
    float v[LCH][8], s = 0.f;
#pragma unroll
    for (int m = 0; m < LCH; ++m) {
      const uint4 u = *reinterpret_cast<const uint4*>(row + swz(r, col0 + 8 * (hl + 16 * m), ld));
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float2 f = f2(as_bf162(w[h]));
        v[m][2 * h] = f.x;
        v[m][2 * h + 1] = f.y;
        s += f.x + f.y;
      }
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    const float mu = s * (1.f / F);
    float q = 0.f;
#pragma unroll
    for (int m = 0; m < LCH; ++m)
#pragma unroll
      for (int e = 0; e < 8; ++e) q += (v[m][e] - mu) * (v[m][e] - mu);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) q += __shfl_xor_sync(FULL, q, o);
    const float rstd = 1.f / sqrtf(q * (1.f / F) + 1e-5f);
#pragma unroll
    for (int m = 0; m < LCH; ++m) {
      uint32_t w[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float l0 = (v[m][2 * h] - mu) * rstd * sc[m][2 * h] + bi[m][2 * h];
        const float l1 = (v[m][2 * h + 1] - mu) * rstd * sc[m][2 * h + 1] + bi[m][2 * h + 1];
        const bf162 o = round2(l0 * sigmoidf(l0), l1 * sigmoidf(l1));
        w[h] = *reinterpret_cast<const uint32_t*>(&o);
      }
      *reinterpret_cast<uint4*>(row + swz(r, col0 + 8 * (hl + 16 * m), ld)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// packed weights: the matrices keep their offsets of the row-major buffer
__device__ __forceinline__ const uint4* wmat(const uint4* wpk, size_t off) { return wpk + off / 8; }

// One CTA of NWARP warps: TB row tiles from tile blockIdx.x * TB on. Warp w
// owns rows 16 (w % 4) .. of every tile and column block w / 4 of each F-wide
// product (NWARP / 4 blocks of CW columns).
template <int TB, int NWARP>
__global__ void __launch_bounds__(32 * NWARP, NWARP == 4 ? 4 : NWARP == 8 ? 2 : 1)
pair_layer_mma_kernel(const float* __restrict__ x, const bf16* __restrict__ s,
                      const bf16* __restrict__ v, const bf16* __restrict__ e,
                      const uint4* __restrict__ wpk, const float* __restrict__ vecs,
                      float* __restrict__ dv, float* __restrict__ ds, bf16* __restrict__ e_out,
                      int B, int N, int G, float pe_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* base = reinterpret_cast<bf16*>(smem);
  bf16* X = base + X_OFF;   // [s_j | e_ij]; then phi's h2 | w's h1, a2 of phi | a1 of w, and
                            // in the 5F chunks a2 of phi | the chunk's h
  bf16* Y = base + Y_OFF;   // PE; then w's h2, a2 of w
  bf16* H = base + H_OFF;   // phi's h1, a1 of phi; then the gates (chunk 0's h)
  constexpr int NTHR = 32 * NWARP;
  constexpr int NP = FP / (NWARP / 4), NT8 = 2 * NP, CW = 8 * NT8;  // a warp's n-tile pairs,
                                                                     // n-tiles, columns
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = lane_id() >> 2;
  const int row0 = 16 * (warp & 3), cb = warp >> 2, col = CW * cb;
  const int BN = B * N;
  const float *vp = vecs + V_PHI, *vw = vecs + V_W;

  const int t0 = blockIdx.x * TB;  // the CTA's first tile

  // geometry of row r of tile c: dist, mask, dir = r / (1 + dist)
  for (int idx = tid; idx < TB * TR; idx += NTHR) {
    const int c = idx / TR, r = idx % TR;
    const int q0 = (t0 + c) * G;
    float d = 0.f, msk = 0.f, rv[3] = {0.f, 0.f, 0.f}, inv = 1.f;
    if (r < min(G, BN - q0) * N) {
      const int q = q0 + r / N, j = r % N, b = q / N, i = q % N;
      const float* xb = x + (size_t)b * N * 3;
#pragma unroll
      for (int c3 = 0; c3 < 3; ++c3) rv[c3] = xb[j * 3 + c3] - xb[i * 3 + c3];
      d = sqrtf(rv[0] * rv[0] + rv[1] * rv[1] + rv[2] * rv[2]);
      inv = 1.f / (1.f + d);
      msk = j != i ? 1.f : 0.f;
    }
    float* geo = tile_geo(base, c);
    bf162* dirw = reinterpret_cast<bf162*>(geo + 2 * TR);
    geo[r] = d;
    geo[TR + r] = msk;
#pragma unroll
    for (int c3 = 0; c3 < 3; ++c3) dirw[c3 * TR + r] = both2(rv[c3] * inv);
  }
  __syncthreads();

  // X = [s_j | e_ij] in 16-byte chunks (zero past the last real row); Y = PE
  // (interleaved cos/sin, rank f / 2 + 1)
  const uint4 none = make_uint4(0u, 0u, 0u, 0u);
  for (int idx = tid; idx < TB * TR * (LDX / 8); idx += NTHR) {
    const int c = idx / (TR * (LDX / 8)), rem = idx % (TR * (LDX / 8));
    const int r = rem / (LDX / 8), k = rem % (LDX / 8);
    const int q0 = (t0 + c) * G;
    bf16* dst = X + c * TSTRIDE + swz(r, 8 * k, LDX);
    if (r < min(G, BN - q0) * N) {
      const int q = q0 + r / N, j = r % N, b = q / N;
      const bf16* src = k < F / 8 ? s + ((size_t)b * N + j) * F + 8 * k
                                  : e + ((size_t)q0 * N + r) * F + (8 * k - F);
      cp_async16(dst, src);
    } else {
      *reinterpret_cast<uint4*>(dst) = none;
    }
  }
  cp_async_commit();
  for (int idx = tid; idx < TB * TR * (F / 2); idx += NTHR) {
    const int c = idx / (TR * (F / 2)), rem = idx % (TR * (F / 2));
    const int r = rem / (F / 2), k = rem % (F / 2);
    const float rank = (float)(k + 1);
    float sn, cs;
    sincosf(tile_geo(base, c)[r] * rank * pe_scale, &sn, &cs);
    sts_b2(Y + c * TSTRIDE, r, 2 * k, F, round2(cs, sn));
  }
  cp_async_wait_all();
  __syncthreads();

  // the MLP fronts, every warp on its rows and column half of every product
  float acc[TB][NT8][4];
  mma_tiles<TB, NP, LDX / 16, FP>(acc, X, LDX, 0, row0, wmat(wpk, M_PHI1), NP * cb);
  store_tiles<TB, NT8>(H, F, col, row0, acc, vp + V_B1 + col);  // phi's h1
  __syncthreads();
  ln_silu_tiles<TB, NWARP>(H, F, 0, vp + V_LN1S, vp + V_LN1B);
  __syncthreads();
  mma_tiles<TB, NP, F / 16, FP>(acc, H, F, 0, row0, wmat(wpk, M_PHI2), NP * cb);
  store_tiles<TB, NT8>(X, LDX, col, row0, acc, vp + V_B2 + col);  // phi's h2
  mma_tiles<TB, NP, F / 16, FP>(acc, Y, F, 0, row0, wmat(wpk, M_W1), NP * cb);
  store_tiles<TB, NT8>(X, LDX, F + col, row0, acc, vw + V_B1 + col);  // w's h1
  __syncthreads();
  ln_silu_tiles<TB, NWARP>(X, LDX, 0, vp + V_LN2S, vp + V_LN2B);  // a2 of phi
  ln_silu_tiles<TB, NWARP>(X, LDX, F, vw + V_LN1S, vw + V_LN1B);
  __syncthreads();
  mma_tiles<TB, NP, F / 16, FP>(acc, X, LDX, F, row0, wmat(wpk, M_W2), NP * cb);
  store_tiles<TB, NT8>(Y, F, col, row0, acc, vw + V_B2 + col);  // w's h2
  __syncthreads();
  ln_silu_tiles<TB, NWARP>(Y, F, 0, vw + V_LN2S, vw + V_LN2B);  // a2 of w
  __syncthreads();

  // the 5F product, one F-wide chunk k at a time (gates | scale_dir | ds | de |
  // cross_gates): h = p q masked into H (k = 0) or X's second half, then the
  // chunk's segmented sums over j
  bool on[TB][2];
#pragma unroll
  for (int c = 0; c < TB; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) on[c][h] = tile_geo(base, c)[TR + row0 + g + 8 * h] != 0.f;
  const bf162 zero2 = both2(0.f);
  for (int k = 0; k < 5; ++k) {
    bf162 p[TB][NT8][2];
    mma_tiles<TB, NP, F / 16, 5 * FP>(acc, X, LDX, 0, row0, wmat(wpk, M_PHI3), k * FP + NP * cb);
#pragma unroll
    for (int c = 0; c < TB; ++c) frag_bias_pack(acc[c], vp + V_B3 + k * F + col, p[c]);
    mma_tiles<TB, NP, F / 16, 5 * FP>(acc, Y, F, 0, row0, wmat(wpk, M_W3), k * FP + NP * cb);
    bf16* out = k == 0 ? H : X;
    const int ldo = k == 0 ? F : LDX, c0 = (k == 0 ? 0 : F) + col;
#pragma unroll
    for (int c = 0; c < TB; ++c) {
      bf162 q[NT8][2];
      frag_bias_pack(acc[c], vw + V_B3 + k * F + col, q);
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) q[nt][h] = on[c][h] ? mul2(p[c][nt][h], q[nt][h]) : zero2;
      frag_store2(out + c * TSTRIDE, ldo, row0, c0, q);
    }
    if (k == 0) continue;  // the gates wait in H for chunk 1
    __syncthreads();

    if (k == 3) {  // e + de, on whole rows in 16-byte chunks
      for (int idx = tid; idx < TB * TR * (F / 8); idx += NTHR) {
        const int c = idx / (TR * (F / 8)), rem = idx % (TR * (F / 8));
        const int r = rem / (F / 8), kk = rem % (F / 8);
        const int q0 = (t0 + c) * G;
        if (r >= min(G, BN - q0) * N) continue;
        const size_t at = ((size_t)q0 * N + r) * F + 8 * kk;
        const uint4 ev = __ldg(reinterpret_cast<const uint4*>(e + at));
        const uint4 hv = *reinterpret_cast<const uint4*>(X + c * TSTRIDE + swz(r, F + 8 * kk, LDX));
        const uint32_t ew[4] = {ev.x, ev.y, ev.z, ev.w}, hw[4] = {hv.x, hv.y, hv.z, hv.w};
        uint32_t o[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const bf162 sum = add2(as_bf162(ew[h]), as_bf162(hw[h]));
          o[h] = *reinterpret_cast<const uint32_t*>(&sum);
        }
        *reinterpret_cast<uint4*>(e_out + at) = make_uint4(o[0], o[1], o[2], o[3]);
      }
    } else {  // a thread per (tile, group, column pair); the same one in every chunk
      for (int idx = tid; idx < TB * G * (F / 2); idx += NTHR) {
        const int c = idx / (G * (F / 2)), rem = idx % (G * (F / 2));
        const int q = rem / (F / 2), cc = 2 * (rem % (F / 2));
        const int Q = (t0 + c) * G + q;
        if (q >= min(G, BN - (t0 + c) * G)) continue;
        const int b = Q / N, i = Q % N, rq = q * N;
        const bf16* hk = X + c * TSTRIDE;  // the chunk's h, columns F ..
        const bf162* dirw = reinterpret_cast<const bf162*>(tile_geo(base, c) + 2 * TR);
        const bf16* vb = v + (size_t)b * 3 * N * F + cc;  // v[b, 0, 0, cc]
        float2* dvq[3];
#pragma unroll
        for (int c3 = 0; c3 < 3; ++c3)
          dvq[c3] = reinterpret_cast<float2*>(dv + (((size_t)b * 3 + c3) * N + i) * F + cc);
        if (k == 1) {  // Σ_j gates·v_j + scale_dir·dir
          const bf16* gk = H + c * TSTRIDE;
          float a[3][2] = {};
          for (int j = 0; j < N; ++j) {
            const bf162 gg = lds_b2(gk, rq + j, cc, F), hh = lds_b2(hk, rq + j, F + cc, LDX);
#pragma unroll
            for (int c3 = 0; c3 < 3; ++c3) {
              const bf162 vv = ldg_b2(vb + ((size_t)c3 * N + j) * F);
              const float2 u = f2(add2(mul2(gg, vv), mul2(hh, dirw[c3 * TR + rq + j])));
              a[c3][0] += u.x;
              a[c3][1] += u.y;
            }
          }
#pragma unroll
          for (int c3 = 0; c3 < 3; ++c3) *dvq[c3] = make_float2(a[c3][0], a[c3][1]);
        } else if (k == 2) {  // Σ_j ds
          float a0 = 0.f, a1 = 0.f;
          for (int j = 0; j < N; ++j) {
            const float2 u = f2(lds_b2(hk, rq + j, F + cc, LDX));
            a0 += u.x;
            a1 += u.y;
          }
          *reinterpret_cast<float2*>(ds + ((size_t)b * N + i) * F + cc) = make_float2(a0, a1);
        } else {  // dv_i += (Σ_j cross_gates·dir) x v_i
          float a[3][2] = {};
          for (int j = 0; j < N; ++j) {
            const bf162 hh = lds_b2(hk, rq + j, F + cc, LDX);
#pragma unroll
            for (int c3 = 0; c3 < 3; ++c3) {
              const float2 u = f2(mul2(hh, dirw[c3 * TR + rq + j]));
              a[c3][0] += u.x;
              a[c3][1] += u.y;
            }
          }
          float2 vi[3];
#pragma unroll
          for (int c3 = 0; c3 < 3; ++c3) vi[c3] = f2(ldg_b2(vb + ((size_t)c3 * N + i) * F));
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const float t0c = a[0][e2], t1c = a[1][e2], t2c = a[2][e2];
            const float vx = e2 ? vi[0].y : vi[0].x, vy = e2 ? vi[1].y : vi[1].x,
                        vz = e2 ? vi[2].y : vi[2].x;
            a[0][e2] = t1c * vz - t2c * vy;
            a[1][e2] = t2c * vx - t0c * vz;
            a[2][e2] = t0c * vy - t1c * vx;
          }
#pragma unroll
          for (int c3 = 0; c3 < 3; ++c3) {
            const float2 o = *dvq[c3];  // chunk 1's sum, stored by this thread
            *dvq[c3] = make_float2(o.x + a[c3][0], o.y + a[c3][1]);
          }
        }
      }
    }
    __syncthreads();  // the chunk buffer is free for the next chunk
  }
}

template <int TB, int NWARP>
int launch(const void* x, const void* s, const void* v, const void* e, const void* mats,
           const void* vecs, void* dv, void* ds, void* e_out, int B, int N, int G,
           long long ctas, float pe_scale, void* stream) {
  const size_t smem = smem_bytes(TB);
  cudaError_t err = cudaFuncSetAttribute(pair_layer_mma_kernel<TB, NWARP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pair_layer_mma_kernel<TB, NWARP><<<(unsigned)ctas, 32 * NWARP, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const bf16*)s, (const bf16*)v, (const bf16*)e, (const uint4*)mats,
      (const float*)vecs, (float*)dv, (float*)ds, (bf16*)e_out, B, N, G, pe_scale);
  return (int)cudaGetLastError();
}

// WARPS1 warps for one tile (four CTAs an SM at F = 64, two at F = 128, one at
// 256), 16 for two or three (one CTA an SM; F = 64 and 128), and for four (F =
// 64 only). A template over MAX_TILES, so that the discarded branches
// instantiate no kernel.
template <int MT>
int launch_tiles(const void* x, const void* s, const void* v, const void* e, const void* mats,
                 const void* vecs, void* dv, void* ds, void* e_out, int B, int N, int G,
                 long long ctas, int TB, float pe_scale, void* stream) {
  if (TB == 1) return launch<1, WARPS1>(x, s, v, e, mats, vecs, dv, ds, e_out, B, N, G, ctas, pe_scale, stream);
  if constexpr (MT >= 3) {
    if (TB == 2) return launch<2, 16>(x, s, v, e, mats, vecs, dv, ds, e_out, B, N, G, ctas, pe_scale, stream);
    if constexpr (MT >= 4) {
      if (TB == 4) return launch<4, 16>(x, s, v, e, mats, vecs, dv, ds, e_out, B, N, G, ctas, pe_scale, stream);
    }
    return launch<3, 16>(x, s, v, e, mats, vecs, dv, ds, e_out, B, N, G, ctas, pe_scale, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

long long cta_count(int B, int N, int TB) {
  const int G = TR / N;
  const long long tiles = ((long long)B * N + G - 1) / G;
  return (tiles + TB - 1) / TB;
}

}  // namespace lmma
}  // namespace pk

// mats is the layer's matrices in fragment order (ops/pair_layer_kernel.pack_mma_weights),
// bf16; TB is the number of 64-row tiles a CTA takes, 1..MAX_TILES.
extern "C" int pair_layer_mma(const void* x, const void* s, const void* v, const void* e,
                              const void* mats, const void* vecs, void* dv, void* ds, void* e_out,
                              int B, int N, int TB, float pe_scale, void* stream) {
  using namespace pk::lmma;
  if (B < 1 || N < 2 || N > pk::R || TB < 1 || TB > MAX_TILES) return (int)cudaErrorInvalidValue;
  const int G = TR / N;
  const long long ctas = cta_count(B, N, TB);
  return launch_tiles<MAX_TILES>(x, s, v, e, mats, vecs, dv, ds, e_out, B, N, G, ctas, TB, pe_scale,
                                 stream);
}

extern "C" int pair_layer_mma_max_tiles() { return pk::lmma::MAX_TILES; }

extern "C" unsigned long long pair_layer_mma_smem_bytes(int TB) {
  return (unsigned long long)pk::lmma::smem_bytes(TB);
}

extern "C" long long pair_layer_mma_ctas(int B, int N, int TB) {
  return pk::lmma::cta_count(B, N, TB);
}
