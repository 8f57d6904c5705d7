// Kernel B3 in the bf16_agg profile, on Hopper's tensor cores (sm_90a): one
// cPaiNN message layer with K forward-mode probe lanes.
//
// Replaces ti_tpu/ops/pair_tangent_kernel.py::_pair_tangent_kernel (the Pallas
// TPU kernel built by _build_pair_tangent_layer). It computes what
// pair_tangent.cu computes, with the same layouts and the same rounding
// sites: the primal layer and, for each lane, its JVP under the lane's
// tangents of (x, s, v, e). pair_tangent.cu keeps the f32 instantiation and
// the earlier bf16 one (f32 FMA on the CUDA cores) to be timed against.
//
// What bounds it on this card: operations, 2 x 15 F^2 per pair row and pass
// (primal + K lanes), on the bf16 tensor cores. For this design the floor is
// lower down: a CTA streams the layer's 15 F^2 bf16 weights (0.49 MB) from
// L2 once for the primal and once per lane block, each of its warps reads
// the weight fragments it needs through L1, and mma.sync reaches about 60%
// of the card's bf16 rate.
//
// What the design does about it:
// - every product is mma.sync.m16n8k16 (bf16 operands, f32 accumulators). The
//   A operand comes from swizzled shared memory through ldmatrix; the B
//   operand straight from global memory, packed once by the wrapper in
//   fragment order (ops/pair_layer_kernel.pack_mma_weights), so no shared
//   memory is spent on weights;
// - one CTA owns one (dst atom i, chain b): the sums over the source atoms j
//   stay inside the CTA, no atomics. The primal runs once and keeps its
//   replay residuals in shared memory (pre-LN activations and LayerNorm
//   statistics of both MLPs, their a2 outputs, dPE/ddist, the gates); its 5F
//   products p, q go to a scratch buffer that stays in L2 and come back one
//   F-wide chunk ahead of their use (cp.async), instead of being recomputed
//   for every lane block;
// - the lanes go in blocks of L, stacked along the row axis: stacked row
//   32 l + j is pair row j of lane l. In the MLP fronts warp w owns stacked
//   rows 16 w .. 16 w + 15 and all F columns, so each weight tile is read
//   once for L lanes, and a warp's chain through both fronts touches only its
//   own rows: warp barriers, no CTA barrier. In the 5F chunks, which need
//   no full rows, a warp owns the 32 rows of one lane and half the columns:
//   each weight fragment feeds two row tiles, and the sums over j end inside
//   the warp;
// - the elementwise product rule runs on pairs of bf16 values (one
//   instruction rounds both, where the scalar form spends a conversion per
//   rounding site);
// - each front product rounds its accumulators to bf16 (where the plain version
//   rounds) into the warp's own rows of shared memory, and LayerNorm and its
//   tangent work there in the fragment's thread layout with rolled loops: with
//   the fragment in registers the kernel spilled.
//
// Shared memory at L = 4: 8 residual tiles of 32 x F bf16 (64 KB), the stacked
// [ds | de] input (64 KB; reused by the fronts' intermediate activations and
// then by the gates tangent and two stages of p, q), the a2 tangents of both
// MLPs (64 KB) and 26 KB of f32 side buffers: 222,976 of the 232,448 bytes a
// CTA may have.
//
// F and the tile counts are named constants (pair_common.cuh, mma_common.cuh).
// The source is built three times (ops/_build.py): at F = 128
// (pair_tangent_mma), with -DPK_F=64 (pair_tangent_mma_f64, the validation
// CLIs' default width) and with -DPK_F=256 (pair_tangent_mma_f256, the 10506
// profile's 29 atoms x F = 256).
// F = 64 keeps F = 128's layout (SMEM_RES): the 8 residual tiles (32 KB) in
// shared memory, lane blocks of 1, 2 or 4 stacked along the rows, a warp's 16
// stacked rows in the fronts and a lane's 32 rows and half the columns (32)
// in the 5F chunks: 113,664 bytes at L = 4. Four lanes divide the CLI's exact
// frame (K = 3N = 12) and the Hutchinson counts (K = 8, 16), so no lane of a
// block is wasted there. Where F = 128's code takes a row of 128 columns as
// 32 lanes x 4 (the fronts' input copy, dPE), F = 64 takes a row a half-warp.
// At F = 256 the buffers above would need 294,144 bytes at L = 1, so
// that build keeps 2 of the 8 residual tiles in shared memory (dPE/ddist and
// the gates) and moves the other 6 out:
// - the primal keeps them in the work buffers while it runs (at F = 256 the
//   work buffers are laid out for 2 lanes: XB 6 tiles, DAp and DAw 2 each),
//   and writes the 4 pre-LN tiles the lanes replay (h1, h2 of phi and of w)
//   to the CTA's scratch beside its p, q (14 tiles of 32 x 256 bf16 a CTA,
//   in L2 while the CTA runs). a2 of phi and of w only feed the primal's 5F
//   product;
// - a lane block reads phi's two tiles from the second p, q stage, where the
//   previous block's chunk 4 fetched them (cp.async, while that chunk's
//   products ran), and w's two from the same stage, fetched between phi's
//   front and w's: two CTA barriers a block more than at F = 128, the fetch
//   hidden behind dPE and w's first product;
// - the MLP fronts run in two column halves of 64 accumulators
//   (mma_common.cuh::front_product), never in place: phi's first tangent
//   product goes to DAw and w's to XB's second half. The lane chunks take
//   every warp, in passes of 32 columns: two a warp at L = 2, one at L = 1
//   (at F = 128 only the 2L warps that own stacked rows, 64 columns each:
//   64-column passes spilled at F = 256);
// - lane blocks of 1 or 2: 229,632 bytes of shared memory either way; at L =
//   4 this layout would need 343,296.
// The choice against a 2-CTA cluster that splits the columns (LayerNorm sums
// through distributed shared memory): the residual move keeps one CTA's code
// and order of summation, so F = 256 is F = 128's arithmetic at another
// width, and costs a 64 KB copy a CTA and 64 KB of L2 reads a lane block
// where the cluster would exchange row sums at every LayerNorm. At the 10506
// node shape (16 chains, N = 29, K = 32) the operations bound is 0.883 ms;
// the kernel takes about 12 times that (PERF.md section 6): in the fronts
// only the 2L warps that own stacked rows work.

#include "mma_common.cuh"

namespace pk {

// tiles (R x F bf16) of the stacked work buffer: the [ds | de] input of L
// lanes, later the gates tangent of L lanes and two stages of the primal p, q
__host__ __device__ constexpr int xb_tiles(int L) { return 2 * L > L + 4 ? 2 * L : L + 4; }

// the layout: at F = 64 and 128 every residual tile lives in shared memory;
// at F = 256 six move to the scratch (above)
constexpr bool SMEM_RES = F == 64 || F == 128;
// lanes a block (1, 2 or MAX_L): 4 at F = 64 and 128, 2 at F = 256
constexpr int MAX_L = SMEM_RES ? 4 : 2;
// the lanes the work buffers are laid out for (F = 64, 128: L; F = 256: at
// least MAX_L, the primal's room), and the slots of per-lane sums (F = 64,
// 128: 4)
__host__ __device__ constexpr int lay_lanes(int L) { return SMEM_RES || L > MAX_L ? L : MAX_L; }
__host__ __device__ constexpr int sum_slots(int L) { return SMEM_RES ? 4 : lay_lanes(L); }
// residual tiles kept in shared memory: 8 at F = 64, 128; dPE/ddist and the gates at 256
constexpr int RES_TILES = SMEM_RES ? 8 : 2;
// scratch tiles a CTA: p, q of 5 chunks; at F = 256 also h1, h2 of phi and of w
constexpr int SCR_TILES = SMEM_RES ? 10 : 14;

// f32 side buffers: the sums over j (slots x 7F), geometry, lane geometry
// (slots lanes), primal sums (7F), LayerNorm statistics (4 x 2R) and vectors (8F)
__host__ __device__ constexpr size_t side_floats(int L) {
  return (size_t)sum_slots(L) * 7 * F + NGEO * R + 4 * sum_slots(L) * R + 7 * F + 4 * 2 * R +
         8 * F;
}
constexpr size_t SIDE_FLOATS = side_floats(MAX_L);

size_t tangent_mma_smem_bytes(int L) {
  const int lb = lay_lanes(L);
  return sizeof(bf16) * (size_t)(RES_TILES + xb_tiles(lb) + 2 * lb) * RF +
         sizeof(float) * side_floats(L);
}

// What every phase of one CTA needs: the launch's tensors, the tile (b, i)
// and its shared-memory buffers.
struct Tile {
  const float* x;
  const bf16 *s, *v, *e;
  const float* dx;
  const bf16 *dsT, *dvT, *deT;
  const uint4* wpk;   // the layer's matrices in fragment order
  const float* vecs;
  float *dvp, *dsp;
  bf16* ep;
  float *dvt, *dst;
  bf16* et;
  bf16* scr;          // this CTA's primal p, q: [chunk][p | q], swizzled R x F tile images;
                      // at F = 256 then h1p, h2p, h1w, h2w
  int N, K, L, b, i;
  float pe_scale;
  // shared memory
  bf16 *h1p, *h2p, *a2p, *h1w, *h2w, *a2w;  // residuals: pre-LN and a2 of phi and w
  bf16 *pef, *G;      // dPE/ddist; the primal gates (chunk 0's h)
  bf16* XB;           // stacked work buffer
  bf16 *DAp, *DAw;    // a2 tangents of phi and w, stacked (32 L x F)
  float* wacc;        // sums over j of dv (3F), ds (F), t_cg (3F): per row tile, then per lane
  float* geo;
  bf162* dirw;        // dir (3 x R), each value as a pair of equal bf16
  bf162* lgw;         // per lane: ddir (3 x R), ddist (R), as pairs
  float* acc;         // primal dv (3F), ds (F), t_cg (3F)
  float* stat;        // mean, 1/std of the rows of h1p, h2p, h1w, h2w
  float* lnv;         // LayerNorm scale, bias of phi 1, phi 2, w 1, w 2
};

// packed weights: the matrices keep their offsets of the row-major buffer
__device__ __forceinline__ const uint4* wmat(const uint4* wpk, size_t off) { return wpk + off / 8; }

// The primal layer of the tile: outputs of dst atom i, and the residuals the
// lanes replay.
__device__ __forceinline__ void primal_phase(const Tile& c) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int N = c.N, b = c.b, i = c.i;
  const size_t pair0 = ((size_t)b * N + i) * N;  // pair row (b, i, j=0)
  float* geo = c.geo;
  const uint4* wpk = c.wpk;
  const float* vecs = c.vecs;
  const bf16 *s = c.s, *v = c.v, *e = c.e, *a2p = c.a2p, *a2w = c.a2w;
  bf16 *pef = c.pef, *G = c.G, *scr = c.scr, *ep = c.ep;
  bf162* dirw = c.dirw;
  float* lnv = c.lnv;
  const float pe_scale = c.pe_scale;

  // LayerNorm vectors into shared memory
  for (int idx = tid; idx < 8 * F; idx += NT) {
    const int m = idx / (4 * F), q = (idx / F) & 3;  // MLP; ln1 scale, ln1 bias, ln2 scale, ln2 bias
    lnv[idx] =
        vecs[(m ? V_W : V_PHI) + (q < 2 ? V_LN1S + q * F : V_LN2S + (q - 2) * F) + idx % F];
  }
  // geometry of row j: r = x_j - x_i, dist, 1/(1+dist), 1/dist, mask, dir
  if (tid < R) {
    const int j = tid;
    const float* xb = c.x + (size_t)b * N * 3;
    float r0 = 0.f, r1 = 0.f, r2 = 0.f, dist = 0.f, msk = 0.f;
    if (j < N) {
      r0 = xb[j * 3 + 0] - xb[i * 3 + 0];
      r1 = xb[j * 3 + 1] - xb[i * 3 + 1];
      r2 = xb[j * 3 + 2] - xb[i * 3 + 2];
      dist = sqrtf(r0 * r0 + r1 * r1 + r2 * r2);
      msk = (j != i) ? 1.f : 0.f;
    }
    const float inv = 1.f / (1.f + dist);
    geo[G_R0 * R + j] = r0;
    geo[G_R1 * R + j] = r1;
    geo[G_R2 * R + j] = r2;
    geo[G_DIST * R + j] = dist;
    geo[G_INV * R + j] = inv;
    geo[G_SID * R + j] = dist > 0.f ? 1.f / fmaxf(dist, 1e-30f) : 0.f;
    geo[G_MASK * R + j] = msk;
    dirw[0 * R + j] = both2(r0 * inv);
    dirw[1 * R + j] = both2(r1 * inv);
    dirw[2 * R + j] = both2(r2 * inv);
  }
  __syncthreads();

  // X = [s_j | e_ij] (row stride 2F), Y = PE(dist_ij), dPE/ddist
  bf16 *X = c.XB, *Y = SMEM_RES ? c.DAp : c.XB + 2 * RF;
  for (int idx = tid; idx < RF; idx += NT) {
    const int j = idx / F, f = idx % F;
    float sv = 0.f, ev = 0.f;
    if (j < N) {
      sv = tof(s[((size_t)b * N + j) * F + f]);
      ev = tof(e[(pair0 + j) * F + f]);
    }
    X[swz(j, f, 2 * F)] = __float2bfloat16_rn(sv);
    X[swz(j, F + f, 2 * F)] = __float2bfloat16_rn(ev);
    const float rank = (float)(f / 2 + 1);
    const float ang = geo[G_DIST * R + j] * rank * pe_scale;
    float sn, cs;
    sincosf(ang, &sn, &cs);
    Y[swz(j, f, F)] = __float2bfloat16_rn((f & 1) ? sn : cs);
    pef[swz(j, f, F)] = __float2bfloat16_rn(((f & 1) ? cs : -sn) * rank * pe_scale);
  }
  __syncthreads();

  // the fronts of both MLPs: warps 0, 1 own 16 rows each
  if (warp < 2) {
    const int row0 = 16 * warp;
    const float *vp = vecs + V_PHI, *vw = vecs + V_W;
    front_product<2 * F / 16>(c.h1p, F, X, 2 * F, row0, wmat(wpk, M_PHI1), vp + V_B1);
    tile_ln_silu(c.h1p, F, X, 2 * F, row0, lnv, lnv + F, c.stat);
    front_product<F / 16>(c.h2p, F, X, 2 * F, row0, wmat(wpk, M_PHI2), vp + V_B2);
    tile_ln_silu(c.h2p, F, c.a2p, F, row0, lnv + 2 * F, lnv + 3 * F, c.stat + 2 * R);

    front_product<F / 16>(c.h1w, F, Y, F, row0, wmat(wpk, M_W1), vw + V_B1);
    tile_ln_silu(c.h1w, F, Y, F, row0, lnv + 4 * F, lnv + 5 * F, c.stat + 4 * R);
    front_product<F / 16>(c.h2w, F, Y, F, row0, wmat(wpk, M_W2), vw + V_B2);
    tile_ln_silu(c.h2w, F, c.a2w, F, row0, lnv + 6 * F, lnv + 7 * F, c.stat + 6 * R);
  }
  __syncthreads();
  if constexpr (!SMEM_RES) {  // the pre-LN tiles the lanes replay, after p, q in the scratch
    bf16* res = scr + 10 * RF;
    for (int idx = tid; idx < 4 * RF / 8; idx += NT) {
      const int k = idx / (RF / 8), off = 8 * (idx % (RF / 8));
      const bf16* src = k == 0 ? c.h1p : k == 1 ? c.h2p : k == 2 ? c.h1w : c.h2w;
      *reinterpret_cast<uint4*>(res + k * RF + off) = *reinterpret_cast<const uint4*>(src + off);
    }
  }

  // the 5F product, one F-wide chunk at a time (gates | scale_dir | ds | de |
  // cross_gates), split over all warps: warp w owns rows 16 (w & 1) .. and
  // columns PCW (w >> 1) .. of the tile (PNT n-tiles)
  constexpr int PNP = F / 64, PNT = 2 * PNP, PCW = F / 4;
  const int rt = warp & 1, cb = warp >> 1;
  const bf162 zero2 = both2(0.f);
  bf162 gk[PNT][2];
  float* wa = c.wacc + rt * 7 * F;
  const int jh[2] = {16 * rt + g, 16 * rt + g + 8};  // the thread's two pair rows
  const bool on[2] = {geo[G_MASK * R + jh[0]] != 0.f, geo[G_MASK * R + jh[1]] != 0.f};
  bf162 dir2[2][3];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c3 = 0; c3 < 3; ++c3) dir2[h][c3] = dirw[c3 * R + jh[h]];
  for (int k = 0; k < 5; ++k) {
    bf162 p[PNT][2], q[PNT][2];
    float a[PNT][4];
    frag_zero(a);
    mma_rows<PNP, F / 16, 5 * FP>(a, a2p, F, 16 * rt, wmat(wpk, M_PHI3), k * FP + PNP * cb);
    frag_bias_pack(a, vecs + V_PHI + V_B3 + k * F + PCW * cb, p);
    frag_zero(a);
    mma_rows<PNP, F / 16, 5 * FP>(a, a2w, F, 16 * rt, wmat(wpk, M_W3), k * FP + PNP * cb);
    frag_bias_pack(a, vecs + V_W + V_B3 + k * F + PCW * cb, q);
    frag_store2(scr + k * 2 * RF, F, 16 * rt, PCW * cb, p);  // for the lane blocks, through L2
    frag_store2(scr + k * 2 * RF + RF, F, 16 * rt, PCW * cb, q);
#pragma unroll
    for (int nt = 0; nt < PNT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) p[nt][h] = on[h] ? mul2(p[nt][h], q[nt][h]) : zero2;  // h
    if (k == 0) {
      frag_store2(G, F, 16 * rt, PCW * cb, p);
#pragma unroll
      for (int nt = 0; nt < PNT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) gk[nt][h] = p[nt][h];
    } else if (k == 1) {  // Σ_j gates·v_j + scale_dir·dir
#pragma unroll
      for (int nt = 0; nt < PNT; ++nt) {
        const int col = PCW * cb + 8 * nt + 2 * t;
        float part[3][2] = {};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (jh[h] >= N) continue;
#pragma unroll
          for (int c3 = 0; c3 < 3; ++c3) {
            const bf162 vv = ldg_b2(v + (((size_t)b * 3 + c3) * N + jh[h]) * F + col);
            const float2 u = f2(add2(mul2(gk[nt][h], vv), mul2(p[nt][h], dir2[h][c3])));
            part[c3][0] += u.x;
            part[c3][1] += u.y;
          }
        }
        rows_sum_store<3>(part, wa, col);
      }
    } else if (k == 2) {  // Σ_j ds
#pragma unroll
      for (int nt = 0; nt < PNT; ++nt) {
        const float2 u0 = f2(p[nt][0]), u1 = f2(p[nt][1]);
        const float part[1][2] = {{u0.x + u1.x, u0.y + u1.y}};
        rows_sum_store<1>(part, wa + 3 * F, PCW * cb + 8 * nt + 2 * t);
      }
    } else if (k == 3) {  // e + de
#pragma unroll
      for (int nt = 0; nt < PNT; ++nt) {
        const int col = PCW * cb + 8 * nt + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (jh[h] >= N) continue;
          const bf162 ev = ldg_b2(e + (pair0 + jh[h]) * F + col);
          *reinterpret_cast<bf162*>(ep + (pair0 + jh[h]) * F + col) = add2(ev, p[nt][h]);
        }
      }
    } else {  // t_cg = Σ_j cross_gates·dir
#pragma unroll
      for (int nt = 0; nt < PNT; ++nt) {
        float part[3][2] = {};
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c3 = 0; c3 < 3; ++c3) {
            const float2 u = f2(mul2(p[nt][h], dir2[h][c3]));
            part[c3][0] += u.x;
            part[c3][1] += u.y;
          }
        rows_sum_store<3>(part, wa + 4 * F, PCW * cb + 8 * nt + 2 * t);
      }
    }
  }
  __syncthreads();
  float* acc = c.acc;
  const float* wacc = c.wacc;
  for (int idx = tid; idx < 7 * F; idx += NT) acc[idx] = wacc[idx] + wacc[7 * F + idx];
  __syncthreads();

  // dv_i = Σ_j(...) + (t_cg × v_i); ds_i
  float *dvp = c.dvp, *dsp = c.dsp;
  for (int f = tid; f < F; f += NT) {
    const float vx = tof(v[(((size_t)b * 3 + 0) * N + i) * F + f]);
    const float vy = tof(v[(((size_t)b * 3 + 1) * N + i) * F + f]);
    const float vz = tof(v[(((size_t)b * 3 + 2) * N + i) * F + f]);
    const float t0 = acc[4 * F + f], t1 = acc[5 * F + f], t2 = acc[6 * F + f];
    dvp[(((size_t)b * 3 + 0) * N + i) * F + f] = acc[f] + (t1 * vz - t2 * vy);
    dvp[(((size_t)b * 3 + 1) * N + i) * F + f] = acc[F + f] + (t2 * vx - t0 * vz);
    dvp[(((size_t)b * 3 + 2) * N + i) * F + f] = acc[2 * F + f] + (t0 * vy - t1 * vx);
    dsp[((size_t)b * N + i) * F + f] = acc[3 * F + f];
  }
}

// The parts of a lane block's fronts: all of them at F = 64, 128; at F = 256
// three, between the CTA barriers around the fetch of w's residuals into the
// stage: the input and phi's front; dPE and w's first product; w's
// LayerNorm tangents and second product.
enum { FR_ALL, FR_PHI, FR_W1, FR_W2 };

// The MLP fronts of lane block kb: geometry tangents, then both tangent
// chains of the warp's 16 stacked rows (rows jr0 .. jr0 + 15 of lane l's
// tile), replayed at the primal's residuals; the a2 tangents go to DAp, DAw.
// Only warp barriers: the warp touches its own rows of XB and DA. At F = 256
// the residuals of phi, then of w, are in the second p, q stage.
template <int PART>
__device__ __forceinline__ void lane_fronts(const Tile& c, int kb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int N = c.N, i = c.i;
  const int l = warp >> 1, row0 = 16 * warp, jr0 = 16 * (warp & 1);
  const size_t bk = (size_t)c.b * c.K + kb * c.L + l;
  const float* geo = c.geo;
  bf162* lg = c.lgw + 4 * l * R;
  bf16* XB = c.XB;
  const uint4* wpk = c.wpk;
  // at F = 256 h1p, h2p sit in the second p, q stage, and w's residuals are
  // fetched there after phi's front
  const bf16 *h1p = c.h1p, *h2p = c.h2p;
  const bf16 *h1w = SMEM_RES ? c.h1w : c.h1p, *h2w = SMEM_RES ? c.h2w : c.h2p;
  const bf16* pef = c.pef;
  bf16 *DAp = c.DAp, *DAw = c.DAw;
  const float *stat = c.stat, *lnv = c.lnv;

  if constexpr (PART == FR_ALL || PART == FR_PHI) {
  if (lane < 16) {
    const int j = jr0 + lane;
    float d0 = 0.f, d1 = 0.f, d2 = 0.f;
    if (j < N) {
      const float* dxb = c.dx + bk * N * 3;
      d0 = dxb[j * 3 + 0] - dxb[i * 3 + 0];
      d1 = dxb[j * 3 + 1] - dxb[i * 3 + 1];
      d2 = dxb[j * 3 + 2] - dxb[i * 3 + 2];
    }
    const float r0 = geo[G_R0 * R + j], r1 = geo[G_R1 * R + j], r2 = geo[G_R2 * R + j];
    const float inv = geo[G_INV * R + j];
    const float dd = (r0 * d0 + r1 * d1 + r2 * d2) * geo[G_SID * R + j];
    const float dinv = -(inv * inv) * dd;
    lg[0 * R + j] = both2(d0 * inv + r0 * dinv);
    lg[1 * R + j] = both2(d1 * inv + r1 * dinv);
    lg[2 * R + j] = both2(d2 * inv + r2 * dinv);
    lg[3 * R + j] = both2(dd);
  }
  const uint4 none = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (F == 64) {
    // din = [ds_j | de_ij]: a row is 16 16-byte chunks, a half-warp a row
    const int hl = lane & 15;
    const bf16* src = hl < 8 ? c.dsT + bk * N * F + 8 * hl
                             : c.deT + (bk * N + i) * N * F + 8 * (hl - 8);
    for (int rr = lane >> 4; rr < 16; rr += 2) {
      const int j = jr0 + rr;
      bf16* dst = XB + swz(row0 + rr, 8 * hl, 2 * F);
      if (j < N) cp_async16(dst, src + (size_t)j * F);
      else *reinterpret_cast<uint4*>(dst) = none;
    }
  } else if constexpr (F == 128) {
    // din = [ds_j | de_ij]: a row is 32 16-byte chunks, one a lane
    const bf16* src = lane < 16 ? c.dsT + bk * N * F + 8 * lane
                                : c.deT + (bk * N + i) * N * F + 8 * (lane - 16);
    for (int rr = 0; rr < 16; ++rr) {
      const int j = jr0 + rr;
      bf16* dst = XB + swz(row0 + rr, 8 * lane, 2 * F);
      if (j < N) cp_async16(dst, src + (size_t)j * F);
      else *reinterpret_cast<uint4*>(dst) = none;
    }
  } else {
    // a row is 64 16-byte chunks: lane takes chunk lane of ds_j and of de_ij
    const bf16* ds_src = c.dsT + bk * N * F + 8 * lane;
    const bf16* de_src = c.deT + (bk * N + i) * N * F + 8 * lane;
    for (int rr = 0; rr < 16; ++rr) {
      const int j = jr0 + rr;
      bf16* dst = XB + swz(row0 + rr, 8 * lane, 2 * F);
      bf16* dse = XB + swz(row0 + rr, F + 8 * lane, 2 * F);
      if (j < N) {
        cp_async16(dst, ds_src + (size_t)j * F);
        cp_async16(dse, de_src + (size_t)j * F);
      } else {
        *reinterpret_cast<uint4*>(dst) = none;
        *reinterpret_cast<uint4*>(dse) = none;
      }
    }
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncwarp();

  // phi's tangent front, replayed at h1p, h2p (at F = 256 its first product
  // goes to DAw, free until w's second: front_product there takes no out = A)
  bf16* H1 = SMEM_RES ? XB : DAw;
  const int ld1 = SMEM_RES ? 2 * F : F;
  front_product<2 * F / 16>(H1, ld1, XB, 2 * F, row0, wmat(wpk, M_PHI1));
  tile_ln_silu_tan(H1, ld1, row0, h1p, stat, lnv, lnv + F);
  front_product<F / 16>(DAp, F, H1, ld1, row0, wmat(wpk, M_PHI2));
  tile_ln_silu_tan(DAp, F, row0, h2p, stat + 2 * R, lnv + 2 * F, lnv + 3 * F);
  }
  if constexpr (PART == FR_ALL || PART == FR_W1) {
  // dPE = dPE/ddist * ddist, then w's tangent front at h1w, h2w
  for (int rr = 0; rr < 16; ++rr) {
    const int j = jr0 + rr;
    const bf162 dd2 = lg[3 * R + j];
    if constexpr (F == 64) {  // a lane 2 of the row's 64 columns
      sts_b2(XB, row0 + rr, 2 * lane, 2 * F, mul2(lds_b2(pef, j, 2 * lane, F), dd2));
    } else {
#pragma unroll
      for (int cc = 0; cc < F / 128; ++cc) {
        const int col = 128 * cc + 4 * lane;
        sts_b2(XB, row0 + rr, col, 2 * F, mul2(lds_b2(pef, j, col, F), dd2));
        sts_b2(XB, row0 + rr, col + 2, 2 * F, mul2(lds_b2(pef, j, col + 2, F), dd2));
      }
    }
  }
  __syncwarp();
  // at F = 256 w's first product goes to XB's second half, free since phi's front
  front_product<F / 16>(SMEM_RES ? XB : XB + F, 2 * F, XB, 2 * F, row0, wmat(wpk, M_W1));
  }
  if constexpr (PART == FR_ALL || PART == FR_W2) {
  bf16* W1o = SMEM_RES ? XB : XB + F;
  tile_ln_silu_tan(W1o, 2 * F, row0, h1w, stat + 4 * R, lnv + 4 * F, lnv + 5 * F);
  front_product<F / 16>(DAw, F, W1o, 2 * F, row0, wmat(wpk, M_W2));
  tile_ln_silu_tan(DAw, F, row0, h2w, stat + 6 * R, lnv + 6 * F, lnv + 7 * F);
  }
}

// Chunk k of the 5F product for the warp's lane l and its columns col0 ..
// col0 + 16 NPW: the lane's 32 rows (row q of the thread is j = g + 8 q).
// Each weight fragment feeds two row tiles; the product rule against the
// primal P, Q (shared memory); the sums over j end inside the warp.
template <int NPW>
__device__ __forceinline__ void lane_chunk(const Tile& c, int kb, int k, const bf16* P,
                                        const bf16* Q, int l, int col0) {
  constexpr int NTW = 2 * NPW;  // n-tiles of the warp
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int N = c.N, i = c.i, b = c.b;
  const size_t bk = (size_t)b * c.K + kb * c.L + l;
  const bf162 *lg = c.lgw + 4 * l * R, *dirw = c.dirw;
  float* wa = c.wacc + l * 7 * F;
  bf16* DG = c.XB;  // the gates tangent of the L lanes, stacked
  const bf16 *G = c.G, *v = c.v, *dvT = c.dvT, *deT = c.deT;
  bf16* et = c.et;
  const uint4* wpk = c.wpk;
  const bf162 zero2 = both2(0.f);

  float d[2][NTW][4];
  bf162 dp[2][NTW][2];  // [row tile][n-tile][row half]
  frag_zero(d[0]);
  frag_zero(d[1]);
  mma_rows2<NPW, F / 16, 5 * FP>(d[0], d[1], c.DAp, F, 32 * l, wmat(wpk, M_PHI3),
                                  k * FP + col0 / 16);
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      dp[r2][nt][0] = round2(d[r2][nt][0], d[r2][nt][1]);
      dp[r2][nt][1] = round2(d[r2][nt][2], d[r2][nt][3]);
    }
  frag_zero(d[0]);
  frag_zero(d[1]);
  mma_rows2<NPW, F / 16, 5 * FP>(d[0], d[1], c.DAw, F, 32 * l, wmat(wpk, M_W3),
                                  k * FP + col0 / 16);

  bool on[4], real[4];
  int jc[4];  // the row, or the last real one where the row is padding (loads stay in bounds)
  bf162 dir2[4][3], ddir2[4][3];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = g + 8 * q;
    on[q] = c.geo[G_MASK * R + j] != 0.f;
    real[q] = j < N;
    jc[q] = real[q] ? j : N - 1;
#pragma unroll
    for (int c3 = 0; c3 < 3; ++c3) {
      dir2[q][c3] = dirw[c3 * R + j];
      ddir2[q][c3] = lg[c3 * R + j];
    }
  }
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    const int col = col0 + 8 * nt + 2 * t;
    bf162 h[4], dh[4];  // [row]: columns col, col + 1
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = g + 8 * q;
      const bf162 pp = lds_b2(P, j, col, F), qq = lds_b2(Q, j, col, F);
      const bf162 dq = round2(d[q >> 1][nt][2 * (q & 1)], d[q >> 1][nt][2 * (q & 1) + 1]);
      h[q] = on[q] ? mul2(pp, qq) : zero2;
      dh[q] = on[q] ? add2(mul2(dp[q >> 1][nt][q & 1], qq), mul2(pp, dq)) : zero2;
    }
    if (k == 0) {  // read back at k == 1 by the same thread
#pragma unroll
      for (int q = 0; q < 4; ++q) sts_b2(DG, 32 * l + g + 8 * q, col, F, dh[q]);
    } else if (k == 1) {  // Σ_j dgates·v + gates·dv + dscale·dir + scale·ddir
      float part[3][2] = {};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bf162 dg = lds_b2(DG, 32 * l + g + 8 * q, col, F);
        const bf162 gg = lds_b2(G, g + 8 * q, col, F);
#pragma unroll
        for (int c3 = 0; c3 < 3; ++c3) {
          const bf162 vv = ldg_b2(v + (((size_t)b * 3 + c3) * N + jc[q]) * F + col);
          const bf162 dvv = ldg_b2(dvT + ((bk * 3 + c3) * N + jc[q]) * F + col);
          bf162 u = add2(mul2(dg, vv), mul2(gg, dvv));
          u = add2(u, mul2(dh[q], dir2[q][c3]));
          const float2 w = f2(add2(u, mul2(h[q], ddir2[q][c3])));
          part[c3][0] += real[q] ? w.x : 0.f;
          part[c3][1] += real[q] ? w.y : 0.f;
        }
      }
      rows_sum_store<3>(part, wa, col);
    } else if (k == 2) {  // Σ_j dds
      float part[1][2] = {};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 u = f2(dh[q]);
        part[0][0] += u.x;
        part[0][1] += u.y;
      }
      rows_sum_store<1>(part, wa + 3 * F, col);
    } else if (k == 3) {  // de + dde
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const size_t row = (bk * N + i) * N + jc[q];
        const bf162 out = add2(ldg_b2(deT + row * F + col), dh[q]);
        if (real[q]) *reinterpret_cast<bf162*>(et + row * F + col) = out;
      }
    } else {  // dt_cg = Σ_j dcg·dir + cg·ddir
      float part[3][2] = {};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c3 = 0; c3 < 3; ++c3) {
          const float2 w = f2(add2(mul2(dh[q], dir2[q][c3]), mul2(h[q], ddir2[q][c3])));
          part[c3][0] += w.x;
          part[c3][1] += w.y;
        }
      rows_sum_store<3>(part, wa + 4 * F, col);
    }
  }
}

// One 2 x R x F stage of p, q from the scratch buffer into shared memory
__device__ __forceinline__ void fetch_pq(bf16* stage, const bf16* src) {
  for (int c = 0; c < 2 * RF / (8 * NT); ++c)
    cp_async16(stage + 8 * (threadIdx.x + NT * c), src + 8 * (threadIdx.x + NT * c));
  cp_async_commit();
}

__global__ void __launch_bounds__(NT, 1)
pair_tangent_mma_kernel(const float* __restrict__ x, const bf16* __restrict__ s,
                        const bf16* __restrict__ v, const bf16* __restrict__ e,
                        const float* __restrict__ dx, const bf16* __restrict__ dsT,
                        const bf16* __restrict__ dvT, const bf16* __restrict__ deT,
                        const uint4* __restrict__ wpk, const float* __restrict__ vecs,
                        float* __restrict__ dvp, float* __restrict__ dsp, bf16* __restrict__ ep,
                        float* __restrict__ dvt, float* __restrict__ dst, bf16* __restrict__ et,
                        bf16* __restrict__ scratch, int N, int K, int L, float pe_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  Tile c;
  c.x = x, c.s = s, c.v = v, c.e = e, c.dx = dx, c.dsT = dsT, c.dvT = dvT, c.deT = deT;
  c.wpk = wpk, c.vecs = vecs, c.dvp = dvp, c.dsp = dsp, c.ep = ep, c.dvt = dvt, c.dst = dst;
  c.et = et, c.N = N, c.K = K, c.L = L, c.b = blockIdx.y, c.i = blockIdx.x, c.pe_scale = pe_scale;
  c.scr = scratch + ((size_t)c.b * N + c.i) * (SCR_TILES * RF);
  // shared memory: what does not depend on L first, at constant offsets
  bf16* base = reinterpret_cast<bf16*>(smem);
  if constexpr (SMEM_RES) {
    c.h1p = base, c.h2p = base + RF, c.a2p = base + 2 * RF, c.h1w = base + 3 * RF;
    c.h2w = base + 4 * RF, c.a2w = base + 5 * RF, c.pef = base + 6 * RF, c.G = base + 7 * RF;
    c.wacc = reinterpret_cast<float*>(base + 8 * RF);
  } else {  // the work buffers for MAX_L lanes, then dPE/ddist and the gates
    c.XB = base;
    c.DAp = c.XB + xb_tiles(MAX_L) * RF;
    c.DAw = c.DAp + MAX_L * RF;
    c.pef = c.DAw + MAX_L * RF, c.G = c.pef + RF;
    c.wacc = reinterpret_cast<float*>(c.G + RF);
    // the primal's other residuals, in the work buffers (its X, Y take XB's
    // first 3 tiles); h1p, h2p sit in the second p, q stage, where the first
    // lane block's fronts read them
    c.a2p = c.XB + 3 * RF, c.h1p = c.XB + 4 * RF, c.h2p = c.XB + 5 * RF;
    c.h1w = c.DAp, c.h2w = c.DAp + RF, c.a2w = c.DAw;
  }
  c.geo = c.wacc + MAX_L * 7 * F;
  c.dirw = reinterpret_cast<bf162*>(c.geo + G_DIR0 * R);
  c.lgw = reinterpret_cast<bf162*>(c.geo + NGEO * R);
  c.acc = c.geo + NGEO * R + 4 * MAX_L * R;
  c.stat = c.acc + 7 * F;
  c.lnv = c.stat + 4 * 2 * R;
  if constexpr (SMEM_RES) {
    c.XB = reinterpret_cast<bf16*>(c.wacc + SIDE_FLOATS);
    c.DAp = c.XB + xb_tiles(L) * RF;
    c.DAw = c.DAp + L * RF;
  }

  primal_phase(c);

  const bool active = warp < 2 * L;  // the warps that own stacked rows
  // XB in the chunk loop: DG | two stages of p | q
  bf16* PQ = c.XB + (SMEM_RES ? L : MAX_L) * RF;
  const int nblk = K / L;
  for (int kb = 0; kb < nblk; ++kb) {
    if constexpr (SMEM_RES) {
      if (active) lane_fronts<FR_ALL>(c, kb);
    } else {
      if (active) lane_fronts<FR_PHI>(c, kb);
      __syncthreads();  // phi's residuals are read: the stage takes w's
      fetch_pq(PQ + 2 * RF, c.scr + 12 * RF);
      if (active) lane_fronts<FR_W1>(c, kb);
      cp_async_wait_all();
      __syncthreads();
      if (active) lane_fronts<FR_W2>(c, kb);
    }
    __syncthreads();  // every front is done: XB becomes DG and the two stages of p, q
    fetch_pq(PQ, c.scr);
    for (int k = 0; k < 5; ++k) {
      cp_async_wait_all();
      __syncthreads();  // chunk k's p, q are in; chunk k - 1 is done with the other stage
      const bf16* P = PQ + (k & 1) * 2 * RF;
      if (k + 1 < 5) {
        fetch_pq(PQ + ((k + 1) & 1) * 2 * RF, c.scr + (k + 1) * 2 * RF);
      } else if constexpr (!SMEM_RES) {  // the next block's phi residuals, into the free stage
        if (kb + 1 < nblk) fetch_pq(PQ + 2 * RF, c.scr + 10 * RF);
      }
      if constexpr (SMEM_RES) {  // a lane's 32 rows, half the columns a warp
        if (active) lane_chunk<FP / 2>(c, kb, k, P, P + RF, warp >> 1, F / 2 * (warp & 1));
      } else {  // every warp, 32 columns a pass: at L = 2 4 warps a lane, two passes each
        const int wpl = NW / L;
        for (int col0 = 32 * (warp % wpl); col0 < F; col0 += 32 * wpl)
          lane_chunk<2>(c, kb, k, P, P + RF, warp / wpl, col0);
      }
    }
    if constexpr (!SMEM_RES) cp_async_wait_all();
    __syncthreads();

    // per lane outputs of dst atom i: dv with the chirality tangent, ds
    for (int idx = tid; idx < L * F; idx += NT) {
      const int ll = idx / F, f = idx % F;
      const size_t bkl = (size_t)c.b * K + kb * L + ll;
      const float *la = c.wacc + ll * 7 * F, *acc = c.acc;
      float vc[3], dvc[3];
#pragma unroll
      for (int c3 = 0; c3 < 3; ++c3) {
        vc[c3] = tof(v[(((size_t)c.b * 3 + c3) * N + c.i) * F + f]);
        dvc[c3] = tof(dvT[((bkl * 3 + c3) * N + c.i) * F + f]);
      }
      const float t0 = acc[4 * F + f], t1 = acc[5 * F + f], t2 = acc[6 * F + f];
      const float u0 = la[4 * F + f], u1 = la[5 * F + f], u2 = la[6 * F + f];
      const float dcx = u1 * vc[2] + t1 * dvc[2] - u2 * vc[1] - t2 * dvc[1];
      const float dcy = u2 * vc[0] + t2 * dvc[0] - u0 * vc[2] - t0 * dvc[2];
      const float dcz = u0 * vc[1] + t0 * dvc[1] - u1 * vc[0] - t1 * dvc[0];
      dvt[((bkl * 3 + 0) * N + c.i) * F + f] = la[f] + dcx;
      dvt[((bkl * 3 + 1) * N + c.i) * F + f] = la[F + f] + dcy;
      dvt[((bkl * 3 + 2) * N + c.i) * F + f] = la[2 * F + f] + dcz;
      dst[(bkl * N + c.i) * F + f] = la[3 * F + f];
    }
    // the next block writes wacc again only after more CTA barriers
  }
}

}  // namespace pk

// mats is the layer's matrices in fragment order (pack_mma_weights), bf16;
// scratch holds B * N * SCR_TILES tiles of R x F bf16 (the primal p, q of
// each CTA; at F = 256 also its pre-LN residuals).
extern "C" int pair_tangent_bf16(const void* x, const void* s, const void* v, const void* e,
                                 const void* dx, const void* ds, const void* dv, const void* de,
                                 const void* mats, const void* vecs, void* dvp, void* dsp,
                                 void* ep, void* dvt, void* dst, void* et, void* scratch, int B,
                                 int N, int K, int L, float pe_scale, void* stream) {
  using namespace pk;
  if (B < 1 || N < 2 || N > R || K < 1 || (L != 1 && L != 2 && L != MAX_L) || K % L)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tangent_mma_smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(pair_tangent_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pair_tangent_mma_kernel<<<dim3(N, B), NT, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const bf16*)s, (const bf16*)v, (const bf16*)e, (const float*)dx,
      (const bf16*)ds, (const bf16*)dv, (const bf16*)de, (const uint4*)mats, (const float*)vecs,
      (float*)dvp, (float*)dsp, (bf16*)ep, (float*)dvt, (float*)dst, (bf16*)et, (bf16*)scratch, N,
      K, L, pe_scale);
  return (int)cudaGetLastError();
}

extern "C" unsigned long long pair_tangent_mma_smem_bytes(int L) {
  return (unsigned long long)pk::tangent_mma_smem_bytes(L);
}
