// Kernel B7 in f32 on Hopper's tensor cores (sm_90a), in split-precision TF32
// ("3xTF32"): the whole-network exact divergence of the dense-pair cPaiNN.
//
// Replaces ti_tpu/ops/div_kernel.py::_make_kernel (the Pallas TPU kernel run
// by _div_kernel_run) and computes what div_kernel.cu computes, with the same
// inputs and output: for each chain and chunk of L identity-basis lanes, the
// lanes' tangents through every message and update layer, the primal message
// MLPs recomputed in the kernel, and only the final node tangents d_v (3
// components) and d_s of each lane written. div_kernel.cu keeps the f32-FMA
// kernel (variant "fma") to be timed beside this one.
//
// What bounds it on this card: operations. Per chain and layer the primal
// message MLPs (15 F^2 multiply-adds per pair row), and per each of the 3N
// real lanes the w tangent (7 F^2) and, from layer 1 on, the phi tangent
// (8 F^2) over N^2 pair rows, plus 12 F^2 per lane and node in the update
// block: 6.17 TFLOP at 128 chains, N = 19, F = 128, 5 layers; 37.4 ms as three
// TF32 products at 495 TFLOP/s. The pair tangent d_e of every lane (N^2 F
// floats) is read and written once a layer: about 14 GB a launch from device
// memory, 4.2 ms at 3.35 TB/s.
//
// What the design does about it:
// - every product of the message layers is mma.sync.m16n8k8 in 3xTF32
//   (tf32_common.cuh::mma3_ahead: two k-steps into a fresh accumulator added
//   in f32, the next two k-steps' weight fragments loaded ahead) over the
//   weights split and packed once a call (ops/div_kernel.pack_tf32_stacks:
//   w's first matrix without the zero rows MLPStacks pads it with, the update
//   MLP's last without the 2F columns nothing reads). A warp owns 32 rows and
//   32 columns of a 64-row tile;
// - a CTA takes G chunks of one chain (G·L lanes; grid ceil(n_chunks / G)
//   x C) and walks layers, then dst atoms i. It computes the primal of
//   (layer, i) once for all its lanes: the replay residuals (pre-LN h1, h2 of
//   phi and w with their statistics, and dPE/ddist) stay in shared memory,
//   the 5F products p, q go to a scratch buffer of the CTA (10 N F floats,
//   in L2), read back chunk by chunk with cp.async;
// - tight lane tiles: stacked row l N + j of a 64-row tile is source atom j
//   of lane l, 64 // N whole lanes a tile (3 at N = 19: 57 rows), the last
//   tile of (layer, i) whatever lanes are left; padding rows are zero and a
//   warp whose 32 rows are all padding skips its products. The lanes from 3N
//   on (zero geometry, the padding of the last chunk) have zero tangents:
//   the kernel writes their output once and computes nothing for them;
// - the sums over j of each lane run in a fixed order inside the CTA, no
//   atomics: two launches agree to the bit. d_e lives in a global scratch
//   slice of the CTA, updated in place (rows (lane, i, j) belong to dst atom
//   i alone); the node tangents are double-buffered in global memory (the
//   output and a scratch of its shape), a barrier between layers;
// - the update block runs on the tensor cores as well, on 64-row tiles of
//   the CTA's (lane, node) rows: d_vv = d_v V, d_|vv|, the update MLP's
//   tangent replayed at its primal pre-LN h1, h2 (kept for the N nodes with
//   their statistics), d_v U, each a 3xTF32 product, and only the 3F output
//   columns the update uses (mma3, no look-ahead). It is a function of its
//   own (__noinline__): inlined, it took the kernel's register allocation
//   past 255 and the message phase ran 4-8% slower;
// Buffers that the kernel writes are read with plain loads or cp.async
// (through L2), never through the read-only cache.
// Shared memory (215,808 bytes, div_kernel_tf32x3_smem_bytes): the stacked
// [ds | de] input (64 x 2F f32, reused by the fronts and, in the 5F chunks,
// by the dh tile and chunk k's p, q), the a2 tangents of both MLPs (2 x 64 x
// F), five residual tiles of 32 x F and the geometry; the update block reuses
// it. One CTA of 8 warps an SM, 255 registers a thread (the kernel and its
// update-block function together), no spills. Only F = 128 is built.

#include "tf32_common.cuh"

namespace pk {
namespace tf32x3 {

// rows of the primal node quantities per layer (ops/div_kernel.NODE_ROWS)
enum { N_Q = 0, N_UV = 3, N_VV = 6, N_VVN = 9, N_H1 = 10, N_H2 = 11, N_GU = 12, N_SSQ = 13, N_ROWS = 14 };

// source-atom geometry of dst atom i (arrays of R floats; zero from row N on)
enum { S_MASK, S_DIR0, S_DIR1, S_DIR2, SGEO };
// geometry tangents of a tile's stacked rows (arrays of TR floats)
enum { D_DDIST, D_DDIR0, D_DDIR1, D_DDIR2, DGEO };

constexpr int DIV_XB_F = TR * LDX;  // the stacked input tile
constexpr int DIV_DA_F = TR * F;    // an a2-tangent tile
constexpr int DIV_RES_F = R * F;    // a residual tile, one row a source atom
constexpr int DIV_NRES = 5;         // h1, h2 of phi and of w; dPE/ddist
constexpr int DIV_TILES_F = DIV_XB_F + 2 * DIV_DA_F + DIV_NRES * DIV_RES_F;
constexpr int DIV_SIDE_F = SGEO * R + DGEO * TR + 8 * R + TR;
constexpr size_t DIV_SMEM = sizeof(float) * (size_t)(DIV_TILES_F + DIV_SIDE_F);
static_assert(5 * TR * F + 2 * R * F <= DIV_TILES_F, "the update block reuses the tiles");
// one layer of pack_tf32_stacks: after the message matrices (M_PHI1 .. M_W3 of
// pair_common.cuh) the update MLP's W1 (2F x F), W2, the first 3F columns of
// W3, then U and V (F x F each), at twice these offsets
constexpr size_t M_U1 = 15 * F * F, M_U2 = 17 * F * F, M_U3 = 18 * F * F;
constexpr size_t M_UK = 21 * F * F, M_VK = 22 * F * F;
constexpr size_t PACKED_LAYER = 2 * 23 * (size_t)F * F;

struct DivTcArgs {
  const float *s, *v, *e, *pe, *pep, *dir, *geom, *node;
  const float* wpk;  // every layer's matrices split for 3xTF32, PACKED_LAYER floats a layer
  const float *vecs, *b3;  // the stacks' vectors (ops/div_kernel.MLPStacks)
  float *out, *nodes, *de, *scratch;
  int C, N, SL, L, n_chunks, G;
};

// acc + bias, its rows below nrows into the scratch rows scr (row stride F)
__device__ __forceinline__ void acc_scratch(float* scr, int row0, int col0, const Acc& acc,
                                            const float* __restrict__ bias, int nrows) {
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
        if (r < nrows)
          *reinterpret_cast<float2*>(scr + r * F + col) =
              make_float2(acc[rt][p][2 * h] + bb.x, acc[rt][p][2 * h + 1] + bb.y);
      }
  }
}

// The update block of one layer on the tensor cores, in place on the node
// tangents nw (lanes, 4, N, F): rows l N + n of the CTA's lanes, 64 a tile.
// wl is the layer's packing, vu the update MLP's vectors, nd the layer's
// primal node quantities. Uses the tile memory: DV (3 x 64 x F, d_v_c of the
// tile's rows), X (64 x 2F, [d_|vv| | d_s], then the MLP's a1 tangent and,
// in place of d_s, its a2 tangent DA) and two residual tiles (the update
// MLP's pre-LN h1, h2 of the N nodes); stat and rown (a row's node, or -1)
// from the side arrays. Starts and ends with a barrier.
__device__ __noinline__ void update_block_tc(float* smem, float* stat, int* rown, float* nw,
                                const float* __restrict__ nd, const float* __restrict__ wl,
                                const float* __restrict__ vu, int N, int lanes) {
  float* DV = smem;
  float* X = DV + 3 * TR * F;
  float* HU1 = X + TR * LDX;
  float* HU2 = HU1 + R * F;
  const int tid = threadIdx.x, warp = warp_id(), lane = lane_id();
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 32 * (warp & 1), col0 = 32 * (warp >> 1), nt0 = 4 * (warp >> 1);
  const size_t NODE = (size_t)4 * N * F;

  __syncthreads();  // the message phase is done with the tile memory
  // the update MLP's pre-LN h1, h2 of the N nodes, and their statistics
  for (int hh = 0; hh < 2; ++hh) {
    for (int idx = tid; idx < N * F / 4; idx += NT) {
      const int n = idx / (F / 4), f = 4 * (idx % (F / 4));
      *reinterpret_cast<float4*>(DV + swz(n, f, F)) =
          __ldg(reinterpret_cast<const float4*>(nd + ((size_t)(N_H1 + hh) * N + n) * F + f));
    }
    __syncthreads();
    ln_silu_keep(DV, F, hh ? HU2 : HU1, stat + 2 * R * hh, N, vu + (hh ? V_LN2S : V_LN1S),
                 vu + (hh ? V_LN2B : V_LN1B));
    __syncthreads();
  }

  const int rows_all = lanes * N;
  for (int r0 = 0; r0 < rows_all; r0 += TR) {
    const int rows = min(TR, rows_all - r0);
    const bool real = row0 < rows;
    // d_v_c and d_s of each row (cp.async); zero past the last real row
    for (int idx = tid; idx < TR * F / 4; idx += NT) {
      const int r = idx / (F / 4), f = 4 * (idx % (F / 4));
      float* xs = X + swz(r, F + f, LDX);
      if (r < rows) {
        const int q = r0 + r, l = q / N, n = q - l * N;
        const float* o = nw + (size_t)l * NODE + (size_t)n * F + f;
#pragma unroll
        for (int c = 0; c < 3; ++c) cp_async16(DV + c * TR * F + swz(r, f, F), o + (size_t)c * N * F);
        cp_async16(xs, o + (size_t)3 * N * F);
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          *reinterpret_cast<float4*>(DV + c * TR * F + swz(r, f, F)) = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(xs) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    cp_async_commit();
    for (int r = tid; r < TR; r += NT) rown[r] = r < rows ? (r0 + r) % N : -1;
    cp_async_wait_all();
    __syncthreads();

    // d_|vv| = Σ_c vv_c · (d_v_c V) / |vv|, kept in dn and put in X's first half
    Acc dn, acc;
    acc_zero(dn);
    for (int c = 0; c < 3; ++c) {
      acc_zero(acc);
      if (real) mma3<F / 8, FN>(acc, DV + c * TR * F, F, row0, wmat(wl, M_VK), nt0);
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int rt = 0; rt < 2; ++rt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = rown[row0 + 16 * rt + g + 8 * h];
            if (n < 0) continue;
            const float2 vv = __ldg(reinterpret_cast<const float2*>(
                nd + ((size_t)(N_VV + c) * N + n) * F + col0 + 8 * p + 2 * t));
            dn[rt][p][2 * h] += vv.x * acc[rt][p][2 * h];
            dn[rt][p][2 * h + 1] += vv.y * acc[rt][p][2 * h + 1];
          }
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int rt = 0; rt < 2; ++rt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = rown[row0 + 16 * rt + g + 8 * h];
          if (n < 0) continue;
          const float2 vn = __ldg(reinterpret_cast<const float2*>(
              nd + ((size_t)N_VVN * N + n) * F + col0 + 8 * p + 2 * t));
          dn[rt][p][2 * h] /= vn.x;
          dn[rt][p][2 * h + 1] /= vn.y;
        }
    acc_put(X, LDX, row0, col0, dn);
    __syncthreads();

    // the update MLP's tangent front on [d_|vv| | d_s], replayed at h1, h2;
    // its a2 tangent DA goes to X's second half (d_s is read again from nw)
    acc_zero(acc);
    if (real) mma3<2 * F / 8, FN>(acc, X, LDX, row0, wmat(wl, M_U1), nt0);
    __syncthreads();  // every warp has read X
    acc_put(X, LDX, row0, col0, acc);
    __syncthreads();
    ln_silu_tan_rows(X, LDX, HU1, stat, rown, vu + V_LN1S, vu + V_LN1B);
    __syncthreads();
    acc_zero(acc);
    if (real) mma3<F / 8, FN>(acc, X, LDX, row0, wmat(wl, M_U2), nt0);
    acc_put(X + F, LDX, row0, col0, acc);
    __syncthreads();
    ln_silu_tan_rows(X + F, LDX, HU2, stat + 2 * R, rown, vu + V_LN2S, vu + V_LN2B);
    __syncthreads();

    // d_s += 2 |vv| d_|vv| scale_sq + |vv|² d_scale_sq + d_add_inv
    acc_zero(acc);
    if (real) mma3<F / 8, 3 * FN>(acc, X + F, LDX, row0, wmat(wl, M_U3), FN + nt0);
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int rt = 0; rt < 2; ++rt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = rown[row0 + 16 * rt + g + 8 * h];
          if (n < 0) continue;
          const size_t at = (size_t)n * F + col0 + 8 * p + 2 * t;
          const float2 vn = __ldg(reinterpret_cast<const float2*>(nd + (size_t)N_VVN * N * F + at));
          const float2 sq = __ldg(reinterpret_cast<const float2*>(nd + (size_t)N_SSQ * N * F + at));
          float* d = &dn[rt][p][2 * h];
          const float* ds = &acc[rt][p][2 * h];
          d[0] = 2.f * vn.x * d[0] * sq.x + vn.x * vn.x * ds[0];
          d[1] = 2.f * vn.y * d[1] * sq.y + vn.y * vn.y * ds[1];
        }
    acc_zero(acc);
    if (real) mma3<F / 8, 3 * FN>(acc, X + F, LDX, row0, wmat(wl, M_U3), 2 * FN + nt0);
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int rt = 0; rt < 2; ++rt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 16 * rt + g + 8 * h, n = rown[r];
          if (n < 0) continue;
          const int l = (r0 + r) / N;
          float2* at = reinterpret_cast<float2*>(nw + (size_t)l * NODE + ((size_t)3 * N + n) * F +
                                                 col0 + 8 * p + 2 * t);
          const float2 o = *at;
          *at = make_float2(o.x + dn[rt][p][2 * h] + acc[rt][p][2 * h],
                            o.y + dn[rt][p][2 * h + 1] + acc[rt][p][2 * h + 1]);
        }

    // d_v_c += d_g_u · uv_c + g_u · (d_v_c U)
    Acc& dgu = dn;
    acc_zero(dgu);
    if (real) mma3<F / 8, 3 * FN>(dgu, X + F, LDX, row0, wmat(wl, M_U3), nt0);
    for (int c = 0; c < 3; ++c) {
      acc_zero(acc);
      if (real) mma3<F / 8, FN>(acc, DV + c * TR * F, F, row0, wmat(wl, M_UK), nt0);
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int rt = 0; rt < 2; ++rt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = row0 + 16 * rt + g + 8 * h, n = rown[r];
            if (n < 0) continue;
            const int l = (r0 + r) / N, col = col0 + 8 * p + 2 * t;
            const size_t at = (size_t)n * F + col;
            const float2 uv = __ldg(reinterpret_cast<const float2*>(nd + (size_t)(N_UV + c) * N * F + at));
            const float2 gu = __ldg(reinterpret_cast<const float2*>(nd + (size_t)N_GU * N * F + at));
            const float2 dv = *reinterpret_cast<const float2*>(DV + c * TR * F + swz(r, col, F));
            *reinterpret_cast<float2*>(nw + (size_t)l * NODE + (size_t)c * N * F + at) =
                make_float2(dv.x + dgu[rt][p][2 * h] * uv.x + gu.x * acc[rt][p][2 * h],
                            dv.y + dgu[rt][p][2 * h + 1] * uv.y + gu.y * acc[rt][p][2 * h + 1]);
          }
    }
    __syncthreads();  // the tile memory is free for the next tile
  }
}

__global__ void __launch_bounds__(NT, 1) div_tf32x3_kernel(DivTcArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* XB = smem;                     // [ds_j | de_ij] of a tile (row stride LDX); X1 | X2
  float* X1 = XB;                       // pre-LN products, then a2 (row stride LDX)
  float* X2 = XB + F;
  float* DH = XB;                       // in the 5F chunks: dh of the tile (row stride F)
  float* SP = XB + TR * F;              // ... and chunk k's primal p, q of the N atoms
  float* SQ = SP + R * F;
  float* DAp = XB + DIV_XB_F;           // a2 tangent of phi; in the primal PE, then w's a1
  float* DAw = DAp + DIV_DA_F;          // a2 tangent of w
  float* H1P = DAw + DIV_DA_F;          // residuals, one row a source atom
  float* H2P = H1P + DIV_RES_F;
  float* H1W = H2P + DIV_RES_F;
  float* H2W = H1W + DIV_RES_F;
  float* PEF = H2W + DIV_RES_F;         // dPE/ddist
  float* sgeo = smem + DIV_TILES_F;     // SGEO x R
  float* dgeo = sgeo + SGEO * R;        // DGEO x TR
  float* stat = dgeo + DGEO * TR;       // per LayerNorm (h1p, h2p, h1w, h2w): mean (R), 1/std (R)
  int* rowj = reinterpret_cast<int*>(stat + 8 * R);  // a tile's row -> source atom, or -1

  const int tid = threadIdx.x, warp = warp_id(), lane = lane_id();
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 32 * (warp & 1), col0 = 32 * (warp >> 1), nt0 = 4 * (warp >> 1);
  const int N = a.N, SL = a.SL, b = blockIdx.y, T = TR / N;
  const int LP = a.n_chunks * a.L;
  const int lb = blockIdx.x * a.G * a.L;            // the CTA's first lane of chain b
  const int nl = min(a.G * a.L, LP - lb);           // its lanes
  const int nreal = min(nl, 3 * N - lb);          // those before the padding (at least 1)
  const size_t NN = (size_t)N * N, NODE = (size_t)4 * N * F;
  const size_t lane0 = (size_t)b * LP + lb;  // the CTA's first lane of all chains'
  // base pointers are recomputed from the arguments where used, not kept in
  // registers through the products
#define DE(lc) (a.de + ((lane0 + (lc)) * NN + pi) * F)  // lane lc's d_e rows (i, j = 0 ..)
#define SCR (a.scratch + ((size_t)b * gridDim.x + blockIdx.x) * (10 * (size_t)N * F))
  const float* pmask = sgeo + S_MASK * R;

  // the padded lanes' tangents are zero
  for (size_t idx = (size_t)nreal * NODE + 4 * tid; idx < (size_t)nl * NODE; idx += 4 * NT)
    *reinterpret_cast<float4*>(a.out + lane0 * NODE + idx) = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int ly = 0; ly < SL; ++ly) {
    const bool last = (SL - 1 - ly) % 2 == 0;  // the last layer writes the output
    float* nw = (last ? a.out : a.nodes) + lane0 * NODE;
    const float* od = (last ? a.nodes : a.out) + lane0 * NODE;  // the previous layer's; unread at layer 0
    const bool first = ly == 0;
    const size_t cl = (size_t)b * SL + ly;
    const float* wl = a.wpk + (size_t)ly * PACKED_LAYER;
    const float* vp = a.vecs + (size_t)(3 * ly) * 6 * F;  // phi's b1 .. ln2 bias; w's follow
    const float* vw = vp + 6 * F;
    const float* bp = a.b3 + (size_t)(3 * ly) * 5 * F;
    const float* bw = bp + 5 * F;

    for (int i = 0; i < N; ++i) {
      const size_t pi = (size_t)i * N;  // pair row (i, j = 0)
      // ---- the primal of (layer, dst atom i): geometry of source atom j ----
      for (int r = tid; r < R; r += NT) {
        float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < N) d = __ldg(reinterpret_cast<const float4*>(a.dir + ((size_t)b * NN + pi + r) * 4));
        sgeo[S_MASK * R + r] = r < N && r != i ? 1.f : 0.f;
        sgeo[S_DIR0 * R + r] = d.x;
        sgeo[S_DIR1 * R + r] = d.y;
        sgeo[S_DIR2 * R + r] = d.z;
      }
      // X = [s_j | e_ij], PE into DAp, dPE/ddist into PEF; zero past row N
      for (int idx = tid; idx < TR * F / 4; idx += NT) {
        const int r = idx / (F / 4), f = 4 * (idx % (F / 4));
        float4 sv = make_float4(0.f, 0.f, 0.f, 0.f), ev = sv, pv = sv, dv = sv;
        if (r < N) {
          sv = __ldg(reinterpret_cast<const float4*>(a.s + (cl * N + r) * F + f));
          ev = __ldg(reinterpret_cast<const float4*>(a.e + (cl * NN + pi + r) * F + f));
          pv = __ldg(reinterpret_cast<const float4*>(a.pe + ((size_t)b * NN + pi + r) * F + f));
          dv = __ldg(reinterpret_cast<const float4*>(a.pep + ((size_t)b * NN + pi + r) * F + f));
        }
        *reinterpret_cast<float4*>(XB + swz(r, f, LDX)) = sv;
        *reinterpret_cast<float4*>(XB + swz(r, F + f, LDX)) = ev;
        *reinterpret_cast<float4*>(DAp + swz(r, f, F)) = pv;
        if (r < R) *reinterpret_cast<float4*>(PEF + swz(r, f, F)) = dv;
      }
      __syncthreads();

      // both fronts, keeping the pre-LN products and their statistics; the
      // warps whose 32 rows are all past N skip their products
      const bool primal_rows = row0 < N;
      Acc acc;
      acc_zero(acc);
      if (primal_rows) mma3_ahead<2 * F / 8, FN>(acc, XB, LDX, row0, wmat(wl, M_PHI1), nt0);
      __syncthreads();  // every warp has read X
      acc_store(X1, LDX, row0, col0, acc, vp + V_B1);
      __syncthreads();
      ln_silu_keep(X1, LDX, H1P, stat, N, vp + V_LN1S, vp + V_LN1B);
      __syncthreads();
      acc_zero(acc);
      if (primal_rows) mma3_ahead<F / 8, FN>(acc, X1, LDX, row0, wmat(wl, M_PHI2), nt0);
      acc_store(X2, LDX, row0, col0, acc, vp + V_B2);  // X2 was last read before the barriers above
      __syncthreads();
      ln_silu_keep(X2, LDX, H2P, stat + 2 * R, N, vp + V_LN2S, vp + V_LN2B);  // a2 of phi
      acc_zero(acc);
      if (primal_rows) mma3_ahead<F / 8, FN>(acc, DAp, F, row0, wmat(wl, M_W1), nt0);
      __syncthreads();  // every warp has read PE
      acc_store(DAp, F, row0, col0, acc, vw + V_B1);
      __syncthreads();
      ln_silu_keep(DAp, F, H1W, stat + 4 * R, N, vw + V_LN1S, vw + V_LN1B);
      __syncthreads();
      acc_zero(acc);
      if (primal_rows) mma3_ahead<F / 8, FN>(acc, DAp, F, row0, wmat(wl, M_W2), nt0);
      acc_store(X1, LDX, row0, col0, acc, vw + V_B2);  // X1 was last read by phi's second product
      __syncthreads();
      ln_silu_keep(X1, LDX, H2W, stat + 6 * R, N, vw + V_LN2S, vw + V_LN2B);  // a2 of w
      __syncthreads();
      // the 5F products chunk by chunk: p, q of the N source atoms to the scratch
      for (int k = 0; k < 5; ++k) {
        float* sp = SCR + (size_t)(2 * k) * N * F;
        acc_zero(acc);
        if (primal_rows) mma3_ahead<F / 8, 5 * FN>(acc, X2, LDX, row0, wmat(wl, M_PHI3), k * FN + nt0);
        acc_scratch(sp, row0, col0, acc, bp + k * F, N);
        acc_zero(acc);
        if (primal_rows) mma3_ahead<F / 8, 5 * FN>(acc, X1, LDX, row0, wmat(wl, M_W3), k * FN + nt0);
        acc_scratch(sp + (size_t)N * F, row0, col0, acc, bw + k * F, N);
      }
      __syncthreads();  // p, q are in the scratch; XB is free

      // ---- the CTA's real lanes, T a tile ----
      for (int l0 = 0; l0 < nreal; l0 += T) {
        const int nlt = min(T, nreal - l0), rows = nlt * N;
        const bool real = row0 < rows;  // the warp's 32 rows are not all padding
        if (!first) {  // din = [d_s_j | d_e_ij] of each row's lane; zero past the last real row
          for (int idx = tid; idx < TR * F / 4; idx += NT) {
            const int r = idx / (F / 4), f = 4 * (idx % (F / 4));
            float* xs = XB + swz(r, f, LDX);
            float* xe = XB + swz(r, F + f, LDX);
            if (r < rows) {
              const int l = r / N, j = r - l * N, lc = l0 + l;
              cp_async16(xs, od + (size_t)lc * NODE + ((size_t)3 * N + j) * F + f);
              cp_async16(xe, DE(lc) + (size_t)j * F + f);
            } else {
              *reinterpret_cast<float4*>(xs) = make_float4(0.f, 0.f, 0.f, 0.f);
              *reinterpret_cast<float4*>(xe) = make_float4(0.f, 0.f, 0.f, 0.f);
            }
          }
          cp_async_commit();
        }
        // row r: lane l0 + r / N, source atom r % N; its geometry tangents
        for (int r = tid; r < TR; r += NT) {
          int j = -1;
          float4 g4 = make_float4(0.f, 0.f, 0.f, 0.f);
          if (r < rows) {
            const int l = r / N;
            j = r - l * N;
            g4 = __ldg(reinterpret_cast<const float4*>(a.geom + ((lane0 + l0 + l) * NN + pi + j) * 4));
          }
          rowj[r] = j;
          dgeo[D_DDIST * TR + r] = g4.x;
          dgeo[D_DDIR0 * TR + r] = g4.y;
          dgeo[D_DDIR1 * TR + r] = g4.z;
          dgeo[D_DDIR2 * TR + r] = g4.w;
        }
        cp_async_wait_all();
        __syncthreads();

        if (!first) {  // phi's tangent front, replayed at h1p, h2p
          acc_zero(acc);
          if (real) mma3_ahead<2 * F / 8, FN>(acc, XB, LDX, row0, wmat(wl, M_PHI1), nt0);
          __syncthreads();  // every warp has read the input
          acc_put(X1, LDX, row0, col0, acc);
          __syncthreads();
          ln_silu_tan_rows(X1, LDX, H1P, stat, rowj, vp + V_LN1S, vp + V_LN1B);
          __syncthreads();
          acc_zero(acc);
          if (real) mma3_ahead<F / 8, FN>(acc, X1, LDX, row0, wmat(wl, M_PHI2), nt0);
          acc_put(DAp, F, row0, col0, acc);
          __syncthreads();  // every warp has read X1
          ln_silu_tan_rows(DAp, F, H2P, stat + 2 * R, rowj, vp + V_LN2S, vp + V_LN2B);
        }
        // dPE = dPE/ddist * ddist into X1
        for (int idx = tid; idx < TR * F / 4; idx += NT) {
          const int r = idx / (F / 4), f = 4 * (idx % (F / 4)), j = rowj[r];
          float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
          if (j >= 0) {
            const float4 pd = *reinterpret_cast<const float4*>(PEF + swz(j, f, F));
            const float dd = dgeo[D_DDIST * TR + r];
            o = make_float4(pd.x * dd, pd.y * dd, pd.z * dd, pd.w * dd);
          }
          *reinterpret_cast<float4*>(X1 + swz(r, f, LDX)) = o;
        }
        __syncthreads();
        // w's tangent front, replayed at h1w, h2w
        acc_zero(acc);
        if (real) mma3_ahead<F / 8, FN>(acc, X1, LDX, row0, wmat(wl, M_W1), nt0);
        __syncthreads();  // every warp has read dPE
        acc_put(X1, LDX, row0, col0, acc);
        __syncthreads();
        ln_silu_tan_rows(X1, LDX, H1W, stat + 4 * R, rowj, vw + V_LN1S, vw + V_LN1B);
        __syncthreads();
        acc_zero(acc);
        if (real) mma3_ahead<F / 8, FN>(acc, X1, LDX, row0, wmat(wl, M_W2), nt0);
        acc_put(DAw, F, row0, col0, acc);
        __syncthreads();  // every warp has read X1: XB is free
        ln_silu_tan_rows(DAw, F, H2W, stat + 6 * R, rowj, vw + V_LN2S, vw + V_LN2B);
        __syncthreads();

        // the 5F chunks: dh = (dp q + p dq) mask into DH, then the sums over j of
        // each lane (thread idx owns lane idx / F, column idx % F in every chunk)
        for (int k = 0; k < 5; ++k) {
          const float* sp = SCR + (size_t)(2 * k) * N * F;
          for (int idx = tid; idx < 2 * N * (F / 4); idx += NT) {  // chunk k's p, q
            const int row = idx / (F / 4), f = 4 * (idx % (F / 4)), j = row < N ? row : row - N;
            cp_async16((row < N ? SP : SQ) + swz(j, f, F), sp + (size_t)row * F + f);
          }
          cp_async_commit();
          acc_zero(acc);
          if (real && !first)
            mma3_ahead<F / 8, 5 * FN>(acc, DAp, F, row0, wmat(wl, M_PHI3), k * FN + nt0);
          cp_async_wait_all();
          __syncthreads();  // p, q are in
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int col = col0 + 8 * p + 2 * t;
#pragma unroll
            for (int rt = 0; rt < 2; ++rt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int j = rowj[row0 + 16 * rt + g + 8 * h];  // the row's source atom, or -1
                float2 o = make_float2(0.f, 0.f);
                if (j >= 0) {
                  const float2 q = *reinterpret_cast<const float2*>(SQ + swz(j, col, F));
                  o = make_float2(acc[rt][p][2 * h] * q.x, acc[rt][p][2 * h + 1] * q.y);
                }
                *reinterpret_cast<float2*>(DH + swz(row0 + 16 * rt + g + 8 * h, col, F)) = o;
              }
          }
          acc_zero(acc);
          if (real) mma3_ahead<F / 8, 5 * FN>(acc, DAw, F, row0, wmat(wl, M_W3), k * FN + nt0);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int col = col0 + 8 * p + 2 * t;
#pragma unroll
            for (int rt = 0; rt < 2; ++rt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int j = rowj[row0 + 16 * rt + g + 8 * h];
                if (j < 0) continue;
                float2* at = reinterpret_cast<float2*>(DH + swz(row0 + 16 * rt + g + 8 * h, col, F));
                const float2 d = *at, pv = *reinterpret_cast<const float2*>(SP + swz(j, col, F));
                const float m = pmask[j];
                *at = make_float2((d.x + pv.x * acc[rt][p][2 * h]) * m,
                                  (d.y + pv.y * acc[rt][p][2 * h + 1]) * m);
              }
          }
          __syncthreads();  // dh is in
          if (k == 3) {  // d_e += dde, in place on the tile's real rows
            for (int idx = tid; idx < rows * (F / 4); idx += NT) {
              const int r = idx / (F / 4), f = 4 * (idx % (F / 4)), l = r / N, j = r - l * N;
              float4* at = reinterpret_cast<float4*>(DE(l0 + l) + (size_t)j * F + f);
              float4 h = *reinterpret_cast<const float4*>(DH + swz(r, f, F));
              if (!first) {
                const float4 o = *at;
                h = make_float4(h.x + o.x, h.y + o.y, h.z + o.z, h.w + o.w);
              }
              *at = h;
            }
          } else {
            const float* v = a.v + cl * 3 * N * F;
            for (int idx = tid; idx < nlt * F; idx += NT) {
              const int l = idx / F, f = idx - l * F, r0 = l * N;
              const float* odl = od + (size_t)(l0 + l) * NODE + f;  // (c, n) at odl[(c N + n) F]
              float* nwl = nw + (size_t)(l0 + l) * NODE + f;
              if (k == 0) {  // d_v_c = dv_i,c + Σ_j dgates · v_j,c + gates · dv_j,c
                float s3[3] = {0.f, 0.f, 0.f};
#pragma unroll 4
                for (int j = 0; j < N; ++j) {
                  const float dg = DH[swz(r0 + j, f, F)];
#pragma unroll
                  for (int c = 0; c < 3; ++c) s3[c] += dg * __ldg(v + ((size_t)c * N + j) * F + f);
                  if (!first) {
                    const float gt = SP[swz(j, f, F)] * SQ[swz(j, f, F)] * pmask[j];
#pragma unroll
                    for (int c = 0; c < 3; ++c) s3[c] += gt * odl[((size_t)c * N + j) * F];
                  }
                }
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                  const size_t at = ((size_t)c * N + i) * F;
                  nwl[at] = (first ? 0.f : odl[at]) + s3[c];
                }
              } else if (k == 2) {  // d_s = ds_i + Σ_j dds
                float s1 = 0.f;
#pragma unroll 4
                for (int j = 0; j < N; ++j) s1 += DH[swz(r0 + j, f, F)];
                const size_t at = ((size_t)3 * N + i) * F;
                nwl[at] = (first ? 0.f : odl[at]) + s1;
              } else {  // k = 1: + Σ_j dscale·dir + scale·ddir; k = 4: the same of cg,
                        // then the chirality tangent dq x v_i + q_i x dv_i
                float s3[3] = {0.f, 0.f, 0.f};
#pragma unroll 4
                for (int j = 0; j < N; ++j) {
                  const float dh = DH[swz(r0 + j, f, F)];
                  const float hh = SP[swz(j, f, F)] * SQ[swz(j, f, F)] * pmask[j];
#pragma unroll
                  for (int c = 0; c < 3; ++c)
                    s3[c] += dh * sgeo[(S_DIR0 + c) * R + j] + hh * dgeo[(D_DDIR0 + c) * TR + r0 + j];
                }
                if (k == 4) {
                  float vi[3], qi[3], dvi[3];
#pragma unroll
                  for (int c = 0; c < 3; ++c) {
                    vi[c] = __ldg(v + ((size_t)c * N + i) * F + f);
                    qi[c] = __ldg(a.node + ((cl * N_ROWS + N_Q + c) * N + i) * F + f);
                    dvi[c] = first ? 0.f : odl[((size_t)c * N + i) * F];
                  }
                  const float u0 = s3[0], u1 = s3[1], u2 = s3[2];
                  s3[0] = u1 * vi[2] + qi[1] * dvi[2] - u2 * vi[1] - qi[2] * dvi[1];
                  s3[1] = u2 * vi[0] + qi[2] * dvi[0] - u0 * vi[2] - qi[0] * dvi[2];
                  s3[2] = u0 * vi[1] + qi[0] * dvi[1] - u1 * vi[0] - qi[1] * dvi[0];
                }
#pragma unroll
                for (int c = 0; c < 3; ++c) nwl[((size_t)c * N + i) * F] += s3[c];
              }
            }
          }
          __syncthreads();  // DH, SP, SQ are free for the next chunk
        }
      }
    }
    // every dst atom of the layer is written: the update block on the node rows
    update_block_tc(smem, stat, rowj, nw, a.node + cl * N_ROWS * N * F, wl,
                    a.vecs + (size_t)(3 * ly + 2) * 6 * F, N, nreal);
  }
}

#undef DE
#undef SCR

}  // namespace tf32x3
}  // namespace pk

// wpk is ops/div_kernel.pack_tf32_stacks(stacks): per layer the message and
// update matrices split into TF32 hi and lo parts in fragment order (2 x 23
// F^2 floats); vecs and b3 are the stacks' own; scratch holds
// ceil(n_chunks / G) x C x 10 x N x F floats (each CTA's primal p, q).
// 1 <= G <= n_chunks.
extern "C" int div_kernel_tf32x3(const void* s, const void* v, const void* e, const void* pe,
                                 const void* pep, const void* dir, const void* geom,
                                 const void* node, const void* wpk, const void* vecs,
                                 const void* b3, void* out, void* nodes, void* de, void* scratch,
                                 int C, int N, int SL, int L, int n_chunks, int G, void* stream) {
  using namespace pk::tf32x3;
  if (C < 1 || C > 65535 || N < 2 || N > pk::R || SL < 1 || L < 1 || n_chunks < 1 || G < 1 ||
      G > n_chunks)
    return (int)cudaErrorInvalidValue;
  DivTcArgs a = {(const float*)s,    (const float*)v,   (const float*)e,    (const float*)pe,
                 (const float*)pep,  (const float*)dir, (const float*)geom, (const float*)node,
                 (const float*)wpk,  (const float*)vecs, (const float*)b3,  (float*)out,
                 (float*)nodes,      (float*)de,        (float*)scratch,    C,
                 N,                  SL,                L,                  n_chunks,
                 G};
  cudaError_t err = cudaFuncSetAttribute(div_tf32x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)DIV_SMEM);
  if (err != cudaSuccess) return (int)err;
  div_tf32x3_kernel<<<dim3((n_chunks + G - 1) / G, C), pk::NT, DIV_SMEM, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" unsigned long long div_kernel_tf32x3_smem_bytes() {
  return (unsigned long long)pk::tf32x3::DIV_SMEM;
}

// lanes a 64-row tile takes at N atoms
extern "C" int div_kernel_tf32x3_lanes(int N) { return pk::tf32x3::TR / N; }
