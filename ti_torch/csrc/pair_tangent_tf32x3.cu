// Kernel B3 in f32 on Hopper's tensor cores (sm_90a), in split-precision TF32
// ("3xTF32"): one cPaiNN message layer with K forward-mode probe lanes.
//
// Replaces ti_tpu/ops/pair_tangent_kernel.py::_pair_tangent_kernel (the Pallas
// TPU kernel built by _build_pair_tangent_layer) for f32 weights. It computes
// what pair_tangent.cu's f32 instantiation computes, with the same layouts:
// kernel B1's primal (dv, ds, e_out) and, for each lane, the layer's JVP
// under the lane's tangents of (x, s, v, e): dr -> ddist -> ddir and dPE,
// both MLP tangent chains replayed at the primal's pre-LN activations (f32
// LayerNorm statistics, eps 1e-5), the product rule dh = (dp q + p dq) mask,
// the sums over j, the chirality tangent and de + dde. pair_tangent.cu keeps
// the f32-FMA kernel (variant "fma") to be timed beside this one.
//
// What bounds it on this card: operations. 15 F^2 multiply-adds per pair row
// and pass, on B N^2 rows and 1 + K passes (1.317 TFLOP at 128 chains, N = 19,
// K = 57): 19.7 ms in f32 FMA at 67 TFLOP/s, 8.0 ms as three TF32 products
// at 495 TFLOP/s. The lane tangents in and out (about 3.3 GB) take 1 ms.
//
// What the design does about it:
// - every product is mma.sync.m16n8k8 in 3xTF32 (tf32_common.cuh::mma3_ahead:
//   B1's sums, the two small terms before the large one, two k-steps into a
//   fresh accumulator added in f32, with the next two k-steps' weight
//   fragments loaded ahead), over the weights split and packed once by
//   ops/pair_layer_kernel.pack_tf32_weights (which prepare applies to every
//   f32 layer). A warp owns 32 rows and 32 columns of a 64-row tile;
// - one CTA owns one (dst atom i, chain b), so the sums over the source atoms
//   j stay in the CTA: segmented sums in a fixed order, no atomics, and two
//   launches on the same inputs agree to the bit;
// - tight lane tiles. Stacked row l N + j of a 64-row tile is source atom j
//   of lane l; a tile takes T = 64 / N whole lanes (3 at N = 19: 57 rows,
//   where the f32-FMA kernel padded 19 rows to 32), the last tile of a
//   launch whatever lanes are left. Padding rows hold zeros, are skipped by a
//   warp whose 32 rows are all padding, and reach no output;
// - the primal once per CTA. It keeps the replay residuals in shared memory
//   (the pre-LN products of both MLPs with their LayerNorm statistics, and
//   dPE/ddist) and writes its 5F products p, q to a scratch buffer of the
//   CTA (10 N F floats, which stays in L2); each tile's chunk k of the 5F
//   product reads chunk k's p, q back with cp.async while its products run.
//   So each lane costs its 15 F^2, not the FMA kernel's 25 F^2;
// - the tangent LayerNorm runs on whole rows of the tile in shared memory,
//   a warp's own 8 rows at a time, at the primal statistics of the row's
//   source atom.
// Shared memory (219,392 bytes, tf32_smem_bytes): the stacked [ds | de]
// input (64 x 2F f32, reused by the fronts and, in the 5F chunks, by the dh
// tile and chunk k's p, q), the a2 tangents of both MLPs (2 x 64 x F), five
// residual tiles of 32 x F and the geometry. One CTA of 8 warps an SM, 248
// registers a thread, no spills. Only F = 128 is built.

#include "tf32_common.cuh"

namespace pk {
namespace tf32x3 {

// geometry of source atom j (arrays of TR floats; zero from row N on)
enum { P_R0, P_R1, P_R2, P_DIST, P_INV, P_SID, P_MASK, P_DIR0, P_DIR1, P_DIR2, PGEO };
// geometry tangents of a tile's stacked rows (arrays of TR floats)
enum { L_DDIR0, L_DDIR1, L_DDIR2, L_DDIST, LGEO };

constexpr int XB_F = TR * LDX;  // the stacked input tile
constexpr int DA_F = TR * F;    // an a2-tangent tile
constexpr int RES_F = R * F;    // a residual tile, one row a source atom
constexpr int NRES = 5;         // h1, h2 of phi and of w; dPE/ddist
constexpr int SIDE_F = (PGEO + LGEO) * TR + 4 * 2 * R + 3 * F + TR;
constexpr size_t TANGENT_SMEM = sizeof(float) * (size_t)(XB_F + 2 * DA_F + NRES * RES_F + SIDE_F);

// p = acc + bias into the warp's block of the swizzled F-wide tile T, and
// its rows below nrows into the scratch rows scr (row stride F)
__device__ __forceinline__ void acc_store_keep(float* T, int row0, int col0, const Acc& acc,
                                               const float* __restrict__ bias, float* scr,
                                               int nrows) {
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
        const float2 o = make_float2(acc[rt][p][2 * h] + bb.x, acc[rt][p][2 * h + 1] + bb.y);
        *reinterpret_cast<float2*>(T + swz(r, col, F)) = o;
        if (r < nrows) *reinterpret_cast<float2*>(scr + r * F + col) = o;
      }
  }
}

// q = acc + bias (its rows below nrows into scr), and h = p q mask in place
// over p in T (the same thread stored p there)
__device__ __forceinline__ void acc_gate_keep(float* T, int row0, int col0, const Acc& acc,
                                              const float* __restrict__ bias, const float* mask,
                                              float* scr, int nrows) {
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
        const float2 q = make_float2(acc[rt][p][2 * h] + bb.x, acc[rt][p][2 * h + 1] + bb.y);
        if (r < nrows) *reinterpret_cast<float2*>(scr + r * F + col) = q;
        float2* at = reinterpret_cast<float2*>(T + swz(r, col, F));
        const float2 pv = *at;
        *at = make_float2(pv.x * q.x * mask[r], pv.y * q.y * mask[r]);
      }
  }
}

__global__ void __launch_bounds__(NT, 1)
pair_tangent_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ s,
                           const float* __restrict__ v, const float* __restrict__ e,
                           const float* __restrict__ dx, const float* __restrict__ dsT,
                           const float* __restrict__ dvT, const float* __restrict__ deT,
                           const float* __restrict__ wpk, const float* __restrict__ vecs,
                           float* __restrict__ dvp, float* __restrict__ dsp,
                           float* __restrict__ ep, float* __restrict__ dvt,
                           float* __restrict__ dst, float* __restrict__ et,
                           float* __restrict__ scratch, int N, int K, float pe_scale) {
  extern __shared__ __align__(16) float smem[];
  float* XB = smem;                // [ds_j | de_ij] of a tile (row stride LDX); X1 | X2
  float* X1 = XB;                  // pre-LN products, then a2 (row stride LDX)
  float* X2 = XB + F;
  float* DH = XB;                  // in the 5F chunks: dh of the tile (row stride F)
  float* SP = XB + TR * F;         // ... and chunk k's primal p, q of the N atoms
  float* SQ = SP + R * F;
  float* DAp = XB + XB_F;          // a2 tangent of phi; in the primal PE, then h
  float* DAw = DAp + DA_F;         // a2 tangent of w
  float* H1P = DAw + DA_F;         // residuals, one row a source atom
  float* H2P = H1P + RES_F;
  float* H1W = H2P + RES_F;
  float* H2W = H1W + RES_F;
  float* PEF = H2W + RES_F;        // dPE/ddist
  float* geo = PEF + RES_F;        // PGEO x TR
  float* lgeo = geo + PGEO * TR;   // LGEO x TR
  float* stat = lgeo + LGEO * TR;  // per LayerNorm (h1p, h2p, h1w, h2w): mean (R), 1/std (R)
  float* tcg = stat + 8 * R;       // the primal's Σ_j cross_gates·dir (3F)
  int* rowj = reinterpret_cast<int*>(tcg + 3 * F);  // a tile's row -> source atom, or -1

  const int tid = threadIdx.x, warp = warp_id(), lane = lane_id();
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 32 * (warp & 1), col0 = 32 * (warp >> 1), nt0 = 4 * (warp >> 1);
  const int b = blockIdx.y, i = blockIdx.x;
  const size_t NN = (size_t)N * N;
  const size_t pair0 = ((size_t)b * N + i) * N;  // pair row (b, i, j = 0)
  float* scr = scratch + ((size_t)b * N + i) * (10 * (size_t)N * F);  // [chunk][p | q][N][F]
  const float *vp = vecs + V_PHI, *vw = vecs + V_W;
  const float* pmask = geo + P_MASK * TR;

  // ---- the primal: geometry of source atom j ----
  for (int r = tid; r < TR; r += NT) {
    float rv[3] = {0.f, 0.f, 0.f}, dist = 0.f, msk = 0.f;
    if (r < N) {
      const float* xb = x + (size_t)b * N * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) rv[c] = xb[r * 3 + c] - xb[i * 3 + c];
      dist = sqrtf(rv[0] * rv[0] + rv[1] * rv[1] + rv[2] * rv[2]);
      msk = r != i ? 1.f : 0.f;
    }
    const float inv = 1.f / (1.f + dist);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      geo[(P_R0 + c) * TR + r] = rv[c];
      geo[(P_DIR0 + c) * TR + r] = rv[c] * inv;
    }
    geo[P_DIST * TR + r] = dist;
    geo[P_INV * TR + r] = inv;
    geo[P_SID * TR + r] = dist > 0.f ? 1.f / fmaxf(dist, 1e-30f) : 0.f;
    geo[P_MASK * TR + r] = msk;
  }
  __syncthreads();

  // X = [s_j | e_ij], PE(dist) into DAp, dPE/ddist into PEF (interleaved
  // cos/sin, rank f/2 + 1); zero past row N
  for (int idx = tid; idx < TR * F / 4; idx += NT) {
    const int r = idx / (F / 4), f = 4 * (idx % (F / 4));
    float4 sv = make_float4(0.f, 0.f, 0.f, 0.f), ev = sv;
    if (r < N) {
      sv = __ldg(reinterpret_cast<const float4*>(s + ((size_t)b * N + r) * F + f));
      ev = __ldg(reinterpret_cast<const float4*>(e + (pair0 + r) * F + f));
    }
    *reinterpret_cast<float4*>(XB + swz(r, f, LDX)) = sv;
    *reinterpret_cast<float4*>(XB + swz(r, F + f, LDX)) = ev;
    const float dist = geo[P_DIST * TR + r];
    float pe[4], pd[4];
#pragma unroll
    for (int c = 0; c < 4; c += 2) {
      const float rank = (float)((f + c) / 2 + 1);
      float sn, cs;
      sincosf(dist * rank * pe_scale, &sn, &cs);
      pe[c] = cs;
      pe[c + 1] = sn;
      pd[c] = -sn * rank * pe_scale;
      pd[c + 1] = cs * rank * pe_scale;
    }
    *reinterpret_cast<float4*>(DAp + swz(r, f, F)) = make_float4(pe[0], pe[1], pe[2], pe[3]);
    if (r < R) *reinterpret_cast<float4*>(PEF + swz(r, f, F)) = make_float4(pd[0], pd[1], pd[2], pd[3]);
  }
  __syncthreads();

  // both fronts, keeping the pre-LN products and their statistics; the warps
  // whose 32 rows are all past N skip their products
  const bool primal_rows = row0 < N;
  Acc acc;
  acc_zero(acc);
  if (primal_rows) mma3_ahead<2 * F / 8, FN>(acc, XB, LDX, row0, wmat(wpk, M_PHI1), nt0);
  __syncthreads();  // every warp has read X
  acc_store(X1, LDX, row0, col0, acc, vp + V_B1);
  __syncthreads();
  ln_silu_keep(X1, LDX, H1P, stat, N, vp + V_LN1S, vp + V_LN1B);
  __syncthreads();
  acc_zero(acc);
  if (primal_rows) mma3_ahead<F / 8, FN>(acc, X1, LDX, row0, wmat(wpk, M_PHI2), nt0);
  acc_store(X2, LDX, row0, col0, acc, vp + V_B2);  // X2 was last read before the barriers above
  __syncthreads();
  ln_silu_keep(X2, LDX, H2P, stat + 2 * R, N, vp + V_LN2S, vp + V_LN2B);  // a2 of phi
  acc_zero(acc);
  if (primal_rows) mma3_ahead<F / 8, FN>(acc, DAp, F, row0, wmat(wpk, M_W1), nt0);
  __syncthreads();  // every warp has read PE
  acc_store(DAp, F, row0, col0, acc, vw + V_B1);
  __syncthreads();
  ln_silu_keep(DAp, F, H1W, stat + 4 * R, N, vw + V_LN1S, vw + V_LN1B);
  __syncthreads();
  acc_zero(acc);
  if (primal_rows) mma3_ahead<F / 8, FN>(acc, DAp, F, row0, wmat(wpk, M_W2), nt0);
  acc_store(X1, LDX, row0, col0, acc, vw + V_B2);  // X1 was last read by phi's second product
  __syncthreads();
  ln_silu_keep(X1, LDX, H2W, stat + 6 * R, N, vw + V_LN2S, vw + V_LN2B);  // a2 of w
  __syncthreads();

  // the 5F product chunk by chunk (gates | scale_dir | ds | de | cross_gates):
  // p, q to the scratch rows, h = p q mask into DAp, then the sums over j of
  // dst atom i (thread f owns column f in every chunk)
  for (int k = 0; k < 5; ++k) {
    float* sp = scr + (size_t)(2 * k) * N * F;
    acc_zero(acc);
    if (primal_rows) mma3_ahead<F / 8, 5 * FN>(acc, X2, LDX, row0, wmat(wpk, M_PHI3), k * FN + nt0);
    acc_store_keep(DAp, row0, col0, acc, vp + V_B3 + k * F, sp, N);
    acc_zero(acc);
    if (primal_rows) mma3_ahead<F / 8, 5 * FN>(acc, X1, LDX, row0, wmat(wpk, M_W3), k * FN + nt0);
    acc_gate_keep(DAp, row0, col0, acc, vw + V_B3 + k * F, pmask, sp + (size_t)N * F, N);
    __syncthreads();
    if (k == 3) {  // e + de
      for (int idx = tid; idx < N * (F / 4); idx += NT) {
        const int r = idx / (F / 4), f = 4 * (idx % (F / 4));
        const float4 ev = __ldg(reinterpret_cast<const float4*>(e + (pair0 + r) * F + f));
        const float4 h = *reinterpret_cast<const float4*>(DAp + swz(r, f, F));
        *reinterpret_cast<float4*>(ep + (pair0 + r) * F + f) =
            make_float4(ev.x + h.x, ev.y + h.y, ev.z + h.z, ev.w + h.w);
      }
    } else {
      for (int f = tid; f < F; f += NT) {
        float* dvq = dvp + ((size_t)b * 3 * N + i) * F + f;  // component c at dvq[c N F]
        if (k == 0) {  // Σ_j gates · v_j
          float a[3] = {0.f, 0.f, 0.f};
          for (int j = 0; j < N; ++j) {
            const float h = DAp[swz(j, f, F)];
#pragma unroll
            for (int c = 0; c < 3; ++c) a[c] += h * __ldg(v + (((size_t)b * 3 + c) * N + j) * F + f);
          }
#pragma unroll
          for (int c = 0; c < 3; ++c) dvq[(size_t)c * N * F] = a[c];
        } else if (k == 2) {  // Σ_j ds
          float a = 0.f;
          for (int j = 0; j < N; ++j) a += DAp[swz(j, f, F)];
          dsp[((size_t)b * N + i) * F + f] = a;
        } else {  // k = 1: + Σ_j scale_dir · dir_j; k = 4: + (Σ_j cross_gates · dir_j) x v_i
          float a[3] = {0.f, 0.f, 0.f};
          for (int j = 0; j < N; ++j) {
            const float h = DAp[swz(j, f, F)];
#pragma unroll
            for (int c = 0; c < 3; ++c) a[c] += h * geo[(P_DIR0 + c) * TR + j];
          }
          if (k == 4) {
            float vi[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              vi[c] = __ldg(v + (((size_t)b * 3 + c) * N + i) * F + f);
              tcg[c * F + f] = a[c];
            }
            const float t0 = a[0], t1 = a[1], t2 = a[2];
            a[0] = t1 * vi[2] - t2 * vi[1];
            a[1] = t2 * vi[0] - t0 * vi[2];
            a[2] = t0 * vi[1] - t1 * vi[0];
          }
#pragma unroll
          for (int c = 0; c < 3; ++c) dvq[(size_t)c * N * F] += a[c];
        }
      }
    }
    __syncthreads();  // DAp is free for the next chunk
  }

  // ---- the lanes, T a tile ----
  const int T = TR / N;
  for (int l0 = 0; l0 < K; l0 += T) {
    const int nl = min(T, K - l0), rows = nl * N;
    const bool real = row0 < rows;  // the warp's 32 rows are not all padding
    // din = [ds_j | de_ij] of each row's lane (cp.async); zero past the last real row
    for (int idx = tid; idx < TR * F / 4; idx += NT) {
      const int r = idx / (F / 4), f = 4 * (idx % (F / 4));
      float* xs = XB + swz(r, f, LDX);
      float* xe = XB + swz(r, F + f, LDX);
      if (r < rows) {
        const int l = r / N, j = r - l * N;
        const size_t bk = (size_t)b * K + l0 + l;
        cp_async16(xs, dsT + (bk * N + j) * F + f);
        cp_async16(xe, deT + (bk * NN + (size_t)i * N + j) * F + f);
      } else {
        *reinterpret_cast<float4*>(xs) = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(xe) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    cp_async_commit();
    // row r: lane l0 + r / N, source atom r % N; its geometry tangents, while the copies fly
    for (int r = tid; r < TR; r += NT) {
      int j = -1;
      float dd[3] = {0.f, 0.f, 0.f}, ddist = 0.f;
      if (r < rows) {
        const int l = r / N;
        j = r - l * N;
        const float* dxl = dx + ((size_t)b * K + l0 + l) * N * 3;
        float d[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) d[c] = dxl[j * 3 + c] - dxl[i * 3 + c];
        const float r0 = geo[P_R0 * TR + j], r1 = geo[P_R1 * TR + j], r2 = geo[P_R2 * TR + j];
        const float inv = geo[P_INV * TR + j];
        ddist = (r0 * d[0] + r1 * d[1] + r2 * d[2]) * geo[P_SID * TR + j];
        const float dinv = -(inv * inv) * ddist;
        dd[0] = d[0] * inv + r0 * dinv;
        dd[1] = d[1] * inv + r1 * dinv;
        dd[2] = d[2] * inv + r2 * dinv;
      }
      rowj[r] = j;
#pragma unroll
      for (int c = 0; c < 3; ++c) lgeo[(L_DDIR0 + c) * TR + r] = dd[c];
      lgeo[L_DDIST * TR + r] = ddist;
    }
    cp_async_wait_all();
    __syncthreads();
    // the source atom and mask of the thread's four accumulator rows
    int jr[2][2];
    float mr[2][2];
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        jr[rt][h] = rowj[row0 + 16 * rt + g + 8 * h];
        mr[rt][h] = jr[rt][h] >= 0 ? pmask[jr[rt][h]] : 0.f;
      }

    // phi's tangent front, replayed at h1p, h2p
    acc_zero(acc);
    if (real) mma3_ahead<2 * F / 8, FN>(acc, XB, LDX, row0, wmat(wpk, M_PHI1), nt0);
    __syncthreads();  // every warp has read the input
    acc_put(X1, LDX, row0, col0, acc);
    __syncthreads();
    ln_silu_tan_rows(X1, LDX, H1P, stat, rowj, vp + V_LN1S, vp + V_LN1B);
    __syncthreads();
    acc_zero(acc);
    if (real) mma3_ahead<F / 8, FN>(acc, X1, LDX, row0, wmat(wpk, M_PHI2), nt0);
    acc_put(DAp, F, row0, col0, acc);
    __syncthreads();  // every warp has read X1
    ln_silu_tan_rows(DAp, F, H2P, stat + 2 * R, rowj, vp + V_LN2S, vp + V_LN2B);
    // dPE = dPE/ddist * ddist into X1
    for (int idx = tid; idx < TR * F / 4; idx += NT) {
      const int r = idx / (F / 4), f = 4 * (idx % (F / 4)), j = rowj[r];
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j >= 0) {
        const float4 pd = *reinterpret_cast<const float4*>(PEF + swz(j, f, F));
        const float dd = lgeo[L_DDIST * TR + r];
        o = make_float4(pd.x * dd, pd.y * dd, pd.z * dd, pd.w * dd);
      }
      *reinterpret_cast<float4*>(X1 + swz(r, f, LDX)) = o;
    }
    __syncthreads();
    // w's tangent front, replayed at h1w, h2w
    acc_zero(acc);
    if (real) mma3_ahead<F / 8, FN>(acc, X1, LDX, row0, wmat(wpk, M_W1), nt0);
    __syncthreads();  // every warp has read dPE
    acc_put(X1, LDX, row0, col0, acc);
    __syncthreads();
    ln_silu_tan_rows(X1, LDX, H1W, stat + 4 * R, rowj, vw + V_LN1S, vw + V_LN1B);
    __syncthreads();
    acc_zero(acc);
    if (real) mma3_ahead<F / 8, FN>(acc, X1, LDX, row0, wmat(wpk, M_W2), nt0);
    acc_put(DAw, F, row0, col0, acc);
    __syncthreads();  // every warp has read X1: XB is free
    ln_silu_tan_rows(DAw, F, H2W, stat + 6 * R, rowj, vw + V_LN2S, vw + V_LN2B);
    __syncthreads();

    // the 5F chunks: dh = (dp q + p dq) mask into DH, then the sums over j of
    // each lane (thread idx owns lane idx / F, column idx % F in every chunk)
    for (int k = 0; k < 5; ++k) {
      const float* sp = scr + (size_t)(2 * k) * N * F;
      for (int idx = tid; idx < 2 * N * (F / 4); idx += NT) {  // chunk k's p, q: rows of sp
        const int row = idx / (F / 4), f = 4 * (idx % (F / 4)), j = row < N ? row : row - N;
        cp_async16((row < N ? SP : SQ) + swz(j, f, F), sp + (size_t)row * F + f);
      }
      cp_async_commit();
      acc_zero(acc);
      if (real) mma3_ahead<F / 8, 5 * FN>(acc, DAp, F, row0, wmat(wpk, M_PHI3), k * FN + nt0);
      cp_async_wait_all();
      __syncthreads();  // p, q are in
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int col = col0 + 8 * p + 2 * t;
#pragma unroll
        for (int rt = 0; rt < 2; ++rt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = jr[rt][h];
            float2 o = make_float2(0.f, 0.f);
            if (j >= 0) {
              const float2 q = *reinterpret_cast<const float2*>(SQ + swz(j, col, F));
              o = make_float2(acc[rt][p][2 * h] * q.x, acc[rt][p][2 * h + 1] * q.y);
            }
            *reinterpret_cast<float2*>(DH + swz(row0 + 16 * rt + g + 8 * h, col, F)) = o;
          }
      }
      acc_zero(acc);
      if (real) mma3_ahead<F / 8, 5 * FN>(acc, DAw, F, row0, wmat(wpk, M_W3), k * FN + nt0);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int col = col0 + 8 * p + 2 * t;
#pragma unroll
        for (int rt = 0; rt < 2; ++rt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = jr[rt][h];
            if (j < 0) continue;
            float2* at = reinterpret_cast<float2*>(DH + swz(row0 + 16 * rt + g + 8 * h, col, F));
            const float2 d = *at, pv = *reinterpret_cast<const float2*>(SP + swz(j, col, F));
            const float m = mr[rt][h];
            *at = make_float2((d.x + pv.x * acc[rt][p][2 * h]) * m,
                              (d.y + pv.y * acc[rt][p][2 * h + 1]) * m);
          }
      }
      __syncthreads();  // dh is in
      if (k == 3) {  // de + dde, on the real rows
        for (int idx = tid; idx < rows * (F / 4); idx += NT) {
          const int r = idx / (F / 4), f = 4 * (idx % (F / 4)), l = r / N, j = r - l * N;
          const size_t row = (((size_t)b * K + l0 + l) * N + i) * N + j;
          const float4 ev = __ldg(reinterpret_cast<const float4*>(deT + row * F + f));
          const float4 h = *reinterpret_cast<const float4*>(DH + swz(r, f, F));
          *reinterpret_cast<float4*>(et + row * F + f) =
              make_float4(ev.x + h.x, ev.y + h.y, ev.z + h.z, ev.w + h.w);
        }
      } else {
        for (int idx = tid; idx < nl * F; idx += NT) {
          const int l = idx / F, f = idx - l * F, r0 = l * N;
          const size_t bk = (size_t)b * K + l0 + l;
          float* dvq = dvt + (bk * 3 * N + i) * F + f;  // component c at dvq[c N F]
          if (k == 0) {  // Σ_j dgates · v_j + gates · dv_j
            float a[3] = {0.f, 0.f, 0.f};
            #pragma unroll 4
            for (int j = 0; j < N; ++j) {
              const float dg = DH[swz(r0 + j, f, F)];
              const float gt = SP[swz(j, f, F)] * SQ[swz(j, f, F)] * pmask[j];
#pragma unroll
              for (int c = 0; c < 3; ++c)
                a[c] += dg * __ldg(v + (((size_t)b * 3 + c) * N + j) * F + f) +
                        gt * __ldg(dvT + ((bk * 3 + c) * N + j) * F + f);
            }
#pragma unroll
            for (int c = 0; c < 3; ++c) dvq[(size_t)c * N * F] = a[c];
          } else if (k == 2) {  // Σ_j dds
            float a = 0.f;
            #pragma unroll 4
            for (int j = 0; j < N; ++j) a += DH[swz(r0 + j, f, F)];
            dst[(bk * N + i) * F + f] = a;
          } else {  // k = 1: Σ_j dscale·dir + scale·ddir; k = 4: the same of cg, then
                    // the chirality tangent dt_cg x v_i + t_cg x dv_i
            float a[3] = {0.f, 0.f, 0.f};
            #pragma unroll 4
            for (int j = 0; j < N; ++j) {
              const float dh = DH[swz(r0 + j, f, F)];
              const float hh = SP[swz(j, f, F)] * SQ[swz(j, f, F)] * pmask[j];
#pragma unroll
              for (int c = 0; c < 3; ++c)
                a[c] += dh * geo[(P_DIR0 + c) * TR + j] + hh * lgeo[(L_DDIR0 + c) * TR + r0 + j];
            }
            if (k == 4) {
              float vi[3], dvi[3], tc[3];
#pragma unroll
              for (int c = 0; c < 3; ++c) {
                vi[c] = __ldg(v + (((size_t)b * 3 + c) * N + i) * F + f);
                dvi[c] = __ldg(dvT + ((bk * 3 + c) * N + i) * F + f);
                tc[c] = tcg[c * F + f];
              }
              const float u0 = a[0], u1 = a[1], u2 = a[2];
              a[0] = u1 * vi[2] + tc[1] * dvi[2] - u2 * vi[1] - tc[2] * dvi[1];
              a[1] = u2 * vi[0] + tc[2] * dvi[0] - u0 * vi[2] - tc[0] * dvi[2];
              a[2] = u0 * vi[1] + tc[0] * dvi[1] - u1 * vi[0] - tc[1] * dvi[0];
            }
#pragma unroll
            for (int c = 0; c < 3; ++c) dvq[(size_t)c * N * F] += a[c];
          }
        }
      }
      __syncthreads();  // DH, SP, SQ are free for the next chunk
    }
  }
}

}  // namespace tf32x3
}  // namespace pk

// mats is the layer's matrices split into TF32 hi and lo parts in fragment
// order (ops/pair_layer_kernel.pack_tf32_weights, 2 x 15 F^2 f32 values);
// scratch holds B * N * 10 * N * F floats (each CTA's primal p, q).
extern "C" int pair_tangent_tf32x3(const void* x, const void* s, const void* v, const void* e,
                                   const void* dx, const void* ds, const void* dv,
                                   const void* de, const void* mats, const void* vecs,
                                   void* dvp, void* dsp, void* ep, void* dvt, void* dst,
                                   void* et, void* scratch, int B, int N, int K,
                                   float pe_scale, void* stream) {
  using namespace pk::tf32x3;
  if (B < 1 || N < 2 || N > pk::R || K < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(pair_tangent_tf32x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)TANGENT_SMEM);
  if (err != cudaSuccess) return (int)err;
  pair_tangent_tf32x3_kernel<<<dim3(N, B), pk::NT, TANGENT_SMEM, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)s, (const float*)v, (const float*)e, (const float*)dx,
      (const float*)ds, (const float*)dv, (const float*)de, (const float*)mats,
      (const float*)vecs, (float*)dvp, (float*)dsp, (float*)ep, (float*)dvt, (float*)dst,
      (float*)et, (float*)scratch, N, K, pe_scale);
  return (int)cudaGetLastError();
}

extern "C" unsigned long long pair_tangent_tf32x3_smem_bytes() {
  return (unsigned long long)pk::tf32x3::TANGENT_SMEM;
}

// lanes a 64-row tile takes at N atoms
extern "C" int pair_tangent_tf32x3_lanes(int N) { return pk::tf32x3::TR / N; }
