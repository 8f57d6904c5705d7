// Kernel B6 in f32 on Hopper's tensor cores (sm_90a), in split-precision TF32
// ("3xTF32"): one reference MLP (Dense-LN-SiLU x2 -> Dense) over row tiles.
//
// Replaces ti_tpu/ops/pallas_kernels.py::fused_mlp (the Pallas TPU kernel body
// _single_mlp_kernel) and computes what fused_mlp.cu computes: x (rows, f_in)
// -> Dense(F) -> LN-SiLU -> Dense(F) -> LN-SiLU -> Dense(f_out), LayerNorm with
// f32 statistics and eps 1e-5, in f32. In cpainn_fused.apply_fused it runs the
// combine (4F, or 3F in latent conditioning, -> F), update (2F -> 3F) and
// readout (F -> 2) MLPs on the B N node rows: 2432 rows at 128 chains and
// N = 19. fused_mlp.cu keeps the f32-FMA kernel (variant "fma") to be timed
// beside this one.
//
// What bounds it on this card: at 2432 rows, neither bytes nor operations but
// latency, with about one CTA an SM. The update MLP does (2F + F + 3F) F
// multiply-adds a row: 0.96 GFLOP, 0.0029 ms as three TF32 products at 495
// TFLOP/s; its rows in and out take 0.0021 ms at 3.35 TB/s. Every CTA that
// takes whole rows reads the whole MLP from L2, split into hi and lo (786 KB
// for the update or the combine).
//
// What the design does about it:
// - one 16-row tile a CTA, all F columns of both hidden Dense layers with 8
//   warps of 16 columns: 152 CTAs at 2432 rows, all resident at once at two
//   CTAs an SM. Tiles of 64 rows over thread-block clusters of 4 CTAs, each
//   computing a quarter of the columns and reading a quarter of the weights
//   (their LayerNorm rows gathered through distributed shared memory), and
//   of 32 rows over clusters of 2 were slower at every width: their cluster
//   barriers, gathers and LayerNorm of the whole row slice in every CTA cost
//   more than the weights they spare; 16 warps a CTA on 32-row tiles were no
//   faster (PERF.md section 6);
// - every product is mma.sync.m16n8k8 in 3xTF32 over the weights split and
//   packed once in fragment order by ops/pallas_kernels.pack_mlp (W1's rows
//   padded with zeros to a multiple of 16, W3's columns to a multiple of 8:
//   the readout's f_out = 2 is one n-tile), the A operand split by
//   truncation, two k-steps into a fresh accumulator added in f32 (as
//   tf32_common.cuh::mma3t_pair). The last Dense deals its n-tiles to the
//   warps up to 3 at a time. A warp's chains of dependent mma set the pace,
//   so the k-step loop is unrolled by two (one pair's products overlap the
//   next's) and the next two k-steps' weight fragments are loaded into
//   registers ahead; an L1 prefetch further ahead, and a fresh accumulator
//   for each k-step (shorter chains), measured slower;
// - each hidden Dense leaves its pre-LN rows (with the bias) in shared
//   memory, where LayerNorm -> SiLU runs in place (f32 statistics, a warp's
//   rows at once, their shuffle sums interleaved): the A tile of the next
//   Dense. Only the real rows and the f_out real columns are stored;
// - the input (f_in a multiple of 4, 16-byte aligned rows) arrives by
//   16-byte cp.async in 16 x 128 chunks, double-buffered (the buffers then
//   hold the two hidden activations), so no f_in needs a tile of it whole:
//   16,384 bytes of shared memory a CTA;
// - no atomics: two launches on the same inputs agree to the bit.
// Built at two widths from this file (PK_F, pair_common.cuh; ops/_build.py):
// F = 128 (library fused_mlp_tf32x3) as above, and F = 256 (library
// fused_mlp_tf32x3_f256, -DPK_F=256; the 10506 model's width). There the 8
// warps take 32 hidden columns each (four n-tiles a pass, the last Dense's
// n-tiles dealt 4 at a time where they come in 32s, as the update's 96 and
// the combine's 32), and the chunks are 256 columns wide, so that a chunk
// buffer still holds a hidden activation: 32,768 bytes of shared memory. The
// combine (4F = 1,024 in) arrives in four chunks, the update (2F = 512) in
// two. LayerNorm takes 2 rows a warp and 8 columns a lane. With four n-tiles
// a pass a thread needs more than 128 registers, so one CTA an SM (at 464 node
// rows, 16 chains of 29 atoms, 29 CTAs: latency, not the card's peak, sets
// the pace; the combine's bound is 0.0022 ms).

#include "tf32_common.cuh"

namespace pk {
namespace tf32x3 {

static_assert(F == 128 || F == 256, "B6 is built at F = 128 and 256");
constexpr int TM = 16;       // rows of a CTA's tile: one row tile of mma.m16n8k8
constexpr int KC = F;        // input columns staged a chunk: a chunk buffer holds a hidden activation
constexpr int WC = F / NW;   // hidden columns a warp: 16 at F = 128, 32 at F = 256
constexpr int NPW = WC / 8;  // their n-tiles
constexpr int CH = F / 128;  // 128-wide chunks of a row in the LayerNorms: lane l takes 128 c + 4 l ..
constexpr size_t MLP_SMEM = sizeof(float) * (size_t)(2 * TM * KC);
// CTAs an SM the launch bounds ask: two at F = 128 (at most 128 registers a
// thread); one at F = 256, where four n-tiles a pass spilled 28 bytes at 128
constexpr int MIN_CTAS = F == 256 ? 1 : 2;

// columns [kc, kc + KC) of rows r0 .. r0 + TM - 1 of x (row stride f_in, a
// multiple of 4; x 16-byte aligned) into the swizzled TM x KC tile S by
// cp.async; zero past f_in and from row nrows on (no commit)
__device__ __forceinline__ void stage_chunk(float* S, const float* __restrict__ x, int f_in,
                                            size_t r0, int nrows, int kc) {
  for (int idx = threadIdx.x; idx < TM * KC / 4; idx += NT) {
    const int r = idx / (KC / 4), f = 4 * (idx % (KC / 4)), col = kc + f;
    float* d = S + swz(r, f, KC);
    if (r < nrows && col < f_in)
      cp_async16(d, x + (r0 + r) * f_in + col);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

constexpr int NPM = F == 256 ? 4 : 3;  // n-tiles a warp takes at most in one pass over K
static_assert(NPW <= NPM, "a warp's hidden columns in one pass");
using AccR = float[NPM][4];   // acc[p][c]: row g + 8 (c / 2), column 8 p + 2 t + (c % 2)

// This thread's weight fragments of k-steps ks, ks + 1 for n-tiles nt0 ..
// nt0 + NP - 1 of a packed matrix of ntm n-tiles a k-step (wp already at nt0
// and the lane)
template <int NP>
__device__ __forceinline__ void load_b(uint4 (&b)[2][NPM], const uint4* __restrict__ wp, int ntm,
                                       int ks) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int p = 0; p < NP; ++p) b[h][p] = __ldg(wp + ((size_t)(ks + h) * ntm + p) * 32);
}

// acc += the products of two k-steps (A columns k0 .. k0 + 15, weight
// fragments b) for the tile's 16 rows and NP n-tiles, as
// tf32_common.cuh::mma3t_pair: A split by truncation, each n-tile's six
// products into a fresh accumulator, which is then added to acc in f32
template <int NP>
__device__ __forceinline__ void mma3t_rows(AccR& acc, const float* A, int lda, int k0,
                                           const uint4 (&b)[2][NPM]) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  uint32_t hi[2][4], lo[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = k0 + 8 * h + 2 * t;
    const float2 u = *reinterpret_cast<const float2*>(A + swz(g, k, lda));
    const float2 w = *reinterpret_cast<const float2*>(A + swz(g + 8, k, lda));
    const float a[4] = {u.x, w.x, u.y, w.y};  // (g, k), (g + 8, k), (g, k + 4), (g + 8, k + 4)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      hi[h][c] = __float_as_uint(a[c]) & 0xffffe000u;
      lo[h][c] = __float_as_uint(a[c] - __uint_as_float(hi[h][c]));
    }
  }
  float z[NPM][4] = {};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      mma_tf32(z[p], lo[h], b[h][p].x, b[h][p].y);  // a_lo b_hi
      mma_tf32(z[p], hi[h], b[h][p].z, b[h][p].w);  // a_hi b_lo
      mma_tf32(z[p], hi[h], b[h][p].x, b[h][p].y);  // a_hi b_hi
    }
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[p][c] += z[p][c];
}

// acc += A[0 .. 15][0 .. 8 ksteps) * W[8 ks0 .. 8 (ks0 + ksteps), n-tiles
// nt0 .. nt0 + NP - 1] (ksteps even): the next two k-steps' weight fragments
// are loaded into registers before the products of these two, and two
// k-step pairs are unrolled
template <int NP>
__device__ __forceinline__ void dense_rows(AccR& acc, const float* A, int lda, int ksteps,
                                           const uint4* __restrict__ W, int ntm, int ks0,
                                           int nt0) {
  const uint4* wp = W + (size_t)nt0 * 32 + lane_id();
  uint4 b[2][NPM];
  load_b<NP>(b, wp, ntm, ks0);
#pragma unroll 2
  for (int ks = 0; ks < ksteps; ks += 2) {
    uint4 nb[2][NPM];
    load_b<NP>(nb, wp, ntm, ks0 + (ks + 2 < ksteps ? ks + 2 : ks));
    mma3t_rows<NP>(acc, A, lda, 8 * ks, b);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int p = 0; p < NP; ++p) b[h][p] = nb[h][p];
  }
}

__device__ __forceinline__ void acc_clear(AccR& acc) {
#pragma unroll
  for (int p = 0; p < NPM; ++p)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[p][c] = 0.f;
}

// LayerNorm (f32 statistics, eps 1e-5) -> SiLU in place on the swizzled TM x F
// tile H: warp w takes rows RW w .. RW w + RW - 1 at once (their sums
// interleave), lane l columns 128 c + 4 l .. + 3 of each 128-wide chunk c;
// each row's sums are tf32_common.cuh::ln_silu_rows' at F = 128
__device__ __forceinline__ void ln_silu_tile(float* H, const float* __restrict__ scale,
                                             const float* __restrict__ bias) {
  constexpr int RW = TM / NW;
  const int lane = lane_id(), w = warp_id();
  float4 sc[CH], bi[CH], v[RW][CH];
  float mu[RW], ss[RW];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    sc[c] = __ldg(reinterpret_cast<const float4*>(scale + 128 * c + 4 * lane));
    bi[c] = __ldg(reinterpret_cast<const float4*>(bias + 128 * c + 4 * lane));
  }
#pragma unroll
  for (int rr = 0; rr < RW; ++rr)
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      v[rr][c] = *reinterpret_cast<const float4*>(H + swz(RW * w + rr, 128 * c + 4 * lane, F));
      const float s = v[rr][c].x + v[rr][c].y + v[rr][c].z + v[rr][c].w;
      mu[rr] = c ? mu[rr] + s : s;
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) mu[rr] += __shfl_xor_sync(0xffffffffu, mu[rr], o);
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    mu[rr] *= 1.f / F;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const float d0 = v[rr][c].x - mu[rr], d1 = v[rr][c].y - mu[rr], d2 = v[rr][c].z - mu[rr],
                  d3 = v[rr][c].w - mu[rr];
      const float s = d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3;
      ss[rr] = c ? ss[rr] + s : s;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) ss[rr] += __shfl_xor_sync(0xffffffffu, ss[rr], o);
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const float rstd = 1.f / sqrtf(ss[rr] * (1.f / F) + 1e-5f);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const float d0 = v[rr][c].x - mu[rr], d1 = v[rr][c].y - mu[rr], d2 = v[rr][c].z - mu[rr],
                  d3 = v[rr][c].w - mu[rr];
      *reinterpret_cast<float4*>(H + swz(RW * w + rr, 128 * c + 4 * lane, F)) =
          make_float4(silu(d0 * rstd * sc[c].x + bi[c].x), silu(d1 * rstd * sc[c].y + bi[c].y),
                      silu(d2 * rstd * sc[c].z + bi[c].z), silu(d3 * rstd * sc[c].w + bi[c].w));
    }
  }
}

// acc + bias into the warp's 16 x WC block at column col of the swizzled
// TM x F tile H (bias indexed by the column)
__device__ __forceinline__ void put_block(float* H, int col, const AccR& acc,
                                          const float* __restrict__ bias) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int p = 0; p < NPW; ++p) {
    const int c = col + 8 * p + 2 * t;
    const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + c));
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(H + swz(g + 8 * h, c, F)) =
          make_float2(acc[p][2 * h] + bb.x, acc[p][2 * h + 1] + bb.y);
  }
}

// acc + bias of n-tiles nt .. nt + NP - 1 of the last Dense to the real rows
// (below nrows) and real columns (below f_out) of out
template <int NP>
__device__ __forceinline__ void store_out(float* __restrict__ out, int f_out, size_t r0, int nrows,
                                          int nt, const AccR& acc, const float* __restrict__ b3) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int col = 8 * (nt + p) + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      if (r >= nrows) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (col + e < f_out) out[(r0 + r) * f_out + col + e] = acc[p][2 * h + e] + __ldg(b3 + col + e);
    }
  }
}

__global__ void __launch_bounds__(NT, MIN_CTAS)
fused_mlp_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ wpk,
                        const float* __restrict__ vecs, float* __restrict__ out, int rows,
                        int f_in, int k_pad, int f_out) {
  extern __shared__ __align__(16) float smem[];
  float* S0 = smem;               // input chunks 0, 2, ...; then the first hidden activation
  float* S1 = smem + TM * KC;     // input chunks 1, 3, ...; then the second
  const size_t r0 = (size_t)blockIdx.x * TM;
  const int nrows = min(TM, rows - (int)r0);
  const int warp = warp_id(), col = WC * warp;  // the warp's columns of the hidden Dense
  const uint4* W1 = reinterpret_cast<const uint4*>(wpk);
  const uint4* W2 = reinterpret_cast<const uint4*>(wpk + 2 * (size_t)k_pad * F);
  const uint4* W3 = reinterpret_cast<const uint4*>(wpk + 2 * (size_t)(k_pad + F) * F);
  AccR acc;

  // Dense 1 over the input in KC-column chunks, two in flight
  const int chunks = (k_pad + KC - 1) / KC;
  stage_chunk(S0, x, f_in, r0, nrows, 0);
  cp_async_commit();
  if (chunks > 1) stage_chunk(S1, x, f_in, r0, nrows, KC);
  cp_async_commit();
  acc_clear(acc);
#pragma unroll 1
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks)
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
      cp_async_wait_all();
    __syncthreads();
    float* S = (c & 1) ? S1 : S0;
    dense_rows<NPW>(acc, S, KC, min(KC, k_pad - c * KC) / 8, W1, FN, c * KC / 8, col / 8);
    __syncthreads();  // every warp has read S
    if (c + 2 < chunks) stage_chunk(S, x, f_in, r0, nrows, (c + 2) * KC);
    cp_async_commit();
  }
  put_block(S0, col, acc, vecs + V_B1);  // every chunk's copy has landed and been read
  __syncthreads();
  ln_silu_tile(S0, vecs + V_LN1S, vecs + V_LN1B);
  __syncthreads();

  // Dense 2
  acc_clear(acc);
  dense_rows<NPW>(acc, S0, F, F / 8, W2, FN, 0, col / 8);
  put_block(S1, col, acc, vecs + V_B2);  // S1 was last read in Dense 1
  __syncthreads();
  ln_silu_tile(S1, vecs + V_LN2S, vecs + V_LN2B);
  __syncthreads();

  // Dense 3: its n-tiles in groups of gs (NPM where they come in NW NPMs, as
  // the update's 48 at F = 128 and 96 at F = 256; else 2), dealt to the warps
  // in turn; a last group may hold one
  const int nt3 = (f_out + 7) / 8;
  const int gs = nt3 % (NW * NPM) == 0 ? NPM : 2;
#pragma unroll 1
  for (int nt = gs * warp; nt < nt3; nt += NW * gs) {
    acc_clear(acc);
    const int np = min(gs, nt3 - nt);
    if (np == NPM) {
      dense_rows<NPM>(acc, S1, F, F / 8, W3, nt3, 0, nt);
      store_out<NPM>(out, f_out, r0, nrows, nt, acc, vecs + V_B3);
    } else if (np == 2) {
      dense_rows<2>(acc, S1, F, F / 8, W3, nt3, 0, nt);
      store_out<2>(out, f_out, r0, nrows, nt, acc, vecs + V_B3);
    } else {
      dense_rows<1>(acc, S1, F, F / 8, W3, nt3, 0, nt);
      store_out<1>(out, f_out, r0, nrows, nt, acc, vecs + V_B3);
    }
  }
}

}  // namespace tf32x3
}  // namespace pk

// mats is the MLP's matrices split into TF32 hi and lo parts in fragment order
// (ops/pallas_kernels.pack_mlp: W1 with its rows padded to k_pad, a multiple
// of 16; W2; W3 with its columns padded to a multiple of 8), vecs the MLP's
// vectors as pack_mlp lays them out; one CTA a TM-row tile.
extern "C" int fused_mlp_tf32x3(const void* x, const void* mats, const void* vecs, void* out,
                                int rows, int f_in, int f_out, void* stream) {
  using namespace pk::tf32x3;
  if (rows < 1 || f_in < 1 || f_in % 4 || f_out < 1 || ((uintptr_t)x & 15))
    return (int)cudaErrorInvalidValue;
  const int k_pad = (f_in + 15) / 16 * 16;
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_tf32x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)MLP_SMEM);
  if (err != cudaSuccess) return (int)err;
  fused_mlp_tf32x3_kernel<<<(unsigned)((rows + TM - 1) / TM), pk::NT, MLP_SMEM,
                            (cudaStream_t)stream>>>(
      (const float*)x, (const float*)mats, (const float*)vecs, (float*)out, rows, f_in, k_pad,
      f_out);
  return (int)cudaGetLastError();
}

extern "C" unsigned long long fused_mlp_tf32x3_smem_bytes() {
  return (unsigned long long)pk::tf32x3::MLP_SMEM;
}

extern "C" int fused_mlp_tf32x3_rows() { return pk::tf32x3::TM; }

// CTAs of the kernel an SM can hold at once, as the card reports it (its
// registers and shared memory decide); negative: a CUDA error code
extern "C" int fused_mlp_tf32x3_ctas_per_sm() {
  using namespace pk::tf32x3;
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_tf32x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)MLP_SMEM);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fused_mlp_tf32x3_kernel, pk::NT,
                                                        MLP_SMEM);
  return err == cudaSuccess ? n : -(int)err;
}
