// Kernels B1 and B2: one cPaiNN message layer on the dense pair grid, for
// Hopper (sm_90a), with C chains per CTA (C = 1 is B1, C > 1 is B2).
//
// Replaces ti_tpu/ops/pair_layer_kernel.py::_pair_layer_kernel (B1) and
// ::_pair_layer_kernel_cb (B2, the chain-blocked kernel), the Pallas TPU
// kernels built by _build_pair_layer. Per chain and pair row p = i*N + j it
// computes the geometry, the positional encoding of dist, the two message MLPs
// phi([s_j | e_ij]) * w(PE), the diagonal mask, the Σ_j aggregations, the
// chirality term and e + de (device code in pair_common.cuh).
//
// What bounds it on this card: operations. One launch at B chains does
// 15F² multiply-adds per pair row (phi 8F², w 7F²) on B·N² rows — 22.7 GFLOP
// at 128 chains, N = 19, F = 128 — against about 50 MB of e in and e_out out
// in f32; at 67 TFLOP/s of f32 FMA that is 0.34 ms, over the 0.015 ms the
// bytes need at 3.35 TB/s. The layer's weights (0.98 MB in f32, 0.49 MB in
// bf16) do not fit in one CTA's shared memory.
//
// What the design does about it: a group of 256 threads serves one (dst atom
// i, chain b) and holds all N source rows of that dst atom, padded to 32, so
// every Σ_j stays inside the group without atomics. All pair-grid
// intermediates (both MLPs' activations, the 5F product) live in shared
// memory and registers: the 5F product is formed one F-wide chunk at a time
// and consumed at once, so only e_out and the node outputs reach device
// memory. Weights stream from L2 through the read-only cache.
//
// B2: a CTA holds C such groups, one per chain, for the same dst atom. Every
// group runs B1's code on its own slice of shared memory, so each chain's
// sums are B1's in B1's order; the CTA-wide barriers keep the C groups in
// step, so the C groups read each weight row at the same time and L1 serves
// it to all of them: a weight element fetched from L2 serves C x 32 pair rows
// instead of 32. What limits C: threads (256·C <= 1024, and at C = 4 the
// register file gives each thread 64 registers, so that version spills) and
// shared memory (54,016 bytes a chain in f32, where red aliases X's free half;
// 41,728 in bf16). The last block of a batch that C does not divide runs its
// idle groups on the last chain without storing anything.
//
// It computes with f32 FMA on the CUDA cores. Both types of B1 and B2 now run
// on the tensor cores (pair_layer_tf32x3.cu in f32, pair_layer_mma.cu in
// bf16_agg); this file is their variant "fma", kept to be timed beside them.

#include "pair_common.cuh"

namespace pk {

// red (NW x 3F f32) fits in X's second half (R x F of T) in f32 only
template <typename T>
__host__ __device__ constexpr bool red_in_x() {
  return sizeof(T) * RF >= sizeof(float) * NW * 3 * F;
}

// dynamic shared memory of one chain's group
template <typename T>
__host__ __device__ constexpr size_t group_smem_bytes() {
  return sizeof(T) * 3 * RF +
         sizeof(float) * ((red_in_x<T>() ? 0 : NW * 3 * F) + NGEO * R + 7 * F);
}

template <typename T, int C>
__global__ void __launch_bounds__(NT * C, C == 1 ? 2 : 1)
pair_layer_kernel(const float* __restrict__ x, const T* __restrict__ s, const T* __restrict__ v,
                  const T* __restrict__ e, const T* __restrict__ mats,
                  const float* __restrict__ vecs, float* __restrict__ dv, float* __restrict__ ds,
                  T* __restrict__ e_out, int B, int N, float pe_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = threadIdx.x / NT;  // this group's chain slot
  const int b = blockIdx.y * C + g;
  T* X = reinterpret_cast<T*>(smem + g * group_smem_bytes<T>());
  T* Y = X + 2 * RF;
  float* tail = reinterpret_cast<float*>(Y + RF);
  float* red = red_in_x<T>() ? reinterpret_cast<float*>(X + RF) : tail;
  float* geo = red_in_x<T>() ? tail : tail + NW * 3 * F;
  float* acc = geo + NGEO * R;
  Residuals<T> none = {};
  const bool live = C == 1 || b < B;  // a compile-time true in B1
  primal_layer<T, false>(live ? b : B - 1, blockIdx.x, N, pe_scale, x, s, v, e, mats, vecs, dv,
                         ds, e_out, X, Y, red, geo, acc, none, live);
}

template <typename T, int C>
int launch_c(const void* x, const void* s, const void* v, const void* e, const void* mats,
             const void* vecs, void* dv, void* ds, void* e_out, int B, int N, float pe_scale,
             void* stream) {
  const size_t smem = C * group_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(pair_layer_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pair_layer_kernel<T, C><<<dim3(N, (B + C - 1) / C), NT * C, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const T*)s, (const T*)v, (const T*)e, (const T*)mats,
      (const float*)vecs, (float*)dv, (float*)ds, (T*)e_out, B, N, pe_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* s, const void* v, const void* e, const void* mats,
           const void* vecs, void* dv, void* ds, void* e_out, int B, int N, int C,
           float pe_scale, void* stream) {
  if (B < 1 || N < 2 || N > R) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 1: return launch_c<T, 1>(x, s, v, e, mats, vecs, dv, ds, e_out, B, N, pe_scale, stream);
    case 2: return launch_c<T, 2>(x, s, v, e, mats, vecs, dv, ds, e_out, B, N, pe_scale, stream);
    case 3: return launch_c<T, 3>(x, s, v, e, mats, vecs, dv, ds, e_out, B, N, pe_scale, stream);
    case 4: return launch_c<T, 4>(x, s, v, e, mats, vecs, dv, ds, e_out, B, N, pe_scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace pk

extern "C" int pair_layer_f32(const void* x, const void* s, const void* v, const void* e,
                              const void* mats, const void* vecs, void* dv, void* ds,
                              void* e_out, int B, int N, int C, float pe_scale, void* stream) {
  return pk::launch<float>(x, s, v, e, mats, vecs, dv, ds, e_out, B, N, C, pe_scale, stream);
}

extern "C" int pair_layer_bf16(const void* x, const void* s, const void* v, const void* e,
                               const void* mats, const void* vecs, void* dv, void* ds,
                               void* e_out, int B, int N, int C, float pe_scale, void* stream) {
  return pk::launch<pk::bf16>(x, s, v, e, mats, vecs, dv, ds, e_out, B, N, C, pe_scale, stream);
}
