// Kernel B1: one cPaiNN message layer on the dense pair grid, for Hopper (sm_90a).
//
// Replaces ti_tpu/ops/pair_layer_kernel.py::_pair_layer_kernel (the Pallas TPU
// kernel built by _build_pair_layer). Per chain and pair row p = i*N + j it
// computes the geometry, the positional encoding of dist, the two message MLPs
// phi([s_j | e_ij]) * w(PE), the diagonal mask, the Σ_j aggregations, the
// chirality term and e + de (device code in pair_common.cuh).
//
// What bounds it on this card: operations. One launch at B chains does
// 15F² multiply-adds per pair row (phi 8F², w 7F²) on B·N² rows — 22.7 GFLOP
// at 128 chains, N = 19, F = 128 — against about 50 MB of e in and e_out out
// in f32; at 67 TFLOP/s of f32 FMA that is 0.34 ms, over the 0.015 ms the
// bytes need at 3.35 TB/s. The layer's weights (0.98 MB in f32) do not fit in
// one CTA's shared memory.
//
// What the design does about it: one CTA per (dst atom i, chain b) holds all
// N source rows of that dst atom, padded to 32, so every Σ_j stays inside the
// CTA without atomics. All pair-grid intermediates (both MLPs' activations,
// the 5F product) live in shared memory and registers: the 5F product is
// formed one F-wide chunk at a time and consumed at once, so only e_out and
// the node outputs reach device memory. Weights stream from L2 through the
// read-only cache. This first version computes with f32 FMA on the CUDA
// cores; tensor cores (wgmma) and TMA are later work.

#include "pair_common.cuh"

namespace pk {

template <typename T>
__global__ void __launch_bounds__(NT, 2)
pair_layer_kernel(const float* __restrict__ x, const T* __restrict__ s, const T* __restrict__ v,
                  const T* __restrict__ e, const T* __restrict__ mats,
                  const float* __restrict__ vecs, float* __restrict__ dv, float* __restrict__ ds,
                  T* __restrict__ e_out, int N, float pe_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* X = reinterpret_cast<T*>(smem);
  T* Y = X + 2 * RF;
  float* red = reinterpret_cast<float*>(Y + RF);
  float* geo = red + NW * 3 * F;
  float* acc = geo + NGEO * R;
  Residuals<T> none = {};
  primal_layer<T, false>(blockIdx.y, blockIdx.x, N, pe_scale, x, s, v, e, mats, vecs, dv, ds,
                         e_out, X, Y, red, geo, acc, none);
}

template <typename T>
size_t smem_bytes() {
  return sizeof(T) * 3 * RF + sizeof(float) * (NW * 3 * F + NGEO * R + 7 * F);
}

template <typename T>
int launch(const void* x, const void* s, const void* v, const void* e, const void* mats,
           const void* vecs, void* dv, void* ds, void* e_out, int B, int N, float pe_scale,
           void* stream) {
  if (B < 1 || N < 2 || N > R) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(pair_layer_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pair_layer_kernel<T><<<dim3(N, B), NT, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const T*)s, (const T*)v, (const T*)e, (const T*)mats,
      (const float*)vecs, (float*)dv, (float*)ds, (T*)e_out, N, pe_scale);
  return (int)cudaGetLastError();
}

}  // namespace pk

extern "C" int pair_layer_f32(const void* x, const void* s, const void* v, const void* e,
                              const void* mats, const void* vecs, void* dv, void* ds,
                              void* e_out, int B, int N, float pe_scale, void* stream) {
  return pk::launch<float>(x, s, v, e, mats, vecs, dv, ds, e_out, B, N, pe_scale, stream);
}

extern "C" int pair_layer_bf16(const void* x, const void* s, const void* v, const void* e,
                               const void* mats, const void* vecs, void* dv, void* ds,
                               void* e_out, int B, int N, float pe_scale, void* stream) {
  return pk::launch<pk::bf16>(x, s, v, e, mats, vecs, dv, ds, e_out, B, N, pe_scale, stream);
}
