// Masked max over an ELL neighbour list of any width, for Hopper (sm_90a),
// with a plain C interface loaded through ctypes
// (mrp_gnn_tpu_torch/ops/ell.py::masked_max).
//
//   out[v] = max(-1e30, max over valid slots j of values[ell_src[v, j]])
//   out[v] = 0 when row v has no valid slot
//
// per feature, compared in f32, written in the values' type (f32 or bf16;
// a max does not round, so the result is one of the inputs). A NaN among
// the valid values gives NaN, as jnp.maximum does: fmaxf would drop it and
// hide a non-finite loss from the training loop's watchdog. Duplicate
// edges are harmless.
//
// Replaces: mrp_gnn_tpu/ops/pallas_ell.py::_max_kernel (launched by
// _max_forward, entry ell_max). The TPU kernel DMAs each slot's value row
// per destination tile into a double buffer and unrolls over the ELL width;
// here each block gathers its rows straight from ell_src, with no cap on
// the width.
//
// Bound: bytes. The function reads values, ell_src and ell_mask once and
// writes out once; at the dynamic_swarm shape (V 256, deg 32, D 8192, f32)
// that is 16.8 MB, 0.005 ms at 3.35 TB/s; one compare per edge and feature
// (14 MFLOP) is nothing beside it. The gathers read each value row once per
// in-edge (about 6.6 times), from the 50 MB L2.
//
// Design: one block per (destination row, chunk of the feature axis), as
// bsp_spmm.cu's row form. Warp 0 compacts the row's valid slots into shared
// memory, reading each slot's mask and source together, 128 slots at a
// time, so a row of any width needs only 512 bytes of shared memory; each
// thread streams its VEC features of every valid source row with 16-byte
// loads, two slots in flight, keeps a running max in registers and writes
// it as soon as its row is done: a row of at most 128 slots takes no
// barrier after its max. The other designs tried were slower at every
// shape on the card (PERF.md section 6 gives their times): a block of 32
// destinations that stages its tile's source window in shared memory by
// bulk copy (a third of the L2 bytes, behind two dependent round trips),
// bsp_spmm.cu's vector form (two 16-byte vectors a thread) and register
// caps of either (they spilled).

#include "bsp_common.cuh"

namespace {

using bsp::kMaxDeg;
using bsp::kNeg;
using bsp::VecIO;

// jnp.maximum: NaN if either operand is NaN.
__device__ __forceinline__ float max_nan(float acc, float x) {
  return (x > acc || x != x) ? x : acc;
}

// grid (V, feature chunks), block a multiple of 32 up to kMaxThreads.
template <typename T, int VEC>
__global__ void __launch_bounds__(bsp::kMaxThreads)
ell_max_kernel(const T* __restrict__ values, const int32_t* __restrict__ ell_src,
               const uint8_t* __restrict__ ell_mask, T* __restrict__ out,
               int deg, long long D) {
  __shared__ int32_t src_sh[kMaxDeg];
  __shared__ int n_sh;

  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const long long f0 =
      (static_cast<long long>(blockIdx.y) * blockDim.x + tid) * VEC;
  const bool active = f0 < D;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = kNeg;
  int total = 0;
  for (int j0 = 0; j0 < deg; j0 += kMaxDeg) {
    if (tid < 32) {
      const int n = bsp::compact_valid_slots(ell_src, ell_mask, row, deg,
                                             src_sh, nullptr, j0,
                                             j0 + kMaxDeg);
      if (tid == 0) n_sh = n;
    }
    __syncthreads();
    const int n = n_sh;
    total += n;
    if (active) {
#pragma unroll 2
      for (int s = 0; s < n; ++s) {
        float x[VEC];
        VecIO<T, VEC>::load(values + static_cast<long long>(src_sh[s]) * D + f0, x);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = max_nan(acc[i], x[i]);
      }
    }
    if (j0 + kMaxDeg < deg) __syncthreads();  // the next 128 slots follow
  }
  if (!active) return;
  if (total == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  }
  VecIO<T, VEC>::store(out + row * D + f0, acc);
}

template <typename T, int VEC>
cudaError_t launch(const void* values, const int32_t* ell_src,
                   const uint8_t* ell_mask, void* out, int V, int deg,
                   long long D, cudaStream_t stream) {
  const int threads = bsp::block_threads((D + VEC - 1) / VEC);
  const long long per_block = static_cast<long long>(threads) * VEC;
  const long long chunks = (D + per_block - 1) / per_block;
  if (chunks > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(V), static_cast<unsigned>(chunks));
  ell_max_kernel<T, VEC><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(values), ell_src, ell_mask, static_cast<T*>(out),
      deg, D);
  return cudaGetLastError();
}

}  // namespace

// values_bf16: 0 for f32 values and output, 1 for bf16. vec: 8 needs D a
// multiple of 8 and 16-byte aligned values and out; 1 takes any D. deg may
// be any width. Returns the CUDA error code of the launch (0 on success).
extern "C" int ell_max(const void* values, const int32_t* ell_src,
                       const uint8_t* ell_mask, void* out, int V, int deg,
                       long long D, int values_bf16, int vec, int device,
                       void* stream) {
  if (V <= 0 || D <= 0 || deg < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (values_bf16) {
    if (vec == 8) err = launch<__nv_bfloat16, 8>(values, ell_src, ell_mask, out, V, deg, D, s);
    else if (vec == 1) err = launch<__nv_bfloat16, 1>(values, ell_src, ell_mask, out, V, deg, D, s);
    else err = cudaErrorInvalidValue;
  } else {
    if (vec == 8) err = launch<float, 8>(values, ell_src, ell_mask, out, V, deg, D, s);
    else if (vec == 1) err = launch<float, 1>(values, ell_src, ell_mask, out, V, deg, D, s);
    else err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
