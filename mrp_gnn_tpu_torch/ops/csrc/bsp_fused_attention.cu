// One-pass fused graph attention over an ELL neighbour list, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (mrp_gnn_tpu_torch/ops/bsp.py).
//
//   out[v] = sum_j alpha[v, j] * values[ell_src[v, j]]
//   alpha[v, :] = masked softmax over j of <q_s[v], k[ell_src[v, j]]>
//
// q_s is pre-scaled by 1/sqrt(dk) in f32 by the caller; q and k are f32,
// values f32 or bf16; the output takes the values type, with f32 sums.
// A masked slot contributes nothing, a duplicate edge counts once per slot
// (its multiplicity), and a row with no valid slot gives 0.
//
// Replaces: mrp_gnn_tpu/ops/pallas_bsp.py::_fused_kernel (launched by
// _fused_forward, entry bsp_attention_fused). The TPU kernel walks a
// (dst tile, src tile) pair plan, selects edges with one-hot MXU products
// and carries an online (max, sum, acc) across each tile group; those are
// workarounds for Mosaic's whole-tile DMAs and 128-lane layout. Here each
// block gathers its rows straight from ell_src.
//
// Bound: at the serving shapes (V 256, deg 32, dk 64, D 8192) the work is
// memory-bound. The function must read values once (V*D) and write out once
// (V*D): 16.8 MB in f32, about 5 us at 3.35 TB/s. The logits and the sums
// are about 28 MFLOP, nothing beside that. The gathers read each value row
// once per in-edge (about 7x the values in total at deg ~6.6), but the
// values (8.4 MB) fit in the 50 MB L2, so most of those reads hit L2.
//
// Design against that bound: one block per (destination row, chunk of
// 256 threads x 16 bytes of features), the body in bsp_common.cuh
// (fused_attention_row). Each block compacts the row's valid
// slots into shared memory, computes their logits one warp per slot (q row
// in shared memory, k rows gathered), reduces max and sum in one warp and
// keeps alpha in shared memory. Each thread then streams its 16-byte
// feature vector of every valid source row, with f32 FMAs, and writes its
// 16 bytes of output once: every global access is a coalesced 16-byte load
// or store, and nothing but the output goes back to device memory. Blocks
// of one row recompute the row's logits (deg x dk FMAs, a few KB of k reads
// from L2) instead of sharing them through a second pass.

#include "bsp_common.cuh"

namespace {

using bsp::kMaxDeg;
using bsp::kMaxDk;
constexpr int kThreads = bsp::kMaxThreads;

// grid (V, feature chunks), block kThreads; the body is shared with
// bsp_fused_parts.cu (bsp_common.cuh).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
fused_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const T* __restrict__ values,
                       const int32_t* __restrict__ ell_src,
                       const uint8_t* __restrict__ ell_mask,
                       T* __restrict__ out, int deg, int dk, long long D) {
  bsp::fused_attention_row<T, T, VEC, false>(q, k, values, ell_src, ell_mask,
                                             out, nullptr, nullptr, deg, dk, D);
}

template <typename T, int VEC>
cudaError_t launch(const float* q, const float* k, const void* values,
                   const int32_t* ell_src, const uint8_t* ell_mask, void* out,
                   int V, int deg, int dk, long long D, cudaStream_t stream) {
  const long long per_block = static_cast<long long>(kThreads) * VEC;
  const long long chunks = (D + per_block - 1) / per_block;
  if (chunks > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(V), static_cast<unsigned>(chunks));
  fused_attention_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      q, k, static_cast<const T*>(values), ell_src, ell_mask,
      static_cast<T*>(out), deg, dk, D);
  return cudaGetLastError();
}

}  // namespace

// values_bf16: 0 for f32 values and output, 1 for bf16.
// vec: features per thread per load; 4 (f32) or 8 (bf16) needs D a multiple
// of it and 16-byte aligned rows, 1 takes any D.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int bsp_fused_attention(const float* q, const float* k,
                                   const void* values, const int32_t* ell_src,
                                   const uint8_t* ell_mask, void* out, int V,
                                   int deg, int dk, long long D,
                                   int values_bf16, int vec, int device,
                                   void* stream) {
  if (V <= 0 || D <= 0 || deg < 0 || deg > kMaxDeg || dk <= 0 || dk > kMaxDk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (values_bf16) {
    if (vec == 8) err = launch<__nv_bfloat16, 8>(q, k, values, ell_src, ell_mask, out, V, deg, dk, D, s);
    else if (vec == 1) err = launch<__nv_bfloat16, 1>(q, k, values, ell_src, ell_mask, out, V, deg, dk, D, s);
    else err = cudaErrorInvalidValue;
  } else {
    if (vec == 4) err = launch<float, 4>(q, k, values, ell_src, ell_mask, out, V, deg, dk, D, s);
    else if (vec == 1) err = launch<float, 1>(q, k, values, ell_src, ell_mask, out, V, deg, dk, D, s);
    else err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
