// Raw online-softmax attention parts over a row-expanded ELL neighbour list
// (in-degree past 128), for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (mrp_gnn_tpu_torch/ops/bsp.py::fused_attention_parts).
//
// For each expanded row r (node v's list split over rows v*R .. v*R+R-1,
// at most 128 slots each):
//   x_j    = <q_x[r], k[src_x[r, j]]> over the row's valid slots j
//   m[r]   = max(-1e30, max_j x_j)            (-1e30 when no slot is valid)
//   l[r]   = sum_j exp(x_j - max(m[r], -5e29))
//   acc[r] = sum_j exp(x_j - max(m[r], -5e29)) * values[src_x[r, j]]
// in f32, acc not divided. The caller (bsp.py::xp_combine) folds a node's
// R triples into one softmax. q_x is f32 [V*R, dk], already scaled by
// 1/sqrt(dk) and repeated R times; k f32 [V, dk]; values f32 or bf16
// [V, D]; acc f32 [V*R, D]; m, l f32 [V*R]. A duplicate edge counts once
// per slot; a row with no valid slot gives m = -1e30, l = 0, acc = 0.
//
// Replaces: mrp_gnn_tpu/ops/pallas_bsp.py::_fused_parts_kernel (launched by
// _fused_parts_forward, entry expanded_attention_fused). The TPU kernel
// runs the one-pass fused body over the rectangular (V*R dst, V src) tile
// plan and emits (acc, m, l) per expanded row instead of dividing; the
// plan and its one-hot selections work around Mosaic's whole-tile DMAs.
// Here each block gathers its rows straight from the expanded ell_src.
//
// Bound: at the dense-swarm shapes (2 scenes x 193 robots in 512 slots, in-
// degree 192 as 2 x 96, 74,112 edges, dk 64, D 8192, f32) the function
// reads values once (16.8 MB) and writes acc once (33.5 MB): 0.015 ms at
// 3.35 TB/s; its f32 work, 2 x edges x (dk + D) FMAs and an exp per edge
// (1.22 GFLOP), takes 0.018 ms at 67 TFLOP/s, so operations bound it.
// The gathers read each value row once per in-edge (192 times, 2.4 GB in
// all); the values fit in the 50 MB L2, so L2 serves those reads.
//
// Design: the body of bsp_fused_attention.cu (bsp_common.cuh,
// fused_attention_row with kParts), one block per (expanded row, chunk of
// 256 threads x 16 bytes of features). Splitting a node's neighbours over
// its expanded rows is the split-over-neighbours ("flash-decoding") form:
// a 192-wide row spreads over two blocks per feature chunk, and the cheap
// combine in torch rescales their partial sums. A tiled form that shares
// value rows among a tile's destination rows in shared memory (the TPU
// kernel's tile pairs) would cut the L2 traffic; that is later work.

#include "bsp_common.cuh"

namespace {

using bsp::kMaxDeg;
using bsp::kMaxDk;
constexpr int kThreads = bsp::kMaxThreads;

// grid (V*R, feature chunks), block kThreads.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
fused_parts_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const T* __restrict__ values,
                   const int32_t* __restrict__ ell_src,
                   const uint8_t* __restrict__ ell_mask,
                   float* __restrict__ acc, float* __restrict__ m,
                   float* __restrict__ l, int deg, int dk, long long D) {
  bsp::fused_attention_row<T, float, VEC, true>(q, k, values, ell_src,
                                                ell_mask, acc, m, l, deg, dk,
                                                D);
}

template <typename T, int VEC>
cudaError_t launch(const float* q, const float* k, const void* values,
                   const int32_t* ell_src, const uint8_t* ell_mask,
                   float* acc, float* m, float* l, int rows, int deg, int dk,
                   long long D, cudaStream_t stream) {
  const long long per_block = static_cast<long long>(kThreads) * VEC;
  const long long chunks = (D + per_block - 1) / per_block;
  if (chunks > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(chunks));
  fused_parts_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      q, k, static_cast<const T*>(values), ell_src, ell_mask, acc, m, l, deg,
      dk, D);
  return cudaGetLastError();
}

}  // namespace

// rows: expanded rows (V*R); deg: the expanded width (<= 128).
// values_bf16: 0 for f32 values, 1 for bf16; acc, m and l are f32.
// vec: features per thread per load; 4 (f32) or 8 (bf16) needs D a multiple
// of it and 16-byte aligned rows of values and acc, 1 takes any D.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int bsp_fused_parts(const float* q, const float* k,
                               const void* values, const int32_t* ell_src,
                               const uint8_t* ell_mask, float* acc, float* m,
                               float* l, int rows, int deg, int dk,
                               long long D, int values_bf16, int vec,
                               int device, void* stream) {
  if (rows <= 0 || D <= 0 || deg < 0 || deg > kMaxDeg || dk <= 0 || dk > kMaxDk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (values_bf16) {
    if (vec == 8) err = launch<__nv_bfloat16, 8>(q, k, values, ell_src, ell_mask, acc, m, l, rows, deg, dk, D, s);
    else if (vec == 1) err = launch<__nv_bfloat16, 1>(q, k, values, ell_src, ell_mask, acc, m, l, rows, deg, dk, D, s);
    else err = cudaErrorInvalidValue;
  } else {
    if (vec == 4) err = launch<float, 4>(q, k, values, ell_src, ell_mask, acc, m, l, rows, deg, dk, D, s);
    else if (vec == 1) err = launch<float, 1>(q, k, values, ell_src, ell_mask, acc, m, l, rows, deg, dk, D, s);
    else err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
