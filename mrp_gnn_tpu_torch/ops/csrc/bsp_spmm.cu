// Weighted neighbour sum over an ELL neighbour list, for Hopper (sm_90a),
// with a plain C interface loaded through ctypes
// (mrp_gnn_tpu_torch/ops/bsp.py::spmm).
//
//   out[v] = sum over valid slots j of w[v, j] * x[ell_src[v, j]]
//
// w is f32 [V, deg]; x f32 or bf16 [Vs, D]; the output [V, D] takes x's
// type, with f32 sums. A masked slot contributes nothing whatever its
// weight, a duplicate edge counts once per slot, and a row with no valid
// slot gives 0. The ELL width deg may be any size.
//
// Replaces: mrp_gnn_tpu/ops/pallas_bsp.py::_spmm_kernel (launched by
// _spmm_forward) and mrp_gnn_tpu/ops/pallas_ell.py::_spmm_kernel (launched
// by _spmm_forward there; wrapper ops/ell.py::spmm, which counts its
// launches apart). The BSP kernel walks the (dst tile, src tile) pair plan,
// builds a one-hot [Tv, Ts] weight matrix column by column and applies it
// on the MXU; the ELL kernel DMAs each slot's row into a double buffer and
// unrolls over the width. Both are workarounds for Mosaic's whole-tile
// DMAs. Here each block gathers its rows straight from ell_src. In the
// training step it gives dq of the fused attention's backward (w = dlog,
// x = k, D = dk); on the plan-free ELL path the attention's weighted sum.
//
// Bound: bytes. The function reads w, x, ell_src and ell_mask once and
// writes out once; its FMAs are 2 x edges x D, far below the f32 rate. At
// dq's shape (V 256, deg 32, D 64) that is under 200 KB, well under a
// microsecond of HBM time, so launch and latency set the time. On the ELL
// path at D 8192 (f32) it is 16.8 MB, 0.005 ms at 3.35 TB/s; the gathers
// read each value row once per in-edge, mostly from the 50 MB L2.
//
// Design: one block per (destination row, chunk of the feature axis). Warp
// 0 compacts the row's valid slots and their weights into shared memory in
// slot order, 128 slots at a time, so a row of any width needs 1.5 KB of
// shared memory (a fixed sum order, so every launch gives the same bits);
// each thread then streams its VEC features of every valid source row with
// 16-byte loads and f32 FMAs and writes them once. The block is only as
// wide as the feature axis needs (at least one warp), so a narrow D does
// not leave most of 256 threads idle.

#include "bsp_common.cuh"

namespace {

using bsp::kMaxDeg;
using bsp::VecIO;

// grid (V, feature chunks), block a multiple of 32 up to kMaxThreads.
template <typename T, int VEC>
__global__ void __launch_bounds__(bsp::kMaxThreads)
spmm_kernel(const float* __restrict__ w, const T* __restrict__ x,
            const int32_t* __restrict__ ell_src,
            const uint8_t* __restrict__ ell_mask, T* __restrict__ out,
            int deg, long long D) {
  __shared__ int32_t src_sh[kMaxDeg];
  __shared__ int32_t slot_sh[kMaxDeg];
  __shared__ float w_sh[kMaxDeg];
  __shared__ int n_sh;

  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const long long f0 =
      (static_cast<long long>(blockIdx.y) * blockDim.x + tid) * VEC;
  const bool active = f0 < D;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  for (int j0 = 0; j0 < deg; j0 += kMaxDeg) {
    if (tid < 32) {
      const int n = bsp::compact_valid_slots(ell_src, ell_mask, row, deg,
                                             src_sh, slot_sh, j0,
                                             j0 + kMaxDeg);
      if (tid == 0) n_sh = n;
    }
    __syncthreads();
    const int n = n_sh;
    for (int s = tid; s < n; s += blockDim.x) w_sh[s] = w[row * deg + slot_sh[s]];
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int s = 0; s < n; ++s) {
        const float a = w_sh[s];
        float xv[VEC];
        VecIO<T, VEC>::load(x + static_cast<long long>(src_sh[s]) * D + f0, xv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = fmaf(a, xv[i], acc[i]);
      }
    }
    __syncthreads();  // the slots are rewritten by the next 128
  }
  if (active) VecIO<T, VEC>::store(out + row * D + f0, acc);
}

template <typename T, int VEC>
cudaError_t launch(const float* w, const void* x, const int32_t* ell_src,
                   const uint8_t* ell_mask, void* out, int V, int deg,
                   long long D, cudaStream_t stream) {
  const int threads = bsp::block_threads((D + VEC - 1) / VEC);
  const long long per_block = static_cast<long long>(threads) * VEC;
  const long long chunks = (D + per_block - 1) / per_block;
  if (chunks > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(V), static_cast<unsigned>(chunks));
  spmm_kernel<T, VEC><<<grid, threads, 0, stream>>>(
      w, static_cast<const T*>(x), ell_src, ell_mask, static_cast<T*>(out),
      deg, D);
  return cudaGetLastError();
}

}  // namespace

// x_bf16: 0 for f32 x and output, 1 for bf16. vec: 8 needs D a multiple of
// 8 and 16-byte aligned x and out; 1 takes any D. deg may be any width.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int bsp_spmm(const float* w, const void* x, const int32_t* ell_src,
                        const uint8_t* ell_mask, void* out, int V, int deg,
                        long long D, int x_bf16, int vec, int device,
                        void* stream) {
  if (V <= 0 || D <= 0 || deg < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (vec == 8) err = launch<__nv_bfloat16, 8>(w, x, ell_src, ell_mask, out, V, deg, D, s);
    else if (vec == 1) err = launch<__nv_bfloat16, 1>(w, x, ell_src, ell_mask, out, V, deg, D, s);
    else err = cudaErrorInvalidValue;
  } else {
    if (vec == 8) err = launch<float, 8>(w, x, ell_src, ell_mask, out, V, deg, D, s);
    else if (vec == 1) err = launch<float, 1>(w, x, ell_src, ell_mask, out, V, deg, D, s);
    else err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
