// Transposed weighted neighbour sum over an ELL neighbour list, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (mrp_gnn_tpu_torch/ops/bsp.py::spmm_t).
//
//   out[s] = sum over valid slots (v, j) with ell_src[v, j] = s of
//            w[v, j] * x[v]
//
// w is f32 [V, deg]; x f32 or bf16 [V, D]; out [Vs, D] f32 or bf16, with
// f32 sums. A source no valid slot names gives 0.
//
// Replaces: mrp_gnn_tpu/ops/pallas_bsp.py::_spmm_t_kernel (launched by
// _spmm_t_forward). The TPU kernel walks a source-major re-sort of the
// tile-pair plan and accumulates A(pair)^T @ x[dst tile] per source tile on
// the MXU. In the training step it gives dvalues (w = alpha, x = the
// output cotangent, D 8192) and dk (w = dlog, x = q_s, D 64) of the fused
// attention's backward.
//
// Deterministic, with no float atomics: the caller passes a source-major
// view of the valid slots (bsp.py::source_view, built on the device with a
// stable sort), `offsets` [Vs + 1] and `slots` (v * deg + j, in (v, j)
// order within each source). Each block owns one output row and sums its
// slots in that order, so two launches give the same bits.
//
// Bound: bytes. The function reads w, x, ell_src and ell_mask once and
// writes out once; at dvalues' shape (V 256, D 8192, f32) that is 16.8 MB,
// about 5 us at 3.35 TB/s. The gathers read each x row once per out-edge
// (about 6.6 times), mostly from the 50 MB L2.
//
// Design: one block per (source row, chunk of the feature axis); each
// thread walks the source's slot list (uniform loads, served by L1) and
// streams its VEC features of each destination row with 16-byte loads and
// f32 FMAs, then writes its features of the output row once.

#include "bsp_common.cuh"

namespace {

using bsp::VecIO;

// grid (Vs, feature chunks), block a multiple of 32 up to kMaxThreads.
template <typename TX, typename TO, int VEC>
__global__ void __launch_bounds__(bsp::kMaxThreads)
spmm_t_kernel(const float* __restrict__ w, const TX* __restrict__ x,
              const int32_t* __restrict__ offsets,
              const int32_t* __restrict__ slots, TO* __restrict__ out,
              int deg, long long D) {
  const long long s = blockIdx.x;
  const long long f0 =
      (static_cast<long long>(blockIdx.y) * blockDim.x + threadIdx.x) * VEC;
  if (f0 >= D) return;
  const int beg = offsets[s];
  const int end = offsets[s + 1];
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int e = beg; e < end; ++e) {
    const int slot = __ldg(slots + e);
    const long long v = slot / deg;
    const float a = __ldg(w + slot);
    float xv[VEC];
    VecIO<TX, VEC>::load(x + v * D + f0, xv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = fmaf(a, xv[i], acc[i]);
  }
  VecIO<TO, VEC>::store(out + s * D + f0, acc);
}

template <typename TX, typename TO, int VEC>
cudaError_t launch(const float* w, const void* x, const int32_t* offsets,
                   const int32_t* slots, void* out, int Vs, int deg,
                   long long D, cudaStream_t stream) {
  const int threads = bsp::block_threads((D + VEC - 1) / VEC);
  const long long per_block = static_cast<long long>(threads) * VEC;
  const long long chunks = (D + per_block - 1) / per_block;
  if (chunks > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(Vs), static_cast<unsigned>(chunks));
  spmm_t_kernel<TX, TO, VEC><<<grid, threads, 0, stream>>>(
      w, static_cast<const TX*>(x), offsets, slots, static_cast<TO*>(out),
      deg, D);
  return cudaGetLastError();
}

template <typename TX, typename TO>
cudaError_t launch_vec(int vec, const float* w, const void* x,
                       const int32_t* offsets, const int32_t* slots,
                       void* out, int Vs, int deg, long long D,
                       cudaStream_t stream) {
  if (vec == 8) return launch<TX, TO, 8>(w, x, offsets, slots, out, Vs, deg, D, stream);
  if (vec == 1) return launch<TX, TO, 1>(w, x, offsets, slots, out, Vs, deg, D, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x_bf16 / out_bf16: 0 for f32, 1 for bf16. vec: 8 needs D a multiple of 8
// and 16-byte aligned x and out; 1 takes any D. Returns the CUDA error code
// of the launch (0 on success).
extern "C" int bsp_spmm_t(const float* w, const void* x,
                          const int32_t* offsets, const int32_t* slots,
                          void* out, int Vs, int deg, long long D, int x_bf16,
                          int out_bf16, int vec, int device, void* stream) {
  if (Vs <= 0 || D <= 0 || deg <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && out_bf16)
    err = launch_vec<__nv_bfloat16, __nv_bfloat16>(vec, w, x, offsets, slots, out, Vs, deg, D, s);
  else if (x_bf16)
    err = launch_vec<__nv_bfloat16, float>(vec, w, x, offsets, slots, out, Vs, deg, D, s);
  else if (out_bf16)
    err = launch_vec<float, __nv_bfloat16>(vec, w, x, offsets, slots, out, Vs, deg, D, s);
  else
    err = launch_vec<float, float>(vec, w, x, offsets, slots, out, Vs, deg, D, s);
  return static_cast<int>(err);
}
