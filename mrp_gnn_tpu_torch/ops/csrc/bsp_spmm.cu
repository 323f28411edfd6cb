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
// microsecond of HBM time, so launch and latency set the time. On the ELL,
// mean and bsp2 paths at D 8192 (f32) it is 16.8 MB, 0.005 ms at 3.35
// TB/s; the gathers read each value row once per in-edge (6.6 times at the
// swarm's shape), from the 50 MB L2.
//
// Forms (bsp.py::SPMM_FORMS; the wrapper takes bsp.py::spmm_form's), both
// with warp 0 compacting the row's valid slots, reading each slot's mask,
// source and weight together (one round trip, bsp_common.cuh), 128 slots
// at a time, so a row of any width needs 1 KB of shared memory, and one
// chain of FMAs per output in slot order (every launch and both forms give
// the same bits):
// - row (any D; the rule's form for bf16 x and for D below one vector
//   block): one block per (destination row, chunk of the feature axis),
//   each thread VEC features, the block only as wide as the feature axis
//   needs (at least one warp), so a narrow D does not leave most of 256
//   threads idle;
// - vector (16-byte rows; the rule's form for f32 x from D 2048): one block
//   of 256 threads per (row, chunk of 2 x 256 x 16 bytes), each thread two
//   16-byte vectors, two slots in flight.
// A block that staged its tile's source window in shared memory once (by
// bulk copy on an mbarrier, 32 destinations a block) moved a third of the
// L2 bytes and was no faster than the vector form on the card: with the
// slots' round trip and the copy's in a row, a grid of such blocks left
// them exposed (PERF.md section 6 gives the times of the designs tried).
// What set the time was dependent round trips and barriers: the weights
// come with the compaction, and a row of at most 128 slots takes no
// barrier after its sum.

#include "bsp_common.cuh"

namespace {

using bsp::kMaxDeg;
using bsp::VecIO;

// The row form: grid (V, feature chunks), block a multiple of 32 up to
// kMaxThreads.
template <typename T, int VEC>
__global__ void __launch_bounds__(bsp::kMaxThreads)
spmm_kernel(const float* __restrict__ w, const T* __restrict__ x,
            const int32_t* __restrict__ ell_src,
            const uint8_t* __restrict__ ell_mask, T* __restrict__ out,
            int deg, long long D) {
  __shared__ int32_t src_sh[kMaxDeg];
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
                                             src_sh, nullptr, j0,
                                             j0 + kMaxDeg, w, w_sh);
      if (tid == 0) n_sh = n;
    }
    __syncthreads();
    const int n = n_sh;
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
    if (j0 + kMaxDeg < deg) __syncthreads();  // the next 128 slots follow
  }
  if (active) VecIO<T, VEC>::store(out + row * D + f0, acc);
}

// The vector form: grid (V, chunks of kVecThreads x kNV x 16 bytes), block
// kVecThreads; thread tid owns kNV 16-byte vectors of row blockIdx.x at
// features f0 + i * kVecThreads * VEC; two slots in flight.
constexpr int kVecThreads = bsp::kMaxThreads;
constexpr int kNV = 2;

template <typename T>
__global__ void __launch_bounds__(kVecThreads)
spmm_vec_kernel(const float* __restrict__ w, const T* __restrict__ x,
                const int32_t* __restrict__ ell_src,
                const uint8_t* __restrict__ ell_mask, T* __restrict__ out,
                int deg, long long D) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr long long kStride = static_cast<long long>(kVecThreads) * VEC;
  __shared__ int32_t src_sh[kMaxDeg];
  __shared__ float w_sh[kMaxDeg];
  __shared__ int n_sh;

  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const long long f0 = static_cast<long long>(blockIdx.y) * kNV * kStride + tid * VEC;
  float acc[kNV][VEC];
#pragma unroll
  for (int i = 0; i < kNV; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;
  for (int j0 = 0; j0 < deg; j0 += kMaxDeg) {
    if (tid < 32) {
      const int n = bsp::compact_valid_slots(ell_src, ell_mask, row, deg,
                                             src_sh, nullptr, j0,
                                             j0 + kMaxDeg, w, w_sh);
      if (tid == 0) n_sh = n;
    }
    __syncthreads();
    const int n = n_sh;
#pragma unroll 2
    for (int s = 0; s < n; ++s) {
      const float a = w_sh[s];
      const T* xr = x + static_cast<long long>(src_sh[s]) * D;
#pragma unroll
      for (int i = 0; i < kNV; ++i) {
        const long long f = f0 + i * kStride;
        if (f < D) {
          float xv[VEC];
          VecIO<T, VEC>::load(xr + f, xv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[i][e] = fmaf(a, xv[e], acc[i][e]);
        }
      }
    }
    if (j0 + kMaxDeg < deg) __syncthreads();  // the next 128 slots follow
  }
#pragma unroll
  for (int i = 0; i < kNV; ++i) {
    const long long f = f0 + i * kStride;
    if (f < D) VecIO<T, VEC>::store(out + row * D + f, acc[i]);
  }
}

struct Args {
  const float* w;
  const void* x;
  const int32_t* ell_src;
  const uint8_t* ell_mask;
  void* out;
  int V, deg;
  long long D;
  cudaStream_t stream;
};

template <typename T, int VEC>
cudaError_t launch_row(const Args& a) {
  const int threads = bsp::block_threads((a.D + VEC - 1) / VEC);
  const long long per_block = static_cast<long long>(threads) * VEC;
  const long long chunks = (a.D + per_block - 1) / per_block;
  if (chunks > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(a.V), static_cast<unsigned>(chunks));
  spmm_kernel<T, VEC><<<grid, threads, 0, a.stream>>>(
      a.w, static_cast<const T*>(a.x), a.ell_src, a.ell_mask,
      static_cast<T*>(a.out), a.deg, a.D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_vec(const Args& a) {
  constexpr int VEC = 16 / sizeof(T);
  const long long per_block = static_cast<long long>(kVecThreads) * VEC * kNV;
  const long long chunks = (a.D + per_block - 1) / per_block;
  if (chunks > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(a.V), static_cast<unsigned>(chunks));
  spmm_vec_kernel<T><<<grid, kVecThreads, 0, a.stream>>>(
      a.w, static_cast<const T*>(a.x), a.ell_src, a.ell_mask,
      static_cast<T*>(a.out), a.deg, a.D);
  return cudaGetLastError();
}

}  // namespace

// x_bf16: 0 for f32 x and output, 1 for bf16. vec: 8 needs D a multiple of
// 8 and 16-byte aligned x and out; 1 takes any D. deg may be any width.
// form (bsp.py::SPMM_FORMS): 0 the row form (vec 8 or 1); 1 the vector
// form (vec 8 only). Returns the CUDA error code of the launch (0 on
// success).
extern "C" int bsp_spmm(const float* w, const void* x, const int32_t* ell_src,
                        const uint8_t* ell_mask, void* out, int V, int deg,
                        long long D, int x_bf16, int vec, int form, int device,
                        void* stream) {
  if (V <= 0 || D <= 0 || deg < 0 || !(vec == 8 || vec == 1) || form < 0
      || form > 1 || (form == 1 && vec != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{w, x, ell_src, ell_mask, out, V, deg, D,
               static_cast<cudaStream_t>(stream)};
  if (x_bf16) {
    if (form == 1) err = launch_vec<__nv_bfloat16>(a);
    else if (vec == 8) err = launch_row<__nv_bfloat16, 8>(a);
    else err = launch_row<__nv_bfloat16, 1>(a);
  } else {
    if (form == 1) err = launch_vec<float>(a);
    else if (vec == 8) err = launch_row<float, 8>(a);
    else err = launch_row<float, 1>(a);
  }
  return static_cast<int>(err);
}
