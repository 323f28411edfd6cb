// Edge dot products over an ELL neighbour list, one pair of operands or
// two, for Hopper (sm_90a), with a plain C interface loaded through ctypes
// (mrp_gnn_tpu_torch/ops/bsp.py::sddmm).
//
//   out1[v, j] = <a1[v], b1[ell_src[v, j]]>
//   out2[v, j] = <a2[v], b2[ell_src[v, j]]>   (dual form only)
//
// summed in f32 over the feature axis; a masked slot gives 0. Each operand
// is f32 or bf16 on its own, so a pair may mix them (an f32 cotangent
// against bf16 values). The ELL width deg may be any size.
//
// Replaces: mrp_gnn_tpu/ops/pallas_bsp.py::_sddmm_kernel (launched by
// _sddmm_forward) and ::_sddmm2_kernel (launched by _sddmm2_forward, the
// dual form), and in the single form mrp_gnn_tpu/ops/pallas_ell.py::
// _sddmm_kernel (launched by _sddmm_forward there; wrapper
// ops/ell.py::sddmm, which counts its launches apart). The BSP kernels take
// one [Tv, D] x [D, Ts] MXU product per (dst tile, src tile) pair of the
// plan, then pick each slot's column with one-hot selections; the ELL
// kernel DMAs each slot's key row and unrolls over the width. The training step launches this kernel once, in the
// dual form: (q_s, k) recomputes the attention logits and (g, values)
// gives dalpha. At the full dynamic_swarm width the JAX package runs that
// as three _sddmm_kernel sweeps (its VMEM gate refuses the dual kernel and
// D 8192 is split in two); at narrow widths as one _sddmm2_kernel sweep.
//
// Bound: bytes. The function reads a1, b1, a2, b2, ell_src and ell_mask
// once and writes the outputs once: at the training shape (V 256, deg 32,
// d1 64, d2 8192, f32) 17 MB, about 5 us at 3.35 TB/s, against
// 2 x edges x (d1 + d2) FMAs (28 MFLOP). The b rows are gathered once per
// in-edge (about 6.6 times), mostly from the 50 MB L2.
//
// Design: one block per destination row. Warp 0 compacts the row's valid
// slots into shared memory in slot order, 128 at a time (so any width fits
// in 9 KB of shared memory); then, slot after slot, every thread takes its
// share of the feature axis (16-byte loads where the rows allow) for both
// pairs, the warps reduce with shuffles and write one partial per warp to
// shared memory. One pass after each 128 slots sums the warps' partials in
// a fixed order, so every launch gives the same bits.

#include "bsp_common.cuh"

namespace {

using bsp::kMaxDeg;
using bsp::kMaxWarps;
using bsp::VecIO;

constexpr int kABf16 = 1;  // flags of one operand pair
constexpr int kBBf16 = 2;
constexpr int kVec8 = 4;   // 16-byte loads: d % 8 == 0, aligned rows

__device__ __forceinline__ void load8(const void* p, bool bf16, long long i,
                                      float* x) {
  if (bf16) VecIO<__nv_bfloat16, 8>::load(static_cast<const __nv_bfloat16*>(p) + i, x);
  else VecIO<float, 8>::load(static_cast<const float*>(p) + i, x);
}

__device__ __forceinline__ float load1(const void* p, bool bf16, long long i) {
  float x;
  if (bf16) VecIO<__nv_bfloat16, 1>::load(static_cast<const __nv_bfloat16*>(p) + i, &x);
  else VecIO<float, 1>::load(static_cast<const float*>(p) + i, &x);
  return x;
}

// This thread's share of <a[arow], b[brow]> over d features.
__device__ __forceinline__ float partial_dot(const void* a, const void* b,
                                             long long arow, long long brow,
                                             int d, int flags) {
  const bool abf = flags & kABf16;
  const bool bbf = flags & kBBf16;
  const long long ia = arow * d;
  const long long ib = brow * d;
  float acc = 0.f;
  if (flags & kVec8) {
#pragma unroll 4
    for (long long f = threadIdx.x * 8LL; f < d; f += blockDim.x * 8LL) {
      float xa[8], xb[8];
      load8(a, abf, ia + f, xa);
      load8(b, bbf, ib + f, xb);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = fmaf(xa[i], xb[i], acc);
    }
  } else {
    for (long long f = threadIdx.x; f < d; f += blockDim.x)
      acc = fmaf(load1(a, abf, ia + f), load1(b, bbf, ib + f), acc);
  }
  return acc;
}

// grid V, block a multiple of 32 up to kMaxThreads. d2 == 0: single form.
__global__ void __launch_bounds__(bsp::kMaxThreads)
sddmm_kernel(const void* __restrict__ a1, const void* __restrict__ b1, int d1,
             int flags1, const void* __restrict__ a2,
             const void* __restrict__ b2, int d2, int flags2,
             const int32_t* __restrict__ ell_src,
             const uint8_t* __restrict__ ell_mask, float* __restrict__ out1,
             float* __restrict__ out2, int deg) {
  __shared__ int32_t src_sh[kMaxDeg];
  __shared__ int32_t slot_sh[kMaxDeg];
  __shared__ float red1[kMaxWarps][kMaxDeg];
  __shared__ float red2[kMaxWarps][kMaxDeg];
  __shared__ int n_sh;

  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int j = tid; j < deg; j += blockDim.x) {
    if (ell_mask[row * deg + j] == 0) {
      out1[row * deg + j] = 0.f;
      if (d2 > 0) out2[row * deg + j] = 0.f;
    }
  }
  const int warps = blockDim.x >> 5;
  for (int j0 = 0; j0 < deg; j0 += kMaxDeg) {
    if (tid < 32) {
      const int n = bsp::compact_valid_slots(ell_src, ell_mask, row, deg,
                                             src_sh, slot_sh, j0,
                                             j0 + kMaxDeg);
      if (tid == 0) n_sh = n;
    }
    __syncthreads();
    const int n = n_sh;

    for (int s = 0; s < n; ++s) {
      const long long src = src_sh[s];
      const float p1 = bsp::warp_sum(partial_dot(a1, b1, row, src, d1, flags1));
      float p2 = 0.f;
      if (d2 > 0) p2 = bsp::warp_sum(partial_dot(a2, b2, row, src, d2, flags2));
      if (lane == 0) {
        red1[warp][s] = p1;
        red2[warp][s] = p2;
      }
    }
    __syncthreads();

    for (int s = tid; s < n; s += blockDim.x) {
      float t1 = 0.f, t2 = 0.f;
      for (int w = 0; w < warps; ++w) {
        t1 += red1[w][s];
        t2 += red2[w][s];
      }
      out1[row * deg + slot_sh[s]] = t1;
      if (d2 > 0) out2[row * deg + slot_sh[s]] = t2;
    }
    __syncthreads();  // the slots and partials are rewritten by the next 128
  }
}

int lanes_for(int d, int flags) {
  return (flags & kVec8) ? (d + 7) / 8 : d;
}

}  // namespace

// flags1 / flags2: bit 0 a is bf16, bit 1 b is bf16, bit 2 16-byte loads
// (d a multiple of 8, rows 16-byte aligned). d2 == 0 (a2, b2, out2 unused)
// is the single form. deg may be any width. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int bsp_sddmm(const void* a1, const void* b1, int d1, int flags1,
                         const void* a2, const void* b2, int d2, int flags2,
                         const int32_t* ell_src, const uint8_t* ell_mask,
                         float* out1, float* out2, int V, int deg, int device,
                         void* stream) {
  if (V <= 0 || deg <= 0 || d1 <= 0 || d2 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int lanes = lanes_for(d1, flags1);
  if (d2 > 0 && lanes_for(d2, flags2) > lanes) lanes = lanes_for(d2, flags2);
  const int threads = bsp::block_threads(lanes);
  sddmm_kernel<<<static_cast<unsigned>(V), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      a1, b1, d1, flags1, a2, b2, d2, flags2, ell_src, ell_mask, out1, out2,
      deg);
  return static_cast<int>(cudaGetLastError());
}
