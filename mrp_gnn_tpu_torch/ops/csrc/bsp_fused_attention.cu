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
// 256 threads x 16 bytes of features). Each block compacts the row's valid
// slots into shared memory, computes their logits one warp per slot (q row
// in shared memory, k rows gathered), reduces max and sum in one warp and
// keeps alpha in shared memory. Each thread then streams its 16-byte
// feature vector of every valid source row, with f32 FMAs, and writes its
// 16 bytes of output once: every global access is a coalesced 16-byte load
// or store, and nothing but the output goes back to device memory. Blocks
// of one row recompute the row's logits (deg x dk FMAs, a few KB of k reads
// from L2) instead of sharing them through a second pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDeg = 128;
constexpr int kMaxDk = 256;
constexpr float kNeg = -1e30f;

template <typename T, int VEC>
struct VecIO;

template <>
struct VecIO<float, 4> {
  __device__ static void load(const float* p, float* x) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  __device__ static void store(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

template <>
struct VecIO<float, 1> {
  __device__ static void load(const float* p, float* x) { x[0] = *p; }
  __device__ static void store(float* p, const float* x) { *p = x[0]; }
};

template <>
struct VecIO<__nv_bfloat16, 8> {
  __device__ static void load(const __nv_bfloat16* p, float* x) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* x) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  }
};

template <>
struct VecIO<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float* x) {
    x[0] = __bfloat162float(*p);
  }
  __device__ static void store(__nv_bfloat16* p, const float* x) {
    *p = __float2bfloat16_rn(x[0]);
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// grid (V, feature chunks), block kThreads.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
fused_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const T* __restrict__ values,
                       const int32_t* __restrict__ ell_src,
                       const uint8_t* __restrict__ ell_mask,
                       T* __restrict__ out, int deg, int dk, long long D) {
  __shared__ float q_sh[kMaxDk];
  __shared__ int32_t src_sh[kMaxDeg];
  __shared__ float w_sh[kMaxDeg];  // logits, then alpha
  __shared__ int n_sh;

  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < dk; i += kThreads) q_sh[i] = q[row * dk + i];

  // Compact the valid slots, in slot order, so the sums below run in the
  // same order on every launch.
  if (warp == 0) {
    int base = 0;
    for (int j0 = 0; j0 < deg; j0 += 32) {
      const int j = j0 + lane;
      const bool valid = j < deg && ell_mask[row * deg + j] != 0;
      const unsigned ballot = __ballot_sync(0xffffffffu, valid);
      if (valid) {
        src_sh[base + __popc(ballot & ((1u << lane) - 1u))] = ell_src[row * deg + j];
      }
      base += __popc(ballot);
    }
    if (lane == 0) n_sh = base;
  }
  __syncthreads();
  const int n = n_sh;

  // Logits, one warp per valid slot.
  for (int s = warp; s < n; s += kWarps) {
    const float* kr = k + static_cast<long long>(src_sh[s]) * dk;
    float acc = 0.f;
    for (int d = lane; d < dk; d += 32) acc = fmaf(q_sh[d], kr[d], acc);
    acc = warp_sum(acc);
    if (lane == 0) w_sh[s] = acc;
  }
  __syncthreads();

  // Masked softmax over the valid slots (the same guards as the plain
  // version: the max is floored at kNeg / 2, a zero sum gives alpha 0).
  if (warp == 0) {
    float m = kNeg;
    for (int s = lane; s < n; s += 32) m = fmaxf(m, w_sh[s]);
    m = fmaxf(warp_max(m), kNeg / 2);
    float l = 0.f;
    for (int s = lane; s < n; s += 32) {
      const float e = expf(w_sh[s] - m);
      w_sh[s] = e;
      l += e;
    }
    l = warp_sum(l);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    for (int s = lane; s < n; s += 32) w_sh[s] *= inv;
  }
  __syncthreads();

  const long long f0 = (static_cast<long long>(blockIdx.y) * kThreads + tid) * VEC;
  if (f0 >= D) return;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int s = 0; s < n; ++s) {
    const float a = w_sh[s];
    float x[VEC];
    VecIO<T, VEC>::load(values + static_cast<long long>(src_sh[s]) * D + f0, x);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = fmaf(a, x[i], acc[i]);
  }
  VecIO<T, VEC>::store(out + row * D + f0, acc);
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
