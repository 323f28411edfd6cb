// Shared device helpers of the ELL gather kernels (bsp_sddmm.cu,
// bsp_spmm.cu, bsp_spmm_t.cu): 16-byte vector loads and stores with f32
// arithmetic, warp reductions and the compaction of a row's valid slots.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bsp {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxDeg = 128;  // a row's slots are kept in shared memory

// VEC consecutive elements of T, converted to and from f32. VEC 8 reads
// 32 bytes of f32 or 16 bytes of bf16 and needs the address aligned to 16
// bytes; VEC 1 takes any address.
template <typename T, int VEC>
struct VecIO;

template <>
struct VecIO<float, 8> {
  __device__ static void load(const float* p, float* x) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
  __device__ static void store(float* p, const float* x) {
    reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
};

template <>
struct VecIO<float, 1> {
  __device__ static void load(const float* p, float* x) { x[0] = __ldg(p); }
  __device__ static void store(float* p, const float* x) { *p = x[0]; }
};

template <>
struct VecIO<__nv_bfloat16, 8> {
  __device__ static void load(const __nv_bfloat16* p, float* x) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
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
    x[0] = __bfloat162float(p[0]);
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

// Run by all 32 lanes of one warp: writes the source node and the slot
// index of row `row`'s valid slots, in slot order, to src_sh / slot_sh and
// returns their count. Slot order fixes the order of every later sum, so
// a kernel gives the same bits on every launch.
__device__ __forceinline__ int compact_valid_slots(
    const int32_t* __restrict__ ell_src, const uint8_t* __restrict__ ell_mask,
    long long row, int deg, int32_t* src_sh, int32_t* slot_sh) {
  const int lane = threadIdx.x & 31;
  int base = 0;
  for (int j0 = 0; j0 < deg; j0 += 32) {
    const int j = j0 + lane;
    const bool valid = j < deg && ell_mask[row * deg + j] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, valid);
    if (valid) {
      const int at = base + __popc(ballot & ((1u << lane) - 1u));
      src_sh[at] = ell_src[row * deg + j];
      slot_sh[at] = j;
    }
    base += __popc(ballot);
  }
  return base;
}

// Threads for a block that covers `lanes` positions of the feature axis:
// a multiple of 32, at least one warp, at most kMaxThreads.
inline int block_threads(long long lanes) {
  long long t = (lanes + 31) / 32 * 32;
  if (t < 32) t = 32;
  if (t > kMaxThreads) t = kMaxThreads;
  return static_cast<int>(t);
}

}  // namespace bsp
