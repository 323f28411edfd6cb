// Shared device code of the port's kernels (bsp_fused_attention.cu,
// bsp_fused_parts.cu, bsp_weights.cu, bsp_sddmm.cu, bsp_spmm.cu,
// bsp_spmm_t.cu, ell_max.cu, ell_softmax.cu, block_attention.cu): 16-byte
// vector loads and stores with f32 arithmetic, warp and lane-group
// reductions, the chain of a narrow edge dot (the per-edge SDDMM's and the
// weights' rows form), 16-byte cp.async staging, the compaction of a row's
// valid slots, a row's softmax weights, the per-row body of the fused
// attention (the parts kernel's) and the node tile of the tiled forms.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bsp {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxDeg = 128;  // a row's slots are kept in shared memory
constexpr int kMaxDk = 256;   // the fused attention keeps a row's query there
constexpr float kNeg = -1e30f;  // the masked logit of the reference ops
// The node tile of the tiled forms of bsp_sddmm.cu and bsp_spmm_t.cu: both
// cut the destination and the source axis into tiles of kTile nodes and
// work on each (destination tile, source tile) pair that holds a valid
// slot as a dense block (bsp.py::TILE).
constexpr int kTile = 64;

// VEC consecutive elements of T, converted to and from f32. VEC 8 reads
// 32 bytes of f32 or 16 bytes of bf16 and needs the address aligned to 16
// bytes, a VEC 4 store of bf16 8 bytes aligned to 8; VEC 1 takes any
// address.
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
struct VecIO<float, 4> {
  __device__ static void load(const float* p, float* x) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  __device__ static void store(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
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
struct VecIO<__nv_bfloat16, 4> {  // stores only (the staged transposed SpMM)
  __device__ static void store(__nv_bfloat16* p, const float* x) {
    uint2 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 2; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    *reinterpret_cast<uint2*>(p) = v;
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// The lanes of one group of g lanes (g a power of two up to 32, groups
// aligned in the warp) sum x with an xor tree, every lane of the warp
// taking part: o = g / 2, g / 4, .., 1, the order of warp_sum at g 32.
__device__ __forceinline__ float group_sum(float x, int g) {
  for (int o = g >> 1; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The lanes one group of a dot over `loads` loads takes: the power of two
// that covers them, at most 32.
__host__ __device__ __forceinline__ int group_lanes(int loads) {
  int g = 1;
  while (g < loads && g < 32) g <<= 1;
  return g;
}

// The lane of the k-th set bit of `bits` (k counted from 0, k < popc(bits)).
__device__ __forceinline__ int nth_set_bit(unsigned bits, int k) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc(bits & ((1u << w) - 1u));
    if (k >= c) {
      k -= c;
      bits >>= w;
      pos += w;
    }
  }
  return pos;
}

// The lanes of one group of g lanes take the max of x, as group_sum.
__device__ __forceinline__ float group_max(float x, int g) {
  for (int o = g >> 1; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// --- edge dots over ELL slots (bsp_sddmm.cu, bsp_weights.cu) ---------------

constexpr int kVec8 = 4;      // operand flag: 16-byte loads (d % 8 == 0,
                              // aligned rows)
constexpr int kRowWarps = 4;  // rows per block of the warp-per-row kernels

// Loads of one dot: 16 bytes (8 elements) where the pair allows, else one
// element. A pair is narrow when a group of at most 32 lanes covers its
// dot with one load each (d <= 256 with 16-byte loads, d <= 32 without).
__host__ __device__ __forceinline__ int dot_loads(int d, int flags) {
  return (flags & kVec8) ? (d + 7) / 8 : d;
}

// acc + <xa, xb> over 8 elements, one chain of FMAs in order: the chain of
// each 16-byte load of a narrow dot (bsp_sddmm.cu, lane_dot), which the
// weights kernel repeats so that its logits have the SDDMM's bits.
__device__ __forceinline__ float fma8(const float* xa, const float* xb,
                                      float acc) {
#pragma unroll
  for (int i = 0; i < 8; ++i) acc = fmaf(xa[i], xb[i], acc);
  return acc;
}

// A 16-byte cp.async from global to shared memory; !full copies nothing and
// fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(full ? 16 : 0));
}

// Run by all 32 lanes of one warp: writes the source node and the slot
// index of row `row`'s valid slots j, j_begin <= j < min(j_end, deg), in
// slot order, to src_sh / slot_sh (slot_sh may be null), and with w given
// their weights w[row, j] to w_sh, and returns their count. Each lane reads
// its slot's mask, source and weight together, so a chunk of 32 slots
// costs one round trip. Slot order fixes the order of every later sum, so
// a kernel gives the same bits on every launch.
__device__ __forceinline__ int compact_valid_slots(
    const int32_t* __restrict__ ell_src, const uint8_t* __restrict__ ell_mask,
    long long row, int deg, int32_t* src_sh, int32_t* slot_sh,
    int j_begin = 0, int j_end = kMaxDeg, const float* __restrict__ w = nullptr,
    float* w_sh = nullptr) {
  const int lane = threadIdx.x & 31;
  const int stop = j_end < deg ? j_end : deg;
  int base = 0;
  for (int j0 = j_begin; j0 < stop; j0 += 32) {
    const int j = j0 + lane;
    const bool in = j < stop;
    const bool valid = in && ell_mask[row * deg + j] != 0;
    const int32_t src = in ? ell_src[row * deg + j] : 0;
    const float a = (w != nullptr && in) ? w[row * deg + j] : 0.f;
    const unsigned ballot = __ballot_sync(0xffffffffu, valid);
    if (valid) {
      const int at = base + __popc(ballot & ((1u << lane) - 1u));
      src_sh[at] = src;
      if (slot_sh != nullptr) slot_sh[at] = j;
      if (w != nullptr) w_sh[at] = a;
    }
    base += __popc(ballot);
  }
  return base;
}

// The shared memory of one ELL row's attention weights (row_exp_weights).
struct RowWeights {
  float q[kMaxDk];
  int32_t src[kMaxDeg];   // the valid slots' source nodes, in slot order
  int32_t slot[kMaxDeg];  // and their slot indices j
  float w[kMaxDeg];       // logits, then e_j
  int n;                  // number of valid slots
  float m, l;             // max logit (kNeg without a valid slot), sum of e_j
};

// Run by all kMaxThreads threads of a block for ELL row `row` (deg <=
// kMaxDeg, dk <= kMaxDk); q (already scaled by 1/sqrt(dk)) and k are f32
// [., dk]. Over the row's valid slots j, in slot order: x_j = <q[row],
// k[src_j]> (one warp per slot), m = max(kNeg, max_j x_j), e_j = exp(x_j -
// max(m, kNeg / 2)) (the reference's floored max), l = sum_j e_j. Leaves
// e_j in sh.w, and n, m, l in sh, visible to every thread on return. The
// logits never leave shared memory.
__device__ __forceinline__ void row_exp_weights(
    const float* __restrict__ q, const float* __restrict__ k,
    const int32_t* __restrict__ ell_src, const uint8_t* __restrict__ ell_mask,
    long long row, int deg, int dk, RowWeights& sh) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < dk; i += kMaxThreads) sh.q[i] = q[row * dk + i];
  if (warp == 0) {
    const int n = compact_valid_slots(ell_src, ell_mask, row, deg, sh.src,
                                      sh.slot);
    if (lane == 0) sh.n = n;
  }
  __syncthreads();
  const int n = sh.n;

  // Logits, one warp per valid slot.
  for (int s = warp; s < n; s += kMaxWarps) {
    const float* kr = k + static_cast<long long>(sh.src[s]) * dk;
    float acc = 0.f;
    for (int d = lane; d < dk; d += 32) acc = fmaf(sh.q[d], kr[d], acc);
    acc = warp_sum(acc);
    if (lane == 0) sh.w[s] = acc;
  }
  __syncthreads();

  if (warp == 0) {
    float m = kNeg;
    for (int s = lane; s < n; s += 32) m = fmaxf(m, sh.w[s]);
    m = warp_max(m);
    const float mg = fmaxf(m, kNeg / 2);
    float l = 0.f;
    for (int s = lane; s < n; s += 32) {
      const float e = expf(sh.w[s] - mg);
      sh.w[s] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) {
      sh.m = m;
      sh.l = l;
    }
  }
  __syncthreads();
}

// One block of the fused attention: ELL row blockIdx.x, features
// [blockIdx.y * kMaxThreads * VEC, ...), kMaxThreads threads; values T
// [Vs, D]. With x_j, m, e_j and l of row_exp_weights:
//   kParts false: out[row] = sum_j (e_j / l) * values[src_j] in T (0 when
//     l == 0): the fused attention (TO = T).
//   kParts true: out[row] = sum_j e_j * values[src_j] in f32, not divided,
//     and m_out[row] = m, l_out[row] = l (written by chunk 0): the raw
//     online-softmax triple of the split-over-neighbours form (TO = float).
// Each block recomputes its row's logits (deg x dk FMAs) rather than share
// them with the row's other feature chunks through a second pass.
template <typename T, typename TO, int VEC, bool kParts>
__device__ __forceinline__ void fused_attention_row(
    const float* __restrict__ q, const float* __restrict__ k,
    const T* __restrict__ values, const int32_t* __restrict__ ell_src,
    const uint8_t* __restrict__ ell_mask, TO* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, int deg, int dk,
    long long D) {
  __shared__ RowWeights sh;
  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  row_exp_weights(q, k, ell_src, ell_mask, row, deg, dk, sh);
  const int n = sh.n;
  float* w_sh = sh.w;
  const int32_t* src_sh = sh.src;

  if (kParts) {
    if (tid == 0 && blockIdx.y == 0) {
      m_out[row] = sh.m;
      l_out[row] = sh.l;
    }
  } else {
    // Normalise the weights; a zero sum gives weight 0.
    const float inv = sh.l > 0.f ? 1.f / sh.l : 0.f;
    for (int s = tid; s < n; s += kMaxThreads) w_sh[s] *= inv;
    __syncthreads();
  }

  const long long f0 =
      (static_cast<long long>(blockIdx.y) * kMaxThreads + tid) * VEC;
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
  VecIO<TO, VEC>::store(out + row * D + f0, acc);
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
