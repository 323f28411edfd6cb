// Block-diagonal masked scene attention, for Hopper (sm_90a), with a plain
// C interface loaded through ctypes (mrp_gnn_tpu_torch/ops/edge.py::
// block_attention).
//
// The batch is S scenes of n consecutive nodes (V = S * n) sharing one
// adjacency. For destination i and source j of one scene:
//
//   x[i, j] = <q_s[i], k[j]> + (scene_adj[i, j] > 0 ? 0 : -1e30)   (f32)
//   x[i, j] = valid[j] ? x[i, j] : -1e30
//   m = max_j x, e = exp(x - max(m, -5e29)), l = sum_j e
//   alpha[i, j] = l > 1e-20 ? e / max(l, 1e-30) : 0, rounded to the values'
//                 type
//   out[i] = sum_j alpha[i, j] * values[j]   (f32 sums, in the values' type)
//
// q_s (already scaled by 1/sqrt(dk)) and k are f32 or bf16 [V, dk], values
// f32 or bf16 [V, D]. A destination whose sources are all masked gives 0,
// so the padded scenes of a batch give exactly 0.
//
// Replaces: mrp_gnn_tpu/ops/pallas_edge.py::_attn_kernel (launched by
// _forward, entry block_fused_attention). The TPU kernel packs T / n scenes
// into one [T, T] node tile (T up to 256) with a kron-built bias and runs
// both products densely on the MXU: 2 V T (dk + D) flops where the function
// needs 2 V n (dk + D), and only where V and D fit Mosaic's tiling. Here
// each block works on one scene, with no tiling condition on V, n or D.
//
// Bound: bytes. The function reads q_s, k and values once and writes out
// once: at the benchmark's shape (1,024 scenes of 8, dk 64, D 2048) 69.2 MB
// in bf16, 0.0207 ms at 3.35 TB/s, against 0.277 GFLOP (0.0041 ms at the
// f32 rate). At multitask_batched (8 scenes of 5, D 8192, f32) 2.6 MB, so
// the launch sets the time.
//
// Design. A kernel that reaches the byte bound must keep enough loads in
// flight: about 3.35 TB/s times the ~1 us latency of a load, some 25 KB per
// SM. The kernels are chosen by the scene size n at launch:
//
// block_attention_f32_kernel and block_attention_bf16_kernel (n <= 32,
// 16-byte rows: the robot teams of the presets and of the benchmark), one
// body (small_scenes). One block per (scene, 16 bytes of each of its rows
// per thread: 256 threads for bf16 values, 128 for f32); a template
// bucket NB = 8, 16 or 32 >= n sizes the shared memory. At block
// start every thread issues the cp.async copies of its 16 bytes of all n
// value rows into shared memory (n loads in flight per thread), and only
// then computes the [n, n] logits (one thread per (destination, source)
// pair, a chain of FMAs over dk with 16-byte loads of the q and k rows
// where they allow), so the value loads overlap the logits and the softmax
// (one thread per destination, into shared memory). It then accumulates the
// outputs in f32 registers, 32 of them for any n (8 destinations a pass for
// f32 values, 4 for bf16), from the staged rows and stores each output row
// once. 64 registers a thread keep 1,024 threads on each SM, whose loads
// are in flight together.
//
// block_attention_kernel (the general case: n up to 256, or rows not
// 16-byte aligned). One block per (scene, chunk of the feature axis). For
// kRows destinations at a time, the warps compute the [kRows, n] logits
// (one warp per (destination, source) dot), one warp per destination takes
// the masked softmax into shared memory, and each thread then streams its
// VEC features of the scene's n value rows, accumulating kRows outputs in
// f32 registers; a larger scene re-reads its rows once per kRows
// destinations, from L1 and L2.
//
// Each feature chunk recomputes its scene's logits (n^2 dk FMAs) rather
// than share them through a second pass.

#include "bsp_common.cuh"

namespace {

using bsp::kNeg;
using bsp::VecIO;

constexpr int kMaxScene = 256;  // nodes per scene
constexpr int kRows = 8;        // destinations per pass

__device__ __forceinline__ float load_qk(const void* p, bool bf16,
                                         long long i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// The weights are kept in the values' type, as the TPU kernel caches them.
template <typename T>
__device__ __forceinline__ float round_to(float x);

template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// grid (S, feature chunks), block a multiple of 32 up to kMaxThreads.
template <typename T, int VEC>
__global__ void __launch_bounds__(bsp::kMaxThreads)
block_attention_kernel(const void* __restrict__ q, const void* __restrict__ k,
                       int qk_bf16, const T* __restrict__ values,
                       const uint8_t* __restrict__ valid,
                       const float* __restrict__ scene_adj,
                       T* __restrict__ out, int n, int dk, long long D) {
  __shared__ float alpha_sh[kRows][kMaxScene];

  const long long base = static_cast<long long>(blockIdx.x) * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const bool qbf = qk_bf16 != 0;
  const long long f0 =
      (static_cast<long long>(blockIdx.y) * blockDim.x + tid) * VEC;
  const bool active = f0 < D;

  for (int r0 = 0; r0 < n; r0 += kRows) {
    const int rows = n - r0 < kRows ? n - r0 : kRows;

    // Logits with the scene and source masks, one warp per pair.
    for (int p = warp; p < rows * n; p += warps) {
      const int r = p / n;
      const int j = p - r * n;
      const long long qi = (base + r0 + r) * dk;
      const long long ki = (base + j) * dk;
      float acc = 0.f;
      for (int d = lane; d < dk; d += 32)
        acc = fmaf(load_qk(q, qbf, qi + d), load_qk(k, qbf, ki + d), acc);
      acc = bsp::warp_sum(acc);
      if (lane == 0) {
        const float x = acc + (scene_adj[(r0 + r) * n + j] > 0.f ? 0.f : kNeg);
        alpha_sh[r][j] = valid[base + j] ? x : kNeg;
      }
    }
    __syncthreads();

    // Masked softmax, one warp per destination.
    for (int r = warp; r < rows; r += warps) {
      float m = kNeg;  // below the floor kNeg / 2, so it never changes mg
      for (int j = lane; j < n; j += 32) m = fmaxf(m, alpha_sh[r][j]);
      const float mg = fmaxf(bsp::warp_max(m), kNeg / 2);
      float l = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float e = expf(alpha_sh[r][j] - mg);
        alpha_sh[r][j] = e;
        l += e;
      }
      l = bsp::warp_sum(l);
      const float den = fmaxf(l, 1e-30f);
      for (int j = lane; j < n; j += 32)
        alpha_sh[r][j] = round_to<T>(l > 1e-20f ? alpha_sh[r][j] / den : 0.f);
    }
    __syncthreads();

    // out[r0 + r] = sum_j alpha[r, j] * values[j], the scene's rows read
    // once per pass. Rows past `rows` hold stale weights and are not stored.
    if (active) {
      float acc[kRows][VEC];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[r][i] = 0.f;
      for (int j = 0; j < n; ++j) {
        float x[VEC];
        VecIO<T, VEC>::load(values + (base + j) * D + f0, x);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float a = alpha_sh[r][j];
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[r][i] = fmaf(a, x[i], acc[r][i]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < rows) VecIO<T, VEC>::store(out + (base + r0 + r) * D + f0, acc[r]);
    }
    __syncthreads();  // the weights are rewritten by the next pass
  }
}

// --- scenes of up to 32 nodes ----------------------------------------------

constexpr int kAccFloats = 32;  // the accumulator, for any n and type

// 16 bytes of T staged in shared memory, as f32.
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& v, float* x);

template <>
__device__ __forceinline__ void unpack16<float>(const uint4& v, float* x) {
  x[0] = __uint_as_float(v.x);
  x[1] = __uint_as_float(v.y);
  x[2] = __uint_as_float(v.z);
  x[3] = __uint_as_float(v.w);
}

template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& v,
                                                        float* x) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// <q[qi .. qi + dk), k[ki .. ki + dk)> in f32, one chain over d in order;
// vec: 16-byte loads (the rows 16-byte aligned, dk a multiple of 16 bytes).
template <typename TQ>
__device__ __forceinline__ float dot_qk(const TQ* __restrict__ q,
                                        const TQ* __restrict__ k,
                                        long long qi, long long ki, int dk,
                                        bool vec) {
  constexpr int kPer = 16 / sizeof(TQ);
  float acc = 0.f;
  if (vec) {
    for (int d = 0; d < dk; d += kPer) {
      float a[kPer], b[kPer];
      VecIO<TQ, kPer>::load(q + qi + d, a);
      VecIO<TQ, kPer>::load(k + ki + d, b);
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc = fmaf(a[i], b[i], acc);
    }
  } else {
    for (int d = 0; d < dk; ++d) {
      float a, b;
      VecIO<TQ, 1>::load(q + qi + d, &a);
      VecIO<TQ, 1>::load(k + ki + d, &b);
      acc = fmaf(a, b, acc);
    }
  }
  return acc;
}

// The body of the small-scene kernels: grid (S, feature chunks of kThreads
// x 16 bytes), block kThreads, NB * kThreads * 16 bytes of dynamic shared
// memory; n <= NB, D a multiple of 16 bytes, values and out 16-byte
// aligned.
template <typename T, int NB, int kThreads>
__device__ __forceinline__ void small_scenes(
    const void* __restrict__ q, const void* __restrict__ k, int qk_bf16,
    int qk_vec, const T* __restrict__ values,
    const uint8_t* __restrict__ valid, const float* __restrict__ scene_adj,
    T* __restrict__ out, int n, int dk, long long D) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int kGroup = kAccFloats / VEC;  // destinations per pass: 8 or 4
  extern __shared__ __align__(16) uint4 rows_sh[];  // [NB][kThreads]
  __shared__ float alpha_sh[NB][NB + 1];

  const long long base = static_cast<long long>(blockIdx.x) * n;
  const int tid = threadIdx.x;
  const long long f0 =
      (static_cast<long long>(blockIdx.y) * kThreads + tid) * VEC;
  const bool active = f0 < D;

  // Every value load of the block in flight before the logits start.
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const bool full = active && j < n;
    bsp::cp_async16(rows_sh + j * kThreads + tid,
                    full ? values + (base + j) * D + f0 : values, full);
  }
  asm volatile("cp.async.commit_group;\n" ::);

  // Logits with the scene and source masks, one thread per pair.
  for (int p = tid; p < n * n; p += kThreads) {
    const int i = p / n;
    const int j = p - i * n;
    const long long qi = (base + i) * dk;
    const long long ki = (base + j) * dk;
    const float dot =
        qk_bf16 ? dot_qk(static_cast<const __nv_bfloat16*>(q),
                         static_cast<const __nv_bfloat16*>(k), qi, ki, dk,
                         qk_vec)
                : dot_qk(static_cast<const float*>(q),
                         static_cast<const float*>(k), qi, ki, dk, qk_vec);
    const float x = dot + (scene_adj[i * n + j] > 0.f ? 0.f : kNeg);
    alpha_sh[i][j] = valid[base + j] ? x : kNeg;
  }
  __syncthreads();

  // Masked softmax, one thread per destination.
  if (tid < n) {
    float* a = alpha_sh[tid];
    float m = kNeg;  // below the floor kNeg / 2, so it never changes mg
    for (int j = 0; j < n; ++j) m = fmaxf(m, a[j]);
    const float mg = fmaxf(m, kNeg / 2);
    float l = 0.f;
    for (int j = 0; j < n; ++j) {
      const float e = expf(a[j] - mg);
      a[j] = e;
      l += e;
    }
    const float den = fmaxf(l, 1e-30f);
    for (int j = 0; j < n; ++j) a[j] = round_to<T>(l > 1e-20f ? a[j] / den : 0.f);
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // out[i0 + r] = sum_j alpha[i0 + r, j] * values[j], kGroup destinations
  // a pass, from the staged rows. Rows past n hold stale weights and are
  // not stored.
  if (!active) return;
  for (int i0 = 0; i0 < n; i0 += kGroup) {
    float acc[kGroup][VEC];
#pragma unroll
    for (int r = 0; r < kGroup; ++r)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (j >= n) break;
      float x[VEC];
      unpack16<T>(rows_sh[j * kThreads + tid], x);
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        const float a = alpha_sh[i0 + r][j];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(a, x[e], acc[r][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < kGroup; ++r)
      if (i0 + r < n) VecIO<T, VEC>::store(out + (base + i0 + r) * D + f0, acc[r]);
  }
}

// The small-scene kernels, one per values' type, each with the launch
// bounds that ran fastest for it on an H100 at the benchmark's shape in
// exploratory calls. f32: 128 threads, no register cap: ptxas takes 64
// registers and spills nothing, where naming a block count in
// __launch_bounds__, even 1, gave 101 registers, and a cap of 64 spills;
// both ran slower. bf16: 256 threads held to 64 registers, 4 blocks per
// SM, where it takes 112 unheld and runs slower.
template <int NB>
__global__ void __launch_bounds__(128)
block_attention_f32_kernel(const void* __restrict__ q,
                           const void* __restrict__ k, int qk_bf16,
                           int qk_vec, const float* __restrict__ values,
                           const uint8_t* __restrict__ valid,
                           const float* __restrict__ scene_adj,
                           float* __restrict__ out, int n, int dk,
                           long long D) {
  small_scenes<float, NB, 128>(q, k, qk_bf16, qk_vec, values, valid,
                               scene_adj, out, n, dk, D);
}

template <int NB>
__global__ void __launch_bounds__(256, 4)
block_attention_bf16_kernel(const void* __restrict__ q,
                            const void* __restrict__ k, int qk_bf16,
                            int qk_vec, const __nv_bfloat16* __restrict__ values,
                            const uint8_t* __restrict__ valid,
                            const float* __restrict__ scene_adj,
                            __nv_bfloat16* __restrict__ out, int n, int dk,
                            long long D) {
  small_scenes<__nv_bfloat16, NB, 256>(q, k, qk_bf16, qk_vec, values, valid,
                                       scene_adj, out, n, dk, D);
}

template <typename T>
using SmallKernel = void (*)(const void*, const void*, int, int, const T*,
                             const uint8_t*, const float*, T*, int, int,
                             long long);

template <typename T, int NB, int kThreads>
cudaError_t launch_small(SmallKernel<T> kernel, const void* q,
                         const void* k, int qk_bf16, int qk_vec,
                         const void* values, const uint8_t* valid,
                         const float* scene_adj, void* out, int S, int n,
                         int dk, long long D, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int kSmem = NB * kThreads * 16;
  const long long per_block = static_cast<long long>(kThreads) * VEC;
  const long long chunks = (D + per_block - 1) / per_block;
  if (chunks > 65535) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(S), static_cast<unsigned>(chunks));
  kernel<<<grid, kThreads, kSmem, stream>>>(
      q, k, qk_bf16, qk_vec, static_cast<const T*>(values), valid, scene_adj,
      static_cast<T*>(out), n, dk, D);
  return cudaGetLastError();
}

template <int NB>
cudaError_t launch_bucket(int values_bf16, const void* q, const void* k,
                          int qk_bf16, int qk_vec, const void* values,
                          const uint8_t* valid, const float* scene_adj,
                          void* out, int S, int n, int dk, long long D,
                          cudaStream_t s) {
  if (values_bf16)
    return launch_small<__nv_bfloat16, NB, 256>(
        block_attention_bf16_kernel<NB>, q, k, qk_bf16, qk_vec, values, valid,
        scene_adj, out, S, n, dk, D, s);
  return launch_small<float, NB, 128>(
      block_attention_f32_kernel<NB>, q, k, qk_bf16, qk_vec, values, valid,
      scene_adj, out, S, n, dk, D, s);
}

// --- the general case ---------------------------------------------------------

template <typename T, int VEC>
cudaError_t launch(const void* q, const void* k, int qk_bf16,
                   const void* values, const uint8_t* valid,
                   const float* scene_adj, void* out, int S, int n, int dk,
                   long long D, cudaStream_t stream) {
  const int threads = bsp::block_threads((D + VEC - 1) / VEC);
  const long long per_block = static_cast<long long>(threads) * VEC;
  const long long chunks = (D + per_block - 1) / per_block;
  if (chunks > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(S), static_cast<unsigned>(chunks));
  block_attention_kernel<T, VEC><<<grid, threads, 0, stream>>>(
      q, k, qk_bf16, static_cast<const T*>(values), valid, scene_adj,
      static_cast<T*>(out), n, dk, D);
  return cudaGetLastError();
}

}  // namespace

// q, k: [S * n, dk], f32 (qk_bf16 0) or bf16 (1); values and out [S * n, D],
// f32 (values_bf16 0) or bf16 (1); valid: bool [S * n]; scene_adj: f32
// [n, n], adj[dst, src]. 1 <= n <= 256. vec: 8 needs D a multiple of 8 and
// 16-byte aligned values and out; 1 takes any D. vec 8 and n <= 32 take
// the small-scene kernels, the rest the general kernel. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int block_attention(const void* q, const void* k, int qk_bf16,
                               const void* values, const uint8_t* valid,
                               const float* scene_adj, void* out, int S,
                               int n, int dk, long long D, int values_bf16,
                               int vec, int device, void* stream) {
  if (S <= 0 || n <= 0 || n > kMaxScene || dk <= 0 || D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 8 && n <= 32) {
    const int esize = qk_bf16 ? 2 : 4;
    const int qk_vec = (static_cast<long long>(dk) * esize) % 16 == 0
                       && reinterpret_cast<uintptr_t>(q) % 16 == 0
                       && reinterpret_cast<uintptr_t>(k) % 16 == 0;
    if (n <= 8)
      err = launch_bucket<8>(values_bf16, q, k, qk_bf16, qk_vec, values, valid, scene_adj, out, S, n, dk, D, s);
    else if (n <= 16)
      err = launch_bucket<16>(values_bf16, q, k, qk_bf16, qk_vec, values, valid, scene_adj, out, S, n, dk, D, s);
    else
      err = launch_bucket<32>(values_bf16, q, k, qk_bf16, qk_vec, values, valid, scene_adj, out, S, n, dk, D, s);
    return static_cast<int>(err);
  }
  if (values_bf16) {
    if (vec == 8) err = launch<__nv_bfloat16, 8>(q, k, qk_bf16, values, valid, scene_adj, out, S, n, dk, D, s);
    else if (vec == 1) err = launch<__nv_bfloat16, 1>(q, k, qk_bf16, values, valid, scene_adj, out, S, n, dk, D, s);
    else err = cudaErrorInvalidValue;
  } else {
    if (vec == 8) err = launch<float, 8>(q, k, qk_bf16, values, valid, scene_adj, out, S, n, dk, D, s);
    else if (vec == 1) err = launch<float, 1>(q, k, qk_bf16, values, valid, scene_adj, out, S, n, dk, D, s);
    else err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
