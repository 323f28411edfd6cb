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
// (its multiplicity), and a row with no valid slot gives 0. Each output is
// one chain of FMAs over its row's valid slots in slot order, with no float
// atomics, so every launch gives the same bits.
//
// Replaces: mrp_gnn_tpu/ops/pallas_bsp.py::_fused_kernel (launched by
// _fused_forward, entry bsp_attention_fused). The TPU kernel walks a
// (dst tile, src tile) pair plan, selects edges with one-hot MXU products
// and carries an online (max, sum, acc) across each tile group; those are
// workarounds for Mosaic's whole-tile DMAs and 128-lane layout. Here each
// block gathers its rows straight from ell_src.
//
// Bound: bytes. At the attention path's shapes (V 256, deg 32, 1,680
// edges, dk 64, D 8192, f32) the function must read values once (V*D) and
// write out once (V*D): 16.8 MB, 0.0051 ms at 3.35 TB/s, against about 28
// MFLOP (0.0004 ms at the f32 rate). A gather reads each value row once
// per in-edge: 55 MB through L2 at 6.6 in-edges a row, and on the card
// that gather, not the logits, sets the time (the plain SpMM over the same
// graph, row 9, takes as long as the whole forward).
//
// Forms (bsp.py::FUSED_FORMS; the wrapper takes bsp.py::fused_form's):
// - vector (the rule's form for f32 values in 16-byte rows): one block of
//   256 threads per (destination row, chunk of 2 x 256 x 16 bytes of
//   features), so a block covers twice the row form's features and each
//   row's logits are computed half as many times, and the grid (1,024
//   blocks at the attention shape) is one wave of 8 blocks an SM. Warp 0
//   compacts the row's valid slots, reading each slot's mask and source
//   together (one round trip, bsp_common.cuh); the logits take a group of
//   G lanes per slot (G covers dk in 16-byte loads of q and k), kBatch
//   passes in flight together, each reduced with an xor tree over its
//   group; warp 0 takes the softmax with the floored max; then each thread
//   streams its two 16-byte vectors of every valid source row from L2, two
//   slots in flight, and stores each output vector once (fused_vec_kernel:
//   32 registers, so 8 blocks an SM; the same body as a one-row case of a
//   kernel over several rows took 40 registers, 6 blocks an SM, and ran
//   slower on the card);
// - row (any D, vec 1; the rule's form for bf16 values, where it is the
//   fastest): one block per (row, chunk of 256 threads x VEC features),
//   bsp_common.cuh's fused_attention_row, shared with the parts kernel
//   (bsp_fused_parts.cu).
// Two other variants of the vector form were slower on the card at every
// type and are not kept: staging the first 4 slots' vectors with cp.async
// before the logits (the gather, not the wait before it, sets the time,
// and 32 KB of staging a block cut the blocks an SM), and blocks of 4
// consecutive rows x 64 threads whose rows share their sources' features
// through L1. PERF.md section 6 gives the times of all four in turns;
// chip_smoke.py's fused_form_ab times the two kept forms in turns.

#include "bsp_common.cuh"

namespace {

using bsp::kMaxDeg;
using bsp::kMaxDk;
using bsp::kNeg;
using bsp::VecIO;
constexpr int kRowThreads = bsp::kMaxThreads;
constexpr int kBatch = 4;  // passes of the logit groups in flight together

// grid (V, feature chunks), block kRowThreads: the row form.
template <typename T, int VEC>
__global__ void __launch_bounds__(kRowThreads)
fused_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const T* __restrict__ values,
                       const int32_t* __restrict__ ell_src,
                       const uint8_t* __restrict__ ell_mask,
                       T* __restrict__ out, int deg, int dk, long long D) {
  bsp::fused_attention_row<T, T, VEC, false>(q, k, values, ell_src, ell_mask,
                                             out, nullptr, nullptr, deg, dk, D);
}

// This lane's share of <q row qr, k row kr>: loads t, t + G, ... of E
// floats (E 4: 16-byte loads, rows aligned, dk % 4 == 0), one chain in
// order.
__device__ __forceinline__ float qk_lane_dot(const float* __restrict__ qr,
                                             const float* __restrict__ kr, int dk,
                                             bool vec4, int t, int G) {
  float acc = 0.f;
  if (vec4) {
    for (int f = t * 4; f < dk; f += G * 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(qr + f));
      const float4 b = __ldg(reinterpret_cast<const float4*>(kr + f));
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
  } else {
    for (int f = t; f < dk; f += G) acc = fmaf(__ldg(qr + f), __ldg(kr + f), acc);
  }
  return acc;
}

// grid (V, feature chunks of kRowThreads x NV x 16 bytes), block
// kRowThreads: the vector form (values and out 16-byte aligned, D a
// multiple of 16 bytes). Thread tid owns NV 16-byte vectors of row
// blockIdx.x, at features f0 + i * kRowThreads * VEC.
template <typename T, int NV>
__global__ void __launch_bounds__(kRowThreads)
fused_vec_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const T* __restrict__ values,
                 const int32_t* __restrict__ ell_src,
                 const uint8_t* __restrict__ ell_mask, T* __restrict__ out,
                 int deg, int dk, int qk_vec4, long long D) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr long long kStride = static_cast<long long>(kRowThreads) * VEC;
  __shared__ int32_t src_sh[kMaxDeg];
  __shared__ float w_sh[kMaxDeg];
  __shared__ int n_sh;

  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long f0 = static_cast<long long>(blockIdx.y) * NV * kStride + tid * VEC;
  const bool vec4 = qk_vec4 != 0;

  if (tid < 32) {
    const int n = bsp::compact_valid_slots(ell_src, ell_mask, row, deg, src_sh,
                                           nullptr);
    if (lane == 0) n_sh = n;
  }
  __syncthreads();
  const int n = n_sh;

  // Logits, a group of G lanes per slot, kBatch passes in flight together;
  // then the softmax with the floored max in warp 0.
  const int G = bsp::group_lanes(vec4 ? (dk + 3) / 4 : dk);
  const int groups = kRowThreads / G;
  const int grp = tid / G;
  const int t = tid & (G - 1);
  const float* qr = q + row * dk;
  for (int s0 = 0; s0 < n; s0 += groups * kBatch) {
    float part[kBatch];
#pragma unroll
    for (int it = 0; it < kBatch; ++it) {
      const int s = s0 + it * groups + grp;
      part[it] = s < n ? qk_lane_dot(qr, k + static_cast<long long>(src_sh[s]) * dk,
                                     dk, vec4, t, G)
                       : 0.f;
    }
#pragma unroll
    for (int it = 0; it < kBatch; ++it) {
      const float x = bsp::group_sum(part[it], G);
      const int s = s0 + it * groups + grp;
      if (s < n && t == 0) w_sh[s] = x;
    }
  }
  __syncthreads();
  if (tid < 32) {
    float m = kNeg;
    for (int s = lane; s < n; s += 32) m = fmaxf(m, w_sh[s]);
    const float mg = fmaxf(bsp::warp_max(m), kNeg / 2);
    float l = 0.f;
    for (int s = lane; s < n; s += 32) {
      const float e = expf(w_sh[s] - mg);
      w_sh[s] = e;
      l += e;
    }
    l = bsp::warp_sum(l);
    const float inv = l > 0.f ? 1.f / l : 0.f;  // a zero sum gives weight 0
    for (int s = lane; s < n; s += 32) w_sh[s] *= inv;
  }
  __syncthreads();

  // The row's sums in slot order, two slots in flight.
  float acc[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;
#pragma unroll 2
  for (int s = 0; s < n; ++s) {
    const float a = w_sh[s];
    const T* vr = values + static_cast<long long>(src_sh[s]) * D;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const long long f = f0 + i * kStride;
      if (f < D) {
        float x[VEC];
        VecIO<T, VEC>::load(vr + f, x);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][e] = fmaf(a, x[e], acc[i][e]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const long long f = f0 + i * kStride;
    if (f < D) VecIO<T, VEC>::store(out + row * D + f, acc[i]);
  }
}

struct Args {
  const float* q;
  const float* k;
  const void* values;
  const int32_t* ell_src;
  const uint8_t* ell_mask;
  void* out;
  int V, deg, dk, qk_vec4;
  long long D;
  cudaStream_t stream;
};

template <typename T, int VEC>
cudaError_t launch_row(const Args& a) {
  const long long per_block = static_cast<long long>(kRowThreads) * VEC;
  const long long chunks = (a.D + per_block - 1) / per_block;
  if (chunks > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(a.V), static_cast<unsigned>(chunks));
  fused_attention_kernel<T, VEC><<<grid, kRowThreads, 0, a.stream>>>(
      a.q, a.k, static_cast<const T*>(a.values), a.ell_src, a.ell_mask,
      static_cast<T*>(a.out), a.deg, a.dk, a.D);
  return cudaGetLastError();
}

template <typename T, int NV>
cudaError_t launch_vec(const Args& a) {
  constexpr int VEC = 16 / sizeof(T);
  const long long per_block = static_cast<long long>(kRowThreads) * VEC * NV;
  const long long chunks = (a.D + per_block - 1) / per_block;
  if (chunks > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(a.V), static_cast<unsigned>(chunks));
  fused_vec_kernel<T, NV><<<grid, kRowThreads, 0, a.stream>>>(
      a.q, a.k, static_cast<const T*>(a.values), a.ell_src, a.ell_mask,
      static_cast<T*>(a.out), a.deg, a.dk, a.qk_vec4, a.D);
  return cudaGetLastError();
}

}  // namespace

// values_bf16: 0 for f32 values and output, 1 for bf16.
// vec: features per thread per load; 4 (f32) or 8 (bf16) needs D a multiple
// of it and 16-byte aligned rows, 1 takes any D.
// form (bsp.py::FUSED_FORMS): 0 the row form (any vec); 1 the vector form,
// 256 threads of 2 vectors (vec 4 or 8 only).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int bsp_fused_attention(const float* q, const float* k,
                                   const void* values, const int32_t* ell_src,
                                   const uint8_t* ell_mask, void* out, int V,
                                   int deg, int dk, long long D,
                                   int values_bf16, int vec, int form,
                                   int device, void* stream) {
  if (V <= 0 || D <= 0 || deg < 0 || deg > kMaxDeg || dk <= 0 || dk > kMaxDk)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = vec == (values_bf16 ? 8 : 4);
  if (!(wide || vec == 1) || form < 0 || form > 1 || (form == 1 && !wide))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int qk_vec4 = dk % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0
                      && reinterpret_cast<uintptr_t>(k) % 16 == 0;
  const Args a{q, k, values, ell_src, ell_mask, out, V, deg, dk, qk_vec4, D,
               static_cast<cudaStream_t>(stream)};
  if (values_bf16) {
    if (form == 1) err = launch_vec<__nv_bfloat16, 2>(a);
    else if (vec == 8) err = launch_row<__nv_bfloat16, 8>(a);
    else err = launch_row<__nv_bfloat16, 1>(a);
  } else {
    if (form == 1) err = launch_vec<float, 2>(a);
    else if (vec == 4) err = launch_row<float, 4>(a);
    else err = launch_row<float, 1>(a);
  }
  return static_cast<int>(err);
}
