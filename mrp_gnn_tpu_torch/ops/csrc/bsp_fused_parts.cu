// The one-pass attention forward past 128 in-neighbours, in two forms, for
// Hopper (sm_90a), with a plain C interface loaded through ctypes
// (mrp_gnn_tpu_torch/ops/bsp.py::fused_attention_parts and
// ::expanded_forward).
//
// Per-edge form: the raw online-softmax parts over a row-expanded ELL list.
// For each expanded row r (node v's list split over rows v*R .. v*R+R-1, at
// most 128 slots each):
//   x_j    = <q_x[r], k[src_x[r, j]]> over the row's valid slots j
//   m[r]   = max(-1e30, max_j x_j)            (-1e30 when no slot is valid)
//   l[r]   = sum_j exp(x_j - max(m[r], -5e29))
//   acc[r] = sum_j exp(x_j - max(m[r], -5e29)) * values[src_x[r, j]]
// in f32, acc not divided. The caller (bsp.py::xp_combine) folds a node's
// R triples into one softmax. q_x is f32 [V*R, dk], already scaled by
// 1/sqrt(dk) and repeated R times; k f32 [Vs, dk]; values f32 or bf16
// [Vs, D]; acc f32 [V*R, D]; m, l f32 [V*R]. A duplicate edge counts once
// per slot; a row with no valid slot gives m = -1e30, l = 0, acc = 0.
//
// Tiled form: the whole forward on the node view [V, R*W] of the same lists
// (one reshape: a node's slots in order, pad columns mask-False):
//   out[v] = sum_j alpha_vj * values[src_vj],  alpha = the masked softmax of
//   node v's logits <q_s[v], k[src_vj]> (max floored at -5e29; 0 for a node
//   with no valid slot)
// with f32 sums, in the values' type. q_s f32 [V, dk]; out [V, D].
//
// Replaces: mrp_gnn_tpu/ops/pallas_bsp.py::_fused_parts_kernel (launched by
// _fused_parts_forward, entry expanded_attention_fused) and, in the tiled
// form, its XLA combine _xp_combine. The TPU kernel runs the one-pass fused
// body over the rectangular (V*R dst, V src) tile plan and emits (acc, m, l)
// per expanded row instead of dividing: the split over R rows and the
// combine exist because Mosaic's kernels take at most 128 ELL columns.
//
// Bound: operations. At the dense-swarm shapes (2 scenes x 193 robots in
// 512 slots, in-degree 192 as 2 x 96, 74,112 edges, dk 64, D 8192, f32)
// the function reads values once (16.8 MB) and writes its output once
// (16.8 MB in the tiled form; the per-edge form's acc is 33.5 MB); its f32
// work, edges x (2 dk + 1 + 2 D) flops (1.22 GFLOP), takes 0.018 ms at
// 67 TFLOP/s. Which form runs is the caller's rule (bsp.py::tiled_form, the
// rule of bsp_sddmm.cu and bsp_spmm_t.cu), so at that shape the tiled one.
//
// Per-edge design: the body of bsp_fused_attention.cu (bsp_common.cuh,
// fused_attention_row with kParts), one block per (expanded row, chunk of
// 256 threads x 16 bytes of features). What bounds it: the gathers read
// each value row once per in-edge from L2 (192 times, 2.4 GB at one FMA per
// 4 bytes), and the split writes acc at [V*R, D] f32 for the torch combine
// to read back.
//
// Tiled design: three steps on the stream, no float atomics, the same bits
// every launch.
// 1. One memset clears the dense weights and the pair flags (scratch).
// 2. fused_parts_weights_kernel, one block per node v over all its slots,
//    256 at a time: the logits (one thread per slot, a chain of FMAs over
//    dk, 16-byte loads of k), the block's max and sum in a fixed order, and
//    alpha = e / l, written into column v of the dense weights
//    Wt[s, v] (f32 [nts * 64, nt * 64]) and the flags of the (source tile,
//    destination tile) pairs it touches. Duplicates are summed in slot
//    order by the thread of their first slot, found as bsp_spmm_t.cu's
//    densify_kernel finds them (integer counts in the zeroed column).
// 3. fused_parts_tiled_kernel, grid (feature chunks of 128, destination
//    tiles of 64): the tile loop of bsp_tiled.cuh (the one the tiled
//    transposed SpMM runs), out[v] = sum over the flagged source tiles of
//    Wt[s, v] * values[s], s ascending, staged with a two-buffer cp.async
//    ring, an 8 x 8 register tile per thread of f32 FMAs (no TF32: the
//    training terms hold 1e-5), each output written once in the values'
//    type. Writing W transposed makes its tiles contiguous rows, so the
//    loop is the transposed SpMM's unchanged.
// So each value row is read once per (source tile, destination tile) pair
// that holds an edge (31 pairs at the dense swarm, about 4 per value row),
// not once per in-edge, and nothing of the size of acc leaves the kernels.
// The dense tiles are 1.7x the edge work at that view. As in the TPU
// kernel's dense product per tile pair, a non-finite value spreads to its
// tile's outputs through a zero weight; the model's values are finite.

#include "bsp_tiled.cuh"

namespace {

using bsp::kMaxDeg;
using bsp::kMaxDk;
using bsp::kMaxWarps;
using bsp::kNeg;
constexpr int kThreads = bsp::kMaxThreads;
constexpr int kT = bsp::kTile;

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

// --- the tiled form ---------------------------------------------------------

// The block's max (op = fmaxf) or sum of one value per thread, in a fixed
// order: a warp butterfly, then the warps in order. Every thread gets it.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  x = kMax ? bsp::warp_max(x) : bsp::warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float t = kMax ? kNeg : 0.f;
#pragma unroll
  for (int w = 0; w < kMaxWarps; ++w) t = kMax ? fmaxf(t, red[w]) : t + red[w];
  __syncthreads();  // red is reused by the next reduction
  return t;
}

// grid V, block kThreads: node v's weights over its deg slots (any width)
// into column v of Wt (f32, row pitch VP = nt * kT; cleared by the caller,
// whose zeros first serve as integer counts) and the flags of its (source
// tile, destination tile) pairs, flags[st * nt + dt]. alpha [V, deg] is
// scratch: a slot's logit, then e, then alpha, owned by one thread until
// the duplicates are summed.
__global__ void __launch_bounds__(kThreads)
fused_parts_weights_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const int32_t* __restrict__ ell_src,
                           const uint8_t* __restrict__ ell_mask,
                           float* alpha, float* __restrict__ Wt,
                           uint8_t* __restrict__ flags, int deg, int dk,
                           int VP, int nt) {
  __shared__ __align__(16) float q_sh[kMaxDk];
  __shared__ float red[kMaxWarps];
  const long long v = blockIdx.x;
  const int tid = threadIdx.x;
  const int32_t* src = ell_src + v * deg;
  const uint8_t* mask = ell_mask + v * deg;
  float* a = alpha + v * deg;
  int* count = reinterpret_cast<int*>(Wt);  // 0.f and 0 have the same bits
  // The slots naming each source, counted in column v first (integer
  // atomics: the same counts every launch), so that the round trip of the
  // counts overlaps the logits.
  for (int j = tid; j < deg; j += kThreads)
    if (mask[j]) atomicAdd(count + static_cast<long long>(src[j]) * VP + v, 1);
  for (int i = tid; i < dk; i += kThreads) q_sh[i] = q[v * dk + i];
  __syncthreads();
  const bool vec4 = dk % 4 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0;

  float m = kNeg;
  for (int j = tid; j < deg; j += kThreads) {
    if (!mask[j]) continue;
    const float* kr = k + static_cast<long long>(src[j]) * dk;
    float x = 0.f;
    if (vec4) {
      for (int d = 0; d < dk; d += 4) {
        const float4 kv = __ldg(reinterpret_cast<const float4*>(kr + d));
        const float4 qv = *reinterpret_cast<const float4*>(q_sh + d);
        x = fmaf(qv.x, kv.x, x);
        x = fmaf(qv.y, kv.y, x);
        x = fmaf(qv.z, kv.z, x);
        x = fmaf(qv.w, kv.w, x);
      }
    } else {
      for (int d = 0; d < dk; ++d) x = fmaf(q_sh[d], __ldg(kr + d), x);
    }
    a[j] = x;
    m = fmaxf(m, x);
  }
  const float mg = fmaxf(block_reduce<true>(m, red), kNeg / 2);
  bool dup = false;
  float l = 0.f;
  for (int j = tid; j < deg; j += kThreads) {
    if (!mask[j]) continue;
    dup |= __ldcg(count + static_cast<long long>(src[j]) * VP + v) > 1;
    const float e = expf(a[j] - mg);
    a[j] = e;
    l += e;
  }
  l = block_reduce<false>(l, red);
  for (int j = tid; j < deg; j += kThreads)
    if (mask[j]) a[j] = l > 0.f ? a[j] / l : 0.f;
  // Every count is read and every alpha written before any count is
  // replaced: each slot's alpha, or, in a node with a duplicate, each
  // source's sum in slot order, by the thread of its first slot.
  dup = __syncthreads_or(dup);
  for (int j = tid; j < deg; j += kThreads) {
    if (!mask[j]) continue;
    const int32_t s = src[j];
    float t = a[j];
    if (dup) {
      bool first = true;
      for (int i = 0; i < j && first; ++i) first = !(mask[i] && src[i] == s);
      if (!first) continue;  // the thread of the first such slot sums them
      for (int i = j + 1; i < deg; ++i)
        if (mask[i] && src[i] == s) t += __ldcg(a + i);
    }
    Wt[static_cast<long long>(s) * VP + v] = t;
    flags[static_cast<long long>(s / kT) * nt + v / kT] = 1;
  }
}

// grid (feature chunks, nt destination tiles), block bsp::kTileThreads,
// bsp::kTileSmemBytes of dynamic shared memory: out[v] = sum over the Vs
// sources s of Wt[s, v] * values[s] (bsp_tiled.cuh, with the roles of its
// rows and outputs taken by the sources and the destinations). Two blocks
// per SM.
__global__ void __launch_bounds__(bsp::kTileThreads, 2)
fused_parts_tiled_kernel(bsp::TiledPair p, const uint8_t* __restrict__ flags,
                         int V, int Vs, int nt, int nts) {
  bsp::tiled_product(p, p, gridDim.x, flags, Vs, V, nts, nt);
}

long long dense_floats(int V, int Vs) {
  return static_cast<long long>((Vs + kT - 1) / kT) * kT * ((V + kT - 1) / kT) * kT;
}

long long flag_bytes(int V, int Vs) {  // rounded up to keep alpha aligned
  const long long n = static_cast<long long>((V + kT - 1) / kT) * ((Vs + kT - 1) / kT);
  return (n + 15) / 16 * 16;
}

long long tiled_scratch(int V, int Vs, int deg) {
  return dense_floats(V, Vs) * 4 + flag_bytes(V, Vs)
         + static_cast<long long>(V) * deg * 4;
}

cudaError_t launch_tiled(const float* q, const float* k, const void* values,
                         const int32_t* ell_src, const uint8_t* ell_mask,
                         void* out, int V, int Vs, int deg, int dk,
                         long long D, int pair_flags, void* scratch,
                         cudaStream_t stream) {
  const int nt = (V + kT - 1) / kT;
  const int nts = (Vs + kT - 1) / kT;
  const long long chunks = bsp::tiled_chunks(D);
  if (nt > 65535 || chunks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  float* Wt = static_cast<float*>(scratch);
  uint8_t* flags = reinterpret_cast<uint8_t*>(Wt + dense_floats(V, Vs));
  float* alpha = reinterpret_cast<float*>(flags + flag_bytes(V, Vs));
  cudaError_t err = cudaMemsetAsync(
      Wt, 0, static_cast<size_t>(dense_floats(V, Vs) * 4 + flag_bytes(V, Vs)),
      stream);
  if (err != cudaSuccess) return err;
  fused_parts_weights_kernel<<<static_cast<unsigned>(V), kThreads, 0, stream>>>(
      q, k, ell_src, ell_mask, alpha, Wt, flags, deg, dk, nt * kT, nt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused_parts_tiled_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bsp::kTileSmemBytes);
  if (err != cudaSuccess) return err;
  const bsp::TiledPair p{nullptr, values, out, D, pair_flags, Wt};
  fused_parts_tiled_kernel<<<dim3(static_cast<unsigned>(chunks), nt),
                             bsp::kTileThreads, bsp::kTileSmemBytes, stream>>>(
      p, flags, V, Vs, nt, nts);
  return cudaGetLastError();
}

}  // namespace

// Bytes of scratch the tiled form needs (the caller allocates them): V
// destination nodes, Vs sources, deg slots per node.
extern "C" long long bsp_fused_parts_scratch(int V, int Vs, int deg) {
  return tiled_scratch(V, Vs, deg);
}

// tiled 0, the per-edge form: rows the expanded rows (V*R), deg their width
// (<= 128), acc, m and l f32; Vs and scratch unused. vec: features per
// thread per load, 4 (f32) or 8 (bf16) needs D a multiple of it and 16-byte
// aligned rows of values and acc, 1 takes any D.
// tiled 1: rows the nodes V, ell_src / ell_mask their node view [V, deg]
// (any width), `acc` the output [V, D] in the values' type; m and l unused;
// Vs the rows of k and values; bsp_fused_parts_scratch(V, Vs, deg) bytes of
// scratch. vec 8: 16-byte loads (D a multiple of 8, values and out 16-byte
// aligned), else 1.
// values_bf16: 0 for f32 values, 1 for bf16. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int bsp_fused_parts(const float* q, const float* k,
                               const void* values, const int32_t* ell_src,
                               const uint8_t* ell_mask, void* acc, float* m,
                               float* l, int rows, int deg, int dk,
                               long long D, int values_bf16, int vec,
                               int tiled, int Vs, void* scratch, int device,
                               void* stream) {
  if (rows <= 0 || D <= 0 || deg < 0 || (!tiled && deg > kMaxDeg) || dk <= 0
      || dk > kMaxDk || (tiled && (Vs <= 0 || deg == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiled) {
    const int flags = (values_bf16 ? bsp::kXBf16 | bsp::kOutBf16 : 0)
                      | (vec == 8 ? bsp::kVec8 : 0);
    return static_cast<int>(launch_tiled(q, k, values, ell_src, ell_mask, acc,
                                         rows, Vs, deg, dk, D, flags, scratch,
                                         s));
  }
  float* a = static_cast<float*>(acc);
  if (values_bf16) {
    if (vec == 8) err = launch<__nv_bfloat16, 8>(q, k, values, ell_src, ell_mask, a, m, l, rows, deg, dk, D, s);
    else if (vec == 1) err = launch<__nv_bfloat16, 1>(q, k, values, ell_src, ell_mask, a, m, l, rows, deg, dk, D, s);
    else err = cudaErrorInvalidValue;
  } else {
    if (vec == 4) err = launch<float, 4>(q, k, values, ell_src, ell_mask, a, m, l, rows, deg, dk, D, s);
    else if (vec == 1) err = launch<float, 1>(q, k, values, ell_src, ell_mask, a, m, l, rows, deg, dk, D, s);
    else err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
