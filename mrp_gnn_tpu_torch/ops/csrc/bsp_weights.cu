// Attention weights over an ELL neighbour list (SDDMM and masked row
// softmax in one kernel), for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (mrp_gnn_tpu_torch/ops/bsp.py::attention_weights).
//
//   alpha[v, j] = masked softmax over j of <q_s[v], k[ell_src[v, j]]>
//
// q_s is f32 [V, dk], pre-scaled by 1/sqrt(dk) by the caller; k f32
// [Vs, dk]; ell_src int32 / ell_mask uint8 [V, deg]; alpha f32 [V, deg].
// The reference's guards hold: the max is floored at -5e29, the sum is
// guarded by 1e-30, a masked slot and every slot of a row without a valid
// one give exactly 0, and a duplicate edge counts once per slot.
//
// Replaces: mrp_gnn_tpu/ops/pallas_bsp.py::_weights_kernel (launched by
// _weights_forward; vjp _bsp_weights, entry bsp_attention). The TPU kernel
// walks the (dst tile, src tile) pair plan, takes one [Tv, dk] x [dk, Ts]
// MXU product per pair, picks each slot's column with one-hot selections
// and carries the logits in VMEM scratch across the tile group, so they
// never reach HBM; the JAX package keeps this two-kernel form beside the
// fused one because the partitioned path needs an explicit alpha. Here
// each block gathers its key rows straight from ell_src, so padded pairs
// of a plan are inert by construction, and the logits stay in shared
// memory as they stay in VMEM there.
//
// Bound: bytes, and tiny. At the training shapes of dynamic_swarm (V 256,
// deg 32, dk 64, 1,680 edges) the function reads q_s, k, ell_src and
// ell_mask once and writes alpha once: 0.2 MB, 0.06 us at 3.35 TB/s; its
// f32 work (2 x edges x dk FMAs and an exp per edge) is 0.2 MFLOP. A call
// is one launch: its time is the launch and one dependent chain of global
// reads (mask, then src, then k rows), not bandwidth.
//
// Design: one block of 256 threads per destination row, the body of the
// fused attention's weights (bsp_common.cuh, row_exp_weights): warp 0
// compacts the row's valid slots into shared memory, one warp per slot
// computes its logit with the q row in shared memory, warp 0 reduces max
// and sum. Then every thread writes its share of the row: 0 on masked
// slots, e_j / max(l, 1e-30) on valid ones.

#include "bsp_common.cuh"

namespace {

using bsp::kMaxDeg;
using bsp::kMaxDk;
constexpr int kThreads = bsp::kMaxThreads;

// grid V, block kThreads.
__global__ void __launch_bounds__(kThreads)
weights_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const int32_t* __restrict__ ell_src,
               const uint8_t* __restrict__ ell_mask,
               float* __restrict__ alpha, int deg, int dk) {
  __shared__ bsp::RowWeights sh;
  const long long row = blockIdx.x;
  bsp::row_exp_weights(q, k, ell_src, ell_mask, row, deg, dk, sh);
  float* out = alpha + row * deg;
  for (int j = threadIdx.x; j < deg; j += kThreads)
    if (ell_mask[row * deg + j] == 0) out[j] = 0.f;
  const float l = sh.l;
  const float den = fmaxf(l, 1e-30f);
  for (int s = threadIdx.x; s < sh.n; s += kThreads)
    out[sh.slot[s]] = l > 0.f ? sh.w[s] / den : 0.f;
}

}  // namespace

// deg <= 128 and dk <= 256 (the row is kept in shared memory). Returns the
// CUDA error code of the launch (0 on success).
extern "C" int bsp_weights(const float* q, const float* k,
                           const int32_t* ell_src, const uint8_t* ell_mask,
                           float* alpha, int V, int deg, int dk, int device,
                           void* stream) {
  if (V <= 0 || deg <= 0 || deg > kMaxDeg || dk <= 0 || dk > kMaxDk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  weights_kernel<<<static_cast<unsigned>(V), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      q, k, ell_src, ell_mask, alpha, deg, dk);
  return static_cast<int>(cudaGetLastError());
}
