// Masked row softmax over an ELL layout of any width, for Hopper (sm_90a),
// with a plain C interface loaded through ctypes
// (mrp_gnn_tpu_torch/ops/ell.py::softmax).
//
//   x[v, j] = mask[v, j] ? logits[v, j] : -1e30
//   m = max_j x, e[v, j] = mask[v, j] ? exp(x - max(m, -5e29)) : 0
//   out[v, j] = l > 0 ? e / max(l, 1e-30) : 0, with l = sum_j e
//
// f32 in and out [V, deg]; a row with no valid slot gives 0.
//
// Replaces: mrp_gnn_tpu/ops/pallas_ell.py::_softmax_kernel (launched by
// _softmax_forward, entry ell_softmax), which takes [Tv, deg] blocks of
// the logits and the mask into VMEM per grid step.
//
// Bound: bytes. The function reads the logits and the mask once and writes
// the weights once: at the dynamic_swarm shape (V 256, deg 32) 74 KB, about
// 0.00002 ms at 3.35 TB/s, so the launch sets the time.
//
// Design: one warp per row, eight rows per block. The lanes stride over
// the row (coalesced loads), a shuffle reduction gives the max and the sum,
// and each lane writes its slots' weights, recomputing exp rather than
// holding a row of any width in registers.

#include "bsp_common.cuh"

namespace {

using bsp::kNeg;

constexpr int kRowsPerBlock = 8;

// grid ceil(V / kRowsPerBlock), block kRowsPerBlock warps.
__global__ void __launch_bounds__(kRowsPerBlock * 32)
ell_softmax_kernel(const float* __restrict__ logits,
                   const uint8_t* __restrict__ mask, float* __restrict__ out,
                   int V, int deg) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= V) return;
  const int lane = threadIdx.x & 31;
  const float* x = logits + row * deg;
  const uint8_t* mk = mask + row * deg;
  float* o = out + row * deg;

  float m = kNeg;  // below the floor kNeg / 2, so it never changes mg
  for (int j = lane; j < deg; j += 32) m = fmaxf(m, mk[j] ? x[j] : kNeg);
  const float mg = fmaxf(bsp::warp_max(m), kNeg / 2);
  float l = 0.f;
  for (int j = lane; j < deg; j += 32) l += mk[j] ? expf(x[j] - mg) : 0.f;
  l = bsp::warp_sum(l);
  const float den = fmaxf(l, 1e-30f);
  for (int j = lane; j < deg; j += 32)
    o[j] = (l > 0.f && mk[j]) ? expf(x[j] - mg) / den : 0.f;
}

}  // namespace

// logits, out: f32 [V, deg]; mask: bool [V, deg]. deg may be any width.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int ell_softmax(const float* logits, const uint8_t* mask,
                           float* out, int V, int deg, int device,
                           void* stream) {
  if (V <= 0 || deg <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(
      (static_cast<long long>(V) + kRowsPerBlock - 1) / kRowsPerBlock);
  ell_softmax_kernel<<<blocks, kRowsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(logits, mask, out,
                                                            V, deg);
  return static_cast<int>(cudaGetLastError());
}
