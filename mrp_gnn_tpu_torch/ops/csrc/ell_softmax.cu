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
// 0.00002 ms at 3.35 TB/s, so the launch and the chain of round trips set
// the time, not bandwidth.
//
// Two forms, one function (ell.py::SOFTMAX_FORMS, by their index here;
// ell.py::softmax_form picks one):
//
// "register" (form 1; deg up to 128, any alignment): one round trip, the
// row in registers. A row is covered by a group of G = group_lanes(min(deg,
// 32)) lanes, 32 / G rows a warp (a warp a row at deg 32), and each lane
// holds the slots j = t, t + G, .. of its row, at most 4. Every load (the
// logits' and the mask's, each coalesced over the group) is issued
// unconditionally before any is used, so the logits' loads never wait on
// the mask's; masked slots become kNeg, the group max and sum take log2 G
// xor shuffles each, and each exp and each division is taken once per slot
// (one body for each count of slots a lane: 1, 2 or 4). A layout of 4
// slots a lane (one float4 of logits, one 32-bit word of mask, deg / 4
// lanes a row) took 4 exps and 4 divisions in each lane's chain and was
// slower at the ell path's width than the loop form (PERF.md section 6).
//
// "loop" (form 0; any width): one warp per row, kLoopRows rows a block.
// The lanes stride over the row (coalesced loads), a shuffle reduction
// gives the max and the sum, and each lane writes its slots' weights,
// recomputing exp rather than holding a row of any width in registers.
// Each pass reads the logit before the mask's select, so neither load waits
// on the other.

#include "bsp_common.cuh"

namespace {

using bsp::kNeg;

constexpr int kLoopRows = 8;          // warps (rows) a block of the loop form
constexpr int kRegisterThreads = 128;  // threads a block of the register form
constexpr int kChunks = 4;             // most slots a lane, register form
constexpr int kRegisterMaxDeg = 32 * kChunks;

// grid ceil(V / kLoopRows), block kLoopRows warps.
__global__ void __launch_bounds__(kLoopRows * 32)
ell_softmax_kernel(const float* __restrict__ logits,
                   const uint8_t* __restrict__ mask, float* __restrict__ out,
                   int V, int deg) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kLoopRows + (threadIdx.x >> 5);
  if (row >= V) return;
  const int lane = threadIdx.x & 31;
  const float* x = logits + row * deg;
  const uint8_t* mk = mask + row * deg;
  float* o = out + row * deg;

  float m = kNeg;  // below the floor kNeg / 2, so it never changes mg
  for (int j = lane; j < deg; j += 32) {
    const float xv = x[j];
    m = fmaxf(m, mk[j] ? xv : kNeg);
  }
  const float mg = fmaxf(bsp::warp_max(m), kNeg / 2);
  float l = 0.f;
  for (int j = lane; j < deg; j += 32) {
    const float xv = x[j];
    l += mk[j] ? expf(xv - mg) : 0.f;
  }
  l = bsp::warp_sum(l);
  const float den = fmaxf(l, 1e-30f);
  for (int j = lane; j < deg; j += 32) {
    const float xv = x[j];
    o[j] = (l > 0.f && mk[j]) ? expf(xv - mg) / den : 0.f;
  }
}

// grid ceil(V / rows a block), block kRegisterThreads; deg <= 32 * C, C
// slots a lane (a body of 4 slots run at deg 32 was slower than this one
// of 1: the slots past the row still cost their instructions).
template <int C>
__global__ void __launch_bounds__(kRegisterThreads)
ell_softmax_register_kernel(const float* __restrict__ logits,
                            const uint8_t* __restrict__ mask,
                            float* __restrict__ out, int V, int deg) {
  const int G = bsp::group_lanes(deg);
  const int lane = threadIdx.x & 31;
  const int t = lane & (G - 1);
  const long long row =
      (static_cast<long long>(blockIdx.x) * (kRegisterThreads / 32)
       + (threadIdx.x >> 5)) * (32 / G) + lane / G;
  // Every lane takes part in the shuffles; only live slots are read and
  // written.
  const bool live = row < V;
  float x[C];
  bool v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = c * G + t;
    const bool in = live && j < deg;
    const long long at = row * deg + j;
    x[c] = in ? logits[at] : kNeg;
    v[c] = in && mask[at] != 0;
  }
  float m = kNeg;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    x[c] = v[c] ? x[c] : kNeg;
    m = fmaxf(m, x[c]);
  }
  const float mg = fmaxf(bsp::group_max(m, G), kNeg / 2);
  float l = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    x[c] = v[c] ? expf(x[c] - mg) : 0.f;
    l += x[c];
  }
  l = bsp::group_sum(l, G);
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = c * G + t;
    if (live && j < deg)
      out[row * deg + j] = (l > 0.f && v[c]) ? x[c] / den : 0.f;
  }
}

template <int C>
void launch_register(const float* logits, const uint8_t* mask, float* out,
                     int V, int deg, cudaStream_t s) {
  const long long rows = kRegisterThreads / 32 * (32 / bsp::group_lanes(deg));
  const unsigned blocks = static_cast<unsigned>((V + rows - 1) / rows);
  ell_softmax_register_kernel<C><<<blocks, kRegisterThreads, 0, s>>>(
      logits, mask, out, V, deg);
}

}  // namespace

// logits, out: f32 [V, deg]; mask: bool [V, deg]. form
// (ell.py::SOFTMAX_FORMS): 0 the loop form, any width; 1 the register
// form, deg up to 128. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int ell_softmax(const float* logits, const uint8_t* mask,
                           float* out, int V, int deg, int form, int device,
                           void* stream) {
  if (V <= 0 || deg <= 0 || form < 0 || form > 1
      || (form == 1 && deg > kRegisterMaxDeg))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 0) {
    const unsigned blocks = static_cast<unsigned>(
        (static_cast<long long>(V) + kLoopRows - 1) / kLoopRows);
    ell_softmax_kernel<<<blocks, kLoopRows * 32, 0, s>>>(logits, mask, out,
                                                         V, deg);
  } else if (deg <= 32) {
    launch_register<1>(logits, mask, out, V, deg, s);
  } else if (deg <= 64) {
    launch_register<2>(logits, mask, out, V, deg, s);
  } else {
    launch_register<kChunks>(logits, mask, out, V, deg, s);
  }
  return static_cast<int>(cudaGetLastError());
}
