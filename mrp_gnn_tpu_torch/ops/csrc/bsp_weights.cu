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
// each row gathers its key rows straight from ell_src, so padded pairs of
// a plan are inert by construction, and the logits never leave the chip.
//
// Bound: bytes, and tiny. At the training shapes of dynamic_swarm (V 256,
// deg 32, dk 64, 1,680 edges) the function reads q_s, k, ell_src and
// ell_mask once and writes alpha once: 0.2 MB, 0.06 us at 3.35 TB/s; its
// f32 work (2 x edges x dk FMAs and an exp per edge) is 0.2 MFLOP. A call
// is one launch: its time is the launch and one dependent chain of global
// reads (slots, then k rows), not bandwidth. So each form is built to cut
// the chain's round trips and barriers, not its bytes.
//
// Two forms, one function (bsp.py::WEIGHTS_FORMS, by their index here;
// bsp.py::weights_form picks one):
//
// "rows" (form 1; dk a multiple of 8, q_s and k in 16-byte rows, dk <=
// 256): one warp per row, kRowWarps rows a block, no barrier and no shared
// memory, the softmax in registers. Round trip 1: every chunk of 32 slots
// (mask and source together, at most 4 chunks) and the lane's 16-byte
// slice of the q row, held in registers (the lanes of a warp read the same
// q addresses, which L1 broadcasts). Round trip 2: the key rows of the
// valid slots, over groups of G = group_lanes(dk / 8) lanes, S = 32 / G
// slots a pass, kPasses passes with their loads in flight together (one
// round covers a chunk up to dk 64; past it a chunk takes several rounds,
// and a round with no valid slot is skipped). The groups take the slots in
// slot order (group g of pass p: slot p * S + g of the round), a masked
// slot's group idle: no compaction, so no search for the n-th valid slot
// between the slots' round trip and the key rows' (a form built on the
// per-edge SDDMM's compaction, nth_set_bit and a shuffle a pass, was
// slower than this one by more than the softmax costs). Each group's xor
// tree leaves the logit on all its lanes; a shuffle moves it to the lane
// that owns its slot (lane j % 32 of chunk j / 32). Then the max, the exp
// once a slot and the sum are warp reductions, and each chunk of alpha is
// one coalesced store, masked slots included: no second read of the mask
// and no scatter by slot index. Each logit is one fma8 chain and one
// group_sum over the same G lanes as bsp_sddmm.cu's lane_dot, so it has
// the bits of the per-edge bsp.sddmm's for the same (q_s, k) (a launch
// given a logits buffer writes them out, for the tests). At this size an
// exp, a division or a spilled register in a lane's chain costs about as
// much as a round of shuffles: a branch that skipped the exps of a chunk
// without a valid slot made ptxas spill and the kernel slower.
//
// "block" (form 0; any dk up to 256): one block of 256 threads per row,
// the body of the fused attention's weights (bsp_common.cuh,
// row_exp_weights): warp 0 compacts the row's valid slots into shared
// memory, one warp per slot computes its logit with the q row in shared
// memory, warp 0 reduces max and sum, with a barrier after each step; then
// every thread writes its share of the row: 0 on masked slots (a second
// read of the mask), e_j / max(l, 1e-30) on valid ones.

#include "bsp_common.cuh"

namespace {

using bsp::kMaxDeg;
using bsp::kMaxDk;
using bsp::kNeg;
using bsp::kRowWarps;
constexpr int kThreads = bsp::kMaxThreads;
constexpr int kChunks = kMaxDeg / 32;  // chunks of 32 slots in a row
constexpr int kPasses = 8;  // passes of a warp's groups in flight together

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

// grid ceil(V / kRowWarps), block 32 x kRowWarps: one warp per row (deg <=
// 32 * C; dk % 8 == 0, dk <= kMaxDk, 16-byte rows). C: chunks of 32 slots
// (a body for each count: one with 4 chunks unrolled, run at deg 32, was
// slower than the per-edge SDDMM). kRounds: S * kPasses < 32, so a chunk
// takes several rounds (dk > 64; a loop over the rounds, run where one
// round covers the chunk, was slower than the straight call). logits: null,
// or also each slot's logit (0 on masked slots), for the tests.
template <int C, bool kRounds>
__global__ void __launch_bounds__(32 * kRowWarps)
weights_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const int32_t* __restrict__ ell_src,
                    const uint8_t* __restrict__ ell_mask,
                    float* __restrict__ alpha, float* __restrict__ logits,
                    int V, int deg, int dk) {
  const long long row = static_cast<long long>(blockIdx.x) * kRowWarps
                        + (threadIdx.x >> 5);
  if (row >= V) return;
  const int lane = threadIdx.x & 31;
  const int G = bsp::group_lanes(bsp::dot_loads(dk, bsp::kVec8));
  const int S = 32 / G;
  const int grp = lane / G;
  const int t = lane & (G - 1);
  const bool has_q = t * 8 < dk;  // the lane's load of each dot
  const int span = S * kPasses;   // slots a round

  // Round trip 1: the slots of every chunk and the lane's slice of q.
  bool on[C];
  int src[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = c * 32 + lane;
    const bool in = j < deg;
    const long long at = row * deg + j;
    on[c] = in && ell_mask[at] != 0;
    src[c] = in ? ell_src[at] : 0;
  }
  float qv[8];
  if (has_q) {
    bsp::VecIO<float, 8>::load(q + row * dk + t * 8, qv);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) qv[i] = 0.f;
  }
  unsigned valid[C];
#pragma unroll
  for (int c = 0; c < C; ++c) valid[c] = __ballot_sync(0xffffffffu, on[c]);

  // Round trip 2: the logits, each moved to the lane of its slot. A round
  // covers slots base .. base + span - 1 of a chunk: kPasses passes of the
  // warp's S groups of G lanes, group g of pass p on slot base + p * S + g,
  // their key rows' loads in flight together.
  float x[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    x[c] = kNeg;
    if (valid[c] == 0) continue;
    for (int i = 0; i < (kRounds ? 32 / kPasses : 1); ++i) {  // the rounds
      const int base = i * span;
      if (kRounds && (base >= 32 || !((valid[c] >> base) & ((1u << span) - 1u))))
        continue;
      float part[kPasses];
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const int j = base + p * S + grp;  // this group's slot of the chunk
        const bool on_j = j < 32 && ((valid[c] >> (j & 31)) & 1u);
        const int s = __shfl_sync(0xffffffffu, src[c], j & 31);
        part[p] = 0.f;
        if (on_j && has_q) {
          float kv[8];
          bsp::VecIO<float, 8>::load(k + static_cast<long long>(s) * dk + t * 8, kv);
          part[p] = bsp::fma8(qv, kv, 0.f);
        }
      }
      const int r = lane - base;  // this lane's slot's place in the round
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const float dot = bsp::group_sum(part[p], G);
        const float got = __shfl_sync(0xffffffffu, dot, (r & (S - 1)) * G);
        if (r >= 0 && r / S == p) x[c] = got;
      }
    }
    if (!on[c]) x[c] = kNeg;
  }

  // The softmax in registers; masked slots hold kNeg and give e = 0.
  float m = kNeg;
#pragma unroll
  for (int c = 0; c < C; ++c) m = fmaxf(m, x[c]);
  const float mg = fmaxf(bsp::warp_max(m), kNeg / 2);
  float e[C];
  float l = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    e[c] = on[c] ? expf(x[c] - mg) : 0.f;
    l += e[c];
  }
  l = bsp::warp_sum(l);
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = c * 32 + lane;
    if (j < deg) {
      alpha[row * deg + j] = l > 0.f ? e[c] / den : 0.f;
      if (logits != nullptr) logits[row * deg + j] = on[c] ? x[c] : 0.f;
    }
  }
}

}  // namespace

// deg <= 128 and dk <= 256. form (bsp.py::WEIGHTS_FORMS): 0 the block
// form; 1 the rows form, which needs dk a multiple of 8 and q and k
// 16-byte aligned. logits: null, or (rows form only) f32 [V, deg] that
// takes each slot's logit (0 on masked slots). Returns the CUDA error code
// of the launch (0 on success).
extern "C" int bsp_weights(const float* q, const float* k,
                           const int32_t* ell_src, const uint8_t* ell_mask,
                           float* alpha, float* logits, int V, int deg, int dk,
                           int form, int device, void* stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(q) % 16 == 0
                       && reinterpret_cast<uintptr_t>(k) % 16 == 0;
  if (V <= 0 || deg <= 0 || deg > kMaxDeg || dk <= 0 || dk > kMaxDk
      || form < 0 || form > 1
      || (form == 1 && (dk % 8 != 0 || !aligned))
      || (form == 0 && logits != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 0) {
    weights_kernel<<<static_cast<unsigned>(V), kThreads, 0, s>>>(
        q, k, ell_src, ell_mask, alpha, deg, dk);
  } else {
    const unsigned blocks = static_cast<unsigned>((V + kRowWarps - 1) / kRowWarps);
#define BSP_ROWS(C, R)                                                  \
  weights_rows_kernel<C, R><<<blocks, 32 * kRowWarps, 0, s>>>(          \
      q, k, ell_src, ell_mask, alpha, logits, V, deg, dk)
    const bool rounds = 32 / bsp::group_lanes(bsp::dot_loads(dk, bsp::kVec8))
                        * kPasses < 32;
    if (deg <= 32) {
      if (rounds) BSP_ROWS(1, true);
      else BSP_ROWS(1, false);
    } else {
      if (rounds) BSP_ROWS(kChunks, true);
      else BSP_ROWS(kChunks, false);
    }
#undef BSP_ROWS
  }
  return static_cast<int>(cudaGetLastError());
}
