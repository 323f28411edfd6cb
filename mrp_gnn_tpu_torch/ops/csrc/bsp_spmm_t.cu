// Transposed weighted neighbour sums over an ELL neighbour list, one pair of
// operands or two, for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (mrp_gnn_tpu_torch/ops/bsp.py::spmm_t and ::spmm_t2).
//
//   out1[s] = sum over valid slots (v, j) with ell_src[v, j] = s of
//             w1[v, j] * x1[v]
//   out2[s] = the same sum of w2[v, j] * x2[v]   (dual form only)
//
// w1, w2 are f32 [V, deg]; x1 [V, D1] and x2 [V, D2] f32 or bf16 each, of
// any two widths; out1 [Vs, D1] and out2 [Vs, D2] f32 or bf16 each, with
// f32 sums. A source no valid slot names gives 0.
//
// Replaces: mrp_gnn_tpu/ops/pallas_bsp.py::_spmm_t_kernel (launched by
// _spmm_t_forward) and, in the dual form, ::_spmm_t2_kernel (launched by
// _spmm_t2_forward). The TPU kernels walk a source-major re-sort of the
// tile-pair plan and accumulate A(pair)^T @ x[dst tile] per source tile on
// the MXU; the dual one builds each pair's one-hot selection once for both
// products. In the training step the pair is dvalues (w = alpha, x = the
// output cotangent, D 8192) and dk (w = dlog, x = q_s, D 64) of the fused
// attention's backward, which launches the dual form for both. The JAX
// package runs them as two single sweeps (a chip A/B found its dual no
// faster) and keeps the dual kernel for its benchmark; its fallback to two
// sweeps past an x2 width of 512 is a VMEM limit that this kernel does not
// have.
//
// Three forms, deterministic (no float atomics: two launches give the same
// bits, and the dual form gives the bits of two single ones, since each
// output of a form is one fixed chain of f32 FMAs that does not depend on
// the other pair). Which runs is a rule on the ELL shape, applied by the
// caller (bsp.py::spmm_t_form, the tiled side of which is bsp_sddmm.cu's
// rule), so the single and the dual form always take the same one. PERF.md
// section 6 gives the times behind the rule, measured on the card.
//
// Per-edge form. The caller passes a source-major view of the valid slots
// (bsp.py::source_view, built on the device with a stable sort), `offsets`
// [Vs + 1] and `slots` (v * deg + j, in (v, j) order within each source).
// Each output element is one chain of f32 FMAs over its source's slots in
// that order. Bound: bytes. The function reads w, x, ell_src and ell_mask
// once and writes out once; at dvalues' shape (V 256, D 8192, f32) that is
// 16.8 MB, about 5 us at 3.35 TB/s. The gathers read each x row once per
// out-edge (about 6.6 times), mostly from the 50 MB L2. One block per
// (source row, chunk of the feature axis); each thread walks the source's
// slot list (uniform loads, served by L1) and streams its VEC features of
// each destination row with 16-byte loads and f32 FMAs, then writes its
// features of the output row once. In the dual form thread t owns features
// [t * VEC1, ...) of x1 and [t * VEC2, ...) of x2, so the threads that own
// features of both read each slot's index and destination once for both.
// The view costs a device sort and several launches on every call; only
// the rule's large graphs, and the tests, still run this form.
//
// Staged form (ELL widths below the tiled form's; one launch, no view, no
// scratch, no host sync). Bound: bytes, as above; no tensor cores: at about
// 6.6 valid slots per source the function does 2 FLOP per 4 bytes of x, and
// TF32 keeps too few digits for the training step's 1e-5 parity. Grid
// (blocks of kStChunks = 2 feature chunks of kStF = 128, of both outputs;
// source tiles of kStSources = 64); a block of 16 warps owns, chunk by
// chunk, the outputs [its 64 sources] x [128 features] in registers (a warp
// 4 sources, a lane 4 features of each):
// 1. the block reads the whole index (ell_src and ell_mask, 16 and 4 bytes
//    a load, several loads in flight) and flags each window of kStRows = 64
//    destination rows that holds a valid slot naming one of its sources;
//    the index stays in L1 for the next steps;
// 2. where one window is flagged (the swarm's graphs: a tile of 64 nodes is
//    two whole scenes), its weights and its 64 rows' features of both
//    chunks (two buffers) are copied to shared memory with cp.async at
//    once (rows that are not 16-byte aligned through registers), so the
//    copies overlap steps 3-4. Each x row is read once per (source tile,
//    chunk) instead of once per out-edge;
// 3. each warp takes a contiguous segment of the window's slots and counts,
//    by source, those that are valid and name a source of the tile (integer
//    shared-memory atomics: the same counts in any order; a probe of 128
//    slots, 4 a lane, skips those with none); one warp turns the counts
//    into each source's list offset and each warp's first position in it;
// 4. once the weights have landed, each warp places its slots in the list
//    (the weight and the slot's row in the window): a stable counting sort
//    (the lanes of one source ranked by ballots), so the list is
//    source-major and each source's slots keep (v, j) order;
// 5. each warp runs its 4 sources' chains over the list and the first
//    chunk's rows, the sources' steps interleaved, and writes them; then
//    the same over the second chunk's rows.
// Where several windows are flagged, each chunk walks them in order, a copy
// and a list each, into the same registers. Each output element is then
// the per-edge form's chain, in the same order from 0.f, over the same f32
// weights and the same f32 (or exactly widened bf16) x: the two forms give
// the same bits. In the dual form the blocks before c1 sum the first pair
// and the rest the second, as in the tiled form: one launch, and each
// pair's blocks do what a single launch's do. One block an SM (120
// registers a thread; at 64, two blocks an SM spilled and ran slower); a
// block per chunk of 256 features, one list and one buffer, ran slower on
// the card (its writes all came at the end). Every block reads the whole
// index (40 KB at the swarm's V 256 x width 32), so the cost grows with V
// x Vs, and its chains are instruction-bound (a few instructions of list
// and address work per entry and lane for 4 FMAs), so they grow with the
// width: bsp.py::spmm_t_form keeps the per-edge form and its view past
// STAGED_MAX_NODES nodes and an ELL width of STAGED_MAX_DEG, where the card
// measured them faster (PERF.md section 6). The window's list and weights
// take 9 bytes a slot, so the form takes ELL widths up to about 280 in 227
// KB of shared memory; the rule gives it widths up to 32.
//
// Tiled form. Bound: operations at a wide ELL. At the high-degree
// backward's node view (V 512, deg 192, 74,112 edges, D 8192 and dk 64) the
// function is 1.22 GFLOP (0.018 ms at 67 TFLOP/s f32) against 52 MB; the
// per-edge form streams a destination row of x from L2 for every out-edge,
// 2.4 GB at one FMA per 4 bytes. Here the node axes are cut into tiles of
// kTile = 64, and x is read from L2 once per (source tile, destination
// tile) pair that holds a valid slot. Three steps:
// 1. the pair flags are cleared (one memset of nt x nts bytes);
// 2. densify_kernel, one block per destination row v: the row of a dense
//    weight matrix W[v, s] (f32 [nt * 64, nts * 64], in scratch) gets the
//    sum of w over the row's valid slots naming s, 0 elsewhere, and the flag
//    of each (dt, st) pair it touches. Duplicates are added in slot order by
//    the thread of their first slot (no float atomics); integer counts find
//    the rows that have any. The dual form fills both weight matrices in
//    this one walk of the slots;
// 3. spmm_t_tiled_kernel, grid (feature chunks of 128 of both outputs,
//    source tiles): the block walks the destination tiles in order, skips
//    those whose flag is 0, stages the [64, 64] tile of W and x[dst tile,
//    chunk] in shared memory (48 KB a pair, two buffers: the next pair's
//    tiles are copied in with cp.async while the current ones are
//    multiplied; bf16 or unaligned x rows go through registers) and
//    accumulates an 8 x 8 register tile per thread (128 threads; four
//    16-byte shared-memory reads per 64 FMAs) with f32 FMAs, v ascending,
//    then writes its outputs once. Two blocks per SM. The loop lives in
//    bsp_tiled.cuh, which bsp_fused_parts.cu's tiled forward shares.
// Each output element is then one chain over the destination nodes in
// order, with a node's duplicate slots pre-summed. As with the TPU kernel's
// dense product per tile pair, a non-finite x element spreads to its tile's
// outputs through a zero weight; the training step's operands are finite.

#include "bsp_tiled.cuh"

namespace {

using bsp::cp_async16;
using bsp::cp_async_commit;
using bsp::kOutBf16;
using bsp::kVec8;
using bsp::kXBf16;
using bsp::load_row;
using bsp::store_row;
using bsp::VecIO;

// grid (Vs, feature chunks), block a multiple of 32 up to kMaxThreads.
template <typename TX, typename TO, int VEC>
__global__ void __launch_bounds__(bsp::kMaxThreads)
spmm_t_kernel(const float* __restrict__ w, const TX* __restrict__ x,
              const int32_t* __restrict__ offsets,
              const int32_t* __restrict__ slots, TO* __restrict__ out,
              int deg, long long D) {
  const long long s = blockIdx.x;
  const long long f0 =
      (static_cast<long long>(blockIdx.y) * blockDim.x + threadIdx.x) * VEC;
  if (f0 >= D) return;
  const int beg = offsets[s];
  const int end = offsets[s + 1];
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int e = beg; e < end; ++e) {
    const int slot = __ldg(slots + e);
    const long long v = slot / deg;
    const float a = __ldg(w + slot);
    float xv[VEC];
    VecIO<TX, VEC>::load(x + v * D + f0, xv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = fmaf(a, xv[i], acc[i]);
  }
  VecIO<TO, VEC>::store(out + s * D + f0, acc);
}

// The dual form: grid (Vs, feature chunks of the wider operand), block a
// multiple of 32 up to kMaxThreads. Each sum is the single form's chain.
template <int VEC1, int VEC2>
__global__ void __launch_bounds__(bsp::kMaxThreads)
spmm_t2_kernel(const float* __restrict__ w1, const void* __restrict__ x1,
               void* __restrict__ out1, long long D1, int flags1,
               const float* __restrict__ w2, const void* __restrict__ x2,
               void* __restrict__ out2, long long D2, int flags2,
               const int32_t* __restrict__ offsets,
               const int32_t* __restrict__ slots, int deg) {
  const long long s = blockIdx.x;
  const long long t =
      static_cast<long long>(blockIdx.y) * blockDim.x + threadIdx.x;
  const long long f1 = t * VEC1;
  const long long f2 = t * VEC2;
  const bool has1 = f1 < D1;
  const bool has2 = f2 < D2;
  if (!has1 && !has2) return;
  const bool x1_bf16 = flags1 & kXBf16;
  const bool x2_bf16 = flags2 & kXBf16;
  const int beg = offsets[s];
  const int end = offsets[s + 1];
  float acc1[VEC1], acc2[VEC2];
#pragma unroll
  for (int i = 0; i < VEC1; ++i) acc1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < VEC2; ++i) acc2[i] = 0.f;
#pragma unroll 4
  for (int e = beg; e < end; ++e) {
    const int slot = __ldg(slots + e);
    const long long v = slot / deg;
    if (has1) {
      const float a = __ldg(w1 + slot);
      float xv[VEC1];
      load_row<VEC1>(x1, x1_bf16, v * D1 + f1, xv);
#pragma unroll
      for (int i = 0; i < VEC1; ++i) acc1[i] = fmaf(a, xv[i], acc1[i]);
    }
    if (has2) {
      const float a = __ldg(w2 + slot);
      float xv[VEC2];
      load_row<VEC2>(x2, x2_bf16, v * D2 + f2, xv);
#pragma unroll
      for (int i = 0; i < VEC2; ++i) acc2[i] = fmaf(a, xv[i], acc2[i]);
    }
  }
  if (has1) store_row<VEC1>(out1, flags1 & kOutBf16, s * D1 + f1, acc1);
  if (has2) store_row<VEC2>(out2, flags2 & kOutBf16, s * D2 + f2, acc2);
}

cudaError_t grid_for(long long lanes, int Vs, dim3* grid, int* threads) {
  *threads = bsp::block_threads(lanes);
  const long long chunks = (lanes + *threads - 1) / *threads;
  if (chunks > 65535) return cudaErrorInvalidConfiguration;
  *grid = dim3(static_cast<unsigned>(Vs), static_cast<unsigned>(chunks));
  return cudaSuccess;
}

template <typename TX, typename TO, int VEC>
cudaError_t launch(const float* w, const void* x, const int32_t* offsets,
                   const int32_t* slots, void* out, int Vs, int deg,
                   long long D, cudaStream_t stream) {
  dim3 grid;
  int threads;
  const cudaError_t err = grid_for((D + VEC - 1) / VEC, Vs, &grid, &threads);
  if (err != cudaSuccess) return err;
  spmm_t_kernel<TX, TO, VEC><<<grid, threads, 0, stream>>>(
      w, static_cast<const TX*>(x), offsets, slots, static_cast<TO*>(out),
      deg, D);
  return cudaGetLastError();
}

template <typename TX, typename TO>
cudaError_t launch_vec(int vec8, const float* w, const void* x,
                       const int32_t* offsets, const int32_t* slots,
                       void* out, int Vs, int deg, long long D,
                       cudaStream_t stream) {
  if (vec8) return launch<TX, TO, 8>(w, x, offsets, slots, out, Vs, deg, D, stream);
  return launch<TX, TO, 1>(w, x, offsets, slots, out, Vs, deg, D, stream);
}

cudaError_t launch_single(const float* w, const void* x, void* out,
                          long long D, int flags, const int32_t* offsets,
                          const int32_t* slots, int Vs, int deg,
                          cudaStream_t s) {
  const int vec8 = flags & kVec8;
  const bool xb = flags & kXBf16;
  const bool ob = flags & kOutBf16;
  if (xb && ob)
    return launch_vec<__nv_bfloat16, __nv_bfloat16>(vec8, w, x, offsets, slots, out, Vs, deg, D, s);
  if (xb)
    return launch_vec<__nv_bfloat16, float>(vec8, w, x, offsets, slots, out, Vs, deg, D, s);
  if (ob)
    return launch_vec<float, __nv_bfloat16>(vec8, w, x, offsets, slots, out, Vs, deg, D, s);
  return launch_vec<float, float>(vec8, w, x, offsets, slots, out, Vs, deg, D, s);
}

template <int VEC1, int VEC2>
cudaError_t launch_dual(const float* w1, const void* x1, void* out1,
                        long long D1, int flags1, const float* w2,
                        const void* x2, void* out2, long long D2, int flags2,
                        const int32_t* offsets, const int32_t* slots, int Vs,
                        int deg, cudaStream_t stream) {
  const long long lanes1 = (D1 + VEC1 - 1) / VEC1;
  const long long lanes2 = (D2 + VEC2 - 1) / VEC2;
  dim3 grid;
  int threads;
  const cudaError_t err =
      grid_for(lanes1 > lanes2 ? lanes1 : lanes2, Vs, &grid, &threads);
  if (err != cudaSuccess) return err;
  spmm_t2_kernel<VEC1, VEC2><<<grid, threads, 0, stream>>>(
      w1, x1, out1, D1, flags1, w2, x2, out2, D2, flags2, offsets, slots,
      deg);
  return cudaGetLastError();
}

// --- the staged form --------------------------------------------------------

constexpr int kStThreads = 512;                    // 16 warps a block
constexpr int kStWarps = kStThreads / 32;
constexpr int kStSources = bsp::kTile;             // a block's source tile
constexpr int kStPerWarp = kStSources / kStWarps;  // sources a warp sums
constexpr int kStRows = bsp::kTile;                // destination rows a window
constexpr int kStF = 128;                          // features a chunk
constexpr int kStChunks = 2;                       // chunks a block
constexpr int kStLaneF = kStF / 32;                // features a lane
constexpr int kStProbe = 128;                      // slots a warp probes at once
constexpr int kStFlagBatch = 4;                    // loads in flight a thread
// The ints ahead of the buffers: the per-warp counts [kStWarps][kStSources]
// (then the warp's first list position of each source) and the source
// offsets [kStSources + 1]; then a flag per window (whether a slot of it
// names the tile), a multiple of 4.
constexpr int kStHeaderInts =
    (kStWarps * kStSources + kStSources + 1 + 3) / 4 * 4;

struct StagedPair {
  const float* w;  // [V, deg]
  const void* x;   // [V, D]
  void* out;       // [Vs, D]
  long long D;
  int flags;       // kXBf16 | kOutBf16 | kVec8
};

__host__ __device__ __forceinline__ int staged_windows(int V) {
  return (V + kStRows - 1) / kStRows;
}

// Bytes ahead of the slot list.
__host__ __device__ __forceinline__ int staged_header_bytes(int V) {
  return (kStHeaderInts + (staged_windows(V) + 3) / 4 * 4) * 4;
}

// Bytes of dynamic shared memory of a block: the header, the window's slot
// list (a weight and a window row: 5 bytes a slot, kStRows * deg slots, a
// multiple of 16 bytes), the window's weights (4 bytes a slot) and two
// buffers of the window's rows.
long long staged_smem_bytes(int V, int deg, int x_bytes) {
  return staged_header_bytes(V) + 9LL * kStRows * deg +
         2LL * kStRows * kStF * x_bytes;
}

// An 8-byte cp.async (4 bf16 features); !full copies nothing and fills the
// 8 bytes with zeros.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(gmem), "r"(full ? 8 : 0));
}

// A 4-byte cp.async (one f32).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Slots k..k+3 of ell_src and ell_mask (k a multiple of 4; slots at or past
// `total` read as masked): one load of each array where all 4 exist.
__device__ __forceinline__ void load4(const int32_t* __restrict__ ell_src,
                                      const uint8_t* __restrict__ ell_mask,
                                      int k, int total, int* sv,
                                      uint32_t* mv) {
  if (k + 4 <= total) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(ell_src + k));
    sv[0] = v.x; sv[1] = v.y; sv[2] = v.z; sv[3] = v.w;
    *mv = __ldg(reinterpret_cast<const unsigned*>(ell_mask + k));
  } else {
    *mv = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool in = k + u < total;
      sv[u] = in ? ell_src[k + u] : 0;
      *mv |= (in ? static_cast<uint32_t>(ell_mask[k + u]) : 0u) << (8 * u);
    }
  }
}

// Whether one of 4 loaded slots is valid and names a source of the tile.
__device__ __forceinline__ bool any_in_tile(const int* sv, uint32_t mv,
                                            int s0) {
  bool any = false;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    any |= ((mv >> (8 * u)) & 0xffu) != 0 &&
           static_cast<unsigned>(sv[u] - s0) < static_cast<unsigned>(kStSources);
  return any;
}

// Flags in hit[] each window of kStRows destination rows that holds a valid
// slot naming a source of the tile (a plain store of 1: every writer stores
// the same value). Each thread reads 4 slots of each array with one load,
// kStFlagBatch of them in flight. total = V * deg < 2^31 (bsp.py checks).
__device__ __forceinline__ void flag_windows(
    const int32_t* __restrict__ ell_src, const uint8_t* __restrict__ ell_mask,
    int total, int deg, int s0, int* hit) {
  const int per = kStRows * deg;  // slots a window, a multiple of 4
  const int step = 4 * kStThreads;
  for (int k0 = 4 * threadIdx.x; k0 < total; k0 += kStFlagBatch * step) {
    int sv[kStFlagBatch][4];
    uint32_t mv[kStFlagBatch];
#pragma unroll
    for (int r = 0; r < kStFlagBatch; ++r)
      load4(ell_src, ell_mask, k0 + r * step, total, sv[r], &mv[r]);
    // the 4 slots share one window: k is a multiple of 4, and so is per
#pragma unroll
    for (int r = 0; r < kStFlagBatch; ++r)
      if (any_in_tile(sv[r], mv[r], s0)) hit[(k0 + r * step) / per] = 1;
  }
}

// The first flagged window from wi, or `windows`.
__device__ __forceinline__ int next_window(const int* hit, int wi,
                                           int windows) {
  while (wi < windows && !hit[wi]) ++wi;
  return wi;
}

// The key of slot k: its source's index in the block's tile where the slot
// is valid and names one, else kStSources. The mask and the source are
// read together (a slot at or past `end` reads slot end - 1 and is no
// key), so that the loads of several slots are in flight at once.
__device__ __forceinline__ int slot_key(const int32_t* __restrict__ ell_src,
                                        const uint8_t* __restrict__ ell_mask,
                                        int k, int end, int s0) {
  const int at = min(k, end - 1);
  const bool valid = __ldg(ell_mask + at) != 0;
  const unsigned s = static_cast<unsigned>(__ldg(ell_src + at) - s0);
  return k < end && valid && s < static_cast<unsigned>(kStSources)
             ? static_cast<int>(s) : kStSources;
}

// The lanes of the warp whose key (0..kStSources) equals this lane's: one
// ballot per bit of the key.
__device__ __forceinline__ unsigned same_key_lanes(int key) {
  unsigned peers = 0xffffffffu;
#pragma unroll
  for (int bit = 1; bit <= kStSources; bit <<= 1) {
    const unsigned set = __ballot_sync(0xffffffffu, key & bit);
    peers &= (key & bit) ? set : ~set;
  }
  return peers;
}

// VEC staged elements of TX as f32.
template <typename TX, int VEC>
__device__ __forceinline__ void load_staged(const TX* p, float* x);

template <>
__device__ __forceinline__ void load_staged<float, 4>(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

template <>
__device__ __forceinline__ void load_staged<__nv_bfloat16, 4>(
    const __nv_bfloat16* p, float* x) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <>
__device__ __forceinline__ void load_staged<float, 1>(const float* p, float* x) {
  x[0] = *p;
}

template <>
__device__ __forceinline__ void load_staged<__nv_bfloat16, 1>(
    const __nv_bfloat16* p, float* x) {
  x[0] = __bfloat162float(*p);
}

// The shared memory of a block (staged_smem_bytes): the header's arrays,
// the window's slot list, its weights and two buffers of its rows.
struct StagedShared {
  int* cnt;
  int* off;
  int* hit;
  float* lw;
  uint8_t* lr;
  float* ww;
  unsigned char* rows;
};

__device__ __forceinline__ StagedShared staged_shared(unsigned char* smem,
                                                      int V, int deg) {
  StagedShared sh;
  sh.cnt = reinterpret_cast<int*>(smem);
  sh.off = sh.cnt + kStWarps * kStSources;
  sh.hit = sh.cnt + kStHeaderInts;
  sh.lw = reinterpret_cast<float*>(smem + staged_header_bytes(V));
  sh.lr = reinterpret_cast<uint8_t*>(sh.lw + kStRows * deg);
  sh.ww = reinterpret_cast<float*>(sh.lr + kStRows * deg);
  sh.rows = reinterpret_cast<unsigned char*>(sh.ww + kStRows * deg);
  return sh;
}

// Starts the copy of window wi's weights (its kStRows * deg slots) into
// sh.ww: one cp.async group.
__device__ __forceinline__ void stage_weights(const StagedShared& sh,
                                              const float* __restrict__ w,
                                              int wi, int V, int deg) {
  const int slot0 = wi * kStRows * deg;
  const int n = min(kStRows, V - wi * kStRows) * deg;
  for (int i = threadIdx.x; i < n; i += kStThreads)
    cp_async4(sh.ww + i, w + slot0 + i);
  cp_async_commit();
}

// Starts the copy of features [f0, f0 + kStF) of window wi's rows into
// `rows` (one cp.async group; rows that are not 16-byte aligned go through
// registers and are stored on return).
template <typename TX, int VEC>
__device__ __forceinline__ void stage_rows(TX* rows, const TX* __restrict__ x,
                                           long long D, int wi, int V,
                                           long long f0) {
  const long long v0 = static_cast<long long>(wi) * kStRows;
  const int nv = min(kStRows, V - wi * kStRows);
  if constexpr (VEC > 1) {
    for (int i = threadIdx.x; i < nv * 32; i += kStThreads) {
      const int f = (i & 31) * VEC;
      const bool in = f0 + f < D;
      const TX* from = in ? x + (v0 + (i >> 5)) * D + f0 + f : x;
      if constexpr (sizeof(TX) == 4) cp_async16(rows + i * VEC, from, in);
      else cp_async8(rows + i * VEC, from, in);
    }
    cp_async_commit();
  } else {
    for (int i = threadIdx.x; i < nv * kStF; i += kStThreads) {
      const long long f = f0 + i % kStF;
      if (f < D) rows[i] = x[(v0 + i / kStF) * D + f];
    }
  }
}

// The slots of window wi (destination rows [64 wi, 64 wi + 64)) that name a
// source of the tile: per-warp counts by source (integer atomics: the same
// counts in any order), then (warp 0) each source's list offset and each
// warp's first position in it. Each warp takes a contiguous segment of the
// window's slots; a probe of kStProbe slots, 4 a lane, skips those with
// none (the index is in L1 since the flag pass). Ends with a barrier.
__device__ __forceinline__ void list_count(
    const StagedShared& sh, const int32_t* __restrict__ ell_src,
    const uint8_t* __restrict__ ell_mask, int wi, int V, int deg, int s0) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slot0 = wi * kStRows * deg;
  const int n = min(kStRows, V - wi * kStRows) * deg;
  for (int i = tid; i < kStWarps * kStSources; i += kStThreads) sh.cnt[i] = 0;
  __syncthreads();
  int* mine = sh.cnt + warp * kStSources;
  const int seg = (n + kStWarps * kStProbe - 1) / (kStWarps * kStProbe) * kStProbe;
  const int ke = min(n, warp * seg + seg);
  for (int c0 = warp * seg; c0 < ke; c0 += kStProbe) {
    int sv[4];
    uint32_t mv;
    const int k4 = c0 + 4 * lane;
    load4(ell_src, ell_mask, slot0 + k4, slot0 + ke, sv, &mv);
    if (!__ballot_sync(0xffffffffu, k4 < ke && any_in_tile(sv, mv, s0)))
      continue;
#pragma unroll
    for (int q = 0; q < kStProbe / 32; ++q) {
      const int key = slot_key(ell_src, ell_mask, slot0 + c0 + 32 * q + lane,
                               slot0 + ke, s0);
      if (key < kStSources) atomicAdd(mine + key, 1);
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int a = 2 * lane;
    int t0 = 0, t1 = 0;
#pragma unroll
    for (int w = 0; w < kStWarps; ++w) {
      int* c = sh.cnt + w * kStSources + a;
      const int n0 = c[0], n1 = c[1];
      c[0] = t0;
      c[1] = t1;
      t0 += n0;
      t1 += n1;
    }
    int inc = t0 + t1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += y;
    }
    const int ex = inc - t0 - t1;
    sh.off[a] = ex;
    sh.off[a + 1] = ex + t0;
    if (lane == 31) sh.off[kStSources] = inc;
#pragma unroll
    for (int w = 0; w < kStWarps; ++w) {
      int* c = sh.cnt + w * kStSources + a;
      c[0] += ex;
      c[1] += ex + t0;
    }
  }
  __syncthreads();
}

// Each warp places its segment's slots of window wi in the list (the
// weight and the slot's row in the window): source-major, and within a
// source in slot order, (v, j) (a stable counting sort: lanes of one source
// ranked by ballots, the group's leader advancing the warp's position).
// The keys of a probe's slots are loaded before the ranks are taken.
// `pending`: the cp.async groups newer than stage_weights' that may stay
// in flight. Starts with a barrier once the weights have landed; ends with
// none.
template <int kPending>
__device__ __forceinline__ void list_place(
    const StagedShared& sh, const int32_t* __restrict__ ell_src,
    const uint8_t* __restrict__ ell_mask, int wi, int V, int deg, int s0,
    unsigned row_magic) {
  cp_async_wait<kPending>();
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int slot0 = wi * kStRows * deg;
  const int n = min(kStRows, V - wi * kStRows) * deg;
  int* mine = sh.cnt + warp * kStSources;
  const int seg = (n + kStWarps * kStProbe - 1) / (kStWarps * kStProbe) * kStProbe;
  const int ke = min(n, warp * seg + seg);
  for (int c0 = warp * seg; c0 < ke; c0 += kStProbe) {
    int sv[4];
    uint32_t mv;
    const int k4 = c0 + 4 * lane;
    load4(ell_src, ell_mask, slot0 + k4, slot0 + ke, sv, &mv);
    if (!__ballot_sync(0xffffffffu, k4 < ke && any_in_tile(sv, mv, s0)))
      continue;
    constexpr int kQ = kStProbe / 32;
    int key[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q)
      key[q] = slot_key(ell_src, ell_mask, slot0 + c0 + 32 * q + lane,
                        slot0 + ke, s0);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int k = c0 + 32 * q + lane;
      const unsigned peers = same_key_lanes(key[q]);
      if (key[q] < kStSources) {
        const int at = mine[key[q]] + __popc(peers & below);
        sh.lw[at] = sh.ww[k];
        sh.lr[at] = static_cast<uint8_t>(__umulhi(k, row_magic));  // k / deg
      }
      __syncwarp();
      if (key[q] < kStSources && (peers & below) == 0)
        mine[key[q]] += __popc(peers);
      __syncwarp();
    }
  }
}

// Each warp runs its sources' chains over the list and the staged rows,
// the sources' steps interleaved.
template <typename TX, int VEC, int NV>
__device__ __forceinline__ void sum_chains(const StagedShared& sh,
                                           const TX* rows,
                                           float (&acc)[kStPerWarp][kStLaneF]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int beg[kStPerWarp], len[kStPerWarp];
  int most = 0;
#pragma unroll
  for (int i = 0; i < kStPerWarp; ++i) {
    const int ls = warp * kStPerWarp + i;
    beg[i] = sh.off[ls];
    len[i] = sh.off[ls + 1] - beg[i];
    most = max(most, len[i]);
  }
  for (int t = 0; t < most; ++t) {
#pragma unroll
    for (int i = 0; i < kStPerWarp; ++i) {
      if (t < len[i]) {
        const int q = beg[i] + t;
        const float a = sh.lw[q];
        const TX* row = rows + sh.lr[q] * kStF + lane * VEC;
#pragma unroll
        for (int h = 0; h < NV; ++h) {
          float xv[VEC];
          load_staged<TX, VEC>(row + h * 32 * VEC, xv);
#pragma unroll
          for (int u = 0; u < VEC; ++u)
            acc[i][h * VEC + u] = fmaf(a, xv[u], acc[i][h * VEC + u]);
        }
      }
    }
  }
}

// One block's outputs: sources [s0, s0 + kStSources) x the features of
// chunks [c_begin, c_end) of kStF of pair p. A lane sums NV groups of VEC
// features (8 or 16 bytes of x a group, or one element) for each of its
// warp's kStPerWarp sources. Where one window holds all the block's slots
// (the swarm's graphs), its weights and both chunks' rows are copied as
// soon as the flag pass has found it, while its list is built once;
// otherwise each chunk walks the flagged windows in order, a list and a
// copy each.
template <typename TX, int VEC, int NV>
__device__ __forceinline__ void staged_sums(
    const StagedPair& p, long long c_begin, long long c_end,
    const int32_t* __restrict__ ell_src, const uint8_t* __restrict__ ell_mask,
    int V, int Vs, int deg, unsigned char* smem) {
  static_assert(VEC * NV == kStLaneF, "a lane sums kStLaneF features");
  static_assert(kStChunks == 2, "the one-window path holds two chunks");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s0 = blockIdx.y * kStSources;
  const int windows = staged_windows(V);
  const unsigned row_magic = 0xffffffffu / deg + 1;  // k / deg = umulhi(k, .)
  const StagedShared sh = staged_shared(smem, V, deg);
  TX* rows = reinterpret_cast<TX*>(sh.rows);  // two buffers of kStRows x kStF
  TX* rows2 = rows + kStRows * kStF;
  const TX* __restrict__ x = static_cast<const TX*>(p.x);
  const bool out_bf16 = p.flags & kOutBf16;
  constexpr int kGroup = VEC > 1 ? 1 : 0;  // cp.async groups a rows copy makes
  float acc[kStPerWarp][kStLaneF];
  auto zero = [&]() {
#pragma unroll
    for (int i = 0; i < kStPerWarp; ++i)
#pragma unroll
      for (int u = 0; u < kStLaneF; ++u) acc[i][u] = 0.f;
  };
  auto store = [&](long long chunk) {
#pragma unroll
    for (int i = 0; i < kStPerWarp; ++i) {
      const long long s = s0 + warp * kStPerWarp + i;
#pragma unroll
      for (int h = 0; h < NV; ++h) {
        const long long f = chunk * kStF + h * 32 * VEC + lane * VEC;
        if (s < Vs && f < p.D)
          store_row<VEC>(p.out, out_bf16, s * p.D + f, &acc[i][h * VEC]);
      }
    }
  };
  for (int i = tid; i < windows; i += kStThreads) sh.hit[i] = 0;
  __syncthreads();
  flag_windows(ell_src, ell_mask, V * deg, deg, s0, sh.hit);
  __syncthreads();
  const int first = next_window(sh.hit, 0, windows);
  if (first < windows && next_window(sh.hit, first + 1, windows) == windows) {
    const bool two = c_begin + 1 < c_end;
    stage_weights(sh, p.w, first, V, deg);
    stage_rows<TX, VEC>(rows, x, p.D, first, V, c_begin * kStF);
    if (two) stage_rows<TX, VEC>(rows2, x, p.D, first, V, (c_begin + 1) * kStF);
    list_count(sh, ell_src, ell_mask, first, V, deg, s0);
    if (two) list_place<2 * kGroup>(sh, ell_src, ell_mask, first, V, deg, s0, row_magic);
    else list_place<kGroup>(sh, ell_src, ell_mask, first, V, deg, s0, row_magic);
    if (two) cp_async_wait<kGroup>();
    else cp_async_wait<0>();
    __syncthreads();
    zero();
    sum_chains<TX, VEC, NV>(sh, rows, acc);
    store(c_begin);
    if (!two) return;
    cp_async_wait<0>();
    __syncthreads();
    zero();
    sum_chains<TX, VEC, NV>(sh, rows2, acc);
    store(c_begin + 1);
    return;
  }
  for (long long c = c_begin; c < c_end; ++c) {
    zero();
    for (int wi = first; wi < windows; wi = next_window(sh.hit, wi + 1, windows)) {
      stage_weights(sh, p.w, wi, V, deg);
      stage_rows<TX, VEC>(rows, x, p.D, wi, V, c * kStF);
      list_count(sh, ell_src, ell_mask, wi, V, deg, s0);
      list_place<kGroup>(sh, ell_src, ell_mask, wi, V, deg, s0, row_magic);
      cp_async_wait<0>();
      __syncthreads();
      sum_chains<TX, VEC, NV>(sh, rows, acc);
      __syncthreads();  // the list, weights and rows are free for the next
    }
    store(c);
  }
}

// grid (c1 + c2 blocks of kStChunks feature chunks of kStF, of both
// outputs; source tiles), block kStThreads, staged_smem_bytes(V, deg, ...)
// of dynamic shared memory: the blocks before c1 sum pair p1, the others
// p2. One block an SM (two spilled at 64 registers; the swarm's dual launch
// is one wave of 132 blocks).
__global__ void __launch_bounds__(kStThreads, 1)
spmm_t_staged_kernel(StagedPair p1, StagedPair p2, int c1,
                     const int32_t* __restrict__ ell_src,
                     const uint8_t* __restrict__ ell_mask, int V, int Vs,
                     int deg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool first = static_cast<int>(blockIdx.x) < c1;
  const StagedPair p = first ? p1 : p2;
  const long long c_begin = (first ? blockIdx.x : blockIdx.x - c1) * static_cast<long long>(kStChunks);
  const long long c_end = min(c_begin + kStChunks, (p.D + kStF - 1) / kStF);
  const bool vec = p.flags & kVec8;
  if (p.flags & kXBf16) {
    if (vec) staged_sums<__nv_bfloat16, 4, 1>(p, c_begin, c_end, ell_src, ell_mask, V, Vs, deg, smem);
    else staged_sums<__nv_bfloat16, 1, 4>(p, c_begin, c_end, ell_src, ell_mask, V, Vs, deg, smem);
  } else {
    if (vec) staged_sums<float, 4, 1>(p, c_begin, c_end, ell_src, ell_mask, V, Vs, deg, smem);
    else staged_sums<float, 1, 4>(p, c_begin, c_end, ell_src, ell_mask, V, Vs, deg, smem);
  }
}

cudaError_t launch_staged(StagedPair p1, StagedPair p2,
                          const int32_t* ell_src, const uint8_t* ell_mask,
                          int V, int Vs, int deg, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(ell_src) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ell_mask) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const long long c1 = ((p1.D + kStF - 1) / kStF + kStChunks - 1) / kStChunks;
  const long long c2 = ((p2.D + kStF - 1) / kStF + kStChunks - 1) / kStChunks;
  const long long nts = (Vs + kStSources - 1) / kStSources;
  if (nts > 65535 || c1 + c2 > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int x_bytes = ((p1.flags & kXBf16) && (p2.D == 0 || (p2.flags & kXBf16)))
                          ? 2 : 4;
  const long long smem = staged_smem_bytes(V, deg, x_bytes);
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > limit) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(spmm_t_staged_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  spmm_t_staged_kernel<<<dim3(static_cast<unsigned>(c1 + c2),
                              static_cast<unsigned>(nts)),
                         kStThreads, static_cast<size_t>(smem), stream>>>(
      p1, p2, static_cast<int>(c1), ell_src, ell_mask, V, Vs, deg);
  return cudaGetLastError();
}

// --- the tiled form ---------------------------------------------------------

constexpr int kT = bsp::kTile;  // nodes per tile
using Pair = bsp::TiledPair;

// grid V, block a multiple of 32: row v of W1 (and W2), and the flags of
// the tile pairs its valid slots join. The row of W1 first counts the slots
// naming each source (integer atomics: the same counts every launch); a row
// in which no source is named twice then writes each slot's weight, and a
// row with a duplicate sums each source's weights in slot order, by the
// thread of its first slot.
__global__ void __launch_bounds__(bsp::kMaxThreads)
densify_kernel(const float* __restrict__ w1, const float* __restrict__ w2,
               const int32_t* __restrict__ ell_src,
               const uint8_t* __restrict__ ell_mask, float* __restrict__ W1,
               float* __restrict__ W2, uint8_t* __restrict__ flags, int deg,
               int VsP, int nts) {
  const long long v = blockIdx.x;
  float* r1 = W1 + v * VsP;
  float* r2 = W2 != nullptr ? W2 + v * VsP : nullptr;
  int* count = reinterpret_cast<int*>(r1);  // 0.f and 0 have the same bits
  for (int i = threadIdx.x; i < VsP; i += blockDim.x) {
    r1[i] = 0.f;
    if (r2 != nullptr) r2[i] = 0.f;
  }
  __syncthreads();
  const int32_t* src = ell_src + v * deg;
  const uint8_t* mask = ell_mask + v * deg;
  for (int j = threadIdx.x; j < deg; j += blockDim.x)
    if (mask[j]) atomicAdd(count + src[j], 1);
  __syncthreads();
  bool dup = false;
  for (int j = threadIdx.x; j < deg; j += blockDim.x)
    if (mask[j]) dup |= __ldcg(count + src[j]) > 1;
  dup = __syncthreads_or(dup);  // every count is read before any is replaced
  for (int j = threadIdx.x; j < deg; j += blockDim.x) {
    if (!mask[j]) continue;
    const int32_t s = src[j];
    float t1 = w1[v * deg + j];
    float t2 = w2 != nullptr ? w2[v * deg + j] : 0.f;
    if (dup) {
      bool first = true;
      for (int i = 0; i < j && first; ++i) first = !(mask[i] && src[i] == s);
      if (!first) continue;  // the thread of the first such slot sums them
      for (int i = j + 1; i < deg; ++i) {
        if (mask[i] && src[i] == s) {
          t1 += w1[v * deg + i];
          if (w2 != nullptr) t2 += w2[v * deg + i];
        }
      }
    }
    r1[s] = t1;
    if (r2 != nullptr) r2[s] = t2;
    flags[(v / kT) * nts + s / kT] = 1;
  }
}

// grid (c1 + c2 feature chunks of both outputs, nts source tiles), block
// bsp::kTileThreads, bsp::kTileSmemBytes of dynamic shared memory: W[v, s]
// from densify_kernel, x[v] and out[s] of each pair (bsp_tiled.cuh). Two
// blocks per SM.
__global__ void __launch_bounds__(bsp::kTileThreads, 2)
spmm_t_tiled_kernel(Pair p1, Pair p2, int c1,
                    const uint8_t* __restrict__ flags, int V, int Vs, int nt,
                    int nts) {
  bsp::tiled_product(p1, p2, c1, flags, V, Vs, nt, nts);
}

long long tiled_scratch(int V, int Vs, int dual) {
  const long long nt = (V + kT - 1) / kT;
  const long long nts = (Vs + kT - 1) / kT;
  return (dual ? 2 : 1) * (nt * kT) * (nts * kT) * 4 + nt * nts;
}

cudaError_t launch_tiled(Pair p1, Pair p2, const int32_t* ell_src,
                         const uint8_t* ell_mask, int V, int Vs, int deg,
                         void* scratch, cudaStream_t stream) {
  const int nt = (V + kT - 1) / kT;
  const int nts = (Vs + kT - 1) / kT;
  const long long c1 = bsp::tiled_chunks(p1.D);
  const long long c2 = bsp::tiled_chunks(p2.D);
  if (nts > 65535 || c1 + c2 > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const long long dense = static_cast<long long>(nt) * kT * nts * kT;
  p1.W = static_cast<float*>(scratch);
  p2.W = c2 > 0 ? p1.W + dense : nullptr;
  uint8_t* flags = reinterpret_cast<uint8_t*>(p1.W + (c2 > 0 ? 2 : 1) * dense);
  cudaError_t err = cudaMemsetAsync(flags, 0, static_cast<size_t>(nt) * nts, stream);
  if (err != cudaSuccess) return err;
  densify_kernel<<<static_cast<unsigned>(V), bsp::block_threads(deg), 0, stream>>>(
      p1.w, c2 > 0 ? p2.w : nullptr, ell_src, ell_mask, p1.W, p2.W, flags,
      deg, nts * kT, nts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(spmm_t_tiled_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bsp::kTileSmemBytes);
  if (err != cudaSuccess) return err;
  spmm_t_tiled_kernel<<<dim3(static_cast<unsigned>(c1 + c2), nts),
                        bsp::kTileThreads, bsp::kTileSmemBytes, stream>>>(
      p1, p2, static_cast<int>(c1), flags, V, Vs, nt, nts);
  return cudaGetLastError();
}

}  // namespace

// Bytes of scratch the tiled form needs (the caller allocates them).
extern "C" long long bsp_spmm_t_scratch(int V, int Vs, int dual) {
  return tiled_scratch(V, Vs, dual);
}

// flags1 / flags2: bit 0 x is bf16, bit 1 out is bf16, bit 2 16-byte loads
// (D a multiple of 8, x and out 16-byte aligned). D2 == 0 (w2, x2, out2
// unused) is the single form. V and deg: the ELL shape; Vs: the output rows.
// form (bsp.py::SPMM_T_FORMS) 0: the per-edge form over the source view
// (offsets, slots); 1: the tiled form (offsets and slots unused), with
// bsp_spmm_t_scratch(...) bytes of scratch; 2: the staged form (offsets,
// slots and scratch unused; ell_src, ell_mask, w1 and w2 16-byte aligned).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int bsp_spmm_t(const float* w1, const void* x1, void* out1,
                          long long D1, int flags1, const float* w2,
                          const void* x2, void* out2, long long D2,
                          int flags2, const int32_t* offsets,
                          const int32_t* slots, const int32_t* ell_src,
                          const uint8_t* ell_mask, int V, int Vs, int deg,
                          int form, void* scratch, int device, void* stream) {
  if (V <= 0 || Vs <= 0 || D1 <= 0 || D2 < 0 || deg <= 0 || form < 0 || form > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 1) {
    return static_cast<int>(launch_tiled(
        Pair{w1, x1, out1, D1, flags1, nullptr},
        Pair{w2, x2, out2, D2, flags2, nullptr}, ell_src, ell_mask, V, Vs,
        deg, scratch, s));
  }
  if (form == 2) {
    return static_cast<int>(launch_staged(
        StagedPair{w1, x1, out1, D1, flags1},
        StagedPair{w2, x2, out2, D2, flags2}, ell_src, ell_mask, V, Vs, deg,
        s));
  }
  if (D2 == 0) {
    err = launch_single(w1, x1, out1, D1, flags1, offsets, slots, Vs, deg, s);
  } else {
    const bool v1 = flags1 & kVec8;
    const bool v2 = flags2 & kVec8;
    if (v1 && v2)
      err = launch_dual<8, 8>(w1, x1, out1, D1, flags1, w2, x2, out2, D2, flags2, offsets, slots, Vs, deg, s);
    else if (v1)
      err = launch_dual<8, 1>(w1, x1, out1, D1, flags1, w2, x2, out2, D2, flags2, offsets, slots, Vs, deg, s);
    else if (v2)
      err = launch_dual<1, 8>(w1, x1, out1, D1, flags1, w2, x2, out2, D2, flags2, offsets, slots, Vs, deg, s);
    else
      err = launch_dual<1, 1>(w1, x1, out1, D1, flags1, w2, x2, out2, D2, flags2, offsets, slots, Vs, deg, s);
  }
  return static_cast<int>(err);
}
