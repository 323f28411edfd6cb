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
// Two forms, deterministic (no float atomics: two launches give the same
// bits, and the dual form gives the bits of two single ones, since each
// output of a form is one fixed chain of f32 FMAs that does not depend on
// the other pair). Which runs is a rule on the ELL shape, applied by the
// caller (bsp.py::tiled_form, the same rule as bsp_sddmm.cu's), so the
// single and the dual form always take the same one. PERF.md section 6
// gives the crossover measured on the card.
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
// tiled 0: the per-edge form over the source view (offsets, slots); 1: the
// tiled form (offsets and slots unused), with bsp_spmm_t_scratch(...) bytes
// of scratch. Returns the CUDA error code of the launch (0 on success).
extern "C" int bsp_spmm_t(const float* w1, const void* x1, void* out1,
                          long long D1, int flags1, const float* w2,
                          const void* x2, void* out2, long long D2,
                          int flags2, const int32_t* offsets,
                          const int32_t* slots, const int32_t* ell_src,
                          const uint8_t* ell_mask, int V, int Vs, int deg,
                          int tiled, void* scratch, int device, void* stream) {
  if (V <= 0 || Vs <= 0 || D1 <= 0 || D2 < 0 || deg <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiled) {
    return static_cast<int>(launch_tiled(
        Pair{w1, x1, out1, D1, flags1, nullptr},
        Pair{w2, x2, out2, D2, flags2, nullptr}, ell_src, ell_mask, V, Vs,
        deg, scratch, s));
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
