// Edge dot products over an ELL neighbour list, one pair of operands or
// two, for Hopper (sm_90a), with a plain C interface loaded through ctypes
// (mrp_gnn_tpu_torch/ops/bsp.py::sddmm).
//
//   out1[v, j] = <a1[v], b1[ell_src[v, j]]>
//   out2[v, j] = <a2[v], b2[ell_src[v, j]]>   (dual form only)
//
// summed in f32 over the feature axis; a masked slot gives 0. Each operand
// is f32 or bf16 on its own, so a pair may mix them (an f32 cotangent
// against bf16 values). The ELL width deg may be any size.
//
// Replaces: mrp_gnn_tpu/ops/pallas_bsp.py::_sddmm_kernel (launched by
// _sddmm_forward) and ::_sddmm2_kernel (launched by _sddmm2_forward, the
// dual form), and in the single form mrp_gnn_tpu/ops/pallas_ell.py::
// _sddmm_kernel (launched by _sddmm_forward there; wrapper
// ops/ell.py::sddmm, which counts its launches apart). The BSP kernels take
// one [Tv, D] x [D, Ts] MXU product per (dst tile, src tile) pair of the
// plan, then pick each slot's column with one-hot selections; the ELL
// kernel DMAs each slot's key row and unrolls over the width. The training step launches this kernel once, in the
// dual form: (q_s, k) recomputes the attention logits and (g, values)
// gives dalpha. At the full dynamic_swarm width the JAX package runs that
// as three _sddmm_kernel sweeps (its VMEM gate refuses the dual kernel and
// D 8192 is split in two); at narrow widths as one _sddmm2_kernel sweep.
//
// Two forms, one result (the sums of each form are fixed, so every launch
// gives the same bits, and the dual form gives the bits of two single
// ones). Which runs is a rule on the ELL shape, applied by the caller
// (bsp.py::tiled_form, the same rule as bsp_spmm_t.cu's): the tiled form
// when the ELL width is at least bsp.py::TILED_MIN_DEG and the node counts
// allow its scratch, the per-edge form otherwise. PERF.md section 6 gives
// the crossover measured on the card.
//
// Per-edge form. Bound: bytes. The function reads a1, b1, a2, b2, ell_src
// and ell_mask once and writes the outputs once: at the training shape (V
// 256, deg 32, d1 64, d2 8192, f32) 17 MB, about 5 us at 3.35 TB/s,
// against 2 x edges x (d1 + d2) FMAs (28 MFLOP); the single form at the
// ell path's logits (d 64) 0.2 MB, 0.06 us, below any launch's time, so
// there the time is the launch and the chain of dependent reads (slots,
// then b rows). The b rows are gathered once per in-edge, mostly from the
// 50 MB L2. Every dot of a pair is one chain in one order (lane_dot and
// group_sum), which depends on the pair's d and flags alone. A narrow pair
// (d <= 256 with 16-byte loads): a warp per row splits into groups of d / 8
// lanes, one valid slot each, and reads the row's slots 32 at a time (mask
// and source together, a ballot of the valid ones); kBatch passes of the
// groups have their loads in flight together and each group reduces with
// an xor tree over its lanes. sddmm_rows_kernel takes kRowWarps rows a
// block when every pair is narrow, with no barrier and no shared memory
// (1, 2, 4 and 8 rows a block took the same time on the card, PERF.md
// section 6).
// A wide pair (the dual form's d2 8192): sddmm_wide_kernel, a block per
// row whose 256 threads share each dot (one round trip of 16-byte loads
// per thread at d 8192), two valid slots' loads in flight at a time, with
// one barrier per 32 slots; a narrow pair of the same launch runs on the
// block's last warp as above. Any ELL width works, 32 slots at a time.
//
// Tiled form. Bound: operations at a wide ELL. At the high-degree backward's
// node view (V 512, deg 192, 74,112 edges, d1 64, d2 8192) the function is
// 1.22 GFLOP (0.018 ms at 67 TFLOP/s f32) against 52 MB (0.016 ms); the
// per-edge form reads a b row and the same a row again for every slot, 4.9
// GB through L1/L2 at 0.25 FLOP per byte. Here the node axes are cut into
// tiles of kTile = 64 and each (destination tile, source tile) pair that
// holds a valid slot is computed as a dense 64 x 64 block of dots, then each
// valid slot picks its entry from the block: on a nearly block-dense graph
// that is a small multiple of the edge work (1.7x at that view) with each
// operand element read once per tile pair. Three kernels:
// 1. the pair flags are cleared, and tile_flags_kernel, one thread per
//    slot, flags the (destination tile, source tile) pair of each valid
//    slot (the pair list, built on the device with no host sync; integer
//    writes of 1, so the same flags every launch);
// 2. sddmm_tiled_kernel: grid (source tile, destination tile, split of the
//    feature axis); a block whose pair holds no valid slot returns. The
//    feature axis is split in kSplit-wide pieces, so that the ~31 pairs of
//    the node view still give ~500 blocks for 132 SMs. The block stages
//    [64, kK] slices of a and b in shared memory (converted to f32 in
//    registers, the next slice loaded while the current one is multiplied:
//    a register double buffer, since bf16 operands are widened on the way
//    and cp.async copies bytes as they are), accumulates a 4 x 4 register
//    tile per thread with f32 FMAs on the CUDA cores (TF32 tensor cores
//    would keep about three digits, too few for the port's 1e-5 parity),
//    then writes each valid slot's dot of its split to a partial buffer.
//    The kernel is one instance per operand types and loads, so each gets
//    its own registers; a dual launch whose pairs differ there (bf16 values
//    against an f32 cotangent) runs two, one per pair;
// 3. sddmm_finish_kernel: each slot's partials summed over the splits in
//    split order (one owner per output, no float atomics), 0 on a masked
//    slot.
// Each dot is one chain of FMAs over its split's features in order, and the
// splits of a pair depend only on its width, so the dual form gives the bits
// of two single launches.

#include "bsp_common.cuh"

namespace {

using bsp::kRowWarps;
using bsp::kVec8;
using bsp::VecIO;

constexpr int kABf16 = 1;  // flags of one operand pair
constexpr int kBBf16 = 2;
constexpr int kWideThreads = 256;  // a block per row when some pair is wide
constexpr int kBatch = 4;  // passes of a warp's groups in flight together

__device__ __forceinline__ void load8(const void* p, bool bf16, long long i,
                                      float* x) {
  if (bf16) VecIO<__nv_bfloat16, 8>::load(static_cast<const __nv_bfloat16*>(p) + i, x);
  else VecIO<float, 8>::load(static_cast<const float*>(p) + i, x);
}

__device__ __forceinline__ float load1(const void* p, bool bf16, long long i) {
  float x;
  if (bf16) VecIO<__nv_bfloat16, 1>::load(static_cast<const __nv_bfloat16*>(p) + i, &x);
  else VecIO<float, 1>::load(static_cast<const float*>(p) + i, &x);
  return x;
}

struct Pair {
  const void* a;
  const void* b;
  int d;
  int flags;
};

__host__ __device__ __forceinline__ bool narrow(const Pair& p) {
  return bsp::dot_loads(p.d, p.flags) <= 32;
}

// One chain of FMAs over the elements of load t, t + G, t + 2G, ... of
// <a[arow], b[brow]>, in order. With the group_sum over its G lanes this
// is the one order of every dot of a pair: it depends on d and the flags
// alone, so the dual form gives the bits of two single launches.
__device__ __forceinline__ float lane_dot(const Pair& p, long long arow,
                                          long long brow, int t, int G) {
  const bool abf = p.flags & kABf16;
  const bool bbf = p.flags & kBBf16;
  const long long ia = arow * p.d;
  const long long ib = brow * p.d;
  float acc = 0.f;
  if (p.flags & kVec8) {
#pragma unroll 4
    for (int f = t * 8; f < p.d; f += G * 8) {
      float xa[8], xb[8];
      load8(p.a, abf, ia + f, xa);
      load8(p.b, bbf, ib + f, xb);
      acc = bsp::fma8(xa, xb, acc);
    }
  } else {
    for (int f = t; f < p.d; f += G)
      acc = fmaf(load1(p.a, abf, ia + f), load1(p.b, bbf, ib + f), acc);
  }
  return acc;
}

// One warp's read of slots j0 .. j0 + 31 of row `row`: its lane's source
// (mask and source read together) and the ballot of the valid slots.
struct Slots {
  unsigned valid;
  int src;
};

__device__ __forceinline__ Slots read_slots(const int32_t* __restrict__ ell_src,
                                            const uint8_t* __restrict__ ell_mask,
                                            long long row, int deg, int j0) {
  const int j = j0 + (threadIdx.x & 31);
  const bool in = j < deg;
  const long long at = row * deg + j;
  const bool v = in && ell_mask[at] != 0;
  const int src = in ? ell_src[at] : 0;
  return Slots{__ballot_sync(0xffffffffu, v), src};
}

// All 32 lanes of a warp, a narrow pair: out[row, j] = <a[row], b[src_j]>
// for every slot j of the row, 0 on masked ones. The warp splits into
// groups of G lanes, one valid slot each; kBatch passes of the groups have
// their loads in flight together, with no barrier.
__device__ void narrow_row(const Pair& p, long long row, int deg,
                           const int32_t* __restrict__ ell_src,
                           const uint8_t* __restrict__ ell_mask,
                           float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int G = bsp::group_lanes(bsp::dot_loads(p.d, p.flags));
  const int S = 32 / G;
  const int grp = lane / G;
  const int t = lane & (G - 1);
  for (int j0 = 0; j0 < deg; j0 += 32) {
    const Slots sl = read_slots(ell_src, ell_mask, row, deg, j0);
    if (j0 + lane < deg && !((sl.valid >> lane) & 1u))
      out[row * deg + j0 + lane] = 0.f;
    const int n = __popc(sl.valid);
    for (int k0 = 0; k0 < n; k0 += S * kBatch) {
      float part[kBatch];
      int pos[kBatch];
#pragma unroll
      for (int it = 0; it < kBatch; ++it) {
        const int kk = k0 + it * S + grp;
        pos[it] = kk < n ? bsp::nth_set_bit(sl.valid, kk) : -1;
        const int src = __shfl_sync(0xffffffffu, sl.src, pos[it] & 31);
        part[it] = pos[it] >= 0 ? lane_dot(p, row, src, t, G) : 0.f;
      }
#pragma unroll
      for (int it = 0; it < kBatch; ++it) {
        const float x = bsp::group_sum(part[it], G);
        if (pos[it] >= 0 && t == 0) out[row * deg + j0 + pos[it]] = x;
      }
    }
  }
}

// grid ceil(V / kRowWarps), block 32 x kRowWarps: every pair narrow, one
// warp per row. p2.d == 0: single form.
__global__ void __launch_bounds__(32 * kRowWarps)
sddmm_rows_kernel(Pair p1, Pair p2, const int32_t* __restrict__ ell_src,
                  const uint8_t* __restrict__ ell_mask,
                  float* __restrict__ out1, float* __restrict__ out2, int V,
                  int deg) {
  const long long row = static_cast<long long>(blockIdx.x) * kRowWarps
                        + (threadIdx.x >> 5);
  if (row >= V) return;
  narrow_row(p1, row, deg, ell_src, ell_mask, out1);
  if (p2.d > 0) narrow_row(p2, row, deg, ell_src, ell_mask, out2);
}

// grid V, block kWideThreads: some pair wide. A narrow pair runs on the
// block's last warp (narrow_row). A wide pair's dots take the whole block,
// two valid slots at a time with both slots' loads in flight: thread tid
// chains the loads tid, tid + kWideThreads, ... of each dot, each warp
// reduces with an xor tree and parks its partial in shared memory, and
// after each 32 slots one barrier, then every slot's partials are summed
// over the warps in order. The order depends on d and the flags alone (the
// block is always kWideThreads), so the dual form gives the bits of two
// single launches.
__global__ void __launch_bounds__(kWideThreads)
sddmm_wide_kernel(Pair p1, Pair p2, const int32_t* __restrict__ ell_src,
                  const uint8_t* __restrict__ ell_mask,
                  float* __restrict__ out1, float* __restrict__ out2,
                  int deg) {
  constexpr int W = kWideThreads / 32;
  __shared__ float red[2][W][32];  // [pair][warp][valid slot of the chunk]
  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool dual = p2.d > 0;
  const bool wide1 = !narrow(p1);
  const bool wide2 = dual && !narrow(p2);
  if (warp == W - 1) {
    if (!wide1) narrow_row(p1, row, deg, ell_src, ell_mask, out1);
    if (dual && !wide2) narrow_row(p2, row, deg, ell_src, ell_mask, out2);
  }
  for (int j0 = 0; j0 < deg; j0 += 32) {
    const Slots sl = read_slots(ell_src, ell_mask, row, deg, j0);
    if (warp == 0 && j0 + lane < deg && !((sl.valid >> lane) & 1u)) {
      if (wide1) out1[row * deg + j0 + lane] = 0.f;
      if (wide2) out2[row * deg + j0 + lane] = 0.f;
    }
    const int n = __popc(sl.valid);
    for (int k = 0; k < n; k += 2) {
      const bool two = k + 1 < n;
      const int s0 = __shfl_sync(0xffffffffu, sl.src, bsp::nth_set_bit(sl.valid, k));
      const int s1 = __shfl_sync(0xffffffffu, sl.src,
                                 two ? bsp::nth_set_bit(sl.valid, k + 1) : 0);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q == 0 ? !wide1 : !wide2) continue;
        const Pair& p = q == 0 ? p1 : p2;
        float x0 = lane_dot(p, row, s0, tid, kWideThreads);
        float x1 = two ? lane_dot(p, row, s1, tid, kWideThreads) : 0.f;
        x0 = bsp::group_sum(x0, 32);
        x1 = bsp::group_sum(x1, 32);
        if (lane == 0) {
          red[q][warp][k] = x0;
          if (two) red[q][warp][k + 1] = x1;
        }
      }
    }
    __syncthreads();
    for (int k = tid; k < n; k += kWideThreads) {
      const long long at = row * deg + j0 + bsp::nth_set_bit(sl.valid, k);
      float t1 = 0.f, t2 = 0.f;
      for (int w = 0; w < W; ++w) {
        t1 += red[0][w][k];
        t2 += red[1][w][k];
      }
      if (wide1) out1[at] = t1;
      if (wide2) out2[at] = t2;
    }
    __syncthreads();  // the partials are rewritten by the next 32 slots
  }
}

// --- the tiled form ---------------------------------------------------------

constexpr int kT = bsp::kTile;      // nodes per tile
constexpr int kK = 32;              // features per shared-memory slice
constexpr int kPitch = kK + 4;      // 9 float4s per row: an odd count, so
                                    // 8 rows read by 8 threads hit 8 bank groups
constexpr int kSplit = 512;         // features per block
constexpr int kThreads = 256;       // 16 x 16 threads, 4 x 4 dots each
constexpr int kCPitch = kT + 1;     // the block of dots in shared memory

// One thread's share of a [kT, kK] slice of rows row0 .. row0 + nrows - 1
// of T [., d], features k0 .. min(k0 + kK, kend) - 1, zero past either end;
// VEC consecutive features per load (VEC > 1 needs d % VEC == 0 and aligned
// rows, so a group never straddles kend).
template <typename T, int VEC>
struct Slice {
  static constexpr int kGroups = kK / VEC;                 // per row
  static constexpr int kPer = kT * kGroups / kThreads;     // per thread
  float r[kPer * VEC];

  __device__ __forceinline__ void load(const T* __restrict__ base,
                                       long long row0, int nrows, long long d,
                                       long long k0, long long kend) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int idx = threadIdx.x + p * kThreads;
      const int i = idx / kGroups;
      const long long k = k0 + (idx % kGroups) * VEC;
      if (i < nrows && k < kend) {
        VecIO<T, VEC>::load(base + (row0 + i) * d + k, r + p * VEC);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) r[p * VEC + e] = 0.f;
      }
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ sm) const {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int idx = threadIdx.x + p * kThreads;
      float* dst = sm + (idx / kGroups) * kPitch + (idx % kGroups) * VEC;
      if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int e = 0; e < VEC; e += 4)
          *reinterpret_cast<float4*>(dst + e) = make_float4(
              r[p * VEC + e], r[p * VEC + e + 1], r[p * VEC + e + 2],
              r[p * VEC + e + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) dst[e] = r[p * VEC + e];
      }
    }
  }
};

// acc[r][c] += sum over the slice of As[ty + 16 r][k] * Bs[tx + 16 c][k],
// k in order.
__device__ __forceinline__ void dot_slice(const float* __restrict__ As,
                                          const float* __restrict__ Bs,
                                          float (&acc)[4][4]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int kk = 0; kk < kK; kk += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(As + (ty + 16 * i) * kPitch + kk);
      b[i] = *reinterpret_cast<const float4*>(Bs + (tx + 16 * i) * kPitch + kk);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[r][c] = fmaf(a[r].x, b[c].x, acc[r][c]);
        acc[r][c] = fmaf(a[r].y, b[c].y, acc[r][c]);
        acc[r][c] = fmaf(a[r].z, b[c].z, acc[r][c]);
        acc[r][c] = fmaf(a[r].w, b[c].w, acc[r][c]);
      }
    }
  }
}

// The [kT, kT] block of dots <a[v0 + i], b[s0 + j]> over features k0 ..
// kend - 1 into acc (thread (ty, tx) holds i = ty + 16 r, j = tx + 16 c).
// sm: 4 slices of [kT, kPitch] floats (A and B, double-buffered).
template <typename TA, typename TB, int VA, int VB>
__device__ __forceinline__ void tile_dots(const void* a, const void* b, int d,
                                          long long v0, int nv, long long s0,
                                          int ns, long long k0, long long kend,
                                          float* sm, float (&acc)[4][4]) {
  const TA* pa = static_cast<const TA*>(a);
  const TB* pb = static_cast<const TB*>(b);
  Slice<TA, VA> la;
  Slice<TB, VB> lb;
  constexpr int kSlice = kT * kPitch;  // buffer b: A at 2b, B at 2b + 1
  const int n = static_cast<int>((kend - k0 + kK - 1) / kK);
  la.load(pa, v0, nv, d, k0, kend);
  lb.load(pb, s0, ns, d, k0, kend);
  la.store(sm);
  lb.store(sm + kSlice);
  __syncthreads();
  for (int c = 0; c < n; ++c) {
    float* cur = sm + (c & 1) * 2 * kSlice;
    float* nxt = sm + ((c & 1) ^ 1) * 2 * kSlice;
    const bool next = c + 1 < n;
    if (next) {  // the next slice's loads are in flight during the FMAs
      la.load(pa, v0, nv, d, k0 + (c + 1) * kK, kend);
      lb.load(pb, s0, ns, d, k0 + (c + 1) * kK, kend);
    }
    dot_slice(cur, cur + kSlice, acc);
    if (next) {  // nxt was last read before the previous barrier
      la.store(nxt);
      lb.store(nxt + kSlice);
    }
    __syncthreads();
  }
}

// One thread per slot, after the flags are cleared: flags[dt * nts + st] =
// 1 where a valid slot of destination tile dt names a source of tile st
// (every writer writes 1, so the same flags every launch).
__global__ void __launch_bounds__(kThreads)
tile_flags_kernel(const int32_t* __restrict__ ell_src,
                  const uint8_t* __restrict__ ell_mask,
                  uint8_t* __restrict__ flags, long long n, int deg,
                  int nts) {
  const long long slot = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (slot < n && ell_mask[slot])
    flags[(slot / deg / kT) * nts + ell_src[slot] / kT] = 1;
}

// grid (nts, nt, splits), block kThreads: block (st, dt, z = z0 +
// blockIdx.z) computes the dots of pair p1 (z < s1; features of split z) or
// p2 (split z - s1) between destination tile dt and source tile st, if any
// valid slot joins them, and writes each such slot's dot to
// partial[z][slot]. Both pairs of a launch have the operand types and loads
// of the template arguments. Two blocks per SM.
template <typename TA, typename TB, int VA, int VB>
__global__ void __launch_bounds__(kThreads, 2)
sddmm_tiled_kernel(Pair p1, Pair p2, int s1, int z0,
                   const int32_t* __restrict__ ell_src,
                   const uint8_t* __restrict__ ell_mask,
                   const uint8_t* __restrict__ flags,
                   float* __restrict__ partial, int V, int Vs, int deg,
                   int nts) {
  __shared__ __align__(16) float sm[4 * kT * kPitch];
  const int st = blockIdx.x;
  const int dt = blockIdx.y;
  const int z = z0 + blockIdx.z;
  if (!flags[static_cast<long long>(dt) * nts + st]) return;
  const Pair p = z < s1 ? p1 : p2;
  const long long k0 = static_cast<long long>(z < s1 ? z : z - s1) * kSplit;
  const long long kend = min(static_cast<long long>(p.d), k0 + kSplit);
  const long long v0 = static_cast<long long>(dt) * kT;
  const long long s0 = static_cast<long long>(st) * kT;
  const int nv = min(kT, V - static_cast<int>(v0));
  const int ns = min(kT, Vs - static_cast<int>(s0));

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  tile_dots<TA, TB, VA, VB>(p.a, p.b, p.d, v0, nv, s0, ns, k0, kend, sm, acc);

  // The block of dots to shared memory (the slices are no longer read:
  // tile_dots ends on a barrier), then each valid slot of the destination
  // tile whose source lies in this source tile takes its entry.
  float* cs = sm;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) cs[(ty + 16 * r) * kCPitch + tx + 16 * c] = acc[r][c];
  __syncthreads();
  float* out = partial + static_cast<long long>(z) * V * deg;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < nv; i += kThreads / 32) {  // a warp per row
    const long long row = (v0 + i) * deg;
#pragma unroll 4
    for (int j = lane; j < deg; j += 32) {  // mask and source read together
      const bool valid = ell_mask[row + j];
      const int s = ell_src[row + j] - static_cast<int>(s0);
      if (valid && s >= 0 && s < kT) out[row + j] = cs[i * kCPitch + s];
    }
  }
}

// One thread per slot: out = the sum of the slot's partials over the splits
// of its pair, in split order; 0 on a masked slot. s2 == 0: single form.
__global__ void __launch_bounds__(kThreads)
sddmm_finish_kernel(const float* __restrict__ partial,
                    const uint8_t* __restrict__ ell_mask,
                    float* __restrict__ out1, float* __restrict__ out2,
                    long long n, int s1, int s2) {
  const long long slot = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (slot >= n) return;
  const bool valid = ell_mask[slot];
  float t = 0.f;
  for (int z = 0; valid && z < s1; ++z) t += partial[z * n + slot];
  out1[slot] = t;
  if (s2 > 0) {
    t = 0.f;
    for (int z = s1; valid && z < s1 + s2; ++z) t += partial[z * n + slot];
    out2[slot] = t;
  }
}

int splits(int d) { return d > 0 ? (d + kSplit - 1) / kSplit : 0; }

// Launches the instance of sddmm_tiled_kernel for operand flags `flags`
// (bits kABf16, kBBf16, kVec8) over splits z0 .. z0 + nz - 1.
cudaError_t launch_dots(int flags, dim3 grid, int z0, Pair p1, Pair p2, int s1,
                        const int32_t* ell_src, const uint8_t* ell_mask,
                        const uint8_t* tile_flags, float* partial, int V,
                        int Vs, int deg, int nts, cudaStream_t stream) {
  using bf = __nv_bfloat16;
#define BSP_DOTS(TA, TB, VA, VB)                                            \
  sddmm_tiled_kernel<TA, TB, VA, VB><<<grid, kThreads, 0, stream>>>(        \
      p1, p2, s1, z0, ell_src, ell_mask, tile_flags, partial, V, Vs, deg, nts)
  switch (flags & (kABf16 | kBBf16 | kVec8)) {
    case kVec8: BSP_DOTS(float, float, 4, 4); break;
    case kVec8 | kABf16: BSP_DOTS(bf, float, 8, 4); break;
    case kVec8 | kBBf16: BSP_DOTS(float, bf, 4, 8); break;
    case kVec8 | kABf16 | kBBf16: BSP_DOTS(bf, bf, 8, 8); break;
    case 0: BSP_DOTS(float, float, 1, 1); break;
    case kABf16: BSP_DOTS(bf, float, 1, 1); break;
    case kBBf16: BSP_DOTS(float, bf, 1, 1); break;
    default: BSP_DOTS(bf, bf, 1, 1); break;
  }
#undef BSP_DOTS
  return cudaGetLastError();
}

long long tiled_scratch(int V, int Vs, int deg, int d1, int d2) {
  const long long nt = (V + kT - 1) / kT;
  const long long nts = (Vs + kT - 1) / kT;
  return static_cast<long long>(splits(d1) + splits(d2)) * V * deg * 4 + nt * nts;
}

cudaError_t launch_tiled(Pair p1, Pair p2, const int32_t* ell_src,
                         const uint8_t* ell_mask, float* out1, float* out2,
                         int V, int Vs, int deg, void* scratch,
                         cudaStream_t stream) {
  const int nt = (V + kT - 1) / kT;
  const int nts = (Vs + kT - 1) / kT;
  const int s1 = splits(p1.d);
  const int s2 = splits(p2.d);
  if (nt > 65535 || s1 + s2 > 65535) return cudaErrorInvalidConfiguration;
  const long long n = static_cast<long long>(V) * deg;
  float* partial = static_cast<float*>(scratch);
  uint8_t* flags = reinterpret_cast<uint8_t*>(partial + (s1 + s2) * n);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  cudaError_t err = cudaMemsetAsync(flags, 0, static_cast<size_t>(nt) * nts, stream);
  if (err != cudaSuccess) return err;
  tile_flags_kernel<<<blocks, kThreads, 0, stream>>>(ell_src, ell_mask, flags,
                                                     n, deg, nts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // One launch for both pairs where their operands take one instance (the
  // training step's f32 pairs), else one for each.
  const int mask = kABf16 | kBBf16 | kVec8;
  if (s2 == 0 || (p1.flags & mask) == (p2.flags & mask)) {
    err = launch_dots(p1.flags, dim3(nts, nt, s1 + s2), 0, p1, p2, s1,
                      ell_src, ell_mask, flags, partial, V, Vs, deg, nts,
                      stream);
  } else {
    err = launch_dots(p1.flags, dim3(nts, nt, s1), 0, p1, p2, s1, ell_src,
                      ell_mask, flags, partial, V, Vs, deg, nts, stream);
    if (err == cudaSuccess)
      err = launch_dots(p2.flags, dim3(nts, nt, s2), s1, p1, p2, s1, ell_src,
                        ell_mask, flags, partial, V, Vs, deg, nts, stream);
  }
  if (err != cudaSuccess) return err;
  sddmm_finish_kernel<<<blocks, kThreads, 0, stream>>>(partial, ell_mask, out1,
                                                      out2, n, s1, s2);
  return cudaGetLastError();
}

}  // namespace

// Bytes of scratch the tiled form needs (the caller allocates them).
extern "C" long long bsp_sddmm_scratch(int V, int Vs, int deg, int d1,
                                       int d2) {
  return tiled_scratch(V, Vs, deg, d1, d2);
}

// flags1 / flags2: bit 0 a is bf16, bit 1 b is bf16, bit 2 16-byte loads
// (d a multiple of 8, rows 16-byte aligned). d2 == 0 (a2, b2, out2 unused)
// is the single form. deg may be any width; Vs is the number of rows of b1
// (and b2). tiled 0: the per-edge form; 1: the tiled form, with
// bsp_sddmm_scratch(...) bytes of scratch. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int bsp_sddmm(const void* a1, const void* b1, int d1, int flags1,
                         const void* a2, const void* b2, int d2, int flags2,
                         const int32_t* ell_src, const uint8_t* ell_mask,
                         float* out1, float* out2, int V, int deg, int Vs,
                         int tiled, void* scratch, int device,
                         void* stream) {
  if (V <= 0 || deg <= 0 || d1 <= 0 || d2 < 0 || Vs <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tiled) {
    return static_cast<int>(launch_tiled(
        Pair{a1, b1, d1, flags1}, Pair{a2, b2, d2, flags2}, ell_src, ell_mask,
        out1, out2, V, Vs, deg, scratch, static_cast<cudaStream_t>(stream)));
  }
  const Pair p1{a1, b1, d1, flags1};
  const Pair p2{a2, b2, d2, flags2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (narrow(p1) && (d2 == 0 || narrow(p2))) {
    sddmm_rows_kernel<<<static_cast<unsigned>((V + kRowWarps - 1) / kRowWarps),
                        32 * kRowWarps, 0, s>>>(p1, p2, ell_src, ell_mask,
                                                out1, out2, V, deg);
  } else {
    sddmm_wide_kernel<<<static_cast<unsigned>(V), kWideThreads, 0, s>>>(
        p1, p2, ell_src, ell_mask, out1, out2, deg);
  }
  return static_cast<int>(cudaGetLastError());
}
