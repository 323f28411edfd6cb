// The tiled weighted sum of bsp_spmm_t.cu's tiled form and bsp_fused_parts.cu's
// tiled forward: out[s] = sum over v of W[v, s] * x[v], with W a dense f32
// [nt * kTile, nts * kTile] matrix in scratch that is 0 outside the (v tile,
// s tile) pairs whose flag is set. The transposed SpMM fills W with the
// weights of each destination row (W[v, s]: destination v, source s); the
// attention forward fills it transposed (W[s, v]: source s, destination v),
// so that both stage contiguous rows of W and run the same tile loop.

#pragma once

#include "bsp_common.cuh"

namespace bsp {

constexpr int kXBf16 = 1;    // flags of one operand pair: x is bf16,
constexpr int kOutBf16 = 2;  // out is bf16, kVec8 (bsp_common.cuh): 16-byte
                             // loads (D % 8 == 0, aligned rows)

template <int VEC>
__device__ __forceinline__ void load_row(const void* p, bool bf16,
                                         long long i, float* x) {
  if (bf16) VecIO<__nv_bfloat16, VEC>::load(static_cast<const __nv_bfloat16*>(p) + i, x);
  else VecIO<float, VEC>::load(static_cast<const float*>(p) + i, x);
}

template <int VEC>
__device__ __forceinline__ void store_row(void* p, bool bf16, long long i,
                                          const float* x) {
  if (bf16) VecIO<__nv_bfloat16, VEC>::store(static_cast<__nv_bfloat16*>(p) + i, x);
  else VecIO<float, VEC>::store(static_cast<float*>(p) + i, x);
}

constexpr int kTileF = 128;       // features per block
constexpr int kTileThreads = 128; // 8 x 16 threads, 8 rows x 8 features each

struct TiledPair {
  const float* w;   // per-slot weights (the transposed SpMM's densify input)
  const void* x;    // [V, D]
  void* out;        // [Vs, D]
  long long D;
  int flags;        // kXBf16 | kOutBf16 | kVec8
  float* W;         // the dense [nt * kTile, nts * kTile] weights, in scratch
};

constexpr int kWTile = kTile * kTile;              // floats of a W tile
constexpr int kXTile = kTile * kTileF;             // floats of an x tile
constexpr int kStage = kWTile + kXTile;            // one buffer
constexpr int kTileSmemBytes = 2 * kStage * 4;     // two buffers: 96 KB

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// x[v0 + i, f0 + f] for i < nv and f0 + f < D (0 elsewhere) -> Xs[i][f],
// through registers (bf16 rows are widened on the way; rows that are not
// 16-byte aligned take VEC 1): every load is issued before the first store.
template <typename TX, int VEC>
__device__ __forceinline__ void stage_x(const TX* __restrict__ x, long long D,
                                        long long v0, int nv, long long f0,
                                        float* __restrict__ Xs) {
  constexpr int kGroups = kTileF / VEC;
  constexpr int kPer = kTile * kGroups / kTileThreads;
  constexpr int kBatch = 16 / VEC;  // 16 floats in flight per thread
  for (int q0 = 0; q0 < kPer; q0 += kBatch) {
    float r[kBatch][VEC];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int idx = threadIdx.x + (q0 + q) * kTileThreads;
      const int i = idx / kGroups;
      const int f = (idx % kGroups) * VEC;
      if (i < nv && f0 + f < D) {
        VecIO<TX, VEC>::load(x + (v0 + i) * D + f0 + f, r[q]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) r[q][e] = 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int idx = threadIdx.x + (q0 + q) * kTileThreads;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        Xs[(idx / kGroups) * kTileF + (idx % kGroups) * VEC + e] = r[q][e];
    }
  }
}

// Starts the copies of row tile dt's W tile and x tile into buffer buf (one
// cp.async group; the register path's stores are done on return).
__device__ __forceinline__ void stage_pair(const TiledPair& p, int dt, int V,
                                           long long s0, long long VsP,
                                           long long f0, float* buf) {
  const long long v0 = static_cast<long long>(dt) * kTile;
  const int nv = min(kTile, V - static_cast<int>(v0));
  float* Ws = buf;
  float* Xs = buf + kWTile;
#pragma unroll
  for (int q = 0; q < kWTile / 4 / kTileThreads; ++q) {
    const int idx = threadIdx.x + q * kTileThreads;
    const int i = idx / (kTile / 4);
    const int j = (idx % (kTile / 4)) * 4;
    const bool full = i < nv;
    cp_async16(Ws + i * kTile + j, full ? p.W + (v0 + i) * VsP + s0 + j : p.W,
               full);
  }
  const bool xbf = p.flags & kXBf16;
  const bool vec = p.flags & kVec8;
  if (!xbf && vec) {
    const float* x = static_cast<const float*>(p.x);
#pragma unroll
    for (int q = 0; q < kXTile / 4 / kTileThreads; ++q) {
      const int idx = threadIdx.x + q * kTileThreads;
      const int i = idx / (kTileF / 4);
      const int f = (idx % (kTileF / 4)) * 4;
      const bool full = i < nv && f0 + f < p.D;
      cp_async16(Xs + i * kTileF + f, full ? x + (v0 + i) * p.D + f0 + f : x,
                 full);
    }
  } else if (xbf) {
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
    if (vec) stage_x<__nv_bfloat16, 8>(x, p.D, v0, nv, f0, Xs);
    else stage_x<__nv_bfloat16, 1>(x, p.D, v0, nv, f0, Xs);
  } else {
    stage_x<float, 1>(static_cast<const float*>(p.x), p.D, v0, nv, f0, Xs);
  }
  cp_async_commit();
}

// The first row tile from dt on whose pair with column tile st holds a
// valid slot, or nt.
__device__ __forceinline__ int next_tile(const uint8_t* __restrict__ flags,
                                         int dt, int nt, int nts, int st) {
  while (dt < nt && !flags[static_cast<long long>(dt) * nts + st]) ++dt;
  return dt;
}

// The body of a kernel of grid (c1 + c2 feature chunks, nts column tiles),
// block kTileThreads, kTileSmemBytes of dynamic shared memory: block (chunk,
// st) writes out[s0 .. s0 + 63, chunk's features] of pair p1 (chunk < c1)
// or p2, where out[s] = sum over the V rows v of W[v, s] * x[v], v
// ascending, flags[dt * nts + st] marking the (row tile, column tile) pairs
// that hold a weight. It walks the flagged row tiles in order and stages the
// [64, 64] tile of W and x[row tile, chunk] in shared memory (48 KB a pair,
// two buffers: the next pair's tiles are copied in with cp.async while the
// current ones are multiplied; bf16 or unaligned x rows go through
// registers), accumulates an 8 x 8 register tile per thread (four 16-byte
// shared-memory reads per 64 FMAs) with f32 FMAs and writes its outputs
// once. Each output is one fixed chain of FMAs: the same bits every launch.
__device__ __forceinline__ void tiled_product(
    const TiledPair& p1, const TiledPair& p2, int c1,
    const uint8_t* __restrict__ flags, int V, int Vs, int nt, int nts) {
  extern __shared__ __align__(16) float smem[];
  const int st = blockIdx.y;
  const int ch = blockIdx.x;
  const TiledPair p = ch < c1 ? p1 : p2;
  const long long f0 = static_cast<long long>(ch < c1 ? ch : ch - c1) * kTileF;
  const long long s0 = static_cast<long long>(st) * kTile;
  const long long VsP = static_cast<long long>(nts) * kTile;
  const int tx = threadIdx.x & 15;  // features tx * 4 + 64 h + c
  const int ty = threadIdx.x >> 4;  // outputs ty * 8 + r
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  int cur = next_tile(flags, 0, nt, nts, st);
  int buf = 0;
  if (cur < nt) stage_pair(p, cur, V, s0, VsP, f0, smem);
  while (cur < nt) {
    const int nxt = next_tile(flags, cur + 1, nt, nts, st);
    if (nxt < nt) {  // the other buffer was last read before the last barrier
      stage_pair(p, nxt, V, s0, VsP, f0, smem + (buf ^ 1) * kStage);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const float* Ws = smem + buf * kStage;
    const float* Xs = Ws + kWTile;
    const int nv = min(kTile, V - cur * kTile);
#pragma unroll 4
    for (int v = 0; v < nv; ++v) {
      const float4 w0 = *reinterpret_cast<const float4*>(Ws + v * kTile + ty * 8);
      const float4 w1 = *reinterpret_cast<const float4*>(Ws + v * kTile + ty * 8 + 4);
      const float4 x0 = *reinterpret_cast<const float4*>(Xs + v * kTileF + tx * 4);
      const float4 x1 = *reinterpret_cast<const float4*>(Xs + v * kTileF + 64 + tx * 4);
      const float a[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], xv[c], acc[r][c]);
    }
    __syncthreads();  // this buffer is refilled two pairs on
    buf ^= 1;
    cur = nxt;
  }

  const bool obf = p.flags & kOutBf16;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const long long s = s0 + ty * 8 + r;
    if (s >= Vs) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const long long f = f0 + (c < 4 ? 0 : 64) + tx * 4 + (c & 3);
      const float val = acc[r][c];
      if (f < p.D) store_row<1>(p.out, obf, s * p.D + f, &val);
    }
  }
}

inline long long tiled_chunks(long long D) {
  return D > 0 ? (D + kTileF - 1) / kTileF : 0;
}

}  // namespace bsp
