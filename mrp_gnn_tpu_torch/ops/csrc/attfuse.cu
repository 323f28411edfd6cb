// AttFuse's per-pixel cross-robot attention (OPV2V's AttFusion: q = k = v
// = x, no learned projection), forward and backward, over a batch's ELL
// neighbour lists, for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (mrp_gnn_tpu_torch/ops/attfuse.py).
//
//   y[p, i] = sum over j in S(i) of a_ij x[p, j],
//   a_ij = softmax over j in S(i) of x[p, i] . x[p, j] / sqrt(C)
//
// for every pixel p of x [P, V, C] (f32, pixel-major rows of C channels),
// where S(i) is node i itself and the sources of ELL row i's valid slots,
// as a set. A padded node (node_mask false) is in no set and gets 0. f32
// throughout: fmaf chains and exp2f, no tensor cores (no TF32).
//
// Replaces: no TPU kernel (the JAX package has no AttFuse). Added because
// the plain form cannot run at the main path's size: at dense_swarm's
// 32x32x32 scale the gathered neighbour rows alone are 74,112 edges x
// 32,768 x 4 B = 9.7 GB a tensor, and autograd keeps them.
//
// Bound: operations. A (pair, pixel) costs 4 C flops forward (a C-wide dot
// and a C-wide weighted sum) and 8 C backward; at dense_swarm (E 74,112,
// sum of P C over the three scales 57,344) the forward is 17.0 GFLOP,
// 0.25 ms at 67 TFLOP/s, against 0.07 ms for its 235 MB of maps at 3.35
// TB/s.
//
// Design: per pixel the block is a dense attention over tiles of 64 nodes
// with a bit mask, the flash-attention form: a source tile is read once
// for all 64 destinations of a tile (64 flops a byte), where an ELL-slot
// walk reads every source row once a destination (1 flop a byte). One
// launch builds the graph's masks (attfuse_graph_kernel): the dense bit
// matrix words[v * nt + t] (bit b: node 64 t + b is in S(v)) and the flags
// of the (destination tile, source tile) pairs that hold a bit, and of
// their transposes. The graph's tile-pair plans are not used: their tiles
// are 128 nodes (and expanded rows past a width of 128), and they flag a
// pair without saying which slots, where every (row, source) bit is
// needed here, both ways; the bit matrix gives both in one launch of
// 0.04-0.06 ms. The forward (a block per destination tile and pixel)
// walks its flagged source tiles with an online softmax and keeps each
// row's log-sum-exp; the backward (a block per tile and pixel) sums the
// whole gradient of its own rows, dx = dq + dk + dv, over the tiles
// flagged either way, from five 64 x 64 x C products a pair. Each output
// is written by one thread: no float atomics, the same bits every run.
// The products keep 4 x 4 sums a thread (256 threads, rows ty + 16 r,
// columns tx + 16 c) over shared rows padded to C + 4 floats, read 16
// bytes at a time without bank conflicts.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using u64 = unsigned long long;

constexpr int kTile = 64;           // nodes a tile (bits of a mask word)
constexpr int kThreads = 256;       // 16 x 16 threads (ty, tx)
constexpr int kPad = 4;             // a shared row holds C + 4 floats
constexpr int kWLd = kTile + kPad;  // a shared weight row: 68 floats

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float lane4(const float4 v, int t) {
  return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
}

// Over the 16 lanes of a half warp (one ty).
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows r0 .. r0 + 63 of one pixel's [V, C] slice into shared [64][C + 4],
// 16-byte loads; rows past V are zero.
template <int C>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int r0, int V,
                                          float* __restrict__ dst) {
  constexpr int kVec = C / 4;
  for (int f = threadIdx.x; f < kTile * kVec; f += kThreads) {
    const int r = f / kVec, c = (f % kVec) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < V) v = ld4(src + static_cast<long long>(r0 + r) * C + c);
    *reinterpret_cast<float4*>(dst + r * (C + kPad) + c) = v;
  }
}

// s[r][c] = a[ty + 16 r] . b[tx + 16 c], rows of shared [64][C + 4].
template <int C>
__device__ __forceinline__ void tile_dot(const float* __restrict__ a,
                                         const float* __restrict__ b,
                                         float (&s)[4][4]) {
  constexpr int kLd = C + kPad;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 2
  for (int k = 0; k < C; k += 4) {
    float4 ar[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) ar[r] = ld4(a + (ty + 16 * r) * kLd + k);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 bc = ld4(b + (tx + 16 * c) * kLd + k);
#pragma unroll
      for (int r = 0; r < 4; ++r) s[r][c] = dot4(ar[r], bc, s[r][c]);
    }
  }
}

// The backward's three products of a pair, one pass over the channels:
// t = xb[j] . xa[i], g1 = xb[j] . ga[i], g2 = gb[j] . xa[i], for j = ty +
// 16 r (own rows) and i = tx + 16 c (partner rows).
template <int C>
__device__ __forceinline__ void tile_dot3(const float* __restrict__ xb,
                                          const float* __restrict__ gb,
                                          const float* __restrict__ xa,
                                          const float* __restrict__ ga,
                                          float (&t)[4][4], float (&g1)[4][4],
                                          float (&g2)[4][4]) {
  constexpr int kLd = C + kPad;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) t[r][c] = g1[r][c] = g2[r][c] = 0.f;
#pragma unroll 1
  for (int k = 0; k < C; k += 4) {
    float4 xr[4], gr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      xr[r] = ld4(xb + (ty + 16 * r) * kLd + k);
      gr[r] = ld4(gb + (ty + 16 * r) * kLd + k);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 xc = ld4(xa + (tx + 16 * c) * kLd + k);
      const float4 gc = ld4(ga + (tx + 16 * c) * kLd + k);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        t[r][c] = dot4(xr[r], xc, t[r][c]);
        g1[r][c] = dot4(xr[r], gc, g1[r][c]);
        g2[r][c] = dot4(gr[r], xc, g2[r][c]);
      }
    }
  }
}

// acc[r][c] += sum over s of w[ty + 16 r][s] v[s][tx + 16 c]: w in shared
// [64][68], v rows in shared [64][C + 4].
template <int C>
__device__ __forceinline__ void tile_weighted_sum(
    const float* __restrict__ w, const float* __restrict__ v,
    float (&acc)[4][C / 16]) {
  constexpr int kLd = C + kPad, kCols = C / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 2
  for (int s = 0; s < kTile; s += 4) {
    float4 wr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) wr[r] = ld4(w + (ty + 16 * r) * kWLd + s);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float vc[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vc[c] = v[(s + u) * kLd + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float wv = lane4(wr[r], u);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(wv, vc[c], acc[r][c]);
      }
    }
  }
}

// One thread per (node v, slot j <= deg): slot deg is v itself. A slot
// counts when it is valid and both ends are real robots.
__global__ void attfuse_graph_kernel(const int32_t* __restrict__ ell_src,
                                     const uint8_t* __restrict__ ell_mask,
                                     const uint8_t* __restrict__ node_mask,
                                     int V, int deg, int nt,
                                     u64* __restrict__ words,
                                     uint8_t* __restrict__ fwd_tiles,
                                     uint8_t* __restrict__ bwd_tiles) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(V) * (deg + 1)) return;
  const int v = static_cast<int>(idx / (deg + 1));
  const int j = static_cast<int>(idx % (deg + 1));
  if (!node_mask[v]) return;
  int s = v;
  if (j < deg) {
    const long long e = static_cast<long long>(v) * deg + j;
    if (!ell_mask[e]) return;
    s = ell_src[e];
    if (s < 0 || s >= V || !node_mask[s]) return;
  }
  atomicOr(words + static_cast<long long>(v) * nt + s / kTile,
           1ull << (s % kTile));
  const int a = v / kTile, t = s / kTile;
  fwd_tiles[a * nt + t] = 1;  // every writer stores 1
  bwd_tiles[a * nt + t] = 1;
  bwd_tiles[t * nt + a] = 1;
}

// Block (destination tile a, pixel p), blockIdx.x = p * nt + a. lse is in
// log2 units of the logits times log2(e) / sqrt(C) (scale2).
template <int C>
__global__ void __launch_bounds__(kThreads)
attfuse_forward_kernel(const float* __restrict__ x, float* __restrict__ y,
                       float* __restrict__ lse, const u64* __restrict__ words,
                       const uint8_t* __restrict__ fwd_tiles, int V, int nt,
                       float scale2) {
  constexpr int kLd = C + kPad, kCols = C / 16;
  extern __shared__ __align__(16) float smem[];
  float* q = smem;                 // the destination rows
  float* kv = q + kTile * kLd;     // a source tile, keys and values
  float* w = kv + kTile * kLd;     // [64][68] the tile's weights
  __shared__ u64 bits[kTile];      // destination row i's word of the tile
  const int a = blockIdx.x % nt;
  const long long p = blockIdx.x / nt;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* xp = x + p * V * C;
  load_tile<C>(xp, a * kTile, V, q);
  float m[4], l[4], o[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[r][c] = 0.f;
  }
  for (int t = 0; t < nt; ++t) {
    if (!fwd_tiles[a * nt + t]) continue;  // the same for the whole block
    __syncthreads();  // the last tile's reads of kv and w are done
    load_tile<C>(xp, t * kTile, V, kv);
    if (threadIdx.x < kTile) {
      const int i = a * kTile + threadIdx.x;
      bits[threadIdx.x] =
          i < V ? words[static_cast<long long>(i) * nt + t] : 0ull;
    }
    __syncthreads();
    float s[4][4];
    tile_dot<C>(q, kv, s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const u64 row = bits[ty + 16 * r];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool on = (row >> (tx + 16 * c)) & 1ull;
        s[r][c] = on ? s[r][c] * scale2 : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
      mx = half_max(mx);
      const float mn = fmaxf(m[r], mx);
      const float base = mn == -INFINITY ? 0.f : mn;
      const float corr = exp2f(m[r] - base);  // 0 while m is -inf
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = exp2f(s[r][c] - base);  // 0 where masked
        sum += s[r][c];
      }
      sum = half_sum(sum);
      l[r] = l[r] * corr + sum;
      m[r] = mn;
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[r][c] *= corr;
#pragma unroll
      for (int c = 0; c < 4; ++c) w[(ty + 16 * r) * kWLd + tx + 16 * c] = s[r][c];
    }
    __syncthreads();
    tile_weighted_sum<C>(w, kv, o);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = a * kTile + ty + 16 * r;
    if (i >= V) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      y[(p * V + i) * C + tx + 16 * c] = o[r][c] * inv;
    if (tx == 0) lse[p * V + i] = l[r] > 0.f ? m[r] + log2f(l[r]) : -INFINITY;
  }
}

// delta[row] = gy[row] . y[row] over every (pixel, node) row.
template <int C>
__global__ void attfuse_delta_kernel(const float* __restrict__ y,
                                     const float* __restrict__ gy,
                                     float* __restrict__ delta,
                                     long long rows) {
  const long long r =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < C; k += 4)
    acc = dot4(ld4(y + r * C + k), ld4(gy + r * C + k), acc);
  delta[r] = acc;
}

// Block (own tile b, pixel p), blockIdx.x = p * nt + b: dx of own rows j,
//   dx_j = sum_i a_ij gy_i + (1 / sqrt C) sum_i (ds_ij + ds_ji) x_i,
//   ds_ij = a_ij (gy_i . x_j - delta_i)  (j in S(i); 0 otherwise),
// over the partner tiles a flagged either way (bwd_tiles[b * nt + a]).
template <int C>
__global__ void __launch_bounds__(kThreads)
attfuse_backward_kernel(const float* __restrict__ x,
                        const float* __restrict__ gy,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ gx, const u64* __restrict__ words,
                        const uint8_t* __restrict__ bwd_tiles, int V, int nt,
                        float scale2, float scale) {
  constexpr int kLd = C + kPad, kCols = C / 16;
  extern __shared__ __align__(16) float smem[];
  float* xb = smem;              // own rows j
  float* gb = xb + kTile * kLd;  // their output gradients
  float* xa = gb + kTile * kLd;  // partner rows i
  float* ga = xa + kTile * kLd;
  float* w1 = ga + kTile * kLd;  // [j][i]: a_ij
  float* w2 = w1 + kTile * kWLd; // [j][i]: (ds_ij + ds_ji) / sqrt C
  __shared__ u64 bits_a[kTile];  // partner row i's word of tile b
  __shared__ u64 bits_b[kTile];  // own row j's word of tile a
  __shared__ float la[kTile], da[kTile], lb[kTile], db[kTile];
  const int b = blockIdx.x % nt;
  const long long p = blockIdx.x / nt;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long base = p * V;
  load_tile<C>(x + base * C, b * kTile, V, xb);
  load_tile<C>(gy + base * C, b * kTile, V, gb);
  if (threadIdx.x < kTile) {
    const int j = b * kTile + threadIdx.x;
    lb[threadIdx.x] = j < V ? lse[base + j] : -INFINITY;
    db[threadIdx.x] = j < V ? delta[base + j] : 0.f;
  }
  float acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  for (int a = 0; a < nt; ++a) {
    if (!bwd_tiles[b * nt + a]) continue;  // the same for the whole block
    __syncthreads();  // the last pair's reads of xa, ga, w1 and w2 are done
    load_tile<C>(x + base * C, a * kTile, V, xa);
    load_tile<C>(gy + base * C, a * kTile, V, ga);
    if (threadIdx.x < kTile) {
      const int i = a * kTile + threadIdx.x, j = b * kTile + threadIdx.x;
      bits_a[threadIdx.x] =
          i < V ? words[static_cast<long long>(i) * nt + b] : 0ull;
      bits_b[threadIdx.x] =
          j < V ? words[static_cast<long long>(j) * nt + a] : 0ull;
      la[threadIdx.x] = i < V ? lse[base + i] : -INFINITY;
      da[threadIdx.x] = i < V ? delta[base + i] : 0.f;
    }
    __syncthreads();
    float t[4][4], g1[4][4], g2[4][4];
    tile_dot3<C>(xb, gb, xa, ga, t, g1, g2);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int jl = ty + 16 * r;
      const u64 jbits = bits_b[jl];
      const float lj = lb[jl], dj = db[jl];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int il = tx + 16 * c;
        const float z = t[r][c] * scale2;
        const bool ij = (bits_a[il] >> jl) & 1ull;  // j in S(i)
        const bool ji = (jbits >> il) & 1ull;       // i in S(j)
        const float a1 = ij ? exp2f(z - la[il]) : 0.f;
        const float a2 = ji ? exp2f(z - lj) : 0.f;
        const float ds = a1 * (g1[r][c] - da[il]) + a2 * (g2[r][c] - dj);
        w1[jl * kWLd + il] = a1;
        w2[jl * kWLd + il] = ds * scale;
      }
    }
    __syncthreads();
    tile_weighted_sum<C>(w1, ga, acc);
    tile_weighted_sum<C>(w2, xa, acc);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = b * kTile + ty + 16 * r;
    if (j >= V) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      gx[(base + j) * C + tx + 16 * c] = acc[r][c];
  }
}

constexpr size_t forward_smem(int C) {
  return (2 * kTile * (C + kPad) + kTile * kWLd) * sizeof(float);
}

constexpr size_t backward_smem(int C) {
  return (4 * kTile * (C + kPad) + 2 * kTile * kWLd) * sizeof(float);
}

// A span's events (null: none) are recorded on the stream right before
// and after the launches, so that they hold the kernels and no host work.
cudaError_t record(cudaEvent_t event, cudaStream_t stream) {
  return event ? cudaEventRecord(event, stream) : cudaSuccess;
}

template <int C>
cudaError_t launch_forward(const float* x, float* y, float* lse,
                           const u64* words, const uint8_t* fwd_tiles, int P,
                           int V, int nt, float scale2, cudaEvent_t start,
                           cudaEvent_t end, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(P) * nt;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      attfuse_forward_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(forward_smem(C)));
  if (err == cudaSuccess) err = record(start, stream);
  if (err != cudaSuccess) return err;
  attfuse_forward_kernel<C>
      <<<static_cast<unsigned>(blocks), kThreads, forward_smem(C), stream>>>(
          x, y, lse, words, fwd_tiles, V, nt, scale2);
  err = cudaGetLastError();
  return err == cudaSuccess ? record(end, stream) : err;
}

template <int C>
cudaError_t launch_backward(const float* x, const float* y, const float* gy,
                            const float* lse, float* delta, float* gx,
                            const u64* words, const uint8_t* bwd_tiles, int P,
                            int V, int nt, float scale2, float scale,
                            cudaEvent_t start, cudaEvent_t end,
                            cudaStream_t stream) {
  const long long blocks = static_cast<long long>(P) * nt;
  const long long rows = static_cast<long long>(P) * V;
  if (blocks > 0x7fffffffLL || (rows + 255) / 256 > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      attfuse_backward_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(backward_smem(C)));
  if (err == cudaSuccess) err = record(start, stream);
  if (err != cudaSuccess) return err;
  attfuse_delta_kernel<C>
      <<<static_cast<unsigned>((rows + 255) / 256), 256, 0, stream>>>(
          y, gy, delta, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attfuse_backward_kernel<C>
      <<<static_cast<unsigned>(blocks), kThreads, backward_smem(C), stream>>>(
          x, gy, lse, delta, gx, words, bwd_tiles, V, nt, scale2, scale);
  err = cudaGetLastError();
  return err == cudaSuccess ? record(end, stream) : err;
}

}  // namespace

// words [V, nt] (u64), fwd_tiles and bwd_tiles [nt, nt] (u8), all zeroed
// by the caller; nt = ceil(V / 64). Returns the CUDA error code (0 on
// success).
extern "C" int attfuse_graph(const int32_t* ell_src, const uint8_t* ell_mask,
                             const uint8_t* node_mask, int V, int deg,
                             u64* words, uint8_t* fwd_tiles,
                             uint8_t* bwd_tiles, int device, void* stream) {
  if (V <= 0 || deg < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (V + kTile - 1) / kTile;
  const long long n = static_cast<long long>(V) * (deg + 1);
  attfuse_graph_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      ell_src, ell_mask, node_mask, V, deg, nt, words, fwd_tiles, bwd_tiles);
  return static_cast<int>(cudaGetLastError());
}

#define ATTFUSE_CHANNELS(X) X(16) X(32) X(64) X(128)

// x, y [P, V, C] f32 (16-byte aligned rows), lse [P, V] f32; C one of 16,
// 32, 64, 128; scale2 = log2(e) / sqrt(C); start and end: a span's CUDA
// events, recorded around the launch (null: none).
extern "C" int attfuse_forward(const float* x, float* y, float* lse,
                               const u64* words, const uint8_t* fwd_tiles,
                               int P, int V, int C, float scale2, void* start,
                               void* end, int device, void* stream) {
  if (P <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (V + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
#define ATTFUSE_FORWARD(c)                                                 \
  case c:                                                                  \
    err = launch_forward<c>(x, y, lse, words, fwd_tiles, P, V, nt, scale2, \
                            static_cast<cudaEvent_t>(start),               \
                            static_cast<cudaEvent_t>(end), s);             \
    break;
    ATTFUSE_CHANNELS(ATTFUSE_FORWARD)
#undef ATTFUSE_FORWARD
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// gx, gy as x; delta [P, V] f32 scratch; scale = 1 / sqrt(C); start and
// end as the forward's, around both launches: delta, then the gradient.
extern "C" int attfuse_backward(const float* x, const float* y,
                                const float* gy, const float* lse,
                                float* delta, float* gx, const u64* words,
                                const uint8_t* bwd_tiles, int P, int V, int C,
                                float scale2, float scale, void* start,
                                void* end, int device, void* stream) {
  if (P <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (V + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
#define ATTFUSE_BACKWARD(c)                                                 \
  case c:                                                                   \
    err = launch_backward<c>(x, y, gy, lse, delta, gx, words, bwd_tiles, P, \
                             V, nt, scale2, scale,                          \
                             static_cast<cudaEvent_t>(start),               \
                             static_cast<cudaEvent_t>(end), s);             \
    break;
    ATTFUSE_CHANNELS(ATTFUSE_BACKWARD)
#undef ATTFUSE_BACKWARD
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
