// Global-norm clipping and AdamW over every parameter leaf of a model, for
// Hopper (sm_90a), with a plain C interface loaded through ctypes
// (mrp_gnn_tpu_torch/ops/adamw.py; called by train.AdamW.step on the card).
//
// Two entry points, one launch each for a table of up to kMaxLeaves leaves:
//
//   adamw_grad_norm: out = || (||g_0||, ..., ||g_{L-1}||) ||, the norm of
//     the per-leaf norms, as the loop of train.AdamW.step computes it;
//   adamw_update:    per element, in f32 and in this order,
//       g  = norm < max_norm ? g : g / norm * max_norm
//       mu = (1 - b1) * g + b1 * mu
//       nu = (1 - b2) * g * g + b2 * nu
//       p += -lr * ((mu * (1 / c1)) / (sqrt(nu * (1 / c2)) + eps) + wd * p)
//     (1 / c1 and 1 / c2 taken in double on the host, rounded to f32)
//     with norm read from device memory (no host sync).
//
// The update gives the bits of the loop it replaces on the card, given the
// same norm: every step is rounded on its own (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn, so nvcc contracts nothing into an FMA), each
// Python float is rounded to f32 as PyTorch rounds a scalar operand, and a
// tensor divided by a Python float is multiplied by the float's reciprocal,
// taken in double and rounded to f32, as PyTorch's CUDA division by a CPU
// scalar does (measured on the card with torch 2.11.0+cu128: these bits,
// not those of an f32 reciprocal or of a division, at each of the first
// 12 updates' bias corrections).
//
// Replaces: no TPU kernel. The JAX package's optimizer (optax's
// clip_by_global_norm and adamw) is fused by XLA inside the jitted step;
// the port's eager loop issued about 21 elementwise launches a leaf and 54
// for the norm, about 1,150 a step over the 52 leaves of dynamic_swarm's
// model, whose host time (17-37 ms a step on the card) set the training
// step's pace.
//
// Bound: bytes. The update reads p, g, mu and nu and writes p, mu and nu,
// 28 bytes a parameter: 19.7 MB, 0.0059 ms at 3.35 TB/s for the 704,711
// parameters of dynamic_swarm; the norm reads g once more (2.8 MB, 0.0008
// ms). About 20 operations a parameter are nothing beside it.
//
// Design: a multi-tensor launch. The leaves' pointers and sizes travel in
// a by-value kernel parameter (Table, under 4 KB); each leaf is cut into
// chunks of kChunk elements, one block a chunk, and a block finds its leaf
// by a binary search of the table's chunk offsets. A leaf whose four
// pointers are 16-byte aligned moves in 16-byte vectors (all of a
// thread's loads issued before its stores), with a scalar tail; any other
// leaf element by element. A convolution's weight gradient may come in
// channels-last order ([N, C, H, W] stored as [N, H, W, C]: cuDNN gives
// the first convolution's so, whose input is the images' NHWC view) while
// its parameter and moments are contiguous; the update then reads each element's gradient
// at its channels-last offset (Table.cl_c, cl_hw), and the norm reads the
// gradient's storage as it lies, since a sum of squares takes any order.
// The norm is deterministic, with no float
// atomics: each block writes its chunk's sum of squares (a fixed tree),
// and the last block to finish (an integer ticket) sums each leaf's
// chunks in chunk order, writes the leaf's norm, and in the last launch of
// the step writes the norm of all the leaves' norms; it then resets the
// ticket for the next launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 2048;      // elements a block takes (adamw.py CHUNK)
constexpr int kMaxLeaves = 64;    // leaves a launch's table holds (adamw.py MAX_LEAVES)
constexpr int kVecs = kChunk / (4 * kThreads);  // 16-byte vectors a thread
static_assert(kChunk % (4 * kThreads) == 0, "a chunk is whole vectors");

// The leaves of one launch: leaf i owns the blocks [chunk0[i], chunk0[i+1]);
// cl_c[i] > 0: leaf i's gradient is channels-last, with cl_c[i] channels
// and cl_hw[i] pixels a channel; 0: contiguous, as the other three.
struct Table {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* mu[kMaxLeaves];
  float* nu[kMaxLeaves];
  long long n[kMaxLeaves];
  int chunk0[kMaxLeaves + 1];
  int cl_c[kMaxLeaves];
  int cl_hw[kMaxLeaves];
  int count;
};
static_assert(sizeof(Table) + 64 <= 4096, "the kernel parameters stay under 4 KB");

// The update's scalars, rounded to f32 as PyTorch rounds the loop's.
struct Hyper {
  float max_norm, omb1, b1, omb2, b2, inv_c1, inv_c2, eps, wd, neg_lr;
};

// The largest i with chunk0[i] <= b: the leaf of block b (empty leaves
// own no block).
__device__ __forceinline__ int find_leaf(const Table& t, int b) {
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.chunk0[mid] <= b) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b,
                                          const void* c, const void* d) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) &
          15) == 0;
}

// The offset in a channels-last gradient of element e (in [N, C, H, W]
// order) of a leaf of C channels of HW pixels (numel under 2^31).
__device__ __forceinline__ int cl_offset(int e, int C, int HW) {
  const int chw = C * HW;
  const int n = e / chw, r = e - n * chw;
  const int c = r / HW, hw = r - c * HW;
  return n * chw + hw * C + c;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One element of the loop of train.AdamW.step, rounded step by step.
__device__ __forceinline__ void adamw_elem(float& p, float g, float& m,
                                           float& v, float nrm, bool scale,
                                           const Hyper& h) {
  if (scale) g = __fmul_rn(__fdiv_rn(g, nrm), h.max_norm);
  m = __fadd_rn(__fmul_rn(g, h.omb1), __fmul_rn(m, h.b1));
  v = __fadd_rn(__fmul_rn(__fmul_rn(g, h.omb2), g), __fmul_rn(v, h.b2));
  const float u = __fdiv_rn(__fmul_rn(m, h.inv_c1),
                            __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.inv_c2)), h.eps));
  p = __fadd_rn(p, __fmul_rn(__fadd_rn(u, __fmul_rn(p, h.wd)), h.neg_lr));
}

__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(const Table t, const float* __restrict__ norm,
                    const Hyper h) {
  const int leaf = find_leaf(t, blockIdx.x);
  const long long start =
      static_cast<long long>(blockIdx.x - t.chunk0[leaf]) * kChunk;
  const long long end = min(start + kChunk, t.n[leaf]);
  float* p = t.p[leaf];
  const float* g = t.g[leaf];
  float* mu = t.mu[leaf];
  float* nu = t.nu[leaf];
  const float nrm = *norm;
  const bool scale = !(nrm < h.max_norm);
  if (t.cl_c[leaf] > 0) {
    const int C = t.cl_c[leaf], HW = t.cl_hw[leaf];
    for (int e = static_cast<int>(start) + threadIdx.x; e < end; e += kThreads)
      adamw_elem(p[e], g[cl_offset(e, C, HW)], mu[e], nu[e], nrm, scale, h);
    return;
  }
  if (!aligned16(p, g, mu, nu)) {
    for (long long e = start + threadIdx.x; e < end; e += kThreads)
      adamw_elem(p[e], g[e], mu[e], nu[e], nrm, scale, h);
    return;
  }
  const long long vend = start + ((end - start) & ~3LL);
  float4 P[kVecs], G[kVecs], M[kVecs], N[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const long long e = start + 4LL * (threadIdx.x + i * kThreads);
    if (e < vend) {
      P[i] = *reinterpret_cast<const float4*>(p + e);
      G[i] = __ldg(reinterpret_cast<const float4*>(g + e));
      M[i] = *reinterpret_cast<const float4*>(mu + e);
      N[i] = *reinterpret_cast<const float4*>(nu + e);
    }
  }
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const long long e = start + 4LL * (threadIdx.x + i * kThreads);
    if (e < vend) {
      adamw_elem(P[i].x, G[i].x, M[i].x, N[i].x, nrm, scale, h);
      adamw_elem(P[i].y, G[i].y, M[i].y, N[i].y, nrm, scale, h);
      adamw_elem(P[i].z, G[i].z, M[i].z, N[i].z, nrm, scale, h);
      adamw_elem(P[i].w, G[i].w, M[i].w, N[i].w, nrm, scale, h);
      *reinterpret_cast<float4*>(p + e) = P[i];
      *reinterpret_cast<float4*>(mu + e) = M[i];
      *reinterpret_cast<float4*>(nu + e) = N[i];
    }
  }
  const long long k = vend + threadIdx.x;  // the last 0-3 elements
  if (k < end) adamw_elem(p[k], g[k], mu[k], nu[k], nrm, scale, h);
}

// One block a chunk; an empty table (every leaf of size 0) launches one
// block, which sums nothing and takes the ticket.
__global__ void __launch_bounds__(kThreads)
grad_norm_kernel(const Table t, float* __restrict__ partials,
                 float* __restrict__ leaf_norms, int leaf_base,
                 int total_leaves, int final_launch, unsigned* ticket,
                 float* __restrict__ out) {
  __shared__ float warp_sums[kWarps];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc = 0.f;
  if (static_cast<int>(blockIdx.x) < t.chunk0[t.count]) {
    const int leaf = find_leaf(t, blockIdx.x);
    const long long start =
        static_cast<long long>(blockIdx.x - t.chunk0[leaf]) * kChunk;
    const long long end = min(start + kChunk, t.n[leaf]);
    const float* g = t.g[leaf];
    if (reinterpret_cast<uintptr_t>(g) % 16 == 0) {
      const long long vend = start + ((end - start) & ~3LL);
      float4 G[kVecs];
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        const long long e = start + 4LL * (threadIdx.x + i * kThreads);
        G[i] = e < vend ? __ldg(reinterpret_cast<const float4*>(g + e))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        acc = fmaf(G[i].x, G[i].x, acc);
        acc = fmaf(G[i].y, G[i].y, acc);
        acc = fmaf(G[i].z, G[i].z, acc);
        acc = fmaf(G[i].w, G[i].w, acc);
      }
      const long long k = vend + threadIdx.x;
      if (k < end) acc = fmaf(g[k], g[k], acc);
    } else {
      for (long long e = start + threadIdx.x; e < end; e += kThreads)
        acc = fmaf(g[e], g[e], acc);
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w];
    partials[blockIdx.x] = s;
    __threadfence();  // the sum is visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // The last block: each leaf's chunks in chunk order, a warp a leaf.
  __threadfence();
  for (int i = warp; i < t.count; i += kWarps) {
    float s = 0.f;
    for (int c = t.chunk0[i] + lane; c < t.chunk0[i + 1]; c += 32)
      s += __ldcg(partials + c);
    s = warp_sum(s);
    if (lane == 0) leaf_norms[leaf_base + i] = __fsqrt_rn(s);
  }
  if (final_launch) {
    __threadfence();
    __syncthreads();
    if (warp == 0) {
      float s = 0.f;
      for (int i = lane; i < total_leaves; i += 32) {
        const float x = __ldcg(leaf_norms + i);
        s = fmaf(x, x, s);
      }
      s = warp_sum(s);
      if (lane == 0) *out = __fsqrt_rn(s);
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;  // the next launch starts from 0
}

// The table of `count` leaves (1..kMaxLeaves) with chunk offsets chunk0
// (count + 1 of them, from 0, ceil(n / kChunk) chunks a leaf) and, unless
// null, cl: (channels, pixels) of each leaf's channels-last gradient, (0,
// 0) for a contiguous one; p, mu, nu and cl may be null for the norm.
cudaError_t fill(Table* t, void* const* p, const void* const* g,
                 void* const* mu, void* const* nu, const long long* n,
                 const int* chunk0, const int* cl, int count) {
  if (count < 1 || count > kMaxLeaves || chunk0[0] != 0)
    return cudaErrorInvalidValue;
  t->count = count;
  for (int i = 0; i < count; ++i) {
    if (n[i] < 0 || chunk0[i + 1] - chunk0[i] != (n[i] + kChunk - 1) / kChunk)
      return cudaErrorInvalidValue;  // a block past a leaf's end would write
                                     // into the leaf's last chunk
    t->p[i] = p ? static_cast<float*>(p[i]) : nullptr;
    t->g[i] = static_cast<const float*>(g[i]);
    t->mu[i] = mu ? static_cast<float*>(mu[i]) : nullptr;
    t->nu[i] = nu ? static_cast<float*>(nu[i]) : nullptr;
    t->n[i] = n[i];
    t->chunk0[i] = chunk0[i];
    t->cl_c[i] = cl ? cl[2 * i] : 0;
    t->cl_hw[i] = cl ? cl[2 * i + 1] : 0;
    if (t->cl_c[i] < 0 || (t->cl_c[i] > 0 &&
        (t->cl_hw[i] <= 0 || n[i] >= (1LL << 31) ||
         n[i] % (static_cast<long long>(t->cl_c[i]) * t->cl_hw[i]) != 0)))
      return cudaErrorInvalidValue;
  }
  t->chunk0[count] = chunk0[count];
  return cudaSuccess;
}

}  // namespace

// The norm over one table of gradient leaves. partials: max(1, chunks)
// floats of scratch; leaf_norms: total_leaves floats, this table's leaves
// at leaf_base; ticket: one unsigned int, 0 at the call and left 0; out:
// one float, written by the launch with final_launch set (the step's last
// table). Returns the CUDA error code of the launch (0 on success).
extern "C" int adamw_grad_norm(const void* const* g, const long long* n,
                               const int* chunk0, int count, int leaf_base,
                               int total_leaves, int final_launch,
                               void* partials, void* leaf_norms, void* ticket,
                               void* out, int device, void* stream) {
  Table t;
  cudaError_t err =
      fill(&t, nullptr, g, nullptr, nullptr, n, chunk0, nullptr, count);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (leaf_base < 0 || leaf_base + count > total_leaves)
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = t.chunk0[count] > 0 ? t.chunk0[count] : 1;
  grad_norm_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<float*>(partials), static_cast<float*>(leaf_norms),
      leaf_base, total_leaves, final_launch, static_cast<unsigned*>(ticket),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The clip and AdamW update of one table of leaves, in place. cl: as
// fill takes it. norm: one float on the device. c1 and c2: the bias
// corrections 1 - b1^t and 1 - b2^t of update t (1-based). A table with
// no element launches nothing. Returns the CUDA error code of the launch
// (0 on success).
extern "C" int adamw_update(void* const* p, const void* const* g,
                            void* const* mu, void* const* nu,
                            const long long* n, const int* chunk0,
                            const int* cl, int count,
                            const void* norm, double max_norm, double lr,
                            double b1, double b2, double eps,
                            double weight_decay, double c1, double c2,
                            int device, void* stream) {
  Table t;
  cudaError_t err = fill(&t, p, g, mu, nu, n, chunk0, cl, count);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (t.chunk0[count] == 0) return 0;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Hyper h;
  h.max_norm = static_cast<float>(max_norm);
  h.omb1 = static_cast<float>(1.0 - b1);
  h.b1 = static_cast<float>(b1);
  h.omb2 = static_cast<float>(1.0 - b2);
  h.b2 = static_cast<float>(b2);
  h.inv_c1 = static_cast<float>(1.0 / c1);
  h.inv_c2 = static_cast<float>(1.0 / c2);
  h.eps = static_cast<float>(eps);
  h.wd = static_cast<float>(weight_decay);
  h.neg_lr = static_cast<float>(-lr);
  adamw_update_kernel<<<t.chunk0[count], kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const float*>(norm), h);
  return static_cast<int>(cudaGetLastError());
}
