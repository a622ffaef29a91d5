// E3: train-mode BatchNorm over channels-last activations, with the ReLU and
// the residual add that follow it, forward and backward
// (textreid_torch/ops/batch_norm.py; models/common.py:batch_norm).
//
// Replaces: no Pallas kernel.  flax's BatchNorm, its ReLU and the
// bottleneck's add are XLA fusions on the TPU.  On the card eager PyTorch
// ran native_batch_norm (a statistics pass, a transform pass, memsets),
// seven f32 ops for flax's running update, the ReLU and the add, and in the
// backward threshold_backward and batch_norm_backward_{reduce,elemt}: about
// ten launches and four passes over the activation a BatchNorm.  E3 is the
// port's name for the fusion, so the K numbers stay those of the Pallas
// functions.
//
// The contract (ops/batch_norm.py: stats_plain, apply_plain, reduce_plain,
// elemt_plain),
// on the [rows, C] view of an NHWC tensor, every sum in f32:
//   bn_fw_stats   mean, biased var; invstd = rsqrt(var + eps); a = g invstd,
//                 b = beta - mean a; unless frozen running = (1 - m) running
//                 + m batch (the biased variance, as flax)
//   bn_fw_apply   y = relu(x a + b [+ r]), rounded once to x's dtype
//   bn_bw_reduce  g = dy [pre > 0]; S1 = sum g, S2 = sum g (x - mean):
//                 d beta = S1, d gamma = S2 invstd
//   bn_bw_elemt   dx = a (g - S1 / n - (x - mean) invstd^2 S2 / n); with a
//                 residual and the ReLU, g itself (the identity's gradient)
// The mask: without a residual pre = x a + b is recomputed from x, read
// anyway; with one it is y > 0 (the next convolution holds y already).
// x a + b is spelled __fmul_rn / __fadd_rn, so nvcc contracts no FMA and the
// kernels' masks and outputs equal the plain version's bit for bit given the
// same statistics.
//
// What bounds them on the H100: bytes.  The statistics read x once, the
// apply reads x (and r) and writes y, the reduce reads dy and x (and y),
// the elemt reads the same and writes dx (and g).  RN50's 55 BatchNorms at
// 384 x 128, batch 128, hold 1.749 G elements a tower forward (3.50 GB in
// bf16): the four passes of a train step's BatchNorms, ReLUs and adds move
// 38.5 GB, 11.5 ms at 3.35 TB/s.
//
// Design.  A block of 256 threads covers a slab of rows and a group of up to
// 32 x V channels (8 x V in the passes that write partials): `lanes`
// threads (a power of two) along C, each
// with V channels (8 bf16 or 4 f32 in one 16-byte load: C a multiple of V,
// every address 16-byte aligned, or the launch is refused), and 256 / lanes
// rows at a time, the block's
// rows interleaved with the other slabs' (row r belongs to slab
// (r / rows_a_pass) % slabs).  A thread keeps its channels' constants in
// registers.  The statistics: f32 Welford accumulators a thread, merged in
// the block by Chan's rule in a fixed tree; each block's partial (count,
// mean, M2) goes to a per-device workspace; the last block of a channel
// group, told by a ticket counter that it resets (the workspace is zeroed
// once, so no memset launch), merges the slabs' partials in a fixed order,
// writes mean, invstd, a and b, and moves the running statistics.  The
// backward reduce sums the same way.  No float atomics: a launch's result
// depends on its shapes and the card alone, so a replayed forward
// (the gradient-cache step, TPU.REMAT) is bit for bit the first.  Each grid
// is one wave (the kernel's occupancy x the SM count), so no launch ends on
// a part-empty wave; the elementwise passes take two rows a trip, their
// loads issued before any store.  A workspace serves one stream at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;
// lanes along C: up to 32 (a warp on one row's 512 bytes) in the
// elementwise passes; up to 8 in the passes that write partials, so a group
// is at most 64 channels and its last block merges few bytes
constexpr int kLanesMax = 32;
constexpr int kPartialLanes = 8;
// launches that write partials: at most this many blocks (slabs x groups
// where groups allow it) and slabs, so the workspace has a fixed size and a
// group's merge reads at most 256 x 64 x 8 bytes
constexpr int kMaxPartialBlocks = 1024;
constexpr int kMaxSlabs = 256;
constexpr int kMaxGroups = 8192;
// a quantity's partials: slabs x C floats; slabs x groups <= 1024 blocks of
// at most 8 x 8 channels, or one slab of C <= 65,536 (ops/batch_norm.py)
constexpr int kPartialFloats = kMaxPartialBlocks * kPartialLanes * 8;
// tickets (int) | counts (float) | partial A | partial B
constexpr int kWorkspaceWords = kMaxGroups + kMaxGroups + 2 * kPartialFloats;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// V channels of one row to and from f32 registers: one 16-byte access
template <typename T, int V>
struct Io;

template <>
struct Io<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load_raw(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void unpack(const Raw& q, float v[4]) {
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  static __device__ __forceinline__ void load(const float* p, float v[4]) {
    unpack(load_raw(p), v);
  }
  static __device__ __forceinline__ void store(float* p, const float v[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Io<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load_raw(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ void unpack(const Raw& q, float v[8]) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float v[8]) {
    unpack(load_raw(p), v);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float v[8]) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = bf16_bits(v[2 * k]) | (bf16_bits(v[2 * k + 1]) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// a thread's place: `lanes` threads along C, kThreads / lanes rows a pass
struct Place {
  int lane, rl, rpb, c0;
  bool active;
};

template <int V>
__device__ __forceinline__ Place place(int C, int lanes) {
  Place p;
  p.lane = threadIdx.x & (lanes - 1);
  p.rl = threadIdx.x / lanes;
  p.rpb = kThreads / lanes;
  p.c0 = (blockIdx.y * lanes + p.lane) * V;
  p.active = p.c0 < C;
  return p;
}

__device__ __forceinline__ float affine(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

// relu that keeps a NaN (as torch.relu does)
__device__ __forceinline__ float relu_f(float v) { return v < 0.0f ? 0.0f : v; }

template <int V>
__device__ __forceinline__ void welford(float& n, float mean[V], float m2[V],
                                        const float v[V]) {
  n += 1.0f;
  const float inv = __frcp_rn(n);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float d = v[j] - mean[j];
    mean[j] = fmaf(d, inv, mean[j]);
    m2[j] = fmaf(d, v[j] - mean[j], m2[j]);
  }
}

// Chan et al.'s merge of (nb, mb, m2b) into (n, mean, m2)
template <int V>
__device__ __forceinline__ void chan(float& n, float mean[V], float m2[V],
                                     float nb, const float mb[V],
                                     const float m2b[V]) {
  if (nb == 0.0f) return;
  const float total = n + nb;
  const float wb = nb / total;
  const float cross = n * wb;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float d = mb[j] - mean[j];
    mean[j] = fmaf(d, wb, mean[j]);
    m2[j] = m2[j] + m2b[j] + d * d * cross;
  }
  n = total;
}

// Merge the block's row lanes into row lane 0 in a fixed tree (every thread
// of the block calls it).  Shared layout [j][thread], conflict-free.
template <int V>
__device__ void merge_rows(float& n, float mean[V], float m2[V],
                           const Place& p, int lanes, float* sh_n,
                           float* sh_a, float* sh_b) {
  const int t = threadIdx.x;
  __syncthreads();
  sh_n[t] = n;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sh_a[j * kThreads + t] = mean[j];
    sh_b[j * kThreads + t] = m2[j];
  }
  __syncthreads();
  for (int s = p.rpb / 2; s >= 1; s >>= 1) {
    if (p.rl < s) {
      const int o = t + s * lanes;
      float mb[V], m2b[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        mb[j] = sh_a[j * kThreads + o];
        m2b[j] = sh_b[j * kThreads + o];
      }
      chan<V>(n, mean, m2, sh_n[o], mb, m2b);
      sh_n[t] = n;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        sh_a[j * kThreads + t] = mean[j];
        sh_b[j * kThreads + t] = m2[j];
      }
    }
    __syncthreads();
  }
}

// The same tree for plain sums
template <int V>
__device__ void sum_rows(float s1[V], float s2[V], const Place& p, int lanes,
                         float* sh_a, float* sh_b) {
  const int t = threadIdx.x;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sh_a[j * kThreads + t] = s1[j];
    sh_b[j * kThreads + t] = s2[j];
  }
  __syncthreads();
  for (int s = p.rpb / 2; s >= 1; s >>= 1) {
    if (p.rl < s) {
      const int o = t + s * lanes;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s1[j] += sh_a[j * kThreads + o];
        s2[j] += sh_b[j * kThreads + o];
        sh_a[j * kThreads + t] = s1[j];
        sh_b[j * kThreads + t] = s2[j];
      }
    }
    __syncthreads();
  }
}

// After the block's partial is written: whether this block is its channel
// group's last (then every other slab's partial is visible to it)
__device__ __forceinline__ bool last_of_group(int* tickets, int* sh_last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *sh_last = atomicAdd(tickets + blockIdx.y, 1) == static_cast<int>(
        gridDim.x) - 1;
  __syncthreads();
  const bool last = *sh_last != 0;
  if (last) __threadfence();
  return last;
}

struct Work {
  int* tickets;
  float* counts;
  float* part_a;
  float* part_b;
};

__host__ __device__ inline Work split_work(void* base) {
  Work w;
  w.tickets = static_cast<int*>(base);
  w.counts = reinterpret_cast<float*>(w.tickets + kMaxGroups);
  w.part_a = w.counts + kMaxGroups;
  w.part_b = w.part_a + kPartialFloats;
  return w;
}

// rows r, r + stride, .. r + 3 stride that exist, raw; how many
template <typename T, int V>
__device__ __forceinline__ int load_rows(const T* base, long long r,
                                         long long stride, int rows, int C,
                                         typename Io<T, V>::Raw out[4]) {
  int n = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (r + u * stride < rows) {
      out[u] = Io<T, V>::load_raw(base + (r + u * stride) * C);
      ++n;
    }
  }
  return n;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_fw_stats_kernel(const T* __restrict__ x, int rows, int C, int lanes,
                   const float* __restrict__ weight,
                   const float* __restrict__ bias, float* running_mean,
                   float* running_var, float momentum, float eps, int update,
                   float* __restrict__ stats, Work work) {
  __shared__ float sh_n[kThreads];
  __shared__ float sh_a[kThreads * V];
  __shared__ float sh_b[kThreads * V];
  __shared__ int sh_last;
  const Place p = place<V>(C, lanes);
  float n = 0.0f, mean[V], m2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) mean[j] = m2[j] = 0.0f;
  if (p.active) {
    // up to four rows a trip, the next trip's loaded (raw) before this
    // trip's Welford chain, so the loads never wait on it; the last trip
    // takes what is left, so no row waits alone for its load
    using Raw = typename Io<T, V>::Raw;
    const long long stride = static_cast<long long>(gridDim.x) * p.rpb;
    long long r = static_cast<long long>(blockIdx.x) * p.rpb + p.rl;
    const T* base = x + p.c0;
    Raw cur[4];
    int have = load_rows<T, V>(base, r, stride, rows, C, cur);
    while (have > 0) {
      r += 4 * stride;
      Raw nxt[4];
      const int next = load_rows<T, V>(base, r, stride, rows, C, nxt);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (u < have) {
          float v[V];
          Io<T, V>::unpack(cur[u], v);
          welford<V>(n, mean, m2, v);
        }
      }
      have = next;
#pragma unroll
      for (int u = 0; u < 4; ++u) cur[u] = nxt[u];
    }
  }
  merge_rows<V>(n, mean, m2, p, lanes, sh_n, sh_a, sh_b);
  const int slabs = gridDim.x;
  if (p.rl == 0 && p.active) {
    const long long at = static_cast<long long>(blockIdx.x) * C + p.c0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      work.part_a[at + j] = mean[j];
      work.part_b[at + j] = m2[j];
    }
    if (p.lane == 0) work.counts[blockIdx.y * slabs + blockIdx.x] = n;
  }
  if (!last_of_group(work.tickets, &sh_last)) return;

  n = 0.0f;
#pragma unroll
  for (int j = 0; j < V; ++j) mean[j] = m2[j] = 0.0f;
  if (p.active) {
    for (int s = p.rl; s < slabs; s += p.rpb) {
      const long long at = static_cast<long long>(s) * C + p.c0;
      float mb[V], m2b[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        mb[j] = __ldcg(work.part_a + at + j);
        m2b[j] = __ldcg(work.part_b + at + j);
      }
      chan<V>(n, mean, m2, __ldcg(work.counts + blockIdx.y * slabs + s), mb,
              m2b);
    }
  }
  merge_rows<V>(n, mean, m2, p, lanes, sh_n, sh_a, sh_b);
  if (p.rl == 0 && p.active) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = p.c0 + j;
      const float var = m2[j] / n;
      const float invstd = rsqrtf(var + eps);
      const float a = weight[c] * invstd;
      stats[c] = mean[j];
      stats[C + c] = invstd;
      stats[2 * C + c] = a;
      stats[3 * C + c] = bias[c] - mean[j] * a;
      if (update) {
        running_mean[c] = __fadd_rn(__fmul_rn(running_mean[c], 1.0f - momentum),
                                    __fmul_rn(momentum, mean[j]));
        running_var[c] = __fadd_rn(__fmul_rn(running_var[c], 1.0f - momentum),
                                   __fmul_rn(momentum, var));
      }
    }
  }
  if (threadIdx.x == 0) work.tickets[blockIdx.y] = 0;
}

template <int V>
__device__ __forceinline__ void channel_row(const float* __restrict__ row,
                                            int c0, float v[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = __ldg(row + c0 + j);
}

// U rows of V channels, `step` elements apart: every load issued before
// the first store
template <typename T, int V, int U>
__device__ __forceinline__ void apply_rows(const T* x, const T* res, T* y,
                                           long long step, const float a[V],
                                           const float b[V], int relu) {
  float v[U][V], q[U][V];
#pragma unroll
  for (int u = 0; u < U; ++u) Io<T, V>::load(x + u * step, v[u]);
  if (res != nullptr) {
#pragma unroll
    for (int u = 0; u < U; ++u) Io<T, V>::load(res + u * step, q[u]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float w = affine(v[u][j], a[j], b[j]);
      if (res != nullptr) w = __fadd_rn(w, q[u][j]);
      v[u][j] = relu ? relu_f(w) : w;
    }
    Io<T, V>::store(y + u * step, v[u]);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_fw_apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
                   T* __restrict__ y, int rows, int C, int lanes,
                   const float* __restrict__ stats, int relu) {
  const Place p = place<V>(C, lanes);
  if (!p.active) return;
  float a[V], b[V];
  channel_row<V>(stats + 2 * C, p.c0, a);
  channel_row<V>(stats + 3 * C, p.c0, b);
  const long long stride = static_cast<long long>(gridDim.x) * p.rpb;
  const long long step = stride * C;
  long long r = static_cast<long long>(blockIdx.x) * p.rpb + p.rl;
  for (; r + stride < rows; r += 2 * stride) {
    const long long at = r * C + p.c0;
    apply_rows<T, V, 2>(x + at, res == nullptr ? nullptr : res + at, y + at,
                        step, a, b, relu);
  }
  if (r < rows) {
    const long long at = r * C + p.c0;
    apply_rows<T, V, 1>(x + at, res == nullptr ? nullptr : res + at, y + at,
                        step, a, b, relu);
  }
}

// U rows of g = dy, masked where relu: by y > 0 when y is given, else by
// x a + b > 0; and x.  Every load issued first.
template <typename T, int V, int U>
__device__ __forceinline__ void masked_grad(const T* dy, const T* x,
                                            const T* y, long long step,
                                            const float a[V],
                                            const float b[V], int relu,
                                            float g[U][V], float xv[U][V]) {
  float yv[U][V];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    Io<T, V>::load(dy + u * step, g[u]);
    Io<T, V>::load(x + u * step, xv[u]);
  }
  if (!relu) return;
  if (y != nullptr) {
#pragma unroll
    for (int u = 0; u < U; ++u) Io<T, V>::load(y + u * step, yv[u]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float pre =
          y != nullptr ? yv[u][j] : affine(xv[u][j], a[j], b[j]);
      g[u][j] = pre > 0.0f ? g[u][j] : 0.0f;
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_bw_reduce_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                    const T* __restrict__ y, int rows, int C, int lanes,
                    const float* __restrict__ stats, int relu,
                    float* __restrict__ grads, Work work) {
  __shared__ float sh_a[kThreads * V];
  __shared__ float sh_b[kThreads * V];
  __shared__ int sh_last;
  const Place p = place<V>(C, lanes);
  float s1[V], s2[V], mean[V], a[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s1[j] = s2[j] = mean[j] = a[j] = b[j] = 0.0f;
  if (p.active) {
    channel_row<V>(stats, p.c0, mean);
    channel_row<V>(stats + 2 * C, p.c0, a);
    channel_row<V>(stats + 3 * C, p.c0, b);
    const long long stride = static_cast<long long>(gridDim.x) * p.rpb;
    const long long step = stride * C;
    long long r = static_cast<long long>(blockIdx.x) * p.rpb + p.rl;
    for (; r + stride < rows; r += 2 * stride) {
      const long long at = r * C + p.c0;
      float g[2][V], xv[2][V];
      masked_grad<T, V, 2>(dy + at, x + at, y == nullptr ? nullptr : y + at,
                           step, a, b, relu, g, xv);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          s1[j] += g[u][j];
          s2[j] = fmaf(g[u][j], xv[u][j] - mean[j], s2[j]);
        }
      }
    }
    if (r < rows) {
      const long long at = r * C + p.c0;
      float g[1][V], xv[1][V];
      masked_grad<T, V, 1>(dy + at, x + at, y == nullptr ? nullptr : y + at,
                           step, a, b, relu, g, xv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s1[j] += g[0][j];
        s2[j] = fmaf(g[0][j], xv[0][j] - mean[j], s2[j]);
      }
    }
  }
  sum_rows<V>(s1, s2, p, lanes, sh_a, sh_b);
  const int slabs = gridDim.x;
  if (p.rl == 0 && p.active) {
    const long long at = static_cast<long long>(blockIdx.x) * C + p.c0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      work.part_a[at + j] = s1[j];
      work.part_b[at + j] = s2[j];
    }
  }
  if (!last_of_group(work.tickets, &sh_last)) return;

#pragma unroll
  for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.0f;
  if (p.active) {
    for (int s = p.rl; s < slabs; s += p.rpb) {
      const long long at = static_cast<long long>(s) * C + p.c0;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s1[j] += __ldcg(work.part_a + at + j);
        s2[j] += __ldcg(work.part_b + at + j);
      }
    }
  }
  sum_rows<V>(s1, s2, p, lanes, sh_a, sh_b);
  if (p.rl == 0 && p.active) {
    const float inv_n = 1.0f / static_cast<float>(rows);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = p.c0 + j;
      const float invstd = stats[C + c];
      grads[c] = s2[j] * invstd;
      grads[C + c] = s1[j];
      grads[2 * C + c] = s1[j] * inv_n;
      grads[3 * C + c] = invstd * invstd * s2[j] * inv_n;
    }
  }
  if (threadIdx.x == 0) work.tickets[blockIdx.y] = 0;
}

template <typename T, int V, int U>
__device__ __forceinline__ void elemt_rows(
    const T* dy, const T* x, const T* y, T* dx, T* dres, long long at,
    long long step, const float mean[V], const float a[V], const float b[V],
    const float k1[V], const float k2[V], int relu) {
  float g[U][V], xv[U][V];
  masked_grad<T, V, U>(dy + at, x + at, y == nullptr ? nullptr : y + at, step,
                       a, b, relu, g, xv);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (dres != nullptr) Io<T, V>::store(dres + at + u * step, g[u]);
    if (dx != nullptr) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        xv[u][j] = a[j] * (g[u][j] - k1[j] - (xv[u][j] - mean[j]) * k2[j]);
      Io<T, V>::store(dx + at + u * step, xv[u]);
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_bw_elemt_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                   const T* __restrict__ y, T* __restrict__ dx,
                   T* __restrict__ dres, int rows, int C, int lanes,
                   const float* __restrict__ stats,
                   const float* __restrict__ grads, int relu) {
  const Place p = place<V>(C, lanes);
  if (!p.active) return;
  float mean[V], a[V], b[V], k1[V], k2[V];
  channel_row<V>(stats, p.c0, mean);
  channel_row<V>(stats + 2 * C, p.c0, a);
  channel_row<V>(stats + 3 * C, p.c0, b);
  channel_row<V>(grads + 2 * C, p.c0, k1);
  channel_row<V>(grads + 3 * C, p.c0, k2);
  const long long stride = static_cast<long long>(gridDim.x) * p.rpb;
  const long long step = stride * C;
  long long r = static_cast<long long>(blockIdx.x) * p.rpb + p.rl;
  for (; r + stride < rows; r += 2 * stride)
    elemt_rows<T, V, 2>(dy, x, y, dx, dres, r * C + p.c0, step, mean, a, b,
                        k1, k2, relu);
  if (r < rows)
    elemt_rows<T, V, 1>(dy, x, y, dx, dres, r * C + p.c0, step, mean, a, b,
                        k1, k2, relu);
}

// Blocks of one full wave of `kernel` on the current device (its occupancy
// at kThreads x the SM count), read once a device into `cache`
template <typename Kernel>
int wave_blocks(Kernel kernel, int* cache) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && cache[dev] != 0) return cache[dev];
  int per_sm = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  if (dev < 64) cache[dev] = blocks;
  return blocks;
}

struct Grid {
  int lanes;
  dim3 grid;
};

// lanes: the power of two >= C / V up to 32; a channel group a grid row;
// slabs to fill `blocks` blocks (one wave), none without a pass of rows.
// The grid depends on the shape and the card alone.
Grid grid_for(int rows, int C, int vec, int blocks, int lanes_max) {
  Grid g;
  const int cv = C / vec;
  g.lanes = 1;
  while (g.lanes < cv && g.lanes < lanes_max) g.lanes *= 2;
  const int rpb = kThreads / g.lanes;
  const int groups = (cv + g.lanes - 1) / g.lanes;
  const int passes = (rows + rpb - 1) / rpb;
  int slabs = blocks / groups;
  if (slabs > passes) slabs = passes;
  if (slabs < 1) slabs = 1;
  g.grid = dim3(slabs, groups);
  return g;
}

// the partial-writing launches: one wave, at most kMaxPartialBlocks blocks
// and kMaxSlabs slabs
template <typename Kernel>
Grid partial_grid(Kernel kernel, int* cache, int rows, int C, int vec) {
  const int blocks = wave_blocks(kernel, cache);
  Grid g = grid_for(rows, C, vec,
                    blocks < kMaxPartialBlocks ? blocks : kMaxPartialBlocks,
                    kPartialLanes);
  if (g.grid.x > static_cast<unsigned>(kMaxSlabs)) g.grid.x = kMaxSlabs;
  return g;
}

// C a multiple of V (8 bf16, 4 f32), every tensor 16-byte aligned
bool args_ok(int rows, int C, int is_bf16,
             std::initializer_list<const void*> tensors) {
  if (rows < 1 || C < 1 || C > 65536 || C % (is_bf16 ? 8 : 4) != 0)
    return false;
  for (const void* t : tensors)
    if (reinterpret_cast<uintptr_t>(t) % 16 != 0) return false;
  return true;
}

bool fits_workspace(const Grid& g, int C) {
  return static_cast<int>(g.grid.y) <= kMaxGroups &&
         static_cast<long long>(g.grid.x) * C <= kPartialFloats &&
         static_cast<long long>(g.grid.x) * g.grid.y <= kMaxGroups;
}

template <typename T, int V>
cudaError_t launch_stats(const void* x, int rows, int C, const float* weight,
                         const float* bias, float* running_mean,
                         float* running_var, float momentum, float eps,
                         int update, float* stats, void* work,
                         cudaStream_t stream) {
  static int cache[64];
  const Grid g = partial_grid(bn_fw_stats_kernel<T, V>, cache, rows, C, V);
  if (!fits_workspace(g, C)) return cudaErrorInvalidValue;
  bn_fw_stats_kernel<T, V><<<g.grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), rows, C, g.lanes, weight, bias, running_mean,
      running_var, momentum, eps, update, stats, split_work(work));
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_apply(const void* x, const void* residual, void* y,
                         int rows, int C, const float* stats, int relu,
                         cudaStream_t stream) {
  static int cache[64];
  const Grid g = grid_for(rows, C, V,
                          wave_blocks(bn_fw_apply_kernel<T, V>, cache),
                          kLanesMax);
  bn_fw_apply_kernel<T, V><<<g.grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(residual),
      static_cast<T*>(y), rows, C, g.lanes, stats, relu);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_reduce(const void* dy, const void* x, const void* y,
                          int rows, int C, const float* stats, int relu,
                          float* grads, void* work, cudaStream_t stream) {
  static int cache[64];
  const Grid g = partial_grid(bn_bw_reduce_kernel<T, V>, cache, rows, C, V);
  if (!fits_workspace(g, C)) return cudaErrorInvalidValue;
  bn_bw_reduce_kernel<T, V><<<g.grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x),
      static_cast<const T*>(y), rows, C, g.lanes, stats, relu, grads,
      split_work(work));
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_elemt(const void* dy, const void* x, const void* y,
                         void* dx, void* dres, int rows, int C,
                         const float* stats, const float* grads, int relu,
                         cudaStream_t stream) {
  static int cache[64];
  const Grid g = grid_for(rows, C, V,
                          wave_blocks(bn_bw_elemt_kernel<T, V>, cache),
                          kLanesMax);
  bn_bw_elemt_kernel<T, V><<<g.grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x),
      static_cast<const T*>(y), static_cast<T*>(dx), static_cast<T*>(dres),
      rows, C, g.lanes, stats, grads, relu);
  return cudaGetLastError();
}

}  // namespace

// the instantiation for is_bf16: 8 bf16 or 4 f32 channels an access
#define TEXTREID_BN_DISPATCH(launch, ...)                 \
  (is_bf16 ? launch<__nv_bfloat16, 8>(__VA_ARGS__)        \
           : launch<float, 4>(__VA_ARGS__))

extern "C" {

// words (4 bytes) of the per-device workspace, to be zeroed once
int bn_workspace_words() { return kWorkspaceWords; }

int bn_fw_stats(const void* x, int is_bf16, int rows, int C,
                const float* weight, const float* bias, float* running_mean,
                float* running_var, float momentum, float eps, int update,
                float* stats, void* work, cudaStream_t stream) {
  if (!args_ok(rows, C, is_bf16, {x})) return cudaErrorInvalidValue;
  return TEXTREID_BN_DISPATCH(launch_stats, x, rows, C, weight, bias,
                              running_mean, running_var, momentum, eps,
                              update, stats, work, stream);
}

int bn_fw_apply(const void* x, const void* residual, void* y, int is_bf16,
                int rows, int C, const float* stats, int relu,
                cudaStream_t stream) {
  if (!args_ok(rows, C, is_bf16, {x, residual, y}))
    return cudaErrorInvalidValue;
  return TEXTREID_BN_DISPATCH(launch_apply, x, residual, y, rows, C, stats,
                              relu, stream);
}

int bn_bw_reduce(const void* dy, const void* x, const void* y, int is_bf16,
                 int rows, int C, const float* stats, int relu, float* grads,
                 void* work, cudaStream_t stream) {
  if (!args_ok(rows, C, is_bf16, {dy, x, y})) return cudaErrorInvalidValue;
  return TEXTREID_BN_DISPATCH(launch_reduce, dy, x, y, rows, C, stats, relu,
                              grads, work, stream);
}

int bn_bw_elemt(const void* dy, const void* x, const void* y, void* dx,
                void* dres, int is_bf16, int rows, int C, const float* stats,
                const float* grads, int relu, cudaStream_t stream) {
  if (!args_ok(rows, C, is_bf16, {dy, x, y, dx, dres}))
    return cudaErrorInvalidValue;
  return TEXTREID_BN_DISPATCH(launch_elemt, dy, x, y, dx, dres, rows, C,
                              stats, grads, relu, stream);
}

}  // extern "C"
