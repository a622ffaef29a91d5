// E1 int8_conv_epilogue and E2 int8_avg_pool: the elementwise work around
// the int8 convolutions of the int8-dataflow CLIP ModifiedResNet trunk
// (textreid_torch/models/int8_tower.py).
//
// Replaces: no Pallas kernel.  In textreid_tpu/models/int8_tower.py XLA
// fuses the chain after each int8 convolution into the convolution's output
// (int8_trunk_apply, :402-489: _int8_unit's `* s_w + b`, the residual
// decode, relu and _requant, :166) and runs _avg_pool_int8 (:142) as a
// reduce_window.  E1 and E2 are the port's names for those fusions, so that
// the K numbers stay those of the Pallas functions.
//
// E1's contract (ops/int8_conv.py:conv_epilogue_plain), per element of
// channel n, every operation in the epilogue dtype (f32, or bf16: each
// result rounded to bf16, as eager bf16 tensors round):
//   v = ep(acc) * s_w[n] + b[n]                 (float input: v = ep(x))
//   residual asym: v += (q + 128) * s_res[n];  sym: v += q * s_res[n]
//   relu: v = max(v, 0)
//   sym out:   q = trunc(clip(v * inv[n] +- 0.5, -127, 127))
//   asym out:  q = trunc(clip(v * inv[n], 0, 254) + 0.5) - 128
//   float out: v as f32 or bf16
// The products and sums are spelled __fmul_rn / __fadd_rn so that nvcc
// contracts no a * b + c into an FMA: the kernel equals its plain version
// bit for bit.
//
// E2's contract (ops/int8_conv.py:avg_pool_int8): NHWC int8 [B, H, W, C] ->
// [B, H/2, W/2, C], clip((a + b + c + d + 2) >> 2, -128, 127), an odd last
// row or column dropped.
//
// What bounds them on the H100: bytes.  E1 reads 4 bytes of accumulator (1
// of residual) and writes 1 (or 2 or 4) an element for a few operations;
// E2 reads 4 bytes and writes 1 an output element.  Layer 1's conv3 with its
// identity at batch 128 (393,216 x 256) moves 5 + 1 bytes an element: 0.18 ms
// at 3.35 TB/s.
//
// Design (a first, simple kernel): a thread owns 4 consecutive elements of
// the flat [rows, N] tensor (E2: 4 channels of one output pixel): one
// 16-byte load of the accumulator, a 4-byte load of the residual, the
// per-channel vectors as one float4 each through the read-only cache (4
// reads where N % 4 != 0: the pixel quantize, N = 3), one 4-byte store of
// the int8 result.  A grid-stride loop with 32-bit indices (the wrapper
// checks that they fit).  The epilogue's options are runtime arguments,
// uniform over the launch, so their branches never diverge; the input type
// and the epilogue dtype are template parameters.  The next step (ROADMAP
// Queue B) is to fuse the epilogue into an int8 implicit-GEMM convolution
// on wgmma, so that no s32 map reaches HBM at all.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr int kResAsym = 1;
constexpr int kResSym = 2;
constexpr int kOutSym = 0;
constexpr int kOutAsym = 1;
constexpr int kOutF32 = 2;
constexpr int kOutBf16 = 3;

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool kBf16>
__device__ __forceinline__ float ep(float v) {
  return kBf16 ? to_bf16(v) : v;
}

__device__ __forceinline__ void load4(const int32_t* p, float v[4]) {
  const int4 raw = *reinterpret_cast<const int4*>(p);
  v[0] = __int2float_rn(raw.x);
  v[1] = __int2float_rn(raw.y);
  v[2] = __int2float_rn(raw.z);
  v[3] = __int2float_rn(raw.w);
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 raw = *reinterpret_cast<const float4*>(p);
  v[0] = raw.x;
  v[1] = raw.y;
  v[2] = raw.z;
  v[3] = raw.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  v[0] = __low2float(lo);
  v[1] = __high2float(lo);
  v[2] = __low2float(hi);
  v[3] = __high2float(hi);
}

__device__ __forceinline__ float load1(const int32_t* p) {
  return __int2float_rn(*p);
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// a per-channel vector at the channels of the 4 elements: one float4 when
// the 4 are one aligned run of channels (N % 4 == 0), else 4 reads
__device__ __forceinline__ void chan4(const float* p, const int col[4],
                                      bool run, float v[4]) {
  if (run) {
    const float4 raw = __ldg(reinterpret_cast<const float4*>(p + col[0]));
    v[0] = raw.x;
    v[1] = raw.y;
    v[2] = raw.z;
    v[3] = raw.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __ldg(p + col[j]);
  }
}

template <bool kBf16>
__device__ __forceinline__ uint32_t quantize(float v, float inv, bool asym) {
  float w = ep<kBf16>(__fmul_rn(v, inv));
  int q;
  if (asym) {
    w = fminf(fmaxf(w, 0.0f), 254.0f);
    w = ep<kBf16>(__fadd_rn(w, 0.5f));
    q = static_cast<int>(w) - 128;
  } else {
    w = ep<kBf16>(__fadd_rn(w, w >= 0.0f ? 0.5f : -0.5f));
    w = fminf(fmaxf(w, -127.0f), 127.0f);
    q = static_cast<int>(w);
  }
  return static_cast<uint32_t>(q) & 0xffu;
}

// A thread owns 4 consecutive elements of the flat [rows, N] tensor (the
// last unit may own fewer): N need not be a multiple of 4 (the pixel
// quantize has N = 3), each element's channel is counted on from the
// first's.
template <typename In, bool kBf16>
__global__ void __launch_bounds__(kThreads)
epilogue_kernel(const In* __restrict__ x, const float* __restrict__ s_w,
                const float* __restrict__ b, const int8_t* __restrict__ res,
                const float* __restrict__ s_res, int res_mode, int relu,
                const float* __restrict__ inv, void* __restrict__ out,
                int out_mode, uint32_t total, uint32_t n) {
  const uint32_t units = (total + 3) / 4;
  const bool run = (n & 3u) == 0;
  for (uint32_t i = blockIdx.x * kThreads + threadIdx.x; i < units;
       i += gridDim.x * kThreads) {
    const uint32_t e = i * 4;
    const uint32_t cnt = min(4u, total - e);
    int col[4];
    col[0] = static_cast<int>(e % n);
#pragma unroll
    for (int j = 1; j < 4; ++j)
      col[j] = col[j - 1] + 1 == static_cast<int>(n) ? 0 : col[j - 1] + 1;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f}, t[4];
    if (cnt == 4) {
      load4(x + e, v);
    } else {
      for (uint32_t j = 0; j < cnt; ++j) v[j] = load1(x + e + j);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = ep<kBf16>(v[j]);
    if (s_w != nullptr) {
      float bias[4];
      chan4(s_w, col, run, t);
      chan4(b, col, run, bias);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = ep<kBf16>(__fmul_rn(v[j], ep<kBf16>(t[j])));
        v[j] = ep<kBf16>(__fadd_rn(v[j], ep<kBf16>(bias[j])));
      }
    }
    if (res_mode != 0) {
      float rq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (cnt == 4) {
        const char4 r = *reinterpret_cast<const char4*>(res + e);
        rq[0] = r.x;
        rq[1] = r.y;
        rq[2] = r.z;
        rq[3] = r.w;
      } else {
        for (uint32_t j = 0; j < cnt; ++j) rq[j] = res[e + j];
      }
      chan4(s_res, col, run, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float d = rq[j];
        if (res_mode == kResAsym) d = ep<kBf16>(__fadd_rn(d, 128.0f));
        d = ep<kBf16>(__fmul_rn(d, ep<kBf16>(t[j])));
        v[j] = ep<kBf16>(__fadd_rn(v[j], d));
      }
    }
    if (relu) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = fmaxf(v[j], 0.0f);
    }
    if (out_mode == kOutSym || out_mode == kOutAsym) {
      chan4(inv, col, run, t);
      uint32_t packed = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        packed |= quantize<kBf16>(v[j], ep<kBf16>(t[j]),
                                  out_mode == kOutAsym) << (8 * j);
      int8_t* o = static_cast<int8_t*>(out) + e;
      if (cnt == 4) {
        *reinterpret_cast<uint32_t*>(o) = packed;
      } else {
        for (uint32_t j = 0; j < cnt; ++j)
          o[j] = static_cast<int8_t>((packed >> (8 * j)) & 0xffu);
      }
    } else if (out_mode == kOutF32) {
      float* o = static_cast<float*>(out) + e;
      if (cnt == 4) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        for (uint32_t j = 0; j < cnt; ++j) o[j] = v[j];
      }
    } else {
      __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + e;
      if (cnt == 4) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
        uint2 raw;
        raw.x = *reinterpret_cast<const uint32_t*>(&lo);
        raw.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(o) = raw;
      } else {
        for (uint32_t j = 0; j < cnt; ++j) o[j] = __float2bfloat16_rn(v[j]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
avg_pool_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ y,
                uint32_t units, uint32_t c4, uint32_t wo, uint32_t ho,
                uint32_t w, uint32_t h) {
  for (uint32_t i = blockIdx.x * kThreads + threadIdx.x; i < units;
       i += gridDim.x * kThreads) {
    const uint32_t ch = (i % c4) * 4;
    uint32_t p = i / c4;
    const uint32_t ox = p % wo;
    p /= wo;
    const uint32_t oy = p % ho;
    const uint32_t bb = p / ho;
    const size_t c = static_cast<size_t>(c4) * 4;
    const size_t base = ((static_cast<size_t>(bb) * h + 2 * oy) * w + 2 * ox)
                        * c + ch;
    const char4 a = *reinterpret_cast<const char4*>(x + base);
    const char4 bq = *reinterpret_cast<const char4*>(x + base + c);
    const char4 cq = *reinterpret_cast<const char4*>(x + base + w * c);
    const char4 d = *reinterpret_cast<const char4*>(x + base + w * c + c);
    const int s[4] = {a.x + bq.x + cq.x + d.x, a.y + bq.y + cq.y + d.y,
                      a.z + bq.z + cq.z + d.z, a.w + bq.w + cq.w + d.w};
    uint32_t packed = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = min(max((s[j] + 2) >> 2, -128), 127);
      packed |= (static_cast<uint32_t>(q) & 0xffu) << (8 * j);
    }
    *reinterpret_cast<uint32_t*>(y + static_cast<size_t>(i) * 4) = packed;
  }
}

int grid_for(uint32_t units) {
  const uint32_t blocks = (units + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <typename In>
cudaError_t launch_epilogue(const void* x, const float* s_w, const float* b,
                            const int8_t* res, const float* s_res,
                            int res_mode, int relu, const float* inv,
                            void* out, int out_mode, uint32_t total,
                            uint32_t n, int bf16_ep, cudaStream_t stream) {
  const In* xi = static_cast<const In*>(x);
  const int grid = grid_for((total + 3) / 4);
  if (bf16_ep)
    epilogue_kernel<In, true><<<grid, kThreads, 0, stream>>>(
        xi, s_w, b, res, s_res, res_mode, relu, inv, out, out_mode, total,
        n);
  else
    epilogue_kernel<In, false><<<grid, kThreads, 0, stream>>>(
        xi, s_w, b, res, s_res, res_mode, relu, inv, out, out_mode, total,
        n);
  return cudaGetLastError();
}

}  // namespace

// in_kind: 0 int32 accumulator, 1 f32, 2 bf16; res_mode: 0 none, 1 asym,
// 2 sym; out_mode: 0 sym int8, 1 asym int8, 2 f32, 3 bf16.  rows * n must
// be below 2^31 (the wrapper checks it).
extern "C" int int8_conv_epilogue(const void* x, int in_kind,
                                  const void* s_w, const void* b,
                                  const void* res, const void* s_res,
                                  int res_mode, int relu, const void* inv,
                                  void* out, int out_mode, int rows, int n,
                                  int bf16_ep, void* stream) {
  const uint32_t total = static_cast<uint32_t>(rows) * n;
  const uint32_t un = static_cast<uint32_t>(n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fs_w = static_cast<const float*>(s_w);
  const float* fb = static_cast<const float*>(b);
  const int8_t* r = static_cast<const int8_t*>(res);
  const float* fs_res = static_cast<const float*>(s_res);
  const float* finv = static_cast<const float*>(inv);
  switch (in_kind) {
    case 0:
      return launch_epilogue<int32_t>(x, fs_w, fb, r, fs_res, res_mode, relu,
                                      finv, out, out_mode, total, un, bf16_ep,
                                      st);
    case 1:
      return launch_epilogue<float>(x, fs_w, fb, r, fs_res, res_mode, relu,
                                    finv, out, out_mode, total, un, bf16_ep,
                                    st);
    default:
      return launch_epilogue<__nv_bfloat16>(x, fs_w, fb, r, fs_res, res_mode,
                                            relu, finv, out, out_mode, total,
                                            un, bf16_ep, st);
  }
}

// x [b, h, w, c] int8 -> y [b, h / 2, w / 2, c]; c % 4 == 0.
extern "C" int int8_avg_pool(const void* x, void* y, int b, int h, int w,
                             int c, void* stream) {
  const uint32_t ho = static_cast<uint32_t>(h / 2);
  const uint32_t wo = static_cast<uint32_t>(w / 2);
  const uint32_t c4 = static_cast<uint32_t>(c / 4);
  const uint32_t units = static_cast<uint32_t>(b) * ho * wo * c4;
  avg_pool_kernel<<<grid_for(units), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(y), units, c4, wo,
      ho, static_cast<uint32_t>(w), static_cast<uint32_t>(h));
  return cudaGetLastError();
}
