// A ViT block's LayerScale residual add and the LayerNorm after it, in one
// pass, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no transformer (its models/
// hold the U-Net and its int8 quantization); the dense-prediction
// transformer exists only in the port (gelslim_depth_tpu_torch/models/
// dpt.py). It takes the place of two aten kernels that ran back to back at
// 47 sites of a DINOv2 ViT-L/14 call: addcmul (x + gamma * branch, the
// LayerScale and the residual add) and the vectorized LayerNorm that read
// the sum straight back from device memory (the block's norm2 after ls1,
// the next block's norm1 after ls2).
//
// What it computes, for rows of D elements, x and branch (rows, D), gamma,
// weight and bias (D), all bfloat16 or all float32, contiguous:
//   x_new = x + gamma * branch, as aten's addcmul computes it: in float32,
//     one fused multiply-add, fma(branch, gamma, x), rounded once to the
//     dtype, so the two agree bit for bit (in bfloat16 the product is
//     exact, so any order agrees; in float32 only the fused one does);
//   y = LayerNorm(x_new): the statistics in float32 from the rounded x_new,
//     the mean, then the variance about it (over D), each summed in the
//     lane and then across the warp; y = weight * (rstd * (x_new - mean)) +
//     bias with rstd = rsqrtf(var + eps), one fused multiply-add as aten's
//     kernel has it, rounded once. The sums run in another order than
//     aten's Welford pass, so y may differ from aten's LayerNorm by a
//     rounding.
//
// Bound on this card: bytes. x and branch read once, x_new and y written
// once: at 128 images of 661 tokens of 1024 in bf16, 4 x 173.3 MB = 693 MB,
// 0.207 ms at the H100 SXM's 3.35 TB/s. aten's addcmul and LayerNorm move
// 866 MB (a 0.258 ms bound) and took 0.46 ms alone on the card, ~0.50 ms in
// a serving call.
//
// Design. A streaming pass with no reuse, so the one target is bytes. A
// warp owns a row (1,024 bf16 are 2 KB): lane l holds the row's 8-element
// vectors l, l + 32, ..., one 16-B load each in bf16 (two in float32), and
// every load of x and branch is issued before any arithmetic. The two sums
// run over registers with warp shuffles; nothing is read twice from device
// memory. x_new and y are stored once each with 16-B stores. gamma, weight
// and bias (2 KB each) are read once a warp and come from the caches.
// Blocks of 16 warps, a row each: at D = 1024 in bf16 the kernel fits the
// 128 registers a thread that 512 threads allow, so an SM keeps 16 warps
// and 64 KB of loads in flight. A sweep on the H100 (PERF.md section 6)
// found blocks of 4, 8, 16 or 32 warps, and evict-first loads or stores of
// either output, within 1.5% of each other (0.233-0.240 ms), and a
// grid-stride walk with the parameters held in registers 5-7% slower (198
// registers, 8 warps an SM, a last wave of rows that ran alone). D: a
// multiple of 8, at most kMaxD = 2048 (8 vectors a lane).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;  // warps a block, a row each
constexpr int kVec = 8;     // elements a vector
constexpr int kMaxD = 2048; // 32 lanes x 8 vectors x 8 elements

struct Params {
  const void* x;
  const void* branch;
  const void* gamma;
  const void* weight;
  const void* bias;
  void* x_new;
  void* y;
  long long rows;
  int d;
  float eps;
};

// 8 elements as they lie in memory
template <typename T>
struct Raw;
template <>
struct Raw<__nv_bfloat16> {
  uint4 u;
};
template <>
struct Raw<float> {
  float4 a, b;
};

// 8 elements from a 16-B aligned address, through the read-only path
__device__ __forceinline__ Raw<__nv_bfloat16> load(const __nv_bfloat16* p, int e) {
  return {__ldg(reinterpret_cast<const uint4*>(p + e))};
}
__device__ __forceinline__ Raw<float> load(const float* p, int e) {
  const float4* q = reinterpret_cast<const float4*>(p + e);
  return {__ldg(q), __ldg(q + 1)};
}

__device__ __forceinline__ void unpack(const Raw<__nv_bfloat16>& r, float (&v)[kVec]) {
  const unsigned w[4] = {r.u.x, r.u.y, r.u.z, r.u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void unpack(const Raw<float>& r, float (&v)[kVec]) {
  v[0] = r.a.x, v[1] = r.a.y, v[2] = r.a.z, v[3] = r.a.w, v[4] = r.b.x, v[5] = r.b.y, v[6] = r.b.z, v[7] = r.b.w;
}

// 8 values rounded to the dtype (nearest, ties to even)
template <typename T>
__device__ __forceinline__ Raw<T> pack(const float (&v)[kVec]);
template <>
__device__ __forceinline__ Raw<__nv_bfloat16> pack(const float (&v)[kVec]) {
  Raw<__nv_bfloat16> r;
  unsigned* w = reinterpret_cast<unsigned*>(&r.u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const unsigned*>(&h);
  }
  return r;
}
template <>
__device__ __forceinline__ Raw<float> pack(const float (&v)[kVec]) {
  return {make_float4(v[0], v[1], v[2], v[3]), make_float4(v[4], v[5], v[6], v[7])};
}

// 8 values to a 16-B aligned address
__device__ __forceinline__ void store(__nv_bfloat16* p, int e, const Raw<__nv_bfloat16>& r) {
  *reinterpret_cast<uint4*>(p + e) = r.u;
}
__device__ __forceinline__ void store(float* p, int e, const Raw<float>& r) {
  float4* q = reinterpret_cast<float4*>(p + e);
  q[0] = r.a;
  q[1] = r.b;
}

// the sum over the warp, in every lane
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, m);
  return s;
}

// V: vectors a lane at most (D <= 256 V); lane l's vector i starts at
// element (l + 32 i) * 8, and is held where that is below D. Warp w of
// block b owns row b * kWarps + w.
template <typename T, int V>
__global__ void __launch_bounds__(kWarps * 32) residual_layer_norm_kernel(Params p) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= p.rows) return;
  const int lane = threadIdx.x & 31;
  const long long base = row * p.d;
  const T* x = static_cast<const T*>(p.x);
  const T* branch = static_cast<const T*>(p.branch);
  Raw<T> xr[V], br[V], gamma[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = (lane + 32 * i) * kVec;
    if (c < p.d) {
      xr[i] = load(x + base, c);
      br[i] = load(branch + base, c);
      gamma[i] = load(static_cast<const T*>(p.gamma), c);
    }
  }
  T* x_new = static_cast<T*>(p.x_new);
  float v[V][kVec];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = (lane + 32 * i) * kVec;
    if (c < p.d) {
      float a[kVec], b[kVec], g[kVec], s[kVec];
      unpack(xr[i], a);
      unpack(br[i], b);
      unpack(gamma[i], g);
#pragma unroll
      for (int k = 0; k < kVec; ++k) s[k] = __fmaf_rn(b[k], g[k], a[k]);
      const Raw<T> r = pack<T>(s);
      store(x_new + base, c, r);
      unpack(r, v[i]);
#pragma unroll
      for (int k = 0; k < kVec; ++k) sum = __fadd_rn(sum, v[i][k]);
    }
  }
  const float d = static_cast<float>(p.d);
  const float mean = __fdiv_rn(warp_sum(sum), d);
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if ((lane + 32 * i) * kVec < p.d) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float e = __fsub_rn(v[i][k], mean);
        sq = __fmaf_rn(e, e, sq);
      }
    }
  }
  const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq), d), p.eps));
  T* y = static_cast<T*>(p.y);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = (lane + 32 * i) * kVec;
    if (c < p.d) {
      float w[kVec], b[kVec], o[kVec];
      unpack(load(static_cast<const T*>(p.weight), c), w);
      unpack(load(static_cast<const T*>(p.bias), c), b);
#pragma unroll
      for (int k = 0; k < kVec; ++k) o[k] = __fmaf_rn(w[k], __fmul_rn(rstd, __fsub_rn(v[i][k], mean)), b[k]);
      store(y + base, c, pack<T>(o));
    }
  }
}

template <typename T, int V>
cudaError_t launch(const Params& p, cudaStream_t s) {
  const long long blocks = (p.rows + kWarps - 1) / kWarps;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  residual_layer_norm_kernel<T, V><<<static_cast<unsigned>(blocks), kWarps * 32, 0, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, cudaStream_t s) {
  const int vecs = (p.d / kVec + 31) / 32;  // vectors a lane
  if (vecs <= 1) return launch<T, 1>(p, s);
  if (vecs <= 2) return launch<T, 2>(p, s);
  if (vecs <= 4) return launch<T, 4>(p, s);
  return launch<T, 8>(p, s);
}

bool aligned(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// Launches on `stream`, a stream of CUDA device `device` (made the calling
// thread's current device for the launch, then restored), without
// synchronizing. x, branch, x_new, y: (rows, d) contiguous; gamma, weight,
// bias: (d); all bfloat16 (bf16 = 1) or all float32, every pointer 16-B
// aligned; d a multiple of 8 in [8, 2048]; rows >= 0 (0 launches nothing).
// Returns cudaGetLastError() after the launch, or the error that kept it
// from launching (0 = success): cudaErrorInvalidValue for a d or rows out
// of range or a misaligned pointer.
extern "C" int residual_layer_norm(const void* x, const void* branch, const void* gamma, const void* weight,
                                   const void* bias, void* x_new, void* y, long long rows, int d, float eps, int bf16,
                                   int device, void* stream) {
  if (rows < 0 || d < kVec || d > kMaxD || d % kVec) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[7] = {x, branch, gamma, weight, bias, x_new, y};
  for (const void* ptr : ptrs)
    if (!aligned(ptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const Params p{x, branch, gamma, weight, bias, x_new, y, rows, d, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = bf16 ? launch_d<__nv_bfloat16>(p, s) : launch_d<float>(p, s);
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}
