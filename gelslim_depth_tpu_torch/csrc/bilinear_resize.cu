// The DPT head's bilinear resize with align_corners=True, on channels-last
// maps, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the dense-prediction transformer exists only in
// the port (gelslim_depth_tpu_torch/models/dpt.py). It takes the place of
// aten's upsample_bilinear2d_nhwc at the head's five resizes a call (the
// four FeatureFusionBlocks and the output's resize to the patch grid). That
// kernel gives each output element a thread, which recovers (n, h, w, c) by
// integer divisions, recomputes the source indices and weights, and makes
// four scalar 2-byte loads and one scalar store: on an H100 at the
// flagship's 128 finger images it ran ~11x off the byte bound.
//
// What it computes, for x (N, C, H, W) in bfloat16 or float32, NHWC in
// memory, to out (N, C, Ho, Wo) in x's dtype, NHWC: what
// F.interpolate(x, (Ho, Wo), mode="bilinear", align_corners=True) computes
// on the card (aten/src/ATen/native/cuda/UpSampleBilinear2d.cu and
// UpSample.cuh), in float32 and in its order, so the two agree bit for bit:
//   scale = (in - 1) / (out - 1) in float32, 0 where out == 1 (host side);
//   src = scale * dst; i0 = (int) src; step = i0 < in - 1;
//   l1 = src - i0; l0 = 1 - l1   (each axis, each op rounded);
//   v = h0l * (w0l * x00 + w1l * x01) + h1l * (w0l * x10 + w1l * x11),
//   rounded once to the dtype.
// The compiler contracts aten's value into fused multiply-adds; this source
// writes them out (a product left to the compiler was contracted another
// way once the code around it changed): fma(h0l, top, h1l * bottom), the
// bottom pair fma(w0l, x10, w1l * x11), the top pair fma(w0l, x00, w1l *
// x01), but in aten's channels-last float32 kernel (C >= 16), whose top
// pair is fma(w1l, x01, w0l * x00). Found by building every contraction
// and comparing each with PyTorch 2.11 for CUDA 12.8 on the H100. These are
// artifacts of that library build: after a PyTorch upgrade,
// tests/test_torch_bilinear_resize.py::test_cuda_kernel_equals_aten (on
// the card) says whether they still hold.
//
// Bound on this card: bytes. Each input element read once and each output
// element written once: at the flagship (128 finger images) the five sites
// move 10.22 GB, 3.05 ms at the H100 SXM's 3.35 TB/s, 72% of it the stores.
//
// Design. A thread moves 8 channels of one output pixel: it computes the
// pixel's four source offsets and two weight pairs once for the 8 (no
// division per element), makes four 16-B loads of bf16 (eight of float32)
// and one 16-B streaming store (two). C = 256 is a warp a pixel, C = 128
// half a warp. A block of 128 threads covers 128 consecutive vectors of one
// output row; the blocks of a row, then of the next rows, follow each other,
// so neighbouring output pixels and rows, which read overlapping inputs, run
// together and read them mostly from L1 and L2 (loads through the read-only
// path). The output is stored evict-first. Offsets are 64-bit: the output
// site's output holds 2,119,434,240 elements. One launch a resize, no
// tables. Where C is not a multiple of 8 or a pointer is not 16-B aligned,
// the same threads move their channels one element at a time. A sweep on the
// H100 (PERF.md section 6) chose 128 threads and one vector a thread over
// 256 or 512 threads, two or four vectors a thread, L2-only loads and
// plain stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads a block
constexpr int kVec = 8;        // channels a vector, a thread's

struct Params {
  const void* x;
  void* out;
  int c, h_in, w_in, h_out, w_out;
  int cv;              // vectors a pixel: ceil(C / 8)
  unsigned row_vecs;   // w_out * cv
  unsigned chunks;     // blocks a row
  float scale_h, scale_w;
};

// aten's source index of an output index on one axis, with
// align_corners: src = scale * dst; i0 = (int) src; step 1 where i0 is not
// the last input index; the weights l1 = src - i0 and l0 = 1 - l1.
struct Axis {
  int i0, step;
  float l0, l1;
};

__device__ __forceinline__ Axis source(float scale, int dst, int in) {
  const float src = __fmul_rn(scale, static_cast<float>(dst));
  Axis a;
  a.i0 = static_cast<int>(src);
  a.step = a.i0 < in - 1 ? 1 : 0;
  a.l1 = __fsub_rn(src, static_cast<float>(a.i0));
  a.l0 = __fsub_rn(1.0f, a.l1);
  return a;
}

// aten's value h0 (w0 x00 + w1 x01) + h1 (w0 x10 + w1 x11), with the
// fused multiply-adds its build has (kW1First: w1 x01 is the fused product
// of the top pair); rounded once, by the caller, to the dtype.
template <bool kW1First>
__device__ __forceinline__ float lerp2(const Axis& h, const Axis& w, float x00, float x01, float x10, float x11) {
  const float top = kW1First ? __fmaf_rn(w.l1, x01, __fmul_rn(w.l0, x00)) : __fmaf_rn(w.l0, x00, __fmul_rn(w.l1, x01));
  const float bottom = __fmaf_rn(w.l0, x10, __fmul_rn(w.l1, x11));
  return __fmaf_rn(h.l0, top, __fmul_rn(h.l1, bottom));
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[kVec]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
  }
}

// 8 channels from a 16-B aligned address, through the read-only path.
__device__ __forceinline__ void load8(const __nv_bfloat16* x, long long e, float (&v)[kVec]) {
  unpack8(__ldg(reinterpret_cast<const uint4*>(x + e)), v);
}
__device__ __forceinline__ void load8(const float* x, long long e, float (&v)[kVec]) {
  const float4* p = reinterpret_cast<const float4*>(x + e);
  const float4 a = __ldg(p), b = __ldg(p + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// 8 values rounded to the dtype (nearest, ties to even), to a 16-B aligned
// address, evict-first.
__device__ __forceinline__ void store8(__nv_bfloat16* out, long long e, const float (&v)[kVec]) {
  uint4 u;
  unsigned* w = reinterpret_cast<unsigned*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 r = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const unsigned*>(&r);
  }
  __stcs(reinterpret_cast<uint4*>(out + e), u);
}
__device__ __forceinline__ void store8(float* out, long long e, const float (&v)[kVec]) {
  float4* p = reinterpret_cast<float4*>(out + e);
  __stcs(p, make_float4(v[0], v[1], v[2], v[3]));
  __stcs(p + 1, make_float4(v[4], v[5], v[6], v[7]));
}

__device__ __forceinline__ float load1(const __nv_bfloat16* x, long long e) { return __bfloat162float(x[e]); }
__device__ __forceinline__ float load1(const float* x, long long e) { return x[e]; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, long long e, float v) { out[e] = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store1(float* out, long long e, float v) { out[e] = v; }

// Block b covers vectors [chunk * kThreads, ...) of output row b / chunks
// (row = n * h_out + ho), one a thread. kVecIO: C % 8 == 0 and both
// pointers 16-B aligned, else the channels one at a time (C's last vector
// short). kW1First: aten's channels-last float32 form of the value.
template <typename T, bool kVecIO, bool kW1First>
__global__ void __launch_bounds__(kThreads) bilinear_resize_kernel(Params p) {
  const unsigned row = blockIdx.x / p.chunks, chunk = blockIdx.x - row * p.chunks;
  const unsigned v = chunk * kThreads + threadIdx.x;
  if (v >= p.row_vecs) return;
  const int n = static_cast<int>(row / static_cast<unsigned>(p.h_out));
  const int ho = static_cast<int>(row - static_cast<unsigned>(n) * p.h_out);
  const int wo = static_cast<int>(v / static_cast<unsigned>(p.cv));
  const int c0 = static_cast<int>(v - static_cast<unsigned>(wo) * p.cv) * kVec;
  const Axis h = source(p.scale_h, ho, p.h_in), w = source(p.scale_w, wo, p.w_in);
  const long long c = p.c;
  const long long src = ((static_cast<long long>(n) * p.h_in + h.i0) * p.w_in + w.i0) * c + c0;  // x00
  const long long right = w.step * c, down = static_cast<long long>(h.step) * p.w_in * c;
  const long long dst = (static_cast<long long>(row) * p.w_out + wo) * c + c0;
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  if (kVecIO) {
    float a[kVec], b[kVec], d[kVec], e[kVec], r[kVec];
    load8(x, src, a);
    load8(x, src + right, b);
    load8(x, src + down, d);
    load8(x, src + down + right, e);
#pragma unroll
    for (int k = 0; k < kVec; ++k) r[k] = lerp2<kW1First>(h, w, a[k], b[k], d[k], e[k]);
    store8(out, dst, r);
  } else {
    for (int k = 0; k < kVec && c0 + k < p.c; ++k) {
      const long long i = src + k;
      store1(out, dst + k,
             lerp2<kW1First>(h, w, load1(x, i), load1(x, i + right), load1(x, i + down), load1(x, i + down + right)));
    }
  }
}

template <typename T, bool kW1First>
cudaError_t launch(const Params& p, bool vec_io, unsigned blocks, cudaStream_t s) {
  if (vec_io)
    bilinear_resize_kernel<T, true, kW1First><<<blocks, kThreads, 0, s>>>(p);
  else
    bilinear_resize_kernel<T, false, kW1First><<<blocks, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

bool aligned(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// Launches on `stream`, a stream of CUDA device `device` (made the calling
// thread's current device for the launch, then restored), without
// synchronizing. x: (n, c, h_in, w_in) NHWC in memory, bfloat16 (bf16 = 1)
// or float32; out: (n, c, h_out, w_out) NHWC, x's dtype. Every size at least
// 1, but n and c, which may be 0 (nothing launches). Returns
// cudaGetLastError() after the launch, or the error that kept it from
// launching (0 = success): cudaErrorInvalidValue for sizes out of range, or
// 2^31 vectors of 8 channels a row or 2^31 blocks.
extern "C" int bilinear_resize(const void* x, void* out, int n, int c, int h_in, int w_in, int h_out, int w_out,
                               int bf16, int device, void* stream) {
  if (n < 0 || c < 0 || h_in < 1 || w_in < 1 || h_out < 1 || w_out < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || c == 0) return 0;
  Params p;
  p.x = x;
  p.out = out;
  p.c = c;
  p.h_in = h_in;
  p.w_in = w_in;
  p.h_out = h_out;
  p.w_out = w_out;
  p.cv = (c + kVec - 1) / kVec;
  const long long row_vecs = static_cast<long long>(w_out) * p.cv;
  const long long chunks = (row_vecs + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(n) * h_out * chunks;
  if (row_vecs >= (1LL << 31) || blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  p.row_vecs = static_cast<unsigned>(row_vecs);
  p.chunks = static_cast<unsigned>(chunks);
  // aten's area_pixel_compute_scale with align_corners, in float32
  p.scale_h = h_out > 1 ? static_cast<float>(h_in - 1) / static_cast<float>(h_out - 1) : 0.0f;
  p.scale_w = w_out > 1 ? static_cast<float>(w_in - 1) / static_cast<float>(w_out - 1) : 0.0f;
  const bool vec_io = c % kVec == 0 && aligned(x) && aligned(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned b = static_cast<unsigned>(blocks);
  // aten's float32 kernel for channels-last maps of 16 channels or more
  if (bf16)
    err = launch<__nv_bfloat16, false>(p, vec_io, b, s);
  else
    err = c >= 16 ? launch<float, true>(p, vec_io, b, s) : launch<float, false>(p, vec_io, b, s);
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}
