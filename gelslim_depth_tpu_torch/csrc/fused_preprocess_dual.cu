// Fused dual-finger preprocess for Hopper (sm_90a): difference image, area
// resize and per-channel normalize in one pass over the raw frames.
//
// Replaces the Pallas TPU kernel
//   gelslim_depth_tpu/ops/pallas/preprocess_kernel.py:_kernel
//   (launched by _fused_preprocess_dual, public wrapper fused_preprocess_dual).
//
// What it computes, for frames (N, 6, H, W), base (6, H, W) -> out (2N, 3, h, w):
//   d = (x - base[c] + 255) / 2                 (or d = x when use_diff == 0)
//   y = A_h . d . A_w^T                         (adaptive-average area resize)
//   out[(c / 3) * N + n, c % 3] = y * mult[c % 3] + add[c % 3]
// Left-finger samples land in rows [0, N), right-finger ones in [N, 2N).
//
// Bound on this card: bytes. The least traffic is each input read once and
// each output written once, 4 * (N*6*H*W + 6*H*W + 2N*3*h*w) bytes; at the
// flagship N=64, 320x427 -> 160x213 that is 265,505,280 B, 79 us at the
// H100 SXM's 3.35 TB/s.
//
// Why a windowed design and not the TPU's two dense products: on the TPU the
// two contractions ride the MXU for free. Here a float32 product may not use
// TF32 (the resize is parity-critical), so a dense design would run
// 2*6*(160*320*427 + 160*427*213) ~ 437 MFLOP per dual frame on the CUDA
// cores, ~6.5 us a frame at 67 TFLOP/s against ~1.2 us of memory traffic.
// A_h and A_w are banded (windows of 2 rows and 2-3 columns at the flagship
// shape), so each output pixel is computed directly as its window average:
// window bounds start = i*n_in/n_out, end = ceil((i+1)*n_in/n_out) in
// integer arithmetic, each term weighted by float32(1/(end-start)) per axis,
// exactly the entries of the weight matrices. Everything between the raw
// frame and the result stays in registers and shared memory.
//
// Layout: one block per (n, c, output row). The block sums the row's input
// window vertically into shared memory (coalesced along W), then each thread
// produces output columns from their 2-3 column window.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int window_start(int i, int n_in, int n_out) {
  return (int)(((long long)i * n_in) / n_out);
}

__device__ __forceinline__ int window_end(int i, int n_in, int n_out) {
  return (int)(((long long)(i + 1) * n_in + n_out - 1) / n_out);
}

// float32(1/k) rounded from double, as the reference builds its weights
__device__ __forceinline__ float window_weight(int k) {
  return (float)(1.0 / (double)k);
}

__global__ void fused_preprocess_dual_kernel(
    const float* __restrict__ frames, const float* __restrict__ base,
    float* __restrict__ out, int n, int h_in, int w_in, int h_out, int w_out,
    int use_diff, float m0, float m1, float m2, float a0, float a1, float a2) {
  extern __shared__ float col_sum[];  // w_in floats: the row window's vertical sum

  const int o = blockIdx.x % h_out;
  const int nc = blockIdx.x / h_out;
  const int c = nc % 6;
  const int i = nc / 6;

  const int r0 = window_start(o, h_in, h_out);
  const int r1 = window_end(o, h_in, h_out);
  const float wh = window_weight(r1 - r0);
  const size_t plane = (size_t)h_in * w_in;
  const float* x = frames + ((size_t)i * 6 + c) * plane;
  const float* b = base + (size_t)c * plane;

  for (int col = threadIdx.x; col < w_in; col += blockDim.x) {
    float t = 0.0f;
    for (int r = r0; r < r1; ++r) {
      const size_t off = (size_t)r * w_in + col;
      const float d = use_diff ? (x[off] - b[off] + 255.0f) * 0.5f : x[off];
      t += wh * d;
    }
    col_sum[col] = t;
  }
  __syncthreads();

  const int ch = c % 3;
  const float mult = ch == 0 ? m0 : (ch == 1 ? m1 : m2);
  const float add = ch == 0 ? a0 : (ch == 1 ? a1 : a2);
  float* y = out + ((((size_t)(c / 3) * n + i) * 3 + ch) * h_out + o) * w_out;
  for (int p = threadIdx.x; p < w_out; p += blockDim.x) {
    const int c0 = window_start(p, w_in, w_out);
    const int c1 = window_end(p, w_in, w_out);
    const float ww = window_weight(c1 - c0);
    float s = 0.0f;
    for (int col = c0; col < c1; ++col) s += ww * col_sum[col];
    y[p] = s * mult + add;
  }
}

}  // namespace

// Launches on `stream` without synchronizing. `base` may be null when
// use_diff == 0. Returns cudaGetLastError() after the launch (0 = success).
extern "C" int fused_preprocess_dual(
    const float* frames, const float* base, float* out, int n, int h_in,
    int w_in, int h_out, int w_out, int use_diff, float m0, float m1, float m2,
    float a0, float a1, float a2, void* stream) {
  if (n == 0) return 0;
  const size_t smem = (size_t)w_in * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_preprocess_dual_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned int blocks = (unsigned int)n * 6u * (unsigned int)h_out;
  fused_preprocess_dual_kernel<<<blocks, 128, smem, (cudaStream_t)stream>>>(
      frames, base, out, n, h_in, w_in, h_out, w_out, use_diff, m0, m1, m2,
      a0, a1, a2);
  return (int)cudaGetLastError();
}
