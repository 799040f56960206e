// Fused dual-finger preprocess for Hopper (sm_90a): difference image, area
// resize and per-channel normalize in one pass over the raw frames.
//
// Replaces the Pallas TPU kernel
//   gelslim_depth_tpu/ops/pallas/preprocess_kernel.py:_kernel
//   (launched by _fused_preprocess_dual, public wrapper fused_preprocess_dual).
//
// What it computes, for frames (N, 6, H, W), base (6, H, W) -> out (2N, 3, h, w):
//   d = (x - base[c] + 255) * 0.5               (or d = x when use_diff == 0)
//   y = A_h . d . A_w^T                         (adaptive-average area resize)
//   out[(c / 3) * N + n, c % 3] = y * mult[c % 3] + add[c % 3]
// Left-finger samples land in rows [0, N), right-finger ones in [N, 2N).
// A_h and A_w are banded: output pixel i of an axis averages the input window
// [floor(i*n_in/n_out), ceil((i+1)*n_in/n_out)), each term weighted by
// float32(1/k). All arithmetic is float32 on the CUDA cores: the resize is
// parity-critical, so no TF32, and 2-3 tap windows give the tensor cores
// nothing to do.
//
// Bound on this card: bytes. The least traffic is each input read once and
// each output written once, 4 * (N*6*H*W + 6*H*W + 2N*3*h*w) bytes; at the
// flagship N=64, 320x427 -> 160x213 that is 265,505,280 B, 79 us at the
// H100 SXM's 3.35 TB/s. The work is ~5 float ops per input element.
//
// Design. A block owns one (channel c, tile of output rows, chunk of frames).
// A tile's input rows are one contiguous span of a plane.
//   1. Bytes in flight: the block streams its frames' spans through a ring of
//      kStages buffers in shared memory with cp.async, 16 B a thread, so the
//      next frames are in flight while one is reduced. The launcher splits
//      the frames into chunks so that about kWaves waves of blocks, several
//      on each SM, fill the card at any N; at N=1 the tiles alone give 480
//      blocks at the flagship shape.
//   2. Base reuse: the base span is copied into shared memory once per block
//      and serves every frame of its chunk, rather than being read again
//      for every frame (half of all loads).
//   3. Ragged spans: a span need not start or end on 16 B (427-wide rows are
//      1,708 B; views may start anywhere). It lands in shared memory at the
//      same offset mod 16 as in device memory, so the aligned body moves in
//      16-B copies and the 0-3 float head and tail in 4-B copies. Every shape
//      takes this one route.
//   4. No integer division per pixel: window starts, ends and weights come
//      from int32/float32 tables built once per shape on the host (the
//      wrapper's window_table and tile_plan), one 16-B shared load a window.
// The reduction, not the copy, is what limits a simple version of this
// kernel, so a thread owns output columns and forms each pixel from its
// whole window at once: the window loops unroll to the widest window of the
// call (an instantiation per 1-3 rows by 1-3 columns, one for wider), so a
// pixel's shared loads issue together. Stores are coalesced along w.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

// The launch shape, from a sweep on the H100 (ops/kernels/tune_preprocess.py,
// which builds variants with -D): threads a block at most, frame buffers, and
// waves of blocks to aim for.
#ifndef FPD_THREADS
#define FPD_THREADS 256
#endif
#ifndef FPD_STAGES
#define FPD_STAGES 3
#endif
#ifndef FPD_WAVES
#define FPD_WAVES 8
#endif
constexpr int kThreads = FPD_THREADS;
constexpr int kStages = FPD_STAGES;  // mirrored by STAGES in ops/kernels/preprocess_kernel.py
constexpr int kWaves = FPD_WAVES;    // aim for about this many waves of resident blocks

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// floats by which p lies past a 16-B boundary
__device__ __forceinline__ int misalignment(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Issues the copy of src[0, len) to buf + misalignment(src); buf is 16-B
// aligned and holds len + 3 floats. Needs blockDim.x >= 3.
__device__ __forceinline__ void copy_span(float* buf, const float* src, int len) {
  const int mis = misalignment(src);
  float* dst = buf + mis;
  const int head = min((4 - mis) & 3, len);
  const int body = (len - head) >> 2;
  const int tail = head + 4 * body;
  for (int i = threadIdx.x; i < body; i += blockDim.x)
    cp_async16(dst + head + 4 * i, src + head + 4 * i);
  const int t = threadIdx.x;
  if (t < head) cp_async4(dst + t, src + t);
  if (t < len - tail) cp_async4(dst + tail + t, src + tail + t);
}

// The window sum of one output pixel, in the twin's order: the vertical sum
// wh * d over rows [rw.x, rw.y) of each column, then ww * that over columns
// [cw.x, cw.y). KH and KW bound the window's rows and columns so that the
// loops unroll and a pixel's loads issue together; 0 means any extent.
template <int KH, int KW>
__device__ __forceinline__ float window_sum(const float* x, const float* b, int use_diff,
                                            int w_in, int4 rw, int4 cw) {
  const float wh = __int_as_float(rw.z), ww = __int_as_float(cw.z);
  float s = 0.0f;
#pragma unroll
  for (int j = 0; KW == 0 ? cw.x + j < cw.y : j < KW; ++j) {
    if (KW == 0 || cw.x + j < cw.y) {
      float t = 0.0f;
#pragma unroll
      for (int i = 0; KH == 0 ? rw.x + i < rw.y : i < KH; ++i) {
        if (KH == 0 || rw.x + i < rw.y) {
          const int off = (rw.x + i) * w_in + cw.x + j;
          const float d = use_diff ? (x[off] - b[off] + 255.0f) * 0.5f : x[off];
          t += wh * d;
        }
      }
      s += ww * t;
    }
  }
  return s;
}

template <int KH, int KW>
__global__ void __launch_bounds__(kThreads) fused_preprocess_dual_kernel(
    const float* __restrict__ frames, const float* __restrict__ base,
    float* __restrict__ out, const int* __restrict__ row_table,
    const int* __restrict__ col_table, const int4* __restrict__ tiles, int n,
    int h_in, int w_in, int h_out, int w_out, int stage_floats, int use_diff,
    float m0, float m1, float m2, float a0, float a1, float a2) {
  extern __shared__ __align__(16) float smem[];
  float* base_buf = smem;                         // stage_floats
  float* ring = base_buf + stage_floats;          // kStages * stage_floats
  // (start, end, weight bits, 0) of each output column, then of each of the
  // tile's output rows, rows counted from the tile's first input row
  int4* cols = reinterpret_cast<int4*>(ring + kStages * stage_floats);  // w_out
  int4* rows = cols + w_out;                      // the tile's output rows

  const int c = blockIdx.x % 6;
  const int4 tile = tiles[blockIdx.x / 6];  // output rows [x, y), input rows [z, w)
  const int rows_out = tile.y - tile.x;
  const int span = (tile.w - tile.z) * w_in;
  const int f0 = static_cast<int>(static_cast<long long>(blockIdx.y) * n / gridDim.y);
  const int f1 = static_cast<int>(static_cast<long long>(blockIdx.y + 1) * n / gridDim.y);
  const size_t plane = static_cast<size_t>(h_in) * w_in;
  const size_t frame_stride = 6 * plane;
  const float* first = frames + (static_cast<size_t>(f0) * 6 + c) * plane +
                       static_cast<size_t>(tile.z) * w_in;
  const float* base_src = use_diff ? base + c * plane + static_cast<size_t>(tile.z) * w_in : nullptr;

  // Prologue: the base span joins frame f0's group; kStages-1 groups in all.
  if (use_diff) copy_span(base_buf, base_src, span);
  for (int s = 0; s < kStages - 1; ++s) {
    if (f0 + s < f1) copy_span(ring + s * stage_floats, first + s * frame_stride, span);
    cp_async_commit();
  }
  for (int i = threadIdx.x; i < w_out; i += blockDim.x)
    cols[i] = make_int4(col_table[i], col_table[w_out + i], col_table[2 * w_out + i], 0);
  for (int i = threadIdx.x; i < rows_out; i += blockDim.x) {
    const int o = tile.x + i;
    rows[i] = make_int4(row_table[o] - tile.z, row_table[h_out + o] - tile.z,
                        row_table[2 * h_out + o], 0);
  }
  const float* b = use_diff ? base_buf + misalignment(base_src) : nullptr;

  const int ch = c % 3;
  const float mult = ch == 0 ? m0 : (ch == 1 ? m1 : m2);
  const float add = ch == 0 ? a0 : (ch == 1 ? a1 : a2);
  const size_t out_stride = static_cast<size_t>(3) * h_out * w_out;
  float* out_first = out + ((static_cast<size_t>(c / 3) * n + f0) * 3 + ch) * h_out * w_out +
                     static_cast<size_t>(tile.x) * w_out;

  for (int k = 0; f0 + k < f1; ++k) {
    // frame k has landed; every thread is done with frame k-1's buffer
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = k + kStages - 1;
    if (f0 + next < f1)
      copy_span(ring + (next % kStages) * stage_floats, first + next * frame_stride, span);
    cp_async_commit();

    const float* x = ring + (k % kStages) * stage_floats + misalignment(first + k * frame_stride);
    float* y = out_first + k * out_stride;
    for (int p = threadIdx.x; p < w_out; p += blockDim.x) {
      const int4 cw = cols[p];
      for (int oh = 0; oh < rows_out; ++oh)
        y[oh * w_out + p] = window_sum<KH, KW>(x, b, use_diff, w_in, rows[oh], cw) * mult + add;
    }
  }
  cp_async_wait<0>();
}

using KernelFn = void (*)(const float*, const float*, float*, const int*, const int*,
                          const int4*, int, int, int, int, int, int, int, float, float,
                          float, float, float, float);

// The instantiation whose unrolled loops cover windows of kh rows and kw
// columns: 1-3 each, or the one with loops of any extent.
KernelFn pick_kernel(int kh, int kw) {
  static const KernelFn unrolled[3][3] = {
      {fused_preprocess_dual_kernel<1, 1>, fused_preprocess_dual_kernel<1, 2>, fused_preprocess_dual_kernel<1, 3>},
      {fused_preprocess_dual_kernel<2, 1>, fused_preprocess_dual_kernel<2, 2>, fused_preprocess_dual_kernel<2, 3>},
      {fused_preprocess_dual_kernel<3, 1>, fused_preprocess_dual_kernel<3, 2>, fused_preprocess_dual_kernel<3, 3>},
  };
  if (kh >= 1 && kh <= 3 && kw >= 1 && kw <= 3) return unrolled[kh - 1][kw - 1];
  return fused_preprocess_dual_kernel<0, 0>;
}

}  // namespace

// Launches on `stream` without synchronizing. `base` may be null when
// use_diff == 0. row_table is int32 (3, h_out): window starts, ends and the
// float32 weights' bits; col_table the same over (3, w_out). tiles is int32
// (n_tiles, 4): output rows [o0, o1) and the input rows [r0, r1) their
// windows cover, tile_rows output rows at most and max_tile_rows input rows
// at most. max_kh and max_kw are the widest row and column windows. Returns
// cudaGetLastError() after the launch, or the error that kept it from
// launching (0 = success).
extern "C" int fused_preprocess_dual(
    const float* frames, const float* base, float* out, int n, int h_in,
    int w_in, int h_out, int w_out, int use_diff, float m0, float m1, float m2,
    float a0, float a1, float a2, const int* row_table, const int* col_table,
    const int* tiles, int n_tiles, int tile_rows, int max_tile_rows, int max_kh,
    int max_kw, void* stream) {
  if (n == 0) return 0;
  const KernelFn kernel = pick_kernel(max_kh, max_kw);
  // a span of max_tile_rows rows, 0-3 floats of misalignment, 16-B multiple
  const int stage_floats = (max_tile_rows * w_in + 3 + 3) / 4 * 4;
  const size_t smem = sizeof(float) * (kStages + 1) * static_cast<size_t>(stage_floats) +
                      sizeof(int4) * (static_cast<size_t>(w_out) + tile_rows);
  // a thread per output column, up to kThreads
  const int threads = std::min(kThreads, (w_out + 31) / 32 * 32);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // split the frames into chunks so that about kWaves waves of blocks fill
  // the card; each block still keeps its base span for a whole chunk
  const long long pairs = 6LL * n_tiles;
  long long chunks = static_cast<long long>(kWaves) * sms * per_sm / pairs;
  chunks = chunks < 1 ? 1 : (chunks > n ? n : chunks);
  chunks = chunks > 65535 ? 65535 : chunks;
  const dim3 grid(static_cast<unsigned>(pairs), static_cast<unsigned>(chunks));
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      frames, base, out, row_table, col_table, reinterpret_cast<const int4*>(tiles), n,
      h_in, w_in, h_out, w_out, stage_floats, use_diff, m0, m1, m2, a0, a1, a2);
  return static_cast<int>(cudaGetLastError());
}
