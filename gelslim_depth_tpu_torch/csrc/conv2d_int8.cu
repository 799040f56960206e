// int8 x int8 -> int32 implicit-GEMM convolution with a float32 dequant
// epilogue, for Hopper (sm_90a).
//
// Replaces the XLA ops of the JAX package's int8 U-Net graph:
//   gelslim_depth_tpu/models/quantize.py:164  lax.conv_general_dilated
//     (s8 x s8 -> s32, in _conv_int8_pre), every quantized 3x3 / kxk conv;
//   gelslim_depth_tpu/models/quantize.py:136  lax.dot_general (s8 x s8 -> s32,
//     in _upconv_int8), the k matmuls of the opt-in row-split int8 upconv.
// Neither is a Pallas kernel; PyTorch has no int8 convolution on CUDA.
//
// What it computes, for qx int8 NHWC (N, H, W, Cin) and w int8 OHWI
// (Cout, kh, kw, Cin), stride 1, zero padding `pad` on each side:
//   acc[m, o] = sum_k A[m, k] * w[o, k]            int32, exact
//     with M = N*Ho*Wo rows (output pixels), K = kh*kw*Cin, and
//     A[m, (dy*kw + dx)*Cin + c] = qx[n, ho + dy - pad, wo + dx - pad, c]
//     (0 outside the image: zero padding is exact in int8);
//   y = float(acc) * scale[o]                      scale = in_s * w_s[o]
//   y = y + bias[o]                                optional
//   y = y * bn_mul[o] + bn_add[o]                  optional folded eval BN
//   y = act(y)                                     none | relu | tanh | mish
//   out = y, stored float32 or bfloat16, NHWC; or, with shuffle = s > 1, the
//     depth-to-space store of a k == stride transposed conv run as a 1x1 conv
//     with s*s*C columns: column (di*s + dj)*C + o of pixel (n, i, j) goes to
//     out[n, s*i + di, s*j + dj, o].
// Each multiply and add of the epilogue is rounded on its own (__fmul_rn,
// __fadd_rn, no contracted FMA), as the plain PyTorch twin's separate ops are,
// so the relu epilogue matches the twin bit for bit.
//
// Bound on this card: operations, at the flagship's deep sites; bytes at the
// full-resolution ones. The 17 quantized sites of the flagship U-Net do about
// 23.6 G multiply-adds per 160x213 finger image, 6.0 T integer operations at
// N=64 dual frames, 3.1 ms at the H100 SXM's 1,979 TOPS dense int8 peak. At
// inc/conv2 (64 -> 64 channels, 160x213) the bytes win: 0.28 GB of int8 in and
// 0.56 GB of bf16 out at N=64 take 0.25 ms at 3.35 TB/s, against 0.16 ms of
// operations.
//
// Design, simple first (wgmma, TMA and the next site's requantization fused
// into the epilogue are later work):
//   - A block computes a 128 x (32 * WN) tile of the (M, Cout) output with
//     2 x WN warps, each 64 x 32, as m16n8k32 s8 mma.sync tiles with int32
//     accumulators in registers. WN is 4 where Cout is a multiple of 128, at
//     least CONV_WIDE_COUT, and the wide tiles still make two blocks for
//     each SM of the card (the deep sites at a large batch, where a wider
//     tile reads each A tile fewer times); else 2, which makes twice the
//     blocks.
//   - K goes in steps of 64 bytes through a kStages-deep ring in shared
//     memory, filled with 16-byte cp.async copies; a halo or out-of-range
//     chunk is zero-filled by the copy itself (src-size 0). Two load paths:
//       tap-major (Cin % 64 == 0, every flagship site): a K step is 64
//         channels of one filter tap; a thread keeps a pointer a row and
//         recomputes it only when the tap changes (every Cin / 64 steps);
//       bytes (any other Cin: 4, 8, 24, ...): plain loads, the same masks.
//   - Rows of the ring are padded by 16 bytes, so the ldmatrix fragment loads
//     (8 rows of 16 bytes a phase) hit 8 distinct 16-byte bank groups.
//   - The epilogue stages the int32 accumulators in shared memory, then runs
//     as a short rolled loop in which a warp owns a whole output row (one
//     128-byte bf16 store a row of 64 channels). Unrolled over a thread's 64
//     fragment elements, with every activation and store variant inlined,
//     it was long enough to be fetched from instruction memory again for
//     each block, which dominated the short-K full-resolution sites. tanh,
//     mish, the depth-to-space store and odd channel counts stay calls.
//   - Blocks walk the Cout tiles fastest, so the blocks that share an A tile
//     run together and read it from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The launch shape; ops/kernels/tune_conv_int8.py builds variants with -D.
// Three stages, not the sweep's two: the sweep times each site alone, its
// weights warm in L2. In serving, where the 17 sites' weights and the
// passes between them evict each other, three take 0.62-0.66 ms of an N=1
// call on an H100 SXM against two's 0.77 ms; at N=64 the two are level.
#ifndef CONV_STAGES
#define CONV_STAGES 3
#endif
#ifndef CONV_WIDE_COUT
#define CONV_WIDE_COUT 128
#endif
constexpr int kStages = CONV_STAGES;
constexpr int kBM = 128;        // output rows (pixels) a block
constexpr int kBK = 64;         // K bytes a stage
constexpr int kRow = kBK + 16;  // padded shared row, bytes
constexpr int kChunks = kBK / 16;  // 16-byte chunks a row

// The tile shape for WN warps along Cout.
template <int WN>
struct Tile {
  static constexpr int kBN = 32 * WN;       // output columns (channels) a block
  static constexpr int kThreads = 64 * WN;  // 2 warps along M x WN along N
  static constexpr int kStageBytes = (kBM + kBN) * kRow;
  static constexpr int kAccRow = kBN + 8;  // int32 row of the staged accumulators, padded
  static constexpr int kSmemBytes =
      kStages * kStageBytes > kBM * kAccRow * 4 ? kStages * kStageBytes : kBM * kAccRow * 4;
  static constexpr int kRowStep = kThreads / kChunks;  // rows between a thread's chunks
  static constexpr int kARows = kBM / kRowStep;        // A rows a thread loads
  static constexpr int kBRows = kBN / kRowStep;        // B rows a thread loads
  static_assert(kBN % 64 == 0, "a warp stores 64 output columns a pass");
  static_assert(kBM % kRowStep == 0 && kBN % kRowStep == 0, "tile rows must split evenly");
};

enum Act { kNone = 0, kRelu = 1, kTanh = 2, kMish = 3 };
enum Path { kBytes = 0, kTapMajor = 1 };

struct Params {
  const int8_t* x;
  const int8_t* w;
  void* out;
  const float* scale;
  const float* bias;    // may be null
  const float* bn_mul;  // null, or both BN vectors given
  const float* bn_add;
  int h, w_in, cin, cout, kh, kw, pad, ho, wo;
  int m_total, k_total, n_tiles;
  int act, out_bf16, shuffle;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The input pixel row m of the GEMM reads: (image n, ho - pad, wo - pad),
// or n = -1 for a row past M.
struct RowOrigin {
  int n, ih0, iw0;
};

__device__ __forceinline__ RowOrigin row_origin(const Params& p, int m) {
  if (m >= p.m_total) return {-1, 0, 0};
  const int wo = m % p.wo;
  const int t = m / p.wo;
  const int ho = t % p.ho;
  return {t / p.ho, ho - p.pad, wo - p.pad};
}

// Address of input pixel (ih0 + dy, iw0 + dx), channel c, of row r; null
// where it is padding or past M.
__device__ __forceinline__ const int8_t* pixel(const Params& p, const RowOrigin& r, int dy, int dx, int c) {
  const int ih = r.ih0 + dy;
  const int iw = r.iw0 + dx;
  if (r.n < 0 || ih < 0 || ih >= p.h || iw < 0 || iw >= p.w_in) return nullptr;
  return p.x + (((static_cast<size_t>(r.n) * p.h + ih) * p.w_in + iw) * p.cin + c);
}

// Address of A[m, k] for the row origin r, or null where it is padding.
__device__ __forceinline__ const int8_t* a_src(const Params& p, const RowOrigin& r, int k) {
  if (k >= p.k_total) return nullptr;
  const int tap = k / p.cin;
  const int dy = tap / p.kw;
  return pixel(p, r, dy, tap - dy * p.kw, k - tap * p.cin);
}

// The tap-major path's position: the next K step reads channels
// [c0, c0 + kBK) of tap (dy, dx), at ptr[i] + c0 for the thread's row i
// (null: padding). Steps in K order: channels, then dx, then dy.
template <int kRows>
struct TapCursor {
  int c0, dy, dx;
  const int8_t* ptr[kRows];

  __device__ __forceinline__ void aim(const Params& p, const RowOrigin (&rows)[kRows], int kc) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) ptr[i] = pixel(p, rows[i], dy, dx, kc);
  }

  __device__ __forceinline__ void advance(const Params& p, const RowOrigin (&rows)[kRows], int kc) {
    c0 += kBK;
    if (c0 == p.cin) {
      c0 = 0;
      if (++dx == p.kw) {
        dx = 0;
        ++dy;
      }
      if (dy < p.kh) aim(p, rows, kc);
    }
  }
};

// Stage the K bytes [k0, k0 + kBK) of the block's A rows and B columns.
template <int kPath, int WN>
__device__ __forceinline__ void load_stage(const Params& p, int8_t* stage, const TapCursor<Tile<WN>::kARows>& tc,
                                           int m0, int n0, int k0) {
  using T = Tile<WN>;
  int8_t* As = stage;
  int8_t* Bs = stage + kBM * kRow;
  const int tid = threadIdx.x;
  if (kPath == kBytes) {
    const int kk = tid & (kBK - 1);
    for (int r = tid / kBK; r < kBM; r += T::kThreads / kBK) {
      const int8_t* src = a_src(p, row_origin(p, m0 + r), k0 + kk);
      As[r * kRow + kk] = src ? *src : 0;
    }
    for (int r = tid / kBK; r < T::kBN; r += T::kThreads / kBK) {
      const int col = n0 + r;
      const bool ok = col < p.cout && k0 + kk < p.k_total;
      Bs[r * kRow + kk] = ok ? p.w[static_cast<size_t>(col) * p.k_total + k0 + kk] : 0;
    }
    return;
  }
  const int kc = (tid % kChunks) * 16;
#pragma unroll
  for (int i = 0; i < T::kARows; ++i) {
    const int r = tid / kChunks + T::kRowStep * i;
    const int8_t* src = tc.ptr[i] ? tc.ptr[i] + tc.c0 : nullptr;
    cp_async16(As + r * kRow + kc, src ? src : p.x, src != nullptr);
  }
#pragma unroll
  for (int i = 0; i < T::kBRows; ++i) {
    const int r = tid / kChunks + T::kRowStep * i;
    const int col = n0 + r;
    const bool ok = col < p.cout && k0 + kc < p.k_total;
    const int8_t* src = ok ? p.w + static_cast<size_t>(col) * p.k_total + k0 + kc : p.w;
    cp_async16(Bs + r * kRow + kc, src, ok);
  }
}

// tanh and mish, out of line: inlined into every element of an unrolled
// epilogue they would multiply its code (the flagship runs relu)
__device__ __noinline__ float activate_rare(int act, float y) {
  if (act == kTanh) return tanhf(y);
  // mish: x * tanh(softplus(x)), softplus with PyTorch's threshold of 20
  const float sp = y > 20.0f ? y : log1pf(expf(y));
  return __fmul_rn(y, tanhf(sp));
}

// Element offset in `out` of output pixel `row`, column `col`.
__device__ __forceinline__ size_t out_offset(const Params& p, int row, int col) {
  if (p.shuffle <= 1) return static_cast<size_t>(row) * p.cout + col;
  const int s = p.shuffle;
  const int c = p.cout / (s * s);
  const int j = row % p.wo;
  const int t = row / p.wo;
  const int i = t % p.ho;
  const int n = t / p.ho;
  const int di = col / (s * c);
  const int rem = col - di * s * c;
  const int dj = rem / c;
  const int o = rem - dj * c;
  return ((static_cast<size_t>(n) * s * p.ho + s * i + di) * (s * p.wo) + s * j + dj) * c + o;
}

// Columns col and col + 1 of one output row, one element at a time: the
// depth-to-space store and odd channel counts. Out of line, as above.
__device__ __noinline__ void store_scalar(const Params& p, int row, int col, float y0, float y1) {
  for (int j = 0; j < 2 && col + j < p.cout; ++j) {
    const size_t off = out_offset(p, row, col + j);
    const float y = j ? y1 : y0;
    if (p.out_bf16)
      static_cast<__nv_bfloat16*>(p.out)[off] = __float2bfloat16_rn(y);
    else
      static_cast<float*>(p.out)[off] = y;
  }
}

template <int kPath, int WN>
__global__ void __launch_bounds__(Tile<WN>::kThreads) conv2d_int8_kernel(const Params p) {
  using T = Tile<WN>;
  extern __shared__ __align__(128) int8_t smem[];

  const int tile_n = blockIdx.x % p.n_tiles;  // Cout tiles fastest: A tiles shared in L2
  const int tile_m = blockIdx.x / p.n_tiles;
  const int m0 = tile_m * kBM;
  const int n0 = tile_n * T::kBN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp & 1) * 64;   // warp's rows in the block tile
  const int wn = (warp >> 1) * 32;  // warp's columns
  const int kc = (tid % kChunks) * 16;

  RowOrigin rows[T::kARows];
#pragma unroll
  for (int i = 0; i < T::kARows; ++i) rows[i] = row_origin(p, m0 + tid / kChunks + T::kRowStep * i);
  TapCursor<T::kARows> tc;
  tc.c0 = tc.dy = tc.dx = 0;
  if (kPath == kTapMajor) tc.aim(p, rows, kc);

  int acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0;

  const int k_tiles = (p.k_total + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) {
      load_stage<kPath, WN>(p, smem + s * T::kStageBytes, tc, m0, n0, s * kBK);
      if (kPath == kTapMajor) tc.advance(p, rows, kc);
    }
    cp_async_commit();
  }

  // ldmatrix lane roles: A x4 = rows 0-7 / 8-15 at bytes 0-15, then at 16-31;
  // B x4 = two n8 tiles, each at bytes 0-15 then 16-31
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 16;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 16;

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; every warp is done with stage kt - 1
    const int next = kt + kStages - 1;
    if (next < k_tiles) {
      load_stage<kPath, WN>(p, smem + (next % kStages) * T::kStageBytes, tc, m0, n0, next * kBK);
      if (kPath == kTapMajor) tc.advance(p, rows, kc);
    }
    cp_async_commit();

    const int8_t* As = smem + (kt % kStages) * T::kStageBytes;
    const int8_t* Bs = As + kBM * kRow;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      unsigned a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) ldmatrix_x4(a[mi], As + (wm + mi * 16 + a_row) * kRow + kk + a_col);
      unsigned b[4][2];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        unsigned r[4];
        ldmatrix_x4(r, Bs + (wn + nj * 16 + b_row) * kRow + kk + b_col);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  cp_async_wait<0>();

  // Stage the accumulators through shared memory (the ring is free now), so
  // that the epilogue is a short rolled loop in which a warp owns a whole
  // output row: fragment c[0], c[1] is row g, columns 2t and 2t+1; c[2],
  // c[3] is row g + 8. A padded row of kBN + 8 int32 keeps each half-warp's
  // 8-byte stores on distinct banks.
  __syncthreads();
  int* staged = reinterpret_cast<int*>(smem);
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<int2*>(staged + (wm + mi * 16 + g + 8 * half) * T::kAccRow + wn + ni * 8 + 2 * t) =
            make_int2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
  __syncthreads();

  // row-major NHWC with an even channel count: columns c, c+1 side by side
  const bool pair = p.shuffle <= 1 && (p.cout & 1) == 0;
  const bool has_bias = p.bias != nullptr;
  const bool has_bn = p.bn_mul != nullptr;
  constexpr int kWarps = T::kThreads / 32;
#pragma unroll
  for (int pass = 0; pass < T::kBN / 64; ++pass) {
    // this lane's two columns, and their vectors, loaded once
    const int c = pass * 64 + 2 * lane;
    const int col = n0 + c;
    if (col >= p.cout) continue;
    float vs[2], vb[2], vm[2], va[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool ok = col + j < p.cout;
      vs[j] = ok ? p.scale[col + j] : 0.0f;
      vb[j] = ok && has_bias ? p.bias[col + j] : 0.0f;
      vm[j] = ok && has_bn ? p.bn_mul[col + j] : 0.0f;
      va[j] = ok && has_bn ? p.bn_add[col + j] : 0.0f;
    }
#pragma unroll 2
    for (int r = warp; r < kBM; r += kWarps) {
      const int row = m0 + r;
      if (row >= p.m_total) break;
      const int2 a2 = *reinterpret_cast<const int2*>(staged + r * T::kAccRow + c);
      float y[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // each multiply and add rounded on its own, as the twin's ops are
        float v = __fmul_rn(__int2float_rn(j ? a2.y : a2.x), vs[j]);
        if (has_bias) v = __fadd_rn(v, vb[j]);
        if (has_bn) v = __fadd_rn(__fmul_rn(v, vm[j]), va[j]);
        if (p.act == kRelu)
          v = fmaxf(v, 0.0f);
        else if (p.act != kNone)
          v = activate_rare(p.act, v);
        y[j] = v;
      }
      if (!pair) {
        store_scalar(p, row, col, y[0], y[1]);
      } else if (p.out_bf16) {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + static_cast<size_t>(row) * p.cout + col) =
            __floats2bfloat162_rn(y[0], y[1]);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + static_cast<size_t>(row) * p.cout + col) =
            make_float2(y[0], y[1]);
      }
    }
  }
}

template <int kPath, int WN>
cudaError_t launch(Params p, cudaStream_t s) {
  using T = Tile<WN>;
  p.n_tiles = (p.cout + T::kBN - 1) / T::kBN;
  const long long blocks = (static_cast<long long>(p.m_total) + kBM - 1) / kBM * p.n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(conv2d_int8_kernel<kPath, WN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return err;
  conv2d_int8_kernel<kPath, WN><<<static_cast<unsigned>(blocks), T::kThreads, T::kSmemBytes, s>>>(p);
  return cudaGetLastError();
}

template <int kPath>
cudaError_t launch_width(const Params& p, cudaStream_t s) {
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long wide_blocks = (static_cast<long long>(p.m_total) + kBM - 1) / kBM * (p.cout / 128);
  if (p.cout % 128 == 0 && p.cout >= CONV_WIDE_COUT && wide_blocks >= 2LL * sms)
    return launch<kPath, 4>(p, s);
  return launch<kPath, 2>(p, s);
}

}  // namespace

// Launches on `stream` without synchronizing. x: int8 (n, h, w, cin); w: int8
// (cout, kh, kw, cin); out: (n, ho, wo, cout) float32 (out_bf16 = 0) or
// bfloat16, or with shuffle = s > 1 and kh = kw = 1, pad = 0, the
// (n, s*h, s*w, cout / s^2) depth-to-space layout. scale, and bias, bn_mul,
// bn_add where not null, are float32 (cout,). act: 0 none, 1 relu, 2 tanh,
// 3 mish. Returns cudaGetLastError() after the launch, or the error that kept
// it from launching (0 = success).
extern "C" int conv2d_int8(const void* x, const void* w, void* out, const float* scale, const float* bias,
                           const float* bn_mul, const float* bn_add, int n, int h, int w_in, int cin,
                           int cout, int kh, int kw, int pad, int act, int out_bf16, int shuffle,
                           void* stream) {
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.out = out;
  p.scale = scale;
  p.bias = bias;
  p.bn_mul = bn_mul;
  p.bn_add = bn_add;
  p.h = h;
  p.w_in = w_in;
  p.cin = cin;
  p.cout = cout;
  p.kh = kh;
  p.kw = kw;
  p.pad = pad;
  p.ho = h + 2 * pad - kh + 1;
  p.wo = w_in + 2 * pad - kw + 1;
  p.act = act;
  p.out_bf16 = out_bf16;
  p.shuffle = shuffle;
  const long long m_total = static_cast<long long>(n) * p.ho * p.wo;
  const long long k_total = static_cast<long long>(kh) * kw * cin;
  if (m_total <= 0 || cout <= 0) return 0;
  // rows and K positions are int, a tile past their ends included; every
  // memory offset is size_t
  if (m_total > 0x7fffffffLL - kBM || k_total > 0x7fffffffLL - kBK) return static_cast<int>(cudaErrorInvalidValue);
  p.m_total = static_cast<int>(m_total);
  p.k_total = static_cast<int>(k_total);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (aligned && cin % kBK == 0)
    err = launch_width<kTapMajor>(p, s);
  else
    err = launch_width<kBytes>(p, s);
  return static_cast<int>(err);
}
