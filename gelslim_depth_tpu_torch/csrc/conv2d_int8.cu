// int8 x int8 -> int32 implicit-GEMM convolution with a float32 dequant
// epilogue that also requantizes its output for the next int8 conv, for
// Hopper (sm_90a).
//
// Replaces the XLA ops of the JAX package's int8 U-Net graph:
//   gelslim_depth_tpu/models/quantize.py:164  lax.conv_general_dilated
//     (s8 x s8 -> s32, in _conv_int8_pre), every quantized 3x3 / kxk conv;
//   gelslim_depth_tpu/models/quantize.py:136  lax.dot_general (s8 x s8 -> s32,
//     in _upconv_int8), the k matmuls of the opt-in row-split int8 upconv;
// and the passes around them there: the requantization of each conv's
// output at its consumers' scales (_quant_act, quantize.py:389-426), the pad
// and concat of up_j/conv1's two inputs. Neither is a Pallas kernel;
// PyTorch has no int8 convolution on CUDA.
//
// What it computes, for x int8 NHWC (N, H, W, C1), optionally x2 int8
// (N, H2, W2, C2) placed at (off_y, off_x) on x's H x W (zero elsewhere),
// and w int8 OHWI (Cout, kh, kw, C1 + C2), stride 1, zero padding `pad`:
//   acc[m, o] = sum_k A[m, k] * w[o, k]            int32, exact
//     with M = N*Ho*Wo rows (output pixels), K = kh*kw*(C1 + C2), and
//     A[m, (dy*kw + dx)*C + c] = the concat [x, x2] at (ho + dy - pad,
//     wo + dx - pad), channel c (0 outside: zero padding is exact in int8);
//   y = float(acc) * scale[o]                      scale = in_s * w_s[o]
//   y = y + bias[o]                                optional
//   y = y * bn_mul[o] + bn_add[o]                  optional folded eval BN
//   y = act(y)                                     none | relu | tanh | mish
//   v = y rounded to the compute dtype (float32 or bfloat16);
//   out = v, stored in the compute dtype where asked, and up to two int8
//     outputs q_i = clamp(rint(v / s_i), -127, 127) (IEEE division, half to
//     even), each at its consumer's scale s_i; all NHWC, or, with shuffle =
//     s > 1, the depth-to-space store of a k == stride transposed conv run
//     as a 1x1 conv with s*s*C columns: column (di*s + dj)*C + o of pixel
//     (n, i, j) goes to out[n, s*i + di, s*j + dj, o].
// Each multiply and add of the epilogue is rounded on its own (__fmul_rn,
// __fadd_rn, no contracted FMA), as the plain PyTorch twin's separate ops
// are, so the relu epilogue matches the twin bit for bit, int8 outputs
// included.
//
// Bound on this card: operations at the flagship's deep sites, bytes at the
// full-resolution ones. The 17 quantized sites of the flagship U-Net do
// about 23.6 G multiply-adds per 160x213 finger image, 6.0 T integer
// operations at N=64 dual frames, 3.1 ms at the H100 SXM's 1,979 TOPS dense
// int8 peak. At inc/conv2 (64 -> 64 channels, 160x213) the bytes win: 0.28
// GB of int8 in and two int8 outputs of 0.28 GB each at N=64 take 0.25 ms
// at 3.35 TB/s, against 0.16 ms of operations.
//
// Two mainloops, by shape:
//   wgmma (C1 and C2 multiples of 64, x, x2 and w 16-byte aligned: every
//     flagship site): persistent blocks with producer warps, two consumer
//     warpgroups and, at 128 output columns, epilogue warps. The producers
//     feed a ring in shared memory with TMA: each K step is one filter tap
//     x 64 channels of one source, an im2col-mode box of 128 output pixels
//     (the tensor map's out-of-bounds zero fill is the conv's padding and
//     the concat's zeros) and a tiled box of the weights, both 64-byte
//     swizzled as wgmma reads them, with mbarriers for full and empty
//     stages. One thread issuing every box held a K step to ~950 cycles, so
//     2 or 4 producers take stages in turn. Each consumer warpgroup runs
//     m64nNk32 s8 wgmma on its 64 rows of a 128 x N tile (N = 64, 128 or 256
//     by Cout), so the int8 tensor cores run at Hopper's full rate. The
//     epilogue is as long as the mainloop at the full-resolution sites, and
//     overlaps it: at N = 64 two blocks share an SM; at N = 128 the sums go
//     to one of two shared buffers that the epilogue warps drain while the
//     consumers run the next tile; at N = 256 (long K only) the consumers
//     run it themselves while the producers fill the ring.
//   bytes (any other C1, C2 or alignment: 4, 8, 24, ... channels): mma.sync
//     m16n8k32 tiles fed a byte a thread through a ring of shared stages.
// Both end in the same epilogue: a short rolled loop in which a warp owns a
// whole output row (one 64-byte int8 or 128-byte bf16 store a row of 64
// channels). Unrolled over a thread's fragment elements with every variant
// inlined, it was long enough to be fetched again from instruction memory
// for each short-K tile; tanh, mish, the depth-to-space store, odd channel
// counts and the IEEE division for extreme scales stay calls.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// The depth of the wgmma path's TMA ring (at most: less where the shared
// memory allows less, and a multiple of the producers), and the producer
// warps of its one-block tiles; ops/kernels/tune_conv_int8.py builds
// variants with -D.
#ifndef CONV_TMA_STAGES
#define CONV_TMA_STAGES 6
#endif
#ifndef CONV_PRODUCERS
#define CONV_PRODUCERS 4
#endif
constexpr int kStages = 3;      // the bytes path's ring
constexpr int kBM = 128;        // output rows (pixels) a block tile
constexpr int kBK = 64;         // K bytes a stage
constexpr int kRow = kBK + 16;  // the bytes path's padded shared row, bytes

// The bytes path's tile: 128 x 64 with 2 x 2 warps, each 64 x 32.
struct Tile {
  static constexpr int kBN = 64;
  static constexpr int kThreads = 128;
  static constexpr int kStageBytes = (kBM + kBN) * kRow;
  static constexpr int kAccRow = kBN + 8;  // int32 row of the staged accumulators, padded
  static constexpr int kSmemBytes =
      kStages * kStageBytes > kBM * kAccRow * 4 ? kStages * kStageBytes : kBM * kAccRow * 4;
};

enum Act { kNone = 0, kRelu = 1, kTanh = 2, kMish = 3 };
enum Path { kBytes = 0, kWgmma = 1 };

struct Params {
  const int8_t* x;    // source 1: (n, h, w_in, cin1)
  const int8_t* x2;   // source 2: (n, h2, w2, cin2) at (off_y, off_x), or null
  const int8_t* w;    // (cout, kh, kw, cin1 + cin2)
  void* out;          // the compute-dtype output, or null
  int8_t* q[2];       // the int8 outputs (n_q of them)
  const float* qs[2];  // their scales, one float each
  const float* scale;
  const float* bias;    // may be null
  const float* bn_mul;  // null, or both BN vectors given
  const float* bn_add;
  int h, w_in, cin1, cin2, cin, h2, w2, off_y, off_x;
  int cout, kh, kw, pad, ho, wo;
  int m_total, k_total, n_tiles;
  int act, bf16, shuffle, n_q;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
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

// Address of input pixel (ih0 + dy, iw0 + dx), channel c of the concat
// [x, x2 at (off_y, off_x)], of row r; null where it is padding, outside
// x2's extent, or past M.
__device__ __forceinline__ const int8_t* pixel(const Params& p, const RowOrigin& r, int dy, int dx, int c) {
  int ih = r.ih0 + dy;
  int iw = r.iw0 + dx;
  if (r.n < 0 || ih < 0 || ih >= p.h || iw < 0 || iw >= p.w_in) return nullptr;
  if (c < p.cin1) return p.x + (((static_cast<size_t>(r.n) * p.h + ih) * p.w_in + iw) * p.cin1 + c);
  ih -= p.off_y;
  iw -= p.off_x;
  if (ih < 0 || ih >= p.h2 || iw < 0 || iw >= p.w2) return nullptr;
  return p.x2 + (((static_cast<size_t>(r.n) * p.h2 + ih) * p.w2 + iw) * p.cin2 + (c - p.cin1));
}

// Address of A[m, k] for the row origin r, or null where it is padding.
__device__ __forceinline__ const int8_t* a_src(const Params& p, const RowOrigin& r, int k) {
  if (k >= p.k_total) return nullptr;
  const int tap = k / p.cin;
  const int dy = tap / p.kw;
  return pixel(p, r, dy, tap - dy * p.kw, k - tap * p.cin);
}

// Stage the K bytes [k0, k0 + kBK) of the block's A rows and B columns, a
// byte a thread at a time.
__device__ __forceinline__ void load_stage(const Params& p, int8_t* stage, int m0, int n0, int k0) {
  int8_t* As = stage;
  int8_t* Bs = stage + kBM * kRow;
  const int kk = threadIdx.x & (kBK - 1);
  for (int r = threadIdx.x / kBK; r < kBM; r += Tile::kThreads / kBK) {
    const int8_t* src = a_src(p, row_origin(p, m0 + r), k0 + kk);
    As[r * kRow + kk] = src ? *src : 0;
  }
  for (int r = threadIdx.x / kBK; r < Tile::kBN; r += Tile::kThreads / kBK) {
    const int col = n0 + r;
    const bool ok = col < p.cout && k0 + kk < p.k_total;
    Bs[r * kRow + kk] = ok ? p.w[static_cast<size_t>(col) * p.k_total + k0 + kk] : 0;
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

// Conversions run at a quarter of the ALU rate or less on this card, and a
// value of the epilogue would take up to six (int to float, the bf16
// rounding, then a rint and a float-to-int a quantized output); the helpers
// below keep it at one, doing the rest with exact full-rate ALU tricks.

// v rounded to bfloat16 (nearest, ties to even), kept as a float: what a
// bf16 store and reload gives. NaN stays NaN.
__device__ __forceinline__ float round_bf16(float v) {
  const unsigned u = __float_as_uint(v);
  const float r = __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
  return v == v ? r : v;
}

// The epilogue of one int32 sum: dequant, bias, BN, activation, each
// multiply and add rounded on its own as the twin's ops are, then the
// rounding to the compute dtype (what storing it and reading it back does).
__device__ __forceinline__ float epilogue_value(const Params& p, int acc, float s, float b, float m, float a) {
  float v = __fmul_rn(__int2float_rn(acc), s);
  if (p.bias) v = __fadd_rn(v, b);
  if (p.bn_mul) v = __fadd_rn(__fmul_rn(v, m), a);
  if (p.act == kRelu)
    v = fmaxf(v, 0.0f);
  else if (p.act != kNone)
    v = activate_rare(p.act, v);
  return p.bf16 ? round_bf16(v) : v;
}

// x + 1.5 * 2^23 rounds x (|x| <= 2^22) to an integer, half to even, and
// leaves it in the low mantissa bits.
constexpr float kRoundMagic = 12582912.0f;
constexpr int kRoundBits = 0x4B400000;

// One int8 output's scale s and what the division by it needs: 1/s rounded,
// and +-128 s (exact: a power-of-two multiple) to clamp the dividend to.
struct QScale {
  float s, rcp, lim;
};

__device__ __forceinline__ QScale q_scale(const float* s) {
  const float v = s ? *s : 1.0f;
  return {v, __frcp_rn(v), __fmul_rn(128.0f, v)};
}

// True where the quotient's branch-free form below is exact: s far from
// overflow and underflow (every activation scale is).
__device__ __forceinline__ bool q_scale_ok(const QScale& q) { return q.s > 0x1p-60f && q.s < 0x1p60f; }

// clamp(rint(v / s), -127, 127) as conv_int8.py's quant_act computes it on the stored
// value, as an int: the IEEE float32 quotient (torch divides by a
// one-element tensor, not by a reciprocal), rint rounding half to even.
// The dividend is first clamped to +-128 s, which changes no result and
// keeps the quotient within +-128. v * (1/s rounded) is within 1.5 ulp of
// v / s; one residual step q + (v - q s) / s, the residual exact by fma,
// brings it within an ulp, and a second gives the rounded quotient itself
// (Markstein's theorem: 1/s rounded to nearest and a quotient within an ulp
// make the corrected quotient correctly rounded). x + 1.5 * 2^23 rounds half
// to even. No branch and no conversion.
__device__ __forceinline__ int quantize(float v, const QScale& q) {
  const float vc = fminf(fmaxf(v, -q.lim), q.lim);
  float t = __fmul_rn(vc, q.rcp);
  t = __fmaf_rn(__fmaf_rn(-t, q.s, vc), q.rcp, t);
  t = __fmaf_rn(__fmaf_rn(-t, q.s, vc), q.rcp, t);
  t = fminf(fmaxf(t, -127.0f), 127.0f);
  return __float_as_int(__fadd_rn(t, kRoundMagic)) - kRoundBits;
}

// The same with the division itself, for any scale.
__device__ __noinline__ int quantize_div(float v, float s) {
  const float t = fminf(fmaxf(__fdiv_rn(v, s), -127.0f), 127.0f);
  return __float_as_int(__fadd_rn(t, kRoundMagic)) - kRoundBits;
}

__device__ __forceinline__ int quantize_any(float v, const QScale& q) {
  return q_scale_ok(q) ? quantize(v, q) : quantize_div(v, q.s);
}

// Columns col and col + 1 of one output row, one element at a time, to
// every output: the depth-to-space store and odd channel counts. Out of
// line, as above.
__device__ __noinline__ void store_scalar(const Params& p, int row, int col, float y0, float y1, QScale q0, QScale q1) {
  for (int j = 0; j < 2 && col + j < p.cout; ++j) {
    const size_t off = out_offset(p, row, col + j);
    const float y = j ? y1 : y0;
    if (p.out) {
      if (p.bf16)
        static_cast<__nv_bfloat16*>(p.out)[off] = __float2bfloat16_rn(y);
      else
        static_cast<float*>(p.out)[off] = y;
    }
    if (p.n_q > 0) p.q[0][off] = static_cast<int8_t>(quantize_any(y, q0));
    if (p.n_q > 1) p.q[1][off] = static_cast<int8_t>(quantize_any(y, q1));
  }
}

// The epilogue of a tile's staged int32 sums, for the shapes the flagship
// U-Net launches: no bias, folded BN, relu or none, row-major pairs of
// columns (even Cout), NQ int8 outputs and the float one in kOut (0 none,
// 1 bfloat16, 2 float32). A warp owns a whole output row at a time (one
// 64-byte int8 or 128-byte bf16 store a row of 64 channels), a lane two
// columns; the loop body has no branch, so unrolled rows overlap.
template <int kBN, int NQ, int kOut>
__device__ __forceinline__ void rows_fast(const Params& p, const int* staged, int pitch, int rows, int row0, int n0,
                                          int warp, int nwarps) {
  const int lane = threadIdx.x & 31;
  const QScale q0 = q_scale(p.qs[0]), q1 = q_scale(NQ > 1 ? p.qs[1] : nullptr);
  const bool relu = p.act == kRelu;
  const bool bf16 = p.bf16;
  const int n_rows = min(rows, p.m_total - row0);
#pragma unroll
  for (int pass = 0; pass < kBN / 64; ++pass) {
    const int c = pass * 64 + 2 * lane;
    const int col = n0 + c;
    if (col >= p.cout) continue;  // Cout is even: col + 1 is in too
    const float s0 = p.scale[col], s1 = p.scale[col + 1];
    const float m0 = p.bn_mul[col], m1 = p.bn_mul[col + 1];
    const float a0 = p.bn_add[col], a1 = p.bn_add[col + 1];
#pragma unroll 4
    for (int r = warp; r < n_rows; r += nwarps) {
      const int2 acc = *reinterpret_cast<const int2*>(staged + r * pitch + c);
      float y0 = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc.x), s0), m0), a0);
      float y1 = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc.y), s1), m1), a1);
      y0 = relu ? fmaxf(y0, 0.0f) : y0;
      y1 = relu ? fmaxf(y1, 0.0f) : y1;
      // both rounded to bf16 by one packed conversion; the float of a bf16 is
      // its bits in the high half
      const __nv_bfloat162 h = __floats2bfloat162_rn(y0, y1);
      const unsigned hb = *reinterpret_cast<const unsigned*>(&h);
      y0 = bf16 ? __uint_as_float(hb << 16) : y0;
      y1 = bf16 ? __uint_as_float(hb & 0xFFFF0000u) : y1;
      const size_t off = static_cast<size_t>(row0 + r) * p.cout + col;
      if (kOut == 1) *reinterpret_cast<unsigned*>(static_cast<__nv_bfloat16*>(p.out) + off) = hb;
      if (kOut == 2) *reinterpret_cast<float2*>(static_cast<float*>(p.out) + off) = make_float2(y0, y1);
      // the low bytes of the two ints, side by side
      if (NQ > 0)
        *reinterpret_cast<unsigned short*>(p.q[0] + off) =
            static_cast<unsigned short>(__byte_perm(quantize(y0, q0), quantize(y1, q0), 0x0040));
      if (NQ > 1)
        *reinterpret_cast<unsigned short*>(p.q[1] + off) =
            static_cast<unsigned short>(__byte_perm(quantize(y0, q1), quantize(y1, q1), 0x0040));
    }
  }
}

// The same for every other epilogue (bias, tanh, mish, the depth-to-space
// store, odd Cout, extreme scales): branches a value, and calls for the rare
// parts, to keep its code short.
template <int kBN>
__device__ __noinline__ void rows_any(const Params& p, const int* staged, int pitch, int rows, int row0, int n0,
                                      int warp, int nwarps) {
  const int lane = threadIdx.x & 31;
  // row-major NHWC with an even channel count: columns c, c+1 side by side
  const bool pair = p.shuffle <= 1 && (p.cout & 1) == 0;
  const QScale q[2] = {q_scale(p.n_q > 0 ? p.qs[0] : nullptr), q_scale(p.n_q > 1 ? p.qs[1] : nullptr)};
  for (int pass = 0; pass < kBN / 64; ++pass) {
    // this lane's two columns, and their vectors, loaded once
    const int c = pass * 64 + 2 * lane;
    const int col = n0 + c;
    if (col >= p.cout) continue;
    float vs[2], vb[2], vm[2], va[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool ok = col + j < p.cout;
      vs[j] = ok ? p.scale[col + j] : 0.0f;
      vb[j] = ok && p.bias ? p.bias[col + j] : 0.0f;
      vm[j] = ok && p.bn_mul ? p.bn_mul[col + j] : 0.0f;
      va[j] = ok && p.bn_mul ? p.bn_add[col + j] : 0.0f;
    }
    for (int r = warp; r < rows; r += nwarps) {
      const int row = row0 + r;
      if (row >= p.m_total) break;
      const int2 a2 = *reinterpret_cast<const int2*>(staged + r * pitch + c);
      const float y0 = epilogue_value(p, a2.x, vs[0], vb[0], vm[0], va[0]);
      const float y1 = epilogue_value(p, a2.y, vs[1], vb[1], vm[1], va[1]);
      if (!pair) {
        store_scalar(p, row, col, y0, y1, q[0], q[1]);
        continue;
      }
      const size_t off = static_cast<size_t>(row) * p.cout + col;
      if (p.out) {
        if (p.bf16)
          *reinterpret_cast<unsigned*>(static_cast<__nv_bfloat16*>(p.out) + off) =
              __byte_perm(__float_as_uint(y0), __float_as_uint(y1), 0x7632);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + off) = make_float2(y0, y1);
      }
      for (int i = 0; i < p.n_q; ++i)
        *reinterpret_cast<unsigned short*>(p.q[i] + off) =
            static_cast<unsigned short>(__byte_perm(quantize_any(y0, q[i]), quantize_any(y1, q[i]), 0x0040));
    }
  }
}

// The epilogue of a tile's staged int32 sums: `rows` rows of `pitch` int32
// from `staged`, output rows row0..., columns n0 + [0, kBN), by `nwarps`
// warps of which this thread's is `warp`.
template <int kBN>
__device__ __forceinline__ void epilogue_rows(const Params& p, const int* staged, int pitch, int rows, int row0, int n0,
                                              int warp, int nwarps) {
  const bool fast = p.shuffle <= 1 && (p.cout & 1) == 0 && !p.bias && p.bn_mul && p.act <= kRelu &&
                    (p.n_q < 1 || q_scale_ok(q_scale(p.qs[0]))) && (p.n_q < 2 || q_scale_ok(q_scale(p.qs[1])));
  const int out = p.out ? (p.bf16 ? 1 : 2) : 0;
  if (fast && p.n_q == 2 && out == 0)
    rows_fast<kBN, 2, 0>(p, staged, pitch, rows, row0, n0, warp, nwarps);
  else if (fast && p.n_q == 1 && out == 0)
    rows_fast<kBN, 1, 0>(p, staged, pitch, rows, row0, n0, warp, nwarps);
  else if (fast && p.n_q == 0 && out == 1)
    rows_fast<kBN, 0, 1>(p, staged, pitch, rows, row0, n0, warp, nwarps);
  else if (fast && p.n_q == 0 && out == 2)
    rows_fast<kBN, 0, 2>(p, staged, pitch, rows, row0, n0, warp, nwarps);
  else
    rows_any<kBN>(p, staged, pitch, rows, row0, n0, warp, nwarps);
}

// The bytes path: a block computes a 128 x 64 tile with 2 x 2 warps, each
// 64 x 32, as m16n8k32 s8 mma.sync tiles with int32 accumulators; K goes in
// steps of 64 bytes through a kStages-deep ring of shared stages, stored a
// byte a thread, rows padded by 16 bytes so the ldmatrix phases hit
// distinct bank groups.
__global__ void __launch_bounds__(Tile::kThreads) conv2d_int8_bytes(const Params p) {
  using T = Tile;
  extern __shared__ __align__(128) int8_t smem[];

  const int tile_n = blockIdx.x % p.n_tiles;  // Cout tiles fastest: A tiles shared in L2
  const int tile_m = blockIdx.x / p.n_tiles;
  const int m0 = tile_m * kBM;
  const int n0 = tile_n * T::kBN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp & 1) * 64;   // warp's rows in the block tile
  const int wn = (warp >> 1) * 32;  // warp's columns

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
    if (s < k_tiles) load_stage(p, smem + s * T::kStageBytes, m0, n0, s * kBK);
  }

  // ldmatrix lane roles: A x4 = rows 0-7 / 8-15 at bytes 0-15, then at 16-31;
  // B x4 = two n8 tiles, each at bytes 0-15 then 16-31
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 16;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 16;

  for (int kt = 0; kt < k_tiles; ++kt) {
    __syncthreads();  // stage kt is stored; every warp is done with stage kt - 1
    const int next = kt + kStages - 1;
    if (next < k_tiles) load_stage(p, smem + (next % kStages) * T::kStageBytes, m0, n0, next * kBK);

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

  // Stage the accumulators through shared memory (the ring is free now):
  // fragment c[0], c[1] is row g, columns 2t and 2t+1; c[2], c[3] is row
  // g + 8. A padded row of kBN + 8 int32 keeps each half-warp's 8-byte
  // stores on distinct banks.
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

  epilogue_rows<T::kBN>(p, staged, T::kAccRow, kBM, m0, n0, warp, T::kThreads / 32);
}

cudaError_t launch_bytes(Params p, cudaStream_t s) {
  p.n_tiles = (p.cout + Tile::kBN - 1) / Tile::kBN;
  const long long blocks = (static_cast<long long>(p.m_total) + kBM - 1) / kBM * p.n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(conv2d_int8_bytes, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kSmemBytes);
  if (err != cudaSuccess) return err;
  conv2d_int8_bytes<<<static_cast<unsigned>(blocks), Tile::kThreads, Tile::kSmemBytes, s>>>(p);
  return cudaGetLastError();
}

// ---- The Hopper mainloop: TMA + mbarrier ring, wgmma, persistent blocks ----

constexpr int kATileBytes = kBM * kBK;  // 128 pixels x 64 channels, one im2col box
constexpr int kSmPerSm = 233472;        // shared memory an SM, 1 KB of it reserved for each block
// The epilogue warps of a 128-column block: with 4, down_0/conv1 ran 27%
// slower than with 8; 10 or more leave the consumers fewer registers than
// an m64n128 wgmma needs.
constexpr int kEpilogueWarps = 8;

// A 128 x BN output tile, computed by both consumer warpgroups together, 64
// rows each; K steps come from producer warps, each filling its own stages
// of the ring: 2 in a block of two an SM, CONV_PRODUCERS in a block alone
// (on an H100, 4 against 2 ran the one-block sites 1-7% faster and, with
// the ring cut to 4 stages, the two-block ones 5-8% slower). 64 columns:
// two blocks an SM, the consumers
// running the epilogue themselves, so one block's epilogue overlaps the
// other's mainloop. 128 columns: one block an SM, with kEpilogueWarps
// epilogue warps besides; the consumers hand them a tile's sums through
// one of two staging buffers and go on with the next tile's mainloop. 256
// columns: one block an SM, where two buffers do not fit; the consumers
// run the epilogue themselves, 128 columns at a time, while the producers
// fill the ring for the next tile.
template <int BN>
struct WgTile {
  static constexpr bool kEpiWarps = BN == 128;
  static constexpr int kBlocks = BN == 64 ? 2 : 1;  // an SM
  static constexpr int kProducers = kBlocks == 2 ? 2 : CONV_PRODUCERS;
  static constexpr int kThreads = 256 + 32 * kProducers + (kEpiWarps ? 32 * kEpilogueWarps : 0);
  static constexpr int kBTileBytes = BN * kBK;
  static constexpr int kStageBytes = kATileBytes + kBTileBytes;
  static constexpr int kStagedCols = BN < 128 ? BN : 128;  // columns staged at a time
  static constexpr int kPitch = kStagedCols + 8;           // int32 row of the staged sums, padded
  static constexpr int kStagingBytes = kBM * kPitch * 4;   // a tile's rows (one buffer)
  static constexpr int kBuffers = kEpiWarps ? 2 : 1;
  // the barriers (full, empty a stage; staged, drained a buffer) and 1024 B
  // to align the ring by hand (the swizzle repeats every 512 B)
  static constexpr int kExtraBytes = 1024 + 2 * 8 * (CONV_TMA_STAGES + 2);
  static constexpr int kFitStages = (kSmPerSm / kBlocks - 1024 - kExtraBytes - kBuffers * kStagingBytes) / kStageBytes;
  // a multiple of the producers, so that each stage has one producer
  static constexpr int kRing = (CONV_TMA_STAGES < kFitStages ? CONV_TMA_STAGES : kFitStages) / kProducers * kProducers;
  static constexpr int kBarrierOffset = kRing * kStageBytes + kBuffers * kStagingBytes;
  static constexpr int kSmemBytes = kBarrierOffset + 2 * 8 * (kRing + 2) + 1024;
  static_assert(kRing >= 2 && kBlocks * (kSmemBytes + 1024) <= kSmPerSm, "a block's shared memory");
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`. A wait
// that lasts seconds can only be a fault: it traps, so the launch fails
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  for (unsigned polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// One im2col box: the 64 channels from c of the 128 pixels that follow
// (w, h, n) in the map's traversal, each shifted by the filter tap (dx, dy).
__device__ __forceinline__ void tma_im2col(void* dst, const CUtensorMap* map, int c, int w, int h, int n, int dx,
                                           int dy, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(w), "r"(h), "r"(n),
      "h"(static_cast<unsigned short>(dx)), "h"(static_cast<unsigned short>(dy))
      : "memory");
}

__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map, int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

// Brings a tensor map into the TMA unit's descriptor cache ahead of its
// first copy.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// The wgmma descriptor of a K-major tile of 64-byte rows in 64-byte-swizzled
// shared memory: 8-row groups 512 B apart; the leading offset is unused.
__device__ __forceinline__ uint64_t gmma_desc(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(512 >> 4) << 32) |
         (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmma that owns them.
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}


// D (64 x 64, int32) += A (64 x 32 bytes) * B (64 x 32 bytes)^T, both K-major in
// 64-byte-swizzled shared memory; scale_d = 0 overwrites D instead.
__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 128, int32) += A (64 x 32 bytes) * B (128 x 32 bytes)^T, both K-major in
// 64-byte-swizzled shared memory; scale_d = 0 overwrites D instead.
__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 256, int32) += A (64 x 32 bytes) * B (256 x 32 bytes)^T, the same.
__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_k32(int (&d)[BN / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BN == 64)
    wgmma_n64(d, da, db, scale_d);
  else if constexpr (BN == 128)
    wgmma_n128(d, da, db, scale_d);
  else
    wgmma_n256(d, da, db, scale_d);
}

// Persistent blocks walk the (M / 128) x (Cout / BN) output tiles, Cout
// tiles fastest, so the blocks in flight share their A rows in L2. Warps
// 8, ... are the producers: one lane of each issues, for each K step of its
// stages (one filter tap, 64 channels of one source), an im2col TMA box of
// A and a tiled TMA box of the weights into the ring, and the hardware
// reports the bytes to the stage's `full` barrier. Warpgroups 0 and 1 are
// the consumers, rows 0-63 and 64-127 of the tile: two m64nBNk32 wgmma a
// stage, one commit group kept in flight, the stage released on `empty`
// once its group retires. After a tile's last step the consumers store
// their sums in a staging buffer: with epilogue warps (the warps after the
// producers) they signal its `staged` barrier and go on with the next tile
// while those run the epilogue and release the buffer on `drained`;
// without, they run the epilogue themselves.
template <int BN>
__global__ void __launch_bounds__(WgTile<BN>::kThreads, WgTile<BN>::kBlocks)
    conv2d_int8_wgmma(const __grid_constant__ Params p, const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_x2, const __grid_constant__ CUtensorMap map_w) {
  using T = WgTile<BN>;
  constexpr int kRing = T::kRing;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int* const staging = reinterpret_cast<int*>(smem + kRing * T::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kBarrierOffset);
  uint64_t* empty = full + kRing;
  uint64_t* staged = empty + kRing;  // a staging buffer holds a tile's sums
  uint64_t* drained = staged + 2;    // the epilogue warps are done with it

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // an arrival from each consumer warpgroup
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&staged[b], 256);                    // every consumer thread
      mbar_init(&drained[b], 32 * kEpilogueWarps);  // every epilogue thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles = (p.m_total + kBM - 1) / kBM * p.n_tiles;
  const int taps = p.kh * p.kw;
  const int c_steps = p.cin / kBK;
  const int hw = p.ho * p.wo;
  const int warp = threadIdx.x >> 5;

  if (warp >= 8 && warp < 8 + T::kProducers) {  // a producer: stages warp - 8, warp - 8 + kProducers, ...
    if ((threadIdx.x & 31) != 0) return;
    prefetch_map(&map_x);
    prefetch_map(&map_x2);
    prefetch_map(&map_w);
    int stage = 0;
    unsigned phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / p.n_tiles * kBM;
      const int n0 = tile % p.n_tiles * BN;
      const int img = m0 / hw;
      const int rem = m0 - img * hw;
      const int h0 = rem / p.wo - p.pad;
      const int w0 = rem % p.wo - p.pad;
      for (int tap = 0; tap < taps; ++tap) {
        const int dy = tap / p.kw;
        const int dx = tap - dy * p.kw;
        for (int cs = 0; cs < c_steps; ++cs) {
          const int c = cs * kBK;
          if (stage % T::kProducers == warp - 8) {
            mbar_wait(&empty[stage], phase ^ 1);
            uint8_t* a = smem + stage * T::kStageBytes;
            mbar_expect_tx(&full[stage], T::kStageBytes);
            if (c < p.cin1)
              tma_im2col(a, &map_x, c, w0, h0, img, dx, dy, &full[stage]);
            else
              tma_im2col(a, &map_x2, c - p.cin1, w0 - p.off_x, h0 - p.off_y, img, dx, dy, &full[stage]);
            tma_tile(a + kATileBytes, &map_w, tap * p.cin + c, n0, &full[stage]);
          }
          if (++stage == kRing) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  if (warp >= 8) {  // an epilogue warp: the block's tiles in order, buffers in turn
    if constexpr (T::kEpiWarps) {
      for (int tile = blockIdx.x, i = 0; tile < tiles; tile += gridDim.x, ++i) {
        const int b = i & 1;
        mbar_wait(&staged[b], (i >> 1) & 1);
        epilogue_rows<BN>(p, staging + b * (T::kStagingBytes / 4), T::kPitch, kBM, tile / p.n_tiles * kBM,
                          tile % p.n_tiles * BN, warp - 8 - T::kProducers, kEpilogueWarps);
        mbar_arrive(&drained[b]);
      }
    }
    return;
  }

  // a consumer warpgroup: rows [64 wg, 64 wg + 64) of every tile
  const int wg = warp >> 2;
  const int lane = threadIdx.x & 31;
  const int k_steps = taps * c_steps;
  int acc[BN / 2];
  int stage = 0;
  unsigned phase = 0;
  for (int tile = blockIdx.x, i = 0; tile < tiles; tile += gridDim.x, ++i) {
    int prev = 0;
    for (int ks = 0; ks < k_steps; ++ks) {
      mbar_wait(&full[stage], phase);
      __syncwarp();  // converged again for the .aligned wgmma
      const uint8_t* a = smem + stage * T::kStageBytes;
      const uint64_t da = gmma_desc(a + wg * 64 * kBK);
      const uint64_t db = gmma_desc(a + kATileBytes);
      wgmma_fence();
      fence_regs(acc);
      wgmma_k32<BN>(acc, da, db, ks > 0);
      wgmma_k32<BN>(acc, da + 2, db + 2, 1);  // the next 32 bytes of K: start address + 32 B
      wgmma_commit();
      fence_regs(acc);
      if (ks > 0) {
        wgmma_wait<1>();  // the previous step's group has retired: its stage is free
        if ((threadIdx.x & 127) == 0) mbar_arrive(&empty[prev]);
      }
      prev = stage;
      if (++stage == kRing) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if ((threadIdx.x & 127) == 0) mbar_arrive(&empty[prev]);

    // store the sums, at most 128 columns at a time: register 4j + {0, 1} is
    // row g, columns 8j + 2t + {0, 1} of the warp's 16 rows; 4j + {2, 3} row g + 8
    const int b = T::kEpiWarps ? i & 1 : 0;
    int* const rows = staging + b * (T::kStagingBytes / 4) + (64 * wg + (warp & 3) * 16 + (lane >> 2)) * T::kPitch +
                      2 * (lane & 3);
#pragma unroll
    for (int c = 0; c < BN / T::kStagedCols; ++c) {
      if constexpr (T::kEpiWarps)
        mbar_wait(&drained[b], ((i >> 1) & 1) ^ 1);  // the epilogue warps are done with the buffer's tile before
      else
        named_barrier(1 + wg, 128);  // this warpgroup is done with its staged sums before
#pragma unroll
      for (int jj = 0; jj < T::kStagedCols / 8; ++jj) {
        const int j = c * T::kStagedCols / 8 + jj;
        *reinterpret_cast<int2*>(rows + 8 * jj) = make_int2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<int2*>(rows + 8 * T::kPitch + 8 * jj) = make_int2(acc[4 * j + 2], acc[4 * j + 3]);
      }
      if constexpr (T::kEpiWarps) {
        mbar_arrive(&staged[b]);
      } else {
        named_barrier(1 + wg, 128);
        epilogue_rows<T::kStagedCols>(p, staging + 64 * wg * T::kPitch, T::kPitch, 64, tile / p.n_tiles * kBM + 64 * wg,
                                      tile % p.n_tiles * BN + c * T::kStagedCols, warp & 3, 4);
      }
    }
  }
}

// cuTensorMapEncode{Tiled,Im2col}, from libcuda through the runtime's
// entry-point query: no -lcuda at build time.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
typedef CUresult (*EncodeIm2col)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const int*, const int*, cuuint32_t, cuuint32_t, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

template <typename Fn>
cudaError_t entry_point(const char* name, Fn* fn) {
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(name, reinterpret_cast<void**>(fn), 12000, cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint(name, reinterpret_cast<void**>(fn), cudaEnableDefault, &found);
#endif
  if (err == cudaSuccess && found != cudaDriverEntryPointSuccess) err = cudaErrorSymbolNotFound;
  return err;
}

// The im2col map of one NHWC source whose traversal visits, for every
// output pixel in M order, the input pixel (ho - pad - off_y, wo - pad -
// off_x) of the source: its bounding box spans wo x ho start pixels, from
// -pad - off on each axis. 64 channels a pixel, 128 pixels a box, the box
// 64-byte swizzled as wgmma reads it; out-of-bounds pixels are zero (the
// conv's padding, and the concat's zeros around x2).
cudaError_t im2col_map(EncodeIm2col encode, CUtensorMap* map, const void* x, int n, int h, int w, int c, int off_y,
                       int off_x, const Params& p) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(w), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(w) * c,
                                 static_cast<cuuint64_t>(h) * w * c};
  const int lower[2] = {-p.pad - off_x, -p.pad - off_y};
  const int upper[2] = {p.wo - p.pad - off_x - w, p.ho - p.pad - off_y - h};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), dims, strides, lower, upper,
                            kBK, kBM, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Device facts a launch needs, queried once for each device and kept here
// (0: not queried yet); two threads that query at once store the same value.
constexpr int kMaxDevices = 64;

// The SMs of `device` (the launches read it to size the grid and pick a tile).
cudaError_t sm_count(int device, int* sms) {
  static std::atomic<int> known[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  *sms = known[device].load(std::memory_order_relaxed);
  if (*sms > 0) return cudaSuccess;
  const cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) known[device].store(*sms, std::memory_order_relaxed);
  return err;
}

// How many blocks of conv2d_int8_wgmma<BN> an SM of `device` holds, after
// the kernel's shared-memory attributes are set there.
template <int BN>
cudaError_t blocks_per_sm(int device, int* per_sm) {
  using T = WgTile<BN>;
  static std::atomic<int> known[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  *per_sm = known[device].load(std::memory_order_relaxed);
  if (*per_sm > 0) return cudaSuccess;
  const auto kernel = conv2d_int8_wgmma<BN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  // all of the SM's unified L1 as shared memory: room for kBlocks blocks
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, T::kThreads, T::kSmemBytes);
  if (err == cudaSuccess && *per_sm < 1) err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess) known[device].store(*per_sm, std::memory_order_relaxed);
  return err;
}

template <int BN>
cudaError_t launch_wgmma(Params p, int n, int device, int sms, cudaStream_t s) {
  using T = WgTile<BN>;
  static EncodeTiled encode_tiled = nullptr;
  static EncodeIm2col encode_im2col = nullptr;
  cudaError_t err = cudaSuccess;
  if (!encode_tiled) err = entry_point("cuTensorMapEncodeTiled", &encode_tiled);
  if (err == cudaSuccess && !encode_im2col) err = entry_point("cuTensorMapEncodeIm2col", &encode_im2col);
  if (err != cudaSuccess) return err;

  CUtensorMap map_x, map_x2, map_w;
  err = im2col_map(encode_im2col, &map_x, p.x, n, p.h, p.w_in, p.cin1, 0, 0, p);
  if (err == cudaSuccess)
    err = p.x2 ? im2col_map(encode_im2col, &map_x2, p.x2, n, p.h2, p.w2, p.cin2, p.off_y, p.off_x, p)
               : im2col_map(encode_im2col, &map_x2, p.x, n, p.h, p.w_in, p.cin1, 0, 0, p);  // never read
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.k_total), static_cast<cuuint64_t>(p.cout)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.k_total)};
  const cuuint32_t box[2] = {kBK, BN};
  const cuuint32_t elem[2] = {1, 1};
  if (encode_tiled(&map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(p.w), dims, strides, box, elem,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;

  p.n_tiles = (p.cout + BN - 1) / BN;
  const long long tiles = (static_cast<long long>(p.m_total) + kBM - 1) / kBM * p.n_tiles;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  int per_sm;
  err = blocks_per_sm<BN>(device, &per_sm);
  if (err != cudaSuccess) return err;
  const long long slots = static_cast<long long>(sms) * per_sm;  // persistent blocks, all resident at once
  const long long blocks = tiles < slots ? tiles : slots;
  conv2d_int8_wgmma<BN><<<static_cast<unsigned>(blocks), T::kThreads, T::kSmemBytes, s>>>(p, map_x, map_x2, map_w);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` without synchronizing. x: int8 (n, h, w, cin); x2:
// null, or int8 (n, h2, w2, cin2), read as channels [cin, cin + cin2) of the
// input at pixel (y - off_y, x - off_x) (zero outside it; it must lie inside
// h x w); w: int8 (cout, kh, kw, cin + cin2). Outputs (n, ho, wo, cout), or
// with shuffle = s > 1 and kh = kw = 1, pad = 0, the (n, s*h, s*w, cout / s^2)
// depth-to-space layout: out, where not null, in the compute dtype (float32,
// bf16 = 0, or bfloat16), and n_q int8 outputs q0, q1 quantized at the scales
// *qs0, *qs1. scale, and bias, bn_mul, bn_add where not null, are float32
// (cout,). act: 0 none, 1 relu, 2 tanh, 3 mish. Sets *path to the mainloop
// taken (0 bytes, 1 wgmma). Returns cudaGetLastError() after the launch,
// or the error that kept it from launching (0 = success).
extern "C" int conv2d_int8(const void* x, const void* x2, const void* w, void* out, void* q0, void* q1,
                           const float* scale, const float* bias, const float* bn_mul, const float* bn_add,
                           const float* qs0, const float* qs1, int n, int h, int w_in, int cin, int h2, int w2,
                           int cin2, int off_y, int off_x, int cout, int kh, int kw, int pad, int act, int bf16,
                           int shuffle, int n_q, int* path, void* stream) {
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.x2 = static_cast<const int8_t*>(x2);
  p.w = static_cast<const int8_t*>(w);
  p.out = out;
  p.q[0] = static_cast<int8_t*>(q0);
  p.q[1] = static_cast<int8_t*>(q1);
  p.qs[0] = qs0;
  p.qs[1] = qs1;
  p.scale = scale;
  p.bias = bias;
  p.bn_mul = bn_mul;
  p.bn_add = bn_add;
  p.h = h;
  p.w_in = w_in;
  p.cin1 = cin;
  p.cin2 = x2 ? cin2 : 0;
  p.cin = p.cin1 + p.cin2;
  p.h2 = h2;
  p.w2 = w2;
  p.off_y = off_y;
  p.off_x = off_x;
  p.cout = cout;
  p.kh = kh;
  p.kw = kw;
  p.pad = pad;
  p.ho = h + 2 * pad - kh + 1;
  p.wo = w_in + 2 * pad - kw + 1;
  p.act = act;
  p.bf16 = bf16;
  p.shuffle = shuffle;
  p.n_q = n_q;
  const long long m_total = static_cast<long long>(n) * p.ho * p.wo;
  const long long k_total = static_cast<long long>(kh) * kw * p.cin;
  if (m_total <= 0 || cout <= 0) return 0;
  // rows and K positions are int, a tile past their ends included; every
  // memory offset is size_t
  if (m_total > 0x7fffffffLL - kBM || k_total > 0x7fffffffLL - kBK) return static_cast<int>(cudaErrorInvalidValue);
  if (n_q < 0 || n_q > 2 || (n_q == 0 && !out)) return static_cast<int>(cudaErrorInvalidValue);
  p.m_total = static_cast<int>(m_total);
  p.k_total = static_cast<int>(k_total);
  const auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  const bool wgmma = aligned(x) && aligned(w) && p.cin1 % kBK == 0 && (!x2 || (aligned(x2) && p.cin2 % kBK == 0));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  *path = wgmma ? kWgmma : kBytes;
  if (!wgmma) return static_cast<int>(launch_bytes(p, s));
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 256 columns where that still gives every SM a tile and the mainloop is
  // long against the epilogue that the consumers then run themselves: 72
  // K steps or more, or no int8 output to quantize
  const long long m_tiles = (m_total + kBM - 1) / kBM;
  const bool long_k = k_total >= 72 * kBK || n_q == 0;
  if (cout <= 64)
    err = launch_wgmma<64>(p, n, device, sms, s);
  else if (cout >= 256 && long_k && m_tiles * ((cout + 255) / 256) >= sms)
    err = launch_wgmma<256>(p, n, device, sms, s);
  else
    err = launch_wgmma<128>(p, n, device, sms, s);
  return static_cast<int>(err);
}
