// The epilogue of a float conv in one pass, for Hopper (sm_90a): the
// conv's bias or the folded eval BatchNorm, the activation, the rounding to
// the compute dtype and, where an int8 conv reads the result, its int8
// quantization; or the bias and a residual unit's skip add.
//
// Replaces the elementwise passes that XLA fuses into the JAX package's
// float convs' epilogues:
//   gelslim_depth_tpu/models/unet.py:197   _batch_norm's eval affine, and
//   gelslim_depth_tpu/models/unet.py:229   _double_conv's activation and
//     cast after it, at each DoubleConv conv;
//   gelslim_depth_tpu/models/unet.py:275   the upconv's bias add;
//   gelslim_depth_tpu/models/quantize.py:156  _quant_act of a float conv's
//     output (inc/conv1, the float upconvs) for the next int8 conv.
// None is a Pallas kernel. Without it the port runs them as aten's separate
// passes: up to eight over a float32 temporary for inc/conv1 of the int8
// graph, four for each BatchNorm site of the float graph. In the
// transformers' heads (no JAX counterpart) it replaces the bias add that
// PyTorch runs after a cuDNN conv (a broadcast add on a channels-last
// output, which falls to aten's strided elementwise kernel at ~38% of its
// byte bound) and, at each residual unit's second conv, the skip add after
// it.
//
// What it computes, for y (N, C, H, W) in bfloat16 or float32, either
// NCHW-contiguous or channels-last (NHWC in memory), in one of three forms
// (round: to y's dtype):
//   a conv's bias (C,), in y's dtype:       v = round(y + bias[c])
//   a BatchNorm's float32 (C,) vectors and its activation (relu | tanh | mish):
//                                           v = round(act(y * bn_mul[c] + bn_add[c]))
//   out = v, in y's dtype and memory layout; or, given a one-element
//   float32 scale s, out = clamp(rint(v / s), -127, 127) as int8 NHWC
//   (N, H, W, C): IEEE division, half to even, NaN to 0.
//   the residual form, a bias and a residual x of y's shape, dtype and layout:
//                                           out = round(round(y + bias[c]) + x)
// The U-Net calls the first two; the DPT head and Depth Pro's decoder and
// head the bias form at each other conv that has a bias, and the residual
// form at the second conv of each ResidualConvUnit (7 a DPT call, 9 a
// Depth Pro call), where the chain was a bias add, then the skip add.
// The destination form (conv_epilogue_into) stores the bias or BatchNorm
// form's out = v of a channels-last y into one or two given views of y's
// shape (channels contiguous, any N, H and W strides) instead of a tensor
// of its own: the bf16 U-Net's concat buffers, so that aten's pad and
// concat (a copy of the upconv's output, then a read and a write of both
// halves) do not run. At up_3 (128 x 64 x 160 x 213) the skip's two stores
// make 0.84 GB moved against 0.56 for one (0.50 ms and 0.33 at 3.35 TB/s).
// Each multiply and add is rounded on its own (__fmul_rn, __fadd_rn, no
// contracted FMA) and rounded where PyTorch's separate ops round (a bf16 +
// bf16 add is a float32 add rounded to bf16; the BN affine and the
// activation stay float32 until the cast), so the kernel equals that chain
// of ops bit for bit: relu, the flagship's activation, and the quantize
// step exactly; tanh and mish where libdevice's tanhf, expf and log1pf equal
// the ones PyTorch was built with (they did with nvcc 12.9 against PyTorch
// 2.11 built for CUDA 12.8).
//
// Bound on this card: bytes, a few ALU operations an element. At the
// flagship's N=64 dual frames (128 finger images) inc/conv1's 279 M bf16
// elements in and int8 out are 0.84 GB, 0.25 ms at the H100 SXM's 3.35 TB/s;
// the float graph's 18 BatchNorm sites move 2.12 G bf16 elements in and out,
// 8.5 GB, 2.5 ms. The residual form reads y and x and writes out: at Depth
// Pro's 16 x 256 x 384 x 384 bf16 map, 3.6 GB, 1.08 ms (the bias form 0.72).
//
// Design. One pass over flat vectors of 8 consecutive elements: a 16-B
// load of bf16 (two of float32), a 16-B store (8 B of int8), neighbouring
// threads on neighbouring vectors. A thread loads 4 vectors, a block of
// 128 threads apart, before it computes any, for bytes in flight; the
// flagship's tensors give thousands of blocks for the 132 SMs. Channels-
// last: a vector is 8 channels of one pixel (C a multiple of 8), and where
// C divides the 1,024 elements between a thread's vectors their parameters
// are loaded once, as 16-B vectors. NCHW: a vector lies in one (n, c)
// plane or crosses into the next (a plane holds at least 8: the flagship's
// smallest is 10 x 13), so a thread loads two channels' parameters and
// picks per element. Flat vectors rather than a block a plane: the deep
// planes hold 130 elements, too few to fill a block, and start off 16 B.
// An int8 output of an NCHW y is stored a byte at a time (NHWC). The
// residual form loads x's vectors beside y's, at the same offsets. The
// destination form finds each vector's pixel (n, h, w) by division and
// stores it at n * sN + h * sH + w * sW + c in each view, where those
// strides are multiples of 8 and the views 16-B aligned. Indices
// are 32-bit: a tensor of 2^32 elements or more (Depth Pro's transposed
// conv to 1536 x 1536 x 128 at 16 images) is launched a run of whole
// images at a time, each run below 2^32. Anything else (misaligned
// pointers, other C or plane sizes, an image of 2^32 elements or more)
// takes a plain loop of one element a thread, and the last total % 8
// elements of a vector launch too.
//
// At 3 bytes an element (bf16 in, int8 out) the card moves ~4.3 elements
// an SM a cycle, so the epilogue has ~30 instructions an element before it,
// not the memory, is the limit, and the exact quotient takes 12. So the
// form (bias, BatchNorm and relu, BatchNorm and tanh or mish, bias and
// residual) is compiled in, a pair of values is rounded to bf16 by one
// conversion, and the int8 bytes are packed by byte permutes. A sweep of the launch shape on the
// H100 (PERF.md section 6) chose 128 threads and 4 vectors a thread: the
// int8 graph's 5 sites reach 87% of their byte bound, the bf16 graph's 22
// sites 88%.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The launch shape: threads a block, and vectors of 8 elements a thread
// (loaded together before any is computed).
constexpr int kThreads = 128;
constexpr int kSub = 4;
constexpr int kVec = 8;  // elements a vector

enum Act { kNone = 0, kRelu = 1, kTanh = 2, kMish = 3 };
// An instantiation's form, by its activation: kNone the upconv's bias, kRelu
// a BatchNorm and relu, kRare a BatchNorm and tanh or mish (read from
// Params at run time).
constexpr int kRare = 4;

struct Params {
  const void* y;
  void* out;
  const void* bias;      // y's dtype; null with a BatchNorm
  const float* bn_mul;   // null with a bias
  const float* bn_add;   // null with a bias
  const float* q_scale;  // null: store in y's dtype
  const void* residual;  // y's dtype and layout; null but in the residual form
  long long total;  // N * C * H * W
  long long hw;     // H * W
  int c;
  unsigned c_mask;  // C - 1 where C is a power of two, else 0
  int act;          // kNone with a bias, else the BatchNorm's activation
  bool cl_shared;   // kThreads * 8 a multiple of C (read by channels-last launches)
};

// relu keeps NaN, as torch.relu does; tanh and mish out of line (the
// flagship runs relu). mish is x * tanh(softplus(x)), softplus with
// PyTorch's threshold of 20, as the U-Net's three float32 ops compute it.
__device__ __noinline__ float activate_rare(int act, float v) {
  if (act == kTanh) return tanhf(v);
  const float sp = v > 20.0f ? v : log1pf(expf(v));
  return __fmul_rn(v, tanhf(sp));
}

__device__ __forceinline__ float activate(int act, float v) {
  if (act == kRelu) return v > 0.0f || v != v ? v : 0.0f;
  return act == kNone ? v : activate_rare(act, v);
}

// Values rounded to bfloat16 (nearest, ties to even; NaN stays NaN) and
// kept as floats: one conversion a pair, as PyTorch's float-to-bf16 cast.
__device__ __forceinline__ void round_pair(float& lo, float& hi) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  const unsigned u = *reinterpret_cast<const unsigned*>(&r);
  lo = __uint_as_float(u << 16);
  hi = __uint_as_float(u & 0xFFFF0000u);
}

__device__ __forceinline__ float round_one(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// The epilogue of 8 elements in place, each with its channel's parameters
// a[k] (bias or bn_mul) and b[k] (bn_add): what the chain of PyTorch ops
// leaves in y's dtype, held in floats. A bias add rounds to bf16 at once
// (a bf16 + bf16 add); the BN affine and the activation stay float32 until
// the cast. The form (kAct) is compiled in: run-time selects per element
// cost more than the epilogue itself. Where an int8 output follows, relu
// may drop NaN: NaN quantizes to 0 either way.
template <bool kBf16, bool kQ, int kAct, int kN>
__device__ __forceinline__ void epilogue(const Params& p, float (&v)[kN], const float (&a)[kN], const float (&b)[kN]) {
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    if (kAct == kNone) {
      v[k] = __fadd_rn(v[k], a[k]);
    } else {
      v[k] = __fadd_rn(__fmul_rn(v[k], a[k]), b[k]);
      if (kAct == kRelu) v[k] = kQ ? fmaxf(v[k], 0.0f) : activate(kRelu, v[k]);
      if (kAct == kRare) v[k] = activate_rare(p.act, v[k]);
    }
  }
  if (kBf16) {
#pragma unroll
    for (int k = 0; k < kN; k += 2) round_pair(v[k], v[k + 1]);
  }
}

// x + 1.5 * 2^23 rounds x (|x| <= 2^22) to an integer, half to even, and
// leaves it in the low mantissa bits: the low byte is its int8.
constexpr float kRoundMagic = 12582912.0f;

// The int8 output's scale s, 1/s rounded, and +-128 s (exact: a power-of-two
// multiple) to clamp the dividend to.
struct QScale {
  float s, rcp, lim;
  bool fast;
};

__device__ __forceinline__ QScale q_scale(const float* s) {
  const float v = s ? __ldg(s) : 1.0f;
  return {v, __frcp_rn(v), __fmul_rn(128.0f, v), v > 0x1p-60f && v < 0x1p60f};
}

// clamp(rint(v / s), -127, 127) in the low byte of an int: the IEEE float32
// quotient (PyTorch divides by the one-element scale tensor, not by a
// reciprocal), rint half to even, NaN to 0 (as PyTorch's float-to-int8
// cast). The dividend is clamped to +-128 s first, which changes no result;
// v * (1/s rounded) is within 1.5 ulp of v / s, and two residual steps
// q + (v - q s) / s, the residual exact by fma, give the correctly rounded
// quotient (Markstein's theorem), for any s far from overflow and
// underflow; other scales divide.
__device__ __forceinline__ int quantize(float v, const QScale& q) {
  float t;
  if (q.fast) {
    const float vc = fminf(fmaxf(v, -q.lim), q.lim);
    t = __fmul_rn(vc, q.rcp);
    t = __fmaf_rn(__fmaf_rn(-t, q.s, vc), q.rcp, t);
    t = __fmaf_rn(__fmaf_rn(-t, q.s, vc), q.rcp, t);
  } else {
    t = __fdiv_rn(v, q.s);
  }
  t = fminf(fmaxf(t, -127.0f), 127.0f);
  return v == v ? __float_as_int(__fadd_rn(t, kRoundMagic)) : 0;
}

__device__ __forceinline__ float load1(const __nv_bfloat16* y, long long i) { return __bfloat162float(y[i]); }
__device__ __forceinline__ float load1(const float* y, long long i) { return y[i]; }

__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[kVec]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void unpack8(const float4& a, const float4& b, float (&v)[kVec]) {
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// 8 elements from a 16-B aligned address, read once (evict first).
__device__ __forceinline__ void load8(const __nv_bfloat16* y, unsigned e, float (&v)[kVec]) {
  unpack8(__ldcs(reinterpret_cast<const uint4*>(y + e)), v);
}
__device__ __forceinline__ void load8(const float* y, unsigned e, float (&v)[kVec]) {
  const float4* p = reinterpret_cast<const float4*>(y + e);
  unpack8(__ldcs(p), __ldcs(p + 1), v);
}

// 8 parameters from a 16-B aligned address, through the read-only cache.
__device__ __forceinline__ void param8(const __nv_bfloat16* p, unsigned c0, float (&v)[kVec]) {
  unpack8(__ldg(reinterpret_cast<const uint4*>(p + c0)), v);
}
__device__ __forceinline__ void param8(const float* p, unsigned c0, float (&v)[kVec]) {
  const float4* q = reinterpret_cast<const float4*>(p + c0);
  unpack8(__ldg(q), __ldg(q + 1), v);
}

// 8 values of y's dtype (bf16 ones already rounded) to a 16-B aligned address.
__device__ __forceinline__ void store8(__nv_bfloat16* out, unsigned e, const float (&v)[kVec]) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = __byte_perm(__float_as_uint(v[2 * k]), __float_as_uint(v[2 * k + 1]), 0x7632);
  *reinterpret_cast<uint4*>(out + e) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store8(float* out, unsigned e, const float (&v)[kVec]) {
  *reinterpret_cast<float4*>(out + e) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(out + e + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// The low bytes of four quantize() results, packed.
__device__ __forceinline__ unsigned pack4(int q0, int q1, int q2, int q3) {
  return __byte_perm(__byte_perm(q0, q1, 0x0040), __byte_perm(q2, q3, 0x0040), 0x5410);
}

// One element, any layout and size: the fallback loop and a vector
// launch's tail. NHWC offset of NCHW element i: ((n * hw + pos) * C + c).
template <typename T, bool kQ, bool kCL, bool kRes>
__device__ __forceinline__ void one_element(const Params& p, long long i) {
  long long c, q_off = i;
  if (kCL) {
    c = i % p.c;
  } else {
    const long long plane = i / p.hw, pos = i - plane * p.hw;
    c = plane % p.c;
    q_off = ((plane / p.c) * p.hw + pos) * p.c + c;
  }
  float v = load1(static_cast<const T*>(p.y), i);
  if (p.act == kNone)
    v = __fadd_rn(v, load1(static_cast<const T*>(p.bias), c));
  else
    v = activate(p.act, __fadd_rn(__fmul_rn(v, __ldg(p.bn_mul + c)), __ldg(p.bn_add + c)));
  if (sizeof(T) == 2) v = round_one(v);
  if (kRes) {
    v = __fadd_rn(v, load1(static_cast<const T*>(p.residual), i));
    if (sizeof(T) == 2) v = round_one(v);
  }
  if (kQ)
    static_cast<int8_t*>(p.out)[q_off] = static_cast<int8_t>(quantize(v, q_scale(p.q_scale)));
  else if (sizeof(T) == 2)
    static_cast<__nv_bfloat16*>(p.out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p.out)[i] = v;
}

template <typename T, bool kQ, bool kCL, bool kRes>
__global__ void __launch_bounds__(kThreads) conv_epilogue_loop(Params p) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < p.total; i += stride)
    one_element<T, kQ, kCL, kRes>(p, i);
}

// The skip add of the residual form on 8 values that the bias add left
// rounded: a second op of y's dtype, rounded again.
template <bool kBf16>
__device__ __forceinline__ void add_residual(float (&v)[kVec], const float (&r)[kVec]) {
#pragma unroll
  for (int k = 0; k < kVec; ++k) v[k] = __fadd_rn(v[k], r[k]);
  if (kBf16) {
#pragma unroll
    for (int k = 0; k < kVec; k += 2) round_pair(v[k], v[k + 1]);
  }
}

// The bias or bn_mul (a) and bn_add (b) of the 8 channels from the one of
// flat channels-last index e (C a multiple of 8, the vectors 16-B aligned).
template <typename T, int kAct>
__device__ __forceinline__ void channel_params(const Params& p, unsigned e, float (&a)[kVec], float (&b)[kVec]) {
  const unsigned c0 = p.c_mask ? e & p.c_mask : e % static_cast<unsigned>(p.c);
  if (kAct == kNone) {
    param8(static_cast<const T*>(p.bias), c0, a);
#pragma unroll
    for (int k = 0; k < kVec; ++k) b[k] = 0.0f;
  } else {
    param8(p.bn_mul, c0, a);
    param8(p.bn_add, c0, b);
  }
}

// The 8 channels-last elements from flat index e, loaded into v (and their
// residuals into r), with their channels' parameters: the epilogue and the
// store.
template <typename T, bool kQ, int kAct, bool kRes>
__device__ __forceinline__ void vector8_cl(const Params& p, unsigned e, float (&v)[kVec], const float (&r)[kVec],
                                           const float (&a)[kVec], const float (&b)[kVec], const QScale& qs) {
  epilogue<sizeof(T) == 2, kQ, kAct>(p, v, a, b);
  if (kRes) add_residual<sizeof(T) == 2>(v, r);
  if (kQ) {
    int q[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) q[k] = quantize(v[k], qs);
    *reinterpret_cast<uint2*>(static_cast<int8_t*>(p.out) + e) =
        make_uint2(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
  } else {
    store8(static_cast<T*>(p.out), e, v);
  }
}

// The 8 NCHW elements from flat index e, loaded into v (and their
// residuals into r): their parameters (the plane of element e and, from
// pos + k == hw on, the next one), the epilogue, the store.
template <typename T, bool kQ, int kAct, bool kRes>
__device__ __forceinline__ void vector8_nchw(const Params& p, unsigned e, float (&v)[kVec], const float (&r)[kVec],
                                             const QScale& qs) {
  const unsigned hw = static_cast<unsigned>(p.hw), C = static_cast<unsigned>(p.c);
  const unsigned plane = e / hw, pos = e - plane * hw;
  const unsigned c = p.c_mask ? plane & p.c_mask : plane % C, c_next = c + 1 == C ? 0 : c + 1;
  float a0, a1, b0 = 0.0f, b1 = 0.0f;
  if (kAct == kNone) {
    a0 = load1(static_cast<const T*>(p.bias), c), a1 = load1(static_cast<const T*>(p.bias), c_next);
  } else {
    a0 = __ldg(p.bn_mul + c), a1 = __ldg(p.bn_mul + c_next);
    b0 = __ldg(p.bn_add + c), b1 = __ldg(p.bn_add + c_next);
  }
  const unsigned cross = hw - pos;  // the first k in the next plane, if below 8
  float a[kVec], b[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    a[k] = k >= cross ? a1 : a0;
    b[k] = k >= cross ? b1 : b0;
  }
  epilogue<sizeof(T) == 2, kQ, kAct>(p, v, a, b);
  if (kRes) add_residual<sizeof(T) == 2>(v, r);
  if (kQ) {
    // int8 NHWC from NCHW: a byte at a time
    int8_t* out = static_cast<int8_t*>(p.out);
    const unsigned n = plane / C;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const bool next = k >= cross;
      const unsigned cc = next ? c_next : c;
      const unsigned nn = next && c_next == 0 ? n + 1 : n;
      const unsigned pp = next ? pos + k - hw : pos + k;
      out[(static_cast<size_t>(nn) * hw + pp) * C + cc] = static_cast<int8_t>(quantize(v[k], qs));
    }
  } else {
    store8(static_cast<T*>(p.out), e, v);
  }
}

// The vector route: every pointer 16-B aligned, total < 2^32, and
// channels-last C % 8 == 0 or NCHW H * W >= 8. A block owns kSub *
// kThreads vectors, thread t the vectors t, t + kThreads, ... The residual
// form (kRes) loads x's vectors with y's, before it computes any.
template <typename T, bool kQ, bool kCL, int kAct, bool kRes>
__global__ void __launch_bounds__(kThreads) conv_epilogue_vec(Params p) {
  const unsigned n_vec = static_cast<unsigned>(p.total / kVec);
  const unsigned t0 = blockIdx.x * (kThreads * kSub) + threadIdx.x;
  float v[kSub][kVec], r[kSub][kVec];
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    if (t0 + s * kThreads < n_vec) {
      load8(static_cast<const T*>(p.y), (t0 + s * kThreads) * kVec, v[s]);
      if (kRes) load8(static_cast<const T*>(p.residual), (t0 + s * kThreads) * kVec, r[s]);
    }
  }
  const QScale qs = q_scale(kQ ? p.q_scale : nullptr);
  if (kCL) {
    // a thread's vectors lie kThreads * 8 elements apart: on the same
    // channels where that is a multiple of C
    float a[kVec], b[kVec];
    if (p.cl_shared) channel_params<T, kAct>(p, t0 * kVec, a, b);
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      const unsigned e = (t0 + s * kThreads) * kVec;
      if (t0 + s * kThreads >= n_vec) break;
      if (!p.cl_shared) channel_params<T, kAct>(p, e, a, b);
      vector8_cl<T, kQ, kAct, kRes>(p, e, v[s], r[s], a, b, qs);
    }
  } else {
#pragma unroll
    for (int s = 0; s < kSub; ++s)
      if (t0 + s * kThreads < n_vec) vector8_nchw<T, kQ, kAct, kRes>(p, (t0 + s * kThreads) * kVec, v[s], r[s], qs);
  }
  // the last total % 8 elements, one a thread of the first block
  if (blockIdx.x == 0 && threadIdx.x < p.total - static_cast<long long>(n_vec) * kVec)
    one_element<T, kQ, kCL, kRes>(p, static_cast<long long>(n_vec) * kVec + threadIdx.x);
}

template <typename T, bool kQ, bool kCL, int kAct, bool kRes = false>
void launch_vec(const Params& p, cudaStream_t s) {
  const unsigned long long n_vec = p.total / kVec, per_block = kThreads * kSub;
  const unsigned blocks = static_cast<unsigned>((n_vec + per_block - 1) / per_block);
  conv_epilogue_vec<T, kQ, kCL, kAct, kRes><<<blocks > 0 ? blocks : 1, kThreads, 0, s>>>(p);
}

template <typename T, bool kQ, bool kCL, bool kRes = false>
void launch_loop(const Params& p, cudaStream_t s) {
  const long long want = (p.total + kThreads - 1) / kThreads;
  conv_epilogue_loop<T, kQ, kCL, kRes><<<static_cast<unsigned>(want < 65536 ? want : 65536), kThreads, 0, s>>>(p);
}

template <typename T, bool kQ, bool kCL>
cudaError_t launch(const Params& p, bool vec, cudaStream_t s) {
  if (!vec) {
    launch_loop<T, kQ, kCL>(p, s);
  } else if (p.act == kNone) {
    launch_vec<T, kQ, kCL, kNone>(p, s);
  } else if (p.act == kRelu) {
    launch_vec<T, kQ, kCL, kRelu>(p, s);
  } else {
    launch_vec<T, kQ, kCL, kRare>(p, s);
  }
  return cudaGetLastError();
}

// The residual form: a bias, no activation, output in y's dtype.
template <typename T, bool kCL>
cudaError_t launch_residual(const Params& p, bool vec, cudaStream_t s) {
  if (vec)
    launch_vec<T, false, kCL, kNone, true>(p, s);
  else
    launch_loop<T, false, kCL, true>(p, s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const Params& p, bool vec, bool cl, cudaStream_t s) {
  if (p.residual) return cl ? launch_residual<T, true>(p, vec, s) : launch_residual<T, false>(p, vec, s);
  const bool q = p.q_scale != nullptr;
  if (q) return cl ? launch<T, true, true>(p, vec, s) : launch<T, true, false>(p, vec, s);
  return cl ? launch<T, false, true>(p, vec, s) : launch<T, false, false>(p, vec, s);
}

bool aligned(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// The destination form: the bias or BatchNorm form's result stored into one
// or two views of y's shape instead of a tensor of y's own, y channels-last.
// A view's channels are contiguous; its N, H and W strides (in elements) are
// any. The U-Net's up blocks take it: the last epilogue of a level stores
// the skip into its own tensor and into the lower channels of the up
// block's concat buffer, the upconv's bias epilogue into the upper ones at
// the pad offset, so no pad or concat pass runs. Its own kernels, so the
// other forms' instances compile as they did.
struct Into {
  void* dst[2];
  long long sn[2], sh[2], sw[2];
  unsigned h, w;
  int n;  // destinations: 1 or 2
};

// The 8 values of y's channels-last vector at flat index e (C a multiple of
// 8) stored to each destination, 16-B aligned there (the host checks).
template <typename T>
__device__ __forceinline__ void store_into(const Params& p, const Into& d, unsigned e, const float (&v)[kVec]) {
  const unsigned pixel = p.c_mask ? e >> __popc(p.c_mask) : e / static_cast<unsigned>(p.c);
  const unsigned c0 = e - pixel * static_cast<unsigned>(p.c);
  const unsigned x = pixel % d.w, rows = pixel / d.w, row = rows % d.h, n = rows / d.h;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (k == d.n) break;
    store8(static_cast<T*>(d.dst[k]) + (n * d.sn[k] + row * d.sh[k] + x * d.sw[k] + c0), 0u, v);
  }
}

// The vector route of the destination form: conv_epilogue_vec's loads and
// epilogue (no q_scale, no residual), then store_into.
template <typename T, int kAct>
__global__ void __launch_bounds__(kThreads) conv_epilogue_into_vec(Params p, Into d) {
  const unsigned n_vec = static_cast<unsigned>(p.total / kVec);
  const unsigned t0 = blockIdx.x * (kThreads * kSub) + threadIdx.x;
  float v[kSub][kVec];
#pragma unroll
  for (int s = 0; s < kSub; ++s)
    if (t0 + s * kThreads < n_vec) load8(static_cast<const T*>(p.y), (t0 + s * kThreads) * kVec, v[s]);
  float a[kVec], b[kVec];
  if (p.cl_shared) channel_params<T, kAct>(p, t0 * kVec, a, b);
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    const unsigned e = (t0 + s * kThreads) * kVec;
    if (t0 + s * kThreads >= n_vec) break;
    if (!p.cl_shared) channel_params<T, kAct>(p, e, a, b);
    epilogue<sizeof(T) == 2, false, kAct>(p, v[s], a, b);
    store_into<T>(p, d, e, v[s]);
  }
}

// One element a thread of the destination form, any C, strides and
// alignment.
template <typename T>
__global__ void __launch_bounds__(kThreads) conv_epilogue_into_loop(Params p, Into d) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < p.total; i += stride) {
    const long long pixel = i / p.c, c = i - pixel * p.c;
    const long long x = pixel % d.w, rows = pixel / d.w, row = rows % d.h, n = rows / d.h;
    float v = load1(static_cast<const T*>(p.y), i);
    if (p.act == kNone)
      v = __fadd_rn(v, load1(static_cast<const T*>(p.bias), c));
    else
      v = activate(p.act, __fadd_rn(__fmul_rn(v, __ldg(p.bn_mul + c)), __ldg(p.bn_add + c)));
    for (int k = 0; k < d.n; ++k) {
      const long long at = n * d.sn[k] + row * d.sh[k] + x * d.sw[k] + c;
      if (sizeof(T) == 2)
        static_cast<__nv_bfloat16*>(d.dst[k])[at] = __float2bfloat16_rn(v);
      else
        static_cast<float*>(d.dst[k])[at] = v;
    }
  }
}

template <typename T>
cudaError_t launch_into(const Params& p, const Into& d, bool vec, cudaStream_t s) {
  if (!vec) {
    const long long want = (p.total + kThreads - 1) / kThreads;
    conv_epilogue_into_loop<T><<<static_cast<unsigned>(want < 65536 ? want : 65536), kThreads, 0, s>>>(p, d);
    return cudaGetLastError();
  }
  const unsigned long long n_vec = p.total / kVec, per_block = kThreads * kSub;
  const unsigned blocks = static_cast<unsigned>((n_vec + per_block - 1) / per_block);
  const dim3 grid(blocks > 0 ? blocks : 1);
  if (p.act == kNone)
    conv_epilogue_into_vec<T, kNone><<<grid, kThreads, 0, s>>>(p, d);
  else if (p.act == kRelu)
    conv_epilogue_into_vec<T, kRelu><<<grid, kThreads, 0, s>>>(p, d);
  else
    conv_epilogue_into_vec<T, kRare><<<grid, kThreads, 0, s>>>(p, d);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`, a stream of CUDA device `device` (made the calling
// thread's current device for the launch, then restored), without
// synchronizing. y: (n, c, h, w) with hw = h *
// w, NCHW-contiguous (channels_last = 0) or NHWC in memory (1), bfloat16
// (bf16 = 1) or float32. One of three forms: bias (c,) in y's dtype with
// act 0 (none); bn_mul and bn_add (c,), float32, with act 1 relu, 2 tanh
// or 3 mish; or bias with act 0 and a residual of y's dtype and layout,
// no q_scale. out: y's dtype and layout where q_scale is null, else int8
// (n, h, w, c) quantized at *q_scale. Returns cudaGetLastError() after the
// launches, or the error that kept one from launching (0 = success).
extern "C" int conv_epilogue(const void* y, void* out, const void* bias, const float* bn_mul, const float* bn_add,
                             const float* q_scale, const void* residual, long long n, int c, long long hw,
                             int channels_last, int bf16, int act, int device, void* stream) {
  if (n < 0 || c < 0 || hw < 0 || act < kNone || act > kMish) return static_cast<int>(cudaErrorInvalidValue);
  const bool bn = bn_mul != nullptr && bn_add != nullptr;
  if (bias != nullptr ? bn_mul != nullptr || bn_add != nullptr || act != kNone : !bn || act == kNone)
    return static_cast<int>(cudaErrorInvalidValue);
  if (residual != nullptr && (bias == nullptr || q_scale != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.bias = bias;
  p.bn_mul = bn_mul;
  p.bn_add = bn_add;
  p.q_scale = q_scale;
  p.hw = hw;
  p.c = c;
  p.c_mask = c > 0 && (c & (c - 1)) == 0 ? static_cast<unsigned>(c - 1) : 0;
  p.act = act;
  p.cl_shared = c > 0 && (kThreads * kVec) % c == 0;
  const long long per_image = static_cast<long long>(c) * hw;
  if (n * per_image == 0) return 0;
  const bool cl = channels_last != 0;
  const bool params_aligned = bn ? aligned(bn_mul) && aligned(bn_add) : aligned(bias);
  // runs of whole images below 2^32 elements each, for the vector route's
  // 32-bit indices; an image of 2^32 or more takes the loop in one launch
  const long long run = per_image < (1LL << 32) ? ((1LL << 32) - 1) / per_image : n;
  const long long y_size = bf16 ? 2 : 4, out_size = q_scale ? 1 : y_size;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (long long n0 = 0; n0 < n && err == cudaSuccess; n0 += run) {
    const long long at = n0 * per_image;
    p.y = static_cast<const char*>(y) + at * y_size;
    p.out = static_cast<char*>(out) + at * out_size;
    p.residual = residual ? static_cast<const char*>(residual) + at * y_size : nullptr;
    p.total = (n - n0 < run ? n - n0 : run) * per_image;
    const bool vec = p.total < (1LL << 32) && aligned(p.y) && aligned(p.out) &&
                     (residual == nullptr || aligned(p.residual)) &&
                     (cl ? c % kVec == 0 && params_aligned : hw >= kVec);
    err = bf16 ? launch_dtype<__nv_bfloat16>(p, vec, cl, s) : launch_dtype<float>(p, vec, cl, s);
  }
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

// The destination form, launched as conv_epilogue is: y (n, c, h, w)
// channels-last, bfloat16 (bf16 = 1) or float32; the bias form (bias in y's
// dtype, act 0) or the BatchNorm form (bn_mul, bn_add float32, act 1-3);
// the result stored into dst0 and, where dst1 is not null, into dst1 too:
// views of y's shape and dtype with contiguous channels, element strides
// sn, sh, sw for N, H and W. Returns as conv_epilogue does.
extern "C" int conv_epilogue_into(const void* y, const void* bias, const float* bn_mul, const float* bn_add,
                                  void* dst0, long long sn0, long long sh0, long long sw0, void* dst1, long long sn1,
                                  long long sh1, long long sw1, long long n, int c, long long h, long long w, int bf16,
                                  int act, int device, void* stream) {
  if (n < 0 || c < 0 || h < 0 || w < 0 || act < kNone || act > kMish || dst0 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool bn = bn_mul != nullptr && bn_add != nullptr;
  if (bias != nullptr ? bn_mul != nullptr || bn_add != nullptr || act != kNone : !bn || act == kNone)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long per_image = static_cast<long long>(c) * h * w;
  if (n * per_image == 0) return 0;
  if (h >= (1LL << 32) || w >= (1LL << 32)) return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.bias = bias;
  p.bn_mul = bn_mul;
  p.bn_add = bn_add;
  p.hw = h * w;
  p.c = c;
  p.c_mask = (c & (c - 1)) == 0 ? static_cast<unsigned>(c - 1) : 0;
  p.act = act;
  p.cl_shared = (kThreads * kVec) % c == 0;
  Into d = {};
  d.n = dst1 != nullptr ? 2 : 1;
  d.h = static_cast<unsigned>(h);
  d.w = static_cast<unsigned>(w);
  void* const base[2] = {dst0, dst1};
  const long long sn[2] = {sn0, sn1}, sh[2] = {sh0, sh1}, sw[2] = {sw0, sw1};
  const long long size = bf16 ? 2 : 4;
  bool strides8 = true;
  for (int k = 0; k < d.n; ++k) {
    d.sn[k] = sn[k], d.sh[k] = sh[k], d.sw[k] = sw[k];
    strides8 = strides8 && sn[k] % kVec == 0 && sh[k] % kVec == 0 && sw[k] % kVec == 0;
  }
  const bool params_aligned = bn ? aligned(bn_mul) && aligned(bn_add) : aligned(bias);
  // runs of whole images below 2^32 elements each, as conv_epilogue's
  const long long run = per_image < (1LL << 32) ? ((1LL << 32) - 1) / per_image : n;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (long long n0 = 0; n0 < n && err == cudaSuccess; n0 += run) {
    p.y = static_cast<const char*>(y) + n0 * per_image * size;
    p.total = (n - n0 < run ? n - n0 : run) * per_image;
    bool vec = p.total < (1LL << 32) && aligned(p.y) && c % kVec == 0 && params_aligned && strides8;
    for (int k = 0; k < d.n; ++k) {
      d.dst[k] = static_cast<char*>(base[k]) + n0 * sn[k] * size;
      vec = vec && aligned(d.dst[k]);
    }
    err = bf16 ? launch_into<__nv_bfloat16>(p, d, vec, s) : launch_into<float>(p, d, vec, s);
  }
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}
