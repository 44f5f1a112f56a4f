// Affine warp of a batch of (C, H, W) f32 images in one launch, each item by
// its own transform, with a constant border.
//
// Replaces ops/pallas_warp.py::_resample_kernel of the JAX package (its two
// pallas_call passes in _warp_planes_pallas, which the JAX package's vmap
// gives a batch grid dimension) and the branch of warp_affine around it.  With the inverse (dst -> src) map hinv, the kernel derives on
// the device, with the rounding of the plain PyTorch version in
// ops/affine_warp.py (_pass_params, _span_ok):
//
//   pass V:  I1[c, y, u]  = src[c, alpha*y + beta*u + gamma, u]
//            alpha = D - C*B/A, beta = C/A, gamma = ty - C*tx/A
//   pass H:  out[c, y, x] = I1[c, y, A*x + B*y + tx]
//
// each a bilinear tap pair, zero outside the source, and the envelope
// predicate of the JAX package's copy budget.  Inside the envelope (or when
// the caller turns the projective fallback off) it computes the 2-pass
// Catmull-Smith result; outside, the direct bilinear gather of
// ops/warp.py::warp_perspective, op for op.  Both then take border[c] where
// the true inverse map sends an output pixel outside the source.  Item b of
// the batch is grid slice blockIdx.z = b: it reads its own inverse map, its
// own border and its image at the batch strides, so the branch is uniform
// within each item and one launch serves a batch that mixes items inside and
// outside the envelope.  No value goes to the host; each item outside the
// envelope adds one to a device counter (block (0, 0, b) adds it).
//
// Bound on this card: device-memory bytes, one read of the input and one
// write of the output (8 B/px; about 50 MB and 0.015 ms at 3.35 TB/s for the
// 3x1080x1920 output frame).  So the intermediate I1 never reaches device
// memory: a block owns a 16 x 64 output tile and all its channels.  It
// reduces the tile's span of pass-H source columns from the same rounded
// positions that pass H uses, computes I1 of every channel for the tile's
// rows over that span into shared memory (stage 1: one position per row and
// column serves its channels, and each thread issues the loads of two to
// four such items before it uses any), then runs pass H from shared memory
// and writes each output pixel once (stage 2).  The channel count is a
// template parameter for the one- and three-channel warps of the step.  A
// span too wide for the buffer (only far outside the envelope) takes its
// taps from device memory instead, with the same arithmetic.  Input and
// output are addressed by element strides, so an (H, W, C) frame is read and
// written in place.
//
// Every product and sum uses the explicitly rounded intrinsics (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn), so nvcc contracts nothing into a fused
// multiply-add and the kernel equals the plain version bit for bit.

#include <cuda_runtime.h>

#include <climits>

#include "launch_device.cuh"

namespace {

constexpr int kTileX = 64;
constexpr int kTileY = 16;
constexpr int kThreads = 256;
constexpr int kRowsPerPass = kThreads / kTileX;      // 4
constexpr int kPix = kTileY / kRowsPerPass;          // output pixels per thread
constexpr int kBuf = 8192;                           // floats of I1 (32 KB)
constexpr float kCopies = 26.0f;                     // pallas_warp.COPIES

struct WarpArgs {
  const float* src;
  float* out;
  const float* hinv;      // 3x3 row-major per item, on the device
  const float* border;    // (C,) per item on the device, or null: border_value
  float border_value;
  int* fallbacks;         // warps that took the gather
  long long s_b, s_c, s_y, s_x;
  long long o_b, o_c, o_y, o_x;
  long long border_stride;  // elements from one item's border to the next
  int c, h, w;
  int projective_fallback;
};

// (p * x + q * y) + r, rounded after every operation as PyTorch does
__device__ __forceinline__ float lin(float p, float q, float x, float y, float r) {
  return __fadd_rn(__fadd_rn(__fmul_rn(p, x), __fmul_rn(q, y)), r);
}

__device__ __forceinline__ float lerp(float v0, float v1, float w) {
  return __fadd_rn(__fmul_rn(v0, __fsub_rn(1.0f, w)), __fmul_rn(v1, w));
}

__device__ __forceinline__ bool span_ok(float alpha, float beta) {
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(fabsf(__fsub_rn(alpha, 1.0f)), 8.0f),
                                      __fmul_rn(fabsf(beta), 128.0f)),
                            3.0f);
  return s <= kCopies;
}

__device__ __forceinline__ bool in_range(float idx, int n) {
  return idx >= 0.0f && idx <= static_cast<float>(n - 1);
}

__device__ __forceinline__ float border_of(const WarpArgs& a, int c) {
  return a.border != nullptr ? a.border[c] : a.border_value;
}

// ops/warp.py::warp_perspective (border 0) at output pixel (x, y), then the
// border of the true inverse map, for every channel
__device__ void gather_pixel(const WarpArgs& a, const float* m, int x, int y) {
  const float fxp = static_cast<float>(x);
  const float fyp = static_cast<float>(y);
  // the affine part alone also gives the border mask, as _border_mask
  const float bx = lin(m[0], m[1], fxp, fyp, m[2]);
  const float by = lin(m[3], m[4], fxp, fyp, m[5]);
  float denom = lin(m[6], m[7], fxp, fyp, m[8]);
  denom = fabsf(denom) > 1e-12f ? denom : 1e-12f;
  const float sx = __fdiv_rn(bx, denom);
  const float sy = __fdiv_rn(by, denom);
  const float x0 = floorf(sx);
  const float y0 = floorf(sy);
  const float fx = __fsub_rn(sx, x0);
  const float fy = __fsub_rn(sy, y0);
  const float wm1 = static_cast<float>(a.w - 1);
  const float hm1 = static_cast<float>(a.h - 1);
  const bool inb = sx >= 0.0f && sx <= wm1 && sy >= 0.0f && sy <= hm1;
  const long long x0c = static_cast<long long>(fminf(fmaxf(x0, 0.0f), wm1));
  const long long x1c = static_cast<long long>(fminf(fmaxf(__fadd_rn(x0, 1.0f), 0.0f), wm1));
  const long long y0c = static_cast<long long>(fminf(fmaxf(y0, 0.0f), hm1));
  const long long y1c = static_cast<long long>(fminf(fmaxf(__fadd_rn(y0, 1.0f), 0.0f), hm1));
  const bool keep = bx >= 0.0f && bx <= wm1 && by >= 0.0f && by <= hm1;
  for (int c = 0; c < a.c; ++c) {
    float val = border_of(a, c);
    if (keep) {
      const float* s = a.src + c * a.s_c;
      const float v00 = s[y0c * a.s_y + x0c * a.s_x];
      const float v01 = s[y0c * a.s_y + x1c * a.s_x];
      const float v10 = s[y1c * a.s_y + x0c * a.s_x];
      const float v11 = s[y1c * a.s_y + x1c * a.s_x];
      const float top = lerp(v00, v01, fx);
      const float bot = lerp(v10, v11, fx);
      val = inb ? lerp(top, bot, fy) : 0.0f;
    }
    a.out[c * a.o_c + y * a.o_y + x * a.o_x] = val;
  }
}

struct PassV {
  float alpha, beta, gamma;
  const float* src;
  long long s_c, s_y, s_x;
  int h;

  // I1[c, y, u]: the bilinear tap pair of column u, zero outside the rows
  __device__ __forceinline__ float operator()(int c, int y, int u) const {
    const float q = lin(alpha, beta, static_cast<float>(y), static_cast<float>(u), gamma);
    const float j0 = floorf(q);
    const float j1 = __fadd_rn(j0, 1.0f);
    const float* col = src + c * s_c + u * s_x;
    const float v0 = in_range(j0, h) ? col[static_cast<long long>(j0) * s_y] : 0.0f;
    const float v1 = in_range(j1, h) ? col[static_cast<long long>(j1) * s_y] : 0.0f;
    return lerp(v0, v1, __fsub_rn(q, j0));
  }
};

// pass-H position of output pixel (x, y)
__device__ __forceinline__ float pass_h(const float* m, int x, int y) {
  return lin(m[0], m[1], static_cast<float>(x), static_cast<float>(y), m[2]);
}

// floor(e / n) for 0 <= e < 2^22 by a float reciprocal: (e + 0.5) / n lies
// at least 0.5 / n from an integer, far more than the two roundings move it
__device__ __forceinline__ int div_small(int e, float inv_n) {
  return static_cast<int>(__fmul_rn(static_cast<float>(e) + 0.5f, inv_n));
}

// kC: the channel count, or 0 for any (read from the arguments; the
// channels then go one by one).  Four blocks of 256 threads share an SM
// (64 registers a thread, 4 x 33 KB of shared memory).
template <int kC>
__global__ void __launch_bounds__(kThreads, 4) affine_warp_kernel(WarpArgs args) {
  // this block's item: its image, output, inverse map and border
  const int item = blockIdx.z;
  WarpArgs a = args;
  a.src = args.src + item * args.s_b;
  a.out = args.out + item * args.o_b;
  a.hinv = args.hinv + 9 * item;
  if (args.border != nullptr) a.border = args.border + item * args.border_stride;

  // stage-1 items a thread loads before it uses any
  constexpr int kBatch = kC == 1 ? 4 : 2;
  __shared__ float buf[kBuf];
  __shared__ int red_lo[kThreads / 32];
  __shared__ int red_hi[kThreads / 32];
  __shared__ int span[2];

  const int nc = kC > 0 ? kC : a.c;
  const float* m = a.hinv;
  const float ha = m[0], hb = m[1];
  const float hc = m[3], hd = m[4], hty = m[5];
  const float a_safe = fabsf(ha) > 1e-3f ? ha : 1e-3f;
  PassV pv;
  pv.alpha = __fsub_rn(hd, __fdiv_rn(__fmul_rn(hc, hb), a_safe));
  pv.beta = __fdiv_rn(hc, a_safe);
  pv.gamma = __fsub_rn(hty, __fdiv_rn(__fmul_rn(hc, m[2]), a_safe));
  pv.src = a.src;
  pv.s_c = a.s_c;
  pv.s_y = a.s_y;
  pv.s_x = a.s_x;
  pv.h = a.h;
  const bool envelope = span_ok(pv.alpha, pv.beta) && span_ok(ha, hb) && fabsf(ha) > 1e-3f;

  const int x = blockIdx.x * kTileX + threadIdx.x % kTileX;
  const int y0 = blockIdx.y * kTileY;
  const int r0 = threadIdx.x / kTileX;                // rows r0, r0 + 4, ...

  if (a.projective_fallback && !envelope) {
    // one count per item outside the envelope
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) atomicAdd(a.fallbacks, 1);
    for (int j = 0; j < kPix; ++j) {
      const int y = y0 + r0 + j * kRowsPerPass;
      if (x < a.w && y < a.h) gather_pixel(a, m, x, y);
    }
    return;
  }

  // the tile's span of pass-H source columns, from the same rounded
  // positions that pass H uses
  int lo = INT_MAX, hi = INT_MIN;
  const float wm1 = static_cast<float>(a.w - 1);
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int y = y0 + r0 + j * kRowsPerPass;
    if (x < a.w && y < a.h) {
      const float i0 = floorf(pass_h(m, x, y));
      // taps at -1 or w read zero, as any tap beyond them
      lo = min(lo, static_cast<int>(fminf(fmaxf(i0, -1.0f), wm1 + 1.0f)));
      hi = max(hi, static_cast<int>(fminf(fmaxf(__fadd_rn(i0, 1.0f), -1.0f), wm1 + 1.0f)));
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (threadIdx.x % 32 == 0) {
    red_lo[threadIdx.x / 32] = lo;
    red_hi[threadIdx.x / 32] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kThreads / 32; ++i) {
      lo = min(lo, red_lo[i]);
      hi = max(hi, red_hi[i]);
    }
    span[0] = max(lo, 0);
    span[1] = min(hi, a.w - 1);
  }
  __syncthreads();
  const int u_lo = span[0];
  const int n_span = max(span[1] - u_lo + 1, 0);
  const int n_rows = min(kTileY, a.h - y0);
  // the buffer holds I1 of every channel ([row][column][channel]), or the
  // taps come from device memory
  const bool buffered = n_rows * n_span * nc <= kBuf;

  if (buffered && n_span > 0) {
    // stage 1: I1 of the tile's rows over the span; an item is a (row,
    // column) pair, whose position serves all its channels
    const int n_items = n_rows * n_span;
    const float inv_span = 1.0f / static_cast<float>(n_span);
    for (int first = threadIdx.x; first < n_items; first += kThreads * kBatch) {
      // the taps' element offsets in this item's image, -1 for none: 32-bit,
      // so that the loads in flight hold no 64-bit addresses
      int o0[kBatch];
      int o1[kBatch];
      float wq[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = first + b * kThreads;
        const int r = div_small(i, inv_span);
        const int u = u_lo + (i - r * n_span);
        const float q = lin(pv.alpha, pv.beta, static_cast<float>(y0 + r),
                            static_cast<float>(u), pv.gamma);
        const float j0 = floorf(q);
        const float j1 = __fadd_rn(j0, 1.0f);
        wq[b] = __fsub_rn(q, j0);
        const long long col = u * a.s_x;
        const bool live = i < n_items;
        o0[b] = live && in_range(j0, a.h)
                    ? static_cast<int>(col + static_cast<long long>(j0) * a.s_y) : -1;
        o1[b] = live && in_range(j1, a.h)
                    ? static_cast<int>(col + static_cast<long long>(j1) * a.s_y) : -1;
      }
      if (kC > 0) {
        constexpr int kN = kC > 0 ? kC : 1;
        float v0[kBatch][kN], v1[kBatch][kN];
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
#pragma unroll
          for (int c = 0; c < kN; ++c) {
            v0[b][c] = o0[b] >= 0 ? a.src[o0[b] + c * a.s_c] : 0.0f;
            v1[b][c] = o1[b] >= 0 ? a.src[o1[b] + c * a.s_c] : 0.0f;
          }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int i = first + b * kThreads;
          if (i < n_items) {
#pragma unroll
            for (int c = 0; c < kN; ++c) buf[i * kN + c] = lerp(v0[b][c], v1[b][c], wq[b]);
          }
        }
      } else {
        for (int b = 0; b < kBatch; ++b) {
          const int i = first + b * kThreads;
          if (i >= n_items) break;
          for (int c = 0; c < nc; ++c) {
            const float v0 = o0[b] >= 0 ? a.src[o0[b] + c * a.s_c] : 0.0f;
            const float v1 = o1[b] >= 0 ? a.src[o1[b] + c * a.s_c] : 0.0f;
            buf[i * nc + c] = lerp(v0, v1, wq[b]);
          }
        }
      }
    }
    __syncthreads();
  }

  // stage 2: pass H from the buffer (or device memory), the border, one
  // write per pixel and channel
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int r = r0 + j * kRowsPerPass;
    const int y = y0 + r;
    if (x >= a.w || y >= a.h) continue;
    const float p = pass_h(m, x, y);
    const float f0 = floorf(p);
    const float f1 = __fadd_rn(f0, 1.0f);
    const float wp = __fsub_rn(p, f0);
    const bool t0 = in_range(f0, a.w);
    const bool t1 = in_range(f1, a.w);
    const float sy = lin(m[3], m[4], static_cast<float>(x), static_cast<float>(y), m[5]);
    const bool inb = p >= 0.0f && p <= wm1 && sy >= 0.0f && sy <= static_cast<float>(a.h - 1);
    const int i0 = t0 ? static_cast<int>(f0) : -1;    // t1 alone: f0 is -1
    const int at = (r * n_span + i0 - u_lo) * nc;
    float* o = a.out + y * a.o_y + x * a.o_x;
#pragma unroll
    for (int c = 0; c < (kC > 0 ? kC : nc); ++c) {
      float v0 = 0.0f, v1 = 0.0f;
      if (buffered) {
        if (t0) v0 = buf[at + c];
        if (t1) v1 = buf[at + nc + c];
      } else {
        if (t0) v0 = pv(c, y, i0);
        if (t1) v1 = pv(c, y, i0 + 1);
      }
      o[c * a.o_c] = inb ? lerp(v0, v1, wp) : border_of(a, c);
    }
  }
}

}  // namespace

// Warps each of the `batch` (C, h, w) images of `src` into `out` (same
// extent) on `stream`.  Element strides (item, channel, row, column) address
// both, so any layout is taken; one item's elements must lie within 2^31 of
// its first (stage 1 keeps 32-bit offsets).  `hinv` holds the items' 3x3 row-major
// inverse maps on the device, one after the other; `border` the (C,) border
// of item 0 on the device, `border_stride` elements before item 1's (0: one
// border for all), or null for `border_value`; `fallbacks` a device int the
// kernel adds one to for each item that takes the gather.  1 <= batch <=
// 65535 (the grid's z extent), else cudaErrorInvalidValue and no launch.
// The launch runs with `device`, the device of the tensors and of `stream`,
// current (launch_device.cuh).  Returns cudaGetLastError() after the launch.
extern "C" int vstab_affine_warp(const float* src, float* out, const float* hinv,
                                 const float* border, float border_value, int* fallbacks,
                                 long long s_b, long long s_c, long long s_y, long long s_x,
                                 long long o_b, long long o_c, long long o_y, long long o_x,
                                 long long border_stride, int batch,
                                 int c, int h, int w, int projective_fallback,
                                 int device, void* stream) {
  if (batch < 1 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const LaunchDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  WarpArgs a;
  a.src = src;
  a.out = out;
  a.hinv = hinv;
  a.border = border;
  a.border_value = border_value;
  a.fallbacks = fallbacks;
  a.s_b = s_b;
  a.s_c = s_c;
  a.s_y = s_y;
  a.s_x = s_x;
  a.o_b = o_b;
  a.o_c = o_c;
  a.o_y = o_y;
  a.o_x = o_x;
  a.border_stride = border_stride;
  a.c = c;
  a.h = h;
  a.w = w;
  a.projective_fallback = projective_fallback;
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY, batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 1) {
    affine_warp_kernel<1><<<grid, kThreads, 0, s>>>(a);
  } else if (c == 3) {
    affine_warp_kernel<3><<<grid, kThreads, 0, s>>>(a);
  } else {
    affine_warp_kernel<0><<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
