// FAST-9/16 score maps of up to 16 f32 images (the levels of one ORB
// pyramid) in one launch, with the 3x3 non-maximum suppression and the edge
// mask of ORB detection fused.
//
// Replaces ops/fast.py::_fast_kernel of the JAX package (driven by
// _fast_score_pallas and fast_score, once per level in ops/orb.py's
// _detect_level).  For each pixel p with the 16 margins m[k] = ring[k] - p on
// the radius-3 Bresenham circle (clockwise from 12 o'clock, edge-replicated
// reads), the score is
//
//   max( max_k min(m[k..k+8]),  max_k -max(m[k..k+8]) )     (k mod 16)
//
// zeroed where it is <= threshold or within 3 px of the border.  With NMS
// on, a score is kept where it is positive and >= every in-image 3x3
// neighbour (ops/orb.py::_nms3: max_pool2d pads with -inf), and last every
// pixel outside [e, h-e) x [e, w-e) is zeroed.  The only rounding operation
// is the subtraction ring - p: min, max, negation and comparisons are exact,
// so the result equals the plain PyTorch version of ops/fast.py bit for bit
// whatever the order of the reductions (the plain version and the JAX
// package reduce by doubling; this kernel by block prefix and suffix
// extrema, with fewer operations).
//
// Bound on this card: one read and one write of 4 bytes per pixel (5.9 MB
// for the ten levels of a 360x640 working image, 1.75 us at 3.35 TB/s)
// against about 150 f32 operations per pixel (the score 133, the NMS 11,
// the mask 5: 0.11 GFLOP, 1.6 us at 67 TFLOP/s).  Most of the operations are
// minima and maxima, which issue at half the rate of multiply-adds, so the
// operations set the pace in practice.  One launch per level cost more than
// either, and the levels' small grids left most of the 132 SMs idle; so one
// flat grid covers every level's 32 x 32 output tiles, and each block finds
// its level in a table passed by value (no host-to-device copy).  A block of
// 32 x 8 threads loads its (32 + 8) x (32 + 8) halo into shared memory with
// clamped indices (ring radius 3 plus 1 for the NMS; the clamp is the JAX
// package's edge padding, so no padded copy is written), computes the
// (32 + 2) x (32 + 2) scores into shared memory (-inf outside the image),
// and writes each pixel's final score once: the score map never goes back
// through device memory for the NMS and the mask.  Tiles 32 rows tall,
// rather than 8, spend 13% rather than 33% of the scores on the NMS ring
// and give each block more work per halo load.

#include <cuda_runtime.h>

#include <math_constants.h>

#include "launch_device.cuh"

namespace {

constexpr int kMaxLevels = 16;
constexpr int kTileX = 32;
constexpr int kTileY = 32;                 // a multiple of kThreadsY
constexpr int kThreadsY = 8;               // 32 x 8 threads a block
constexpr int kR = 3;                      // ring radius
constexpr int kHalo = kR + 1;              // ring + NMS
constexpr int kHaloX = kTileX + 2 * kHalo;
constexpr int kHaloY = kTileY + 2 * kHalo;
constexpr int kScoreX = kTileX + 2;
constexpr int kScoreY = kTileY + 2;

struct Levels {
  const float* img[kMaxLevels];
  float* out[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int tiles_x[kMaxLevels];
  int first_tile[kMaxLevels + 1];
  int n;
  float threshold;
  int edge;
  int nms;
};

// The best 9-arc of the ring for one polarity: kBright, max_k min(m[k..k+8]);
// else min_k max(m[k..k+8]) (k mod 16).  The 16 windows come from block
// prefix and suffix extrema of the doubled ring d[i] = m[i % 16], blocks
// [0, 9), [9, 18), [18, 24): window k is the suffix of its block from k
// joined to the prefix of the next block up to k + 8.  That takes 57
// minima and maxima a polarity, against 79 for the doubling 2, 4, 8 + 1.
template <bool kBright>
__device__ __forceinline__ float best_arc(const float (&m)[16]) {
  auto in = [](float a, float b) { return kBright ? fminf(a, b) : fmaxf(a, b); };
  auto across = [](float a, float b) { return kBright ? fmaxf(a, b) : fminf(a, b); };
  float suf[18], pre[24];
  suf[8] = m[8];
#pragma unroll
  for (int i = 7; i >= 0; --i) suf[i] = in(m[i], suf[i + 1]);
  suf[17] = m[1];
#pragma unroll
  for (int i = 16; i >= 9; --i) suf[i] = in(m[i & 15], suf[i + 1]);
  pre[9] = m[9];
#pragma unroll
  for (int i = 10; i <= 16; ++i) pre[i] = in(pre[i - 1], m[i & 15]);
  pre[18] = m[2];
#pragma unroll
  for (int i = 19; i <= 23; ++i) pre[i] = in(pre[i - 1], m[i & 15]);
  float best = across(suf[0], suf[9]);                // windows 0 and 9: whole blocks
#pragma unroll
  for (int k = 1; k <= 8; ++k) best = across(best, in(suf[k], pre[k + 8]));
#pragma unroll
  for (int k = 10; k <= 15; ++k) best = across(best, in(suf[k], pre[k + 8]));
  return best;
}

// the raw FAST score of the pixel at (cy, cx) of the shared halo
__device__ __forceinline__ float fast_score(const float (*tile)[kHaloX], int cy, int cx) {
  const float* t = &tile[cy][cx];
  const float center = t[0];
  // the circle clockwise from 12 o'clock, (dy, dx) as literals so that every
  // read is one shared-memory load at a fixed offset
  auto at = [&](int dy, int dx) { return t[dy * kHaloX + dx] - center; };
  const float m[16] = {at(-3, 0), at(-3, 1), at(-2, 2), at(-1, 3), at(0, 3),  at(1, 3),
                       at(2, 2),  at(3, 1),  at(3, 0),  at(3, -1), at(2, -2), at(1, -3),
                       at(0, -3), at(-1, -3), at(-2, -2), at(-3, -1)};
  // max_k -max(arc) = -min_k max(arc): negation is exact
  return fmaxf(best_arc<true>(m), -best_arc<false>(m));
}

__global__ void __launch_bounds__(kTileX * kThreadsY) fast_levels_kernel(Levels lv) {
  __shared__ float tile[kHaloY][kHaloX];
  __shared__ float score[kScoreY][kScoreX];

  int level = 0;
  while (level + 1 < lv.n && static_cast<int>(blockIdx.x) >= lv.first_tile[level + 1]) ++level;
  const int t = blockIdx.x - lv.first_tile[level];
  const float* img = lv.img[level];
  const int h = lv.h[level];
  const int w = lv.w[level];
  const int x0 = (t % lv.tiles_x[level]) * kTileX;
  const int y0 = (t / lv.tiles_x[level]) * kTileY;
  const int tid = threadIdx.y * kTileX + threadIdx.x;

  for (int i = tid; i < kHaloY * kHaloX; i += kTileX * kThreadsY) {
    const int ty = i / kHaloX;
    const int tx = i - ty * kHaloX;
    const int gy = min(max(y0 + ty - kHalo, 0), h - 1);
    const int gx = min(max(x0 + tx - kHalo, 0), w - 1);
    tile[ty][tx] = img[static_cast<long>(gy) * w + gx];
  }
  __syncthreads();

  // thresholded scores of the tile and its 1-px ring; -inf off the image
  for (int i = tid; i < kScoreY * kScoreX; i += kTileX * kThreadsY) {
    const int sy = i / kScoreX;
    const int sx = i - sy * kScoreX;
    const int gy = y0 + sy - 1;
    const int gx = x0 + sx - 1;
    float s = -CUDART_INF_F;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const float raw = fast_score(tile, sy + kR, sx + kR);
      const bool interior = gy >= kR && gy < h - kR && gx >= kR && gx < w - kR;
      s = (interior && raw > lv.threshold) ? raw : 0.0f;
    }
    score[sy][sx] = s;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int e = lv.edge;
  for (int ty = threadIdx.y; ty < kTileY; ty += kThreadsY) {
    const int y = y0 + ty;
    if (x >= w || y >= h) break;
    const int cy = ty + 1;
    const int cx = threadIdx.x + 1;
    float v = score[cy][cx];
    if (lv.nms) {
      float neigh = v;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) neigh = fmaxf(neigh, score[cy + dy][cx + dx]);
      v = (v >= neigh && v > 0.0f) ? v : 0.0f;
    }
    const bool inside = y >= e && y < h - e && x >= e && x < w - e;
    lv.out[level][static_cast<long>(y) * w + x] = inside ? v : 0.0f;
  }
}

}  // namespace

// Launches the score maps of `n` (1..16) row-major f32 images: imgs[i] of
// (hs[i], ws[i]) into outs[i], on `stream`.  `nms` turns on the 3x3
// non-maximum suppression; `edge` zeroes every pixel within that many pixels
// of the border (0: none).  The host arrays are packed into the kernel's
// parameters, so nothing is copied to the device.  The launch runs with
// `device`, the device of the images and of `stream`, current
// (launch_device.cuh).  Returns cudaGetLastError() after the launch.
extern "C" int vstab_fast_levels(const float* const* imgs, float* const* outs, const int* hs,
                                 const int* ws, int n, float threshold, int edge, int nms,
                                 int device, void* stream) {
  if (n < 1 || n > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  lv.n = n;
  lv.threshold = threshold;
  lv.edge = edge;
  lv.nms = nms;
  lv.first_tile[0] = 0;
  for (int i = 0; i < n; ++i) {
    if (hs[i] < 1 || ws[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    lv.img[i] = imgs[i];
    lv.out[i] = outs[i];
    lv.h[i] = hs[i];
    lv.w[i] = ws[i];
    lv.tiles_x[i] = (ws[i] + kTileX - 1) / kTileX;
    lv.first_tile[i + 1] =
        lv.first_tile[i] + lv.tiles_x[i] * ((hs[i] + kTileY - 1) / kTileY);
  }
  const LaunchDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  const dim3 block(kTileX, kThreadsY);
  fast_levels_kernel<<<lv.first_tile[n], block, 0, static_cast<cudaStream_t>(stream)>>>(lv);
  return static_cast<int>(cudaGetLastError());
}
