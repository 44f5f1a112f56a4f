// FAST-9/16 score map of one (h, w) f32 image.
//
// Replaces ops/fast.py::_fast_kernel of the JAX package (driven by
// _fast_score_pallas and fast_score).  For each pixel p with the 16 margins
// m[k] = ring[k] - p on the radius-3 Bresenham circle (clockwise from 12
// o'clock, edge-replicated reads), the score is
//
//   max( max_k min(m[k..k+8]),  max_k -max(m[k..k+8]) )     (k mod 16)
//
// zeroed where it is <= threshold or within 3 px of the border.  The only
// rounding operation is the subtraction ring - p: min, max and negation are
// exact, so the result equals the plain PyTorch version of ops/fast.py bit
// for bit whatever the order of the reductions.  The arcs are still reduced
// in the JAX package's doubling order (2, 4, 8, then the 9th entry) so a
// reader can follow one against the other.
//
// The Pallas kernel keeps the whole padded image in one VMEM block and pads
// it to 128 lanes and 8-row strips for Mosaic's tiling.  None of that
// carries over.  Here a block of 32 x 8 threads computes a 32 x 8 tile of
// outputs, one thread per pixel with threads along the contiguous width.
// The block first loads its (8 + 6) x (32 + 6) halo into shared memory,
// clamping indices at the image edge: that clamp is the JAX package's
// edge padding, so no padded copy is ever written.  The 16 ring reads then
// come from shared memory, both arc reductions run in registers, and each
// thread writes one float.
//
// Bound on this card: one read and one write of 4 bytes per pixel (5.9 MB
// for the ten pyramid levels of a 360x640 working image, under 2 us at
// 3.35 TB/s) and about 177 f32 operations per pixel (about 0.13 GFLOP, about
// 2 us at 67 TFLOP/s).  At these sizes one launch costs more than either;
// batching levels or fusing the 3x3 NMS is left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kR = 3;
constexpr int kHaloX = kTileX + 2 * kR;
constexpr int kHaloY = kTileY + 2 * kR;

__constant__ int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__global__ void fast_score_kernel(const float* __restrict__ img,
                                  float* __restrict__ out, int h, int w,
                                  float threshold) {
  __shared__ float tile[kHaloY][kHaloX];
  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * kTileY;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  for (int i = tid; i < kHaloY * kHaloX; i += kTileX * kTileY) {
    const int ty = i / kHaloX;
    const int tx = i - ty * kHaloX;
    const int gy = min(max(y0 + ty - kR, 0), h - 1);
    const int gx = min(max(x0 + tx - kR, 0), w - 1);
    tile[ty][tx] = img[static_cast<long>(gy) * w + gx];
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= w || y >= h) return;

  const int cy = threadIdx.y + kR;
  const int cx = threadIdx.x + kR;
  const float center = tile[cy][cx];
  float m[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) m[k] = tile[cy + kDy[k]][cx + kDx[k]] - center;

  float lo2[16], hi2[16], lo4[16], hi4[16], lo8[16], hi8[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    lo2[k] = fminf(m[k], m[(k + 1) & 15]);
    hi2[k] = fmaxf(m[k], m[(k + 1) & 15]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    lo4[k] = fminf(lo2[k], lo2[(k + 2) & 15]);
    hi4[k] = fmaxf(hi2[k], hi2[(k + 2) & 15]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    lo8[k] = fminf(lo4[k], lo4[(k + 4) & 15]);
    hi8[k] = fmaxf(hi4[k], hi4[(k + 4) & 15]);
  }
  float bright = fminf(lo8[0], m[8]);
  float dark = -fmaxf(hi8[0], m[8]);
#pragma unroll
  for (int k = 1; k < 16; ++k) {
    bright = fmaxf(bright, fminf(lo8[k], m[(k + 8) & 15]));
    dark = fmaxf(dark, -fmaxf(hi8[k], m[(k + 8) & 15]));
  }
  const float score = fmaxf(bright, dark);

  const bool interior = y >= kR && y < h - kR && x >= kR && x < w - kR;
  out[static_cast<long>(y) * w + x] =
      (interior && score > threshold) ? score : 0.0f;
}

}  // namespace

// Launches the score map of the (h, w) row-major f32 image `img` into `out`
// on `stream`.  Returns cudaGetLastError() after the launch.
extern "C" int vstab_fast_score(const float* img, float* out, int h, int w,
                                float threshold, void* stream) {
  const dim3 block(kTileX, kTileY);
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY);
  fast_score_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, h, w, threshold);
  return static_cast<int>(cudaGetLastError());
}
