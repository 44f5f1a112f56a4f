// The Y|U|V planes of Y4M frames from N u8 BGR frames, C420 or C444, in one
// launch.
//
// Replaces no TPU kernel: the JAX package encodes its outputs on the host
// (io/video.py::encode_y4m_planes, numpy), and so did the port until serving
// moved the encode of its outputs onto the card (serve.py::serve_files).  The
// bytes are numpy's: BT.601 in f32 in numpy's order, each product and sum
// rounded on its own (the _rn intrinsics, which nvcc does not contract into
// fused multiply-adds),
//
//   y = (0.299 r + 0.587 g) + 0.114 b
//   u = 128 + 0.564 (b - y)        v = 128 + 0.713 (r - y)
//
// C420 chroma as numpy's mean of each 2x2 block, ((tl + tr) + (bl + br)) / 4
// (the division by 4 is exact), then a clip to [0, 255] and a truncation
// toward zero.  ops/y4m.py::encode_y4m_plain writes the same order out in
// PyTorch.
//
// Bound on this card: bytes.  A C420 frame reads 3 B/px of BGR and writes
// 1.5 B/px of planes (9.3 MB at 1080x1920, 2.8 us at 3.35 TB/s) against
// about 12 f32 operations a pixel.  So nothing goes through device memory
// but the frames and the planes: one thread takes one 2x2 block (C420; one
// pixel for C444), reads its two rows of 6 bytes as 2-byte loads that
// neighbouring threads make at neighbouring addresses, keeps Y, U and V in
// registers, and writes each output byte once.  Plain PyTorch would write
// about ten f32 full-frame intermediates instead.  A flat grid per frame
// (grid y the frame) keeps every block busy whatever the width.

#include <cuda_runtime.h>

#include "launch_device.cuh"

namespace {

constexpr int kThreads = 256;

struct Yuv {
  float y, u, v;
};

// one pixel in numpy's order and rounding
__device__ __forceinline__ Yuv bt601(unsigned char b8, unsigned char g8, unsigned char r8) {
  const float b = b8, g = g8, r = r8;
  const float y =
      __fadd_rn(__fadd_rn(__fmul_rn(0.299f, r), __fmul_rn(0.587f, g)), __fmul_rn(0.114f, b));
  return {y, __fadd_rn(128.0f, __fmul_rn(0.564f, __fsub_rn(b, y))),
          __fadd_rn(128.0f, __fmul_rn(0.713f, __fsub_rn(r, y)))};
}

// numpy's clip to [0, 255] and astype(uint8), which truncates toward zero
__device__ __forceinline__ unsigned char to_u8(float x) {
  return static_cast<unsigned char>(fminf(fmaxf(x, 0.0f), 255.0f));
}

__global__ void __launch_bounds__(kThreads)
    y4m_c420_kernel(const unsigned char* __restrict__ bgr, unsigned char* __restrict__ out,
                    int h, int w) {
  const int cw = w / 2;
  const int ch = h / 2;
  const int i = blockIdx.x * kThreads + threadIdx.x;      // the 2x2 block of frame blockIdx.y
  if (i >= ch * cw) return;
  const int by = i / cw;
  const int bx = i - by * cw;
  const long plane = static_cast<long>(h) * w;
  const long frame = blockIdx.y;
  const unsigned char* src = bgr + (frame * h + 2 * by) * 3L * w + 6 * bx;
  unsigned char* dst = out + frame * (plane + plane / 2);
  float u_row[2], v_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // B G R B G R of the block's row: three 2-byte loads (the wrapper
    // checks that the frames start on an even address)
    const uchar2* row = reinterpret_cast<const uchar2*>(src + r * 3L * w);
    const uchar2 p0 = row[0], p1 = row[1], p2 = row[2];
    const Yuv left = bt601(p0.x, p0.y, p1.x);
    const Yuv right = bt601(p1.y, p2.x, p2.y);
    *reinterpret_cast<uchar2*>(dst + (2L * by + r) * w + 2 * bx) =
        make_uchar2(to_u8(left.y), to_u8(right.y));
    u_row[r] = __fadd_rn(left.u, right.u);
    v_row[r] = __fadd_rn(left.v, right.v);
  }
  const long c = static_cast<long>(by) * cw + bx;
  dst[plane + c] = to_u8(__fmul_rn(__fadd_rn(u_row[0], u_row[1]), 0.25f));
  dst[plane + plane / 4 + c] = to_u8(__fmul_rn(__fadd_rn(v_row[0], v_row[1]), 0.25f));
}

__global__ void __launch_bounds__(kThreads)
    y4m_c444_kernel(const unsigned char* __restrict__ bgr, unsigned char* __restrict__ out,
                    int h, int w) {
  const int i = blockIdx.x * kThreads + threadIdx.x;      // the pixel of frame blockIdx.y
  const long plane = static_cast<long>(h) * w;
  if (i >= plane) return;
  const long frame = blockIdx.y;
  const unsigned char* px = bgr + (frame * plane + i) * 3;
  unsigned char* dst = out + frame * 3 * plane + i;
  const Yuv p = bt601(px[0], px[1], px[2]);
  dst[0] = to_u8(p.y);
  dst[plane] = to_u8(p.u);
  dst[2 * plane] = to_u8(p.v);
}

}  // namespace

// Launches the encode of `n` (1..65535) contiguous (h, w, 3) u8 BGR frames
// at `bgr` into `out`, n rows of h·w·3/2 (c420; h and w even, `bgr` on an
// even address) or h·w·3 bytes, each Y | U | V, on `stream`.  The launch
// runs with `device`, the device of the tensors and of `stream`, current
// (launch_device.cuh).  Returns cudaGetLastError() after the launch.
extern "C" int vstab_y4m_encode(const unsigned char* bgr, unsigned char* out, int n, int h,
                                int w, int c420, int device, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || (c420 && (h % 2 || w % 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long items = c420 ? static_cast<long>(h / 2) * (w / 2) : static_cast<long>(h) * w;
  if (items > 0x7fffffffL - kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const LaunchDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  const dim3 grid(static_cast<unsigned>((items + kThreads - 1) / kThreads), n);
  const auto s = static_cast<cudaStream_t>(stream);
  if (c420)
    y4m_c420_kernel<<<grid, kThreads, 0, s>>>(bgr, out, h, w);
  else
    y4m_c444_kernel<<<grid, kThreads, 0, s>>>(bgr, out, h, w);
  return static_cast<int>(cudaGetLastError());
}
