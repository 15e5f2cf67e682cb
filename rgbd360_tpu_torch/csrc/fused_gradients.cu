// Occlusion-aware harmonic-mean image gradients, both axes in one pass.
//
// Replaces the TPU kernel rgbd360_tpu/ops/pallas_kernels.py:fused_gradients
// (body `_grad_kernel`).  For every pixel of a stacked (C, H, W) f32 tensor:
//
//   g = 2 / (1/fwd + 1/bwd)   where the pixel lies strictly between its two
//                             neighbours along the axis, else 0;
//   a zero difference is replaced by 1e-12, and so is a zero denominator.
//
// The border columns of gx and the border rows of gy are zeroed, so the
// column wrap and the edge-clamped row halo of the Pallas kernel never reach
// an output: an interior pixel reads only in-bounds neighbours of its own
// channel.  The result is bit-equal to
// rgbd360_tpu/ops/pyramid.py:gradient_xy_multi.  Bit-equality needs IEEE
// round-to-nearest division and no contraction: build without
// --use_fast_math, with -prec-div=true (the default) and --fmad=false.
//
// Bound: HBM bytes.  The arithmetic is a handful of flops per pixel; a
// 320x1920x2 call reads 4.9 MB and writes 9.8 MB.  The design answers that
// with ONE pass that produces both axes of every channel (the TPU path ran
// one kernel per image, and the reference's plain form one pass per axis),
// with one thread per output pixel so that a warp's loads and stores are
// coalesced along a row; the four neighbour reads hit L1/L2 lines that the
// neighbouring threads and rows share.  Shared-memory tiling is later work.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float harmonic(float fwd, float bwd) {
  const bool mono = (fwd > 0.0f && bwd > 0.0f) || (fwd < 0.0f && bwd < 0.0f);
  const float df = fwd == 0.0f ? 1e-12f : fwd;
  const float db = bwd == 0.0f ? 1e-12f : bwd;
  float denom = 1.0f / df + 1.0f / db;
  denom = denom == 0.0f ? 1e-12f : denom;
  return mono ? 2.0f / denom : 0.0f;
}

__global__ void fused_gradients_kernel(const float* __restrict__ img,
                                       float* __restrict__ gx,
                                       float* __restrict__ gy, int h, int w,
                                       long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int x = static_cast<int>(i % w);
  const long long row = i / w;  // channel * h + y
  const int y = static_cast<int>(row % h);
  const float* line = img + row * w;
  const float c = line[x];

  float out_x = 0.0f;
  if (x > 0 && x < w - 1) {
    out_x = harmonic(line[x + 1] - c, c - line[x - 1]);
  }
  float out_y = 0.0f;
  if (y > 0 && y < h - 1) {
    out_y = harmonic(line[x + w] - c, c - line[x - w]);
  }
  gx[i] = out_x;
  gy[i] = out_y;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` over img (c, h, w) -> gx, gy (c, h, w),
// all f32 and contiguous.  Returns cudaGetLastError() after the launch.
int rgbd360_fused_gradients(const float* img, float* gx, float* gy, int c,
                            int h, int w, cudaStream_t stream) {
  const long long total = static_cast<long long>(c) * h * w;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  fused_gradients_kernel<<<static_cast<unsigned int>(blocks), threads, 0, stream>>>(
      img, gx, gy, h, w, total);
  return static_cast<int>(cudaGetLastError());
}

const char* rgbd360_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
