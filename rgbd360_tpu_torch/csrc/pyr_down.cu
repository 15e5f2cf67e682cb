// 5-tap binomial blur on both axes, then 2x decimation (cv::pyrDown).
//
// Replaces the TPU kernel rgbd360_tpu/ops/pallas_kernels.py:fused_pyr_down
// (body `_pyr_down_kernel`).  For a stacked (C, H, W) f32 tensor with even
// H and W, every output pixel (c, i, j) of the (C, H/2, W/2) result is
//
//   v(col) = k0*(x[r-2] + x[r+2]) + k1*(x[r-1] + x[r+1]) + k2*x[r],  r = 2i
//   out    = k0*(v[s-2] + v[s+2]) + k1*(v[s-1] + v[s+1]) + k2*v[s],  s = 2j
//
// with k0, k1, k2 = 1/16, 4/16, 6/16, the additions in exactly that order
// (the Pallas body's), columns circular (azimuth wraps), and rows either
// edge-clamped (the Pallas kernel's `mode="edge"` padding) or circular (what
// the banded-matmul pyrDown of ops/pyramid.py computes).  Built without
// contraction (--fmad=false) it is bit-equal to the plain PyTorch version in
// ops/hopper_kernels.py.
//
// Bound: launch latency, then HBM bytes.  A (4, 320, 1920) call reads
// 9.8 MB and writes 2.5 MB; each thread does 30 adds and multiplies.  On an
// H100 (80GB HBM3, 700 W) that call takes 12.0 us of device time (~1 TB/s)
// and the smaller levels ~2 us, the floor of a launch.  One thread per
// output pixel reads its 5x5 window through L1: neighbouring threads of a
// warp share most of their lines, so DRAM sees each input byte about once.
// The Pallas kernel's DMA of a row stripe plus halo into VMEM exists
// because a TPU grid step must stage its window by hand; on Hopper the
// cache does that, and blocks run in any order, so the stripe scheme is
// not copied.  A shared-memory halo tile is later work.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

__device__ __forceinline__ float blur5(float m2, float m1, float c, float p1,
                                       float p2) {
  const float k0 = 1.0f / 16.0f, k1 = 4.0f / 16.0f, k2 = 6.0f / 16.0f;
  return k0 * (m2 + p2) + k1 * (m1 + p1) + k2 * c;
}

__global__ void pyr_down_kernel(const float* __restrict__ img,
                                float* __restrict__ out, int h, int w,
                                int circular_rows, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int w2 = w / 2, h2 = h / 2;
  const int ox = static_cast<int>(i % w2);
  const long long t = i / w2;
  const int oy = static_cast<int>(t % h2);
  const long long ch = t / h2;
  const float* plane = img + ch * h * w;

  const float* rows[5];
  for (int d = 0; d < 5; ++d) {
    int r = 2 * oy + d - 2;
    r = circular_rows ? wrap(r, h) : min(max(r, 0), h - 1);
    rows[d] = plane + static_cast<long long>(r) * w;
  }
  float v[5];
  for (int d = 0; d < 5; ++d) {
    const int col = wrap(2 * ox + d - 2, w);
    v[d] = blur5(rows[0][col], rows[1][col], rows[2][col], rows[3][col],
                 rows[4][col]);
  }
  out[i] = blur5(v[0], v[1], v[2], v[3], v[4]);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` over img (c, h, w) -> out (c, h/2, w/2),
// both f32 and contiguous, h and w even.  circular_rows: 0 = edge-clamped
// rows, 1 = circular rows.  Returns cudaGetLastError() after the launch.
int rgbd360_pyr_down(const float* img, float* out, int c, int h, int w,
                     int circular_rows, cudaStream_t stream) {
  const long long total = static_cast<long long>(c) * (h / 2) * (w / 2);
  if (total == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  pyr_down_kernel<<<static_cast<unsigned int>(blocks), threads, 0, stream>>>(
      img, out, h, w, circular_rows, total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
