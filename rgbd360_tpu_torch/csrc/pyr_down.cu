// One pyramid level transition in one launch: the gray's 5-tap binomial blur
// on both axes with 2x decimation (cv::pyrDown), and the depth's 2x2 mean
// over valid depths.
//
// Replaces the TPU kernel rgbd360_tpu/ops/pallas_kernels.py:fused_pyr_down
// (body `_pyr_down_kernel`).  For a stacked (C, H, W) f32 gray tensor with
// even H and W, every output pixel (c, i, j) of the (C, H/2, W/2) result is
//
//   v(col) = k0*(x[r-2] + x[r+2]) + k1*(x[r-1] + x[r+1]) + k2*x[r],  r = 2i
//   out    = k0*(v[s-2] + v[s+2]) + k1*(v[s-1] + v[s+1]) + k2*v[s],  s = 2j
//
// with k0, k1, k2 = 1/16, 4/16, 6/16, the additions in exactly that order
// (the Pallas body's), columns circular (azimuth wraps), and rows either
// edge-clamped (the Pallas kernel's `mode="edge"` padding) or circular (what
// the banded-matmul pyrDown of ops/pyramid.py computes).  For a (C, H, W)
// depth tensor the same launch computes, per 2x2 block,
//
//   valid = min < d < max;  s = (m00 + m10) + (m01 + m11) over the masked
//   depths, n likewise over `valid`;  out = n > 0.5 ? s / max(n, 1) : 0
//
// which is the order of the 0/1 matmul pair (rows, then columns) of
// ops/pyramid.py:fused_level_down.  Built without contraction
// (--fmad=false, -prec-div=true) both are bit-equal to the plain PyTorch
// versions in ops/hopper_kernels.py.
//
// Bound: HBM bytes at the largest level (each input read once, a quarter as
// much written), launches at the small ones.  The design:
//
// * A block owns 4 x 64 outputs of one channel.  For a gray channel it
//   stages the 11-row input window in shared memory, 136 columns
//   wide (the 131 it needs, widened to 16-byte chunks), with 16-byte
//   cp.async copies whose row index is wrapped or clamped and whose chunk
//   index is wrapped by the loader; it then computes the vertical blur v
//   once per window column into shared memory and the horizontal blur at
//   the even columns from there, and stores coalesced rows.  No global load
//   has a stride of 2 and no v is computed twice inside a tile.  A width
//   that is not a multiple of 4, or a pointer that is not 16-byte aligned,
//   takes the same kernel with a 4-byte loader that wraps every column.
// * TMA is not used: its out-of-range fill is zero, which is neither wrap
//   nor clamp, so only interior tiles could take it, and a window of 11 x
//   136 floats is staged by 256 threads in two cp.async copies each; a
//   second code path for the interior would buy nothing at these sizes.
// * A depth channel's block has no halo: a thread loads two float4 of two
//   rows (four 2x2 blocks' worth of two outputs) and stores a float2.
// * The grid is (column tiles, row tiles, gray channels + depth channels),
//   so no thread divides to find its tile.  The tile plan is computed by
//   the Python wrapper (ops/hopper_kernels.level_down_plan), where the CPU
//   tests reach it.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (device time, L2 cold; the
// one-thread-per-output kernel this replaces in the same run, in brackets):
// 9.2 us at 4x320x1920 (13.2), 4.2 us at 1x320x1920 (4.8), 2.3-2.8 us at the
// smaller levels (the floor of a launch); a whole transition, gray and depth,
// 5.2 us at 1x320x1920 (131 us in 15 device ops with the depth's matmul
// pair).  The banded A @ img @ B sandwich takes 43 us there.  Tiles of 8 rows
// are 0.9 us faster at 4x320x1920 and 0.1-0.7 us slower everywhere else, so
// there is one tile height.  PERF.md has every shape.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 64;               // outputs per tile row
constexpr int kTileH = 4;                // output rows per tile (LD_TILE_H of the wrapper)
constexpr int kThreads = 256;
constexpr int kSpan = 2 * kTileW + 8;    // staged columns: image columns
                                         // [2*ox0 - 4, 2*ox0 + 2*kTileW + 4)

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

__device__ __forceinline__ float blur5(float m2, float m1, float c, float p1,
                                       float p2) {
  const float k0 = 1.0f / 16.0f, k1 = 4.0f / 16.0f, k2 = 6.0f / 16.0f;
  return k0 * (m2 + p2) + k1 * (m1 + p1) + k2 * c;
}

// The blur of one kTileH x kTileW tile of one gray channel.  `win` holds
// (2 kTileH + 3) x kSpan floats, `vb` kTileH x kSpan.
__device__ __forceinline__ void blur_tile(const float* __restrict__ plane,
                                          float* __restrict__ out_plane, int h,
                                          int w, int circular_rows, int vec,
                                          int ox0, int oy0, float* win,
                                          float* vb) {
  constexpr int kRows = 2 * kTileH + 3;
  const int tid = threadIdx.x;
  const int col0 = 2 * ox0 - 4;  // a multiple of 4
  const int row0 = 2 * oy0 - 2;

  if (vec) {
    constexpr int kChunks = kSpan / 4;
    const int w_chunks = w / 4;
    const int chunk0 = col0 / 4;
    for (int i = tid; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int k = i - r * kChunks;
      const int y = circular_rows ? wrap(row0 + r, h) : min(max(row0 + r, 0), h - 1);
      const int x = 4 * wrap(chunk0 + k, w_chunks);
      __pipeline_memcpy_async(win + r * kSpan + 4 * k, plane + y * w + x, 16);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
  } else {
    for (int i = tid; i < kRows * kSpan; i += kThreads) {
      const int r = i / kSpan;
      const int k = i - r * kSpan;
      const int y = circular_rows ? wrap(row0 + r, h) : min(max(row0 + r, 0), h - 1);
      win[i] = plane[y * w + wrap(col0 + k, w)];
    }
  }
  __syncthreads();

  // v of output row ty at every staged column: window rows 2 ty .. 2 ty + 4
  for (int i = tid; i < kTileH * kSpan; i += kThreads) {
    const int ty = i / kSpan;
    const int k = i - ty * kSpan;
    const float* col = win + 2 * ty * kSpan + k;
    vb[i] = blur5(col[0], col[kSpan], col[2 * kSpan], col[3 * kSpan], col[4 * kSpan]);
  }
  __syncthreads();

  // output column ox0 + tx is image column 2 (ox0 + tx) = col0 + 4 + 2 tx
  const int w2 = w / 2, h2 = h / 2;
  for (int i = tid; i < kTileH * kTileW; i += kThreads) {
    const int ty = i / kTileW;
    const int tx = i - ty * kTileW;
    const int ox = ox0 + tx, oy = oy0 + ty;
    if (ox < w2 && oy < h2) {
      const float* v = vb + ty * kSpan + 2 * tx + 2;
      out_plane[oy * w2 + ox] = blur5(v[0], v[1], v[2], v[3], v[4]);
    }
  }
}

__device__ __forceinline__ float valid_mean(float d00, float d10, float d01,
                                            float d11, float lo, float hi) {
  const bool v00 = d00 > lo && d00 < hi, v10 = d10 > lo && d10 < hi;
  const bool v01 = d01 > lo && d01 < hi, v11 = d11 > lo && d11 < hi;
  const float s = ((v00 ? d00 : 0.0f) + (v10 ? d10 : 0.0f)) +
                  ((v01 ? d01 : 0.0f) + (v11 ? d11 : 0.0f));
  const float n = ((v00 ? 1.0f : 0.0f) + (v10 ? 1.0f : 0.0f)) +
                  ((v01 ? 1.0f : 0.0f) + (v11 ? 1.0f : 0.0f));
  return n > 0.5f ? s / fmaxf(n, 1.0f) : 0.0f;
}

// The valid mean of one kTileH x kTileW tile of one depth channel.
__device__ __forceinline__ void depth_tile(const float* __restrict__ plane,
                                           float* __restrict__ out_plane, int h,
                                           int w, int vec, int ox0, int oy0,
                                           float lo, float hi) {
  const int tid = threadIdx.x;
  const int w2 = w / 2, h2 = h / 2;
  if (vec) {
    // two outputs per thread: w is a multiple of 4, so w2 is even
    for (int i = tid; i < kTileH * (kTileW / 2); i += kThreads) {
      const int ty = i / (kTileW / 2);
      const int ox = ox0 + 2 * (i - ty * (kTileW / 2));
      const int oy = oy0 + ty;
      if (ox < w2 && oy < h2) {
        const float* top = plane + 2 * oy * w + 2 * ox;
        const float4 a = *reinterpret_cast<const float4*>(top);
        const float4 b = *reinterpret_cast<const float4*>(top + w);
        *reinterpret_cast<float2*>(out_plane + oy * w2 + ox) =
            make_float2(valid_mean(a.x, b.x, a.y, b.y, lo, hi),
                        valid_mean(a.z, b.z, a.w, b.w, lo, hi));
      }
    }
  } else {
    for (int i = tid; i < kTileH * kTileW; i += kThreads) {
      const int ty = i / kTileW;
      const int ox = ox0 + (i - ty * kTileW);
      const int oy = oy0 + ty;
      if (ox < w2 && oy < h2) {
        const float* top = plane + 2 * oy * w + 2 * ox;
        out_plane[oy * w2 + ox] = valid_mean(top[0], top[w], top[1], top[w + 1], lo, hi);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
level_down_kernel(const float* __restrict__ gray, float* __restrict__ gray_out,
                  int c_gray, const float* __restrict__ depth,
                  float* __restrict__ depth_out, int h, int w, int circular_rows,
                  float lo, float hi, int vec_gray, int vec_depth) {
  __shared__ __align__(16) float win[(2 * kTileH + 3) * kSpan];
  __shared__ float vb[kTileH * kSpan];
  const int ox0 = blockIdx.x * kTileW;
  const int oy0 = blockIdx.y * kTileH;
  const int z = blockIdx.z;
  const size_t in_plane = static_cast<size_t>(h) * w;
  const size_t out_plane = static_cast<size_t>(h / 2) * (w / 2);
  if (z < c_gray) {
    blur_tile(gray + z * in_plane, gray_out + z * out_plane, h, w,
                  circular_rows, vec_gray, ox0, oy0, win, vb);
  } else {
    const int ch = z - c_gray;
    depth_tile(depth + ch * in_plane, depth_out + ch * out_plane, h, w,
                   vec_depth, ox0, oy0, lo, hi);
  }
}

}  // namespace

extern "C" {

// Launches one kernel on `stream`: gray (c_gray, h, w) -> gray_out
// (c_gray, h/2, w/2) by the blur, and depth (c_depth, h, w) -> depth_out
// (c_depth, h/2, w/2) by the valid mean over lo < d < hi; all f32 and
// contiguous, h and w even, either channel count may be 0 (its pointers are
// then not read).  circular_rows: 0 = edge-clamped rows, 1 = circular rows.
// vec_gray / vec_depth: 1 where w is a multiple of 4 and that tensor's input
// (and, for the depth, 8-byte aligned output) allow 16-byte accesses.
// Returns cudaGetLastError() after the launch.
int rgbd360_level_down(const float* gray, float* gray_out, int c_gray,
                       const float* depth, float* depth_out, int c_depth, int h,
                       int w, int circular_rows, float lo, float hi,
                       int vec_gray, int vec_depth, cudaStream_t stream) {
  const int h2 = h / 2, w2 = w / 2;
  if (h2 == 0 || w2 == 0 || c_gray + c_depth == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((w2 + kTileW - 1) / kTileW, (h2 + kTileH - 1) / kTileH, c_gray + c_depth);
  level_down_kernel<<<grid, kThreads, 0, stream>>>(
      gray, gray_out, c_gray, depth, depth_out, h, w, circular_rows, lo, hi,
      vec_gray, vec_depth);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
