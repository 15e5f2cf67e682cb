// Occlusion-aware harmonic-mean image gradients, both axes in one pass, for
// every level of a pyramid in one launch.
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
// channel.  With a mask (one byte per pixel of an (H, W) 0/1 image, shared by
// the channels) both outputs are multiplied by it before the store, which is
// exact.  The result is bit-equal to
// rgbd360_tpu/ops/pyramid.py:gradient_xy_multi (times the mask).
// Bit-equality needs IEEE round-to-nearest division and no contraction:
// build without --use_fast_math, with -prec-div=true (the default) and
// --fmad=false.
//
// Bound: by bytes on paper (one read, two writes of 4 bytes per pixel), but
// what holds the kernel is its six IEEE divisions per pixel: nvcc expands
// each into a reciprocal estimate, a few FMAs, a range check and a branch to
// a slow path, and the branches keep the compiler from overlapping the
// divisions of neighbouring pixels, so a thread runs them as one long
// latency chain.  The design:
//
// * Divisions without branches.  Every division here is 1/b or 2/b, so one
//   correctly rounded reciprocal serves: MUFU.RCP, then two Newton steps in
//   FMAs whose last is Markstein's correction (the residual 1 - b*y is
//   exact), which is RN(1/b) for every b with 2^-60 <= |b| <= 2^60.  That is
//   not taken on trust: `rgbd360_check_fast_reciprocal` compares it with
//   1.0f / b for every float of that range, on the card.  A row whose
//   operands leave the range (denormals, infinities, NaN) is recomputed
//   with the compiler's division, one branch per row instead of one per
//   division, so the result is IEEE division's for every input.
// * A warp owns a tile of 32*VEC columns by 2 rows of one channel; a
//   thread owns VEC consecutive pixels of each row of the tile.  VEC = 4
//   where the width and the pointers allow 16-byte accesses (every width of
//   the pyramid), else the same code runs at VEC = 1.
// * The thread loads its 4 rows (the strip and one halo row above and
//   below) into registers up front, so all of a thread's loads are in
//   flight together.  The left and right neighbours of a thread's pixels
//   come from the adjacent lanes by warp shuffle; only lane 0 and lane 31
//   load one extra scalar per row.  Registers and shuffles were taken over a
//   shared-memory tile filled with cp.async: a three-point stencil shares
//   nothing between warps except the halo rows, so a tile in shared memory
//   would add a barrier and a second pass over the data for no reuse.  A
//   three-point stencil has no matrix product, so it has no use for the
//   tensor cores, and TMA would stage tiles that the registers already hold.
//   The strip is 2 rows tall (PERF.md): a taller strip reads fewer halo
//   rows, but the re-reads hit L1/L2, while it lengthens each thread's
//   chain of arithmetic and leaves fewer warps to hide it (strips of 4, 8
//   and 16 rows measured slower at every size, strips of 1 row only faster
//   below the size of a pyramid's launch).
// * One launch takes up to 16 stacks (the gray and the depth of every
//   level): their descriptors travel by value as a __grid_constant__ struct,
//   and a block finds its stack by the prefix of block counts.  The tile
//   plan (VEC, tile counts, first block) is computed by the Python wrapper
//   (ops/hopper_kernels.gradient_plan), where the CPU tests reach it.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (device time, L2 cold; the
// one-thread-per-pixel kernel this replaces in the same run, in brackets):
// 9.2 us at 2x320x1920 (14.6), 26.2 us at 8x320x1920 (51.5), 4.3 us at
// 2x160x960 (5.5), and 12.8 us for one frame's 10 stacks with their masks in
// ONE launch (80.6 us in 25 device ops); 0.48-0.67 of the bytes bound at the
// large shapes.  A single stack of 2x80x480 or less, which no path launches
// on its own, takes 3.1-3.6 us (2.6-3.1).  PERF.md has every shape.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;       // warps per block, one tile each
constexpr int kRows = 2;        // rows per tile (GRAD_ROWS of the wrapper)
constexpr int kMaxStacks = 16;  // descriptors per launch

// One (C, H, W) stack and its plan.  The layout (4 pointers, 8 ints) is
// mirrored by ops/hopper_kernels._GradStack.
struct GradStack {
  const float* img;
  float* gx;
  float* gy;
  const unsigned char* mask;  // (H, W) bytes of 0/1, or null
  int c, h, w;
  int vec;          // pixels per thread: 4 or 1
  int tiles_x;      // ceil(w / (32 * vec))
  int tiles_y;      // ceil(h / kRows)
  int tiles;        // c * tiles_y * tiles_x
  int first_block;  // of this stack in the launch's grid
};

struct GradGroup {
  GradStack stack[kMaxStacks];
  int n;
  int pad;
};

// The reciprocal's proven range: 2^-60 <= |b| <= 2^60, as bit patterns.
constexpr unsigned int kRcpLo = 0x21800000u;
constexpr unsigned int kRcpHi = 0x5d800000u;

// RN(1/b) for kRcpLo <= bits(|b|) <= kRcpHi, else `unsafe` is set and the
// value is not to be used.
__device__ __forceinline__ float rcp_rn(float b, bool& unsafe) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(b));
  float e = __fmaf_rn(-b, y, 1.0f);
  y = __fmaf_rn(y, e, y);
  e = __fmaf_rn(-b, y, 1.0f);  // exact: y is within an ulp of 1/b
  y = __fmaf_rn(y, e, y);
  const unsigned int u = __float_as_uint(b) & 0x7fffffffu;
  unsafe = unsafe || (u - kRcpLo) > (kRcpHi - kRcpLo);
  return y;
}

// harmonic() below with rcp_rn for its divisions: 2/d is 2 * RN(1/d), since
// scaling by 2 commutes with rounding inside the range.
__device__ __forceinline__ float harmonic_fast(float fwd, float bwd, bool& unsafe) {
  const bool mono = (fwd > 0.0f && bwd > 0.0f) || (fwd < 0.0f && bwd < 0.0f);
  const float df = fwd == 0.0f ? 1e-12f : fwd;
  const float db = bwd == 0.0f ? 1e-12f : bwd;
  float denom = rcp_rn(df, unsafe) + rcp_rn(db, unsafe);
  denom = denom == 0.0f ? 1e-12f : denom;
  return mono ? 2.0f * rcp_rn(denom, unsafe) : 0.0f;
}

__device__ __forceinline__ float harmonic(float fwd, float bwd) {
  const bool mono = (fwd > 0.0f && bwd > 0.0f) || (fwd < 0.0f && bwd < 0.0f);
  const float df = fwd == 0.0f ? 1e-12f : fwd;
  const float db = bwd == 0.0f ? 1e-12f : bwd;
  float denom = 1.0f / df + 1.0f / db;
  denom = denom == 0.0f ? 1e-12f : denom;
  return mono ? 2.0f / denom : 0.0f;
}

template <int VEC>
__device__ __forceinline__ void load_px(float (&v)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store_px(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

template <int VEC>
__device__ __forceinline__ void load_mask(float (&m)[VEC], const unsigned char* p) {
  if constexpr (VEC == 4) {
    const uchar4 q = *reinterpret_cast<const uchar4*>(p);
    m[0] = static_cast<float>(q.x); m[1] = static_cast<float>(q.y);
    m[2] = static_cast<float>(q.z); m[3] = static_cast<float>(q.w);
  } else {
    m[0] = static_cast<float>(*p);
  }
}

// One warp's tile.  Every lane runs every shuffle: a lane past the right
// edge is inactive (loads nothing, stores nothing) but still takes part.
template <int VEC>
__device__ __forceinline__ void grad_tile(const GradStack& s, int tile, int lane) {
  const int tx = tile % s.tiles_x;
  const int rest = tile / s.tiles_x;
  const int ty = rest % s.tiles_y;
  const int ch = rest / s.tiles_y;
  const int h = s.h, w = s.w;
  const int x0 = (tx * 32 + lane) * VEC;  // this thread's first column
  const int y0 = ty * kRows;              // the strip's first row
  const bool active = x0 < w;             // VEC divides w, so all VEC are in
  const size_t plane = static_cast<size_t>(ch) * h * w;
  const float* __restrict__ img = s.img + plane;
  float* __restrict__ gx = s.gx + plane;
  float* __restrict__ gy = s.gy + plane;
  const unsigned char* __restrict__ mask = s.mask;

  // rows y0-1 .. y0+kRows of this thread's columns, and the strip rows' one
  // column to the left (lane 0) and to the right (lane 31)
  float px[kRows + 2][VEC];
  float edge_l[kRows], edge_r[kRows];
#pragma unroll
  for (int r = 0; r < kRows + 2; ++r) {
    const int y = y0 + r - 1;
#pragma unroll
    for (int k = 0; k < VEC; ++k) px[r][k] = 0.0f;
    if (active && y >= 0 && y < h) load_px<VEC>(px[r], img + y * w + x0);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int y = y0 + r;
    edge_l[r] = 0.0f;
    edge_r[r] = 0.0f;
    if (active && y < h) {
      if (lane == 0 && x0 > 0) edge_l[r] = img[y * w + x0 - 1];
      if (lane == 31 && x0 + VEC < w) edge_r[r] = img[y * w + x0 + VEC];
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int y = y0 + r;
    const float (&prev)[VEC] = px[r];
    const float (&cur)[VEC] = px[r + 1];
    const float (&next)[VEC] = px[r + 2];
    float left = __shfl_up_sync(0xffffffffu, cur[VEC - 1], 1);
    float right = __shfl_down_sync(0xffffffffu, cur[0], 1);
    if (lane == 0) left = edge_l[r];
    if (lane == 31) right = edge_r[r];
    const bool store = active && y < h;
    const bool inner_y = y > 0 && y < h - 1;
    float out_x[VEC], out_y[VEC];
    float fx[VEC], bx[VEC], fy[VEC], by[VEC];  // forward, backward differences
    bool unsafe = false;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float c = cur[k];
      const float l = k == 0 ? left : cur[k == 0 ? 0 : k - 1];
      const float rt = k == VEC - 1 ? right : cur[k == VEC - 1 ? k : k + 1];
      fx[k] = rt - c;
      bx[k] = c - l;
      fy[k] = next[k] - c;
      by[k] = c - prev[k];
      out_x[k] = harmonic_fast(fx[k], bx[k], unsafe);
      out_y[k] = harmonic_fast(fy[k], by[k], unsafe);
    }
    if (unsafe) {  // rare: an operand outside rcp_rn's range
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        out_x[k] = harmonic(fx[k], bx[k]);
        out_y[k] = harmonic(fy[k], by[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int x = x0 + k;
      if (!(x > 0 && x < w - 1)) out_x[k] = 0.0f;
      if (!inner_y) out_y[k] = 0.0f;
    }
    if (store) {
      if (mask != nullptr) {
        float m[VEC];
        load_mask<VEC>(m, mask + y * w + x0);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          out_x[k] = out_x[k] * m[k];
          out_y[k] = out_y[k] * m[k];
        }
      }
      store_px<VEC>(gx + y * w + x0, out_x);
      store_px<VEC>(gy + y * w + x0, out_y);
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
fused_gradients_kernel(const __grid_constant__ GradGroup g) {
  const int block = static_cast<int>(blockIdx.x);
  int which = 0;
  for (int i = 1; i < g.n; ++i) {
    if (block >= g.stack[i].first_block) which = i;
  }
  const GradStack& s = g.stack[which];
  const int lane = threadIdx.x & 31;
  const int tile = (block - s.first_block) * kWarps + (threadIdx.x >> 5);
  if (tile >= s.tiles) return;  // the whole warp leaves together
  if (s.vec == 4) {
    grad_tile<4>(s, tile, lane);
  } else {
    grad_tile<1>(s, tile, lane);
  }
}

// Every float b with kRcpLo <= bits(|b|) <= kRcpHi, both signs: rcp_rn(b)
// against 1.0f / b.  result[0] counts the mismatches, result[1] keeps the
// bits of one of them.
__global__ void check_rcp_kernel(unsigned long long* result) {
  const unsigned long long span = static_cast<unsigned long long>(kRcpHi - kRcpLo) + 1;
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  unsigned int bad = 0, bad_bits = 0;
  for (unsigned long long i = static_cast<unsigned long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < 2 * span; i += stride) {
    const unsigned int bits = (i < span ? static_cast<unsigned int>(i)
                                        : static_cast<unsigned int>(i - span) | 0x80000000u) +
                              kRcpLo;
    const float b = __uint_as_float(bits);
    bool unsafe = false;
    const float fast = rcp_rn(b, unsafe);
    const float exact = 1.0f / b;
    if (unsafe || __float_as_uint(fast) != __float_as_uint(exact)) {
      ++bad;
      bad_bits = bits;
    }
  }
  if (bad) {
    atomicAdd(result, static_cast<unsigned long long>(bad));
    result[1] = bad_bits;
  }
}

}  // namespace

extern "C" {

// Compares the kernel's branch-free reciprocal with IEEE division for every
// float of its range (2^-60 <= |b| <= 2^60, about 2e9 values); `result` is
// two zeroed 64-bit words on the device: the mismatch count, and the bits of
// one mismatching b.  Returns cudaGetLastError() after the launch.
int rgbd360_check_fast_reciprocal(unsigned long long* result, cudaStream_t stream) {
  check_rcp_kernel<<<132 * 16, 256, 0, stream>>>(result);
  return static_cast<int>(cudaGetLastError());
}

// Launches one kernel on `stream` over the `n` stacks of the GradGroup at
// `group_ptr` (a host pointer; the struct goes to the kernel by value), `blocks`
// blocks in all.  Every stack is f32 and contiguous;
// a stack with vec == 4 has a width that is a multiple of 4, 16-byte
// aligned img, gx and gy, and a 4-byte aligned mask.  Returns
// cudaGetLastError() after the launch.
int rgbd360_fused_gradients_levels(const void* group_ptr, int blocks,
                                   cudaStream_t stream) {
  // (a void pointer: a parameter of a type from the unnamed namespace
  // would give this function internal linkage)
  const GradGroup* group = static_cast<const GradGroup*>(group_ptr);
  if (group->n < 1 || group->n > kMaxStacks) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  const unsigned int grid = static_cast<unsigned int>(blocks);
  fused_gradients_kernel<<<grid, kWarps * 32, 0, stream>>>(*group);
  return static_cast<int>(cudaGetLastError());
}

const char* rgbd360_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
