// The normal equations of one dense Gauss-Newton sweep: H = sum J^T J and
// g = sum J^T r over the pixels of each element of a batch, with the sums of
// squared residuals and the counts beside them, in two launches.
//
// Replaces no TPU kernel: the JAX package leaves this reduction to XLA
// (rgbd360_tpu/registration/dense.py:_hess_grad_packed).  On the card the
// port had it as `J.mT @ J` and `J.mT @ r` in PyTorch, which cuBLAS runs as a
// GEMM with a 32x32 output tile of which 6x6 is used, walking the whole
// pixel axis (614,400 long at level 0) on a handful of blocks: the largest
// device operation of the tracker.  For every pixel p of element b and each
// residual term t (photo, depth) given:
//
//   c = [a, tp x a]                     (a: the Jacobian's prefix, 3 floats;
//                                        the cross product as torch.linalg.cross)
//   j = mask ? c * w : 0                (selected, never multiplied by the
//                                        mask: a non-finite a or tp under a
//                                        masked pixel must not reach a sum)
//   H += j j^T,  g += j r,  sq_t += r r,  n_t += mask,  visible += vis
//
// H and g sum over the terms.  This is ops/hopper_kernels.normal_equations_plain
// up to the order of the float32 sums (parity by tolerance, tests/test_torch_cuda.py).
//
// Bound: bytes.  Per pixel 12 B of tp, 1 B of the visible mask and 21 B a term
// (12 of a, 4 of w, 4 of r, 1 of the mask), read once: ~3 flops a byte
// against the card's ~20 for float32.  The design:
//
// * Pass 1: a block of 256 threads owns a fixed chunk of kChunk pixels of one
//   element (grid: chunks x batch).  Each thread walks its pixels, 256 apart
//   so that a warp reads neighbouring addresses, and keeps the 21 upper
//   terms of H, the 6 of g, the squared sums and the counts in registers
//   (fused multiply-adds, float32).  The block reduces them by warp
//   shuffles, then across its warps in a fixed order through shared memory,
//   and writes one partial of kWords words.
// * Pass 2: one block per element sums that element's partials: warp w takes
//   partials w, w + 8, ... in order, a lane a word (each load one 128-byte
//   partial), then the warps' sums in a fixed order; it mirrors H's lower
//   triangle and writes the outputs.
// * No atomics, and the partition depends on (batch, pixels) only: a sweep is
//   bit-identical run to run, which the CUDA graphs of the GN loop and their
//   tests rely on.  Both launches go on the caller's stream and allocate
//   nothing (the wrapper's `torch.empty` gives the scratch), so a CUDA graph
//   captures them.
// * The sums are a tree over each chunk's 256 threads, then short serial
//   sums over the chunks, not a serial walk of the pixel axis: on the
//   benchmark's sweeps H lies within 1.4e-7 (relative Frobenius) of a
//   float64 sum, where the GEMM it replaces read up to 3.1e-6.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (device time, L2 cold /
// warm; the GEMM path it replaces, 30-39 device ops, in brackets): 27.0 /
// 16.4 us at 1 x 614,400 pixels (378.5 / 374.8), 56.4 / 48.3 us at 3 x
// 614,400 (35,607 / 35,597: cuBLAS's batched product at three elements),
// 11.1 / 7.1 us at 1 x 153,600 (192.8 / 183.8), 9.5 / 6.4 us at 3 x 16,384
// (679.5 / 665.9) and 9.3 / 6.4 us at 16 x 2,400 (179.5 / 170.9); 0.37 /
// 0.61 of the bytes bound at level 0 with one element, 0.54 / 0.63 with
// three.  Pass 2 is 3.1 us of the warm 16.4 (it was 7.4 with a thread per
// partial, whose loads did not coalesce).  Chunks of 1024 to 8192 pixels,
// and 1, 2 or 4 pixels loaded before they are summed, moved no shape by more
// than ~10 us (CUDA events, both launches): there is one chunk.  PERF.md has
// every shape.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 2048;      // pixels a pass-1 block (NEQ_CHUNK of the wrapper)
constexpr int kWords = 32;        // a partial (NEQ_WORDS): 21 H, 6 g, 2 sq, 3 counts
constexpr int kSums = 29;         // its float words; words 29-31 hold int counts
constexpr int kMaxTerms = 2;
static_assert(kWords == 32, "pass 2 reads a partial with one warp, a lane a word");

struct Term {
  const float* a;                 // (B, N, 3)
  const float* w;                 // (B, N)
  const unsigned char* mask;      // (B, N) bool
  const float* r;                 // (B, N)
};

struct Args {
  const float* tp;                // (B, N, 3)
  const unsigned char* visible;   // (B, N) bool
  Term term[kMaxTerms];
  int batch, n, chunks;
  float* partial;                 // (B, chunks, kWords)
  float* hess;                    // (B, 6, 6)
  float* grad;                    // (B, 6)
  float* sq;                      // (terms, B)
  long long* count;               // (terms + 1, B): each term's mask count, then visible
};

// Sums each thread's v[kSums] and cnt[3] over the block, in a fixed order.
// On return thread k < kSums holds the sum of word k in *sum, and thread
// k < 3 the sum of count k in *total.
__device__ __forceinline__ void block_sum(float (&v)[kSums], int (&cnt)[3], float* sum,
                                          int* total) {
  __shared__ float fs[kWarps][kSums];
  __shared__ int is[kWarps][3];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    float x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) fs[warp][k] = x;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int x = __reduce_add_sync(0xffffffffu, cnt[k]);
    if (lane == 0) is[warp][k] = x;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float s = fs[0][threadIdx.x];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) s += fs[i][threadIdx.x];
    *sum = s;
  }
  if (threadIdx.x < 3) {
    int s = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += is[i][threadIdx.x];
    *total = s;
  }
}

template <int T>
__global__ void __launch_bounds__(kThreads) neq_partial_kernel(const __grid_constant__ Args a) {
  const int chunk = blockIdx.x, b = blockIdx.y;
  const long long base = static_cast<long long>(b) * a.n;
  const int lo = chunk * kChunk;
  const int hi = min(lo + kChunk, a.n);
  float v[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) v[k] = 0.0f;
  int cnt[3] = {0, 0, 0};
#pragma unroll 2
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    const long long p = base + i;
    const float tx = a.tp[3 * p], ty = a.tp[3 * p + 1], tz = a.tp[3 * p + 2];
    cnt[2] += a.visible[p];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const Term& e = a.term[t];
      const float ax = e.a[3 * p], ay = e.a[3 * p + 1], az = e.a[3 * p + 2];
      const float w = e.w[p], r = e.r[p];
      const bool m = e.mask[p] != 0;
      const float c[6] = {ax, ay, az, ty * az - tz * ay, tz * ax - tx * az, tx * ay - ty * ax};
      float j[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) j[k] = m ? c[k] * w : 0.0f;
      int q = 0;
#pragma unroll
      for (int row = 0; row < 6; ++row) {
#pragma unroll
        for (int col = row; col < 6; ++col, ++q) v[q] = __fmaf_rn(j[row], j[col], v[q]);
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) v[21 + k] = __fmaf_rn(j[k], r, v[21 + k]);
      v[27 + t] = __fmaf_rn(r, r, v[27 + t]);
      cnt[t] += m;
    }
  }
  float sum = 0.0f;
  int total = 0;
  block_sum(v, cnt, &sum, &total);
  float* out = a.partial + (static_cast<long long>(b) * a.chunks + chunk) * kWords;
  if (threadIdx.x < kSums) out[threadIdx.x] = sum;
  if (threadIdx.x < 3) out[kSums + threadIdx.x] = __int_as_float(total);
}

template <int T>
__global__ void __launch_bounds__(kThreads) neq_finish_kernel(const __grid_constant__ Args a) {
  __shared__ float fs[kWarps][kWords];
  __shared__ int is[kWarps][kWords];
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* part = a.partial + static_cast<long long>(b) * a.chunks * kWords;
  float s = 0.0f;
  int c = 0;
  for (int chunk = warp; chunk < a.chunks; chunk += kWarps) {
    const float x = part[chunk * kWords + lane];  // one 128-byte partial a load
    if (lane < kSums) {
      s += x;
    } else {
      c += __float_as_int(x);
    }
  }
  fs[warp][lane] = s;
  is[warp][lane] = c;
  __syncthreads();
  const int k = threadIdx.x;
  if (k >= kWords) return;
  float sum = fs[0][k];
  int total = is[0][k];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) {
    sum += fs[i][k];
    total += is[i][k];
  }
  if (k < 21) {  // upper-triangle word k -> (row, col), and its mirror
    int row = 0, first = 0;
    while (k >= first + 6 - row) first += 6 - row++;
    const int col = row + k - first;
    a.hess[b * 36 + row * 6 + col] = sum;
    a.hess[b * 36 + col * 6 + row] = sum;
  } else if (k < 27) {
    a.grad[b * 6 + k - 21] = sum;
  } else if (k < 27 + T) {
    a.sq[(k - 27) * a.batch + b] = sum;
  } else if (k >= kSums) {  // counts: the terms' masks, then (count 2) the visible pixels
    const int j = k - kSums;
    if (j < T) a.count[j * a.batch + b] = total;
    if (j == 2) a.count[T * a.batch + b] = total;
  }
}

template <int T>
int launch(const Args& a, cudaStream_t stream) {
  neq_partial_kernel<T><<<dim3(a.chunks, a.batch), kThreads, 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  neq_finish_kernel<T><<<a.batch, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches both passes on `stream` over `batch` elements of `n` pixels with
// `n_terms` (1 or 2) residual terms; the second term's pointers are not read
// when n_terms is 1.  Every input is contiguous: tp and a (batch, n, 3) f32,
// w and r (batch, n) f32, the masks (batch, n) bool.  `partial` holds
// batch * chunks * 32 floats, chunks = max(1, ceil(n / 2048)); the outputs
// are hess (batch, 6, 6), grad (batch, 6), sq (n_terms, batch) f32 and count
// (n_terms + 1, batch) int64.  1 <= batch <= 65535.  Returns the first
// cudaGetLastError() that is not cudaSuccess, or cudaSuccess.
int rgbd360_normal_equations(const float* tp, const unsigned char* visible, int n_terms,
                             const float* a0, const float* w0, const unsigned char* m0,
                             const float* r0, const float* a1, const float* w1,
                             const unsigned char* m1, const float* r1, int batch, int n,
                             int chunks, float* partial, float* hess, float* grad, float* sq,
                             long long* count, cudaStream_t stream) {
  if (n_terms < 1 || n_terms > kMaxTerms || batch < 1 || batch > 65535 || n < 0 ||
      chunks != (n + kChunk - 1) / kChunk + (n == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{tp, visible, {{a0, w0, m0, r0}, {a1, w1, m1, r1}}, batch, n, chunks,
         partial, hess, grad, sq, count};
  return n_terms == 1 ? launch<1>(a, stream) : launch<2>(a, stream);
}

}  // extern "C"
