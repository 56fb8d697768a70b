// Subpixel refinement of matched keypoint pairs, for Hopper.
//
// Replaces no TPU kernel: the JAX package fits these shifts on the host
// (feabas_tpu/thumbnail.py:464 refine_matches_subpixel, after two scipy DoGs:
// a per-match cut of a (P + 2s)^2 window of DoG0 and a P^2 window of DoG1, a
// scipy FFT correlation over the (2s + 1)^2 valid lags and 8 numpy
// Lucas-Kanade steps). The port ran that host code until this kernel; on a
// 4096^2 thumbnail pair (~1,300 matches) it took ~6.4 s of a ~7.6 s pair.
// This kernel takes the per-match stage, on the band-passed images that the
// DoG kernel (dog_filter.cu) makes on the card. One block a match:
//     p0 = DoG0 window of N = P + 2s around c0, minus its mean
//     p1 = DoG1 window of P around c1, minus its mean
//     C[ly, lx] = sum_{u, v < P} p0[ly + u, lx + v] * p1[u, v], lags 0..2s
//     (py, px) = the first maximum of C in row-major order
//     good = 0 < px, py < 2s and C[py, px] > 0.1 * |p0| * |p1| * P / N
//     then 8 Gauss-Newton steps of (sx, sy) in [-1, 1]^2: W = p0 sampled
//     bilinearly at (py + sy + y, px + sx + x), y, x < P; r = p1 - W;
//     symmetric gradients g = (p1 + W) central differences / 4 over the
//     (P - 2)^2 interior; A = sum g g^T, b = sum g r; the step A^-1 b where
//     det A > 1e-12, else none; clip to [-1, 1]
//     out = (px + sx - s, py + sy - s, good)
// That is ops/subpixel.subpixel_refine_plain's arithmetic (the host route's,
// term for term); sums run in another order (f32 tree sums here), so the
// shifts agree to rounding, not to the bit.
//
// What bounds it on an H100: per match, 4 (N^2 + P^2) bytes of window reads
// (11.8 kB at P = 32, s = 6) against 2 (2s + 1)^2 P^2 = 346 kFLOP of
// correlation and, where the peak is good, 8 (11 P^2 + 14 (P - 2)^2) = 191
// kFLOP of fitting: operations, 30-46 FLOP a byte against the card's 20.
// The windows stay in shared memory from the first read to the last.
//
// Design: a block of 256 threads a match (~1,300 blocks a pair, about ten
// waves of one block a SM at 20.7 kB of shared memory). The windows load
// once; means and energies are block sums; each correlation lag is one
// thread's 1,024 FMAs straight from shared memory (the 169 lags of s = 6 in
// one pass); warp 0 takes the first maximum; the fit keeps its shift in
// double (uniform across the block: every thread adds the same warp sums in
// the same order) and stages p1 +- W in shared memory for the gradients.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// given stream, allocates nothing, and returns a cudaError_t (0 = launched).
// The caller keeps every window inside its image.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIters = 8;
// dynamic shared memory a block may take without an opt-in: 48 kB
constexpr int kMaxFloats = 12288;

// v[i] summed over the block, the result in every thread. Every thread adds
// the warps' partials in the same order, so the sums are uniform.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) scratch[warp * NV + i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += scratch[w * NV + i];
    v[i] = t;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
subpixel_kernel(const float* __restrict__ dog0, int w0,
                const float* __restrict__ dog1, int w1,
                const int4* __restrict__ centres, int P, int s,
                float* __restrict__ out) {
  extern __shared__ float sm[];
  __shared__ float scratch[kWarps * 5];
  __shared__ float peak_val;
  __shared__ int peak_arg;
  const int N = P + 2 * s, L = 2 * s + 1, tid = threadIdx.x;
  float* p0 = sm;              // N x N
  float* p1 = p0 + N * N;      // P x P
  float* sw = p1 + P * P;      // P x P: p1 + W
  float* dw = sw + P * P;      // P x P: p1 - W
  float* cc = dw + P * P;      // L x L correlation
  const int k = blockIdx.x;
  const int4 c = centres[k];
  const int x0 = c.x - P / 2 - s, y0 = c.y - P / 2 - s;
  const int x1 = c.z - P / 2, y1 = c.w - P / 2;

  float m[2] = {0.f, 0.f};
  for (int i = tid; i < N * N; i += kThreads) {
    const float a = dog0[(size_t)(y0 + i / N) * w0 + x0 + i % N];
    p0[i] = a;
    m[0] += a;
  }
  for (int i = tid; i < P * P; i += kThreads) {
    const float b = dog1[(size_t)(y1 + i / P) * w1 + x1 + i % P];
    p1[i] = b;
    m[1] += b;
  }
  block_sum<2>(m, scratch);
  const float m0 = m[0] / (float)(N * N), m1 = m[1] / (float)(P * P);
  // each thread centres the values it loaded
  float e[2] = {0.f, 0.f};
  for (int i = tid; i < N * N; i += kThreads) {
    const float a = p0[i] - m0;
    p0[i] = a;
    e[0] += a * a;
  }
  for (int i = tid; i < P * P; i += kThreads) {
    const float b = p1[i] - m1;
    p1[i] = b;
    e[1] += b * b;
  }
  block_sum<2>(e, scratch);
  const float e0 = sqrtf(e[0]), e1 = sqrtf(e[1]);

  for (int l = tid; l < L * L; l += kThreads) {
    const float* a = p0 + (l / L) * N + l % L;
    float acc = 0.f;
    for (int u = 0; u < P; ++u) {
      const float* au = a + u * N;
      const float* bu = p1 + u * P;
#pragma unroll 8
      for (int v = 0; v < P; ++v) acc = fmaf(au[v], bu[v], acc);
    }
    cc[l] = acc;
  }
  __syncthreads();
  if (tid < 32) {
    // each lane's first maximum over its lags, in increasing order, then
    // the larger value or, on a tie, the lower lag: the first maximum
    float best = -INFINITY;
    int arg = L * L;
    for (int l = tid; l < L * L; l += 32) {
      if (cc[l] > best) {
        best = cc[l];
        arg = l;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oa = __shfl_xor_sync(0xffffffffu, arg, o);
      if (ob > best || (ob == best && oa < arg)) {
        best = ob;
        arg = oa;
      }
    }
    if (tid == 0) {
      peak_val = best;
      peak_arg = arg;
    }
  }
  __syncthreads();
  const int py = peak_arg / L, px = peak_arg % L;
  const bool interior = px > 0 && px < 2 * s && py > 0 && py < 2 * s;
  const float ratio = (float)((double)P / (double)N);
  const bool strong = peak_val > 0.1f * e0 * e1 * ratio;
  if (!(interior && strong)) {
    if (tid == 0) {
      out[3 * k] = 0.f;
      out[3 * k + 1] = 0.f;
      out[3 * k + 2] = 0.f;
    }
    return;
  }

  // the padded window's origin: one px before the peak's window
  const float* base = p0 + (py - 1) * N + (px - 1);
  const int Q = P - 2;
  double sx = 0.0, sy = 0.0;
  for (int it = 0; it < kIters; ++it) {
    const double ox = 1.0 + sx, oy = 1.0 + sy;
    const int ix = min(max((int)floor(ox), 0), 1);
    const int iy = min(max((int)floor(oy), 0), 1);
    const double fx = ox - ix, fy = oy - iy;
    const float wx0 = (float)(1.0 - fx), wx1 = (float)fx;
    const float wy0 = (float)(1.0 - fy), wy1 = (float)fy;
    for (int i = tid; i < P * P; i += kThreads) {
      const float* q = base + (i / P + iy) * N + i % P + ix;
      const float W = wy0 * (wx0 * q[0] + wx1 * q[1])
                      + wy1 * (wx0 * q[N] + wx1 * q[N + 1]);
      const float t = p1[i];
      sw[i] = t + W;
      dw[i] = t - W;
    }
    __syncthreads();
    float a[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = tid; i < Q * Q; i += kThreads) {
      const int j = (1 + i / Q) * P + 1 + i % Q;
      const float gx = (sw[j + 1] - sw[j - 1]) * 0.25f;
      const float gy = (sw[j + P] - sw[j - P]) * 0.25f;
      const float r = dw[j];
      a[0] += gx * gx;
      a[1] += gx * gy;
      a[2] += gy * gy;
      a[3] += gx * r;
      a[4] += gy * r;
    }
    // its syncs also keep the next step's writes after these reads
    block_sum<5>(a, scratch);
    const float det = a[0] * a[2] - a[1] * a[1];
    float dxk = 0.f, dyk = 0.f;
    if (det > 1e-12f) {
      dxk = (a[2] * a[3] - a[1] * a[4]) / det;
      dyk = (a[0] * a[4] - a[1] * a[3]) / det;
    }
    sx = fmin(fmax(sx + (double)dxk, -1.0), 1.0);
    sy = fmin(fmax(sy + (double)dyk, -1.0), 1.0);
  }
  if (tid == 0) {
    out[3 * k] = (float)(px + sx - s);
    out[3 * k + 1] = (float)(py + sy - s);
    out[3 * k + 2] = 1.f;
  }
}

}  // namespace

extern "C" int subpixel_refine_max_floats() { return kMaxFloats; }

// dog0: (h0, w0) f32, dog1: (h1, w1) f32; centres: (k, 4) int32 rows of
// (x0, y0, x1, y1) window centres, 16-byte aligned; out: (k, 3) f32 rows of
// (dx, dy, good).
extern "C" int subpixel_refine_f32(const float* dog0, int w0,
                                   const float* dog1, int w1,
                                   const int* centres, float* out, int k,
                                   int patch, int search,
                                   cudaStream_t stream) {
  if (patch < 3 || search < 1 || k < 0) return (int)cudaErrorInvalidValue;
  const long n = patch + 2L * search, l = 2L * search + 1;
  const long floats = n * n + 3L * patch * patch + l * l;
  if (floats > kMaxFloats) return (int)cudaErrorInvalidValue;
  if (k == 0) return (int)cudaSuccess;
  subpixel_kernel<<<k, kThreads, floats * sizeof(float), stream>>>(
      dog0, w0, dog1, w1, reinterpret_cast<const int4*>(centres), patch,
      search, out);
  return (int)cudaGetLastError();
}
