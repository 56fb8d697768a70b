// Local-Radon (LRadon) keypoint descriptors for Hopper.
//
// Replaces feabas_tpu/ops/lradon.py:_patch_body, which XLA ran as a patch
// gather, a (K, Dp^2) x (Dp^2, 4 P B) matrix product at Precision.HIGHEST
// and a normalisation, each through device memory. Per keypoint k:
//     patch   = the (Dp, Dp) window of the edge-padded image at z_k
//     M[c, q] = sum_p patch[p] * W[c, q, p]        (4 corners x P*B bins)
//     des[q]  = sum_c wc_k[c] * M[c, q]            (corner blend by f_k)
//     out     = (des - mean(des)) / max(|des - mean(des)|, 1e-6)
// in f32 throughout (FMA, no TF32). The edge pad is not materialised: a
// read at padded coordinate (y, x) is a read of the image at
// (clamp(y - pad), clamp(x - pad)).
//
// What bounds it on an H100: memory traffic, 20 MB at K = 5000 keypoints
// (6 us). The table is mostly zeros: the beams touch about 5% of its
// 4 * 48 * 2401 taps (at most 372 of 2401 in a row), so the function needs
// about 2 * 5000 * 23.4 k = 0.23 GFLOP (3.5 us at 67 TFLOP/s). This kernel
// does not exploit that and runs the dense product,
// 2 * 5000 * 192 * 2401 = 4.6 GFLOP. The design is the simple one that is
// right:
//   * a block takes kGroup keypoints; their patches go to shared memory
//     once, interleaved [p][g], so one 16-byte read serves 4 keypoints;
//   * thread t owns output (c, q) = t of all kGroup keypoints: it streams
//     column t of the transposed table Wt (Dp^2, 4 P B) through L2 (a
//     warp's reads of one p are consecutive addresses) and every table
//     value read feeds kGroup FMAs, summed over p in ascending order;
//   * the blend, mean and norm are done in shared memory and only the
//     (P*B) descriptor leaves the chip.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// given stream, allocates nothing, and returns a cudaError_t (0 = launched).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxSmem = 232448;    // 227 KB, the most a block may use

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// shared memory of one block, in floats
__host__ __device__ inline size_t smem_floats(int G, int dp2, int nt, int pb) {
  return (size_t)G * dp2 + (size_t)G * nt + (size_t)G * pb + 2 * G;
}

template <int G>
__global__ void patch_kernel(const float* __restrict__ img, int h, int w,
                             const int* __restrict__ z,
                             const float* __restrict__ frac,
                             const float* __restrict__ wt,
                             float* __restrict__ out, int K, int Dp, int PB,
                             int pad) {
  extern __shared__ __align__(16) float smem[];
  const int nt = 4 * PB;                 // threads: one per (corner, bin)
  const int dp2 = Dp * Dp;
  float* patches = smem;                 // [dp2][G]
  float* Ms = patches + (size_t)G * dp2; // [G][nt]
  float* des = Ms + (size_t)G * nt;      // [G][PB]
  float* stats = des + (size_t)G * PB;   // [2][G]: mean, clipped norm
  const int t = threadIdx.x;
  const int k0 = blockIdx.x * G;

  for (int i = t; i < G * dp2; i += nt) {
    const int g = i % G, p = i / G;
    const int k = k0 + g;
    float v = 0.0f;
    if (k < K) {
      const int dy = p / Dp, dx = p - dy * Dp;
      const int x = clampi(z[2 * k] + dx - pad, 0, w - 1);
      const int y = clampi(z[2 * k + 1] + dy - pad, 0, h - 1);
      v = img[(size_t)y * w + x];
    }
    patches[i] = v;
  }
  __syncthreads();

  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.0f;
  const float* wcol = wt + t;
#pragma unroll 4
  for (int p = 0; p < dp2; ++p) {
    const float wv = __ldg(wcol + (size_t)p * nt);
    const float* pv = patches + (size_t)p * G;
    if constexpr (G % 4 == 0) {
#pragma unroll
      for (int g = 0; g < G; g += 4) {
        const float4 v = *reinterpret_cast<const float4*>(pv + g);
        acc[g] = fmaf(v.x, wv, acc[g]);
        acc[g + 1] = fmaf(v.y, wv, acc[g + 1]);
        acc[g + 2] = fmaf(v.z, wv, acc[g + 2]);
        acc[g + 3] = fmaf(v.w, wv, acc[g + 3]);
      }
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = fmaf(pv[g], wv, acc[g]);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) Ms[g * nt + t] = acc[g];
  __syncthreads();

  // corner blend: corners are (cy, cx) = (0,0), (0,1), (1,0), (1,1)
  for (int i = t; i < G * PB; i += nt) {
    const int g = i / PB, q = i - g * PB;
    const int k = k0 + g;
    float d = 0.0f;
    if (k < K) {
      const float fx = frac[2 * k], fy = frac[2 * k + 1];
      const float* m = Ms + g * nt + q;
      d = (1.0f - fx) * (1.0f - fy) * m[0];
      d = fmaf(fx * (1.0f - fy), m[PB], d);
      d = fmaf((1.0f - fx) * fy, m[2 * PB], d);
      d = fmaf(fx * fy, m[3 * PB], d);
    }
    des[i] = d;
  }
  __syncthreads();
  if (t < G) {
    float s = 0.0f;
    for (int q = 0; q < PB; ++q) s += des[t * PB + q];
    const float mean = s / (float)PB;
    float ss = 0.0f;
    for (int q = 0; q < PB; ++q) {
      const float d = des[t * PB + q] - mean;
      ss = fmaf(d, d, ss);
    }
    stats[t] = mean;
    stats[G + t] = fmaxf(sqrtf(ss), 1e-6f);
  }
  __syncthreads();
  for (int i = t; i < G * PB; i += nt) {
    const int g = i / PB;
    const int k = k0 + g;
    if (k < K)
      out[(size_t)k * PB + (i - g * PB)] = (des[i] - stats[g]) / stats[G + g];
  }
}

template <int G>
int launch(const float* img, int h, int w, const int* z, const float* frac,
           const float* wt, float* out, int K, int Dp, int PB, int pad,
           cudaStream_t stream) {
  const size_t bytes = smem_floats(G, Dp * Dp, 4 * PB, PB) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      patch_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  patch_kernel<G><<<(K + G - 1) / G, 4 * PB, bytes, stream>>>(
      img, h, w, z, frac, wt, out, K, Dp, PB, pad);
  return (int)cudaGetLastError();
}

}  // namespace

// img: (h, w) f32, unpadded. z: (K, 2) int32 patch origins (x, y) in the
// frame padded by `pad`. frac: (K, 2) f32 fractional offsets (fx, fy).
// wt: (Dp * Dp, 4 * PB) f32, the stencil table transposed. out: (K, PB) f32.
extern "C" int lradon_patch_f32(const float* img, int h, int w, const int* z,
                                const float* frac, const float* wt,
                                float* out, int K, int Dp, int PB, int pad,
                                cudaStream_t stream) {
  if (K < 1 || Dp < 1 || PB < 1 || 4 * PB > 1024 || h < 1 || w < 1)
    return (int)cudaErrorInvalidValue;
  const int dp2 = Dp * Dp, nt = 4 * PB;
  // the largest group whose patches fit one block, at two blocks per SM
  // where that is possible: 8 up to 59^2 patches, 4 up to 118^2, then 1
  if (smem_floats(8, dp2, nt, PB) * sizeof(float) <= kMaxSmem / 2)
    return launch<8>(img, h, w, z, frac, wt, out, K, Dp, PB, pad, stream);
  if (smem_floats(4, dp2, nt, PB) * sizeof(float) <= kMaxSmem)
    return launch<4>(img, h, w, z, frac, wt, out, K, Dp, PB, pad, stream);
  if (smem_floats(1, dp2, nt, PB) * sizeof(float) <= kMaxSmem)
    return launch<1>(img, h, w, z, frac, wt, out, K, Dp, PB, pad, stream);
  return (int)cudaErrorInvalidValue;
}
