// Local-Radon (LRadon) keypoint descriptors for Hopper.
//
// Replaces feabas_tpu/ops/lradon.py:_patch_body, which XLA ran as a patch
// gather, a (K, Dp^2) x (Dp^2, 4 P B) matrix product at Precision.HIGHEST
// against the dense stencil table W (4 corners x P*B bins x Dp^2 taps), a
// corner blend and a normalisation, each through device memory.
//
// The form computed here. Corner plane c = (cy, cx) of W is plane 0 shifted
// by (cx, cy) pixels (ops/lradon._stencil_table64 adds cx, cy to the tap
// positions; W0 is zero on the patch's last row and column), so for a
// keypoint with patch P (Dp x Dp window of the edge-padded image at z) and
// fractional offset (fx, fy):
//     des[q] = sum_c wc[c] sum_p W[c, q, p] P[p] = sum_p W0[q, p] bl[p]
//     bl[y, x] = (1-fx)(1-fy) P[y, x] + fx(1-fy) P[y, x+1]
//              + (1-fx) fy P[y+1, x] + fx fy P[y+1, x+1]
//     out = (des - mean(des)) / max(|des - mean(des)|, 1e-6)
// in f32 (FMA, no TF32). This sums in another order than the dense product
// of the plain version (ops/lradon.lradon_patch_plain), which the f64
// identity test in tests/test_torch_lradon.py pins; the results agree to
// ~1e-6 on unit descriptors. The edge pad is not materialised: padded
// coordinate (y, x) reads the image at (clamp(y - pad), clamp(x - pad)).
//
// What bounds it on an H100: memory traffic, 20 MB at K = 5000 keypoints
// on a 2048^2 image (6 us at 3.35 TB/s); the function needs about 0.23
// GFLOP (W0 is ~5% non-zero: 93-144 taps of 2401 per bin at radius 15).
// The design:
//   * the taps of W0, bin by bin in ascending p and padded to the longest
//     bin with (0, 0.0), sit in shared memory as an (S, PB) table of 16-bit
//     offsets and f32 weights (41 KB at radius 15, 120 KB at radius 45),
//     loaded once per persistent block;
//   * a warp owns a keypoint: it blends the patch once into its own
//     Dp x Dp buffer in shared memory (lane x walks column x down in
//     strips of 8 rows, the strip's reads of the L2-resident image all in
//     flight together), then lane q evaluates bins q, q + 32, ... over their
//     taps (consecutive lanes read consecutive table words; a last round
//     of at most 16 bins is split between the half-warps), and the mean
//     and norm are warp shuffles; only the descriptor leaves the chip;
//   * as many warps per block as their buffers leave room for (16 at
//     radius 15, 1 at radius 45), one block per SM, each looping over
//     keypoints; the shared-memory opt-in and the SM count are set up
//     once per device, not per launch.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// given stream, allocates nothing, and returns a cudaError_t (0 = launched).

#include <cuda_runtime.h>
#include <stddef.h>

#include <mutex>

namespace {

constexpr int kMaxSmem = 232448;    // 227 KB, the most a block may use
constexpr int kMaxWarps = 16;
constexpr int kMaxBinsPerLane = 8;  // PB <= 256
constexpr int kMaxDevices = 64;
constexpr int kStrip = 8;           // patch rows a lane blends per pass

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__host__ __device__ inline size_t round4(size_t n) {
  return (n + 3) & ~(size_t)3;
}

// f32 weights, then u16 offsets, each padded to 16 bytes
__host__ __device__ inline size_t taps_bytes(int S, int PB) {
  return round4((size_t)S * PB) * 4 + round4(((size_t)S * PB + 1) / 2) * 4;
}

// whether lane holds bin 32 j + lane of round j (a split last round of at
// most 16 bins: lanes below its size)
__device__ __forceinline__ bool on_bin(int PB, int j, int lane) {
  const int rest = PB - 32 * j;
  return rest > 16 ? lane < rest : lane < rest && lane < 16;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kMaxWarps * 32)
patch_kernel(const float* __restrict__ img, int h, int w,
             const int* __restrict__ z, const float* __restrict__ frac,
             const short* __restrict__ tap_off,
             const float* __restrict__ tap_w, int S,
             float* __restrict__ out, int K, int Dp, int PB, int pad) {
  extern __shared__ __align__(16) float smem[];
  const int n = S * PB;
  float* wts = smem;                                          // [S][PB]
  unsigned short* offs =
      reinterpret_cast<unsigned short*>(wts + round4((size_t)n));
  float* bufs = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem) + taps_bytes(S, PB));
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dp2 = Dp * Dp;
  // the table, 4 taps a read (a block of one warp still has many reads in
  // flight); the tail one by one
  const int n4 = n / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    reinterpret_cast<float4*>(wts)[i] =
        __ldg(reinterpret_cast<const float4*>(tap_w) + i);
    reinterpret_cast<uint2*>(offs)[i] =
        __ldg(reinterpret_cast<const uint2*>(tap_off) + i);
  }
  for (int i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x) {
    wts[i] = tap_w[i];
    offs[i] = static_cast<unsigned short>(tap_off[i]);
  }
  __syncthreads();
  float* bl = bufs + (size_t)warp * dp2;
  for (int k = blockIdx.x * nwarps + warp; k < K; k += gridDim.x * nwarps) {
    const int zx = z[2 * k] - pad, zy = z[2 * k + 1] - pad;
    const float fx = frac[2 * k], fy = frac[2 * k + 1];
    const float w00 = (1.0f - fx) * (1.0f - fy), w01 = fx * (1.0f - fy);
    const float w10 = (1.0f - fx) * fy, w11 = fx * fy;
    // lane x blends column x (and x + 32, ...) kStrip rows at a time: the
    // strip's 2 (kStrip + 1) reads of the L2-resident image are all in
    // flight before the first is used, and each pixel is read twice
    for (int dx = lane; dx < Dp; dx += 32) {
      const int x0 = clampi(zx + dx, 0, w - 1);
      const int x1 = clampi(zx + dx + 1, 0, w - 1);
      for (int dy0 = 0; dy0 < Dp; dy0 += kStrip) {
        float p0[kStrip + 1], p1[kStrip + 1];
#pragma unroll
        for (int r = 0; r <= kStrip; ++r) {
          const size_t row = (size_t)clampi(zy + dy0 + r, 0, h - 1) * w;
          p0[r] = __ldg(img + row + x0);
          p1[r] = __ldg(img + row + x1);
        }
#pragma unroll
        for (int r = 0; r < kStrip; ++r) {
          if (dy0 + r < Dp) {
            float v = w00 * p0[r];
            v = fmaf(w01, p1[r], v);
            v = fmaf(w10, p0[r + 1], v);
            v = fmaf(w11, p1[r + 1], v);
            bl[(dy0 + r) * Dp + dx] = v;
          }
        }
      }
    }
    __syncwarp();
    // lane q takes bins q, q + 32, ...; a last round of at most 16 bins
    // goes to both half-warps, each summing half of a bin's taps
    float d[kMaxBinsPerLane];
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxBinsPerLane; ++j) {
      const int rest = PB - 32 * j;
      float acc = 0.0f;
      if (rest > 16) {
        const int q = 32 * j + lane;
        if (q < PB) {
#pragma unroll 8
          for (int s = 0; s < S; ++s)
            acc = fmaf(wts[s * PB + q], bl[offs[s * PB + q]], acc);
          sum += acc;
        }
      } else if (rest > 0) {
        const int q = 32 * j + (lane & 15);
        const int half = (S + 1) / 2;
        const int s1 = lane < 16 ? half : S;
        if ((lane & 15) < rest) {
#pragma unroll 8
          for (int s = lane < 16 ? 0 : half; s < s1; ++s)
            acc = fmaf(wts[s * PB + q], bl[offs[s * PB + q]], acc);
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 16);
        if (lane < rest) sum += acc;
      }
      d[j] = acc;
    }
    const float mean = warp_sum(sum) / (float)PB;
    float ss = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxBinsPerLane; ++j) {
      const float c = d[j] - mean;
      if (on_bin(PB, j, lane)) ss = fmaf(c, c, ss);
    }
    const float nrm = fmaxf(sqrtf(warp_sum(ss)), 1e-6f);
#pragma unroll
    for (int j = 0; j < kMaxBinsPerLane; ++j) {
      if (on_bin(PB, j, lane))
        out[(size_t)k * PB + 32 * j + lane] = (d[j] - mean) / nrm;
    }
    __syncwarp();      // the next keypoint overwrites this warp's buffer
  }
}

// The shared-memory opt-in and the SM count of each device, set up at the
// first launch on it (under a lock: callers may launch from several host
// threads).
int device_sms(int* sms) {
  static std::mutex lock;
  static int sm_of[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> guard(lock);
  if (sm_of[dev] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          patch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    sm_of[dev] = n;
  }
  *sms = sm_of[dev];
  return 0;
}

}  // namespace

// img: (h, w) f32, unpadded. z: (K, 2) int32 patch origins (x, y) in the
// frame padded by `pad`. frac: (K, 2) f32 fractional offsets (fx, fy).
// tap_off, tap_w: (S, PB) int16 / f32, the non-zero taps of the corner-(0,
// 0) stencil plane, column q for bin q (ops/lradon._stencil_taps). out:
// (K, PB) f32.
extern "C" int lradon_patch_f32(const float* img, int h, int w, const int* z,
                                const float* frac, const short* tap_off,
                                const float* tap_w, int S, float* out, int K,
                                int Dp, int PB, int pad, cudaStream_t stream) {
  if (K < 1 || Dp < 2 || S < 1 || PB < 1
      || PB > 32 * kMaxBinsPerLane || h < 1 || w < 1 || Dp * Dp > 65536)
    return (int)cudaErrorInvalidValue;
  const size_t fixed = taps_bytes(S, PB);
  const size_t per_warp = (size_t)Dp * Dp * sizeof(float);
  if (fixed + per_warp > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const size_t room = (kMaxSmem - fixed) / per_warp;
  const int warps = room < (size_t)kMaxWarps ? (int)room : kMaxWarps;
  int sms = 0;
  const int err = device_sms(&sms);
  if (err != 0) return err;
  const int blocks = min((K + warps - 1) / warps, sms);
  patch_kernel<<<blocks, warps * 32, fixed + warps * per_warp, stream>>>(
      img, h, w, z, frac, tap_off, tap_w, S, out, K, Dp, PB, pad);
  return (int)cudaGetLastError();
}
