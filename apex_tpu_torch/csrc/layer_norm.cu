// Row LayerNorm / RMSNorm forward for Hopper (sm_90a).
//
// Replaces: apex_tpu/kernels/layer_norm.py, _ln_fwd_kernel (the Pallas body)
// launched by _ln_fwd_pallas's pl.pallas_call. Same function: per row of
// x [N, H], fp32 statistics whatever the I/O dtype, y = (x - mean) * rstd
// (* gamma) (+ beta) written in the I/O dtype, and mean / rstd [N] fp32
// (mean is 0 for RMSNorm, as in the Pallas kernel).
//
// What bounds it on the card: bytes. Each element is read once and written
// once for about ten floating-point operations, far below the H100's
// ~295 operations per byte of device memory. At the serving path's shapes
// (N = slots = 8 rows in decode, N = chunk_len = 256 rows in chunk prefill,
// H = 768) the whole input is 12 KB - 400 KB, so launch latency dominates
// the decode rows.
//
// What the design does about it: one warp per row, four rows per block.
// The row is read from device memory once into registers (at most
// MAX_PER_LANE values per lane), both reductions (mean, then the centred
// variance: the two-pass form, which is exact where a one-pass sum of
// squares cancels) run on registers with warp shuffles, and y is written
// once. No shared memory and no block-wide barrier.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 4;
constexpr int kMaxPerLane = 32;          // H <= 32 * 32 = 1024 per row

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void ln_fwd_kernel(const T* __restrict__ x,
                              const T* __restrict__ gamma,
                              const T* __restrict__ beta,
                              T* __restrict__ y, float* __restrict__ mean_out,
                              float* __restrict__ rstd_out, int n, int h,
                              float eps, int rms) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= n) return;                  // whole warp leaves together
  const T* xr = x + static_cast<size_t>(row) * h;
  float v[kMaxPerLane];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + i * kWarp;
    v[i] = c < h ? to_f(xr[c]) : 0.f;
    s += v[i];
  }
  const float inv_h = 1.f / static_cast<float>(h);
  const float mean = rms ? 0.f : warp_sum(s) * inv_h;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + i * kWarp;
    const float d = c < h ? v[i] - mean : 0.f;
    q += d * d;
  }
  const float rstd = 1.f / sqrtf(warp_sum(q) * inv_h + eps);
  T* yr = y + static_cast<size_t>(row) * h;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + i * kWarp;
    if (c < h) {
      float o = (v[i] - mean) * rstd;
      if (gamma != nullptr) o *= to_f(gamma[c]);
      if (beta != nullptr && !rms) o += to_f(beta[c]);
      yr[c] = from_f<T>(o);
    }
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* y,
           float* mean, float* rstd, int n, int h, float eps, int rms,
           cudaStream_t stream) {
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  ln_fwd_kernel<T><<<blocks, kRowsPerBlock * kWarp, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<T*>(y), mean, rstd, n, h, eps,
      rms);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. gamma / beta may be null (no affine;
// beta is ignored when rms != 0). Returns cudaGetLastError() after launch,
// or -1 for a shape the kernel does not take.
extern "C" int apex_ln_fwd(const void* x, const void* gamma, const void* beta,
                           void* y, float* mean, float* rstd, int n, int h,
                           float eps, int rms, int dtype,
                           cudaStream_t stream) {
  if (n < 1 || h < 1 || h > kWarp * kMaxPerLane) return -1;
  if (dtype == 0)
    return launch<float>(x, gamma, beta, y, mean, rstd, n, h, eps, rms,
                         stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, n, h, eps,
                                 rms, stream);
  return -1;
}
