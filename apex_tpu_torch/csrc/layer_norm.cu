// Row LayerNorm / RMSNorm forward and backward for Hopper (sm_90a).
//
// Replaces two Pallas kernels of apex_tpu/kernels/layer_norm.py:
//   - _ln_fwd_kernel, launched by _ln_fwd_pallas: per row of x [N, H], fp32
//     statistics whatever the I/O dtype, y = (x - mean) * rstd (* gamma)
//     (+ beta) written in x's dtype, and mean / rstd [N] fp32 (mean is 0 for
//     RMSNorm, as in the Pallas kernel);
//   - _ln_bwd_kernel, launched by _ln_bwd_pallas: dx in x's dtype, and the
//     column sums dgamma = sum_rows dy * xhat, dbeta = sum_rows dy, cast to
//     gamma's dtype once at the end. xhat comes from the saved input,
//     (x - mean) * rstd, or, under memory_efficient, from the saved OUTPUT,
//     (y - beta) / gamma (y / gamma for RMSNorm, y without affine params).
//     dx follows _bwd_from_xhat: rstd * (dyg - mean(dyg) - xhat *
//     mean(dyg * xhat)), with dyg = dy * gamma and no mean(dyg) term for
//     RMSNorm.
// x / y / dy / dx share one type T and gamma / beta / dgamma / dbeta one
// type G: (fp32, fp32) and (bf16, bf16) for the serve path, (bf16, fp32)
// for amp O2, which keeps LayerNorm parameters in fp32 with bf16
// activations.
//
// What bounds them on the card: bytes. Each element is read once and
// written once (twice read in the backward: dy and x) for about ten to
// twenty floating-point operations, far below the H100's ~295 operations
// per byte of device memory. At the training shape (N = 8192 rows, H = 768)
// the forward moves ~25 MB in bf16 and the backward ~38 MB.
//
// What the design does about it: one warp per row, four rows per block.
// The row is read from device memory once into registers (at most
// kMaxPerLane values per lane), the reductions (mean, then the centred
// variance: the two-pass form, exact where a one-pass sum of squares
// cancels; in the backward mean(dyg) and mean(dyg * xhat)) run on
// registers with warp shuffles, and each output is written once.
//
// The TPU backward accumulates dgamma / dbeta in one output block across
// its SEQUENTIAL row grid. GPU blocks run in no order, so the backward
// reduces in two deterministic stages and no atomics: a fixed number of
// blocks (a function of N alone) each walk a fixed set of rows, sum their
// dy * xhat and dy per column in fp32 in shared memory (one row per warp),
// combine their four warps in warp order and write one row of a [blocks, H]
// fp32 scratch; then a column kernel sums the scratch rows in block order and
// casts to G. Two runs on the same inputs give bitwise-equal gradients.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 4;         // one warp per row
constexpr int kMaxPerLane = 32;          // H <= 32 * 32 = 1024 per row
constexpr int kMaxH = kWarp * kMaxPerLane;
constexpr int kBwdMaxBlocks = 528;       // 4 blocks per SM on 132 SMs

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

// Stage-1 blocks of the backward for n rows: a function of n alone, so the
// reduction order (and so every bit of dgamma / dbeta) is fixed by shape.
int bwd_blocks(int n) {
  const int want = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  return want < kBwdMaxBlocks ? want : kBwdMaxBlocks;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ----------------------------------------------------------------- forward
template <typename T, typename G>
__global__ void ln_fwd_kernel(const T* __restrict__ x,
                              const G* __restrict__ gamma,
                              const G* __restrict__ beta,
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

// ---------------------------------------------------------------- backward
// Stage 1. grid: blocks (bwd_blocks(n)), block kRowsPerBlock warps. Warp w
// of block b takes rows b * 4 + w, then every gridDim.x * 4 rows after. src
// is x (mem_eff == 0, with mean / rstd) or y (mem_eff != 0, with beta /
// rstd). part_g / part_b: [gridDim.x, h] fp32 per-block column sums (null
// without affine params; part_b null for RMSNorm). Each lane owns the same
// columns in every row, so a warp's running column sums live in its own
// row of shared memory with no race, and gamma / beta are staged there
// once per block; registers hold only the current row (dy and xhat).
template <typename T, typename G>
__global__ void ln_bwd_kernel(const T* __restrict__ dy,
                              const T* __restrict__ src,
                              const G* __restrict__ gamma,
                              const G* __restrict__ beta,
                              const float* __restrict__ mean,
                              const float* __restrict__ rstd,
                              T* __restrict__ dx,
                              float* __restrict__ part_g,
                              float* __restrict__ part_b, int n, int h,
                              int rms, int mem_eff) {
  __shared__ float acc_g[kRowsPerBlock][kMaxH];
  __shared__ float acc_b[kRowsPerBlock][kMaxH];
  __shared__ float gs[kMaxH];
  __shared__ float bs[kMaxH];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const bool affine = gamma != nullptr;
  const float inv_h = 1.f / static_cast<float>(h);
  for (int c = threadIdx.x; c < h; c += blockDim.x) {
    gs[c] = affine ? to_f(gamma[c]) : 1.f;
    bs[c] = (affine && !rms && beta != nullptr) ? to_f(beta[c]) : 0.f;
#pragma unroll
    for (int w = 0; w < kRowsPerBlock; ++w) {
      acc_g[w][c] = 0.f;
      acc_b[w][c] = 0.f;
    }
  }
  __syncthreads();
  for (int row = blockIdx.x * kRowsPerBlock + warp; row < n;
       row += gridDim.x * kRowsPerBlock) {
    const size_t off = static_cast<size_t>(row) * h;
    const float r = rstd[row];
    const float mu = mem_eff ? 0.f : mean[row];
    float d[kMaxPerLane], xh[kMaxPerLane];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int c = lane + i * kWarp;
      d[i] = 0.f;
      xh[i] = 0.f;
      if (c < h) {
        d[i] = to_f(dy[off + c]);
        const float sv = to_f(src[off + c]);
        if (mem_eff)
          xh[i] = affine ? (sv - bs[c]) / gs[c] : sv;
        else
          xh[i] = (sv - mu) * r;
        const float dyg = d[i] * gs[c];
        s1 += dyg;
        s2 += dyg * xh[i];
      }
    }
    const float c1 = rms ? 0.f : warp_sum(s1) * inv_h;
    const float c2 = warp_sum(s2) * inv_h;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int c = lane + i * kWarp;
      if (c < h) {
        const float dyg = d[i] * gs[c];
        dx[off + c] = from_f<T>(r * (dyg - c1 - xh[i] * c2));
        acc_g[warp][c] += d[i] * xh[i];
        acc_b[warp][c] += d[i];
      }
    }
  }
  if (!affine) return;                   // uniform over the block
  __syncthreads();
  for (int c = threadIdx.x; c < h; c += blockDim.x) {
    float sg = 0.f, sb = 0.f;
#pragma unroll
    for (int w = 0; w < kRowsPerBlock; ++w) {
      sg += acc_g[w][c];
      sb += acc_b[w][c];
    }
    part_g[static_cast<size_t>(blockIdx.x) * h + c] = sg;
    if (part_b != nullptr)
      part_b[static_cast<size_t>(blockIdx.x) * h + c] = sb;
  }
}

// Stage 2. One thread per column sums the [blocks, h] partials in block
// order and writes G. grid: ceil(h / 256), block 256.
template <typename G>
__global__ void ln_bwd_colsum_kernel(const float* __restrict__ part_g,
                                     const float* __restrict__ part_b,
                                     G* __restrict__ dgamma,
                                     G* __restrict__ dbeta, int blocks,
                                     int h) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= h) return;
  float sg = 0.f, sb = 0.f;
  for (int b = 0; b < blocks; ++b) {
    sg += part_g[static_cast<size_t>(b) * h + c];
    if (part_b != nullptr) sb += part_b[static_cast<size_t>(b) * h + c];
  }
  dgamma[c] = from_f<G>(sg);
  if (dbeta != nullptr) dbeta[c] = from_f<G>(sb);
}

template <typename T, typename G>
int launch_fwd(const void* x, const void* gamma, const void* beta, void* y,
               float* mean, float* rstd, int n, int h, float eps, int rms,
               cudaStream_t stream) {
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  ln_fwd_kernel<T, G><<<blocks, kRowsPerBlock * kWarp, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const G*>(gamma),
      static_cast<const G*>(beta), static_cast<T*>(y), mean, rstd, n, h, eps,
      rms);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename G>
int launch_bwd(const void* dy, const void* src, const void* gamma,
               const void* beta, const float* mean, const float* rstd,
               void* dx, void* dgamma, void* dbeta, float* part, int n,
               int h, int rms, int mem_eff, cudaStream_t stream) {
  const int blocks = bwd_blocks(n);
  float* part_g = gamma != nullptr ? part : nullptr;
  float* part_b = (gamma != nullptr && !rms)
                      ? part + static_cast<size_t>(blocks) * h
                      : nullptr;
  ln_bwd_kernel<T, G><<<blocks, kRowsPerBlock * kWarp, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(src),
      static_cast<const G*>(gamma), static_cast<const G*>(beta), mean, rstd,
      static_cast<T*>(dx), part_g, part_b, n, h, rms, mem_eff);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || gamma == nullptr) return static_cast<int>(err);
  ln_bwd_colsum_kernel<G><<<(h + 255) / 256, 256, 0, stream>>>(
      part_g, part_b, static_cast<G*>(dgamma),
      rms ? nullptr : static_cast<G*>(dbeta), blocks, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Number of stage-1 blocks of the backward for n rows: the [blocks, h] fp32
// scratch the caller allocates holds two such planes (dgamma, dbeta).
extern "C" int apex_ln_bwd_blocks(int n) { return bwd_blocks(n); }

// dtype: 0 = float32, 1 = bfloat16 for x / y (T); pdtype the same codes for
// gamma / beta (G). Taken pairs: (0, 0), (1, 1), (1, 0). gamma / beta may be
// null (no affine; beta is ignored when rms != 0). Returns
// cudaGetLastError() after launch, or -1 for a shape or type pair the kernel
// does not take.
extern "C" int apex_ln_fwd(const void* x, const void* gamma, const void* beta,
                           void* y, float* mean, float* rstd, int n, int h,
                           float eps, int rms, int dtype, int pdtype,
                           cudaStream_t stream) {
  if (n < 1 || h < 1 || h > kMaxH) return -1;
  if (dtype == 0 && pdtype == 0)
    return launch_fwd<float, float>(x, gamma, beta, y, mean, rstd, n, h, eps,
                                    rms, stream);
  if (dtype == 1 && pdtype == 1)
    return launch_fwd<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, y, mean,
                                                    rstd, n, h, eps, rms,
                                                    stream);
  if (dtype == 1 && pdtype == 0)
    return launch_fwd<__nv_bfloat16, float>(x, gamma, beta, y, mean, rstd, n,
                                            h, eps, rms, stream);
  return -1;
}

// The backward: dx [n, h] in T; dgamma / dbeta [h] in G (null without
// affine params; dbeta ignored for RMSNorm). src is x (mem_eff == 0; mean
// read) or the forward's output y (mem_eff != 0; beta read, mean unused).
// part: fp32 scratch of 2 * apex_ln_bwd_blocks(n) * h floats. Launches the
// row kernel and, with affine params, the column-sum kernel.
extern "C" int apex_ln_bwd(const void* dy, const void* src, const void* gamma,
                           const void* beta, const float* mean,
                           const float* rstd, void* dx, void* dgamma,
                           void* dbeta, float* part, int n, int h, int rms,
                           int mem_eff, int dtype, int pdtype,
                           cudaStream_t stream) {
  if (n < 1 || h < 1 || h > kMaxH) return -1;
  if (dtype == 0 && pdtype == 0)
    return launch_bwd<float, float>(dy, src, gamma, beta, mean, rstd, dx,
                                    dgamma, dbeta, part, n, h, rms, mem_eff,
                                    stream);
  if (dtype == 1 && pdtype == 1)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(
        dy, src, gamma, beta, mean, rstd, dx, dgamma, dbeta, part, n, h, rms,
        mem_eff, stream);
  if (dtype == 1 && pdtype == 0)
    return launch_bwd<__nv_bfloat16, float>(dy, src, gamma, beta, mean, rstd,
                                            dx, dgamma, dbeta, part, n, h,
                                            rms, mem_eff, stream);
  return -1;
}
