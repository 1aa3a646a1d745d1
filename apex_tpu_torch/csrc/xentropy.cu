// Fused softmax cross-entropy with label smoothing, forward and backward,
// for Hopper (sm_90a).
//
// Replaces two Pallas kernels of apex_tpu/kernels/xentropy.py:
//   - _fwd_kernel (launched by _xent_fwd, xentropy.py:132): per row of
//     logits [N, V], lse = log(sum_c exp(x_c)) and
//     loss = (1 - s) * (lse - x[y]) - s * mean_c(x_c - lse),
//     NaN for a label y outside [0, V) (lse stays finite); writes loss [N]
//     and lse [N] in fp32 and saves no softmax;
//   - _bwd_kernel (launched by _xent_bwd, xentropy.py:161):
//     dlogits = g * (softmax - ((1 - s) * onehot(y) + s / V)) in the logits'
//     dtype, softmax recomputed as exp(x - lse); a row with an invalid label
//     gets g * s * (softmax - 1 / V) (0 without smoothing).
// Logits are fp32 or bf16, any V >= 1 and any N; the arithmetic is fp32.
// Unlike the TPU kernel, which needs V % 128 == 0 (GPT-2's V = 50257 takes
// the jnp path there), these take any row length.
//
// What bounds them on the card: bytes. Each logit is read once (forward)
// or read once and written once (backward) for a handful of operations; at
// the LM's [8192, 50257] the forward moves 0.82 GB in bf16 (1.65 GB fp32)
// and the backward twice that, against the H100's 3.35 TB/s.
//
// What the design does about it: one block of 256 threads per row, the
// row read once with 16-byte vector loads. Rows are not 16-byte aligned (a
// bf16 row of 50257 is 100,514 bytes), so each row is cut into a scalar
// head up to the first 16-byte boundary, a vector body and a scalar tail;
// the backward takes the vector path only where input and output rows
// share their offset within 16 bytes (fresh outputs do). An fp32 row (201
// KB) does not fit a block's registers, so the forward keeps an ONLINE
// max / sum-exp per thread — the running sum rescaled once per vector when
// the max grows, so about one exp per element — plus the sum of x for the
// smoothing term, and merges them across the block; x[y] is read once by
// thread 0. The backward recomputes exp(x - lse) from the saved lse.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;

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

// 16 bytes of T: 4 fp32 or 8 bf16 values
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[Vec<T>::N]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) out[i] = to_f(e[i]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[Vec<T>::N]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) e[i] = from_f<T>(in[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Elements of a row before its first 16-byte boundary (at most v).
template <typename T>
__device__ __forceinline__ int head_len(const T* row, int v) {
  const int bytes = static_cast<int>(
      (16u - (reinterpret_cast<uintptr_t>(row) & 15u)) & 15u);
  const int h = bytes / static_cast<int>(sizeof(T));
  return h < v ? h : v;
}

// exp(a - m) for a running max m that may still be -inf (nothing seen yet,
// or every value so far -inf): such terms add 0, not exp(NaN)
__device__ __forceinline__ float exp_rebased(float a, float m) {
  return m == -INFINITY ? 0.f : expf(a - m);
}

// Merge (m2, s2) into the running (m, s): sums of exp(x - m).
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mm = m > m2 ? m : m2;
  if (mm == -INFINITY) return;           // both empty
  s = (m == -INFINITY ? 0.f : s * expf(m - mm)) +
      (m2 == -INFINITY ? 0.f : s2 * expf(m2 - mm));
  m = mm;
}

__device__ __forceinline__ void add_one(float x, float& m, float& s,
                                        float& sx, bool& nan) {
  nan |= x != x;
  if (x > m) {
    s = exp_rebased(m, x) * s + 1.f;
    m = x;
  } else {
    s += exp_rebased(x, m);
  }
  sx += x;
}

// ----------------------------------------------------------------- forward
template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_fwd_kernel(const T* __restrict__ logits,
                const int64_t* __restrict__ labels,
                float* __restrict__ loss, float* __restrict__ lse_out, int v,
                float smoothing, float one_minus_s) {
  constexpr int VN = Vec<T>::N;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const T* x = logits + static_cast<size_t>(row) * v;
  const int head = head_len(x, v);
  const int nvec = (v - head) / VN;
  const int tail = head + nvec * VN;

  float m = -INFINITY, s = 0.f, sx = 0.f;
  bool nan = false;
  for (int c = tid; c < head; c += kThreads)
    add_one(to_f(x[c]), m, s, sx, nan);
  for (int c = tail + tid; c < v; c += kThreads)
    add_one(to_f(x[c]), m, s, sx, nan);
#pragma unroll 4
  for (int j = tid; j < nvec; j += kThreads) {
    float e[VN];
    load_vec(x + head + j * VN, e);
    float mv = e[0];
#pragma unroll
    for (int i = 1; i < VN; ++i) mv = e[i] > mv ? e[i] : mv;
    if (mv > m) {                        // rescale once per vector
      s *= exp_rebased(m, mv);
      m = mv;
    }
#pragma unroll
    for (int i = 0; i < VN; ++i) {
      nan |= e[i] != e[i];
      s += exp_rebased(e[i], m);
      sx += e[i];
    }
  }
  // a NaN logit never wins a max comparison above, so it is flagged
  // instead: the row's lse and loss come out NaN, as the plain version's
  nan = __any_sync(0xffffffffu, nan);

  // merge across the warp, then across the block's warps
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    sx += __shfl_xor_sync(0xffffffffu, sx, o);
    merge(m, s, m2, s2);
  }
  __shared__ float sm[kThreads / kWarp], ss[kThreads / kWarp],
      ssx[kThreads / kWarp];
  __shared__ int snan[kThreads / kWarp];
  const int warp = tid / kWarp, lane = tid % kWarp;
  if (lane == 0) {
    sm[warp] = m;
    ss[warp] = s;
    ssx[warp] = sx;
    snan[warp] = nan;
  }
  __syncthreads();
  if (tid != 0) return;
  m = sm[0];
  s = ss[0];
  sx = ssx[0];
  for (int w = 1; w < kThreads / kWarp; ++w) {
    merge(m, s, sm[w], ss[w]);
    sx += ssx[w];
    nan |= snan[w] != 0;
  }
  const float qnan = __int_as_float(0x7fc00000);
  const float lse = nan ? qnan : m + logf(s);
  const int64_t y = labels[row];
  const bool valid = y >= 0 && y < v;
  const float nll = valid ? lse - to_f(x[y]) : qnan;
  float out = nll;
  if (smoothing > 0.f) {
    const float mean_logp = sx / static_cast<float>(v) - lse;
    out = one_minus_s * nll - smoothing * mean_logp;
  }
  loss[row] = out;
  lse_out[row] = lse;
}

// ---------------------------------------------------------------- backward
// dl for column c of a row: softmax p minus the target, or the invalid-row
// smoothing term; times g, in fp32, in the TPU kernel's order of operations
__device__ __forceinline__ float dlogit(float x, int c, float lse, float g,
                                        int64_t y, bool valid,
                                        float smoothing, float on_label,
                                        float s_over_v, float inv_v) {
  const float p = expf(x - lse);
  float dl;
  if (valid) {
    dl = p - (c == y ? on_label : s_over_v);
  } else {
    dl = smoothing > 0.f ? smoothing * (p - inv_v) : 0.f;
  }
  return dl * g;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_bwd_kernel(const T* __restrict__ logits,
                const int64_t* __restrict__ labels,
                const float* __restrict__ lse_in,
                const float* __restrict__ g_in, T* __restrict__ dlogits,
                int v, float smoothing, float on_label, float s_over_v,
                float inv_v) {
  constexpr int VN = Vec<T>::N;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t off = static_cast<size_t>(row) * v;
  const T* x = logits + off;
  T* dx = dlogits + off;
  const float lse = lse_in[row];
  const float g = g_in[row];
  const int64_t y = labels[row];
  const bool valid = y >= 0 && y < v;
  // vector path only when both rows sit at one offset within 16 bytes
  const bool same = ((reinterpret_cast<uintptr_t>(x) ^
                      reinterpret_cast<uintptr_t>(dx)) & 15u) == 0;
  const int head = same ? head_len(x, v) : v;
  const int nvec = (v - head) / VN;
  const int tail = head + nvec * VN;

  for (int c = tid; c < head; c += kThreads)
    dx[c] = from_f<T>(dlogit(to_f(x[c]), c, lse, g, y, valid, smoothing,
                             on_label, s_over_v, inv_v));
  for (int c = tail + tid; c < v; c += kThreads)
    dx[c] = from_f<T>(dlogit(to_f(x[c]), c, lse, g, y, valid, smoothing,
                             on_label, s_over_v, inv_v));
#pragma unroll 4
  for (int j = tid; j < nvec; j += kThreads) {
    const int c0 = head + j * VN;
    float e[VN];
    load_vec(x + c0, e);
#pragma unroll
    for (int i = 0; i < VN; ++i)
      e[i] = dlogit(e[i], c0 + i, lse, g, y, valid, smoothing, on_label,
                    s_over_v, inv_v);
    store_vec(dx + c0, e);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 logits. labels int64 [n]; loss, lse fp32
// [n]. smoothing s with one_minus_s = fp32(1 - s) from the caller. Returns
// cudaGetLastError() after the launch, or -1 for shapes it does not take.
extern "C" int apex_xent_fwd(const void* logits, const int64_t* labels,
                             float* loss, float* lse, int n, int v, int dtype,
                             float smoothing, float one_minus_s,
                             cudaStream_t stream) {
  if (n < 1 || v < 1) return -1;
  if (dtype == 0)
    xent_fwd_kernel<float><<<n, kThreads, 0, stream>>>(
        static_cast<const float*>(logits), labels, loss, lse, v, smoothing,
        one_minus_s);
  else if (dtype == 1)
    xent_fwd_kernel<__nv_bfloat16><<<n, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(logits), labels, loss, lse, v,
        smoothing, one_minus_s);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}

// dlogits [n, v] in the logits' dtype from logits, labels, the forward's lse
// and the per-row upstream gradient g (fp32 [n]). on_label = fp32(fp32(1 - s)
// + fp32(s / v)), s_over_v = fp32(s / v), inv_v = fp32(1 / v): the TPU
// kernel's constants, rounded as there.
extern "C" int apex_xent_bwd(const void* logits, const int64_t* labels,
                             const float* lse, const float* g, void* dlogits,
                             int n, int v, int dtype, float smoothing,
                             float on_label, float s_over_v, float inv_v,
                             cudaStream_t stream) {
  if (n < 1 || v < 1) return -1;
  if (dtype == 0)
    xent_bwd_kernel<float><<<n, kThreads, 0, stream>>>(
        static_cast<const float*>(logits), labels, lse, g,
        static_cast<float*>(dlogits), v, smoothing, on_label, s_over_v,
        inv_v);
  else if (dtype == 1)
    xent_bwd_kernel<__nv_bfloat16><<<n, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(logits), labels, lse, g,
        static_cast<__nv_bfloat16*>(dlogits), v, smoothing, on_label,
        s_over_v, inv_v);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}
