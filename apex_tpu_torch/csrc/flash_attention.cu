// Blockwise (flash) attention forward, dK/dV and dQ for Hopper (sm_90a).
//
// Replaces three Pallas kernels of apex_tpu/kernels/flash_attention.py:
//   - _fwd_kernel, launched by _fwd_pallas: o = softmax(q k^T * scale) v per
//     (batch * head), causal or not, with the online-softmax recurrence
//     (running max m, running sum l, accumulator acc) in fp32, and
//     lse = m + log(l) [bh, sq] fp32 saved for the backward;
//   - _bwd_dkdv_kernel (the first pallas_call of _bwd_pallas): for one k-tile,
//     over the q-tiles that reach it, p = exp(s - lse), dp = dO v^T,
//     dv += p^T dO, ds = p * (dp - delta) * scale, dk += ds^T q;
//   - _bwd_dq_kernel (the second): for one q-tile, over the k-tiles it
//     reaches, dq += ds k.
// delta = rowsum(dO * o) [bh, sq] fp32 comes from the caller, as in the JAX
// wrapper. Layout: q, k, v, o, dO [bh, s, 64] contiguous; outputs in the
// input dtype, accumulated in fp32 and rounded once.
//
// Numerics follow the TPU kernels: q, k, v and dO are upcast to fp32, and
// p and ds stay fp32 for the p.v, ds.k and ds^T.q products (no tensor
// cores: a later design that rounds p to bf16 for wgmma moves the result by
// about one bf16 ulp of p). Masked logits are -1e30 (_NEG_INF), never -inf;
// l == 0 is replaced by 1 before o = acc / l and lse = m + log(l).
//
// What bounds them on the card: operations. At the training shape (bh = 96,
// s = 1024, d = 64, causal) the forward does ~2 * 2 * 96 * 1024^2 / 2 * 64
// = 13 GFLOP on ~51 MB of bf16 inputs and outputs: ~255 operations per
// byte, near the H100's ~295 for the bf16 tensor cores and far above the
// ~20 of its fp32 rate. The backward does 2.5x the forward's operations.
// Kept in fp32 on the CUDA cores as this design is, its bound is the fp32
// rate (67 TFLOP/s).
//
// What the design does about it. Each block stages 64 x 64 tiles of the
// operands in shared memory as fp32 (padded rows: conflict-free column
// reads) and reuses every staged element 64 times; 256 threads each own a
// 4 x 4 piece of every 64 x 64 product, so each shared-memory read feeds
// two multiply-adds. The work split is the TPU kernels', with the TPU's
// sequential grid axis as a loop inside the block, so no kernel needs
// atomics:
//   - forward: one block per (bh, q-tile), looping over the k-tiles up to
//     the diagonal;
//   - dK/dV: one block per (bh, k-tile), looping over the q-tiles from the
//     diagonal on;
//   - dQ: one block per (bh, q-tile), looping over the k-tiles up to the
//     diagonal.
// Whole tiles above the diagonal are skipped. Only the diagonal tile (and a
// ragged last tile) is masked elementwise, over the whole tile, with p = 0
// past each row's last position: no loop runs to a per-row bound. The
// heaviest q-tiles (the most k-tiles) are launched first.
// Simple and right first: no tensor cores, no TMA, no cp.async pipelining.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kD = 64;                   // head_dim built for this path
constexpr int kB = 64;                   // q-tile and k-tile rows
constexpr int kLd = kD + 1;              // padded shared-memory row
constexpr int kTile = kB * kLd;          // floats per staged tile
constexpr int kThreads = 256;            // 16 x 16, a 4 x 4 piece each
constexpr int kSide = 16;
constexpr float kNegInf = -1e30f;        // the Pallas kernels' _NEG_INF

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

// Reductions over the 16 lanes of one thread row (same ty): xor offsets
// below 16 stay inside the half-warp.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = kSide / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = kSide / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage rows [r0, r0 + 64) of a [rows, 64] matrix as fp32; rows past `rows`
// read as 0.
template <typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src, int r0,
                                          int rows) {
  for (int i = threadIdx.x; i < kB * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    dst[r * kLd + c] = r0 + r < rows
                           ? to_f(src[static_cast<size_t>(r0 + r) * kD + c])
                           : 0.f;
  }
}

// Stage a 64-row slice of a per-row fp32 vector; rows past `rows` read 0.
__device__ __forceinline__ void load_rows(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int r0, int rows) {
  for (int i = threadIdx.x; i < kB; i += kThreads)
    dst[i] = r0 + i < rows ? src[r0 + i] : 0.f;
}

// out[a][b] = sum_k A[ty + 16a][k] * B[tx + 16b][k] over the 64 columns.
__device__ __forceinline__ void dot_rows(const float* __restrict__ A,
                                         const float* __restrict__ B, int ty,
                                         int tx, float out[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) out[a][b] = 0.f;
#pragma unroll 8
  for (int k = 0; k < kD; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = A[(ty + kSide * a) * kLd + k];
#pragma unroll
    for (int b = 0; b < 4; ++b) bv[b] = B[(tx + kSide * b) * kLd + k];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) out[a][b] += av[a] * bv[b];
  }
}

// acc[a][b] += sum_r A[r][ty + 16a] * B[r][tx + 16b] over the 64 rows when
// `trans` (A^T B), or sum_r A[ty + 16a][r] * B[r][tx + 16b] otherwise (A B).
template <bool kTrans>
__device__ __forceinline__ void mma_acc(const float* __restrict__ A,
                                        const float* __restrict__ B, int ty,
                                        int tx, float acc[4][4]) {
#pragma unroll 8
  for (int r = 0; r < kB; ++r) {
    float av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      av[a] = kTrans ? A[r * kLd + ty + kSide * a]
                     : A[(ty + kSide * a) * kLd + r];
#pragma unroll
    for (int b = 0; b < 4; ++b) bv[b] = B[r * kLd + tx + kSide * b];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] += av[a] * bv[b];
  }
}

// Is logit (row, col) masked? Rows and columns are global positions.
__device__ __forceinline__ bool masked(int row, int col, int sk, int causal) {
  return col >= sk || (causal && col > row);
}

// Number of k-tiles q-tile qt reaches.
__device__ __forceinline__ int k_tiles_for(int qt, int sq, int sk,
                                           int causal) {
  const int nk = (sk + kB - 1) / kB;
  if (!causal) return nk;
  const int last_row = min(qt * kB + kB - 1, sq - 1);
  return min(nk, last_row / kB + 1);
}

// ------------------------------------------------------------------ forward
// grid (ceil(sq / 64), bh), kThreads threads, 4 tiles of dynamic shared
// memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, float scale,
                 int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile;
  float* Vs = Ks + kTile;
  float* Ps = Vs + kTile;
  const int bh = blockIdx.y;
  const int qt = gridDim.x - 1 - blockIdx.x;          // heaviest first
  const int q0 = qt * kB;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const T* qb = q + static_cast<size_t>(bh) * sq * kD;
  const T* kb = k + static_cast<size_t>(bh) * sk * kD;
  const T* vb = v + static_cast<size_t>(bh) * sk * kD;

  load_tile(Qs, qb, q0, sq);
  float m[4], l[4], acc[4][4], s[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  }
  const int nk = k_tiles_for(qt, sq, sk, causal);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();                     // last tile's Ks / Vs / Ps read
    load_tile(Ks, kb, k0, sk);
    load_tile(Vs, vb, k0, sk);
    __syncthreads();
    dot_rows(Qs, Ks, ty, tx, s);
    const bool edge = (causal && k0 + kB - 1 > q0) || k0 + kB > sk;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = kNegInf;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] *= scale;
        if (edge && masked(q0 + ty + kSide * a, k0 + tx + kSide * b, sk,
                           causal))
          s[a][b] = kNegInf;
        mx = fmaxf(mx, s[a][b]);
      }
      const float m_new = fmaxf(m[a], row_max(mx));
      float ps = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = expf(s[a][b] - m_new);
        ps += s[a][b];
        Ps[(ty + kSide * a) * kLd + tx + kSide * b] = s[a][b];
      }
      const float alpha = expf(m[a] - m_new);
      l[a] = alpha * l[a] + row_sum(ps);
      m[a] = m_new;
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] *= alpha;
    }
    __syncthreads();
    mma_acc<false>(Ps, Vs, ty, tx, acc);
  }
  T* ob = o + static_cast<size_t>(bh) * sq * kD;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + kSide * a;
    if (row >= sq) continue;
    const float l_safe = l[a] == 0.f ? 1.f : l[a];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      ob[static_cast<size_t>(row) * kD + tx + kSide * b] =
          from_f<T>(acc[a][b] / l_safe);
    if (tx == 0) lse[static_cast<size_t>(bh) * sq + row] = m[a] +
                                                           logf(l_safe);
  }
}

// ------------------------------------------------------------------- dK / dV
// grid (ceil(sk / 64), bh), kThreads threads, 6 tiles + 2 rows of dynamic
// shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int sq, int sk, float scale,
                      int causal) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile;
  float* Qs = Vs + kTile;
  float* dOs = Qs + kTile;
  float* Ps = dOs + kTile;
  float* dSs = Ps + kTile;
  float* lse_s = dSs + kTile;
  float* delta_s = lse_s + kB;
  const int bh = blockIdx.y;
  const int kt = blockIdx.x;             // the first k-tiles meet most q-tiles
  const int k0 = kt * kB;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const size_t qoff = static_cast<size_t>(bh) * sq;
  const size_t koff = static_cast<size_t>(bh) * sk;

  load_tile(Ks, k + koff * kD, k0, sk);
  load_tile(Vs, v + koff * kD, k0, sk);
  float dk_acc[4][4], dv_acc[4][4], s[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) dk_acc[a][b] = dv_acc[a][b] = 0.f;
  const int nq = (sq + kB - 1) / kB;
  // causal: q-tile qt reaches k-tile kt once its last row is >= k0
  const int qt0 = causal ? min(nq, k0 / kB) : 0;
  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * kB;
    __syncthreads();                     // last tile's Qs / dOs / Ps read
    load_tile(Qs, q + qoff * kD, q0, sq);
    load_tile(dOs, dout + qoff * kD, q0, sq);
    load_rows(lse_s, lse + qoff, q0, sq);
    load_rows(delta_s, delta + qoff, q0, sq);
    __syncthreads();
    dot_rows(Qs, Ks, ty, tx, s);         // rows: q, columns: k
    dot_rows(dOs, Vs, ty, tx, dp);
    const bool edge = (causal && k0 + kB - 1 > q0) || k0 + kB > sk ||
                      q0 + kB > sq;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + kSide * a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = tx + kSide * b;
        const bool off = edge && (q0 + i >= sq ||
                                  masked(q0 + i, k0 + j, sk, causal));
        const float p = off ? 0.f : expf(s[a][b] * scale - lse_s[i]);
        Ps[i * kLd + j] = p;
        dSs[i * kLd + j] = p * (dp[a][b] - delta_s[i]) * scale;
      }
    }
    __syncthreads();
    mma_acc<true>(Ps, dOs, ty, tx, dv_acc);    // dv += p^T dO
    mma_acc<true>(dSs, Qs, ty, tx, dk_acc);    // dk += ds^T q
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = k0 + ty + kSide * a;
    if (row >= sk) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const size_t at = (koff + row) * kD + tx + kSide * b;
      dk[at] = from_f<T>(dk_acc[a][b]);
      dv[at] = from_f<T>(dv_acc[a][b]);
    }
  }
}

// ------------------------------------------------------------------------ dQ
// grid (ceil(sq / 64), bh), kThreads threads, 5 tiles + 2 rows of dynamic
// shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int sq, int sk, float scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile;
  float* Ks = dOs + kTile;
  float* Vs = Ks + kTile;
  float* dSs = Vs + kTile;
  float* lse_s = dSs + kTile;
  float* delta_s = lse_s + kB;
  const int bh = blockIdx.y;
  const int qt = gridDim.x - 1 - blockIdx.x;          // heaviest first
  const int q0 = qt * kB;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const size_t qoff = static_cast<size_t>(bh) * sq;
  const size_t koff = static_cast<size_t>(bh) * sk;

  load_tile(Qs, q + qoff * kD, q0, sq);
  load_tile(dOs, dout + qoff * kD, q0, sq);
  load_rows(lse_s, lse + qoff, q0, sq);
  load_rows(delta_s, delta + qoff, q0, sq);
  float dq_acc[4][4], s[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) dq_acc[a][b] = 0.f;
  const int nk = k_tiles_for(qt, sq, sk, causal);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();                     // last tile's Ks / dSs read
    load_tile(Ks, k + koff * kD, k0, sk);
    load_tile(Vs, v + koff * kD, k0, sk);
    __syncthreads();
    dot_rows(Qs, Ks, ty, tx, s);
    dot_rows(dOs, Vs, ty, tx, dp);
    const bool edge = (causal && k0 + kB - 1 > q0) || k0 + kB > sk ||
                      q0 + kB > sq;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + kSide * a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = tx + kSide * b;
        const bool off = edge && (q0 + i >= sq ||
                                  masked(q0 + i, k0 + j, sk, causal));
        const float p = off ? 0.f : expf(s[a][b] * scale - lse_s[i]);
        dSs[i * kLd + j] = p * (dp[a][b] - delta_s[i]) * scale;
      }
    }
    __syncthreads();
    mma_acc<false>(dSs, Ks, ty, tx, dq_acc);   // dq += ds k
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + kSide * a;
    if (row >= sq) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      dq[(qoff + row) * kD + tx + kSide * b] = from_f<T>(dq_acc[a][b]);
  }
}

constexpr size_t kFwdSmem = 4 * kTile * sizeof(float);
constexpr size_t kDkdvSmem = (6 * kTile + 2 * kB) * sizeof(float);
constexpr size_t kDqSmem = (5 * kTile + 2 * kB) * sizeof(float);

// Above 48 KB a kernel takes dynamic shared memory only after it opts in:
// once per kernel, at its first launch (outside any graph capture that
// replays it later).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  *done = err == cudaSuccess;
  return err;
}

bool shapes_ok(int bh, int sq, int sk, int d) {
  return bh >= 1 && bh <= 65535 && sq >= 1 && sk >= 1 && d == kD;
}

template <typename T>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        int bh, int sq, int sk, float scale, int causal, cudaStream_t st) {
  static bool opted_in = false;
  cudaError_t err = allow_smem(flash_fwd_kernel<T>, kFwdSmem, &opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kB - 1) / kB, bh);
  flash_fwd_kernel<T><<<grid, kThreads, kFwdSmem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dkdv(const void* q, const void* k, const void* v, const void* dout,
         const float* lse, const float* delta, void* dk, void* dv, int bh,
         int sq, int sk, float scale, int causal, cudaStream_t st) {
  static bool opted_in = false;
  cudaError_t err =
      allow_smem(flash_bwd_dkdv_kernel<T>, kDkdvSmem, &opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sk + kB - 1) / kB, bh);
  flash_bwd_dkdv_kernel<T><<<grid, kThreads, kDkdvSmem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const float* lse, const float* delta, void* dqo, int bh, int sq,
       int sk, float scale, int causal, cudaStream_t st) {
  static bool opted_in = false;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T>, kDqSmem, &opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kB - 1) / kB, bh);
  flash_bwd_dq_kernel<T><<<grid, kThreads, kDqSmem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dqo), sq, sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every q / k / v / o / dO / dq / dk / dv
// operand). q, o, dO, dq: [bh, sq, 64]; k, v, dk, dv: [bh, sk, 64]; lse,
// delta: [bh, sq] fp32; all contiguous. Each returns cudaGetLastError()
// after its launch, or -1 for a shape or dtype it does not take.
extern "C" int apex_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, int bh, int sq, int sk,
                              int d, float scale, int causal, int dtype,
                              cudaStream_t stream) {
  if (!shapes_ok(bh, sq, sk, d)) return -1;
  if (dtype == 0)
    return fwd<float>(q, k, v, o, lse, bh, sq, sk, scale, causal, stream);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(q, k, v, o, lse, bh, sq, sk, scale, causal,
                              stream);
  return -1;
}

extern "C" int apex_flash_bwd_dkdv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dk, void* dv, int bh, int sq, int sk,
                                   int d, float scale, int causal, int dtype,
                                   cudaStream_t stream) {
  if (!shapes_ok(bh, sq, sk, d)) return -1;
  if (dtype == 0)
    return dkdv<float>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, scale,
                       causal, stream);
  if (dtype == 1)
    return dkdv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                               scale, causal, stream);
  return -1;
}

extern "C" int apex_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dqo, int bh,
                                 int sq, int sk, int d, float scale,
                                 int causal, int dtype, cudaStream_t stream) {
  if (!shapes_ok(bh, sq, sk, d)) return -1;
  if (dtype == 0)
    return dq<float>(q, k, v, dout, lse, delta, dqo, bh, sq, sk, scale,
                     causal, stream);
  if (dtype == 1)
    return dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dqo, bh, sq, sk,
                             scale, causal, stream);
  return -1;
}
