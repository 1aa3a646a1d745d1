// Paged decode and paged chunk-prefill attention for Hopper (sm_90a).
//
// Replaces two Pallas kernels:
//   - apex_tpu/kernels/decode_attention.py, _paged_decode_kernel (launched
//     by _paged_decode_pallas): one query per (batch row, head) against the
//     row's pages, masked at lengths[b]; rows with lengths[b] == 0 give 0.
//   - apex_tpu/kernels/prefill_attention.py, _paged_prefill_kernel
//     (launched by _paged_prefill_pallas): a chunk of C queries per row,
//     query i at global position offsets[b] + i attending positions
//     <= offsets[b] + i (shifted-causal), never reading past the row's last
//     reachable page (offsets[b] + C - 1) / page_len.
// Both keep the online-softmax recurrence (running max m, running sum l,
// accumulator acc) in fp32 whatever the I/O dtype, and apply `scale` to the
// logits. Layouts are the JAX package's: q [B, H, (C,) D], pools
// [num_pages, H, page_len, D], page_table [B, max_pages] int32.
//
// What bounds them on the card: bytes. Decode does 4 operations per K/V
// element it reads (one multiply-add for q.k, one for p.v); chunk prefill
// reuses each K/V element across up to C queries, but at the serving path's
// shapes (C = 256, a prefix of at most 1024 positions, D = 64) both stay far
// below the ~295 operations per byte at which the H100's tensor cores would
// become the limit.
//
// What the design does about it. The TPU kernels walked one page per grid
// step with scalar-prefetched page ids and carried (m, l, acc) in scratch
// across the sequential grid. Here a block reads its own row of the page
// table and its own length/offset, and a loop inside the block takes the
// place of the sequential grid axis:
//   - decode: one block per (head, row), four warps splitting the row's
//     positions (a lane per position for q.k, a lane per output column for
//     p.v, so V is read coalesced), each warp with its own (m, l, acc),
//     merged once at the end through shared memory. Pages past
//     ceil(lengths[b] / page_len) are never read, so a live row never sees
//     the sentinel page 0 and a short row costs O(length) bytes.
//   - prefill: one block per (q-tile of 16 rows, head, row); the block
//     stages each 32-position K/V tile in shared memory once (fp32) and its
//     four warps reuse it for their four query rows each. Tiles past the
//     block's last query position are skipped, and no position past it is
//     loaded, so the walk is O(offset + C) like the TPU kernel's clamped
//     page walk.
// Simple and right first: no tensor cores, no TMA, no cp.async pipelining.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;
constexpr float kNegInit = -1e30f;       // the Pallas kernels' _NEG_INF

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Element offset of position `pos` of head `hh` in a pool, through row b's
// page table.
__device__ __forceinline__ size_t pool_offset(const int* __restrict__ pt_row,
                                              int pos, int hh, int heads,
                                              int page_len, int d) {
  const int page = pt_row[pos / page_len];
  return ((static_cast<size_t>(page) * heads + hh) * page_len +
          pos % page_len) * d;
}

// ----------------------------------------------------------------- decode
// grid (heads, batch), block kWarps * 32 threads.
template <int D, typename T>
__global__ void paged_decode_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k_pool,
                                    const T* __restrict__ v_pool,
                                    const int* __restrict__ page_table,
                                    const int* __restrict__ lengths,
                                    T* __restrict__ out, int heads,
                                    int page_len, int max_pages,
                                    float scale) {
  constexpr int kPerLane = D / kWarp;
  __shared__ float qs[D];
  __shared__ float wm[kWarps];
  __shared__ float wl[kWarps];
  __shared__ float wacc[kWarps][D];
  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int* pt_row = page_table + static_cast<size_t>(b) * max_pages;
  const int len = min(max(lengths[b], 0), max_pages * page_len);
  const size_t qo = (static_cast<size_t>(b) * heads + hh) * D;
  for (int i = threadIdx.x; i < D; i += blockDim.x) qs[i] = to_f(q[qo + i]);
  __syncthreads();

  float m = kNegInit, l = 0.f, acc[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) acc[k] = 0.f;

  for (int base = warp * kWarp; base < len; base += kWarps * kWarp) {
    const int pos = base + lane;
    const bool valid = pos < len;
    float s = -CUDART_INF_F;
    if (valid) {
      const T* kr = k_pool + pool_offset(pt_row, pos, hh, heads, page_len, D);
      float dot = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) dot += qs[c] * to_f(kr[c]);
      s = dot * scale;
    }
    const float m_new = fmaxf(m, warp_max(s));   // lane 0 is always valid
    const float p = valid ? expf(s - m_new) : 0.f;
    const float alpha = expf(m - m_new);
    l = l * alpha + warp_sum(p);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) acc[k] *= alpha;
    const int n_valid = min(kWarp, len - base);
    for (int j = 0; j < n_valid; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
      const T* vr =
          v_pool + pool_offset(pt_row, base + j, hh, heads, page_len, D);
#pragma unroll
      for (int k = 0; k < kPerLane; ++k)
        acc[k] += pj * to_f(vr[lane + k * kWarp]);
    }
    m = m_new;
  }

  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) wacc[warp][lane + k * kWarp] = acc[k];
  __syncthreads();
  if (warp == 0) {
    float mm = kNegInit;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, wm[w]);
    float ll = 0.f, f[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      f[w] = expf(wm[w] - mm);
      ll += wl[w] * f[w];
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int c = lane + k * kWarp;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += wacc[w][c] * f[w];
      // lengths[b] == 0 leaves l == 0: a defined zero row, as the
      // Pallas wrapper's jnp.where(live, out, 0)
      out[qo + c] = from_f<T>(ll > 0.f ? a / ll : 0.f);
    }
  }
}

// ---------------------------------------------------------------- prefill
constexpr int kQTile = 16;               // query rows per block
constexpr int kRowsPerWarp = kQTile / kWarps;
constexpr int kKTile = kWarp;            // positions per staged K/V tile

// grid (ceil(C / kQTile), heads, batch), block kWarps * 32 threads.
template <int D, typename T>
__global__ void paged_prefill_kernel(const T* __restrict__ q,
                                     const T* __restrict__ k_pool,
                                     const T* __restrict__ v_pool,
                                     const int* __restrict__ page_table,
                                     const int* __restrict__ offsets,
                                     T* __restrict__ out, int heads, int C,
                                     int page_len, int max_pages,
                                     float scale) {
  constexpr int kPerLane = D / kWarp;
  __shared__ float qs[kQTile][D];
  __shared__ float ks[kKTile][D + 1];    // +1: conflict-free row reads
  __shared__ float vs[kKTile][D];
  const int q0 = blockIdx.x * kQTile;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int nq = min(kQTile, C - q0);
  const int off = offsets[b];
  const int* pt_row = page_table + static_cast<size_t>(b) * max_pages;
  const size_t qo = ((static_cast<size_t>(b) * heads + hh) * C + q0) * D;
  for (int i = threadIdx.x; i < kQTile * D; i += blockDim.x) {
    const int r = i / D;
    qs[r][i % D] = r < nq ? to_f(q[qo + i]) : 0.f;
  }
  // the last position any query of this block attends; never past the
  // page table's extent
  const int last = min(off + q0 + nq - 1, max_pages * page_len - 1);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInit;
    l[rr] = 0.f;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) acc[rr][k] = 0.f;
  }

  for (int base = 0; base <= last; base += kKTile) {
    __syncthreads();   // previous tile consumed (and qs staged, first time)
    for (int i = threadIdx.x; i < kKTile * D; i += blockDim.x) {
      const int t = i / D, c = i % D;
      const int pos = base + t;
      float kv = 0.f, vv = 0.f;
      if (pos <= last) {
        const size_t o = pool_offset(pt_row, pos, hh, heads, page_len, D) + c;
        kv = to_f(k_pool[o]);
        vv = to_f(v_pool[o]);
      }
      ks[t][c] = kv;
      vs[t][c] = vv;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      // the row's last visible position (staged tiles hold nothing past
      // `last`)
      const int row_pos = min(off + q0 + r, last);
      // warp-uniform: the row exists and the tile starts at or before it
      if (r < nq && base <= row_pos) {
        const int pos = base + lane;
        const bool valid = pos <= row_pos;
        float s = -CUDART_INF_F;
        if (valid) {
          float dot = 0.f;
#pragma unroll 16
          for (int c = 0; c < D; ++c) dot += qs[r][c] * ks[lane][c];
          s = dot * scale;
        }
        const float m_new = fmaxf(m[rr], warp_max(s));
        const float p = valid ? expf(s - m_new) : 0.f;
        const float alpha = expf(m[rr] - m_new);
        l[rr] = l[rr] * alpha + warp_sum(p);
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) acc[rr][k] *= alpha;
        // all kKTile positions, masked ones with p == 0: staged values are
        // finite (zero past `last`), so they add exactly nothing
#pragma unroll
        for (int j = 0; j < kKTile; ++j) {
          const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
          for (int k = 0; k < kPerLane; ++k)
            acc[rr][k] += pj * vs[j][lane + k * kWarp];
        }
        m[rr] = m_new;
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    if (r < nq) {
      const float inv = l[rr] > 0.f ? 1.f / l[rr] : 0.f;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k)
        out[qo + static_cast<size_t>(r) * D + lane + k * kWarp] =
            from_f<T>(acc[rr][k] * inv);
    }
  }
}

template <int D, typename T>
int launch_decode(const void* q, const void* k, const void* v,
                  const int* pt, const int* lens, void* out, int batch,
                  int heads, int page_len, int max_pages, float scale,
                  cudaStream_t stream) {
  paged_decode_kernel<D, T><<<dim3(heads, batch), kWarps * kWarp, 0,
                              stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pt, lens, static_cast<T*>(out), heads,
      page_len, max_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename T>
int launch_prefill(const void* q, const void* k, const void* v,
                   const int* pt, const int* offs, void* out, int batch,
                   int heads, int C, int page_len, int max_pages,
                   float scale, cudaStream_t stream) {
  const dim3 grid((C + kQTile - 1) / kQTile, heads, batch);
  paged_prefill_kernel<D, T><<<grid, kWarps * kWarp, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pt, offs, static_cast<T*>(out), heads, C,
      page_len, max_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim d == 64, the serving path's
// (another width is instantiated when a path that runs it is checked on
// the card).
// Returns cudaGetLastError() after the launch, or -1 for a shape or dtype
// the kernel does not take.
extern "C" int apex_paged_decode(const void* q, const void* k_pool,
                                 const void* v_pool, const int* page_table,
                                 const int* lengths, void* out, int batch,
                                 int heads, int d, int page_len,
                                 int max_pages, float scale, int dtype,
                                 cudaStream_t stream) {
  if (batch < 1 || heads < 1 || page_len < 1 || max_pages < 1) return -1;
#define APEX_DECODE(DD, TT)                                                  \
  return launch_decode<DD, TT>(q, k_pool, v_pool, page_table, lengths, out, \
                               batch, heads, page_len, max_pages, scale,     \
                               stream)
  if (dtype == 0) {
    if (d == 64) APEX_DECODE(64, float);
  } else if (dtype == 1) {
    if (d == 64) APEX_DECODE(64, __nv_bfloat16);
  }
#undef APEX_DECODE
  return -1;
}

extern "C" int apex_paged_prefill(const void* q, const void* k_pool,
                                  const void* v_pool, const int* page_table,
                                  const int* offsets, void* out, int batch,
                                  int heads, int C, int d, int page_len,
                                  int max_pages, float scale, int dtype,
                                  cudaStream_t stream) {
  if (batch < 1 || heads < 1 || C < 1 || page_len < 1 || max_pages < 1)
    return -1;
#define APEX_PREFILL(DD, TT)                                                 \
  return launch_prefill<DD, TT>(q, k_pool, v_pool, page_table, offsets, out, \
                                batch, heads, C, page_len, max_pages, scale, \
                                stream)
  if (dtype == 0) {
    if (d == 64) APEX_PREFILL(64, float);
  } else if (dtype == 1) {
    if (d == 64) APEX_PREFILL(64, __nv_bfloat16);
  }
#undef APEX_PREFILL
  return -1;
}
