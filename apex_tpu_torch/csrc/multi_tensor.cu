// Multi-tensor apply for Hopper (sm_90a): one launch over a LIST of tensors
// of any sizes, with the scale (unscale) and Adam functors.
//
// Replaces two Pallas kernels of apex_tpu/kernels/multi_tensor.py:
//   - _scale_kernel (launched by fused_scale, multi_tensor.py:95):
//     out = x * scale in the out dtype, found_inf = any(!isfinite(x)) —
//     apex's multi_tensor_scale, which amp's unscale runs;
//   - _adam_kernel (launched by fused_adam_step, multi_tensor.py:265): one
//     Adam / AdamW step with bias correction and inv_scale — apex's
//     multi_tensor_adam.
// The TPU kernels run over one flat, zero-padded superbuffer; here, as in
// apex's csrc/multi_tensor_apply.cuh, the tensors stay where they are.
//
// What bounds them on the card: bytes. Scale reads 2 or 4 bytes and writes
// 4 per element; Adam reads p, g, m, v and writes p, m, v, 28 bytes per
// fp32 element, for ~15 operations. What costs time in eager PyTorch is not
// the bytes but the launches: a per-tensor update of GPT-2's 148 tensors is
// ~2000 small kernels a step.
//
// What the design does about it: the host cuts every tensor into chunks of
// kChunk elements and fills a table — the tensors' addresses and sizes and,
// for each block, which tensor and which chunk it owns — that travels IN
// the kernel's parameters (by value: CUDA 12.1+ allows 32,764 bytes of
// parameters on sm_70+). One table holds kMaxTensors tensors and kMaxBlocks
// chunks; GPT-2's 148 tensors make ~2000 chunks, so one launch per dtype
// group. A full table launches and the walk continues, a tensor cut across
// two launches resuming at its next chunk (apex's multi_tensor_apply). Each
// block walks its chunk with kILP elements per thread per step, 16-byte
// vector accesses where every pointer of the tensor allows them. Scalars go
// by value; found_inf is one device int the scale kernel sets to 1.
//
// The Adam arithmetic is the plain version's, operation for operation, with
// __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn so that nvcc contracts
// nothing into an FMA: the kernel matches the plain PyTorch ops bit for bit,
// and the tree and flat layouts of FusedAdam, which both run it, agree
// bitwise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kILP = 4;
constexpr int64_t kChunk = 65536;        // elements per block (apex's 2048*32)
constexpr int kMaxTensors = 192;
constexpr int kMaxBlocks = 2560;

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

// The launch table: depth lists of tensor addresses, their sizes, and each
// block's (tensor, chunk). 4 lists: 6 KB + 1.5 KB + 2.5 KB + 10 KB.
template <int Depth>
struct TensorListMetadata {
  void* addresses[Depth][kMaxTensors];
  int64_t sizes[kMaxTensors];
  uint8_t block_to_tensor[kMaxBlocks];
  int block_to_chunk[kMaxBlocks];
};
static_assert(sizeof(TensorListMetadata<4>) + 128 <= 32764,
              "the table must fit the kernel-parameter space");
static_assert(kMaxTensors <= 256, "block_to_tensor is one byte");

template <typename T>
__device__ __forceinline__ bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) % (kILP * sizeof(T))) == 0;
}

template <typename T>
__device__ __forceinline__ void load_ilp(float (&r)[kILP], const T* p,
                                         int64_t i) {
  struct alignas(kILP * sizeof(T)) V { T v[kILP]; };
  const V raw = reinterpret_cast<const V*>(p)[i];
#pragma unroll
  for (int k = 0; k < kILP; ++k) r[k] = to_f(raw.v[k]);
}

template <typename T>
__device__ __forceinline__ void store_ilp(T* p, int64_t i,
                                          const float (&r)[kILP]) {
  struct alignas(kILP * sizeof(T)) V { T v[kILP]; };
  V raw;
#pragma unroll
  for (int k = 0; k < kILP; ++k) raw.v[k] = from_f<T>(r[k]);
  reinterpret_cast<V*>(p)[i] = raw;
}

// --------------------------------------------------------------- functors
// out = x * scale in the out dtype; found_inf |= !isfinite(x)
template <typename TIn, typename TOut>
struct ScaleFunctor {
  static constexpr int kDepth = 2;
  float scale;
  int* found_inf;

  __device__ __forceinline__ void operator()(
      int chunk, int64_t n, const TensorListMetadata<2>& tl, int t) const {
    const int64_t base = static_cast<int64_t>(chunk) * kChunk;
    const TIn* in = static_cast<const TIn*>(tl.addresses[0][t]) + base;
    TOut* out = static_cast<TOut*>(tl.addresses[1][t]) + base;
    n -= base;
    const int64_t len = n < kChunk ? n : kChunk;
    bool finite = true;
    if (len % kILP == 0 && aligned<TIn>(in) && aligned<TOut>(out)) {
      for (int64_t i = threadIdx.x; i * kILP < len; i += blockDim.x) {
        float r[kILP];
        load_ilp(r, in, i);
#pragma unroll
        for (int k = 0; k < kILP; ++k) {
          finite = finite && isfinite(r[k]);
          r[k] = __fmul_rn(r[k], scale);
        }
        store_ilp(out, i, r);
      }
    } else {
      for (int64_t i = threadIdx.x; i < len; i += blockDim.x) {
        const float x = to_f(in[i]);
        finite = finite && isfinite(x);
        out[i] = from_f<TOut>(__fmul_rn(x, scale));
      }
    }
    if (!finite) *found_inf = 1;
  }
};

// One Adam / AdamW element, the plain version's operations in its order.
struct AdamArgs {
  float lr, beta1, beta2, one_minus_beta1, one_minus_beta2, eps, wd, bc1,
      bc2, inv_scale;
  int adam_w;        // 1: decoupled decay (AdamW), 0: L2 folded into g
  int apply_delta;   // 1: p += T(new_p - p), 0: p = T(new_p)
};

__device__ __forceinline__ void adam_elem(const AdamArgs& a, float g,
                                          float& p, float& m, float& v,
                                          float& p_out) {
  g = __fmul_rn(g, a.inv_scale);
  if (!a.adam_w) g = __fadd_rn(g, __fmul_rn(a.wd, p));
  m = __fadd_rn(__fmul_rn(a.beta1, m), __fmul_rn(a.one_minus_beta1, g));
  v = __fadd_rn(__fmul_rn(a.beta2, v),
                __fmul_rn(__fmul_rn(a.one_minus_beta2, g), g));
  float upd = __fdiv_rn(__fdiv_rn(m, a.bc1),
                        __fadd_rn(__fsqrt_rn(__fdiv_rn(v, a.bc2)), a.eps));
  if (a.adam_w) upd = __fadd_rn(upd, __fmul_rn(a.wd, p));
  p_out = __fsub_rn(p, __fmul_rn(a.lr, upd));
}

// p's new value in its own dtype: new_p, or p + delta with the delta
// rounded to p's dtype first (FusedAdam's update, optax.apply_updates)
template <typename TP>
__device__ __forceinline__ TP adam_write(const AdamArgs& a, float p,
                                         float new_p) {
  if (!a.apply_delta) return from_f<TP>(new_p);
  const float delta = to_f(from_f<TP>(__fsub_rn(new_p, p)));
  return from_f<TP>(__fadd_rn(p, delta));
}

// lists: 0 grads (TG), 1 params (TP, updated in place), 2 exp_avg and
// 3 exp_avg_sq (fp32, in place)
template <typename TG, typename TP>
struct AdamFunctor {
  static constexpr int kDepth = 4;
  AdamArgs a;

  __device__ __forceinline__ void operator()(
      int chunk, int64_t n, const TensorListMetadata<4>& tl, int t) const {
    const int64_t base = static_cast<int64_t>(chunk) * kChunk;
    const TG* gp = static_cast<const TG*>(tl.addresses[0][t]) + base;
    TP* pp = static_cast<TP*>(tl.addresses[1][t]) + base;
    float* mp = static_cast<float*>(tl.addresses[2][t]) + base;
    float* vp = static_cast<float*>(tl.addresses[3][t]) + base;
    n -= base;
    const int64_t len = n < kChunk ? n : kChunk;
    if (len % kILP == 0 && aligned<TG>(gp) && aligned<TP>(pp) &&
        aligned<float>(mp) && aligned<float>(vp)) {
      for (int64_t i = threadIdx.x; i * kILP < len; i += blockDim.x) {
        float g[kILP], p[kILP], m[kILP], v[kILP];
        load_ilp(g, gp, i);
        load_ilp(p, pp, i);
        load_ilp(m, mp, i);
        load_ilp(v, vp, i);
        TP out[kILP];
#pragma unroll
        for (int k = 0; k < kILP; ++k) {
          float np;
          adam_elem(a, g[k], p[k], m[k], v[k], np);
          out[k] = adam_write<TP>(a, p[k], np);
          p[k] = to_f(out[k]);
        }
        store_ilp(pp, i, p);
        store_ilp(mp, i, m);
        store_ilp(vp, i, v);
      }
    } else {
      for (int64_t i = threadIdx.x; i < len; i += blockDim.x) {
        float p = to_f(pp[i]), m = mp[i], v = vp[i], np;
        adam_elem(a, to_f(gp[i]), p, m, v, np);
        pp[i] = adam_write<TP>(a, p, np);
        mp[i] = m;
        vp[i] = v;
      }
    }
  }
};

template <typename F>
__global__ void __launch_bounds__(kThreads)
multi_tensor_kernel(const __grid_constant__ TensorListMetadata<F::kDepth> tl,
                    const F f) {
  const int t = tl.block_to_tensor[blockIdx.x];
  f(tl.block_to_chunk[blockIdx.x], tl.sizes[t], tl, t);
}

// ---------------------------------------------------------------- the host
// apex's multi_tensor_apply: walk the tensors chunk by chunk, launching
// whenever the table's tensors or blocks are full or the walk ends. Returns
// cudaGetLastError() of the first failing launch (0 when none), the count
// of launches in *n_launches.
template <typename F>
int multi_tensor_apply(int n, void* const* const* lists,
                       const int64_t* sizes, const F& f, cudaStream_t stream,
                       int* n_launches) {
  constexpr int D = F::kDepth;
  TensorListMetadata<D> tl;
  int loc_tensor = 0, loc_block = 0;
  *n_launches = 0;
  int last_t = n - 1;                    // the last tensor with elements
  while (last_t >= 0 && sizes[last_t] == 0) --last_t;
  for (int t = 0; t <= last_t; ++t) {
    if (sizes[t] == 0) continue;
    tl.sizes[loc_tensor] = sizes[t];
    for (int d = 0; d < D; ++d) tl.addresses[d][loc_tensor] = lists[d][t];
    ++loc_tensor;
    const int64_t chunks = (sizes[t] + kChunk - 1) / kChunk;
    for (int64_t c = 0; c < chunks; ++c) {
      tl.block_to_tensor[loc_block] = static_cast<uint8_t>(loc_tensor - 1);
      tl.block_to_chunk[loc_block] = static_cast<int>(c);
      ++loc_block;
      const bool last_chunk = c == chunks - 1;
      const bool last = last_chunk && t == last_t;
      const bool tensors_full = loc_tensor == kMaxTensors && last_chunk;
      const bool blocks_full = loc_block == kMaxBlocks;
      if (tensors_full || blocks_full || last) {
        multi_tensor_kernel<F><<<loc_block, kThreads, 0, stream>>>(tl, f);
        ++*n_launches;
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
        loc_block = 0;
        if (last_chunk) {
          loc_tensor = 0;
        } else {                     // the tensor resumes in the next table
          tl.sizes[0] = tl.sizes[loc_tensor - 1];
          for (int d = 0; d < D; ++d)
            tl.addresses[d][0] = tl.addresses[d][loc_tensor - 1];
          loc_tensor = 1;
        }
      }
    }
  }
  return 0;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.
//
// out[i] = in[i] * scale (in_dtype -> out_dtype: fp32 -> fp32, bf16 -> fp32
// for amp's unscale, bf16 -> bf16) over n tensors of sizes[i]
// elements; *found_inf (a device int) is set to 1 when any input is inf or
// NaN, and never cleared here. Returns 0 or a cudaError_t, -1 for dtypes it
// does not take; *n_launches counts the kernels launched.
extern "C" int apex_mt_scale(int n, void* const* in, void* const* out,
                             const int64_t* sizes, int in_dtype,
                             int out_dtype, float scale, int* found_inf,
                             cudaStream_t stream, int* n_launches) {
  void* const* lists[2] = {in, out};
  *n_launches = 0;
  if (n < 0) return -1;
  if (in_dtype == 0 && out_dtype == 0)
    return multi_tensor_apply(n, lists, sizes,
                              ScaleFunctor<float, float>{scale, found_inf},
                              stream, n_launches);
  if (in_dtype == 1 && out_dtype == 0)
    return multi_tensor_apply(
        n, lists, sizes, ScaleFunctor<__nv_bfloat16, float>{scale, found_inf},
        stream, n_launches);
  if (in_dtype == 1 && out_dtype == 1)
    return multi_tensor_apply(
        n, lists, sizes,
        ScaleFunctor<__nv_bfloat16, __nv_bfloat16>{scale, found_inf}, stream,
        n_launches);
  return -1;
}

// One Adam / AdamW step over n tensors: grads g and params p (in place),
// both fp32 or both bf16 (a parameter's grad has its dtype), exp_avg m and
// exp_avg_sq v (fp32, in place). The
// scalars are fp32 values from the caller: bias corrections bc1 = 1 -
// beta1^step and bc2 (1 without bias correction), one_minus_beta* = fp32(1 -
// beta*). adam_w: decoupled decay; apply_delta: p += p_dtype(new_p - p)
// instead of p = new_p.
extern "C" int apex_mt_adam(int n, void* const* g, void* const* p,
                            void* const* m, void* const* v,
                            const int64_t* sizes, int g_dtype, int p_dtype,
                            float lr, float beta1, float beta2,
                            float one_minus_beta1, float one_minus_beta2,
                            float eps, float wd, float bc1, float bc2,
                            float inv_scale, int adam_w, int apply_delta,
                            cudaStream_t stream, int* n_launches) {
  void* const* lists[4] = {g, p, m, v};
  const AdamArgs a{lr, beta1, beta2, one_minus_beta1, one_minus_beta2, eps,
                   wd, bc1, bc2, inv_scale, adam_w, apply_delta};
  *n_launches = 0;
  if (n < 0) return -1;
  if (g_dtype == 0 && p_dtype == 0)
    return multi_tensor_apply(n, lists, sizes, AdamFunctor<float, float>{a},
                              stream, n_launches);
  if (g_dtype == 1 && p_dtype == 1)
    return multi_tensor_apply(n, lists, sizes,
                              AdamFunctor<__nv_bfloat16, __nv_bfloat16>{a},
                              stream, n_launches);
  return -1;
}
