// Paged-attention decode for Hopper (sm_90a): one new token per slot,
// attended against that slot's pages of the paged KV pool.
//
// Replaces the TPU kernel accelerate_tpu/ops/paged_attention.py
// ::_paged_decode_kernel (launched by _paged_attention_call). Semantics
// are the reference's, kept exactly:
//   - the page table [S, P] and lengths [S] are data; a block walks only
//     the slot's live pages (j * ps < length);
//   - the GQA group is broadcast in-kernel: q is [S, Hkv, G, D] and K/V
//     rows are never repeated;
//   - int8 pools are dequantized in f32 as code * per-row-per-head scale;
//   - a sliding window keeps pos > length - window (window <= 0: none);
//   - the new token's K/V (already cast to the pool's row dtype by the
//     wrapper) folds in last as a single-key online-softmax update;
//   - masked probabilities are zeroed and l is clamped at 1e-30;
//   - the pool is never written.
//
// What bounds it: decode attention reads every live page once and does
// ~4 flops per byte read, so the floor is the bytes of the live pages
// (K and V, plus scales for int8) over device-memory bandwidth. This
// first design is simple and right, not fast:
//   - one block per (slot, kv head); the grid S x Hkv underfills the 132
//     SMs at small S (64 blocks at S=8, Hkv=8). Splitting each slot's
//     pages across blocks with a second combine pass (split-K /
//     flash-decoding) would fill the card;
//   - pages are staged through shared memory with plain loads, one page
//     at a time; there is no cp.async/TMA prefetch of the next page, so
//     every page pays a full memory latency.
//
// The C entry point takes raw pointers and the CUDA stream, launches on
// that stream, never synchronises, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxGroup = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Grid (S, Hkv); block D threads (D a multiple of 32): thread d owns
// output column d of all G query heads of its (slot, kv head).
template <typename QT, typename PT, typename RT, bool kQuant>
__global__ void paged_decode_kernel(
    const QT* __restrict__ q,          // [S, Hkv, G, D]
    const RT* __restrict__ k_row,      // [S, Hkv, D]
    const RT* __restrict__ v_row,      // [S, Hkv, D]
    const PT* __restrict__ pool_k,     // [N+1, ps, Hkv, D]
    const PT* __restrict__ pool_v,     // [N+1, ps, Hkv, D]
    const __nv_bfloat16* __restrict__ k_scales,  // [N+1, ps, Hkv] (int8)
    const __nv_bfloat16* __restrict__ v_scales,  // [N+1, ps, Hkv] (int8)
    const int* __restrict__ table,     // [S, P]
    const int* __restrict__ lengths,   // [S]
    QT* __restrict__ out,              // [S, Hkv, G, D]
    int Hkv, int G, int D, int P, int ps, int window, float sm_scale) {
  extern __shared__ float smem[];
  float* q_s = smem;            // [G, D]
  float* k_s = q_s + G * D;     // [ps, D] this page's keys, f32
  float* v_s = k_s + ps * D;    // [ps, D] this page's values, f32
  float* p_s = v_s + ps * D;    // [G, ps] scores, then probabilities
  float* m_s = p_s + G * ps;    // [G] running max
  float* l_s = m_s + G;         // [G] running denominator
  float* a_s = l_s + G;         // [G] rescale factor of the last update

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int d = threadIdx.x;
  const int lane = d & 31;
  const int warp = d >> 5;
  const int nwarps = blockDim.x >> 5;
  const int length = lengths[s];
  const size_t row_stride = (size_t)Hkv * D;
  const size_t page_stride = (size_t)ps * row_stride;
  const size_t qbase = ((size_t)s * Hkv + h) * G * D;
  const size_t rbase = ((size_t)s * Hkv + h) * D;

  for (int i = d; i < G * D; i += blockDim.x) q_s[i] = to_f32(q[qbase + i]);
  if (d < G) {
    m_s[d] = kNegInf;
    l_s[d] = 0.f;
  }
  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;
  __syncthreads();

  int n_live = (max(length, 0) + ps - 1) / ps;
  if (n_live > P) n_live = P;
  for (int j = 0; j < n_live; ++j) {
    const size_t page = (size_t)table[s * P + j];
    const PT* kp = pool_k + page * page_stride + (size_t)h * D;
    const PT* vp = pool_v + page * page_stride + (size_t)h * D;
    for (int r = 0; r < ps; ++r) {
      float kv = to_f32(kp[r * row_stride + d]);
      float vv = to_f32(vp[r * row_stride + d]);
      if (kQuant) {
        const size_t si = (page * ps + r) * Hkv + h;
        kv *= __bfloat162float(k_scales[si]);
        vv *= __bfloat162float(v_scales[si]);
      }
      k_s[r * D + d] = kv;
      v_s[r * D + d] = vv;
    }
    __syncthreads();

    // masked, scaled scores: one warp per (query head, row) pair
    for (int pr = warp; pr < G * ps; pr += nwarps) {
      const int g = pr / ps;
      const int r = pr - g * ps;
      float dot = 0.f;
      for (int c = lane; c < D; c += 32) dot += q_s[g * D + c] * k_s[r * D + c];
      dot = warp_sum(dot);
      if (lane == 0) {
        const int pos = j * ps + r;
        const bool keep =
            pos < length && (window <= 0 || pos > length - window);
        p_s[pr] = keep ? dot * sm_scale : kNegInf;
      }
    }
    __syncthreads();

    // online-softmax update: one warp per query head
    for (int g = warp; g < G; g += nwarps) {
      float bmax = kNegInf;
      for (int r = lane; r < ps; r += 32) bmax = fmaxf(bmax, p_s[g * ps + r]);
      bmax = warp_max(bmax);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, bmax);
      float sum = 0.f;
      for (int r = lane; r < ps; r += 32) {
        const float sc = p_s[g * ps + r];
        // a fully masked page keeps m_new at kNegInf, where exp(s - m)
        // would be 1 per masked key: zero those explicitly
        const float p = sc <= kNegInf * 0.5f ? 0.f : expf(sc - m_new);
        p_s[g * ps + r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < G) {
        float pv = 0.f;
        for (int r = 0; r < ps; ++r) pv += p_s[g * ps + r] * v_s[r * D + d];
        acc[g] = acc[g] * a_s[g] + pv;
      }
    }
    __syncthreads();  // the next page overwrites k_s, v_s and p_s
  }

  // the new token's K/V at position == length: always visible (window
  // distance 0), folded as one more single-key update
  for (int g = warp; g < G; g += nwarps) {
    float dot = 0.f;
    for (int c = lane; c < D; c += 32)
      dot += q_s[g * D + c] * to_f32(k_row[rbase + c]);
    dot = warp_sum(dot);
    if (lane == 0) {
      const float sc = dot * sm_scale;
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, sc);
      const float p = sc <= kNegInf * 0.5f ? 0.f : expf(sc - m_new);
      const float alpha = expf(m_prev - m_new);
      p_s[g] = p;
      a_s[g] = alpha;
      l_s[g] = l_s[g] * alpha + p;
      m_s[g] = m_new;
    }
  }
  __syncthreads();
  const float vn = to_f32(v_row[rbase + d]);
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < G) {
      const float o = (acc[g] * a_s[g] + p_s[g] * vn) / fmaxf(l_s[g], 1e-30f);
      out[qbase + (size_t)g * D + d] = from_f32<QT>(o);
    }
  }
}

template <typename QT, typename PT, typename RT, bool kQuant>
int launch(const void* q, const void* k_row, const void* v_row,
           const void* pool_k, const void* pool_v, const void* k_scales,
           const void* v_scales, const int* table, const int* lengths,
           void* out, int S, int Hkv, int G, int D, int P, int ps,
           int window, float sm_scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)G * D + 2 * (size_t)ps * D +
                                       (size_t)G * ps + 3 * (size_t)G);
  paged_decode_kernel<QT, PT, RT, kQuant>
      <<<dim3(S, Hkv), dim3(D), smem, stream>>>(
          static_cast<const QT*>(q), static_cast<const RT*>(k_row),
          static_cast<const RT*>(v_row), static_cast<const PT*>(pool_k),
          static_cast<const PT*>(pool_v),
          static_cast<const __nv_bfloat16*>(k_scales),
          static_cast<const __nv_bfloat16*>(v_scales), table, lengths,
          static_cast<QT*>(out), Hkv, G, D, P, ps, window, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename RT>
int dispatch_pool(int pool_dtype, const void* q, const void* k_row,
                  const void* v_row, const void* pool_k, const void* pool_v,
                  const void* k_scales, const void* v_scales,
                  const int* table, const int* lengths, void* out, int S,
                  int Hkv, int G, int D, int P, int ps, int window,
                  float sm_scale, cudaStream_t stream) {
  switch (pool_dtype) {
    case 0:
      return launch<QT, float, RT, false>(q, k_row, v_row, pool_k, pool_v,
                                          k_scales, v_scales, table, lengths,
                                          out, S, Hkv, G, D, P, ps, window,
                                          sm_scale, stream);
    case 1:
      return launch<QT, __nv_bfloat16, RT, false>(
          q, k_row, v_row, pool_k, pool_v, k_scales, v_scales, table,
          lengths, out, S, Hkv, G, D, P, ps, window, sm_scale, stream);
    case 2:
      return launch<QT, int8_t, RT, true>(q, k_row, v_row, pool_k, pool_v,
                                          k_scales, v_scales, table, lengths,
                                          out, S, Hkv, G, D, P, ps, window,
                                          sm_scale, stream);
  }
  return -1;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pool only).
// Returns cudaGetLastError() after the launch, or -1 for a dtype code the
// kernel is not built for.
extern "C" int paged_decode(int q_dtype, int pool_dtype, int row_dtype,
                            const void* q, const void* k_row,
                            const void* v_row, const void* pool_k,
                            const void* pool_v, const void* k_scales,
                            const void* v_scales, const int* table,
                            const int* lengths, void* out, int S, int Hkv,
                            int G, int D, int P, int ps, int window,
                            float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > kMaxGroup || D < 32 || D % 32 != 0 || D > 1024) return -1;
  if (q_dtype == 0 && row_dtype == 0)
    return dispatch_pool<float, float>(pool_dtype, q, k_row, v_row, pool_k,
                                       pool_v, k_scales, v_scales, table,
                                       lengths, out, S, Hkv, G, D, P, ps,
                                       window, sm_scale, st);
  if (q_dtype == 0 && row_dtype == 1)
    return dispatch_pool<float, __nv_bfloat16>(
        pool_dtype, q, k_row, v_row, pool_k, pool_v, k_scales, v_scales,
        table, lengths, out, S, Hkv, G, D, P, ps, window, sm_scale, st);
  if (q_dtype == 1 && row_dtype == 0)
    return dispatch_pool<__nv_bfloat16, float>(
        pool_dtype, q, k_row, v_row, pool_k, pool_v, k_scales, v_scales,
        table, lengths, out, S, Hkv, G, D, P, ps, window, sm_scale, st);
  if (q_dtype == 1 && row_dtype == 1)
    return dispatch_pool<__nv_bfloat16, __nv_bfloat16>(
        pool_dtype, q, k_row, v_row, pool_k, pool_v, k_scales, v_scales,
        table, lengths, out, S, Hkv, G, D, P, ps, window, sm_scale, st);
  return -1;
}
