// Paged-attention decode for Hopper (sm_90a): one new token per slot,
// attended against that slot's pages of the paged KV pool.
//
// Replaces the TPU kernel accelerate_tpu/ops/paged_attention.py
// ::_paged_decode_kernel (launched by _paged_attention_call). Semantics
// are the reference's, kept exactly:
//   - the page table [S, P] and lengths [S] are data; only the slot's live
//     pages (j * ps < length) are read;
//   - the GQA group is broadcast in-kernel: q is [S, Hkv, G, D] and K/V
//     rows are never repeated;
//   - int8 pools are dequantized in f32 as code * per-row-per-head scale;
//   - a sliding window keeps pos > length - window (window <= 0: none);
//   - scores, probabilities and P.V stay in f32;
//   - the new token's K/V (already cast to the pool's row dtype by the
//     wrapper) folds in last as a single-key online-softmax update;
//   - masked probabilities are zeroed and l is clamped at 1e-30;
//   - the pool is never written.
//
// What bounds it: decode attention reads every live page once and does
// about 4 flops per byte read, so the floor is the bytes of the live pages
// (K and V, plus scales for int8) over device-memory bandwidth. The design
// keeps the memory system busy (flash-decoding):
//   - each slot's pages are split across blocks: the grid is (split, kv
//     head, slot) and a split owns a fixed run of pages of about 128 rows,
//     so a few slots already give hundreds of blocks. A split past the
//     slot's live rows, or wholly before its window, records an empty
//     partial (m = -1e30, l = 0) and exits;
//   - inside a split, pages stream through a ring of shared-memory
//     buffers filled by cp.async with 16-byte copies (neighbouring threads
//     on neighbouring addresses), up to three pages ahead of the one being
//     scored, with one barrier per page. The split scores its K pages,
//     takes its softmax statistics once, then streams its V pages through
//     the same ring; its partial (m, l and the unnormalised P.V row) goes
//     to f32 scratch;
//   - a split block is latency-bound, so it keeps instructions few and
//     independent: the GQA group width is built in (4, 8 or 16), a row's
//     group dots are summed across the warp by one transposing butterfly,
//     256 threads share the rows of P.V, and the split's page ids are
//     read into shared memory once;
//   - a second kernel combines the splits of each (slot, kv head) in split
//     order, with no atomics (the result is deterministic), skips empty
//     splits, and folds the new token last.
// The number of splits follows from the page table's width and the page
// size, both known on the host, so a launch never reads device data on
// the host.
//
// The C entry point takes raw pointers and the CUDA stream, launches both
// kernels on that stream, never synchronises, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxGroup = 16;
constexpr int kMaxSmem = 232448;  // a block's shared memory on an H100

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

__device__ __forceinline__ void cp_async_wait_stages(int stages) {
  // wait until the page about to be used has landed, leaving the
  // stages - 2 pages issued after it in flight
  switch (stages) {
    case 2: hopper::cp_async_wait<0>(); break;
    case 3: hopper::cp_async_wait<1>(); break;
    default: hopper::cp_async_wait<2>(); break;
  }
}

struct SplitArgs {
  int Hkv, G, D, P, ps, pps, nsplit, stages, window;
  float sm_scale;
};

// Threads of a split block: 256 (8 warps), or one per column when the head
// dim is wider.
int split_threads(int D) { return D > 256 ? D : 256; }

// Bytes of shared memory of a split block: the page ring, q in f32 (kG
// query heads, zero past G), the split's scores/probabilities, m and l per
// query head, the split's page ids, and the P.V sums of all but one row
// group of threads.
size_t split_smem(int stages, int ps, int D, int elt, int kG, int pps) {
  const int groups = split_threads(D) / D;
  return (size_t)stages * ps * D * elt +
         sizeof(float) * ((size_t)kG * D + (size_t)kG * pps * ps +
                          2 * (size_t)kG + pps +
                          (size_t)(groups - 1) * kG * D);
}

template <int kG>
__host__ __device__ constexpr int log2_of() {
  return kG == 1 ? 0 : 1 + log2_of<kG / 2>();
}

// Sums kG partial values per lane across the warp with kG - 1 + 5 -
// log2(kG) shuffles (a transposing butterfly): afterwards lane l holds the
// full sum of value ((l >> (5 - log2 kG)) & (kG - 1)) in v[0].
template <int kG>
__device__ __forceinline__ void warp_sum_transpose(float (&v)[kG], int lane) {
  constexpr int kLevels = log2_of<kG>();
#pragma unroll
  for (int lvl = 0; lvl < kLevels; ++lvl) {
    const int o = 16 >> lvl, w = kG >> (lvl + 1);
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < kG / 2; ++i) {
      if (i < w) {
        const float send = upper ? v[i] : v[i + w];
        const float keep = upper ? v[i + w] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    }
  }
#pragma unroll
  for (int o = 16 >> kLevels; o >= 1; o >>= 1)
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
}

// Grid (nsplit, Hkv, S); blockDim split_threads(D) <= kThreads. Split `sp`
// of slot s owns pages [sp * pps, (sp + 1) * pps) of the slot's table row.
// kG is G rounded up to 4, 8 or 16: the group loops unroll whole, and q's
// padded heads are zeros whose results are never written.
template <typename QT, typename PT, bool kQuant, int kG, int kThreads>
__global__ void __launch_bounds__(kThreads, 1)
    paged_decode_split_kernel(const QT* __restrict__ q,        // [S,Hkv,G,D]
                              const PT* __restrict__ pool_k,   // [N+1,ps,Hkv,D]
                              const PT* __restrict__ pool_v,
                              const __nv_bfloat16* __restrict__ k_scales,
                              const __nv_bfloat16* __restrict__ v_scales,
                              const int* __restrict__ table,    // [S, P]
                              const int* __restrict__ lengths,  // [S]
                              float* __restrict__ part_m,  // [S,Hkv,nsplit,G]
                              float* __restrict__ part_l,
                              float* __restrict__ part_acc,  // [..., G, D]
                              SplitArgs a) {
  const int Hkv = a.Hkv, G = a.G, D = a.D, ps = a.ps;
  const int R = a.pps * ps;  // rows of a split
  const int sp = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t pidx = (((size_t)s * Hkv + h) * a.nsplit + sp) * G;

  // the split's visible pool rows: [first, end)
  const int length = lengths[s];
  const int lo = a.window > 0 ? max(0, length - a.window + 1) : 0;
  const int live_end = min(length, a.P * ps);
  const int r0 = sp * R;
  const int first = max(r0, lo), end = min(r0 + R, live_end);
  if (first >= end) {
    if (tid < G) {
      part_m[pidx + tid] = kNegInf;
      part_l[pidx + tid] = 0.f;
    }
    return;
  }
  const int pb = first / ps, npg = (end + ps - 1) / ps - pb;

  extern __shared__ __align__(16) char smem_raw[];
  const size_t row_bytes = (size_t)D * sizeof(PT);
  const size_t stage_bytes = (size_t)ps * row_bytes;
  char* ring = smem_raw;
  float* q_s = reinterpret_cast<float*>(ring + a.stages * stage_bytes);
  float* p_s = q_s + kG * D;  // [kG, R]: scores, then probabilities
  float* m_s = p_s + kG * R;
  float* l_s = m_s + kG;
  int* pid_s = reinterpret_cast<int*>(l_s + kG);  // the split's page ids
  float* red_s = reinterpret_cast<float*>(pid_s + a.pps);  // [groups-1,kG,D]

  // the page ids, read once: the ring's copies never wait on the table
  for (int i = tid; i < npg; i += blockDim.x)
    pid_s[i] = table[(size_t)s * a.P + pb + i];
  const size_t qbase = ((size_t)s * Hkv + h) * G * D;
  for (int i = tid; i < kG * D; i += blockDim.x)
    q_s[i] = i < G * D ? to_f32(q[qbase + i]) : 0.f;
  __syncthreads();

  // page load t: the K pages of the split, then its V pages
  const size_t hd = (size_t)Hkv * D;
  const int chunks = static_cast<int>(row_bytes / 16);
  auto issue = [&](int t) {
    if (t < 2 * npg) {
      const bool is_v = t >= npg;
      const size_t page = (size_t)pid_s[is_v ? t - npg : t];
      const char* src = reinterpret_cast<const char*>(
          (is_v ? pool_v : pool_k) + page * ps * hd + (size_t)h * D);
      char* dst = ring + (t % a.stages) * stage_bytes;
      for (int i = tid; i < ps * chunks; i += blockDim.x) {
        const int r = i / chunks, c = i - r * chunks;
        hopper::cp_async16(dst + r * row_bytes + c * 16,
                           src + r * hd * sizeof(PT) + c * 16);
      }
    }
    hopper::cp_async_commit();  // empty groups keep the count uniform
  };
  for (int t = 0; t < a.stages - 1; ++t) issue(t);

  // P.V: thread (group, d) owns column d over the rows r = group (mod
  // groups) of each page
  const int groups = blockDim.x / D;
  const int col = tid % D, grp = tid / D;
  constexpr int kShift = 5 - log2_of<kG>();
  float acc[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) acc[g] = 0.f;

  for (int t = 0; t < 2 * npg; ++t) {
    cp_async_wait_stages(a.stages);
    // one barrier a page: past it the page has landed for every thread,
    // and the stage read last iteration is free for the next copies
    __syncthreads();
    issue(t + a.stages - 1);
    const PT* pg = reinterpret_cast<const PT*>(ring + (t % a.stages) *
                                               stage_bytes);
    const int lj = t < npg ? t : t - npg;  // page within the split's run
    const size_t page = (size_t)pid_s[lj];
    if (t < npg) {
      // masked, scaled scores: one warp per row, lanes across D, the kG
      // dots summed across the warp together
      for (int r = warp; r < ps; r += nwarps) {
        const float ks =
            kQuant ? __bfloat162float(k_scales[(page * ps + r) * Hkv + h])
                   : 1.f;
        float dot[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) dot[g] = 0.f;
        for (int d = lane; d < D; d += 32) {
          float kv = to_f32(pg[r * D + d]);
          if (kQuant) kv *= ks;
#pragma unroll
          for (int g = 0; g < kG; ++g) dot[g] = fmaf(q_s[g * D + d], kv, dot[g]);
        }
        warp_sum_transpose<kG>(dot, lane);
        const int pos = (pb + lj) * ps + r;
        const bool keep = pos >= first && pos < end;
        if ((lane & ((1 << kShift) - 1)) == 0)
          p_s[((lane >> kShift) & (kG - 1)) * R + lj * ps + r] =
              keep ? dot[0] * a.sm_scale : kNegInf;
      }
    } else if (grp < groups) {
#pragma unroll 4
      for (int r = grp; r < ps; r += groups) {
        float vv = to_f32(pg[r * D + col]);
        if (kQuant)
          vv *= __bfloat162float(v_scales[(page * ps + r) * Hkv + h]);
#pragma unroll
        for (int g = 0; g < kG; ++g)
          acc[g] = fmaf(p_s[g * R + lj * ps + r], vv, acc[g]);
      }
    }
    if (t == npg - 1) {
      // every score is in: the split's softmax statistics, one warp per
      // query head; the split has a visible row, so m is finite, l >= 1
      __syncthreads();
      const int rows = npg * ps;
      for (int g = warp; g < G; g += nwarps) {
        float mx = kNegInf;
        for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, p_s[g * R + r]);
        mx = warp_max(mx);
        float sum = 0.f;
        for (int r = lane; r < rows; r += 32) {
          const float sc = p_s[g * R + r];
          const float p = sc <= kNegInf * 0.5f ? 0.f : expf(sc - mx);
          p_s[g * R + r] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          m_s[g] = mx;
          l_s[g] = sum;
        }
      }
      __syncthreads();
    }
  }
  hopper::cp_async_wait<0>();  // trailing empty groups

  // the row groups' sums, added in group order
  if (grp > 0 && grp < groups) {
#pragma unroll
    for (int g = 0; g < kG; ++g) red_s[((grp - 1) * kG + g) * D + col] = acc[g];
  }
  __syncthreads();
  if (grp == 0) {
    for (int j = 1; j < groups; ++j) {
#pragma unroll
      for (int g = 0; g < kG; ++g) acc[g] += red_s[((j - 1) * kG + g) * D + col];
    }
#pragma unroll
    for (int g = 0; g < kG; ++g)
      if (g < G) part_acc[(pidx + g) * D + col] = acc[g];
  }
  if (tid < G) {
    part_m[pidx + tid] = m_s[tid];
    part_l[pidx + tid] = l_s[tid];
  }
}

// Grid (Hkv, S); blockDim D. Merges the splits of one (slot, kv head) in
// split order and folds the new token's K/V last: one warp per query head
// turns the splits' (m, l) and the new token's score into normalised
// weights in shared memory, then thread d sums column d.
template <typename QT, typename RT>
__global__ void __launch_bounds__(1024)
    paged_decode_combine_kernel(const QT* __restrict__ q,
                                const RT* __restrict__ k_row,  // [S,Hkv,D]
                                const RT* __restrict__ v_row,
                                const float* __restrict__ part_m,
                                const float* __restrict__ part_l,
                                const float* __restrict__ part_acc,
                                QT* __restrict__ out,  // [S,Hkv,G,D]
                                int Hkv, int G, int D, int nsplit,
                                float sm_scale) {
  __shared__ float pn_s[kMaxGroup];    // the new token's weight
  extern __shared__ float w_s[];        // [G, nsplit] the splits' weights
  const int h = blockIdx.x, s = blockIdx.y, d = threadIdx.x;
  const int lane = d & 31, warp = d >> 5, nwarps = blockDim.x >> 5;
  const size_t qbase = ((size_t)s * Hkv + h) * G * D;
  const size_t rbase = ((size_t)s * Hkv + h) * D;
  const size_t base = ((size_t)s * Hkv + h) * nsplit;

  for (int g = warp; g < G; g += nwarps) {
    // the new token at position == length: always visible (window
    // distance 0)
    float sc = 0.f;
    for (int c = lane; c < D; c += 32)
      sc += to_f32(q[qbase + (size_t)g * D + c]) * to_f32(k_row[rbase + c]);
    sc = warp_sum(sc) * sm_scale;
    float m = kNegInf;
    for (int sp = lane; sp < nsplit; sp += 32) {
      const size_t i = (base + sp) * G + g;
      if (part_l[i] > 0.f) m = fmaxf(m, part_m[i]);
    }
    m = warp_max(m);
    // the splits first, then the new token as one more online update
    float l = 0.f;
    for (int sp = lane; sp < nsplit; sp += 32) {
      const size_t i = (base + sp) * G + g;
      const float ls = part_l[i];
      // an empty split (l == 0) gets weight 0: its acc was never written
      const float w = ls > 0.f ? expf(part_m[i] - m) : 0.f;
      w_s[g * nsplit + sp] = w;
      l += ls * w;
    }
    l = warp_sum(l);
    const float m_new = fmaxf(m, sc);
    const float alpha = expf(m - m_new);
    const float p = expf(sc - m_new);
    const float inv = 1.f / fmaxf(l * alpha + p, 1e-30f);
    for (int sp = lane; sp < nsplit; sp += 32)
      w_s[g * nsplit + sp] *= alpha * inv;
    if (lane == 0) pn_s[g] = p * inv;
  }
  __syncthreads();
  const float vn = to_f32(v_row[rbase + d]);
  for (int g = 0; g < G; ++g) {
    float o = pn_s[g] * vn;
    const float* src = part_acc + (base * G + g) * D + d;
    // loads independent of the weights, so they fly together; an empty
    // split's unwritten values are selected away, never multiplied
#pragma unroll 8
    for (int sp = 0; sp < nsplit; ++sp) {
      const float w = w_s[g * nsplit + sp];
      const float x = src[(size_t)sp * G * D];
      o = w != 0.f ? fmaf(w, x, o) : o;
    }
    out[qbase + (size_t)g * D + d] = from_f32<QT>(o);
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  // above 48 KB a block's dynamic shared memory must be opted into
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <typename QT, typename PT, bool kQuant, int kG>
int launch_split(const void* q, const void* pool_k, const void* pool_v,
                 const void* k_scales, const void* v_scales, const int* table,
                 const int* lengths, float* part_m, float* part_l,
                 float* part_acc, int S, SplitArgs a, cudaStream_t stream) {
  // the deepest ring (up to 4 pages) that fits
  a.stages = 4;
  while (a.stages > 2 && split_smem(a.stages, a.ps, a.D, sizeof(PT), kG,
                                    a.pps) > kMaxSmem)
    --a.stages;
  const size_t smem = split_smem(a.stages, a.ps, a.D, sizeof(PT), kG, a.pps);
  if (smem > kMaxSmem) return -1;
  // up to 256 threads a block may hold 255 registers a thread; head dims
  // over 256 take a thread a column and the 16-wide group
  auto split = paged_decode_split_kernel<QT, PT, kQuant, kG, 256>;
  if constexpr (kG == 16) {
    if (a.D > 256) split = paged_decode_split_kernel<QT, PT, kQuant, 16, 1024>;
  }
  if (int e = set_smem(split, smem)) return e;
  split<<<dim3(a.nsplit, a.Hkv, S), dim3(split_threads(a.D)), smem,
          stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(pool_k),
      static_cast<const PT*>(pool_v),
      static_cast<const __nv_bfloat16*>(k_scales),
      static_cast<const __nv_bfloat16*>(v_scales), table, lengths, part_m,
      part_l, part_acc, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename PT, typename RT, bool kQuant>
int launch(const void* q, const void* k_row, const void* v_row,
           const void* pool_k, const void* pool_v, const void* k_scales,
           const void* v_scales, const int* table, const int* lengths,
           float* part_m, float* part_l, float* part_acc, void* out, int S,
           SplitArgs a, cudaStream_t stream) {
  // the group width the split kernel is built for: G rounded up to 4, 8
  // or 16 (16 for head dims over 256)
  const int kg = a.D > 256 ? 16 : a.G <= 4 ? 4 : a.G <= 8 ? 8 : 16;
  int e = kg == 4 ? launch_split<QT, PT, kQuant, 4>(
                        q, pool_k, pool_v, k_scales, v_scales, table,
                        lengths, part_m, part_l, part_acc, S, a, stream)
          : kg == 8 ? launch_split<QT, PT, kQuant, 8>(
                          q, pool_k, pool_v, k_scales, v_scales, table,
                          lengths, part_m, part_l, part_acc, S, a, stream)
                    : launch_split<QT, PT, kQuant, 16>(
                          q, pool_k, pool_v, k_scales, v_scales, table,
                          lengths, part_m, part_l, part_acc, S, a, stream);
  if (e) return e;
  const size_t combine_smem = sizeof(float) * a.G * a.nsplit;
  if (combine_smem > kMaxSmem) return -1;
  auto combine = paged_decode_combine_kernel<QT, RT>;
  if ((e = set_smem(combine, combine_smem))) return e;
  combine<<<dim3(a.Hkv, S), dim3(a.D), combine_smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const RT*>(k_row),
      static_cast<const RT*>(v_row), part_m, part_l, part_acc,
      static_cast<QT*>(out), a.Hkv, a.G, a.D, a.nsplit, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename RT>
int dispatch_pool(int pool_dtype, const void* q, const void* k_row,
                  const void* v_row, const void* pool_k, const void* pool_v,
                  const void* k_scales, const void* v_scales,
                  const int* table, const int* lengths, float* part_m,
                  float* part_l, float* part_acc, void* out, int S,
                  SplitArgs a, cudaStream_t stream) {
  switch (pool_dtype) {
    case 0:
      return launch<QT, float, RT, false>(
          q, k_row, v_row, pool_k, pool_v, k_scales, v_scales, table,
          lengths, part_m, part_l, part_acc, out, S, a, stream);
    case 1:
      return launch<QT, __nv_bfloat16, RT, false>(
          q, k_row, v_row, pool_k, pool_v, k_scales, v_scales, table,
          lengths, part_m, part_l, part_acc, out, S, a, stream);
    case 2:
      return launch<QT, int8_t, RT, true>(
          q, k_row, v_row, pool_k, pool_v, k_scales, v_scales, table,
          lengths, part_m, part_l, part_acc, out, S, a, stream);
  }
  return -1;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pool only).
// part_m and part_l are [S, Hkv, nsplit, G] f32 and part_acc
// [S, Hkv, nsplit, G, D] f32 scratch; split i owns table columns
// [i * pps, (i + 1) * pps), so nsplit * pps must cover P. Returns
// cudaGetLastError() after the launches, or -1 for arguments the kernels
// are not built for.
extern "C" int paged_decode(int q_dtype, int pool_dtype, int row_dtype,
                            const void* q, const void* k_row,
                            const void* v_row, const void* pool_k,
                            const void* pool_v, const void* k_scales,
                            const void* v_scales, const int* table,
                            const int* lengths, void* part_m, void* part_l,
                            void* part_acc, void* out, int S, int Hkv, int G,
                            int D, int P, int ps, int pps, int nsplit,
                            int window, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > kMaxGroup || D < 32 || D % 32 != 0 || D > 1024) return -1;
  if (S < 1 || Hkv < 1 || ps < 1 || pps < 1 || (long)nsplit * pps < P ||
      S > 65535 || Hkv > 65535)
    return -1;
  SplitArgs a{Hkv, G, D, P, ps, pps, nsplit, 2, window, sm_scale};
  auto pm = static_cast<float*>(part_m);
  auto pl = static_cast<float*>(part_l);
  auto pa = static_cast<float*>(part_acc);
  if (q_dtype == 0 && row_dtype == 0)
    return dispatch_pool<float, float>(pool_dtype, q, k_row, v_row, pool_k,
                                       pool_v, k_scales, v_scales, table,
                                       lengths, pm, pl, pa, out, S, a, st);
  if (q_dtype == 0 && row_dtype == 1)
    return dispatch_pool<float, __nv_bfloat16>(
        pool_dtype, q, k_row, v_row, pool_k, pool_v, k_scales, v_scales,
        table, lengths, pm, pl, pa, out, S, a, st);
  if (q_dtype == 1 && row_dtype == 0)
    return dispatch_pool<__nv_bfloat16, float>(
        pool_dtype, q, k_row, v_row, pool_k, pool_v, k_scales, v_scales,
        table, lengths, pm, pl, pa, out, S, a, st);
  if (q_dtype == 1 && row_dtype == 1)
    return dispatch_pool<__nv_bfloat16, __nv_bfloat16>(
        pool_dtype, q, k_row, v_row, pool_k, pool_v, k_scales, v_scales,
        table, lengths, pm, pl, pa, out, S, a, st);
  return -1;
}
