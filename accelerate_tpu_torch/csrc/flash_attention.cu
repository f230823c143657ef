// Flash attention for Hopper (sm_90a): the forward with its log-sum-exp,
// and the FlashAttention-2 backward as a dQ pass and a dK/dV pass.
//
// Replaces the TPU kernels of accelerate_tpu/ops/flash_attention.py:
//   flash_fwd     -> _flash_kernel      (K1a, launched by _flash_forward)
//   flash_bwd_dq  -> _flash_dq_kernel   (K1b, launched by _flash_backward)
//   flash_bwd_dkv -> _flash_dkv_kernel  (K1c, launched by _flash_backward)
//
// Layout: q/o/dq/do are [B, Sq, H, D] and k/v/dk/dv [B, Sk, H, D], heads
// already repeated (GQA callers repeat K/V first); lse and delta are
// [B, H, Sq] f32; the optional key mask is [B, Sk] uint8 (1 = attend).
// Inputs are bf16 (the main path, tensor cores), f32 or f16; outputs are
// in the input dtype. bf16 head dims up to 128 run the wgmma kernels; f32,
// f16, and bf16 head dims over 128 (up to 256) run the CUDA-core kernels
// of the same semantics, which take the head dim at run time. Head dims
// need only be a multiple of 16 bytes of a row (8 bf16/f16, 4 f32).
//
// Semantics kept from the reference:
//   - sm_scale = 1/sqrt(D) is applied to the f32 dot;
//   - causal is top-aligned (key visible iff key <= query); a window keeps
//     keys with query - key < window; masked scores are -1e30 and their
//     probabilities are exactly zero;
//   - l is clamped at 1e-30 and the LSE is pinned to 0 where l == 0, so
//     empty rows give zero output and zero gradients;
//   - P is rounded to the input dtype before P.V and P^T.dO, dS before
//     dS.K and dS^T.Q; every product accumulates in f32.
// Ragged tiles (lengths that are not tile multiples) are masked here, so
// no caller pads.
//
// Design (FA-2's split, no atomics, so the same inputs give bit-identical
// outputs):
//   - forward and dQ: one block per (b*h, 128-row q tile), a loop over the
//     live 64-row k tiles of the causal/window band, heavy (late) q tiles
//     launched first; dK/dV: one block per (b*h, 128-row k tile), a loop
//     over the live 64-row q tiles, early (long causal) k tiles first.
//   - the bf16 kernels (flash_{fwd,dq,dkv}_kernel_sm90) run two
//     warpgroups of 64 rows each. The block's own tiles (Q, and dO for dQ;
//     K and V for dK/dV) are loaded once; the tiles it loops over come
//     through a two-stage shared-memory ring filled by cp.async, the next
//     tile's copies issued right after the one barrier a tile, so they fly
//     while this tile is multiplied. Tiles are stored as 64-column panels
//     with the 128-byte swizzle (hopper.cuh).
//   - every product runs on wgmma with f32 accumulators in registers. The
//     score-shaped ones (S = Q K^T; in the backward also dP = dO V^T, and
//     in dK/dV their transposes S^T = K Q^T and dP^T = V dO^T, whose
//     columns are queries) read both operands from shared memory. The
//     second products (P.V; dS.K; P^T.dO and dS^T.Q) take P or dS,
//     rounded to bf16 in registers, as their register A operand: the
//     accumulator's fragment layout is exactly that operand's, so P and
//     dS never leave registers. Masking and the softmax (forward), P and
//     dS (backward) are computed in registers; a tile that every row of a
//     warpgroup sees whole skips the mask.
//   - delta = rowsum(dO * O) is computed once per q row by the dQ pass,
//     which writes it out for the dK/dV pass launched after it on the same
//     stream (the reference recomputes it in both kernels).
//   - head dims below 64 or 128 are zero-padded columns in shared memory
//     (instances DP = 64 and 128); outputs leave through shared memory as
//     16-byte stores of the valid rows and columns.
//   - the CUDA-core path (f32 for tight checks, f16, and bf16 past 128
//     columns) stages 32-row tiles in shared memory in the input dtype and
//     multiplies on CUDA cores in f32; at D = 256 its dK/dV pass in f32
//     takes 218 KB of the 227 KB a block may have.
//
// What bounds it: at the training shapes (S = 2048, D = 128, causal) all
// three are bounded by tensor-core operations (4, 6 and 8 flops per
// visible (query, key) pair and head dim, at 989 TFLOP/s bf16), with bytes
// well under that line. Still missing against that bound: a TMA producer
// warp (the consumers issue their own copies), ping-pong between the two
// warpgroups (a tile's elementwise work stalls its warpgroup's products),
// and overlap of one tile's second products with the next tile's first.
//
// Each C entry point takes raw pointers and the CUDA stream, launches on
// that stream, never synchronises, and returns cudaGetLastError() (or -1
// for arguments it is not built for).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 256;
constexpr int kMaxD = 256;
constexpr int kMaxSmem = 232448;  // a block's shared memory on an H100

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(f16 x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}
template <>
__device__ __forceinline__ f16 from_f32<f16>(float x) {
  return __float2half_rn(x);
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

// Tile sizes of the CUDA-core path, small enough that its dK/dV pass
// fits shared memory at D = 256 in f32.
template <typename T>
struct Tiles {
  static constexpr int BQ = 32, BK = 32;
};

// Row padding of 16 bytes against shared-memory bank conflicts.
template <typename T>
__host__ __device__ constexpr int pad() {
  return 16 / static_cast<int>(sizeof(T));
}
constexpr int kPadF = 4;  // f32 accumulators

// C[M,N] (+)= op(A)[M,K] . op(B)[K,N] on CUDA cores in f32, summed in k
// order. A is stored [M,K] (or [K,M] when kAT), B [K,N] (or [N,K] when
// kBT), all in shared memory in the input dtype.
template <bool kAT, bool kBT, typename T>
__device__ __forceinline__ void mm(float* C, int ldc, const T* A, int lda, const T* B,
                   int ldb, int M, int N, int K, bool acc) {
  for (int idx = threadIdx.x; idx < M * N; idx += blockDim.x) {
    const int m = idx / N, n = idx - m * N;
    float s = acc ? C[m * ldc + n] : 0.f;
    for (int k = 0; k < K; ++k) {
      const float a = to_f32(kAT ? A[k * lda + m] : A[m * lda + k]);
      const float b = to_f32(kBT ? B[n * ldb + k] : B[k * ldb + n]);
      s = fmaf(a, b, s);
    }
    C[m * ldc + n] = s;
  }
}

// rows x D tile from global rows `row_stride` elements apart into shared
// memory (leading dimension ld); rows at or past `valid` read as zero.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, size_t row_stride,
                          int rows, int valid, int D) {
  const int chunks = D * static_cast<int>(sizeof(T)) / 16;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += blockDim.x) {
    const int r = idx / chunks, c = idx - r * chunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid)
      val = reinterpret_cast<const uint4*>(src + r * row_stride)[c];
    reinterpret_cast<uint4*>(dst + r * ld)[c] = val;
  }
}

__device__ __forceinline__ bool visible(int q, int k, int Sq, int Sk,
                                        bool causal, int window,
                                        const uint8_t* kmask_s, int kc) {
  if (q >= Sq || k >= Sk) return false;
  if (causal && k > q) return false;
  if (window > 0 && q - k >= window) return false;
  return kmask_s == nullptr || kmask_s[kc] != 0;
}

// Whether k tile kj can reach q tile qi (the reference's _band_live).
__device__ __forceinline__ bool band_live(int qi, int kj, int BQ, int BK,
                                          bool causal, int window) {
  if (causal && (qi + 1) * BQ - 1 < kj * BK) return false;
  if (window > 0 && kj * BK + BK - 1 <= qi * BQ - window) return false;
  return true;
}

__device__ __forceinline__ char* carve(char*& p, size_t bytes) {
  char* out = p;
  p += (bytes + 127) & ~size_t(127);
  return out;
}

struct Shape {
  int H, Sq, Sk, D, causal, window;
  float scale;
};

// ---------------------------------------------------------------------------
// K1a: forward on CUDA cores (bf16 up to 128 columns runs
// flash_fwd_kernel_sm90 below)
// ---------------------------------------------------------------------------

template <typename T>
size_t fwd_smem(int D) {
  constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
  auto r = [](size_t b) { return (b + 127) & ~size_t(127); };
  const int ldt = D + pad<T>();
  return r(sizeof(T) * BQ * ldt) + 2 * r(sizeof(T) * BK * ldt) +
         r(sizeof(float) * BQ * (BK + kPadF)) +
         r(sizeof(T) * BQ * (BK + pad<T>())) +
         r(sizeof(float) * BQ * (D + kPadF)) + 2 * r(sizeof(float) * BQ) +
         r(BK);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const uint8_t* __restrict__ kmask, T* __restrict__ o,
                     float* __restrict__ lse, Shape sh) {
  constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
  constexpr int kPerLane = BK / 32;
  const int H = sh.H, Sq = sh.Sq, Sk = sh.Sk, D = sh.D;
  const int ldt = D + pad<T>(), lds = BK + kPadF, ldp = BK + pad<T>(),
            ldo = D + kPadF;
  extern __shared__ __align__(128) char smem_raw[];
  char* sp = smem_raw;
  T* Qs = reinterpret_cast<T*>(carve(sp, sizeof(T) * BQ * ldt));
  T* Ks = reinterpret_cast<T*>(carve(sp, sizeof(T) * BK * ldt));
  T* Vs = reinterpret_cast<T*>(carve(sp, sizeof(T) * BK * ldt));
  float* Ss = reinterpret_cast<float*>(carve(sp, sizeof(float) * BQ * lds));
  T* Ps = reinterpret_cast<T*>(carve(sp, sizeof(T) * BQ * ldp));
  float* Os = reinterpret_cast<float*>(carve(sp, sizeof(float) * BQ * ldo));
  float* m_s = reinterpret_cast<float*>(carve(sp, sizeof(float) * BQ));
  float* l_s = reinterpret_cast<float*>(carve(sp, sizeof(float) * BQ));
  uint8_t* km_s = reinterpret_cast<uint8_t*>(carve(sp, BK));

  // heavy (late, long causal rows) q tiles launch first
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = qi * BQ;
  const size_t rs = (size_t)H * D;
  const T* qb = q + ((size_t)b * Sq * H + h) * D;
  const T* kb = k + ((size_t)b * Sk * H + h) * D;
  const T* vb = v + ((size_t)b * Sk * H + h) * D;
  const uint8_t* mb = kmask ? kmask + (size_t)b * Sk : nullptr;
  const bool causal = sh.causal != 0;
  const int window = sh.window;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  load_rows(Qs, ldt, qb + q0 * rs, rs, BQ, Sq - q0, D);
  for (int i = threadIdx.x; i < BQ * ldo; i += blockDim.x) Os[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  const int nk = (Sk + BK - 1) / BK;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kj_end = causal ? min(nk, q_last / BK + 1) : nk;
  const int kj_begin = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  for (int kj = kj_begin; kj < kj_end; ++kj) {
    if (!band_live(qi, kj, BQ, BK, causal, window)) continue;
    const int k0 = kj * BK;
    __syncthreads();  // the previous tile's readers are done
    load_rows(Ks, ldt, kb + k0 * rs, rs, BK, Sk - k0, D);
    load_rows(Vs, ldt, vb + k0 * rs, rs, BK, Sk - k0, D);
    if (mb)
      for (int i = threadIdx.x; i < BK; i += blockDim.x)
        km_s[i] = k0 + i < Sk ? mb[k0 + i] : 0;
    __syncthreads();
    mm<false, true>(Ss, lds, Qs, ldt, Ks, ldt, BQ, BK, D, false);
    __syncthreads();
    // online softmax, one warp per row; the warp also rescales its row
    // of the accumulator
    for (int r = warp; r < BQ; r += nwarps) {
      const int qr = q0 + r;
      float s[kPerLane];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int c = lane + 32 * j;
        const bool keep = visible(qr, k0 + c, Sq, Sk, causal, window,
                                  mb ? km_s : nullptr, c);
        s[j] = keep ? Ss[r * lds + c] * sh.scale : kNegInf;
        mx = fmaxf(mx, s[j]);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const float p = s[j] <= kNegInf * 0.5f ? 0.f : expf(s[j] - m_new);
        sum += p;
        Ps[r * ldp + lane + 32 * j] = from_f32<T>(p);
      }
      sum = warp_sum(sum);
      const float alpha = expf(m_prev - m_new);
      for (int d = lane; d < D; d += 32) Os[r * ldo + d] *= alpha;
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
      }
    }
    __syncthreads();
    mm<false, false>(Os, ldo, Ps, ldp, Vs, ldt, BQ, D, BK, true);
  }
  __syncthreads();

  T* ob = o + ((size_t)b * Sq * H + h) * D;
  for (int idx = threadIdx.x; idx < BQ * D; idx += blockDim.x) {
    const int r = idx / D, d = idx - r * D;
    if (q0 + r < Sq)
      ob[(size_t)(q0 + r) * rs + d] =
          from_f32<T>(Os[r * ldo + d] / fmaxf(l_s[r], 1e-30f));
  }
  for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
    if (q0 + r >= Sq) continue;
    const float l = l_s[r];
    lse[(size_t)bh * Sq + q0 + r] =
        l > 0.f ? m_s[r] + logf(fmaxf(l, 1e-30f)) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// The bf16 kernels' building blocks (wgmma, swizzled panels)
// ---------------------------------------------------------------------------

constexpr int kSm90Rows = 128;    // a block's own rows: two warpgroups of 64
constexpr int kSm90Ring = 64;     // rows of a ring stage
constexpr int kSm90Threads = 256;

__device__ __forceinline__ char* align1024(char* p) {
  return reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// The thread's index, read anew where it is used: offsets derived from
// it are then recomputed at each call instead of being held in registers
// across a kernel's main loop.
__device__ __forceinline__ int fresh_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

// ROWS x DP of `src` (rows rs elements apart) into swizzled 64-column
// panels at `dst`, asynchronously; rows at or past `valid` and columns at
// or past D are zero-filled. Every thread of the block takes part, each
// with one chunk column and every STEP-th row from its first.
template <int DP, int ROWS>
__device__ __forceinline__ void load_panels(char* dst, const bf16* src,
                                            size_t rs, int valid, int D) {
  constexpr int CH = DP / 8;                 // 16-byte chunks of a row
  constexpr int STEP = kSm90Threads / CH;    // a multiple of 8
  static_assert(ROWS % STEP == 0, "whole rounds of copies");
  const int t = fresh_tid(), r0 = t / CH, c = t % CH;
  char* d = dst + hopper::swz128(r0, c, ROWS);  // r % 8 == r0 % 8
  const bf16* s = src + r0 * rs + c * 8;
  const bool col_in = c * 8 < D;
#pragma unroll
  for (int i = 0; i < ROWS / STEP; ++i) {
    const bool in = col_in && r0 + i * STEP < valid;
    hopper::cp_async16(d + i * STEP * 128, in ? s + i * STEP * rs : src,
                       in ? 16 : 0);
  }
}

// wgmma descriptor of k-step kk (16 columns) of a K-major operand: rows
// [r0, r0 + 64) of a swizzled tile of `rows` rows.
__device__ __forceinline__ uint64_t kmajor_desc(const char* tile, int rows,
                                                int r0, int kk) {
  return hopper::wgmma_desc(
      tile + (kk >> 2) * rows * 128 + r0 * 128 + (kk & 3) * 32, 16, 1024);
}

// wgmma descriptor of k-step kk (16 rows) of an MN-major operand: a
// swizzled tile of `rows` rows read across its columns (the leading
// offset steps from one 64-column panel to the next).
__device__ __forceinline__ uint64_t mnmajor_desc(const char* tile, int rows,
                                                 int kk) {
  return hopper::wgmma_desc(tile + kk * 16 * 128, rows * 128, 1024);
}

// D[64 x DP] += A[64 x 16] . B[16 x DP], A in registers, B MN-major.
template <int DP>
__device__ __forceinline__ void wgmma_rs(float (&d)[DP / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DP == 128)
    hopper::wgmma_rs_n128(d, a, db, 1);
  else
    hopper::wgmma_rs_n64(d, a, db, 1);
}

// Writes this thread's part of its warpgroup's 64 x DP accumulator, times
// `mul`, as bf16 into the block's staging tile (rows `ld` elements apart).
// Lane l of warp w holds, for accumulator i, row wg*64 + w*16 + l/4 +
// 8*(i/2%2) and column 8*(i/4) + 2*(l%4) + i%2.
template <int DP>
__device__ __forceinline__ void stage_acc(bf16* dst, int ld,
                                          const float (&acc)[DP / 2],
                                          float mul) {
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int row = wg * 64 + warp * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
    const int col = (i >> 2) * 8 + (lane & 3) * 2;
    *reinterpret_cast<__nv_bfloat162*>(dst + row * ld + col) =
        __floats2bfloat162_rn(acc[i] * mul, acc[i + 1] * mul);
  }
}

// The first `valid` of `rows` staged rows (`ld` elements apart), D
// columns, to global rows `rs` elements apart, 16 bytes at a time.
__device__ __forceinline__ void store_rows(bf16* dst, size_t rs,
                                           const bf16* src, int ld, int rows,
                                           int valid, int D) {
  const int ch = D / 8;
  for (int idx = threadIdx.x; idx < rows * ch; idx += kSm90Threads) {
    const int r = idx / ch, c = idx - r * ch;
    if (r < valid)
      *reinterpret_cast<uint4*>(dst + (size_t)r * rs + c * 8) =
          *reinterpret_cast<const uint4*>(src + r * ld + c * 8);
  }
}

// Bit i set where accumulator i of this thread in a 64 x 64 score tile is
// visible: its rows r0 and r0 + 8, its columns c0 + 8*(i/4) + 2*(l%4) +
// i%2. Rows are queries and columns keys, or the other way round when
// kKeyRows (dK/dV's transposed scores); the key mask is indexed from key
// kbase.
template <bool kKeyRows>
__device__ __forceinline__ uint32_t visible_bits(int r0, int c0, int Sq,
                                                 int Sk, bool causal,
                                                 int window,
                                                 const uint8_t* kmask_s,
                                                 int kbase) {
  const int lane = threadIdx.x & 31;
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = r0 + 8 * ((i >> 1) & 1);
    const int c = c0 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
    const int qq = kKeyRows ? c : r, kk = kKeyRows ? r : c;
    if (visible(qq, kk, Sq, Sk, causal, window, kmask_s, kk - kbase))
      bits |= 1u << i;
  }
  return bits;
}

// Sum of the products of two runs of 8 bf16, in f32.
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 u = __bfloat1622float2(x[j]), w = __bfloat1622float2(y[j]);
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
  return s;
}

// ---------------------------------------------------------------------------
// K1a: forward, bf16 on wgmma
// ---------------------------------------------------------------------------

// Q tile, two K and two V stages (DP columns, bf16), two key-mask stages,
// and 1 KB to align the tiles to the swizzle's 1024 bytes.
template <int DP>
constexpr size_t fwd_sm90_smem() {
  return size_t(kSm90Rows) * DP * 2 + 4 * size_t(kSm90Ring) * DP * 2 +
         2 * kSm90Ring + 1024;
}

// DP: the head dim padded to a multiple of 64 (64 or 128); columns D..DP
// are zeros in shared memory, so they add nothing to Q K^T and their
// output columns are dropped.
//
// Register fragments (wgmma's accumulator layout): see stage_acc. P's
// bf16 pairs in that layout are exactly the register A operand of the P.V
// product.
template <int DP>
__global__ void __launch_bounds__(kSm90Threads, 1)
    flash_fwd_kernel_sm90(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const uint8_t* __restrict__ kmask,
                          bf16* __restrict__ o, float* __restrict__ lse,
                          Shape sh) {
  using namespace hopper;
  constexpr int BQ = kSm90Rows, BK = kSm90Ring;
  constexpr int KV_BYTES = BK * DP * 2;
  constexpr int NS = BK / 2;            // S accumulators of a thread
  constexpr int NO = DP / 2;            // O accumulators of a thread
  constexpr float kLn2 = 0.6931471805599453f;
  extern __shared__ char fwd_smem_raw[];
  char* Qs = align1024(fwd_smem_raw);
  char* Ks = Qs + BQ * DP * 2;          // two stages
  char* Vs = Ks + 2 * KV_BYTES;         // two stages
  uint8_t* kms = reinterpret_cast<uint8_t*>(Vs + 2 * KV_BYTES);

  const int H = sh.H, Sq = sh.Sq, Sk = sh.Sk, D = sh.D;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int qi = gridDim.y - 1 - blockIdx.y;  // heavy q tiles launch first
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = qi * BQ;
  const size_t rs = (size_t)H * D;
  const bf16* qb = q + ((size_t)b * Sq * H + h) * D;
  const bf16* kb = k + ((size_t)b * Sk * H + h) * D;
  const bf16* vb = v + ((size_t)b * Sk * H + h) * D;
  const uint8_t* mb = kmask ? kmask + (size_t)b * Sk : nullptr;
  const bool causal = sh.causal != 0;
  const int window = sh.window;

  auto load_kv = [&](int kj, int st) {
    const int k0 = kj * BK;
    load_panels<DP, BK>(Ks + st * KV_BYTES, kb + (size_t)k0 * rs, rs,
                        Sk - k0, D);
    load_panels<DP, BK>(Vs + st * KV_BYTES, vb + (size_t)k0 * rs, rs,
                        Sk - k0, D);
    if (mb && tid < BK) kms[st * BK + tid] = k0 + tid < Sk ? mb[k0 + tid] : 0;
  };

  const int nk = (Sk + BK - 1) / BK;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kj_end = causal ? min(nk, q_last / BK + 1) : nk;
  const int kj_begin = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  float oacc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) oacc[i] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};  // log2 units
  const int row0 = q0 + wg * 64 + warp * 16 + (lane >> 2);  // and row0 + 8
  const bool wg_rows = q0 + wg * 64 < Sq;
  const float scale2 = sh.scale * kLog2e;

  load_panels<DP, BQ>(Qs, qb + (size_t)q0 * rs, rs, Sq - q0, D);
  if (kj_begin < kj_end) load_kv(kj_begin, 0);
  cp_async_commit();
  for (int kj = kj_begin, st = 0; kj < kj_end; ++kj, st ^= 1) {
    cp_async_wait<0>();  // this tile, the one group in flight, has landed
    fence_proxy_async();
    // one barrier a tile: past it, every warpgroup is done with the other
    // stage, so the next tile's copies go there and fly while this one is
    // multiplied
    __syncthreads();
    if (kj + 1 < kj_end) load_kv(kj + 1, st ^ 1);
    cp_async_commit();
    const int k0 = kj * BK;
    if (wg_rows && band_live(q0 / 64 + wg, kj, 64, BK, causal, window)) {
      const char* kt = Ks + st * KV_BYTES;
      // S = Q K^T, both K-major in shared memory
      float s[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n64(s, kmajor_desc(Qs, BQ, wg * 64, kk),
                     kmajor_desc(kt, BK, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);

      // mask and online softmax; a row's 64 columns sit in the 4 lanes
      // that share l/4. A tile that every row of the warpgroup sees whole
      // (most of a long causal band) skips the mask.
      const int wr0 = q0 + wg * 64;
      const bool whole = mb == nullptr && k0 + BK <= Sk && wr0 + 64 <= Sq &&
                         (!causal || k0 + BK - 1 <= wr0) &&
                         (window <= 0 || wr0 + 63 - k0 < window);
      if (!whole) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int col = k0 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
          if (!visible(row0 + 8 * ((i >> 1) & 1), col, Sq, Sk, causal,
                       window, mb ? kms + st * BK : nullptr, col - k0))
            s[i] = kNegInf;
        }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < NS; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float alpha[2], m_use[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // scores in log2 units: dot * sm_scale * log2(e)
        const float m_new =
            mx[r] <= kNegInf * 0.5f ? m_r[r] : fmaxf(m_r[r], mx[r] * scale2);
        alpha[r] = fast_exp2(m_r[r] - m_new);
        m_r[r] = m_new;
        // masked keys must give 0: against a row that has seen nothing (m
        // still kNegInf) exp2(s - m) would be 1, so subtract 0 there
        m_use[r] = m_new <= kNegInf * 0.5f ? 0.f : m_new;
      }
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int i = 0; i < NS; i += 2) {
        const int hi = (i >> 1) & 1;
        const float p0 = fast_exp2(fmaf(s[i], scale2, -m_use[hi]));
        const float p1 = fast_exp2(fmaf(s[i + 1], scale2, -m_use[hi]));
        sum[hi] += p0 + p1;
        pa[i >> 3][(i >> 1) & 3] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l_r[r] = l_r[r] * alpha[r] + sum[r];
      }
#pragma unroll
      for (int i = 0; i < NO; ++i) oacc[i] *= alpha[(i >> 1) & 1];

      // O += P V: P from registers, V MN-major in shared memory
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<DP>(oacc, pa[kk], mnmajor_desc(Vs + st * KV_BYTES, BK, kk));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(oacc);
    }
  }
  cp_async_wait<0>();  // with no live tile, Q's copies may still fly
  __syncthreads();

  // epilogue: O / l in bf16, staged in shared memory (rows padded against
  // bank conflicts), then 16-byte stores of the valid rows and columns
  constexpr int LDO = DP + 8;
  bf16* Os = reinterpret_cast<bf16*>(Qs);
#pragma unroll
  for (int i = 0; i < NO; i += 2) {
    const int hi = (i >> 1) & 1;
    const int row = wg * 64 + warp * 16 + (lane >> 2) + 8 * hi;
    const int col = (i >> 2) * 8 + (lane & 3) * 2;
    const float l = fmaxf(l_r[hi], 1e-30f);
    *reinterpret_cast<__nv_bfloat162*>(Os + row * LDO + col) =
        __floats2bfloat162_rn(oacc[i] / l, oacc[i + 1] / l);
  }
  if (wg_rows && (lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < Sq)
        lse[(size_t)bh * Sq + row] =
            l_r[r] > 0.f ? (m_r[r] + log2f(l_r[r])) * kLn2 : 0.f;
    }
  }
  __syncthreads();
  store_rows(o + ((size_t)b * Sq * H + h) * D + (size_t)q0 * rs, rs, Os, LDO,
             BQ, Sq - q0, D);
}

// ---------------------------------------------------------------------------
// K1b: dQ (and delta) on CUDA cores (bf16 up to 128 columns runs
// flash_dq_kernel_sm90)
// ---------------------------------------------------------------------------

template <typename T>
size_t dq_smem(int D) {
  constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
  auto r = [](size_t b) { return (b + 127) & ~size_t(127); };
  const int ldt = D + pad<T>();
  return 2 * r(sizeof(T) * BQ * ldt) + 2 * r(sizeof(T) * BK * ldt) +
         2 * r(sizeof(float) * BQ * (BK + kPadF)) +
         r(sizeof(T) * BQ * (BK + pad<T>())) +
         r(sizeof(float) * BQ * (D + kPadF)) + 2 * r(sizeof(float) * BQ) +
         r(BK);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const uint8_t* __restrict__ kmask, T* __restrict__ dq,
                    float* __restrict__ delta, Shape sh) {
  constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
  const int H = sh.H, Sq = sh.Sq, Sk = sh.Sk, D = sh.D;
  const int ldt = D + pad<T>(), lds = BK + kPadF, ldp = BK + pad<T>(),
            ldo = D + kPadF;
  extern __shared__ __align__(128) char smem_raw[];
  char* sp = smem_raw;
  T* Qs = reinterpret_cast<T*>(carve(sp, sizeof(T) * BQ * ldt));
  T* dOs = reinterpret_cast<T*>(carve(sp, sizeof(T) * BQ * ldt));
  T* Ks = reinterpret_cast<T*>(carve(sp, sizeof(T) * BK * ldt));
  T* Vs = reinterpret_cast<T*>(carve(sp, sizeof(T) * BK * ldt));
  float* Ss = reinterpret_cast<float*>(carve(sp, sizeof(float) * BQ * lds));
  float* dPs = reinterpret_cast<float*>(carve(sp, sizeof(float) * BQ * lds));
  T* dSs = reinterpret_cast<T*>(carve(sp, sizeof(T) * BQ * ldp));
  float* dQs = reinterpret_cast<float*>(carve(sp, sizeof(float) * BQ * ldo));
  float* lse_s = reinterpret_cast<float*>(carve(sp, sizeof(float) * BQ));
  float* dl_s = reinterpret_cast<float*>(carve(sp, sizeof(float) * BQ));
  uint8_t* km_s = reinterpret_cast<uint8_t*>(carve(sp, BK));

  const int qi = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = qi * BQ;
  const size_t rs = (size_t)H * D;
  const size_t qoff = ((size_t)b * Sq * H + h) * D;
  const T* kb = k + ((size_t)b * Sk * H + h) * D;
  const T* vb = v + ((size_t)b * Sk * H + h) * D;
  const uint8_t* mb = kmask ? kmask + (size_t)b * Sk : nullptr;
  const bool causal = sh.causal != 0;
  const int window = sh.window;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  load_rows(Qs, ldt, q + qoff + q0 * rs, rs, BQ, Sq - q0, D);
  load_rows(dOs, ldt, dout + qoff + q0 * rs, rs, BQ, Sq - q0, D);
  for (int i = threadIdx.x; i < BQ * ldo; i += blockDim.x) dQs[i] = 0.f;
  // delta = rowsum(dO * O) in f32, one warp per row; written out for the
  // dK/dV pass
  for (int r = warp; r < BQ; r += nwarps) {
    const int qr = q0 + r;
    float acc = 0.f;
    if (qr < Sq) {
      const T* orow = o + qoff + (size_t)qr * rs;
      const T* drow = dout + qoff + (size_t)qr * rs;
      for (int d = lane; d < D; d += 32)
        acc += to_f32(drow[d]) * to_f32(orow[d]);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      dl_s[r] = acc;
      lse_s[r] = qr < Sq ? lse[(size_t)bh * Sq + qr] : 0.f;
      if (qr < Sq) delta[(size_t)bh * Sq + qr] = acc;
    }
  }

  const int nk = (Sk + BK - 1) / BK;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kj_end = causal ? min(nk, q_last / BK + 1) : nk;
  const int kj_begin = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  for (int kj = kj_begin; kj < kj_end; ++kj) {
    if (!band_live(qi, kj, BQ, BK, causal, window)) continue;
    const int k0 = kj * BK;
    __syncthreads();
    load_rows(Ks, ldt, kb + k0 * rs, rs, BK, Sk - k0, D);
    load_rows(Vs, ldt, vb + k0 * rs, rs, BK, Sk - k0, D);
    if (mb)
      for (int i = threadIdx.x; i < BK; i += blockDim.x)
        km_s[i] = k0 + i < Sk ? mb[k0 + i] : 0;
    __syncthreads();
    mm<false, true>(Ss, lds, Qs, ldt, Ks, ldt, BQ, BK, D, false);
    mm<false, true>(dPs, lds, dOs, ldt, Vs, ldt, BQ, BK, D, false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < BQ * BK; idx += blockDim.x) {
      const int r = idx / BK, c = idx - r * BK;
      const bool keep = visible(q0 + r, k0 + c, Sq, Sk, causal, window,
                                mb ? km_s : nullptr, c);
      const float p =
          keep ? expf(Ss[r * lds + c] * sh.scale - lse_s[r]) : 0.f;
      dSs[r * ldp + c] = from_f32<T>(p * (dPs[r * lds + c] - dl_s[r]));
    }
    __syncthreads();
    mm<false, false>(dQs, ldo, dSs, ldp, Ks, ldt, BQ, D, BK, true);
  }
  __syncthreads();

  T* dqb = dq + qoff;
  for (int idx = threadIdx.x; idx < BQ * D; idx += blockDim.x) {
    const int r = idx / D, d = idx - r * D;
    if (q0 + r < Sq)
      dqb[(size_t)(q0 + r) * rs + d] =
          from_f32<T>(sh.scale * dQs[r * ldo + d]);
  }
}

// ---------------------------------------------------------------------------
// K1b: dQ (and delta), bf16 on wgmma
// ---------------------------------------------------------------------------

// Q, dO and O tiles (128 rows), two K and two V stages (64 rows), two
// key-mask stages, and 1 KB to align the tiles to the swizzle's 1024
// bytes.
template <int DP>
constexpr size_t dq_sm90_smem() {
  return 3 * size_t(kSm90Rows) * DP * 2 + 4 * size_t(kSm90Ring) * DP * 2 +
         2 * kSm90Ring + 1024;
}

// The forward's grid and ring (K and V tiles of 64 rows, two stages).
// Delta = rowsum(dO * O) comes from the O and dO tiles in shared memory.
// Per K/V tile and warpgroup: S = Q K^T and dP = dO V^T on wgmma from
// shared memory; P = exp(S * scale - lse) and dS = P (dP - delta) in
// registers, dS rounded to bf16 into the register A operand of dQ += dS K,
// with K read MN-major through a second descriptor of the same tile. Each
// thread keeps its two rows' lse (log2 units) and delta in registers.
template <int DP>
__global__ void __launch_bounds__(kSm90Threads, 1)
    flash_dq_kernel_sm90(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ o,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const uint8_t* __restrict__ kmask,
                         bf16* __restrict__ dq, float* __restrict__ delta,
                         Shape sh) {
  using namespace hopper;
  constexpr int BQ = kSm90Rows, BK = kSm90Ring;
  constexpr int TILE = BQ * DP * 2;
  constexpr int KV_BYTES = BK * DP * 2;
  constexpr int NS = BK / 2;            // S and dP accumulators of a thread
  constexpr int NO = DP / 2;            // dQ accumulators of a thread
  extern __shared__ char dq_smem_raw[];
  char* Qs = align1024(dq_smem_raw);
  char* dOs = Qs + TILE;
  char* Os = dOs + TILE;
  char* Ks = Os + TILE;                 // two stages
  char* Vs = Ks + 2 * KV_BYTES;         // two stages
  uint8_t* kms = reinterpret_cast<uint8_t*>(Vs + 2 * KV_BYTES);

  const int H = sh.H, Sq = sh.Sq, Sk = sh.Sk, D = sh.D;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int qi = gridDim.y - 1 - blockIdx.y;  // heavy q tiles launch first
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = qi * BQ;
  const size_t rs = (size_t)H * D;
  const size_t qoff = ((size_t)b * Sq * H + h) * D;
  const bf16* kb = k + ((size_t)b * Sk * H + h) * D;
  const bf16* vb = v + ((size_t)b * Sk * H + h) * D;
  const uint8_t* mb = kmask ? kmask + (size_t)b * Sk : nullptr;
  const bool causal = sh.causal != 0;
  const int window = sh.window;

  const int nk = (Sk + BK - 1) / BK;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kj_end = causal ? min(nk, q_last / BK + 1) : nk;
  const int kj_begin = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  auto load_kv = [&](int kj, int st) {
    const int k0 = kj * BK;
    load_panels<DP, BK>(Ks + st * KV_BYTES, kb + (size_t)k0 * rs, rs,
                        Sk - k0, D);
    load_panels<DP, BK>(Vs + st * KV_BYTES, vb + (size_t)k0 * rs, rs,
                        Sk - k0, D);
    if (mb && tid < BK) kms[st * BK + tid] = k0 + tid < Sk ? mb[k0 + tid] : 0;
  };

  load_panels<DP, BQ>(Qs, q + qoff + (size_t)q0 * rs, rs, Sq - q0, D);
  load_panels<DP, BQ>(dOs, dout + qoff + (size_t)q0 * rs, rs, Sq - q0, D);
  load_panels<DP, BQ>(Os, o + qoff + (size_t)q0 * rs, rs, Sq - q0, D);
  if (kj_begin < kj_end) load_kv(kj_begin, 0);
  cp_async_commit();

  // this thread's two rows, row0 and row0 + 8: lse in log2 units, and
  // delta = rowsum(dO * O) in f32 from shared memory, the four lanes that
  // share the rows splitting the columns (padded columns are zeros);
  // delta is written out for the dK/dV pass
  const int lrow = wg * 64 + warp * 16 + (lane >> 2);  // and lrow + 8
  const int row0 = q0 + lrow;
  const bool wg_rows = q0 + wg * 64 < Sq;
  cp_async_wait<0>();
  __syncthreads();
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < DP / 32; ++j) {
      const uint32_t at = swz128(lrow + 8 * r, (lane & 3) + 4 * j, BQ);
      acc += dot8(*reinterpret_cast<const uint4*>(Os + at),
                  *reinterpret_cast<const uint4*>(dOs + at));
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dl[r] = acc;
    lse2[r] = row < Sq ? lse[(size_t)bh * Sq + row] * kLog2e : 0.f;
    if ((lane & 3) == 0 && row < Sq) delta[(size_t)bh * Sq + row] = acc;
  }

  float dqa[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dqa[i] = 0.f;
  const float scale2 = sh.scale * kLog2e;
  for (int kj = kj_begin, st = 0; kj < kj_end; ++kj, st ^= 1) {
    cp_async_wait<0>();  // this tile, the one group in flight, has landed
    fence_proxy_async();
    __syncthreads();     // one barrier a tile, as in the forward
    if (kj + 1 < kj_end) load_kv(kj + 1, st ^ 1);
    cp_async_commit();
    const int k0 = kj * BK;
    if (wg_rows && band_live(q0 / 64 + wg, kj, 64, BK, causal, window)) {
      const char* kt = Ks + st * KV_BYTES;
      const char* vt = Vs + st * KV_BYTES;
      // S = Q K^T and dP = dO V^T, all four K-major in shared memory
      float s[NS], dp[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n64(s, kmajor_desc(Qs, BQ, wg * 64, kk),
                     kmajor_desc(kt, BK, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n64(dp, kmajor_desc(dOs, BQ, wg * 64, kk),
                     kmajor_desc(vt, BK, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);
      reg_fence(dp);

      // P = exp(S * scale - lse), masked entries exactly 0, and dS =
      // P (dP - delta), packed to bf16 in the A operand's layout. A tile
      // that every row of the warpgroup sees whole skips the mask.
      const int wr0 = q0 + wg * 64;
      const bool whole = mb == nullptr && k0 + BK <= Sk && wr0 + 64 <= Sq &&
                         (!causal || k0 + BK - 1 <= wr0) &&
                         (window <= 0 || wr0 + 63 - k0 < window);
      const uint32_t live =
          whole ? ~0u
                : visible_bits<false>(row0, k0, Sq, Sk, causal, window,
                                      mb ? kms + st * BK : nullptr, k0);
      uint32_t sa[BK / 16][4];
#pragma unroll
      for (int i = 0; i < NS; i += 2) {
        const int hi = (i >> 1) & 1;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = fast_exp2(fmaf(s[i + e], scale2, -lse2[hi]));
          ds[e] = (live >> (i + e) & 1u ? p : 0.f) * (dp[i + e] - dl[hi]);
        }
        sa[i >> 3][(i >> 1) & 3] = pack_bf16(ds[0], ds[1]);
      }

      // dQ += dS K: dS from registers, K MN-major in shared memory
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<DP>(dqa, sa[kk], mnmajor_desc(kt, BK, kk));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dqa);
    }
  }
  cp_async_wait<0>();  // the last (empty) group
  __syncthreads();

  // epilogue: scale * dQ in bf16 through shared memory, 16-byte stores
  constexpr int LDO = DP + 8;
  bf16* dQs = reinterpret_cast<bf16*>(Qs);
  stage_acc<DP>(dQs, LDO, dqa, sh.scale);
  __syncthreads();
  store_rows(dq + qoff + (size_t)q0 * rs, rs, dQs, LDO, BQ, Sq - q0, D);
}

// ---------------------------------------------------------------------------
// K1c: dK, dV on CUDA cores (bf16 up to 128 columns runs
// flash_dkv_kernel_sm90)
// ---------------------------------------------------------------------------

template <typename T>
size_t dkv_smem(int D) {
  constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
  auto r = [](size_t b) { return (b + 127) & ~size_t(127); };
  const int ldt = D + pad<T>();
  return 2 * r(sizeof(T) * BK * ldt) + 2 * r(sizeof(T) * BQ * ldt) +
         2 * r(sizeof(float) * BQ * (BK + kPadF)) +
         2 * r(sizeof(T) * BQ * (BK + pad<T>())) +
         2 * r(sizeof(float) * BK * (D + kPadF)) +
         2 * r(sizeof(float) * BQ) + r(BK);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const uint8_t* __restrict__ kmask, T* __restrict__ dk,
                     T* __restrict__ dv, Shape sh) {
  constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
  const int H = sh.H, Sq = sh.Sq, Sk = sh.Sk, D = sh.D;
  const int ldt = D + pad<T>(), lds = BK + kPadF, ldp = BK + pad<T>(),
            ldo = D + kPadF;
  extern __shared__ __align__(128) char smem_raw[];
  char* sp = smem_raw;
  T* Ks = reinterpret_cast<T*>(carve(sp, sizeof(T) * BK * ldt));
  T* Vs = reinterpret_cast<T*>(carve(sp, sizeof(T) * BK * ldt));
  T* Qs = reinterpret_cast<T*>(carve(sp, sizeof(T) * BQ * ldt));
  T* dOs = reinterpret_cast<T*>(carve(sp, sizeof(T) * BQ * ldt));
  float* Ss = reinterpret_cast<float*>(carve(sp, sizeof(float) * BQ * lds));
  float* dPs = reinterpret_cast<float*>(carve(sp, sizeof(float) * BQ * lds));
  T* Ps = reinterpret_cast<T*>(carve(sp, sizeof(T) * BQ * ldp));
  T* dSs = reinterpret_cast<T*>(carve(sp, sizeof(T) * BQ * ldp));
  float* dKs = reinterpret_cast<float*>(carve(sp, sizeof(float) * BK * ldo));
  float* dVs = reinterpret_cast<float*>(carve(sp, sizeof(float) * BK * ldo));
  float* lse_s = reinterpret_cast<float*>(carve(sp, sizeof(float) * BQ));
  float* dl_s = reinterpret_cast<float*>(carve(sp, sizeof(float) * BQ));
  uint8_t* km_s = reinterpret_cast<uint8_t*>(carve(sp, BK));

  const int kj = blockIdx.x;  // early k tiles carry the most causal work
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int k0 = kj * BK;
  const size_t rs = (size_t)H * D;
  const size_t qoff = ((size_t)b * Sq * H + h) * D;
  const size_t koff = ((size_t)b * Sk * H + h) * D;
  const uint8_t* mb = kmask ? kmask + (size_t)b * Sk : nullptr;
  const bool causal = sh.causal != 0;
  const int window = sh.window;

  load_rows(Ks, ldt, k + koff + k0 * rs, rs, BK, Sk - k0, D);
  load_rows(Vs, ldt, v + koff + k0 * rs, rs, BK, Sk - k0, D);
  for (int i = threadIdx.x; i < BK * ldo; i += blockDim.x) {
    dKs[i] = 0.f;
    dVs[i] = 0.f;
  }
  if (mb)
    for (int i = threadIdx.x; i < BK; i += blockDim.x)
      km_s[i] = k0 + i < Sk ? mb[k0 + i] : 0;

  const int nq = (Sq + BQ - 1) / BQ;
  const int qi_begin = causal ? k0 / BQ : 0;
  const int qi_end =
      window > 0 ? min(nq, (k0 + BK - 1 + window - 1) / BQ + 1) : nq;
  for (int qi = qi_begin; qi < qi_end; ++qi) {
    if (!band_live(qi, kj, BQ, BK, causal, window)) continue;
    const int q0 = qi * BQ;
    __syncthreads();
    load_rows(Qs, ldt, q + qoff + q0 * rs, rs, BQ, Sq - q0, D);
    load_rows(dOs, ldt, dout + qoff + q0 * rs, rs, BQ, Sq - q0, D);
    for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
      const bool in = q0 + r < Sq;
      lse_s[r] = in ? lse[(size_t)bh * Sq + q0 + r] : 0.f;
      dl_s[r] = in ? delta[(size_t)bh * Sq + q0 + r] : 0.f;
    }
    __syncthreads();
    mm<false, true>(Ss, lds, Qs, ldt, Ks, ldt, BQ, BK, D, false);
    mm<false, true>(dPs, lds, dOs, ldt, Vs, ldt, BQ, BK, D, false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < BQ * BK; idx += blockDim.x) {
      const int r = idx / BK, c = idx - r * BK;
      const bool keep = visible(q0 + r, k0 + c, Sq, Sk, causal, window,
                                mb ? km_s : nullptr, c);
      const float p =
          keep ? expf(Ss[r * lds + c] * sh.scale - lse_s[r]) : 0.f;
      Ps[r * ldp + c] = from_f32<T>(p);
      dSs[r * ldp + c] = from_f32<T>(p * (dPs[r * lds + c] - dl_s[r]));
    }
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q (contracting over the q rows)
    mm<true, false>(dVs, ldo, Ps, ldp, dOs, ldt, BK, D, BQ, true);
    mm<true, false>(dKs, ldo, dSs, ldp, Qs, ldt, BK, D, BQ, true);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < BK * D; idx += blockDim.x) {
    const int r = idx / D, d = idx - r * D;
    if (k0 + r >= Sk) continue;
    const size_t g = koff + (size_t)(k0 + r) * rs + d;
    dk[g] = from_f32<T>(sh.scale * dKs[r * ldo + d]);
    dv[g] = from_f32<T>(dVs[r * ldo + d]);
  }
}

// ---------------------------------------------------------------------------
// K1c: dK, dV, bf16 on wgmma
// ---------------------------------------------------------------------------

// K and V tiles (128 rows), two Q and two dO stages (64 rows), two lse
// and two delta stages (f32), the key mask, and 1 KB to align the tiles
// to the swizzle's 1024 bytes.
template <int DP>
constexpr size_t dkv_sm90_smem() {
  return 2 * size_t(kSm90Rows) * DP * 2 + 4 * size_t(kSm90Ring) * DP * 2 +
         4 * kSm90Ring * sizeof(float) + kSm90Rows + 1024;
}

// One block per (b*h, 128-row k tile), K and V loaded once; Q and dO
// tiles of 64 rows, with their lse and delta, through a two-stage ring.
// Per q tile and warpgroup (64 keys): S^T = K Q^T and dP^T = V dO^T on
// wgmma from shared memory (K and V the K-major A operand, Q and dO the
// K-major B operand), so the accumulators' rows are keys and their
// columns queries, whose lse and delta come from shared memory;
// P^T = exp(S^T * scale - lse) and dS^T = P^T (dP^T - delta) in registers,
// each rounded to bf16 into the register A operand of dV += P^T dO and
// dK += dS^T Q, with dO and Q read MN-major through a second descriptor
// of the same tiles. dK and dV (DP/2 f32 each) stay in registers.
template <int DP>
__global__ void __launch_bounds__(kSm90Threads, 1)
    flash_dkv_kernel_sm90(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const uint8_t* __restrict__ kmask,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          Shape sh) {
  using namespace hopper;
  constexpr int BK = kSm90Rows, BQ = kSm90Ring;
  constexpr int TILE = BK * DP * 2;
  constexpr int Q_BYTES = BQ * DP * 2;
  constexpr int NS = BQ / 2;            // S^T and dP^T accumulators
  constexpr int NO = DP / 2;            // dK and dV accumulators, each
  extern __shared__ char dkv_smem_raw[];
  char* Ks = align1024(dkv_smem_raw);
  char* Vs = Ks + TILE;
  char* Qs = Vs + TILE;                 // two stages
  char* dOs = Qs + 2 * Q_BYTES;         // two stages
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * Q_BYTES);  // two stages
  float* dl_s = lse_s + 2 * BQ;                                // two stages
  uint8_t* kms = reinterpret_cast<uint8_t*>(dl_s + 2 * BQ);

  const int H = sh.H, Sq = sh.Sq, Sk = sh.Sk, D = sh.D;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int kj = blockIdx.y;  // early k tiles carry the most causal work
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int k0 = kj * BK;
  const size_t rs = (size_t)H * D;
  const size_t qoff = ((size_t)b * Sq * H + h) * D;
  const size_t koff = ((size_t)b * Sk * H + h) * D;
  const float* lb = lse + (size_t)bh * Sq;
  const float* db = delta + (size_t)bh * Sq;
  const uint8_t* mb = kmask ? kmask + (size_t)b * Sk : nullptr;
  const bool causal = sh.causal != 0;
  const int window = sh.window;

  const int nq = (Sq + BQ - 1) / BQ;
  const int qi_begin = causal ? k0 / BQ : 0;
  const int qi_end =
      window > 0 ? min(nq, (k0 + BK - 1 + window - 1) / BQ + 1) : nq;

  auto load_q = [&](int qi, int st) {
    const int q0 = qi * BQ;
    load_panels<DP, BQ>(Qs + st * Q_BYTES, q + qoff + (size_t)q0 * rs, rs,
                        Sq - q0, D);
    load_panels<DP, BQ>(dOs + st * Q_BYTES, dout + qoff + (size_t)q0 * rs,
                        rs, Sq - q0, D);
    if (tid < 2 * BQ) {  // lse, then delta; rows past Sq read as 0
      const int r = tid & (BQ - 1);
      const bool in = q0 + r < Sq;
      const float* src = tid < BQ ? lb : db;
      cp_async4((tid < BQ ? lse_s : dl_s) + st * BQ + r,
                in ? src + q0 + r : src, in ? 4 : 0);
    }
  };

  load_panels<DP, BK>(Ks, k + koff + (size_t)k0 * rs, rs, Sk - k0, D);
  load_panels<DP, BK>(Vs, v + koff + (size_t)k0 * rs, rs, Sk - k0, D);
  if (mb && tid < BK) kms[tid] = k0 + tid < Sk ? mb[k0 + tid] : 0;
  if (qi_begin < qi_end) load_q(qi_begin, 0);
  cp_async_commit();

  float dka[NO], dva[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dka[i] = dva[i] = 0.f;
  const int kw = k0 / 64 + wg;  // this warpgroup's 64-key tile
  const int krow0 = k0 + wg * 64 + warp * 16 + (lane >> 2);  // and + 8
  const bool wg_keys = k0 + wg * 64 < Sk;
  const float scale2 = sh.scale * kLog2e;
  for (int qi = qi_begin, st = 0; qi < qi_end; ++qi, st ^= 1) {
    cp_async_wait<0>();  // this tile, the one group in flight, has landed
    fence_proxy_async();
    __syncthreads();     // one barrier a tile, as in the forward
    if (qi + 1 < qi_end) load_q(qi + 1, st ^ 1);
    cp_async_commit();
    const int q0 = qi * BQ;
    if (wg_keys && band_live(qi, kw, BQ, 64, causal, window)) {
      const char* qt = Qs + st * Q_BYTES;
      const char* dot = dOs + st * Q_BYTES;
      // S^T = K Q^T and dP^T = V dO^T, all four K-major in shared memory
      float s[NS], dp[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n64(s, kmajor_desc(Ks, BK, wg * 64, kk),
                     kmajor_desc(qt, BQ, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n64(dp, kmajor_desc(Vs, BK, wg * 64, kk),
                     kmajor_desc(dot, BQ, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);
      reg_fence(dp);

      // P^T and dS^T, masked entries exactly 0 (a tile that every key of
      // the warpgroup sees whole skips the mask); a column's lse and delta
      // are shared by the two rows a thread holds. Packed to bf16 in the
      // A operand's layout: accumulators 4j..4j+3 are k-step j/2's
      // registers 2(j%2) and 2(j%2) + 1.
      const int kr0 = k0 + wg * 64;
      const bool whole = mb == nullptr && kr0 + 64 <= Sk && q0 + BQ <= Sq &&
                         (!causal || kr0 + 63 <= q0) &&
                         (window <= 0 || q0 + BQ - 1 - kr0 < window);
      const uint32_t live =
          whole ? ~0u
                : visible_bits<true>(krow0, q0, Sq, Sk, causal, window,
                                     mb ? kms : nullptr, k0);
      const float2* lt = reinterpret_cast<const float2*>(lse_s + st * BQ);
      const float2* dt = reinterpret_cast<const float2*>(dl_s + st * BQ);
      uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
#pragma unroll
      for (int j = 0; j < NS / 4; ++j) {
        const float2 l = lt[j * 4 + (lane & 3)];
        const float2 d = dt[j * 4 + (lane & 3)];
        const float l2[2] = {l.x * kLog2e, l.y * kLog2e};
        const float dl[2] = {d.x, d.y};
        float p[4], ds[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int i = 4 * j + t, e = t & 1;
          const float x = fast_exp2(fmaf(s[i], scale2, -l2[e]));
          p[t] = live >> i & 1u ? x : 0.f;
          ds[t] = p[t] * (dp[i] - dl[e]);
        }
        pa[j >> 1][(2 * j) & 3] = pack_bf16(p[0], p[1]);
        pa[j >> 1][(2 * j + 1) & 3] = pack_bf16(p[2], p[3]);
        sa[j >> 1][(2 * j) & 3] = pack_bf16(ds[0], ds[1]);
        sa[j >> 1][(2 * j + 1) & 3] = pack_bf16(ds[2], ds[3]);
      }

      // dV += P^T dO and dK += dS^T Q: P^T and dS^T from registers, dO
      // and Q MN-major in shared memory
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<DP>(dva, pa[kk], mnmajor_desc(dot, BQ, kk));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<DP>(dka, sa[kk], mnmajor_desc(qt, BQ, kk));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dva);
      reg_fence(dka);
    }
  }
  cp_async_wait<0>();  // with no live tile, K's and V's copies may fly
  __syncthreads();

  // epilogue: scale * dK and dV in bf16 through shared memory, 16-byte
  // stores of the valid rows and columns
  constexpr int LDO = DP + 8;
  bf16* dKs = reinterpret_cast<bf16*>(Ks);
  bf16* dVs = dKs + BK * LDO;
  stage_acc<DP>(dKs, LDO, dka, sh.scale);
  stage_acc<DP>(dVs, LDO, dva, 1.f);
  __syncthreads();
  store_rows(dk + koff + (size_t)k0 * rs, rs, dKs, LDO, BK, Sk - k0, D);
  store_rows(dv + koff + (size_t)k0 * rs, rs, dVs, LDO, BK, Sk - k0, D);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  // above 48 KB a block's dynamic shared memory must be opted into
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// Head dims every path takes: a row of 16-byte pieces, up to 256.
bool bad_shape(int dtype, int B, int H, int Sq, int Sk, int D) {
  const int elt = dtype == 0 ? 4 : 2;
  return dtype < 0 || dtype > 2 || B < 1 || H < 1 || Sq < 1 || Sk < 1 ||
         D < 1 || (D * elt) % 16 != 0 || D > kMaxD;
}

// Whether a bf16 head dim runs the wgmma kernels (DP = 64 or 128).
bool sm90(int dtype, int D) { return dtype == 1 && D <= 128; }

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v,
               const uint8_t* kmask, void* o, float* lse, int B, Shape sh,
               cudaStream_t st) {
  const size_t smem = fwd_smem<T>(sh.D);
  if (smem > kMaxSmem) return -1;
  if (int e = set_smem(flash_fwd_kernel<T>, smem)) return e;
  dim3 grid((sh.Sq + Tiles<T>::BQ - 1) / Tiles<T>::BQ, B * sh.H);
  flash_fwd_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kmask, static_cast<T*>(o), lse, sh);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_fwd_sm90(const void* q, const void* k, const void* v,
                    const uint8_t* kmask, void* o, float* lse, int B,
                    Shape sh, cudaStream_t st) {
  constexpr size_t smem = fwd_sm90_smem<DP>();
  if (int e = set_smem(flash_fwd_kernel_sm90<DP>, smem)) return e;
  const int nq = (sh.Sq + kSm90Rows - 1) / kSm90Rows;
  if (nq > 65535) return -1;
  dim3 grid(B * sh.H, nq);
  flash_fwd_kernel_sm90<DP><<<grid, kSm90Threads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), kmask, static_cast<bf16*>(o), lse, sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, const uint8_t* kmask,
              void* dq, float* delta, int B, Shape sh, cudaStream_t st) {
  const size_t smem = dq_smem<T>(sh.D);
  if (smem > kMaxSmem) return -1;
  if (int e = set_smem(flash_dq_kernel<T>, smem)) return e;
  dim3 grid((sh.Sq + Tiles<T>::BQ - 1) / Tiles<T>::BQ, B * sh.H);
  flash_dq_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, kmask, static_cast<T*>(dq), delta,
      sh);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_dq_sm90(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   const uint8_t* kmask, void* dq, float* delta, int B,
                   Shape sh, cudaStream_t st) {
  constexpr size_t smem = dq_sm90_smem<DP>();
  if (int e = set_smem(flash_dq_kernel_sm90<DP>, smem)) return e;
  const int nq = (sh.Sq + kSm90Rows - 1) / kSm90Rows;
  if (nq > 65535) return -1;
  dim3 grid(B * sh.H, nq);
  flash_dq_kernel_sm90<DP><<<grid, kSm90Threads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), lse, kmask, static_cast<bf16*>(dq),
      delta, sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               const uint8_t* kmask, void* dk, void* dv, int B, Shape sh,
               cudaStream_t st) {
  const size_t smem = dkv_smem<T>(sh.D);
  if (smem > kMaxSmem) return -1;
  if (int e = set_smem(flash_dkv_kernel<T>, smem)) return e;
  dim3 grid((sh.Sk + Tiles<T>::BK - 1) / Tiles<T>::BK, B * sh.H);
  flash_dkv_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      kmask, static_cast<T*>(dk), static_cast<T*>(dv), sh);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_dkv_sm90(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    const uint8_t* kmask, void* dk, void* dv, int B,
                    Shape sh, cudaStream_t st) {
  constexpr size_t smem = dkv_sm90_smem<DP>();
  if (int e = set_smem(flash_dkv_kernel_sm90<DP>, smem)) return e;
  const int nk = (sh.Sk + kSm90Rows - 1) / kSm90Rows;
  if (nk > 65535) return -1;
  dim3 grid(B * sh.H, nk);
  flash_dkv_kernel_sm90<DP><<<grid, kSm90Threads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, kmask, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16. window <= 0 means
// none; kmask may be null. sm_scale is 1/sqrt(D), passed by the caller.
// bf16 head dims up to 64 run the DP = 64 wgmma instances, up to 128 the
// DP = 128 ones; the rest, and f32 and f16, the CUDA-core kernels.

extern "C" int flash_fwd(int dtype, const void* q, const void* k,
                         const void* v, const void* kmask, void* o,
                         void* lse, int B, int H, int Sq, int Sk, int D,
                         int causal, int window, float sm_scale,
                         void* stream) {
  if (bad_shape(dtype, B, H, Sq, Sk, D)) return -1;
  Shape sh{H, Sq, Sk, D, causal, window, sm_scale};
  auto st = static_cast<cudaStream_t>(stream);
  auto km = static_cast<const uint8_t*>(kmask);
  auto ls = static_cast<float*>(lse);
  if (sm90(dtype, D))
    return D <= 64 ? launch_fwd_sm90<64>(q, k, v, km, o, ls, B, sh, st)
                   : launch_fwd_sm90<128>(q, k, v, km, o, ls, B, sh, st);
  if (dtype == 0) return launch_fwd<float>(q, k, v, km, o, ls, B, sh, st);
  if (dtype == 1) return launch_fwd<bf16>(q, k, v, km, o, ls, B, sh, st);
  return launch_fwd<f16>(q, k, v, km, o, ls, B, sh, st);
}

// Also writes delta [B, H, Sq] f32 for flash_bwd_dkv, which must run
// after it on the same stream.
extern "C" int flash_bwd_dq(int dtype, const void* q, const void* k,
                            const void* v, const void* o, const void* dout,
                            const void* lse, const void* kmask, void* dq,
                            void* delta, int B, int H, int Sq, int Sk, int D,
                            int causal, int window, float sm_scale,
                            void* stream) {
  if (bad_shape(dtype, B, H, Sq, Sk, D)) return -1;
  Shape sh{H, Sq, Sk, D, causal, window, sm_scale};
  auto st = static_cast<cudaStream_t>(stream);
  auto km = static_cast<const uint8_t*>(kmask);
  auto ls = static_cast<const float*>(lse);
  auto dl = static_cast<float*>(delta);
  if (sm90(dtype, D))
    return D <= 64 ? launch_dq_sm90<64>(q, k, v, o, dout, ls, km, dq, dl, B,
                                        sh, st)
                   : launch_dq_sm90<128>(q, k, v, o, dout, ls, km, dq, dl, B,
                                         sh, st);
  if (dtype == 0)
    return launch_dq<float>(q, k, v, o, dout, ls, km, dq, dl, B, sh, st);
  if (dtype == 1)
    return launch_dq<bf16>(q, k, v, o, dout, ls, km, dq, dl, B, sh, st);
  return launch_dq<f16>(q, k, v, o, dout, ls, km, dq, dl, B, sh, st);
}

extern "C" int flash_bwd_dkv(int dtype, const void* q, const void* k,
                             const void* v, const void* dout,
                             const void* lse, const void* delta,
                             const void* kmask, void* dk, void* dv, int B,
                             int H, int Sq, int Sk, int D, int causal,
                             int window, float sm_scale, void* stream) {
  if (bad_shape(dtype, B, H, Sq, Sk, D)) return -1;
  Shape sh{H, Sq, Sk, D, causal, window, sm_scale};
  auto st = static_cast<cudaStream_t>(stream);
  auto km = static_cast<const uint8_t*>(kmask);
  auto ls = static_cast<const float*>(lse);
  auto dl = static_cast<const float*>(delta);
  if (sm90(dtype, D))
    return D <= 64 ? launch_dkv_sm90<64>(q, k, v, dout, ls, dl, km, dk, dv, B,
                                         sh, st)
                   : launch_dkv_sm90<128>(q, k, v, dout, ls, dl, km, dk, dv,
                                          B, sh, st);
  if (dtype == 0)
    return launch_dkv<float>(q, k, v, dout, ls, dl, km, dk, dv, B, sh, st);
  if (dtype == 1)
    return launch_dkv<bf16>(q, k, v, dout, ls, dl, km, dk, dv, B, sh, st);
  return launch_dkv<f16>(q, k, v, dout, ls, dl, km, dk, dv, B, sh, st);
}

// Dynamic shared memory in bytes of a bf16 (wgmma) kernel, for reports:
// kernel 0 = forward, 1 = dQ, 2 = dK/dV; dp = 64 or 128.
extern "C" int flash_sm90_smem(int kernel, int dp) {
  const bool wide = dp == 128;
  if (dp != 64 && !wide) return -1;
  switch (kernel) {
    case 0: return static_cast<int>(wide ? fwd_sm90_smem<128>()
                                         : fwd_sm90_smem<64>());
    case 1: return static_cast<int>(wide ? dq_sm90_smem<128>()
                                         : dq_sm90_smem<64>());
    case 2: return static_cast<int>(wide ? dkv_sm90_smem<128>()
                                         : dkv_sm90_smem<64>());
  }
  return -1;
}
