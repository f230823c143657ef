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
// Inputs are bf16 (the main path, tensor cores) or f32 (a CUDA-core path
// of the same kernels, for tight checks); outputs are in the input dtype.
//
// Semantics kept from the reference:
//   - sm_scale = 1/sqrt(D) is applied to the f32 dot;
//   - causal is top-aligned (key visible iff key <= query); a window keeps
//     keys with query - key < window; masked scores are -1e30 and their
//     probabilities are zeroed;
//   - l is clamped at 1e-30 and the LSE is pinned to 0 where l == 0, so
//     empty rows give zero output and zero gradients;
//   - P is rounded to the input dtype before P.V and P^T.dO, dS before
//     dS.K and dS^T.Q; every product accumulates in f32.
// Ragged tiles (lengths that are not tile multiples) are masked here, so
// no caller pads.
//
// Design (FA-2's split, no atomics):
//   - forward and dQ: one block per (b*h, q tile), a loop over the live k
//     tiles of the causal/window band; dK/dV: one block per (b*h, k tile),
//     a loop over the live q tiles. Heavy (late, long causal) q tiles
//     launch first.
//   - the bf16 forward (flash_fwd_kernel_sm90) is built for Hopper: a
//     128-row q tile per block, two warpgroups of 64 rows each; K/V tiles
//     of 64 rows in a two-stage shared-memory ring filled by cp.async, the
//     next tile's copies issued before this tile's products; S = Q K^T on
//     wgmma from shared memory into registers; mask and online softmax in
//     registers; P rounded to bf16 in registers and fed to the P.V wgmma
//     as its register operand, O accumulated and rescaled in registers;
//     the output leaves through shared memory as 16-byte stores. Head
//     dims below a multiple of 64 are zero-padded in shared memory.
//   - the dQ and dK/dV passes and the f32 forward stage tiles in shared
//     memory with 16-byte loads; their bf16 products run on the tensor
//     cores through WMMA (mma.sync m16n8k16 underneath) with f32
//     accumulators kept in shared memory, where the softmax touches them.
//     The f32 path runs the same kernels on CUDA cores, for tight checks.
//   - delta = rowsum(dO * O) is computed once per q tile by the dQ pass,
//     which writes it out for the dK/dV pass launched after it on the same
//     stream (the reference recomputes it in both kernels).
//
// What bounds it: at the training shapes (S = 2048, D = 128, causal) all
// three are bounded by tensor-core operations (4, 6 and 8 * B*H*S^2*D/2
// flops at 989 TFLOP/s bf16), with bytes well under that line. The
// forward keeps the tensor cores fed from registers and a prefetched ring;
// it has no producer warp or TMA, so a tile's softmax still stalls its
// warpgroup's products. The two backward passes are the first, simple
// design: WMMA from shared memory with no pipelining, accumulators in
// shared memory, no wgmma; each is later work.
//
// Each C entry point takes raw pointers and the CUDA stream, launches on
// that stream, never synchronises, and returns cudaGetLastError() (or -1
// for arguments it is not built for).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kMaxD = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
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

// Tile sizes per input type: bf16 tiles feed 16x16x16 WMMA; f32 runs on
// CUDA cores with smaller tiles so the dK/dV pass fits shared memory.
template <typename T>
struct Tiles;
template <>
struct Tiles<bf16> {
  static constexpr int BQ = 64, BK = 64;
};
template <>
struct Tiles<float> {
  static constexpr int BQ = 32, BK = 32;
};

// Row padding of 16 bytes against shared-memory bank conflicts; keeps
// every 16-row WMMA tile 32-byte aligned.
template <typename T>
__host__ __device__ constexpr int pad() {
  return 16 / static_cast<int>(sizeof(T));
}
constexpr int kPadF = 4;  // f32 accumulators

// C[M,N] (+)= op(A)[M,K] . op(B)[K,N] with f32 accumulation. A is stored
// [M,K] (or [K,M] when kAT), B [K,N] (or [N,K] when kBT), all in shared
// memory; M, N and K are multiples of 16.
template <bool kAT, bool kBT>
__device__ void mm(float* C, int ldc, const bf16* A, int lda, const bf16* B,
                   int ldb, int M, int N, int K, bool acc) {
  using namespace nvcuda;
  using LA = std::conditional_t<kAT, wmma::col_major, wmma::row_major>;
  using LB = std::conditional_t<kBT, wmma::col_major, wmma::row_major>;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int tn = N / 16, tiles = (M / 16) * tn;
  for (int t = warp; t < tiles; t += nwarps) {
    const int mi = t / tn, ni = t - mi * tn;
    float* cp = C + mi * 16 * ldc + ni * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    if (acc)
      wmma::load_matrix_sync(c, cp, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(c, 0.f);
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
      wmma::load_matrix_sync(
          a, kAT ? A + kk * lda + mi * 16 : A + mi * 16 * lda + kk, lda);
      wmma::load_matrix_sync(
          b, kBT ? B + ni * 16 * ldb + kk : B + kk * ldb + ni * 16, ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(cp, c, ldc, wmma::mem_row_major);
  }
}

// The f32 path: the same product on CUDA cores, summed in k order.
template <bool kAT, bool kBT>
__device__ void mm(float* C, int ldc, const float* A, int lda,
                   const float* B, int ldb, int M, int N, int K, bool acc) {
  for (int idx = threadIdx.x; idx < M * N; idx += blockDim.x) {
    const int m = idx / N, n = idx - m * N;
    float s = acc ? C[m * ldc + n] : 0.f;
    for (int k = 0; k < K; ++k) {
      const float a = kAT ? A[k * lda + m] : A[m * lda + k];
      const float b = kBT ? B[n * ldb + k] : B[k * ldb + n];
      s = fmaf(a, b, s);
    }
    C[m * ldc + n] = s;
  }
}

// rows x D tile from global rows `row_stride` elements apart into shared
// memory (leading dimension ld); rows at or past `valid` read as zero.
template <typename T>
__device__ void load_rows(T* dst, int ld, const T* src, size_t row_stride,
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
// K1a: forward, f32 on CUDA cores (bf16 runs flash_fwd_kernel_sm90 below)
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
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const uint8_t* __restrict__ kmask, T* __restrict__ o,
                     float* __restrict__ lse, Shape sh) {
  static_assert(std::is_same<T, float>::value,
                "the bf16 forward is flash_fwd_kernel_sm90");
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
// K1a: forward, bf16 on wgmma
// ---------------------------------------------------------------------------

constexpr int kFwdBQ = 128;       // q rows of a block: two warpgroups of 64
constexpr int kFwdBK = 64;        // k/v rows of a ring stage
constexpr int kFwdThreads = 256;

// Q tile, two K and two V stages (DP columns, bf16), two key-mask stages,
// and 1 KB to align the tiles to the swizzle's 1024 bytes.
template <int DP>
constexpr size_t fwd_sm90_smem() {
  return size_t(kFwdBQ) * DP * 2 + 4 * size_t(kFwdBK) * DP * 2 +
         2 * kFwdBK + 1024;
}

// DP: the head dim padded to a multiple of 64 (64 or 128); columns D..DP
// are zeros in shared memory, so they add nothing to Q K^T and their
// output columns are dropped.
//
// Register fragments (wgmma's accumulator layout): in warpgroup wg, lane
// l of warp w holds, for accumulator i, row wg*64 + w*16 + l/4 + 8*(i/2%2)
// and column 8*(i/4) + 2*(l%4) + i%2. P's bf16 pairs in that layout are
// exactly the register A operand of the P.V product.
template <int DP>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_kernel_sm90(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const uint8_t* __restrict__ kmask,
                          bf16* __restrict__ o, float* __restrict__ lse,
                          Shape sh) {
  using namespace hopper;
  constexpr int BQ = kFwdBQ, BK = kFwdBK;
  constexpr int CH = DP / 8;            // 16-byte chunks of a tile row
  constexpr int KV_BYTES = BK * DP * 2;
  constexpr int NS = BK / 2;            // S accumulators of a thread
  constexpr int NO = DP / 2;            // O accumulators of a thread
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr float kLn2 = 0.6931471805599453f;
  extern __shared__ char fwd_smem_raw[];
  char* Qs = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(fwd_smem_raw) + 1023) & ~uintptr_t(1023));
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

  // rows x DP of `src` (rows rs apart) into swizzled panels; rows at or
  // past `valid` and columns at or past D are zero-filled
  auto load = [&](char* dst, const bf16* src, int rows, int valid) {
    for (int idx = tid; idx < rows * CH; idx += kFwdThreads) {
      const int r = idx / CH, c = idx - r * CH;
      const bool in = r < valid && c * 8 < D;
      cp_async16(dst + swz128(r, c, rows), in ? src + r * rs + c * 8 : src,
                 in ? 16 : 0);
    }
  };
  auto load_kv = [&](int kj, int st) {
    const int k0 = kj * BK;
    load(Ks + st * KV_BYTES, kb + (size_t)k0 * rs, BK, Sk - k0);
    load(Vs + st * KV_BYTES, vb + (size_t)k0 * rs, BK, Sk - k0);
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

  load(Qs, qb + (size_t)q0 * rs, BQ, Sq - q0);
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
      // S = Q K^T, both K-major in shared memory
      float s[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint64_t da = wgmma_desc(
            Qs + (kk >> 2) * BQ * 128 + wg * 64 * 128 + (kk & 3) * 32, 16,
            1024);
        const uint64_t db = wgmma_desc(
            Ks + st * KV_BYTES + (kk >> 2) * BK * 128 + (kk & 3) * 32, 16,
            1024);
        wgmma_ss_n64(s, da, db, kk > 0);
      }
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
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db =
            wgmma_desc(Vs + st * KV_BYTES + kk * 16 * 128, BK * 128, 1024);
        if constexpr (DP == 128)
          wgmma_rs_n128(oacc, pa[kk], db, 1);
        else
          wgmma_rs_n64(oacc, pa[kk], db, 1);
      }
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
  bf16* ob = o + ((size_t)b * Sq * H + h) * D;
  const int och = D / 8;
  for (int idx = tid; idx < BQ * och; idx += kFwdThreads) {
    const int r = idx / och, c = idx - r * och;
    if (q0 + r < Sq)
      *reinterpret_cast<uint4*>(ob + (size_t)(q0 + r) * rs + c * 8) =
          *reinterpret_cast<const uint4*>(Os + r * LDO + c * 8);
  }
}

// ---------------------------------------------------------------------------
// K1b: dQ (and delta)
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
__global__ void __launch_bounds__(kThreads)
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
// K1c: dK, dV
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
__global__ void __launch_bounds__(kThreads)
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

bool bad_shape(int B, int H, int Sq, int Sk, int D) {
  return B < 1 || H < 1 || Sq < 1 || Sk < 1 || D < 16 || D % 16 != 0 ||
         D > kMaxD;
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v,
               const uint8_t* kmask, void* o, float* lse, int B, Shape sh,
               cudaStream_t st) {
  const size_t smem = fwd_smem<T>(sh.D);
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
  const int nq = (sh.Sq + kFwdBQ - 1) / kFwdBQ;
  if (nq > 65535) return -1;
  dim3 grid(B * sh.H, nq);
  flash_fwd_kernel_sm90<DP><<<grid, kFwdThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), kmask, static_cast<bf16*>(o), lse, sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, const uint8_t* kmask,
              void* dq, float* delta, int B, Shape sh, cudaStream_t st) {
  const size_t smem = dq_smem<T>(sh.D);
  if (int e = set_smem(flash_dq_kernel<T>, smem)) return e;
  dim3 grid((sh.Sq + Tiles<T>::BQ - 1) / Tiles<T>::BQ, B * sh.H);
  flash_dq_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, kmask, static_cast<T*>(dq), delta,
      sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               const uint8_t* kmask, void* dk, void* dv, int B, Shape sh,
               cudaStream_t st) {
  const size_t smem = dkv_smem<T>(sh.D);
  if (int e = set_smem(flash_dkv_kernel<T>, smem)) return e;
  dim3 grid((sh.Sk + Tiles<T>::BK - 1) / Tiles<T>::BK, B * sh.H);
  flash_dkv_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      kmask, static_cast<T*>(dk), static_cast<T*>(dv), sh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. window <= 0 means none; kmask
// may be null. sm_scale is 1/sqrt(D), passed by the caller.

extern "C" int flash_fwd(int dtype, const void* q, const void* k,
                         const void* v, const void* kmask, void* o,
                         void* lse, int B, int H, int Sq, int Sk, int D,
                         int causal, int window, float sm_scale,
                         void* stream) {
  if (bad_shape(B, H, Sq, Sk, D)) return -1;
  Shape sh{H, Sq, Sk, D, causal, window, sm_scale};
  auto st = static_cast<cudaStream_t>(stream);
  auto km = static_cast<const uint8_t*>(kmask);
  auto ls = static_cast<float*>(lse);
  if (dtype == 0) return launch_fwd<float>(q, k, v, km, o, ls, B, sh, st);
  if (dtype == 1)
    return sh.D <= 64
               ? launch_fwd_sm90<64>(q, k, v, km, o, ls, B, sh, st)
               : launch_fwd_sm90<128>(q, k, v, km, o, ls, B, sh, st);
  return -1;
}

// Also writes delta [B, H, Sq] f32 for flash_bwd_dkv, which must run
// after it on the same stream.
extern "C" int flash_bwd_dq(int dtype, const void* q, const void* k,
                            const void* v, const void* o, const void* dout,
                            const void* lse, const void* kmask, void* dq,
                            void* delta, int B, int H, int Sq, int Sk, int D,
                            int causal, int window, float sm_scale,
                            void* stream) {
  if (bad_shape(B, H, Sq, Sk, D)) return -1;
  Shape sh{H, Sq, Sk, D, causal, window, sm_scale};
  auto st = static_cast<cudaStream_t>(stream);
  auto km = static_cast<const uint8_t*>(kmask);
  auto ls = static_cast<const float*>(lse);
  auto dl = static_cast<float*>(delta);
  if (dtype == 0)
    return launch_dq<float>(q, k, v, o, dout, ls, km, dq, dl, B, sh, st);
  if (dtype == 1)
    return launch_dq<bf16>(q, k, v, o, dout, ls, km, dq, dl, B, sh, st);
  return -1;
}

extern "C" int flash_bwd_dkv(int dtype, const void* q, const void* k,
                             const void* v, const void* dout,
                             const void* lse, const void* delta,
                             const void* kmask, void* dk, void* dv, int B,
                             int H, int Sq, int Sk, int D, int causal,
                             int window, float sm_scale, void* stream) {
  if (bad_shape(B, H, Sq, Sk, D)) return -1;
  Shape sh{H, Sq, Sk, D, causal, window, sm_scale};
  auto st = static_cast<cudaStream_t>(stream);
  auto km = static_cast<const uint8_t*>(kmask);
  auto ls = static_cast<const float*>(lse);
  auto dl = static_cast<const float*>(delta);
  if (dtype == 0)
    return launch_dkv<float>(q, k, v, dout, ls, dl, km, dk, dv, B, sh, st);
  if (dtype == 1)
    return launch_dkv<bf16>(q, k, v, dout, ls, dl, km, dk, dv, B, sh, st);
  return -1;
}
