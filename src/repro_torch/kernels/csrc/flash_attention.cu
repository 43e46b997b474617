// Flash-attention forward (prefill) for Hopper: causal / windowed GQA with a
// blocked online softmax, kept in f32.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py: flash_attention
// (its pallas_call).  Plain version: repro_torch/kernels/ref.py: attention.
//
// Layout is the JAX one: q (B, Sq, Hq, Dk), k (B, Sk, Hkv, Dk),
// v (B, Sk, Hkv, Dv), out (B, Sq, Hq, Dv), all contiguous, one dtype
// (f32, bf16 or f16).  Query head h reads KV head h / (Hq / Hkv).
//
// Grid: one block per (query tile, b * Hq + h), flattened to one axis.  The
// TPU kernel's sequential third grid axis over KV tiles becomes a loop inside
// the block; KV tiles wholly masked by causality or the window are never
// visited.  Ragged Sq and Sk are masked: padding rows of Q, K and V are staged
// as zeros and rows past Sq are never written.
//
// Bound on this card: at the serving shapes (S = 32..128, head_dim 64) the
// work is small, so the floor is the bytes of q, k, v and o; both paths keep
// every intermediate (scores, probabilities, running max and sum, the
// accumulator) on chip and read each KV tile from device memory once per
// query tile.  Two paths, chosen from the inputs:
//
// * tensor cores (bf16 / f16, Dk == Dv in {64, 128}, 16-byte aligned): four
//   warps own 16 query rows each of a 64-row tile; Q fragments stay in
//   registers, S = Q K^T and O += P V run as mma.sync m16n8k16 with f32
//   accumulators fed by ldmatrix from padded shared-memory tiles, and P is
//   rounded to the input type for the second product (as the JAX package's
//   chunked attention does).  The serving path runs here.
// * CUDA cores (any dtype, Dk and Dv up to 256): f32 FMAs, each lane scoring
//   one key of a 32-key tile against the warp's kRows query rows, the P.V
//   product broadcasting each probability with a shuffle.  f32 inputs stay
//   exact here; other head dims land here too.
//
// wgmma, TMA and a pipelined KV ring are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;             // query rows per warp
constexpr int kBQ = kWarps * kRows;  // query rows per block
constexpr int kBK = 32;              // keys per KV tile: one per lane
constexpr float kNegInf = -1e30f;    // the reference's mask fill, not -inf

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// DVC = ceil(Dv / 32): output columns each lane accumulates.
template <typename T, int DVC>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                       int Hq, int Hkv, int Dk, int Dv, float scale, int causal,
                       int window) {
  extern __shared__ float smem[];
  const int ks_stride = Dk | 1;  // odd stride: a warp reading one column of K hits 32 banks
  float* qs = smem;                  // [kBQ][Dk]
  float* ks = qs + kBQ * Dk;         // [kBK][ks_stride]
  float* vs = ks + kBK * ks_stride;  // [kBK][Dv]

  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x / n_qt;                // b * Hq + h
  const int qt = n_qt - 1 - blockIdx.x % n_qt;     // longest causal rows first
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < kBQ * Dk; i += kThreads) {
    const int r = i / Dk;
    const int row = q0 + r;
    qs[i] = row < Sq ? to_f32(q[(((int64_t)b * Sq + row) * Hq + h) * Dk + (i - r * Dk)]) : 0.f;
  }

  // KV range that any row of this tile can see
  int kv_lo = 0;
  int kv_hi = Sk;
  if (causal) kv_hi = min(Sk, q0 + kBQ);
  if (window >= 0) kv_lo = max(0, q0 - window + 1);

  float m[kRows], l[kRows], acc[kRows][DVC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DVC; ++c) acc[r][c] = 0.f;
  }
  const float* qw = qs + warp * kRows * Dk;

  for (int t0 = kv_lo; t0 < kv_hi; t0 += kBK) {
    __syncthreads();  // Q staged / previous tile consumed
    for (int i = tid; i < kBK * Dk; i += kThreads) {
      const int r = i / Dk;
      const int d = i - r * Dk;
      const int kj = t0 + r;
      ks[r * ks_stride + d] = kj < Sk ? to_f32(k[(((int64_t)b * Sk + kj) * Hkv + hk) * Dk + d]) : 0.f;
    }
    for (int i = tid; i < kBK * Dv; i += kThreads) {
      const int r = i / Dv;
      const int kj = t0 + r;
      vs[i] = kj < Sk ? to_f32(v[(((int64_t)b * Sk + kj) * Hkv + hk) * Dv + (i - r * Dv)]) : 0.f;
    }
    __syncthreads();

    // lane j scores key t0 + j against the warp's kRows query rows
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* kr = ks + lane * ks_stride;
#pragma unroll 4
    for (int d = 0; d < Dk; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = fmaf(qw[r * Dk + d], kd, s[r]);
    }
    const int kj = t0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + warp * kRows + r;
      bool ok = kj < Sk;
      if (causal) ok = ok && kj <= qi;
      if (window >= 0) ok = ok && kj > qi - window;
      const float sr = ok ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float alpha = expf(m[r] - m_new);
      s[r] = expf(sr - m_new);  // now the probability numerator p
      l[r] = l[r] * alpha + warp_sum(s[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DVC; ++c) acc[r][c] *= alpha;
    }

    // acc += P . V over the keys below kv_hi (keys past it are masked for every row)
    const int n_keys = min(kBK, kv_hi - t0);
    for (int j = 0; j < n_keys; ++j) {
      float vv[DVC];
#pragma unroll
      for (int c = 0; c < DVC; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < Dv ? vs[j * Dv + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
        for (int c = 0; c < DVC; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp * kRows + r;
    if (qi >= Sq) continue;
    T* orow = o + (((int64_t)b * Sq + qi) * Hq + h) * Dv;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DVC; ++c) {
      const int d = lane + 32 * c;
      if (d < Dv) orow[d] = from_f32<T>(acc[r][c] / denom);
    }
  }
}

// ----------------------------------------------------------- tensor cores
constexpr int kMmaBQ = 64;  // query rows per block: 16 per warp
constexpr int kMmaBK = 64;  // keys per KV tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16x16, row) . b (16x8, col), f32 accumulators
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&c)[4], const uint32_t (&a)[4],
                                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                                 uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values rounded to T, the first in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layouts are those of mma.m16n8k16 in the PTX ISA: lane = 4 g + t
// holds accumulator rows g and g + 8, columns 2t and 2t + 1 of each 8-wide
// n-tile; the accumulators of two adjacent n-tiles are exactly the A fragment
// of the next product, so P never leaves registers.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int Hq,
                           int Hkv, float scale, int causal, int window) {
  constexpr int kRow = D + 8;  // padded row: ldmatrix's 8 row reads hit distinct banks
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [kMmaBQ][kRow]
  T* ks = qs + kMmaBQ * kRow;              // [kMmaBK][kRow]
  T* vs = ks + kMmaBK * kRow;              // [kMmaBK][kRow]

  const int n_qt = (Sq + kMmaBQ - 1) / kMmaBQ;
  const int bh = blockIdx.x / n_qt;
  const int qt = n_qt - 1 - blockIdx.x % n_qt;  // longest causal rows first
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kMmaBQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;

  for (int i = tid; i < kMmaBQ * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 8;
    const int row = q0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < Sq) val = *reinterpret_cast<const uint4*>(q + (((int64_t)b * Sq + row) * Hq + h) * D + c);
    *reinterpret_cast<uint4*>(qs + r * kRow + c) = val;
  }
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * kRow + kk * 16 + (lane >> 4) * 8);

  int kv_lo = 0;
  int kv_hi = Sk;
  if (causal) kv_hi = min(Sk, q0 + kMmaBQ);
  if (window >= 0) kv_lo = max(0, q0 - window + 1);

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  for (int t0 = kv_lo; t0 < kv_hi; t0 += kMmaBK) {
    __syncthreads();  // previous tile consumed
    for (int i = tid; i < kMmaBK * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = (i - r * kChunks) * 8;
      const int kj = t0 + r;
      uint4 kval = make_uint4(0u, 0u, 0u, 0u);
      uint4 vval = kval;
      if (kj < Sk) {
        const int64_t off = (((int64_t)b * Sk + kj) * Hkv + hk) * D + c;
        kval = *reinterpret_cast<const uint4*>(k + off);
        vval = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(ks + r * kRow + c) = kval;
      *reinterpret_cast<uint4*>(vs + r * kRow + c) = vval;
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, as 8 n-tiles of 8 keys
    float s[kMmaBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kMmaBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int nt2 = 0; nt2 < kMmaBK / 16; ++nt2) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kb[4];  // B fragments of n-tiles 2 nt2 and 2 nt2 + 1
        ldmatrix_x4(kb, ks + (nt2 * 16 + (lane & 7) + (lane >> 4) * 8) * kRow + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma16816<T>(s[2 * nt2], qf[kk], kb[0], kb[1]);
        mma16816<T>(s[2 * nt2 + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // mask, then the online softmax of rows g and g + 8 (a quad shares a row)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int qi = q0 + warp * 16 + g + rr * 8;
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kMmaBK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = t0 + nt * 8 + 2 * t + e;
          bool ok = kj < Sk;
          if (causal) ok = ok && kj <= qi;
          if (window >= 0) ok = ok && kj > qi - window;
          float& x = s[nt][2 * rr + e];
          x = ok ? x * scale : kNegInf;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      const float alpha = exp2f((m[rr] - m_new) * kLog2e);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kMmaBK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * rr + e];
          x = exp2f((x - m_new) * kLog2e);
          sum += x;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[rr] = l[rr] * alpha + sum;
      m[rr] = m_new;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        acc[dt][2 * rr] *= alpha;
        acc[dt][2 * rr + 1] *= alpha;
      }
    }

    // O += P V, P in the input type straight from the S accumulators
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack2<T>(s[2 * kk][0], s[2 * kk][1]), pack2<T>(s[2 * kk][2], s[2 * kk][3]),
          pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]), pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt2 = 0; dt2 < D / 16; ++dt2) {
        uint32_t vb[4];  // B fragments of d-tiles 2 dt2 and 2 dt2 + 1
        ldmatrix_x4_trans(vb, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kRow +
                                  dt2 * 16 + (lane >> 4) * 8);
        mma16816<T>(acc[2 * dt2], pa, vb[0], vb[1]);
        mma16816<T>(acc[2 * dt2 + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = q0 + warp * 16 + g + rr * 8;
    if (qi >= Sq) continue;
    T* orow = o + (((int64_t)b * Sq + qi) * Hq + h) * D + 2 * t;
    const float denom = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8) =
          pack2<T>(acc[dt][2 * rr] / denom, acc[dt][2 * rr + 1] / denom);
  }
}

template <typename T, int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                       int Sk, int Hq, int Hkv, float scale, int causal, int window,
                       cudaStream_t stream) {
  const size_t smem = sizeof(T) * (size_t)(kMmaBQ + 2 * kMmaBK) * (D + 8);
  auto kernel = flash_attention_mma_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int64_t blocks = (int64_t)((Sq + kMmaBQ - 1) / kMmaBQ) * B * Hq;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, Hq, Hkv, scale, causal, window);
  return cudaGetLastError();
}

// ------------------------------------------------------------ CUDA cores
template <typename T, int DVC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                   int Sk, int Hq, int Hkv, int Dk, int Dv, float scale, int causal,
                   int window, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kBQ * Dk + (size_t)kBK * (Dk | 1) + (size_t)kBK * Dv);
  auto kernel = flash_attention_kernel<T, DVC>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int64_t blocks = (int64_t)((Sq + kBQ - 1) / kBQ) * B * Hq;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, Hq, Hkv, Dk, Dv, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                     int Sk, int Hq, int Hkv, int Dk, int Dv, float scale, int causal,
                     int window, cudaStream_t stream) {
#define REPRO_FA_CASE(n) \
  case n:                \
    return launch<T, n>(q, k, v, o, B, Sq, Sk, Hq, Hkv, Dk, Dv, scale, causal, window, stream);
  switch ((Dv + 31) / 32) {
    REPRO_FA_CASE(1)
    REPRO_FA_CASE(2)
    REPRO_FA_CASE(3)
    REPRO_FA_CASE(4)
    REPRO_FA_CASE(5)
    REPRO_FA_CASE(6)
    REPRO_FA_CASE(7)
    REPRO_FA_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FA_CASE
}

// the tensor-core path when the inputs fit it, else the CUDA-core path
template <typename T>
cudaError_t dispatch_mma(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                         int Sk, int Hq, int Hkv, int Dk, int Dv, float scale, int causal,
                         int window, cudaStream_t stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  if (aligned && Dk == Dv && Dk == 64)
    return launch_mma<T, 64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, window, stream);
  if (aligned && Dk == Dv && Dk == 128)
    return launch_mma<T, 128>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, window, stream);
  return dispatch<T>(q, k, v, o, B, Sq, Sk, Hq, Hkv, Dk, Dv, scale, causal, window, stream);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, 2 = f16.  window < 0: no window.  Returns the
// cudaError_t of the launch (0 on success); the caller raises on anything else.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int Sq, int Sk, int Hq, int Hkv,
                                   int Dk, int Dv, float scale, int causal, int window,
                                   void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || Hq % Hkv != 0 || Dk < 1 || Dk > 256 ||
      Dv < 1 || Dv > 256)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch<float>(q, k, v, o, B, Sq, Sk, Hq, Hkv, Dk, Dv, scale, causal, window, s);
    case 1:
      return (int)dispatch_mma<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, Hq, Hkv, Dk, Dv, scale, causal,
                                              window, s);
    case 2:
      return (int)dispatch_mma<__half>(q, k, v, o, B, Sq, Sk, Hq, Hkv, Dk, Dv, scale, causal,
                                       window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
