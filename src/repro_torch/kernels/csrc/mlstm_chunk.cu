// Chunkwise mLSTM (the xLSTM matrix-memory cell) for Hopper.
//
// Replaces the TPU kernel repro/kernels/mlstm_chunk.py: chunked_mlstm (its
// pallas_call).  Plain version: repro_torch/kernels/ref.py: mlstm_chunked.
//
// Layout is the JAX one: q, k, v, out (B, L, H, D), contiguous, one dtype
// (f32, bf16 or f16), 1 <= D <= 512; the log input gate li and the log
// forget gate lf (B, L, H), contiguous f32.  Any L >= 1.
//
// What it computes, chunk by chunk along L (F = cumulative lf within the
// chunk, q already scaled by D^-1/2):
//   logw[t, s] = F_t - F_s + li_s for s <= t
//   m_t        = max(m_in + F_t, max_s logw[t, s])
//   P[t, s]    = (q_t . k_s) exp(logw[t, s] - m_t)
//   inter_t    = exp(m_in + F_t - m_t)
//   out_t      = (inter_t q_t C_in + sum_s P[t, s] v_s)
//                / max(|inter_t q_t . n_in + sum_s P[t, s]|, exp(-m_t))
// and carries the (D, D) memory C, the (D,) normalizer n and the scalar
// stabilizer m into the next chunk:
//   m_out = max(m_in + F_C, max_s (F_C - F_s + li_s)),  w_s = exp(F_C - F_s + li_s - m_out)
//   C     = exp(m_in + F_C - m_out) C_in + sum_s w_s k_s^T v_s,  n likewise with k_s.
//
// Design.  The TPU kernel keeps the whole (D, D) f32 state in VMEM scratch
// and walks the chunks as a sequential grid axis.  Here the chunk walk is a
// loop inside each block, and the state does not fit: at D = 384 it is
// 576 KB against 227 KB of shared memory.  So the value dimension is split:
// block (v-tile, h, b) owns the 64 columns C[:, j0:j0+64] (D x 64 f32, 96 KB
// at D = 384), its own copy of n and m, and the output columns of its tile.
// Every block of a (b, h) recomputes q k^T, the weights and the denominator,
// which do not depend on v: D / 64 times the score work, the price of holding
// the state on chip.  At the serving shape (B 32, L 128, H 4, D 384) that is
// 768 blocks of 256 threads, one per SM at a time (about 152 KB of shared
// memory each).
//
// Within a chunk of kC = 64 rows (fewer in a ragged last one), each thread
// owns a 4 x 4 tile of the (C, C) scores and of the (C, 64) output: the
// d-contraction runs over 32-wide slices of q and k staged transposed in
// shared memory and converted to f32 once, and the carried term q C_in rides
// the same loop.  Row maxima and sums are warp shuffles over the 16 threads
// of a row group.  The state update stages k (times its outgoing weight) in
// 64-wide slices and adds k^T v into the block's columns of C.  Every tile
// goes from device memory into registers first and into shared memory after
// the products before it, so the next slice's loads are in flight while this
// one is multiplied. The first chunk has no carried state (m_in = -1e30, so
// inter_t = 0) and skips those terms; the last chunk does not update the
// state, which the kernel does not return.  A ragged last chunk masks its
// padded rows: they are never written and, being last, add nothing to any
// state.
//
// Bound on this card: bytes.  Each (b, h, chunk of C rows) does 2 D flops
// for each of q k^T and P V over the chunk's C (C + 1) / 2 causal pairs, plus
// 2 C D^2 each for q C_in and the update when a state is carried.  At the
// serving shape (B 32, L 128, H 4, D 384, bf16) that is 1.6 us at the card's
// bf16 tensor-core rate (989 TFLOP/s) against 15 us to move q, k, v and out
// at 3.35 TB/s.  This first version runs f32 FMAs on the CUDA cores
// (67 TFLOP/s) over whole (C, C) score tiles and recomputes them D / 64
// times, so it sits far above that bound.  Tensor cores (mma.sync / wgmma)
// for the bf16 products, and sharing the scores across the v-tile blocks of
// a cluster, are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's mask fill, not -inf
constexpr int kC = 64;             // most rows per chunk
constexpr int kVT = 64;            // value columns per block
constexpr int kDS = 32;            // head dims per staged q / k slice (scores)
constexpr int kDU = 64;            // head dims per staged k slice (state update)
constexpr int kQS = kC + 4;        // row stride (floats) of the transposed slices and of P^T
constexpr int kKS = kDU + 4;       // row stride (floats) of the update's k slice
constexpr int kThreads = 256;      // 16 x 16 threads, each a 4 x 4 tile
constexpr int kMaxDim = 512;
constexpr size_t kSmemLimit = 232448;  // bytes one block may use on the H100

static_assert(kC * kKS == 2 * kDS * kQS, "the update's k slice aliases the two score slices");

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

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// floats of dynamic shared memory for head dimension D
__host__ __device__ constexpr int smem_floats(int D) {
  return round_up(D, kDU) * (kVT + 1)  // C[:, tile] and n
         + 2 * kDS * kQS               // q^T, k^T slices (the update's k slice)
         + kC * kQS                    // P^T
         + kC * kVT                    // v tile
         + 3 * kC + 4;                 // F, li, outgoing weights, m_out and decay
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// the scores S = q k^T of one d-slice, and with a carried state also the
// slice's share of q C_in (nacc) and of q . n_in (qn)
template <bool kState>
__device__ __forceinline__ void score_slice(const float* qT, const float* kT, const float* Cs,
                                            const float* nv, int d0, int ty, int tx,
                                            float (&sacc)[4][4], float (&nacc)[4][4],
                                            float (&qn)[4]) {
#pragma unroll 4
  for (int d = 0; d < kDS; ++d) {
    const float4 a = ld4(qT + d * kQS + ty * 4);
    fma4x4(sacc, a, ld4(kT + d * kQS + tx * 4));
    if (kState) {
      fma4x4(nacc, a, ld4(Cs + (d0 + d) * kVT + tx * 4));
      const float nd = nv[d0 + d];
      qn[0] = fmaf(a.x, nd, qn[0]);
      qn[1] = fmaf(a.y, nd, qn[1]);
      qn[2] = fmaf(a.z, nd, qn[2]);
      qn[3] = fmaf(a.w, nd, qn[3]);
    }
  }
}

// Each thread's share of a (kC x cols) tile of one of q, k, v: elements
// i = tid + r * kThreads for r < N, at row i / cols and column i % cols of
// the chunk, read raw (converted when stored) so that the loads stay in
// flight until the values are needed.  Rows past cv and columns past ncol
// read as 0.
template <int kCols, typename T>
struct Tile {
  static constexpr int N = kC * kCols / kThreads;
  T raw[N];

  __device__ __forceinline__ void load(const T* __restrict__ src, long long rs, int t0, int cv, int c0,
                                       int ncol, int tid) {
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const int i = tid + r * kThreads, t = i / kCols, c = i % kCols;
      raw[r] = (t < cv && c0 + c < ncol) ? src[(long long)(t0 + t) * rs + c0 + c] : from_f32<T>(0.f);
    }
  }
  __device__ __forceinline__ float get(int r) const { return to_f32(raw[r]); }
  __device__ __forceinline__ static int row(int r, int tid) { return (tid + r * kThreads) / kCols; }
  __device__ __forceinline__ static int col(int r, int tid) { return (tid + r * kThreads) % kCols; }
};

// grid (ceil(D / kVT), H, B), kThreads threads, smem_floats(D) * 4 bytes
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    mlstm_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const float* __restrict__ li, const float* __restrict__ lf,
                       T* __restrict__ out, int L, int H, int D, float scale) {
  extern __shared__ float4 smem4[];
  float* const Cs = reinterpret_cast<float*>(smem4);  // Dp x kVT: the block's columns of C
  const int Dp = round_up(D, kDU);
  float* const nv = Cs + Dp * kVT;       // Dp: the normalizer n
  float* const qT = nv + Dp;             // kDS x kQS: q slice, [d][t], scaled
  float* const kT = qT + kDS * kQS;      // kDS x kQS: k slice, [d][s]
  float* const ks = qT;                  // kC x kKS: update's k slice, [s][d], aliases qT and kT
  float* const PT = kT + kDS * kQS;      // kC x kQS: P^T, [s][t]
  float* const vs = PT + kC * kQS;       // kC x kVT: v tile, [s][j]
  float* const Fs = vs + kC * kVT;       // kC: cumulative log forget within the chunk
  float* const lis = Fs + kC;            // kC: log input gate
  float* const wo = lis + kC;            // kC: weight of row s in the outgoing state
  float* const carry = wo + kC;          // [0] m_out, [1] decay of the carried state

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;  // rows ty*4.., columns tx*4..
  const int j0 = blockIdx.x * kVT, h = blockIdx.y, b = blockIdx.z;
  const int nj = min(kVT, D - j0);
  const long long rs = (long long)H * D;  // elements between rows t and t + 1
  const long long base = (long long)b * L * rs + (long long)h * D;
  const T* const qb = q + base;
  const T* const kb = k + base;
  const T* const vb = v + base;
  T* const ob = out + base;
  const float* const lib = li + (long long)b * L * H + h;
  const float* const lfb = lf + (long long)b * L * H + h;

  for (int i = tid; i < Dp * (kVT + 1); i += kThreads) Cs[i] = 0.f;  // C and n
  float m_in = kNegInf;
  const int n_chunks = (L + kC - 1) / kC;

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kC;
    const int cv = min(kC, L - t0);  // live rows of this chunk
    const bool has_state = c > 0;

    // gates; F by an inclusive warp scan, two rows a lane
    if (warp == 0) {
      const int r0 = 2 * lane, r1 = r0 + 1;
      const float f0 = r0 < cv ? lfb[(long long)(t0 + r0) * H] : 0.f;
      const float f1 = r1 < cv ? lfb[(long long)(t0 + r1) * H] : 0.f;
      float incl = f0 + f1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      Fs[r0] = excl + f0;
      Fs[r1] = (excl + f0) + f1;
      lis[r0] = r0 < cv ? lib[(long long)(t0 + r0) * H] : kNegInf;
      lis[r1] = r1 < cv ? lib[(long long)(t0 + r1) * H] : kNegInf;
    }

    // ---- scores, and the carried terms q C_in and q . n_in; the next
    // slice's loads are in flight while this one is multiplied
    float sacc[4][4] = {}, nacc[4][4] = {}, qn[4] = {};
    Tile<kDS, T> qs, ksl;
    qs.load(qb, rs, t0, cv, 0, D, tid);
    ksl.load(kb, rs, t0, cv, 0, D, tid);
    for (int d0 = 0; d0 < D; d0 += kDS) {
#pragma unroll
      for (int r = 0; r < Tile<kDS, T>::N; ++r) {
        const int at = Tile<kDS, T>::col(r, tid) * kQS + Tile<kDS, T>::row(r, tid);
        qT[at] = qs.get(r) * scale;
        kT[at] = ksl.get(r);
      }
      __syncthreads();
      if (d0 + kDS < D) {
        qs.load(qb, rs, t0, cv, d0 + kDS, D, tid);
        ksl.load(kb, rs, t0, cv, d0 + kDS, D, tid);
      }
      if (has_state)
        score_slice<true>(qT, kT, Cs, nv, d0, ty, tx, sacc, nacc, qn);
      else
        score_slice<false>(qT, kT, Cs, nv, d0, ty, tx, sacc, nacc, qn);
      __syncthreads();
    }
    Tile<kVT, T> vt;  // this block's value columns of the chunk
    vt.load(vb, rs, t0, cv, j0, D, tid);

    // ---- weights, stabilizer and denominator of this thread's 4 rows
    float den[4], inter[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty * 4 + i;
      const float Ft = Fs[t];
      float lw[4];
      float mx = m_in + Ft;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = tx * 4 + j;
        lw[j] = (s <= t && t < cv) ? Ft - Fs[s] + lis[s] : kNegInf;
        mx = fmaxf(mx, lw[j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = tx * 4 + j;
        const float p = (s <= t && t < cv) ? sacc[i][j] * expf(lw[j] - mx) : 0.f;
        sacc[i][j] = p;
        rowsum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rowsum += __shfl_xor_sync(0xffffffffu, rowsum, o);
      inter[i] = has_state ? expf(m_in + Ft - mx) : 0.f;
      den[i] = fmaxf(fabsf(inter[i] * qn[i] + rowsum), expf(-mx));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(PT + (tx * 4 + j) * kQS + ty * 4) =
          make_float4(sacc[0][j], sacc[1][j], sacc[2][j], sacc[3][j]);
#pragma unroll
    for (int r = 0; r < Tile<kVT, T>::N; ++r) vs[tid + r * kThreads] = vt.get(r);
    __syncthreads();

    // ---- out = (inter q C_in + P v) / den; warp w holds rows 8w..8w+7, so
    // no row of it sees a key past 8w + 7
    {
      float num[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) num[i][j] = inter[i] * nacc[i][j];
      const int s_end = min(cv, warp * 8 + 8);
#pragma unroll 4
      for (int s = 0; s < s_end; ++s)
        fma4x4(num, ld4(PT + s * kQS + ty * 4), ld4(vs + s * kVT + tx * 4));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty * 4 + i;
        if (t >= cv) continue;
        T* const orow = ob + (long long)(t0 + t) * rs + j0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (tx * 4 + j < nj) orow[tx * 4 + j] = from_f32<T>(num[i][j] / den[i]);
      }
    }
    if (c + 1 == n_chunks) break;

    // ---- carry the state across the chunk boundary (cv == kC here)
    Tile<kDU, T> kt;
    kt.load(kb, rs, t0, cv, 0, D, tid);
    if (warp == 0) {
      const float FC = Fs[cv - 1];
      const int r0 = 2 * lane, r1 = r0 + 1;
      const float d0v = r0 < cv ? FC - Fs[r0] + lis[r0] : kNegInf;
      const float d1v = r1 < cv ? FC - Fs[r1] + lis[r1] : kNegInf;
      float mx = fmaxf(m_in + FC, fmaxf(d0v, d1v));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      wo[r0] = r0 < cv ? expf(d0v - mx) : 0.f;
      wo[r1] = r1 < cv ? expf(d1v - mx) : 0.f;
      if (lane == 0) {
        carry[0] = mx;
        carry[1] = expf(m_in + FC - mx);
      }
    }
    __syncthreads();
    const float decay = carry[1];
    for (int d0 = 0; d0 < D; d0 += kDU) {
#pragma unroll
      for (int r = 0; r < Tile<kDU, T>::N; ++r) {
        const int s = Tile<kDU, T>::row(r, tid);
        ks[s * kKS + Tile<kDU, T>::col(r, tid)] = kt.get(r) * wo[s];
      }
      __syncthreads();
      if (d0 + kDU < D) kt.load(kb, rs, t0, cv, d0 + kDU, D, tid);
      float acc[4][4] = {};
#pragma unroll 4
      for (int s = 0; s < cv; ++s) fma4x4(acc, ld4(ks + s * kKS + ty * 4), ld4(vs + s * kVT + tx * 4));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4* const row = reinterpret_cast<float4*>(Cs + (d0 + ty * 4 + i) * kVT + tx * 4);
        float4 cur = *row;
        cur.x = fmaf(decay, cur.x, acc[i][0]);
        cur.y = fmaf(decay, cur.y, acc[i][1]);
        cur.z = fmaf(decay, cur.z, acc[i][2]);
        cur.w = fmaf(decay, cur.w, acc[i][3]);
        *row = cur;
      }
      if (tid < kDU) {
        float sn = 0.f;
        for (int s = 0; s < cv; ++s) sn += ks[s * kKS + tid];
        nv[d0 + tid] = fmaf(decay, nv[d0 + tid], sn);
      }
      __syncthreads();
    }
    m_in = carry[0];
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* li, const float* lf,
                   void* out, int B, int L, int H, int D, float scale,
                   cudaStream_t stream) {
  auto kernel = mlstm_chunk_kernel<T>;
  const size_t smem = (size_t)smem_floats(D) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((D + kVT - 1) / kVT, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), li, lf, static_cast<T*>(out),
                                           L, H, D, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, 2 = f16.  Chunks of kC rows.
// Returns the cudaError_t of the launch (0 on success); the caller raises on
// anything else.
extern "C" int mlstm_chunk_fwd(const void* q, const void* k, const void* v, const void* li,
                               const void* lf, void* out, int dtype, int B, int L, int H, int D,
                               float scale, void* stream) {
  if (B < 1 || L < 1 || H < 1 || D < 1 || D > kMaxDim || B > 65535 ||
      H > 65535 || (size_t)smem_floats(D) * sizeof(float) > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const auto* lif = static_cast<const float*>(li);
  const auto* lff = static_cast<const float*>(lf);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(q, k, v, lif, lff, out, B, L, H, D, scale, s);
    case 1: return (int)launch<__nv_bfloat16>(q, k, v, lif, lff, out, B, L, H, D, scale, s);
    case 2: return (int)launch<__half>(q, k, v, lif, lff, out, B, L, H, D, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
