// Flash-decode for Hopper: one query token per sequence against a KV cache,
// the g = Hq / Hkv grouped queries of a KV head sharing one pass over it.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py: flash_decode
// (its pallas_call).  Plain version: repro_torch/kernels/ref.py:
// decode_attention.
//
// Layout is the JAX one: q (B, Hq, Dk), k (B, S, Hkv, Dk), v (B, S, Hkv, Dv),
// lengths (B,) int32 on the device, out (B, Hq, Dv); all contiguous, one
// dtype (f32, bf16 or f16), 1 <= Dk, Dv <= 576 (MLA's absorbed decode uses
// Dk 576 / Dv 512).  Slot pos of row b is live when pos < lengths[b] and,
// given a window, pos >= lengths[b] - window.
//
// Bound on this card: bytes.  Every live cache row is read once and meets g
// queries, about g flops per cache byte in bf16, far below the ~295 flop/B
// where the tensor cores would set the limit; f32 FMAs on the CUDA cores keep
// up, and the design is about keeping enough bytes in flight:
//
// * Pass 1, grid (B * Hkv, splits).  The TPU kernel's sequential KV grid axis
//   becomes a loop inside the block, and a split axis cuts the cache into
//   contiguous row ranges, because B * Hkv blocks alone (5 for smollm at
//   batch 1, 1 for gemma3) leave most of the 132 SMs idle.  The split count
//   comes from S, B * Hkv and the SM count, never from the values in
//   `lengths`, which stay on the device (so the call can be captured in a
//   CUDA graph).  A block clips its range to the live interval
//   [max(0, len - window), len) and visits no row outside it.  It stages
//   tiles of 32 * NW rows of K and V in shared memory with 16-byte cp.async
//   copies, double buffered so that the next tile is in flight while this
//   one is scored.  Each of the NW warps takes 32 rows of the tile, one per
//   lane, scores them against the chunk's queries in f32 and keeps its own
//   running max, sum and accumulator; the warps are merged at the end and
//   the block writes its partial (m, l, acc[g, Dv]) to an f32 workspace.
// * Pass 2, one block per (b, query head), on the same stream: merges the
//   splits and writes acc / max(l, 1e-30) in the input type, the JAX
//   finalize, so a split with no live row adds nothing and length 0 gives 0.
//   With one split, pass 1 writes the output itself and pass 2 does not run.
//
// Queries go QC at a time (QC in {1, 4, 16}, the smallest >= g that the
// accumulator registers allow).  When g needs more than one chunk (MLA's
// absorbed decode: g = 128, Dv = 512) every split is one tile, which stays in
// shared memory while the block loops over the chunks, so the cache is still
// read from device memory once.  Inputs that are not 16-byte aligned, or rows
// whose bytes are not a multiple of 16, are staged element by element into the
// same tiles.  Tensor cores (for MLA's g = 128) and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;     // the reference's mask fill, not -inf
constexpr int kMaxDim = 576;
constexpr size_t kSmemLimit = 232448;       // bytes one block may use on the H100
constexpr size_t kSmemTarget = 110 * 1024;  // up to here: two blocks per SM
constexpr int kBlocksPerSm = 4;             // pass-1 blocks the split count aims at

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

// a 32-bit word of T values -> 4 / sizeof(T) floats
__device__ __forceinline__ void unpack_word(uint32_t w, float* f, float) { f[0] = __uint_as_float(w); }
__device__ __forceinline__ void unpack_word(uint32_t w, float* f, __nv_bfloat16) {
  __nv_bfloat162 h;
  *reinterpret_cast<uint32_t*>(&h) = w;
  const float2 t = __bfloat1622float2(h);
  f[0] = t.x;
  f[1] = t.y;
}
__device__ __forceinline__ void unpack_word(uint32_t w, float* f, __half) {
  __half2 h;
  *reinterpret_cast<uint32_t*>(&h) = w;
  const float2 t = __half22float2(h);
  f[0] = t.x;
  f[1] = t.y;
}

// a 16-byte chunk of T values -> 16 / sizeof(T) floats
template <typename T>
__device__ __forceinline__ void unpack_chunk(const uint4& c, float* f) {
  constexpr int E = 4 / sizeof(T);
  unpack_word(c.x, f, T());
  unpack_word(c.y, f + E, T());
  unpack_word(c.z, f + 2 * E, T());
  unpack_word(c.w, f + 3 * E, T());
}

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* out;
  float* ws;  // [splits][B * Hq][Dv] accumulators, then [splits][B * Hq][2] (m, l)
  int B, S, Hq, Hkv, Dk, Dv, g;
  float scale;
  int window;          // < 0: none
  int rows_per_split;  // a whole number of tiles
  int splits;
  int n_chunks;        // query chunks of QC per KV head
  int stages;          // tile buffers: 2, or 1 when the tile stays resident
  int vec;             // stage with 16-byte cp.async copies
  int dk16, dv16;      // 16-byte chunks per row of K and of V (the last one padded)
  int ks16;            // shared-memory row stride of K in chunks (odd: no bank conflicts)
};

// DVW = NACC / (4 / sizeof(T)) 32-bit words of each V row per lane; lane owns
// the columns of words lane + 32 w.
template <typename T, int QC, int NACC>
__global__ void __launch_bounds__(128)
flash_decode_split_kernel(const Params p) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int E = 4 / sizeof(T);     // elements per 32-bit word
  constexpr int DVW = NACC / E;
  constexpr int ACOLS = 32 * NACC;     // accumulator columns a warp holds
  extern __shared__ __align__(16) unsigned char smem[];

  const int nw = blockDim.x >> 5;
  const int rows = 32 * nw;  // rows per tile
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / p.Hkv;
  const int hk = blockIdx.x - b * p.Hkv;
  const int split = blockIdx.y;

  const int qs_stride = p.dk16 * EPC;  // floats per staged query row
  float* qs = reinterpret_cast<float*>(smem);                        // [QC][qs_stride]
  uint4* tiles = reinterpret_cast<uint4*>(qs + QC * qs_stride);      // stages x (K, V)
  const int tile16 = rows * (p.ks16 + p.dv16);
  float* rm = reinterpret_cast<float*>(tiles + p.stages * tile16);  // [nw][QC]
  float* rl = rm + nw * QC;                                          // [nw][QC]
  float* ra = rl + nw * QC;                                          // [nw][QC][ACOLS]

  const int len = min(max(p.lengths[b], 0), p.S);
  const int lo = p.window >= 0 ? max(0, len - p.window) : 0;
  const int r_begin = max(lo, split * p.rows_per_split);
  const int r_end = min(len, (split + 1) * p.rows_per_split);
  const int n_tiles = r_end > r_begin ? (r_end - r_begin + rows - 1) / rows : 0;

  const T* kb = static_cast<const T*>(p.k);
  const T* vb = static_cast<const T*>(p.v);
  auto stage = [&](int t, int buf) {
    const int r0 = r_begin + t * rows;
    const int nr = min(rows, r_end - r0);
    uint4* ks = tiles + buf * tile16;
    uint4* vs = ks + rows * p.ks16;
    const int64_t row0 = ((int64_t)b * p.S + r0) * p.Hkv + hk;  // (b, r0, hk)
    if (p.vec) {
      for (int i = tid; i < nr * p.dk16; i += blockDim.x) {
        const int r = i / p.dk16;
        const int c = i - r * p.dk16;
        cp_async16(ks + r * p.ks16 + c, kb + (row0 + (int64_t)r * p.Hkv) * p.Dk + c * EPC);
      }
      for (int i = tid; i < nr * p.dv16; i += blockDim.x) {
        const int r = i / p.dv16;
        const int c = i - r * p.dv16;
        cp_async16(vs + r * p.dv16 + c, vb + (row0 + (int64_t)r * p.Hkv) * p.Dv + c * EPC);
      }
    } else {  // element by element; the padding of the last chunk is zero
      T* kst = reinterpret_cast<T*>(ks);
      T* vst = reinterpret_cast<T*>(vs);
      const int kw = p.dk16 * EPC;
      const int vw = p.dv16 * EPC;
      for (int i = tid; i < nr * kw; i += blockDim.x) {
        const int r = i / kw;
        const int d = i - r * kw;
        kst[r * p.ks16 * EPC + d] =
            d < p.Dk ? kb[(row0 + (int64_t)r * p.Hkv) * p.Dk + d] : from_f32<T>(0.f);
      }
      for (int i = tid; i < nr * vw; i += blockDim.x) {
        const int r = i / vw;
        const int d = i - r * vw;
        vst[r * vw + d] = d < p.Dv ? vb[(row0 + (int64_t)r * p.Hkv) * p.Dv + d] : from_f32<T>(0.f);
      }
    }
  };

  const int64_t BH = (int64_t)p.B * p.Hq;
  const T* qb = static_cast<const T*>(p.q) + ((int64_t)b * p.Hq + (int64_t)hk * p.g) * p.Dk;
  for (int ch = 0; ch < p.n_chunks; ++ch) {
    const int q0 = ch * QC;  // the chunk's first query within the group
    for (int i = tid; i < QC * qs_stride; i += blockDim.x) {
      const int r = i / qs_stride;
      const int d = i - r * qs_stride;
      qs[i] = (q0 + r < p.g && d < p.Dk) ? to_f32(qb[(int64_t)(q0 + r) * p.Dk + d]) : 0.f;
    }
    float m[QC], l[QC], acc[QC][NACC];
#pragma unroll
    for (int r = 0; r < QC; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[r][i] = 0.f;
    }

    for (int t = 0; t < n_tiles; ++t) {
      if (ch == 0) {  // with more chunks, the split's one tile stays resident
        if (t == 0 || p.stages == 1) {
          stage(t, t % p.stages);
          cp_async_commit();
        }
        if (p.stages == 2 && t + 1 < n_tiles) {
          stage(t + 1, (t + 1) & 1);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
      }
      __syncthreads();  // tile t and the queries are visible to every warp

      const uint4* ks = tiles + (t % p.stages) * tile16;
      const uint4* vs = ks + rows * p.ks16;
      const int nv = min(32, r_end - (r_begin + t * rows + 32 * warp));  // this warp's live rows
      if (nv > 0) {
        // lane j scores row 32 * warp + j of the tile against the chunk's queries
        float s[QC];
#pragma unroll
        for (int r = 0; r < QC; ++r) s[r] = 0.f;
        const uint4* kr = ks + (32 * warp + lane) * p.ks16;
        for (int c = 0; c < p.dk16; ++c) {
          float kf[EPC];
          unpack_chunk<T>(kr[c], kf);
#pragma unroll
          for (int r = 0; r < QC; ++r) {
            const float4* qv = reinterpret_cast<const float4*>(qs + r * qs_stride + c * EPC);
#pragma unroll
            for (int e = 0; e < EPC / 4; ++e) {
              const float4 qq = qv[e];
              s[r] = fmaf(qq.x, kf[4 * e], s[r]);
              s[r] = fmaf(qq.y, kf[4 * e + 1], s[r]);
              s[r] = fmaf(qq.z, kf[4 * e + 2], s[r]);
              s[r] = fmaf(qq.w, kf[4 * e + 3], s[r]);
            }
          }
        }
        const bool live = lane < nv;
#pragma unroll
        for (int r = 0; r < QC; ++r) {
          const float sr = live ? s[r] * p.scale : kNegInf;
          const float m_new = fmaxf(m[r], warp_max(sr));
          const float alpha = expf(m[r] - m_new);
          s[r] = live ? expf(sr - m_new) : 0.f;  // now the probability numerator
          l[r] = l[r] * alpha + warp_sum(s[r]);
          m[r] = m_new;
#pragma unroll
          for (int i = 0; i < NACC; ++i) acc[r][i] *= alpha;
        }
        // acc += P . V over the warp's live rows
        const uint32_t* vw = reinterpret_cast<const uint32_t*>(vs + 32 * warp * p.dv16);
        const int row_words = 4 * p.dv16;
        for (int j = 0; j < nv; ++j) {
          float vv[NACC];
#pragma unroll
          for (int w = 0; w < DVW; ++w) {
            const int word = lane + 32 * w;
            unpack_word(word < row_words ? vw[j * row_words + word] : 0u, vv + w * E, T());
          }
#pragma unroll
          for (int r = 0; r < QC; ++r) {
            const float pj = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
            for (int i = 0; i < NACC; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
          }
        }
      }
      __syncthreads();  // tile t consumed before its buffer is restaged
    }

    // merge the warps: each warp's state rescaled to the block's max
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < QC; ++r) {
        rm[warp * QC + r] = m[r];
        rl[warp * QC + r] = l[r];
      }
    }
#pragma unroll
    for (int r = 0; r < QC; ++r) {
#pragma unroll
      for (int w = 0; w < DVW; ++w) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          ra[(warp * QC + r) * ACOLS + (lane + 32 * w) * E + e] = acc[r][w * E + e];
      }
    }
    __syncthreads();
    for (int i = tid; i < QC * p.Dv; i += blockDim.x) {
      const int r = i / p.Dv;
      const int col = i - r * p.Dv;
      if (q0 + r >= p.g) break;  // i only grows from here
      float M = kNegInf;
      for (int w = 0; w < nw; ++w) M = fmaxf(M, rm[w * QC + r]);
      float L = 0.f, a = 0.f;
      for (int w = 0; w < nw; ++w) {
        const float f = expf(rm[w * QC + r] - M);
        L += f * rl[w * QC + r];
        a += f * ra[(w * QC + r) * ACOLS + col];
      }
      const int64_t row = (int64_t)b * p.Hq + (int64_t)hk * p.g + q0 + r;  // (b, query head)
      if (p.splits == 1) {
        static_cast<T*>(p.out)[row * p.Dv + col] = from_f32<T>(a / fmaxf(L, 1e-30f));
      } else {
        p.ws[((int64_t)split * BH + row) * p.Dv + col] = a;
        if (col == 0) {
          float* ml = p.ws + (int64_t)p.splits * BH * p.Dv + ((int64_t)split * BH + row) * 2;
          ml[0] = M;
          ml[1] = L;
        }
      }
    }
    __syncthreads();  // the merge buffers and the queries are free for the next chunk
  }
}

// Pass 2: one block per (b, query head) merges the splits' partials.
template <typename T>
__global__ void __launch_bounds__(128) flash_decode_merge_kernel(const Params p) {
  const int64_t BH = (int64_t)p.B * p.Hq;
  const int64_t row = blockIdx.x;
  const float* ml = p.ws + (int64_t)p.splits * BH * p.Dv;  // (m, l) of split s at ml[2 (s BH + row)]
  float M = kNegInf;
  for (int s = 0; s < p.splits; ++s) M = fmaxf(M, ml[((int64_t)s * BH + row) * 2]);
  float L = 0.f;
  for (int s = 0; s < p.splits; ++s) {
    const float* e = ml + ((int64_t)s * BH + row) * 2;
    L += expf(e[0] - M) * e[1];
  }
  const float denom = fmaxf(L, 1e-30f);
  for (int col = threadIdx.x; col < p.Dv; col += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < p.splits; ++s)
      a += expf(ml[((int64_t)s * BH + row) * 2] - M) * p.ws[((int64_t)s * BH + row) * p.Dv + col];
    static_cast<T*>(p.out)[row * p.Dv + col] = from_f32<T>(a / denom);
  }
}

struct Plan {
  int qc, nacc, n_chunks, nw, stages, rows_per_split, splits;
  int dk16, dv16, ks16;
  size_t smem;
};

// The launch shape, from the shapes and the SM count alone.  false: unsupported.
bool make_plan(int dtype, int B, int S, int Hq, int Hkv, int Dk, int Dv, int sms, Plan* pl) {
  if (dtype < 0 || dtype > 2 || B < 1 || S < 1 || Hkv < 1 || Hq < 1 || Hq % Hkv != 0 || Dk < 1 ||
      Dk > kMaxDim || Dv < 1 || Dv > kMaxDim || sms < 1)
    return false;
  const int es = dtype == 0 ? 4 : 2;
  const int E = 4 / es;
  const int epc = 16 / es;
  const int g = Hq / Hkv;
  pl->dk16 = (Dk + epc - 1) / epc;
  pl->dv16 = (Dv + epc - 1) / epc;
  pl->ks16 = pl->dk16 | 1;
  const int need = (Dv + 32 * E - 1) / (32 * E) * E;  // accumulator floats per lane and query
  pl->nacc = need <= 2 ? 2 : need <= 4 ? 4 : need <= 8 ? 8 : need <= 16 ? 16 : 18;
  const int qmax = pl->nacc <= 4 ? 16 : 4;  // keeps QC * NACC <= 72 registers
  pl->qc = g <= 1 ? 1 : g <= 4 ? 4 : 16;
  if (pl->qc > qmax) pl->qc = qmax;
  pl->n_chunks = (g + pl->qc - 1) / pl->qc;
  pl->stages = pl->n_chunks > 1 ? 1 : 2;
  auto tile_bytes = [&](int nw) { return (size_t)32 * nw * (pl->ks16 + pl->dv16) * 16; };
  auto fixed_bytes = [&](int nw) {
    return (size_t)pl->qc * pl->dk16 * epc * 4 + (size_t)nw * pl->qc * (2 + 32 * pl->nacc) * 4;
  };
  auto smem = [&](int nw) { return pl->stages * tile_bytes(nw) + fixed_bytes(nw); };
  pl->nw = 0;
  for (int nw = 4; nw >= 1 && !pl->nw; nw >>= 1)
    if (smem(nw) <= kSmemTarget) pl->nw = nw;
  if (!pl->nw) {
    pl->nw = 1;
    if (smem(1) > kSmemLimit) pl->stages = 1;
  }
  pl->smem = smem(pl->nw);
  if (pl->smem > kSmemLimit) return false;
  const int rows = 32 * pl->nw;
  const int n_tiles = (S + rows - 1) / rows;
  int per_split = 1;  // tiles; one when the tile must stay resident across chunks
  if (pl->n_chunks == 1) {
    const int64_t bh = (int64_t)B * Hkv;
    const int64_t want = (kBlocksPerSm * (int64_t)sms + bh - 1) / bh;
    const int splits = (int)(want < n_tiles ? want : n_tiles);
    per_split = (n_tiles + splits - 1) / splits;
  }
  pl->rows_per_split = per_split * rows;
  pl->splits = (n_tiles + per_split - 1) / per_split;
  return pl->splits <= 65535 && (int64_t)B * Hkv <= INT_MAX;
}

template <typename T, int QC, int NACC>
cudaError_t launch_split(const Params& p, const Plan& pl, cudaStream_t stream) {
  auto kernel = flash_decode_split_kernel<T, QC, NACC>;
  if (pl.smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3((unsigned)(p.B * p.Hkv), (unsigned)pl.splits), 32 * pl.nw, pl.smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Params& p, const Plan& pl, cudaStream_t stream) {
  cudaError_t e = cudaErrorInvalidValue;
#define REPRO_FD_CASE(QC, NACC) \
  if (pl.qc == QC && pl.nacc == NACC) e = launch_split<T, QC, NACC>(p, pl, stream);
  REPRO_FD_CASE(1, 2)
  REPRO_FD_CASE(4, 2)
  REPRO_FD_CASE(16, 2)
  REPRO_FD_CASE(1, 4)
  REPRO_FD_CASE(4, 4)
  REPRO_FD_CASE(16, 4)
  REPRO_FD_CASE(1, 8)
  REPRO_FD_CASE(4, 8)
  REPRO_FD_CASE(1, 16)
  REPRO_FD_CASE(4, 16)
  REPRO_FD_CASE(1, 18)
  REPRO_FD_CASE(4, 18)
#undef REPRO_FD_CASE
  if (e != cudaSuccess || pl.splits == 1) return e;
  const int64_t rows = (int64_t)p.B * p.Hq;
  if (rows > INT_MAX) return cudaErrorInvalidConfiguration;
  flash_decode_merge_kernel<T><<<(unsigned)rows, 128, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Floats of f32 workspace flash_decode_fwd needs at these shapes (0 with one
// split), or -1 if it does not take them.
extern "C" long long flash_decode_workspace(int dtype, int B, int S, int Hq, int Hkv, int Dk,
                                            int Dv, int sms) {
  Plan pl;
  if (!make_plan(dtype, B, S, Hq, Hkv, Dk, Dv, sms, &pl)) return -1;
  return pl.splits == 1 ? 0 : (long long)pl.splits * B * Hq * (Dv + 2);
}

// dtype: 0 = f32, 1 = bf16, 2 = f16.  window < 0: no window.  ws holds
// flash_decode_workspace(...) floats.  Returns the cudaError_t of the
// launches (0 on success); the caller raises on anything else.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v, const void* lengths,
                                void* out, void* ws, int dtype, int B, int S, int Hq, int Hkv,
                                int Dk, int Dv, float scale, int window, int sms, void* stream) {
  Plan pl;
  if (!make_plan(dtype, B, S, Hq, Hkv, Dk, Dv, sms, &pl)) return (int)cudaErrorInvalidValue;
  const int es = dtype == 0 ? 4 : 2;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.lengths = static_cast<const int*>(lengths);
  p.out = out;
  p.ws = static_cast<float*>(ws);
  p.B = B;
  p.S = S;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Dk = Dk;
  p.Dv = Dv;
  p.g = Hq / Hkv;
  p.scale = scale;
  p.window = window;
  p.rows_per_split = pl.rows_per_split;
  p.splits = pl.splits;
  p.n_chunks = pl.n_chunks;
  p.stages = pl.stages;
  p.vec = ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 15) == 0 &&
          (Dk * es) % 16 == 0 && (Dv * es) % 16 == 0;
  p.dk16 = pl.dk16;
  p.dv16 = pl.dv16;
  p.ks16 = pl.ks16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(p, pl, s);
    case 1:
      return (int)launch<__nv_bfloat16>(p, pl, s);
    default:
      return (int)launch<__half>(p, pl, s);
  }
}
