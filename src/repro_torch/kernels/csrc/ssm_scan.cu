// Selective scan (the Mamba SSM core) for Hopper.
//
// Replaces the TPU kernel repro/kernels/ssm_scan.py: chunked_selective_scan
// (its pallas_call).  Plain version: repro_torch/kernels/ref.py:
// selective_scan.
//
// What it computes, for every (b, d) and t = 0 .. L-1, from h = h0[b, :, d]
// (zeros without h0):
//   a_n   = exp(dt[b, t, d] * A[d, n])
//   h_n   = a_n h_n + (dt[b, t, d] x[b, t, d]) B[b, t, n]
//   y[b, t, d] = sum_n h_n C[b, t, n]
// and h_last[b, n, d] = h_n after the last step.  The D x skip is not here:
// the Mamba block adds it (repro/models/ssm.py:91), as the TPU kernel's code
// does (its docstring says it fuses the skip; it does not).
//
// Layouts are the JAX ones.  x, dt, y (B, L, D) contiguous; B, C (B, L, N)
// with any batch and time strides (in elements) and a unit last stride, so
// Mamba's column slices of one projection pass as they are; A (D, N)
// contiguous f32; h0, h_last (B, N, D) contiguous f32.  x is f32, bf16 or f16; dt, B and C are f32 or
// x's type (all three the same).  1 <= N <= 16, any L >= 1, any D >= 1.
//
// Design.  The TPU kernel walks L as a sequential grid axis over chunks of
// 128 with the whole (N, D) state of a sequence in VMEM, one vector lane per
// channel.  Here the recurrence is independent per channel, so each thread
// owns one channel d of one sequence: its N states and its row of A (times
// log2 e) live in registers, the walk over L is a loop inside the thread,
// and y_t is a sum over N in registers; no reduction crosses threads.  A
// block is TD = 32, 64 or 128 consecutive channels of one sequence; the
// host picks the widest tile that still gives two blocks per SM (at B = 1,
// D = 8192, tiles of 32: 256 blocks).  The walk goes kT steps at a time:
// each thread loads its kT values of x and dt into registers, and the first
// 32 threads load the kT rows of B and C (shared by every channel) into
// registers and then into a double-buffered shared-memory tile.  The loads
// of the next kT steps are issued before the arithmetic of this one, so
// they are in flight while it runs; one barrier per kT steps hands the B
// and C tile over.  A whole chunk of kT steps runs without a per-step test,
// so the compiler can overlap one step's sum over N with the next step's
// exponentials.  Registers are capped at 128 a thread so that four 128-thread
// blocks share an SM (uncapped, the compiler takes ~170 and two or three
// fit): that costs a few spilled words, and measured faster at the serving
// shape and at the decode fill, though not at b = 1.  Padded states
// (n >= N) have A = B = C = 0 and stay 0.
//
// Bound on this card.  Bytes: at the serving shape (B 32, L 128, D 8192,
// N 16; x and y bf16, dt, B and C f32, no h0) 285.7 MB move, 85 us at
// 3.35 TB/s.  Operations: about 8 f32 operations per (b, t, d, n), 4.3
// GFLOP, 64 us at 67 TFLOP/s; but each (b, t, d, n) also needs one
// exponential, 537M of them, which the SFUs issue at 16 a clock per SM:
// about 0.13 ms.  So the exponentials, not the bytes, are likely to set the
// pace of this design.  Computing part of them with FMA polynomials, to
// share the load between the SFUs and the FMA pipes, is later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kT = 8;           // time steps per staged chunk
constexpr int kMaxTile = 128;   // channels per block, at most
constexpr int kBlocksPerSM = 4;  // caps registers at 128 a thread (tools/scan_launch_bounds.py)
constexpr int kStagers = 32;    // threads that stage B and C
constexpr float kLog2e = 1.4426950408889634f;

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

// 2^x on the SFU (flushes results below 2^-126 to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct Strides {  // of B and C, in elements
  long long b_b, b_t, c_b, c_t;
};

// NP: N padded to 8 or 16.  T: x's and y's type; TP: dt's, B's and C's.
template <typename T, typename TP, int NP>
__global__ void __launch_bounds__(kMaxTile, kBlocksPerSM) selective_scan_kernel(
    const T* __restrict__ x, const TP* __restrict__ dt, const float* __restrict__ A,
    const TP* __restrict__ Bm, const TP* __restrict__ Cm, const float* __restrict__ h0,
    T* __restrict__ y, float* __restrict__ h_last, int L, int D, int N, Strides st) {
  constexpr int kBC = kT * 2 * NP;          // B and C values per chunk: row t holds B then C
  constexpr int kPer = kBC / kStagers;      // of them per staging thread
  static_assert(kBC % kStagers == 0, "B/C tile splits evenly over the staging threads");
  __shared__ __align__(16) float bc[2][kBC];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d = blockIdx.x * blockDim.x + tid;
  const bool live = d < D;
  const bool stager = tid < kStagers;

  const long long row0 = (long long)b * L * D + (live ? d : 0);  // (b, 0, d) of x, dt and y
  const T* xb = x + row0;
  const TP* db = dt + row0;
  const TP* Bb = Bm + b * st.b_b;
  const TP* Cb = Cm + b * st.c_b;
  T* yb = y + row0;

  float a2[NP], h[NP];
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    const bool on = live && n < N;
    a2[n] = on ? A[(long long)d * N + n] * kLog2e : 0.f;
    h[n] = (on && h0 != nullptr) ? h0[((long long)b * N + n) * D + d] : 0.f;
  }

  float xr[kT], dr[kT], bcr[kPer];
  // issue the loads of steps t0 .. t0 + kT - 1 into registers
  auto load = [&](int t0) {
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      const int t = t0 + i;
      const bool on = live && t < L;
      xr[i] = on ? to_f32(xb[(long long)t * D]) : 0.f;
      dr[i] = on ? to_f32(db[(long long)t * D]) : 0.f;
    }
    if (stager) {
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int j = tid + r * kStagers;
        const int t = t0 + j / (2 * NP);
        const int c = j % (2 * NP);
        const int n = c < NP ? c : c - NP;
        float v = 0.f;
        if (t < L && n < N) v = to_f32(c < NP ? Bb[t * st.b_t + n] : Cb[t * st.c_t + n]);
        bcr[r] = v;
      }
    }
  };
  auto stash = [&](int buf) {
    if (stager) {
#pragma unroll
      for (int r = 0; r < kPer; ++r) bc[buf][tid + r * kStagers] = bcr[r];
    }
  };

  // one step: update the N states and return y_t; B_t and C_t come as
  // 16-byte shared-memory loads, and y_t is summed in two halves
  auto step = [&](const float* row, float dtv, float xv) {
    const float dbx = dtv * xv;
    float bv[NP], cv[NP];
#pragma unroll
    for (int q = 0; q < NP / 4; ++q) {
      const float4 b4 = reinterpret_cast<const float4*>(row)[q];
      const float4 c4 = reinterpret_cast<const float4*>(row + NP)[q];
      bv[4 * q] = b4.x, bv[4 * q + 1] = b4.y, bv[4 * q + 2] = b4.z, bv[4 * q + 3] = b4.w;
      cv[4 * q] = c4.x, cv[4 * q + 1] = c4.y, cv[4 * q + 2] = c4.z, cv[4 * q + 3] = c4.w;
    }
    float acc[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      h[n] = fmaf(ex2(dtv * a2[n]), h[n], dbx * bv[n]);
      acc[n & 1] = fmaf(h[n], cv[n], acc[n & 1]);
    }
    return acc[0] + acc[1];
  };

  load(0);
  stash(0);
  __syncthreads();
  int buf = 0;
  for (int t0 = 0; t0 < L; t0 += kT) {
    float xc[kT], dc[kT];
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      xc[i] = xr[i];
      dc[i] = dr[i];
    }
    const bool more = t0 + kT < L;
    if (more) load(t0 + kT);  // in flight during this chunk's arithmetic
    const float* tile = bc[buf];
    if (t0 + kT <= L) {  // a whole chunk: no per-step test, so steps can overlap
#pragma unroll
      for (int i = 0; i < kT; ++i) {
        const float yv = step(tile + i * 2 * NP, dc[i], xc[i]);
        if (live) yb[(long long)(t0 + i) * D] = from_f32<T>(yv);
      }
    } else {  // the ragged last chunk
      const int steps = L - t0;
#pragma unroll
      for (int i = 0; i < kT; ++i) {
        if (i < steps) {
          const float yv = step(tile + i * 2 * NP, dc[i], xc[i]);
          if (live) yb[(long long)(t0 + i) * D] = from_f32<T>(yv);
        }
      }
    }
    if (more) {
      stash(buf ^ 1);  // the other buffer was last read before the previous barrier
      __syncthreads();
      buf ^= 1;
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < NP; ++n)
      if (n < N) h_last[((long long)b * N + n) * D + d] = h[n];
  }
}

template <typename T, typename TP, int NP>
cudaError_t launch(const void* x, const void* dt, const float* A, const void* Bm, const void* Cm,
                   const float* h0, void* y, float* h_last, int B, int L, int D, int N,
                   const Strides& st, cudaStream_t stream) {
  int dev = 0, sms = 132;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  // the widest tile that still gives every SM two blocks
  int td = kMaxTile;
  while (td > 32 && (long long)B * ((D + td - 1) / td) < 2LL * sms) td /= 2;
  const dim3 grid((D + td - 1) / td, B);
  selective_scan_kernel<T, TP, NP><<<grid, td, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const TP*>(dt), A, static_cast<const TP*>(Bm),
      static_cast<const TP*>(Cm), h0, static_cast<T*>(y), h_last, L, D, N, st);
  return cudaGetLastError();
}

template <typename T, typename TP>
cudaError_t dispatch_n(const void* x, const void* dt, const float* A, const void* Bm, const void* Cm,
                       const float* h0, void* y, float* h_last, int B, int L, int D, int N,
                       const Strides& st, cudaStream_t stream) {
  if (N <= 8) return launch<T, TP, 8>(x, dt, A, Bm, Cm, h0, y, h_last, B, L, D, N, st, stream);
  return launch<T, TP, 16>(x, dt, A, Bm, Cm, h0, y, h_last, B, L, D, N, st, stream);
}

}  // namespace

// x_dtype: 0 = f32, 1 = bf16, 2 = f16.  p_dtype: 0 = dt, B and C are f32;
// 1 = they are x's type.  h0 may be null (the state starts at zero).
// The strides of B and C are in elements.  Returns the cudaError_t of the launch (0 on
// success); the caller raises on anything else.
extern "C" int selective_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                                  const void* Cm, const void* h0, void* y, void* h_last,
                                  int x_dtype, int p_dtype, int B, int L, int D, int N,
                                  long long b_b, long long b_t, long long c_b, long long c_t,
                                  void* stream) {
  if (B < 1 || B > 65535 || L < 1 || D < 1 || N < 1 || N > 16 || p_dtype < 0 || p_dtype > 1)
    return (int)cudaErrorInvalidValue;
  const Strides st{b_b, b_t, c_b, c_t};
  const auto* Af = static_cast<const float*>(A);
  const auto* h0f = static_cast<const float*>(h0);
  auto* hl = static_cast<float*>(h_last);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (x_dtype * 2 + p_dtype) {
    case 0:
    case 1: return (int)dispatch_n<float, float>(x, dt, Af, Bm, Cm, h0f, y, hl, B, L, D, N, st, s);
    case 2: return (int)dispatch_n<__nv_bfloat16, float>(x, dt, Af, Bm, Cm, h0f, y, hl, B, L, D, N, st, s);
    case 3:
      return (int)dispatch_n<__nv_bfloat16, __nv_bfloat16>(x, dt, Af, Bm, Cm, h0f, y, hl, B, L, D, N, st, s);
    case 4: return (int)dispatch_n<__half, float>(x, dt, Af, Bm, Cm, h0f, y, hl, B, L, D, N, st, s);
    case 5: return (int)dispatch_n<__half, __half>(x, dt, Af, Bm, Cm, h0f, y, hl, B, L, D, N, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
