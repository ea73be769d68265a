// Mamba2 SSD recurrence with its final state, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_pallas` (`_kernel`) in
// src/repro/kernels/mamba2_ssd/mamba2_ssd.py, and returns what that kernel
// keeps in scratch and drops: the final state, which the prefill hands to
// the decode. Plain version: repro_torch/kernels/mamba2_ssd/ref.py
// `ssd_chunked` (the JAX package's chunked form).
//
// Per (b, h), state S in R^{P x N} from zero, scalar decay per head:
//   S[p,n] <- a_t S[p,n] + (dt_t x_t[p]) B_t[n]     (a clamped to [1e-38, 1])
//   y_t[p]  = sum_n S[p,n] C_t[n]
// B and C are shared by the heads of a batch row.
//
// Bound, at zamba2-7b's prefill (Bz=4, S=512, H=112, P=64, N=64; x, B, C
// bf16, dt, a, y and the state f32): reading every input once and writing
// y and the state once is ~97 MB, 29 us at 3.35 TB/s: bound by bytes. Its
// ~5*Bz*S*H*P*N = 4.7 GFLOP would take 5 us at the tensor cores' 989
// TFLOP/s (the chunked form is matrix products); this kernel runs the
// elementwise recurrence on the CUDA cores, where they need 70 us at the
// 67 TFLOP/s float32 peak: expect at least that.
//
// Design: the per-token recurrence of the reference's `ssd_ref`, the same
// function as the chunked form without exp or log. One block per (b, pair
// of heads) with P threads per head; thread p holds row p of its head's
// state in registers (N floats), so the state never touches memory until
// the end. Chunks of 32 tokens of B and C are staged in shared memory once
// per block and read as float4 broadcasts by both heads: B and C come from
// device memory once per (b, chunk, head pair), and no per-head copy of
// them is made (the TPU kernel broadcast them to [Bz*H, S, N] in device
// memory first). x, dt and a are staged with coalesced loads. Two heads
// per block instead of one keep a block at 128 threads. What bounds it:
// the S tokens are sequential.
//
// Built without --use_fast_math and with --fmad=false.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;
constexpr int kThreadsMax = 128;   // heads per block = 128 / P (at least 1)
constexpr int kHeadsMax = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreadsMax)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const T* __restrict__ Bm,
           const T* __restrict__ Cm, float* __restrict__ y,
           float* __restrict__ state, int S, int H, int P, int HP) {
  __shared__ __align__(16) float Bs[kChunk][N];
  __shared__ __align__(16) float Cs[kChunk][N];
  __shared__ float xs[kChunk][kThreadsMax];
  __shared__ float dts[kChunk][kHeadsMax];
  __shared__ float as[kChunk][kHeadsMax];

  const int n_hb = (H + HP - 1) / HP;
  const int b = blockIdx.x / n_hb;
  const int h0 = (blockIdx.x % n_hb) * HP;
  const int tid = threadIdx.x;
  const int hl = tid / P, p = tid % P;
  const int h = h0 + hl;
  const bool live = h < H;                     // the last pair may be half
  const long long row = static_cast<long long>(H) * P;      // x per token

  float s[N];
#pragma unroll
  for (int n = 0; n < N; ++n) s[n] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int cnt = min(kChunk, S - t0);
    const long long tok = static_cast<long long>(b) * S + t0;
    __syncthreads();                           // last chunk fully read
    for (int i = tid; i < cnt * N; i += blockDim.x) {
      const int tt = i / N, n = i % N;
      Bs[tt][n] = to_f32(Bm[(tok + tt) * N + n]);
      Cs[tt][n] = to_f32(Cm[(tok + tt) * N + n]);
    }
    for (int i = tid; i < cnt * HP; i += blockDim.x) {
      const int tt = i / HP, hh = h0 + i % HP;
      if (hh < H) {
        dts[tt][i % HP] = dt[(tok + tt) * H + hh];
        as[tt][i % HP] = fminf(fmaxf(a[(tok + tt) * H + hh], 1e-38f), 1.f);
      }
    }
    if (live)
      for (int tt = 0; tt < cnt; ++tt)
        xs[tt][tid] = to_f32(x[(tok + tt) * row + static_cast<long long>(h) * P + p]);
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < cnt; ++tt) {
      const float dbx = dts[tt][hl] * xs[tt][tid];
      const float at = as[tt][hl];
      const float4* b4 = reinterpret_cast<const float4*>(Bs[tt]);
      const float4* c4 = reinterpret_cast<const float4*>(Cs[tt]);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 bb = b4[q], cc = c4[q];
        const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
        const float cv[4] = {cc.x, cc.y, cc.z, cc.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 4 * q + e;
          s[n] = fmaf(at, s[n], dbx * bv[e]);
          acc[e] = fmaf(s[n], cv[e], acc[e]);
        }
      }
      y[(tok + tt) * row + static_cast<long long>(h) * P + p] =
          (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
  }
  if (!live) return;
  float* st = state + ((static_cast<long long>(b) * H + h) * P + p) * N;
#pragma unroll
  for (int n = 0; n < N; ++n) st[n] = s[n];
}

template <typename T>
int launch(const void* x, const float* dt, const float* a, const void* B,
           const void* C, float* y, float* state, int Bz, int S, int H,
           int P, int N, cudaStream_t st) {
  if (P < 1 || P > kThreadsMax) return static_cast<int>(cudaErrorInvalidValue);
  const int HP = min(kHeadsMax, max(1, kThreadsMax / P));
  const dim3 grid(Bz * ((H + HP - 1) / HP));
  const int threads = HP * P;
  const T* x_ = static_cast<const T*>(x);
  const T* B_ = static_cast<const T*>(B);
  const T* C_ = static_cast<const T*>(C);
  switch (N) {
    case 8: ssd_kernel<T, 8><<<grid, threads, 0, st>>>(x_, dt, a, B_, C_, y, state, S, H, P, HP); break;
    case 16: ssd_kernel<T, 16><<<grid, threads, 0, st>>>(x_, dt, a, B_, C_, y, state, S, H, P, HP); break;
    case 32: ssd_kernel<T, 32><<<grid, threads, 0, st>>>(x_, dt, a, B_, C_, y, state, S, H, P, HP); break;
    case 64: ssd_kernel<T, 64><<<grid, threads, 0, st>>>(x_, dt, a, B_, C_, y, state, S, H, P, HP); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). x: [Bz,S,H,P]; B, C: [Bz,S,N]
// of x's type, float32 (bf16 = 0) or bfloat16 (bf16 = 1); dt, a:
// f32[Bz,S,H]; y: f32[Bz,S,H,P] and state: f32[Bz,H,P,N] (written); all
// contiguous; P <= 128, N in {8, 16, 32, 64}. Launches on `stream` and
// returns cudaGetLastError() as an int (0 = launched).
extern "C" int ssd_launch(const void* x, const float* dt, const float* a,
                          const void* B, const void* C, float* y,
                          float* state, int Bz, int S, int H, int P, int N,
                          int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, dt, a, B, C, y, state, Bz, S, H, P, N, st);
  return launch<float>(x, dt, a, B, C, y, state, Bz, S, H, P, N, st);
}
