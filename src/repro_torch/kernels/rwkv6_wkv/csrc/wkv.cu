// RWKV6 WKV recurrence with its final state in float32 on the CUDA cores,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `wkv_pallas` (`_kernel`) in
// src/repro/kernels/rwkv6_wkv/rwkv6_wkv.py for float32 inputs (the
// full-width float32 self-checks and the smoke archs), and returns what
// that kernel keeps in scratch and drops: the final state, which the
// prefill hands to the decode. bfloat16 goes to the chunked tensor-core
// kernel in wkv_tc.cu, chosen by dtype in rwkv6_wkv.py. Plain version:
// repro_torch/kernels/rwkv6_wkv/ref.py `wkv_chunked` (the JAX package's
// chunked form).
//
// Per (b, h), state S in R^{hd x hd} from zero:
//   y_t[j]  = sum_i r_t[i] (S[i,j] + u[i] k_t[i] v_t[j])
//   S[i,j] <- w_t[i] S[i,j] + k_t[i] v_t[j]         (w clamped to [1e-38, 1])
//
// Bound, at rwkv6-7b's prefill shape (B=4, S=512, H=64, hd=64) in
// float32: reading r, k, v, w once and writing y and the state once is
// ~172 MB, 51 us at 3.35 TB/s. Its ~5*B*S*H*hd*hd = 2.7 GFLOP take 40 us
// at the CUDA cores' 67 TFLOP/s float32 rate, which this kernel uses.
//
// Design: the per-token recurrence of the reference's `wkv_ref`, which is
// the same function as the chunked form and needs no exp or log at all,
// so strong decay cannot overflow. One block per (b, h) of hd threads;
// thread j holds column j of the state in registers (hd floats), so the
// state never touches memory until the end. Chunks of 32 tokens of r, k
// and w are staged in shared memory with coalesced loads (thread j loads
// channel j) and read back as float4 broadcasts; y_t[j] is written by
// thread j, coalesced. The dot product runs in four partial sums to keep
// the FMA chains short. What bounds it: the S = 512 tokens are
// sequential, and only B*H = 256 blocks of 64 threads are in flight.
//
// Built without --use_fast_math and with --fmad=false.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;

template <int HD>
__global__ void __launch_bounds__(HD)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, float* __restrict__ y,
           float* __restrict__ state, int S, int H) {
  __shared__ __align__(16) float rs[kChunk][HD];
  __shared__ __align__(16) float ks[kChunk][HD];
  __shared__ __align__(16) float ws[kChunk][HD];
  __shared__ __align__(16) float us[HD];
  __shared__ float vs[kChunk][HD];

  const int j = threadIdx.x;
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const long long step = static_cast<long long>(H) * HD;   // per token
  const long long base = (static_cast<long long>(b) * S * H + h) * HD + j;
  us[j] = u[h * HD + j];

  float s[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) s[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
    __syncthreads();                           // last chunk fully read
    for (int tt = 0; tt < n; ++tt) {
      const long long o = base + (t0 + tt) * step;
      rs[tt][j] = r[o];
      ks[tt][j] = k[o];
      vs[tt][j] = v[o];
      ws[tt][j] = fminf(fmaxf(w[o], 1e-38f), 1.f);
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = vs[tt][j];
      const float4* r4 = reinterpret_cast<const float4*>(rs[tt]);
      const float4* k4 = reinterpret_cast<const float4*>(ks[tt]);
      const float4* w4 = reinterpret_cast<const float4*>(ws[tt]);
      const float4* u4 = reinterpret_cast<const float4*>(us);
      float a[4] = {0.f, 0.f, 0.f, 0.f};       // sum_i r_i S_ij
      float c[4] = {0.f, 0.f, 0.f, 0.f};       // sum_i r_i u_i k_i
#pragma unroll
      for (int q = 0; q < HD / 4; ++q) {
        const float4 rr = r4[q], kk = k4[q], ww = w4[q], uu = u4[q];
        const float rv[4] = {rr.x, rr.y, rr.z, rr.w};
        const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wv[4] = {ww.x, ww.y, ww.z, ww.w};
        const float uv[4] = {uu.x, uu.y, uu.z, uu.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e;
          a[e] = fmaf(rv[e], s[i], a[e]);
          c[e] = fmaf(rv[e], uv[e] * kv[e], c[e]);
          s[i] = fmaf(wv[e], s[i], kv[e] * vj);
        }
      }
      const float yt = ((a[0] + a[1]) + (a[2] + a[3])) +
                       ((c[0] + c[1]) + (c[2] + c[3])) * vj;
      y[base + (t0 + tt) * step] = yt;
    }
  }
  float* st = state + static_cast<long long>(b * H + h) * HD * HD + j;
#pragma unroll
  for (int i = 0; i < HD; ++i) st[i * HD] = s[i];
}

}  // namespace

// Plain C entry point (bound with ctypes). r, k, v, y: f32[B,S,H,hd];
// w: f32[B,S,H,hd]; u: f32[H,hd]; state: f32[B,H,hd,hd] (written); all
// contiguous; hd in {8, 16, 32, 64}. Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int wkv_launch(const float* r, const float* k, const float* v,
                          const float* w, const float* u, float* y,
                          float* state, int B, int S, int H, int hd,
                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * H);
  switch (hd) {
    case 8: wkv_kernel<8><<<grid, 8, 0, st>>>(r, k, v, w, u, y, state, S, H); break;
    case 16: wkv_kernel<16><<<grid, 16, 0, st>>>(r, k, v, w, u, y, state, S, H); break;
    case 32: wkv_kernel<32><<<grid, 32, 0, st>>>(r, k, v, w, u, y, state, S, H); break;
    case 64: wkv_kernel<64><<<grid, 64, 0, st>>>(r, k, v, w, u, y, state, S, H); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
