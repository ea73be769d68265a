// Flash-attention forward (blockwise online softmax) in float32 on the
// CUDA cores, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` (`_kernel`) in
// src/repro/kernels/flash_attention/flash_attention.py for float32 inputs
// (the full-width float32 self-checks and the smoke archs); bfloat16 goes
// to the tensor-core kernel in flash_attention_tc.cu, chosen by dtype in
// flash_attention.py. Plain version:
// repro_torch/kernels/flash_attention/ref.py `mha_ref`.
//
//   out[b,s,h,:] = softmax_t(q[b,s,h,:] . k[b,t,h/G,:] / sqrt(hd)) v[b,t,h/G,:]
//
// over the keys t the masks leave: causal (t <= s + T - S, queries
// right-aligned when S != T) and the sliding window (t > s + T - S - W).
// Masked logits are -1e30 as in the reference (a row with no visible key
// then averages every value instead of giving NaN); keys past T are -inf.
//
// Bound, at qwen2.5-3b's prefill shape (B=4, S=T=512, H=16, KV=2,
// hd=128) in float32: q, k, v read once and out written once are
// 37,748,736 B (11.3 us at 3.35 TB/s); the causal half of the products is
// 4.30 GFLOP, 64 us at the CUDA cores' 67 TFLOP/s float32 rate, which
// bounds this kernel: it computes with float32 FMAs. (In bf16 the same
// shape is 18,874,368 B, 5.6 us, chip_smoke.py's count; that is the
// tensor-core kernel's bound.)
//
// Design: one block of 256 threads per (query tile of 64 rows, b*H + h).
// A loop over key tiles of 64 replaces the TPU's sequential grid axis:
// each tile's K and V are staged in shared memory, the
// 64x64 logits go to shared memory, four threads per row run the online
// softmax (running max m, sum l and the rescale factor in shared memory),
// and each thread keeps a 4 x 8 block of the f32 output accumulator in
// registers (rows ty + 16i, columns tx + 16j), so any hd <= 128 works,
// 112 included. Tiles entirely above the diagonal or outside the window
// are skipped, except in a query tile that holds a row with no visible
// key (causal, S > T), where every tile is visited so that the row
// averages all T values as the reference's does. Ragged query and key
// tiles (S or T not a multiple of 64) are masked here. Rows of shared
// memory are padded to an odd number of words (hd + 1), so the 16
// threads that read 16 rows of K at one column hit 16 banks.
//
// Built without --use_fast_math and with --fmad=false; expf, not __expf.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kHdMax = 128;
constexpr int kPs = kBK + 1;   // row stride of the logits tile (floats)
constexpr float kMasked = -1e30f;

size_t smem_bytes(int hd) {
  return static_cast<size_t>((kBQ + 2 * kBK) * (hd + 1) + kBQ * kPs +
                             3 * kBQ) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int S,
             int T_, int H, int KV, int hd, int group, int causal, int window,
             float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rs = hd + 1;                       // an odd number of words
  float* Qs = reinterpret_cast<float*>(smem);  // [kBQ][rs]
  float* Ks = Qs + kBQ * rs;                   // [kBK][rs]
  float* Vs = Ks + kBK * rs;                   // [kBK][rs]
  float* Ps = reinterpret_cast<float*>(Vs + kBK * rs);  // [kBQ][kPs]
  float* m_s = Ps + kBQ * kPs;                 // running max per row
  float* l_s = m_s + kBQ;                      // running sum per row
  float* a_s = l_s + kBQ;                      // this tile's rescale factor

  const int h = blockIdx.y % H;
  const int b = blockIdx.y / H;
  const int kvh = h / group;
  const int q0 = blockIdx.x * kBQ;
  const int off = T_ - S;                      // right alignment
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  const long long q_step = static_cast<long long>(H) * hd;   // per token
  const long long kv_step = static_cast<long long>(KV) * hd;
  const float* qb = q + (static_cast<long long>(b) * S * H + h) * hd;
  const float* kb = k + (static_cast<long long>(b) * T_ * KV + kvh) * hd;
  const float* vb = v + (static_cast<long long>(b) * T_ * KV + kvh) * hd;
  float* ob = out + (static_cast<long long>(b) * S * H + h) * hd;

  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    Qs[r * rs + d] = q0 + r < S ? qb[(q0 + r) * q_step + d] : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kMasked;
    l_s[tid] = 0.f;
  }

  const int nd = (hd + 15) / 16;               // column groups, <= 8
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int q_first = q0 + off;
  const int q_last = min(q0 + kBQ, S) - 1 + off;
  const bool blind = causal && q_first < 0;    // a row sees no key
  const int n_tiles = (T_ + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    const int k_last = min(k0 + kBK, T_) - 1;
    if (!blind) {                              // uniform over the block
      if (causal && k0 > q_last) break;        // above the diagonal
      if (window > 0 && k_last <= q_first - window) continue;
    }
    __syncthreads();                           // last tile fully read
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int r = i / hd, d = i % hd;
      const bool in = k0 + r < T_;
      Ks[r * rs + d] = in ? kb[(k0 + r) * kv_step + d] : 0.f;
      Vs[r * rs + d] = in ? vb[(k0 + r) * kv_step + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * rs + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * rs + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qp = q0 + r + off;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kp = k0 + c;
        float val = s[i][j] * scale;
        if (kp >= T_)
          val = -INFINITY;
        else if ((causal && kp > qp) || (window > 0 && kp <= qp - window))
          val = kMasked;
        Ps[r * kPs + c] = val;
      }
    }
    __syncthreads();

    {  // online softmax: four neighbouring lanes per row
      const int r = tid / 4, part = tid % 4;
      float mx = -INFINITY;
      for (int c = part; c < kBK; c += 4) mx = fmaxf(mx, Ps[r * kPs + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part; c < kBK; c += 4) {
        const float p = expf(Ps[r * kPs + c] - m_new);
        Ps[r * kPs + c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();                            // the quad has read m_s[r]
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * kPs + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = tx + 16 * j;
        if (j < nd && d < hd) {
          const float vv = Vs[c * rs + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= S) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = tx + 16 * j;
      if (j < nd && d < hd)
        ob[(q0 + r) * q_step + d] = acc[i][j] / l;
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). q: [B,S,H,hd], k/v: [B,T,KV,hd],
// out: [B,S,H,hd], all contiguous float32; hd <= 128; window 0 = none.
// Launches on `stream` and returns cudaGetLastError() as an int (0 =
// launched).
extern "C" int flash_attention_launch(const float* q, const float* k,
                                      const float* v, float* out, int B,
                                      int S, int T, int H, int KV, int hd,
                                      int group, int causal, int window,
                                      float scale, void* stream) {
  if (hd < 1 || hd > kHdMax) return static_cast<int>(cudaErrorInvalidValue);
  static size_t configured = 0;                // dynamic shared memory set
  const size_t bytes = smem_bytes(hd);
  if (bytes > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = bytes;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, S, T, H, KV, hd, group, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}
