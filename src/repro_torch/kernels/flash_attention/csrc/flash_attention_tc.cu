// Flash-attention forward on the tensor cores, bf16 in and out, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` (`_kernel`) in
// src/repro/kernels/flash_attention/flash_attention.py for bfloat16
// inputs with hd % 16 == 0 and hd <= 128 (every head_dim of the registry:
// 128, 112, 64 and the smoke archs' 32). float32 inputs go to the SIMT
// kernel in flash_attention.cu; the wrapper (flash_attention.py) chooses
// by dtype and raises on a bf16 hd this kernel does not take. Plain
// version: repro_torch/kernels/flash_attention/ref.py `mha_ref`.
//
//   out[b,s,h,:] = softmax_t(q[b,s,h,:] . k[b,t,h/G,:] / sqrt(hd)) v[b,t,h/G,:]
//
// over the keys t the masks leave: causal (t <= s + T - S, queries
// right-aligned when S != T) and the sliding window (t > s + T - S - W).
// Masked logits are -1e30 as in the reference (a row with no visible key
// then averages every value); keys past T are -inf.
//
// Bound, at qwen2.5-3b's prefill (B=4, S=T=512, H=16, KV=2, hd=128): q, k,
// v read once and out written once are 18,874,368 B, 5.6 us at 3.35 TB/s;
// the causal half of the products is 4.30 GFLOP, 4.3 us at the tensor
// cores' 989 TFLOP/s: bound by bytes, barely. At zamba2-7b's (H=KV=32,
// hd=112): 58,720,256 B, 17.5 us. The byte counts are chip_smoke.py's.
//
// Design (the FlashAttention-2 shape). One block of 4 warps per (query
// tile of 64 rows, b*H + h); each warp owns 16 query rows. Key tiles of
// 64 rows of K and V are double-buffered in shared memory with cp.async
// (the next tile loads while this one is computed); rows are padded to
// hd + 8 elements, so the 8 rows an ldmatrix phase reads start in 8
// different 4-bank groups for every hd % 16 == 0. Q.K^T and P.V run as
// mma.sync.m16n8k16 bf16 -> f32, operands loaded with ldmatrix (.trans for
// V); the warp's Q fragments stay in registers for the whole key loop.
// The 16 x 64 logits stay in the accumulator registers: scaled by
// 1/sqrt(hd) in f32 (not folded into a bf16 Q), masked, and run through
// the online softmax (running max and sum per row, reduced across each
// quad with __shfl_xor_sync) in registers. P is rounded to bf16 once, in
// registers, and is the A operand of P.V; the row sums are of the f32 P.
// The output accumulates in f32 (16 x hd per warp) and is divided by the
// row sum and rounded to bf16 once, staged through shared memory for
// 16-byte stores. hd = 112 is 7 k-steps of Q.K^T and 14 n-tiles of P.V;
// nothing is padded in device memory.
//
// Key tiles entirely above the diagonal or outside the window are
// skipped, except in a query tile that holds a row with no visible key
// (causal, S > T), which visits every key tile so that the row averages
// all T values as the reference's does. Per-element masks are applied
// only in tiles a warp's rows see partly. Ragged S and T: rows past S are
// zero-filled and never stored, keys past T zero-filled and -inf.
//
// Precision: q, k, v enter the products exact (bf16); the logits, the
// softmax and the output sum are f32; the one extra rounding against the
// plain version is P to bf16 before P.V (2^-9 relative per weight).
// Built without --use_fast_math and with --fmad=false (mma is unaffected);
// expf, not __expf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;    // query rows per block
constexpr int kBK = 64;             // keys per tile
constexpr float kMasked = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid == false the 16 bytes are zeroed.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 -> one register of two bf16 (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD> __host__ __device__ constexpr int row_stride() {
  return HD + 8;
}

template <int HD> size_t smem_bytes() {
  return static_cast<size_t>(kBQ + 4 * kBK) * row_stride<HD>() * sizeof(bf16);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, int S,
                int T_, int H, int KV, int group, int causal, int window,
                float scale) {
  constexpr int RS = row_stride<HD>();
  constexpr int KSTEPS = HD / 16;   // k-steps of Q.K^T
  constexpr int DT = HD / 8;        // n-tiles of P.V (even)
  constexpr int CH = HD / 8;        // 16-byte chunks per row
  constexpr int NT = kBK / 8;       // n-tiles of Q.K^T
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);   // [kBQ][RS], later the output
  bf16* Ks = Qs + kBQ * RS;                   // [2][kBK][RS]
  bf16* Vs = Ks + 2 * kBK * RS;               // [2][kBK][RS]

  const int h = blockIdx.y % H;
  const int b = blockIdx.y / H;
  const int kvh = h / group;
  // the longest causal tiles first: the last query tile has the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int off = T_ - S;                     // right alignment
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;

  const long long q_step = static_cast<long long>(H) * HD;   // per token
  const long long kv_step = static_cast<long long>(KV) * HD;
  const bf16* qb = q + (static_cast<long long>(b) * S * H + h) * HD;
  const bf16* kb = k + (static_cast<long long>(b) * T_ * KV + kvh) * HD;
  const bf16* vb = v + (static_cast<long long>(b) * T_ * KV + kvh) * HD;
  bf16* ob = out + (static_cast<long long>(b) * S * H + h) * HD;

  // The key tiles this query tile visits: one contiguous range.
  const int q_first = q0 + off;
  const int q_last = min(q0 + kBQ, S) - 1 + off;
  const bool blind = causal && q_first < 0;   // a row sees no key
  const int n_tiles = (T_ + kBK - 1) / kBK;
  int kt_lo = 0, kt_hi = n_tiles;
  if (!blind) {
    if (causal) kt_hi = min(n_tiles, q_last / kBK + 1);
    if (window > 0)
      while (kt_lo < kt_hi && min((kt_lo + 1) * kBK, T_) - 1 <= q_first - window)
        ++kt_lo;
  }

  for (int i = tid; i < kBQ * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool in = q0 + r < S;
    cp_async16(Qs + r * RS + c, qb + (in ? (q0 + r) * q_step + c : 0), in);
  }
  auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * kBK;
    bf16* kd = Ks + buf * kBK * RS;
    bf16* vd = Vs + buf * kBK * RS;
    for (int i = tid; i < kBK * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool in = k0 + r < T_;
      const long long src = in ? (k0 + r) * kv_step + c : 0;
      cp_async16(kd + r * RS + c, kb + src, in);
      cp_async16(vd + r * RS + c, vb + src, in);
    }
  };
  if (kt_lo < kt_hi) load_kv(kt_lo, 0);
  cp_async_commit();

  // rows of this thread's accumulators: r_lo (c0, c1) and r_lo + 8 (c2, c3)
  const int r_lo = q0 + warp * 16 + gid;
  const int w_first = q0 + warp * 16 + off;  // the warp's query positions
  const int w_last = w_first + 15;
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m_run[2] = {kMasked, kMasked};
  float l_run[2] = {0.f, 0.f};              // this thread's partial sums
  uint32_t qf[KSTEPS][4];

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int buf = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) {
      load_kv(kt + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == kt_lo) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        ldsm_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * RS + kk * 16 +
                            (lane >> 4) * 8);
    }
    const bf16* kd = Ks + buf * kBK * RS;
    const bf16* vd = Vs + buf * kBK * RS;

    // logits: s = Q K^T, 16 x 64 per warp
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, kd + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * RS +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma16816(s[2 * np], qf[kk], bf[0], bf[1]);
        mma16816(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

    const int k0 = kt * kBK;
    const int k_last = min(k0 + kBK, T_) - 1;
    const bool partial = k0 + kBK > T_ || (causal && k_last > w_first) ||
                         (window > 0 && k0 <= w_last - window);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[j][e] * scale;
        if (partial) {
          const int qp = r_lo + (e >> 1) * 8 + off;
          const int kp = k0 + j * 8 + tig * 2 + (e & 1);
          if (kp >= T_)
            val = -INFINITY;
          else if ((causal && kp > qp) || (window > 0 && kp <= qp - window))
            val = kMasked;
        }
        s[j][e] = val;
      }

    // online softmax, rows r_lo (i = 0) and r_lo + 8 (i = 1)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m_run[i];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = expf(m_run[i] - mx);
      m_run[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float p0 = expf(s[j][2 * i] - mx);
        const float p1 = expf(s[j][2 * i + 1] - mx);
        s[j][2 * i] = p0;
        s[j][2 * i + 1] = p1;
        sum += p0 + p1;
      }
      l_run[i] = alpha * l_run[i] + sum;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[d][2 * i] *= alpha;
        o[d][2 * i + 1] *= alpha;
      }
    }

    // o += bf16(P) V; P's accumulator layout is the A fragment's
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bf[4];
        ldsm_x4_t(bf, vd + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                          dp * 16 + (lane >> 4) * 8);
        mma16816(o[2 * dp], a, bf[0], bf[1]);
        mma16816(o[2 * dp + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();                          // this buffer fully read
  }

  // out = o / l, rounded once; staged in the warp's own rows of Qs
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    bf16* row = Qs + (warp * 16 + gid + 8 * i) * RS + tig * 2;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<uint32_t*>(row + d * 8) =
          pack_bf16(o[d][2 * i] / l, o[d][2 * i + 1] / l);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8;
    const int sq = q0 + warp * 16 + r;
    if (sq < S)
      *reinterpret_cast<uint4*>(ob + sq * q_step + c) =
          *reinterpret_cast<const uint4*>(Qs + (warp * 16 + r) * RS + c);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T_, int H, int KV, int group, int causal, int window,
           float scale, cudaStream_t stream) {
  static bool configured = false;             // dynamic shared memory set
  const size_t bytes = smem_bytes<HD>();
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_tc_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, T_, H, KV,
      group, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). q: [B,S,H,hd], k/v: [B,T,KV,hd],
// out: [B,S,H,hd], all contiguous bfloat16 on 16-byte boundaries;
// hd % 16 == 0, hd <= 128; window 0 = none. Launches on `stream` and
// returns cudaGetLastError() as an int (0 = launched).
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* out, int B,
                                         int S, int T, int H, int KV, int hd,
                                         int group, int causal, int window,
                                         float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
#define FLASH_TC_CASE(D)                                                    \
  case D:                                                                   \
    return launch<D>(q, k, v, out, B, S, T, H, KV, group, causal, window,  \
                     scale, st);
    FLASH_TC_CASE(16) FLASH_TC_CASE(32) FLASH_TC_CASE(48) FLASH_TC_CASE(64)
    FLASH_TC_CASE(80) FLASH_TC_CASE(96) FLASH_TC_CASE(112) FLASH_TC_CASE(128)
#undef FLASH_TC_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
