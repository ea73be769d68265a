// Mamba2 SSD with its final state, for Hopper (sm_90a): the chunked
// "state-space duality" form on the tensor cores for bfloat16 x, B, C, and
// the per-token recurrence on the CUDA cores for float32.
//
// Replaces the Pallas TPU kernel `ssd_pallas` (`_kernel`) in
// src/repro/kernels/mamba2_ssd/mamba2_ssd.py, and returns what that kernel
// keeps in scratch and drops: the final state, which the prefill hands to
// the decode. Plain version: repro_torch/kernels/mamba2_ssd/ref.py
// `ssd_chunked` (the JAX package's chunked form).
//
// Per (b, h), state S in R^{P x N} from zero, scalar decay per head; B and
// C are shared by the heads of a batch row. Per chunk of L = 64 tokens:
//   cum = cumsum(log(clamp(a, 1e-38, 1)))                  (chunk-local)
//   g   = C B^T                                   [L, L]   (per b, chunk)
//   y   = (att o g)(dt x) + exp(cum) o (C S^T)    [L, P]   att = exp(cum_t
//                                                  - cum_s), s <= t, else 0
//   S'  = exp(cum_L) S + ((exp(cum_L - cum) dt) o x)^T B   [P, N]
//
// Dtype split, chosen explicitly by the entry point: bfloat16 x, B, C
// (the serving path) take the chunked kernel below; float32 x, B, C take
// the per-token recurrence on the CUDA cores (`ssd_recurrence`), which
// meets the float32 check at 3e-4 without splitting every f32 operand in
// three.
//
// Bound, at zamba2-7b's prefill (Bz=4, S=512, H=112, P=64, N=64; x, B, C
// bf16, dt, a, y and the state f32): reading every input once and writing
// y and the state once is 97,779,712 B, 29.2 us at 3.35 TB/s (y alone is
// 58.7 MB of it): bound by bytes. The byte count is chip_smoke.py's.
//
// Chunked kernel design. One block of 4 warps per (b, pair of heads)
// walks the S/64 chunks in order; the state of each head stays in the f32
// accumulator registers of the warps (warp w owns state rows p in
// [16w, 16w + 16), or 32 rows when P > 64, then one head per block). The
// next chunk's x (both heads), B, C, dt and a are copied into the other
// half of a double buffer with cp.async while this chunk is computed.
// Per chunk: warps 0 and 1 run each head's 64-token cumsum as a warp scan
// and tabulate exp(cum_t), exp(cum_L - cum_s) dt_s and exp(cum_L); then
// warp w owns token rows t in [16w, 16w + 16) and computes its rows of g =
// C B^T once (only the column tiles s <= t), shared by both heads. For
// each head, y's rows are C (S_hi + S_lo)^T, scaled by exp(cum_t) in the
// f32 epilogue, plus M_hi x + M_lo x with M = att o g o dt_s built in
// registers from g's accumulators (masked before the exp, so every
// exponent is <= 0 and strong decay cannot overflow), and are stored as
// f32. Then each warp updates its state rows: exp(cum_L) S + A_hi^T B +
// A_lo^T B with A = exp(cum_L - cum_s) dt_s x_s, and writes S_hi, S_lo to
// shared memory for the next chunk's C S^T. B and C are read from device
// memory once per (b, chunk, head pair); no per-head copy is made.
//
// Precision: every product is mma.sync.m16n8k16 bf16 -> f32. x, B and C
// are bf16 on the path and go in exact; each f32 operand (M, the state S,
// the decay-weighted x) is split into a bf16 pair hi + lo, hi = bf16(v),
// lo = bf16(v - hi), and enters as two products, which keeps it to about
// 2^-17 relative (a single bf16 rounding, 2^-9, would not meet the 3e-4
// tolerance). The row scaling exp(cum_t) is applied in the f32 epilogue.
// Tile shapes: 64-token chunks; m16n8k16 tiles, 16 rows per warp; P
// padded to 64 or 128 and N to at least 16 in shared memory only (zeros),
// so any P <= 128 and N in {8, 16, 32, 64} work; a ragged last chunk is
// zero-filled (dt = 0, log a = 0: the state is left as it is).
//
// Built without --use_fast_math and with --fmad=false (mma is unaffected);
// expf and logf, not __expf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// float32: the per-token recurrence, state rows in registers, one block
// per (b, group of heads), P threads per head. What bounds it: the S
// tokens are sequential.
// ---------------------------------------------------------------------------
constexpr int kChunk = 32;
constexpr int kThreadsMax = 128;   // heads per block = 128 / P (at least 1)
constexpr int kHeadsMax = 16;

template <int N>
__global__ void __launch_bounds__(kThreadsMax)
ssd_recurrence(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const float* __restrict__ Bm,
               const float* __restrict__ Cm, float* __restrict__ y,
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
  const bool live = h < H;                     // the last group may be short
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
      Bs[tt][n] = Bm[(tok + tt) * N + n];
      Cs[tt][n] = Cm[(tok + tt) * N + n];
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
        xs[tt][tid] = x[(tok + tt) * row + static_cast<long long>(h) * P + p];
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

int launch_recurrence(const float* x, const float* dt, const float* a,
                      const float* B, const float* C, float* y, float* state,
                      int Bz, int S, int H, int P, int N, cudaStream_t st) {
  const int HP = min(kHeadsMax, max(1, kThreadsMax / P));
  const dim3 grid(Bz * ((H + HP - 1) / HP));
  const int threads = HP * P;
  switch (N) {
#define SSD_REC_CASE(NV)                                                     \
  case NV:                                                                   \
    ssd_recurrence<NV><<<grid, threads, 0, st>>>(x, dt, a, B, C, y, state,  \
                                                 S, H, P, HP);              \
    break;
    SSD_REC_CASE(8) SSD_REC_CASE(16) SSD_REC_CASE(32) SSD_REC_CASE(64)
#undef SSD_REC_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: the chunked form on the tensor cores.
// ---------------------------------------------------------------------------
constexpr int kL = 64;               // tokens per chunk
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 (or 4) bytes global -> shared; with valid == false they are zeroed.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
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
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r));
}
// v = hi + lo to about 2^-17 relative: two registers of bf16 pairs.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const bf16 h0 = __float2bfloat16_rn(v0), h1 = __float2bfloat16_rn(v1);
  hi = pack_bf16(__bfloat162float(h0), __bfloat162float(h1));
  lo = pack_bf16(v0 - __bfloat162float(h0), v1 - __bfloat162float(h1));
}

// Shared memory of one block, in bf16 elements unless stated.
template <int PP, int NN, int HB> struct Smem {
  static constexpr int XS = PP + 8;          // row strides (16-byte rows,
  static constexpr int BS = NN + 8;          // conflict-free ldmatrix)
  static constexpr int kC = kL * BS;         // one chunk of C (or B)
  static constexpr int kX = HB * kL * XS;    // one chunk of x, all heads
  static constexpr int kS = HB * PP * BS;    // S_hi (or S_lo), all heads
  static constexpr int kBf16 = 2 * (2 * kC + kX) + 2 * kS;
  static constexpr int kF32 = 2 * 2 * HB * kL + 3 * HB * kL + HB;
  static constexpr size_t bytes = kBf16 * sizeof(bf16) + kF32 * sizeof(float);
};

template <int PP, int NN, int HB>
__global__ void __launch_bounds__(kThreads)
ssd_chunked_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const bf16* __restrict__ Bm,
               const bf16* __restrict__ Cm, float* __restrict__ y,
               float* __restrict__ state, int S, int H, int P, int N) {
  using L = Smem<PP, NN, HB>;
  constexpr int XS = L::XS, BS = L::BS;
  constexpr int MT = PP / 64;                 // 16-row state tiles per warp
  constexpr int PT = PP / 8;                  // n-tiles over P
  constexpr int NT = NN / 8;                  // n-tiles over N
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Cs = reinterpret_cast<bf16*>(smem);   // [2][kL][BS]
  bf16* Bs = Cs + 2 * L::kC;                  // [2][kL][BS]
  bf16* Xs = Bs + 2 * L::kC;                  // [2][HB][kL][XS]
  bf16* Shi = Xs + 2 * L::kX;                 // [HB][PP][BS]
  bf16* Slo = Shi + L::kS;                    // [HB][PP][BS]
  float* dts = reinterpret_cast<float*>(Slo + L::kS);   // [2][HB][kL]
  float* as = dts + 2 * HB * kL;                        // [2][HB][kL]
  float* cums = as + 2 * HB * kL;             // [HB][kL]  cum_t
  float* ecs = cums + HB * kL;                // [HB][kL]  exp(cum_t)
  float* wts = ecs + HB * kL;                 // [HB][kL]  exp(cum_L-cum_s) dt_s
  float* eLs = wts + HB * kL;                 // [HB]      exp(cum_L)

  const int n_hb = (H + HB - 1) / HB;
  const int b = blockIdx.x / n_hb;
  const int h0 = (blockIdx.x % n_hb) * HB;
  const int nh = min(HB, H - h0);             // live heads of this block
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_chunks = (S + kL - 1) / kL;
  const bool x_vec = P % 8 == 0;              // 16-byte rows of x

  // Zero what no copy writes: the padding columns (P..PP, N..NN) of both
  // buffers and the state's bf16 halves.
  for (int i = tid; i < L::kBf16; i += kThreads)
    Cs[i] = __float2bfloat16_rn(0.f);
  __syncthreads();

  auto load_chunk = [&](int c, int buf) {
    const int t0 = c * kL;
    const int cnt = min(kL, S - t0);
    const long long tok = static_cast<long long>(b) * S + t0;
    bf16* cd = Cs + buf * L::kC;
    bf16* bd = Bs + buf * L::kC;
    const int nch = N / 8;
    for (int i = tid; i < kL * nch; i += kThreads) {
      const int r = i / nch, col = (i % nch) * 8;
      const bool in = r < cnt;
      const long long src = in ? (tok + r) * N + col : 0;
      cp_async16(cd + r * BS + col, Cm + src, in);
      cp_async16(bd + r * BS + col, Bm + src, in);
    }
    bf16* xd = Xs + buf * L::kX;
    const long long xrow = static_cast<long long>(H) * P;
    if (x_vec) {
      const int pch = P / 8;
      for (int i = tid; i < HB * kL * pch; i += kThreads) {
        const int hh = i / (kL * pch), r = (i / pch) % kL;
        const int col = (i % pch) * 8;
        const bool in = r < cnt && hh < nh;
        const long long src =
            in ? (tok + r) * xrow + static_cast<long long>(h0 + hh) * P + col
               : 0;
        cp_async16(xd + (hh * kL + r) * XS + col, x + src, in);
      }
    } else {
      for (int i = tid; i < HB * kL * P; i += kThreads) {
        const int hh = i / (kL * P), r = (i / P) % kL, col = i % P;
        const bool in = r < cnt && hh < nh;
        xd[(hh * kL + r) * XS + col] =
            in ? x[(tok + r) * xrow + static_cast<long long>(h0 + hh) * P + col]
               : __float2bfloat16_rn(0.f);
      }
    }
    for (int i = tid; i < HB * kL; i += kThreads) {
      const int hh = i / kL, r = i % kL;
      const bool in = r < cnt && hh < nh;
      const long long src = in ? (tok + r) * H + h0 + hh : 0;
      cp_async4(dts + (buf * HB + hh) * kL + r, dt + src, in);
      cp_async4(as + (buf * HB + hh) * kL + r, a + src, in);
    }
  };

  float st[HB][MT][NT][4];                    // state rows of this warp
#pragma unroll
  for (int hh = 0; hh < HB; ++hh)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[hh][m][j][e] = 0.f;

  load_chunk(0, 0);
  cp_async_commit();
  const int t_lo = warp * 16 + gid;           // this thread's token rows
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    const int cnt = min(kL, S - c * kL);
    cp_async_wait_all();
    __syncthreads();                          // chunk c in; chunk c-1 done
    if (c + 1 < n_chunks) load_chunk(c + 1, buf ^ 1);
    cp_async_commit();
    const bf16* cd = Cs + buf * L::kC;
    const bf16* bd = Bs + buf * L::kC;
    const bf16* xd = Xs + buf * L::kX;

    if (warp < nh) {                          // the chunk-local cumsum
      const float* dh = dts + (buf * HB + warp) * kL;
      const float* ah = as + (buf * HB + warp) * kL;
      const int t0 = 2 * lane;
      const float la0 = t0 < cnt ? logf(fminf(fmaxf(ah[t0], 1e-38f), 1.f)) : 0.f;
      const float la1 =
          t0 + 1 < cnt ? logf(fminf(fmaxf(ah[t0 + 1], 1e-38f), 1.f)) : 0.f;
      float incl = la0 + la1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      const float cum1 = incl;
      const float cum0 = incl - la1;
      const float cumL = __shfl_sync(0xffffffffu, cum1, 31);
      float* ch = cums + warp * kL;
      float* eh = ecs + warp * kL;
      float* wh = wts + warp * kL;
      ch[t0] = cum0;
      ch[t0 + 1] = cum1;
      eh[t0] = expf(cum0);
      eh[t0 + 1] = expf(cum1);
      wh[t0] = t0 < cnt ? expf(cumL - cum0) * dh[t0] : 0.f;
      wh[t0 + 1] = t0 + 1 < cnt ? expf(cumL - cum1) * dh[t0 + 1] : 0.f;
      if (lane == 0) eLs[warp] = expf(cumL);
    }
    __syncthreads();

    // g = C B^T, rows t of this warp, column tiles s <= t only
    float g[kL / 8][4];
#pragma unroll
    for (int j = 0; j < kL / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) g[j][e] = 0.f;
#pragma unroll
    for (int kn = 0; kn < NN / 16; ++kn) {
      uint32_t af[4];
      ldsm_x4(af, cd + (warp * 16 + (lane & 15)) * BS + kn * 16 +
                      (lane >> 4) * 8);
#pragma unroll
      for (int sp = 0; sp < kL / 16; ++sp) {
        if (sp > warp) continue;
        uint32_t bf[4];
        ldsm_x4(bf, bd + (sp * 16 + (lane & 7) + ((lane >> 4) << 3)) * BS +
                        kn * 16 + ((lane >> 3) & 1) * 8);
        mma16816(g[2 * sp], af, bf[0], bf[1]);
        mma16816(g[2 * sp + 1], af, bf[2], bf[3]);
      }
    }

#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      if (hh >= nh) continue;
      const float* ch = cums + hh * kL;
      const float* dh = dts + (buf * HB + hh) * kL;
      float acc[PT][4];
#pragma unroll
      for (int j = 0; j < PT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      if (c > 0) {                            // C (S_hi + S_lo)^T
        const bf16* sh = Shi + hh * PP * BS;
        const bf16* sl = Slo + hh * PP * BS;
#pragma unroll
        for (int kn = 0; kn < NN / 16; ++kn) {
          uint32_t af[4];
          ldsm_x4(af, cd + (warp * 16 + (lane & 15)) * BS + kn * 16 +
                          (lane >> 4) * 8);
#pragma unroll
          for (int pp = 0; pp < PP / 16; ++pp) {
            const int ro = (pp * 16 + (lane & 7) + ((lane >> 4) << 3)) * BS +
                           kn * 16 + ((lane >> 3) & 1) * 8;
            uint32_t bh[4], bl[4];
            ldsm_x4(bh, sh + ro);
            ldsm_x4(bl, sl + ro);
            mma16816(acc[2 * pp], af, bh[0], bh[1]);
            mma16816(acc[2 * pp], af, bl[0], bl[1]);
            mma16816(acc[2 * pp + 1], af, bh[2], bh[3]);
            mma16816(acc[2 * pp + 1], af, bl[2], bl[3]);
          }
        }
        const float e0 = ecs[hh * kL + t_lo], e1 = ecs[hh * kL + t_lo + 8];
#pragma unroll
        for (int j = 0; j < PT; ++j) {
          acc[j][0] *= e0;
          acc[j][1] *= e0;
          acc[j][2] *= e1;
          acc[j][3] *= e1;
        }
      }
      // + (M_hi + M_lo) x, M[t, s] = exp(cum_t - cum_s) g[t, s] dt_s, s <= t
      const float ct[2] = {ch[t_lo], ch[t_lo + 8]};
      const bf16* xh = xd + hh * kL * XS;
#pragma unroll
      for (int kk = 0; kk < kL / 16; ++kk) {
        if (kk > warp) continue;
        float mv[8];                          // a0.x a0.y a1.x a1.y a2.. a3..
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int half = e >> 2;            // s + 8 for a2, a3
          const int rr = (e >> 1) & 1;        // row t + 8 for a1, a3
          const int s = kk * 16 + half * 8 + tig * 2 + (e & 1);
          const int t = t_lo + rr * 8;
          const float gv = g[2 * kk + half][rr * 2 + (e & 1)];
          mv[e] = s <= t ? expf(ct[rr] - ch[s]) * gv * dh[s] : 0.f;
        }
        uint32_t mh[4], ml[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) split2(mv[2 * r], mv[2 * r + 1], mh[r], ml[r]);
#pragma unroll
        for (int pp = 0; pp < PP / 16; ++pp) {
          uint32_t bf[4];
          ldsm_x4_t(bf, xh + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * XS +
                            pp * 16 + (lane >> 4) * 8);
          mma16816(acc[2 * pp], mh, bf[0], bf[1]);
          mma16816(acc[2 * pp], ml, bf[0], bf[1]);
          mma16816(acc[2 * pp + 1], mh, bf[2], bf[3]);
          mma16816(acc[2 * pp + 1], ml, bf[2], bf[3]);
        }
      }
      // store y rows t < cnt, columns p < P
      const long long yrow = static_cast<long long>(H) * P;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int t = t_lo + rr * 8;
        if (t >= cnt) continue;
        float* yp = y + (static_cast<long long>(b) * S + c * kL + t) * yrow +
                    static_cast<long long>(h0 + hh) * P;
#pragma unroll
        for (int j = 0; j < PT; ++j) {
          const int p = j * 8 + tig * 2;
          if (p + 1 < P && (P & 1) == 0) {
            *reinterpret_cast<float2*>(yp + p) =
                make_float2(acc[j][2 * rr], acc[j][2 * rr + 1]);
          } else {
            if (p < P) yp[p] = acc[j][2 * rr];
            if (p + 1 < P) yp[p + 1] = acc[j][2 * rr + 1];
          }
        }
      }
    }
    __syncthreads();                          // S_hi, S_lo fully read

    // S' = exp(cum_L) S + (A_hi + A_lo)^T B, A[s, p] = w_s x[s, p]
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      if (hh >= nh) continue;
      const float eL = eLs[hh];
      const float* wh = wts + hh * kL;
      const bf16* xh = xd + hh * kL * XS;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int p0 = (warp * MT + m) * 16;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[hh][m][j][e] *= eL;
#pragma unroll
        for (int kk = 0; kk < kL / 16; ++kk) {
          uint32_t ax[4];                     // x^T: rows p, columns s
          ldsm_x4_t(ax, xh + (kk * 16 + (lane & 7) + (lane >> 4) * 8) * XS +
                            p0 + ((lane >> 3) & 1) * 8);
          const int s0 = kk * 16 + tig * 2;
          const float w00 = wh[s0], w01 = wh[s0 + 1];
          const float w10 = wh[s0 + 8], w11 = wh[s0 + 9];
          uint32_t ah[4], al[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float2 xv = unpack_bf16(ax[r]);
            const bool hi_s = r >= 2;         // a2, a3: columns s + 8
            split2(xv.x * (hi_s ? w10 : w00), xv.y * (hi_s ? w11 : w01),
                   ah[r], al[r]);
          }
#pragma unroll
          for (int np = 0; np < NN / 16; ++np) {
            uint32_t bf[4];
            ldsm_x4_t(bf, bd + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   BS + np * 16 + (lane >> 4) * 8);
            mma16816(st[hh][m][2 * np], ah, bf[0], bf[1]);
            mma16816(st[hh][m][2 * np], al, bf[0], bf[1]);
            mma16816(st[hh][m][2 * np + 1], ah, bf[2], bf[3]);
            mma16816(st[hh][m][2 * np + 1], al, bf[2], bf[3]);
          }
        }
        // S_hi, S_lo of these rows for the next chunk's C S^T
        bf16* sh = Shi + (hh * PP + p0 + gid) * BS + tig * 2;
        bf16* sl = Slo + (hh * PP + p0 + gid) * BS + tig * 2;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            uint32_t hi, lo;
            split2(st[hh][m][j][2 * rr], st[hh][m][j][2 * rr + 1], hi, lo);
            *reinterpret_cast<uint32_t*>(sh + rr * 8 * BS + j * 8) = hi;
            *reinterpret_cast<uint32_t*>(sl + rr * 8 * BS + j * 8) = lo;
          }
      }
    }
  }

  // the final state, rows p < P and columns n < N
#pragma unroll
  for (int hh = 0; hh < HB; ++hh) {
    if (hh >= nh) continue;
    float* sp = state + (static_cast<long long>(b) * H + h0 + hh) * P * N;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int p = (warp * MT + m) * 16 + gid + rr * 8;
        if (p >= P) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = j * 8 + tig * 2;
          if (n < N)
            *reinterpret_cast<float2*>(sp + p * N + n) =
                make_float2(st[hh][m][j][2 * rr], st[hh][m][j][2 * rr + 1]);
        }
      }
  }
}

template <int PP, int NN, int HB>
int launch_tc(const void* x, const float* dt, const float* a, const void* B,
              const void* C, float* y, float* state, int Bz, int S, int H,
              int P, int N, cudaStream_t st) {
  static bool configured = false;             // dynamic shared memory set
  const size_t bytes = Smem<PP, NN, HB>::bytes;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_chunked_tc<PP, NN, HB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(Bz * ((H + HB - 1) / HB));
  ssd_chunked_tc<PP, NN, HB><<<grid, kThreads, bytes, st>>>(
      static_cast<const bf16*>(x), dt, a, static_cast<const bf16*>(B),
      static_cast<const bf16*>(C), y, state, S, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

template <int NN>
int launch_tc_p(const void* x, const float* dt, const float* a, const void* B,
                const void* C, float* y, float* state, int Bz, int S, int H,
                int P, int N, cudaStream_t st) {
  if (P <= 64)     // two heads a block share g; the state fits in registers
    return launch_tc<64, NN, 2>(x, dt, a, B, C, y, state, Bz, S, H, P, N, st);
  return launch_tc<128, NN, 1>(x, dt, a, B, C, y, state, Bz, S, H, P, N, st);
}

}  // namespace

// Plain C entry point (bound with ctypes). x: [Bz,S,H,P]; B, C: [Bz,S,N]
// of x's type, float32 (bf16 = 0: the recurrence) or bfloat16 (bf16 = 1:
// the chunked tensor-core kernel, x, B, C on 16-byte boundaries); dt, a:
// f32[Bz,S,H]; y: f32[Bz,S,H,P] and state: f32[Bz,H,P,N] (written); all
// contiguous; P <= 128, N in {8, 16, 32, 64}. Launches on `stream` and
// returns cudaGetLastError() as an int (0 = launched).
extern "C" int ssd_launch(const void* x, const float* dt, const float* a,
                          const void* B, const void* C, float* y,
                          float* state, int Bz, int S, int H, int P, int N,
                          int bf16_in, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P < 1 || P > kThreadsMax) return static_cast<int>(cudaErrorInvalidValue);
  if (!bf16_in)
    return launch_recurrence(static_cast<const float*>(x), dt, a,
                             static_cast<const float*>(B),
                             static_cast<const float*>(C), y, state, Bz, S, H,
                             P, N, st);
  switch (N) {
    case 8:
    case 16: return launch_tc_p<16>(x, dt, a, B, C, y, state, Bz, S, H, P, N, st);
    case 32: return launch_tc_p<32>(x, dt, a, B, C, y, state, Bz, S, H, P, N, st);
    case 64: return launch_tc_p<64>(x, dt, a, B, C, y, state, Bz, S, H, P, N, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
