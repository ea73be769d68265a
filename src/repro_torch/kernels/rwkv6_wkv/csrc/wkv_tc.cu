// RWKV6 WKV with its final state, chunked on the tensor cores, for
// bfloat16 r, k, v on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `wkv_pallas` (`_kernel`) in
// src/repro/kernels/rwkv6_wkv/rwkv6_wkv.py for bfloat16 inputs (the
// serving path), and returns what that kernel keeps in scratch and drops:
// the final state, which the prefill hands to the decode. float32 inputs
// take the per-token recurrence in wkv.cu, chosen by dtype in
// rwkv6_wkv.py. Plain version: repro_torch/kernels/rwkv6_wkv/ref.py
// `wkv_chunked` (the JAX package's chunked form).
//
// Per (b, h), state S in R^{hd x hd} (rows i: key channel, columns j:
// value channel) from zero, w clamped to [1e-38, 1]:
//   y_t[j]  = sum_i r_t[i] (S[i,j] + u[i] k_t[i] v_t[j])
//   S[i,j] <- w_t[i] S[i,j] + k_t[i] v_t[j]
// Per chunk of L = 32 tokens, with S0 the state at its start and
// att(t, s)[i] = prod_{s<tau<t} w_tau[i] (= exp(cum_prev[t,i] - cum[s,i])):
//   y[t]  = (r_t o dec_t) S0 + sum_{s<t} a[t,s] v_s + (r_t . (u o k_t)) v_t
//   a[t,s] = sum_i r_t[i] k_s[i] att(t, s)[i]
//   S'    = diag(dec_L) S0 + sum_s (k_s o prod_{s<tau<L} w_tau) v_s^T
// with dec_t = prod_{tau<t} w_tau (= exp(cum_prev[t])).
//
// Bounded exponents. The kernel takes no exp and no log: every decay
// factor is a product of clamped w in [1e-38, 1], i.e. exp of a sum of
// clamped log w over a range of tokens, which is <= 0, so no factor can
// exceed 1 and strong decay can only underflow towards 0 (where the true
// term is smaller still), never overflow. The two sub-blocks of a chunk
// (tokens 0-15 and 16-31), each of two halves of 8, give these factors,
// each a running product, computed per channel by one thread:
//   E[t]  = prod_{b(t) <= tau < t} w   (b(t): the first token of t's block)
//   F[s]  = prod_{s < tau <= e(s)} w   (e(s): the last token of s's block)
//   E8[t] = prod_{h(t) <= tau < t} w   (t in an upper half, h(t) its start)
//   F8[s] = prod_{s < tau <= g(s)} w   (s in a lower half, g(s) its end)
//   D0, D1 = the products over sub-blocks 0 and 1.
// Then, all products of factors <= 1:
//   r o dec_t         = r E[t] (t < 16),  r E[t] D0 (t >= 16)
//   k o prod_{s<tau<L} = k F[s] D1 (s < 16), k F[s] (s >= 16);  dec_L = D0 D1
//   a[t,s], t >= 16 > s: att = F[s] E[t], factored through the end of
//                         block 0: sum_i (r E)[t,i] (k F)[s,i], one product
//   a[t,s], t in the upper half of a block, s in its lower half:
//                         att = F8[s] E8[t], factored through the end of
//                         the lower half: (r E8)(k F8)^T, one product
//   a[t,s], s < t in one half: att built on the CUDA cores by walking t
//                         (att *= w_t), never through a ratio.
// exp(-cum), 1 / w or any other factor > 1 is never formed.
//
// Precision: every product is mma.sync.m16n8k16 bf16 -> f32. r, k and v
// are bf16 on the path and enter exact; the float32 operands (r o dec,
// r E, k F, r E8, k F8, k o prod w, the state S and the score tiles) are
// split into bf16 pairs hi + lo (hi = bf16(x), lo = bf16(x - hi), about
// 2^-17 relative). A product of one f32 operand with an exact one is two
// products (hi and lo); of two f32 operands three (hi.hi + lo.hi +
// hi.lo; lo.lo is below 2^-16). A single bf16 rounding (2^-9) would miss
// the state's 2e-4 tolerance (tests/test_torch_kernel_numerics.py shows
// it). The state stays in f32 accumulator registers across chunks; its
// hi/lo copy in shared memory only feeds the next chunk's y. y is rounded
// to bf16 once, at the store.
//
// Bound, at rwkv6-7b's prefill (B=4, S=512, H=64, hd=64; r, k, v and y
// bf16, w f32): reading every input once and writing y and the f32 state
// once is 104,873,984 B, 31.3 us at 3.35 TB/s: bound by bytes (the byte
// count is chip_smoke.py's). The chunked products are about 5 GFLOP with
// the hi/lo splits, 5 us at 989 TFLOP/s.
//
// Design and split. One block of 8 warps per (b, h) walks the S/32
// chunks in order. The columns j of the state are independent (S[:, j]
// and y[:, j] read no other column), so the warps split j inside the
// block instead of across blocks: the decay factors and the score tile
// are computed once per (b, h, chunk) and shared through shared memory,
// not recomputed per column slice, and r, k, w are read from device
// memory once. 256 blocks of 8 warps, two an SM (106,624 B of shared
// memory each at hd = 64), give 16 warps an SM. The next chunk's r, k,
// v, w are copied into the other half of a double buffer with cp.async
// while this chunk is computed. Per chunk, three phases between barriers:
//  1. threads 0..hd-1 run the prefix products E, E8 (and D0) of one
//     channel each, writing r o dec, r E and r E8 as hi/lo pairs; threads
//     hd..2hd-1 the suffix products F, F8 (and D1), writing k F, k F8 and
//     k o prod w; threads 2hd..4hd-1 (warps 4-7) walk the four 8 x 8
//     diagonal triangles (s < t in one half, plus the bonus r.(u o k) at
//     s = t): a lane owns 8 channels of a pair of s (s and 7 - s, 9 steps
//     in all) and walks t, writing each step's partial sum to shared
//     memory; after the walk the lanes of the warp add each a[t, s]'s hd/8
//     partials in a fixed order (no dependent shuffle chain per step, no
//     atomics);
//  2. warp (q, jg) owns y's rows 16q..16q+15 and columns 16jg..16jg+15:
//     (r o dec)(S_hi + S_lo) in three products, the off-diagonal scores
//     (q = 1) in three, kept in registers (an m16n8 accumulator pair is an
//     m16n8k16 A operand) and split for a.v; the diagonal block from the
//     walked triangles and (r E8)(k F8)^T in three products, again in
//     registers; then y stored as bf16;
//  3. warp (ib, jg..) owns state rows 16ib..16ib+15 and two column groups:
//     S = dec_L S + (k o prod w)^T v, then S_hi, S_lo to shared memory.
// hd < 16 is zero-padded to 16 channels in shared memory (w = 1 there),
// never in device memory; a ragged last chunk (S % 32 != 0, S < 32
// included) is filled with k = 0 and w = 1, as `wkv_chunked` pads, so
// the state is left as it is. Any S >= 1 and hd in {8, 16, 32, 64}.
//
// Built without --use_fast_math and with --fmad=false (mma is unaffected).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kL = 32;               // tokens per chunk
constexpr int kSub = 16;             // tokens per sub-block, two a chunk
constexpr int kHalf = 8;             // tokens per half of a sub-block
constexpr int kDgS = kSub + 1;       // row stride of a diagonal block (f32)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; with valid == false they are zeroed.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
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
// (v0, v1) = hi + lo to about 2^-17 relative: two registers of bf16 pairs.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const bf16 h0 = __float2bfloat16_rn(v0), h1 = __float2bfloat16_rn(v1);
  hi = pack_bf16(__bfloat162float(h0), __bfloat162float(h1));
  lo = pack_bf16(v0 - __bfloat162float(h0), v1 - __bfloat162float(h1));
}
// x = hi[o] + lo[o], stored as two bf16 values.
__device__ __forceinline__ void store_split(bf16* hi, bf16* lo, int o,
                                            float x) {
  const bf16 h = __float2bfloat16_rn(x);
  hi[o] = h;
  lo[o] = __float2bfloat16_rn(x - __bfloat162float(h));
}
// 8 consecutive bf16 of shared memory (16-byte aligned) as floats.
__device__ __forceinline__ void load8(float (&x)[8], const bf16* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&words[e]));
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ float clamp_w(float w) {
  return fminf(fmaxf(w, 1e-38f), 1.f);
}

// Shared memory of one block; offsets in bytes. DP: hd padded to >= 16.
template <int DP> struct Smem {
  static constexpr int RS = DP + 8;           // bf16 row stride (16-byte
                                              // rows, conflict-free ldmatrix)
  static constexpr size_t kRow = RS * sizeof(bf16);
  static constexpr size_t r_off = 0;                        // [2][kL][RS]
  static constexpr size_t k_off = r_off + 2 * kL * kRow;    // [2][kL][RS]
  static constexpr size_t v_off = k_off + 2 * kL * kRow;    // [2][kL][RS]
  static constexpr size_t rdh_off = v_off + 2 * kL * kRow;  // r o dec, hi
  static constexpr size_t rdl_off = rdh_off + kL * kRow;    //          lo
  static constexpr size_t kdh_off = rdl_off + kL * kRow;    // k o prod w
  static constexpr size_t kdl_off = kdh_off + kL * kRow;
  static constexpr size_t reh_off = kdl_off + kL * kRow;    // r E, t >= 16
  static constexpr size_t rel_off = reh_off + kSub * kRow;
  static constexpr size_t kfh_off = rel_off + kSub * kRow;  // k F, s < 16
  static constexpr size_t kfl_off = kfh_off + kSub * kRow;
  static constexpr size_t r8h_off = kfl_off + kSub * kRow;  // r E8, upper
  static constexpr size_t r8l_off = r8h_off + kSub * kRow;  //   halves
  static constexpr size_t k8h_off = r8l_off + kSub * kRow;  // k F8, lower
  static constexpr size_t k8l_off = k8h_off + kSub * kRow;  //   halves
  static constexpr size_t sh_off = k8l_off + kSub * kRow;   // S [DP][RS]
  static constexpr size_t sl_off = sh_off + DP * kRow;
  static constexpr size_t w_off = sl_off + DP * kRow;       // f32 [2][kL][DP]
  static constexpr size_t dg_off = w_off + 2 * kL * DP * sizeof(float);
  static constexpr size_t u_off = dg_off + 2 * kSub * kDgS * sizeof(float);
  static constexpr size_t el_off = u_off + DP * sizeof(float);
  static constexpr size_t ps_off = el_off + DP * sizeof(float);  // diagonal
  static constexpr size_t bytes =                              // partials
      ps_off + DP / 16 * 32 * (kHalf + 1) * sizeof(float);
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
wkv_chunked_tc(const bf16* __restrict__ r, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, bf16* __restrict__ y,
               float* __restrict__ state, int S, int H, int hd) {
  using L = Smem<DP>;
  constexpr int RS = L::RS;
  constexpr int NK = DP / 16;        // 16-wide channel blocks (k-steps,
                                     // state row blocks, y column groups)
  constexpr int JSTEP = kWarps / NK; // state column groups: jg0 + p JSTEP
  constexpr int TPW = (NK * NK + kWarps - 1) / kWarps;  // state tiles a warp
  constexpr int CG = DP / 8;         // diagonal: lanes (8 channels each)
                                     // that share one s pair
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Rs = reinterpret_cast<bf16*>(smem + L::r_off);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
  bf16* Rdh = reinterpret_cast<bf16*>(smem + L::rdh_off);
  bf16* Rdl = reinterpret_cast<bf16*>(smem + L::rdl_off);
  bf16* Kdh = reinterpret_cast<bf16*>(smem + L::kdh_off);
  bf16* Kdl = reinterpret_cast<bf16*>(smem + L::kdl_off);
  bf16* Reh = reinterpret_cast<bf16*>(smem + L::reh_off);
  bf16* Rel = reinterpret_cast<bf16*>(smem + L::rel_off);
  bf16* Kfh = reinterpret_cast<bf16*>(smem + L::kfh_off);
  bf16* Kfl = reinterpret_cast<bf16*>(smem + L::kfl_off);
  bf16* R8h = reinterpret_cast<bf16*>(smem + L::r8h_off);
  bf16* R8l = reinterpret_cast<bf16*>(smem + L::r8l_off);
  bf16* K8h = reinterpret_cast<bf16*>(smem + L::k8h_off);
  bf16* K8l = reinterpret_cast<bf16*>(smem + L::k8l_off);
  bf16* Sh = reinterpret_cast<bf16*>(smem + L::sh_off);
  bf16* Sl = reinterpret_cast<bf16*>(smem + L::sl_off);
  float* Ws = reinterpret_cast<float*>(smem + L::w_off);
  float* Dg = reinterpret_cast<float*>(smem + L::dg_off);
  float* us = reinterpret_cast<float*>(smem + L::u_off);
  float* eLs = reinterpret_cast<float*>(smem + L::el_off);
  float* Ps = reinterpret_cast<float*>(smem + L::ps_off);

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const long long tok = static_cast<long long>(H) * hd;     // per token
  const long long base = (static_cast<long long>(b) * S * H + h) * hd;
  const int n_chunks = (S + kL - 1) / kL;

  // Channels hd..DP-1 (hd < 16 only): r, k, v = 0 and w = 1 in both
  // buffers, which no copy overwrites; u = 0 there.
  for (int x = tid; x < 2 * kL * DP; x += kThreads) {
    const int row = x / DP, i = x % DP;
    if (i >= hd) {
      Rs[row * RS + i] = Ks[row * RS + i] = Vs[row * RS + i] =
          __float2bfloat16_rn(0.f);
      Ws[row * DP + i] = 1.f;
    }
  }
  for (int i = tid; i < DP; i += kThreads) us[i] = i < hd ? u[h * hd + i] : 0.f;

  // Tokens past S are zero-filled (r = k = v = 0); their w reads as 1.
  auto load_chunk = [&](int c, int buf) {
    const int t0 = c * kL;
    const int cnt = min(kL, S - t0);
    const int nb = hd / 8;             // 16-byte pieces of a bf16 row
    for (int x = tid; x < kL * nb; x += kThreads) {
      const int t = x / nb, col = (x % nb) * 8;
      const bool in = t < cnt;
      const long long src = in ? base + (t0 + t) * tok + col : 0;
      const int dst = (buf * kL + t) * RS + col;
      cp_async16(Rs + dst, r + src, in);
      cp_async16(Ks + dst, k + src, in);
      cp_async16(Vs + dst, v + src, in);
    }
    const int nw = hd / 4;             // 16-byte pieces of an f32 row
    for (int x = tid; x < kL * nw; x += kThreads) {
      const int t = x / nw, col = (x % nw) * 4;
      const bool in = t < cnt;
      const long long src = in ? base + (t0 + t) * tok + col : 0;
      cp_async16(Ws + (buf * kL + t) * DP + col, w + src, in);
    }
  };

  float st[TPW][2][4];                 // this warp's state tiles (f32)
#pragma unroll
  for (int p = 0; p < TPW; ++p)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[p][n][e] = 0.f;
  const int ib = warp % NK, jg0 = warp / NK;   // phase 3's tiles

  load_chunk(0, 0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    const int cnt = min(kL, S - c * kL);
    cp_async_wait_all();
    __syncthreads();                   // chunk c in; chunk c-1 done
    if (c + 1 < n_chunks) load_chunk(c + 1, buf ^ 1);
    cp_async_commit();
    const bf16* rb = Rs + buf * kL * RS;
    const bf16* kb = Ks + buf * kL * RS;
    const bf16* vb = Vs + buf * kL * RS;
    const float* wb = Ws + buf * kL * DP;
    auto wc = [&](int t, int i) {
      return t < cnt ? clamp_w(wb[t * DP + i]) : 1.f;
    };

    // ---- phase 1: decay factors (products of w <= 1) and diagonal blocks
    if (tid < DP) {                    // prefix products of channel i
      const int i = tid;
      float e = 1.f, e8 = 1.f;         // from the block's, the half's start
      for (int t = 0; t < kSub; ++t) {
        const float rv = __bfloat162float(rb[t * RS + i]), wt = wc(t, i);
        store_split(Rdh, Rdl, t * RS + i, rv * e);
        e *= wt;
        if (t >= kHalf) {
          store_split(R8h, R8l, (t - kHalf) * RS + i, rv * e8);
          e8 *= wt;
        }
      }
      const float d0 = e;
      e = e8 = 1.f;
      for (int t = kSub; t < kL; ++t) {
        const float rv = __bfloat162float(rb[t * RS + i]), wt = wc(t, i);
        const float x = rv * e;
        store_split(Reh, Rel, (t - kSub) * RS + i, x);
        store_split(Rdh, Rdl, t * RS + i, x * d0);
        e *= wt;
        if (t >= kSub + kHalf) {
          store_split(R8h, R8l, (t - kSub) * RS + i, rv * e8);
          e8 *= wt;
        }
      }
    } else if (tid < 2 * DP) {         // suffix products of channel i
      const int i = tid - DP;
      float f = 1.f, f8 = 1.f;         // to the block's, the half's end
      for (int s = kL - 1; s >= kSub; --s) {
        const float kv = __bfloat162float(kb[s * RS + i]), ws = wc(s, i);
        store_split(Kdh, Kdl, s * RS + i, kv * f);
        f *= ws;
        if (s < kSub + kHalf) {
          store_split(K8h, K8l, (s - kHalf) * RS + i, kv * f8);
          f8 *= ws;
        }
      }
      const float d1 = f;
      f = f8 = 1.f;
      for (int s = kSub - 1; s >= 0; --s) {
        const float kv = __bfloat162float(kb[s * RS + i]), ws = wc(s, i);
        const float x = kv * f;
        store_split(Kfh, Kfl, s * RS + i, x);
        store_split(Kdh, Kdl, s * RS + i, x * d1);
        f *= ws;
        if (s < kHalf) {
          store_split(K8h, K8l, s * RS + i, kv * f8);
          f8 *= ws;
        }
      }
      eLs[i] = f * d1;                 // dec_L = D0 D1
    } else if (tid < 4 * DP) {         // the four 8 x 8 diagonal triangles
      const int d = tid - 2 * DP;
      const int cg = d % CG, grp = d / CG;
      const int sp = grp % 4, row0 = grp / 4 * kHalf;  // (block, half)
      const int i0 = cg * 8;
      const int n1 = kHalf - sp;       // steps of s = sp; then s = 7 - sp
      float uu[8], kk[8], att[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        uu[e] = us[i0 + e];
        kk[e] = 0.f;
        att[e] = 1.f;
      }
      // this lane's 8 channels of a[t, s] at step n: part[g][n][cg], g the
      // lane's group (one s pair) in its warp
      float* part = Ps + (warp - 2 * DP / 32) * 32 * (kHalf + 1);
      const int g = (lane / CG) * (kHalf + 1);
      for (int n = 0; n <= kHalf; ++n) {
        const bool first = n < n1;
        const int s = first ? sp : kHalf - 1 - sp;
        const int t = first ? sp + n : kHalf - 1 - sp + (n - n1);
        float rv[8];
        load8(rv, rb + (row0 + t) * RS + i0);
        float val[2] = {0.f, 0.f};     // two chains of 4 channels
        if (t == s) {                  // the bonus; att(s + 1, s) = 1
          load8(kk, kb + (row0 + s) * RS + i0);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            att[e] = 1.f;
            val[e & 1] = fmaf(rv[e], uu[e] * kk[e], val[e & 1]);
          }
        } else {                       // att(t, s), then att(t + 1, s)
          float wv[8];
          if (row0 + t < cnt) {
            const float4 w0 =
                *reinterpret_cast<const float4*>(wb + (row0 + t) * DP + i0);
            const float4 w1 = *reinterpret_cast<const float4*>(
                wb + (row0 + t) * DP + i0 + 4);
            wv[0] = clamp_w(w0.x); wv[1] = clamp_w(w0.y);
            wv[2] = clamp_w(w0.z); wv[3] = clamp_w(w0.w);
            wv[4] = clamp_w(w1.x); wv[5] = clamp_w(w1.y);
            wv[6] = clamp_w(w1.z); wv[7] = clamp_w(w1.w);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) wv[e] = 1.f;
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            val[e & 1] = fmaf(rv[e], kk[e] * att[e], val[e & 1]);
            att[e] *= wv[e];
          }
        }
        part[(g + n) * CG + cg] = val[0] + val[1];
      }
      __syncwarp();
      // a[t, s] = the sum of its group's CG partials, in a fixed order
      for (int o = lane; o < 32 / CG * (kHalf + 1); o += 32) {
        const int n = o % (kHalf + 1);
        const int go = (warp - 2 * DP / 32) * 32 / CG + o / (kHalf + 1);
        const int spo = go % 4, r0 = go / 4 * kHalf;
        const int n1o = kHalf - spo;
        const bool first = n < n1o;
        const int s = first ? spo : kHalf - 1 - spo;
        const int t = first ? spo + n : kHalf - 1 - spo + (n - n1o);
        const float* pp = part + o * CG;
        float sum = 0.f;
        if constexpr (CG % 4 == 0) {
#pragma unroll
          for (int x = 0; x < CG; x += 4) {
            const float4 p4 = *reinterpret_cast<const float4*>(pp + x);
            sum += (p4.x + p4.y) + (p4.z + p4.w);
          }
        } else {
#pragma unroll
          for (int x = 0; x < CG; ++x) sum += pp[x];
        }
        Dg[(r0 + t) * kDgS + r0 % kSub + s] = sum;
      }
    }
    __syncthreads();

    // ---- phase 2: y rows 16q.., columns 16jg..
    if (warp < 2 * NK) {
      const int q = warp & 1, jg = warp >> 1;
      const int row0 = q * kSub, col0 = jg * 16;
      float acc[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      // a (hi + lo) . v over the 16 rows of v from vrow0
      auto av = [&](const uint32_t (&ph)[4], const uint32_t (&pl)[4],
                    int vrow0) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vb + (vrow0 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                          col0 + (lane >> 4) * 8);
        mma16816(acc[0], ph, bv[0], bv[1]);
        mma16816(acc[1], ph, bv[2], bv[3]);
        mma16816(acc[0], pl, bv[0], bv[1]);
        mma16816(acc[1], pl, bv[2], bv[3]);
      };
      if (c > 0) {                     // (r o dec) S0
#pragma unroll
        for (int kq = 0; kq < NK; ++kq) {
          uint32_t ah[4], al[4], bh[4], bl[4];
          const int ao = (row0 + (lane & 15)) * RS + kq * 16 + (lane >> 4) * 8;
          ldsm_x4(ah, Rdh + ao);
          ldsm_x4(al, Rdl + ao);
          const int bo = (kq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                         col0 + (lane >> 4) * 8;
          ldsm_x4_t(bh, Sh + bo);
          ldsm_x4_t(bl, Sl + bo);
          mma16816(acc[0], ah, bh[0], bh[1]);
          mma16816(acc[1], ah, bh[2], bh[3]);
          mma16816(acc[0], al, bh[0], bh[1]);
          mma16816(acc[1], al, bh[2], bh[3]);
          mma16816(acc[0], ah, bl[0], bl[1]);
          mma16816(acc[1], ah, bl[2], bl[3]);
        }
      }
      if (q == 1) {                    // scores t >= 16 > s: (r E)(k F)^T
        float sc[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
        for (int kq = 0; kq < NK; ++kq) {
          uint32_t ah[4], al[4], bh[4], bl[4];
          const int ao = (lane & 15) * RS + kq * 16 + (lane >> 4) * 8;
          ldsm_x4(ah, Reh + ao);
          ldsm_x4(al, Rel + ao);
          const int bo = ((lane & 7) + ((lane >> 4) << 3)) * RS + kq * 16 +
                         ((lane >> 3) & 1) * 8;
          ldsm_x4(bh, Kfh + bo);
          ldsm_x4(bl, Kfl + bo);
          mma16816(sc[0], ah, bh[0], bh[1]);
          mma16816(sc[1], ah, bh[2], bh[3]);
          mma16816(sc[0], al, bh[0], bh[1]);
          mma16816(sc[1], al, bh[2], bh[3]);
          mma16816(sc[0], ah, bl[0], bl[1]);
          mma16816(sc[1], ah, bl[2], bl[3]);
        }
        // the accumulator pair is the A operand of a . v (rows t, k = s)
        uint32_t ph[4], pl[4];
        split2(sc[0][0], sc[0][1], ph[0], pl[0]);
        split2(sc[0][2], sc[0][3], ph[1], pl[1]);
        split2(sc[1][0], sc[1][1], ph[2], pl[2]);
        split2(sc[1][2], sc[1][3], ph[3], pl[3]);
        av(ph, pl, 0);
      }
      {                                // the diagonal block, s <= t
        // t in the upper half, s in the lower: (r E8)(k F8)^T, factored
        // through the end of the lower half; only A's rows 8-15 are live
        float qd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kq = 0; kq < NK; ++kq) {
          uint32_t a4[4], b4[4];       // hi k 0-7, hi k 8-15, lo, lo
          const int o8 = (q * kHalf + (lane & 7)) * RS + kq * 16 +
                         ((lane >> 3) & 1) * 8;
          ldsm_x4(a4, (lane < 16 ? R8h : R8l) + o8);
          ldsm_x4(b4, (lane < 16 ? K8h : K8l) + o8);
          const uint32_t ah[4] = {0u, a4[0], 0u, a4[1]};
          const uint32_t al[4] = {0u, a4[2], 0u, a4[3]};
          mma16816(qd, ah, b4[0], b4[1]);
          mma16816(qd, al, b4[0], b4[1]);
          mma16816(qd, ah, b4[2], b4[3]);
        }
        const float* dg = Dg + q * kSub * kDgS;
        float m[8];                    // a0.x a0.y a1.x a1.y a2.. a3..
#pragma unroll
        for (int e = 0; e < 8; ++e) {  // the walked triangles
          const int s = (e >> 2) * 8 + tig * 2 + (e & 1);
          const int t = gid + ((e >> 1) & 1) * 8;
          m[e] = s <= t && (s >= kHalf || t < kHalf) ? dg[t * kDgS + s] : 0.f;
        }
        m[2] = qd[2];                  // rows 8-15, columns 0-7
        m[3] = qd[3];
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) split2(m[2 * x], m[2 * x + 1], ph[x], pl[x]);
        av(ph, pl, row0);
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int t = row0 + gid + rr * 8;
        if (t >= cnt) continue;
        bf16* yp = y + base + (static_cast<long long>(c) * kL + t) * tok;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int j = col0 + n * 8 + tig * 2;
          if (j < hd)
            *reinterpret_cast<__nv_bfloat162*>(yp + j) =
                __floats2bfloat162_rn(acc[n][2 * rr], acc[n][2 * rr + 1]);
        }
      }
    }
    __syncthreads();                   // S_hi, S_lo fully read

    // ---- phase 3: S = dec_L S + (k o prod w)^T v; rows 16ib.., columns
    // 16jg.. for jg = jg0, jg0 + JSTEP, ...
    if (jg0 < NK) {
      const float e0 = eLs[ib * 16 + gid], e1 = eLs[ib * 16 + gid + 8];
#pragma unroll
      for (int p = 0; p < TPW; ++p)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          st[p][n][0] *= e0;
          st[p][n][1] *= e0;
          st[p][n][2] *= e1;
          st[p][n][3] *= e1;
        }
#pragma unroll
      for (int kq = 0; kq < kL / 16; ++kq) {
        uint32_t ah[4], al[4];         // (k o prod w)^T: rows i, columns s
        const int ao = (kq * 16 + (lane & 7) + (lane >> 4) * 8) * RS +
                       ib * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4_t(ah, Kdh + ao);
        ldsm_x4_t(al, Kdl + ao);
#pragma unroll
        for (int p = 0; p < TPW; ++p) {
          const int jg = jg0 + p * JSTEP;
          if (jg >= NK) continue;
          uint32_t bv[4];
          ldsm_x4_t(bv, vb + (kq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 RS + jg * 16 + (lane >> 4) * 8);
          mma16816(st[p][0], ah, bv[0], bv[1]);
          mma16816(st[p][0], al, bv[0], bv[1]);
          mma16816(st[p][1], ah, bv[2], bv[3]);
          mma16816(st[p][1], al, bv[2], bv[3]);
        }
      }
#pragma unroll
      for (int p = 0; p < TPW; ++p) {
        const int jg = jg0 + p * JSTEP;
        if (jg >= NK) continue;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int o = (ib * 16 + gid + rr * 8) * RS + jg * 16 + n * 8 +
                          tig * 2;
            uint32_t hi, lo;
            split2(st[p][n][2 * rr], st[p][n][2 * rr + 1], hi, lo);
            *reinterpret_cast<uint32_t*>(Sh + o) = hi;
            *reinterpret_cast<uint32_t*>(Sl + o) = lo;
          }
      }
    }
  }

  // the final state, rows i < hd and columns j < hd
  if (jg0 < NK) {
    float* sp = state + (static_cast<long long>(b) * H + h) * hd * hd;
#pragma unroll
    for (int p = 0; p < TPW; ++p) {
      const int jg = jg0 + p * JSTEP;
      if (jg >= NK) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = ib * 16 + gid + rr * 8;
          const int j = jg * 16 + n * 8 + tig * 2;
          if (i < hd && j < hd)
            *reinterpret_cast<float2*>(sp + i * hd + j) =
                make_float2(st[p][n][2 * rr], st[p][n][2 * rr + 1]);
        }
    }
  }
}

template <int DP>
int launch_tc(const void* r, const void* k, const void* v, const float* w,
              const float* u, void* y, float* state, int B, int S, int H,
              int hd, cudaStream_t st) {
  static bool configured = false;      // dynamic shared memory set
  const size_t bytes = Smem<DP>::bytes;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv_chunked_tc<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  wkv_chunked_tc<DP><<<B * H, kThreads, bytes, st>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), w, u, static_cast<bf16*>(y), state, S, H,
      hd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). r, k, v, y: bf16[B,S,H,hd]; w:
// f32[B,S,H,hd]; u: f32[H,hd]; state: f32[B,H,hd,hd] (written); all
// contiguous, r, k, v and w on 16-byte boundaries; hd in {8, 16, 32, 64}.
// Launches on `stream` and returns cudaGetLastError() as an int (0 =
// launched).
extern "C" int wkv_tc_launch(const void* r, const void* k, const void* v,
                             const float* w, const float* u, void* y,
                             float* state, int B, int S, int H, int hd,
                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 8:
    case 16: return launch_tc<16>(r, k, v, w, u, y, state, B, S, H, hd, st);
    case 32: return launch_tc<32>(r, k, v, w, u, y, state, B, S, H, hd, st);
    case 64: return launch_tc<64>(r, k, v, w, u, y, state, B, S, H, hd, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
