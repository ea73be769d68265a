// Node -> CDU group segment sums for Hopper (sm_90a): the device side shared
// by fused_cooling.cu and group_power.cu.
//
// Group g of a row of N node powers is the contiguous ceil-span
// [g*span, min((g+1)*span, N)) (the last group is ragged and may be empty).
// Both kernels read each node power once and are bound by device memory:
// at Frontier's width (S=8, N=9,600: 307 KB) the launch sets the time, at
// Fugaku's (N=158,976: 5.1 MB at S=8) the bytes do. So:
//
// * Nodes are taken four at a time ("quads", 16 bytes). When N % 4 == 0
//   and span % 4 == 0 every group starts on a 16-byte boundary and a quad
//   is one 128-bit load; otherwise each quad is four scalar loads masked
//   at the group's end. Each thread issues all its loads (up to kQuads
//   quads) before its first add, so they are in flight together.
// * A span of at most 32 * kQuads quads (Frontier: 96) is summed by one
//   warp, by shuffles only: no shared memory, no block barrier, several
//   groups in a block.
// * A longer span (Fugaku: 1,242 quads) is one CTA of kCtaThreads per
//   group: warp shuffles, then one barrier and warp 0 over the warp
//   partials. No atomics, no second launch. (Splitting a group over a
//   thread-block cluster combined through distributed shared memory
//   measured 1.6-4.3x slower at Fugaku's width on the H100: PERF.md.)
// * Launched with a programmatic dependency on the previous kernel
//   (grid_wait() below): the launch overlaps the previous kernel's tail.
//
// The summation order is a function of (N, G) alone, never of the row s or
// of the number of rows S, so a row of a sweep sums exactly as a solo run
// (the engine's row-vs-solo bit-identity). Thread t of a unit of T threads
// (a warp or a CTA) adds, in this order, the nodes of quads t, t + T,
// t + 2T, ... of its group (each quad's four nodes in order) into a float
// starting at 0; a warp adds its lanes by an xor butterfly (offsets
// 16..1); a CTA of W warps adds its warp partials by a butterfly over W
// lanes (offsets W/2..1). The scalar path keeps the same order, so it
// gives the vector path's bits wherever both apply. power_topo.plan()
// mirrors the launch plan and tests/test_torch_power_topo_design.py
// emulates this order in numpy.
//
// Build without --use_fast_math and with --fmad=false: adds only here, but
// the CDU update of fused_cooling.cu divides in IEEE f32 and rounds every
// product before the following add, as the reference does.

#pragma once

#include <cuda_runtime.h>

namespace segsum {

constexpr int kQuads = 4;            // quads a thread has in flight at once
constexpr int kWarpBlockWarps = 4;   // warp mode: groups (warps) per block
constexpr int kCtaThreads = 512;     // CTA mode: threads a CTA
constexpr int kCtaWarps = kCtaThreads / 32;

// The launch plan, a function of (N, G) only apart from n_scen (mirrors
// repro_torch/kernels/power_topo/power_topo.py plan()).
struct Plan {
  int n_scen;       // S: rows (scenarios)
  int n_nodes;      // N
  int n_groups;     // G
  int span;         // ceil(N / G) nodes per group
  int quads;        // ceil(span / 4) quads per group
  int rounds;       // rounds of kQuads loads per thread
};

// One or two running sums: the plain group sum, or (split) the idle floor
// min(p, idle) and the dynamic share p - min(p, idle).
// (A trivial type, so it can live in __shared__; start from Sums{}.)
template <bool kSplit>
struct Sums {
  float a;
  float b;
  __device__ __forceinline__ void add(float p, float idle) {
    if (kSplit) {
      const float f = fminf(p, idle);
      a += f;
      b += p - f;
    } else {
      a += p;
    }
  }
  __device__ __forceinline__ void add(const Sums& o) {
    a += o.a;
    if (kSplit) b += o.b;
  }
  __device__ __forceinline__ Sums shfl_xor(int off) const {
    Sums o{};
    o.a = __shfl_xor_sync(0xffffffffu, a, off);
    if (kSplit) o.b = __shfl_xor_sync(0xffffffffu, b, off);
    return o;
  }
};

// Xor butterfly over the lanes [0, width) of each aligned group of
// `width` lanes: afterwards every lane holds the same total (IEEE adds
// commute, so each pair of partners forms the same bits).
template <bool kSplit>
__device__ __forceinline__ void butterfly(Sums<kSplit>& x, int width) {
  for (int off = width >> 1; off > 0; off >>= 1) x.add(x.shfl_xor(off));
}

// Thread t's partial over one group of n nodes starting at `grp`: quads
// t, t + T, t + 2T, ... in order, kQuads loads issued before the adds of
// each round.
template <bool kVec, bool kSplit>
__device__ __forceinline__ void thread_sums(const float* __restrict__ grp,
                                            int n, int t, int T, int rounds,
                                            float idle, Sums<kSplit>& acc) {
  const int q1 = (n + 3) / 4;
  for (int r = 0; r < rounds; ++r) {
    float v[kQuads][4];
    int m[kQuads];  // nodes of each quad to add (0 = quad not this thread's)
#pragma unroll
    for (int j = 0; j < kQuads; ++j) {
      const int q = t + (r * kQuads + j) * T;
      m[j] = q < q1 ? min(4, n - 4 * q) : 0;
      if (kVec) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m[j] > 0) x = __ldg(reinterpret_cast<const float4*>(grp) + q);
        v[j][0] = x.x;
        v[j][1] = x.y;
        v[j][2] = x.z;
        v[j][3] = x.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          v[j][c] = c < m[j] ? __ldg(grp + 4 * q + c) : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kQuads; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c < m[j]) acc.add(v[j][c], idle);
  }
}

// Nodes in group g: [g*span, min((g+1)*span, N)), empty past the end.
__device__ __forceinline__ int group_nodes(const Plan& p, int g) {
  const long long lo = static_cast<long long>(g) * p.span;
  const long long hi = min(lo + p.span, static_cast<long long>(p.n_nodes));
  return hi > lo ? static_cast<int>(hi - lo) : 0;
}

// Programmatic dependent launch: let the next kernel on the stream be
// scheduled now, then wait until the previous one has finished and its
// writes are visible (it may still be writing node_pw). Nothing is read
// from global memory before grid_wait().
__device__ __forceinline__ void grid_wait() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// An Op gives the kernel its epilogue:
//   static constexpr bool kSplit;  float idle;  struct State;
//   State begin(int s, int g, long long i)  -- leader only, at entry
//   void end(int s, int g, long long i, const State&, const Sums&)
//                                           -- leader only, with the totals
// where i = s * G + g indexes the [S, G] outputs.

// One warp per (s, g); kWarpBlockWarps groups per block.
template <bool kVec, class Op>
__global__ void __launch_bounds__(kWarpBlockWarps * 32)
warp_kernel(const float* __restrict__ node_pw, Plan p, Op op) {
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kWarpBlockWarps + (threadIdx.x >> 5);
  if (pair >= p.n_scen * p.n_groups) return;
  const int s = pair / p.n_groups;
  const int g = pair - s * p.n_groups;
  const long long i = static_cast<long long>(s) * p.n_groups + g;
  const int n = group_nodes(p, g);
  const float* grp = node_pw + static_cast<long long>(s) * p.n_nodes +
                     static_cast<long long>(g) * p.span;
  grid_wait();
  typename Op::State st{};
  if (lane == 0) st = op.begin(s, g, i);  // overlaps the node loads below
  Sums<Op::kSplit> acc{};
  thread_sums<kVec>(grp, n, lane, 32, p.rounds, op.idle, acc);
  butterfly(acc, 32);
  if (lane == 0) op.end(s, g, i, st, acc);
}

// One CTA of kCtaThreads per (s, g): grid (G, S); thread 0 ends with the
// group's total.
template <bool kVec, class Op>
__global__ void __launch_bounds__(kCtaThreads)
cta_kernel(const float* __restrict__ node_pw, Plan p, Op op) {
  const int g = blockIdx.x;
  const int s = blockIdx.y;
  const long long i = static_cast<long long>(s) * p.n_groups + g;
  const int n = group_nodes(p, g);
  const float* grp = node_pw + static_cast<long long>(s) * p.n_nodes +
                     static_cast<long long>(g) * p.span;
  grid_wait();
  typename Op::State st{};
  if (threadIdx.x == 0) st = op.begin(s, g, i);  // overlaps the node loads
  Sums<Op::kSplit> acc{};
  thread_sums<kVec>(grp, n, threadIdx.x, kCtaThreads, p.rounds, op.idle, acc);
  butterfly(acc, 32);

  __shared__ Sums<Op::kSplit> warp_part[kCtaWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    Sums<Op::kSplit> x{};
    if (lane < kCtaWarps) x = warp_part[lane];
    butterfly(x, kCtaWarps);
    if (lane == 0) op.end(s, g, i, st, x);
  }
}

// Launch `kernel` on `stream` with a programmatic dependency on the
// previous kernel; returns the launch's error or cudaGetLastError().
template <class Op>
cudaError_t launch_ex(void (*kernel)(const float*, Plan, Op), dim3 grid,
                      int threads, const float* node_pw, const Plan& p,
                      const Op& op, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, node_pw, p, op);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool kVec, class Op>
cudaError_t launch_vec(const float* node_pw, const Plan& p, const Op& op,
                       cudaStream_t stream) {
  if (p.quads > 32 * kQuads)
    return launch_ex(cta_kernel<kVec, Op>, dim3(p.n_groups, p.n_scen, 1),
                     kCtaThreads, node_pw, p, op, stream);
  const int pairs = p.n_scen * p.n_groups;
  return launch_ex(warp_kernel<kVec, Op>,
                   dim3((pairs + kWarpBlockWarps - 1) / kWarpBlockWarps, 1,
                        1),
                   kWarpBlockWarps * 32, node_pw, p, op, stream);
}

// Launch the plan's kernel on `stream`: one warp per group when a span
// fits one warp's loads, else one CTA per group. Returns the CUDA error
// (cudaSuccess: launched).
template <class Op>
cudaError_t launch(const float* node_pw, const Plan& p, int vec, const Op& op,
                   cudaStream_t stream) {
  return vec ? launch_vec<true>(node_pw, p, op, stream)
             : launch_vec<false>(node_pw, p, op, stream);
}

}  // namespace segsum
