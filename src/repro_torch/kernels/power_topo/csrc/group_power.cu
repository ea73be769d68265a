// Node -> CDU group power segment sum, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `group_power_pallas` (`_kernel`) in
// src/repro/kernels/power_topo/power_topo.py. Plain version:
// repro_torch/kernels/power_topo/ref.py `group_power_ref` (plain mode) and
// `group_power_split_ref` (split mode).
//
// Per (scenario s, CDU group g), over the group's contiguous ceil-span
// [g*span, min((g+1)*span, N))  (the last group is ragged, and may be empty):
//   plain:  out0 = sum p                          (the TPU kernel's sum)
//   split:  out0 = sum min(p, idle)               (idle floor per group)
//           out1 = sum (p - min(p, idle))         (DVFS-addressable share)
// The split mode serves grid/powercap.enforce_cap, which the reference
// feeds with two segment sums over two materialised arrays; here the node
// powers are read once and the floor and dynamic arrays never reach device
// memory.
//
// Bound: device memory. The S x N node-power read is the only large operand
// (S=12, N=9600: 460,800 B per step) with one or three flops per 4 bytes.
// Design: one block per (s, g) walks its own span with coalesced strided
// loads (the TPU's lane-padded (S_block, span) tile is not carried over),
// each thread keeps its partial sums, a warp-shuffle plus shared-memory
// reduction forms the group totals, and one thread writes them. At the
// grid sweep's shape the bound is well under a microsecond and the launch
// dominates.
//
// Build without --use_fast_math and with --fmad=false, as fused_cooling.cu.
// fminf returns the other operand for a NaN power where torch.minimum would
// propagate it; node powers are never NaN on the engine path.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

template <bool kSplit>
__global__ void __launch_bounds__(kThreads)
group_power_kernel(const float* __restrict__ node_pw, int n_nodes, int span,
                   int n_groups, float idle, float* __restrict__ out0,
                   float* __restrict__ out1) {
  const int g = blockIdx.x;
  const int s = blockIdx.y;
  const long long lo = static_cast<long long>(g) * span;
  const long long hi = min(lo + span, static_cast<long long>(n_nodes));
  const float* row = node_pw + static_cast<long long>(s) * n_nodes;

  float a = 0.f;  // plain: sum p; split: sum of the idle floor
  float b = 0.f;  // split: sum of the dynamic share
  for (long long n = lo + threadIdx.x; n < hi; n += kThreads) {
    const float p = row[n];
    if (kSplit) {
      const float f = fminf(p, idle);
      a += f;
      b += p - f;
    } else {
      a += p;
    }
  }
  a = warp_sum(a);
  if (kSplit) b = warp_sum(b);

  __shared__ float sa[kWarps];
  __shared__ float sb[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    sa[warp] = a;
    if (kSplit) sb[warp] = b;
  }
  __syncthreads();
  if (warp != 0) return;
  a = warp_sum(lane < kWarps ? sa[lane] : 0.f);
  if (kSplit) b = warp_sum(lane < kWarps ? sb[lane] : 0.f);
  if (lane != 0) return;

  const long long i = static_cast<long long>(s) * n_groups + g;
  out0[i] = a;
  if (kSplit) out1[i] = b;
}

}  // namespace

// Plain C entry point (bound with ctypes). `split` selects the mode (0 =
// plain: out1 is not written and may be null). Launches on `stream` and
// returns cudaGetLastError() as an int (0 = launched).
extern "C" int group_power_launch(const float* node_pw, int n_scen,
                                  int n_nodes, int n_groups, int span,
                                  int split, float idle, float* out0,
                                  float* out1, void* stream) {
  const dim3 grid(n_groups, n_scen);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (split)
    group_power_kernel<true><<<grid, kThreads, 0, st>>>(
        node_pw, n_nodes, span, n_groups, idle, out0, out1);
  else
    group_power_kernel<false><<<grid, kThreads, 0, st>>>(
        node_pw, n_nodes, span, n_groups, idle, out0, out1);
  return static_cast<int>(cudaGetLastError());
}
