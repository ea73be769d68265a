// Node -> CDU group power segment sum, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `group_power_pallas` (`_kernel`) in
// src/repro/kernels/power_topo/power_topo.py. Plain version:
// repro_torch/kernels/power_topo/ref.py `group_power_ref` (plain mode) and
// `group_power_split_ref` (split mode).
//
// Per (scenario s, CDU group g), over the group's contiguous ceil-span
// [g*span, min((g+1)*span, N))  (the last group is ragged, and may be empty):
//   plain:  out[s, g]    = sum p                     (the TPU kernel's sum)
//   split:  out[0, s, g] = sum min(p, idle)          (idle floor per group)
//           out[1, s, g] = sum (p - min(p, idle))    (DVFS-addressable share)
// The split mode serves grid/powercap.enforce_cap, which the reference
// feeds with two segment sums over two materialised arrays; here the node
// powers are read once and the floor and dynamic arrays never reach device
// memory.
//
// Bound: device memory. The S x N node-power read is the only large operand
// (Frontier, S=12: 460,800 B per step; Fugaku: 7.6 MB) with one or three
// flops per 4 bytes. The reduction is segment_sum.cuh's: one warp per group
// at Frontier's span, one 512-thread CTA per group at Fugaku's, the
// order of the adds a function of (N, G) only. The TPU's lane-padded
// (S_block, span) tile is not carried over.
//
// Build without --use_fast_math and with --fmad=false, as fused_cooling.cu.
// fminf returns the other operand for a NaN power where torch.minimum would
// propagate it; node powers are never NaN on the engine path.

#include "segment_sum.cuh"

// Outside the anonymous namespace: the C entry point's signature names it.
struct GroupArgs {  // mirrors power_topo.py _GroupArgs
  segsum::Plan plan;
  int split;        // 0: plain sums; 1: idle floor and dynamic share
  float idle;       // per-node idle floor (W), split mode
};

namespace {

template <bool kSplitMode>
struct GroupOp {
  static constexpr bool kSplit = kSplitMode;
  float idle;
  float* __restrict__ out;  // plain: [S, G]; split: [2, S, G]
  long long plane;          // S * G

  struct State {};

  __device__ __forceinline__ State begin(int, int, long long) const {
    return State{};
  }

  __device__ __forceinline__ void end(int, int, long long i, const State&,
                                      const segsum::Sums<kSplit>& sum) const {
    out[i] = sum.a;
    if (kSplit) out[plane + i] = sum.b;
  }
};

}  // namespace

// Plain C entry point (bound with ctypes). `args` is a host struct (the
// launch plan and mode, packed once per shape and mode); `vec` selects
// 128-bit loads as in fused_cooling_launch. Launches on `stream` and
// returns the CUDA error as an int (0 = launched).
extern "C" int group_power_launch(const float* node_pw, float* out,
                                  const GroupArgs* args, int vec,
                                  void* stream) {
  const long long plane =
      static_cast<long long>(args->plan.n_scen) * args->plan.n_groups;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (args->split)
    err = segsum::launch(node_pw, args->plan, vec,
                         GroupOp<true>{args->idle, out, plane}, st);
  else
    err = segsum::launch(node_pw, args->plan, vec,
                         GroupOp<false>{0.f, out, plane}, st);
  return static_cast<int>(err);
}
