// Fused node -> CDU segment reduction + CDU loop update, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_cooling_pallas` (`_fused_kernel`) in
// src/repro/kernels/power_topo/power_topo.py. Plain version:
// repro_torch/kernels/power_topo/ref.py `fused_cooling_ref` (the reference's
// `ref.cdu_update_ref` maths).
//
// Per (scenario s, CDU group g):
//   q       = sum of node_pw[s, n] over the group's contiguous ceil-span
//             [g*span, min((g+1)*span, N))   (the last group is ragged)
//   mdot'   = mdot + (clip(q / (cp*dT_design), mdot_min, mdot_max) - mdot)*a_valve
//   t_ret   = t_sup + q / (mdot' * cp)
//   t_sup'  = t_sup + (max(t_set, t_basin + q/UA) - t_sup) * a_hx
//
// Bound: device memory. The S x N node-power read is the only large
// operand (Frontier, S=8: 307 KB; Fugaku: 5.1 MB), about one add per 4
// bytes. The reduction is segment_sum.cuh's (one warp per group at
// Frontier's span, one 512-thread CTA per group at Fugaku's); the
// group's leader thread loads the CDU state (t_supply, mdot, t_basin,
// t_set) at entry, so that round trip overlaps the node loads instead of
// following them, then applies the update and writes the four outputs, so
// q never round-trips through device memory. The TPU's lane-padded
// (S_block, span) tile is not carried over.
//
// t_basin is read per group ([S, G] strides), per scenario (stride 0 over
// g) or per hall: with `hall` non-null, group g reads column hall[g] of an
// [S, H] tensor, so the engine's group -> hall gather is no launch of its
// own.
//
// Build without --use_fast_math and with --fmad=false: the reference
// divides in IEEE f32 and rounds every product before the following add.

#include "segment_sum.cuh"

// Outside the anonymous namespace: the C entry point's signature names it.
struct FusedArgs {       // mirrors power_topo.py _FusedArgs
  segsum::Plan plan;
  long long tb_s, tb_g;  // t_basin strides (elements)
  long long ts_s, ts_g;  // t_set strides (elements)
  float a_valve;         // min(dt / tau_valve, 1)
  float a_hx;            // min(dt / tau_hx, 1)
  float cp;              // water specific heat (J/(kg K))
  float cp_dt_design;    // cp * design delta-T
  float ua;              // facility HX conductance per group (W/K)
  float mdot_min;        // valve floor (kg/s)
  float mdot_max;        // full-open flow (kg/s)
};

namespace {

struct FusedOp {
  static constexpr bool kSplit = false;
  float idle;  // unused: plain sums
  const float* __restrict__ t_supply;
  const float* __restrict__ mdot;
  const float* __restrict__ t_basin;
  const int* __restrict__ hall;  // null: t_basin is indexed by group
  const float* __restrict__ t_set;
  float* __restrict__ out;       // [4, S, G]: q, t_return, t_supply', mdot'
  long long plane;               // S * G
  FusedArgs a;

  struct State {
    float ts, md, tb, tset;
  };

  __device__ __forceinline__ State begin(int s, int g, long long i) const {
    const int h = hall ? __ldg(hall + g) : g;
    return State{__ldg(t_supply + i), __ldg(mdot + i),
                 __ldg(t_basin + s * a.tb_s + h * a.tb_g),
                 __ldg(t_set + s * a.ts_s + g * a.ts_g)};
  }

  __device__ __forceinline__ void end(int, int, long long i, const State& st,
                                      const segsum::Sums<false>& sum) const {
    const float q = sum.a;
    const float dem = fminf(fmaxf(q / a.cp_dt_design, a.mdot_min), a.mdot_max);
    const float md_new = st.md + (dem - st.md) * a.a_valve;
    const float tgt = fmaxf(st.tset, st.tb + q / a.ua);
    out[i] = q;
    out[plane + i] = st.ts + q / (md_new * a.cp);
    out[2 * plane + i] = st.ts + (tgt - st.ts) * a.a_hx;
    out[3 * plane + i] = md_new;
  }
};

}  // namespace

// Plain C entry point (bound with ctypes). `args` is a host struct (the
// launch plan, strides and CDU scalars, packed once per shape and
// parameter set); `vec` selects 128-bit loads (only when the plan allows
// them and node_pw is 16-byte aligned: the order of the adds is the same
// either way). Launches on `stream` and returns the CUDA error as an int
// (0 = launched).
extern "C" int fused_cooling_launch(const float* node_pw, const float* t_supply,
                                    const float* mdot, const float* t_basin,
                                    const int* hall, const float* t_set,
                                    float* out, const FusedArgs* args, int vec,
                                    void* stream) {
  const FusedOp op{0.f, t_supply, mdot, t_basin, hall, t_set, out,
                   static_cast<long long>(args->plan.n_scen) *
                       args->plan.n_groups,
                   *args};
  return static_cast<int>(segsum::launch(
      node_pw, args->plan, vec, op, static_cast<cudaStream_t>(stream)));
}
