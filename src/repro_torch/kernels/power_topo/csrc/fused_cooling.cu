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
// operand (S=8, N=9600: 307 KB per step), with about one add per 4 bytes
// read. Design: one block per (s, g) walks its own span with coalesced
// loads (the TPU's lane-padded (S_block, span) tile is not carried over),
// each thread keeps a partial sum, a warp-shuffle plus shared-memory
// reduction forms q, and one thread applies the CDU update and writes the
// four outputs, so q never round-trips through device memory. At Frontier
// shape the bound is well under a microsecond and the launch dominates.
//
// Build without --use_fast_math and with --fmad=false: the reference
// divides in IEEE f32 and rounds every product before the following add.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct CduScalars {
  float a_valve;       // min(dt / tau_valve, 1)
  float a_hx;          // min(dt / tau_hx, 1)
  float cp;            // water specific heat (J/(kg K))
  float cp_dt_design;  // cp * design delta-T (host product in double)
  float ua;            // facility HX conductance per group (W/K)
  float mdot_min;      // valve floor (kg/s)
  float mdot_max;      // full-open flow (kg/s)
};

__global__ void __launch_bounds__(kThreads)
fused_cooling_kernel(const float* __restrict__ node_pw, int n_nodes, int span,
                     int n_groups, const float* __restrict__ t_supply,
                     const float* __restrict__ mdot,
                     const float* __restrict__ t_basin, long long tb_s,
                     long long tb_g, const float* __restrict__ t_set,
                     long long tset_s, long long tset_g, CduScalars p,
                     float* __restrict__ q_out, float* __restrict__ tr_out,
                     float* __restrict__ tso_out, float* __restrict__ mdo_out) {
  const int g = blockIdx.x;
  const int s = blockIdx.y;
  const long long lo = static_cast<long long>(g) * span;
  const long long hi = min(lo + span, static_cast<long long>(n_nodes));
  const float* row = node_pw + static_cast<long long>(s) * n_nodes;

  float acc = 0.f;
  for (long long n = lo + threadIdx.x; n < hi; n += kThreads) acc += row[n];
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);

  __shared__ float warp_sum[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (warp != 0) return;
  acc = lane < kWarps ? warp_sum[lane] : 0.f;
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane != 0) return;

  const long long i = static_cast<long long>(s) * n_groups + g;
  const float q = acc;
  const float ts = t_supply[i];
  const float md = mdot[i];
  const float tb = t_basin[s * tb_s + g * tb_g];
  const float tset = t_set[s * tset_s + g * tset_g];
  const float dem = fminf(fmaxf(q / p.cp_dt_design, p.mdot_min), p.mdot_max);
  const float md_new = md + (dem - md) * p.a_valve;
  const float tgt = fmaxf(tset, tb + q / p.ua);
  q_out[i] = q;
  tr_out[i] = ts + q / (md_new * p.cp);
  tso_out[i] = ts + (tgt - ts) * p.a_hx;
  mdo_out[i] = md_new;
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int fused_cooling_launch(
    const float* node_pw, int n_scen, int n_nodes, int n_groups, int span,
    const float* t_supply, const float* mdot, const float* t_basin,
    long long tb_s, long long tb_g, const float* t_set, long long tset_s,
    long long tset_g, float a_valve, float a_hx, float cp, float cp_dt_design,
    float ua, float mdot_min, float mdot_max, float* q_out, float* tr_out,
    float* tso_out, float* mdo_out, void* stream) {
  const CduScalars p{a_valve, a_hx, cp, cp_dt_design, ua, mdot_min, mdot_max};
  const dim3 grid(n_groups, n_scen);
  fused_cooling_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      node_pw, n_nodes, span, n_groups, t_supply, mdot, t_basin, tb_s, tb_g,
      t_set, tset_s, tset_g, p, q_out, tr_out, tso_out, mdo_out);
  return static_cast<int>(cudaGetLastError());
}
