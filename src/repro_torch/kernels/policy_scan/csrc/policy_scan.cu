// Streaming-runtime policy sweep for Hopper (sm_90a): B traces x P static
// placements, W windows of the executor's window step, in one launch.
//
// No TPU kernel replaces it: the reference runs this sweep as an XLA
// `lax.scan` (_evaluate_jax, src/repro/runtime_stream/eval_jax.py:214). It
// computes, for every (trace b, placement p), the window step of
// runtime_stream.executor.StreamExecutor._run with no controller and no
// migrations, window after window:
//   1. arrivals: spouts at rates[b, t] * throttle; every other component at
//      sum over its shuffle parents of alpha[p] * prev_out[p], split evenly
//      over its instances; then each fields edge, in declaration order, adds
//      alpha[parent] * prev_out[parent] * share[b, t, j] to the j-th
//      instance of its destination;
//   2. backlog += arrivals * dt; over = max(backlog - max_queue, 0) is
//      dropped;
//   3. desired = backlog / dt;
//   4. per machine w: var_w = sum of e * desired and met_w = sum of met over
//      its tasks;
//   5. head_w = max(cap_w - met_w, 0), s_w = var_w > head_w ? head_w /
//      max(var_w, 1e-300) : 1;
//   6. processed = desired * s[machine];
//   7. backlog = max(backlog - processed * dt, 0);
//   8. tcu = e * processed + met * (cap[machine] > 0);
//   9. prev_out[c] = sum of processed over component c's tasks;
//  10. the window's throughput, admitted rate, dropped rate, backlog and
//      throttle, and the machines' tcu sums into a window mean;
//  11. the spout throttle (AIMD on the deepest queue) for the next window.
// Every product and sum rounds once (__dmul_rn, __dadd_rn; built with
// -fmad=false too), and every sum over tasks adds in task order: a
// machine's tasks in ascending task order (the wrapper sorts each
// placement's tasks by machine, stably, once a call), a component's tasks
// over its contiguous range. That is np.bincount's order in the executor,
// so the carried state (backlog, prev_out, throttle) follows the
// executor's bits. No atomics: reruns are bit-identical.
//
// Layout: rates (B, W), capacity (B, W, m), shares (B, W, S) float64;
// tm, e, met (P, T); order (P, T) and mstart (P, m + 1) int32, machine w's
// tasks being order[mstart[w] .. mstart[w + 1]); comp (T,) int32; alpha (n,)
// float64; topo int32, packed: offsets (n + 1), is_source (n), parent_ptr
// (n + 1), parent_idx (E), then per keyed edge (K) its parent, lo, hi and
// share column. Outputs (B, P, W) and util (B, P, m) float64. A task id
// outside [0, m) matches no machine: it never serves.
//
// Bound: operations. About 23 FP64 operations a task and window against
// 5 (B, P, W) outputs, so at B 6, P 256, W 240, T 478 the FP64 rate bounds
// it (~0.13 ms at 34 TFLOP/s) and the bytes (~21 MB) do not.
// Design, simple first: one block of 256 threads a (b, p) pair walks the
// windows in order with its state in shared memory: backlog, the per-task
// temporaries, the per-machine sums, prev_out and the throttle. Tasks and
// machines are split over the threads; the deepest queue is a maximum over
// the threads (exact in any order). The sums over tasks are serial chains in
// task order, each on one warp's lane 0 so that they run side by side: the
// throughput, the backlog and the dropped tuples on warps 0-2, the
// components' sums on the other five. These chains, T dependent adds a
// window, set the block's time. Enough (b, p) blocks fill the card.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScalars = 4 + kWarps;  // three totals, the throttle, each warp's queue maximum

struct Consts {
  double dt, max_queue, bp_high, bp_low, down, up, tmin;
};

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

__global__ void __launch_bounds__(kThreads)
policy_scan_kernel(const double* __restrict__ rates, const double* __restrict__ capacity,
                   const int* __restrict__ tm, const double* __restrict__ e,
                   const double* __restrict__ met, const int* __restrict__ order,
                   const int* __restrict__ mstart, const int* __restrict__ comp,
                   const double* __restrict__ alpha, const int* __restrict__ topo,
                   const double* __restrict__ shares, double* __restrict__ out_thpt,
                   double* __restrict__ out_adm, double* __restrict__ out_drop,
                   double* __restrict__ out_qtot, double* __restrict__ out_thr,
                   double* __restrict__ out_util, int P, int T, int m, int n, int E, int K,
                   int W, int S, Consts c) {
  const int p = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int* off = topo;
  const int* is_source = off + n + 1;
  const int* parent_ptr = is_source + n;
  const int* parent_idx = parent_ptr + n + 1;
  const int* key = parent_idx + E;  // K x (parent, lo, hi, share column)

  extern __shared__ double smem[];
  double* backlog = smem;        // (T,)
  double* task_a = backlog + T;  // (T,) e * desired, then tcu
  double* processed = task_a + T;
  double* over = processed + T;
  double* desired = over + T;
  double* met_w = desired + T;   // (m,)
  double* s_w = met_w + m;
  double* util = s_w + m;
  double* arr = util + m;        // (n,)
  double* prev_out = arr + n;
  double* n_inst = prev_out + n;
  double* contrib = n_inst + n;  // (K,), at least one slot
  double* scal = contrib + (K > 0 ? K : 1);  // (kScalars,)
  double* warp_max = scal + 4;
  int* ord = reinterpret_cast<int*>(scal + kScalars);  // (T,)
  int* mst = ord + T;                            // (m + 1,)

  const size_t pt = static_cast<size_t>(p) * T;
  const int* tm_p = tm + pt;
  const double* e_p = e + pt;
  const double* met_p = met + pt;
  for (int j = tid; j < T; j += kThreads) {
    ord[j] = order[pt + j];
    backlog[j] = 0.0;
  }
  const int* mstart_p = mstart + static_cast<size_t>(p) * (m + 1);
  for (int w = tid; w <= m; w += kThreads) mst[w] = mstart_p[w];
  for (int w = tid; w < m; w += kThreads) util[w] = 0.0;
  for (int i = tid; i < n; i += kThreads) {
    prev_out[i] = 0.0;
    n_inst[i] = static_cast<double>(off[i + 1] - off[i]);
  }
  if (tid == 0) scal[3] = 1.0;  // throttle
  __syncthreads();
  // Fixed per-machine load: every task is active.
  for (int w = tid; w < m; w += kThreads) {
    double v = 0.0;
    for (int j = mst[w]; j < mst[w + 1]; ++j) v = add(v, met_p[ord[j]]);
    met_w[w] = v;
  }
  __syncthreads();

  const double dt = c.dt;
  for (int t = 0; t < W; ++t) {
    const size_t bt = static_cast<size_t>(b) * W + t;
    const double* cap = capacity + bt * m;
    const double r_adm = mul(rates[bt], scal[3]);
    // 1. Arrivals per component split over its instances (one division a
    // component, not a task), and each fields edge's flow.
    for (int i = tid; i < n; i += kThreads) {
      double a;
      if (is_source[i]) {
        a = r_adm;
      } else {
        a = 0.0;
        for (int q = parent_ptr[i]; q < parent_ptr[i + 1]; ++q) {
          const int par = parent_idx[q];
          a = add(a, mul(alpha[par], prev_out[par]));
        }
      }
      arr[i] = a / n_inst[i];
    }
    for (int k = tid; k < K; k += kThreads) {
      const int par = key[4 * k];
      contrib[k] = mul(alpha[par], prev_out[par]);
    }
    __syncthreads();
    // 2-3. Backlog, drops, desired and e * desired.
    const double* sh = shares + bt * S;
    for (int i = tid; i < T; i += kThreads) {
      double a = arr[comp[i]];
      for (int k = 0; k < K; ++k) {
        const int lo = key[4 * k + 1];
        if (i >= lo && i < key[4 * k + 2]) a = add(a, mul(contrib[k], sh[key[4 * k + 3] + i - lo]));
      }
      double x = add(backlog[i], mul(a, dt));
      const double o = fmax(sub(x, c.max_queue), 0.0);
      x = sub(x, o);
      backlog[i] = x;
      over[i] = o;
      const double d = x / dt;
      desired[i] = d;
      task_a[i] = mul(e_p[i], d);
    }
    __syncthreads();
    // 4-5. Per machine, its tasks in ascending order.
    for (int w = tid; w < m; w += kThreads) {
      double v = 0.0;
      for (int j = mst[w]; j < mst[w + 1]; ++j) v = add(v, task_a[ord[j]]);
      const double head = fmax(sub(cap[w], met_w[w]), 0.0);
      s_w[w] = v > head ? head / fmax(v, 1e-300) : 1.0;
    }
    __syncthreads();
    // 6-8. Service, new backlog (and its maximum, exact in any order), tcu.
    double top = 0.0;
    for (int i = tid; i < T; i += kThreads) {
      const int w = tm_p[i];
      const bool on = static_cast<unsigned>(w) < static_cast<unsigned>(m);
      const double q = mul(desired[i], on ? s_w[w] : 0.0);
      processed[i] = q;
      backlog[i] = fmax(sub(backlog[i], mul(q, dt)), 0.0);
      top = fmax(top, backlog[i]);
      const double alive = (on && cap[w] > 0.0) ? 1.0 : 0.0;
      task_a[i] = add(mul(e_p[i], q), mul(met_p[i], alive));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) top = fmax(top, __shfl_xor_sync(0xffffffffu, top, o));
    if (lane == 0) warp_max[warp] = top;
    __syncthreads();
    // 9-10. Machine tcu sums; the ordered totals in task order, one warp's
    // lane 0 each: throughput, backlog, dropped, then the components' sums
    // over the remaining warps.
    for (int w = tid; w < m; w += kThreads) {
      double u = 0.0;
      for (int j = mst[w]; j < mst[w + 1]; ++j) u = add(u, task_a[ord[j]]);
      util[w] = add(util[w], u);
    }
    if (lane == 0) {
      if (warp < 3) {
        const double* x = warp == 0 ? processed : warp == 1 ? backlog : over;
        double v = 0.0;
        for (int i = 0; i < T; ++i) v = add(v, x[i]);
        scal[warp] = v;
      } else {
        for (int ci = warp - 3; ci < n; ci += kWarps - 3) {
          double v = 0.0;
          for (int i = off[ci]; i < off[ci + 1]; ++i) v = add(v, processed[i]);
          prev_out[ci] = v;
        }
      }
    }
    __syncthreads();
    // 11. Log the window (the throttle before it updates), then update it.
    if (tid == 0) {
      const size_t o = (static_cast<size_t>(b) * P + p) * W + t;
      const double thr = scal[3];
      out_thpt[o] = scal[0];
      out_adm[o] = r_adm;
      out_drop[o] = scal[2] / dt;
      out_qtot[o] = scal[1];
      out_thr[o] = thr;
      double top = warp_max[0];
      for (int k = 1; k < kWarps; ++k) top = fmax(top, warp_max[k]);
      const double q_frac = top / c.max_queue;
      if (q_frac > c.bp_high) {
        scal[3] = fmax(c.tmin, mul(thr, c.down));
      } else if (q_frac < c.bp_low) {
        scal[3] = fmin(1.0, mul(thr, c.up));
      }
    }
    __syncthreads();
  }
  const size_t ou = (static_cast<size_t>(b) * P + p) * m;
  for (int w = tid; w < m; w += kThreads) out_util[ou + w] = util[w] / static_cast<double>(W);
}

}  // namespace

// Launches the kernel on `stream` (no synchronisation); one block a (b, p)
// pair with `smem_bytes` of shared memory, which the wrapper counts for the
// layout above (ops.smem_bytes). Returns a cudaError_t code: 0 on success.
// Empty inputs launch nothing.
extern "C" int policy_scan_launch(int device, const void* rates, const void* capacity,
                                  const void* tm, const void* e, const void* met,
                                  const void* order, const void* mstart, const void* comp,
                                  const void* alpha, const void* topo, const void* shares,
                                  void* thpt, void* adm, void* drop, void* qtot, void* thr,
                                  void* util, long long B, long long P, int T, int m, int n,
                                  int E, int K, int W, int S, double dt, double max_queue,
                                  double bp_high, double bp_low, double down, double up,
                                  double tmin, long long smem_bytes, void* stream) {
  if (B <= 0 || P <= 0 || W <= 0 || T <= 0) return 0;
  if (B > 65535 || P > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(policy_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Consts c{dt, max_queue, bp_high, bp_low, down, up, tmin};
  const dim3 grid(static_cast<unsigned>(P), static_cast<unsigned>(B));
  policy_scan_kernel<<<grid, kThreads, static_cast<size_t>(smem_bytes),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(rates), static_cast<const double*>(capacity),
      static_cast<const int*>(tm), static_cast<const double*>(e),
      static_cast<const double*>(met), static_cast<const int*>(order),
      static_cast<const int*>(mstart), static_cast<const int*>(comp),
      static_cast<const double*>(alpha), static_cast<const int*>(topo),
      static_cast<const double*>(shares), static_cast<double*>(thpt),
      static_cast<double*>(adm), static_cast<double*>(drop), static_cast<double*>(qtot),
      static_cast<double*>(thr), static_cast<double*>(util), static_cast<int>(P), T, m, n, E,
      K, W, S, c);
  return static_cast<int>(cudaGetLastError());
}
