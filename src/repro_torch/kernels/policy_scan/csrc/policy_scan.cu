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
// executor's bits. Where dt is a power of two, desired = backlog * (1 /
// dt), which is the division's value (both round the same real number).
// No atomics: reruns are bit-identical.
//
// Layout: rates (B, W), capacity (B, W, m), shares (B, W, S) float64;
// e, met (P, T); order (P, T) and mstart (P, m + 2) int32, machine w's
// tasks being order[mstart[w] .. mstart[w + 1]) and the tasks on no machine
// (ids outside [0, m), which never serve) order[mstart[m] .. T); comp (T,)
// int32; alpha (n,) float64; topo int32, packed: offsets (n + 1), is_source
// (n), parent_ptr (n + 1), parent_idx (E), then per keyed edge (K) its
// parent, lo, hi and share column. Outputs (B, P, W) and util (B, P, m)
// float64.
//
// Bound: operations. About 23 FP64 operations a task and window against
// 5 (B, P, W) outputs, so at B 6, P 256, W 240, T 478 the FP64 rate bounds
// it (~0.13 ms at 34 TFLOP/s) and the bytes (~21 MB) do not. What sets the
// time is serial: sums in task order are chains of dependent adds (8 cycles
// each on an H100), T of them a window for each output total and the
// largest component's for prev_out, and a window needs the last one's
// prev_out and throttle.
//
// Design: a block takes one placement p and G of its traces (G pairs),
// which walk the windows in step. What the placement fixes (e and met per
// task, each task's machine, the machines' task lists and fixed loads) and
// the topology are staged once in shared memory for all G pairs; each
// pair's state (backlog, processed, dropped, the window's capacities, the
// machines' scales and utilization, prev_out, arrivals, throttle) sits
// there too. A window, on WPP worker warps a pair:
//   B. per task: arrivals, backlog, drops (the window's capacity row comes
//      by cp.async meanwhile);
//   C. per machine: var_w in task order, s_w;
//   D. per task: service, new backlog, processed; each warp's deepest queue;
//   E. per machine: the tcu sum into utilization, while the two other
//      roles work.
// One warp then sums every pair's prev_out (a lane a (pair, component)),
// updates the throttles and prepares the next window's arrivals (its rates
// loaded a window ahead); a second warp sums the three output totals
// (throughput, backlog, dropped) of every pair, a lane each. Both start
// when phase D ends and must finish before the next window's phase B: two
// named barriers a window join the three roles (the workers arrive at one
// and wait at the other). Packing the chains of G pairs into one warp
// keeps the FP64 pipe for the phases (a lone lane's add costs a whole
// warp's issue). The grid's y and z axes walk the groups of G traces, so
// any number of traces runs.
//
// Where one pair's state does not fit a block (ops.smem_bytes with one
// pair past ops.SMEM_LIMIT: thousands of tasks or machines), a second
// kernel (the global-state instance, policy_scan_global_kernel) takes one
// pair a block at a time, the resident blocks walking the (trace,
// placement) pairs trace-fastest (a placement's traces run at once and
// share its arrays in the L2), with every warp of the block on that pair:
// NWG worker warps, the chain warp and the totals warp. A placement's T
// tasks occupy at most min(T, m) machines, so once a pair it lists the
// machines that hold a task (ascending, each with its run of the task
// order) and gives each task the index of its machine in that list; phases
// C and E and the capacity loads walk the list alone, four machines (or
// tasks) a lane in flight. An empty machine's s_w is never read and its
// utilization stays 0.0 (out_util gets 0.0 / W = 0.0, the same bits). The
// per-task state (backlog, processed, dropped) and each task's machine stay
// in shared memory where they fit (~7 700 tasks), the per-machine state
// (capacities, scales, utilization, fixed loads, the list) too where it
// fits beside them; what does not fit goes to a global slab, one a resident
// block, which the wrapper allocates (ops.global_smem_bytes and
// ops.slab_bytes count the split). The placement's e, met, order and
// machine boundaries are read in place. Three chains of T dependent adds a
// window (the totals) bound a pair at W T ~8 cycles, so they run beside the
// next window: phase D copies the backlog and the drops to the slab, the
// totals warp streams that copy through a cp.async ring in shared memory
// (processed it reads in place: the next phase D waits for the totals, on
// a fourth named barrier), and the next window's phases wait only for the
// chain warp. The order of every sum is the one-block kernel's, and both
// kernels call the same helpers for the step's arithmetic (desired_rate,
// admit, machine_scale, serve_task, tcu, next_throttle); the one-block
// kernel keeps component_arrivals' and task_arrivals' few lines inline,
// where the calls cost it spills under its register cap.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WPP = 3;        // worker warps a pair (ops.WARPS_A_PAIR)
constexpr int PAIRS_MAX = 6;  // pairs a block, at most (ops.PAIRS_MAX)
constexpr int kMaxThreads = (PAIRS_MAX * WPP + 2) * 32;
constexpr int NWG = 16;       // worker warps of the global-state instance (ops.GLOBAL_WORKER_WARPS)
constexpr int kGlobalThreads = (NWG + 2) * 32;
constexpr long long kSmemLimit = 232448;  // a block's shared memory (ops.SMEM_LIMIT)
// The global-state instance's totals read a copy of the backlog and the
// drops through a ring of kRing chunks of kChunk doubles an array.
constexpr int kRing = 4, kChunk = 256;
// Named barriers: the workers' own; a window's phase D done (the workers
// arrive, the chain and totals warps wait); the next window may start (the
// other way round); in the global-state instance, the totals have read the
// copy that the next phase D overwrites (the totals warp arrives, the
// workers wait).
constexpr int kWork = 1, kDone = 2, kGo = 3, kCopy = 4;

struct Consts {
  double dt, rdt, max_queue, bp_high, bp_low, down, up, tmin;
};

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

// The window step's arithmetic, which both kernels call: the order of
// every sum stays with the caller.
// Desired rate: backlog / dt (times rdt = 1 / dt where that is exact).
__device__ __forceinline__ double desired_rate(double x, double dt, double rdt) {
  return rdt > 0.0 ? mul(x, rdt) : x / dt;
}
// Component i's arrivals a task: the admitted rate at a spout, else the sum
// over its shuffle parents of alpha * prev_out, split over its instances.
__device__ __forceinline__ double component_arrivals(int i, const int* off, const int* is_source,
                                                     const int* parent_ptr, const int* parent_idx,
                                                     const double* alpha, const double* prev_out,
                                                     const double* r_adm) {
  double a;
  if (is_source[i]) {
    a = *r_adm;
  } else {
    a = 0.0;
    for (int q = parent_ptr[i]; q < parent_ptr[i + 1]; ++q) {
      const int par = parent_idx[q];
      a = add(a, mul(alpha[par], prev_out[par]));
    }
  }
  return a / static_cast<double>(off[i + 1] - off[i]);
}
// B. Task i's arrivals: its component's a, then each fields edge's share,
// in declaration order.
__device__ __forceinline__ double task_arrivals(int i, double a, int K, const int* key,
                                                const double* contrib, const double* sh) {
  for (int k = 0; k < K; ++k) {
    const int lo = key[4 * k + 1];
    if (i >= lo && i < key[4 * k + 2]) a = add(a, mul(contrib[k], sh[key[4 * k + 3] + i - lo]));
  }
  return a;
}
// B. The arrivals a over dt into the backlog; what passes max_queue is
// dropped.
struct Queue {
  double back, over;
};
__device__ __forceinline__ Queue admit(double back, double a, double dt, double max_queue) {
  const double x = add(back, mul(a, dt));
  const double o = fmax(sub(x, max_queue), 0.0);
  return {sub(x, o), o};
}
// C. A machine's scale from its var_w, capacity and fixed load.
__device__ __forceinline__ double machine_scale(double var, double cap, double met_w) {
  const double head = fmax(sub(cap, met_w), 0.0);
  return var > head ? head / fmax(var, 1e-300) : 1.0;
}
// D. Task service at its machine's scale s: processed, and the new backlog.
struct Service {
  double proc, back;
};
__device__ __forceinline__ Service serve_task(double x, double s, double dt, double rdt) {
  const double q = mul(desired_rate(x, dt, rdt), s);
  return {q, fmax(sub(x, mul(q, dt)), 0.0)};
}
// E. A task's tcu term.
__device__ __forceinline__ double tcu(double e, double proc, double met, double alive) {
  return add(mul(e, proc), mul(met, alive));
}
// The spout throttle (AIMD on the deepest queue) for the next window.
__device__ __forceinline__ double next_throttle(double th, double deep, const Consts& c) {
  const double q_frac = deep / c.max_queue;
  if (q_frac > c.bp_high) return fmax(c.tmin, mul(th, c.down));
  if (q_frac < c.bp_low) return fmin(1.0, mul(th, c.up));
  return th;
}

// Named barriers (not .aligned: a warp may reach them diverged); the ids
// are immediates, so ptxas reserves only the barriers the kernel uses.
template <int ID>
__device__ __forceinline__ void bar_sync(int count) {
  asm volatile("barrier.sync %0, %1;\n" ::"n"(ID), "r"(count) : "memory");
}
template <int ID>
__device__ __forceinline__ void bar_arrive(int count) {
  asm volatile("barrier.arrive %0, %1;\n" ::"n"(ID), "r"(count) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

// Sum of x[0 .. count) in index order, loads issued eight ahead of the adds.
__device__ __forceinline__ double ordered_sum(const double* x, int count) {
  double v = 0.0;
  int i = 0;
  for (; i + 8 <= count; i += 8) {
    double y[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) y[k] = x[i + k];
#pragma unroll
    for (int k = 0; k < 8; ++k) v = add(v, y[k]);
  }
  for (; i < count; ++i) v = add(v, x[i]);
  return v;
}

// The same sum continued from v, the next eight loads issued before this
// eight's adds: the global-state instance's chains, which set its time.
__device__ __forceinline__ double ordered_sum_from(double v, const double* x, int count) {
  int i = 0;
  if (count >= 8) {
    double y[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) y[k] = x[k];
    for (i = 8; i + 8 <= count; i += 8) {
      double z[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) z[k] = x[i + k];
#pragma unroll
      for (int k = 0; k < 8; ++k) v = add(v, y[k]);
#pragma unroll
      for (int k = 0; k < 8; ++k) y[k] = z[k];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) v = add(v, y[k]);
  }
  for (; i < count; ++i) v = add(v, x[i]);
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// Shared memory, in doubles: the placement's e and met (T each), the
// machines' fixed loads (m), alpha (n); then per pair: backlog, processed
// and dropped (T each), the window's capacities (m), the machines' scales
// (m + 1; slot m, 0, for the tasks on no machine) and utilization (m),
// arrivals a task and prev_out (n each), the fields edges' flows (max(K,
// 1)), each worker warp's deepest queue (WPP), the throttle and the
// admitted rate; then int32: each task's machine (m where none) and the
// placement's task order (T each), the machines' boundaries (m + 2) and the
// packed topology (3 n + 2 + E + 4 K). ops.smem_bytes counts the same bytes,
// and the launcher refuses a count that is not `bytes`.
struct Layout {
  int T, m, n, kc, pair;  // kc: max(K, 1); pair: doubles a pair
  __host__ __device__ Layout(int T_, int m_, int n_, int K)
      : T(T_), m(m_), n(n_), kc(K > 0 ? K : 1), pair(3 * T_ + 3 * m_ + 1 + 2 * n_ + kc + WPP + 2) {}
  // Bytes of a block of G pairs, for E shuffle parents and K keyed edges.
  __host__ long long bytes(int G, int E, int K) const {
    const long long doubles = 2LL * T + m + n + static_cast<long long>(G) * pair;
    const long long ints = 2LL * T + (m + 2) + (3LL * n + 2 + E + 4LL * K);
    return 8 * doubles + 4 * ints;
  }
};

struct PairState {
  double *back, *proc, *over, *cap, *s_w, *util, *arr, *prev_out, *contrib, *top, *thr, *r_adm;
  __device__ PairState(double* base, const Layout& L) {
    back = base;
    proc = back + L.T;
    over = proc + L.T;
    cap = over + L.T;
    s_w = cap + L.m;
    util = s_w + L.m + 1;
    arr = util + L.m;
    prev_out = arr + L.n;
    contrib = prev_out + L.n;
    top = contrib + L.kc;
    thr = top + WPP;
    r_adm = thr + 1;
  }
};

__global__ void __launch_bounds__(kMaxThreads, 2)
policy_scan_kernel(const double* __restrict__ rates, const double* __restrict__ capacity,
                   const double* __restrict__ e, const double* __restrict__ met,
                   const int* __restrict__ order, const int* __restrict__ mstart,
                   const int* __restrict__ comp, const double* __restrict__ alpha,
                   const int* __restrict__ topo, const double* __restrict__ shares,
                   double* __restrict__ out_thpt, double* __restrict__ out_adm,
                   double* __restrict__ out_drop, double* __restrict__ out_qtot,
                   double* __restrict__ out_thr, double* __restrict__ out_util, int B, int P,
                   int T, int m, int n, int E, int K, int W, int S, int G, Consts c) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Layout L(T, m, n, K);

  // Group blockIdx.y + gridDim.y blockIdx.z of G traces: the y axis holds
  // at most 65 535 groups.
  const long long grp = blockIdx.y + static_cast<long long>(gridDim.y) * blockIdx.z;
  if (grp * G >= B) return;
  // Placement p and its traces b0 .. b0 + G - 1 (those below B).
  const int p = blockIdx.x, b0 = static_cast<int>(grp * G);
  const int g_here = B - b0 < G ? B - b0 : G;  // pairs of this block
  const int n_work = G * WPP;                  // worker warps
  const int workers = n_work * 32;
  const int chain_warp = n_work, totals_warp = n_work + 1;

  const size_t pt = static_cast<size_t>(p) * T;
  const int* mstart_p = mstart + static_cast<size_t>(p) * (m + 2);
  double* e_s = smem;
  double* met_s = e_s + T;
  double* met_w = met_s + T;
  double* alpha_s = met_w + m;
  double* pairs = alpha_s + n;
  int* tm_s = reinterpret_cast<int*>(pairs + static_cast<size_t>(G) * L.pair);
  int* ord = tm_s + T;
  int* seg = ord + T;
  int* topo_s = seg + m + 2;
  const int* off = topo_s;
  const int* is_source = off + n + 1;
  const int* parent_ptr = is_source + n;
  const int* parent_idx = parent_ptr + n + 1;
  const int* key = parent_idx + E;  // K x (parent, lo, hi, share column)

  for (int i = tid; i < T; i += blockDim.x) {
    e_s[i] = e[pt + i];
    met_s[i] = met[pt + i];
    ord[i] = order[pt + i];
  }
  for (int w = tid; w < m + 2; w += blockDim.x) seg[w] = mstart_p[w];
  for (int i = tid; i < 3 * n + 2 + E + 4 * K; i += blockDim.x) topo_s[i] = topo[i];
  for (int i = tid; i < n; i += blockDim.x) alpha_s[i] = alpha[i];
  for (int g = 0; g < G; ++g) {
    PairState st(pairs + static_cast<size_t>(g) * L.pair, L);
    for (int i = tid; i < T; i += blockDim.x) st.back[i] = 0.0;
    for (int w = tid; w < m; w += blockDim.x) st.util[w] = 0.0;
    for (int i = tid; i < n; i += blockDim.x) st.prev_out[i] = 0.0;
    if (tid == 0) {
      st.s_w[m] = 0.0;  // the tasks on no machine never serve
      *st.thr = 1.0;
    }
  }
  __syncthreads();
  // Each task's machine (m where none) and the machines' fixed loads, in
  // task order: every task is active (no migrations).
  for (int w = tid; w <= m; w += blockDim.x) {
    double v = 0.0;
    for (int j = seg[w]; j < seg[w + 1]; ++j) {
      const int i = ord[j];
      tm_s[i] = w;
      v = add(v, met_s[i]);
    }
    if (w < m) met_w[w] = v;
  }
  __syncthreads();

  const double dt = c.dt;
  auto out_at = [&](int g, int t) { return (static_cast<size_t>(b0 + g) * P + p) * W + t; };

  if (warp == totals_warp) {
    // Window t's totals in task order, a lane a (pair, total).
    const int g = lane / 3, k = lane % 3;
    for (int t = 0; t < W; ++t) {
      if (t > 0) bar_sync<kDone>(workers + 64);
      if (g < g_here) {
        PairState st(pairs + static_cast<size_t>(g) * L.pair, L);
        if (t > 0) {
          const double v = ordered_sum(k == 0 ? st.proc : k == 1 ? st.back : st.over, T);
          double* out = k == 0 ? out_thpt : k == 1 ? out_qtot : out_drop;
          out[out_at(g, t - 1)] = k == 2 ? v / dt : v;
        }
      }
      bar_arrive<kGo>(workers + 64);  // window t may start
    }
    bar_sync<kDone>(workers + 64);
    if (g < g_here) {
      PairState st(pairs + static_cast<size_t>(g) * L.pair, L);
      const double v = ordered_sum(k == 0 ? st.proc : k == 1 ? st.back : st.over, T);
      double* out = k == 0 ? out_thpt : k == 1 ? out_qtot : out_drop;
      out[out_at(g, W - 1)] = k == 2 ? v / dt : v;
    }
    return;
  }

  if (warp == chain_warp) {
    // Between windows: every pair's prev_out (a lane a (pair, component))
    // and throttle; for window t, the admitted rate (logged with the
    // throttle), arrivals a task of each component (one division a
    // component) and each fields edge's flow.
    double rate_next = lane < g_here ? rates[static_cast<size_t>(b0 + lane) * W] : 0.0;
    for (int t = 0; t < W; ++t) {
      if (t > 0) {
        bar_sync<kDone>(workers + 64);  // window t - 1's phase D done
        for (int k = lane; k < g_here * n; k += 32) {
          PairState st(pairs + static_cast<size_t>(k / n) * L.pair, L);
          const int i = k % n;
          st.prev_out[i] = ordered_sum(st.proc + off[i], off[i + 1] - off[i]);
        }
      }
      const double rate = rate_next;
      if (lane < g_here) {
        PairState st(pairs + static_cast<size_t>(lane) * L.pair, L);
        if (t + 1 < W) rate_next = rates[static_cast<size_t>(b0 + lane) * W + t + 1];
        double th = *st.thr;
        if (t > 0) {
          double deep = st.top[0];
          for (int k = 1; k < WPP; ++k) deep = fmax(deep, st.top[k]);
          th = next_throttle(th, deep, c);
          *st.thr = th;
        }
        *st.r_adm = mul(rate, th);
        out_adm[out_at(lane, t)] = *st.r_adm;
        out_thr[out_at(lane, t)] = th;
      }
      __syncwarp();
      for (int k = lane; k < g_here * n; k += 32) {
        PairState st(pairs + static_cast<size_t>(k / n) * L.pair, L);
        const int i = k % n;
        // component_arrivals' arithmetic, inline: called here, the helper
        // adds spills under this kernel's 48-register cap, and time.
        double a;
        if (is_source[i]) {
          a = *st.r_adm;
        } else {
          a = 0.0;
          for (int q = parent_ptr[i]; q < parent_ptr[i + 1]; ++q) {
            const int par = parent_idx[q];
            a = add(a, mul(alpha_s[par], st.prev_out[par]));
          }
        }
        st.arr[i] = a / static_cast<double>(off[i + 1] - off[i]);
      }
      for (int k = lane; k < g_here * K; k += 32) {
        PairState st(pairs + static_cast<size_t>(k / K) * L.pair, L);
        const int par = key[4 * (k % K)];
        st.contrib[k % K] = mul(alpha_s[par], st.prev_out[par]);
      }
      bar_arrive<kGo>(workers + 64);  // window t may start
    }
    bar_sync<kDone>(workers + 64);  // the last window's phase D
    return;
  }

  // Worker warps: pair g, and its WPP warps split the tasks and machines.
  const int g = warp / WPP;
  const int w0 = (warp % WPP) * 32 + lane, wstep = WPP * 32;
  const bool mine = g < g_here;
  PairState st(pairs + static_cast<size_t>(g) * L.pair, L);
  const size_t bw = static_cast<size_t>(b0 + (mine ? g : 0)) * W;
  for (int t = 0; t < W; ++t) {
    bar_sync<kGo>(workers + 64);  // window t's arrivals ready, window t - 1's totals read
    if (mine) {
      // The window's capacities, by cp.async while phase B runs.
      const double* cap = capacity + (bw + t) * m;
      for (int w = w0; w < m; w += wstep) cp_async8(st.cap + w, cap + w);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      // B. Arrivals, backlog, drops.
      const double* sh = shares + (bw + t) * S;
      for (int i = w0; i < T; i += wstep) {
        // task_arrivals' arithmetic, inline for the same reason.
        double a = st.arr[__ldg(comp + i)];
        for (int k = 0; k < K; ++k) {
          const int lo = key[4 * k + 1];
          if (i >= lo && i < key[4 * k + 2]) a = add(a, mul(st.contrib[k], sh[key[4 * k + 3] + i - lo]));
        }
        const Queue q = admit(st.back[i], a, dt, c.max_queue);
        st.back[i] = q.back;
        st.over[i] = q.over;
      }
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    bar_sync<kWork>(workers);
    if (mine) {
      // C. Each machine's tasks in ascending order: var_w, then s_w.
      for (int w = w0; w < m; w += wstep) {
        double var = 0.0;
        for (int j = seg[w]; j < seg[w + 1]; ++j) {
          const int i = ord[j];
          var = add(var, mul(e_s[i], desired_rate(st.back[i], dt, c.rdt)));
        }
        st.s_w[w] = machine_scale(var, st.cap[w], met_w[w]);
      }
    }
    bar_sync<kWork>(workers);
    double top = 0.0;
    if (mine) {
      // D. Service, new backlog, processed.
      for (int i = w0; i < T; i += wstep) {
        const Service sv = serve_task(st.back[i], st.s_w[tm_s[i]], dt, c.rdt);
        st.proc[i] = sv.proc;
        st.back[i] = sv.back;
        top = fmax(top, sv.back);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) top = fmax(top, __shfl_xor_sync(0xffffffffu, top, o));
    if (mine && lane == 0) st.top[warp % WPP] = top;
    bar_arrive<kDone>(workers + 64);  // the chain and totals warps may read window t
    bar_sync<kWork>(workers);
    if (mine) {
      // E. Each machine's tcu sum, in task order, into its utilization.
      for (int w = w0; w < m; w += wstep) {
        const double alive = st.cap[w] > 0.0 ? 1.0 : 0.0;
        double u = 0.0;
        for (int j = seg[w]; j < seg[w + 1]; ++j) {
          const int i = ord[j];
          u = add(u, tcu(e_s[i], st.proc[i], met_s[i], alive));
        }
        st.util[w] = add(st.util[w], u);
      }
    }
  }
  if (mine) {
    const size_t ou = (static_cast<size_t>(b0 + g) * P + p) * m;
    for (int w = w0; w < m; w += wstep) out_util[ou + w] = st.util[w] / static_cast<double>(W);
  }
}

// The global-state instance's carve. Always in shared memory: the totals'
// ring (2 kRing kChunk doubles), alpha, each window's arrivals a component
// and prev_out (n each), the fields edges' flows (max(K, 1)), each worker
// warp's deepest queue (NWG), the throttle and the admitted rate
// (doubles); the packed topology and a count a warp for listing the
// occupied machines (NWG + 2; int32). A pair's per-task state (backlog,
// processed, dropped: 3 T doubles; each task's place in the list of
// occupied machines: T int32) joins them where it fits SMEM_LIMIT, and the
// per-machine state for the occ = min(T, m) machines a placement can occupy
// (capacities, scales (occ + 1: slot n_occ, 0, for the tasks on no
// machine), utilization and fixed loads: 4 occ + 1 doubles; each listed
// machine's id and its start in the task order, occ + 1 for the end: 2 occ
// + 1 int32) joins them where it fits beside those. Always in the block's
// slab: the copy of the backlog and the drops that the totals read (2 Tc
// doubles, Tc = T rounded up to kChunk); then what does not fit shared
// memory, doubles before int32. ops.global_smem_bytes and ops.slab_bytes count the
// same bytes.
struct GlobalLayout {
  int T, m, n, kc, occ;  // occ: the machines a placement can occupy, min(T, m)
  long long tc;          // T rounded up to kChunk
  long long small_d, small_i, task_d, task_i, mach_d, mach_i;
  bool task_smem, mach_smem;
  __host__ __device__ GlobalLayout(int T_, int m_, int n_, int E, int K)
      : T(T_), m(m_), n(n_), kc(K > 0 ? K : 1), occ(T_ < m_ ? T_ : m_) {
    tc = (T + kChunk - 1LL) / kChunk * kChunk;
    small_d = 2LL * kRing * kChunk + 3LL * n + kc + NWG + 2;
    small_i = (3LL * n + 2 + E + 4LL * K) + (NWG + 2);
    task_d = 3LL * T;
    task_i = T;
    mach_d = 4LL * occ + 1;
    mach_i = 2LL * occ + 1;
    const long long base = 8 * small_d + 4 * small_i;
    const long long task = 8 * task_d + 4 * task_i;
    task_smem = base + task <= kSmemLimit;
    mach_smem = base + (task_smem ? task : 0) + 8 * mach_d + 4 * mach_i <= kSmemLimit;
  }
  __host__ __device__ long long smem_bytes() const {
    return 8 * (small_d + (task_smem ? task_d : 0) + (mach_smem ? mach_d : 0)) +
           4 * (small_i + (task_smem ? task_i : 0) + (mach_smem ? mach_i : 0));
  }
  // Doubles of a block's slab (a multiple of two).
  __host__ __device__ long long slab_doubles() const {
    const long long d = 2 * tc + (task_smem ? 0 : task_d) + (mach_smem ? 0 : mach_d);
    const long long i = (task_smem ? 0 : task_i) + (mach_smem ? 0 : mach_i);
    return (d + (i + 1) / 2 + 1) / 2 * 2;
  }
};

// One pair a block at a time, every warp on it: see the file's head. One
// block a SM (its shared memory holds thousands of tasks' state anyway)
// leaves each thread the registers of four loads in flight.
__global__ void __launch_bounds__(kGlobalThreads, 1)
policy_scan_global_kernel(const double* __restrict__ rates, const double* __restrict__ capacity,
                          const double* __restrict__ e, const double* __restrict__ met,
                          const int* __restrict__ order, const int* __restrict__ mstart,
                          const int* __restrict__ comp, const double* __restrict__ alpha,
                          const int* __restrict__ topo, const double* __restrict__ shares,
                          double* __restrict__ out_thpt, double* __restrict__ out_adm,
                          double* __restrict__ out_drop, double* __restrict__ out_qtot,
                          double* __restrict__ out_thr, double* __restrict__ out_util, int B,
                          int P, int T, int m, int n, int E, int K, int W, int S, Consts c,
                          double* __restrict__ slab, long long slab_doubles) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const GlobalLayout L(T, m, n, E, K);
  constexpr int workers = NWG * 32, chain_warp = NWG, totals_warp = NWG + 1;

  // The carve: doubles, then int32, in shared memory and in the slab.
  double* sd = smem;
  double* gd = slab + static_cast<size_t>(blockIdx.x) * slab_doubles;
  double* ring = sd;  // [kRing][2][kChunk]
  double* copy = gd;  // [2][tc]: backlog and dropped as the last phase D left them
  gd += 2 * L.tc;
  double* alpha_s = ring + 2 * kRing * kChunk;
  double* arr = alpha_s + n;
  double* prev_out = arr + n;
  double* contrib = prev_out + n;
  double* tops = contrib + L.kc;
  double* thr = tops + NWG;
  double* r_adm = thr + 1;
  sd = r_adm + 1;
  double* back = L.task_smem ? sd : gd;
  double* proc = back + T;
  double* over = proc + T;
  (L.task_smem ? sd : gd) = over + T;
  double* cap = L.mach_smem ? sd : gd;  // per listed machine
  double* s_w = cap + L.occ;
  double* util = s_w + L.occ + 1;
  double* met_w = util + L.occ;
  (L.mach_smem ? sd : gd) = met_w + L.occ;
  int* si = reinterpret_cast<int*>(sd);
  int* gi = reinterpret_cast<int*>(gd);
  int* topo_s = si;
  int* wcount = topo_s + (3 * n + 2 + E + 4 * K);
  si = wcount + NWG + 2;
  int* tm_s = L.task_smem ? si : gi;  // each task's place in the list (n_occ: none)
  (L.task_smem ? si : gi) = tm_s + T;
  int* occ_w = L.mach_smem ? si : gi;  // the listed machines, ascending
  int* occ_lo = occ_w + L.occ;         // their runs of the task order
  const int* off = topo_s;
  const int* is_source = off + n + 1;
  const int* parent_ptr = is_source + n;
  const int* parent_idx = parent_ptr + n + 1;
  const int* key = parent_idx + E;  // K x (parent, lo, hi, share column)

  for (int i = tid; i < 3 * n + 2 + E + 4 * K; i += blockDim.x) topo_s[i] = topo[i];
  for (int i = tid; i < n; i += blockDim.x) alpha_s[i] = alpha[i];

  const double dt = c.dt;

  // Pairs trace-fastest: the blocks at work at once share few placements'
  // arrays in the L2.
  for (long long item = blockIdx.x; item < static_cast<long long>(B) * P; item += gridDim.x) {
    const int b = static_cast<int>(item % B), p = static_cast<int>(item / B);
    const size_t pt = static_cast<size_t>(p) * T;
    const double* e_p = e + pt;
    const double* met_p = met + pt;
    const int* ord = order + pt;
    const int* seg = mstart + static_cast<size_t>(p) * (m + 2);
    __syncthreads();  // the last pair's state read; alpha and the topology staged
    for (int i = tid; i < T; i += blockDim.x) back[i] = 0.0;
    for (int i = tid; i < n; i += blockDim.x) prev_out[i] = 0.0;
    if (tid == 0) *thr = 1.0;
    // The occupied machines, ascending: a ballot a warp, blockDim.x machines
    // a step.
    int n_occ = 0;
    for (int w0 = 0; w0 < m; w0 += blockDim.x) {
      const int w = w0 + tid;
      const bool occ = w < m && seg[w + 1] > seg[w];
      const unsigned vote = __ballot_sync(0xffffffffu, occ);
      if (lane == 0) wcount[warp] = __popc(vote);
      __syncthreads();
      int before = n_occ, step = 0;
      for (int q = 0; q < NWG + 2; ++q) {
        before += q < warp ? wcount[q] : 0;
        step += wcount[q];
      }
      if (occ) occ_w[before + __popc(vote & ((1u << lane) - 1u))] = w;
      __syncthreads();  // wcount is rewritten next step
      n_occ += step;
    }
    // Each listed machine's run and fixed load, in task order (every task is
    // active: no migrations), and each task's place in the list.
    for (int k = tid; k < n_occ; k += blockDim.x) {
      const int w = occ_w[k];
      const int lo = seg[w], hi = seg[w + 1];
      occ_lo[k] = lo;
      double v = 0.0;
      for (int j = lo; j < hi; ++j) {
        const int i = ord[j];
        tm_s[i] = k;
        v = add(v, met_p[i]);
      }
      met_w[k] = v;
      util[k] = 0.0;
    }
    for (int j = seg[m] + tid; j < T; j += blockDim.x) tm_s[ord[j]] = n_occ;
    if (tid == 0) {
      occ_lo[n_occ] = seg[m];
      s_w[n_occ] = 0.0;  // the tasks on no machine never serve
    }
    __syncthreads();

    auto out_at = [&](int t) { return (static_cast<size_t>(b) * P + p) * W + t; };

    if (warp == totals_warp) {
      // Window t's totals in task order, a lane a total, while window t + 1
      // runs: processed in place (the next phase D waits for the totals), the
      // backlog and the drops from the copy that phase D wrote, streamed
      // through the ring.
      const int chunks = (T + kChunk - 1) / kChunk;
      auto stage = [&](int ch) {  // chunk ch of the two copies into its ring slot
        if (ch < chunks) {
          double* dst = ring + (ch % kRing) * 2 * kChunk;
          for (int q = lane; q < kChunk; q += 32) {
            const int a = q / (kChunk / 2), e = (q % (kChunk / 2)) * 2;
            cp_async16(dst + a * kChunk + e, copy + a * L.tc + static_cast<size_t>(ch) * kChunk + e);
          }
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      };
      double* out = lane == 0 ? out_thpt : lane == 1 ? out_qtot : out_drop;
      bar_arrive<kCopy>(workers + 32);  // window 0's phase D may write the copy
      for (int t = 0; t < W; ++t) {
        bar_sync<kDone>(workers + 64);  // window t's copy written
        for (int ch = 0; ch < kRing - 1; ++ch) stage(ch);
        double v = 0.0;
        for (int ch = 0; ch < chunks; ++ch) {
          stage(ch + kRing - 1);
          asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 1) : "memory");
          __syncwarp();
          if (lane < 3) {
            const int count = T - ch * kChunk < kChunk ? T - ch * kChunk : kChunk;
            v = ordered_sum_from(v, lane == 0 ? proc + ch * kChunk
                                              : ring + ((ch % kRing) * 2 + lane - 1) * kChunk,
                                 count);
          }
          __syncwarp();  // the slot is refilled at ch + 1
        }
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncwarp();
        if (lane < 3) out[out_at(t)] = lane == 2 ? v / dt : v;
        if (t + 1 < W) bar_arrive<kCopy>(workers + 32);  // the next phase D may overwrite it
      }
      continue;
    }

    if (warp == chain_warp) {
      // Between windows: prev_out (a lane a component) and the throttle;
      // for window t, the admitted rate (logged with the throttle), arrivals
      // a task of each component (one division a component) and each fields
      // edge's flow.
      double rate_next = rates[static_cast<size_t>(b) * W];
      for (int t = 0; t < W; ++t) {
        if (t > 0) {
          bar_sync<kDone>(workers + 64);  // window t - 1's phase D done
          for (int i = lane; i < n; i += 32) {
            prev_out[i] = ordered_sum_from(0.0, proc + off[i], off[i + 1] - off[i]);
          }
        }
        const double rate = rate_next;
        if (lane == 0) {
          if (t + 1 < W) rate_next = rates[static_cast<size_t>(b) * W + t + 1];
          double th = *thr;
          if (t > 0) {
            double deep = tops[0];
            for (int k = 1; k < NWG; ++k) deep = fmax(deep, tops[k]);
            th = next_throttle(th, deep, c);
            *thr = th;
          }
          *r_adm = mul(rate, th);
          out_adm[out_at(t)] = *r_adm;
          out_thr[out_at(t)] = th;
        }
        __syncwarp();
        for (int i = lane; i < n; i += 32) {
          arr[i] = component_arrivals(i, off, is_source, parent_ptr, parent_idx, alpha_s,
                                      prev_out, r_adm);
        }
        for (int k = lane; k < K; k += 32) {
          const int par = key[4 * k];
          contrib[k] = mul(alpha_s[par], prev_out[par]);
        }
        bar_arrive<kGo>(workers + 32);  // window t may start
      }
      bar_sync<kDone>(workers + 64);  // the last window's phase D
      continue;
    }

    // Worker warps: tasks and listed machines split over NWG warps, each
    // lane's next Q items loaded together (their loads are independent).
    constexpr int Q = 4;
    const int w0 = warp * 32 + lane, wstep = workers;
    const size_t bw = static_cast<size_t>(b) * W;
    // Machine k's first task, its slope and its run's end: every listed
    // machine has at least one task.
    auto first_task = [&](int k, int& lo, int& hi, int& i0, double& e0) {
      lo = occ_lo[k];
      hi = occ_lo[k + 1];
      i0 = ord[lo];
      e0 = __ldg(e_p + i0);
    };
    for (int t = 0; t < W; ++t) {
      bar_sync<kGo>(workers + 32);  // window t's arrivals ready
      // The window's capacities of the listed machines, then B. arrivals,
      // backlog, drops.
      const double* cap_t = capacity + (bw + t) * m;
      for (int k0 = w0; k0 < n_occ; k0 += Q * wstep) {
        double v[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int k = k0 + q * wstep;
          v[q] = k < n_occ ? __ldg(cap_t + occ_w[k]) : 0.0;
        }
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          if (k0 + q * wstep < n_occ) cap[k0 + q * wstep] = v[q];
        }
      }
      const double* sh = shares + (bw + t) * S;
      for (int i = w0; i < T; i += wstep) {
        const double a = task_arrivals(i, arr[__ldg(comp + i)], K, key, contrib, sh);
        const Queue q = admit(back[i], a, dt, c.max_queue);
        back[i] = q.back;
        over[i] = q.over;
      }
      bar_sync<kWork>(workers);
      // C. Each listed machine's tasks in ascending order: var_w, then s_w.
      for (int k0 = w0; k0 < n_occ; k0 += Q * wstep) {
        int lo[Q], hi[Q], i0[Q];
        double e0[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          if (k0 + q * wstep < n_occ) first_task(k0 + q * wstep, lo[q], hi[q], i0[q], e0[q]);
        }
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int k = k0 + q * wstep;
          if (k >= n_occ) continue;
          double var = add(0.0, mul(e0[q], desired_rate(back[i0[q]], dt, c.rdt)));
          for (int j = lo[q] + 1; j < hi[q]; ++j) {
            const int i = ord[j];
            var = add(var, mul(__ldg(e_p + i), desired_rate(back[i], dt, c.rdt)));
          }
          s_w[k] = machine_scale(var, cap[k], met_w[k]);
        }
      }
      bar_sync<kWork>(workers);
      // D. Service, new backlog, processed, once the totals have read the
      // last window's; the backlog and the drops copied for them.
      bar_sync<kCopy>(workers + 32);
      double top = 0.0;
      for (int i0 = w0; i0 < T; i0 += Q * wstep) {
        double sv[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int i = i0 + q * wstep;
          sv[q] = i < T ? s_w[tm_s[i]] : 0.0;
        }
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int i = i0 + q * wstep;
          if (i >= T) continue;
          const Service r = serve_task(back[i], sv[q], dt, c.rdt);
          proc[i] = r.proc;
          back[i] = r.back;
          top = fmax(top, r.back);
          copy[i] = r.back;
          copy[L.tc + i] = over[i];
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) top = fmax(top, __shfl_xor_sync(0xffffffffu, top, o));
      if (lane == 0) tops[warp] = top;
      bar_arrive<kDone>(workers + 64);  // the chain and totals warps may read window t
      bar_sync<kWork>(workers);
      // E. Each listed machine's tcu sum, in task order, into its utilization.
      for (int k0 = w0; k0 < n_occ; k0 += Q * wstep) {
        int lo[Q], hi[Q], i0[Q];
        double e0[Q], m0[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          if (k0 + q * wstep < n_occ) {
            first_task(k0 + q * wstep, lo[q], hi[q], i0[q], e0[q]);
            m0[q] = __ldg(met_p + i0[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int k = k0 + q * wstep;
          if (k >= n_occ) continue;
          const double alive = cap[k] > 0.0 ? 1.0 : 0.0;
          double u = add(0.0, tcu(e0[q], proc[i0[q]], m0[q], alive));
          for (int j = lo[q] + 1; j < hi[q]; ++j) {
            const int i = ord[j];
            u = add(u, tcu(__ldg(e_p + i), proc[i], __ldg(met_p + i), alive));
          }
          util[k] = add(util[k], u);
        }
      }
    }
    // Every machine's window mean: 0.0 for the empty ones, then the listed.
    const size_t ou = (static_cast<size_t>(b) * P + p) * m;
    for (int w = w0; w < m; w += wstep) out_util[ou + w] = 0.0;
    bar_sync<kWork>(workers);
    for (int k = w0; k < n_occ; k += wstep) {
      out_util[ou + occ_w[k]] = util[k] / static_cast<double>(W);
    }
  }
}

// The resident blocks of the global-state instance: `sms` times its
// occupancy, at most the pairs. Fills per_sm.
cudaError_t global_blocks(int device, long long pairs, long long smem_bytes, int& per_sm,
                          long long& blocks) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, policy_scan_global_kernel,
                                                        kGlobalThreads,
                                                        static_cast<size_t>(smem_bytes));
  }
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  blocks = pairs < resident ? pairs : resident;
  return err;
}

template <typename KERNEL>
cudaError_t set_smem(KERNEL kernel, long long smem_bytes) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes));
}

}  // namespace

// The launch for B traces x P placements with G pairs a block (0: the
// global-state instance) and `smem_bytes` of shared memory, into out[0..4]:
// threads a block, resident blocks a SM, registers and local (spilled)
// bytes a thread, and blocks. Returns a cudaError_t code: 0 on success.
extern "C" int policy_scan_occupancy(int device, long long B, long long P, int G,
                                     long long smem_bytes, long long* out) {
  const bool global = G == 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = global ? set_smem(policy_scan_global_kernel, smem_bytes)
                 : set_smem(policy_scan_kernel, smem_bytes);
  }
  const int threads = global ? kGlobalThreads : (G * WPP + 2) * 32;
  int per_sm = 0;
  long long blocks = 0;
  if (err == cudaSuccess && global) err = global_blocks(device, B * P, smem_bytes, per_sm, blocks);
  if (err == cudaSuccess && !global) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, policy_scan_kernel, threads,
                                                        static_cast<size_t>(smem_bytes));
    blocks = P * ((B + G - 1) / G);
  }
  cudaFuncAttributes attr;
  if (err == cudaSuccess) {
    err = global ? cudaFuncGetAttributes(&attr, policy_scan_global_kernel)
                 : cudaFuncGetAttributes(&attr, policy_scan_kernel);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = threads;
  out[1] = per_sm;
  out[2] = attr.numRegs;
  out[3] = static_cast<long long>(attr.localSizeBytes);
  out[4] = blocks;
  return 0;
}

// Launches the kernel on `stream` (no synchronisation): blocks of G pairs
// (one placement, G traces) with `smem_bytes` of shared memory, which the
// wrapper counts for the layout above (ops.smem_bytes); or, with G = 0, the
// global-state instance, whose `smem_bytes` the wrapper counts as
// ops.global_smem_bytes, on `slab_blocks` blocks (at most the pairs; the
// resident ones, policy_scan_occupancy's) with a slab each at `slab`
// (ops.slab_bytes a block, which the wrapper allocates). Returns a
// cudaError_t code: 0 on success, cudaErrorInvalidValue where `smem_bytes`
// is not the layout's size or the slabs are missing. Empty inputs launch
// nothing.
extern "C" int policy_scan_launch(int device, const void* rates, const void* capacity,
                                  const void* e, const void* met, const void* order,
                                  const void* mstart, const void* comp, const void* alpha,
                                  const void* topo, const void* shares, void* thpt, void* adm,
                                  void* drop, void* qtot, void* thr, void* util, long long B,
                                  long long P, int T, int m, int n, int E, int K, int W, int S,
                                  int G, double dt, double max_queue, double bp_high,
                                  double bp_low, double down, double up, double tmin,
                                  void* slab, long long slab_blocks, long long smem_bytes,
                                  void* stream) {
  if (B <= 0 || P <= 0 || W <= 0 || T <= 0) return 0;
  const bool global = G == 0;
  if (G < 0 || G > PAIRS_MAX || B > 0x7fffffffLL || P > 0x7fffffffLL ||
      smem_bytes != (global ? GlobalLayout(T, m, n, E, K).smem_bytes()
                            : Layout(T, m, n, K).bytes(G, E, K)) ||
      (global && (slab == nullptr || slab_blocks < 1 || slab_blocks > B * P ||
                  slab_blocks > 0x7fffffffLL))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = global ? set_smem(policy_scan_global_kernel, smem_bytes)
                 : set_smem(policy_scan_kernel, smem_bytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // 1 / dt where it is exact (dt a power of two, its reciprocal normal):
  // then x * (1 / dt) is x / dt, bit for bit; 0 where it is not.
  int exp2 = 0;
  const double mant = frexp(dt, &exp2);
  const double rdt = (dt > 0.0 && mant == 0.5 && exp2 > -1021 && exp2 < 1023) ? 1.0 / dt : 0.0;
  const Consts c{dt, rdt, max_queue, bp_high, bp_low, down, up, tmin};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const double*>(rates);
  const auto* cp = static_cast<const double*>(capacity);
  const auto* ep = static_cast<const double*>(e);
  const auto* mp = static_cast<const double*>(met);
  const auto* op = static_cast<const int*>(order);
  const auto* sp = static_cast<const int*>(mstart);
  const auto* cm = static_cast<const int*>(comp);
  const auto* al = static_cast<const double*>(alpha);
  const auto* tp = static_cast<const int*>(topo);
  const auto* sh = static_cast<const double*>(shares);
  auto* o0 = static_cast<double*>(thpt);
  auto* o1 = static_cast<double*>(adm);
  auto* o2 = static_cast<double*>(drop);
  auto* o3 = static_cast<double*>(qtot);
  auto* o4 = static_cast<double*>(thr);
  auto* o5 = static_cast<double*>(util);
  const size_t smem = static_cast<size_t>(smem_bytes);
  if (!global) {
    // The groups of G traces on the y axis, 65 535 at a time, and the z axis.
    const long long groups = (B + G - 1) / G;
    const long long gy = groups < 65535 ? groups : 65535;
    const dim3 grid(static_cast<unsigned>(P), static_cast<unsigned>(gy),
                    static_cast<unsigned>((groups + gy - 1) / gy));
    policy_scan_kernel<<<grid, (G * WPP + 2) * 32, smem, s>>>(
        r, cp, ep, mp, op, sp, cm, al, tp, sh, o0, o1, o2, o3, o4, o5, static_cast<int>(B),
        static_cast<int>(P), T, m, n, E, K, W, S, G, c);
    return static_cast<int>(cudaGetLastError());
  }
  policy_scan_global_kernel<<<static_cast<unsigned>(slab_blocks), kGlobalThreads, smem, s>>>(
      r, cp, ep, mp, op, sp, cm, al, tp, sh, o0, o1, o2, o3, o4, o5, static_cast<int>(B),
      static_cast<int>(P), T, m, n, E, K, W, S, c, static_cast<double*>(slab),
      GlobalLayout(T, m, n, E, K).slab_doubles());
  return static_cast<int>(cudaGetLastError());
}
