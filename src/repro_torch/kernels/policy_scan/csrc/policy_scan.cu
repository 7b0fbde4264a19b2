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
// instance (GLOBAL) keeps it in a global scratch instead, one slab a
// resident block (the pattern of cut_traffic's kGlobal), and the resident
// blocks walk the (trace, placement) pairs, one at a time. The placement's
// arrays are read in place (e, met, the order and the machine boundaries)
// or kept in the slab (the machines' fixed loads and each task's machine);
// shared memory holds alpha and the packed topology alone. The roles,
// barriers and the order of every sum are the same.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WPP = 3;        // worker warps a pair (ops.WARPS_A_PAIR)
constexpr int PAIRS_MAX = 6;  // pairs a block, at most (ops.PAIRS_MAX)
constexpr int kMaxThreads = (PAIRS_MAX * WPP + 2) * 32;
// Named barriers: the workers' own; a window's phase D done (the workers
// arrive, the chain and totals warps wait); the next window may start (the
// other way round).
constexpr int kWork = 1, kDone = 2, kGo = 3;

struct Consts {
  double dt, rdt, max_queue, bp_high, bp_low, down, up, tmin;
};

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

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

// Shared memory, in doubles: the placement's e and met (T each), the
// machines' fixed loads (m), alpha (n); then per pair: backlog, processed
// and dropped (T each), the window's capacities (m), the machines' scales
// (m + 1; slot m, 0, for the tasks on no machine) and utilization (m),
// arrivals a task and prev_out (n each), the fields edges' flows (max(K,
// 1)), each worker warp's deepest queue (WPP), the throttle and the
// admitted rate; then int32: each task's machine (m where none) and the
// placement's task order (T each), the machines' boundaries (m + 2) and the
// packed topology (3 n + 2 + E + 4 K). ops.smem_bytes counts the same bytes,
// and the launcher refuses a count that is not `bytes` (or, for the GLOBAL
// instance, `global_bytes`: ops.global_smem_bytes).
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
  // Shared bytes of a GLOBAL block: alpha and the packed topology.
  __host__ long long global_bytes(int E, int K) const {
    return 8LL * n + 4 * (3LL * n + 2 + E + 4LL * K);
  }
  // Doubles of a GLOBAL block's slab: a pair's state, the machines' fixed
  // loads and each task's machine; a multiple of two.
  __host__ long long slab_doubles() const {
    const long long d = pair + m + (T + 1LL) / 2;
    return (d + 1) / 2 * 2;
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

// GLOBAL: one pair a block at a time, its state in `slab` (slab_doubles a
// block), the placement's arrays read in place.
template <bool GLOBAL>
__global__ void __launch_bounds__(kMaxThreads, 2)
policy_scan_kernel(const double* __restrict__ rates, const double* __restrict__ capacity,
                   const double* __restrict__ e, const double* __restrict__ met,
                   const int* __restrict__ order, const int* __restrict__ mstart,
                   const int* __restrict__ comp, const double* __restrict__ alpha,
                   const int* __restrict__ topo, const double* __restrict__ shares,
                   double* __restrict__ out_thpt, double* __restrict__ out_adm,
                   double* __restrict__ out_drop, double* __restrict__ out_qtot,
                   double* __restrict__ out_thr, double* __restrict__ out_util, int B, int P,
                   int T, int m, int n, int E, int K, int W, int S, int G, Consts c,
                   double* __restrict__ slab, long long slab_doubles) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Layout L(T, m, n, K);

  // Placement p and its traces b0 .. b0 + G - 1 (those below B).
  auto run = [&](const int p, const int b0) {
  const int g_here = B - b0 < G ? B - b0 : G;  // pairs of this block
  const int n_work = G * WPP;                  // worker warps
  const int workers = n_work * 32;
  const int chain_warp = n_work, totals_warp = n_work + 1;

  const size_t pt = static_cast<size_t>(p) * T;
  const int* mstart_p = mstart + static_cast<size_t>(p) * (m + 2);
  double *e_s, *met_s, *met_w, *alpha_s, *pairs;
  int *tm_s, *ord, *seg, *topo_s;
  if (!GLOBAL) {
    e_s = smem;
    met_s = e_s + T;
    met_w = met_s + T;
    alpha_s = met_w + m;
    pairs = alpha_s + n;
    tm_s = reinterpret_cast<int*>(pairs + static_cast<size_t>(G) * L.pair);
    ord = tm_s + T;
    seg = ord + T;
    topo_s = seg + m + 2;
  } else {
    alpha_s = smem;
    topo_s = reinterpret_cast<int*>(alpha_s + n);
    pairs = slab + static_cast<size_t>(blockIdx.x) * slab_doubles;
    met_w = pairs + L.pair;
    tm_s = reinterpret_cast<int*>(met_w + m);
    e_s = const_cast<double*>(e + pt);  // read in place, never written
    met_s = const_cast<double*>(met + pt);
    ord = const_cast<int*>(order + pt);
    seg = const_cast<int*>(mstart_p);
  }
  const int* off = topo_s;
  const int* is_source = off + n + 1;
  const int* parent_ptr = is_source + n;
  const int* parent_idx = parent_ptr + n + 1;
  const int* key = parent_idx + E;  // K x (parent, lo, hi, share column)

  if (!GLOBAL) {
    for (int i = tid; i < T; i += blockDim.x) {
      e_s[i] = e[pt + i];
      met_s[i] = met[pt + i];
      ord[i] = order[pt + i];
    }
    for (int w = tid; w < m + 2; w += blockDim.x) seg[w] = mstart_p[w];
  }
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
  auto desired = [&](double x) { return c.rdt > 0.0 ? mul(x, c.rdt) : x / dt; };
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
          const double q_frac = deep / c.max_queue;
          if (q_frac > c.bp_high) {
            th = fmax(c.tmin, mul(th, c.down));
          } else if (q_frac < c.bp_low) {
            th = fmin(1.0, mul(th, c.up));
          }
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
      // The window's capacities, by cp.async while phase B runs (GLOBAL:
      // loads into the slab).
      const double* cap = capacity + (bw + t) * m;
      if (GLOBAL) {
        for (int w = w0; w < m; w += wstep) st.cap[w] = cap[w];
      } else {
        for (int w = w0; w < m; w += wstep) cp_async8(st.cap + w, cap + w);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      }
      // B. Arrivals, backlog, drops.
      const double* sh = shares + (bw + t) * S;
      for (int i = w0; i < T; i += wstep) {
        double a = st.arr[__ldg(comp + i)];
        for (int k = 0; k < K; ++k) {
          const int lo = key[4 * k + 1];
          if (i >= lo && i < key[4 * k + 2]) a = add(a, mul(st.contrib[k], sh[key[4 * k + 3] + i - lo]));
        }
        double x = add(st.back[i], mul(a, dt));
        const double o = fmax(sub(x, c.max_queue), 0.0);
        st.back[i] = sub(x, o);
        st.over[i] = o;
      }
      if (!GLOBAL) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    bar_sync<kWork>(workers);
    if (mine) {
      // C. Each machine's tasks in ascending order: var_w, then s_w.
      for (int w = w0; w < m; w += wstep) {
        double var = 0.0;
        for (int j = seg[w]; j < seg[w + 1]; ++j) {
          const int i = ord[j];
          var = add(var, mul(e_s[i], desired(st.back[i])));
        }
        const double head = fmax(sub(st.cap[w], met_w[w]), 0.0);
        st.s_w[w] = var > head ? head / fmax(var, 1e-300) : 1.0;
      }
    }
    bar_sync<kWork>(workers);
    double top = 0.0;
    if (mine) {
      // D. Service, new backlog, processed.
      for (int i = w0; i < T; i += wstep) {
        const double x = st.back[i];
        const double q = mul(desired(x), st.s_w[tm_s[i]]);
        st.proc[i] = q;
        const double y = fmax(sub(x, mul(q, dt)), 0.0);
        st.back[i] = y;
        top = fmax(top, y);
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
          u = add(u, add(mul(e_s[i], st.proc[i]), mul(met_s[i], alive)));
        }
        st.util[w] = add(st.util[w], u);
      }
    }
  }
  if (mine) {
    const size_t ou = (static_cast<size_t>(b0 + g) * P + p) * m;
    for (int w = w0; w < m; w += wstep) out_util[ou + w] = st.util[w] / static_cast<double>(W);
  }
  };

  if (!GLOBAL) {
    // Group blockIdx.y + gridDim.y blockIdx.z of G traces: the y axis
    // holds at most 65 535 groups.
    const long long grp = blockIdx.y + static_cast<long long>(gridDim.y) * blockIdx.z;
    if (grp * G < B) run(blockIdx.x, static_cast<int>(grp * G));
    return;
  }
  for (long long item = blockIdx.x; item < static_cast<long long>(B) * P; item += gridDim.x) {
    __syncthreads();  // the last pair's state, alpha and the topology read
    run(static_cast<int>(item % P), static_cast<int>(item / P));
  }
}

// The resident blocks of the GLOBAL instance: `sms` times its occupancy,
// at most the pairs. Fills per_sm.
cudaError_t global_blocks(int device, long long pairs, long long smem_bytes, int& per_sm,
                          long long& blocks) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, policy_scan_kernel<true>,
                                                        (WPP + 2) * 32,
                                                        static_cast<size_t>(smem_bytes));
  }
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  blocks = pairs < resident ? pairs : resident;
  return err;
}

template <bool GLOBAL>
cudaError_t set_smem(long long smem_bytes) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(policy_scan_kernel<GLOBAL>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes));
}

}  // namespace

// The launch for B traces x P placements with G pairs a block (0: the
// GLOBAL instance) and `smem_bytes` of shared memory, into out[0..4]:
// threads a block, resident blocks a SM, registers and local (spilled)
// bytes a thread, and blocks. Returns a cudaError_t code: 0 on success.
extern "C" int policy_scan_occupancy(int device, long long B, long long P, int G,
                                     long long smem_bytes, long long* out) {
  const bool global = G == 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = global ? set_smem<true>(smem_bytes) : set_smem<false>(smem_bytes);
  const int threads = ((global ? 1 : G) * WPP + 2) * 32;
  int per_sm = 0;
  long long blocks = 0;
  if (err == cudaSuccess && global) err = global_blocks(device, B * P, smem_bytes, per_sm, blocks);
  if (err == cudaSuccess && !global) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, policy_scan_kernel<false>,
                                                        threads, static_cast<size_t>(smem_bytes));
    blocks = P * ((B + G - 1) / G);
  }
  cudaFuncAttributes attr;
  if (err == cudaSuccess) {
    err = global ? cudaFuncGetAttributes(&attr, policy_scan_kernel<true>)
                 : cudaFuncGetAttributes(&attr, policy_scan_kernel<false>);
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
// GLOBAL instance, whose `smem_bytes` the wrapper counts as
// ops.global_smem_bytes. Returns a cudaError_t code: 0 on success,
// cudaErrorInvalidValue where `smem_bytes` is not the layout's size. Empty
// inputs launch nothing.
extern "C" int policy_scan_launch(int device, const void* rates, const void* capacity,
                                  const void* e, const void* met, const void* order,
                                  const void* mstart, const void* comp, const void* alpha,
                                  const void* topo, const void* shares, void* thpt, void* adm,
                                  void* drop, void* qtot, void* thr, void* util, long long B,
                                  long long P, int T, int m, int n, int E, int K, int W, int S,
                                  int G, double dt, double max_queue, double bp_high,
                                  double bp_low, double down, double up, double tmin,
                                  long long smem_bytes, void* stream) {
  if (B <= 0 || P <= 0 || W <= 0 || T <= 0) return 0;
  const Layout L(T, m, n, K);
  const bool global = G == 0;
  if (G < 0 || G > PAIRS_MAX || B > 0x7fffffffLL || P > 0x7fffffffLL ||
      smem_bytes != (global ? L.global_bytes(E, K) : L.bytes(G, E, K))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = global ? set_smem<true>(smem_bytes) : set_smem<false>(smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 1 / dt where it is exact (dt a power of two, its reciprocal normal):
  // then x * (1 / dt) is x / dt, bit for bit; 0 where it is not.
  int exp2 = 0;
  const double mant = frexp(dt, &exp2);
  const double rdt = (dt > 0.0 && mant == 0.5 && exp2 > -1021 && exp2 < 1023) ? 1.0 / dt : 0.0;
  const Consts c{dt, rdt, max_queue, bp_high, bp_low, down, up, tmin};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch = [&](auto kernel, dim3 grid, int threads, double* slab,
                          long long slab_doubles) {
    kernel<<<grid, threads, static_cast<size_t>(smem_bytes), s>>>(
        static_cast<const double*>(rates), static_cast<const double*>(capacity),
        static_cast<const double*>(e), static_cast<const double*>(met),
        static_cast<const int*>(order), static_cast<const int*>(mstart),
        static_cast<const int*>(comp), static_cast<const double*>(alpha),
        static_cast<const int*>(topo), static_cast<const double*>(shares),
        static_cast<double*>(thpt), static_cast<double*>(adm), static_cast<double*>(drop),
        static_cast<double*>(qtot), static_cast<double*>(thr), static_cast<double*>(util),
        static_cast<int>(B), static_cast<int>(P), T, m, n, E, K, W, S, global ? 1 : G, c, slab,
        slab_doubles);
    return cudaGetLastError();
  };
  if (!global) {
    // The groups of G traces on the y axis, 65 535 at a time, and the z axis.
    const long long groups = (B + G - 1) / G;
    const long long gy = groups < 65535 ? groups : 65535;
    const dim3 grid(static_cast<unsigned>(P), static_cast<unsigned>(gy),
                    static_cast<unsigned>((groups + gy - 1) / gy));
    return static_cast<int>(launch(policy_scan_kernel<false>, grid, (G * WPP + 2) * 32, nullptr,
                                   0));
  }
  int per_sm = 0;
  long long blocks = 0;
  err = global_blocks(device, B * P, smem_bytes, per_sm, blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long slab_doubles = L.slab_doubles();
  void* slab = nullptr;
  err = cudaMallocAsync(&slab, static_cast<size_t>(blocks) * slab_doubles * sizeof(double), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch(policy_scan_kernel<true>, dim3(static_cast<unsigned>(blocks)), (WPP + 2) * 32,
               static_cast<double*>(slab), slab_doubles);
  const cudaError_t freed = cudaFreeAsync(slab, s);  // after the kernel, in stream order
  return static_cast<int>(err != cudaSuccess ? err : freed);
}
