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
// warp's issue).

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
  const int p = blockIdx.x;
  const int b0 = blockIdx.y * G;
  const int g_here = B - b0 < G ? B - b0 : G;  // pairs of this block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_work = G * WPP;                  // worker warps
  const int workers = n_work * 32;
  const int chain_warp = n_work, totals_warp = n_work + 1;

  const Layout L(T, m, n, K);
  extern __shared__ double smem[];
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

  const size_t pt = static_cast<size_t>(p) * T;
  const int* mstart_p = mstart + static_cast<size_t>(p) * (m + 2);
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
      // The window's capacities, by cp.async while phase B runs.
      const double* cap = capacity + (bw + t) * m;
      for (int w = w0; w < m; w += wstep) cp_async8(st.cap + w, cap + w);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
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
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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
}

}  // namespace

// The launch for B traces x P placements with G pairs a block and
// `smem_bytes` of shared memory, into out[0..4]: threads a block, resident
// blocks a SM, registers and local (spilled) bytes a thread, and blocks.
// Returns a cudaError_t code: 0 on success.
extern "C" int policy_scan_occupancy(int device, long long B, long long P, int G,
                                     long long smem_bytes, long long* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess && smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(policy_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes));
  }
  const int threads = (G * WPP + 2) * 32;
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, policy_scan_kernel, threads,
                                                        static_cast<size_t>(smem_bytes));
  }
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, policy_scan_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = threads;
  out[1] = per_sm;
  out[2] = attr.numRegs;
  out[3] = static_cast<long long>(attr.localSizeBytes);
  out[4] = P * ((B + G - 1) / G);
  return 0;
}

// Launches the kernel on `stream` (no synchronisation): blocks of G pairs
// (one placement, G traces) with `smem_bytes` of shared memory, which the
// wrapper counts for the layout above (ops.smem_bytes). Returns a
// cudaError_t code: 0 on success, cudaErrorInvalidValue where `smem_bytes`
// is not the layout's size. Empty inputs launch nothing.
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
  if (G < 1 || G > PAIRS_MAX || (B + G - 1) / G > 65535 || P > 0x7fffffffLL ||
      smem_bytes != Layout(T, m, n, K).bytes(G, E, K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(policy_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // 1 / dt where it is exact (dt a power of two, its reciprocal normal):
  // then x * (1 / dt) is x / dt, bit for bit; 0 where it is not.
  int exp2 = 0;
  const double mant = frexp(dt, &exp2);
  const double rdt = (dt > 0.0 && mant == 0.5 && exp2 > -1021 && exp2 < 1023) ? 1.0 / dt : 0.0;
  const Consts c{dt, rdt, max_queue, bp_high, bp_low, down, up, tmin};
  const dim3 grid(static_cast<unsigned>(P), static_cast<unsigned>((B + G - 1) / G));
  policy_scan_kernel<<<grid, (G * WPP + 2) * 32, static_cast<size_t>(smem_bytes),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(rates), static_cast<const double*>(capacity),
      static_cast<const double*>(e), static_cast<const double*>(met),
      static_cast<const int*>(order), static_cast<const int*>(mstart),
      static_cast<const int*>(comp), static_cast<const double*>(alpha),
      static_cast<const int*>(topo), static_cast<const double*>(shares),
      static_cast<double*>(thpt), static_cast<double*>(adm), static_cast<double*>(drop),
      static_cast<double*>(qtot), static_cast<double*>(thr), static_cast<double*>(util),
      static_cast<int>(B), static_cast<int>(P), T, m, n, E, K, W, S, G, c);
  return static_cast<int>(cudaGetLastError());
}
