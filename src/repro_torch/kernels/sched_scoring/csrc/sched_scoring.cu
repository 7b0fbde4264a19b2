// Closed-form max-stable-rate scorer for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// src/repro/kernels/sched_scoring/kernel.py, together with the host-side
// profile gather of src/repro/kernels/sched_scoring/ops.py:
//   * sched_scoring_pallas            (RES = false, scalar-CPU scoring);
//   * sched_scoring_pallas_resources  (RES = true: memory feasibility mask
//                                      and cut-traffic variable load).
//
// For candidate row b, over the tasks t with tm[b, t] == w, in task order:
//   var_w = sum_t e_cm[comp_t, w] * unit_ir_t
//   met_w = sum_t met_cm[comp_t, w]
//   mem_w = sum_t mem_c[comp_t]                       (RES, with memory)
// then, with net_w added to var_w (RES, with a network term),
//   rate_b = clip(min_{w: var_w > 0} (cap_w - met_w) / max(var_w, 1e-300), 0)
// or 0 when some cap_w - met_w < 0 or some mem_w > mem_cap_w.
// comp/unit_ir are shared (row stride 0) or per row (stride T); capacity
// and memory capacity are shared (stride 0) or per row (stride m).
//
// Bound: bytes. Per row the kernel must read the T task->machine ids
// (int32) -- plus the per-row maps and the (m,) network row when present --
// and does ~3 flops per task, far below the card's ratio of flops to bytes.
// Design: one thread per row; the row's m accumulators live in shared
// memory laid out [w][thread], so the threads of a warp touch consecutive
// banks whatever machines they hit; the small profile tables are gathered
// here from global memory (L1-resident), so per sweep only tm has to cross
// the bus. Tasks are added in row order with explicit round-to-nearest
// multiply and add (never contracted into an FMA) and no atomics: results
// are bit-identical to the reference's sequential np.add.at and to reruns.
// Shared memory per row caps occupancy at about 50-80 rows per SM for
// m = 180; staging tm tiles with coalesced loads and splitting a row over
// several threads is later work.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

struct Args {
  const int32_t* tm;       // (B, T) machine id per task
  const int32_t* comp;     // (T,) or (B, T) component per task
  const double* unit_ir;   // (T,) or (B, T) unit-rate input per task
  const double* e_cm;      // (n, m) per-tuple cost
  const double* met_cm;    // (n, m) fixed overhead
  const double* cap;       // (m,) or (B, m) CPU capacity
  const double* net;       // (B, m) cut-traffic load, or null
  const double* mem_c;     // (n,) memory per instance, or null
  const double* mem_cap;   // (m,) or (B, m) memory capacity
  double* out;             // (B,) rates
  int64_t B, T;
  int64_t comp_stride, uir_stride, cap_stride, mem_cap_stride;
  int m;
};

template <bool RES>
__global__ void sched_scoring_kernel(Args a) {
  extern __shared__ double smem[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * nt + tid;
  if (b >= a.B) return;  // no barriers below: each thread owns its column
  const int m = a.m;
  double* s_var = smem + tid;                        // s_var[w * nt]
  double* s_met = smem + static_cast<size_t>(m) * nt + tid;
  double* s_mem = smem + static_cast<size_t>(2 * m) * nt + tid;
  const bool use_mem = RES && a.mem_c != nullptr;
  for (int w = 0; w < m; ++w) {
    s_var[w * nt] = 0.0;
    s_met[w * nt] = 0.0;
    if (use_mem) s_mem[w * nt] = 0.0;
  }

  const int32_t* tm = a.tm + b * a.T;
  const int32_t* comp = a.comp + b * a.comp_stride;
  const double* uir = a.unit_ir + b * a.uir_stride;
  for (int64_t t = 0; t < a.T; ++t) {
    const int w = tm[t];
    if (w < 0 || w >= m) continue;  // ids outside [0, m) match no machine
    const int c = comp[t];
    const int64_t cw = static_cast<int64_t>(c) * m + w;
    const double ev = __dmul_rn(__ldg(a.e_cm + cw), uir[t]);
    s_var[w * nt] = __dadd_rn(s_var[w * nt], ev);
    s_met[w * nt] = __dadd_rn(s_met[w * nt], __ldg(a.met_cm + cw));
    if (use_mem) s_mem[w * nt] = __dadd_rn(s_mem[w * nt], __ldg(a.mem_c + c));
  }

  const double* cap = a.cap + b * a.cap_stride;
  const double* net = (RES && a.net != nullptr) ? a.net + b * m : nullptr;
  const double* mem_cap = use_mem ? a.mem_cap + b * a.mem_cap_stride : nullptr;
  bool infeasible = false;
  double rate = CUDART_INF;
  for (int w = 0; w < m; ++w) {
    double var = s_var[w * nt];
    if (RES && net != nullptr) var = __dadd_rn(var, net[w]);
    const double head = __dsub_rn(cap[w], s_met[w * nt]);
    if (head < 0.0) infeasible = true;
    if (use_mem && s_mem[w * nt] > mem_cap[w]) infeasible = true;
    if (var > 0.0) rate = fmin(rate, __ddiv_rn(head, fmax(var, 1e-300)));
  }
  a.out[b] = infeasible ? 0.0 : fmax(rate, 0.0);
}

// Largest block (rows per block, at most 128) whose accumulators fit two
// blocks per SM; 0 when even one row does not fit in a block.
int rows_per_block(int m, int n_acc) {
  const size_t per_row = static_cast<size_t>(n_acc) * m * sizeof(double);
  const size_t budget = 113 * 1024;
  const size_t block_max = 227 * 1024;
  for (int rows = 128; rows >= 1; rows /= 2) {
    if (rows * per_row <= budget) return rows;
  }
  return per_row <= block_max ? 1 : 0;
}

}  // namespace

// Launches the scorer on `stream` (no synchronisation). Returns a
// cudaError_t code: 0 on success.
extern "C" int sched_scoring_launch(
    int device, const void* tm, const void* comp, long long comp_stride,
    const void* unit_ir, long long uir_stride, const void* e_cm,
    const void* met_cm, const void* cap, long long cap_stride,
    const void* net, const void* mem_c, const void* mem_cap,
    long long mem_cap_stride, void* out, long long B, long long T, int m,
    int resources, void* stream) {
  if (B <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.tm = static_cast<const int32_t*>(tm);
  a.comp = static_cast<const int32_t*>(comp);
  a.unit_ir = static_cast<const double*>(unit_ir);
  a.e_cm = static_cast<const double*>(e_cm);
  a.met_cm = static_cast<const double*>(met_cm);
  a.cap = static_cast<const double*>(cap);
  a.net = static_cast<const double*>(net);
  a.mem_c = static_cast<const double*>(mem_c);
  a.mem_cap = static_cast<const double*>(mem_cap);
  a.out = static_cast<double*>(out);
  a.B = B;
  a.T = T;
  a.comp_stride = comp_stride;
  a.uir_stride = uir_stride;
  a.cap_stride = cap_stride;
  a.mem_cap_stride = mem_cap_stride;
  a.m = m;
  const int n_acc = resources ? 3 : 2;
  const int rows = rows_per_block(m, n_acc);
  if (rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(n_acc) * m * rows * sizeof(double);
  const dim3 grid(static_cast<unsigned>((B + rows - 1) / rows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (resources) {
    err = cudaFuncSetAttribute(sched_scoring_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    sched_scoring_kernel<true><<<grid, rows, smem, s>>>(a);
  } else {
    err = cudaFuncSetAttribute(sched_scoring_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    sched_scoring_kernel<false><<<grid, rows, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
