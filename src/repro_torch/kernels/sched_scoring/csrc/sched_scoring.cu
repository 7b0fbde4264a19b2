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
//
// What holds it back is the row's chain of dependent steps, not bytes: a
// row's m accumulators (2 or 3 doubles each) live in shared memory, which
// caps the rows resident on an SM at ~50, and each task is a random gather
// from the profile tables plus a read-modify-write of one accumulator.
// Design: one warp a row. The row's tiles of TT tasks come into shared
// memory by cp.async, double-buffered (the next tile's copy overlaps this
// tile's work), as the 16-byte chunks that hold the tile (coalesced, and
// past L1, which keeps the profile tables) whatever the row's alignment.
// Lane l takes task j0 + l of each group of 32: its gathers and product do
// not depend on the other lanes'. The lanes then add into their machines'
// accumulators in rounds: in each round the lowest waiting lane on each
// machine (an atomic minimum on a per-machine tag) adds, so the tasks of
// one machine add in task order -- the plain version's order -- and no two
// lanes of a round touch one accumulator. A group of 32 tasks over m = 180
// machines takes about two rounds. At the end lane l takes the machines
// w = l (mod 32); the lanes' partial min of head / var and "infeasible"
// flags combine by warp shuffles (min and or are exact in any order).
// Products and sums use explicit round-to-nearest intrinsics (and the file
// builds with -fmad=false): the results are bit-identical to the plain
// version, to the reference's sequential np.add.at, and to reruns. PERF.md
// lists the designs timed on the card and dropped.
//
// Past the m whose accumulators fit one block (ops.max_machines), a second
// instance (TILED) splits the machines into tiles of `tile_w` (sized so
// that eight one-warp blocks share an SM: ops.machine_tiles). A warp takes
// one (row, machine tile) pair: it streams the row's tasks as above and
// adds only those whose machine lies in its tile, in the same rounds, so
// each machine still adds its tasks in task order. It writes the tile's
// partial min of head / var and its "infeasible" flag to a scratch; a
// second kernel takes a row's partials in tile order. Min and or are exact
// in any order, so both instances give the same bits.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int TT = 128;       // tasks a staged tile
constexpr int NSTAGE = 2;     // tiles a warp keeps staged (NSTAGE - 1 in flight)
constexpr int TS_I = TT + 8;  // strides of a staged tile: TT values and the
constexpr int TS_D = TT + 4;  //   16 bytes of slack either side (int32, double)
constexpr int kRows = 4;      // rows (warps) a block (1-8 timed alike on the card)

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
  double* part_rate;       // (B, n_tiles) a tile's partial min (TILED), or null
  int* part_bad;           // (B, n_tiles) a tile's "infeasible" flag (TILED), or null
  int64_t B, T;
  int64_t comp_stride, uir_stride, cap_stride, mem_cap_stride;
  int m;
  int tile_w;              // machines a tile (m in the one-block layout)
  int64_t n_tiles;         // machine tiles a row (1 in the one-block layout)
  int warp_bytes;          // shared memory of one (row, tile) warp
};

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The warp copies elements [g0, g0 + count) of `base` (n_total elements)
// into shared memory, coalesced; element g0 lands at dst[chunk_offset].
// With a 16-byte aligned `base`, the copy covers the 16-byte chunks
// that hold the range (dst has 2 * 16 bytes of slack), by 16-byte copies
// that bypass L1 (which keeps the profile tables), one element at a time
// only past the array's last full chunk; else it copies element by element.
template <typename ELEM>
__device__ __forceinline__ int chunk_offset(const ELEM* base, int64_t g0) {
  constexpr int PER16 = 16 / sizeof(ELEM);
  return (reinterpret_cast<uintptr_t>(base) & 15) != 0 ? 0 : static_cast<int>(g0 % PER16);
}

template <typename ELEM>
__device__ __forceinline__ void stage_row(ELEM* dst, const ELEM* base, int64_t g0, int count,
                                         int64_t n_total, int lane) {
  constexpr int PER16 = 16 / sizeof(ELEM);
  const int64_t g1 = g0 + count;
  if ((reinterpret_cast<uintptr_t>(base) & 15) != 0) {
    for (int j = lane; j < count; j += 32) cp_async(dst + j, base + g0 + j, sizeof(ELEM));
    return;
  }
  const int64_t a0 = g0 / PER16 * PER16;
  int64_t a1 = (g1 + PER16 - 1) / PER16 * PER16;
  if (a1 > n_total) a1 = n_total / PER16 * PER16;
  for (int64_t k = a0 + lane * PER16; k < a1; k += 32 * PER16) {
    cp_async(dst + (k - a0), base + k, 16);
  }
  for (int64_t k = (a1 > g0 ? a1 : g0) + lane; k < g1; k += 32) {
    cp_async(dst + (k - a0), base + k, sizeof(ELEM));
  }
}

// Shared memory of one warp: accumulators [var | met | (mem)][m] and, for
// the ordered rounds, one tag per machine, padded to 16 bytes; then the
// NSTAGE raw tiles (each with the copies' slack): unit_ir [NSTAGE][TS_D]
// (per-row maps), tm [NSTAGE][TS_I], comp [NSTAGE][TS_I] (per-row maps).
__host__ __device__ int acc_doubles(int m, bool use_mem) {
  return ((use_mem ? 3 : 2) * m + (m + 1) / 2 + 1) / 2 * 2;
}

int warp_smem(int m, bool use_mem, bool row_comp, bool row_uir) {
  return acc_doubles(m, use_mem) * static_cast<int>(sizeof(double)) +
         NSTAGE * (TS_I * static_cast<int>(sizeof(int32_t)) * (1 + row_comp) +
                   TS_D * static_cast<int>(sizeof(double)) * row_uir);
}

// The tiled instance's width: the most machines, a multiple of 32, whose
// warp takes at most kTileWarpBytes, so that eight one-warp blocks (each
// reserving 1 KB) share an SM's 228 KB (ops.machine_tiles mirrors it).
constexpr int kTileWarpBytes = 27 * 1024;

int tile_width(bool use_mem, bool row_comp, bool row_uir) {
  int w = 32;
  while (warp_smem(w + 32, use_mem, row_comp, row_uir) <= kTileWarpBytes) w += 32;
  return w;
}

// TILED: the warp takes machines [w0, w0 + mw) of its row (a tile), with
// accumulators for tile_w machines; else all m machines of its row.
template <bool RES, bool TILED>
__global__ void sched_scoring_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t pair = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (pair >= (TILED ? a.B * a.n_tiles : a.B)) return;  // warps work alone: no block barrier
  const int64_t b = TILED ? pair / a.n_tiles : pair;
  const int m = a.m;
  const int L = TILED ? a.tile_w : m;  // accumulators a warp
  const int w0 = TILED ? static_cast<int>(pair - b * a.n_tiles) * a.tile_w : 0;
  const int mw = TILED ? (m - w0 < L ? m - w0 : L) : m;  // machines of this warp
  const bool use_mem = RES && a.mem_c != nullptr;
  const bool row_comp = a.comp_stride != 0, row_uir = a.uir_stride != 0;

  double* s_var = reinterpret_cast<double*>(smem + static_cast<size_t>(warp) * a.warp_bytes);
  double* s_met = s_var + L;
  double* s_mem = s_met + L;
  int* s_tag = reinterpret_cast<int*>(s_var + (use_mem ? 3 : 2) * L);
  double* s_uir = s_var + acc_doubles(L, use_mem);
  int32_t* s_tm = reinterpret_cast<int32_t*>(s_uir + (row_uir ? NSTAGE * TS_D : 0));
  int32_t* s_comp = s_tm + NSTAGE * TS_I;
  for (int i = lane; i < (use_mem ? 3 : 2) * L; i += 32) s_var[i] = 0.0;
  for (int w = lane; w < L; w += 32) s_tag[w] = 32;

  // The row's tiles of TT tasks, copied NSTAGE - 1 tiles ahead.
  const int64_t n_tiles = (a.T + TT - 1) / TT;
  const int64_t n_total = a.B * a.T;
  auto stage = [&](int64_t tile) {
    if (tile < n_tiles) {
      const int64_t g0 = b * a.T + tile * TT;
      const int count = static_cast<int>(a.T - tile * TT < TT ? a.T - tile * TT : TT);
      const int k = static_cast<int>(tile % NSTAGE);
      stage_row(s_tm + k * TS_I, a.tm, g0, count, n_total, lane);
      if (row_comp) stage_row(s_comp + k * TS_I, a.comp, g0, count, n_total, lane);
      if (row_uir) stage_row(s_uir + k * TS_D, a.unit_ir, g0, count, n_total, lane);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  for (int tile = 0; tile < NSTAGE - 1; ++tile) stage(tile);

  for (int64_t tile = 0; tile < n_tiles; ++tile) {
    stage(tile + NSTAGE - 1);  // into the buffer consumed at tile - 1
    cp_async_wait<NSTAGE - 1>();
    __syncwarp();
    const int k = static_cast<int>(tile % NSTAGE);
    const int64_t t0 = tile * TT, g0 = b * a.T + t0;
    const int32_t* tm_t = s_tm + k * TS_I + chunk_offset(a.tm, g0);
    const int32_t* comp_t = s_comp + k * TS_I + chunk_offset(a.comp, g0);
    const double* uir_t = s_uir + k * TS_D + chunk_offset(a.unit_ir, g0);
    const int count = static_cast<int>(a.T - t0 < TT ? a.T - t0 : TT);
    for (int j0 = 0; j0 < count; j0 += 32) {
      // Lane l takes task j0 + l: its gathers and product, independent of
      // the other lanes'. Ids outside [0, m) match no machine, and those
      // outside the warp's machines are not its own (w = -1); w is the
      // machine's place among the warp's accumulators.
      const int j = j0 + lane;
      const unsigned u =
          j < count ? static_cast<unsigned>(tm_t[j]) - static_cast<unsigned>(w0) : ~0u;
      const int w = u < static_cast<unsigned>(mw) ? static_cast<int>(u) : -1;
      double ev = 0.0, met = 0.0, mem = 0.0;
      if (w >= 0) {
        const int c = row_comp ? comp_t[j] : __ldg(a.comp + t0 + j);
        const double u = row_uir ? uir_t[j] : __ldg(a.unit_ir + t0 + j);
        const int64_t cw = static_cast<int64_t>(c) * m + (w0 + w);
        ev = __dmul_rn(__ldg(a.e_cm + cw), u);
        met = __ldg(a.met_cm + cw);
        if (use_mem) mem = __ldg(a.mem_c + c);
      }
      // Lanes whose tasks land on one machine add in lane (= task)
      // order: each round, the lowest waiting lane on each machine (its
      // tag's atomic minimum) adds. Most rounds' machines are distinct.
      bool wait = w >= 0;
      while (__any_sync(0xffffffffu, wait)) {
        if (wait) atomicMin(s_tag + w, lane);
        __syncwarp();
        const bool first = wait && s_tag[w] == lane;
        if (first) {
          s_var[w] = __dadd_rn(s_var[w], ev);
          s_met[w] = __dadd_rn(s_met[w], met);
          if (use_mem) s_mem[w] = __dadd_rn(s_mem[w], mem);
        }
        __syncwarp();
        if (first) {
          s_tag[w] = 32;
          wait = false;
        }
        __syncwarp();
      }
    }
    __syncwarp();  // the buffer is refilled at tile + 1
  }
  cp_async_wait<0>();

  // Lane l finalizes the warp's machines w = l (mod 32); the partials
  // combine by shuffles (min and or are exact in any order).
  bool infeasible = false;
  double rate = CUDART_INF;
  const double* cap = a.cap + b * a.cap_stride + w0;
  const double* net = (RES && a.net != nullptr) ? a.net + b * m + w0 : nullptr;
  const double* mem_cap = use_mem ? a.mem_cap + b * a.mem_cap_stride + w0 : nullptr;
  for (int w = lane; w < mw; w += 32) {
    double var = s_var[w];
    // (B, m) rows are read once: streaming loads, which leave L1 to the tables
    if (RES && net != nullptr) var = __dadd_rn(var, __ldcs(net + w));
    const double head = __dsub_rn(a.cap_stride ? __ldcs(cap + w) : __ldg(cap + w), s_met[w]);
    if (head < 0.0) infeasible = true;
    if (use_mem &&
        s_mem[w] > (a.mem_cap_stride ? __ldcs(mem_cap + w) : __ldg(mem_cap + w))) {
      infeasible = true;
    }
    if (var > 0.0) rate = fmin(rate, __ddiv_rn(head, fmax(var, 1e-300)));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    rate = fmin(rate, __shfl_xor_sync(0xffffffffu, rate, off));
  }
  infeasible = __any_sync(0xffffffffu, infeasible);
  if (lane == 0) {
    if (TILED) {
      a.part_rate[pair] = rate;
      a.part_bad[pair] = infeasible;
    } else {
      a.out[b] = infeasible ? 0.0 : fmax(rate, 0.0);
    }
  }
}

// The tiled instance's second pass: row b's tile partials, in tile order.
__global__ void combine_tiles_kernel(Args a) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  double rate = CUDART_INF;
  bool infeasible = false;
  for (int64_t k = b * a.n_tiles; k < (b + 1) * a.n_tiles; ++k) {
    rate = fmin(rate, a.part_rate[k]);
    infeasible |= a.part_bad[k] != 0;
  }
  a.out[b] = infeasible ? 0.0 : fmax(rate, 0.0);
}

// The one-block layout (tile_w == m) where a row's accumulators fit a
// block, else the tiled one at tile_width's width (and only then: the
// wrapper's tile_w must be the layout's, as ops.machine_tiles gives it).
template <bool RES>
int launch(Args a, bool use_mem, cudaStream_t s) {
  constexpr int kBlockMax = 227 * 1024;
  const bool row_comp = a.comp_stride != 0, row_uir = a.uir_stride != 0;
  const bool tiled = warp_smem(a.m, use_mem, row_comp, row_uir) > kBlockMax;
  if (a.tile_w != (tiled ? tile_width(use_mem, row_comp, row_uir) : a.m)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!tiled) {
    a.warp_bytes = warp_smem(a.m, use_mem, row_comp, row_uir);
    int rows = kRows;
    while (rows > 1 && rows * a.warp_bytes > kBlockMax) rows /= 2;
    const int smem = rows * a.warp_bytes;
    cudaError_t err = cudaFuncSetAttribute(sched_scoring_kernel<RES, false>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>((a.B + rows - 1) / rows));
    sched_scoring_kernel<RES, false><<<grid, 32 * rows, smem, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  // One warp a block: eight blocks share an SM.
  a.n_tiles = (a.m + a.tile_w - 1) / a.tile_w;
  a.warp_bytes = warp_smem(a.tile_w, use_mem, row_comp, row_uir);
  const int64_t pairs = a.B * a.n_tiles;
  if (pairs > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(sched_scoring_kernel<RES, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         a.warp_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* scratch = nullptr;
  err = cudaMallocAsync(&scratch, static_cast<size_t>(pairs) * (sizeof(double) + sizeof(int)), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.part_rate = static_cast<double*>(scratch);
  a.part_bad = reinterpret_cast<int*>(a.part_rate + pairs);
  sched_scoring_kernel<RES, true><<<static_cast<unsigned>(pairs), 32, a.warp_bytes, s>>>(a);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    combine_tiles_kernel<<<static_cast<unsigned>((a.B + 255) / 256), 256, 0, s>>>(a);
    err = cudaGetLastError();
  }
  const cudaError_t freed = cudaFreeAsync(scratch, s);  // after both kernels, in stream order
  return static_cast<int>(err != cudaSuccess ? err : freed);
}

}  // namespace

// Launches the scorer on `stream` (no synchronisation), `tile_w` machines
// a tile (m for the one-block layout). Returns a cudaError_t code: 0 on
// success, cudaErrorInvalidValue where `tile_w` is not the layout's.
extern "C" int sched_scoring_launch(
    int device, const void* tm, const void* comp, long long comp_stride,
    const void* unit_ir, long long uir_stride, const void* e_cm,
    const void* met_cm, const void* cap, long long cap_stride,
    const void* net, const void* mem_c, const void* mem_cap,
    long long mem_cap_stride, void* out, long long B, long long T, int m,
    int tile_w, int resources, void* stream) {
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
  a.tile_w = tile_w;
  a.n_tiles = 1;
  a.part_rate = nullptr;
  a.part_bad = nullptr;
  a.warp_bytes = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool use_mem = resources && mem_c != nullptr;
  return resources ? launch<true>(a, use_mem, s) : launch<false>(a, use_mem, s);
}
