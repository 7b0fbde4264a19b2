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
// Past the m whose accumulators fit one block (ops.max_machines) a row
// touches at most T of its m machines, so a second instance (TABLE) keeps
// accumulators for those alone: one warp a row, a table of H = S + S / 2 +
// 1 slots for S = min(T, m) machines (ops.table_slots), a machine's slot
// found by a hash of its id with linear probing, and a bitmap of the
// touched machines. In a group of 32 tasks the lanes on one machine find
// each other (__match_any_sync): the lowest inserts the machine (claiming
// an empty slot by atomicCAS; which slot a machine takes changes no sum)
// and passes its slot on, and each lane adds in the round of its rank among
// them, so each machine still adds its tasks in task order, with no tags.
// A tile's four groups' gathers go out together, and four rows share a
// block, as in the one-block layout. The finalize walks the table's slots,
// four a lane in flight. An untouched machine has var = met = mem = 0:
// with (m,) capacities and no network term it can only make a row
// infeasible, by cap_w < 0 or mem_cap_w < 0, so such machines are listed
// once a call (normally none; in a scratch the wrapper allocates,
// ops.scratch_bytes) and a row is infeasible if its bitmap misses one of
// them. With a (B, m) operand (per-row capacity or memory capacity, or
// net_var) the warp also streams the row's m machines, sixteen a lane in
// flight, and finalizes those the bitmap misses from zero accumulators:
// the same expressions, so the same bits. O(B T) work, plus the bytes of
// the (B, m) operands.
//
// Where a row's table does not fit a warp's share of the SM (kTileWarpBytes,
// as a tile's warp: past ~486-737 tasks, by the operands), a third instance
// (TILED) splits the machines into tiles of `tile_w` (sized so that eight
// one-warp blocks share an SM: ops.machine_tiles). A warp takes one (row,
// machine tile) pair: it streams the row's tasks as above and adds only
// those whose machine lies in its tile, in the same rounds, so each machine
// still adds its tasks in task order. It writes the tile's partial min of
// head / var and its "infeasible" flag to a scratch (the wrapper's); a
// second kernel takes a row's partials in tile order. Min and or are exact in any order, so all
// three instances give the same bits.

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
  const int* bad;          // machines with cap_w < 0 or mem_cap_w < 0 (TABLE, no (B, m)
  const int* n_bad;        //   operand), and their count; or null
  int64_t B, T;
  int64_t comp_stride, uir_stride, cap_stride, mem_cap_stride;
  int m;
  int tile_w;              // machines a tile (m in the one-block layout)
  int64_t n_tiles;         // machine tiles a row (1 in the one-block layout)
  int slots;               // the table's slots (TABLE), else 0
  int warp_bytes;          // shared memory of one (row, tile) warp
};

// The kernel's three instances (see above).
enum Layout { kOneBlock, kTiled, kTable };

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

int tile_bytes(bool row_comp, bool row_uir) {
  return NSTAGE * (TS_I * static_cast<int>(sizeof(int32_t)) * (1 + row_comp) +
                   TS_D * static_cast<int>(sizeof(double)) * row_uir);
}

int warp_smem(int m, bool use_mem, bool row_comp, bool row_uir) {
  return acc_doubles(m, use_mem) * static_cast<int>(sizeof(double)) + tile_bytes(row_comp, row_uir);
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

// TABLE: shared memory of one warp with H slots on m machines: var, met
// (and mem) doubles and a machine id (int32) a slot, then a bit a machine
// (int32 words), padded to 16 bytes; then the staged tiles, as warp_smem's.
int64_t table_bytes(int64_t H, int m, bool use_mem, bool row_comp, bool row_uir) {
  const int64_t acc = ((use_mem ? 3 : 2) * 8 + 4) * H + 4 * ((m + 31) / 32);
  return (acc + 15) / 16 * 16 + tile_bytes(row_comp, row_uir);
}

// The table's slots for T tasks on m machines (load under 2/3), or 0 where
// they do not fit a tile's warp: then the TILED instance runs (ops.table_slots
// mirrors it).
int table_slots(int64_t T, int m, bool use_mem, bool row_comp, bool row_uir) {
  const int64_t S = T < m ? T : m;
  const int64_t H = S + S / 2 + 1;
  return table_bytes(H, m, use_mem, row_comp, row_uir) <= kTileWarpBytes ? static_cast<int>(H)
                                                                         : 0;
}

constexpr int kEmpty = -1;  // a free slot's machine id

// A machine's first slot to probe: a multiplicative hash of its id, scaled
// to [0, H).
__device__ __forceinline__ int table_home(int w, int H) {
  return static_cast<int>(__umulhi(static_cast<unsigned>(w) * 2654435769u,
                                   static_cast<unsigned>(H)));
}

// The slot of machine w, claimed (and w's bit set) if it has none yet.
// Leaders of several machines insert at once: one that loses an empty
// slot's atomicCAS to another machine probes on. H exceeds the row's
// machines, so a free slot always remains.
__device__ __forceinline__ int table_insert(int* key, unsigned* bits, int H, int w) {
  int h = table_home(w, H);
  while (true) {
    int k = *reinterpret_cast<volatile int*>(key + h);
    if (k == kEmpty) {
      k = atomicCAS(key + h, kEmpty, w);
      if (k == kEmpty) {
        atomicOr(bits + (w >> 5), 1u << (w & 31));
        return h;
      }
    }
    if (k == w) return h;
    if (++h == H) h = 0;
  }
}

// TILED: the warp takes machines [w0, w0 + mw) of its row (a tile), with
// accumulators for tile_w machines; TABLE: a.slots accumulators, a slot a
// machine the row touches; else all m machines of its row.
template <bool RES, int LAYOUT>
__global__ void sched_scoring_kernel(Args a) {
  constexpr bool TILED = LAYOUT == kTiled, TABLE = LAYOUT == kTable;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t pair = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (pair >= (TILED ? a.B * a.n_tiles : a.B)) return;  // warps work alone: no block barrier
  const int64_t b = TILED ? pair / a.n_tiles : pair;
  const int m = a.m;
  const int L = TILED ? a.tile_w : TABLE ? a.slots : m;  // accumulators a warp
  const int w0 = TILED ? static_cast<int>(pair - b * a.n_tiles) * a.tile_w : 0;
  const int mw = TILED ? (m - w0 < L ? m - w0 : L) : m;  // machines of this warp
  const bool use_mem = RES && a.mem_c != nullptr;
  const bool row_comp = a.comp_stride != 0, row_uir = a.uir_stride != 0;

  double* s_var = reinterpret_cast<double*>(smem + static_cast<size_t>(warp) * a.warp_bytes);
  double* s_met = s_var + L;
  double* s_mem = s_met + L;
  int* s_tag = reinterpret_cast<int*>(s_var + (use_mem ? 3 : 2) * L);
  int* s_key = s_tag;  // TABLE: each slot's machine (no tags), then a bit a machine
  unsigned* s_bits = reinterpret_cast<unsigned*>(s_key + L);
  const int n_words = TABLE ? (m + 31) / 32 : 0;
  double* s_uir =
      TABLE ? reinterpret_cast<double*>(
                  smem + static_cast<size_t>(warp) * a.warp_bytes +
                  (((use_mem ? 3 : 2) * 8 + 4) * static_cast<int64_t>(L) + 4 * n_words + 15) /
                      16 * 16)
            : s_var + acc_doubles(L, use_mem);
  int32_t* s_tm = reinterpret_cast<int32_t*>(s_uir + (row_uir ? NSTAGE * TS_D : 0));
  int32_t* s_comp = s_tm + NSTAGE * TS_I;
  for (int i = lane; i < (use_mem ? 3 : 2) * L; i += 32) s_var[i] = 0.0;
  for (int w = lane; w < L; w += 32) s_tag[w] = TABLE ? kEmpty : 32;
  for (int i = lane; i < n_words; i += 32) s_bits[i] = 0u;

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
    if (TABLE) {
      // The tile's four groups' gathers first (lane l: tasks l, l + 32, ...),
      // then the groups in order.
      constexpr int G = TT / 32;
      int wg[G];
      double evg[G], metg[G], memg[G];
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const int j = q * 32 + lane;
        const unsigned u = j < count ? static_cast<unsigned>(tm_t[j]) : ~0u;
        wg[q] = u < static_cast<unsigned>(m) ? static_cast<int>(u) : -1;
        evg[q] = metg[q] = memg[q] = 0.0;
        if (wg[q] >= 0) {
          const int c = row_comp ? comp_t[j] : __ldg(a.comp + t0 + j);
          const double ur = row_uir ? uir_t[j] : __ldg(a.unit_ir + t0 + j);
          const int64_t cw = static_cast<int64_t>(c) * m + wg[q];
          evg[q] = __dmul_rn(__ldg(a.e_cm + cw), ur);
          metg[q] = __ldg(a.met_cm + cw);
          if (use_mem) memg[q] = __ldg(a.mem_c + c);
        }
      }
#pragma unroll
      for (int q = 0; q < G; ++q) {
        // The lanes on one machine: the lowest finds its slot (inserting
        // it) for all; each adds in the round of its rank among them.
        const int w = wg[q];
        const unsigned peers = __match_any_sync(0xffffffffu, w);
        const int leader = __ffs(peers) - 1;
        int slot = (w >= 0 && lane == leader) ? table_insert(s_key, s_bits, L, w) : -1;
        slot = __shfl_sync(0xffffffffu, slot, leader);
        const int rank = w >= 0 ? __popc(peers & ((1u << lane) - 1u)) : -1;
        const int rounds = __reduce_max_sync(0xffffffffu, static_cast<unsigned>(rank + 1));
        for (int k = 0; k < rounds; ++k) {
          if (rank == k) {
            s_var[slot] = __dadd_rn(s_var[slot], evg[q]);
            s_met[slot] = __dadd_rn(s_met[slot], metg[q]);
            if (use_mem) s_mem[slot] = __dadd_rn(s_mem[slot], memg[q]);
          }
          __syncwarp();
        }
      }
    } else {
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
    }
    __syncwarp();  // the buffer is refilled at tile + 1
  }
  cp_async_wait<0>();

  // Lane l finalizes the warp's machines w = l (mod 32) (TABLE: its slots,
  // then, with a (B, m) operand, the row's untouched machines); the
  // partials combine by shuffles (min and or are exact in any order).
  bool infeasible = false;
  double rate = CUDART_INF;
  const double* cap = a.cap + b * a.cap_stride + w0;
  const double* net = (RES && a.net != nullptr) ? a.net + b * m + w0 : nullptr;
  const double* mem_cap = use_mem ? a.mem_cap + b * a.mem_cap_stride + w0 : nullptr;
  // (B, m) rows are read once: streaming loads, which leave L1 to the tables
  auto cap_at = [&](int w) { return a.cap_stride ? __ldcs(cap + w) : __ldg(cap + w); };
  auto mem_cap_at = [&](int w) {
    return a.mem_cap_stride ? __ldcs(mem_cap + w) : __ldg(mem_cap + w);
  };
  // A machine's accumulators against its capacities (and net_w).
  auto finalize = [&](double var, double met, double mem, double net_w, double cap_w,
                      double mem_cap_w) {
    if (RES && net != nullptr) var = __dadd_rn(var, net_w);
    const double head = __dsub_rn(cap_w, met);
    if (head < 0.0) infeasible = true;
    if (use_mem && mem > mem_cap_w) infeasible = true;
    if (var > 0.0) rate = fmin(rate, __ddiv_rn(head, fmax(var, 1e-300)));
  };
  if (!TABLE) {
    for (int w = lane; w < mw; w += 32) {
      finalize(s_var[w], s_met[w], use_mem ? s_mem[w] : 0.0,
               (RES && net != nullptr) ? __ldcs(net + w) : 0.0, cap_at(w),
               use_mem ? mem_cap_at(w) : 0.0);
    }
  } else {
    __syncwarp();
    // The slots, four a lane at a time: their machines' operands loaded first.
    constexpr int kSlots = 4;
    for (int k0 = lane; k0 < L; k0 += 32 * kSlots) {
      int wv[kSlots];
      double nv[kSlots], cv[kSlots], mv[kSlots];
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        const int k = k0 + q * 32;
        wv[q] = k < L ? s_key[k] : kEmpty;
        nv[q] = cv[q] = mv[q] = 0.0;
        if (wv[q] != kEmpty) {
          if (RES && net != nullptr) nv[q] = __ldcs(net + wv[q]);
          cv[q] = cap_at(wv[q]);
          if (use_mem) mv[q] = mem_cap_at(wv[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        const int k = k0 + q * 32;
        if (wv[q] != kEmpty) {
          finalize(s_var[k], s_met[k], use_mem ? s_mem[k] : 0.0, nv[q], cv[q], mv[q]);
        }
      }
    }
    auto untouched = [&](int w) { return ((s_bits[w >> 5] >> (w & 31)) & 1u) == 0u; };
    if (a.bad != nullptr) {
      const int n_bad = *a.n_bad;
      for (int k = lane; k < n_bad; k += 32) {
        if (untouched(a.bad[k])) infeasible = true;
      }
    } else {
      // A (B, m) operand: every untouched machine, from zero accumulators,
      // its operands loaded eight a lane ahead of the arithmetic, and the
      // next eight machines' net_var (the row's bytes from device memory)
      // eight more ahead.
      constexpr int kAhead = 8;
      double nn[kAhead];
      auto load_net = [&](int base) {
#pragma unroll
        for (int q = 0; q < kAhead; ++q) {
          const int w = base + q * 32 + lane;
          nn[q] = (RES && net != nullptr && w < m) ? __ldcs(net + w) : 0.0;
        }
      };
      load_net(0);
      for (int base = 0; base < m; base += 32 * kAhead) {
        double nv[kAhead], cv[kAhead], mv[kAhead];
#pragma unroll
        for (int q = 0; q < kAhead; ++q) nv[q] = nn[q];
        load_net(base + 32 * kAhead);
#pragma unroll
        for (int q = 0; q < kAhead; ++q) {
          const int w = base + q * 32 + lane;
          const bool in = w < m;
          cv[q] = in ? cap_at(w) : 0.0;
          mv[q] = (use_mem && in) ? mem_cap_at(w) : 0.0;
        }
#pragma unroll
        for (int q = 0; q < kAhead; ++q) {
          const int w = base + q * 32 + lane;
          if (w < m && untouched(w)) finalize(0.0, 0.0, 0.0, nv[q], cv[q], mv[q]);
        }
      }
    }
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

// The TABLE instance's list of the machines that make every row missing
// them infeasible (cap_w < 0, or 0 > mem_cap_w with a memory term), in any
// order: only whether a row misses one counts.
__global__ void list_bad_kernel(Args a, bool use_mem, int* bad, int* n_bad) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= a.m) return;
  if (__dsub_rn(a.cap[w], 0.0) < 0.0 || (use_mem && 0.0 > a.mem_cap[w])) {
    bad[atomicAdd(n_bad, 1)] = w;
  }
}

// The one-block layout (tile_w == m) where a row's accumulators fit a
// block; else the table (slots == table_slots) where it fits a tile's warp;
// else the tiled one at tile_width's width. The wrapper's tile_w and slots
// must be the layout's, as ops.machine_tiles and ops.table_slots give them.
// Whether a (B, m) operand (per-row capacity or memory capacity, net_var)
// takes the table's finalize over every machine of a row.
bool rows_m(const Args& a, bool use_mem) {
  return a.cap_stride != 0 || (use_mem && a.mem_cap_stride != 0) || a.net != nullptr;
}

template <bool RES>
int launch(Args a, bool use_mem, void* scratch, int64_t scratch_bytes, cudaStream_t s) {
  constexpr int kBlockMax = 227 * 1024;
  const bool row_comp = a.comp_stride != 0, row_uir = a.uir_stride != 0;
  const bool wide = warp_smem(a.m, use_mem, row_comp, row_uir) > kBlockMax;
  const int slots = wide ? table_slots(a.T, a.m, use_mem, row_comp, row_uir) : 0;
  const Layout layout = !wide ? kOneBlock : slots > 0 ? kTable : kTiled;
  const int tile_w = layout == kOneBlock ? a.m
                     : layout == kTiled  ? tile_width(use_mem, row_comp, row_uir)
                                         : 0;
  // The scratch the wrapper allocates (ops.scratch_bytes): the table's list
  // of failing machines and its count, or the tiles' partials.
  const int64_t need = layout == kTable   ? (rows_m(a, use_mem) ? 0 : 4 * (a.m + 1LL))
                       : layout == kTiled ? a.B * ((a.m + tile_w - 1) / tile_w) * 12
                                          : 0;
  if (a.tile_w != tile_w || a.slots != slots || scratch_bytes < need ||
      (need > 0 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (layout == kOneBlock) {
    a.warp_bytes = warp_smem(a.m, use_mem, row_comp, row_uir);
    int rows = kRows;
    while (rows > 1 && rows * a.warp_bytes > kBlockMax) rows /= 2;
    const int smem = rows * a.warp_bytes;
    cudaError_t err = cudaFuncSetAttribute(sched_scoring_kernel<RES, kOneBlock>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>((a.B + rows - 1) / rows));
    sched_scoring_kernel<RES, kOneBlock><<<grid, 32 * rows, smem, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (layout == kTable) {
    // A warp a row, kRows a block as in the one-block layout. Without a
    // (B, m) operand, the machines that fail every row missing them go to a
    // list first.
    a.warp_bytes = static_cast<int>(table_bytes(slots, a.m, use_mem, row_comp, row_uir));
    int rows = kRows;
    while (rows > 1 && rows * a.warp_bytes > kBlockMax) rows /= 2;
    const int smem = rows * a.warp_bytes;
    // The most shared memory an SM can hold, so that its blocks fit at once.
    cudaError_t err = cudaFuncSetAttribute(sched_scoring_kernel<RES, kTable>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(sched_scoring_kernel<RES, kTable>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!rows_m(a, use_mem)) {
      int* n_bad = static_cast<int*>(scratch);
      a.n_bad = n_bad;
      a.bad = n_bad + 1;
      err = cudaMemsetAsync(n_bad, 0, sizeof(int), s);
      if (err != cudaSuccess) return static_cast<int>(err);
      list_bad_kernel<<<static_cast<unsigned>((a.m + 255) / 256), 256, 0, s>>>(a, use_mem,
                                                                              n_bad + 1, n_bad);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid(static_cast<unsigned>((a.B + rows - 1) / rows));
    sched_scoring_kernel<RES, kTable><<<grid, 32 * rows, smem, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  // One warp a block: eight blocks share an SM.
  a.n_tiles = (a.m + a.tile_w - 1) / a.tile_w;
  a.warp_bytes = warp_smem(a.tile_w, use_mem, row_comp, row_uir);
  const int64_t pairs = a.B * a.n_tiles;
  if (pairs > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(sched_scoring_kernel<RES, kTiled>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         a.warp_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.part_rate = static_cast<double*>(scratch);
  a.part_bad = reinterpret_cast<int*>(a.part_rate + pairs);
  sched_scoring_kernel<RES, kTiled><<<static_cast<unsigned>(pairs), 32, a.warp_bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_tiles_kernel<<<static_cast<unsigned>((a.B + 255) / 256), 256, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the scorer on `stream` (no synchronisation), `tile_w` machines
// a tile (m for the one-block layout, 0 for the table) and `slots` table
// slots (0 but for the table), with `scratch_bytes` of device scratch at
// `scratch`. Returns a cudaError_t code: 0 on success,
// cudaErrorInvalidValue where `tile_w` or `slots` is not the layout's or
// the scratch is short of it.
extern "C" int sched_scoring_launch(
    int device, const void* tm, const void* comp, long long comp_stride,
    const void* unit_ir, long long uir_stride, const void* e_cm,
    const void* met_cm, const void* cap, long long cap_stride,
    const void* net, const void* mem_c, const void* mem_cap,
    long long mem_cap_stride, void* out, void* scratch, long long scratch_bytes, long long B,
    long long T, int m, int tile_w, int slots, int resources, void* stream) {
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
  a.bad = nullptr;
  a.n_bad = nullptr;
  a.slots = slots;
  a.warp_bytes = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool use_mem = resources && mem_c != nullptr;
  return resources ? launch<true>(a, use_mem, scratch, scratch_bytes, s)
                   : launch<false>(a, use_mem, scratch, scratch_bytes, s);
}
