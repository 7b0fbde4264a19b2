// Cut-traffic load of candidate placements for Hopper (sm_90a).
//
// The (B, m) per-machine cut-traffic CPU load at unit topology rate that
// feeds B2 (sched_scoring_pallas_resources) as `net_var`. It replaces no
// TPU kernel: the reference computes it with NumPy on the host
// (repro/core/cost_model.py::network_unit_load), and the port's plain
// version (../ref.py) with eager ops. For row b, in the plain version's
// order, each product and each sum rounded once:
//   1. per task t of component c on machine w:
//        out_t   = alpha[c] * unit_ir_t
//        rfrac_t = unit_ir_t / max(cir[c], 1e-300), or 0 where cir[c] <= 0
//   2. send[c][w] = sum_t out_t and recv[c][w] = sum_t rfrac_t over the
//      row's tasks of c on w, in task order, for c in srcs (send) and dsts
//      (recv): the K2 "slots" of X[slot][w];
//   3. Y[slot][w] = sum_{v = 0, 1, ..., m-1} distance[w][v] * X[slot][v];
//   4. acc_w = 0; per edge (a, b) in order:
//        acc_w += send[a][w] * recv_d[b][w];  acc_w += recv[b][w] * send_d[a][w]
//   5. net[b][w] = acc_w * penalty.
//
// Bound: operations. Step 3 is a product of (B K2, m) by (m, m) in float64
// -- K2 m^2 multiplies and adds per row, 0.39 MFLOP at K2 = 6, m = 180 --
// against T + m values read and written per row.
//
// Design. A block takes R rows (8, 4, 2 or 1: as many as fit). Step 2 works
// in chunks of TC tasks, whose raw values come by cp.async one chunk ahead:
// all threads prepare the chunk (step 1 and the slots of each task) and
// set one bit per task in its owner's mask; each row's machines
// w = g (mod G) belong to its thread g, which walks the set bits in
// increasing order and adds only its own tasks. So every cell's sum keeps
// the plain version's task order, with no atomics on the sums. Step 3 runs
// on the CUDA cores (the tensor cores' float64 products sum in their own
// order) as a register-tiled product: X sits in shared memory transposed
// (X^T[v][row, slot]), a thread owns 4 rows of X by 2 machines for up to
// PMAX passes, and two tiles of `distance` (up to 16 columns v by all m
// rows w, copied by cp.async while the previous tile is used) serve all
// R K2 rows of X. Each output sums v in increasing order. The block's threads are as
// few as its items need. Where a row's X^T and Y^T (m K2 doubles each) do
// not fit a block's shared memory (many contracted components on many
// machines), they live in a global scratch instead, one pair a resident
// block, and the blocks loop over the rows; the order of every sum is the
// same. The file builds with -fmad=false and spells every
// product and sum with round-to-nearest intrinsics, so the result is the
// plain version's, bit for bit. On the card the product, the mass phase
// and the tile loads each take a comparable share of the time (PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT_MAX = 256;  // threads a block, at most
constexpr int TC = 64;       // tasks a prepared chunk (one bit each in an owner's mask)
constexpr int KT_MAX = 16;   // columns v of `distance` a tile, at most
constexpr int MX = 4;        // rows of X a thread's micro-tile
constexpr int PMAX = 4;      // passes of micro-tiles a thread keeps in registers

struct Args {
  const int32_t* tm;         // (B, T) machine id per task
  const int32_t* comp;       // (T,) or (B, T) component per task
  const double* unit_ir;     // (T,) or (B, T) unit-rate input per task
  const double* alpha;       // (n,) output ratio per component
  const double* cir;         // (n,) unit-rate component input
  const int32_t* send_slot;  // (n,) slot of the component's send mass, or -1
  const int32_t* recv_slot;  // (n,) slot of its receive mass, or -1
  const int32_t* edges;      // (E, 2) (send slot of a, receive slot of b)
  const double* distance;    // (m, m)
  double* out;               // (B, m)
  double* scratch;           // X^T and Y^T of each block [grid][2][mp][qp], or null
  double penalty;
  int64_t B, T, comp_stride, uir_stride;
  int n, m, mp, ld, k2, qp, n_edges, rows, group;
  int kt_log2;   // columns v of `distance` a tile: 1 << kt_log2
  int y_offset;  // where Y^T starts in the region (0: over the tiles)
};

// Shared memory: X^T [mp][qp] (row (r, slot) of X is column r K2 + slot,
// padded to qp, a multiple of MX), then one region used in turn by step 2
// (the owners' task masks [R][group]; the prepared chunk: values
// (out, rfrac) [R][TC], slots [R][TC], machines [R][TC]; the raw chunks,
// two of each: unit_ir (per-row maps), tm, comp (per-row maps), [R][TC]),
// by step 3 (two distance tiles [kt][ld]) and by steps 4-5 (Y^T [mp][qp]).
// Where X^T and Y^T sit: Y^T over the region (kOverlap), Y^T past it, when
// step 3 takes more than one round of items (kYApart), or both in the
// global scratch, the region alone in shared memory (kGlobal).
enum Layout { kOverlap, kYApart, kGlobal };

size_t smem_bytes(const Args& a, int rows, int group, int kt, Layout layout) {
  const int qp = (rows * a.k2 + MX - 1) / MX * MX;
  const size_t raw = sizeof(int32_t) * (1 + (a.comp_stride != 0)) +
                     sizeof(double) * (a.uir_stride != 0);
  const size_t masses = sizeof(unsigned long long) * rows * group +
                        static_cast<size_t>(rows) * TC *
                            (sizeof(double2) + sizeof(int2) + sizeof(int32_t) + 2 * raw);
  const size_t tiles = sizeof(double) * 2 * kt * a.ld;
  const size_t region = masses > tiles ? masses : tiles;
  const size_t xy = sizeof(double) * static_cast<size_t>(a.mp) * qp;  // X^T or Y^T
  if (layout == kGlobal) return region;
  if (layout == kYApart) return xy + region + xy;
  return xy + (region > xy ? region : xy);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(BYTES));
}

// XY_GLOBAL: X^T and Y^T in the global scratch (a separate instance, so
// that the shared-memory one addresses them as shared memory).
template <bool XY_GLOBAL>
__global__ void __launch_bounds__(NT_MAX) cut_traffic_kernel(Args a) {
  extern __shared__ __align__(16) double smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int R = a.rows, K2 = a.k2, m = a.m, mp = a.mp, ld = a.ld, qp = a.qp, G = a.group;
  double* XT = XY_GLOBAL ? a.scratch + static_cast<size_t>(blockIdx.x) * 2 * mp * qp : smem;
  double* region = XY_GLOBAL ? smem : XT + static_cast<size_t>(mp) * qp;
  unsigned long long* s_mask = reinterpret_cast<unsigned long long*>(region);
  const bool row_comp = a.comp_stride != 0, row_uir = a.uir_stride != 0;
  double2* p_val = reinterpret_cast<double2*>(s_mask + R * G);
  double* raw_uir = reinterpret_cast<double*>(p_val + R * TC);  // [2][R TC]
  int2* p_slot = reinterpret_cast<int2*>(raw_uir + (row_uir ? 2 * R * TC : 0));
  int32_t* p_w = reinterpret_cast<int32_t*>(p_slot + R * TC);
  int32_t* raw_tm = p_w + R * TC;      // [2][R TC]
  int32_t* raw_comp = raw_tm + 2 * R * TC;
  double* D = region;  // [2][kt][ld]
  double* YT = XY_GLOBAL ? XT + static_cast<size_t>(mp) * qp : region + a.y_offset;  // [mp][qp]
  int64_t b0 = 0;      // the block's first row, R rows a group

  // Steps 1-2: masses. Row r's machines w = g (mod G) belong to its thread
  // g (threads r G + g, r < R; G a power of two). The rows' raw chunks come
  // by cp.async one chunk ahead; a chunk is prepared by all threads (step
  // 1, and a bit in the owner's mask per task), then each owner adds its
  // own tasks in increasing order.
  auto stage = [&](int k, int64_t t0) {
    const int count = static_cast<int>(a.T - t0 < TC ? a.T - t0 : TC);
    for (int i = tid; i < R * TC; i += nt) {
      const int r = i / TC, j = i - r * TC;
      const int64_t b = b0 + r, t = t0 + j;
      if (j >= count || b >= a.B) continue;
      cp_async<4>(raw_tm + k * R * TC + i, a.tm + b * a.T + t);
      if (row_comp) cp_async<4>(raw_comp + k * R * TC + i, a.comp + b * a.T + t);
      if (row_uir) cp_async<8>(raw_uir + k * R * TC + i, a.unit_ir + b * a.T + t);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  const int n_wp = mp / 2;
  const int n_items = (qp / MX) * n_wp;
  const int KT = 1 << a.kt_log2;
  const int n_kt = (m + KT - 1) / KT;
  // Tile t of distance, transposed: D[v][w] = distance[w][t KT + v], by
  // 8-byte async copies (coalesced reads of KT consecutive v a row w).
  auto load_tile = [&](int t) {
    const int v0 = t * KT, kc = m - v0 < KT ? m - v0 : KT;
    double* Dt = D + (t & 1) * KT * ld;
    for (int i = tid; i < m * KT; i += nt) {
      const int w = i >> a.kt_log2, v = i & (KT - 1);
      if (v < kc) cp_async<8>(Dt + v * ld + w, a.distance + static_cast<int64_t>(w) * m + v0 + v);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // A block takes groups of R rows, blockIdx.x first; with X^T and Y^T in
  // shared memory the grid covers the rows and each block takes one group.
  for (int64_t grp = blockIdx.x; grp * R < a.B; grp += gridDim.x) {
    b0 = grp * R;
    for (int i = tid; i < mp * qp; i += nt) XT[i] = 0.0;
    for (int i = tid; i < R * G; i += nt) s_mask[i] = 0ull;

    if (a.T > 0) stage(0, 0);
    for (int64_t t0 = 0; t0 < a.T; t0 += TC) {
      const int count = static_cast<int>(a.T - t0 < TC ? a.T - t0 : TC);
      const int k = static_cast<int>((t0 / TC) & 1);
      if (t0 + TC < a.T) {
        stage(k ^ 1, t0 + TC);  // into the buffers read two chunks ago
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncthreads();  // this chunk landed; X zeroed / the previous chunk consumed
      for (int i = tid; i < R * TC; i += nt) {
        const int r = i / TC, j = i - r * TC;
        const int64_t b = b0 + r, t = t0 + j;
        if (j >= count || b >= a.B) continue;
        const int w = raw_tm[k * R * TC + i];
        const int c = row_comp ? raw_comp[k * R * TC + i] : __ldg(a.comp + t);
        if (static_cast<unsigned>(w) >= static_cast<unsigned>(m) ||
            static_cast<unsigned>(c) >= static_cast<unsigned>(a.n)) {
          continue;  // matches no machine, or no component
        }
        const int2 slot = make_int2(__ldg(a.send_slot + c), __ldg(a.recv_slot + c));
        if (slot.x < 0 && slot.y < 0) continue;  // sends and receives nothing
        const double u = row_uir ? raw_uir[k * R * TC + i] : __ldg(a.unit_ir + t);
        const double cir = __ldg(a.cir + c);
        p_w[i] = w;
        p_slot[i] = slot;
        p_val[i] = make_double2(__dmul_rn(__ldg(a.alpha + c), u),
                                cir > 0.0 ? __ddiv_rn(u, fmax(cir, 1e-300)) : 0.0);
        atomicOr(s_mask + r * G + (w & (G - 1)), 1ull << j);
      }
      __syncthreads();
      if (tid < R * G) {
        unsigned long long own = s_mask[tid];
        s_mask[tid] = 0ull;
        const int r = tid / G;
        while (own != 0ull) {
          const int i = r * TC + __ffsll(static_cast<long long>(own)) - 1;
          own &= own - 1ull;
          double* x = XT + static_cast<size_t>(p_w[i]) * qp + r * K2;
          const int2 slot = p_slot[i];
          const double2 val = p_val[i];
          if (slot.x >= 0) x[slot.x] = __dadd_rn(x[slot.x], val.x);
          if (slot.y >= 0) x[slot.y] = __dadd_rn(x[slot.y], val.y);
        }
      }
    }

    // Step 3: Y = X . distance^T, v in increasing order. An item is MX rows
    // of X (from q0) by 2 machines (from w0); a round gives a thread the
    // items i0 + tid + p nt, p < PMAX (one round unless X is very large).
    for (int i0 = 0; i0 < n_items; i0 += PMAX * nt) {
      int q0[PMAX], w0[PMAX];
      bool own[PMAX];
      double acc[PMAX][MX][2];
#pragma unroll
      for (int p = 0; p < PMAX; ++p) {
        const int item = i0 + tid + p * nt;
        own[p] = item < n_items;
        q0[p] = (item / n_wp) * MX;
        w0[p] = (item % n_wp) * 2;
#pragma unroll
        for (int k = 0; k < MX; ++k) acc[p][k][0] = acc[p][k][1] = 0.0;
      }
      __syncthreads();  // masses written; the region's step-2 data / last round's tiles consumed
      load_tile(0);
      for (int t = 0; t < n_kt; ++t) {
        if (t + 1 < n_kt) {
          load_tile(t + 1);
          asm volatile("cp.async.wait_group 1;\n" ::);
        } else {
          asm volatile("cp.async.wait_group 0;\n" ::);
        }
        __syncthreads();
        const int v0 = t * KT, kc = m - v0 < KT ? m - v0 : KT;
        const double* Dt = D + (t & 1) * KT * ld;
        for (int v = 0; v < kc; ++v) {
          const double* xv = XT + static_cast<size_t>(v0 + v) * qp;
          const double* dv = Dt + v * ld;
#pragma unroll
          for (int p = 0; p < PMAX; ++p) {
            if (own[p]) {
              const double2 x01 = *reinterpret_cast<const double2*>(xv + q0[p]);
              const double2 x23 = *reinterpret_cast<const double2*>(xv + q0[p] + 2);
              // machine mp - 1 past m (m odd) reads a slot no copy filled; its
              // sums land in Y^T's padding, never read
              const double2 d = *reinterpret_cast<const double2*>(dv + w0[p]);
              const double x[MX] = {x01.x, x01.y, x23.x, x23.y};
#pragma unroll
              for (int k = 0; k < MX; ++k) {
                acc[p][k][0] = __dadd_rn(acc[p][k][0], __dmul_rn(x[k], d.x));
                acc[p][k][1] = __dadd_rn(acc[p][k][1], __dmul_rn(x[k], d.y));
              }
            }
          }
        }
        __syncthreads();  // tile t consumed before its buffer is refilled / Y^T written
      }
#pragma unroll
      for (int p = 0; p < PMAX; ++p) {
        if (own[p]) {
#pragma unroll
          for (int k = 0; k < MX; ++k) {
            YT[static_cast<size_t>(w0[p]) * qp + q0[p] + k] = acc[p][k][0];
            YT[static_cast<size_t>(w0[p] + 1) * qp + q0[p] + k] = acc[p][k][1];
          }
        }
      }
    }
    __syncthreads();

    // Steps 4-5: the edges in order, then the penalty; coalesced stores.
    for (int i = tid; i < R * m; i += nt) {
      const int r = i / m, w = i - r * m;
      const int64_t b = b0 + r;
      if (b >= a.B) break;
      const double* x = XT + static_cast<size_t>(w) * qp + r * K2;
      const double* y = YT + static_cast<size_t>(w) * qp + r * K2;
      double acc_w = 0.0;
      for (int e = 0; e < a.n_edges; ++e) {
        const int sa = __ldg(a.edges + 2 * e), rb = __ldg(a.edges + 2 * e + 1);
        acc_w = __dadd_rn(acc_w, __dmul_rn(x[sa], y[rb]));
        acc_w = __dadd_rn(acc_w, __dmul_rn(x[rb], y[sa]));
      }
      a.out[b * m + w] = __dmul_rn(acc_w, a.penalty);
    }
    __syncthreads();  // X^T and Y^T read before the next group's zeroing
  }
}

}  // namespace

// Launches the kernel on `stream` (no synchronisation). `send_slot` /
// `recv_slot` map each of the n components to its row of X (srcs first, in
// increasing order, then dsts; -1 where it has none), `edges` holds the
// (send slot of a, receive slot of b) of each edge in order, `k2` is the
// number of slots. Returns a cudaError_t code: 0 on success.
extern "C" int cut_traffic_launch(
    int device, const void* tm, const void* comp, long long comp_stride, const void* unit_ir,
    long long uir_stride, const void* alpha, const void* cir, const void* send_slot,
    const void* recv_slot, const void* edges, int n_edges, int k2, const void* distance,
    double penalty, void* out, long long B, long long T, int n, int m, void* stream) {
  if (B <= 0) return 0;
  if (m <= 0 || k2 < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.tm = static_cast<const int32_t*>(tm);
  a.comp = static_cast<const int32_t*>(comp);
  a.unit_ir = static_cast<const double*>(unit_ir);
  a.alpha = static_cast<const double*>(alpha);
  a.cir = static_cast<const double*>(cir);
  a.send_slot = static_cast<const int32_t*>(send_slot);
  a.recv_slot = static_cast<const int32_t*>(recv_slot);
  a.edges = static_cast<const int32_t*>(edges);
  a.distance = static_cast<const double*>(distance);
  a.out = static_cast<double*>(out);
  a.penalty = penalty;
  a.B = B;
  a.T = T;
  a.comp_stride = comp_stride;
  a.uir_stride = uir_stride;
  a.n = n;
  a.m = m;
  a.mp = (m + 1) / 2 * 2;                       // even, for the double2 tile reads
  a.ld = a.mp % 4 == 0 ? a.mp + 2 : a.mp;       // tile rows 2 (mod 4) doubles apart
  a.k2 = k2;
  a.n_edges = n_edges;
  // The most rows (8, 4, 2 or 1) whose micro-tiles fit one round of PMAX
  // passes of NT_MAX threads and whose shared memory lets two blocks share
  // an SM; then the fewest threads for those passes. A product too large
  // for one round at one row takes several, with Y^T past the tiles, and
  // narrower tiles where the shared memory needs them. Where X^T and Y^T do
  // not fit even so, they go to a global scratch (one row a block, the
  // blocks resident at once looping over the rows), and shared memory
  // holds the mass phase's chunks and the tiles, down to one column.
  constexpr size_t kBlockMax = 227 * 1024;
  auto items = [&](int r) { return ((r * k2 + MX - 1) / MX) * (a.mp / 2); };
  auto group = [&](int r, int threads) {  // owners a row: a power of two, r g <= threads
    int g = 1;
    while (2 * g * r <= threads) g *= 2;
    return g;
  };
  int rows = 8, kt = KT_MAX;
  while (rows > 1 && (items(rows) > NT_MAX * PMAX ||
                      2 * smem_bytes(a, rows, group(rows, NT_MAX), kt, kOverlap) > kBlockMax)) {
    rows /= 2;
  }
  Layout layout = items(rows) > NT_MAX * PMAX ? kYApart : kOverlap;
  while (kt > 2 && smem_bytes(a, rows, group(rows, NT_MAX), kt, layout) > kBlockMax) kt /= 2;
  if (smem_bytes(a, rows, group(rows, NT_MAX), kt, layout) > kBlockMax) {
    layout = kGlobal;
    rows = 1;
    kt = KT_MAX;
    while (kt > 1 && smem_bytes(a, 1, group(1, NT_MAX), kt, kGlobal) > kBlockMax) kt /= 2;
  }
  int nt = NT_MAX;
  if (layout == kOverlap) {
    const int passes = (items(rows) + NT_MAX - 1) / NT_MAX;
    nt = (items(rows) + passes - 1) / passes;
    nt = nt < 32 ? 32 : (nt + 31) / 32 * 32;
  }
  a.rows = rows;
  a.kt_log2 = 0;
  while ((1 << a.kt_log2) < kt) ++a.kt_log2;
  a.group = group(rows, nt);
  a.qp = (rows * k2 + MX - 1) / MX * MX;
  const size_t smem = smem_bytes(a, rows, a.group, kt, layout);
  // Two one-column tiles of `distance` past a block's shared memory: m > 14 500
  // (ops.MAX_MACHINES).
  if (smem > kBlockMax) return static_cast<int>(cudaErrorInvalidValue);
  const size_t xy = sizeof(double) * a.mp * a.qp;
  a.y_offset = layout == kYApart ? static_cast<int>((smem - 2 * xy) / sizeof(double)) : 0;
  a.scratch = nullptr;
  void (*kernel)(Args) =
      layout == kGlobal ? cut_traffic_kernel<true> : cut_traffic_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t blocks = (B + rows - 1) / rows;
  if (layout == kGlobal) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, nt, smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
    if (blocks > resident) blocks = resident;
    void* scratch = nullptr;
    err = cudaMallocAsync(&scratch, static_cast<size_t>(blocks) * 2 * xy, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    a.scratch = static_cast<double*>(scratch);
  }
  kernel<<<dim3(static_cast<unsigned>(blocks)), nt, smem, s>>>(a);
  err = cudaGetLastError();
  if (a.scratch != nullptr) {
    const cudaError_t freed = cudaFreeAsync(a.scratch, s);  // after the kernel, in stream order
    if (err == cudaSuccess) err = freed;
  }
  return static_cast<int>(err);
}
