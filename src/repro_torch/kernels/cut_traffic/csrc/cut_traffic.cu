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
// against T + m values read and written per row. The bits rule (below)
// forbids FMA, so a product and a sum are two FP64 instructions and the
// FP64 pipe's ceiling is half its peak FLOP rate.
//
// Design. A block takes R rows (8, 4, 2 or 1: as many as fit; 4 at the
// resource refine's sweep). Step 2 runs on up to 4 warps a row, each
// taking the machines of one residue of w / 32, in chunks of 32 tasks (one
// a lane, step 1 on the lane, the next chunk's operands loading
// meanwhile): lane L owns the machines w = L (mod 32); each lane learns
// which of the chunk's tasks are its own (a bit each, set by shared-memory
// atomicOr into a per-warp staging area) and adds them in increasing
// order. So every cell's sum keeps the plain version's task order, with no
// atomics on the sums and no block barrier in the mass phase. Step 3 runs
// on the CUDA cores (the tensor cores' float64 products sum in their own
// order) as a register-tiled product: X sits in shared memory transposed
// (X^T[v][row, slot]); a thread owns 6 rows of X by 4 machines (24 sums:
// three 16-byte loads of X^T and two of `distance` for 48 FP64
// instructions), a warp 2 x 16 such tiles, so that its loads of a column
// are 2 broadcast runs of X^T and two contiguous runs of `distance`. A
// ring of three tiles of `distance` (up to 8 columns v by all m rows w,
// copied by cp.async two tiles ahead, one block barrier a tile) serves all
// R K2 rows of X; each output sums v in increasing order. The block's
// threads are as few as its warp tiles need, and three blocks share an SM,
// so one block's mass phase overlaps the others' products. Where a row's
// X^T and Y^T (m K2 doubles each) do not fit a block's shared memory (many
// contracted components on many machines), they live in a global scratch
// instead, one pair a resident block, and the blocks loop over the rows;
// the order of every sum is the same. The file builds with -fmad=false and
// spells every product and sum with round-to-nearest intrinsics, so the
// result is the plain version's, bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT_MAX = 288;  // threads a block, at most
constexpr int KT_MAX = 8;    // columns v of `distance` a tile, at most
constexpr int MQ = 6;        // rows of X a thread's micro-tile (K2 at the linear topology)
constexpr int MW = 4;        // machines a thread's micro-tile
constexpr int WQ = 2;        // a warp's micro-tiles: WQ along X's rows
constexpr int WW = 32 / WQ;  // by WW along the machines

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
  int n, m, mp, ld, k2, qp, n_edges, rows;
  int kt_log2;   // columns v of `distance` a tile: 1 << kt_log2
  int stages;    // tiles in flight: 3, or 2 at the largest m
  int y_offset;  // where Y^T starts in the region (0: over the tiles)
};

// A warp's staged chunk of the mass phase: each lane's task (machine or -1,
// its two slots, its two values) and each lane's mask of the tasks it owns.
struct Staged {
  double2 val[32];
  int2 slot[32];
  int w[32];
  unsigned own[32];
};

// Shared memory: X^T [mp][qp] (row (r, slot) of X is column r K2 + slot,
// padded to qp, a multiple of MQ), then one region used in turn by step 2
// (a Staged per warp), by step 3 (two distance tiles [kt][ld]) and by
// steps 4-5 (Y^T [mp][qp]). Where X^T and Y^T sit: Y^T over the region
// (kOverlap), Y^T past it, when step 3 takes more than one round of items
// (kYApart), or both in the global scratch, the region alone in shared
// memory (kGlobal).
enum Layout { kOverlap, kYApart, kGlobal };

size_t smem_bytes(const Args& a, int rows, int threads, int kt, Layout layout, int stages) {
  const int qp = (rows * a.k2 + MQ - 1) / MQ * MQ;
  const size_t masses = sizeof(Staged) * (threads / 32);
  const size_t tiles = sizeof(double) * stages * kt * a.ld;
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
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int R = a.rows, K2 = a.k2, m = a.m, mp = a.mp, ld = a.ld, qp = a.qp;
  double* XT = XY_GLOBAL ? a.scratch + static_cast<size_t>(blockIdx.x) * 2 * mp * qp : smem;
  double* region = XY_GLOBAL ? smem : XT + static_cast<size_t>(mp) * qp;
  Staged& st = reinterpret_cast<Staged*>(region)[warp];
  double* D = region;  // [stages][kt][ld]
  double* YT = XY_GLOBAL ? XT + static_cast<size_t>(mp) * qp : region + a.y_offset;  // [mp][qp]

  const int n_qt = qp / MQ, n_ww = mp / (MW * WW);
  const int n_tiles = (n_qt + WQ - 1) / WQ * n_ww;  // warp tiles of WQ x WW micro-tiles
  const int n_warps = nt >> 5;
  const int KT = 1 << a.kt_log2;
  const int n_kt = (m + KT - 1) / KT;
  // Tile t of distance, transposed: D[v][w] = distance[w][t KT + v], by
  // 8-byte async copies (coalesced reads of KT consecutive v a row w).
  auto load_tile = [&](int t) {
    const int v0 = t * KT, kc = m - v0 < KT ? m - v0 : KT;
    double* Dt = D + (t % a.stages) * KT * ld;
    for (int i = tid; i < m * KT; i += nt) {
      const int w = i >> a.kt_log2, v = i & (KT - 1);
      if (v < kc) cp_async<8>(Dt + v * ld + w, a.distance + static_cast<int64_t>(w) * m + v0 + v);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // A block takes groups of R rows, blockIdx.x first; with X^T and Y^T in
  // shared memory the grid covers the rows and each block takes one group.
  for (int64_t grp = blockIdx.x; grp * R < a.B; grp += gridDim.x) {
    const int64_t b0 = grp * R;
    for (int i = tid; i < mp * qp; i += nt) XT[i] = 0.0;
    __syncthreads();

    // Steps 1-2: masses. Warp (r, h) takes row r and the machines w with
    // (w / 32) mod ns = h, where ns warps share a row (as many, up to 4, as
    // the block's warps allow); its lane L owns those with w mod 32 = L and
    // adds the chunk's tasks on them in increasing order, so each cell sums
    // its tasks in task order. The next chunk's operands load meanwhile.
    int ns = 1;
    while (ns < 4 && 2 * ns * R <= n_warps) ns *= 2;
    for (int job = warp; job < R * ns && b0 + job / ns < a.B; job += n_warps) {
      const int r = job / ns, h = job % ns;
      const int64_t b = b0 + r;
      const int32_t* tm_b = a.tm + b * a.T;
      const int32_t* comp_b = a.comp + b * a.comp_stride;
      const double* uir_b = a.unit_ir + b * a.uir_stride;
      double* x_r = XT + r * K2;
      int w_next = -1, c_next = -1;
      double u_next = 0.0;
      auto fetch = [&](int64_t t) {
        w_next = -1;
        if (t < a.T) {
          w_next = __ldg(tm_b + t);
          c_next = __ldg(comp_b + t);
          u_next = __ldg(uir_b + t);
        }
      };
      fetch(lane);
      for (int64_t t0 = 0; t0 < a.T; t0 += 32) {
        int w = w_next;
        const int c = c_next;
        const double u = u_next;
        fetch(t0 + 32 + lane);
        int2 slot = make_int2(-1, -1);
        double2 val = make_double2(0.0, 0.0);
        if (static_cast<unsigned>(w) < static_cast<unsigned>(m) && (w >> 5) % ns == h &&
            static_cast<unsigned>(c) < static_cast<unsigned>(a.n)) {
          slot = make_int2(__ldg(a.send_slot + c), __ldg(a.recv_slot + c));
          const double cir = __ldg(a.cir + c);
          val = make_double2(__dmul_rn(__ldg(a.alpha + c), u),
                             cir > 0.0 ? __ddiv_rn(u, fmax(cir, 1e-300)) : 0.0);
        }
        // No machine of this warp's, or sends and receives nothing.
        if (slot.x < 0 && slot.y < 0) w = -1;
        __syncwarp();  // the previous chunk's staged tasks consumed
        st.w[lane] = w;
        st.slot[lane] = slot;
        st.val[lane] = val;
        st.own[lane] = 0u;
        __syncwarp();
        if (w >= 0) atomicOr(&st.own[w & 31], 1u << lane);
        __syncwarp();
        for (unsigned own = st.own[lane]; own != 0u; own &= own - 1u) {
          const int j = __ffs(own) - 1;
          double* x = x_r + static_cast<size_t>(st.w[j]) * qp;
          const int2 sl = st.slot[j];
          const double2 v = st.val[j];
          if (sl.x >= 0) x[sl.x] = __dadd_rn(x[sl.x], v.x);
          if (sl.y >= 0) x[sl.y] = __dadd_rn(x[sl.y], v.y);
        }
      }
    }

    // Step 3: Y = X . distance^T, v in increasing order. A micro-tile is MQ
    // rows of X (q0 ..) by MW machines (w0, w0 + 1, w0 + 2 WW, w0 + 2 WW +
    // 1); a warp takes a tile of WQ x WW of them, 4 WW machines wide, so a
    // warp's loads of a column v read WQ runs of MQ doubles of X^T and two
    // runs of 2 WW consecutive machines of the distance tile. Round i0 gives warp k
    // the warp tile i0 + k (one round unless X is very large).
    for (int i0 = 0; i0 < n_tiles; i0 += n_warps) {
      const int tile = i0 + warp;
      const int qt = tile / n_ww * WQ + lane / WW;
      const bool own = tile < n_tiles && qt < n_qt;
      const int q0 = qt * MQ, w0 = tile % n_ww * MW * WW + 2 * (lane % WW);
      double acc[MQ][MW];
#pragma unroll
      for (int k = 0; k < MQ; ++k)
#pragma unroll
        for (int j = 0; j < MW; ++j) acc[k][j] = 0.0;
      __syncthreads();  // masses written; the region's staging / last round's tiles consumed
      // A ring of `stages` tiles: tiles t + 1 .. t + stages - 2 load while
      // tile t is used.
      for (int t = 0; t + 1 < a.stages && t < n_kt; ++t) load_tile(t);
      for (int t = 0; t < n_kt; ++t) {
        if (a.stages == 3 && t + 1 < n_kt) {
          asm volatile("cp.async.wait_group 1;\n" ::);
        } else {
          asm volatile("cp.async.wait_group 0;\n" ::);
        }
        // Tile t landed for all; tile t - 1 consumed, so its buffer takes
        // tile t + stages - 1.
        __syncthreads();
        if (t + a.stages - 1 < n_kt) load_tile(t + a.stages - 1);
        const int v0 = t * KT, kc = m - v0 < KT ? m - v0 : KT;
        const double* Dt = D + (t % a.stages) * KT * ld;
        if (!own) continue;
        for (int v = 0; v < kc; ++v) {
          const double* xv = XT + static_cast<size_t>(v0 + v) * qp;
          const double* dv = Dt + v * ld;
          const double2 x01 = *reinterpret_cast<const double2*>(xv + q0);
          const double2 x23 = *reinterpret_cast<const double2*>(xv + q0 + 2);
          const double2 x45 = *reinterpret_cast<const double2*>(xv + q0 + 4);
          // machines past m read slots no copy filled; their sums land in
          // Y^T's padding, never read
          const double2 d01 = *reinterpret_cast<const double2*>(dv + w0);
          const double2 d23 = *reinterpret_cast<const double2*>(dv + w0 + 2 * WW);
          const double x[MQ] = {x01.x, x01.y, x23.x, x23.y, x45.x, x45.y};
          const double d[MW] = {d01.x, d01.y, d23.x, d23.y};
#pragma unroll
          for (int k = 0; k < MQ; ++k)
#pragma unroll
            for (int j = 0; j < MW; ++j) acc[k][j] = __dadd_rn(acc[k][j], __dmul_rn(x[k], d[j]));
        }
      }
      __syncthreads();  // the last tiles consumed before Y^T is written over them
      if (own) {
#pragma unroll
        for (int j = 0; j < MW; ++j) {
          double* y = YT + static_cast<size_t>(w0 + (j & 1) + (j >> 1) * 2 * WW) * qp + q0;
          *reinterpret_cast<double2*>(y) = make_double2(acc[0][j], acc[1][j]);
          *reinterpret_cast<double2*>(y + 2) = make_double2(acc[2][j], acc[3][j]);
          *reinterpret_cast<double2*>(y + 4) = make_double2(acc[4][j], acc[5][j]);
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

// The launch's shape: rows a group, threads, shared memory, layout, tiles,
// and the grid (with the global scratch: the blocks resident at once).
struct Plan {
  int rows, threads, kt, per_sm;
  Layout layout;
  size_t smem;
  int64_t blocks;
};

// The most rows (8, 4, 2 or 1) whose warp tiles fit one round of NT_MAX
// threads and whose shared memory lets two blocks share an SM; then one
// warp a warp tile. A product too large for one round at one row takes
// several, with Y^T past the tiles, and
// narrower tiles where the shared memory needs them. Where X^T and Y^T do
// not fit even so, they go to a global scratch (one row a block, the
// blocks resident at once looping over the rows), and shared memory holds
// the staging and the tiles, down to one column. Fills a's derived fields.
cudaError_t plan_launch(Args& a, int device, Plan& pl) {
  constexpr size_t kBlockMax = 227 * 1024;
  a.mp = (a.m + MW * WW - 1) / (MW * WW) * (MW * WW);  // whole warp tiles of machines
  a.ld = a.mp + 2;                                    // tile rows 2 (mod 4) doubles apart
  const int k2 = a.k2;
  auto items = [&](int r) {  // lanes of the warp tiles
    const int n_qt = (r * k2 + MQ - 1) / MQ;
    return 32 * ((n_qt + WQ - 1) / WQ) * (a.mp / (MW * WW));
  };
  int rows = 8, kt = KT_MAX, stages = 3;
  while (rows > 1 && (items(rows) > NT_MAX ||
                      2 * smem_bytes(a, rows, NT_MAX, kt, kOverlap, stages) > kBlockMax)) {
    rows /= 2;
  }
  Layout layout = items(rows) > NT_MAX ? kYApart : kOverlap;
  while (kt > 2 && smem_bytes(a, rows, NT_MAX, kt, layout, stages) > kBlockMax) kt /= 2;
  if (smem_bytes(a, rows, NT_MAX, kt, layout, stages) > kBlockMax) {
    layout = kGlobal;
    rows = 1;
    kt = KT_MAX;
    while (kt > 1 && smem_bytes(a, 1, NT_MAX, kt, kGlobal, stages) > kBlockMax) kt /= 2;
    // At the largest m (ops.MAX_MACHINES) one-column tiles fit only two at
    // a time, with unpadded rows.
    if (smem_bytes(a, 1, NT_MAX, kt, kGlobal, stages) > kBlockMax) stages = 2;
    if (smem_bytes(a, 1, NT_MAX, kt, kGlobal, stages) > kBlockMax) a.ld = a.mp;
  }
  const int nt = layout == kOverlap ? items(rows) : NT_MAX;
  a.rows = rows;
  a.stages = stages;
  a.kt_log2 = 0;
  while ((1 << a.kt_log2) < kt) ++a.kt_log2;
  a.qp = (rows * k2 + MQ - 1) / MQ * MQ;
  pl.rows = rows;
  pl.threads = nt;
  pl.kt = kt;
  pl.layout = layout;
  pl.smem = smem_bytes(a, rows, nt, kt, layout, stages);
  // Two one-column tiles of `distance` past a block's shared memory: m > 14 528
  // (ops.MAX_MACHINES is 14 500).
  if (pl.smem > kBlockMax) return cudaErrorInvalidValue;
  const size_t xy = sizeof(double) * a.mp * a.qp;
  a.y_offset = layout == kYApart ? static_cast<int>((pl.smem - 2 * xy) / sizeof(double)) : 0;
  void (*kernel)(Args) =
      layout == kGlobal ? cut_traffic_kernel<true> : cut_traffic_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(pl.smem));
  int sms = 0;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&pl.per_sm, kernel, nt, pl.smem);
  }
  if (err != cudaSuccess) return err;
  pl.blocks = (a.B + rows - 1) / rows;
  const int64_t resident = static_cast<int64_t>(sms) * (pl.per_sm > 0 ? pl.per_sm : 1);
  if (layout == kGlobal && pl.blocks > resident) pl.blocks = resident;
  return cudaSuccess;
}

}  // namespace

// The launch that cut_traffic_launch makes for B rows of T tasks, k2 slots
// and m machines, into out[0..9]: rows a block, threads a block, shared
// bytes a block, layout (0 shared, 1 Y^T apart, 2 global scratch), columns
// a distance tile, tiles in flight, blocks, resident blocks a SM, and the
// registers and local (spilled) bytes a thread. Returns a cudaError_t
// code: 0 on success.
extern "C" int cut_traffic_plan(int device, long long B, long long T, int k2, int m,
                                long long* out) {
  if (B <= 0 || m <= 0 || k2 < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{};
  a.B = B;
  a.T = T;
  a.k2 = k2;
  a.m = m;
  Plan pl;
  err = plan_launch(a, device, pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(
      &attr, pl.layout == kGlobal ? cut_traffic_kernel<true> : cut_traffic_kernel<false>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long vals[10] = {pl.rows, pl.threads, static_cast<long long>(pl.smem),
                              static_cast<long long>(pl.layout), pl.kt, a.stages, pl.blocks,
                              pl.per_sm, attr.numRegs,
                              static_cast<long long>(attr.localSizeBytes)};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return 0;
}

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
  Args a{};
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
  a.k2 = k2;
  a.n_edges = n_edges;
  Plan pl;
  err = plan_launch(a, device, pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  a.scratch = nullptr;
  if (pl.layout == kGlobal) {
    void* scratch = nullptr;
    err = cudaMallocAsync(&scratch, static_cast<size_t>(pl.blocks) * 2 * sizeof(double) * a.mp *
                                        a.qp, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    a.scratch = static_cast<double*>(scratch);
  }
  void (*kernel)(Args) =
      pl.layout == kGlobal ? cut_traffic_kernel<true> : cut_traffic_kernel<false>;
  kernel<<<dim3(static_cast<unsigned>(pl.blocks)), pl.threads, pl.smem, s>>>(a);
  err = cudaGetLastError();
  if (a.scratch != nullptr) {
    const cudaError_t freed = cudaFreeAsync(a.scratch, s);  // after the kernel, in stream order
    if (err == cudaSuccess) err = freed;
  }
  return static_cast<int>(err);
}
