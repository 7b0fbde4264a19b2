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
// Bound: operations. Step 3 is a product of (B K2, m) by (m, m) in float64,
// but a row of X is non-zero only on the machines that hold its
// component's tasks, so the needed work is m products and m sums per
// non-zero (row, slot, machine). The bits rule (below) forbids FMA, so a
// product and a sum are two FP64 instructions and the FP64 pipe's ceiling
// is half its peak FLOP rate.
//
// Two designs, picked by plan_launch from m and K2 alone.
//
// One block (kOverlap, kYApart: up to ops.one_block's limit, 1 600 machines
// at K2 = 6). A block takes R rows (8, 4, 2 or 1: as many as fit). Step 2
// runs on up to 4 warps a row (row_masses). Step 3 runs on the CUDA cores
// (the tensor cores' float64 products sum in their own order) as a
// register-tiled product: X sits in shared memory transposed (X^T[v][row,
// slot]); a thread owns 6 rows of X by 4 machines, a warp 2 x 16 such
// tiles. A ring of three tiles of `distance` (up to 8 columns v by all m
// rows w, copied by cp.async two tiles ahead, one block barrier a tile)
// serves all R K2 rows of X; each output sums v in increasing order. Y^T
// lies over the ring (kOverlap) or, when step 3 takes more than one round of
// warp tiles, past it (kYApart).
//
// Lists (kLists: past that, where X^T and Y^T leave shared memory). The
// rows go in waves of ops.list_wave's rows, through a scratch the wrapper
// allocates (the masses X and contractions Y of the wave's rows, the
// lists), each wave in five kernels:
//   a. list_masses_kernel: steps 1-2, a block a row (row_masses, 4 warps),
//      into X[row][slot][w]; each task also sets its machine's bit in its
//      component's bitmap of the row's group of GROUP_ROWS rows. The bit
//      marks occupancy, not value: a mass that sums to zero is listed.
//   b. list_columns_kernel: a block a (list, group) compacts the bitmap,
//      OR the columns of `distance` that hold an inf or a NaN (found once a
//      call by nonfinite_columns_kernel), into the sorted list of its
//      columns v by a prefix popcount.
//   c. list_product_kernel: step 3. A list is a contracted component, with
//      its NS slots (send and receive, or one of them); a block takes
//      (group, w tile of LT_W machines, list) and walks the list in
//      increasing v, LT_K columns at a time: the group's X at those columns
//      (GROUP_ROWS x NS values) and distance[w][v_k] for its machines, in a
//      ring of LT_STAGES cp.async stages. A thread owns 4 rows x NS slots x
//      4 machines; each Y[slot][w] sums the listed v in increasing order.
//      The blocks of one (tile, list) are adjacent on the grid (groups
//      first), so they share each distance tile through the L2.
//   d. list_edges_kernel: steps 4-5 a (row, w), from X and Y.
// Skipping column v is exact: an unlisted v has X[slot][v] = +0 for every
// row of the group and a finite distance[w][v], so its product is +-0,
// and an accumulator that starts at +0 is never -0 under round-to-nearest,
// so acc + (+-0) == acc. The columns with a non-finite entry are listed
// for every group, so 0 x inf gives the plain version's NaN.
//
// The file builds with -fmad=false and spells every product and sum with
// round-to-nearest intrinsics, so the result is the plain version's, bit
// for bit, in every layout.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT_MAX = 288;  // threads a block, at most
constexpr int KT_MAX = 8;    // columns v of `distance` a tile, at most
constexpr int MQ = 6;        // rows of X a thread's micro-tile (K2 at the linear topology)
constexpr int MW = 4;        // machines a thread's micro-tile
constexpr int WQ = 2;        // a warp's micro-tiles: WQ along X's rows
constexpr int WW = 32 / WQ;  // by WW along the machines

// The list layout (ops.GROUP_ROWS, ops.W_TILE mirror the first two).
constexpr int GROUP_ROWS = 32;  // rows a group: the rows that share a list
constexpr int LT_W = 128;       // machines w a product block's distance tile
constexpr int LT_K = 8;         // listed columns v a stage
constexpr int LT_STAGES = 3;    // stages in flight
constexpr int LT_THREADS = 256;
constexpr int MASS_WARPS = 4;   // warps a row of list_masses_kernel

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
  double penalty;
  int64_t B, T, comp_stride, uir_stride;
  int n, m, mp, ld, k2, qp, n_edges, rows;
  int kt_log2;   // columns v of `distance` a tile: 1 << kt_log2
  int stages;    // tiles in flight
  int y_offset;  // where Y^T starts in the region (0: over the tiles)
  // kLists: the topology's lists and the wave's scratch.
  const int32_t* list_of;     // (n,) list of the component, or -1
  const int32_t* list_slots;  // (n_lists, 2) its (send, receive) slots; two-slot lists first
  int n_lists, n2, words;     // lists, two-slot lists, 32-bit words of a bitmap
  int64_t b0;                 // the wave's first row
  double* X;                  // [wave rows][k2][m]
  double* Y;                  // [wave rows][k2][m]
  int32_t* list;              // [groups][n_lists][m]
  unsigned* occ;              // [groups][n_lists][words]
  int32_t* len;               // [groups][n_lists]
  unsigned* nonfinite;        // [words]
};

// A warp's staged chunk of the mass phase: each lane's task (machine or -1,
// its two slots, its two values) and each lane's mask of the tasks it owns.
struct Staged {
  double2 val[32];
  int2 slot[32];
  int w[32];
  unsigned own[32];
};

// Shared memory of the one-block layouts: X^T [mp][qp] (row (r, slot) of X
// is column r K2 + slot, padded to qp, a multiple of MQ), then one region
// used in turn by step 2 (a Staged per warp), by step 3 (the distance tiles
// [kt][ld]) and by steps 4-5 (Y^T [mp][qp]): Y^T over the region
// (kOverlap) or past it, when step 3 takes more than one round of items
// (kYApart). kLists keeps X and Y in the wrapper's scratch.
enum Layout { kOverlap, kYApart, kLists };

size_t smem_bytes(const Args& a, int rows, int threads, int kt, Layout layout, int stages) {
  const int qp = (rows * a.k2 + MQ - 1) / MQ * MQ;
  const size_t masses = sizeof(Staged) * (threads / 32);
  const size_t tiles = sizeof(double) * stages * kt * a.ld;
  const size_t region = masses > tiles ? masses : tiles;
  const size_t xy = sizeof(double) * static_cast<size_t>(a.mp) * qp;  // X^T or Y^T
  if (layout == kYApart) return xy + region + xy;
  return xy + (region > xy ? region : xy);
}

// The list layout's scratch for a wave of `wave_rows` rows (whole groups):
// X and Y, then the lists, the bitmaps, the lengths and the flags of the
// non-finite columns (ops.list_wave mirrors it).
size_t list_scratch_bytes(int64_t wave_rows, int k2, int m, int n_lists) {
  const int64_t groups = wave_rows / GROUP_ROWS, words = (m + 31) / 32;
  return 16 * static_cast<size_t>(wave_rows) * k2 * m +
         4 * static_cast<size_t>(groups * n_lists * (m + words + 1) + words);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(BYTES));
}

// Steps 1-2 of row b: warp h of the ns warps that share the row takes the
// machines w with (w / 32) mod ns = h, and its lane L those with w mod 32 =
// L; each lane adds the row's tasks on its machines in increasing order
// into *cell(w, slot), so each cell sums its tasks in task order, with no
// atomics on the sums. Tasks come in chunks of 32, one a lane (step 1 on
// the lane), the next chunk's operands loading meanwhile; each lane learns
// which of the chunk's tasks are its own by a bit each, set by
// shared-memory atomicOr into the warp's staging area. With MARK each task
// also sets its machine's bit in its component's bitmap in `occ`.
template <bool MARK, class Cell>
__device__ __forceinline__ void row_masses(const Args& a, int64_t b, int ns, int h, Staged& st,
                                           Cell cell, unsigned* occ) {
  const int lane = threadIdx.x & 31, m = a.m;
  const int32_t* tm_b = a.tm + b * a.T;
  const int32_t* comp_b = a.comp + b * a.comp_stride;
  const double* uir_b = a.unit_ir + b * a.uir_stride;
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
    if (MARK && w >= 0) {
      atomicOr(occ + static_cast<size_t>(__ldg(a.list_of + c)) * a.words + (w >> 5),
               1u << (w & 31));
    }
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
      const int wj = st.w[j];
      const int2 sl = st.slot[j];
      const double2 v = st.val[j];
      if (sl.x >= 0) {
        double* x = cell(wj, sl.x);
        *x = __dadd_rn(*x, v.x);
      }
      if (sl.y >= 0) {
        double* x = cell(wj, sl.y);
        *x = __dadd_rn(*x, v.y);
      }
    }
  }
}

// The one-block layouts: a block a group of R rows, everything in shared
// memory.
__global__ void __launch_bounds__(NT_MAX) cut_traffic_kernel(Args a) {
  extern __shared__ __align__(16) double smem[];
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int R = a.rows, K2 = a.k2, m = a.m, mp = a.mp, ld = a.ld, qp = a.qp;
  double* XT = smem;
  double* region = XT + static_cast<size_t>(mp) * qp;
  Staged& st = reinterpret_cast<Staged*>(region)[warp];
  double* D = region;  // [stages][kt][ld]
  double* YT = region + a.y_offset;  // [mp][qp]

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
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * R;
  for (int i = tid; i < mp * qp; i += nt) XT[i] = 0.0;
  __syncthreads();

  // Steps 1-2: warp (r, h) takes row r and the machines w with (w / 32) mod
  // ns = h, where ns warps share a row (as many, up to 4, as the block's
  // warps allow).
  int ns = 1;
  while (ns < 4 && 2 * ns * R <= n_warps) ns *= 2;
  for (int job = warp; job < R * ns && b0 + job / ns < a.B; job += n_warps) {
    double* x_r = XT + (job / ns) * K2;
    row_masses<false>(
        a, b0 + job / ns, ns, job % ns, st,
        [&](int w, int s) { return x_r + static_cast<size_t>(w) * qp + s; }, nullptr);
  }

  // Step 3: Y = X . distance^T, v in increasing order. A micro-tile is MQ
  // rows of X (q0 ..) by MW machines (w0, w0 + 1, w0 + 2 WW, w0 + 2 WW +
  // 1); a warp takes a tile of WQ x WW of them, 4 WW machines wide, so a
  // warp's loads of a column v read WQ runs of MQ doubles of X^T and two
  // runs of 2 WW consecutive machines of the distance tile. Round i0 gives
  // warp k the warp tile i0 + k (one round unless X is very large).
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
}

// kLists, once a call: the bitmap of the columns v of `distance` that hold
// an inf or a NaN (a stream of all m^2 values, four loads a thread in
// flight).
__global__ void __launch_bounds__(256) nonfinite_columns_kernel(Args a) {
  const int64_t n = static_cast<int64_t>(a.m) * a.m;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += 4 * stride) {
    double d[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) d[u] = i + u * stride < n ? __ldg(a.distance + i + u * stride) : 0.0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (!isfinite(d[u])) {
        const int v = static_cast<int>((i + u * stride) % a.m);
        atomicOr(a.nonfinite + (v >> 5), 1u << (v & 31));
      }
    }
  }
}

// kLists (a): steps 1-2 of the wave's row blockIdx.x into X, and the
// occupancy bitmaps of its group.
__global__ void __launch_bounds__(32 * MASS_WARPS) list_masses_kernel(Args a) {
  __shared__ Staged st[MASS_WARPS];
  const int warp = threadIdx.x >> 5;
  const int64_t row = blockIdx.x;
  double* x_r = a.X + row * a.k2 * a.m;
  unsigned* occ = a.occ + (row / GROUP_ROWS) * a.n_lists * a.words;
  row_masses<true>(
      a, a.b0 + row, MASS_WARPS, warp, st[warp],
      [&](int w, int s) { return x_r + static_cast<size_t>(s) * a.m + w; }, occ);
}

// kLists (b): list blockIdx.x of group blockIdx.y, the set bits of its
// bitmap or of the non-finite columns' in increasing order; a thread takes
// a run of words, and a block-wide prefix sum of their popcounts places
// its columns.
__global__ void __launch_bounds__(256) list_columns_kernel(Args a) {
  __shared__ int warp_sums[8];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t gl = static_cast<size_t>(blockIdx.y) * a.n_lists + blockIdx.x;
  const unsigned* occ = a.occ + gl * a.words;
  int32_t* list = a.list + gl * a.m;
  const int per = (a.words + 255) / 256;
  const int w0 = tid * per, w1 = w0 + per < a.words ? w0 + per : a.words;
  int count = 0;
  for (int w = w0; w < w1; ++w) count += __popc(occ[w] | a.nonfinite[w]);
  int incl = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int base = 0;
  for (int i = 0; i < warp; ++i) base += warp_sums[i];
  int pos = base + incl - count;
  for (int w = w0; w < w1; ++w) {
    for (unsigned bits = occ[w] | a.nonfinite[w]; bits != 0u; bits &= bits - 1u) {
      list[pos++] = 32 * w + __ffs(bits) - 1;
    }
  }
  if (tid == 255) a.len[gl] = base + incl;
}

// kLists (c): step 3 for the group blockIdx.x, the machines [blockIdx.y
// LT_W, + LT_W) and the list j, one with NS slots. A thread owns rows r0 ..
// r0 + 3 of the group, the list's NS slots and the machines wl, wl + 1, wl
// + 32, wl + 33 of the tile (a warp: 8 rows by 64 machines; its loads of a
// column are two broadcast runs of X and one run of 32 machines of the
// distance tile, twice).
template <int NS>
__device__ __forceinline__ void list_product(const Args& a, int j, double* smem) {
  constexpr int Q = GROUP_ROWS * NS;  // the group's rows of X on this list: (row, slot)
  double(*Xs)[LT_K][Q] = reinterpret_cast<double(*)[LT_K][Q]>(smem);
  double(*Ds)[LT_K][LT_W + 2] =
      reinterpret_cast<double(*)[LT_K][LT_W + 2]>(smem + LT_STAGES * LT_K * Q);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.x, wb = blockIdx.y * LT_W, m = a.m, k2 = a.k2;
  const size_t gl = static_cast<size_t>(g) * a.n_lists + j;
  const int L = a.len[gl];
  const int32_t* list = a.list + gl * m;
  const int s0 = __ldg(a.list_slots + 2 * j), s1 = __ldg(a.list_slots + 2 * j + 1);
  const double* Xg = a.X + static_cast<size_t>(g) * GROUP_ROWS * k2 * m;
  const int n_kt = (L + LT_K - 1) / LT_K;
  // Stage t: listed columns k = t LT_K + kk, kk = tid mod LT_K for every
  // copy of this thread; Ds[kk][w] = distance[wb + w][v_k] and Xs[kk][q] =
  // X[row q / NS][slot q mod NS][v_k], each by 8-byte async copies (a warp
  // reads LT_K consecutive listed columns of 32 / LT_K rows).
  auto load = [&](int t) {
    const int k = t * LT_K + (tid & (LT_K - 1));
    if (k < L) {
      const int v = __ldg(list + k), kk = tid & (LT_K - 1), s = t % LT_STAGES;
      for (int w = tid / LT_K; w < LT_W; w += LT_THREADS / LT_K) {
        if (wb + w < m) cp_async<8>(&Ds[s][kk][w], a.distance + static_cast<int64_t>(wb + w) * m + v);
      }
      for (int q = tid / LT_K; q < Q; q += LT_THREADS / LT_K) {
        const int slot = NS == 2 && (q & 1) ? s1 : s0;
        cp_async<8>(&Xs[s][kk][q], Xg + (static_cast<size_t>(q / NS) * k2 + slot) * m + v);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int r0 = ((warp & 3) * 2 + (lane >> 4)) * 4;
  const int wl = (warp >> 2) * 64 + 2 * (lane & 15);
  double acc[4][NS][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][s][i] = 0.0;
  for (int t = 0; t + 1 < LT_STAGES && t < n_kt; ++t) load(t);
  for (int t = 0; t < n_kt; ++t) {
    // Stage t landed for all (the later ones may be in flight); stage t -
    // 1 consumed, so its buffer takes stage t + LT_STAGES - 1.
    if (t + LT_STAGES - 2 < n_kt) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(LT_STAGES - 2));
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    if (t + LT_STAGES - 1 < n_kt) load(t + LT_STAGES - 1);
    const int s = t % LT_STAGES, kc = L - t * LT_K < LT_K ? L - t * LT_K : LT_K;
    for (int k = 0; k < kc; ++k) {
      double x[4 * NS];
#pragma unroll
      for (int i = 0; i < 2 * NS; ++i) {
        const double2 p = *reinterpret_cast<const double2*>(&Xs[s][k][r0 * NS + 2 * i]);
        x[2 * i] = p.x;
        x[2 * i + 1] = p.y;
      }
      // machines past m read slots no copy filled; their sums are dropped
      const double2 d01 = *reinterpret_cast<const double2*>(&Ds[s][k][wl]);
      const double2 d23 = *reinterpret_cast<const double2*>(&Ds[s][k][wl + 32]);
      const double d[4] = {d01.x, d01.y, d23.x, d23.y};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < NS; ++q)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[r][q][i] = __dadd_rn(acc[r][q][i], __dmul_rn(x[r * NS + q], d[i]));
          }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t row = static_cast<int64_t>(g) * GROUP_ROWS + r0 + r;
    if (a.b0 + row >= a.B) break;
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      double* y = a.Y + (row * k2 + (q ? s1 : s0)) * m + wb;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int w = wl + (i & 1) + (i >> 1) * 32;
        if (wb + w < m) y[w] = acc[r][q][i];
      }
    }
  }
}

// The lists of both kinds in one launch, list blockIdx.z: the two-slot
// lists first on the grid, so that the one-slot lists' blocks fill the
// last wave.
__global__ void __launch_bounds__(LT_THREADS, 2) list_product_kernel(Args a) {
  extern __shared__ __align__(16) double smem[];
  if (static_cast<int>(blockIdx.z) < a.n2) {
    list_product<2>(a, blockIdx.z, smem);
  } else {
    list_product<1>(a, blockIdx.z, smem);
  }
}

// Shared bytes of list_product_kernel: the two-slot lists' stages.
constexpr size_t kListSmem = sizeof(double) * LT_STAGES * LT_K * (2 * GROUP_ROWS + LT_W + 2);

// kLists (d): steps 4-5 of the wave's (row, w) pairs, from X and Y.
__global__ void __launch_bounds__(256) list_edges_kernel(Args a, int64_t rows) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rows * a.m) return;
  const int64_t row = i / a.m;
  const int w = static_cast<int>(i - row * a.m);
  const size_t m = a.m;
  const double* x = a.X + row * a.k2 * a.m + w;
  const double* y = a.Y + row * a.k2 * a.m + w;
  double acc_w = 0.0;
  for (int e = 0; e < a.n_edges; ++e) {
    const int sa = __ldg(a.edges + 2 * e), rb = __ldg(a.edges + 2 * e + 1);
    acc_w = __dadd_rn(acc_w, __dmul_rn(x[sa * m], y[rb * m]));
    acc_w = __dadd_rn(acc_w, __dmul_rn(x[rb * m], y[sa * m]));
  }
  a.out[(a.b0 + row) * a.m + w] = __dmul_rn(acc_w, a.penalty);
}

// The launch's shape: rows a block (kLists: a group), threads, shared
// memory, layout, tiles, and resident blocks a SM (kLists: of the
// product kernel).
struct Plan {
  int rows, threads, kt, per_sm;
  Layout layout;
  size_t smem;
};

// The most rows (8, 4, 2 or 1) whose warp tiles fit one round of NT_MAX
// threads and whose shared memory lets two blocks share an SM; then one
// warp a warp tile. A product too large for one round at one row takes
// several, with Y^T past the tiles, and narrower tiles where the shared
// memory needs them. Where X^T and Y^T do not fit even so, kLists
// (ops.one_block mirrors the choice). Fills a's derived fields.
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
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (smem_bytes(a, rows, NT_MAX, kt, layout, stages) > kBlockMax) {
    pl.layout = kLists;
    pl.rows = GROUP_ROWS;
    pl.threads = LT_THREADS;
    pl.kt = LT_K;
    pl.smem = kListSmem;
    a.stages = LT_STAGES;
    a.words = (a.m + 31) / 32;
    err = cudaFuncSetAttribute(list_product_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kListSmem));
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&pl.per_sm, list_product_kernel,
                                                         LT_THREADS, kListSmem);
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
  const size_t xy = sizeof(double) * a.mp * a.qp;
  a.y_offset = layout == kYApart ? static_cast<int>((pl.smem - 2 * xy) / sizeof(double)) : 0;
  err = cudaFuncSetAttribute(cut_traffic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(pl.smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&pl.per_sm, cut_traffic_kernel, nt,
                                                       pl.smem);
}

// kLists: the waves of `wave_rows` rows through the scratch.
cudaError_t launch_lists(Args a, int device, int64_t wave_rows, char* scratch,
                         cudaStream_t s) {
  const int k2 = a.k2, m = a.m;
  const int64_t groups = wave_rows / GROUP_ROWS;
  a.X = reinterpret_cast<double*>(scratch);
  a.Y = a.X + wave_rows * k2 * m;
  a.list = reinterpret_cast<int32_t*>(a.Y + wave_rows * k2 * m);
  a.occ = reinterpret_cast<unsigned*>(a.list + groups * a.n_lists * m);
  a.len = reinterpret_cast<int32_t*>(a.occ + groups * a.n_lists * a.words);
  a.nonfinite = reinterpret_cast<unsigned*>(a.len + groups * a.n_lists);
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaMemsetAsync(a.nonfinite, 0, size_t{4} * a.words, s);
  if (err != cudaSuccess) return err;
  nonfinite_columns_kernel<<<8 * sms, 256, 0, s>>>(a);
  const unsigned tiles = (m + LT_W - 1) / LT_W;
  for (a.b0 = 0; a.b0 < a.B; a.b0 += wave_rows) {
    const int64_t rows = a.B - a.b0 < wave_rows ? a.B - a.b0 : wave_rows;
    const unsigned g = static_cast<unsigned>((rows + GROUP_ROWS - 1) / GROUP_ROWS);
    err = cudaMemsetAsync(a.X, 0, sizeof(double) * g * GROUP_ROWS * k2 * m, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(a.occ, 0, size_t{4} * g * a.n_lists * a.words, s);
    if (err != cudaSuccess) return err;
    list_masses_kernel<<<static_cast<unsigned>(rows), 32 * MASS_WARPS, 0, s>>>(a);
    list_columns_kernel<<<dim3(a.n_lists, g), 256, 0, s>>>(a);
    if (a.n_lists > 0) {
      list_product_kernel<<<dim3(g, tiles, a.n_lists), LT_THREADS, kListSmem, s>>>(a);
    }
    list_edges_kernel<<<static_cast<unsigned>((rows * m + 255) / 256), 256, 0, s>>>(a, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// The launch that cut_traffic_launch makes for B rows of T tasks, k2 slots,
// n_lists lists of which n2 have two slots, m machines and waves of
// wave_rows rows, into out[0..13]: rows a block (kLists: a group), threads
// a block, shared bytes a block, layout (0 shared, 1 Y^T apart, 2 lists),
// columns a distance tile, tiles in flight, blocks (kLists: product blocks
// of a full wave), resident blocks a SM, the registers and local (spilled)
// bytes a thread (kLists: of the product kernel), machines w a
// distance tile, rows a wave, scratch bytes and the capacity of a list
// (kLists; else 0). Returns a cudaError_t code: 0 on success.
extern "C" int cut_traffic_plan(int device, long long B, long long T, int k2, int m, int n_lists,
                                int n2, long long wave_rows, long long* out) {
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
  const bool lists = pl.layout == kLists;
  cudaFuncAttributes attr;
  err = lists ? cudaFuncGetAttributes(&attr, list_product_kernel)
              : cudaFuncGetAttributes(&attr, cut_traffic_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (m + LT_W - 1) / LT_W;
  const long long vals[14] = {
      pl.rows, pl.threads, static_cast<long long>(pl.smem), static_cast<long long>(pl.layout),
      pl.kt, a.stages,
      lists ? wave_rows / GROUP_ROWS * tiles * n_lists : (B + pl.rows - 1) / pl.rows, pl.per_sm,
      attr.numRegs, static_cast<long long>(attr.localSizeBytes), lists ? LT_W : a.mp,
      lists ? wave_rows : 0,
      lists ? static_cast<long long>(list_scratch_bytes(wave_rows, k2, m, n_lists)) : 0,
      lists ? m : 0};
  for (int i = 0; i < 14; ++i) out[i] = vals[i];
  return 0;
}

// Launches the kernel on `stream` (no synchronisation). `send_slot` /
// `recv_slot` map each of the n components to its row of X (srcs first, in
// increasing order, then dsts; -1 where it has none), `edges` holds the
// (send slot of a, receive slot of b) of each edge in order, `k2` is the
// number of slots; `list_of` maps each component to its list (-1 where it
// has none) and `list_slots` holds each list's (send, receive) slots, the
// n2 lists of two slots first. Past the one-block layouts, `scratch` holds
// list_scratch_bytes(wave_rows, ...) bytes (the wrapper allocates them;
// wave_rows a multiple of 32). Returns a cudaError_t code: 0 on success.
extern "C" int cut_traffic_launch(
    int device, const void* tm, const void* comp, long long comp_stride, const void* unit_ir,
    long long uir_stride, const void* alpha, const void* cir, const void* send_slot,
    const void* recv_slot, const void* edges, int n_edges, int k2, const void* list_of,
    const void* list_slots, int n_lists, int n2, const void* distance, double penalty,
    void* out, long long B, long long T, int n, int m, void* scratch, long long scratch_bytes,
    long long wave_rows, void* stream) {
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
  a.list_of = static_cast<const int32_t*>(list_of);
  a.list_slots = static_cast<const int32_t*>(list_slots);
  a.n_lists = n_lists;
  a.n2 = n2;
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
  if (pl.layout == kLists) {
    if (wave_rows <= 0 || wave_rows % GROUP_ROWS != 0 || scratch == nullptr ||
        static_cast<size_t>(scratch_bytes) < list_scratch_bytes(wave_rows, k2, m, n_lists)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(launch_lists(a, device, wave_rows, static_cast<char*>(scratch), s));
  }
  const unsigned blocks = static_cast<unsigned>((B + pl.rows - 1) / pl.rows);
  cut_traffic_kernel<<<dim3(blocks), pl.threads, pl.smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
