// sLSTM recurrence for Hopper (sm_90a): the whole time loop of one sLSTM
// block call in one launch, in one of two layouts, and its backward (one
// launch in the cooperative layout, a loop and a rest pass in the cluster
// layout).
//
// No TPU kernel stands behind it. It replaces the time loop of
// src/repro/models/xlstm.py::slstm_block, an XLA lax.scan (:293-312), which
// the port ran as a Python loop of ~13 small torch ops a token: at
// xlstm-125m's prefill (6 sLSTM blocks, 8 x 512 tokens, d 768) ~59 000
// launches, the host's time and not the card's. For every step t, with
// h_{-1}, c_{-1}, n_{-1}, m_{-1} the entering state:
//   z   = tanh(zx_t + h_{t-1} @ rw)
//   lf  = log_sigmoid(fx_t),   m_t = max(lf + m_{t-1}, ix_t)
//   i'  = exp(ix_t - m_t),     f' = exp(lf + m_{t-1} - m_t)
//   c_t = f' c_{t-1} + i' z,   n_t = f' n_{t-1} + i'
//   h_t = sigmoid(ox_t) c_t / max(n_t, 1)
// hs[:, t] = h_t, and the state after the last step. For training the
// forward also saves every step's c_t, n_t, m_t and z (the save pointers
// set; serving passes null and runs as before).
//
// Layout: zx, ix, fx, ox and hs (B, S, d), rw (d, d), the states (B, d), all
// float32 and contiguous.
//
// Numbers: the plain version's (ref.py, torch's CUDA formulae, built without
// --use_fast_math): log_sigmoid(x) = min(x, 0) - log1p(exp(-|x|)),
// sigmoid(x) = 1 / (1 + exp(-x)), tanhf; max and max(n, 1) keep NaN as
// torch.maximum and clamp_min do (fmaxf alone would drop it). Every product
// and sum of the update rounds on its own (__fmul_rn, __fadd_rn: no
// multiply-add), in the plain version's order, so the update is bit for bit
// the plain version's in both layouts; only the dot products sum in another
// order than cuBLAS (each lane's k in ascending order, then a fixed tree over
// the lanes), and the kernel is held to the plain version by tolerance.
// Neither layout uses atomics, so a rerun gives the same bits.
//
// Bound: operations. 2 B S d^2 FLOP of the products (4.83 G at B 8, S 512,
// d 768: 0.072 ms at 67 TFLOP/s FP32) against ~65 MB moved (0.0195 ms at
// 3.35 TB/s). But step t needs all of row b's h_{t-1}, so the steps of a row
// are serial, and a step's latency, not either bound, sets the time.
//
// Rows never mix: h_{t-1} @ rw couples the columns of one row only. So the
// wait between steps need only span the blocks that hold one row's columns.
// Two layouts, chosen by the caller (ops.plan, from the shape and the
// device's attributes) before the launch:
//
// Cluster layout (slstm_scan_cluster_kernel): an ordinary launch
// (cudaLaunchKernelEx) of thread-block clusters of C blocks, C the fewest that
// hold d at 48 columns a block (16 at d = 768, a non-portable size). A cluster
// runs the whole loop for R <= 8 rows; clusters never wait on each other, so
// none needs another resident: no grid-wide barrier, no cooperative launch.
// Block c owns W = ceil(d / C) rounded up to 4 columns from c W (the last
// block the rest) and holds rw[:, its slice] in registers for the whole loop:
// warp w columns 4w..4w+3, lane l rows k = 4 l + 128 i + e (i < 6, e < 4; 96
// floats a thread, so d <= 768). A step of a block:
//   - lane l of warp w owns row l % 8 and column 4w + l / 8 for the whole
//     loop: its state c, n, m stay in registers, its four gates are loaded a
//     step ahead, and what needs no h (log_sigmoid(fx), sigmoid(ox), m_t, the
//     two exponentials, n_t) is computed while h_{t-1} is on its way, leaving
//     tanhf, two products and one division on the chain;
//   - it waits for h_{t-1} on an mbarrier of its own shared memory, then every
//     lane sums its k for each row (16-byte loads of rows padded to 768, zeros
//     past d), and a reduce-scatter (6 shuffles a row) leaves column 4w + l/8's
//     sum in lane l's group of 8;
//   - the owning lane updates and stores hs[b, t, j]; the warp then writes its
//     4 columns of h_t into every block of the cluster, this one's too, one
//     16-byte st.async a (row, block) spread over the lanes, each landing
//     counted on the receiver's mbarrier (complete_tx).
// h is double-buffered by step parity, one mbarrier a buffer, each phase
// expecting all of h_t. No block writes a buffer before every reader of it is
// done: h_{t+1} is sent only once all of h_t has arrived, and each block sends
// its part of h_t after its own reads of the buffer. So no barrier spans the
// cluster after the first cluster.sync() (buffers and mbarriers ready before
// any peer writes) and before the last (no block leaves while a peer may still
// write into it). On an H100 this was the cheapest exchange tried: a cluster
// barrier with release semantics a step cost more, a relaxed one orders no
// store, and step-tagged words left readers spinning on late stores.
//
// Cooperative layout (slstm_scan_kernel): one cooperative
// launch, blocks own groups of kCols output columns for all B rows, at most
// one block an SM (every block resident, checked against the occupancy;
// grid.sync() between steps). A block keeps rw[:, its columns] in shared
// memory (768 x 8 floats, 24 KB, at xlstm-125m) where it fits, and reads it
// through the read-only path where not. Each step a block stages h_{t-1}
// (rows x a k chunk) from hs[:, t-1] (or the entering h at t = 0) through
// the L2 (__ldcg: other blocks wrote it in this launch); a warp takes one
// row and one group of columns, lane l the products over k = l mod 32, and
// after a butterfly lane q < kCols owns column q: its gates, hs[b, t, j],
// and c, n, m in the output state. Rows past the staging tile and k past the
// chunk loop; a ragged last group is masked. It takes any (B, S, d) the
// plain version takes: it serves d > 768, and a call of a few steps (a
// decode step), where loading 144 KiB of rw a block costs the cluster layout
// more than the step itself.
//
// The backward replaces autograd through the same lax.scan (the
// reference's jax.grad of slstm_block, :312). It runs t = S-1 .. 0 from the
// saved c, n, m, z, the gradients dhs of every output and those of the
// state after the last step (any of them null: zero), and writes dzx_t (the
// gradient of z's pre-activation, dz_pre,t), dix_t, dfx_t, dox_t and the
// entering state's gradients. ref.py's slstm_scan_bwd_ref is its CPU twin
// and gives the formulae; each product, sum and quotient rounds on its own
// in the twin's order. Its only serial dependence runs through the chain
//   dh_t = dhs_t + dz_pre,t+1 @ rw^T -> dq = dh_t / max(n_t, 1)
//   -> dc' = dc + dq o -> dz_pre,t = dc' i' (1 - z_t^2),  dc <- dc' f',
// the forward's product with rw^T in the place of rw; dn, dm and the gate
// gradients hang off it and feed nothing back into it. The layouts:
//
// Cluster layout: two kernels, one after the other. The loop
// (slstm_scan_bwd_cluster_kernel) holds the chain and nothing else: block c
// holds rows J of rw (its columns of rw^T) in registers, the lane that owns
// (row, column) carries dc and loads a step ahead what the chain reads (the
// gates, dhs, z, n, m), computes the chain's terms (o, i', f', max(n, 1),
// 1 - z^2) while dz_pre,t+1 is on its way, and stores dzx_t and dh_t (gs, a
// scratch the wrapper allocates). The exchange is phased by row: each row
// of the cluster has its own double buffer and its own pair of mbarriers,
// each phase expecting that row's 4 d bytes, and each row is sent apart. A
// warp waits for the rows two at a time and sums both rows' products
// together (their loads and products interleaved): on an H100 80GB HBM3 at
// 700 W the loop at (8, 512, 768) took 0.7007 ms so, where taking the rows
// in turn (wait, products, chain and send of one row, then the next) took
// 0.7887 and waiting each row just before its own products 0.7351
// (launch/slstm_bwd_split.py --orders): one row's products and
// reduce-scatter alone leave the warps too little to interleave. The
// invariant of the forward holds row by row: no block writes a row's buffer
// before every reader of it is done, since dz_pre,t[r] is sent only once
// all of dz_pre,t+1[r] has arrived, and each block sends its part after its
// own reads of that buffer. One wait more after step 0 gives the entering
// h's gradient. The rest (slstm_scan_bwd_rest_kernel) then runs
// over t = S-1 .. 0 from gs: dc, dn and dm are recurrences of one column and
// wait on no exchange; a block's producer warps compute the steps' terms a
// chunk ahead in parallel and one warp runs the recurrences, each value
// rounded as the cooperative kernel's step_terms, step_chain and step_rest
// round it, so every output keeps its bits.
//
// Cooperative layout (slstm_scan_bwd_kernel): the whole step in one
// kernel, dz_pre,t+1 staged from dzx[:, t+1] after a grid barrier, dc, dn,
// dm carried in the output state; it serves d past 768 and short calls.
//
// The gradient of rw, sum over rows and steps of h_{t-1}^T dz_pre,t, is one
// matrix product after the launch (the caller's). Bound: operations, as the
// forward's (the same 2 B S d^2 FLOP of products); ~154 MB of operands at
// (8, 512, 768), and the cluster layout moves 2 x 12.6 MB more through gs.
//
// Each layout and direction has a serial floor (serial_floor 1): the same
// launch with the arithmetic removed. The cooperative floor is its grid
// barriers; the cluster floor its exchange (the mbarrier waits and the
// st.async stores, one read of the buffer a lane; in the backward's loop
// phased by row).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;             // columns of a group (one warp's dot products)
constexpr int kStageFloats = 8192;   // h staging: rows x chunk floats (32 KB)
constexpr int kMaxChunk = 4096;      // k chunk (a multiple of 32)

// The cluster layout (ops.py mirrors these numbers in its plan).
constexpr int kCThreads = 384;                   // 12 warps a block
constexpr int kCWarps = kCThreads / 32;
constexpr int kWarpCols = 4;                     // columns of rw a warp holds
constexpr int kLaneK = 24;                       // k a lane holds: 4 lane + 128 i + e
constexpr int kMaxWidth = kCWarps * kWarpCols;   // 48 columns a block
constexpr int kMaxClusterD = 32 * kLaneK;        // 768
constexpr int kMaxClusterRows = 8;               // rows a cluster: a lane updates one
constexpr int kMaxCluster = 16;                  // the largest (non-portable) cluster

constexpr int kLayoutCooperative = 0;
constexpr int kLayoutCluster = 1;

struct Args {
  const float* zx;
  const float* ix;
  const float* fx;
  const float* ox;
  const float* rw;
  const float* c0;
  const float* n0;
  const float* h0;
  const float* m0;
  float* hs;
  float* c;
  float* n;
  float* h;
  float* m;
  float* cs;  // every step's c, n, m, z (B, S, d) for the backward, or all null
  float* ns;
  float* ms;
  float* zs;
  int64_t B, S, d;
  int groups;       // column groups of kCols, ceil(d / kCols)
  int chunk;        // k staged at once
  int rows;         // rows of h staged at once
  int rw_resident;  // rw[:, the block's columns] in shared memory
};

struct ClusterArgs {
  const float* zx;
  const float* ix;
  const float* fx;
  const float* ox;
  const float* rw;
  const float* c0;
  const float* n0;
  const float* h0;
  const float* m0;
  float* hs;
  float* c;
  float* n;
  float* h;
  float* m;
  float* cs;  // as Args
  float* ns;
  float* ms;
  float* zs;
  int64_t B, S;
  int d;
  int C;  // blocks a cluster (column slices)
  int R;  // rows a cluster, at most kMaxClusterRows (lane l of a warp owns row l % 8)
  int W;  // ceil(d / C) rounded up to 4: a slice's width (the last block's: the rest)
};

// The backward's operands, both layouts (each reads its own plan's fields).
struct BwdArgs {
  const float* dhs;  // (B, S, d), or null: zero
  const float* dcT;  // the state after the last step's gradients (B, d), each null: zero
  const float* dnT;
  const float* dhT;
  const float* dmT;
  const float* ix;
  const float* fx;
  const float* ox;
  const float* rw;
  const float* c0;  // the entering state
  const float* n0;
  const float* m0;
  const float* cs;  // the forward's saved c, n, m, z of every step (B, S, d)
  const float* ns;
  const float* ms;
  const float* zs;
  float* dzx;  // (B, S, d)
  float* dix;
  float* dfx;
  float* dox;
  float* dc;  // the entering state's gradients (B, d)
  float* dn;
  float* dh;
  float* dm;
  float* gs;  // every step's dh_t (B, S, d): the cluster loop's output, its rest pass's input
  int64_t B, S, d;
  int groups, chunk, rows, rw_resident;  // the cooperative layout's plan
  int C, R, W;                           // the cluster layout's
};

struct Plan {
  int grid, groups, groups_per_block, chunk, rows, rw_resident, blocks_per_sm, sms;
  size_t smem;
};

// torch.maximum and clamp_min on CUDA: NaN in, NaN out.
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float log_sigmoid(float x) {
  const float lo = x < 0.0f ? x : 0.0f;  // std::min(0, x)
  return __fsub_rn(lo, log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// d log_sigmoid(x) / dx as torch's log_sigmoid_backward: with z = exp(-|x|),
// 1 - z / (1 + z) below 0, z / (1 + z) from 0.
__device__ __forceinline__ float log_sigmoid_grad(float x) {
  const float z = expf(-fabsf(x));
  const float s = __fdiv_rn(z, __fadd_rn(1.0f, z));
  return x < 0.0f ? __fsub_rn(1.0f, s) : s;
}

// What a backward step needs of the forward and no gradient: from the gates
// and the saved values of steps t and t - 1. ChainTerms: what the chain from
// dh_t to dz_pre,t (and the carried dc) reads; StepTerms adds the rest's.
struct ChainTerms {
  float o, lfm, i_p, f_p, nd, zz;
};

struct StepTerms : ChainTerms {
  float qnn, lsg;
};

__device__ __forceinline__ ChainTerms chain_terms(float ix, float fx, float ox, float n, float m,
                                                  float z, float m_prev) {
  ChainTerms k;
  k.o = sigmoid(ox);
  k.lfm = __fadd_rn(log_sigmoid(fx), m_prev);
  k.i_p = expf(__fsub_rn(ix, m));
  k.f_p = expf(__fsub_rn(k.lfm, m));
  k.nd = max_nan(n, 1.0f);
  k.zz = __fsub_rn(1.0f, __fmul_rn(z, z));
  return k;
}

__device__ __forceinline__ StepTerms step_terms(float ix, float fx, float ox, float c, float n,
                                                float m, float z, float m_prev) {
  StepTerms k;
  static_cast<ChainTerms&>(k) = chain_terms(ix, fx, ox, n, m, z, m_prev);
  k.qnn = __fdiv_rn(__fdiv_rn(__fmul_rn(k.o, c), k.nd), k.nd);  // (o c / nd) / nd
  k.lsg = log_sigmoid_grad(fx);
  return k;
}

// The chain of a backward step: dz_pre,t from g = dh_t and the carried dc;
// leaves dq and dc' for the rest.
__device__ __forceinline__ float step_chain(const ChainTerms& k, float g, float dc, float& dq,
                                            float& dcp) {
  dq = __fdiv_rn(g, k.nd);
  dcp = __fadd_rn(dc, __fmul_rn(dq, k.o));
  return __fmul_rn(__fmul_rn(dcp, k.i_p), k.zz);
}

// What the rest of a backward step reads that no carried gradient feeds,
// from the step's terms, dh_t (g) and dq: dq o (dc's addend), n's addend
// ([n >= 1] -dh_t qnn: max(n, 1)'s gradient goes to n where n >= 1), the
// values the products read, and how lf + m_{t-1} compares with ix_t (none
// of the three where either is NaN).
struct RestTerms {
  float dqo, a, z, c_prev, n_prev, f_p, i_p, lsg;
  int tie;  // 1: lf + m_{t-1} > ix_t, 2: <, 4: ==
};

__device__ __forceinline__ RestTerms rest_terms(const StepTerms& k, float g, float dq, float ix,
                                                float z, float c_prev, float n_prev, float n) {
  RestTerms r;
  r.dqo = __fmul_rn(dq, k.o);
  r.a = n >= 1.0f ? __fmul_rn(-g, k.qnn) : 0.0f;
  r.z = z;
  r.c_prev = c_prev;
  r.n_prev = n_prev;
  r.f_p = k.f_p;
  r.i_p = k.i_p;
  r.lsg = k.lsg;
  r.tie = (k.lfm > ix ? 1 : 0) | (k.lfm < ix ? 2 : 0) | (k.lfm == ix ? 4 : 0);
  return r;
}

// dox_t, which no carried gradient feeds either.
__device__ __forceinline__ float step_dox(const StepTerms& k, float dq, float c) {
  return __fmul_rn(__fmul_rn(__fmul_rn(dq, c), __fsub_rn(1.0f, k.o)), k.o);
}

// The carried part of the rest of a backward step, from dc' (step_chain's):
// the gate gradients dix, dfx and the carried dc, dn, dm for step t - 1.
// The max's gradient splits as torch.maximum's backward: half to each side
// at a tie, all to both where either is NaN.
__device__ __forceinline__ void rest_carry(const RestTerms& r, float dcp, float& dc, float& dn,
                                           float& dm, float& dix, float& dfx) {
  const float dnp = __fadd_rn(dn, r.a);
  const float di = __fadd_rn(__fmul_rn(dcp, r.z), dnp);
  const float df = __fadd_rn(__fmul_rn(dcp, r.c_prev), __fmul_rn(dnp, r.n_prev));
  dc = __fmul_rn(dcp, r.f_p);
  dn = __fmul_rn(dnp, r.f_p);
  const float gi = __fmul_rn(di, r.i_p);
  const float gf = __fmul_rn(df, r.f_p);
  const float dmt = __fsub_rn(__fsub_rn(dm, gi), gf);
  const float half = (r.tie & 4) ? __fmul_rn(dmt, 0.5f) : dmt;
  dix = __fadd_rn(gi, (r.tie & 1) ? 0.0f : half);
  dm = __fadd_rn(gf, (r.tie & 2) ? 0.0f : half);
  dfx = __fmul_rn(dm, r.lsg);
}

// The rest of a backward step, after dz_pre,t has gone: the gate gradients
// (dix, dfx, dox) and the carried dc, dn, dm for step t - 1.
__device__ __forceinline__ void step_rest(const StepTerms& k, float g, float dq, float dcp,
                                          float ix, float c, float z, float c_prev, float n_prev,
                                          float n, float& dc, float& dn, float& dm, float& dix,
                                          float& dfx, float& dox) {
  dox = step_dox(k, dq, c);
  rest_carry(rest_terms(k, g, dq, ix, z, c_prev, n_prev, n), dcp, dc, dn, dm, dix, dfx);
}

// The block's groups of kCols columns of M into rw_s[group][kCols][d]: M =
// rw (kT false, the forward's h_{t-1} @ rw) or rw^T (kT true, the backward's
// dz_pre,t @ rw^T); zeros past d.
template <bool kT>
__device__ __forceinline__ void load_columns(float* rw_s, const float* rw, int64_t d,
                                             int my_groups) {
  const int64_t total = static_cast<int64_t>(my_groups) * kCols * d;
  for (int64_t e = threadIdx.x; e < total; e += kThreads) {
    const int64_t k = e % d;
    const int64_t q = e / d;
    const int64_t j = (blockIdx.x + (q / kCols) * gridDim.x) * static_cast<int64_t>(kCols) +
                      q % kCols;
    rw_s[e] = j < d ? __ldg(kT ? rw + j * d + k : rw + k * d + j) : 0.0f;
  }
}

// The cooperative layout's products of one item (row rl of the rows r0 ..
// r0 + rows, the kCols columns of M from j0, the block's group gi): x's row
// b at xp + b * xstride, staged into x_s chunk by chunk (once for all items
// of a step where one chunk holds d: `first` marks the items' first pass,
// uniform over the block); lane l sums k = l mod 32, and after a butterfly
// every lane holds every column's sum (a + b == b + a). M as load_columns.
template <bool kT>
__device__ __forceinline__ void coop_dots(const float* xp, int64_t xstride, int64_t r0, int rows,
                                          bool first, bool active, int rl, int gi, int64_t j0,
                                          int lane, float* x_s, const float* rw_s, const float* rw,
                                          bool rw_resident, int chunk, int64_t d,
                                          float (&acc)[kCols]) {
#pragma unroll
  for (int q = 0; q < kCols; ++q) acc[q] = 0.0f;
  const int64_t n_chunks = (d + chunk - 1) / chunk;
  for (int64_t ch = 0; ch < n_chunks; ++ch) {
    const int64_t k0 = ch * chunk;
    const int len = static_cast<int>(d - k0 < chunk ? d - k0 : chunk);
    if (n_chunks > 1 || first) {
      __syncthreads();
      for (int e = threadIdx.x; e < rows * len; e += kThreads) {
        const int rr = e / len;
        const int kk = e - rr * len;
        x_s[rr * chunk + kk] = __ldcg(xp + (r0 + rr) * xstride + k0 + kk);
      }
      __syncthreads();
    }
    if (active) {
      const float* xrow = x_s + rl * chunk;
      if (rw_resident) {
        const float* w = rw_s + static_cast<int64_t>(gi) * kCols * d + k0;
        for (int kk = lane; kk < len; kk += 32) {
          const float hv = xrow[kk];
#pragma unroll
          for (int q = 0; q < kCols; ++q) acc[q] = fmaf(hv, w[q * d + kk], acc[q]);
        }
      } else {
        for (int kk = lane; kk < len; kk += 32) {
          const float hv = xrow[kk];
#pragma unroll
          for (int q = 0; q < kCols; ++q) {
            const float wq = j0 + q < d ? __ldg(kT ? rw + (j0 + q) * d + k0 + kk
                                                   : rw + (k0 + kk) * d + j0 + q)
                                        : 0.0f;
            acc[q] = fmaf(hv, wq, acc[q]);
          }
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc[q] = __fadd_rn(acc[q], __shfl_xor_sync(0xffffffffu, acc[q], off));
      }
    }
  }
}

// Lane q < kCols's column of a butterfly's sums.
__device__ __forceinline__ float lane_column(const float (&acc)[kCols], int lane) {
  float dot = acc[0];
#pragma unroll
  for (int q = 1; q < kCols; ++q) {
    if (lane == q) dot = acc[q];
  }
  return dot;
}

template <bool kFloor>
__global__ void __launch_bounds__(kThreads) slstm_scan_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const int64_t B = a.B, S = a.S, d = a.d;
  if (kFloor) {  // the serial floor: the launch and its barriers, no arithmetic
    for (int64_t t = 0; t + 1 < S; ++t) grid.sync();
    return;
  }
  extern __shared__ float smem[];
  float* h_s = smem;                                  // [rows][chunk]
  float* rw_s = smem + static_cast<size_t>(a.rows) * a.chunk;  // [my_groups][kCols][d]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // Groups blockIdx.x, blockIdx.x + gridDim.x, ...; gridDim.x <= groups.
  const int my_groups = (a.groups - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  if (a.rw_resident) load_columns<false>(rw_s, a.rw, d, my_groups);

  for (int64_t t = 0; t < S; ++t) {
    // h_{t-1}: row b at hp + b * hstride.
    const float* hp = t == 0 ? a.h0 : a.hs + (t - 1) * d;
    const int64_t hstride = t == 0 ? d : S * d;
    for (int64_t r0 = 0; r0 < B; r0 += a.rows) {
      const int rows = static_cast<int>(B - r0 < a.rows ? B - r0 : a.rows);
      const int items = rows * my_groups;
      for (int base = 0; base < items; base += kWarps) {  // uniform across the block
        const int item = base + warp;
        const bool active = item < items;
        const int rl = active ? item % rows : 0;
        const int gi = active ? item / rows : 0;
        const int64_t b = r0 + rl;
        const int64_t j0 = (blockIdx.x + static_cast<int64_t>(gi) * gridDim.x) * kCols;
        const int64_t j = j0 + lane;
        const bool owner = active && lane < kCols && j < d;
        const int64_t gidx = (b * S + t) * d + j;
        float zx_v = 0.0f, ix_v = 0.0f, fx_v = 0.0f, ox_v = 0.0f;
        if (owner) {  // independent of h: issued before the staging
          zx_v = __ldg(a.zx + gidx);
          ix_v = __ldg(a.ix + gidx);
          fx_v = __ldg(a.fx + gidx);
          ox_v = __ldg(a.ox + gidx);
        }
        float acc[kCols];
        coop_dots<false>(hp, hstride, r0, rows, base == 0, active, rl, gi, j0, lane, h_s, rw_s,
                         a.rw, a.rw_resident, a.chunk, d, acc);
        if (owner) {
          const float dot = lane_column(acc, lane);
          const int64_t sidx = b * d + j;
          const float c_prev = t == 0 ? a.c0[sidx] : a.c[sidx];
          const float n_prev = t == 0 ? a.n0[sidx] : a.n[sidx];
          const float m_prev = t == 0 ? a.m0[sidx] : a.m[sidx];
          const float z = tanhf(__fadd_rn(zx_v, dot));
          const float lf = log_sigmoid(fx_v);
          const float lfm = __fadd_rn(lf, m_prev);
          const float m_new = max_nan(lfm, ix_v);
          const float i_p = expf(__fsub_rn(ix_v, m_new));
          const float f_p = expf(__fsub_rn(lfm, m_new));
          const float c_new = __fadd_rn(__fmul_rn(f_p, c_prev), __fmul_rn(i_p, z));
          const float n_new = __fadd_rn(__fmul_rn(f_p, n_prev), i_p);
          const float h_new = __fdiv_rn(__fmul_rn(sigmoid(ox_v), c_new), max_nan(n_new, 1.0f));
          a.hs[gidx] = h_new;
          a.c[sidx] = c_new;
          a.n[sidx] = n_new;
          a.m[sidx] = m_new;
          if (t + 1 == S) a.h[sidx] = h_new;
          if (a.cs) {
            a.cs[gidx] = c_new;
            a.ns[gidx] = n_new;
            a.ms[gidx] = m_new;
            a.zs[gidx] = z;
          }
        }
      }
    }
    if (t + 1 < S) grid.sync();  // hs[:, t] whole before any block reads it
  }
}

// The backward in the cooperative layout: iteration s runs step t = S-1-s
// (its products read dz_pre,t+1 from dzx[:, t+1], written in iteration s - 1),
// and iteration S the products alone: dz_pre,0 @ rw^T, the entering h's
// gradient. dc, dn, dm carry in the output state.
template <bool kFloor>
__global__ void __launch_bounds__(kThreads) slstm_scan_bwd_kernel(BwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int64_t B = a.B, S = a.S, d = a.d;
  if (kFloor) {  // the serial floor: the launch and its barriers, no arithmetic
    for (int64_t s = 0; s < S; ++s) grid.sync();
    return;
  }
  extern __shared__ float smem[];
  float* x_s = smem;                                           // [rows][chunk]
  float* rw_s = smem + static_cast<size_t>(a.rows) * a.chunk;  // [my_groups][kCols][d]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int my_groups = (a.groups - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  if (a.rw_resident) load_columns<true>(rw_s, a.rw, d, my_groups);

  for (int64_t s = 0; s <= S; ++s) {
    const int64_t t = S - 1 - s;
    const float* xp = a.dzx + (t + 1) * d;  // dz_pre,t+1 of row b at xp + b * S * d (s > 0)
    for (int64_t r0 = 0; r0 < B; r0 += a.rows) {
      const int rows = static_cast<int>(B - r0 < a.rows ? B - r0 : a.rows);
      const int items = rows * my_groups;
      for (int base = 0; base < items; base += kWarps) {  // uniform across the block
        const int item = base + warp;
        const bool active = item < items;
        const int rl = active ? item % rows : 0;
        const int gi = active ? item / rows : 0;
        const int64_t b = r0 + rl;
        const int64_t j0 = (blockIdx.x + static_cast<int64_t>(gi) * gridDim.x) * kCols;
        const int64_t j = j0 + lane;
        const bool owner = active && lane < kCols && j < d;
        const int64_t sidx = b * d + j;
        const int64_t gidx = (b * S + t) * d + j;
        float ix = 0.0f, fx = 0.0f, ox = 0.0f, gin = 0.0f, c = 0.0f, n = 0.0f, m = 0.0f,
              z = 0.0f, c_prev = 0.0f, n_prev = 0.0f, m_prev = 0.0f;
        if (owner && s < S) {  // independent of the gradient: issued before the staging
          ix = __ldg(a.ix + gidx);
          fx = __ldg(a.fx + gidx);
          ox = __ldg(a.ox + gidx);
          if (a.dhs) gin = __ldg(a.dhs + gidx);
          c = __ldg(a.cs + gidx);
          n = __ldg(a.ns + gidx);
          m = __ldg(a.ms + gidx);
          z = __ldg(a.zs + gidx);
          c_prev = t > 0 ? __ldg(a.cs + gidx - d) : a.c0[sidx];
          n_prev = t > 0 ? __ldg(a.ns + gidx - d) : a.n0[sidx];
          m_prev = t > 0 ? __ldg(a.ms + gidx - d) : a.m0[sidx];
        }
        float acc[kCols];
        if (s > 0) {
          coop_dots<true>(xp, S * d, r0, rows, base == 0, active, rl, gi, j0, lane, x_s, rw_s,
                          a.rw, a.rw_resident, a.chunk, d, acc);
        }
        if (!owner) continue;
        const float dot = s > 0 ? lane_column(acc, lane) : 0.0f;
        if (s == S) {
          a.dh[sidx] = dot;
          continue;
        }
        // dh_t = dhs_t + (the final h's gradient at t = S-1, else dz_pre,t+1 @ rw^T).
        const float carry = s == 0 ? (a.dhT ? a.dhT[sidx] : 0.0f) : dot;
        float dc = s == 0 ? (a.dcT ? a.dcT[sidx] : 0.0f) : a.dc[sidx];
        float dn = s == 0 ? (a.dnT ? a.dnT[sidx] : 0.0f) : a.dn[sidx];
        float dm = s == 0 ? (a.dmT ? a.dmT[sidx] : 0.0f) : a.dm[sidx];
        const StepTerms k = step_terms(ix, fx, ox, c, n, m, z, m_prev);
        const float g = a.dhs ? __fadd_rn(gin, carry) : carry;
        float dq, dcp, dix, dfx, dox;
        a.dzx[gidx] = step_chain(k, g, dc, dq, dcp);
        step_rest(k, g, dq, dcp, ix, c, z, c_prev, n_prev, n, dc, dn, dm, dix, dfx, dox);
        a.dix[gidx] = dix;
        a.dfx[gidx] = dfx;
        a.dox[gidx] = dox;
        a.dc[sidx] = dc;
        a.dn[sidx] = dn;
        a.dm[sidx] = dm;
      }
    }
    if (s < S) grid.sync();  // dzx[:, t] whole before any block reads it
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The address of shared address `a` in block `rank` of the cluster.
__device__ __forceinline__ unsigned mapa(unsigned a, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

// One arrival that also expects `bytes` more of stores before the phase ends.
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// Stores into a peer's shared memory that, on landing, count their bytes on
// the peer's mbarrier (both addresses in the cluster's window).
__device__ __forceinline__ void st_async(unsigned addr, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

__device__ __forceinline__ void st_async4(unsigned addr, const float (&v)[4], unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
               "{%1, %2, %3, %4}, [%5];\n"
               ::"r"(addr), "r"(__float_as_uint(v[0])), "r"(__float_as_uint(v[1])),
               "r"(__float_as_uint(v[2])), "r"(__float_as_uint(v[3])), "r"(bar) : "memory");
}

// Dynamic shared bytes of a cluster-layout block: two mbarriers (16 bytes)
// and h (dz_pre in the backward) double-buffered [2][R][kMaxClusterD] (every
// row padded to the kernel's widest, zeros past d: a lane's loads need no
// bound), float32.
__host__ __device__ inline size_t cluster_smem(int R) {
  return 16 + 8 * static_cast<size_t>(R) * kMaxClusterD;
}

// kRows rows of a warp's dot products: row rr of h_{t-1} at
// hr + rr * kMaxClusterD. Lane l sums k = 4 l + 128 i + e (i < 6, e < 4), one
// 16-byte load a row and i, in ascending order for the warp's 4 columns (past
// d both h and w are 0); a reduce-scatter over the lanes (a + b == b + a, so
// every lane of a group holds the same bits) then leaves in lane l column
// l >> 3's sum, sum[rr].
template <int kRows>
__device__ __forceinline__ void cluster_dots(const float* hr, int lane,
                                             const float (&w)[kWarpCols][kLaneK],
                                             float (&sum)[kRows]) {
  float acc[kRows][kWarpCols];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
#pragma unroll
    for (int q = 0; q < kWarpCols; ++q) acc[rr][q] = 0.0f;
  }
  hr += 4 * lane;
#pragma unroll
  for (int i = 0; i < kLaneK / 4; ++i) {
    float4 hv[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      hv[rr] = *reinterpret_cast<const float4*>(hr + rr * kMaxClusterD + 128 * i);
    }
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const float h4[4] = {hv[rr].x, hv[rr].y, hv[rr].z, hv[rr].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int q = 0; q < kWarpCols; ++q) acc[rr][q] = fmaf(h4[e], w[q][4 * i + e], acc[rr][q]);
      }
    }
  }
  const bool hi16 = lane & 16, hi8 = lane & 8;
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    float k0 = hi16 ? acc[rr][2] : acc[rr][0];
    float k1 = hi16 ? acc[rr][3] : acc[rr][1];
    const float s0 = hi16 ? acc[rr][0] : acc[rr][2];
    const float s1 = hi16 ? acc[rr][1] : acc[rr][3];
    k0 = __fadd_rn(k0, __shfl_xor_sync(0xffffffffu, s0, 16));
    k1 = __fadd_rn(k1, __shfl_xor_sync(0xffffffffu, s1, 16));
    float v = hi8 ? k1 : k0;
    const float sv = hi8 ? k0 : k1;
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, sv, 8));
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
    sum[rr] = v;
  }
}

// Row r's sum of this lane's column over the buffer's nr rows (hc: row 0),
// two rows a pass.
__device__ __forceinline__ float cluster_row_dot(const float* hc, int nr, int r, int lane,
                                                 const float (&w)[kWarpCols][kLaneK]) {
  float dot = 0.0f;
  int rr = 0;
  for (; rr + 2 <= nr; rr += 2) {
    float sum[2];
    cluster_dots<2>(hc + rr * kMaxClusterD, lane, w, sum);
    if (r == rr) dot = sum[0];
    if (r == rr + 1) dot = sum[1];
  }
  if (rr < nr) {
    float sum[1];
    cluster_dots<1>(hc + rr * kMaxClusterD, lane, w, sum);
    if (r == rr) dot = sum[0];
  }
  return dot;
}

// The warp's 4 columns (from c0 + 4 warp) of every row into every block's
// buffer at shared address `buf`, this one's too: one 16-byte store a (row,
// block) spread over the lanes, each value shuffled from the lane that holds
// it (8 q + row), each landing counted on the receiver's mbarrier `bar`.
__device__ __forceinline__ void cluster_send(float v_lane, unsigned buf, unsigned bar, int C,
                                             int nr, int c0, int wc, int warp, int lane) {
  const int cols = wc - warp * kWarpCols < kWarpCols ? wc - warp * kWarpCols : kWarpCols;
  const int pairs = C * nr;
  for (int e0 = 0; e0 < pairs; e0 += 32) {
    const int e = e0 + lane;
    const int rr = e / C, p = e - rr * C;
    float v[kWarpCols];
#pragma unroll
    for (int q = 0; q < kWarpCols; ++q) {
      v[q] = __shfl_sync(0xffffffffu, v_lane, 8 * q + (rr & 7));
    }
    if (e < pairs) {
      const unsigned la = buf + 4u * (rr * kMaxClusterD + c0 + warp * kWarpCols);
      const unsigned rb = mapa(bar, p);
      if (cols == kWarpCols) {
        st_async4(mapa(la, p), v, rb);
      } else {
        for (int q = 0; q < cols; ++q) st_async(mapa(la + 4u * q, p), v[q], rb);
      }
    }
  }
}

// The backward's exchange, phased by row: each row of a cluster has its own
// pair of buffers and of mbarriers. Dynamic shared bytes of a block: the
// mbarriers ([2][R], 8 bytes each) and dz_pre ([2][R][kMaxClusterD], zeros
// past d), float32.
__host__ __device__ inline size_t cluster_bwd_smem(int R) {
  return 16 * static_cast<size_t>(R) + 8 * static_cast<size_t>(R) * kMaxClusterD;
}

// Row r's value of the warp's 4 columns (from c0 + 4 warp; lane 8 q + r
// holds column q's) into every block's row buffer at shared address `buf`,
// this one's too: lane p < C stores one 16-byte st.async into block p,
// counted on that block's mbarrier `bar` (row r's of the buffer).
__device__ __forceinline__ void cluster_send_row(float v_lane, unsigned buf, unsigned bar, int C,
                                                 int r, int c0, int wc, int warp, int lane) {
  const int cols = wc - warp * kWarpCols < kWarpCols ? wc - warp * kWarpCols : kWarpCols;
  float v[kWarpCols];
#pragma unroll
  for (int q = 0; q < kWarpCols; ++q) v[q] = __shfl_sync(0xffffffffu, v_lane, 8 * q + r);
  if (lane < C) {
    const unsigned la = buf + 4u * (c0 + warp * kWarpCols);
    const unsigned rb = mapa(bar, lane);
    if (cols == kWarpCols) {
      st_async4(mapa(la, lane), v, rb);
    } else {
      for (int q = 0; q < cols; ++q) st_async(mapa(la + 4u * q, lane), v[q], rb);
    }
  }
}

template <bool kFloor>
__global__ void __launch_bounds__(kCThreads, 1) slstm_scan_cluster_kernel(ClusterArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int d = a.d, W = a.W, R = a.R, C = a.C;
  constexpr int dp = kMaxClusterD;  // h's row stride in shared memory
  const int64_t S = a.S;
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t r0 = static_cast<int64_t>(blockIdx.x / C) * R;
  const int nr = static_cast<int>(a.B - r0 < R ? a.B - r0 : R);  // <= kMaxClusterRows
  // The column split: block c owns W columns from c W (W = ceil(d / C) rounded
  // up to 4, so every slice starts 16-byte aligned), the last block the rest.
  const int c0 = rank * W < d ? rank * W : d;
  const int wc = (d - c0 < W ? d - c0 : W);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // Lane l of warp w updates row l % 8 and column 4 w + l / 8, the whole loop.
  const int r = lane & 7;
  const int jl = warp * kWarpCols + (lane >> 3);
  const bool mine = r < nr && jl < wc;
  // A warp with no column neither reads h nor is waited for: it idles.
  const bool reader = warp * kWarpCols < wc;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const unsigned bars = smem_u32(smem_raw);                        // [2] mbarriers
  float* hbuf = reinterpret_cast<float*>(smem_raw + 16);           // [2][R][kMaxClusterD]
  const unsigned h_u32 = smem_u32(hbuf);
  const unsigned phase_bytes = 4u * nr * d;  // all of h_t's rows, from every block

  float w[kWarpCols][kLaneK];  // rw[k][c0 + 4 warp + q], k = 4 lane + 128 i + e at [q][4 i + e]
  if (!kFloor) {
#pragma unroll
    for (int i = 0; i < kLaneK; ++i) {
      const int k = 4 * lane + 128 * (i / 4) + i % 4;
#pragma unroll
      for (int q = 0; q < kWarpCols; ++q) {
        const int j = warp * kWarpCols + q;
        w[q][i] = (k < d && j < wc) ? __ldg(a.rw + static_cast<int64_t>(k) * d + c0 + j) : 0.0f;
      }
    }
  }
  // Buffer 0 holds h_{-1}; the padding of both stays 0 (0 x 0 in the products).
  for (int e = threadIdx.x; e < 2 * R * dp; e += kCThreads) {
    const int rr = e / dp, k = e - rr * dp;
    hbuf[e] = rr < nr && k < d ? a.h0[(r0 + rr) * d + k] : 0.0f;
  }
  // h_t lands in buffer (t + 1) & 1 and completes that buffer's mbarrier;
  // each phase expects all of h_t.
  if (threadIdx.x == 0) {
    mbar_init(bars);
    mbar_init(bars + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(bars, phase_bytes);
    mbar_expect(bars + 8, phase_bytes);
  }
  // This lane's state, and its gates one step ahead: loaded a step before
  // they are used, off the chain.
  const int64_t sidx = (r0 + r) * d + c0 + jl;
  float c = 0.0f, n = 0.0f, m = 0.0f, h = 0.0f, zx = 0.0f, ix = 0.0f, fx = 0.0f, ox = 0.0f;
  if (!kFloor && mine) {
    c = a.c0[sidx];
    n = a.n0[sidx];
    m = a.m0[sidx];
    const int64_t g = (r0 + r) * S * d + c0 + jl;
    zx = __ldg(a.zx + g);
    ix = __ldg(a.ix + g);
    fx = __ldg(a.fx + g);
    ox = __ldg(a.ox + g);
  }
  cluster.sync();  // every block runs, its buffers and mbarriers ready, before any peer writes

  for (int64_t t = 0; t < S; ++t) {
    if (!reader) continue;
    const int cur = static_cast<int>(t & 1);
    // What does not need h, while h_{t-1} is on its way: the update's terms in
    // the gates and the state, and the next step's gates.
    float og = 0.0f, i_p = 0.0f, f_p = 0.0f, n_new = 0.0f, m_new = 0.0f, n_div = 1.0f;
    if (!kFloor && mine) {
      og = sigmoid(ox);
      const float lfm = __fadd_rn(log_sigmoid(fx), m);
      m_new = max_nan(lfm, ix);
      i_p = expf(__fsub_rn(ix, m_new));
      f_p = expf(__fsub_rn(lfm, m_new));
      n_new = __fadd_rn(__fmul_rn(f_p, n), i_p);
      n_div = max_nan(n_new, 1.0f);
    }
    const float zx_t = zx;
    if (!kFloor && mine && t + 1 < S) {
      const int64_t g = ((r0 + r) * S + t + 1) * d + c0 + jl;
      zx = __ldg(a.zx + g);
      ix = __ldg(a.ix + g);
      fx = __ldg(a.fx + g);
      ox = __ldg(a.ox + g);
    }
    if (t > 0) {  // h_{t-1}: the (t - 1) / 2-th phase of this buffer's mbarrier
      mbar_wait(bars + 8 * cur, static_cast<unsigned>((t - 1) >> 1) & 1u);
      if (threadIdx.x == 0) mbar_expect(bars + 8 * cur, phase_bytes);  // for h_{t+1}
    }
    // No block writes this buffer again before every reader of it here is
    // done: h_{t+1} is sent only once all of h_t arrived, and this block
    // sends its part of h_t after its reads.
    const float* hc = hbuf + cur * R * dp;
    // The floor keeps one read of h_{t-1} a lane, so the step still waits on it.
    const float dot = kFloor ? hc[(mine ? r : 0) * dp + (mine ? c0 + jl : c0)]
                             : cluster_row_dot(hc, nr, r, lane, w);
    float h_new = dot;
    if (!kFloor && mine) {
      const float z = tanhf(__fadd_rn(zx_t, dot));
      c = __fadd_rn(__fmul_rn(f_p, c), __fmul_rn(i_p, z));
      n = n_new;
      m = m_new;
      h_new = __fdiv_rn(__fmul_rn(og, c), n_div);
      h = h_new;
      const int64_t g = ((r0 + r) * S + t) * d + c0 + jl;
      a.hs[g] = h_new;
      if (a.cs) {
        a.cs[g] = c;
        a.ns[g] = n;
        a.ms[g] = m;
        a.zs[g] = z;
      }
    }
    if (t + 1 < S) {
      cluster_send(h_new, h_u32 + 4u * (cur ^ 1) * R * dp, bars + 8 * (cur ^ 1), C, nr, c0, wc,
                   warp, lane);
    }
  }
  if (!kFloor && mine) {
    a.c[sidx] = c;
    a.n[sidx] = n;
    a.h[sidx] = h;
    a.m[sidx] = m;
  }
  cluster.sync();  // no block leaves while a peer may still write into it
}

// The rows of one buffer of the backward's exchange (rows at xc + rr
// kMaxClusterD, their mbarriers at bar0 + 8 rr), each at its phase of
// parity `parity`, two at a time: lane row r's sum for its column (the
// floor: one read of column `col` a lane, so the step still waits on it).
// Where `rearm`, each mbarrier is armed for its next phase once waited for.
// No block writes a row's buffer again before every reader of it is done:
// dz_pre,t[rr] is sent only once all of dz_pre,t+1[rr] has arrived, and each
// block sends its part after its own reads of that buffer.
template <bool kFloor>
__device__ __forceinline__ float bwd_row_dots(const float* xc, unsigned bar0, int nr,
                                              unsigned parity, bool rearm, unsigned row_bytes,
                                              int r, int col, int lane,
                                              const float (&w)[kWarpCols][kLaneK]) {
  float dot = 0.0f;
  for (int rr = 0; rr < nr; rr += 2) {
    const bool two = rr + 1 < nr;
    const unsigned bar = bar0 + 8 * rr;
    mbar_wait(bar, parity);
    if (two) mbar_wait(bar + 8, parity);
    if (rearm && threadIdx.x == 0) {
      mbar_expect(bar, row_bytes);
      if (two) mbar_expect(bar + 8, row_bytes);
    }
    if (kFloor) {
      if (r == rr || r == rr + 1) dot = xc[(r < nr ? r : 0) * kMaxClusterD + col];
    } else if (two) {
      float sum[2];
      cluster_dots<2>(xc + rr * kMaxClusterD, lane, w, sum);
      if (r == rr) dot = sum[0];
      if (r == rr + 1) dot = sum[1];
    } else {
      float sum[1];
      cluster_dots<1>(xc + rr * kMaxClusterD, lane, w, sum);
      if (r == rr) dot = sum[0];
    }
  }
  return dot;
}

// The backward's loop in the cluster layout: the chain alone. Block c holds
// rows J (its slice) of rw, that is rw^T's columns J, in registers as the
// forward holds rw's: lane l of warp w owns row l % 8 and column j = c0 +
// 4 w + l / 8 and computes dh_{t-1}[j] = sum_k dz_pre,t[k] rw[j][k].
// Iteration s runs step t = S-1-s: every warp waits for the rows of
// dz_pre,t+1 in buffer s & 1 two at a time and sums both rows' products
// together (cluster_dots<2>), the owner lanes of every row run the chain
// (dh_t, dq, dc', dz_pre,t, dc) and store dzx_t and dh_t, and the warp
// sends each row of dz_pre,t into that row's buffer (s + 1) & 1 of every
// block. A last wait after the loop gives the entering h's gradient. dn,
// dm, the gate gradients and the entering c, n, m's are the rest kernel's.
template <bool kFloor>
__global__ void __launch_bounds__(kCThreads, 1) slstm_scan_bwd_cluster_kernel(BwdArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int d = static_cast<int>(a.d), W = a.W, R = a.R, C = a.C;
  constexpr int dp = kMaxClusterD;
  const int64_t S = a.S;
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t r0 = static_cast<int64_t>(blockIdx.x / C) * R;
  const int nr = static_cast<int>(a.B - r0 < R ? a.B - r0 : R);
  const int c0 = rank * W < d ? rank * W : d;
  const int wc = (d - c0 < W ? d - c0 : W);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = lane & 7;
  const int jl = warp * kWarpCols + (lane >> 3);
  const bool mine = r < nr && jl < wc;
  const bool reader = warp * kWarpCols < wc;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Row rr of buffer p: its mbarrier at bars + 8 (p R + rr), its floats at
  // xbuf + (p R + rr) dp; each phase expects that row of dz_pre from every
  // block (4 d bytes).
  const unsigned bars = smem_u32(smem_raw);
  float* xbuf = reinterpret_cast<float*>(smem_raw + 16 * R);
  const unsigned x_u32 = smem_u32(xbuf);
  const unsigned row_bytes = 4u * d;

  float w[kWarpCols][kLaneK];  // rw[c0 + 4 warp + q][k], k = 4 lane + 128 i + e at [q][4 i + e]
  if (!kFloor) {
#pragma unroll
    for (int i = 0; i < kLaneK; ++i) {
      const int k = 4 * lane + 128 * (i / 4) + i % 4;
#pragma unroll
      for (int q = 0; q < kWarpCols; ++q) {
        const int j = warp * kWarpCols + q;
        w[q][i] = (k < d && j < wc) ? __ldg(a.rw + static_cast<int64_t>(c0 + j) * d + k) : 0.0f;
      }
    }
  }
  for (int e = threadIdx.x; e < 2 * R * dp; e += kCThreads) xbuf[e] = 0.0f;  // padding stays 0
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * R; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int p = 0; p < 2; ++p) {
      for (int rr = 0; rr < nr; ++rr) mbar_expect(bars + 8 * (p * R + rr), row_bytes);
    }
  }
  const int col = mine ? c0 + jl : c0;  // the column the floor reads
  // This lane's carried dc and dh_t's carry; what the chain reads of its
  // step t: gates, dhs, z, n, m, and m of step t - 1 (mp: the entering m at
  // t = 0), each loaded a step ahead.
  const int64_t sidx = (r0 + r) * d + c0 + jl;
  const int64_t g0 = (r0 + r) * S * d + c0 + jl;  // (row, step 0, column)
  float dc = 0.0f, carry = 0.0f;
  float ix = 0.0f, fx = 0.0f, ox = 0.0f, gin = 0.0f, z = 0.0f, n = 0.0f, m = 0.0f, mp = 0.0f;
  if (!kFloor && mine) {
    if (a.dcT) dc = a.dcT[sidx];
    if (a.dhT) carry = a.dhT[sidx];
    const int64_t g = g0 + (S - 1) * d;
    ix = __ldg(a.ix + g);
    fx = __ldg(a.fx + g);
    ox = __ldg(a.ox + g);
    if (a.dhs) gin = __ldg(a.dhs + g);
    z = __ldg(a.zs + g);
    n = __ldg(a.ns + g);
    m = __ldg(a.ms + g);
    mp = S > 1 ? __ldg(a.ms + g - d) : a.m0[sidx];
  }
  cluster.sync();  // every block runs, its buffers and mbarriers ready, before any peer writes

  for (int64_t s = 0; s < S && reader; ++s) {
    const int64_t t = S - 1 - s;
    const int cur = static_cast<int>(s & 1);
    // What the chain reads and needs no gradient, while dz_pre,t+1 is on
    // its way; then step t - 1's values.
    ChainTerms k{};
    if (!kFloor && mine) k = chain_terms(ix, fx, ox, n, m, z, mp);
    float nix = 0.0f, nfx = 0.0f, nox = 0.0f, ngin = 0.0f, nz = 0.0f, nn = 0.0f, nmp = 0.0f;
    if (!kFloor && mine && t > 0) {
      const int64_t g = g0 + (t - 1) * d;
      nix = __ldg(a.ix + g);
      nfx = __ldg(a.fx + g);
      nox = __ldg(a.ox + g);
      if (a.dhs) ngin = __ldg(a.dhs + g);
      nz = __ldg(a.zs + g);
      nn = __ldg(a.ns + g);
      nmp = t > 1 ? __ldg(a.ms + g - d) : a.m0[sidx];
    }
    // dz_pre,t+1: the (s - 1) / 2-th phase of buffer s & 1's mbarriers.
    if (s > 0) {
      carry = bwd_row_dots<kFloor>(xbuf + cur * R * dp, bars + 8 * cur * R, nr,
                                   static_cast<unsigned>((s - 1) >> 1) & 1u, true, row_bytes, r,
                                   col, lane, w);
    }
    float da = carry;
    if (!kFloor && mine) {
      const float g = a.dhs ? __fadd_rn(gin, carry) : carry;
      float dq, dcp;
      da = step_chain(k, g, dc, dq, dcp);
      dc = __fmul_rn(dcp, k.f_p);
      a.dzx[g0 + t * d] = da;
      a.gs[g0 + t * d] = g;
    }
    const int nxt = cur ^ 1;
    for (int rr = 0; rr < nr; ++rr) {
      cluster_send_row(da, x_u32 + 4u * (nxt * R + rr) * dp, bars + 8 * (nxt * R + rr), C, rr, c0,
                       wc, warp, lane);
    }
    ix = nix;
    fx = nfx;
    ox = nox;
    gin = ngin;
    z = nz;
    n = nn;
    m = mp;
    mp = nmp;
  }
  if (reader) {  // dz_pre,0 @ rw^T: the entering h's gradient
    const int last = static_cast<int>(S & 1);
    const float dh = bwd_row_dots<kFloor>(xbuf + last * R * dp, bars + 8 * last * R, nr,
                                          static_cast<unsigned>((S - 1) >> 1) & 1u, false,
                                          row_bytes, r, col, lane, w);
    if (!kFloor && mine) a.dh[sidx] = dh;
  }
  cluster.sync();  // no block leaves while a peer may still write into it
}

// The rest of the backward in the cluster layout, after its loop, from its
// dh_t (gs). dc, dn and dm are recurrences of one (row, column) each, so no
// step waits on another column; but a step's terms (five exponentials or
// logarithms, five quotients) outweigh its recurrences (some twenty
// products and sums), so they run apart. A block takes kRestCols columns of
// one row: kRestWarps producer warps compute the terms of a chunk of
// kRestChunk steps (lane: column; each warp kRestItems steps), store dox_t
// and leave what the recurrences read (RestTerms) in shared memory; one
// warp more runs the recurrences over the previous chunk (dix_t, dfx_t, and
// at the end the entering dc, dn, dm). Two buffers, one block barrier a
// chunk. Each producer loads its next chunk's values before the barrier.
// Every value rounds as in step_terms, step_chain and step_rest, so the
// outputs keep the cooperative kernel's bits.
constexpr int kRestCols = 16;                          // columns a block
constexpr int kRestLaneSteps = 32 / kRestCols;         // steps a producer warp takes at once
constexpr int kRestWarps = 8;
constexpr int kRestChunk = 16;
constexpr int kRestItems = kRestChunk / (kRestWarps * kRestLaneSteps);
constexpr int kRestThreads = 32 * (kRestWarps + 1);

// Step t's values of the (row, column) whose step 0 is at g0, and the state
// of step t - 1 (at t = 0 the entering one, at sidx); nothing before step 0.
struct RestIn {
  float ix, fx, ox, g, z, c, n, m, cp, np, mp;
};

__device__ __forceinline__ RestIn rest_in(const BwdArgs& a, int64_t g0, int64_t sidx, int64_t t) {
  RestIn v{};
  if (t < 0) return v;
  const int64_t g = g0 + t * a.d;
  v.ix = __ldg(a.ix + g);
  v.fx = __ldg(a.fx + g);
  v.ox = __ldg(a.ox + g);
  v.g = __ldg(a.gs + g);
  v.z = __ldg(a.zs + g);
  v.c = __ldg(a.cs + g);
  v.n = __ldg(a.ns + g);
  v.m = __ldg(a.ms + g);
  v.cp = t > 0 ? __ldg(a.cs + g - a.d) : a.c0[sidx];
  v.np = t > 0 ? __ldg(a.ns + g - a.d) : a.n0[sidx];
  v.mp = t > 0 ? __ldg(a.ms + g - a.d) : a.m0[sidx];
  return v;
}

__global__ void __launch_bounds__(kRestThreads) slstm_scan_bwd_rest_kernel(BwdArgs a) {
  __shared__ float terms[2][8][kRestChunk][kRestCols];  // RestTerms' floats by field
  __shared__ int ties[2][kRestChunk][kRestCols];
  const int64_t S = a.S, d = a.d;
  const int64_t col_blocks = (d + kRestCols - 1) / kRestCols;
  const int64_t b = blockIdx.x / col_blocks;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int cl = lane % kRestCols;  // the lane's column; its producer step: u0 + lane / kRestCols
  const int u0 = warp * kRestLaneSteps + lane / kRestCols;
  const int64_t j = (blockIdx.x - b * col_blocks) * kRestCols + cl;
  const bool col = j < d;
  const bool chain = warp == kRestWarps && lane < kRestCols && col;  // runs the recurrences
  const int64_t sidx = b * d + j;
  const int64_t g0 = b * S * d + j;  // (row, step 0, column)
  const int64_t chunks = (S + kRestChunk - 1) / kRestChunk;
  // Chunk ch holds steps t = S-1 - ch kRestChunk - u, u < kRestChunk; a
  // producer lane's item i is u = u0 + kRestWarps kRestLaneSteps i.
  RestIn in[kRestItems];
  if (warp < kRestWarps && col) {
#pragma unroll
    for (int i = 0; i < kRestItems; ++i) {
      in[i] = rest_in(a, g0, sidx, S - 1 - u0 - kRestWarps * kRestLaneSteps * i);
    }
  }
  float dc = 0.0f, dn = 0.0f, dm = 0.0f;
  if (chain) {
    if (a.dcT) dc = a.dcT[sidx];
    if (a.dnT) dn = a.dnT[sidx];
    if (a.dmT) dm = a.dmT[sidx];
  }
  for (int64_t ch = 0; ch <= chunks; ++ch) {
    const int buf = static_cast<int>(ch & 1);
    if (warp < kRestWarps) {
      if (ch < chunks && col) {
#pragma unroll
        for (int i = 0; i < kRestItems; ++i) {
          const int u = u0 + kRestWarps * kRestLaneSteps * i;
          const int64_t t = S - 1 - ch * kRestChunk - u;
          if (t >= 0) {
            const RestIn& v = in[i];
            const StepTerms k = step_terms(v.ix, v.fx, v.ox, v.c, v.n, v.m, v.z, v.mp);
            const float dq = __fdiv_rn(v.g, k.nd);  // step_chain's
            a.dox[g0 + t * d] = step_dox(k, dq, v.c);
            const RestTerms r = rest_terms(k, v.g, dq, v.ix, v.z, v.cp, v.np, v.n);
            const float f[8] = {r.dqo, r.a, r.z, r.c_prev, r.n_prev, r.f_p, r.i_p, r.lsg};
#pragma unroll
            for (int e = 0; e < 8; ++e) terms[buf][e][u][cl] = f[e];
            ties[buf][u][cl] = r.tie;
          }
          in[i] = rest_in(a, g0, sidx, t - kRestChunk);  // this item of the next chunk
        }
      }
    } else if (ch > 0 && chain) {  // the recurrences over the previous chunk
      const int pb = buf ^ 1;
      for (int u = 0; u < kRestChunk; ++u) {
        const int64_t t = S - 1 - (ch - 1) * kRestChunk - u;
        if (t < 0) break;
        RestTerms r;
        r.dqo = terms[pb][0][u][cl];
        r.a = terms[pb][1][u][cl];
        r.z = terms[pb][2][u][cl];
        r.c_prev = terms[pb][3][u][cl];
        r.n_prev = terms[pb][4][u][cl];
        r.f_p = terms[pb][5][u][cl];
        r.i_p = terms[pb][6][u][cl];
        r.lsg = terms[pb][7][u][cl];
        r.tie = ties[pb][u][cl];
        float dix, dfx;
        rest_carry(r, __fadd_rn(dc, r.dqo), dc, dn, dm, dix, dfx);
        a.dix[g0 + t * d] = dix;
        a.dfx[g0 + t * d] = dfx;
      }
    }
    __syncthreads();  // chunk ch's terms whole; chunk ch - 1's buffer free
  }
  if (chain) {
    a.dc[sidx] = dc;
    a.dn[sidx] = dn;
    a.dm[sidx] = dm;
  }
}

// The cooperative plan of `kernel` (its floor `floor_kernel` shares it) at
// (B, d): the grid, column groups, the staging, rw's residence, the shared
// bytes, and the occupancy that every block's residence needs.
int make_plan(int device, int64_t B, int64_t d, const void* kernel, const void* floor_kernel,
              Plan* p) {
  int coop = 0, smem_optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&p->sms, cudaDevAttrMultiProcessorCount,
                                                       device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(
      &smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  const int64_t groups = (d + kCols - 1) / kCols;
  if (groups > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p->groups = static_cast<int>(groups);
  p->grid = p->groups < p->sms ? p->groups : p->sms;
  p->groups_per_block = (p->groups + p->grid - 1) / p->grid;
  const int64_t chunk = ((d + 31) / 32) * 32;
  p->chunk = static_cast<int>(chunk < kMaxChunk ? chunk : kMaxChunk);
  const int64_t rows = kStageFloats / p->chunk;
  p->rows = static_cast<int>(rows < B ? rows : B);
  const size_t h_bytes = static_cast<size_t>(p->rows) * p->chunk * sizeof(float);
  const size_t rw_bytes = static_cast<size_t>(p->groups_per_block) * kCols * d * sizeof(float);
  p->rw_resident = h_bytes + rw_bytes <= static_cast<size_t>(smem_optin);
  p->smem = h_bytes + (p->rw_resident ? rw_bytes : 0);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(p->smem));
  if (err == cudaSuccess) err = cudaFuncSetAttribute(
      floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p->smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p->blocks_per_sm, kernel, kThreads,
                                                      p->smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Every block must be resident for grid.sync(): at most one a SM here.
  if (p->blocks_per_sm < 1 || p->grid > p->blocks_per_sm * p->sms) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  return 0;
}

const void* forward_kernel(bool floor) {
  return floor ? reinterpret_cast<const void*>(slstm_scan_kernel<true>)
               : reinterpret_cast<const void*>(slstm_scan_kernel<false>);
}

const void* backward_kernel(bool floor) {
  return floor ? reinterpret_cast<const void*>(slstm_scan_bwd_kernel<true>)
               : reinterpret_cast<const void*>(slstm_scan_bwd_kernel<false>);
}

// A cluster kernel's attributes for a launch of `smem` dynamic bytes, and
// its launch configuration: `clusters` clusters of C blocks.
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, int C, size_t smem, int64_t clusters,
                           cudaStream_t stream, cudaLaunchAttribute* attr,
                           cudaLaunchConfig_t* cfg) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                                         1);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(clusters * C));
  cfg->blockDim = dim3(kCThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// Launches `kernel` (either direction, its arguments `a`, `smem` dynamic
// shared bytes a block) in clusters of C blocks over ceil(B / R) groups of
// rows.
template <typename Kernel, typename A>
int launch_cluster(int device, Kernel kernel, const A& a, int64_t B, int64_t d, int C, int R,
                   int W, size_t smem, cudaStream_t stream) {
  if (C < 1 || C > kMaxCluster || R < 1 || R > kMaxClusterRows || d > kMaxClusterD ||
      W > kMaxWidth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int smem_optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                           device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t clusters = (B + R - 1) / R;
  if (smem > static_cast<size_t>(smem_optin) || clusters * C > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  err = cluster_config(kernel, C, smem, clusters, stream, &attr, &cfg);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int slice_width(int64_t d, int C) { return static_cast<int>(((d + C - 1) / C + 3) / 4 * 4); }

}  // namespace

// Launches the recurrence on `stream` (no synchronisation) in `layout` (0
// cooperative, 1 cluster: `clusters` = ceil(B / R) clusters of C blocks, R
// rows each): the kernel (serial_floor 0) or its serial floor (serial_floor
// 1: the same launch, its barriers and, in the cluster layout, the h
// exchange alone). Inputs zx, ix, fx, ox (B, S, d), rw (d, d) and the
// entering state c0, n0, h0, m0 (B, d); outputs hs (B, S, d) and the state
// c, n, h, m (B, d), and, where cs is not null, every step's c, n, m and z
// into cs, ns, ms, zs (B, S, d; all four or none); all float32, contiguous,
// the outputs apart from the inputs. Returns a cudaError_t code: 0 on
// success (cudaErrorNotSupported where the device has no cooperative launch,
// cudaErrorCooperativeLaunchTooLarge where the cooperative grid cannot be
// resident, cudaErrorInvalidValue for a cluster plan the kernel cannot
// take). Empty inputs launch nothing.
extern "C" int slstm_scan_launch(int device, const void* zx, const void* ix, const void* fx,
                                 const void* ox, const void* rw, const void* c0, const void* n0,
                                 const void* h0, const void* m0, void* hs, void* c, void* n,
                                 void* h, void* m, void* cs, void* ns, void* ms, void* zs,
                                 long long B, long long S, long long d, int layout, int C, int R,
                                 int serial_floor, void* stream) {
  if (B <= 0 || S <= 0 || d <= 0) return 0;
  if ((cs == nullptr) != (ns == nullptr) || (cs == nullptr) != (ms == nullptr) ||
      (cs == nullptr) != (zs == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layout == kLayoutCluster) {
    if (C < 1 || d > kMaxClusterD) return static_cast<int>(cudaErrorInvalidValue);
    const int W = slice_width(d, C);
    const ClusterArgs a{static_cast<const float*>(zx), static_cast<const float*>(ix),
                        static_cast<const float*>(fx), static_cast<const float*>(ox),
                        static_cast<const float*>(rw), static_cast<const float*>(c0),
                        static_cast<const float*>(n0), static_cast<const float*>(h0),
                        static_cast<const float*>(m0), static_cast<float*>(hs),
                        static_cast<float*>(c), static_cast<float*>(n), static_cast<float*>(h),
                        static_cast<float*>(m), static_cast<float*>(cs), static_cast<float*>(ns),
                        static_cast<float*>(ms), static_cast<float*>(zs), B, S,
                        static_cast<int>(d), C, R, W};
    const size_t smem = cluster_smem(R);
    return serial_floor ? launch_cluster(device, slstm_scan_cluster_kernel<true>, a, B, d, C, R,
                                         W, smem, st)
                        : launch_cluster(device, slstm_scan_cluster_kernel<false>, a, B, d, C, R,
                                         W, smem, st);
  }
  if (layout != kLayoutCooperative) return static_cast<int>(cudaErrorInvalidValue);
  Plan p{};
  int status = make_plan(device, B, d, forward_kernel(false), forward_kernel(true), &p);
  if (status != 0) return status;
  Args a{static_cast<const float*>(zx), static_cast<const float*>(ix),
         static_cast<const float*>(fx), static_cast<const float*>(ox),
         static_cast<const float*>(rw), static_cast<const float*>(c0),
         static_cast<const float*>(n0), static_cast<const float*>(h0),
         static_cast<const float*>(m0), static_cast<float*>(hs), static_cast<float*>(c),
         static_cast<float*>(n), static_cast<float*>(h), static_cast<float*>(m),
         static_cast<float*>(cs), static_cast<float*>(ns), static_cast<float*>(ms),
         static_cast<float*>(zs), B, S, d, p.groups, p.chunk, p.rows, p.rw_resident};
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(forward_kernel(serial_floor), dim3(p.grid), dim3(kThreads),
                                    params, p.smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Launches the backward on `stream` (no synchronisation) in `layout`, as
// slstm_scan_launch launches the forward (serial_floor 1: the same launch,
// its barriers or its dz_pre exchange alone). Inputs: the gradients dhs (B,
// S, d) and dcT, dnT, dhT, dmT (B, d) of the forward's outputs, each of them
// null for zero; ix, fx, ox (B, S, d), rw (d, d), the entering state c0, n0,
// m0 (B, d) and the forward's saved cs, ns, ms, zs (B, S, d). Outputs dzx,
// dix, dfx, dox (B, S, d) and the entering state's gradients dc, dn, dh, dm
// (B, d). The cooperative layout writes them all. The cluster layout's loop
// writes dzx, dh and every step's dh_t into gs (B, S, d); the rest
// (slstm_scan_bwd_rest_launch, from gs) the others. All float32 and
// contiguous. Returns a cudaError_t code as slstm_scan_launch does. Empty
// inputs launch nothing.
extern "C" int slstm_scan_bwd_launch(int device, const void* dhs, const void* dcT,
                                     const void* dnT, const void* dhT, const void* dmT,
                                     const void* ix, const void* fx, const void* ox,
                                     const void* rw, const void* c0, const void* n0,
                                     const void* m0, const void* cs, const void* ns,
                                     const void* ms, const void* zs, void* dzx, void* dix,
                                     void* dfx, void* dox, void* dc, void* dn, void* dh, void* dm,
                                     void* gs, long long B, long long S, long long d, int layout,
                                     int C, int R, int serial_floor, void* stream) {
  if (B <= 0 || S <= 0 || d <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  BwdArgs a{static_cast<const float*>(dhs), static_cast<const float*>(dcT),
            static_cast<const float*>(dnT), static_cast<const float*>(dhT),
            static_cast<const float*>(dmT), static_cast<const float*>(ix),
            static_cast<const float*>(fx), static_cast<const float*>(ox),
            static_cast<const float*>(rw), static_cast<const float*>(c0),
            static_cast<const float*>(n0), static_cast<const float*>(m0),
            static_cast<const float*>(cs), static_cast<const float*>(ns),
            static_cast<const float*>(ms), static_cast<const float*>(zs),
            static_cast<float*>(dzx), static_cast<float*>(dix), static_cast<float*>(dfx),
            static_cast<float*>(dox), static_cast<float*>(dc), static_cast<float*>(dn),
            static_cast<float*>(dh), static_cast<float*>(dm), static_cast<float*>(gs), B, S, d,
            0, 0, 0, 0, C, R, 0};
  if (layout == kLayoutCluster) {
    if (C < 1 || d > kMaxClusterD || (!serial_floor && gs == nullptr)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.W = slice_width(d, C);
    const size_t smem = cluster_bwd_smem(R);
    return serial_floor
               ? launch_cluster(device, slstm_scan_bwd_cluster_kernel<true>, a, B, d, C, R, a.W,
                                smem, st)
               : launch_cluster(device, slstm_scan_bwd_cluster_kernel<false>, a, B, d, C, R, a.W,
                                smem, st);
  }
  if (layout != kLayoutCooperative) return static_cast<int>(cudaErrorInvalidValue);
  Plan p{};
  int status = make_plan(device, B, d, backward_kernel(false), backward_kernel(true), &p);
  if (status != 0) return status;
  a.groups = p.groups;
  a.chunk = p.chunk;
  a.rows = p.rows;
  a.rw_resident = p.rw_resident;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(backward_kernel(serial_floor), dim3(p.grid), dim3(kThreads),
                                    params, p.smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Launches the rest of the cluster layout's backward on `stream` (no
// synchronisation): from every step's dh_t (gs, the loop's output) and the
// state after the last step's gradients dcT, dnT, dmT (each null: zero),
// with ix, fx, ox, the entering c0, n0, m0 and the saved cs, ns, ms, zs as
// slstm_scan_bwd_launch takes them, writes dix, dfx, dox (B, S, d) and the
// entering state's dc, dn, dm (B, d). One block a row's group of kRestCols
// columns. Returns a cudaError_t code. Empty inputs launch nothing.
extern "C" int slstm_scan_bwd_rest_launch(int device, const void* gs, const void* dcT,
                                          const void* dnT, const void* dmT, const void* ix,
                                          const void* fx, const void* ox, const void* c0,
                                          const void* n0, const void* m0, const void* cs,
                                          const void* ns, const void* ms, const void* zs,
                                          void* dix, void* dfx, void* dox, void* dc, void* dn,
                                          void* dm, long long B, long long S, long long d,
                                          void* stream) {
  if (B <= 0 || S <= 0 || d <= 0) return 0;
  const int64_t blocks = B * ((d + kRestCols - 1) / kRestCols);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  BwdArgs a{};
  a.dcT = static_cast<const float*>(dcT);
  a.dnT = static_cast<const float*>(dnT);
  a.dmT = static_cast<const float*>(dmT);
  a.ix = static_cast<const float*>(ix);
  a.fx = static_cast<const float*>(fx);
  a.ox = static_cast<const float*>(ox);
  a.c0 = static_cast<const float*>(c0);
  a.n0 = static_cast<const float*>(n0);
  a.m0 = static_cast<const float*>(m0);
  a.cs = static_cast<const float*>(cs);
  a.ns = static_cast<const float*>(ns);
  a.ms = static_cast<const float*>(ms);
  a.zs = static_cast<const float*>(zs);
  a.gs = static_cast<float*>(const_cast<void*>(gs));
  a.dix = static_cast<float*>(dix);
  a.dfx = static_cast<float*>(dfx);
  a.dox = static_cast<float*>(dox);
  a.dc = static_cast<float*>(dc);
  a.dn = static_cast<float*>(dn);
  a.dm = static_cast<float*>(dm);
  a.B = B;
  a.S = S;
  a.d = d;
  slstm_scan_bwd_rest_kernel<<<static_cast<unsigned>(blocks), kRestThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The cooperative layout's launch of a (B, d) call, into out[10]: grid,
// column groups, groups a block, k chunk, staged rows, rw resident (0/1),
// dynamic shared bytes, resident blocks a SM, registers and local (spilled)
// bytes a thread; of the forward (backward 0) or the backward (1).
extern "C" int slstm_scan_plan(int device, long long B, long long d, int backward,
                               long long* out) {
  if (B <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* kernel = backward ? backward_kernel(false) : forward_kernel(false);
  Plan p{};
  int status = make_plan(device, B, d, kernel, backward ? backward_kernel(true)
                                                        : forward_kernel(true), &p);
  if (status != 0) return status;
  cudaFuncAttributes attr{};
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long vals[10] = {p.grid, p.groups, p.groups_per_block, p.chunk, p.rows,
                              p.rw_resident, static_cast<long long>(p.smem), p.blocks_per_sm,
                              attr.numRegs, static_cast<long long>(attr.localSizeBytes)};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return 0;
}

// The device's attributes that the cluster layout's plan reads, into
// out[10 + kMaxCluster]: SMs, opt-in shared bytes a block, cooperative launch
// (0/1), cluster launch (0/1), the forward cluster kernel's registers and
// local (spilled) bytes a thread, the backward cluster loop's, its rest
// kernel's, then for C =
// 1 .. kMaxCluster the clusters of C blocks of the forward kernel the device
// holds at once at the opt-in shared bytes (0 where it holds none; one block
// an SM in any case, as the kernel's registers allow no more).
extern "C" int slstm_scan_device(int device, long long* out) {
  cudaError_t err = cudaSetDevice(device);
  int vals[4] = {0, 0, 0, 0};
  const cudaDeviceAttr keys[4] = {cudaDevAttrMultiProcessorCount,
                                  cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  cudaDevAttrCooperativeLaunch, cudaDevAttrClusterLaunch};
  for (int i = 0; i < 4 && err == cudaSuccess; ++i) {
    err = cudaDeviceGetAttribute(&vals[i], keys[i], device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr{}, bwd{}, rest{};
  err = cudaFuncGetAttributes(&attr, slstm_scan_cluster_kernel<false>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&bwd, slstm_scan_bwd_cluster_kernel<false>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&rest, slstm_scan_bwd_rest_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int i = 0; i < 4; ++i) out[i] = vals[i];
  out[4] = attr.numRegs;
  out[5] = static_cast<long long>(attr.localSizeBytes);
  out[6] = bwd.numRegs;
  out[7] = static_cast<long long>(bwd.localSizeBytes);
  out[8] = rest.numRegs;
  out[9] = static_cast<long long>(rest.localSizeBytes);
  for (int C = 1; C <= kMaxCluster; ++C) {
    int active = 0;
    if (vals[3]) {
      cudaLaunchAttribute la;
      cudaLaunchConfig_t cfg;
      err = cluster_config(slstm_scan_cluster_kernel<false>, C, static_cast<size_t>(vals[1]), C,
                           nullptr, &la, &cfg);
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveClusters(&active, slstm_scan_cluster_kernel<false>, &cfg);
      }
      if (err != cudaSuccess) {
        active = 0;
        cudaGetLastError();  // a size the device refuses: none of it
      }
    }
    out[9 + C] = active;
  }
  return 0;
}
