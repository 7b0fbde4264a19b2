// sLSTM recurrence for Hopper (sm_90a): the whole time loop of one sLSTM
// block call in one launch, in one of two layouts.
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
// hs[:, t] = h_t, and the state after the last step.
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
// Each layout has a serial floor (serial_floor 1): the same launch with the
// arithmetic removed. The cooperative floor is its S - 1 grid barriers; the
// cluster floor its h exchange (the mbarrier waits and the st.async stores,
// one read of h a lane).

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
  int64_t B, S;
  int d;
  int C;  // blocks a cluster (column slices)
  int R;  // rows a cluster, at most kMaxClusterRows (lane l of a warp owns row l % 8)
  int W;  // ceil(d / C) rounded up to 4: a slice's width (the last block's: the rest)
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

  if (a.rw_resident) {
    const int64_t total = static_cast<int64_t>(my_groups) * kCols * d;
    for (int64_t e = threadIdx.x; e < total; e += kThreads) {
      const int64_t k = e % d;
      const int64_t q = e / d;
      const int64_t j = (blockIdx.x + (q / kCols) * gridDim.x) * static_cast<int64_t>(kCols) +
                        q % kCols;
      rw_s[e] = j < d ? __ldg(a.rw + k * d + j) : 0.0f;
    }
  }
  const int64_t n_chunks = (d + a.chunk - 1) / a.chunk;

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
#pragma unroll
        for (int q = 0; q < kCols; ++q) acc[q] = 0.0f;
        for (int64_t ch = 0; ch < n_chunks; ++ch) {
          const int64_t k0 = ch * a.chunk;
          const int len = static_cast<int>(d - k0 < a.chunk ? d - k0 : a.chunk);
          if (n_chunks > 1 || base == 0) {
            __syncthreads();
            for (int e = threadIdx.x; e < rows * len; e += kThreads) {
              const int rr = e / len;
              const int kk = e - rr * len;
              h_s[rr * a.chunk + kk] = __ldcg(hp + (r0 + rr) * hstride + k0 + kk);
            }
            __syncthreads();
          }
          if (active) {
            const float* hrow = h_s + rl * a.chunk;
            if (a.rw_resident) {
              const float* w = rw_s + static_cast<int64_t>(gi) * kCols * d + k0;
              for (int kk = lane; kk < len; kk += 32) {
                const float hv = hrow[kk];
#pragma unroll
                for (int q = 0; q < kCols; ++q) acc[q] = fmaf(hv, w[q * d + kk], acc[q]);
              }
            } else {
              for (int kk = lane; kk < len; kk += 32) {
                const float hv = hrow[kk];
                const float* w = a.rw + (k0 + kk) * d + j0;
#pragma unroll
                for (int q = 0; q < kCols; ++q) {
                  const float wq = j0 + q < d ? __ldg(w + q) : 0.0f;
                  acc[q] = fmaf(hv, wq, acc[q]);
                }
              }
            }
          }
        }
        if (active) {
          // Butterfly: every lane ends with the same sums (a + b == b + a).
#pragma unroll
          for (int q = 0; q < kCols; ++q) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
              acc[q] = __fadd_rn(acc[q], __shfl_xor_sync(0xffffffffu, acc[q], off));
            }
          }
        }
        if (owner) {
          float dot = acc[0];
#pragma unroll
          for (int q = 1; q < kCols; ++q) {
            if (lane == q) dot = acc[q];
          }
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
        }
      }
    }
    if (t + 1 < S) grid.sync();  // hs[:, t] whole before any block reads it
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
// and h double-buffered [2][R][kMaxClusterD] (every row padded to the
// kernel's widest, zeros past d: a lane's loads need no bound), float32.
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
    float dot = 0.0f;
    if (kFloor) {
      // The floor keeps one read of h_{t-1} a lane, so the step still waits on it.
      dot = hc[(mine ? r : 0) * dp + (mine ? c0 + jl : c0)];
    } else {
      int rr = 0;
      for (; rr + 2 <= nr; rr += 2) {
        float sum[2];
        cluster_dots<2>(hc + rr * dp, lane, w, sum);
        if (r == rr) dot = sum[0];
        if (r == rr + 1) dot = sum[1];
      }
      if (rr < nr) {
        float sum[1];
        cluster_dots<1>(hc + rr * dp, lane, w, sum);
        if (r == rr) dot = sum[0];
      }
    }
    float h_new = dot;
    if (!kFloor && mine) {
      const float z = tanhf(__fadd_rn(zx_t, dot));
      c = __fadd_rn(__fmul_rn(f_p, c), __fmul_rn(i_p, z));
      n = n_new;
      m = m_new;
      h_new = __fdiv_rn(__fmul_rn(og, c), n_div);
      h = h_new;
      a.hs[((r0 + r) * S + t) * d + c0 + jl] = h_new;
    }
    if (t + 1 < S) {
      // h_t into every block's buffer, this one's too: the warp's 4 columns
      // of a row in one 16-byte store, the (row, peer) pairs spread over the
      // lanes, each value shuffled from the lane that holds it (8 q + row).
      const unsigned hn = h_u32 + 4u * (cur ^ 1) * R * dp;
      const unsigned bar_n = bars + 8 * (cur ^ 1);
      const int cols = wc - warp * kWarpCols < kWarpCols ? wc - warp * kWarpCols : kWarpCols;
      const int pairs = C * nr;
      for (int e0 = 0; e0 < pairs; e0 += 32) {
        const int e = e0 + lane;
        const int rr = e / C, p = e - rr * C;
        float v[kWarpCols];
#pragma unroll
        for (int q = 0; q < kWarpCols; ++q) {
          v[q] = __shfl_sync(0xffffffffu, h_new, 8 * q + (rr & 7));
        }
        if (e < pairs) {
          const unsigned la = hn + 4u * (rr * dp + c0 + warp * kWarpCols);
          const unsigned rb = mapa(bar_n, p);
          if (cols == kWarpCols) {
            st_async4(mapa(la, p), v, rb);
          } else {
            for (int q = 0; q < cols; ++q) st_async(mapa(la + 4u * q, p), v[q], rb);
          }
        }
      }
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

int make_plan(int device, int64_t B, int64_t d, Plan* p) {
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
  err = cudaFuncSetAttribute(slstm_scan_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(p->smem));
  if (err == cudaSuccess) err = cudaFuncSetAttribute(
      slstm_scan_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p->smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p->blocks_per_sm, slstm_scan_kernel<false>,
                                                      kThreads, p->smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Every block must be resident for grid.sync(): at most one a SM here.
  if (p->blocks_per_sm < 1 || p->grid > p->blocks_per_sm * p->sms) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  return 0;
}

// The cluster kernel's attributes for a launch of `smem` dynamic bytes, and
// its launch configuration: `clusters` clusters of C blocks.
template <bool kFloor>
cudaError_t cluster_config(int C, size_t smem, int64_t clusters, cudaStream_t stream,
                           cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  cudaError_t err = cudaFuncSetAttribute(slstm_scan_cluster_kernel<kFloor>,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(
      slstm_scan_cluster_kernel<kFloor>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
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

template <bool kFloor>
int launch_cluster(int device, const ClusterArgs& a, cudaStream_t stream) {
  if (a.C < 1 || a.C > kMaxCluster || a.R < 1 || a.R > kMaxClusterRows || a.d > kMaxClusterD ||
      a.W > kMaxWidth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int smem_optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                           device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = cluster_smem(a.R);
  const int64_t clusters = (a.B + a.R - 1) / a.R;
  if (smem > static_cast<size_t>(smem_optin) || clusters * a.C > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  err = cluster_config<kFloor>(a.C, smem, clusters, stream, &attr, &cfg);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, slstm_scan_cluster_kernel<kFloor>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the recurrence on `stream` (no synchronisation) in `layout` (0
// cooperative, 1 cluster: `clusters` = ceil(B / R) clusters of C blocks, R
// rows each): the kernel (serial_floor 0) or its serial floor (serial_floor
// 1: the same launch, its barriers and, in the cluster layout, the h
// exchange alone). Inputs zx, ix, fx, ox (B, S, d), rw (d, d) and the
// entering state c0, n0, h0, m0 (B, d); outputs hs (B, S, d) and the state
// c, n, h, m (B, d), all float32, contiguous, the outputs apart from the
// inputs. Returns a cudaError_t code: 0 on success (cudaErrorNotSupported
// where the device has no cooperative launch, cudaErrorCooperativeLaunchTooLarge
// where the cooperative grid cannot be resident, cudaErrorInvalidValue for a
// cluster plan the kernel cannot take). Empty inputs launch nothing.
extern "C" int slstm_scan_launch(int device, const void* zx, const void* ix, const void* fx,
                                 const void* ox, const void* rw, const void* c0, const void* n0,
                                 const void* h0, const void* m0, void* hs, void* c, void* n,
                                 void* h, void* m, long long B, long long S, long long d,
                                 int layout, int C, int R, int serial_floor, void* stream) {
  if (B <= 0 || S <= 0 || d <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layout == kLayoutCluster) {
    if (C < 1 || d > kMaxClusterD) return static_cast<int>(cudaErrorInvalidValue);
    const ClusterArgs a{static_cast<const float*>(zx), static_cast<const float*>(ix),
                        static_cast<const float*>(fx), static_cast<const float*>(ox),
                        static_cast<const float*>(rw), static_cast<const float*>(c0),
                        static_cast<const float*>(n0), static_cast<const float*>(h0),
                        static_cast<const float*>(m0), static_cast<float*>(hs),
                        static_cast<float*>(c), static_cast<float*>(n), static_cast<float*>(h),
                        static_cast<float*>(m), B, S, static_cast<int>(d), C, R,
                        static_cast<int>(((d + C - 1) / C + 3) / 4 * 4)};
    return serial_floor ? launch_cluster<true>(device, a, st)
                        : launch_cluster<false>(device, a, st);
  }
  if (layout != kLayoutCooperative) return static_cast<int>(cudaErrorInvalidValue);
  Plan p{};
  int status = make_plan(device, B, d, &p);
  if (status != 0) return status;
  Args a{static_cast<const float*>(zx), static_cast<const float*>(ix),
         static_cast<const float*>(fx), static_cast<const float*>(ox),
         static_cast<const float*>(rw), static_cast<const float*>(c0),
         static_cast<const float*>(n0), static_cast<const float*>(h0),
         static_cast<const float*>(m0), static_cast<float*>(hs), static_cast<float*>(c),
         static_cast<float*>(n), static_cast<float*>(h), static_cast<float*>(m),
         B, S, d, p.groups, p.chunk, p.rows, p.rw_resident};
  void* params[] = {&a};
  const void* fn = serial_floor ? reinterpret_cast<const void*>(slstm_scan_kernel<true>)
                         : reinterpret_cast<const void*>(slstm_scan_kernel<false>);
  err = cudaLaunchCooperativeKernel(fn, dim3(p.grid), dim3(kThreads), params, p.smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The cooperative layout's launch of a (B, d) call, into out[10]: grid,
// column groups, groups a block, k chunk, staged rows, rw resident (0/1),
// dynamic shared bytes, resident blocks a SM, registers and local (spilled)
// bytes a thread.
extern "C" int slstm_scan_plan(int device, long long B, long long d, long long* out) {
  if (B <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan p{};
  int status = make_plan(device, B, d, &p);
  if (status != 0) return status;
  cudaFuncAttributes attr{};
  err = cudaFuncGetAttributes(&attr, slstm_scan_kernel<false>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long vals[10] = {p.grid, p.groups, p.groups_per_block, p.chunk, p.rows,
                              p.rw_resident, static_cast<long long>(p.smem), p.blocks_per_sm,
                              attr.numRegs, static_cast<long long>(attr.localSizeBytes)};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return 0;
}

// The device's attributes that the cluster layout's plan reads, into
// out[6 + kMaxCluster]: SMs, opt-in shared bytes a block, cooperative launch
// (0/1), cluster launch (0/1), the cluster kernel's registers and local
// (spilled) bytes a thread, then for C = 1 .. kMaxCluster the clusters of C
// blocks the device holds at once at the opt-in shared bytes (0 where it
// holds none; one block an SM in any case, as the kernel's registers allow no
// more).
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
  cudaFuncAttributes attr{};
  err = cudaFuncGetAttributes(&attr, slstm_scan_cluster_kernel<false>);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int i = 0; i < 4; ++i) out[i] = vals[i];
  out[4] = attr.numRegs;
  out[5] = static_cast<long long>(attr.localSizeBytes);
  for (int C = 1; C <= kMaxCluster; ++C) {
    int active = 0;
    if (vals[3]) {
      cudaLaunchAttribute la;
      cudaLaunchConfig_t cfg;
      err = cluster_config<false>(C, static_cast<size_t>(vals[1]), C, nullptr, &la, &cfg);
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveClusters(&active, slstm_scan_cluster_kernel<false>, &cfg);
      }
      if (err != cudaSuccess) {
        active = 0;
        cudaGetLastError();  // a size the device refuses: none of it
      }
    }
    out[5 + C] = active;
  }
  return 0;
}
