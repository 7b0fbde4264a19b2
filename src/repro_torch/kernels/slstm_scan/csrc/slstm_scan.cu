// sLSTM recurrence for Hopper (sm_90a): the whole time loop of one sLSTM
// block call in one cooperative launch.
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
// the plain version's; only the dot products sum in another order than
// cuBLAS (lane l of a warp takes k = l mod 32 in ascending order, then a
// butterfly over the lanes), and the kernel is held to the plain version by
// tolerance.
//
// Bound: operations. 2 B S d^2 FLOP of the products (4.83 G at B 8, S 512,
// d 768: 0.072 ms at 67 TFLOP/s FP32) against ~65 MB moved (0.0195 ms at
// 3.35 TB/s). But step t needs every h_{t-1}, so the steps are serial: the
// launch pays S - 1 grid-wide barriers and S round trips through the L2,
// a floor far above either bound that the serial-floor entry measures.
//
// Design, simple first: one launch per call, the time loop inside it.
// Blocks own groups of kCols output columns for all B rows; the grid has
// at most one block an SM (cudaLaunchCooperativeKernel: every block
// resident, checked against the occupancy; grid.sync() between steps). A
// block keeps rw[:, its columns] in shared memory for the whole loop (768 x
// 8 floats, 24 KB, at xlstm-125m) where it fits, and reads it through the
// read-only path where not. Each step a block stages h_{t-1} (rows x a k
// chunk) from hs[:, t-1] (or the entering h at t = 0) through the L2
// (__ldcg: other blocks wrote it in this launch, so never the read-only or
// L1 path); a warp takes one row and one group of columns, lane l the
// products over k = l mod 32, and after a butterfly lane q < kCols owns
// column q: its gates, hs[b, t, j], and c, n, m in the output state
// (read and written by that lane alone, every step). Rows past the staging
// tile and k past the chunk loop; a ragged last group is masked. Any
// (B, S, d) the plain version takes is taken.

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

}  // namespace

// Launches the recurrence on `stream` (no synchronisation): the kernel
// (serial_floor 0) or its serial floor (serial_floor 1: the same launch, its barriers
// alone). Inputs zx, ix, fx, ox (B, S, d), rw (d, d) and the entering state
// c0, n0, h0, m0 (B, d); outputs hs (B, S, d) and the state c, n, h, m
// (B, d), all float32, contiguous, the outputs apart from the inputs.
// Returns a cudaError_t code: 0 on success (cudaErrorNotSupported where the
// device has no cooperative launch, cudaErrorCooperativeLaunchTooLarge where
// the grid cannot be resident). Empty inputs launch nothing.
extern "C" int slstm_scan_launch(int device, const void* zx, const void* ix, const void* fx,
                                 const void* ox, const void* rw, const void* c0, const void* n0,
                                 const void* h0, const void* m0, void* hs, void* c, void* n,
                                 void* h, void* m, long long B, long long S, long long d,
                                 int serial_floor, void* stream) {
  if (B <= 0 || S <= 0 || d <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
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
  err = cudaLaunchCooperativeKernel(fn, dim3(p.grid), dim3(kThreads), params, p.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The launch of a (B, d) call, into out[10]: grid, column groups, groups a
// block, k chunk, staged rows, rw resident (0/1), dynamic shared bytes,
// resident blocks a SM, registers and local (spilled) bytes a thread.
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
