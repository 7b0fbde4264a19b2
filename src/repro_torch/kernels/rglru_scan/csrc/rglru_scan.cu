// RG-LRU linear-recurrence scan for Hopper (sm_90a): the forward and its
// backward.
//
// The forward replaces the Pallas TPU kernel rglru_scan_pallas of
// src/repro/kernels/rglru_scan/kernel.py. For every channel (b, w) of
// a, b (B, S, W) and h0 (B, W):
//   h_{-1} = h0[b, w],   h_t = a[b, t, w] * h_{t-1} + b[b, t, w],
//   out[b, t, w] = h_t in a's type,
// with the carry in float32 from float32 or bf16 inputs. The product and
// the sum round separately (__fmul_rn, __fadd_rn: no fused multiply-add),
// as the plain version's `a * h + b` does, so the two agree bit for bit.
//
// Layout: a, b and out (B, S, W) contiguous, h0 (B, W) float32 contiguous.
//
// Bound: bytes. a and b are read once and out written once: 3 * B * S * W
// elements (566 MB in float32 at the serving shape B 8, S 2304, W 2560:
// 0.169 ms at 3.35 TB/s), against 2 flops an element.
// Design, simple first: one thread owns one channel and keeps h in a
// register; neighbouring threads take neighbouring w, so each time step's
// loads and stores are coalesced. The loads do not depend on h, so each
// thread issues the loads of kUnroll steps together before it runs them.
// Only B * W threads exist (20 480 at the serving shape, ~5 warps an SM),
// so the kernel is bound by the latency of its loads more than by the
// bytes; the Pallas tiling (8 x 256 x 128 VMEM tiles walked in order) is not
// carried over. Splitting the sequence into chunks with a second pass over
// the chunk carries is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;  // time steps whose loads are issued together

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b, const float* __restrict__ h0,
                  T* __restrict__ out, int64_t S, int64_t W, int64_t channels) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= channels) return;
  const int64_t row = c / W;
  const int64_t base = row * S * W + (c - row * W);  // element (row, 0, w)
  const T* pa = a + base;
  const T* pb = b + base;
  T* po = out + base;
  float h = h0[c];
  int64_t t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = load(pa + (t + u) * W);
      bv[u] = load(pb + (t + u) * W);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      store(po + (t + u) * W, h);
    }
  }
  for (; t < S; ++t) {
    h = __fadd_rn(__fmul_rn(load(pa + t * W), h), load(pb + t * W));
    store(po + t * W, h);
  }
}

template <typename T>
int launch(const void* a, const void* b, const float* h0, void* out, int64_t B, int64_t S,
           int64_t W, cudaStream_t stream) {
  const int64_t channels = B * W;
  const int64_t blocks = (channels + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rglru_scan_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0, static_cast<T*>(out), S, W,
      channels);
  return static_cast<int>(cudaGetLastError());
}

// The backward. The Pallas kernel has none: the reference trains through
// jax.grad of the associative scan in src/repro/models/rglru.py:95
// (_lru_scan). With g_t = dL/dh_t, a reverse scan over the same channels:
//   c_{S-1} = g_{S-1},   c_t = g_t + a_{t+1} c_{t+1},
//   db_t = c_t,   da_t = c_t h_{t-1} (h_{-1} = h0),   dh0 = a_0 c_0.
// float32 only (training computes a and b in float32). As in the forward,
// the product and the sum of every step round separately, in the plain
// version's order (ref.py: rglru_scan_bwd_ref), so the two agree bit for
// bit.
//
// Bound: bytes. g, a and the saved h are read once, da and db written
// once: 20 bytes an element (10.49 M elements at the training shape B 8,
// S 512, W 2560: 210 MB, 0.063 ms at 3.35 TB/s), against 3 flops an
// element. Design: the forward's, walked from t = S-1 down to 0. One
// thread owns one channel and keeps c and a_{t+1} in registers;
// neighbouring threads take neighbouring w, so each step's loads and
// stores are coalesced; the loads of kUnroll steps are issued together.
template <bool kGradH0>
__global__ void __launch_bounds__(kThreads)
rglru_scan_bwd_kernel(const float* __restrict__ g, const float* __restrict__ a,
                      const float* __restrict__ h, const float* __restrict__ h0,
                      float* __restrict__ da, float* __restrict__ db, float* __restrict__ dh0,
                      int64_t S, int64_t W, int64_t channels) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= channels) return;
  const int64_t row = c / W;
  const int64_t base = row * S * W + (c - row * W);  // element (row, 0, w)
  const float* pg = g + base;
  const float* pa = a + base;
  const float* ph = h + base;
  float* pda = da + base;
  float* pdb = db + base;
  const float first = h0[c];  // h_{-1}
  float carry = 0.0f;         // c_{t+1}
  float a_next = 0.0f;        // a_{t+1}
  int64_t t = S - 1;
  for (; t + 1 >= kUnroll; t -= kUnroll) {  // steps t, t-1, ..., t-kUnroll+1
    float gv[kUnroll], av[kUnroll], hv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t s = t - u;
      gv[u] = __ldg(pg + s * W);
      av[u] = __ldg(pa + s * W);
      hv[u] = s > 0 ? __ldg(ph + (s - 1) * W) : first;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t s = t - u;
      carry = __fadd_rn(gv[u], __fmul_rn(a_next, carry));
      pdb[s * W] = carry;
      pda[s * W] = __fmul_rn(carry, hv[u]);
      a_next = av[u];
    }
  }
  for (; t >= 0; --t) {
    carry = __fadd_rn(__ldg(pg + t * W), __fmul_rn(a_next, carry));
    pdb[t * W] = carry;
    pda[t * W] = __fmul_rn(carry, t > 0 ? __ldg(ph + (t - 1) * W) : first);
    a_next = __ldg(pa + t * W);
  }
  if (kGradH0) dh0[c] = __fmul_rn(a_next, carry);
}

}  // namespace

// Launches the kernel on `stream` (no synchronisation). dtype: 0 float32,
// 1 bfloat16 (a, b and out; h0 is float32). Returns a cudaError_t code: 0
// on success. Empty inputs launch nothing.
extern "C" int rglru_scan_launch(int device, int dtype, const void* a, const void* b,
                                 const void* h0, void* out, long long B, long long S,
                                 long long W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* h = static_cast<const float*>(h0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, h, out, B, S, W, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, h, out, B, S, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launches the backward on `stream` (no synchronisation): g, a, h (B, S, W)
// and h0 (B, W), all float32 and contiguous, into da, db (B, S, W) and,
// when dh0 is not null, dh0 (B, W). Returns a cudaError_t code: 0 on
// success. Empty inputs launch nothing.
extern "C" int rglru_scan_bwd_launch(int device, const void* g, const void* a, const void* h,
                                     const void* h0, void* da, void* db, void* dh0, long long B,
                                     long long S, long long W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t channels = B * W;
  const int64_t blocks = (channels + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pg = static_cast<const float*>(g);
  const float* pa = static_cast<const float*>(a);
  const float* ph = static_cast<const float*>(h);
  const float* ph0 = static_cast<const float*>(h0);
  float* pda = static_cast<float*>(da);
  float* pdb = static_cast<float*>(db);
  float* pdh0 = static_cast<float*>(dh0);
  if (pdh0 != nullptr) {
    rglru_scan_bwd_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        pg, pa, ph, ph0, pda, pdb, pdh0, S, W, channels);
  } else {
    rglru_scan_bwd_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        pg, pa, ph, ph0, pda, pdb, nullptr, S, W, channels);
  }
  return static_cast<int>(cudaGetLastError());
}
