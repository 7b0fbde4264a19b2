// RG-LRU linear-recurrence scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rglru_scan_pallas of
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
