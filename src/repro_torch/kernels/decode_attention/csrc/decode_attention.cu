// Single-token GQA attention over a KV cache (decode) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel decode_attention_pallas of
// src/repro/kernels/decode_attention/kernel.py. For every batch row b and
// query head h = hk * G + g (G = H / Hkv query heads share KV head hk),
// over the cache slots j < lengths[b] (clamped to S):
//   s_j = (q_h * D^-1/2) . k[b, j, hk],   o_h = sum_j softmax(s)_j v[b, j, hk],
// with scores, softmax and accumulation in float32 from float32 or bf16
// inputs, and the output acc / max(l, 1e-30) in the input type.
//
// Layout: q and o (B, H, D), k and v (B, S, Hkv, D), all contiguous;
// lengths (B,) int32 on the device.
//
// Bound: bytes. Each launch must read the valid K and V rows once
// (2 * B * Hkv * len * D elements: ~18.9 MB in bf16 at B 8, S 576, Hkv 16,
// D 64) and does 4 * G * D flops per row read, far below the card's ratio.
// Design, simple first: one block of 128 threads per (b, hk), holding the
// G query heads of the group, so every KV byte is read once per group (as
// the Pallas kernel's shared (G, D) tile does). It walks the cache in
// 64-slot tiles up to lengths[b] only (the Pallas grid visits every block
// of S and masks), staging K and V in shared memory as float32 with 16-byte
// loads; the ragged last tile is zero-filled, never read past the length.
// With B * Hkv blocks (128 at the serving shape) the card holds one block
// per SM and few loads in flight: splitting the cache over several blocks
// with a combine pass, and a pipeline of tiles, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBK = 64;        // cache slots per tile
constexpr int kThreads = 128;  // 4 warps
constexpr float kNegInf = -1.0e30f;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;  // elements per 16-byte load
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  __device__ static float to_float(float x) { return x; }
  __device__ static float store(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16(x); }
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* lengths;
  void* o;
  int64_t S;
  float scale;  // D^-1/2, rounded to float32 as the reference rounds it
  int H, Hkv;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(Args a) {
  constexpr int VN = Vec<T>::N;
  constexpr int NV = D / VN;
  constexpr int KS = D + 1;  // padded K row: lanes on consecutive slots hit distinct banks
  const int G = a.H / a.Hkv;
  extern __shared__ __align__(16) float smem[];
  float* qS = smem;              // [G][D]
  float* accS = qS + G * D;      // [G][D]
  float* kS = accS + G * D;      // [kBK][D + 1]
  float* vS = kS + kBK * KS;     // [kBK][D]
  float* sS = vS + kBK * D;      // [G][kBK]
  float* mS = sS + G * kBK;      // [G]
  float* lS = mS + G;            // [G]
  float* cS = lS + G;            // [G]

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  int64_t len = a.lengths[b];
  if (len > a.S) len = a.S;
  if (len < 0) len = 0;

  const int64_t row = static_cast<int64_t>(a.Hkv) * D;
  const T* q = static_cast<const T*>(a.q) + (static_cast<int64_t>(b) * a.H + hk * G) * D;
  const T* k = static_cast<const T*>(a.k) + static_cast<int64_t>(b) * a.S * row + hk * D;
  const T* v = static_cast<const T*>(a.v) + static_cast<int64_t>(b) * a.S * row + hk * D;

  for (int idx = tid; idx < G * D; idx += kThreads) {
    qS[idx] = Vec<T>::to_float(q[idx]) * a.scale;
    accS[idx] = 0.0f;
  }
  for (int g = tid; g < G; g += kThreads) {
    mS[g] = kNegInf;
    lS[g] = 0.0f;
  }

  for (int64_t j0 = 0; j0 < len; j0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * NV; idx += kThreads) {
      const int j = idx / NV;
      const int dv = idx % NV;
      float kv[VN], vv[VN];
      if (j0 + j < len) {
        Vec<T>::load(k + (j0 + j) * row + dv * VN, kv);
        Vec<T>::load(v + (j0 + j) * row + dv * VN, vv);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) kv[e] = vv[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        kS[j * KS + dv * VN + e] = kv[e];
        vS[j * D + dv * VN + e] = vv[e];
      }
    }
    __syncthreads();

    for (int idx = tid; idx < G * kBK; idx += kThreads) {
      const int g = idx / kBK;
      const int j = idx % kBK;
      float s = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qS[g * D + d], kS[j * KS + d], s);
      sS[idx] = j0 + j < len ? s : kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kThreads / 32) {
      float mx = kNegInf;
      for (int j = lane; j < kBK; j += 32) mx = fmaxf(mx, sS[g * kBK + j]);
#pragma unroll
      for (int o = 16; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(mS[g], mx);
      float sum = 0.0f;
      for (int j = lane; j < kBK; j += 32) {
        const float p = j0 + j < len ? expf(sS[g * kBK + j] - m_new) : 0.0f;
        sS[g * kBK + j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(mS[g] - m_new);
        lS[g] = lS[g] * corr + sum;
        mS[g] = m_new;
        cS[g] = corr;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < G * D; idx += kThreads) {
      const int g = idx / D;
      const int d = idx % D;
      float acc = accS[idx] * cS[g];
#pragma unroll 8
      for (int j = 0; j < kBK; ++j) acc = fmaf(sS[g * kBK + j], vS[j * D + d], acc);
      accS[idx] = acc;
    }
  }
  __syncthreads();

  T* o = static_cast<T*>(a.o) + (static_cast<int64_t>(b) * a.H + hk * G) * D;
  for (int idx = tid; idx < G * D; idx += kThreads) {
    o[idx] = Vec<T>::store(accS[idx] / fmaxf(lS[idx / D], 1e-30f));
  }
}

template <typename T, int D>
int launch(const Args& a, int64_t B, cudaStream_t stream) {
  const int G = a.H / a.Hkv;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(G) * D + kBK * (D + 1) +
                                       static_cast<size_t>(kBK) * D +
                                       static_cast<size_t>(G) * kBK + 3 * static_cast<size_t>(G));
  cudaError_t err = cudaFuncSetAttribute(decode_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(a.Hkv), static_cast<unsigned>(B));
  decode_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const Args& a, int64_t B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    case 256: return launch<T, 256>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches the kernel on `stream` (no synchronisation). dtype: 0 float32,
// 1 bfloat16. Returns a cudaError_t code: 0 on success.
extern "C" int decode_attention_launch(int device, int dtype, const void* q, const void* k,
                                       const void* v, const void* lengths, void* o,
                                       long long B, long long S, int H, int Hkv, int D,
                                       float scale, void* stream) {
  if (B <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.lengths = static_cast<const int32_t*>(lengths);
  a.o = o;
  a.S = S;
  a.scale = scale;
  a.H = H;
  a.Hkv = Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(a, B, D, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(a, B, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
