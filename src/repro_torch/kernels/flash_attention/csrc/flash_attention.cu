// Blocked online-softmax attention (prefill) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_pallas of
// src/repro/kernels/flash_attention/kernel.py (body _kernel), together with
// the GQA repeat of src/repro/kernels/flash_attention/ops.py. For every
// batch b, query head h and query row i (queries right-aligned to the key
// span: q_pos = i + Sk - Sq), over the keys j that pass the mask
//   j < Sk,  causal: q_pos >= j,  window w > 0: j > q_pos - w,
//   s_j = (q_i * D^-1/2) . k_j,   o_i = sum_j softmax(s)_j v_j,
// with scores, softmax and accumulation in float32 from float32 or bf16
// inputs, and the output acc / max(l, 1e-30) in the input type. Query head
// h reads key/value head h / G (G = H / Hkv) directly: no repeat.
//
// Layout: q and o are (B, Sq, H, D), k and v (B, Sk, Hkv, D), each with
// its dims after the first contiguous and a batch stride of its own (so a
// prefix of a KV cache is read in place).
//
// Bound: bytes. At the serving shape (B 8, H 16, S 512, D 64, causal, bf16)
// q, k, v and o move 33.6 MB once, 0.0100 ms at 3.35 TB/s; the two
// products are 4.30 GFLOP, 0.0043 ms at the card's dense bf16 peak. The
// kernel is far from either while its products run on the FP32 pipes (a
// 67 TFLOP/s ceiling puts them at 0.064 ms). Design, simple first: one block of 128 threads per (b, h, 64-row query
// tile), looping over 64-key tiles of K and V staged in shared memory as
// float32. Tiles wholly outside the causal or window bound are skipped
// (the Pallas kernel visits and masks them); the ragged last tile is
// zero-filled, never read past Sk. Each thread owns a 4 x 8 block of
// scores and a 4 x D/8 block of the output, so a shared-memory load feeds
// several FMAs; the running max and sum of a row are shared by the 8
// threads of the row group through warp shuffles. The products run on the
// FP32 pipes, not the tensor cores: mma/wgmma tiles, TMA and a pipeline of
// tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kPad = 4;        // row padding of the transposed tiles (floats)
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
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16(x); }
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t Sq, Sk;
  int64_t q_bstride, kv_bstride, o_bstride;  // elements
  float scale;  // D^-1/2, rounded to float32 as the reference rounds it
  int H, Hkv;
  int causal, window;
};

// Stages rows [row0, row0 + kBQ/kBK) of one head of x (rows of `row_stride`
// elements, D contiguous) as float32 * scale, transposed to dst[d][row]
// (row stride kBQ + kPad). Rows at or past n_rows are zero.
template <typename T, int D, int ROWS>
__device__ void stage_transposed(float* dst, const T* x, int64_t row0, int64_t n_rows,
                                 int64_t row_stride, float scale) {
  constexpr int VN = Vec<T>::N;
  constexpr int NV = D / VN;
  for (int idx = threadIdx.x; idx < ROWS * NV; idx += kThreads) {
    const int i = idx % ROWS;  // consecutive threads: consecutive rows
    const int dv = idx / ROWS;
    float vals[VN];
    if (row0 + i < n_rows) {
      Vec<T>::load(x + (row0 + i) * row_stride + dv * VN, vals);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) vals[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) dst[(dv * VN + e) * (ROWS + kPad) + i] = vals[e] * scale;
  }
}

// Stages rows of x as float32, row-major dst[row][d]; zero past n_rows.
template <typename T, int D, int ROWS>
__device__ void stage_rows(float* dst, const T* x, int64_t row0, int64_t n_rows,
                           int64_t row_stride) {
  constexpr int VN = Vec<T>::N;
  constexpr int NV = D / VN;
  for (int idx = threadIdx.x; idx < ROWS * NV; idx += kThreads) {
    const int j = idx / NV;
    const int dv = idx % NV;
    float vals[VN];
    if (row0 + j < n_rows) {
      Vec<T>::load(x + (row0 + j) * row_stride + dv * VN, vals);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) vals[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) dst[j * D + dv * VN + e] = vals[e];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(Args a) {
  constexpr int DPT = D / 8;  // output dims per thread
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;                          // [D][kBQ + kPad]
  float* kT = qT + D * (kBQ + kPad);         // [D][kBK + kPad]
  float* vS = kT + D * (kBK + kPad);         // [kBK][D]
  float* pT = vS + kBK * D;                  // [kBK][kBQ + kPad]

  const int n_q = static_cast<int>((a.Sq + kBQ - 1) / kBQ);
  const int qi = n_q - 1 - static_cast<int>(blockIdx.x);  // longest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int64_t q0 = static_cast<int64_t>(qi) * kBQ;
  const int64_t off = a.Sk - a.Sq;  // queries right-aligned to the keys

  const int tid = threadIdx.x;
  const int r = tid / 8;  // row group: rows r*4 .. r*4+3
  const int c = tid % 8;  // column group: keys c*8 .. c*8+7, dims c*DPT ..

  const T* q = static_cast<const T*>(a.q) + b * a.q_bstride + static_cast<int64_t>(h) * D;
  const T* k = static_cast<const T*>(a.k) + b * a.kv_bstride + static_cast<int64_t>(hk) * D;
  const T* v = static_cast<const T*>(a.v) + b * a.kv_bstride + static_cast<int64_t>(hk) * D;
  const int64_t q_row = static_cast<int64_t>(a.H) * D;
  const int64_t kv_row = static_cast<int64_t>(a.Hkv) * D;

  stage_transposed<T, D, kBQ>(qT, q, q0, a.Sq, q_row, a.scale);

  // Key tiles that can hold an unmasked key for some row of this tile.
  const int64_t pos_lo = q0 + off;
  const int64_t pos_hi = (q0 + kBQ < a.Sq ? q0 + kBQ : a.Sq) - 1 + off;
  int64_t kv_end = a.Sk;
  if (a.causal && pos_hi + 1 < kv_end) kv_end = pos_hi + 1;
  int64_t kv_start = 0;
  if (a.window && pos_lo - a.window + 1 > 0) kv_start = pos_lo - a.window + 1;
  const int64_t t_first = kv_start / kBK;
  const int64_t t_end = kv_end > kv_start ? (kv_end + kBK - 1) / kBK : t_first;

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[i][d] = 0.0f;
  }

  for (int64_t t = t_first; t < t_end; ++t) {
    const int64_t k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done
    stage_transposed<T, D, kBK>(kT, k, k0, a.Sk, kv_row, 1.0f);
    stage_rows<T, D, kBK>(vS, v, k0, a.Sk, kv_row);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&qT[d * (kBQ + kPad) + r * 4]);
      const float4 k_lo = *reinterpret_cast<const float4*>(&kT[d * (kBK + kPad) + c * 8]);
      const float4 k_hi = *reinterpret_cast<const float4*>(&kT[d * (kBK + kPad) + c * 8 + 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[8] = {k_lo.x, k_lo.y, k_lo.z, k_lo.w, k_hi.x, k_hi.y, k_hi.z, k_hi.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t pos = q0 + r * 4 + i + off;
      bool valid[8];
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int64_t kj = k0 + c * 8 + j;
        valid[j] = kj < a.Sk && (!a.causal || pos >= kj) && (!a.window || kj > pos - a.window);
        if (valid[j]) row_max = fmaxf(row_max, s[i][j]);
      }
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 4));
      const float m_new = fmaxf(m[i], row_max);
      const float corr = expf(m[i] - m_new);
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = valid[j] ? expf(s[i][j] - m_new) : 0.0f;
        row_sum += s[i][j];
      }
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 4);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[i][d] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float4*>(&pT[(c * 8 + j) * (kBQ + kPad) + r * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(&pT[j * (kBQ + kPad) + r * 4]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int u = 0; u < DPT; u += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&vS[j * D + c * DPT + u]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][u] = fmaf(pv[i], vv.x, acc[i][u]);
          acc[i][u + 1] = fmaf(pv[i], vv.y, acc[i][u + 1]);
          acc[i][u + 2] = fmaf(pv[i], vv.z, acc[i][u + 2]);
          acc[i][u + 3] = fmaf(pv[i], vv.w, acc[i][u + 3]);
        }
      }
    }
  }

  T* o = static_cast<T*>(a.o) + b * a.o_bstride + static_cast<int64_t>(h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + r * 4 + i;
    if (row >= a.Sq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int d = 0; d < DPT; ++d) o[row * q_row + c * DPT + d] = Vec<T>::store(acc[i][d] * inv);
  }
}

template <typename T, int D>
int launch(const Args& a, int64_t B, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(D) * (kBQ + kPad) + static_cast<size_t>(D) * (kBK + kPad) +
                       static_cast<size_t>(kBK) * D + static_cast<size_t>(kBK) * (kBQ + kPad));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a.Sq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(B * a.H));
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
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
extern "C" int flash_attention_launch(int device, int dtype, const void* q, const void* k,
                                      const void* v, void* o, long long B, long long Sq,
                                      long long Sk, int H, int Hkv, int D,
                                      long long q_bstride, long long kv_bstride,
                                      long long o_bstride, float scale, int causal,
                                      int window, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.Sq = Sq;
  a.Sk = Sk;
  a.q_bstride = q_bstride;
  a.kv_bstride = kv_bstride;
  a.o_bstride = o_bstride;
  a.scale = scale;
  a.H = H;
  a.Hkv = Hkv;
  a.causal = causal;
  a.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(a, B, D, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(a, B, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
