// Blocked online-softmax attention (prefill) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_pallas of
// src/repro/kernels/flash_attention/kernel.py (body _kernel), together with
// the GQA repeat of src/repro/kernels/flash_attention/ops.py. For every
// batch b, query head h and query row i (queries right-aligned to the key
// span: q_pos = i + Sk - Sq), over the keys j that pass the mask
//   j < Sk,  causal: q_pos >= j,  window w > 0: j > q_pos - w,
//   s_j = (q_i . k_j) * D^-1/2,   o_i = sum_j softmax(s)_j v_j,
// with scores, softmax and accumulation in float32 from float32 or bf16
// inputs, and the output acc / max(l, 1e-30) in the input type. Query head
// h reads key/value head h / G (G = H / Hkv) directly: no repeat.
//
// Layout: q and o are (B, Sq, H, D), k and v (B, Sk, Hkv, D), each with
// its dims after the first contiguous and a batch stride of its own (so a
// prefix of a KV cache is read in place).
//
// Bound: at qwen1.5-0.5b's prefill (B 8, H 16, S 512, D 64, causal, bf16)
// bytes: q, k, v and o move 33.6 MB once, 0.0100 ms at 3.35 TB/s, against
// 4.30 GFLOP. At recurrentgemma-2b's (B 8, S 2304, 10 heads on 1 KV head of
// 256, window 2048) operations: 214.8 GFLOP, 0.217 ms at the dense bf16
// peak. Both kernels below visit only the key tiles that the causal and
// window bounds let some row of the query tile see (the Pallas kernel
// visits and masks them all), walk the query tiles longest first, and
// zero-fill the ragged tail: nothing is read past Sq or Sk.
//
// bf16 (the serving path), flash_attention_mma_kernel: one block of 4
// warps per (b, h, 64-row query tile), each warp owning 16 query rows. Both
// products run on the tensor cores, mma.sync m16n8k16 with float32
// accumulation and fragments loaded by ldmatrix; the scale multiplies the
// float32 scores after the product, so q is rounded once, as given. K and V
// tiles (64 keys, 32 at D 256 to keep the 16 x 256 float32 output block
// and the scores of a warp in registers) arrive by cp.async in a 2-stage
// pipeline: tile t + 1 is in flight while tile t is computed. Rows in
// shared memory are padded by 16 bytes, so ldmatrix's eight row addresses
// hit distinct banks. The softmax runs in registers on the score
// fragments (each row's max and sum over its 4 lanes by shuffles); masks
// are applied only on tiles that cross a bound. P.V splits P into P_hi =
// bf16(P) and P_lo = bf16(P - P_hi), both products into one float32
// accumulator: P keeps ~16 bits, and the output stays within one bf16
// rounding of the plain version (one rounding of P would not).
//
// float32 (not on the serving path), flash_attention_fma_kernel: the same
// tiles and bounds with both products as FP32 FMA loops on the CUDA cores
// (64 x 64 tiles staged as float32; each thread owns a 4 x 8 block of
// scores and a 4 x D/8 block of the output).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kThreads = 128;  // 4 warps
constexpr float kNegInf = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

// The block's (b, h, query tile) and the key tiles [t_first, t_end) that
// can hold an unmasked key for some row of the tile.
struct Tile {
  int b, h, hk;
  int64_t q0, off, t_first, t_end;

  __device__ Tile(const Args& a, int bk) {
    const int n_q = static_cast<int>((a.Sq + kBQ - 1) / kBQ);
    const int qi = n_q - 1 - static_cast<int>(blockIdx.x);  // longest causal tiles first
    b = static_cast<int>(blockIdx.y) / a.H;
    h = static_cast<int>(blockIdx.y) % a.H;
    hk = h / (a.H / a.Hkv);
    q0 = static_cast<int64_t>(qi) * kBQ;
    off = a.Sk - a.Sq;  // queries right-aligned to the keys
    const int64_t pos_lo = q0 + off;
    const int64_t pos_hi = (q0 + kBQ < a.Sq ? q0 + kBQ : a.Sq) - 1 + off;
    int64_t kv_end = a.Sk;
    if (a.causal && pos_hi + 1 < kv_end) kv_end = pos_hi + 1;
    int64_t kv_start = 0;
    if (a.window && pos_lo - a.window + 1 > 0) kv_start = pos_lo - a.window + 1;
    t_first = kv_start / bk;
    t_end = kv_end > kv_start ? (kv_end + bk - 1) / bk : t_first;
  }
};

// Row 0 of head `head` of batch b in a (B, S, heads, D) tensor.
template <typename T>
__device__ __forceinline__ T* head_base(T* x, int64_t bstride, int b, int head, int D) {
  return x + b * bstride + static_cast<int64_t>(head) * D;
}

__device__ __forceinline__ bool key_visible(const Args& a, int64_t pos, int64_t key) {
  return key < a.Sk && (!a.causal || pos >= key) && (!a.window || key > pos - a.window);
}

// ---- bf16 on the tensor cores ------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled (nothing read)
// when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prev() {  // all groups but the newest
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) . b (16 x 8, col): bf16 in, float32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) as two bf16 pairs, hi = bf16(x) and lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int D>
__host__ __device__ constexpr int mma_bk() { return D >= 256 ? 32 : 64; }  // keys per tile

template <int D>
constexpr size_t mma_smem_bytes() {  // q [kBQ][D + 8], K and V [2][BK][D + 8], bf16
  return sizeof(__nv_bfloat16) * (D + 8) * (kBQ + 4 * mma_bk<D>());
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attention_mma_kernel(Args a) {
  using bf16 = __nv_bfloat16;
  constexpr int BK = mma_bk<D>();
  constexpr int RS = D + 8;   // padded row stride (elements)
  constexpr int CH = D / 8;   // 16-byte chunks per row
  constexpr int NT = BK / 8;  // score n-tiles of a warp
  constexpr int OT = D / 8;   // output n-tiles of a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qS = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][RS]
  bf16* kS = qS + kBQ * RS;                      // [2][BK][RS]
  bf16* vS = kS + 2 * BK * RS;                   // [2][BK][RS]

  const Tile tile(a, BK);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int64_t q_row = static_cast<int64_t>(a.H) * D;
  const int64_t kv_row = static_cast<int64_t>(a.Hkv) * D;
  const bf16* q = head_base(static_cast<const bf16*>(a.q), a.q_bstride, tile.b, tile.h, D);
  const bf16* k = head_base(static_cast<const bf16*>(a.k), a.kv_bstride, tile.b, tile.hk, D);
  const bf16* v = head_base(static_cast<const bf16*>(a.v), a.kv_bstride, tile.b, tile.hk, D);

  for (int idx = tid; idx < kBQ * CH; idx += kThreads) {
    const int r = idx / CH;
    const int c = idx % CH;
    const bool valid = tile.q0 + r < a.Sq;
    cp_async16(qS + r * RS + c * 8, valid ? q + (tile.q0 + r) * q_row + c * 8 : q, valid);
  }
  auto load_kv = [&](int buf, int64_t t) {
    bf16* kd = kS + buf * BK * RS;
    bf16* vd = vS + buf * BK * RS;
    for (int idx = tid; idx < BK * CH; idx += kThreads) {
      const int j = idx / CH;
      const int c = idx % CH;
      const int64_t key = t * BK + j;
      const bool valid = key < a.Sk;
      const int64_t off = valid ? key * kv_row + c * 8 : 0;
      cp_async16(kd + j * RS + c * 8, k + off, valid);
      cp_async16(vd + j * RS + c * 8, v + off, valid);
    }
  };
  if (tile.t_first < tile.t_end) load_kv(0, tile.t_first);
  cp_async_commit();

  // This thread's rows of the tile: r0 = warp*16 + lane/4 and r0 + 8.
  const int r0 = warp * 16 + (lane >> 2);
  const int64_t pos0 = tile.q0 + r0 + tile.off;
  const int64_t pos_min = tile.q0 + tile.off;
  const int64_t pos_max = tile.q0 + kBQ - 1 + tile.off;
  float o[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};  // this thread's part of the row sums

  for (int64_t t = tile.t_first; t < tile.t_end; ++t) {
    const int buf = static_cast<int>(t - tile.t_first) & 1;
    if (t + 1 < tile.t_end) load_kv(buf ^ 1, t + 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // tile t (and q) visible to every thread
    const bf16* kT = kS + buf * BK * RS;
    const bf16* vT = vS + buf * BK * RS;

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      ldmatrix_x4(qa, qS + (warp * 16 + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {  // keys np*16 .. +15: (b0, b1) of two n-tiles
        uint32_t kb[4];
        ldmatrix_x4(kb, kT + (np * 16 + (lane & 7) + (lane >> 4) * 8) * RS + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
      }
    }

    // Scale; mask only a tile that crosses the end of the keys or a bound.
    const int64_t k0 = t * BK;
    const bool edge = k0 + BK > a.Sk || (a.causal && k0 + BK - 1 > pos_min) ||
                      (a.window && k0 <= pos_max - a.window);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= a.scale;
        if (edge && !key_visible(a, pos0 + (e >> 1) * 8, k0 + n * 8 + (lane & 3) * 2 + (e & 1))) {
          s[n][e] = kNegInf;
        }
      }
    }

    // Online softmax on the fragments: row i = e / 2 (rows r0, r0 + 8).
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = exp2f((m[i] - m_new) * kLog2e);
      m[i] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          s[n][e] = s[n][e] > kNegInf ? exp2f((s[n][e] - m_new) * kLog2e) : 0.0f;
          sum += s[n][e];
        }
      }
      l[i] = l[i] * corr[i] + sum;
    }
#pragma unroll
    for (int n = 0; n < OT; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // o += P_hi . V + P_lo . V; the A fragments of P are the score
    // fragments of n-tiles 2 ks and 2 ks + 1.
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t ah[4], al[4];
      split_bf16x2(s[2 * ks][0], s[2 * ks][1], ah[0], al[0]);
      split_bf16x2(s[2 * ks][2], s[2 * ks][3], ah[1], al[1]);
      split_bf16x2(s[2 * ks + 1][0], s[2 * ks + 1][1], ah[2], al[2]);
      split_bf16x2(s[2 * ks + 1][2], s[2 * ks + 1][3], ah[3], al[3]);
      const bf16* vrow = vT + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + (lane >> 4) * 8;
#pragma unroll
      for (int np = 0; np < OT / 2; ++np) {  // dims np*16 .. +15: (b0, b1) of two n-tiles
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vrow + np * 16);
        mma_bf16(o[2 * np], ah, vb[0], vb[1]);
        mma_bf16(o[2 * np], al, vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], ah, vb[2], vb[3]);
        mma_bf16(o[2 * np + 1], al, vb[2], vb[3]);
      }
    }
    __syncthreads();  // the buffer is free for tile t + 2
  }

  bf16* out = static_cast<bf16*>(a.o) + tile.b * a.o_bstride + static_cast<int64_t>(tile.h) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int64_t row = tile.q0 + r0 + 8 * i;
    if (row >= a.Sq) continue;
    const float inv = 1.0f / fmaxf(sum, 1e-30f);
#pragma unroll
    for (int n = 0; n < OT; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(&out[row * q_row + n * 8 + (lane & 3) * 2]) =
          __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    }
  }
}

// ---- float32 on the CUDA cores -----------------------------------------

constexpr int kBK = 64;  // keys per tile of the FMA kernel
constexpr int kPad = 4;  // row padding of the transposed tiles (floats)

// Stages rows [row0, row0 + ROWS) of one head of x (rows of `row_stride`
// floats, D contiguous) times scale, transposed to dst[d][row] (row stride
// ROWS + kPad). Rows at or past n_rows are zero.
template <int D, int ROWS>
__device__ void stage_transposed(float* dst, const float* x, int64_t row0, int64_t n_rows,
                                 int64_t row_stride, float scale) {
  constexpr int NV = D / 4;
  for (int idx = threadIdx.x; idx < ROWS * NV; idx += kThreads) {
    const int i = idx % ROWS;  // consecutive threads: consecutive rows
    const int dv = idx / ROWS;
    float4 vals = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + i < n_rows) {
      vals = *reinterpret_cast<const float4*>(x + (row0 + i) * row_stride + dv * 4);
    }
    dst[(dv * 4 + 0) * (ROWS + kPad) + i] = vals.x * scale;
    dst[(dv * 4 + 1) * (ROWS + kPad) + i] = vals.y * scale;
    dst[(dv * 4 + 2) * (ROWS + kPad) + i] = vals.z * scale;
    dst[(dv * 4 + 3) * (ROWS + kPad) + i] = vals.w * scale;
  }
}

// Stages rows of x row-major, dst[row][d]; zero past n_rows.
template <int D, int ROWS>
__device__ void stage_rows(float* dst, const float* x, int64_t row0, int64_t n_rows,
                           int64_t row_stride) {
  constexpr int NV = D / 4;
  for (int idx = threadIdx.x; idx < ROWS * NV; idx += kThreads) {
    const int j = idx / NV;
    const int dv = idx % NV;
    float4 vals = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + j < n_rows) {
      vals = *reinterpret_cast<const float4*>(x + (row0 + j) * row_stride + dv * 4);
    }
    *reinterpret_cast<float4*>(&dst[j * D + dv * 4]) = vals;
  }
}

template <int D>
constexpr size_t fma_smem_bytes() {  // qT, kT [D][64 + kPad], V [64][D], pT [64][64 + kPad]
  return sizeof(float) * (2 * static_cast<size_t>(D) * (kBQ + kPad) + static_cast<size_t>(kBK) * D +
                          static_cast<size_t>(kBK) * (kBQ + kPad));
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attention_fma_kernel(Args a) {
  constexpr int DPT = D / 8;  // output dims per thread
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;                          // [D][kBQ + kPad]
  float* kT = qT + D * (kBQ + kPad);         // [D][kBK + kPad]
  float* vS = kT + D * (kBK + kPad);         // [kBK][D]
  float* pT = vS + kBK * D;                  // [kBK][kBQ + kPad]

  const Tile tile(a, kBK);
  const int tid = threadIdx.x;
  const int r = tid / 8;  // row group: rows r*4 .. r*4+3
  const int c = tid % 8;  // column group: keys c*8 .. c*8+7, dims c*DPT ..

  const float* q = head_base(static_cast<const float*>(a.q), a.q_bstride, tile.b, tile.h, D);
  const float* k = head_base(static_cast<const float*>(a.k), a.kv_bstride, tile.b, tile.hk, D);
  const float* v = head_base(static_cast<const float*>(a.v), a.kv_bstride, tile.b, tile.hk, D);
  const int64_t q_row = static_cast<int64_t>(a.H) * D;
  const int64_t kv_row = static_cast<int64_t>(a.Hkv) * D;

  stage_transposed<D, kBQ>(qT, q, tile.q0, a.Sq, q_row, a.scale);

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[i][d] = 0.0f;
  }

  for (int64_t t = tile.t_first; t < tile.t_end; ++t) {
    const int64_t k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done
    stage_transposed<D, kBK>(kT, k, k0, a.Sk, kv_row, 1.0f);
    stage_rows<D, kBK>(vS, v, k0, a.Sk, kv_row);
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
      const int64_t pos = tile.q0 + r * 4 + i + tile.off;
      bool valid[8];
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        valid[j] = key_visible(a, pos, k0 + c * 8 + j);
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

  float* o = static_cast<float*>(a.o) + tile.b * a.o_bstride + static_cast<int64_t>(tile.h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = tile.q0 + r * 4 + i;
    if (row >= a.Sq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int d = 0; d < DPT; ++d) o[row * q_row + c * DPT + d] = acc[i][d] * inv;
  }
}

// ---- launch --------------------------------------------------------------

template <typename Kernel>
int launch_kernel(Kernel kernel, size_t smem, const Args& a, int64_t B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a.Sq + kBQ - 1) / kBQ), static_cast<unsigned>(B * a.H));
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const Args& a, int dtype, int64_t B, cudaStream_t stream) {
  if (dtype == 0) {
    return launch_kernel(flash_attention_fma_kernel<D>, fma_smem_bytes<D>(), a, B, stream);
  }
  if (dtype == 1) {
    return launch_kernel(flash_attention_mma_kernel<D>, mma_smem_bytes<D>(), a, B, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches the kernel of `dtype` (0 float32: FMA, 1 bfloat16: tensor
// cores) on `stream` (no synchronisation). Returns a cudaError_t code: 0 on
// success.
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
  switch (D) {
    case 32: return launch<32>(a, dtype, B, s);
    case 64: return launch<64>(a, dtype, B, s);
    case 128: return launch<128>(a, dtype, B, s);
    case 256: return launch<256>(a, dtype, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
