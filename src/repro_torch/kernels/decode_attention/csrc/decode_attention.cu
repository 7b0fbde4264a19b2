// Single-token GQA attention over a KV cache (decode) for Hopper (sm_90a):
// split-KV, a split pass and a combine pass.
//
// Replaces the Pallas TPU kernel decode_attention_pallas of
// src/repro/kernels/decode_attention/kernel.py. For every batch row b and
// query head h = hk * G + g (G = H / Hkv query heads share KV head hk),
// over the cache slots j < lengths[b] (clamped to S):
//   s_j = (q_h . k[b, j, hk]) * D^-1/2,   o_h = sum_j softmax(s)_j v[b, j, hk],
// with scores, softmax and accumulation in float32 from float32 or bf16
// inputs, and the output acc / max(l, 1e-30) in the input type.
//
// Layout: q and o (B, H, D), k and v (B, S, Hkv, D), all contiguous;
// lengths (B,) int32 on the device, never read by the host.
//
// Bound: bytes. A launch must read the valid K and V rows once (16.8 MB in
// bf16 over recurrentgemma-2b's 2048-slot rings at B 8, Hkv 1, D 256;
// 18.9 MB at qwen1.5-0.5b's B 8, Hkv 16, 576 slots, D 64) and does 4 G D
// flops per slot, far below the card's ratio. Design:
// - Split pass, grid (n_split, Hkv * ceil(G / 16), B). The cache's kBK-slot
//   tiles are cut into n_split contiguous slices (slice s holds tiles
//   [s * n_tiles / n_split, (s + 1) * n_tiles / n_split)); each block takes
//   one slice for up to 16 query heads of one KV head, so every KV byte is
//   read once per group of heads, and writes a float32 partial: running max
//   m, sum l and the unnormalised acc[g][D]. The host picks n_split from the
//   shapes alone (about two blocks per SM, the partials under ~15 % of the
//   K/V bytes): with MQA the cache itself has to be split to fill the card.
//   A slice at or past lengths[b] writes m = -inf, l = 0 and exits.
// - K and V tiles stay in their own type in shared memory and arrive by
//   cp.async, 16 bytes a thread, neighbouring threads on neighbouring
//   addresses, L2 evict_first (read once), in a ring of stages (bf16: up
//   to ~100 KB, so a slice of the serving shapes is in flight at once;
//   float32: two), so the next tiles' loads overlap this tile's scores and
//   P.V. The ragged tail is
//   zero-filled, never read past the slice or the length. Rows are padded
//   by 16 bytes, so ldmatrix and the 16-byte row loads hit distinct banks.
// - bf16 with G >= 8 (recurrentgemma-2b's 10 heads on one KV head): both
//   products on the tensor cores, mma.sync m16n8k16 with float32
//   accumulation, the G heads padded to the mma's 16 rows. Each of the 4
//   warps scores 8 slots of the tile (q's fragments held in registers, the
//   scale applied to the float32 scores) and, after the softmax, sums P.V
//   for a quarter of D. P is split into P_hi = bf16(P) and P_lo = bf16(P -
//   P_hi) and both products go into one float32 accumulator, so P carries
//   ~16 bits and the result stays within one bf16 rounding of the plain
//   version.
// - float32, and bf16 with fewer heads a KV head (qwen1.5-0.5b has one,
//   where 15 of the mma's 16 rows would be padding): the same slices,
//   tiles and softmax, the products as float32 FMA loops on the CUDA cores
//   (four threads a score, one thread a (head, d) of the output).
// - The online softmax runs in shared memory, 8 threads a head.
// - Combine pass, grid (D / 64, H, B), a programmatic dependent launch (its
//   blocks wait on the card for the split pass instead of being launched
//   after it): merges the slices in a fixed order, o = sum_s e^{m_s - M}
//   acc_s / max(sum_s e^{m_s - M} l_s, 1e-30), skipping empty slices; the
//   slices' partials are loaded before their weights are known. No
//   atomics: reruns are bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBK = 32;        // cache slots per tile (TILE of ref.py)
constexpr int kRows = 16;      // query heads per block: the mma's M
constexpr int kThreads = 128;  // 4 warps on the CUDA cores, 8 (kMmaThreads) on the tensor cores
constexpr int kMmaThreads = 256;
constexpr int kSP = kBK + 8;   // row stride of the score tile (floats)
constexpr float kNegInf = -1.0e30f;
constexpr int kMmaHeads = 8;   // bf16 takes the tensor cores from this many heads a KV head

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* lengths;
  float* part_acc;  // (B, Hkv, n_split, G, D)
  float* part_ml;   // (B, Hkv, n_split, G, 2): m, l
  int64_t S;
  float scale;  // D^-1/2, rounded to float32 as the reference rounds it
  int H, Hkv, n_split, n_tiles;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously, zero-filled (nothing read)
// when !valid, under an L2 cache policy: q, K and V are read once a
// launch, so they go in as evict_first and make room for each other rather
// than for what other kernels keep in L2.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}
__device__ __forceinline__ void cp_async16_once(void* dst, const void* src, bool valid,
                                                uint64_t policy) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0), "l"(policy)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {  // all groups but the newest N
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
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
__device__ __forceinline__ void split_bf16x2(float2 x, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x.x, x.y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x.x - hf.x, x.y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Tiles in flight per block: bf16 holds ~100 KB of K/V tiles or less (a
// slice of the serving shapes whole: 2-3 tiles of the ring, 6 of qwen's
// cache), so a block issues its slice's loads at once; float32
// double-buffers.
template <typename T, int D>
__host__ __device__ constexpr int stages() {
  return sizeof(T) == 4 ? 2 : D >= 256 ? 3 : D >= 128 ? 4 : D >= 64 ? 6 : 8;
}

// Shared memory of one split-pass block, in bytes: q [kRows][RS], K and V
// [stages][kBK][RS] in T; scores [kRows][kSP] (two halves over D on the
// tensor cores), m, l, corr [kRows] and, on the CUDA cores, acc [kRows][D]
// in float.
template <typename T, int D, bool MMA>
constexpr size_t split_smem_bytes() {
  constexpr size_t RS = D + 16 / sizeof(T);
  return sizeof(T) * RS * (kRows + 2 * stages<T, D>() * kBK) +
         sizeof(float) * ((MMA ? 2 : 1) * kRows * kSP + 3 * kRows + (MMA ? 0 : kRows * D));
}

// 8 elements of shared memory (16 bytes of bf16, 32 of float) as float.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// One block per (slice, KV head, group of up to 16 heads, batch row). MMA:
// both products on the tensor cores (bf16, G >= 8), 8 warps; otherwise FMA
// loops on the CUDA cores (float32, and bf16 with few heads a KV head,
// where the mma's 16 rows would be mostly padding), 4 warps. Tile t_lo + i
// arrives with cp.async commit group i (q with group 0).
template <typename T, int D, bool MMA>
__global__ void __launch_bounds__(MMA ? kMmaThreads : kThreads, MMA ? 2 : 1)
    decode_attention_split_kernel(Args a) {
  constexpr int NTH = MMA ? kMmaThreads : kThreads;
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int RS = D + E;          // padded row stride of q, K and V (elements)
  constexpr int CH = D / E;          // 16-byte chunks per row
  constexpr int ST = stages<T, D>();
  constexpr int PVW = D / 8 < 8 ? D / 8 : 8;    // warps that sum P.V on the tensor cores
  constexpr int NT = MMA ? D / (8 * PVW) : 1;  // their output n-tiles of 8
  constexpr int KH = D / 32;                   // k-steps of 16 in each half of D
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qS = reinterpret_cast<T*>(smem_raw);                    // [kRows][RS]
  T* kS = qS + kRows * RS;                                   // [ST][kBK][RS]
  T* vS = kS + ST * kBK * RS;                                // [ST][kBK][RS]
  float* sS = reinterpret_cast<float*>(vS + ST * kBK * RS);  // [kRows][kSP]: scores, then p
  float* sS1 = sS + kRows * kSP;                             // tensor cores: second half of D
  float* mS = sS1 + (MMA ? kRows * kSP : 0);                 // running max
  float* lS = mS + kRows;                                    // running sum
  float* cS = lS + kRows;                                    // this tile's correction
  float* accS = cS + kRows;                                  // [kRows][D], CUDA cores only

  const int split = blockIdx.x;
  const int n_gc = (a.H / a.Hkv + kRows - 1) / kRows;
  const int hk = blockIdx.y / n_gc;
  const int g0 = (blockIdx.y % n_gc) * kRows;
  const int b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const int Gc = G - g0 < kRows ? G - g0 : kRows;  // heads of this block
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // q first: it does not wait for the length.
  const uint64_t once = evict_first_policy();
  const T* q = static_cast<const T*>(a.q) + (static_cast<int64_t>(b) * a.H + hk * G + g0) * D;
  for (int idx = tid; idx < kRows * CH; idx += NTH) {  // heads past Gc are zero
    const int r = idx / CH;
    const int c = idx % CH;
    cp_async16_once(qS + r * RS + c * E, r < Gc ? q + r * D + c * E : q, r < Gc, once);
  }

  int64_t len = a.lengths[b];
  if (len > a.S) len = a.S;
  if (len < 0) len = 0;
  const int64_t t_lo = static_cast<int64_t>(split) * a.n_tiles / a.n_split;
  const int64_t t_hi = static_cast<int64_t>(split + 1) * a.n_tiles / a.n_split;
  const int64_t lo = t_lo * kBK;
  const int64_t hi = t_hi * kBK < len ? t_hi * kBK : len;  // slots [lo, hi)

  const int64_t prow = ((static_cast<int64_t>(b) * a.Hkv + hk) * a.n_split + split) * G + g0;
  float* pacc = a.part_acc + prow * D;
  float* pml = a.part_ml + prow * 2;
  if (lo >= hi) {  // nothing of this row in the slice
    if (tid < Gc) {
      pml[tid * 2] = -INFINITY;
      pml[tid * 2 + 1] = 0.0f;
    }
    cp_async_wait<0>();
    return;
  }

  const int64_t row = static_cast<int64_t>(a.Hkv) * D;
  const T* k = static_cast<const T*>(a.k) + static_cast<int64_t>(b) * a.S * row + hk * D;
  const T* v = static_cast<const T*>(a.v) + static_cast<int64_t>(b) * a.S * row + hk * D;
  auto load_tile = [&](int buf, int64_t t) {
    T* kd = kS + buf * kBK * RS;
    T* vd = vS + buf * kBK * RS;
    for (int idx = tid; idx < kBK * CH; idx += NTH) {
      const int j = idx / CH;
      const int c = idx % CH;
      const int64_t slot = t * kBK + j;
      const bool valid = slot < hi;
      const int64_t off = valid ? slot * row + c * E : 0;
      cp_async16_once(kd + j * RS + c * E, k + off, valid, once);
      cp_async16_once(vd + j * RS + c * E, v + off, valid, once);
    }
  };
  const int64_t t_end = (hi + kBK - 1) / kBK;
  for (int st = 0; st < ST; ++st) {  // group st: tile t_lo + st (group 0 also q)
    if (t_lo + st < t_end) load_tile(st, t_lo + st);
    cp_async_commit();
  }

  if (tid < kRows) {
    mS[tid] = kNegInf;
    lS[tid] = 0.0f;
  }
  if constexpr (!MMA) {
    for (int idx = tid; idx < Gc * D; idx += NTH) accS[idx] = 0.0f;
  }
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  // Tensor cores: warp w scores slots (w % 4) * 8 .. +7 over half w / 4 of
  // D, holding q's A fragments of that half.
  const int sg = warp & 3;
  const int kh = warp >> 2;
  uint32_t qf[MMA ? KH : 1][4];
  if constexpr (MMA) {
    cp_async_wait<ST - 1>();  // q and tile t_lo
    __syncthreads();
#pragma unroll
    for (int i = 0; i < KH; ++i) {
      ldmatrix_x4(qf[i], qS + (lane & 15) * RS + (kh * KH + i) * 16 + (lane >> 4) * 8);
    }
  }

  for (int64_t t = t_lo; t < t_end; ++t) {
    const int buf = static_cast<int>((t - t_lo) % ST);
    cp_async_wait<ST - 1>();
    __syncthreads();  // tile t visible to every thread
    const T* kT = kS + buf * kBK * RS;
    const T* vT = vS + buf * kBK * RS;

    // Scores of the tile: on the tensor cores two raw halves over D (sS,
    // sS1), scaled and masked by the softmax; on the CUDA cores scaled and
    // masked at hi (rows < Gc).
    if constexpr (MMA) {
      float c[2][4] = {};  // two accumulators: short chains
#pragma unroll
      for (int i = 0; i < KH; ++i) {
        uint32_t b0, b1;  // K rows sg*8 .. +7 at dims of k-step kh*KH + i
        ldmatrix_x2(b0, b1, kT + (sg * 8 + (lane & 7)) * RS + (kh * KH + i) * 16 +
                                ((lane >> 3) & 1) * 8);
        mma_bf16(c[i & 1], qf[i], b0, b1);
      }
      float* dst = kh ? sS1 : sS;
      const int col = sg * 8 + (lane & 3) * 2;
      const int r = lane >> 2;
      *reinterpret_cast<float2*>(&dst[r * kSP + col]) =
          make_float2(c[0][0] + c[1][0], c[0][1] + c[1][1]);
      *reinterpret_cast<float2*>(&dst[(r + 8) * kSP + col]) =
          make_float2(c[0][2] + c[1][2], c[0][3] + c[1][3]);
    } else {  // 4 threads a score, a quarter of D each
      for (int idx = tid; idx < Gc * kBK * 4; idx += NTH) {
        const int part = idx & 3;
        const int j = (idx >> 2) % kBK;
        const int g = idx / (4 * kBK);
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < D / 32; ++i) {
          const int d = part * (D / 4) + i * 8;
          float qv[8], kv[8];
          load8(qS + g * RS + d, qv);
          load8(kT + j * RS + d, kv);
#pragma unroll
          for (int e = 0; e < 8; ++e) s = fmaf(qv[e], kv[e], s);
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (part == 0) sS[g * kSP + j] = t * kBK + j < hi ? s * a.scale : kNegInf;
      }
    }
    __syncthreads();

    if (tid < kThreads) {  // online softmax: 8 threads a row, 4 slots each; p replaces scores
      const int r = tid >> 3;
      const int c0 = (tid & 7) * 4;
      float4 s4 = make_float4(kNegInf, kNegInf, kNegInf, kNegInf);  // rows past Gc: p = 0
      if (r < Gc) s4 = *reinterpret_cast<const float4*>(&sS[r * kSP + c0]);
      if constexpr (MMA) {
        if (r < Gc) {
          const float4 h1 = *reinterpret_cast<const float4*>(&sS1[r * kSP + c0]);
          const int64_t slot = t * kBK + c0;
          s4.x = slot < hi ? (s4.x + h1.x) * a.scale : kNegInf;
          s4.y = slot + 1 < hi ? (s4.y + h1.y) * a.scale : kNegInf;
          s4.z = slot + 2 < hi ? (s4.z + h1.z) * a.scale : kNegInf;
          s4.w = slot + 3 < hi ? (s4.w + h1.w) * a.scale : kNegInf;
        }
      }
      float mx = fmaxf(fmaxf(s4.x, s4.y), fmaxf(s4.z, s4.w));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_old = mS[r];
      const float m_new = fmaxf(m_old, mx);
      s4.x = s4.x > kNegInf ? expf(s4.x - m_new) : 0.0f;
      s4.y = s4.y > kNegInf ? expf(s4.y - m_new) : 0.0f;
      s4.z = s4.z > kNegInf ? expf(s4.z - m_new) : 0.0f;
      s4.w = s4.w > kNegInf ? expf(s4.w - m_new) : 0.0f;
      *reinterpret_cast<float4*>(&sS[r * kSP + c0]) = s4;
      float sum = (s4.x + s4.y) + (s4.z + s4.w);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      __syncwarp();
      if ((tid & 7) == 0) {
        const float corr = expf(m_old - m_new);
        lS[r] = lS[r] * corr + sum;
        mS[r] = m_new;
        cS[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p . V
    if constexpr (MMA) {  // warp w < PVW: columns [w D/PVW, (w + 1) D/PVW)
      if (warp < PVW) {
        const float c_lo = cS[lane >> 2];
        const float c_hi = cS[(lane >> 2) + 8];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          o[n][0] *= c_lo;
          o[n][1] *= c_lo;
          o[n][2] *= c_hi;
          o[n][3] *= c_hi;
        }
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks) {
          // A fragments of p (rows lane/4 and +8, slots ks*16 + (lane%4)*2 and +8),
          // split into P_hi + P_lo.
          const float* p0 = &sS[(lane >> 2) * kSP + ks * 16 + (lane & 3) * 2];
          uint32_t ah[4], al[4];
          split_bf16x2(*reinterpret_cast<const float2*>(p0), ah[0], al[0]);
          split_bf16x2(*reinterpret_cast<const float2*>(p0 + 8 * kSP), ah[1], al[1]);
          split_bf16x2(*reinterpret_cast<const float2*>(p0 + 8), ah[2], al[2]);
          split_bf16x2(*reinterpret_cast<const float2*>(p0 + 8 * kSP + 8), ah[3], al[3]);
          const T* vrow =
              vT + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + warp * (D / PVW);
          if constexpr (NT >= 2) {
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {
              uint32_t vb[4];
              ldmatrix_x4_trans(vb, vrow + np * 16 + (lane >> 4) * 8);
              mma_bf16(o[2 * np], ah, vb[0], vb[1]);
              mma_bf16(o[2 * np], al, vb[0], vb[1]);
              mma_bf16(o[2 * np + 1], ah, vb[2], vb[3]);
              mma_bf16(o[2 * np + 1], al, vb[2], vb[3]);
            }
          } else {
            uint32_t vb0, vb1;
            ldmatrix_x2_trans(vb0, vb1, vrow);
            mma_bf16(o[0], ah, vb0, vb1);
            mma_bf16(o[0], al, vb0, vb1);
          }
        }
      }
    } else {
      for (int idx = tid; idx < Gc * D; idx += NTH) {
        const int g = idx / D;
        const int d = idx % D;
        float acc = accS[idx] * cS[g];
#pragma unroll 8
        for (int j = 0; j < kBK; ++j) acc = fmaf(sS[g * kSP + j], to_float(vT[j * RS + d]), acc);
        accS[idx] = acc;
      }
    }
    // The next tile's barriers order the scores and p of this one; only a
    // buffer that is loaded again waits here for its readers.
    if (t + ST < t_end) {
      __syncthreads();
      load_tile(buf, t + ST);
    }
    cp_async_commit();
  }

  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // the combine may launch
  // Partials: acc (unnormalised), m, l of heads g0 .. g0 + Gc - 1.
  if constexpr (MMA) {
    const int r = lane >> 2;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = warp * (D / PVW) + n * 8 + (lane & 3) * 2;
      if (warp < PVW && r < Gc) {
        *reinterpret_cast<float2*>(&pacc[r * D + col]) = make_float2(o[n][0], o[n][1]);
      }
      if (warp < PVW && r + 8 < Gc) {
        *reinterpret_cast<float2*>(&pacc[(r + 8) * D + col]) = make_float2(o[n][2], o[n][3]);
      }
    }
  } else {
    for (int idx = tid; idx < Gc * D; idx += NTH) pacc[idx] = accS[idx];
  }
  if (tid < Gc) {
    pml[tid * 2] = mS[tid];
    pml[tid * 2 + 1] = lS[tid];
  }
}

// Grid (D / C, H, B), C = min(D, 64) columns a block, C x P threads (P =
// 256 / C). Launched as a programmatic dependent of the split pass (which
// lets it launch once every split block has reached its epilogue);
// griddepcontrol.wait holds it until the partials are complete and
// visible. Thread (p, d) loads acc[s][d] of slices s = p, p + P, ... into
// registers; warp 0 meanwhile turns the slices' (m, l) into weights
// e^{m_s - M} (in shared memory) and their sum sum_s e^{m_s - M} l_s; each
// thread sums its slices in order, and the P sums of each d are added in
// order of p.
constexpr int kPer = 8;
constexpr int kCombineThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kCombineThreads) decode_attention_combine_kernel(
    const float* part_acc, const float* part_ml, T* o, int H, int Hkv, int n_split, int D) {
  extern __shared__ float wS[];  // [n_split] weights
  __shared__ float red[kCombineThreads];  // [P][C] sums over slices p, p + P, ...
  __shared__ float den_s;
  const int C = D < 64 ? D : 64;
  const int P = kCombineThreads / C;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int p = threadIdx.x / C;
  const int64_t first = (static_cast<int64_t>(b) * Hkv + h / G) * n_split * G + h % G;
  const int64_t stride = static_cast<int64_t>(G) * D;  // from one slice to the next
  const float* accp = part_acc + first * D + blockIdx.x * C + threadIdx.x % C;
  const float2* mlp = reinterpret_cast<const float2*>(part_ml) + first;  // (m, l), stride G
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  float x[kPer];  // slices past n_split read the last one again, weighed 0 below
#pragma unroll
  for (int i = 0; i < kPer; ++i) x[i] = accp[min(p + i * P, n_split - 1) * stride];
  if (threadIdx.x < 32) {
    float M = -INFINITY;
    for (int s = threadIdx.x; s < n_split; s += 32) {
      const float2 ml = mlp[static_cast<int64_t>(s) * G];
      if (ml.y > 0.0f) M = fmaxf(M, ml.x);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    float den = 0.0f;
    for (int s = threadIdx.x; s < n_split; s += 32) {
      const float2 ml = mlp[static_cast<int64_t>(s) * G];
      const float w = ml.y > 0.0f ? expf(ml.x - M) : 0.0f;  // an empty slice weighs 0
      wS[s] = w;
      den = fmaf(w, ml.y, den);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) den += __shfl_xor_sync(0xffffffffu, den, off);
    if (threadIdx.x == 0) den_s = den;
  }
  __syncthreads();
  float num = 0.0f;  // an empty slice's acc was never written: skipped, not weighed
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int s = p + i * P;
    const float w = s < n_split ? wS[s] : 0.0f;
    num = fmaf(w, w > 0.0f ? x[i] : 0.0f, num);
  }
  for (int s = p + kPer * P; s < n_split; s += P) {
    const float w = wS[s];
    num = fmaf(w, w > 0.0f ? accp[s * stride] : 0.0f, num);
  }
  red[threadIdx.x] = num;
  __syncthreads();
  if (p == 0) {
    for (int i = 1; i < P; ++i) num += red[i * C + threadIdx.x];
    o[(static_cast<int64_t>(b) * H + h) * D + blockIdx.x * C + threadIdx.x] =
        from_float<T>(num / fmaxf(den_s, 1e-30f));
  }
}

template <typename T, int D, bool MMA>
int launch(const Args& a, void* o, int64_t B, cudaStream_t stream) {
  constexpr size_t smem = split_smem_bytes<T, D, MMA>();
  cudaError_t err = cudaFuncSetAttribute(decode_attention_split_kernel<T, D, MMA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_gc = (a.H / a.Hkv + kRows - 1) / kRows;
  const dim3 grid(static_cast<unsigned>(a.n_split), static_cast<unsigned>(a.Hkv * n_gc),
                  static_cast<unsigned>(B));
  decode_attention_split_kernel<T, D, MMA>
      <<<grid, MMA ? kMmaThreads : kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int C = D < 64 ? D : 64;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(D / C), static_cast<unsigned>(a.H),
                     static_cast<unsigned>(B));
  cfg.blockDim = dim3(kCombineThreads);
  cfg.dynamicSmemBytes = sizeof(float) * static_cast<size_t>(a.n_split);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, decode_attention_combine_kernel<T>,
                                             static_cast<const float*>(a.part_acc),
                                             static_cast<const float*>(a.part_ml),
                                             static_cast<T*>(o), a.H, a.Hkv, a.n_split, D));
}

template <typename T, bool MMA>
int launch_d(const Args& a, void* o, int64_t B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32, MMA>(a, o, B, stream);
    case 64: return launch<T, 64, MMA>(a, o, B, stream);
    case 128: return launch<T, 128, MMA>(a, o, B, stream);
    case 256: return launch<T, 256, MMA>(a, o, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches the split and combine passes on `stream` (no synchronisation).
// dtype: 0 float32, 1 bfloat16. `part` is float32 scratch of
// B * Hkv * n_split * G * (D + 2) elements, 1 <= n_split <= ceil(S / 32).
// Returns a cudaError_t code: 0 on success.
extern "C" int decode_attention_launch(int device, int dtype, const void* q, const void* k,
                                       const void* v, const void* lengths, void* o, void* part,
                                       long long B, long long S, int H, int Hkv, int D,
                                       int n_split, float scale, void* stream) {
  if (B <= 0) return 0;
  const long long n_tiles = (S + kBK - 1) / kBK;
  if (n_split < 1 || n_split > n_tiles) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.lengths = static_cast<const int32_t*>(lengths);
  a.part_acc = static_cast<float*>(part);
  a.part_ml = a.part_acc + B * Hkv * static_cast<long long>(n_split) * (H / Hkv) * D;
  a.S = S;
  a.scale = scale;
  a.H = H;
  a.Hkv = Hkv;
  a.n_split = n_split;
  a.n_tiles = static_cast<int>(n_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float, false>(a, o, B, D, s);
  if (dtype == 1 && H / Hkv >= kMmaHeads) return launch_d<__nv_bfloat16, true>(a, o, B, D, s);
  if (dtype == 1) return launch_d<__nv_bfloat16, false>(a, o, B, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
