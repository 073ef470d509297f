// Hand-written Hopper (sm_90a) flash-attention forward kernel.
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention/kernel.py):
// causal or full attention, grouped-query heads (q head h reads kv-head
// h / (H / KVH)), scale 1/sqrt(D), an online softmax over kv tiles with f32
// statistics and accumulation, masked scores -1e30 (kpos >= Skv, and
// qpos < kpos when causal), output acc / max(l, 1e-30) in q's dtype (bf16
// or f32).
//
// Bound: at Zamba2-2.7B's prefill shape (B 4, S 4096, H 32, D 80, causal)
// one call is ~344 GFLOP against ~0.17 GB of q, k, v and output, so it is
// bound by tensor-core operations (~0.35 ms at 989 TFLOP/s bf16). The design
// therefore puts both products on the tensor cores and keeps the S x S
// scores out of device memory:
//   - one block of 4 warps per (q tile of 64 rows, head, batch); each warp
//     owns 16 query rows, so the softmax statistics of a row live in the 4
//     lanes of one quad and are reduced with two shuffles;
//   - K and V tiles of 64 rows are staged in shared memory with cp.async
//     (rows past Skv are zero-filled), the V load overlapping Q.K^T and the
//     next K load overlapping P.V (FlashAttention-2's single-buffer scheme);
//   - Q.K^T and P.V run as mma.sync m16n8k16 (bf16 in, f32 accumulate) with
//     fragments loaded by ldmatrix; P is rounded to bf16 for the second
//     product, while the row sums l use the f32 probabilities;
//   - rows of shared memory are padded by 16 bytes so that ldmatrix reads
//     hit 8 distinct bank groups for every head dim that is a multiple of 16;
//   - the 1/sqrt(D) scale (times log2 e, for exp2) multiplies the f32
//     scores: that equals the Pallas kernel's scaling of q in f32, because
//     bf16 products are exact in f32, where a bf16 copy of q*scale would add
//     a rounding the Pallas kernel does not have;
//   - causal blocks skip the kv tiles above the diagonal, and the grid
//     starts with the longest q tiles.
// wgmma, TMA and a persistent grid are later work.
//
// f32 inputs take a second kernel, flash_fwd_f32_kernel, which keeps the
// Pallas kernel's f32 arithmetic throughout (q * scale, both products and
// the probabilities in f32, exp rather than exp2) on the CUDA cores: the
// tensor cores have no f32 inputs, and rounding to bf16 or tf32 would break
// the f32 contract. It is bound by f32 operations (~5 ms at 67 TFLOP/s for
// one call at Zamba2's shape); no configuration of the repo serves in f32,
// so it is built for being right, not fast:
//   - one block of 128 threads per (q tile of 64 rows, head, batch), K and
//     V tiles of 32 rows; Q (scaled), K, V and the probabilities P are
//     staged in shared memory with an odd row pitch, so that column reads
//     are free of bank conflicts;
//   - each thread owns 4 query rows x 4 keys of the scores and 4 rows x D/8
//     columns of the output; a row's 32 scores sit in the 8 consecutive
//     lanes that share the row group, reduced with three shuffles.
//
// The head dim D is a template parameter (multiples of 16 up to 256), so the
// accumulators stay in registers. Every global offset is 64-bit.
//
// The extern "C" launcher takes the caller's stream, launches without
// synchronising, allocates nothing, and returns cudaGetLastError(). The
// Python wrapper (repro_torch/kernels/flash_attention/kernel.py) checks every
// argument before it calls.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // q rows per block, kv rows per tile
constexpr int kThreads = 128;  // 4 warps x 16 q rows
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes 0 zero-fills the destination.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage rows [0, rows) of a 64-row tile (row stride `stride` elements) into
// shared memory with row pitch D + 8; rows past `valid` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long stride,
                                          int valid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = r < valid;
    cp_async_16(smem_addr(dst + r * (D + 8) + col), src + (ok ? r : 0) * stride + col,
                ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Skv, int H,
                 int KVH, int causal, float scale_log2) {
  constexpr int LD = D + 8;  // padded row pitch, elements
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kTile * LD;
  bf16* sV = sK + kTile * LD;

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q0 = tile * kTile;
  const long long q_stride = static_cast<long long>(H) * D;
  const long long kv_stride = static_cast<long long>(KVH) * D;
  const bf16* qb = q + (static_cast<long long>(b) * Sq + q0) * q_stride +
                   static_cast<long long>(h) * D;
  const bf16* kb = k + static_cast<long long>(b) * Skv * kv_stride +
                   static_cast<long long>(kvh) * D;
  const bf16* vb = v + static_cast<long long>(b) * Skv * kv_stride +
                   static_cast<long long>(kvh) * D;

  int n_kv = (Skv + kTile - 1) / kTile;
  // causal: no kv tile starts past the block's last query row
  if (causal) n_kv = min(n_kv, (min(q0 + kTile, Sq) - 1) / kTile + 1);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  load_tile<D>(sQ, qb, q_stride, Sq - q0);
  load_tile<D>(sK, kb, kv_stride, Skv);
  cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_row[2] = {kNegInf, kNegInf}, l_row[2] = {0.f, 0.f};
  const int row_a = q0 + warp * 16 + g;  // this lane's rows: row_a, row_a + 8

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kTile;
    load_tile<D>(sV, vb + static_cast<long long>(k0) * kv_stride, kv_stride, Skv - k0);
    cp_async_commit();
    cp_async_wait<1>();  // Q and K_j have landed
    __syncthreads();

    // s = Q K_j^T for this warp's 16 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(smem_addr(sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8),
                  a[0], a[1], a[2], a[3]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b0, b1, b2, b3;
        const int key = np * 16 + (lane >> 4) * 8 + (lane & 7);
        const int col = kk * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(smem_addr(sK + key * LD + col), b0, b1, b2, b3);
        mma_bf16(s[2 * np], a, b0, b1);
        mma_bf16(s[2 * np + 1], a, b2, b3);
      }
    }

    // scale into the exp2 domain and mask; then the online softmax
    float mx[2] = {m_row[0], m_row[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row_a + (e >> 1) * 8;
        const int c = k0 + n * 8 + 2 * tq + (e & 1);
        const bool masked = c >= Skv || (causal && c > r);
        s[n][e] = masked ? kNegInf : s[n][e] * scale_log2;
      }
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float rs[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m_row[i] - mx[i]);
      m_row[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = exp2f(s[n][0] - mx[0]);
      s[n][1] = exp2f(s[n][1] - mx[0]);
      s[n][2] = exp2f(s[n][2] - mx[1]);
      s[n][3] = exp2f(s[n][3] - mx[1]);
      rs[0] += s[n][0] + s[n][1];
      rs[1] += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l_row[i] = l_row[i] * alpha[i] + rs[i];
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    cp_async_wait<0>();  // V_j has landed
    __syncthreads();     // and every warp is done with K_j
    if (j + 1 < n_kv)
      load_tile<D>(sK, kb + static_cast<long long>(k0 + kTile) * kv_stride, kv_stride,
                   Skv - k0 - kTile);
    cp_async_commit();

    // acc += P V_j
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b0, b1, b2, b3;
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = dp * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(smem_addr(sV + key * LD + col), b0, b1, b2, b3);
        mma_bf16(acc[2 * dp], a, b0, b1);
        mma_bf16(acc[2 * dp + 1], a, b2, b3);
      }
    }
    __syncthreads();  // every warp is done with V_j before it is overwritten
  }

  const float l0 = fmaxf(l_row[0], 1e-30f), l1 = fmaxf(l_row[1], 1e-30f);
  bf16* ob = o + static_cast<long long>(b) * Sq * q_stride + static_cast<long long>(h) * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + 2 * tq;
    if (row_a < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_a * q_stride + col) =
          __floats2bfloat162_rn(acc[i][0] / l0, acc[i][1] / l0);
    if (row_a + 8 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (row_a + 8) * q_stride + col) =
          __floats2bfloat162_rn(acc[i][2] / l1, acc[i][3] / l1);
  }
}

constexpr int kF32Keys = 32;  // kv rows per tile of the f32 kernel

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int Sq, int Skv, int H,
                     int KVH, int causal, float scale) {
  constexpr int LD = D + 1;          // odd row pitch of Q, K and V, floats
  constexpr int LP = kF32Keys + 1;   // ... of P
  constexpr int DC = D / 8;          // output columns per thread
  extern __shared__ float fsmem[];
  float* sQ = fsmem;
  float* sK = sQ + kTile * LD;
  float* sV = sK + kF32Keys * LD;
  float* sP = sV + kF32Keys * LD;

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q0 = tile * kTile;
  const long long q_stride = static_cast<long long>(H) * D;
  const long long kv_stride = static_cast<long long>(KVH) * D;
  const float* qb = q + (static_cast<long long>(b) * Sq + q0) * q_stride +
                    static_cast<long long>(h) * D;
  const float* kb = k + static_cast<long long>(b) * Skv * kv_stride +
                    static_cast<long long>(kvh) * D;
  const float* vb = v + static_cast<long long>(b) * Skv * kv_stride +
                    static_cast<long long>(kvh) * D;

  int n_kv = (Skv + kF32Keys - 1) / kF32Keys;
  if (causal) n_kv = min(n_kv, (min(q0 + kTile, Sq) - 1) / kF32Keys + 1);

  // rows rg * 4 + i of the tile; keys cg + 8 * c of a kv tile and output
  // columns cg + 8 * c
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;

  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e % D;
    sQ[r * LD + c] = q0 + r < Sq ? qb[r * q_stride + c] * scale : 0.f;
  }
  float acc[4][DC];
  float m_row[4], l_row[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_row[i] = kNegInf;
    l_row[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kF32Keys;
    __syncthreads();  // Q is staged; every thread is done with the last K, V and P
    for (int e = threadIdx.x; e < kF32Keys * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const bool ok = k0 + r < Skv;
      sK[r * LD + c] = ok ? kb[(k0 + r) * kv_stride + c] : 0.f;
      sV[r * LD + c] = ok ? vb[(k0 + r) * kv_stride + c] : 0.f;
    }
    __syncthreads();

    float s[4][4] = {};
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(rg * 4 + i) * LD + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = sK[(cg + 8 * c) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + rg * 4 + i;
      float mx = m_row[i];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + cg + 8 * c;
        if (key >= Skv || (causal && key > r)) s[i][c] = kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[i][c] - mx);
        sP[(rg * 4 + i) * LP + cg + 8 * c] = p;
        rs += p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      const float alpha = expf(m_row[i] - mx);
      l_row[i] = l_row[i] * alpha + rs;
      m_row[i] = mx;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P is complete

    for (int key = 0; key < kF32Keys; ++key) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(rg * 4 + i) * LP + key];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = sV[key * LD + cg + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

  float* ob = o + static_cast<long long>(b) * Sq * q_stride + static_cast<long long>(h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + rg * 4 + i;
    if (r >= Sq) continue;
    const float l = fmaxf(l_row[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) ob[r * q_stride + cg + 8 * c] = acc[i][c] / l;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv, int H,
           int KVH, int causal, int f32, float scale, cudaStream_t stream) {
  const dim3 grid((Sq + kTile - 1) / kTile, H, B);
  if (f32) {
    const size_t smem = ((kTile + 2 * kF32Keys) * (D + 1) + kTile * (kF32Keys + 1)) * sizeof(float);
    const cudaError_t err = allow_smem(flash_fwd_f32_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    flash_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), Sq, Skv, H, KVH, causal, scale);
  } else {
    const size_t smem = 3 * kTile * (D + 8) * sizeof(bf16);
    const cudaError_t err = allow_smem(flash_fwd_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    const float scale_log2 = scale * 1.4426950408889634f;  // log2(e)
    flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), Sq, Skv, H, KVH, causal, scale_log2);
  }
  return cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Skv, KVH, D), o (B, Sq, H, D), all contiguous
// and of one dtype: f32 if `f32`, else bf16; D a multiple of 16 in [16, 256];
// H a multiple of KVH; scale 1/sqrt(D).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int Sq, int Skv, int H, int KVH, int D, int causal, int f32,
                                   float scale, cudaStream_t stream) {
  switch (D) {
#define FLASH_CASE(d) \
  case d:             \
    return launch<d>(q, k, v, o, B, Sq, Skv, H, KVH, causal, f32, scale, stream);
    FLASH_CASE(16) FLASH_CASE(32) FLASH_CASE(48) FLASH_CASE(64)
    FLASH_CASE(80) FLASH_CASE(96) FLASH_CASE(112) FLASH_CASE(128)
    FLASH_CASE(144) FLASH_CASE(160) FLASH_CASE(176) FLASH_CASE(192)
    FLASH_CASE(208) FLASH_CASE(224) FLASH_CASE(240) FLASH_CASE(256)
#undef FLASH_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
