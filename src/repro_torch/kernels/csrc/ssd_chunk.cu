// Hand-written Hopper (sm_90a) kernel of the Mamba2 SSD chunk.
//
// Replaces ssd_chunk_pallas (src/repro/kernels/ssd_scan/kernel.py). For one
// (batch b, chunk c, head h), with Q rows in the chunk, head h reading group
// g = h / (H / G) of B and C:
//   a       = dt * A[h],  cum_a = inclusive cumsum of a,  a_total = cum_a[Q-1]
//   decay   = exp(cum_a[i] - cum_a[j]) for i >= j, else 0
//   y_intra = ((C . B^T) o decay o dt[j]) . x                      (Q x P)
//   state   = (x o w)^T . B,  w = exp(a_total - cum_a) * dt        (P x N)
//   y_decay = exp(cum_a)
// All four outputs are f32, as in ref.ssd_chunk_ref.
//
// Bound: at Zamba2-2.7B's prefill shape (b 4, Q 256, 16 chunks, H 80, P 64,
// N 64) a call moves ~0.6 GB (x in bf16, the f32 y_intra and states) and does
// ~0.07 TFLOP, so on the tensor cores it would be bound by bytes (~0.18 ms).
// This first kernel runs its products in f32 on the CUDA cores, which makes
// the operations its limit (~1 ms at 67 TFLOP/s f32); the f32 products are
// what holds it within 1e-4 of the plain version. The design keeps every
// intermediate on chip and reads each input once from device memory:
//   - the Pallas block holds a whole Q x Q f32 tile (256 KB at Q = 256, more
//     than a block's 227 KB of shared memory); here rows i and columns j are
//     tiled by 64, and for each row tile only the column tiles j <= i are
//     visited, so no Q x Q tile exists;
//   - the mask is applied before the exp (i >= j ? expf(cum_i - cum_j) : 0):
//     above the diagonal cum_i - cum_j reaches ~+180 with A = -1, whose exp
//     is inf, and inf * 0 would be NaN;
//   - B and C are read through the group index from their (b, nc, Q, G, N)
//     layout, never repeated to H heads;
//   - each 64 x 64 product tile is split 4 x 4 over 256 threads, operands
//     staged in shared memory (padded rows, float4 reads), x, B and C widened
//     from bf16 to f32 as they are staged;
//   - cum_a is one warp's shuffle scan over the chunk.
// Tensor-core products (a bf16 hi/lo split keeps f32 accuracy) are later work.
//
// Every global offset is 64-bit. The extern "C" launcher takes the caller's
// stream, launches without synchronising, allocates nothing, and returns
// cudaGetLastError(). The Python wrapper (repro_torch/kernels/ssd_scan/
// kernel.py) checks every argument before it calls.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;          // tile edge (rows i, columns j, p, n)
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kLD = kT + 4;     // padded pitch in floats, keeps float4 alignment

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// dst[r][c] = src[r * stride + col0 + c] (times row_scale[r] if given) for
// r < rows, c < cols; zero elsewhere in the 64 x 64 tile.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long stride, int rows,
                                          int col0, int cols, const float* row_scale) {
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
    const int r = e >> 6, c = e & (kT - 1);
    float v = 0.f;
    if (r < rows && c < cols) {
      v = to_f32(src[r * stride + col0 + c]);
      if (row_scale != nullptr) v *= row_scale[r];
    }
    dst[r * kLD + c] = v;
  }
}

// The transpose: dst[c][r] = src[r * stride + col0 + c].
template <typename T>
__device__ __forceinline__ void load_cols(float* dst, const T* src, long long stride, int rows,
                                          int col0, int cols) {
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
    const int r = e >> 6, c = e & (kT - 1);
    dst[c * kLD + r] = (r < rows && c < cols) ? to_f32(src[r * stride + col0 + c]) : 0.f;
  }
}

// acc[a][e] += sum_{k < kmax} A[k][4 ty + a] * Bm[k][4 tx + e]
__device__ __forceinline__ void product(float (&acc)[4][4], const float* A, const float* Bm,
                                        int kmax, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < kmax; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(A + k * kLD + 4 * ty);
    const float4 b = *reinterpret_cast<const float4*>(Bm + k * kLD + 4 * tx);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bg,
                 const T* __restrict__ Cg, float* __restrict__ y, float* __restrict__ states,
                 float* __restrict__ a_total, float* __restrict__ y_decay, int nc, int Q, int H,
                 int P, int G, int N) {
  extern __shared__ __align__(16) float smem[];
  float* tA = smem;
  float* tB = tA + kT * kLD;
  float* tS = tB + kT * kLD;
  float* tX = tS + kT * kLD;
  float* cum = tX + kT * kLD;  // [Q]
  float* dts = cum + Q;        // [Q]
  float* w = dts + Q;          // [Q]

  const int h = blockIdx.x, g = h / (H / G);
  const long long chunk = static_cast<long long>(blockIdx.z) * nc + blockIdx.y;
  const long long row0 = chunk * Q;  // first row of the chunk in (b, nc, Q)
  const long long x_stride = static_cast<long long>(H) * P;
  const long long bc_stride = static_cast<long long>(G) * N;
  const T* xb = x + row0 * x_stride + static_cast<long long>(h) * P;
  const T* Bb = Bg + row0 * bc_stride + static_cast<long long>(g) * N;
  const T* Cb = Cg + row0 * bc_stride + static_cast<long long>(g) * N;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, lane = tid & 31;

  // 1. cum_a by one warp's shuffle scan; a_total, y_decay and w
  for (int i = tid; i < Q; i += kThreads) dts[i] = dt[(row0 + i) * H + h];
  __syncthreads();
  if (tid < 32) {
    const float a_h = A[h];
    float carry = 0.f;
    for (int base = 0; base < Q; base += 32) {
      const int i = base + lane;
      float v = i < Q ? dts[i] * a_h : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      v += carry;
      if (i < Q) cum[i] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  const float total = cum[Q - 1];
  if (tid == 0) a_total[chunk * H + h] = total;
  for (int i = tid; i < Q; i += kThreads) {
    y_decay[(row0 + i) * H + h] = expf(cum[i]);
    w[i] = expf(total - cum[i]) * dts[i];
  }

  // 2. y_intra, one 64-row tile at a time, over the column tiles j <= i
  const int n_tiles = (Q + kT - 1) / kT;
  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = it * kT;
    for (int p0 = 0; p0 < P; p0 += kT) {
      float acc[4][4] = {};
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT;
        float s[4][4] = {};
        for (int n0 = 0; n0 < N; n0 += kT) {
          __syncthreads();
          load_cols(tA, Cb + i0 * bc_stride, bc_stride, Q - i0, n0, N - n0);
          load_cols(tB, Bb + j0 * bc_stride, bc_stride, Q - j0, n0, N - n0);
          __syncthreads();
          product(s, tA, tB, min(kT, N - n0), ty, tx);
        }
        // weight (C.B^T)[i][j] by decay and dt[j], masked before the exp
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + 4 * ty + a, j = j0 + 4 * tx + e;
            const float v = (i < Q && j < Q && i >= j)
                                ? s[a][e] * expf(cum[i] - cum[j]) * dts[j]
                                : 0.f;
            tS[(4 * tx + e) * kLD + 4 * ty + a] = v;  // stored [j][i]
          }
        load_rows(tX, xb + j0 * x_stride, x_stride, Q - j0, p0, P - p0,
                  static_cast<const float*>(nullptr));
        __syncthreads();
        product(acc, tS, tX, kT, ty, tx);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + 4 * ty + a, p = p0 + 4 * tx + e;
          if (i < Q && p < P) y[((row0 + i) * H + h) * P + p] = acc[a][e];
        }
    }
  }

  // 3. state[p][n] = sum_j x[j][p] w[j] B[j][n]
  float* st = states + (chunk * H + h) * static_cast<long long>(P) * N;
  for (int p0 = 0; p0 < P; p0 += kT) {
    for (int n0 = 0; n0 < N; n0 += kT) {
      float acc[4][4] = {};
      for (int jt = 0; jt < n_tiles; ++jt) {
        const int j0 = jt * kT;
        __syncthreads();
        load_rows(tA, xb + j0 * x_stride, x_stride, Q - j0, p0, P - p0, w + j0);
        load_rows(tB, Bb + j0 * bc_stride, bc_stride, Q - j0, n0, N - n0,
                  static_cast<const float*>(nullptr));
        __syncthreads();
        product(acc, tA, tB, kT, ty, tx);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = p0 + 4 * ty + a, n = n0 + 4 * tx + e;
          if (p < P && n < N) st[static_cast<long long>(p) * N + n] = acc[a][e];
        }
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B, const void* C, void* y,
           void* states, void* a_total, void* y_decay, int b, int nc, int Q, int H, int P, int G,
           int N, cudaStream_t stream) {
  const size_t smem = (4 * kT * kLD + 3 * static_cast<size_t>(Q)) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(H, nc, b);
  ssd_chunk_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<float*>(y),
      static_cast<float*>(states), static_cast<float*>(a_total), static_cast<float*>(y_decay),
      nc, Q, H, P, G, N);
  return cudaGetLastError();
}

}  // namespace

// x (b, nc, Q, H, P) and B, C (b, nc, Q, G, N) in bf16 (in_bf16 = 1) or f32;
// dt (b, nc, Q, H) and A (H,) f32; outputs y (b, nc, Q, H, P), states
// (b, nc, H, P, N), a_total (b, nc, H), y_decay (b, nc, Q, H), all f32 and
// contiguous; H a multiple of G.
extern "C" int ssd_chunk_fwd(const void* x, const void* dt, const void* A, const void* B,
                             const void* C, void* y, void* states, void* a_total, void* y_decay,
                             int b, int nc, int Q, int H, int P, int G, int N, int in_bf16,
                             cudaStream_t stream) {
  if (in_bf16)
    return launch<__nv_bfloat16>(x, dt, A, B, C, y, states, a_total, y_decay, b, nc, Q, H, P, G,
                                 N, stream);
  return launch<float>(x, dt, A, B, C, y, states, a_total, y_decay, b, nc, Q, H, P, G, N,
                       stream);
}
