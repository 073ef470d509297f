// Hand-written Hopper (sm_90a) kernels of the Mamba2 SSD chunk.
//
// Replace ssd_chunk_pallas (src/repro/kernels/ssd_scan/kernel.py:50, pallas_call at
// :55). For one (batch b, chunk c, head h), with Q rows in the chunk, head h reading
// group g = h / (H / G) of B and C:
//   a       = dt * A[h],  cum_a = inclusive cumsum of a,  a_total = cum_a[Q-1]
//   decay   = exp(cum_a[i] - cum_a[j]) for i >= j, else 0
//   y_intra = ((C . B^T) o decay o dt[j]) . x                      (Q x P)
//   state   = (x o w)^T . B,  w = exp(a_total - cum_a) * dt        (P x N)
//   y_decay = exp(cum_a)
// All four outputs are f32, as in ref.ssd_chunk_ref, within 1e-4 (atol and rtol) of it
// (y_intra of the bf16-intra mode within 1e-3 of its largest value, below).
// Two kernels, each a template on the bf16-intra mode below, four launchers; the wrapper
// (repro_torch/kernels/ssd_scan/kernel.py, `route`) picks one by dtype, shape and mode:
//
//   bf16, Q, P, N multiples of 16, N <= 128, within shared memory  ssd_chunk_tc_kernel
//   f32, and any other bf16 shape                                  ssd_chunk_kernel
//
// launched by ssd_chunk_fwd_tc and ssd_chunk_fwd, or in the bf16-intra mode by
// ssd_chunk_fwd_tc_bf16i and ssd_chunk_fwd_bf16i.
//
// --- bf16 intra (the *_bf16i launchers) ----------------------------------------------
// The mode of repro.models.ssm.ssd_chunked(..., intra_bf16=True) (src/repro/models/ssm.py:
// 89-96), which the Pallas kernel lacks and the JAX model computes in jnp: the
// intra-chunk tensors are bf16, rounded at each step of
//   y_intra = sum_j bf16(bf16(bf16(C_i . B_j) * bf16(decay_ij)) * bf16(dt_j)) * bf16(x_j)
// with C, B rounded to bf16 before their f32 sum, and the last sum in f32. states,
// a_total and y_decay are f32 as in the other mode. The rounded score is one bf16 A
// fragment, so the tensor-core kernel multiplies it with x once (no lo part); the
// states keep their split (f32 in JAX too). The CUDA-core kernel rounds the same way
// in scalar code, C, B and x rounded as they are staged (f32 inputs; JAX rounds them).
// The tensor-core kernel in this mode is laid out for what the mode makes cheap:
//   - bf16(C . B^T) depends on the group alone, not on the head. So the block's warps
//     compute it once, the f32 sums in the order of the other mode (the same m16n8k16
//     over 16 of N at a time), and keep the causal 16 x 16 tiles in shared memory, each
//     as its lanes' A fragments (one uint4 a lane: a warp reads a tile as 512 contiguous
//     bytes, free of bank conflicts). At Q 256 that is 136 tiles, 69,632 bytes, in C's
//     place: each warp holds its tiles in registers until a block barrier says C is
//     read: 9 at N <= 64 (two groups, 16 warps), 17 at N 80-128 (one group of 8 warps,
//     68 registers held through the cum_a scans, most of that instance's 126). All 8
//     heads of a block read them; the products per head fall from
//     three sets to two (scores, y_intra, states: now only the last two).
//   - The score chain runs in bf16x2 pairs (score_chain): the two decays of an A-fragment
//     register rounded by one conversion, then multiplied with the score pair and with
//     the rounded dt pair by __hmul2_rn. A product of two bf16 values is exact in f32, so
//     each pair product rounds where round_bf16(a * b) does: the operand is the bits of
//     the scalar chain, with no repack. bf16(dt) is rounded once per head and column,
//     into the row array that the other mode's cc takes.
//   - The next column tile's exps and pairs are issued before this tile's products.
//   - Shared memory at Zamba2's shape: B 36,864 + tiles 69,632 + two x buffers 73,728 +
//     the rows (cum_a, dt, bf16(dt), w) of 8 heads 32,768 = 212,992 bytes. Where the
//     tiles do not fit beside the rest (Q 256, P 128, N 64: 245,760; or Q > 256), a
//     second instance (template flag kSharedS off) computes each head's S as the other
//     mode does, with the same chain; the launcher picks it from the shape.
//   - ptxas -v (tools/ssd_probe.py): the shared-score instances take 116 registers at
//     N <= 64 (two groups, within the 128 of 512 threads) and 126 at N 80-128 (one
//     group), the per-head-S instances 120-156; no instance spills or has a stack.
// Each decay takes the direct form exp(cum_i - cum_j) with expf, as the plain version's
// torch.exp does on the card, and cum_a is summed in f64 and rounded once, as the plain
// version sums it: both then give the same f32 decay, so that its rounding to bf16
// agrees. A bf16 rounding can still flip where the two f32 values before it differ: the
// f32 sums of C . B^T, taken in another order than the plain version's, and exp where
// the plain version's differs from expf (on the CPU). A flip moves one score by one bf16
// step (2^-8 of it); y_intra is held within 1e-3 of its largest value
// (tests/test_torch_ssd_intra_bf16.py states it), the other outputs within 1e-4.
//
// Bound: at Zamba2-2.7B's prefill shape (b 4, Q 256, 16 chunks, H 80, P 64, N 64, G 1)
// a call moves 0.60 GB: the f32 y_intra (335 MB) and states (84 MB), x in bf16 (168 MB);
// B and C are 2 MB. Its 53.9 GFLOP take 0.80 ms at the 67 TFLOP/s of f32 on the CUDA
// cores but 0.05 ms on the bf16 tensor cores, so only the tensor cores let the 0.18 ms
// of bytes (3.35 TB/s) bound it.
//
// --- bf16: ssd_chunk_tc_kernel (mma.sync, bf16 hi/lo split) -------------------------
// The chunk is masked linear attention: S = C . B^T, P = S o decay o dt[j], Y = P . x,
// flash without the softmax. On Zamba2's path x, B and C arrive in bf16, so C . B^T is
// exact on the tensor cores (bf16 products, f32 accumulation). The other operand of
// each of the other two products is f32 (P, and x o w), and bf16 alone misses 1e-4 at
// Zamba2's scales. So each f32 operand v is split as hi = bf16(v), lo = bf16(v - hi),
// and hi . op + lo . op accumulate into one f32 accumulator: two products, not three,
// since the other operand is exact. hi + lo carries ~16 bits of v's mantissa, which
// meets 1e-4 (tests/test_torch_ssd_scan.py models both on the CPU). With the split a
// call is ~90 GFLOP of m16n8k16 products at Zamba2's shape.
//   - One block per (batch, chunk, group, up to 8 heads of the group): 640 blocks at
//     Zamba2's shape, one to an SM at a time. C and B of the chunk's group are staged
//     once per block with cp.async (64 KB at N 64, 128 KB at N 128) and serve all its
//     heads. The block has two groups of 8 warps where N <= 64 (one where the
//     registers do not allow two), and group k computes heads k, k + 2, ...: while one
//     group waits for its next head's x tile (Q x P), the other computes. Head hl's x
//     lies in buffer hl % 2, so with one group the buffers alternate.
//   - Before the heads, warp k scans head k's cum_a (one warp's shuffle scan over the
//     chunk, as in the f32 kernel), writes a_total and y_decay, and fills two arrays
//     of the head: w (the states' weight) and cc (below; bf16(dt) in the bf16-intra
//     mode).
//   - y_intra: row tiles of 16, a warp taking tiles t and 2*8-1-t (the causal work of
//     the pair is the same for every warp). For each column tile j <= i, S_ij is
//     recomputed from shared memory for each head in this mode (the bf16-intra mode
//     shares its rounded tiles, above) (m16n8k16 from ldmatrix fragments:
//     C . B^T is a quarter of a head's products and needs no f32 tile to keep).
//     Off the diagonal the weight exp(cum_i - cum_j) dt_j is a product of factors
//     that are each at most 1 (tc_y_intra): one exponential a tile pair, where the
//     direct form takes eight a thread. The diagonal tile takes the direct form,
//     masked before the exp (above the diagonal cum_i - cum_j reaches ~+180 with
//     A = -1, whose exp is inf). The weighted S is
//     split to hi/lo A fragments (two n8 accumulators have the layout of one A
//     fragment) and multiplied with x (ldmatrix.trans) into the f32 accumulator.
//     Each warp stores its rows' 64 contiguous floats per (row, head) as float2 pairs
//     that fill whole 32-byte sectors.
//   - states: (x o w)^T . B, the A fragment x^T from ldmatrix.trans, widened, weighted
//     by w in f32 and split hi/lo; B as the B operand (ldmatrix.trans).
//   - Rows are padded by 16 bytes in shared memory, so the 8 rows an ldmatrix reads
//     fall in distinct banks.
// It does not reach its bytes bound: each warp issues its products, weights and splits
// in turn (tools/ssd_probe.py times the parts, PERF.md has the numbers); wgmma, which
// runs the products asynchronously beside the weights, is the next step. In the
// bf16-intra mode the products are fewer (one score set a block, one product with x),
// but each thread takes eight expf a tile pair, which keep the plain version's decays,
// and the block's score tiles are computed before its first head, with no head's work
// beside them (PERF.md splits the time).
//
// --- f32 (and other bf16 shapes): ssd_chunk_kernel (CUDA cores) ---------------------
// The products in f32 on the CUDA cores, which makes the operations its limit (~0.8 ms
// at Zamba2's shape); f32 inputs have no exact tensor-core product. The design keeps
// every intermediate on chip and reads each input once from device memory:
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
//
// Every global offset is 64-bit. Each extern "C" launcher takes the caller's stream,
// launches without synchronising, allocates nothing, and returns a cudaError_t. The
// Python wrapper checks every argument before it calls.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;          // tile edge (rows i, columns j, p, n)
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kLD = kT + 4;     // padded pitch in floats, keeps float4 alignment

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// v rounded to bf16 (to nearest, ties to even), widened back
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The bf16-intra score: bf16(bf16(bf16(s) * bf16(decay)) * bf16(dt)). Each product of
// two bf16 values is exact in f32, so each rounding is the one bf16 arithmetic makes.
__device__ __forceinline__ float intra_bf16_score(float s, float decay, float dt) {
  return round_bf16(round_bf16(round_bf16(s) * round_bf16(decay)) * round_bf16(dt));
}

// cum[i] = sum_{k <= i} dts[k] * a_h, by one warp's shuffle scan, in f32, or (kF64) in
// f64 and rounded once: the plain version's sums.
template <bool kF64>
__device__ __forceinline__ void warp_cumsum(const float* dts, float a_h, float* cum, int Q,
                                            int lane) {
  using Acc = std::conditional_t<kF64, double, float>;
  Acc carry = 0;
  for (int base = 0; base < Q; base += 32) {
    const int i = base + lane;
    Acc v = i < Q ? static_cast<Acc>(dts[i] * a_h) : Acc(0);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const Acc u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    v += carry;
    if (i < Q) cum[i] = static_cast<float>(v);
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// dst[r][c] = src[r * stride + col0 + c] (times row_scale[r] if given; rounded to bf16
// first if kRound) for r < rows, c < cols; zero elsewhere in the 64 x 64 tile.
template <bool kRound = false, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long stride, int rows,
                                          int col0, int cols, const float* row_scale) {
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
    const int r = e >> 6, c = e & (kT - 1);
    float v = 0.f;
    if (r < rows && c < cols) {
      v = to_f32(src[r * stride + col0 + c]);
      if (kRound) v = round_bf16(v);
      if (row_scale != nullptr) v *= row_scale[r];
    }
    dst[r * kLD + c] = v;
  }
}

// The transpose: dst[c][r] = src[r * stride + col0 + c] (rounded to bf16 if kRound).
template <bool kRound, typename T>
__device__ __forceinline__ void load_cols(float* dst, const T* src, long long stride, int rows,
                                          int col0, int cols) {
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
    const int r = e >> 6, c = e & (kT - 1);
    float v = 0.f;
    if (r < rows && c < cols) {
      v = to_f32(src[r * stride + col0 + c]);
      if (kRound) v = round_bf16(v);
    }
    dst[c * kLD + r] = v;
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

template <typename T, bool kIntraBf16>
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
  if (tid < 32) warp_cumsum<kIntraBf16>(dts, A[h], cum, Q, lane);
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
          load_cols<kIntraBf16>(tA, Cb + i0 * bc_stride, bc_stride, Q - i0, n0, N - n0);
          load_cols<kIntraBf16>(tB, Bb + j0 * bc_stride, bc_stride, Q - j0, n0, N - n0);
          __syncthreads();
          product(s, tA, tB, min(kT, N - n0), ty, tx);
        }
        // weight (C.B^T)[i][j] by decay and dt[j], masked before the exp
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + 4 * ty + a, j = j0 + 4 * tx + e;
            float v = 0.f;
            if (i < Q && j < Q && i >= j) {
              const float decay = expf(cum[i] - cum[j]);
              v = kIntraBf16 ? intra_bf16_score(s[a][e], decay, dts[j])
                             : s[a][e] * decay * dts[j];
            }
            tS[(4 * tx + e) * kLD + 4 * ty + a] = v;  // stored [j][i]
          }
        load_rows<kIntraBf16>(tX, xb + j0 * x_stride, x_stride, Q - j0, p0, P - p0,
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

template <typename T, bool kIntraBf16>
int launch(const void* x, const void* dt, const void* A, const void* B, const void* C, void* y,
           void* states, void* a_total, void* y_decay, int b, int nc, int Q, int H, int P, int G,
           int N, cudaStream_t stream) {
  const size_t smem = (4 * kT * kLD + 3 * static_cast<size_t>(Q)) * sizeof(float);
  const cudaError_t err =
      cudaFuncSetAttribute(ssd_chunk_kernel<T, kIntraBf16>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(H, nc, b);
  ssd_chunk_kernel<T, kIntraBf16><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<float*>(y),
      static_cast<float*>(states), static_cast<float*>(a_total), static_cast<float*>(y_decay),
      nc, Q, H, P, G, N);
  return cudaGetLastError();
}

// --- the tensor-core kernel ----------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 8;            // warps of a group, which computes one head
constexpr int kTcGroupThreads = 32 * kTcWarps;
constexpr int kTcMaxHeads = kTcWarps;  // heads per block at most: warp k scans head k

// Groups of a block: two (512 threads, at most 128 registers each) where the state
// width leaves the registers for it, one where it does not.
template <int N>
__host__ __device__ constexpr int tc_groups() { return N <= 64 ? 2 : 1; }
constexpr int kTcPad = 8;              // bf16 of padding a row in shared memory
// f32 per row and head: cum_a, dt, w, and cc (f32 intra) or bf16(dt) (bf16 intra)
constexpr int kTcRowArrays = 4;
constexpr size_t kSmemMax = 232448;    // a block's shared memory (227 KB)
// The bf16-intra block's score tiles: the causal 16 x 16 tiles of bf16(C . B^T), 512
// bytes each, at most 136 (Q <= 256), each warp holding at most 136 / warps of them in
// registers until C, whose place they take, is read.
constexpr int kTcTileBytes = 16 * 16 * sizeof(bf16);
constexpr int kTcMaxScoreTiles = 136;
template <int N>
__host__ __device__ constexpr int tc_tiles_per_warp() {
  return (kTcMaxScoreTiles + kTcWarps * tc_groups<N>() - 1) / (kTcWarps * tc_groups<N>());
}

// Switches of tools/ssd_probe.py, a bit mask fixed at build time (-DSSD_PROBE=n; 0, the
// default, builds the kernel as it is). Each cuts a part out of the tensor-core kernel
// to see what the rest costs, so every switch makes it compute something else:
//   1   no y_intra (tc_y_intra skipped);
//   2   no states (tc_states skipped);
//   4   no products: each m16n8k16 becomes one dependent add;
//   8   no decay weights off the diagonal: the raw scores are split (f32 intra);
//   16  no x loads after the first two heads (each head reads a tile already there);
//   32  bf16 intra: no expf, each decay's argument in its place;
//   64  bf16 intra: no bf16x2 products in the score chain, the score, decay and dt
//       pairs combined by one xor;
//   128 bf16 intra: the scores computed for each head where the block's tiles fit.
#ifndef SSD_PROBE
#define SSD_PROBE 0
#endif
constexpr int kProbe = SSD_PROBE;

__host__ __device__ constexpr size_t tc_smem_bytes(int Q, int P, int N, int heads) {
  return 2 * static_cast<size_t>(Q) * (N + kTcPad) * sizeof(bf16) +  // C, B
         2 * static_cast<size_t>(Q) * (P + kTcPad) * sizeof(bf16) +  // x, two buffers
         static_cast<size_t>(kTcRowArrays) * heads * Q * sizeof(float);
}

// Heads a block takes: the most of 8, 4, 2, 1 whose shared memory fits; 0 if none.
// Chosen by the wave count at Zamba2's shape (80 heads, 64 chunks, one block to an SM):
// 8 make 640 blocks, 4.85 waves on 132 SMs, the 5 waves 97% busy. With shared score
// tiles more heads would share them further, but 10 (512 blocks, 3.88 waves) fill the
// waves no better and save 1.1% of the products (the tiles are 6.0% of a block's at 8
// heads); 16 fill 81% (2.42 waves), and 20 leave no room for their rows.
__host__ __device__ constexpr int tc_heads(int Q, int P, int N) {
  int heads = kTcMaxHeads;
  while (heads > 0 && tc_smem_bytes(Q, P, N, heads) > kSmemMax) heads /= 2;
  return heads;
}

__host__ __device__ constexpr int tc_score_tiles(int Q) { return (Q / 16) * (Q / 16 + 1) / 2; }

// The bf16-intra block with shared score tiles: C's place, then the tiles, as large as
// the larger of the two; B, x and the rows as in tc_smem_bytes.
__host__ __device__ constexpr size_t tc_shared_smem_bytes(int Q, int P, int N, int heads) {
  const size_t c = static_cast<size_t>(Q) * (N + kTcPad) * sizeof(bf16);
  const size_t tiles = static_cast<size_t>(tc_score_tiles(Q)) * kTcTileBytes;
  return tc_smem_bytes(Q, P, N, heads) - c + (tiles > c ? tiles : c);
}

// Whether the bf16-intra block shares its score tiles at this shape: the tiles within
// kTcMaxScoreTiles and the block within its shared memory at tc_heads' heads. Elsewhere
// (Q 256, P 128, N 64: 245,760 bytes) each head computes its own scores.
__host__ __device__ constexpr bool tc_shares_scores(int Q, int P, int N) {
  return !(kProbe & 128) && tc_score_tiles(Q) <= kTcMaxScoreTiles &&
         tc_shared_smem_bytes(Q, P, N, tc_heads(Q, P, N)) <= kSmemMax;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if (kProbe & 4) {
    d[0] += __uint_as_float(a[0] ^ a[3] ^ b0 ^ b1);
    return;
  }
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 pair(uint32_t r) {
  return *reinterpret_cast<__nv_bfloat162*>(&r);
}

// The pair (u, v) as bf16 hi = bf16(.) and lo = bf16(. - hi), u in the low halves.
__device__ __forceinline__ void split2(float u, float v, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(u, v);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(u - hf.x, v - hf.y));
}

__device__ __forceinline__ float2 widen(uint32_t r) {
  return __bfloat1622float2(pair(r));
}

// The bf16-intra score chain of one A-fragment register, two columns of one row:
// bf16(bf16(s * bf16(decay)) * bf16(dt)) for the rounded score pair s, the decays d0, d1
// (f32) and the rounded dt pair. A product of two bf16 values is exact in f32, so each
// __hmul2_rn rounds exactly where round_bf16(a * b) does, and its result is the operand.
__device__ __forceinline__ uint32_t score_chain(uint32_t s, float d0, float d1, uint32_t dt) {
  const __nv_bfloat162 decay = __floats2bfloat162_rn(d0, d1);
  if (kProbe & 64) return s ^ bits(decay) ^ dt;
  return bits(__hmul2_rn(__hmul2_rn(pair(s), decay), pair(dt)));
}

__device__ __forceinline__ float decay_exp(float d) { return (kProbe & 32) ? d : expf(d); }

// -inf, the masked decay's exponent
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }

// The warp's index within its group, through a shuffle so that the compiler knows it
// is the same across the warp (the products' .aligned instructions then need no
// reconvergence code).
__device__ __forceinline__ int group_warp() {
  return __shfl_sync(0xffffffffu, (threadIdx.x >> 5) % kTcWarps, 0);
}

// Named barrier of the group's threads (0 is __syncthreads).
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(kTcGroupThreads) : "memory");
}

// Stage the Q x P tile of head h of the chunk (rows x_stride apart) into dst, row
// pitch P + kTcPad, by the threads of one group.
__device__ __forceinline__ void stage_x(bf16* dst, const bf16* src, long long x_stride, int Q,
                                        int P) {
  const int chunks = P / 8;  // 16-byte pieces a row
  for (int c = threadIdx.x % kTcGroupThreads; c < Q * chunks; c += kTcGroupThreads) {
    const int r = c / chunks, col = (c % chunks) * 8;
    cp_async_16(smem_addr(dst + r * (P + kTcPad) + col), src + r * x_stride + col);
  }
}

// S = C_i . B_j^T for the 16 rows i0.. and the 16 columns j0.., as two n8 accumulators
// (the layout of one A fragment), from the A fragments cf of C's rows: one m16n8k16 pair
// for each 16 of N, in order of kk.
template <int N>
__device__ __forceinline__ void c_bt(const bf16* sB, const uint32_t (&cf)[N / 16][4], int j0,
                                     float (&out)[2][4]) {
  constexpr int LDN = N + kTcPad;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < 2; ++n) out[n][0] = out[n][1] = out[n][2] = out[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t b[4];
    ldmatrix_x4(smem_addr(sB + (j0 + (lane >> 4) * 8 + (lane & 7)) * LDN + kk * 16 +
                          ((lane >> 3) & 1) * 8),
                b);
    mma_bf16(out[0], cf[kk], b[0], b[1]);
    mma_bf16(out[1], cf[kk], b[2], b[3]);
  }
}

// The A fragments of C's rows i0..i0+15.
template <int N>
__device__ __forceinline__ void c_rows(const bf16* sC, int i0, uint32_t (&cf)[N / 16][4]) {
  constexpr int LDN = N + kTcPad;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    ldmatrix_x4(smem_addr(sC + (i0 + (lane & 15)) * LDN + kk * 16 + (lane >> 4) * 8), cf[kk]);
}

// The rounded scores bf16(S) as one A fragment (rows g, g + 8; columns 2 tq, 2 tq + 1,
// then 8 more), the low half of each register the even column.
__device__ __forceinline__ void round_scores(const float (&s)[2][4], uint32_t (&a)[4]) {
#pragma unroll
  for (int nb = 0; nb < 2; ++nb) {
    a[2 * nb] = bits(__floats2bfloat162_rn(s[nb][0], s[nb][1]));
    a[2 * nb + 1] = bits(__floats2bfloat162_rn(s[nb][2], s[nb][3]));
  }
}

// The bf16-intra block's score tiles: bf16(C . B^T) of the chunk's group, the causal
// tile (it, jt) at it (it + 1) / 2 + jt, each as its 32 lanes' A fragments, one uint4 a
// lane (a warp reads a tile as 512 contiguous bytes, free of bank conflicts). The
// block's warps take tiles w, w + warps, ...; C lies where the tiles go, so each warp
// keeps its tiles in registers and writes them only after a block barrier.
template <int N>
__device__ __forceinline__ void tc_scores(const bf16* sC, const bf16* sB,
                                          uint32_t (&tiles)[tc_tiles_per_warp<N>()][4], int Q) {
  constexpr int kWarps = kTcWarps * tc_groups<N>();
  const int w = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int n_score = tc_score_tiles(Q);
#pragma unroll
  for (int k = 0; k < tc_tiles_per_warp<N>(); ++k) {
    const int t = w + k * kWarps;
    if (t >= n_score) break;
    int it = 0;
    while ((it + 1) * (it + 2) / 2 <= t) ++it;
    uint32_t cf[N / 16][4];
    c_rows<N>(sC, it * 16, cf);
    float s[2][4];
    c_bt<N>(sB, cf, (t - it * (it + 1) / 2) * 16, s);
    round_scores(s, tiles[k]);
  }
}

template <int N>
__device__ __forceinline__ void tc_store_scores(
    uint4* sS, const uint32_t (&tiles)[tc_tiles_per_warp<N>()][4], int Q) {
  constexpr int kWarps = kTcWarps * tc_groups<N>();
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_score = tc_score_tiles(Q);
#pragma unroll
  for (int k = 0; k < tc_tiles_per_warp<N>(); ++k) {
    const int t = w + k * kWarps;
    if (t >= n_score) break;
    sS[t * 32 + lane] = make_uint4(tiles[k][0], tiles[k][1], tiles[k][2], tiles[k][3]);
  }
}

// y_intra of one head: this warp's row tiles, all P columns. Off the diagonal tile
// (j0 + 16 <= i0) the weight exp(cum_i - cum_j) dt_j is the product of three factors,
// each at most 1, so that no product overflows:
//   R_i = exp(cum_i - cum_i0)  (per row tile),  E = exp(cum_i0 - cum_je)  (per tile pair),
//   cc_j = exp(cum_je - cum_j) dt_j  (per head, in shared memory),  je = j0 + 15,
// one exponential a tile pair where the direct form takes eight a thread. The diagonal
// tile takes the direct form, masked before the exp.
// In the bf16-intra mode every tile takes the direct form (the plain version's decay)
// and score_chain turns the rounded score fragment into the operand in bf16x2 pairs;
// the fragment comes from the block's tiles (kSharedS) or from this head's own C . B^T.
// There the next tile's exps and pairs are issued before this tile's products.
template <int N, bool kIntraBf16, bool kSharedS>
__device__ __forceinline__ void tc_y_intra(const bf16* sC, const bf16* sB, const uint4* sS,
                                           const bf16* sX, const float* cum, const float* dts,
                                           const float* cc, const bf16* dtb, float* yb,
                                           long long y_stride, int Q, int P) {
  const int LDP = P + kTcPad;
  const int warp = group_warp(), lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int n_tiles = Q / 16;
  for (int round = 0; round * kTcWarps < n_tiles; ++round) {
    // rounds alternate direction, so that a warp's tiles t and 2*8-1-t pair up
    const int it = round * kTcWarps + ((round & 1) ? kTcWarps - 1 - warp : warp);
    if (it >= n_tiles) continue;
    const int i0 = it * 16, ra = i0 + g, rb = ra + 8;
    const float cum_i0 = cum[i0], cum_a = cum[ra], cum_b = cum[rb];
    const float row_a = expf(cum_a - cum_i0), row_b = expf(cum_b - cum_i0);
    uint32_t cf[N / 16][4];  // C rows i0..i0+15 as A fragments
    if constexpr (!kSharedS) c_rows<N>(sC, i0, cf);
    // bf16 intra: column tile jt's operand from its rounded score fragment sc
    auto weigh = [&](int jt, const uint32_t (&sc)[4], uint32_t (&a)[4]) {
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const int j = jt * 16 + nb * 8 + 2 * tq;
        const float2 cj = *reinterpret_cast<const float2*>(cum + j);
        const uint32_t dj = *reinterpret_cast<const uint32_t*>(dtb + j);
        float da0 = cum_a - cj.x, da1 = cum_a - cj.y, db0 = cum_b - cj.x, db1 = cum_b - cj.y;
        uint32_t keep_a = ~0u, keep_b = ~0u;
        if (jt == it) {  // the diagonal: masked before the exp, and to +0 after the chain
          da0 = ra >= j ? da0 : neg_inf();
          da1 = ra >= j + 1 ? da1 : neg_inf();
          db0 = rb >= j ? db0 : neg_inf();
          db1 = rb >= j + 1 ? db1 : neg_inf();
          keep_a = (ra >= j ? 0xffffu : 0u) | (ra >= j + 1 ? 0xffff0000u : 0u);
          keep_b = (rb >= j ? 0xffffu : 0u) | (rb >= j + 1 ? 0xffff0000u : 0u);
        }
        a[2 * nb] = score_chain(sc[2 * nb], decay_exp(da0), decay_exp(da1), dj) & keep_a;
        a[2 * nb + 1] = score_chain(sc[2 * nb + 1], decay_exp(db0), decay_exp(db1), dj) & keep_b;
      }
    };
    for (int p0 = 0; p0 < P; p0 += 64) {
      float acc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      // Y += P . x_j: the bf16 operand (or its hi part) and, for f32 intra, its lo part
      auto multiply = [&](int j0, const uint32_t (&hi)[4], const uint32_t (&lo)[4]) {
#pragma unroll
        for (int pn = 0; pn < 4; ++pn) {
          if (p0 + pn * 16 >= P) break;
          uint32_t b[4];
          ldmatrix_x4_trans(smem_addr(sX + (j0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDP +
                                      p0 + pn * 16 + (lane >> 4) * 8),
                            b);
          mma_bf16(acc[2 * pn], hi, b[0], b[1]);
          mma_bf16(acc[2 * pn + 1], hi, b[2], b[3]);
          if constexpr (!kIntraBf16) {
            mma_bf16(acc[2 * pn], lo, b[0], b[1]);
            mma_bf16(acc[2 * pn + 1], lo, b[2], b[3]);
          }
        }
      };
      if constexpr (kSharedS) {
        // the row tile's score tiles lie one after another from it (it + 1) / 2
        const uint4* row = sS + (it * (it + 1) / 2) * 32 + lane;
        auto scores = [&](int jt, uint32_t (&sc)[4]) {
          const uint4 v = row[jt * 32];
          sc[0] = v.x, sc[1] = v.y, sc[2] = v.z, sc[3] = v.w;
        };
        uint32_t sc[4], a[4];
        scores(0, sc);
        weigh(0, sc, a);
        for (int jt = 0; jt < it; ++jt) {
          uint32_t next[4];
          scores(jt + 1, sc);
          weigh(jt + 1, sc, next);
          multiply(jt * 16, a, a);
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = next[r];
        }
        multiply(it * 16, a, a);
      } else {
        // this head's S; the next column tile's S is issued before this one is
        // weighted, so that its products overlap the weights
        float s_next[2][4];
        c_bt<N>(sB, cf, 0, s_next);
        for (int jt = 0; jt <= it; ++jt) {
          const int j0 = jt * 16;
          float s[2][4];
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = s_next[n][e];
          if (jt < it) c_bt<N>(sB, cf, j0 + 16, s_next);
          // weight by decay and dt[j]; split into hi/lo (bf16 intra: rounded into hi)
          uint32_t hi[4], lo[4];
          if constexpr (kIntraBf16) {
            uint32_t sc[4];
            round_scores(s, sc);
            weigh(jt, sc, hi);
          } else if (kProbe & 8) {
#pragma unroll
            for (int nb = 0; nb < 2; ++nb) {
              split2(s[nb][0], s[nb][1], hi[2 * nb], lo[2 * nb]);
              split2(s[nb][2], s[nb][3], hi[2 * nb + 1], lo[2 * nb + 1]);
            }
          } else if (jt < it) {
            const float e = expf(cum_i0 - cum[j0 + 15]);
            const float fa = row_a * e, fb = row_b * e;
#pragma unroll
            for (int nb = 0; nb < 2; ++nb) {
              const float2 c = *reinterpret_cast<const float2*>(cc + j0 + nb * 8 + 2 * tq);
              split2(s[nb][0] * fa * c.x, s[nb][1] * fa * c.y, hi[2 * nb], lo[2 * nb]);
              split2(s[nb][2] * fb * c.x, s[nb][3] * fb * c.y, hi[2 * nb + 1], lo[2 * nb + 1]);
            }
          } else {
#pragma unroll
            for (int nb = 0; nb < 2; ++nb) {
              const int j = j0 + nb * 8 + 2 * tq;
              const float2 cj = *reinterpret_cast<const float2*>(cum + j);
              const float2 dj = *reinterpret_cast<const float2*>(dts + j);
              const float v0 = ra >= j ? s[nb][0] * expf(cum_a - cj.x) * dj.x : 0.f;
              const float v1 = ra >= j + 1 ? s[nb][1] * expf(cum_a - cj.y) * dj.y : 0.f;
              const float v2 = rb >= j ? s[nb][2] * expf(cum_b - cj.x) * dj.x : 0.f;
              const float v3 = rb >= j + 1 ? s[nb][3] * expf(cum_b - cj.y) * dj.y : 0.f;
              split2(v0, v1, hi[2 * nb], lo[2 * nb]);          // row g, k 8 nb + 2 tq
              split2(v2, v3, hi[2 * nb + 1], lo[2 * nb + 1]);  // row g + 8
            }
          }
          multiply(j0, hi, lo);
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = p0 + n * 8 + 2 * tq;
        if (col >= P) break;
        *reinterpret_cast<float2*>(yb + ra * y_stride + col) = make_float2(acc[n][0], acc[n][1]);
        *reinterpret_cast<float2*>(yb + rb * y_stride + col) = make_float2(acc[n][2], acc[n][3]);
      }
    }
  }
}

// states of one head: (x o w)^T . B, this warp's (16 p x 32 n) units.
template <int N>
__device__ __forceinline__ void tc_states(const bf16* sB, const bf16* sX, const float* w,
                                          float* st, int Q, int P) {
  constexpr int LDN = N + kTcPad;
  constexpr int kGroups = (N + 31) / 32;
  const int LDP = P + kTcPad;
  const int warp = group_warp(), lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  for (int u = warp; u < (P / 16) * kGroups; u += kTcWarps) {
    const int p0 = (u / kGroups) * 16, n0 = (u % kGroups) * 32;
    float acc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int j0 = 0; j0 < Q; j0 += 16) {
      // A = x^T (rows p, k = j) from ldmatrix.trans, times w[j] in f32, split
      uint32_t a[4];
      ldmatrix_x4_trans(smem_addr(sX + (j0 + (lane & 7) + (lane >> 4) * 8) * LDP + p0 +
                                  ((lane >> 3) & 1) * 8),
                        a);
      const float2 wa = *reinterpret_cast<const float2*>(w + j0 + 2 * tq);      // k 2tq, +1
      const float2 wb = *reinterpret_cast<const float2*>(w + j0 + 8 + 2 * tq);  // k 8 + 2tq
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 xv = widen(a[r]);
        const float2 wr = r >= 2 ? wb : wa;  // a[2], a[3]: k 8..15
        split2(xv.x * wr.x, xv.y * wr.y, hi[r], lo[r]);
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        if (n0 + nb * 16 >= N) break;
        uint32_t b[4];
        ldmatrix_x4_trans(smem_addr(sB + (j0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDN + n0 +
                                    nb * 16 + (lane >> 4) * 8),
                          b);
        mma_bf16(acc[2 * nb], hi, b[0], b[1]);
        mma_bf16(acc[2 * nb], lo, b[0], b[1]);
        mma_bf16(acc[2 * nb + 1], hi, b[2], b[3]);
        mma_bf16(acc[2 * nb + 1], lo, b[2], b[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = n0 + n * 8 + 2 * tq;
      if (col >= N) break;
      *reinterpret_cast<float2*>(st + (p0 + g) * N + col) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(st + (p0 + g + 8) * N + col) =
          make_float2(acc[n][2], acc[n][3]);
    }
  }
}

template <int N, bool kIntraBf16, bool kSharedS>
__global__ void __launch_bounds__(kTcGroupThreads * tc_groups<N>(), 1)
ssd_chunk_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const bf16* __restrict__ Bg,
                    const bf16* __restrict__ Cg, float* __restrict__ y,
                    float* __restrict__ states, float* __restrict__ a_total,
                    float* __restrict__ y_decay, int nc, int Q, int H, int P, int G,
                    int heads, int head_blocks) {
  static_assert(kIntraBf16 || !kSharedS, "only the bf16-intra scores are shared");
  constexpr int LDN = N + kTcPad;
  constexpr int kGroups = tc_groups<N>();
  constexpr int kThreads = kTcGroupThreads * kGroups;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  // C; with shared scores, then the score tiles in its place (bf16 counts)
  const int c_region = kSharedS ? max(Q * LDN, tc_score_tiles(Q) * kTcTileBytes / 2) : Q * LDN;
  bf16* sC = reinterpret_cast<bf16*>(tc_smem);
  const uint4* sS = reinterpret_cast<const uint4*>(tc_smem);
  bf16* sB = sC + c_region;
  bf16* sX0 = sB + Q * LDN;
  bf16* sX1 = sX0 + Q * (P + kTcPad);
  // per head and row: cum_a, dt, cc (the column factor of tc_y_intra; bf16 intra: the
  // rounded dt, Q bf16 in its place), w
  float* sCum = reinterpret_cast<float*>(sX1 + Q * (P + kTcPad));  // [heads][Q]
  float* sDt = sCum + heads * Q;
  float* sCC = sDt + heads * Q;
  float* sW = sCC + heads * Q;

  const int g = blockIdx.x / head_blocks, hb = blockIdx.x % head_blocks;
  const int rep = H / G;
  const int h0 = g * rep + hb * heads;
  const int nh = min(heads, rep - hb * heads);
  const long long chunk = static_cast<long long>(blockIdx.z) * nc + blockIdx.y;
  const long long row0 = chunk * Q;  // first row of the chunk in (b, nc, Q)
  const long long x_stride = static_cast<long long>(H) * P;
  const long long bc_stride = static_cast<long long>(G) * N;
  const bf16* xb = x + row0 * x_stride + static_cast<long long>(h0) * P;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, group = warp / kTcWarps;

  // 1. C and B of the group, then the first two heads' x, in flight while the scans run
  {
    const bf16* Cb = Cg + row0 * bc_stride + static_cast<long long>(g) * N;
    const bf16* Bb = Bg + row0 * bc_stride + static_cast<long long>(g) * N;
    constexpr int chunks = N / 8;
    for (int c = tid; c < Q * chunks; c += kThreads) {
      const int r = c / chunks, col = (c % chunks) * 8;
      cp_async_16(smem_addr(sC + r * LDN + col), Cb + r * bc_stride + col);
      cp_async_16(smem_addr(sB + r * LDN + col), Bb + r * bc_stride + col);
    }
    cp_async_commit();
  }
  // x groups a thread commits (with shared scores, padded with empty groups so that
  // every thread can wait for C and B alone)
  constexpr int kXGroups = kGroups == 2 ? 1 : 2;
  for (int k = 0, hl = group; k < kXGroups; ++k, hl += kGroups) {
    if (hl < min(2, nh)) {
      stage_x(hl ? sX1 : sX0, xb + hl * P, x_stride, Q, P);
      cp_async_commit();
    } else if (kSharedS) {
      cp_async_commit();
    }
  }

  // 2. cum_a of head h0 + k by warp k; a_total, y_decay, cc (bf16 intra: bf16(dt)) and
  // w. With shared scores the block's warps first compute the score tiles into registers.
  for (int e = tid; e < Q * heads; e += kThreads) {
    const int i = e / heads, hl = e % heads;
    if (hl < nh) sDt[hl * Q + i] = dt[(row0 + i) * H + h0 + hl];
  }
  uint32_t tiles[kSharedS ? tc_tiles_per_warp<N>() : 1][4];
  if constexpr (kSharedS) {
    cp_async_wait<kXGroups>();  // C and B
    __syncthreads();
    tc_scores<N>(sC, sB, tiles, Q);
  } else {
    __syncthreads();
  }
  if (warp < nh) {
    const int h = h0 + warp;
    const float* dts = sDt + warp * Q;
    float* cum = sCum + warp * Q;
    warp_cumsum<kIntraBf16>(dts, A[h], cum, Q, lane);
    __syncwarp();
    const float total = cum[Q - 1];
    if (lane == 0) a_total[chunk * H + h] = total;
    float* cc = sCC + warp * Q;
    float* w = sW + warp * Q;
    for (int i = lane; i < Q; i += 32) {
      y_decay[(row0 + i) * H + h] = expf(cum[i]);
      if constexpr (kIntraBf16)
        reinterpret_cast<bf16*>(cc)[i] = __float2bfloat16_rn(dts[i]);
      else
        cc[i] = expf(cum[i | 15] - cum[i]) * dts[i];  // i | 15: the last row of i's tile
      w[i] = expf(total - cum[i]) * dts[i];
    }
  }
  if constexpr (kSharedS) {
    __syncthreads();  // every warp is done with C
    tc_store_scores<N>(reinterpret_cast<uint4*>(tc_smem), tiles, Q);
  }

  // 3. the heads: group k takes heads k, k + groups, ...; head hl's x lies in buffer
  // hl % 2 and the load of head hl + 2 follows its use. With two groups the other
  // group computes while one waits for its load; with one, the buffers alternate.
  cp_async_wait<0>();
  __syncthreads();  // C, B (or the score tiles), the first x tiles and the scans
  for (int hl = group; hl < nh; hl += kGroups) {
    bf16* sX = (hl & 1) ? sX1 : sX0;
    if (hl >= 2) {
      if (kGroups == 1 && hl + 1 < nh)
        cp_async_wait<1>();  // head hl + 1's load may stay in flight
      else
        cp_async_wait<0>();
      group_sync(group);
    }
    const int h = h0 + hl;
    if (!(kProbe & 1))
      tc_y_intra<N, kIntraBf16, kSharedS>(
          sC, sB, sS, sX, sCum + hl * Q, sDt + hl * Q, sCC + hl * Q,
          reinterpret_cast<const bf16*>(sCC + hl * Q),
          y + row0 * x_stride + static_cast<long long>(h) * P, x_stride, Q, P);
    if (!(kProbe & 2))
      tc_states<N>(sB, sX, sW + hl * Q,
                   states + (chunk * H + h) * static_cast<long long>(P) * N, Q, P);
    group_sync(group);  // the group is done with sX
    if (hl + 2 < nh && !(kProbe & 16)) {
      stage_x(sX, xb + (hl + 2) * P, x_stride, Q, P);
      cp_async_commit();
    }
  }
}

template <int N, bool kIntraBf16, bool kSharedS>
int launch_tc_instance(const void* x, const void* dt, const void* A, const void* B,
                       const void* C, void* y, void* states, void* a_total, void* y_decay,
                       int b, int nc, int Q, int H, int P, int G, cudaStream_t stream) {
  const int heads = tc_heads(Q, P, N);
  const size_t smem =
      kSharedS ? tc_shared_smem_bytes(Q, P, N, heads) : tc_smem_bytes(Q, P, N, heads);
  const cudaError_t err =
      cudaFuncSetAttribute(ssd_chunk_tc_kernel<N, kIntraBf16, kSharedS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int head_blocks = (H / G + heads - 1) / heads;
  const dim3 grid(head_blocks * G, nc, b);
  ssd_chunk_tc_kernel<N, kIntraBf16, kSharedS>
      <<<grid, kTcGroupThreads * tc_groups<N>(), smem, stream>>>(
          static_cast<const bf16*>(x), static_cast<const float*>(dt),
          static_cast<const float*>(A), static_cast<const bf16*>(B),
          static_cast<const bf16*>(C), static_cast<float*>(y), static_cast<float*>(states),
          static_cast<float*>(a_total), static_cast<float*>(y_decay), nc, Q, H, P, G, heads,
          head_blocks);
  return cudaGetLastError();
}

// The instance of the shape: in the bf16-intra mode with the block's score tiles where
// they fit (tc_shares_scores).
template <int N, bool kIntraBf16>
int launch_tc(const void* x, const void* dt, const void* A, const void* B, const void* C,
              void* y, void* states, void* a_total, void* y_decay, int b, int nc, int Q, int H,
              int P, int G, cudaStream_t stream) {
  if constexpr (kIntraBf16) {
    if (tc_shares_scores(Q, P, N))
      return launch_tc_instance<N, true, true>(x, dt, A, B, C, y, states, a_total, y_decay, b,
                                               nc, Q, H, P, G, stream);
  }
  return launch_tc_instance<N, kIntraBf16, false>(x, dt, A, B, C, y, states, a_total, y_decay,
                                                  b, nc, Q, H, P, G, stream);
}

template <bool kIntraBf16>
int fwd(const void* x, const void* dt, const void* A, const void* B, const void* C, void* y,
        void* states, void* a_total, void* y_decay, int b, int nc, int Q, int H, int P, int G,
        int N, int in_bf16, cudaStream_t stream) {
  if (in_bf16)
    return launch<__nv_bfloat16, kIntraBf16>(x, dt, A, B, C, y, states, a_total, y_decay, b, nc,
                                             Q, H, P, G, N, stream);
  return launch<float, kIntraBf16>(x, dt, A, B, C, y, states, a_total, y_decay, b, nc, Q, H, P,
                                   G, N, stream);
}

template <bool kIntraBf16>
int fwd_tc(const void* x, const void* dt, const void* A, const void* B, const void* C, void* y,
           void* states, void* a_total, void* y_decay, int b, int nc, int Q, int H, int P, int G,
           int N, cudaStream_t stream) {
  if (Q % 16 || P % 16 || tc_heads(Q, P, N) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (N) {
#define SSD_TC_CASE(n)                                                                          \
  case n:                                                                                       \
    return launch_tc<n, kIntraBf16>(x, dt, A, B, C, y, states, a_total, y_decay, b, nc, Q, H, P, \
                                    G, stream);
    SSD_TC_CASE(16) SSD_TC_CASE(32) SSD_TC_CASE(48) SSD_TC_CASE(64)
    SSD_TC_CASE(80) SSD_TC_CASE(96) SSD_TC_CASE(112) SSD_TC_CASE(128)
#undef SSD_TC_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
  return fwd<false>(x, dt, A, B, C, y, states, a_total, y_decay, b, nc, Q, H, P, G, N, in_bf16,
                    stream);
}

// ssd_chunk_fwd in the bf16-intra mode.
extern "C" int ssd_chunk_fwd_bf16i(const void* x, const void* dt, const void* A, const void* B,
                                   const void* C, void* y, void* states, void* a_total,
                                   void* y_decay, int b, int nc, int Q, int H, int P, int G,
                                   int N, int in_bf16, cudaStream_t stream) {
  return fwd<true>(x, dt, A, B, C, y, states, a_total, y_decay, b, nc, Q, H, P, G, N, in_bf16,
                   stream);
}

// x (b, nc, Q, H, P) and B, C (b, nc, Q, G, N) in bf16, 16-byte aligned; dt (b, nc, Q,
// H) and A (H,) f32; outputs as ssd_chunk_fwd's. Q, P and N multiples of 16, N <= 128,
// and the shared memory of one head a block (tc_smem_bytes) within the block's 227 KB;
// any other shape returns cudaErrorInvalidValue.
extern "C" int ssd_chunk_fwd_tc(const void* x, const void* dt, const void* A, const void* B,
                                const void* C, void* y, void* states, void* a_total,
                                void* y_decay, int b, int nc, int Q, int H, int P, int G, int N,
                                cudaStream_t stream) {
  return fwd_tc<false>(x, dt, A, B, C, y, states, a_total, y_decay, b, nc, Q, H, P, G, N, stream);
}

// ssd_chunk_fwd_tc in the bf16-intra mode.
extern "C" int ssd_chunk_fwd_tc_bf16i(const void* x, const void* dt, const void* A,
                                      const void* B, const void* C, void* y, void* states,
                                      void* a_total, void* y_decay, int b, int nc, int Q, int H,
                                      int P, int G, int N, cudaStream_t stream) {
  return fwd_tc<true>(x, dt, A, B, C, y, states, a_total, y_decay, b, nc, Q, H, P, G, N, stream);
}
