// Hand-written Hopper (sm_90a) kernels of the BlobShuffle device data plane:
// the Batcher's pack into per-partition blobs, the Debatcher's unpack, and
// the fused int8 codec on both sides.
//
// Each kernel has an extern "C" launcher that takes the caller's CUDA stream
// (PyTorch's current stream), launches without synchronising, allocates
// nothing, and returns cudaGetLastError(). The Python wrappers in
// repro_torch/kernels/*/kernel.py check every argument before they call.
//
// All four are bound by device-memory bandwidth: they do a few operations per
// byte, far below the H100's ~295 operations per byte of bf16 balance. The
// design goal is therefore coalesced 16-byte accesses and nothing else: one
// warp per destination row, neighbouring lanes on neighbouring 16-byte words,
// 8 warps per block, many blocks in flight per SM to hide the latency of the
// row gathers. Rows that are padding (pack) or dropped (unpack) are written
// as zero without being read. Every byte offset is 64-bit: at the paper's
// deployment size the blob layout is 3.4 GB and the dequantized output 6.6 GB.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// VEC elements of T moved as one aligned access (16 bytes where possible).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

__device__ __forceinline__ long long clip(long long i, long long n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// Largest power-of-two access width (16..1 bytes) that divides the row and
// both base pointers.
int access_width(long long row_bytes, const void* a, const void* b) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
  for (int w = 16; w > 1; w >>= 1)
    if (row_bytes % w == 0 && p % w == 0) return w;
  return 1;
}

// ---------------------------------------------------------------------------
// Kernel 1: pack. Replaces blob_pack_fused_pallas and blob_pack_pallas
// (src/repro/kernels/blob_pack/kernel.py, both through _pack_call):
//   out[b, r] = x[order[clip(starts[b] + r, 0, U-1)]]  if r < min(counts[b], cap)
//             = 0                                      otherwise.
// A byte copy of whole rows, so it is bit-exact for every payload dtype.
// Bound: bytes (read the live rows once, write the layout once). Grid: one
// block per (bin, tile of rows_per_block rows); warp w of the block copies
// rows w, w+8, ... of the tile. The tile may overhang the bin's capacity.
template <typename V>
__global__ void __launch_bounds__(kThreads)
pack_rows_kernel(const V* __restrict__ x, const int32_t* __restrict__ order,
                 const int32_t* __restrict__ starts,
                 const int32_t* __restrict__ counts, V* __restrict__ out,
                 long long U, long long cap, long long row_vecs,
                 int rows_per_block, long long tiles_per_bin) {
  const long long b = blockIdx.x / tiles_per_bin;
  const long long r0 = (blockIdx.x % tiles_per_bin) * rows_per_block;
  const long long start = starts[b];
  const long long count = min(static_cast<long long>(counts[b]), cap);
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < rows_per_block; i += kWarps) {
    const long long r = r0 + i;
    if (r >= cap) break;
    V* dst = out + (b * cap + r) * row_vecs;
    if (r < count) {
      const V* src = x + static_cast<long long>(order[clip(start + r, U)]) * row_vecs;
#pragma unroll 4
      for (long long j = lane; j < row_vecs; j += 32) dst[j] = src[j];
    } else {
      for (long long j = lane; j < row_vecs; j += 32) dst[j] = V{};
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel 2: unpack. Replaces blob_unpack_fused_pallas and blob_unpack_pallas
// (src/repro/kernels/blob_unpack/kernel.py), which give the same output:
//   out[u] = flat[clip(slot[u], 0, R-1)]  if valid[u],  else 0,
// with flat the (bins*cap, d) view of the blob layout. Byte copy as above;
// bound by bytes. One block per tile of rows_per_block unit rows.
template <typename V>
__global__ void __launch_bounds__(kThreads)
unpack_rows_kernel(const V* __restrict__ buf, const int32_t* __restrict__ slot,
                   const uint8_t* __restrict__ valid, V* __restrict__ out,
                   long long U, long long R, long long row_vecs,
                   int rows_per_block) {
  const long long u0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < rows_per_block; i += kWarps) {
    const long long u = u0 + i;
    if (u >= U) break;
    V* dst = out + u * row_vecs;
    if (valid[u]) {
      const V* src = buf + clip(slot[u], R) * row_vecs;
#pragma unroll 4
      for (long long j = lane; j < row_vecs; j += 32) dst[j] = src[j];
    } else {
      for (long long j = lane; j < row_vecs; j += 32) dst[j] = V{};
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel 3: compress-pack. Replaces compress_pack_fused_pallas
// (src/repro/kernels/blob_codec/kernel.py): the pack gather of kernel 1, then
// per-row symmetric int8 quantization, bit-exact with quantize_rows
// (src/repro/kernels/blob_codec/ref.py):
//   scale = absmax * f32(1/127)  (1.0 for an all-zero row)
//   q     = clip(round_half_even(x / scale), -127, 127)
// Three details keep it bit-exact: the scale is a multiply by f32(1/127)
// (bits 0x3C010204), never a divide by 127; x / scale is
// the IEEE divide __fdiv_rn (the build never passes --use_fast_math); rintf
// rounds half to even. The f32 widening of bf16 is exact (a 16-bit shift).
// Bound: bytes (read the live rows, write int8 codes and f32 scales). The
// warp reads its row twice, for the absmax and for the codes; the second
// read hits L1. Padding rows become (q = 0, scale = 1.0) without a read.
constexpr uint32_t kInv127Bits = 0x3C010204u;  // f32(1/127) = 0x1.020408p-7

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint16_t bf16_bits) {
  return __uint_as_float(static_cast<uint32_t>(bf16_bits) << 16);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
compress_pack_kernel(const T* __restrict__ x, const int32_t* __restrict__ order,
                     const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ counts, int8_t* __restrict__ q,
                     float* __restrict__ scales, long long U, long long cap,
                     long long d, int rows_per_block, long long tiles_per_bin) {
  using In = Vec<T, VEC>;
  using Out = Vec<int8_t, VEC>;
  const long long b = blockIdx.x / tiles_per_bin;
  const long long r0 = (blockIdx.x % tiles_per_bin) * rows_per_block;
  const long long start = starts[b];
  const long long count = min(static_cast<long long>(counts[b]), cap);
  const long long nvec = d / VEC;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < rows_per_block; i += kWarps) {
    const long long r = r0 + i;
    if (r >= cap) break;
    const long long row = b * cap + r;
    Out* dst = reinterpret_cast<Out*>(q + row * d);
    if (r < count) {
      const In* src = reinterpret_cast<const In*>(
          x + static_cast<long long>(order[clip(start + r, U)]) * d);
      float amax = 0.0f;
      for (long long j = lane; j < nvec; j += 32) {
        const In p = src[j];
#pragma unroll
        for (int k = 0; k < VEC; ++k) amax = fmaxf(amax, fabsf(to_f32(p.v[k])));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      const float scale = amax > 0.0f ? amax * __uint_as_float(kInv127Bits) : 1.0f;
      for (long long j = lane; j < nvec; j += 32) {
        const In p = src[j];
        Out o;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float c = rintf(__fdiv_rn(to_f32(p.v[k]), scale));
          o.v[k] = static_cast<int8_t>(fminf(fmaxf(c, -127.0f), 127.0f));
        }
        dst[j] = o;
      }
      if (lane == 0) scales[row] = scale;
    } else {
      for (long long j = lane; j < nvec; j += 32) dst[j] = Out{};
      if (lane == 0) scales[row] = 1.0f;
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel 4: unpack-decompress. Replaces unpack_decompress_fused_pallas
// (src/repro/kernels/blob_codec/kernel.py):
//   out[u] = f32(q[s]) * scales[s]  with s = clip(slot[u], 0, R-1), if valid[u]
//          = 0                                                      otherwise,
// one f32 multiply per element, as int8_dequantize does. Bound: bytes, and
// mostly the f32 output (4 bytes written per int8 code read), so the access
// width is chosen for coalesced 16-byte stores.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
unpack_decompress_kernel(const int8_t* __restrict__ q,
                         const float* __restrict__ scales,
                         const int32_t* __restrict__ slot,
                         const uint8_t* __restrict__ valid,
                         float* __restrict__ out, long long U, long long R,
                         long long d, int rows_per_block) {
  using In = Vec<int8_t, VEC>;
  using Out = Vec<float, VEC>;
  const long long u0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long nvec = d / VEC;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < rows_per_block; i += kWarps) {
    const long long u = u0 + i;
    if (u >= U) break;
    Out* dst = reinterpret_cast<Out*>(out + u * d);
    if (valid[u]) {
      const long long s = clip(slot[u], R);
      const float scale = scales[s];
      const In* src = reinterpret_cast<const In*>(q + s * d);
      for (long long j = lane; j < nvec; j += 32) {
        const In p = src[j];
        Out o;
#pragma unroll
        for (int k = 0; k < VEC; ++k) o.v[k] = static_cast<float>(p.v[k]) * scale;
        dst[j] = o;
      }
    } else {
      for (long long j = lane; j < nvec; j += 32) dst[j] = Out{};
    }
  }
}

bool bad_grid(long long blocks) { return blocks < 1 || blocks > INT_MAX; }

}  // namespace

extern "C" int blob_pack_rows(const void* x, const void* order, const void* starts,
                              const void* counts, void* out, long long U,
                              long long bins, long long cap, long long row_bytes,
                              int rows_per_block, void* stream) {
  if (U < 1 || cap < 1 || row_bytes < 1 || rows_per_block < 1) return cudaErrorInvalidValue;
  const long long tiles = (cap + rows_per_block - 1) / rows_per_block;
  if (bad_grid(bins * tiles)) return cudaErrorInvalidConfiguration;
  const int w = access_width(row_bytes, x, out);
  const auto* o = static_cast<const int32_t*>(order);
  const auto* st = static_cast<const int32_t*>(starts);
  const auto* ct = static_cast<const int32_t*>(counts);
  const dim3 grid(static_cast<unsigned>(bins * tiles));
  auto s = static_cast<cudaStream_t>(stream);
#define PACK(V)                                                                        \
  pack_rows_kernel<V><<<grid, kThreads, 0, s>>>(static_cast<const V*>(x), o, st, ct,  \
                                                static_cast<V*>(out), U, cap,          \
                                                row_bytes / w, rows_per_block, tiles)
  switch (w) {
    case 16: PACK(uint4); break;
    case 8: PACK(uint2); break;
    case 4: PACK(uint32_t); break;
    case 2: PACK(uint16_t); break;
    default: PACK(uint8_t); break;
  }
#undef PACK
  return cudaGetLastError();
}

extern "C" int blob_unpack_rows(const void* buf, const void* slot, const void* valid,
                                void* out, long long U, long long R, long long row_bytes,
                                int rows_per_block, void* stream) {
  if (U < 1 || R < 1 || row_bytes < 1 || rows_per_block < 1) return cudaErrorInvalidValue;
  const long long blocks = (U + rows_per_block - 1) / rows_per_block;
  if (bad_grid(blocks)) return cudaErrorInvalidConfiguration;
  const int w = access_width(row_bytes, buf, out);
  const auto* sl = static_cast<const int32_t*>(slot);
  const auto* va = static_cast<const uint8_t*>(valid);
  const dim3 grid(static_cast<unsigned>(blocks));
  auto s = static_cast<cudaStream_t>(stream);
#define UNPACK(V)                                                                         \
  unpack_rows_kernel<V><<<grid, kThreads, 0, s>>>(static_cast<const V*>(buf), sl, va,    \
                                                  static_cast<V*>(out), U, R,             \
                                                  row_bytes / w, rows_per_block)
  switch (w) {
    case 16: UNPACK(uint4); break;
    case 8: UNPACK(uint2); break;
    case 4: UNPACK(uint32_t); break;
    case 2: UNPACK(uint16_t); break;
    default: UNPACK(uint8_t); break;
  }
#undef UNPACK
  return cudaGetLastError();
}

// x_is_bf16: 1 for bf16 rows (passed as their uint16 bits), 0 for f32 rows.
extern "C" int blob_compress_pack(const void* x, int x_is_bf16, const void* order,
                                  const void* starts, const void* counts, void* q,
                                  void* scales, long long U, long long bins, long long cap,
                                  long long d, int rows_per_block, void* stream) {
  if (U < 1 || cap < 1 || d < 1 || rows_per_block < 1) return cudaErrorInvalidValue;
  const long long tiles = (cap + rows_per_block - 1) / rows_per_block;
  if (bad_grid(bins * tiles)) return cudaErrorInvalidConfiguration;
  const auto* o = static_cast<const int32_t*>(order);
  const auto* st = static_cast<const int32_t*>(starts);
  const auto* ct = static_cast<const int32_t*>(counts);
  auto* qo = static_cast<int8_t*>(q);
  auto* so = static_cast<float*>(scales);
  const dim3 grid(static_cast<unsigned>(bins * tiles));
  auto s = static_cast<cudaStream_t>(stream);
  // 16-byte loads of the row: 8 bf16 or 4 f32 per access, when d and both
  // base pointers allow it; one element per access otherwise.
  const int vec = x_is_bf16 ? 8 : 4;
  const bool wide = d % vec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(q) % vec == 0;
#define COMPRESS(T, VEC)                                                                   \
  compress_pack_kernel<T, VEC><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x), o, st, \
                                                         ct, qo, so, U, cap, d,            \
                                                         rows_per_block, tiles)
  if (x_is_bf16) {
    if (wide) COMPRESS(uint16_t, 8); else COMPRESS(uint16_t, 1);
  } else {
    if (wide) COMPRESS(float, 4); else COMPRESS(float, 1);
  }
#undef COMPRESS
  return cudaGetLastError();
}

extern "C" int blob_unpack_decompress(const void* q, const void* scales, const void* slot,
                                      const void* valid, void* out, long long U,
                                      long long R, long long d, int rows_per_block,
                                      void* stream) {
  if (U < 1 || R < 1 || d < 1 || rows_per_block < 1) return cudaErrorInvalidValue;
  const long long blocks = (U + rows_per_block - 1) / rows_per_block;
  if (bad_grid(blocks)) return cudaErrorInvalidConfiguration;
  const auto* qi = static_cast<const int8_t*>(q);
  const auto* sc = static_cast<const float*>(scales);
  const auto* sl = static_cast<const int32_t*>(slot);
  const auto* va = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<float*>(out);
  const dim3 grid(static_cast<unsigned>(blocks));
  auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t qa = reinterpret_cast<uintptr_t>(q);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
#define DECOMPRESS(VEC)                                                               \
  unpack_decompress_kernel<VEC><<<grid, kThreads, 0, s>>>(qi, sc, sl, va, o, U, R, d, \
                                                          rows_per_block)
  // 4 codes in, one 16-byte float4 out per lane: the warp's stores, 80% of
  // the bytes, are contiguous. 16 codes per lane would give 16-byte loads
  // but stride each warp store instruction by 64 bytes.
  if (d % 4 == 0 && qa % 4 == 0 && oa % 16 == 0) DECOMPRESS(4);
  else DECOMPRESS(1);
#undef DECOMPRESS
  return cudaGetLastError();
}
