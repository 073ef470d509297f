// Hand-written Hopper (sm_90a) flash-attention forward kernels.
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention/kernel.py,
// pallas_call at :93): causal or full attention, grouped-query heads (q head h
// reads kv-head h / (H / KVH), with no repeat), scale 1/sqrt(D) applied to the
// f32 scores, an online softmax over kv tiles with f32 statistics, masked
// scores -1e30 (kpos >= Skv, and kpos > qpos when causal) with the running
// maximum starting at -1e30, and output acc / max(l, 1e-30) in q's dtype.
// Query row i sits at position qpos = i + q_offset (q_offset >= 0), as in
// the jnp flash_attention (src/repro/models/flash.py) that the port's kernel
// replaces at attention_op's call site: a suffix of Sq queries over Skv keys
// takes q_offset = Skv - Sq. The offset moves only the causal mask and the
// number of kv tiles a q tile reaches, never the row loaded or stored.
// Two kernels serve the two routes, chosen by dtype (the wrapper,
// repro_torch/kernels/flash_attention/kernel.py, picks the symbol); a third
// is kept, off every route, as the timed comparison of the first at large D:
//
//   bf16, D in {16, 32, ..., 256}   flash_fwd_wgmma_kernel  (wgmma, TMA)
//   f32,  D in {16, 32, ..., 256}   flash_fwd_f32_kernel    (CUDA cores)
//   bf16, D in {144, 160, ..., 256} flash_fwd_mma_kernel    (mma.sync; no route)
//
// --- bf16: flash_fwd_wgmma_kernel -------------------------------------------
// Bounds at Zamba2-2.7B's prefill shape (B 4, S 4096, 32 heads of D 80,
// causal): one call is 344 GFLOP of matrix products, 0.35 ms at the 989
// TFLOP/s bf16 tensor-core peak, against 0.34 GB of q, k, v and output
// (0.10 ms at 3.35 TB/s). The softmax adds 4 x 32 x 4096 x 4097 / 2 = 1.07e9
// exp2 on the special-function units, ~0.28 ms at their ~3.9 T/s: at D 80
// the exponentials cost nearly as much as the products, and only running
// them while the tensor cores work keeps the kernel near 0.35 ms rather than
// the 0.63 ms of the two back to back. FlashAttention-3's structure
// (arXiv:2407.08608), written out by hand:
//   - a persistent grid of one block per SM; a block walks work items (a q
//     tile of 128 rows of one head and batch row), q tile fastest and the
//     longest causal tile first, so that the blocks at work at one time
//     share the K and V of a few heads in L2 (where the K and V that the
//     items read fit in L2: the balanced order below);
//   - three warpgroups: a producer and two consumers of 64 q rows each.
//     setmaxnreg moves registers from the producer (40) to the consumers
//     (232);
//   - the producer's one thread issues TMA loads: an item's Q, then K_j and
//     V_j (128 rows each) into a ring of 2 to 4 stages (as many as fit), each
//     with a full and an empty mbarrier; Q has its own pair, freed after the
//     item's last Q K^T, so the next item's Q and first tiles load while the
//     consumers finish this one. The tensor maps are 4-D over (D, heads, S,
//     B), so a tile past Sq or Skv is zero-filled by the hardware within its
//     own batch row, never read from the next one;
//   - S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//     (K-major); the online softmax runs in registers in the exp2 domain,
//     with the scale folded into one fma per score and ex2.approx.ftz on the
//     special-function unit; O += P V is wgmma m64nDk16 with P as the A
//     operand from registers (the S accumulator repacked to bf16 pairs: the
//     two layouts agree fragment by fragment) and V from shared memory as an
//     MN-major B operand (imm-trans-b 1);
//   - each consumer issues Q K_j^T together with P_{j-1} V_{j-1} and runs
//     the softmax of tile j while P_{j-1} V_{j-1} is still on the tensor
//     cores; two named barriers order the two consumers' issues (ping-pong),
//     so that one consumer's softmax runs while the other's products run;
//   - the mask is computed only on the tiles that need it: the causal
//     diagonal and the tile holding Skv's edge (at S 4096, 32 of a (head,
//     batch)'s 528 tile pairs per consumer);
//   - the output is acc times 1 / max(l, 1e-30), within an f32 rounding of
//     the quotient, stored as bf16 pairs.
// Shared memory: Q and K tiles are 64-column boxes with the 128-byte swizzle
// plus a tail box of the narrowest swizzle that holds the rest (below, at
// WgmmaTiles). D 80 is not a swizzle width (a 160-byte row): its Q and K take
// a 64-column box and a 16-column box with the 32-byte swizzle, so TMA moves
// no padding for them (Q K^T is 4 k-steps on the first box and 1 on the
// second). V takes two 64-column boxes, columns 80-127 zero-filled by TMA
// and never read, so that P V is one wgmma of N 80 per k-step. At D 80, Q
// (20 KB) and 3 stages of K (20 KB) and V (32 KB) take 176 KB: one block per
// SM, as the registers require anyway.
// D 144-256: gemma-2b's 256 (B 1, S 4096, 8 heads, 1 kv head, causal:
// 68.7 GFLOP, 0.070 ms at the bf16 peak, against 0.038 GB, 0.011 ms) and
// deepseek-v2-lite's MLA at 192 (16 heads and kv heads: 103.1 GFLOP,
// 0.104 ms, against 0.101 GB, 0.030 ms). The products per score are 2.4-3.2
// times D 80's, so a consumer's softmax takes about as long as the other
// consumer's products (at D 80 it took twice as long), and the kernel is
// bound by the tensor cores, the softmax beside them and how evenly the
// blocks share the work. Two things change with D above 128:
//   - kv tiles of 96 rows up to D 192 and 64 above (kBlockKV), so Q K^T is
//     m64n96k16 or m64n64k16. With 128 rows, one stage of K and V no
//     longer fits beside Q from D 176 up, and S (64 registers a thread),
//     P (32) and O (D / 2) leave a consumer too few registers from D 144
//     up. With 96 and 64 rows: Q 36-64 KB, K + V 58-73 KB a stage, 3
//     stages at D 144, 2 from D 160; S + P + O 144-176 registers, so the
//     register split of D <= 128 (below) serves every D. At D 192, 96 rows
//     took 0.198 ms against 64 rows' 0.214 (tools/flash_probe.py
//     --shape deepseek-v2-lite --compare, on an H100 80GB HBM3 at 700 W):
//     the softmax's fixed cost a tile is spread over more keys;
//   - the item order (at work_item) is the launcher's choice, from the
//     bytes of K and V that the items read (all, or half under the causal
//     mask) against L2's size, not from D. At B 1 with 8 or 16 heads the
//     head-major order leaves the busiest SM 1.875 and 1.615 times the
//     mean number of kv tiles; the balanced order gives it the mean and
//     took 0.139 and 0.194 ms at gemma-2b's and deepseek-v2-lite's shapes
//     against 0.228 and 0.276. At B 4 gemma-2b's K and V (17 MB) still
//     fit: 0.503 against 0.559 ms; deepseek-v2-lite's (201 MB) do not, and
//     head-major took 0.802 against 0.890, as at Zamba2's B 4 (0.929
//     against 1.172). (tools/flash_probe.py --batch 1 2 4, on an H100 80GB
//     HBM3 at 700 W.)
// P V is one wgmma of N = D (up to m64n256k16, 128 accumulators a thread).
//
// --- bf16, D 144-256: flash_fwd_mma_kernel (no route) ------------------------
// The Ampere-style kernel that served these head dims before the wgmma
// kernel did, kept as its timed comparison: one block of 4 warps per (q
// tile of 64 rows, head, batch), 16 q rows a warp; single-buffered 64-row
// K and V tiles staged with cp.async (rows past Skv zero-filled); mma.sync
// m16n8k16 with ldmatrix fragments from rows padded by 16 bytes; P rounded
// to bf16 for the second product while l sums the f32 probabilities;
// causal blocks skip the kv tiles above the diagonal.
//
// --- f32: flash_fwd_f32_kernel -----------------------------------------------
// The Pallas kernel's f32 arithmetic throughout (q * scale, both products
// and the probabilities in f32, exp rather than exp2) on the CUDA cores: the
// tensor cores have no f32 inputs, and rounding to bf16 or tf32 would break
// the f32 contract. Bound by f32 operations (~1.3 ms at 67 TFLOP/s for one
// causal call at Zamba2's shape at batch 1); no configuration of the repo
// serves in f32, so it is built for being right, not fast:
//   - one block of 128 threads per (q tile of 64 rows, head, batch), K and
//     V tiles of 32 rows; Q (scaled), K, V and the probabilities P are
//     staged in shared memory with an odd row pitch, so that column reads
//     are free of bank conflicts;
//   - each thread owns 4 query rows x 4 keys of the scores and 4 rows x D/8
//     columns of the output; a row's 32 scores sit in the 8 consecutive
//     lanes that share the row group, reduced with three shuffles.
//
// In every kernel the head dim is a template parameter, so the accumulators
// stay in registers; every global offset is 64-bit. The scale times log2(e)
// multiplies the f32 scores in the bf16 kernels: that equals the Pallas
// kernel's scaling of q in f32, because bf16 products are exact in f32,
// where a bf16 copy of q * scale would add a rounding the Pallas kernel does
// not have.
//
// Each extern "C" launcher takes the caller's stream, launches without
// synchronising, allocates nothing, and returns a cudaError_t. The wgmma
// launcher encodes its five tensor maps on the host per call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so that
// the library needs no -lcuda, and reads the card's SM count for its grid.
// The Python wrapper checks every argument before it calls.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // q rows per block, kv rows per tile (mma.sync, f32)
constexpr int kThreads = 128;  // 4 warps (mma.sync, f32)
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

// --- the wgmma kernel --------------------------------------------------------

constexpr int kWgRows = 64;                    // q rows per consumer warpgroup
constexpr int kConsumers = 2;                  // consumer warpgroups
constexpr int kBlockQ = kWgRows * kConsumers;  // q rows per block
constexpr int kWgThreads = 128;
constexpr int kWgmmaThreads = (kConsumers + 1) * kWgThreads;
constexpr int kBoxCols = 64;                   // one 128-byte swizzle row of bf16
// kv rows per tile: 128 up to D 128; above, where two stages of 128-row K
// and V tiles no longer fit beside Q, nor the S, P and O accumulators in a
// consumer's registers, 96 up to D 192 and 64 above
template <int D>
constexpr int kBlockKV = D <= 128 ? 128 : D <= 192 ? 96 : 64;
// setmaxnreg: registers a thread after the split (128 x 40 + 256 x 232 of
// the SM's 64 K). 232 hold a consumer's S, P and O at every D (0 spills by
// ptxas -v); a producer of 24 registers, for consumers of 240, spilled at
// D 224-256.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// named barriers 1 and 2 order the two consumers' issues (0 is
// __syncthreads)
constexpr int kSchedBarrier = 1;

// Switches of tools/flash_probe.py, a bit mask fixed at build time
// (-DFLASH_PROBE=n; 0, the default, builds the kernel as it is). The probe
// cuts parts out to see what the rest costs, so every switch but 8 makes
// the kernel compute something else:
//   1  no softmax (P is the raw scores, alpha 1);
//   2  no wgmma (S and O are never written);
//   4  clock64() stamps at the steps of the consumer loop (probe_stamp);
//   8  Q and K tail boxes of 64 columns with the 128-byte swizzle,
//      zero-filled past D, as V's are (a layout that computes the same);
//   16 V loads only its first 64-column box;
//   32 the other item order (block_item): the one the launcher does not
//      pick.
#ifndef FLASH_PROBE
#define FLASH_PROBE 0
#endif
constexpr int kProbe = FLASH_PROBE;

// Shared-memory tiles, each a row of TMA boxes of R rows (R rows of the
// box's pitch; the boxes of a tile lie one after the other). A Q or K tile
// of D columns takes D / 64 boxes of 64 columns (128-byte rows, 128-byte
// swizzle) and a tail box for the rest: 16 columns take 32-byte rows
// (32-byte swizzle), 32 columns 64-byte rows (64-byte swizzle), 48 columns
// a 64-column box whose last 16 columns TMA fills with zeros. A V tile takes
// 64-column boxes only, zero-filled past D, so that P V is one product of
// N = D per k-step: split at the tail it doubled the products issued and
// ran slower.
template <int D>
struct WgmmaTiles {
  static constexpr int kMain = D / kBoxCols;
  static constexpr int kTail = D % kBoxCols;
  static constexpr int kTailPitch = kTail == 0                 ? 0
                                    : kTail == 48 || kProbe & 8 ? 128
                                    : kTail == 16               ? 32
                                                                : 64;
  static constexpr int kPitch = kMain * 128 + kTailPitch;  // bytes of a tile row, all boxes
  static constexpr int kKV = kBlockKV<D>;
  static constexpr int kQBytes = kBlockQ * kPitch;
  static constexpr int kKBytes = kKV * kPitch;             // one K tile
  // V: all boxes 64 columns wide, so that P V is one product of N = D
  static constexpr int kVBoxes = (D + kBoxCols - 1) / kBoxCols;
  static constexpr int kVBytes = kKV * 128 * kVBoxes;
  // + 1024: the dynamic base is aligned up to the swizzle atom by hand
  static constexpr int kFree = 232448 - 1024 - 8 * (2 + 4 * 4) - kQBytes;
  static constexpr int kStages =
      kFree / (kKBytes + kVBytes) < 4 ? kFree / (kKBytes + kVBytes) : 4;
  static constexpr int kSmem =
      kQBytes + kStages * (kKBytes + kVBytes) + 8 * (2 + 4 * kStages) + 1024;
  static_assert(kStages >= 2, "the K and V ring needs two stages");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait for the completion of the barrier's phase of this parity. A wait
// that lasts ~10 s can only be a fault of the pipeline: it traps, so that
// the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    if (clock64() - start > (1ll << 34)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 4-D tensor map into shared memory; completion is counted in
// bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accesses of these registers across the
// asynchronous products' fences and waits.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor of a swizzled operand with rows of `pitch`
// bytes (128, 64 or 32: the swizzle width): start address, leading and
// stride byte offsets (16-byte units), and the layout (1: 128-byte swizzle,
// 2: 64-byte, 3: 32-byte). The stride byte offset is always the next 8 rows.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, int pitch) {
  const uint64_t layout = pitch == 128 ? 1 : pitch == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(((8 * pitch) >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// The "+f" operands of eight accumulator registers from d[i].
#define WG_D8(i)                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),      \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x N, f32) = (scale_d ? d : 0) + A (64 x 16) B (16 x N); A and B in
// shared memory, K-major, swizzled (the descriptors say how).
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<96>(float (&d)[48], uint64_t a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47},"
      " %48, %49, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32),
        WG_D8(40)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32),
        WG_D8(40), WG_D8(48), WG_D8(56)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x N, f32) += A (64 x 16, registers: the m16n8k16 A fragment of each
// warp's 16 rows) B (16 x N); B in shared memory, MN-major (imm-trans-b 1),
// 128-byte swizzle. N is the head dim: every multiple of 16 up to 256.
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7},"
      " {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : WG_D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23},"
      " {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39},"
      " {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47},"
      " {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32),
        WG_D8(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<112>(float (&d)[56], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55},"
      " {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32),
        WG_D8(40), WG_D8(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32),
        WG_D8(40), WG_D8(48), WG_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<144>(float (&d)[72], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71},"
      " {%72, %73, %74, %75}, %76, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32),
        WG_D8(40), WG_D8(48), WG_D8(56), WG_D8(64)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<160>(float (&d)[80], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79},"
      " {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32),
        WG_D8(40), WG_D8(48), WG_D8(56), WG_D8(64), WG_D8(72)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<176>(float (&d)[88], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %93, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87},"
      " {%88, %89, %90, %91}, %92, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32),
        WG_D8(40), WG_D8(48), WG_D8(56), WG_D8(64), WG_D8(72),
        WG_D8(80)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95},"
      " {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32),
        WG_D8(40), WG_D8(48), WG_D8(56), WG_D8(64), WG_D8(72),
        WG_D8(80), WG_D8(88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<208>(float (&d)[104], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %109, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103},"
      " {%104, %105, %106, %107}, %108, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32),
        WG_D8(40), WG_D8(48), WG_D8(56), WG_D8(64), WG_D8(72),
        WG_D8(80), WG_D8(88), WG_D8(96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<224>(float (&d)[112], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %117, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111},"
      " {%112, %113, %114, %115}, %116, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32),
        WG_D8(40), WG_D8(48), WG_D8(56), WG_D8(64), WG_D8(72),
        WG_D8(80), WG_D8(88), WG_D8(96), WG_D8(104)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<240>(float (&d)[120], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %125, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n240k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119},"
      " {%120, %121, %122, %123}, %124, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32),
        WG_D8(40), WG_D8(48), WG_D8(56), WG_D8(64), WG_D8(72),
        WG_D8(80), WG_D8(88), WG_D8(96), WG_D8(104), WG_D8(112)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127},"
      " {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32),
        WG_D8(40), WG_D8(48), WG_D8(56), WG_D8(64), WG_D8(72),
        WG_D8(80), WG_D8(88), WG_D8(96), WG_D8(104), WG_D8(112),
        WG_D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WG_D8

// exp2 on the special-function unit, results below 2^-126 flushed to zero
// (such a probability is lost in bf16 and in l alike).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one 64 x KV score tile in the S accumulator of a
// consumer warpgroup. This thread holds rows `row` and `row + 8`, columns
// k0 + 8 n + 2 tq + {0, 1} in s[4 n + {0, 1}] and s[4 n + {2, 3}]. Turns s
// into the f32 probabilities exp2(s scale_log2 - m scale_log2), updates the
// running maximum m (of the unscaled scores) and sum l, and returns in alpha
// the factor by which the output accumulator must be rescaled. Maxima and
// sums run in 4 partial chains per row: only one warp per scheduler works
// on a softmax at a time, so latency, not throughput, bounds a long chain.
template <bool kMask, int KV>
__device__ __forceinline__ void softmax_tile(float (&s)[KV / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2], int row,
                                             int k0, int tq, int Skv, int causal,
                                             int q_offset, float scale_log2) {
  float pm[2][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) pm[0][c] = m[0], pm[1][c] = m[1];
#pragma unroll
  for (int n = 0; n < KV / 8; ++n) {
    if (kMask) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row + (e >> 1) * 8;
        const int c = k0 + n * 8 + 2 * tq + (e & 1);
        if (c >= Skv || (causal && c > r + q_offset)) s[4 * n + e] = kNegInf;
      }
    }
    pm[0][n % 4] = fmaxf(pm[0][n % 4], fmaxf(s[4 * n], s[4 * n + 1]));
    pm[1][n % 4] = fmaxf(pm[1][n % 4], fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
  float neg_ms[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = fmaxf(fmaxf(pm[i][0], pm[i][1]), fmaxf(pm[i][2], pm[i][3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[i] = ex2((m[i] - mx) * scale_log2);
    m[i] = mx;
    neg_ms[i] = -mx * scale_log2;
  }
  float ps[2][4] = {};
#pragma unroll
  for (int n = 0; n < KV / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * n + e] = ex2(fmaf(s[4 * n + e], scale_log2, neg_ms[e >> 1]));
      ps[e >> 1][n % 4] += s[4 * n + e];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float rs = (ps[i][0] + ps[i][1]) + (ps[i][2] + ps[i][3]);
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l[i] = l[i] * alpha[i] + rs;
  }
}

// S = Q K_j^T for one consumer warpgroup (its 64 rows start at row `wrow`
// of the Q tile): D / 16 k-steps of 16 columns (32 bytes), both operands
// K-major.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s_acc)[kBlockKV<D> / 2], uint32_t sQ,
                                         int wrow, uint32_t sK) {
  using T = WgmmaTiles<D>;
  if (kProbe & 2) return wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bool tail = kk >= 4 * T::kMain;
    const int x = tail ? T::kMain : kk / 4;
    const int pitch = tail ? T::kTailPitch : 128;
    const uint32_t col = (tail ? kk - 4 * T::kMain : kk % 4) * 32;
    wgmma_ss<T::kKV>(
        s_acc, smem_desc(sQ + x * kBlockQ * 128 + wrow * pitch + col, 16, pitch),
        smem_desc(sK + x * T::kKV * 128 + col, 16, pitch), kk > 0);
  }
  wgmma_commit();
}

// O += P V_j: 16 kv rows a k-step, one product of N = D each; V is
// MN-major, in 64-column boxes (the leading byte offset steps to the next).
template <int D>
__device__ __forceinline__ void issue_pv(float (&o_acc)[D / 2],
                                         const uint32_t (&p)[kBlockKV<D> / 16][4],
                                         uint32_t sV) {
  constexpr int kKV = kBlockKV<D>;
  if (kProbe & 2) return wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < kKV / 16; ++kk)
    wgmma_rs<D>(o_acc, p[kk], smem_desc(sV + kk * 16 * 128, kKV * 128, 128));
  wgmma_commit();
}

// The softmax of a tile, masked only where the tile crosses the causal
// diagonal of this warpgroup's rows (first row wq0, at position
// wq0 + q_offset) or Skv's edge.
template <int KV>
__device__ __forceinline__ void softmax(float (&s)[KV / 2], float (&m)[2], float (&l)[2],
                                        float (&alpha)[2], int row, int wq0, int k0, int tq,
                                        int Skv, int causal, int q_offset, float scale_log2) {
  if (kProbe & 1) {
    alpha[0] = alpha[1] = 1.f;
    return;
  }
  if (k0 + KV > Skv || (causal && k0 + KV - 1 > wq0 + q_offset))
    softmax_tile<true, KV>(s, m, l, alpha, row, k0, tq, Skv, causal, q_offset, scale_log2);
  else
    softmax_tile<false, KV>(s, m, l, alpha, row, k0, tq, Skv, causal, q_offset, scale_log2);
}

// O *= alpha, row by row: the m64nN accumulator holds rows row and row + 8
// in o[4 i + {0, 1}] and o[4 i + {2, 3}].
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    o[4 * i + 0] *= alpha[0];
    o[4 * i + 1] *= alpha[0];
    o[4 * i + 2] *= alpha[1];
    o[4 * i + 3] *= alpha[1];
  }
}

// P as the A operand of P V: the S accumulator of n8 blocks 2 kk and
// 2 kk + 1 is the m16n8k16 A fragment of k-step kk, rounded to bf16 pairs.
template <int KV>
__device__ __forceinline__ void pack_p(uint32_t (&p)[KV / 16][4], const float (&s)[KV / 2]) {
#pragma unroll
  for (int kk = 0; kk < KV / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

#if FLASH_PROBE & 4
__device__ long long flash_probe_trace[kConsumers][40][8];
#endif

// Probe switch 4: stamp step k of kv tile j of block 0's first item.
__device__ __forceinline__ void probe_stamp(int wg, int tid, int i, int j, int k) {
#if FLASH_PROBE & 4
  if (blockIdx.x == 0 && tid == 0 && i == 0 && j < 40) flash_probe_trace[wg][j][k] = clock64();
#endif
}

// Work items: a q tile of kBlockQ rows of one head and batch row. A block
// takes one item of each round of gridDim.x (G) items, in one of two
// orders (kBal), an instance each, which the launcher picks:
//   - head-major: q tile fastest (longest causal tile first), then head,
//     then batch row, and block b takes item b of each round, so that the
//     blocks at work at one time share the K and V of a few heads in L2;
//   - balanced: q tile slowest (every item of the longest tile first, over
//     all heads and batch rows), and block b takes item b of the even
//     rounds and G - 1 - b of the odd ones (a snake), so that a block that
//     took a long item takes a short one next. The busiest SM then gets
//     the mean number of kv tiles (1.000 and 1.004 times it at gemma-2b's
//     and deepseek-v2-lite's shapes, B 1, where head-major gives 1.875 and
//     1.615), but the blocks at work at one time read every head's K and V.
// So the launcher takes the balanced order when the K and V the items read
// fit in L2, head-major when they do not (see launch_wgmma).
struct WorkItem {
  int q0, h, b, n_kv;
};

// The item of round r of this block, or -1 past the last (every later
// round's is past it too).
__device__ __forceinline__ int block_item(int r, int n_items, int balanced) {
  const int G = gridDim.x, b = blockIdx.x;
  const int w = r * G + (balanced && (r & 1) ? G - 1 - b : b);
  return w < n_items ? w : -1;
}

template <int D>
__device__ __forceinline__ WorkItem work_item(int w, int n_qt, int H, int B, int Sq,
                                              int Skv, int causal, int q_offset,
                                              int balanced) {
  constexpr int kKV = kBlockKV<D>;
  WorkItem it;
  const int hb = balanced ? w % (H * B) : w / n_qt;  // head + H x batch row
  it.q0 = (n_qt - 1 - (balanced ? w / (H * B) : w % n_qt)) * kBlockQ;
  it.h = hb % H;
  it.b = hb / H;
  it.n_kv = (Skv + kKV - 1) / kKV;
  // causal: no kv tile starts past the item's last query position; n_kv
  // stays non-increasing in the order the items are taken (q0 falling), so
  // the balanced order still takes the longest first
  if (causal)
    it.n_kv = min(it.n_kv, (min(it.q0 + kBlockQ, Sq) - 1 + q_offset) / kKV + 1);
  return it;
}

// A persistent grid: each block walks its items, one a round. The K/V ring
// and its phases run on across items, so the producer loads the next
// item's Q and first tiles while the consumers finish this one.
template <int D, bool kBal>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_q_tail,
                       const __grid_constant__ CUtensorMap tm_k_tail, bf16* __restrict__ o,
                       int B, int Sq, int Skv, int H, int KVH, int causal, int q_offset,
                       float scale_log2) {
  constexpr int balanced = kBal;
  using T = WgmmaTiles<D>;
  constexpr int kStages = T::kStages;
  constexpr int kKV = T::kKV;
  extern __shared__ unsigned char wg_smem[];
  const uint32_t sQ = (smem_addr(wg_smem) + 1023u) & ~1023u;
  const uint32_t sK = sQ + T::kQBytes;               // stage s at + s * kKBytes
  const uint32_t sV = sK + kStages * T::kKBytes;     // stage s at + s * kVBytes
  const uint32_t bars = sV + kStages * T::kVBytes;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int s) { return bars + 8u * (2 + s); };
  auto v_full = [&](int s) { return bars + 8u * (2 + kStages + s); };
  auto k_empty = [&](int s) { return bars + 8u * (2 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8u * (2 + 3 * kStages + s); };
  const int n_qt = (Sq + kBlockQ - 1) / kBlockQ;
  const int n_items = n_qt * H * B;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers * kWgThreads);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kConsumers * kWgThreads);
      mbar_init(v_empty(s), kConsumers * kWgThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == kConsumers) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * kWgThreads) {
      int t = 0;  // kv tiles loaded so far, over all items
      for (int i = 0, w = block_item(0, n_items, balanced); w >= 0;
           w = block_item(++i, n_items, balanced)) {
        const WorkItem it = work_item<D>(w, n_qt, H, B, Sq, Skv, causal, q_offset, balanced);
        const int kvh = it.h / (H / KVH);
        // every box of a tile, main boxes first: tile rows r0.., `rows` of them
        auto load_tile = [&](uint32_t dst, const CUtensorMap* main_map,
                             const CUtensorMap* tail_map, uint32_t bar, int head, int r0,
                             int rows) {
#pragma unroll
          for (int x = 0; x < T::kMain; ++x)
            tma_load_4d(dst + x * rows * 128, main_map, bar, x * kBoxCols, head, r0, it.b);
          if (T::kTail > 0)
            tma_load_4d(dst + T::kMain * rows * 128, tail_map, bar, T::kMain * kBoxCols, head,
                        r0, it.b);
        };
        if (i > 0) mbar_wait(q_empty, (i - 1) & 1);
        mbar_expect_tx(q_full, T::kQBytes);
        load_tile(sQ, &tm_q, &tm_q_tail, q_full, it.h, it.q0, kBlockQ);
        for (int j = 0; j < it.n_kv; ++j, ++t) {
          const int s = t % kStages;
          const uint32_t parity = ((t / kStages) & 1) ^ 1;  // of the consumers' last release
          if (t >= kStages) mbar_wait(k_empty(s), parity);
          mbar_expect_tx(k_full(s), T::kKBytes);
          load_tile(sK + s * T::kKBytes, &tm_k, &tm_k_tail, k_full(s), kvh, j * kKV, kKV);
          if (t >= kStages) mbar_wait(v_empty(s), parity);
          constexpr int kVLoaded = kProbe & 16 ? 1 : T::kVBoxes;
          mbar_expect_tx(v_full(s), kVLoaded * kKV * 128);
#pragma unroll
          for (int x = 0; x < kVLoaded; ++x)
            tma_load_4d(sV + s * T::kVBytes + x * kKV * 128, &tm_v, v_full(s), x * kBoxCols,
                        kvh, j * kKV, it.b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % kWgThreads;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;

    float s_acc[kKV / 2];
    float o_acc[D / 2];
    uint32_t p[kKV / 16][4];
#pragma unroll
    for (int i = 0; i < kKV / 2; ++i) s_acc[i] = 0.f;

    // ping-pong: the two consumers take turns on the tensor cores, each
    // issuing its products once the other has issued; consumer 1 lets
    // consumer 0 go first
    static_assert(kConsumers == 2, "the ping-pong pairs two consumers");
    const int my_turn = kSchedBarrier + wg, next_turn = kSchedBarrier + (wg ^ 1);
    constexpr int kPair = 2 * kWgThreads;
    if (wg == 1) named_arrive(kSchedBarrier, kPair);

    int t = 0;  // kv tiles consumed so far, over all items
    for (int i = 0, w = block_item(0, n_items, balanced); w >= 0;
         w = block_item(++i, n_items, balanced)) {
      const WorkItem it = work_item<D>(w, n_qt, H, B, Sq, Skv, causal, q_offset, balanced);
      const int wq0 = it.q0 + wg * kWgRows;          // this warpgroup's first row
      const int row = wq0 + warp * 16 + g;           // this thread's rows: row, row + 8
#pragma unroll
      for (int c = 0; c < D / 2; ++c) o_acc[c] = 0.f;
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];

      mbar_wait(q_full, i & 1);
      // tile 0: S = Q K_0^T
      mbar_wait(k_full(t % kStages), (t / kStages) & 1);
      named_sync(my_turn, kPair);
      fence_regs(s_acc);
      wgmma_fence();
      issue_qk<D>(s_acc, sQ, wg * kWgRows, sK + (t % kStages) * T::kKBytes);
      named_arrive(next_turn, kPair);
      wgmma_wait<0>();
      fence_regs(s_acc);
      mbar_arrive(k_empty(t % kStages));
      if (it.n_kv == 1) mbar_arrive(q_empty);
      softmax<kKV>(s_acc, m, l, alpha, row, wq0, 0, tq, Skv, causal, q_offset, scale_log2);
      pack_p<kKV>(p, s_acc);

      for (int j = 1; j < it.n_kv; ++j) {
        const int tj = t + j;
        const int s = tj % kStages, sp = (tj - 1) % kStages;
        probe_stamp(wg, tid, i, j, 0);
        mbar_wait(k_full(s), (tj / kStages) & 1);
        probe_stamp(wg, tid, i, j, 1);
        named_sync(my_turn, kPair);
        fence_regs(s_acc);
        probe_stamp(wg, tid, i, j, 2);
        wgmma_fence();
        issue_qk<D>(s_acc, sQ, wg * kWgRows, sK + s * T::kKBytes);  // S = Q K_j^T
        probe_stamp(wg, tid, i, j, 3);
        rescale(o_acc, alpha);           // to the maximum of tile j - 1, while S runs
        wgmma_fence();
        mbar_wait(v_full(sp), ((tj - 1) / kStages) & 1);
        probe_stamp(wg, tid, i, j, 4);
        issue_pv<D>(o_acc, p, sV + sp * T::kVBytes);  // O += P_{j-1} V_{j-1}
        named_arrive(next_turn, kPair);
        wgmma_wait<1>();                 // S has landed
        fence_regs(s_acc);
        probe_stamp(wg, tid, i, j, 5);
        mbar_arrive(k_empty(s));
        if (j == it.n_kv - 1) mbar_arrive(q_empty);  // Q is read for the last time
        softmax<kKV>(s_acc, m, l, alpha, row, wq0, j * kKV, tq, Skv, causal, q_offset,
                    scale_log2);
        probe_stamp(wg, tid, i, j, 6);
        wgmma_wait<0>();                 // P_{j-1} V_{j-1} has landed
        fence_regs(o_acc);
        probe_stamp(wg, tid, i, j, 7);
        mbar_arrive(v_empty(sp));
        pack_p<kKV>(p, s_acc);
      }

      // the last tile's O += P V; consumer 1 gives no turn after its last
      // issue of the last item, so both named barriers end balanced
      t += it.n_kv;
      const int sl = (t - 1) % kStages;
      mbar_wait(v_full(sl), ((t - 1) / kStages) & 1);
      named_sync(my_turn, kPair);
      rescale(o_acc, alpha);
      fence_regs(o_acc);
      wgmma_fence();
      issue_pv<D>(o_acc, p, sV + sl * T::kVBytes);
      if (wg == 0 || block_item(i + 1, n_items, balanced) >= 0) named_arrive(next_turn, kPair);
      wgmma_wait<0>();
      fence_regs(o_acc);
      mbar_arrive(v_empty(sl));

      const float inv0 = 1.f / fmaxf(l[0], 1e-30f), inv1 = 1.f / fmaxf(l[1], 1e-30f);
      const long long q_stride = static_cast<long long>(H) * D;
      bf16* ob = o + static_cast<long long>(it.b) * Sq * q_stride +
                 static_cast<long long>(it.h) * D;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const int col = c * 8 + 2 * tq;
        if (row < Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + row * q_stride + col) =
              __floats2bfloat162_rn(o_acc[4 * c + 0] * inv0, o_acc[4 * c + 1] * inv0);
        if (row + 8 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + (row + 8) * q_stride + col) =
              __floats2bfloat162_rn(o_acc[4 * c + 2] * inv1, o_acc[4 * c + 3] * inv1);
      }
    }
  }
}

// --- the mma.sync kernel (bf16, D 144-256; no route) -------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Skv, int H,
                 int KVH, int causal, int q_offset, float scale_log2) {
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
  // causal: no kv tile starts past the block's last query position
  if (causal) n_kv = min(n_kv, (min(q0 + kTile, Sq) - 1 + q_offset) / kTile + 1);

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
        const bool masked = c >= Skv || (causal && c > r + q_offset);
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

// --- the f32 kernel ------------------------------------------------------------

constexpr int kF32Keys = 32;  // kv rows per tile of the f32 kernel

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int Sq, int Skv, int H,
                     int KVH, int causal, int q_offset, float scale) {
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
  if (causal) n_kv = min(n_kv, (min(q0 + kTile, Sq) - 1 + q_offset) / kF32Keys + 1);

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
        if (key >= Skv || (causal && key > r + q_offset)) s[i][c] = kNegInf;
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so
// that the library is not linked against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a contiguous bf16 (batch, seq, heads, D) tensor, innermost
// first, cut into boxes of 64 columns x `rows` rows of one head and batch
// row, 128-byte swizzled. Out-of-bounds elements read as zero.
bool encode_4d(EncodeTiled encode, CUtensorMap* map, const void* ptr, int batch, int seq,
               int heads, int D, int rows, int pitch) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(D) * sizeof(bf16);
  const cuuint64_t strides[3] = {row_bytes, row_bytes * heads, row_bytes * heads * seq};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(pitch / sizeof(bf16)), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const CUtensorMapSwizzle swizzle = pitch == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : pitch == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
                 int H, int KVH, int causal, int q_offset, float scale,
                 cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // maps of the 64-column boxes of q, k and v, and of the tail boxes of q
  // and k (a kernel without a tail never reads those)
  using T = WgmmaTiles<D>;
  const int tail_pitch = T::kTail > 0 ? T::kTailPitch : 128;
  CUtensorMap tm[5];
  const void* ptr[3] = {q, k, v};
  const int seq[3] = {Sq, Skv, Skv}, heads[3] = {H, KVH, KVH};
  const int rows[3] = {kBlockQ, T::kKV, T::kKV};
  for (int i = 0; i < 3; ++i)
    if (!encode_4d(encode, &tm[i], ptr[i], B, seq[i], heads[i], D, rows[i], 128) ||
        (i < 2 &&
         !encode_4d(encode, &tm[3 + i], ptr[i], B, seq[i], heads[i], D, rows[i], tail_pitch)))
      return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = WgmmaTiles<D>::kSmem;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // the item order (work_item), an instance each: balanced when the K and
  // V that the items read fit in L2, head-major when they do not. Without
  // the causal mask an item reads all of its head's; under it, query row i
  // reads min(i + 1 + q_offset, Skv) keys, at most min(q_offset + Sq / 2,
  // Skv) on average over the rows (half of them at q_offset 0, Sq = Skv)
  int l2 = 0;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, device);
  if (e != cudaSuccess) return e;
  const long long kv_bytes = 2LL * B * KVH * Skv * D * static_cast<long long>(sizeof(bf16));
  const long long half_rows = q_offset + Sq / 2LL;
  const long long keys_read = causal && half_rows < Skv ? half_rows : Skv;
  const long long read = Skv > 0 ? kv_bytes / Skv * keys_read : 0;
  const int balanced = (read <= l2) != bool(kProbe & 32);
  auto kern = balanced ? flash_fwd_wgmma_kernel<D, true> : flash_fwd_wgmma_kernel<D, false>;
  const cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>((Sq + kBlockQ - 1) / kBlockQ) * H * B;
  if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(items < sms ? items : sms);  // one block per SM
  const float scale_log2 = scale * 1.4426950408889634f;  // log2(e)
  kern<<<grid, kWgmmaThreads, smem, stream>>>(
      tm[0], tm[1], tm[2], tm[3], tm[4], static_cast<bf16*>(o), B, Sq, Skv, H, KVH,
      causal, q_offset, scale_log2);
  return cudaGetLastError();
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
               int H, int KVH, int causal, int q_offset, float scale,
               cudaStream_t stream) {
  const size_t smem = 3 * kTile * (D + 8) * sizeof(bf16);
  const cudaError_t err = allow_smem(flash_fwd_mma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kTile - 1) / kTile, H, B);
  const float scale_log2 = scale * 1.4426950408889634f;  // log2(e)
  flash_fwd_mma_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Sq, Skv, H, KVH, causal, q_offset, scale_log2);
  return cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
               int H, int KVH, int causal, int q_offset, float scale,
               cudaStream_t stream) {
  const size_t smem = ((kTile + 2 * kF32Keys) * (D + 1) + kTile * (kF32Keys + 1)) * sizeof(float);
  const cudaError_t err = allow_smem(flash_fwd_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kTile - 1) / kTile, H, B);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Sq, Skv, H, KVH, causal, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// Every launcher: q (B, Sq, H, D), k and v (B, Skv, KVH, D), o (B, Sq, H, D),
// all contiguous and of the launcher's dtype; H a multiple of KVH; q_offset
// >= 0 with Sq + q_offset < 2^31 (the position of q's row 0 under the causal
// mask); scale 1/sqrt(D). A head dim the launcher has no instance for
// returns cudaErrorInvalidValue.
#define FLASH_CASE(launcher, d) \
  case d:                       \
    return launcher<d>(q, k, v, o, B, Sq, Skv, H, KVH, causal, q_offset, scale, stream);

// bf16, D a multiple of 16 in [16, 256]; q, k, v 16-byte aligned (TMA).
extern "C" int flash_attention_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                                         int B, int Sq, int Skv, int H, int KVH, int D,
                                         int causal, int q_offset, float scale,
                                         cudaStream_t stream) {
  switch (D) {
    FLASH_CASE(launch_wgmma, 16) FLASH_CASE(launch_wgmma, 32) FLASH_CASE(launch_wgmma, 48)
    FLASH_CASE(launch_wgmma, 64) FLASH_CASE(launch_wgmma, 80) FLASH_CASE(launch_wgmma, 96)
    FLASH_CASE(launch_wgmma, 112) FLASH_CASE(launch_wgmma, 128)
    FLASH_CASE(launch_wgmma, 144) FLASH_CASE(launch_wgmma, 160) FLASH_CASE(launch_wgmma, 176)
    FLASH_CASE(launch_wgmma, 192) FLASH_CASE(launch_wgmma, 208) FLASH_CASE(launch_wgmma, 224)
    FLASH_CASE(launch_wgmma, 240) FLASH_CASE(launch_wgmma, 256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16, D a multiple of 16 in [144, 256]; no route takes it.
extern "C" int flash_attention_fwd_mma(const void* q, const void* k, const void* v, void* o,
                                       int B, int Sq, int Skv, int H, int KVH, int D, int causal,
                                       int q_offset, float scale, cudaStream_t stream) {
  switch (D) {
    FLASH_CASE(launch_mma, 144) FLASH_CASE(launch_mma, 160) FLASH_CASE(launch_mma, 176)
    FLASH_CASE(launch_mma, 192) FLASH_CASE(launch_mma, 208) FLASH_CASE(launch_mma, 224)
    FLASH_CASE(launch_mma, 240) FLASH_CASE(launch_mma, 256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// f32, D a multiple of 16 in [16, 256].
extern "C" int flash_attention_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                       int B, int Sq, int Skv, int H, int KVH, int D, int causal,
                                       int q_offset, float scale, cudaStream_t stream) {
  switch (D) {
    FLASH_CASE(launch_f32, 16) FLASH_CASE(launch_f32, 32) FLASH_CASE(launch_f32, 48)
    FLASH_CASE(launch_f32, 64) FLASH_CASE(launch_f32, 80) FLASH_CASE(launch_f32, 96)
    FLASH_CASE(launch_f32, 112) FLASH_CASE(launch_f32, 128) FLASH_CASE(launch_f32, 144)
    FLASH_CASE(launch_f32, 160) FLASH_CASE(launch_f32, 176) FLASH_CASE(launch_f32, 192)
    FLASH_CASE(launch_f32, 208) FLASH_CASE(launch_f32, 224) FLASH_CASE(launch_f32, 240)
    FLASH_CASE(launch_f32, 256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

#undef FLASH_CASE

#if FLASH_PROBE & 4
// Probe switch 4: copy the clock stamps to `out` (2 x 40 x 8 long longs).
extern "C" int flash_probe_trace_read(long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, flash_probe_trace, sizeof(flash_probe_trace)));
}
#endif
