// Hopper building blocks for hand-written kernels (sm_90a): mbarriers, TMA
// loads (16-bit and fp32 tiles) and the host-side tensor maps they read,
// wgmma shared-memory descriptors and the wgmma shapes the flash-attention
// kernels issue, and the 3xTF32 pieces (operand splits, tf32 wgmma and
// mma.sync, fragment reads) of the fp32 forward and backward kernels. Every
// source built by paddle_tpu_torch/ops/cuda/_build.py hashes this header into
// its library name, so an edit here rebuilds them all.
#pragma once

#include <cuda.h>  // CUtensorMap (the type only; the .so links no driver library)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// --- mbarrier ---------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

// make the initialised barriers visible to the async proxy (TMA) and to the
// other threads (after the caller's __syncthreads)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` more of transactions (a TMA copy's)
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed. A phase that never
// completes (a pipeline fault) traps after ~2^30 tries, seconds of waiting,
// so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 30)) __trap();
  }
}

// --- TMA --------------------------------------------------------------------
// One box of a 4-d tensor map at coordinates (c0 innermost .. c3) into shared
// memory; completion (its bytes) is reported to the mbarrier `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of a 1-d tensor map starting at element c0 (zero-filled past the end).
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

// A 16-bit (rows, D) tile in shared memory is D / kCols column atoms, each
// rows x kRowBytes, swizzled as TMA writes it and wgmma reads it; atom a of a
// tile of R rows starts a * R * kRowBytes in. A head dim that is a multiple
// of 64 takes 64-column atoms (128-byte rows, 128-byte swizzle); 32 and 96
// take 32-column atoms (64-byte rows, 64-byte swizzle): D = 96 is three of
// them, so no column is left out of a copy or a descriptor.
template <int D>
struct SwizzleAtom {
  static constexpr int kCols = D % 64 == 0 ? 64 : 32;
  static constexpr int kRowBytes = kCols * 2;
  static constexpr int kAtoms = D / kCols;
  static constexpr uint32_t kSwizzle = kRowBytes == 128 ? 1 : 2;  // descriptor code
  static constexpr int kKPerAtom = kCols / 16;                    // k16 steps in an atom
  static_assert(D >= 32 && D <= 256 && D % kCols == 0,
                "the tile must be whole column atoms of 32 or 64 columns, at most 256");
};

// Rows [row0, row0 + rows) of head `head`, batch `b` of a 4-d map whose box
// is one atom of columns by `box` rows, into the tile at `dst`.
template <int D>
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map, int rows,
                                              int box, int row0, int head, int b, uint32_t bar) {
  using A = SwizzleAtom<D>;
#pragma unroll
  for (int a = 0; a < A::kAtoms; ++a)
    for (int r = 0; r < rows; r += box)
      tma_load_4d(dst + (a * rows + r) * A::kRowBytes, map, bar, a * A::kCols, row0 + r, head, b);
}

// A float32 (rows, D) tile in shared memory is D / 32 column atoms, each rows
// x 128 bytes with TMA's 128-byte swizzle (16-byte chunk j of row r at chunk
// j ^ (r % 8)); atom a starts a * rows * 128 bytes in, on a 1024-byte boundary
// when the tile does. Rows [row0, row0 + rows) of head `head`, batch `b` of a
// map from encode_map_f32_tile, in boxes of `box` rows.
template <int D>
__device__ __forceinline__ void tma_load_f32(uint32_t dst, const CUtensorMap* map, int rows,
                                             int box, int row0, int head, int b, uint32_t bar) {
  static_assert(D % 32 == 0, "fp32 tiles are whole 32-column atoms");
#pragma unroll
  for (int a = 0; a < D / 32; ++a)
    for (int r = 0; r < rows; r += box)
      tma_load_4d(dst + (a * rows + r) * 128, map, bar, a * 32, row0 + r, head, b);
}

// --- wgmma ------------------------------------------------------------------
// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle (1 = 128 B, 2 = 64 B). Tiles start
// on a multiple of the swizzle pattern (1024 or 512 bytes): base offset 0.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                               uint32_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)swizzle << 62);
}

// K-major operand (rows of the tile, D contiguous) of k16 step kk: rows
// [row0, row0 + 8 n) of a tile of R rows
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int R, int row0, int kk) {
  using A = SwizzleAtom<D>;
  return wgmma_desc(tile + ((kk / A::kKPerAtom) * R + row0) * A::kRowBytes +
                        (kk % A::kKPerAtom) * 32,
                    16, 8 * A::kRowBytes, A::kSwizzle);
}

// MN-major B operand (D contiguous, the transpose bit): rows 16 kc .. 16 kc
// + 15 of a tile of R rows are the k16 step; D atoms are R rows apart
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int R, int kc) {
  using A = SwizzleAtom<D>;
  return wgmma_desc(tile + kc * 16 * A::kRowBytes, R * A::kRowBytes, 8 * A::kRowBytes,
                    A::kSwizzle);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// D (m64 x N, fp32) (+)= A (m64 x k16) B (k16 x N), both from shared memory,
// both K-major; scale_d = 0 overwrites D.
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);

// D (m64 x N, fp32) += A (m64 x k16, registers) B (k16 x N, shared memory,
// N contiguous: the descriptor's transpose bit).
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db);

// The accumulator registers of m64nN (N / 2 a thread) as asm operands
#define PT_WG_D8(d, i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),            \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define PT_WG_D16(d) PT_WG_D8(d, 0), PT_WG_D8(d, 8)
#define PT_WG_D32(d) PT_WG_D16(d), PT_WG_D8(d, 16), PT_WG_D8(d, 24)
#define PT_WG_D64(d) PT_WG_D32(d), PT_WG_D8(d, 32), PT_WG_D8(d, 40), PT_WG_D8(d, 48), \
                     PT_WG_D8(d, 56)
#define PT_WG_D48(d) PT_WG_D32(d), PT_WG_D8(d, 32), PT_WG_D8(d, 40)
#define PT_WG_D128(d) PT_WG_D64(d), PT_WG_D8(d, 64), PT_WG_D8(d, 72), PT_WG_D8(d, 80),   \
                      PT_WG_D8(d, 88), PT_WG_D8(d, 96), PT_WG_D8(d, 104), PT_WG_D8(d, 112), \
                      PT_WG_D8(d, 120)
#define PT_WG_R16 "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" "}"
#define PT_WG_R32                                                                         \
  "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "             \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" "}"
#define PT_WG_R64                                                                         \
  "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "             \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "       \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "       \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" "}"

#define PT_WG_R48                                                                         \
  "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                                \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "                          \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "                          \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47" "}"
#define PT_WG_R128                                                                        \
  "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                                \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "                          \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "                          \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                          \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "                          \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "                          \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "                          \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "                          \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "                  \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "              \
  "%120, %121, %122, %123, %124, %125, %126, %127" "}"

// One specialisation of each for a type and width. REGS/OUTS are the
// accumulator list and operands; the other operands follow them, numbered
// from R = N / 2: ss takes (desc A, desc B, scale_d) as %R .. %R+2, rs takes
// (a0..a3, desc B, 1) as %R .. %R+5.
#define PT_WGMMA(TYPE, PTX, N, REGS, OUTS, SS_ARGS, SS_SCALE, RS_ARGS, RS_SCALE)          \
  template <>                                                                           \
  __device__ __forceinline__ void wgmma_ss<TYPE, N>(float (&d)[N / 2], uint64_t da,      \
                                                    uint64_t db, int scale_d) {         \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SS_SCALE ", 0;\n"                   \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." PTX "." PTX " " REGS  \
                 ", " SS_ARGS ", p, 1, 1, 0, 0;\n}\n"                                   \
                 : OUTS : "l"(da), "l"(db), "r"(scale_d));                              \
  }                                                                                     \
  template <>                                                                           \
  __device__ __forceinline__ void wgmma_rs<TYPE, N>(float (&d)[N / 2],                   \
                                                    const uint32_t (&a)[4], uint64_t db) { \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " RS_SCALE ", 0;\n"                   \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." PTX "." PTX " " REGS  \
                 ", " RS_ARGS ", p, 1, 1, 1;\n}\n"                                      \
                 : OUTS                                                                 \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));        \
  }

#define PT_WGMMA_TYPE(TYPE, PTX)                                                          \
  PT_WGMMA(TYPE, PTX, 256, PT_WG_R128, PT_WG_D128(d), "%128, %129", "%130",               \
           "{%128, %129, %130, %131}, %132", "%133")                                    \
  PT_WGMMA(TYPE, PTX, 128, PT_WG_R64, PT_WG_D64(d), "%64, %65", "%66",                   \
           "{%64, %65, %66, %67}, %68", "%69")                                          \
  PT_WGMMA(TYPE, PTX, 96, PT_WG_R48, PT_WG_D48(d), "%48, %49", "%50",                    \
           "{%48, %49, %50, %51}, %52", "%53")                                          \
  PT_WGMMA(TYPE, PTX, 64, PT_WG_R32, PT_WG_D32(d), "%32, %33", "%34",                    \
           "{%32, %33, %34, %35}, %36", "%37")                                          \
  PT_WGMMA(TYPE, PTX, 32, PT_WG_R16, PT_WG_D16(d), "%16, %17", "%18",                    \
           "{%16, %17, %18, %19}, %20", "%21")

PT_WGMMA_TYPE(__nv_bfloat16, "bf16")
PT_WGMMA_TYPE(__half, "f16")

// tf32 wgmma, A from registers (the m16n8k8 A fragment of each warp's 16
// rows), B from shared memory K-major: d (m64 x N) (+)= a b; scale_d = 0
// overwrites d. The tensor cores read B's fp32 words as tf32 by truncation.
#define PT_WG_R8 "{" "%0, %1, %2, %3, %4, %5, %6, %7" "}"
#define PT_WGMMA_TF32(N, REGS, OUTS, ARGS, SCALE)                                          \
  __device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],    \
                                             uint64_t db, int scale_d) {                   \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE ", 0;\n"                        \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 " REGS ", " ARGS \
                 ", p, 1, 1;\n}\n"                                                         \
                 : OUTS : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)); \
  }
PT_WGMMA_TF32(256, PT_WG_R128, PT_WG_D128(d), "{%128, %129, %130, %131}, %132", "%133")
PT_WGMMA_TF32(128, PT_WG_R64, PT_WG_D64(d), "{%64, %65, %66, %67}, %68", "%69")
PT_WGMMA_TF32(96, PT_WG_R48, PT_WG_D48(d), "{%48, %49, %50, %51}, %52", "%53")
PT_WGMMA_TF32(64, PT_WG_R32, PT_WG_D32(d), "{%32, %33, %34, %35}, %36", "%37")
PT_WGMMA_TF32(32, PT_WG_R16, PT_WG_D16(d), "{%16, %17, %18, %19}, %20", "%21")
PT_WGMMA_TF32(16, PT_WG_R8, PT_WG_D8(d, 0), "{%8, %9, %10, %11}, %12", "%13")

#undef PT_WGMMA_TF32
#undef PT_WG_R8
#undef PT_WGMMA_TYPE
#undef PT_WGMMA
#undef PT_WG_R128
#undef PT_WG_R64
#undef PT_WG_R48
#undef PT_WG_R32
#undef PT_WG_R16
#undef PT_WG_D128
#undef PT_WG_D64
#undef PT_WG_D48
#undef PT_WG_D32
#undef PT_WG_D16
#undef PT_WG_D8

// --- 3xTF32: fp32 products on the tf32 tensor cores -----------------------------
// An A operand x (registers) is split into hi = tf32(x), rounded to nearest
// with ties away (cvt.rna), and lo = x - hi, exact in fp32; a B operand
// (shared memory) into hi = trunc(x), the fp32 word itself, and lo = x -
// trunc(x), its lo plane. The tensor cores read every operand word's top 19
// bits (tf32 by truncation). A product accumulates a_hi b_lo + a_lo b_hi +
// a_hi b_hi in fp32, the small terms first (CUTLASS's OpMultiplyAddFastF32);
// a_lo b_lo, ~2^-21 of the product, is dropped.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));  // the tensor cores read its top 19 bits
}

// the tf32 the tensor cores read of x: its top 19 bits
__device__ __forceinline__ float tf32_trunc(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// c (m16 x n8, fp32) += a (m16 x k8, tf32) b (k8 x n8, tf32)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment split once and used against several B fragments
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void split(float x0, float x1, float x2, float x3) {
    split_tf32(x0, hi[0], lo[0]);
    split_tf32(x1, hi[1], lo[1]);
    split_tf32(x2, hi[2], lo[2]);
    split_tf32(x3, hi[3], lo[3]);
  }
};

// Keep an A fragment in its registers across an asynchronous wgmma that reads
// it (the compiler takes an asm input as read at issue).
__device__ __forceinline__ void fence_frag(FragA& a) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a.hi[i]), "+r"(a.lo[i]) :: "memory");
}

// c += a b in 3xTF32 (mma.sync): b's two elements as fp32 words of a tile in
// shared memory, h0, h1 (the tensor cores read them truncated to tf32), and of
// its lo plane, l0, l1 (x - trunc(x))
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, float h0, float h1,
                                     float l0, float l1) {
  mma_tf32(c, a.hi, __float_as_uint(l0), __float_as_uint(l1));
  mma_tf32(c, a.lo, __float_as_uint(h0), __float_as_uint(h1));
  mma_tf32(c, a.hi, __float_as_uint(h0), __float_as_uint(h1));
}

// An fp32 (R, D) tile as TMA writes it with the 128-byte swizzle: D / 32
// column atoms of R rows x 128 bytes, atom a at a R 128 bytes; the 16-byte
// chunk j of row r lies at chunk j ^ (r % 8). Float offset of (r, c):
template <int R>
__device__ __forceinline__ int sw(int r, int c) {
  return ((c >> 5) * R + r) * 32 + ((c & 31) ^ ((r & 7) << 2));
}
// Fragment reads, lane = 4 g + t: an A fragment whose contraction dim is the
// tile's columns (K-major) is one ldmatrix of 8 x 16-byte matrices, whose 8
// rows (r % 8 = 0..7) sit in 8 different chunks: one pass over the banks. A B
// fragment whose contraction dim is the tile's rows (MN-major: dQ = dS K,
// dV = P^T dO, dK = dS^T Q) reads rows 8 k + 2 t, 8 k + 2 t + 1 and column
// 8 n + g: word g ^ 4 (2 t + {0, 1}) of chunk group n, 32 banks. Those rows
// are the contraction order that makes an m16n8 (or wgmma m64) accumulator,
// columns 2 t, 2 t + 1 of each n8 group, the A fragment of the next product
// as it lies (a0..a3 = c0, c2, c1, c3), so P and dS never leave registers.

// ldmatrix of four 8 x 16-byte matrices: lane l gives the address of row
// l % 8 of matrix l / 8 and gets word l % 4 of row l / 4 of each, which for
// fp32 is a0 of an m16n8k8 (or wgmma m64k8) A fragment: rows 8 i + g,
// column t
__device__ __forceinline__ void ldsm4(uint32_t addr, float (&x)[4]) {
  uint32_t r0, r1, r2, r3;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
  x[0] = __uint_as_float(r0);
  x[1] = __uint_as_float(r1);
  x[2] = __uint_as_float(r2);
  x[3] = __uint_as_float(r3);
}

// The A fragment of rows [r0, r0 + 16) and columns [c0, c0 + 8) of an (R, D)
// tile at shared address `tile` (K-major): matrices (rows +0, cols +0),
// (+8, +0), (+0, +4), (+8, +4) are a0..a3
template <int R>
__device__ __forceinline__ void load_a(FragA& a, uint32_t tile, int r0, int c0, int lane) {
  float x[4];
  ldsm4(tile + 4 * sw<R>(r0 + lane % 8 + 8 * ((lane / 8) % 2), c0 + 4 * (lane / 16)), x);
  a.split(x[0], x[1], x[2], x[3]);
}

// The K-major descriptor of k8 step kk of an fp32 (R, D) tile (tma_load_f32's
// layout: 32-column atoms of R rows x 128 bytes, 128-byte swizzle)
template <int R>
__device__ __forceinline__ uint64_t f32_kmajor_desc(uint32_t tile, int kk) {
  return wgmma_desc(tile + (kk / 4) * R * 128 + (kk % 4) * 32, 16, 1024, 1);
}

// order this thread's shared-memory writes before later async-proxy (wgmma,
// TMA) reads of them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- host: tensor maps --------------------------------------------------------
// cuTensorMapEncodeTiled, reached through the runtime (no link to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult got;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &got) !=
            cudaSuccess ||
        got != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A 16-bit (B, S, H, D) tensor with element strides (sb, ss, sh) and D
// contiguous, as a 4-d map (D, S, H, B), box (one atom of columns, `rows`
// rows, 1, 1), swizzled for wgmma. Rows past S read as zeros. The caller
// guarantees a 16-byte-aligned base and strides that are multiples of 16
// bytes (the wrapper copies what is not).
template <int D>
bool encode_map(CUtensorMap* map, CUtensorMapDataType dtype, const void* ptr, int S, int H,
                int B, long long sb, long long ss, long long sh, int rows) {
  using A = SwizzleAtom<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)A::kCols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, dtype, 4, const_cast<void*>(ptr), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            A::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// A float32 (B, S, H, D) tensor with element strides (sb, ss, sh) and D
// contiguous, as a 4-d map (D, S, H, B), box (32 columns, `rows` rows, 1, 1),
// 128-byte swizzle (tma_load_f32). Rows past S read as zeros. The caller
// guarantees a 16-byte-aligned base and strides that are multiples of 16
// bytes (the wrapper copies what is not).
template <int D>
bool encode_map_f32_tile(CUtensorMap* map, const void* ptr, int S, int H, int B, long long sb,
                         long long ss, long long sh, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 4, (cuuint64_t)sh * 4, (cuuint64_t)sb * 4};
  const cuuint32_t box[4] = {32, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// n contiguous floats (16-byte-aligned base) as a 1-d map, box `box`
// elements; elements past n read as zeros.
bool encode_map_f32(CUtensorMap* map, const float* ptr, long long n, int box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {0};  // rank 1: no strides are read
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  const cuuint32_t elem_strides[1] = {1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(ptr), dims, strides,
            boxes, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace
