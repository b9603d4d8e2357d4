// Building blocks shared by the flash-attention kernels (forward and
// backward): tensor-core mma.sync wrappers, ldmatrix, cp.async tile loads
// and the once-per-device grant of more than 48 KB of shared memory.
// Every source that includes this header is built on its own; the build
// (paddle_tpu_torch/ops/cuda/_build.py) hashes this header into the name of
// each library, so an edit here rebuilds them all.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegBig = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses registers; with `valid` false
// it writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8. Plain: lane gets (row lane/4, cols 2*(lane%4)+{0,1})
// of each matrix; .trans: (rows 2*(lane%4)+{0,1}, col lane/4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Start copying rows [r0, r0 + ROWS) of a (rows, D) matrix with row stride
// `stride` (elements; the last dim is contiguous) into shared memory with
// row pitch LDS. Rows at or past `nrows` are zero-filled: a ragged tail must
// read as 0, never as stale data, because 0 * NaN would poison a product.
// Aligned rows go by cp.async (the caller commits and waits); others by
// plain loads and stores, visible after the caller's __syncthreads.
template <typename T, int D, int LDS, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride,
                                          int r0, int nrows, bool aligned16) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = ROWS * D / kVec;
  for (int c = threadIdx.x; c < kChunks; c += THREADS) {
    const int r = c / (D / kVec);
    const int col = (c % (D / kVec)) * kVec;
    T* d = dst + r * LDS + col;
    const int gr = r0 + r;
    const bool in = gr < nrows;
    const T* s = in ? src + (long long)gr * stride + col : src;
    if (aligned16) {
      cp_async16(d, s, in);
    } else if (in) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) d[e] = s[e];
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

constexpr int kMaxDevices = 64;

// `configured` belongs to one kernel: above 48 KB a block's shared memory must
// be granted explicitly, once per kernel and device (so never again inside a
// CUDA-graph capture).
template <typename Kernel>
cudaError_t grant_smem(Kernel kernel, bool* configured, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) configured[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace
