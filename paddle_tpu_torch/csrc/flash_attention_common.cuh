// Building blocks shared by the flash-attention kernels (forward and
// backward): constants, 16-bit packing, exp2 on the special-function unit,
// the causal key limit and the once-per-device grant of more than 48 KB of
// shared memory. Every source that includes this header is built on its own;
// the build (paddle_tpu_torch/ops/cuda/_build.py) hashes this header into the
// name of each library, so an edit here rebuilds them all.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegBig = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x on the special-function unit (flushes subnormal results to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to one 32-bit pair of T (lo in the low half), and back
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t v);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t v) {
  return __half22float2(*reinterpret_cast<__half2*>(&v));
}

// Number of keys the rows [q0, q0 + rows) can see (rows past Sq see none
// beyond the last real row's). Causal is aligned bottom-right: key t is
// visible to query s iff t <= s + (Sk - Sq).
__device__ __forceinline__ int kv_limit(int q0, int rows, int Sq, int Sk, int causal) {
  if (!causal) return Sk;
  const int last_row = min(q0 + rows, Sq) - 1;
  return min(Sk, last_row + (Sk - Sq) + 1);
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
