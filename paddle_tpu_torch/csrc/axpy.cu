// y = 2x + 1, elementwise, for Hopper (sm_90a), bound to Python through a
// plain C entry point (ctypes; see paddle_tpu_torch/ops/cuda/_build.py).
//
// Replaces: the test-only Pallas kernel `kernel` of
// tests/test_extension_points.py:57 (launched by `fwd`, :60-65), which the
// JAX package's test registers as op `test_pallas_axpy` through
// register_custom_op. Same function: o = x * 2 + 1 in x's dtype.
//
// Arithmetic: fmaf(x, 2, 1) in fp32, rounded once to the output dtype. 2x is
// exact in fp32, fp16 and bf16 (or infinite in both versions), so the result
// equals the two-step x * 2.0 + 1.0 of PyTorch and of the Pallas kernel bit
// for bit; only a NaN's payload may differ.
//
// What bounds it on an H100: each element is read once and written once for
// one fma, so it is bytes: 2 x n x itemsize over 3.35 TB/s (0.160 ms for
// 2^26 fp32 elements).
//
// Design (axpy_vectors): where x and y both start 16-byte aligned, a grid
// that covers x's whole 16-byte vectors once, in blocks of 256 threads, each
// thread U = 1 16-byte vector, loaded with ld.global.nc.L1::no_allocate (x is
// read once) and stored with st.global.cs (y is not read again here); with
// U > 1 a thread issues its U loads before any store, each of the U rounds
// one coalesced sweep of the block's span. Indices within a span are 32-bit.
// A scalar tail runs after the last whole vector. Every other pair (x a view
// at an element offset that is not a multiple of 16 bytes; the wrapper
// allocates y, so y is aligned) goes to a second kernel, axpy_elements: a
// block loads and stores 256 x U x (16 / itemsize) single elements,
// U x 16 / itemsize a thread, each round a coalesced sweep, so neither side
// needs a vector.
//
// Same-card A/B (tools/axpy_ab.py; NVIDIA H100 80GB HBM3, 700 W; device ms,
// a CUDA graph of 20 calls) at 2^26 fp32, readings in turns, three calls on
// three cards. The previous design, a grid-stride loop of one 16-byte load
// then one store a thread over 16 blocks of 256 an SM: 0.18689, 0.18689;
// 0.18979, 0.18981; 0.18976, 0.18950. This design: U = 4 0.17874, 0.17860
// and U = 8 0.17944, 0.17947 (first call, one kernel for both paths); U = 2
// 0.17944, 0.17950, U = 4 0.18197, 0.18194, U = 8 0.18142, 0.18128 (second);
// U = 1 0.17880, 0.17874, U = 2 0.17954, 0.17970, U = 4 0.18249, 0.18200
// (third). torch.add of the same function: 0.17834-0.17880, 0.17992-0.18073,
// 0.17994-0.18037. So more bytes in flight a thread did not help: a longer
// span only lengthens the grid's tail, and U = 1 moves the same 16 bytes a
// thread as the previous design, whose loss lay in its grid-stride loop over
// a fixed grid. U = 4 is faster only when x sits in L2 (2^22 fp32: 0.0063
// against 0.0077 ms). A second design, persistent blocks streaming x through
// a ring of shared-memory stages by 1-D TMA bulk copies (cp.async.bulk, 1 or
// 2 blocks an SM, 3-6 stages of 16-32 KB), computing in place and writing
// back by bulk copies, read 0.18589-0.18670 in the first call and was
// deleted: each chunk waits for a block-wide barrier between its load and
// its store, and its bytes in flight did not help either.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// tools/axpy_ab.py builds other unroll depths with -DPT_AXPY_UNROLL=...
#ifndef PT_AXPY_UNROLL
#define PT_AXPY_UNROLL 1
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = PT_AXPY_UNROLL;  // 16-byte vectors a thread (U)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ T axpy1(T x) {
  return from_float<T>(fmaf(to_float(x), 2.0f, 1.0f));
}

// y = 2x + 1 on the elements packed in one 32-bit word (one fp32, or two
// 16-bit values, low half first)
template <typename T>
__device__ __forceinline__ uint32_t axpy_word(uint32_t w);
template <>
__device__ __forceinline__ uint32_t axpy_word<float>(uint32_t w) {
  return __float_as_uint(fmaf(__uint_as_float(w), 2.0f, 1.0f));
}
template <>
__device__ __forceinline__ uint32_t axpy_word<__half>(uint32_t w) {
  const uint32_t lo = __half_as_ushort(axpy1(__ushort_as_half((unsigned short)(w & 0xFFFF))));
  const uint32_t hi = __half_as_ushort(axpy1(__ushort_as_half((unsigned short)(w >> 16))));
  return lo | (hi << 16);
}
template <>
__device__ __forceinline__ uint32_t axpy_word<__nv_bfloat16>(uint32_t w) {
  const uint32_t lo =
      __bfloat16_as_ushort(axpy1(__ushort_as_bfloat16((unsigned short)(w & 0xFFFF))));
  const uint32_t hi =
      __bfloat16_as_ushort(axpy1(__ushort_as_bfloat16((unsigned short)(w >> 16))));
  return lo | (hi << 16);
}

template <typename T>
__device__ __forceinline__ uint4 axpy_vec(uint4 v) {
  return make_uint4(axpy_word<T>(v.x), axpy_word<T>(v.y), axpy_word<T>(v.z), axpy_word<T>(v.w));
}

// scalar tail (after the last whole vector, from element `tail` on): fewer
// than 16 / sizeof(T) elements, block 0's threads
template <typename T>
__device__ __forceinline__ void scalar_tail(const T* __restrict__ x, T* __restrict__ y,
                                            long long n, long long tail) {
  if (blockIdx.x != 0) return;
  const int t = threadIdx.x;
  if (t < n - tail) y[tail + t] = axpy1(x[tail + t]);
}

__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return r;
}

__device__ __forceinline__ void st_stream(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

// x and y 16-byte aligned: block b covers vectors [b * kThreads * U, (b + 1)
// * kThreads * U); thread t takes vectors t, t + kThreads, ... of that span.
template <typename T>
__global__ void __launch_bounds__(kThreads)
axpy_vectors(const T* __restrict__ x, T* __restrict__ y, long long n, long long nvec) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kSpan = kThreads * kUnroll;
  const long long base = (long long)blockIdx.x * kSpan;
  const int count = (int)min((long long)kSpan, nvec - base);  // vectors in the span
  const uint4* xv = reinterpret_cast<const uint4*>(x) + base;
  uint4* yv = reinterpret_cast<uint4*>(y) + base;
  uint4 v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = u * kThreads + threadIdx.x;
    if (i < count) v[u] = ld_stream(xv + i);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = u * kThreads + threadIdx.x;
    if (i < count) st_stream(yv + i, axpy_vec<T>(v[u]));
  }
  scalar_tail(x, y, n, nvec * V);
}

// x or y not 16-byte aligned: block b covers elements [b * kThreads * U
// * V, (b + 1) * kThreads * U * V) of the whole range, thread t elements t, t +
// kThreads, ... A kernel of its own, so that its U * V registers of elements
// do not lower axpy_vectors' occupancy.
template <typename T>
__global__ void __launch_bounds__(kThreads)
axpy_elements(const T* __restrict__ x, T* __restrict__ y, long long n) {
  constexpr int kSpan = kThreads * kUnroll * (16 / sizeof(T));
  const long long base = (long long)blockIdx.x * kSpan;
  const int count = (int)min((long long)kSpan, n - base);  // elements in the span
  const T* xs = x + base;
  T* ys = y + base;
  T v[kSpan / kThreads];
#pragma unroll
  for (int u = 0; u < kSpan / kThreads; ++u) {
    const int i = u * kThreads + threadIdx.x;
    if (i < count) v[u] = xs[i];
  }
#pragma unroll
  for (int u = 0; u < kSpan / kThreads; ++u) {
    const int i = u * kThreads + threadIdx.x;
    if (i < count) ys[i] = axpy1(v[u]);
  }
}

template <typename T>
cudaError_t run(const void* xp, void* yp, long long n, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xp);
  T* y = static_cast<T*>(yp);
  constexpr long long V = 16 / sizeof(T);
  constexpr long long kSpan = kThreads * kUnroll;  // vectors a block
  if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0) {
    const long long nvec = n / V;
    long long blocks = (nvec + kSpan - 1) / kSpan;
    if (blocks < 1) blocks = 1;  // the tail alone
    axpy_vectors<T><<<(unsigned)blocks, kThreads, 0, stream>>>(x, y, n, nvec);
  } else {
    const long long blocks = (n + kSpan * V - 1) / (kSpan * V);
    axpy_elements<T><<<(unsigned)blocks, kThreads, 0, stream>>>(x, y, n);
  }
  return cudaGetLastError();
}

}  // namespace

// y = 2x + 1 over n contiguous elements; y must not overlap x.
// dtype: 0 = float32, 1 = float16, 2 = bfloat16.
// Returns a cudaError_t (0 on success).
extern "C" int pt_axpy(const void* x, void* y, long long n, int dtype,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (dtype == 0) return (int)run<float>(x, y, n, s);
  if (dtype == 1) return (int)run<__half>(x, y, n, s);
  if (dtype == 2) return (int)run<__nv_bfloat16>(x, y, n, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
