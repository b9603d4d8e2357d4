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
// 2^26 fp32 elements). The design keeps every SM's memory pipe full and
// nothing else: a grid-stride loop of 16-byte vector loads (4 fp32 or 8
// fp16/bf16 a thread) over x's 16-byte-aligned body, a scalar head before it
// and a scalar tail after it (x may be a view at any element offset); the
// stores are 16-byte vectors where y's matching element is aligned too, else
// scalars. 16 blocks of 256 threads an SM, twice what can be resident, so a
// block that finishes early leaves no SM idle; no committed measurement
// compares this grid, or unrolling, with the alternatives yet. Counts and
// indices are 64-bit.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 16;

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

// 16 bytes of T, loaded and stored as one vector
template <typename T>
struct alignas(16) Vec {
  static constexpr int kN = 16 / sizeof(T);
  T e[kN];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
axpy_kernel(const T* __restrict__ x, T* __restrict__ y, long long n) {
  constexpr int V = Vec<T>::kN;
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // elements before x's first 16-byte boundary (x is element-aligned)
  long long head =
      (long long)(((16 - (reinterpret_cast<uintptr_t>(x) & 15)) & 15) / sizeof(T));
  if (head > n) head = n;
  const long long nvec = (n - head) / V;
  const long long tail = head + nvec * V;
  const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x + head);
  if ((reinterpret_cast<uintptr_t>(y + head) & 15) == 0) {
    Vec<T>* yv = reinterpret_cast<Vec<T>*>(y + head);
    for (long long i = tid; i < nvec; i += stride) {
      Vec<T> v = xv[i];
#pragma unroll
      for (int j = 0; j < V; ++j) v.e[j] = axpy1(v.e[j]);
      yv[i] = v;
    }
  } else {
    for (long long i = tid; i < nvec; i += stride) {
      const Vec<T> v = xv[i];
      T* out = y + head + i * V;
#pragma unroll
      for (int j = 0; j < V; ++j) out[j] = axpy1(v.e[j]);
    }
  }
  // head and tail hold fewer than V elements each; the grid has >= 256 threads
  if (tid < head) y[tid] = axpy1(x[tid]);
  if (tid < n - tail) y[tail + tid] = axpy1(x[tail + tid]);
}

template <typename T>
cudaError_t launch(const void* x, void* y, long long n, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  constexpr int V = Vec<T>::kN;
  long long blocks = (n / V + kThreads - 1) / kThreads;
  const long long most = (long long)sms * kBlocksPerSm;
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  axpy_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n);
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
  if (dtype == 0) return (int)launch<float>(x, y, n, s);
  if (dtype == 1) return (int)launch<__half>(x, y, n, s);
  if (dtype == 2) return (int)launch<__nv_bfloat16>(x, y, n, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
