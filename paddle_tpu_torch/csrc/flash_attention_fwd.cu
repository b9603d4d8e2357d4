// Flash-attention forward for Hopper (sm_90a), bound to Python through a
// plain C entry point (ctypes; see paddle_tpu_torch/ops/cuda/_build.py).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py::_fwd_kernel (the
// Pallas TPU forward kernel launched by `_fwd`). Same function: online-
// softmax attention with fp32 running max / sum / accumulator, scores scaled
// in fp32, -1e30 masking, causal mask aligned bottom-right (key t is visible
// to query s iff t <= s + (Sk - Sq)), GQA kv head = h / (Hq / Hkv), and the
// per-row log-sum-exp returned beside O for a backward pass.
//
// What bounds it on an H100: per (b, head) the kernel reads q, k, v once and
// writes o and lse once, and does 4*D flops per visible (query, key) pair.
// At serving prompt lengths (S=128, D=128) that is ~2 flop per byte, far
// below the ~295 flop/byte at which bf16 tensor cores become the limit, so
// the bound is HBM bytes; at S >= ~1k causal it is tensor-core flops.
// The design answers both simply:
//   * bytes: q/k/v are read straight from the caller's (B, S, H, D) layout
//     through strides (no transposed copies), each k/v tile is staged once in
//     shared memory per 64 query rows (cp.async, double-buffered so the next
//     tile streams in under the current tile's math), and probabilities
//     never leave registers (no S x S matrix in HBM).
//   * flops: bf16/fp16 products run on tensor cores (mma.sync m16n8k16 with
//     fp32 accumulation) fed by ldmatrix; the P tile is re-packed from the
//     score registers as the A operand of P @ V without a trip through
//     shared memory; the k/v loop stops at the causal diagonal; causal q
//     tiles are issued longest first so the tail of the grid is short.
// fp32 inputs run on CUDA cores in full fp32 (no TF32), one query row per
// four threads. wgmma, TMA and warp specialisation are left for later work.
#include "flash_attention_common.cuh"

namespace {

constexpr int kBlockM = 64;  // query rows per thread block
constexpr int kBlockN = 64;  // keys per k/v tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, Hq, Sq) contiguous
  int B, Hq, Hkv, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
  int aligned16;  // every row of q/k/v starts on a 16-byte boundary
};

// Number of keys the rows [q0, q0 + kBlockM) can see.
__device__ __forceinline__ int kv_limit(const Params& p, int q0) {
  if (!p.causal) return p.Sk;
  const int last_row = min(q0 + kBlockM, p.Sq) - 1;
  return min(p.Sk, last_row + (p.Sk - p.Sq) + 1);
}

// ---------------------------------------------------------------------------
// bf16 / fp16: tensor cores
// ---------------------------------------------------------------------------
// One block = 64 query rows of one (b, q head); 4 warps x 16 rows each.
// Fragment layouts are those of mma.sync m16n8k16 (PTX ISA): with g = lane/4
// and t = lane%4, a thread holds A rows {g, g+8} x cols {2t, 2t+1, 2t+8,
// 2t+9}, B (k x n) rows {2t, 2t+1, 2t+8, 2t+9} x col g, and C rows {g, g+8}
// x cols {2t, 2t+1}. ldmatrix fills A from Q rows, B of Q @ K^T from K rows
// (plain) and B of P @ V from V rows (.trans). K/V tiles are double-
// buffered: tile j + 1 streams in by cp.async while tile j is computed.
template <typename T, int D>
__global__ void __launch_bounds__(128)
fa_fwd_mma(const Params p) {
  constexpr int kThreads = 128;
  constexpr int LDS = D + 8;  // +16 bytes a row: conflict-free ldmatrix rows
  constexpr int kDT = D / 8;  // n-tiles of the output
  constexpr int kKC = D / 16; // k-chunks of Q @ K^T
  constexpr int kNT = kBlockN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // shared memory: Q | K buffer 0 | K buffer 1 | V buffer 0 | V buffer 1
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* const sK0 = sQ + kBlockM * LDS;
  T* const sV0 = sK0 + 2 * kBlockN * LDS;

  const int n_qtiles = (p.Sq + kBlockM - 1) / kBlockM;
  const int q0 = (n_qtiles - 1 - blockIdx.x) * kBlockM;  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lm = lane >> 3;  // which 8x8 matrix this lane addresses
  const int lr = lane & 7;   // which row of it
  const bool aligned = p.aligned16 != 0;

  const T* Qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* Kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* Vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  const int kv_end = kv_limit(p, q0);
  const int n_tiles = (kv_end + kBlockN - 1) / kBlockN;

  load_tile<T, D, LDS, kBlockM, kThreads>(sQ, Qg, p.q_ss, q0, p.Sq, aligned);
  load_tile<T, D, LDS, kBlockN, kThreads>(sK0, Kg, p.k_ss, 0, p.Sk, aligned);
  load_tile<T, D, LDS, kBlockN, kThreads>(sV0, Vg, p.v_ss, 0, p.Sk, aligned);
  cp_async_commit();

  const int lr0 = warp * 16 + g;  // local rows of this thread: lr0, lr0 + 8
  const int offset = p.Sk - p.Sq;
  const int row[2] = {q0 + lr0, q0 + lr0 + 8};
  const float scale_log2 = p.scale * kLog2e;
  float m_i[2] = {kNegBig, kNegBig};  // running max, log2 units
  float l_i[2] = {0.f, 0.f};          // this thread's share of the row sum
  float acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  uint32_t qf[kKC][4];

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockN;
    const int buf = (j & 1) * kBlockN * LDS;  // offset of this tile's buffers
    const T* sK = sK0 + buf;
    const T* sV = sV0 + buf;
    if (j + 1 < n_tiles) {
      // the other buffer was last read in iteration j - 1, which ended in a
      // barrier
      const int next = kBlockN * LDS - buf;
      load_tile<T, D, LDS, kBlockN, kThreads>(sK0 + next, Kg, p.k_ss, k0 + kBlockN,
                                              p.Sk, aligned);
      load_tile<T, D, LDS, kBlockN, kThreads>(sV0 + next, Vg, p.v_ss, k0 + kBlockN,
                                              p.Sk, aligned);
      cp_async_commit();
      cp_async_wait<1>();  // everything but the tile just started
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (j == 0) {
#pragma unroll
      for (int kc = 0; kc < kKC; ++kc)
        ldmatrix_x4(qf[kc], sQ + (warp * 16 + (lm & 1) * 8 + lr) * LDS + kc * 16 + (lm >> 1) * 8);
    }

    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kKC; kc += 2) {
        uint32_t kf[4];  // B of chunks kc (kf[0..1]) and kc + 1 (kf[2..3])
        ldmatrix_x4(kf, sK + (nt * 8 + lr) * LDS + kc * 16 + lm * 8);
        Mma<T>::mma(s[nt], qf[kc], kf);
        Mma<T>::mma(s[nt], qf[kc + 1], kf + 2);
      }
    }

    const bool need_mask =
        (k0 + kBlockN > p.Sk) || (p.causal && k0 + kBlockN - 1 > q0 + offset);
    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (need_mask) {
          const int col = k0 + nt * 8 + 2 * t + (e & 1);
          const bool ok = col < p.Sk && (!p.causal || col <= row[e >> 1] + offset);
          x = ok ? x : kNegBig;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // m_i == mx == kNegBig (nothing visible yet) gives alpha = 1 with
      // l = acc = 0: no NaN from a fully masked first tile
      alpha[i] = exp2f(m_i[i] - mx[i]);
      m_i[i] = mx[i];
      l_i[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[nt][e];
        const float pe = (x == kNegBig) ? 0.f : exp2f(x - mx[e >> 1]);
        s[nt][e] = pe;
        l_i[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // O += P @ V. The C layout of two adjacent score n-tiles is exactly the
    // A layout of one 16-key chunk, so P goes from registers to the mma.
#pragma unroll
    for (int kc = 0; kc < kBlockN / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = Mma<T>::pack(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = Mma<T>::pack(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = Mma<T>::pack(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = Mma<T>::pack(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dt = 0; dt < kDT; dt += 2) {
        uint32_t vf[4];  // B of n-tiles dt (vf[0..1]) and dt + 1 (vf[2..3])
        ldmatrix_x4_trans(vf, sV + (kc * 16 + (lm & 1) * 8 + lr) * LDS +
                                  dt * 8 + (lm >> 1) * 8);
        Mma<T>::mma(acc[dt], pa, vf);
        Mma<T>::mma(acc[dt + 1], pa, vf + 2);
      }
    }
    __syncthreads();  // every warp is done with buf before it is refilled
  }

  // Epilogue: finish the row sums across the quad, normalise, store.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_i[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_safe = fmaxf(l, 1e-30f);
    const float inv = 1.f / l_safe;
    const int r = row[i];
    if (r < p.Sq) {
      T* Og = static_cast<T*>(p.o) + b * p.o_sb + (long long)r * p.o_ss + h * p.o_sh;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        *reinterpret_cast<uint32_t*>(Og + dt * 8 + 2 * t) =
            Mma<T>::pack(acc[dt][2 * i] * inv, acc[dt][2 * i + 1] * inv);
      }
      if (t == 0) {
        p.lse[((long long)b * p.Hq + h) * p.Sq + r] = (m_i[i] + log2f(l_safe)) * kLn2;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, full fp32 arithmetic
// ---------------------------------------------------------------------------
// One block = 64 query rows; 256 threads, four per row. Thread (r, c) owns
// score columns c, c+4, ... of its row and output dims c, c+4, ...
template <int D>
__global__ void __launch_bounds__(256)
fa_fwd_f32(const Params p) {
  constexpr int kThreads = 256;
  constexpr int LDQ = D + 1;  // odd pitch: conflict-free column walks
  constexpr int LDP = kBlockN + 1;
  constexpr int kCols = kBlockN / 4;
  constexpr int kDims = D / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + kBlockM * LDQ;
  float* sV = sK + kBlockN * LDQ;
  float* sP = sV + kBlockN * D;

  const int n_qtiles = (p.Sq + kBlockM - 1) / kBlockM;
  const int q0 = (n_qtiles - 1 - blockIdx.x) * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int lr = threadIdx.x / 4;
  const int c4 = threadIdx.x % 4;
  const int r = q0 + lr;

  const float* Qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* Kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* Vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int i = threadIdx.x; i < kBlockM * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    const int gr = q0 + rr;
    sQ[rr * LDQ + d] = gr < p.Sq ? Qg[(long long)gr * p.q_ss + d] * p.scale : 0.f;
  }

  const int offset = p.Sk - p.Sq;
  float m_i = kNegBig, l_i = 0.f;
  float acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) acc[i] = 0.f;

  const int kv_end = kv_limit(p, q0);
  const int n_tiles = (kv_end + kBlockN - 1) / kBlockN;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockN;
    __syncthreads();
    for (int i = threadIdx.x; i < kBlockN * D; i += kThreads) {
      const int rr = i / D, d = i % D;
      const int gr = k0 + rr;
      const bool in = gr < p.Sk;
      sK[rr * LDQ + d] = in ? Kg[(long long)gr * p.k_ss + d] : 0.f;
      sV[rr * D + d] = in ? Vg[(long long)gr * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    float s[kCols];
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) s[jj] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = sQ[lr * LDQ + d];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) s[jj] = fmaf(qv, sK[(c4 + 4 * jj) * LDQ + d], s[jj]);
    }
    float mx = m_i;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      const int col = k0 + c4 + 4 * jj;
      const bool ok = col < p.Sk && (!p.causal || col <= r + offset);
      s[jj] = ok ? s[jj] : kNegBig;
      mx = fmaxf(mx, s[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = expf(m_i - mx);
    m_i = mx;
    float rs = 0.f;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      const float pe = (s[jj] == kNegBig) ? 0.f : expf(s[jj] - mx);
      sP[lr * LDP + c4 + 4 * jj] = pe;
      rs += pe;
    }
    l_i = l_i * alpha + rs;  // this thread's share; summed over the quad below
    __syncwarp();  // the row's four threads share one warp
#pragma unroll
    for (int i = 0; i < kDims; ++i) acc[i] *= alpha;
    for (int c = 0; c < kBlockN; ++c) {
      const float pe = sP[lr * LDP + c];
      const float* vr = sV + c * D + c4;
#pragma unroll
      for (int i = 0; i < kDims; ++i) acc[i] = fmaf(pe, vr[4 * i], acc[i]);
    }
  }

  float l = l_i;
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  const float l_safe = fmaxf(l, 1e-30f);
  if (r < p.Sq) {
    float* Og = static_cast<float*>(p.o) + b * p.o_sb + (long long)r * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int i = 0; i < kDims; ++i) Og[c4 + 4 * i] = acc[i] / l_safe;
    if (c4 == 0) p.lse[((long long)b * p.Hq + h) * p.Sq + r] = m_i + logf(l_safe);
  }
}

// A refused launch is reported only by cudaGetLastError.
template <typename Kernel>
cudaError_t launch(Kernel kernel, bool* configured, int threads, size_t smem,
                   const Params& p, cudaStream_t stream) {
  const cudaError_t err = grant_smem(kernel, configured, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBlockM - 1) / kBlockM, p.Hq, p.B);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  const size_t smem = (size_t)(kBlockM + 4 * kBlockN) * (D + 8) * sizeof(T);
  return launch(fa_fwd_mma<T, D>, configured, 128, smem, p, stream);
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const size_t smem = ((size_t)(kBlockM + kBlockN) * (D + 1) + (size_t)kBlockN * D +
                       (size_t)kBlockM * (kBlockN + 1)) * sizeof(float);
  static bool configured[kMaxDevices] = {};
  return launch(fa_fwd_f32<D>, configured, 256, smem, p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. Strides are in elements.
// Returns a cudaError_t (0 on success).
extern "C" int pt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int B, int Hq, int Hkv, int Sq, int Sk, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, int aligned16, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = static_cast<float*>(lse);
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.Sq = Sq; p.Sk = Sk;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.scale = scale; p.causal = causal; p.aligned16 = aligned16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 2 && D == 128) return (int)launch_mma<__nv_bfloat16, 128>(p, s);
  if (dtype == 2 && D == 64) return (int)launch_mma<__nv_bfloat16, 64>(p, s);
  if (dtype == 1 && D == 128) return (int)launch_mma<__half, 128>(p, s);
  if (dtype == 1 && D == 64) return (int)launch_mma<__half, 64>(p, s);
  if (dtype == 0 && D == 128) return (int)launch_f32<128>(p, s);
  if (dtype == 0 && D == 64) return (int)launch_f32<64>(p, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
