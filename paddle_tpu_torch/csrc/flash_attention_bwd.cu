// Flash-attention backward for Hopper (sm_90a): the dq kernel and the dk/dv
// kernel, bound to Python through plain C entry points (ctypes; see
// paddle_tpu_torch/ops/cuda/_build.py).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (the Pallas TPU kernels launched by `_bwd`), and the GQA
// group-sum that `_bwd` does outside them. Same function, flash-attention-2's
// recomputation: P = exp(S * scale - LSE) from the forward's per-row LSE,
// dP = dO V^T, dS = P * (dP - delta) * scale with delta = rowsum(dO * O)
// (computed by the caller, as the JAX package leaves it to XLA), then
// dQ = dS K, dK = dS^T Q, dV = P^T dO. Masking is the forward kernel's:
// causal aligned bottom-right (key t visible to query s iff
// t <= s + (Sk - Sq)), GQA kv head = h / (Hq / Hkv).
//
// What bounds them on an H100: tensor-core flops at the training shape. Per
// visible (query, key) pair the dq kernel does three D-deep products (S, dP,
// dQ) and the dk/dv kernel four (S, dP, dV, dK), against two in the forward:
// 6 D and 8 D flops a pair, so at S = 2048, D = 128 both are far above the
// ~295 flop/byte at which bf16 tensor cores become the limit. At short
// sequences (S = 128) each block does one or two tiles of work and the bound
// is the bytes of q, k, v, dO, LSE and delta read and dq, dk, dv written.
// The design answers both simply:
//   * flops: bf16/fp16 products on tensor cores (mma.sync m16n8k16, fp32
//     accumulation) fed by ldmatrix; the causal loops stop at the diagonal
//     (dq: k/v tiles up to the last visible key; dk/dv: q tiles from the
//     first query that sees the block's first key); P and dS are rounded to
//     the input dtype only as operands of the next product, as FA2 does.
//   * bytes: q, k, v, dO are read straight from the caller's (B, S, H, D)
//     layout through strides (no transposed copies); tiles stream into
//     shared memory by cp.async, double-buffered under the current tile's
//     math; no S x S matrix and no per-q-head dk/dv copy touch device memory.
//   * dk/dv: one block owns 64 keys of one kv head and loops over the q
//     tiles of every q head of its GQA group, so dk and dv are summed over
//     the group in fp32 registers: no (B, Hq, Sk, D) scratch, no group-sum
//     pass, no atomics (deterministic). Each warp computes S^T = K Q^T for
//     its 16 keys directly, so P^T and dS^T come out of the mma already in
//     the row layout of the A operand of dV = P^T dO and dK = dS^T Q: they go
//     from registers into the next product without a trip through shared
//     memory. At D = 128 a thread holds two 16 x 128 fp32 accumulators (128
//     registers), so the q tile is 32 rows there (64 at D = 64) to keep the
//     score and dP fragments small enough not to spill.
// fp32 inputs run on CUDA cores in full fp32 (no TF32), four threads per row.
// wgmma, TMA and warp specialisation are left for later work.
#include "flash_attention_common.cuh"

namespace {

constexpr int kBlockM = 64;  // dq: query rows per block; dk/dv: keys per block
constexpr int kBlockN = 64;  // dq: keys per k/v tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, Hq, Sq) contiguous, natural log
  const float* delta;  // (B, Hq, Sq) contiguous
  void* dq;
  void* dk;
  void* dv;
  int B, Hq, Hkv, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  float scale;
  int causal;
  int aligned16;  // every row of q/k/v/dO starts on a 16-byte boundary
};

// Number of keys the rows [q0, q0 + kBlockM) can see.
__device__ __forceinline__ int kv_limit(const Params& p, int q0) {
  if (!p.causal) return p.Sk;
  const int last_row = min(q0 + kBlockM, p.Sq) - 1;
  return min(p.Sk, last_row + (p.Sk - p.Sq) + 1);
}

// First q tile (of `rows` rows) with a query that sees key k0.
__device__ __forceinline__ int q_tile_lo(const Params& p, int k0, int rows) {
  if (!p.causal) return 0;
  return max(k0 - (p.Sk - p.Sq), 0) / rows;
}

// ---------------------------------------------------------------------------
// bf16 / fp16: tensor cores
// ---------------------------------------------------------------------------
// Fragment layouts are those of mma.sync m16n8k16 (PTX ISA): with g = lane/4
// and t = lane%4, a thread holds A rows {g, g+8} x cols {2t, 2t+1, 2t+8,
// 2t+9}, B (k x n) rows {2t, 2t+1, 2t+8, 2t+9} x col g, and C rows {g, g+8}
// x cols {2t, 2t+1}. The C layout of two adjacent n-tiles is the A layout of
// one 16-deep k-chunk, so a result goes from registers into the next product.
//
// X @ Y^T for a warp's 16 rows of X (smem, pitch LDS) against ROWS rows of Y
// (smem): acc[n][..] += X[16 rows] . Y[n * 8 + (0..7)] over D. A comes from
// X by ldmatrix, B from Y's rows by plain ldmatrix (B[k][n] = Y[n][k]).
template <typename T, int D, int LDS, int ROWS>
__device__ __forceinline__ void mma_abt(float (*acc)[4], const T* X, const T* Y,
                                        int lm, int lr) {
#pragma unroll
  for (int kc = 0; kc < D / 16; kc += 2) {
    uint32_t a0[4], a1[4];
    ldmatrix_x4(a0, X + ((lm & 1) * 8 + lr) * LDS + kc * 16 + (lm >> 1) * 8);
    ldmatrix_x4(a1, X + ((lm & 1) * 8 + lr) * LDS + (kc + 1) * 16 + (lm >> 1) * 8);
#pragma unroll
    for (int nt = 0; nt < ROWS / 8; ++nt) {
      uint32_t b[4];  // B of chunks kc (b[0..1]) and kc + 1 (b[2..3])
      ldmatrix_x4(b, Y + (nt * 8 + lr) * LDS + kc * 16 + lm * 8);
      Mma<T>::mma(acc[nt], a0, b);
      Mma<T>::mma(acc[nt], a1, b + 2);
    }
  }
}

// acc[dt][..] += A @ Y for A (16 x KROWS) held in C-layout registers `a`
// (rounded to T here) and Y (KROWS x D) in smem, B from Y's rows by
// ldmatrix.trans (B[k][n] = Y[k][n]).
template <typename T, int D, int LDS, int KROWS>
__device__ __forceinline__ void mma_ab(float (*acc)[4], float (*a)[4], const T* Y,
                                       int lm, int lr) {
#pragma unroll
  for (int kc = 0; kc < KROWS / 16; ++kc) {
    uint32_t pa[4];
    pa[0] = Mma<T>::pack(a[2 * kc][0], a[2 * kc][1]);
    pa[1] = Mma<T>::pack(a[2 * kc][2], a[2 * kc][3]);
    pa[2] = Mma<T>::pack(a[2 * kc + 1][0], a[2 * kc + 1][1]);
    pa[3] = Mma<T>::pack(a[2 * kc + 1][2], a[2 * kc + 1][3]);
#pragma unroll
    for (int dt = 0; dt < D / 8; dt += 2) {
      uint32_t b[4];  // B of n-tiles dt (b[0..1]) and dt + 1 (b[2..3])
      ldmatrix_x4_trans(b, Y + (kc * 16 + (lm & 1) * 8 + lr) * LDS + dt * 8 + (lm >> 1) * 8);
      Mma<T>::mma(acc[dt], pa, b);
      Mma<T>::mma(acc[dt + 1], pa, b + 2);
    }
  }
}

// Store a warp's 16 x D accumulator rows {g, g+8} (global rows r[0], r[1],
// skipped at or past `nrows`) into a (rows, D) matrix at `base`.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, long long stride, const int* r,
                                           int nrows, float (*acc)[4], int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (r[i] >= nrows) continue;
    T* row = base + (long long)r[i] * stride;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(row + dt * 8 + 2 * t) =
          Mma<T>::pack(acc[dt][2 * i], acc[dt][2 * i + 1]);
    }
  }
}

// dq: one block = 64 query rows of one (b, q head); 4 warps x 16 rows. Per
// k/v tile (64 keys, double-buffered): S = Q K^T and dP = dO V^T (16 x 64 a
// warp), P and dS in registers, dQ += dS K.
template <typename T, int D>
__global__ void __launch_bounds__(128)
fa_bwd_dq_mma(const Params p) {
  constexpr int kThreads = 128;
  constexpr int LDS = D + 8;  // +16 bytes a row: conflict-free ldmatrix rows
  constexpr int kNT = kBlockN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // shared memory: Q | dO | K buffers 0, 1 | V buffers 0, 1
  T* const sQ = reinterpret_cast<T*>(smem_raw);
  T* const sdO = sQ + kBlockM * LDS;
  T* const sK0 = sdO + kBlockM * LDS;
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
  const int lm = lane >> 3;
  const int lr = lane & 7;
  const bool aligned = p.aligned16 != 0;

  const T* Qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dOg = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* Kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* Vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  const int kv_end = kv_limit(p, q0);
  const int n_tiles = (kv_end + kBlockN - 1) / kBlockN;

  load_tile<T, D, LDS, kBlockM, kThreads>(sQ, Qg, p.q_ss, q0, p.Sq, aligned);
  load_tile<T, D, LDS, kBlockM, kThreads>(sdO, dOg, p.do_ss, q0, p.Sq, aligned);
  load_tile<T, D, LDS, kBlockN, kThreads>(sK0, Kg, p.k_ss, 0, p.Sk, aligned);
  load_tile<T, D, LDS, kBlockN, kThreads>(sV0, Vg, p.v_ss, 0, p.Sk, aligned);
  cp_async_commit();

  const int offset = p.Sk - p.Sq;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float scale_log2 = p.scale * kLog2e;
  float lse_log2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row[i] < p.Sq;
    const long long idx = ((long long)b * p.Hq + h) * p.Sq + row[i];
    lse_log2[i] = in ? p.lse[idx] * kLog2e : 0.f;
    dlt[i] = in ? p.delta[idx] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockN;
    const int buf = (j & 1) * kBlockN * LDS;
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
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
    mma_abt<T, D, LDS, kBlockN>(s, sQ + warp * 16 * LDS, sK, lm, lr);
    mma_abt<T, D, LDS, kBlockN>(dp, sdO + warp * 16 * LDS, sV, lm, lr);

    // P = 0 exactly for masked scores, keys past Sk and rows past Sq: a
    // zero-filled row has s = 0 and LSE = 0, which would give P = 1.
    const bool need_mask = (k0 + kBlockN > p.Sk) || (q0 + kBlockM > p.Sq) ||
                           (p.causal && k0 + kBlockN - 1 > q0 + offset);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        bool ok = true;
        if (need_mask) {
          const int col = k0 + nt * 8 + 2 * t + (e & 1);
          ok = col < p.Sk && row[i] < p.Sq && (!p.causal || col <= row[i] + offset);
        }
        const float pe = ok ? exp2f(s[nt][e] * scale_log2 - lse_log2[i]) : 0.f;
        s[nt][e] = ok ? pe * (dp[nt][e] - dlt[i]) * p.scale : 0.f;  // dS
      }
    }
    mma_ab<T, D, LDS, kBlockN>(acc, s, sK, lm, lr);  // dQ += dS K
    __syncthreads();  // every warp is done with buf before it is refilled
  }

  T* dQg = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  store_rows<T, D>(dQg, p.dq_ss, row, p.Sq, acc, t);
}

// dk/dv: one block = 64 keys of one (b, kv head); 4 warps x 16 keys. Loops
// over the q heads of the GQA group and, for each, the q tiles (BQ rows,
// double-buffered) from the causal lo: S^T = K Q^T and dP^T = V dO^T
// (16 x BQ a warp), P^T and dS^T in registers, dV += P^T dO, dK += dS^T Q.
template <typename T, int D>
__global__ void __launch_bounds__(128)
fa_bwd_dkv_mma(const Params p) {
  constexpr int kThreads = 128;
  constexpr int LDS = D + 8;
  constexpr int BQ = D >= 128 ? 32 : 64;  // q rows per tile (registers, above)
  constexpr int kNT = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // shared memory: K | V | Q buffers 0, 1 | dO buffers 0, 1 | LSE*log2e, delta
  // (two buffers each)
  T* const sK = reinterpret_cast<T*>(smem_raw);
  T* const sV = sK + kBlockM * LDS;
  T* const sQ0 = sV + kBlockM * LDS;
  T* const sdO0 = sQ0 + 2 * BQ * LDS;
  float* const sL0 = reinterpret_cast<float*>(sdO0 + 2 * BQ * LDS);
  float* const sDl0 = sL0 + 2 * BQ;

  const int k0 = blockIdx.x * kBlockM;  // causal: the longest key tiles first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = p.Hq / p.Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lm = lane >> 3;
  const int lr = lane & 7;
  const bool aligned = p.aligned16 != 0;

  const T* Kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* Vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  const int n_q = (p.Sq + BQ - 1) / BQ;
  const int lo = q_tile_lo(p, k0, BQ);
  const int per_head = n_q - lo;
  const int n_iter = rep * per_head;

  // Stage the q tile of iteration `it` (q head, tile) into buffer `bi`.
  auto stage = [&](int it, int bi) {
    const int h = hk * rep + it / per_head;
    const int q0 = (lo + it % per_head) * BQ;
    const T* Qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dOg = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    load_tile<T, D, LDS, BQ, kThreads>(sQ0 + bi * BQ * LDS, Qg, p.q_ss, q0, p.Sq, aligned);
    load_tile<T, D, LDS, BQ, kThreads>(sdO0 + bi * BQ * LDS, dOg, p.do_ss, q0, p.Sq,
                                       aligned);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const int r = q0 + i;
      const long long idx = ((long long)b * p.Hq + h) * p.Sq + r;
      sL0[bi * BQ + i] = r < p.Sq ? p.lse[idx] * kLog2e : 0.f;
      sDl0[bi * BQ + i] = r < p.Sq ? p.delta[idx] : 0.f;
    }
  };

  load_tile<T, D, LDS, kBlockM, kThreads>(sK, Kg, p.k_ss, k0, p.Sk, aligned);
  load_tile<T, D, LDS, kBlockM, kThreads>(sV, Vg, p.v_ss, k0, p.Sk, aligned);
  stage(0, 0);
  cp_async_commit();

  const int offset = p.Sk - p.Sq;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const float scale_log2 = p.scale * kLog2e;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    dk[dt][0] = dk[dt][1] = dk[dt][2] = dk[dt][3] = 0.f;
    dv[dt][0] = dv[dt][1] = dv[dt][2] = dv[dt][3] = 0.f;
  }

  for (int it = 0; it < n_iter; ++it) {
    const int bi = it & 1;
    const int q0 = (lo + it % per_head) * BQ;
    const T* sQ = sQ0 + bi * BQ * LDS;
    const T* sdO = sdO0 + bi * BQ * LDS;
    const float* sL = sL0 + bi * BQ;
    const float* sDl = sDl0 + bi * BQ;
    if (it + 1 < n_iter) {
      // the other buffers were last read in iteration it - 1, which ended in
      // a barrier
      stage(it + 1, bi ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[kNT][4], dp[kNT][4];  // S^T and dP^T: rows = keys, cols = queries
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
    mma_abt<T, D, LDS, BQ>(s, sK + warp * 16 * LDS, sQ, lm, lr);
    mma_abt<T, D, LDS, BQ>(dp, sV + warp * 16 * LDS, sdO, lm, lr);

    // P^T = 0 exactly for masked scores, queries past Sq and keys past Sk.
    const bool need_mask = (q0 + BQ > p.Sq) || (k0 + kBlockM > p.Sk) ||
                           (p.causal && k0 + kBlockM - 1 > q0 + offset);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + 2 * t + (e & 1);  // query within the tile
        bool ok = true;
        if (need_mask) {
          const int r = q0 + qc;
          const int c = key[e >> 1];
          ok = r < p.Sq && c < p.Sk && (!p.causal || c <= r + offset);
        }
        const float pe = ok ? exp2f(s[nt][e] * scale_log2 - sL[qc]) : 0.f;
        s[nt][e] = pe;
        dp[nt][e] = ok ? pe * (dp[nt][e] - sDl[qc]) * p.scale : 0.f;  // dS^T
      }
    }
    mma_ab<T, D, LDS, BQ>(dv, s, sdO, lm, lr);   // dV += P^T dO
    mma_ab<T, D, LDS, BQ>(dk, dp, sQ, lm, lr);   // dK += dS^T Q
    __syncthreads();  // every warp is done with bi before it is refilled
  }

  T* dKg = static_cast<T*>(p.dk) + b * p.dk_sb + hk * p.dk_sh;
  T* dVg = static_cast<T*>(p.dv) + b * p.dv_sb + hk * p.dv_sh;
  store_rows<T, D>(dKg, p.dk_ss, key, p.Sk, dk, t);
  store_rows<T, D>(dVg, p.dv_ss, key, p.Sk, dv, t);
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, full fp32 arithmetic
// ---------------------------------------------------------------------------
// 256 threads, four per row of the block's 64 rows. Thread (r, c) owns score
// columns c, c+4, ... of its row and output dims c, c+4, ...; odd pitches
// keep the column walks free of bank conflicts.
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, long long stride,
                                              int r0, int nrows, float mul) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < kBlockM * D; i += 256) {
    const int rr = i / D, d = i % D;
    const int gr = r0 + rr;
    dst[rr * LD + d] = gr < nrows ? src[(long long)gr * stride + d] * mul : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(256)
fa_bwd_dq_f32(const Params p) {
  constexpr int LD = D + 1;
  constexpr int LDP = kBlockN + 1;
  constexpr int kCols = kBlockN / 4;
  constexpr int kDims = D / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // pre-scaled by scale
  float* sdO = sQ + kBlockM * LD;
  float* sK = sdO + kBlockM * LD;
  float* sV = sK + kBlockN * LD;
  float* sS = sV + kBlockN * LD;  // dS

  const int n_qtiles = (p.Sq + kBlockM - 1) / kBlockM;
  const int q0 = (n_qtiles - 1 - blockIdx.x) * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int lr = threadIdx.x / 4;
  const int c4 = threadIdx.x % 4;
  const int r = q0 + lr;

  const float* Qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dOg = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* Kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* Vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_rows_f32<D>(sQ, Qg, p.q_ss, q0, p.Sq, p.scale);
  load_rows_f32<D>(sdO, dOg, p.do_ss, q0, p.Sq, 1.f);

  const long long idx = ((long long)b * p.Hq + h) * p.Sq + r;
  const float lse = r < p.Sq ? p.lse[idx] : 0.f;
  const float dlt = r < p.Sq ? p.delta[idx] : 0.f;
  const int offset = p.Sk - p.Sq;
  float acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) acc[i] = 0.f;

  const int n_tiles = (kv_limit(p, q0) + kBlockN - 1) / kBlockN;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockN;
    __syncthreads();
    load_rows_f32<D>(sK, Kg, p.k_ss, k0, p.Sk, 1.f);
    load_rows_f32<D>(sV, Vg, p.v_ss, k0, p.Sk, 1.f);
    __syncthreads();

    float s[kCols], dp[kCols];
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) s[jj] = dp[jj] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = sQ[lr * LD + d];
      const float ov = sdO[lr * LD + d];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        s[jj] = fmaf(qv, sK[(c4 + 4 * jj) * LD + d], s[jj]);
        dp[jj] = fmaf(ov, sV[(c4 + 4 * jj) * LD + d], dp[jj]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      const int col = k0 + c4 + 4 * jj;
      const bool ok = r < p.Sq && col < p.Sk && (!p.causal || col <= r + offset);
      const float pe = ok ? expf(s[jj] - lse) : 0.f;
      sS[lr * LDP + c4 + 4 * jj] = ok ? pe * (dp[jj] - dlt) * p.scale : 0.f;
    }
    __syncwarp();  // the row's four threads share one warp
    for (int c = 0; c < kBlockN; ++c) {
      const float ds = sS[lr * LDP + c];
      const float* kr = sK + c * LD + c4;
#pragma unroll
      for (int i = 0; i < kDims; ++i) acc[i] = fmaf(ds, kr[4 * i], acc[i]);
    }
  }

  if (r < p.Sq) {
    float* dQg = static_cast<float*>(p.dq) + b * p.dq_sb + (long long)r * p.dq_ss + h * p.dq_sh;
#pragma unroll
    for (int i = 0; i < kDims; ++i) dQg[c4 + 4 * i] = acc[i];
  }
}

template <int D>
__global__ void __launch_bounds__(256)
fa_bwd_dkv_f32(const Params p) {
  constexpr int LD = D + 1;
  constexpr int LDP = kBlockN + 1;
  constexpr int kCols = kBlockN / 4;  // queries of a 64-row q tile a thread owns
  constexpr int kDims = D / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);  // pre-scaled by scale
  float* sV = sK + kBlockM * LD;
  float* sQ = sV + kBlockM * LD;
  float* sdO = sQ + kBlockN * LD;
  float* sP = sdO + kBlockN * LD;   // P^T
  float* sS = sP + kBlockM * LDP;   // dS^T
  float* sL = sS + kBlockM * LDP;
  float* sDl = sL + kBlockN;

  const int k0 = blockIdx.x * kBlockM;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = p.Hq / p.Hkv;
  const int lr = threadIdx.x / 4;
  const int c4 = threadIdx.x % 4;
  const int c = k0 + lr;  // this thread's key

  const float* Kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* Vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_rows_f32<D>(sK, Kg, p.k_ss, k0, p.Sk, p.scale);
  load_rows_f32<D>(sV, Vg, p.v_ss, k0, p.Sk, 1.f);

  const int offset = p.Sk - p.Sq;
  float dk[kDims], dv[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) dk[i] = dv[i] = 0.f;

  const int n_q = (p.Sq + kBlockN - 1) / kBlockN;
  const int lo = q_tile_lo(p, k0, kBlockN);
  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    const float* Qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* dOg = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int qt = lo; qt < n_q; ++qt) {
      const int q0 = qt * kBlockN;
      __syncthreads();
      load_rows_f32<D>(sQ, Qg, p.q_ss, q0, p.Sq, 1.f);
      load_rows_f32<D>(sdO, dOg, p.do_ss, q0, p.Sq, 1.f);
      for (int i = threadIdx.x; i < kBlockN; i += 256) {
        const int r = q0 + i;
        const long long idx = ((long long)b * p.Hq + h) * p.Sq + r;
        sL[i] = r < p.Sq ? p.lse[idx] : 0.f;
        sDl[i] = r < p.Sq ? p.delta[idx] : 0.f;
      }
      __syncthreads();

      float s[kCols], dp[kCols];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) s[jj] = dp[jj] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kv = sK[lr * LD + d];
        const float vv = sV[lr * LD + d];
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) {
          s[jj] = fmaf(kv, sQ[(c4 + 4 * jj) * LD + d], s[jj]);
          dp[jj] = fmaf(vv, sdO[(c4 + 4 * jj) * LD + d], dp[jj]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        const int qc = c4 + 4 * jj;
        const int r = q0 + qc;
        const bool ok = r < p.Sq && c < p.Sk && (!p.causal || c <= r + offset);
        const float pe = ok ? expf(s[jj] - sL[qc]) : 0.f;
        sP[lr * LDP + qc] = pe;
        sS[lr * LDP + qc] = ok ? pe * (dp[jj] - sDl[qc]) * p.scale : 0.f;
      }
      __syncwarp();
      for (int qq = 0; qq < kBlockN; ++qq) {
        const float pe = sP[lr * LDP + qq];
        const float ds = sS[lr * LDP + qq];
        const float* dor = sdO + qq * LD + c4;
        const float* qr = sQ + qq * LD + c4;
#pragma unroll
        for (int i = 0; i < kDims; ++i) {
          dv[i] = fmaf(pe, dor[4 * i], dv[i]);
          dk[i] = fmaf(ds, qr[4 * i], dk[i]);
        }
      }
    }
  }

  if (c < p.Sk) {
    float* dKg = static_cast<float*>(p.dk) + b * p.dk_sb + (long long)c * p.dk_ss + hk * p.dk_sh;
    float* dVg = static_cast<float*>(p.dv) + b * p.dv_sb + (long long)c * p.dv_ss + hk * p.dv_sh;
#pragma unroll
    for (int i = 0; i < kDims; ++i) {
      dKg[c4 + 4 * i] = dk[i];
      dVg[c4 + 4 * i] = dv[i];
    }
  }
}

// A refused launch is reported only by cudaGetLastError.
template <typename Kernel>
cudaError_t launch(Kernel kernel, bool* configured, dim3 grid, int threads, size_t smem,
                   const Params& p, cudaStream_t stream) {
  const cudaError_t err = grant_smem(kernel, configured, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

dim3 dq_grid(const Params& p) { return dim3((p.Sq + kBlockM - 1) / kBlockM, p.Hq, p.B); }
dim3 dkv_grid(const Params& p) { return dim3((p.Sk + kBlockM - 1) / kBlockM, p.Hkv, p.B); }

template <typename T, int D>
cudaError_t launch_dq_mma(const Params& p, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  const size_t smem = (size_t)(2 * kBlockM + 4 * kBlockN) * (D + 8) * sizeof(T);
  return launch(fa_bwd_dq_mma<T, D>, configured, dq_grid(p), 128, smem, p, stream);
}

template <typename T, int D>
cudaError_t launch_dkv_mma(const Params& p, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  constexpr int BQ = D >= 128 ? 32 : 64;  // as in fa_bwd_dkv_mma
  const size_t smem = (size_t)(2 * kBlockM + 4 * BQ) * (D + 8) * sizeof(T) +
                      (size_t)4 * BQ * sizeof(float);
  return launch(fa_bwd_dkv_mma<T, D>, configured, dkv_grid(p), 128, smem, p, stream);
}

template <int D>
cudaError_t launch_dq_f32(const Params& p, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  const size_t smem = ((size_t)(2 * kBlockM + 2 * kBlockN) * (D + 1) +
                       (size_t)kBlockM * (kBlockN + 1)) * sizeof(float);
  return launch(fa_bwd_dq_f32<D>, configured, dq_grid(p), 256, smem, p, stream);
}

template <int D>
cudaError_t launch_dkv_f32(const Params& p, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  const size_t smem = ((size_t)(2 * kBlockM + 2 * kBlockN) * (D + 1) +
                       (size_t)2 * kBlockM * (kBlockN + 1) + 2 * kBlockN) * sizeof(float);
  return launch(fa_bwd_dkv_f32<D>, configured, dkv_grid(p), 256, smem, p, stream);
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, int B, int Hq, int Hkv, int Sq,
                   int Sk, const long long* s, float scale, int causal, int aligned16) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.Sq = Sq; p.Sk = Sk;
  p.q_sb = s[0]; p.q_ss = s[1]; p.q_sh = s[2];
  p.k_sb = s[3]; p.k_ss = s[4]; p.k_sh = s[5];
  p.v_sb = s[6]; p.v_ss = s[7]; p.v_sh = s[8];
  p.do_sb = s[9]; p.do_ss = s[10]; p.do_sh = s[11];
  p.scale = scale; p.causal = causal; p.aligned16 = aligned16;
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. Strides are in elements:
// (batch, seq, head) of q, k, v, dO and then of the output(s). Returns a
// cudaError_t (0 on success).
extern "C" int pt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, int dtype, int B, int Hq, int Hkv, int Sq, int Sk, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long dq_sb, long long dq_ss, long long dq_sh,
    float scale, int causal, int aligned16, void* stream) {
  const long long s[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh, do_sb, do_ss, do_sh};
  Params p = make_params(q, k, v, dout, lse, delta, B, Hq, Hkv, Sq, Sk, s, scale, causal,
                         aligned16);
  p.dq = dq; p.dq_sb = dq_sb; p.dq_ss = dq_ss; p.dq_sh = dq_sh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 2 && D == 128) return (int)launch_dq_mma<__nv_bfloat16, 128>(p, st);
  if (dtype == 2 && D == 64) return (int)launch_dq_mma<__nv_bfloat16, 64>(p, st);
  if (dtype == 1 && D == 128) return (int)launch_dq_mma<__half, 128>(p, st);
  if (dtype == 1 && D == 64) return (int)launch_dq_mma<__half, 64>(p, st);
  if (dtype == 0 && D == 128) return (int)launch_dq_f32<128>(p, st);
  if (dtype == 0 && D == 64) return (int)launch_dq_f32<64>(p, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int pt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int dtype, int B, int Hq, int Hkv, int Sq,
    int Sk, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long dk_sb, long long dk_ss, long long dk_sh,
    long long dv_sb, long long dv_ss, long long dv_sh,
    float scale, int causal, int aligned16, void* stream) {
  const long long s[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh, do_sb, do_ss, do_sh};
  Params p = make_params(q, k, v, dout, lse, delta, B, Hq, Hkv, Sq, Sk, s, scale, causal,
                         aligned16);
  p.dk = dk; p.dk_sb = dk_sb; p.dk_ss = dk_ss; p.dk_sh = dk_sh;
  p.dv = dv; p.dv_sb = dv_sb; p.dv_ss = dv_ss; p.dv_sh = dv_sh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 2 && D == 128) return (int)launch_dkv_mma<__nv_bfloat16, 128>(p, st);
  if (dtype == 2 && D == 64) return (int)launch_dkv_mma<__nv_bfloat16, 64>(p, st);
  if (dtype == 1 && D == 128) return (int)launch_dkv_mma<__half, 128>(p, st);
  if (dtype == 1 && D == 64) return (int)launch_dkv_mma<__half, 64>(p, st);
  if (dtype == 0 && D == 128) return (int)launch_dkv_f32<128>(p, st);
  if (dtype == 0 && D == 64) return (int)launch_dkv_f32<64>(p, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
