// Flash-attention backward for Hopper (sm_90a): the dq kernel and the dk/dv
// kernel, bound to Python through plain C entry points (ctypes; see
// paddle_tpu_torch/ops/cuda/_build.py).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (the Pallas TPU kernels launched by `_bwd`), and the two
// passes `_bwd` does around them in XLA: delta = rowsum(dO * O) is fused into
// the dq kernel, the GQA group sum of dK and dV into the dk/dv kernel. Same
// function, flash-attention-2's recomputation: P = exp(S * scale - LSE) from
// the forward's per-row LSE, dP = dO V^T, dS = P * (dP - delta) * scale, then
// dQ = dS K, dK = dS^T Q, dV = P^T dO. Masking is the forward kernel's:
// causal aligned bottom-right (key t visible to query s iff
// t <= s + (Sk - Sq)), GQA kv head = h / (Hq / Hkv); masked scores, rows past
// Sq and keys past Sk give P = 0 exactly.
//
// What bounds them on an H100: per visible (query, key) pair the dq kernel
// does three D-deep products (S, dP, dQ: 6 D flops) and the dk/dv kernel four
// (S, dP, dV, dK: 8 D flops). At S >= ~1k that is far above the ~295
// flop/byte at which bf16 tensor cores become the limit, so the bound is
// tensor-core operations; at the prefill length (S = 128) each block does one
// or two tiles and the bound is the bytes of q, k, v, dO, O, LSE and delta
// read and dq, dk, dv written.
//
// bf16 / fp16 (`fa_bwd_dq_wgmma`, `fa_bwd_dkv_wgmma`, head dims 32, 64, 96,
// 128, 256; the wrapper zero-pads any other head dim up to 256 to the next of
// them), designed for Hopper on the forward's building blocks (hopper.cuh):
//   * operations: every product runs on wgmma. A block is two consumer
//     warpgroups of 64 rows. The two score-like products (S = Q K^T and
//     dP = dO V^T in dq; S^T = K Q^T and dP^T = V dO^T in dk/dv) read both
//     operands K-major from shared memory (D contiguous in every input) and
//     are issued together, so the exp of P runs while dP is still in flight.
//     Their fp32 accumulators are already the A-register layout of the next
//     product: P (dq: dS) and P^T, dS^T are packed to 16-bit pairs and go
//     straight into dQ += dS K, dV += P^T dO and dK += dS^T Q, whose B
//     operand (K, dO, Q: the keys or queries are the contraction dim, D is
//     contiguous) is MN-major through the descriptor's transpose bit. P and
//     dS never touch shared memory. The element loops are branch-free: one
//     uniform branch per tile decides whether masking selects run. The causal
//     loops stop at the diagonal, per warpgroup, and blocks are issued
//     longest first.
//   * bytes: Q, K, V, dO and O are read straight from the caller's
//     (B, S, H, D) strides by TMA (one 4-d tensor map each, 128-byte swizzle,
//     64-byte at D = 32 and 96); one thread issues the copies into a ring of two
//     stages with full/empty mbarriers, so the next tile streams in under the
//     current one's products. The dk/dv kernel's stage also carries the
//     tile's LSE and delta rows, by 1-d TMA maps over the (B, Hq, Sq) fp32
//     tensors. TMA zero-fills rows past Sq and Sk.
//   * dq (128 query rows a block, 128-key K/V tiles): the prologue computes
//     delta = rowsum(dO * O) in fp32 for the block's rows from dO, already in
//     shared memory, and O, which TMA puts in the last K/V stage before that
//     stage is first needed; the block writes delta to (B, Hq, Sq) fp32 for
//     the dk/dv kernel (launched after it on the same stream) and uses it at
//     once. Registers a thread: dQ D / 2, S and dP 64 each (220 in all at
//     D = 128, no spill). 128-key tiles make S and dP n128 products, which
//     read less shared memory per flop than n64 (at n64 the two score
//     products alone need ~128 B a cycle, the SM's rate): 14% faster than
//     64-key tiles at B8 S2048 in a same-card A/B. At D = 256 a block is 64
//     rows (one warpgroup) and the K/V tiles 64 keys: dQ 128 registers, S and
//     dP 32 each; Q, dO 64 KB and two stages of K, V 128 KB.
//   * dk/dv (128 keys of one (b, kv head) a block, BQ-row Q/dO tiles): the
//     block loops over the q heads of its GQA group and, for each, the q
//     tiles from the causal lo, summing dK and dV over the group in fp32
//     registers: no (B, Hq, Sk, D) scratch, no group-sum pass, no atomics, so
//     the result is deterministic. Registers a thread: dK and dV D / 2 each
//     (128 at D = 128), S^T and dP^T BQ / 2 each; BQ = 64 keeps every
//     instantiation within 255 registers with no spill (nvcc -Xptxas -v).
//     At D = 256 a block is 64 keys: both warpgroups compute the same S^T
//     and dP^T and each sums half of the head dim of dK and dV (64 registers
//     each, as at D = 128), which costs the score products twice (12 D flops
//     a pair against 8 D) but keeps the two warpgroups' work the same.
// Measured slower and not kept: issuing the next tile's score products before
// this tile's P and dS (dq, two register sets) or right behind its dV and dK
// (dk/dv), both with three stages: ptxas serialized the wgmmas (C7518) around
// the barrier waits and branches that then run with products in flight.
// Left for later: a producer warp with setmaxnreg, ping-pong of the consumer
// warpgroups and persistent blocks; one fused kernel that accumulates dQ with
// fp32 atomics (FA2/FA3: it drops the recompute of S and dP, 14 D to 10 D
// flops a pair, but gives up the deterministic two-kernel split).
//
// fp32 inputs run on CUDA cores in full fp32 (no TF32), four threads per row
// (64-row tiles, 32 at D = 256); the fp32 dq kernel computes delta for its
// rows too.
#include "flash_attention_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBox = 64;       // rows of a warpgroup's tile and of a TMA box
constexpr int kStages = 2;     // K/V (dq) or Q/dO (dk/dv) stages in the ring
constexpr float kBig = 1e30f;  // an LSE that gives P = 0 (rows past Sq)

struct BwdParams {
  CUtensorMap tq, tk, tv, tdo, to;  // (D, S, H, B) maps
  CUtensorMap tlse, tdelta;         // (B * Hq * Sq) fp32 maps (dk/dv)
  const float* lse;                 // (B, Hq, Sq) contiguous, natural log
  float* delta;                     // (B, Hq, Sq): written by dq, read by dk/dv
  void* dq;                         // contiguous (B, Sq, Hq, D)
  void* dk;                         // contiguous (B, Sk, Hkv, D)
  void* dv;
  int Hq, Hkv, Sq, Sk;
  float scale;
  int causal;
};

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}

// sum of the products of eight 16-bit pairs, in fp32
template <typename T>
__device__ __forceinline__ float dot8(uint4 x, uint4 y) {
  const float2 a0 = unpack2<T>(x.x), b0 = unpack2<T>(y.x);
  const float2 a1 = unpack2<T>(x.y), b1 = unpack2<T>(y.y);
  const float2 a2 = unpack2<T>(x.z), b2 = unpack2<T>(y.z);
  const float2 a3 = unpack2<T>(x.w), b3 = unpack2<T>(y.w);
  return a0.x * b0.x + a0.y * b0.y + a1.x * b1.x + a1.y * b1.y + a2.x * b2.x + a2.y * b2.y +
         a3.x * b3.x + a3.y * b3.y;
}

// An m64nN accumulator (n8 groups i, a thread's elements 4 i + e: row
// r0 + 8 (e >> 1), column 8 i + 2 (lane % 4) + (e & 1)) packed to the A
// registers of k16 steps: groups 2 kc and 2 kc + 1 are step kc.
template <typename T, int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc) {
    a[kc][0] = pack2<T>(x[8 * kc + 0], x[8 * kc + 1]);
    a[kc][1] = pack2<T>(x[8 * kc + 2], x[8 * kc + 3]);
    a[kc][2] = pack2<T>(x[8 * kc + 4], x[8 * kc + 5]);
    a[kc][3] = pack2<T>(x[8 * kc + 6], x[8 * kc + 7]);
  }
}

// Store a warpgroup's m64 x D accumulator rows row[0], row[1] (skipped at or
// past nrows) into the contiguous (rows, heads, D) slab at `base` (row
// stride `stride` elements).
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, long long stride, const int (&row)[2],
                                           int nrows, const float (&acc)[D / 2], int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= nrows) continue;
    T* g = base + (long long)row[r] * stride + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(g + 8 * i) = pack2<T>(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// dq: 128 query rows of one (b, q head) a block (two warpgroups), 128-key K/V
// tiles; at D = 256 64 rows (one warpgroup) and 64-key tiles
// ---------------------------------------------------------------------------
template <int D>
struct DqLayout : SwizzleAtom<D> {
  // At D = 256 dQ alone is 128 registers a thread, so S and dP are m64n64
  // (32 each); Q, dO of 128 rows (128 KB) and two stages of K, V would not
  // fit in 227 KB, so a block is one warpgroup of 64 rows.
  static constexpr int kBlockM = D > 128 ? 64 : 128;   // query rows
  static constexpr int kBlockN = D > 128 ? 64 : 128;   // keys per K/V tile
  static constexpr int kThreads = 2 * kBlockM;         // one warpgroup per 64 rows
  static constexpr int kQBytes = kBlockM * D * 2;      // one of Q, dO (and O)
  static constexpr int kKVBytes = kBlockN * D * 2;     // one of K, V
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kStage0 = 2 * kQBytes;
  static constexpr int kDeltaOffset = kStage0 + kStages * kStageBytes;  // float[kBlockM]
  static constexpr int kBarOffset = kDeltaOffset + kBlockM * 4;
  // + 1 KB so the tiles can start on a 1024-byte boundary
  static constexpr size_t kSmem = (size_t)kBarOffset + 8 * (2 * kStages + 1) + 1024;
  static_assert(kStageBytes >= kQBytes, "O is staged in one K/V stage");
  static_assert(kSmem <= 232448, "a block's shared memory is 227 KB");
};

template <typename T, int D>
__global__ void __launch_bounds__(DqLayout<D>::kThreads, 1)
fa_bwd_dq_wgmma(const __grid_constant__ BwdParams p) {
  using L = DqLayout<D>;
  constexpr int kDqBlockM = L::kBlockM;
  constexpr int kDqBlockN = L::kBlockN;
  constexpr int kThreads = L::kThreads;
  constexpr int kNT = kDqBlockN / 8;  // n8 column groups of the S and dP tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sdO = base + L::kQBytes;
  float* const sDelta = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kDeltaOffset);
  const uint32_t bars = base + L::kBarOffset;
  // full[s] = bars + 8 s, empty[s] = bars + 8 (kStages + s), Q/dO/O = bars + 16 kStages
  const uint32_t q_bar = bars + 16 * kStages;

  const int n_qtiles = (p.Sq + kDqBlockM - 1) / kDqBlockM;
  const int q0 = (n_qtiles - 1 - blockIdx.x) * kDqBlockM;  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x;
  const int wg = tid / 128;  // this warpgroup's rows: [q0 + 64 wg, q0 + 64 wg + 64)
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int offset = p.Sk - p.Sq;

  const int n_tiles = (kv_limit(q0, kDqBlockM, p.Sq, p.Sk, p.causal) + kDqBlockN - 1) /
                      kDqBlockN;
  const int wq0 = q0 + kBox * wg;
  const int wg_tiles = wq0 >= p.Sq ? 0
      : (kv_limit(wq0, kBox, p.Sq, p.Sk, p.causal) + kDqBlockN - 1) / kDqBlockN;

  auto stage_k = [&](int s) { return base + L::kStage0 + s * L::kStageBytes; };
  auto load_kv = [&](int j) {  // tile j into stage j % kStages
    const int s = j % kStages;
    const uint32_t full = bars + 8 * s;
    mbar_arrive_expect_tx(full, L::kStageBytes);
    tma_load_tile<D>(stage_k(s), &p.tk, kDqBlockN, kBox, j * kDqBlockN, hk, b, full);
    tma_load_tile<D>(stage_k(s) + L::kKVBytes, &p.tv, kDqBlockN, kBox, j * kDqBlockN, hk, b,
                     full);
  };
  const uint32_t sO = stage_k(kStages - 1);  // O, until the prologue is done with it

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kThreads);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(q_bar, 3 * L::kQBytes);
    tma_load_tile<D>(sQ, &p.tq, kDqBlockM, kBox, q0, h, b, q_bar);
    tma_load_tile<D>(sdO, &p.tdo, kDqBlockM, kBox, q0, h, b, q_bar);
    tma_load_tile<D>(sO, &p.to, kDqBlockM, kBox, q0, h, b, q_bar);
    for (int j = 0; j < kStages - 1 && j < n_tiles; ++j) load_kv(j);
  }
  __syncwarp();

  // Prologue: delta = rowsum(dO * O) in fp32, two threads a row. dO and O
  // share one swizzled layout and the swizzle only permutes 16-byte chunks
  // within a row, so products of equal offsets pair equal elements and a row
  // sum is a sum over its chunks in any order; the order is staggered by row
  // so that neighbouring rows hit different banks.
  mbar_wait(q_bar, 0);
  {
    constexpr int kHalf = L::kRowBytes / 32;  // 16-byte chunks a thread takes per atom
    const int r = tid / 2;
    const int half = tid % 2;
    float sum = 0.f;
#pragma unroll
    for (int a = 0; a < L::kAtoms; ++a) {
      const uint32_t row = (a * kDqBlockM + r) * L::kRowBytes;
#pragma unroll
      for (int c = 0; c < kHalf; ++c) {
        const uint32_t off = row + (half * kHalf + (c + r) % kHalf) * 16;
        sum += dot8<T>(lds128(sdO + off), lds128(sO + off));
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      sDelta[r] = sum;
      if (q0 + r < p.Sq) p.delta[((long long)b * p.Hq + h) * p.Sq + q0 + r] = sum;
    }
  }
  __syncthreads();  // delta is visible, and every thread is done with O
  if (tid == 0 && kStages - 1 < n_tiles) load_kv(kStages - 1);
  __syncwarp();

  const int row_l[2] = {kBox * wg + warp * 16 + lane / 4, kBox * wg + warp * 16 + lane / 4 + 8};
  const int row[2] = {q0 + row_l[0], q0 + row_l[1]};
  const float scale_log2 = p.scale * kLog2e;
  float neg_lse[2], dlt[2];  // -LSE in log2 units (kBig past Sq: P = 0), delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    neg_lse[r] = row[r] < p.Sq
        ? -p.lse[((long long)b * p.Hq + h) * p.Sq + row[r]] * kLog2e : -kBig;
    dlt[r] = sDelta[row_l[r]];
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[kDqBlockN / 2], dp[kDqBlockN / 2];  // S (then P), dP (then dS)
#pragma unroll
  for (int i = 0; i < kDqBlockN / 2; ++i) sc[i] = dp[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    mbar_wait(bars + 8 * s, parity);
    __syncwarp();
    if (j < wg_tiles) {
      const uint32_t sK = stage_k(s);
      const uint32_t sV = sK + L::kKVBytes;
      // S = Q K^T and dP = dO V^T, two groups: the first overwrites (scale-d 0)
      wgmma_fence();
      fence_regs(sc);
      fence_regs(dp);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<T, kDqBlockN>(sc, kmajor_desc<D>(sQ, kDqBlockM, kBox * wg, kk),
                               kmajor_desc<D>(sK, kDqBlockN, 0, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<T, kDqBlockN>(dp, kmajor_desc<D>(sdO, kDqBlockM, kBox * wg, kk),
                               kmajor_desc<D>(sV, kDqBlockN, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);

      // P = exp2(S scale log2e - LSE log2e): a thread holds rows row[0],
      // row[1] at columns 8 i + 2 (lane % 4) + {0, 1} of each n8 group i
      const int k0 = j * kDqBlockN;
#pragma unroll
      for (int i = 0; i < kNT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[4 * i + e] = fmaf(sc[4 * i + e], scale_log2, neg_lse[e >> 1]);
      if ((k0 + kDqBlockN > p.Sk) || (p.causal && k0 + kDqBlockN - 1 > wq0 + offset)) {
        // one uniform branch, then selects: column 8 i + (e & 1) of this
        // thread's share is visible to row r iff it is below lim[r]
        int lim[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          lim[r] = (p.causal ? min(p.Sk, row[r] + offset + 1) : p.Sk) - k0 - 2 * (lane % 4);
#pragma unroll
        for (int i = 0; i < kNT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * i + (e & 1) >= lim[e >> 1]) sc[4 * i + e] = kNegBig;
      }
#pragma unroll
      for (int i = 0; i < kDqBlockN / 2; ++i) sc[i] = fast_exp2(sc[i]);

      // dS = P (dP - delta) scale, packed as the A operand of dQ += dS K
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < kNT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * i + e] = sc[4 * i + e] * (dp[4 * i + e] - dlt[e >> 1]) * p.scale;
      uint32_t ds[kDqBlockN / 16][4];
      pack_a<T, kDqBlockN>(ds, dp);
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int kc = 0; kc < kDqBlockN / 16; ++kc)
        wgmma_rs<T, D>(acc, ds[kc], mnmajor_desc<D>(sK, kDqBlockN, kc));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    // this thread is done with stage s; thread 0 refills it once every
    // consumer thread is
    mbar_arrive(bars + 8 * (kStages + s));
    if (tid == 0 && j + kStages < n_tiles) {
      mbar_wait(bars + 8 * (kStages + s), parity);
      load_kv(j + kStages);
    }
    __syncwarp();
  }

  T* const dQg = static_cast<T*>(p.dq) + ((long long)b * p.Sq * p.Hq + h) * D;
  store_rows<T, D>(dQg, (long long)p.Hq * D, row, p.Sq, acc, lane);
}

// ---------------------------------------------------------------------------
// dk/dv: 128 keys of one (b, kv head) a block, a warpgroup for each 64 of
// them, BQ-row Q/dO tiles; at D = 256 64 keys, each warpgroup holding half of
// the head dim of dK and dV
// ---------------------------------------------------------------------------
constexpr int kDkvThreads = 256;  // two warpgroups

template <int D>
struct DkvLayout : SwizzleAtom<D> {
  // At D = 256 dK and dV of 64 keys would be 128 registers a thread each:
  // both warpgroups take the block's 64 keys (each recomputes S^T and dP^T)
  // and each accumulates D / 2 columns of dK and dV, 64 registers each, as
  // at D = 128. K and V of 128 keys (128 KB) would not fit beside two stages
  // either.
  static constexpr bool kSplitD = D > 128;
  static constexpr int kKeys = kSplitD ? 64 : 128;    // keys per block
  static constexpr int kAccN = kSplitD ? D / 2 : D;   // dK, dV columns a warpgroup
  static constexpr int kBQ = 64;                      // q rows per tile (registers, above)
  static constexpr int kKBytes = kKeys * D * 2;       // one of K, V
  static constexpr int kQBytes = kBQ * D * 2;         // one of Q, dO
  // one of LSE, delta: a box of kBQ + 4 floats from the 16-byte-aligned
  // element at or before the tile's first row (TMA reads a box from a
  // 16-byte-aligned address), 128-byte-aligned in the stage
  static constexpr int kRowsBox = kBQ + 4;
  static constexpr int kRowsStride = (kRowsBox * 4 + 127) / 128 * 128;
  static constexpr uint32_t kTx = 2 * kQBytes + 2 * kRowsBox * 4;
  static constexpr int kStageBytes =
      (2 * kQBytes + kRowsStride + kRowsBox * 4 + 1023) / 1024 * 1024;
  static constexpr int kStage0 = 2 * kKBytes;
  static constexpr int kBarOffset = kStage0 + kStages * kStageBytes;
  static constexpr size_t kSmem = (size_t)kBarOffset + 8 * (2 * kStages + 1) + 1024;
  static_assert(kSmem <= 232448, "a block's shared memory is 227 KB");
};

template <typename T, int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
fa_bwd_dkv_wgmma(const __grid_constant__ BwdParams p) {
  using L = DkvLayout<D>;
  constexpr int kThreads = kDkvThreads;
  constexpr int kDkvBlockN = L::kKeys;
  constexpr int kAccN = L::kAccN;
  constexpr int BQ = L::kBQ;
  constexpr int kNT = BQ / 8;  // n8 column groups (queries) of S^T and dP^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base;
  const uint32_t sV = base + L::kKBytes;
  const uint32_t bars = base + L::kBarOffset;
  // full[s] = bars + 8 s, empty[s] = bars + 8 (kStages + s), K/V = bars + 16 kStages
  const uint32_t kv_bar = bars + 16 * kStages;

  const int k0 = blockIdx.x * kDkvBlockN;  // causal: the longest key tiles first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = p.Hq / p.Hkv;
  const int tid = threadIdx.x;
  // this warpgroup's keys: [kw0, kw0 + 64); its dK, dV columns [col0, col0 + kAccN)
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int offset = p.Sk - p.Sq;
  const int kw0 = L::kSplitD ? k0 : k0 + kBox * wg;
  const int kw_row = kw0 - k0;               // its first row in the K, V tiles
  const int col0 = L::kSplitD ? wg * kAccN : 0;
  // the atom of the Q and dO tiles where column col0 starts
  const uint32_t col_off = (col0 / L::kCols) * BQ * L::kRowBytes;

  // q tiles from the first one with a query that sees the block's (or the
  // warpgroup's) first key; every q head of the group in turn
  const int n_q = (p.Sq + BQ - 1) / BQ;
  const int lo = p.causal ? max(k0 - offset, 0) / BQ : 0;
  const int wg_lo = p.causal ? max(kw0 - offset, 0) / BQ : 0;
  const int per_head = n_q - lo;
  const int n_iter = rep * per_head;
  const bool wg_live = kw0 < p.Sk;

  auto stage_q = [&](int s) { return base + L::kStage0 + s * L::kStageBytes; };
  auto load_q = [&](int it) {  // iteration it into stage it % kStages
    const int s = it % kStages;
    const uint32_t full = bars + 8 * s;
    const int h = hk * rep + it / per_head;
    const int q0 = (lo + it % per_head) * BQ;
    const int rows = ((b * p.Hq + h) * p.Sq + q0) & ~3;  // into the flat LSE, delta
    mbar_arrive_expect_tx(full, L::kTx);
    tma_load_tile<D>(stage_q(s), &p.tq, BQ, BQ, q0, h, b, full);
    tma_load_tile<D>(stage_q(s) + L::kQBytes, &p.tdo, BQ, BQ, q0, h, b, full);
    tma_load_1d(stage_q(s) + 2 * L::kQBytes, &p.tlse, full, rows);
    tma_load_1d(stage_q(s) + 2 * L::kQBytes + L::kRowsStride, &p.tdelta, full, rows);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kThreads);
    }
    mbar_init(kv_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(kv_bar, 2 * L::kKBytes);
    tma_load_tile<D>(sK, &p.tk, kDkvBlockN, kBox, k0, hk, b, kv_bar);
    tma_load_tile<D>(sV, &p.tv, kDkvBlockN, kBox, k0, hk, b, kv_bar);
    for (int it = 0; it < kStages && it < n_iter; ++it) load_q(it);
  }
  __syncwarp();

  const int key_l = warp * 16 + lane / 4;  // rows key_l, key_l + 8 of the warpgroup's 64
  const int key[2] = {kw0 + key_l, kw0 + key_l + 8};
  const float scale_log2 = p.scale * kLog2e;
  float dk[kAccN / 2], dv[kAccN / 2];
#pragma unroll
  for (int i = 0; i < kAccN / 2; ++i) dk[i] = dv[i] = 0.f;
  float st[BQ / 2], dpt[BQ / 2];  // S^T (then P^T), dP^T (then dS^T): rows keys
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.f;
  char* const smem = reinterpret_cast<char*>(smem_raw) + (base - raw);

  mbar_wait(kv_bar, 0);
  __syncwarp();
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const int qt = lo + it % per_head;
    const int h = hk * rep + it / per_head;
    mbar_wait(bars + 8 * s, parity);
    __syncwarp();
    if (wg_live && qt >= wg_lo) {
      const int q0 = qt * BQ;
      const uint32_t sQ = stage_q(s);
      const uint32_t sdO = sQ + L::kQBytes;
      // this tile's LSE and delta: row q0 + c at c (the box began up to 3
      // rows earlier)
      const int mis = ((b * p.Hq + h) * p.Sq + q0) & 3;
      const float* const sL = reinterpret_cast<const float*>(
          smem + L::kStage0 + s * L::kStageBytes + 2 * L::kQBytes) + mis;
      const float* const sDl = sL + L::kRowsStride / 4;
      // S^T = K Q^T and dP^T = V dO^T, two groups
      wgmma_fence();
      fence_regs(st);
      fence_regs(dpt);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<T, BQ>(st, kmajor_desc<D>(sK, kDkvBlockN, kw_row, kk),
                        kmajor_desc<D>(sQ, BQ, 0, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<T, BQ>(dpt, kmajor_desc<D>(sV, kDkvBlockN, kw_row, kk),
                        kmajor_desc<D>(sdO, BQ, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);

      // P^T = exp2(S^T scale log2e - LSE log2e): a thread holds keys key[0],
      // key[1] at queries 8 i + 2 (lane % 4) + {0, 1} of each n8 group i
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        const float* l = sL + 8 * i + 2 * (lane % 4);
        const float nl[2] = {-l[0] * kLog2e, -l[1] * kLog2e};
#pragma unroll
        for (int e = 0; e < 4; ++e) st[4 * i + e] = fmaf(st[4 * i + e], scale_log2, nl[e & 1]);
      }
      if ((kw0 + kBox > p.Sk) || (q0 + BQ > p.Sq) ||
          (p.causal && kw0 + kBox - 1 > q0 + offset)) {
        // one uniform branch, then selects: query 8 i + (e & 1) of this
        // thread's share sees key[r] iff it lies in [qlo[r], qhi[r])
        int qlo[2], qhi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          qlo[r] = (p.causal ? key[r] - offset - q0 : 0) - 2 * (lane % 4);
          qhi[r] = key[r] < p.Sk ? p.Sq - q0 - 2 * (lane % 4) : -(1 << 30);
        }
#pragma unroll
        for (int i = 0; i < kNT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * i + (e & 1);
            if (c < qlo[e >> 1] || c >= qhi[e >> 1]) st[4 * i + e] = kNegBig;
          }
      }
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) st[i] = fast_exp2(st[i]);

      // dS^T = P^T (dP^T - delta) scale
      wgmma_wait<0>();
      fence_regs(dpt);
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        const float* d = sDl + 8 * i + 2 * (lane % 4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * i + e] = st[4 * i + e] * (dpt[4 * i + e] - d[e & 1]) * p.scale;
      }
      // dV += P^T dO and dK += dS^T Q (columns [col0, col0 + kAccN)), one group
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
      pack_a<T, BQ>(pa, st);
      pack_a<T, BQ>(da, dpt);
      wgmma_fence();
      fence_regs(dv);
      fence_regs(dk);
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc)
        wgmma_rs<T, kAccN>(dv, pa[kc], mnmajor_desc<D>(sdO + col_off, BQ, kc));
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc)
        wgmma_rs<T, kAccN>(dk, da[kc], mnmajor_desc<D>(sQ + col_off, BQ, kc));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
    }
    mbar_arrive(bars + 8 * (kStages + s));
    if (tid == 0 && it + kStages < n_iter) {
      mbar_wait(bars + 8 * (kStages + s), parity);
      load_q(it + kStages);
    }
    __syncwarp();
  }

  const long long stride = (long long)p.Hkv * D;
  const long long head = ((long long)b * p.Sk * p.Hkv + hk) * D + col0;
  store_rows<T, kAccN>(static_cast<T*>(p.dk) + head, stride, key, p.Sk, dk, lane);
  store_rows<T, kAccN>(static_cast<T*>(p.dv) + head, stride, key, p.Sk, dv, lane);
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, full fp32 arithmetic
// ---------------------------------------------------------------------------
// 64-row tiles, 256 threads (four a row); 32-row tiles and 128 threads at
// D = 256, where 64-row tiles of Q, dO, K and V take 279,808 bytes of shared
// memory in dq (more in dk/dv), above a block's 227 KB
template <int D>
struct F32Tile {
  static constexpr int kM = D > 128 ? 32 : 64;  // dq: query rows a block; dk/dv: keys a block
  static constexpr int kN = kM;                 // dq: keys a k/v tile; dk/dv: queries a q tile
  static constexpr int kThreads = 4 * kM;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* o;
  const float* lse;  // (B, Hq, Sq) contiguous, natural log
  float* delta;      // (B, Hq, Sq) contiguous: written by dq, read by dk/dv
  void* dq;
  void* dk;
  void* dv;
  int B, Hq, Hkv, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

// Four threads per row of the block's kM rows. Thread (r, c) owns score
// columns c, c+4, ... of its row and output dims c, c+4, ...; odd pitches
// keep the column walks free of bank conflicts.
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, long long stride,
                                              int r0, int nrows, float mul) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < F32Tile<D>::kM * D; i += F32Tile<D>::kThreads) {
    const int rr = i / D, d = i % D;
    const int gr = r0 + rr;
    dst[rr * LD + d] = gr < nrows ? src[(long long)gr * stride + d] * mul : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(F32Tile<D>::kThreads)
fa_bwd_dq_f32(const Params p) {
  constexpr int kF32BlockM = F32Tile<D>::kM;
  constexpr int kF32BlockN = F32Tile<D>::kN;
  constexpr int LD = D + 1;
  constexpr int LDP = kF32BlockN + 1;
  constexpr int kCols = kF32BlockN / 4;
  constexpr int kDims = D / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // pre-scaled by scale
  float* sdO = sQ + kF32BlockM * LD;
  float* sK = sdO + kF32BlockM * LD;
  float* sV = sK + kF32BlockN * LD;
  float* sS = sV + kF32BlockN * LD;  // dS

  const int n_qtiles = (p.Sq + kF32BlockM - 1) / kF32BlockM;
  const int q0 = (n_qtiles - 1 - blockIdx.x) * kF32BlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int lr = threadIdx.x / 4;
  const int c4 = threadIdx.x % 4;
  const int r = q0 + lr;

  const float* Qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dOg = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* Og = static_cast<const float*>(p.o) + b * p.o_sb + h * p.o_sh;
  const float* Kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* Vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_rows_f32<D>(sQ, Qg, p.q_ss, q0, p.Sq, p.scale);
  load_rows_f32<D>(sdO, dOg, p.do_ss, q0, p.Sq, 1.f);

  // delta = rowsum(dO * O), the row's four threads a quarter each
  float dlt = 0.f;
  if (r < p.Sq) {
#pragma unroll
    for (int i = 0; i < kDims; ++i)
      dlt += dOg[(long long)r * p.do_ss + c4 + 4 * i] * Og[(long long)r * p.o_ss + c4 + 4 * i];
  }
  dlt += __shfl_xor_sync(0xffffffffu, dlt, 1);
  dlt += __shfl_xor_sync(0xffffffffu, dlt, 2);
  const long long idx = ((long long)b * p.Hq + h) * p.Sq + r;
  if (c4 == 0 && r < p.Sq) p.delta[idx] = dlt;
  const float lse = r < p.Sq ? p.lse[idx] : 0.f;
  const int offset = p.Sk - p.Sq;
  float acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) acc[i] = 0.f;

  const int n_tiles = (kv_limit(q0, kF32BlockM, p.Sq, p.Sk, p.causal) + kF32BlockN - 1) /
                      kF32BlockN;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kF32BlockN;
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
    for (int c = 0; c < kF32BlockN; ++c) {
      const float ds = sS[lr * LDP + c];
      const float* kr = sK + c * LD + c4;
#pragma unroll
      for (int i = 0; i < kDims; ++i) acc[i] = fmaf(ds, kr[4 * i], acc[i]);
    }
  }

  if (r < p.Sq) {
    float* dQg = static_cast<float*>(p.dq) + ((long long)b * p.Sq + r) * p.Hq * D + h * D;
#pragma unroll
    for (int i = 0; i < kDims; ++i) dQg[c4 + 4 * i] = acc[i];
  }
}

template <int D>
__global__ void __launch_bounds__(F32Tile<D>::kThreads)
fa_bwd_dkv_f32(const Params p) {
  constexpr int kF32BlockM = F32Tile<D>::kM;
  constexpr int kF32BlockN = F32Tile<D>::kN;
  constexpr int LD = D + 1;
  constexpr int LDP = kF32BlockN + 1;
  constexpr int kCols = kF32BlockN / 4;  // queries of a q tile a thread owns
  constexpr int kDims = D / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);  // pre-scaled by scale
  float* sV = sK + kF32BlockM * LD;
  float* sQ = sV + kF32BlockM * LD;
  float* sdO = sQ + kF32BlockN * LD;
  float* sP = sdO + kF32BlockN * LD;   // P^T
  float* sS = sP + kF32BlockM * LDP;   // dS^T
  float* sL = sS + kF32BlockM * LDP;
  float* sDl = sL + kF32BlockN;

  const int k0 = blockIdx.x * kF32BlockM;
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

  const int n_q = (p.Sq + kF32BlockN - 1) / kF32BlockN;
  const int lo = p.causal ? max(k0 - offset, 0) / kF32BlockN : 0;
  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    const float* Qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* dOg = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int qt = lo; qt < n_q; ++qt) {
      const int q0 = qt * kF32BlockN;
      __syncthreads();
      load_rows_f32<D>(sQ, Qg, p.q_ss, q0, p.Sq, 1.f);
      load_rows_f32<D>(sdO, dOg, p.do_ss, q0, p.Sq, 1.f);
      for (int i = threadIdx.x; i < kF32BlockN; i += F32Tile<D>::kThreads) {
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
      for (int qq = 0; qq < kF32BlockN; ++qq) {
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
    const long long at = ((long long)b * p.Sk + c) * p.Hkv * D + hk * D;
    float* dKg = static_cast<float*>(p.dk) + at;
    float* dVg = static_cast<float*>(p.dv) + at;
#pragma unroll
    for (int i = 0; i < kDims; ++i) {
      dKg[c4 + 4 * i] = dk[i];
      dVg[c4 + 4 * i] = dv[i];
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
// A refused launch is reported only by cudaGetLastError.
template <typename Kernel, typename P>
cudaError_t launch(Kernel kernel, bool* configured, dim3 grid, int threads, size_t smem,
                   const P& p, cudaStream_t stream) {
  const cudaError_t err = grant_smem(kernel, configured, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The 16-bit kernels' parameters: tensor maps over the inputs (Q/dO boxes of
// `q_rows` rows, the others of kBox), LSE and delta as 1-d maps for dk/dv.
template <int D>
bool make_wg_params(BwdParams* w, const Params& a, CUtensorMapDataType dt, int q_rows,
                    bool rows_maps) {
  if (!encode_map<D>(&w->tq, dt, a.q, a.Sq, a.Hq, a.B, a.q_sb, a.q_ss, a.q_sh, q_rows) ||
      !encode_map<D>(&w->tdo, dt, a.dout, a.Sq, a.Hq, a.B, a.do_sb, a.do_ss, a.do_sh, q_rows) ||
      !encode_map<D>(&w->tk, dt, a.k, a.Sk, a.Hkv, a.B, a.k_sb, a.k_ss, a.k_sh, kBox) ||
      !encode_map<D>(&w->tv, dt, a.v, a.Sk, a.Hkv, a.B, a.v_sb, a.v_ss, a.v_sh, kBox))
    return false;
  if (a.o != nullptr &&
      !encode_map<D>(&w->to, dt, a.o, a.Sq, a.Hq, a.B, a.o_sb, a.o_ss, a.o_sh, q_rows))
    return false;
  const long long rows = (long long)a.B * a.Hq * a.Sq;
  if (rows_maps && (!encode_map_f32(&w->tlse, a.lse, rows, DkvLayout<D>::kRowsBox) ||
                    !encode_map_f32(&w->tdelta, a.delta, rows, DkvLayout<D>::kRowsBox)))
    return false;
  w->lse = a.lse;
  w->delta = a.delta;
  w->dq = a.dq;
  w->dk = a.dk;
  w->dv = a.dv;
  w->Hq = a.Hq; w->Hkv = a.Hkv; w->Sq = a.Sq; w->Sk = a.Sk;
  w->scale = a.scale;
  w->causal = a.causal;
  return true;
}

template <typename T, int D>
cudaError_t launch_dq_wgmma(const Params& a, CUtensorMapDataType dt, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  BwdParams w;
  if (!make_wg_params<D>(&w, a, dt, kBox, false)) return cudaErrorInvalidValue;
  using L = DqLayout<D>;
  const dim3 grid((a.Sq + L::kBlockM - 1) / L::kBlockM, a.Hq, a.B);
  return launch(fa_bwd_dq_wgmma<T, D>, configured, grid, L::kThreads, L::kSmem, w, stream);
}

template <typename T, int D>
cudaError_t launch_dkv_wgmma(const Params& a, CUtensorMapDataType dt, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  BwdParams w;
  if (!make_wg_params<D>(&w, a, dt, DkvLayout<D>::kBQ, true)) return cudaErrorInvalidValue;
  using L = DkvLayout<D>;
  const dim3 grid((a.Sk + L::kKeys - 1) / L::kKeys, a.Hkv, a.B);
  return launch(fa_bwd_dkv_wgmma<T, D>, configured, grid, kDkvThreads, L::kSmem, w, stream);
}

template <int D>
cudaError_t launch_dq_f32(const Params& p, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  using F = F32Tile<D>;
  const size_t smem = ((size_t)(2 * F::kM + 2 * F::kN) * (D + 1) +
                       (size_t)F::kM * (F::kN + 1)) * sizeof(float);
  const dim3 grid((p.Sq + F::kM - 1) / F::kM, p.Hq, p.B);
  return launch(fa_bwd_dq_f32<D>, configured, grid, F::kThreads, smem, p, stream);
}

template <int D>
cudaError_t launch_dkv_f32(const Params& p, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  using F = F32Tile<D>;
  const size_t smem = ((size_t)(2 * F::kM + 2 * F::kN) * (D + 1) +
                       (size_t)2 * F::kM * (F::kN + 1) + 2 * F::kN) * sizeof(float);
  const dim3 grid((p.Sk + F::kM - 1) / F::kM, p.Hkv, p.B);
  return launch(fa_bwd_dkv_f32<D>, configured, grid, F::kThreads, smem, p, stream);
}

template <int D>
cudaError_t launch_dim(bool dq, int dtype, const Params& p, cudaStream_t s) {
  if (dtype == 2)
    return dq ? launch_dq_wgmma<__nv_bfloat16, D>(p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, s)
              : launch_dkv_wgmma<__nv_bfloat16, D>(p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, s);
  if (dtype == 1)
    return dq ? launch_dq_wgmma<__half, D>(p, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, s)
              : launch_dkv_wgmma<__half, D>(p, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, s);
  if (dtype == 0) return dq ? launch_dq_f32<D>(p, s) : launch_dkv_f32<D>(p, s);
  return cudaErrorInvalidValue;
}

int launch_bwd(bool dq, int dtype, int D, const Params& p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return (int)launch_dim<128>(dq, dtype, p, s);
  if (D == 64) return (int)launch_dim<64>(dq, dtype, p, s);
  if (D == 32) return (int)launch_dim<32>(dq, dtype, p, s);
  if (D == 96) return (int)launch_dim<96>(dq, dtype, p, s);
  if (D == 256) return (int)launch_dim<256>(dq, dtype, p, s);
  return (int)cudaErrorInvalidValue;
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, void* delta, int B, int Hq, int Hkv, int Sq, int Sk,
                   const long long* s, float scale, int causal) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.Sq = Sq; p.Sk = Sk;
  p.q_sb = s[0]; p.q_ss = s[1]; p.q_sh = s[2];
  p.k_sb = s[3]; p.k_ss = s[4]; p.k_sh = s[5];
  p.v_sb = s[6]; p.v_ss = s[7]; p.v_sh = s[8];
  p.do_sb = s[9]; p.do_ss = s[10]; p.do_sh = s[11];
  p.scale = scale; p.causal = causal;
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. Strides are in elements:
// (batch, seq, head) of q, k, v, dO (and O); the outputs are contiguous
// (B, S, H, D). For float16 and bfloat16 every input's base must be 16-byte
// aligned and its strides multiples of 16 bytes (TMA), LSE's and delta's
// base too. Each returns a cudaError_t (0 on success).
//
// dq: writes dq and delta = rowsum(dO * O) (B, Hq, Sq) fp32.
extern "C" int pt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* o,
    const void* lse, void* delta, void* dq, int dtype, int B, int Hq, int Hkv, int Sq,
    int Sk, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, void* stream) {
  const long long s[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh, do_sb, do_ss, do_sh};
  Params p = make_params(q, k, v, dout, lse, delta, B, Hq, Hkv, Sq, Sk, s, scale, causal);
  p.o = o; p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.dq = dq;
  return launch_bwd(true, dtype, D, p, stream);
}

// dk/dv: reads the delta the dq kernel wrote; dk and dv are summed over each
// GQA group.
extern "C" int pt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    void* delta, void* dk, void* dv, int dtype, int B, int Hq, int Hkv, int Sq, int Sk,
    int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh,
    float scale, int causal, void* stream) {
  const long long s[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh, do_sb, do_ss, do_sh};
  Params p = make_params(q, k, v, dout, lse, delta, B, Hq, Hkv, Sq, Sk, s, scale, causal);
  p.dk = dk;
  p.dv = dv;
  return launch_bwd(false, dtype, D, p, stream);
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
