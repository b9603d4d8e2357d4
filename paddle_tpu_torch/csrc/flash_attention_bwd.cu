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
// fp32 (`fa_bwd_dq_tf32`, `fa_bwd_dkv_tf32`, the same head dims), on the
// tensor cores with 3xTF32, which keeps fp32's accuracy (one TF32 pass keeps
// ~3 decimal digits and is not used):
//   * operations: each product is three tf32 passes, a_hi b_lo + a_lo b_hi +
//     a_hi b_hi in fp32, so the bound is the tensor cores' 495 TFLOP/s over
//     three passes, ~165 TFLOP/s of fp32 work (6 D flops a visible pair in
//     dq, 8 D in dk/dv, as above). The score products S = Q K^T and dP =
//     dO V^T (dk/dv: S^T = K Q^T, dP^T = V dO^T) run on tf32 wgmma: A (Q, dO;
//     K, V) from registers, split there (hi rounded to nearest, lo = x - hi),
//     B (the streamed K, V; Q, dO tile) from shared memory, where the tensor
//     cores read the fp32 words truncated to tf32 (hi) and a lo plane (x -
//     trunc(x)) that the block writes once a tile. tf32 wgmma reads B only
//     K-major (no transpose bit below 16 bits), so dQ += dS K, dV += P^T dO
//     and dK += dS^T Q, whose B (K, dO, Q) is MN-major, run on
//     mma.sync.m16n8k8: S and dP, as the wgmma accumulators lie, are their A
//     fragments in a permuted contraction order (see `sw`), and B is read as
//     32-bit words from the tile and its lo plane. P and dS never leave
//     registers. Each warp owns 16 rows (dq: queries; dk/dv: keys) of a
//     256-thread block of 128 rows, kN = 32 keys (queries) a tile; at
//     D = 256 two warpgroups take the same 64 rows, each summing half of dQ
//     (dK, dV) and each computing S and dP (kN = 16).
//   * bytes: Q, K, V, dO come by TMA with the 128-byte swizzle (32-column
//     atoms) into a ring of two stages with full/empty mbarriers, as in the
//     16-bit kernels, so every input must be 16-byte aligned with 16-byte
//     strides (the wrapper's one alignment copy); the wgmma A fragments are
//     ldmatrix reads, the MN-major B words 32-bit reads, all free of bank
//     conflicts. The dq kernel computes delta from dO in shared memory and O
//     read directly while the first K/V tiles arrive.
//   * order: the grid is (heads x batch, tiles) with the tile index slowest,
//     so every head's longest causal tile (dq: the last query rows; dk/dv:
//     the first keys) is issued before any head's next one.
//   On an H100 (700 W) at B8 S2048 H16 D128 causal, chip_smoke.py phase 5
//   reads dq 3.3 ms and dk/dv 5.2 (38% and 32% of the 3xTF32 bound) and
//   torch's memory-efficient fp32 backward 10.4 for both; the CUDA-core
//   kernels they replace took 28.6 and 23.7 (tools/flash_bwd_ab.py). Each
//   step of the design was kept over the one before in a same-card A/B:
//   every product on mma.sync (slower than torch's pair), the score products
//   on wgmma, B of the mma.sync products from the lo planes instead of split
//   in registers, one A set in dk/dv. Slower and not kept: lo rounded by a
//   second cvt.rna (the same error); 32-bit reads where ldmatrix reads; dk/dv
//   with two warps a 16-key group (one for S^T, P^T and dV, one for dP^T and
//   dK, P^T passed through shared memory: 16 warps at 128 registers, which
//   spill more); kN = 16 in dk/dv; the mma.sync loops rolled or unrolled by
//   2 (no spills, dq slower). Left for later: the MN-major products on wgmma
//   need transposed hi/lo copies of K (dO, Q), which do not fit beside two
//   stages at D = 128.
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
  const float* o;                   // fp32 dq: O, read directly for delta
  long long o_sb, o_ss, o_sh;
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
// fp32: 3xTF32 on the tensor cores (tf32 wgmma and mma.sync m16n8k8)
// ---------------------------------------------------------------------------
// The 3xTF32 building blocks (the splits, FragA, mma3, sw, load_a, tf32
// wgmma) are hopper.cuh's, shared with the fp32 forward kernel.

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

// The lo planes of a stage's two B tiles (the streamed K, V or Q, dO): x -
// (x as the tensor cores read it), in the tiles' own layout, written by the
// whole block and made visible to the wgmmas. The caller's barrier before it
// ensures the last tile's wgmmas are done with the buffer.
template <int kBytes, int kThreads>
__device__ __forceinline__ void write_lo_planes(float* lo, const float* tiles, int tid) {
  const float4* const src = reinterpret_cast<const float4*>(tiles);
  float4* const dst = reinterpret_cast<float4*>(lo);
  static_assert(kBytes % (16 * kThreads) == 0, "whole float4s a thread");
#pragma unroll
  for (int c = 0; c < kBytes / 16 / kThreads; ++c) {
    const int i = c * kThreads + tid;
    const float4 x = src[i];
    dst[i] = make_float4(x.x - tf32_trunc(x.x), x.y - tf32_trunc(x.y), x.z - tf32_trunc(x.z),
                         x.w - tf32_trunc(x.w));
  }
  fence_proxy_async();
  __syncthreads();
}

// The two score-like products of a warpgroup's 64 rows and a streamed tile's
// N rows, in 3xTF32 on tf32 wgmma: s = A0 B0^T, d = A1 B1^T (dq: S = Q K^T,
// dP = dO V^T; dk/dv: S^T = K Q^T, dP^T = V dO^T). A0, A1: the kept (R, D)
// tiles at a0, a1, the warp's rows from r0, split in registers per k8 step;
// B0, B1: the stage's tiles at b0, b1 and their lo planes at lo0, lo1.
// kSets A sets in turn: with two, step kk's loads overlap step kk - 1's
// wgmmas.
template <int kSets, int R, int N, int D>
__device__ __forceinline__ void score_products(float (&s)[N / 2], float (&d)[N / 2], uint32_t a0,
                                               uint32_t a1, uint32_t b0, uint32_t b1,
                                               uint32_t lo0, uint32_t lo1, int r0, int lane) {
  FragA fa[kSets], fb[kSets];
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    // set kk % kSets was last read by step kk - kSets's wgmmas, done since
    // the wait at step kk - kSets + 1
    FragA& x = fa[kk % kSets];
    FragA& y = fb[kk % kSets];
    load_a<R>(x, a0, r0, 8 * kk, lane);
    load_a<R>(y, a1, r0, 8 * kk, lane);
    wgmma_fence();
    fence_regs(s);
    fence_regs(d);
    wgmma_tf32(s, x.hi, f32_kmajor_desc<N>(lo0, kk), kk > 0);
    wgmma_tf32(s, x.lo, f32_kmajor_desc<N>(b0, kk), 1);
    wgmma_tf32(s, x.hi, f32_kmajor_desc<N>(b0, kk), 1);
    wgmma_tf32(d, y.hi, f32_kmajor_desc<N>(lo1, kk), kk > 0);
    wgmma_tf32(d, y.lo, f32_kmajor_desc<N>(b1, kk), 1);
    wgmma_tf32(d, y.hi, f32_kmajor_desc<N>(b1, kk), 1);
    wgmma_commit();
    wgmma_wait<kSets - 1>();
    // the set read by the step now done stays in its registers until here
    fence_frag(fa[(kk + 1) % kSets]);
    fence_frag(fb[(kk + 1) % kSets]);
  }
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(d);
}

// Store a warp's fp32 m16 x (8 kAccT) accumulator rows row[0], row[1]
// (skipped at or past nrows) at base + row * stride, columns 2 t, 2 t + 1 of
// each n8 group
template <int kAccT>
__device__ __forceinline__ void store_rows_f32(float* base, long long stride, const int (&row)[2],
                                               int nrows, const float (&acc)[kAccT][4], int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= nrows) continue;
    float* const out = base + (long long)row[r] * stride + 2 * t;
#pragma unroll
    for (int n = 0; n < kAccT; ++n)
      *reinterpret_cast<float2*>(out + 8 * n) = make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// dq's fp32 tiles. kRows: the query rows a block keeps in shared memory (Q
// and dO) for the whole loop, a warpgroup of four warps for each 64; at
// D = 256 two warpgroups take the same 64 rows, each computing their S and
// dP and summing half of the columns of dQ (dQ of 16 rows x 256 would be 128
// registers a thread beside S and dP); kN: keys of a streamed K/V tile. The
// lo planes (x - tf32(x)) of the tile's K and V, which the S and dP wgmmas
// read, have one buffer: the block rebuilds it at the top of each tile.
template <int D>
struct F32DqLayout {
  static constexpr bool kWide = D > 128;
  static constexpr int kSplit = kWide ? 2 : 1;
  static constexpr int kRows = kWide ? 64 : 128;
  static constexpr int kN = kWide ? 16 : 32;
  static constexpr int kThreads = 256;
  static constexpr int kAccN = D / kSplit;                      // dQ columns a warp
  static constexpr int kResBytes = kRows * D * 4;               // one of Q, dO
  static constexpr int kTileBytes = kN * D * 4;                 // one of K, V
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kStage0 = 2 * kResBytes;
  static constexpr int kLoOffset = kStage0 + kStages * kStageBytes;   // K_lo, V_lo
  static constexpr int kDeltaOffset = kLoOffset + kStageBytes;        // float[kRows]
  static constexpr int kBarOffset = kDeltaOffset + kRows * 4;
  static constexpr size_t kSmem = (size_t)kBarOffset + 8 * (2 * kStages + 1) + 1024;
  static_assert(D % 32 == 0, "tiles are whole 32-column atoms");
  static_assert(kThreads == 32 * (kRows / 16) * kSplit, "a warp for each 16 rows (and half)");
  static_assert(kSmem <= 232448, "a block's shared memory is 227 KB");
};

// dq: kRows query rows of one (b, q head) a block, kN-key K/V tiles streamed
// by TMA. S = Q K^T and dP = dO V^T run on tf32 wgmma (3 passes: Q_hi K_lo,
// Q_lo K_hi, Q_hi K_hi, K_hi = the tile as the tensor cores truncate it),
// dQ += dS K on mma.sync (K MN-major)
template <int D>
__global__ void __launch_bounds__(F32DqLayout<D>::kThreads, 1)
fa_bwd_dq_tf32(const __grid_constant__ BwdParams p) {
  using L = F32DqLayout<D>;
  constexpr int R = L::kRows;
  constexpr int N = L::kN;
  constexpr int kNT = N / 8;             // n8 groups of the S and dP tiles
  constexpr int kAccT = L::kAccN / 8;    // n8 groups of dQ a warp
  constexpr int kThreads = L::kThreads;
  constexpr int kPerRow = kThreads / R;  // threads a row in the delta prologue
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw);
  const float* const fbase = reinterpret_cast<const float*>(smem);
  const float* const sdO = fbase + R * D;
  float* const sLo = reinterpret_cast<float*>(smem + L::kLoOffset);
  float* const sDelta = reinterpret_cast<float*>(smem + L::kDeltaOffset);
  const uint32_t uLo = base + L::kLoOffset;
  const uint32_t bars = base + L::kBarOffset;
  // full[s] = bars + 8 s, empty[s] = bars + 8 (kStages + s), Q/dO = bars + 16 kStages
  const uint32_t q_bar = bars + 16 * kStages;

  // every head's longest tile before any head's next one
  const int n_qtiles = (p.Sq + R - 1) / R;
  const int q0 = (n_qtiles - 1 - (int)blockIdx.y) * R;
  const int h = blockIdx.x % p.Hq;
  const int b = blockIdx.x / p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wg = warp / 4;                         // warpgroup
  const int wg_r0 = L::kSplit == 1 ? 64 * wg : 0;  // its first row in the block
  const int wr0 = wg_r0 + 16 * (warp % 4);         // the warp's first row
  const int col0 = L::kSplit == 1 ? 0 : wg * L::kAccN;
  const int wq0 = q0 + wg_r0;
  const int offset = p.Sk - p.Sq;

  const int n_tiles = (kv_limit(q0, R, p.Sq, p.Sk, p.causal) + N - 1) / N;
  const int wg_tiles = wq0 >= p.Sq ? 0 : (kv_limit(wq0, 64, p.Sq, p.Sk, p.causal) + N - 1) / N;

  auto stage_k = [&](int s) { return base + L::kStage0 + s * L::kStageBytes; };
  auto load_kv = [&](int j) {  // tile j into stage j % kStages
    const int s = j % kStages;
    const uint32_t full = bars + 8 * s;
    mbar_arrive_expect_tx(full, 2 * L::kTileBytes);
    tma_load_f32<D>(stage_k(s), &p.tk, N, N, j * N, hk, b, full);
    tma_load_f32<D>(stage_k(s) + L::kTileBytes, &p.tv, N, N, j * N, hk, b, full);
  };

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
    mbar_arrive_expect_tx(q_bar, 2 * L::kResBytes);
    tma_load_f32<D>(base, &p.tq, R, R, q0, h, b, q_bar);
    tma_load_f32<D>(base + L::kResBytes, &p.tdo, R, R, q0, h, b, q_bar);
    for (int j = 0; j < kStages && j < n_tiles; ++j) load_kv(j);
  }
  __syncwarp();

  // Prologue: delta = rowsum(dO * O) in fp32, kPerRow threads a row: dO from
  // shared memory, O from global memory (16-byte rows: the wrapper's
  // alignment rule), while the first K/V tiles stream in. Rows past Sq get 0.
  mbar_wait(q_bar, 0);
  {
    constexpr int kCols = D / kPerRow;
    const int r = tid / kPerRow;
    const int part = tid % kPerRow;
    const int row = q0 + r;
    float sum = 0.f;
    if (row < p.Sq) {
      const float* og = p.o + (long long)b * p.o_sb + (long long)row * p.o_ss +
                        (long long)h * p.o_sh + part * kCols;
#pragma unroll
      for (int c = 0; c < kCols; c += 4) {
        const float4 x = *reinterpret_cast<const float4*>(sdO + sw<R>(r, part * kCols + c));
        const float4 y = *reinterpret_cast<const float4*>(og + c);
        sum += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
    }
#pragma unroll
    for (int m = 1; m < kPerRow; m *= 2) sum += __shfl_xor_sync(0xffffffffu, sum, m);
    if (part == 0) {
      sDelta[r] = sum;
      if (row < p.Sq) p.delta[((long long)b * p.Hq + h) * p.Sq + row] = sum;
    }
  }
  __syncthreads();

  const int row[2] = {q0 + wr0 + g, q0 + wr0 + g + 8};
  const float scale_log2 = p.scale * kLog2e;
  float neg_lse[2], dlt[2];  // -LSE in log2 units (kBig past Sq: P = 0), delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    neg_lse[r] = row[r] < p.Sq
        ? -p.lse[((long long)b * p.Hq + h) * p.Sq + row[r]] * kLog2e : -kBig;
    dlt[r] = sDelta[wr0 + g + 8 * r];
  }
  float acc[kAccT][4];
#pragma unroll
  for (int n = 0; n < kAccT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const uint32_t uK = stage_k(s);
    mbar_wait(bars + 8 * s, parity);
    __syncthreads();  // every warp is done with the last tile's lo planes
    write_lo_planes<L::kStageBytes, kThreads>(sLo, fbase + (uK - base) / 4, tid);
    if (j < wg_tiles) {
      // S = Q K^T and dP = dO V^T for the warpgroup's 64 rows
      float sc[N / 2], dp[N / 2];
      score_products<2, R, N, D>(sc, dp, base, base + L::kResBytes, uK, uK + L::kTileBytes, uLo,
                                 uLo + L::kTileBytes, wr0, lane);

      // P = exp2(S scale log2e - LSE log2e): a thread holds rows row[0],
      // row[1] (e >> 1) at columns 8 i + 2 t + (e & 1)
      const int k0 = j * N;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) sc[i] = fmaf(sc[i], scale_log2, neg_lse[(i >> 1) & 1]);
      if ((k0 + N > p.Sk) || (p.causal && k0 + N - 1 > q0 + wr0 + offset)) {
        int lim[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          lim[r] = (p.causal ? min(p.Sk, row[r] + offset + 1) : p.Sk) - k0 - 2 * t;
#pragma unroll
        for (int i = 0; i < kNT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * i + (e & 1) >= lim[e >> 1]) sc[4 * i + e] = kNegBig;
      }
      // dS = P (dP - delta) scale
#pragma unroll
      for (int i = 0; i < N / 2; ++i)
        dp[i] = fast_exp2(sc[i]) * (dp[i] - dlt[(i >> 1) & 1]) * p.scale;

      // dQ += dS K: contraction over the tile's keys, K MN-major (and its
      // lo plane)
      const float* const sK = fbase + (uK - base) / 4;
#pragma unroll
      for (int kc = 0; kc < kNT; ++kc) {
        FragA da;
        da.split(dp[4 * kc], dp[4 * kc + 2], dp[4 * kc + 1], dp[4 * kc + 3]);
#pragma unroll
        for (int n = 0; n < kAccT; ++n) {
          const int i0 = sw<N>(8 * kc + 2 * t, col0 + 8 * n + g);
          const int i1 = sw<N>(8 * kc + 2 * t + 1, col0 + 8 * n + g);
          mma3(acc[n], da, sK[i0], sK[i1], sLo[i0], sLo[i1]);
        }
      }
    }
    // this thread is done with stage s; thread 0 refills it once every
    // thread is
    mbar_arrive(bars + 8 * (kStages + s));
    if (tid == 0 && j + kStages < n_tiles) {
      mbar_wait(bars + 8 * (kStages + s), parity);
      load_kv(j + kStages);
    }
    __syncwarp();
  }

  store_rows_f32<kAccT>(static_cast<float*>(p.dq) + ((long long)b * p.Sq * p.Hq + h) * D + col0,
                        (long long)p.Hq * D, row, p.Sq, acc, t);
}

// dk/dv's fp32 tiles. kRows: the keys a block keeps in shared memory (K and
// V) for the whole loop, a warpgroup of four warps for each 64; at D = 256
// two warpgroups take the same 64 keys, each computing their S^T and dP^T and
// summing half of the columns of dK and dV (dK and dV of 16 keys x 256 would
// be 256 registers a thread); kN: queries of a streamed Q/dO tile. The lo
// planes of the tile's Q and dO, which the S^T and dP^T wgmmas read, have one
// buffer, rebuilt at the top of each tile.
template <int D>
struct F32DkvLayout {
  static constexpr bool kWide = D > 128;
  static constexpr int kSplit = kWide ? 2 : 1;
  static constexpr int kRows = kWide ? 64 : 128;
  static constexpr int kN = kWide ? 16 : 32;
  static constexpr int kThreads = 256;
  static constexpr int kAccN = D / kSplit;                      // dK, dV columns a warp
  static constexpr int kResBytes = kRows * D * 4;               // one of K, V
  static constexpr int kTileBytes = kN * D * 4;                 // one of Q, dO
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kStage0 = 2 * kResBytes;
  static constexpr int kLoOffset = kStage0 + kStages * kStageBytes;  // Q_lo, dO_lo
  // a stage's LSE and delta, each a box of kN + 4 floats from the
  // 16-byte-aligned element at or before the tile's first row
  static constexpr int kRowsBox = kN + 4;
  static constexpr int kRowsStride = (kRowsBox * 4 + 127) / 128 * 128;
  static constexpr int kRowsOffset = kLoOffset + kStageBytes;
  static constexpr int kBarOffset = kRowsOffset + kStages * 2 * kRowsStride;
  static constexpr size_t kSmem = (size_t)kBarOffset + 8 * (2 * kStages + 1) + 1024;
  static_assert(D % 32 == 0, "tiles are whole 32-column atoms");
  static_assert(kThreads == 32 * (kRows / 16) * kSplit, "a warp for each 16 keys (and half)");
  static_assert(kSmem <= 232448, "a block's shared memory is 227 KB");
};

// dk/dv: kRows keys of one (b, kv head) a block, kN-row Q/dO tiles (with
// their LSE and delta rows) streamed by TMA over every q head of the GQA
// group; dK and dV are summed over the group in registers. S^T = K Q^T and
// dP^T = V dO^T run on tf32 wgmma (3 passes, Q and dO as the tensor cores
// truncate them and their lo planes), dV += P^T dO and dK += dS^T Q on
// mma.sync (dO and Q MN-major)
template <int D>
__global__ void __launch_bounds__(F32DkvLayout<D>::kThreads, 1)
fa_bwd_dkv_tf32(const __grid_constant__ BwdParams p) {
  using L = F32DkvLayout<D>;
  constexpr int R = L::kRows;
  constexpr int N = L::kN;
  constexpr int kNT = N / 8;           // n8 groups (queries) of S^T and dP^T
  constexpr int kAccT = L::kAccN / 8;  // n8 groups of dK and dV a warp
  constexpr int kThreads = L::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw);
  const float* const fbase = reinterpret_cast<const float*>(smem);
  float* const sLo = reinterpret_cast<float*>(smem + L::kLoOffset);
  const uint32_t uLo = base + L::kLoOffset;
  const uint32_t bars = base + L::kBarOffset;
  // full[s] = bars + 8 s, empty[s] = bars + 8 (kStages + s), K/V = bars + 16 kStages
  const uint32_t kv_bar = bars + 16 * kStages;

  const int k0 = blockIdx.y * R;  // causal: every head's longest key tile first
  const int hk = blockIdx.x % p.Hkv;
  const int b = blockIdx.x / p.Hkv;
  const int rep = p.Hq / p.Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wg = warp / 4;                         // warpgroup
  const int wg_r0 = L::kSplit == 1 ? 64 * wg : 0;  // its first key in the block
  const int wr0 = wg_r0 + 16 * (warp % 4);         // the warp's first key
  const int col0 = L::kSplit == 1 ? 0 : wg * L::kAccN;
  const int kw0 = k0 + wr0;
  const int kg0 = k0 + wg_r0;
  const int offset = p.Sk - p.Sq;

  // q tiles from the first one with a query that sees the block's (the
  // warpgroup's) first key; every q head of the group in turn
  const int n_q = (p.Sq + N - 1) / N;
  const int lo = p.causal ? max(k0 - offset, 0) / N : 0;
  const int wg_lo = p.causal ? max(kg0 - offset, 0) / N : 0;
  const int per_head = n_q - lo;
  const int n_iter = rep * per_head;
  const bool wg_live = kg0 < p.Sk;

  auto stage_q = [&](int s) { return base + L::kStage0 + s * L::kStageBytes; };
  auto stage_rows = [&](int s) { return base + L::kRowsOffset + s * 2 * L::kRowsStride; };
  auto load_q = [&](int it) {  // iteration it into stage it % kStages
    const int s = it % kStages;
    const uint32_t full = bars + 8 * s;
    const int h = hk * rep + it / per_head;
    const int q0 = (lo + it % per_head) * N;
    const int rows = ((b * p.Hq + h) * p.Sq + q0) & ~3;  // into the flat LSE, delta
    mbar_arrive_expect_tx(full, 2 * L::kTileBytes + 2 * L::kRowsBox * 4);
    tma_load_f32<D>(stage_q(s), &p.tq, N, N, q0, h, b, full);
    tma_load_f32<D>(stage_q(s) + L::kTileBytes, &p.tdo, N, N, q0, h, b, full);
    tma_load_1d(stage_rows(s), &p.tlse, full, rows);
    tma_load_1d(stage_rows(s) + L::kRowsStride, &p.tdelta, full, rows);
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
    mbar_arrive_expect_tx(kv_bar, 2 * L::kResBytes);
    tma_load_f32<D>(base, &p.tk, R, R, k0, hk, b, kv_bar);
    tma_load_f32<D>(base + L::kResBytes, &p.tv, R, R, k0, hk, b, kv_bar);
    for (int it = 0; it < kStages && it < n_iter; ++it) load_q(it);
  }
  __syncwarp();

  const int key[2] = {kw0 + g, kw0 + g + 8};
  const float scale_log2 = p.scale * kLog2e;
  float dk[kAccT][4], dv[kAccT][4];
#pragma unroll
  for (int n = 0; n < kAccT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  mbar_wait(kv_bar, 0);
  __syncwarp();
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const int qt = lo + it % per_head;
    const int h = hk * rep + it / per_head;
    const uint32_t uQ = stage_q(s);
    mbar_wait(bars + 8 * s, parity);
    __syncthreads();  // every warp is done with the last tile's lo planes
    write_lo_planes<L::kStageBytes, kThreads>(sLo, fbase + (uQ - base) / 4, tid);
    if (wg_live && qt >= wg_lo) {
      const int q0 = qt * N;
      const float* const sQ = fbase + (uQ - base) / 4;
      const float* const sdO = sQ + L::kTileBytes / 4;
      // this tile's LSE and delta: row q0 + c at c (the box began up to 3
      // rows earlier)
      const float* const sL = fbase + (stage_rows(s) - base) / 4 +
                              (((b * p.Hq + h) * p.Sq + q0) & 3);
      const float* const sDl = sL + L::kRowsStride / 4;
      // S^T = K Q^T and dP^T = V dO^T for the warpgroup's 64 keys, one A set
      // (dK and dV hold 128 registers a thread; two sets, as in dq, were
      // slower)
      float st[N / 2], dpt[N / 2];
      score_products<1, R, N, D>(st, dpt, base, base + L::kResBytes, uQ, uQ + L::kTileBytes,
                                 uLo, uLo + L::kTileBytes, wr0, lane);

      // P^T = exp2(S^T scale log2e - LSE log2e): a thread holds keys key[0],
      // key[1] (e >> 1) at queries 8 i + 2 t + (e & 1)
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        const float* l = sL + 8 * i + 2 * t;
        const float nl[2] = {-l[0] * kLog2e, -l[1] * kLog2e};
#pragma unroll
        for (int e = 0; e < 4; ++e) st[4 * i + e] = fmaf(st[4 * i + e], scale_log2, nl[e & 1]);
      }
      if ((kw0 + 16 > p.Sk) || (q0 + N > p.Sq) || (p.causal && kw0 + 15 > q0 + offset)) {
        // query 8 i + (e & 1) of this thread's share sees key[r] iff it lies
        // in [qlo[r], qhi[r])
        int qlo[2], qhi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          qlo[r] = (p.causal ? key[r] - offset - q0 : 0) - 2 * t;
          qhi[r] = key[r] < p.Sk ? p.Sq - q0 - 2 * t : -(1 << 30);
        }
#pragma unroll
        for (int i = 0; i < kNT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * i + (e & 1);
            if (c < qlo[e >> 1] || c >= qhi[e >> 1]) st[4 * i + e] = kNegBig;
          }
      }
      // P^T, then dS^T = P^T (dP^T - delta) scale
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        const float* dd = sDl + 8 * i + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[4 * i + e] = fast_exp2(st[4 * i + e]);
          dpt[4 * i + e] = st[4 * i + e] * (dpt[4 * i + e] - dd[e & 1]) * p.scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q: contraction over the tile's queries,
      // dO and Q MN-major (and their lo planes), columns [col0, col0 + kAccN)
      const float* const sQlo = sLo;
      const float* const sdOlo = sLo + L::kTileBytes / 4;
#pragma unroll
      for (int kc = 0; kc < kNT; ++kc) {
        FragA pa, da;
        pa.split(st[4 * kc], st[4 * kc + 2], st[4 * kc + 1], st[4 * kc + 3]);
        da.split(dpt[4 * kc], dpt[4 * kc + 2], dpt[4 * kc + 1], dpt[4 * kc + 3]);
#pragma unroll
        for (int n = 0; n < kAccT; ++n) {
          const int i0 = sw<N>(8 * kc + 2 * t, col0 + 8 * n + g);
          const int i1 = sw<N>(8 * kc + 2 * t + 1, col0 + 8 * n + g);
          mma3(dv[n], pa, sdO[i0], sdO[i1], sdOlo[i0], sdOlo[i1]);
          mma3(dk[n], da, sQ[i0], sQ[i1], sQlo[i0], sQlo[i1]);
        }
      }
    }
    mbar_arrive(bars + 8 * (kStages + s));
    if (tid == 0 && it + kStages < n_iter) {
      mbar_wait(bars + 8 * (kStages + s), parity);
      load_q(it + kStages);
    }
    __syncwarp();
  }

  const long long head = ((long long)b * p.Sk * p.Hkv + hk) * D + col0;
  store_rows_f32<kAccT>(static_cast<float*>(p.dk) + head, (long long)p.Hkv * D, key, p.Sk, dk, t);
  store_rows_f32<kAccT>(static_cast<float*>(p.dv) + head, (long long)p.Hkv * D, key, p.Sk, dv, t);
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

// The fp32 kernels' parameters: 128-byte-swizzled fp32 tensor maps over
// q and dO (boxes of `q_rows` rows) and k and v (`k_rows`), LSE and delta as
// 1-d maps for dk/dv, O's pointer and strides for dq.
template <int D>
bool make_f32_params(BwdParams* w, const Params& a, int q_rows, int k_rows, bool rows_maps) {
  if (!encode_map_f32_tile<D>(&w->tq, a.q, a.Sq, a.Hq, a.B, a.q_sb, a.q_ss, a.q_sh, q_rows) ||
      !encode_map_f32_tile<D>(&w->tdo, a.dout, a.Sq, a.Hq, a.B, a.do_sb, a.do_ss, a.do_sh,
                              q_rows) ||
      !encode_map_f32_tile<D>(&w->tk, a.k, a.Sk, a.Hkv, a.B, a.k_sb, a.k_ss, a.k_sh, k_rows) ||
      !encode_map_f32_tile<D>(&w->tv, a.v, a.Sk, a.Hkv, a.B, a.v_sb, a.v_ss, a.v_sh, k_rows))
    return false;
  const long long rows = (long long)a.B * a.Hq * a.Sq;
  if (rows_maps && (!encode_map_f32(&w->tlse, a.lse, rows, F32DkvLayout<D>::kRowsBox) ||
                    !encode_map_f32(&w->tdelta, a.delta, rows, F32DkvLayout<D>::kRowsBox)))
    return false;
  w->o = static_cast<const float*>(a.o);
  w->o_sb = a.o_sb; w->o_ss = a.o_ss; w->o_sh = a.o_sh;
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

// grid (heads x batch, tiles): the tile index varies slowest, so every
// head's longest tile is issued before any head's next one
template <int D>
cudaError_t launch_dq_tf32(const Params& a, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  using L = F32DqLayout<D>;
  BwdParams w = {};
  if (!make_f32_params<D>(&w, a, L::kRows, L::kN, false)) return cudaErrorInvalidValue;
  const dim3 grid(a.Hq * a.B, (a.Sq + L::kRows - 1) / L::kRows);
  return launch(fa_bwd_dq_tf32<D>, configured, grid, L::kThreads, L::kSmem, w, stream);
}

template <int D>
cudaError_t launch_dkv_tf32(const Params& a, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  using L = F32DkvLayout<D>;
  BwdParams w = {};
  if (!make_f32_params<D>(&w, a, L::kN, L::kRows, true)) return cudaErrorInvalidValue;
  const dim3 grid(a.Hkv * a.B, (a.Sk + L::kRows - 1) / L::kRows);
  return launch(fa_bwd_dkv_tf32<D>, configured, grid, L::kThreads, L::kSmem, w, stream);
}

template <int D>
cudaError_t launch_dim(bool dq, int dtype, const Params& p, cudaStream_t s) {
  if (dtype == 2)
    return dq ? launch_dq_wgmma<__nv_bfloat16, D>(p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, s)
              : launch_dkv_wgmma<__nv_bfloat16, D>(p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, s);
  if (dtype == 1)
    return dq ? launch_dq_wgmma<__half, D>(p, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, s)
              : launch_dkv_wgmma<__half, D>(p, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, s);
  if (dtype == 0) return dq ? launch_dq_tf32<D>(p, s) : launch_dkv_tf32<D>(p, s);
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
// (B, S, H, D). Every input's base must be 16-byte aligned and its strides
// multiples of 16 bytes (TMA), LSE's and delta's base too. Each returns a
// cudaError_t (0 on success).
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
