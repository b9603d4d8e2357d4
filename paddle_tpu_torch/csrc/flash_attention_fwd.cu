// Flash-attention forward for Hopper (sm_90a), bound to Python through a
// plain C entry point (ctypes; see paddle_tpu_torch/ops/cuda/_build.py).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py::_fwd_kernel (the
// Pallas TPU forward kernel launched by `_fwd`). Same function: online-
// softmax attention with fp32 running max / sum / accumulator, scores scaled
// in fp32, -1e30 masking, causal mask aligned bottom-right (key t is visible
// to query s iff t <= s + (Sk - Sq)), GQA kv head = h / (Hq / Hkv), and the
// per-row log-sum-exp (fp32, (B, Hq, Sq)) returned beside O for a backward.
//
// What bounds it on an H100: per (b, head) the kernel reads q, k, v once and
// writes o and lse once, and does 4*D flops per visible (query, key) pair.
// At serving prompt lengths (S=128, D=128) that is ~2 flop per byte, far
// below the ~295 flop/byte at which bf16 tensor cores become the limit, so
// the bound is HBM bytes; at S >= ~1k causal it is tensor-core flops.
//
// bf16 / fp16 (`fa_fwd_wgmma`, head dims 32, 64, 96, 128, 256; the wrapper
// zero-pads any other head dim up to 256 to the next of them), designed for
// Hopper:
//   * flops: both products run on wgmma, the only path to the card's full
//     tensor-core rate. A block is 128 query rows of one (b, q head) in two
//     warpgroups of 64 rows; each K/V tile in shared memory (128 keys, 64 at
//     D = 256) feeds both. S = Q K^T is m64n128k16 with Q and K from shared memory (both
//     K-major: D contiguous). O += P V is m64nDk16 with P from registers (the
//     fp32 score accumulator packed to 16-bit pairs: the m64 accumulator
//     layout is the A-register layout) and V from shared memory, D
//     contiguous, through the descriptor's transpose bit. The softmax is
//     branch-free in registers (exp2 on the special-function unit, masking
//     only on tiles that cross the diagonal or the end of the keys). The k/v
//     loop stops at the causal diagonal (per warpgroup), and causal q tiles
//     are issued longest first so the tail of the grid is short.
//   * bytes: Q, K and V are read straight from the caller's (B, S, H, D)
//     strides by TMA (one 4-d tensor map each, 128-byte swizzle, 64-byte at
//     D = 32 and 96, matching the wgmma descriptors); one thread issues the copies
//     and no thread spends registers on addresses. K/V tiles go through a
//     ring of two stages, each with a "full" mbarrier (TMA bytes) and an
//     "empty" one (every consumer thread past the wgmma that read it), so the
//     next tile streams in under the current tile's math. TMA zero-fills rows
//     past Sq and Sk; masking still gives those columns P = 0. Probabilities
//     never leave registers.
//   * shared memory at D = 128: Q 32 KB + 2 stages x (K + V) 64 KB = 160 KB of
//     the 227 KB. A third stage fits (224 KB) but measured no faster: with
//     the loads issued a tile ahead, the tile's math, not the copy, is what
//     the next tile waits for. D = 96: Q 24 KB + 96 KB, three 32-column atoms
//     a tile. D = 256: Q 64 KB + 2 x (K + V) 64 KB of 64-key tiles = 192 KB;
//     registers a thread: O 128, S 32 (the m64n64 score tile), P 16.
// Left for later (stage 2): a producer warp with setmaxnreg, and ping-pong of
// the two warpgroups so one's softmax runs under the other's products.
//
// fp32 (`fa_fwd_tf32`, the same head dims), on the tensor cores with 3xTF32,
// which keeps fp32's accuracy (one TF32 pass keeps ~3 decimal digits and is
// not used); the arithmetic is the fp32 backward kernels' (hopper.cuh):
//   * operations: each product is three tf32 passes, a_hi b_lo + a_lo b_hi +
//     a_hi b_hi in fp32, so the bound is the tensor cores' 495 TFLOP/s over
//     three passes, ~165 TFLOP/s of fp32 work (4 D flops a visible pair). Both
//     products run on tf32 wgmma, A from registers: S = Q K^T with Q split
//     there per k8 step (hi rounded to nearest, lo = x - hi; ldmatrix reads,
//     two A sets in turn so a step's reads overlap the last step's wgmmas)
//     and K from the stage, read truncated (hi), with a lo plane (x -
//     trunc(x)) that the block writes once a tile; O += P V with P split in
//     registers (its m64 accumulator columns 2 t, 2 t + 1 are the A fragment
//     in a permuted contraction order) and V from two planes the block writes
//     once a tile: V^T's hi and lo, (D, kN) with keys contiguous in that same
//     order (tf32 wgmma reads B only K-major). P never leaves registers. The
//     softmax is the 16-bit kernel's: exp2 on the special-function unit,
//     masking only on tiles that cross the diagonal or the end of the keys,
//     the key loop stopping at the diagonal per warpgroup. No atomics, no
//     split over keys: the result is deterministic.
//   * bytes: Q, K and V come by TMA with the fp32 128-byte swizzle (32-column
//     atoms) from the caller's strides into the Q tile and the K/V stage,
//     with full/empty mbarriers; the stage is released once the block has
//     built its planes and its S products are done, so the next tile
//     streams in under this one's softmax and P V. Every input must be
//     16-byte aligned with 16-byte strides (the wrapper copies what is not).
//   * tiles: 128 query rows a block (two warpgroups) and 64-key tiles, one
//     K/V stage: Q 64 KB + K and V 64 KB + K_lo 32 KB + V^T hi and lo 64 KB
//     (two 32-key atoms each) = 224 KB at D = 128; registers a thread: O 64,
//     S 32, P's split 64 (236 in all, no spill). At D = 256 64 rows (one
//     warpgroup) and 16-key tiles in two stages (V^T rows of 64 bytes,
//     64-byte swizzle): Q 64 KB + 64 + 16 + 32 = 176 KB, O 128 registers.
//   * order: the grid is (heads x batch, q tiles) with the tile index
//     slowest, so every head's longest causal tile is issued before any
//     head's next one.
//   On an H100 (700 W) at B8 S2048 H16 D128, tools/flash_fwd_ab.py against
//   the CUDA-core kernel this replaces reads 1.52-1.55 ms causal (12.70
//   before) and 2.70-2.83 non-causal (24.02), beside sdpa's fp32 3.23-3.30
//   and 6.01-6.12; chip_smoke.py phase 2 reads 1.43-1.45 ms, 57-58% of the
//   3xTF32 bound.
// The design was chosen with variant builds that are not in the repo, each
// against the one before in a same-card A/B (tools/flash_fwd_ab.py): P V on
// mma.sync m16n8k8 with V and its lo plane read as 32-bit words (the fp32
// backward's dQ/dK/dV design; every warp reads all of V twice a tile), then
// P V on wgmma against V^T's planes with 32-key tiles in two stages (176 KB),
// then the 64-key tiles in one stage kept here, each faster than the one
// before (m64n64 score wgmmas, half the barriers and Q splits a key). Left
// for later: the plane writes and the two block barriers a tile run with the
// tensor cores idle; a producer warpgroup could build the next tile's planes
// under this one's products (no shared memory is left at D = 128 for a
// second set of planes).
#include "flash_attention_common.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16 / fp16: wgmma fed by TMA
// ---------------------------------------------------------------------------
constexpr int kWgBlockM = 128;  // query rows per block: two warpgroups of 64
constexpr int kWgThreads = 256;
constexpr int kStages = 2;      // K/V stages in the ring

struct WgParams {
  CUtensorMap tq, tk, tv;  // (D, S, H, B) maps, box (atom columns, tile rows, 1, 1)
  void* o;
  float* lse;              // (B, Hq, Sq) contiguous
  int Hq, Hkv, Sq, Sk;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

// Shared-memory layout of one head dim: the Q tile, then the K/V stages, each
// tile in swizzled column atoms (SwizzleAtom, hopper.cuh). K/V tiles are 128
// keys, or 64 at D = 256: there the m64n256 O accumulator is 128 registers a
// thread (S of 64 keys adds 32, of 128 keys 64), and Q 64 KB + two stages of
// 128-key K and V (256 KB) would not fit in a block's 227 KB.
template <int D>
struct WgLayout : SwizzleAtom<D> {
  static constexpr int kBlockN = D > 128 ? 64 : 128;              // keys per K/V tile
  static constexpr int kQBytes = kWgBlockM * D * 2;
  static constexpr int kKVBytes = kBlockN * D * 2;                // one of K, V
  static constexpr int kBarOffset = kQBytes + kStages * 2 * kKVBytes;
  // + 1 KB so the tiles can start on a 1024-byte boundary
  static constexpr size_t kSmem = (size_t)kBarOffset + 8 * (2 * kStages + 1) + 1024;
  static_assert(kSmem <= 232448, "a block's shared memory is 227 KB");
};

template <typename T, int D>
__global__ void __launch_bounds__(kWgThreads, 1)
fa_fwd_wgmma(const __grid_constant__ WgParams p) {
  using L = WgLayout<D>;
  constexpr int kBlockN = L::kBlockN;
  constexpr int kNT = kBlockN / 8;    // n8 column groups of the score tile
  constexpr int kDT = D / 8;          // n8 column groups of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t bars = base + L::kBarOffset;
  // full[s] = bars + 8 s, empty[s] = bars + 8 (kStages + s), Q = bars + 16 kStages
  const uint32_t q_bar = bars + 16 * kStages;

  const int n_qtiles = (p.Sq + kWgBlockM - 1) / kWgBlockM;
  const int q0 = (n_qtiles - 1 - blockIdx.x) * kWgBlockM;  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x;
  const int wg = tid / 128;  // this warpgroup's rows: [q0 + 64 wg, q0 + 64 wg + 64)
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int offset = p.Sk - p.Sq;

  const int n_tiles = (kv_limit(q0, kWgBlockM, p.Sq, p.Sk, p.causal) + kBlockN - 1) /
                      kBlockN;
  const int wq0 = q0 + 64 * wg;
  const int wg_tiles = wq0 >= p.Sq ? 0
      : (kv_limit(wq0, 64, p.Sq, p.Sk, p.causal) + kBlockN - 1) / kBlockN;

  auto stage_k = [&](int s) { return base + L::kQBytes + s * 2 * L::kKVBytes; };
  auto load_kv = [&](int j) {  // tile j into stage j % kStages
    const int s = j % kStages;
    const uint32_t full = bars + 8 * s;
    mbar_arrive_expect_tx(full, 2 * L::kKVBytes);
    tma_load_tile<D>(stage_k(s), &p.tk, kBlockN, kBlockN, j * kBlockN, hk, b, full);
    tma_load_tile<D>(stage_k(s) + L::kKVBytes, &p.tv, kBlockN, kBlockN, j * kBlockN, hk, b,
                     full);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kWgThreads);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(q_bar, L::kQBytes);
    tma_load_tile<D>(sQ, &p.tq, kWgBlockM, kWgBlockM, q0, h, b, q_bar);
    for (int j = 0; j < kStages && j < n_tiles; ++j) load_kv(j);
  }
  __syncwarp();

  const int row[2] = {wq0 + warp * 16 + lane / 4, wq0 + warp * 16 + lane / 4 + 8};
  const float scale_log2 = p.scale * kLog2e;
  float m_i[2] = {kNegBig, kNegBig};  // running max, log2 units
  float l_i[2] = {0.f, 0.f};          // this thread's share of the row sum
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[kBlockN / 2];  // this tile's scores, then its probabilities
#pragma unroll
  for (int i = 0; i < kBlockN / 2; ++i) sc[i] = 0.f;
  // this warpgroup's 64 rows in each Q atom
  const uint32_t q_wg = sQ + wg * 64 * L::kRowBytes;

  mbar_wait(q_bar, 0);
  __syncwarp();
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    mbar_wait(bars + 8 * s, parity);
    __syncwarp();
    if (j < wg_tiles) {
      const uint32_t sK = stage_k(s);
      const uint32_t sV = sK + L::kKVBytes;
      // S = Q K^T: D / 16 k-steps, each 32 bytes further along a swizzled
      // row; the first overwrites sc (scale-d 0)
      wgmma_fence();
      fence_regs(sc);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a_off = (kk / L::kKPerAtom) * kWgBlockM * L::kRowBytes +
                               (kk % L::kKPerAtom) * 32;
        const uint32_t b_off = (kk / L::kKPerAtom) * kBlockN * L::kRowBytes +
                               (kk % L::kKPerAtom) * 32;
        wgmma_ss<T, kBlockN>(sc, wgmma_desc(q_wg + a_off, 16, 8 * L::kRowBytes, L::kSwizzle),
                    wgmma_desc(sK + b_off, 16, 8 * L::kRowBytes, L::kSwizzle), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // online softmax in registers: a thread holds rows row[0], row[1] at
      // columns 8 i + 2 (lane % 4) + {0, 1} of each n8 group i
      const int k0 = j * kBlockN;
#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) sc[i] *= scale_log2;
      if ((k0 + kBlockN > p.Sk) || (p.causal && k0 + kBlockN - 1 > wq0 + offset)) {
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
      float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
      for (int i = 0; i < kNT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * i + e]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // the first tile gives every row a visible key (key 0, as Sq <= Sk
        // when causal), so mx is a real score from then on and a masked
        // score's exp2(-1e30 - mx) is 0; alpha of the first tile is 0 (O and
        // l are still 0)
        alpha[r] = fast_exp2(m_i[r] - mx[r]);
        m_i[r] = mx[r];
        l_i[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = fast_exp2(sc[4 * i + e] - mx[e >> 1]);
          sc[4 * i + e] = pe;
          l_i[e >> 1] += pe;
        }
      }
      // the previous P V has completed (wait_group 0 below): rescale O
#pragma unroll
      for (int i = 0; i < kDT; ++i) {
        acc[4 * i + 0] *= alpha[0];
        acc[4 * i + 1] *= alpha[0];
        acc[4 * i + 2] *= alpha[1];
        acc[4 * i + 3] *= alpha[1];
      }
      // P as the A operand: score groups 2 kc and 2 kc + 1 are keys
      // 16 kc .. 16 kc + 15, in the m64k16 A-register layout
      uint32_t pa[kBlockN / 16][4];
#pragma unroll
      for (int kc = 0; kc < kBlockN / 16; ++kc) {
        pa[kc][0] = pack2<T>(sc[8 * kc + 0], sc[8 * kc + 1]);
        pa[kc][1] = pack2<T>(sc[8 * kc + 2], sc[8 * kc + 3]);
        pa[kc][2] = pack2<T>(sc[8 * kc + 4], sc[8 * kc + 5]);
        pa[kc][3] = pack2<T>(sc[8 * kc + 6], sc[8 * kc + 7]);
      }
      // O += P V: 16 keys a step (16 rows of every V atom); V atoms along D
      // are kBlockN rows apart (the descriptor's leading byte offset)
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int kc = 0; kc < kBlockN / 16; ++kc) {
        wgmma_rs<T, D>(acc, pa[kc],
                       wgmma_desc(sV + kc * 16 * L::kRowBytes, kBlockN * L::kRowBytes,
                                  8 * L::kRowBytes, L::kSwizzle));
      }
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

  // Epilogue: finish the row sums across the quad, normalise, store.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_safe = fmaxf(l, 1e-30f);
    const float inv = 1.f / l_safe;
    if (row[r] < p.Sq) {
      T* Og = static_cast<T*>(p.o) + b * p.o_sb + (long long)row[r] * p.o_ss + h * p.o_sh;
#pragma unroll
      for (int i = 0; i < kDT; ++i) {
        *reinterpret_cast<uint32_t*>(Og + i * 8 + 2 * (lane % 4)) =
            pack2<T>(acc[4 * i + 2 * r] * inv, acc[4 * i + 2 * r + 1] * inv);
      }
      if (lane % 4 == 0) {
        p.lse[((long long)b * p.Hq + h) * p.Sq + row[r]] = (m_i[r] + log2f(l_safe)) * kLn2;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: 3xTF32 on the tensor cores, both products on tf32 wgmma
// ---------------------------------------------------------------------------
// The fp32 kernel's tiles. kRows query rows a block, a warpgroup of four warps
// for each 64; kN keys a streamed K/V tile. Beside the Q tile and the K/V
// stage(s) the block keeps three planes, rebuilt at the top of each tile:
// K's lo plane (x - trunc(x), the B operand of S's Q_hi K_lo pass) and V^T's
// hi and lo planes (V transposed to (D, kN), keys contiguous, so that P V is a
// K-major wgmma; tf32 wgmma has no transpose bit). At D = 256 a block is 64
// rows and 16-key tiles in two stages: the m64n256 O accumulator is 128
// registers a thread, and larger tiles would not fit in 227 KB beside a
// 64-row Q. Below it 64-key tiles in a single stage: the next tile's copy
// lands under this one's softmax and P V.
template <int D>
struct F32FwdLayout {
  static constexpr bool kWide = D > 128;
  static constexpr int kRows = kWide ? 64 : 128;
  static constexpr int kN = kWide ? 16 : 64;
  static constexpr int kStages = kWide ? 2 : 1;       // K/V stages in the ring
  static constexpr int kThreads = 2 * kRows;          // a warp for each 16 rows
  // V^T's keys in atoms of at most 32 (one 128-byte swizzle row), each
  // (D, kAtomKeys) with rows of 4 kAtomKeys bytes
  static constexpr int kAtomKeys = kN < 32 ? kN : 32;
  static constexpr int kQBytes = kRows * D * 4;
  static constexpr int kTileBytes = kN * D * 4;       // one of K, V, K_lo, V^T hi, V^T lo
  static constexpr int kStageBytes = 2 * kTileBytes;  // K, V
  static constexpr int kKloOffset = kQBytes + kStages * kStageBytes;
  static constexpr int kVtOffset = kKloOffset + kTileBytes;  // V^T hi, then V^T lo
  static constexpr int kBarOffset = kVtOffset + 2 * kTileBytes;
  // + 1 KB so the tiles can start on a 1024-byte boundary
  static constexpr size_t kSmem = (size_t)kBarOffset + 8 * (2 * kStages + 1) + 1024;
  static constexpr int kKloPer = kTileBytes / 16 / kThreads;  // float4s of K_lo a thread
  static constexpr int kVtPer = D * kN / 4 / kThreads;        // 16-byte V^T chunks a thread
  static_assert(D % 32 == 0, "tiles are whole 32-column atoms");
  static_assert(kKloPer * 16 * kThreads == kTileBytes && kVtPer * 4 * kThreads == D * kN,
                "the planes split evenly over the threads");
  static_assert(kTileBytes % 1024 == 0, "every tile on a 1024-byte boundary");
  static_assert(kSmem <= 232448, "a block's shared memory is 227 KB");
};

// Byte offset of the 16-byte chunk c (keys 4 c .. 4 c + 3) of row d of a
// (D, kN) V^T plane: atoms of kAtomKeys keys, D rows each of kRowBytes = 4
// kAtomKeys (128 or 64) with the matching swizzle, the layout a K-major wgmma
// descriptor reads (address bits 4.. XORed with bits 7..).
template <int D, int kAtomKeys>
__device__ __forceinline__ int vt_chunk(int d, int c) {
  constexpr int kRowBytes = 4 * kAtomKeys;
  constexpr int kPerRow = kAtomKeys / 4;  // chunks a row
  const int addr = d * kRowBytes + 16 * (c % kPerRow);
  return (c / kPerRow) * D * kRowBytes + (addr ^ (((addr >> 7) & (kRowBytes / 16 - 1)) << 4));
}

// The K-major descriptor of k8 step kc (keys 8 kc .. 8 kc + 7) of a V^T plane
template <int D, int kAtomKeys>
__device__ __forceinline__ uint64_t vt_desc(uint32_t plane, int kc) {
  constexpr int kRowBytes = 4 * kAtomKeys;
  constexpr int kSteps = kAtomKeys / 8;  // k8 steps an atom
  return wgmma_desc(plane + (kc / kSteps) * D * kRowBytes + (kc % kSteps) * 32, 16,
                    8 * kRowBytes, kRowBytes == 128 ? 1 : 2);
}

// S = Q K^T for a warpgroup's 64 rows and a tile's N keys in 3xTF32 on tf32
// wgmma: Q from the (R, D) tile at q, the warp's rows from r0, split in
// registers per k8 step; K as the tensor cores truncate the stage's words at
// k and its lo plane at lo. Two A sets in turn, so that step kk's ldmatrix
// and split overlap step kk - 1's wgmmas.
template <int R, int N, int D>
__device__ __forceinline__ void score_product(float (&s)[N / 2], uint32_t q, uint32_t k,
                                              uint32_t lo, int r0, int lane) {
  FragA fa[2];
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    // set kk % 2 was last read by step kk - 2's wgmmas, done since the wait
    // at step kk - 1
    FragA& x = fa[kk % 2];
    load_a<R>(x, q, r0, 8 * kk, lane);
    wgmma_fence();
    fence_regs(s);
    wgmma_tf32(s, x.hi, f32_kmajor_desc<N>(lo, kk), kk > 0);
    wgmma_tf32(s, x.lo, f32_kmajor_desc<N>(k, kk), 1);
    wgmma_tf32(s, x.hi, f32_kmajor_desc<N>(k, kk), 1);
    wgmma_commit();
    wgmma_wait<1>();
    // the set read by the step now done stays in its registers until here
    fence_frag(fa[(kk + 1) % 2]);
  }
  wgmma_wait<0>();
  fence_regs(s);
}

// kRows query rows of one (b, q head) a block, kN-key K/V tiles streamed by
// TMA. S = Q K^T and O += P V both run on tf32 wgmma in three passes (a_hi
// b_lo, a_lo b_hi, a_hi b_hi): A (Q; P) from registers, split there; B (K;
// V^T) from shared memory, the words as the tensor cores truncate them and a
// lo plane. P's accumulator columns 2 t, 2 t + 1 are its A fragment in the
// contraction order that V^T's planes are written in (keys 8 kc + 2 p, then
// 8 kc + 2 p + 1), so P never leaves registers.
template <int D>
__global__ void __launch_bounds__(F32FwdLayout<D>::kThreads, 1)
fa_fwd_tf32(const __grid_constant__ WgParams p) {
  using L = F32FwdLayout<D>;
  constexpr int R = L::kRows;
  constexpr int N = L::kN;
  constexpr int kNT = N / 8;  // n8 groups of the score tile, k8 steps of P V
  constexpr int kDT = D / 8;  // n8 groups of the output
  constexpr int kThreads = L::kThreads;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw);
  const float* const fbase = reinterpret_cast<const float*>(smem);
  float4* const sKlo = reinterpret_cast<float4*>(smem + L::kKloOffset);
  unsigned char* const sVt = smem + L::kVtOffset;
  const uint32_t uKlo = base + L::kKloOffset;
  const uint32_t uVt = base + L::kVtOffset;
  const uint32_t uVtlo = uVt + L::kTileBytes;
  const uint32_t bars = base + L::kBarOffset;
  // full[s] = bars + 8 s, empty[s] = bars + 8 (kStages + s), Q = bars + 16 kStages
  const uint32_t q_bar = bars + 16 * kStages;

  // every head's longest causal tile before any head's next one
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
  const int wr0 = 16 * warp;         // the warp's first row in the block
  const int wq0 = q0 + 64 * (warp / 4);  // its warpgroup's first row
  const int offset = p.Sk - p.Sq;

  const int n_tiles = (kv_limit(q0, R, p.Sq, p.Sk, p.causal) + N - 1) / N;
  const int wg_tiles = wq0 >= p.Sq ? 0 : (kv_limit(wq0, 64, p.Sq, p.Sk, p.causal) + N - 1) / N;

  auto stage_k = [&](int s) { return base + L::kQBytes + s * L::kStageBytes; };
  auto load_kv = [&](int j) {  // tile j into stage j % kStages
    const int s = j % kStages;
    const uint32_t full = bars + 8 * s;
    mbar_arrive_expect_tx(full, L::kStageBytes);
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
    mbar_arrive_expect_tx(q_bar, L::kQBytes);
    tma_load_f32<D>(base, &p.tq, R, R, q0, h, b, q_bar);
    for (int j = 0; j < kStages && j < n_tiles; ++j) load_kv(j);
  }
  __syncwarp();

  const int row[2] = {q0 + wr0 + g, q0 + wr0 + g + 8};
  const float scale_log2 = p.scale * kLog2e;
  float m_i[2] = {kNegBig, kNegBig};  // running max, log2 units
  float l_i[2] = {0.f, 0.f};          // this thread's share of the row sum
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(q_bar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const uint32_t uK = stage_k(s);
    const float* const sK = fbase + (uK - base) / 4;
    const float* const sV = sK + L::kTileBytes / 4;
    mbar_wait(bars + 8 * s, parity);
    // this thread's share of the planes, read from the stage before the
    // barrier: float4s of K, and for each 16-byte chunk c of V^T row d (keys
    // 8 (c / 2) + 2 e + c % 2, e = 0..3: the permuted contraction order) the
    // four V words
    float4 kx[L::kKloPer];
    float vx[L::kVtPer][4];
#pragma unroll
    for (int i = 0; i < L::kKloPer; ++i)
      kx[i] = reinterpret_cast<const float4*>(sK)[i * kThreads + tid];
#pragma unroll
    for (int i = 0; i < L::kVtPer; ++i) {
      const int ci = i * kThreads + tid;
      const int d = ci % D, c = ci / D;
#pragma unroll
      for (int e = 0; e < 4; ++e) vx[i][e] = sV[sw<N>(8 * (c / 2) + 2 * e + c % 2, d)];
    }
    __syncthreads();  // every warp is done with the last tile's planes
#pragma unroll
    for (int i = 0; i < L::kKloPer; ++i)
      sKlo[i * kThreads + tid] = make_float4(kx[i].x - tf32_trunc(kx[i].x),
                                             kx[i].y - tf32_trunc(kx[i].y),
                                             kx[i].z - tf32_trunc(kx[i].z),
                                             kx[i].w - tf32_trunc(kx[i].w));
#pragma unroll
    for (int i = 0; i < L::kVtPer; ++i) {
      const int ci = i * kThreads + tid;
      const int off = vt_chunk<D, L::kAtomKeys>(ci % D, ci / D);
      *reinterpret_cast<float4*>(sVt + off) = make_float4(vx[i][0], vx[i][1], vx[i][2], vx[i][3]);
      *reinterpret_cast<float4*>(sVt + L::kTileBytes + off) =
          make_float4(vx[i][0] - tf32_trunc(vx[i][0]), vx[i][1] - tf32_trunc(vx[i][1]),
                      vx[i][2] - tf32_trunc(vx[i][2]), vx[i][3] - tf32_trunc(vx[i][3]));
    }
    fence_proxy_async();
    __syncthreads();

    const bool live = j < wg_tiles;
    float sc[N / 2];  // this tile's scores, then its probabilities
    if (live) score_product<R, N, D>(sc, base, uK, uKlo, wr0, lane);
    // this thread is done with stage s (P V reads the planes); thread 0
    // refills it once every thread is, so the copy runs under the softmax
    // and P V
    mbar_arrive(bars + 8 * (kStages + s));
    if (tid == 0 && j + kStages < n_tiles) {
      mbar_wait(bars + 8 * (kStages + s), parity);
      load_kv(j + kStages);
    }
    __syncwarp();
    if (live) {
      // online softmax in registers: a thread holds rows row[0], row[1] at
      // columns 8 i + 2 t + {0, 1} of each n8 group i
      const int k0 = j * N;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) sc[i] *= scale_log2;
      if ((k0 + N > p.Sk) || (p.causal && k0 + N - 1 > q0 + wr0 + offset)) {
        // one uniform branch, then selects: column 8 i + (e & 1) of this
        // thread's share is visible to row r iff it is below lim[r]
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
      float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
      for (int i = 0; i < kNT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * i + e]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // the first tile gives every row a visible key (key 0, as Sq <= Sk
        // when causal), so mx is a real score from then on and a masked
        // score's exp2(-1e30 - mx) is 0; alpha of the first tile is 0
        alpha[r] = fast_exp2(m_i[r] - mx[r]);
        m_i[r] = mx[r];
        l_i[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        sc[i] = fast_exp2(sc[i] - mx[(i >> 1) & 1]);
        l_i[(i >> 1) & 1] += sc[i];
      }
      // the previous P V has completed (wait_group 0 below): rescale O
#pragma unroll
      for (int i = 0; i < kDT; ++i) {
        acc[4 * i + 0] *= alpha[0];
        acc[4 * i + 1] *= alpha[0];
        acc[4 * i + 2] *= alpha[1];
        acc[4 * i + 3] *= alpha[1];
      }
      // O += P V: P's n8 group kc is the A fragment of k8 step kc as it lies
      // (a0..a3 = elements 0, 2, 1, 3), split in registers; V^T's planes hold
      // keys in the same order
      FragA pa[kNT];
#pragma unroll
      for (int kc = 0; kc < kNT; ++kc)
        pa[kc].split(sc[4 * kc], sc[4 * kc + 2], sc[4 * kc + 1], sc[4 * kc + 3]);
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int kc = 0; kc < kNT; ++kc) {
        wgmma_tf32(acc, pa[kc].hi, vt_desc<D, L::kAtomKeys>(uVtlo, kc), 1);
        wgmma_tf32(acc, pa[kc].lo, vt_desc<D, L::kAtomKeys>(uVt, kc), 1);
        wgmma_tf32(acc, pa[kc].hi, vt_desc<D, L::kAtomKeys>(uVt, kc), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int kc = 0; kc < kNT; ++kc) fence_frag(pa[kc]);
    }
  }

  // Epilogue: finish the row sums across the quad, normalise, store.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_safe = fmaxf(l, 1e-30f);
    if (row[r] < p.Sq) {
      float* Og = static_cast<float*>(p.o) + b * p.o_sb + (long long)row[r] * p.o_ss + h * p.o_sh;
#pragma unroll
      for (int i = 0; i < kDT; ++i)
        *reinterpret_cast<float2*>(Og + 8 * i + 2 * t) =
            make_float2(acc[4 * i + 2 * r] / l_safe, acc[4 * i + 2 * r + 1] / l_safe);
      if (t == 0) p.lse[((long long)b * p.Hq + h) * p.Sq + row[r]] = (m_i[r] + log2f(l_safe)) * kLn2;
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
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
};

void fill_rest(WgParams* p, const Params& a) {
  p->o = a.o;
  p->lse = a.lse;
  p->Hq = a.Hq; p->Hkv = a.Hkv; p->Sq = a.Sq; p->Sk = a.Sk;
  p->o_sb = a.o_sb; p->o_ss = a.o_ss; p->o_sh = a.o_sh;
  p->scale = a.scale;
  p->causal = a.causal;
}

template <typename T, int D>
cudaError_t launch_wgmma(const Params& a, CUtensorMapDataType dt, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  WgParams p;
  if (!encode_map<D>(&p.tq, dt, a.q, a.Sq, a.Hq, a.B, a.q_sb, a.q_ss, a.q_sh, kWgBlockM) ||
      !encode_map<D>(&p.tk, dt, a.k, a.Sk, a.Hkv, a.B, a.k_sb, a.k_ss, a.k_sh,
                     WgLayout<D>::kBlockN) ||
      !encode_map<D>(&p.tv, dt, a.v, a.Sk, a.Hkv, a.B, a.v_sb, a.v_ss, a.v_sh,
                     WgLayout<D>::kBlockN))
    return cudaErrorInvalidValue;
  fill_rest(&p, a);
  const size_t smem = WgLayout<D>::kSmem;
  const cudaError_t err = grant_smem(fa_fwd_wgmma<T, D>, configured, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kWgBlockM - 1) / kWgBlockM, a.Hq, a.B);
  fa_fwd_wgmma<T, D><<<grid, kWgThreads, smem, stream>>>(p);
  return cudaGetLastError();  // a refused launch is reported only here
}

// grid (heads x batch, q tiles): the tile index varies slowest, so every
// head's longest causal tile is issued before any head's next one
template <int D>
cudaError_t launch_tf32(const Params& a, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  using L = F32FwdLayout<D>;
  WgParams p;
  if (!encode_map_f32_tile<D>(&p.tq, a.q, a.Sq, a.Hq, a.B, a.q_sb, a.q_ss, a.q_sh, L::kRows) ||
      !encode_map_f32_tile<D>(&p.tk, a.k, a.Sk, a.Hkv, a.B, a.k_sb, a.k_ss, a.k_sh, L::kN) ||
      !encode_map_f32_tile<D>(&p.tv, a.v, a.Sk, a.Hkv, a.B, a.v_sb, a.v_ss, a.v_sh, L::kN))
    return cudaErrorInvalidValue;
  fill_rest(&p, a);
  const cudaError_t err = grant_smem(fa_fwd_tf32<D>, configured, L::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.Hq * a.B, (a.Sq + L::kRows - 1) / L::kRows);
  fa_fwd_tf32<D><<<grid, L::kThreads, L::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dim(int dtype, const Params& p, cudaStream_t stream) {
  if (dtype == 2)
    return launch_wgmma<__nv_bfloat16, D>(p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, stream);
  if (dtype == 1) return launch_wgmma<__half, D>(p, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, stream);
  if (dtype == 0) return launch_tf32<D>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. Strides are in elements;
// every input's base must be 16-byte aligned and its strides multiples of 16
// bytes (TMA). Returns a cudaError_t (0 on success).
extern "C" int pt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int B, int Hq, int Hkv, int Sq, int Sk, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = static_cast<float*>(lse);
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.Sq = Sq; p.Sk = Sk;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.scale = scale; p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return (int)launch_dim<128>(dtype, p, s);
  if (D == 64) return (int)launch_dim<64>(dtype, p, s);
  if (D == 32) return (int)launch_dim<32>(dtype, p, s);
  if (D == 96) return (int)launch_dim<96>(dtype, p, s);
  if (D == 256) return (int)launch_dim<256>(dtype, p, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
