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
// fp32 (`fa_fwd_f32`) runs on CUDA cores in full fp32 (no TF32), one query
// row per four threads, 64-row blocks (213,760 bytes of shared memory at
// D = 256).
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
// fp32: CUDA cores, full fp32 arithmetic
// ---------------------------------------------------------------------------
constexpr int kF32BlockM = 64;  // query rows per block
constexpr int kF32BlockN = 64;  // keys per k/v tile

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

// One block = 64 query rows; 256 threads, four per row. Thread (r, c) owns
// score columns c, c+4, ... of its row and output dims c, c+4, ...
template <int D>
__global__ void __launch_bounds__(256)
fa_fwd_f32(const Params p) {
  constexpr int kThreads = 256;
  constexpr int LDQ = D + 1;  // odd pitch: conflict-free column walks
  constexpr int LDP = kF32BlockN + 1;
  constexpr int kCols = kF32BlockN / 4;
  constexpr int kDims = D / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + kF32BlockM * LDQ;
  float* sV = sK + kF32BlockN * LDQ;
  float* sP = sV + kF32BlockN * D;

  const int n_qtiles = (p.Sq + kF32BlockM - 1) / kF32BlockM;
  const int q0 = (n_qtiles - 1 - blockIdx.x) * kF32BlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int lr = threadIdx.x / 4;
  const int c4 = threadIdx.x % 4;
  const int r = q0 + lr;

  const float* Qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* Kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* Vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int i = threadIdx.x; i < kF32BlockM * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    const int gr = q0 + rr;
    sQ[rr * LDQ + d] = gr < p.Sq ? Qg[(long long)gr * p.q_ss + d] * p.scale : 0.f;
  }

  const int offset = p.Sk - p.Sq;
  float m_i = kNegBig, l_i = 0.f;
  float acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) acc[i] = 0.f;

  const int kv_end = kv_limit(q0, kF32BlockM, p.Sq, p.Sk, p.causal);
  const int n_tiles = (kv_end + kF32BlockN - 1) / kF32BlockN;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kF32BlockN;
    __syncthreads();
    for (int i = threadIdx.x; i < kF32BlockN * D; i += kThreads) {
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
    for (int c = 0; c < kF32BlockN; ++c) {
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

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
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
  p.o = a.o;
  p.lse = a.lse;
  p.Hq = a.Hq; p.Hkv = a.Hkv; p.Sq = a.Sq; p.Sk = a.Sk;
  p.o_sb = a.o_sb; p.o_ss = a.o_ss; p.o_sh = a.o_sh;
  p.scale = a.scale;
  p.causal = a.causal;
  const size_t smem = WgLayout<D>::kSmem;
  const cudaError_t err = grant_smem(fa_fwd_wgmma<T, D>, configured, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kWgBlockM - 1) / kWgBlockM, a.Hq, a.B);
  fa_fwd_wgmma<T, D><<<grid, kWgThreads, smem, stream>>>(p);
  return cudaGetLastError();  // a refused launch is reported only here
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  const size_t smem = ((size_t)(kF32BlockM + kF32BlockN) * (D + 1) + (size_t)kF32BlockN * D +
                       (size_t)kF32BlockM * (kF32BlockN + 1)) * sizeof(float);
  const cudaError_t err = grant_smem(fa_fwd_f32<D>, configured, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kF32BlockM - 1) / kF32BlockM, p.Hq, p.B);
  fa_fwd_f32<D><<<grid, 256, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dim(int dtype, const Params& p, cudaStream_t stream) {
  if (dtype == 2)
    return launch_wgmma<__nv_bfloat16, D>(p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, stream);
  if (dtype == 1) return launch_wgmma<__half, D>(p, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, stream);
  if (dtype == 0) return launch_f32<D>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. Strides are in elements;
// for float16 and bfloat16 the base must be 16-byte aligned and the strides
// multiples of 16 bytes (TMA). Returns a cudaError_t (0 on success).
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
