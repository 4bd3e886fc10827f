// Flash-attention backward for Hopper (sm_90a), with a plain C interface that
// lcasr_torch/kernels.py loads through ctypes.
//
// Replaces the three backward bodies of lcasr_tpu/ops/flash_attention.py,
// driven by `_bwd_impl`:
//   K3 `_bwd_fused_kernel` (pl.pallas_call at :910): one pass, dq, dk, dv;
//   K4 `_bwd_dq_kernel`    (call at :968): dq only (banded / split path);
//   K5 `_bwd_dkv_kernel`   (call at :1007): dk and dv (banded / split path).
// Same function as the Pallas kernels: q arrives already multiplied by the
// softmax scale (in q's dtype, as in the forward), p = exp(s - lse) is
// recomputed from the forward's lse on the valid (row, col) pairs and is 0
// elsewhere (a select, never a multiply: rows past the length carry
// lse = -1e30, and exp(s + 1e30) = inf must not meet a 0), delta =
// rowsum(do * o) comes in from the caller, and
//   dv = p^T do,  dp = do v^T,  ds = p (dp - delta),  dk = ds^T q,  dq = ds k.
// dk is exact as it is (q is pre-scaled); dq leaves the kernel in fp32
// without the chain-rule scale, which the caller applies, as `_bwd_impl`
// does.  Lengths, the (left, right) band and the q/kv offsets are in global
// coordinates, as in the forward kernel.
//
// Bound on the H100: at the training shape (B 4, T 2048, H 6, D 128, bf16)
// K3 does 5 products of 2*T*T*D per (b, h) = 128.8 GFLOP on about 101 MB
// (q, k, v, do, dk, dv in bf16, dq in fp32, lse and delta), 0.130 ms at the
// tensor cores' 989 TFLOP/s against 0.030 ms at 3.35 TB/s: the tensor cores,
// not the memory, bound it (K4: 3 products, K5: 4).
//
// Design of K3 and K5 in bf16 (one template, `flash_bwd_hopper<D, WITH_DQ>`,
// for D 128, 64 and 32): what the design does about that bound is keep the
// tensor cores fed from shared memory and never stop them for a load.
//   * One CTA of three warpgroups per (128-key tile, head, batch): K and V
//     arrive once by TMA (128-byte swizzle; 64-byte at D 32) and stay in
//     shared memory; a producer warp streams 64-row q and do tiles, with
//     their lse and delta rows, through a two-stage TMA ring over the q
//     tiles the band and the lengths leave (`q_tile_range`); two consumer
//     warpgroups own 64 keys each and keep dk, dv in fp32 registers.
//   * Every product is a wgmma with the keys as M: s^T = k q^T and
//     dp^T = v do^T from shared memory (SS), dv += p^T do and dk += ds^T q
//     with p^T and ds^T as bf16 A fragments from registers (RS, q and do
//     read MN-major), and in K3 dq = ds k with ds^T staged in shared memory
//     (SS, both operands MN-major).  The masks are a select, applied only on
//     tiles that cross a length or lie under a band: rows past the length
//     carry lse = -1e30, and exp(s + 1e30) must never meet a 0.
//   * dq is a sum over the key tiles, which run in no order: each CTA stages
//     its fp32 part in shared memory and adds it once per q tile to a zeroed
//     (B, T, H, D) buffer by TMA reduce-add (`cp.reduce.async.bulk.tensor`,
//     one per 32 columns; where the Pallas kernel carries dq through an
//     aliased buffer across sequential grid steps).  It measured 17% faster
//     than four-float `red.global.add` from registers (PERF.md, §6).
//     dq's order of additions, and only dq's, varies from run to run; dk and
//     dv are the same bits each run, and K5's equal K3's.
//   * Shared memory at D 128: K, V 64 KB; q, do 2 stages x 32 KB; K3's ds^T
//     2 x 16 KB and dq parts 2 x 16 KB; 194 KB (K5 162 KB): one CTA per SM.
//     The training shape gives 4 x 6 x 16 = 384 CTAs, 2.9 waves on 132 SMs.
// Design of K4 in bf16 (`flash_bwd_dq_hopper<D>`, D 128, 64 and 32; dq
// alone, the split path every two-sided band takes).  Its loop is the
// forward's, q-stationary, so it is built like the forward
// (flash_fwd_hopper.cuh), not like K3: one CTA of a producer and two
// consumer warpgroups per (128 q rows, head, batch); q and do arrive once by
// TMA, k and v stream through a two-stage TMA ring over the key tiles of
// `kv_tile_range` (64 keys each); s = q k^T and dp = do v^T are SS wgmma,
// dq += ds k an RS wgmma with ds as bf16 A fragments and k read MN-major
// (as the forward reads v for o += p v).  dq stays in fp32 registers and is
// written once: no reduction across CTAs, so K4's dq, unlike K3's, is the
// same bits from run to run.  Shared memory at D 128: q, do 64 KB, two
// stages of k and v 64 KB, 128 KB: one CTA per SM (the registers allow no
// more); the training shape gives 16 x 6 x 4 = 384 CTAs, 2.9 waves.  s, dp
// and dq take 32 + 32 + 64 fp32 registers a thread; 128-key tiles (64 + 64
// + 64) fitted too, without spills, and measured 2-3% slower
// (scripts/attention_bwd_experiments.py variants, PERF.md).
// fp32 inputs take SIMT kernels of the K4 / K3 structure (32-row tiles, four
// threads per row, fp32 FMA, no tensor cores).  They are slow, and are
// there because the JAX kernels accept fp32.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int BR = 32;  // rows per tile, both ways (fp32 SIMT)
constexpr int NTHREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

enum Kind { FUSED = 0, DQ = 1, DKV = 2 };

struct Params {
  const void* q;  // pre-scaled
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, H, Tq)
  const float* delta;  // (B, H, Tq)
  const int* lengths;  // (B,) global lengths
  float* dq;           // (B, Tq, H, D) fp32, unscaled; zeroed for K3
  void* dk;            // (B, Tk, H, D) contiguous, q's dtype
  void* dv;
  int B, H, Tq, Tk;
  long long q_sb, q_st, q_sh;  // element strides; the D stride is 1
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;  // strides of dout
  int q_off, kv_off, left, right;
};

// valid global rows are < q_hi, valid global cols < kv_hi
struct Limits {
  int q_hi, kv_hi;
};

__device__ __forceinline__ Limits limits(const Params& p, int b) {
  const int len = p.lengths[b];
  return {min(len, p.q_off + p.Tq), min(len, p.kv_off + p.Tk)};
}

// Local q tiles [lo, hi) of height bq that can meet the key tile of width bk
// starting at local col c0.
__device__ __forceinline__ void q_tile_range(const Params& p, Limits lim,
                                             int c0, int bq, int bk, int& lo,
                                             int& hi) {
  const int c0g = p.kv_off + c0;
  const int q_valid = lim.q_hi - p.q_off;  // local rows below this are valid
  lo = 0;
  hi = (q_valid > 0 && c0g < lim.kv_hi) ? (q_valid + bq - 1) / bq : 0;
  if (p.right >= 0) lo = max(0, floordiv(c0g - p.right - p.q_off, bq));
  if (p.left >= 0)
    hi = min(hi, floordiv(c0g + bk - 1 + p.left - p.q_off, bq) + 1);
}

// Local key tiles [lo, hi) of width bk that can meet the q tile of height bq
// starting at local row q0 (the forward kernel's range).
__device__ __forceinline__ void kv_tile_range(const Params& p, Limits lim,
                                              int q0, int bq, int bk, int& lo,
                                              int& hi) {
  const int qg0 = p.q_off + q0;
  const int kv_valid = lim.kv_hi - p.kv_off;
  lo = 0;
  hi = (kv_valid > 0 && qg0 < lim.q_hi) ? (kv_valid + bk - 1) / bk : 0;
  if (p.left >= 0) lo = max(0, floordiv(qg0 - p.left - p.kv_off, bk));
  if (p.right >= 0)
    hi = min(hi, floordiv(qg0 + bq - 1 + p.right - p.kv_off, bk) + 1);
}

__device__ __forceinline__ bool pair_valid(const Params& p, Limits lim,
                                           int row_g, int col_g) {
  bool ok = row_g < lim.q_hi && col_g < lim.kv_hi;
  if (p.right >= 0) ok = ok && (col_g <= row_g + p.right);
  if (p.left >= 0) ok = ok && (col_g >= row_g - p.left);
  return ok;
}

// lse and delta of `rows` q rows from local row r0 into shared memory
__device__ __forceinline__ void load_stats(float* sL, float* sD,
                                           const float* lse, const float* del,
                                           int r0, int rows, int Tq) {
  for (int i = threadIdx.x; i < rows; i += NTHREADS) {
    const bool ok = r0 + i < Tq;
    sL[i] = ok ? lse[r0 + i] : 0.f;
    sD[i] = ok ? del[r0 + i] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// bf16 K3 and K5 on Hopper: TMA, wgmma, warp specialisation
// ---------------------------------------------------------------------------
constexpr int HBK = 128;     // keys per CTA: 64 per consumer warpgroup
constexpr int HBQ = 64;      // q rows per tile of the walk
constexpr int HSTAGES = 2;   // q / do tiles in flight
constexpr int HTHREADS = 384;  // the producer and two consumer warpgroups
constexpr int CONSUMER_THREADS = 256;
constexpr int CONSUMER_WARPS = 8;
// registers a thread: 128 x 40 + 256 x 232 = 64,512 of the SM's 65,536
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int DS_BAR = 1;  // named barrier: both consumers' ds^T halves are staged
constexpr int DQ_BAR = 2;  // + consumer: its dq part is staged / its stage is free

template <int D>
struct BwdTile {
  // a tile of R rows is D / COLS column blocks of R rows x COLS elements,
  // each row of a block ROW_BYTES long and swizzled across 8-row groups
  static constexpr int COLS = D >= 64 ? 64 : D;
  static constexpr int ROW_BYTES = COLS * 2;
  static constexpr int BLOCKS = D / COLS;
  static constexpr uint64_t LAYOUT =
      D >= 64 ? hopper::SWIZZLE_128B : hopper::SWIZZLE_64B;
  static constexpr CUtensorMapSwizzle TMA_SWIZZLE =
      D >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  static constexpr int SBO = 8 * ROW_BYTES;  // bytes between 8-row groups
  static constexpr int KV_ELEMS = HBK * D;
  static constexpr int QT_ELEMS = HBQ * D;
  static constexpr uint32_t KV_BYTES = KV_ELEMS * 2;
  static constexpr uint32_t QT_BYTES = QT_ELEMS * 2;
  // dq = ds k: at D 128 each consumer takes one 64-column block of dq; at
  // D 64 and 32 a block is the whole width (a wgmma cannot take half of a
  // swizzle atom along N) and consumer 0 takes it alone
  static constexpr bool DQ_SPLIT = D == 128;
  static constexpr int DQ_N = DQ_SPLIT ? 64 : D;
};

// ds^T of the CTA: 128 keys x 64 q rows, bf16, one 128-byte swizzled block
constexpr int DS_ELEMS = HBK * HBQ;
// a consumer's dq part on its way to the TMA reduce-add: 64 q rows x DQ_N
// fp32, as blocks of 32 columns (128-byte rows, swizzled)
constexpr int DQ_BOX_COLS = 32;

template <int D, bool WITH_DQ>
constexpr size_t bwd_smem() {
  using TL = BwdTile<D>;
  return 1024 + 2 * (size_t)TL::KV_BYTES + 2 * HSTAGES * (size_t)TL::QT_BYTES +
         (WITH_DQ ? 2 * DS_ELEMS * 2 + 2 * HBQ * TL::DQ_N * sizeof(float) : 0) +
         2 * HSTAGES * HBQ * sizeof(float) + 8 * (1 + 2 * HSTAGES);
}

// Issue acc (64 keys x 64 q rows) = A B^T over D: s^T = k q^T or dp^T = v do^T,
// A this consumer's 64 rows of the key tile, B the q / do tile, both K-major
// (not waited for).
template <int D>
__device__ __forceinline__ void issue_keys_by_rows(float* acc,
                                                   const __nv_bfloat16* sA,
                                                   const __nv_bfloat16* sB) {
  using TL = BwdTile<D>;
  hopper::fence_all<HBQ / 2>(acc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int blk = kk * 16 / TL::COLS, col = kk * 16 % TL::COLS;
    const uint64_t da = hopper::smem_desc(sA + blk * HBK * TL::COLS + col, 16,
                                          TL::SBO, TL::LAYOUT);
    const uint64_t db = hopper::smem_desc(sB + blk * HBQ * TL::COLS + col, 16,
                                          TL::SBO, TL::LAYOUT);
    hopper::wgmma_m64n64k16_ss<0, 0>(acc, da, db, kk > 0);
  }
  hopper::wgmma_commit();
  hopper::fence_all<HBQ / 2>(acc);
}

// Issue acc (64 keys x D) += A B, A (64 keys x 64 q rows) bf16 from registers,
// B the q / do tile read MN-major: dv += p^T do, dk += ds^T q (not committed).
template <int D>
__device__ __forceinline__ void issue_rows_times_tile(float* acc,
                                                      uint32_t (*a)[4],
                                                      const __nv_bfloat16* sB) {
  using TL = BwdTile<D>;
#pragma unroll
  for (int kc = 0; kc < HBQ / 16; ++kc) {
    // q rows 16 kc .. 16 kc + 15 of every column block; the leading byte
    // offset steps from one block of COLS columns to the next
    const uint64_t db = hopper::smem_desc(sB + kc * 16 * TL::COLS,
                                          HBQ * TL::ROW_BYTES, TL::SBO,
                                          TL::LAYOUT);
    hopper::wgmma_rs_tb<D>(acc, a[kc], db);
  }
}

// Issue dq (64 q rows x DQ_N) = ds k over the CTA's 128 keys: A is ds^T in
// shared memory read MN-major (q rows contiguous), B the columns of the key
// tile from `sK` read MN-major (not waited for).
template <int D>
__device__ __forceinline__ void issue_dq(float* acc, const __nv_bfloat16* sDS,
                                         const __nv_bfloat16* sK) {
  using TL = BwdTile<D>;
  hopper::fence_all<TL::DQ_N / 2>(acc);
  hopper::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < HBK / 16; ++ks) {
    // 16 keys = 16 rows of 128 bytes; A spans one swizzle atom along M, so
    // only the 8-row stride is read (both offsets are set to it)
    const uint64_t da = hopper::smem_desc(sDS + ks * 16 * HBQ, 1024, 1024,
                                          hopper::SWIZZLE_128B);
    const uint64_t db = hopper::smem_desc(sK + ks * 16 * TL::COLS,
                                          HBK * TL::ROW_BYTES, TL::SBO,
                                          TL::LAYOUT);
    if constexpr (TL::DQ_N == 64)
      hopper::wgmma_m64n64k16_ss<1, 1>(acc, da, db, ks > 0);
    else
      hopper::wgmma_m64n32k16_ss<1, 1>(acc, da, db, ks > 0);
  }
  hopper::wgmma_commit();
  hopper::fence_all<TL::DQ_N / 2>(acc);
}

// K3 (WITH_DQ) and K5: dk, dv for one 128-key tile; K3 also adds dq.
//   * warpgroup 0, the producer (setmaxnreg 40): one thread loads the key
//     tile's K and V once by TMA; warp 0 then keeps a ring of HSTAGES q and
//     do tiles of 64 rows in flight by TMA, its lanes copying the tile's lse
//     (times log2 e) and delta rows beside them, one full and one empty
//     mbarrier per stage;
//   * warpgroups 1 and 2, the consumers (setmaxnreg 232), own 64 keys each
//     and keep their dk and dv rows in fp32 registers for the whole walk.
//     Per q tile: s^T = k q^T and dp^T = v do^T (SS wgmma, keys as M);
//     p^T = 2^(s^T log2 e - lse log2 e) and ds^T = p^T (dp^T - delta) in
//     registers, the masks a select on edge tiles only; dv += p^T do and
//     dk += ds^T q (RS wgmma, p^T and ds^T rounded to bf16 as the A operand);
//   * K3: both consumers stage ds^T (bf16) in shared memory, meet at a named
//     barrier, and dq (64 q x D) = ds k is one SS wgmma per 16 keys (ds read
//     MN-major, k MN-major), split by columns between the consumers at
//     D 128; each consumer stages its fp32 part in shared memory, and one of
//     its threads adds it to the zeroed (B, T, H, D) buffer by TMA
//     reduce-add, once per q tile.
// dk and dv have one writer and a fixed order of products: they are the
// same bits from run to run, and K5's are K3's.  Only dq's order of
// additions across CTAs varies.
template <int D, bool WITH_DQ>
__global__ void __launch_bounds__(HTHREADS, 1)
    flash_bwd_hopper(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tdq, const Params p) {
  using TL = BwdTile<D>;
  using bf = __nv_bfloat16;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = hopper::smem_u32(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (base & 1023)) & 1023);
  bf* sK = reinterpret_cast<bf*>(smem);
  bf* sV = sK + TL::KV_ELEMS;
  bf* sQ = sV + TL::KV_ELEMS;              // HSTAGES tiles
  bf* sO = sQ + HSTAGES * TL::QT_ELEMS;    // do, HSTAGES tiles
  bf* sDS = sO + HSTAGES * TL::QT_ELEMS;   // ds^T, 2 buffers (K3 only)
  // one dq part a consumer (K3 only)
  float* sDQ = reinterpret_cast<float*>(sDS + (WITH_DQ ? 2 * DS_ELEMS : 0));
  float* sL = sDQ + (WITH_DQ ? 2 * HBQ * TL::DQ_N : 0);  // lse rows, times log2 e
  float* sDl = sL + HSTAGES * HBQ;         // delta rows
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sDl + HSTAGES * HBQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + HSTAGES;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < HSTAGES; ++s) {
      hopper::mbar_init(&full[s], 32);  // the producer warp's lanes
      hopper::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup's index, read from lane 0 so that the compiler sees it is
  // the same across the warp: each role is then a region of its own
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int h = blockIdx.y, b = blockIdx.z;
  const int c0 = blockIdx.x * HBK;  // the CTA's first local key
  if (wg == 0) {
    // ---- producer ----
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    const Limits lim = limits(p, b);
    int lo, hi;
    q_tile_range(p, lim, c0, HBQ, HBK, lo, hi);
    const int lane = threadIdx.x % 32;
    if (threadIdx.x < 32 && lo < hi) {
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(kv_full, 2 * TL::KV_BYTES);
#pragma unroll
        for (int c = 0; c < TL::BLOCKS; ++c) {
          hopper::tma_load_4d(sK + c * HBK * TL::COLS, &tk, kv_full,
                              c * TL::COLS, h, c0, b);
          hopper::tma_load_4d(sV + c * HBK * TL::COLS, &tv, kv_full,
                              c * TL::COLS, h, c0, b);
        }
      }
      const float* lse_b = p.lse + ((long long)b * p.H + h) * p.Tq;
      const float* del_b = p.delta + ((long long)b * p.H + h) * p.Tq;
      for (int n = 0; n < hi - lo; ++n) {
        const int st = n % HSTAGES;
        const uint32_t ph = (n / HSTAGES) & 1;
        const int q0 = (lo + n) * HBQ;
        // the tile's lse and delta rows are read before the wait, so their
        // latency passes while the stage is still in use
        float lv[HBQ / 32], dl[HBQ / 32];
#pragma unroll
        for (int i = 0; i < HBQ / 32; ++i) {
          const int r = q0 + lane + 32 * i;
          lv[i] = r < p.Tq ? lse_b[r] * LOG2E : 0.f;
          dl[i] = r < p.Tq ? del_b[r] : 0.f;
        }
        hopper::mbar_wait(&empty[st], ph ^ 1);
#pragma unroll
        for (int i = 0; i < HBQ / 32; ++i) {
          sL[st * HBQ + lane + 32 * i] = lv[i];
          sDl[st * HBQ + lane + 32 * i] = dl[i];
        }
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(&full[st], 2 * TL::QT_BYTES);
#pragma unroll
          for (int c = 0; c < TL::BLOCKS; ++c) {
            hopper::tma_load_4d(sQ + st * TL::QT_ELEMS + c * HBQ * TL::COLS,
                                &tq, &full[st], c * TL::COLS, h, q0, b);
            hopper::tma_load_4d(sO + st * TL::QT_ELEMS + c * HBQ * TL::COLS,
                                &tdo, &full[st], c * TL::COLS, h, q0, b);
          }
        } else {
          hopper::mbar_arrive(&full[st]);
        }
      }
    }
  } else {
    // ---- consumers ----
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const Limits lim = limits(p, b);
    int lo, hi;
    q_tile_range(p, lim, c0, HBQ, HBK, lo, hi);
    const int cw = wg - 1;  // consumer 0 or 1: keys c0 + 64 cw ..
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int key_l[2] = {c0 + cw * 64 + warp * 16 + g,
                          c0 + cw * 64 + warp * 16 + g + 8};
    const int key_g[2] = {p.kv_off + key_l[0], p.kv_off + key_l[1]};
    // every tile needs the masks under a band or when the key tile crosses
    // the length; otherwise only the q tiles that cross it
    const bool key_edge = p.left >= 0 || p.right >= 0 ||
                          p.kv_off + c0 + HBK > lim.kv_hi;
    const bf* sKc = sK + cw * 64 * TL::COLS;  // this consumer's rows
    const bf* sVc = sV + cw * 64 * TL::COLS;
    const bool does_dq = WITH_DQ && (TL::DQ_SPLIT || cw == 0);

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    if (lo < hi) hopper::mbar_wait(kv_full, 0);
    for (int n = 0; n < hi - lo; ++n) {
      const int st = n % HSTAGES;
      const uint32_t ph = (n / HSTAGES) & 1;
      const int q0 = (lo + n) * HBQ;
      const bf* tQ = sQ + st * TL::QT_ELEMS;
      const bf* tO = sO + st * TL::QT_ELEMS;
      const float* tL = sL + st * HBQ;
      const float* tD = sDl + st * HBQ;
      hopper::mbar_wait(&full[st], ph);

      float s[HBQ / 2], dp[HBQ / 2];
      issue_keys_by_rows<D>(s, sKc, tQ);
      issue_keys_by_rows<D>(dp, sVc, tO);

      // p^T on the valid pairs; rows past the length carry lse = -1e30 and
      // give inf here, which the select drops
      const bool edge = key_edge || p.q_off + q0 + HBQ > lim.q_hi;
      hopper::wgmma_wait<1>();
      hopper::fence_all<HBQ / 2>(s);
#pragma unroll
      for (int j = 0; j < HBQ / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(tL + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = hopper::ex2(fmaf(s[4 * j + e], LOG2E, -((e & 1) ? l2.y : l2.x)));
          if (edge) {
            const int row_g = p.q_off + q0 + 8 * j + 2 * t + (e & 1);
            if (!pair_valid(p, lim, row_g, key_g[e >> 1])) x = 0.f;
          }
          s[4 * j + e] = x;
        }
      }
      // ds^T = p^T (dp^T - delta) in place of dp^T
      hopper::wgmma_wait<0>();
      hopper::fence_all<HBQ / 2>(dp);
#pragma unroll
      for (int j = 0; j < HBQ / 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(tD + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x));
      }
      uint32_t pa[HBQ / 16][4], da[HBQ / 16][4];
      hopper::pack_frags<HBQ / 16>(pa, s);
      hopper::pack_frags<HBQ / 16>(da, dp);

      bf* tDS = sDS + (n & 1) * DS_ELEMS;
      if (WITH_DQ) {
        // ds^T rows (keys) 64 cw + 16 warp + g (+ 8), columns (q rows)
        // 16 kc + 2 t (+ 8): one 32-bit word each, at its 128-byte swizzled
        // place (16-byte chunk index XOR the row's index mod 8)
        unsigned char* ds_bytes = reinterpret_cast<unsigned char*>(tDS);
#pragma unroll
        for (int kc = 0; kc < HBQ / 16; ++kc)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = cw * 64 + warp * 16 + g + 8 * (i & 1);
            const int chunk = 2 * kc + (i >> 1);
            *reinterpret_cast<uint32_t*>(ds_bytes + r * 128 + ((chunk ^ (r & 7)) << 4) +
                                         4 * t) = da[kc][i];
          }
        hopper::fence_proxy_async();
      }

      // dv += p^T do, dk += ds^T q
      hopper::fence_all<D / 2>(dv);
      hopper::fence_all<D / 2>(dk);
      hopper::fence_frags<HBQ / 16>(pa);
      hopper::fence_frags<HBQ / 16>(da);
      hopper::wgmma_fence();
      issue_rows_times_tile<D>(dv, pa, tO);
      issue_rows_times_tile<D>(dk, da, tQ);
      hopper::wgmma_commit();

      float dq[TL::DQ_N / 2];
      if (WITH_DQ) {
        hopper::named_sync(DS_BAR, CONSUMER_THREADS);  // both halves of ds^T
        if (does_dq)
          issue_dq<D>(dq, tDS, sK + (TL::DQ_SPLIT ? cw * HBK * TL::COLS : 0));
      }
      hopper::wgmma_wait<0>();
      hopper::fence_all<D / 2>(dv);
      hopper::fence_all<D / 2>(dk);
      hopper::fence_frags<HBQ / 16>(pa);
      hopper::fence_frags<HBQ / 16>(da);
      if (lane == 0) hopper::mbar_arrive(&empty[st]);  // q, do, lse, delta read

      if (does_dq) {
        hopper::fence_all<TL::DQ_N / 2>(dq);
        // the part is staged in shared memory and added to dq by one TMA
        // reduce-add per 32 columns; rows past Tq are skipped by the TMA,
        // rows past the length add zeros
        unsigned char* part = reinterpret_cast<unsigned char*>(sDQ + cw * HBQ * TL::DQ_N);
        if (tid == 0) hopper::bulk_wait_read();  // the last tile's adds have read it
        hopper::named_sync(DQ_BAR + cw, 128);
#pragma unroll
        for (int j = 0; j < TL::DQ_N / 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = warp * 16 + g + 8 * r, col = 8 * j + 2 * t;
            const int cb = col % DQ_BOX_COLS;
            *reinterpret_cast<float2*>(part + col / DQ_BOX_COLS * (HBQ * 128) + row * 128 +
                                       (((cb >> 2) ^ (row & 7)) << 4) + (cb & 3) * 4) =
                make_float2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
          }
        hopper::fence_proxy_async();
        hopper::named_sync(DQ_BAR + cw, 128);
        if (tid == 0) {
#pragma unroll
          for (int blk = 0; blk < TL::DQ_N / DQ_BOX_COLS; ++blk)
            hopper::tma_reduce_add_4d(&tdq, part + blk * (HBQ * 128),
                                      (TL::DQ_SPLIT ? cw * 64 : 0) + blk * DQ_BOX_COLS,
                                      h, q0, b);
          hopper::bulk_commit();
        }
      }
    }
    if (does_dq && tid == 0) hopper::bulk_wait();  // dq's adds are done

    // dk and dv rounded to bf16 and written once; dk needs no scale (q
    // arrives scaled)
    bf* dkb = static_cast<bf*>(p.dk);
    bf* dvb = static_cast<bf*>(p.dv);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (key_l[r] >= p.Tk) continue;
      const long long off = (((long long)b * p.Tk + key_l[r]) * p.H + h) * D + t * 2;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dkb + off + 8 * j) =
            pack_bf16(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dvb + off + 8 * j) =
            pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

// Tensor maps of q, k, v and do and the launch of K3 (WITH_DQ) or K5;
// errors of the maps' encoding and of the launch are returned, nothing is
// synchronised.
template <int D, bool WITH_DQ>
cudaError_t launch_hopper_bwd(const Params& p, cudaStream_t stream) {
  using TL = BwdTile<D>;
  CUtensorMap mq, mk, mv, mo, mdq;
  cudaError_t err = hopper::bthd_map(&mq, p.q, p.B, p.Tq, p.H, D, p.q_sb, p.q_st,
                                     p.q_sh, HBQ, TL::COLS, TL::TMA_SWIZZLE);
  if (err == cudaSuccess)
    err = hopper::bthd_map(&mk, p.k, p.B, p.Tk, p.H, D, p.k_sb, p.k_st, p.k_sh,
                           HBK, TL::COLS, TL::TMA_SWIZZLE);
  if (err == cudaSuccess)
    err = hopper::bthd_map(&mv, p.v, p.B, p.Tk, p.H, D, p.v_sb, p.v_st, p.v_sh,
                           HBK, TL::COLS, TL::TMA_SWIZZLE);
  if (err == cudaSuccess)
    err = hopper::bthd_map(&mo, p.dout, p.B, p.Tq, p.H, D, p.o_sb, p.o_st,
                           p.o_sh, HBQ, TL::COLS, TL::TMA_SWIZZLE);
  // dq: fp32 (B, Tq, H, D), contiguous; K5 has none and is given q's map
  mdq = mq;
  if (err == cudaSuccess && WITH_DQ)
    err = hopper::bthd_map(&mdq, p.dq, p.B, p.Tq, p.H, D, (long long)p.Tq * p.H * D,
                           (long long)p.H * D, D, HBQ, DQ_BOX_COLS,
                           CU_TENSOR_MAP_SWIZZLE_128B, true);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_hopper<D, WITH_DQ>;
  constexpr size_t smem = bwd_smem<D, WITH_DQ>();
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tk + HBK - 1) / HBK, p.H, p.B);
  kernel<<<grid, HTHREADS, smem, stream>>>(mq, mk, mv, mo, mdq, p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 K4 on Hopper: the forward's loop (q-stationary) with dq in registers
// ---------------------------------------------------------------------------
constexpr int DQ_Q = 128;      // q rows per CTA: 64 per consumer warpgroup
constexpr int DQ_KEYS = 64;    // keys per k / v tile of the walk (128 measured 2-3% slower)
constexpr int DQ_STAGES = 2;   // k / v tiles in flight

template <int D>
constexpr size_t dq_smem() {
  // 1024 bytes of slack to align the tiles to the swizzle atom; q and do
  // once, DQ_STAGES stages of k and v; the barriers
  return 1024 + 2 * (size_t)DQ_Q * D * 2 + 2 * DQ_STAGES * (size_t)DQ_KEYS * D * 2 +
         8 * (1 + 2 * DQ_STAGES);
}

// D (64 x N, fp32) (+)= A (64 x 16) B^T (N x 16), both K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_ss_k(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 128)
    hopper::wgmma_m64n128k16_ss(d, da, db, scale_d);
  else
    hopper::wgmma_m64n64k16_ss<0, 0>(d, da, db, scale_d);
}

// Issue acc (64 q rows x DQ_KEYS) = A B^T over D: s = q k^T or dp = do v^T,
// A this consumer's 64 rows of the q / do tile, B the k / v tile, both
// K-major (committed, not waited for).
template <int D>
__device__ __forceinline__ void issue_rows_by_keys(float* acc,
                                                   const __nv_bfloat16* sA,
                                                   const __nv_bfloat16* sB) {
  using TL = BwdTile<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int blk = kk * 16 / TL::COLS, col = kk * 16 % TL::COLS;
    const uint64_t da = hopper::smem_desc(sA + blk * DQ_Q * TL::COLS + col, 16,
                                          TL::SBO, TL::LAYOUT);
    const uint64_t db = hopper::smem_desc(sB + blk * DQ_KEYS * TL::COLS + col, 16,
                                          TL::SBO, TL::LAYOUT);
    wgmma_ss_k<DQ_KEYS>(acc, da, db, kk > 0);
  }
  hopper::wgmma_commit();
}

// K4: dq (fp32, without the scale) for 128 q rows of one (head, batch).
//   * warpgroup 0, the producer (setmaxnreg 40): one thread loads the CTA's
//     q (pre-scaled) and do tiles once by TMA, then keeps a ring of
//     DQ_STAGES k and v tiles of DQ_KEYS keys in flight over the key tiles
//     the band and the lengths leave (`kv_tile_range`, the forward's
//     walk), one full and one empty mbarrier per stage;
//   * warpgroups 1 and 2, the consumers (setmaxnreg 232), own 64 q rows
//     each, with their lse and delta in registers and dq in fp32 registers
//     for the whole walk.  Per key tile: s = q k^T and dp = do v^T (SS
//     wgmma); p = 2^(s log2 e - lse log2 e), a select on the valid pairs of
//     edge tiles only; ds = p (dp - delta); dq += ds k (RS wgmma, ds rounded
//     to bf16 as the A operand, k read MN-major as the forward reads v);
//   * dq leaves once, from registers.  One writer per element and a fixed
//     order of products: the same bits from run to run.
template <int D>
__global__ void __launch_bounds__(HTHREADS, 1)
    flash_bwd_dq_hopper(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo, const Params p) {
  using TL = BwdTile<D>;
  using bf = __nv_bfloat16;
  constexpr int Q_ELEMS = DQ_Q * D, KV_ELEMS = DQ_KEYS * D;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = hopper::smem_u32(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (base & 1023)) & 1023);
  bf* sQ = reinterpret_cast<bf*>(smem);
  bf* sO = sQ + Q_ELEMS;                      // do
  bf* sK = sO + Q_ELEMS;                      // DQ_STAGES tiles
  bf* sV = sK + DQ_STAGES * KV_ELEMS;         // DQ_STAGES tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + DQ_STAGES * KV_ELEMS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + DQ_STAGES;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < DQ_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup's index, read from lane 0 so that the compiler sees it is
  // the same across the warp: each role is then a region of its own
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * DQ_Q;  // the CTA's first local q row
  if (wg == 0) {
    // ---- producer ----
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    const Limits lim = limits(p, b);
    int lo, hi;
    kv_tile_range(p, lim, q0, DQ_Q, DQ_KEYS, lo, hi);
    if (threadIdx.x == 0 && lo < hi) {
      hopper::mbar_arrive_expect_tx(q_full, 2 * Q_ELEMS * 2);
#pragma unroll
      for (int c = 0; c < TL::BLOCKS; ++c) {
        hopper::tma_load_4d(sQ + c * DQ_Q * TL::COLS, &tq, q_full, c * TL::COLS, h, q0, b);
        hopper::tma_load_4d(sO + c * DQ_Q * TL::COLS, &tdo, q_full, c * TL::COLS, h, q0, b);
      }
      for (int n = 0; n < hi - lo; ++n) {
        const int st = n % DQ_STAGES;
        const uint32_t ph = (n / DQ_STAGES) & 1;
        const int row = (lo + n) * DQ_KEYS;
        hopper::mbar_wait(&empty[st], ph ^ 1);
        hopper::mbar_arrive_expect_tx(&full[st], 2 * KV_ELEMS * 2);
#pragma unroll
        for (int c = 0; c < TL::BLOCKS; ++c) {
          hopper::tma_load_4d(sK + st * KV_ELEMS + c * DQ_KEYS * TL::COLS, &tk, &full[st],
                              c * TL::COLS, h, row, b);
          hopper::tma_load_4d(sV + st * KV_ELEMS + c * DQ_KEYS * TL::COLS, &tv, &full[st],
                              c * TL::COLS, h, row, b);
        }
      }
    }
  } else {
    // ---- consumers ----
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const Limits lim = limits(p, b);
    int lo, hi;
    kv_tile_range(p, lim, q0, DQ_Q, DQ_KEYS, lo, hi);
    const int cw = wg - 1;  // consumer 0 or 1: q rows q0 + 64 cw ..
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row_l[2] = {q0 + cw * 64 + warp * 16 + g, q0 + cw * 64 + warp * 16 + g + 8};
    const int row_g[2] = {p.q_off + row_l[0], p.q_off + row_l[1]};
    // the rows' lse (times log2 e) and delta; rows past Tq are never valid
    float lse2[2], del[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long i = ((long long)b * p.H + h) * p.Tq + row_l[r];
      lse2[r] = row_l[r] < p.Tq ? p.lse[i] * LOG2E : 0.f;
      del[r] = row_l[r] < p.Tq ? p.delta[i] : 0.f;
    }
    // every tile needs the masks under a band or when the CTA's rows cross
    // the length; otherwise only the key tiles that cross it
    const bool row_edge = p.left >= 0 || p.right >= 0 || p.q_off + q0 + DQ_Q > lim.q_hi;
    const bf* sQc = sQ + cw * 64 * TL::COLS;  // this consumer's rows
    const bf* sOc = sO + cw * 64 * TL::COLS;

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    if (lo < hi) hopper::mbar_wait(q_full, 0);
    for (int n = 0; n < hi - lo; ++n) {
      const int st = n % DQ_STAGES;
      const uint32_t ph = (n / DQ_STAGES) & 1;
      const int c0 = (lo + n) * DQ_KEYS;  // the tile's first local key
      const bf* tK = sK + st * KV_ELEMS;
      const bf* tV = sV + st * KV_ELEMS;
      hopper::mbar_wait(&full[st], ph);

      float s[DQ_KEYS / 2], dp[DQ_KEYS / 2];
      hopper::fence_all<DQ_KEYS / 2>(s);
      hopper::fence_all<DQ_KEYS / 2>(dp);
      hopper::wgmma_fence();
      issue_rows_by_keys<D>(s, sQc, tK);
      issue_rows_by_keys<D>(dp, sOc, tV);
      hopper::fence_all<DQ_KEYS / 2>(s);
      hopper::fence_all<DQ_KEYS / 2>(dp);

      // p on the valid pairs; rows past the length carry lse = -1e30 and
      // give inf here, which the select drops
      const bool edge = row_edge || p.kv_off + c0 + DQ_KEYS > lim.kv_hi;
      hopper::wgmma_wait<1>();
      hopper::fence_all<DQ_KEYS / 2>(s);
#pragma unroll
      for (int j = 0; j < DQ_KEYS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = hopper::ex2(fmaf(s[4 * j + e], LOG2E, -lse2[e >> 1]));
          if (edge) {
            const int col_g = p.kv_off + c0 + 8 * j + 2 * t + (e & 1);
            if (!pair_valid(p, lim, row_g[e >> 1], col_g)) x = 0.f;
          }
          s[4 * j + e] = x;
        }
      // ds = p (dp - delta) in place of dp
      hopper::wgmma_wait<0>();
      hopper::fence_all<DQ_KEYS / 2>(dp);
#pragma unroll
      for (int j = 0; j < DQ_KEYS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - del[e >> 1]);
      uint32_t da[DQ_KEYS / 16][4];
      hopper::pack_frags<DQ_KEYS / 16>(da, dp);

      // dq += ds k: the keys 16 kc .. 16 kc + 15 are rows of every column
      // block of k; the leading byte offset steps from one block to the next
      hopper::fence_all<D / 2>(dq);
      hopper::fence_frags<DQ_KEYS / 16>(da);
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < DQ_KEYS / 16; ++kc) {
        const uint64_t dk = hopper::smem_desc(tK + kc * 16 * TL::COLS,
                                              DQ_KEYS * TL::ROW_BYTES, TL::SBO, TL::LAYOUT);
        hopper::wgmma_rs_tb<D>(dq, da[kc], dk);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_all<D / 2>(dq);
      hopper::fence_frags<DQ_KEYS / 16>(da);
      if (lane == 0) hopper::mbar_arrive(&empty[st]);  // k and v read
    }

    // dq written once, fp32, without the scale (rows past Tq are not there)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row_l[r] >= p.Tq) continue;
      float* row = p.dq + (((long long)b * p.Tq + row_l[r]) * p.H + h) * D + t * 2;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(row + 8 * j) = make_float2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
    }
  }
}

// Tensor maps of q, k, v and do and the launch of K4; errors of the maps'
// encoding and of the launch are returned, nothing is synchronised.
template <int D>
cudaError_t launch_hopper_dq(const Params& p, cudaStream_t stream) {
  using TL = BwdTile<D>;
  CUtensorMap mq, mk, mv, mo;
  cudaError_t err = hopper::bthd_map(&mq, p.q, p.B, p.Tq, p.H, D, p.q_sb, p.q_st,
                                     p.q_sh, DQ_Q, TL::COLS, TL::TMA_SWIZZLE);
  if (err == cudaSuccess)
    err = hopper::bthd_map(&mk, p.k, p.B, p.Tk, p.H, D, p.k_sb, p.k_st, p.k_sh,
                           DQ_KEYS, TL::COLS, TL::TMA_SWIZZLE);
  if (err == cudaSuccess)
    err = hopper::bthd_map(&mv, p.v, p.B, p.Tk, p.H, D, p.v_sb, p.v_st, p.v_sh,
                           DQ_KEYS, TL::COLS, TL::TMA_SWIZZLE);
  if (err == cudaSuccess)
    err = hopper::bthd_map(&mo, p.dout, p.B, p.Tq, p.H, D, p.o_sb, p.o_st,
                           p.o_sh, DQ_Q, TL::COLS, TL::TMA_SWIZZLE);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dq_hopper<D>;
  constexpr size_t smem = dq_smem<D>();
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + DQ_Q - 1) / DQ_Q, p.H, p.B);
  kernel<<<grid, HTHREADS, smem, stream>>>(mq, mk, mv, mo, p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: SIMT FMA (slow; kept for the fp32 inputs the JAX kernels accept).
// Four threads share a row; thread `qq` of a row owns dims qq, qq+4, ...
// ---------------------------------------------------------------------------
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// K3 (WITH_DQ) and K5 for fp32: 32 keys per CTA, 32-row q tiles.
template <int D, bool WITH_DQ>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_kv_f32(const Params p) {
  constexpr int PER = D / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // BR x D
  float* sO = sQ + BR * D;                         // BR x D
  float* sK = sO + BR * D;                         // BR x D
  float* sS = sK + BR * D;                         // ds as (q, key), BR x (BR+1)
  float* sL = sS + BR * (BR + 1);
  float* sD = sL + BR;

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = kt * BR;
  const int key = threadIdx.x / 4, qq = threadIdx.x % 4;
  const int key_l = c0 + key, key_g = p.kv_off + key_l;
  const Limits lim = limits(p, b);
  int lo, hi;
  q_tile_range(p, lim, c0, BR, BR, lo, hi);

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* ob = static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* lse_b = p.lse + ((long long)b * p.H + h) * p.Tq;
  const float* del_b = p.delta + ((long long)b * p.H + h) * p.Tq;

  float kr[PER], vr[PER], dk[PER], dv[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const bool ok = key_l < p.Tk;
    kr[i] = ok ? kb[(long long)key_l * p.k_st + i * 4 + qq] : 0.f;
    vr[i] = ok ? vb[(long long)key_l * p.v_st + i * 4 + qq] : 0.f;
    if (WITH_DQ) sK[key * D + i * 4 + qq] = kr[i];
    dk[i] = dv[i] = 0.f;
  }

  for (int it = lo; it < hi; ++it) {
    const int q0 = it * BR;
    __syncthreads();  // the previous tile is consumed (and sK written)
    for (int i = threadIdx.x; i < BR * D; i += NTHREADS) {
      const int r = i / D, d = i % D;
      const bool ok = q0 + r < p.Tq;
      sQ[i] = ok ? qb[(long long)(q0 + r) * p.q_st + d] : 0.f;
      sO[i] = ok ? ob[(long long)(q0 + r) * p.o_st + d] : 0.f;
    }
    load_stats(sL, sD, lse_b, del_b, q0, BR, p.Tq);
    __syncthreads();

    for (int r = 0; r < BR; ++r) {
      float sp = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        sp = fmaf(sQ[r * D + i * 4 + qq], kr[i], sp);
        dp = fmaf(sO[r * D + i * 4 + qq], vr[i], dp);
      }
      sp = quad_sum(sp);
      dp = quad_sum(dp);
      const bool ok = pair_valid(p, lim, p.q_off + q0 + r, key_g);
      const float pr = ok ? expf(sp - sL[r]) : 0.f;
      const float ds = pr * (dp - sD[r]);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        dv[i] = fmaf(pr, sO[r * D + i * 4 + qq], dv[i]);
        dk[i] = fmaf(ds, sQ[r * D + i * 4 + qq], dk[i]);
      }
      if (WITH_DQ && qq == 0) sS[r * (BR + 1) + key] = ds;
    }

    if (WITH_DQ) {
      __syncthreads();
      const int rr = threadIdx.x / 4, row_l = q0 + rr;
      if (p.q_off + row_l < lim.q_hi) {
        float acc[PER];
#pragma unroll
        for (int i = 0; i < PER; ++i) acc[i] = 0.f;
        for (int c = 0; c < BR; ++c) {
          const float ds = sS[rr * (BR + 1) + c];
#pragma unroll
          for (int i = 0; i < PER; ++i) acc[i] = fmaf(ds, sK[c * D + i * 4 + qq], acc[i]);
        }
        float* row = p.dq + (((long long)b * p.Tq + row_l) * p.H + h) * D;
#pragma unroll
        for (int i = 0; i < PER; ++i) atomicAdd(row + i * 4 + qq, acc[i]);
      }
    }
  }

  if (key_l < p.Tk) {
    const long long off = (((long long)b * p.Tk + key_l) * p.H + h) * D;
    float* dkb = static_cast<float*>(p.dk) + off;
    float* dvb = static_cast<float*>(p.dv) + off;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      dkb[i * 4 + qq] = dk[i];
      dvb[i * 4 + qq] = dv[i];
    }
  }
}

// K4 for fp32: 32 q rows per CTA, 32-key tiles.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_q_f32(const Params p) {
  constexpr int PER = D / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);  // BR x D
  float* sV = sK + BR * D;                         // BR x D

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BR;
  const int row = threadIdx.x / 4, qq = threadIdx.x % 4;
  const int row_l = q0 + row, row_g = p.q_off + row_l;
  const Limits lim = limits(p, b);
  int lo, hi;
  kv_tile_range(p, lim, q0, BR, BR, lo, hi);

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* ob = static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const bool live = row_l < p.Tq;
  const long long si = ((long long)b * p.H + h) * p.Tq + row_l;
  const float lse_r = live ? p.lse[si] : 0.f;
  const float del_r = live ? p.delta[si] : 0.f;

  float qr[PER], orr[PER], acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    qr[i] = live ? qb[(long long)row_l * p.q_st + i * 4 + qq] : 0.f;
    orr[i] = live ? ob[(long long)row_l * p.o_st + i * 4 + qq] : 0.f;
    acc[i] = 0.f;
  }

  for (int kt = lo; kt < hi; ++kt) {
    const int c0 = kt * BR;
    __syncthreads();
    for (int i = threadIdx.x; i < BR * D; i += NTHREADS) {
      const int r = i / D, d = i % D;
      const bool ok = c0 + r < p.Tk;
      sK[i] = ok ? kb[(long long)(c0 + r) * p.k_st + d] : 0.f;
      sV[i] = ok ? vb[(long long)(c0 + r) * p.v_st + d] : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < BR; ++c) {
      float sp = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        sp = fmaf(qr[i], sK[c * D + i * 4 + qq], sp);
        dp = fmaf(orr[i], sV[c * D + i * 4 + qq], dp);
      }
      sp = quad_sum(sp);
      dp = quad_sum(dp);
      const bool ok = pair_valid(p, lim, row_g, p.kv_off + c0 + c);
      const float pr = ok ? expf(sp - lse_r) : 0.f;
      const float ds = pr * (dp - del_r);
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[i] = fmaf(ds, sK[c * D + i * 4 + qq], acc[i]);
    }
  }

  if (live) {
    float* out = p.dq + (((long long)b * p.Tq + row_l) * p.H + h) * D;
#pragma unroll
    for (int i = 0; i < PER; ++i) out[i * 4 + qq] = acc[i];
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int D>
cudaError_t dispatch(const Params& p, int kind, int is_f32, cudaStream_t s) {
  if (is_f32) {
    if (kind == DQ)
      return launch(flash_bwd_q_f32<D>, dim3(cdiv(p.Tq, BR), p.H, p.B),
                    sizeof(float) * 2 * BR * D, p, s);
    const size_t smem = sizeof(float) * (3 * BR * D + BR * (BR + 1) + 2 * BR);
    const dim3 grid(cdiv(p.Tk, BR), p.H, p.B);
    return kind == FUSED ? launch(flash_bwd_kv_f32<D, true>, grid, smem, p, s)
                         : launch(flash_bwd_kv_f32<D, false>, grid, smem, p, s);
  }
  if (kind == DQ) return launch_hopper_dq<D>(p, s);
  return kind == FUSED ? launch_hopper_bwd<D, true>(p, s)
                       : launch_hopper_bwd<D, false>(p, s);
}

}  // namespace

extern "C" {

// kind: 0 = K3 (dq into a zeroed fp32 buffer, dk, dv), 1 = K4 (dq),
// 2 = K5 (dk, dv).  Returns a cudaError_t (0 on success): the launch's own
// error, from cudaGetLastError() right after it.
int lcasr_flash_attn_bwd(int kind, const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         const void* lengths, void* dq, void* dk, void* dv,
                         int B, int H, int Tq, int Tk, int D, int is_f32,
                         long long q_sb, long long q_st, long long q_sh,
                         long long k_sb, long long k_st, long long k_sh,
                         long long v_sb, long long v_st, long long v_sh,
                         long long o_sb, long long o_st, long long o_sh,
                         int q_off, int kv_off, int left, int right,
                         void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.lengths = static_cast<const int*>(lengths);
  p.dq = static_cast<float*>(dq);
  p.dk = dk;
  p.dv = dv;
  p.B = B;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.q_sb = q_sb;
  p.q_st = q_st;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_st = k_st;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_st = v_st;
  p.v_sh = v_sh;
  p.o_sb = o_sb;
  p.o_st = o_st;
  p.o_sh = o_sh;
  p.q_off = q_off;
  p.kv_off = kv_off;
  p.left = left;
  p.right = right;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind < FUSED || kind > DKV) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32:
      return dispatch<32>(p, kind, is_f32, s);
    case 64:
      return dispatch<64>(p, kind, is_f32, s);
    case 128:
      return dispatch<128>(p, kind, is_f32, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* lcasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
