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
// K3 does 5 products of 2*T*T*D per (b, h) = 129 GFLOP on about 101 MB, so
// the tensor cores, not the memory, bound it (K4: 3 products, K5: 4).
//
// Design (first, simple kernels; wgmma/TMA versions are later work):
//   * K3 and K5: one CTA of 4 warps per (64-key tile, head, batch); each warp
//     owns 16 keys and keeps their dk and dv rows in fp32 registers while
//     the CTA walks the 64-row q tiles that can meet the key tile (the band
//     and the lengths cut the range).  q / do tiles are double-buffered in
//     shared memory with cp.async, read in place through their strides.
//     Each warp computes s^T = k q^T and dp^T = v do^T for its keys, so p^T
//     and ds^T stay in registers and feed dv += p^T do and dk += ds^T q as
//     A fragments of bf16 mma.sync m16n8k16 (fp32 accumulation).
//   * K3 also needs dq = ds k, a sum over all key tiles: ds is staged in
//     shared memory as (q, key), each warp multiplies 16 q rows of it by the
//     CTA's key tile, and adds the fp32 result into a zeroed (B, T, H, D)
//     buffer with atomicAdd.  The Pallas kernel's aliased dq input/output
//     has no CUDA counterpart; the atomics make dq's summation order vary
//     from run to run (the only non-deterministic output).
//   * K4: one CTA per (64-row q tile, head, batch), walking the key tiles in
//     band; dq stays in registers and is written once, in fp32.
// fp32 inputs take SIMT kernels of the same structure (32-row tiles, four
// threads per row, fp32 FMA, no tensor cores).  They are slow, and are
// there because the JAX kernels accept fp32.

#include "flash_common.cuh"

namespace {

constexpr int BQ = 64;  // q rows per tile (bf16)
constexpr int BK = 64;  // keys per tile (bf16)
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

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 x 16, row-major) of the rows at `lo` (row g) and lo + 8*ld
// (row g + 8), k-step kk; `lo` already points at column t*2.
__device__ __forceinline__ void a_frag(uint32_t* a, const __nv_bfloat16* lo,
                                       int ld, int kk) {
  a[0] = ld32(lo + kk * 16);
  a[1] = ld32(lo + 8 * ld + kk * 16);
  a[2] = ld32(lo + kk * 16 + 8);
  a[3] = ld32(lo + 8 * ld + kk * 16 + 8);
}

// A fragment of the 16 x 16 block kc of a C-fragment tile held in registers
// (columns 16kc..16kc+15 = n-tiles 2kc, 2kc+1), rounded to bf16.
__device__ __forceinline__ void a_from_c(uint32_t* a, float (*c)[4], int kc) {
  a[0] = pack_bf16(c[2 * kc][0], c[2 * kc][1]);
  a[1] = pack_bf16(c[2 * kc][2], c[2 * kc][3]);
  a[2] = pack_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
  a[3] = pack_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
}

// acc (16 x D) += A (16 x 16*KC, bf16 from C-fragment registers) times the
// shared tile `m` (16*KC rows x D, row stride LD) read through ldmatrix.trans.
template <int D, int LD, int KC>
__device__ __forceinline__ void acc_times_tile(float (*acc)[4], float (*c)[4],
                                               const __nv_bfloat16* m,
                                               int lane) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    uint32_t a[4];
    a_from_c(a, c, kc);
    const __nv_bfloat16* row = m + (kc * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int dt = 0; dt < D / 8; dt += 2) {
      uint32_t b4[4];
      ldmatrix_x4_trans(b4, row + dt * 8);
      mma_bf16(acc[dt], a, b4[0], b4[1]);
      mma_bf16(acc[dt + 1], a, b4[2], b4[3]);
    }
  }
}

// c (16 x 8*NT) = rows(16 x D, at `a_lo`, stride LD) times tile^T, where the
// shared tile holds 8*NT rows of D (row stride LD): c[n] = a . tile[n].
template <int D, int LD, int NT>
__device__ __forceinline__ void rows_times_tile_t(float (*c)[4],
                                                  const __nv_bfloat16* a_lo,
                                                  const __nv_bfloat16* tile,
                                                  int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    a_frag(a, a_lo, LD, kk);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat16* brow = tile + (nt * 8 + g) * LD + t * 2 + kk * 16;
      mma_bf16(c[nt], a, ld32(brow), ld32(brow + 8));
    }
  }
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

// K3 (WITH_DQ) and K5: dk, dv for one key tile; K3 also adds dq.
template <int D, bool WITH_DQ>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_kv_bf16(const Params p) {
  constexpr int LD = D + 8;    // padded row: conflict-free fragment loads
  constexpr int LDS = BK + 8;  // row stride of the staged ds (q, key)
  constexpr int NT = BQ / 8;   // n-tiles of s^T over the q tile
  constexpr int DT = D / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + BK * LD;
  __nv_bfloat16* sQ = sV + BK * LD;      // 2 buffers
  __nv_bfloat16* sO = sQ + 2 * BQ * LD;  // do, 2 buffers
  __nv_bfloat16* sS = sO + 2 * BQ * LD;  // ds as (q, key)
  float* sL = reinterpret_cast<float*>(sS + BQ * LDS);  // 2 buffers
  float* sD = sL + 2 * BQ;                              // 2 buffers

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = kt * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const Limits lim = limits(p, b);
  int lo, hi;
  q_tile_range(p, lim, c0, BQ, BK, lo, hi);

  using bf = __nv_bfloat16;
  const bf* qb = static_cast<const bf*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf* kb = static_cast<const bf*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf* vb = static_cast<const bf*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf* ob = static_cast<const bf*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* lse_b = p.lse + ((long long)b * p.H + h) * p.Tq;
  const float* del_b = p.delta + ((long long)b * p.H + h) * p.Tq;

  // keys this thread owns in the C fragments: g and g + 8 of its warp
  const int key_l[2] = {c0 + warp * 16 + g, c0 + warp * 16 + g + 8};
  const int key_g[2] = {p.kv_off + key_l[0], p.kv_off + key_l[1]};

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.f;

  if (lo < hi) {
    load_tile_async<D, LD, BK, NTHREADS>(sK, kb, p.k_st, c0, p.Tk);
    load_tile_async<D, LD, BK, NTHREADS>(sV, vb, p.v_st, c0, p.Tk);
    load_tile_async<D, LD, BQ, NTHREADS>(sQ, qb, p.q_st, lo * BQ, p.Tq);
    load_tile_async<D, LD, BQ, NTHREADS>(sO, ob, p.o_st, lo * BQ, p.Tq);
    cp_async_commit();
    load_stats(sL, sD, lse_b, del_b, lo * BQ, BQ, p.Tq);
    cp_async_wait_all();
    __syncthreads();
  }

  const bf* k_lo = sK + (warp * 16 + g) * LD + t * 2;
  const bf* v_lo = sV + (warp * 16 + g) * LD + t * 2;
  for (int it = lo; it < hi; ++it) {
    const int buf = (it - lo) & 1;
    const int q0 = it * BQ;
    if (it + 1 < hi) {  // prefetch the next q / do tile into the other buffer
      const int nb = buf ^ 1;
      load_tile_async<D, LD, BQ, NTHREADS>(sQ + nb * BQ * LD, qb, p.q_st, q0 + BQ, p.Tq);
      load_tile_async<D, LD, BQ, NTHREADS>(sO + nb * BQ * LD, ob, p.o_st, q0 + BQ, p.Tq);
      load_stats(sL + nb * BQ, sD + nb * BQ, lse_b, del_b, q0 + BQ, BQ, p.Tq);
    }
    cp_async_commit();
    const bf* tQ = sQ + buf * BQ * LD;
    const bf* tO = sO + buf * BQ * LD;
    const float* tL = sL + buf * BQ;
    const float* tD = sD + buf * BQ;

    // s^T = k q^T (16 keys x 64 q per warp), then p^T on the valid pairs
    float s[NT][4];
    rows_times_tile_t<D, LD, NT>(s, k_lo, tQ, g, t);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = nt * 8 + t * 2 + (i & 1);  // q row in the tile
        const bool ok = pair_valid(p, lim, p.q_off + q0 + col, key_g[i >> 1]);
        s[nt][i] = ok ? exp2f((s[nt][i] - tL[col]) * LOG2E) : 0.f;
      }

    // dv += p^T do
    acc_times_tile<D, LD, BQ / 16>(dv, s, tO, lane);

    // dp^T = v do^T, then ds^T = p^T (dp^T - delta) in place of p^T
    {
      float dp[NT][4];
      rows_times_tile_t<D, LD, NT>(dp, v_lo, tO, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[nt][i] *= dp[nt][i] - tD[nt * 8 + t * 2 + (i & 1)];
    }
    if (WITH_DQ) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          sS[(nt * 8 + t * 2 + (i & 1)) * LDS + warp * 16 + g + 8 * (i >> 1)] =
              __float2bfloat16(s[nt][i]);
    }

    // dk += ds^T q
    acc_times_tile<D, LD, BQ / 16>(dk, s, tQ, lane);

    if (WITH_DQ) {
      __syncthreads();  // the whole ds tile is staged
      // dq (64 q x D) += ds (64 q x 64 keys) k; this warp: q rows 16w..16w+15
      uint32_t sa[BK / 16][4];
      const bf* s_lo = sS + (warp * 16 + g) * LDS + t * 2;
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) a_frag(sa[kc], s_lo, LDS, kc);
      const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
      const bool ok0 = p.q_off + r0 < lim.q_hi, ok1 = p.q_off + r1 < lim.q_hi;
      float* dq0 = p.dq + (((long long)b * p.Tq + r0) * p.H + h) * D + t * 2;
      float* dq1 = dq0 + 8LL * p.H * D;
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kc = 0; kc < BK / 16; ++kc) {
          uint32_t b4[4];
          ldmatrix_x4_trans(b4, sK + (kc * 16 + (lane & 15)) * LD +
                                    (lane >> 4) * 8 + dt * 8);
          mma_bf16(a0, sa[kc], b4[0], b4[1]);
          mma_bf16(a1, sa[kc], b4[2], b4[3]);
        }
        if (ok0) {
          atomicAdd(dq0 + dt * 8, a0[0]);
          atomicAdd(dq0 + dt * 8 + 1, a0[1]);
          atomicAdd(dq0 + dt * 8 + 8, a1[0]);
          atomicAdd(dq0 + dt * 8 + 9, a1[1]);
        }
        if (ok1) {
          atomicAdd(dq1 + dt * 8, a0[2]);
          atomicAdd(dq1 + dt * 8 + 1, a0[3]);
          atomicAdd(dq1 + dt * 8 + 8, a1[2]);
          atomicAdd(dq1 + dt * 8 + 9, a1[3]);
        }
      }
    }

    cp_async_wait_all();
    __syncthreads();
  }

  bf* dkb = static_cast<bf*>(p.dk);
  bf* dvb = static_cast<bf*>(p.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key_l[r] >= p.Tk) continue;
    const long long off = (((long long)b * p.Tk + key_l[r]) * p.H + h) * D + t * 2;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<uint32_t*>(dkb + off + dt * 8) =
          pack_bf16(dk[dt][2 * r], dk[dt][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dvb + off + dt * 8) =
          pack_bf16(dv[dt][2 * r], dv[dt][2 * r + 1]);
    }
  }
}

// K4: dq for one q tile, in fp32 and without the scale.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_q_bf16(const Params p) {
  constexpr int LD = D + 8;
  constexpr int KT = D / 16;
  constexpr int NT = BK / 8;
  constexpr int DT = D / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sO = sQ + BQ * LD;
  __nv_bfloat16* sK = sO + BQ * LD;      // 2 buffers
  __nv_bfloat16* sV = sK + 2 * BK * LD;  // 2 buffers

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const Limits lim = limits(p, b);
  int lo, hi;
  kv_tile_range(p, lim, q0, BQ, BK, lo, hi);

  using bf = __nv_bfloat16;
  const bf* qb = static_cast<const bf*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf* kb = static_cast<const bf*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf* vb = static_cast<const bf*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf* ob = static_cast<const bf*>(p.dout) + b * p.o_sb + h * p.o_sh;

  const int row_l[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const int row_g[2] = {p.q_off + row_l[0], p.q_off + row_l[1]};
  float lse_r[2], del_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long i = ((long long)b * p.H + h) * p.Tq + row_l[r];
    lse_r[r] = row_l[r] < p.Tq ? p.lse[i] : 0.f;
    del_r[r] = row_l[r] < p.Tq ? p.delta[i] : 0.f;
  }

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (lo < hi) {
    load_tile_async<D, LD, BQ, NTHREADS>(sQ, qb, p.q_st, q0, p.Tq);
    load_tile_async<D, LD, BQ, NTHREADS>(sO, ob, p.o_st, q0, p.Tq);
    load_tile_async<D, LD, BK, NTHREADS>(sK, kb, p.k_st, lo * BK, p.Tk);
    load_tile_async<D, LD, BK, NTHREADS>(sV, vb, p.v_st, lo * BK, p.Tk);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  }

  uint32_t qa[KT][4];
  const bf* q_lo = sQ + (warp * 16 + g) * LD + t * 2;
  const bf* o_lo = sO + (warp * 16 + g) * LD + t * 2;
  if (lo < hi) {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) a_frag(qa[kk], q_lo, LD, kk);
  }

  for (int kt = lo; kt < hi; ++kt) {
    const int buf = (kt - lo) & 1;
    if (kt + 1 < hi) {
      load_tile_async<D, LD, BK, NTHREADS>(sK + (buf ^ 1) * BK * LD, kb, p.k_st,
                                 (kt + 1) * BK, p.Tk);
      load_tile_async<D, LD, BK, NTHREADS>(sV + (buf ^ 1) * BK * LD, vb, p.v_st,
                                 (kt + 1) * BK, p.Tk);
    }
    cp_async_commit();
    const bf* tK = sK + buf * BK * LD;
    const bf* tV = sV + buf * BK * LD;

    // s = q k^T (16 q x 64 keys per warp), p on the valid pairs
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf* krow = tK + (nt * 8 + g) * LD + t * 2;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        mma_bf16(s[nt], qa[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
    }
    const int c0 = kt * BK;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col_g = p.kv_off + c0 + nt * 8 + t * 2 + (i & 1);
        const bool ok = pair_valid(p, lim, row_g[i >> 1], col_g);
        s[nt][i] = ok ? exp2f((s[nt][i] - lse_r[i >> 1]) * LOG2E) : 0.f;
      }

    // dp = do v^T, ds = p (dp - delta) in place of p
    {
      float dp[NT][4];
      rows_times_tile_t<D, LD, NT>(dp, o_lo, tV, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] *= dp[nt][i] - del_r[i >> 1];
    }

    // dq += ds k
    acc_times_tile<D, LD, BK / 16>(acc, s, tK, lane);

    cp_async_wait_all();
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row_l[r] >= p.Tq) continue;
    float* row = p.dq + (((long long)b * p.Tq + row_l[r]) * p.H + h) * D + t * 2;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<float2*>(row + dt * 8) =
          make_float2(acc[dt][2 * r], acc[dt][2 * r + 1]);
  }
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
  if (kind == DQ)
    return launch(flash_bwd_q_bf16<D>, dim3(cdiv(p.Tq, BQ), p.H, p.B),
                  sizeof(__nv_bfloat16) * (2 * BQ + 4 * BK) * (D + 8), p, s);
  const size_t smem = sizeof(__nv_bfloat16) *
                          ((2 * BK + 4 * BQ) * (D + 8) + BQ * (BK + 8)) +
                      sizeof(float) * 4 * BQ;
  const dim3 grid(cdiv(p.Tk, BK), p.H, p.B);
  return kind == FUSED ? launch(flash_bwd_kv_bf16<D, true>, grid, smem, p, s)
                       : launch(flash_bwd_kv_bf16<D, false>, grid, smem, p, s);
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
