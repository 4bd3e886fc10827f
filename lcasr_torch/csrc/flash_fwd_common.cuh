// What the two flash-attention forward kernels share (flash_attn_fwd.cu, K1,
// and flash_attn_fwd_db.cu, K2): the parameters, the range of k/v tiles a
// CTA visits, the masks, and, for fp32 on the CUDA cores, one tile's worth of
// each step (scores, online softmax with O += P V, the final write).  The
// bf16 kernels are in flash_fwd_hopper.cuh.
#pragma once

#include "flash_common.cuh"

namespace {

constexpr int BQ = 64;  // query rows per CTA of the fp32 kernels
constexpr int BK = 64;  // keys per k/v tile of the fp32 kernels
constexpr int NTHREADS = 128;
constexpr float LSE_EMPTY = -1e30f;  // lse of a row with no valid key
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;           // (B, Tq, H, D) contiguous, q's dtype
  float* lse;        // (B, H, Tq) contiguous
  const int* lengths;  // (B,) global lengths
  int B, H, Tq, Tk;
  long long q_sb, q_st, q_sh;  // element strides; the D stride is 1
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  int q_off, kv_off, left, right;
};

// The bounds of a CTA of TQ query rows from local row q0 that walks k/v tiles
// of TK keys: valid global rows < q_hi, valid global cols < kv_hi, and the
// half-open range [t_lo, t_hi) of local k/v tiles it must visit (empty when
// t_hi <= t_lo).  Tiles outside the range are wholly masked for every row of
// the CTA and are never loaded, scored or fed to the softmax.
struct Bounds {
  int q_hi, kv_hi, t_lo, t_hi;
};

template <int TQ, int TK>
__device__ __forceinline__ Bounds cta_bounds(const Params& p, int b, int q0) {
  Bounds r;
  const int len = p.lengths[b];
  r.q_hi = min(len, p.q_off + p.Tq);
  r.kv_hi = min(len, p.kv_off + p.Tk);
  const int qg0 = p.q_off + q0;
  const int kv_valid = r.kv_hi - p.kv_off;  // local cols below this are valid
  r.t_lo = 0;
  r.t_hi = kv_valid > 0 ? (kv_valid + TK - 1) / TK : 0;
  if (qg0 >= r.q_hi) r.t_hi = 0;
  if (p.left >= 0) r.t_lo = max(0, floordiv(qg0 - p.left - p.kv_off, TK));
  if (p.right >= 0)
    r.t_hi = min(r.t_hi, floordiv(qg0 + TQ - 1 + p.right - p.kv_off, TK) + 1);
  return r;
}

__device__ __forceinline__ bool col_valid(const Params& p, const Bounds& bd,
                                          int row_g, int col_g) {
  bool ok = col_g < bd.kv_hi;
  if (p.right >= 0) ok = ok && (col_g <= row_g + p.right);
  if (p.left >= 0) ok = ok && (col_g >= row_g - p.left);
  return ok;
}

// ---------------------------------------------------------------------------
// fp32 SIMT: two threads per query row (r = thread / 2), each holding half of
// the tile's scores and half of the row's output (hf = thread % 2)
// ---------------------------------------------------------------------------

// Rows of a (b, h) slice starting at r0 into a shared tile with row stride
// LD; rows at or past `limit` are zero.
template <int D, int LD, int ROWS>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* base,
                                              long long st, int r0, int limit) {
  for (int i = threadIdx.x; i < ROWS * D; i += NTHREADS) {
    const int rr = i / D, d = i % D;
    dst[rr * LD + d] = r0 + rr < limit ? base[(long long)(r0 + rr) * st + d] : 0.f;
  }
}

// This thread's BK/2 masked scores of tile kt.
template <int D>
__device__ __forceinline__ void scores_f32(float* s, const float* sQ,
                                           const float* sK, const Params& p,
                                           const Bounds& bd, int kt, int r,
                                           int hf, int row_g) {
  constexpr int LDQ = D + 1;
#pragma unroll 4
  for (int j = 0; j < BK / 2; ++j) {
    const int c = hf * (BK / 2) + j;
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot = fmaf(sQ[r * LDQ + d], sK[c * LDQ + d], dot);
    if (!col_valid(p, bd, row_g, p.kv_off + kt * BK + c)) dot = -INFINITY;
    s[j] = dot;
  }
}

// Online softmax of one tile's masked scores and acc += P V; P crosses the
// two halves of a row through shared memory (both halves live in one warp).
template <int D>
__device__ __forceinline__ void softmax_pv_f32(const float* s, float* acc,
                                               float& m_i, float& l_i,
                                               float* sP, const float* sV,
                                               int r, int hf) {
  constexpr int HALF = D / 2;
  float mx = m_i;
#pragma unroll 4
  for (int j = 0; j < BK / 2; ++j) mx = fmaxf(mx, s[j]);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  const float m_use = mx == -INFINITY ? 0.f : mx;
  const float corr = expf(m_i - m_use);
  m_i = mx;
  l_i *= corr;
#pragma unroll 4
  for (int j = 0; j < BK / 2; ++j) {
    const float e = expf(s[j] - m_use);
    l_i += e;
    sP[r * (BK + 1) + hf * (BK / 2) + j] = e;
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < HALF; ++i) acc[i] *= corr;
  for (int c = 0; c < BK; ++c) {
    const float pc = sP[r * (BK + 1) + c];
    const float* vrow = sV + c * D + hf * HALF;
#pragma unroll
    for (int i = 0; i < HALF; ++i) acc[i] = fmaf(pc, vrow[i], acc[i]);
  }
}

template <int D>
__device__ __forceinline__ void finish_f32(const Params& p, const Bounds& bd,
                                           const float* acc, float m_i,
                                           float l_i, int b, int h, int row_l,
                                           int row_g, int hf) {
  constexpr int HALF = D / 2;
  const float l = l_i + __shfl_xor_sync(0xffffffffu, l_i, 1);
  const bool live = l > 0.f && row_g < bd.q_hi;
  const float inv = live ? 1.f / l : 0.f;
  if (row_l < p.Tq) {
    float* orow = static_cast<float*>(p.o) +
                  (((long long)b * p.Tq + row_l) * p.H + h) * D + hf * HALF;
#pragma unroll
    for (int i = 0; i < HALF; ++i) orow[i] = acc[i] * inv;
    if (hf == 0)
      p.lse[((long long)b * p.H + h) * p.Tq + row_l] =
          live ? m_i + logf(l) : LSE_EMPTY;
  }
}

// Shared-memory sizes of the fp32 kernels: Q (BQ x D+1), one K tile
// (BK x D+1), one V tile (BK x D), P (BQ x BK+1).  At D = 256 that is
// 213,760 bytes, within the 232,448 a block may use, and each thread holds
// 128 floats of O: the same 64 x 64 tiles serve every D.
template <int D>
constexpr size_t smem_f32() {
  return sizeof(float) * ((size_t)(BQ + BK) * (D + 1) + BK * D + BQ * (BK + 1));
}
static_assert(smem_f32<256>() <= 232448, "fp32 tiles at D = 256 exceed shared memory");

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + BQ - 1) / BQ, p.H, p.B);
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

__host__ inline Params make_params(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* lengths, int B, int H, int Tq, int Tk, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh, int q_off,
    int kv_off, int left, int right) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.lengths = static_cast<const int*>(lengths);
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
  p.q_off = q_off;
  p.kv_off = kv_off;
  p.left = left;
  p.right = right;
  return p;
}

}  // namespace
