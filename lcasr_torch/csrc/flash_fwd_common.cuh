// What the two flash-attention forward kernels share (flash_attn_fwd.cu, K1,
// and flash_attn_fwd_db.cu, K2): the parameters, the range of k/v tiles a
// CTA visits, the masks, and one tile's worth of each step (scores, online
// softmax with O += P V, the final write), for bf16 on the tensor cores and
// for fp32 on the CUDA cores.  The kernels differ only in the order in which
// they run these steps over the k/v tiles.
#pragma once

#include "flash_common.cuh"

namespace {

constexpr int BQ = 64;  // query rows per CTA
constexpr int BK = 64;  // keys per k/v tile
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

// The CTA's bounds: valid global rows < q_hi, valid global cols < kv_hi, and
// the half-open range [t_lo, t_hi) of local k/v tiles it must visit.  Tiles
// outside the range are wholly masked for every row of the CTA and are never
// loaded, scored or fed to the softmax.
struct Bounds {
  int q_hi, kv_hi, t_lo, t_hi;
};

__device__ __forceinline__ Bounds cta_bounds(const Params& p, int b, int q0) {
  Bounds r;
  const int len = p.lengths[b];
  r.q_hi = min(len, p.q_off + p.Tq);
  r.kv_hi = min(len, p.kv_off + p.Tk);
  const int qg0 = p.q_off + q0;
  const int kv_valid = r.kv_hi - p.kv_off;  // local cols below this are valid
  r.t_lo = 0;
  r.t_hi = kv_valid > 0 ? (kv_valid + BK - 1) / BK : 0;
  if (qg0 >= r.q_hi) r.t_hi = 0;
  if (p.left >= 0) r.t_lo = max(0, floordiv(qg0 - p.left - p.kv_off, BK));
  if (p.right >= 0)
    r.t_hi = min(r.t_hi, floordiv(qg0 + BQ - 1 + p.right - p.kv_off, BK) + 1);
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
// bf16: one warp owns 16 query rows; a thread holds rows g and g + 8 of the
// m16n8 C fragments (g = lane / 4, t = lane % 4)
// ---------------------------------------------------------------------------

// The warp's Q fragments (A operand of Q K^T) from the shared Q tile.
template <int D, int LD>
__device__ __forceinline__ void load_q_frags(uint32_t (*qa)[4],
                                             const __nv_bfloat16* sQ, int warp,
                                             int g, int t) {
  const __nv_bfloat16* q_lo = sQ + (warp * 16 + g) * LD + t * 2;
  const __nv_bfloat16* q_hi = q_lo + 8 * LD;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(q_lo + kk * 16);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(q_hi + kk * 16);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(q_lo + kk * 16 + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(q_hi + kk * 16 + 8);
  }
}

// S = Q K^T (16 x BK per warp), raw: no mask yet.
template <int D, int LD>
__device__ __forceinline__ void scores_bf16(float (*s)[4],
                                            const uint32_t (*qa)[4],
                                            const __nv_bfloat16* tK, int g,
                                            int t) {
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const __nv_bfloat16* krow = tK + (nt * 8 + g) * LD + t * 2;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
      const uint32_t b1 =
          *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
      mma_bf16(s[nt], qa[kk], b0, b1);
    }
  }
}

// Tile kt's masks, the online softmax and O += P V.  s holds the tile's raw
// scores and is overwritten with P; P goes to the tensor cores from these
// registers as bf16 A fragments, V's B operand by ldmatrix .trans.
template <int D, int LD>
__device__ __forceinline__ void softmax_pv_bf16(
    float (*s)[4], float (*acc)[4], float* m_i, float* l_i,
    const __nv_bfloat16* tV, const Params& p, const Bounds& bd, int kt,
    const int* row_g, int t, int lane) {
  constexpr int NT = BK / 8;  // n-tiles of S per warp
  constexpr int DT = D / 8;   // n-tiles of O per warp

  // masks: only tiles that cross the length edge or meet a band
  const int c0 = kt * BK;  // local col of the tile's first key
  if (p.left >= 0 || p.right >= 0 || p.kv_off + c0 + BK > bd.kv_hi) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col_g = p.kv_off + c0 + nt * 8 + t * 2 + (i & 1);
        if (!col_valid(p, bd, row_g[i >> 1], col_g)) s[nt][i] = -INFINITY;
      }
  }

  // online softmax; each row is spread over the 4 threads of a quad
  float m_new[2] = {m_i[0], m_i[1]};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) m_new[i >> 1] = fmaxf(m_new[i >> 1], s[nt][i]);
  float corr[2], m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
    m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
    m_use[r] = m_new[r] == -INFINITY ? 0.f : m_new[r];
    corr[r] = exp2f((m_i[r] - m_use[r]) * LOG2E);  // 0 while m_i is -inf
    m_i[r] = m_new[r];
    l_i[r] *= corr[r];
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float e = exp2f((s[nt][i] - m_use[i >> 1]) * LOG2E);
      s[nt][i] = e;
      l_i[i >> 1] += e;
    }
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    acc[dt][0] *= corr[0];
    acc[dt][1] *= corr[0];
    acc[dt][2] *= corr[1];
    acc[dt][3] *= corr[1];
  }

#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
    uint32_t pa[4];
    pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
    pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
    pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
    pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
    const __nv_bfloat16* vrow = tV + (kc * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int dt = 0; dt < DT; dt += 2) {
      uint32_t vb4[4];
      ldmatrix_x4_trans(vb4, vrow + dt * 8);
      mma_bf16(acc[dt], pa, vb4[0], vb4[1]);
      mma_bf16(acc[dt + 1], pa, vb4[2], vb4[3]);
    }
  }
}

// Full row sums across the quad, normalise, write o and lse.
template <int D>
__device__ __forceinline__ void finish_bf16(const Params& p, const Bounds& bd,
                                            float (*acc)[4], const float* m_i,
                                            const float* l_i, int b, int h,
                                            const int* row_l, const int* row_g,
                                            int t) {
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const bool live = l > 0.f && row_g[r] < bd.q_hi;
    const float inv = live ? 1.f / l : 0.f;
    if (row_l[r] >= p.Tq) continue;
    __nv_bfloat16* orow = ob + (((long long)b * p.Tq + row_l[r]) * p.H + h) * D + t * 2;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8) =
          pack_bf16(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    }
    if (t == 0)
      p.lse[((long long)b * p.H + h) * p.Tq + row_l[r]] =
          live ? m_i[r] + logf(l) : LSE_EMPTY;
  }
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
// (BK x D+1), one V tile (BK x D), P (BQ x BK+1).
template <int D>
constexpr size_t smem_f32() {
  return sizeof(float) * ((size_t)(BQ + BK) * (D + 1) + BK * D + BQ * (BK + 1));
}

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
