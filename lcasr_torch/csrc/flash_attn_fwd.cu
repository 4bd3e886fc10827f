// Flash-attention forward for Hopper (sm_90a), with a plain C interface that
// lcasr_torch/kernels.py loads through ctypes.
//
// Replaces: lcasr_tpu/ops/flash_attention.py `_fwd_kernel` (driven by `_fwd`,
// the pl.pallas_call at :451).  Same function: exact non-causal softmax
// attention with an fp32 online softmax over q (already multiplied by the
// softmax scale in q's dtype by the caller), per-batch kv `lengths`, an
// optional (left, right) band in global coordinates, q/kv offsets for
// context parallelism, and the per-row log-sum-exp.  Query rows at or past
// min(len, q_off + Tq) and rows with no valid key give o = 0 and
// lse = -1e30.
//
// Bound on the H100: at the decode shape (B 16, T 2048, H 6, D 128, bf16)
// one launch does 4*B*H*T^2*D = 206 GFLOP on 50 MB of q/k/v/o, about 4,000
// FLOP per byte, so the tensor cores and not the memory bound it.
//
// Design (a first, simple kernel; a wgmma/TMA warp-specialised version is
// later work):
//   * one CTA of 4 warps per (64-query tile, head, batch); each warp owns 16
//     query rows; the CTA walks 64-key k/v tiles, skipping tiles past the
//     valid length and outside the band (the Pallas `_block_in_band`);
//   * k/v tiles are double-buffered in shared memory with cp.async (16-byte
//     copies, zero-filled past the ragged T edge, so nothing is padded in
//     device memory); q, k and v are read through their (B, T, H, D)
//     strides, so the non-contiguous views from the fused qkv projection
//     need no copy;
//   * S = Q K^T and O += P V run on the tensor cores as bf16 mma.sync
//     m16n8k16 with fp32 accumulation; S stays in registers and is reused
//     as the A operand of P V (P cast to bf16 first, as the Pallas kernel
//     casts p to v's dtype); V's B operand comes from ldmatrix .trans;
//   * running max, sum and the output accumulator are fp32 in registers.
// fp32 inputs take a separate SIMT kernel (fp32 FMA, no tensor cores). It
// is slow, and is there because the JAX kernel accepts fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // query rows per CTA
constexpr int BK = 64;  // keys per k/v tile
constexpr int NTHREADS = 128;
static_assert(BQ == BK, "load_tile_async stages BK rows for q tiles too");
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

__device__ __forceinline__ int floordiv(int a, int b) {  // b > 0
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// The CTA's bounds: valid global rows < q_hi, valid global cols < kv_hi, and
// the half-open range [t_lo, t_hi) of local k/v tiles it must visit.
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
// bf16: tensor cores
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo, low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy `rows` x D bf16 of one (b, h) slice, starting at local row r0, into a
// shared tile with row stride LD; rows at or past `limit` are zero-filled.
template <int D, int LD>
__device__ __forceinline__ void load_tile_async(
    __nv_bfloat16* dst, const __nv_bfloat16* base, long long st, int r0,
    int limit) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < BK * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < limit;
    const __nv_bfloat16* src = ok ? base + (long long)(r0 + r) * st + c * 8 : base;
    cp_async16(dst + r * LD + c * 8, src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_bf16(const Params p) {
  constexpr int LD = D + 8;  // padded row: conflict-free fragment loads
  constexpr int KT = D / 16;  // k-steps of Q K^T
  constexpr int NT = BK / 8;  // n-tiles of S per warp
  constexpr int DT = D / 8;   // n-tiles of O per warp

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * LD;      // 2 buffers
  __nv_bfloat16* sV = sK + 2 * BK * LD;  // 2 buffers

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const Bounds bd = cta_bounds(p, b, q0);

  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) +
                            b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) +
                            b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) +
                            b * p.v_sb + h * p.v_sh;

  // rows this thread owns in the C fragments: g and g + 8 of its warp
  const int row_l[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const int row_g[2] = {p.q_off + row_l[0], p.q_off + row_l[1]};

  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};  // this thread's partial row sums
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (bd.t_lo < bd.t_hi) {
    load_tile_async<D, LD>(sQ, qb, p.q_st, q0, p.Tq);
    load_tile_async<D, LD>(sK, kb, p.k_st, bd.t_lo * BK, p.Tk);
    load_tile_async<D, LD>(sV, vb, p.v_st, bd.t_lo * BK, p.Tk);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  }

  uint32_t qa[KT][4];
  if (bd.t_lo < bd.t_hi) {
    const __nv_bfloat16* q_lo = sQ + (warp * 16 + g) * LD + t * 2;
    const __nv_bfloat16* q_hi = q_lo + 8 * LD;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(q_lo + kk * 16);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(q_hi + kk * 16);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(q_lo + kk * 16 + 8);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(q_hi + kk * 16 + 8);
    }
  }

  const bool banded = p.left >= 0 || p.right >= 0;
  for (int kt = bd.t_lo; kt < bd.t_hi; ++kt) {
    const int buf = (kt - bd.t_lo) & 1;
    if (kt + 1 < bd.t_hi) {  // prefetch the next tile into the other buffer
      load_tile_async<D, LD>(sK + (buf ^ 1) * BK * LD, kb, p.k_st,
                             (kt + 1) * BK, p.Tk);
      load_tile_async<D, LD>(sV + (buf ^ 1) * BK * LD, vb, p.v_st,
                             (kt + 1) * BK, p.Tk);
    }
    cp_async_commit();
    const __nv_bfloat16* tK = sK + buf * BK * LD;
    const __nv_bfloat16* tV = sV + buf * BK * LD;

    // S = Q K^T (16 x 64 per warp)
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = tK + (nt * 8 + g) * LD + t * 2;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_bf16(s[nt], qa[kk], b0, b1);
      }
    }

    // masks: only tiles that cross the length edge or meet a band
    const int c0 = kt * BK;  // local col of the tile's first key
    if (banded || p.kv_off + c0 + BK > bd.kv_hi) {
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

    // O += P V, P taken from the S registers as bf16 A fragments
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

    cp_async_wait_all();
    __syncthreads();
  }

  // finish: full row sums across the quad, normalise, write o and lse
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
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8) =
          pack_bf16(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    }
    if (t == 0)
      p.lse[((long long)b * p.H + h) * p.Tq + row_l[r]] =
          live ? m_i[r] + logf(l) : LSE_EMPTY;
  }
}

// ---------------------------------------------------------------------------
// fp32: SIMT FMA (slow; kept for the fp32 inputs the JAX kernel accepts)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_f32(const Params p) {
  constexpr int LDQ = D + 1;  // odd stride: rows fall in distinct banks
  constexpr int HALF = D / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // BQ x LDQ
  float* sK = sQ + BQ * LDQ;                       // BK x LDQ
  float* sV = sK + BK * LDQ;                       // BK x D
  float* sP = sV + BK * D;                         // BQ x (BK + 1)

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int r = threadIdx.x / 2, hf = threadIdx.x % 2;  // row, half
  const Bounds bd = cta_bounds(p, b, q0);
  const int row_l = q0 + r, row_g = p.q_off + row_l;

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS) {
    const int rr = i / D, d = i % D;
    sQ[rr * LDQ + d] = q0 + rr < p.Tq ? qb[(long long)(q0 + rr) * p.q_st + d] : 0.f;
  }

  float m_i = -INFINITY, l_i = 0.f;
  float acc[HALF];
#pragma unroll
  for (int i = 0; i < HALF; ++i) acc[i] = 0.f;

  for (int kt = bd.t_lo; kt < bd.t_hi; ++kt) {
    const int c0 = kt * BK;
    __syncthreads();  // previous tile fully consumed (and sQ written)
    for (int i = threadIdx.x; i < BK * D; i += NTHREADS) {
      const int rr = i / D, d = i % D;
      const bool ok = c0 + rr < p.Tk;
      sK[rr * LDQ + d] = ok ? kb[(long long)(c0 + rr) * p.k_st + d] : 0.f;
      sV[rr * D + d] = ok ? vb[(long long)(c0 + rr) * p.v_st + d] : 0.f;
    }
    __syncthreads();

    float s[BK / 2];
    float mx = m_i;
#pragma unroll 4
    for (int j = 0; j < BK / 2; ++j) {
      const int c = hf * (BK / 2) + j;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(sQ[r * LDQ + d], sK[c * LDQ + d], dot);
      if (!col_valid(p, bd, row_g, p.kv_off + c0 + c)) dot = -INFINITY;
      s[j] = dot;
      mx = fmaxf(mx, dot);
    }
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
    __syncwarp();  // both halves of a row live in one warp
#pragma unroll
    for (int i = 0; i < HALF; ++i) acc[i] *= corr;
    for (int c = 0; c < BK; ++c) {
      const float pc = sP[r * (BK + 1) + c];
      const float* vrow = sV + c * D + hf * HALF;
#pragma unroll
      for (int i = 0; i < HALF; ++i) acc[i] = fmaf(pc, vrow[i], acc[i]);
    }
  }

  float l = l_i + __shfl_xor_sync(0xffffffffu, l_i, 1);
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

template <int D>
cudaError_t dispatch_dtype(const Params& p, int is_f32, cudaStream_t stream) {
  if (is_f32) {
    const size_t smem =
        sizeof(float) * ((size_t)(BQ + BK) * (D + 1) + BK * D + BQ * (BK + 1));
    return launch(flash_fwd_f32<D>, p, smem, stream);
  }
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)(BQ + 4 * BK) * (D + 8);
  return launch(flash_fwd_bf16<D>, p, smem, stream);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success): the launch's own error, from
// cudaGetLastError() right after it.
int lcasr_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, const void* lengths, int B, int H, int Tq,
                         int Tk, int D, int is_f32, long long q_sb,
                         long long q_st, long long q_sh, long long k_sb,
                         long long k_st, long long k_sh, long long v_sb,
                         long long v_st, long long v_sh, int q_off, int kv_off,
                         int left, int right, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return dispatch_dtype<32>(p, is_f32, s);
    case 64:
      return dispatch_dtype<64>(p, is_f32, s);
    case 128:
      return dispatch_dtype<128>(p, is_f32, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* lcasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
