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

#include "flash_fwd_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
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

  uint32_t qa[KT][4];
  if (bd.t_lo < bd.t_hi) {
    load_tile_async<D, LD, BQ, NTHREADS>(sQ, qb, p.q_st, q0, p.Tq);
    load_tile_async<D, LD, BK, NTHREADS>(sK, kb, p.k_st, bd.t_lo * BK, p.Tk);
    load_tile_async<D, LD, BK, NTHREADS>(sV, vb, p.v_st, bd.t_lo * BK, p.Tk);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    load_q_frags<D, LD>(qa, sQ, warp, g, t);
  }

  for (int kt = bd.t_lo; kt < bd.t_hi; ++kt) {
    const int buf = (kt - bd.t_lo) & 1;
    if (kt + 1 < bd.t_hi) {  // prefetch the next tile into the other buffer
      load_tile_async<D, LD, BK, NTHREADS>(sK + (buf ^ 1) * BK * LD, kb, p.k_st,
                             (kt + 1) * BK, p.Tk);
      load_tile_async<D, LD, BK, NTHREADS>(sV + (buf ^ 1) * BK * LD, vb, p.v_st,
                             (kt + 1) * BK, p.Tk);
    }
    cp_async_commit();

    float s[NT][4];
    scores_bf16<D, LD>(s, qa, sK + buf * BK * LD, g, t);
    softmax_pv_bf16<D, LD>(s, acc, m_i, l_i, sV + buf * BK * LD, p, bd, kt,
                           row_g, t, lane);

    cp_async_wait_all();
    __syncthreads();
  }

  finish_bf16<D>(p, bd, acc, m_i, l_i, b, h, row_l, row_g, t);
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

  load_tile_f32<D, LDQ, BQ>(sQ, qb, p.q_st, q0, p.Tq);

  float m_i = -INFINITY, l_i = 0.f;
  float acc[HALF];
#pragma unroll
  for (int i = 0; i < HALF; ++i) acc[i] = 0.f;

  for (int kt = bd.t_lo; kt < bd.t_hi; ++kt) {
    __syncthreads();  // previous tile fully consumed (and sQ written)
    load_tile_f32<D, LDQ, BK>(sK, kb, p.k_st, kt * BK, p.Tk);
    load_tile_f32<D, D, BK>(sV, vb, p.v_st, kt * BK, p.Tk);
    __syncthreads();

    float s[BK / 2];
    scores_f32<D>(s, sQ, sK, p, bd, kt, r, hf, row_g);
    softmax_pv_f32<D>(s, acc, m_i, l_i, sP, sV, r, hf);
  }

  finish_f32<D>(p, bd, acc, m_i, l_i, b, h, row_l, row_g, hf);
}

template <int D>
cudaError_t dispatch_dtype(const Params& p, int is_f32, cudaStream_t stream) {
  if (is_f32) return launch(flash_fwd_f32<D>, p, smem_f32<D>(), stream);
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
  const Params p = make_params(q, k, v, o, lse, lengths, B, H, Tq, Tk, q_sb,
                               q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
                               q_off, kv_off, left, right);
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
