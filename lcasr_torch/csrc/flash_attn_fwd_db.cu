// Double-buffered flash-attention forward for Hopper (sm_90a), with a plain C
// interface that lcasr_torch/kernels.py loads through ctypes.
//
// Replaces: lcasr_tpu/ops/flash_attention.py `_fwd_kernel_db` (driven by
// `_fwd` under LCASR_ATTN_FWD_DB=1 when the attention is not banded on both
// sides, the pl.pallas_call at :451).  It computes what `_fwd_kernel` computes
// on that route: exact non-causal softmax attention with an fp32 online
// softmax over pre-scaled q, per-batch kv `lengths`, an absent or one-sided
// band in global coordinates, q/kv offsets, and the per-row log-sum-exp.
// Rows with no valid key give o = 0 and lse = -1e30.  Its plain version is
// `flash_attention_ref`, the same one that stands beside flash_attn_fwd.cu.
//
// What the Pallas body is for is kept, not its schedule: tile i + 1's
// Q K^T is sent to the tensor cores before tile i's softmax and P V run,
// so the exp/max/sum chain on the CUDA cores has independent mma work to
// overlap with.  On the TPU that needed an extra grid step and a round trip
// of the raw scores through scratch memory; here it is a software pipeline
// inside the CTA's loop over k/v tiles:
//   * two score tiles per warp live in registers (s_cur, s_next; 2 x 32
//     fp32 per thread): s_next = Q K(i+1)^T is started first, then the
//     masks, the softmax and O += P V of s_cur = tile i; the last iteration
//     starts nothing and drains the pipeline;
//   * K runs two tiles ahead of the softmax and V one: while tile i is
//     processed, K(i+1) is read, K(i+2) and V(i+1) arrive by cp.async into
//     the other buffer of each pair; one __syncthreads per tile;
//   * the tiles a CTA visits are the contiguous range [t_lo, t_hi) of
//     `cta_bounds`: a tile outside it is wholly masked and is neither started
//     nor processed (fed to the online softmax it would contribute exp(0) at
//     a masked maximum in a formulation with finite masks), so "started at
//     i - 1" and "processed at i" hold for the same tiles.
// Bound on the H100: as flash_attn_fwd.cu, by operations (about 4,000 FLOP
// per byte at the decode shape).  fp32 inputs take a SIMT kernel with the
// same order of steps (scores of tile i + 1 before the softmax of tile i).

#include "flash_fwd_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_db_bf16(const Params p) {
  constexpr int LD = D + 8;
  constexpr int KT = D / 16;
  constexpr int NT = BK / 8;
  constexpr int DT = D / 8;

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

  const int row_l[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const int row_g[2] = {p.q_off + row_l[0], p.q_off + row_l[1]};

  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  uint32_t qa[KT][4];
  float s_cur[NT][4], s_next[NT][4];
  if (bd.t_lo < bd.t_hi) {
    // group 0: Q, K(t_lo), V(t_lo); group 1: K(t_lo + 1) (maybe empty)
    load_tile_async<D, LD, BQ, NTHREADS>(sQ, qb, p.q_st, q0, p.Tq);
    load_tile_async<D, LD, BK, NTHREADS>(sK, kb, p.k_st, bd.t_lo * BK, p.Tk);
    load_tile_async<D, LD, BK, NTHREADS>(sV, vb, p.v_st, bd.t_lo * BK, p.Tk);
    cp_async_commit();
    if (bd.t_lo + 1 < bd.t_hi)
      load_tile_async<D, LD, BK, NTHREADS>(sK + BK * LD, kb, p.k_st,
                                           (bd.t_lo + 1) * BK, p.Tk);
    cp_async_commit();
    cp_async_wait_group<1>();
    __syncthreads();
    load_q_frags<D, LD>(qa, sQ, warp, g, t);
    scores_bf16<D, LD>(s_cur, qa, sK, g, t);  // the first tile in flight
  }

  for (int kt = bd.t_lo; kt < bd.t_hi; ++kt) {
    const int buf = (kt - bd.t_lo) & 1;
    // K(kt + 1) and V(kt) have landed; every warp is done with K(kt) (its
    // scores were started an iteration ago) and with V(kt - 1)
    cp_async_wait_all();
    __syncthreads();
    if (kt + 2 < bd.t_hi)
      load_tile_async<D, LD, BK, NTHREADS>(sK + buf * BK * LD, kb, p.k_st,
                                           (kt + 2) * BK, p.Tk);
    if (kt + 1 < bd.t_hi)
      load_tile_async<D, LD, BK, NTHREADS>(sV + (buf ^ 1) * BK * LD, vb, p.v_st,
                                           (kt + 1) * BK, p.Tk);
    cp_async_commit();

    // start tile kt + 1 (nothing on the last, draining, iteration) ...
    if (kt + 1 < bd.t_hi)
      scores_bf16<D, LD>(s_next, qa, sK + (buf ^ 1) * BK * LD, g, t);
    // ... then process tile kt: independent of s_next, free to overlap
    softmax_pv_bf16<D, LD>(s_cur, acc, m_i, l_i, sV + buf * BK * LD, p, bd, kt,
                           row_g, t, lane);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s_cur[nt][i] = s_next[nt][i];
  }

  finish_bf16<D>(p, bd, acc, m_i, l_i, b, h, row_l, row_g, t);
}

// ---------------------------------------------------------------------------
// fp32: SIMT FMA, the same order of steps
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_db_f32(const Params p) {
  constexpr int LDQ = D + 1;
  constexpr int HALF = D / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // BQ x LDQ
  float* sK = sQ + BQ * LDQ;                       // BK x LDQ: K(kt + 1)
  float* sV = sK + BK * LDQ;                       // BK x D:   V(kt)
  float* sP = sV + BK * D;                         // BQ x (BK + 1)

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int r = threadIdx.x / 2, hf = threadIdx.x % 2;
  const Bounds bd = cta_bounds(p, b, q0);
  const int row_l = q0 + r, row_g = p.q_off + row_l;

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  float m_i = -INFINITY, l_i = 0.f;
  float acc[HALF];
#pragma unroll
  for (int i = 0; i < HALF; ++i) acc[i] = 0.f;

  float s_cur[BK / 2], s_next[BK / 2];
  if (bd.t_lo < bd.t_hi) {
    load_tile_f32<D, LDQ, BQ>(sQ, qb, p.q_st, q0, p.Tq);
    load_tile_f32<D, LDQ, BK>(sK, kb, p.k_st, bd.t_lo * BK, p.Tk);
    __syncthreads();
    scores_f32<D>(s_cur, sQ, sK, p, bd, bd.t_lo, r, hf, row_g);
  }

  for (int kt = bd.t_lo; kt < bd.t_hi; ++kt) {
    __syncthreads();  // K(kt) scored and V(kt - 1) consumed by every warp
    if (kt + 1 < bd.t_hi)
      load_tile_f32<D, LDQ, BK>(sK, kb, p.k_st, (kt + 1) * BK, p.Tk);
    load_tile_f32<D, D, BK>(sV, vb, p.v_st, kt * BK, p.Tk);
    __syncthreads();

    if (kt + 1 < bd.t_hi)
      scores_f32<D>(s_next, sQ, sK, p, bd, kt + 1, r, hf, row_g);
    softmax_pv_f32<D>(s_cur, acc, m_i, l_i, sP, sV, r, hf);
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) s_cur[j] = s_next[j];
  }

  finish_f32<D>(p, bd, acc, m_i, l_i, b, h, row_l, row_g, hf);
}

template <int D>
cudaError_t dispatch_dtype(const Params& p, int is_f32, cudaStream_t stream) {
  if (is_f32) return launch(flash_fwd_db_f32<D>, p, smem_f32<D>(), stream);
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)(BQ + 4 * BK) * (D + 8);
  return launch(flash_fwd_db_bf16<D>, p, smem, stream);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  A band on both sides is not this
// kernel's route (the caller sends it to lcasr_flash_attn_fwd).
int lcasr_flash_attn_fwd_db(const void* q, const void* k, const void* v,
                            void* o, void* lse, const void* lengths, int B,
                            int H, int Tq, int Tk, int D, int is_f32,
                            long long q_sb, long long q_st, long long q_sh,
                            long long k_sb, long long k_st, long long k_sh,
                            long long v_sb, long long v_st, long long v_sh,
                            int q_off, int kv_off, int left, int right,
                            void* stream) {
  if (left >= 0 && right >= 0) return (int)cudaErrorInvalidValue;
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
