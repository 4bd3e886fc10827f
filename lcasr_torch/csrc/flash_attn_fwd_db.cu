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
// What the Pallas body is for is kept, not its schedule: two kv tiles in
// flight, so the exp/max/sum chain of the softmax has tensor-core work to
// overlap with.  On the TPU that needed an extra grid step and a round trip
// of the raw scores through scratch memory.  Here bf16 runs
// flash_fwd_hopper<D, true> (flash_fwd_hopper.cuh): each consumer warpgroup
// issues the asynchronous wgmma of S(i + 1) = Q K(i + 1)^T together with
// O += P(i) V(i), and runs the softmax of S(i + 1) while O's product is in
// flight (two score tiles' worth of registers: S(i + 1) in fp32, P(i) in
// bf16).  A tile outside `cta_bounds`' range is neither started nor
// processed.  Bound on the H100: as flash_attn_fwd.cu, by operations (about
// 4,000 FLOP per byte at the decode shape).  fp32 inputs take a SIMT kernel
// with the same order of steps (scores of tile i + 1 before the softmax of
// tile i).

#include "flash_fwd_hopper.cuh"

namespace {

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
  const Bounds bd = cta_bounds<BQ, BK>(p, b, q0);
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
  return launch_hopper<D, true>(p, stream);
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
    case 256:
      return dispatch_dtype<256>(p, is_f32, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* lcasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
