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
// FLOP per byte, so the tensor cores and not the memory bound it; so does
// (B 16, T 2048, H 3, D 256), the same work with half the heads.  D is 32,
// 64, 128 or 256.
//
// Design: bf16 runs flash_fwd_hopper<D, false> (flash_fwd_hopper.cuh): TMA
// loads by a producer warp into a ring of k/v stages, wgmma products in two
// consumer warpgroups of 64 query rows each that take turns at the tensor
// cores, so one's softmax overlaps the other's products.  fp32 inputs take a
// separate SIMT kernel (fp32 FMA, no tensor cores); it is slow, and is there
// because the JAX kernel accepts fp32.

#include "flash_fwd_hopper.cuh"

namespace {

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
  const Bounds bd = cta_bounds<BQ, BK>(p, b, q0);
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
  return launch_hopper<D, false>(p, stream);
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
