// The bf16 flash-attention forward for Hopper that K1 (flash_attn_fwd.cu,
// OVERLAP false) and K2 (flash_attn_fwd_db.cu, OVERLAP true) instantiate:
// TMA loads, wgmma products and warp specialisation.
//
// One CTA of three warpgroups per (128 query rows, head, batch):
//   * warpgroup 0, the producer, gives up registers (setmaxnreg 40); one of
//     its threads loads the CTA's Q tile once and keeps a ring of HSTAGES
//     (two) K and V tiles of BK keys (128; 64 at D = 256) in flight by TMA,
//     each stage with a full and an empty mbarrier, separate for K and V.
//     The tensor maps read q, k and v through their (B, T, H, D) strides
//     and zero-fill rows past T;
//   * warpgroups 1 and 2, the consumers (setmaxnreg 232), own 64 query rows
//     each.  S = Q K^T is one wgmma m64n128k16 (m64n64k16 at D = 256) per
//     16 columns of D, both operands from swizzled shared memory; the fp32
//     online softmax runs on S in registers (exp2 on scores scaled by
//     log2 e); P is rounded to bf16 in registers and is the A operand of
//     O += P V (wgmma m64nDk16, V read as an MN-major B operand straight
//     from its TMA tile);
//   * the two consumers take turns at the tensor cores (named barriers 1
//     and 2): one issues its products while the other runs its softmax.
// K2 also keeps two kv tiles in flight inside each consumer, which is what
// the Pallas `_fwd_kernel_db` is for: it issues S(i + 1) = Q K(i + 1)^T and
// O += P(i) V(i) together and runs the softmax of S(i + 1) while O's product
// is in flight; O's rescale by the new maximum waits for the next round.
//
// Shared memory at D = 128: Q 32 KB, two stages of K and V 32 KB each, 160 KB
// in all: one CTA per SM.  D = 64 uses the same 128-byte rows (one column
// block); D = 32 has 64-byte rows and the 64-byte swizzle.  D = 256 (four
// column blocks) takes 64-key tiles: Q 64 KB and two stages of K and V 32 KB
// each, 192 KB, where 128-key tiles would need 320 KB; its consumers hold O
// in 128 registers a thread, S in 32 and P in 16, within the 232 of
// setmaxnreg, and O += P V is one wgmma m64n256k16 per 16 keys.  The masks
// of the lengths and the band are applied only on tiles that cross an edge,
// and tiles outside `cta_bounds` are never loaded.
#pragma once

#include "flash_fwd_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int HBQ = 128;  // query rows per CTA: 64 per consumer warpgroup
constexpr int HSTAGES = 2;  // a third stage fits at D = 128 and measured no faster
constexpr int HTHREADS = 384;  // the producer and two consumer warpgroups
constexpr int CONSUMER_THREADS = 256;
constexpr int CONSUMER_WARPS = 8;
// registers a thread: 128 x 40 + 256 x 232 = 64,512 of the SM's 65,536
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

template <int D>
struct HopperTile {
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
  // keys per k/v tile: 128, or 64 at D = 256 for shared memory
  static constexpr int BK = hopper::keys_per_tile<D>();
  static constexpr int Q_ELEMS = HBQ * D;
  static constexpr int KV_ELEMS = BK * D;
  static constexpr uint32_t Q_BYTES = Q_ELEMS * 2;
  static constexpr uint32_t KV_BYTES = KV_ELEMS * 2;
  // 1024 bytes of slack to align the tiles to the swizzle atom
  static constexpr size_t SMEM =
      1024 + Q_BYTES + 2 * HSTAGES * (size_t)KV_BYTES + 8 * (1 + 4 * HSTAGES);
};

// Issue S = Q K^T for this warpgroup's 64 rows (not waited for).
template <int D>
__device__ __forceinline__ void issue_scores(float* s,
                                             const __nv_bfloat16* sQw,
                                             const __nv_bfloat16* sK) {
  using TL = HopperTile<D>;
  hopper::fence_all<TL::BK / 2>(s);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int blk = kk * 16 / TL::COLS, col = kk * 16 % TL::COLS;
    const uint64_t dq = hopper::smem_desc(sQw + blk * HBQ * TL::COLS + col, 16,
                                          TL::SBO, TL::LAYOUT);
    const uint64_t dk = hopper::smem_desc(sK + blk * TL::BK * TL::COLS + col,
                                          16, TL::SBO, TL::LAYOUT);
    if constexpr (TL::BK == 128)
      hopper::wgmma_m64n128k16_ss(s, dq, dk, kk > 0);
    else
      hopper::wgmma_m64n64k16_ss<0, 0>(s, dq, dk, kk > 0);
  }
  hopper::wgmma_commit();
  hopper::fence_all<TL::BK / 2>(s);
}

// Issue O += P V (not waited for).
template <int D>
__device__ __forceinline__ void issue_pv(float* o, uint32_t (*pa)[4],
                                         const __nv_bfloat16* sV) {
  using TL = HopperTile<D>;
  hopper::fence_all<D / 2>(o);
  hopper::fence_frags<TL::BK / 16>(pa);
  hopper::wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < TL::BK / 16; ++kc) {
    // keys 16 kc .. 16 kc + 15 are rows of every column block; the leading
    // byte offset steps from one block of COLS columns of V to the next
    const uint64_t dv = hopper::smem_desc(sV + kc * 16 * TL::COLS,
                                          TL::BK * TL::ROW_BYTES, TL::SBO,
                                          TL::LAYOUT);
    hopper::wgmma_rs_tb<D>(o, pa[kc], dv);
  }
  hopper::wgmma_commit();
  hopper::fence_all<D / 2>(o);
}

// Tile kt's masks and online softmax on this thread's two rows of S (in
// place: S becomes exp(S - m)), with the factor by which O must be scaled
// to the new maximum.  BK: keys per tile.
template <int BK>
__device__ __forceinline__ void softmax_tile(float* s, float* m_i, float* l_i,
                                             float* scale, const Params& p,
                                             const Bounds& bd, int kt,
                                             const int* row_g, int t) {
  const int c0 = kt * BK;  // local col of the tile's first key
  if (p.left >= 0 || p.right >= 0 || p.kv_off + c0 + BK > bd.kv_hi) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col_g = p.kv_off + c0 + 8 * j + 2 * t + (e & 1);
        if (!col_valid(p, bd, row_g[e >> 1], col_g)) s[4 * j + e] = -INFINITY;
      }
  }
  float m_new[2] = {m_i[0], m_i[1]};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      m_new[e >> 1] = fmaxf(m_new[e >> 1], s[4 * j + e]);
  float m_scaled[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // each row is spread over a quad
    m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
    m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
    const float m_use = m_new[r] == -INFINITY ? 0.f : m_new[r];
    scale[r] = hopper::ex2((m_i[r] - m_use) * LOG2E);  // 0 while m_i is -inf
    m_i[r] = m_new[r];
    l_i[r] *= scale[r];
    m_scaled[r] = m_use * LOG2E;
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = hopper::ex2(fmaf(s[4 * j + e], LOG2E, -m_scaled[e >> 1]));
      s[4 * j + e] = x;
      l_i[e >> 1] += x;
    }
}

template <int D>
__device__ __forceinline__ void rescale_o(float* o, const float* scale) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * j + e] *= scale[e >> 1];
}

// One lane per consumer warp frees a stage once its products have completed.
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  if (lane == 0) hopper::mbar_arrive(bar);
}

// The consumers' turns at the tensor cores: consumer c waits on barrier
// 1 + c, then lets the other go.  Consumer 1 opens consumer 0's first turn
// and skips its own last hand-over, so every barrier completes exactly once
// per turn and none is left half-arrived when the CTA exits.
__device__ __forceinline__ void turn_begin(int cw) {
  hopper::named_sync(1 + cw, CONSUMER_THREADS);
}
__device__ __forceinline__ void turn_end(int cw, bool last) {
  if (!(cw == 1 && last)) hopper::named_arrive(2 - cw, CONSUMER_THREADS);
}

template <int D, bool OVERLAP>
__global__ void __launch_bounds__(HTHREADS, 1)
    flash_fwd_hopper(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const Params p) {
  using TL = HopperTile<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = hopper::smem_u32(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (base & 1023)) & 1023);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + TL::Q_ELEMS;              // HSTAGES tiles
  __nv_bfloat16* sV = sK + HSTAGES * TL::KV_ELEMS;   // HSTAGES tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + HSTAGES * TL::KV_ELEMS);
  uint64_t* full_k = q_full + 1;
  uint64_t* empty_k = full_k + HSTAGES;
  uint64_t* full_v = empty_k + HSTAGES;
  uint64_t* empty_v = full_v + HSTAGES;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < HSTAGES; ++s) {
      hopper::mbar_init(&full_k[s], 1);
      hopper::mbar_init(&full_v[s], 1);
      hopper::mbar_init(&empty_k[s], CONSUMER_WARPS);
      hopper::mbar_init(&empty_v[s], CONSUMER_WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup's index, read from lane 0 so that the compiler sees it is
  // the same across the warp: each role is then a region of its own, and
  // setmaxnreg sets the registers that region's code may use
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  // each role computes the CTA's bounds after its setmaxnreg: nothing is
  // live across the change of register budget
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * HBQ;
  if (wg == 0) {
    // ---- producer ----
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    const Bounds bd = cta_bounds<HBQ, TL::BK>(p, b, q0);
    const int n_tiles = max(bd.t_hi - bd.t_lo, 0);
    if (threadIdx.x == 0 && n_tiles > 0) {
      hopper::mbar_arrive_expect_tx(q_full, TL::Q_BYTES);
#pragma unroll
      for (int c = 0; c < TL::BLOCKS; ++c)
        hopper::tma_load_4d(sQ + c * HBQ * TL::COLS, &tq, q_full, c * TL::COLS,
                            h, q0, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % HSTAGES;
        const uint32_t ph = (n / HSTAGES) & 1;
        const int row = (bd.t_lo + n) * TL::BK;
        __nv_bfloat16* dk = sK + s * TL::KV_ELEMS;
        __nv_bfloat16* dv = sV + s * TL::KV_ELEMS;
        hopper::mbar_wait(&empty_k[s], ph ^ 1);
        hopper::mbar_arrive_expect_tx(&full_k[s], TL::KV_BYTES);
#pragma unroll
        for (int c = 0; c < TL::BLOCKS; ++c)
          hopper::tma_load_4d(dk + c * TL::BK * TL::COLS, &tk, &full_k[s],
                              c * TL::COLS, h, row, b);
        hopper::mbar_wait(&empty_v[s], ph ^ 1);
        hopper::mbar_arrive_expect_tx(&full_v[s], TL::KV_BYTES);
#pragma unroll
        for (int c = 0; c < TL::BLOCKS; ++c)
          hopper::tma_load_4d(dv + c * TL::BK * TL::COLS, &tv, &full_v[s],
                              c * TL::COLS, h, row, b);
      }
    }
  } else {
    // ---- consumers ----
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const Bounds bd = cta_bounds<HBQ, TL::BK>(p, b, q0);
    const int n_tiles = max(bd.t_hi - bd.t_lo, 0);
    const int cw = wg - 1;  // consumer 0 or 1
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row_l[2] = {q0 + cw * 64 + warp * 16 + g,
                          q0 + cw * 64 + warp * 16 + g + 8};
    const int row_g[2] = {p.q_off + row_l[0], p.q_off + row_l[1]};
    const __nv_bfloat16* sQw = sQ + cw * 64 * TL::COLS;  // this consumer's rows

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float s[TL::BK / 2];
    uint32_t pa[TL::BK / 16][4];
    float m_i[2] = {-INFINITY, -INFINITY};
    float l_i[2] = {0.f, 0.f};  // this thread's partial row sums
    float scale[2];

    if (n_tiles > 0) {
      hopper::mbar_wait(q_full, 0);
      if (cw == 1) hopper::named_arrive(1, CONSUMER_THREADS);  // consumer 0 first
      if (!OVERLAP) {
        for (int n = 0; n < n_tiles; ++n) {
          const int st = n % HSTAGES;
          const uint32_t ph = (n / HSTAGES) & 1;
          hopper::mbar_wait(&full_k[st], ph);
          turn_begin(cw);
          issue_scores<D>(s, sQw, sK + st * TL::KV_ELEMS);
          turn_end(cw, n == n_tiles - 1);
          hopper::wgmma_wait<0>();
          hopper::fence_all<TL::BK / 2>(s);
          release(&empty_k[st], lane);
          softmax_tile<TL::BK>(s, m_i, l_i, scale, p, bd, bd.t_lo + n, row_g, t);
          rescale_o<D>(o, scale);
          hopper::pack_frags<TL::BK / 16>(pa, s);
          hopper::mbar_wait(&full_v[st], ph);
          issue_pv<D>(o, pa, sV + st * TL::KV_ELEMS);
          hopper::wgmma_wait<0>();
          hopper::fence_all<D / 2>(o);
          release(&empty_v[st], lane);
        }
      } else {
        // the first tile: scores and softmax only
        hopper::mbar_wait(&full_k[0], 0);
        turn_begin(cw);
        issue_scores<D>(s, sQw, sK);
        turn_end(cw, n_tiles == 1);
        hopper::wgmma_wait<0>();
        hopper::fence_all<TL::BK / 2>(s);
        release(&empty_k[0], lane);
        softmax_tile<TL::BK>(s, m_i, l_i, scale, p, bd, bd.t_lo, row_g, t);
        hopper::pack_frags<TL::BK / 16>(pa, s);
        // tile n's scores in flight with tile n - 1's P V
        for (int n = 1; n < n_tiles; ++n) {
          const int st = n % HSTAGES, sp = (n - 1) % HSTAGES;
          const uint32_t ph = (n / HSTAGES) & 1, php = ((n - 1) / HSTAGES) & 1;
          hopper::mbar_wait(&full_k[st], ph);
          hopper::mbar_wait(&full_v[sp], php);
          turn_begin(cw);
          issue_scores<D>(s, sQw, sK + st * TL::KV_ELEMS);
          rescale_o<D>(o, scale);  // to the maximum P(n - 1) was taken at
          issue_pv<D>(o, pa, sV + sp * TL::KV_ELEMS);
          turn_end(cw, n == n_tiles - 1);
          hopper::wgmma_wait<1>();  // the scores have landed
          hopper::fence_all<TL::BK / 2>(s);
          release(&empty_k[st], lane);
          softmax_tile<TL::BK>(s, m_i, l_i, scale, p, bd, bd.t_lo + n, row_g, t);
          hopper::wgmma_wait<0>();  // P(n - 1) V(n - 1) has landed
          hopper::fence_all<D / 2>(o);
          hopper::fence_all<TL::BK / 2>(s);  // P(n) is packed only now: pa is free
          release(&empty_v[sp], lane);
          hopper::pack_frags<TL::BK / 16>(pa, s);
        }
        // the last tile's P V
        const int sl = (n_tiles - 1) % HSTAGES;
        rescale_o<D>(o, scale);
        hopper::mbar_wait(&full_v[sl], ((n_tiles - 1) / HSTAGES) & 1);
        issue_pv<D>(o, pa, sV + sl * TL::KV_ELEMS);
        hopper::wgmma_wait<0>();
        hopper::fence_all<D / 2>(o);
        release(&empty_v[sl], lane);
      }
    }

    // full row sums across the quad, normalise, write o and lse
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_i[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const bool live = l > 0.f && row_g[r] < bd.q_hi;
      const float inv = live ? 1.f / l : 0.f;
      if (row_l[r] >= p.Tq) continue;
      __nv_bfloat16* orow =
          ob + (((long long)b * p.Tq + row_l[r]) * p.H + h) * D + t * 2;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      if (t == 0)
        p.lse[((long long)b * p.H + h) * p.Tq + row_l[r]] =
            live ? m_i[r] + logf(l) : LSE_EMPTY;
    }
  }
}

// Tensor maps of q, k and v and the launch; errors of the maps' encoding
// and of the launch are returned, nothing is synchronised.
template <int D, bool OVERLAP>
cudaError_t launch_hopper(const Params& p, cudaStream_t stream) {
  using TL = HopperTile<D>;
  CUtensorMap mq, mk, mv;
  cudaError_t err = hopper::bthd_map(&mq, p.q, p.B, p.Tq, p.H, D, p.q_sb,
                                     p.q_st, p.q_sh, HBQ, TL::COLS,
                                     TL::TMA_SWIZZLE);
  if (err == cudaSuccess)
    err = hopper::bthd_map(&mk, p.k, p.B, p.Tk, p.H, D, p.k_sb, p.k_st, p.k_sh,
                           TL::BK, TL::COLS, TL::TMA_SWIZZLE);
  if (err == cudaSuccess)
    err = hopper::bthd_map(&mv, p.v, p.B, p.Tk, p.H, D, p.v_sb, p.v_st, p.v_sh,
                           TL::BK, TL::COLS, TL::TMA_SWIZZLE);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_hopper<D, OVERLAP>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)TL::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + HBQ - 1) / HBQ, p.H, p.B);
  kernel<<<grid, HTHREADS, TL::SMEM, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

}  // namespace
