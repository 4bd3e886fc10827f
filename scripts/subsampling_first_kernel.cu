// Fused 8x dw_striding subsampling for Hopper (sm_90a), with a plain C
// interface that lcasr_torch/kernels.py loads through ctypes.
//
// Replaces: lcasr_tpu/ops/subsampling_pallas.py `_fused_kernel` (driven by
// `_fused_impl`, the pl.pallas_call at :413; public `fused_dw_striding`).
// Same function: the whole non-causal chain in one launch,
//   x (B, T, F) -> full 3x3 stride-2 conv 1 -> C, act
//               -> depthwise 3x3 stride-2, pointwise 1x1 C -> C, act
//               -> depthwise 3x3 stride-2, pointwise 1x1 C -> C, act
//               -> (B, T/8, F/8, C), C minor,
// padding 1 on both sides of both axes at every stage, fp32 accumulation and
// fp32 activations, every intermediate rounded to the model dtype as the
// Pallas body rounds it, and no intermediate in device memory.  T % 8 == 0
// and F % 8 == 0 (so no stage ever reads its right zero padding in time or
// frequency), C in {128, 256}; x and every parameter in one dtype, bf16 or
// fp32.  Its plain version is `dw_striding_chain` (lcasr_torch/ops/subsampling.py).
//
// Bound on the H100: at the decode shape (16, 16384, 80) -> C 256 the two
// pointwise products are 215 of the chain's 246 GFLOP against 0.2 GB of input
// and output, so operations bound it, not bytes.
//
// Design.  One CTA of 16 warps computes `To` output
// frames of one batch row.  Output frame j needs stage-1 rows [2j-1, 2j+1],
// stage-0 rows [4j-3, 4j+3] and input frames [8j-7, 8j+7]: a tile reads
// 8 To + 7 input frames and recomputes its halo (4 To + 3 stage-0 rows,
// 2 To + 1 stage-1 rows).  Rows of a stage at globally negative indices are
// the next stage's left zero padding: they are written as zeros, not as
// act(bias); only the first tile has them.  In shared memory:
//   sX  the input tile in fp32, one zero column on the left;
//   sS  stage 0's output for a slice of channels, (4 To + 3, F/2 + 1, 64 or 32),
//       and later stage 1's output for all channels, (2 To + 1, F/4 + 1, C):
//       the full stage-0 tile (390 KB at C 256, F 80, To 4) does not fit, and
//       stage 0 and the first depthwise conv are per channel, so they run
//       slice by slice;
//   sH  the depthwise outputs, row-major (positions, C): the A operand of the
//       pointwise products, first (2 To + 1) F/4 rows, later To F/8 rows.
// In the bf16 kernel stage 0 is an im2col product on the tensor cores (the 9
// taps padded to K = 16, A fragments packed straight from the input tile);
// in the fp32 kernel it is 9 FMAs per output on the CUDA cores.  The Pallas
// body's dense-weight matmul for stage 0 ((F + 2) x 42 C weights, 27x the
// needed operations) exists only to avoid relayouts on the TPU and is not
// carried over.  The depthwise stages are 9 FMAs per output (bf16: a lane owns
// two neighbouring channels and reads them as one 4-byte word).  The pointwise
// products are the kernel's own: bf16 mma.sync m16n8k16 with fp32
// accumulation, each warp owning C/16 output channels whose weights it keeps
// in registers as B fragments for the whole product (loaded 16 bytes at a
// time, the A operand's columns permuted to match: `a_column`), A fragments by
// ldmatrix; for fp32 inputs a SIMT product on transposed weights.  To is the
// largest of 8, 4, 2, 1 whose tiles fit the SM's shared memory (4 at C 256 in
// bf16, 2 in fp32).  What is left for later: wgmma, TMA, persistent CTAs that
// keep the pointwise weights, and a tensor-core product for fp32 inputs.

#include <type_traits>

#include "flash_common.cuh"

namespace {

constexpr int NTHREADS = 512;
constexpr int NWARPS = NTHREADS / 32;
// Channels per slice of stage 0 and the first depthwise conv: 64 in the bf16
// kernel (a lane owns two neighbouring channels), 32 in the fp32 kernel.
__host__ __device__ constexpr int slice_channels(int elem) { return elem == 2 ? 64 : 32; }

enum Act { ACT_NONE = 0, ACT_SILU = 1, ACT_RELU = 2, ACT_GELU = 3 };

struct SubParams {
  const void* x;    // (B, T, F)
  void* out;        // (B, T/8, F/8, C)
  const void* k0;   // (C, 9): OIHW (C, 1, 3, 3)
  const void* b0;   // (C,)
  const void* kd[2];  // (C, 9) depthwise
  const void* bd[2];
  const void* kp[2];  // bf16: (C out, C in); fp32: transposed, (C in, C out)
  const void* bp[2];
  int B, Tin, F, To, act;
};

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

// The tile's shared-memory layout, computed alike on the host and the device.
struct Layout {
  int RX, LDX, R0, F0, R1, F1, F8, M1, M2, LDH;
  int LD0, LD1;  // channel strides of a position in stage 0's slice and in stage 1's output
  size_t off_h, off_s, total;  // bytes; sX starts at 0
};

__host__ __device__ inline Layout make_layout(int To, int F, int C, int elem) {
  Layout L;
  L.RX = 8 * To + 7;
  L.LDX = F + 4;  // F + 1 used; rows stay 16-byte aligned
  L.R0 = 4 * To + 3;
  L.F0 = F / 2;
  L.R1 = 2 * To + 1;
  L.F1 = F / 4;
  L.F8 = F / 8;
  L.M1 = L.R1 * L.F1;
  L.M2 = To * L.F8;
  L.LDH = C + 16 / elem;  // bf16: conflict-free ldmatrix rows
  const int rows_h = round_up(L.M1 > L.M2 ? L.M1 : L.M2, 16);
  // bf16: 16 bytes of padding per position, so that the tensor-core
  // epilogues' stores (8 positions x 4 channel pairs a warp) meet no bank
  // twice; the fp32 kernel's lanes write neighbouring channels and need none
  L.LD0 = slice_channels(elem) + (elem == 2 ? 8 : 0);
  L.LD1 = C + (elem == 2 ? 8 : 0);
  const size_t s0 = (size_t)L.R0 * (L.F0 + 1) * L.LD0;
  const size_t s1 = (size_t)L.R1 * (L.F1 + 1) * L.LD1;
  L.off_h = (size_t)round_up(L.RX * L.LDX * 4, 16);
  L.off_s = L.off_h + (size_t)round_up(rows_h * L.LDH * elem, 16);
  L.total = L.off_s + (s0 > s1 ? s0 : s1) * elem;
  return L;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// FAST (the bf16 kernel): silu by ex2.approx and rcp.approx, a relative error
// near 1e-6 over the whole range, which the rounding of the result to bf16
// (2e-3) hides; a precise expf and an IEEE division took a fifth of the first
// version's time.  (silu as h + h tanh.approx(h), h = v / 2, needs one
// special-function operation instead of two, but loses the negative tail: at
// v = -6 its error is 50 times the bf16 rounding.)  The fp32 kernel keeps the
// precise forms.
template <bool FAST>
__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case ACT_SILU:
      return FAST ? __fdividef(v, 1.f + __expf(-v)) : v / (1.f + expf(-v));
    case ACT_RELU:
      return fmaxf(v, 0.f);
    case ACT_GELU:  // exact, erf
      return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
    default:
      return v;
  }
}

// One value, or a pair of neighbouring bf16 channels in one 4-byte store.
__device__ __forceinline__ void put(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void put(__nv_bfloat16* dst, float v0, float v1) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
}

// Where the bf16 kernel keeps input channel l of a 32-channel block in a row
// of the A operand.  The contraction index of a product may be permuted as
// long as A and B agree; with this order the 8 weights a thread needs for two
// k-steps of mma.m16n8k16 (k-slots 2t, 2t + 1, 2t + 8, 2t + 9 of each) are the
// 8 consecutive input channels 8t .. 8t + 7: one 16-byte load from the
// weight's row instead of four 4-byte ones, and whole 32-byte sectors.
__device__ __forceinline__ int a_column(int l) {
  const int t = l >> 3, h = (l >> 2) & 1, u = (l >> 1) & 1, e = l & 1;
  return 16 * h + 8 * u + 2 * t + e;
}

// out(m, c) = act(bias[c] + sum_k A[m][k] W[c][k]) for m < M, through
// `store(m, c, value of c, value of c + 1)`.
// bf16: warp w owns channels [w C/16, (w + 1) C/16) and keeps their weights
// in registers as B fragments; A fragments come from shared memory by
// ldmatrix, its columns in the order of `a_column`.  W is (C out, C in) in
// device memory, 16-byte aligned.
template <int C, typename Store>
__device__ __forceinline__ void pointwise_mma(const __nv_bfloat16* sA, int LDH, int M,
                                              const __nv_bfloat16* W,
                                              const __nv_bfloat16* bias, int act, Store store) {
  constexpr int NTW = C / 128;  // n-tiles of 8 channels per warp
  constexpr int KT = C / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = warp * NTW * 8;

  uint32_t bfrag[KT][NTW][2];
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    const __nv_bfloat16* wrow = W + (size_t)(n0 + nt * 8 + g) * C + t * 8;
#pragma unroll
    for (int kb = 0; kb < KT / 2; ++kb) {  // 32 input channels: two k-steps
      const uint4 w = *reinterpret_cast<const uint4*>(wrow + kb * 32);
      bfrag[2 * kb][nt][0] = w.x;
      bfrag[2 * kb][nt][1] = w.y;
      bfrag[2 * kb + 1][nt][0] = w.z;
      bfrag[2 * kb + 1][nt][1] = w.w;
    }
  }
  float bias_lo[NTW], bias_hi[NTW];
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    bias_lo[nt] = __bfloat162float(bias[n0 + nt * 8 + t * 2]);
    bias_hi[nt] = __bfloat162float(bias[n0 + nt * 8 + t * 2 + 1]);
  }
  for (int mt = 0; mt * 16 < M; ++mt) {
    float acc[NTW][4];
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    const __nv_bfloat16* arow = sA + (mt * 16 + (lane & 15)) * LDH + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, arow + kk * 16);
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) mma_bf16(acc[nt], a, bfrag[kk][nt][0], bfrag[kk][nt][1]);
    }
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8, channels 2t and 2t + 1
        const int m = mt * 16 + g + 8 * h, c = n0 + nt * 8 + t * 2;
        if (m < M)
          store(m, c, activate<true>(acc[nt][2 * h] + bias_lo[nt], act),
                activate<true>(acc[nt][2 * h + 1] + bias_hi[nt], act));
      }
  }
}

// The same product for fp32 on the CUDA cores.  Wt is transposed, (C in,
// C out), so that a warp's threads (one output channel each) read it
// coalesced; a thread takes RB rows of A at a time, read as broadcast float4.
// Through `store(m, c, value)`.
template <int C, typename Store>
__device__ __forceinline__ void pointwise_simt(const float* sA, int LDH, int M,
                                               const float* Wt, const float* bias, int act,
                                               Store store) {
  constexpr int RB = 8;
  constexpr int NRG = NTHREADS / C;  // row groups
  const int n = threadIdx.x % C, rg = threadIdx.x / C;
  const float bias_n = bias[n];
  for (int m0 = rg * RB; m0 < M; m0 += NRG * RB) {
    float acc[RB];
    const float* arow[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      acc[r] = 0.f;
      arow[r] = sA + min(m0 + r, M - 1) * LDH;  // rows past M repeat the last; not stored
    }
    for (int k = 0; k < C; k += 4) {
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = Wt[(size_t)(k + i) * C + n];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(arow[r] + k);
        acc[r] = fmaf(a.x, w[0], acc[r]);
        acc[r] = fmaf(a.y, w[1], acc[r]);
        acc[r] = fmaf(a.z, w[2], acc[r]);
        acc[r] = fmaf(a.w, w[3], acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r)
      if (m0 + r < M) store(m0 + r, n, activate<false>(acc[r] + bias_n, act));
  }
}

template <typename T, int C, typename Store>
__device__ __forceinline__ void pointwise(const T* sA, int LDH, int M, const void* W,
                                          const void* bias, int act, Store store) {
  if constexpr (std::is_same<T, float>::value)
    pointwise_simt<C>(sA, LDH, M, static_cast<const float*>(W),
                      static_cast<const float*>(bias), act, store);
  else
    pointwise_mma<C>(sA, LDH, M, static_cast<const __nv_bfloat16*>(W),
                     static_cast<const __nv_bfloat16*>(bias), act, store);
}

// Stage 0 for one 32-channel slice on the CUDA cores (the fp32 kernel): a
// lane owns a channel and 4 neighbouring frequencies, so the 27 inputs it
// needs come as broadcast vector loads; 9 FMAs per output.
__device__ __forceinline__ void stage0_simt(const SubParams& p, const Layout& L,
                                            const float* sX, float* sS, int c0, int j0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;  // a slice is 32 channels
  const int c = c0 + lane, F0 = L.F0, LDX = L.LDX;
  float w[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) w[i] = static_cast<const float*>(p.k0)[c * 9 + i];
  const float bias = static_cast<const float*>(p.b0)[c];
  const int groups = F0 / 4;
  for (int item = warp; item < L.R0 * groups; item += NWARPS) {
    const int a = item / groups, q = item % groups;
    const bool zero_row = 4 * j0 - 3 + a < 0;  // the next stage's zero padding
    const float* xr = sX + 2 * a * LDX + 8 * q;
    float acc[4] = {bias, bias, bias, bias};
#pragma unroll
    for (int dt = 0; dt < 3; ++dt) {
      const float4 v0 = *reinterpret_cast<const float4*>(xr + dt * LDX);
      const float4 v1 = *reinterpret_cast<const float4*>(xr + dt * LDX + 4);
      const float xs[9] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w, xr[dt * LDX + 8]};
#pragma unroll
      for (int o = 0; o < 4; ++o)
#pragma unroll
        for (int df = 0; df < 3; ++df) acc[o] = fmaf(w[dt * 3 + df], xs[2 * o + df], acc[o]);
    }
    float* dst = sS + ((size_t)a * (F0 + 1) + 4 * q + 1) * L.LD0 + lane;
#pragma unroll
    for (int o = 0; o < 4; ++o) dst[o * L.LD0] = zero_row ? 0.f : activate<false>(acc[o], p.act);
  }
}

// Stage 0 for one 64-channel slice on the tensor cores (the bf16 kernel), as
// an im2col product with the 9 taps padded to K = 16: an m-tile is 16
// neighbouring frequencies of one stage-0 row, its A fragment is packed
// straight from the input tile (tap k of frequency f of row a is
// x[2a + k / 3][2f + k % 3] in the padded tile), the B fragments are the
// slice's 3x3 weights; bias, activation and the store follow from the
// accumulators.  About a third of the instructions of the SIMT form.
__device__ __forceinline__ void stage0_mma(const SubParams& p, const Layout& L,
                                           const float* sX, __nv_bfloat16* sS, int c0,
                                           int j0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int F0 = L.F0, LDX = L.LDX;
  constexpr int CS = slice_channels(2);
  const __nv_bfloat16* k0 = static_cast<const __nv_bfloat16*>(p.k0);
  const __nv_bfloat16* b0 = static_cast<const __nv_bfloat16*>(p.b0);
  uint32_t bfrag[CS / 8][2];
  float bias[CS / 8][2];
#pragma unroll
  for (int nt = 0; nt < CS / 8; ++nt) {
    const __nv_bfloat16* wr = k0 + (c0 + nt * 8 + g) * 9;  // B column n = g
    bfrag[nt][0] = pack_bf16(__bfloat162float(wr[2 * t]), __bfloat162float(wr[2 * t + 1]));
    bfrag[nt][1] = t == 0 ? pack_bf16(__bfloat162float(wr[8]), 0.f) : 0u;
    bias[nt][0] = __bfloat162float(b0[c0 + nt * 8 + 2 * t]);  // C columns 2t, 2t + 1
    bias[nt][1] = __bfloat162float(b0[c0 + nt * 8 + 2 * t + 1]);
  }
  // this thread's taps k = 2t, 2t + 1 (and k = 8 for t == 0) as offsets in sX
  const int off_lo = (2 * t) / 3 * LDX + (2 * t) % 3;
  const int off_hi = (2 * t + 1) / 3 * LDX + (2 * t + 1) % 3;
  const int off_8 = 2 * LDX + 2;
  const int nj = (F0 + 15) / 16;
  for (int item = warp; item < L.R0 * nj; item += NWARPS) {
    const int a = item / nj, j = item % nj;
    const bool zero_row = 4 * j0 - 3 + a < 0;  // the next stage's zero padding
    uint32_t afrag[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the m-tile
      const int f = 16 * j + g + 8 * h;
      const float* xp = sX + 2 * a * LDX + 2 * min(f, F0 - 1);  // rows past F0: not stored
      afrag[h] = pack_bf16(xp[off_lo], xp[off_hi]);
      afrag[2 + h] = t == 0 ? pack_bf16(xp[off_8], 0.f) : 0u;
    }
#pragma unroll
    for (int nt = 0; nt < CS / 8; ++nt) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(acc, afrag, bfrag[nt][0], bfrag[nt][1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = 16 * j + g + 8 * h;
        if (f < F0) {
          const float v0 = activate<true>(acc[2 * h] + bias[nt][0], p.act);
          const float v1 = activate<true>(acc[2 * h + 1] + bias[nt][1], p.act);
          put(sS + ((size_t)a * (F0 + 1) + f + 1) * L.LD0 + nt * 8 + 2 * t,
              zero_row ? 0.f : v0, zero_row ? 0.f : v1);
        }
      }
    }
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(NTHREADS) subsampling_fused_kernel(const SubParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout L = make_layout(p.To, p.F, C, sizeof(T));
  float* sX = reinterpret_cast<float*>(smem_raw);
  T* sH = reinterpret_cast<T*>(smem_raw + L.off_h);
  T* sS = reinterpret_cast<T*>(smem_raw + L.off_s);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y;
  const int j0 = blockIdx.x * p.To;  // first output frame of the tile
  const int T8 = p.Tin / 8;
  const int F = p.F, F0 = L.F0, F1 = L.F1, F8 = L.F8, LDX = L.LDX, LDH = L.LDH;
  const int act = p.act;
  constexpr bool FAST = !std::is_same<T, float>::value;
  constexpr int CS = slice_channels(sizeof(T));

  // ---- the input tile: frames [8 j0 - 7, 8 j0 + 8 To), zero outside [0, T) ----
  {
    const T* xb = static_cast<const T*>(p.x) + (long long)b * p.Tin * F;
    const int t0 = 8 * j0 - 7;
    for (int i = tid; i < L.RX * F; i += NTHREADS) {
      const int r = i / F, col = i % F;
      const int tg = t0 + r;
      sX[r * LDX + col + 1] = (tg >= 0 && tg < p.Tin) ? to_f(xb[(long long)tg * F + col]) : 0.f;
    }
    for (int r = tid; r < L.RX; r += NTHREADS) sX[r * LDX] = 0.f;  // frequency -1
  }
  // frequency -1 of every stage-0 slice: written once, never overwritten
  for (int i = tid; i < L.R0 * CS; i += NTHREADS)
    sS[(i / CS) * (F0 + 1) * L.LD0 + i % CS] = from_f<T>(0.f);
  __syncthreads();

  // ---- stage 0 and the first depthwise conv, one slice of channels at a time ----
  for (int c0 = 0; c0 < C; c0 += CS) {
    if constexpr (FAST)
      stage0_mma(p, L, sX, sS, c0, j0);
    else
      stage0_simt(p, L, sX, sS, c0, j0);
    __syncthreads();
    if constexpr (FAST) {
      // a lane owns channels c and c + 1: 4-byte loads, a warp reads a
      // position's 64 channels in one conflict-free pass
      const int c = c0 + 2 * lane;
      const __nv_bfloat16* kd = static_cast<const __nv_bfloat16*>(p.kd[0]);
      const __nv_bfloat16* bd = static_cast<const __nv_bfloat16*>(p.bd[0]);
      float w[9][2];
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        w[i][0] = __bfloat162float(kd[c * 9 + i]);
        w[i][1] = __bfloat162float(kd[(c + 1) * 9 + i]);
      }
      const float bias[2] = {__bfloat162float(bd[c]), __bfloat162float(bd[c + 1])};
      // the slice is two 32-channel blocks of the A operand
      const int col = c0 + 32 * (lane / 16) + a_column(2 * (lane % 16));
      for (int item = warp; item < L.M1; item += NWARPS) {
        const int r1 = item / F1, f1 = item % F1;
        const __nv_bfloat16* src = sS + ((size_t)2 * r1 * (F0 + 1) + 2 * f1) * L.LD0 + 2 * lane;
        float acc[2] = {bias[0], bias[1]};
#pragma unroll
        for (int dt = 0; dt < 3; ++dt)
#pragma unroll
          for (int df = 0; df < 3; ++df) {
            const uint32_t x2 =
                *reinterpret_cast<const uint32_t*>(src + (dt * (F0 + 1) + df) * L.LD0);
            acc[0] = fmaf(w[dt * 3 + df][0], __uint_as_float(x2 << 16), acc[0]);
            acc[1] = fmaf(w[dt * 3 + df][1], __uint_as_float(x2 & 0xffff0000u), acc[1]);
          }
        put(sH + item * LDH + col, acc[0], acc[1]);
      }
    } else {
      const int c = c0 + lane;
      float w[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) w[i] = to_f(static_cast<const T*>(p.kd[0])[c * 9 + i]);
      const float bias = to_f(static_cast<const T*>(p.bd[0])[c]);
      for (int item = warp; item < L.M1; item += NWARPS) {
        const int r1 = item / F1, f1 = item % F1;
        const T* src = sS + ((size_t)2 * r1 * (F0 + 1) + 2 * f1) * L.LD0 + lane;
        float acc = bias;
#pragma unroll
        for (int dt = 0; dt < 3; ++dt)
#pragma unroll
          for (int df = 0; df < 3; ++df)
            acc = fmaf(w[dt * 3 + df], to_f(src[(dt * (F0 + 1) + df) * L.LD0]), acc);
        sH[item * LDH + c] = from_f<T>(acc);
      }
    }
    __syncthreads();
  }

  // ---- pointwise 1 + act into sS as stage 1's output (frequency -1 zero) ----
  for (int i = tid; i < L.R1 * C; i += NTHREADS)
    sS[(size_t)(i / C) * (F1 + 1) * L.LD1 + i % C] = from_f<T>(0.f);
  pointwise<T, C>(sH, LDH, L.M1, p.kp[0], p.bp[0], act, [&](int m, int c, auto... v) {
    const int r1 = m / F1, f1 = m % F1;
    const bool zero_row = 2 * j0 - 1 + r1 < 0;
    put(sS + ((size_t)r1 * (F1 + 1) + f1 + 1) * L.LD1 + c, (zero_row ? 0.f : v)...);
  });
  __syncthreads();

  // ---- the second depthwise conv: (To, F/8, C) into sH ----
  {
    const int c = tid % C;  // NTHREADS % C == 0: a thread keeps its channel
    float w[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) w[i] = to_f(static_cast<const T*>(p.kd[1])[c * 9 + i]);
    const float bias = to_f(static_cast<const T*>(p.bd[1])[c]);
    const int col = FAST ? (c & ~31) + a_column(c & 31) : c;
    for (int pos = tid / C; pos < L.M2; pos += NTHREADS / C) {
      const int j = pos / F8, f8 = pos % F8;
      const T* src = sS + ((size_t)2 * j * (F1 + 1) + 2 * f8) * L.LD1 + c;
      float acc = bias;
#pragma unroll
      for (int dt = 0; dt < 3; ++dt)
#pragma unroll
        for (int df = 0; df < 3; ++df)
          acc = fmaf(w[dt * 3 + df], to_f(src[(dt * (F1 + 1) + df) * L.LD1]), acc);
      sH[pos * LDH + col] = from_f<T>(acc);
    }
  }
  __syncthreads();

  // ---- pointwise 2 + act, straight to the output ----
  {
    T* ob = static_cast<T*>(p.out) + (long long)b * T8 * F8 * C;
    pointwise<T, C>(sH, LDH, L.M2, p.kp[1], p.bp[1], act, [&](int m, int c, auto... v) {
      const int j = j0 + m / F8;
      if (j < T8) put(ob + ((long long)j * F8 + m % F8) * C + c, v...);
    });
  }
}

template <typename T, int C>
cudaError_t launch(SubParams p, int tile, cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  int To = 0;
  if (tile > 0) {
    To = tile;
  } else {
    for (int cand = 8; cand >= 1 && To == 0; cand /= 2)
      if (make_layout(cand, p.F, C, sizeof(T)).total <= (size_t)max_smem) To = cand;
  }
  if (To == 0 || make_layout(To, p.F, C, sizeof(T)).total > (size_t)max_smem)
    return cudaErrorInvalidValue;
  p.To = To;
  const size_t smem = make_layout(To, p.F, C, sizeof(T)).total;
  err = cudaFuncSetAttribute(subsampling_fused_kernel<T, C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tin / 8 + To - 1) / To, p.B);
  subsampling_fused_kernel<T, C><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  `tile` is the number of output
// frames per CTA, 0 for the largest that fits.  For fp32 the pointwise
// weights kp1, kp2 come transposed, (C in, C out).
int lcasr_subsampling_fused(const void* x, void* out, const void* k0, const void* b0,
                            const void* kd1, const void* bd1, const void* kp1,
                            const void* bp1, const void* kd2, const void* bd2,
                            const void* kp2, const void* bp2, int B, int T, int F, int C,
                            int is_f32, int act, int tile, void* stream) {
  if (T % 8 || F % 8 || T <= 0 || F <= 0 || B <= 0 || B > 65535 || act < 0 || act > 3)
    return (int)cudaErrorInvalidValue;
  SubParams p;
  p.x = x;
  p.out = out;
  p.k0 = k0;
  p.b0 = b0;
  p.kd[0] = kd1;
  p.bd[0] = bd1;
  p.kp[0] = kp1;
  p.bp[0] = bp1;
  p.kd[1] = kd2;
  p.bd[1] = bd2;
  p.kp[1] = kp2;
  p.bp[1] = bp2;
  p.B = B;
  p.Tin = T;
  p.F = F;
  p.To = 0;
  p.act = act;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 128)
    return is_f32 ? launch<float, 128>(p, tile, s) : launch<__nv_bfloat16, 128>(p, tile, s);
  if (C == 256)
    return is_f32 ? launch<float, 256>(p, tile, s) : launch<__nv_bfloat16, 256>(p, tile, s);
  return (int)cudaErrorInvalidValue;
}

const char* lcasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
