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
// Pallas body rounds it (after stage 0's activation, after each depthwise
// conv, after each pointwise activation), and no intermediate in device
// memory.  T % 8 == 0 and F % 8 == 0 (so no stage ever reads its right zero
// padding in time or frequency), F <= MAX_F, C any multiple of 128 up to
// MAX_C; x and every parameter in one dtype, bf16 or fp32.  Its plain version
// is `dw_striding_chain` (lcasr_torch/ops/subsampling.py).
//
// Bound on the H100: at the decode shape (16, 16384, 80) -> C 256 the chain
// has 1.76 G activation values, each needing at least one exponential: 0.42
// ms on the special-function units (16 a clock on each SM), above the 246
// GFLOP on the tensor cores (0.25 ms) and the 0.2 GB of input and output
// (0.06 ms).  So the special-function units and the instruction issue of the
// per-value work (stage 0's epilogue, the depthwise FMAs) bound it; the
// design keeps the tensor cores and the weight traffic off that path.
//
// Design (bf16).  A CTA of four warpgroups walks tiles of `To` output frames
// of one batch row (persistent: one CTA an SM, tiles strided by the grid).
// Output frame j needs stage-1 rows [2j-1, 2j+1], stage-0 rows [4j-3, 4j+3]
// and input frames [8j-7, 8j+7]: a tile reads 8 To + 7 input frames and
// recomputes its halo.  Rows of a stage at globally negative indices are the
// next stage's left zero padding: written as zeros, not as act(bias).  Per
// tile:
//   - A, the operand of pointwise 1 (the tile's stage-1 positions x the
//     channels, in blocks of 64 channels, 128-byte swizzled for wgmma), is
//     built by the warps independently: each warp owns units of 16 (or 8)
//     channels and sweeps the tile's rows with them, stage 0 on the tensor
//     cores (an im2col mma.sync with the 9 taps and the bias padded to
//     K = 16, A fragments packed from the input tile) into a rolling window
//     of three stage-0 rows in its own shared memory, then the first
//     depthwise conv of the stage-1 row those rows complete, straight into A.
//     No barrier of the CTA falls inside, so one warp's exponentials overlap
//     another's depthwise FMAs;
//   - pointwise 1 by `wgmma` from A in groups of 128 output channels, on
//     warpgroups 0-2 (64 positions each, 64 fp32 accumulators a thread), the
//     group's epilogue (bias, act) into stage 1's output for its channels,
//     and the second depthwise conv of those channels into stage 2's operand
//     (A's layout);
//   - pointwise 2 from that whole operand (To F/8 <= 64 positions x C) by
//     `wgmma`, in groups of 128 output channels, warpgroups 0 and 1 half a
//     group each, straight to the output.
// The pointwise weights never sit whole on the chip: they stream from L2 in
// (128 output x 64 input channel) tiles through a ring of NS slots, loaded by
// TMA (128-byte swizzle) by warpgroup 3's first thread as the slots free up;
// the consumers run no divergent code while their products are in flight.
// The input tile comes by 16-byte cp.async, the next tile's while this one's
// products run.  The activation is a template parameter and the pointwise
// biases sit in shared memory.  `To` is the largest tile whose stage-1
// positions fit three 64-row products, whose stage-2 positions fit one and
// whose buffers fit the SM's shared memory with A whole and two or more
// weight slots (4 frames and 3 slots at F 80 and C 256), or LCASR_SUB_TILE's.
// Where A cannot be held whole (C above 1024 at F 80) it is held in chunks of
// KC channels and rebuilt for each group of pointwise 1: correct at every C
// up to MAX_C, and slower by the recomputation.
// The fp32 kernel keeps SIMT products (its tolerance against the fp32 chain
// rules out TF32) in groups of 128 output channels, A whole where it fits
// (C 256 at To 2, built once), else rebuilt in slices of 32 channels for
// each group; stage 2's operand whole.

#include <algorithm>
#include <type_traits>

#include "hopper_common.cuh"

namespace {

constexpr int NTHREADS = 512;   // four warpgroups
constexpr int NWARPS = NTHREADS / 32;
constexpr int KS = 64;          // input channels of a weight tile and of a block of A: one 128-byte row
constexpr int NG = 128;         // output channels of a pointwise group (bf16)
constexpr int MAX_SLOTS = 4;    // weight tiles in flight, at most
constexpr int KS32 = 32;        // input channels of a K-slice (fp32)
constexpr int NG32 = 128;       // output channels of a group (fp32)
constexpr int MAX_C = 2048;     // the widest d_model in configs/
constexpr int MAX_F = 168;      // a one-frame tile's 3 F/4 stage-1 positions fit the fp32 kernel's 128 rows
constexpr int CONSUMERS = 384;  // bf16: warpgroups 0-2 own the products; warpgroup 3's first
                                // thread loads their weights
constexpr int MAX_POS1 = 192;   // stage-1 positions of a tile: three m-tiles (bf16)
constexpr int MAX_POS2 = 64;    // stage-2 positions of a tile: one m-tile

enum Act { ACT_NONE = 0, ACT_SILU = 1, ACT_RELU = 2, ACT_GELU = 3 };

// Built with -DLCASR_K8_CLOCKS, thread 0 of each CTA of the bf16 kernel adds
// the SM clocks of each phase of its tiles to k8_clocks (read and cleared by
// lcasr_subsampling_clocks): where a CTA's time goes.  Compiled out otherwise.
enum K8Phase {
  K8_INPUT,       // the tile's input, and the CTA barrier before stage 0
  K8_STAGE0,      // stage 0 of thread 0's warp
  K8_DW1,         // its first depthwise conv
  K8_A_BARRIER,   // waiting for the other warps' parts of A
  K8_PW1_WAIT,    // waiting for pointwise 1's weight tiles
  K8_PW1,         // issuing pointwise 1's products and waiting for them
  K8_EPILOGUE1,   // bias and act of stage 1, to the consumers' barrier
  K8_DW2,         // the second depthwise conv, to the consumers' barrier
  K8_PW2_WAIT,    // waiting for pointwise 2's weight tiles
  K8_PW2,         // issuing its products, waiting for them, act, the output
  K8_TILE_END,    // the CTA barrier at the tile's end
  K8_PHASES
};
#ifdef LCASR_K8_CLOCKS
__device__ unsigned long long k8_clocks[K8_PHASES];
#define K8_CLOCK(t) long long t = clock64()
#define K8_RESET(t) (t) = clock64()
#define K8_MARK(t, ph)                                                            \
  do {                                                                            \
    if (threadIdx.x == 0) {                                                       \
      const long long now_ = clock64();                                           \
      atomicAdd(&k8_clocks[ph], static_cast<unsigned long long>(now_ - (t)));     \
      (t) = now_;                                                                 \
    }                                                                             \
  } while (0)
#else
#define K8_CLOCK(t) \
  do {              \
  } while (0)
#define K8_RESET(t) \
  do {              \
  } while (0)
#define K8_MARK(t, ph) \
  do {                 \
  } while (0)
#endif

// The tile's geometry and shared-memory layout (`make_layout`), computed on
// the host and passed in the parameters, so that the kernels read it from
// the constant bank and hold none of it in registers.
struct Layout {
  int RX, LDX, R0, F0, R1, F1, F8, M1, M2;
  int MA, MA2;  // bf16: rows of a 64-channel block of A and of stage 2's operand (M1, M2
                // rounded up to the swizzle atom's 8)
  int KC;  // bf16: channels of A held at once (C, or a chunk of it rebuilt per group)
  int NS;  // bf16: weight slots
  int LD1, LDH2, LDA;  // channel strides of a position: stage 1's group; fp32: stage 2's operand, A
  size_t off_a, off_w, off_s, off_h2, off_x, off_b, off_bar, total;  // bytes from the aligned base
};

struct SubParams {
  Layout L;
  const void* x;    // (B, T, F)
  void* out;        // (B, T/8, F/8, C)
  const void* k0;   // (C, 9): OIHW (C, 1, 3, 3)
  const void* b0;   // (C,)
  const void* kd[2];  // (C, 9) depthwise
  const void* bd[2];
  const void* kp[2];  // bf16: (C out, C in), read by TMA; fp32: transposed, (C in, C out)
  const void* bp[2];
  int B, Tin, F, C, To, act;
};

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }
__host__ __device__ inline size_t align_up(size_t a, size_t b) { return (a + b - 1) / b * b; }

// bf16: a warp's rolling window of three stage-0 rows, 16 channels a position
constexpr int WIN_ROWS = 3, WIN_CH = 16;

// NS matters for bf16 only.
inline Layout make_layout(int To, int F, int C, int KC, int NS, bool f32) {
  Layout L;
  L.RX = 8 * To + 7;
  L.R0 = 4 * To + 3;
  L.F0 = F / 2;
  L.R1 = 2 * To + 1;
  L.F1 = F / 4;
  L.F8 = F / 8;
  L.M1 = L.R1 * L.F1;
  L.M2 = To * L.F8;
  L.MA = round_up(L.M1, 8);
  L.MA2 = round_up(L.M2, 8);
  L.KC = KC;
  L.NS = NS;
  if (!f32) {
    // bf16: A first (its blocks 1024-byte aligned, the swizzle atom; the
    // products of rows past M1 read on into the ring, which is at least
    // 32 KB long), the ring, the region of the warps' stage-0 windows, which
    // once A is built holds stage 1's output for a group and after it stage
    // 2's operand in A's layout (whose product reads up to 64 rows, on into
    // the input tile): sharing the region leaves room for a third weight
    // slot at F 80, C 256, To 4.  Then the input tile (the data from column 8
    // for 16-byte copies, column 7 the zero of frequency -1)
    L.LDX = F + 16;
    L.LD1 = NG + 8;
    L.LDH2 = 0;
    L.off_a = 0;
    L.off_w = L.off_a + (size_t)(KC / KS) * L.MA * 128;
    L.off_s = L.off_w + (size_t)NS * NG * KS * 2;
    const size_t s0 = (size_t)NWARPS * WIN_ROWS * (L.F0 + 1) * WIN_CH * 2;
    const size_t s1 = (size_t)L.R1 * (L.F1 + 1) * L.LD1 * 2;
    // (where A is rebuilt per group, the windows come back: stage 2's operand
    // then lies past them)
    L.off_h2 = L.off_s + align_up(KC == C ? s1 : std::max(s0, s1), 1024);
    const size_t h2_end = L.off_h2 + (size_t)(C / KS) * L.MA2 * 128;
    L.off_x = align_up(std::max(L.off_s + s0, h2_end), 16);
    L.off_b = L.off_x + align_up((size_t)L.RX * L.LDX * 2, 16);
    L.off_bar = L.off_b + (size_t)2 * C * 4;
    L.total = std::max(L.off_bar + 2 * NS * 8, h2_end + (size_t)(64 - L.MA2) * 128);
  } else {
    // fp32: A (M1 positions x KC channels), the input tile with one zero
    // column on the left; rows 16-byte aligned for float4 reads
    L.LDX = F + 4;
    L.LD1 = NG32;
    L.LDH2 = C + 4;
    L.LDA = KC + 4;
    L.off_a = L.off_w = 0;
    L.off_x = align_up((size_t)L.M1 * L.LDA * 4, 16);
    L.off_s = L.off_x + align_up((size_t)L.RX * L.LDX * 4, 16);
    const size_t s0 = (size_t)L.R0 * (L.F0 + 1) * KS32 * 4;
    const size_t s1 = (size_t)L.R1 * (L.F1 + 1) * L.LD1 * 4;
    L.off_h2 = L.off_s + align_up(s0 > s1 ? s0 : s1, 16);
    L.off_bar = L.off_h2 + align_up((size_t)L.M2 * L.LDH2 * 4, 16);
    L.total = L.off_bar;
  }
  return L;
}

// Whether a tile of To output frames fits: its positions and its buffers
// (the bf16 kernel aligns its base to 1024 bytes: that much slack).
__host__ inline bool tile_fits(int To, int F, int C, int KC, int NS, bool f32, int max_smem) {
  const Layout L = make_layout(To, F, C, KC, NS, f32);
  return L.M1 <= (f32 ? 128 : MAX_POS1) && L.M2 <= MAX_POS2 &&
         L.total + (f32 ? 0 : 1024) <= (size_t)max_smem;
}

// The fp32 kernel's activations, in their precise forms.
__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case ACT_SILU:
      return v / (1.f + expf(-v));
    case ACT_RELU:
      return fmaxf(v, 0.f);
    case ACT_GELU:  // exact, erf
      return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
    default:
      return v;
  }
}

// 1 / x, 1 ulp, denormals flushed
__device__ __forceinline__ float rcp_ftz(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// The bf16 kernel's activations, fixed at compile time: a switch on a
// runtime code at every value kept the compiler from interleaving a thread's
// independent exponentials (stage 0 then ran at 3x its special-function
// floor).  silu by ex2.approx and rcp.approx, a relative error near 1e-6
// over the whole range, which the rounding of the result to bf16 (2e-3)
// hides; their flush-to-zero forms (the same bits wherever the values are
// normal) spare each value the three instructions of the denormal range.
// (silu as h + h tanh.approx(h), h = v / 2, needs one special-function
// operation instead of two, but loses the negative tail below v = -8 on the
// H100; chip_smoke.py's silu-tail case catches it.)
template <int ACT>
__device__ __forceinline__ float act_fast(float v) {
  if constexpr (ACT == ACT_SILU) return v * rcp_ftz(1.f + hopper::ex2(v * -1.4426950408889634f));
  if constexpr (ACT == ACT_RELU) return fmaxf(v, 0.f);
  if constexpr (ACT == ACT_GELU) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  return v;
}

__device__ __forceinline__ float bf(const void* p, int i) {
  return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}
__device__ __forceinline__ float f32(const void* p, int i) {
  return static_cast<const float*>(p)[i];
}

// ---------------------------------------------------------------------------
// bf16 kernel
// ---------------------------------------------------------------------------

// Byte offset of (row, 16-byte chunk) in a tile of 128-byte rows with the
// 128-byte swizzle that TMA and the wgmma descriptors use.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// The weight tiles of one output tile, in the order they are consumed:
// pointwise 1's groups x K-blocks, then pointwise 2's.  Tile q of a CTA is
// tile q % (2 G K) of that order.  One producer thread issues the loads; the
// consumers' warps wait for a tile and release it.
struct WeightRing {
  uint64_t* full;
  uint64_t* empty;
  __nv_bfloat16* slots;
  int ns, nk, per_tile, total;
  int issued;  // the producer's count of tiles whose load has been issued

  // The producer: issue the loads of tiles [issued, upto), each as its slot
  // is released.
  __device__ void produce(int upto, const CUtensorMap* w1, const CUtensorMap* w2) {
    for (; issued < min(upto, total); ++issued) {
      const int s = issued % ns;
      hopper::mbar_wait(&empty[s], ((issued / ns) & 1) ^ 1);
      int r = issued % per_tile;
      const CUtensorMap* map = w1;
      if (r >= per_tile / 2) {
        r -= per_tile / 2;
        map = w2;
      }
      hopper::mbar_arrive_expect_tx(&full[s], (uint32_t)NG * KS * 2);
      hopper::tma_load_4d(slots + (size_t)s * NG * KS, map, &full[s], (r % nk) * KS, 0,
                          (r / nk) * NG, 0);
    }
  }
  __device__ const __nv_bfloat16* wait(int q) const {
    hopper::mbar_wait(&full[q % ns], (q / ns) & 1);
    return slots + (size_t)(q % ns) * NG * KS;
  }
  // A consumer warp, after its wait for the products that read tile q.
  __device__ void release(int q) const {
    if (threadIdx.x % 32 == 0) hopper::mbar_arrive(&empty[q % ns]);
  }
};

// Stage 0 of the tile's stage-0 rows a .. a + NR - 1 for a warp's unit of
// 8 NT channels on the tensor cores, as an im2col product with the 9 taps and
// the bias padded to K = 16: an m-tile is 16 neighbouring frequencies, its A
// fragment is packed straight from the input tile (tap k of frequency f is
// x[2a + k / 3][2f + k % 3 - 1], tap 9 is 1), the B fragments (`bfrag`) are
// the unit's 3x3 weights and bias.  Into the row slots `dst` (position f + 1,
// WIN_CH channels a position; position 0 is frequency -1).  Two rows at a
// time give a thread 8 NT independent exponentials in flight, not 4 NT.
template <int NT, int ACT, int NR>
__device__ __forceinline__ void stage0_rows(const Layout& L, const unsigned short* xs,
                                            __nv_bfloat16* const* dst,
                                            const uint32_t (*bfrag)[2], int a) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int F0 = L.F0, LDX = L.LDX;
  // this thread's taps k = 2t, 2t + 1 (and k = 8 for t == 0) as offsets in sX
  const int off_lo = (2 * t) / 3 * LDX + (2 * t) % 3;
  const int off_hi = (2 * t + 1) / 3 * LDX + (2 * t + 1) % 3;
  const unsigned short* xr = xs + 2 * a * LDX + 7;  // frequency 2f - 1 sits at column 2f + 7
  // frequencies [16 j, 16 j + 16); only the last block may reach past F0,
  // so only it checks (the others store without branches)
  auto block = [&](int j, auto edge_type) {
    constexpr bool edge = decltype(edge_type)::value;
    uint32_t afrag[NR][4];
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the m-tile
        const int f = 16 * j + g + 8 * h;
        // rows past F0 are not stored
        const unsigned short* xp = xr + 2 * r * LDX + 2 * (edge ? min(f, F0 - 1) : f);
        afrag[r][h] = xp[off_lo] | ((uint32_t)xp[off_hi] << 16);
        afrag[r][2 + h] = t == 0 ? xp[2 * LDX + 2] | 0x3f800000u : 0u;  // tap 9: bf16 1
      }
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(acc, afrag[r], bfrag[nt][0], bfrag[nt][1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = 16 * j + g + 8 * h;
          if (!edge || f < F0)
            *reinterpret_cast<uint32_t*>(dst[r] + (f + 1) * WIN_CH + nt * 8 + 2 * t) =
                pack_bf16(act_fast<ACT>(acc[2 * h]), act_fast<ACT>(acc[2 * h + 1]));
        }
      }
  };
  int j = 0;
  for (; j < F0 / 16; ++j) block(j, std::false_type{});
  if (F0 % 16) block(j, std::true_type{});
}

// A stage-0 row left of the input: the next stage's zero padding.
template <int NT>
__device__ __forceinline__ void zero_row(const Layout& L, __nv_bfloat16* dst) {
  for (int i = threadIdx.x % 32; i < L.F0 * 4 * NT; i += 32)
    *reinterpret_cast<uint32_t*>(dst + (1 + i / (4 * NT)) * WIN_CH + 2 * (i % (4 * NT))) = 0u;
}

// Stage-0 row a (local) of the tile at output frame j0, or its zeros.
template <int NT, int ACT>
__device__ __forceinline__ void stage0_row(const Layout& L, const unsigned short* xs,
                                           __nv_bfloat16* dst, const uint32_t (*bfrag)[2],
                                           int a, int j0) {
  if (4 * j0 - 3 + a < 0)
    zero_row<NT>(L, dst);
  else
    stage0_rows<NT, ACT, 1>(L, xs, &dst, bfrag, a);
}

constexpr int STAGE0_ROWS = 2;  // rows of stage 0 a pass (1 or 2)

// The channels [cb, cb + kc) of A for the tile at output frame j0: stage 0
// and the first depthwise conv, warp by warp (see the design above).  A
// holds stage-1 position m, channel cb + k at block k / 64, row m, 16-byte
// chunk (k % 64) / 8 of the swizzle.  Ends with A complete for the products.
template <int NT, int ACT>
__device__ void build_a(const SubParams& p, const Layout& L, const __nv_bfloat16* sX,
                        __nv_bfloat16* sS, unsigned char* sA, int cb, int kc, int j0) {
  constexpr int UC = 8 * NT;   // channels of a unit
  constexpr int LP = UC / 2;   // lanes on a position in the depthwise conv (two channels each)
  constexpr int PP = 32 / LP;  // positions a pass
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int F0 = L.F0, F1 = L.F1, RS = (F0 + 1) * WIN_CH;  // a row slot, in elements
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(sX);
  __nv_bfloat16* win = sS + (size_t)warp * WIN_ROWS * RS;
  const int cpair = lane % LP, ps = lane / LP;
  K8_CLOCK(clk);
  for (int u = warp; u < kc / UC; u += NWARPS) {
    const int c0 = cb + u * UC;
    uint32_t bfrag[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = c0 + nt * 8 + g;  // B column g
      bfrag[nt][0] = pack_bf16(bf(p.k0, n * 9 + 2 * t), bf(p.k0, n * 9 + 2 * t + 1));
      bfrag[nt][1] = t == 0 ? pack_bf16(bf(p.k0, n * 9 + 8), bf(p.b0, n)) : 0u;
    }
    const int c = c0 + 2 * cpair;  // this lane's channels in the depthwise conv
    float w[9][2];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      w[i][0] = bf(p.kd[0], c * 9 + i);
      w[i][1] = bf(p.kd[0], (c + 1) * 9 + i);
    }
    const float bias0 = bf(p.bd[0], c), bias1 = bf(p.bd[0], c + 1);
    const int k = c - cb;
    unsigned char* acol = sA + (size_t)(k / KS) * L.MA * 128 + (k % 8) * 2;
    const int chunk = (k % KS) / 8;
    // frequency -1 of the three row slots (the region held stage 1 before)
    if (lane < WIN_ROWS * LP)
      *reinterpret_cast<uint32_t*>(win + (lane / LP) * RS + 2 * (lane % LP)) = 0u;
    stage0_row<NT, ACT>(L, xs, win, bfrag, 0, j0);
    for (int i = 0; i < L.R1; ++i) {
      // stage-0 rows 2i + 1, 2i + 2 into the slots of rows 2i - 2, 2i - 1
      __nv_bfloat16* const next[2] = {win + ((2 * i + 1) % WIN_ROWS) * RS,
                                      win + ((2 * i + 2) % WIN_ROWS) * RS};
      if (STAGE0_ROWS == 2 && 4 * j0 - 3 + 2 * i + 1 >= 0) {
        stage0_rows<NT, ACT, 2>(L, xs, next, bfrag, 2 * i + 1);
      } else {
        stage0_row<NT, ACT>(L, xs, next[0], bfrag, 2 * i + 1, j0);
        stage0_row<NT, ACT>(L, xs, next[1], bfrag, 2 * i + 2, j0);
      }
      __syncwarp();
      K8_MARK(clk, K8_STAGE0);
      // this lane's first channel pair of each row, as 4-byte words
      const uint32_t* rows[3];
#pragma unroll
      for (int dt = 0; dt < 3; ++dt)
        rows[dt] = reinterpret_cast<const uint32_t*>(win + ((2 * i + dt) % WIN_ROWS) * RS +
                                                     2 * ps * WIN_CH + 2 * cpair);
      int m = i * F1 + ps;
      for (int o = 0; m < (i + 1) * F1; o += PP * WIN_CH, m += PP) {
        float acc0 = bias0, acc1 = bias1;
#pragma unroll
        for (int dt = 0; dt < 3; ++dt)
#pragma unroll
          for (int df = 0; df < 3; ++df) {
            const uint32_t x2 = rows[dt][o + df * (WIN_CH / 2)];
            acc0 = fmaf(w[dt * 3 + df][0], __uint_as_float(x2 << 16), acc0);
            acc1 = fmaf(w[dt * 3 + df][1], __uint_as_float(x2 & 0xffff0000u), acc1);
          }
        *reinterpret_cast<uint32_t*>(acol + swz(m, chunk)) = pack_bf16(acc0, acc1);
      }
      __syncwarp();  // the slots are rewritten next
      K8_MARK(clk, K8_DW1);
    }
  }
  hopper::fence_proxy_async();
  __syncthreads();  // A complete
  K8_MARK(clk, K8_A_BARRIER);
}

// The input tile of tile (b, j0): frames [8 j0 - 7, 8 j0 + 8 To), zero
// outside [0, T), by 16-byte cp.async (committed by the caller).
__device__ __forceinline__ void load_x_async(const SubParams& p, const Layout& L,
                                             __nv_bfloat16* sX, int b, int j0) {
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(p.x) + (long long)b * p.Tin * p.F;
  const int chunks = p.F / 8, t0 = 8 * j0 - 7;
  for (int i = threadIdx.x; i < L.RX * chunks; i += NTHREADS) {
    const int r = i / chunks, c = i - r * chunks;
    const int tg = t0 + r;
    const bool ok = tg >= 0 && tg < p.Tin;
    cp_async16(sX + r * L.LDX + 8 + 8 * c, ok ? xb + (long long)tg * p.F + 8 * c : xb, ok);
  }
}

template <int ACT>
__global__ void __launch_bounds__(NTHREADS, 1)
    subsampling_fused_bf16(const __grid_constant__ CUtensorMap tw1,
                           const __grid_constant__ CUtensorMap tw2, const SubParams p) {
  constexpr int N2 = NG / 2;  // pointwise 2: warpgroups 0 and 1 take half a group each
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  const Layout& L = p.L;
  unsigned char* sA = base + L.off_a;
  __nv_bfloat16* sW = reinterpret_cast<__nv_bfloat16*>(base + L.off_w);
  unsigned char* sH2 = base + L.off_h2;
  __nv_bfloat16* sS = reinterpret_cast<__nv_bfloat16*>(base + L.off_s);
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(base + L.off_x);
  float* sB = reinterpret_cast<float*>(base + L.off_b);  // the pointwise biases, fp32
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.off_bar);

  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const bool consumer = wg < 3, producer = tid == CONSUMERS;
  const int ww = (tid / 32) % 4, g = lane / 4, t = lane % 4;
  const int C = p.C, To = p.To, F1 = L.F1, F8 = L.F8, KC = L.KC;
  const int nk = C / KS, ngroups = C / NG;
  const bool whole = KC == C;
  const int T8 = p.Tin / 8, per_row = (T8 + To - 1) / To, n_tiles = p.B * per_row;
  const int my_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  WeightRing ring{bars, bars + L.NS, sW, L.NS, nk, 2 * ngroups * nk,
                  my_tiles * 2 * ngroups * nk, 0};
  if (tid == 0) {
    for (int s = 0; s < L.NS; ++s) {
      hopper::mbar_init(&ring.full[s], 1);
      hopper::mbar_init(&ring.empty[s], CONSUMERS / 32);
    }
    hopper::fence_barrier_init();
  }
  // frequency -1 of the input tile: written once, never overwritten
  for (int r = tid; r < L.RX; r += NTHREADS) sX[r * L.LDX + 7] = __float2bfloat16(0.f);
  for (int c = tid; c < 2 * C; c += NTHREADS) sB[c] = c < C ? bf(p.bp[0], c) : bf(p.bp[1], c - C);
  __syncthreads();
  if (producer) ring.produce(L.NS, &tw1, &tw2);
  if (my_tiles > 0) {
    const int tile = blockIdx.x;
    load_x_async(p, L, sX, tile / per_row, (tile % per_row) * To);
  }
  cp_async_commit();

  int q = 0;  // weight tiles consumed
  K8_CLOCK(clk);
  for (int it = 0; it < my_tiles; ++it) {
    const int tile = blockIdx.x + it * gridDim.x;
    const int b = tile / per_row, j0 = (tile % per_row) * To;
    const int tile_end = (it + 1) * ring.per_tile;
    cp_async_wait_group<0>();
    __syncthreads();  // the input tile
    K8_MARK(clk, K8_INPUT);

    // A's channels [cb, cb + kc); the producer then loads the weights up to
    // the next CTA barrier and a ring's worth beyond, and after the tile's
    // last build the next tile's input comes into sX, whose last reader that
    // was
    auto build = [&](int cb, int kc, int upto, bool last) {
      if (kc % 256 == 0)
        build_a<2, ACT>(p, L, sX, sS, sA, cb, kc, j0);
      else
        build_a<1, ACT>(p, L, sX, sS, sA, cb, kc, j0);
      if (last && it + 1 < my_tiles) {
        const int nt = tile + gridDim.x;
        load_x_async(p, L, sX, nt / per_row, (nt % per_row) * To);
      }
      cp_async_commit();
      if (producer) ring.produce(upto + L.NS, &tw1, &tw2);
      K8_RESET(clk);  // build_a counted its own phases
    };
    if (whole) build(0, C, tile_end, true);

    // ---- pointwise 1 + act, group by group, and the second depthwise conv ----
    for (int grp = 0; grp < ngroups; ++grp) {
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int cb = 0; cb < C; cb += KC) {
        const int kc = min(KC, C - cb), nkc = kc / KS;
        if (!whole) {
          __syncthreads();  // every product that read A before is done
          const bool last = grp == ngroups - 1 && cb + kc == C;
          build(cb, kc, last ? tile_end : q + nkc, last);
        }
        if (consumer) {
          // two groups of products in flight; a third slot keeps a load ahead
          for (int kb = 0; kb < nkc; ++kb) {
            const __nv_bfloat16* wt = ring.wait(q + kb);
            K8_MARK(clk, K8_PW1_WAIT);
            hopper::fence_all<64>(acc);
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < KS / 16; ++kk) {
              const uint64_t da = hopper::smem_desc(
                  sA + ((size_t)kb * L.MA + wg * 64) * 128 + kk * 32, 16, 1024,
                  hopper::SWIZZLE_128B);
              const uint64_t db = hopper::smem_desc(wt + kk * 16, 16, 1024, hopper::SWIZZLE_128B);
              hopper::wgmma_m64n128k16_ss(acc, da, db, 1);
            }
            hopper::wgmma_commit();
            hopper::fence_all<64>(acc);
            if (kb > 0) {
              hopper::wgmma_wait<1>();
              ring.release(q + kb - 1);
            }
            K8_MARK(clk, K8_PW1);
          }
          hopper::wgmma_wait<0>();
          hopper::fence_all<64>(acc);
          ring.release(q + nkc - 1);
          K8_MARK(clk, K8_PW1);
        }
        q += nkc;
      }
      if (!consumer) continue;

      // the group's epilogue: bias, act, stage 1's output for its channels
      // (frequency -1 zero; rows left of the input the next stage's zeros)
      for (int i = tid; i < L.R1 * NG; i += CONSUMERS)
        sS[(size_t)(i / NG) * (F1 + 1) * L.LD1 + i % NG] = __float2bfloat16(0.f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wg * 64 + 16 * ww + g + 8 * h;
        if (m < L.M1) {
          const int r1 = m / F1, f1 = m - (m / F1) * F1;
          const bool zero_row = 2 * j0 - 1 + r1 < 0;
          __nv_bfloat16* dst = sS + ((size_t)r1 * (F1 + 1) + f1 + 1) * L.LD1 + 2 * t;
          const int c = grp * NG + 2 * t;
#pragma unroll
          for (int j = 0; j < NG / 8; ++j) {
            const float2 bias = *reinterpret_cast<const float2*>(sB + c + 8 * j);
            *reinterpret_cast<uint32_t*>(dst + 8 * j) =
                zero_row ? 0u
                         : pack_bf16(act_fast<ACT>(acc[4 * j + 2 * h] + bias.x),
                                     act_fast<ACT>(acc[4 * j + 2 * h + 1] + bias.y));
          }
        }
      }
      hopper::named_sync(1, CONSUMERS);
      K8_MARK(clk, K8_EPILOGUE1);
      // the second depthwise conv on the group's channels: (To, F/8) into
      // stage 2's operand (A's layout), channels [grp NG, grp NG + NG); a
      // thread keeps a pair of neighbouring channels (one 4-byte load a tap)
      {
        constexpr int PAIRS = NG / 2;  // CONSUMERS % PAIRS == 0
        const int cg = grp * NG + 2 * (tid % PAIRS);
        float w[9][2];
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          w[i][0] = bf(p.kd[1], cg * 9 + i);
          w[i][1] = bf(p.kd[1], (cg + 1) * 9 + i);
        }
        const float bias0 = bf(p.bd[1], cg), bias1 = bf(p.bd[1], cg + 1);
        unsigned char* hcol = sH2 + (size_t)(cg / KS) * L.MA2 * 128 + (cg % 8) * 2;
        const int chunk = (cg % KS) / 8;
        for (int pos = tid / PAIRS; pos < L.M2; pos += CONSUMERS / PAIRS) {
          const int j = pos / F8, f8 = pos - (pos / F8) * F8;
          const __nv_bfloat16* src =
              sS + ((size_t)2 * j * (F1 + 1) + 2 * f8) * L.LD1 + cg - grp * NG;
          float a0 = bias0, a1 = bias1;
#pragma unroll
          for (int dt = 0; dt < 3; ++dt)
#pragma unroll
            for (int df = 0; df < 3; ++df) {
              const uint32_t x2 =
                  *reinterpret_cast<const uint32_t*>(src + (dt * (F1 + 1) + df) * L.LD1);
              a0 = fmaf(w[dt * 3 + df][0], __uint_as_float(x2 << 16), a0);
              a1 = fmaf(w[dt * 3 + df][1], __uint_as_float(x2 & 0xffff0000u), a1);
            }
          *reinterpret_cast<uint32_t*>(hcol + swz(pos, chunk)) = pack_bf16(a0, a1);
        }
      }
      hopper::fence_proxy_async();
      hopper::named_sync(1, CONSUMERS);  // stage 1's region free; the group's columns of stage 2
      K8_MARK(clk, K8_DW2);
    }

    // ---- pointwise 2 + act, straight to the output: warpgroups 0 and 1 take
    // half a group each, warpgroup 2 releases the tiles with them ----
    if (consumer) {
      __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.out) + (long long)b * T8 * F8 * C;
      for (int g2 = 0; g2 < ngroups; ++g2, q += nk) {
        if (wg == 2) {
          for (int kb = 0; kb < nk; ++kb) {
            ring.wait(q + kb);
            ring.release(q + kb);
          }
          continue;
        }
        float acc2[N2 / 2];
#pragma unroll
        for (int i = 0; i < N2 / 2; ++i) acc2[i] = 0.f;
        for (int kb = 0; kb < nk; ++kb) {
          const __nv_bfloat16* wt = ring.wait(q + kb) + (size_t)wg * N2 * KS;
          K8_MARK(clk, K8_PW2_WAIT);
          hopper::fence_all<N2 / 2>(acc2);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KS / 16; ++kk) {
            const uint64_t da = hopper::smem_desc(sH2 + (size_t)kb * L.MA2 * 128 + kk * 32, 16,
                                                  1024, hopper::SWIZZLE_128B);
            const uint64_t db = hopper::smem_desc(wt + kk * 16, 16, 1024, hopper::SWIZZLE_128B);
            hopper::wgmma_m64n64k16_ss<0, 0>(acc2, da, db, 1);
          }
          hopper::wgmma_commit();
          hopper::fence_all<N2 / 2>(acc2);
          if (kb > 0) {
            hopper::wgmma_wait<1>();
            ring.release(q + kb - 1);
          }
          K8_MARK(clk, K8_PW2);
        }
        hopper::wgmma_wait<0>();
        hopper::fence_all<N2 / 2>(acc2);
        ring.release(q + nk - 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 16 * ww + g + 8 * h;
          const int jo = j0 + m / F8;
          if (m < L.M2 && jo < T8) {
            const int c = g2 * NG + wg * N2 + 2 * t;
            __nv_bfloat16* dst = ob + ((long long)jo * F8 + m % F8) * C + c;
#pragma unroll
            for (int j = 0; j < N2 / 8; ++j) {
              const float2 bias = *reinterpret_cast<const float2*>(sB + C + c + 8 * j);
              *reinterpret_cast<uint32_t*>(dst + 8 * j) =
                  pack_bf16(act_fast<ACT>(acc2[4 * j + 2 * h] + bias.x),
                            act_fast<ACT>(acc2[4 * j + 2 * h + 1] + bias.y));
            }
          }
        }
      }
    } else {
      q += ngroups * nk;
    }
    K8_MARK(clk, K8_PW2);
    __syncthreads();  // stage 2's operand and the windows free
    K8_MARK(clk, K8_TILE_END);
  }
}

// ---------------------------------------------------------------------------
// fp32 kernel: the same tiling on the CUDA cores
// ---------------------------------------------------------------------------

// Stage 0 for one 32-channel slice: a lane owns a channel and 4 neighbouring
// frequencies, so the 27 inputs it needs come as broadcast vector loads; 9
// FMAs per output.
__device__ __forceinline__ void stage0_simt(const SubParams& p, const Layout& L,
                                            const float* sX, float* sS, int c0, int j0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = c0 + lane, F0 = L.F0, LDX = L.LDX;
  float w[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) w[i] = f32(p.k0, c * 9 + i);
  const float bias = f32(p.b0, c);
  const int groups = F0 / 4;
  for (int item = warp; item < L.R0 * groups; item += NTHREADS / 32) {
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
    float* dst = sS + ((size_t)a * (F0 + 1) + 4 * q + 1) * KS32 + lane;
#pragma unroll
    for (int o = 0; o < 4; ++o) dst[o * KS32] = zero_row ? 0.f : activate(acc[o], p.act);
  }
}

constexpr int MR1 = 32;  // rows of pointwise 1 a thread accumulates: 4 x 32 = 128 positions
constexpr int MR2 = MAX_POS2 / 4;

__global__ void __launch_bounds__(NTHREADS, 1) subsampling_fused_f32(const SubParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout& L = p.L;
  float* sA = reinterpret_cast<float*>(smem_raw + L.off_a);
  float* sX = reinterpret_cast<float*>(smem_raw + L.off_x);
  float* sS = reinterpret_cast<float*>(smem_raw + L.off_s);
  float* sH2 = reinterpret_cast<float*>(smem_raw + L.off_h2);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = tid % NG32, rq = tid / NG32;  // a thread's channel of the group, its rows rq + 4 i
  const int b = blockIdx.y, j0 = blockIdx.x * p.To;
  const int C = p.C, T8 = p.Tin / 8, F = p.F, F0 = L.F0, F1 = L.F1, F8 = L.F8, LDX = L.LDX;
  const float* W1 = static_cast<const float*>(p.kp[0]);  // (C in, C out)
  const float* W2 = static_cast<const float*>(p.kp[1]);

  // ---- the input tile: frames [8 j0 - 7, 8 j0 + 8 To), zero outside [0, T) ----
  {
    const float* xb = static_cast<const float*>(p.x) + (long long)b * p.Tin * F;
    const int t0 = 8 * j0 - 7;
    for (int i = tid; i < L.RX * F; i += NTHREADS) {
      const int r = i / F, col = i % F;
      const int tg = t0 + r;
      sX[r * LDX + col + 1] = (tg >= 0 && tg < p.Tin) ? xb[(long long)tg * F + col] : 0.f;
    }
    for (int r = tid; r < L.RX; r += NTHREADS) sX[r * LDX] = 0.f;  // frequency -1
  }

  // A holds KC input channels of pointwise 1: all C where it fits, built
  // once; else slices of 32 channels, rebuilt for each group
  const int KC = L.KC;
  for (int grp = 0; grp < C / NG32; ++grp) {
    float acc[MR1];
#pragma unroll
    for (int i = 0; i < MR1; ++i) acc[i] = 0.f;
    for (int cb = 0; cb < C; cb += KC) {
      if (KC < C || grp == 0) {
        for (int i = tid; i < L.R0 * KS32; i += NTHREADS)
          sS[(size_t)(i / KS32) * (F0 + 1) * KS32 + i % KS32] = 0.f;
        __syncthreads();
        for (int c0 = cb; c0 < cb + KC; c0 += KS32) {
          stage0_simt(p, L, sX, sS, c0, j0);
          __syncthreads();
          {  // the first depthwise conv: a lane owns a channel of the slice
            const int c = c0 + lane;
            float w[9];
#pragma unroll
            for (int i = 0; i < 9; ++i) w[i] = f32(p.kd[0], c * 9 + i);
            const float bias = f32(p.bd[0], c);
            for (int m = warp; m < L.M1; m += NTHREADS / 32) {
              const int r1 = m / F1, f1 = m % F1;
              const float* src = sS + ((size_t)2 * r1 * (F0 + 1) + 2 * f1) * KS32 + lane;
              float a = bias;
#pragma unroll
              for (int dt = 0; dt < 3; ++dt)
#pragma unroll
                for (int df = 0; df < 3; ++df)
                  a = fmaf(w[dt * 3 + df], src[(dt * (F0 + 1) + df) * KS32], a);
              sA[m * L.LDA + c0 - cb + lane] = a;
            }
          }
          __syncthreads();
        }
      }
      // pointwise 1 over A's channels: the rows of a warp are the same (a
      // broadcast), its lanes read 32 neighbouring output channels
      const float* wk = W1 + (size_t)cb * C + grp * NG32 + n;
      for (int k = 0; k < KC; k += 4) {
        float w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = wk[(size_t)(k + i) * C];
#pragma unroll
        for (int i = 0; i < MR1; ++i) {
          const float4 a =
              *reinterpret_cast<const float4*>(sA + min(rq + 4 * i, L.M1 - 1) * L.LDA + k);
          acc[i] = fmaf(a.x, w[0], acc[i]);
          acc[i] = fmaf(a.y, w[1], acc[i]);
          acc[i] = fmaf(a.z, w[2], acc[i]);
          acc[i] = fmaf(a.w, w[3], acc[i]);
        }
      }
      __syncthreads();
    }
    // the group's epilogue into stage 1's region (frequency -1 zero)
    for (int i = tid; i < L.R1 * NG32; i += NTHREADS)
      sS[(size_t)(i / NG32) * (F1 + 1) * L.LD1 + i % NG32] = 0.f;
    {
      const float bias = f32(p.bp[0], grp * NG32 + n);
#pragma unroll
      for (int i = 0; i < MR1; ++i) {
        const int m = rq + 4 * i;
        if (m < L.M1) {
          const int r1 = m / F1, f1 = m % F1;
          const bool zero_row = 2 * j0 - 1 + r1 < 0;
          sS[((size_t)r1 * (F1 + 1) + f1 + 1) * L.LD1 + n] =
              zero_row ? 0.f : activate(acc[i] + bias, p.act);
        }
      }
    }
    __syncthreads();
    {  // the second depthwise conv on the group's channels
      const int cg = grp * NG32 + n;
      float w[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) w[i] = f32(p.kd[1], cg * 9 + i);
      const float bias = f32(p.bd[1], cg);
      for (int pos = rq; pos < L.M2; pos += NTHREADS / NG32) {
        const int j = pos / F8, f8 = pos % F8;
        const float* src = sS + ((size_t)2 * j * (F1 + 1) + 2 * f8) * L.LD1 + n;
        float a = bias;
#pragma unroll
        for (int dt = 0; dt < 3; ++dt)
#pragma unroll
          for (int df = 0; df < 3; ++df) a = fmaf(w[dt * 3 + df], src[(dt * (F1 + 1) + df) * L.LD1], a);
        sH2[(size_t)pos * L.LDH2 + cg] = a;
      }
    }
    __syncthreads();
  }

  // ---- pointwise 2 + act, straight to the output ----
  float* ob = static_cast<float*>(p.out) + (long long)b * T8 * F8 * C;
  for (int grp = 0; grp < C / NG32; ++grp) {
    float acc[MR2];
#pragma unroll
    for (int i = 0; i < MR2; ++i) acc[i] = 0.f;
    const float* wk = W2 + grp * NG32 + n;
    for (int k = 0; k < C; k += 4) {
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = wk[(size_t)(k + i) * C];
#pragma unroll
      for (int i = 0; i < MR2; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(sH2 + min(rq + 4 * i, L.M2 - 1) * L.LDH2 + k);
        acc[i] = fmaf(a.x, w[0], acc[i]);
        acc[i] = fmaf(a.y, w[1], acc[i]);
        acc[i] = fmaf(a.z, w[2], acc[i]);
        acc[i] = fmaf(a.w, w[3], acc[i]);
      }
    }
    const float bias = f32(p.bp[1], grp * NG32 + n);
#pragma unroll
    for (int i = 0; i < MR2; ++i) {
      const int m = rq + 4 * i;
      const int jo = j0 + m / F8;
      if (m < L.M2 && jo < T8)
        ob[((long long)jo * F8 + m % F8) * C + grp * NG32 + n] = activate(acc[i] + bias, p.act);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// fp32: A whole (KC = C) at the largest tile that fits (or `tile`'s), else
// slices of 32 channels.  False if nothing fits.
bool pick_f32(int tile, int F, int C, int max_smem, int* To, int* KC) {
  for (int kc : {C, KS32})
    for (int to = tile > 0 ? tile : 8; to >= (tile > 0 ? tile : 1); --to)
      if (tile_fits(to, F, C, kc, 0, true, max_smem)) {
        *To = to;
        *KC = kc;
        return true;
      }
  return false;
}

// bf16: A whole (KC = C) at the largest tile that fits (or `tile`'s), with as
// many weight slots as fit; else the widest chunk of A (a multiple of 128
// channels) that fits.  False if nothing does.
bool pick_bf16(int tile, int F, int C, int max_smem, int* To, int* KC, int* NS) {
  for (int kc = C; kc >= 128; kc -= 128)
    for (int to = tile > 0 ? tile : 8; to >= (tile > 0 ? tile : 1); --to)
      for (int ns = MAX_SLOTS; ns >= 2; --ns)
        if (tile_fits(to, F, C, kc, ns, false, max_smem)) {
          *To = to;
          *KC = kc;
          *NS = ns;
          return true;
        }
  return false;
}

template <int ACT>
cudaError_t launch_bf16(SubParams p, int KC, int NS, int sms, cudaStream_t stream) {
  CUtensorMap m1, m2;
  // the (C out, C in) weight as a 4-D (C in, 1, C out, 1) tensor, in boxes of
  // 64 input x 128 output channels
  cudaError_t err = hopper::bthd_map(&m1, p.kp[0], 1, p.C, 1, p.C, (long long)p.C * p.C, p.C,
                                     p.C, NG, KS, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = hopper::bthd_map(&m2, p.kp[1], 1, p.C, 1, p.C, (long long)p.C * p.C, p.C, p.C, NG,
                           KS, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  p.L = make_layout(p.To, p.F, p.C, KC, NS, false);
  const size_t smem = p.L.total + 1024;  // and the alignment of the base to 1024
  err = cudaFuncSetAttribute(subsampling_fused_bf16<ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = p.B * ((p.Tin / 8 + p.To - 1) / p.To);
  subsampling_fused_bf16<ACT><<<n_tiles < sms ? n_tiles : sms, NTHREADS, smem, stream>>>(m1, m2, p);
  return cudaGetLastError();
}

cudaError_t launch_f32(SubParams p, int KC, cudaStream_t stream) {
  p.L = make_layout(p.To, p.F, p.C, KC, 0, true);
  const size_t smem = p.L.total;
  cudaError_t err = cudaFuncSetAttribute(subsampling_fused_f32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tin / 8 + p.To - 1) / p.To, p.B);
  subsampling_fused_f32<<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  `tile` is the number of output
// frames per tile, 0 for the largest that fits.  For fp32 the pointwise
// weights kp1, kp2 come transposed, (C in, C out); for bf16 as the module
// holds them, (C out, C in), 16-byte aligned.
int lcasr_subsampling_fused(const void* x, void* out, const void* k0, const void* b0,
                            const void* kd1, const void* bd1, const void* kp1,
                            const void* bp1, const void* kd2, const void* bd2,
                            const void* kp2, const void* bp2, int B, int T, int F, int C,
                            int is_f32, int act, int tile, void* stream) {
  if (T % 8 || F % 8 || T <= 0 || F <= 0 || B <= 0 || B > 65535 || act < 0 || act > 3 ||
      C % 128 || C <= 0 || C > MAX_C || F > MAX_F || tile < 0)
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
  p.C = C;
  p.act = act;
  int dev = 0, max_smem = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int KC = 0, NS = 0;
  if (is_f32)
    return pick_f32(tile, F, C, max_smem, &p.To, &KC) ? (int)launch_f32(p, KC, s)
                                                      : (int)cudaErrorInvalidValue;
  if (!pick_bf16(tile, F, C, max_smem, &p.To, &KC, &NS)) return (int)cudaErrorInvalidValue;
  switch (act) {
    case ACT_SILU:
      return (int)launch_bf16<ACT_SILU>(p, KC, NS, sms, s);
    case ACT_RELU:
      return (int)launch_bf16<ACT_RELU>(p, KC, NS, sms, s);
    case ACT_GELU:
      return (int)launch_bf16<ACT_GELU>(p, KC, NS, sms, s);
    default:
      return (int)launch_bf16<ACT_NONE>(p, KC, NS, sms, s);
  }
}

#ifdef LCASR_K8_CLOCKS
// The K8_PHASES sums of k8_clocks into `out`, then zero them.
int lcasr_subsampling_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k8_clocks, sizeof(k8_clocks));
  static const unsigned long long zeros[K8_PHASES] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(k8_clocks, zeros, sizeof(k8_clocks));
  return (int)err;
}
#endif

const char* lcasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
