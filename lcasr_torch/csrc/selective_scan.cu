// Selective state-space scan for Hopper (sm_90a): forward (K6) and
// reverse-recurrence backward (K7).
//
//     h_t = exp(delta_t * A) h_{t-1} + delta_t * B_t * x_t      (per channel d,
//     y_t = C_t . h_t                                            state n < N)
//
// N (d_state) is a template parameter of every kernel, built for 16, 32 and
// 64; the wrapper (ops/ssm.py) pads any other N <= 64 up to the next of these
// with zero columns of B and C (a padded state stays 0 and adds 0 to y and to
// every gradient).  The comments below give the sizes at N = 16.
//
// Replaces the Pallas kernels `_scan_kernel` and `_scan_bwd_kernel` of
// lcasr_tpu/ops/ssm.py.  What is kept is the function: the same y, the same
// five gradients, and no (Bt, L, D, N) tensor in device memory.  The TPU
// kernels' 16-row groups, transposes and 512-frame grid steps are not.
//
// K6 replaces `_scan_kernel` (lcasr_tpu/ops/ssm.py:78), which carries h in
// VMEM across sequential grid steps over L.  CUDA blocks run in parallel and
// in no order, and rows x channels alone do not fill 132 SMs at every shape
// the Mamba family runs (2 x 768 channels at the 120,000-frame step: the
// first port, one thread per (row, channel) walking the whole sequence, ran
// 12 blocks there).  So the time axis is cut into S segments of whole 32-step
// chunks, S a function of (Bt, L, D) alone that the wrapper computes
// (`fwd_segments` in ops/ssm.py), and h's linearity joins them: a segment's
// exit = its exit from a zero entry + exp(A sum delta) * its entry.
//   1. `selective_scan_fwd_local` (S > 1): segments 0 .. S - 2 from a zero
//      entry; each writes its exit and its sum of delta.  Segment 0's entry
//      is the true one, so it writes its y and states here as well;
//   2. `selective_scan_fwd_body`: segments 1 .. S - 1 (segment 0 when S is
//      1).  Each folds the exits of the segments before it into its true
//      entry (the carry pass, per (row, channel, state), done by the block
//      that needs it: s exps per state against the segment's L / S, and no
//      launch or round trip of its own), then runs its segment writing y and
//      the chunk-entry states.
// A split spends a second exp per (t, d, n) on segments 1 .. S - 2, so S is 1
// where rows x channels fill the card (the decode's 32 x 768).  Two threads
// own one (row, channel), 8 states each, and finish y's sum over states with
// one shuffle: 1/8 shuffle per (t, d, n), and twice the warps of one thread
// a channel.  64 channels (128 threads) a block.  A chunk's x, delta (as
// [t][channel]) and B, C (as [t][n], fp32) are double-buffered in shared
// memory, and the next chunk's loads are in flight while the current chunk
// computes: x and delta by 16-byte `cp.async` copies (plain loads where a
// row is not 16-byte aligned), B and C (16 values a step, bf16 or fp32) by
// loads into registers that are converted and stored once the chunk is
// done, so the inner loop reads fp32 and unpacks nothing.  B and C are read
// through their strides, so the mixer's slices of its x_proj output are not
// copied.  The choice of S
// depends on the shape only, so y is the same bits with and without the
// states, and there are no atomics: the same bits each run.
//
// K7 replaces `_scan_bwd_kernel` (lcasr_tpu/ops/ssm.py:177), which carries the
// adjoint lambda backward across sequential grid steps in VMEM.  CUDA blocks
// run in parallel and in no order, so the time axis is split.  lambda follows
// a linear recurrence, lambda_t = C_t g_t + a_{t+1} lambda_{t+1}: a chunk's
// lambda is its local lambda (as if nothing followed the chunk) plus its chain
// of gains times the carry from the chunks after it.  Three passes, each
// parallel over rows, channels and chunks but the second:
//   1. `selective_scan_bwd_local`: each chunk's carry out from a zero carry
//      in, and its sum of delta (its gain is exp(A sum delta));
//   2. `selective_scan_bwd_carry`: per (row, state, channel), the chunks
//      backward: carry_in(c) = local(c + 1) + gain(c + 1) carry_in(c + 1);
//   3. `selective_scan_bwd_chunk`: today's chunk body from the true carry:
//      the chunk's states recomputed forward from K6's entry state, then the
//      reverse sweep writing dx, ddelta and partials of dB, dC and dA;
// then two reductions in a fixed order.  The recurrence is never inverted,
// and there are no atomics: the five gradients are the same bits each run.
// Passes 1 and 3 take one (channel, state) pair a thread, 512 threads over
// 32 channels at a time, 128 channels a block (one partial of dB and dC per
// 128 channels), so a thread holds its chunk's 33 states in registers (no
// shared-memory history) and the grid at (8, 2048, 768, 16) is 6 x 64 x 8
// = 3,072 blocks (at (2, 15000, 768, 16), 5,628).  Pass 3 reads its inputs
// as [channel][t] rows, four steps a 16-byte load.  Every 8 steps its reverse
// sweep hands its sums to shared memory: the 16 states' (lam B, lam a h A)
// pairs of each (step, channel), which half the threads then sum in a fixed
// order into dx and ddelta, and the dB / dC values of each warp's two
// channels (one shuffle), which the other half sum over the warps.  It is
// held to 64 registers so that two of its 512-thread blocks (76 KB of
// shared memory each) share an SM; ptxas then spills 152 bytes, and that
// measured 3.5% faster than one block without a spill.  Against the first
// version (scalar loads, the sums over states by shuffles, one block an SM)
// these took 30% off pass 3 and 24% off K7
// (scripts/scan_bwd_experiments.py variants and time, PERF.md).
//
// Memory latency.  K7's chunk loads (x, delta, g, B, C, the entry state) are
// all loaded into registers before the first of them is stored to shared
// memory: a load-then-store pair per element serialises on the latency and
// took the first versions of these kernels 2-3x as long.  K6 keeps the next
// chunk's loads in flight while it computes (below).
//
// Bound.  The function needs one exp per (t, d, n), forward and backward, on
// the special-function units (16 per clock per SM).  K7 at (8, 2048, 768, 16)
// moves 0.28 GB at least, 0.0836 ms at 3.35 TB/s: the bytes bound it.  This
// design reads delta and g twice and spends three exps per (t, d, n) (pass 1,
// the recompute, the sweep): 0.60 G exps, about 0.15 ms at the special-
// function units, so they, not the bytes, set its floor.  See PERF.md.  All
// arithmetic and the state are fp32; x, delta and A are fp32 (the wrapper
// casts; the mixer's x is fp32 already), B and C bf16 or fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TC = 32;            // steps per chunk = interval of saved states
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
__device__ __forceinline__ float ldf(const T* p);
template <>
__device__ __forceinline__ float ldf<float>(const float* p) {
  return *p;
}
template <>
__device__ __forceinline__ float ldf<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// 2^v on the special-function unit (v <= 0 here; results below 2^-126 flush
// to 0, which is what the recurrence's gain then is to fp32 anyway).
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

struct ScanParams {
  const float* x;      // (Bt, L, D), unit stride on D
  const float* delta;  // (Bt, L, D), unit stride on D
  const float* A;      // (D, N) contiguous
  const void* B;       // (Bt, L, N), unit stride on N
  const void* C;       // (Bt, L, N), unit stride on N
  int L, D, n_chunks;
  long long sx_b, sx_l, sd_b, sd_l, sB_b, sB_l, sC_b, sC_l;
  // K6: every row of x / delta starts 16-byte aligned (cp.async copies)
  bool vec_x, vec_delta;
};

// Stage B and C of steps [t0, t0 + len) of batch row b into shared memory as
// fp32; rows past len are zero.  Every load comes before the first store,
// so one round trip to memory covers them all.
template <int N, typename BT, int THREADS>
__device__ __forceinline__ void stage_bc(const ScanParams& p, int b, int t0,
                                         int len, float (*Bs)[N],
                                         float (*Cs)[N]) {
  constexpr int PER = TC * N / THREADS;
  const BT* Bp = static_cast<const BT*>(p.B) + (long long)b * p.sB_b;
  const BT* Cp = static_cast<const BT*>(p.C) + (long long)b * p.sC_b;
  float bv[PER], cv[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int t = i / N, n = i % N;
    const bool ok = t < len;
    bv[j] = ok ? ldf(Bp + (long long)(t0 + t) * p.sB_l + n) : 0.f;
    cv[j] = ok ? ldf(Cp + (long long)(t0 + t) * p.sC_l + n) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * THREADS;
    Bs[i / N][i % N] = bv[j];
    Cs[i / N][i % N] = cv[j];
  }
}

// ---------------------------------------------------------------------------
// K6: forward, parallel over rows, channels and segments of time.  Two
// launches (one when S is 1), grid (ceil(D / 64), S - 1 or 1, Bt) each, 8N
// threads (128 at N = 16): threads 2j and 2j + 1 hold states 0-7 and 8-15 of
// channel j; at any N, N / 8 threads a channel hold 8 states each, so a
// thread's registers are the same at every N and a block grows with N.
// Bound: one exp per (t, d, n) on the special-function units (16 per clock
// per SM): 0.193 ms at (32, 2048, 768, 16), where the bytes take 0.18 ms.
// Registers decide how many blocks share an SM.  A first build staged with
// unrolled plain-load fallbacks and per-copy 64-bit addresses, which the
// compiler hoisted out of the chunk loop: 229-247 registers, two blocks an
// SM, and capping them spilled.  The fallback is now a rolled loop, each
// copy an offset from one pointer a chunk, and the inner loop reads fp32 B
// and C: 112-124 registers, no spill, all 384 decode blocks resident
// (PERF.md, scripts/scan_fwd_experiments.py).
// ---------------------------------------------------------------------------
constexpr int FWD_CH = 64;  // channels a block
constexpr int FWD_NS = 8;   // states a thread

template <int N>
struct Fwd {
  static_assert(N % FWD_NS == 0 && N <= 64, "N / 8 threads a channel");
  static constexpr int LANES = N / FWD_NS;         // threads a channel
  static constexpr int THREADS = FWD_CH * LANES;   // 128 at N = 16
  static constexpr int BC_PER = TC * N / THREADS;  // 4: B, C values a thread
};

struct FwdBuffers {
  float* y;       // (Bt, L, D)
  float* states;  // null, or (Bt, n_chunks, N, D): the state at each chunk's entry
  float* exits;   // (Bt, segments - 1, N, D): a segment's exit from a zero entry
  float* dsum;    // (Bt, segments - 1, D): a segment's sum of delta
  int segments, seg_chunks;
};

// Two chunk buffers: x, delta as [t][channel], B, C as [t][n], all fp32.  In
// dynamic shared memory: 40 KB at N = 16, 64 KB at N = 64.
template <int N>
struct FwdSmem {
  __align__(16) float xs[2][TC][FWD_CH];
  __align__(16) float ds[2][TC][FWD_CH];
  __align__(16) float Bs[2][TC][N];
  __align__(16) float Cs[2][TC][N];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // copies `bytes` (0-16) and fills the rest of the 16 with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Steps [t0, t0 + TC) of channels [d0, d0 + FWD_CH) of one row of an
// (L, D)-strided fp32 tensor into dst[TC][FWD_CH]; zeros past len steps and
// past D.  `vec`: the rows are 16-byte aligned, so 16-byte cp.async copies,
// TC / R a thread (rows r, r + R, ... of the chunk, columns 4q .. 4q + 3);
// else one plain load and store at a time, a loop the compiler keeps rolled,
// so that the rare path holds no registers of its own across the chunk loop.
template <int THREADS>
__device__ __forceinline__ void stage_rows(const float* row0, long long sl, bool vec, int t0,
                                           int len, int d0, int D, float (*dst)[FWD_CH]) {
  constexpr int Q = FWD_CH / 4, R = THREADS / Q;
  static_assert(TC % R == 0, "whole copies a thread");
  const float* base = row0 + t0 * sl + d0;
  if (vec) {
    const int r = threadIdx.x / Q, q = threadIdx.x % Q;
    const int cols = 4 * max(0, min(4, D - d0 - 4 * q));
    const float* src = base + r * sl + 4 * q;
#pragma unroll
    for (int k = 0; k < TC / R; ++k) {
      const int t = r + k * R, bytes = t < len ? cols : 0;
      cp_async16(&dst[t][4 * q], bytes ? src + k * R * sl : row0, bytes);
    }
    return;
  }
#pragma unroll 1
  for (int i = threadIdx.x; i < TC * FWD_CH; i += THREADS) {
    const int t = i / FWD_CH, j = i % FWD_CH;
    dst[t][j] = t < len && d0 + j < D ? base[t * sl + j] : 0.f;
  }
}

// B and C of chunk c of row b as fp32 in registers, zeros past L: BC_PER (4)
// values of each a thread, loads only; `store_bc` puts them in shared memory
// once the chunk before has been computed.
template <int N, typename BT>
__device__ __forceinline__ void load_bc(const ScanParams& p, int b, int c,
                                        float (&bv)[Fwd<N>::BC_PER],
                                        float (&cv)[Fwd<N>::BC_PER]) {
  constexpr int R = Fwd<N>::THREADS / N;  // steps a pass: thread i loads steps r + R k
  const int t0 = c * TC, len = min(TC, p.L - t0), r = threadIdx.x / N, n = threadIdx.x % N;
  const BT* Bp = static_cast<const BT*>(p.B) + b * p.sB_b + (t0 + r) * p.sB_l + n;
  const BT* Cp = static_cast<const BT*>(p.C) + b * p.sC_b + (t0 + r) * p.sC_l + n;
#pragma unroll
  for (int k = 0; k < Fwd<N>::BC_PER; ++k) {
    const bool ok = r + k * R < len;
    bv[k] = ok ? ldf(Bp + k * R * p.sB_l) : 0.f;
    cv[k] = ok ? ldf(Cp + k * R * p.sC_l) : 0.f;
  }
}

template <int N>
__device__ __forceinline__ void store_bc(const float (&bv)[Fwd<N>::BC_PER],
                                         const float (&cv)[Fwd<N>::BC_PER], float (*Bs)[N],
                                         float (*Cs)[N]) {
  constexpr int R = Fwd<N>::THREADS / N;
  const int r = threadIdx.x / N, n = threadIdx.x % N;
#pragma unroll
  for (int k = 0; k < Fwd<N>::BC_PER; ++k) {
    Bs[r + k * R][n] = bv[k];
    Cs[r + k * R][n] = cv[k];
  }
}

// Start the copies of x and delta of chunk c of row b, channel block d0, into
// buffer buf.
template <int N>
__device__ __forceinline__ void stage_xd(const ScanParams& p, int b, int d0, int c, int buf,
                                         FwdSmem<N>& s) {
  const int t0 = c * TC, len = min(TC, p.L - t0);
  stage_rows<Fwd<N>::THREADS>(p.x + b * p.sx_b, p.sx_l, p.vec_x, t0, len, d0, p.D, s.xs[buf]);
  stage_rows<Fwd<N>::THREADS>(p.delta + b * p.sd_b, p.sd_l, p.vec_delta, t0, len, d0, p.D,
                              s.ds[buf]);
  cp_async_commit();
}

// Chunk c0 into buffer 0: x and delta in flight, B and C stored.
template <int N, typename BT>
__device__ __forceinline__ void stage_first(const ScanParams& p, int b, int d0, int c0,
                                            FwdSmem<N>& s) {
  stage_xd<N>(p, b, d0, c0, 0, s);
  float bv[Fwd<N>::BC_PER], cv[Fwd<N>::BC_PER];
  load_bc<N, BT>(p, b, c0, bv, cv);
  store_bc<N>(bv, cv, s.Bs[0], s.Cs[0]);
}

// This thread's 8 of a step's N values of B or C, from shared memory.
__device__ __forceinline__ void lds_half(const float* row, float (&o)[FWD_NS]) {
  const float4 a = reinterpret_cast<const float4*>(row)[0];
  const float4 c = reinterpret_cast<const float4*>(row)[1];
  o[0] = a.x, o[1] = a.y, o[2] = a.z, o[3] = a.w, o[4] = c.x, o[5] = c.y, o[6] = c.z, o[7] = c.w;
}

// Chunks [c0, c1) of row b over channels [d0, d0 + 64) from the entry state
// in h; h leaves as the exit.  Chunk c0 must be staged (`stage_first`).  OUT:
// write y and (STATES) the state at each chunk's entry.  Returns this
// thread's sum of delta over the segment.
template <int N, typename BT, bool OUT, bool STATES>
__device__ __forceinline__ float run_segment(const ScanParams& p, const FwdBuffers& w, int b,
                                             int d0, int c0, int c1, const float (&A2)[FWD_NS],
                                             float (&h)[FWD_NS], FwdSmem<N>& s) {
  constexpr int LANES = Fwd<N>::LANES;
  const int j = threadIdx.x / LANES, half = threadIdx.x % LANES;
  const int d = d0 + j;
  const bool live = d < p.D;
  float dsum = 0.f;
  for (int c = c0; c < c1; ++c) {
    const int buf = (c - c0) & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk c has landed everywhere, and chunk c - 1 is read
    // the next chunk's loads are in flight while this one computes: x and
    // delta by cp.async, B and C into registers
    float bv[Fwd<N>::BC_PER], cv[Fwd<N>::BC_PER];
    if (c + 1 < c1) {
      stage_xd<N>(p, b, d0, c + 1, buf ^ 1, s);
      load_bc<N, BT>(p, b, c + 1, bv, cv);
    }
    if (STATES && live) {
      float* sp = w.states + (((long long)b * p.n_chunks + c) * N + half * FWD_NS) * p.D + d;
#pragma unroll
      for (int k = 0; k < FWD_NS; ++k) sp[(long long)k * p.D] = h[k];
    }
    const int t0 = c * TC, len = min(TC, p.L - t0);
    float* yp = w.y + ((long long)b * p.L + t0) * p.D + d;
    // past len delta, x and B are 0: a step leaves h as it is
#pragma unroll 4
    for (int t = 0; t < TC; ++t) {
      const float dt = s.ds[buf][t][j];
      const float dtx = dt * s.xs[buf][t][j];
      float Bv[FWD_NS], Cv[FWD_NS];
      lds_half(&s.Bs[buf][t][half * FWD_NS], Bv);
      if (OUT) lds_half(&s.Cs[buf][t][half * FWD_NS], Cv);
      dsum += dt;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < FWD_NS; ++k) {
        h[k] = ex2(dt * A2[k]) * h[k] + dtx * Bv[k];
        if (OUT) acc += h[k] * Cv[k];
      }
      if (OUT) {
        // the channel's other states, from its other N / 8 - 1 threads
#pragma unroll
        for (int o = 1; o < LANES; o <<= 1) acc += __shfl_xor_sync(FULL, acc, o);
        if (half == 0 && live && t < len) yp[(long long)t * p.D] = acc;
      }
    }
    // every thread is past this chunk's barrier, so done with buffer buf ^ 1
    if (c + 1 < c1) store_bc<N>(bv, cv, s.Bs[buf ^ 1], s.Cs[buf ^ 1]);
  }
  return dsum;
}

template <int N>
__device__ __forceinline__ void load_a2(const ScanParams& p, int d0, float (&A2)[FWD_NS]) {
  const int d = d0 + threadIdx.x / Fwd<N>::LANES, half = threadIdx.x % Fwd<N>::LANES;
#pragma unroll
  for (int k = 0; k < FWD_NS; ++k)
    A2[k] = d < p.D ? p.A[(long long)d * N + half * FWD_NS + k] * LOG2E : 0.f;
}

// Pass 1: segments 0 .. S - 2 from a zero entry; grid (channel blocks, S - 1, Bt).
template <int N, typename BT, bool STATES>
__global__ void __launch_bounds__(Fwd<N>::THREADS)
selective_scan_fwd_local(ScanParams p, FwdBuffers w) {
  extern __shared__ __align__(16) float fwd_smem[];
  FwdSmem<N>& s = *reinterpret_cast<FwdSmem<N>*>(fwd_smem);
  const int d0 = blockIdx.x * FWD_CH, seg = blockIdx.y, b = blockIdx.z;
  const int c0 = seg * w.seg_chunks, c1 = min(p.n_chunks, c0 + w.seg_chunks);
  stage_first<N, BT>(p, b, d0, c0, s);
  float A2[FWD_NS], h[FWD_NS];
  load_a2<N>(p, d0, A2);
#pragma unroll
  for (int k = 0; k < FWD_NS; ++k) h[k] = 0.f;
  // segment 0's zero entry is its true entry: its outputs are final
  const float dsum = seg == 0
                         ? run_segment<N, BT, true, STATES>(p, w, b, d0, c0, c1, A2, h, s)
                         : run_segment<N, BT, false, false>(p, w, b, d0, c0, c1, A2, h, s);
  const int d = d0 + threadIdx.x / Fwd<N>::LANES, half = threadIdx.x % Fwd<N>::LANES;
  if (d < p.D) {
    const long long bs = (long long)b * (w.segments - 1) + seg;
    float* ep = w.exits + (bs * N + half * FWD_NS) * p.D + d;
#pragma unroll
    for (int k = 0; k < FWD_NS; ++k) ep[(long long)k * p.D] = h[k];
    if (half == 0) w.dsum[bs * p.D + d] = dsum;
  }
}

// Pass 2: segments 1 .. S - 1 (segment 0 when S is 1) from their true
// entries; grid (channel blocks, max(S - 1, 1), Bt).
template <int N, typename BT, bool STATES>
__global__ void __launch_bounds__(Fwd<N>::THREADS)
selective_scan_fwd_body(ScanParams p, FwdBuffers w) {
  extern __shared__ __align__(16) float fwd_smem[];
  FwdSmem<N>& s = *reinterpret_cast<FwdSmem<N>*>(fwd_smem);
  const int d0 = blockIdx.x * FWD_CH, seg = blockIdx.y + (w.segments > 1), b = blockIdx.z;
  const int c0 = seg * w.seg_chunks, c1 = min(p.n_chunks, c0 + w.seg_chunks);
  stage_first<N, BT>(p, b, d0, c0, s);  // x and delta in flight during the fold
  float A2[FWD_NS], h[FWD_NS];
  load_a2<N>(p, d0, A2);
#pragma unroll
  for (int k = 0; k < FWD_NS; ++k) h[k] = 0.f;
  // the true entry: entry(i + 1) = exit0(i) + exp(A sum delta(i)) entry(i)
  const int d = d0 + threadIdx.x / Fwd<N>::LANES, half = threadIdx.x % Fwd<N>::LANES;
  if (d < p.D) {
    for (int i = 0; i < seg; ++i) {
      const long long bs = (long long)b * (w.segments - 1) + i;
      const float g = w.dsum[bs * p.D + d];
      const float* ep = w.exits + (bs * N + half * FWD_NS) * p.D + d;
#pragma unroll
      for (int k = 0; k < FWD_NS; ++k) h[k] = ep[(long long)k * p.D] + ex2(A2[k] * g) * h[k];
    }
  }
  run_segment<N, BT, true, STATES>(p, w, b, d0, c0, c1, A2, h, s);
}

// ---------------------------------------------------------------------------
// K7: backward, parallel over rows, channels and chunks.  Five launches:
//   selective_scan_bwd_local  each chunk's adjoint from a zero carry;
//   selective_scan_bwd_carry  every chunk's true incoming carry, in place;
//   selective_scan_bwd_chunk  each chunk's gradients from its true carry;
//   selective_scan_bwd_reduce_bc / _reduce_da  the sums over channel groups
//                             and over (row, chunk) of dB, dC and dA.
// The chunk kernels take one (channel, state) pair a thread: 512 threads over
// Bwd<N>::CH = 512 / N channels (32 at N = 16, 8 at N = 64), and walk a
// block's BWD_GROUP channels in BWD_GROUP / CH passes.  Thread i holds state
// i % N of channel i / N: at N = 16, lanes 0-15 of a warp are the 16 states
// of one channel, lanes 16-31 those of the next.
// ---------------------------------------------------------------------------
constexpr int BWD_THREADS = 512;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int BWD_GROUP = 128;  // channels a block: one partial of dB, dC
// a chunk's per-channel (and per-state) inputs lie in shared memory as
// [channel][t] rows of TCP floats, so a thread reads four steps with one
// 16-byte load; the 4 floats of padding spread the rows over the banks
constexpr int TCP = TC + 4;

template <int N>
struct Bwd {
  static_assert(N >= 16 && N <= 64 && BWD_THREADS % N == 0, "N in {16, 32, 64}");
  static constexpr int CH = BWD_THREADS / N;        // channels a pass of a block
  static constexpr int PASSES = BWD_GROUP / CH;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

struct BwdBuffers {
  const float* g;       // (Bt, L, D) contiguous
  const float* states;  // (Bt, n_chunks, N, D): the state at each chunk's entry
  float* dx;            // (Bt, L, D)
  float* ddelta;        // (Bt, L, D)
  float* dB;            // (Bt, L, N)
  float* dC;            // (Bt, L, N)
  float* dA;            // (D, N)
  // workspace
  float* carry;    // (Bt, n_chunks, N, D): local adjoint out, then true carry in
  float* dsum;     // (Bt, n_chunks, D): sum of delta over the chunk
  float* dB_part;  // (Bt, groups, L, N)
  float* dC_part;  // (Bt, groups, L, N)
  float* dA_part;  // (Bt * n_chunks, D, N)
  int groups;
};

// This pass's x (X), delta and g of the chunk, as [channel][t] with zeros
// past the chunk's length and past D: all loads (coalesced over channels),
// then all stores.
template <int N, bool X>
__device__ __forceinline__ void stage_chunk(const ScanParams& p, const float* g,
                                            int b, int t0, int len, int ch0,
                                            float (*xs)[TCP], float (*ds)[TCP],
                                            float (*gs)[TCP]) {
  constexpr int CH = Bwd<N>::CH, ELEMS = TC * CH;
  constexpr int PER = (ELEMS + BWD_THREADS - 1) / BWD_THREADS;
  constexpr bool EVEN = ELEMS % BWD_THREADS == 0;  // every thread has PER elements
  float xr[PER], dr[PER], gr[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * BWD_THREADS;
    const int t = i / CH, d = ch0 + i % CH;
    const bool ok = (EVEN || i < ELEMS) && t < len && d < p.D;
    const long long tt = t0 + t;
    xr[k] = (X && ok) ? p.x[(long long)b * p.sx_b + tt * p.sx_l + d] : 0.f;
    dr[k] = ok ? p.delta[(long long)b * p.sd_b + tt * p.sd_l + d] : 0.f;
    gr[k] = ok ? g[((long long)b * p.L + tt) * p.D + d] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * BWD_THREADS;
    if (!EVEN && i >= ELEMS) break;
    if (X) xs[i % CH][i / CH] = xr[k];
    ds[i % CH][i / CH] = dr[k];
    gs[i % CH][i / CH] = gr[k];
  }
}

// A (N, CH + 1) slice [n][channel] of a (Bt, n_chunks, N, D) tensor at
// chunk (b, c), zeros past D (one load a thread).
template <int N>
__device__ __forceinline__ float load_state_slice(const float* src, const ScanParams& p,
                                                  int b, int c, int ch0) {
  constexpr int CH = Bwd<N>::CH;
  const int n = threadIdx.x / CH, d = ch0 + threadIdx.x % CH;
  return d < p.D ? src[(((long long)b * p.n_chunks + c) * N + n) * p.D + d] : 0.f;
}

// Pass 1: lambda from a zero carry over the chunk, backward; writes the carry
// the chunk would hand to the one before it, a_{t0} lambda_{t0}, and the
// chunk's sum of delta (its gain is exp(A sum delta)).  grid (groups,
// n_chunks, Bt).  Needs delta, g and C only.
template <int N, typename BT>
__global__ void __launch_bounds__(BWD_THREADS)
selective_scan_bwd_local(ScanParams p, BwdBuffers w) {
  constexpr int CH = Bwd<N>::CH;
  __shared__ __align__(16) float ds[CH][TCP];
  __shared__ __align__(16) float gs[CH][TCP];
  __shared__ __align__(16) float Bs[TC][N];  // unused here: stage_bc fills both
  __shared__ __align__(16) float Cs[TC][N];
  __shared__ float out[N][CH + 1];
  __shared__ float sums[CH];
  const int grp = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int t0 = c * TC, len = min(TC, p.L - t0);
  const int n = threadIdx.x % N, dl = threadIdx.x / N;
  stage_bc<N, BT, BWD_THREADS>(p, b, t0, len, Bs, Cs);
  for (int pass = 0; pass < Bwd<N>::PASSES; ++pass) {
    const int ch0 = grp * BWD_GROUP + pass * CH;
    if (ch0 >= p.D) break;  // the same for every thread of the block
    stage_chunk<N, false>(p, w.g, b, t0, len, ch0, nullptr, ds, gs);
    __syncthreads();
    const int d = ch0 + dl;
    const float A2 = d < p.D ? p.A[(long long)d * N + n] * LOG2E : 0.f;
    float carry = 0.f;  // past the length delta and g are 0: no-op steps
#pragma unroll
    for (int t = TC - 1; t >= 0; --t) {
      const float lam = carry + Cs[t][n] * gs[dl][t];
      carry = ex2(ds[dl][t] * A2) * lam;
    }
    out[n][dl] = carry;
    if (threadIdx.x < CH) {
      float s = 0.f;
      for (int t = 0; t < TC; ++t) s += ds[threadIdx.x][t];
      sums[threadIdx.x] = s;
    }
    __syncthreads();
    {
      const int nn = threadIdx.x / CH, j = threadIdx.x % CH, dd = ch0 + j;
      if (dd < p.D) {
        w.carry[(((long long)b * p.n_chunks + c) * N + nn) * p.D + dd] = out[nn][j];
        if (nn == 0) w.dsum[((long long)b * p.n_chunks + c) * p.D + dd] = sums[j];
      }
    }
  }
}

// Pass 2: for each (row, state, channel), walk the chunks backward and turn
// the local carries into true ones, in place:
//   carry_in(c) = local(c + 1) + gain(c + 1) carry_in(c + 1),  carry_in(last) = 0.
// Loads come in batches of CB chunks ahead of the dependent chain.
template <int N>
__global__ void __launch_bounds__(256)
selective_scan_bwd_carry(ScanParams p, BwdBuffers w, int Bt) {
  constexpr int CB = 8;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= (long long)Bt * N * p.D) return;
  const int d = (int)(i % p.D), n = (int)(i / p.D % N), b = (int)(i / ((long long)N * p.D));
  const float A2 = p.A[(long long)d * N + n] * LOG2E;
  float* col = w.carry + (long long)b * p.n_chunks * N * p.D + (long long)n * p.D + d;
  const float* sum = w.dsum + (long long)b * p.n_chunks * p.D + d;
  const long long cstride = (long long)N * p.D;
  float v = 0.f;
  for (int c1 = p.n_chunks - 1; c1 >= 0; c1 -= CB) {
    float o[CB], s[CB];
#pragma unroll
    for (int k = 0; k < CB; ++k) {
      const int c = c1 - k;
      o[k] = c >= 0 ? col[c * cstride] : 0.f;
      s[k] = c >= 0 ? sum[(long long)c * p.D] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < CB; ++k) {
      const int c = c1 - k;
      if (c >= 0) {
        col[c * cstride] = v;
        v = o[k] + ex2(A2 * s[k]) * v;
      }
    }
  }
}

// Pass 3: the chunk's gradients from its true carry: its states recomputed
// forward from K6's entry state into registers (hist), then the reverse
// sweep.  grid (groups, n_chunks, Bt).  The reverse sweep hands its sums to
// shared memory every SEG steps: per (step, channel) the N states' (lam B,
// lam a h_{t-1} A) pairs, rows of RED floats (padded so that 16-byte reads of
// neighbouring rows miss each other's banks), which the first SEG x CH
// threads sum in a fixed order into dx and ddelta; and the dB / dC values,
// which the last 256 threads sum over the pass's channels in a fixed order.
// At N = 16 a warp holds two channels, whose dB / dC values are first added
// by one shuffle, so `part` holds one value per (step, warp, lane); at
// N >= 32 `part` holds every (step, dB or dC, channel, state) value.  dA is
// one partial per (row, chunk).
constexpr int SEG = 8;
constexpr int BWD_SUMMERS = BWD_THREADS / 2;  // threads that sum dB and dC

template <int N>
struct BwdChunk {
  static constexpr int CH = Bwd<N>::CH;
  static constexpr int RED = 2 * N + 4;
  static constexpr int PART = N == 16 ? SEG * BWD_WARPS * 32 : SEG * 2 * BWD_THREADS;
  static constexpr int OUT_PER = SEG * 2 * N / BWD_SUMMERS;  // dB / dC values a summer
  static constexpr int SMEM_FLOATS =
      3 * CH * TCP + 2 * N * TCP + 2 * N * (CH + 1) + SEG * CH * RED + PART;
  static_assert(SEG * CH <= BWD_SUMMERS, "the dx summers and the dB summers are apart");
};

// B and C of steps [t0, t0 + len) as [n][t] (zeros past len): TC / CH loads
// each a thread, then the stores.
template <int N, typename BT>
__device__ __forceinline__ void stage_bc_t(const ScanParams& p, int b, int t0, int len,
                                           float (*Bs)[TCP], float (*Cs)[TCP]) {
  constexpr int PER = TC * N / BWD_THREADS;
  const BT* Bp = static_cast<const BT*>(p.B) + (long long)b * p.sB_b;
  const BT* Cp = static_cast<const BT*>(p.C) + (long long)b * p.sC_b;
  float bv[PER], cv[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * BWD_THREADS;
    const int t = i / N, n = i % N;
    const bool ok = t < len;
    bv[k] = ok ? ldf(Bp + (long long)(t0 + t) * p.sB_l + n) : 0.f;
    cv[k] = ok ? ldf(Cp + (long long)(t0 + t) * p.sC_l + n) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * BWD_THREADS;
    Bs[i % N][i / N] = bv[k];
    Cs[i % N][i / N] = cv[k];
  }
}

template <int N, typename BT>
__global__ void __launch_bounds__(BWD_THREADS, 2)
selective_scan_bwd_chunk(ScanParams p, BwdBuffers w) {
  using K = BwdChunk<N>;
  constexpr int CH = K::CH, RED = K::RED;
  extern __shared__ __align__(16) float smem[];
  float (*xs)[TCP] = reinterpret_cast<float (*)[TCP]>(smem);
  float (*ds)[TCP] = xs + CH;
  float (*gs)[TCP] = ds + CH;
  float (*Bs)[TCP] = gs + CH;
  float (*Cs)[TCP] = Bs + N;
  float (*hs)[CH + 1] = reinterpret_cast<float (*)[CH + 1]>(Cs + N);
  float (*cs)[CH + 1] = hs + N;
  float (*red)[CH][RED] = reinterpret_cast<float (*)[CH][RED]>(cs + N);
  float* part = reinterpret_cast<float*>(red + SEG);

  const int grp = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int t0 = c * TC, len = min(TC, p.L - t0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = threadIdx.x % N, dl = threadIdx.x / N;
  stage_bc_t<N, BT>(p, b, t0, len, Bs, Cs);
  // threads BWD_SUMMERS .. sum the dB / dC values of OUT_PER (step in the
  // segment, dB or dC, state) triples; acc[sg][k] is that sum for segment sg
  float acc[TC / SEG][K::OUT_PER] = {};

  for (int pass = 0; pass < Bwd<N>::PASSES; ++pass) {
    const int ch0 = grp * BWD_GROUP + pass * CH;
    if (ch0 >= p.D) break;  // the same for every thread of the block
    {
      const float hv = load_state_slice<N>(w.states, p, b, c, ch0);
      const float cv = load_state_slice<N>(w.carry, p, b, c, ch0);
      stage_chunk<N, true>(p, w.g, b, t0, len, ch0, xs, ds, gs);
      hs[threadIdx.x / CH][threadIdx.x % CH] = hv;
      cs[threadIdx.x / CH][threadIdx.x % CH] = cv;
    }
    __syncthreads();
    const int d = ch0 + dl;
    const bool live = d < p.D;
    const float A2 = live ? p.A[(long long)d * N + n] * LOG2E : 0.f;

    // hist[t] = h_{t0 + t - 1}: the entry state, then after every step (past
    // the length delta and x are 0 and a step leaves h as it is)
    float hist[TC + 1];
    hist[0] = hs[n][dl];
#pragma unroll
    for (int t4 = 0; t4 < TC; t4 += 4) {
      const float4 d4 = ld4(&ds[dl][t4]), x4 = ld4(&xs[dl][t4]), b4 = ld4(&Bs[n][t4]);
      const float dv[4] = {d4.x, d4.y, d4.z, d4.w}, xv[4] = {x4.x, x4.y, x4.z, x4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        hist[t4 + e + 1] = ex2(dv[e] * A2) * hist[t4 + e] + dv[e] * xv[e] * bv[e];
    }

    float carry = cs[n][dl];  // a_{t+1} lambda_{t+1} from the chunks after
    float dA = 0.f;
#pragma unroll
    for (int sg = TC / SEG - 1; sg >= 0; --sg) {
#pragma unroll
      for (int t4 = sg * SEG + SEG - 4; t4 >= sg * SEG; t4 -= 4) {
        const float4 d4 = ld4(&ds[dl][t4]), x4 = ld4(&xs[dl][t4]), g4 = ld4(&gs[dl][t4]);
        const float4 b4 = ld4(&Bs[n][t4]), c4 = ld4(&Cs[n][t4]);
        const float dv[4] = {d4.x, d4.y, d4.z, d4.w}, xv[4] = {x4.x, x4.y, x4.z, x4.w};
        const float gv[4] = {g4.x, g4.y, g4.z, g4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int e = 3; e >= 0; --e) {
          const int t = t4 + e, tl = t - sg * SEG;
          const float a = ex2(dv[e] * A2);
          const float lam = carry + cv[e] * gv[e];
          const float gain = lam * a * hist[t];
          dA += gain * dv[e];
          carry = lam * a;
          *reinterpret_cast<float2*>(&red[tl][dl][2 * n]) = make_float2(lam * bv[e], gain * A2);
          const float vb = lam * dv[e] * xv[e], vc = gv[e] * hist[t + 1];
          if constexpr (N == 16) {
            // the warp's two channels: lanes 0-15 keep the sum of lam delta x
            // (dB), lanes 16-31 that of g h_t (dC)
            const bool second = lane & 16;
            part[(tl * BWD_WARPS + warp) * 32 + lane] =
                (second ? vc : vb) + __shfl_xor_sync(FULL, second ? vb : vc, 16);
          } else {
            part[((tl * 2 + 0) * CH + dl) * N + n] = vb;
            part[((tl * 2 + 1) * CH + dl) * N + n] = vc;
          }
        }
      }
      __syncthreads();
      if (threadIdx.x < SEG * CH) {
        // dx and ddelta of one (step, channel): the sums over its N states
        const int tl = threadIdx.x / CH, j = threadIdx.x % CH, t = sg * SEG + tl;
        float sum_lb = 0.f, sum_ga = 0.f;
#pragma unroll
        for (int k = 0; k < N / 2; ++k) {
          const float4 v = ld4(&red[tl][j][4 * k]);
          sum_lb += v.x;
          sum_ga += v.y;
          sum_lb += v.z;
          sum_ga += v.w;
        }
        if (t < len && ch0 + j < p.D) {
          const long long o = ((long long)b * p.L + t0 + t) * p.D + ch0 + j;
          w.dx[o] = ds[j][t] * sum_lb;
          w.ddelta[o] = xs[j][t] * sum_lb + sum_ga * LN2;  // A = A2 ln 2
        }
      }
      if (threadIdx.x >= BWD_SUMMERS) {
        const int i = threadIdx.x - BWD_SUMMERS;
        if constexpr (N == 16) {
          float sum = 0.f;
#pragma unroll
          for (int wi = 0; wi < BWD_WARPS; ++wi) sum += part[((i / 32) * BWD_WARPS + wi) * 32 + i % 32];
          acc[sg][0] += sum;
        } else {
          // o = (step, dB or dC, state): the channels' values in order
#pragma unroll
          for (int k = 0; k < K::OUT_PER; ++k) {
            const int o = i + k * BWD_SUMMERS, tl = o / (2 * N), which = o / N % 2;
            const float* col = part + (tl * 2 + which) * CH * N + o % N;
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < CH; ++j) sum += col[j * N];
            acc[sg][k] += sum;
          }
        }
      }
      // the next segment (or pass) writes red and part only after every
      // thread is past this point
      __syncthreads();
    }
    if (live) w.dA_part[(((long long)b * p.n_chunks + c) * p.D + d) * N + n] = dA;
  }
  if (threadIdx.x >= BWD_SUMMERS) {
    const int i = threadIdx.x - BWD_SUMMERS;
#pragma unroll
    for (int k = 0; k < K::OUT_PER; ++k) {
      const int o = i + k * BWD_SUMMERS, tl = o / (2 * N), which = o / N % 2;
#pragma unroll
      for (int sg = 0; sg < TC / SEG; ++sg) {
        const int t = sg * SEG + tl;
        if (t < len) {
          float* dst = which == 0 ? w.dB_part : w.dC_part;
          dst[(((long long)b * w.groups + grp) * p.L + t0 + t) * N + o % N] = acc[sg][k];
        }
      }
    }
  }
}

// dB, dC (Bt, L, N): the sum of the groups' partials, in group order.
template <int N>
__global__ void __launch_bounds__(256)
selective_scan_bwd_reduce_bc(ScanParams p, BwdBuffers w, int Bt) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long rows = (long long)p.L * N;
  if (i >= Bt * rows) return;
  const long long b = i / rows, r = i % rows;
  float sb = 0.f, sc = 0.f;
  for (int gi = 0; gi < w.groups; ++gi) {
    const long long o = (b * w.groups + gi) * rows + r;
    sb += w.dB_part[o];
    sc += w.dC_part[o];
  }
  w.dB[i] = sb;
  w.dC[i] = sc;
}

// dA (D, N): the sum over (row, chunk) of the chunks' partials; 32 columns a
// block, 8 slices of rows summed in a fixed order.
template <int N>
__global__ void __launch_bounds__(256)
selective_scan_bwd_reduce_da(ScanParams p, BwdBuffers w, int rows) {
  __shared__ float s8[8][32];
  const int col = blockIdx.x * 32 + threadIdx.x % 32, slice = threadIdx.x / 32;
  const int cols = p.D * N;
  float s = 0.f;
  if (col < cols)
    for (int r = slice; r < rows; r += 8) s += w.dA_part[(long long)r * cols + col];
  s8[slice][threadIdx.x % 32] = s;
  __syncthreads();
  if (slice == 0 && col < cols) {
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) total += s8[k][threadIdx.x];
    w.dA[col] = total;
  }
}

// K6's segments of seg_chunks chunks each; false unless S is what
// `fwd_segments` (ops/ssm.py) can give: 1 <= S <= n_chunks, and no segment
// empty.
bool fwd_split(int L, int segments, int* seg_chunks) {
  const int nch = (L + TC - 1) / TC;
  if (segments < 1 || segments > nch) return false;
  *seg_chunks = (nch + segments - 1) / segments;
  return (nch + *seg_chunks - 1) / *seg_chunks == segments;
}

// The grid of K6's launch `pass` (0: selective_scan_fwd_local, none when S is
// 1; 1: selective_scan_fwd_body); the same at every N.
dim3 fwd_grid(int Bt, int D, int segments, int pass) {
  const unsigned blocks = (D + FWD_CH - 1) / FWD_CH;
  if (pass == 0) return dim3(blocks, segments - 1, Bt);
  return dim3(blocks, segments > 1 ? segments - 1 : 1, Bt);
}

// Floats of workspace K6 needs: the segments' exits (Bt, S - 1, N, D) and
// sums of delta (Bt, S - 1, D).
long long fwd_workspace_floats(int Bt, int D, int N, int segments) {
  return (long long)Bt * (segments - 1) * (N + 1) * D;
}

bool rows_aligned(const float* ptr, long long s_b, long long s_l) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s_b % 4 == 0 && s_l % 4 == 0;
}

// A K6 kernel at N (16, 32 or 64): its entry, threads and dynamic shared
// memory.
struct FwdLaunch {
  void (*kernel)(ScanParams, FwdBuffers);
  int threads, smem;
};

template <int N, typename BT>
FwdLaunch fwd_launch_n(bool local, bool states) {
  FwdLaunch l;
  if (local)
    l.kernel = states ? selective_scan_fwd_local<N, BT, true> : selective_scan_fwd_local<N, BT, false>;
  else
    l.kernel = states ? selective_scan_fwd_body<N, BT, true> : selective_scan_fwd_body<N, BT, false>;
  l.threads = Fwd<N>::THREADS;
  l.smem = (int)sizeof(FwdSmem<N>);
  return l;
}

template <typename BT>
FwdLaunch fwd_launch(int N, bool local, bool states) {
  if (N == 16) return fwd_launch_n<16, BT>(local, states);
  if (N == 32) return fwd_launch_n<32, BT>(local, states);
  return fwd_launch_n<64, BT>(local, states);
}

cudaError_t launch_fwd_kernel(const FwdLaunch& l, dim3 grid, const ScanParams& p,
                              const FwdBuffers& w, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem);
  if (err != cudaSuccess) return err;
  l.kernel<<<grid, l.threads, l.smem, stream>>>(p, w);
  return cudaGetLastError();
}

template <typename BT>
cudaError_t launch_fwd(ScanParams p, int Bt, int N, FwdBuffers w, float* workspace,
                       cudaStream_t stream) {
  p.vec_x = rows_aligned(p.x, p.sx_b, p.sx_l);
  p.vec_delta = rows_aligned(p.delta, p.sd_b, p.sd_l);
  w.exits = workspace;
  w.dsum = workspace + (long long)Bt * (w.segments - 1) * N * p.D;
  if (w.segments > 1) {
    auto local = fwd_launch<BT>(N, true, w.states != nullptr);
    const cudaError_t err =
        launch_fwd_kernel(local, fwd_grid(Bt, p.D, w.segments, 0), p, w, stream);
    if (err != cudaSuccess) return err;
  }
  auto body = fwd_launch<BT>(N, false, w.states != nullptr);
  return launch_fwd_kernel(body, fwd_grid(Bt, p.D, w.segments, 1), p, w, stream);
}

ScanParams make_params(const void* x, const void* delta, const void* A,
                       const void* B, const void* C, int L, int D,
                       long long sx_b, long long sx_l, long long sd_b,
                       long long sd_l, long long sB_b, long long sB_l,
                       long long sC_b, long long sC_l) {
  ScanParams p;
  p.x = static_cast<const float*>(x);
  p.delta = static_cast<const float*>(delta);
  p.A = static_cast<const float*>(A);
  p.B = B;
  p.C = C;
  p.L = L;
  p.D = D;
  p.n_chunks = (L + TC - 1) / TC;
  p.sx_b = sx_b, p.sx_l = sx_l, p.sd_b = sd_b, p.sd_l = sd_l;
  p.sB_b = sB_b, p.sB_l = sB_l, p.sC_b = sC_b, p.sC_l = sC_l;
  p.vec_x = p.vec_delta = false;
  return p;
}

// Floats of workspace K7 needs: the carries (Bt, n_chunks, N, D), the chunk
// sums of delta (Bt, n_chunks, D), the dB and dC partials (Bt, groups, L, N)
// and the dA partials (Bt * n_chunks, D, N).
long long bwd_workspace_floats(int Bt, int L, int D, int N) {
  const long long nch = (L + TC - 1) / TC, groups = (D + BWD_GROUP - 1) / BWD_GROUP;
  return (long long)Bt * nch * N * D + (long long)Bt * nch * D +
         2LL * Bt * groups * L * N + (long long)Bt * nch * D * N;
}

template <int N, typename BT>
cudaError_t launch_bwd(const ScanParams& p, int Bt, BwdBuffers w, float* workspace,
                       cudaStream_t stream) {
  const long long nch = p.n_chunks;
  w.groups = (p.D + BWD_GROUP - 1) / BWD_GROUP;
  w.carry = workspace;
  w.dsum = w.carry + Bt * nch * N * p.D;
  w.dB_part = w.dsum + Bt * nch * p.D;
  w.dC_part = w.dB_part + (long long)Bt * w.groups * p.L * N;
  w.dA_part = w.dC_part + (long long)Bt * w.groups * p.L * N;
  const dim3 chunks(w.groups, p.n_chunks, Bt);
  selective_scan_bwd_local<N, BT><<<chunks, BWD_THREADS, 0, stream>>>(p, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long pairs = (long long)Bt * N * p.D;
  selective_scan_bwd_carry<N><<<(unsigned)((pairs + 255) / 256), 256, 0, stream>>>(p, w, Bt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto chunk = selective_scan_bwd_chunk<N, BT>;
  const size_t smem = BwdChunk<N>::SMEM_FLOATS * sizeof(float);
  err = cudaFuncSetAttribute(chunk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  chunk<<<chunks, BWD_THREADS, smem, stream>>>(p, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long bc = (long long)Bt * p.L * N;
  selective_scan_bwd_reduce_bc<N><<<(unsigned)((bc + 255) / 256), 256, 0, stream>>>(p, w, Bt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  selective_scan_bwd_reduce_da<N>
      <<<(p.D * N + 31) / 32, 256, 0, stream>>>(p, w, (int)(Bt * nch));
  return cudaGetLastError();
}

bool built_n(int n_state) { return n_state == 16 || n_state == 32 || n_state == 64; }

}  // namespace

extern "C" {

// Both return a cudaError_t (0 on success): the launch's own error, from
// cudaGetLastError() right after it.  Strides are in elements.  x, delta and A
// are fp32; `bc_f32` says whether B and C are fp32 (else bf16).  `n_state`
// (N) is 16, 32 or 64; any other gives cudaErrorInvalidValue.

// y (Bt, L, D) fp32 contiguous; `states` is null or (Bt, ceil(L/32), N, D)
// fp32 contiguous and receives the state at the entry of every chunk;
// `workspace` fp32 of lcasr_selective_scan_fwd_workspace(Bt, L, D, N,
// segments) floats; `segments` as `fwd_segments` gives it.
int lcasr_selective_scan_fwd(const void* x, const void* delta, const void* A,
                             const void* B, const void* C, void* y,
                             void* states, void* workspace, int segments, int Bt,
                             int L, int D, int n_state, int bc_f32, long long sx_b,
                             long long sx_l, long long sd_b, long long sd_l,
                             long long sB_b, long long sB_l, long long sC_b,
                             long long sC_l, void* stream) {
  FwdBuffers w;
  if (!built_n(n_state) || Bt < 1 || L < 1 || D < 1 || !fwd_split(L, segments, &w.seg_chunks))
    return cudaErrorInvalidValue;
  const ScanParams p = make_params(x, delta, A, B, C, L, D, sx_b, sx_l, sd_b,
                                   sd_l, sB_b, sB_l, sC_b, sC_l);
  w.y = static_cast<float*>(y);
  w.states = static_cast<float*>(states);
  w.segments = segments;
  float* ws = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc_f32) return launch_fwd<float>(p, Bt, n_state, w, ws, s);
  return launch_fwd<__nv_bfloat16>(p, Bt, n_state, w, ws, s);
}

long long lcasr_selective_scan_fwd_workspace(int Bt, int L, int D, int n_state, int segments) {
  (void)L;
  return fwd_workspace_floats(Bt, D, n_state, segments);
}

// The grid (x, y, z) of K6's launch `pass` (0: selective_scan_fwd_local, 1:
// selective_scan_fwd_body) into grid[3]; returns 1 where that pass does not
// launch (pass 0 when S is 1), -1 for a split the kernel refuses, else 0.
int lcasr_selective_scan_fwd_grid(int Bt, int L, int D, int segments, int pass, int* grid) {
  int seg_chunks;
  if (Bt < 1 || L < 1 || D < 1 || !fwd_split(L, segments, &seg_chunks)) return -1;
  if (pass == 0 && segments == 1) return 1;
  const dim3 g = fwd_grid(Bt, D, segments, pass);
  grid[0] = (int)g.x, grid[1] = (int)g.y, grid[2] = (int)g.z;
  return 0;
}

// g, dx, ddelta (Bt, L, D) fp32 contiguous; `states` as the forward wrote
// them; dB, dC (Bt, L, N) and dA (D, N) fp32 contiguous, the finished
// gradients; `workspace` fp32 of lcasr_selective_scan_bwd_workspace(Bt, L, D,
// N) floats, which the launches overwrite.
int lcasr_selective_scan_bwd(const void* x, const void* delta, const void* A,
                             const void* B, const void* C, const void* g,
                             const void* states, void* dx, void* ddelta,
                             void* dB, void* dC, void* dA, void* workspace,
                             int Bt, int L, int D, int n_state,
                             int bc_f32, long long sx_b, long long sx_l,
                             long long sd_b, long long sd_l, long long sB_b,
                             long long sB_l, long long sC_b, long long sC_l,
                             void* stream) {
  if (!built_n(n_state) || Bt < 1 || L < 1 || D < 1) return cudaErrorInvalidValue;
  const ScanParams p = make_params(x, delta, A, B, C, L, D, sx_b, sx_l, sd_b,
                                   sd_l, sB_b, sB_l, sC_b, sC_l);
  BwdBuffers w;
  w.g = static_cast<const float*>(g);
  w.states = static_cast<const float*>(states);
  w.dx = static_cast<float*>(dx);
  w.ddelta = static_cast<float*>(ddelta);
  w.dB = static_cast<float*>(dB);
  w.dC = static_cast<float*>(dC);
  w.dA = static_cast<float*>(dA);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_state * 2 + (bc_f32 != 0)) {
    case 32: return launch_bwd<16, __nv_bfloat16>(p, Bt, w, ws, s);
    case 33: return launch_bwd<16, float>(p, Bt, w, ws, s);
    case 64: return launch_bwd<32, __nv_bfloat16>(p, Bt, w, ws, s);
    case 65: return launch_bwd<32, float>(p, Bt, w, ws, s);
    case 128: return launch_bwd<64, __nv_bfloat16>(p, Bt, w, ws, s);
    default: return launch_bwd<64, float>(p, Bt, w, ws, s);
  }
}

long long lcasr_selective_scan_bwd_workspace(int Bt, int L, int D, int n_state) {
  return bwd_workspace_floats(Bt, L, D, n_state);
}

const char* lcasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
