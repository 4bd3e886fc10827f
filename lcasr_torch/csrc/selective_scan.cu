// Selective state-space scan for Hopper (sm_90a): forward (K6) and
// reverse-recurrence backward (K7).
//
//     h_t = exp(delta_t * A) h_{t-1} + delta_t * B_t * x_t      (per channel d,
//     y_t = C_t . h_t                                            state n < 16)
//
// Replaces the Pallas kernels `_scan_kernel` and `_scan_bwd_kernel` of
// lcasr_tpu/ops/ssm.py.  What is kept is the function: the same y, the same
// five gradients, and no (Bt, L, D, N) tensor in device memory.  The TPU
// kernels' 16-row groups, transposes and 512-frame grid steps are not.
//
// K6.  One thread owns one (batch row, channel) pair and keeps its 16
// states in registers for the whole sequence, so y_t (a sum over n) needs no
// communication, and neighbouring threads read neighbouring channels of x,
// delta, y (coalesced).  B_t and C_t (16 values each, shared by every channel
// of a batch row) are staged in shared memory one chunk of 32 time steps at a
// time and read as broadcasts; they are read through their strides, so
// last-dimension slices of a wider projection need no copy.  The forward can
// write the state at the entry of every 32-step chunk, (Bt, ceil(L/32), N, D)
// fp32.
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
// Memory latency.  A chunk's loads (x, delta, g, B, C, the entry state) are
// all loaded into registers before the first of them is stored to shared
// memory: a load-then-store pair per element serialises on the latency and
// took the first versions of these kernels 2-3x as long.
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

constexpr int N = 16;             // d_state the kernels are built for
constexpr int TC = 32;            // steps per chunk = interval of saved states
constexpr int FWD_THREADS = 128;  // channels per forward block
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

// 16 consecutive fp32 values from shared memory, as four 16-byte reads.
__device__ __forceinline__ void lds16(const float* row, float (&out)[16]) {
  const float4* v = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 q = v[i];
    out[4 * i] = q.x, out[4 * i + 1] = q.y, out[4 * i + 2] = q.z, out[4 * i + 3] = q.w;
  }
}

struct ScanParams {
  const float* x;      // (Bt, L, D), unit stride on D
  const float* delta;  // (Bt, L, D), unit stride on D
  const float* A;      // (D, N) contiguous
  const void* B;       // (Bt, L, N), unit stride on N
  const void* C;       // (Bt, L, N), unit stride on N
  int L, D, n_chunks;
  long long sx_b, sx_l, sd_b, sd_l, sB_b, sB_l, sC_b, sC_l;
};

// Stage B and C of steps [t0, t0 + len) of batch row b into shared memory as
// fp32; rows past len are zero.  Every load comes before the first store,
// so one round trip to memory covers them all.
template <typename BT, int THREADS>
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
// K6: forward.  grid (ceil(D / 128), Bt), 128 threads.
// ---------------------------------------------------------------------------
template <typename BT, bool STATES>
__global__ void __launch_bounds__(FWD_THREADS)
selective_scan_fwd_kernel(ScanParams p, float* __restrict__ y,
                          float* __restrict__ states) {
  __shared__ float xs[TC][FWD_THREADS];
  __shared__ float ds[TC][FWD_THREADS];
  __shared__ __align__(16) float Bs[TC][N];
  __shared__ __align__(16) float Cs[TC][N];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d = blockIdx.x * FWD_THREADS + tid;
  const bool live = d < p.D;

  float A2[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    A2[n] = live ? p.A[(long long)d * N + n] * LOG2E : 0.f;
    h[n] = 0.f;
  }
  const float* xp = p.x + (long long)b * p.sx_b + d;
  const float* dp = p.delta + (long long)b * p.sd_b + d;
  float* yp = y + (long long)b * p.L * p.D + d;

  for (int c = 0; c < p.n_chunks; ++c) {
    const int t0 = c * TC;
    const int len = min(TC, p.L - t0);
    __syncthreads();  // the chunk before has been read
    stage_bc<BT, FWD_THREADS>(p, b, t0, len, Bs, Cs);
    {
      // the chunk's x and delta of this channel: all loads, then all stores
      float xr[TC], dr[TC];
#pragma unroll
      for (int t = 0; t < TC; ++t) {
        const bool ok = live && t < len;
        xr[t] = ok ? xp[(long long)(t0 + t) * p.sx_l] : 0.f;
        dr[t] = ok ? dp[(long long)(t0 + t) * p.sd_l] : 0.f;
      }
#pragma unroll
      for (int t = 0; t < TC; ++t) {
        xs[t][tid] = xr[t];
        ds[t][tid] = dr[t];
      }
    }
    if (STATES && live) {
      float* sp = states + ((long long)b * p.n_chunks + c) * N * p.D + d;
#pragma unroll
      for (int n = 0; n < N; ++n) sp[(long long)n * p.D] = h[n];
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int t = 0; t < len; ++t) {
        const float dt = ds[t][tid];
        const float dtx = dt * xs[t][tid];
        float Bt[N], Ct[N];
        lds16(Bs[t], Bt);
        lds16(Cs[t], Ct);
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = ex2(dt * A2[n]) * h[n] + dtx * Bt[n];
          acc += h[n] * Ct[n];
        }
        yp[(long long)(t0 + t) * p.D] = acc;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K7: backward, parallel over rows, channels and chunks.  Five launches:
//   selective_scan_bwd_local  each chunk's adjoint from a zero carry;
//   selective_scan_bwd_carry  every chunk's true incoming carry, in place;
//   selective_scan_bwd_chunk  each chunk's gradients from its true carry;
//   selective_scan_bwd_reduce_bc / _reduce_da  the sums over channel groups
//                             and over (row, chunk) of dB, dC and dA.
// The chunk kernels take one (channel, state) pair a thread: BWD_CH channels
// x 16 states = 512 threads, and walk a block's BWD_GROUP channels in
// BWD_GROUP / BWD_CH passes.  Lanes 0-15 of a warp are the 16 states of one
// channel, lanes 16-31 those of the next.
// ---------------------------------------------------------------------------
constexpr int BWD_CH = 32;      // channels a pass of a block
constexpr int BWD_GROUP = 128;  // channels a block: one partial of dB, dC
constexpr int BWD_THREADS = BWD_CH * N;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int BWD_PASSES = BWD_GROUP / BWD_CH;
// a chunk's per-channel (and per-state) inputs lie in shared memory as
// [channel][t] rows of TCP floats, so a thread reads four steps with one
// 16-byte load; the 4 floats of padding spread the rows over the banks
constexpr int TCP = TC + 4;

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
template <bool X>
__device__ __forceinline__ void stage_chunk(const ScanParams& p, const float* g,
                                            int b, int t0, int len, int ch0,
                                            float (*xs)[TCP], float (*ds)[TCP],
                                            float (*gs)[TCP]) {
  constexpr int PER = TC * BWD_CH / BWD_THREADS;
  float xr[PER], dr[PER], gr[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * BWD_THREADS;
    const int t = i / BWD_CH, d = ch0 + i % BWD_CH;
    const bool ok = t < len && d < p.D;
    const long long tt = t0 + t;
    xr[k] = (X && ok) ? p.x[(long long)b * p.sx_b + tt * p.sx_l + d] : 0.f;
    dr[k] = ok ? p.delta[(long long)b * p.sd_b + tt * p.sd_l + d] : 0.f;
    gr[k] = ok ? g[((long long)b * p.L + tt) * p.D + d] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * BWD_THREADS;
    if (X) xs[i % BWD_CH][i / BWD_CH] = xr[k];
    ds[i % BWD_CH][i / BWD_CH] = dr[k];
    gs[i % BWD_CH][i / BWD_CH] = gr[k];
  }
}

// A (N, BWD_CH + 1) slice [n][channel] of a (Bt, n_chunks, N, D) tensor at
// chunk (b, c), zeros past D (one load a thread).
__device__ __forceinline__ float load_state_slice(const float* src, const ScanParams& p,
                                                  int b, int c, int ch0) {
  const int n = threadIdx.x / BWD_CH, d = ch0 + threadIdx.x % BWD_CH;
  return d < p.D ? src[(((long long)b * p.n_chunks + c) * N + n) * p.D + d] : 0.f;
}

// Pass 1: lambda from a zero carry over the chunk, backward; writes the carry
// the chunk would hand to the one before it, a_{t0} lambda_{t0}, and the
// chunk's sum of delta (its gain is exp(A sum delta)).  grid (groups,
// n_chunks, Bt).  Needs delta, g and C only.
template <typename BT>
__global__ void __launch_bounds__(BWD_THREADS)
selective_scan_bwd_local(ScanParams p, BwdBuffers w) {
  __shared__ __align__(16) float ds[BWD_CH][TCP];
  __shared__ __align__(16) float gs[BWD_CH][TCP];
  __shared__ __align__(16) float Bs[TC][N];  // unused here: stage_bc fills both
  __shared__ __align__(16) float Cs[TC][N];
  __shared__ float out[N][BWD_CH + 1];
  __shared__ float sums[BWD_CH];
  const int grp = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int t0 = c * TC, len = min(TC, p.L - t0);
  const int lane = threadIdx.x % 32, n = lane & 15;
  const int dl = 2 * (threadIdx.x / 32) + (lane >> 4);
  stage_bc<BT, BWD_THREADS>(p, b, t0, len, Bs, Cs);
  for (int pass = 0; pass < BWD_PASSES; ++pass) {
    const int ch0 = grp * BWD_GROUP + pass * BWD_CH;
    if (ch0 >= p.D) break;  // the same for every thread of the block
    stage_chunk<false>(p, w.g, b, t0, len, ch0, nullptr, ds, gs);
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
    if (threadIdx.x < BWD_CH) {
      float s = 0.f;
      for (int t = 0; t < TC; ++t) s += ds[threadIdx.x][t];
      sums[threadIdx.x] = s;
    }
    __syncthreads();
    {
      const int nn = threadIdx.x / BWD_CH, j = threadIdx.x % BWD_CH, dd = ch0 + j;
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
// sweep.  Sums over the 16 states (dx, ddelta) are shuffles inside the
// 16 lanes of a channel; sums over channels (dB, dC) a shuffle between the
// warp's two channels, then over the warps in shared memory in a fixed
// order; dA per (row, chunk) partial.  grid (groups, n_chunks, Bt).
// The reverse sweep hands its sums to shared memory every SEG steps: per
// (step, channel) the 16 states' (lam B, lam a h_{t-1} A) pairs, rows of RED
// floats (padded so that 16-byte reads of neighbouring rows miss each other's
// banks), and per (step, warp) the dB / dC values of its two channels.
constexpr int SEG = 8;
constexpr int RED = 2 * N + 4;
static_assert(2 * SEG * BWD_CH == BWD_THREADS && BWD_CH == 32,
              "half the threads reduce red, half part, one (step, channel / lane) each");
constexpr int CHUNK_SMEM_FLOATS = 3 * BWD_CH * TCP + 2 * N * TCP + 2 * N * (BWD_CH + 1) +
                                  SEG * BWD_CH * RED + SEG * BWD_WARPS * 32;

// B and C of steps [t0, t0 + len) as [n][t] (zeros past len): one load each
// a thread, then the stores.
template <typename BT>
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

template <typename BT>
__global__ void __launch_bounds__(BWD_THREADS, 2)
selective_scan_bwd_chunk(ScanParams p, BwdBuffers w) {
  extern __shared__ __align__(16) float smem[];
  float (*xs)[TCP] = reinterpret_cast<float (*)[TCP]>(smem);
  float (*ds)[TCP] = xs + BWD_CH;
  float (*gs)[TCP] = ds + BWD_CH;
  float (*Bs)[TCP] = gs + BWD_CH;
  float (*Cs)[TCP] = Bs + N;
  float (*hs)[BWD_CH + 1] = reinterpret_cast<float (*)[BWD_CH + 1]>(Cs + N);
  float (*cs)[BWD_CH + 1] = hs + N;
  float (*red)[BWD_CH][RED] = reinterpret_cast<float (*)[BWD_CH][RED]>(cs + N);
  float (*part)[BWD_WARPS][32] = reinterpret_cast<float (*)[BWD_WARPS][32]>(red + SEG);

  const int grp = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int t0 = c * TC, len = min(TC, p.L - t0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n = lane & 15;
  const int dl = 2 * warp + (lane >> 4);
  stage_bc_t<BT>(p, b, t0, len, Bs, Cs);
  // threads SEG * BWD_CH .. sum the warps' dB / dC values of one (step in
  // the segment, lane) pair; acc[sg] is that sum for segment sg
  float acc[TC / SEG] = {};

  for (int pass = 0; pass < BWD_PASSES; ++pass) {
    const int ch0 = grp * BWD_GROUP + pass * BWD_CH;
    if (ch0 >= p.D) break;  // the same for every thread of the block
    {
      const float hv = load_state_slice(w.states, p, b, c, ch0);
      const float cv = load_state_slice(w.carry, p, b, c, ch0);
      stage_chunk<true>(p, w.g, b, t0, len, ch0, xs, ds, gs);
      hs[threadIdx.x / BWD_CH][threadIdx.x % BWD_CH] = hv;
      cs[threadIdx.x / BWD_CH][threadIdx.x % BWD_CH] = cv;
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
          // the warp's two channels: lanes 0-15 keep the sum of lam delta x
          // (dB), lanes 16-31 that of g h_t (dC)
          const bool second = lane & 16;
          const float vb = lam * dv[e] * xv[e], vc = gv[e] * hist[t + 1];
          part[tl][warp][lane] = (second ? vc : vb) + __shfl_xor_sync(FULL, second ? vb : vc, 16);
        }
      }
      __syncthreads();
      if (threadIdx.x < SEG * BWD_CH) {
        // dx and ddelta of one (step, channel): the sums over its 16 states
        const int tl = threadIdx.x / BWD_CH, j = threadIdx.x % BWD_CH, t = sg * SEG + tl;
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
      } else {
        const int i = threadIdx.x - SEG * BWD_CH;
        float sum = 0.f;
#pragma unroll
        for (int wi = 0; wi < BWD_WARPS; ++wi) sum += part[i / 32][wi][i % 32];
        acc[sg] += sum;
      }
      // the next segment (or pass) writes red and part only after every
      // thread is past this point
      __syncthreads();
    }
    if (live) w.dA_part[(((long long)b * p.n_chunks + c) * p.D + d) * N + n] = dA;
  }
  if (threadIdx.x >= SEG * BWD_CH) {
    const int i = threadIdx.x - SEG * BWD_CH, tl = i / 32, l = i % 32;
#pragma unroll
    for (int sg = 0; sg < TC / SEG; ++sg) {
      const int t = sg * SEG + tl;
      if (t < len) {
        float* dst = l < N ? w.dB_part : w.dC_part;
        dst[(((long long)b * w.groups + grp) * p.L + t0 + t) * N + (l % N)] = acc[sg];
      }
    }
  }
}

// dB, dC (Bt, L, N): the sum of the groups' partials, in group order.
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

template <typename BT>
cudaError_t launch_fwd(const ScanParams& p, int Bt, float* y, float* states,
                       cudaStream_t stream) {
  const dim3 grid((p.D + FWD_THREADS - 1) / FWD_THREADS, Bt);
  if (states != nullptr)
    selective_scan_fwd_kernel<BT, true>
        <<<grid, FWD_THREADS, 0, stream>>>(p, y, states);
  else
    selective_scan_fwd_kernel<BT, false>
        <<<grid, FWD_THREADS, 0, stream>>>(p, y, nullptr);
  return cudaGetLastError();
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
  return p;
}

// Floats of workspace K7 needs: the carries (Bt, n_chunks, N, D), the chunk
// sums of delta (Bt, n_chunks, D), the dB and dC partials (Bt, groups, L, N)
// and the dA partials (Bt * n_chunks, D, N).
long long bwd_workspace_floats(int Bt, int L, int D) {
  const long long nch = (L + TC - 1) / TC, groups = (D + BWD_GROUP - 1) / BWD_GROUP;
  return (long long)Bt * nch * N * D + (long long)Bt * nch * D +
         2LL * Bt * groups * L * N + (long long)Bt * nch * D * N;
}

template <typename BT>
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
  selective_scan_bwd_local<BT><<<chunks, BWD_THREADS, 0, stream>>>(p, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long pairs = (long long)Bt * N * p.D;
  selective_scan_bwd_carry<<<(unsigned)((pairs + 255) / 256), 256, 0, stream>>>(p, w, Bt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto chunk = selective_scan_bwd_chunk<BT>;
  const size_t smem = CHUNK_SMEM_FLOATS * sizeof(float);
  err = cudaFuncSetAttribute(chunk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  chunk<<<chunks, BWD_THREADS, smem, stream>>>(p, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long bc = (long long)Bt * p.L * N;
  selective_scan_bwd_reduce_bc<<<(unsigned)((bc + 255) / 256), 256, 0, stream>>>(p, w, Bt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  selective_scan_bwd_reduce_da<<<(p.D * N + 31) / 32, 256, 0, stream>>>(p, w, (int)(Bt * nch));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Both return a cudaError_t (0 on success): the launch's own error, from
// cudaGetLastError() right after it.  Strides are in elements.  x, delta and A
// are fp32; `bc_f32` says whether B and C are fp32 (else bf16).

// y (Bt, L, D) fp32 contiguous; `states` is null or (Bt, ceil(L/32), 16, D)
// fp32 contiguous and receives the state at the entry of every chunk.
int lcasr_selective_scan_fwd(const void* x, const void* delta, const void* A,
                             const void* B, const void* C, void* y,
                             void* states, int Bt, int L, int D, int n_state,
                             int bc_f32, long long sx_b, long long sx_l,
                             long long sd_b, long long sd_l, long long sB_b,
                             long long sB_l, long long sC_b, long long sC_l,
                             void* stream) {
  if (n_state != N || Bt < 1 || L < 1 || D < 1) return cudaErrorInvalidValue;
  const ScanParams p = make_params(x, delta, A, B, C, L, D, sx_b, sx_l, sd_b,
                                   sd_l, sB_b, sB_l, sC_b, sC_l);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(states);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc_f32) return launch_fwd<float>(p, Bt, yf, sf, s);
  return launch_fwd<__nv_bfloat16>(p, Bt, yf, sf, s);
}

// g, dx, ddelta (Bt, L, D) fp32 contiguous; `states` as the forward wrote
// them; dB, dC (Bt, L, 16) and dA (D, 16) fp32 contiguous, the finished
// gradients; `workspace` fp32 of lcasr_selective_scan_bwd_workspace(Bt, L, D)
// floats, which the launches overwrite.
int lcasr_selective_scan_bwd(const void* x, const void* delta, const void* A,
                             const void* B, const void* C, const void* g,
                             const void* states, void* dx, void* ddelta,
                             void* dB, void* dC, void* dA, void* workspace,
                             int Bt, int L, int D, int n_state,
                             int bc_f32, long long sx_b, long long sx_l,
                             long long sd_b, long long sd_l, long long sB_b,
                             long long sB_l, long long sC_b, long long sC_l,
                             void* stream) {
  if (n_state != N || Bt < 1 || L < 1 || D < 1) return cudaErrorInvalidValue;
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
  if (bc_f32) return launch_bwd<float>(p, Bt, w, ws, s);
  return launch_bwd<__nv_bfloat16>(p, Bt, w, ws, s);
}

long long lcasr_selective_scan_bwd_workspace(int Bt, int L, int D) {
  return bwd_workspace_floats(Bt, L, D);
}

const char* lcasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
