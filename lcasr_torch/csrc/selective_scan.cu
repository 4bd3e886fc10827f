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
// Design.  One thread owns one (batch row, channel) pair and keeps its 16
// states in registers for the whole sequence, so y_t, dx_t and ddelta_t (sums
// over n) need no communication, and neighbouring threads read neighbouring
// channels of x, delta, y (coalesced).  B_t and C_t (16 values each, shared by
// every channel of a batch row) are staged in shared memory one chunk of 32
// time steps at a time and read as broadcasts; they are read through their
// strides, so last-dimension slices of a wider projection need no copy.
//
// The forward can write the state at the entry of every 32-step chunk,
// (Bt, ceil(L/32), N, D) fp32.  The backward walks the chunks in reverse with
// one warp (32 channels) per block: it recomputes the chunk's 32 states
// forward from the saved entry state into shared memory (33 x 16 x 32 fp32 =
// 66 KB; with the chunk's x, delta, g, B and C the block takes 82 KB, so two
// blocks fit on an SM), then sweeps back with the adjoint lambda in registers.
// The recurrence is never inverted.  dB_t and dC_t are sums over channels: each
// warp reduces its 16 + 16 values per step with a halving butterfly (16
// shuffles for 16 values) and writes one partial per 32-channel group; dA is
// kept per batch row.  The wrapper adds the partials up with a tensor sum, so
// the result does not depend on the order in which blocks ran (no atomics).
//
// Memory latency.  With one or two warps per scheduler nothing hides a round
// trip to device memory, so a chunk's loads (x, delta, g, B, C, the entry
// state) are all loaded into registers before the first of them is stored to
// shared memory: a load-then-store pair per element serialises on the
// latency and took these kernels 2-3x as long.
//
// Bound: the function needs one exp per (t, d, n), forward and backward, on
// the special-function units (16 per clock per SM); the backward here spends a
// second one in its reverse sweep instead of shared memory for the gains.  See
// PERF.md.  All arithmetic and the state are fp32; x, delta and A are fp32 (the
// wrapper casts; the mixer's x is fp32 already), B and C bf16 or fp32.
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
// K7: backward.  grid (ceil(D / 32), Bt), one warp.
// ---------------------------------------------------------------------------
// Sum each of v[0..15] over the 32 lanes.  Every stage halves the values a
// lane holds (it keeps one half and hands the other to its partner), so 16
// values cost 8 + 4 + 2 + 1 + 1 shuffles.  Returns the total of value
// `butterfly_index(lane)`; lanes l and l ^ 16 hold the same one.
__device__ __forceinline__ float warp_sum16(const float (&v)[N], int lane) {
  float w8[8], w4[4], w2[2];
  bool up = lane & 1;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float send = up ? v[i] : v[i + 8];
    const float keep = up ? v[i + 8] : v[i];
    w8[i] = keep + __shfl_xor_sync(FULL, send, 1);
  }
  up = lane & 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = up ? w8[i] : w8[i + 4];
    const float keep = up ? w8[i + 4] : w8[i];
    w4[i] = keep + __shfl_xor_sync(FULL, send, 2);
  }
  up = lane & 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = up ? w4[i] : w4[i + 2];
    const float keep = up ? w4[i + 2] : w4[i];
    w2[i] = keep + __shfl_xor_sync(FULL, send, 4);
  }
  up = lane & 8;
  const float send = up ? w2[0] : w2[1];
  const float keep = up ? w2[1] : w2[0];
  float w = keep + __shfl_xor_sync(FULL, send, 8);
  w += __shfl_xor_sync(FULL, w, 16);
  return w;
}

__device__ __forceinline__ int butterfly_index(int lane) {
  return ((lane & 1) << 3) | ((lane & 2) << 1) | ((lane & 4) >> 1) |
         ((lane & 8) >> 3);
}

// hist 66 KB + x, delta, g 12 KB + B, C 4 KB = 82 KB
constexpr int BWD_SMEM_FLOATS = (TC + 1) * N * 32 + 3 * TC * 32 + 2 * TC * N;

template <typename BT>
__global__ void __launch_bounds__(32)
selective_scan_bwd_kernel(ScanParams p, const float* __restrict__ g,
                          const float* __restrict__ states,
                          float* __restrict__ dx, float* __restrict__ ddelta,
                          float* __restrict__ dB_part,
                          float* __restrict__ dC_part,
                          float* __restrict__ dA_part) {
  extern __shared__ __align__(16) float smem[];
  float (*hist)[N][32] = reinterpret_cast<float (*)[N][32]>(smem);  // [TC+1]
  float (*xs)[32] = reinterpret_cast<float (*)[32]>(smem + (TC + 1) * N * 32);
  float (*ds)[32] = xs + TC;
  float (*gs)[32] = ds + TC;
  float (*Bs)[N] = reinterpret_cast<float (*)[N]>(smem + (TC + 1) * N * 32 +
                                                  3 * TC * 32);
  float (*Cs)[N] = Bs + TC;

  const int lane = threadIdx.x;
  const int b = blockIdx.y;
  const int grp = blockIdx.x;
  const int n_groups = gridDim.x;
  const int d = grp * 32 + lane;
  const bool live = d < p.D;
  const int out_n = butterfly_index(lane);

  float A2[N], h[N], carry[N], dA[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    A2[n] = live ? p.A[(long long)d * N + n] * LOG2E : 0.f;
    carry[n] = 0.f;  // a_{t+1} * lambda_{t+1}: nothing follows the last step
    dA[n] = 0.f;
  }
  const float* xp = p.x + (long long)b * p.sx_b + d;
  const float* dp = p.delta + (long long)b * p.sd_b + d;
  const long long row0 = (long long)b * p.L;  // contiguous (Bt, L, .) tensors

  for (int c = p.n_chunks - 1; c >= 0; --c) {
    const int t0 = c * TC;
    const int len = min(TC, p.L - t0);
    __syncwarp();  // the chunk after has been read
    stage_bc<BT, 32>(p, b, t0, len, Bs, Cs);
    {
      // x, delta and g of this channel, one array at a time: all of its
      // loads, then all of its stores (dead channels and the tail: zeros,
      // which make every step a no-op)
      float r[TC];
#pragma unroll
      for (int t = 0; t < TC; ++t)
        r[t] = (live && t < len) ? xp[(long long)(t0 + t) * p.sx_l] : 0.f;
#pragma unroll
      for (int t = 0; t < TC; ++t) xs[t][lane] = r[t];
#pragma unroll
      for (int t = 0; t < TC; ++t)
        r[t] = (live && t < len) ? dp[(long long)(t0 + t) * p.sd_l] : 0.f;
#pragma unroll
      for (int t = 0; t < TC; ++t) ds[t][lane] = r[t];
#pragma unroll
      for (int t = 0; t < TC; ++t)
        r[t] = (live && t < len) ? g[(row0 + t0 + t) * p.D + d] : 0.f;
#pragma unroll
      for (int t = 0; t < TC; ++t) gs[t][lane] = r[t];
    }
    {
      const float* sp = states + ((long long)b * p.n_chunks + c) * N * p.D + d;
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = live ? sp[(long long)n * p.D] : 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) hist[0][n][lane] = h[n];
    }
    __syncwarp();

    // the chunk's states, forward from its entry state: hist[t + 1] = h_t
#pragma unroll 4
    for (int t = 0; t < len; ++t) {
      const float dt = ds[t][lane];
      const float dtx = dt * xs[t][lane];
      float Bt[N];
      lds16(Bs[t], Bt);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = ex2(dt * A2[n]) * h[n] + dtx * Bt[n];
        hist[t + 1][n][lane] = h[n];
      }
    }

    // reverse sweep; h holds h_t on entry to step t
#pragma unroll 2
    for (int t = len - 1; t >= 0; --t) {
      const float dt = ds[t][lane];
      const float xv = xs[t][lane];
      const float gv = gs[t][lane];
      const float dtx = dt * xv;
      float sum_lb = 0.f, sum_ga = 0.f;
      float vb[N], vc[N], Bt[N], Ct[N];
      lds16(Bs[t], Bt);
      lds16(Cs[t], Ct);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float a = ex2(dt * A2[n]);
        const float hp = hist[t][n][lane];  // h_{t-1}
        const float lam = carry[n] + Ct[n] * gv;
        sum_lb += lam * Bt[n];
        const float gain = lam * a * hp;
        sum_ga += gain * A2[n];
        dA[n] += gain * dt;
        vb[n] = lam * dtx;
        vc[n] = gv * h[n];
        carry[n] = lam * a;
        h[n] = hp;
      }
      if (live) {
        const long long o = (row0 + t0 + t) * p.D + d;
        dx[o] = dt * sum_lb;
        ddelta[o] = xv * sum_lb + sum_ga * LN2;  // A = A2 * ln 2
      }
      const float rb = warp_sum16(vb, lane);
      const float rc = warp_sum16(vc, lane);
      if (lane < N) {
        const long long o =
            (((long long)b * n_groups + grp) * p.L + t0 + t) * N + out_n;
        dB_part[o] = rb;
        dC_part[o] = rc;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) dA_part[((long long)b * p.D + d) * N + n] = dA[n];
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

template <typename BT>
cudaError_t launch_bwd(const ScanParams& p, int Bt, const float* g,
                       const float* states, float* dx, float* ddelta,
                       float* dB_part, float* dC_part, float* dA_part,
                       cudaStream_t stream) {
  auto kernel = selective_scan_bwd_kernel<BT>;
  const size_t smem = BWD_SMEM_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.D + 31) / 32, Bt);
  kernel<<<grid, 32, smem, stream>>>(p, g, states, dx, ddelta, dB_part,
                                     dC_part, dA_part);
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
// them; dB_part, dC_part (Bt, ceil(D/32), L, 16) and dA_part (Bt, D, 16)
// fp32 contiguous, to be summed over their second / first dimension.
int lcasr_selective_scan_bwd(const void* x, const void* delta, const void* A,
                             const void* B, const void* C, const void* g,
                             const void* states, void* dx, void* ddelta,
                             void* dB_part, void* dC_part, void* dA_part,
                             int Bt, int L, int D, int n_state,
                             int bc_f32, long long sx_b, long long sx_l,
                             long long sd_b, long long sd_l, long long sB_b,
                             long long sB_l, long long sC_b, long long sC_l,
                             void* stream) {
  if (n_state != N || Bt < 1 || L < 1 || D < 1) return cudaErrorInvalidValue;
  const ScanParams p = make_params(x, delta, A, B, C, L, D, sx_b, sx_l, sd_b,
                                   sd_l, sB_b, sB_l, sC_b, sC_l);
  const float* gf = static_cast<const float*>(g);
  const float* sf = static_cast<const float*>(states);
  float* o1 = static_cast<float*>(dx);
  float* o2 = static_cast<float*>(ddelta);
  float* o3 = static_cast<float*>(dB_part);
  float* o4 = static_cast<float*>(dC_part);
  float* o5 = static_cast<float*>(dA_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc_f32)
    return launch_bwd<float>(p, Bt, gf, sf, o1, o2, o3, o4, o5, s);
  return launch_bwd<__nv_bfloat16>(p, Bt, gf, sf, o1, o2, o3, o4, o5, s);
}

const char* lcasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
