// CTC loss for Hopper (sm_90a): the alpha and beta recursions of each batch
// row's lattice, run at once by two thread-block clusters that meet half-way
// in time, and the gradient by class, with a plain C interface that
// lcasr_torch/kernels.py loads through ctypes.  Its wrapper is `ops/ctc.py`
// (`_CTCLoss`); CPU tensors take `torch.nn.functional.ctc_loss` there, the
// plain version.
//
// Replaces no TPU kernel: the JAX package scans the lattice with `lax.scan`
// (lcasr_tpu/ops/ctc.py) and has no Pallas body for it.  It was added because
// PyTorch's CUDA CTC, which the port called, runs one block of at most 1,024
// threads a batch row: at one hour (T' 45,000, 2S+1 = 30,087 states) that
// block walks 30 tiles of states through all 45,000 steps, a barrier and a
// round trip to device memory each, ~1.2 s a pass on one SM of 132.
//
// Bound on the H100: the chain of T dependent steps, and the special
// functions at the cluster's rate.  A state takes at most two expf and one
// logf a step here (PyTorch's three and one, less exp(0) = 1; the same bits),
// and one expf more for its posterior: 45,000 x 30,087 x 4 = 5.4 G
// special-function operations for both passes, 1.3 ms at 16 a clock on 132
// SMs and 21 ms on the 16 SMs of one cluster.  Bytes (the lattice written
// once and read once, 5.4 GB at one hour) take 1.6 ms each way at 3.35 TB/s.
// Measured on an H100 (PERF.md), an alpha step at one hour costs ~1.7 us on
// 16 SMs: about 1 us the special functions and the rest of the state update
// (the max trick, the adds), the rest the step's loads, stores and barriers.
//
// Design.  A pass is one thread-block cluster of up to 16 CTAs (the
// non-portable size, opted into above 8) on neighbouring SMs; each CTA owns a
// slice of W = threads x K consecutive states, thread i the states i, i +
// threads, ... (K a thread, in registers), so that a row of the lattice is
// stored coalesced.  An alpha step needs alpha[t-1] at s, s-1 and s-2: s from
// the thread's own register, s-1 and s-2 from the slice's copy in shared
// memory, and across the slice's left edge from two halo slots that the left
// CTA stores into this CTA's shared memory (st.async, counted on an
// mbarrier) as it makes them; beta mirrors it (s+1, s+2, the right CTA).
// The slice and its halo are double-buffered by the step's parity.  A step
// ends with a CTA barrier; across CTAs only the halo's two readers wait for
// its bytes, and tell the producer when they have read them, so that it may
// store the next-but-one step's there (`Links`): no cluster-wide barrier a
// step, and no fence that would wait on device memory.  Labels are fixed for
// the pass, so each state's emission lp[t, label(s)] is loaded kAhead steps
// ahead of the chain into a ring of registers (the time loop is unrolled by
// kAhead), and the chain never waits on device memory.
//
// Where the gradient is wanted, a row's alpha and beta clusters run at once
// in one launch (rows in groups of as many as the card holds two clusters of
// at once, so both are resident): alpha stores its rows t < M = Tb / 2, beta
// its rows t >= M, then both meet (a flag in device memory), and each goes on
// over the other's rows, storing alpha + beta there, PyTorch's first sum of
// the posterior.  So the lattice is stored once, (B, T, 2S+1), and no beta
// buffer exists; the gradient kernel turns the sums into posteriors
// exp((alpha + beta) + nll - lp) and sums them by class, row by row: a CTA
// takes one (b, t) row, each warp a contiguous quarter of its states, 32 at
// a time; a class with one member among the 32 adds it to the warp's own
// accumulator alone, the members of any other (the blanks, repeated labels)
// are summed by a fixed butterfly first; the four accumulators are added in
// warp order.  No atomics: the gradient is the same bits each run.  A
// lattice wider than a cluster's slices (above 65,536 states) is walked in
// tiles of cluster x W states, alpha left to right (a tile's left halo read
// back from log-alpha in device memory), then beta right to left (its right
// halo from a (B, T, 2) scratch of the tile's two first betas).
//
// Arithmetic is PyTorch's (aten/src/ATen/native/cuda/LossCTC.cu): the max
// trick over the terms, expf / logf without fast math, the same order of
// additions, -inf as log zero, the nll from the two end states with the same
// max trick; so log-alpha, the nll and alpha + beta are PyTorch's bits.  The
// gradient is PyTorch's convention, (exp(lp) - sum of the class's
// posteriors) x the row's incoming gradient, 0 at t >= input_length and on
// rows whose nll is +inf (zero_infinity).  Input lengths are clamped to
// [0, T] and label lengths to [0, U], and label ids to [0, C): PyTorch
// checks the lengths on the host (a blocking read this wrapper does not
// make) and reads out of bounds for an id outside the classes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kAhead = 4;         // steps of emissions loaded ahead of the chain
constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 16;
constexpr int kGradWarps = 4;     // warps of a gradient CTA, one accumulator each
constexpr int kGradClasses = 4096;  // classes an accumulator holds at once
constexpr int kGradBatch = 8;     // 32-state chunks a warp loads at once
constexpr unsigned kFull = 0xffffffffu;

struct Lattice {
  const float* lp;                // (B, T, C) log-probs, fp32, contiguous
  const long long* labels;        // (B, U)
  const long long* input_lengths;  // (B,)
  const long long* label_lengths;  // (B,)
  int B, T, C, U, S2, blank;      // S2 = 2U + 1 states
  int cluster, threads, tiles;    // the partition (ops/ctc.py `ctc_partition`)
};

__device__ __forceinline__ int clamp_len(long long v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : static_cast<int>(v));
}

// label(s) of the extended label sequence: blank at even s, the row's labels
// at odd s; blank for states past the row's lattice (as PyTorch)
__device__ __forceinline__ int state_class(const Lattice& L, int b, int s, int live) {
  if (!(s & 1) || s >= live) return L.blank;
  const long long c = L.labels[static_cast<size_t>(b) * L.U + (s >> 1)];
  return c < 0 ? 0 : (c >= L.C ? L.C - 1 : static_cast<int>(c));
}

// log(e^x + e^y [+ e^z]) + e with PyTorch's max trick and order of additions:
// m = x, then y, then z if larger; sum = e^(x-m) + e^(y-m) + e^(z-m) left to
// right; log(sum) + m + e.  The term that is m gives exp(0) = 1 exactly, so
// only the others spend an expf; a two-term state adds e^(-inf) = 0 in
// PyTorch, which changes no bit.  All terms -inf: PyTorch's m = 0 gives
// log(0) + 0 + e.
__device__ __forceinline__ float log_add(float x, float y, float z, bool three, float e) {
  const bool y_wins = y > x;
  const float mxy = y_wins ? y : x;
  if (three && z > mxy) {
    return logf((expf(x - z) + expf(y - z)) + 1.0f) + z + e;
  }
  if (mxy == -INFINITY) return -INFINITY + e;
  float sum = 1.0f + expf((y_wins ? x : y) - mxy);
  if (three) sum += expf(z - mxy);
  return logf(sum) + mxy + e;
}

// ---------------------------------------------------------------------------
// the lattice: one pass (alpha or beta) of one cluster over one tile
// ---------------------------------------------------------------------------
// A pass of direction kBeta makes its values v step by step, i = 0 .. Tb - 1
// (t = i for alpha, Tb - 1 - i for beta), and stores at (t, s) either v
// (kValues: every state of the tile below S2) or other + v (kSums: states of
// the row's lattice only), `other` being what the out buffer holds there:
// alpha + beta, the first sum PyTorch's posterior takes.
enum Store { kValues, kSums };

struct PassArgs {
  int b, Tb, Lb, live, rank, tile;
  float* out;            // (B, T, S2): alpha, then the sums
  float* edge;           // (B, T, 2) beta's tile edges, or null
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the shared::cluster address of shared-memory address `a` in CTA `rank`
__device__ __forceinline__ uint32_t cluster_u32(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint64_t* m, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(m)), "r"(count)
               : "memory");
}

// one arrival that also announces `bytes` of stores to come
__device__ __forceinline__ void mbar_expect(uint64_t* m, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(m)),
               "r"(bytes)
               : "memory");
}

// 4 bytes into another CTA's shared memory, counted on that CTA's mbarrier
__device__ __forceinline__ void store_remote(uint32_t addr, float v, uint32_t mbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
                   addr),
               "r"(__float_as_uint(v)), "r"(mbar)
               : "memory");
}

// An arrival on another CTA's mbarrier, relaxed: a release here would wait
// for this thread's loads from device memory still in flight (0.23 us a
// step at one hour on an H100).  What it signals is only that this thread
// has read two values of its own shared memory: `read` is computed from
// them, so the arrival cannot issue before those reads are done.
__device__ __forceinline__ void arrive_remote(uint32_t mbar, float read) {
  asm volatile("mbarrier.arrive.relaxed.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(mbar),
               "f"(read)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t m, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(m), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Until the phase of parity `parity` has completed.  A wait past ~60 s traps
// (a fault of the phase bookkeeping): the launch fails instead of hanging.
__device__ __noinline__ void mbar_wait_long(uint32_t m, uint32_t parity) {
  const uint64_t t0 = globaltimer_ns();
  while (!mbar_try_wait(m, parity)) {
    if (globaltimer_ns() - t0 > 60ull * 1000 * 1000 * 1000) __trap();
  }
}

__device__ __forceinline__ void mbar_wait(uint64_t* m, uint32_t parity) {
  const uint32_t a = smem_u32(m);
  if (!mbar_try_wait(a, parity)) mbar_wait_long(a, parity);
}

// A CTA's links to its neighbours in a pass.  The producer (left for alpha,
// right for beta) writes this CTA's two halo slots of buffer p by st.async,
// counted on full[p]; this CTA writes its consumer's halo slots of buffer p
// once the consumer has read what was written there two steps before
// (empty[p], on which the consumer's two halo readers arrive).  So one step
// needs only a CTA barrier and, at the slice's edges, these handshakes: no
// cluster-wide barrier and no device-scope fence on the chain.
struct Links {
  uint64_t* full;         // [2], this CTA's
  uint64_t* empty;        // [2], this CTA's
  uint32_t cons_halo[2];  // the consumer's halo slot 0 in its buffer p (shared::cluster)
  uint32_t cons_full[2];
  uint32_t prod_empty[2];
  bool has_prod, has_cons;
  bool reader, writer;    // this thread reads the halo / writes the consumer's
  int n;                  // steps this pass has made (every tile, both halves)
};

template <int K, bool kBeta>
struct Pass {
  int s[K], cls[K];
  bool valid[K], three[K], start[K];
  float own[K];          // the thread's values at the last step

  __device__ __forceinline__ void init(const Lattice& L, const PassArgs& a, int base) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      s[k] = base + k * static_cast<int>(blockDim.x) + static_cast<int>(threadIdx.x);
      valid[k] = s[k] < a.live;
      cls[k] = state_class(L, a.b, s[k], a.live);
      if (kBeta) {  // PyTorch: s < 2L - 1 and label(s + 2) != label(s)
        three[k] = valid[k] && (s[k] & 1) && s[k] + 2 < a.live &&
                   state_class(L, a.b, s[k] + 2, a.live) != cls[k];
        start[k] = valid[k] && s[k] >= 2 * a.Lb - 1;  // beta starts from 2L, 2L - 1
      } else {
        three[k] = valid[k] && (s[k] & 1) && s[k] >= 3 &&
                   state_class(L, a.b, s[k] - 2, a.live) != cls[k];
        start[k] = valid[k] && s[k] <= 1;  // s = 1 is valid only with a label
      }
    }
  }

  // Steps [i0, i1).  buf: this CTA's two buffers, alpha [0, 1] = halo (s =
  // base - 2, base - 1), [2 + i] = state base + i; beta [i] = state base +
  // i, [W, W + 1] = halo (base + W, base + W + 1); step n writes buffer
  // n & 1 and reads the other.
  template <Store store, bool tiled>
  __device__ __forceinline__ void run(const Lattice& L, const PassArgs& a, float* const* buf,
                                      Links& lk, int i0, int i1) {
    if (i0 >= i1) return;
    const int NT = blockDim.x, tid = threadIdx.x, W = NT * K;
    const float* lp_b = L.lp + static_cast<size_t>(a.b) * L.T * L.C;
    float* out_b = a.out + static_cast<size_t>(a.b) * L.T * L.S2;
    float* edge_b = a.edge == nullptr ? nullptr : a.edge + static_cast<size_t>(a.b) * L.T * 2;
    const int base = s[0] - tid;
    // a tile's halo past the lattice's first (alpha) or last (beta) tile:
    // alpha's from log-alpha in memory, beta's from the edge scratch
    const bool halo_in = tiled && tid < 2 &&
                         (kBeta ? a.tile + 1 < L.tiles && a.rank == L.cluster - 1
                                : a.tile > 0 && a.rank == 0);
    const bool edge_out = tiled && kBeta && a.tile > 0 && a.rank == 0 && tid < 2;
    constexpr int ke = kBeta ? 0 : K - 1;  // the state a writer sends
    const int slot = kBeta ? tid : tid - (NT - 2);
    auto time_of = [&](int i) { return kBeta ? a.Tb - 1 - i : i; };
    auto halo_at = [&](int t) {
      return kBeta ? __ldcg(edge_b + static_cast<size_t>(t) * 2 + tid)
                   : __ldcg(out_b + static_cast<size_t>(t) * L.S2 + base - 2 + tid);
    };
    float em[kAhead][K], oth[kAhead][K], hm[kAhead];
#pragma unroll
    for (int d = 0; d < kAhead; ++d) {
      const int t = time_of(min(i0 + d, i1 - 1));
#pragma unroll
      for (int k = 0; k < K; ++k) {
        em[d][k] = __ldg(lp_b + static_cast<size_t>(t) * L.C + cls[k]);
        oth[d][k] = store == kSums && valid[k]
                        ? __ldcg(out_b + static_cast<size_t>(t) * L.S2 + s[k]) : 0.0f;
      }
      hm[d] = halo_in ? halo_at(t) : -INFINITY;
    }
    for (int j0 = i0; j0 < i1; j0 += kAhead) {
#pragma unroll
      for (int d = 0; d < kAhead; ++d) {
        const int i = j0 + d;
        if (i < i1) {  // the same for every thread of the cluster
          const int t = time_of(i), pn = lk.n & 1, qn = pn ^ 1;
          float* cur = buf[pn];
          const float* prv = buf[qn];
          if (lk.has_prod && tid == 0) mbar_expect(&lk.full[pn], 8);  // this step's halo
          if (lk.has_prod && lk.reader && lk.n > 0) mbar_wait(&lk.full[qn], ((lk.n - 1) >> 1) & 1);
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int at = kBeta ? k * NT + tid : k * NT + tid + 2;
            float v;
            if (!valid[k]) {
              v = -INFINITY;
            } else if (i == 0) {
              v = start[k] ? em[d][k] : -INFINITY;
            } else {
              v = log_add(own[k], prv[at + (kBeta ? 1 : -1)],
                          three[k] ? prv[at + (kBeta ? 2 : -2)] : -INFINITY, three[k], em[d][k]);
            }
            own[k] = v;
            cur[at] = v;
          }
          // the readers' states (alpha k = 0, beta k = K - 1) are made from the halo
          if (lk.has_prod && lk.reader && lk.n > 0)
            arrive_remote(lk.prod_empty[qn], own[kBeta ? K - 1 : 0]);
          if (lk.has_cons && lk.writer) {
            if (lk.n >= 2) mbar_wait(&lk.empty[pn], ((lk.n - 2) >> 1) & 1);
            store_remote(lk.cons_halo[pn] + 4 * slot, own[ke], lk.cons_full[pn]);
          }
          if (halo_in) cur[kBeta ? W + tid : tid] = hm[d];
          // the row's stores and the loads for step i + kAhead
#pragma unroll
          for (int k = 0; k < K; ++k) {
            float* o = out_b + static_cast<size_t>(t) * L.S2 + s[k];
            if (store == kValues ? s[k] < L.S2 : valid[k])
              __stcs(o, store == kValues ? own[k] : oth[d][k] + own[k]);
          }
          if (edge_out) edge_b[static_cast<size_t>(t) * 2 + tid] = own[0];
          const int tn = time_of(min(i + kAhead, i1 - 1));
#pragma unroll
          for (int k = 0; k < K; ++k) {
            em[d][k] = __ldg(lp_b + static_cast<size_t>(tn) * L.C + cls[k]);
            if (store == kSums && valid[k])
              oth[d][k] = __ldcg(out_b + static_cast<size_t>(tn) * L.S2 + s[k]);
          }
          if (halo_in) hm[d] = halo_at(tn);
          __syncthreads();
          ++lk.n;
        }
      }
    }
  }

  // the halo of the pass's last step has landed (it is read by the nll, and
  // no store may be in flight to a CTA that leaves)
  __device__ __forceinline__ void drain(Links& lk) {
    if (lk.has_prod && lk.reader && lk.n > 0)
      mbar_wait(&lk.full[(lk.n - 1) & 1], ((lk.n - 1) >> 1) & 1);
    __syncthreads();
  }
};

// The other cluster of the row, at the same point: every store of this
// cluster visible on the device first, then one thread meets the other
// cluster's through `flag` (each adds 1, both wait for 2), then the whole
// cluster goes on, its next loads after the other cluster's stores.  A wait
// past ~60 s traps: the launch fails instead of hanging the card.
__device__ __forceinline__ void meet(cg::cluster_group& cluster, int* flag) {
  __threadfence();
  cluster.sync();
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    atomicAdd(flag, 1);
    const uint64_t t0 = globaltimer_ns();
    while (atomicAdd(flag, 0) < 2) {
      __nanosleep(200);
      if (globaltimer_ns() - t0 > 60ull * 1000 * 1000 * 1000) __trap();
    }
    __threadfence();
  }
  cluster.sync();
}

// What a launch computes: log-alpha and the nll (kAlphaOnly), or the nll and
// the sums alpha + beta (kBoth), two clusters a row that meet half-way in
// time (tiles = 1: alpha stores t < M and sums t >= M, beta the reverse, M =
// Tb / 2), or one after the other (tiles > 1).
enum Mode { kAlphaOnly, kBoth };

// the shared memory of a lattice CTA: two buffers of W + 2 floats, then four
// mbarriers
__host__ __device__ constexpr size_t lattice_smem_bytes(int W) {
  return ((2 * (static_cast<size_t>(W) + 2) * sizeof(float) + 7) / 8) * 8 + 4 * sizeof(uint64_t);
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads, 1)
ctc_lattice_kernel(Lattice L, float* __restrict__ out, float* __restrict__ nll,
                   float* __restrict__ edge, int* __restrict__ flags, int mode, int row0) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int q = blockIdx.x / L.cluster;
  const int b = row0 + (mode == kBoth ? q / 2 : q);
  const bool beta = mode == kBoth && (q & 1);
  const int NT = blockDim.x, tid = threadIdx.x, W = NT * K, TW = W * L.cluster;
  float* buf[2] = {smem, smem + W + 2};
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<char*>(smem) + lattice_smem_bytes(W) - 4 * sizeof(uint64_t));
  Links lk;
  lk.full = bars, lk.empty = bars + 2, lk.n = 0;
  const int prod = beta ? rank + 1 : rank - 1, cons = beta ? rank - 1 : rank + 1;
  lk.has_prod = prod >= 0 && prod < L.cluster;
  lk.has_cons = cons >= 0 && cons < L.cluster;
  lk.reader = beta ? tid >= NT - 2 : tid < 2;
  lk.writer = beta ? tid < 2 : tid >= NT - 2;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const uint32_t halo = smem_u32(beta ? buf[p] + W : buf[p]);
    lk.cons_halo[p] = lk.has_cons ? cluster_u32(halo, cons) : 0;
    lk.cons_full[p] = lk.has_cons ? cluster_u32(smem_u32(&lk.full[p]), cons) : 0;
    lk.prod_empty[p] = lk.has_prod ? cluster_u32(smem_u32(&lk.empty[p]), prod) : 0;
  }
  if (tid == 0) {
    mbar_init(&lk.full[0], 1), mbar_init(&lk.full[1], 1);
    mbar_init(&lk.empty[0], 2), mbar_init(&lk.empty[1], 2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  PassArgs a;
  a.b = b, a.rank = rank, a.out = out, a.edge = edge;
  a.Tb = clamp_len(L.input_lengths[b], L.T);
  a.Lb = clamp_len(L.label_lengths[b], L.U);
  a.live = 2 * a.Lb + 1;
  // the lattice's outer halos are log zero
  if (tid < 2) {
    if (!beta && rank == 0) buf[0][tid] = buf[1][tid] = -INFINITY;
    if (beta && rank == L.cluster - 1) buf[0][W + tid] = buf[1][W + tid] = -INFINITY;
  }
  cluster.sync();  // every CTA's barriers initialised before any remote use
  const bool halves = mode == kBoth && L.tiles == 1 && a.Tb > 0;
  const int M = a.Tb / 2;
  if (!beta) {
    Pass<K, false> p;
    for (int tile = 0; tile < L.tiles; ++tile) {
      a.tile = tile;
      p.init(L, a, tile * TW + rank * W);
      if (halves) {
        p.template run<kValues, false>(L, a, buf, lk, 0, M);
        meet(cluster, flags + b);
        p.template run<kSums, false>(L, a, buf, lk, M, a.Tb);
      } else if (L.tiles > 1) {
        p.template run<kValues, true>(L, a, buf, lk, 0, a.Tb);
      } else {
        p.template run<kValues, false>(L, a, buf, lk, 0, a.Tb);
      }
      p.drain(lk);
      // the nll from the end states 2L and 2L - 1 at t = Tb - 1, by the
      // thread that owns 2L (2L - 1 is in its slice or its halo)
      const int end = 2 * a.Lb, base = tile * TW + rank * W;
      if (a.Tb > 0 && end >= base && end < base + W && (end - base) % NT == tid) {
        const float* last = buf[(lk.n - 1) & 1];
        const float l1 = last[end - base + 2];
        const float l2 = a.Lb > 0 ? last[end - base + 1] : -INFINITY;
        float m = l1 > l2 ? l1 : l2;
        m = m == -INFINITY ? 0.0f : m;
        nll[b] = -(logf(expf(l1 - m) + expf(l2 - m)) + m);
      } else if (a.Tb == 0 && tile == 0 && rank == 0 && tid == 0) {
        nll[b] = a.Lb == 0 ? 0.0f : INFINITY;  // PyTorch's value for an empty input
      }
      if (mode == kAlphaOnly) {  // rows past the input: -inf, as PyTorch writes them
        float* out_b = out + static_cast<size_t>(b) * L.T * L.S2;
        for (int t = a.Tb; t < L.T; ++t) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (p.s[k] < L.S2) __stcs(out_b + static_cast<size_t>(t) * L.S2 + p.s[k], -INFINITY);
          }
        }
      }
      if (L.tiles > 1) {  // the next tile reads this one's right edge
        __threadfence();
        cluster.sync();
      }
    }
    if (mode == kBoth && !halves && a.Tb > 0) meet(cluster, flags + b);  // beta may start
  } else {
    Pass<K, true> p;
    if (mode == kBoth && !halves && a.Tb > 0) meet(cluster, flags + b);  // alpha is done
    for (int tile = L.tiles - 1; tile >= 0; --tile) {
      a.tile = tile;
      p.init(L, a, tile * TW + rank * W);
      if (halves) {
        p.template run<kValues, false>(L, a, buf, lk, 0, a.Tb - M);
        meet(cluster, flags + b);
        p.template run<kSums, false>(L, a, buf, lk, a.Tb - M, a.Tb);
      } else if (L.tiles > 1) {
        p.template run<kSums, true>(L, a, buf, lk, 0, a.Tb);
      } else {
        p.template run<kSums, false>(L, a, buf, lk, 0, a.Tb);
      }
      p.drain(lk);
      if (L.tiles > 1) {  // the next tile (to the left) reads this one's edge
        __threadfence();
        cluster.sync();
      }
    }
  }
  cluster.sync();  // no CTA leaves while a neighbour may still signal it
}

// ---------------------------------------------------------------------------
// gradient (B, T, C): (exp(lp) - the class's posteriors) x grad_out[b]
// (x 1 where grad_out is null), each posterior exp((alpha + beta) + nll - lp)
// from the sums the lattice kernel left
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kGradWarps * 32)
ctc_grad_kernel(Lattice L, const float* __restrict__ sums, const float* __restrict__ nll,
                const float* __restrict__ grad_out, float* __restrict__ grad, int chunk) {
  extern __shared__ float acc_all[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* acc = acc_all + warp * chunk;
  const long long rows = static_cast<long long>(L.B) * L.T;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const int b = static_cast<int>(row / L.T), t = static_cast<int>(row % L.T);
    const int Tb = clamp_len(L.input_lengths[b], L.T);
    const float nll_b = nll[b];
    const float* lp_row = L.lp + row * L.C;
    float* out = grad + row * L.C;
    if (t >= Tb || nll_b == INFINITY) {
      for (int c = threadIdx.x; c < L.C; c += blockDim.x) out[c] = 0.0f;
      continue;
    }
    const int live = 2 * clamp_len(L.label_lengths[b], L.U) + 1;
    const float g = grad_out == nullptr ? 1.0f : grad_out[b];
    const float* x_row = sums + row * L.S2;
    // each warp a contiguous run of whole 32-state chunks
    const int per_warp = ((live + kGradWarps * 32 - 1) / (kGradWarps * 32)) * 32;
    const int s_lo = warp * per_warp, s_hi = min(s_lo + per_warp, live);
    for (int c0 = 0; c0 < L.C; c0 += chunk) {
      const int cw = min(chunk, L.C - c0);
      for (int c = lane; c < cw; c += 32) acc[c] = 0.0f;
      __syncwarp();
      for (int s0 = s_lo; s0 < s_hi; s0 += 32 * kGradBatch) {
        // the batch's reads in flight at once: sums, labels, then emissions
        float p[kGradBatch];
        int cls[kGradBatch];
#pragma unroll
        for (int u = 0; u < kGradBatch; ++u) {
          const int s = s0 + u * 32 + lane;
          p[u] = s < s_hi ? __ldcs(x_row + s) : -INFINITY;
          cls[u] = state_class(L, b, s, live);  // blank past the lattice
        }
#pragma unroll
        for (int u = 0; u < kGradBatch; ++u) {
          p[u] = expf((p[u] + nll_b) - __ldg(lp_row + cls[u]));
          cls[u] = p[u] != 0.0f ? cls[u] - c0 : -1;
          if (cls[u] >= cw) cls[u] = -1;
        }
#pragma unroll
        for (int u = 0; u < kGradBatch; ++u) {
          const bool mine = cls[u] >= 0;
          if (__ballot_sync(kFull, mine) == 0) continue;
          // a class with one member in the chunk adds it alone; the others
          // (the blanks, repeated labels) one class a pass, summed by a fixed
          // butterfly
          const unsigned peers = __match_any_sync(kFull, cls[u]);
          const bool alone = mine && __popc(peers) == 1;
          if (alone) acc[cls[u]] += p[u];
          unsigned todo = __ballot_sync(kFull, mine && !alone);
          while (todo) {
            const int leader = __ffs(todo) - 1;
            const int c = __shfl_sync(kFull, cls[u], leader);
            const bool member = mine && cls[u] == c;
            float v = member ? p[u] : 0.0f;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
            if (lane == leader) acc[c] += v;
            todo &= ~__ballot_sync(kFull, member);
          }
          __syncwarp();
        }
      }
      __syncthreads();
      for (int c1 = threadIdx.x; c1 < cw; c1 += blockDim.x * kGradBatch) {
        float e[kGradBatch];
#pragma unroll
        for (int u = 0; u < kGradBatch; ++u) {  // the row's reads in flight before its writes
          const int c = c1 + u * blockDim.x;
          e[u] = c < cw ? __ldg(lp_row + c0 + c) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kGradBatch; ++u) {
          const int c = c1 + u * blockDim.x;
          if (c >= cw) break;
          float sum = acc_all[c];
#pragma unroll
          for (int w = 1; w < kGradWarps; ++w) sum += acc_all[w * chunk + c];
          out[c0 + c] = (expf(e[u]) - sum) * g;
        }
      }
      __syncthreads();
    }
  }
}

bool partition_ok(const Lattice& L, int per_thread) {
  if (L.B < 1 || L.T < 1 || L.C < 1 || L.U < 1 || L.S2 != 2 * L.U + 1) return false;
  if (L.blank < 0 || L.blank >= L.C) return false;
  if (per_thread != 1 && per_thread != 2 && per_thread != 4) return false;
  if (L.threads < 32 || L.threads > kMaxThreads || L.threads % 32 != 0) return false;
  if (L.cluster < 1 || L.cluster > kMaxCluster || (L.cluster & (L.cluster - 1)) != 0) return false;
  if (L.tiles < 1) return false;
  const long long cover = static_cast<long long>(L.tiles) * L.cluster * L.threads * per_thread;
  return cover >= L.S2;
}

using LatticeKernel = void (*)(Lattice, float*, float*, float*, int*, int, int);

LatticeKernel lattice_kernel(int per_thread) {
  return per_thread == 1 ? ctc_lattice_kernel<1>
                         : (per_thread == 2 ? ctc_lattice_kernel<2> : ctc_lattice_kernel<4>);
}

// a launch of `clusters` clusters of the partition (cluster, 1, 1)
cudaLaunchConfig_t lattice_config(const Lattice& L, int per_thread, int clusters,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(L.cluster) * clusters, 1, 1);
  cfg.blockDim = dim3(L.threads, 1, 1);
  cfg.dynamicSmemBytes = lattice_smem_bytes(L.threads * per_thread);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// how many clusters of the partition the device holds at once
cudaError_t active_clusters(const Lattice& L, int per_thread, int* out) {
  LatticeKernel kernel = lattice_kernel(per_thread);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                                         L.cluster > 8 ? 1 : 0);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = lattice_config(L, per_thread, 1, nullptr, attr);
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

cudaError_t launch_lattice(const Lattice& L, int per_thread, int mode, int row0, int rows,
                           float* out, float* nll, float* edge, int* flags, cudaStream_t stream) {
  LatticeKernel kernel = lattice_kernel(per_thread);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                                         L.cluster > 8 ? 1 : 0);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      lattice_config(L, per_thread, mode == kBoth ? 2 * rows : rows, stream, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, L, out, nll, edge, flags, mode, row0);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

Lattice make_lattice(const void* lp, const void* labels, const void* input_lengths,
                     const void* label_lengths, int B, int T, int C, int U, int blank,
                     int cluster, int threads, int tiles) {
  Lattice L;
  L.lp = static_cast<const float*>(lp);
  L.labels = static_cast<const long long*>(labels);
  L.input_lengths = static_cast<const long long*>(input_lengths);
  L.label_lengths = static_cast<const long long*>(label_lengths);
  L.B = B, L.T = T, L.C = C, L.U = U, L.S2 = 2 * U + 1, L.blank = blank;
  L.cluster = cluster, L.threads = threads, L.tiles = tiles;
  return L;
}

}  // namespace

extern "C" {

// Each returns a cudaError_t (0 on success): the launch's own error, from
// cudaGetLastError() right after it; cudaErrorInvalidValue for a partition
// that does not cover the lattice or that the kernels are not built for.
// lp (B, T, C) fp32, labels (B, U) int64 (U >= 1), both lengths (B,) int64,
// all contiguous on one device; the partition (cluster, threads, per_thread,
// tiles) is `ctc_partition`'s (ops/ctc.py).

// alpha (B, T, 2U + 1) fp32: log-alpha; nll (B,) fp32: the raw nll (+inf
// where no alignment exists).  One launch.
int lcasr_ctc_alpha(const void* lp, const void* labels, const void* input_lengths,
                    const void* label_lengths, void* alpha, void* nll, int B, int T, int C,
                    int U, int blank, int cluster, int threads, int per_thread, int tiles,
                    void* stream) {
  const Lattice L = make_lattice(lp, labels, input_lengths, label_lengths, B, T, C, U, blank,
                                 cluster, threads, tiles);
  if (!partition_ok(L, per_thread)) return cudaErrorInvalidValue;
  return launch_lattice(L, per_thread, kAlphaOnly, 0, B, static_cast<float*>(alpha),
                        static_cast<float*>(nll), nullptr, nullptr,
                        static_cast<cudaStream_t>(stream));
}

// The nll (B,) and d sum_b nll[b] / d lp, grad (B, T, C), both fp32, with
// alpha + beta left in sums (B, T, 2U + 1) fp32 (the lattice's states);
// `edge` is (B, T, 2) fp32 scratch where tiles > 1, else null; `flags` B
// int32 zeros.  The rows go in groups of as many as the device holds two
// clusters of at once (one launch each: alpha and beta together, both
// resident, as their meeting needs), then one gradient launch.  A device
// that cannot hold two clusters of the partition at once gives
// cudaErrorInvalidConfiguration (an H100 holds seven of 16 x 960 threads).
int lcasr_ctc_lattice(const void* lp, const void* labels, const void* input_lengths,
                      const void* label_lengths, void* sums, void* nll, void* grad, void* edge,
                      void* flags, int B, int T, int C, int U, int blank, int cluster,
                      int threads, int per_thread, int tiles, void* stream) {
  const Lattice L = make_lattice(lp, labels, input_lengths, label_lengths, B, T, C, U, blank,
                                 cluster, threads, tiles);
  if (!partition_ok(L, per_thread) || (tiles > 1 && edge == nullptr) || flags == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* x = static_cast<float*>(sums);
  float* n = static_cast<float*>(nll);
  float* e = static_cast<float*>(edge);
  int* f = static_cast<int*>(flags);
  int fit = 0;
  cudaError_t err = active_clusters(L, per_thread, &fit);
  if (err != cudaSuccess) return err;
  const int rows = fit / 2;
  if (rows < 1) return cudaErrorInvalidConfiguration;
  for (int r0 = 0; r0 < B && err == cudaSuccess; r0 += rows)
    err = launch_lattice(L, per_thread, kBoth, r0, B - r0 < rows ? B - r0 : rows, x, n, e, f, s);
  if (err != cudaSuccess) return err;

  const int chunk = C < kGradClasses ? C : kGradClasses;
  const size_t smem = static_cast<size_t>(kGradWarps) * chunk * sizeof(float);
  err = cudaFuncSetAttribute(ctc_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ctc_grad_kernel,
                                                           kGradWarps * 32, smem)) != cudaSuccess)
    return err;
  const long long all_rows = static_cast<long long>(B) * T;
  const long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(all_rows < blocks ? all_rows : blocks);
  ctc_grad_kernel<<<grid, kGradWarps * 32, smem, s>>>(L, x, n, nullptr,
                                                      static_cast<float*>(grad), chunk);
  return cudaGetLastError();
}

// The number of clusters of the partition that the device can hold at once
// (cudaOccupancyMaxActiveClusters), into *out; 0 means it cannot launch.
int lcasr_ctc_active_clusters(int cluster, int threads, int per_thread, int* out) {
  Lattice L = {};
  L.cluster = cluster, L.threads = threads;
  return active_clusters(L, per_thread, out);
}

const char* lcasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
