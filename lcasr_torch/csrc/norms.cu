// Row norms for Hopper (sm_90a): LayerNorm and RMSNorm over the last
// dimension, forward and backward, with a plain C interface that
// lcasr_torch/kernels.py loads through ctypes.  Its wrapper is `ops/norms.py`
// (`_RowNorm`); CPU tensors take the plain versions there (`layer_norm_ref`,
// `rms_norm_ref`).
//
// Replaces no TPU kernel: the JAX package leaves its norms
// (lcasr_tpu/ops/norms.py) to XLA, which fuses them; it has no Pallas body
// for them.  It was added because the port's eager fp32 chain runs a norm as
// some ten kernels, each a full pass over the activations: ~68 bytes of
// device memory an element for LayerNorm where the function needs 4 (bf16 in,
// bf16 out), and that chain held a third of the decode's device time.
//
// Bound on the H100: bytes.  A forward moves rows x D x (input bytes +
// output bytes), plus two fp32 statistics a row where a gradient is wanted;
// a backward reads x and dy and writes dx (3 x 2 bytes an element in bf16).
// The arithmetic is a few operations an element, far below the card's
// rate.  At (32768, 768) bf16 the forward's 100.7 MB take 30 us at 3.35 TB/s.
//
// Design.  Rows of D <= 1024 (every width the models run) go one to a warp:
// a lane holds E = 8, 16, 24 or 32 elements of the row in registers as
// 16-byte packs (lane l owns packs l, l + 32, ...: each load and store is
// coalesced), the row's sums are warp butterflies (no shared memory, no
// barrier), and the row is read once and written once.  Blocks of four warps
// are persistent and stride over the rows, so a warp loads the fp32 scale and
// bias into registers once; it loads its next row while it normalises the
// current one, and `__launch_bounds__` holds the registers to what several
// blocks an SM need (`warp_min_blocks`, mirrored by `ops/norms.py`), so that
// enough rows are in flight to keep device memory busy.  Rows of
// 1024 < D <= 16384 go one to a block of up to 512 threads, the same code
// with the sums finished across warps in shared memory.
//
// Arithmetic is the eager code's: fp32 statistics, two passes over the
// registers (the mean, then the mean of squared deviations; RMSNorm the mean
// of squares), rstd = 1 / sqrtf(var + eps) with IEEE division and square
// root, y = (x - mean) * rstd * scale + bias one rounding an operation in
// that order (no contraction into FMAs), then one rounding to the input's
// dtype.  Only the order of the row sums differs.
//
// Backward: dx = rstd (dy g - mean(dy g) - x^ mean(dy g x^)) (RMSNorm without
// the middle term), x^ recomputed from x and the saved mean and rstd.  Each
// block sums its rows' dscale = dy x^ and dbias = dy by column, in its
// warps' order, into a (blocks, D) fp32 buffer, and a second kernel sums
// that over the blocks in a fixed order: no atomics, the same bits each run.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpThreads = 128;  // four warps, a row each
constexpr int kBlockThreads = 512;  // at most, a row a block
constexpr int kFP32 = 0, kBF16 = 1, kFP16 = 2;  // dtype codes of the wrapper

// Registers a thread: the cached scale and bias (and, backward, the column
// sums), two rows of packs, and ~40 of addresses and temporaries; blocks of
// kWarpThreads an SM that the register file holds at that count.
__host__ __device__ constexpr int warp_min_blocks(int E, int bytes, bool bwd) {
  const int regs = ((bwd ? 3 * E : 2 * E) + 2 * E * bytes / 4 + 40 + 7) / 8 * 8;
  const int b = 65536 / (kWarpThreads * regs);
  return b < 1 ? 1 : (b > 16 ? 16 : b);
}

template <typename T>
struct alignas(16) Pack {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) { return __float2half_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sum over a row's group: a warp, or (BLOCK) the whole block, whose warp
// sums every warp adds again in the same order; `red` holds 32 floats.
template <bool BLOCK>
__device__ __forceinline__ float group_sum(float v, float* red) {
  v = warp_sum(v);
  if constexpr (BLOCK) {
    const int lane = threadIdx.x & 31;
    __syncthreads();  // the last sum's readers are done with red
    if (lane == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    v = warp_sum(lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f);
  }
  return v;
}

// Where a thread's packs lie: lane (or thread) t of a group of `lanes` owns
// packs t, t + lanes, ... of the row.
struct Group {
  int lanes, t;
  long long first, stride;  // the group's first row, and the rows between its rows
};

template <bool BLOCK>
__device__ __forceinline__ Group group() {
  if constexpr (BLOCK) {
    return {static_cast<int>(blockDim.x), static_cast<int>(threadIdx.x),
            static_cast<long long>(blockIdx.x), static_cast<long long>(gridDim.x)};
  } else {
    const int warps = blockDim.x >> 5;
    return {32, static_cast<int>(threadIdx.x & 31),
            static_cast<long long>(blockIdx.x) * warps + (threadIdx.x >> 5),
            static_cast<long long>(gridDim.x) * warps};
  }
}

template <typename T, int NP>
__device__ __forceinline__ void load_row(Pack<T> (&p)[NP], const T* row, const Group& g,
                                         int packs) {
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int q = j * g.lanes + g.t;
    if (q < packs) p[j] = reinterpret_cast<const Pack<T>*>(row)[q];
  }
}

// E fp32 values of a parameter vector at the thread's packs (0 where there
// is none), loaded once a kernel and one by one: a parameter may be a view
// at any offset of a flat buffer (ZeRO's).
template <int E, int V>
__device__ __forceinline__ void load_param(float (&w)[E], const float* src, const Group& g,
                                           int packs) {
#pragma unroll
  for (int j = 0; j < E / V; ++j) {
    const int q = j * g.lanes + g.t;
#pragma unroll
    for (int k = 0; k < V; ++k) w[j * V + k] = (src != nullptr && q < packs) ? src[q * V + k] : 0.f;
  }
}

// x^ of one value, rounded as the forward rounds it
__device__ __forceinline__ float normed(float x, float mean, float rstd, bool rms) {
  return rms ? __fmul_rn(x, rstd) : __fmul_rn(__fsub_rn(x, mean), rstd);
}

template <typename T, int E, bool BLOCK>
__global__ void __launch_bounds__(BLOCK ? kBlockThreads : kWarpThreads,
                                  BLOCK ? 1 : warp_min_blocks(E, sizeof(T), false))
    row_norm_fwd(const T* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, T* __restrict__ y, float* __restrict__ mean_out,
                 float* __restrict__ rstd_out, long long rows, int D, float eps, bool rms) {
  constexpr int V = Pack<T>::kN, NP = E / V;
  static_assert(E % V == 0, "a thread holds whole packs");
  __shared__ float red[32];
  const Group g = group<BLOCK>();
  const int packs = D / V;
  float w[E], b[E];
  load_param<E, V>(w, scale, g, packs);
  load_param<E, V>(b, rms ? nullptr : bias, g, packs);

  Pack<T> cur[NP], nxt[NP];
  long long r = g.first;
  if (r < rows) load_row(cur, x + r * D, g, packs);
  for (; r < rows; r += g.stride) {
    if (r + g.stride < rows) load_row(nxt, x + (r + g.stride) * D, g, packs);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (j * g.lanes + g.t < packs) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float v = to_float(cur[j].v[k]);
          s += rms ? __fmul_rn(v, v) : v;
        }
      }
    }
    s = group_sum<BLOCK>(s, red);
    float mean = 0.f, var = s / D;
    if (!rms) {
      mean = var;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        if (j * g.lanes + g.t < packs) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float d = __fsub_rn(to_float(cur[j].v[k]), mean);
            q += __fmul_rn(d, d);
          }
        }
      }
      var = group_sum<BLOCK>(q, red) / D;
    }
    const float rstd = 1.0f / sqrtf(var + eps);
    T* yr = y + r * D;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int q = j * g.lanes + g.t;
      if (q < packs) {
        Pack<T> o;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          float v = __fmul_rn(normed(to_float(cur[j].v[k]), mean, rstd, rms), w[j * V + k]);
          if (!rms) v = __fadd_rn(v, b[j * V + k]);
          o.v[k] = from_float<T>(v);
        }
        reinterpret_cast<Pack<T>*>(yr)[q] = o;
      }
    }
    if (rstd_out != nullptr && g.t == 0) {
      if (mean_out != nullptr) mean_out[r] = mean;
      rstd_out[r] = rstd;
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) cur[j] = nxt[j];
  }
}

template <typename T, int E, bool BLOCK>
__global__ void __launch_bounds__(BLOCK ? kBlockThreads : kWarpThreads,
                                  BLOCK ? 1 : warp_min_blocks(E, sizeof(T), true))
    row_norm_bwd(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                 const float* __restrict__ scale, T* __restrict__ dx,
                 float* __restrict__ dscale_part, float* __restrict__ dbias_part, long long rows,
                 int D, bool rms) {
  constexpr int V = Pack<T>::kN, NP = E / V;
  __shared__ float red[32];
  extern __shared__ float cols[];  // warp rows: (warps, D), a warp's column sums
  const Group g = group<BLOCK>();
  const int packs = D / V;
  float w[E], ds[E], db[E];
  load_param<E, V>(w, scale, g, packs);
#pragma unroll
  for (int e = 0; e < E; ++e) ds[e] = 0.f, db[e] = 0.f;

  for (long long r = g.first; r < rows; r += g.stride) {
    Pack<T> xp[NP], gp[NP];
    load_row(xp, x + r * D, g, packs);
    load_row(gp, dy + r * D, g, packs);
    const float mean = rms ? 0.f : mean_in[r], rstd = rstd_in[r];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (j * g.lanes + g.t < packs) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float h = normed(to_float(xp[j].v[k]), mean, rstd, rms);
          const float d = to_float(gp[j].v[k]);
          const float gd = d * w[j * V + k];
          s1 += gd;
          s2 += gd * h;
          ds[j * V + k] += d * h;
          db[j * V + k] += d;
        }
      }
    }
    s1 = group_sum<BLOCK>(s1, red) / D;
    s2 = group_sum<BLOCK>(s2, red) / D;
    T* dxr = dx + r * D;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int q = j * g.lanes + g.t;
      if (q < packs) {
        Pack<T> o;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float h = normed(to_float(xp[j].v[k]), mean, rstd, rms);
          const float gd = to_float(gp[j].v[k]) * w[j * V + k];
          o.v[k] = from_float<T>(rstd * ((rms ? gd : gd - s1) - h * s2));
        }
        reinterpret_cast<Pack<T>*>(dxr)[q] = o;
      }
    }
  }

  // The block's column sums: a block row's thread owns its columns alone;
  // the warps of a warp-row block add theirs in warp order.
  float* parts[2] = {dscale_part + static_cast<long long>(blockIdx.x) * D,
                     rms ? nullptr : dbias_part + static_cast<long long>(blockIdx.x) * D};
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    if (parts[which] == nullptr) continue;
    const float* acc = which == 0 ? ds : db;
    float* dst = BLOCK ? parts[which] : cols + (threadIdx.x >> 5) * D;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int q = j * g.lanes + g.t;
      if (q < packs) {
#pragma unroll
        for (int k = 0; k < V; ++k) dst[q * V + k] = acc[j * V + k];
      }
    }
    if constexpr (!BLOCK) {
      __syncthreads();
      const int warps = blockDim.x >> 5;
      for (int c = threadIdx.x; c < D; c += blockDim.x) {
        float s = 0.f;
        for (int wi = 0; wi < warps; ++wi) s += cols[wi * D + c];
        parts[which][c] = s;
      }
      __syncthreads();
    }
  }
}

// out[c] = sum over g of part[g, c], in order of g: 32 columns a block, 32
// slices of the blocks' rows summed in order, then the slices in order.
__global__ void __launch_bounds__(1024) column_sum(const float* __restrict__ part,
                                                   float* __restrict__ out, int G, int D) {
  __shared__ float acc[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (c < D)
    for (int i = threadIdx.y; i < G; i += 32) s += part[static_cast<long long>(i) * D + c];
  acc[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < D) {
    float t = 0.f;
    for (int i = 0; i < 32; ++i) t += acc[i][threadIdx.x];
    out[c] = t;
  }
}

// One launch shape: rows of warps (E in {8, 16, 24, 32}, 128 threads) or of
// blocks (E in {8, 16, 32}, 32..512 threads); it must cover D with whole
// 16-byte packs.
bool shape_ok(int dtype, int D, int E, bool block, int threads, int grid) {
  if (dtype != kFP32 && dtype != kBF16 && dtype != kFP16) return false;
  const int V = dtype == kFP32 ? 4 : 8;
  if (D < 1 || D % V != 0 || grid < 1) return false;
  if (block) {
    if (E != 8 && E != 16 && E != 32) return false;
    if (threads < 32 || threads > kBlockThreads || threads % 32 != 0) return false;
    return static_cast<long long>(threads) * E >= D;
  }
  if (E != 8 && E != 16 && E != 24 && E != 32) return false;
  return threads == kWarpThreads && 32 * E >= D;
}

struct FwdArgs {
  const void* x;
  const float* scale;
  const float* bias;
  void* y;
  float* mean;
  float* rstd;
  long long rows;
  int D;
  float eps;
  bool rms;
};

template <typename T, int E, bool BLOCK>
cudaError_t fwd(const FwdArgs& a, int threads, int grid, cudaStream_t s) {
  row_norm_fwd<T, E, BLOCK><<<grid, threads, 0, s>>>(
      static_cast<const T*>(a.x), a.scale, a.bias, static_cast<T*>(a.y), a.mean, a.rstd, a.rows,
      a.D, a.eps, a.rms);
  return cudaGetLastError();
}

struct BwdArgs {
  const void* x;
  const void* dy;
  const float* mean;
  const float* rstd;
  const float* scale;
  void* dx;
  float* dscale_part;
  float* dbias_part;
  long long rows;
  int D;
  bool rms;
};

template <typename T, int E, bool BLOCK>
cudaError_t bwd(const BwdArgs& a, int threads, int grid, cudaStream_t s) {
  const size_t smem = BLOCK ? 0 : static_cast<size_t>(threads / 32) * a.D * sizeof(float);
  row_norm_bwd<T, E, BLOCK><<<grid, threads, smem, s>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dy), a.mean, a.rstd, a.scale,
      static_cast<T*>(a.dx), a.dscale_part, a.dbias_part, a.rows, a.D, a.rms);
  return cudaGetLastError();
}

// The kernel for (E, mode) of one dtype, as `Op<T, E, BLOCK>::run(...)`.
template <template <typename, int, bool> class Op, typename T, typename... Args>
cudaError_t dispatch_e(int E, bool block, Args&&... args) {
  if (block) {
    switch (E) {
      case 8: return Op<T, 8, true>::run(args...);
      case 16: return Op<T, 16, true>::run(args...);
      case 32: return Op<T, 32, true>::run(args...);
    }
  } else {
    switch (E) {
      case 8: return Op<T, 8, false>::run(args...);
      case 16: return Op<T, 16, false>::run(args...);
      case 24: return Op<T, 24, false>::run(args...);
      case 32: return Op<T, 32, false>::run(args...);
    }
  }
  return cudaErrorInvalidValue;
}

template <template <typename, int, bool> class Op, typename... Args>
cudaError_t dispatch(int dtype, int E, bool block, Args&&... args) {
  switch (dtype) {
    case kFP32: return dispatch_e<Op, float>(E, block, args...);
    case kBF16: return dispatch_e<Op, __nv_bfloat16>(E, block, args...);
    case kFP16: return dispatch_e<Op, __half>(E, block, args...);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int E, bool BLOCK>
struct FwdOp {
  static cudaError_t run(const FwdArgs& a, int threads, int grid, cudaStream_t s) {
    return fwd<T, E, BLOCK>(a, threads, grid, s);
  }
};

template <typename T, int E, bool BLOCK>
struct BwdOp {
  static cudaError_t run(const BwdArgs& a, int threads, int grid, cudaStream_t s) {
    return bwd<T, E, BLOCK>(a, threads, grid, s);
  }
};

template <typename T, int E, bool BLOCK>
struct OccupancyOp {
  static cudaError_t run(bool backward, int threads, int* out) {
    const size_t smem = (backward && !BLOCK) ? static_cast<size_t>(threads / 32) * 32 * E *
                                                   sizeof(float)
                                             : 0;
    return backward ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          out, row_norm_bwd<T, E, BLOCK>, threads, smem)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          out, row_norm_fwd<T, E, BLOCK>, threads, 0);
  }
};

}  // namespace

extern "C" {

// Each returns a cudaError_t (0 on success): the launch's own error, from
// cudaGetLastError() right after it; cudaErrorInvalidValue for a launch shape
// that does not cover D or that the kernels are not built for.  x (rows, D)
// of `dtype` (0 fp32, 1 bf16, 2 fp16), contiguous and 16-byte aligned, D a
// multiple of 16 bytes; scale and bias (D,) fp32, 4-byte aligned; everything
// on one device.
// The launch shape (elems a thread, block rows, threads, grid) is
// `ops/norms.py`'s `norm_launch`.

// y (rows, D) of x's dtype; with rms the norm is RMSNorm and bias and mean are
// not read or written.  mean and rstd (rows,) fp32, or null where no gradient
// is wanted (rstd null: neither is written).
int lcasr_row_norm_fwd(const void* x, const void* scale, const void* bias, void* y, void* mean,
                       void* rstd, long long rows, int D, float eps, int rms, int dtype,
                       int elems, int block_rows, int threads, int grid, void* stream) {
  if (!shape_ok(dtype, D, elems, block_rows != 0, threads, grid) || rows < 1)
    return cudaErrorInvalidValue;
  const FwdArgs a = {x, static_cast<const float*>(scale), static_cast<const float*>(bias), y,
                     static_cast<float*>(mean), static_cast<float*>(rstd), rows, D, eps,
                     rms != 0};
  return dispatch<FwdOp>(dtype, elems, block_rows != 0, a, threads, grid,
                         static_cast<cudaStream_t>(stream));
}

// dx (rows, D) of x's dtype from x, dy (rows, D), the forward's mean and rstd
// (rows,) and scale; dscale (D,) and, without rms, dbias (D,) fp32, summed
// through part (2, grid, D) fp32 scratch.  Two launches (three without rms).
int lcasr_row_norm_bwd(const void* x, const void* dy, const void* mean, const void* rstd,
                       const void* scale, void* dx, void* dscale, void* dbias, void* part,
                       long long rows, int D, int rms, int dtype, int elems, int block_rows,
                       int threads, int grid, void* stream) {
  if (!shape_ok(dtype, D, elems, block_rows != 0, threads, grid) || rows < 1)
    return cudaErrorInvalidValue;
  float* p = static_cast<float*>(part);
  const long long plane = static_cast<long long>(grid) * D;
  const BwdArgs a = {x, dy, static_cast<const float*>(mean), static_cast<const float*>(rstd),
                     static_cast<const float*>(scale), dx, p, rms ? nullptr : p + plane, rows, D,
                     rms != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dispatch<BwdOp>(dtype, elems, block_rows != 0, a, threads, grid, s);
  const dim3 sum_block(32, 32), sum_grid((D + 31) / 32);
  if (err == cudaSuccess) {
    column_sum<<<sum_grid, sum_block, 0, s>>>(p, static_cast<float*>(dscale), grid, D);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess && !rms) {
    column_sum<<<sum_grid, sum_block, 0, s>>>(p + plane, static_cast<float*>(dbias), grid, D);
    err = cudaGetLastError();
  }
  return err;
}

// Blocks of `threads` an SM that the device holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) for the forward or the
// backward of one launch shape, at the widest D it covers, into *out.
int lcasr_row_norm_blocks_per_sm(int dtype, int elems, int block_rows, int threads, int backward,
                                 int* out) {
  const int D = block_rows ? threads * elems : 32 * elems;
  if (!shape_ok(dtype, D, elems, block_rows != 0, threads, 1))
    return cudaErrorInvalidValue;
  return dispatch<OccupancyOp>(dtype, elems, block_rows != 0, backward != 0, threads, out);
}

const char* lcasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
