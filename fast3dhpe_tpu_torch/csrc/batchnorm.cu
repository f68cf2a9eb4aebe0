// Train-mode BatchNorm, forward and backward, for Hopper (sm_90a): fp32 or
// bf16 activations, every statistic and every per-channel number in fp32,
// the outputs in the activations' type.
//
// Replaces no TPU kernel: the JAX package leaves its masked BatchNorm
// (flax's `_compute_stats` and `_normalize`, fast3dhpe_tpu/models/layers.py)
// to XLA's fusion. Its plain version, the same arithmetic in eager PyTorch,
// is ops/batchnorm.py `plain_forward` / `plain_backward`, which the wrapper
// runs on CPU tensors. For each channel over the rows that `mask` marks
// valid (rows x positions; no mask: every row), with m the row's mask:
//   s1 = sum m x,  s2 = sum m x x,  count = (sum m) * positions
//   mean = s1 / count,  var_raw = s2 / count - mean^2,  var = max(var_raw, 0)
//   r = rsqrt(var + eps),  y = (x - mean) * (r w) + b       (every row)
// and backward, with s = sum dy (x - mean) and dbias = sum dy over every row:
//   dweight = s r,  g = w r,  dvar = var_raw > 0 ? -s w r^3 / 2 : 0,
//   dmean = -dbias g - 2 mean dvar,
//   dx = dy g + m (dmean / count + x 2 dvar / count)
// (bf16: dx is the bf16 sum of the two parts, each rounded to bf16). The
// products, quotients and sums of the formulas round where the plain
// version's materialised tensors round (__fmul_rn and its kin: no
// contraction into fused multiply-adds); only the order of the sums over
// rows differs.
//
// What bounds them on the H100: memory. A layer's activations are read or
// written 8 times in all: the statistics read x; the normalisation reads x
// and writes y; the backward's reduction reads dy and x; dx reads dy and x
// and writes dx. Nothing else touches a tensor of the activations' size
// (the eager version makes ~31 such passes). At CDRNet-101's stem (64
// images of 128 x 128 x 64, fp32, 268 MB) the bound is 0.080 ms forward
// and 0.240 ms backward at 3.35 TB/s.
//
// The passes, five kernels, each named train_bn_* (the benchmark counts
// kernels by that prefix):
//   train_bn_stats        x -> per-block partial (s1, s2) per channel
//   train_bn_finish       the partials -> one packed fp32 vector in a fixed
//                         order: forward (s1 | s2 | count), backward
//                         (s | dbias) plus dweight and dbias
//   train_bn_norm         its prologue finishes the statistics per channel
//                         (block 0 writes mean, var, r, var_raw > 0); y
//   train_bn_grad_reduce  dy, x -> per-block partial (s, dbias)
//   train_bn_grad         its prologue forms g, dmean / count and
//                         2 dvar / count per channel; dx
// Under a process group the caller all-reduces the packed vector between
// train_bn_finish and the kernel after it (forward: the norm; backward: the
// grad), so the statistics and dx take the ranks' rows together.
//
// Deterministic: every sum runs in an order fixed by the launch plan, which
// is fixed by the shape: a thread's running sums over its rows, then the
// block's threads in a fixed order, then train_bn_finish over the blocks in
// block order. No float atomics, so repeated steps and graph replays give
// the same bits. The sequential sums are compensated (Kahan), still in
// fp32: their order is not the plain version's (PyTorch's reductions), so
// their rounding errors do not cancel against a reference that sums in
// PyTorch's order, and E[x^2] - E[x]^2 and the backward's sums magnify
// them. Uncompensated, the volumetric cell's largest step-0 gradient gap
// over 15 seeds was 0.116 of its 0.12 limit; compensated 0.060, the
// plain version's 0.061 (PERF.md).
//
// Two launch plans, chosen by ops/batchnorm.py from x's strides, over one
// set of kernels (the template parameter L):
//   - rows (kRows): channels innermost (NCHW in channels_last memory, or
//     NCDHW in channels_last_3d), an (M = N * positions, C) matrix. A block
//     spans `tile` channel vectors of V elements (16 bytes: 4 fp32 or 8
//     bf16; V = 1 where C * bytes is not a multiple of 16) and `lanes` row
//     lanes, tile * lanes <= 256, and walks a slab of `span` rows; a warp's
//     16-byte loads cover consecutive bytes of one or more rows. Thread
//     (lane, col) keeps V channels' sums in registers over rows
//     lane, lane + lanes, ...; the block sums its lanes in lane order in
//     shared memory and writes one partial row of its channels.
//   - planes (kPlanes): contiguous (N, C, positions), each (sample,
//     channel) plane contiguous (the V2V's NCDHW volumes). A block takes one
//     channel and a run of `span` vectors of that channel's N planes in
//     order; its threads' sums meet in a warp butterfly and then the warps
//     in order.
// The wrapper sizes the grid to one wave of kBlocksPerSm blocks on each of
// the 132 SMs where the tensor allows: a small late layer (4,096 rows x
// 2,048 channels) still fills the card, and a large early one (1 M rows x
// 64 channels) keeps kUnroll 16-byte loads a thread in flight.
//
// Launches go on the caller's stream; the wrapper allocates every buffer.
// Each entry checks its plan and pointers and returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;          // threads a block, every kernel
constexpr int kVecBytes = 16;          // bytes of one load
constexpr int kMaxTileVec = 32;        // rows: channel vectors a block spans
constexpr int kUnroll = 4;             // loads a thread issues at once
constexpr int kBlocksPerSm = 2;        // blocks an SM holds (launch bounds)
constexpr int kFinishCols = 32;        // train_bn_finish: channels a block
constexpr int kFinishLanes = kThreads / kFinishCols;
constexpr int kMaxVec = kVecBytes / 2;  // elements of a vector, bf16
constexpr int kMaxGridY = 65535;

enum Layout { kRows = 0, kPlanes = 1 };

struct Plan {
  int n, c, s;      // samples, channels, positions a sample and channel
  int tile, lanes;  // rows: channel vectors and row lanes a block;
                    // planes: 1 and kThreads
  int span;         // rows a block (rows), vectors a block (planes)
  int blocks;       // blocks along the rows or a channel: partial rows
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back (the identity for fp32)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

template <typename T>
__host__ __device__ constexpr int full_vec() {
  return kVecBytes / (int)sizeof(T);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// One load of V elements as they lie in memory: a 16-byte vector, or one
// element where V is 1. get(i) widens element i to fp32.
template <typename T, int V, bool kWide = (V == full_vec<T>() && V > 1)>
struct Raw {
  T v;
  __device__ __forceinline__ void load(const T* p) { v = *p; }
  __device__ __forceinline__ float get(int) const { return to_f(v); }
};

template <typename T, int V>
struct Raw<T, V, true> {
  uint4 v;
  __device__ __forceinline__ void load(const T* p) {
    v = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ float get(int i) const {
    if constexpr (std::is_same<T, float>::value) {
      return __uint_as_float(word(v, i));
    } else {
      const uint32_t w = word(v, i >> 1);
      return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
    }
  }
};

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&o)[V]) {
  if constexpr (V == full_vec<T>() && V > 1) {
    uint32_t w[4];
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = __float_as_uint(o[k]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = (uint32_t)__bfloat16_as_ushort(from_f<bf16>(o[2 * k])) |
               ((uint32_t)__bfloat16_as_ushort(from_f<bf16>(o[2 * k + 1]))
                << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = from_f<T>(o[i]);
  }
}

// s += v with Kahan's compensation c (minus the low-order bits that s has
// lost): a sum over many rows keeps the error of a few additions. The
// result is s - c.
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float y = __fsub_rn(v, c);
  const float t = __fadd_rn(s, y);
  c = __fsub_rn(__fsub_rn(t, s), y);
  s = t;
}

// The channel of element i of this thread's vectors; C or more for a
// thread of a rows block past the last channel.
template <int L, int V>
__device__ __forceinline__ int channel_of(const Plan& p, int i) {
  if constexpr (L == kRows) {
    const int lane = threadIdx.x / p.tile;
    const int col = threadIdx.x - lane * p.tile;
    return ((int)blockIdx.y * p.tile + col) * V + i;
  } else {
    return blockIdx.y;
  }
}

template <int L>
__device__ __forceinline__ bool first_lane(const Plan& p) {
  if constexpr (L == kRows) return threadIdx.x < (unsigned)p.tile;
  else return threadIdx.x == 0;
}

// Walks this thread's vectors in a fixed order, kUnroll at a time, calling
// f(off, smp, ok): the element offset of each vector, its sample (computed
// only if kSample) and whether it exists.
template <int L, int V, bool kSample, typename F>
__device__ __forceinline__ void walk(const Plan& p, F&& f) {
  size_t off[kUnroll];
  int smp[kUnroll];
  bool ok[kUnroll];
  if constexpr (L == kRows) {
    const int lane = threadIdx.x / p.tile;
    const int col = threadIdx.x - lane * p.tile;
    const int c0 = ((int)blockIdx.y * p.tile + col) * V;
    if (lane >= p.lanes || c0 >= p.c) return;
    const int rows = p.n * p.s;
    const int r0 = (int)blockIdx.x * p.span;
    const int r1 = min(r0 + p.span, rows);
    for (int r = r0 + lane; r < r1; r += kUnroll * p.lanes) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int rr = r + u * p.lanes;
        ok[u] = rr < r1;
        off[u] = (size_t)rr * p.c + c0;
        smp[u] = kSample ? rr / p.s : 0;
      }
      f(off, smp, ok);
    }
  } else {
    const int ch = blockIdx.y;
    const int sv = p.s / V;
    const int total = p.n * sv;
    const int v0 = (int)blockIdx.x * p.span;
    const int v1 = min(v0 + p.span, total);
    for (int v = v0 + (int)threadIdx.x; v < v1; v += kUnroll * kThreads) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int vv = v + u * kThreads;
        ok[u] = vv < v1;
        const int n = vv / sv;
        smp[u] = n;
        off[u] = ((size_t)n * p.c + ch) * p.s + (size_t)(vv - n * sv) * V;
      }
      f(off, smp, ok);
    }
  }
}

// The block's sums (a, b) of its channels into row blockIdx.x of the
// partials, laid out (2, blocks, C): a in the first half, b in the second.
template <int L, int V>
__device__ __forceinline__ void block_partials(const float (&a)[V],
                                               const float (&b)[V],
                                               const Plan& p,
                                               float* __restrict__ part) {
  float* pa = part + (size_t)blockIdx.x * p.c;
  float* pb = part + ((size_t)p.blocks + blockIdx.x) * p.c;
  if constexpr (L == kRows) {
    __shared__ float red[2][kThreads * kMaxVec];
    const int lane = threadIdx.x / p.tile;
    const int col = threadIdx.x - lane * p.tile;
    const int width = p.tile * V;
    if (lane < p.lanes) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        red[0][lane * width + col * V + i] = a[i];
        red[1][lane * width + col * V + i] = b[i];
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < width; k += kThreads) {
      float sa = 0.f, sb = 0.f, ca = 0.f, cb = 0.f;
      for (int l = 0; l < p.lanes; ++l) {
        kahan_add(sa, ca, red[0][l * width + k]);
        kahan_add(sb, cb, red[1][l * width + k]);
      }
      const int ch = (int)blockIdx.y * width + k;
      if (ch < p.c) {
        pa[ch] = __fsub_rn(sa, ca);
        pb[ch] = __fsub_rn(sb, cb);
      }
    }
  } else {
    __shared__ float red[2][kThreads / 32];
    float sa = 0.f, sb = 0.f, ca = 0.f, cb = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      kahan_add(sa, ca, a[i]);
      kahan_add(sb, cb, b[i]);
    }
    sa = __fsub_rn(sa, ca);
    sb = __fsub_rn(sb, cb);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      sa = __fadd_rn(sa, __shfl_xor_sync(0xffffffffu, sa, d));
      sb = __fadd_rn(sb, __shfl_xor_sync(0xffffffffu, sb, d));
    }
    if ((threadIdx.x & 31) == 0) {
      red[0][threadIdx.x >> 5] = sa;
      red[1][threadIdx.x >> 5] = sb;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float ta = 0.f, tb = 0.f, ca2 = 0.f, cb2 = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) {
        kahan_add(ta, ca2, red[0][w]);
        kahan_add(tb, cb2, red[1][w]);
      }
      pa[blockIdx.y] = __fsub_rn(ta, ca2);
      pb[blockIdx.y] = __fsub_rn(tb, cb2);
    }
  }
}

// Forward: partial (sum m x, sum m x x) of each channel. Backward:
// partial (sum dy (x - mean), sum dy).
template <typename T, int V, int L, bool kGrad>
__device__ __forceinline__ void reduce_pass(const T* __restrict__ x,
                                            const T* __restrict__ dy,
                                            const float* __restrict__ mask,
                                            const float* __restrict__ mean,
                                            const Plan& p,
                                            float* __restrict__ part) {
  float a[V], b[V], ca[V], cb[V], mu[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    a[i] = b[i] = ca[i] = cb[i] = 0.f;
    mu[i] = kGrad ? mean[min(channel_of<L, V>(p, i), p.c - 1)] : 0.f;
  }
  const bool masked = mask != nullptr;
  walk<L, V, !kGrad>(p, [&](const size_t (&off)[kUnroll],
                            const int (&smp)[kUnroll],
                            const bool (&ok)[kUnroll]) {
    Raw<T, V> xr[kUnroll], gr[kUnroll];
    float m[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
      xr[u].load(x + off[u]);
      if constexpr (kGrad) gr[u].load(dy + off[u]);
      else m[u] = masked ? mask[smp[u]] : 1.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xv = xr[u].get(i);
        if constexpr (kGrad) {
          const float g = gr[u].get(i);
          kahan_add(a[i], ca[i], __fmul_rn(g, __fsub_rn(xv, mu[i])));
          kahan_add(b[i], cb[i], g);
        } else {
          const float xm = __fmul_rn(xv, m[u]);
          kahan_add(a[i], ca[i], xm);
          kahan_add(b[i], cb[i], __fmul_rn(xm, xv));
        }
      }
    }
  });
#pragma unroll
  for (int i = 0; i < V; ++i) {
    a[i] = __fsub_rn(a[i], ca[i]);
    b[i] = __fsub_rn(b[i], cb[i]);
  }
  block_partials<L, V>(a, b, p, part);
}

template <typename T, int V, int L>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
train_bn_stats(const T* __restrict__ x, const float* __restrict__ mask,
               Plan p, float* __restrict__ part) {
  reduce_pass<T, V, L, false>(x, nullptr, mask, nullptr, p, part);
}

template <typename T, int V, int L>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
train_bn_grad_reduce(const T* __restrict__ dy, const T* __restrict__ x,
                     const float* __restrict__ mean, Plan p,
                     float* __restrict__ part) {
  reduce_pass<T, V, L, true>(x, dy, nullptr, mean, p, part);
}

// The partials (2, blocks, C) summed over the blocks in block order into
// packed[0:C] and packed[C:2C]. Forward (r null): packed[2C] = count, the
// masked rows times the positions (every row without a mask). Backward:
// dweight = packed[0:C] * r and dbias = packed[C:2C], the rank's own.
__global__ void __launch_bounds__(kThreads)
train_bn_finish(const float* __restrict__ part, int blocks, int C,
                const float* __restrict__ mask, int n, int s,
                const float* __restrict__ r, float* __restrict__ packed,
                float* __restrict__ dweight, float* __restrict__ dbias) {
  __shared__ float red[2][kFinishLanes][kFinishCols];
  const int col = threadIdx.x % kFinishCols;
  const int lane = threadIdx.x / kFinishCols;
  const int c = (int)blockIdx.x * kFinishCols + col;
  float sa = 0.f, sb = 0.f, ca = 0.f, cb = 0.f;
  if (c < C) {
    for (int k = lane; k < blocks; k += kFinishLanes) {
      kahan_add(sa, ca, part[(size_t)k * C + c]);
      kahan_add(sb, cb, part[((size_t)blocks + k) * C + c]);
    }
  }
  red[0][lane][col] = __fsub_rn(sa, ca);
  red[1][lane][col] = __fsub_rn(sb, cb);
  __syncthreads();
  if (lane == 0 && c < C) {
    float ta = 0.f, tb = 0.f, ca2 = 0.f, cb2 = 0.f;
    for (int l = 0; l < kFinishLanes; ++l) {
      kahan_add(ta, ca2, red[0][l][col]);
      kahan_add(tb, cb2, red[1][l][col]);
    }
    ta = __fsub_rn(ta, ca2);
    tb = __fsub_rn(tb, cb2);
    packed[c] = ta;
    packed[C + c] = tb;
    if (r != nullptr) {
      dweight[c] = __fmul_rn(ta, r[c]);
      dbias[c] = tb;
    }
  }
  if (r == nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    float count;
    if (mask != nullptr) {
      float valid = 0.f;
      for (int i = 0; i < n; ++i) valid = __fadd_rn(valid, mask[i]);
      count = __fmul_rn(valid, (float)s);
    } else {
      count = (float)((long long)n * s);
    }
    packed[2 * C] = count;
  }
}

template <typename T, int V, int L>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
train_bn_norm(const T* __restrict__ x, const float* __restrict__ packed,
              const float* __restrict__ weight,
              const float* __restrict__ bias, float eps, Plan p,
              T* __restrict__ y, float* __restrict__ mean_out,
              float* __restrict__ var_out, float* __restrict__ r_out,
              unsigned char* __restrict__ pos_out) {
  float mu[V], rw[V], bb[V];
  const float count = packed[2 * p.c];
  const bool writer = blockIdx.x == 0 && first_lane<L>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int ch = channel_of<L, V>(p, i);
    mu[i] = rw[i] = bb[i] = 0.f;
    if (ch >= p.c) continue;
    const float mean = __fdiv_rn(packed[ch], count);
    const float mu2 = __fdiv_rn(packed[p.c + ch], count);
    const float var_raw = __fsub_rn(mu2, __fmul_rn(mean, mean));
    const float var = fmaxf(var_raw, 0.f);
    const float r = rsqrtf(__fadd_rn(var, eps));
    mu[i] = mean;
    rw[i] = __fmul_rn(r, weight[ch]);
    bb[i] = bias[ch];
    if (writer && (L == kRows || i == 0)) {
      mean_out[ch] = mean;
      var_out[ch] = var;
      r_out[ch] = r;
      pos_out[ch] = var_raw > 0.f;
    }
  }
  walk<L, V, false>(p, [&](const size_t (&off)[kUnroll],
                           const int (&)[kUnroll],
                           const bool (&ok)[kUnroll]) {
    Raw<T, V> xr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (ok[u]) xr[u].load(x + off[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i)
        o[i] = __fadd_rn(__fmul_rn(__fsub_rn(xr[u].get(i), mu[i]), rw[i]),
                         bb[i]);
      store<T, V>(y + off[u], o);
    }
  });
}

template <typename T, int V, int L>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
train_bn_grad(const T* __restrict__ dy, const T* __restrict__ x,
              const float* __restrict__ mask,
              const float* __restrict__ packed,
              const float* __restrict__ count_p,
              const float* __restrict__ weight,
              const float* __restrict__ mean,
              const float* __restrict__ rstd,
              const unsigned char* __restrict__ pos, Plan p,
              T* __restrict__ dx) {
  float g[V], c1[V], c2[V];
  const float count = *count_p;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int ch = min(channel_of<L, V>(p, i), p.c - 1);
    const float s = packed[ch], dbias = packed[p.c + ch];
    const float w = weight[ch], r = rstd[ch];
    g[i] = __fmul_rn(w, r);
    const float dvar =
        pos[ch] ? __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(-0.5f, s),
                                                          w), r), r), r)
                : 0.f;
    const float dmean = __fsub_rn(__fmul_rn(-dbias, g[i]),
                                  __fmul_rn(__fmul_rn(2.f, mean[ch]), dvar));
    c1[i] = __fdiv_rn(dmean, count);
    c2[i] = __fdiv_rn(__fmul_rn(2.f, dvar), count);
  }
  const bool masked = mask != nullptr;
  walk<L, V, true>(p, [&](const size_t (&off)[kUnroll],
                          const int (&smp)[kUnroll],
                          const bool (&ok)[kUnroll]) {
    Raw<T, V> xr[kUnroll], gr[kUnroll];
    float m[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
      gr[u].load(dy + off[u]);
      xr[u].load(x + off[u]);
      m[u] = masked ? mask[smp[u]] : 1.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float direct = __fmul_rn(gr[u].get(i), g[i]);
        const float stat = __fmul_rn(
            __fadd_rn(c1[i], __fmul_rn(xr[u].get(i), c2[i])), m[u]);
        o[i] = __fadd_rn(round_to<T>(direct), round_to<T>(stat));
      }
      store<T, V>(dx + off[u], o);
    }
  });
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
struct Tag {
  using type = T;
};
template <int N>
using Int = std::integral_constant<int, N>;

// f(Tag<T>, Int<V>, Int<L>) for the element type, vector and layout asked.
template <typename F>
int dispatch(int is_bf16, int layout, int vec, F&& f) {
  const bool wide = vec > 1;
  if (is_bf16) {
    if (layout == kRows)
      return wide ? f(Tag<bf16>{}, Int<8>{}, Int<kRows>{})
                  : f(Tag<bf16>{}, Int<1>{}, Int<kRows>{});
    return wide ? f(Tag<bf16>{}, Int<8>{}, Int<kPlanes>{})
                : f(Tag<bf16>{}, Int<1>{}, Int<kPlanes>{});
  }
  if (layout == kRows)
    return wide ? f(Tag<float>{}, Int<4>{}, Int<kRows>{})
                : f(Tag<float>{}, Int<1>{}, Int<kRows>{});
  return wide ? f(Tag<float>{}, Int<4>{}, Int<kPlanes>{})
              : f(Tag<float>{}, Int<1>{}, Int<kPlanes>{});
}

// The plan's checks (ops/batchnorm.py launch_plan makes plans that pass):
// the shape, the vector against C (rows) or the positions (planes), a
// block's threads, and `blocks` blocks of `span` covering the rows or a
// channel's vectors with none empty.
bool plan_ok(const Plan& p, int is_bf16, int layout, int vec) {
  const int full = is_bf16 ? 8 : 4;
  if (p.n < 1 || p.c < 1 || p.s < 1 || p.span < 1 || p.blocks < 1 ||
      (long long)p.n * p.c * p.s >= (1LL << 31) ||
      (vec != 1 && vec != full))
    return false;
  long long units;
  if (layout == kRows) {
    if (p.c % vec || p.tile < 1 || p.tile > kMaxTileVec || p.lanes < 1 ||
        p.tile * p.lanes > kThreads ||
        (p.c / vec + p.tile - 1) / p.tile > kMaxGridY)
      return false;
    units = (long long)p.n * p.s;
  } else if (layout == kPlanes) {
    if (p.s % vec || p.tile != 1 || p.lanes != kThreads || p.c > kMaxGridY)
      return false;
    units = (long long)p.n * p.s / vec;
  } else {
    return false;
  }
  return (long long)p.blocks * p.span >= units &&
         (long long)(p.blocks - 1) * p.span < units;
}

dim3 grid_of(const Plan& p, int layout, int vec) {
  if (layout == kRows)
    return dim3(p.blocks, (p.c / vec + p.tile - 1) / p.tile);
  return dim3(p.blocks, p.c);
}

int last_error() { return (int)cudaGetLastError(); }

}  // namespace

// x: (N, C, positions) in the plan's layout (rows: channels innermost;
// planes: contiguous), fp32 (is_bf16 = 0) or bf16; mask: (N,) fp32 or null;
// part: (2, blocks, C) fp32. vec > 1 needs x 16-byte aligned.
// Returns a cudaError_t: 0 once the launch is enqueued on `stream`.
extern "C" int train_bn_stats_launch(const void* x, int is_bf16,
                                     const float* mask, int n, int c, int s,
                                     int layout, int vec, int tile, int lanes,
                                     int span, int blocks, float* part,
                                     void* stream) {
  const Plan p{n, c, s, tile, lanes, span, blocks};
  if (!plan_ok(p, is_bf16, layout, vec) || (vec > 1 && !aligned16(x)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(is_bf16, layout, vec, [&](auto t, auto v, auto l) {
    using T = typename decltype(t)::type;
    train_bn_stats<T, decltype(v)::value, decltype(l)::value>
        <<<grid_of(p, layout, vec), kThreads, 0, st>>>(
            static_cast<const T*>(x), mask, p, part);
    return last_error();
  });
}

// part: (2, blocks, C) fp32 from train_bn_stats_launch (r null) or
// train_bn_grad_reduce_launch (r: (C,) fp32). packed: (2C + 1,) forward,
// (2C,) backward; dweight, dbias: (C,) backward, else null.
extern "C" int train_bn_finish_launch(const float* part, int blocks, int c,
                                      const float* mask, int n, int s,
                                      const float* r, float* packed,
                                      float* dweight, float* dbias,
                                      void* stream) {
  if (blocks < 1 || c < 1 || n < 1 || s < 1 ||
      (r != nullptr && (dweight == nullptr || dbias == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  train_bn_finish<<<(c + kFinishCols - 1) / kFinishCols, kThreads, 0, st>>>(
      part, blocks, c, mask, n, s, r, packed, dweight, dbias);
  return last_error();
}

// x, y: as for train_bn_stats_launch, y in x's layout; packed: (2C + 1,)
// (s1 | s2 | count), all-reduced by the caller under a process group;
// weight, bias, mean, var, r: (C,) fp32; pos: (C,) bool.
extern "C" int train_bn_norm_launch(const void* x, int is_bf16,
                                    const float* packed, const float* weight,
                                    const float* bias, float eps, int n,
                                    int c, int s, int layout, int vec,
                                    int tile, int lanes, int span, int blocks,
                                    void* y, float* mean, float* var,
                                    float* r, unsigned char* pos,
                                    void* stream) {
  const Plan p{n, c, s, tile, lanes, span, blocks};
  if (!plan_ok(p, is_bf16, layout, vec) ||
      (vec > 1 && (!aligned16(x) || !aligned16(y))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(is_bf16, layout, vec, [&](auto t, auto v, auto l) {
    using T = typename decltype(t)::type;
    train_bn_norm<T, decltype(v)::value, decltype(l)::value>
        <<<grid_of(p, layout, vec), kThreads, 0, st>>>(
            static_cast<const T*>(x), packed, weight, bias, eps, p,
            static_cast<T*>(y), mean, var, r, pos);
    return last_error();
  });
}

// dy, x: in one layout and type; mean: (C,) from the forward; part as for
// train_bn_stats_launch.
extern "C" int train_bn_grad_reduce_launch(const void* dy, const void* x,
                                           int is_bf16, const float* mean,
                                           int n, int c, int s, int layout,
                                           int vec, int tile, int lanes,
                                           int span, int blocks, float* part,
                                           void* stream) {
  const Plan p{n, c, s, tile, lanes, span, blocks};
  if (!plan_ok(p, is_bf16, layout, vec) ||
      (vec > 1 && (!aligned16(x) || !aligned16(dy))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(is_bf16, layout, vec, [&](auto t, auto v, auto l) {
    using T = typename decltype(t)::type;
    train_bn_grad_reduce<T, decltype(v)::value, decltype(l)::value>
        <<<grid_of(p, layout, vec), kThreads, 0, st>>>(
            static_cast<const T*>(dy), static_cast<const T*>(x), mean, p,
            part);
    return last_error();
  });
}

// dy, x, dx: in one layout and type; packed: (2C,) (s | dbias), all-reduced
// by the caller under a process group; count: the forward's packed[2C];
// weight, mean, r: (C,) fp32; pos: (C,) bool; mask: (N,) fp32 or null.
extern "C" int train_bn_grad_launch(const void* dy, const void* x,
                                    int is_bf16, const float* mask,
                                    const float* packed, const float* count,
                                    const float* weight, const float* mean,
                                    const float* r, const unsigned char* pos,
                                    int n, int c, int s, int layout, int vec,
                                    int tile, int lanes, int span, int blocks,
                                    void* dx, void* stream) {
  const Plan p{n, c, s, tile, lanes, span, blocks};
  if (!plan_ok(p, is_bf16, layout, vec) ||
      (vec > 1 && (!aligned16(x) || !aligned16(dy) || !aligned16(dx))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(is_bf16, layout, vec, [&](auto t, auto v, auto l) {
    using T = typename decltype(t)::type;
    train_bn_grad<T, decltype(v)::value, decltype(l)::value>
        <<<grid_of(p, layout, vec), kThreads, 0, st>>>(
            static_cast<const T*>(dy), static_cast<const T*>(x), mask, packed,
            count, weight, mean, r, pos, p, static_cast<T*>(dx));
    return last_error();
  });
}
