// Soft-argmax forward (K1) and backward (K2) for Hopper (sm_90a), fp32 or
// bf16 logits in, fp32 statistics, the gradient in the logits' type.
//
// Replaces fast3dhpe_tpu/ops/pallas_softargmax.py `_softargmax_fwd_kernel`
// (:28, launched by `_fwd_pallas` at :64) and `_softargmax_bwd_kernel`
// (:45, launched by `_bwd_pallas` at :79). For each (image, joint) the
// max-subtracted fp32 softmax over the H*W pixels gives
//   cx = sum p*x,  cy = sum p*y            (K1)
//   dL/dh = p * (gx*(x - cx) + gy*(y - cy)) (K2)
// K1 also writes, per (image, joint), the statistics (m, 1/S, cx, cy) with
// m the max and S = sum e^{h-m}, and K2 takes them from there: the JAX
// custom VJP recomputes p, cx and cy from the logits in its backward, which
// would cost K2 a second read of them.
//
// What bounds them on the H100: each reads every logit once and does a few
// fp32 operations on it, so the roofline is memory. At 64 images of
// 64x64x19, K1 reads 19.9 MB in fp32 (6.0 us at 3.35 TB/s) and 10.0 MB in
// bf16 (3.0 us); K2 reads and writes 19.9 MB each in fp32 (11.9 us), half
// that in bf16.
//
// The layout. The decoder's output is NCHW in channels_last memory, a
// contiguous (N, H, W, J) tensor: one (image, joint) row of H*W values lies
// J elements apart, but each image's H*W*J values are one contiguous span.
// Both kernels stream that span in 16-byte pieces, so every warp-wide load
// and store covers whole 32-byte sectors:
//   - K1: one CTA of 8 warps per (image, chunk of whole pixels), the chunk
//     chosen by ops/softargmax.py launch_plan (1024 pixels at 64 images,
//     512 at 2). A CTA walks its chunk in tiles, each a contiguous run of
//     the span, brought into shared memory by 16-byte cp.async through a
//     kStages ring (a tile's ends need not be 16-byte aligned: the copy
//     covers the aligned 16-byte pieces around it, and the last piece of
//     the tensor copies only its own bytes). Thread t takes joint
//     j = t mod J of run g = t div J of each tile, a run being kRun
//     consecutive pixels (13 runs of 19 joints: 247 of the 256 threads, a
//     208-pixel tile), so a warp reads consecutive elements of the staged
//     span with at most 2-way bank conflicts where it spans two runs. A
//     run is one pass: its kRun values are loaded at once, its max
//     rescales the thread's running statistics once (m, s = sum e^{h-m},
//     sx, sy), and within a row its pixels are x0, x0 + 1, ... at one y,
//     so the pass sums e and e*i and adds x0 and y0 once: about 8
//     instructions an element, where per-element coordinates and index
//     arithmetic had made the kernel instruction-bound (PERF.md). The
//     groups of each joint are combined through shared memory, one thread
//     a joint. The CTAs of one image form a thread-block cluster (at most
//     8 chunks, a portable cluster): each writes its chunk's (m, s, sx,
//     sy) into the shared memory of the cluster's first CTA, one
//     cluster.sync() replaces a global scratch, fence and atomic ticket,
//     and the first CTA combines the chunks in chunk order, so the result
//     does not depend on which CTA finished first, and writes (cx, cy)
//     and the statistics.
//   - K2: one CTA per (image, chunk of 16-byte vectors of the span). Each
//     CTA stages its image's J rows of (m, 1/S, cx, cy, gx, gy) in shared
//     memory, loads kBwdVec vectors a thread before it computes, maps
//     each element e of the span to j = e mod J and pixel = e div J
//     (stepping j, x and y along a vector instead of dividing), computes
//     e^{h-m} * (1/S) * (gx*(x - cx) + gy*(y - cy)) in fp32 (JAX's form,
//     not a folded a*x + b*y + c, so that it rounds as the plain version
//     does), and stores 16-byte vectors in the logits' type, rounded once.
//     Elements of an image that share a 16-byte vector with the next image
//     are done one by one by the image's first CTA.
// Launches go on the caller's stream; the wrapper allocates every buffer.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace cg = cooperative_groups;

constexpr int kThreads = 256;             // 8 warps a CTA, both kernels
constexpr int kMaxJ = 64;                 // joints a launch may have
constexpr int kRun = 16;                  // pixels of a K1 thread's run
constexpr int kStages = 3;                // K1's cp.async ring
constexpr int kPixAlign = kRun;           // K1 chunks: multiples of a run
constexpr int kMaxChunks = 8;             // K1 CTAs an image: one cluster
constexpr int kBwdVec = 4;                // 16-byte vectors a K2 thread loads
constexpr int kSmemLimit = 232448;        // bytes of shared memory a block

__host__ __device__ constexpr size_t round16(size_t b) {
  return (b + 15) & ~size_t(15);
}

// A K1 tile is one run of kRun pixels for each of the kThreads / J groups
// of threads that share a joint.
__host__ __device__ constexpr int tile_pix(int J) {
  return (kThreads / J) * kRun;
}

// One K1 stage: a tile's bytes, rounded up, and one more 16-byte piece for
// a tile that does not start on a 16-byte boundary.
__host__ __device__ constexpr size_t stage_bytes(int J, int elt) {
  return round16((size_t)tile_pix(J) * J * elt) + 16;
}

__host__ __device__ constexpr size_t fwd_smem_bytes(int J, int elt) {
  return kStages * stage_bytes(J, elt);
}

// the most any J asks: a tile is at most kThreads * kRun fp32 values
constexpr size_t kMaxFwdSmem = kStages * (kThreads * kRun * 4 + 16);

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float ex2(float x) {   // 2^x, 0 for -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The union of `count` sets of terms, each given as (m, s, sx, sy) scaled
// to its own max m and `stride` float4s apart: the max over the sets
// first, then the sums scaled to it. An empty set (m = -inf, sums 0) adds
// nothing.
__device__ __forceinline__ float4 merge(const float4* sets, int count,
                                        int stride) {
  float M = -INFINITY;
  for (int k = 0; k < count; ++k) M = fmaxf(M, sets[k * stride].x);
  float S = 0.f, SX = 0.f, SY = 0.f;
  for (int k = 0; k < count; ++k) {
    const float4 q = sets[k * stride];
    const float f = __expf(q.x - M);
    S = fmaf(q.y, f, S);
    SX = fmaf(q.z, f, SX);
    SY = fmaf(q.w, f, SY);
  }
  return make_float4(M, S, SX, SY);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    softargmax_fwd_kernel(const T* __restrict__ h, float* __restrict__ out,
                          float* __restrict__ stats, int HW, int W, int J,
                          int chunk_pix) {
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float4 red[kThreads];
  __shared__ float4 chunk_stats[kMaxChunks * kMaxJ];  // read in rank 0 only
  const int n = blockIdx.y;
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int tpix = tile_pix(J);
  const int p_begin = c * chunk_pix;
  const int p_end = min(p_begin + chunk_pix, HW);
  const int tiles = (p_end - p_begin + tpix - 1) / tpix;
  const size_t img = (size_t)n * HW * J;
  const size_t total_bytes = (size_t)gridDim.y * HW * J * sizeof(T);
  const size_t sbytes = stage_bytes(J, sizeof(T));
  const unsigned char* base = reinterpret_cast<const unsigned char*>(h);

  auto load = [&](int t) {
    if (t < tiles) {
      const int p0 = p_begin + t * tpix;
      const int p1 = min(p0 + tpix, p_end);
      const size_t b0 = (img + (size_t)p0 * J) * sizeof(T);
      const size_t b1 = (img + (size_t)p1 * J) * sizeof(T);
      const size_t a0 = b0 & ~size_t(15);
      const int pieces = (int)((b1 - a0 + 15) >> 4);
      unsigned char* dst = smem + (t % kStages) * sbytes;
      for (int v = tid; v < pieces; v += kThreads) {
        const size_t src = a0 + ((size_t)v << 4);
        const size_t left = total_bytes - src;
        cp_async16(dst + (v << 4), base + src, left < 16 ? (int)left : 16);
      }
    }
    cp_async_commit();
  };

  // Thread t takes joint j = t mod J of run g = t div J of every tile: the
  // kRun pixels g*kRun, g*kRun + 1, ... A warp reads consecutive elements
  // (the lanes of one run) of the staged span. Within a row a run's pixels
  // are x0, x0 + 1, ... at one y, so a pass sums e and e*i (i the place in
  // the run) and adds x0 and y0 once; a run that crosses a row (W not a
  // multiple of kRun) steps x and y element by element.
  const int G = kThreads / J;
  const int g = tid / J;
  const int j = tid - g * J;
  float m = -INFINITY, s = 0.f, sx = 0.f, sy = 0.f;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) load(t);
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                  // tile t landed; tile t-1 is read
    load(t + kStages - 1);
    const int p0 = p_begin + t * tpix;
    const int cnt = min(kRun, min(tpix, p_end - p0) - g * kRun);
    if (g >= G || cnt <= 0) continue;
    const size_t b0 = (img + (size_t)p0 * J) * sizeof(T);
    const T* run = reinterpret_cast<const T*>(smem + (t % kStages) * sbytes +
                                              (b0 & 15)) +
                   g * kRun * J + j;
    // every load unconditional (past a short run it still reads the staged
    // buffer) and masked after: loads behind a branch do not overlap
    float v[kRun];
    float vmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const float raw = to_float(run[i * J]);
      v[i] = i < cnt ? raw : -INFINITY;
      vmax = fmaxf(vmax, v[i]);
    }
    if (vmax == -INFINITY) continue;  // an all -inf run adds nothing
    const float mn = fmaxf(m, vmax);
    const float r = __expf(m - mn);   // 0 while m is -inf
    const float ml = mn * kLog2e;
    m = mn;
    float es = 0.f, ei = 0.f;
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      v[i] = ex2(fmaf(v[i], kLog2e, -ml));   // e^{v - m}; 0 past the run
      es += v[i];
      ei = fmaf(v[i], (float)i, ei);
    }
    const int gp = p0 + g * kRun;
    const int y0 = gp / W;
    const int x0 = gp - y0 * W;
    float ex, ey;
    if (x0 + cnt <= W) {
      ex = fmaf((float)x0, es, ei);
      ey = (float)y0 * es;
    } else {
      float x = (float)x0, y = (float)y0;
      ex = ey = 0.f;
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        ex = fmaf(v[i], x, ex);
        ey = fmaf(v[i], y, ey);
        x += 1.f;
        if (x >= (float)W) {
          x = 0.f;
          y += 1.f;
        }
      }
    }
    s = fmaf(s, r, es);
    sx = fmaf(sx, r, ex);
    sy = fmaf(sy, r, ey);
  }
  cp_async_wait<0>();

  // the groups of each joint -> this chunk's statistics, one thread a
  // joint, written into the shared memory of the cluster's first CTA
  cg::cluster_group cluster = cg::this_cluster();
  red[tid] = make_float4(m, s, sx, sy);
  __syncthreads();
  if (tid < J)
    cluster.map_shared_rank(chunk_stats, 0)[c * J + tid] =
        merge(red + tid, G, J);

  // the cluster's first CTA combines the image's chunks, in chunk order,
  // one thread a joint
  cluster.sync();
  if (c != 0) return;
  if (tid < J) {
    const float4 q = merge(chunk_stats + tid, gridDim.x, J);  // (M, S, ...)
    const float cx = q.z / q.y;
    const float cy = q.w / q.y;
    const size_t r = (size_t)n * J + tid;
    reinterpret_cast<float2*>(out)[r] = make_float2(cx, cy);
    reinterpret_cast<float4*>(stats)[r] = make_float4(q.x, 1.f / q.y, cx, cy);
  }
}

__device__ __forceinline__ float grad_of(float v, int j, int x, int y,
                                         const float* sm) {
  // sm: m, 1/S, cx, cy, gx, gy, each kMaxJ long
  const float p = __expf(v - sm[j]) * sm[kMaxJ + j];
  return p * (sm[4 * kMaxJ + j] * ((float)x - sm[2 * kMaxJ + j]) +
              sm[5 * kMaxJ + j] * ((float)y - sm[3 * kMaxJ + j]));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    softargmax_bwd_kernel(const T* __restrict__ h,
                          const float* __restrict__ stats,
                          const float* __restrict__ g, T* __restrict__ dh,
                          int HW, int W, int J, int chunk_vec) {
  constexpr int kEpv = 16 / sizeof(T);    // elements a 16-byte vector
  __shared__ float sm[6 * kMaxJ];
  const int n = blockIdx.y;
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < J) {
    const size_t r = (size_t)n * J + tid;
    const float4 st = reinterpret_cast<const float4*>(stats)[r];
    const float2 gg = reinterpret_cast<const float2*>(g)[r];
    sm[tid] = st.x;
    sm[kMaxJ + tid] = st.y;
    sm[2 * kMaxJ + tid] = st.z;
    sm[3 * kMaxJ + tid] = st.w;
    sm[4 * kMaxJ + tid] = gg.x;
    sm[5 * kMaxJ + tid] = gg.y;
  }
  __syncthreads();
  const size_t span = (size_t)HW * J;
  const size_t e0 = (size_t)n * span;
  // the image's whole 16-byte vectors of the flat tensor: [v_lo, v_hi)
  size_t v_lo = (e0 + kEpv - 1) / kEpv;
  size_t v_hi = (e0 + span) / kEpv;
  if (v_hi < v_lo) v_hi = v_lo;

  auto one = [&](size_t e) {            // one element, by itself
    const size_t el = e - e0;
    const int pix = (int)(el / J);
    const int j = (int)(el - (size_t)pix * J);
    const int y = pix / W;
    dh[e] = from_float<T>(grad_of(to_float(h[e]), j, pix - y * W, y, sm));
  };
  if (c == 0) {
    // elements before the first and after the last whole vector
    const size_t head_end = v_lo * kEpv < e0 + span ? v_lo * kEpv : e0 + span;
    for (size_t e = e0 + tid; e < head_end; e += kThreads) one(e);
    const size_t tail = v_hi * kEpv > head_end ? v_hi * kEpv : head_end;
    for (size_t e = tail + tid; e < e0 + span; e += kThreads) one(e);
  }

  const uint4* hv = reinterpret_cast<const uint4*>(h);
  uint4* dv = reinterpret_cast<uint4*>(dh);
  const size_t vb = v_lo + (size_t)c * chunk_vec;
  const size_t ve = vb + chunk_vec < v_hi ? vb + chunk_vec : v_hi;
  for (size_t pass = vb; pass < ve; pass += (size_t)kThreads * kBwdVec) {
    uint4 raw[kBwdVec];
#pragma unroll
    for (int i = 0; i < kBwdVec; ++i) {
      const size_t v = pass + (size_t)i * kThreads + tid;
      if (v < ve) raw[i] = __ldg(hv + v);
    }
#pragma unroll
    for (int i = 0; i < kBwdVec; ++i) {
      const size_t v = pass + (size_t)i * kThreads + tid;
      if (v < ve) {
        const size_t el = v * kEpv - e0;
        int pix = (int)(el / J);
        int j = (int)(el - (size_t)pix * J);
        int y = pix / W;
        int x = pix - y * W;
        const T* in = reinterpret_cast<const T*>(&raw[i]);
        uint4 res;
        T* o = reinterpret_cast<T*>(&res);
#pragma unroll
        for (int k = 0; k < kEpv; ++k) {
          o[k] = from_float<T>(grad_of(to_float(in[k]), j, x, y, sm));
          if (++j == J) {
            j = 0;
            if (++x == W) {
              x = 0;
              ++y;
            }
          }
        }
        dv[v] = res;
      }
    }
  }
}

// K1's attributes, set once a device: room for the largest ring, and the
// SM's unified memory given to shared memory so that several CTAs fit.
template <typename T>
int configure_fwd() {
  static unsigned done = 0;           // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32 && (done >> dev & 1u)) return 0;
  err = cudaFuncSetAttribute(softargmax_fwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxFwdSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(softargmax_fwd_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return (int)err;
}

// One cluster of `chunks` CTAs an image.
template <typename T>
int launch_fwd(const void* h, void* out, void* stats, int N, int HW, int W,
               int J, int chunk_pix, int chunks, cudaStream_t stream) {
  const int err = configure_fwd<T>();
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(chunks, N);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = fwd_smem_bytes(J, sizeof(T));
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = chunks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, softargmax_fwd_kernel<T>, static_cast<const T*>(h),
      static_cast<float*>(out), static_cast<float*>(stats), HW, W, J,
      chunk_pix);
  if (launched != cudaSuccess) return (int)launched;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* h, const void* stats, const void* g, void* dh,
               int N, int HW, int W, int J, int chunk_vec, int chunks,
               cudaStream_t stream) {
  softargmax_bwd_kernel<T><<<dim3(chunks, N), kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const float*>(stats),
      static_cast<const float*>(g), static_cast<T*>(dh), HW, W, J,
      chunk_vec);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool shape_ok(int N, int HW, int W, int J) {
  return N >= 1 && N <= 65535 && W >= 1 && HW >= W && HW % W == 0 &&
         J >= 1 && J <= kMaxJ;
}

}  // namespace

// K1's dynamic shared memory for J joints of elt bytes.
extern "C" int softargmax_fwd_smem_bytes(int J, int elt) {
  return (int)fwd_smem_bytes(J, elt);
}

// h: (N, H, W, J) contiguous, fp32 (is_bf16 = 0) or bf16, HW = H*W.
// out: (N, J, 2) fp32 (x, y); stats: (N, J, 4) fp32 (m, 1/S, cx, cy).
// chunk_pix % 16 == 0, chunks == ceil(HW / chunk_pix) <= 8 (ops/softargmax.py
// launch_plan). Every pointer 16-byte aligned.
// Returns a cudaError_t: 0 once the launch is enqueued on `stream`.
extern "C" int softargmax_fwd(const void* h, int is_bf16, void* out,
                              void* stats, int N, int HW, int W, int J,
                              int chunk_pix, int chunks, void* stream) {
  if (!shape_ok(N, HW, W, J) || chunk_pix < kPixAlign ||
      chunk_pix % kPixAlign != 0 || chunks > kMaxChunks ||
      chunks != (HW + chunk_pix - 1) / chunk_pix ||
      fwd_smem_bytes(J, is_bf16 ? 2 : 4) > (size_t)kSmemLimit ||
      !aligned16(h) || !aligned16(out) || !aligned16(stats))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_fwd<bf16>(h, out, stats, N, HW, W, J, chunk_pix, chunks,
                            st);
  return launch_fwd<float>(h, out, stats, N, HW, W, J, chunk_pix, chunks,
                           st);
}

// h, dh: (N, H, W, J) contiguous, fp32 (is_bf16 = 0) or bf16; stats:
// (N, J, 4) fp32 from softargmax_fwd; g: (N, J, 2) fp32. chunk_vec > 0 and
// chunks == max(1, ceil((HW*J / vector elements) / chunk_vec))
// (launch_plan). Every pointer 16-byte aligned.
// Returns a cudaError_t: 0 once the launch is enqueued on `stream`.
extern "C" int softargmax_bwd(const void* h, int is_bf16, const void* stats,
                              const void* g, void* dh, int N, int HW, int W,
                              int J, int chunk_vec, int chunks,
                              void* stream) {
  const long long nvec = (long long)HW * J / (is_bf16 ? 8 : 4);
  const long long need = nvec > 0 ? (nvec + chunk_vec - 1) / chunk_vec : 1;
  if (!shape_ok(N, HW, W, J) || chunk_vec < 1 || chunks != need ||
      !aligned16(h) || !aligned16(stats) || !aligned16(g) || !aligned16(dh))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bwd<bf16>(h, stats, g, dh, N, HW, W, J, chunk_vec, chunks,
                            st);
  return launch_bwd<float>(h, stats, g, dh, N, HW, W, J, chunk_vec, chunks,
                           st);
}
