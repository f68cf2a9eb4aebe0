// Fused eval-mode ResNet Bottleneck for Hopper (sm_90a), bf16 in and out.
//
// Replaces fast3dhpe_tpu/ops/pallas_bottleneck.py `_bottleneck_kernel`
// (pallas_call at :191): one stride-1 block
//   1x1 conv + BN + relu -> 3x3 conv (pad 1) + BN + relu -> 1x1 conv + BN
//   -> + residual (identity, or 1x1 downsample + BN) -> relu
// with BN folded to per-channel (scale, bias) by the caller. It rounds where
// the TPU kernel rounds: h1, h2, h3 and the downsampled residual are bf16,
// every product sums in fp32, and the residual add happens in bf16.
//
// What bounds it on the H100: at the encoder's stage-1/2 shapes the block
// moves ~2 MB and does ~0.6 GFLOP per image, so the roofline is memory
// (~40 us for 64 images at 3.35 TB/s). The design keeps every intermediate
// on chip, so device memory sees x once and the output once:
//   - one CTA per (image, 8x8 output tile); x over the 10x10 halo is staged
//     in shared memory, conv1 runs over the halo into an h1 tile (zero where
//     the halo leaves the image: the TPU kernel zero-pads h1, not x);
//   - the 3x3 conv reads the h1 tile, conv3 and the residual run in chunks
//     of 128 output channels so the fp32 accumulators fit in registers;
//   - the products are plain fp32 FMAs (no tensor cores yet): each warp owns
//     a set of pixels, each lane a set of output channels, A comes from
//     shared memory as a warp-wide broadcast, B (weights, <= 0.6 MB a block)
//     from global memory, where it stays in L1/L2.
// Tensor cores (mma.sync / wgmma) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 8;                      // output tile edge
constexpr int kHalo = kTile + 2;              // 3x3 conv halo edge
constexpr int kHaloPix = kHalo * kHalo;       // 100
constexpr int kTilePix = kTile * kTile;       // 64
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kOutChunk = 128;                // conv3 output channels a pass

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <int RM, int RN>
__device__ __forceinline__ void zero(float (&acc)[RM][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_k a[off[i] + k] * b[k * ldb + n0 + lane + 32 j]
// a: shared memory rows (one per pixel of this warp), b: global K x ldb.
template <int RM, int RN>
__device__ __forceinline__ void gemm_acc(float (&acc)[RM][RN],
                                         const bf16* a, const int (&off)[RM],
                                         int K, const bf16* __restrict__ b,
                                         int ldb, int n0, int lane) {
  const bf16* bp = b + n0 + lane;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float bv[RN];
#pragma unroll
    for (int j = 0; j < RN; ++j)
      bv[j] = __bfloat162float(bp[(size_t)k * ldb + 32 * j]);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float av = __bfloat162float(a[off[i] + k]);
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
    }
  }
}

// RNP: output channels per lane in the P-wide convs (P = 32 * RNP * chunks).
template <int RNP>
__global__ void __launch_bounds__(kThreads)
bottleneck_kernel(const bf16* __restrict__ x,
                  const bf16* __restrict__ w1, const float* __restrict__ s1,
                  const float* __restrict__ b1,
                  const bf16* __restrict__ w2, const float* __restrict__ s2,
                  const float* __restrict__ b2,
                  const bf16* __restrict__ w3, const float* __restrict__ s3,
                  const float* __restrict__ b3,
                  const bf16* __restrict__ wd, const float* __restrict__ sd,
                  const float* __restrict__ bd,
                  bf16* __restrict__ out, int H, int W, int Cin, int P,
                  int Cout) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);   // [100][Cin]
  bf16* h1s = xs + kHaloPix * Cin;            // [100][P]
  bf16* h2s = h1s + kHaloPix * P;             // [64][P]

  const int tiles_x = (W + kTile - 1) / kTile;
  const int img = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * kTile;
  const int x0 = (blockIdx.x % tiles_x) * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bf16* ximg = x + (size_t)img * H * W * Cin;

  // 1. x over the halo, 16 bytes a thread; zero outside the image
  const int vecs = Cin >> 3;
  for (int t = threadIdx.x; t < kHaloPix * vecs; t += kThreads) {
    const int m = t / vecs;
    const int v = t - m * vecs;
    const int gy = y0 - 1 + m / kHalo;
    const int gx = x0 - 1 + m % kHalo;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      val = *reinterpret_cast<const uint4*>(
          ximg + ((size_t)gy * W + gx) * Cin + v * 8);
    *reinterpret_cast<uint4*>(xs + m * Cin + v * 8) = val;
  }
  __syncthreads();

  // 2. h1 = bf16(relu(x @ w1 * s1 + b1)) over the halo, 0 off the image
  constexpr int RM1 = (kHaloPix + kWarps - 1) / kWarps;   // 13
  for (int n0 = 0; n0 < P; n0 += 32 * RNP) {
    float acc[RM1][RNP];
    zero(acc);
    int off[RM1];
#pragma unroll
    for (int i = 0; i < RM1; ++i)
      off[i] = min(warp + kWarps * i, kHaloPix - 1) * Cin;
    gemm_acc<RM1, RNP>(acc, xs, off, Cin, w1, P, n0, lane);
#pragma unroll
    for (int i = 0; i < RM1; ++i) {
      const int m = warp + kWarps * i;
      if (m < kHaloPix) {
        const int gy = y0 - 1 + m / kHalo;
        const int gx = x0 - 1 + m % kHalo;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int j = 0; j < RNP; ++j) {
          const int n = n0 + lane + 32 * j;
          const float v = inside ? fmaxf(acc[i][j] * s1[n] + b1[n], 0.f) : 0.f;
          h1s[m * P + n] = __float2bfloat16(v);
        }
      }
    }
  }
  __syncthreads();

  // 3. h2 = bf16(relu(conv3x3(h1) * s2 + b2)) on the 8x8 tile
  constexpr int RM2 = kTilePix / kWarps;                  // 8
  for (int n0 = 0; n0 < P; n0 += 32 * RNP) {
    float acc[RM2][RNP];
    zero(acc);
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3;
      const int kx = tap - ky * 3;
      int off[RM2];
#pragma unroll
      for (int i = 0; i < RM2; ++i) {
        const int m = warp + kWarps * i;
        off[i] = (((m >> 3) + ky) * kHalo + (m & 7) + kx) * P;
      }
      gemm_acc<RM2, RNP>(acc, h1s, off, P, w2 + (size_t)tap * P * P, P, n0,
                         lane);
    }
#pragma unroll
    for (int i = 0; i < RM2; ++i) {
      const int m = warp + kWarps * i;
#pragma unroll
      for (int j = 0; j < RNP; ++j) {
        const int n = n0 + lane + 32 * j;
        const float v = fmaxf(acc[i][j] * s2[n] + b2[n], 0.f);
        h2s[m * P + n] = __float2bfloat16(v);
      }
    }
  }
  __syncthreads();

  // 4. out = relu(bf16(bf16(h2 @ w3 * s3 + b3) + r)), 128 channels a pass
  for (int n0 = 0; n0 < Cout; n0 += kOutChunk) {
    float acc[RM2][4];
    zero(acc);
    int off[RM2];
#pragma unroll
    for (int i = 0; i < RM2; ++i) off[i] = (warp + kWarps * i) * P;
    gemm_acc<RM2, 4>(acc, h2s, off, P, w3, Cout, n0, lane);

    float res[RM2][4];
#pragma unroll
    for (int i = 0; i < RM2; ++i) {
      const int m = warp + kWarps * i;
      off[i] = (((m >> 3) + 1) * kHalo + (m & 7) + 1) * Cin;
    }
    if (wd != nullptr) {
      zero(res);
      gemm_acc<RM2, 4>(res, xs, off, Cin, wd, Cout, n0, lane);
#pragma unroll
      for (int i = 0; i < RM2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + lane + 32 * j;
          res[i][j] = round_bf16(res[i][j] * sd[n] + bd[n]);
        }
    } else {
#pragma unroll
      for (int i = 0; i < RM2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          res[i][j] = __bfloat162float(xs[off[i] + n0 + lane + 32 * j]);
    }

#pragma unroll
    for (int i = 0; i < RM2; ++i) {
      const int m = warp + kWarps * i;
      const int gy = y0 + (m >> 3);
      const int gx = x0 + (m & 7);
      if (gy < H && gx < W) {
        bf16* orow = out + (((size_t)img * H + gy) * W + gx) * Cout;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + lane + 32 * j;
          const float h3 = round_bf16(acc[i][j] * s3[n] + b3[n]);
          orow[n] = __float2bfloat16(fmaxf(round_bf16(h3 + res[i][j]), 0.f));
        }
      }
    }
  }
}

template <int RNP>
int launch(const bf16* x, const bf16* w1, const float* s1, const float* b1,
           const bf16* w2, const float* s2, const float* b2, const bf16* w3,
           const float* s3, const float* b3, const bf16* wd, const float* sd,
           const float* bd, bf16* out, int B, int H, int W, int Cin, int P,
           int Cout, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * ((size_t)kHaloPix * Cin +
                                      (size_t)(kHaloPix + kTilePix) * P);
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_kernel<RNP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile), B);
  bottleneck_kernel<RNP><<<grid, kThreads, smem, stream>>>(
      x, w1, s1, b1, w2, s2, b2, w3, s3, b3, wd, sd, bd, out, H, W, Cin, P,
      Cout);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, H, W, Cin) bf16 (NHWC, i.e. NCHW in channels_last);
// w1 (Cin, P), w2 (9 P, P) rows ordered (ky, kx, cin), w3 (P, Cout),
// wd (Cin, Cout) or null for the identity residual (Cin == Cout); all bf16.
// s*, b*: folded BN, fp32. out: (B, H, W, Cout) bf16.
// Returns a cudaError_t: 0 once the launch is enqueued on `stream`.
extern "C" int fused_bottleneck_bf16(
    const void* x, const void* w1, const void* s1, const void* b1,
    const void* w2, const void* s2, const void* b2, const void* w3,
    const void* s3, const void* b3, const void* wd, const void* sd,
    const void* bd, void* out, int B, int H, int W, int Cin, int P, int Cout,
    void* stream) {
  if (Cin % 8 != 0 || P % 32 != 0 || Cout % kOutChunk != 0 ||
      (wd == nullptr && Cin != Cout))
    return (int)cudaErrorInvalidValue;
#define FB_LAUNCH(RNP)                                                     \
  launch<RNP>((const bf16*)x, (const bf16*)w1, (const float*)s1,          \
              (const float*)b1, (const bf16*)w2, (const float*)s2,        \
              (const float*)b2, (const bf16*)w3, (const float*)s3,        \
              (const float*)b3, (const bf16*)wd, (const float*)sd,        \
              (const float*)bd, (bf16*)out, B, H, W, Cin, P, Cout,        \
              (cudaStream_t)stream)
  if (P % 128 == 0) return FB_LAUNCH(4);
  if (P % 64 == 0) return FB_LAUNCH(2);
  return FB_LAUNCH(1);
#undef FB_LAUNCH
}
