// GroupNorm (f32 statistics) + ReLU + bf16 cast of a bf16 NCHW activation,
// CUDA C++ for sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves the U-Net's GroupNorm to
// XLA. It was added because on an H100 the chain that followed each of the
// U-Net's 14 convolutions (x.float(), F.group_norm's statistics kernel and
// affine pass, F.relu, .to(bfloat16)) was the U-Net's largest cost: full f32
// passes over the activation, ~32 bytes an element, and a statistics kernel
// with one block per (sample, group) row, 64 blocks for 132 SMs at batch 8.
// The plain version, that chain line for line, is group_norm_relu_plain in
// image_compression_torch/ops/group_norm_relu.py.
//
// What bounds it on an H100: bytes. Each element is read twice as bf16
// (statistics, then apply) and written once as bf16, 6 bytes an element:
// 23.3 GB for the 3.89 G elements of the 14 sites of a batch of 8 images of
// 1024x1024, 7.0 ms at 3.35 TB/s. A few flops an element are far below the
// card's rate.
//
// Design: in contiguous NCHW the (C / G) x H x W elements of one (sample,
// group) row are one contiguous run, and each (sample, channel) plane of
// H x W elements one contiguous run inside it. Two kernels a call:
//   1. statistics, grid (N * G rows, S splits): a block reduces one slice of
//      its row with 16-byte loads (8 bf16). Each thread keeps f32 (count,
//      mean, M2): every 8 values' own mean and M2 are merged into it by
//      Chan's formula. The block merges its threads' moments in a fixed tree
//      (warp shuffles, then shared memory) and writes one partial. S is
//      chosen per shape so that every site gives the SMs several waves of
//      blocks: slices of about 64 K elements, more of them where the rows are
//      short, none under 2 K elements.
//   2. apply, grid (N * C planes, chunks of 16 K elements): a block merges
//      its row's S partials (one a thread, the same tree), computes, as
//      PyTorch's CUDA GroupNorm does, var = max(M2 / count, 0),
//      rstd = rsqrtf(var + eps), a = rstd * gamma[c], b = -a * mean + beta[c],
//      and streams its chunk as bf16_rn(relu(fma(x, a, b))) with 16-byte
//      loads and stores.
// Where a range does not start or end on a multiple of 8 elements (H x W not
// a multiple of 8), its head and tail go one element at a time. The caller
// passes 16-byte-aligned tensors. No atomics: the sums run in an order fixed
// by the shape, so the outputs repeat bit for bit. Statistics are f32 from
// exact bf16 -> f32 values and the affine step is f32 with one rounding to
// bf16, as in the chain; only the order of the sums differs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 8;                        // bf16 in a 16-byte access
constexpr long long SLICE = 1 << 16;          // statistics slice, elements
constexpr long long MIN_SLICE = 1 << 11;      // smallest statistics slice
constexpr int BLOCKS_PER_SM = 16;             // least statistics blocks
constexpr long long CHUNK = THREADS * VEC * 8;  // apply chunk, elements
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Moments {
  float n, mean, m2;
};

// Chan's merge of two sets' (count, mean, M2).
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float wb = b.n / n;
  const float delta = b.mean - a.mean;
  return {n, fmaf(delta, wb, a.mean), a.m2 + b.m2 + delta * delta * a.n * wb};
}

__device__ __forceinline__ float lo_bf16(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(unsigned w) {
  return __uint_as_float(w & 0xFFFF0000u);
}
__device__ __forceinline__ float load1(const unsigned short* x, long long i) {
  return __uint_as_float((unsigned)x[i] << 16);
}

// The moments of 8 values: their mean, then the squares about it.
__device__ __forceinline__ Moments moments8(uint4 q) {
  const float f[VEC] = {lo_bf16(q.x), hi_bf16(q.x), lo_bf16(q.y),
                        hi_bf16(q.y), lo_bf16(q.z), hi_bf16(q.z),
                        lo_bf16(q.w), hi_bf16(q.w)};
  const float mean =
      (((f[0] + f[1]) + (f[2] + f[3])) + ((f[4] + f[5]) + (f[6] + f[7]))) *
      0.125f;
  float m2 = 0.f;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float d = f[k] - mean;
    m2 = fmaf(d, d, m2);
  }
  return {float(VEC), mean, m2};
}

__device__ __forceinline__ Moments shfl_down(Moments m, int offset) {
  return {__shfl_down_sync(FULL, m.n, offset),
          __shfl_down_sync(FULL, m.mean, offset),
          __shfl_down_sync(FULL, m.m2, offset)};
}

// The block's moments, in thread 0: lanes merged by shuffles (offsets 16 to
// 1), then the warps' results in warp 0, in a fixed order.
__device__ Moments block_merge(Moments m, Moments* warps) {
  for (int offset = 16; offset > 0; offset >>= 1)
    m = merge(m, shfl_down(m, offset));
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warps[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < WARPS ? warps[lane] : Moments{0.f, 0.f, 0.f};
    for (int offset = WARPS / 2; offset > 0; offset >>= 1)
      m = merge(m, shfl_down(m, offset));
  }
  return m;
}

__global__ void __launch_bounds__(THREADS)
    gnr_stats_kernel(const unsigned short* __restrict__ x,
                     float4* __restrict__ part, long long len,
                     long long slice, int splits) {
  __shared__ Moments warps[WARPS];
  const long long row = blockIdx.x;
  const long long lo = row * len + blockIdx.y * slice;
  const long long hi = row * len + min(len, (blockIdx.y + 1) * slice);
  const long long head = min(hi, (lo + VEC - 1) / VEC * VEC);
  const long long tail = max(head, hi / VEC * VEC);
  Moments m = {0.f, 0.f, 0.f};
  for (long long i = lo + threadIdx.x; i < head; i += THREADS)
    m = merge(m, Moments{1.f, load1(x, i), 0.f});
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const long long vend = tail / VEC;
  long long v = head / VEC + threadIdx.x;
  for (; v + 3 * THREADS < vend; v += 4 * THREADS) {
    uint4 q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = xv[v + k * THREADS];
#pragma unroll
    for (int k = 0; k < 4; ++k) m = merge(m, moments8(q[k]));
  }
  for (; v < vend; v += THREADS) m = merge(m, moments8(xv[v]));
  for (long long i = tail + threadIdx.x; i < hi; i += THREADS)
    m = merge(m, Moments{1.f, load1(x, i), 0.f});
  m = block_merge(m, warps);
  if (threadIdx.x == 0)
    part[row * splits + blockIdx.y] = make_float4(m.n, m.mean, m.m2, 0.f);
}

__device__ __forceinline__ unsigned norm_relu(float v, float a, float b) {
  float r = fmaf(a, v, b);
  r = r < 0.f ? 0.f : r;
  return __bfloat16_as_ushort(__float2bfloat16_rn(r));
}

__device__ __forceinline__ unsigned apply2(unsigned w, float a, float b) {
  return norm_relu(lo_bf16(w), a, b) | norm_relu(hi_bf16(w), a, b) << 16;
}

__global__ void __launch_bounds__(THREADS)
    gnr_apply_kernel(const unsigned short* __restrict__ x,
                     unsigned short* __restrict__ y,
                     const float4* __restrict__ part,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta, float* __restrict__ mean,
                     float* __restrict__ rstd, int channels, int per_group,
                     long long hw, long long len, int splits, float eps) {
  __shared__ Moments warps[WARPS];
  __shared__ float coef[2];
  const long long plane = blockIdx.x;
  const int c = (int)(plane % channels);
  const long long row = plane / channels * (channels / per_group) +
                        c / per_group;
  Moments m = {0.f, 0.f, 0.f};
  if ((int)threadIdx.x < splits) {
    const float4 p = part[row * splits + threadIdx.x];
    m = {p.x, p.y, p.z};
  }
  m = block_merge(m, warps);
  if (threadIdx.x == 0) {
    const float var = fmaxf(m.m2 / (float)len, 0.f);
    const float r = rsqrtf(var + eps);
    const float a = r * gamma[c];
    coef[0] = a;
    coef[1] = fmaf(-a, m.mean, beta[c]);
    if (blockIdx.y == 0 && c % per_group == 0) {
      mean[row] = m.mean;
      rstd[row] = r;
    }
  }
  __syncthreads();
  const float a = coef[0], b = coef[1];
  const long long lo = plane * hw + blockIdx.y * CHUNK;
  const long long hi = plane * hw + min(hw, (blockIdx.y + 1) * CHUNK);
  const long long head = min(hi, (lo + VEC - 1) / VEC * VEC);
  const long long tail = max(head, hi / VEC * VEC);
  for (long long i = lo + threadIdx.x; i < head; i += THREADS)
    y[i] = (unsigned short)norm_relu(load1(x, i), a, b);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  const long long vend = tail / VEC;
  long long v = head / VEC + threadIdx.x;
  for (; v + 3 * THREADS < vend; v += 4 * THREADS) {
    uint4 q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = xv[v + k * THREADS];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      yv[v + k * THREADS] = make_uint4(apply2(q[k].x, a, b), apply2(q[k].y, a, b),
                                       apply2(q[k].z, a, b), apply2(q[k].w, a, b));
  }
  for (; v < vend; v += THREADS) {
    const uint4 q = xv[v];
    yv[v] = make_uint4(apply2(q.x, a, b), apply2(q.y, a, b), apply2(q.z, a, b),
                       apply2(q.w, a, b));
  }
  for (long long i = tail + threadIdx.x; i < hi; i += THREADS)
    y[i] = (unsigned short)norm_relu(load1(x, i), a, b);
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// y = bf16(relu(group_norm(float(x), groups, gamma, beta, eps))) for a
// contiguous bf16 x [n, channels, hw] (hw = H * W) on the current device;
// gamma, beta f32 [channels]; y bf16 like x; mean, rstd f32 [n, groups];
// scratch f32 [n * groups, max_splits, 4]; x, y and scratch 16-byte aligned.
// Launches two kernels on `stream`, synchronizes nothing and returns the
// first cudaGetLastError() that is not cudaSuccess.
extern "C" int group_norm_relu_launch(const void* x, const void* gamma,
                                      const void* beta, void* y, void* mean,
                                      void* rstd, void* scratch,
                                      int max_splits, long long n,
                                      int channels, long long hw, int groups,
                                      float eps, void* stream) {
  if (n < 0 || hw < 0 || channels < 1 || groups < 1 ||
      channels % groups != 0 || max_splits < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || hw == 0) return (int)cudaSuccess;
  const int per_group = channels / groups;
  const long long rows = n * groups;
  const long long len = per_group * hw;
  const long long chunks = ceil_div(hw, CHUNK);
  if (chunks > 65535 || n * channels > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;

  long long splits = std::max(ceil_div(len, SLICE),
                              ceil_div((long long)BLOCKS_PER_SM * sms, rows));
  splits = std::min(splits, ceil_div(len, MIN_SLICE));
  splits = std::max(1LL, std::min(splits, (long long)std::min(THREADS,
                                                               max_splits)));
  const long long slice = ceil_div(ceil_div(len, splits), VEC) * VEC;
  splits = ceil_div(len, slice);

  const cudaStream_t s = (cudaStream_t)stream;
  gnr_stats_kernel<<<dim3((unsigned)rows, (unsigned)splits), THREADS, 0, s>>>(
      (const unsigned short*)x, (float4*)scratch, len, slice, (int)splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gnr_apply_kernel<<<dim3((unsigned)(n * channels), (unsigned)chunks), THREADS,
                     0, s>>>(
      (const unsigned short*)x, (unsigned short*)y, (const float4*)scratch,
      (const float*)gamma, (const float*)beta, (float*)mean, (float*)rstd,
      channels, per_group, hw, len, (int)splits, eps);
  return (int)cudaGetLastError();
}
