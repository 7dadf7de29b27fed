// Just enough of the CUDA runtime to compile a kernel source of the port
// with a host C++20 compiler and run it on the CPU (tests only): every CUDA
// thread of a block is a std::thread, blocks run one after another,
// __syncthreads and __syncwarp are std::barriers, __ballot_sync exchanges
// the lanes' predicates between two warp barriers, and the atomics take a
// lock. A launch `kernel<<<grid, block, smem, stream>>>(args);` is rewritten
// by the test into `emu_launch(grid, block, smem, stream, [&] {
// kernel(args); });`. `__shared__` variables become function statics, one
// per kernel instance, which is right because blocks do not overlap.
#pragma once
#include <algorithm>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)
#define __shared__ static

struct emu_dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local emu_dim3 threadIdx, blockIdx;

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, F,
                                                          int, size_t) {
  *blocks = 1;
  return cudaSuccess;
}

struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
using std::max;
using std::min;

inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }

struct EmuBlock {
  std::unique_ptr<std::barrier<>> block;
  std::vector<std::unique_ptr<std::barrier<>>> warp;
  std::vector<unsigned char> ballot;  // [warps][32]
};
inline EmuBlock* emu_block;
inline std::mutex emu_atomic_lock;

inline void __syncthreads() { emu_block->block->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xFFFFFFFFu) {
  emu_block->warp[threadIdx.x / 32]->arrive_and_wait();
}
inline unsigned __ballot_sync(unsigned, bool pred) {
  unsigned char* lanes = emu_block->ballot.data() + threadIdx.x / 32 * 32;
  lanes[threadIdx.x % 32] = pred;
  __syncwarp();
  unsigned bits = 0;
  for (int i = 0; i < 32; ++i)
    if (lanes[i]) bits |= 1u << i;
  __syncwarp();
  return bits;
}
inline unsigned long long atomicMax(unsigned long long* a,
                                    unsigned long long v) {
  std::lock_guard<std::mutex> g(emu_atomic_lock);
  const unsigned long long old = *a;
  if (v > old) *a = v;
  return old;
}
inline unsigned atomicMin(unsigned* a, unsigned v) {
  std::lock_guard<std::mutex> g(emu_atomic_lock);
  const unsigned old = *a;
  if (v < old) *a = v;
  return old;
}

template <class F>
void emu_launch(int grid, int block, int, cudaStream_t, F kernel) {
  for (int b = 0; b < grid; ++b) {
    EmuBlock eb;
    eb.block = std::make_unique<std::barrier<>>(block);
    for (int w = 0; w < block / 32; ++w)
      eb.warp.push_back(std::make_unique<std::barrier<>>(32));
    eb.ballot.assign(block, 0);
    emu_block = &eb;
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([&, t, b] {
        threadIdx.x = t;
        blockIdx.x = b;
        kernel();
      });
    for (auto& th : threads) th.join();
  }
}
