// The few CUDA features csrc/mpc_solve.cu and csrc/tick_block.cu use,
// emulated on the CPU for tests/test_torch_long_horizon.py and
// tests/test_torch_tick_scope.py, which compile the kernels with g++.
// mpc_solve.cu (emu_launch): one warp at a time, each of its 32 lanes a
// thread; shuffles and ballots pass through a buffer between two barrier
// waits, so every lane sees the values all lanes held at the call, as on the
// card. Blocks and warps run one after another (the kernel shares nothing
// across warps), so one buffer and one barrier serve every warp.
// tick_block.cu (emu_launch_block): one block at a time, all its threads at
// once, __syncthreads a barrier of the block (the kernel uses no shuffle).
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdlib>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__

struct uint3 {
  unsigned x, y, z;
};
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
extern thread_local uint3 threadIdx, blockIdx;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
// the opt-in shared memory a block may take: an H100's 232,448 bytes unless
// the program that links the emulation sets it otherwise
extern int emu_smem_optin;
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = emu_smem_optin;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "CPU emulation"; }

extern std::barrier<>* emu_warp;
extern float emu_buf[32];
extern unsigned emu_bits[32];

inline int emu_lane() { return threadIdx.x & 31; }
inline float emu_exchange(float v, int src) {
  emu_buf[emu_lane()] = v;
  emu_warp->arrive_and_wait();
  const float r = emu_buf[src];
  emu_warp->arrive_and_wait();
  return r;
}
inline float __shfl_sync(unsigned, float v, int src) { return emu_exchange(v, src); }
inline float __shfl_up_sync(unsigned, float v, int d) {
  const int l = emu_lane();
  return emu_exchange(v, l >= d ? l - d : l);
}
inline float __shfl_down_sync(unsigned, float v, int d) {
  const int l = emu_lane();
  return emu_exchange(v, l + d < 32 ? l + d : l);
}
inline float __shfl_xor_sync(unsigned, float v, int m) { return emu_exchange(v, emu_lane() ^ m); }
inline unsigned __ballot_sync(unsigned, bool p) {
  emu_bits[emu_lane()] = p;
  emu_warp->arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= (emu_bits[i] ? 1u : 0u) << i;
  emu_warp->arrive_and_wait();
  return r;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
extern std::barrier<>* emu_block;
inline void __syncthreads() { emu_block->arrive_and_wait(); }
// IEEE operations the compiler may not contract into an FMA: the volatile
// store rounds each result, as the card's _rn intrinsics do
inline float __fmul_rn(float a, float b) {
  volatile float r = a * b;
  return r;
}
inline float __fadd_rn(float a, float b) {
  volatile float r = a + b;
  return r;
}
inline float __fsub_rn(float a, float b) {
  volatile float r = a - b;
  return r;
}
inline void __syncwarp() { emu_warp->arrive_and_wait(); }
inline void __trap() { std::abort(); }

// kernel<<<grid, block, shared, stream>>>(args...)
template <class K, class... A>
void emu_launch(K kernel, dim3 grid, dim3 block, size_t, cudaStream_t, A... args) {
  for (unsigned bx = 0; bx < grid.x; ++bx)
    for (unsigned w = 0; w < block.x / 32; ++w) {
      std::vector<std::thread> lanes;
      for (unsigned l = 0; l < 32; ++l)
        lanes.emplace_back([=] {
          threadIdx = {w * 32 + l, 0, 0};
          blockIdx = {bx, 0, 0};
          kernel(args...);
        });
      for (auto& t : lanes) t.join();
    }
}

// kernel<<<grid, block, shared, stream>>>(args...) for a kernel whose warps
// share memory and meet at __syncthreads: one block at a time, each of its
// threads a thread of the CPU
template <class K, class... A>
void emu_launch_block(K kernel, dim3 grid, dim3 block, size_t, cudaStream_t, A... args) {
  for (unsigned bx = 0; bx < grid.x; ++bx) {
    std::barrier<> sync(block.x);
    emu_block = &sync;
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block.x; ++t)
      threads.emplace_back([=] {
        threadIdx = {t, 0, 0};
        blockIdx = {bx, 0, 0};
        kernel(args...);
      });
    for (auto& th : threads) th.join();
  }
}
