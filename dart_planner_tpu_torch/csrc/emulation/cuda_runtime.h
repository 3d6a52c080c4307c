// The few CUDA features csrc/mpc_solve.cu and csrc/tick_block.cu use,
// emulated on the CPU for the tests that compile the kernels with g++
// (tests/_emulated_b1.py, tests/test_torch_tick_scope.py).
// A launch runs on the calling thread, one block at a time. The threads of
// the group that meets (a warp under emu_launch, a block under
// emu_launch_block) take turns, each on a stack of its own: a thread runs to
// its next meeting (a shuffle, a ballot, __syncwarp, __syncthreads), then
// the next one does; once all have arrived, the next round resumes them.
// A shuffle or ballot writes into its round's buffer before it hands over
// and reads after, so every thread sees what all threads held at the call,
// as on the card. The kernels make every meeting one of the whole warp (or
// block), as the card requires, so the order of the turns changes nothing.
#pragma once
#undef _FORTIFY_SOURCE  // first: a fortified longjmp refuses another stack
#include <setjmp.h>
#include <sys/mman.h>
#include <ucontext.h>
#include <unistd.h>

#include <cmath>
#include <cstddef>
#include <cstdio>
#include <cstdlib>

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
inline uint3 threadIdx, blockIdx;  // the running thread's, set before each resume

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin, cudaDevAttrMultiProcessorCount };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
// the opt-in shared memory a block may take and the SMs: an H100's 232,448
// bytes and 132 unless the program that links the emulation sets them
// otherwise
inline int emu_smem_optin = 232448, emu_sm_count = 132;
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr attr, int) {
  *value = attr == cudaDevAttrMultiProcessorCount ? emu_sm_count : emu_smem_optin;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// the CPU has no occupancy to report: the call fails
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, F, int, size_t) {
  *blocks = 0;
  return cudaErrorInvalidValue;
}
inline const char* cudaGetErrorString(cudaError_t) { return "CPU emulation"; }

namespace emu {
constexpr unsigned kMaxThreads = 1024;  // a block's, as on the card
constexpr size_t kStack = size_t(1) << 20;
inline ucontext_t entry[kMaxThreads];            // each thread's start
inline jmp_buf scheduler, threads[kMaxThreads];  // where each side left off
inline unsigned running, round_;                 // the thread resumed, its round
inline bool finished[kMaxThreads];
inline float buf[2][kMaxThreads];  // shuffles' values, by round parity
inline bool bits[2][kMaxThreads];  // ballots' predicates, by round parity
inline void* body;                 // the launch's kernel call

// A thread is entered by setcontext, then switched by _setjmp / _longjmp,
// which make no system call. Neither side is inlined, so that no other
// function holds a _setjmp: the kernels compile as around any call.
// The running thread hands over; it returns when the next round resumes it.
__attribute__((noinline)) inline void arrive() {
  if (!_setjmp(threads[running])) _longjmp(scheduler, 1);
}
// The scheduler runs thread `running` to its next meeting or its end.
__attribute__((noinline)) inline void resume() {
  if (!_setjmp(scheduler)) {
    if (round_ == 0) setcontext(&entry[running]);
    _longjmp(threads[running], 1);
  }
}
template <class F>
void start() {
  (*static_cast<F*>(body))();
  finished[running] = true;
  _longjmp(scheduler, 1);
}

inline float exchange(float v, int src) {
  float* b = buf[round_ & 1];
  const unsigned t = threadIdx.x;
  b[t] = v;
  arrive();
  return b[(t & ~31u) + src];
}

// A launch's stacks, one a thread, each above a guard page, so that an
// overflow faults instead of writing into the next stack.
struct Stacks {
  size_t page = size_t(sysconf(_SC_PAGESIZE)), each = kStack + page;
  unsigned n;
  char* base;
  explicit Stacks(unsigned count) : n(count) {
    void* p = mmap(nullptr, n * each, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    if (p == MAP_FAILED) std::abort();
    base = static_cast<char*>(p);
    for (unsigned t = 0; t < n; ++t) mprotect(base + t * each, page, PROT_NONE);
  }
  ~Stacks() { munmap(base, n * each); }

  // runs f() as the group's n threads, thread t as threadIdx.x = first + t
  template <class F>
  void run(F& f, unsigned first, unsigned block) {
    body = &f;
    for (unsigned t = 0; t < n; ++t) {
      getcontext(&entry[t]);
      entry[t].uc_stack = {base + t * each + page, 0, kStack};
      entry[t].uc_link = nullptr;  // start() never returns
      makecontext(&entry[t], start<F>, 0);
      finished[t] = false;
    }
    for (unsigned done = 0, r = 0; done == 0; ++r) {
      for (unsigned t = 0; t < n; ++t) {
        running = t, round_ = r;
        threadIdx = {first + t, 0, 0};
        blockIdx = {block, 0, 0};
        resume();
        done += finished[t];
      }
      if (done != 0 && done != n) {  // on the card the rest would wait for ever
        std::fprintf(stderr, "emulation: %u of %u threads left at a meeting\n", done, n);
        std::abort();
      }
    }
  }
};
}  // namespace emu

inline float __shfl_sync(unsigned, float v, int src) { return emu::exchange(v, src); }
// with `width` < 32 the warp is cut into segments of that many lanes, and a
// lane whose source lies outside its own segment keeps its value
inline float __shfl_up_sync(unsigned, float v, int d, int width = 32) {
  const int l = threadIdx.x & 31;
  return emu::exchange(v, (l & (width - 1)) >= d ? l - d : l);
}
inline float __shfl_down_sync(unsigned, float v, int d, int width = 32) {
  const int l = threadIdx.x & 31;
  return emu::exchange(v, (l & (width - 1)) + d < width ? l + d : l);
}
inline float __shfl_xor_sync(unsigned, float v, int m) {
  return emu::exchange(v, (threadIdx.x & 31) ^ m);
}
inline unsigned __ballot_sync(unsigned, bool p) {
  bool* b = emu::bits[emu::round_ & 1];
  const unsigned warp = threadIdx.x & ~31u;
  b[threadIdx.x] = p;
  emu::arrive();
  unsigned r = 0;
  for (unsigned i = 0; i < 32; ++i) r |= (b[warp + i] ? 1u : 0u) << i;
  return r;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline void __syncwarp() { emu::arrive(); }
inline void __syncthreads() { emu::arrive(); }
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
inline void __trap() { std::abort(); }

// kernel<<<grid, block, shared, stream>>>(args...) for a kernel whose warps
// share nothing: one warp at a time
template <class K, class... A>
void emu_launch(K kernel, dim3 grid, dim3 block, size_t, cudaStream_t, A... args) {
  auto f = [&] { kernel(args...); };
  emu::Stacks lanes(32);
  for (unsigned bx = 0; bx < grid.x; ++bx)
    for (unsigned w = 0; w < block.x / 32; ++w) lanes.run(f, w * 32, bx);
}

// kernel<<<grid, block, shared, stream>>>(args...) for a kernel whose warps
// share memory and meet at __syncthreads: one block at a time
template <class K, class... A>
void emu_launch_block(K kernel, dim3 grid, dim3 block, size_t, cudaStream_t, A... args) {
  auto f = [&] { kernel(args...); };
  emu::Stacks group(block.x);
  for (unsigned bx = 0; bx < grid.x; ++bx) group.run(f, 0, bx);
}
