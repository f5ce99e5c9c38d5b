// A stand-in for <cuda_runtime.h> that lets a host compiler build a CUDA
// source of the port and run its kernels on CPU threads: one std::thread for
// each thread of a block, the blocks of a grid one after another,
// __syncthreads() as a barrier, __shared__ as a static array.  Enough of the
// runtime for csrc/sub_matmul.cu (no warp shuffles, no dynamic shared
// memory).  The test rewrites `kernel<<<grid, threads, 0, stream>>>(args)`
// into `emu_launch(kernel, grid, threads, args)` before it compiles.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <thread>
#include <vector>

struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct idx3 { unsigned x, y, z; };
inline thread_local idx3 threadIdx, blockIdx;
inline std::barrier<>* emu_barrier;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }

#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)

typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaDevAttrMultiProcessorCount = 16 };
inline int cudaGetDevice(int* device) { *device = 0; return 0; }
// the SM count comes from the environment, so that a test can put any launch
// on either side of a rule that depends on it
inline int cudaDeviceGetAttribute(int* value, int, int) {
  *value = atoi(getenv("EMU_SMS"));
  return 0;
}
inline int cudaGetLastError() { return 0; }

template <typename F, typename... A>
void emu_launch(F kernel, dim3 grid, int threads, A... args) {
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::barrier<> barrier(threads);
      emu_barrier = &barrier;
      std::vector<std::thread> pool;
      for (int t = 0; t < threads; ++t)
        pool.emplace_back([=] {
          threadIdx = {unsigned(t), 0, 0};
          blockIdx = {bx, by, 0};
          kernel(args...);
        });
      for (auto& th : pool) th.join();
    }
}
