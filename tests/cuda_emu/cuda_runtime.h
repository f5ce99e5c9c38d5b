// A stand-in for <cuda_runtime.h> that lets a host compiler build a CUDA
// source of the port and run its kernels on the CPU: the threads of a block
// are fibers on one OS thread, the blocks of a grid run one after another,
// __syncthreads() is a barrier, __shared__ a static array.  Enough of the
// runtime for csrc/sub_matmul.cu (no warp shuffles, no dynamic shared
// memory).  The test rewrites `kernel<<<grid, threads, 0, stream>>>(args)`
// into `emu_launch(kernel, grid, threads, args)`, and the one inline-PTX
// DMMA statement into a call of `emu_dmma_m8n8k4`, before it compiles.
//
// The scheduler resumes the fibers of a block in an order shuffled on every
// sweep, and a fiber runs until it waits at a barrier or ends: a barrier the
// kernel leaves out lets one thread read shared memory that another has not
// yet written, or has already overwritten, and the bits come out wrong.
//
// The DMMA stand-in exchanges a warp's fragments through slots and computes
// each lane's D[g][2t], D[g][2t + 1] as one fma chain over the four k of the
// step in ascending order.  That order inside a k step is ASSUMED here: the
// PTX ISA says which lane holds what, not how the tensor core rounds, and
// only the card can check it (chip_smoke.py compares the kernel with cuBLAS).
#pragma once
#include <ucontext.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <functional>
#include <random>
#include <vector>

struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
struct alignas(16) double2 { double x, y; };
inline double2 make_double2(double x, double y) { return {x, y}; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct idx3 { unsigned x, y, z; };

// Set by the scheduler before it resumes a fiber.  emu_progress counts the
// arrivals at barriers and the ends of fibers: a sweep that adds none is a
// deadlock.
inline idx3 threadIdx, blockIdx;
inline ucontext_t emu_main;
inline ucontext_t* emu_current;
inline long emu_progress;
inline void emu_yield() { swapcontext(emu_current, &emu_main); }

// A barrier of `count` threads: the last to arrive opens the generation.
struct EmuBarrier {
  int count = 0, arrived = 0;
  unsigned generation = 0;
  void wait() {
    const unsigned gen = generation;
    ++emu_progress;
    if (++arrived == count) {
      arrived = 0;
      ++generation;
      return;
    }
    while (generation == gen) emu_yield();
  }
};
inline EmuBarrier emu_block_barrier;
inline void __syncthreads() { emu_block_barrier.wait(); }

// mma.sync.aligned.m8n8k4.row.col.f64: lane = g * 4 + t holds A[g][t] in a,
// B[t][g] in b, and D[g][2t], D[g][2t + 1] in c0, c1.  The slots alternate
// between two sets, so one warp barrier a call keeps the lane that opens it
// from overwriting what the others still read.
constexpr int kEmuMaxThreads = 1024, kEmuMaxWarps = kEmuMaxThreads / 32;
inline EmuBarrier emu_warp_barrier[kEmuMaxWarps];
inline double emu_frag[2][kEmuMaxWarps][2][32];
inline unsigned emu_frag_set[kEmuMaxThreads];
inline void emu_dmma_m8n8k4(double& c0, double& c1, double a, double b) {
  const unsigned lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  auto& slot = emu_frag[emu_frag_set[threadIdx.x]][warp];
  emu_frag_set[threadIdx.x] ^= 1;
  slot[0][lane] = a;
  slot[1][lane] = b;
  emu_warp_barrier[warp].wait();
  const unsigned g = lane / 4, t = lane % 4;
  for (unsigned kk = 0; kk < 4; ++kk) {
    c0 = std::fma(slot[0][g * 4 + kk], slot[1][(2 * t) * 4 + kk], c0);
    c1 = std::fma(slot[0][g * 4 + kk], slot[1][(2 * t + 1) * 4 + kk], c1);
  }
}

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

inline std::function<void()> emu_body;
inline bool emu_body_done;
inline void emu_fiber() {
  emu_body();
  emu_body_done = true;
}

template <typename F, typename... A>
void emu_launch(F kernel, dim3 grid, int threads, A... args) {
  constexpr size_t kStack = 1 << 16;
  static std::vector<std::vector<char>> stacks;
  if (stacks.size() < size_t(threads))
    stacks.resize(threads, std::vector<char>(kStack));
  static std::mt19937 shuffle_rng(11);
  std::vector<ucontext_t> fibers(threads);
  std::vector<int> order(threads);
  emu_body = [=] { kernel(args...); };
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      emu_block_barrier = {threads};
      for (int w = 0; w * 32 < threads; ++w) emu_warp_barrier[w] = {32};
      std::vector<bool> done(threads, false);
      for (int t = 0; t < threads; ++t) {
        getcontext(&fibers[t]);
        fibers[t].uc_stack = {stacks[t].data(), 0, kStack};
        fibers[t].uc_link = &emu_main;
        makecontext(&fibers[t], emu_fiber, 0);
        order[t] = t;
        emu_frag_set[t] = 0;
      }
      for (int left = threads; left > 0;) {
        const long before = emu_progress;
        std::shuffle(order.begin(), order.end(), shuffle_rng);
        for (int t : order) {
          if (done[t]) continue;
          threadIdx = {unsigned(t), 0, 0};
          blockIdx = {bx, by, 0};
          emu_current = &fibers[t];
          emu_body_done = false;
          swapcontext(&emu_main, &fibers[t]);
          if (emu_body_done) {
            done[t] = true;
            --left;
            ++emu_progress;
          }
        }
        if (left > 0 && emu_progress == before) {
          fprintf(stderr, "emu: deadlock at a barrier\n");
          abort();
        }
      }
    }
}
