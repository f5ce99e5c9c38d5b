// A stand-in for <cuda_runtime.h> that lets a host compiler build a CUDA
// source of the port and run its kernels on the CPU: the threads of a block
// are fibers on one OS thread, the blocks of a grid run one after another,
// __syncthreads() is a barrier, __shared__ a static array, and dynamic
// shared memory one buffer filled with NaN bytes at the start of every
// block.  Enough of the runtime for csrc/sub_matmul.cu,
// csrc/symv_lower.cu and csrc/sturm.cu.  The tests rewrite `kernel<<<grid, threads, smem,
// stream>>>(args)` into `emu_launch(kernel, grid, threads, args)`, the
// inline PTX (the DMMA statement, the cp.async copies, commits and waits)
// into calls of the `emu_` functions below, and `extern __shared__` into a
// pointer to the dynamic buffer, before they compile.
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
// `__shfl_xor_sync` and `__ballot_sync` exchange values through per-warp
// slots at a warp barrier in the same way.
//
// cp.async: a thread's copies are queued in its open group; a commit closes
// the group; `cp.async.wait_group N` performs, oldest first, the copies of
// every committed group but the newest N.  So a copy lands only at the wait
// that covers it: a kernel that reads a stage without that wait reads what
// the stage held before (NaN, or an older tile).  A copy whose addresses are
// not aligned to its size aborts, as the card would fault.
#pragma once
#include <ucontext.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <random>
#include <vector>

struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
struct alignas(8) float2 { float x, y; };
inline float2 make_float2(float x, float y) { return {x, y}; }
struct alignas(16) double2 { double x, y; };
inline double2 make_double2(double x, double y) { return {x, y}; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct idx3 { unsigned x, y, z; };
using std::fma;
using std::min;

// Set by the scheduler before it resumes a fiber.  emu_progress counts the
// arrivals at barriers and the ends of fibers: a sweep that adds none is a
// deadlock.
inline idx3 threadIdx, blockIdx, gridDim;
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

// __shfl_xor_sync: lane `lane` gets the value of lane `lane ^ mask`.  A
// double holds a float or a double exactly.
inline double emu_shfl[2][kEmuMaxWarps][32];
inline unsigned emu_shfl_set[kEmuMaxThreads];
template <typename T>
T __shfl_xor_sync(unsigned, T value, int mask) {
  const unsigned lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  auto& slot = emu_shfl[emu_shfl_set[threadIdx.x]][warp];
  emu_shfl_set[threadIdx.x] ^= 1;
  slot[lane] = value;
  emu_warp_barrier[warp].wait();
  return static_cast<T>(slot[lane ^ unsigned(mask)]);
}

// __ballot_sync: bit l of the result is lane l's predicate, for every lane
// of the warp, through the same slots and warp barrier.
inline unsigned __ballot_sync(unsigned, int predicate) {
  const unsigned lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  auto& slot = emu_shfl[emu_shfl_set[threadIdx.x]][warp];
  emu_shfl_set[threadIdx.x] ^= 1;
  slot[lane] = predicate != 0;
  emu_warp_barrier[warp].wait();
  unsigned bits = 0;
  for (unsigned l = 0; l < 32; ++l) bits |= unsigned(slot[l] != 0.0) << l;
  return bits;
}

struct EmuCopy {
  void* dst;
  const void* src;
  int bytes;
};
inline std::vector<EmuCopy> emu_cp_open[kEmuMaxThreads];
inline std::vector<std::vector<EmuCopy>> emu_cp_groups[kEmuMaxThreads];
inline void emu_cp_async(void* dst, const void* src, int bytes) {
  if ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) %
      bytes) {
    fprintf(stderr, "emu: cp.async of %d bytes from %p to %p misaligned\n",
            bytes, src, dst);
    abort();
  }
  emu_cp_open[threadIdx.x].push_back({dst, src, bytes});
}
inline void emu_cp_async_commit() {
  emu_cp_groups[threadIdx.x].push_back(std::move(emu_cp_open[threadIdx.x]));
  emu_cp_open[threadIdx.x].clear();
}
inline void emu_cp_async_wait(int newest_left) {
  auto& groups = emu_cp_groups[threadIdx.x];
  while (int(groups.size()) > newest_left) {
    for (const EmuCopy& c : groups.front()) memcpy(c.dst, c.src, c.bytes);
    groups.erase(groups.begin());
  }
}

constexpr size_t kEmuDynamicSmem = 232448;
alignas(16) inline unsigned char emu_dynamic_smem[kEmuDynamicSmem];
inline size_t __cvta_generic_to_shared(const void* p) {
  return reinterpret_cast<uintptr_t>(p);
}

#define __global__
#define __host__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)

typedef void* cudaStream_t;
typedef int cudaError_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
  cudaErrorInvalidDevice = 101,
  cudaDevAttrMultiProcessorCount = 16,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
};
inline int cudaGetDevice(int* device) { *device = 0; return 0; }
// the SM count comes from the environment, so that a test can put any launch
// on either side of a rule that depends on it
inline int cudaDeviceGetAttribute(int* value, int, int) {
  *value = atoi(getenv("EMU_SMS"));
  return 0;
}
inline int cudaGetLastError() { return 0; }
template <typename F>
int cudaFuncSetAttribute(F, int, int value) {
  return size_t(value) <= kEmuDynamicSmem ? 0 : cudaErrorInvalidValue;
}
// one block an SM: the grid is the SM count, which EMU_SMS sets small
template <typename F>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, F, int,
                                                  size_t smem) {
  *blocks = smem <= kEmuDynamicSmem ? 1 : 0;
  return 0;
}

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
  gridDim = {grid.x, grid.y, grid.z};
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      emu_block_barrier = {threads};
      memset(emu_dynamic_smem, 0xff, kEmuDynamicSmem);
      for (int w = 0; w * 32 < threads; ++w) emu_warp_barrier[w] = {32};
      std::vector<bool> done(threads, false);
      for (int t = 0; t < threads; ++t) {
        getcontext(&fibers[t]);
        fibers[t].uc_stack = {stacks[t].data(), 0, kStack};
        fibers[t].uc_link = &emu_main;
        makecontext(&fibers[t], emu_fiber, 0);
        order[t] = t;
        emu_frag_set[t] = 0;
        emu_shfl_set[t] = 0;
        emu_cp_open[t].clear();
        emu_cp_groups[t].clear();
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

// The f64 intrinsics that round once and are never contracted into an fma
// (csrc/sturm.cu): plain operations of a host compiler that builds with
// -std=c++20, which contracts nothing.
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
