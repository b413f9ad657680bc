// Host emulation of the CUDA features csrc/newton_iter.cu uses, for
// checking a one-warp-per-block kernel's logic on a machine without a GPU:
// each block runs as 32 std::threads (one block at a time); shuffles,
// ballots and __syncwarp go through a barrier-synchronised exchange;
// shared memory is a per-block buffer filled with garbage first; the
// source's cp.async helpers take their plain-copy branch (no __CUDA_ARCH__).
// It says nothing of speed, registers or what nvcc accepts. Used by run.py
// and tests/test_torch_newton_iter_emu.py.
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <functional>
#include <thread>
#include <vector>
using std::sqrt;
using std::fma;
using std::fabs;
using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(x) alignas(x)
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
struct dim3e { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3e threadIdx;
inline thread_local dim3e blockIdx;
struct alignas(16) uint4 { unsigned x, y, z, w; };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize, cudaFuncAttributePreferredSharedMemoryCarveout };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
struct cudaFuncAttributes { int numRegs = 0; size_t localSizeBytes = 0; };
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 132; return 0; }
template <class F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* v, F, int, size_t) { *v = 1; return 0; }
template <class F> cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, F) { a->numRegs = 0; return 0; }
inline cudaError_t cudaGetLastError() { return 0; }

namespace emu {
struct Warp {
  std::barrier<> bar{32};
  uint64_t slot[32];
};
inline thread_local Warp* tw = nullptr;
inline thread_local unsigned char* tsmem = nullptr;
inline unsigned char* smem() { return tsmem; }
template <class T>
T xchg(T v, int src) {
  uint64_t b = 0;
  std::memcpy(&b, &v, sizeof(T));
  tw->slot[threadIdx.x] = b;
  tw->bar.arrive_and_wait();
  uint64_t r = tw->slot[src];
  tw->bar.arrive_and_wait();
  T out;
  std::memcpy(&out, &r, sizeof(T));
  return out;
}
inline void launch(int grid, size_t bytes, const std::function<void()>& fn) {
  std::vector<unsigned char> buf(bytes + 16);
  for (int b = 0; b < grid; ++b) {
    // garbage in shared memory, as on the card
    for (size_t i = 0; i < buf.size(); ++i) buf[i] = (unsigned char)(0xA5 ^ (i * 31 + b));
    Warp w;
    std::vector<std::thread> th;
    for (int l = 0; l < 32; ++l) {
      th.emplace_back([&, l, b] {
        threadIdx.x = l;
        blockIdx.x = b;
        tw = &w;
        tsmem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(buf.data()) + 15) / 16 * 16);
        fn();
      });
    }
    for (auto& t : th) t.join();
  }
}
}  // namespace emu

template <class T> T __shfl_xor_sync(unsigned, T v, int o) { return emu::xchg(v, threadIdx.x ^ o); }
template <class T> T __shfl_up_sync(unsigned, T v, int o) {
  int s = int(threadIdx.x) - o;
  return emu::xchg(v, s < 0 ? int(threadIdx.x) : s);
}
template <class T> T __shfl_sync(unsigned, T v, int src) { return emu::xchg(v, src); }
inline unsigned __ballot_sync(unsigned, int p) {
  emu::tw->slot[threadIdx.x] = p ? 1 : 0;
  emu::tw->bar.arrive_and_wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) if (emu::tw->slot[i]) m |= 1u << i;
  emu::tw->bar.arrive_and_wait();
  return m;
}
inline void __syncwarp(unsigned = 0xffffffffu) { emu::tw->bar.arrive_and_wait(); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
template <class T> T __ldg(const T* p) { return *p; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline double __dadd_rn(double a, double b) { volatile double r = a + b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline double __dmul_rn(double a, double b) { volatile double r = a * b; return r; }
inline int __float_as_int(float x) { int i; std::memcpy(&i, &x, 4); return i; }
inline long long __double_as_longlong(double x) { long long i; std::memcpy(&i, &x, 8); return i; }
