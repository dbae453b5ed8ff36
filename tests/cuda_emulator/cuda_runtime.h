// A CPU stand-in for the parts of CUDA that the port's paged attention
// kernel uses, so that csrc/paged_attention.cu compiles with a host C++
// compiler and its launches run on the CPU (tests/torch_port_cuda_emulator.py).
// One std::thread per CUDA thread: __syncthreads is a barrier of the
// block's threads, a warp's shuffles and mma.sync exchange through a
// barrier of its 32 lanes, and a thread-block cluster's blocks run at
// once, with cluster.sync() a barrier of all their threads and
// map_shared_rank() an address in another block's shared memory.
// cp.async copies synchronously; mma.sync m16n8k8 TF32 reads its operands
// as TF32 (the low 13 bits dropped) and adds exact products to fp32.
#pragma once
#include <algorithm>
#include <barrier>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() = default;
  dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
template <typename T> inline T __ldg(const T* p) { return *p; }

struct EmuWarp {
  std::barrier<> bar{32};
  uint64_t slot[32][8];
};
struct EmuCluster;
struct EmuBlock {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<unsigned char> smem;
  std::vector<std::unique_ptr<EmuWarp>> warps;
  EmuCluster* cluster;
};
struct EmuCluster {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<EmuBlock*> blocks;
};
inline thread_local dim3 threadIdx, blockIdx, gridDim, blockDim;
inline thread_local EmuBlock* emu_block = nullptr;
inline unsigned char* emu_smem() { return emu_block->smem.data(); }
inline void __syncthreads() { emu_block->bar->arrive_and_wait(); }

// every lane of the warp puts n words, then `read` sees every lane's
template <typename F>
inline void emu_warp_exchange(const uint64_t* mine, int n, F&& read) {
  EmuWarp& w = *emu_block->warps[threadIdx.x / 32];
  const int lane = threadIdx.x & 31;
  for (int i = 0; i < n; ++i) w.slot[lane][i] = mine[i];
  w.bar.arrive_and_wait();
  read(w.slot);
  w.bar.arrive_and_wait();
}
inline float __shfl_xor_sync(unsigned, float x, int o) {
  const uint64_t v = __float_as_uint(x);
  const int lane = threadIdx.x & 31;
  float r = 0.f;
  emu_warp_exchange(&v, 1, [&](uint64_t (&s)[32][8]) {
    r = __uint_as_float(static_cast<unsigned>(s[lane ^ o][0]));
  });
  return r;
}
inline int __reduce_max_sync(unsigned, int x) {
  const uint64_t v = static_cast<uint32_t>(x);
  int r = INT_MIN;
  emu_warp_exchange(&v, 1, [&](uint64_t (&s)[32][8]) {
    for (int l = 0; l < 32; ++l) r = std::max(r, static_cast<int>(static_cast<uint32_t>(s[l][0])));
  });
  return r;
}
// c += a b for the warp's 16 x 8 x 8 tile in the fragment layouts of
// mma.sync.m16n8k8 (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g+8, t),
// a2 (g, t+4), a3 (g+8, t+4); b0 (k t, n g), b1 (k t+4, n g); c0 (g, 2t),
// c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
inline void emu_mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  const uint64_t v[6] = {a[0], a[1], a[2], a[3], b[0], b[1]};
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float out[4];
  emu_warp_exchange(v, 6, [&](uint64_t (&s)[32][8]) {
    auto tf32 = [](uint64_t bits) { return __uint_as_float(static_cast<uint32_t>(bits) & 0xffffe000u); };
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e >> 1), n = 2 * t + (e & 1);
      double acc = 0.0;
      for (int k = 0; k < 8; ++k)
        acc += static_cast<double>(tf32(s[(row % 8) * 4 + k % 4][(row >= 8) + 2 * (k >= 4)])) *
               static_cast<double>(tf32(s[n * 4 + k % 4][4 + (k >= 4)]));
      out[e] = static_cast<float>(static_cast<double>(c[e]) + acc);
    }
  });
  for (int e = 0; e < 4; ++e) c[e] = out[e];
}

typedef int cudaError_t;
constexpr cudaError_t cudaSuccess = 0, cudaErrorInvalidValue = 1;
typedef void* cudaStream_t;
enum { cudaLaunchAttributeClusterDimension = 4 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum { cudaDevAttrMultiProcessorCount = 16 };
struct cudaLaunchAttribute {
  int id;
  struct { struct { unsigned x, y, z; } clusterDim; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
// the streaming multiprocessors the launchers size their clusters for
inline int emu_sms = 132;
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = emu_sms; return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <typename K>
cudaError_t cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }

// runs the grid cluster by cluster; shared memory starts as NaN bits, so
// a read of what no thread wrote shows in the output
template <typename... P, typename... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(P...), A... args) {
  unsigned C = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) C = cfg->attrs[i].val.clusterDim.x;
  if (C < 1 || cfg->gridDim.x % C) return cudaErrorInvalidValue;
  const unsigned nt = cfg->blockDim.x;
  const dim3 grid = cfg->gridDim;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x0 = 0; x0 < grid.x; x0 += C) {
        EmuCluster cluster;
        cluster.bar = std::make_unique<std::barrier<>>(C * nt);
        std::vector<std::unique_ptr<EmuBlock>> blocks;
        for (unsigned r = 0; r < C; ++r) {
          auto blk = std::make_unique<EmuBlock>();
          blk->bar = std::make_unique<std::barrier<>>(nt);
          blk->smem.assign(cfg->dynamicSmemBytes, 0xff);
          for (unsigned w = 0; w < nt / 32; ++w) blk->warps.push_back(std::make_unique<EmuWarp>());
          blk->cluster = &cluster;
          cluster.blocks.push_back(blk.get());
          blocks.push_back(std::move(blk));
        }
        std::vector<std::thread> threads;
        for (unsigned r = 0; r < C; ++r)
          for (unsigned tid = 0; tid < nt; ++tid)
            threads.emplace_back([&, r, tid] {
              threadIdx = dim3(tid);
              blockIdx = dim3(x0 + r, y, z);
              gridDim = grid;
              blockDim = dim3(nt);
              emu_block = blocks[r].get();
              kernel(args...);
            });
        for (auto& th : threads) th.join();
      }
  return cudaSuccess;
}
