// A CPU stand-in for the parts of CUDA that the port's kernels use, so
// that csrc/paged_attention.cu and csrc/flash_attention.cu compile with a
// host C++ compiler and their launches run on the CPU
// (tests/torch_port_cuda_emulator.py). One std::thread per CUDA thread:
// __syncthreads is a barrier of the block's threads, a warp's shuffles,
// __syncwarp and mma.sync exchange through a barrier of its 32 lanes, and
// a thread-block cluster's blocks run at once, with cluster.sync() a
// barrier of all their threads and map_shared_rank() an address in
// another block's shared memory. cp.async copies synchronously; mma.sync
// m16n8k8 TF32 reads its operands as TF32 (the low 13 bits dropped) and
// adds exact products to fp32.
//
// Hopper's pieces of the bf16 and fp16 flash bodies: an mbarrier counts arrivals
// and transaction bytes and completes its phase when both reach zero
// (a wait blocks on a condition variable, and gives up after five minutes); a
// TMA tile load copies its box at once, past-the-bounds elements as
// zeros, through the 128-byte swizzle (16-byte chunk bits 4-6 of the
// shared-memory address XORed with bits 7-9), then completes its bytes on
// the barrier; wgmma m64n64k16 bf16 or fp16 decodes its shared-memory descriptors
// (start, lbo, sbo, the 128-byte swizzle; K-major or MN-major), takes A
// from the warp's registers where asked, and adds exact products to the
// fp32 accumulator. A wgmma completes as it is called, so the kernels'
// fences, commits and waits are no-ops here.
//
// Devices: a current device a host thread (cudaSetDevice, cudaGetDevice;
// emu_devices of them), and each kernel's dynamic shared-memory limit
// kept by (kernel, device), as the real runtime keeps it: a launch that
// asks for more than 48 KB on a device where cudaFuncSetAttribute did not
// raise that kernel's limit far enough is refused with
// cudaErrorInvalidValue, reported by the launch (cudaLaunchKernelEx) or by
// the next cudaGetLastError (a <<<...>>> launch). The kernels do not run
// on any particular device here: the device only keys the limits.
#pragma once
#include <algorithm>
#include <barrier>
#include <chrono>
#include <climits>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#include "cuda.h"
using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __grid_constant__
#define CUDART_VERSION 12080

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
struct EmuMbar {
  int expected = 0, pending = 0;
  long tx = 0;          // bytes announced and not yet landed
  unsigned phases = 0;  // completed phases
};
struct EmuCluster;
struct EmuBlock {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<unsigned char> smem;
  std::vector<std::unique_ptr<EmuWarp>> warps;
  EmuCluster* cluster;
  std::mutex mbar_mu;
  std::condition_variable mbar_cv;
  std::map<uint32_t, EmuMbar> mbars;  // by shared-memory offset
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
inline float __shfl_sync(unsigned, float x, int src) {
  const uint64_t v = __float_as_uint(x);
  float r = 0.f;
  emu_warp_exchange(&v, 1, [&](uint64_t (&s)[32][8]) {
    r = __uint_as_float(static_cast<unsigned>(s[src & 31][0]));
  });
  return r;
}
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_block->warps[threadIdx.x / 32]->bar.arrive_and_wait();
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

[[noreturn]] inline void emu_fail(const char* what) {
  std::fprintf(stderr, "cuda emulator: %s (block %u,%u,%u thread %u)\n", what, blockIdx.x,
               blockIdx.y, blockIdx.z, threadIdx.x);
  std::abort();
}
inline uint32_t emu_smem_offset(const void* p) {
  const auto off = static_cast<const unsigned char*>(p) - emu_smem();
  if (off < 0 || static_cast<size_t>(off) > emu_block->smem.size()) emu_fail("not a shared-memory address");
  return static_cast<uint32_t>(off);
}

// ------------------------------------------------------------- mbarrier

// completes the phase if every arrival and byte is in (under the lock)
inline void emu_mbar_settle(EmuMbar& m) {
  if (m.pending < 0 || m.tx < 0) emu_fail("mbarrier over-arrived");
  if (m.pending == 0 && m.tx == 0) {
    ++m.phases;
    m.pending = m.expected;
    emu_block->mbar_cv.notify_all();
  }
}
inline void emu_mbar_init(void* bar, int count) {
  std::lock_guard<std::mutex> lk(emu_block->mbar_mu);
  EmuMbar& m = emu_block->mbars[emu_smem_offset(bar)];
  m = EmuMbar{count, count, 0, 0};
}
inline EmuMbar& emu_mbar(void* bar) {  // under the lock
  auto it = emu_block->mbars.find(emu_smem_offset(bar));
  if (it == emu_block->mbars.end()) emu_fail("mbarrier used before its init");
  return it->second;
}
// an arrival that first announces `tx` bytes to come
inline void emu_mbar_arrive(void* bar, uint32_t tx) {
  std::lock_guard<std::mutex> lk(emu_block->mbar_mu);
  EmuMbar& m = emu_mbar(bar);
  m.tx += tx;
  m.pending -= 1;
  emu_mbar_settle(m);
}
inline void emu_mbar_complete_tx(void* bar, uint32_t bytes) {
  std::lock_guard<std::mutex> lk(emu_block->mbar_mu);
  EmuMbar& m = emu_mbar(bar);
  m.tx -= bytes;
  emu_mbar_settle(m);
}
// blocks until the phase of this parity has completed
inline void emu_mbar_wait(void* bar, uint32_t parity) {
  std::unique_lock<std::mutex> lk(emu_block->mbar_mu);
  EmuMbar& m = emu_mbar(bar);
  if (!emu_block->mbar_cv.wait_for(lk, std::chrono::seconds(300),
                                   [&] { return (m.phases & 1u) != (parity & 1u); }))
    emu_fail("mbarrier wait timed out");
}

// ------------------------------------------------------------------ TMA

inline uint32_t emu_swizzle128(uint32_t addr) { return addr ^ (((addr >> 7) & 7u) << 4); }

// the box at coordinates c of a tiled tensor map into shared memory at
// dst, then its bytes completed on bar
inline void emu_tma_load(void* dst, const CUtensorMap* map, void* bar, const int* c) {
  const EmuTensorMap& m = *reinterpret_cast<const EmuTensorMap*>(map);
  const uint32_t off = emu_smem_offset(dst);
  if (m.swizzle_bytes != 0 && m.swizzle_bytes != 128) emu_fail("only the 128-byte swizzle is emulated");
  if (m.swizzle_bytes == 128 && (off & 1023u)) emu_fail("a 128-byte-swizzled box needs a 1024-byte-aligned destination");
  uint64_t n = 1;
  for (uint32_t d = 0; d < m.rank; ++d) n *= m.box[d];
  for (uint64_t e = 0; e < n; ++e) {
    uint64_t rest = e, src = 0;
    bool in = true;
    for (uint32_t d = 0; d < m.rank; ++d) {
      const int64_t x = static_cast<int64_t>(c[d]) + static_cast<int64_t>(rest % m.box[d]);
      rest /= m.box[d];
      in = in && x >= 0 && static_cast<uint64_t>(x) < m.dims[d];
      src += static_cast<uint64_t>(x) * m.strides[d];
    }
    uint32_t at = off + static_cast<uint32_t>(e * m.esize);
    if (m.swizzle_bytes) at = emu_swizzle128(at);
    if (at + m.esize > emu_block->smem.size()) emu_fail("TMA box past the block's shared memory");
    if (in) std::memcpy(emu_smem() + at, m.base + src, m.esize);
    else std::memset(emu_smem() + at, 0, m.esize);
  }
  emu_mbar_complete_tx(bar, static_cast<uint32_t>(n * m.esize));
}

// ---------------------------------------------------------------- wgmma

// shared-memory address of element (mn, k) of a wgmma operand from its
// descriptor (128-byte swizzle): K-major, the row mn holds k at 2 bytes
// apart, 8-row groups sbo apart; MN-major, the row k holds mn, 8-row
// groups of k sbo apart, 64-element blocks of mn lbo apart
inline uint32_t emu_gmma_addr(uint64_t desc, int mn, int k, bool mn_major) {
  const uint32_t start = static_cast<uint32_t>(desc & 0x3fff) << 4;
  const uint32_t lbo = static_cast<uint32_t>((desc >> 16) & 0x3fff) << 4;
  const uint32_t sbo = static_cast<uint32_t>((desc >> 32) & 0x3fff) << 4;
  if ((desc >> 62) != 1 || ((desc >> 49) & 7)) emu_fail("only 128-byte-swizzled descriptors at base offset 0 are emulated");
  const uint32_t a = mn_major ? start + (k / 8) * sbo + (k % 8) * 128 + (mn / 64) * lbo + (mn % 64) * 2
                              : start + (mn / 8) * sbo + (mn % 8) * 128 + k * 2;
  return emu_swizzle128(a);
}
inline float emu_bf16_bits(uint32_t b) { return __uint_as_float((b & 0xffffu) << 16); }
// an fp16 value from its low 16 bits, exactly
inline float emu_half_bits(uint32_t b) {
  const unsigned s = (b >> 15) & 1, e = (b >> 10) & 31, m = b & 1023;
  float v;
  if (e == 0) v = std::ldexp(static_cast<float>(m), -24);
  else if (e == 31) v = m ? NAN : INFINITY;
  else v = std::ldexp(static_cast<float>(m | 1024), static_cast<int>(e) - 25);
  return s ? -v : v;
}
// a wgmma operand element from its 16 bits: fp16 or bf16
inline float emu_elem_bits(uint32_t b, bool f16) { return f16 ? emu_half_bits(b & 0xffffu) : emu_bf16_bits(b); }
inline float emu_elem_at(uint32_t addr, bool f16) {
  if (addr + 2 > emu_block->smem.size()) emu_fail("wgmma operand past the block's shared memory");
  uint16_t b;
  std::memcpy(&b, emu_smem() + addr, 2);
  return emu_elem_bits(b, f16);
}
// d += A B for the warpgroup's 64 x 64 x 16 tile: this thread's 32
// accumulators (element i: row 16w + g + 8 ((i >> 1) & 1), column
// 8 (i >> 2) + 2t + (i & 1)); A from the warp's registers (a_regs, the
// m16n8k16 A layout) or from shared memory (K-major, a_desc); B from
// shared memory, K-major or MN-major; f16: the operands are fp16, else bf16
inline void emu_wgmma(float (&d)[32], const uint32_t* a_regs, uint64_t a_desc, uint64_t b_desc,
                      bool b_mn_major, bool f16) {
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float a[2][16];  // rows 16w + g and 16w + g + 8 of A
  if (a_regs != nullptr) {
    const uint64_t mine[4] = {a_regs[0], a_regs[1], a_regs[2], a_regs[3]};
    emu_warp_exchange(mine, 4, [&](uint64_t (&s)[32][8]) {
      for (int r = 0; r < 2; ++r)
        for (int k = 0; k < 16; ++k)
          a[r][k] = emu_elem_bits(static_cast<uint32_t>(
              s[4 * g + (k % 8) / 2][r + 2 * (k >= 8)] >> (16 * (k & 1))), f16);
    });
  } else {
    for (int r = 0; r < 2; ++r)
      for (int k = 0; k < 16; ++k) a[r][k] = emu_elem_at(emu_gmma_addr(a_desc, 16 * w + g + 8 * r, k, false), f16);
  }
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1, n = 8 * (i >> 2) + 2 * t + (i & 1);
    double acc = 0.0;
    for (int k = 0; k < 16; ++k)
      acc += static_cast<double>(a[r][k]) * static_cast<double>(emu_elem_at(emu_gmma_addr(b_desc, n, k, b_mn_major), f16));
    d[i] = static_cast<float>(static_cast<double>(d[i]) + acc);
  }
}

typedef int cudaError_t;
constexpr cudaError_t cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidDevice = 101,
                      cudaErrorNotSupported = 801;
enum cudaDriverEntryPointQueryResult {
  cudaDriverEntryPointSuccess = 0, cudaDriverEntryPointSymbolNotFound = 1
};
constexpr unsigned long long cudaEnableDefault = 0;
inline cudaError_t cudaGetDriverEntryPointByVersion(const char* symbol, void** fn, unsigned,
                                                    unsigned long long,
                                                    cudaDriverEntryPointQueryResult* status) {
  const bool found = std::strcmp(symbol, "cuTensorMapEncodeTiled") == 0;
  *fn = found ? reinterpret_cast<void*>(&emu_encode_tiled) : nullptr;
  *status = found ? cudaDriverEntryPointSuccess : cudaDriverEntryPointSymbolNotFound;
  return cudaSuccess;
}
typedef void* cudaStream_t;
enum { cudaLaunchAttributeClusterDimension = 4 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8, cudaFuncAttributePreferredSharedMemoryCarveout = 9 };
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
inline int emu_devices = 2;
inline thread_local int emu_device = 0;
inline thread_local cudaError_t emu_last_error = cudaSuccess;
inline cudaError_t emu_error(cudaError_t e) {
  if (e != cudaSuccess) emu_last_error = e;
  return e;
}
inline cudaError_t cudaGetDevice(int* d) { *d = emu_device; return cudaSuccess; }
inline cudaError_t cudaSetDevice(int d) {
  if (d < 0 || d >= emu_devices) return emu_error(cudaErrorInvalidDevice);
  emu_device = d;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = emu_sms; return cudaSuccess; }
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = emu_last_error;
  emu_last_error = cudaSuccess;
  return e;
}
// each kernel's raised dynamic shared-memory limit, by (kernel, device)
inline std::mutex emu_limit_mu;
inline std::map<std::pair<const void*, int>, int> emu_smem_limits;
template <typename K>
cudaError_t cudaFuncSetAttribute(K kernel, int attr, int value) {
  if (attr == cudaFuncAttributeMaxDynamicSharedMemorySize) {
    std::lock_guard<std::mutex> lk(emu_limit_mu);
    emu_smem_limits[{reinterpret_cast<const void*>(kernel), emu_device}] = value;
  }
  return cudaSuccess;
}
// may this kernel launch with `bytes` of dynamic shared memory on the
// current device
inline bool emu_smem_allowed(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return true;
  std::lock_guard<std::mutex> lk(emu_limit_mu);
  const auto it = emu_smem_limits.find({kernel, emu_device});
  return it != emu_smem_limits.end() && static_cast<size_t>(it->second) >= bytes;
}
// one block an SM: the emulator runs the grid block by block
template <typename K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return cudaSuccess;
}

// runs the grid cluster by cluster; shared memory starts as NaN bits, so
// a read of what no thread wrote shows in the output
template <typename... P, typename... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(P...), A... args) {
  unsigned C = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) C = cfg->attrs[i].val.clusterDim.x;
  if (C < 1 || cfg->gridDim.x % C) return emu_error(cudaErrorInvalidValue);
  if (!emu_smem_allowed(reinterpret_cast<const void*>(kernel), cfg->dynamicSmemBytes))
    return emu_error(cudaErrorInvalidValue);
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

// kernel<<<grid, block, smem, stream>>>(args...), rewritten as a call; a
// refused launch is reported by the next cudaGetLastError, as on the card
template <typename... P, typename... A>
cudaError_t emu_launch(void (*kernel)(P...), dim3 grid, dim3 block, size_t smem,
                       cudaStream_t stream, A... args) {
  cudaLaunchConfig_t cfg{grid, block, smem, stream, nullptr, 0};
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}
