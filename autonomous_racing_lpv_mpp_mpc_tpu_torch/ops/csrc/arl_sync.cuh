// Cooperation primitives of the group-cooperative kernels (megastep,
// racestep, fused and solver-only kernels): the G threads that own one lane,
// the lane's slice of dynamic shared memory, the 128-lane early-exit vote
// and the 128-lane maximum (the megastep's cache decision) held across a
// thread block cluster, and the (clustered) launch.
//
// Launch shape: a lane is LANE_THREADS adjacent threads of one warp; a
// block holds BLOCK_LANES lanes; a cluster of CLUSTER blocks holds the 128
// consecutive lanes that leave the ADMM loop together (the JAX package's
// vote group, ops/fused_kernel.py GROUP). ops/fused_kernel.py::launch_shape
// states the same shape; the C entries check the shared-memory bytes it
// computes from it.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace arl {

constexpr int LANE_THREADS = 8;    // G
constexpr int BLOCK_LANES = 16;
constexpr int GROUP_THREADS = LANE_THREADS * BLOCK_LANES;   // threads per block
constexpr int CLUSTER = 128 / BLOCK_LANES;                  // blocks per vote group
static_assert(CLUSTER <= 8, "a portable cluster holds at most 8 blocks");

// The G threads of one lane: g is this thread's index in the group, mask
// the group's bits in the warp. Every exchange names the group's mask only,
// so a group may run while the other groups of its warp do not (lanes past
// B skip all work but the votes).
template <int G>
struct Grp {
  static_assert(G >= 1 && G <= 16 && (G & (G - 1)) == 0, "G threads per lane: 1, 2, 4, 8 or 16");
  int g;
  unsigned mask;
  __device__ __forceinline__ Grp()
      : g(threadIdx.x % G), mask(((1u << G) - 1u) << ((threadIdx.x % 32) / G * G)) {}
  // v of the group's thread src
  __device__ __forceinline__ float bcast(float v, int src) const { return __shfl_sync(mask, v, src, G); }
  // v of the thread g ^ m
  __device__ __forceinline__ float xchg(float v, int m) const { return __shfl_xor_sync(mask, v, m, G); }
  __device__ __forceinline__ int xchg(int v, int m) const { return __shfl_xor_sync(mask, v, m, G); }
  __device__ __forceinline__ float max(float v) const {
#pragma unroll
    for (int m = G / 2; m > 0; m >>= 1) v = fmaxf(v, xchg(v, m));
    return v;
  }
  // orders the group's shared- and device-memory writes before its reads
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
};

// The block's dynamic shared memory.
__device__ __forceinline__ float* dyn_smem() {
  extern __shared__ __align__(16) float arl_smem[];
  return arl_smem;
}

// True on every thread of the cluster iff `mine` holds on every thread of
// it: a block-wide AND, then each block's flag read across the cluster
// (distributed shared memory) between two cluster barriers. Every thread of
// every block of the cluster calls it the same number of times.
__device__ __forceinline__ bool vote_all(bool mine) {
  namespace cg = cooperative_groups;
  __shared__ int flag;
  const int blk = __syncthreads_and(mine);
  cg::cluster_group cl = cg::this_cluster();
  const unsigned n = cl.num_blocks();
  if (n == 1) return blk != 0;
  if (threadIdx.x == 0) flag = blk;
  cl.sync();
  int all = 1;
  for (unsigned r = 0; r < n; ++r) all &= *cl.map_shared_rank(&flag, r);
  cl.sync();   // no block writes its next flag before every block has read this one
  return all != 0;
}

// The largest `mine` over every thread of the cluster, on every thread of
// it: a warp max by shuffles, a block max through shared memory, then each
// block's maximum read across the cluster (distributed shared memory)
// between two cluster barriers, as in vote_all. A max is exact, so every
// thread returns the same float. Every thread of every block of the
// cluster calls it the same number of times, with every lane of its warp.
__device__ __forceinline__ float max_all(float mine) {
  namespace cg = cooperative_groups;
  __shared__ float warp_max[32];
  __shared__ float blk_max;
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) mine = fmaxf(mine, __shfl_xor_sync(0xffffffffu, mine, m));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = mine;
  __syncthreads();
  float blk = warp_max[0];
  for (unsigned w = 1; w < (blockDim.x + 31) / 32; ++w) blk = fmaxf(blk, warp_max[w]);
  cg::cluster_group cl = cg::this_cluster();
  const unsigned n = cl.num_blocks();
  if (n == 1) {
    __syncthreads();   // no warp writes its next maximum before every thread has read this one
    return blk;
  }
  if (threadIdx.x == 0) blk_max = blk;
  cl.sync();
  float all = blk;
  for (unsigned r = 0; r < n; ++r) all = fmaxf(all, *cl.map_shared_rank(&blk_max, r));
  cl.sync();   // no block writes its next maximum before every block has read this one
  return all;
}

// Launch `kern` on `grid` blocks of `threads` threads in clusters of
// `cluster` blocks (1: no cluster) with `smem` bytes of dynamic shared
// memory. Returns 0, -4 if the card cannot hold one such cluster, or the
// CUDA error.
//
// The kernel's dynamic shared-memory limit is raised before any launch that
// needs more than the limit set on this device so far (never lowered, so
// any sequence of horizons launches), and a cluster's fit is checked for
// every amount above the largest that fitted.
template <class P>
int launch_grouped(void (*kern)(P), const P& p, int grid, int threads, int cluster, int smem,
                   void* stream) {
  struct Seen {
    void (*kern)(P);
    int device, allowed, fitted;
  };
  static Seen seen[32];
  static int n_seen = 0;
  cudaGetLastError();   // an earlier call's error is not this launch's
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  Seen none{kern, device, -1, -1};
  Seen* s = &none;
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].kern == kern && seen[i].device == device) s = &seen[i];
  if (s == &none && n_seen < 32) {
    seen[n_seen] = none;
    s = &seen[n_seen++];
  }
  if (smem > s->allowed) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    s->allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  if (cluster > 1 && smem > s->fitted) {
    int fit = 0;
    e = cudaOccupancyMaxActiveClusters(&fit, kern, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (fit < 1) return -4;
    s->fitted = smem;
  }
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The group core's launch: blocks of GROUP_THREADS threads in clusters of
// CLUSTER blocks (one 128-lane vote group per cluster).
template <class P>
int launch_clustered(void (*kern)(P), const P& p, int grid, int smem, void* stream) {
  return launch_grouped(kern, p, grid, GROUP_THREADS, CLUSTER, smem, stream);
}

}  // namespace arl
