// Cooperation primitives of the group-cooperative kernels (megastep,
// racestep, fused and solver-only kernels): the G threads that own one lane,
// the lane's slice of dynamic shared memory, the 128-lane early-exit vote
// and the 128-lane maximum (the megastep's cache decision), and the launch
// that places each 128-lane group with the fits it keeps.
//
// Launch shape: a lane is LANE_THREADS adjacent threads of one warp; a
// block holds BLOCK_LANES lanes; CLUSTER consecutive blocks hold the 128
// consecutive lanes that leave the ADMM loop together (the JAX package's
// vote group, ops/fused_kernel.py GROUP). ops/fused_kernel.py::launch_shape
// states the same shape; the C entries check the shared-memory bytes it
// computes from it.
//
// Two ways to launch a group (launch_group): as a thread block cluster,
// whose vote reads the blocks' flags through distributed shared memory
// (vote_all), or, where the launch votes, holds more groups than the card
// runs as clusters at once and its whole grid fits the card at once, as a
// cooperative launch without clusters, whose vote goes through device
// memory (vote_all_resident). A cluster's blocks must share one GPC, so the
// card holds fewer blocks as clusters than it has block places (at N=20, 30
// clusters of 8 where 264 blocks fit: B=4,096 took two waves); the
// cooperative launch runs the whole grid in one wave. Each group has the
// same blocks, lanes and slices either way, so the outputs are the same.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>

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

// A 128-lane group's slots of the co-resident vote, in device memory:
// `arrived` counts the blocks that reached the current vote (low byte) and,
// in units of NAY, those that voted "no"; `gen` is the group's number of
// votes so far times two, plus the last vote's result. The group's last
// block to arrive resets `arrived` before it publishes `gen`, so the slots
// are at rest between votes and after every launch: they need no epoch, no
// memset and no host step, whatever the launches before. One 32-byte sector
// a group, MAX_VOTE_GROUPS of them per device, allocated and zeroed once,
// at the device's first co-resident launch (resident_groups), and handed to
// the co-resident instantiation as a second kernel argument, so that the
// clustered instantiations have the parameters, calls and code of kernels
// without the co-resident path (a module-scope array, or a member of the
// parameters, changed the clustered kernels' SASS).
struct VoteSlot {
  unsigned arrived, gen;
  unsigned pad[6];
};
constexpr int MAX_VOTE_GROUPS = 1024;
constexpr unsigned NAY = 1u << 8;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// vote_all for a co-resident launch (every block of the grid resident at
// once, launch_group; `slots` the device's): a block-wide AND, then thread 0
// adds the block's arrival and vote into its group's slots and waits until
// the group's eighth block has arrived and published the result; every
// thread returns it. Thread 0 reads `gen` (acquire) before it arrives, so
// the value it waits to see change is this vote's: the vote cannot end
// before its arrival. Every thread of every block of the group calls it the
// same number of times.
__device__ __forceinline__ bool vote_all_resident(bool mine, VoteSlot* slots) {
  __shared__ int flag;
  const int blk = __syncthreads_and(mine);
  if (threadIdx.x == 0) {
    VoteSlot& s = slots[blockIdx.x / CLUSTER];
    const unsigned gen = ld_acquire(&s.gen);
    const unsigned add = blk ? 1u : 1u + NAY;
    const unsigned now = atomicAdd(&s.arrived, add) + add;
    unsigned next;
    if ((now & (NAY - 1u)) == CLUSTER) {   // the last block: rest the slots, publish
      st_relaxed(&s.arrived, 0u);
      next = ((gen & ~1u) + 2u) | (now < NAY ? 1u : 0u);
      st_release(&s.gen, next);
    } else {
      do next = ld_acquire(&s.gen);
      while (next == gen);
    }
    flag = (int)(next & 1u);
  }
  __syncthreads();   // the next vote's flag is written after its __syncthreads_and
  return flag != 0;
}

// The group's vote: across the cluster, or, given the device's slots (the
// co-resident launch), through device memory. The group kernels take the
// slots as a parameter pack (`Vote... vote`): empty in the clustered
// instantiations, one VoteSlot* in the co-resident ones.
__device__ __forceinline__ bool vote_group(bool mine) { return vote_all(mine); }

__device__ __forceinline__ bool vote_group(bool mine, VoteSlot* slots) {
  return vote_all_resident(mine, slots);
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

// The 128-lane groups of a launch's shape that the card holds at once, per
// kernel instantiation, device and dynamic shared-memory bytes: a clustered
// launch's clusters (cudaOccupancyMaxActiveClusters), a co-resident launch's
// block places over CLUSTER (`resident`); kept at the first such launch,
// under the kernel's name, for arl_cluster_fits (arl_sync.cu). A clustered
// launch of B lanes runs in ceil(B / 128 / groups) waves, a co-resident one
// in one.
struct ClusterFit {
  const void* kern;
  const char* name;
  int device, smem, groups, resident;
};
constexpr int MAX_FITS = 64;
inline ClusterFit cluster_fits[MAX_FITS];
inline int n_cluster_fits = 0;

inline void keep_fit(const void* kern, const char* name, int device, int smem, int groups,
                     int resident) {
  for (int i = 0; i < n_cluster_fits; ++i) {
    const ClusterFit& f = cluster_fits[i];
    if (f.kern == kern && f.device == device && f.smem == smem) return;
  }
  if (n_cluster_fits < MAX_FITS)
    cluster_fits[n_cluster_fits++] = {kern, name, device, smem, groups, resident};
}

// Raise `kern`'s dynamic shared-memory limit to `smem` where that is more
// than the limit set on this device so far (never lowered, so any sequence
// of horizons launches).
struct SmemLimit {
  const void* kern;
  int device, allowed;
};
inline SmemLimit smem_limits[128];
inline int n_smem_limits = 0;

template <class K>
cudaError_t allow_smem(K* kern, int device, int smem) {
  const void* key = reinterpret_cast<const void*>(kern);
  SmemLimit none{key, device, -1};
  SmemLimit* s = &none;
  for (int i = 0; i < n_smem_limits; ++i)
    if (smem_limits[i].kern == key && smem_limits[i].device == device) s = &smem_limits[i];
  if (s == &none && n_smem_limits < 128) {
    smem_limits[n_smem_limits] = none;
    s = &smem_limits[n_smem_limits++];
  }
  if (smem <= s->allowed) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) s->allowed = smem;
  return e;
}

// The clusters of `cluster` blocks of `threads` threads with `smem` bytes
// of dynamic shared memory that the card holds at once (into `fit`).
template <class P>
cudaError_t max_clusters(void (*kern)(P), int threads, int cluster, int smem, int* fit) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(fit, kern, &cfg);
}

// Launch `kern` on `grid` blocks of `threads` threads in clusters of
// `cluster` blocks (1: no cluster) with `smem` bytes of dynamic shared
// memory. Returns 0, -4 if the card cannot hold one such cluster, or the
// CUDA error. A clustered launch's fit is asked once per amount and kept
// (ClusterFit, under `name`).
template <class P>
int launch_grouped(void (*kern)(P), const P& p, int grid, int threads, int cluster, int smem,
                   void* stream, const char* name = nullptr) {
  cudaGetLastError();   // an earlier call's error is not this launch's
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = allow_smem(kern, device, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
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
  if (cluster > 1) {
    const void* key = reinterpret_cast<const void*>(kern);
    bool known = false;
    for (int i = 0; i < n_cluster_fits; ++i) {
      const ClusterFit& f = cluster_fits[i];
      known |= f.kern == key && f.device == device && f.smem == smem;
    }
    if (!known) {
      int fit = 0;
      e = max_clusters(kern, threads, cluster, smem, &fit);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (fit < 1) return -4;
      keep_fit(key, name, device, smem, fit, 0);
    }
  }
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The group core's clustered launch: blocks of GROUP_THREADS threads in
// clusters of CLUSTER blocks (one 128-lane vote group per cluster); `name`
// the kernel's, under which its cluster fit is kept.
template <class P>
int launch_clustered(void (*kern)(P), const P& p, int grid, int smem, void* stream,
                     const char* name) {
  return launch_grouped(kern, p, grid, GROUP_THREADS, CLUSTER, smem, stream, name);
}

// What decides a shape's path, asked once per co-resident instantiation,
// device and dynamic shared-memory bytes: the clusters of the clustered
// instantiation the card holds at once, and the groups of the co-resident
// one it holds at once (block places over CLUSTER; 0 where the card takes
// no cooperative launch).
struct ResidentFit {
  const void* kern;
  int device, smem, clusters, groups;
};
inline ResidentFit resident_fits[MAX_FITS];
inline int n_resident_fits = 0;

// The stream that runs each device's co-resident launches, the first to
// take the path there, and the device's vote slots. A group's slots
// (VoteSlot) hold one vote at a time, so two launches must not vote in them
// at once; launches on one stream run one after the other, whereas on two
// streams a launch's blocks may start while the last groups of the other's
// still vote. So a launch on any other stream of the device takes the
// clustered path.
constexpr int MAX_DEVICES = 64;
inline void* resident_stream[MAX_DEVICES];
inline VoteSlot* resident_slots[MAX_DEVICES];
inline std::mutex resident_mutex;

// The groups the card holds at once on the co-resident path where this
// launch takes it (`slots` then the device's vote slots), else 0.
template <class P>
int resident_groups(void (*clustered)(P), void (*resident)(P, VoteSlot*), int device, int grid,
                    int smem, void* stream, VoteSlot** slots) {
  if (device < 0 || device >= MAX_DEVICES) return 0;
  std::lock_guard<std::mutex> lock(resident_mutex);
  const void* key = reinterpret_cast<const void*>(resident);
  const ResidentFit* f = nullptr;
  for (int i = 0; i < n_resident_fits; ++i) {
    const ResidentFit& r = resident_fits[i];
    if (r.kern == key && r.device == device && r.smem == smem) f = &r;
  }
  if (f == nullptr) {
    if (n_resident_fits == MAX_FITS) return 0;
    ResidentFit r{key, device, smem, 0, 0};
    int coop = 0, sms = 0, per_sm = 0;
    const bool asked =
        allow_smem(clustered, device, smem) == cudaSuccess &&
        allow_smem(resident, device, smem) == cudaSuccess &&
        max_clusters(clustered, GROUP_THREADS, CLUSTER, smem, &r.clusters) == cudaSuccess &&
        cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device) == cudaSuccess &&
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) == cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, resident, GROUP_THREADS, smem) ==
            cudaSuccess;
    cudaGetLastError();   // a refused question is not the launch's error
    if (asked && coop) r.groups = per_sm * sms / CLUSTER;
    resident_fits[n_resident_fits] = r;
    f = &resident_fits[n_resident_fits++];
  }
  const int groups = grid / CLUSTER;
  if (groups <= f->clusters || groups > f->groups || groups > MAX_VOTE_GROUPS) return 0;
  if (resident_slots[device] == nullptr) {   // the device's first co-resident launch
    const size_t bytes = MAX_VOTE_GROUPS * sizeof(VoteSlot);
    VoteSlot* d = nullptr;
    if (cudaMalloc(&d, bytes) != cudaSuccess ||
        cudaMemsetAsync(d, 0, bytes, static_cast<cudaStream_t>(stream)) != cudaSuccess) {
      if (d != nullptr) cudaFree(d);
      cudaGetLastError();
      return 0;
    }
    resident_slots[device] = d;
    resident_stream[device] = stream;
  }
  if (resident_stream[device] != stream) return 0;
  *slots = resident_slots[device];
  return f->groups;
}

// The group core's launch (megastep, racestep, fused kernel): co-resident
// (`resident`, the instantiation whose vote is vote_all_resident on the
// slots it takes as its second argument) where the launch votes (early
// exit), holds more 128-lane groups than the card holds clusters at once
// and its whole grid fits the card at once (a cooperative launch without
// clusters; its fit kept under `name` as the groups it holds at once), else
// clustered (`clustered`). Chosen from the launch's shape, the card and the
// stream, asked once per shape; the path changes no output.
template <class P>
int launch_group(void (*clustered)(P), void (*resident)(P, VoteSlot*), const P& p, int grid,
                 int smem, void* stream, const char* name, bool votes) {
  int device = 0;
  VoteSlot* slots = nullptr;
  if (votes && cudaGetDevice(&device) == cudaSuccess) {
    const int groups = resident_groups(clustered, resident, device, grid, smem, stream, &slots);
    if (groups > 0) {
      keep_fit(reinterpret_cast<const void*>(resident), name, device, smem, groups, 1);
      cudaGetLastError();   // an earlier call's error is not this launch's
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(grid);
      cfg.blockDim = dim3(GROUP_THREADS);
      cfg.dynamicSmemBytes = smem;
      cfg.stream = static_cast<cudaStream_t>(stream);
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeCooperative;
      attr[0].val.cooperative = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      const cudaError_t e = cudaLaunchKernelEx(&cfg, resident, p, slots);
      if (e != cudaSuccess) return static_cast<int>(e);
      return static_cast<int>(cudaGetLastError());
    }
  }
  return launch_clustered(clustered, p, grid, smem, stream, name);
}

}  // namespace arl
