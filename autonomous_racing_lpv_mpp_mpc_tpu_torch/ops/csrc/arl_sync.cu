// The C entry that reads the cluster fits the group kernels' launches kept
// (arl_sync.cuh, ClusterFit), for utils/profiling.py::clusters_per_wave. A
// translation unit of its own: the table is shared by every kernel's.
#include <cstring>

#include "arl_sync.cuh"

// The kept fits of the kernel named `name` ("megastep_kernel",
// "fused_kernel", "racestep_kernel"), each as three ints into `out` (its
// device, dynamic shared-memory bytes per block, clusters the card holds at
// once), at most `cap` of them. Returns how many fits the kernel has.
extern "C" int arl_cluster_fits(const char* name, int* out, int cap) {
  int n = 0;
  for (int i = 0; i < arl::n_cluster_fits; ++i) {
    const arl::ClusterFit& f = arl::cluster_fits[i];
    if (f.name == nullptr || std::strcmp(f.name, name) != 0) continue;
    if (n < cap) {
      out[3 * n] = f.device;
      out[3 * n + 1] = f.smem;
      out[3 * n + 2] = f.clusters;
    }
    ++n;
  }
  return n;
}
