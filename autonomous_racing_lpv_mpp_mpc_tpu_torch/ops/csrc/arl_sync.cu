// The C entry that reads the fits the group kernels' launches kept
// (arl_sync.cuh, ClusterFit), for utils/profiling.py::group_fits. A
// translation unit of its own: the table is shared by every kernel's.
#include <cstring>

#include "arl_sync.cuh"

// The kept fits of the kernel named `name` ("megastep_kernel",
// "fused_kernel", "racestep_kernel"), each as four ints into `out` (its
// device, dynamic shared-memory bytes per block, 128-lane groups the card
// holds at once, 1 for a co-resident launch and 0 for a clustered one), at
// most `cap` of them. Returns how many fits the kernel has.
extern "C" int arl_cluster_fits(const char* name, int* out, int cap) {
  int n = 0;
  for (int i = 0; i < arl::n_cluster_fits; ++i) {
    const arl::ClusterFit& f = arl::cluster_fits[i];
    if (f.name == nullptr || std::strcmp(f.name, name) != 0) continue;
    if (n < cap) {
      out[4 * n] = f.device;
      out[4 * n + 1] = f.smem;
      out[4 * n + 2] = f.groups;
      out[4 * n + 3] = f.resident;
    }
    ++n;
  }
  return n;
}
