// The megastep's traced instantiations (tracing on: a section-counter
// pointer, utils/profiling.py): megastep_kernel<M, SM, false, true> and its
// co-resident instantiation (<..., VoteSlot*>) for both models and both
// operand placements, behind arl::launch_megastep_traced, which
// megastep_kernel.cu's entry calls when the counters' pointer is set and no
// cache is given. A translation unit of its own so that nvcc builds it
// beside megastep_kernel.cu; the kernel's source is that file's.
#define ARL_MEGASTEP_TRACED_TU
#include "megastep_kernel.cu"
