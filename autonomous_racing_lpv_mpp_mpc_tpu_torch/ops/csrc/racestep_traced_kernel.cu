// The racestep's traced instantiations (tracing on: a section-counter
// pointer, utils/profiling.py): racestep_kernel<SM, true> and its
// co-resident instantiation (<SM, true, VoteSlot*>) for both operand
// placements, behind arl::launch_racestep_traced, which racestep_kernel.cu's
// entry calls when the counters' pointer is set. A translation unit of its
// own so that nvcc builds it beside racestep_kernel.cu; the kernel's source
// is that file's.
#define ARL_RACESTEP_TRACED_TU
#include "racestep_kernel.cu"
