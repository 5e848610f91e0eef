// The fused kernel's traced instantiations (tracing on: a section-counter
// pointer, utils/profiling.py): fused_kernel<M, SM, true> and its
// co-resident instantiation (<M, SM, true, VoteSlot*>) for both models and
// both operand placements, behind arl::launch_fused_traced, which
// fused_kernel.cu's entry calls when the counters' pointer is set. A
// translation unit of its own so that nvcc builds it beside fused_kernel.cu;
// the kernel's source is that file's.
#define ARL_FUSED_TRACED_TU
#include "fused_kernel.cu"
