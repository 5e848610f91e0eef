// The megastep's instantiations with the discretization cache
// (SolverConfig.cache_build): megastep_kernel<M, SM, true> for both models
// and both operand placements, behind arl::launch_megastep_cached, which
// megastep_kernel.cu's entry calls when the cache's pointers are set. A
// translation unit of its own so that nvcc builds it beside
// megastep_kernel.cu; the kernel's source is that file's.
#define ARL_MEGASTEP_CACHED_TU
#include "megastep_kernel.cu"
