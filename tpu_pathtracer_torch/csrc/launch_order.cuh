// Programmatic dependent launch on Hopper: a kernel launched as a
// programmatic dependent of the launch before it on its stream may start
// while that launch still runs, and waits in griddepcontrol.wait only
// where it reads what that launch writes.
//
// The launch before lets its dependent start with
// griddepcontrol.launch_dependents; its dependent's blocks are scheduled
// once every block of it has issued that or exited.  A stream capture
// records the pair as a programmatic edge of the graph, so a replay
// overlaps them as an eager stream does.
//
// The invariant every dependent kernel here keeps (nee.cu, camera.cu):
// before its wait it reads only what was written two or more launches
// back, and only while the launch just before it was made without the
// attribute (that launch then began after everything before it was done
// and visible); it stores nothing before its wait.  So the launches just
// before the dependents (the any-hit traversal, cluster_streamed.cuh;
// kernel 7 and the path step, fused_schedule.cu) stay ordinary launches
// and only let their dependents start early.  The caller of a dependent
// launch vouches for the launch before it: the wrappers pass `dependent`
// only where the integrator's order makes that launch the traversal or a
// schedule step (ops/bounce.py: next_event, ops/camera.py: camera_paths).

#pragma once

#include <utility>

#include <cuda_runtime.h>

namespace launch_order {

// At the entry of a kernel that a dependent follows: lets the dependent's
// blocks be scheduled once every block of this launch has started.  A
// no-op where no dependent follows.
__device__ __forceinline__ void let_dependents_start() { asm volatile("griddepcontrol.launch_dependents;"); }

// In a dependent kernel: waits until the launch before it has completed
// and its writes are visible.  A no-op in a launch made without the
// attribute.  The memory clobber keeps every load the source puts before
// it issued before it, and every load after it after it.
__device__ __forceinline__ void wait_for_launch_before() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

// kernel<<<blocks, threads, 0, stream>>>(args...), as a programmatic
// dependent of the launch before it on `stream` where `dependent`.
// Returns the launch's error.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int blocks, int threads, cudaStream_t stream, bool dependent,
                   Args&&... args) {
  cudaLaunchAttribute attribute = {};
  attribute.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attribute.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  config.attrs = &attribute;
  config.numAttrs = dependent ? 1 : 0;
  return cudaLaunchKernelEx(&config, kernel, std::forward<Args>(args)...);
}

}  // namespace launch_order
