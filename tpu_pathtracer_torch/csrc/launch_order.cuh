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
// The invariant every dependent kernel here keeps (nee.cu, camera.cu and
// the path step of fused_schedule.cu): before its wait it reads only what
// was written before the nearest launch made without the attribute began,
// and it stores nothing before its wait.
//
// Why that is enough, also for a chain of dependents.  A launch made
// without the attribute begins after everything before it on the stream
// is done and visible.  A dependent's blocks start only once the launch
// before it has started, so every link of a chain behind that ordinary
// launch starts after it began, and may run beside any earlier link:
// what it reads before its wait was written before the chain's head
// began, and no link writes before its own wait.  A link's wait returns
// once the launch before it is complete, which that launch is only after
// its own wait returned: after the wait every earlier link is done.  The
// chains on the main path, each link's early reads in brackets:
// * the any-hit traversal (ordinary: cluster_streamed.cuh, or brute.cu on
//   a scene without an accel) -> the NEE kernel (the record, the shadow
//   rays and radiance that the bounce
//   kernel wrote before the traversal, the lane state, the env tables) ->
//   under NEE the path step (the flag and a live lane's own state, which
//   the previous iteration's path step and camera kernel wrote before the
//   iteration's first launch, an ordinary one) -> on render_pixels_regen
//   the camera kernel (the camera's vectors and the seed counters, a
//   frame's set-up);
// * the bounce kernel (ordinary, bounce.cu) -> without NEE the path step
//   -> on render_pixels_regen the camera kernel;
// * kernel 7 (ordinary, fused_schedule.cu) -> the stream's camera kernel.
// So the heads stay ordinary launches and, like every link that has a
// dependent, let it start at their entry.  The caller of a dependent
// launch vouches for the launch before it: the wrappers pass `dependent`
// only where the integrator's order makes that launch the link before
// (ops/bounce.py: next_event, ops/camera.py: camera_paths,
// ops/fused_schedule.py: path_step), and refuse an input that a copy or
// fill just before the launch would make.

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
