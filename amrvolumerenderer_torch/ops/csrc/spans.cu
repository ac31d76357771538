// Stage marks: empty kernels that carry a span's stage and end in their
// names, for utils/timers.py's stage spans.
//
// Replaces no TPU kernel.  A CUDA graph replay runs no host code, so a
// host span (torch.profiler.record_function) around a captured stage leaves
// nothing in a trace of the replay, and a CUDA event recorded in a graph
// shows nowhere in the profiler's device timeline.  Every kernel of a replay
// does show there, by name, on the same clock as the stage's own kernels.
// So a span launches avr_span_mark<stage, 0> on the stream where it opens
// and avr_span_mark<stage, 1> where it closes; a reader of the trace
// (utils/timers.py::parse_mark) assigns what runs between the two to the
// stage.
//
// What bounds it: launch latency alone (one block of one thread, no memory
// touched).

#include <cuda_runtime.h>

constexpr int kStages = 8;  // utils/timers.py::SPANS has at most this many

template <int Stage, int End>
__global__ void avr_span_mark() {}

namespace {

template <int Stage>
cudaError_t launch(int stage, int end, cudaStream_t stream) {
  if (stage != Stage) {
    if constexpr (Stage + 1 < kStages) return launch<Stage + 1>(stage, end, stream);
    return cudaErrorInvalidValue;
  }
  if (end)
    avr_span_mark<Stage, 1><<<1, 1, 0, stream>>>();
  else
    avr_span_mark<Stage, 0><<<1, 1, 0, stream>>>();
  return cudaGetLastError();
}

template <int Stage>
cudaError_t load() {
  // under lazy module loading a kernel loads at its first launch, which
  // may fall inside a stream capture; asking for its attributes loads it now
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, avr_span_mark<Stage, 0>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, avr_span_mark<Stage, 1>);
  if (err != cudaSuccess) return err;
  if constexpr (Stage + 1 < kStages) return load<Stage + 1>();
  return cudaSuccess;
}

}  // namespace

// Launch stage ``stage``'s opening (end 0) or closing (end 1) mark on
// ``stream``; stage ``-1`` launches nothing and loads every mark.
extern "C" int avr_span_mark_launch(int stage, int end, void* stream) {
  if (stage == -1) return static_cast<int>(load<0>());
  if (stage < 0 || stage >= kStages || (end != 0 && end != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<0>(stage, end, static_cast<cudaStream_t>(stream)));
}
