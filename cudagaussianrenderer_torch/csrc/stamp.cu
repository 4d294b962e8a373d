// The frame's device stamps (telemetry.py): one thread writes the card's
// nanosecond clock (%globaltimer) into column `column` of row *row of a
// [rows, columns] int64 ring.  render_frame_tensors stamps the boundaries
// of its stages; a CUDA graph captures those launches, so a replay writes
// the stamps with no host call, into the row that the frame's inputs name
// (Renderer copies it to the device with the camera, as a float).  A stamp
// waits for the work before it on its stream and for nothing else, so the
// difference of two stamps is the device time of the stream's work
// between them.
#include "common.cuh"

namespace {

__global__ void frame_stamp_kernel(long long* ring, const float* row, int rows, int columns,
                                   int column) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const int r = static_cast<int>(*row);
  if (r >= 0 && r < rows) ring[static_cast<long long>(r) * columns + column] = now;
}

}  // namespace

GSR_EXPORT int gsr_frame_stamp(void* ring, const void* row, int rows, int columns, int column,
                               void* stream) {
  if (rows < 1 || column < 0 || column >= columns) return static_cast<int>(cudaErrorInvalidValue);
  frame_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<const float*>(row), rows, columns, column);
  return static_cast<int>(cudaGetLastError());
}
