// An empty kernel: the device time of a launch that does nothing, the
// practical floor under every short decode kernel (the card's counterpart of
// the TPU grid-overhead probe tools/probe_grid.py). It ports no TPU kernel;
// chip_smoke.py and tools/torch_kernel_times.py time it beside the kernels.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
