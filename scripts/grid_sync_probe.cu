// A probe of what one step of a cooperative chain costs on the card, for
// scripts/chain_timing.py: `steps` rounds of a grid-wide barrier alone
// (mode 0: cooperative groups' grid.sync(); mode 2: a barrier of one
// release atomic a block, where the last block to arrive moves a generation
// word on and the others spin on it with acquire loads), or of the ingest
// chain's step skeleton without its arithmetic (mode 1): each block stores
// one partial to slot j % 2 of a slab, grid sync, one warp reads every
// block's partial through L2 and sums it, block barrier. Not a kernel of the
// port: the port's chain is src/repro_torch/csrc/ingest_chain.cu.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC \
//        -o build/grid_sync_probe.so scripts/grid_sync_probe.cu
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// mode 2's barrier words: arrivals of the current round (0 between rounds), rounds passed
__device__ unsigned int probe_count;
__device__ unsigned int probe_gen;

__device__ __forceinline__ void generation_barrier() {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int gen, old;
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(gen) : "l"(&probe_gen) : "memory");
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;" : "=r"(old) : "l"(&probe_count) : "memory");
    if (old == gridDim.x - 1) {
      asm volatile("st.relaxed.gpu.global.u32 [%0], 0;" ::"l"(&probe_count) : "memory");
      asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(&probe_gen), "r"(gen + 1) : "memory");
    } else {
      unsigned int now = gen;
      while (now == gen) asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(now) : "l"(&probe_gen) : "memory");
    }
  }
  __syncthreads();
}

__global__ void grid_sync_probe_kernel(int64_t steps, int mode, float* slab, float* out) {
  __shared__ float total;
  cg::grid_group grid = cg::this_grid();
  float acc = 0.f;
  for (int64_t j = 0; j < steps; ++j) {
    float* slot = slab + (j & 1) * gridDim.x;
    if (mode == 1 && threadIdx.x == 0) slot[blockIdx.x] = acc + static_cast<float>(j);
    if (mode == 2)
      generation_barrier();
    else
      grid.sync();
    if (mode == 1) {
      if (threadIdx.x < 32) {
        float a = 0.f;
        for (unsigned b = threadIdx.x; b < gridDim.x; b += 32) a += __ldcg(slot + b);
        for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        if (threadIdx.x == 0) total = a;
      }
      __syncthreads();
      acc += total;
    }
  }
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

// slab: 2 * blocks floats, out: blocks floats
extern "C" __attribute__((visibility("default"))) int grid_sync_probe(int blocks, int64_t steps, int mode,
                                                                       float* slab, float* out, void* stream) {
  void* args[] = {&steps, &mode, &slab, &out};
  const cudaError_t rc = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(grid_sync_probe_kernel),
                                                     dim3(blocks), dim3(256), args, 0,
                                                     static_cast<cudaStream_t>(stream));
  return rc != cudaSuccess ? static_cast<int>(rc) : static_cast<int>(cudaGetLastError());
}
