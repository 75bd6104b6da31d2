// Copy probes for Hopper (sm_90a): what streaming rate and what launch cost
// the card gives a kernel of this package.  Plain C interface, loaded with
// ctypes by waterlily_tpu_torch/ops/_build.py; each entry launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().
//
// Replaces the probe kernels of the TPU benchmarks, all out = a * 1.0000001
// on float32 fields: the windowed copy (benchmarks/leanprobe.py:99,
// benchmarks/bwprobe.py:115), the BlockSpec copy at two block sizes
// (leanprobe.py:117), the copy of eight concatenated fields (leanprobe.py:149,
// a working set beyond the fast memory: there VMEM, here the 50 MB L2), the
// six-field copy (bwprobe.py:128) and the tiny kernel launched back to back
// (bwprobe.py:157).  The TPU variants differ in how a window reaches VMEM;
// this card has no such machinery to compare, so they are one kernel,
// copy_scale_kernel<NF>, launched with two block sizes.
//
// Bound: memory traffic, 8 B per element and field (one read, one write);
// one multiply per element.  Each thread moves one float4 of every field
// (a warp reads 512 consecutive bytes per field), one block per `block`
// float4s, so a 258^3 field is ~16 waves of blocks and the last one is
// nearly full; a scalar tail covers n % 4.  What is left above the memory
// time at 258^3 (~4 us of ~48) is the start and the drain of each launch,
// so the kernel is launched with programmatic dependent launch
// (cudaLaunchAttributeProgrammaticStreamSerialization): its blocks are
// scheduled while the previous kernel on the stream drains, and each waits
// (griddepcontrol.wait, before any load or store) until that kernel has
// finished and its writes are visible.  This overlap helps back-to-back
// launches of this kernel only; the solver's kernels are launched plainly.
// Measured on an H100 against the same kernel launched plainly, in one
// process (tools/bandwidth_probe.py --against, PERF.md section 6): ~4 %
// faster on one 258^3 field, ~1 % on six fields and on 550 MB; streaming
// (evict-first) loads and stores added to it made those two 0.4-0.9 %
// slower than the plain launch.

// wlt_copy_scale_loop launches the one-field copy `count` times from a C
// loop: the host cost of a launch with no Python in it, the floor against
// which the wrappers' launch path is measured (tools/launch_cost.py).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr float SCALE = 1.0000001f;

template <int NF>
struct Fields {
  const float* in[NF];
  float* out[NF];
};

template <int NF>
__global__ void copy_scale_kernel(Fields<NF> f, int64_t n4, int64_t n) {
  // the previous kernel on the stream has finished and its writes are seen
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n4) {
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      float4 v = reinterpret_cast<const float4*>(f.in[k])[i];
      v.x *= SCALE;
      v.y *= SCALE;
      v.z *= SCALE;
      v.w *= SCALE;
      reinterpret_cast<float4*>(f.out[k])[i] = v;
    }
  }
  const int64_t t = 4 * n4 + i;
  if (t < n) {
#pragma unroll
    for (int k = 0; k < NF; ++k) f.out[k][t] = f.in[k][t] * SCALE;
  }
}

template <int NF>
cudaError_t launch_copy_scale(const float* const* in, float* const* out,
                              int64_t n, int block, cudaStream_t s) {
  if (block < 32 || block > 1024 || block % 32 != 0 || n < 1)
    return cudaErrorInvalidValue;
  Fields<NF> f;
  for (int k = 0; k < NF; ++k) {
    f.in[k] = in[k];
    f.out[k] = out[k];
  }
  const int64_t n4 = n / 4;
  const int64_t threads = n4 > n - 4 * n4 ? n4 : n - 4 * n4;
  const int64_t blocks = (threads + block - 1) / block;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(block);
  cfg.stream = s;
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &early;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, copy_scale_kernel<NF>, f, n4, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// in, out: n float32 elements each, 16-byte aligned; block: threads per
// block, a multiple of 32 up to 1024
int wlt_copy_scale(const float* in, float* out, int64_t n, int block,
                   void* stream) {
  return (int)launch_copy_scale<1>(&in, &out, n, block, (cudaStream_t)stream);
}

// in, out: six pointers each to n float32 elements, 16-byte aligned
int wlt_copy_scale6(const float* const* in, float* const* out, int64_t n,
                    int block, void* stream) {
  return (int)launch_copy_scale<6>(in, out, n, block, (cudaStream_t)stream);
}

// a -> b, b -> a, ... count launches of wlt_copy_scale back to back
int wlt_copy_scale_loop(float* a, float* b, int64_t n, int block, int count,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  for (int k = 0; k < count; ++k) {
    const float* in = k % 2 ? b : a;
    float* out = k % 2 ? a : b;
    cudaError_t err = launch_copy_scale<1>(&in, &out, n, block, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
