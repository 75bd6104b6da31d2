// Copy probes for Hopper (sm_90a): what streaming rate and what launch cost
// the card gives a kernel of this package.  Plain C interface, loaded with
// ctypes by waterlily_tpu_torch/ops/_build.py; the entry launches on the
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
// one multiply per element.  Each thread moves one float4 of every field, so
// a warp reads 512 consecutive bytes per field; a scalar tail covers n % 4.

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
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
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
  int64_t t = 4 * n4 + i;
  if (t < n) {
#pragma unroll
    for (int k = 0; k < NF; ++k) f.out[k][t] = f.in[k][t] * SCALE;
  }
}

template <int NF>
cudaError_t launch_copy_scale(const float* const* in, float* const* out,
                              int64_t n, int block, cudaStream_t s) {
  Fields<NF> f;
  for (int k = 0; k < NF; ++k) {
    f.in[k] = in[k];
    f.out[k] = out[k];
  }
  int64_t n4 = n / 4;
  int64_t threads = n4 > n - 4 * n4 ? n4 : n - 4 * n4;
  int64_t blocks = (threads + block - 1) / block;
  if (blocks < 1) blocks = 1;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  copy_scale_kernel<NF><<<(unsigned)blocks, block, 0, s>>>(f, n4, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// in, out: nf pointers each to n float32 elements, 16-byte aligned; nf is 1
// or 6; block: threads per block, a multiple of 32 up to 1024
int wlt_copy_scale(const float* const* in, float* const* out, int nf,
                   int64_t n, int block, void* stream) {
  if (block < 32 || block > 1024 || block % 32 != 0 || n < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (nf) {
    case 1: return (int)launch_copy_scale<1>(in, out, n, block, s);
    case 6: return (int)launch_copy_scale<6>(in, out, n, block, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
