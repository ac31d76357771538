// numerics.fma on the card: float32 a * b + c rounded once, elementwise with
// broadcasting.
//
// Replaces no TPU kernel.  XLA contracts a * b + c into one fused
// multiply-add wherever the product has a single use in a fusion, so every
// FMA site of the port's PyTorch code (the plain versions, and the eager
// ray set-up and ordered fold of the differentiable path, which run on the
// main path) must round once, as __fmaf_rn does.  In PyTorch alone that
// takes a float64 sum rounded to odd before the cast: about twenty
// elementwise passes over float64 temporaries
// (ops/numerics.py::fma_reference, the plain version, which the CPU runs).
// This kernel is one pass.
//
// What bounds it: bytes (the float32 operands read once, the output written
// once; a broadcast operand is read again through L1 and L2).  Each operand
// is a pointer with a stride a dimension (0 on a broadcast one) or, where
// the pointer is null, a number; ops/numerics.py merges the dimensions it
// can, so the index arithmetic is short; a thread an element,
// grid-striding, with 32-bit indices below 2^31 elements.  The build passes
// -fmad=false; __fmaf_rn is the one rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // a few waves of the H100's 132 SMs
constexpr int kDims = 8;              // dimensions an operand may have

struct Operand {
  const float* p;  // null: ``value`` everywhere
  float value;
  int64_t stride[kDims];
};

struct Shape {
  int64_t size[kDims];  // the output's, row-major
  int64_t numel;
  int ndim;
  bool flat;  // every pointer operand contiguous in the output's shape
};

template <typename Index>
__global__ void __launch_bounds__(kThreads)
    fma_kernel(Operand a, Operand b, Operand c, Shape shape, float* out) {
  const Index n = static_cast<Index>(shape.numel);
  for (Index i = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += static_cast<Index>(gridDim.x) * kThreads) {
    int64_t at_a = i, at_b = i, at_c = i;
    if (!shape.flat) {
      at_a = at_b = at_c = 0;
      Index r = i;
      for (int d = shape.ndim - 1; d >= 0; --d) {
        const Index size = static_cast<Index>(shape.size[d]);
        const Index k = r % size;
        r /= size;
        at_a += k * a.stride[d];
        at_b += k * b.stride[d];
        at_c += k * c.stride[d];
      }
    }
    const float x = a.p ? a.p[at_a] : a.value;
    const float y = b.p ? b.p[at_b] : b.value;
    const float z = c.p ? c.p[at_c] : c.value;
    out[i] = __fmaf_rn(x, y, z);
  }
}

Operand operand(const void* p, float value, const void* strides, int ndim) {
  Operand o;
  o.p = static_cast<const float*>(p);
  o.value = value;
  for (int d = 0; d < kDims; ++d)
    o.stride[d] = d < ndim && p != nullptr ? static_cast<const int64_t*>(strides)[d] : 0;
  return o;
}

}  // namespace

// out[i] = a[i] * b[i] + c[i] rounded once over the output's shape
// ``sizes`` (``ndim`` <= kDims int64 sizes, row-major); each operand a
// pointer with ``ndim`` int64 element strides, or null and its number.  ``flat``: every
// pointer operand is contiguous in the output's shape.
extern "C" int avr_fma_launch(const void* a, const void* b, const void* c, void* out,
                              float a_value, float b_value, float c_value, int ndim,
                              const void* sizes, const void* a_strides,
                              const void* b_strides, const void* c_strides, int flat,
                              void* stream) {
  if (ndim < 1 || ndim > kDims) return static_cast<int>(cudaErrorInvalidValue);
  Shape shape;
  shape.numel = 1;
  for (int d = 0; d < kDims; ++d) {
    shape.size[d] = d < ndim ? static_cast<const int64_t*>(sizes)[d] : 1;
    shape.numel *= shape.size[d];
  }
  shape.ndim = ndim;
  shape.flat = flat != 0;
  if (shape.numel <= 0) return 0;
  const int64_t blocks = (shape.numel + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks));
  const Operand oa = operand(a, a_value, a_strides, ndim);
  const Operand ob = operand(b, b_value, b_strides, ndim);
  const Operand oc = operand(c, c_value, c_strides, ndim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shape.numel < (int64_t{1} << 31))
    fma_kernel<uint32_t><<<grid, kThreads, 0, s>>>(oa, ob, oc, shape,
                                                   static_cast<float*>(out));
  else
    fma_kernel<int64_t><<<grid, kThreads, 0, s>>>(oa, ob, oc, shape,
                                                  static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
