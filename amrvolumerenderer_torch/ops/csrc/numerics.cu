// numerics.fma on the card: float32 a * b + c rounded once, elementwise with
// broadcasting.
//
// Replaces no TPU kernel.  XLA contracts a * b + c into one fused
// multiply-add wherever the product has a single use in a fusion, so every
// FMA site of the port's PyTorch code (the plain versions, and the eager
// ray set-up and ordered fold of the differentiable path, which run on the
// main path) must round once, as __fmaf_rn does.  In PyTorch alone that
// takes a float64 sum and a test for the float32 midpoints where its cast
// would round twice (ops/numerics.py::fma_reference, the plain version,
// which the CPU runs).  This kernel is one pass.
//
// What bounds it: bytes (the float32 operands read once, the output written
// once).  What the design does about it, with the walk planned on the host
// (ops/numerics.py::_fma_plan, once for each shape, stride and alignment):
//   * a thread writes a run of kRun consecutive outputs with one 16-byte
//     store, and issues every load of the run before its first FMA;
//   * each operand is read over a run as one 16-byte load where it is
//     contiguous and aligned there (VECTOR), as one load where its stride is
//     0 there (CONSTANT), or as a load an output (GENERAL);
//   * where an operand repeats along the outermost dimension (the ray
//     set-up's directions over the bricks), a thread walks a chunk of that
//     dimension's rows and keeps what repeats in registers;
//   * a run's multi-index is divided out once (each output's only where an
//     operand is GENERAL or the run is a row's scalar tail), by the host's
//     fast divisors: a multiply-high, an add and a shift, as PyTorch's
//     IntDivider; 32-bit offsets below 2^31, 64-bit ones and plain division
//     above;
//   * templates on each operand being a pointer or a number, and on the
//     one-dimensional (flat) walk, leave no per-element select.
// The build passes -fmad=false; __fmaf_rn is the one rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 4;   // outputs a thread writes: one 16-byte store
constexpr int kDims = 8;  // dimensions a walk may keep
// how an operand is read over a run (ops/numerics.py's modes)
constexpr int kGeneral = 0, kVector = 1, kConstant = 2;
// the plan's int64 words: ndim, loop, chunk, wide; per operand its mode and
// loop stride; sizes, magics, shifts; each operand's strides
constexpr int kWords = 4 + 6 + 3 * kDims + 3 * kDims;

template <typename Index>
struct Operand {
  const float* p;  // null: ``value`` everywhere
  float value;
  int mode;
  Index loop_stride;    // along the looped rows
  Index stride[kDims];  // over the walk's dimensions
};

template <typename Index>
struct Walk {
  Index size[kDims];  // row-major; ``inner`` = their product
  uint32_t magic[kDims], shift[kDims];
  Index inner, loop, chunk;
  int ndim;
  bool per_element;  // an operand is GENERAL: each output's offsets
};

// n / size[d]: the host's divisor in 32 bits (n < 2^31), a division in 64
__device__ __forceinline__ uint32_t quotient(const Walk<uint32_t>& w, int d, uint32_t n) {
  return (__umulhi(n, w.magic[d]) + n) >> w.shift[d];
}
__device__ __forceinline__ uint64_t quotient(const Walk<uint64_t>& w, int d, uint64_t n) {
  return n / w.size[d];
}

// Each pointer operand's element offset of walk element ``e``.
template <typename Index, bool kA, bool kB, bool kC, bool kFlat>
__device__ __forceinline__ void offsets(const Walk<Index>& w, const Operand<Index>& a,
                                        const Operand<Index>& b, const Operand<Index>& c,
                                        Index e, Index& oa, Index& ob, Index& oc) {
  oa = ob = oc = 0;
  if (!kFlat) {
#pragma unroll
    for (int d = kDims - 1; d > 0; --d) {
      if (d < w.ndim) {
        const Index q = quotient(w, d, e);
        const Index k = e - q * w.size[d];
        if (kA) oa += k * a.stride[d];
        if (kB) ob += k * b.stride[d];
        if (kC) oc += k * c.stride[d];
        e = q;
      }
    }
  }
  if (kA) oa += e * a.stride[0];
  if (kB) ob += e * b.stride[0];
  if (kC) oc += e * c.stride[0];
}

// One operand's values over a run, ``shift`` elements along the rows.
template <bool kPtr, typename Index>
__device__ __forceinline__ void load_run(const Operand<Index>& x, const Index (&o)[kRun],
                                         Index shift, bool full, float (&v)[kRun]) {
  if (!kPtr) {
#pragma unroll
    for (int j = 0; j < kRun; ++j) v[j] = x.value;
    return;
  }
  const float* p = x.p + shift;
  if (x.mode == kConstant) {
    const float s = __ldg(p + o[0]);
#pragma unroll
    for (int j = 0; j < kRun; ++j) v[j] = s;
  } else if (x.mode == kVector && full) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p + o[0]));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < kRun; ++j) v[j] = __ldg(p + o[j]);
  }
}

// A thread a run of the row space (grid x) in a chunk of rows (grid y).
template <typename Index, bool kA, bool kB, bool kC, bool kFlat>
__global__ void __launch_bounds__(kThreads)
    fma_kernel(Operand<Index> a, Operand<Index> b, Operand<Index> c, Walk<Index> w,
               float* __restrict__ out) {
  const Index i0 = (static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x) * kRun;
  if (i0 >= w.inner) return;
  const Index left = w.inner - i0;
  const bool full = left >= kRun;  // else the row's scalar tail
  Index oa[kRun], ob[kRun], oc[kRun];
  offsets<Index, kA, kB, kC, kFlat>(w, a, b, c, i0, oa[0], ob[0], oc[0]);
#pragma unroll
  for (int j = 1; j < kRun; ++j) {
    if (w.per_element || !full) {
      offsets<Index, kA, kB, kC, kFlat>(w, a, b, c, j < left ? i0 + j : i0, oa[j], ob[j],
                                        oc[j]);
    } else {
      oa[j] = oa[0];
      ob[j] = ob[0];
      oc[j] = oc[0];
    }
  }
  const Index first = static_cast<Index>(blockIdx.y) * w.chunk;
  const Index last = first + w.chunk < w.loop ? first + w.chunk : w.loop;
  // what repeats along the rows is read once
  const bool a_once = a.loop_stride == 0, b_once = b.loop_stride == 0,
             c_once = c.loop_stride == 0;
  float x[kRun], y[kRun], z[kRun];
  if (a_once) load_run<kA>(a, oa, Index{0}, full, x);
  if (b_once) load_run<kB>(b, ob, Index{0}, full, y);
  if (c_once) load_run<kC>(c, oc, Index{0}, full, z);
  for (Index l = first; l < last; ++l) {
    if (!a_once) load_run<kA>(a, oa, l * a.loop_stride, full, x);
    if (!b_once) load_run<kB>(b, ob, l * b.loop_stride, full, y);
    if (!c_once) load_run<kC>(c, oc, l * c.loop_stride, full, z);
    float r[kRun];
#pragma unroll
    for (int j = 0; j < kRun; ++j) r[j] = __fmaf_rn(x[j], y[j], z[j]);
    float* o = out + l * w.inner + i0;
    if (full) {
      *reinterpret_cast<float4*>(o) = make_float4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kRun; ++j)
        if (j < left) o[j] = r[j];
    }
  }
}

template <typename Index, bool kA, bool kB, bool kC>
cudaError_t run(const Operand<Index>& a, const Operand<Index>& b, const Operand<Index>& c,
                const Walk<Index>& w, dim3 grid, cudaStream_t s, float* out) {
  if (w.ndim == 1)
    fma_kernel<Index, kA, kB, kC, true><<<grid, kThreads, 0, s>>>(a, b, c, w, out);
  else
    fma_kernel<Index, kA, kB, kC, false><<<grid, kThreads, 0, s>>>(a, b, c, w, out);
  return cudaGetLastError();
}

template <typename Index>
Operand<Index> operand(const void* p, float value, const int64_t* plan, int k) {
  Operand<Index> o;
  o.p = static_cast<const float*>(p);
  o.value = value;
  o.mode = static_cast<int>(plan[4 + k]);
  o.loop_stride = p != nullptr ? static_cast<Index>(plan[7 + k]) : Index{0};
  for (int d = 0; d < kDims; ++d)
    o.stride[d] = p != nullptr ? static_cast<Index>(plan[10 + (3 + k) * kDims + d]) : Index{0};
  return o;
}

template <typename Index>
int launch(const void* a, const void* b, const void* c, float* out, float a_value,
           float b_value, float c_value, const int64_t* plan, cudaStream_t s) {
  Walk<Index> w;
  w.ndim = static_cast<int>(plan[0]);
  w.loop = static_cast<Index>(plan[1]);
  w.chunk = static_cast<Index>(plan[2]);
  w.inner = 1;
  for (int d = 0; d < kDims; ++d) {
    w.size[d] = d < w.ndim ? static_cast<Index>(plan[10 + d]) : Index{1};
    w.magic[d] = static_cast<uint32_t>(plan[10 + kDims + d]);
    w.shift[d] = static_cast<uint32_t>(plan[10 + 2 * kDims + d]);
    w.inner *= w.size[d];
  }
  const Operand<Index> oa = operand<Index>(a, a_value, plan, 0);
  const Operand<Index> ob = operand<Index>(b, b_value, plan, 1);
  const Operand<Index> oc = operand<Index>(c, c_value, plan, 2);
  w.per_element = (a != nullptr && oa.mode == kGeneral) ||
                  (b != nullptr && ob.mode == kGeneral) ||
                  (c != nullptr && oc.mode == kGeneral);
  const uint64_t runs = (static_cast<uint64_t>(w.inner) + kRun - 1) / kRun;
  const uint64_t blocks = (runs + kThreads - 1) / kThreads;
  const uint64_t rows = (static_cast<uint64_t>(w.loop) + w.chunk - 1) / w.chunk;
  if (blocks > 0x7fffffffu || rows > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(rows));
  switch ((a != nullptr ? 4 : 0) | (b != nullptr ? 2 : 0) | (c != nullptr ? 1 : 0)) {
    case 0: return static_cast<int>(run<Index, false, false, false>(oa, ob, oc, w, grid, s, out));
    case 1: return static_cast<int>(run<Index, false, false, true>(oa, ob, oc, w, grid, s, out));
    case 2: return static_cast<int>(run<Index, false, true, false>(oa, ob, oc, w, grid, s, out));
    case 3: return static_cast<int>(run<Index, false, true, true>(oa, ob, oc, w, grid, s, out));
    case 4: return static_cast<int>(run<Index, true, false, false>(oa, ob, oc, w, grid, s, out));
    case 5: return static_cast<int>(run<Index, true, false, true>(oa, ob, oc, w, grid, s, out));
    case 6: return static_cast<int>(run<Index, true, true, false>(oa, ob, oc, w, grid, s, out));
    default: return static_cast<int>(run<Index, true, true, true>(oa, ob, oc, w, grid, s, out));
  }
}

}  // namespace

// out = a * b + c rounded once over the walk ``plan`` (kWords int64 words,
// ops/numerics.py::_fma_array); each operand a pointer, or null and its
// number.  ``out`` is contiguous and 16-byte aligned.
extern "C" int avr_fma_launch(const void* a, const void* b, const void* c, void* out,
                              float a_value, float b_value, float c_value, const void* plan,
                              void* stream) {
  const int64_t* p = static_cast<const int64_t*>(plan);
  if (p[0] < 1 || p[0] > kDims || p[1] < 1 || p[2] < 1 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static_assert(kWords == 58, "ops/numerics.py::_fma_array writes 58 words");
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (p[3] != 0)
    return launch<uint64_t>(a, b, c, o, a_value, b_value, c_value, p, s);
  return launch<uint32_t>(a, b, c, o, a_value, b_value, c_value, p, s);
}
