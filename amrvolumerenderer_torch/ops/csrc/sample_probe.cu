// Not a renderer kernel: one valid sample of the march loop body
// (march.cuh::ray_step) per thread, and one step of the composite's fold,
// for counting the SASS instructions a valid sample or a fold step issues.
// chip_smoke.py compiles this file to a cubin, disassembles it with
// cuobjdump -sass and subtracts each probe_base_* kernel (the same kernel
// without the sample or step) from its probe_* twin.  The piece, view and
// ray terms are kernel parameters, so reading them costs no instruction
// that a march loop would not pay once per item.

#include "march.cuh"

using namespace avr;

#define AVR_PROBE(name, TRI, PRE, ROLLED, T)                                 \
  extern "C" __global__ void probe_##name(Item<T> it, View v, RayItem ri,     \
                                          const float* lut, float* out,       \
                                          int k, int entries, int max_slices, \
                                          int ghost, int stored) {            \
    float acc[4];                                                             \
    for (int i = 0; i < 4; ++i) acc[i] = out[4 * threadIdx.x + i];            \
    ray_step<TRI, PRE, ROLLED>(it, v, ri, false, k, lut, entries,            \
                               max_slices, ghost, stored, acc);               \
    for (int i = 0; i < 4; ++i) out[4 * threadIdx.x + i] = acc[i];            \
  }                                                                           \
  extern "C" __global__ void probe_base_##name(                               \
      Item<T> it, View v, RayItem ri, const float* lut, float* out, int k,    \
      int entries, int max_slices, int ghost, int stored) {                   \
    float acc[4];                                                             \
    for (int i = 0; i < 4; ++i) acc[i] = out[4 * threadIdx.x + i];            \
    for (int i = 0; i < 4; ++i) out[4 * threadIdx.x + i] = acc[i];            \
  }

// slice march (rolled fold), float32 volume
AVR_PROBE(slicemarch_nearest_post, false, false, true, float)
AVR_PROBE(slicemarch_trilinear_post, true, false, true, float)
AVR_PROBE(slicemarch_trilinear_pre, true, true, true, float)
// tile march (unrolled fold), float32 and bfloat16 volumes
AVR_PROBE(tilemarch_nearest_post, false, false, false, float)
AVR_PROBE(tilemarch_trilinear_post, true, false, false, float)
AVR_PROBE(tilemarch_trilinear_pre, true, true, false, float)
AVR_PROBE(tilemarch_bf16_nearest_post, false, false, false, __nv_bfloat16)

// One fold step of composite.cu per thread: the next layer's loads and its
// blend into the run.  The tile mode folds 4 pixels from five float4 loads
// (chip_smoke.py divides its count by 4), the pixel mode one pixel from
// five scalar loads.
__device__ __forceinline__ void load_run(const float* state, Layer* run, int n) {
  for (int j = 0; j < n; ++j)
    run[j] = Layer{state[j], state[n + j], state[2 * n + j], state[3 * n + j],
                   state[4 * n + j]};
}

__device__ __forceinline__ void store_run(float* state, const Layer* run, int n) {
  for (int j = 0; j < n; ++j) {
    state[j] = run[j].r;
    state[n + j] = run[j].g;
    state[2 * n + j] = run[j].b;
    state[3 * n + j] = run[j].a;
    state[4 * n + j] = run[j].d;
  }
}

extern "C" __global__ void probe_fold_tile(const float* src, float* state,
                                           int plane) {
  Layer run[4];
  load_run(state + 20 * threadIdx.x, run, 4);
  const float* c = src + 4 * threadIdx.x;
  const float4 r = *reinterpret_cast<const float4*>(c);
  const float4 g = *reinterpret_cast<const float4*>(c + plane);
  const float4 b = *reinterpret_cast<const float4*>(c + 2 * plane);
  const float4 a = *reinterpret_cast<const float4*>(c + 3 * plane);
  const float4 d = *reinterpret_cast<const float4*>(c + 4 * plane);
  run[0] = blend(run[0], Layer{r.x, g.x, b.x, a.x, d.x});
  run[1] = blend(run[1], Layer{r.y, g.y, b.y, a.y, d.y});
  run[2] = blend(run[2], Layer{r.z, g.z, b.z, a.z, d.z});
  run[3] = blend(run[3], Layer{r.w, g.w, b.w, a.w, d.w});
  store_run(state + 20 * threadIdx.x, run, 4);
}

extern "C" __global__ void probe_base_fold_tile(const float* src, float* state,
                                                int plane) {
  Layer run[4];
  load_run(state + 20 * threadIdx.x, run, 4);
  store_run(state + 20 * threadIdx.x, run, 4);
}

extern "C" __global__ void probe_fold_pixel(const float* src, float* state,
                                            int plane) {
  Layer run;
  load_run(state + 5 * threadIdx.x, &run, 1);
  const float* s = src + 5 * threadIdx.x;
  run = blend(run, Layer{s[0], s[1], s[2], s[3], s[4]});
  store_run(state + 5 * threadIdx.x, &run, 1);
}

extern "C" __global__ void probe_base_fold_pixel(const float* src, float* state,
                                                 int plane) {
  Layer run;
  load_run(state + 5 * threadIdx.x, &run, 1);
  store_run(state + 5 * threadIdx.x, &run, 1);
}
