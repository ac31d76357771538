// Not a renderer kernel: one valid sample of the march loop body
// (march.cuh::ray_step) per thread, for counting the SASS instructions
// a valid sample issues.  chip_smoke.py compiles this file to a cubin,
// disassembles it with cuobjdump -sass and subtracts each probe_base_*
// kernel (the same kernel without the sample) from its probe_* twin.  The piece, view and
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
