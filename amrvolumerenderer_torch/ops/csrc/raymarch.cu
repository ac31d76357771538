// The raymarch oracle's bucket march on Hopper.
//
// Replaces amrvolumerenderer_tpu/ops/raymarch.py:78, render_bucket_impl: an
// XLA program (jax.lax.fori_loop over a masked fixed-step body, vmapped over
// a bucket of same-shape bricks) that the JAX package jits as its forward
// step.  The port ran it as a Python loop of about 70 PyTorch launches a
// step; this kernel marches every (brick, pixel) pair of the bucket in one
// launch.  ops/raymarch.py keeps the ray set-up (directions, per-brick
// constants) in PyTorch and classifies every cell once
// (ops/raymarch.py::classify_cells: raw value -> LUT entry, elementwise),
// so a sample here is a cell read, a LUT read and the fold.
//
// One thread owns one (brick, pixel) pair: the slab test of the brick's box,
// the fixed-step march in registers, the [0, 1] clamp and the box-entry
// depth; it writes the pair's five floats (r, g, b, a, depth) into row
// layer_ids[b] of the [L, P, 5] stack, background (colour 0, depth +inf)
// where its ray misses the box or accumulates nothing.  So every row of the
// bucket is written whole and the caller needs no clear.  A block is 256
// consecutive pixels; it loops over a share of the bucket's bricks (grid y),
// so a block's rays read each brick's cells and LUT through L1.
//
// What bounds it on this card: bytes.  Every (brick, pixel) pair writes 20
// B, hit or not (10.7 GB for 512 bricks at 1024^2: 3.2 ms at 3.35 TB/s),
// while the samples are a few hundred million cell and LUT reads that hit
// L1/L2 (the bucket's cells are read from device memory about once) and
// about 48 float32 operations each.  What the design does about it: a
// block's 256 x 5 floats are staged in shared memory and stored as 16-byte
// vectors of one contiguous run (a thread's own five floats are 20 B apart;
// rows that are not 16-byte aligned store a float at a time), a ray stops
// at the first step that cannot be active again, and no pair list, batch or
// host synchronisation remains.  Registers: each IEEE division has a slow
// path that is a subroutine call, and values live across it beyond what the
// call preserves spill; so the forward vector is read after the march and
// cell offsets within a brick are 32-bit (chip_smoke.py fails on a spill).
//
// Numerics: the plain version (ops/raymarch.py::render_bucket_into_reference)
// rounds as jitted JAX does on the CPU, and so does this kernel, op for op.
// Each FMA site of the plain version is a __fmaf_rn here; the build passes
// -fmad=false, so nothing else contracts.  The tested distance is
// d0 + step * k, rounded twice, and the sampled cell's distance
// fma(step, k, d0); cell indices are IEEE floor((pos - lo) / size), clamped
// in float.  A thread stops only on what cannot come back: a tested distance
// at or past tmax (distances do not decrease for a step >= 0) or an opacity
// at or above 1; a step outside the box may be followed by one inside.  A
// step that is not active adds alpha 0, which leaves the accumulation as it
// is for the finite LUT entries the renderer builds.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;  // pixels per block
constexpr int kTargetBlocks = 16384;  // grid y: enough blocks to fill the card
constexpr float kParallel = 0x1.5798eep-27f;  // float32(1e-8), the slab guard

// torch.clamp(x, 0, 1): NaN stays NaN
__device__ __forceinline__ float clamp01(float x) {
  return x != x ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}

// One axis of the slab test with the reference's parallel-ray guard
// (VolumePainter.cpp:775-809; ops/raymarch.py::_slab_intersect).
__device__ __forceinline__ void slab(float o, float d, float mn, float mx,
                                     float& lo, float& hi) {
  const bool parallel = fabsf(d) < kParallel;
  const float inv = 1.0f / (parallel ? 1.0f : d);
  const float t1 = (mn - o) * inv;
  const float t2 = (mx - o) * inv;
  const bool inside = o >= mn && o <= mx;
  lo = parallel ? (inside ? -INFINITY : INFINITY) : fminf(t1, t2);
  hi = parallel ? (inside ? INFINITY : -INFINITY) : fmaxf(t1, t2);
}

// The nearest cell of one axis: floor((p - lo) / size), clamped in float.
__device__ __forceinline__ int cell_of(float p, float lo, float size, int top) {
  return static_cast<int>(
      fminf(fmaxf(floorf((p - lo) / size), 0.0f), static_cast<float>(top)));
}

__global__ void __launch_bounds__(kThreads) raymarch_kernel(
    const float* __restrict__ dirs, const float* __restrict__ eye,
    const float* __restrict__ forward, const float* __restrict__ bmin,
    const float* __restrict__ bmax, const float* __restrict__ cell,
    const int* __restrict__ top, const float* __restrict__ steps,
    const float* __restrict__ mesh_eps, const int* __restrict__ lut_index,
    const float4* __restrict__ luts, const long long* __restrict__ layer_ids,
    float* __restrict__ out, int num_bricks, int num_pixels, int pad_x,
    int pad_y, int pad_z, int lut_entries, int num_steps) {
  __shared__ __align__(16) float stage[kThreads * 5];
  const int n0 = blockIdx.x * kThreads;
  const int n = n0 + threadIdx.x;
  const bool pixel = n < num_pixels;
  const float ex = eye[0], ey = eye[1], ez = eye[2];
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (pixel) {
    dx = dirs[3 * static_cast<int64_t>(n)];
    dy = dirs[3 * static_cast<int64_t>(n) + 1];
    dz = dirs[3 * static_cast<int64_t>(n) + 2];
  }
  const int64_t cells = static_cast<int64_t>(pad_x) * pad_y * pad_z;
  const int count = min(kThreads, num_pixels - n0) * 5;

  for (int b = blockIdx.y; b < num_bricks; b += gridDim.y) {
    float r = 0.0f, g = 0.0f, bl = 0.0f, a = 0.0f, depth = INFINITY;
    if (pixel) {
      const float lx = bmin[3 * b], ly = bmin[3 * b + 1], lz = bmin[3 * b + 2];
      const float hx = bmax[3 * b], hy = bmax[3 * b + 1], hz = bmax[3 * b + 2];
      float lo0, hi0, lo1, hi1, lo2, hi2;
      slab(ex, dx, lx, hx, lo0, hi0);
      slab(ey, dy, ly, hy, lo1, hi1);
      slab(ez, dz, lz, hz, lo2, hi2);
      const float tmin = fmaxf(fmaxf(lo0, lo1), lo2);
      const float tmax = fminf(fminf(hi0, hi1), hi2);
      if (tmax >= tmin) {
        const float eps = mesh_eps[b];
        const float step = steps[b];
        float d0 = tmin + eps;
        if (d0 < 0.0f) d0 = eps;
        const float sx = cell[3 * b], sy = cell[3 * b + 1], sz = cell[3 * b + 2];
        const int tx = top[3 * b], ty = top[3 * b + 1], tz = top[3 * b + 2];
        const int* vol = lut_index + b * cells;
        const float4* lut = luts + static_cast<int64_t>(b) * lut_entries;
        const bool rising = !(step < 0.0f);  // distances never decrease
        float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_a = 0.0f;
        for (int k = 0; k < num_steps; ++k) {
          const float kf = static_cast<float>(k);
          const float dist = d0 + step * kf;  // tested: rounded twice
          if (!(dist < tmax)) {
            if (rising) break;
            continue;
          }
          const float px = __fmaf_rn(dx, dist, ex);  // FMA: position tested
          const float py = __fmaf_rn(dy, dist, ey);
          const float pz = __fmaf_rn(dz, dist, ez);
          if (!(px >= lx && px <= hx && py >= ly && py <= hy && pz >= lz &&
                pz <= hz))
            continue;
          const float dc = __fmaf_rn(step, kf, d0);  // FMA: the cell's distance
          const int ix = cell_of(__fmaf_rn(dx, dc, ex), lx, sx, tx);
          const int iy = cell_of(__fmaf_rn(dy, dc, ey), ly, sy, ty);
          const int iz = cell_of(__fmaf_rn(dz, dc, ez), lz, sz, tz);
          const float4 s =
              lut[vol[(ix * pad_y + iy) * pad_z + iz]];
          const float alpha = s.w * (1.0f - acc_a);
          acc_r = __fmaf_rn(s.x, alpha, acc_r);  // FMA: colour accumulation
          acc_g = __fmaf_rn(s.y, alpha, acc_g);
          acc_b = __fmaf_rn(s.z, alpha, acc_b);
          acc_a = acc_a + alpha;
          if (!(acc_a < 1.0f)) break;  // never active again
        }
        r = clamp01(acc_r);
        g = clamp01(acc_g);
        bl = clamp01(acc_b);
        a = clamp01(acc_a);
        // FMA: the box entry point, then the depth dot product (forward is
        // read here: held across the march it spills a register)
        const float fx = forward[0], fy = forward[1], fz = forward[2];
        const float rx = __fmaf_rn(dx, tmin, ex) - ex;
        const float ry = __fmaf_rn(dy, tmin, ey) - ey;
        const float rz = __fmaf_rn(dz, tmin, ez) - ez;
        const float dep = __fmaf_rn(rz, fz, __fmaf_rn(ry, fy, rx * fx));
        if (a > 0.0f && isfinite(dep)) depth = dep;
      }
    }
    __syncthreads();  // the previous brick's row has left the stage
    float* s = stage + threadIdx.x * 5;
    s[0] = r;
    s[1] = g;
    s[2] = bl;
    s[3] = a;
    s[4] = depth;
    __syncthreads();
    float* row = out + (layer_ids[b] * num_pixels + n0) * 5;
    if (count == kThreads * 5 && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
      float4* row4 = reinterpret_cast<float4*>(row);
      const float4* stage4 = reinterpret_cast<const float4*>(stage);
      for (int i = threadIdx.x; i < kThreads * 5 / 4; i += kThreads)
        row4[i] = stage4[i];
    } else {
      for (int i = threadIdx.x; i < count; i += kThreads) row[i] = stage[i];
    }
  }
}

}  // namespace

extern "C" int avr_raymarch_launch(
    const void* dirs, const void* eye, const void* forward, const void* bmin,
    const void* bmax, const void* cell, const void* top, const void* steps,
    const void* mesh_eps, const void* lut_index, const void* luts,
    const void* layer_ids, void* out, int num_bricks, int num_pixels,
    int pad_x, int pad_y, int pad_z, int lut_entries, int num_steps,
    void* stream) {
  if (num_bricks <= 0 || num_pixels <= 0) return 0;
  const int blocks_x = (num_pixels + kThreads - 1) / kThreads;
  const int blocks_y =
      std::min(num_bricks, std::min(65535, std::max(1, kTargetBlocks / blocks_x)));
  raymarch_kernel<<<dim3(blocks_x, blocks_y), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dirs), static_cast<const float*>(eye),
      static_cast<const float*>(forward), static_cast<const float*>(bmin),
      static_cast<const float*>(bmax), static_cast<const float*>(cell),
      static_cast<const int*>(top), static_cast<const float*>(steps),
      static_cast<const float*>(mesh_eps), static_cast<const int*>(lut_index),
      static_cast<const float4*>(luts),
      static_cast<const long long*>(layer_ids), static_cast<float*>(out),
      num_bricks, num_pixels, pad_x, pad_y, pad_z, lut_entries, num_steps);
  return static_cast<int>(cudaGetLastError());
}
