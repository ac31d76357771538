// The differentiable path's march on Hopper: forward, tangent and backward.
//
// Replaces amrvolumerenderer_tpu/diff.py:113, render_layers_diff: an XLA
// program (jax.lax.scan over a jax.checkpoint'ed step, vmapped over the
// bricks) that the JAX package jits and differentiates with jax.grad and
// jax.jvp.  The port ran it as a Python loop of about 60 PyTorch launches a
// step over every (brick, pixel) pair.  ops/diffmarch.py keeps the ray
// set-up in PyTorch under autograd and calls these kernels from one
// torch.autograd.Function; their plain versions are march_forward_reference,
// march_tangent_reference and march_backward_reference beside it.
//
// Launch shape.  A first kernel (diffmarch_pairs_kernel, its own launch and
// counter) lists each brick's hit pairs: the pixels whose ray meets the
// brick, about 5% of the (brick, pixel) pairs at 1024^2 on bench.py's
// 3-level scene, each list block's hits in pixel order.  For the forward it
// also writes the zero row of every pair that misses.  The march kernels
// then give a row of blocks to each brick (grid y), about kGridBlocks in all,
// striding over the brick's list: no thread is spent on a miss, no block is
// launched empty, and a block's samples read one brick's cells and LUT
// through L1.  The list's count stays on the card, so the host reads nothing
// and a CUDA graph can capture every launch.
//
// A step: the distance d0 + step * k, the position fma(dir, dist, eye), the
// gate (dist < tmax, inside the box, opacity below 1), a trilinear sample
// with eight gathers, the scalar transform (XLA's float32 log,
// ops/numerics.py::_log, op for op), the soft tail, a lerped LUT lookup and
// the over step.  A thread stops only where no later step can be active: a
// distance at or past tmax (distances do not decrease for a step >= 0) or
// an opacity at or above 1.  A step outside the box does not stop it (d0 is
// nudged by mesh_eps, so a later step may be inside).
//
// The forward (kGroups 0; a thread a hit pair) writes the raw accumulator
// [B, P, 4] and, when reverse mode will follow, the opacity before steps 0,
// S, 2S, ... into checkpoints [C, B, P] (S = kSegment; a miss has none).  A
// tangent instantiation carries a tangent beside the accumulator: each
// active step's sample tangent from the same intermediates, then the dual
// over step.  It is instantiated for the groups of fields that carry a
// tangent (data, LUT, the ray and box geometry, the transform's scalars:
// kGroups), decided on the host as jax.jvp's symbolic zeros are, so that an
// absent group costs no load, no term and no register: the eye's forward
// mode carries the geometry alone (d0 and eye) in 128 registers, 16 warps an
// SM, where all four groups take 153 (12 warps, in blocks of 128).  A pair
// loads its geometry's tangents and the cell's reciprocal once.
//
// The backward is the exact reverse mode of the recurrence.  For an active
// step, alpha = s.a (1 - A.a), A'.rgb = fma(s.rgb, alpha, A.rgb) and A'.a =
// A.a + alpha; so lam.rgb stays the output cotangent, g_alpha = lam.rgb .
// s.rgb + lam.a, lam.a -= s.a g_alpha, g_s.rgb = lam.rgb alpha and g_s.a =
// g_alpha (1 - A.a).  It divides by no transmittance: each segment of S steps
// is replayed forward from its checkpoint, through the same sample() as the
// forward and in the same rounding, into shared memory (the opacity before
// each step), then walked backwards.  So every gate decision is the
// forward's own.  A warp's 32 hit pairs walk their segments and steps in
// step, so that each step's gradients are added a warp at a time:
//   * the LUT rows: the lanes with one LUT row are gathered by the first of
//     them (__match_any_sync and shuffles), which adds the float32 sum of at
//     most 32 terms into the warp's own float64 copy of the brick's LUT
//     gradient in shared memory with plain adds; at the block's end the
//     copies are summed in a fixed order and flushed with one float64
//     atomicAdd an entry (a LUT entry takes millions of terms at full size,
//     beyond what a float32 sum holds to 1e-4);
//   * the data: the runs of neighbouring lanes on one cell are summed by a
//     segmented tree of shuffles and their first lanes add the eight corners
//     with float32 atomicAdd (a RED to L2).
// Shared-memory atomicAdd of float32 and float64 is a compare-and-swap loop
// on this card (ATOMS.CAST.SPIN in the SASS), and lanes of one warp hit the
// same LUT rows: an atomic an active lane and step took 6.9 of the
// backward's 10.23 ms on an H100 80GB HBM3 at 700 W
// (chip_smoke.py --diff-march).  g_s also flows back
// through the clips (half the gradient at every tie, as jnp.clip and
// jnp.maximum give), the transform (log's 1 / x), the trilinear weights, the
// position (direction: an atomicAdd a pixel and brick; eye) and the
// distance (d0: written; step).  The per-brick and global sums (step,
// origin, cell, eye, the five scalars) are reduced over the block and
// written a block apart; ops/diffmarch.py adds them.  Atomics and the list's
// order change from run to run, so the backward is held at 1e-4 of the
// gradient's scale, not bit for bit.
//
// What bounds it on this card: operations and latency, not bytes.  The
// forward writes 16 B a pair and reads each brick's cells and LUT about once
// from device memory (L1 and L2 serve the rest); a valid sample is about 270
// SASS instructions (the forward's loop body, with the normalisation) and
// nine gathers in two dependent rounds; the backward does about three
// samples' work a valid sample, the adjoint and a warp's adds.  What the
// design does about it: the pair list, a ray stops at the first step that
// cannot be active again, the backward skips every segment whose checkpoint
// is already opaque or whose first distance is past the box, and nothing is
// stored per step.
//
// Numerics: each FMA site of the plain version is a __fmaf_rn here; the build
// passes -fmad=false, so nothing else contracts, and divisions are IEEE
// (-prec-div).  The forward equals its plain version bit for bit: the plain
// version's numerics.fma rounds once, as __fmaf_rn does.  The tangent and the
// backward's derivative arithmetic are float32 in another order than
// autograd's, and their own divisions are __fdividef (g / x, g / cell) or a
// reciprocal a pair (the tangent's / cell): both are held at 1e-4 of the
// gradient's scale.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // hit pairs a block of the forward
constexpr int kBackThreads = 128;  // hit pairs a block of the backward
constexpr int kBackWarps = kBackThreads / 32;
constexpr int kSegment = 16;   // steps between two opacity checkpoints
constexpr int kPartials = 15;  // step, origin (3), cell (3), eye (3), scalars (5)
constexpr int kLutCopyBytes = 96 * 1024;  // the backward's LUT copies, at most
// blocks a launch aims at: each brick's blocks stride over its list
constexpr int kGridBlocks = 4096;

constexpr int kLog = 1, kNormalize = 2, kClip = 4, kSoft = 8;

// XLA's float32 log (ops/numerics.py, its constants as XLA spells them)
constexpr float kLogP0 = 0x1.204376p-4f, kLogP1 = -0x1.d7a370p-4f,
                kLogP2 = 0x1.de4a34p-4f, kLogP3 = -0x1.fcba9ep-4f,
                kLogP4 = 0x1.23d37ep-3f, kLogP5 = -0x1.555ca0p-3f,
                kLogP6 = 0x1.999d58p-3f, kLogP7 = -0x1.fffff8p-3f,
                kLogP8 = 0x1.555554p-2f;
constexpr float kLogQ1 = -0x1.bd0106p-13f;
constexpr float kLogQ2 = 0x1.63p-1f;
constexpr float kSqrtHalf = 0x1.6a09e6p-1f;
constexpr float kMinNormal = 0x1p-126f;

struct Inputs {
  const float* data;      // [B, nx, ny, nz]
  const float4* luts;     // [B, size]
  const float* d0;        // [B, P]
  const float* dirs;      // [P, 3]
  const float* eye;       // [3]
  const float* steps;     // [B]
  const float* bmin;      // [B, 3]
  const float* cell;      // [B, 3]
  const float* scalars;   // [5] rmin, rinv, floor, nmin, ninv
  const float* tmax;      // [B, P]
  const uint8_t* hit;     // [B, P]
  const float* bmax;      // [B, 3]
  const int* top;         // [B, 3]
  const int* low;         // [B, 3]
  int num_bricks, num_pixels, pad_y, pad_z, lut_entries, num_steps, flags;
  int64_t cells;          // nx * ny * nz
  float clip_start, clip_span, clip_rspan, clip_end;
};

// The tangent's groups of Inputs' differentiable fields: an instantiation
// of the march carries the tangent terms of its groups only.  The host
// leaves out a field that carries no tangent (a null pointer); a group is
// present where any of its fields is.
constexpr int kTanData = 1, kTanLut = 2, kTanGeometry = 4, kTanScalars = 8;
constexpr int kTanAll = kTanData | kTanLut | kTanGeometry | kTanScalars;

struct Tangents {  // the tangents of Inputs' differentiable fields (null: none)
  const float* data;
  const float4* luts;
  const float* d0;
  const float* dirs;
  const float* eye;
  const float* steps;
  const float* bmin;
  const float* cell;
  const float* scalars;
};

// torch.maximum / torch.minimum of a value and a bound: NaN propagates
__device__ __forceinline__ float tmax_(float x, float lo) {
  return x != x ? x : (x < lo ? lo : x);
}
__device__ __forceinline__ float tmin_(float x, float hi) {
  return x != x ? x : (hi < x ? hi : x);
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return tmin_(tmax_(x, lo), hi);
}
// d clip(x, lo, hi) / dx under torch.maximum / minimum's rules: half at a
// tie (jnp.clip's), 1 for NaN
__device__ __forceinline__ float clip_grad(float x, float lo, float hi) {
  const float up = x < lo ? 0.0f : (x == lo ? 0.5f : 1.0f);
  const float y = tmax_(x, lo);
  return up * (y > hi ? 0.0f : (y == hi ? 0.5f : 1.0f));
}
__device__ __forceinline__ float lerp(float a, float b, float w) {
  return __fmaf_rn(a, 1.0f - w, b * w);  // FMA: a * (1 - w) + b * w
}

__device__ __forceinline__ float xla_log(float x) {
  const float xx = fabsf(x) < kMinNormal ? 0.0f : x;
  // nan_to_num (NaN -> 0, +-inf -> +-FLT_MAX), then at least the least normal
  float c = xx != xx ? 0.0f : (isinf(xx) ? copysignf(FLT_MAX, xx) : xx);
  c = tmax_(c, kMinNormal);
  const int bits = __float_as_int(c);
  const float m = __int_as_float((bits & static_cast<int>(0x807FFFFF)) | 0x3F000000);
  const bool small = m < kSqrtHalf;
  const float e = (static_cast<float>((bits >> 23) - 127) + 1.0f) - (small ? 1.0f : 0.0f);
  const float t = (m - 1.0f) + (small ? m : 0.0f);
  const float t2 = t * t;
  const float t3 = t2 * t;
  float y = __fmaf_rn(t, kLogP0, kLogP1);
  float y1 = __fmaf_rn(t, kLogP3, kLogP4);
  float y2 = __fmaf_rn(t, kLogP6, kLogP7);
  y = __fmaf_rn(y, t, kLogP2);
  y1 = __fmaf_rn(y1, t, kLogP5);
  y2 = __fmaf_rn(y2, t, kLogP8);
  y = __fmaf_rn(y, t3, y1);
  y = __fmaf_rn(y, t3, y2);
  y = __fmaf_rn(y, t3, kLogQ1 * e);
  float out = __fmaf_rn(kLogQ2, e, __fmaf_rn(t2, -0.5f, t) + y);
  if (xx == 0.0f) out = -INFINITY;
  if (xx == INFINITY) out = INFINITY;
  if (xx < 0.0f || xx != xx) out = NAN;
  return out;
}

// What one thread's (brick, pixel) pair holds through its march.
struct Ray {
  float e[3], d[3];        // eye, direction
  float d0, tmax, step;
  float lo[3], hi[3];      // the box
  float cell[3];
  int top[3], low[3];
  float rmin, rinv, pfloor, nmin, ninv;
  int b;                   // the brick (its cells and LUT are read through it)
};

__device__ __forceinline__ Ray load_ray(const Inputs& in, int b, int n, int64_t pair) {
  Ray r;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r.e[a] = in.eye[a];
    r.d[a] = in.dirs[3 * n + a];
    r.lo[a] = in.bmin[3 * b + a];
    r.hi[a] = in.bmax[3 * b + a];
    r.cell[a] = in.cell[3 * b + a];
    r.top[a] = in.top[3 * b + a];
    r.low[a] = in.low[3 * b + a];
  }
  r.d0 = in.d0[pair];
  r.tmax = in.tmax[pair];
  r.step = in.steps[b];
  r.rmin = in.scalars[0];
  r.rinv = in.scalars[1];
  r.pfloor = in.scalars[2];
  r.nmin = in.scalars[3];
  r.ninv = in.scalars[4];
  r.b = b;
  return r;
}

// Step k's distance and position; true when the step samples (the caller
// tests the opacity).  ``beyond``: the distance is at or past tmax.
__device__ __forceinline__ bool gate(const Ray& r, float kf, float& dist, float p[3],
                                     bool& beyond) {
  dist = r.d0 + r.step * kf;  // rounded twice, as the plain version
  beyond = !(dist < r.tmax);
  if (beyond) return false;
  bool inside = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    p[a] = __fmaf_rn(r.d[a], dist, r.e[a]);  // FMA: eye + direction * distance
    inside = inside && p[a] >= r.lo[a] && p[a] <= r.hi[a];
  }
  return inside;
}

// One sample and the intermediates its derivatives read.
struct Sample {
  float rel[3], h[3], f[3], w[3];
  int i0[3];
  int base, ox, oy, oz;  // corner (z, y, x): base + z oz + y oy + x ox
  float c[8];            // corners, index (z * 2 + y) * 2 + x
  float cx[4], cy[2];
  float value0, v1, lv, q2, value, m, scalar, q, n, u, wl;
  bool finite, positive, ins;
  int j0, j1;
  float4 row0, row1, s;
};

__device__ __forceinline__ void sample(const Inputs& in, const Ray& r, const float p[3],
                                       Sample& s) {
  int i1[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    s.rel[a] = p[a] - r.lo[a];
    s.h[a] = s.rel[a] / r.cell[a] - 0.5f;
    s.f[a] = clip(s.h[a], 0.0f, static_cast<float>(r.top[a]));
    // floor then clamp, as torch.floor(f).long(); NaN converts to 0
    s.i0[a] = min(max(static_cast<int>(floorf(s.f[a])), 0), r.low[a]);
    s.w[a] = clip(s.f[a] - static_cast<float>(s.i0[a]), 0.0f, 1.0f);
    i1[a] = min(s.i0[a] + 1, r.top[a]);
  }
  s.base = (s.i0[0] * in.pad_y + s.i0[1]) * in.pad_z + s.i0[2];
  s.ox = (i1[0] - s.i0[0]) * in.pad_y * in.pad_z;
  s.oy = (i1[1] - s.i0[1]) * in.pad_z;
  s.oz = i1[2] - s.i0[2];
#pragma unroll
  for (int z = 0; z < 2; ++z)
#pragma unroll
    for (int y = 0; y < 2; ++y)
#pragma unroll
      for (int x = 0; x < 2; ++x)
        s.c[(z * 2 + y) * 2 + x] = in.data[r.b * in.cells + s.base + z * s.oz + y * s.oy +
                                           x * s.ox];
#pragma unroll
  for (int zy = 0; zy < 4; ++zy) s.cx[zy] = lerp(s.c[zy * 2], s.c[zy * 2 + 1], s.w[0]);
#pragma unroll
  for (int z = 0; z < 2; ++z) s.cy[z] = lerp(s.cx[z * 2], s.cx[z * 2 + 1], s.w[1]);
  const float raw = lerp(s.cy[0], s.cy[1], s.w[2]);
  // the scalar transform, the soft tail, the range
  s.finite = isfinite(raw);
  s.value0 = s.finite ? raw : 0.0f;
  float v = s.value0;
  if (in.flags & kLog) {
    s.positive = s.value0 > 0.0f;
    s.v1 = s.positive ? tmax_(s.value0, r.pfloor) : r.pfloor;
    v = xla_log(s.v1);
  }
  s.lv = v;
  if (in.flags & kNormalize) {
    s.q2 = (v - r.nmin) * r.ninv;
    v = clip(s.q2, 0.0f, 1.0f);
  }
  s.value = v;
  if (in.flags & kClip) {
    v = clip(v, 0.0f, in.clip_end);
    if (in.flags & kSoft) {
      s.m = (v - in.clip_start) * in.clip_rspan;
      const float m2 = s.m * s.m;
      const float smooth = __fmaf_rn(-s.m, m2, s.m + m2);  // FMA: (m + m^2) - m m^2
      const float soft = __fmaf_rn(smooth, in.clip_span, in.clip_start);  // FMA
      s.ins = v > in.clip_start && v < in.clip_end;
      if (s.ins) v = soft;
    }
  }
  s.scalar = v;
  s.q = (v - r.rmin) * r.rinv;
  s.n = clip(s.q, 0.0f, 1.0f);
  // the lerped LUT lookup
  const int table_max = in.lut_entries - 1;
  s.u = clip(s.n, 0.0f, 1.0f) * static_cast<float>(table_max);
  s.j0 = min(max(static_cast<int>(floorf(s.u)), 0), max(table_max - 1, 0));
  s.wl = clip(s.u - static_cast<float>(s.j0), 0.0f, 1.0f);
  s.j1 = min(s.j0 + 1, table_max);
  const float4* lut = in.luts + static_cast<int64_t>(r.b) * in.lut_entries;
  s.row0 = lut[s.j0];
  s.row1 = lut[s.j1];
  s.s.x = lerp(s.row0.x, s.row1.x, s.wl);
  s.s.y = lerp(s.row0.y, s.row1.y, s.wl);
  s.s.z = lerp(s.row0.z, s.row1.z, s.wl);
  s.s.w = lerp(s.row0.w, s.row1.w, s.wl);
}

// What one pair's tangent reads once: its geometry's and the scalars'
// tangents (0 where a field carries none) and the reciprocal cell size.
struct RayTangent {
  float d0, step, dir[3], eye[3], bmin[3], cell[3], rcell[3];
  float rmin, rinv, pfloor, nmin, ninv;
};

template <int kGroups>
__device__ __forceinline__ RayTangent load_ray_tangent(const Tangents& t, const Ray& r, int n,
                                                       int64_t pair) {
  RayTangent rt = {};
  if (kGroups & kTanGeometry) {
    rt.d0 = t.d0 != nullptr ? t.d0[pair] : 0.0f;
    rt.step = t.steps != nullptr ? t.steps[r.b] : 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      rt.dir[a] = t.dirs != nullptr ? t.dirs[3 * n + a] : 0.0f;
      rt.eye[a] = t.eye != nullptr ? t.eye[a] : 0.0f;
      rt.bmin[a] = t.bmin != nullptr ? t.bmin[3 * r.b + a] : 0.0f;
      rt.cell[a] = t.cell != nullptr ? t.cell[3 * r.b + a] : 0.0f;
      rt.rcell[a] = 1.0f / r.cell[a];  // one division an axis a pair
    }
  }
  if (kGroups & kTanScalars) {
    rt.rmin = t.scalars[0];
    rt.rinv = t.scalars[1];
    rt.pfloor = t.scalars[2];
    rt.nmin = t.scalars[3];
    rt.ninv = t.scalars[4];
  }
  return rt;
}

// The tangent of one sample (forward mode from the sample's intermediates),
// with the terms of the groups in kGroups only.
template <int kGroups>
__device__ __forceinline__ float4 sample_tangent(const Inputs& in, const Tangents& t,
                                                 const Ray& r, const RayTangent& rt,
                                                 const Sample& s, float kf, float dist) {
  constexpr bool kData = kGroups & kTanData, kGeometry = kGroups & kTanGeometry;
  constexpr bool kScalars = kGroups & kTanScalars;
  // the scalar's tangent exists where the data, the geometry or the
  // transform's scalars carry one
  constexpr bool kValue = kData || kGeometry || kScalars;
  float v_t = 0.0f;
  if (kData || kGeometry) {
    float w_t[3] = {0.0f, 0.0f, 0.0f};
    if (kGeometry) {
      const float dist_t = rt.d0 + rt.step * kf;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float pos_t = rt.dir[a] * dist + r.d[a] * dist_t + rt.eye[a];
        // d h / d(position, origin, cell): rel / cell = h + 0.5
        const float h_t = ((pos_t - rt.bmin[a]) - (s.h[a] + 0.5f) * rt.cell[a]) * rt.rcell[a];
        w_t[a] = clip_grad(s.f[a] - static_cast<float>(s.i0[a]), 0.0f, 1.0f) *
                 clip_grad(s.h[a], 0.0f, static_cast<float>(r.top[a])) * h_t;
      }
    }
    float cx_t[4], cy_t[2];
#pragma unroll
    for (int zy = 0; zy < 4; ++zy) {
      cx_t[zy] = kGeometry ? (s.c[zy * 2 + 1] - s.c[zy * 2]) * w_t[0] : 0.0f;
      if (kData) {
        const float* vol_t = t.data + r.b * in.cells;
        const int o = s.base + (zy >> 1) * s.oz + (zy & 1) * s.oy;
        cx_t[zy] += vol_t[o] * (1.0f - s.w[0]) + vol_t[o + s.ox] * s.w[0];
      }
    }
#pragma unroll
    for (int z = 0; z < 2; ++z)
      cy_t[z] = cx_t[z * 2] * (1.0f - s.w[1]) + cx_t[z * 2 + 1] * s.w[1] +
                (kGeometry ? (s.cx[z * 2 + 1] - s.cx[z * 2]) * w_t[1] : 0.0f);
    v_t = cy_t[0] * (1.0f - s.w[2]) + cy_t[1] * s.w[2] +
          (kGeometry ? (s.cy[1] - s.cy[0]) * w_t[2] : 0.0f);
    if (!s.finite) v_t = 0.0f;
  }
  float wl_t = 0.0f;
  if (kValue) {
    if (in.flags & kLog) {
      const float share = s.value0 < r.pfloor ? 0.0f : (s.value0 == r.pfloor ? 0.5f : 1.0f);
      v_t = s.positive ? share * v_t + (1.0f - share) * rt.pfloor : rt.pfloor;
      v_t = __fdividef(v_t, s.v1);  // log's rule
    }
    if (in.flags & kNormalize)
      v_t = clip_grad(s.q2, 0.0f, 1.0f) *
            ((v_t - rt.nmin) * r.ninv + (s.lv - r.nmin) * rt.ninv);
    if (in.flags & kClip) v_t = clip_grad(s.value, 0.0f, in.clip_end) * v_t;
    if ((in.flags & kSoft) && s.ins) {
      const float m_t = v_t * in.clip_rspan;
      v_t = (m_t * (1.0f - s.m * s.m) + (1.0f - s.m) * (2.0f * s.m) * m_t) * in.clip_span;
    }
    const float q_t = (v_t - rt.rmin) * r.rinv + (s.scalar - r.rmin) * rt.rinv;
    const float u_t = clip_grad(s.n, 0.0f, 1.0f) * clip_grad(s.q, 0.0f, 1.0f) * q_t *
                      static_cast<float>(in.lut_entries - 1);
    wl_t = clip_grad(s.u - static_cast<float>(s.j0), 0.0f, 1.0f) * u_t;
  }
  float4 st = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (kValue) {
    st.x = (s.row1.x - s.row0.x) * wl_t;
    st.y = (s.row1.y - s.row0.y) * wl_t;
    st.z = (s.row1.z - s.row0.z) * wl_t;
    st.w = (s.row1.w - s.row0.w) * wl_t;
  }
  if (kGroups & kTanLut) {
    const float4* lut_t = t.luts + static_cast<int64_t>(r.b) * in.lut_entries;
    const float4 a0 = lut_t[s.j0], a1 = lut_t[s.j1];
    st.x += a0.x * (1.0f - s.wl) + a1.x * s.wl;
    st.y += a0.y * (1.0f - s.wl) + a1.y * s.wl;
    st.z += a0.z * (1.0f - s.wl) + a1.z * s.wl;
    st.w += a0.w * (1.0f - s.wl) + a1.w * s.wl;
  }
  return st;
}

// Threads a block and blocks an SM that each instantiation of the march
// asks for (__launch_bounds__): the forward 256 x 3 (64 registers); a
// tangent without the data's and the LUT's terms 256 x 2 (128 registers);
// the others 128 x 3: every group's 153 registers in 12 warps an SM, where
// blocks of 256 fit one (8 warps), without the spills that 128 registers
// cost it (chip_smoke.py --diff-march)
__host__ __device__ constexpr bool heavy_tangent(int groups) {
  return (groups & (kTanData | kTanLut)) != 0;
}
__host__ __device__ constexpr int march_threads(int groups) {
  return heavy_tangent(groups) ? 128 : kThreads;
}
__host__ __device__ constexpr int march_blocks(int groups) {
  return groups == 0 ? 3 : (heavy_tangent(groups) ? 3 : 2);
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kListThreads = 256, kListPixels = 4;  // a block of the pair list
constexpr int kListWarps = kListThreads / 32;

// Each brick's hit pairs as a list of pixels: list[b * P + i] for i below
// counts[b] (which starts at 0).  A block reads kListPixels rows of
// kListThreads neighbouring pixels and writes its hits in pixel order at an
// offset one atomicAdd of the block takes; where ``zero_out`` is given, it
// writes the zero row of every pair that misses there.
__global__ void __launch_bounds__(kListThreads)
    diffmarch_pairs_kernel(const uint8_t* hit, int num_pixels, int* list, int* counts,
                           float4* zero_out) {
  __shared__ int s_warp[kListPixels * kListWarps];
  __shared__ int s_base;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = blockIdx.x * kListThreads * kListPixels + threadIdx.x;
  const int64_t row = static_cast<int64_t>(b) * num_pixels;
  unsigned masks[kListPixels];
#pragma unroll
  for (int i = 0; i < kListPixels; ++i) {
    const int n = first + i * kListThreads;
    const bool inside = n < num_pixels;
    const bool h = inside && hit[row + n] != 0;
    if (inside && !h && zero_out != nullptr)
      zero_out[row + n] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    masks[i] = __ballot_sync(kFull, h);
    if (lane == 0) s_warp[i * kListWarps + warp] = __popc(masks[i]);
  }
  __syncthreads();
  int total = 0;
  for (int w = 0; w < kListPixels * kListWarps; ++w) total += s_warp[w];
  if (threadIdx.x == 0) s_base = total > 0 ? atomicAdd(counts + b, total) : 0;
  __syncthreads();
  // pixel order is (row i, warp, lane): the hits before each of this
  // thread's own
  int before = s_base;
#pragma unroll
  for (int i = 0; i < kListPixels; ++i) {
    for (int w = 0; w < kListWarps; ++w)
      if (w < warp) before += s_warp[i * kListWarps + w];
    if ((masks[i] >> lane) & 1u)
      list[row + before + __popc(masks[i] & ((1u << lane) - 1u))] = first + i * kListThreads;
    for (int w = warp; w < kListWarps; ++w) before += s_warp[i * kListWarps + w];
  }
}

// How a brick's blocks find their hit pairs, and where a pair's rows sit.
//   * Dense rows (diffmarch_pairs_kernel's list; the sharded path, forward
//     mode): brick b's hits are the pixels list[b * P + i] for i below
//     counts[b], and a pair's rows (d0, tmax, the output, the gradient) sit
//     at b * P + pixel.
//   * Pair rows (diffpairs_build_kernel's list): brick b's pairs are one run
//     a tile of pixels, pairs run_off[b * T + t] onwards, run_cnt[b * T + t]
//     of them, brick_count[b] in all; a pair's rows sit at its index in the
//     view's pair list, and pixel[index] is its pixel.
// Checkpoints are [C, rows]: rows is B * P or the pair list's capacity.
struct Walk {
  const int* list;
  const int* counts;
  const int* run_off;
  const int* run_cnt;
  const int* brick_count;
  const int* pixel;
  int num_tiles;
  int64_t rows;
};

__device__ __forceinline__ int walk_count(const Walk& w, int b) {
  return w.run_cnt != nullptr ? w.brick_count[b] : w.counts[b];
}

// Pair rows: s_first[t] = brick b's pairs in the tiles before t, t <= T; a
// block-wide exclusive scan of the brick's run counts (every thread of the
// block calls it).
__device__ void scan_runs(const Walk& w, int b, int* s_first) {
  __shared__ int s_part[32];
  const int T = w.num_tiles;
  const int* cnt = w.run_cnt + static_cast<int64_t>(b) * T;
  const int per = (T + blockDim.x - 1) / blockDim.x;
  const int lo = min(T, static_cast<int>(threadIdx.x) * per), hi = min(T, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += cnt[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) s_part[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < static_cast<int>(blockDim.x >> 5) ? s_part[lane] : 0;
    int all = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, all, o);
      if (lane >= o) all += y;
    }
    if (lane < static_cast<int>(blockDim.x >> 5)) s_part[lane] = all - v;
  }
  __syncthreads();
  int run = s_part[warp] + inc - sum;
  for (int i = lo; i < hi; ++i) {
    s_first[i] = run;
    run += cnt[i];
  }
  if (threadIdx.x == 0) s_first[T] = w.brick_count[b];
  __syncthreads();
}

// Brick b's i-th hit pair: its pixel n and its rows' index.
__device__ __forceinline__ void walk_at(const Walk& w, int num_pixels, int b, int i,
                                        const int* s_first, int& n, int64_t& pair) {
  if (w.run_cnt == nullptr) {
    const int64_t row = static_cast<int64_t>(b) * num_pixels;
    n = w.list[row + i];
    pair = row + n;
    return;
  }
  int lo = 0, hi = w.num_tiles;  // s_first[lo] <= i < s_first[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (s_first[mid] <= i) lo = mid;
    else hi = mid;
  }
  pair = w.run_off[static_cast<int64_t>(b) * w.num_tiles + lo] + (i - s_first[lo]);
  n = w.pixel[pair];
}

// ---- the pair list: diffpairs_build_kernel ----------------------------------
//
// Replaces diff.py's eager ray set-up over every (brick, pixel) pair: the
// slab test (ops/raymarch.py::_slab_intersect), the hit mask, the first
// sample distance d0 and the pair list, one launch a view.  A block is a
// tile of per_thread x 256 pixels, a thread one pixel in each of its
// per_thread rows; the bricks are walked in the fold's order (order[k],
// front first, a permutation that each block checks and traps on, as the
// fold kernels do).
//   * First walk: each pixel counts its hits; a brick any pixel of the
//     tile hits is marked in shared memory.  The tile's pixels take their
//     first slot by a block scan, the tile its offset in the list by one
//     atomicAdd (the tiles' order in the list is the order they finish).
//   * Second walk, over the marked bricks alone: each hit's pair is
//     written brick-major within the tile (one run a brick, in fold order,
//     each run in pixel order: run_off / run_cnt, brick_count), and its
//     index into the pixel's own slots (fold_index from pixel_start, in
//     fold order: what the pair fold walks).
// A tile whose pairs would pass the capacity writes no pair: its pixels'
// counts read -1 and its runs 0, and *total still counts what it needed,
// so that ops/diffmarch.py grows the list and runs again (eagerly), or the
// pair fold writes NaN there (inside a CUDA graph).  Every arithmetic step
// is the eager path's on the card, op for op (-fmad=false, IEEE division):
// d0 and tmax equal what diff.render_layers_diff computes for the pair.
constexpr int kBuildThreads = 256;
constexpr int kBuildWarps = kBuildThreads / 32;
constexpr int kBuildRows = 4;  // pixels a thread, at most

struct SlabRay {  // what a pixel's slab tests share: the direction's reciprocal
  float inv[3];
  bool par[3];
};

__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// _slab_intersect for one (box, ray): the entry and exit distances
__device__ __forceinline__ void slab(const float e[3], const SlabRay& r, const float lo[3],
                                     const float hi[3], float& tmin, float& tmax) {
  float near[3], far[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t1 = __fmul_rn(__fsub_rn(lo[a], e[a]), r.inv[a]);
    const float t2 = __fmul_rn(__fsub_rn(hi[a], e[a]), r.inv[a]);
    const bool inside = e[a] >= lo[a] && e[a] <= hi[a];
    near[a] = r.par[a] ? (inside ? -INFINITY : INFINITY) : nan_min(t1, t2);
    far[a] = r.par[a] ? (inside ? INFINITY : -INFINITY) : nan_max(t1, t2);
  }
  tmin = nan_max(nan_max(near[0], near[1]), near[2]);
  tmax = nan_min(nan_min(far[0], far[1]), far[2]);
}

// a block-wide exclusive scan of v (every thread calls it); *total the sum
__device__ __forceinline__ int block_scan(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kBuildWarps; ++w) {
    before += w < warp ? s_warp[w] : 0;
    total += s_warp[w];
  }
  __syncthreads();
  return before + inc - v;
}

__global__ void __launch_bounds__(kBuildThreads)
    diffpairs_build_kernel(const float* eye, const float* dirs, const float* bmin,
                           const float* bmax, const float* eps, const long long* order,
                           int num_bricks, int num_pixels, int per_thread, long long capacity,
                           unsigned long long* total, int* brick_count, int* pair_brick,
                           int* pair_pixel, float* pair_d0, float* pair_tmax, int* fold_index,
                           int* pixel_start, int* pixel_count, int* run_off, int* run_cnt) {
  extern __shared__ unsigned s_bits[];  // [2][words]: bricks seen in order; ranks marked
  __shared__ int s_warp[kBuildWarps];
  __shared__ int s_cnt[kBuildRows * kBuildWarps];
  __shared__ long long s_base;
  const int words = (num_bricks + 31) / 32;
  unsigned* seen = s_bits;
  unsigned* marked = s_bits + words;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x, num_tiles = gridDim.x;
  for (int w = threadIdx.x; w < 2 * words; w += kBuildThreads) s_bits[w] = 0u;
  __syncthreads();
  for (int k = threadIdx.x; k < num_bricks; k += kBuildThreads) {  // order: a permutation
    const long long b = order[k];
    if (b < 0 || b >= num_bricks) __trap();
    const unsigned bit = 1u << (b & 31);
    if (atomicOr(seen + (b >> 5), bit) & bit) __trap();
  }
  __syncthreads();  // no thread reads a brick before the order is checked
  const float e[3] = {eye[0], eye[1], eye[2]};
  SlabRay ray[kBuildRows] = {};
  int hits[kBuildRows];
  const int first = tile * per_thread * kBuildThreads + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kBuildRows; ++j) {
    hits[j] = 0;
    const int p = first + j * kBuildThreads;
    if (j < per_thread && p < num_pixels) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float d = dirs[3 * p + a];
        ray[j].par[a] = fabsf(d) < 1e-8f;
        ray[j].inv[a] = __fdiv_rn(1.0f, ray[j].par[a] ? 1.0f : d);
      }
    }
  }
  // first walk: counts, and the bricks the tile meets
  for (int k = 0; k < num_bricks; ++k) {
    const int b = static_cast<int>(order[k]);
    const float lo[3] = {bmin[3 * b], bmin[3 * b + 1], bmin[3 * b + 2]};
    const float hi[3] = {bmax[3 * b], bmax[3 * b + 1], bmax[3 * b + 2]};
    bool any = false;
#pragma unroll
    for (int j = 0; j < kBuildRows; ++j) {
      if (j < per_thread && first + j * kBuildThreads < num_pixels) {
        float tmin, tmax;
        slab(e, ray[j], lo, hi, tmin, tmax);
        const bool h = tmax >= tmin;
        hits[j] += h;
        any |= h;
      }
    }
    if (__any_sync(kFull, any) && lane == 0) atomicOr(marked + (k >> 5), 1u << (k & 31));
  }
  // the pixels' first slots, in pixel order (row j, then thread)
  int slot0[kBuildRows] = {};
  int tile_total = 0;
#pragma unroll
  for (int j = 0; j < kBuildRows; ++j) {
    if (j < per_thread) {
      int row_total;
      slot0[j] = tile_total + block_scan(hits[j], s_warp, row_total);
      tile_total += row_total;
    }
  }
  if (threadIdx.x == 0)
    s_base = tile_total > 0 ? static_cast<long long>(atomicAdd(
                                  total, static_cast<unsigned long long>(tile_total)))
                            : 0;
  __syncthreads();  // also: every rank is marked
  const long long base = s_base;
  const bool over = base + tile_total > capacity;
#pragma unroll
  for (int j = 0; j < kBuildRows; ++j) {
    const int p = first + j * kBuildThreads;
    if (j < per_thread && p < num_pixels) {
      pixel_start[p] = over ? 0 : static_cast<int>(base + slot0[j]);
      pixel_count[p] = over ? -1 : hits[j];
    }
  }
  for (int k = threadIdx.x; k < num_bricks; k += kBuildThreads) {  // runs, 0 unless marked
    const int b = static_cast<int>(order[k]);
    if (over || !((marked[k >> 5] >> (k & 31)) & 1u)) {
      run_off[static_cast<int64_t>(b) * num_tiles + tile] = 0;
      run_cnt[static_cast<int64_t>(b) * num_tiles + tile] = 0;
    }
  }
  if (over) return;
  // second walk, the marked bricks in fold order: the pairs
  int filled[kBuildRows];
#pragma unroll
  for (int j = 0; j < kBuildRows; ++j) filled[j] = 0;
  long long run = base;  // the next run's first pair
  for (int w = 0; w < words; ++w) {
    unsigned bits = marked[w];
    while (bits) {
      const int k = 32 * w + __ffs(bits) - 1;
      bits &= bits - 1u;
      const int b = static_cast<int>(order[k]);
      const float lo[3] = {bmin[3 * b], bmin[3 * b + 1], bmin[3 * b + 2]};
      const float hi[3] = {bmax[3 * b], bmax[3 * b + 1], bmax[3 * b + 2]};
      const float eb = eps[b];
      bool hit[kBuildRows];
      float tmin[kBuildRows], tmax[kBuildRows];
      unsigned mask[kBuildRows];
#pragma unroll
      for (int j = 0; j < kBuildRows; ++j) {
        hit[j] = false;
        if (j < per_thread && first + j * kBuildThreads < num_pixels) {
          slab(e, ray[j], lo, hi, tmin[j], tmax[j]);
          hit[j] = tmax[j] >= tmin[j];
        }
        mask[j] = __ballot_sync(kFull, hit[j]);
        if (j < per_thread && lane == 0) s_cnt[j * kBuildWarps + warp] = __popc(mask[j]);
      }
      __syncthreads();
      int before = 0, cnt = 0;  // the run's pairs before row j, warp w; the run's total
      for (int i = 0; i < per_thread * kBuildWarps; ++i) cnt += s_cnt[i];
#pragma unroll
      for (int j = 0; j < kBuildRows; ++j) {
        if (j >= per_thread) continue;
        int at = before;
        for (int v = 0; v < warp; ++v) at += s_cnt[j * kBuildWarps + v];
        if (hit[j]) {
          const long long q = run + at + __popc(mask[j] & ((1u << lane) - 1u));
          const int p = first + j * kBuildThreads;
          float d0 = tmin[j] + eb;  // hit: the entry distance, plus mesh_eps
          d0 = d0 < 0.0f ? eb : d0;
          pair_brick[q] = b;
          pair_pixel[q] = p;
          pair_d0[q] = d0;
          pair_tmax[q] = tmax[j];
          fold_index[base + slot0[j] + filled[j]++] = static_cast<int>(q);
        }
        for (int v = 0; v < kBuildWarps; ++v) before += s_cnt[j * kBuildWarps + v];
      }
      if (threadIdx.x == 0) {
        run_off[static_cast<int64_t>(b) * num_tiles + tile] = static_cast<int>(run);
        run_cnt[static_cast<int64_t>(b) * num_tiles + tile] = cnt;
        atomicAdd(brick_count + b, cnt);
      }
      run += cnt;
      __syncthreads();  // s_cnt is read before the next brick writes it
    }
  }
}

// One hit pair's march, from the list: brick b, pixel n.  kGroups: the
// tangent groups carried beside the value (0: the forward alone).
template <int kGroups>
__device__ __forceinline__ void march_pair(const Inputs& in, const Tangents& t, int b, int n,
                                           int64_t pair, int64_t rows, float4* out,
                                           float4* out_tangent, float* ckpt) {
  constexpr bool kTangent = kGroups != 0;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 acc_t = acc;
  const Ray r = load_ray(in, b, n, pair);
  RayTangent rt;
  if (kTangent) rt = load_ray_tangent<kGroups>(t, r, n, pair);
  const bool rising = !(r.step < 0.0f);  // distances never decrease
  int next = 0;  // the next checkpoint to write
  for (int k = 0; k < in.num_steps; ++k) {
    if (ckpt != nullptr && k == next * kSegment)
      ckpt[next++ * rows + pair] = acc.w;
    if (!(acc.w < 1.0f)) break;  // never active again
    const float kf = static_cast<float>(k);
    float dist, p[3];
    bool beyond;
    if (!gate(r, kf, dist, p, beyond)) {
      if (beyond && rising) break;
      continue;
    }
    Sample s;
    sample(in, r, p, s);
    const float alpha = s.s.w * (1.0f - acc.w);
    if (kTangent) {
      const float4 st = sample_tangent<kGroups>(in, t, r, rt, s, kf, dist);
      const float alpha_t = st.w * (1.0f - acc.w) - s.s.w * acc_t.w;
      acc_t.x = acc_t.x + (st.x * alpha + s.s.x * alpha_t);
      acc_t.y = acc_t.y + (st.y * alpha + s.s.y * alpha_t);
      acc_t.z = acc_t.z + (st.z * alpha + s.s.z * alpha_t);
      acc_t.w = acc_t.w + alpha_t;
    }
    acc.x = __fmaf_rn(s.s.x, alpha, acc.x);  // FMA: colour accumulation
    acc.y = __fmaf_rn(s.s.y, alpha, acc.y);
    acc.z = __fmaf_rn(s.s.z, alpha, acc.z);
    acc.w = acc.w + alpha;
  }
  if (ckpt != nullptr)  // the rest: no later step changes the opacity
    for (; next * kSegment < in.num_steps; ++next)
      ckpt[next * rows + pair] = acc.w;
  if (out != nullptr) out[pair] = acc;
  if (kTangent) out_tangent[pair] = acc_t;
}

// A thread a hit pair of brick blockIdx.y's list, the brick's blocks
// striding over it; in dense rows the misses have their zero rows from the
// list's kernel, in pair rows they have no row.
template <int kGroups>
__global__ void __launch_bounds__(march_threads(kGroups), march_blocks(kGroups))
    diffmarch_forward_kernel(Inputs in, Tangents t, Walk walk, float4* out,
                             float4* out_tangent, float* ckpt) {
  extern __shared__ int s_first_fwd[];  // pair rows: [num_tiles + 1] (scan_runs)
  constexpr int kBlock = march_threads(kGroups);
  const int b = blockIdx.y;
  const int count = walk_count(walk, b);
  if (static_cast<int>(blockIdx.x) * kBlock >= count) return;  // the whole block
  if (walk.run_cnt != nullptr) scan_runs(walk, b, s_first_fwd);
  for (int i = blockIdx.x * kBlock + threadIdx.x; i < count; i += gridDim.x * kBlock) {
    int n;
    int64_t pair;
    walk_at(walk, in.num_pixels, b, i, s_first_fwd, n, pair);
    march_pair<kGroups>(in, t, b, n, pair, walk.rows, out, out_tangent, ckpt);
  }
}

// The reverse of one active step with opacity ``Aa`` before it: updates the
// cotangent ``lam`` and the per-ray and per-block sums, and returns the
// step's LUT gradient (rows j0 then j1, RGBA) in ``g_lut`` and its corners'
// data gradient (index (z * 2 + y) * 2 + x) in ``g_cell``.
__device__ __forceinline__ void adjoint(const Inputs& in, const Ray& r, const Sample& s,
                                        float kf, float dist, float Aa, float4& lam,
                                        float (&g_lut)[8], float (&g_cell)[8],
                                        float part[kPartials], float& g_d0, float g_dir[3]) {
  const float one_minus = 1.0f - Aa;
  const float alpha = s.s.w * one_minus;
  const float g_alpha = lam.x * s.s.x + lam.y * s.s.y + lam.z * s.s.z + lam.w;
  const float4 gs = make_float4(lam.x * alpha, lam.y * alpha, lam.z * alpha,
                                g_alpha * one_minus);
  lam.w = lam.w - s.s.w * g_alpha;
  // the LUT lerp
  const float w0 = 1.0f - s.wl, w1 = s.wl;
  g_lut[0] = gs.x * w0;
  g_lut[1] = gs.y * w0;
  g_lut[2] = gs.z * w0;
  g_lut[3] = gs.w * w0;
  g_lut[4] = gs.x * w1;
  g_lut[5] = gs.y * w1;
  g_lut[6] = gs.z * w1;
  g_lut[7] = gs.w * w1;
  float g = gs.x * (s.row1.x - s.row0.x) + gs.y * (s.row1.y - s.row0.y) +
            gs.z * (s.row1.z - s.row0.z) + gs.w * (s.row1.w - s.row0.w);
  g *= clip_grad(s.u - static_cast<float>(s.j0), 0.0f, 1.0f);
  g = g * static_cast<float>(in.lut_entries - 1) * clip_grad(s.n, 0.0f, 1.0f);
  g *= clip_grad(s.q, 0.0f, 1.0f);  // d / d((scalar - rmin) * rinv)
  part[10] += -(g * r.rinv);
  part[11] += g * (s.scalar - r.rmin);
  g *= r.rinv;
  if ((in.flags & kSoft) && s.ins) {
    const float g_sm = g * in.clip_span;
    g = (g_sm * (1.0f - s.m * s.m) + g_sm * (1.0f - s.m) * (2.0f * s.m)) * in.clip_rspan;
  }
  if (in.flags & kClip) g *= clip_grad(s.value, 0.0f, in.clip_end);
  if (in.flags & kNormalize) {
    g *= clip_grad(s.q2, 0.0f, 1.0f);
    part[13] += -(g * r.ninv);
    part[14] += g * (s.lv - r.nmin);
    g *= r.ninv;
  }
  if (in.flags & kLog) {
    g = __fdividef(g, s.v1);  // log's rule
    const float share = s.value0 < r.pfloor ? 0.0f : (s.value0 == r.pfloor ? 0.5f : 1.0f);
    part[12] += s.positive ? g * (1.0f - share) : g;
    g = s.positive ? g * share : 0.0f;
  }
  if (!s.finite) g = 0.0f;
  // the trilinear weights and corners
  float g_w[3] = {0.0f, 0.0f, g * (s.cy[1] - s.cy[0])};
#pragma unroll
  for (int z = 0; z < 2; ++z) {
    const float g_cy = g * (z ? s.w[2] : 1.0f - s.w[2]);
    g_w[1] += g_cy * (s.cx[z * 2 + 1] - s.cx[z * 2]);
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      const int zy = z * 2 + y;
      const float g_cx = g_cy * (y ? s.w[1] : 1.0f - s.w[1]);
      g_w[0] += g_cx * (s.c[zy * 2 + 1] - s.c[zy * 2]);
      g_cell[zy * 2] = g_cx * (1.0f - s.w[0]);
      g_cell[zy * 2 + 1] = g_cx * s.w[0];
    }
  }
  // h = (pos - bmin) / cell - 0.5, pos = fma(direction, dist, eye)
  float g_dist = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float g_h = g_w[a] * clip_grad(s.f[a] - static_cast<float>(s.i0[a]), 0.0f, 1.0f) *
                      clip_grad(s.h[a], 0.0f, static_cast<float>(r.top[a]));
    const float g_pos = __fdividef(g_h, r.cell[a]);
    part[4 + a] += -(g_pos * __fdividef(s.rel[a], r.cell[a]));
    part[1 + a] -= g_pos;
    part[7 + a] += g_pos;
    g_dir[a] += g_pos * dist;
    g_dist += g_pos * r.d[a];
  }
  g_d0 += g_dist;
  part[0] += g_dist * kf;
}

// Sums the warp's per-lane values ``v`` over runs of neighbouring lanes that
// hold one key, in float32 by a segmented tree of shuffles (as many levels
// as the warp's longest run needs), into the run's first lane; returns true
// on that lane where ``act``.  A lane with nothing to add passes a key no
// other lane holds.  Every lane of the warp calls it, converged.
__device__ __forceinline__ bool sum_runs(int key, bool act, float (&v)[8]) {
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(kFull, key, 1);
  const bool head = lane == 0 || prev != key;
  const unsigned heads = __ballot_sync(kFull, head);
  const unsigned later = heads & ~((2u << lane) - 1u);  // run heads after this lane
  const int end = later ? __ffs(later) - 1 : 32;        // one past this lane's run
  const int longest = static_cast<int>(
      __reduce_max_sync(kFull, head ? static_cast<unsigned>(end - lane) : 0u));
  for (int off = 1; off < longest; off <<= 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float o = __shfl_down_sync(kFull, v[i], off);
      if (lane + off < end) v[i] += o;
    }
  }
  return head && act;
}

// Adds the warp's LUT-gradient rows (``v``: row j0 then row j1, RGBA) to
// ``lut_sum``.  Each group of lanes with one j0 (exact, __match_any_sync)
// is gathered by its first lane through shuffles, a lane at a time, in
// float32 (at most 32 terms); then each group's first lane adds the sums in
// float64: to a copy of the warp's own with plain adds, the rows j0 and
// then the rows j1 (the groups' rows differ), else with atomicAdd (a
// compare-and-swap loop in shared memory on this card).  Every lane of the
// warp calls it, converged; a lane with nothing to add passes ``act`` false
// and a j0 no other lane holds.
__device__ __forceinline__ void add_lut_rows(double* lut_sum, bool own, int j0, int j1,
                                             bool act, float (&v)[8]) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(kFull, j0);
  const bool lead = act && __ffs(peers) - 1 == lane;
  unsigned rest = lead ? peers & (peers - 1u) : 0u;  // the group's other lanes
  const int most = static_cast<int>(__reduce_max_sync(kFull, __popc(rest)));
  float mine[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) mine[i] = v[i];
  for (int t = 0; t < most; ++t) {
    const int src = rest ? __ffs(rest) - 1 : lane;
    rest &= rest - 1u;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float o = __shfl_sync(kFull, mine[i], src);
      if (src != lane) v[i] += o;
    }
  }
  if (own) {
    if (lead)
#pragma unroll
      for (int c = 0; c < 4; ++c) lut_sum[4 * j0 + c] += static_cast<double>(v[c]);
    __syncwarp();
    if (lead)
#pragma unroll
      for (int c = 0; c < 4; ++c) lut_sum[4 * j1 + c] += static_cast<double>(v[4 + c]);
    __syncwarp();
  } else if (lead) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      atomicAdd(lut_sum + 4 * j0 + c, static_cast<double>(v[c]));
      atomicAdd(lut_sum + 4 * j1 + c, static_cast<double>(v[4 + c]));
    }
  }
}

// The backward: brick blockIdx.y's blocks stride over its hit pairs,
// kBackThreads at a time; a warp's lanes walk their 32 pairs back in step.
__global__ void __launch_bounds__(kBackThreads)
    diffmarch_backward_kernel(Inputs in, Walk walk, const float4* grad, const float* ckpt,
                              float* g_data, double* g_luts, float* g_d0, float* g_dirs,
                              float* g_partial, int lut_copies) {
  // the LUT gradient's float64 sums, a copy a warp (warp % lut_copies), then
  // in pair rows scan_runs' [num_tiles + 1] ints
  extern __shared__ double s_lut[];  // [lut_copies][lut_entries * 4] when g_luts is given
  __shared__ float s_before[kSegment][kBackThreads];  // a segment's opacity before each step
  __shared__ float s_red[kPartials][kBackWarps];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int count = walk_count(walk, b);
  if (static_cast<int>(blockIdx.x) * kBackThreads >= count) return;  // the whole block
  const int lut_floats = g_luts != nullptr ? in.lut_entries * 4 : 0;
  int* s_first = reinterpret_cast<int*>(s_lut + lut_floats * lut_copies);
  for (int i = threadIdx.x; i < lut_floats * lut_copies; i += kBackThreads) s_lut[i] = 0.0;
  if (walk.run_cnt != nullptr) scan_runs(walk, b, s_first);
  __syncthreads();
  double* lut_sum = g_luts != nullptr ? s_lut + (warp % lut_copies) * lut_floats : nullptr;
  const bool lut_private = lut_copies == kBackWarps;  // a copy of the warp's own
  float* g_vol = g_data != nullptr ? g_data + b * in.cells : nullptr;
  const int segments = (in.num_steps + kSegment - 1) / kSegment;
  float part[kPartials];
#pragma unroll
  for (int i = 0; i < kPartials; ++i) part[i] = 0.0f;
  for (int start = blockIdx.x * kBackThreads; start < count;
       start += gridDim.x * kBackThreads) {
    if (start + warp * 32 >= count) continue;  // the warp: no pair in this chunk
    const bool valid = start + static_cast<int>(threadIdx.x) < count;
    int n;
    int64_t pair;
    walk_at(walk, in.num_pixels, b, start + (valid ? static_cast<int>(threadIdx.x) : warp * 32),
            s_first, n, pair);
    const Ray r = load_ray(in, b, n, pair);
    const bool rising = !(r.step < 0.0f);
    float4 lam = valid ? grad[pair] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float gd0 = 0.0f, g_dir[3] = {0.0f, 0.0f, 0.0f};
    for (int seg = segments - 1; seg >= 0; --seg) {
      const int k0 = seg * kSegment;
      const int k1 = min(in.num_steps, k0 + kSegment);
      // a segment that starts past the box, or whose checkpoint is opaque,
      // has no active step
      bool live = valid && !(rising && !(r.d0 + r.step * static_cast<float>(k0) < r.tmax));
      float a = 1.0f;
      if (live) {
        a = ckpt[seg * walk.rows + pair];
        live = a < 1.0f;
      }
      if (!__any_sync(kFull, live)) continue;
      // replay the segment forward: the opacity before each active step
      unsigned active = 0u;
      if (live) {
        for (int k = k0; k < k1; ++k) {
          if (!(a < 1.0f)) break;
          float dist, p[3];
          bool beyond;
          if (!gate(r, static_cast<float>(k), dist, p, beyond)) {
            if (beyond && rising) break;
            continue;
          }
          Sample s;
          sample(in, r, p, s);
          s_before[k - k0][threadIdx.x] = a;
          active |= 1u << (k - k0);
          a = a + s.s.w * (1.0f - a);
        }
      }
      // then walk it backwards, the warp's lanes in step
      for (int k = k1 - 1; k >= k0; --k) {
        const bool act = (active >> (k - k0)) & 1u;
        if (!__any_sync(kFull, act)) continue;
        float g_lut[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        float g_cell[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        // keys no other lane holds, unless the step is active
        int j0 = -1 - lane, j1 = 0, base = -1 - lane, ox = 0, oy = 0, oz = 0;
        if (act) {
          const float kf = static_cast<float>(k);
          float dist, p[3];
          bool beyond;
          gate(r, kf, dist, p, beyond);
          Sample s;
          sample(in, r, p, s);
          adjoint(in, r, s, kf, dist, s_before[k - k0][threadIdx.x], lam, g_lut, g_cell,
                  part, gd0, g_dir);
          j0 = s.j0;
          j1 = s.j1;
          base = s.base;
          ox = s.ox;
          oy = s.oy;
          oz = s.oz;
        }
        __syncwarp();
        if (lut_sum != nullptr) add_lut_rows(lut_sum, lut_private, j0, j1, act, g_lut);
        if (g_vol != nullptr && sum_runs(base, act, g_cell)) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int o = base + (i >> 2) * oz + ((i >> 1) & 1) * oy + (i & 1) * ox;
            if (g_cell[i] != 0.0f) atomicAdd(g_vol + o, g_cell[i]);
          }
        }
      }
    }
    if (valid) {
      g_d0[pair] = gd0;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        if (g_dir[c] != 0.0f) atomicAdd(g_dirs + 3 * n + c, g_dir[c]);
    }
  }
  // the block's sums, a block apart (no atomics: the order is fixed)
#pragma unroll
  for (int i = 0; i < kPartials; ++i) {
    float v = part[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    if (lane == 0) s_red[i][warp] = v;
  }
  __syncthreads();  // also: every warp's LUT adds are in
  if (threadIdx.x < kPartials) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kBackWarps; ++w) v += s_red[threadIdx.x][w];
    g_partial[(static_cast<int64_t>(b) * gridDim.x + blockIdx.x) * kPartials + threadIdx.x] = v;
  }
  // the block's LUT gradient, its copies summed in a fixed order, one
  // atomicAdd an entry
  for (int i = threadIdx.x; i < lut_floats; i += kBackThreads) {
    double v = 0.0;
    for (int c = 0; c < lut_copies; ++c) v += s_lut[c * lut_floats + i];
    if (v != 0.0) atomicAdd(g_luts + static_cast<int64_t>(b) * lut_floats + i, v);
  }
}

Inputs make_inputs(const void* const* p, int num_bricks, int num_pixels, int pad_x,
                   int pad_y, int pad_z, int lut_entries, int num_steps, int flags,
                   float clip_start, float clip_span, float clip_rspan, float clip_end) {
  Inputs in;
  in.data = static_cast<const float*>(p[0]);
  in.luts = static_cast<const float4*>(p[1]);
  in.d0 = static_cast<const float*>(p[2]);
  in.dirs = static_cast<const float*>(p[3]);
  in.eye = static_cast<const float*>(p[4]);
  in.steps = static_cast<const float*>(p[5]);
  in.bmin = static_cast<const float*>(p[6]);
  in.cell = static_cast<const float*>(p[7]);
  in.scalars = static_cast<const float*>(p[8]);
  in.tmax = static_cast<const float*>(p[9]);
  in.hit = static_cast<const uint8_t*>(p[10]);
  in.bmax = static_cast<const float*>(p[11]);
  in.top = static_cast<const int*>(p[12]);
  in.low = static_cast<const int*>(p[13]);
  in.num_bricks = num_bricks;
  in.num_pixels = num_pixels;
  in.pad_y = pad_y;
  in.pad_z = pad_z;
  in.cells = static_cast<int64_t>(pad_x) * pad_y * pad_z;
  in.lut_entries = lut_entries;
  in.num_steps = num_steps;
  in.flags = flags;
  in.clip_start = clip_start;
  in.clip_span = clip_span;
  in.clip_rspan = clip_rspan;
  in.clip_end = clip_end;
  return in;
}

dim3 grid_of(int num_bricks, int num_pixels, int per_block) {
  return dim3((num_pixels + per_block - 1) / per_block, num_bricks);
}

// A march kernel's grid: a row of blocks a brick, at most a block a
// ``per_block`` pixels, about kGridBlocks blocks of kThreads threads in all
dim3 march_grid(int num_bricks, int num_pixels, int per_block) {
  const int most = (num_pixels + per_block - 1) / per_block;
  const int total = kGridBlocks * (kThreads / per_block);
  return dim3(max(1, min(most, (total + num_bricks - 1) / num_bricks)), num_bricks);
}

Tangents make_tangents(const void* const* p) {
  Tangents t;
  t.data = static_cast<const float*>(p[0]);
  t.luts = static_cast<const float4*>(p[1]);
  t.d0 = static_cast<const float*>(p[2]);
  t.dirs = static_cast<const float*>(p[3]);
  t.eye = static_cast<const float*>(p[4]);
  t.steps = static_cast<const float*>(p[5]);
  t.bmin = static_cast<const float*>(p[6]);
  t.cell = static_cast<const float*>(p[7]);
  t.scalars = static_cast<const float*>(p[8]);
  return t;
}

// The tangent instantiation of ``groups`` (1 to kTanAll).
template <int kGroups>
cudaError_t launch_tangent(int groups, cudaStream_t stream, const Inputs& in,
                           const Tangents& t, const Walk& walk, float4* out,
                           float4* out_tangent) {
  if (groups == kGroups) {
    constexpr int kBlock = march_threads(kGroups);
    diffmarch_forward_kernel<kGroups>
        <<<march_grid(in.num_bricks, in.num_pixels, kBlock), kBlock, 0, stream>>>(
            in, t, walk, out, out_tangent, nullptr);
    return cudaGetLastError();
  }
  if constexpr (kGroups < kTanAll)
    return launch_tangent<kGroups + 1>(groups, stream, in, t, walk, out, out_tangent);
  return cudaErrorInvalidValue;
}

// The walk of the dense rows (list, counts) or of the pair rows (the
// others); the checkpoints' stride ``rows``.
Walk make_walk(const void* list, const void* counts, const void* run_off, const void* run_cnt,
               const void* brick_count, const void* pixel, int num_tiles, long long rows) {
  Walk w;
  w.list = static_cast<const int*>(list);
  w.counts = static_cast<const int*>(counts);
  w.run_off = static_cast<const int*>(run_off);
  w.run_cnt = static_cast<const int*>(run_cnt);
  w.brick_count = static_cast<const int*>(brick_count);
  w.pixel = static_cast<const int*>(pixel);
  w.num_tiles = num_tiles;
  w.rows = rows;
  return w;
}

// scan_runs' shared memory in pair rows
size_t walk_shared_bytes(const Walk& w) {
  return w.run_cnt != nullptr ? static_cast<size_t>(w.num_tiles + 1) * sizeof(int) : 0;
}

}  // namespace

// The pair list (``diffmarch_pairs_kernel``): ``counts`` [B] must hold 0.
extern "C" int avr_diffmarch_pairs_launch(const void* hit, void* list, void* counts,
                                          void* zero_out, int num_bricks, int num_pixels,
                                          void* stream) {
  if (num_bricks <= 0 || num_pixels <= 0) return 0;
  diffmarch_pairs_kernel<<<grid_of(num_bricks, num_pixels, kListThreads * kListPixels),
                           kListThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(hit), num_pixels, static_cast<int*>(list),
      static_cast<int*>(counts), static_cast<float4*>(zero_out));
  return static_cast<int>(cudaGetLastError());
}

// The pair list of one view (``diffpairs_build_kernel``): ``total`` and
// ``brick_count`` must hold 0; ``capacity`` pairs fit in the pair buffers.
extern "C" int avr_diffpairs_build_launch(
    const void* eye, const void* dirs, const void* bmin, const void* bmax, const void* eps,
    const void* order, int num_bricks, int num_pixels, int per_thread, long long capacity,
    void* total, void* brick_count, void* pair_brick, void* pair_pixel, void* pair_d0,
    void* pair_tmax, void* fold_index, void* pixel_start, void* pixel_count, void* run_off,
    void* run_cnt, void* stream) {
  if (num_bricks <= 0 || num_pixels <= 0) return 0;
  if (per_thread < 1 || per_thread > kBuildRows) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (num_pixels + per_thread * kBuildThreads - 1) / (per_thread * kBuildThreads);
  const size_t shared = 2 * static_cast<size_t>((num_bricks + 31) / 32) * sizeof(unsigned);
  diffpairs_build_kernel<<<tiles, kBuildThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(eye), static_cast<const float*>(dirs),
      static_cast<const float*>(bmin), static_cast<const float*>(bmax),
      static_cast<const float*>(eps), static_cast<const long long*>(order), num_bricks,
      num_pixels, per_thread, capacity, static_cast<unsigned long long*>(total),
      static_cast<int*>(brick_count), static_cast<int*>(pair_brick), static_cast<int*>(pair_pixel),
      static_cast<float*>(pair_d0), static_cast<float*>(pair_tmax), static_cast<int*>(fold_index),
      static_cast<int*>(pixel_start), static_cast<int*>(pixel_count), static_cast<int*>(run_off),
      static_cast<int*>(run_cnt));
  return static_cast<int>(cudaGetLastError());
}

// The march entry points take the 14 fields of ops/diffmarch.py's
// MarchInputs in order, the walk (the dense list and its counts, or the
// pair rows' runs, counts and pixels, the tile count and the rows), then
// their own buffers, the sizes and flags, and the stream.

extern "C" int avr_diffmarch_forward_launch(
    const void* data, const void* luts, const void* d0, const void* dirs, const void* eye,
    const void* steps, const void* bmin, const void* cell, const void* scalars,
    const void* tmax, const void* hit, const void* bmax, const void* top, const void* low,
    const void* list, const void* counts, const void* run_off, const void* run_cnt,
    const void* brick_count, const void* pixel, int num_tiles, long long rows,
    void* out, void* checkpoints,
    int num_bricks, int num_pixels, int pad_x, int pad_y, int pad_z, int lut_entries,
    int num_steps, int flags, float clip_start, float clip_span, float clip_rspan,
    float clip_end,
    void* stream) {
  const void* ptrs[14] = {data, luts, d0, dirs, eye, steps, bmin,
                          cell, scalars, tmax, hit, bmax, top, low};
  const Inputs in = make_inputs(ptrs, num_bricks, num_pixels, pad_x, pad_y, pad_z,
                                lut_entries, num_steps, flags, clip_start, clip_span,
                                clip_rspan, clip_end);
  if (num_bricks <= 0 || num_pixels <= 0) return 0;
  const Tangents none = {};
  const Walk walk = make_walk(list, counts, run_off, run_cnt, brick_count, pixel, num_tiles, rows);
  diffmarch_forward_kernel<0>
      <<<march_grid(num_bricks, num_pixels, kThreads), kThreads, walk_shared_bytes(walk),
         static_cast<cudaStream_t>(stream)>>>(
          in, none, walk, static_cast<float4*>(out), nullptr, static_cast<float*>(checkpoints));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int avr_diffmarch_tangent_launch(
    const void* data, const void* luts, const void* d0, const void* dirs, const void* eye,
    const void* steps, const void* bmin, const void* cell, const void* scalars,
    const void* tmax, const void* hit, const void* bmax, const void* top, const void* low,
    const void* list, const void* counts,
    const void* data_t, const void* luts_t, const void* d0_t, const void* dirs_t,
    const void* eye_t, const void* steps_t, const void* bmin_t, const void* cell_t,
    const void* scalars_t, void* out, void* out_tangent,
    int num_bricks, int num_pixels, int pad_x, int pad_y, int pad_z, int lut_entries,
    int num_steps, int flags, float clip_start, float clip_span, float clip_rspan,
    float clip_end,
    void* stream) {
  const void* ptrs[14] = {data, luts, d0, dirs, eye, steps, bmin,
                          cell, scalars, tmax, hit, bmax, top, low};
  const Inputs in = make_inputs(ptrs, num_bricks, num_pixels, pad_x, pad_y, pad_z,
                                lut_entries, num_steps, flags, clip_start, clip_span,
                                clip_rspan, clip_end);
  if (num_bricks <= 0 || num_pixels <= 0) return 0;
  const void* tptrs[9] = {data_t, luts_t, d0_t, dirs_t, eye_t, steps_t, bmin_t, cell_t,
                          scalars_t};
  const int groups = (data_t != nullptr ? kTanData : 0) | (luts_t != nullptr ? kTanLut : 0) |
                     (d0_t != nullptr || dirs_t != nullptr || eye_t != nullptr ||
                              steps_t != nullptr || bmin_t != nullptr || cell_t != nullptr
                          ? kTanGeometry
                          : 0) |
                     (scalars_t != nullptr ? kTanScalars : 0);
  const Walk walk = make_walk(list, counts, nullptr, nullptr, nullptr, nullptr, 0,
                             static_cast<long long>(num_bricks) * num_pixels);
  return static_cast<int>(launch_tangent<1>(
      groups, static_cast<cudaStream_t>(stream), in, make_tangents(tptrs), walk,
      static_cast<float4*>(out), static_cast<float4*>(out_tangent)));
}

extern "C" int avr_diffmarch_backward_launch(
    const void* data, const void* luts, const void* d0, const void* dirs, const void* eye,
    const void* steps, const void* bmin, const void* cell, const void* scalars,
    const void* tmax, const void* hit, const void* bmax, const void* top, const void* low,
    const void* list, const void* counts, const void* run_off, const void* run_cnt,
    const void* brick_count, const void* pixel, int num_tiles, long long rows,
    const void* grad, const void* checkpoints,
    void* g_data, void* g_luts, void* g_d0, void* g_dirs, void* g_partial, int blocks,
    int num_bricks, int num_pixels, int pad_x, int pad_y, int pad_z, int lut_entries,
    int num_steps, int flags, float clip_start, float clip_span, float clip_rspan,
    float clip_end,
    void* stream) {
  const void* ptrs[14] = {data, luts, d0, dirs, eye, steps, bmin,
                          cell, scalars, tmax, hit, bmax, top, low};
  const Inputs in = make_inputs(ptrs, num_bricks, num_pixels, pad_x, pad_y, pad_z,
                                lut_entries, num_steps, flags, clip_start, clip_span,
                                clip_rspan, clip_end);
  if (num_bricks <= 0 || num_pixels <= 0 || blocks <= 0) return 0;
  // dynamic shared memory up to what a block may hold, raised once a device
  // (a kernel's attribute is held per device), so that no capture into a
  // CUDA graph meets the call
  constexpr int kMaxDevices = 64;
  static int max_dynamic[kMaxDevices] = {};  // 0: not raised on that device yet
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (max_dynamic[device] == 0) {
    int optin = 0;
    cudaFuncAttributes attr;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, diffmarch_backward_kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(diffmarch_backward_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin - static_cast<int>(attr.sharedSizeBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    max_dynamic[device] = optin - static_cast<int>(attr.sharedSizeBytes);
  }
  // the LUT gradient's copies: one a warp while they fit in kLutCopyBytes
  // and beside the pair rows' scan
  const Walk walk = make_walk(list, counts, run_off, run_cnt, brick_count, pixel, num_tiles, rows);
  const int scan = static_cast<int>(walk_shared_bytes(walk));
  const int lut_bytes = lut_entries * 4 * static_cast<int>(sizeof(double));
  int copies = max(1, min(kBackWarps, kLutCopyBytes / lut_bytes));
  if (g_luts != nullptr && copies * lut_bytes + scan > max_dynamic[device])
    copies = max(1, (max_dynamic[device] - scan) / lut_bytes);
  const int smem = (g_luts != nullptr ? copies * lut_bytes : 0) + scan;
  if (smem > max_dynamic[device]) return static_cast<int>(cudaErrorInvalidValue);
  diffmarch_backward_kernel<<<dim3(blocks, num_bricks), kBackThreads,
                              smem, static_cast<cudaStream_t>(stream)>>>(
      in, walk, static_cast<const float4*>(grad), static_cast<const float*>(checkpoints),
      static_cast<float*>(g_data), static_cast<double*>(g_luts), static_cast<float*>(g_d0),
      static_cast<float*>(g_dirs), static_cast<float*>(g_partial), copies);
  return static_cast<int>(cudaGetLastError());
}
