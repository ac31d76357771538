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
// One thread owns one (brick, pixel) pair; a block is 256 consecutive pixels
// of one brick (grid y), so a block's samples read one brick's cells and LUT
// through L1.  A step: the distance d0 + step * k, the position
// fma(dir, dist, eye), the gate (hit, dist < tmax, inside the box, opacity
// below 1), a trilinear sample with eight gathers, the scalar transform (XLA's
// float32 log, ops/numerics.py::_log, op for op), the soft tail, a lerped LUT
// lookup and the over step.  A thread stops only where no later step can be
// active: a distance at or past tmax (distances do not decrease for a step
// >= 0) or an opacity at or above 1.  A step outside the box does not stop
// it (d0 is nudged by mesh_eps, so a later step may be inside).
//
// The forward (kTangent false) writes the raw accumulator [B, P, 4] and, when
// reverse mode will follow, the opacity before steps 0, S, 2S, ... into
// checkpoints [C, B, P] (S = kSegment).  The tangent instantiation carries a
// tangent beside the accumulator: each active step's sample tangent from the
// same intermediates (the data, LUT, ray, box and scalar tangents), then the
// dual over step.
//
// The backward is the exact reverse mode of the recurrence.  For an active
// step, alpha = s.a (1 - A.a), A'.rgb = fma(s.rgb, alpha, A.rgb) and A'.a =
// A.a + alpha; so lam.rgb stays the output cotangent, g_alpha = lam.rgb .
// s.rgb + lam.a, lam.a -= s.a g_alpha, g_s.rgb = lam.rgb alpha and g_s.a =
// g_alpha (1 - A.a).  It divides by no transmittance: each segment of S steps
// is replayed forward from its checkpoint, through the same sample() as the
// forward and in the same rounding, into a local array of the opacities
// before each step, then walked backwards.  So every gate decision is the
// forward's own.  g_s flows back through the LUT lerp (the two rows' gradients
// summed in float64 in shared memory, one brick's LUT a block, flushed with
// one float64 atomicAdd an entry: a LUT entry takes millions of terms at full
// size, beyond what a float32 sum holds to 1e-4), the clips (half the gradient at every tie, as jnp.clip and
// jnp.maximum give), the transform (log's 1 / x), the trilinear weights and
// corners (atomicAdd into the data gradient), the position (direction: an
// atomicAdd a pixel and brick; eye) and the distance (d0: written; step).  The
// per-brick and global sums (step, origin, cell, eye, the five scalars) are
// reduced over the block and written a block apart; ops/diffmarch.py adds
// them.  Atomics add in an order that changes from run to run, so the
// backward is held at 1e-4 of the gradient's scale, not bit for bit.
//
// What bounds it on this card: operations and latency, not bytes.  The
// forward writes 16 B a pair and reads each brick's cells and LUT about once
// from device memory (L1 and L2 serve the rest); a valid sample is about 90
// float32 operations and nine dependent gathers, and the backward does about
// three samples' work a valid sample plus twelve atomics.  What the design
// does about it: a ray stops at the first step that cannot be active again,
// the backward skips every segment whose checkpoint is already opaque or whose
// first distance is past the box, and nothing is stored per step.
//
// Numerics: each FMA site of the plain version is a __fmaf_rn here; the build
// passes -fmad=false, so nothing else contracts, and divisions are IEEE
// (-prec-div).  The forward equals its plain version bit for bit.  (The plain
// version rounds the position once, as here (numerics.fma_once); its other
// sites' fma, a float64 product and sum cast to float32, rounds twice where the
// float64 sum falls exactly halfway between two float32 values; no tested
// scene meets such a sum: see ROADMAP section 3.)  The tangent and the backward's
// derivative arithmetic are float32 in another order than autograd's, and the
// backward's own divisions (g / x, g / cell) are __fdividef: both are held at
// 1e-4 of the gradient's scale.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // pixels per block
constexpr int kSegment = 16;   // steps between two opacity checkpoints
constexpr int kPartials = 15;  // step, origin (3), cell (3), eye (3), scalars (5)

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

struct Tangents {  // the tangents of Inputs' differentiable fields
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
  const float* vol;        // the brick's cells
  const float4* lut;       // the brick's LUT
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
  r.vol = in.data + b * in.cells;
  r.lut = in.luts + static_cast<int64_t>(b) * in.lut_entries;
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
        s.c[(z * 2 + y) * 2 + x] = r.vol[s.base + z * s.oz + y * s.oy + x * s.ox];
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
  s.row0 = r.lut[s.j0];
  s.row1 = r.lut[s.j1];
  s.s.x = lerp(s.row0.x, s.row1.x, s.wl);
  s.s.y = lerp(s.row0.y, s.row1.y, s.wl);
  s.s.z = lerp(s.row0.z, s.row1.z, s.wl);
  s.s.w = lerp(s.row0.w, s.row1.w, s.wl);
}

// The tangent of one sample (forward mode from the sample's intermediates).
__device__ __forceinline__ float4 sample_tangent(const Inputs& in, const Tangents& t,
                                                 const Ray& r, const Sample& s, int b,
                                                 int n, int64_t pair, float kf,
                                                 float dist) {
  const float dist_t = t.d0[pair] + t.steps[b] * kf;
  float w_t[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pos_t = t.dirs[3 * n + a] * dist + r.d[a] * dist_t + t.eye[a];
    const float h_t =
        ((pos_t - t.bmin[3 * b + a]) - (s.rel[a] / r.cell[a]) * t.cell[3 * b + a]) /
        r.cell[a];
    w_t[a] = clip_grad(s.f[a] - static_cast<float>(s.i0[a]), 0.0f, 1.0f) *
             clip_grad(s.h[a], 0.0f, static_cast<float>(r.top[a])) * h_t;
  }
  const float* vol_t = t.data + b * in.cells;
  float cx_t[4], cy_t[2];
#pragma unroll
  for (int zy = 0; zy < 4; ++zy) {
    const int z = zy >> 1, y = zy & 1;
    const int o = s.base + z * s.oz + y * s.oy;
    cx_t[zy] = vol_t[o] * (1.0f - s.w[0]) + vol_t[o + s.ox] * s.w[0] +
               (s.c[zy * 2 + 1] - s.c[zy * 2]) * w_t[0];
  }
#pragma unroll
  for (int z = 0; z < 2; ++z)
    cy_t[z] = cx_t[z * 2] * (1.0f - s.w[1]) + cx_t[z * 2 + 1] * s.w[1] +
              (s.cx[z * 2 + 1] - s.cx[z * 2]) * w_t[1];
  float v_t = cy_t[0] * (1.0f - s.w[2]) + cy_t[1] * s.w[2] + (s.cy[1] - s.cy[0]) * w_t[2];
  if (!s.finite) v_t = 0.0f;
  if (in.flags & kLog) {
    const float floor_t = t.scalars[2];
    const float share = s.value0 < r.pfloor ? 0.0f : (s.value0 == r.pfloor ? 0.5f : 1.0f);
    v_t = s.positive ? share * v_t + (1.0f - share) * floor_t : floor_t;
    v_t = v_t / s.v1;
  }
  if (in.flags & kNormalize)
    v_t = clip_grad(s.q2, 0.0f, 1.0f) *
          ((v_t - t.scalars[3]) * r.ninv + (s.lv - r.nmin) * t.scalars[4]);
  if (in.flags & kClip) v_t = clip_grad(s.value, 0.0f, in.clip_end) * v_t;
  if ((in.flags & kSoft) && s.ins) {
    const float m_t = v_t * in.clip_rspan;
    v_t = (m_t * (1.0f - s.m * s.m) + (1.0f - s.m) * (2.0f * s.m) * m_t) * in.clip_span;
  }
  const float q_t = (v_t - t.scalars[0]) * r.rinv + (s.scalar - r.rmin) * t.scalars[1];
  const float u_t = clip_grad(s.n, 0.0f, 1.0f) * clip_grad(s.q, 0.0f, 1.0f) * q_t *
                    static_cast<float>(in.lut_entries - 1);
  const float wl_t = clip_grad(s.u - static_cast<float>(s.j0), 0.0f, 1.0f) * u_t;
  const float4* lut_t = t.luts + static_cast<int64_t>(b) * in.lut_entries;
  const float4 a0 = lut_t[s.j0], a1 = lut_t[s.j1];
  float4 st;
  st.x = a0.x * (1.0f - s.wl) + a1.x * s.wl + (s.row1.x - s.row0.x) * wl_t;
  st.y = a0.y * (1.0f - s.wl) + a1.y * s.wl + (s.row1.y - s.row0.y) * wl_t;
  st.z = a0.z * (1.0f - s.wl) + a1.z * s.wl + (s.row1.z - s.row0.z) * wl_t;
  st.w = a0.w * (1.0f - s.wl) + a1.w * s.wl + (s.row1.w - s.row0.w) * wl_t;
  return st;
}

template <bool kTangent>
__global__ void __launch_bounds__(kThreads)
    diffmarch_forward_kernel(Inputs in, Tangents t, float4* out, float4* out_tangent,
                             float* ckpt) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (n >= in.num_pixels) return;
  const int64_t pair = static_cast<int64_t>(b) * in.num_pixels + n;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 acc_t = acc;
  if (in.hit[pair]) {
    const Ray r = load_ray(in, b, n, pair);
    const int64_t pairs = static_cast<int64_t>(in.num_bricks) * in.num_pixels;
    const bool rising = !(r.step < 0.0f);  // distances never decrease
    int next = 0;  // the next checkpoint to write
    for (int k = 0; k < in.num_steps; ++k) {
      if (ckpt != nullptr && k == next * kSegment) ckpt[next++ * pairs + pair] = acc.w;
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
        const float4 st = sample_tangent(in, t, r, s, b, n, pair, kf, dist);
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
      for (; next * kSegment < in.num_steps; ++next) ckpt[next * pairs + pair] = acc.w;
  }
  if (out != nullptr) out[pair] = acc;
  if (kTangent) out_tangent[pair] = acc_t;
}

// The reverse of one active step with opacity ``Aa`` before it: updates the
// cotangent ``lam`` and adds the step's gradients.
__device__ __forceinline__ void adjoint(const Inputs& in, const Ray& r, const Sample& s,
                                        float kf, float dist, float Aa, float4& lam,
                                        double* s_lut, float* g_vol, float part[kPartials],
                                        float& g_d0, float g_dir[3]) {
  const float one_minus = 1.0f - Aa;
  const float alpha = s.s.w * one_minus;
  const float g_alpha = lam.x * s.s.x + lam.y * s.s.y + lam.z * s.s.z + lam.w;
  const float4 gs = make_float4(lam.x * alpha, lam.y * alpha, lam.z * alpha,
                                g_alpha * one_minus);
  lam.w = lam.w - s.s.w * g_alpha;
  // the LUT lerp
  if (s_lut != nullptr) {
    const float w0 = 1.0f - s.wl, w1 = s.wl;
    atomicAdd(s_lut + 4 * s.j0 + 0, static_cast<double>(gs.x * w0));
    atomicAdd(s_lut + 4 * s.j0 + 1, static_cast<double>(gs.y * w0));
    atomicAdd(s_lut + 4 * s.j0 + 2, static_cast<double>(gs.z * w0));
    atomicAdd(s_lut + 4 * s.j0 + 3, static_cast<double>(gs.w * w0));
    atomicAdd(s_lut + 4 * s.j1 + 0, static_cast<double>(gs.x * w1));
    atomicAdd(s_lut + 4 * s.j1 + 1, static_cast<double>(gs.y * w1));
    atomicAdd(s_lut + 4 * s.j1 + 2, static_cast<double>(gs.z * w1));
    atomicAdd(s_lut + 4 * s.j1 + 3, static_cast<double>(gs.w * w1));
  }
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
      if (g_vol != nullptr) {
        const int o = s.base + z * s.oz + y * s.oy;
        const float g0 = g_cx * (1.0f - s.w[0]), g1 = g_cx * s.w[0];
        if (g0 != 0.0f) atomicAdd(g_vol + o, g0);
        if (g1 != 0.0f) atomicAdd(g_vol + o + s.ox, g1);
      }
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

__global__ void __launch_bounds__(kThreads)
    diffmarch_backward_kernel(Inputs in, const float4* grad, const float* ckpt,
                              float* g_data, double* g_luts, float* g_d0, float* g_dirs,
                              float* g_partial) {
  extern __shared__ double s_lut[];  // [lut_entries * 4] when g_luts is given
  __shared__ float s_red[kPartials][kThreads / 32];
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  const int lut_floats = g_luts != nullptr ? in.lut_entries * 4 : 0;
  for (int i = threadIdx.x; i < lut_floats; i += kThreads) s_lut[i] = 0.0;
  __syncthreads();
  float part[kPartials];
#pragma unroll
  for (int i = 0; i < kPartials; ++i) part[i] = 0.0f;
  if (n < in.num_pixels) {
    const int64_t pair = static_cast<int64_t>(b) * in.num_pixels + n;
    float gd0 = 0.0f, g_dir[3] = {0.0f, 0.0f, 0.0f};
    if (in.hit[pair]) {
      const Ray r = load_ray(in, b, n, pair);
      const int64_t pairs = static_cast<int64_t>(in.num_bricks) * in.num_pixels;
      const bool rising = !(r.step < 0.0f);
      float* g_vol = g_data != nullptr ? g_data + b * in.cells : nullptr;
      double* lut_sum = g_luts != nullptr ? s_lut : nullptr;
      float4 lam = grad[pair];
      const int segments = (in.num_steps + kSegment - 1) / kSegment;
      for (int seg = segments - 1; seg >= 0; --seg) {
        const int k0 = seg * kSegment;
        const int k1 = min(in.num_steps, k0 + kSegment);
        float a = ckpt[seg * pairs + pair];
        if (!(a < 1.0f)) continue;  // opaque: no step of it is active
        if (rising && !(r.d0 + r.step * static_cast<float>(k0) < r.tmax)) continue;
        // replay the segment forward: the opacity before each active step
        float before[kSegment];
        unsigned active = 0u;
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
          before[k - k0] = a;
          active |= 1u << (k - k0);
          a = a + s.s.w * (1.0f - a);
        }
        // then walk it backwards
        for (int k = k1 - 1; k >= k0; --k) {
          if (!((active >> (k - k0)) & 1u)) continue;
          const float kf = static_cast<float>(k);
          float dist, p[3];
          bool beyond;
          gate(r, kf, dist, p, beyond);
          Sample s;
          sample(in, r, p, s);
          adjoint(in, r, s, kf, dist, before[k - k0], lam, lut_sum, g_vol, part, gd0,
                  g_dir);
        }
      }
    }
    g_d0[pair] = gd0;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      if (g_dir[a] != 0.0f) atomicAdd(g_dirs + 3 * n + a, g_dir[a]);
  }
  // the block's sums, a block apart (no atomics: the order is fixed)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kPartials; ++i) {
    float v = part[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) s_red[i][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < kPartials) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) v += s_red[threadIdx.x][w];
    g_partial[(static_cast<int64_t>(b) * gridDim.x + blockIdx.x) * kPartials + threadIdx.x] = v;
  }
  // the block's LUT gradient, one atomicAdd an entry
  for (int i = threadIdx.x; i < lut_floats; i += kThreads) {
    const double v = s_lut[i];
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

dim3 grid_of(int num_bricks, int num_pixels) {
  return dim3((num_pixels + kThreads - 1) / kThreads, num_bricks);
}

}  // namespace

// The entry points take the 14 fields of ops/diffmarch.py's MarchInputs in
// order, then their own buffers, the sizes and flags, and the stream.

extern "C" int avr_diffmarch_forward_launch(
    const void* data, const void* luts, const void* d0, const void* dirs, const void* eye,
    const void* steps, const void* bmin, const void* cell, const void* scalars,
    const void* tmax, const void* hit, const void* bmax, const void* top, const void* low,
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
  diffmarch_forward_kernel<false>
      <<<grid_of(num_bricks, num_pixels), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          in, none, static_cast<float4*>(out), nullptr, static_cast<float*>(checkpoints));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int avr_diffmarch_tangent_launch(
    const void* data, const void* luts, const void* d0, const void* dirs, const void* eye,
    const void* steps, const void* bmin, const void* cell, const void* scalars,
    const void* tmax, const void* hit, const void* bmax, const void* top, const void* low,
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
  Tangents t;
  t.data = static_cast<const float*>(data_t);
  t.luts = static_cast<const float4*>(luts_t);
  t.d0 = static_cast<const float*>(d0_t);
  t.dirs = static_cast<const float*>(dirs_t);
  t.eye = static_cast<const float*>(eye_t);
  t.steps = static_cast<const float*>(steps_t);
  t.bmin = static_cast<const float*>(bmin_t);
  t.cell = static_cast<const float*>(cell_t);
  t.scalars = static_cast<const float*>(scalars_t);
  diffmarch_forward_kernel<true>
      <<<grid_of(num_bricks, num_pixels), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          in, t, static_cast<float4*>(out), static_cast<float4*>(out_tangent), nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int avr_diffmarch_backward_launch(
    const void* data, const void* luts, const void* d0, const void* dirs, const void* eye,
    const void* steps, const void* bmin, const void* cell, const void* scalars,
    const void* tmax, const void* hit, const void* bmax, const void* top, const void* low,
    const void* grad, const void* checkpoints, void* g_data, void* g_luts, void* g_d0,
    void* g_dirs, void* g_partial,
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
  const int smem = g_luts != nullptr ? lut_entries * 4 * static_cast<int>(sizeof(double)) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        diffmarch_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  diffmarch_backward_kernel<<<grid_of(num_bricks, num_pixels), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const float4*>(grad), static_cast<const float*>(checkpoints),
      static_cast<float*>(g_data), static_cast<double*>(g_luts), static_cast<float*>(g_d0),
      static_cast<float*>(g_dirs), static_cast<float*>(g_partial));
  return static_cast<int>(cudaGetLastError());
}
