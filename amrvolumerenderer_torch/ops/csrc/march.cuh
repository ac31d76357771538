// The per-ray slice march shared by the tile-march and slice-march kernels.
//
// One thread owns one pixel of a 32x32 tile.  It builds its ray from the
// camera pack, and ``march_item`` marches one piece over the item's
// occupied slices [s_lo, s_hi) along the piece's permuted march axis,
// returning the piece's layer (colour, entry depth) for that ray.  Each
// thread picks its own slice direction and skips a piece its ray misses:
// the TPU kernels' tile-uniform any_hit / fwd / bwd / mixed dispatch
// (ops/slicemarch.py:475-490) has no counterpart here.
//
// Numerics follow the JAX kernels as XLA compiles them for the CPU in
// interpret mode, so frames match the JAX reference and its golden rows bit
// for bit: samples fold strictly in order; every fused multiply-add is an
// explicit fmaf() at a site where XLA contracts (the build passes
// -fmad=false, so nvcc contracts nothing else); exp is XLA's float32
// polynomial and the ray normalisation XLA's rsqrt, seeded with the x86
// estimate table (ops/numerics.py, passed in as rsqrt_seed).  Divisions are
// IEEE-rounded (no --use_fast_math): a nearest-cell index
// floor((pos - pmin) / cell) flips at a cell boundary otherwise.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace avr {

constexpr int kTileW = 32;
constexpr int kTileP = 1024;   // pixels per tile and cells per stored slice
constexpr int kThreads = 256;  // one 8-row quarter of a tile per block

struct Layer {
  float r, g, b, a, d;
};

__device__ __forceinline__ Layer empty_layer() {
  return Layer{0.0f, 0.0f, 0.0f, 0.0f, INFINITY};
}

// Depth-sorted over blend; ties keep ``top`` in front.
__device__ __forceinline__ Layer blend(const Layer& top, const Layer& bot) {
  const bool top_front = top.d <= bot.d;
  const Layer& f = top_front ? top : bot;
  const Layer& k = top_front ? bot : top;
  const float one_minus = 1.0f - f.a;
  return Layer{fmaf(k.r, one_minus, f.r), fmaf(k.g, one_minus, f.g),
               fmaf(k.b, one_minus, f.b), fmaf(k.a, one_minus, f.a),
               fminf(top.d, bot.d)};
}

// XLA's float32 exp (ops/numerics.py::exp)
__device__ __forceinline__ float xla_expf(float x) {
  x = fminf(fmaxf(x, -0x1.5f3334p+6f), 0x1.633334p+6f);
  const float n =
      fminf(fmaxf(floorf(fmaf(x, 0x1.715476p+0f, 0.5f)), -127.0f), 127.0f);
  float r = fmaf(-0x1.63p-1f, n, x);
  r = fmaf(0x1.bd0106p-13f, n, r);
  float p = fmaf(r, 0x1.a0d2cep-13f, 0x1.6e879cp-10f);
  p = fmaf(p, r, 0x1.111210p-7f);
  p = fmaf(p, r, 0x1.555382p-5f);
  p = fmaf(p, r, 0x1.555554p-3f);
  p = fmaf(p, r, 0.5f);
  const float y = fmaf(p, r * r, r) + 1.0f;
  return y * __int_as_float((static_cast<int>(n) + 127) << 23);
}

// XLA's float32 rsqrt of a positive normal x (ops/numerics.py::rsqrt)
__device__ __forceinline__ float xla_rsqrtf(float x, const int* seed) {
  const int bits = __float_as_int(x);
  const int e = ((bits >> 23) & 0xFF) - 127;
  const int parity = e & 1;
  const int mant = seed[parity * 1024 + ((bits >> 13) & 0x3FF)];
  float y = __int_as_float(((126 - ((e - parity) >> 1)) << 23) | (mant << 11));
  for (int i = 0; i < 2; ++i) y = fmaf(y * -0.5f, fmaf(x * y, y, -1.0f), y);
  return y;
}

__device__ __forceinline__ float pick(const float* v, int p) {
  return p == 0 ? v[0] : (p == 1 ? v[1] : v[2]);
}

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// A stored volume cell as float32: float32 as is, bfloat16 widened
// exactly (the TPU kernel upcasts each bf16 slice the same way,
// ops/tilemarch.py:409-415).
__device__ __forceinline__ float cell_value(const float* p) { return *p; }
__device__ __forceinline__ float cell_value(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// The piece tables a march reads; T is the stored volume's element type
// (float or __nv_bfloat16).
template <typename T>
struct Pieces {
  const T* vol;       // [B, S, 1024] packed slices (row stride dims[6])
  const float* meta;  // [B, 12] pmin(3) pmax(3) cell(3) pad(3), permuted
  const int* dims;    // [B, 8] n_slices nu nv perm(3) nv_stride bounds
  int stored_slices;  // S
  int lut_entries;    // E, entries per LUT channel
  int max_slices;
  int ghost;
};

// One pixel's ray in world space, and the camera's classification terms.
struct Ray {
  float eye[3];
  float dir[3];
  float fwd_dot;  // dir . forward, for the entry depth
  float range_min, inverse_range, ref_distance;
};

// The ray of pixel ``flat`` (row-major in the tile) of frame tile ``tile``.
__device__ __forceinline__ Ray make_ray(const float* cam, int tile,
                                        int tiles_x, int flat, float ndc_sx,
                                        float ndc_sy, const int* rsqrt_seed) {
  Ray ray;
  const float fwd[3] = {cam[3], cam[4], cam[5]};
  const float right[3] = {cam[6], cam[7], cam[8]};
  const float up[3] = {cam[9], cam[10], cam[11]};
  const float tan_half_fov = cam[12];
  const float aspect = cam[13];
  ray.range_min = cam[14];
  ray.inverse_range = cam[15];
  ray.ref_distance = cam[16];
  const float px = static_cast<float>((tile % tiles_x) * kTileW + flat % kTileW);
  const float py = static_cast<float>((tile / tiles_x) * kTileW + flat / kTileW);
  const float ndc_x = fmaf(px + 0.5f, ndc_sx, -1.0f);
  const float ndc_y = fmaf(py + 0.5f, ndc_sy, -1.0f);
  const float plane_x = ndc_x * tan_half_fov * aspect;
  const float plane_y = ndc_y * tan_half_fov;
  for (int i = 0; i < 3; ++i) {
    ray.eye[i] = cam[i];
    ray.dir[i] = fmaf(up[i], plane_y, fmaf(right[i], plane_x, fwd[i]));
  }
  const float len_sq = fmaf(ray.dir[2], ray.dir[2],
                            fmaf(ray.dir[0], ray.dir[0], ray.dir[1] * ray.dir[1]));
  const float inv_len = len_sq > 0.0f ? xla_rsqrtf(len_sq, rsqrt_seed) : 0.0f;
  for (int i = 0; i < 3; ++i) ray.dir[i] = ray.dir[i] * inv_len;
  ray.fwd_dot =
      fmaf(ray.dir[2], fwd[2], fmaf(ray.dir[0], fwd[0], ray.dir[1] * fwd[1]));
  return ray;
}

// LUT entries for one scalar: (r, g, b, log(1 - alpha_ref)).
__device__ __forceinline__ void classify(const float* lut, int entries,
                                         const Ray& ray, float scalar,
                                         float* out) {
  const int table_max = entries - 1;
  const float normalized =
      clamp01((scalar - ray.range_min) * ray.inverse_range);
  const int idx =
      clampi(static_cast<int>(normalized * static_cast<float>(table_max)), 0,
             table_max);
  out[0] = lut[idx];
  out[1] = lut[entries + idx];
  out[2] = lut[2 * entries + idx];
  out[3] = lut[3 * entries + idx];
}

// One piece's layer for this thread's ray.  ``kRolled`` selects how a
// sample joins the accumulator, as XLA contracts each JAX kernel's loop
// body: the slice-march kernel's rolled loop rounds alpha = a * (1 - acc_a)
// before the colour FMAs; the tile-march kernel's (unrolled form) fuses
// (s * a) * (1 - acc_a).  ``lut`` is the [4, E] table of this piece.
template <bool kTrilinear, bool kPre, bool kRolled, typename T>
__device__ Layer march_item(const Pieces<T>& p, const float* lut, int brick,
                            int packed_bounds, const Ray& ray) {
  const float* m = p.meta + static_cast<int64_t>(brick) * 12;
  const int* dm = p.dims + static_cast<int64_t>(brick) * 8;
  const float pmin[3] = {m[0], m[1], m[2]};
  const float pmax[3] = {m[3], m[4], m[5]};
  const float cell[3] = {m[6], m[7], m[8]};
  const int n_slices = dm[0];
  const int nu = dm[1];
  const int nv = dm[2];
  const int nv_stride = dm[6] > 0 ? dm[6] : nv;
  const int s_lo = packed_bounds > 0 ? (packed_bounds >> 16) : 0;
  const int s_hi = packed_bounds > 0 ? (packed_bounds & 0xFFFF) : n_slices;
  const int ghost = p.ghost;

  float eye[3], d[3];
  for (int i = 0; i < 3; ++i) {
    eye[i] = pick(ray.eye, dm[3 + i]);
    d[i] = pick(ray.dir, dm[3 + i]);
  }

  // slab test against the piece's core box
  float tmin = -INFINITY;
  float tmax = INFINITY;
  for (int axis = 0; axis < 3; ++axis) {
    const bool parallel = fabsf(d[axis]) < 1e-8f;
    const float inv = 1.0f / (parallel ? 1.0f : d[axis]);
    const float t1 = (pmin[axis] - eye[axis]) * inv;
    const float t2 = (pmax[axis] - eye[axis]) * inv;
    float lo = fminf(t1, t2);
    float hi = fmaxf(t1, t2);
    if (parallel) {
      const bool inside = eye[axis] >= pmin[axis] && eye[axis] <= pmax[axis];
      lo = inside ? -INFINITY : INFINITY;
      hi = inside ? INFINITY : -INFINITY;
    }
    tmin = fmaxf(tmin, lo);
    tmax = fminf(tmax, hi);
  }
  const bool hit = (tmax >= tmin) && (tmax > 0.0f);
  const float d_a = d[0];
  const bool marchable = fabsf(d_a) > 1e-8f;
  if (!(hit && marchable)) return empty_layer();

  const float inv_da = 1.0f / d_a;
  const bool backward = d_a < 0.0f;
  const float dt = cell[0] * fabsf(inv_da);
  const float t_lo = fmaxf(tmin, 0.0f);
  const float t_hi = tmax;
  const int hi_k = min(s_hi, p.max_slices);
  const int lim = min(s_hi, n_slices);
  const T* vol_b =
      p.vol + static_cast<int64_t>(brick) * p.stored_slices * kTileP;
  const int entries = p.lut_entries;

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_a = 0.0f;
  for (int k = s_lo; k < hi_k; ++k) {
    // backward rays mirror within the occupied range
    const int k_eff = backward ? (s_lo + s_hi - 1 - k) : k;
    const float z_k = fmaf(static_cast<float>(k_eff) + 0.5f, cell[0], pmin[0]);
    const float t_k = (z_k - eye[0]) * inv_da;
    const float pos_u = fmaf(d[1], t_k, eye[1]);
    const float pos_v = fmaf(d[2], t_k, eye[2]);
    // exact quadrature: the overlap of the slice's half-cell window with
    // the ray's clipped interval
    const float w = fmaxf(
        fminf(t_k + 0.5f * dt, t_hi) - fmaxf(t_k - 0.5f * dt, t_lo), 0.0f);
    // an invalid sample has zero alpha and leaves the accumulator as is
    if (!(k < lim && w > 0.0f)) continue;
    const int k_load = min(k, max(s_hi - 1, 0));
    const int k_rev_load =
        clampi(s_lo + s_hi - 1 - k_load, 0, p.max_slices - 1 - ghost);
    const int slice = clampi((backward ? k_rev_load : k_load) + ghost, 0,
                             p.stored_slices - 1);
    const T* sl = vol_b + static_cast<int64_t>(slice) * kTileP;

    float s[4];
    if (!kTrilinear) {
      const float fu = floorf((pos_u - pmin[1]) / cell[1]);
      const float fv = floorf((pos_v - pmin[2]) / cell[2]);
      // clamp in float first: float->int of an out-of-range value is
      // undefined, and the index clips anyway
      const int iu = clampi(static_cast<int>(fminf(fmaxf(fu, -1.0f), 1e9f)),
                            0, nu - 1);
      const int iv = clampi(static_cast<int>(fminf(fmaxf(fv, -1.0f), 1e9f)),
                            0, nv - 1);
      const int flat = (iu + ghost) * nv_stride + (iv + ghost);
      classify(lut, entries, ray, cell_value(sl + clampi(flat, 0, kTileP - 1)),
               s);
    } else {
      // in-slice bilinear with clamp-to-edge over core + ghost ring
      const float g = static_cast<float>(ghost);
      float pu = (pos_u - pmin[1]) / cell[1] - 0.5f;
      float pv = (pos_v - pmin[2]) / cell[2] - 0.5f;
      pu = fminf(fmaxf(pu, -g), static_cast<float>(nu - 1) + g);
      pv = fminf(fmaxf(pv, -g), static_cast<float>(nv - 1) + g);
      const float fu0 = floorf(pu);
      const float fv0 = floorf(pv);
      const float wu = clamp01(pu - fu0);
      const float wv = clamp01(pv - fv0);
      const int iu0 = static_cast<int>(fu0);
      const int iu1 = min(iu0 + 1, nu - 1 + ghost);
      const int iv0 = static_cast<int>(fv0);
      const int iv1 = min(iv0 + 1, nv - 1 + ghost);
      const int fl[4] = {(iu0 + ghost) * nv_stride + (iv0 + ghost),
                         (iu1 + ghost) * nv_stride + (iv0 + ghost),
                         (iu0 + ghost) * nv_stride + (iv1 + ghost),
                         (iu1 + ghost) * nv_stride + (iv1 + ghost)};
      float v[4];
      for (int i = 0; i < 4; ++i) {
        v[i] = cell_value(sl + clampi(fl[i], 0, kTileP - 1));
      }
      if (kPre) {
        // classify each corner, then interpolate the classified channels;
        // opacity interpolates in log-transmittance space, with L = -inf
        // clamped to -1e4 before weighting
        const float wts[4] = {(1.0f - wu) * (1.0f - wv), wu * (1.0f - wv),
                              (1.0f - wu) * wv, wu * wv};
        float c0[4], c1[4];
        classify(lut, entries, ray, v[0], c0);
        classify(lut, entries, ray, v[1], c1);
        c0[3] = fmaxf(c0[3], -1e4f);
        c1[3] = fmaxf(c1[3], -1e4f);
        // c0 * w0 + c1 * w1 contracts its first product
        for (int ch = 0; ch < 4; ++ch) {
          s[ch] = fmaf(c0[ch], wts[0], c1[ch] * wts[1]);
        }
        for (int i = 2; i < 4; ++i) {
          classify(lut, entries, ray, v[i], c0);
          c0[3] = fmaxf(c0[3], -1e4f);
          for (int ch = 0; ch < 4; ++ch) s[ch] = fmaf(c0[ch], wts[i], s[ch]);
        }
      } else {
        const float v0 = fmaf(v[0], 1.0f - wu, v[1] * wu);
        const float v1 = fmaf(v[2], 1.0f - wu, v[3] * wu);
        classify(lut, entries, ray, fmaf(v0, 1.0f - wv, v1 * wv), s);
      }
    }
    // step-normalised opacity: 1 - (1 - a_ref)^(w / ref)
    const float q_k = w / ray.ref_distance;
    const float a = 1.0f - xla_expf(q_k * s[3]);
    const float one_m = 1.0f - acc_a;
    if (kRolled) {
      const float alpha = a * one_m;
      acc_r = fmaf(s[0], alpha, acc_r);
      acc_g = fmaf(s[1], alpha, acc_g);
      acc_b = fmaf(s[2], alpha, acc_b);
    } else {
      acc_r = fmaf(s[0] * a, one_m, acc_r);
      acc_g = fmaf(s[1] * a, one_m, acc_g);
      acc_b = fmaf(s[2] * a, one_m, acc_b);
    }
    acc_a = fmaf(a, one_m, acc_a);
  }
  Layer out{clamp01(acc_r), clamp01(acc_g), clamp01(acc_b), clamp01(acc_a),
            INFINITY};
  const float entry_depth = tmin * ray.fwd_dot;
  if (out.a > 0.0f && isfinite(entry_depth)) out.d = entry_depth;
  return out;
}

}  // namespace avr
