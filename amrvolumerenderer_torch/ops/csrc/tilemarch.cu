// Tile-march: slice march + per-owner run composite in one pass, one CUDA
// block per (grid step, 8-row quarter of the step's 32x32 pixel tile).
//
// Replaces the TPU kernel amrvolumerenderer_tpu/ops/tilemarch.py::_kernel
// (single-frame entry, float32 volume).  Each thread owns one pixel: it
// walks the step's CSR work list front to back, marches every item's brick
// over the item's occupied slices [s_lo, s_hi) along the permuted march
// axis, and folds each item's layer into its own registers with the
// same-owner run fold of the JAX kernel (ops/tilemarch.py:569-630).
//
// What bounds it on this card: bytes gathered per sample.  Every valid
// sample reads 1 (nearest) or 4 (bilinear) scattered floats of the packed
// brick slice plus 4 LUT floats, straight from L2/HBM.
// What the design does about that: nothing yet.  It is a plain global
// gather; neighbouring pixels of a warp hit neighbouring cells of one slice,
// so the reads coalesce only as far as the camera lets them.  Staging the
// item's slices in shared memory is work for a later change.
//
// Numerics follow the JAX kernel as XLA compiles it for the CPU in
// interpret mode (unroll = 1), so the frame matches the JAX reference and
// its golden rows bit for bit: samples fold strictly in order; every
// fused multiply-add is an explicit fmaf() at a site where XLA contracts
// (the build passes -fmad=false, so nvcc contracts nothing else); exp is
// XLA's float32 polynomial and the ray normalisation XLA's rsqrt, seeded
// with the x86 estimate table (ops/numerics.py, passed in as rsqrt_seed).
// Divisions are IEEE-rounded (no --use_fast_math): a nearest-cell index
// floor((pos - pmin) / cell) flips at a cell boundary otherwise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileP = 1024;  // pixels per tile and cells per stored slice
constexpr int kThreads = 256;  // one 8-row quarter of a tile per block

struct Params {
  const float* vol;       // [B, S, 1024] packed slices (row stride dims[6])
  const float* meta;      // [B, 12] pmin(3) pmax(3) cell(3) pad(3), permuted
  const int* dims;        // [B, 8] n_slices nu nv perm(3) nv_stride bounds
  const float* lut;       // [4, E] r, g, b, log(1 - alpha)
  const float* cam;       // [20] camera pack
  const int* offsets;     // [G + 1] CSR offsets per grid step
  const int* bricks;      // [W] brick per work item
  const int* owners;      // [W] owner (run key) per work item
  const int* ibounds;     // [W] packed (lo << 16) | hi, 0 = full range
  const int* tile_ids;    // [G] frame tile per grid step
  const int* rsqrt_seed;  // [2, 1024] x86 rsqrt estimate mantissas
  float* out_c;           // [G, 4, 1024]
  float* out_d;           // [G, 1024]
  int stored_slices;      // S
  int lut_entries;        // E
  int tiles_x;
  int max_slices;
  int ghost;
  float ndc_sx;           // float32(2 / logical_width)
  float ndc_sy;           // float32(2 / logical_height)
};

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

// LUT entries for one scalar: (r, g, b, log(1 - alpha_ref)).
__device__ __forceinline__ void classify(const Params& p, float range_min,
                                         float inverse_range, float scalar,
                                         float* out) {
  const int table_max = p.lut_entries - 1;
  const float normalized = clamp01((scalar - range_min) * inverse_range);
  const int idx =
      clampi(static_cast<int>(normalized * static_cast<float>(table_max)), 0,
             table_max);
  out[0] = p.lut[idx];
  out[1] = p.lut[p.lut_entries + idx];
  out[2] = p.lut[2 * p.lut_entries + idx];
  out[3] = p.lut[3 * p.lut_entries + idx];
}

// One work item's layer for this thread's ray.
template <bool kTrilinear, bool kPre>
__device__ Layer march_item(const Params& p, int brick, int packed_bounds,
                            const float* eye_w, const float* d_w,
                            float ray_fwd_dot, float range_min,
                            float inverse_range, float ref_distance) {
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
    eye[i] = pick(eye_w, dm[3 + i]);
    d[i] = pick(d_w, dm[3 + i]);
  }

  // slab test against the brick's core box
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
  const float* vol_b =
      p.vol + static_cast<int64_t>(brick) * p.stored_slices * kTileP;

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_a = 0.0f;
  for (int k = s_lo; k < hi_k; ++k) {
    const int k_eff = backward ? (s_lo + s_hi - 1 - k) : k;
    const float z_k = fmaf(static_cast<float>(k_eff) + 0.5f, cell[0], pmin[0]);
    const float t_k = (z_k - eye[0]) * inv_da;
    const float pos_u = fmaf(d[1], t_k, eye[1]);
    const float pos_v = fmaf(d[2], t_k, eye[2]);
    const float w = fmaxf(
        fminf(t_k + 0.5f * dt, t_hi) - fmaxf(t_k - 0.5f * dt, t_lo), 0.0f);
    // an invalid sample has zero alpha and leaves the accumulator as is
    if (!(k < lim && w > 0.0f)) continue;
    const int k_load = min(k, max(s_hi - 1, 0));
    const int k_rev_load =
        clampi(s_lo + s_hi - 1 - k_load, 0, p.max_slices - 1 - ghost);
    const int slice = clampi((backward ? k_rev_load : k_load) + ghost, 0,
                             p.stored_slices - 1);
    const float* sl = vol_b + static_cast<int64_t>(slice) * kTileP;

    float s_r, s_g, s_b, s_l;
    if (!kTrilinear) {
      const float fu = floorf((pos_u - pmin[1]) / cell[1]);
      const float fv = floorf((pos_v - pmin[2]) / cell[2]);
      const int iu = clampi(static_cast<int>(fu), 0, nu - 1);
      const int iv = clampi(static_cast<int>(fv), 0, nv - 1);
      const int flat = (iu + ghost) * nv_stride + (iv + ghost);
      float c[4];
      classify(p, range_min, inverse_range, sl[clampi(flat, 0, kTileP - 1)],
               c);
      s_r = c[0];
      s_g = c[1];
      s_b = c[2];
      s_l = c[3];
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
      for (int i = 0; i < 4; ++i) v[i] = sl[clampi(fl[i], 0, kTileP - 1)];
      if (kPre) {
        // classify each corner, then interpolate the classified channels;
        // opacity interpolates in log-transmittance space
        const float wts[4] = {(1.0f - wu) * (1.0f - wv), wu * (1.0f - wv),
                              (1.0f - wu) * wv, wu * wv};
        float c0[4], c1[4];
        classify(p, range_min, inverse_range, v[0], c0);
        classify(p, range_min, inverse_range, v[1], c1);
        // c0 * w0 + c1 * w1 contracts its first product
        s_r = fmaf(c0[0], wts[0], c1[0] * wts[1]);
        s_g = fmaf(c0[1], wts[0], c1[1] * wts[1]);
        s_b = fmaf(c0[2], wts[0], c1[2] * wts[1]);
        s_l = fmaf(fmaxf(c0[3], -1e4f), wts[0], fmaxf(c1[3], -1e4f) * wts[1]);
        for (int i = 2; i < 4; ++i) {
          classify(p, range_min, inverse_range, v[i], c0);
          s_r = fmaf(c0[0], wts[i], s_r);
          s_g = fmaf(c0[1], wts[i], s_g);
          s_b = fmaf(c0[2], wts[i], s_b);
          s_l = fmaf(fmaxf(c0[3], -1e4f), wts[i], s_l);
        }
      } else {
        const float v0 = fmaf(v[0], 1.0f - wu, v[1] * wu);
        const float v1 = fmaf(v[2], 1.0f - wu, v[3] * wu);
        float c[4];
        classify(p, range_min, inverse_range, fmaf(v0, 1.0f - wv, v1 * wv), c);
        s_r = c[0];
        s_g = c[1];
        s_b = c[2];
        s_l = c[3];
      }
    }
    const float q_k = w / ref_distance;
    const float a = 1.0f - xla_expf(q_k * s_l);
    const float one_m = 1.0f - acc_a;
    acc_r = fmaf(s_r * a, one_m, acc_r);
    acc_g = fmaf(s_g * a, one_m, acc_g);
    acc_b = fmaf(s_b * a, one_m, acc_b);
    acc_a = fmaf(a, one_m, acc_a);
  }
  Layer out{clamp01(acc_r), clamp01(acc_g), clamp01(acc_b), clamp01(acc_a),
            INFINITY};
  const float entry_depth = tmin * ray_fwd_dot;
  if (out.a > 0.0f && isfinite(entry_depth)) out.d = entry_depth;
  return out;
}

template <bool kTrilinear, bool kPre>
__global__ void __launch_bounds__(kThreads) tilemarch_kernel(Params p) {
  const int step = blockIdx.x;
  const int flat = blockIdx.y * kThreads + threadIdx.x;  // pixel in tile
  const int t = p.tile_ids[step];
  const float* cam = p.cam;
  const float eye_w[3] = {cam[0], cam[1], cam[2]};
  const float fwd[3] = {cam[3], cam[4], cam[5]};
  const float right[3] = {cam[6], cam[7], cam[8]};
  const float up[3] = {cam[9], cam[10], cam[11]};
  const float tan_half_fov = cam[12];
  const float aspect = cam[13];
  const float range_min = cam[14];
  const float inverse_range = cam[15];
  const float ref_distance = cam[16];

  const int tx = t % p.tiles_x;
  const int ty = t / p.tiles_x;
  const float px = static_cast<float>(tx * kTileW + flat % kTileW);
  const float py = static_cast<float>(ty * kTileW + flat / kTileW);
  const float ndc_x = fmaf(px + 0.5f, p.ndc_sx, -1.0f);
  const float ndc_y = fmaf(py + 0.5f, p.ndc_sy, -1.0f);
  const float plane_x = ndc_x * tan_half_fov * aspect;
  const float plane_y = ndc_y * tan_half_fov;
  float d_w[3];
  for (int i = 0; i < 3; ++i) {
    d_w[i] = fmaf(up[i], plane_y, fmaf(right[i], plane_x, fwd[i]));
  }
  const float len_sq =
      fmaf(d_w[2], d_w[2], fmaf(d_w[0], d_w[0], d_w[1] * d_w[1]));
  const float inv_len = len_sq > 0.0f ? xla_rsqrtf(len_sq, p.rsqrt_seed) : 0.0f;
  for (int i = 0; i < 3; ++i) d_w[i] = d_w[i] * inv_len;
  const float ray_fwd_dot =
      fmaf(d_w[2], fwd[2], fmaf(d_w[0], fwd[0], d_w[1] * fwd[1]));

  const int begin = p.offsets[step];
  const int end = p.offsets[step + 1];
  Layer run = empty_layer();
  Layer tot = empty_layer();
  bool have_tot = false;
  for (int w = begin; w < end; ++w) {
    const Layer c = march_item<kTrilinear, kPre>(
        p, p.bricks[w], p.ibounds[w], eye_w, d_w, ray_fwd_dot, range_min,
        inverse_range, ref_distance);
    const bool same_owner = w > begin && p.owners[w] == p.owners[w - 1];
    if (same_owner) {
      run = blend(run, c);
    } else {
      // close the previous owner's run into the running total
      tot = have_tot ? blend(tot, run) : run;
      have_tot = have_tot || w > begin;
      run = c;
    }
  }
  const Layer out = have_tot ? blend(tot, run) : run;
  float* oc = p.out_c + static_cast<int64_t>(step) * 4 * kTileP + flat;
  oc[0] = out.r;
  oc[kTileP] = out.g;
  oc[2 * kTileP] = out.b;
  oc[3 * kTileP] = out.a;
  p.out_d[static_cast<int64_t>(step) * kTileP + flat] = out.d;
}

}  // namespace

extern "C" int avr_tilemarch_launch(
    const void* vol, const void* meta, const void* dims, const void* lut,
    const void* cam, const void* offsets, const void* bricks,
    const void* owners, const void* ibounds, const void* tile_ids,
    const void* rsqrt_seed, void* out_c, void* out_d, int num_steps, int stored_slices,
    int lut_entries, int tiles_x, int max_slices, int ghost, float ndc_sx,
    float ndc_sy, int trilinear, int pre, void* stream) {
  Params p;
  p.vol = static_cast<const float*>(vol);
  p.meta = static_cast<const float*>(meta);
  p.dims = static_cast<const int*>(dims);
  p.lut = static_cast<const float*>(lut);
  p.cam = static_cast<const float*>(cam);
  p.offsets = static_cast<const int*>(offsets);
  p.bricks = static_cast<const int*>(bricks);
  p.owners = static_cast<const int*>(owners);
  p.ibounds = static_cast<const int*>(ibounds);
  p.tile_ids = static_cast<const int*>(tile_ids);
  p.rsqrt_seed = static_cast<const int*>(rsqrt_seed);
  p.out_c = static_cast<float*>(out_c);
  p.out_d = static_cast<float*>(out_d);
  p.stored_slices = stored_slices;
  p.lut_entries = lut_entries;
  p.tiles_x = tiles_x;
  p.max_slices = max_slices;
  p.ghost = ghost;
  p.ndc_sx = ndc_sx;
  p.ndc_sy = ndc_sy;
  if (num_steps <= 0) return 0;
  const dim3 grid(num_steps, kTileP / kThreads);
  const dim3 block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!trilinear) {
    tilemarch_kernel<false, false><<<grid, block, 0, s>>>(p);
  } else if (pre) {
    tilemarch_kernel<true, true><<<grid, block, 0, s>>>(p);
  } else {
    tilemarch_kernel<true, false><<<grid, block, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
