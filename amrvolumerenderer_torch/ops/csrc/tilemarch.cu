// Tile-march: slice march + per-owner run composite in one pass, for F
// frames in one launch.  One CUDA block per (frame, grid step, 8-row
// quarter of the step's 32x32 pixel tile).
//
// Replaces the TPU kernel amrvolumerenderer_tpu/ops/tilemarch.py::_kernel,
// both entries: tilemarch_render (one frame) and tilemarch_render_batch
// (the steps_per_frame branch, :126-148: the frame axis flattened into the
// grid), on a float32 or a bfloat16 volume.  blockIdx.x runs over F * S
// grid steps; step g belongs to frame f = g / S and reads that frame's
// camera pack, CSR offsets, work row and tile ids, and writes its outputs
// frame-major ([F, S, ...]).  A one-frame launch is F = 1.  Each thread owns
// one pixel: it walks the step's work list front to back, marches every
// item's piece (march.cuh) and folds each item's layer into its own
// registers with the same-owner run fold of the JAX kernel
// (ops/tilemarch.py:569-630).  Owner and brick stay two tables here; the
// TPU kernel packs them as (owner << 16) | brick to save scalar memory,
// which compares owners the same way for the owners below 2^15 that
// build_tile_worklist allows.
//
// What bounds it on this card: bytes gathered per sample.  Every valid
// sample reads 1 (nearest) or 4 (bilinear) scattered cells of the packed
// brick slice (4 bytes each, 2 in bfloat16) plus 4 LUT floats, straight
// from L2/HBM.
// What the design does about that: nothing yet.  It is a plain global
// gather; neighbouring pixels of a warp hit neighbouring cells of one slice,
// so the reads coalesce only as far as the camera lets them.  A bfloat16
// volume halves the bytes of each cell read.  Staging the item's slices in
// shared memory is work for a later change.
//
// Numerics: march.cuh (bit-exact with the JAX kernel in interpret mode);
// a bfloat16 cell widens to float32 exactly before it is used.

#include "march.cuh"

namespace {

using namespace avr;

template <typename T>
struct Params {
  Pieces<T> pieces;
  const float* lut;       // [4, E] r, g, b, log(1 - alpha)
  const float* cams;      // [F, 20] camera packs
  const int* offsets;     // [F, S + 1] CSR offsets per grid step
  const int* bricks;      // [F, W] brick per work item
  const int* owners;      // [F, W] owner (run key) per work item
  const int* ibounds;     // [F, W] packed (lo << 16) | hi, 0 = full range
  const int* tile_ids;    // [F, S] frame tile per grid step
  const int* rsqrt_seed;  // [2, 1024] x86 rsqrt estimate mantissas
  float* out_c;           // [F, S, 4, 1024]
  float* out_d;           // [F, S, 1024]
  int steps;              // S, grid steps per frame
  int items;              // W, work-table row length per frame
  int tiles_x;
  float ndc_sx;           // float32(2 / logical_width)
  float ndc_sy;           // float32(2 / logical_height)
};

template <bool kTrilinear, bool kPre, typename T>
__global__ void __launch_bounds__(kThreads) tilemarch_kernel(Params<T> p) {
  const int gstep = blockIdx.x;
  const int f = gstep / p.steps;
  const int step = gstep - f * p.steps;
  const int flat = blockIdx.y * kThreads + threadIdx.x;  // pixel in tile
  const int64_t row = static_cast<int64_t>(f) * p.items;
  const int* offsets = p.offsets + static_cast<int64_t>(f) * (p.steps + 1);
  const int* bricks = p.bricks + row;
  const int* owners = p.owners + row;
  const int* ibounds = p.ibounds + row;
  const Ray ray =
      make_ray(p.cams + static_cast<int64_t>(f) * 20,
               p.tile_ids[static_cast<int64_t>(f) * p.steps + step], p.tiles_x,
               flat, p.ndc_sx, p.ndc_sy, p.rsqrt_seed);
  const int begin = offsets[step];
  const int end = offsets[step + 1];
  Layer run = empty_layer();
  Layer tot = empty_layer();
  bool have_tot = false;
  for (int w = begin; w < end; ++w) {
    const Layer c = march_item<kTrilinear, kPre, false>(
        p.pieces, p.lut, bricks[w], ibounds[w], ray);
    const bool same_owner = w > begin && owners[w] == owners[w - 1];
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
  float* oc = p.out_c + static_cast<int64_t>(gstep) * 4 * kTileP + flat;
  oc[0] = out.r;
  oc[kTileP] = out.g;
  oc[2 * kTileP] = out.b;
  oc[3 * kTileP] = out.a;
  p.out_d[static_cast<int64_t>(gstep) * kTileP + flat] = out.d;
}

template <typename T>
int launch(const void* vol, const void* meta, const void* dims,
           const void* lut, const void* cams, const void* offsets,
           const void* bricks, const void* owners, const void* ibounds,
           const void* tile_ids, const void* rsqrt_seed, void* out_c,
           void* out_d, int num_frames, int steps, int items,
           int stored_slices, int lut_entries, int tiles_x, int max_slices,
           int ghost, float ndc_sx, float ndc_sy, int trilinear, int pre,
           cudaStream_t s) {
  Params<T> p;
  p.pieces.vol = static_cast<const T*>(vol);
  p.pieces.meta = static_cast<const float*>(meta);
  p.pieces.dims = static_cast<const int*>(dims);
  p.pieces.stored_slices = stored_slices;
  p.pieces.lut_entries = lut_entries;
  p.pieces.max_slices = max_slices;
  p.pieces.ghost = ghost;
  p.lut = static_cast<const float*>(lut);
  p.cams = static_cast<const float*>(cams);
  p.offsets = static_cast<const int*>(offsets);
  p.bricks = static_cast<const int*>(bricks);
  p.owners = static_cast<const int*>(owners);
  p.ibounds = static_cast<const int*>(ibounds);
  p.tile_ids = static_cast<const int*>(tile_ids);
  p.rsqrt_seed = static_cast<const int*>(rsqrt_seed);
  p.out_c = static_cast<float*>(out_c);
  p.out_d = static_cast<float*>(out_d);
  p.steps = steps;
  p.items = items;
  p.tiles_x = tiles_x;
  p.ndc_sx = ndc_sx;
  p.ndc_sy = ndc_sy;
  const dim3 grid(num_frames * steps, kTileP / kThreads);
  const dim3 block(kThreads);
  if (!trilinear) {
    tilemarch_kernel<false, false, T><<<grid, block, 0, s>>>(p);
  } else if (pre) {
    tilemarch_kernel<true, true, T><<<grid, block, 0, s>>>(p);
  } else {
    tilemarch_kernel<true, false, T><<<grid, block, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int avr_tilemarch_launch(
    const void* vol, const void* meta, const void* dims, const void* lut,
    const void* cams, const void* offsets, const void* bricks,
    const void* owners, const void* ibounds, const void* tile_ids,
    const void* rsqrt_seed, void* out_c, void* out_d, int num_frames,
    int steps, int items, int stored_slices, int lut_entries, int tiles_x,
    int max_slices, int ghost, float ndc_sx, float ndc_sy, int trilinear,
    int pre, int bf16, void* stream) {
  if (num_frames <= 0 || steps <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(
        vol, meta, dims, lut, cams, offsets, bricks, owners, ibounds,
        tile_ids, rsqrt_seed, out_c, out_d, num_frames, steps, items,
        stored_slices, lut_entries, tiles_x, max_slices, ghost, ndc_sx,
        ndc_sy, trilinear, pre, s);
  }
  return launch<float>(vol, meta, dims, lut, cams, offsets, bricks, owners,
                       ibounds, tile_ids, rsqrt_seed, out_c, out_d,
                       num_frames, steps, items, stored_slices, lut_entries,
                       tiles_x, max_slices, ghost, ndc_sx, ndc_sy, trilinear,
                       pre, s);
}
