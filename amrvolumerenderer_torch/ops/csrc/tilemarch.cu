// Tile-march: slice march + per-owner run composite in one pass, one CUDA
// block per (grid step, 8-row quarter of the step's 32x32 pixel tile).
//
// Replaces the TPU kernel amrvolumerenderer_tpu/ops/tilemarch.py::_kernel
// (single-frame entry, float32 volume).  Each thread owns one pixel: it
// walks the step's CSR work list front to back, marches every item's piece
// (march.cuh) and folds each item's layer into its own registers with the
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
// Numerics: march.cuh (bit-exact with the JAX kernel in interpret mode).

#include "march.cuh"

namespace {

using namespace avr;

struct Params {
  Pieces pieces;
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
  int tiles_x;
  float ndc_sx;           // float32(2 / logical_width)
  float ndc_sy;           // float32(2 / logical_height)
};

template <bool kTrilinear, bool kPre>
__global__ void __launch_bounds__(kThreads) tilemarch_kernel(Params p) {
  const int step = blockIdx.x;
  const int flat = blockIdx.y * kThreads + threadIdx.x;  // pixel in tile
  const Ray ray = make_ray(p.cam, p.tile_ids[step], p.tiles_x, flat,
                           p.ndc_sx, p.ndc_sy, p.rsqrt_seed);
  const int begin = p.offsets[step];
  const int end = p.offsets[step + 1];
  Layer run = empty_layer();
  Layer tot = empty_layer();
  bool have_tot = false;
  for (int w = begin; w < end; ++w) {
    const Layer c = march_item<kTrilinear, kPre, false>(
        p.pieces, p.lut, p.bricks[w], p.ibounds[w], ray);
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
  p.pieces.vol = static_cast<const float*>(vol);
  p.pieces.meta = static_cast<const float*>(meta);
  p.pieces.dims = static_cast<const int*>(dims);
  p.pieces.stored_slices = stored_slices;
  p.pieces.lut_entries = lut_entries;
  p.pieces.max_slices = max_slices;
  p.pieces.ghost = ghost;
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
  p.tiles_x = tiles_x;
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
