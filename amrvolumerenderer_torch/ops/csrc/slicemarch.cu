// Work-list slice march: one layer per piece, one CUDA block per (work
// item, 8-row quarter of the item's 32x32 pixel tile).
//
// Replaces the TPU kernels amrvolumerenderer_tpu/ops/slicemarch.py::
// _kernel_worklist -> _kernel_body, behind slicemarch_render_worklist_raw
// and slicemarch_render_worklist.  Work item w marches piece bricks[w] over
// frame tile tiles[w] within its slice band bounds[w]; each thread owns
// one pixel, marches it (march.cuh, rolled-loop rounding) and writes the
// piece's layer block [b, t].  Blocks no item names stay unwritten.  The
// host pads the work list by repeating its last item, so two blocks may
// write the same [b, t] block: they compute identical values from
// identical inputs, so the race is benign.
//
// It also replaces ops/slicemarch.py::slicemarch_render -> _kernel_dense,
// the dense march of the multi-device pipelines: that wrapper passes the
// full piece-major list of every (piece, tile) pair with each piece's band
// dims[b, 7], so every block is written.  A tile the piece does not touch
// comes out as colour 0 and depth +inf: the TPU kernel's tile-level cull
// (any_hit, ops/slicemarch.py:476-490) is the per-thread early return in
// march_item.  A zero padding slot (dims and meta all 0) has an empty band
// and marches nothing.
//
// What bounds it on this card: bytes gathered per sample, as in the
// tile-march kernel (1 or 4 scattered slice floats plus 4 LUT floats per
// valid sample), plus the layer writes: 20 bytes per pixel per item.
// What the design does about that: nothing yet; it is a plain global
// gather and a coalesced store (thread i writes pixel i of each plane).
//
// Numerics: march.cuh (bit-exact with the JAX kernel in interpret mode).

#include "march.cuh"

namespace {

using namespace avr;

struct Params {
  Pieces<float> pieces;
  const float* lut;       // [B, 4, E] per-piece r, g, b, log(1 - alpha)
  const float* cam;       // [20] camera pack
  const int* bricks;      // [W] piece per work item
  const int* tiles;       // [W] frame tile per work item
  const int* bounds;      // [W] packed (lo << 16) | hi, 0 = full range
  const int* rsqrt_seed;  // [2, 1024] x86 rsqrt estimate mantissas
  float* out_c;           // [B, T, 4, 1024]
  float* out_d;           // [B, T, 1024]
  int num_tiles;          // T
  int tiles_x;
  float ndc_sx;           // float32(2 / logical_width)
  float ndc_sy;           // float32(2 / logical_height)
};

template <bool kTrilinear, bool kPre>
__global__ void __launch_bounds__(kThreads) slicemarch_kernel(Params p) {
  const int w = blockIdx.x;
  const int flat = blockIdx.y * kThreads + threadIdx.x;  // pixel in tile
  const int b = p.bricks[w];
  const int t = p.tiles[w];
  const Ray ray = make_ray(p.cam, t, p.tiles_x, flat, p.ndc_sx, p.ndc_sy,
                           p.rsqrt_seed);
  const float* lut =
      p.lut + static_cast<int64_t>(b) * 4 * p.pieces.lut_entries;
  const Layer out = march_item<kTrilinear, kPre, true>(p.pieces, lut, b,
                                                       p.bounds[w], ray);
  const int64_t block = static_cast<int64_t>(b) * p.num_tiles + t;
  float* oc = p.out_c + block * 4 * kTileP + flat;
  oc[0] = out.r;
  oc[kTileP] = out.g;
  oc[2 * kTileP] = out.b;
  oc[3 * kTileP] = out.a;
  p.out_d[block * kTileP + flat] = out.d;
}

}  // namespace

extern "C" int avr_slicemarch_launch(
    const void* vol, const void* meta, const void* dims, const void* lut,
    const void* cam, const void* bricks, const void* tiles,
    const void* bounds, const void* rsqrt_seed, void* out_c, void* out_d,
    int num_items, int num_tiles, int stored_slices, int lut_entries,
    int tiles_x, int max_slices, int ghost, float ndc_sx, float ndc_sy,
    int trilinear, int pre, void* stream) {
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
  p.bricks = static_cast<const int*>(bricks);
  p.tiles = static_cast<const int*>(tiles);
  p.bounds = static_cast<const int*>(bounds);
  p.rsqrt_seed = static_cast<const int*>(rsqrt_seed);
  p.out_c = static_cast<float*>(out_c);
  p.out_d = static_cast<float*>(out_d);
  p.num_tiles = num_tiles;
  p.tiles_x = tiles_x;
  p.ndc_sx = ndc_sx;
  p.ndc_sy = ndc_sy;
  if (num_items <= 0) return 0;
  const dim3 grid(num_items, kTileP / kThreads);
  const dim3 block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!trilinear) {
    slicemarch_kernel<false, false><<<grid, block, 0, s>>>(p);
  } else if (pre) {
    slicemarch_kernel<true, true><<<grid, block, 0, s>>>(p);
  } else {
    slicemarch_kernel<true, false><<<grid, block, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
