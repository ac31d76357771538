// Slice march: one layer per piece, one CUDA block per (piece, 8-row
// quarter of a 32x32 pixel tile), one pixel a thread, in two modes of one
// kernel.
//
// Work-list mode replaces the TPU kernels amrvolumerenderer_tpu/ops/
// slicemarch.py::_kernel_worklist -> _kernel_body, behind
// slicemarch_render_worklist_raw and slicemarch_render_worklist.  Block w
// marches piece bricks[w] over frame tile tiles[w] within its slice band
// bounds[w] (march.cuh, rolled-loop rounding) and writes the piece's
// layer block [b, t] in tile order.  Blocks no item names stay unwritten.
// The host pads the work list by repeating its last item, so two blocks
// may write the same [b, t] block: they compute identical values from
// identical inputs, so the race is benign.
//
// Dense mode replaces ops/slicemarch.py::slicemarch_render ->
// _kernel_dense, the dense march of the multi-device pipelines: blocks
// (t, b, quarter) = blockIdx march piece b over tile t within the piece's
// band dims[b, 7], with no index list, and write the row-major layers
// slicemarch_render returns ([B, H*W] float4 colour, [B, H*W] depth), so
// no untile pass follows.  A padding slot (dims[b, 0] == 0) writes
// background, colour 0 and depth +inf, and reads nothing more; a ray that
// misses its piece writes the same: the TPU kernel's tile-level cull
// (any_hit, ops/slicemarch.py:476-490) is the per-thread early return in
// march_item.
//
// What bounds it on this card: in work-list mode, as the tile-march
// kernel, the latency and issue of each valid sample's dependent chain
// (cell read, LUT reads, IEEE divisions, exp, fold); in dense mode also the
// output bytes: every (piece, tile) block is written, 20 bytes a pixel,
// and most blocks of a frame are background.
// What the design does about that (march.cuh): one block per 8-row quarter
// of a tile, one ray a thread, no barrier; each ray marches only the steps
// its interval reaches.  In dense mode a thread whose ray misses the piece
// writes background at once: one float4 of colour and one depth per
// pixel, coalesced over a warp's row.
//
// Numerics: march.cuh (bit-exact with the JAX kernel in interpret mode).

#include "march.cuh"

namespace {

using namespace avr;

struct Params {
  Pieces<float> pieces;
  const float* lut;       // [B, 4, E] per-piece r, g, b, log(1 - alpha)
  const float* cam;       // [20] camera pack
  const int* bricks;      // [W] piece per work item (work-list mode)
  const int* tiles;       // [W] frame tile per work item (work-list mode)
  const int* bounds;      // [W] packed (lo << 16) | hi, 0 = full range
  const int* rsqrt_seed;  // [2, 1024] x86 rsqrt estimate mantissas
  float* out_c;           // [B, T, 4, 1024], or [B, H*W, 4] dense
  float* out_d;           // [B, T, 1024], or [B, H*W] dense
  int num_tiles;          // T
  int tiles_x;
  float ndc_sx;           // float32(2 / logical_width)
  float ndc_sy;           // float32(2 / logical_height)
};

// Row-major pixel index of tile pixel ``flat`` in a frame tiles_x tiles wide.
__device__ __forceinline__ int64_t frame_pixel(int t, int tiles_x, int flat) {
  const int64_t width = static_cast<int64_t>(tiles_x) * kTileW;
  const int py = (t / tiles_x) * kTileW + flat / kTileW;
  const int px = (t % tiles_x) * kTileW + flat % kTileW;
  return py * width + px;
}

template <bool kTrilinear, bool kPre, bool kDense>
__global__ void __launch_bounds__(kThreads) slicemarch_kernel(Params p) {
  const int w = blockIdx.x;
  const int b = kDense ? blockIdx.y : p.bricks[w];
  const int t = kDense ? blockIdx.x : p.tiles[w];
  const int flat = (kDense ? blockIdx.z : blockIdx.y) * kThreads + threadIdx.x;
  const int* dm = p.pieces.dims + static_cast<int64_t>(b) * 8;
  Layer out = empty_layer();
  if (!kDense || dm[0] != 0) {  // a dense padding slot is background
    const Ray ray = make_ray(p.cam, t, p.tiles_x, flat, p.ndc_sx, p.ndc_sy,
                             p.rsqrt_seed);
    out = march_item<kTrilinear, kPre, true>(
        p.pieces, make_view(p.cam), ray, b, kDense ? dm[7] : p.bounds[w],
        p.lut + static_cast<int64_t>(b) * 4 * p.pieces.lut_entries);
  }
  if (kDense) {
    const int64_t px = static_cast<int64_t>(b) * p.num_tiles * kTileP +
                       frame_pixel(t, p.tiles_x, flat);
    reinterpret_cast<float4*>(p.out_c)[px] =
        make_float4(out.r, out.g, out.b, out.a);
    p.out_d[px] = out.d;
    return;
  }
  const int64_t block = static_cast<int64_t>(b) * p.num_tiles + t;
  float* oc = p.out_c + block * 4 * kTileP + flat;
  oc[0] = out.r;
  oc[kTileP] = out.g;
  oc[2 * kTileP] = out.b;
  oc[3 * kTileP] = out.a;
  p.out_d[block * kTileP + flat] = out.d;
}

template <bool kDense>
int launch(const Params& p, dim3 grid, int trilinear, int pre,
           cudaStream_t s) {
  const dim3 block(kThreads);
  if (!trilinear) {
    slicemarch_kernel<false, false, kDense><<<grid, block, 0, s>>>(p);
  } else if (pre) {
    slicemarch_kernel<true, true, kDense><<<grid, block, 0, s>>>(p);
  } else {
    slicemarch_kernel<true, false, kDense><<<grid, block, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Work-list mode (dense == 0): num_items items over bricks/tiles/bounds.
// Dense mode (dense != 0): num_items is the piece count B, and the grid is
// every (tile, piece) pair; bricks, tiles and bounds are unused.
extern "C" int avr_slicemarch_launch(
    const void* vol, const void* meta, const void* dims, const void* lut,
    const void* cam, const void* bricks, const void* tiles,
    const void* bounds, const void* rsqrt_seed, void* out_c, void* out_d,
    int num_items, int num_tiles, int stored_slices, int lut_entries,
    int tiles_x, int max_slices, int ghost, float ndc_sx, float ndc_sy,
    int trilinear, int pre, int dense, void* stream) {
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
  if (num_items <= 0 || num_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int quarters = kTileP / kThreads;
  if (dense) {
    if (num_items > 65535) return static_cast<int>(cudaErrorInvalidValue);
    return launch<true>(p, dim3(num_tiles, num_items, quarters), trilinear,
                        pre, s);
  }
  return launch<false>(p, dim3(num_items, quarters), trilinear, pre, s);
}
