// Tile composite: fold every piece layer of a tile in blend order, one
// CUDA block per (tile, 8-row quarter of the tile's 32x32 pixels).
//
// Replaces the TPU kernels amrvolumerenderer_tpu/ops/composite.py::_kernel
// (composite_tiles, up to 96 layers in VMEM) and ::_kernel_hbm
// (composite_tiles_hbm, layers streamed by DMA past that).  A thread owns
// one pixel and keeps only its run and total in registers, so one kernel
// serves any layer count.  For layer i it reads piece order[i]'s block
// only where coverage[order[i], t] is set; elsewhere the layer is
// background (0, 0, 0, 0, +inf) and nothing is read, so an unwritten block
// never reaches a pixel.  The fold is composeLayered's: same-owner runs
// blend first, then the runs, with the depth-sort blend (ties keep the
// top; march.cuh::blend, whose FMA sites are the JAX kernel's).
//
// What bounds it on this card: bytes.  Each covered layer block is read
// once (20 bytes per pixel) and the frame written once; the fold is a few
// FMAs per layer.  What the design does about that: each warp reads 32
// consecutive floats of a plane (coalesced), and uncovered blocks cost no
// traffic.

#include "march.cuh"

namespace {

using namespace avr;

__global__ void __launch_bounds__(kThreads) composite_kernel(
    const float* colors, const float* depths, const int* order,
    const int* owners, const unsigned char* coverage, float* out_c,
    float* out_d, int num_layers, int num_tiles) {
  const int t = blockIdx.x;
  const int flat = blockIdx.y * kThreads + threadIdx.x;  // pixel in tile
  Layer run = empty_layer();
  Layer tot = empty_layer();
  bool have_tot = false;
  for (int i = 0; i < num_layers; ++i) {
    const int b = order[i];
    const int64_t block = static_cast<int64_t>(b) * num_tiles + t;
    Layer c = empty_layer();
    if (coverage[block]) {
      const float* src = colors + block * 4 * kTileP + flat;
      c = Layer{src[0], src[kTileP], src[2 * kTileP], src[3 * kTileP],
                depths[block * kTileP + flat]};
    }
    if (i > 0 && owners[i] == owners[i - 1]) {
      run = blend(run, c);
    } else {
      // close the previous owner's run into the running total
      tot = have_tot ? blend(tot, run) : run;
      have_tot = have_tot || i > 0;
      run = c;
    }
  }
  const Layer out = have_tot ? blend(tot, run) : run;
  float* oc = out_c + static_cast<int64_t>(t) * 4 * kTileP + flat;
  oc[0] = out.r;
  oc[kTileP] = out.g;
  oc[2 * kTileP] = out.b;
  oc[3 * kTileP] = out.a;
  out_d[static_cast<int64_t>(t) * kTileP + flat] = out.d;
}

}  // namespace

extern "C" int avr_composite_launch(const void* colors, const void* depths,
                                    const void* order, const void* owners,
                                    const void* coverage, void* out_c,
                                    void* out_d, int num_layers,
                                    int num_tiles, void* stream) {
  if (num_tiles <= 0) return 0;
  const dim3 grid(num_tiles, kTileP / kThreads);
  const dim3 block(kThreads);
  composite_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(colors), static_cast<const float*>(depths),
      static_cast<const int*>(order), static_cast<const int*>(owners),
      static_cast<const unsigned char*>(coverage), static_cast<float*>(out_c),
      static_cast<float*>(out_d), num_layers, num_tiles);
  return static_cast<int>(cudaGetLastError());
}
