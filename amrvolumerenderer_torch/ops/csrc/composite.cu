// The run-grouped depth-sort fold of composeLayered, in two entries.
//
// Replaces the TPU kernels amrvolumerenderer_tpu/ops/composite.py::_kernel
// (composite_tiles, up to 96 layers in VMEM) and ::_kernel_hbm
// (composite_tiles_hbm, layers streamed by DMA past that) with the tile
// mode, and the JAX package's XLA fold compositor.py::_composite_sorted_runs
// (the sharded folds) with the pixel mode.  Both fold the layers in sorted
// order: same-owner runs blend first, then the runs into the total, with
// the depth-sort blend (ties keep the top; march.cuh::blend, whose FMA
// sites are the JAX fold's).
//
// What bounds both on this card: bytes.  Each layer block a pixel needs is
// read once (20 bytes a pixel) and the frame written once; the fold is a
// few FMAs per layer.  What the design does about that:
//   * Tile mode (layers [L, T, 4, 8, 128] and [L, T, 8, 128], coverage
//     [L, T]): two blocks per tile of 128 threads, 4 pixels a thread as
//     float4 along a plane row (16-byte copies and stores).  The block
//     stages its tile's order, owners and coverage column once per chunk
//     of 128 sorted positions and compacts them into the list of covered
//     positions with their run ids (ballots and a scan over the warps), so
//     an uncovered block costs neither traffic nor a pass of the fold, and
//     the index chain order -> coverage runs once per block, not once per
//     layer and thread.  Each thread copies its pixels of the next covered
//     layer with cp.async into a ring in shared memory before it blends
//     the current one; it reads back only what it copied itself, so the
//     ring needs no barrier and holds no registers.
//   * Pixel mode (layers [L, P, 5], pixel-major as the sharded pipelines
//     hold them, any stride between layers, order [L]): one thread a
//     pixel, 256 a block, the ragged edge masked.  A warp's 32 pixels are
//     640 contiguous bytes of a layer: the warp copies them with cp.async,
//     4 bytes a lane and 128 contiguous bytes an instruction, into a ring
//     of 4 layers in shared memory, 3 in flight, and each lane reads its
//     own 20 bytes back; the frame goes out the same way.  Order and the
//     same-owner flags are staged in shared memory per chunk of 256
//     layers.  The layer order is an index, so a caller never gathers the
//     stack.
//
// The tile mode's compaction, and when it is exact.  The fold is not
// associative in depth ties: owners A1, B, A2, A3 in sorted order fold as
// blend(blend(T, A1), blend(A2, A3)), while one run A1 A2 A3 would give
// blend(T, blend(blend(A1, A2), A3)).  So uncovered layers must not merge
// runs: each sorted position gets a run id, the count of owner changes up
// to it over all L layers, and a covered entry starts a new run if and
// only if its run id differs from the previous covered entry's.  An
// uncovered layer is background (0, 0, 0, 0, +inf), and blend(x, bg) and
// blend(bg, x) both return x: with x.d <= +inf the front layer is x (or,
// for x.d == +inf, bg in front of x scaled by 1 - 0), and the other side
// adds 0 * (1 - x.a) to each colour and fminf leaves x.d.  So a run that
// skips its uncovered layers folds to the same value, an all-uncovered run
// is background and drops out of the total, and a tile with no covered
// layer writes background.  Precondition: every covered block holds a
// finite alpha and no NaN depth.  Where it holds, the compacted fold
// equals the full one value for value, except that a -0.0 colour the full
// fold would have blended with background (giving +0.0) stays -0.0; the
// two compare equal.  Where a covered depth is NaN the identity breaks
// (blend(x, bg) turns x.d into +inf through fminf, and the comparisons
// change sides): the kernel then folds the covered layers alone, grouped
// by run id, as it always does.  An infinite or NaN alpha makes
// 0 * (1 - a) NaN in the full fold and not in the compacted one.
//
// Numerics: every blend is march.cuh::blend, built with -fmad=false, in the
// order of the plain versions (ops/composite.py), so the kernels equal
// them bit for bit on inputs that meet the precondition.

#include "march.cuh"

namespace {

using namespace avr;

// Tile mode's shape, chosen by measurement on an H100
// (scripts/torch_march_ab.py; PERF.md section 6): kParts blocks per tile,
// kVec pixels a thread (float4), and a ring of kStages covered layers per
// thread in shared memory, kStages - 1 of them in flight.  Two blocks
// with 2 or 3 stages were the only shapes that kept up with the earlier
// one-pixel-a-thread kernel at 128 layers; 3 stages was the faster of the
// two on the main path.
// One, four or eight blocks per tile, 4 or 8 stages, a persistent grid and
// register caps lost at 128 layers.
constexpr int kParts = 2;
constexpr int kStages = 3;
constexpr int kVec = 4;
constexpr int kBlockPixels = kTileP / kParts;
constexpr int kCompThreads = kBlockPixels / kVec;
constexpr int kCompWarps = kCompThreads / 32;
static_assert(kStages * 5 * kCompThreads * 16 <= 48 * 1024,
              "the ring must fit in static shared memory");
// Pixel mode: one pixel a thread, kFoldStages layers per warp in flight.
constexpr int kFoldThreads = 256;
constexpr int kFoldWarps = kFoldThreads / 32;
constexpr int kFoldStages = 4;
constexpr int kWarpFloats = 32 * 5;  // one layer of a warp's 32 pixels

// Asynchronous copies, global to shared memory (sm_80+), 16 or 4 bytes.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(kCompThreads) composite_kernel(
    const float* colors, const float* depths, const int* order,
    const int* owners, const unsigned char* coverage, float* out_c,
    float* out_d, int num_layers, int num_tiles) {
  __shared__ int s_layer[kCompThreads];   // the chunk's covered layers
  __shared__ int s_run[kCompThreads];     // their run ids
  __shared__ int s_count[2][kCompWarps];  // per warp: covered, owner changes
  // [kStages][5 planes][kCompThreads] float4: a thread reads back only the
  // slots it copied itself, so the ring needs no block barrier
  __shared__ float4 s_ring[kStages * 5 * kCompThreads];
  const int t = blockIdx.x / kParts;
  const int pix = (blockIdx.x % kParts) * kBlockPixels + threadIdx.x * kVec;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  auto issue = [&](int k) {  // start copying the k-th covered layer's pixels
    float4* slot = s_ring + (k % kStages) * 5 * kCompThreads + threadIdx.x;
    const int64_t blk = static_cast<int64_t>(s_layer[k]) * num_tiles + t;
    const float* c = colors + blk * 4 * kTileP + pix;
    for (int p = 0; p < 4; ++p)
      cp_async16(slot + p * kCompThreads, c + p * kTileP);
    cp_async16(slot + 4 * kCompThreads, depths + blk * kTileP + pix);
  };
  Layer run[kVec], tot[kVec];
  for (int j = 0; j < kVec; ++j) run[j] = tot[j] = empty_layer();
  bool started = false, have_tot = false;
  int last_run = 0, run_base = 0;
  for (int c0 = 0; c0 < num_layers; c0 += kCompThreads) {
    // stage: this thread's sorted position, compacted over the block
    const int pos = c0 + threadIdx.x;
    const bool in = pos < num_layers;
    const int layer = in ? order[pos] : 0;
    const bool change = in && pos > 0 && owners[pos] != owners[pos - 1];
    const bool cov =
        in && coverage[static_cast<int64_t>(layer) * num_tiles + t] != 0;
    const unsigned cov_bits = __ballot_sync(~0u, cov);
    const unsigned change_bits = __ballot_sync(~0u, change);
    if (lane == 0) {
      s_count[0][warp] = __popc(cov_bits);
      s_count[1][warp] = __popc(change_bits);
    }
    __syncthreads();
    int slot = __popc(cov_bits & below);
    int run_id = run_base + __popc(change_bits & (below | (1u << lane)));
    int count = 0;
    for (int w = 0; w < kCompWarps; ++w) {
      const int n_cov = s_count[0][w], n_change = s_count[1][w];
      if (w < warp) {
        slot += n_cov;
        run_id += n_change;
      }
      count += n_cov;
      run_base += n_change;
    }
    if (cov) {
      s_layer[slot] = layer;
      s_run[slot] = run_id;
    }
    __syncthreads();
    // fold the chunk's covered layers, kStages - 1 ahead in flight (a
    // group is committed every step, empty past the end, so the wait
    // count stays fixed)
    for (int k = 0; k < kStages - 1; ++k) {
      if (k < count) issue(k);
      cp_async_commit();
    }
    for (int k = 0; k < count; ++k) {
      if (k + kStages - 1 < count) issue(k + kStages - 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();  // layer k has landed
      const float4* src =
          s_ring + (k % kStages) * 5 * kCompThreads + threadIdx.x;
      const float4 r = src[0], g = src[kCompThreads], b = src[2 * kCompThreads],
                   a = src[3 * kCompThreads], d = src[4 * kCompThreads];
      const Layer cur[kVec] = {
          Layer{r.x, g.x, b.x, a.x, d.x}, Layer{r.y, g.y, b.y, a.y, d.y},
          Layer{r.z, g.z, b.z, a.z, d.z}, Layer{r.w, g.w, b.w, a.w, d.w}};
      const int rid = s_run[k];
      if (started && rid == last_run) {
        for (int j = 0; j < kVec; ++j) run[j] = blend(run[j], cur[j]);
      } else {
        // close the previous run into the running total
        if (started) {
          for (int j = 0; j < kVec; ++j)
            tot[j] = have_tot ? blend(tot[j], run[j]) : run[j];
          have_tot = true;
        }
        for (int j = 0; j < kVec; ++j) run[j] = cur[j];
        started = true;
      }
      last_run = rid;
    }
    __syncthreads();  // the next chunk reuses s_layer, s_run and s_count
  }
  Layer o[kVec];
  for (int j = 0; j < kVec; ++j)
    o[j] = have_tot ? blend(tot[j], run[j]) : run[j];
  const int64_t tile4 = static_cast<int64_t>(t) * kTileP / 4;  // in float4s
  float4* oc = reinterpret_cast<float4*>(out_c) + 4 * tile4;
  float4* od = reinterpret_cast<float4*>(out_d) + tile4;
  const int q = pix / kVec;
  oc[q] = make_float4(o[0].r, o[1].r, o[2].r, o[3].r);
  oc[q + kTileP / 4] = make_float4(o[0].g, o[1].g, o[2].g, o[3].g);
  oc[q + 2 * kTileP / 4] = make_float4(o[0].b, o[1].b, o[2].b, o[3].b);
  oc[q + 3 * kTileP / 4] = make_float4(o[0].a, o[1].a, o[2].a, o[3].a);
  od[q] = make_float4(o[0].d, o[1].d, o[2].d, o[3].d);
}

__global__ void __launch_bounds__(kFoldThreads) composite_pixels_kernel(
    const float* layers, const int* order, const int* owners, float* out,
    int num_layers, int num_pixels, int64_t layer_stride) {
  __shared__ int s_layer[kFoldThreads];
  __shared__ unsigned char s_same[kFoldThreads];  // same owner as the previous
  // per warp, kFoldStages layers of its 32 pixels (160 floats each)
  __shared__ float s_ring[kFoldWarps][kFoldStages * kWarpFloats];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t p0 =
      static_cast<int64_t>(blockIdx.x) * kFoldThreads + warp * 32;
  // floats of the warp's pixels that exist (the ragged edge is masked)
  const int64_t left = num_pixels - p0;
  const int valid =
      static_cast<int>(left < 0 ? 0 : (left < 32 ? left : 32)) * 5;
  float* ring = s_ring[warp];
  auto issue = [&](int k) {  // the warp copies layer k's pixels, coalesced
    float* dst = ring + (k % kFoldStages) * kWarpFloats;
    const float* src = layers + s_layer[k] * layer_stride + p0 * 5;
    for (int j = lane; j < valid; j += 32) cp_async4(dst + j, src + j);
  };
  Layer run = empty_layer(), tot = empty_layer();
  bool have_tot = false;
  for (int c0 = 0; c0 < num_layers; c0 += kFoldThreads) {
    const int count = min(kFoldThreads, num_layers - c0);
    if (threadIdx.x < count) {
      const int pos = c0 + threadIdx.x;
      s_layer[threadIdx.x] = order[pos];
      s_same[threadIdx.x] = pos > 0 && owners[pos] == owners[pos - 1];
    }
    __syncthreads();
    for (int k = 0; k < kFoldStages - 1; ++k) {
      if (k < count) issue(k);
      cp_async_commit();
    }
    for (int k = 0; k < count; ++k) {
      __syncwarp();  // every lane has read the slot this step refills
      if (k + kFoldStages - 1 < count) issue(k + kFoldStages - 1);
      cp_async_commit();
      cp_async_wait<kFoldStages - 1>();  // this lane's copies of layer k
      __syncwarp();                      // and every other lane's
      const float* v = ring + (k % kFoldStages) * kWarpFloats + lane * 5;
      const Layer cur{v[0], v[1], v[2], v[3], v[4]};
      if (s_same[k]) {
        run = blend(run, cur);
      } else {
        // close the previous owner's run into the running total
        if (c0 + k > 0) {
          tot = have_tot ? blend(tot, run) : run;
          have_tot = true;
        }
        run = cur;
      }
    }
    __syncthreads();  // the next chunk reuses s_layer and s_same
  }
  // write the warp's pixels back through its ring, coalesced
  const Layer o = have_tot ? blend(tot, run) : run;
  float* v = ring + lane * 5;
  v[0] = o.r;
  v[1] = o.g;
  v[2] = o.b;
  v[3] = o.a;
  v[4] = o.d;
  __syncwarp();
  for (int j = lane; j < valid; j += 32) out[p0 * 5 + j] = ring[j];
}

}  // namespace

extern "C" int avr_composite_launch(const void* colors, const void* depths,
                                    const void* order, const void* owners,
                                    const void* coverage, void* out_c,
                                    void* out_d, int num_layers,
                                    int num_tiles, void* stream) {
  if (num_tiles <= 0) return 0;
  composite_kernel<<<num_tiles * kParts, kCompThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(colors), static_cast<const float*>(depths),
      static_cast<const int*>(order), static_cast<const int*>(owners),
      static_cast<const unsigned char*>(coverage), static_cast<float*>(out_c),
      static_cast<float*>(out_d), num_layers, num_tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int avr_composite_pixels_launch(const void* layers,
                                           const void* order,
                                           const void* owners, void* out,
                                           int num_layers, int num_pixels,
                                           long long layer_stride,
                                           void* stream) {
  if (num_pixels <= 0) return 0;
  const int blocks = (num_pixels + kFoldThreads - 1) / kFoldThreads;
  composite_pixels_kernel<<<blocks, kFoldThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(layers), static_cast<const int*>(order),
      static_cast<const int*>(owners), static_cast<float*>(out), num_layers,
      num_pixels, static_cast<int64_t>(layer_stride));
  return static_cast<int>(cudaGetLastError());
}
