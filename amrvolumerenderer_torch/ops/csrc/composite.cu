// The run-grouped depth-sort fold of composeLayered, in three entries.
//
// Replaces the TPU kernels amrvolumerenderer_tpu/ops/composite.py::_kernel
// (composite_tiles, up to 96 layers in VMEM) and ::_kernel_hbm
// (composite_tiles_hbm, layers streamed by DMA past that) with the tile
// mode, the JAX package's XLA fold compositor.py::_composite_sorted_runs
// (the sharded folds) with the pixel mode, and its XLA loop
// parallel/directsend.py::_preblend_runs_scan (the persistent renderer's
// run pre-blend) with the runs mode.  Both fold the layers in sorted
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
//   * Runs mode (the pixel mode's layout, loop and ring): instead of
//     closing a run into a running total it stores the run in its slot of
//     [rmax, P, 5], through a per-warp staging row so that the store is
//     coalesced like the loads.  Each step's slot and whether it extends
//     the open run are staged with the order.  A run starts from its first
//     layer, never from a zero accumulator, so -0.0 and NaN depths come out
//     as the JAX loop gives them.  With `fill` the block marks the slots
//     its steps touch (a byte a slot, dynamic shared memory) and writes the
//     identity (colour 0, depth +inf) into the others; with `carry` step 0
//     extends the run already stored in its slot, so a stack folded in
//     chunks gives the same chain of blends as one launch.
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
//
// The differentiable fold (fold_diff_forward_kernel and
// fold_diff_backward_kernel) replaces no TPU kernel: JAX differentiates
// diff.py::composite_layers_diff's loop of FMAs with XLA, and the port's
// eager loop (a numerics.fma launch a layer, then _Fma's float64 backward
// op by op: about 110 launches a fold) was the step's largest stage.
// Layers [B, P, 4] (premultiplied RGBA, layer k of the fold is
// colors[order[k]], order a permutation of the B layers read on the device
// and checked by every block), one pixel a thread as a float4, 256 a block,
// the ragged edge masked.
// Bytes bound both: the forward reads the layers once and writes the
// clipped image, and with kKeep each layer's transmittance t_k = 1 - a
// ([B, P]) and the image before the clip; the backward reads the image's
// gradient, the layers, t and the unclipped image, and writes each layer's
// gradient once (no zero fill, no scatter).  The arithmetic is the eager
// chain's, op for op:
//   * forward: t_k = 1 - accum.a rounded, accum = __fmaf_rn(L_k, t_k,
//     accum) from zero, then minimum(maximum(accum, 0), 1) with NaN kept;
//   * backward: the clip's gradient by autograd's rules for minimum, then
//     maximum (half at a tie, 0 beyond, the image's NaN passes g); then back
//     to front g_L_k = g * t_k (+ 0, the zero that index_select's backward
//     adds into, so -0 reads +0), g_t_k = the sum over channels of the
//     exact double products g_c * L_k,c in ReduceOp<double>'s order, rounded
//     once to float, and for k > 0 g.rgb + 0 (the slice's zero rows) and
//     g.a - g_t_k, which is how autograd adds the two paths into accum.

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

__global__ void __launch_bounds__(kFoldThreads) composite_runs_kernel(
    const float* layers, const int* order, const int* slots, float* out,
    int num_layers, int num_pixels, int rmax, int64_t layer_stride, int carry,
    int fill) {
  extern __shared__ unsigned char s_touched[];  // [rmax] with fill
  __shared__ int s_layer[kFoldThreads];
  __shared__ int s_slot[kFoldThreads];
  __shared__ unsigned char s_same[kFoldThreads];  // extends the open run
  __shared__ float s_ring[kFoldWarps][kFoldStages * kWarpFloats];
  __shared__ float s_row[kFoldWarps][kWarpFloats];  // coalesced run stores
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t p0 =
      static_cast<int64_t>(blockIdx.x) * kFoldThreads + warp * 32;
  const int64_t left = num_pixels - p0;
  const int valid =
      static_cast<int>(left < 0 ? 0 : (left < 32 ? left : 32)) * 5;
  const int64_t slot_floats = static_cast<int64_t>(num_pixels) * 5;
  float* ring = s_ring[warp];
  float* row = s_row[warp];
  auto issue = [&](int k) {  // the warp copies layer k's pixels, coalesced
    float* dst = ring + (k % kFoldStages) * kWarpFloats;
    const float* src = layers + s_layer[k] * layer_stride + p0 * 5;
    for (int j = lane; j < valid; j += 32) cp_async4(dst + j, src + j);
  };
  auto store = [&](int slot, const Layer& v) {  // the warp's pixels of a run
    float* mine = row + lane * 5;
    mine[0] = v.r;
    mine[1] = v.g;
    mine[2] = v.b;
    mine[3] = v.a;
    mine[4] = v.d;
    __syncwarp();
    float* dst = out + slot * slot_floats + p0 * 5;
    for (int j = lane; j < valid; j += 32) dst[j] = row[j];
    __syncwarp();
  };
  if (fill) {
    for (int s = threadIdx.x; s < rmax; s += kFoldThreads) s_touched[s] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < num_layers; i += kFoldThreads)
      s_touched[slots[i]] = 1;
    __syncthreads();
  }
  Layer run = empty_layer();
  int prev_slot = 0;
  for (int c0 = 0; c0 < num_layers; c0 += kFoldThreads) {
    const int count = min(kFoldThreads, num_layers - c0);
    if (threadIdx.x < count) {
      const int pos = c0 + threadIdx.x;
      const int slot = slots[pos];
      s_layer[threadIdx.x] = order[pos];
      s_slot[threadIdx.x] = slot;
      s_same[threadIdx.x] = pos > 0 ? slot == slots[pos - 1] : carry != 0;
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
      const int slot = s_slot[k];
      if (s_same[k]) {
        if (c0 + k == 0) {  // carry: the run stored by an earlier launch
          const float* src = out + slot * slot_floats + p0 * 5;
          for (int j = lane; j < valid; j += 32) row[j] = src[j];
          __syncwarp();
          const float* mine = row + lane * 5;
          run = Layer{mine[0], mine[1], mine[2], mine[3], mine[4]};
          __syncwarp();
        }
        run = blend(run, cur);
      } else {
        if (c0 + k > 0) store(prev_slot, run);  // close the open run
        run = cur;
      }
      prev_slot = slot;
    }
    __syncthreads();  // the next chunk reuses s_layer, s_slot and s_same
  }
  if (num_layers > 0) store(prev_slot, run);
  if (fill) {
    for (int s = 0; s < rmax; ++s) {
      if (s_touched[s]) continue;
      float* dst = out + s * slot_floats + p0 * 5;
      for (int j = lane; j < valid; j += 32)
        dst[j] = j % 5 == 4 ? INFINITY : 0.0f;
    }
  }
}

constexpr int kFoldDiffThreads = 256;

// minimum(maximum(x, 0), 1) as torch.maximum / torch.minimum give it on the
// card: a NaN operand comes through
__device__ __forceinline__ float clip01(float x) {
  const float y = x != x ? x : fmaxf(x, 0.0f);
  return y != y ? y : fminf(y, 1.0f);
}

// d clip01(x) / dx applied to g: minimum's backward rule, then maximum's
__device__ __forceinline__ float clip01_grad(float g, float x) {
  const float y = x != x ? x : fmaxf(x, 0.0f);
  g = y == 1.0f ? g * 0.5f : g;
  g = y > 1.0f ? 0.0f : g;
  g = x == 0.0f ? g * 0.5f : g;
  return x < 0.0f ? 0.0f : g;
}

// Each block first checks that order is a permutation of the B layers, in
// a bitmask of B bits in shared memory (fold_order_bytes): an index outside
// [0, B) or one that comes twice stops the kernel (as index_select's device
// assert does) before any thread of the block reads a layer.  The backward
// writes each layer's rows once, so a repeat would leave rows unwritten.
__device__ __forceinline__ void check_fold_order(const long long* order,
                                                 int num_layers) {
  extern __shared__ unsigned seen[];
  for (int w = threadIdx.x; w < (num_layers + 31) / 32; w += blockDim.x)
    seen[w] = 0u;
  __syncthreads();
  for (int k = threadIdx.x; k < num_layers; k += blockDim.x) {
    const long long layer = order[k];
    if (layer < 0 || layer >= num_layers) __trap();
    const unsigned bit = 1u << (layer & 31);
    if (atomicOr(seen + (layer >> 5), bit) & bit) __trap();
  }
  __syncthreads();
}

inline size_t fold_order_bytes(int num_layers) {
  return static_cast<size_t>((num_layers + 31) / 32) * sizeof(unsigned);
}

// the element of pixel p in layer k of the fold (order checked)
__device__ __forceinline__ int64_t fold_row(const long long* order, int k,
                                            int num_pixels, int p) {
  return order[k] * num_pixels + p;
}

template <bool kKeep>
__global__ void __launch_bounds__(kFoldDiffThreads) fold_diff_forward_kernel(
    const float4* __restrict__ colors, const long long* __restrict__ order,
    float4* __restrict__ image, float* __restrict__ trans,
    float4* __restrict__ pre, int num_layers, int num_pixels) {
  check_fold_order(order, num_layers);
  const int p = blockIdx.x * kFoldDiffThreads + threadIdx.x;
  if (p >= num_pixels) return;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
  for (int k = 0; k < num_layers; ++k) {
    const float4 c =
        __ldg(colors + fold_row(order, k, num_pixels, p));
    const float t = __fsub_rn(1.0f, acc.w);
    if (kKeep) trans[static_cast<int64_t>(k) * num_pixels + p] = t;
    acc = make_float4(__fmaf_rn(c.x, t, acc.x), __fmaf_rn(c.y, t, acc.y),
                      __fmaf_rn(c.z, t, acc.z), __fmaf_rn(c.w, t, acc.w));
  }
  if (kKeep) pre[p] = acc;
  image[p] = make_float4(clip01(acc.x), clip01(acc.y), clip01(acc.z),
                         clip01(acc.w));
}

// the sum of the four exact products g_c * l_c in double, in the order of
// PyTorch's CUDA reduction over a row of four (ReduceOp<double> of
// sum_to_size: a lane an element, then shuffles at offsets 2 and 1)
__device__ __forceinline__ float dot4_rn(float4 g, float4 l) {
  const double p0 = __dmul_rn(g.x, l.x), p1 = __dmul_rn(g.y, l.y);
  const double p2 = __dmul_rn(g.z, l.z), p3 = __dmul_rn(g.w, l.w);
  return __double2float_rn(__dadd_rn(__dadd_rn(p0, p2), __dadd_rn(p1, p3)));
}

__global__ void __launch_bounds__(kFoldDiffThreads) fold_diff_backward_kernel(
    const float4* __restrict__ grad_image, const float4* __restrict__ colors,
    const long long* __restrict__ order, const float* __restrict__ trans,
    const float4* __restrict__ pre, float4* __restrict__ grad, int num_layers,
    int num_pixels) {
  check_fold_order(order, num_layers);
  const int p = blockIdx.x * kFoldDiffThreads + threadIdx.x;
  if (p >= num_pixels) return;
  const float4 x = pre[p];
  float4 g = grad_image[p];
  g = make_float4(clip01_grad(g.x, x.x), clip01_grad(g.y, x.y),
                  clip01_grad(g.z, x.z), clip01_grad(g.w, x.w));
#pragma unroll 4
  for (int k = num_layers - 1; k >= 0; --k) {
    const int64_t row = fold_row(order, k, num_pixels, p);
    const float t = trans[static_cast<int64_t>(k) * num_pixels + p];
    grad[row] = make_float4(__fadd_rn(__fmul_rn(g.x, t), 0.0f),
                            __fadd_rn(__fmul_rn(g.y, t), 0.0f),
                            __fadd_rn(__fmul_rn(g.z, t), 0.0f),
                            __fadd_rn(__fmul_rn(g.w, t), 0.0f));
    if (k == 0) break;  // the first layer's transmittance is the constant 1
    const float gt = dot4_rn(g, __ldg(colors + row));
    g = make_float4(__fadd_rn(g.x, 0.0f), __fadd_rn(g.y, 0.0f),
                    __fadd_rn(g.z, 0.0f), __fsub_rn(g.w, gt));
  }
}

// The pair fold (diffpairs_fold_forward_kernel, diffpairs_fold_backward_kernel):
// the differentiable fold of one view's pair list (ops/diffmarch.py's
// Pairs), which holds a row for each (brick, pixel) pair whose ray meets the
// brick and none for a miss.  Pixel p's layers, front first, are the raw
// march rows raw[fold_index[pixel_start[p] + s]] for s below
// pixel_count[p]; each is clipped here (diff.render_layers_diff's clip,
// minimum(maximum(x, 0), 1)) and folded as fold_diff_forward_kernel folds
// a layer.  A miss layer of the dense fold is 0 and fma(0, t, acc) = acc,
// so the image is the dense fold's bit for bit; the backward writes the
// raw rows' gradient (the layer's g * t + 0 through the clip's rule) once
// a pair, and for every layer but a pixel's first the dense fold's g_t
// (a miss's adds only a signed zero, which g * t + 0 turns to +0).
// pixel_count -1 marks a tile whose pairs passed the list's capacity (a
// view captured in a CUDA graph with a smaller list): its pixels come out
// NaN, and their gradient is not written.
template <bool kKeep>
__global__ void __launch_bounds__(kFoldDiffThreads) diffpairs_fold_forward_kernel(
    const float4* __restrict__ raw, const int* __restrict__ fold_index,
    const int* __restrict__ pixel_start, const int* __restrict__ pixel_count,
    float4* __restrict__ image, float* __restrict__ trans, float4* __restrict__ pre,
    int num_pixels) {
  const int p = blockIdx.x * kFoldDiffThreads + threadIdx.x;
  if (p >= num_pixels) return;
  const int count = pixel_count[p];
  if (count < 0) {
    image[p] = make_float4(NAN, NAN, NAN, NAN);
    if (kKeep) pre[p] = image[p];
    return;
  }
  const int start = pixel_start[p];
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int s = 0; s < count; ++s) {
    const float4 r = __ldg(raw + fold_index[start + s]);
    const float4 c = make_float4(clip01(r.x), clip01(r.y), clip01(r.z), clip01(r.w));
    const float t = __fsub_rn(1.0f, acc.w);
    if (kKeep) trans[start + s] = t;
    acc = make_float4(__fmaf_rn(c.x, t, acc.x), __fmaf_rn(c.y, t, acc.y),
                      __fmaf_rn(c.z, t, acc.z), __fmaf_rn(c.w, t, acc.w));
  }
  if (kKeep) pre[p] = acc;
  image[p] = make_float4(clip01(acc.x), clip01(acc.y), clip01(acc.z), clip01(acc.w));
}

__global__ void __launch_bounds__(kFoldDiffThreads) diffpairs_fold_backward_kernel(
    const float4* __restrict__ grad_image, const float4* __restrict__ raw,
    const int* __restrict__ fold_index, const int* __restrict__ pixel_start,
    const int* __restrict__ pixel_count, const float* __restrict__ trans,
    const float4* __restrict__ pre, float4* __restrict__ grad_raw, int num_pixels) {
  const int p = blockIdx.x * kFoldDiffThreads + threadIdx.x;
  if (p >= num_pixels) return;
  const int count = pixel_count[p];
  if (count <= 0) return;
  const int start = pixel_start[p];
  const float4 x = pre[p];
  float4 g = grad_image[p];
  g = make_float4(clip01_grad(g.x, x.x), clip01_grad(g.y, x.y),
                  clip01_grad(g.z, x.z), clip01_grad(g.w, x.w));
  for (int s = count - 1; s >= 0; --s) {
    const int q = fold_index[start + s];
    const float t = trans[start + s];
    const float4 r = __ldg(raw + q);
    grad_raw[q] = make_float4(clip01_grad(__fadd_rn(__fmul_rn(g.x, t), 0.0f), r.x),
                              clip01_grad(__fadd_rn(__fmul_rn(g.y, t), 0.0f), r.y),
                              clip01_grad(__fadd_rn(__fmul_rn(g.z, t), 0.0f), r.z),
                              clip01_grad(__fadd_rn(__fmul_rn(g.w, t), 0.0f), r.w));
    if (s == 0) break;  // the layers in front of it are misses
    const float gt =
        dot4_rn(g, make_float4(clip01(r.x), clip01(r.y), clip01(r.z), clip01(r.w)));
    g = make_float4(__fadd_rn(g.x, 0.0f), __fadd_rn(g.y, 0.0f),
                    __fadd_rn(g.z, 0.0f), __fsub_rn(g.w, gt));
  }
}

}  // namespace

extern "C" int avr_fold_diff_forward_launch(const void* colors,
                                            const void* order, void* image,
                                            void* trans, void* pre,
                                            int num_layers, int num_pixels,
                                            void* stream) {
  if (num_pixels <= 0) return 0;
  const int blocks = (num_pixels + kFoldDiffThreads - 1) / kFoldDiffThreads;
  const auto* c = static_cast<const float4*>(colors);
  const auto* o = static_cast<const long long*>(order);
  auto* out = static_cast<float4*>(image);
  const size_t shared = fold_order_bytes(num_layers);
  auto s = static_cast<cudaStream_t>(stream);
  if (trans != nullptr)
    fold_diff_forward_kernel<true><<<blocks, kFoldDiffThreads, shared, s>>>(
        c, o, out, static_cast<float*>(trans), static_cast<float4*>(pre),
        num_layers, num_pixels);
  else
    fold_diff_forward_kernel<false><<<blocks, kFoldDiffThreads, shared, s>>>(
        c, o, out, nullptr, nullptr, num_layers, num_pixels);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int avr_fold_diff_backward_launch(const void* grad_image,
                                             const void* colors,
                                             const void* order,
                                             const void* trans, const void* pre,
                                             void* grad, int num_layers,
                                             int num_pixels, void* stream) {
  if (num_pixels <= 0) return 0;
  const int blocks = (num_pixels + kFoldDiffThreads - 1) / kFoldDiffThreads;
  fold_diff_backward_kernel<<<blocks, kFoldDiffThreads,
                              fold_order_bytes(num_layers),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(grad_image),
      static_cast<const float4*>(colors), static_cast<const long long*>(order),
      static_cast<const float*>(trans), static_cast<const float4*>(pre),
      static_cast<float4*>(grad), num_layers, num_pixels);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int avr_diffpairs_fold_forward_launch(const void* raw, const void* fold_index,
                                                 const void* pixel_start,
                                                 const void* pixel_count, void* image,
                                                 void* trans, void* pre, int num_pixels,
                                                 void* stream) {
  if (num_pixels <= 0) return 0;
  const int blocks = (num_pixels + kFoldDiffThreads - 1) / kFoldDiffThreads;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const float4*>(raw);
  const auto* fi = static_cast<const int*>(fold_index);
  const auto* ps = static_cast<const int*>(pixel_start);
  const auto* pc = static_cast<const int*>(pixel_count);
  if (trans != nullptr)
    diffpairs_fold_forward_kernel<true><<<blocks, kFoldDiffThreads, 0, s>>>(
        r, fi, ps, pc, static_cast<float4*>(image), static_cast<float*>(trans),
        static_cast<float4*>(pre), num_pixels);
  else
    diffpairs_fold_forward_kernel<false><<<blocks, kFoldDiffThreads, 0, s>>>(
        r, fi, ps, pc, static_cast<float4*>(image), nullptr, nullptr, num_pixels);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int avr_diffpairs_fold_backward_launch(const void* grad_image, const void* raw,
                                                  const void* fold_index,
                                                  const void* pixel_start,
                                                  const void* pixel_count, const void* trans,
                                                  const void* pre, void* grad_raw,
                                                  int num_pixels, void* stream) {
  if (num_pixels <= 0) return 0;
  const int blocks = (num_pixels + kFoldDiffThreads - 1) / kFoldDiffThreads;
  diffpairs_fold_backward_kernel<<<blocks, kFoldDiffThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(grad_image), static_cast<const float4*>(raw),
      static_cast<const int*>(fold_index), static_cast<const int*>(pixel_start),
      static_cast<const int*>(pixel_count), static_cast<const float*>(trans),
      static_cast<const float4*>(pre), static_cast<float4*>(grad_raw), num_pixels);
  return static_cast<int>(cudaGetLastError());
}

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

extern "C" int avr_composite_runs_launch(const void* layers, const void* order,
                                         const void* slots, void* out,
                                         int num_layers, int num_pixels,
                                         int rmax, long long layer_stride,
                                         int carry, int fill, void* stream) {
  if (num_pixels <= 0) return 0;
  const int blocks = (num_pixels + kFoldThreads - 1) / kFoldThreads;
  composite_runs_kernel<<<blocks, kFoldThreads, fill ? rmax : 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(layers), static_cast<const int*>(order),
      static_cast<const int*>(slots), static_cast<float*>(out), num_layers,
      num_pixels, rmax, static_cast<int64_t>(layer_stride), carry, fill);
  return static_cast<int>(cudaGetLastError());
}
