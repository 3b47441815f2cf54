// Site-grouped head GEMM with its bias, forward: a grouped GEMM with a
// gather prologue and a scatter-add epilogue, over detector sites as the
// groups.
//
// Replaces waveformml_tpu/ops/site_head.py:site_grouped_matmul, which XLA
// ran on the TPU as a row gather, one batched einsum over the site groups
// and an event scatter-add, and the bias add that follows it in
// waveformml_tpu/models/blocks.py:FoldedSiteLinear:
//
//   rs[g, m]         = rows[take1[g, m] - 1]                (take1 = 0: empty slot)
//   out[e]           = bias                                 (0 without a bias)
//   out[ev1[g,m]-1] += rs[g, m] @ k3[:, clamp(site1[g] - 1), :]
//                                                           (ev1 = 0 or > n_events: dropped)
//
// Bound on the H100: bytes, and below them a launch's latency. With C = 8
// channels and F = 50 features the work is 2·C·F = 800 FLOP per filled
// slot against ~C·4 bytes of row and 200 bytes of output, far below the
// card's ridge point; a serving chunk (4096 events, ~10200 filled slots of
// 154 × 128) moves ~2 MB, 0.5 µs at 3.35 TB/s, so what a call costs is
// the start of its grids, the chain of dependent steps each block walks
// (indices, then rows, then adds) and the number of read-modify-writes
// that reach L2.
//
// Design:
// * Two grids and no memset. The first writes the bias (or 0) into every
//   event row, padding columns included. The second is a programmatic
//   dependent launch: its blocks load indices, weights and rows while the
//   first still runs, and wait for it (griddepcontrol.wait) only before
//   their first add; a block with nothing to add waits before it exits,
//   so that the second grid always ends after the first.
// * One block per site group. It stages its site's [C, F] weight slice in
//   shared memory once (zero past F), then walks its MAX slots in tiles of
//   THREADS, a slot a thread: each thread gathers its live slot's row as
//   soon as the slot's indices arrive (two 16-byte loads for a row of 8
//   channels where rows are 16-byte aligned), the tile's live slots are
//   listed in slot order (warp ballots), a tile with none is skipped, and
//   the block's threads share the listed slots' outputs out. Empty slots
//   may lie anywhere, rows need not be sorted by event, and a group may
//   share its site with other groups (stitched layouts).
// * Vector reductions: each thread adds 4 consecutive outputs of one slot
//   with one atomicAdd on a float4 (a single 16-byte RED on compute
//   capability 9.x), and consecutive threads take consecutive vectors of a
//   row, so a warp's adds cover a few rows' sectors. That needs every
//   output row 16-byte aligned: the wrapper pads rows to a multiple of 4
//   floats (F = 50 to 52), and any other stride or a misaligned output is
//   refused. On an H100 SXM at 700 W, float2 adds into rows of 50 took
//   ~1.5x the float4 time and scalar adds ~4x.
// * Shapes: a template on (C, F). The serving head (C, F) = (8, 50)
//   has its own instantiation, with no runtime divide in its loops; every
//   other shape runs the same code with C and F given at run time. Where
//   the weight slice and a tile's rows together exceed the block's shared
//   memory (SubMPSD_w128's head, (C, F) = (128, 199): 100 KB of weights
//   and 128 KB of rows), the rows are not staged: each product reads its
//   slot's row from global memory (L1), by the listed row index.
//
// The adds of one event's slots land in an order that varies from run to
// run, so an output that sums m slots (its event's rows at this head, ≤ 4
// at detector multiplicity) and the bias can differ from run to run, and
// from the plain version's fixed order, by ~m ulp of the sum of their
// magnitudes: ~1e-7 relative, far inside a tolerance of 1e-5.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;            // threads of an accumulate block, and slots of a tile
constexpr int WARPS = THREADS / 32;
constexpr int FILL_THREADS = 256;       // threads of a bias block
constexpr int FILL_ROWS = 32;           // event rows of a bias block
constexpr int VEC = 4;                  // floats per store and per add: one float4

// acc += x · p[0, 4), p 16-byte aligned
__device__ __forceinline__ void fma4(float (&acc)[VEC], float x, const float* p) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  acc[0] = fmaf(x, w.x, acc[0]);
  acc[1] = fmaf(x, w.y, acc[1]);
  acc[2] = fmaf(x, w.z, acc[2]);
  acc[3] = fmaf(x, w.w, acc[3]);
}

// out[e, j] = bias[j] for j < f (0 without a bias), 0 for f <= j < ldo;
// block x covers event rows [x·FILL_ROWS, x·FILL_ROWS + FILL_ROWS), a warp
// a row at a time, a lane VEC columns
__global__ void __launch_bounds__(FILL_THREADS)
fill_bias_kernel(const float* __restrict__ bias, float* __restrict__ out, int n_events, int f,
                 int ldo) {
  // the accumulate grid may start now; it waits for this one before adding
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r_end = min(n_events, (blockIdx.x + 1) * FILL_ROWS);
  for (int j = lane * VEC; j < ldo; j += 32 * VEC) {
    float v[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) v[q] = bias != nullptr && j + q < f ? bias[j + q] : 0.f;
    for (int r = blockIdx.x * FILL_ROWS + warp; r < r_end; r += FILL_THREADS / 32)
      *reinterpret_cast<float4*>(out + (int64_t)r * ldo + j) =
          make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Words of the staged weight slice: C rows of FP = ceil(F / VEC)·VEC, so
// that the gathered rows after it are 16-byte aligned.
__host__ __device__ inline int weight_words(int c, int f) {
  return c * ((f + VEC - 1) / VEC * VEC);
}

// Block g owns site group g. CT, FT: C and F at compile time (0: c_rt,
// f_rt at run time). vec_rows: C % 4 == 0 and rows 16-byte aligned.
// stage_rows: the tile's rows are gathered into shared memory (always so
// for a compile-time shape).
template <int CT, int FT>
__global__ void __launch_bounds__(THREADS)
site_grouped_matmul_kernel(const float* __restrict__ rows,
                           const float* __restrict__ k3,
                           const int32_t* __restrict__ take1,
                           const int32_t* __restrict__ ev1,
                           const int32_t* __restrict__ site1,
                           float* __restrict__ out,
                           int c_rt, int s, int f_rt, int ldo, int max_slots, int n_events,
                           int vec_rows, int stage_rows) {
  const int c = CT ? CT : c_rt;
  const int f = FT ? FT : f_rt;
  const bool staged = CT ? true : stage_rows != 0;
  const int fv = (f + VEC - 1) / VEC;     // vectors of an output row
  const int fp = fv * VEC;                // staged weight row, zero past f
  extern __shared__ __align__(16) float smem[];
  float* kg = smem;                                   // [c, fp] this group's weight slice
  float* rs = smem + weight_words(c, f);              // [THREADS, c] the tile's rows, by slot
  __shared__ int slot_s[THREADS];                     // the tile's live slots, listed
  __shared__ int ev_s[THREADS];                       // 0-based event of each listed slot
  __shared__ int take_s[THREADS];                     // 0-based row of each listed slot
  __shared__ int warp_n[WARPS];                       // live slots of each warp's part of a tile

  const int g = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int site = min(max(site1[g] - 1, 0), s - 1);
  for (int i = t; i < c * fp; i += THREADS) {
    const int cc = i / fp, ff = i - cc * fp;
    kg[i] = ff < f ? k3[((int64_t)cc * s + site) * f + ff] : 0.f;
  }

  bool waited = false;
  const int32_t* take_g = take1 + (int64_t)g * max_slots;
  const int32_t* ev_g = ev1 + (int64_t)g * max_slots;
#pragma unroll 1
  for (int m0 = 0; m0 < max_slots; m0 += THREADS) {
    if (m0 > 0) __syncthreads();  // the last tile's readers of rs and the lists are done
    // -- each thread gathers its slot's row; the live slots are listed ---------
    const int slot = m0 + t;
    const int take = slot < max_slots ? take_g[slot] : 0;
    const int ev = slot < max_slots ? ev_g[slot] : 0;
    const bool live = take > 0 && ev > 0 && ev <= n_events;
    if (live && staged) {
      const float* src = rows + (int64_t)(take - 1) * c;
      if (vec_rows) {
        for (int k = 0; k < c / 4; ++k)
          reinterpret_cast<float4*>(rs + t * c)[k] = reinterpret_cast<const float4*>(src)[k];
      } else {
        for (int cc = 0; cc < c; ++cc) rs[t * c + cc] = src[cc];
      }
    }
    const uint32_t b = __ballot_sync(0xffffffffu, live);
    if (lane == 0) warp_n[warp] = __popc(b);
    __syncthreads();              // the weight slice, the rows and warp_n are written
    int base = 0, n = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      base += w < warp ? warp_n[w] : 0;
      n += warp_n[w];
    }
    if (live) {
      const int pos = base + __popc(b & ((1u << lane) - 1u));
      slot_s[pos] = t;
      ev_s[pos] = ev - 1;
      take_s[pos] = take - 1;
    }
    __syncthreads();
    if (n == 0) continue;

    // -- multiply and add into the event rows ---------------------------------
    if (!waited) {
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      waited = true;
    }
    for (int i = t; i < n * fv; i += THREADS) {
      const int m = i / fv;
      const int j = (i - m * fv) * VEC;
      const float* r = staged ? rs + slot_s[m] * c : rows + (int64_t)take_s[m] * c;
      const float* w = kg + j;
      float acc[VEC];
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
#pragma unroll 8
      for (int cc = 0; cc < c; ++cc) fma4(acc, r[cc], w + cc * fp);
      atomicAdd(reinterpret_cast<float4*>(out + (int64_t)ev_s[m] * ldo + j),
                make_float4(acc[0], acc[1], acc[2], acc[3]));
    }
  }
  // a block with nothing to add still waits, so that this grid ends after
  // the bias grid and work after it in the stream sees the whole output
  if (!waited) asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Allow `smem` bytes of dynamic shared memory for kernel `fn`.
template <typename Fn>
cudaError_t allow_smem(Fn* fn, size_t smem, size_t& allowed) {
  if (smem <= allowed || smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err == cudaSuccess) allowed = smem;
  return err;
}

template <int CT, int FT>
int launch(const float* rows, const float* k3, const float* bias, const int32_t* take1,
           const int32_t* ev1, const int32_t* site1, float* out, int groups, int max_slots,
           int c, int s, int f, int ldo, int n_events, cudaStream_t stream) {
  // the event rows: bias, or 0
  fill_bias_kernel<<<(n_events + FILL_ROWS - 1) / FILL_ROWS, FILL_THREADS, 0, stream>>>(
      bias, out, n_events, f, ldo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || groups == 0 || max_slots == 0) return static_cast<int>(err);

  auto* kernel = site_grouped_matmul_kernel<CT, FT>;
  const size_t weight_bytes = sizeof(float) * weight_words(c, f);
  const size_t rows_bytes = sizeof(float) * (size_t)THREADS * c;
  int stage_rows = 1;
  if (CT == 0) {
    // stage a tile's rows only where they fit beside the weight slice and
    // the static lists
    static int optin = 0;
    if (optin == 0) {
      int device = 0;
      err = cudaGetDevice(&device);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const size_t static_bytes = sizeof(int) * (3 * THREADS + WARPS);
    stage_rows = weight_bytes + rows_bytes + static_bytes <= static_cast<size_t>(optin);
  }
  const size_t smem = weight_bytes + (stage_rows ? rows_bytes : 0);
  static size_t allowed = 0;
  err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_rows = c % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  // ... then the slots' products, added into them: a programmatic dependent
  // launch whose blocks wait for the bias grid before their first add
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(groups);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&config, kernel, rows, k3, take1, ev1, site1, out,
                                             c, s, f, ldo, max_slots, n_events, vec_rows,
                                             stage_rows));
}

}  // namespace

extern "C" {

// All pointers are device pointers; bias may be null (then 0). out is
// [n_events, ldo], 16-byte aligned, with ldo >= f a multiple of 4: columns
// [0, f) get the result, the others 0. Launches two grids on `stream` (the
// bias grid alone when there is no slot) and returns the first launch
// error (0 on success) without synchronising.
int site_grouped_matmul_fwd(const float* rows, const float* k3, const float* bias,
                            const int32_t* take1, const int32_t* ev1, const int32_t* site1,
                            float* out, int groups, int max_slots, int c, int s, int f,
                            int ldo, int n_events, void* stream) {
  if (n_events == 0 || f == 0) return 0;
  if (ldo < f || ldo % VEC != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0 || s <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c == 8 && f == 50)
    return launch<8, 50>(rows, k3, bias, take1, ev1, site1, out, groups, max_slots, c, s, f,
                         ldo, n_events, st);
  return launch<0, 0>(rows, k3, bias, take1, ev1, site1, out, groups, max_slots, c, s, f, ldo,
                      n_events, st);
}

// Slots of a tile: an accumulate block lists and adds THREADS slots at a
// time, and skips a tile whose slots are all empty.
int site_grouped_matmul_tile_slots() { return THREADS; }

const char* wf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
