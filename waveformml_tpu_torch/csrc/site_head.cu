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
// Bound on the H100: at the serving head, (C, F) = (8, 50), bytes, and
// below them a launch's latency: the work is 2·C·F = 800 FLOP per filled
// slot against ~C·4 bytes of row and 200 bytes of output, far below the
// card's ridge point; a serving chunk (4096 events, ~10200 filled slots of
// 154 × 128) moves ~2 MB, 0.5 µs at 3.35 TB/s, so what a call costs is
// the start of its grids, the chain of dependent steps each block walks
// (indices, then rows, then adds) and the number of read-modify-writes
// that reach L2. At SubMPSD_w128's head, (C, F) = (128, 199), bytes again
// once the products run on the tensor cores: ~24 MB (the weights are 16 MB
// of it), 7 µs, against 3 x 2·C·F FLOP a live slot in three TF32 passes,
// ~1.6·10^9 a chunk, 3 µs at 495 TFLOP/s (8 µs in fp32 at 67 TFLOP/s).
//
// Design:
// * Two grids and no memset. The first writes the bias (or 0) into every
//   event row, padding columns included. The second is a programmatic
//   dependent launch: its blocks load indices, weights and rows while the
//   first still runs, and wait for it (griddepcontrol.wait) only before
//   their first add; a block with nothing to add waits before it exits,
//   so that the second grid always ends after the first.
// * At the serving head (8, 50), an instantiation of its own (no runtime
//   divide in its loops): one block per site group. It stages its site's
//   [C, F] weight slice in shared memory once (zero past F), then walks its
//   MAX slots in tiles of THREADS, a slot a thread: each thread gathers its
//   live slot's row as soon as the slot's indices arrive (two 16-byte loads
//   for a row of 8 channels where rows are 16-byte aligned), the tile's live
//   slots are listed in slot order (warp ballots), a tile with none is
//   skipped, and the block's threads share the listed slots' outputs out.
// * At every other (C, F), wide heads such as SubMPSD_w128's: one block per
//   (group, 64-column tile of F), 616 blocks of ~71 KB at (128, 199), three
//   to an SM (the group grid staged the [C, F] slice, 100 KB, and read each
//   slot's row from L1 for every 4 outputs). A block stages its [C, 64]
//   weight tile once, lists its group's live slots 256 at a time and
//   streams their rows through shared memory KR = 32 at a time,
//   double-buffered by cp.async (the next chunk loads while this one
//   multiplies). The products run on the tensor cores as K5's wide grid's
//   do (mma.sync.m16n8k8 TF32, 3-pass split: M = the chunk's slots, N =
//   the tile's columns, a warp a 16 x 16 tile, K = C); staged rows lie 4
//   mod 8 words apart and weight rows 8 mod 32, so that fragment loads hit
//   32 banks. Lanes tig and tig ^ 1 trade half their sums (a warp shuffle),
//   so that each holds 4 consecutive columns of one slot for a float4 RED.
//   Register tiles of fp32 FMA (2 slots x 4 columns a thread, float4
//   reads) came first and took 0.049 ms at (128, 199) on an H100 SXM at
//   700 W, against 0.040 for this grid, most of whose time is each block's
//   weight-tile load before its first product.
// * Empty slots may lie anywhere, rows need not be sorted by event, and a
//   group may share its site with other groups (stitched layouts).
// * Vector reductions: each thread adds 4 consecutive outputs of one slot
//   with one atomicAdd on a float4 (a single 16-byte RED on compute
//   capability 9.x), and consecutive threads take consecutive vectors of a
//   row, so a warp's adds cover a few rows' sectors. That needs every
//   output row 16-byte aligned: the wrapper pads rows to a multiple of 4
//   floats (F = 50 to 52), and any other stride or a misaligned output is
//   refused. On an H100 SXM at 700 W, float2 adds into rows of 50 took
//   ~1.5x the float4 time and scalar adds ~4x.
//
// The adds of one event's slots land in an order that varies from run to
// run, so an output that sums m slots (its event's rows at this head, ≤ 4
// at detector multiplicity) and the bias can differ from run to run, and
// from the plain version's fixed order, by ~m ulp of the sum of their
// magnitudes: ~1e-7 relative, far inside a tolerance of 1e-5.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_cache.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int THREADS = 256;            // threads of an accumulate block, and slots of a tile
constexpr int WARPS = THREADS / 32;
constexpr int FILL_THREADS = 256;       // threads of a bias block
constexpr int FILL_ROWS = 32;           // event rows of a bias block
constexpr int VEC = 4;                  // floats per store and per add: one float4
// the tiled grid: output columns of a block, slots of a chunk, and the row
// stride (words) of the staged weight tile (≡ 8 mod 32, so that an mma
// fragment's 4 channels x 8 columns hit 32 banks)
constexpr int FT = 64;
constexpr int KR = 32;
constexpr int FTS = FT + 8;

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

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

// Lists a tile's live slots, each thread's `live` given, in slot order:
// (position in the list or -1, count). Called by every thread.
__device__ __forceinline__ int2 list_live(bool live, int* warp_n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t b = __ballot_sync(0xffffffffu, live);
  if (lane == 0) warp_n[warp] = __popc(b);
  __syncthreads();
  int base = 0, n = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    base += w < warp ? warp_n[w] : 0;
    n += warp_n[w];
  }
  return make_int2(live ? base + __popc(b & ((1u << lane) - 1u)) : -1, n);
}

// Words of the staged weight slice at the serving head: C rows of FP =
// ceil(F / VEC)·VEC, so that the gathered rows after it are 16-byte aligned.
__host__ __device__ inline int weight_words(int c, int f) {
  return c * ((f + VEC - 1) / VEC * VEC);
}

// Block g owns site group g, at the head (C, F). vec_rows: rows are 16-byte
// aligned (C % 4 == 0).
template <int C, int F>
__global__ void __launch_bounds__(THREADS)
site_grouped_matmul_kernel(const float* __restrict__ rows,
                           const float* __restrict__ k3,
                           const int32_t* __restrict__ take1,
                           const int32_t* __restrict__ ev1,
                           const int32_t* __restrict__ site1,
                           float* __restrict__ out,
                           int s, int ldo, int max_slots, int n_events, int vec_rows) {
  constexpr int fv = (F + VEC - 1) / VEC;   // vectors of an output row
  constexpr int fp = fv * VEC;              // staged weight row, zero past F
  extern __shared__ __align__(16) float smem[];
  float* kg = smem;                                   // [C, fp] this group's weight slice
  float* rs = smem + weight_words(C, F);              // [THREADS, C] the tile's rows, by slot
  __shared__ int slot_s[THREADS];                     // the tile's live slots, listed
  __shared__ int ev_s[THREADS];                       // 0-based event of each listed slot
  __shared__ int warp_n[WARPS];                       // live slots of each warp's part of a tile

  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const int site = min(max(site1[g] - 1, 0), s - 1);
  for (int i = t; i < C * fp; i += THREADS) {
    const int cc = i / fp, ff = i - cc * fp;
    kg[i] = ff < F ? k3[((int64_t)cc * s + site) * F + ff] : 0.f;
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
    if (live) {
      const float* src = rows + (int64_t)(take - 1) * C;
      if (vec_rows) {
        for (int k = 0; k < C / 4; ++k)
          reinterpret_cast<float4*>(rs + t * C)[k] = reinterpret_cast<const float4*>(src)[k];
      } else {
        for (int cc = 0; cc < C; ++cc) rs[t * C + cc] = src[cc];
      }
    }
    // (the weight slice, the rows and warp_n are written at list_live's sync)
    const int2 pos = list_live(live, warp_n);
    if (live) {
      slot_s[pos.x] = t;
      ev_s[pos.x] = ev - 1;
    }
    __syncthreads();
    const int n = pos.y;
    if (n == 0) continue;

    // -- multiply and add into the event rows ---------------------------------
    if (!waited) {
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      waited = true;
    }
    for (int i = t; i < n * fv; i += THREADS) {
      const int m = i / fv;
      const int j = (i - m * fv) * VEC;
      const float* r = rs + slot_s[m] * C;
      const float* w = kg + j;
      float acc[VEC];
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
#pragma unroll 8
      for (int cc = 0; cc < C; ++cc) fma4(acc, r[cc], w + cc * fp);
      atomicAdd(reinterpret_cast<float4*>(out + (int64_t)ev_s[m] * ldo + j),
                make_float4(acc[0], acc[1], acc[2], acc[3]));
    }
  }
  // a block with nothing to add still waits, so that this grid ends after
  // the bias grid and work after it in the stream sees the whole output
  if (!waited) asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Block (g, ft): group g's products at output columns [64·ft, 64·ft + 64),
// at a runtime (C, F), on the tensor cores (3-pass TF32, tf32_mma.cuh). lr:
// row stride (words) of the staged rows, C rounded up to 8 (the mma's
// k-steps along C, zeros past C), plus 4, so that a fragment's 8 slots x 4
// channels hit 32 banks; kr: slots a chunk (KR where it fits); vec_rows,
// vec_k3: rows and weight rows may be copied 16 bytes at a time.
__global__ void __launch_bounds__(THREADS, 3)
site_grouped_matmul_tiled_kernel(const float* __restrict__ rows,
                                 const float* __restrict__ k3,
                                 const int32_t* __restrict__ take1,
                                 const int32_t* __restrict__ ev1,
                                 const int32_t* __restrict__ site1,
                                 float* __restrict__ out,
                                 int c, int s, int f, int ldo, int max_slots, int n_events,
                                 int lr, int kr, int vec_rows, int vec_k3) {
  extern __shared__ __align__(16) float smem[];
  const int c8 = (c + 7) / 8 * 8;
  float* kg = smem;                       // [c8, FTS] the weight tile (0 past C and F)
  float* buf = kg + c8 * FTS;             // 2 x [kr, lr] rows of a chunk (0 past C)
  __shared__ int take_s[THREADS];         // 0-based row of each listed slot
  __shared__ int ev_s[THREADS];           // 0-based event of each listed slot
  __shared__ int warp_n[WARPS];

  const int g = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int f0 = blockIdx.y * FT, fw = min(FT, f - f0);
  const int site = min(max(site1[g] - 1, 0), s - 1);
  const int32_t* take_g = take1 + (int64_t)g * max_slots;
  const int32_t* ev_g = ev1 + (int64_t)g * max_slots;
  // a thread's slot of the first tile and the weight tile: loads in flight
  // together (the tile's copies are committed with the first chunk's)
  int take = t < max_slots ? take_g[t] : 0;
  int ev = t < max_slots ? ev_g[t] : 0;
  const int vk = vec_k3 ? 4 : 1;
  for (int i = t; i < c8 * (FT / vk); i += THREADS) {
    const int cc = i / (FT / vk), q = vk * (i % (FT / vk));
    const bool on = cc < c && q < fw;
    cp_async(kg + cc * FTS + q, on ? k3 + ((int64_t)cc * s + site) * f + f0 + q : k3, on, vk);
  }
  bool kg_pending = true;                 // the weight tile's copies are uncommitted

  // warp w owns the chunk's 16 slots 16·(w % 2).. at the 16 columns
  // 16·(w / 2).. of the tile: two 8-column n-tiles
  const int rm = warp & 1, rn = warp >> 1;
  const bool cols_on = 16 * rn < fw;
  bool waited = false;

  // copies of chunk k of the listed slots into buffer k % 2: a warp a slot,
  // its lanes along the row
  auto issue = [&](int k, int cnt) {
    float* rs = buf + (k & 1) * kr * lr;
    const int base = k * kr, kn = min(kr, cnt - base);
    for (int m = warp; m < kn; m += WARPS) {
      const float* row = rows + (int64_t)take_s[base + m] * c;
      if (vec_rows) {
        for (int q = 4 * lane; q < c8; q += 128)
          cp_async(rs + m * lr + q, q < c ? row + q : rows, q < c, 4);
      } else {
        for (int q = lane; q < c8; q += 32) cp_async(rs + m * lr + q, q < c ? row + q : rows, q < c, 1);
      }
    }
  };

#pragma unroll 1
  for (int m0 = 0; m0 < max_slots; m0 += THREADS) {
    if (m0 > 0) {
      take = m0 + t < max_slots ? take_g[m0 + t] : 0;
      ev = m0 + t < max_slots ? ev_g[m0 + t] : 0;
    }
    // -- the tile's live slots, listed in slot order; a tile with none is
    //    skipped --------------------------------------------------------------
    const bool live = take > 0 && ev > 0 && ev <= n_events;
    const int2 pos = list_live(live, warp_n);
    if (live) {
      take_s[pos.x] = take - 1;
      ev_s[pos.x] = ev - 1;
    }
    __syncthreads();
    const int cnt = pos.y;
    if (cnt == 0) continue;
    const int chunks = ceil_div(cnt, kr);
    issue(0, cnt);
    cp_async_commit();
    kg_pending = false;
#pragma unroll 1
    for (int k = 0; k < chunks; ++k) {
      if (k + 1 < chunks) {
        issue(k + 1, cnt);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();                    // chunk k (and the weight tile) landed
      const int kn = min(kr, cnt - k * kr);
      if (cols_on && 16 * rm < kn) {
        // M = slots, N = columns, K = channels, 8 a step
        float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        const float* a = buf + (k & 1) * kr * lr + (16 * rm + gid) * lr + tig;
        const float* w = kg + tig * FTS + 16 * rn + gid;
#pragma unroll 2
        for (int kb = 0; kb < c8; kb += 8) {
          // A[m][k] = row of slot m, channel kb + k: a0 (gid, tig), a1 (gid +
          // 8, tig), a2 (gid, tig + 4), a3 (gid + 8, tig + 4)
          uint32_t ab[4], as[4], bb[2][2], bs[2][2];
          split(a[kb], ab[0], as[0]);
          split(a[kb + 8 * lr], ab[1], as[1]);
          split(a[kb + 4], ab[2], as[2]);
          split(a[kb + 8 * lr + 4], ab[3], as[3]);
          // B[k][n] = weight of channel kb + k, column n: b0 (tig, gid), b1 (tig + 4, gid)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            split(w[kb * FTS + 8 * q], bb[q][0], bs[q][0]);
            split(w[(kb + 4) * FTS + 8 * q], bb[q][1], bs[q][1]);
          }
#pragma unroll
          for (int pass = 0; pass < 3; ++pass)
#pragma unroll
            for (int q = 0; q < 2; ++q)
              mma_tf32(acc[q], pass == 0 ? as : ab, pass == 1 ? bs[q] : bb[q]);
        }
        if (!waited) {
          asm volatile("griddepcontrol.wait;\n" ::: "memory");
          waited = true;
        }
        // acc[q]: slots gid, gid + 8 x columns 8·q + 2·tig, + 1 of the warp's
        // 16; lanes tig, tig ^ 1 trade halves, so that each holds 4
        // consecutive columns of one slot (even tig: slot gid, odd: gid + 8)
        // and adds them with one float4 RED; columns past F land in the
        // row's padding, as zeros
        const bool odd = tig & 1;
        const int m = 16 * rm + gid + (odd ? 8 : 0);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float x0 = odd ? acc[q][0] : acc[q][2], x1 = odd ? acc[q][1] : acc[q][3];
          const float y0 = __shfl_xor_sync(0xffffffffu, x0, 1);
          const float y1 = __shfl_xor_sync(0xffffffffu, x1, 1);
          const float4 v = odd ? make_float4(y0, y1, acc[q][2], acc[q][3])
                               : make_float4(acc[q][0], acc[q][1], y0, y1);
          const int col = 16 * rn + 8 * q + 2 * (tig & 2);
          if (m < kn && col < fw)
            atomicAdd(reinterpret_cast<float4*>(out + (int64_t)ev_s[k * kr + m] * ldo + f0 + col),
                      v);
        }
      }
      __syncthreads();                    // buffer k % 2 is free for chunk k + 2
    }
  }
  if (kg_pending) cp_async_commit();
  cp_async_wait<0>();
  // a thread with nothing to add still waits, so that this grid ends after
  // the bias grid and work after it in the stream sees the whole output
  if (!waited) asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Allow `smem` bytes of dynamic shared memory for kernel `fn` on the
// current device; `allowed` is what has been allowed so far, per device.
template <typename Fn>
cudaError_t allow_smem(Fn* fn, size_t smem, DeviceCache& allowed) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return raise_per_device(allowed, smem, [fn, smem] {
    return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  });
}

// A programmatic dependent launch of `kernel`, whose blocks wait for the
// bias grid before their first add.
template <typename Kernel, typename... Args>
int launch_dependent(Kernel* kernel, dim3 grid, size_t smem, cudaStream_t st, Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = smem;
  config.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&config, kernel, args...));
}

int launch_tiled(const float* rows, const float* k3, const int32_t* take1, const int32_t* ev1,
                 const int32_t* site1, float* out, int groups, int max_slots, int c, int s,
                 int f, int ldo, int n_events, cudaStream_t st) {
  static DeviceCache optin_cache;   // the opt-in limit, read once a device
  size_t optin = 0;
  {
    const cudaError_t err = optin_smem(optin_cache, &optin);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the weight tile and two chunks of rows: the largest power-of-two chunk
  // of KR or 16 slots (the product's two 16-slot m-tiles) that fits
  const int c8 = (c + 7) / 8 * 8, lr = c8 + 4;
  const size_t static_bytes = sizeof(int) * (2 * THREADS + WARPS);
  auto smem_of = [&](int kr) { return sizeof(float) * ((size_t)c8 * FTS + 2 * (size_t)kr * lr); };
  int kr = KR;
  while (kr > 16 && smem_of(kr) + static_bytes > optin) kr /= 2;
  const size_t smem = smem_of(kr);
  if (smem + static_bytes > optin)
    return static_cast<int>(cudaErrorInvalidValue);
  static DeviceCache allowed;
  const cudaError_t err = allow_smem(site_grouped_matmul_tiled_kernel, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_rows = c % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  const int vec_k3 = f % 4 == 0 && reinterpret_cast<uintptr_t>(k3) % 16 == 0;
  return launch_dependent(site_grouped_matmul_tiled_kernel, dim3(groups, ceil_div(f, FT)), smem,
                          st, rows, k3, take1, ev1, site1, out, c, s, f, ldo, max_slots,
                          n_events, lr, kr, vec_rows, vec_k3);
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
  // the event rows: bias, or 0
  fill_bias_kernel<<<(n_events + FILL_ROWS - 1) / FILL_ROWS, FILL_THREADS, 0, st>>>(
      bias, out, n_events, f, ldo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || groups == 0 || max_slots == 0) return static_cast<int>(err);
  // ... then the slots' products, added into them
  if (c == 8 && f == 50) {
    auto kernel = site_grouped_matmul_kernel<8, 50>;
    const size_t smem = sizeof(float) * (weight_words(8, 50) + (size_t)THREADS * 8);
    const int vec_rows = reinterpret_cast<uintptr_t>(rows) % 16 == 0;
    return launch_dependent(kernel, dim3(groups), smem, st, rows, k3, take1, ev1, site1, out, s,
                            ldo, max_slots, n_events, vec_rows);
  }
  return launch_tiled(rows, k3, take1, ev1, site1, out, groups, max_slots, c, s, f, ldo,
                      n_events, st);
}

// Slots of a tile: an accumulate block lists and adds THREADS slots at a
// time, and skips a tile whose slots are all empty.
int site_grouped_matmul_tile_slots() { return THREADS; }

const char* wf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
