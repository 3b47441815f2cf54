// Site-grouped head GEMM with its bias, backward: per site group, the
// gradients of the gathered rows and of the group's weight slice, summed
// over the groups of each site by the last of them to finish, with no float
// atomics, so that two runs give the same bits.
//
// Replaces the autodiff of waveformml_tpu/ops/site_head.py:
// site_grouped_matmul (:96-108) and of the bias add after it in
// waveformml_tpu/models/blocks.py:FoldedSiteLinear (:188), which XLA ran on
// the TPU as a row gather of d_out, two batched einsums and two scatter-adds.
// With live(g, m) = take1[g, m] > 0 and 1 <= ev1[g, m] <= n_events,
// sg = clamp(site1[g] - 1, 0, S - 1) and the weight slice k3[:, sg, :]:
//
//   d_rows[take1 - 1]  = live ? d_out[ev1 - 1] @ k3[:, sg, :]ᵀ : 0   (rows in no slot: 0)
//   d_k3[:, s, :]      = Σ_{g: sg = s} Σ_{m live} rows[take1 - 1]ᵀ d_out[ev1 - 1]
//   d_bias             = Σ_e d_out[e]
//
// A row is in at most one slot of a layout that host_site_layout builds, so
// its d_rows entry is a plain store.
//
// Bound on the H100: at the training head, (C, F) = (8, 50), bytes, and
// below them the latency of dependent grids: a live slot costs 2·2·C·F =
// 1600 FLOP against ~C·8 bytes of row in and out and 200 bytes of d_out;
// the training layout's ~10^4 live slots move ~3 MB with the weights and
// their gradient, 1 µs at 3.35 TB/s, while one grid costs a few µs to
// launch and drain. At SubMPSD_w128's head, (C, F) = (128, 199), bytes
// again once the products run on the tensor cores: ~46 MB (the weights
// and their gradient are 31 MB of it), 14 µs, against 3 x 4·C·F FLOP a
// live slot, ~3·10^9 for a 4096-event batch in three TF32 passes, 6 µs at
// 495 TFLOP/s (15 µs in fp32 at 67 TFLOP/s).
//
// Design: two grids, the second a programmatic dependent launch.
// * Grid 1 zeroes d_rows (which rows sit in no slot is known only from the
//   whole layout) and the tickets, and sums d_out over runs of BIAS_EVENTS
//   events, in a fixed order (column_sums), into per-block partials of
//   d_bias.
// * Grid 2, at the training head's (8, 50) (an instantiation of its own:
//   loops unrolled, indices divided by constants): one block per site
//   group. It loads its first TILE = 256 slots, the sites of all groups and
//   its [C, F] weight slice together, lists the groups of its site (warp
//   ballots over site1, in group order), then walks its MAX slots TILE at a
//   time (one tile at the training layout's MAX = 128): it lists the tile's
//   filled slots in slot order, gathers their rows and d_out rows into
//   shared memory (zero where the slot is not live), adds the tile's
//   products into the group's [C, F] gradient, which a thread owns entry by
//   entry in shared memory, slot by slot in order, and only then waits for
//   grid 1 (griddepcontrol.wait) to store each listed slot's d_rows row. So
//   all its loads and products overlap grid 1.
// * Grid 2 at every other (C, F), wide heads such as SubMPSD_w128's: one
//   block per (group, 32-channel tile, 256-column pass of F), 616 blocks of
//   ~94 KB at (128, 199), two to an SM (the group grid held the whole
//   [C, F] slice and its gradient, 199 KB: 154 blocks, one to an SM, and
//   its chunked products took two shared-memory loads per FMA). A block
//   lists its group's live slots 256 at a time and streams them through
//   shared memory KC = 32 at a time, double-buffered by cp.async (the next
//   chunk's rows and d_out rows load while this chunk multiplies), with the
//   tile's [32, F] slice of the weights staged once, after the first chunk
//   (only d_rows reads it: the first chunk's d_k3 runs while it loads).
//   Both products of a
//   chunk run on the tensor cores, mma.sync.m16n8k8 TF32 with K1's and
//   K4's 3-pass split (tf32_mma.cuh; fp32 accuracy but for ~2^-22
//   relative):
//   - the d_k3 tile, rowsᵀ · d_out as K4's centre tap: M = the 32
//     channels, N = the pass's columns (a warp every 8th 8-column tile),
//     K = the chunk's slots in list order, accumulated in registers across
//     the chunks;
//   - d_rows, d_out · sliceᵀ as K1's product: M = the chunk's slots, N =
//     the 32 channels, K = the full F inside the block, so that no partial
//     needs an atomic. A warp owns 16 slots x 16 channels over every other
//     k-step (8 fragment splits for 6 mma), and the two halves meet in
//     shared memory, in that order; stored after griddepcontrol.wait.
//   Staged rows lie 8 mod 32 words apart and d_out and weight rows 4 mod 8
//   (F rounded up to 8, plus 4), so that fragment loads hit 32 banks
//   (d_k3's d_out fragments excepted: 2-way). Why the tensor cores:
//   register tiles of fp32 FMA came first (8 channels x 4 columns of d_k3
//   a thread, 2 x 2 of d_rows, float4 reads) and took 0.091 ms at (128,
//   199) on an H100 SXM at 700 W, against 0.067 for this grid; an mma
//   fragment of 4 to 6 conflict-free 32-bit reads feeds 1024 products,
//   where a thread's float4 reads fed 4 to 8 FMA each. What is left is
//   mostly each block's chain of loads and waits before and between its
//   products, not the products.
// * The sum over a site's groups needs no third grid: where the site has
//   one group (G = S, every layout host_site_layout builds) the block
//   stores its gradient into d_k3 directly. Otherwise it writes it to a
//   [G, C, F] scratch buffer, waits for grid 1 and takes an integer ticket
//   of its (site, tile); the last of the site's groups to arrive sums their
//   tiles in group order. The tickets lie in the call's scratch and grid 1
//   zeroes them, so no memset precedes a call and calls on several streams
//   may run at once. Stitched layouts (G > S, a site in several groups,
//   sites outside [1, S] clamped) take that branch. Sites with no group get
//   zeros from the blocks that own them (site ≡ group block mod groups),
//   and the first block sums d_bias's partials in block order.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_cache.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = THREADS;       // slots a group's block lists at a time
constexpr int ZERO_ROWS = 256;      // d_rows rows a block of grid 1 zeroes
constexpr int BIAS_EVENTS = 64;     // d_out rows a block of grid 1 sums for d_bias
// the tiled grid: channels and gradient columns of a block, slots of a
// chunk, and the row stride (words) of a chunk's staged rows (≡ 8 mod 32,
// so that an mma fragment's 4 slots x 8 channels hit 32 banks)
constexpr int WC = 32;
constexpr int WF = 256;
constexpr int KC = 32;
constexpr int SR = WC + 8;

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ int clamp_site(int site1, int s) { return min(max(site1 - 1, 0), s - 1); }

// out[j] = Σ_{r < rows} src[r, j] for the f columns of a [rows, f] array,
// in a fixed order: THREADS / f groups of threads a column, each over every
// group-th row (the loads in flight together), then the groups in order.
// Called by every thread of the block.
__device__ void column_sums(const float* __restrict__ src, int rows, int f,
                            float* __restrict__ out, float* part_s) {
  const int t = threadIdx.x;
  for (int j0 = 0; j0 < f; j0 += THREADS) {
    const int cols = min(f - j0, THREADS), groups = THREADS / cols;
    const int c = t % cols, rg = t / cols;
    float v = 0.f;
    if (rg < groups) {
#pragma unroll 16
      for (int r = rg; r < rows; r += groups) v += src[(int64_t)r * f + j0 + c];
    }
    part_s[t] = v;
    __syncthreads();
    if (t < cols) {
      float sum = 0.f;
      for (int q = 0; q < groups; ++q) sum += part_s[q * cols + t];
      out[j0 + t] = sum;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
zero_rows_bias_kernel(const float* __restrict__ d_out, float* __restrict__ d_rows,
                      float* __restrict__ bias_part, int* __restrict__ tickets, int n, int c,
                      int n_events, int f, int n_tickets) {
  __shared__ float part_s[THREADS];
  // the group grid may start now; it waits for this grid before its stores
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int b = blockIdx.x, t = threadIdx.x;
  for (int i = b * THREADS + t; i < n_tickets; i += gridDim.x * THREADS) tickets[i] = 0;
  const int64_t z1 = (int64_t)min(n, (b + 1) * ZERO_ROWS) * c;
  for (int64_t i = (int64_t)b * ZERO_ROWS * c + t; i < z1; i += THREADS) d_rows[i] = 0.f;
  const int e0 = b * BIAS_EVENTS;
  if (bias_part == nullptr || e0 >= n_events) return;
  column_sums(d_out + (int64_t)e0 * f, min(n_events - e0, BIAS_EVENTS), f,
              bias_part + (int64_t)b * f, part_s);
}

// The groups of a block's site, in group order, into same_s and *n_same
// (warp 0), after every group's clamped site is in site_s.
__device__ void list_site_groups(const int* site_s, int groups, int site, int* same_s,
                                 int* n_same) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 32) return;
  int cnt = 0;
  for (int i0 = 0; i0 < groups; i0 += 32) {
    const int i = i0 + lane;
    const bool same = i < groups && site_s[i] == site;
    const uint32_t b = __ballot_sync(0xffffffffu, same);
    if (same) same_s[cnt + __popc(b & ((1u << lane) - 1u))] = i;
    cnt += __popc(b);
  }
  if (lane == 0) *n_same = cnt;
}

// Zeros for the sites with no group among those this block owns (site ≡
// block mod blocks): columns [f0, f0 + fw) of channels [c0, c0 + cw).
__device__ void zero_lonely_sites(const int* site_s, int groups, int block, int blocks, int s,
                                  int c0, int cw, int f, int f0, int fw, float* d_k3) {
  const int t = threadIdx.x;
  for (int sp = block; sp < s; sp += blocks) {
    bool mine = false;
    for (int i = t; i < groups; i += THREADS) mine |= site_s[i] == sp;
    if (__syncthreads_or(mine)) continue;
    for (int i = t; i < cw * fw; i += THREADS) {
      const int cc = i / fw, ff = i - cc * fw;
      d_k3[((int64_t)(c0 + cc) * s + sp) * f + f0 + ff] = 0.f;
    }
  }
}

// Thread t's slot m0 + t of a group's take1 and ev1 rows (0, 0 past MAX).
__device__ __forceinline__ int2 load_slot(const int32_t* take_g, const int32_t* ev_g, int m0,
                                          int max_slots) {
  const int m = m0 + threadIdx.x;
  return m < max_slots ? make_int2(take_g[m], ev_g[m]) : make_int2(0, 0);
}

// Lists the live (with_dead: filled) slots of a tile of a group, each
// thread's (take, ev) of its slot given, in slot order, into take_s (0-based
// row) and ev_s (0-based event, -1 where not live); returns their count.
// Called by every thread, once the last tile's readers of the lists are done.
__device__ int list_slots(int2 slot, int n_events, bool with_dead, int* take_s, int* ev_s,
                          int* warp_n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int take = slot.x, ev = slot.y;
  const bool live = take > 0 && ev > 0 && ev <= n_events;
  const bool listed = with_dead ? take > 0 : live;
  const uint32_t b = __ballot_sync(0xffffffffu, listed);
  if (lane == 0) warp_n[warp] = __popc(b);
  __syncthreads();
  int base = 0, cnt = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    base += w < warp ? warp_n[w] : 0;
    cnt += warp_n[w];
  }
  if (listed) {
    const int pos = base + __popc(b & ((1u << lane) - 1u));
    take_s[pos] = take - 1;
    ev_s[pos] = live ? ev - 1 : -1;
  }
  __syncthreads();
  return cnt;
}

// The site's tile of the weight gradient from the block's own, `get(i)`
// for entry i = cc·fw + ff of channels [c0, c0 + cw) and columns [f0, f0 +
// fw): a plain store where the site has one group, else through the
// scratch and the last of the site's groups to take the (site, tile)
// ticket, which sums them in group order. Called by every thread.
template <typename Get>
__device__ void store_site_tile(Get get, int g, int site, int n_same, const int* same_s, int c,
                                int s, int f, int c0, int cw, int f0, int fw, int ticket,
                                float* d_k3, float* dkg_part, int* tickets, int* last) {
  const int t = threadIdx.x;
  if (n_same == 1) {
    for (int i = t; i < cw * fw; i += THREADS) {
      const int cc = i / fw, ff = i - cc * fw;
      d_k3[((int64_t)(c0 + cc) * s + site) * f + f0 + ff] = get(i);
    }
    return;
  }
  const int64_t cf = (int64_t)c * f;
  for (int i = t; i < cw * fw; i += THREADS) {
    const int cc = i / fw, ff = i - cc * fw;
    dkg_part[g * cf + (int64_t)(c0 + cc) * f + f0 + ff] = get(i);
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");   // the tickets are zero
  __threadfence();
  __syncthreads();
  if (t == 0) *last = atomicAdd(&tickets[ticket], 1) == n_same - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  for (int i = t; i < cw * fw; i += THREADS) {
    const int cc = i / fw, ff = i - cc * fw;
    const int64_t at = (int64_t)(c0 + cc) * f + f0 + ff;
    float v = 0.f;
    for (int q = 0; q < n_same; ++q) v += __ldcg(&dkg_part[same_s[q] * cf + at]);
    d_k3[((int64_t)(c0 + cc) * s + site) * f + f0 + ff] = v;
  }
}

// ---------------------------------------------------------------------------
// Grid 2 at the training head's (C, F) = (8, 50)
// ---------------------------------------------------------------------------

// Bytes of its dynamic shared memory: the weight slice and the group's
// gradient [C, F] each, the staged rows [TILE, C] and d_out rows [TILE, F],
// then the clamped site of every group and the groups of the block's site.
size_t group_smem_bytes(int c, int f, int groups) {
  return sizeof(float) * (2 * (size_t)c * f + (size_t)TILE * (c + f)) +
         sizeof(int) * 2 * (size_t)groups;
}

template <int C, int F>
__global__ void __launch_bounds__(THREADS)
site_head_bwd_kernel(const float* __restrict__ d_out, const float* __restrict__ rows,
                     const float* __restrict__ k3, const int32_t* __restrict__ take1,
                     const int32_t* __restrict__ ev1, const int32_t* __restrict__ site1,
                     const float* __restrict__ bias_part, float* __restrict__ d_rows,
                     float* __restrict__ d_k3, float* __restrict__ d_bias,
                     float* __restrict__ dkg_part, int* __restrict__ tickets, int groups,
                     int max_slots, int s, int n_events, int bias_parts) {
  constexpr int cf = C * F;
  extern __shared__ __align__(16) float smem[];
  float* kg = smem;                 // [C, F] the group's weight slice
  float* acc = kg + cf;             // [C, F] the group's weight gradient
  float* rs = acc + cf;             // [TILE, C] rows of the listed slots (0 where not live)
  float* ds = rs + TILE * C;        // [TILE, F] their d_out rows (0 where not live)
  int* site_s = reinterpret_cast<int*>(ds + TILE * F);   // [groups] clamped site of each group
  int* same_s = site_s + groups;    // the groups of this block's site, in group order
  __shared__ int take_s[TILE];      // 0-based row of each listed slot
  __shared__ int ev_s[TILE];        // 0-based event of each listed slot, -1 where not live
  __shared__ int warp_n[WARPS];
  __shared__ int n_same, last;
  __shared__ float part_s[THREADS];

  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const bool is_group = g < groups;
  const int32_t* take_g = take1 + (int64_t)g * max_slots;
  const int32_t* ev_g = ev1 + (int64_t)g * max_slots;
  // the first tile's slots, the sites and the weight slice: loads in flight
  // together
  int2 slot = is_group ? load_slot(take_g, ev_g, 0, max_slots) : make_int2(0, 0);
  for (int i = t; i < groups; i += THREADS) site_s[i] = clamp_site(site1[i], s);
  const int site = is_group ? clamp_site(site1[g], s) : -1;
  if (is_group) {
    for (int i = t; i < cf; i += THREADS) {
      const int cc = i / F, ff = i - cc * F;
      kg[i] = k3[((int64_t)cc * s + site) * F + ff];
      acc[i] = 0.f;
    }
  }
  __syncthreads();
  list_site_groups(site_s, groups, site, same_s, &n_same);
  zero_lonely_sites(site_s, groups, g, gridDim.x, s, 0, C, F, 0, F, d_k3);
  __syncthreads();                  // n_same and same_s are written

  if (is_group) {
#pragma unroll 1
    for (int m0 = 0; m0 < max_slots; m0 += TILE) {
      if (m0 > 0) {
        __syncthreads();            // the last tile's readers are done
        slot = load_slot(take_g, ev_g, m0, max_slots);
      }
      const int cnt = list_slots(slot, n_events, true, take_s, ev_s, warp_n);
      if (cnt == 0) continue;
      // -- gather the listed slots' rows and d_out rows (a thread's loads are
      //    independent: unrolled, they are in flight together) ----------------
#pragma unroll 4
      for (int i = t; i < cnt * C; i += THREADS) {
        const int m = i / C, cc = i - m * C;
        rs[i] = ev_s[m] >= 0 ? rows[(int64_t)take_s[m] * C + cc] : 0.f;
      }
#pragma unroll 4
      for (int i = t; i < cnt * F; i += THREADS) {
        const int m = i / F, ff = i - m * F;
        ds[i] = ev_s[m] >= 0 ? d_out[(int64_t)ev_s[m] * F + ff] : 0.f;
      }
      __syncthreads();

      // -- the group's weight gradient, slot by slot in list order -------------
      // (four independent chains over the slots m ≡ 0..3 mod 4, added in
      // that order: a fixed order with a quarter of the latency)
      for (int i = t; i < cf; i += THREADS) {
        const int cc = i / F, ff = i - cc * F;
        float v[4] = {acc[i], 0.f, 0.f, 0.f};
        int m = 0;
        for (; m + 4 <= cnt; m += 4) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            v[u] = fmaf(rs[(m + u) * C + cc], ds[(m + u) * F + ff], v[u]);
        }
        for (int u = 0; m < cnt; ++m, ++u) v[u] = fmaf(rs[m * C + cc], ds[m * F + ff], v[u]);
        acc[i] = (v[0] + v[1]) + (v[2] + v[3]);
      }
      // -- d_rows of the listed slots: d_out row times the slice, transposed,
      //    stored once grid 1 has zeroed d_rows --------------------------------
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      for (int i = t; i < cnt * C; i += THREADS) {
        const int m = i / C, cc = i - m * C;
        const float* d = ds + m * F;
        const float* w = kg + cc * F;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        int ff = 0;
        for (; ff + 4 <= F; ff += 4) {
#pragma unroll
          for (int u = 0; u < 4; ++u) v[u] = fmaf(d[ff + u], w[ff + u], v[u]);
        }
        for (int u = 0; ff < F; ++ff, ++u) v[u] = fmaf(d[ff], w[ff], v[u]);
        d_rows[(int64_t)take_s[m] * C + cc] = (v[0] + v[1]) + (v[2] + v[3]);
      }
    }
  }

  // -- d_bias: block 0 sums grid 1's partials in block order (and waits for
  //    grid 1 in any case, so that this grid ends after it) --------------------
  if (g == 0) {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    if (d_bias != nullptr) column_sums(bias_part, bias_parts, F, d_bias, part_s);
  }
  if (!is_group) return;
  // (each thread wrote only its own entries of acc)
  store_site_tile([&](int i) { return acc[i]; }, g, site, n_same, same_s, C, s, F, 0, C, 0, F,
                  site, d_k3, dkg_part, tickets, &last);
}

// ---------------------------------------------------------------------------
// Grid 2 at every other (C, F): tiles of WC channels x WF columns
// ---------------------------------------------------------------------------

// Row stride (words) of the staged d_out rows and weight rows: F rounded up
// to 8 (the mma's k-steps along F, zeros past F), plus 4, so that a row
// fragment's 8 rows x 4 columns hit 32 banks.
int tiled_ld(int f) { return (f + 7) / 8 * 8 + 4; }

// Bytes of its dynamic shared memory: the weight tile [WC, ld], two chunk
// buffers of d_out rows [kc, ld] and rows [kc, SR], the second half-sums of
// a chunk's row gradients [4, 32, 8], and two [groups] lists.
size_t tiled_smem_bytes(int ld, int kc, int groups) {
  return sizeof(float) * ((size_t)WC * ld + 2 * (size_t)kc * (ld + SR) + 4 * 32 * 8) +
         sizeof(int) * 2 * (size_t)groups;
}

// cp.async.wait_group with a runtime count of groups left in flight (0–2)
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n >= 2) {
    cp_async_wait<2>();
  } else if (n == 1) {
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
}

// Bytes of its static shared memory.
constexpr size_t TILED_STATIC_BYTES = sizeof(int) * (2 * TILE + WARPS + 2) + sizeof(float) * THREADS;

// The weight gradient's tile over one chunk, on the tensor cores (3-pass
// TF32, tf32_mma.cuh): acc[mt][q] += rs[k-steps, 16·mt..]ᵀ · ds[k-steps,
// nb + 64·q..], M = the tile's 32 channels (2 m-tiles), N = the warp's NQ
// 8-column tiles (every 8th of the pass), K = the chunk's slots, 8 a step,
// in slot order.
template <int NQ>
__device__ __forceinline__ void k3_chunk(float (&acc)[2][4][4], const float* __restrict__ ds,
                                         const float* __restrict__ rs, int ksteps, int ld,
                                         int nb) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll 1
  for (int ks = 0; ks < ksteps; ++ks) {
    const int kb = ks * 8;
    // A[m][k] = row of slot kb + k, channel m: a0 (gid, tig), a1 (gid + 8,
    // tig), a2 (gid, tig + 4), a3 (gid + 8, tig + 4)
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float* a = rs + (kb + tig) * SR + mt * 16 + gid;
      split(a[0], ab[mt][0], as[mt][0]);
      split(a[8], ab[mt][1], as[mt][1]);
      split(a[4 * SR], ab[mt][2], as[mt][2]);
      split(a[4 * SR + 8], ab[mt][3], as[mt][3]);
    }
    // B[k][n] = d_out row of slot kb + k, column n: b0 (tig, gid), b1 (tig + 4, gid)
    uint32_t bb[NQ][2], bs[NQ][2];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float* b = ds + (kb + tig) * ld + nb + 64 * q + gid;
      split(b[0], bb[q][0], bs[q][0]);
      split(b[4 * ld], bb[q][1], bs[q][1]);
    }
#pragma unroll
    for (int pass = 0; pass < 3; ++pass)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          mma_tf32(acc[mt][q], pass == 0 ? as[mt] : ab[mt], pass == 1 ? bs[q] : bb[q]);
  }
}

// Block (g, ct, fp): group g's weight gradient at channels [32·ct, 32·ct +
// 32) and columns [256·fp, 256·fp + 256), and (fp = 0) the d_rows entries
// of its live slots at those channels. kc: slots a chunk (KC where it fits);
// vec_rows, vec_out: rows and d_out rows may be copied 16 bytes at a time.
__global__ void __launch_bounds__(THREADS, 2)
site_head_bwd_tiled_kernel(const float* __restrict__ d_out, const float* __restrict__ rows,
                           const float* __restrict__ k3, const int32_t* __restrict__ take1,
                           const int32_t* __restrict__ ev1, const int32_t* __restrict__ site1,
                           const float* __restrict__ bias_part, float* __restrict__ d_rows,
                           float* __restrict__ d_k3, float* __restrict__ d_bias,
                           float* __restrict__ dkg_part, int* __restrict__ tickets, int groups,
                           int max_slots, int c, int s, int f, int n_events, int bias_parts,
                           int ld, int kc, int vec_rows, int vec_out) {
  extern __shared__ __align__(16) float smem[];
  float* kg = smem;                             // [WC, ld] the weight tile (0 past C and F)
  float* buf = kg + WC * ld;                    // 2 x ([kc, ld] d_out rows | [kc, SR] rows)
  const int buf_words = kc * (ld + SR);
  float* half_s = buf + 2 * buf_words;          // [4, 32, 8] second half-sums of d_rows
  int* site_s = reinterpret_cast<int*>(half_s + 4 * 32 * 8);  // [groups] clamped sites
  int* same_s = site_s + groups;                // the groups of this block's site, in order
  __shared__ int take_s[TILE];                  // 0-based row of each listed slot
  __shared__ int ev_s[TILE];                    // 0-based event of each listed slot
  __shared__ int warp_n[WARPS];
  __shared__ int n_same, last;
  __shared__ float part_s[THREADS];

  const int g = blockIdx.x, ct = blockIdx.y, fp = blockIdx.z;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int c0 = ct * WC, cw = min(WC, c - c0);
  const int f0 = fp * WF, fw = min(WF, f - f0);
  const bool is_group = g < groups;
  const bool with_rows = fp == 0;               // this block also owns d_rows
  const int32_t* take_g = take1 + (int64_t)g * max_slots;
  const int32_t* ev_g = ev1 + (int64_t)g * max_slots;
  const int site = is_group ? clamp_site(site1[g], s) : -1;

  // -- the first tile's slots, the sites, and zeros past F in the chunk
  //    buffers, which the copies never write --------------------------------------
  int2 slot = is_group ? load_slot(take_g, ev_g, 0, max_slots) : make_int2(0, 0);
  for (int i = t; i < groups; i += THREADS) site_s[i] = clamp_site(site1[i], s);
  const int pad = ld - f;
  for (int i = t; i < 2 * kc * pad; i += THREADS) {
    const int r = i / pad;
    buf[(r / kc) * buf_words + (r % kc) * ld + f + i % pad] = 0.f;
  }
  __syncthreads();
  list_site_groups(site_s, groups, site, same_s, &n_same);
  zero_lonely_sites(site_s, groups, g, gridDim.x, s, c0, cw, f, f0, fw, d_k3);
  __syncthreads();                              // n_same and same_s are written

  // d_k3: warp w owns the 8-column tiles w + 8·q of the pass, nq of them
  // inside F, and both 16-channel m-tiles
  const int nq = min(4, max(0, ceil_div(ceil_div(fw, 8) - warp, 8)));
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][q][i] = 0.f;
  // d_rows: warp w owns the chunk's 16 slots 16·(w % 2).. at the 16
  // channels 16·(w / 2 % 2).. of the tile (two 8-channel n-tiles) over every
  // other k-step of F, from the (w / 4)-th; the second half's sums meet the
  // first's in shared memory
  const int rm = warp & 1, rn = (warp >> 1) & 1, rk = warp >> 2;
  const int f8 = (f + 7) / 8 * 8;
  bool waited = false;

  // the weight tile, by cp.async
  auto stage_kg = [&]() {
    for (int cc = warp; cc < WC; cc += WARPS) {
      const float* src = k3 + ((int64_t)(c0 + cc) * s + site) * f;
      for (int ff = lane; ff < ld; ff += 32) {
        const bool on = cc < cw && ff < f;
        cp_async(kg + cc * ld + ff, on ? src + ff : k3, on, 1);
      }
    }
  };

  // copies of chunk k of the listed slots into buffer k % 2: a warp a slot,
  // its lanes along the row; zeros up to the chunk's next multiple of 8
  // slots (the d_k3 product's last k-step)
  auto issue = [&](int k, int cnt) {
    float* ds = buf + (k & 1) * buf_words;
    float* rs = ds + kc * ld;
    const int base = k * kc, kn = min(kc, cnt - base);
    for (int m = warp; m < min(kc, (kn + 7) / 8 * 8); m += WARPS) {
      const bool on = m < kn;
      const float* src = on ? d_out + (int64_t)ev_s[base + m] * f : d_out;
      if (vec_out) {
        for (int q = 4 * lane; q < f; q += 128)
          cp_async(ds + m * ld + q, on ? src + q : d_out, on, 4);
      } else {
        for (int q = lane; q < f; q += 32) cp_async(ds + m * ld + q, on ? src + q : d_out, on, 1);
      }
      const float* row = on ? rows + (int64_t)take_s[base + m] * c + c0 : rows;
      if (vec_rows) {
        const bool q_on = on && 4 * lane < cw;
        if (lane < WC / 4) cp_async(rs + m * SR + 4 * lane, q_on ? row + 4 * lane : rows, q_on, 4);
      } else {
        const bool q_on = on && lane < cw;
        cp_async(rs + m * SR + lane, q_on ? row + lane : rows, q_on, 1);
      }
    }
  };

  if (is_group) {
    bool kg_staged = !with_rows;                // the weight tile is asked for
#pragma unroll 1
    for (int m0 = 0; m0 < max_slots; m0 += TILE) {
      if (m0 > 0) slot = load_slot(take_g, ev_g, m0, max_slots);
      const int cnt = list_slots(slot, n_events, false, take_s, ev_s, warp_n);
      if (cnt == 0) continue;
      const int chunks = ceil_div(cnt, kc);
      // the first chunk, then the weight tile (d_rows's alone: the first
      // chunk's d_k3 runs while it loads), then the second chunk
      issue(0, cnt);
      cp_async_commit();
      const bool kg_now = !kg_staged;
      if (kg_now) {
        stage_kg();
        cp_async_commit();
        kg_staged = true;
      }
#pragma unroll 1
      for (int k = 0; k < chunks; ++k) {
        const bool next = k + 1 < chunks;
        if (next) {
          issue(k + 1, cnt);
          cp_async_commit();
        }
        // groups that may stay in flight: the next chunk's, and the weight
        // tile's until d_rows of the first chunk
        const bool kg_wait = kg_now && k == 0;
        cp_async_wait_n(int(next) + int(kg_wait));
        __syncthreads();                        // chunk k landed
        const float* ds = buf + (k & 1) * buf_words;
        const float* rs = ds + kc * ld;
        const int kn = min(kc, cnt - k * kc);
        // -- the weight gradient's tile, slot by slot in list order ----------
        const int ksteps = ceil_div(kn, 8), nb = f0 + 8 * warp;
        switch (nq) {
          case 4: k3_chunk<4>(acc, ds, rs, ksteps, ld, nb); break;
          case 3: k3_chunk<3>(acc, ds, rs, ksteps, ld, nb); break;
          case 2: k3_chunk<2>(acc, ds, rs, ksteps, ld, nb); break;
          case 1: k3_chunk<1>(acc, ds, rs, ksteps, ld, nb); break;
          default: break;
        }
        // -- d_rows of the chunk's slots at the block's channels, over all
        //    of F on the tensor cores (M = slots, N = channels, K = F), stored
        //    once grid 1 has zeroed d_rows -------------------------------------
        if (with_rows) {
          if (kg_wait) {
            cp_async_wait_n(int(next));
            __syncthreads();                    // the weight tile landed
          }
          if (!waited) {
            asm volatile("griddepcontrol.wait;\n" ::: "memory");
            waited = true;
          }
          const bool rows_on = 16 * rm < kn;
          float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          if (rows_on) {
            const float* a = ds + (16 * rm + gid) * ld + tig;
            const float* w = kg + (16 * rn + gid) * ld + tig;
#pragma unroll 2
            for (int kb = 8 * rk; kb < f8; kb += 16) {
              // A[m][k] = d_out of slot m, column kb + k; B[k][n] = weight of
              // channel n, column kb + k: b0 (tig, gid), b1 (tig + 4, gid)
              uint32_t ab[4], as[4], bb[2][2], bs[2][2];
              split(a[kb], ab[0], as[0]);
              split(a[kb + 8 * ld], ab[1], as[1]);
              split(a[kb + 4], ab[2], as[2]);
              split(a[kb + 8 * ld + 4], ab[3], as[3]);
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                split(w[8 * q * ld + kb], bb[q][0], bs[q][0]);
                split(w[8 * q * ld + kb + 4], bb[q][1], bs[q][1]);
              }
#pragma unroll
              for (int pass = 0; pass < 3; ++pass)
#pragma unroll
                for (int q = 0; q < 2; ++q)
                  mma_tf32(o[q], pass == 0 ? as : ab, pass == 1 ? bs[q] : bb[q]);
            }
          }
          // the second half's sums meet the first's, in that order
          float* hs = half_s + ((rm * 2 + rn) * 32 + lane) * 8;
          if (rows_on && rk == 1) {
#pragma unroll
            for (int i = 0; i < 8; ++i) hs[i] = o[i / 4][i % 4];
          }
          __syncthreads();
          if (rows_on && rk == 0) {
            // o[q]: slots gid, gid + 8 of the m-tile x channels 8·q + 2·tig, + 1
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int cc = 16 * rn + 8 * q + 2 * tig;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int m = 16 * rm + gid + 8 * h;
                if (m >= kn) continue;
                float* r = d_rows + (int64_t)take_s[k * kc + m] * c + c0 + cc;
                if (cc < cw) r[0] = o[q][2 * h] + hs[4 * q + 2 * h];
                if (cc + 1 < cw) r[1] = o[q][2 * h + 1] + hs[4 * q + 2 * h + 1];
              }
            }
          }
        }
        __syncthreads();                        // buffer k % 2 is free for chunk k + 2
      }
    }
    cp_async_wait<0>();
  }
  __syncthreads();                              // every copy into buf has landed

  // -- d_bias: the first block sums grid 1's partials in block order (and
  //    waits for grid 1 in any case, so that this grid ends after it) ---------
  if (g == 0 && ct == 0 && fp == 0) {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    if (d_bias != nullptr) column_sums(bias_part, bias_parts, f, d_bias, part_s);
  }
  if (!is_group) return;

  // -- the site's tile: the block's sums through shared memory (the weight
  //    tile and the chunk buffers are free), then stored or summed over the
  //    site's groups ------------------------------------------------------------
  float* tile_s = smem;                         // [WC, ts]
  const int ts = (fw + 7) / 8 * 8;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q >= nq) break;
    // acc[mt][q]: channels 16·mt + gid (+ 8) x columns 8·(warp + 8·q) + 2·tig (+ 1)
    const int col = 8 * (warp + 8 * q) + 2 * tig;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float* p = tile_s + (16 * mt + gid) * ts + col;
      p[0] = acc[mt][q][0];
      p[1] = acc[mt][q][1];
      p[8 * ts] = acc[mt][q][2];
      p[8 * ts + 1] = acc[mt][q][3];
    }
  }
  __syncthreads();
  store_site_tile([&](int i) { const int cc = i / fw; return tile_s[cc * ts + i - cc * fw]; },
                  g, site, n_same, same_s, c, s, f, c0, cw, f0, fw,
                  (site * gridDim.y + ct) * gridDim.z + fp, d_k3, dkg_part, tickets, &last);
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

// A programmatic dependent launch of `kernel`: its blocks load and multiply
// while grid 1 runs and wait for it before their d_rows stores.
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

int launch_tiled(const float* d_out, const float* rows, const float* k3, const int32_t* take1,
                 const int32_t* ev1, const int32_t* site1, const float* bias_part,
                 float* d_rows, float* d_k3, float* d_bias, float* dkg_part, int* tickets,
                 int groups, int max_slots, int c, int s, int f, int n_events, int bias_parts,
                 cudaStream_t st) {
  static DeviceCache optin_cache;   // the opt-in limit, read once a device
  size_t optin = 0;
  {
    const cudaError_t err = optin_smem(optin_cache, &optin);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the largest power-of-two chunk of KC or 16 slots (the row gradient's
  // two 16-slot m-tiles) that fits
  const int ld = tiled_ld(f);
  int kc = KC;
  while (kc > 16 && tiled_smem_bytes(ld, kc, groups) + TILED_STATIC_BYTES > optin)
    kc /= 2;
  const size_t smem = tiled_smem_bytes(ld, kc, groups);
  if (smem + TILED_STATIC_BYTES > optin)
    return static_cast<int>(cudaErrorInvalidValue);
  static DeviceCache allowed;
  const cudaError_t err = allow_smem(site_head_bwd_tiled_kernel, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_rows = c % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  const int vec_out = f % 4 == 0 && reinterpret_cast<uintptr_t>(d_out) % 16 == 0;
  return launch_dependent(site_head_bwd_tiled_kernel,
                          dim3(groups > 0 ? groups : 1, ceil_div(c, WC), ceil_div(f, WF)), smem,
                          st, d_out, rows, k3, take1, ev1, site1, bias_part, d_rows, d_k3,
                          d_bias, dkg_part, tickets, groups, max_slots, c, s, f, n_events,
                          bias_parts, ld, kc, vec_rows, vec_out);
}

// Tickets of a call: one per (site, tile) of the tiled grid (one per site
// at the training head).
int64_t ticket_count(int c, int s, int f) {
  return (int64_t)s * (c > 0 ? ceil_div(c, WC) : 1) * (f > 0 ? ceil_div(f, WF) : 1);
}

}  // namespace

extern "C" {

// Scratch the launch needs: *groups_floats floats for the groups' weight
// gradients (G·C·F) and the tickets (ticket_count int32 after them), and
// *bias_floats floats for d_bias's partials.
int site_grouped_matmul_bwd_scratch(int groups, int c, int s, int f, int n_events,
                                    long long* groups_floats, long long* bias_floats) {
  *groups_floats = (long long)groups * c * f + ticket_count(c, s, f);
  *bias_floats = (long long)ceil_div(n_events, BIAS_EVENTS) * f;
  return 0;
}

// All pointers are device pointers. d_out is [n_events, f] contiguous; rows
// [n, c]; k3 [c, s, f]; take1, ev1 [groups, max_slots]; site1 [groups].
// d_rows [n, c], d_k3 [c, s, f] and d_bias [f] are written in full (d_bias
// and bias_part may be null: no bias). dkg_part and bias_part are scratch of
// the sizes above. Launches two grids on `stream` (the first only with rows,
// events or outputs, the second only with outputs) and returns the first
// launch error (0 on success) without synchronising. The kernel keeps no
// state between calls, so calls on several streams may run at once.
int site_grouped_matmul_bwd(const float* d_out, const float* rows, const float* k3,
                            const int32_t* take1, const int32_t* ev1, const int32_t* site1,
                            float* d_rows, float* d_k3, float* d_bias, float* dkg_part,
                            float* bias_part, int n, int groups, int max_slots, int c, int s,
                            int f, int n_events, void* stream) {
  if (s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* tickets = reinterpret_cast<int*>(dkg_part + (int64_t)groups * c * f);
  const int64_t outputs = (int64_t)c * s * f + (d_bias != nullptr ? f : 0);
  const int bias_parts = d_bias != nullptr ? ceil_div(n_events, BIAS_EVENTS) : 0;
  const int row_blocks = ceil_div(n, ZERO_ROWS);
  int zero_blocks = row_blocks > bias_parts ? row_blocks : bias_parts;
  if (outputs > 0 && zero_blocks == 0) zero_blocks = 1;   // the tickets
  cudaError_t err;
  if (zero_blocks > 0) {
    zero_rows_bias_kernel<<<zero_blocks, THREADS, 0, st>>>(
        d_out, d_rows, d_bias != nullptr ? bias_part : nullptr, tickets, n, c, n_events, f,
        static_cast<int>(ticket_count(c, s, f)));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (outputs == 0) return 0;
  if (c == 8 && f == 50) {
    auto kernel = site_head_bwd_kernel<8, 50>;
    const size_t smem = group_smem_bytes(8, 50, groups);
    static DeviceCache allowed;
    err = allow_smem(kernel, smem, allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_dependent(kernel, dim3(groups > 0 ? groups : 1), smem, st, d_out, rows, k3,
                            take1, ev1, site1, bias_part, d_rows, d_k3, d_bias, dkg_part,
                            tickets, groups, max_slots, s, n_events, bias_parts);
  }
  return launch_tiled(d_out, rows, k3, take1, ev1, site1, bias_part, d_rows, d_k3, d_bias,
                      dkg_part, tickets, groups, max_slots, c, s, f, n_events, bias_parts, st);
}

const char* wf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
