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
// Bound on the H100: bytes, and below them the latency of dependent grids.
// With C = 8 and F = 50 a live slot costs 2·2·C·F = 1600 FLOP against ~C·8
// bytes of row in and out and 200 bytes of d_out; the training layout's
// ~10^4 live slots move ~3 MB with the weights and their gradient, 1 µs at
// 3.35 TB/s, while one grid costs a few µs to launch and drain.
//
// Design: two grids, the second a programmatic dependent launch.
// * Grid 1 zeroes d_rows (which rows sit in no slot is known only from the
//   whole layout) and the sites' tickets, and sums d_out over runs of
//   BIAS_EVENTS events, in a fixed order (column_sums), into per-block
//   partials of d_bias.
// * Grid 2: one block per site group. It loads its first TILE = 256 slots,
//   the sites of all groups and its [C, F] weight slice together, lists the
//   groups of its site (warp ballots over site1, in group order), then
//   walks its MAX slots TILE at a time (one tile at the training layout's
//   MAX = 128): it lists the tile's filled slots in slot order, gathers
//   their rows and d_out rows into shared memory (zero where the slot is
//   not live), adds the tile's products into the group's [C, F] gradient,
//   which a thread owns entry by entry in shared memory, slot by slot in
//   order, and only then waits for grid 1 (griddepcontrol.wait) to store
//   each listed slot's d_rows row. So all its loads and products overlap
//   grid 1. The training head's (C, F) = (8, 50) has an instantiation of
//   its own (loops unrolled, indices divided by constants); other widths
//   take the runtime one. Where the weight slice, its gradient and a tile's
//   rows and d_out rows exceed the block's shared memory (SubMPSD_w128's
//   head, (C, F) = (128, 199): 199 KB for the slice and its gradient
//   alone), the listed slots are staged and multiplied a chunk of fewer
//   slots at a time (the largest power of two that fits, 16 there), in
//   list order, so the sums keep a fixed order.
// * The sum over a site's groups needs no third grid: where the site has
//   one group (G = S, every layout host_site_layout builds) the block
//   stores its gradient into d_k3 directly. Otherwise it writes it to a
//   [G, C, F] scratch buffer, waits for grid 1 and takes an integer ticket
//   of its site; the last of the site's groups to arrive sums their
//   gradients in group order. The tickets lie in the call's scratch and
//   grid 1 zeroes them, so no memset precedes a call and calls on several
//   streams may run at once. Stitched layouts
//   (G > S, a site in several groups, sites outside [1, S] clamped) take
//   that branch. Sites with no group get zeros from the blocks that own
//   them (site ≡ block mod grid size), and block 0 sums d_bias's partials in
//   block order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = THREADS;       // slots a group's block lists at a time (and stages, where they fit)
constexpr int ZERO_ROWS = 256;      // d_rows rows a block of grid 1 zeroes
constexpr int BIAS_EVENTS = 64;     // d_out rows a block of grid 1 sums for d_bias

int ceil_div(int a, int b) { return (a + b - 1) / b; }

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
                      int n_events, int f, int s) {
  __shared__ float part_s[THREADS];
  // the group grid may start now; it waits for this grid before its stores
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int b = blockIdx.x, t = threadIdx.x;
  for (int i = b * THREADS + t; i < s; i += gridDim.x * THREADS) tickets[i] = 0;
  const int64_t z1 = (int64_t)min(n, (b + 1) * ZERO_ROWS) * c;
  for (int64_t i = (int64_t)b * ZERO_ROWS * c + t; i < z1; i += THREADS) d_rows[i] = 0.f;
  const int e0 = b * BIAS_EVENTS;
  if (bias_part == nullptr || e0 >= n_events) return;
  column_sums(d_out + (int64_t)e0 * f, min(n_events - e0, BIAS_EVENTS), f,
              bias_part + (int64_t)b * f, part_s);
}

// Bytes of grid 2's dynamic shared memory: the weight slice and the group's
// gradient [C, F] each, the staged rows [tile, C] and d_out rows [tile, F],
// then the clamped site of every group and the groups of the block's site.
size_t group_smem_bytes(int c, int f, int groups, int tile) {
  return sizeof(float) * (2 * (size_t)c * f + (size_t)tile * (c + f)) +
         sizeof(int) * 2 * (size_t)groups;
}

// Bytes of grid 2's static shared memory.
constexpr size_t GROUP_STATIC_BYTES = sizeof(int) * (2 * TILE + WARPS + 2) + sizeof(float) * THREADS;

// (CT, FT): the head's (C, F) where known at compile time (the training
// head's (8, 50), so that its loops unroll and its indices divide by
// constants), else (0, 0) and the runtime c, f. tile_arg: listed slots
// staged at a time for a runtime shape (TILE for a compile-time one).
template <int CT, int FT>
__global__ void __launch_bounds__(THREADS)
site_head_bwd_kernel(const float* __restrict__ d_out, const float* __restrict__ rows,
                     const float* __restrict__ k3, const int32_t* __restrict__ take1,
                     const int32_t* __restrict__ ev1, const int32_t* __restrict__ site1,
                     const float* __restrict__ bias_part, float* __restrict__ d_rows,
                     float* __restrict__ d_k3, float* __restrict__ d_bias,
                     float* __restrict__ dkg_part, int* __restrict__ tickets, int groups,
                     int max_slots, int c_arg, int s, int f_arg, int n_events, int bias_parts,
                     int tile_arg) {
  const int c = CT ? CT : c_arg, f = FT ? FT : f_arg;
  const int tile = CT ? TILE : tile_arg;
  extern __shared__ __align__(16) float smem[];
  const int cf = c * f;
  float* kg = smem;                 // [c, f] the group's weight slice
  float* acc = kg + cf;             // [c, f] the group's weight gradient
  float* rs = acc + cf;             // [tile, c] rows of a chunk of listed slots (0 where not live)
  float* ds = rs + tile * c;        // [tile, f] their d_out rows (0 where not live)
  int* site_s = reinterpret_cast<int*>(ds + tile * f);   // [groups] clamped site of each group
  int* same_s = site_s + groups;    // the groups of this block's site, in group order
  __shared__ int take_s[TILE];      // 0-based row of each listed slot
  __shared__ int ev_s[TILE];        // 0-based event of each listed slot, -1 where not live
  __shared__ int warp_n[WARPS];
  __shared__ int n_same, last;
  __shared__ float part_s[THREADS];

  const int g = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool is_group = g < groups;
  const int32_t* take_g = take1 + (int64_t)g * max_slots;
  const int32_t* ev_g = ev1 + (int64_t)g * max_slots;
  // the first tile's slots, the sites and the weight slice: loads in flight
  // together
  int take = 0, ev = 0;
  if (is_group && t < max_slots) {
    take = take_g[t];
    ev = ev_g[t];
  }
  for (int i = t; i < groups; i += THREADS) site_s[i] = clamp_site(site1[i], s);
  const int site = is_group ? clamp_site(site1[g], s) : -1;
  if (is_group) {
    for (int i = t; i < cf; i += THREADS) {
      const int cc = i / f, ff = i - cc * f;
      kg[i] = k3[((int64_t)cc * s + site) * f + ff];
      acc[i] = 0.f;
    }
  }
  __syncthreads();

  // -- the groups of the site, in group order (warp 0) -------------------------
  if (warp == 0) {
    int cnt = 0;
    for (int i0 = 0; i0 < groups; i0 += 32) {
      const int i = i0 + lane;
      const bool same = i < groups && site_s[i] == site;
      const uint32_t b = __ballot_sync(0xffffffffu, same);
      if (same) same_s[cnt + __popc(b & ((1u << lane) - 1u))] = i;
      cnt += __popc(b);
    }
    if (lane == 0) n_same = cnt;
  }
  // -- sites with no group (site ≡ block mod grid size): zeros ----------------
  for (int sp = g; sp < s; sp += gridDim.x) {
    bool mine = false;
    for (int i = t; i < groups; i += THREADS) mine |= site_s[i] == sp;
    if (__syncthreads_or(mine)) continue;
    for (int i = t; i < cf; i += THREADS) {
      const int cc = i / f, ff = i - cc * f;
      d_k3[((int64_t)cc * s + sp) * f + ff] = 0.f;
    }
  }
  __syncthreads();                  // n_same and same_s are written

  if (is_group) {
#pragma unroll 1
    for (int m0 = 0; m0 < max_slots; m0 += TILE) {
      if (m0 > 0) {
        __syncthreads();            // the last tile's readers are done
        take = ev = 0;
        if (m0 + t < max_slots) {
          take = take_g[m0 + t];
          ev = ev_g[m0 + t];
        }
      }
      // -- list the tile's filled slots, in slot order ------------------------
      const bool filled = take > 0;
      const bool live = filled && ev > 0 && ev <= n_events;
      const uint32_t b = __ballot_sync(0xffffffffu, filled);
      if (lane == 0) warp_n[warp] = __popc(b);
      __syncthreads();
      int base = 0, cnt = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        base += w < warp ? warp_n[w] : 0;
        cnt += warp_n[w];
      }
      if (filled) {
        const int pos = base + __popc(b & ((1u << lane) - 1u));
        take_s[pos] = take - 1;
        ev_s[pos] = live ? ev - 1 : -1;
      }
      __syncthreads();
      if (cnt == 0) continue;

      // -- the listed slots a chunk of at most `tile` at a time, in list order
#pragma unroll 1
      for (int k0 = 0; k0 < cnt; k0 += tile) {
        const int kn = min(cnt - k0, tile);
        if (k0 > 0) __syncthreads();  // the last chunk's readers of rs and ds are done
        const int* take_k = take_s + k0;
        const int* ev_k = ev_s + k0;
        // -- gather the chunk's rows and d_out rows (a thread's loads are
        //    independent: unrolled, they are in flight together) --------------
#pragma unroll 4
        for (int i = t; i < kn * c; i += THREADS) {
          const int m = i / c, cc = i - m * c;
          rs[i] = ev_k[m] >= 0 ? rows[(int64_t)take_k[m] * c + cc] : 0.f;
        }
#pragma unroll 4
        for (int i = t; i < kn * f; i += THREADS) {
          const int m = i / f, ff = i - m * f;
          ds[i] = ev_k[m] >= 0 ? d_out[(int64_t)ev_k[m] * f + ff] : 0.f;
        }
        __syncthreads();

        // -- the group's weight gradient, slot by slot in list order -----------
        // (four independent chains over the slots m ≡ 0..3 mod 4, added in
        // that order: a fixed order with a quarter of the latency)
        for (int i = t; i < cf; i += THREADS) {
          const int cc = i / f, ff = i - cc * f;
          float v[4] = {acc[i], 0.f, 0.f, 0.f};
          int m = 0;
          for (; m + 4 <= kn; m += 4) {
#pragma unroll
            for (int u = 0; u < 4; ++u)
              v[u] = fmaf(rs[(m + u) * c + cc], ds[(m + u) * f + ff], v[u]);
          }
          for (int u = 0; m < kn; ++m, ++u) v[u] = fmaf(rs[m * c + cc], ds[m * f + ff], v[u]);
          acc[i] = (v[0] + v[1]) + (v[2] + v[3]);
        }
        // -- d_rows of the chunk's slots: d_out row times the slice,
        //    transposed, stored once grid 1 has zeroed d_rows ------------------
        asm volatile("griddepcontrol.wait;\n" ::: "memory");
        for (int i = t; i < kn * c; i += THREADS) {
          const int m = i / c, cc = i - m * c;
          const float* d = ds + m * f;
          const float* w = kg + cc * f;
          float v[4] = {0.f, 0.f, 0.f, 0.f};
          int ff = 0;
          for (; ff + 4 <= f; ff += 4) {
#pragma unroll
            for (int u = 0; u < 4; ++u) v[u] = fmaf(d[ff + u], w[ff + u], v[u]);
          }
          for (int u = 0; ff < f; ++ff, ++u) v[u] = fmaf(d[ff], w[ff], v[u]);
          d_rows[(int64_t)take_k[m] * c + cc] = (v[0] + v[1]) + (v[2] + v[3]);
        }
      }
    }
  }

  // -- d_bias: block 0 sums grid 1's partials in block order (and waits for
  //    grid 1 in any case, so that this grid ends after it) --------------------
  if (g == 0) {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    if (d_bias != nullptr) column_sums(bias_part, bias_parts, f, d_bias, part_s);
  }
  if (!is_group) return;

  // -- the site's gradient: a plain store for a site of one group ------------
  // (each thread wrote only its own entries of acc)
  if (n_same == 1) {
    for (int i = t; i < cf; i += THREADS) {
      const int cc = i / f, ff = i - cc * f;
      d_k3[((int64_t)cc * s + site) * f + ff] = acc[i];
    }
    return;
  }
  // ... else the last of the site's groups sums them in group order (the
  // tickets are zero once grid 1 has run)
  for (int i = t; i < cf; i += THREADS) dkg_part[(int64_t)g * cf + i] = acc[i];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(&tickets[site], 1) == n_same - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = t; i < cf; i += THREADS) {
    float v = 0.f;
    for (int q = 0; q < n_same; ++q) v += __ldcg(&dkg_part[(int64_t)same_s[q] * cf + i]);
    const int cc = i / f, ff = i - cc * f;
    d_k3[((int64_t)cc * s + site) * f + ff] = v;
  }
}

template <int CT, int FT>
int launch_groups(const float* d_out, const float* rows, const float* k3, const int32_t* take1,
                  const int32_t* ev1, const int32_t* site1, const float* bias_part,
                  float* d_rows, float* d_k3, float* d_bias, float* dkg_part, int* tickets,
                  int groups, int max_slots, int c, int s, int f, int n_events, int bias_parts,
                  cudaStream_t st) {
  auto kernel = site_head_bwd_kernel<CT, FT>;
  int tile = TILE;
  if (CT == 0) {
    // stage the listed slots in the largest power-of-two chunk that fits
    // beside the weight slice and its gradient
    static int optin = 0;
    if (optin == 0) {
      int device = 0;
      cudaError_t err = cudaGetDevice(&device);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    while (tile > 1 &&
           group_smem_bytes(c, f, groups, tile) + GROUP_STATIC_BYTES > static_cast<size_t>(optin))
      tile /= 2;
  }
  const size_t smem = group_smem_bytes(c, f, groups, tile);
  static size_t allowed =   // dynamic shared memory allowed so far, beside the static
      48 * 1024 - GROUP_STATIC_BYTES;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  // a programmatic dependent launch: its blocks load and multiply while
  // grid 1 runs and wait for it before their d_rows stores
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(groups > 0 ? groups : 1);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = smem;
  config.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&config, kernel, d_out, rows, k3, take1, ev1, site1,
                                             bias_part, d_rows, d_k3, d_bias, dkg_part, tickets,
                                             groups, max_slots, c, s, f, n_events, bias_parts,
                                             tile));
}

}  // namespace

extern "C" {

// Scratch the launch needs: *groups_floats floats for the groups' weight
// gradients (G·C·F) and the sites' tickets (S int32 after them), and
// *bias_floats floats for d_bias's partials.
int site_grouped_matmul_bwd_scratch(int groups, int c, int s, int f, int n_events,
                                    long long* groups_floats, long long* bias_floats) {
  *groups_floats = (long long)groups * c * f + s;
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
        d_out, d_rows, d_bias != nullptr ? bias_part : nullptr, tickets, n, c, n_events, f, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (outputs == 0) return 0;
  return c == 8 && f == 50
      ? launch_groups<8, 50>(d_out, rows, k3, take1, ev1, site1, bias_part, d_rows, d_k3, d_bias,
                             dkg_part, tickets, groups, max_slots, c, s, f, n_events, bias_parts,
                             st)
      : launch_groups<0, 0>(d_out, rows, k3, take1, ev1, site1, bias_part, d_rows, d_k3, d_bias,
                            dkg_part, tickets, groups, max_slots, c, s, f, n_events, bias_parts,
                            st);
}

const char* wf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
