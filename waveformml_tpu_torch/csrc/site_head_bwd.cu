// Site-grouped head GEMM with its bias, backward: per site group, the
// gradients of the gathered rows and of the group's weight slice, then a
// reduction over the groups of each site, with no float atomics, so that two
// runs give the same bits.
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
// Bound on the H100: bytes, and below them the latency of three dependent
// grids. With C = 8 and F = 50 a live slot costs 2·2·C·F = 1600 FLOP against
// ~C·8 bytes of row in and out and 200 bytes of d_out; the serving layout's
// ~10^4 live slots move ~3 MB with the weights and their gradient.
//
// Design (a simple kernel that is right):
// * Grid 1 zeroes d_rows and sums d_out over runs of BIAS_EVENTS events, in
//   event order, into per-block partials of d_bias.
// * Grid 2: one block per site group. It stages its [C, F] weight slice
//   once, then walks its MAX slots TILE at a time: it lists the tile's
//   filled slots in slot order (warp ballots and a prefix over the warps),
//   gathers their rows and d_out rows into shared memory (zero where the slot
//   is not live), stores each listed slot's d_rows row, and adds the tile's
//   products into the group's [C, F] gradient, which a thread owns entry by
//   entry in shared memory, slot by slot in order. The block writes that
//   gradient to a [G, C, F] scratch buffer.
// * Grid 3 sums, for every entry of d_k3, the gradients of the groups of its
//   site in group order (a site with no group gets 0), and d_bias from the
//   partials in block order. Stitched layouts (G > S, a site in several
//   groups, sites outside [1, S] clamped) need nothing else.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;            // slots a group's block lists and stages at a time
constexpr int TILE_WARPS = TILE / 32;
constexpr int ZERO_ROWS = 256;      // d_rows rows a block of grid 1 zeroes
constexpr int BIAS_EVENTS = 32;     // d_out rows a block of grid 1 sums for d_bias

int ceil_div(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ int clamp_site(int site1, int s) { return min(max(site1 - 1, 0), s - 1); }

__global__ void __launch_bounds__(THREADS)
zero_rows_bias_kernel(const float* __restrict__ d_out, float* __restrict__ d_rows,
                      float* __restrict__ bias_part, int n, int c, int n_events, int f) {
  const int b = blockIdx.x, t = threadIdx.x;
  const int64_t z1 = (int64_t)min(n, (b + 1) * ZERO_ROWS) * c;
  for (int64_t i = (int64_t)b * ZERO_ROWS * c + t; i < z1; i += THREADS) d_rows[i] = 0.f;
  const int e0 = b * BIAS_EVENTS;
  if (bias_part == nullptr || e0 >= n_events) return;
  const int e1 = min(n_events, e0 + BIAS_EVENTS);
  for (int j = t; j < f; j += THREADS) {
    float v = 0.f;
#pragma unroll 8
    for (int e = e0; e < e1; ++e) v += d_out[(int64_t)e * f + j];
    bias_part[(int64_t)b * f + j] = v;
  }
}

// Words of grid 2's dynamic shared memory: the weight slice and the group's
// gradient [C, F] each, then the staged rows [TILE, C] and d_out rows
// [TILE, F].
size_t group_smem_bytes(int c, int f) {
  return sizeof(float) * (2 * (size_t)c * f + (size_t)TILE * (c + f));
}

__global__ void __launch_bounds__(THREADS)
site_head_bwd_kernel(const float* __restrict__ d_out, const float* __restrict__ rows,
                     const float* __restrict__ k3, const int32_t* __restrict__ take1,
                     const int32_t* __restrict__ ev1, const int32_t* __restrict__ site1,
                     float* __restrict__ d_rows, float* __restrict__ dkg_part, int max_slots,
                     int c, int s, int f, int n_events) {
  extern __shared__ __align__(16) float smem[];
  const int cf = c * f;
  float* kg = smem;                 // [c, f] the group's weight slice
  float* acc = kg + cf;             // [c, f] the group's weight gradient
  float* rs = acc + cf;             // [TILE, c] rows of the listed slots (0 where not live)
  float* ds = rs + TILE * c;        // [TILE, f] d_out rows of the listed slots (0 where not live)
  __shared__ int take_s[TILE];      // 0-based row of each listed slot
  __shared__ int ev_s[TILE];        // 0-based event of each listed slot, -1 where not live
  __shared__ int warp_n[TILE_WARPS];

  const int g = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int site = clamp_site(site1[g], s);
  for (int i = t; i < cf; i += THREADS) {
    const int cc = i / f, ff = i - cc * f;
    kg[i] = k3[((int64_t)cc * s + site) * f + ff];
    acc[i] = 0.f;
  }
  const int32_t* take_g = take1 + (int64_t)g * max_slots;
  const int32_t* ev_g = ev1 + (int64_t)g * max_slots;
#pragma unroll 1
  for (int m0 = 0; m0 < max_slots; m0 += TILE) {
    __syncthreads();                // the last tile's readers are done (and kg is written)
    // -- list the tile's filled slots, in slot order ------------------------
    int take = 0, ev = 0;
    if (t < TILE && m0 + t < max_slots) {
      take = take_g[m0 + t];
      ev = ev_g[m0 + t];
    }
    const bool filled = take > 0;
    const bool live = filled && ev > 0 && ev <= n_events;
    const uint32_t b = __ballot_sync(0xffffffffu, filled);
    if (warp < TILE_WARPS && lane == 0) warp_n[warp] = __popc(b);
    __syncthreads();
    int base = 0, cnt = 0;
#pragma unroll
    for (int w = 0; w < TILE_WARPS; ++w) {
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

    // -- gather the listed slots' rows and d_out rows (a thread's loads are
    //    independent: unrolled, they are in flight together) ----------------
#pragma unroll 4
    for (int i = t; i < cnt * c; i += THREADS) {
      const int m = i / c, cc = i - m * c;
      rs[i] = ev_s[m] >= 0 ? rows[(int64_t)take_s[m] * c + cc] : 0.f;
    }
#pragma unroll 4
    for (int i = t; i < cnt * f; i += THREADS) {
      const int m = i / f, ff = i - m * f;
      ds[i] = ev_s[m] >= 0 ? d_out[(int64_t)ev_s[m] * f + ff] : 0.f;
    }
    __syncthreads();

    // -- d_rows of the listed slots: d_out row times the slice, transposed ---
    for (int i = t; i < cnt * c; i += THREADS) {
      const int m = i / c, cc = i - m * c;
      const float* d = ds + m * f;
      const float* w = kg + cc * f;
      float v = 0.f;
      for (int ff = 0; ff < f; ++ff) v = fmaf(d[ff], w[ff], v);
      d_rows[(int64_t)take_s[m] * c + cc] = v;
    }
    // -- the group's weight gradient, slot by slot in list order -------------
    for (int i = t; i < cf; i += THREADS) {
      const int cc = i / f, ff = i - cc * f;
      float v = acc[i];
      for (int m = 0; m < cnt; ++m) v = fmaf(rs[m * c + cc], ds[m * f + ff], v);
      acc[i] = v;
    }
  }
  // each thread wrote only its own entries of acc
  for (int i = t; i < cf; i += THREADS) dkg_part[(int64_t)g * cf + i] = acc[i];
}

__global__ void __launch_bounds__(THREADS)
site_head_bwd_reduce_kernel(const float* __restrict__ dkg_part,
                            const int32_t* __restrict__ site1,
                            const float* __restrict__ bias_part, float* __restrict__ d_k3,
                            float* __restrict__ d_bias, int groups, int c, int s, int f,
                            int bias_parts) {
  extern __shared__ int site_s[];    // [groups] the clamped 0-based site of each group
  for (int i = threadIdx.x; i < groups; i += THREADS) site_s[i] = clamp_site(site1[i], s);
  __syncthreads();
  const int64_t per = (int64_t)c * s * f;
  const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx < per) {
    const int cc = static_cast<int>(idx / ((int64_t)s * f));
    const int rem = static_cast<int>(idx - cc * (int64_t)s * f);
    const int site = rem / f, ff = rem - site * f;
    float v = 0.f;
    for (int gg = 0; gg < groups; ++gg)
      if (site_s[gg] == site) v += dkg_part[((int64_t)gg * c + cc) * f + ff];
    d_k3[idx] = v;
  } else if (d_bias != nullptr && idx < per + f) {
    const int ff = static_cast<int>(idx - per);
    float v = 0.f;
#pragma unroll 8
    for (int p = 0; p < bias_parts; ++p) v += bias_part[(int64_t)p * f + ff];
    d_bias[ff] = v;
  }
}

}  // namespace

extern "C" {

// Scratch the launch needs: *groups_floats floats for the groups' weight
// gradients (G·C·F) and *bias_floats floats for d_bias's partials.
int site_grouped_matmul_bwd_scratch(int groups, int c, int f, int n_events,
                                    long long* groups_floats, long long* bias_floats) {
  *groups_floats = (long long)groups * c * f;
  *bias_floats = (long long)ceil_div(n_events, BIAS_EVENTS) * f;
  return 0;
}

// All pointers are device pointers. d_out is [n_events, f] contiguous; rows
// [n, c]; k3 [c, s, f]; take1, ev1 [groups, max_slots]; site1 [groups].
// d_rows [n, c], d_k3 [c, s, f] and d_bias [f] are written in full (d_bias
// and bias_part may be null: no bias). dkg_part and bias_part are scratch of
// the sizes above. Launches three grids on `stream` (grid 1 only with rows
// or events, grid 2 only with slots) and returns the first launch error (0
// on success) without synchronising.
int site_grouped_matmul_bwd(const float* d_out, const float* rows, const float* k3,
                            const int32_t* take1, const int32_t* ev1, const int32_t* site1,
                            float* d_rows, float* d_k3, float* d_bias, float* dkg_part,
                            float* bias_part, int n, int groups, int max_slots, int c, int s,
                            int f, int n_events, void* stream) {
  if (s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bias_parts = d_bias != nullptr ? ceil_div(n_events, BIAS_EVENTS) : 0;
  const int row_blocks = ceil_div(n, ZERO_ROWS);
  const int zero_blocks = row_blocks > bias_parts ? row_blocks : bias_parts;
  cudaError_t err;
  if (zero_blocks > 0) {
    zero_rows_bias_kernel<<<zero_blocks, THREADS, 0, st>>>(
        d_out, d_rows, d_bias != nullptr ? bias_part : nullptr, n, c, n_events, f);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool slots = groups > 0 && max_slots > 0;
  if (slots) {
    const size_t smem = group_smem_bytes(c, f);
    static size_t allowed = 48 * 1024;   // dynamic shared memory allowed so far
    if (smem > allowed) {
      err = cudaFuncSetAttribute(site_head_bwd_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      allowed = smem;
    }
    site_head_bwd_kernel<<<groups, THREADS, smem, st>>>(d_out, rows, k3, take1, ev1, site1,
                                                        d_rows, dkg_part, max_slots, c, s, f,
                                                        n_events);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t outputs = (int64_t)c * s * f + (d_bias != nullptr ? f : 0);
  if (outputs == 0) return 0;
  const int reduce_groups = slots ? groups : 0;
  const size_t reduce_smem = sizeof(int) * (size_t)reduce_groups;
  static size_t reduce_allowed = 48 * 1024;   // dynamic shared memory allowed so far
  if (reduce_smem > reduce_allowed) {
    err = cudaFuncSetAttribute(site_head_bwd_reduce_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(reduce_smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    reduce_allowed = reduce_smem;
  }
  site_head_bwd_reduce_kernel<<<static_cast<int>((outputs + THREADS - 1) / THREADS), THREADS,
                                reduce_smem, st>>>(dkg_part, site1, bias_part, d_k3, d_bias,
                                                   reduce_groups, c, s, f, bias_parts);
  return static_cast<int>(cudaGetLastError());
}

const char* wf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
