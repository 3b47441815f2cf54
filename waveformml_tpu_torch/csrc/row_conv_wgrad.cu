// Row-space submanifold convolution, weight and bias gradient, in two
// designs, both with a fixed-order reduction and no float atomics, so that
// two runs give the same bits: the centre tap as a split-K GEMM on the
// tensor cores (TF32, 3-pass split, fp32 accuracy) and the other taps over
// listed row pairs, for 2D windows and wide channels ("tiles"); and a
// row-chunked FFMA pass over all 27 taps of the 3x3x3 window at narrow
// channels ("taps").
//
// Both replace d_kernel and d_bias of waveformml_tpu/ops/row_conv.py:_subm_bwd
// (:257-268), which XLA ran on the TPU as a gather into an [N, K², Cin]
// operand contracted against the masked cotangent g over the rows:
//
//   dW[k] = Σ_r mask[r] · feats[plan[r, k]]ᵀ g[r]      (plan = -1 → 0)
//   db    = Σ_r mask[r] · g[r]
//
// Dispatch (ops/row_conv.py row_design, on the host, the same rule as K1's):
// K² = 27 with Cin ≤ 16 and Cout ≤ 16 runs "taps"
// (subm_conv_rows_wgrad_taps); every other shape runs "tiles"
// (subm_conv_rows_wgrad), the 9-tap convs of every 2D config among them.
//
// Bound on the H100: bytes, in both. Tiles, 2D: at the SubMPSD training
// shapes (N = 12288 rows, ~10^4 real, Cin·Cout = 130·104, 104·56, 56·8) the
// centre tap, present for every real row, holds ~91% of the row-taps;
// three TF32 passes of its 2·Cin·Cout FLOP per row at 495 TFLOP/s take less
// time than reading feats and g once at 3.35 TB/s. So the design reads
// each operand once and keeps the partial sums small. Taps, 3D: the plan
// (108 bytes a row, 10.5 MB at SCNet3D.json's ~97k rows of 4096 events)
// and g (3.1 MB at 8 channels) are read once, feats (0.78 MB) gathered:
// ~4-5 µs; the ~295k row-taps at Cin 2, Cout 8 are 9.4 MFLOP.
//
// Design "tiles":
// * Grid 1, the centre tap as split-K: M = Cin + 1, N = Cout, K = rows.
//   Block x owns the contiguous rows [x·cr, x·cr + cr) (cr chosen so that
//   ~128 blocks fill the card) and, at every width up to 143 + 1 input and
//   128 output channels, the whole (Cin + 1, Cout) tile in its registers
//   (144 x 104 at layer 0: 72 accumulators a thread), so feats and g are
//   read from device memory once a layer. Wider layers split into channel
//   tiles on grid.y.
// * db is row Cin of the same product: column Cin of the staged feats rows
//   is 1 where the mask is on, so it needs no row loop of its own.
// * Staging: BR-row steps of feats rows (through plan[:, centre], which may
//   name another row for duplicate sites; zero where absent or masked) and
//   g rows (zero where masked) by cp.async into a ring of NSTAGE buffers;
//   a step whose rows are all masked is neither loaded nor multiplied. Row
//   strides ≡ 8 mod 16 words put a warp's fragment loads on 32 banks.
// * Arithmetic: mma.sync.m16n8k8 TF32 with K1's 3-pass split (small·big +
//   big·small + big·big, dropping only ~2^-22 relative; the helpers are
//   tf32_mma.cuh's, shared with row_conv.cu). A warp owns NTW
//   8-column tiles and all MT 16-row tiles; where the output is narrow (k=1
//   layer: 8 columns) the warps split the block's k-steps instead (wk
//   groups, merged in group order in shared memory). Each pass runs over 3
//   m-tiles' accumulators before the next, with no branch between the mma.
//   Registers are bounded at 128 so that two blocks fit an SM, of grid 1
//   or of grid 2 (layer 0 ran faster so than at 163 registers).
// * The other taps: each block reads its rows' [cr, K²] plan once,
//   coalesced, into shared memory, and lists for each other tap, in row
//   order (warp ballots), the (source row, row) pairs present into a
//   per-(block, tap) list in scratch. The second grid multiplies them.
// * Reduction (deterministic, no float atomics): thread-block clusters of
//   CL = 8 blocks. Each block merges its warps' sums into a tile in its own
//   shared memory; after a cluster barrier, rank q sums slice q of the tile
//   over the cluster's 8 blocks through distributed shared memory in rank
//   order, and writes it to scratch: one partial per cluster (16 at layer
//   0, 1 MB) where one per block would be 7.7 MB, as large as feats and g.
//   A second grid, a programmatic dependent launch (its blocks start once
//   every block of grid 1 runs, and wait for grid 1 to end with
//   griddepcontrol.wait before they read anything), sums the clusters'
//   partials in cluster order into dW[centre] and db, and gives each
//   (other tap, 32x32 channel tile) a block that gathers the tap's pairs
//   from the lists in block order (a prefix over the blocks' counts) and
//   accumulates their products in FFMA (each tap ~1% of the row-taps in
//   2D). The kernel keeps no state between calls, so calls on several
//   streams may run at once. The tap blocks could start on a count of grid
//   1's blocks whose lists are out: a count shared by all calls saved ~10%
//   but is unsafe across streams, and one in the call's scratch needs a
//   memset first, which cost most of that gain on the card. A last-block
//   ticket for the centre sum was not taken: one block would then read
//   every partial alone.
// * Measured on the card, the centre grid is what sets the time: its fixed
//   steps (plan and mask loads, the lists, the merge, the cluster sum),
//   the operand loads and the 3-pass mma each take a comparable share of
//   it at layer 0, and overlap little, with one or two blocks on an SM.
// * Why it loses at 27 taps and narrow channels: the dt = ±1 taps are
//   present for ~86k rows each of SCNet3D's ~97k, not ~1%. Their tap
//   blocks (one per 32x32 channel tile: 26 blocks on 132 SMs at Cin 2,
//   Cout 8) each walk 86k pairs alone, ~675 steps of 128 pairs with two
//   barriers and a binary search a pair, 16 of each tile's 1024 products
//   real; and grid 1 writes a [26, cr] pair list for every row block,
//   ~20 MB of scratch (2.73904 ms on an H100 against a library line of
//   0.08066; PERF.md).
//
// Design "taps" (two grids, no pair lists):
// * Grid 1: 512-thread blocks of at most 64 registers a thread, two an SM
//   (the SMs read from the device: 264 blocks in one wave on an H100;
//   fewer where a partial is large), sized in C
//   (subm_conv_rows_wgrad_taps_scratch gives the host the scratch), each owning
//   a run of rows (384 at SCNet3D's ~97k) staged TAP_CH = 384 at a time:
//   plan rows [384, 27] (16-byte loads where aligned), g rows [384, CO] and
//   the mask, coalesced, by loads that do not wait for one another; then g
//   is zeroed where the mask is off, and the plan is read through the mask.
// * A thread owns an item: a (tap, input channel) pair, or db's pair of
//   ones, and a row lane; at Cin 2 the 55 pairs take 9 row lanes, at 16 the
//   433 pairs one. It walks its lane's rows TAP_U = 4 at a time: gathers
//   feats[plan[r, tap], c] from L2 (0.78 MB at 2 channels, stays resident)
//   for the 4 rows, then adds each times the row's g into CO fp32 registers
//   (FFMA). An absent tap reads nothing; items are pair-major, so a warp
//   holds few taps, and a step that no row of its taps has is skipped by
//   the whole warp.
// * The block sums its row lanes in lane order in shared memory and writes
//   one partial [(27·Cin + 1)·Cout] to scratch, entry-major ([entry,
//   block]) so that grid 2 reads it coalesced.
// * Grid 2, a programmatic dependent launch triggered when grid 1's blocks
//   end (triggered at their start, its waiting blocks held SMs grid 1
//   used), gives each output a warp: lane l sums blocks l, l + 32, ... in
//   order, then a butterfly of shuffles; it waits for grid 1 with
//   griddepcontrol.wait before reading. Every sum has a fixed order, so two
//   runs give the same bits.
// * Measured at SCNet3D's shape (Cin 2, Cout 8; PERF.md): grid 1
//   sets the time, and it scales with a block's rows, not with the
//   gathers or the products (turning either off moved it <10%). Tried and
//   slower or no faster: 256-thread blocks of two items a thread (2 blocks
//   an SM at 88 registers: two waves), 8 rows a step, and gathering each
//   chunk's features into shared memory before the products (more integer
//   work than it saved); 384-row staging gained ~10% over 128.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "device_cache.cuh"
#include "tf32_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BR = 32;             // rows per pipeline step (4 mma k-steps)
constexpr int NSTAGE = 3;          // ring buffers
constexpr int CL = 8;              // blocks per cluster
constexpr int TARGET_BLOCKS = 128; // row blocks aimed at (one wave)
constexpr int CR_MAX = 512;        // most rows per block
constexpr int MAX_MT = 9;          // 16-row tiles of (Cin + 1) per block: 144 channels
constexpr int MAX_TW = 128;        // output channels per block
// the other taps' grid: FFMA tiles of TI x TO channels, BR2 pairs a step
constexpr int TI = 32, TO = 32, MI = 2, MO = 2;
constexpr int BR2 = 128;
constexpr int WINDOW = 512;        // pairs gathered into shared memory at a time
constexpr int LOADS = BR2 * TI / THREADS;
static_assert(TI == TO, "one index map stages both operands");
static_assert((TI / MI) * (TO / MO) == THREADS, "one micro tile per thread");

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
int round_up(int a, int b) { return ceil_div(a, b) * b; }

// row stride (words) of a staged operand of width w: ≡ 8 mod 16, so that a
// fragment load's 4 rows x 8 columns hit 32 banks
__host__ __device__ inline int stride_of(int w) { return (w + 7) / 16 * 16 + 8; }

struct Geometry {
  int cr, blocks, clusters;       // rows per block, row blocks (a multiple of CL)
  int mt, ci_tiles;               // 16-row tiles of a block's (Cin + 1) slice, slices
  int tw, co_tiles;               // output channels of a block (a multiple of 8), tiles
  int ntw, wn, wk;                // n-tiles a warp, warps along n, k-step groups
  int ring_words, smem;           // shared memory of grid 1
};

Geometry geometry(int n, int cin, int cout, int kk) {
  Geometry g{};
  g.cr = n > 0 ? std::min(CR_MAX, std::max(BR, round_up(ceil_div(n, TARGET_BLOCKS), BR))) : BR;
  g.blocks = n > 0 ? round_up(ceil_div(n, g.cr), CL) : 0;
  g.clusters = g.blocks / CL;
  g.ci_tiles = ceil_div(cin + 1, MAX_MT * 16);
  g.mt = ceil_div(ceil_div(cin + 1, g.ci_tiles), 16);
  g.co_tiles = std::max(1, ceil_div(cout, MAX_TW));
  g.tw = std::max(8, round_up(ceil_div(cout, g.co_tiles), 8));
  const int nt = g.tw / 8;
  g.ntw = nt > WARPS ? 2 : 1;
  g.wn = ceil_div(nt, g.ntw);
  g.wk = std::min(4, WARPS / g.wn);
  const int mw = g.mt * 16;
  g.ring_words = std::max(NSTAGE * BR * (stride_of(mw) + stride_of(g.tw)), mw * g.tw);
  g.smem = static_cast<int>(sizeof(float)) * g.ring_words +
           static_cast<int>(sizeof(int)) * (g.cr * kk + g.cr + g.cr / BR);
  return g;
}

// Grid 1. Block (x, y): rows [x·cr, x·cr + cr), input channels [m0, m0 +
// 16·MT) of the (Cin + 1) rows of the product (row Cin: db) and output
// channels [o0, o0 + tw). Writes its cluster's partial, rows m0.. of
// partial[cluster] [Cin + 1, Cout], and (y = 0, K² > 1) its other taps'
// pair lists and counts.
template <int MT, int NTW>
__global__ void __launch_bounds__(THREADS, 2)
wgrad_centre_kernel(const float* __restrict__ feats, const int32_t* __restrict__ plan,
                    const float* __restrict__ g, const uint8_t* __restrict__ mask,
                    float* __restrict__ partial, int2* __restrict__ lists,
                    int* __restrict__ counts, int n, int cin, int cout, int kk, int cr,
                    int co_tiles, int tw, int wn, int wk, int ring_words, int vec_f,
                    int vec_g) {
  constexpr int MW = MT * 16;
  const int sf = stride_of(MW), sg = stride_of(tw);
  const int stage_words = BR * (sf + sg);
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                   // NSTAGE x [BR x sf | BR x sg]; then the tile
  int* plan_s = reinterpret_cast<int*>(smem + ring_words);  // [cr, kk], -1 where masked
  int* msk_s = plan_s + cr * kk;                        // [cr] mask
  int* live_s = msk_s + cr;                             // [cr / BR] any row of the step on

  // the reduction grid may start now; it waits for this grid before reading
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int row0 = blockIdx.x * cr;
  const int rows_here = max(0, min(cr, n - row0));
  const int centre = kk / 2;
  const int m0 = (blockIdx.y / co_tiles) * MW, o0 = (blockIdx.y % co_tiles) * tw;
  const int steps = cr / BR;

  // -- the block's plan rows, read once, coalesced ----------------------------
  for (int i = t; i < steps; i += THREADS) live_s[i] = 0;
  __syncthreads();
  for (int i = t; i < cr; i += THREADS) {
    const bool on = i < rows_here && mask[row0 + i] != 0;
    msk_s[i] = on;
    if (on) live_s[i / BR] = 1;
  }
  const int32_t* plan_b = plan + (int64_t)row0 * kk;
  for (int i = t; i < cr * kk; i += THREADS) {
    const int r = i / kk;
    plan_s[i] = r < rows_here && mask[row0 + r] != 0 ? plan_b[i] : -1;
  }
  __syncthreads();

  // -- staging of step s: feats rows through the centre tap, g rows, and the
  //    ones column of db ---------------------------------------------------------
  const int fc = max(0, min(MW, cin - m0));             // feats channels of the slice
  const int f_per = fc / vec_f;                         // copies a row
  const int gc = max(0, min(tw, cout - o0));
  const int g_per = gc / vec_g;
  const int ones = cin - m0;                            // the ones column, if in [0, MW)
  auto issue = [&](int s) {
    float* f_s = ring + (s % NSTAGE) * stage_words;
    float* g_s = f_s + BR * sf;
    const int rb = s * BR;
    for (int idx = t; idx < BR * f_per; idx += THREADS) {
      const int j = idx / f_per, c = (idx - j * f_per) * vec_f;
      const int src = plan_s[(rb + j) * kk + centre];
      cp_async(f_s + j * sf + c, src >= 0 ? feats + (int64_t)src * cin + m0 + c : feats,
               src >= 0, vec_f);
    }
    for (int idx = t; idx < BR * g_per; idx += THREADS) {
      const int j = idx / g_per, c = (idx - j * g_per) * vec_g;
      const bool on = msk_s[rb + j] != 0;
      cp_async(g_s + j * sg + c, on ? g + (int64_t)(row0 + rb + j) * cout + o0 + c : g, on,
               vec_g);
    }
    if (ones >= 0 && ones < MW)
      for (int j = t; j < BR; j += THREADS) f_s[j * sf + ones] = msk_s[rb + j] ? 1.f : 0.f;
  };

#pragma unroll 1
  for (int p = 0; p < NSTAGE - 1; ++p) {
    if (p < steps && live_s[p]) issue(p);
    cp_async_commit();
  }

  // -- the other taps' pairs, listed in row order, one tap per warp ----------
  if (blockIdx.y == 0 && kk > 1) {
    for (int q = warp; q < kk - 1; q += WARPS) {
      const int tap = q + (q >= centre);
      int2* out = lists + ((int64_t)blockIdx.x * (kk - 1) + q) * cr;
      int cnt = 0;
      for (int i0 = 0; i0 < rows_here; i0 += 32) {
        const int i = i0 + lane;
        const int src = i < rows_here ? plan_s[i * kk + tap] : -1;
        const uint32_t b = __ballot_sync(0xffffffffu, src >= 0);
        if (src >= 0) out[cnt + __popc(b & ((1u << lane) - 1u))] = make_int2(src, row0 + i);
        cnt += __popc(b);
      }
      if (lane == 0) counts[blockIdx.x * (kk - 1) + q] = cnt;
    }
  }

  // -- the centre product ------------------------------------------------------
  const int gid = lane >> 2, tig = lane & 3;
  const int wn_i = warp % wn, wk_i = warp / wn;
  const bool active = wk_i < wk;
  const int nt = tw / 8;
  bool q_on[NTW];
#pragma unroll
  for (int q = 0; q < NTW; ++q) q_on[q] = wn_i * NTW + q < nt;
  float acc[MT][NTW][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < NTW; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();                 // step s has landed; step s-1's buffer is free
    const int next = s + NSTAGE - 1;
    if (next < steps && live_s[next]) issue(next);
    cp_async_commit();
    if (!live_s[s] || !active) continue;
    const float* f_s = ring + (s % NSTAGE) * stage_words;
    const float* g_s = f_s + BR * sf;
#pragma unroll 1
    for (int ks = wk_i; ks < BR / 8; ks += wk) {
      const int kb = ks * 8;
      uint32_t bb[NTW][2], bs[NTW][2];
#pragma unroll
      for (int q = 0; q < NTW; ++q) {
        // B[k][n] = g row kb + k, channel n: b0 (tig, gid), b1 (tig + 4, gid)
        const float* x = g_s + (kb + tig) * sg + (wn_i * NTW + q) * 8 + gid;
        const float x0 = q_on[q] ? x[0] : 0.f, x1 = q_on[q] ? x[4 * sg] : 0.f;
        split(x0, bb[q][0], bs[q][0]);
        split(x1, bb[q][1], bs[q][1]);
      }
      // MG m-tiles at a time: each pass runs over all their accumulators
      // before the next, so that consecutive mma are independent; no branch
      // lies between them (a tile past Cout multiplies zeros)
      constexpr int MG = MT < 3 ? MT : 3;
#pragma unroll
      for (int m0 = 0; m0 < MT; m0 += MG) {
        uint32_t ab[MG][4], as[MG][4];
#pragma unroll
        for (int j = 0; j < MG; ++j) {
          // A[m][k] = feats row kb + k, channel m: a0 (gid, tig), a1 (gid + 8,
          // tig), a2 (gid, tig + 4), a3 (gid + 8, tig + 4)
          const float* a = f_s + (kb + tig) * sf + min(m0 + j, MT - 1) * 16 + gid;
          split(a[0], ab[j][0], as[j][0]);
          split(a[8], ab[j][1], as[j][1]);
          split(a[4 * sf], ab[j][2], as[j][2]);
          split(a[4 * sf + 8], ab[j][3], as[j][3]);
        }
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
#pragma unroll
          for (int j = 0; j < MG; ++j)
#pragma unroll
            for (int q = 0; q < NTW; ++q)
              if (m0 + j < MT)
                mma_tf32(acc[min(m0 + j, MT - 1)][q], pass == 0 ? as[j] : ab[j],
                         pass == 1 ? bs[q] : bb[q]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                   // the ring is free: it holds the tile now

  // -- the warps' sums into the block's tile [MW, tw], k-step groups in order --
  float* tile_s = ring;
#pragma unroll 1
  for (int r = 0; r < wk; ++r) {
    if (active && wk_i == r) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < NTW; ++q) {
          if (!q_on[q]) continue;
          // c0 (gid, 2tig), c1 (gid, 2tig+1), c2 (gid+8, 2tig), c3 (gid+8, 2tig+1)
          float* p0 = tile_s + (mt * 16 + gid) * tw + (wn_i * NTW + q) * 8 + 2 * tig;
          float* p1 = p0 + 8 * tw;
          const float* c = acc[mt][q];
          if (r == 0) {
            p0[0] = c[0]; p0[1] = c[1]; p1[0] = c[2]; p1[1] = c[3];
          } else {
            p0[0] += c[0]; p0[1] += c[1]; p1[0] += c[2]; p1[1] += c[3];
          }
        }
    }
    __syncthreads();
  }

  // -- the cluster's sum: rank q sums slice q over the 8 blocks in rank order
  cluster.sync();
  const int rank = static_cast<int>(cluster.block_rank());
  const int per_rank = MW * tw / 4 / CL;                // float4s of a slice
  const float4* remote[CL];
#pragma unroll
  for (int p = 0; p < CL; ++p)
    remote[p] = reinterpret_cast<const float4*>(cluster.map_shared_rank(tile_s, p));
  float* part = partial + (int64_t)(blockIdx.x / CL) * (cin + 1) * cout;
  for (int e = rank * per_rank + t; e < (rank + 1) * per_rank; e += THREADS) {
    float4 v = remote[0][e];
#pragma unroll
    for (int p = 1; p < CL; ++p) {
      const float4 w = remote[p][e];
      v.x += w.x; v.y += w.y; v.z += w.z; v.w += w.w;
    }
    const int m = e * 4 / tw, nn = e * 4 - m * tw;
    const int i = m0 + m;
    if (i > cin) continue;
    const float vals[4] = {v.x, v.y, v.z, v.w};
    float* out = part + (int64_t)i * cout + o0 + nn;
#pragma unroll
    for (int h = 0; h < 4; ++h)
      if (o0 + nn + h < cout) out[h] = vals[h];
  }
  cluster.sync();                    // no block leaves while the others read its tile
}

// Grid 2, a programmatic dependent launch. Blocks [0, sum_blocks): each
// entry of the (Cin + 1, Cout) centre product summed over the clusters'
// partials in cluster order, into dW[centre] and db. Then one block per
// (other tap, 32x32 channel tile): the tap's pairs, gathered from the
// blocks' lists in block order, multiplied in FFMA in list order.
__global__ void __launch_bounds__(THREADS)
wgrad_reduce_kernel(const float* __restrict__ feats, const float* __restrict__ g,
                    const float* __restrict__ partial, const int2* __restrict__ lists,
                    const int* __restrict__ counts, float* __restrict__ dw,
                    float* __restrict__ db, int cin, int cout, int kk, int clusters,
                    int blocks, int cr, int sum_blocks, int tiles_o) {
  extern __shared__ int prefix_s[];                    // [blocks + 1] the tap's pairs before each block
  __shared__ __align__(16) float a_s[BR2][TI];          // gathered feats rows
  __shared__ __align__(16) float b_s[BR2][TO];          // g rows
  __shared__ int src_s[WINDOW];
  __shared__ int row_s[WINDOW];
  __shared__ int warp_s[WARPS];

  const int t = threadIdx.x;
  const int centre = kk / 2;
  // the partials and the pair lists are complete only when grid 1 is
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (static_cast<int>(blockIdx.x) < sum_blocks) {
    const int64_t per = (int64_t)(cin + 1) * cout;
    const int64_t e = (int64_t)blockIdx.x * THREADS + t;
    if (e >= per) return;
    float v = 0.f;
#pragma unroll 8
    for (int c = 0; c < clusters; ++c) v += partial[c * per + e];
    const int i = static_cast<int>(e / cout), o = static_cast<int>(e - (int64_t)i * cout);
    if (i < cin)
      dw[((int64_t)centre * cin + i) * cout + o] = v;
    else if (db != nullptr)
      db[o] = v;
    return;
  }

  const int tiles = ceil_div(cin, TI) * tiles_o;
  const int qb = blockIdx.x - sum_blocks;
  const int other = qb / tiles, tile = qb % tiles;
  const int tap = other + (other >= centre);
  const int i0 = (tile / tiles_o) * TI, o0 = (tile % tiles_o) * TO;

  // -- prefix over the blocks' counts of this tap, in block order: each
  //    thread's run of blocks, a warp scan, then the warps' totals ---------------
  const int lane = t & 31, warp = t >> 5;
  const int per = ceil_div(blocks, THREADS);
  int s = 0;
  for (int k = 0; k < per; ++k) {
    const int b = t * per + k;
    if (b < blocks) s += __ldcg(&counts[b * (kk - 1) + other]);
  }
  int v = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) warp_s[warp] = v;
  __syncthreads();
  int run = v - s;
  for (int w = 0; w < warp; ++w) run += warp_s[w];
  if (t == THREADS - 1) prefix_s[blocks] = run + s;
  for (int k = 0; k < per; ++k) {
    const int b = t * per + k;
    if (b < blocks) {
      prefix_s[b] = run;
      run += __ldcg(&counts[b * (kk - 1) + other]);
    }
  }
  __syncthreads();
  const int total = prefix_s[blocks];

  const int ti = t % (TI / MI), to = t / (TI / MI);
  float acc[MI][MO];
#pragma unroll
  for (int a = 0; a < MI; ++a)
#pragma unroll
    for (int b = 0; b < MO; ++b) acc[a][b] = 0.f;
  float ra[LOADS], rb[LOADS];
#pragma unroll 1
  for (int w0 = 0; w0 < total; w0 += WINDOW) {
    const int cnt = min(WINDOW, total - w0);
    // -- the window's pairs: pair l lies in the last block whose prefix <= l
    for (int l = t; l < cnt; l += THREADS) {
      const int pos = w0 + l;
      int lo = 0, hi = blocks;                          // prefix_s[lo] <= pos < prefix_s[hi]
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (prefix_s[mid] <= pos) lo = mid; else hi = mid;
      }
      const int2 pr = __ldcg(&lists[((int64_t)lo * (kk - 1) + other) * cr + pos - prefix_s[lo]]);
      src_s[l] = pr.x;
      row_s[l] = pr.y;
    }
    __syncthreads();
    // -- BR2 pairs at a time: stage (one step ahead in registers), accumulate
    const int steps = ceil_div(cnt, BR2);
    auto load = [&](int step) {
#pragma unroll
      for (int q = 0; q < LOADS; ++q) {
        const int idx = q * THREADS + t;
        const int j = idx / TI, c = idx % TI;
        const int l = step * BR2 + j;
        const bool ok = l < cnt;
        ra[q] = ok && i0 + c < cin ? feats[(int64_t)src_s[l] * cin + i0 + c] : 0.f;
        rb[q] = ok && o0 + c < cout ? g[(int64_t)row_s[l] * cout + o0 + c] : 0.f;
      }
    };
    load(0);
#pragma unroll 1
    for (int st = 0; st < steps; ++st) {
      __syncthreads();               // the last step's readers of a_s, b_s are done
#pragma unroll
      for (int q = 0; q < LOADS; ++q) {
        const int idx = q * THREADS + t;
        a_s[idx / TI][idx % TI] = ra[q];
        b_s[idx / TO][idx % TO] = rb[q];
      }
      __syncthreads();
      if (st + 1 < steps) load(st + 1);
#pragma unroll 8
      for (int j = 0; j < min(BR2, cnt - st * BR2); ++j) {
        const float2 a = *reinterpret_cast<const float2*>(&a_s[j][ti * MI]);
        const float2 b = *reinterpret_cast<const float2*>(&b_s[j][to * MO]);
        const float av[MI] = {a.x, a.y};
        const float bv[MO] = {b.x, b.y};
#pragma unroll
        for (int x = 0; x < MI; ++x)
#pragma unroll
          for (int y = 0; y < MO; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
      }
    }
    __syncthreads();                 // src_s, row_s are rewritten by the next window
  }
  float* out = dw + (int64_t)tap * cin * cout;
#pragma unroll
  for (int x = 0; x < MI; ++x) {
    const int i = i0 + ti * MI + x;
    if (i >= cin) continue;
#pragma unroll
    for (int y = 0; y < MO; ++y) {
      const int o = o0 + to * MO + y;
      if (o < cout) out[(int64_t)i * cout + o] = acc[x][y];
    }
  }
}

int copy_width(int count, const void* ptr) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(ptr);
  if (count % 4 == 0 && p % 16 == 0) return 4;
  if (count % 2 == 0 && p % 8 == 0) return 2;
  return 1;
}

template <int MT, int NTW>
int launch_centre(const Geometry& geo, const float* feats, const int32_t* plan, const float* g,
                  const uint8_t* mask, float* partial, int2* lists, int* counts, int n, int cin,
                  int cout, int kk, cudaStream_t stream) {
  auto kernel = wgrad_centre_kernel<MT, NTW>;
  static DeviceCache configured;   // dynamic shared memory allowed so far, per device
  const cudaError_t err = raise_per_device(configured, geo.smem, [&] {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(geo.blocks, geo.ci_tiles * geo.co_tiles);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = geo.smem;
  config.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CL;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &config, kernel, feats, plan, g, mask, partial, lists, counts, n, cin, cout, kk, geo.cr,
      geo.co_tiles, geo.tw, geo.wn, geo.wk, geo.ring_words, copy_width(cin, feats),
      copy_width(cout, g)));
}

template <int NTW>
int dispatch_mt(const Geometry& geo, const float* feats, const int32_t* plan, const float* g,
                const uint8_t* mask, float* partial, int2* lists, int* counts, int n, int cin,
                int cout, int kk, cudaStream_t st) {
#define WGRAD_MT(MT) \
  case MT: return launch_centre<MT, NTW>(geo, feats, plan, g, mask, partial, lists, counts, n, \
                                         cin, cout, kk, st);
  switch (geo.mt) {
    WGRAD_MT(1) WGRAD_MT(2) WGRAD_MT(3) WGRAD_MT(4) WGRAD_MT(5)
    WGRAD_MT(6) WGRAD_MT(7) WGRAD_MT(8)
    default: return launch_centre<MAX_MT, NTW>(geo, feats, plan, g, mask, partial, lists, counts,
                                               n, cin, cout, kk, st);
  }
#undef WGRAD_MT
}

// -- design "taps": K² = 27, Cin and Cout up to TAP_MAX --------------------

constexpr int TAPS = 27;          // the 3x3x3 window
constexpr int TAP_MAX = 16;       // widest Cin and Cout the design takes
constexpr int TAP_THREADS = 512;  // grid 1: an item a thread
constexpr int TAP_BLOCK_ROWS = 128;  // the rows a block owns are a multiple of this
constexpr int TAP_CH = 384;       // rows staged at a time (a multiple of 4)
constexpr int TAP_U = 4;          // rows a thread gathers before it multiplies
constexpr int SUM_THREADS = 256;  // grid 2: a warp an output
constexpr long long TAP_PARTIAL_FLOATS = 1 << 19;  // scratch the partials aim at

// Items: pairs = 27·Cin + 1 (tap, channel) pairs, the last db's ones, times
// lanes = TAP_THREADS / pairs row lanes (9 at Cin 2, 1 at 16); item i is
// row lane i % lanes of pair i / lanes, so that a warp's items hold few
// taps and a warp whose taps no row of a step has skips the step.
__host__ __device__ inline int tap_pairs(int cin) { return TAPS * cin + 1; }
__host__ __device__ inline int tap_lanes(int cin) { return TAP_THREADS / tap_pairs(cin); }

// Grid 1. Block x: rows [x·rows_per_block, ...) (rows_per_block a multiple
// of TAP_BLOCK_ROWS); writes partial[e · blocks + x] for each entry e of the
// flattened (dW [27, Cin, Cout], db [Cout]). vec_plan: the plan is 16-byte
// aligned. At most 64 registers, so that two blocks (32 warps) share an SM.
template <int CO>
__global__ void __launch_bounds__(TAP_THREADS, 2)
wgrad_taps_kernel(const float* __restrict__ feats, const int32_t* __restrict__ plan,
                  const float* __restrict__ g, const uint8_t* __restrict__ mask,
                  float* __restrict__ partial, int n, int cin, int cout, int blocks,
                  int rows_per_block, int vec_plan) {
  extern __shared__ __align__(16) float smem[];
  float* g_s = smem;                                            // [TAP_CH, CO], 0 where masked
  int* plan_s = reinterpret_cast<int*>(g_s + TAP_CH * CO);      // [TAP_CH, 27]
  float* red_s = smem;                                          // [pairs, lanes, CO], then
  __shared__ uint8_t msk_s[TAP_CH];

  const int t = threadIdx.x;
  const int pairs = tap_pairs(cin), lanes = tap_lanes(cin);
  const bool live = t < pairs * lanes;
  const int lane = t % lanes, p = t / lanes;
  // the item's tap (TAPS: none; -1: db's ones) and input channel
  const int k = !live ? TAPS : p < TAPS * cin ? p / cin : -1;
  const int c = p < TAPS * cin ? p % cin : 0;
  float acc[CO];
#pragma unroll
  for (int o = 0; o < CO; ++o) acc[o] = 0.f;

  const int64_t first = (int64_t)blockIdx.x * rows_per_block;
  const int64_t last = first + rows_per_block < n ? first + rows_per_block : (int64_t)n;
#pragma unroll 1
  for (int64_t r0 = first; r0 < last; r0 += TAP_CH) {
    const int rows = last - r0 < TAP_CH ? static_cast<int>(last - r0) : TAP_CH;
    __syncthreads();                           // the last chunk's readers are done
    // the chunk's plan rows, g rows and mask, every load independent of the
    // others (r0·27 ints is a multiple of 4: an aligned plan stays aligned)
    const int32_t* plan_c = plan + r0 * TAPS;
    const int words = rows * TAPS;
    int head = 0;
    if (vec_plan) {
      head = words / 4 * 4;
      const int4* src4 = reinterpret_cast<const int4*>(plan_c);
      int4* dst4 = reinterpret_cast<int4*>(plan_s);
      for (int i = t; i < words / 4; i += TAP_THREADS) dst4[i] = __ldg(src4 + i);
    }
    for (int i = head + t; i < words; i += TAP_THREADS) plan_s[i] = __ldg(plan_c + i);
    for (int i = t; i < rows * CO; i += TAP_THREADS) {
      const int r = i / CO, o = i % CO;
      g_s[i] = o < cout ? __ldg(g + (r0 + r) * cout + o) : 0.f;
    }
    if (t < rows) msk_s[t] = mask[r0 + t];
    __syncthreads();
    // g is 0 where the mask is off (db and every product of the row then
    // add 0, whatever g holds there); the plan is read through the mask
    for (int i = t; i < rows * CO; i += TAP_THREADS)
      if (msk_s[i / CO] == 0) g_s[i] = 0.f;
    __syncthreads();
    // the lane's rows, TAP_U at a time; every thread of a warp takes the
    // same steps (the __any_sync), those past the items with nothing to add
#pragma unroll 1
    for (int r = lane; r - lane < rows; r += lanes * TAP_U) {
      float a[TAP_U];
      bool any = false;
#pragma unroll
      for (int u = 0; u < TAP_U; ++u) {
        const int rr = r + u * lanes;
        if (k < 0) {
          a[u] = rr < rows ? 1.f : 0.f;        // db: g_s is 0 where the mask is off
        } else {
          const int src = k < TAPS && rr < rows && msk_s[rr] != 0 ? plan_s[rr * TAPS + k] : -1;
          a[u] = src >= 0 ? __ldg(feats + (int64_t)src * cin + c) : 0.f;
          any |= src >= 0;
        }
      }
      // a step that no item of the warp has a tap in adds nothing
      if (!__any_sync(0xffffffffu, any || k < 0)) continue;
#pragma unroll
      for (int u = 0; u < TAP_U; ++u) {
        const int rr = min(r + u * lanes, rows - 1);   // a[u] is 0 past the rows
        const float4* gr = reinterpret_cast<const float4*>(g_s + rr * CO);
#pragma unroll
        for (int q = 0; q < CO / 4; ++q) {
          const float4 v = gr[q];
          acc[4 * q] = fmaf(a[u], v.x, acc[4 * q]);
          acc[4 * q + 1] = fmaf(a[u], v.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(a[u], v.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(a[u], v.w, acc[4 * q + 3]);
        }
      }
    }
  }
  __syncthreads();                             // the staged rows are read: red_s takes them
  if (live) {
#pragma unroll
    for (int o = 0; o < CO; ++o) red_s[t * CO + o] = acc[o];
  }
  __syncthreads();
  // the row lanes summed in lane order
  for (int e = t; e < pairs * cout; e += TAP_THREADS) {
    const int q = e / cout, o = e - q * cout;
    float v = red_s[q * lanes * CO + o];
    for (int l = 1; l < lanes; ++l) v += red_s[(q * lanes + l) * CO + o];
    partial[(int64_t)e * blocks + blockIdx.x] = v;
  }
  // the sum's grid may start now (launched earlier, its blocks would wait
  // on SMs this grid uses); it waits for this grid before reading
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Grid 2, a programmatic dependent launch: warp e sums entry e over the
// blocks' partials (lane l: blocks l, l + 32, ..., then a butterfly), into
// dW or db. With no row (blocks = 0) it writes zeros.
__global__ void __launch_bounds__(SUM_THREADS)
wgrad_taps_sum_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                      float* __restrict__ db, int cin, int cout, int blocks) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int e = (blockIdx.x * SUM_THREADS + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  const int dw_n = TAPS * cin * cout;
  if (e >= dw_n + cout) return;                // whole warps
  const float* src = partial + (int64_t)e * blocks;
  float v = 0.f;
#pragma unroll 4
  for (int b = lane; b < blocks; b += 32) v += __ldcg(src + b);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane != 0) return;
  if (e < dw_n)
    dw[e] = v;
  else if (db != nullptr)
    db[e - dw_n] = v;
}

template <int CO>
int launch_taps(const float* feats, const int32_t* plan, const float* g, const uint8_t* mask,
                float* partial, int n, int cin, int cout, int blocks, int rows_per_block,
                cudaStream_t stream) {
  // the staged rows (66 KB at CO 16), or the items' sums (at most 32 KB:
  // 512 items x 16)
  const int items = tap_pairs(cin) * tap_lanes(cin);
  const size_t smem = sizeof(float) * std::max(items * CO, TAP_CH * (CO + TAPS));
  static DeviceCache allowed;   // dynamic shared memory allowed so far, per device
  const cudaError_t err = raise_per_device(allowed, smem, [smem] {
    return cudaFuncSetAttribute(wgrad_taps_kernel<CO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_plan = reinterpret_cast<uintptr_t>(plan) % 16 == 0;
  wgrad_taps_kernel<CO><<<blocks, TAP_THREADS, smem, stream>>>(
      feats, plan, g, mask, partial, n, cin, cout, blocks, rows_per_block, vec_plan);
  return static_cast<int>(cudaGetLastError());
}

// Grid 1's geometry over n rows on the current device: two blocks an SM
// (one wave), fewer where the partials ((27·Cin + 1)·Cout floats a block)
// would pass TAP_PARTIAL_FLOATS, never under one an SM; rows a block a
// multiple of TAP_BLOCK_ROWS, no block empty. 0 and 0 for no row.
cudaError_t taps_geometry(int n, int cin, int cout, int* blocks, int* rows) {
  *blocks = *rows = 0;
  if (n <= 0) return cudaSuccess;
  static DeviceCache sm_cache;   // SMs, per device
  size_t sms = 0;
  const cudaError_t err = device_attribute(sm_cache, cudaDevAttrMultiProcessorCount, &sms);
  if (err != cudaSuccess) return err;
  const long long per = std::max(1LL, (long long)tap_pairs(cin) * cout);
  const long long target =
      std::max((long long)sms, std::min(2LL * (long long)sms, TAP_PARTIAL_FLOATS / per));
  const long long per_block = (n + target - 1) / target;
  *rows = static_cast<int>((per_block + TAP_BLOCK_ROWS - 1) / TAP_BLOCK_ROWS * TAP_BLOCK_ROWS);
  *blocks = (n + *rows - 1) / *rows;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Scratch the launch needs for n rows: *floats floats (one [Cin + 1, Cout]
// partial per cluster) and *ints ints (each row block's pair lists, [K² - 1,
// rows per block] int2, then its counts [K² - 1]).
int subm_conv_rows_wgrad_scratch(int n, int cin, int cout, int kk, long long* floats,
                                 long long* ints) {
  const Geometry geo = geometry(n, cin, cout, kk);
  *floats = (long long)geo.clusters * (cin + 1) * cout;
  *ints = (long long)geo.blocks * (kk - 1) * (2LL * geo.cr + 1);
  return 0;
}

// All pointers are device pointers; db may be null (no bias). partial and
// ints are scratch of the sizes above; dw is [kk, cin, cout] and db [cout],
// both written in full. Launches two grids on `stream` (the second alone
// when there is no row) and returns the first launch error (0 on success)
// without synchronising.
int subm_conv_rows_wgrad(const float* feats, const int32_t* plan, const float* g,
                         const uint8_t* mask, float* partial, int* ints, float* dw, float* db,
                         int n, int cin, int cout, int kk, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t outputs = (int64_t)kk * cin * cout + (db != nullptr ? cout : 0);
  if (outputs == 0) return 0;
  const Geometry geo = geometry(n, cin, cout, kk);
  int2* lists = reinterpret_cast<int2*>(ints);
  int* counts = ints + (int64_t)geo.blocks * (kk - 1) * 2 * geo.cr;
  const bool rows = n > 0 && cout > 0;
  if (rows) {
    if (geo.smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
    const int err = geo.ntw == 1
        ? dispatch_mt<1>(geo, feats, plan, g, mask, partial, lists, counts, n, cin, cout, kk, st)
        : dispatch_mt<2>(geo, feats, plan, g, mask, partial, lists, counts, n, cin, cout, kk, st);
    if (err != 0) return err;
  }
  const int clusters = rows ? geo.clusters : 0, blocks = rows ? geo.blocks : 0;
  const int sum_blocks = static_cast<int>(((int64_t)(cin + 1) * cout + THREADS - 1) / THREADS);
  const int tiles_o = ceil_div(cout, TO);
  const int tap_blocks = (kk - 1) * ceil_div(cin, TI) * tiles_o;
  const size_t smem = sizeof(int) * ((size_t)blocks + 1);
  // dynamic shared memory a launch may use without the attribute, beside the static
  const size_t unset = 48 * 1024 - sizeof(float) * 2 * BR2 * TI - sizeof(int) * (2 * WINDOW + WARPS);
  static DeviceCache allowed;   // dynamic shared memory allowed so far, per device
  if (smem > unset) {
    const cudaError_t err = raise_per_device(allowed, smem, [smem] {
      return cudaFuncSetAttribute(wgrad_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem));
    });
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // a programmatic dependent launch: its blocks start while grid 1 runs and
  // wait for it (griddepcontrol.wait) before reading anything
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(sum_blocks + tap_blocks);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = smem;
  config.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&config, wgrad_reduce_kernel, feats, g,
                                             (const float*)partial, (const int2*)lists,
                                             (const int*)counts, dw, db, cin, cout, kk,
                                             clusters, blocks, geo.cr, sum_blocks, tiles_o));
}

// The 27-tap design's grid 1 over n rows on the current device (*blocks
// row blocks of *rows rows, a multiple of 128; 0 and 0 for no row) and the
// scratch its launch needs: *floats floats, one (27·Cin + 1)·Cout partial
// a block. Returns a CUDA error where the device cannot be read.
int subm_conv_rows_wgrad_taps_scratch(int n, int cin, int cout, int* blocks, int* rows,
                                      long long* floats) {
  const cudaError_t err = taps_geometry(n, cin, cout, blocks, rows);
  *floats = err == cudaSuccess ? (long long)*blocks * tap_pairs(cin) * cout : 0;
  return static_cast<int>(err);
}

// The 27-tap design (K² = 27, 0 ≤ Cin ≤ 16, 0 ≤ Cout ≤ 16; any other shape
// returns cudaErrorInvalidValue and launches nothing). partial is scratch
// of the size above, for the same n, cin, cout and device. dw [27, cin,
// cout] and db [cout] (may be null) are written in full. Launches two
// grids on `stream` (the second alone when there is no row, none without
// outputs) and returns the first launch error (0 on success) without
// synchronising.
int subm_conv_rows_wgrad_taps(const float* feats, const int32_t* plan, const float* g,
                              const uint8_t* mask, float* partial, float* dw, float* db, int n,
                              int cin, int cout, int kk, void* stream) {
  if (kk != TAPS || cin < 0 || cin > TAP_MAX || cout < 0 || cout > TAP_MAX || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((int64_t)TAPS * cin * cout + (db != nullptr ? cout : 0) == 0) return 0;
  int blocks = 0, rows_per_block = 0;
  const cudaError_t geo_err = taps_geometry(n, cin, cout, &blocks, &rows_per_block);
  if (geo_err != cudaSuccess) return static_cast<int>(geo_err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const int co = cout <= 4 ? 4 : cout <= 8 ? 8 : 16;
    const int err =
        co == 4 ? launch_taps<4>(feats, plan, g, mask, partial, n, cin, cout, blocks,
                                 rows_per_block, st)
        : co == 8 ? launch_taps<8>(feats, plan, g, mask, partial, n, cin, cout, blocks,
                                   rows_per_block, st)
                  : launch_taps<16>(feats, plan, g, mask, partial, n, cin, cout, blocks,
                                    rows_per_block, st);
    if (err != 0) return err;
  }
  const int outputs = TAPS * cin * cout + cout;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((outputs * 32 + SUM_THREADS - 1) / SUM_THREADS);
  config.blockDim = dim3(SUM_THREADS);
  config.dynamicSmemBytes = 0;
  config.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&config, wgrad_taps_sum_kernel,
                                             (const float*)partial, dw, db, cin, cout,
                                             n > 0 ? blocks : 0));
}

const char* wf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
