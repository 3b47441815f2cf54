// Row-space submanifold convolution, forward, in two designs: a gather-fused
// GEMM on the tensor cores (TF32, 3-pass split) over the row-taps the data
// has, for 2D windows (K² = 1, 9) and wide channels ("tiles"), and a one-pass
// gather in FFMA, a row a thread, for the 3x3x3 window at narrow channels
// ("taps").
//
// A third kernel builds a 3D batch's K³-tap neighbour plan on the device
// (subm_conv_rows_plan), for the grid's SubM convs (ops/sparse_conv.py), as
// waveformml_tpu/ops/row_conv.py:build_neighbor_plan_3d (:76-100) does.
//
// Both designs replace waveformml_tpu/ops/row_conv.py:subm_conv_rows (_masked_gather
// + _gather_gemm, :189-242), and the d_feats of _subm_bwd (:250-256) through
// the reversed, transposed kernel, which XLA ran on the TPU as a gather into
// an [N, K², Cin] operand followed by one GEMM:
//
//   out[r] = mask[r] · (Σ_k feats[plan[r, k]] @ W[k] + bias),  plan = -1 → 0
//
// Dispatch (ops/row_conv.py row_design, on the host): K² = 27 with Cin ≤ 16
// and Cout ≤ 16 runs "taps" (subm_conv_rows_taps_fwd); every other shape
// runs "tiles" (subm_conv_rows_fwd), the 9-tap convs of every 2D config
// among them. Measured on the card at 27 taps (PERF.md): the taps
// design at 2→8, 8→8 and 16→16 against the tiles design at the same
// shapes; wider channels at 27 taps are untried and stay on "tiles".
//
// Bound on the H100: bytes, in both. Tiles, 2D: a real row has its centre
// tap and ~0.1 of its 8 other taps at detector occupancy, so the data needs
// ~1/8 of the dense-tap work, 2·Cin·Cout FLOP per present row-tap; three
// TF32 passes of that at 495 TFLOP/s take less time than reading feats and
// writing out at 3.35 TB/s. Taps, 3D: the plan is the largest operand (108
// bytes a row: 10.5 MB of ~14.5 at SCNet3D.json's 4096 events, ~97k rows,
// against 0.78 MB of feats at 2 channels and 3.1 MB of out at 8), ~4.3 µs;
// its ~295k row-taps at 2→8 are 9.4 MFLOP, ~0.14 µs in fp32.
//
// Design "tiles":
// * Two launches. The first gives each block BM = 32 rows and the centre
//   tap (present for every real row), and writes out = mask·(centre +
//   bias); 32-row blocks measured faster than 64 (more blocks in flight).
//   The second gives each block SPARSE_ROWS rows and one other tap, and
//   adds its products into out with fp32 atomics: in 2D an off-centre tap
//   is present for ~1 real row in 100 at detector occupancy (it holds for
//   the 3x3 windows of the SubMPSD, SegQuantifier and SCNet stacks; in the
//   3x3x3 window the two dt = ±1 taps are present for ~90% of the rows), so
//   one block per 256 rows reads W[k] once where per-tile blocks would read
//   it for every tile that has the tap, and rounds its rows up to a group
//   once. A row takes at most one atomic add per tap; a row with two or
//   more other taps can differ in its last bits from run to run. The
//   second launch is a programmatic dependent launch: its blocks compact,
//   load and multiply while the first grid still runs, and wait for it
//   (griddepcontrol.wait) only before their first add; block 0 waits even
//   with nothing to add, so that the second grid always ends after the
//   first.
// * Why it loses at 27 taps and narrow channels: each of the 26 off-centre
//   taps gets its own blocks, each reading one int32 column of the 108-byte
//   plan rows; a 32-channel slice of which 2 are real is staged, 16 output
//   channels computed for 8; and the dense dt = ±1 taps add ~86k rows × 8
//   channels each with fp32 atomics (0.06290 ms on an H100 against a
//   library line of 0.05862; PERF.md).
// * Compaction. Each block lists, in shared memory, its rows whose tap is
//   present and whose mask is on (warp ballot + one shared counter), and
//   multiplies only those rows, in groups of 8: the gathered rows are the N
//   side of mma.m16n8k8 and the output channels its M side. 8 is the
//   smallest row granularity a tensor-core tile offers; the row-taps
//   computed are ~1.14x those needed at detector occupancy (each block adds
//   its count to a device counter, one atomic a block, which
//   subm_conv_rows_take_row_taps reads). A row's sums do not depend on the
//   other rows of its group, so the list's order does not matter. Any plan
//   entry in [-1, N) works, including a centre tap that names another row
//   (duplicate sites).
// * Width matched to Cout: MT 16-channel tiles, MT = 1..8 a template
//   argument, so 104 channels compute 112 and 8 compute 16; a wider Cout
//   splits into column tiles on grid.y.
// * fp32 accuracy on TF32 units: each operand x is split into big =
//   tf32(x) and small = tf32(x - big), and each product is taken as
//   small·big + big·small + big·big (the dropped small·small term is
//   ~2^-22 |x·y|). Single-pass TF32 would keep ~3 digits. The split, the
//   mma and the cp.async helpers are tf32_mma.cuh's, shared with K4.
// * Staging: a block's steps are (segment of BM listed rows, BK-channel
//   slice of Cin); each step's gathered rows (cp.async, 16, 8 or 4 bytes a
//   copy, zero past Cin) and W[k] slice (one TMA bulk copy when the slice
//   is contiguous, else cp.async) go into a ring of NSTAGE shared-memory
//   buffers, so later steps load while this one multiplies. Row strides
//   are padded (gathered rows ≡ 4, W rows ≡ 8 or 24 words mod 32, as Cout
//   104, 56 and 8 are) so that a warp's fragment loads hit 32 banks.
// * The mma of a step run without a branch between them, and the three
//   passes each cover all of a warp's independent accumulators before the
//   next; a segment of one group spreads its passes and k-steps over the
//   accumulators the other groups would use.
//
// Design "taps" (one launch, no atomics on the output):
// * A block owns TAP_ROWS = 128 consecutive rows, a thread one row. The
//   block reads its rows' plan [128, 27] once, coalesced (16-byte loads
//   where aligned), into shared memory, and W [27, Cin, Cout] (1.7 KB at
//   2→8, 6.9 KB at 8→8), zero-padded to [27, CI, CO] with CI, CO template
//   widths, so that the products need no bound checks.
// * Each thread walks the 27 taps in order, in groups of TG (14 at Cin 2,
//   4 at 8: at most 32 gathered floats a thread) whose gathers it issues
//   together, so that a row waits for L2 once a group; a group, or a tap,
//   that no row of the warp has is skipped by the whole warp
//   (__any_sync), so the ~1% sparse taps cost little. A present tap's Cin
//   features come from L2 (feats, 0.78 MB at 2 channels, stays resident)
//   in one 8- or 16-byte load where aligned, and the Cout sums accumulate
//   in registers in fp32 FFMA, with W read as warp-wide broadcasts from
//   shared memory.
// * mask·(sum + bias) goes through shared memory (odd row stride: no bank
//   conflicts) and out in coalesced stores, written once.
// * A row's sum runs over its taps in a fixed order with no atomics, so
//   two runs give the same bits (ROADMAP's "K1's fp32 atomics" holds for
//   the tiles design only). The row-taps it computes are those needed; each
//   block adds their count to the same device counter as the tiles design.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_cache.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int BM = 32;           // rows per block, centre tap
constexpr int SPARSE_ROWS = 256;  // rows per block, each other tap
constexpr int LIST = SPARSE_ROWS > BM ? SPARSE_ROWS : BM;  // compacted list capacity
constexpr int BK = 32;            // input channels per pipeline step
constexpr int GROUP = 8;          // gathered rows per mma tile (its N)
constexpr int NSTAGE = 3;         // shared-memory buffers in the ring
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int GS = BK + 4;        // row stride of a staged gathered row, words

// row-taps computed since the last subm_conv_rows_take_row_taps: each block
// of the first column tile adds its listed rows, rounded up to whole groups
__device__ unsigned long long row_taps_computed = 0;

template <int MT>
struct Tile {
  static constexpr int BN = MT * 16;                  // output channels per block
  static constexpr int WS = BN + 8;                   // W row stride of cp.async staging
  static constexpr int WM = MT == 1 ? 1 : (MT == 2 ? 2 : 4);  // warps along channels
  static constexpr int WN = WARPS / WM;               // warps along row groups
  static constexpr int MT_W = (MT + WM - 1) / WM;     // channel tiles per warp
  static constexpr int RG_W = (BM / GROUP + WN - 1) / WN;  // row groups per warp
};

// W rows of a slice are `ws` words apart: Cout when one bulk copy stages
// the slice, Tile::WS otherwise. The fragment loads of a warp's last
// channel tile can reach (BK - 1)·ws + 127 words.
__host__ __device__ inline int w_words(int ws) { return ((BK - 1) * ws + 128 + 3) / 4 * 4; }

size_t smem_bytes(int ws) {
  // ring of [gathered rows | W slice], then row flags and the list
  return sizeof(float) * (size_t)NSTAGE * (BM * GS + w_words(ws)) +
         sizeof(int) * ((size_t)BM + 2 * (size_t)LIST);
}

// A bulk copy through the Tensor Memory Accelerator, completing on an
// mbarrier in shared memory.
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.b32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// One warp's k-steps of a step: fragment loads from the staged buffers,
// the 3-pass split and the mma, for its channel tiles (wm + i·WM) and row
// groups (wn + j·WN). A warp's last channel tile may lie past the block's
// width (MT not a multiple of WM): it is computed all the same, from
// buffer words that are never stored, and dropped at the flush.
template <int MT>
struct Frag {
  using T = Tile<MT>;
  const float* g_s;
  const float* w_s;
  int ws, wm, wn, gid, tig;

  // A[m][k] = W[k][m]: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4);
  // W rows at or past `rows` (the slice's end in Cin) read as zero: a bulk
  // copy leaves them as they were
  __device__ __forceinline__ void load_a(int kb, int rows, uint32_t (&ab)[T::MT_W][4],
                                         uint32_t (&as)[T::MT_W][4]) const {
    const bool lo = kb + tig < rows, hi = kb + tig + 4 < rows;
#pragma unroll
    for (int mt = 0; mt < T::MT_W; ++mt) {
      const float* w0 = w_s + (kb + tig) * ws + (wm + mt * T::WM) * 16 + gid;
      const float* w4 = w0 + 4 * ws;
      split(lo ? w0[0] : 0.f, ab[mt][0], as[mt][0]);
      split(lo ? w0[8] : 0.f, ab[mt][1], as[mt][1]);
      split(hi ? w4[0] : 0.f, ab[mt][2], as[mt][2]);
      split(hi ? w4[8] : 0.f, ab[mt][3], as[mt][3]);
    }
  }

  // B[k][n] = gathered row n of group g, channel k: b0 (t, g), b1 (t+4, g)
  __device__ __forceinline__ void load_b(int kb, int g, uint32_t (&bb)[2],
                                         uint32_t (&bs)[2]) const {
    const float* x = g_s + (g * GROUP + gid) * GS + kb + tig;
    split(x[0], bb[0], bs[0]);
    split(x[4], bb[1], bs[1]);
  }

  // k-step at channel kb for every row group of the warp (ALL: all exist);
  // the three passes each run over all (group, channel tile) pairs before
  // the next, so that consecutive mma are independent
  template <bool ALL>
  __device__ __forceinline__ void multi_step(float (&acc)[T::MT_W][T::RG_W][4], int kb,
                                             int groups, int rows = BK) const {
    uint32_t ab[T::MT_W][4], as[T::MT_W][4];
    uint32_t bb[T::RG_W][2], bs[T::RG_W][2];
    load_a(kb, rows, ab, as);
#pragma unroll
    for (int rg = 0; rg < T::RG_W; ++rg)
      if (ALL || wn + rg * T::WN < groups) load_b(kb, wn + rg * T::WN, bb[rg], bs[rg]);
#pragma unroll
    for (int pass = 0; pass < 3; ++pass)
#pragma unroll
      for (int rg = 0; rg < T::RG_W; ++rg)
        if (ALL || wn + rg * T::WN < groups)
#pragma unroll
          for (int mt = 0; mt < T::MT_W; ++mt)
            mma_tf32(acc[mt][rg], pass == 0 ? as[mt] : ab[mt],
                     pass == 1 ? bs[rg] : bb[rg]);
  }

  // k-step KS of a full slice (or any k-step at kb, KS = 0) for a segment
  // of one row group, on the warps with wn == 0: its passes and k-steps go
  // to separate accumulator slots, summed at the flush
  template <int KS>
  __device__ __forceinline__ void single_step(float (&acc)[T::MT_W][T::RG_W][4],
                                              int kb = KS * 8, int rows = BK) const {
    uint32_t ab[T::MT_W][4], as[T::MT_W][4], bb[2], bs[2];
    load_a(kb, rows, ab, as);
    load_b(kb, 0, bb, bs);
#pragma unroll
    for (int pass = 0; pass < 3; ++pass)
#pragma unroll
      for (int mt = 0; mt < T::MT_W; ++mt)
        mma_tf32(acc[mt][(3 * KS + pass) % T::RG_W], pass == 0 ? as[mt] : ab[mt],
                 pass == 1 ? bs : bb);
  }
};

// sparse = 0: block x owns rows [x·BM, x·BM + BM) and the tap `centre`,
// and writes out for all its rows. sparse = 1: block x owns rows
// [x·SPARSE_ROWS, ...) and tap z (skipping `centre`), and adds into out.
// bulk_w: the W slices are contiguous (one column tile, Cout % 4 == 0,
// 16-byte aligned) and go by bulk copy with row stride Cout.
template <int MT>
__global__ void __launch_bounds__(THREADS)
subm_conv_rows_kernel(const float* __restrict__ feats,
                      const int32_t* __restrict__ plan,
                      const float* __restrict__ weight,
                      const float* __restrict__ bias,
                      const uint8_t* __restrict__ mask,
                      float* __restrict__ out,
                      int n, int cin, int cout, int kk, int centre, int sparse,
                      int vec_f, int vec_w, int bulk_w) {
  using T = Tile<MT>;
  const int ws = bulk_w ? cout : T::WS;
  const int stage = BM * GS + w_words(ws);             // words of one ring buffer
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                  // NSTAGE x [rows BM x GS | W slice]
  int* flag_s = reinterpret_cast<int*>(ring + NSTAGE * stage);  // [BM] 0 off, 1 on, 2 listed
  int* src_s = flag_s + BM;                            // [LIST] source rows, compacted
  int* row_s = src_s + LIST;                           // [LIST] their output rows
  __shared__ int count;
  __shared__ __align__(8) uint64_t bars[NSTAGE];       // bulk copies of each buffer

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int rows = sparse ? SPARSE_ROWS : BM;
  const int row0 = blockIdx.x * rows;
  const int col0 = blockIdx.y * T::BN;
  const int tap = sparse ? (int)blockIdx.z + ((int)blockIdx.z >= centre) : centre;

  // the other taps' launch may start now; each of its blocks waits for
  // this grid before its first add into out (block 0 waits in any case)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (t == 0) count = 0;
  __syncthreads();

  // -- compaction: the block's rows that have the tap, mask on --------------
  // The list's order does not matter: a row's sums do not depend on the
  // other rows of its mma group.
  for (int i = t; i - t < rows; i += THREADS) {
    const int r = row0 + i;
    const bool keep = i < rows && r < n && mask[r] != 0;
    const int src = keep ? plan[(int64_t)r * kk + tap] : -1;
    if (!sparse && i < BM) flag_s[i] = keep + (src >= 0);
    const uint32_t b = __ballot_sync(0xffffffffu, src >= 0);
    int base = 0;
    if (lane == 0 && b != 0) base = atomicAdd(&count, __popc(b));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (src >= 0) {
      const int pos = base + __popc(b & ((1u << lane) - 1u));
      src_s[pos] = src;
      row_s[pos] = r;
    }
  }
  __syncthreads();
  if (t == 0 && blockIdx.y == 0 && count > 0)
    atomicAdd(&row_taps_computed, (unsigned long long)((count + GROUP - 1) / GROUP * GROUP));

  if (!sparse) {
    // rows off the list: bias where the mask is on, else 0
    for (int lr = warp; lr < BM && row0 + lr < n; lr += WARPS) {
      if (flag_s[lr] == 2) continue;
      for (int o = col0 + lane; o < min(col0 + T::BN, cout); o += 32)
        out[(int64_t)(row0 + lr) * cout + o] = flag_s[lr] && bias != nullptr ? bias[o] : 0.f;
    }
  }

  // -- pipeline over (segment, Cin slice) steps -----------------------------
  // the list is multiplied BM rows (a segment) at a time
  const int n_slices = (cin + BK - 1) / BK;
  const int steps = (count + BM - 1) / BM * n_slices;
  if (steps == 0) {
    // Block 0 of the other taps' launch waits for the centre grid even with
    // nothing to add, so that this grid never ends before that one, however
    // sparse the plan (the other blocks with work wait before their first
    // add). Other empty blocks return at once: waiting, they would hold
    // their SM's shared memory from blocks with work (+12% at 104->56).
    if (sparse && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
    return;
  }
  if (bulk_w) {
    if (t == 0) {
      for (int i = 0; i < NSTAGE; ++i) bar_init(&bars[i]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // copy geometry: a warp copies whole rows, `per_row` copies of `vec`
  // floats each, 32 / per_row rows per instruction
  const int f_per_row = BK / vec_f, f_rows = 32 / f_per_row;
  const int f_sub = lane / f_per_row, f_col = (lane % f_per_row) * vec_f;
  const int w_per_row = T::BN / vec_w;

  // Stage step `step`: the segment's rows and the W[k] rows of the slice,
  // with channels past Cin zero (a bulk W slice leaves its rows past Cin as
  // they were; the fragment loads read them as zero). Gathered rows past
  // the segment and W columns past Cout are left as they are: they only
  // reach outputs never stored.
  auto issue = [&](int step) {
    float* g_s = ring + (step % NSTAGE) * stage;
    float* w_s = g_s + BM * GS;
    const int seg = step / n_slices * BM;
    const int c0 = (step % n_slices) * BK;
    const int cnt = min(BM, count - seg);
    const int rows_w = min(BK, cin - c0);
    const float* w_k = weight + ((int64_t)tap * cin + c0) * cout + col0;
    if (bulk_w && t == 0) {
      uint64_t* bar = &bars[step % NSTAGE];
      bar_expect(bar, rows_w * cout * 4);
      bulk_copy(w_s, w_k, rows_w * cout * 4, bar);
    }
    const bool f_ok = c0 + f_col < cin;
    for (int nr = warp * f_rows + f_sub; nr < cnt; nr += WARPS * f_rows) {
      const float* src = f_ok ? feats + (int64_t)src_s[seg + nr] * cin + c0 + f_col : feats;
      cp_async(g_s + nr * GS + f_col, src, f_ok, vec_f);
    }
    if (bulk_w) return;
    for (int kc = warp; kc < BK; kc += WARPS) {
      for (int q = lane; q < w_per_row; q += 32) {
        const int j = q * vec_w;
        if (col0 + j >= cout) break;
        const bool ok = kc < rows_w;
        cp_async(w_s + kc * T::WS + j, ok ? w_k + (int64_t)kc * cout + j : weight, ok, vec_w);
      }
    }
  };

  const int wm = warp % T::WM, wn = warp / T::WM;
  const int gid = lane >> 2, tig = lane & 3;
  float acc[T::MT_W][T::RG_W][4];
#pragma unroll
  for (int a = 0; a < T::MT_W; ++a)
#pragma unroll
    for (int b = 0; b < T::RG_W; ++b)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][b][q] = 0.f;

#pragma unroll 1
  for (int p = 0; p < NSTAGE - 1; ++p) {
    if (p < steps) issue(p);
    cp_async_commit();
  }
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();                 // step s has landed; step s-1's buffer is free
    if (s + NSTAGE - 1 < steps) issue(s + NSTAGE - 1);
    cp_async_commit();
    if (bulk_w) bar_wait(&bars[s % NSTAGE], (s / NSTAGE) & 1);

    const float* g_s = ring + (s % NSTAGE) * stage;
    const int seg = s / n_slices * BM;
    const int slice = s % n_slices;
    const int cnt = min(BM, count - seg);
    const int groups = (cnt + GROUP - 1) / GROUP;
    const bool single = groups == 1;
    const int rows_w = min(BK, cin - slice * BK);
    const int ksteps = (rows_w + 7) / 8;
    const Frag<MT> f{g_s, g_s + BM * GS, ws, wm, wn, gid, tig};
    // one branch per step picks a loop with no branch around its mma
    if (ksteps == BK / 8) {
      if (single) {
        if (wn == 0) {
          f.template single_step<0>(acc); f.template single_step<1>(acc);
          f.template single_step<2>(acc); f.template single_step<3>(acc);
        }
      } else if (groups == BM / GROUP) {
#pragma unroll
        for (int ks = 0; ks < BK / 8; ++ks) f.template multi_step<true>(acc, ks * 8, groups);
      } else {
#pragma unroll
        for (int ks = 0; ks < BK / 8; ++ks) f.template multi_step<false>(acc, ks * 8, groups);
      }
    } else if (single) {
      if (wn == 0)
        for (int ks = 0; ks < ksteps; ++ks) f.template single_step<0>(acc, ks * 8, rows_w);
    } else {
      for (int ks = 0; ks < ksteps; ++ks)
        f.template multi_step<false>(acc, ks * 8, groups, rows_w);
    }

    if (slice != n_slices - 1) continue;
    // the segment is done: its sums (plus bias) go to out, then restart.
    // c0 (ch g, row 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
#pragma unroll
    for (int mt = 0; mt < T::MT_W; ++mt) {
      if (single) {
#pragma unroll
        for (int rg = 1; rg < T::RG_W; ++rg)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][0][q] += acc[mt][rg][q];
      }
      if (sparse && mt == 0 && seg == 0) asm volatile("griddepcontrol.wait;\n" ::: "memory");
      const int ch = (wm + mt * T::WM) * 16 + gid;
      const bool on[2] = {ch < T::BN && col0 + ch < cout, ch < T::BN && col0 + ch + 8 < cout};
      float b[2] = {0.f, 0.f};
      if (!sparse && bias != nullptr) {
        if (on[0]) b[0] = bias[col0 + ch];
        if (on[1]) b[1] = bias[col0 + ch + 8];
      }
#pragma unroll
      for (int rg = 0; rg < T::RG_W; ++rg) {
        const int g = wn + rg * T::WN;
        if (ch < T::BN && g < groups && !(single && rg > 0)) {
#pragma unroll
          for (int dn = 0; dn < 2; ++dn) {
            const int nr = g * GROUP + 2 * tig + dn;
            if (nr >= cnt) continue;
            float* o = out + (int64_t)row_s[seg + nr] * cout + col0 + ch;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (!on[h]) continue;
              if (sparse)
                atomicAdd(o + 8 * h, acc[mt][rg][2 * h + dn]);
              else
                o[8 * h] = acc[mt][rg][2 * h + dn] + b[h];
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][rg][q] = 0.f;
      }
    }
  }
  cp_async_wait<0>();
}

int copy_width(int count, const void* ptr) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(ptr);
  if (count % 4 == 0 && p % 16 == 0) return 4;
  if (count % 2 == 0 && p % 8 == 0) return 2;
  return 1;
}

// Allow `smem` bytes of dynamic shared memory, and ask for the largest
// shared-memory carveout, so that several blocks fit on an SM.
template <int MT>
cudaError_t configure(size_t smem) {
  static DeviceCache configured;   // dynamic shared memory allowed so far, per device
  return raise_per_device(configured, smem, [smem] {
    cudaError_t err = cudaFuncSetAttribute(subm_conv_rows_kernel<MT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(subm_conv_rows_kernel<MT>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    return err;
  });
}

template <int MT>
int launch(const float* feats, const int32_t* plan, const float* weight,
           const float* bias, const uint8_t* mask, float* out, int n, int cin,
           int cout, int kk, cudaStream_t stream) {
  const int col_tiles = (cout + Tile<MT>::BN - 1) / Tile<MT>::BN;
  const int vec_f = copy_width(cin, feats), vec_w = copy_width(cout, weight);
  const int bulk_w = col_tiles == 1 && vec_w == 4;
  const size_t smem = smem_bytes(bulk_w ? cout : Tile<MT>::WS);
  cudaError_t err = configure<MT>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int centre = kk / 2;
  // the centre tap, bias and mask, written into out ...
  subm_conv_rows_kernel<MT><<<dim3((n + BM - 1) / BM, col_tiles), THREADS, smem, stream>>>(
      feats, plan, weight, bias, mask, out, n, cin, cout, kk, centre, 0, vec_f, vec_w, bulk_w);
  err = cudaGetLastError();
  if (err != cudaSuccess || kk == 1) return static_cast<int>(err);
  // ... then the other taps, added into it. A programmatic dependent
  // launch: its blocks start while the first grid runs, and each waits for
  // that grid's writes (griddepcontrol.wait) before its first atomic add;
  // block 0 waits even with none.
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((n + SPARSE_ROWS - 1) / SPARSE_ROWS, col_tiles, kk - 1);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&config, subm_conv_rows_kernel<MT>, feats, plan,
                                             weight, bias, mask, out, n, cin, cout, kk, centre,
                                             1, vec_f, vec_w, bulk_w));
}

// 16-channel tiles per block: column tiles of at most 128 channels, each as
// narrow as Cout allows
int channel_tiles(int cout) {
  const int col_tiles = (cout + 127) / 128;
  return ((cout + col_tiles - 1) / col_tiles + 15) / 16;
}

// -- design "taps": K² = 27, Cin and Cout up to TAP_MAX --------------------

constexpr int TAPS = 27;          // the 3x3x3 window
constexpr int TAP_ROWS = 128;     // rows per block, one a thread
constexpr int TAP_MAX = 16;       // widest Cin and Cout the design takes

// Taps whose rows a thread gathers at once: as many as keep the gathered
// values within 32 registers
__host__ __device__ constexpr int tap_group(int ci) {
  return ci >= 16 ? 2 : ci >= 8 ? 4 : ci >= 4 ? 8 : ci >= 2 ? 14 : 27;
}

// Row src's CI features into a (zero past cin, or where src < 0): one
// 16- or 8-byte load where vec_f says the row allows it, else cin loads.
template <int CI>
__device__ __forceinline__ void gather_row(float (&a)[CI], const float* __restrict__ feats,
                                           int src, int cin, int vec_f) {
#pragma unroll
  for (int c = 0; c < CI; ++c) a[c] = 0.f;
  if (src < 0) return;
  const float* f = feats + (int64_t)src * cin;
  if constexpr (CI % 4 == 0) {
    if (vec_f == 4) {
#pragma unroll
      for (int c = 0; c < CI; c += 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(f + c));
        a[c] = v.x; a[c + 1] = v.y; a[c + 2] = v.z; a[c + 3] = v.w;
      }
      return;
    }
  }
  if constexpr (CI % 2 == 0) {
    if (vec_f == 2) {
#pragma unroll
      for (int c = 0; c < CI; c += 2) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(f + c));
        a[c] = v.x; a[c + 1] = v.y;
      }
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < CI; ++c) a[c] = c < cin ? __ldg(f + c) : 0.f;
}

// CI, CO: Cin and Cout rounded up to a template width (W is zero past them
// in shared memory). vec_plan: the plan is 16-byte aligned. vec_f: floats
// of one gather load (4 or 2 where Cin == CI is a multiple and feats is
// aligned, else 1).
template <int CI, int CO>
__global__ void __launch_bounds__(TAP_ROWS)
subm_conv_rows_taps_kernel(const float* __restrict__ feats,
                           const int32_t* __restrict__ plan,
                           const float* __restrict__ weight,
                           const float* __restrict__ bias,
                           const uint8_t* __restrict__ mask,
                           float* __restrict__ out,
                           int n, int cin, int cout, int vec_plan, int vec_f) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                                            // [27, CI, CO]
  int* plan_s = reinterpret_cast<int*>(w_s + TAPS * CI * CO);   // [TAP_ROWS, 27]
  float* out_s = reinterpret_cast<float*>(plan_s);              // [TAP_ROWS, os], after the taps
  __shared__ int taps_s;

  const int t = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * TAP_ROWS;
  const int rows = n - row0 < TAP_ROWS ? static_cast<int>(n - row0) : TAP_ROWS;
  if (t == 0) taps_s = 0;
  for (int i = t; i < TAPS * CI * CO; i += TAP_ROWS) {
    const int o = i % CO, c = (i / CO) % CI, k = i / (CO * CI);
    w_s[i] = c < cin && o < cout ? __ldg(weight + ((int64_t)k * cin + c) * cout + o) : 0.f;
  }
  // the block's plan rows, read once, coalesced (row0·27 ints is a multiple
  // of 4, so a 16-byte aligned plan stays aligned at every block)
  const int words = rows * TAPS;
  const int32_t* plan_b = plan + row0 * TAPS;
  int head = 0;
  if (vec_plan) {
    head = words / 4 * 4;
    const int4* src4 = reinterpret_cast<const int4*>(plan_b);
    int4* dst4 = reinterpret_cast<int4*>(plan_s);
    for (int i = t; i < words / 4; i += TAP_ROWS) dst4[i] = __ldg(src4 + i);
  }
  for (int i = head + t; i < words; i += TAP_ROWS) plan_s[i] = __ldg(plan_b + i);
  const bool on = t < rows && mask[row0 + t] != 0;
  __syncthreads();

  float acc[CO];
#pragma unroll
  for (int o = 0; o < CO; ++o) acc[o] = 0.f;
  int present = 0;
  const int* taps = plan_s + t * TAPS;        // row stride 27 words: no bank conflicts
  // TG taps at a time: their gathers are issued together, so that a row
  // waits for L2 once a group rather than once a tap
  constexpr int TG = tap_group(CI);
#pragma unroll 1
  for (int k0 = 0; k0 < TAPS; k0 += TG) {
    int src[TG];
    bool any = false;
#pragma unroll
    for (int j = 0; j < TG; ++j) {
      src[j] = on && k0 + j < TAPS ? taps[k0 + j] : -1;
      any |= src[j] >= 0;
    }
    // every lane takes part: the rows past n and the masked rows with -1
    if (!__any_sync(0xffffffffu, any)) continue;
    float a[TG][CI];
#pragma unroll
    for (int j = 0; j < TG; ++j) gather_row<CI>(a[j], feats, src[j], cin, vec_f);
#pragma unroll
    for (int j = 0; j < TG; ++j) {
      if (!__any_sync(0xffffffffu, src[j] >= 0)) continue;
      present += src[j] >= 0;
      const float* w = w_s + (k0 + j) * CI * CO;
#pragma unroll
      for (int c = 0; c < CI; ++c)
#pragma unroll
        for (int o = 0; o < CO; ++o) acc[o] = fmaf(a[j][c], w[c * CO + o], acc[o]);
    }
  }
  if (present) atomicAdd(&taps_s, present);
  __syncthreads();                            // plan_s is read: it holds out_s now

  const int os = cout | 1;                    // odd row stride: no bank conflicts
  if (t < rows) {
#pragma unroll
    for (int o = 0; o < CO; ++o)
      if (o < cout) out_s[t * os + o] = on ? acc[o] + (bias != nullptr ? __ldg(bias + o) : 0.f)
                                          : 0.f;
  }
  __syncthreads();
  float* out_b = out + row0 * cout;
  for (int i = t; i < rows * cout; i += TAP_ROWS) out_b[i] = out_s[(i / cout) * os + i % cout];
  if (t == 0 && taps_s > 0) atomicAdd(&row_taps_computed, (unsigned long long)taps_s);
}

template <int CI, int CO>
int launch_taps(const float* feats, const int32_t* plan, const float* weight,
                const float* bias, const uint8_t* mask, float* out, int n, int cin,
                int cout, cudaStream_t stream) {
  // W and the plan rows (the output rows reuse the plan's words): at most
  // 41.5 KB at CI = CO = 16, under the 48 KB a launch may take unasked
  const size_t smem = sizeof(float) * ((size_t)TAPS * CI * CO + (size_t)TAP_ROWS * TAPS);
  const int vec_plan = reinterpret_cast<uintptr_t>(plan) % 16 == 0;
  const int vec_f = cin == CI ? copy_width(cin, feats) : 1;
  subm_conv_rows_taps_kernel<CI, CO><<<(n + TAP_ROWS - 1) / TAP_ROWS, TAP_ROWS, smem, stream>>>(
      feats, plan, weight, bias, mask, out, n, cin, cout, vec_plan, vec_f);
  return static_cast<int>(cudaGetLastError());
}

int tap_width(int c) { return c <= 1 ? 1 : c <= 2 ? 2 : c <= 4 ? 4 : c <= 8 ? 8 : 16; }

// -- the K³-tap neighbour plan of a 3D batch, from its rows' sites ---------------
//
// One thread a (row, tap), the taps of a row adjacent, so the plan is written
// in coalesced stores: plan[r, tap] = table[site[r] + offset(tap)] where the
// row is live and the tap's (x, y, t) lies on the grid, else -1. Tap order
// (dx, dy, dt) row-major, each in -h..h (ops/row_conv.py host_neighbor_plan).
// A live row's site, and every site of its window on the grid, is below the
// table's size, which the caller keeps under 2^31: the index arithmetic is
// 32-bit (a 64-bit division is a long software sequence on the card).
__global__ void __launch_bounds__(256)
neighbor_plan_kernel(const int64_t* __restrict__ site, const uint8_t* __restrict__ live,
                     const int32_t* __restrict__ table, int32_t* __restrict__ plan,
                     long long total, int k, int nx, int ny, int nt) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int kk = k * k * k;
  const int r = static_cast<int>(i / kk), tap = static_cast<int>(i - (long long)r * kk);
  int out = -1;
  if (live[r]) {
    const int s = static_cast<int>(site[r]);
    const int t = s % nt, xy = s / nt;
    const int y = xy % ny, x = (xy / ny) % nx;
    const int h = (k - 1) / 2;
    const int dx = tap / (k * k) - h, dy = tap / k % k - h, dt = tap % k - h;
    if (x + dx >= 0 && x + dx < nx && y + dy >= 0 && y + dy < ny && t + dt >= 0 &&
        t + dt < nt)
      out = table[s + (dx * ny + dy) * nt + dt];
  }
  plan[i] = out;
}

}  // namespace

extern "C" {

// All pointers are device pointers; bias may be null. Launches on `stream`
// and returns the launch's cudaError_t (0 on success) without synchronising.
int subm_conv_rows_fwd(const float* feats, const int32_t* plan,
                       const float* weight, const float* bias,
                       const uint8_t* mask, float* out, int n, int cin,
                       int cout, int kk, void* stream) {
  if (n == 0 || cout == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (channel_tiles(cout)) {
    case 1: return launch<1>(feats, plan, weight, bias, mask, out, n, cin, cout, kk, st);
    case 2: return launch<2>(feats, plan, weight, bias, mask, out, n, cin, cout, kk, st);
    case 3: return launch<3>(feats, plan, weight, bias, mask, out, n, cin, cout, kk, st);
    case 4: return launch<4>(feats, plan, weight, bias, mask, out, n, cin, cout, kk, st);
    case 5: return launch<5>(feats, plan, weight, bias, mask, out, n, cin, cout, kk, st);
    case 6: return launch<6>(feats, plan, weight, bias, mask, out, n, cin, cout, kk, st);
    case 7: return launch<7>(feats, plan, weight, bias, mask, out, n, cin, cout, kk, st);
    default: return launch<8>(feats, plan, weight, bias, mask, out, n, cin, cout, kk, st);
  }
}

// The 27-tap design (K² = 27, 0 ≤ Cin ≤ 16, 0 ≤ Cout ≤ 16; any other shape
// returns cudaErrorInvalidValue and launches nothing): one launch on
// `stream` (none without rows or outputs), the same operands as
// subm_conv_rows_fwd; returns the launch's cudaError_t without
// synchronising.
int subm_conv_rows_taps_fwd(const float* feats, const int32_t* plan,
                            const float* weight, const float* bias,
                            const uint8_t* mask, float* out, int n, int cin,
                            int cout, int kk, void* stream) {
  if (kk != TAPS || cin < 0 || cin > TAP_MAX || cout < 0 || cout > TAP_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || cout == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TAPS_CASE(CI, CO) \
  case CI * 100 + CO: \
    return launch_taps<CI, CO>(feats, plan, weight, bias, mask, out, n, cin, cout, st);
  switch (tap_width(cin) * 100 + (cout <= 4 ? 4 : cout <= 8 ? 8 : 16)) {
    TAPS_CASE(1, 4) TAPS_CASE(1, 8) TAPS_CASE(1, 16)
    TAPS_CASE(2, 4) TAPS_CASE(2, 8) TAPS_CASE(2, 16)
    TAPS_CASE(4, 4) TAPS_CASE(4, 8) TAPS_CASE(4, 16)
    TAPS_CASE(8, 4) TAPS_CASE(8, 8) TAPS_CASE(8, 16)
    TAPS_CASE(16, 4) TAPS_CASE(16, 8) TAPS_CASE(16, 16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TAPS_CASE
}

// The [n, k³] plan of n rows (site int64, live bool as bytes, table int32
// of every site and one slot more, plan int32 out) over an nx × ny × nt grid:
// one launch on `stream`, none without rows; returns the launch's
// cudaError_t without synchronising.
int subm_conv_rows_plan(const int64_t* site, const uint8_t* live, const int32_t* table,
                        int32_t* plan, int n, int k, int nx, int ny, int nt, void* stream) {
  const long long total = (long long)n * k * k * k;
  if (total == 0) return 0;
  neighbor_plan_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(site, live, table, plan, total,
                                                              k, nx, ny, nt);
  return static_cast<int>(cudaGetLastError());
}

// Store the row-taps the kernel computed since the last call into *count
// and restart the count. Synchronous; returns a cudaError_t.
int subm_conv_rows_take_row_taps(long long* count) {
  unsigned long long v = 0;
  const unsigned long long zero = 0;
  cudaError_t err = cudaMemcpyFromSymbol(&v, row_taps_computed, sizeof v);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(row_taps_computed, &zero, sizeof zero);
  *count = static_cast<long long>(v);
  return static_cast<int>(err);
}

const char* wf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
