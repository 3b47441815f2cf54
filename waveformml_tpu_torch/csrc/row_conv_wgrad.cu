// Row-space submanifold convolution, weight and bias gradient: a gather-fused
// GEMM over the row-taps the data has, split over row blocks and reduced in
// a fixed order, so that two runs give the same bits.
//
// Replaces d_kernel and d_bias of waveformml_tpu/ops/row_conv.py:_subm_bwd
// (:257-268), which XLA ran on the TPU as a gather into an [N, K², Cin]
// operand contracted against the masked cotangent g over the rows:
//
//   dW[k] = Σ_r mask[r] · feats[plan[r, k]]ᵀ g[r]      (plan = -1 → 0)
//   db    = Σ_r mask[r] · g[r]
//
// Bound on the H100: at the SubMPSD training shapes (N = 12288 rows, ~10^4
// real, Cin·Cout = 130·104, 104·56, 56·8) the centre tap, present for every
// real row, holds nearly all of the work: 2·Cin·Cout FLOP per row-tap. On
// the card's fastest fp32-accurate units (three TF32 passes, 495 TFLOP/s)
// that takes less time than reading feats and g once at 3.35 TB/s, so the
// bound is bytes; on the FFMA units (67 TFLOP/s) this kernel uses, layer 0's
// work takes a little more. An off-centre tap is present for ~1 real row in
// 100.
//
// Design (a simple kernel that is right; wgmma, TMA and a fused reduction
// are later work):
// * Two grids. The first gives each block one tap, a range of rows and a
//   64x64 tile of (input, output) channels, and writes the tile of its
//   partial sum Σ_{its rows} feats[plan[r, k]]ᵀ g[r] into a scratch buffer.
//   The second sums, for every dW entry, the partials of its tap in a fixed
//   order; it also sums db's per-block column sums. No float atomics.
// * Rows per block: CENTRE_ROWS for the centre tap, so that its partials
//   fill the card; SPARSE_ROWS for each other tap, whose rows are rare, so
//   that few partials are written and read for them. A block whose rows have
//   no tap writes no partial and a count of 0, and the second grid skips it.
// * Compaction: a block lists, WINDOW rows at a time, the rows whose mask is
//   on and whose tap is present, in row order (warp ballots and a prefix
//   over the warps, so the list and hence the order of the sums is fixed),
//   and multiplies only those. Any plan entry in [-1, N) works, including
//   one that names another row (duplicate sites).
// * Arithmetic: FFMA in fp32. BR listed rows at a time are gathered into
//   shared memory (their feats row through the plan, their g row), scalar
//   loads along the channels (Cin = 130 is not a multiple of 4), held in
//   registers one step ahead; each thread accumulates a 4x4 block of the
//   tile from float4 reads of the two staged operands.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TI = 64;             // input channels of a block's tile
constexpr int TO = 64;             // output channels of a block's tile
constexpr int MI = 4, MO = 4;      // a thread's outputs: MI input x MO output channels
constexpr int WINDOW = 512;        // rows compacted at a time
constexpr int CENTRE_ROWS = 256;   // rows of a centre-tap block
constexpr int SPARSE_ROWS = 4096;  // rows of an other-tap block
constexpr int BR = 32;             // listed rows staged per step
constexpr int LOADS = BR * TI / THREADS;   // staged values of each operand per thread
constexpr int DB_LOADS = 8;        // g rows a thread of the db sums loads at a time
static_assert(TI == TO, "one index map stages both operands");
static_assert((TI / MI) * (TO / MO) == THREADS, "one micro tile per thread");
static_assert(WINDOW % THREADS == 0, "whole compaction rounds");

// Block x < nc: the centre tap, rows [x·CENTRE_ROWS, ...); block x >= nc:
// other tap (x - nc) / ns, rows [((x - nc) % ns)·SPARSE_ROWS, ...). Block y:
// the channel tile (y / tiles_o, y % tiles_o). Partial x is [cin, cout].
__global__ void __launch_bounds__(THREADS)
wgrad_partial_kernel(const float* __restrict__ feats, const int32_t* __restrict__ plan,
                     const float* __restrict__ g, const uint8_t* __restrict__ mask,
                     float* __restrict__ partial, int* __restrict__ counts,
                     float* __restrict__ db_part, int n, int cin, int cout, int kk, int nc,
                     int ns, int tiles_o) {
  __shared__ __align__(16) float a_s[BR][TI];   // gathered feats rows, the tile's input channels
  __shared__ __align__(16) float b_s[BR][TO];   // g rows, the tile's output channels
  __shared__ int src_s[WINDOW];                 // listed rows: the plan's row of the tap ...
  __shared__ int row_s[WINDOW];                 // ... and the output row
  __shared__ int warp_n[WARPS];
  __shared__ float col_s[THREADS];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int centre = kk / 2;
  const int p = blockIdx.x;
  int tap, row0, row_end;
  if (p < nc) {
    tap = centre;
    row0 = p * CENTRE_ROWS;
    row_end = min(n, row0 + CENTRE_ROWS);
  } else {
    const int q = p - nc, other = q / ns;
    tap = other + (other >= centre);
    row0 = (q % ns) * SPARSE_ROWS;
    row_end = min(n, row0 + SPARSE_ROWS);
  }
  const int i0 = (blockIdx.y / tiles_o) * TI, o0 = (blockIdx.y % tiles_o) * TO;
  const int ti = t % (TI / MI), to = t / (TI / MI);

  float acc[MI][MO];
#pragma unroll
  for (int a = 0; a < MI; ++a)
#pragma unroll
    for (int b = 0; b < MO; ++b) acc[a][b] = 0.f;

  float ra[LOADS], rb[LOADS];
  int total = 0;
#pragma unroll 1
  for (int w0 = row0; w0 < row_end; w0 += WINDOW) {
    // -- compaction: the window's rows with the mask on and the tap present,
    //    in row order
    int src[WINDOW / THREADS];
#pragma unroll
    for (int q = 0; q < WINDOW / THREADS; ++q) {
      const int r = w0 + q * THREADS + t;
      const bool in = r < row_end;
      const int s = in ? plan[(int64_t)r * kk + tap] : -1;
      src[q] = in && mask[r] != 0 ? s : -1;
    }
    int cnt = 0;
#pragma unroll
    for (int q = 0; q < WINDOW / THREADS; ++q) {
      const uint32_t b = __ballot_sync(0xffffffffu, src[q] >= 0);
      if (lane == 0) warp_n[warp] = __popc(b);
      __syncthreads();
      int base = cnt, round = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        base += w < warp ? warp_n[w] : 0;
        round += warp_n[w];
      }
      if (src[q] >= 0) {
        const int pos = base + __popc(b & ((1u << lane) - 1u));
        src_s[pos] = src[q];
        row_s[pos] = w0 + q * THREADS + t;
      }
      cnt += round;
      __syncthreads();                 // the list is written; warp_n may be reused
    }
    total += cnt;

    // -- the listed rows, BR at a time: stage, then accumulate --------------
    const int steps = (cnt + BR - 1) / BR;
    auto load = [&](int step) {
#pragma unroll
      for (int q = 0; q < LOADS; ++q) {
        const int idx = q * THREADS + t;
        const int j = idx / TI, c = idx % TI;
        const int lr = step * BR + j;
        const bool ok = lr < cnt;
        ra[q] = ok && i0 + c < cin ? feats[(int64_t)src_s[lr] * cin + i0 + c] : 0.f;
        rb[q] = ok && o0 + c < cout ? g[(int64_t)row_s[lr] * cout + o0 + c] : 0.f;
      }
    };
    if (steps > 0) load(0);
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
      __syncthreads();                 // the last step's readers of a_s, b_s are done
#pragma unroll
      for (int q = 0; q < LOADS; ++q) {
        const int idx = q * THREADS + t;
        a_s[idx / TI][idx % TI] = ra[q];
        b_s[idx / TO][idx % TO] = rb[q];
      }
      __syncthreads();
      if (s + 1 < steps) load(s + 1);  // in flight while this step multiplies
#pragma unroll 8
      for (int j = 0; j < BR; ++j) {
        const float4 a = *reinterpret_cast<const float4*>(&a_s[j][ti * MI]);
        const float4 b = *reinterpret_cast<const float4*>(&b_s[j][to * MO]);
        const float av[MI] = {a.x, a.y, a.z, a.w};
        const float bv[MO] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int x = 0; x < MI; ++x)
#pragma unroll
          for (int y = 0; y < MO; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
      }
    }
    __syncthreads();                   // src_s, row_s are rewritten by the next window
  }

  if (blockIdx.y == 0 && t == 0) counts[p] = total;
  if (total > 0) {
    float* out = partial + (int64_t)p * cin * cout;
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

  // -- db: the centre blocks of the first input tile sum g over their rows
  //    with the mask on: `groups` threads a column, each over every
  //    groups-th row in order (DB_LOADS rows in flight), then in group order
  if (db_part != nullptr && p < nc && blockIdx.y < tiles_o) {
    const int cols = min(TO, cout - o0), groups = THREADS / cols;
    const int c = t % cols, rg = t / cols;
    float s = 0.f;
    if (rg < groups) {
      for (int r0 = row0 + rg; r0 < row_end; r0 += DB_LOADS * groups) {
        float v[DB_LOADS];
#pragma unroll
        for (int q = 0; q < DB_LOADS; ++q) {
          const int r = r0 + q * groups;
          v[q] = r < row_end && mask[r] != 0 ? g[(int64_t)r * cout + o0 + c] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < DB_LOADS; ++q) s += v[q];
      }
    }
    col_s[t] = s;
    __syncthreads();
    if (t < cols) {
      float v = 0.f;
      for (int q = 0; q < groups; ++q) v += col_s[q * cols + t];
      db_part[(int64_t)p * cout + o0 + t] = v;
    }
  }
}

// dW[k, i, o] = Σ over tap k's partials with rows, in block order; db[o] =
// Σ over the centre blocks' column sums, in block order. Every partial is
// loaded (one without rows holds stale words, selected away), so that a
// thread's loads are independent and in flight together.
__global__ void __launch_bounds__(THREADS)
wgrad_reduce_kernel(const float* __restrict__ partial, const int* __restrict__ counts,
                    const float* __restrict__ db_part, float* __restrict__ dw,
                    float* __restrict__ db, int cin, int cout, int kk, int nc, int ns) {
  extern __shared__ int counts_s[];   // [nc + (kk - 1)·ns] rows listed by each partial
  const int partials = nc + (kk - 1) * ns;
  for (int i = threadIdx.x; i < partials; i += THREADS) counts_s[i] = counts[i];
  __syncthreads();
  const int64_t per = (int64_t)cin * cout;
  const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int centre = kk / 2;
  if (idx < kk * per) {
    const int k = static_cast<int>(idx / per);
    const int64_t e = idx - k * per;
    int p0 = 0, p1 = nc;
    if (k != centre) {
      p0 = nc + (k - (k > centre)) * ns;
      p1 = p0 + ns;
    }
    float v = 0.f;
#pragma unroll 8
    for (int p = p0; p < p1; ++p) {
      const float x = partial[p * per + e];
      v += counts_s[p] > 0 ? x : 0.f;
    }
    dw[idx] = v;
  } else if (db != nullptr && idx < kk * per + cout) {
    const int o = static_cast<int>(idx - kk * per);
    float v = 0.f;
#pragma unroll 8
    for (int p = 0; p < nc; ++p) v += db_part[(int64_t)p * cout + o];
    db[o] = v;
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// Scratch the launch needs for n rows and K² taps: *partials buffers of
// [cin, cout] floats (and as many ints of counts), and *centre_blocks rows of
// [cout] floats for db.
int subm_conv_rows_wgrad_scratch(int n, int kk, int* partials, int* centre_blocks) {
  const int nc = ceil_div(n, CENTRE_ROWS), ns = ceil_div(n, SPARSE_ROWS);
  *partials = nc + (kk - 1) * ns;
  *centre_blocks = nc;
  return 0;
}

// All pointers are device pointers; db and db_part may be null (no bias).
// partial, counts and db_part are scratch of the sizes above; dw is [kk,
// cin, cout] and db [cout], both written in full. Launches two grids on
// `stream` (the reduction alone when there is no row) and returns the first
// launch error (0 on success) without synchronising.
int subm_conv_rows_wgrad(const float* feats, const int32_t* plan, const float* g,
                         const uint8_t* mask, float* partial, int* counts, float* db_part,
                         float* dw, float* db, int n, int cin, int cout, int kk, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = ceil_div(n, CENTRE_ROWS), ns = ceil_div(n, SPARSE_ROWS);
  const int tiles_o = ceil_div(cout, TO);
  const bool rows = n > 0 && cin > 0 && cout > 0;
  if (rows) {
    const dim3 grid(nc + (kk - 1) * ns, ceil_div(cin, TI) * tiles_o);
    wgrad_partial_kernel<<<grid, THREADS, 0, st>>>(feats, plan, g, mask, partial, counts,
                                                   db != nullptr ? db_part : nullptr, n, cin,
                                                   cout, kk, nc, ns, tiles_o);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t outputs = (int64_t)kk * cin * cout + (db != nullptr ? cout : 0);
  if (outputs == 0) return 0;
  const int blocks = static_cast<int>((outputs + THREADS - 1) / THREADS);
  const int nc_r = rows ? nc : 0, ns_r = rows ? ns : 0;
  const size_t smem = sizeof(int) * (size_t)(nc_r + (kk - 1) * ns_r);
  static size_t allowed = 48 * 1024;   // dynamic shared memory allowed so far
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgrad_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  wgrad_reduce_kernel<<<blocks, THREADS, smem, st>>>(partial, counts, db_part, dw, db, cin, cout,
                                                     kk, nc_r, ns_r);
  return static_cast<int>(cudaGetLastError());
}

const char* wf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
