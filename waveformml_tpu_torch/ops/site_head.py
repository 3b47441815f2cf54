"""Site-grouped execution of the flatten-Linear head: a grouped GEMM with
detector sites as the groups (counterpart of waveformml_tpu/ops/site_head.py).

The host sorts a batch's rows by site into a ``[S, MAX]`` slot grid
(``host_site_layout``). The device gathers each slot's row, multiplies it by
its site's ``[C, F]`` slice of the Linear kernel and adds the result into
its event's output row, which starts from the Linear's bias. That is kernel
K2 (``csrc/site_head.cu``) on the card and ``site_grouped_matmul_plain`` on
the CPU. Its gradient (``SiteGroupedMatmul``, an autograd Function) is
kernel K5 (``csrc/site_head_bwd.cu``) on the card and
``site_grouped_matmul_bwd_plain`` on the CPU.

Encoding: ``site_take``/``site_ev`` are 1-based with 0 = empty slot and
``site_s`` is the 1-based site of each group, so zero padding anywhere
means "empty".
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from waveformml_tpu_torch.detector import NX, NY
from waveformml_tpu_torch.ops import native

S = NX * NY

#: per-site capacity floor; capacities are powers of two at or above it
MIN_CAP = 8


def host_site_layout(coords: np.ndarray, mask: np.ndarray,
                     min_cap: int = MIN_CAP) -> Dict[str, np.ndarray]:
    """Slot layout of one padded batch: ``site_take`` [S, MAX] (1-based row,
    0 empty), ``site_ev`` [S, MAX] (1-based event, 0 empty), ``site_s`` [S]
    (1-based site). MAX is the smallest power of two ≥ the largest site
    occupancy and ≥ ``min_cap``. Coords must lie on the detector grid."""
    m = np.asarray(mask, bool)
    x = coords[:, 0].astype(np.int64)
    y = coords[:, 1].astype(np.int64)
    ev = coords[:, -1].astype(np.int64)
    s_eff = np.where(m, x * NY + y, S)            # padding rows sort last
    order = np.argsort(s_eff, kind="stable")
    n_real = int(m.sum())
    real = order[:n_real]
    s_sorted = s_eff[real]
    counts = np.bincount(s_sorted, minlength=S)[:S]
    cap = max(int(min_cap), int(counts.max()) if n_real else 1)
    max_slots = 1 << int(cap - 1).bit_length()
    starts = np.zeros(S, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    slots = s_sorted * max_slots + (np.arange(n_real, dtype=np.int64)
                                    - starts[s_sorted])
    take = np.zeros(S * max_slots, np.int32)
    take[slots] = real.astype(np.int32) + 1
    evs = np.zeros(S * max_slots, np.int32)
    evs[slots] = ev[real].astype(np.int32) + 1
    return {"site_take": take.reshape(S, max_slots),
            "site_ev": evs.reshape(S, max_slots),
            "site_s": np.arange(1, S + 1, dtype=np.int32)}


def site_grouped_matmul_plain(rows: torch.Tensor, k3: torch.Tensor,
                              take1: torch.Tensor, ev1: torch.Tensor,
                              site1: torch.Tensor, n_events: int,
                              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K2: gather (slot 0 reads a prepended zero
    row), one batched GEMM per site group, event scatter-add (slot 0 and
    events past ``n_events`` are dropped), then the bias if one is given."""
    g, max_slots = take1.shape
    c, f = rows.shape[1], k3.shape[2]
    padded = torch.cat([rows.new_zeros(1, c), rows])
    rs = padded[take1.reshape(-1).long()].reshape(g, max_slots, c)
    sg = (site1.long() - 1).clamp(0, k3.shape[1] - 1)
    kg = k3[:, sg, :].permute(1, 0, 2)                        # [G, C, F]
    rowlog = torch.bmm(rs.float(), kg.float())                # [G, MAX, F]
    evs = ev1.reshape(-1).long()
    idx = torch.where((evs > 0) & (evs <= n_events), evs - 1, n_events)
    out = torch.zeros((n_events + 1, f), dtype=torch.float32, device=rows.device)
    out.index_add_(0, idx, rowlog.reshape(g * max_slots, f))
    out = out[:n_events]
    return out if bias is None else out + bias.float()


_FUNCTIONS = {"site_grouped_matmul_fwd":
              [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
              "site_grouped_matmul_tile_slots": []}


def output_stride(f: int) -> int:
    """Row stride, in floats, of the kernel's ``[n_events, F]`` output: F
    rounded up to a multiple of 4, so that every row is 16-byte aligned and
    takes float4 adds."""
    return (f + 3) // 4 * 4


def tile_slots() -> int:
    """Slots K2's accumulate block lists and adds at a time, as the built
    kernel has it: a tile whose slots are all empty is skipped."""
    return native.load("site_head", _FUNCTIONS).site_grouped_matmul_tile_slots()


def _check(rows, k3, take1, ev1, site1, bias) -> None:
    if rows.dim() != 2 or k3.dim() != 3 or take1.dim() != 2:
        raise ValueError("expected rows [N, C], k3 [C, S, F], take1/ev1 [G, MAX], "
                         "site1 [G]")
    c = rows.shape[1]
    g = take1.shape[0]
    if k3.shape[0] != c or ev1.shape != take1.shape or site1.shape != (g,):
        raise ValueError(f"shape mismatch: rows {tuple(rows.shape)}, k3 "
                         f"{tuple(k3.shape)}, take1 {tuple(take1.shape)}, ev1 "
                         f"{tuple(ev1.shape)}, site1 {tuple(site1.shape)}")
    if bias is not None and bias.shape != (k3.shape[2],):
        raise ValueError(f"bias {tuple(bias.shape)} != ({k3.shape[2]},)")
    tensors = [rows, k3, take1, ev1, site1] + ([bias] if bias is not None else [])
    if any(t.device != rows.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if rows.is_cuda:
        if any(t.dtype != torch.float32 for t in (rows, k3)) or (
                bias is not None and bias.dtype != torch.float32):
            raise TypeError("the CUDA kernel takes float32 rows, k3 and bias")
        if any(t.dtype != torch.int32 for t in (take1, ev1, site1)):
            raise TypeError("the CUDA kernel takes int32 take1, ev1 and site1")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("the CUDA kernel takes contiguous tensors")


def site_grouped_matmul(rows: torch.Tensor, k3: torch.Tensor, take1: torch.Tensor,
                        ev1: torch.Tensor, site1: torch.Tensor, n_events: int,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Event outputs of the folded first Linear layer, site-grouped, with
    its bias.

    rows [N, C] (padding rows already zero), k3 [C, S, F] (the flatten-order
    kernel reshaped), take1/ev1 [G, MAX] int32 1-based (0 empty), site1 [G]
    int32 1-based (clamped to [1, S]), bias [F] or None (zero) → [n_events,
    F] float32. Row indices must lie in ``[0, N]``. CUDA tensors run kernel
    K2 (``csrc/site_head.cu``); CPU tensors run ``site_grouped_matmul_plain``.

    K2 replaces the XLA gather + einsum + scatter-add of
    waveformml_tpu/ops/site_head.py:site_grouped_matmul and the bias add
    after it in waveformml_tpu/models/blocks.py:FoldedSiteLinear. On the
    H100 it is bound at SubMPSD.json's head, (C, F) = (8, 50), by bytes
    (~800 FLOP per filled slot against ~230 bytes), and at a serving
    chunk's ~2 MB by the latency of its dependent steps; at SubMPSD_w128's
    (128, 199) by operations. Its design: no memset and no separate bias
    add (a first grid writes the bias into every event row, a second,
    programmatically dependent, adds the products); at (8, 50) one block
    per site group, which stages its weight slice once, lists each tile's
    live slots and gathers their rows; at every other width one block per
    (group, 64-column tile of F), which stages its weight tile once and
    streams the listed slots' rows through shared memory 32 at a time,
    double-buffered, into tensor-core products (mma.sync TF32 with the
    3-pass split of K1 and K4: fp32 accuracy but for ~2^-22 relative); and
    float4 adds into the event rows, one RED per 4 outputs. For
    those, the output is allocated ``[n_events, output_stride(F)]`` (16-byte
    aligned rows, the only layout the kernel takes) and the ``[:, :F]`` view
    is returned: for F = 50 rows are 52 floats apart.

    The adds of an event's slots land in an order that varies from run to
    run, so an output can differ from run to run, and from the plain
    version, by ~m ulp of the sum of the magnitudes of its m terms and the
    bias (m ≤ 4 at detector multiplicity): ~1e-7 relative, inside rtol =
    atol = 1e-5. The note in ``csrc/site_head.cu`` has the details.
    """
    _check(rows, k3, take1, ev1, site1, bias)
    if not rows.is_cuda:
        return site_grouped_matmul_plain(rows, k3, take1, ev1, site1, n_events, bias)
    g, max_slots = take1.shape
    c, s, f = k3.shape
    ldo = output_stride(f)
    out = torch.empty((n_events, ldo), dtype=torch.float32, device=rows.device)
    lib = native.load("site_head", _FUNCTIONS)
    err = lib.site_grouped_matmul_fwd(
        rows.data_ptr(), k3.data_ptr(), bias.data_ptr() if bias is not None else None,
        take1.data_ptr(), ev1.data_ptr(), site1.data_ptr(), out.data_ptr(), g,
        max_slots, c, s, f, ldo, n_events,
        torch.cuda.current_stream(rows.device).cuda_stream)
    native.check_launch(lib, err, "site_grouped_matmul")
    if n_events and f:
        # the bias grid, and where there are slots the products' grid
        native.count_launches(site_grouped_matmul, 2 if g and max_slots else 1)
    return out[:, :f]


site_grouped_matmul.launches = site_grouped_matmul.captured = 0


def site_grouped_matmul_bwd_plain(d_out: torch.Tensor, rows: torch.Tensor, k3: torch.Tensor,
                                  take1: torch.Tensor, ev1: torch.Tensor, site1: torch.Tensor,
                                  n_events: int, with_bias: bool = True):
    """Plain PyTorch version of K5: the autodiff of
    waveformml_tpu/ops/site_head.py:site_grouped_matmul and of the bias add
    after it, as JAX computes it: the event gather of d_out (0 for dropped
    slots), the two batched GEMMs and the two scatter-adds (slot 0 of the
    rows and groups of one site add up). Returns ``(d_rows, d_k3, d_bias)``,
    ``d_bias`` None unless ``with_bias``."""
    g, max_slots = take1.shape
    c, s, f = k3.shape
    evs = ev1.reshape(-1).long()
    live = (evs > 0) & (evs <= n_events)
    d_padded = torch.cat([d_out, d_out.new_zeros(1, f)])
    d_rowlog = d_padded[torch.where(live, evs - 1, n_events)].reshape(g, max_slots, f)
    sg = (site1.long() - 1).clamp(0, s - 1)
    kg = k3[:, sg, :].permute(1, 0, 2)                         # [G, C, F]
    take = take1.reshape(-1).long()
    d_rows = rows.new_zeros(rows.shape[0] + 1, c)
    d_rows.index_add_(0, take, torch.bmm(d_rowlog, kg.transpose(1, 2)).reshape(-1, c))
    rs = torch.cat([rows.new_zeros(1, c), rows])[take].reshape(g, max_slots, c)
    d_k3 = k3.new_zeros(s, c, f)
    d_k3.index_add_(0, sg, torch.bmm(rs.transpose(1, 2), d_rowlog))
    return (d_rows[1:], d_k3.permute(1, 0, 2).contiguous(),
            d_out.sum(0) if with_bias else None)


_BWD_FUNCTIONS = {"site_grouped_matmul_bwd":
                  [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
                  "site_grouped_matmul_bwd_scratch":
                  [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)] * 2}


def site_grouped_matmul_bwd(d_out: torch.Tensor, rows: torch.Tensor, k3: torch.Tensor,
                            take1: torch.Tensor, ev1: torch.Tensor, site1: torch.Tensor,
                            n_events: int, with_bias: bool = True):
    """Gradients of ``site_grouped_matmul`` with its bias: d_out [n_events,
    F] and the forward's operands → ``(d_rows [N, C], d_k3 [C, S, F],
    d_bias [F] or None)``. CUDA tensors run kernel K5
    (``csrc/site_head_bwd.cu``, which replaces the XLA autodiff of
    waveformml_tpu/ops/site_head.py:site_grouped_matmul and of the bias add
    in waveformml_tpu/models/blocks.py:FoldedSiteLinear); CPU tensors run
    ``site_grouped_matmul_bwd_plain``.

    K5 writes each filled slot's row gradient with a plain store: a row must
    sit in at most one slot, as in every layout ``host_site_layout`` builds
    (the plain version adds a row's slots up). It honours the forward's
    layout rules: slot 0 is empty, ``site1`` is clamped to ``[1, S]``, slots
    of events past ``n_events`` add nothing, and groups of one site add up.
    It takes d_out contiguous. Two grids: the first zeroes the row gradient
    and the tickets and sums d_out for the bias by runs of events; the
    second, a programmatic dependent launch, computes the rows' gradients
    and the weight slices'. At SubMPSD.json's head, (C, F) = (8, 50), it
    gives each group a block; at every other width, such as
    SubMPSD_w128's (128, 199), each (group, 32-channel tile, 256-column
    pass of F) a block, which streams the group's live slots through
    shared memory 32 at a time, double-buffered, into tensor-core products
    (mma.sync TF32, 3-pass split: the weight gradient's tile, and the
    chunk's row gradients over the full F). A block stores its tile
    into ``d_k3`` where its site has no other group; otherwise the last of
    the site's groups to finish the tile (an integer ticket per site and
    tile in the call's scratch, which the first grid zeroes) sums them in
    group order. The first block sums the bias's runs. There are no float
    atomics, so two runs give the same bits, and no state outlives a call,
    so calls on several streams may run at once.
    """
    _check(rows, k3, take1, ev1, site1, None)
    f = k3.shape[2]
    if d_out.dim() != 2 or d_out.shape != (n_events, f):
        raise ValueError(f"d_out {tuple(d_out.shape)} != ({n_events}, {f})")
    if d_out.device != rows.device:
        raise ValueError("all operands must be on one device")
    if not rows.is_cuda:
        return site_grouped_matmul_bwd_plain(d_out, rows, k3, take1, ev1, site1, n_events,
                                             with_bias)
    if d_out.dtype != torch.float32:
        raise TypeError("the CUDA kernel takes a float32 d_out")
    if not d_out.is_contiguous():
        raise ValueError("the CUDA kernel takes a contiguous d_out")
    g, max_slots = take1.shape
    n, c = rows.shape
    s = k3.shape[1]
    lib = native.load("site_head_bwd", _BWD_FUNCTIONS)
    groups_floats, bias_floats = ctypes.c_longlong(), ctypes.c_longlong()
    lib.site_grouped_matmul_bwd_scratch(g, c, s, f, n_events, ctypes.byref(groups_floats),
                                        ctypes.byref(bias_floats))
    dev = rows.device
    scratch = torch.empty(groups_floats.value + bias_floats.value, dtype=torch.float32,
                          device=dev)
    d_rows = torch.empty((n, c), dtype=torch.float32, device=dev)
    d_k3 = torch.empty((c, s, f), dtype=torch.float32, device=dev)
    d_bias = torch.empty(f, dtype=torch.float32, device=dev) if with_bias else None
    err = lib.site_grouped_matmul_bwd(
        d_out.data_ptr(), rows.data_ptr(), k3.data_ptr(), take1.data_ptr(), ev1.data_ptr(),
        site1.data_ptr(), d_rows.data_ptr(), d_k3.data_ptr(),
        d_bias.data_ptr() if with_bias else None, scratch.data_ptr(),
        scratch.data_ptr() + 4 * groups_floats.value, n, g, max_slots, c, s, f, n_events,
        torch.cuda.current_stream(dev).cuda_stream)
    native.check_launch(lib, err, "site_grouped_matmul_bwd")
    # zeroing and bias runs where there are rows, events or outputs (the
    # tickets), the groups' grid where there are outputs
    outputs = c * s * f + (f if with_bias else 0) > 0
    native.count_launches(site_grouped_matmul_bwd,
                          int(n > 0 or (with_bias and n_events > 0) or outputs) + int(outputs))
    return d_rows, d_k3, d_bias


site_grouped_matmul_bwd.launches = site_grouped_matmul_bwd.captured = 0


class SiteGroupedMatmul(torch.autograd.Function):
    """``site_grouped_matmul`` with its bias, differentiable in rows, k3 and
    the bias: the forward is K2, the backward K5. ``plain = True`` runs the
    plain forward and ``site_grouped_matmul_bwd_plain`` instead, whatever the
    device. The layout gets no gradient."""

    @staticmethod
    def forward(ctx, rows, k3, bias, take1, ev1, site1, n_events, plain=False):
        ctx.save_for_backward(rows, k3, take1, ev1, site1)
        ctx.n_events, ctx.with_bias, ctx.plain = n_events, bias is not None, plain
        fn = site_grouped_matmul_plain if plain else site_grouped_matmul
        return fn(rows, k3, take1, ev1, site1, n_events, bias)

    @staticmethod
    def backward(ctx, d_out):
        rows, k3, take1, ev1, site1 = ctx.saved_tensors
        fn = site_grouped_matmul_bwd_plain if ctx.plain else site_grouped_matmul_bwd
        d_rows, d_k3, d_bias = fn(d_out.contiguous(), rows, k3, take1, ev1, site1,
                                  ctx.n_events, ctx.with_bias)
        return d_rows, d_k3, d_bias, None, None, None, None, None
