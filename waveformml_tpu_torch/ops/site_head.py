"""Site-grouped execution of the flatten-Linear head: a grouped GEMM with
detector sites as the groups (counterpart of waveformml_tpu/ops/site_head.py).

The host sorts a batch's rows by site into a ``[S, MAX]`` slot grid
(``host_site_layout``). The device gathers each slot's row, multiplies it by
its site's ``[C, F]`` slice of the Linear kernel and adds the result into
its event's output row, which starts from the Linear's bias. That is kernel
K2 (``csrc/site_head.cu``) on the card and ``site_grouped_matmul_plain`` on
the CPU.

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
    H100 it is bound by bytes (~800 FLOP per filled slot against ~230
    bytes), and at a serving chunk's ~2 MB by the latency of its dependent
    steps. Its design: no memset and no separate bias add (a first grid
    writes the bias into every event row, a second, programmatically
    dependent, adds the products); one block per site group, which stages
    its weight slice once, lists each tile's live slots and gathers their
    rows; and float4 adds into the event rows, one RED per 4 outputs. For
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
        site_grouped_matmul.launches += 2 if g and max_slots else 1
    return out[:, :f]


site_grouped_matmul.launches = 0
