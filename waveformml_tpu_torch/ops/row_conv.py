"""Row-space submanifold convolution: a gather-GEMM over active sites only
(counterpart of waveformml_tpu/ops/row_conv.py).

The neighbour plan ``[N, K²]`` int32 lists, for each row, the row of each
site in its centred K×K window (-1 where the site is empty, out of the
detector or the row is padding). It depends on coords only, so the host
builds it once per batch with numpy and every conv of the stack shares it.
The conv itself is kernel K1 (``csrc/row_conv.cu``) on the card and
``subm_conv_rows_plain`` on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from waveformml_tpu_torch.detector import NX, NY
from waveformml_tpu_torch.ops import native


def host_neighbor_plan(coords: np.ndarray, mask: np.ndarray, n_events: int,
                       kernel_size: int) -> np.ndarray:
    """Neighbour rows ``[N, K²]`` int32 of a centred K×K window, -1 where
    absent, tap order ``(dx, dy)`` row-major with dx, dy in ``-h..h``."""
    k = int(kernel_size)
    if k % 2 != 1:
        # the backward of this conv reuses the plan with the window reversed,
        # which holds only for a window symmetric under negation (odd k)
        raise ValueError(f"row-space SubM conv requires an odd kernel size, got {k}")
    x = coords[:, 0].astype(np.int32)
    y = coords[:, 1].astype(np.int32)
    ev = coords[:, -1].astype(np.int32)
    m = np.asarray(mask, dtype=bool)
    size = int(n_events) * NX * NY
    if size >= 2 ** 31:
        raise ValueError("flat site index overflows int32")
    flat = ev * (NX * NY) + x * NY + y
    lut = np.full((size,), -1, np.int32)
    rows = np.arange(coords.shape[0], dtype=np.int32)
    in_range = m & (flat >= 0) & (flat < size)
    lut[flat[in_range]] = rows[in_range]
    half = (k - 1) // 2
    offs = np.asarray([(dx, dy) for dx in range(-half, k - half)
                       for dy in range(-half, k - half)], dtype=np.int32)
    nx_ = x[:, None] + offs[None, :, 0]
    ny_ = y[:, None] + offs[None, :, 1]
    valid = (nx_ >= 0) & (nx_ < NX) & (ny_ >= 0) & (ny_ < NY) & m[:, None]
    site = ev[:, None] * (NX * NY) + nx_ * NY + ny_
    np.clip(site, 0, size - 1, out=site)
    plan = lut[site]
    plan[~valid] = -1
    return plan


def subm_conv_rows_plain(feats: torch.Tensor, plan: torch.Tensor,
                         kernel: torch.Tensor, bias: Optional[torch.Tensor],
                         mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: gather through the plan (absent taps read
    an appended zero row), one GEMM over K²·Cin, bias, row mask."""
    n, c = feats.shape
    kk, _, cout = kernel.shape
    padded = torch.cat([feats, feats.new_zeros(1, c)])
    idx = torch.where(plan >= 0, plan, n).long()
    out = padded[idx].reshape(n, kk * c) @ kernel.reshape(kk * c, cout)
    if bias is not None:
        out = out + bias
    return torch.where(mask[:, None], out, torch.zeros((), dtype=out.dtype,
                                                       device=out.device))


_FUNCTIONS = {"subm_conv_rows_fwd":
              [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
              "subm_conv_rows_take_row_taps": [ctypes.POINTER(ctypes.c_longlong)]}


def take_row_taps() -> int:
    """Row-taps kernel K1 computed on the card since the last call (for each
    block, its rows that have its tap, rounded up to whole mma groups), as
    the kernel counted them; restarts the count. Synchronises the device."""
    lib = native.load("row_conv", _FUNCTIONS)
    count = ctypes.c_longlong()
    torch.cuda.synchronize()
    native.check_launch(lib, lib.subm_conv_rows_take_row_taps(ctypes.byref(count)),
                        "subm_conv_rows_take_row_taps")
    return count.value


def _check(feats, plan, kernel, bias, mask) -> None:
    if feats.dim() != 2 or plan.dim() != 2 or kernel.dim() != 3 or mask.dim() != 1:
        raise ValueError("expected feats [N, Cin], plan [N, K²], kernel "
                         "[K², Cin, Cout], mask [N]")
    n, cin = feats.shape
    kk, kcin, cout = kernel.shape
    if plan.shape != (n, kk) or kcin != cin or mask.shape != (n,):
        raise ValueError(f"shape mismatch: feats {tuple(feats.shape)}, plan "
                         f"{tuple(plan.shape)}, kernel {tuple(kernel.shape)}, "
                         f"mask {tuple(mask.shape)}")
    if bias is not None and bias.shape != (cout,):
        raise ValueError(f"bias {tuple(bias.shape)} != ({cout},)")
    tensors = [feats, plan, kernel, mask] + ([bias] if bias is not None else [])
    if any(t.device != feats.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if feats.is_cuda:
        if any(t.dtype != torch.float32 for t in (feats, kernel)) or (
                bias is not None and bias.dtype != torch.float32):
            raise TypeError("the CUDA kernel takes float32 feats, kernel and bias")
        if plan.dtype != torch.int32 or mask.dtype != torch.bool:
            raise TypeError("the CUDA kernel takes an int32 plan and a bool mask")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("the CUDA kernel takes contiguous tensors")


def subm_conv_rows(feats: torch.Tensor, plan: torch.Tensor, kernel: torch.Tensor,
                   bias: Optional[torch.Tensor], mask: torch.Tensor) -> torch.Tensor:
    """Row-space SubM conv: ``out[r] = mask[r]·(Σ_k feats[plan[r, k]] @
    kernel[k] + bias)``, absent taps (-1) contributing zero.

    feats [N, Cin], plan [N, K²] int32, kernel [K², Cin, Cout], bias [Cout]
    or None, mask [N] bool → [N, Cout]. CUDA tensors run kernel K1
    (``csrc/row_conv.cu``, which replaces the XLA gather + GEMM of
    waveformml_tpu/ops/row_conv.py:subm_conv_rows); CPU tensors run
    ``subm_conv_rows_plain``. Plan entries must lie in ``[-1, N)``.

    On the H100 it is bound by bytes. K1 fuses the gather into its operand
    loads (no [N, K², Cin] operand in memory) and multiplies only the rows
    that have a tap, in groups of 8, on the tensor cores in TF32 with a
    3-pass split that keeps fp32 accuracy: one launch writes the centre tap,
    bias and mask per 32-row tile, a second adds the other taps per 256-row
    block with fp32 atomics, so a row with two or more off-centre taps can
    differ in its last bits from run to run (the note in
    ``csrc/row_conv.cu`` has the details).
    """
    _check(feats, plan, kernel, bias, mask)
    if not feats.is_cuda:
        return subm_conv_rows_plain(feats, plan, kernel, bias, mask)
    n, cin = feats.shape
    kk, _, cout = kernel.shape
    out = torch.empty((n, cout), dtype=torch.float32, device=feats.device)
    lib = native.load("row_conv", _FUNCTIONS)
    err = lib.subm_conv_rows_fwd(
        feats.data_ptr(), plan.data_ptr(), kernel.data_ptr(),
        bias.data_ptr() if bias is not None else None, mask.data_ptr(),
        out.data_ptr(), n, cin, cout, kk,
        torch.cuda.current_stream(feats.device).cuda_stream)
    native.check_launch(lib, err, "subm_conv_rows")
    if n and cout:
        # the centre tap's grid, and for K² > 1 the other taps' grid
        subm_conv_rows.launches += 1 if kk == 1 else 2
    return out


subm_conv_rows.launches = 0
