"""Row-space submanifold convolution: a gather-GEMM over active sites only
(counterpart of waveformml_tpu/ops/row_conv.py).

The neighbour plan ``[N, K²]`` int32 lists, for each row, the row of each
site in its centred K×K window (-1 where the site is empty, out of the
detector or the row is padding). It depends on coords only, so the host
builds it once per batch with numpy and every conv of the stack shares it.
The conv itself is the custom op ``waveformml::subm_conv_rows``: kernel K1
(``csrc/row_conv.cu``) for CUDA tensors, ``subm_conv_rows_plain`` for CPU
tensors, the dispatcher choosing by device.

Its gradient (``SubMConvRows``, an autograd Function) follows the JAX
package's custom VJP (waveformml_tpu/ops/row_conv.py:_subm_bwd): the
feature gradient is K1 again, over the same plan, with the window reversed
and the kernel transposed; the kernel and bias gradients are the custom op
``waveformml::subm_conv_rows_wgrad``: kernel K4 (``csrc/row_conv_wgrad.cu``)
for CUDA tensors, ``subm_conv_rows_wgrad_plain`` for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from waveformml_tpu_torch.detector import NX, NY
from waveformml_tpu_torch.ops import native
from waveformml_tpu_torch.ops.sparse import SparseBatch, scatter_to_dense


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


def rows_to_dense(rows: torch.Tensor, batch: SparseBatch) -> torch.Tensor:
    """A stack's final rows ``[N, C]`` on the dense grid in the JAX
    package's ``[B, C, NX, NY]`` order (two rows at one site summed), as a
    channels-last view of the scatter: only the final channel count pays
    for the scatter."""
    return scatter_to_dense(batch, rows).permute(0, 3, 1, 2)


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


def subm_conv_rows_cuda(feats: torch.Tensor, plan: torch.Tensor, kernel: torch.Tensor,
                        bias: Optional[torch.Tensor], mask: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel of the op: K1's launch on operands that ``_check``
    has passed."""
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
        native.count_launches(subm_conv_rows, 1 if kk == 1 else 2)
    return out


def _subm_conv_rows_fake(feats, plan, kernel, bias, mask):
    dtype = torch.promote_types(feats.dtype, kernel.dtype)
    if bias is not None:
        dtype = torch.promote_types(dtype, bias.dtype)
    return feats.new_empty((feats.shape[0], kernel.shape[2]), dtype=dtype)


subm_conv_rows_op = native.define_op(
    "subm_conv_rows",
    "(Tensor feats, Tensor plan, Tensor kernel, Tensor? bias, Tensor mask) -> Tensor",
    cpu=subm_conv_rows_plain, cuda=subm_conv_rows_cuda, fake=_subm_conv_rows_fake)


def subm_conv_rows(feats: torch.Tensor, plan: torch.Tensor, kernel: torch.Tensor,
                   bias: Optional[torch.Tensor], mask: torch.Tensor) -> torch.Tensor:
    """Row-space SubM conv: ``out[r] = mask[r]·(Σ_k feats[plan[r, k]] @
    kernel[k] + bias)``, absent taps (-1) contributing zero.

    feats [N, Cin], plan [N, K²] int32, kernel [K², Cin, Cout], bias [Cout]
    or None, mask [N] bool → [N, Cout]. Checks its operands, then calls
    the custom op ``waveformml::subm_conv_rows``, which runs kernel K1
    (``csrc/row_conv.cu``, which replaces the XLA gather + GEMM of
    waveformml_tpu/ops/row_conv.py:subm_conv_rows) on CUDA tensors and
    ``subm_conv_rows_plain`` on CPU tensors. Plan entries must lie in
    ``[-1, N)``.

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
    return subm_conv_rows_op(feats, plan, kernel, bias, mask)


subm_conv_rows.launches = subm_conv_rows.captured = 0


def transposed_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """The kernel of the feature gradient's conv: the window reversed (k →
    K² - 1 - k) and Cin, Cout swapped, ``[K², Cout, Cin]`` contiguous. The
    centred odd window is symmetric under negation, so the conv with it over
    the forward's plan is the transpose of the forward conv."""
    return torch.flip(kernel, (0,)).transpose(1, 2).contiguous()


def subm_conv_rows_wgrad_plain(feats: torch.Tensor, plan: torch.Tensor, g: torch.Tensor,
                               mask: torch.Tensor, with_bias: bool = True):
    """Plain PyTorch version of K4: ``d_kernel`` and ``d_bias`` of
    waveformml_tpu/ops/row_conv.py:_subm_bwd, the forward's gather
    contracted against the masked cotangent over the rows."""
    n, c = feats.shape
    kk = plan.shape[1]
    g = g.masked_fill(~mask[:, None], 0)
    padded = torch.cat([feats, feats.new_zeros(1, c)])
    idx = torch.where(plan >= 0, plan, n).long()
    d_kernel = (padded[idx].reshape(n, kk * c).t() @ g).reshape(kk, c, -1)
    return d_kernel, (g.sum(0) if with_bias else None)


def subm_conv_rows_bwd_plain(feats: torch.Tensor, plan: torch.Tensor, kernel: torch.Tensor,
                             mask: torch.Tensor, g: torch.Tensor, with_bias: bool = True,
                             need_feats: bool = True):
    """waveformml_tpu/ops/row_conv.py:_subm_bwd line for line, in plain
    PyTorch: ``(d_feats, d_kernel, d_bias)``, ``d_feats`` None unless
    ``need_feats``. ``d_feats`` is the conv of the masked g with the
    reversed, transposed kernel; where the plan names another row for a
    centre tap (duplicate sites) that is the reference's value, not the true
    gradient."""
    g = g.masked_fill(~mask[:, None], 0)
    d_feats = (subm_conv_rows_plain(g, plan, transposed_kernel(kernel), None, mask)
               if need_feats else None)
    d_kernel, d_bias = subm_conv_rows_wgrad_plain(feats, plan, g, mask, with_bias)
    return d_feats, d_kernel, d_bias


_WGRAD_FUNCTIONS = {"subm_conv_rows_wgrad":
                    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
                    "subm_conv_rows_wgrad_scratch":
                    [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)] * 2}


def _check_wgrad(feats, plan, g, mask) -> None:
    if feats.dim() != 2 or plan.dim() != 2 or g.dim() != 2 or mask.dim() != 1:
        raise ValueError("expected feats [N, Cin], plan [N, K²], g [N, Cout], mask [N]")
    n = feats.shape[0]
    if plan.shape[0] != n or g.shape[0] != n or mask.shape != (n,):
        raise ValueError(f"shape mismatch: feats {tuple(feats.shape)}, plan "
                         f"{tuple(plan.shape)}, g {tuple(g.shape)}, mask {tuple(mask.shape)}")
    tensors = (feats, plan, g, mask)
    if any(t.device != feats.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if feats.is_cuda:
        if feats.dtype != torch.float32 or g.dtype != torch.float32:
            raise TypeError("the CUDA kernel takes float32 feats and g")
        if plan.dtype != torch.int32 or mask.dtype != torch.bool:
            raise TypeError("the CUDA kernel takes an int32 plan and a bool mask")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("the CUDA kernel takes contiguous tensors")


def _subm_conv_rows_wgrad_cpu(feats, plan, g, mask, with_bias):
    # an op returns no None: d_bias is [0] without the bias
    d_kernel, d_bias = subm_conv_rows_wgrad_plain(feats, plan, g, mask, with_bias)
    return d_kernel, d_bias if with_bias else g.new_empty(0)


def subm_conv_rows_wgrad_cuda(feats: torch.Tensor, plan: torch.Tensor, g: torch.Tensor,
                              mask: torch.Tensor, with_bias: bool
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel of the op: K4's launch on operands that
    ``_check_wgrad`` has passed (d_bias ``[0]`` without the bias)."""
    n, cin = feats.shape
    kk, cout = plan.shape[1], g.shape[1]
    lib = native.load("row_conv_wgrad", _WGRAD_FUNCTIONS)
    floats, ints = ctypes.c_longlong(), ctypes.c_longlong()
    lib.subm_conv_rows_wgrad_scratch(n, cin, cout, kk, ctypes.byref(floats), ctypes.byref(ints))
    dev = feats.device
    partial = torch.empty(floats.value, dtype=torch.float32, device=dev)
    lists = torch.empty(ints.value, dtype=torch.int32, device=dev)
    d_kernel = torch.empty((kk, cin, cout), dtype=torch.float32, device=dev)
    d_bias = torch.empty(cout if with_bias else 0, dtype=torch.float32, device=dev)
    err = lib.subm_conv_rows_wgrad(
        feats.data_ptr(), plan.data_ptr(), g.data_ptr(), mask.data_ptr(),
        partial.data_ptr(), lists.data_ptr(), d_kernel.data_ptr(),
        d_bias.data_ptr() if with_bias else None, n, cin, cout, kk,
        torch.cuda.current_stream(dev).cuda_stream)
    native.check_launch(lib, err, "subm_conv_rows_wgrad")
    # where there are outputs: the centre tap's grid where there are rows,
    # and the reduction's grid
    if kk * cin * cout + (cout if with_bias else 0) > 0:
        native.count_launches(subm_conv_rows_wgrad, int(n > 0 and cout > 0) + 1)
    return d_kernel, d_bias


def _subm_conv_rows_wgrad_fake(feats, plan, g, mask, with_bias):
    cout = g.shape[1]
    return (feats.new_empty((plan.shape[1], feats.shape[1], cout),
                            dtype=torch.promote_types(feats.dtype, g.dtype)),
            g.new_empty(cout if with_bias else 0))


subm_conv_rows_wgrad_op = native.define_op(
    "subm_conv_rows_wgrad",
    "(Tensor feats, Tensor plan, Tensor g, Tensor mask, bool with_bias) -> (Tensor, Tensor)",
    cpu=_subm_conv_rows_wgrad_cpu, cuda=subm_conv_rows_wgrad_cuda,
    fake=_subm_conv_rows_wgrad_fake)


def subm_conv_rows_wgrad(feats: torch.Tensor, plan: torch.Tensor, g: torch.Tensor,
                         mask: torch.Tensor, with_bias: bool = True):
    """Kernel and bias gradients of ``subm_conv_rows``: ``dW[k] = Σ_r
    mask[r]·feats[plan[r, k]]ᵀ g[r]`` (absent taps zero) and ``db = Σ_r
    mask[r]·g[r]``.

    feats [N, Cin], plan [N, K²] int32, g [N, Cout], mask [N] bool →
    (d_kernel [K², Cin, Cout], d_bias [Cout] or None). Checks its operands,
    then calls the custom op ``waveformml::subm_conv_rows_wgrad``, which
    runs kernel K4 (``csrc/row_conv_wgrad.cu``, which replaces the XLA
    gather + contraction of waveformml_tpu/ops/row_conv.py:_subm_bwd) on
    CUDA tensors and ``subm_conv_rows_wgrad_plain`` on CPU tensors; the op
    gives an empty d_bias for ``with_bias=False``. Plan entries must lie in
    ``[-1, N)``.

    K4 takes the centre tap, present for every real row, as a split-K GEMM
    on the tensor cores (TF32 with a 3-pass split, fp32 accuracy): each
    block owns a range of rows and the whole (Cin + 1, Cout) tile, so feats
    and g are read once, and db is row Cin of the product (a column of ones
    where the mask is on). Clusters of 8 blocks sum their tiles through
    distributed shared memory in rank order; a second grid, programmatically
    dependent, sums the clusters' partials in order and multiplies the other
    taps' row pairs, which the first grid listed from one coalesced read of
    the plan. There are no float atomics, so two runs give the same bits;
    the sums run in another order than the plain version's, so the two
    differ by a few ulp of the sum of the magnitudes of each output's terms.
    """
    _check_wgrad(feats, plan, g, mask)
    d_kernel, d_bias = subm_conv_rows_wgrad_op(feats, plan, g, mask, with_bias)
    return d_kernel, d_bias if with_bias else None


subm_conv_rows_wgrad.launches = subm_conv_rows_wgrad.captured = 0


class SubMConvRows(torch.autograd.Function):
    """``subm_conv_rows`` with the JAX package's custom VJP
    (waveformml_tpu/ops/row_conv.py:_subm_bwd): g is masked; d_feats is K1
    over the same plan and mask with ``transposed_kernel`` and no bias,
    computed only where feats needs a gradient (not for the first conv of a
    stack, whose input is the waveforms); d_kernel and d_bias are K4.
    ``plain = True`` runs the plain forward and ``subm_conv_rows_bwd_plain``
    instead, whatever the device. The plan and mask get no gradient.

    bf16 feats (``half_precision``'s first conv; the kernel and bias stay
    float32) follow the JAX package's order and rounding points with the
    float32 kernels: the forward runs K1 on the feats widened to float32
    (exact) without the bias, rounds its sums to bf16, then adds the
    float32 bias (a float32 output) and applies the row mask. K1 cannot
    round inside itself: its off-centre grid adds into the output after the
    centre grid has written it. The backward rounds the masked g to bf16
    before K4, and rounds d_bias (and d_feats, returned as bf16) to bf16;
    d_kernel is K4's float32 sum."""

    @staticmethod
    def forward(ctx, feats, plan, kernel, bias, mask, plain=False):
        ctx.save_for_backward(feats, plan, kernel, mask)
        ctx.with_bias = bias is not None
        ctx.plain = plain
        fn = subm_conv_rows_plain if plain else subm_conv_rows
        if feats.dtype != torch.bfloat16:
            return fn(feats, plan, kernel, bias, mask)
        out = fn(feats.float(), plan, kernel, None, mask).to(torch.bfloat16)
        if bias is not None:
            out = out + bias
        return torch.where(mask[:, None], out, torch.zeros((), dtype=out.dtype,
                                                           device=out.device))

    @staticmethod
    def backward(ctx, g):
        feats, plan, kernel, mask = ctx.saved_tensors
        need_feats = ctx.needs_input_grad[0]
        half = feats.dtype == torch.bfloat16
        if half:
            g = g.masked_fill(~mask[:, None], 0).to(torch.bfloat16).float()
            feats = feats.float()
        if ctx.plain:
            d_feats, d_kernel, d_bias = subm_conv_rows_bwd_plain(
                feats, plan, kernel, mask, g, ctx.with_bias, need_feats)
        else:
            g = g.masked_fill(~mask[:, None], 0).contiguous()
            d_feats = (subm_conv_rows(g, plan, transposed_kernel(kernel), None, mask)
                       if need_feats else None)
            d_kernel, d_bias = subm_conv_rows_wgrad(feats, plan, g, mask, ctx.with_bias)
        if half:
            d_feats = d_feats.to(torch.bfloat16) if d_feats is not None else None
            d_bias = d_bias.to(torch.bfloat16).float() if d_bias is not None else None
        return d_feats, None, d_kernel, d_bias, None, None
