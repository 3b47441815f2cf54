"""Row-space submanifold convolution: a gather-GEMM over active sites only
(counterpart of waveformml_tpu/ops/row_conv.py).

The neighbour plan ``[N, K²]`` int32 lists, for each row, the row of each
site in its centred K×K window (-1 where the site is empty, out of the
detector or the row is padding); a 3D batch's ``[N, K³]`` plan lists the
K×K×K window over (x, y, t). It depends on coords only, so the host
builds it once per batch with numpy and every conv of the stack shares it.
The conv itself is the custom op ``waveformml::subm_conv_rows``: kernel K1
(``csrc/row_conv.cu``) for CUDA tensors, ``subm_conv_rows_plain`` for CPU
tensors, the dispatcher choosing by device. K1 and K4 each have two designs,
picked by ``row_design`` from the conv's shape: "taps" for the 3x3x3 window
at narrow channels, "tiles" for every other shape.

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
from waveformml_tpu_torch.ops.sparse import SparseBatch, scatter_to_dense, scatter_to_dense_3d


def host_neighbor_plan(coords: np.ndarray, mask: np.ndarray, n_events: int,
                       kernel_size: int, n_t: Optional[int] = None) -> np.ndarray:
    """Neighbour rows ``[N, K²]`` int32 of a centred K×K window, -1 where
    absent, tap order ``(dx, dy)`` row-major with dx, dy in ``-h..h``; with
    ``n_t`` (coords ``[N, 4]`` = x, y, t, event) ``[N, K³]`` of a K×K×K
    window over (x, y, t) of T = n_t samples, tap order ``(dx, dy, dt)``
    row-major."""
    k = int(kernel_size)
    if k % 2 != 1:
        # the backward of this conv reuses the plan with the window reversed,
        # which holds only for a window symmetric under negation (odd k)
        raise ValueError(f"row-space SubM conv requires an odd kernel size, got {k}")
    x = coords[:, 0].astype(np.int32)
    y = coords[:, 1].astype(np.int32)
    ev = coords[:, -1].astype(np.int32)
    m = np.asarray(mask, dtype=bool)
    n_t = None if n_t is None else int(n_t)
    span = 1 if n_t is None else n_t
    size = int(n_events) * NX * NY * span
    if size >= 2 ** 31:
        raise ValueError("flat site index overflows int32")
    t = np.zeros_like(x) if n_t is None else coords[:, 2].astype(np.int32)
    flat = ev * (NX * NY * span) + x * (NY * span) + y * span + t
    lut = np.full((size,), -1, np.int32)
    rows = np.arange(coords.shape[0], dtype=np.int32)
    in_range = m & (flat >= 0) & (flat < size)
    lut[flat[in_range]] = rows[in_range]
    half = (k - 1) // 2
    taps = range(-half, k - half)
    offs = np.asarray([(dx, dy, dt) for dx in taps for dy in taps
                       for dt in (taps if n_t is not None else (0,))], dtype=np.int32)
    nx_ = x[:, None] + offs[None, :, 0]
    ny_ = y[:, None] + offs[None, :, 1]
    nt_ = t[:, None] + offs[None, :, 2]
    valid = ((nx_ >= 0) & (nx_ < NX) & (ny_ >= 0) & (ny_ < NY) & (nt_ >= 0) & (nt_ < span)
             & m[:, None])
    site = ev[:, None] * (NX * NY * span) + nx_ * (NY * span) + ny_ * span + nt_
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


def rows_to_dense_3d(rows: torch.Tensor, batch: SparseBatch, n_t: int) -> torch.Tensor:
    """A 3D stack's final rows on the ``[B, C, NX, NY, T]`` grid, as a
    channels-last view of the scatter."""
    return scatter_to_dense_3d(batch, n_t, rows).permute(0, 4, 1, 2, 3)


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


#: the taps design's window (3x3x3) and widest Cin and Cout
#: (``csrc/row_conv.cu``, ``csrc/row_conv_wgrad.cu``)
TAP_KK, TAP_MAX = 27, 16


def row_design(kk: int, cin: int, cout: int) -> str:
    """The design of K1 and K4 that takes a conv of ``kk`` taps, ``cin``
    input and ``cout`` output channels (K1 as d_feats: the two swapped):
    ``"taps"`` for the 3x3x3 window with both widths at most 16 (one pass,
    a row a thread in K1; row chunks over every (tap, channel) pair in K4),
    ``"tiles"`` for every other shape (the tensor-core designs, every 9-tap
    conv among them). The source notes of ``csrc/row_conv.cu`` and
    ``csrc/row_conv_wgrad.cu`` give the measurements behind it."""
    return "taps" if kk == TAP_KK and cin <= TAP_MAX and cout <= TAP_MAX else "tiles"


def k1_grids(kk: int, cin: int, cout: int) -> int:
    """Grids one K1 call launches where it has rows and outputs: one for
    the taps design and for K² = 1; the centre tap's and the other taps'
    for the tiles design."""
    return 1 if kk == 1 or row_design(kk, cin, cout) == "taps" else 2


_FUNCTIONS = {"subm_conv_rows_fwd":
              [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
              "subm_conv_rows_taps_fwd":
              [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
              "subm_conv_rows_take_row_taps": [ctypes.POINTER(ctypes.c_longlong)]}


def take_row_taps() -> int:
    """Row-taps kernel K1 computed on the card since the last call (tiles
    design: for each block, its rows that have its tap, rounded up to whole
    mma groups; taps design: the present row-taps of the rows whose mask is
    on), as the kernel counted them; restarts the count. Synchronises the
    device."""
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
    """The CUDA kernel of the op: K1's launch, in the design ``row_design``
    picks, on operands that ``_check`` has passed."""
    n, cin = feats.shape
    kk, _, cout = kernel.shape
    out = torch.empty((n, cout), dtype=torch.float32, device=feats.device)
    lib = native.load("row_conv", _FUNCTIONS)
    launch = (lib.subm_conv_rows_taps_fwd if row_design(kk, cin, cout) == "taps"
              else lib.subm_conv_rows_fwd)
    err = launch(
        feats.data_ptr(), plan.data_ptr(), kernel.data_ptr(),
        bias.data_ptr() if bias is not None else None, mask.data_ptr(),
        out.data_ptr(), n, cin, cout, kk,
        torch.cuda.current_stream(feats.device).cuda_stream)
    native.check_launch(lib, err, "subm_conv_rows")
    if n and cout:
        native.count_launches(subm_conv_rows, k1_grids(kk, cin, cout))
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
    loads (no [N, K², Cin] operand in memory). Its tiles design multiplies
    only the rows that have a tap, in groups of 8, on the tensor cores in
    TF32 with a 3-pass split that keeps fp32 accuracy: one launch writes the
    centre tap, bias and mask per 32-row tile, a second adds the other taps
    per 256-row block with fp32 atomics, so a row with two or more
    off-centre taps can differ in its last bits from run to run. Its taps
    design (27 taps, Cin and Cout ≤ 16: ``row_design``) is one launch, a row
    a thread, the present taps' features gathered and summed in fp32 FFMA
    in tap order, so two runs give the same bits (the note in
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
                    [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)] * 2,
                    "subm_conv_rows_wgrad_taps_scratch":
                    [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
                    + [ctypes.POINTER(ctypes.c_longlong)],
                    "subm_conv_rows_wgrad_taps":
                    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]}


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
    """The CUDA kernel of the op: K4's launch, in the design ``row_design``
    picks, on operands that ``_check_wgrad`` has passed (d_bias ``[0]``
    without the bias)."""
    n, cin = feats.shape
    kk, cout = plan.shape[1], g.shape[1]
    lib = native.load("row_conv_wgrad", _WGRAD_FUNCTIONS)
    dev = feats.device
    d_kernel = torch.empty((kk, cin, cout), dtype=torch.float32, device=dev)
    d_bias = torch.empty(cout if with_bias else 0, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    db = d_bias.data_ptr() if with_bias else None
    if row_design(kk, cin, cout) == "taps":
        blocks, rows, floats = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
        native.check_launch(lib, lib.subm_conv_rows_wgrad_taps_scratch(
            n, cin, cout, ctypes.byref(blocks), ctypes.byref(rows), ctypes.byref(floats)),
            "subm_conv_rows_wgrad_taps_scratch")
        partial = torch.empty(floats.value, dtype=torch.float32, device=dev)
        err = lib.subm_conv_rows_wgrad_taps(
            feats.data_ptr(), plan.data_ptr(), g.data_ptr(), mask.data_ptr(),
            partial.data_ptr(), d_kernel.data_ptr(), db, n, cin, cout, kk, stream)
    else:
        floats, ints = ctypes.c_longlong(), ctypes.c_longlong()
        lib.subm_conv_rows_wgrad_scratch(n, cin, cout, kk, ctypes.byref(floats),
                                         ctypes.byref(ints))
        partial = torch.empty(floats.value, dtype=torch.float32, device=dev)
        lists = torch.empty(ints.value, dtype=torch.int32, device=dev)
        err = lib.subm_conv_rows_wgrad(
            feats.data_ptr(), plan.data_ptr(), g.data_ptr(), mask.data_ptr(),
            partial.data_ptr(), lists.data_ptr(), d_kernel.data_ptr(), db, n, cin, cout, kk,
            stream)
    native.check_launch(lib, err, "subm_conv_rows_wgrad")
    # where there are outputs, in both designs: the partials' grid where
    # there are rows, and the reduction's grid
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

    K4's tiles design takes the centre tap, present for every real row, as
    a split-K GEMM on the tensor cores (TF32 with a 3-pass split, fp32
    accuracy): each block owns a range of rows and the whole (Cin + 1,
    Cout) tile, so feats and g are read once, and db is row Cin of the
    product (a column of ones where the mask is on). Clusters of 8 blocks
    sum their tiles through distributed shared memory in rank order; a
    second grid, programmatically dependent, sums the clusters' partials in
    order and multiplies the other taps' row pairs, which the first grid
    listed from one coalesced read of the plan. Its taps design (27 taps,
    Cin and Cout ≤ 16: ``row_design``) gives each block row chunks whose
    plan and g it stages once, and each thread a (tap, channel) pair and a
    row lane, summed in FFMA; each block writes one partial, and a second
    grid, programmatically dependent, sums them in block order. There are
    no float atomics in either, so two runs give the same bits; the sums
    run in another order than the plain version's, so the two differ by a
    few ulp of the sum of the magnitudes of each output's terms.
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
