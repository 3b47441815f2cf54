"""The six kernels as ``torch.library`` custom ops (``waveformml::*``), on
the CPU: ``torch.library.opcheck`` passes for each at narrow sizes, K1 and
K4 also at a 27-tap shape, their taps design's, the 3D plan kernel at 1,
27 and 125 taps (its schema, fake kernel
and compiled-graph tests); each public wrapper gives its
plain version's tensors bitwise; the fake kernel gives the CPU
implementation's shapes, dtypes and strides (K2's rows padded to
``output_stride(F)`` on every device); ``torch.export`` of a module that calls
one op holds one node of it; each op has a CUDA kernel of its own, so that a
CUDA tensor never reaches the plain version."""
import numpy as np
import pytest
import torch

from waveformml_tpu_torch.datasets.synthetic import (adversarial_waveforms, conv_case,
                                                     site_layout_case)
from waveformml_tpu_torch.ops import native, row_conv, site_head, waveform_features
from waveformml_tpu_torch.ops.row_conv import host_neighbor_plan

OPS = ("subm_conv_rows", "subm_conv_rows_wgrad", "site_grouped_matmul",
       "site_grouped_matmul_bwd", "waveform_features", "subm_conv_rows_plan")


def _conv_args(seed, k=3, with_bias=True, n_rows=64, cin=4, cout=8):
    """K1's operands: 64 rows (padding at the end), Cin 4, Cout 8, K² 9."""
    rng = np.random.default_rng(seed)
    coords, feats, kernel, bias, mask = conv_case(rng, "clustered", 12, k, cin, cout, n_rows)
    plan = host_neighbor_plan(coords, mask, 12, k)
    return [torch.from_numpy(feats), torch.from_numpy(plan), torch.from_numpy(kernel),
            torch.from_numpy(bias) if with_bias else None, torch.from_numpy(mask)]


def _wgrad_args(seed, with_bias=True):
    feats, plan, kernel, _, mask = _conv_args(seed)
    g = torch.from_numpy(np.random.default_rng(seed + 1).normal(
        size=(feats.shape[0], kernel.shape[2])).astype(np.float32))
    return [feats, plan, g, mask, with_bias]


def _tap_args(seed, with_bias=True):
    """K1's operands over a 27-tap plan (n_t = 4), Cin 2, Cout 8: the taps
    design's shape on the card."""
    from test_torch_row_conv import tap_case

    feats, plan, kernel, bias, mask, _ = tap_case(seed, 2, 8)
    return [torch.from_numpy(feats), torch.from_numpy(plan), torch.from_numpy(kernel),
            torch.from_numpy(bias) if with_bias else None, torch.from_numpy(mask)]


def _tap_wgrad_args(seed, with_bias=True):
    from test_torch_row_conv import tap_case

    feats, plan, _, _, mask, g = tap_case(seed, 2, 8)
    return [torch.from_numpy(a) for a in (feats, plan, g, mask)] + [with_bias]


def _site_args(seed, c, f, with_bias=True):
    """K2's operands at head width (C, F) over 10 events (+1 empty)."""
    rng = np.random.default_rng(seed)
    rows, k3, take, ev, site, bias = site_layout_case(rng, ("duplicate_sites",), 10, c, f)
    return [torch.from_numpy(a) for a in (rows, k3, take, ev, site)] + [
        11, torch.from_numpy(bias) if with_bias else None]


def _site_bwd_args(seed, c, f, with_bias=True):
    rows, k3, take, ev, site, n_events, _ = _site_args(seed, c, f)
    d_out = torch.from_numpy(np.random.default_rng(seed + 1).normal(
        size=(n_events, f)).astype(np.float32))
    return [d_out, rows, k3, take, ev, site, n_events, with_bias]


def _plan_args(seed, k, n_t):
    """The plan kernel's operands over 5 events on a T = ``n_t`` grid: 60
    rows at random sites, 8 of them at another row's site, 6 off the grid
    (padding); live the last row of each site."""
    rng = np.random.default_rng(seed)
    size = 5 * 14 * 11 * n_t
    site = torch.from_numpy(rng.integers(0, size, 60))
    site[40:48] = site[:8]
    site[54:] = size
    table = row_conv.device_site_table(site, size)
    live = table.index_select(0, site) == torch.arange(60, dtype=torch.int32)
    return [site, live, table, k, n_t]


def _wfs(seed, s):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(adversarial_waveforms(rng, 70, s).astype(np.float32))


#: (op name, case id, operands of the op) at the narrow sizes
CASES = [
    ("subm_conv_rows", "k3-bias", lambda: _conv_args(1)),
    ("subm_conv_rows", "k3-nobias", lambda: _conv_args(2, with_bias=False)),
    ("subm_conv_rows", "k1-bias", lambda: _conv_args(3, k=1)),
    ("subm_conv_rows", "k27-bias", lambda: _tap_args(12)),
    ("subm_conv_rows_wgrad", "bias", lambda: _wgrad_args(4)),
    ("subm_conv_rows_wgrad", "nobias", lambda: _wgrad_args(5, with_bias=False)),
    ("subm_conv_rows_wgrad", "k27-bias", lambda: _tap_wgrad_args(13)),
    ("site_grouped_matmul", "8x50-bias", lambda: _site_args(6, 8, 50)),
    ("site_grouped_matmul", "16x24-nobias", lambda: _site_args(7, 16, 24, with_bias=False)),
    ("site_grouped_matmul_bwd", "8x50-bias", lambda: _site_bwd_args(8, 8, 50)),
    ("site_grouped_matmul_bwd", "16x24-nobias",
     lambda: _site_bwd_args(9, 16, 24, with_bias=False)),
    ("waveform_features", "s59", lambda: [_wfs(10, 59)]),
    ("waveform_features", "s150", lambda: [_wfs(11, 150)]),
    ("subm_conv_rows_plan", "k3-t4", lambda: _plan_args(14, 3, 4)),
    ("subm_conv_rows_plan", "k1-t16", lambda: _plan_args(15, 1, 16)),
    ("subm_conv_rows_plan", "k5-t7", lambda: _plan_args(16, 5, 7)),
]
CASE_PARAMS = [pytest.param(name, make, id=f"{name}-{case}") for name, case, make in CASES]

#: op name → (module, public wrapper name, plain version name)
MODULES = {"subm_conv_rows": (row_conv, "subm_conv_rows", "subm_conv_rows_plain"),
           "subm_conv_rows_wgrad": (row_conv, "subm_conv_rows_wgrad",
                                    "subm_conv_rows_wgrad_plain"),
           "site_grouped_matmul": (site_head, "site_grouped_matmul",
                                   "site_grouped_matmul_plain"),
           "site_grouped_matmul_bwd": (site_head, "site_grouped_matmul_bwd",
                                       "site_grouped_matmul_bwd_plain"),
           "waveform_features": (waveform_features, "waveform_features",
                                 "waveform_features_plain"),
           "subm_conv_rows_plan": (row_conv, "subm_conv_rows_plan",
                                   "subm_conv_rows_plan_plain")}


def _op(name):
    return getattr(torch.ops.waveformml, name).default


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("name,make", CASE_PARAMS)
def test_opcheck(name, make):
    """Schema, autograd registration (none: the autograd Functions wrap the
    ops), fake kernel against the CPU implementation, and the op under
    AOT dispatch with dynamic shapes."""
    torch.library.opcheck(_op(name), tuple(make()))


@pytest.mark.parametrize("name,make", CASE_PARAMS)
def test_wrapper_gives_the_plain_version_bitwise(name, make):
    module, wrapper, plain = MODULES[name]
    args = make()
    fn = getattr(module, wrapper)
    before = fn.launches
    got = _flat(fn(*args))
    want = _flat(getattr(module, plain)(*args))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    assert fn.launches == before


@pytest.mark.parametrize("name,make", CASE_PARAMS)
def test_fake_kernel_matches_the_cpu_implementation(name, make):
    from torch._subclasses.fake_tensor import FakeTensorMode

    args = make()
    real = _flat(_op(name)(*args))
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        fake = _flat(_op(name)(*fake_args))
    assert len(fake) == len(real)
    for f, r in zip(fake, real):
        assert (f.shape, f.stride(), f.dtype) == (r.shape, r.stride(), r.dtype)


@pytest.mark.parametrize("f", [50, 24, 199])
def test_site_head_output_rows_are_16_byte_aligned(f):
    """K2's output is a ``[:, :F]`` view of rows ``output_stride(F)`` floats
    apart on the CPU too, as on the card and in the fake kernel."""
    out = site_head.site_grouped_matmul(*_site_args(12, 3, f))
    assert out.shape == (11, f) and out.stride() == (site_head.output_stride(f), 1)
    assert site_head.output_stride(f) % 4 == 0


_TENSOR = object()


class _OneOp(torch.nn.Module):
    """A module whose forward is one call of op ``name``: the tensors of
    ``args`` are its inputs, the other arguments constants."""

    def __init__(self, name, args):
        super().__init__()
        self.name = name
        self.template = [_TENSOR if isinstance(a, torch.Tensor) else a for a in args]

    def forward(self, *tensors):
        it = iter(tensors)
        args = [next(it) if a is _TENSOR else a for a in self.template]
        return getattr(torch.ops.waveformml, self.name)(*args)


#: one case of each op
ONE_OF_EACH = [p for p in CASE_PARAMS if p.id in (
    "subm_conv_rows-k3-bias", "subm_conv_rows_wgrad-bias", "site_grouped_matmul-8x50-bias",
    "site_grouped_matmul_bwd-8x50-bias", "waveform_features-s59",
    "subm_conv_rows_plan-k3-t4")]


@pytest.mark.parametrize("name,make", ONE_OF_EACH)
def test_export_of_one_op_is_one_node(name, make):
    args = make()
    tensors = tuple(a for a in args if isinstance(a, torch.Tensor))
    program = torch.export.export(_OneOp(name, args), tensors, strict=False)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert [t for t in targets if t.startswith("waveformml.")] == [
        f"waveformml.{name}.default"], targets
    for g, w in zip(_flat(program.module()(*tensors)), _flat(_op(name)(*args))):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", OPS)
def test_each_op_has_its_own_cuda_kernel(name):
    """The dispatcher sends CUDA tensors to the kernel's launch and CPU
    tensors to the plain version: both keys have a kernel, and the op is
    not a composite that would run the plain version anywhere."""
    qualname = f"waveformml::{name}"
    for key in ("CPU", "CUDA", "Meta"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(qualname, key), key
    assert not torch._C._dispatch_has_kernel_for_dispatch_key(
        qualname, "CompositeImplicitAutograd")
    module = MODULES[name][0]
    assert callable(getattr(module, f"{name}_cuda"))


def test_ops_need_torch_library_register_fake(monkeypatch):
    monkeypatch.delattr(torch.library, "register_fake")
    with pytest.raises(ImportError, match="torch >= 2.4"):
        native.define_op("never_registered", "(Tensor x) -> Tensor", cpu=None, cuda=None,
                         fake=None)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ops' CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,make", CASE_PARAMS)
def test_opcheck_on_card(cuda, name, make):
    """The same checks with CUDA tensors: the CUDA kernel against the fake
    kernel and under AOT dispatch; the wrapper launches the kernel."""
    args = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in make()]
    torch.library.opcheck(_op(name), tuple(args))
    module, wrapper, _ = MODULES[name]
    fn = getattr(module, wrapper)
    before = fn.launches
    for out in _flat(fn(*args)):
        assert out is None or out.is_cuda
    assert fn.launches > before
