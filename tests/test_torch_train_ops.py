"""The training pieces of the port against the JAX package, on the CPU:
the backward of the row conv (K1 as d_feats, K4) and of the site-grouped
head (K5) in their plain versions against ``jax.vjp`` of the JAX functions,
a float64 gradcheck of the row conv's autograd Function, masked BatchNorm in
train mode against flax, ``LitPSD.loss_and_metrics`` against the JAX task,
and SGD (nesterov) with ExponentialLR against ``waveformml_tpu.optim``. On
the card (``cuda`` marker): K4 and K5 against their plain versions, also
on the shapes and layouts their designs treat apart, their bitwise
determinism and their refusal of what they do not take.

Inputs come from numpy generators; JAX is imported inside the tests, so
that the card tests run where there is no JAX."""
import numpy as np
import pytest
import torch

from waveformml_tpu_torch.datasets.synthetic import (SITE_LAYOUT_FEATURES, conv_case,
                                                     site_layout_case)
from waveformml_tpu_torch.detector import NX, NY
from waveformml_tpu_torch.models.blocks import MaskedArrayBatchNorm
from waveformml_tpu_torch.ops.row_conv import (SubMConvRows, host_neighbor_plan,
                                               subm_conv_rows_bwd_plain, subm_conv_rows_wgrad,
                                               subm_conv_rows_wgrad_plain)
from waveformml_tpu_torch.ops.site_head import (SiteGroupedMatmul, host_site_layout,
                                                site_grouped_matmul_bwd,
                                                site_grouped_matmul_bwd_plain)

CONV_KINDS = ("clustered", "dense_cluster", "duplicate_sites", "isolated_sites")
LAYOUTS = [pytest.param((name,), id=name) for name in SITE_LAYOUT_FEATURES]
LAYOUTS.append(pytest.param(SITE_LAYOUT_FEATURES, id="all"))
# SubMPSD_w128.json's head (C, F); SubMPSD.json's is (8, 50)
WIDE = (128, 199)
LAYOUTS_AT = [pytest.param(*p.values, 8, 50, id=p.id) for p in LAYOUTS] + [
    pytest.param(*p.values, *WIDE, id=f"{p.id}-128-199") for p in LAYOUTS]
S = NX * NY


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels K4 and K5 run only on the card")
    return torch.device("cuda")


def _conv_inputs(rng, kind, k, cin, cout, n_events=12, n_rows=None):
    """feats, plan, kernel, bias, mask and a cotangent g, numpy."""
    coords, feats, kernel, bias, mask = conv_case(rng, kind, n_events, k, cin, cout, n_rows)
    plan = host_neighbor_plan(coords, mask, n_events, k)
    g = rng.normal(size=(feats.shape[0], cout)).astype(np.float32)
    return feats, plan, kernel, bias, mask, g


# -- row conv backward ------------------------------------------------------------

@pytest.mark.parametrize("kind", CONV_KINDS)
@pytest.mark.parametrize("k,cin,cout", [(3, 13, 7), (1, 9, 5)])
def test_subm_conv_rows_bwd_plain_matches_jax_vjp(rng, kind, k, cin, cout):
    """d_feats, d_kernel and d_bias of _subm_bwd, duplicate sites included
    (where d_feats is the reference's value, not the true gradient); fp32,
    rtol = atol = 1e-5."""
    import jax
    import jax.numpy as jnp

    from waveformml_tpu.ops.row_conv import subm_conv_rows as jax_subm_conv_rows

    feats, plan, kernel, bias, mask, g = _conv_inputs(rng, kind, k, cin, cout)
    _, vjp = jax.vjp(lambda x, w, b: jax_subm_conv_rows(x, jnp.asarray(plan), w, b,
                                                       jnp.asarray(mask)),
                     jnp.asarray(feats), jnp.asarray(kernel), jnp.asarray(bias))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    t = [torch.from_numpy(a) for a in (feats, plan, kernel, mask, g)]
    got = subm_conv_rows_bwd_plain(t[0], t[1], t[2], t[3], t[4])
    for name, a, b in zip(("d_feats", "d_kernel", "d_bias"), got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5, err_msg=name)
    # the autograd Function (the wrappers' CPU dispatch) gives the same
    x = torch.from_numpy(feats).requires_grad_()
    w = torch.from_numpy(kernel).requires_grad_()
    bb = torch.from_numpy(bias).requires_grad_()
    SubMConvRows.apply(x, t[1], w, bb, t[3]).backward(t[4])
    for name, a, b in zip(("d_feats", "d_kernel", "d_bias"), (x.grad, w.grad, bb.grad), got):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_subm_conv_rows_skips_d_feats_where_feats_needs_none(rng):
    feats, plan, kernel, bias, mask, g = (torch.from_numpy(a) for a in
                                          _conv_inputs(rng, "clustered", 3, 6, 4))
    w = kernel.clone().requires_grad_()
    SubMConvRows.apply(feats, plan, w, bias, mask).backward(g)
    want = subm_conv_rows_bwd_plain(feats, plan, kernel, mask, g, with_bias=False,
                                    need_feats=False)
    assert want[0] is None and want[2] is None
    torch.testing.assert_close(w.grad, want[1], rtol=0, atol=0)


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("k", [3, 1])
def test_subm_conv_rows_gradcheck(rng, plain, k):
    """Without duplicate sites the custom backward is the true gradient:
    torch.autograd.gradcheck in float64."""
    feats, plan, kernel, bias, mask, _ = _conv_inputs(rng, "clustered", k, 3, 2, n_events=6)
    rows = np.arange(plan.shape[0])
    assert (plan[mask, k * k // 2] == rows[mask]).all()      # no duplicate sites
    plan_t, mask_t = torch.from_numpy(plan), torch.from_numpy(mask)
    args = tuple(torch.from_numpy(a).double().requires_grad_() for a in (feats, kernel, bias))
    assert torch.autograd.gradcheck(
        lambda x, w, b: SubMConvRows.apply(x, plan_t, w, b, mask_t, plain), args,
        eps=1e-6, atol=1e-8, rtol=1e-6)


# -- site head backward -----------------------------------------------------------

def _jax_site_vjp(rows, k3, take, ev, site, n_events, bias, d_out):
    """jax.vjp of the JAX site_grouped_matmul plus the bias as
    FoldedSiteLinear adds it: (d_rows, d_k3, d_bias), numpy."""
    import jax
    import jax.numpy as jnp

    from waveformml_tpu.ops.site_head import site_grouped_matmul as jax_site_matmul

    layout = [jnp.asarray(a) for a in (take, ev, site)]
    _, vjp = jax.vjp(lambda r, k, b: jax_site_matmul(r, k, *layout, n_events) + b,
                     jnp.asarray(rows), jnp.asarray(k3), jnp.asarray(bias))
    return [np.asarray(x) for x in vjp(jnp.asarray(d_out))]


def _check_site_bwd(rows, k3, take, ev, site, n_events, bias, d_out):
    want = _jax_site_vjp(rows, k3, take, ev, site, n_events, bias, d_out)
    t = [torch.from_numpy(a) for a in (d_out, rows, k3, take, ev, site)]
    got = site_grouped_matmul_bwd_plain(*t, n_events)
    for name, a, b in zip(("d_rows", "d_k3", "d_bias"), got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5, err_msg=name)
    # the autograd Function, and the wrapper's CPU dispatch, give the same
    r = t[1].clone().requires_grad_()
    k = t[2].clone().requires_grad_()
    bb = torch.from_numpy(bias).requires_grad_()
    SiteGroupedMatmul.apply(r, k, bb, t[3], t[4], t[5], n_events).backward(t[0])
    wrapped = site_grouped_matmul_bwd(*t, n_events)
    for name, a, b, c in zip(("d_rows", "d_k3", "d_bias"), (r.grad, k.grad, bb.grad), got,
                             wrapped):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
        torch.testing.assert_close(c, b, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("features,c,f", LAYOUTS_AT)
def test_site_grouped_matmul_bwd_plain_matches_jax_vjp(rng, features, c, f):
    """Hand-made layouts: duplicate sites, stitched groups (G > S, clamped
    sites), events past the batch, a ragged MAX; fp32, rtol = atol = 1e-5."""
    rows, k3, take, ev, site, bias = site_layout_case(rng, features, 60, c, f)
    d_out = rng.normal(size=(60, f)).astype(np.float32)
    _check_site_bwd(rows, k3, take, ev, site, 60, bias, d_out)


@pytest.mark.parametrize("c,f", [(8, 50), (3, 5), WIDE])
def test_site_grouped_matmul_bwd_plain_matches_jax_vjp_on_host_layout(rng, c, f):
    """The layout host_site_layout builds, with padding rows in no slot (their
    d_rows is zero) and an event with no row."""
    n_events = 40
    sites = [rng.choice(154, size=int(rng.integers(1, 5)), replace=False)
             for _ in range(n_events - 1)]
    coords = np.asarray([[s // 11, s % 11, e] for e, ss in enumerate(sites) for s in ss],
                        np.int32)
    coords = np.concatenate([coords, np.zeros((9, 3), np.int32)])
    mask = np.arange(coords.shape[0]) < coords.shape[0] - 9
    lay = host_site_layout(coords, mask)
    rows = rng.normal(size=(coords.shape[0], c)).astype(np.float32)
    rows[~mask] = 0
    k3 = rng.normal(size=(c, 154, f)).astype(np.float32)
    bias = rng.normal(size=(f,)).astype(np.float32)
    d_out = rng.normal(size=(n_events, f)).astype(np.float32)
    _check_site_bwd(rows, k3, lay["site_take"], lay["site_ev"], lay["site_s"], n_events,
                    bias, d_out)
    got = site_grouped_matmul_bwd_plain(*(torch.from_numpy(a) for a in (
        d_out, rows, k3, lay["site_take"], lay["site_ev"], lay["site_s"])), n_events)
    assert (got[0][~torch.from_numpy(mask)] == 0).all()


# -- masked BatchNorm in train mode -----------------------------------------------

@pytest.mark.parametrize("n,c,n_pad", [(40, 6, 9), (5, 3, 0), (1, 4, 3), (0, 3, 5)])
def test_masked_batchnorm_train_matches_flax(rng, n, c, n_pad):
    """Outputs, gradients and updated running statistics against flax with
    mutable batch_stats; padding rows hold values that must not reach the
    statistics. Outputs and statistics rtol = atol = 1e-5, gradients
    rtol = 1e-4, atol = 1e-5 (sums over the rows in another order)."""
    import jax
    import jax.numpy as jnp

    from waveformml_tpu.models.blocks import MaskedArrayBatchNorm as JaxBN

    x = rng.normal(2.0, 3.0, size=(n + n_pad, c)).astype(np.float32)
    mask = np.arange(n + n_pad) < n
    cot = rng.normal(size=x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    shift = rng.normal(size=c).astype(np.float32)
    ra_mean = rng.normal(size=c).astype(np.float32)
    ra_var = rng.uniform(0.5, 2.0, c).astype(np.float32)
    bn = JaxBN(c)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(shift)},
                 "batch_stats": {"mean": jnp.asarray(ra_mean), "var": jnp.asarray(ra_var)}}

    def loss(xx, params):
        y, upd = bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx,
                          mask=jnp.asarray(mask), train=True, mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(cot)), (y, upd["batch_stats"])

    (_, (y_want, stats)), (dx_want, dp_want) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), variables["params"])

    mod = MaskedArrayBatchNorm(c)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(shift))
        mod.running_mean.copy_(torch.from_numpy(ra_mean))
        mod.running_var.copy_(torch.from_numpy(ra_var))
    mod.train()
    xt = torch.from_numpy(x).requires_grad_()
    y = mod(xt, torch.from_numpy(mask))
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mod.running_mean.numpy(), np.asarray(stats["mean"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mod.running_var.numpy(), np.asarray(stats["var"]),
                               rtol=1e-5, atol=1e-5)
    for got, want in ((xt.grad, dx_want), (mod.weight.grad, dp_want["scale"]),
                      (mod.bias.grad, dp_want["bias"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_masked_batchnorm_eval_ignores_the_mask(rng):
    mod = MaskedArrayBatchNorm(4).eval()
    x = torch.from_numpy(rng.normal(size=(7, 4)).astype(np.float32))
    mask = torch.arange(7) < 3
    torch.testing.assert_close(mod(x, mask), mod(x), rtol=0, atol=0)
    torch.testing.assert_close(mod(x), x / np.sqrt(1 + 1e-5), rtol=1e-6, atol=1e-6)


def test_masked_batchnorm_train_needs_the_mask():
    mod = MaskedArrayBatchNorm(4).train()
    with pytest.raises(ValueError, match="row mask"):
        mod(torch.zeros(3, 4))
    assert mod.running_mean.eq(0).all() and mod.running_var.eq(1).all()


# -- LitPSD loss ------------------------------------------------------------------

def _cfg_dict(criterion_params=()):
    return {
        "run_config": {"exp_name": "t", "run_class": "LitPSD", "imports": []},
        "system_config": {"model_name": "t", "n_samples": 4, "n_type": 3,
                          "type_names": ["a", "b", "c"], "half_precision": 0},
        "net_config": {"criterion_class": "CrossEntropyLoss",
                       "criterion_params": list(criterion_params), "imports": [],
                       "net_class": "SubMPSDNet", "net_type": "2DConvolution",
                       "hparams": {"out_planes": 4, "n_lin": 2,
                                   "conv_params": {"kernel_size": 3, "n_conv": 1,
                                                   "n_point": 1, "conv_position": 1,
                                                   "version": 2}}},
        "optimize_config": {"total_epoch": 1, "lr": 0.01, "imports": [],
                            "optimizer_class": "optim.SGD", "optimizer_params": {}},
        "dataset_config": {"mode": "path", "imports": [], "paths": ["a"],
                           "dataset_class": "PulseDataset2D", "dataset_params": {}},
    }


@pytest.mark.parametrize("weights", [None, [0.3, 1.7, 0.9]], ids=["plain", "class_weights"])
def test_litpsd_loss_and_metrics_match_jax(rng, weights):
    """loss_sum, weight (the event count, or the events' class weights),
    accuracy sums and the confusion matrix over the real events;
    rtol = 1e-5."""
    import jax.numpy as jnp

    from waveformml_tpu.config import Config as JaxConfig
    from waveformml_tpu.engineering.tasks import LitPSD as JaxLitPSD
    from waveformml_tpu_torch.config import Config
    from waveformml_tpu_torch.engineering.tasks import LitPSD

    params = [weights] if weights else []
    jtask = JaxLitPSD(JaxConfig(_cfg_dict(params)))
    task = LitPSD(Config(_cfg_dict(params)), device="cpu")
    n, n_real = 32, 27
    outputs = rng.normal(size=(n, 3)).astype(np.float32) * 3
    labels = rng.integers(0, 3, n).astype(np.int64)
    ymask = np.arange(n) < n_real
    want = jtask.loss_and_metrics(jnp.asarray(outputs),
                                  {"labels": jnp.asarray(labels),
                                   "label_mask": jnp.asarray(ymask)})
    got = task.loss_and_metrics(torch.from_numpy(outputs),
                                {"labels": torch.from_numpy(labels),
                                 "label_mask": torch.from_numpy(ymask)})
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-5)
    for key in ("accuracy_sum", "accuracy_count", "confusion"):
        np.testing.assert_array_equal(got[2][key].numpy(), np.asarray(want[2][key]),
                                      err_msg=key)
    assert float(got[2]["confusion"].sum()) == n_real


def test_criterion_refuses_unsupported_params():
    from waveformml_tpu_torch.nn.functional import build_criterion

    with pytest.raises(ValueError, match="unsupported criterion params"):
        build_criterion("nn.CrossEntropyLoss", [[1.0, 2.0], "extra"])
    with pytest.raises(ValueError, match="unsupported criterion params"):
        build_criterion("NLLLoss", [[1.0, 2.0], "extra"])
    with pytest.raises(KeyError):
        build_criterion("NoSuchLoss")


@pytest.mark.parametrize("weights", [None, [0.2, 1.0, 3.0]], ids=["plain", "class_weights"])
def test_criterion_mean_matches_torch(rng, weights):
    """The elementwise loss summed over mean_denominator's sum (or the
    sample count) is torch's CrossEntropyLoss mean, weighted mean included;
    the elementwise loss equals the JAX criterion's. rtol = 1e-6."""
    import jax.numpy as jnp

    from waveformml_tpu.nn.functional import CrossEntropyLoss as JaxCE
    from waveformml_tpu_torch.nn.functional import CrossEntropyLoss

    pred = rng.normal(size=(9, 3)).astype(np.float32)
    target = rng.integers(0, 3, 9)
    crit = CrossEntropyLoss(weights)
    elem = crit.elementwise(torch.from_numpy(pred), torch.from_numpy(target))
    den = crit.mean_denominator(torch.from_numpy(target))
    mean = elem.sum() / (len(target) if den is None else den.sum())
    want = torch.nn.CrossEntropyLoss(None if weights is None else torch.tensor(weights))(
        torch.from_numpy(pred), torch.from_numpy(target))
    torch.testing.assert_close(mean, want, rtol=1e-6, atol=0)
    jelem = JaxCE(weights, reduction="none").elementwise(jnp.asarray(pred),
                                                         jnp.asarray(target))
    np.testing.assert_allclose(elem.numpy(), np.asarray(jelem), rtol=1e-6)


# -- optimizer and scheduler ------------------------------------------------------

@pytest.mark.parametrize("opt_params", [{"momentum": 0.98, "nesterov": True},
                                        {"momentum": 0.9, "weight_decay": 1e-3},
                                        {"momentum": 0.9, "dampening": 0.1}],
                         ids=["nesterov", "weight_decay", "dampening"])
def test_sgd_and_exponential_lr_match_jax(rng, opt_params):
    """Three epochs of four steps from the same parameters and gradients,
    the lr set once per epoch; rtol = 1e-6, atol = 1e-7."""
    import jax.numpy as jnp
    import optax

    from waveformml_tpu import optim as wopt
    from waveformml_tpu_torch.optim import build_optimizer, build_scheduler, set_learning_rate

    shapes = [(5, 3), (3,), (2, 2, 2)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(12)]
    jparams = [jnp.asarray(p) for p in init]
    jopt = wopt.build_optimizer("optim.SGD", 0.01, opt_params)
    jstate = jopt.init(jparams)
    jsched = wopt.build_scheduler("lr_scheduler.ExponentialLR", 0.01, {"gamma": 0.9})
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt = build_optimizer("optim.SGD", params, 0.01, opt_params)
    sched = build_scheduler("lr_scheduler.ExponentialLR", 0.01, {"gamma": 0.9})
    for epoch in range(3):
        for step in range(4):
            g = grads[epoch * 4 + step]
            updates, jstate = jopt.update([jnp.asarray(x) for x in g], jstate, jparams)
            jparams = optax.apply_updates(jparams, updates)
            for p, x in zip(params, g):
                p.grad = torch.from_numpy(x)
            opt.step()
        lr = jsched.step()
        jstate = wopt.set_learning_rate(jstate, lr)
        set_learning_rate(opt, sched.step())
        assert sched.lr() == pytest.approx(lr, rel=1e-12)
        assert opt.param_groups[0]["lr"] == pytest.approx(0.01 * 0.9 ** (epoch + 1), rel=1e-12)
        for p, jp in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6,
                                       atol=1e-7)


def test_optim_refuses_what_is_not_ported():
    """Every optimizer and scheduler of the JAX registry is ported: only an
    unknown name and nesterov without momentum are refused. A checkpoint's
    optimizer and scheduler states resume the schedule at its epoch."""
    from waveformml_tpu_torch.optim import build_optimizer, build_scheduler, set_learning_rate

    params = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError, match="nesterov"):
        build_optimizer("optim.SGD", params, 0.1, {"nesterov": True})
    with pytest.raises(KeyError, match="unknown optimizer"):
        build_optimizer("optim.Adagrad", params, 0.1)
    with pytest.raises(KeyError, match="unknown scheduler"):
        build_scheduler("lr_scheduler.OneCycleLR", 0.1)
    for name in ("optim.SGD", "optim.Adam", "optim.AdamW", "optim.RMSprop"):
        build_optimizer(name, params, 0.1)
    opt = build_optimizer("SGD", params, 0.1)
    assert build_scheduler(None, 0.1) is None
    sched = build_scheduler("ExponentialLR", 0.1, {"gamma": 0.5})
    opt.step()
    set_learning_rate(opt, sched.step())
    assert opt.param_groups[0]["lr"] == pytest.approx(0.05)
    fresh = build_optimizer("SGD", params, 0.1)
    resumed = build_scheduler("ExponentialLR", 0.1, {"gamma": 0.5})
    fresh.load_state_dict(opt.state_dict())
    resumed.load_state_dict(sched.state_dict())
    assert fresh.param_groups[0]["lr"] == pytest.approx(0.05)
    assert resumed.step() == pytest.approx(0.025) and resumed.epoch == 2


# -- K4 and K5 on the card --------------------------------------------------------

# (plan kind, k, cin, cout, events, rows): the training layers' widths, then
# the adversarial plans
K4_CASES = [
    pytest.param("clustered", 3, 130, 104, 1000, None, id="3-130-104"),
    pytest.param("clustered", 3, 104, 56, 1000, None, id="3-104-56"),
    pytest.param("clustered", 1, 56, 8, 1000, None, id="1-56-8"),
    pytest.param("dense_cluster", 3, 130, 104, 600, None, id="dense_cluster"),
    pytest.param("duplicate_sites", 3, 104, 56, 1000, None, id="duplicate_sites"),
    pytest.param("isolated_sites", 3, 130, 104, 300, None, id="isolated_sites"),
    pytest.param("clustered", 3, 5, 3, 1000, None, id="3-5-3"),
    pytest.param("clustered", 3, 56, 200, 1000, 78 * 64 + 37, id="ragged-56-200"),
    # the shapes K4's design treats apart: a last row block cut short, Cout
    # of one 8-column tile, k = 1 at layer 0's widths, Cin + 1 over one
    # block's 144 channels
    pytest.param("clustered", 3, 130, 104, 2000, 12288 - 61, id="rows-not-a-block-multiple"),
    pytest.param("clustered", 3, 130, 8, 1000, None, id="3-130-8"),
    pytest.param("clustered", 1, 130, 104, 1000, None, id="1-130-104"),
    pytest.param("duplicate_sites", 3, 130, 104, 1000, None, id="duplicate_sites-130-104"),
    pytest.param("clustered", 3, 300, 40, 500, None, id="3-300-40"),
]


def _k4_args(cuda, kind, k, cin, cout, n_events, n_rows):
    rng = np.random.default_rng(2024)
    feats, plan, _, _, mask, g = _conv_inputs(rng, kind, k, cin, cout, n_events, n_rows)
    return [torch.from_numpy(a).to(cuda) for a in (feats, plan, g, mask)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,k,cin,cout,n_events,n_rows", K4_CASES)
def test_k4_matches_plain_on_card(cuda, kind, k, cin, cout, n_events, n_rows):
    """Each output within 1e-5 times the sum of the magnitudes of its terms
    (the plain version on |feats| and |g|): the kernel sums in fp32 in
    another order. Two runs give the same bits."""
    feats, plan, g, mask = _k4_args(cuda, kind, k, cin, cout, n_events, n_rows)
    want = subm_conv_rows_wgrad_plain(feats, plan, g, mask)
    scale = subm_conv_rows_wgrad_plain(feats.abs(), plan, g.abs(), mask)
    before = subm_conv_rows_wgrad.launches
    got = subm_conv_rows_wgrad(feats, plan, g, mask)
    again = subm_conv_rows_wgrad(feats, plan, g, mask)
    torch.cuda.synchronize()
    assert subm_conv_rows_wgrad.launches == before + 4     # partials and sums, twice
    _within_terms(got, want, scale)
    for a, c in zip(got, again):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_k4_refuses_what_it_does_not_take(cuda):
    feats, plan, g, mask = _k4_args(cuda, "clustered", 3, 7, 5, 50, None)
    before = subm_conv_rows_wgrad.launches
    with pytest.raises(TypeError):
        subm_conv_rows_wgrad(feats.double(), plan, g, mask)
    with pytest.raises(TypeError):
        subm_conv_rows_wgrad(feats, plan.long(), g, mask)
    with pytest.raises(TypeError):
        subm_conv_rows_wgrad(feats, plan, g, mask.to(torch.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        subm_conv_rows_wgrad(feats, plan, torch.cat([g, g], 1)[:, ::2], mask)
    with pytest.raises(ValueError, match="one device"):
        subm_conv_rows_wgrad(feats, plan, g.cpu(), mask)
    with pytest.raises(ValueError, match="shape"):
        subm_conv_rows_wgrad(feats, plan[:-1], g, mask)
    assert subm_conv_rows_wgrad.launches == before


def _check_k4(args):
    """K4 against its plain version (each output within 1e-5 times the sum
    of its terms' magnitudes), two grids a call, the same bits twice."""
    feats, plan, g, mask = args
    want = subm_conv_rows_wgrad_plain(feats, plan, g, mask)
    scale = subm_conv_rows_wgrad_plain(feats.abs(), plan, g.abs(), mask)
    before = subm_conv_rows_wgrad.launches
    got = subm_conv_rows_wgrad(feats, plan, g, mask)
    again = subm_conv_rows_wgrad(feats, plan, g, mask)
    torch.cuda.synchronize()
    assert subm_conv_rows_wgrad.launches == before + 4
    _within_terms(got, want, scale)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 500], ids=["no-rows", "no-real-row"])
def test_k4_without_real_rows_on_card(cuda, n):
    """No row, or rows that are all padding: zero gradients (with no row,
    the reduction's grid alone writes them)."""
    rng = np.random.default_rng(3)
    feats = torch.from_numpy(rng.normal(size=(n, 130)).astype(np.float32)).to(cuda)
    plan = torch.from_numpy(rng.integers(-1, max(n, 1), size=(n, 9)).astype(np.int32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(n, 104)).astype(np.float32)).to(cuda)
    mask = torch.zeros(n, dtype=torch.bool, device=cuda)
    before = subm_conv_rows_wgrad.launches
    d_kernel, d_bias = subm_conv_rows_wgrad(feats, plan, g, mask)
    torch.cuda.synchronize()
    assert subm_conv_rows_wgrad.launches == before + (2 if n else 1)
    assert not d_kernel.any() and not d_bias.any()
    if n:
        _check_k4((feats, plan, g, mask))


@pytest.mark.cuda
def test_k4_plan_naming_other_rows_on_card(cuda):
    """Every plan entry a random row or -1: each tap present for most
    rows, its source any row, the centre tap's too."""
    rng = np.random.default_rng(4)
    n = 3001
    feats = rng.normal(size=(n, 130)).astype(np.float32)
    plan = rng.integers(-1, n, size=(n, 9)).astype(np.int32)
    g = rng.normal(size=(n, 104)).astype(np.float32)
    mask = rng.random(n) < 0.9
    _check_k4([torch.from_numpy(a).to(cuda) for a in (feats, plan, g, mask)])


@pytest.mark.cuda
def test_k4_tap_in_one_block_on_card(cuda):
    """Isolated sites but for one pair of neighbours: each of two taps is
    present for one row, in one row block."""
    rng = np.random.default_rng(5)
    coords, feats, _, _, mask = conv_case(rng, "isolated_sites", 6000, 3, 130, 104)
    j = 3001
    x, y = coords[j, 0], coords[j, 1]
    coords[j + 1] = [x + 1 if x + 1 < NX else x - 1, y, coords[j, 2]]
    plan = host_neighbor_plan(coords, mask, 6000, 3)
    assert (np.delete(plan, 4, axis=1) >= 0).sum() == 2
    g = rng.normal(size=(feats.shape[0], 104)).astype(np.float32)
    _check_k4([torch.from_numpy(a).to(cuda) for a in (feats, plan, g, mask)])


def _within_terms(got, want, scale, tol=1e-5):
    """Each output within ``tol`` times the sum of the magnitudes of its
    terms (``scale``): a sum of thousands of fp32 terms in another order is
    off by a few ulp of that sum."""
    for name, a, b, s in zip(("first", "second", "third"), got, want, scale):
        excess = float(((a - b).abs() - tol * s).max())
        assert excess <= 0, f"{name} output off by {excess:.3g} beyond {tol}·Σ|terms|"


@pytest.mark.cuda
@pytest.mark.parametrize("layer", [pytest.param((3, 104, 56), id="3-104-56"),
                                   pytest.param((1, 56, 8), id="1-56-8")])
def test_row_conv_function_on_card_matches_plain(cuda, layer):
    """The autograd Function on the card (K1 forward and as d_feats, K4)
    against its plain forward and backward: the output and d_feats (K1)
    rtol = atol = 1e-5, d_kernel and d_bias (K4, sums over the rows) within
    1e-5 of the sum of their terms' magnitudes."""
    k, cin, cout = layer
    rng = np.random.default_rng(5)
    feats, plan, kernel, bias, mask, g = (torch.from_numpy(a).to(cuda) for a in
                                          _conv_inputs(rng, "clustered", k, cin, cout, 1000))
    grads = []
    for plain in (False, True):
        x, w, b = (t.clone().requires_grad_() for t in (feats, kernel, bias))
        y = SubMConvRows.apply(x, plan, w, b, mask, plain)
        y.backward(g)
        grads.append((y.detach(), x.grad, w.grad, b.grad))
    got, want = grads
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5, msg="output")
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5, msg="d_feats")
    _within_terms(got[2:], want[2:], subm_conv_rows_wgrad_plain(feats.abs(), plan, g.abs(), mask))


# (layout features, C, F): the host layout and each hand-made layout, at
# SubMPSD.json's head (the kernel's own instantiation) and SubMPSD_w128.json's
# (its tiled grid)
K5_CASES = [pytest.param(None, 8, 50, id="host-layout-4096"),
            pytest.param(None, *WIDE, id="host-layout-4096-128-199")] + LAYOUTS_AT


def _k5_args(cuda, features, c=8, f=50, n_events=4096):
    rng = np.random.default_rng(77)
    if features is None:
        sites = rng.integers(0, 154, size=(n_events, 4))
        mult = rng.integers(1, 5, n_events)
        coords = np.asarray([[s // 11, s % 11, e] for e in range(n_events)
                             for s in np.unique(sites[e, :mult[e]])], np.int32)
        coords = np.concatenate([coords, np.zeros((37, 3), np.int32)])
        mask = np.arange(coords.shape[0]) < coords.shape[0] - 37
        lay = host_site_layout(coords, mask)
        rows = np.where(mask[:, None], rng.normal(size=(coords.shape[0], c)), 0)
        arrays = [rows.astype(np.float32),
                  rng.normal(size=(c, 154, f)).astype(np.float32) / 30,
                  lay["site_take"], lay["site_ev"], lay["site_s"]]
    else:
        arrays = list(site_layout_case(rng, features, n_events, c, f)[:5])
    d_out = rng.normal(size=(n_events, f)).astype(np.float32)
    return [torch.from_numpy(a).to(cuda) for a in [d_out] + arrays], n_events


@pytest.mark.cuda
@pytest.mark.parametrize("features,c,f", K5_CASES)
def test_k5_matches_plain_on_card(cuda, features, c, f):
    """Each output within 1e-5 times the sum of the magnitudes of its terms
    (the plain version on |d_out|, |rows| and |k3|): the kernel sums in fp32
    in another order. Two runs give the same bits."""
    args, n_events = _k5_args(cuda, features, c, f)
    want = site_grouped_matmul_bwd_plain(*args, n_events)
    scale = site_grouped_matmul_bwd_plain(*(a.abs() for a in args[:3]), *args[3:], n_events)
    before = site_grouped_matmul_bwd.launches
    got = site_grouped_matmul_bwd(*args, n_events)
    again = site_grouped_matmul_bwd(*args, n_events)
    torch.cuda.synchronize()
    assert site_grouped_matmul_bwd.launches == before + 4    # two grids, twice
    _within_terms(got, want, scale)
    for a, c in zip(got, again):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_k5_refuses_what_it_does_not_take(cuda):
    args, n_events = _k5_args(cuda, ("duplicate_sites",), n_events=64)
    d_out = args[0]
    before = site_grouped_matmul_bwd.launches
    with pytest.raises(TypeError):
        site_grouped_matmul_bwd(d_out.double(), *args[1:], n_events)
    with pytest.raises(ValueError, match="contiguous"):
        site_grouped_matmul_bwd(torch.cat([d_out, d_out], 1)[:, ::2], *args[1:], n_events)
    with pytest.raises(ValueError, match="d_out"):
        site_grouped_matmul_bwd(d_out[:-1], *args[1:], n_events)
    with pytest.raises(TypeError):
        site_grouped_matmul_bwd(d_out, *args[1:3], args[3].long(), *args[4:], n_events)
    with pytest.raises(ValueError, match="one device"):
        site_grouped_matmul_bwd(d_out.cpu(), *args[1:], n_events)
    assert site_grouped_matmul_bwd.launches == before


@pytest.mark.cuda
def test_k5_gets_a_contiguous_d_out_from_linear(cuda):
    """K2's output is a [:, :F] view of rows padded to 4 floats; the Linear
    after it hands its backward a contiguous d_out all the same."""
    args, n_events = _k5_args(cuda, None, n_events=256)
    _, rows, k3, take, ev, site = args
    bias = torch.zeros(50, device=cuda, requires_grad=True)
    seen = []
    y = SiteGroupedMatmul.apply(rows, k3.requires_grad_(), bias, take, ev, site, n_events)
    assert not y.is_contiguous()
    y.register_hook(lambda grad: seen.append(grad.is_contiguous()))
    torch.nn.Linear(50, 2, device=cuda)(y).sum().backward()
    assert seen == [True]


def _layout(rng, site1, n_rows, n_events, max_slots, empty_groups=(), c=8, f=50):
    """d_out and a hand-made slot layout: each of n_rows - 7 rows in one
    slot of a random group not in ``empty_groups``, its event up to
    n_events + 20 (those past n_events add nothing)."""
    groups = len(site1)
    take = np.zeros((groups, max_slots), np.int32)
    ev = np.zeros((groups, max_slots), np.int32)
    allowed = np.setdiff1d(np.arange(groups), empty_groups)
    fill = np.zeros(groups, np.int64)
    for r in range(n_rows - 7):
        gi = rng.choice(allowed[fill[allowed] < max_slots])
        take[gi, fill[gi]] = r + 1
        ev[gi, fill[gi]] = rng.integers(1, n_events + 21)
        fill[gi] += 1
    for gi in range(groups):
        perm = rng.permutation(max_slots)
        take[gi], ev[gi] = take[gi, perm], ev[gi, perm]
    rows = np.zeros((n_rows, c), np.float32)
    rows[:n_rows - 7] = rng.normal(size=(n_rows - 7, c))
    k3 = (rng.normal(size=(c, S, f)) / np.sqrt(c * S)).astype(np.float32)
    d_out = rng.normal(size=(n_events, f)).astype(np.float32)
    return [d_out, rows, k3, take, ev, np.asarray(site1, np.int32)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["site-in-three-groups", "sites-out-of-range",
                                  "empty-groups", "few-events", "fewer-groups-than-sites",
                                  "other-widths"])
def test_k5_layouts_on_card(cuda, case):
    """Stitched layouts (a site in several groups, sites out of range),
    empty groups, events past n_events, sites with no group, at the
    training head's widths (C, F) = (8, 50), which the kernel compiles
    for, and at others, which it takes at run time."""
    rng = np.random.default_rng(6)
    site1 = list(range(1, S + 1))
    empty, n_events, c, f = (), 4096, 8, 50
    if case == "site-in-three-groups":
        site1 += [5, 5, 9]
    elif case == "sites-out-of-range":
        site1 += [0, -4, S + 3, 2 * S]
    elif case == "empty-groups":
        site1 += [3, 3]
        empty = (2, 10, S, S + 1)
    elif case == "few-events":
        n_events = 40
    elif case == "other-widths":
        site1 += [3, 3]
        c, f = 5, 37
    else:
        site1 = [1, 17, 17, S]
    arrays = _layout(rng, site1, 3000, n_events, 64 if len(site1) > 4 else 1024, empty, c, f)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    want = site_grouped_matmul_bwd_plain(*args, n_events)
    scale = site_grouped_matmul_bwd_plain(*(a.abs() for a in args[:3]), *args[3:], n_events)
    before = site_grouped_matmul_bwd.launches
    got = site_grouped_matmul_bwd(*args, n_events)
    again = site_grouped_matmul_bwd(*args, n_events)
    torch.cuda.synchronize()
    assert site_grouped_matmul_bwd.launches == before + 4      # two grids, twice
    _within_terms(got, want, scale)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("c,f", [(8, 50), WIDE])
def test_k4_k5_on_two_streams_at_once(cuda, c, f):
    """K4 and K5 keep no state between calls: calls on two streams at once
    (K5 on a stitched layout, whose sites sum by tickets per site and, at
    the wide head, per tile) each agree with the plain versions."""
    k4_args = _k4_args(cuda, "clustered", 3, 130, 104, 1000, None)
    rng = np.random.default_rng(8)
    k5_args = [torch.from_numpy(a).to(cuda) for a in
               _layout(rng, list(range(1, S + 1)) + [5, 5, 9], 3000, 4096, 64, c=c, f=f)]
    feats, plan, g, mask = k4_args
    want4 = subm_conv_rows_wgrad_plain(*k4_args)
    scale4 = subm_conv_rows_wgrad_plain(feats.abs(), plan, g.abs(), mask)
    want5 = site_grouped_matmul_bwd_plain(*k5_args, 4096)
    scale5 = site_grouped_matmul_bwd_plain(*(a.abs() for a in k5_args[:3]), *k5_args[3:], 4096)
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    torch.cuda.synchronize()
    outs = []
    for _ in range(4):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append((subm_conv_rows_wgrad(*k4_args),
                             site_grouped_matmul_bwd(*k5_args, 4096)))
    torch.cuda.synchronize()
    for got4, got5 in outs:
        _within_terms(got4, want4, scale4)
        _within_terms(got5, want5, scale5)
