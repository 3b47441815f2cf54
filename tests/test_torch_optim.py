"""The port's optimizers, schedulers, gradient clipping and accumulation
against the JAX package's (``waveformml_tpu.optim`` and the optax
transforms its ``Trainer`` chains): the same parameters and seeded
gradients, numpy in between."""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from waveformml_tpu import optim as wopt
from waveformml_tpu_torch.optim import (MultiSteps, build_optimizer, build_scheduler,
                                        clip_by_global_norm_, set_learning_rate)

SHAPES = [(5, 3), (3,), (2, 2, 2)]
STEPS = 20
EPOCHS = 40

OPTIMIZERS = [
    ("optim.Adam", {}),
    ("optim.Adam", {"betas": [0.8, 0.99], "eps": 1e-6, "weight_decay": 1e-2}),
    ("optim.AdamW", {}),
    ("optim.AdamW", {"betas": [0.85, 0.995], "weight_decay": 0.05}),
    ("optim.RMSprop", {}),
    ("optim.RMSprop", {"alpha": 0.9, "momentum": 0.9}),
    ("optim.RMSprop", {"momentum": 0.5, "weight_decay": 1e-3, "eps": 1e-6}),
    ("optim.SGD", {"momentum": 0.9, "dampening": 0.3}),
    ("optim.SGD", {"momentum": 0.9, "dampening": 0.3, "weight_decay": 1e-3}),
]


def _ids(cases):
    return [f"{name.split('.')[-1]}-{i}" for i, (name, _) in enumerate(cases)]


@pytest.mark.parametrize("name,params", OPTIMIZERS, ids=_ids(OPTIMIZERS))
def test_optimizer_steps_like_jax(name, params):
    """20 steps from the same parameters and gradients (some tiny, where
    eps matters), the lr halved after step 10 in both, and the port's state
    carried through ``state_dict`` into a fresh optimizer there; rtol 1e-6,
    atol 1e-7."""
    rng = np.random.default_rng(11)
    init = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.normal(size=s) * 10.0 ** rng.integers(-6, 1)).astype(np.float32)
              for s in SHAPES] for _ in range(STEPS)]
    jparams = [jnp.asarray(p) for p in init]
    jopt = wopt.build_optimizer(name, 0.01, params)
    jstate = jopt.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt = build_optimizer(name, tparams, 0.01, params)
    for step in range(STEPS):
        if step == STEPS // 2:
            jstate = wopt.set_learning_rate(jstate, 0.005)
            set_learning_rate(opt, 0.005)
            fresh = build_optimizer(name, tparams, 0.01, params)
            fresh.load_state_dict(opt.state_dict())
            opt = fresh
            assert opt.param_groups[0]["lr"] == 0.005
        updates, jstate = jopt.update([jnp.asarray(g) for g in grads[step]], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(tparams, grads[step]):
            p.grad = torch.from_numpy(g)
        opt.step()
        for p, jp in zip(tparams, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6,
                                       atol=1e-7, err_msg=f"step {step}")


def _metrics(n):
    """A validation-loss sequence that falls, stalls and rises, with
    epochs that had no validation (None)."""
    rng = np.random.default_rng(5)
    out = []
    for e in range(n):
        if e % 4 == 3:
            out.append(None)
        elif e < 10:
            out.append(1.0 - 0.05 * e)
        else:
            out.append(0.55 + 1e-5 * float(rng.integers(-3, 4)) + (0.01 if e > 30 else 0.0))
    return out


SCHEDULERS = [
    ("lr_scheduler.ExponentialLR", {"gamma": 0.9}),
    ("lr_scheduler.StepLR", {"step_size": 7, "gamma": 0.5}),
    ("lr_scheduler.CosineAnnealingLR", {"T_max": 15, "eta_min": 1e-4}),
    ("lr_scheduler.ReduceLROnPlateau", {"patience": 2, "factor": 0.5}),
    ("lr_scheduler.ReduceLROnPlateau", {"patience": 1, "factor": 0.3, "threshold": 1e-3,
                                        "threshold_mode": "abs", "cooldown": 2,
                                        "min_lr": 1e-4}),
    ("lr_scheduler.ReduceLROnPlateau", {"patience": 1, "threshold": 0.01, "cooldown": 3}),
]


@pytest.mark.parametrize("name,params", SCHEDULERS, ids=_ids(SCHEDULERS))
def test_scheduler_matches_jax(name, params):
    """40 epochs fed the same metric sequence (None where no validation
    ran) give the JAX scheduler's lr within 1e-12, the port's state carried
    through ``state_dict`` into a fresh scheduler at epoch 20."""
    jsched = wopt.build_scheduler(name, 0.1, params)
    sched = build_scheduler(name, 0.1, params)
    lrs = []
    for epoch, metric in enumerate(_metrics(EPOCHS)):
        if epoch == EPOCHS // 2:
            fresh = build_scheduler(name, 0.1, params)
            fresh.load_state_dict(sched.state_dict())
            sched = fresh
        want = jsched.step(metric)
        got = sched.step(metric)
        assert got == pytest.approx(want, rel=1e-12, abs=1e-12), epoch
        assert sched.lr() == got
        lrs.append(got)
    assert len(set(lrs)) > 1, lrs


def test_plateau_scheduler_reduces_and_cools_down():
    """The sequence the scheduler test feeds does cut the lr, and the abs
    mode's cooldown holds it for its epochs."""
    sched = build_scheduler("ReduceLROnPlateau", 0.1, SCHEDULERS[4][1])
    lrs = [sched.step(m) for m in _metrics(EPOCHS)]
    cuts = [i for i in range(1, EPOCHS) if lrs[i] < lrs[i - 1]]
    assert len(cuts) >= 2 and all(b - a > 2 for a, b in zip(cuts, cuts[1:])), lrs
    assert min(lrs) >= 1e-4


@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["engaged", "idle"])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.default_rng(3)
    grads = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = clip_by_global_norm_(got, max_norm)
    assert (float(norm) >= max_norm) == (max_norm == 0.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_multisteps_with_clip_matches_optax():
    """optax.MultiSteps(chain(clip, SGD momentum), 3) over 7 micro-steps:
    the port's running mean, clipped as a whole and stepped on every third
    micro-step, moves the parameters the same (rtol 1e-6, atol 1e-7), and
    not at all in between; its state round-trips at micro-step 4."""
    rng = np.random.default_rng(8)
    init = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[rng.normal(size=s).astype(np.float32) for s in SHAPES] for _ in range(7)]
    jopt = optax.MultiSteps(optax.chain(optax.clip_by_global_norm(0.7),
                                        wopt.build_optimizer("SGD", 0.1, {"momentum": 0.9})),
                            every_k_schedule=3)
    jparams = [jnp.asarray(p) for p in init]
    jstate = jopt.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt = build_optimizer("SGD", tparams, 0.1, {"momentum": 0.9})
    acc = MultiSteps(tparams, 3)
    for i, g in enumerate(grads):
        if i == 4:
            fresh = MultiSteps(tparams, 3)
            fresh.load_state_dict(acc.state_dict())
            acc = fresh
        updates, jstate = jopt.update([jnp.asarray(x) for x in g], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        before = [p.detach().clone() for p in tparams]
        mean = acc.update([torch.from_numpy(x) for x in g])
        assert (mean is not None) == (i % 3 == 2)
        if mean is not None:
            clip_by_global_norm_(mean, 0.7)
            for p, m in zip(tparams, mean):
                p.grad = m
            opt.step()
        else:
            assert all(torch.equal(p, b) for p, b in zip(tparams, before))
        for p, jp in zip(tparams, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6,
                                       atol=1e-7, err_msg=f"micro-step {i}")
    assert acc.mini_step == 1
