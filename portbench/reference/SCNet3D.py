"""Plain reference of ``config/examples/SCNet3D.json`` (LitPSD, the
algorithm-DSL ``SCNet`` of ``net_type`` 3DConvolution), in float32 over the
occupied (event, x, y, t) sites:

1. the rows' features summed into their sites (the scatter to the grid);
2. ``spconv.SubMConv3d(2, 8, 3)``: at each occupied site, the bias plus the
   27 taps' ``W[:, :, dx, dy, dt]·x`` over the occupied neighbours;
3. ``nn.BatchNorm1d(8)`` over the occupied sites (batch statistics in
   training), ``nn.ReLU``;
4. ``spconv.ToDense``: ``[B, 8, 14, 11, 16]`` with zeros off the sites,
   flattened channels first to ``[B, 19712]``;
5. ``nn.Linear(19712, 32)``, ``nn.ReLU``, ``nn.Linear(32, 2)``;
6. training: cross entropy averaged over the events; SGD with the config's
   momentum and nesterov, the learning rate ``lr·gamma^epoch``
   (ExponentialLR stepped once an epoch).

Parameters are named as the port's ``state_dict`` names them, which is how
the benchmark hands both sides the same weights.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from portbench.reference import _sparse as sp

CONV = "sparse_model.layers_0.conv"
BN = "sparse_model.layers_1"
LIN0 = "linear_layers_0.dense"
LIN1 = "linear_layers_2.dense"


def forward(p: Dict[str, torch.Tensor], coords: torch.Tensor, feats: torch.Tensor,
            n_events: int, n_t: int, train: bool, tf32: bool = False) -> torch.Tensor:
    """Logits ``[n_events, 2]`` of one chunk (coords ``[N, 4]``: x, y, t,
    event)."""
    flat = _flat(p, coords, feats, n_events, n_t, train, tf32)
    z = torch.relu(sp.mm(flat, p[f"{LIN0}.weight"].t(), tf32) + p[f"{LIN0}.bias"])
    return sp.mm(z, p[f"{LIN1}.weight"].t(), tf32) + p[f"{LIN1}.bias"]


def _flat(p, coords, feats, n_events, n_t, train, tf32=False):
    """Steps 1–4: the head's input ``[n_events, 8·14·11·T]``."""
    sites, x = sp.sites_of(coords, feats, n_t)
    h = sp.conv_sites(sites, x, sites, p[f"{CONV}.weight"], p[f"{CONV}.bias"], n_t, tf32)
    if train:
        h = sp.batch_norm_train(h, p[f"{BN}.weight"], p[f"{BN}.bias"])
    else:
        h = sp.batch_norm_eval(h, p[f"{BN}.weight"], p[f"{BN}.bias"],
                               p[f"{BN}.running_mean"], p[f"{BN}.running_var"])
    h = torch.relu(h)
    c = h.shape[1]
    e, xx, yy, tt = sp.key_xyz(sites, n_t)
    dense = h.new_zeros((n_events, c, sp.NX, sp.NY, n_t))
    channel = torch.arange(c, device=h.device)[None, :]
    dense = dense.index_put((e[:, None], channel, xx[:, None], yy[:, None], tt[:, None]), h)
    return dense.reshape(n_events, -1)


def calibrate(config: Dict, weights: Dict[str, torch.Tensor], chunk) -> Dict[str, torch.Tensor]:
    """``weights`` with each Linear layer's weight scaled so that its output
    has unit standard deviation over ``chunk`` in training mode (LSUV:
    Mishkin and Matas, "All you need is a good init", 2016): the conv's
    output reaches the head at about 190 of a row's 19712 inputs, so
    ``N(0, 1/fan_in)`` weights would give logits near 0, where the loss
    hardly depends on the data."""
    dev = next(iter(weights.values())).device
    n_t = int(config["system_config"]["n_samples"])
    out = dict(weights)
    coords = torch.as_tensor(chunk.coords, device=dev)
    feats = torch.as_tensor(chunk.feats, device=dev)
    with sp.float32_matmul(), torch.no_grad():
        x = _flat(out, coords, feats, chunk.n_events, n_t, True)
        for layer in (LIN0, LIN1):
            y = x @ out[f"{layer}.weight"].t() + out[f"{layer}.bias"]
            out[f"{layer}.weight"] = out[f"{layer}.weight"] / max(float(y.std()), 1e-12)
            x = torch.relu(x @ out[f"{layer}.weight"].t() + out[f"{layer}.bias"])
    return out


def loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross entropy averaged over the events."""
    return F.cross_entropy(logits, labels.long())


def train_steps(config: Dict, weights: Dict[str, torch.Tensor], chunks: Sequence,
                epochs: Sequence[int], tf32: bool = False, half_batch: bool = False) -> Dict:
    """Steps of training from ``weights``, one a chunk (each with
    ``coords``, ``feats``, ``labels``, ``n_events`` as numpy), the i-th in
    epoch ``epochs[i]``. Returns each step's loss, the first step's logits
    and gradients and each parameter's change after the last step.
    ``half_batch`` (a fault, read as a control) leaves the second half of
    each chunk's events out of the loss."""
    with sp.float32_matmul():
        return _train(config, weights, chunks, epochs, tf32, half_batch)


def _train(config, weights, chunks, epochs, tf32, half_batch):
    oc = config["optimize_config"]
    n_t = int(config["system_config"]["n_samples"])
    dev = next(iter(weights.values())).device
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()
              if not k.endswith(("running_mean", "running_var"))}
    fixed = {k: v for k, v in weights.items() if k not in params}
    start = {k: v.detach().clone() for k, v in params.items()}
    opt = oc.get("optimizer_params", {})
    gamma = oc.get("scheduler_params", {}).get("gamma", 1.0)
    state: Dict[str, torch.Tensor] = {}
    losses: List[float] = []
    grad1 = out1 = None
    for chunk, epoch in zip(chunks, epochs):
        coords = torch.as_tensor(chunk.coords, device=dev)
        feats = torch.as_tensor(chunk.feats, device=dev)
        labels = torch.as_tensor(chunk.labels, device=dev)
        logits = forward({**params, **fixed}, coords, feats, chunk.n_events, n_t, True, tf32)
        if out1 is None:
            out1 = logits.detach().cpu()
        if half_batch:
            keep = chunk.n_events // 2
            logits, labels = logits[:keep], labels[:keep]
        value = loss(logits, labels)
        grads = dict(zip(params, torch.autograd.grad(value, list(params.values()))))
        if grad1 is None:
            grad1 = {k: g.detach().clone() for k, g in grads.items()}
        losses.append(float(value.detach()))
        sp.sgd_steps(params, grads, state, oc["lr"] * gamma ** epoch,
                     opt.get("momentum", 0.0), bool(opt.get("nesterov", False)),
                     opt.get("weight_decay", 0.0), opt.get("dampening", 0.0))
    delta = {k: (params[k].detach() - start[k]) for k in params}
    return {"losses": losses, "grad1": grad1, "delta": delta, "out1": out1}
