"""Plain reference of ``config/examples/SingleEndedZCNN.json`` (LitZ,
``SingleEndedZConv`` with the "conv" algorithm: ``SparseConv2DForZ`` of
kernel 3 and two layers), in float32 over the occupied (event, x, y) sites:

1. the rows' 300 features (both PMTs' 150 samples) summed into their sites;
2. ``spconv.SparseConv2d(300, 150, 3, padding=1)``: its output sites are the
   grid sites whose 3×3 window holds an occupied input site; at each, the
   bias plus ``W[:, :, dx, dy]·x`` over the window's occupied inputs;
3. BatchNorm(150) over those output sites (batch statistics in training,
   running statistics in evaluation), ReLU;
4. ``spconv.SparseConv2d(150, 1, 1)`` on the same sites, ReLU;
5. ``ToDense``: ``[B, 1, 14, 11]``, zero off the output sites;
6. training: L1 between that map and the rows' z summed into their sites,
   over the input's occupied sites, averaged over them; SGD with the
   config's momentum and nesterov at ``lr·gamma^epoch``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from portbench.reference import _sparse as sp

L0 = "SparseConv2DForZ_0.l0.conv"
BN = "SparseConv2DForZ_0.l1"
L3 = "SparseConv2DForZ_0.l3.conv"


def forward(p: Dict[str, torch.Tensor], coords: torch.Tensor, feats: torch.Tensor,
            n_events: int, train: bool, tf32: bool = False):
    """The ``[n_events, 1, 14, 11]`` map of one chunk (coords ``[N, 3]``:
    x, y, event), the input's occupied sites and the map at them."""
    in_sites, x = sp.sites_of(coords, feats)
    out_sites = sp.dilated_sites(in_sites, 3, 2)
    h = sp.conv_sites(in_sites, x, out_sites, p[f"{L0}.weight"], p[f"{L0}.bias"], tf32=tf32)
    if train:
        h = sp.batch_norm_train(h, p[f"{BN}.weight"], p[f"{BN}.bias"])
    else:
        h = sp.batch_norm_eval(h, p[f"{BN}.weight"], p[f"{BN}.bias"],
                               p[f"{BN}.running_mean"], p[f"{BN}.running_var"])
    h = torch.relu(h)
    y = torch.relu(sp.conv_sites(out_sites, h, out_sites, p[f"{L3}.weight"], p[f"{L3}.bias"],
                                 tf32=tf32))[:, 0]
    e, xx, yy = sp.key_xyz(out_sites)
    dense = y.new_zeros((n_events, sp.NX, sp.NY)).index_put((e, xx, yy), y)
    at_inputs = y[sp.lookup(out_sites, in_sites, torch.ones_like(in_sites, dtype=torch.bool))[0]]
    return dense[:, None], in_sites, at_inputs


def calibrate(config: Dict, weights: Dict[str, torch.Tensor], chunk) -> Dict[str, torch.Tensor]:
    """``weights`` with the BatchNorm's running statistics set to those of
    the first conv's outputs over ``chunk``'s output sites (the mean and the
    unbiased variance), as training leaves them for data like it; so that
    the served map depends on the data and not on the biases alone."""
    dev = next(iter(weights.values())).device
    with sp.float32_matmul(), torch.no_grad():
        in_sites, x = sp.sites_of(torch.as_tensor(chunk.coords, device=dev),
                                  torch.as_tensor(chunk.feats, device=dev))
        out_sites = sp.dilated_sites(in_sites, 3, 2)
        h = sp.conv_sites(in_sites, x, out_sites, weights[f"{L0}.weight"], weights[f"{L0}.bias"])
    out = dict(weights)
    out[f"{BN}.running_mean"] = h.mean(0)
    out[f"{BN}.running_var"] = h.var(0, unbiased=True)
    return out


def serve(config: Dict, weights: Dict[str, torch.Tensor], chunk, tf32: bool = False):
    """The served map of one chunk (evaluation mode), as numpy."""
    dev = next(iter(weights.values())).device
    with sp.float32_matmul(), torch.no_grad():
        dense, _, _ = forward(weights, torch.as_tensor(chunk.coords, device=dev),
                              torch.as_tensor(chunk.feats, device=dev), chunk.n_events,
                              False, tf32)
    return dense.cpu().numpy()


def train_steps(config: Dict, weights: Dict[str, torch.Tensor], chunks: Sequence,
                epochs: Sequence[int], tf32: bool = False, half_batch: bool = False) -> Dict:
    """As ``SCNet3D.train_steps``: each step's loss, the first step's
    map and gradients and each parameter's change after the last step.
    ``half_batch`` (a fault, read as a control) takes the loss over the
    sites of the first half of each chunk's events only."""
    with sp.float32_matmul():
        return _train(config, weights, chunks, epochs, tf32, half_batch)


def _train(config, weights, chunks, epochs, tf32, half_batch):
    oc = config["optimize_config"]
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
        z = torch.as_tensor(chunk.labels, device=dev).float()
        dense, in_sites, pred = forward({**params, **fixed}, coords, feats, chunk.n_events, True,
                                    tf32)
        if out1 is None:
            out1 = dense.detach().cpu()
        _, target = sp.sites_of(coords, z[:, None])
        err = (pred - target[:, 0]).abs()
        if half_batch:
            err = err[sp.key_xyz(in_sites)[0] < chunk.n_events // 2]
        value = err.mean()
        grads = dict(zip(params, torch.autograd.grad(value, list(params.values()))))
        if grad1 is None:
            grad1 = {k: g.detach().clone() for k, g in grads.items()}
        losses.append(float(value.detach()))
        sp.sgd_steps(params, grads, state, oc["lr"] * gamma ** epoch,
                     opt.get("momentum", 0.0), bool(opt.get("nesterov", False)),
                     opt.get("weight_decay", 0.0), opt.get("dampening", 0.0))
    delta = {k: (params[k].detach() - start[k]) for k in params}
    return {"losses": losses, "grad1": grad1, "delta": delta, "out1": out1}
