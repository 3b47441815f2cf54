"""Operations and bytes that one chunk of ``SCNet3D.json`` needs, counted
from its rows under the layers' sparse semantics (float32, 4 bytes a value).

* ``SubMConv3d(2, 8, 3)``: 2·Cin·Cout per (occupied site, tap whose
  neighbour is occupied), in the forward and in the weight gradient; no
  input gradient (its input is the data). Bytes: the sites' features and
  coordinates read once, the output written once, the weights once; in
  training also the output's gradient read and the weight gradient written.
* ``Linear(19712, 32)``, ``Linear(32, 2)``: 2·B·in·out a pass at their
  published shapes; training adds the weight and the input gradients.

``grid_*`` are the SubM conv's alone (the grid ops layer), ``model_flops``
the conv's and the Linear layers' (BatchNorm, ReLU and the loss, a few
operations a value, are not counted).
"""
from __future__ import annotations

from portbench.work import _sites

F32 = 4


def _layers(algorithm):
    """(SubMConv3d args, [Linear args]) of the DSL list."""
    conv, linear = None, []
    for i, item in enumerate(algorithm):
        args = algorithm[i + 1] if i + 1 < len(algorithm) and isinstance(
            algorithm[i + 1], list) else None
        if item == "spconv.SubMConv3d":
            conv = args
        elif item == "nn.Linear":
            linear.append(args)
    return conv, linear


def count(chunk, config, mode: str):
    n_t = int(config["system_config"]["n_samples"])
    conv, linear = _layers(config["net_config"]["algorithm"])
    cin, cout, k = conv[:3]
    sites = _sites.site_keys(chunk.coords, n_t)
    s = sites.shape[0]
    taps = _sites.present_taps(sites, sites, k, 3, n_t)
    train = mode == "train"
    conv_pass = 2.0 * cin * cout * taps
    w = (k ** 3 * cin * cout + cout) * F32
    grid_flops = conv_pass * (2 if train else 1)
    grid_bytes = s * cin * F32 + s * 4 * F32 + w + s * cout * F32
    if train:
        grid_bytes += s * cout * F32 + w
    b = chunk.n_events
    lin_pass = sum(2.0 * b * n_in * n_out for n_in, n_out in linear)
    model_flops = grid_flops + lin_pass * (3 if train else 1)
    return {"grid_flops": grid_flops, "grid_bytes": float(grid_bytes),
            "model_flops": model_flops, "sites": s, "taps": taps}
