"""Operations and bytes that one chunk of ``SingleEndedZCNN.json`` needs,
counted from its rows under the layers' sparse semantics (float32, 4 bytes
a value).

* ``SparseConv2d(300, 150, 3, padding=1)``: 2·Cin·Cout per (output site in
  the dilated occupancy, tap whose input site is occupied), in the forward
  and in the weight gradient; no input gradient (its input is the data).
* ``SparseConv2d(150, 1, 1)``: 2·Cin·Cout per output site, in the forward,
  the weight and the input gradient.

Bytes, each layer apart: its input sites' features read once (and the
first layer's coordinates), its output written once, its weights once; in
training also its output's gradient read, its weight gradient written and,
for the second layer, its input gradient written. ``grid_*`` and
``model_flops`` are the two convs' (BatchNorm and ReLU are not counted).
"""
from __future__ import annotations

from portbench.work import _sites

F32 = 4


def count(chunk, config, mode: str):
    train = mode == "train"
    ns = int(config["system_config"]["n_samples"])
    k = int(config["net_config"]["hparams"]["conv"]["kernel_size"])
    cin, mid, cout = 2 * ns, ns, 1
    in_sites = _sites.site_keys(chunk.coords)
    out_sites = _sites.dilated(in_sites, k, 2)
    si, so = in_sites.shape[0], out_sites.shape[0]
    pairs = _sites.present_taps(in_sites, out_sites, k, 2)
    w0 = (k * k * cin * mid + mid) * F32
    w1 = (mid * cout + cout) * F32
    flops0 = 2.0 * cin * mid * pairs
    flops1 = 2.0 * mid * cout * so
    grid_flops = flops0 * (2 if train else 1) + flops1 * (3 if train else 1)
    bytes0 = si * cin * F32 + si * 3 * F32 + w0 + so * mid * F32
    bytes1 = so * mid * F32 + w1 + so * cout * F32
    if train:
        bytes0 += so * mid * F32 + w0
        bytes1 += so * cout * F32 + w1 + so * mid * F32
    return {"grid_flops": grid_flops, "grid_bytes": float(bytes0 + bytes1),
            "model_flops": grid_flops, "in_sites": si, "out_sites": so, "pairs": pairs}
