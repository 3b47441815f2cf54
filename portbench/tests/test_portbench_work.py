"""``portbench/work/``: operations and bytes counted by hand on small,
hand-made coordinates, under the layers' sparse semantics."""
import json
import os

import numpy as np

from conftest import ROOT
from portbench import gen
from portbench.harness import load_module


def config(name):
    return json.load(open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")))["config"]


def chunk(coords, n_events, width):
    coords = np.asarray(coords, np.int32)
    return gen.Chunk(coords, np.zeros((coords.shape[0], width), np.float32),
                     np.zeros(n_events, np.int64), n_events)


def test_subm_conv_3d_counts_present_taps():
    # event 0: three rows, each with the other two inside its 3x3x3 window;
    # event 1: one row alone. Present taps 3 + 3 + 3 + 1 = 10.
    c = chunk([[0, 0, 0, 0], [0, 0, 1, 0], [1, 1, 1, 0], [0, 0, 0, 1]], 2, 2)
    w = load_module("work", "SCNet3D")
    serve = w.count(c, config("SCNet3D"), "serve")
    train = w.count(c, config("SCNet3D"), "train")
    assert serve["sites"] == 4 and serve["taps"] == 10
    assert serve["grid_flops"] == 2 * 2 * 8 * 10
    assert train["grid_flops"] == 2 * 2 * 2 * 8 * 10            # forward and weight gradient
    weights = (27 * 2 * 8 + 8) * 4
    # features in, coordinates, weights, output written
    assert serve["grid_bytes"] == 4 * 2 * 4 + 4 * 4 * 4 + weights + 4 * 8 * 4
    # and the output's gradient read, the weight gradient written
    assert train["grid_bytes"] == serve["grid_bytes"] + 4 * 8 * 4 + weights
    linear = 2 * 2 * (19712 * 32 + 32 * 2)
    assert serve["model_flops"] == serve["grid_flops"] + linear
    assert train["model_flops"] == train["grid_flops"] + 3 * linear


def test_regular_conv_2d_counts_dilated_sites_and_occupied_taps():
    # event 0: sites (0, 0) and (2, 0), whose 3x3 windows cover 4 and 6 grid
    # sites, 2 of them shared; event 1: the corner (13, 10), 4 sites.
    c = chunk([[0, 0, 0], [2, 0, 0], [13, 10, 1]], 2, 300)
    w = load_module("work", "SingleEndedZCNN")
    serve = w.count(c, config("SingleEndedZCNN"), "serve")
    train = w.count(c, config("SingleEndedZCNN"), "train")
    assert (serve["in_sites"], serve["out_sites"], serve["pairs"]) == (3, 12, 14)
    conv0, conv1 = 2 * 300 * 150 * 14, 2 * 150 * 1 * 12
    assert serve["grid_flops"] == conv0 + conv1
    assert train["grid_flops"] == 2 * conv0 + 3 * conv1
    w0, w1 = (9 * 300 * 150 + 150) * 4, (150 + 1) * 4
    bytes0 = 3 * 300 * 4 + 3 * 3 * 4 + w0 + 12 * 150 * 4
    bytes1 = 12 * 150 * 4 + w1 + 12 * 4
    assert serve["grid_bytes"] == bytes0 + bytes1
    assert train["grid_bytes"] == (bytes0 + 12 * 150 * 4 + w0) + (bytes1 + 12 * 4 + w1
                                                                   + 12 * 150 * 4)
    assert serve["model_flops"] == serve["grid_flops"]


def test_least_time_is_the_larger_bound():
    from portbench.metrics._read import least_seconds

    peaks = {"flops": 1e12, "bytes": 1e9}
    work = [{"grid_flops": 2e12, "grid_bytes": 1e9}, {"grid_flops": 1e12, "grid_bytes": 3e9}]
    assert least_seconds(work, peaks) == 2.0 + 3.0
