#!/usr/bin/env python3
"""Drive the PyTorch port (waveformml_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card and nvcc. In
order, it:

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from the checkout's sources (one nvcc per source,
   all at once), printing the time and each kernel's registers and spills;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes of the serving path and times it, the plain version and, where
   one exists, a PyTorch library composition computing the same function;
   K1 also on adversarial plans (full 3×3 clusters, duplicate sites, a
   ragged row count, 5→3 and 56→200 channels, single-site events with no
   off-centre tap) with the row-taps it computes, as it counts them,
   against those the data needs, K2 also on hand-made slot layouts
   (duplicate sites, stitched groups with G > S, events past the batch, a
   ragged MAX that leaves whole tiles empty) with each layout's groups,
   slots, live tiles and output row stride, K3 also on adversarial rows at the detector's sample
   counts and on rows with a gap between them;
4. serves SubMPSD (config/examples/SubMPSD.json widths, seeded random
   weights and head bias) through ``InferenceModel`` over 4 chunks of 4096
   synthetic events, checks every launch count and holds the logits
   against the same model run with the plain versions on the card and,
   for a few events, on the CPU;
5. runs ``waveform_features`` over the first PMT's half of those chunks'
   waveforms and checks its launch count and outputs;
6. prints one JSON line describing every kernel, the card line again, and
   as its last line ``{"ok": true, "device": {...}}``.

Any failure raises, so the script exits non-zero without the last line.
Without CUDA, or outside a checkout, it exits non-zero before printing any
result. Times are CUDA-event medians of CUDA-graph replays (device time
with warm L2, no host launch cost, but with the card's own few µs per
replay, printed as the timing floor; K2 is also timed 20 calls to a graph).
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "config", "examples", "SubMPSD.json")
N_CHUNKS = 4
EVENTS_PER_CHUNK = 4096       # events per batch of the repository's benchmark
SEED = 0
TIMING_SAMPLES = 25           # CUDA-event samples per timing (median)
REPLAYS_PER_SAMPLE = 10       # graph replays between two events
RUN_CALLS = 20                # calls per graph where a call is timed without a replay's cost

# NVIDIA H100 SXM data sheet: HBM3 rate, fp32 rate outside the tensor cores
# and the dense TF32 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
# operations per waveform sample of K3's function in its whole-row form, as
# the plain version computes it: the peak, threshold and first-crossing
# reductions (7), the two one-hot selects (6), two integration windows
# (compares, weight corrections, product and sum: 18 each) and the row total
K3_OPS_PER_SAMPLE = 49
# computed row-taps of a k=3 layer may be at most this multiple of those needed
K1_MAX_COMPUTED_RATIO = 1.5
# sample counts of the detector's waveforms
K3_SAMPLE_COUNTS = (59, 65, 130, 150)

# kernel-vs-plain tolerances: the plain versions are fp32 without TF32; K1
# splits each operand for three TF32 passes (dropping only ~2^-22 relative)
# and sums K²·Cin products in another order, K2 adds an event's rows into
# its bias with atomics in a varying order, K3 rounds each row's sums once
# (double) where the plain version sums in fp32, so its total and psd are
# held to the tolerance times each row's condition number (features_close)
TOL = {"subm_conv_rows": 1e-5, "site_grouped_matmul": 1e-5, "waveform_features": 1e-5}
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-5


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def graph_time_ms(fn, calls: int = 1) -> float:
    """Median device time of one ``fn()`` call: ``calls`` calls of fn are
    captured in one CUDA graph, and each sample times REPLAYS_PER_SAMPLE
    back-to-back replays between two CUDA events. A replay costs the card
    a few µs of its own (the timing floor line), so with calls = 1 a call
    of a few µs is timed with that cost and with more calls mostly
    without."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    for _ in range(3):
        graph.replay()
    samples = []
    for _ in range(TIMING_SAMPLES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPLAYS_PER_SAMPLE):
            graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / (REPLAYS_PER_SAMPLE * calls))
    return statistics.median(samples)


def bound_ms(n_bytes: float, flops: float, flops_per_s: float = FP32_FLOPS_PER_S):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(got, want, tol: float) -> float:
    """Largest |got - want| over tensors, after asserting closeness."""
    err = 0.0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)
        err = max(err, float((g - w).abs().max()))
    return err


# K1's adversarial plans: (label, plan kind, k, Cin, Cout, events, rows)
K1_ADVERSARIAL = (("full 3x3 clusters", "dense_cluster", 3, 130, 104, 1000, None),
                  ("duplicate sites", "duplicate_sites", 3, 104, 56, 1000, None),
                  ("N not a multiple of the tile", "clustered", 3, 130, 104, 1000,
                   78 * 64 + 37),
                  ("Cin 5, Cout 3", "clustered", 3, 5, 3, 1000, None),
                  ("Cout 200", "clustered", 3, 56, 200, 1000, None),
                  ("single-site events", "isolated_sites", 3, 130, 104, 64, None))


def check_subm_conv_rows_adversarial(rng) -> float:
    """K1 against its plain version on plans that stress its compaction,
    tiles and widths; returns the largest |error|."""
    from waveformml_tpu_torch.datasets.synthetic import conv_case
    from waveformml_tpu_torch.ops.row_conv import (host_neighbor_plan, subm_conv_rows,
                                                   subm_conv_rows_plain)

    err = 0.0
    for label, kind, k, cin, cout, n_events, n_rows in K1_ADVERSARIAL:
        coords, feats, kernel, bias, mask = conv_case(rng, kind, n_events, k, cin, cout,
                                                      n_rows)
        plan = host_neighbor_plan(coords, mask, n_events, k)
        args = [torch.from_numpy(a).cuda() for a in (feats, plan, kernel, bias, mask)]
        got = subm_conv_rows(*args)
        want = subm_conv_rows_plain(*args)
        torch.cuda.synchronize()
        e = max_abs_err([got], [want], TOL["subm_conv_rows"])
        print(f"K1 adversarial, {label}: N={args[0].shape[0]} K²={k * k} {cin}->{cout} "
              f"max_abs_err={e:.3g}", flush=True)
        err = max(err, e)
    return err


def check_subm_conv_rows(model, db):
    """K1 at the three convs of the SubMPSD stack, on one chunk's batch."""
    from waveformml_tpu_torch.ops.row_conv import (subm_conv_rows, subm_conv_rows_plain,
                                                   take_row_taps)
    from waveformml_tpu_torch.models.sparse_blocks import RowSubMConv2d

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    mask = db["mask"]
    n = mask.shape[0]
    convs = [m for m in model.stack.modules() if isinstance(m, RowSubMConv2d)]
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                  bytes=0.0, flops=0.0, max_abs_err=0.0)
    for layer, conv in enumerate(convs):
        kk, cin, cout = conv.weight.shape
        plan = db[f"plan_k{conv.kernel_size}"]
        if layer == 0:
            feats = db["feats"]
        else:
            feats = torch.randn(n, cin, device="cuda", generator=gen)
            feats = torch.where(mask[:, None], feats, 0.0).contiguous()
        args = (feats, plan, conv.weight.detach(), conv.bias.detach(), mask)
        take_row_taps()
        got = subm_conv_rows(*args)
        computed = take_row_taps()
        want = subm_conv_rows_plain(*args)
        torch.cuda.synchronize()
        err = max_abs_err([got], [want], TOL["subm_conv_rows"])
        padded = torch.cat([feats, feats.new_zeros(1, cin)])
        idx = torch.where(plan >= 0, plan, n).long().reshape(-1)
        w2 = conv.weight.detach().reshape(kk * cin, cout)
        maskf = mask[:, None].float()
        bias = conv.bias.detach()
        ms = graph_time_ms(lambda: subm_conv_rows(*args))
        plain_ms = graph_time_ms(lambda: subm_conv_rows_plain(*args))
        library_ms = graph_time_ms(lambda: torch.addmm(
            bias, torch.index_select(padded, 0, idx).view(n, kk * cin), w2).mul_(maskf))
        n_bytes = 4 * (n * cin + n * kk + kk * cin * cout + cout + n * cout) + n
        needed = int(((plan >= 0) & mask[:, None]).sum())
        # three TF32 passes over the row-taps the data needs
        flops = 3 * 2.0 * cin * cout * needed
        b_ms, by = bound_ms(n_bytes, flops, TF32_FLOPS_PER_S)
        print(f"K1 subm_conv_rows layer {layer}: N={n} K²={kk} {cin}->{cout} "
              f"ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
              f"bound_ms={b_ms:.5f} ({by}) max_abs_err={err:.3g} row-taps needed "
              f"{needed} of {n * kk}, computed {computed} as the kernel counted them "
              f"({computed / max(needed, 1):.3f}x)", flush=True)
        if kk > 1:
            assert computed <= K1_MAX_COMPUTED_RATIO * needed, (computed, needed)
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                         ("bound_ms", b_ms), ("bytes", n_bytes), ("flops", flops)):
            totals[key] += val
        totals["max_abs_err"] = max(totals["max_abs_err"], err)
    totals["bound_by"] = bound_ms(totals["bytes"], totals["flops"], TF32_FLOPS_PER_S)[1]
    return totals


# K2's hand-made layouts (datasets/synthetic.py:site_layout_case): one per
# feature, then all of them at once
K2_ADVERSARIAL = (("duplicate_sites",), ("stitched_groups",), ("events_past_end",),
                  ("ragged_max",),
                  ("duplicate_sites", "stitched_groups", "events_past_end", "ragged_max"))


def k2_layout(take, ev, n_events, out):
    """Groups, MAX, filled and live slots, and K2's tiles with a live slot
    (the tile size as the built kernel reports it) of a slot layout, and
    the row stride of K2's output ``out`` (floats; a multiple of 4, so that
    every add is a float4): (printable line, live tiles, all tiles)."""
    from waveformml_tpu_torch.ops.site_head import tile_slots

    tile = tile_slots()
    g, m = take.shape
    live = (take > 0) & (ev > 0) & (ev <= n_events)
    tiles = -(-m // tile)
    live_tiles = int(torch.nn.functional.pad(live, (0, tiles * tile - m))
                     .view(g, tiles, tile).any(-1).sum())
    return (f"groups={g} MAX={m} filled={int((take > 0).sum())} live={int(live.sum())} "
            f"live tiles={live_tiles} of {g * tiles} ({tile} slots) row stride "
            f"{out.stride(0)}"), live_tiles, g * tiles


def check_site_grouped_matmul_adversarial(rng, c, f) -> float:
    """K2 against its plain version on hand-made layouts at the head's
    widths, with the bias; returns the largest |error|."""
    from waveformml_tpu_torch.datasets.synthetic import site_layout_case
    from waveformml_tpu_torch.ops.site_head import (site_grouped_matmul,
                                                    site_grouped_matmul_plain)

    err = 0.0
    for features in K2_ADVERSARIAL:
        *arrays, bias = site_layout_case(rng, features, EVENTS_PER_CHUNK, c, f)
        rows, k3, take, ev, site = (torch.from_numpy(a).cuda() for a in arrays)
        args = (rows, k3, take, ev, site, EVENTS_PER_CHUNK, torch.from_numpy(bias).cuda())
        got = site_grouped_matmul(*args)
        want = site_grouped_matmul_plain(*args)
        torch.cuda.synchronize()
        e = max_abs_err([got], [want], TOL["site_grouped_matmul"])
        line, live_tiles, tiles = k2_layout(take, ev, EVENTS_PER_CHUNK, got)
        print(f"K2 adversarial, {'+'.join(features)}: {line} max_abs_err={e:.3g}",
              flush=True)
        if "ragged_max" in features:
            # whole tiles of every group are empty: the kernel skipped them
            assert live_tiles < tiles, (live_tiles, tiles)
        err = max(err, e)
    return err


def check_site_grouped_matmul(model, db):
    """K2 at the SubMPSD head (C=8, F=50, with its bias) on one chunk's slot
    layout."""
    from waveformml_tpu_torch.detector import NX, NY
    from waveformml_tpu_torch.ops.site_head import (site_grouped_matmul,
                                                    site_grouped_matmul_plain)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    mask = db["mask"]
    head = model.head0
    c, f, s = head.cin, head.features, NX * NY
    rows = torch.relu(torch.randn(mask.shape[0], c, device="cuda", generator=gen))
    rows = torch.where(mask[:, None], rows, 0.0).contiguous()
    k3 = head.weight.detach().view(c, s, f)
    bias = head.bias.detach()
    take, ev, site = db["plan_site_take"], db["plan_site_ev"], db["plan_site_s"]
    n_events = db["labels"].shape[0]
    args = (rows, k3, take, ev, site, n_events, bias)
    got = site_grouped_matmul(*args)
    want = site_grouped_matmul_plain(*args)
    torch.cuda.synchronize()
    err = max_abs_err([got], [want], TOL["site_grouped_matmul"])
    layout = k2_layout(take, ev, n_events, got)[0]
    g, m = take.shape
    rows_pad = torch.cat([rows.new_zeros(1, c), rows])
    take_flat = take.reshape(-1).long()
    kg = k3[:, (site.long() - 1).clamp(0, s - 1), :].permute(1, 0, 2).contiguous()
    evs = ev.reshape(-1).long()
    idx = torch.where((evs > 0) & (evs <= n_events), evs - 1, n_events)
    out = torch.empty(n_events + 1, f, device="cuda")

    def library():
        out.copy_(bias.expand(n_events + 1, f))
        out.index_add_(0, idx, torch.bmm(torch.index_select(rows_pad, 0, take_flat)
                                         .view(g, m, c), kg).view(-1, f))

    ms = graph_time_ms(lambda: site_grouped_matmul(*args))
    plain_ms = graph_time_ms(lambda: site_grouped_matmul_plain(*args))
    library_ms = graph_time_ms(library)
    ms_run = graph_time_ms(lambda: site_grouped_matmul(*args), calls=RUN_CALLS)
    library_ms_run = graph_time_ms(library, calls=RUN_CALLS)
    # the function gathers the rows of live slots only (each once) and
    # multiplies each live slot once
    live = (take > 0) & (ev > 0) & (ev <= n_events)
    n_live = int(live.sum())
    rows_read = int(torch.unique(take[live]).numel())
    n_bytes = 4 * (rows_read * c + k3.numel() + 2 * g * m + g + f + n_events * f)
    b_ms, by = bound_ms(n_bytes, 2.0 * c * f * n_live)
    print(f"K2 site_grouped_matmul: {layout} C={c} F={f} B={n_events} ms={ms:.5f} "
          f"plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} bound_ms={b_ms:.6f} "
          f"({n_bytes} bytes, {rows_read} rows gathered) max_abs_err={err:.3g}; in a graph of {RUN_CALLS} calls: ms={ms_run:.5f} "
          f"library_ms={library_ms_run:.5f}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                bound_by=by, max_abs_err=err)


def check_waveform_features(wfs_main, wfs_150, wfs_pairs, rng):
    """K3 on the feature path's input (S=65), on synthetic pulses at S=150,
    on adversarial rows at each of the detector's sample counts and on the
    first PMT's samples read in place from the [n, 2·S] pair rows; the row
    counts are not multiples of the block's rows. The max_abs_err returned
    is that of the timed input, the feature path's: where a row's psd
    cancels (signed noise), its absolute error grows as 1/|fast + slow|, so
    the other inputs are held by features_close and printed."""
    from waveformml_tpu_torch.datasets.synthetic import adversarial_waveforms
    from waveformml_tpu_torch.ops.waveform_features import (features_close,
                                                            launch_geometry,
                                                            waveform_features,
                                                            waveform_features_plain)

    s_main = wfs_main.shape[1]
    strided = wfs_pairs[:, :s_main]
    assert strided.stride(0) == 2 * s_main
    inputs = [("pulses", wfs_main), ("pulses", wfs_main[:4097]), ("pulses", wfs_150),
              ("strided rows", strided)]
    inputs += [("adversarial", torch.from_numpy(
        adversarial_waveforms(rng, 4097, s).astype(np.float32)).cuda())
        for s in K3_SAMPLE_COUNTS]
    err = 0.0
    for name, wfs in inputs:
        rows = launch_geometry(wfs.shape[1])[0]
        assert wfs.shape[0] % rows != 0 or wfs is wfs_main
        got = waveform_features(wfs)
        want = waveform_features_plain(wfs)
        torch.cuda.synchronize()
        close = features_close(got, want, wfs, TOL["waveform_features"])
        print(f"K3 {name}: n={wfs.shape[0]} S={wfs.shape[1]} row stride "
              f"{wfs.stride(0)} max_abs_err={close['max_abs_err']:.3g}; largest psd "
              f"difference {close['psd_excess']:.3g}x tol·(1+|psd|), on a row of "
              f"condition number {close['psd_kappa']:.4g}", flush=True)
        if wfs is wfs_main:
            err = close["max_abs_err"]
    ms = graph_time_ms(lambda: waveform_features(wfs_main))
    plain_ms = graph_time_ms(lambda: waveform_features_plain(wfs_main))
    n, s = wfs_main.shape
    b_ms, by = bound_ms(4 * (n * s + 4 * n), K3_OPS_PER_SAMPLE * n * s)
    print(f"K3 waveform_features: n={n} S={s} ms={ms:.5f} plain_ms={plain_ms:.5f} "
          f"bound_ms={b_ms:.5f} max_abs_err={err:.3g}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=by, max_abs_err=err)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from waveformml_tpu_torch.config import load_config
    from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
    from waveformml_tpu_torch.datasets.synthetic import make_events, synth_waveform_pair
    from waveformml_tpu_torch.detector import MAX_RANGE
    from waveformml_tpu_torch.inference.model import InferenceModel
    from waveformml_tpu_torch.models.blocks import FoldedSiteLinear
    from waveformml_tpu_torch.models.nets import SubMPSDNet
    from waveformml_tpu_torch.models.sparse_blocks import RowSubMConv2d
    from waveformml_tpu_torch.ops import native
    from waveformml_tpu_torch.ops.row_conv import subm_conv_rows
    from waveformml_tpu_torch.ops.site_head import site_grouped_matmul
    from waveformml_tpu_torch.ops.waveform_features import waveform_features

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    reports = native.build()
    print(f"build: nvcc {sorted(reports) or 'cached'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    # -- data and model -------------------------------------------------------
    cfg = load_config(CONFIG)
    n_samples = cfg.system_config.n_samples
    rng = np.random.default_rng(SEED)
    chunks = [make_events(rng, EVENTS_PER_CHUNK, n_samples, kind=i % 2)
              for i in range(N_CHUNKS)]
    inputs = [(ch["coords"], (ch["waveforms"] / MAX_RANGE).astype(np.float32))
              for ch in chunks]
    gen = torch.Generator().manual_seed(SEED)
    model = SubMPSDNet(cfg, generator=gen)
    with torch.no_grad():
        # initialisation leaves the head's bias zero, which K2 now adds
        model.head0.bias.normal_(generator=gen)
    state = model.state_dict()
    server = InferenceModel(cfg, state)
    t0 = time.perf_counter()
    server(*inputs[0])                       # loads the kernels' libraries
    torch.cuda.synchronize()
    print(f"first chunk (library load, allocator warm-up): "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    # -- 3. kernels against their plain versions ------------------------------
    probe = torch.zeros(16, device="cuda")
    print(f"timing floor: a graph of one 16-float add replays in "
          f"{graph_time_ms(lambda: probe.add_(1)):.5f} ms; in a graph of {RUN_CALLS} "
          f"such adds, each takes {graph_time_ms(lambda: probe.add_(1), RUN_CALLS):.5f} ms",
          flush=True)
    coords0, feats0 = inputs[0]
    task = server.task
    block = FileBlock(coords0, feats0, np.zeros(EVENTS_PER_CHUNK, np.int64))
    db = task.to_device(task.prepare_block(block, task.row_bucket(block),
                                           task.event_bucket(block)))
    wfs_main = torch.from_numpy(np.concatenate(
        [ch["waveforms"][:, :n_samples] for ch in chunks])).cuda()
    wfs_150 = torch.from_numpy(np.stack(
        [synth_waveform_pair(rng, 150, rng.uniform(0.5, 10.0), 0.0)[:150]
         for _ in range(4097)])).cuda()
    wfs_pairs = torch.from_numpy(np.concatenate([ch["waveforms"] for ch in chunks])).cuda()
    results = {
        "subm_conv_rows": check_subm_conv_rows(task.model, db),
        "site_grouped_matmul": check_site_grouped_matmul(task.model, db),
        "waveform_features": check_waveform_features(wfs_main, wfs_150, wfs_pairs, rng),
    }
    results["subm_conv_rows"]["max_abs_err"] = max(
        results["subm_conv_rows"]["max_abs_err"], check_subm_conv_rows_adversarial(rng))
    head = task.model.head0
    results["site_grouped_matmul"]["max_abs_err"] = max(
        results["site_grouped_matmul"]["max_abs_err"],
        check_site_grouped_matmul_adversarial(rng, head.cin, head.features))

    # -- 4. serving path ------------------------------------------------------
    server.dispatch_phases = dict.fromkeys(server.dispatch_phases, 0.0)
    subm_conv_rows.launches = 0
    site_grouped_matmul.launches = 0
    waveform_features.launches = 0
    t0 = time.perf_counter()
    handles = [server.dispatch(c, f) for c, f in inputs]
    logits = [server.fetch(h) for h in handles]
    wall = time.perf_counter() - t0
    launches = {"subm_conv_rows": subm_conv_rows.launches,
                "site_grouped_matmul": site_grouped_matmul.launches,
                "waveform_features": waveform_features.launches}
    n_events = N_CHUNKS * EVENTS_PER_CHUNK
    n_rows = sum(c.shape[0] for c, _ in inputs)
    print(f"serving: {N_CHUNKS} chunks, {n_events} events, {n_rows} waveform pairs "
          f"in {wall:.4f} s = {n_events / wall:.1f} events/s; launches {launches}",
          flush=True)
    # K1: one grid per conv for the centre tap, one more for a K² > 1 conv's
    # other taps
    k1_grids = sum(1 if m.kernel_size == 1 else 2 for m in task.model.stack.modules()
                   if isinstance(m, RowSubMConv2d))
    # K2: one grid writes the head's bias into the event rows, one adds the
    # slots' products
    assert launches == {"subm_conv_rows": k1_grids * N_CHUNKS,
                        "site_grouped_matmul": 2 * N_CHUNKS,
                        "waveform_features": 0}, launches
    for out in logits:
        assert out.shape == (EVENTS_PER_CHUNK, cfg.system_config.n_type), out.shape
        assert np.isfinite(out).all()
    # where the serving time goes: the host-clock phases of that run, and
    # the device forward of one chunk as a CUDA-graph replay
    forward_ms = graph_time_ms(lambda: task.apply_model(db))
    phases = " ".join(f"{k[:-2]} {v * 1e3 / N_CHUNKS:.3f}"
                      for k, v in server.dispatch_phases.items())
    print(f"serving breakdown (ms/chunk): {phases}; device forward "
          f"{forward_ms:.4f}; wall {wall * 1e3 / N_CHUNKS:.3f}; device busy share "
          f"{N_CHUNKS * forward_ms / (wall * 1e3):.4f}", flush=True)

    reference = InferenceModel(cfg, state)
    for module in reference.task.model.modules():
        if isinstance(module, (RowSubMConv2d, FoldedSiteLinear)):
            module.plain = True
    agree = 0
    for (c, f), out in zip(inputs, logits):
        want = reference(c, f)
        np.testing.assert_allclose(out, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
        agree += int((out.argmax(-1) == want.argmax(-1)).sum())
    small = coords0[:, -1] < 64
    cpu = InferenceModel(cfg, state, device="cpu")(coords0[small], feats0[small])
    card_small = server(coords0[small], feats0[small])
    np.testing.assert_allclose(card_small, cpu, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    np.testing.assert_allclose(card_small, logits[0][:64], rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL)
    print(f"logits match the plain versions on the card (rtol={LOGIT_RTOL}, "
          f"atol={LOGIT_ATOL}); argmax agrees on {agree}/{n_events} events; "
          f"64 events match the CPU run", flush=True)

    # -- 5. waveform-features path --------------------------------------------
    waveform_features.launches = 0
    t0 = time.perf_counter()
    arrival, psd, total, peak = waveform_features(wfs_main)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["waveform_features"] = waveform_features.launches
    assert launches["waveform_features"] == 1, launches
    for x in (arrival, psd, total, peak):
        assert x.shape == (wfs_main.shape[0],) and bool(torch.isfinite(x).all())
    assert bool(((psd >= 0) & (psd <= 1)).all())
    print(f"waveform features: {wfs_main.shape[0]} waveforms x {n_samples} samples "
          f"in {wall:.4f} s; means arrival={float(arrival.mean()):.4f} "
          f"psd={float(psd.mean()):.4f} total={float(total.mean()):.1f} "
          f"peak={float(peak.mean()):.1f}", flush=True)

    # -- 6. report ------------------------------------------------------------
    sources = {
        "subm_conv_rows": ("cuda", "waveformml_tpu_torch/csrc/row_conv.cu",
                           "waveformml_tpu/ops/row_conv.py:226"),
        "site_grouped_matmul": ("cuda", "waveformml_tpu_torch/csrc/site_head.cu",
                                "waveformml_tpu/ops/site_head.py:83"),
        "waveform_features": ("cuda", "waveformml_tpu_torch/csrc/waveform_features.cu",
                              "waveformml_tpu/ops/pallas_dsp.py:113"),
    }
    kernels = []
    for name, (route, source, replaces) in sources.items():
        r = results[name]
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
