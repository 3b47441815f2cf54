"""Plot the weight tensors of a checkpoint as heatmaps (the port's
counterpart of scripts/PlotModelWeights.py):

    python -m waveformml_tpu_torch.scripts.plot_model_weights ckpt [-o DIR] [--max_plots N]

``ckpt`` is a checkpoint of the port's ``Trainer`` or a ``state_dict`` file.
Every tensor of rank 2 or more, in the port's own layout (a tensor of higher
rank flattened to ``[shape[0], -1]``), up to N of them in ``state_dict``
order, goes to ``DIR/<key with . as _>.png`` (needs matplotlib).
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import torch

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("checkpoint", help="checkpoint or state_dict file")
    parser.add_argument("--out_dir", "-o", default="weight_plots")
    parser.add_argument("--max_plots", type=int, default=24)
    args = parser.parse_args(argv)
    ckpt = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    state = ckpt.get("state_dict", ckpt)
    os.makedirs(args.out_dir, exist_ok=True)
    count = 0
    for key, value in state.items():
        if count >= args.max_plots:
            break
        if value.dim() < 2:
            continue
        mat = value.detach().float().reshape(value.shape[0], -1).numpy()
        fig, ax = plt.subplots()
        im = ax.imshow(mat, aspect="auto", cmap="RdBu_r")
        fig.colorbar(im, ax=ax)
        ax.set_title(key)
        name = key.replace(".", "_") + ".png"
        fig.savefig(os.path.join(args.out_dir, name))
        plt.close(fig)
        print("wrote", name)
        count += 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
