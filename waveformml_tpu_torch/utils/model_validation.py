"""Static shape validation of the config ``algorithm`` DSL (counterpart of
waveformml_tpu/utils/model_validation.py, pure Python).

Propagates (14, 11, 2·n_samples) [2D] or (14, 11, n_samples, 2) [3D]
through the conv output-size formula o = ⌊(i + 2p − k − (k−1)(d−1))/s⌋ + 1,
pooling's o = ⌊(i − k)/s⌋ + 1 and the flatten, raising ``IOError`` on a
channel or shape mismatch before any parameter is made.

Unlike the JAX package's, it flattens at ``ToDense`` as the nets do
(``SCNet`` and ``SPConvNet`` flatten its ``[B, C, *S]`` output before the
head), so that a head right after it, as in ``OPs3ns_SCNet.json`` and
``SCNet3D.json``, takes the flattened width; the JAX package's keeps the
channel width there and rejects those configs.
"""
from __future__ import annotations

from typing import Any, Dict, List, Union

from waveformml_tpu_torch.detector import NX as DIMX, NY as DIMY

DIM = "DIMENSION"
NIN = "N_INPUT_CHANNELS"
NOUT = "N_OUTPUT_CHANNELS"
FS = "FILTER_SIZE"
STR = "FILTER_STRIDE"
PAD = "FILTER_PADDING"
DIL = "FILTER_DILATION"

# positional-arg meaning per layer class
alg_map: Dict[str, List[str]] = {
    "sparseconvnet.Convolution": [DIM, NIN, NOUT, FS, STR],
    "sparseconvnet.FullConvolution": [DIM, NIN, NOUT, FS, STR],
    "sparseconvnet.SubmanifoldConvolution": [DIM, NIN, NOUT, FS],
    "nn.Linear": [NIN, NOUT],
    "nn.Conv1d": [NIN, NOUT, FS, STR, PAD, DIL],
    "nn.Conv2d": [NIN, NOUT, FS, STR, PAD, DIL],
    "nn.Conv3d": [NIN, NOUT, FS, STR, PAD, DIL],
    "nn.Conv4d": [NIN, NOUT, FS, STR, PAD, DIL],
    "spconv.SparseConv1d": [NIN, NOUT, FS, STR, PAD, DIL],
    "spconv.SparseConv2d": [NIN, NOUT, FS, STR, PAD, DIL],
    "spconv.SparseConv3d": [NIN, NOUT, FS, STR, PAD, DIL],
    "spconv.SparseConv4d": [NIN, NOUT, FS, STR, PAD, DIL],
    "spconv.SubMConv2d": [NIN, NOUT, FS, STR, PAD, DIL],
    "spconv.SubMConv3d": [NIN, NOUT, FS, STR, PAD, DIL],
    "spconv.SparseConvTranspose2d": [NIN, NOUT, FS, STR, PAD, DIL],
    "spconv.SparseConvTranspose3d": [NIN, NOUT, FS, STR, PAD, DIL],
}
type_map = {
    "convolution": [DIM, NIN, NOUT, FS, STR, PAD, DIL],
    "linear": [NIN, NOUT],
}


class ModelValidation:
    """Shape-checks an ``algorithm`` layer list against the dataset geometry."""

    @staticmethod
    def validate(config) -> None:
        if not hasattr(config.net_config, "algorithm"):
            return
        if not isinstance(config.net_config.algorithm, (list, tuple)):
            return  # hparams-style string selector, not a DSL list
        dimt = config.system_config.n_samples
        net_type = config.net_config.net_type
        if net_type == "2DConvolution":
            current_dim: List[Union[int, float]] = [DIMX, DIMY, dimt * 2]
        elif net_type == "3DConvolution":
            current_dim = [DIMX, DIMY, dimt, 2]
        else:
            raise IOError(f"model validation not configured for net type {net_type}")
        current_alg, prev_alg = "", ""
        for alg in config.net_config.algorithm:
            if isinstance(alg, str):
                prev_alg, current_alg = current_alg, alg
                if ModelValidation._get_type(alg) == "todense":
                    # the nets flatten ToDense's [B, C, *S] before the head
                    newdim = 1
                    for d in current_dim:
                        newdim *= d
                    current_dim = [newdim]
            elif isinstance(alg, (list, tuple)):
                algtype = ModelValidation._get_type(current_alg)
                inputs = ModelValidation._parse_function_inputs(current_alg, list(alg), algtype)
                if algtype == "convolution":
                    ndim = ModelValidation._get_conv_dim(current_alg, inputs)
                    current_dim = ModelValidation.calc_output_size(
                        inputs, current_dim, current_alg, prev_alg, ndim)
                elif algtype == "pooling":
                    # nn.MaxPoolNd/AvgPoolNd(kernel_size, stride=kernel_size):
                    # downsample the spatial axes, o = ⌊(i − k)/s⌋ + 1 —
                    # skipping these leaves current_dim un-pooled and the
                    # flatten/linear check below spuriously rejects the config
                    nd = ModelValidation._get_conv_dim(current_alg, list(alg))
                    k = alg[0] if len(alg) > 0 else 1
                    s = alg[1] if len(alg) > 1 and alg[1] else k
                    ks = list(k) if isinstance(k, (list, tuple)) else [k] * nd
                    ss = list(s) if isinstance(s, (list, tuple)) else [s] * nd
                    if nd == 1 and len(current_dim) == 3:
                        # 1D pool over per-site channel data (matches the 1D
                        # conv path above): pool the trailing axis
                        current_dim = [current_dim[0], current_dim[1],
                                       int((current_dim[2] - ks[0]) // ss[0] + 1)]
                    else:
                        for i in range(min(nd, len(current_dim) - 1)):
                            current_dim[i] = int(
                                (current_dim[i] - ks[i]) // ss[i] + 1)
                elif algtype in ("flatten", "todense"):
                    newdim = 1
                    for d in current_dim:
                        newdim *= d
                    current_dim = [newdim]
                elif algtype == "linear":
                    if inputs[NIN] != current_dim[-1]:
                        raise IOError(
                            f"Error: dimension mismatch between layer {prev_alg} and "
                            f"{current_alg}. Expecting the input dimensions to be "
                            f"{current_dim[-1]}, got {inputs[NIN]}")
                    current_dim[-1] = inputs[NOUT]

    @staticmethod
    def _parse_function_inputs(current_alg: str, args_list: List[Any], alg_type: str):
        if alg_type not in type_map:
            return args_list
        match = type_map[alg_type]
        output: Dict[str, Any] = {m: 0 for m in match}
        if current_alg in alg_map:
            for i, m in enumerate(match):
                for j, typename in enumerate(alg_map[current_alg]):
                    if typename == m and j < len(args_list):
                        if isinstance(args_list[j], (list, tuple)):
                            output[m] = list(args_list[j])
                        elif i > 2:
                            output[m] = [args_list[j]] * 4
                        else:
                            output[m] = args_list[j]
                        break
        if FS in match and not output[FS]:
            output[FS] = [0] * 4
        if STR in match and not output[STR]:
            output[STR] = [1] * 4
        if PAD in match and not output[PAD]:
            output[PAD] = [0] * 4
        if DIL in match and not output[DIL]:
            # neutral dilation is 1 (torch's default), not [0]*4, whose d=0
            # would make the size formula add (k-1) and reject valid same-convs
            # that omit the dilation argument
            output[DIL] = [1] * 4
        return output

    @staticmethod
    def calc_output_size_1d(current, arg_dict, ind=None):
        """o = (i + 2p − k − (k−1)(d−1))/s + 1."""
        if ind is None:
            return (current + 2 * arg_dict[PAD] - arg_dict[FS]
                    - (arg_dict[FS] - 1) * (arg_dict[DIL] - 1)) / arg_dict[STR] + 1
        return (current[ind] + 2 * arg_dict[PAD][ind] - arg_dict[FS][ind]
                - (arg_dict[FS][ind] - 1) * (arg_dict[DIL][ind] - 1)) / arg_dict[STR][ind] + 1

    @staticmethod
    def calc_output_size(arg_dict, current_dim, ca, pa, ndim):
        if len(current_dim) > 1 and len(current_dim) != ndim + 1:
            if ndim == 1 and len(current_dim) == 3:
                # 1D conv over the per-site channel data
                f = ModelValidation.calc_output_size_1d(current_dim, arg_dict, 2)
                return [current_dim[0], current_dim[1], f]
            raise IOError(
                f"Dataset dimensionality is {len(current_dim) - 1}, network layer "
                f"is for {ndim} dimensional inputs.")
        if current_dim[-1] != arg_dict[NIN]:
            raise IOError(
                f"Error between layers {pa} and {ca}: \nInput feature dimension "
                f"{arg_dict[NIN]} does not match previous output feature dimension "
                f"{current_dim[-1]}.")
        if arg_dict[STR] == 0:
            arg_dict[STR] = 1
        w = ModelValidation.calc_output_size_1d(current_dim, arg_dict, 0)
        if ndim == 1:
            return [int(w), int(arg_dict[NOUT])]
        h = ModelValidation.calc_output_size_1d(current_dim, arg_dict, 1)
        if ndim == 2:
            return [int(w), int(h), int(arg_dict[NOUT])]
        z = ModelValidation.calc_output_size_1d(current_dim, arg_dict, 2)
        if ndim == 3:
            return [int(w), int(h), int(z), int(arg_dict[NOUT])]
        t = ModelValidation.calc_output_size_1d(current_dim, arg_dict, 3)
        if ndim == 4:
            return [int(w), int(h), int(z), int(t), int(arg_dict[NOUT])]
        raise IOError("only 4d or fewer convolutions are supported")

    @staticmethod
    def _get_type(alg: str) -> str:
        if not alg:
            return "none"
        name = alg.lower().split(".")[-1]
        if "conv" in name:
            return "convolution"
        if "todense" in name:
            return "todense"
        if name == "linear":
            return "linear"
        if name == "flatten":
            return "flatten"
        if "pool" in name:
            return "pooling"
        return "other"

    @staticmethod
    def _get_conv_dim(alg: str, inputs) -> int:
        name = alg.split(".")[-1].lower()
        if alg in alg_map and DIM in alg_map[alg]:
            if isinstance(inputs, dict):
                return inputs.get(DIM) or 2
            return inputs[alg_map[alg].index(DIM)]
        for nd in ("1d", "2d", "3d", "4d"):
            if nd in name:
                return int(nd[0])
        return 2
