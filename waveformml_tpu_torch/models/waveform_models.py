"""Per-waveform networks (counterpart of waveformml_tpu/models/waveform_models.py).

Each net takes ``[N, S]`` single waveforms (``[N, S + 3]`` where
``LitWaveform`` appends the detector coordinates) and runs its convs in
PyTorch's channels-first ``[N, C, L]``; flattens are in (C, L) order, as
the JAX package's, so that the Linear layers' sizes are its own. Each net
names its submodules as flax names the JAX net's (``model``, ``linear``,
``net``), for ``convert.py``.
"""
from __future__ import annotations

import logging
from math import floor
from typing import Any, Optional, Set

import torch
from torch import nn

from waveformml_tpu_torch.config import to_dict
from waveformml_tpu_torch.models.blocks import (Conv1DNet, LinearBlock, LinearPlanes,
                                                TemporalConvNet)
from waveformml_tpu_torch.models.recurrent_blocks import RecurrentNet
from waveformml_tpu_torch.registry import registry

log = logging.getLogger(__name__)


class _WaveformNet(nn.Module):
    """A net over the rows' features alone: no plan, no site layout."""

    def plan_requirements(self) -> Set[str]:
        return set()


@registry.register("TemporalWaveformNet", aliases=("WaveformModels.TemporalWaveformNet",))
class TemporalWaveformNet(_WaveformNet):
    """The weight-normed causal TCN over the samples (one input channel),
    then, with ``n_lin`` > 0, a ``LinearBlock`` over its (C, L) flatten."""

    def __init__(self, config: Any, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        hp = config.net_config.hparams
        nsamples = config.system_config.n_samples
        output_size = getattr(hp, "out_size", 1)
        expand_factor = float(hp.expansion_factor / hp.n_expand)
        planes = [int(round(expand_factor * (i + 1))) for i in range(hp.n_expand)]
        contract_factor = float((hp.expansion_factor - hp.out_planes) / hp.n_contract)
        planes += [int(round(contract_factor * (hp.n_contract - i - 1)))
                   for i in range(hp.n_contract)]
        planes[-1] = hp.out_planes
        if min(planes) < 1:
            # the formula can give 0-channel levels for small expansion
            # factors; the JAX package clamps them to 1 channel
            log.warning("TCN plane schedule %s contains empty levels; clamping to 1", planes)
            planes = [max(1, p) for p in planes]
        self.planes = planes
        self.model = TemporalConvNet(1, planes, generator=generator, device=device,
                                     **to_dict(hp.conv_params))
        self.linear = (LinearBlock(nsamples * planes[-1], output_size, hp.n_lin, generator,
                                   device) if hp.n_lin > 0 else None)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        h = self.model(x[:, None, :] if x.dim() == 2 else x, generator)
        if self.linear is not None:
            h = self.linear(h.reshape(h.shape[0], -1))
        return h


@registry.register("LinearWaveformNet", aliases=("WaveformModels.LinearWaveformNet",))
class LinearWaveformNet(_WaveformNet):
    """An MLP over the raw samples: ``LinearPlanes`` (ReLU after each
    layer) through the expand/contract planes where ``n_expand`` > 0, else
    a ``LinearBlock`` of ``n_lin`` layers; under ``net``."""

    def __init__(self, config: Any, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        hp = config.net_config.hparams
        nsamples = config.system_config.n_samples
        out_size = getattr(hp, "out_size", 1)
        planes = [nsamples]
        if getattr(hp, "n_expand", 0) > 0:
            if not hasattr(hp, "expansion_factor"):
                raise IOError("hparams.expansion_factor must be set if n_expand > 0")
            expand = float((planes[0] * hp.expansion_factor - planes[0]) / hp.n_expand)
            planes += [int(round(planes[0] + expand * (i + 1))) for i in range(hp.n_expand)]
            n_contract = getattr(hp, "n_contract", None)
            if n_contract is None:
                if hasattr(hp, "n_lin"):
                    n_contract = hp.n_lin - hp.n_expand
                else:
                    raise IOError("if n_expand is set, must either set n_contract or n_lin")
            contract = float((planes[-1] - out_size) / n_contract)
            start_n = planes[-1]
            planes += [int(round(start_n - contract * (i + 1))) for i in range(n_contract)]
            planes[-1] = out_size
        if len(planes) == 1:
            if not hasattr(hp, "n_lin"):
                raise IOError("hparams.n_lin must be >= 1 if n_expand/n_contract unset")
            self.net = LinearBlock(nsamples, out_size, hp.n_lin, generator, device)
        else:
            self.net = LinearPlanes(planes, torch.relu, generator, device)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return self.net(x)


@registry.register("RecurrentWaveformNet", aliases=("WaveformModels.RecurrentWaveformNet",))
class RecurrentWaveformNet(_WaveformNet):
    """A ``RecurrentNet`` over the samples (one input feature a step)."""

    def __init__(self, config: Any, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        hp = config.net_config.hparams
        nsamples = config.system_config.n_samples
        if config.net_config.net_type != "RNN":
            raise IOError(f"{config.net_config.net_type} not supported net type")
        self.model = RecurrentNet(nsamples, 1, hp.n_hidden, hp.n_layers, hp.n_lin,
                                  hp.out_size, generator=generator, device=device,
                                  **to_dict(getattr(hp, "rnn_params", None) or {}))

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return self.model(x[..., None] if x.dim() == 2 else x, generator)


@registry.register("ConvWaveformNet", aliases=("WaveformModels.ConvWaveformNet",))
class ConvWaveformNet(_WaveformNet):
    """A ``Conv1DNet`` over the samples (one input channel; its BatchNorm
    given no mask, as the JAX net gives it none), then, where ``hparams``
    has ``n_lin``, ``LinearPlanes`` (ReLU after each layer) over its (C, L)
    flatten, the detector coordinates appended to it under
    ``use_detector_number`` (the last 3 features of a row)."""

    def __init__(self, config: Any, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        hp = config.net_config.hparams
        nc = config.net_config
        self.nsamples = config.system_config.n_samples
        self.use_detector_number = bool(getattr(nc, "use_detector_number", False))
        num_inputs = self.nsamples - 3 if self.use_detector_number else self.nsamples
        if nc.net_type != "CNN":
            raise IOError(f"{nc.net_type} not supported net type")
        self.model = Conv1DNet(num_inputs, generator=generator, device=device, in_width=1,
                               **to_dict(hp.cnn_params))
        self.linear = None
        if hasattr(hp, "n_lin"):
            out_len, out_ch = self.model.out_shape()
            out = out_len * out_ch + (3 if self.use_detector_number else 0)
            lin_planes = [int(floor(out - i * ((out - hp.out_size) / hp.n_lin)))
                          for i in range(hp.n_lin + 1)]
            self.linear = LinearPlanes(lin_planes, torch.relu, generator, device)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        det = None
        if self.use_detector_number:
            det = x[:, self.nsamples - 3:]
            x = x[:, :self.nsamples - 3]
        h = self.model(x[:, None, :], generator=generator)
        if self.linear is not None:
            h = h.reshape(h.shape[0], -1)
            if det is not None:
                h = torch.cat([h, det], dim=1)
            h = self.linear(h)
        return h
