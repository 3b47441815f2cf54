"""Recurrent blocks (counterpart of waveformml_tpu/models/recurrent_blocks.py)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from waveformml_tpu_torch.models.blocks import LinearBlock
from waveformml_tpu_torch.nn.layers import RecurrentStack


class RecurrentBlock(RecurrentStack):
    """torch ``nn.RNN(input_size, hidden, n_layers, nonlinearity,
    dropout, batch_first=True)`` on ``[B, L, C]``: simple cells, ReLU by
    default."""

    def __init__(self, input_size: int, hidden_size: int, n_layers: int,
                 nonlinearity: str = "relu", dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(input_size, hidden_size, n_layers, nonlinearity, dropout,
                         generator, device)


class RecurrentNet(nn.Module):
    """``rnn_block`` over ``[B, L, C]``, its outputs flattened in (L, H)
    order, then a ``LinearBlock`` ``linear`` from ``hidden·seq_len`` to
    ``out_size`` over ``n_lin`` layers; without one (``n_lin`` 0, and
    ``out_size`` 1) the last step's outputs ``[B, H]``."""

    def __init__(self, seq_len: int, input_size: int, hidden_size: int, n_layers: int,
                 n_lin: int, out_size: int, nonlinearity: str = "relu", dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if n_lin <= 0 and out_size != 1:
            raise IOError("must have n_lin > 0 if out_size is > 1")
        self.rnn_block = RecurrentBlock(input_size, hidden_size, n_layers, nonlinearity,
                                        dropout, generator, device)
        self.linear = (LinearBlock(hidden_size * seq_len, out_size, n_lin, generator, device)
                       if n_lin > 0 else None)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        out = self.rnn_block(x, generator)
        if self.linear is None:
            return out[:, -1]
        return self.linear(out.reshape(out.shape[0], -1))
