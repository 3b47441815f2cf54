"""Device time of chosen modules of the program, by module and not by
kernel name: CUDA events recorded on the current stream by hooks that the
benchmark registers on the module objects.

* forward: an event before the module's forward (a forward pre-hook) and
  one after it (a forward hook);
* backward: an event when the gradient reaches the module's output (a hook
  on the output's features) and one each time a gradient of one of its
  parameters is computed (a hook on each parameter); the span runs from
  the first to the last of them. The masking of the module's input, whose
  gradient autograd computes after the parameters', falls outside it.

A span is the stream's time between its two events, so it counts any wait
of the stream inside the module; both cells that read it keep the host
ahead of the card. ``LayerTimer`` is off the CPU (no CUDA events there).
"""
from __future__ import annotations

from typing import List, Optional

import torch


def _features(out):
    """The output tensor of a module: itself, or a grid's ``features``."""
    return out if isinstance(out, torch.Tensor) else getattr(out, "features", None)


class LayerTimer:
    """Forward and backward spans of ``names`` (submodules of ``model``)
    while it is installed."""

    def __init__(self, model: torch.nn.Module, names: List[str]):
        self.forward: List[list] = []
        self.backward: List[list] = []
        self._open_bwd: dict = {}
        self._handles = []
        for name in names:
            module = model.get_submodule(name)
            self._handles.append(module.register_forward_pre_hook(self._pre))
            self._handles.append(module.register_forward_hook(self._post(name)))
            for p in module.parameters():
                if p.requires_grad:
                    self._handles.append(p.register_hook(self._param(name)))

    @staticmethod
    def _event() -> torch.cuda.Event:
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _pre(self, module, args):
        self.forward.append([self._event(), None])

    def _post(self, name):
        def hook(module, args, out):
            self.forward[-1][1] = self._event()
            f = _features(out)
            if f is not None and f.requires_grad:
                def grad_hook(g):
                    span = [self._event(), None]
                    self.backward.append(span)
                    self._open_bwd[name] = span
                f.register_hook(grad_hook)
        return hook

    def _param(self, name):
        def hook(g):
            span = self._open_bwd.get(name)
            if span is not None:
                span[1] = self._event()
        return hook

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []

    def total_ms(self) -> Optional[float]:
        """Milliseconds of every closed span (after a synchronise), or None
        where none was recorded."""
        spans = [s for s in self.forward + self.backward if s[1] is not None]
        if not spans:
            return None
        torch.cuda.synchronize()
        return float(sum(a.elapsed_time(b) for a, b in spans))


def layer_timer(model: torch.nn.Module, names: List[str], device) -> Optional[LayerTimer]:
    """A ``LayerTimer`` on the card; None elsewhere."""
    if torch.device(device).type != "cuda":
        return None
    return LayerTimer(model, names)
