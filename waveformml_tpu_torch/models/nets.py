"""Model classes registered under the JAX package's config names
(counterpart of waveformml_tpu/models/nets.py).

Each net names its submodules as flax names the JAX net's (the
per-segment nets' stack ``SparseConv2DForZ_0``, ...; ``sparse_model``,
``conv``, ``linear``; a list attribute's items ``waveform_layers_<i>``,
``linear_layers_<i>``), so that ``convert.py`` carries the JAX package's
variables path for path; ``stack`` names the sparse stack whatever its
name. The event classifiers flatten the dense ``[B, C, H, W]`` output in
that order, so that the Linear layers' sizes are the JAX package's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
from math import pow as fpow
from typing import Any, List, Optional, Set, Tuple

import torch
from torch import nn

from waveformml_tpu_torch.config import to_dict
from waveformml_tpu_torch.detector import NX, NY
from waveformml_tpu_torch.models.algorithm import (build_sparse_instances, dsl_to_row_specs,
                                                   split_algorithm)
from waveformml_tpu_torch.models.blocks import (Conv2DBlock, FoldedSiteLinear, LinearBlock,
                                                MaskedArrayBatchNorm, TemporalConvNet)
from waveformml_tpu_torch.models.sparse_blocks import (DSLSpecNet, ExtractedFeatureConv,
                                                       Pointwise2DForZ, SparseConv2DBlock,
                                                       SparseConv2DForEZ, SparseConv2DForZ,
                                                       SparseConv2DPreserve, _SpecNet)
from waveformml_tpu_torch.ops.sparse import (SparseBatch, gather_from_dense, occupancy_mask,
                                             scatter_to_dense)
from waveformml_tpu_torch.ops.sparse_conv import (SparseGrid, SparseSequential, batch_to_grid,
                                                  batch_to_grid_3d)
from waveformml_tpu_torch.registry import registry

log = logging.getLogger(__name__)


@registry.register("SubMPSDNet", aliases=("SPConvNet.SubMPSDNet",))
class SubMPSDNet(nn.Module):
    """Event classifier over a pure-SubM sparse stack: the version-2
    ``SparseConv2DForEZ`` row stack, then ``Linear(flatten([B, C, NX, NY]))``
    folded over the active sites (``FoldedSiteLinear``), then a
    ``LinearBlock`` with the same plane schedule as the JAX model."""

    def __init__(self, config: Any, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        sc = config.system_config
        hp = config.net_config.hparams
        out_planes = getattr(hp, "out_planes", 8)
        params = to_dict(getattr(hp, "conv_params", None) or {})
        params.setdefault("version", 2)
        self.stack = SparseConv2DForEZ(sc.n_samples * 2, out_planes=out_planes,
                                       generator=generator, device=device, **params)
        flat = out_planes * NX * NY
        n_lin = getattr(hp, "n_lin", 2)
        factor = fpow(float(sc.n_type) / flat, 1.0 / n_lin)
        planes = [int(round(flat * fpow(factor, i + 1))) for i in range(n_lin)]
        self.head0 = FoldedSiteLinear(out_planes, planes[0], generator, device)
        self.linear = (LinearBlock(planes[0], sc.n_type, n_lin - 1, generator, device)
                       if n_lin > 1 else None)

    def plan_requirements(self) -> Set[str]:
        """Host-built plans a batch must carry: the stack's neighbour plans
        and the head's site layout."""
        return self.stack.plan_requirements() | {"site"}

    def forward(self, batch: SparseBatch) -> torch.Tensor:
        rows = self.stack(batch, return_rows=True)      # [N, C]
        x = self.head0(rows, batch)          # [B, planes[0]]
        if self.linear is not None:
            x = self.linear(x)
        return x


class _OneStackNet(nn.Module):
    """A net whose parameters are one ``_SpecNet``, registered under the
    flax name of the JAX net's child: ``<class name>_0``."""

    def _set_stack(self, stack: _SpecNet) -> None:
        self._stack_name = f"{type(stack).__name__}_0"
        self.add_module(self._stack_name, stack)

    @property
    def stack(self) -> _SpecNet:
        return getattr(self, self._stack_name)

    def plan_requirements(self) -> Set[str]:
        """The neighbour plans of the stack's row convs."""
        return self.stack.plan_requirements()


@registry.register("SPConvPreserveNet", aliases=("SPConvNet.SPConvPreserveNet",))
class SPConvPreserveNet(_OneStackNet):
    """Site-preserving sparse net giving per-row features ``[N, n_type]``:
    the ``SparseConv2DPreserve`` stack's grid, read back at the batch's
    rows (two rows at one site both read the sum of their outputs)."""

    def __init__(self, config: Any, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        sc = config.system_config
        hp = config.net_config.hparams
        self._set_stack(SparseConv2DPreserve(sc.n_samples * 2, sc.n_type, hp.n_conv,
                                             generator=generator, device=device,
                                             **to_dict(hp.conv_params)))

    def forward(self, batch: SparseBatch) -> torch.Tensor:
        out = self.stack(batch)
        return gather_from_dense(out.features.permute(0, 2, 3, 1), batch)


def _input_planes(config) -> Tuple[int, Optional[int]]:
    """The per-segment nets' input width by the schedule (the samples of
    both PMTs, or one row of features for ``algorithm: features``), and
    the width a grid stack is really given where ``UseFFT`` turns the
    features into their spectrum (real ‖ imaginary parts, 2 more)."""
    nc = config.net_config
    ns = config.system_config.n_samples
    n_in = ns if getattr(nc, "algorithm", "conv") == "features" else ns * 2
    return n_in, (n_in + 2 if getattr(nc, "UseFFT", False) else None)


@registry.register("SingleEndedZConv", aliases=("SingleEndedZConv.SingleEndedZConv",))
class SingleEndedZConv(_OneStackNet):
    """Per-segment Z regressor giving the dense ``[B, 1, NX, NY]`` map:
    ``algorithm`` "conv" or "features" with ``SparseConv2DForZ`` at version
    0 (regular sparse convs on the grid) or ``SparseConv2DForEZ`` with one
    output plane at version >= 1 (its SubM versions run the row path),
    "point" with ``Pointwise2DForZ``."""

    def __init__(self, config: Any, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        nc = config.net_config
        algorithm = getattr(nc, "algorithm", "conv")
        version = getattr(nc, "version", 0)
        n_in, in_width = _input_planes(config)
        kw = dict(generator=generator, device=device, in_width=in_width)
        if algorithm in ("conv", "features"):
            if version == 0:
                stack = SparseConv2DForZ(n_in, **to_dict(nc.hparams.conv), **kw)
            else:
                stack = SparseConv2DForEZ(n_in, out_planes=1, **to_dict(nc.hparams), **kw)
        elif algorithm == "point":
            stack = Pointwise2DForZ(n_in, **to_dict(nc.hparams.point), **kw)
        else:
            raise IOError(f"unknown algorithm {algorithm}")
        self._set_stack(stack)

    def forward(self, batch: SparseBatch) -> torch.Tensor:
        return self.stack(batch)


@registry.register("SingleEndedEZConv", aliases=("SingleEndedEZConv.SingleEndedEZConv",))
class SingleEndedEZConv(_OneStackNet):
    """(E, Z) per-segment regressor giving ``[B, 2, NX, NY]``: a
    ``SparseConv2DForEZ`` stack of two output planes, or of one beside the
    output of a frozen Z model (``z_model``, a module in eval mode whose
    parameters are not this net's: it is not registered as a submodule,
    so it is in neither ``parameters()`` nor ``state_dict()``), concatenated
    with no gradient."""

    def __init__(self, config: Any, z_model: Optional[nn.Module] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        nc = config.net_config
        n_in, in_width = _input_planes(config)
        self._z_model = (z_model,) if z_model is not None else ()
        self._set_stack(SparseConv2DForEZ(n_in, out_planes=1 if z_model is not None else 2,
                                          generator=generator, device=device,
                                          in_width=in_width, **to_dict(nc.hparams)))

    def plan_requirements(self) -> Set[str]:
        """The stack's neighbour plans and the frozen Z model's."""
        reqs = self.stack.plan_requirements()
        for z in self._z_model:
            reqs |= z.plan_requirements()
        return reqs

    def forward(self, batch: SparseBatch) -> torch.Tensor:
        x = self.stack(batch)
        for z_model in self._z_model:
            with torch.no_grad():
                z = z_model(batch)
            x = torch.cat([x, z.to(x.dtype)], dim=1)
        return x


# the waveform section's BatchNorm over the real rows only: a plain one would
# fold the bucket's padding rows into its training statistics
_WAVEFORM_TRANSLATIONS = {
    "nn.BatchNorm1d": lambda c, *a, **k: MaskedArrayBatchNorm(c),
    "BatchNorm1d": lambda c, *a, **k: MaskedArrayBatchNorm(c),
}


@contextlib.contextmanager
def _seeded_init(generator: Optional[torch.Generator]):
    """Inside the block, PyTorch's global random stream is seeded from
    ``generator`` (and put back after it), so that layers the DSL builds
    without a generator of their own initialise reproducibly."""
    if generator is None:
        yield
        return
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        yield


class _LayerListNet(nn.Module):
    """A net with the JAX net's list attributes: ``waveform_layers_<i>``
    and ``linear_layers_<i>``, each layer called as ``layer(x,
    generator)``."""

    def _set_layers(self, name: str, layers: List[nn.Module]) -> None:
        setattr(self, f"_n_{name}", len(layers))
        for i, layer in enumerate(layers):
            self.add_module(f"{name}_{i}", layer)

    def _layers(self, name: str) -> List[nn.Module]:
        return [getattr(self, f"{name}_{i}") for i in range(getattr(self, f"_n_{name}", 0))]

    def _linear(self, x: torch.Tensor, generator) -> torch.Tensor:
        for layer in self._layers("linear_layers"):
            x = layer(x, generator)
        return x

    def _waveform_dsl(self, feats: torch.Tensor, batch: SparseBatch) -> torch.Tensor:
        """The DSL's waveform section per row: ``[N, 2S]`` as ``[N, 2, S]``
        (two channels of S samples), through the layers (the masked
        BatchNorm over the real rows), flattened back in (C, L) order."""
        n = feats.shape[0]
        x = feats.reshape(n, 2, self.n_samples)
        for layer in self._layers("waveform_layers"):
            if isinstance(layer, MaskedArrayBatchNorm):
                x = layer(x, batch.mask)
            else:
                x = layer(x, batch.generator)
        return x.reshape(n, -1)

    def _dsl_sections(self, algorithm):
        """The waveform and linear sections of a DSL list built into
        ``waveform_layers_<i>`` and ``linear_layers_<i>``; returns the
        sparse section and the head's input width."""
        wf, sparse, linear = split_algorithm(algorithm)
        if wf:
            self._set_layers("waveform_layers", registry.create_class_instances(
                list(wf), translations=_WAVEFORM_TRANSLATIONS))
        self._set_layers("linear_layers", registry.create_class_instances(list(linear)))
        return sparse, linear[1][0]


@registry.register("BasicNetwork", aliases=("BasicNetwork.BasicNetwork",))
class BasicNetwork(nn.Module):
    """The config-holding base model: gives the batch's features as they
    are."""

    def __init__(self, config: Any, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.config = config

    def plan_requirements(self) -> Set[str]:
        return set()

    def forward(self, batch):
        return batch.feats if isinstance(batch, SparseBatch) else batch


@registry.register("SPConvNet", aliases=("SPConvNet.SPConvNet",))
class SPConvNet(_LayerListNet):
    """Sparse-conv event classifier: an optional waveform section, a
    sparse stack on the grid, the flatten and a linear head. From
    ``hparams``: a causal TCN over both PMTs' samples (``n_dil`` > 0),
    ``SparseConv2DBlock`` and a ``LinearBlock``; from ``algorithm``: the
    DSL's three sections (the sparse one a ``SparseSequential`` on the
    grid, SubM convs too)."""

    def __init__(self, config: Any, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        nc, sc = config.net_config, config.system_config
        self.n_samples = sc.n_samples
        self.tcn = False
        if not hasattr(nc, "algorithm"):
            if not hasattr(nc, "hparams"):
                raise IOError("net_config must contain one of 'algorithm' or 'hparams'")
            self._from_hparams(nc.hparams, sc.n_type, generator, device)
        else:
            with _seeded_init(generator):
                sparse, self.n_linear = self._dsl_sections(nc.algorithm)
                self.sparse_model = SparseSequential(build_sparse_instances(sparse))
            self.to(device)

    def _from_hparams(self, hparams, n_classes, generator, device) -> None:
        size = [NX, NY, int(self.n_samples * 2)]
        for rq in ("n_dil", "n_conv", "n_lin", "out_planes"):
            if not hasattr(hparams, rq):
                raise IOError(rq + " is required to create the sparse conv algorithm.")
        wf_params = to_dict(getattr(hparams, "wf_params", None) or {})
        conv_params = to_dict(getattr(hparams, "conv_params", None) or {})
        if hparams.n_dil > 0:
            self._set_layers("waveform_layers", [TemporalConvNet(
                1, [1] * hparams.n_dil, generator=generator, device=device, **wf_params)])
            self.tcn = True
        self.sparse_model = SparseConv2DBlock(size[2], hparams.out_planes, hparams.n_conv,
                                              tuple(size), True, generator=generator,
                                              device=device, **conv_params)
        out_size = SparseConv2DBlock.out_size(self.sparse_model.specs, size)
        flat = out_size[0] * out_size[1] * out_size[2]
        self.n_linear = flat
        log.debug("Flattened size of the sparse network output is %s", flat)
        self._set_layers("linear_layers", [LinearBlock(flat, n_classes, hparams.n_lin,
                                                       generator, device)])

    @property
    def stack(self) -> nn.Module:
        return self.sparse_model

    def plan_requirements(self) -> Set[str]:
        """None: the stack runs on the grid."""
        return set()

    def _waveform(self, batch: SparseBatch) -> torch.Tensor:
        if not self.tcn:
            return self._waveform_dsl(batch.feats, batch)
        # the TCN: one input channel of both PMTs' 2S samples, causal across
        # them; flattened in the JAX package's [N, L, C] order
        n = batch.feats.shape[0]
        x = batch.feats[:, None, :]
        for layer in self._layers("waveform_layers"):
            x = layer(x, batch.generator)
        return x.transpose(1, 2).reshape(n, -1)

    def forward(self, batch: SparseBatch) -> torch.Tensor:
        if self._layers("waveform_layers"):
            batch = dataclasses.replace(batch, feats=self._waveform(batch))
        if isinstance(self.sparse_model, SparseSequential):
            x = self.sparse_model(batch_to_grid(batch), batch.generator)
        else:
            x = self.sparse_model(batch)
        x = x.reshape(batch.n_events, -1)
        return self._linear(x, batch.generator)


@registry.register("SCNet", aliases=("SCNet.SCNet",))
class SCNet(_LayerListNet):
    """The algorithm-DSL net: an optional waveform section, the sparse
    section, the flatten (channels first) and the linear section. A
    pure-SubM 2D sparse section runs in row space (``DSLSpecNet``: K1 in
    the forward, K1 and K4 in the backward); any other on the grid
    (``SparseSequential``). ``net_type: "3DConvolution"`` (coords ``[N,
    4]``: x, y, t, event) runs its sparse section on the ``[B, C, NX, NY,
    T]`` grid of T = ``n_samples``, as the JAX package does (its 3D row
    path is ``DSLSpecNet(n_t=…)``)."""

    def __init__(self, config: Any, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        nc = config.net_config
        self.n_samples = config.system_config.n_samples
        net_type = getattr(nc, "net_type", "2DConvolution")
        if net_type not in ("2DConvolution", "3DConvolution"):
            log.warning("unknown net_type in net_config: %s", net_type)
        self.ndim = 3 if net_type == "3DConvolution" else 2
        with _seeded_init(generator):
            sparse, self.n_linear = self._dsl_sections(nc.algorithm)
            row_specs = dsl_to_row_specs(sparse) if self.ndim == 2 else None
            self.row_path = row_specs is not None
            self.sparse_model = (DSLSpecNet(row_specs) if self.row_path
                                 else SparseSequential(build_sparse_instances(sparse)))
        self.to(device)

    @property
    def stack(self) -> nn.Module:
        return self.sparse_model

    def plan_requirements(self) -> Set[str]:
        """The row stack's neighbour plans (none on the grid)."""
        return self.sparse_model.plan_requirements() if self.row_path else set()

    def forward(self, batch: SparseBatch) -> torch.Tensor:
        if self._layers("waveform_layers"):
            batch = dataclasses.replace(batch, feats=self._waveform_dsl(batch.feats, batch))
        if self.row_path:
            x = self.sparse_model(batch)
        elif self.ndim == 3:
            x = self.sparse_model(batch_to_grid_3d(batch, self.n_samples), batch.generator)
        else:
            x = self.sparse_model(batch_to_grid(batch), batch.generator)
        if isinstance(x, SparseGrid):
            x = x.masked()
        # channels first, whatever the rank
        return self._linear(x.reshape(batch.n_events, -1), batch.generator)


@registry.register("DenseConvNet", aliases=("DenseConvNet.DenseConvNet",))
class DenseConvNet(nn.Module):
    """Dense baseline: the batch scattered to the dense grid, a
    ``Conv2DBlock`` (BatchNorm statistics over the real events), the
    (C, H, W) flatten and a ``LinearBlock``."""

    def __init__(self, config: Any, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        sc, hp = config.system_config, config.net_config.hparams
        size = [NX, NY, int(sc.n_samples * 2)]
        for rq in ("n_conv", "n_lin", "out_planes"):
            if not hasattr(hp, rq):
                raise IOError(rq + " is required to create the conv algorithm.")
        conv_params = to_dict(getattr(hp, "conv_params", None) or {})
        self.conv = Conv2DBlock(size[2], hp.out_planes, hp.n_conv, tuple(size),
                                generator=generator, device=device, **conv_params)
        out_size = self.conv.out_size()
        flat = out_size[0] * out_size[1] * out_size[2]
        self.n_linear = flat
        self.linear = LinearBlock(flat, sc.n_type, hp.n_lin, generator, device)

    def plan_requirements(self) -> Set[str]:
        return set()

    def forward(self, batch: SparseBatch) -> torch.Tensor:
        dense = scatter_to_dense(batch).permute(0, 3, 1, 2)
        # padding events hold no site: they stay out of the BatchNorm statistics
        ev_mask = occupancy_mask(batch).any(dim=2).any(dim=1)
        x = self.conv(dense, ev_mask, batch.generator)
        return self.linear(x.reshape(batch.n_events, -1))


@registry.register("ExtractedFeatureConvNet",
                   aliases=("ExtractedFeatureConvNet.ExtractedFeatureConvNet",))
class ExtractedFeatureConvNet(nn.Module):
    """Regular sparse convs over per-segment extracted features
    (``system_config.n_features`` a row) and a ``LinearBlock``."""

    def __init__(self, config: Any, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        sc, hp = config.system_config, config.net_config.hparams
        nfeatures = sc.n_features
        params = to_dict(hp.conv)
        self.model = ExtractedFeatureConv(nfeatures, hp.out_planes, hp.n_conv,
                                          (NX, NY, nfeatures), generator=generator,
                                          device=device, **params)
        out_size = SparseConv2DBlock.out_size(self.model.specs, (NX, NY, nfeatures))
        flat = out_size[0] * out_size[1] * out_size[2]
        self.n_linear = flat
        self.linear = LinearBlock(flat, sc.n_type, hp.n_lin, generator, device)

    def plan_requirements(self) -> Set[str]:
        return set()

    def forward(self, batch: SparseBatch) -> torch.Tensor:
        x = self.model(batch)
        return self.linear(x.reshape(batch.n_events, -1))
