"""Tasks (counterpart of waveformml_tpu/engineering/tasks.py): their
masked loss and metric sums for training and validation, and their
test-time outputs. ``LitPSD`` classifies events; ``LitWaveform``
regresses or classifies single waveforms; ``LitZ`` and ``LitEZ``
regress z, and E and z, per segment through the dense-grid segment loss;
``LitSegClassifier`` and ``LitSegQuantifier`` classify and regress per
row, optionally over the single-ended segments only. ``make_evaluator``
picks each task's evaluator as the JAX task does."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
from waveformml_tpu_torch.detector import NX, NY
from waveformml_tpu_torch.engineering.base import TaskBase
from waveformml_tpu_torch.engineering.se_mask import seg_status_maps
from waveformml_tpu_torch.ops.sparse import bucket_size, pad_sparse
from waveformml_tpu_torch.registry import registry

Metrics = Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]


def _masked_sum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The sum of x over the rows of ``mask`` (x may have more axes)."""
    mask = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device)).sum()


@registry.register("LitPSD", aliases=("src.engineering.LitPSD", "LitPSD.LitPSD"))
class LitPSD(TaskBase):
    """Event classification (pulse-shape discrimination)."""

    def __init__(self, config, device=None, trial=None):
        super().__init__(config, device, trial)
        sc = config.system_config
        self.n_type = getattr(sc, "n_type", None) or len(sc.type_names)

    def loss_and_metrics(self, outputs: torch.Tensor, db: Dict[str, torch.Tensor]
                         ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """Over the real events (``label_mask``): the criterion's sum, its
        'mean' denominator (the event count, or the sum of the events' class
        weights for a class-weighted criterion), and the sums of correct
        predictions, of events and the confusion matrix (rows target,
        columns prediction)."""
        labels = db["labels"].long()
        ymask = db["label_mask"]
        elem = self.criterion.elementwise(outputs, labels)
        loss_sum = elem.masked_fill(~ymask, 0).sum()
        den = self.criterion.mean_denominator(labels)
        count = ymask.sum().float()
        weight = count if den is None else den.masked_fill(~ymask, 0).sum()
        pred = torch.argmax(outputs, dim=-1)
        correct = ((pred == labels) & ymask).sum().float()
        onehot_t = F.one_hot(labels, self.n_type).float() * ymask[:, None]
        onehot_p = F.one_hot(pred, self.n_type).float()
        return loss_sum, weight, {"accuracy_sum": correct, "accuracy_count": count,
                                  "confusion": onehot_t.t() @ onehot_p}

    def test_outputs(self, outputs: torch.Tensor,
                     db: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"logits": outputs,
                "pred": torch.argmax(outputs, dim=-1),
                "logprob": torch.log_softmax(outputs, dim=-1)}

    def make_evaluator(self, logger=None):
        """``PhysEvaluator`` over the phys-feature datasets, else
        ``PSDEvaluator`` (ref: LitPSD.py:35-46)."""
        from waveformml_tpu_torch.evaluation.psd_eval import PhysEvaluator, PSDEvaluator

        dc = self.config.dataset_config
        cls = (PhysEvaluator if dc.dataset_class in (
            "PulseDatasetDet", "PulseDatasetDetWithZ", "PulseDatasetDetWithEZ")
            else PSDEvaluator)
        return cls(list(self.config.system_config.type_names), logger,
                   calgroup=getattr(dc, "calgroup", None), **self._eval_params())


@registry.register("LitWaveform", aliases=("src.engineering.LitWaveform.LitWaveform",
                                           "LitWaveform.LitWaveform"))
class LitWaveform(TaskBase):
    """Single-waveform regression or classification: each row is a
    waveform and its own event (coords ``[N]``, its detector channel id),
    its label per row; the model takes the rows' features alone
    (``forward_model``), one output a row.

    Under ``net_config.use_detector_number`` the config's ``n_samples``
    grows by 3, once per config, and ``prepare_block`` appends each row's
    normalised (x, y, side) detector coordinates to its features. Labels
    of more than one column are read at ``dataset_params.label_index``."""

    labels_per_row = True
    output_unit = "row"

    def __init__(self, config, device=None, trial=None):
        nc = config.net_config
        self.use_detector_number = bool(getattr(nc, "use_detector_number", False))
        if self.use_detector_number:
            if not hasattr(nc, "num_detectors"):
                raise IOError("net config must contain 'num_detectors' if "
                              "'use_detector_number' set to true")
            # the reference grows n_samples on every task built from the
            # config; grown once here, as the JAX package does, so that a
            # second task of one config keeps the model's geometry
            if not getattr(config.system_config, "_det_coords_applied", False):
                config.system_config.n_samples = config.system_config.n_samples + 3
                config.system_config["_det_coords_applied"] = True
            if nc.num_detectors != 308:
                raise IOError(f"num detectors {nc.num_detectors} not supported")
        super().__init__(config, device, trial)
        dc = config.dataset_config
        self.target_index = (getattr(dc.dataset_params, "label_index", None)
                             if hasattr(dc, "dataset_params") else None)
        cc = nc.criterion_class
        self.use_accuracy = cc.startswith("BCE") or cc.startswith("CrossEntropy")

    def n_events(self, block: FileBlock) -> int:
        return max(1, block.coords.shape[0])

    def event_bucket(self, block: FileBlock) -> int:
        # the labels are per row
        return self.row_bucket(block)

    def prepare_block(self, block: FileBlock, row_bucket: int,
                      event_bucket: int) -> Dict[str, np.ndarray]:
        """The rows padded to the row bucket: ``det`` (each row's detector
        channel id), ``feats`` (with the detector coordinates under
        ``use_detector_number``), ``mask``, ``labels`` and ``label_mask``
        (the mask)."""
        n = block.coords.shape[0]
        dets = block.coords.reshape(n, -1)[:, 0].astype(np.int32)
        feats = block.feats
        if self.use_detector_number:
            seg = dets // 2
            coords = np.stack([(seg % NX) * (1.0 / (NX - 1)), (seg // NX) * (1.0 / (NY - 1)),
                               (dets % 2).astype(np.float32)], axis=1).astype(feats.dtype)
            feats = np.concatenate([feats, coords], axis=1)
        out_feats = np.zeros((row_bucket, feats.shape[1]), dtype=feats.dtype)
        out_feats[:n] = feats
        out_det = np.zeros((row_bucket,), dtype=np.int32)
        out_det[:n] = dets
        mask = np.zeros((row_bucket,), dtype=bool)
        mask[:n] = True
        labels = block.labels
        y = np.zeros((row_bucket,) + labels.shape[1:], dtype=labels.dtype)
        y[:n] = labels
        return {"det": out_det, "feats": out_feats, "mask": mask, "labels": y,
                "label_mask": mask}

    def forward_model(self, db: Dict[str, torch.Tensor],
                      generator=None) -> torch.Tensor:
        return self.model(self._features(db), generator)

    def _targets(self, db: Dict[str, torch.Tensor], outputs: torch.Tensor):
        """(predictions, targets): the label column ``target_index`` of
        labels with columns, a single output column squeezed against
        per-row targets."""
        labels = db["labels"]
        if self.target_index is not None and labels.dim() == 2:
            labels = labels[:, self.target_index]
        p = outputs
        if p.dim() == 2 and labels.dim() == 1 and p.shape[1] == 1:
            p = p[:, 0]
        return p, labels

    def loss_and_metrics(self, outputs: torch.Tensor, db: Dict[str, torch.Tensor]) -> Metrics:
        """Over the real rows: the criterion's sum and its 'mean'
        denominator times the outputs a row (torch's 'mean' averages every
        element); under a classification criterion the accuracy sums."""
        p, labels = self._targets(db, outputs)
        mask = db["mask"]
        elem = self.criterion.elementwise(p, labels)
        loss_sum = _masked_sum(elem, mask)
        n_out = int(np.prod(elem.shape[mask.dim():], dtype=np.int64))
        den = self.criterion.mean_denominator(labels)
        count = mask.sum().float()
        weight = (count if den is None else den.masked_fill(~mask, 0).sum()) * n_out
        metrics = {}
        if self.use_accuracy and p.dim() == 2:
            pred = torch.argmax(torch.softmax(p, dim=1), dim=1)
            metrics["accuracy_sum"] = _masked_sum((pred == labels).float(), mask)
            metrics["accuracy_count"] = count
        return loss_sum, weight, metrics

    def test_outputs(self, outputs: torch.Tensor,
                     db: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        p, labels = self._targets(db, outputs)
        return {"predictions": p, "loss_no_reduce": self.criterion.elementwise(p, labels)}

    def make_evaluator(self, logger=None):
        """``TensorEvaluator``, its metric named after the criterion; the
        targets carry the phys record where the test set's labels are the
        whole phys vector (ref: LitWaveform.py:39-66)."""
        from waveformml_tpu_torch.evaluation.tensor_eval import TensorEvaluator

        cc = self.config.net_config.criterion_class
        metric_name = {"L1Loss": "mean absolute error", "MSELoss": "mean squared error"}.get(
            cc, "Accuracy" if self.use_accuracy else "?")
        dc = self.config.dataset_config
        tp = getattr(dc, "test_dataset_params", None)
        test_has_phys = (tp is not None and getattr(tp, "label_name", None) == "phys"
                         and not hasattr(tp, "label_index"))
        params = self._eval_params()
        params.pop("additional_field_names", None)
        return TensorEvaluator(logger, calgroup=getattr(dc, "calgroup", None),
                               target_has_phys=test_has_phys, target_index=self.target_index,
                               metric_name=metric_name, **params)


@registry.register("LitZ", aliases=("src.engineering.LitZ.LitZ", "LitZ.LitZ"))
class LitZ(TaskBase):
    """Per-segment z regression: the criterion between the model's dense
    ``[B, 1, NX, NY]`` map and the rows' labels scattered to the grid
    (``segment_loss``), over the occupied sites. Labels of phys width (more
    than 2 columns) are read at the phys z column, 4. ``net_config.UseFFT``
    gives the model each row's real spectrum (real ‖ imaginary parts)."""

    labels_per_row = True
    default_net = "SingleEndedZConv"
    z_index = 4

    def __init__(self, config, device=None, trial=None):
        super().__init__(config, device, trial)
        self.use_fft = bool(getattr(config.net_config, "UseFFT", False))

    def event_bucket(self, block: FileBlock) -> int:
        if block.coords.ndim == 2 and block.coords.shape[0]:
            return TaskBase.event_bucket(self, block)
        return bucket_size(max(1, block.labels.shape[0]))

    def prepare_block(self, block: FileBlock, row_bucket: int,
                      event_bucket: int) -> Dict[str, np.ndarray]:
        """The rows padded with their labels (``labels_rows``, padding rows
        0) and extras; ``labels`` and ``label_mask`` zeros over the event
        bucket, which fix the batch's event count; a graph model's edge
        lists; the model's plans."""
        coords, feats, mask, y = pad_sparse(block.coords, block.feats, row_bucket,
                                            labels=block.labels)
        out = {"coords": coords, "feats": feats, "mask": mask, "labels_rows": y,
               "labels": np.zeros((event_bucket,), dtype=np.float32),
               "label_mask": np.zeros((event_bucket,), dtype=bool)}
        self.add_row_extras(block, out, row_bucket)
        self.add_graph_edges(block, out)
        self.add_row_plans(out, event_bucket)
        return out

    def _features(self, db: Dict[str, torch.Tensor]) -> torch.Tensor:
        f = super()._features(db)
        if self.use_fft:
            z = torch.fft.rfft(f.float(), dim=-1)
            f = torch.cat([z.real, z.imag], dim=-1).to(f.dtype)
        return f

    def loss_and_metrics(self, outputs: torch.Tensor, db: Dict[str, torch.Tensor]) -> Metrics:
        labels = db["labels_rows"]
        phys = labels.dim() == 2 and labels.shape[1] > 2
        loss_sum, weight, _, _ = self.segment_loss(
            outputs, db, labels, target_index=self.z_index if phys else None)
        return loss_sum, weight, {}

    def test_outputs(self, outputs: torch.Tensor,
                     db: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        _, _, target_dense, preds = self.segment_loss(outputs, db, db["labels_rows"])
        return {"predictions": preds, "target": target_dense}

    def make_evaluator(self, logger=None):
        """``ZEvaluatorRealWFNorm`` where the test set's labels are the
        phys records, ``ZEvaluatorPhys`` for the ``features`` algorithm,
        else ``ZEvaluatorWF`` (ref: LitZ.py:49-60)."""
        from waveformml_tpu_torch.evaluation.z_eval import (ZEvaluatorPhys,
                                                            ZEvaluatorRealWFNorm, ZEvaluatorWF)

        dc = self.config.dataset_config
        calgroup = getattr(dc, "calgroup", None)
        params = self._eval_params()
        tp = getattr(dc, "test_dataset_params", None)
        if (tp is not None and getattr(tp, "label_name", None) == "phys"
                and not hasattr(tp, "label_index")):
            if hasattr(tp, "additional_fields"):
                params["additional_field_names"] = list(tp.additional_fields)
            return ZEvaluatorRealWFNorm(logger, calgroup=calgroup, **params)
        params.pop("additional_field_names", None)
        if getattr(self.config.net_config, "algorithm", None) == "features":
            return ZEvaluatorPhys(logger, calgroup=calgroup, **params)
        return ZEvaluatorWF(logger, calgroup=calgroup, **params)


@registry.register("LitEZ", aliases=("src.engineering.LitEZ.LitEZ", "LitEZ.LitEZ"))
class LitEZ(TaskBase):
    """Joint per-segment (E, z) regression: output plane 0 against label
    column 0 (E) and plane 1 against column 1 (z), the two segment losses
    summed. With ``algorithm: features`` the E-like feature columns (0, 2,
    3) are scaled by ``escale / e_adjust``."""

    labels_per_row = True
    default_net = "SingleEndedEZConv"
    prepare_block = LitZ.prepare_block
    event_bucket = LitZ.event_bucket

    def __init__(self, config, device=None, trial=None):
        super().__init__(config, device, trial)
        nc = config.net_config
        self.zscale = getattr(nc, "zscale", 1200.0)
        self.escale = getattr(nc, "escale", 12.0)
        self.e_adjust = getattr(nc, "e_adjust", 12.0)
        self.e_factor = self.escale / self.e_adjust
        self.phys_coord = getattr(nc, "algorithm", "conv") == "features"

    def _features(self, db: Dict[str, torch.Tensor]) -> torch.Tensor:
        f = super()._features(db)
        if self.phys_coord and self.e_factor != 1.0:
            f = f.clone()
            f[:, [0, 2, 3]] *= self.e_factor
        return f

    def loss_and_metrics(self, outputs: torch.Tensor, db: Dict[str, torch.Tensor]) -> Metrics:
        t = db["labels_rows"]
        e_sum, e_w, _, _ = self.segment_loss(outputs[:, 0:1], db, t[:, 0])
        z_sum, z_w, _, _ = self.segment_loss(outputs[:, 1:2], db, t[:, 1])
        return z_sum + e_sum, z_w, {"MAE_z_sum": z_sum, "MAE_z_count": z_w,
                                    "MAE_E_sum": e_sum, "MAE_E_count": e_w}

    def test_outputs(self, outputs: torch.Tensor,
                     db: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        t = db["labels_rows"]
        _, _, te, pe = self.segment_loss(outputs[:, 0:1], db, t[:, 0])
        _, _, tz, pz = self.segment_loss(outputs[:, 1:2], db, t[:, 1])
        return {"predictions": torch.cat([pe, pz], dim=1),
                "target": torch.cat([te, tz], dim=1)}

    def make_evaluator(self, logger=None):
        """``EZEvaluatorPhys`` for the ``features`` algorithm, else
        ``EZEvaluatorWF`` (ref: LitEZ.py:26-35)."""
        from waveformml_tpu_torch.evaluation.ez_eval import EZEvaluatorPhys, EZEvaluatorWF

        cls = EZEvaluatorPhys if self.phys_coord else EZEvaluatorWF
        return cls(logger, calgroup=getattr(self.config.dataset_config, "calgroup", None),
                   e_scale=self.e_adjust)


class _RowTask(TaskBase):
    """Per-row tasks over site-preserving nets: labels per row, outputs per
    row, the single-ended rows selectable by the segment status map."""

    labels_per_row = True
    output_unit = "row"
    prepare_block = LitZ.prepare_block
    event_bucket = LitZ.event_bucket

    def __init__(self, config, device=None, trial=None):
        super().__init__(config, device, trial)
        self.seg_status = torch.as_tensor(seg_status_maps()[0], device=self.device)

    def _row_mask(self, db: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The real rows, under ``SE_only`` those of single-ended segments."""
        mask = db["mask"]
        if self.SE_only:
            c = db["coords"].long()
            mask = mask & (self.seg_status[c[:, 0], c[:, 1]] == 0.5)
        return mask


@registry.register("LitSegClassifier",
                   aliases=("src.engineering.LitSegClassifier.LitSegClassifier",
                            "LitSegClassifier.LitSegClassifier"))
class LitSegClassifier(_RowTask):
    """Per-row classification: the criterion's sum over the rows, weighted
    by their count (a class weight scales the sum, never the count), the
    accuracy sums and the confusion matrix (rows target, columns
    prediction)."""

    def __init__(self, config, device=None, trial=None):
        super().__init__(config, device, trial)
        self.n_type = config.system_config.n_type

    def loss_and_metrics(self, outputs: torch.Tensor, db: Dict[str, torch.Tensor]) -> Metrics:
        labels = db["labels_rows"]
        if labels.dim() == 2:
            labels = labels[:, 0]
        labels = labels.long()
        mask = self._row_mask(db)
        loss_sum = _masked_sum(self.criterion.elementwise(outputs, labels), mask)
        count = mask.sum().float()
        pred = torch.argmax(outputs, dim=-1)
        correct = _masked_sum((pred == labels).float(), mask)
        onehot_t = F.one_hot(labels, self.n_type).float() * mask[:, None]
        onehot_p = F.one_hot(pred, self.n_type).float()
        return loss_sum, count, {"accuracy_sum": correct, "accuracy_count": count,
                                 "confusion": onehot_t.t() @ onehot_p}

    def test_outputs(self, outputs: torch.Tensor,
                     db: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"logits": outputs, "pred": torch.argmax(outputs, dim=-1),
                "prob": torch.softmax(outputs, dim=-1)}

    def make_evaluator(self, logger=None):
        from waveformml_tpu_torch.evaluation.pid_eval import PIDEvaluator

        return PIDEvaluator(logger, calgroup=getattr(self.config.dataset_config, "calgroup", None),
                            SE_only=self.SE_only)


@registry.register("LitSegQuantifier",
                   aliases=("src.engineering.LitSegQuantifier.LitSegQuantifier",
                            "LitSegQuantifier.LitSegQuantifier"))
class LitSegQuantifier(_RowTask):
    """Per-row scalar regression of label column ``net_config.target_index``
    (column 0 by default): the criterion's sum over the rows, weighted by
    their count, and the squared error's sum."""

    def __init__(self, config, device=None, trial=None):
        super().__init__(config, device, trial)
        self.target_index = getattr(config.net_config, "target_index", None)

    def loss_and_metrics(self, outputs: torch.Tensor, db: Dict[str, torch.Tensor]) -> Metrics:
        labels = db["labels_rows"]
        if labels.dim() == 2:
            labels = labels[:, self.target_index if self.target_index is not None else 0]
        p = outputs[:, 0] if outputs.dim() == 2 and outputs.shape[1] == 1 else outputs
        mask = self._row_mask(db)
        loss_sum = _masked_sum(self.criterion.elementwise(p, labels), mask)
        count = mask.sum().float()
        mse = _masked_sum((p - labels) ** 2, mask)
        return loss_sum, count, {"mse_sum": mse, "mse_count": count}

    def test_outputs(self, outputs: torch.Tensor,
                     db: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"predictions": outputs}

    def make_evaluator(self, logger=None):
        from waveformml_tpu_torch.evaluation.seg_eval import SegEvaluator

        return SegEvaluator(logger, calgroup=getattr(self.config.dataset_config, "calgroup", None),
                            target_index=self.target_index, SE_only=self.SE_only)
