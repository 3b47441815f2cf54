"""Prediction writers: stream an HDF5 event file through a frozen model and
write a new HDF5 file with the predictions in place (counterpart of
waveformml_tpu/inference/prediction_writer.py).

``PredictionWriter.write_predictions`` runs a five-stage pipeline over
event-preserving read chunks: the HDF5 reader on a prefetch thread, the
model's host prep and asynchronous dispatch on the calling thread, a FIFO
of fetch futures over ``fetch_workers`` threads (wait for the chunk's
outputs, post-process them into the rows to write), and the table writer
on its own thread. ``ZPredictionWriter`` swaps a Z model's z into
``EZ[:, 1]``, ``IRNPredictionWriter`` per-event outputs into
``phys[:, 4:]``, ``IRNIMPredictionWriter`` a segment classifier's scores
into ``phys[:, 2:]`` or into PhysPulse records, and ``ZAndClassWriter``
runs a Z model and a classifier on each chunk into PhysPulse records. An
XML provenance sidecar follows (``write_XML``).

The writers take the JAX writers' arguments, and ``device`` (None: the
card, which raises where there is none; "cpu": the plain versions of the
kernels). Each model is the port's ``InferenceModel`` and loads a port
checkpoint (a ``Trainer`` checkpoint or a ``torch.save``d state dict). The
input is opened by ``_open_input`` and the output file by ``_open``, the
seam that ``datasets/synthetic.py``'s in-memory stand-ins override.
"""
from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from waveformml_tpu_torch.config import load_config
from waveformml_tpu_torch.datasets.pulse_dataset import dataset_class_type_map
from waveformml_tpu_torch.detector import MAX_RANGE, NX, NY, Z_NORMALIZATION_FACTOR
from waveformml_tpu_torch.device import resolve_device
from waveformml_tpu_torch.engineering.se_mask import seg_status_maps
from waveformml_tpu_torch.inference.model import InferenceModel
from waveformml_tpu_torch.io.compound_types import (PhysPulse, WaveformPairCal,
                                                    extension_type_map)
from waveformml_tpu_torch.io.hdf5 import H5Input, P2XTableWriter
from waveformml_tpu_torch.io.sql import get_gains
from waveformml_tpu_torch.io.xml import XMLWriter
from waveformml_tpu_torch.ops.calibration import convert_wf_phys_SE_classifier
from waveformml_tpu_torch.ops.sparse import (consecutive_event_index, normalize_waveforms,
                                             swap_sparse_from_dense, swap_sparse_from_event)
from waveformml_tpu_torch.utils import tracing
from waveformml_tpu_torch.utils.util import get_file_md5, prefetch_iter

_CALGROUP_NEEDED = ("Must pass calgroup argument in order to normalize "
                    "WaveformPairCal data before passing to model")


class PredictionWriter(P2XTableWriter):
    """The base writer: subclasses implement ``model_dispatch`` and
    ``apply_outputs`` (or ``swap_values``/``convert_values``)."""

    def __init__(self, path: str, input_path: str, config: str, checkpoint: str,
                 device=None, **kwargs):
        # the device first: without a card nothing is opened
        self.device = resolve_device(device)
        super().__init__(path)
        self.XMLW = XMLWriter()
        self.checkpoint_path = checkpoint
        self.config_path = config
        self.config = load_config(config)
        self.input = self._open_input(input_path)
        self.input_type = extension_type_map(input_path)
        self.n_buffer_rows = 1024 * 16
        self.n_rows_per_read = 2048
        # gzip level of the output table: deflate at any level reads the
        # same downstream, and 4 writes much faster than 9
        self.output_compression = 4
        self.swap = True
        for key, val in kwargs.items():
            setattr(self, key, val)
        pre, post = self._model_transforms()
        self.model = InferenceModel(self.config, checkpoint, device=self.device,
                                    preprocess=pre, postprocess=post,
                                    output_unit=self._output_unit())
        if "datatype" in kwargs:
            if kwargs["datatype"] == "WaveformPairCal":
                self.data_type = WaveformPairCal()
            elif kwargs["datatype"] == "PhysPulse":
                self.data_type = PhysPulse()
            else:
                raise IOError(f"unrecognized datatype: {kwargs['datatype']}, did you mean "
                              "'WaveformPairCal' or 'PhysPulse'?")
        else:
            self.data_type = (dataset_class_type_map(self.config.dataset_config.dataset_class)
                              or self.input_type)

    def _open_input(self, input_path: str) -> H5Input:
        return H5Input(input_path)

    def write_predictions(self) -> None:
        """Stream the input through the model into the output table.

        Stages: (A) the reader decodes chunks on a prefetch thread; (B) this
        thread preps and dispatches each chunk without waiting for the
        device; (C) ``fetch_workers`` threads wait for a chunk's outputs and
        post-process them, collected in dispatch order from a FIFO of at
        most ``pipeline_depth`` futures; (D) the writer thread appends and
        flushes. Queues are bounded; an error in any stage drains the
        others and is raised here, with both files closed.
        ``stage_seconds`` holds each stage's host-clock seconds, each a
        ``utils.tracing`` span (``writer.<stage>``)."""
        if "Chanmap" in self.input.h5f:
            self.copy_chanmap(self.input)
        self.input.setup_table(self.input_type.name, self.input_type.type,
                               self.input_type.event_index_name,
                               event_index_coord=self.input_type.event_index_coord)
        nrows = self.input.h5f[self.input_type.name].shape[0]
        self.create_table(self.data_type.name, (nrows,), self.data_type.type,
                          compression_opts=int(self.output_compression))
        self.copy_p2x_attrs(self.input, self.data_type.name, self.input_type.name,
                            self.data_type.names)
        self.stage_seconds = {"dispatch_s": 0.0, "fetch_post_s": 0.0, "fetch_wait_s": 0.0,
                              "write_wait_s": 0.0, "writer_busy_s": 0.0, "fill_s": 0.0,
                              "drain_s": 0.0}
        for attr in ("model", "class_model"):
            model = getattr(self, attr, None)
            if model is not None:
                model.dispatch_phases = dict.fromkeys(model.dispatch_phases, 0.0)
        # each chunk in flight holds its pinned output buffer until fetched
        depth = max(1, int(getattr(self, "pipeline_depth", 8)))
        wq: "queue.Queue" = queue.Queue(maxsize=8)
        fq: "queue.Queue" = queue.Queue(maxsize=depth)
        errors = []

        def writer_loop():
            n_current_buffer = 0
            draining = False
            while True:
                rows = wq.get()
                if rows is None:
                    return
                if draining:
                    continue
                with tracing.span("writer.write") as busy:
                    try:
                        self.add_rows(self.data_type.name, rows)
                        n_current_buffer += rows.shape[0]
                        if n_current_buffer >= self.n_buffer_rows:
                            n_current_buffer = 0
                            self.flush(self.data_type.name)
                    except BaseException as e:  # raised again by the producer
                        errors.append(e)
                        draining = True  # keep consuming so that no producer blocks
                self.stage_seconds["writer_busy_s"] += busy.seconds

        fetch_stat_lock = threading.Lock()

        def fetch_one(data, handle):
            # fetch_post_s sums the workers' busy time: the workers overlap,
            # so it can exceed the wall
            with tracing.span("writer.fetch_post") as post:
                rows = self.apply_outputs(data, handle)
            with fetch_stat_lock:
                self.stage_seconds["fetch_post_s"] += post.seconds
            return rows

        def fetch_loop():
            # the collector: futures in dispatch order, so that rows are
            # written in input order
            draining = False
            while True:
                fut = fq.get()
                if fut is None:
                    return
                if draining:
                    fut.cancel()
                    continue
                try:
                    _write(fut.result())
                except BaseException as e:
                    errors.append(e)
                    draining = True

        def _write(rows):
            if errors:
                raise errors[0]
            with tracing.span("writer.write_wait") as wait:
                wq.put(rows)
            self.stage_seconds["write_wait_s"] += wait.seconds

        def _enqueue_fetch(data, handle):
            if errors:
                raise errors[0]
            with tracing.span("writer.fetch_wait") as wait:
                fq.put(fetch_pool.submit(fetch_one, data, handle))
            self.stage_seconds["fetch_wait_s"] += wait.seconds

        def _drain_threads():
            fq.put(None)
            fetcher.join()
            fetch_pool.shutdown(wait=True)
            wq.put(None)
            writer.join()

        def _close_quietly():
            for closer in (self.input.close, self.close):
                try:
                    closer()
                except Exception:
                    pass  # the original error is the one raised

        fetch_pool = ThreadPoolExecutor(max_workers=max(1, int(getattr(self, "fetch_workers", 3))),
                                        thread_name_prefix="wfml-prediction-fetch")
        writer = threading.Thread(target=writer_loop, daemon=True,
                                  name="wfml-prediction-writer")
        fetcher = threading.Thread(target=fetch_loop, daemon=True,
                                   name="wfml-prediction-fetcher")
        writer.start()
        fetcher.start()

        fill = tracing.span("writer.fill").open()
        try:
            # "truncate": a chunk never exceeds n_rows_per_read, so that it
            # pads to that row bucket and not to the next one
            for data in prefetch_iter(self.input.iter_chunks(self.n_rows_per_read,
                                                             preserve_event="truncate")):
                if fill is not None:
                    fill.close()
                    self.stage_seconds["fill_s"] = fill.seconds
                    fill = None
                with tracing.span("writer.dispatch") as dispatch:
                    handle = self.model_dispatch(data)
                self.stage_seconds["dispatch_s"] += dispatch.seconds
                if handle is None:  # a writer without model_dispatch
                    if self.swap:
                        self.swap_values(data)
                    else:
                        data = self.convert_values(data)
                    _write(data)
                    continue
                _enqueue_fetch(data, handle)
        except BaseException:
            _drain_threads()
            _close_quietly()
            raise
        finally:
            if fill is not None:
                fill.close()
        with tracing.span("writer.drain") as drain:
            with tracing.span("writer.drain_fetch") as drain_fetch:
                _drain_threads()
            if errors:
                _close_quietly()
                raise errors[0]
            self.stage_seconds["drain_fetch_s"] = drain_fetch.seconds
            try:
                self.flush(self.data_type.name)
                self.input.close()
                self.close()
            except BaseException:
                _close_quietly()
                raise
        self.stage_seconds["drain_s"] = drain.seconds

    # -- the model's inputs ---------------------------------------------------------
    def _coords_vals(self, data: np.ndarray):
        """Raw ADC pairs normalised by the gains (which need a calgroup), or
        the pulses as they are; the event column renumbered consecutively."""
        coords = data["coord"].copy()
        if "waveform" in (data.dtype.names or ()):
            if getattr(self, "gains", None) is None:
                raise IOError(_CALGROUP_NEEDED)
            vals = normalize_waveforms(coords, data["waveform"], self.gains)
        else:
            coords[:, -1] = consecutive_event_index(coords[:, -1])
            vals = np.asarray(data["pulse"], dtype=np.float32)
        return coords, vals

    def swap_values(self, data: np.ndarray) -> None:
        self.apply_outputs(data, self.model_dispatch(data))

    def convert_values(self, data: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    # -- the pipeline's hooks -------------------------------------------------------
    def _output_unit(self) -> str:
        """The leading axis of the model's outputs ("row", "event" or
        "auto"), for ``InferenceModel.fetch`` to cut."""
        return "auto"

    def _model_transforms(self):
        """(preprocess, postprocess) run on the device inside the model's
        captured forward; None each by default."""
        return None, None

    def model_dispatch(self, data: np.ndarray):
        """Dispatch a chunk's device work without waiting for it; returns a
        handle for ``apply_outputs`` (None: the synchronous path)."""
        return None

    def apply_outputs(self, data: np.ndarray, handle) -> np.ndarray:
        """Wait for a handle's outputs and return the chunk's rows to write."""
        raise NotImplementedError

    # -- provenance -----------------------------------------------------------------
    def set_xml(self) -> None:
        settings = {"model_checkpoint": self.checkpoint_path, "model_config": self.config_path}
        if os.path.exists(self.checkpoint_path):
            settings["model_checkpoint_hash"] = get_file_md5(self.checkpoint_path)
        if os.path.isfile(self.config_path):
            settings["model_config_hash"] = get_file_md5(self.config_path)
        self.XMLW.step_settings.update(settings)

    def write_XML(self, runtime: float) -> None:
        self.XMLW.input_file = self.input.path + ".xml"
        self.XMLW.output_file = self.path
        self.XMLW.step_name = type(self).__name__
        self.set_xml()
        self.XMLW.write_xml(self.path + ".xml", runtime)


def _device_gain_pre(gains_scaled: np.ndarray, device):
    """A ``preprocess`` that normalises raw int16 ADC pairs on the device:
    each row's samples as float32, the left half times its segment's left
    factor, the right half times the right one. ``gains_scaled`` ``[NX,
    NY, 2]`` already holds any scale factor; its device copy is made here,
    before any capture."""
    gains = torch.as_tensor(np.asarray(gains_scaled, dtype=np.float32), device=device)

    def pre(coords, feats, mask):
        g = gains[coords[:, 0].long(), coords[:, 1].long()]  # [N, 2]
        s = feats.shape[1] // 2
        f = feats.float()
        return torch.cat([f[:, :s] * g[:, :1], f[:, s:] * g[:, 1:]], dim=1)

    return pre


def _dense_to_row_post():
    """A ``postprocess`` that gathers each row's value from a dense ``[B, 1,
    NX, NY]`` output (the event column renumbered consecutively)."""
    def post(outputs, coords, mask):
        c = coords.long()
        return outputs[c[:, -1], 0, c[:, 0], c[:, 1]]

    return post


def _gain_factors(calgroup: str, scale_factor: Optional[float] = None) -> np.ndarray:
    """``[NX, NY, 2]`` float32 factors (scale_factor · 690 / MAX_RANGE) /
    gain, zero where a gain is zero, from the calibration database that
    ``PROSPECT_CALDB`` names."""
    gains = get_gains(os.environ["PROSPECT_CALDB"], calgroup)
    num = (scale_factor or 1.0) * 690.0 / MAX_RANGE
    out = np.full((NX, NY, 2), num, dtype=np.float32)
    return np.divide(out, gains, out=np.zeros_like(out), where=gains != 0)


class ZPredictionWriter(PredictionWriter):
    """Swap a Z model's z into ``EZ[:, 1]``.

    Over raw ADC waveforms with a calgroup, the gain normalisation and the
    dense-grid → per-row gather run on the device inside the captured
    forward: int16 samples go in and one z a row comes out. Otherwise the
    host normalises (or takes the pulses) and fetches the dense grid."""

    def __init__(self, path, input_path, config, checkpoint, **kwargs):
        self.z_scale = Z_NORMALIZATION_FACTOR
        self.gains = None
        if kwargs.get("calgroup"):
            self.gains = _gain_factors(kwargs["calgroup"], kwargs.get("scale_factor"))
        self._device_norm = (self.gains is not None and
                             "waveform" in (extension_type_map(input_path).type.names or ()))
        super().__init__(path, input_path, config, checkpoint, **kwargs)

    def _output_unit(self) -> str:
        return "row" if self._device_norm else "event"

    def _model_transforms(self):
        if not self._device_norm:
            return None, None
        return _device_gain_pre(self.gains, self.device), _dense_to_row_post()

    def model_dispatch(self, data: np.ndarray):
        if self._device_norm:
            coords = data["coord"].copy()
            coords[:, -1] = consecutive_event_index(coords[:, -1])
            return self.model.dispatch(coords, data["waveform"])
        coords, vals = self._coords_vals(data)
        return self.model.dispatch(coords, vals)

    def apply_outputs(self, data: np.ndarray, handle) -> np.ndarray:
        out = self.model.fetch(handle)
        if self._device_norm:  # one z a row
            data["EZ"][:, 1] = (out - 0.5) * self.z_scale
        else:                  # the dense [B, 1, NX, NY] grid
            swap_sparse_from_dense(data["EZ"][:, 1], (out[:, 0] - 0.5) * self.z_scale,
                                   data["coord"])
        return data

    def set_xml(self) -> None:
        super().set_xml()
        self.XMLW.step_settings["EZ_index_replaced"] = [1]


class IRNPredictionWriter(PredictionWriter):
    """Swap a model's per-event outputs into ``phys[:, 4:]`` of every row of
    the event."""

    def __init__(self, path, input_path, config, checkpoint, **kwargs):
        super().__init__(path, input_path, config, checkpoint, **kwargs)
        self.phys_index_replaced = 4

    def _output_unit(self) -> str:
        return "event"

    def model_dispatch(self, data: np.ndarray):
        coords, vals = self._coords_vals(data)
        return self.model.dispatch(coords, vals)

    def apply_outputs(self, data: np.ndarray, handle) -> np.ndarray:
        swap_sparse_from_event(data["phys"][:, self.phys_index_replaced:],
                               self.model.fetch(handle), data["coord"])
        return data

    def set_xml(self) -> None:
        super().set_xml()
        self.XMLW.step_settings["phys_index_replaced"] = [4, 5, 6]


class IRNIMPredictionWriter(PredictionWriter):
    """A segment classifier's 5 scores a row: swapped into ``phys[:, 2:]``,
    or, with ``datatype="PhysPulse"``, converted into PhysPulse records
    (``convert_wf_phys_SE_classifier``)."""

    def __init__(self, path, input_path, config, checkpoint, **kwargs):
        super().__init__(path, input_path, config, checkpoint, **kwargs)
        self.phys_index_replaced = 2
        self.output_is_sparse = kwargs.get("output_is_sparse", True)
        self.seg_status, self.blind_detl, self.blind_detr = seg_status_maps(
            kwargs.get("excludes"))
        self.gains = None
        if kwargs.get("calgroup"):
            self.gains = _gain_factors(kwargs["calgroup"], kwargs.get("scale_factor"))
        if isinstance(self.data_type, PhysPulse):
            self.swap = False

    def _output_unit(self) -> str:
        # per-row scores [N, 5], or [B, 5, NX, NY] from a dense model;
        # output_is_sparse may be set from kwargs before __init__ sets it
        return "row" if getattr(self, "output_is_sparse", True) else "event"

    def model_dispatch(self, data: np.ndarray):
        coords, vals = self._coords_vals(data)
        return coords, self.model.dispatch(coords, vals)

    def apply_outputs(self, data: np.ndarray, handle) -> np.ndarray:
        coords, h = handle
        output = self.model.fetch(h)
        if self.swap:
            if self.output_is_sparse:
                data["phys"][:, self.phys_index_replaced:] = output
            else:
                # channels last, as the swap indexes [B, NX, NY, ...]
                swap_sparse_from_dense(data["phys"][:, self.phys_index_replaced:],
                                       np.moveaxis(output, 1, -1), data["coord"])
            return data
        return self._convert(data, coords, output)

    def convert_values(self, data: np.ndarray) -> np.ndarray:
        coords, h = self.model_dispatch(data)
        return self._convert(data, coords, self.model.fetch(h))

    def _convert(self, data: np.ndarray, coords: np.ndarray, output: np.ndarray) -> np.ndarray:
        return _phys_pulses(self.data_type, data, coords, data["EZ"][:, 1], output,
                            self.blind_detl, self.blind_detr)

    def set_xml(self) -> None:
        super().set_xml()
        if self.swap:
            self.XMLW.step_settings["phys_index_replaced"] = [2, 3, 4, 5, 6]
        else:
            self.XMLW.step_settings.update(_SCORE_PLACEMENT)


#: where ``convert_wf_phys_SE_classifier`` puts each class score
_SCORE_PLACEMENT = {"classifier_score_ioni_placement": "E",
                    "classifier_score_recoil_placement": "rand",
                    "classifier_score_ncap_placement": "dt",
                    "classifier_score_ingress_placement": "y",
                    "classifier_score_muon_placement": "PSD"}


def _phys_pulses(data_type, data, coords, nn_z, scores, blind_detl, blind_detr) -> np.ndarray:
    """PhysPulse records of a chunk from its input rows, a z a row and the
    classifier's scores."""
    phys = np.zeros((coords.shape[0],), dtype=data_type.type)
    phys["evt"] = data["evt"]
    phys["t"] = data["t"]
    phys["PE"] = data["PE"]
    phys["seg"] = data["coord"][:, 0] + data["coord"][:, 1] * NX
    phys["PID"] = data["PID"]
    convert_wf_phys_SE_classifier(
        data["coord"], data["E"], phys["E"], phys["rand"], data["dt"], phys["dt"], data["z"],
        phys["y"], data["PSD"], phys["PSD"], phys["E_SE"], phys["y_SE"], phys["Esmear_SE"],
        phys["PSD_SE"], nn_z, scores, blind_detl, blind_detr)
    return phys


class ZAndClassWriter(PredictionWriter):
    """A Z model and a segment classifier on each chunk → PhysPulse records
    (``python -m waveformml_tpu_torch.scripts.write_z_and_class``). Both
    normalise the raw int16 ADC pairs on the device, each with its own
    scale factor (``scale_factor_z``, ``scale_factor_class``); a calgroup is
    required."""

    def __init__(self, path, input_path, zconfig, zcheckpoint, classconfig,
                 classcheckpoint, **kwargs):
        if kwargs.get("datatype", "PhysPulse") != "PhysPulse":
            raise IOError("datatype must be PhysPulse for ZAndClassWriter")
        kwargs["datatype"] = "PhysPulse"
        self.scale_factor_z = kwargs.pop("scale_factor_z", 1.0)
        self.scale_factor_class = kwargs.pop("scale_factor_class", 1.0)
        if "scale_factor" in kwargs:
            raise IOError("Must specify scale factor for z or classifier "
                          "(scale_factor_z or scale_factor_class)")
        self.z_scale = Z_NORMALIZATION_FACTOR
        self.gains = None
        if kwargs.get("calgroup"):
            self.gains = _gain_factors(kwargs["calgroup"])
        if self.gains is None:
            raise IOError(_CALGROUP_NEEDED)
        self._device_norm = True
        super().__init__(path, input_path, zconfig, zcheckpoint, **kwargs)
        self.swap = False
        self.seg_status, self.blind_detl, self.blind_detr = seg_status_maps(
            kwargs.get("excludes"))
        self.class_config_path = classconfig
        self.class_checkpoint_path = classcheckpoint
        self.class_config = load_config(classconfig)
        self.class_model = InferenceModel(self.class_config, classcheckpoint,
                                          device=self.device,
                                          preprocess=self._norm_pre(self.scale_factor_class),
                                          output_unit="row")  # [N, 5] scores

    def _output_unit(self) -> str:
        return "row"

    def _norm_pre(self, scale_factor: float):
        return _device_gain_pre(self.gains * scale_factor, self.device)

    def _model_transforms(self):
        return self._norm_pre(self.scale_factor_z), _dense_to_row_post()

    def convert_values(self, data: np.ndarray) -> np.ndarray:
        return self.apply_outputs(data, self.model_dispatch(data))

    def model_dispatch(self, data: np.ndarray):
        """Both models dispatched back to back: the raw int16 pairs ship
        once a model, and both forwards run while the host preps the next
        chunk."""
        coords = data["coord"].copy()
        coords[:, -1] = consecutive_event_index(coords[:, -1])
        class_h = self.class_model.dispatch(coords, data["waveform"])
        z_h = self.model.dispatch(coords, data["waveform"])
        return coords, class_h, z_h

    def apply_outputs(self, data: np.ndarray, handle) -> np.ndarray:
        coords, class_h, z_h = handle
        class_out = self.class_model.fetch(class_h)
        data["EZ"][:, 1] = (self.model.fetch(z_h) - 0.5) * self.z_scale
        return _phys_pulses(self.data_type, data, coords, data["EZ"][:, 1], class_out,
                            self.blind_detl, self.blind_detr)

    def set_xml(self) -> None:
        super().set_xml()
        self.XMLW.step_settings.update({
            "ML_z_placement": "y_SE", **_SCORE_PLACEMENT,
            "model_z_checkpoint": self.checkpoint_path,
            "model_z_config": self.config_path,
            "model_classifier_checkpoint": self.class_checkpoint_path,
            "model_classifier_config": self.class_config_path,
            "scale_factor_z": self.scale_factor_z,
            "scale_factor_class": self.scale_factor_class})
