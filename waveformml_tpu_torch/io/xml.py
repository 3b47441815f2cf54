"""XML provenance sidecars (the port's copy of waveformml_tpu/io/xml.py):
``XMLWriter`` appends an ``<AnalysisStep>`` node (the code, the input's md5,
the step's settings, the run's provenance and its run time) to the input
file's sidecar and writes the result beside the output file, in the
experiment's analysis-chain format."""
from __future__ import annotations

import logging
import os
import sys
import xml.etree.ElementTree as ET
from ntpath import basename
from typing import Any, Dict, Optional

from waveformml_tpu_torch.utils.util import get_file_md5, get_run_info

log = logging.getLogger(__name__)


def append_xml(in_path: str, out_path: str, append_dict: Dict[str, Any],
               parent: Optional[ET.Element] = None) -> None:
    """Append the nodes of a nested dict to the XML file ``in_path`` and
    write the result to ``out_path`` (or, given ``parent``, append under
    it and write nothing); ``_PROP_`` entries become attributes."""
    if parent is None:
        tree = ET.parse(in_path)
        root = tree.getroot()
    else:
        root = parent
    for name, value in append_dict.items():
        if name == "_PROP_":
            for key, v in value.items():
                root.set(key, str(v))
            continue
        n = ET.Element(name)
        if isinstance(value, dict):
            append_xml(in_path, out_path, value, n)
        else:
            n.text = str(value)
        root.append(n)
    if parent is None:
        ET.indent(tree, space="    ")
        tree.write(out_path, xml_declaration=True)


class XMLWriter:
    """One analysis step's provenance: set ``input_file``, ``output_file``,
    ``step_name`` and ``step_settings``, then ``write_xml``."""

    def __init__(self):
        self.code = basename(str(sys.argv[0]))
        self.input_file = "UNKNOWN"
        self.output_file = "UNKNOWN"
        self.step_name = "UNKNOWN"
        self.step_settings: Dict[str, Any] = {}
        self.step_xml: Dict[str, Any] = {}

    def generate_step_xml(self, runtime: float) -> None:
        input_md5 = (get_file_md5(self.input_file) if os.path.exists(self.input_file)
                     else "UNKNOWN")
        self.step_xml = {"AnalysisStep": {
            "_PROP_": {"code": self.code},
            "input": {"_PROP_": {"file": self.input_file, "md5": input_md5}},
            "output": {"_PROP_": {"file": self.output_file}},
            self.step_name: {"_PROP_": self.step_settings},
        }}
        for key, val in get_run_info().items():
            self.step_xml["AnalysisStep"]["_PROP_"][key] = val
        self.step_xml["AnalysisStep"]["_PROP_"]["dtime"] = str(int(runtime))

    def write_xml(self, out_path: str, runtime: float) -> None:
        """Append this step to the input's sidecar (or to a new
        ``<WaveformML>`` root where the input has none) as ``out_path``."""
        self.generate_step_xml(runtime)
        if os.path.exists(self.input_file):
            append_xml(self.input_file, out_path, self.step_xml)
        else:
            log.warning("No input XML file %s found, writing standalone sidecar",
                        self.input_file)
            root = ET.Element("WaveformML")
            tree = ET.ElementTree(root)
            append_xml("", out_path, self.step_xml, parent=root)
            ET.indent(tree, space="    ")
            tree.write(out_path, xml_declaration=True)
