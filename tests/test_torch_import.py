"""The port stands alone: importing it, module by module, loads neither
JAX nor the JAX package nor h5py, matplotlib, tensorboard or tensorboardX,
and no source of the port or of chip_smoke.py refers to JAX, the JAX
package or h5py. The one exception: the HDF5 loaders import h5py inside
their own functions (``H5PY_LOADERS``), when they run, so that the package
imports without it (the scripts open files through them). matplotlib,
tensorboard and tensorboardX are imported only inside the functions that
draw, read or log events (the card machine has none of them)."""
import ast
import os
import pkgutil
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "waveformml_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "h5py", "waveformml_tpu", "matplotlib",
             "tensorboard", "tensorboardX")
#: imported only inside functions, never when a module of the port is imported
LAZY = ("matplotlib", "tensorboard", "tensorboardX")
#: module → the top-level functions of it whose body may import h5py
H5PY_LOADERS = {"waveformml_tpu_torch/io/hdf5.py": ("open_h5", "is_group", "_fixed_str_type")}


def _loader_import_lines(path: str, functions) -> set:
    """Lines of ``import h5py`` statements in the bodies of the named
    top-level functions of a source file."""
    with open(path) as f:
        tree = ast.parse(f.read())
    lines = set()
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in functions:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Import) and [a.name for a in sub.names] == ["h5py"]:
                    lines.add(sub.lineno)
    return lines


def _modules():
    names = ["waveformml_tpu_torch"]
    for info in pkgutil.walk_packages([PORT], prefix="waveformml_tpu_torch."):
        names.append(info.name)
    return names


def test_import_loads_no_jax():
    names = _modules()
    for name in ("ops.waveform_features", "inference.model", "engineering.trainer", "optim",
                 "nn.functional", "datasets.synthetic", "inference.prediction_writer",
                 "write_predictions", "scripts.write_z_and_class", "io.hdf5", "io.sql",
                 "io.xml", "evaluate", "evaluation.psd_eval", "evaluation.z_eval",
                 "engineering.callbacks", "utils.plot", "utils.tb",
                 "scripts.analyze_waveforms", "scripts.compare_gains",
                 "scripts.compare_sim_cal_curve", "scripts.eval_wf_params",
                 "scripts.gen_wf_param_config", "scripts.compare_calibration_curves",
                 "scripts.run_occlusion_study", "scripts.eval_occlusion_study",
                 "scripts.compare_pmt_wf", "scripts.add_attr", "scripts.plot_model_weights",
                 "scripts.peak_finder"):
        assert f"waveformml_tpu_torch.{name}" in names, name
    code = ("import importlib, sys\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_do_not_refer_to_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|orbax|h5py|waveformml_tpu)\b"
                         r"|waveformml_tpu\.|(import_module|__import__)\(\s*[\"']h5py",
                         re.MULTILINE)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, filenames in os.walk(PORT):
        files += [os.path.join(dirpath, f) for f in filenames if f.endswith(".py")]
    for name in ("engineering/trainer.py", "optim.py", "nn/functional.py"):
        assert os.path.join(PORT, name) in files, name
    for name in H5PY_LOADERS:
        assert os.path.join(ROOT, name) in files, name
    offenders = []
    for path in files:
        rel = os.path.relpath(path, ROOT)
        allowed = _loader_import_lines(path, H5PY_LOADERS.get(rel, ()))
        with open(path) as f:
            text = f.read()
        for m in pattern.finditer(text):
            line = text.count("\n", 0, m.start(1) if m.group(1) else m.start()) + 1
            if m.group(0).strip() == "import h5py" and line in allowed:
                continue
            offenders.append(f"{rel}:{line}: {m.group(0).strip()}")
    assert not offenders, offenders


def test_matplotlib_and_tensorboardx_are_imported_inside_functions():
    """No module of the port imports matplotlib, tensorboard or tensorboardX
    at its top level (including under a top-level ``if`` or ``try``)."""
    offenders = []
    for dirpath, _, filenames in os.walk(PORT):
        for f in filenames:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                tree = ast.parse(fh.read())
            nodes = list(tree.body)
            while nodes:
                node = nodes.pop()
                if isinstance(node, (ast.If, ast.Try)):
                    nodes += node.body + node.orelse + getattr(node, "finalbody", [])
                    nodes += [s for h in getattr(node, "handlers", []) for s in h.body]
                names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                         [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                if any(n.split(".")[0] in LAZY for n in names):
                    offenders.append(f"{os.path.relpath(path, ROOT)}:{node.lineno}")
    assert not offenders, offenders
