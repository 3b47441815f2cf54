"""The port stands alone: importing it, module by module, loads neither
JAX nor the JAX package nor h5py, and no source of the port or of
chip_smoke.py refers to them."""
import os
import pkgutil
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "waveformml_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "h5py", "waveformml_tpu")


def _modules():
    names = ["waveformml_tpu_torch"]
    for info in pkgutil.walk_packages([PORT], prefix="waveformml_tpu_torch."):
        names.append(info.name)
    return names


def test_import_loads_no_jax():
    names = _modules()
    for name in ("ops.waveform_features", "inference.model", "engineering.trainer", "optim",
                 "nn.functional", "datasets.synthetic"):
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
                         r"|waveformml_tpu\.", re.MULTILINE)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, filenames in os.walk(PORT):
        files += [os.path.join(dirpath, f) for f in filenames if f.endswith(".py")]
    for name in ("engineering/trainer.py", "optim.py", "nn/functional.py"):
        assert os.path.join(PORT, name) in files, name
    offenders = []
    for path in files:
        with open(path) as f:
            for m in pattern.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}")
    assert not offenders, offenders
