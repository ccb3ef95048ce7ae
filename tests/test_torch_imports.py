"""Import hygiene of the PyTorch port: ``repro_torch``, every one of its
modules, ``chip_smoke`` and ``chip_profile`` (imported, not run) load
without JAX and without the JAX package, and build no kernel at import."""

import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

from _torch import torch  # noqa: F401  (skips the module without torch)

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
mods = ["repro_torch"] + sorted(
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
for m in mods:
    importlib.import_module(m)
import chip_smoke
import chip_profile
from repro_torch.kernels import _build
print(json.dumps({
    "modules": mods,
    "jax": sorted(k for k in sys.modules if k == "jax" or k.startswith("jax.")),
    "repro": sorted(k for k in sys.modules
                    if k == "repro" or k.startswith("repro.")),
    "libs": sorted(_build._LIBS),
    "launches": _build.LAUNCHES,
}))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240,
                         check=True)
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["jax"] == [] and seen["repro"] == []
    assert seen["libs"] == []  # nothing built or loaded at import
    assert set(seen["launches"].values()) == {0}
    expected = {"repro_torch.core.engine", "repro_torch.kernels.ops",
                "repro_torch.kernels.sorted_probe",
                "repro_torch.kernels.run_probe",
                "repro_torch.kernels.delta_probe", "repro_torch.rdf.store",
                "repro_torch.rdf.writes",
                "repro_torch.obs.registry"}
    assert expected <= set(seen["modules"])


def test_port_sources_name_no_jax():
    pkg = ROOT / "src" / "repro_torch"
    files = [*pkg.rglob("*.py"), ROOT / "chip_smoke.py",
             ROOT / "chip_profile.py"]
    assert len(files) > 15
    for path in files:
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax", "import repro ",
                                     "from repro.", "from repro ")), \
                (path, line)
            assert s != "import repro", (path, line)


def test_every_module_is_walked():
    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    on_disk = {
        "repro_torch." + ".".join(p.relative_to(
            ROOT / "src" / "repro_torch").with_suffix("").parts)
        for p in (ROOT / "src" / "repro_torch").rglob("*.py")
        if p.name != "__init__.py"}
    assert on_disk <= names
