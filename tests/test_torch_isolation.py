"""The port stands alone: importing every ``repro_torch`` module pulls in
neither JAX nor anything of the JAX package ``repro``, and no source of
the port (nor ``chip_smoke.py``) names them in an import."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)(\s|\.|,|$)|"
    r"from\s+(jax|jaxlib|repro)(\s|\.))", re.MULTILINE)


def _modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= len(_modules())


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert not offenders, offenders


def test_the_scan_catches_what_it_should():
    for line in ("import jax", "from jax import numpy", "import repro.core",
                 "from repro.fl import x", "  import jaxlib",
                 "from repro import lora"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import x",
                 "import jaxtyping_like_name_is_fine_if_not_jax"):
        assert not FORBIDDEN.search(line), line


def test_the_import_check_covers_every_slice():
    """The walk above reaches each slice's modules, serving and the
    operator-facing obs modules included."""
    walked = set(_modules())
    for name in ("repro_torch.fl.async_agg", "repro_torch.serving.store",
                 "repro_torch.serving.engine", "repro_torch.obs.export",
                 "repro_torch.obs.health", "repro_torch.obs.trace",
                 "repro_torch.kernels.lora_matmul.ops",
                 "repro_torch.kernels.lora_matmul.ref",
                 "repro_torch.kernels.ssd_scan.ops",
                 "repro_torch.kernels.ssd_scan.ref",
                 "repro_torch.configs.base", "repro_torch.models.common",
                 "repro_torch.models.mamba", "repro_torch.models.transformer",
                 "repro_torch.models.model", "repro_torch.launch.serve"):
        assert name in walked, name
