"""``repro_torch`` imports with ``jax``, ``ml_dtypes`` and ``repro`` blocked.

The check runs in a subprocess: this test process has already imported
``repro`` (``tests/conftest.py``) and ``jax``. A ``sys.meta_path`` finder
refuses ``jax``, ``jaxlib``, ``ml_dtypes``, ``repro`` and ``repro.*`` (not
``repro_torch``), then every module of the port is imported.
"""
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

SCRIPT = r"""
import importlib, pkgutil, sys

class Blocker:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "ml_dtypes", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocker())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in ("repro_torch.analysis", "repro_torch.core.gateway", "repro_torch.core.workload",
             "repro_torch.train.checkpoint", "repro_torch.train.optimizer",
             "repro_torch.train.compress", "repro_torch.launch.train",
             "repro_torch.models.sharding", "repro_torch.launch.mesh",
             "repro_torch.train.elastic", "repro_torch.roofline", "repro_torch.roofline.analysis",
             "repro_torch.roofline.op_count", "repro_torch.roofline.report",
             "repro_torch.launch.dryrun", "repro_torch.launch.buffers", "repro_torch.examples",
             "repro_torch.examples.quickstart", "repro_torch.examples.reconfigure_live",
             "repro_torch.examples.serve_decode", "repro_torch.examples.train_ec_checkpoint",
             "repro_torch.kernels.flash_attention.work"):
    assert name in names, name
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"))
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", SCRIPT], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 74  # every module of slices 1, 2, 5, 6 and 11


def test_port_sources_never_name_jax_or_import_repro():
    root = SRC / "repro_torch"
    files = sorted(root.rglob("*.py")) + [SRC.parent / "chip_smoke.py"]
    for path in files:
        text = path.read_text()
        for line in text.splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                words = stripped.replace(",", " ").split()
                assert "jax" not in words[1].split(".")[0], (path, line)
                assert words[1].split(".")[0] != "repro", (path, line)
        assert "import jax" not in text, path
