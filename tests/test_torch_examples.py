"""The port's examples (``python -m repro_torch.examples.<name>``) against
the reference's ``examples/*.py``, on the CPU (``--device cpu``: the data
plane's plain versions), each in a subprocess as a user runs it:

- ``quickstart`` and ``reconfigure_live`` build the reference's deployments
  from its seeds; the control plane is trace-identical (ROADMAP, "held
  against the reference"), so their standard output equals the reference
  examples' byte for byte;
- ``serve_decode`` and ``train_ec_checkpoint`` run ``launch.serve`` and
  ``launch.train`` with the reference example's arguments and pass its
  assertions. ``train_ec_checkpoint`` runs 12 steps with a checkpoint every
  5 and the crash at step 8 (the example's 60 / 20 / 45 take ~3 minutes of
  the suite's time here): two quorum checkpoints, a crash of the trainer and
  of two checkpoint hosts, a restore, and a loss that falls.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(args: list[str]) -> str:
    # one thread: the suite's workers share the host's cores
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, *args], env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout


@pytest.mark.parametrize("name", ["quickstart", "reconfigure_live"])
def test_example_prints_what_the_references_prints(name):
    want = _run([str(ROOT / "examples" / f"{name}.py")])
    got = _run(["-m", f"repro_torch.examples.{name}", "--device", "cpu"])
    assert got == want
    assert got.strip()


def test_serve_decode_passes_its_assertions():
    out = _run(["-m", "repro_torch.examples.serve_decode", "--device", "cpu"])
    assert out.rstrip().endswith("example OK")


def test_train_ec_checkpoint_survives_its_crashes():
    out = _run(["-m", "repro_torch.examples.train_ec_checkpoint", "--device", "cpu", "--steps",
                "12", "--ckpt-every", "5", "--crash-at", "8"])
    assert "example OK: loss" in out and "2 quorum checkpoints" in out
