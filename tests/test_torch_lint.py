"""The reference's protocol-invariant lint pack, run over repro_torch.

``repro.analysis.invariants`` holds the rule pack (``MODULE_RULES``:
assert ban, determinism, set iteration, ``_StateMap`` bypass; ``REPO_RULES``:
registry drift between the server's handlers, the codec's registries and
the gateway's gossip vocabulary). The port's protocol modules are copies of
the reference's, so the pack must come back clean over them.
"""
import shutil
from pathlib import Path

from repro.analysis import astlint, invariants

ROOT = Path(__file__).resolve().parents[1] / "src"
PORT = ROOT / "repro_torch"


def test_module_rules_clean_over_port():
    findings = astlint.run_rules(PORT, invariants.MODULE_RULES)
    assert findings == [], "\n".join(map(str, findings))


def test_registry_drift_clean_over_port(tmp_path):
    """The gateway tier is not ported yet, so its gossip vocabulary comes
    from the reference's ``core/gateway.py``; the server handlers and codec
    registries are the port's own."""
    for rel in ("core/server.py", "net/codec.py"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(PORT / rel, tmp_path / rel)
    shutil.copy(ROOT / "repro" / "core" / "gateway.py", tmp_path / "core" / "gateway.py")
    findings = astlint.run_rules(tmp_path, (), invariants.REPO_RULES, check_waivers=False)
    assert findings == [], "\n".join(map(str, findings))


def test_registry_drift_sees_a_port_drift(tmp_path):
    """The check above is live: a handler the codec does not list is found."""
    for rel in ("core/server.py", "net/codec.py"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(PORT / rel, tmp_path / rel)
    shutil.copy(ROOT / "repro" / "core" / "gateway.py", tmp_path / "core" / "gateway.py")
    codec = tmp_path / "net" / "codec.py"
    text = codec.read_text()
    assert '"ec-repair-push",' in text
    codec.write_text(text.replace('"ec-repair-push",', "", 1))
    findings = astlint.run_rules(tmp_path, (), invariants.REPO_RULES, check_waivers=False)
    assert any("ec-repair-push" in f.message for f in findings)
