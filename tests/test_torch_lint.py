"""The protocol-invariant lint packs over repro_torch: the port's own, and the reference's.

``repro_torch.analysis.invariants`` holds the port's copy of the rule pack
(``MODULE_RULES``: assert ban, determinism, set iteration, ``_StateMap``
bypass; ``REPO_RULES``: registry drift between the server's handlers, the
codec's registries and the gateway's gossip vocabulary). It must come back
clean over the port's own tree, gateway included, and so must the
reference's pack (``repro.analysis.invariants``), since the port's
protocol modules are copies of the reference's.
"""
import shutil
from pathlib import Path

import pytest

from repro.analysis import astlint as ref_astlint
from repro.analysis import invariants as ref_invariants
from repro_torch.analysis import astlint, invariants

ROOT = Path(__file__).resolve().parents[1] / "src"
PORT = ROOT / "repro_torch"
PACKS = {"port": (astlint, invariants), "reference": (ref_astlint, ref_invariants)}


@pytest.mark.parametrize("pack", list(PACKS))
def test_module_rules_clean_over_port(pack):
    lint, rules = PACKS[pack]
    findings = lint.run_rules(PORT, rules.MODULE_RULES)
    assert findings == [], "\n".join(map(str, findings))


@pytest.mark.parametrize("pack", list(PACKS))
def test_registry_drift_clean_over_port(pack):
    """The server handlers, the codec registries and the gateway's gossip
    vocabulary are all the port's own."""
    lint, rules = PACKS[pack]
    findings = lint.run_rules(PORT, (), rules.REPO_RULES, check_waivers=False)
    assert findings == [], "\n".join(map(str, findings))


def _drifted_copy(tmp_path: Path) -> Path:
    for rel in ("core/server.py", "core/gateway.py", "net/codec.py"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(PORT / rel, tmp_path / rel)
    codec = tmp_path / "net" / "codec.py"
    text = codec.read_text()
    assert '"ec-repair-push",' in text
    codec.write_text(text.replace('"ec-repair-push",', "", 1))
    return tmp_path


@pytest.mark.parametrize("pack", list(PACKS))
def test_registry_drift_sees_a_port_drift(pack, tmp_path):
    """The check above is live: a handler the codec does not list is found."""
    lint, rules = PACKS[pack]
    findings = lint.run_rules(_drifted_copy(tmp_path), (), rules.REPO_RULES,
                              check_waivers=False)
    assert any("ec-repair-push" in f.message for f in findings)


def test_gossip_drift_in_the_ports_gateway_is_seen(tmp_path):
    """The registry-drift rule reads the port's own gateway: a gossip reply
    tag renamed there alone is a finding."""
    root = _drifted_copy(tmp_path)
    shutil.copy(PORT / "net" / "codec.py", root / "net" / "codec.py")
    gw = root / "core" / "gateway.py"
    text = gw.read_text()
    assert '"gossip-ack"' in text
    gw.write_text(text.replace('"gossip-ack"', '"gossip-ack2"'))
    findings = astlint.run_rules(root, (), invariants.REPO_RULES, check_waivers=False)
    assert any("gossip-ack2" in f.message for f in findings)
