"""The port's regression battery (``gunrock_tpu_torch/examples/
regression.py``) on the CPU: every CLI of the family's list with
``--validate`` and the recorded invariants of ``datasets/expected.json``
(exact; floats within 1e-3 * max(1, |v|), the JAX battery's rule), one
family a test; and the port's lists held equal to
``datasets/regression.py``'s, which this test (not the port) loads by
path."""

import importlib.util
import json
from pathlib import Path

import pytest

from gunrock_tpu_torch.examples import regression

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_battery():
    spec = importlib.util.spec_from_file_location(
        "_jax_regression", ROOT / "datasets" / "regression.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lists_match_the_jax_battery(jax_battery):
    assert regression.FULL == jax_battery.FULL
    assert regression.DIRECTED == jax_battery.DIRECTED
    assert {k: v for k, v in regression.FAMILIES.items()} == \
        {k: v[0] for k, v in jax_battery.FAMILIES.items()}
    assert list(regression.FAMILIES) == list(jax_battery.FAMILIES)
    assert regression.DATASETS == ROOT / "datasets"
    # the JAX battery's directed families (regression.py:147)
    assert regression.DIRECTED_FAMILIES == ("rmat12", "bipartite2k")


@pytest.mark.parametrize("family", list(regression.FAMILIES))
def test_battery_passes_on_cpu(family, capsys):
    rc = regression.main(["--device", "cpu", "--families", family])
    out = capsys.readouterr().out
    assert rc == 0, out
    lines = out.strip().splitlines()
    summary = json.loads(lines[-1])["regression"]
    assert summary["failures"] == 0 and summary["device"] == "cpu"
    assert list(summary["seconds"]) == [family]
    want = json.loads(regression.EXPECTED.read_text())[family]
    assert set(summary["invariants"][family]) == set(want)
    n_clis = len(regression.DIRECTED if family in regression.DIRECTED_FAMILIES
                 else regression.FULL)
    assert sum(": ok (" in ln for ln in lines) == n_clis


@pytest.mark.parametrize("want,got,ok", [
    (3, 3, True), (3, 4, False), (100.0, 100.09, True), (100.0, 100.2, False),
    (0.5, 0.5009, True), (0.5, 0.5011, False), (1.0, None, False)])
def test_invariant_rule(want, got, ok):
    assert regression.matches(want, got) is ok


def test_a_failed_invariant_fails_the_battery(monkeypatch, capsys):
    real = regression.invariants

    def off_by_one(path, device):
        inv = real(path, device)
        inv["bfs_depth"] += 1
        return inv

    monkeypatch.setattr(regression, "invariants", off_by_one)
    assert regression.main(["--device", "cpu", "--families", "chesapeake"]) == 1
    out = capsys.readouterr().out
    assert "invariant bfs_depth: FAIL (want 2, got 3)" in out
    assert json.loads(out.strip().splitlines()[-1])["regression"]["failures"] == 1


def test_unknown_family_is_refused():
    with pytest.raises(SystemExit):
        regression.main(["--device", "cpu", "--families", "karate"])
