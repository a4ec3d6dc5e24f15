"""No run loads JAX or the JAX package; top-level names compare whole."""

import subprocess
import sys
import textwrap

from portbench import manifest


def test_banned_names_compare_whole(monkeypatch):
    sys.path.insert(0, str(manifest.HERE))
    try:
        import run
    finally:
        sys.path.remove(str(manifest.HERE))
    monkeypatch.setitem(sys.modules, "gunrock_tpu_torch.fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    monkeypatch.delitem(sys.modules, "gunrock_tpu", raising=False)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "jaxlib", raising=False)
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "gunrock_tpu.graph", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.banned_modules() == ["gunrock_tpu", "jax"]


def test_a_whole_cell_loads_no_jax():
    """A cell driven end to end on the CPU, in a fresh process."""
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(manifest.ROOT)!r}, {str(manifest.HERE)!r}]
        sys.path.insert(0, {str(manifest.HERE / 'tests')!r})
        import run
        from conftest import small_configs
        from portbench.cell import Cell
        cfgs = small_configs()
        for name in cfgs:
            cell = Cell(name, 5, "cpu", config=cfgs[name])
            result, _ = run.measure(cell, 0.05, False)
            assert result["correct"], (name, result)
        print(run.banned_modules())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
