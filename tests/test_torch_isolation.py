"""The port stands alone: no module of ra_tpu_torch, and not
chip_smoke.py, imports jax or anything of ra_tpu, and importing the
package loads neither."""
import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(os.path.join(REPO, "ra_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_port_files_found():
    files = _port_files()
    assert len(files) >= 12
    for tail in (("engine", "lockstep.py"), ("parallel", "mesh.py"),
                 ("engine", "shards.py"), ("entry.py",)):
        assert any(f.endswith(os.path.join(*tail)) for f in files), tail


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_ra_tpu_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "ra_tpu")]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, ra_tpu_torch, ra_tpu_torch.engine, "
            "ra_tpu_torch.convert, ra_tpu_torch.ops.pallas_quorum, "
            "ra_tpu_torch.ops.commit_phase, ra_tpu_torch.engine.durable, "
            "ra_tpu_torch.wal_probe, ra_tpu_torch.models, "
            "ra_tpu_torch.ingress, ra_tpu_torch.wire, "
            "ra_tpu_torch.wire.soak, ra_tpu_torch.parallel, "
            "ra_tpu_torch.parallel.mesh, ra_tpu_torch.engine.shards, "
            "ra_tpu_torch.entry\n"
            "ra_tpu_torch.LockstepEngine, ra_tpu_torch.open_engine\n"
            "from ra_tpu_torch import native\n"
            "assert not native.IO._loaded   # no g++ at import\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ra_tpu'))\n"
            "assert not bad, bad\n"
            "assert 'ra_tpu_torch.engine.lockstep' in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
