"""The port stands alone: no module of ra_tpu_torch, and not
chip_smoke.py, imports jax, anything of ra_tpu or the test suite
(``tests.*``), and importing the package loads none of them."""
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
                 ("engine", "shards.py"), ("entry.py",),
                 ("core", "types.py"), ("core", "aux.py"),
                 ("core", "server.py"), ("utils", "flru.py"), ("codec.py",),
                 ("log", "snapshot.py"), ("log", "memory.py"),
                 ("log", "segment.py"), ("log", "durable.py"),
                 ("machines.py",), ("machine_ets.py",), ("node.py",),
                 ("directory.py",), ("system.py",), ("api.py",),
                 ("models", "kv.py"), ("models", "fifo.py"),
                 ("models", "queue.py"), ("placement", "table.py"),
                 ("placement", "supervisor.py"), ("placement", "host.py"),
                 ("placement", "fabric.py"), ("placement", "soak.py"),
                 ("placement", "__init__.py"), ("placement", "geo.py"),
                 ("transport", "tcp.py"),
                 ("models", "fifo_client.py"), ("dbg.py",)):
        assert any(f.endswith(os.path.join(*tail)) for f in files), tail


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_ra_tpu_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "ra_tpu", "tests")]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, ra_tpu_torch, ra_tpu_torch.engine, "
            "ra_tpu_torch.convert, ra_tpu_torch.ops.pallas_quorum, "
            "ra_tpu_torch.ops.commit_phase, ra_tpu_torch.engine.durable, "
            "ra_tpu_torch.wal_probe, ra_tpu_torch.models, "
            "ra_tpu_torch.ingress, ra_tpu_torch.wire, "
            "ra_tpu_torch.wire.soak, ra_tpu_torch.parallel, "
            "ra_tpu_torch.parallel.mesh, ra_tpu_torch.engine.shards, "
            "ra_tpu_torch.entry, ra_tpu_torch.core.server, "
            "ra_tpu_torch.log.durable, ra_tpu_torch.node, "
            "ra_tpu_torch.system, ra_tpu_torch.api, ra_tpu_torch.machines, "
            "ra_tpu_torch.machine_ets, ra_tpu_torch.directory, "
            "ra_tpu_torch.codec, ra_tpu_torch.transport.rpc, "
            "ra_tpu_torch.placement, ra_tpu_torch.utils, "
            "ra_tpu_torch.transport.tcp, ra_tpu_torch.models.fifo_client, "
            "ra_tpu_torch.dbg, ra_tpu_torch.placement.geo\n"
            "ra_tpu_torch.LockstepEngine, ra_tpu_torch.open_engine\n"
            "ra_tpu_torch.RaNode, ra_tpu_torch.RaSystem, ra_tpu_torch.aux, "
            "ra_tpu_torch.start_cluster, ra_tpu_torch.KvMachine\n"
            "from ra_tpu_torch import native\n"
            "assert not native.IO._loaded   # no g++ at import\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ra_tpu', 'tests', 'nemesis'))\n"
            "assert not bad, bad\n"
            "assert 'ra_tpu_torch.engine.lockstep' in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_import_alone_loads_only_the_package_file():
    """``import ra_tpu_torch`` loads nothing but its own ``__init__``: no
    torch, no submodule, no compiler; the classic entry points are named
    in its lazy exports."""
    code = ("import sys, ra_tpu_torch as t\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'ra_tpu') or m.startswith('ra_tpu_torch.'))\n"
            "assert not bad, bad\n"
            "want = {'RaNode', 'LocalRouter', 'RaSystem', 'Directory', "
            "'start_cluster', 'process_command', 'consistent_query', "
            "'add_member', 'remove_member', 'restart_server', 'aux'}\n"
            "assert want <= set(t.__all__), want - set(t.__all__)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_tcp_frames_load_through_convert():
    """The TCP receive path unpickles every frame through
    ``convert.loads`` (so a reference process's frame reads as the port's
    classes); no plain ``pickle.load``/``loads`` is left in it."""
    path = os.path.join(REPO, "ra_tpu_torch", "transport", "tcp.py")
    calls = [(n.func.value.id, n.func.attr)
             for n in ast.walk(ast.parse(open(path).read(), path))
             if isinstance(n, ast.Call) and
             isinstance(n.func, ast.Attribute) and
             isinstance(n.func.value, ast.Name)]
    assert not [c for c in calls if c[0] == "pickle" and
                c[1] in ("load", "loads")], calls
    src = open(path).read()
    assert "from ..convert import loads as _wire_loads" in src
    assert src.count("_wire_loads(frame[1:])") == 6
