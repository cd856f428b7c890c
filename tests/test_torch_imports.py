"""The port stands alone: with ``jax`` and the reference package blocked,
every ``repro_torch`` module and ``chip_smoke.py`` import, and neither
pulls in ``jax`` or ``repro``. ``chip_smoke.py`` also refuses to run,
printing no result, where there is no CUDA device."""
import json
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORTS = textwrap.dedent("""
    import importlib, pkgutil, sys

    class _Block:
        # a meta-path finder consulted before the real ones (find_spec:
        # the hook Python 3.12 still calls)
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, _Block())
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke  # noqa: F401
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    print(len(names), leaked)
""")


def _run(code, cwd=REPO, **env):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src") + ":"
             + REPO, **env})


def test_port_imports_without_jax_or_reference():
    proc = _run(_BLOCKED_IMPORTS)
    assert proc.returncode == 0, proc.stderr
    n_modules, leaked = proc.stdout.strip().split(" ", 1)
    assert int(n_modules) >= 25
    assert leaked == "[]"


def test_chip_smoke_fails_without_cuda(tmp_path):
    """No CUDA device: exit code 1 and no result line, both in the repo
    and in a directory that holds only the script."""
    hide = {"CUDA_VISIBLE_DEVICES": ""}
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
    for script, cwd in ((os.path.join(REPO, "chip_smoke.py"), REPO),
                        (str(alone), str(tmp_path))):
        proc = subprocess.run([sys.executable, script], cwd=cwd,
                              capture_output=True, text=True, timeout=300,
                              env={**os.environ, **hide,
                                   "PYTHONPATH": ""})
        assert proc.returncode != 0
        for line in proc.stdout.splitlines():
            assert '"ok"' not in line
            json.loads(line)   # whatever it printed is a phase line
