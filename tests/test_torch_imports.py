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
    assert int(n_modules) >= 70
    assert leaked == "[]"


# the multi-process deployment's modules: telemetry, fault tolerance, the
# wire, the pipe and socket buses and ProcessRuntime
DEPLOYMENT_MODULES = [
    *(f"repro_torch.core.runtime.telemetry.{m}" for m in
      ("clock", "events", "recorder", "export", "flight", "collect")),
    "repro_torch.core.runtime.telemetry",
    "repro_torch.runtime.fault_tolerance", "repro_torch.runtime",
    *(f"repro_torch.core.runtime.transport.{m}" for m in
      ("wire", "process_bus", "socket_bus", "fleet")),
    "repro_torch.core.runtime.transport",
]
# the training slice's modules: the input pipeline, the trainer, the
# checkpoints, the launcher (and the tree helpers they share)
TRAINING_MODULES = [
    "repro_torch.utils.tree",
    "repro_torch.data.pipeline", "repro_torch.data",
    *(f"repro_torch.train.{m}" for m in
      ("optimizer", "schedule", "state", "step")),
    "repro_torch.train",
    "repro_torch.ckpt.checkpoint", "repro_torch.ckpt",
    "repro_torch.launch.train", "repro_torch.launch",
]


def test_deployment_modules_import_first_without_jax_or_reference():
    """Each module of the deployment, and of the training slice, imports
    first in a fresh interpreter (no eager import cycle), with ``jax``
    and the reference blocked, and pulls in neither."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    block = _BLOCKED_IMPORTS.split("\nimport repro_torch\n")[0]
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", block + textwrap.dedent(f"""
            import {name}
            print(sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "jaxlib", "repro")))
        """)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for name in DEPLOYMENT_MODULES + TRAINING_MODULES}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{name}: {err}"
        assert out.strip() == "[]", name


def test_runtime_exports_transport_and_telemetry_lazily():
    """``repro_torch.core.runtime`` resolves ``transport`` and
    ``telemetry`` on first use and loads neither when imported; the
    ``repro_torch.telemetry`` names are the telemetry package's."""
    proc = _run(textwrap.dedent("""
        import sys
        import repro_torch.core.runtime as rt
        print(sorted(m for m in sys.modules
                     if m.startswith("repro_torch.core.runtime.")))
        import repro_torch.core.runtime.telemetry.recorder as rec
        import repro_torch.core.runtime.transport.fleet as fleet
        import repro_torch.telemetry as shim
        print(rt.transport.ProcessRuntime is fleet.ProcessRuntime,
              rt.telemetry.active is rec.active is shim.active,
              shim.NullRecorder is rec.NullRecorder,
              {"transport", "telemetry"} <= set(dir(rt)),
              isinstance(shim.active(), rec.NullRecorder))
    """))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[:2] == ["[]", "True True True True True"]


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


def test_core_reexports_the_references_names():
    """``repro_torch.core`` exports the reference's names, each the object
    of the submodule that defines it."""
    import importlib

    import repro.core
    import repro_torch.core as core
    assert core.__all__ == repro.core.__all__
    subs = [importlib.import_module(f"repro_torch.core.{m}") for m in
            ("policy", "metrics", "snapshot", "rpc_tuner", "cache_tuner",
             "controller", "policies")]
    for name in core.__all__:
        owners = [m for m in subs if name in vars(m)]
        assert owners and getattr(core, name) is vars(owners[0])[name]
    assert set(core.__all__) <= set(dir(core))
    try:
        core.no_such_name
    except AttributeError as e:
        assert "no_such_name" in str(e)
    else:
        raise AssertionError("a missing name must raise AttributeError")


def test_kernel_import_leaves_the_policy_stack_unloaded():
    """The re-exports load lazily: importing the GBDT kernels, or the model
    package, loads no policy (the policy stack imports the kernels)."""
    proc = _run(textwrap.dedent("""
        import sys
        import repro_torch.kernels.gbdt_infer
        import repro_torch.core.ml
        print(sorted(m for m in sys.modules
                     if m.startswith(("repro_torch.core.policies",
                                      "repro_torch.core.ml.dataset"))))
        from repro_torch.core import CaratPolicy  # noqa: F401
        print("repro_torch.core.policies.carat" in sys.modules)
    """))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[:2] == ["[]", "True"]
