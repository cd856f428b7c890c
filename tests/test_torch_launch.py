"""The port's training launcher (``repro_torch.launch.train``) and its
example (``examples/train_lm_with_carat_torch.py``) on the CPU, a few
steps each: the reference's flags, its last line, a checkpoint, the
pipeline's decisions. The CARAT pair is the committed one
(``default_models``; ``tests/test_torch_ml.py`` holds
``get_default_models`` byte-equal to it), so no test retrains it."""
import os
import re
import runpy

import pytest
import torch

import repro_torch.launch.train as launch
from repro_torch.core.ml.gbdt import default_models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's last line (repro/launch/train.py)
LAST = re.compile(r"^final_loss=(\S+) input_wait_s=(\S+) pfs_MBps=(\S+) "
                  r"decisions=(\d+)$")


@pytest.fixture(autouse=True)
def committed_models(monkeypatch):
    monkeypatch.setattr(launch, "get_default_models", default_models)


def _last_line(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    match = LAST.match(lines[-1])
    assert match, lines[-1]
    return match


@pytest.mark.parametrize("carat", [True, False])
def test_main_prints_the_references_last_line(tmp_path, capsys, carat):
    argv = ["--steps", "3", "--device", "cpu", "--sample-kb", "2048",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    run = launch.main(argv + ([] if carat else ["--no-carat"]))
    loss, wait, mbps, decisions = _last_line(capsys).groups()
    assert float(loss) == pytest.approx(run.losses[-1], abs=5e-5)
    assert float(wait) == pytest.approx(sum(run.waits_s), abs=5e-3)
    assert float(mbps) > 0.0
    assert int(decisions) == sum(len(c.decisions)
                                 for c in run.pipeline.controllers)
    assert len(run.pipeline.controllers) == (4 if carat else 0)
    assert len(run.losses) == len(run.compute_s) == 3
    assert all(c > 0.0 for c in run.compute_s)
    assert int(run.state["step"]) == 3
    assert run.model.cfg.name == "granite-3-2b-smoke"
    # remat "dots" and float32 weights, as the reference's launcher
    assert run.model.dtype == torch.float32
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000003"]


def test_main_defaults_to_cuda(tmp_path):
    argv = ["--steps", "1", "--no-carat", "--ckpt-dir", str(tmp_path)]
    if torch.cuda.is_available():
        assert launch.main(argv).model.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            launch.main(argv)


def test_example_runs_carat_off_then_on(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", [
        "train_lm_with_carat_torch.py", "--steps", "2", "--device", "cpu",
        "--ckpt-root", str(tmp_path)])
    runpy.run_path(os.path.join(REPO, "examples",
                                "train_lm_with_carat_torch.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    lines = [m for m in map(LAST.match, out.splitlines()) if m]
    assert len(lines) == 2
    assert int(lines[0].group(4)) == 0          # CARAT off: no decisions
    assert sorted(os.listdir(tmp_path)) == ["ck_off", "ck_on"]
