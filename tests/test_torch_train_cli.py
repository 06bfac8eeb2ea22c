"""The port's training entry points on the CPU: ``examples/quickstart_torch.py``
run short, and ``python -m repro_torch.launch.train``, whose resumed run
must end bit-identical to an uninterrupted one; ``--watchdog-s`` arms the
step watchdog around each step, which stays quiet on a healthy step and
prints the reference's ``[watchdog] step hung`` on a slow one. Without a
card and without ``--device`` the launcher raises. ``--mesh 2x1`` runs on
two ranks under ``torchrun`` (gloo on the CPU), held against ``--mesh
1x1``; a mesh larger than the world raises."""
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one thread each, so the suite's parallel workers do not
# oversubscribe the cores that timing-sensitive tests share with them
torch.set_num_threads(1)

from repro_torch.core import LayerStore  # noqa: E402
from repro_torch.launch import train  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = ["--arch", "yi-6b", "--smoke", "--device", "cpu", "--batch", "2",
         "--seq", "16", "--ckpt-every", "2"]


def test_quickstart_runs_short_on_the_cpu():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "quickstart_torch.py"),
         "--device", "cpu", "--steps", "4", "--batch", "2", "--seq", "16",
         "--save-every", "2"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[ckpt] step 2: injected=0" in proc.stdout
    assert "[ckpt] step 4: injected=4" in proc.stdout
    assert "quickstart OK" in proc.stdout


def _payload(root, step):
    return LayerStore(root).load_image_payload("ckpt", f"step-{step:08d}")


def test_resumed_run_ends_bit_identical_to_an_uninterrupted_one(tmp_path,
                                                                capsys):
    resumed, straight = str(tmp_path / "resumed"), str(tmp_path / "straight")
    train.main(SMOKE + ["--ckpt", resumed, "--steps", "4"])
    assert "resumed" not in capsys.readouterr().out
    train.main(SMOKE + ["--ckpt", resumed, "--steps", "6"])
    assert "[train] resumed from step 4" in capsys.readouterr().out
    train.main(SMOKE + ["--ckpt", straight, "--steps", "6"])
    got, want = _payload(resumed, 6), _payload(straight, 6)
    assert sorted(got) == sorted(want)
    assert int(got["opt/step"]) == 6 and int(got["opt/__step__"][0]) == 6
    for name in want:
        assert got[name].dtype == want[name].dtype and \
            torch.equal(got[name], want[name]), name
    # retention kept the reference's default three step tags
    assert LayerStore(resumed).list_tags("ckpt") == \
        [f"step-{s:08d}" for s in (2, 4, 6)]


def test_launcher_without_a_card_refuses_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "yi-6b", "--smoke", "--steps", "1"])


_F32_LAUNCHER = """
import sys
from repro_torch.launch import train
smoke = train.get_smoke_config
train.get_smoke_config = lambda arch: smoke(arch).replace(
    param_dtype="float32", compute_dtype="float32")
train.main(sys.argv[1:])
"""


def _losses(out):
    return [float(ln.split("loss=")[1].split()[0]) for ln in out.splitlines()
            if ln.startswith("[train] step ")]


def _torchrun(tmp_path, args):
    script = tmp_path / "launch_f32.py"
    script.write_text(_F32_LAUNCHER)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(script)] + SMOKE + args,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_mesh_2x1_under_torchrun_matches_1x1_and_resumes(tmp_path, capsys,
                                                         monkeypatch):
    """``--mesh 2x1 --device cpu`` on two torchrun ranks, f32: the losses of
    ``--mesh 1x1`` (to the print's 4 decimals) and its checkpointed state
    within 1e-5 relative per leaf; rank 0 alone prints and writes one
    image a save; the resumed run ends bit-identical to an uninterrupted
    one."""
    smoke = train.get_smoke_config
    monkeypatch.setattr(train, "get_smoke_config", lambda arch: smoke(
        arch).replace(param_dtype="float32", compute_dtype="float32"))
    one = str(tmp_path / "one")
    train.main(SMOKE + ["--ckpt", one, "--steps", "4", "--mesh", "1x1"])
    want = _losses(capsys.readouterr().out)
    resumed, straight = str(tmp_path / "resumed"), str(tmp_path / "straight")
    out = _torchrun(tmp_path, ["--mesh", "2x1", "--ckpt", resumed,
                               "--steps", "4"])
    got = _losses(out)
    assert len(got) == len(want) == 4 and out.count("[train] 4 steps") == 1
    assert np.allclose(got, want, rtol=0, atol=5e-5), (got, want)
    w4, g4 = _payload(one, 4), _payload(resumed, 4)
    assert sorted(w4) == sorted(g4)
    for name in w4:
        a, b = g4[name].double(), w4[name].double()
        assert float((a - b).abs().max()) <= \
            1e-5 * max(float(b.abs().max()), 1e-30), name
    out = _torchrun(tmp_path, ["--mesh", "2x1", "--ckpt", resumed,
                               "--steps", "6"])
    assert out.count("[train] resumed from step 4") == 1
    _torchrun(tmp_path, ["--mesh", "2x1", "--ckpt", straight, "--steps", "6"])
    got, want = _payload(resumed, 6), _payload(straight, 6)
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    store = LayerStore(resumed)
    assert store.list_tags("ckpt") == [f"step-{s:08d}" for s in (2, 4, 6)]
    assert store.verify_image("ckpt", "step-00000006", deep=True) == []


def test_mesh_larger_than_the_world_raises():
    with pytest.raises((RuntimeError, ValueError), match="ranks"):
        train.main(SMOKE + ["--steps", "1", "--mesh", "2x1"])


class _CountingWatchdog(train.Watchdog):
    armed = []

    def arm(self):
        _CountingWatchdog.armed.append(self.timeout)
        super().arm()


def test_watchdog_is_armed_each_step_and_stays_quiet(monkeypatch, capsys):
    _CountingWatchdog.armed = []
    monkeypatch.setattr(train, "Watchdog", _CountingWatchdog)
    train.main(SMOKE + ["--steps", "3", "--watchdog-s", "60"])
    out = capsys.readouterr().out
    assert _CountingWatchdog.armed == [60.0] * 3
    assert "[train] 3 steps in" in out and "[watchdog]" not in out


def _slowed(make_step):
    def slow_make_step(*args, **kw):
        bundle = make_step(*args, **kw)
        fn = bundle.fn

        def step(*a):
            time.sleep(0.5)
            return fn(*a)
        bundle.fn = step
        return bundle
    return slow_make_step


def test_watchdog_reports_a_hung_step_as_the_reference_does(monkeypatch,
                                                            capsys):
    """Each launcher's step slowed to 0.5 s past a 0.05 s watchdog: both
    print the same one report."""
    from repro.launch import train as jax_train
    monkeypatch.setattr(train, "make_train_step",
                        _slowed(train.make_train_step))
    monkeypatch.setattr(jax_train, "make_train_step",
                        _slowed(jax_train.make_train_step))
    flags = ["--steps", "1", "--watchdog-s", "0.05"]
    train.main(SMOKE + flags)
    port = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["train"] + [
        a for a in SMOKE if a not in ("--device", "cpu")] + flags)
    jax_train.main()
    ref = capsys.readouterr().out.splitlines()
    assert [ln for ln in port if "[watchdog]" in ln] == \
        [ln for ln in ref if "[watchdog]" in ln] == ["[watchdog] step hung"]
    assert any(ln.startswith("[train] 1 steps in") for ln in port)
