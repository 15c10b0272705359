"""The port's training loop and its launchers on the CPU: ``Trainer.run``
and its hooks (history, watchdog, fault injector, step timer) against the
reference's statements, ``repro_torch.launch.train --reduced --device
cpu``, ``examples/torch_quickstart.py --device cpu``, ``launch.serve
--ckpt-dir`` serving what a checkpoint restores, and the meshed forms
(``Trainer(mesh=)``, ``param_shardings=``, ``--mesh host``) equal to the
unmeshed ones.

Tolerances: none.  The watchdog's and injector's decisions are exact;
served tokens are compared with a server on the same restored parameters
in the same process; a meshed step runs the unmeshed step's operations on
the same device.
"""
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.runtime import faults as jfaults  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.dist.sharding import (make_rules,  # noqa: E402
                                       named_shardings, tree_leaves)
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw, make_optimizer, sgd  # noqa: E402
from repro_torch.runtime import (BatchedServer, FaultInjector,  # noqa: E402
                                 SimulatedPreemption, StragglerWatchdog,
                                 Trainer, checkpoint as ckpt)
from repro_torch.runtime import train_loop  # noqa: E402
from repro_torch.runtime.faults import StepTimer  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen2-0.5b"


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO / "src"))


def test_trainer_run_history_and_descent():
    cfg = get_reduced_config(ARCH)
    trainer = Trainer(cfg, adamw(3e-3), device="cpu")
    state, hist = trainer.run(TokenStream(cfg.vocab_size, 32, 4, seed=0), 12,
                              log_every=100)
    assert state.step == 12 and [h["step"] for h in hist] == list(
        range(1, 13))
    assert set(hist[0]) == {"loss", "ce", "aux", "grad_norm", "step",
                            "time_s", "straggler"}
    assert all(isinstance(h["loss"], float) and h["aux"] == 0.0
               and h["ce"] == h["loss"] and h["grad_norm"] > 0
               and h["time_s"] > 0 for h in hist)
    assert hist[-1]["loss"] < hist[0]["loss"]


@pytest.mark.parametrize("optimizer", ["sgd", "pulse_sgd"])
def test_trainer_takes_every_optimizer(optimizer):
    cfg = get_reduced_config(ARCH, crossbar=True)
    trainer = Trainer(cfg, make_optimizer(optimizer, 0.05), device="cpu")
    state, hist = trainer.run(TokenStream(cfg.vocab_size, 16, 2), 3,
                              log_every=100)
    assert state.step == 3 and len(hist) == 3
    if optimizer == "pulse_sgd":    # the conductance pairs stay in range
        for k in ("g_plus", "g_minus"):
            g = state.params["stack"]["b0_attn"]["attn"]["wq"][k]
            assert float(g.min()) >= 0.0 and float(g.max()) <= 4.0


def test_trainer_batch_fn_and_injector():
    cfg = get_reduced_config(ARCH)
    stream = TokenStream(cfg.vocab_size, 16, 2, seed=4)
    seen = []

    def batch_fn(step):
        seen.append(step)
        return stream.batch_at(step)

    trainer = Trainer(cfg, sgd(0.01), device="cpu",
                      fault_injector=FaultInjector(preempt_at_step=2))
    with pytest.raises(SimulatedPreemption, match="step 2"):
        trainer.run(stream, 5, batch_fn=batch_fn, log_every=100)
    assert seen == [0, 1]


def test_meshed_forms_raise():
    """The meshed forms work and equal the unmeshed ones: a step with
    ``param_shardings`` and a ``Trainer`` on a host mesh folded onto the
    CPU, bit for bit; a mesh on another device than the one asked for
    raises."""
    cfg = get_reduced_config(ARCH)
    mesh = make_host_mesh(device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        Trainer(cfg, sgd(0.1), mesh=mesh, device="meta")
    model = build_model(cfg, "cpu")
    shardings = named_shardings(model.spec, make_rules(mesh), mesh)
    batch = TokenStream(cfg.vocab_size, 16, 2, seed=3).batch_at(0)
    runs = []
    for kw in ({}, {"param_shardings": shardings}):
        params = model.init(torch.Generator().manual_seed(0))
        opt = sgd(0.1)
        step = train_loop.make_train_step(model, opt, **kw)
        runs.append(step(params, opt.init(params), batch, 0))
    for a, b in zip(tree_leaves(runs[0]), tree_leaves(runs[1])):
        assert torch.equal(a, b)
    stream = TokenStream(cfg.vocab_size, 16, 2, seed=3)
    plain, ph = Trainer(cfg, sgd(0.1), device="cpu").run(stream, 2,
                                                        log_every=100)
    trainer = Trainer(cfg, sgd(0.1), mesh=mesh)
    assert trainer.device.type == "cpu" and trainer.rules == make_rules(mesh)
    meshed, mh = trainer.run(stream, 2, log_every=100)
    assert [h["loss"] for h in ph] == [h["loss"] for h in mh]
    for a, b in zip(tree_leaves((plain.params, plain.opt_state)),
                    tree_leaves((meshed.params, meshed.opt_state))):
        assert a.device.type == "cpu" and torch.equal(a, b)


def test_watchdog_and_injector_match_reference():
    times = [1.0] * 9 + [3.5, 1.0, 2.9, 1.1] + [0.5] * 40 + [10.0]
    ours, ref = StragglerWatchdog(), jfaults.StragglerWatchdog()
    flags = [ours.observe(i, dt) for i, dt in enumerate(times)]
    assert flags == [ref.observe(i, dt) for i, dt in enumerate(times)]
    assert ours.events == ref.events and len(ours.events) == 2
    short = StragglerWatchdog()
    assert not any(short.observe(i, 100.0 * i) for i in range(7))
    for inj in (FaultInjector(3), jfaults.FaultInjector(3)):
        inj.check(2)
        with pytest.raises(Exception, match="simulated preemption at step 3"):
            inj.check(3)
    FaultInjector().check(0)
    assert issubclass(SimulatedPreemption, Exception)


def test_step_timer_on_the_cpu():
    with StepTimer("cpu") as t:
        sum(range(10000))
    assert t.dt > 0 and not t.cuda
    with StepTimer() as t2:
        pass
    assert t2.dt >= 0


def test_train_cli_on_cpu(tmp_path):
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--steps", "6", "--batch", "2",
         "--seq", "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"],
        capture_output=True, text=True, cwd=REPO, env=_env(), timeout=300)
    assert p.returncode == 0, p.stderr
    last = p.stdout.strip().splitlines()[-1]
    assert last.startswith("final step 6: loss ") and "(first " in last
    assert ckpt.latest_step(str(tmp_path)) == 6
    meshed = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--mesh", "host", "--steps", "3",
         "--batch", "2", "--seq", "32"],
        capture_output=True, text=True, cwd=REPO, env=_env(), timeout=300)
    assert meshed.returncode == 0, meshed.stderr
    assert meshed.stdout.strip().splitlines()[-1].startswith(
        "final step 3: loss ")


def test_quickstart_example_on_cpu(tmp_path):
    p = subprocess.run(
        [sys.executable, str(REPO / "examples" / "torch_quickstart.py"),
         "--device", "cpu", "--steps", "8", "--batch", "2", "--seq", "32",
         "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, cwd=tmp_path, env=_env(),
        timeout=300)
    assert p.returncode == 0, p.stderr
    out = p.stdout.strip().splitlines()
    assert out[0].startswith("arch=qwen2-0.5b-reduced params=")
    assert out[1].startswith("loss: ") and "over 8 steps" in out[1]
    assert out[2].startswith("sample generations: [[")


def test_serve_cli_serves_a_checkpoint(tmp_path, capsys, monkeypatch):
    for flag in ("allow_tf32",):      # serve.main sets the TF32 flags
        monkeypatch.setattr(torch.backends.cuda.matmul, flag,
                            getattr(torch.backends.cuda.matmul, flag))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                        torch.backends.cudnn.allow_tf32)
    cfg = get_reduced_config(ARCH)
    state, _ = Trainer(cfg, adamw(3e-3), ckpt_dir=str(tmp_path),
                       ckpt_every=4, device="cpu").run(
        TokenStream(cfg.vocab_size, 32, 4, seed=0), 4, log_every=100)
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--ckpt-dir", str(tmp_path), "--max-new", "6"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "restored params from step 4"
    # the served tokens are those of the trained parameters
    server = BatchedServer(build_model(cfg, "cpu"), state.params, batch=4,
                           max_len=256)
    prompts = [[1 + (i * 7 + j) % (cfg.vocab_size - 1) for j in range(8)]
               for i in range(4)]
    outs = server.generate(prompts, 6)
    for i, o in enumerate(outs):
        assert lines[1 + i] == f"req{i}: {o[:16]}"
    fresh = BatchedServer(build_model(cfg, "cpu"),
                          build_model(cfg, "cpu").init(
                              torch.Generator().manual_seed(0)),
                          batch=4, max_len=256).generate(prompts, 6)
    assert fresh != outs
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(state.params), tree_leaves(ckpt.restore(
            str(tmp_path), {"params": state.params, "opt": None},
            device="cpu")[0]["params"])))
