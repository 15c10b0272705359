"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the
port's examples (``examples/torch_*.py``) import neither JAX nor the JAX
package ``repro``, and its entry points refuse to run on a CUDA device that
is not there instead of falling back to the CPU.
"""
import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
# import statements only; `repro_torch` itself must not match `repro`
FORBIDDEN = re.compile(
    r"^\s*(?:import\s+(?:jax|repro)(?![\w])|from\s+(?:jax|repro)(?![\w]))",
    re.MULTILINE)


def _port_modules():
    names = []
    for p in PORT.rglob("*.py"):
        parts = ("repro_torch",) + p.relative_to(PORT).with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__"
                              else parts))
    return sorted(names)


def _run(code):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=120)


def test_every_port_module_imports_without_jax_or_repro():
    mods = _port_modules()
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    p = _run(code)
    assert p.returncode == 0, p.stderr
    lm = {"repro_torch.configs.base", "repro_torch.dist.sharding",
          "repro_torch.layers.attention", "repro_torch.models.lm",
          "repro_torch.models.model", "repro_torch.runtime.serve_loop",
          "repro_torch.launch.serve", "repro_torch.kernels.flash_attention"}
    assert "repro_torch.sim.chip" in mods and lm <= set(mods), mods
    assert {"repro_torch.sim.fabric",
            "repro_torch.launch.pipeline"} <= set(mods), mods
    assert {"repro_torch.optim", "repro_torch.optim.optimizers",
            "repro_torch.optim.schedule", "repro_torch.data.pipeline",
            "repro_torch.runtime.train_loop",
            "repro_torch.runtime.checkpoint",
            "repro_torch.launch.train"} <= set(mods), mods
    assert {"repro_torch.launch.roofline", "repro_torch.launch.dryrun",
            "repro_torch.launch.sweep", "repro_torch.launch.perf",
            "repro_torch.launch.report"} <= set(mods), mods
    assert len(mods) >= 63, mods


def test_sources_have_no_jax_or_repro_imports():
    examples = sorted((REPO / "examples").glob("torch_*.py"))
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"] + examples
    assert len(files) >= 64 and len(examples) >= 6
    for f in files:
        hits = FORBIDDEN.findall(f.read_text())
        assert not hits, (f, hits)
    # the pattern itself is prefix-safe and catches the real thing
    assert FORBIDDEN.search("from repro.sim import VirtualChip")
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert not FORBIDDEN.search("from repro_torch.sim import VirtualChip")
    assert not FORBIDDEN.search("import repro_torch")


def test_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.paper_apps import PAPER_SPEC
    from repro_torch.core.crossbar import mlp_forward
    from repro_torch.launch import chipsim, farm, pipeline, serve, train
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import Trainer, checkpoint
    from repro_torch.sim import (ChipFarm, ChipPipeline, PipelineFarm,
                                 VirtualChip, build_farm, build_pipeline)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    layers = [{"g_plus": torch.zeros(4, 3), "g_minus": torch.zeros(4, 3)}]
    for fn in (lambda: VirtualChip(layers),
               lambda: chipsim.build_chip("kdd_anomaly"),
               lambda: mlp_forward(layers, torch.zeros(1, 4), PAPER_SPEC),
               lambda: chipsim.main(["--app", "kdd_anomaly"]),
               lambda: ChipFarm(layers),
               lambda: build_farm("kdd_anomaly", 2),
               lambda: farm.main(["--app", "kdd_anomaly"]),
               lambda: ChipPipeline(layers),
               lambda: build_pipeline("isolet_class"),
               lambda: PipelineFarm(layers),
               lambda: pipeline.main(["--app", "isolet_class"]),
               lambda: build_model(get_reduced_config("qwen2-0.5b")),
               lambda: serve.main(["--arch", "qwen2-0.5b", "--reduced"]),
               lambda: Trainer(get_reduced_config("qwen2-0.5b"),
                               adamw(1e-3)),
               lambda: train.main(["--arch", "qwen2-0.5b", "--reduced"]),
               lambda: checkpoint.restore("x", {})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()


def test_chip_smoke_fails_without_a_card_and_prints_no_result():
    p = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       capture_output=True, text=True, cwd=REPO, timeout=120)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_cli_runs_recognition_on_cpu_and_refuses_training(tmp_path, capsys):
    # training is ported now: --train-steps 0 is recognition only, the
    # default takes the reference's one step; fault flags build a faulted
    # chip (tests/test_torch_faults.py holds it against the reference)
    from repro_torch.launch import chipsim
    out = tmp_path / "rec.json"
    chipsim.main(["--app", "kdd_anomaly", "--device", "cpu", "--samples",
                  "4", "--train-steps", "0", "--json", str(out)])
    text = capsys.readouterr().out
    assert "cross-validation vs hw_model" in text
    assert "train step" not in text and "train_time" not in text
    assert out.exists()
    chipsim.main(["--device", "cpu", "--samples", "2"])
    text = capsys.readouterr().out
    assert "train step 0" in text and "train step 1" not in text
    chipsim.main(["--device", "cpu", "--stuck-off", "0.1"])
    text = capsys.readouterr().out
    assert "faults: stuck_on=0.0 stuck_off=0.1" in text
    assert "train step 0" in text
