"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports jax or the JAX package, and the entry points
run on the card unless the caller asks for the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import get_arch
from repro_torch.core.federated import (FederatedConfig, encode_state,
                                        federated_round)
from repro_torch.core.zampling import (ZamplingConfig, build_specs,
                                       sample_weights)
from repro_torch.launch import train as lm_train
from repro_torch.models.mlp import (SMALL_DIMS, mlp_accuracy, mlp_loss,
                                    mlp_template)
from repro_torch.models.model import build_model, param_template
from repro_torch.train import evaluate, federated_fit
from repro_torch.serve import (ServeConfig, ServeScheduler,
                               build_serve_engine, make_serve_state,
                               serve_generate)

ROOT = Path(__file__).resolve().parent.parent

_BLOCKED = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
"""


def _modules():
    pkg = Path(repro_torch.__file__).parent
    mods = []
    for f in sorted(pkg.rglob("*.py")):
        parts = f.relative_to(pkg.parent).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def test_every_module_and_chip_smoke_import_without_jax():
    mods = _modules()
    for m in ("kernels.qz_decode", "kernels.qz_reconstruct", "kernels.nvcc",
              "core.federated", "core.reconstruct", "core.transpose_plan",
              "comm.bitpack", "comm.protocol", "comm.metering",
              "train.fit", "train.local", "data.synthetic",
              "data.federated_split", "models.mlp", "configs.mnistfc",
              "optim.optimizers", "device", "launch.train",
              "models.model", "models.common", "models.attention"):
        assert f"repro_torch.{m}" in mods
    code = _BLOCKED + "\n".join(
        ["import importlib", f"sys.path.insert(0, {str(ROOT)!r})"]
        + [f"importlib.import_module({m!r})" for m in mods]
        + ["import chip_smoke",
           "assert not any(k.split('.')[0] in ('jax', 'repro') "
           "for k in sys.modules)", "print('ok')"])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _tiny_state():
    cfg = get_arch("qwen2-0.5b").reduced()
    zspecs = build_specs(param_template(cfg),
                         ZamplingConfig(compression=8, d=8, min_size=1024))
    rng = np.random.RandomState(0)
    state = {"scores": {p: rng.rand(s.n).astype(np.float32)
                        for p, s in zspecs.specs.items()},
             "dense": {p: np.ones(zspecs.template[p].shape, np.float32)
                       for p in zspecs.dense_paths}}
    return cfg, zspecs, state


def test_entry_points_default_to_the_card():
    cfg, zspecs, state = _tiny_state()
    model = build_model(cfg)
    cpu_state = make_serve_state(zspecs, state, 2, downlink="u8",
                                 device="cpu")
    calls = [
        lambda: make_serve_state(zspecs, state, 2, downlink="u8"),
        lambda: build_serve_engine(model, cpu_state),
        lambda: ServeScheduler(model, cpu_state,
                               ServeConfig(mode="streaming")),
        lambda: serve_generate(model, cpu_state, [[1, 2]], 1),
    ]
    if torch.cuda.is_available():
        # with a card, the default is the card: a CPU state is refused
        with pytest.raises(ValueError, match="lives on"):
            calls[1]()
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_training_entry_points_default_to_the_card():
    zspecs = build_specs(mlp_template(SMALL_DIMS), ZamplingConfig(
        compression=8, d=10, window=128, min_size=128))
    rng = np.random.RandomState(0)
    state = {"scores": {p: rng.rand(s.n).astype(np.float32)
                        for p, s in zspecs.specs.items()},
             "dense": {p: np.zeros(zspecs.template[p].shape, np.float32)
                       for p in zspecs.dense_paths}}
    cfg = FederatedConfig(num_clients=2, local_steps=1, aggregate="psum_u32",
                          downlink="u8")
    x = rng.randn(2, 1, 4, 784).astype(np.float32)
    y = rng.randint(0, 10, (2, 1, 4)).astype(np.int32)
    test = {"x": torch.from_numpy(x[0, 0]), "y": torch.from_numpy(y[0, 0])}
    calls = [
        lambda: encode_state(zspecs, cfg, state),
        lambda: sample_weights(zspecs, state, 3),
        lambda: federated_round(zspecs, state, mlp_loss, {"x": x, "y": y}, 1,
                                cfg),
        lambda: federated_fit(zspecs, state, mlp_loss,
                              {"x": x[None], "y": y[None]}, [1], cfg),
        lambda: evaluate(zspecs, state, lambda p: mlp_accuracy(p, test),
                         [1]),
        lambda: lm_train.build(lm_train.parser().parse_args(
            ["--scale", "0.01", "--rounds", "1"])),
    ]
    if torch.cuda.is_available():
        # with a card, the default is the card
        enc = calls[0]()
        assert all(v.is_cuda for v in enc["scores"].values())
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, str(cwd / "chip_smoke.py")],
                          cwd=cwd, capture_output=True, text=True, env=env,
                          timeout=120)


def test_chip_smoke_alone_fails_without_result(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout


def test_chip_smoke_without_card_fails_without_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py runs for real")
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert '"ok"' not in res.stdout
