"""The port stands alone: no module of ``repro_torch``, not
``chip_smoke.py`` and not the port's examples
(``examples/federated_mnistfc_torch.py``,
``examples/serve_compressed_torch.py``, ``examples/quickstart_torch.py``)
imports jax or the JAX package, and the entry points run on the card
unless the caller asks for the CPU."""

import os
import runpy
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_arch
from repro_torch.core.federated import (FederatedConfig, encode_state,
                                        federated_round)
from repro_torch.core.zampling import (ZamplingConfig, build_specs,
                                       sample_weights)
from repro_torch.experiments import paper, run_wire_formats
from repro_torch.launch import train as lm_train
from repro_torch.models.mlp import (SMALL_DIMS, mlp_accuracy, mlp_loss,
                                    mlp_template)
from repro_torch.models.model import build_model, param_template
from repro_torch.train import evaluate, federated_fit
from repro_torch.serve import (ServeConfig, ServeScheduler,
                               build_serve_engine, make_serve_state,
                               serve_generate)

ROOT = Path(__file__).resolve().parent.parent
EXAMPLE = ROOT / "examples" / "federated_mnistfc_torch.py"
SERVE_EXAMPLE = ROOT / "examples" / "serve_compressed_torch.py"
QUICKSTART = ROOT / "examples" / "quickstart_torch.py"

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
              "models.model", "models.common", "models.attention",
              "fault", "fault.plan", "fault.population", "fault.validate",
              "checkpoint", "checkpoint.ckpt", "core.zonotope",
              "experiments", "experiments.paper", "models.ssm", "models.moe",
              "models.flash", "launch.input_specs", "train.steps",
              "configs.registry", "configs.mamba2_1_3b",
              "configs.mixtral_8x7b", "configs.olmoe_1b_7b",
              "configs.pixtral_12b", "configs.qwen1_5_4b",
              "configs.qwen3_14b", "configs.seamless_m4t_medium",
              "configs.yi_9b", "configs.zamba2_7b", "core.bitpack",
              "kernels.ref", "kernels.qz_sharded", "launch.mesh",
              "launch.sharding", "launch.dryrun"):
        assert f"repro_torch.{m}" in mods
    code = _BLOCKED + "\n".join(
        ["import importlib", f"sys.path.insert(0, {str(ROOT)!r})"]
        + [f"importlib.import_module({m!r})" for m in mods]
        + ["import chip_smoke", "import runpy",
           f"runpy.run_path({str(EXAMPLE)!r}, run_name='example')",
           f"runpy.run_path({str(SERVE_EXAMPLE)!r}, run_name='example')",
           f"runpy.run_path({str(QUICKSTART)!r}, run_name='example')",
           "assert not any(k.split('.')[0] in ('jax', 'repro') "
           "for k in sys.modules)", "print('ok')"])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _run_example(*flags, script=EXAMPLE, prelude=""):
    """An example under the import blocker, in a new process;
    ``prelude`` runs before it."""
    code = _BLOCKED + prelude + (
        f"import runpy, sys\nsys.argv = [{str(script)!r}, "
        f"*{list(flags)!r}]\n"
        f"runpy.run_path({str(script)!r}, run_name='__main__')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)


# the heterogeneity table's quick grid at a cut: 2 betas x 2 codecs, 2
# rounds of 4 clients taking 2 steps
_SMALL_HET = """
import torch
torch.set_num_threads(2)
import repro_torch.experiments as ex
from repro_torch.experiments import paper
def _small(quick=True, *, device="cuda"):
    assert quick
    return [paper.heterogeneity_cell(b, c, N=6, K=4, E=2, rounds=2,
                                     n_eval=2, device=device)
            for b in (0.1, 1.0) for c in ("f32", "packed4")]
ex.run_heterogeneity = _small
"""


def test_example_runs_on_the_cpu_without_jax():
    """The federated example at a small size on the CPU: the wire tables,
    a line per evaluation, the cumulative downlink; ``--het-table`` the
    heterogeneity table's rows (its grid cut here)."""
    # with partial participation, streaming and a schedule, ported since
    res = _run_example("--rounds", "2", "--clients", "3", "--local-steps",
                       "2", "--device", "cpu", "--aggregate",
                       "allgather_packed", "--downlink", "packed2",
                       "--population", "12", "--cohort", "3",
                       "--dropout-rate", "0.3", "--stream-chunk", "2",
                       "--downlink-schedule", "frontier")
    assert res.returncode == 0, res.stderr
    out = res.stdout
    assert "transport=allgather_packed" in out and "packed2" in out
    assert "round   2: loss=" in out and "sampled-acc=" in out
    assert "population N=12" in out and "w_sum" in out
    assert "schedule=frontier" in out
    assert "cumulative downlink" in out and out.rstrip().endswith(
        "never a naive float tensor.")
    res = _run_example("--device", "cpu", "--het-table", prelude=_SMALL_HET)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[0].startswith("accuracy vs Dirichlet beta")
    assert lines[1].split() == ["beta", "codec", "acc", "std", "down",
                                "KiB", "vs", "f32"]
    rows = [line.split() for line in lines[2:]]
    assert [r[:2] for r in rows] == [["0.10", "f32"], ["0.10", "packed4"],
                                     ["1.00", "f32"], ["1.00", "packed4"]]
    assert all(r[-1] == ("1.0000" if r[1] == "f32" else "0.1449")
               for r in rows)


def test_quickstart_runs_on_the_cpu_without_jax():
    res = _run_example("--device", "cpu", "--steps", "20",
                       script=QUICKSTART,
                       prelude="import torch\ntorch.set_num_threads(2)\n")
    assert res.returncode == 0, res.stderr
    out = res.stdout.splitlines()
    assert out[0] == "weights m=16280, trainable n=4160 (3.9x compression)"
    assert out[1] == ("federated client upload: 4160 bits vs naive 520960 "
                      "(125x)")
    assert out[2].startswith("loss: ") and out[3].startswith(
        "sampled accuracy ") and out[4].startswith("expected accuracy ")


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


def test_training_entry_points_default_to_the_card(tmp_path):
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
    ckpt = tmp_path / "ckpt.npz"
    save_checkpoint(str(ckpt), state)
    quickstart = runpy.run_path(str(QUICKSTART), run_name="quickstart")
    quickstart = types.SimpleNamespace(**quickstart)
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
        lambda: lm_train.build(lm_train.parser().parse_args(
            ["--arch", "mamba2-1.3b", "--scale", "0.01", "--rounds", "1"])),
        lambda: lm_train.main(["--arch", "mamba2-1.3b", "--scale", "1.0",
                               "--rounds", "1", "--out",
                               str(tmp_path / "run")]),
        lambda: load_checkpoint(str(ckpt), state),
        lambda: paper.zhou_cell("zhou_d1_nm", 1.0, 1, steps=1, n_samples=1),
        lambda: run_wire_formats(),
        lambda: quickstart.main(["--steps", "1"]),
    ]
    if torch.cuda.is_available():
        # with a card, the default is the card
        enc = calls[0]()
        assert all(v.is_cuda for v in enc["scores"].values())
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_entry_point_refuses_the_audio_family_by_name():
    """JAX's entry point raises KeyError: 'enc_embeds' on the audio
    family; the port's refuses it up front, naming the missing input,
    on any device."""
    for device in ("cpu", "cuda"):
        with pytest.raises(ValueError, match="enc_embeds"):
            lm_train.build(lm_train.parser().parse_args(
                ["--arch", "seamless-m4t-medium", "--scale", "0.01",
                 "--device", device]))


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
