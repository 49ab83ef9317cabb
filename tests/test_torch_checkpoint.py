"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint``): files either package writes, the other
reads, leaf by leaf at the saved dtype and by bits.

JAX's ``load_checkpoint`` cannot restore a bf16 leaf (it casts the raw
``|V2`` bytes with ``astype``; ROADMAP queue 3), so the port's bf16
files are read here through ``np.load`` and a uint16 view."""

import json
import zipfile

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import (checkpoint_downlink as jdownlink,
                              load_checkpoint as jload,
                              save_checkpoint as jsave)
from repro_torch.checkpoint import (DOWNLINK_KEY, checkpoint_downlink,
                                    load_checkpoint, save_checkpoint)
from repro_torch.comm.bitpack import packed_word_len
from repro_torch.configs import get_arch
from repro_torch.core.federated import federated_round
from repro_torch.core.zampling import ZamplingConfig, build_specs
from repro_torch.device import as_tensor
from repro_torch.launch import train as lm_train
from repro_torch.models.mlp import SMALL_DIMS, mlp_template
from repro_torch.models.model import build_model, param_template
from repro_torch.serve import make_serve_state, serve_generate

ZC = dict(compression=8, d=10, window=128, min_size=128, seed=1)
META = {"arch": "mnistfc-small", "q_seed": 0, "rounds": 3}
LM_META_KEYS = ["arch", "q_seed", "rounds", "compression", "__leaf_dtypes__"]


@pytest.fixture(autouse=True)
def _one_thread():
    """Serving and the LM round on one intra-op thread: beside the other
    test workers, torch's thread pool only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _states():
    """{case: (numpy state, codec tag)}: f32 scores, u8 and u16 words,
    packed4 lanes with the frontier's widths, bf16 dense leaves."""
    zs = build_specs(mlp_template(SMALL_DIMS), ZamplingConfig(**ZC))
    rng = np.random.RandomState(0)
    dense = {p: rng.randn(*zs.template[p].shape).astype(np.float32)
             for p in zs.dense_paths}
    n = {p: s.n for p, s in zs.specs.items()}

    def words(dtype, hi, length=None):
        return {p: rng.randint(0, hi, length(k) if length else k,
                               dtype=np.uint64).astype(dtype)
                for p, k in n.items()}

    return {
        "f32": ({"scores": {p: rng.rand(k).astype(np.float32)
                            for p, k in n.items()}, "dense": dense}, None),
        "u8": ({"scores": words(np.uint8, 256), "dense": dense}, "u8"),
        "u16": ({"scores": words(np.uint16, 2**16), "dense": dense}, "u16"),
        "packed4": ({"scores": words(np.uint32, 2**32,
                                     lambda k: packed_word_len(k, 4)),
                     "dense": dense,
                     "downlink_b": np.array([2, 4, 3], np.uint32)},
                    "packed4"),
        "bf16": ({"scores": {p: rng.rand(k).astype(np.float32)
                             for p, k in n.items()},
                  "dense": {p: v.astype(ml_dtypes.bfloat16)
                            for p, v in dense.items()}}, None),
    }


STATES = _states()
TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                np.dtype(np.uint8): torch.uint8,
                np.dtype(np.uint16): torch.uint16,
                np.dtype(np.uint32): torch.uint32}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _bits(x) -> np.ndarray:
    """A leaf's bytes (bf16 through its uint16 bits)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.uint16)
        x = x.cpu().numpy()
    x = np.asarray(x)
    if x.dtype.kind == "V" or x.dtype == ml_dtypes.bfloat16:
        x = x.view(np.uint16)
    return np.ascontiguousarray(x).view(np.uint8)


def _to_torch(state):
    """A numpy state as the port carries it: tensors, bf16 as
    ``torch.bfloat16``, the widths as int64."""
    out = {part: {p: as_tensor(v, "cpu") for p, v in state[part].items()}
           for part in ("scores", "dense")}
    if "downlink_b" in state:
        out["downlink_b"] = torch.from_numpy(
            state["downlink_b"].astype(np.int64))
    return out


def _sidecar(stem):
    with open(str(stem) + ".meta.json") as f:
        return json.load(f)


@pytest.mark.parametrize("case", list(STATES))
def test_jax_files_load_in_the_port_by_bits(case, tmp_path):
    state, tag = STATES[case]
    path = str(tmp_path / "ckpt")
    jsave(path, {k: ({p: jnp.asarray(v) for p, v in d.items()}
                     if isinstance(d, dict) else jnp.asarray(d))
                 for k, d in state.items()}, meta=dict(META), downlink=tag)
    got, meta = load_checkpoint(path, state, device="cpu")
    for key, want in _leaves(state):
        leaf = dict(_leaves(got))[key]
        assert isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"
        want_dtype = (torch.bfloat16 if want.dtype == ml_dtypes.bfloat16
                      else TORCH_DTYPES[want.dtype])
        assert leaf.dtype == want_dtype, key
        np.testing.assert_array_equal(_bits(leaf), _bits(want), err_msg=key)
    want_meta = _sidecar(tmp_path / "ckpt")
    want_meta.pop("__leaf_dtypes__")
    assert meta == want_meta and checkpoint_downlink(meta) == tag
    if case != "bf16":
        jgot, jmeta = jload(path + ".npz", state)
        assert jmeta == meta and jdownlink(jmeta) == tag


@pytest.mark.parametrize("case", list(STATES))
def test_port_files_load_in_jax_by_bits(case, tmp_path):
    state, tag = STATES[case]
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, _to_torch(state), meta=dict(META), downlink=tag)
    if case == "bf16":
        data = np.load(path)
        for key, want in _leaves(state):
            assert data[key].dtype.kind == ("V" if "dense" in key else "f")
            np.testing.assert_array_equal(_bits(data[key]), _bits(want))
        assert set(_sidecar(tmp_path / "ckpt")["__leaf_dtypes__"].values()) \
            == {"float32", "bfloat16"}
        return
    got, meta = jload(path, state)
    for key, want in _leaves(state):
        leaf = np.asarray(dict(_leaves(got))[key])
        assert leaf.dtype == want.dtype, key
        np.testing.assert_array_equal(_bits(leaf), _bits(want), err_msg=key)
    assert jdownlink(meta) == tag and meta["rounds"] == 3


def test_both_packages_write_the_same_layout(tmp_path):
    """One state holding every dtype: the same npz keys in the same
    order, the same sidecar, and every non-bf16 member's npy bytes
    (header and data) the same."""
    state = dict(STATES["packed4"][0], dense=STATES["bf16"][0]["dense"])
    jsave(str(tmp_path / "jax"), {
        "scores": {p: jnp.asarray(v) for p, v in state["scores"].items()},
        "dense": {p: jnp.asarray(v) for p, v in state["dense"].items()},
        "downlink_b": jnp.asarray(state["downlink_b"])},
        meta=dict(META), downlink="packed4")
    save_checkpoint(str(tmp_path / "port"), _to_torch(state),
                    meta=dict(META), downlink="packed4")
    assert _sidecar(tmp_path / "jax") == _sidecar(tmp_path / "port")
    assert (tmp_path / "jax.meta.json").read_text() \
        == (tmp_path / "port.meta.json").read_text()
    dtypes = _sidecar(tmp_path / "port")["__leaf_dtypes__"]
    assert dtypes["downlink_b"] == "uint32"
    assert {dtypes[f"dense/{p}"] for p in state["dense"]} == {"bfloat16"}
    zj = zipfile.ZipFile(tmp_path / "jax.npz")
    zp = zipfile.ZipFile(tmp_path / "port.npz")
    assert zj.namelist() == zp.namelist()
    assert [n[:-4] for n in zp.namelist()] == [k for k, _ in _leaves(state)]
    for name in zp.namelist():
        if dtypes[name[:-4]] != "bfloat16":
            assert zj.read(name) == zp.read(name), name
        else:  # '<V2' from ml_dtypes, '|V2' from the uint16 view
            a, b = np.load(tmp_path / "jax.npz")[name[:-4]], \
                np.load(tmp_path / "port.npz")[name[:-4]]
            assert a.dtype.itemsize == b.dtype.itemsize == 2
            assert a.tobytes() == b.tobytes()


def test_codec_tag_errors_match_jax(tmp_path):
    state = {"scores": {"w": np.zeros(4, np.uint8)}}
    for kw in (dict(meta={DOWNLINK_KEY: "u16"}, downlink="u8"),
               dict(downlink="u3"), dict(meta={DOWNLINK_KEY: "nope"})):
        with pytest.raises(ValueError) as port_err:
            save_checkpoint(str(tmp_path / "p"), state, **kw)
        with pytest.raises(ValueError) as jax_err:
            jsave(str(tmp_path / "j"), state, **kw)
        assert str(port_err.value) == str(jax_err.value)
    for save in (save_checkpoint, jsave):  # an alias is a registered name
        save(str(tmp_path / "ok"), state, downlink="u4")
        assert checkpoint_downlink(_sidecar(tmp_path / "ok")) == "u4"
    for get in (checkpoint_downlink, jdownlink):
        assert get({}) is None
        with pytest.raises(ValueError, match="unknown downlink codec"):
            get({DOWNLINK_KEY: "f16"})


def test_lm_entry_point_writes_a_checkpoint_that_resumes(tmp_path,
                                                         monkeypatch, capsys):
    runs = []
    real_save = lm_train.save

    def keep(run):
        runs.append(run)
        return real_save(run)

    monkeypatch.setattr(lm_train, "save", keep)
    out = tmp_path / "run"
    lm_train.main(["--device", "cpu", "--scale", "0.01", "--rounds", "2",
                   "--batch", "2", "--seq", "16", "--out", str(out)])
    assert capsys.readouterr().out.rstrip().endswith(
        f"checkpoint at {out}/ckpt.npz")
    assert (out / "ckpt.npz").exists() and (out / "history.json").exists()
    meta = _sidecar(out / "ckpt")
    assert list(meta) == LM_META_KEYS
    run = runs[0]
    assert meta["arch"] == run.cfg.name and meta["rounds"] == 2
    assert meta["compression"] == run.zspecs.compression
    assert set(meta["__leaf_dtypes__"].values()) == {"float32"}
    loaded, lmeta = load_checkpoint(str(out / "ckpt"), run.state,
                                    device="cpu")
    assert lmeta == {k: meta[k] for k in LM_META_KEYS[:-1]}
    batch = run.batch()
    nxt = [federated_round(run.zspecs, st, run.loss, batch, 12345, run.fcfg,
                           device="cpu") for st in (run.state, loaded)]
    (a, ma), (b, mb) = nxt
    for key, leaf in _leaves(a):
        np.testing.assert_array_equal(_bits(leaf), _bits(dict(_leaves(b))[key]),
                                      err_msg=key)
    assert _bits(ma["loss"]).tobytes() == _bits(mb["loss"]).tobytes()


def test_served_u8_checkpoint_gives_the_in_memory_tokens(tmp_path):
    cfg = get_arch("qwen2-0.5b").reduced()
    zspecs = build_specs(param_template(cfg),
                         ZamplingConfig(compression=8, d=8, min_size=1024))
    rng = np.random.RandomState(0)
    state = {"scores": {p: rng.rand(s.n).astype(np.float32)
                        for p, s in zspecs.specs.items()},
             "dense": {p: (1 + 0.1 * rng.randn(*zspecs.template[p].shape)
                           ).astype(np.float32)
                       for p in zspecs.dense_paths}}
    sstate = make_serve_state(zspecs, state, 2, downlink="u8", device="cpu")
    save_checkpoint(str(tmp_path / "serve"), {"scores": sstate.words,
                                              "dense": sstate.dense},
                    downlink="u8")
    loaded, meta = load_checkpoint(str(tmp_path / "serve.npz"),
                                   {"scores": sstate.words,
                                    "dense": sstate.dense}, device="cpu")
    tag = checkpoint_downlink(meta)
    assert tag == "u8"
    served = make_serve_state(zspecs, loaded, 2, carried=tag, device="cpu")
    model = build_model(cfg)
    want = serve_generate(model, sstate, [[5, 17]], 2, device="cpu")
    got = serve_generate(model, served, [[5, 17]], 2, device="cpu")
    assert torch.equal(got, want)


def test_as_tensor_reads_raw_bf16_bytes():
    x = np.array([1.5, -2.0, 3.0e-3, -0.0], np.float32)
    bits = torch.from_numpy(x).to(torch.bfloat16).view(torch.uint16).numpy()
    raw = bits.view(np.dtype("V2"))  # what np.load gives for a bf16 leaf
    t = as_tensor(raw, "cpu")
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.uint16).numpy(), bits)
    assert as_tensor(raw, "cpu", torch.float32).tolist() == \
        torch.from_numpy(x).to(torch.bfloat16).float().tolist()
    # an ml_dtypes bf16 array gives the same bits
    assert np.array_equal(as_tensor(x.astype(ml_dtypes.bfloat16), "cpu")
                          .view(torch.uint16).numpy(), bits)
    with pytest.raises(TypeError, match="no bf16 leaf"):
        as_tensor(np.zeros(2, np.dtype("V4")), "cpu")
