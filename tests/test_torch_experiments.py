"""The port's paper experiments (``repro_torch.experiments``), the
zonotope quantities (``core.zonotope``) and the Table 1 accounting
(``ZamplingSpecs.comm_bits_per_round``) against the JAX package's.

Each experiment's cell runs at a tiny size on the CPU, its rows under
the JAX package's keys (read from the JAX source) with finite values;
one heterogeneity cell is held against JAX's jitted ``federated_fit``
on the same numpy scores and words.  The JAX package's beta init draws
from ``jax.random``, so the port's is held only in its moments."""

import ast
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import metering as jmet
from repro.core import federated as jfed, zampling as jz
from repro.core import zonotope as jzono
from repro.core.sampling import key_word
from repro.experiments import comm_savings_table as jcomm_savings_table
from repro.models import mlp as jmlp
from repro.train import fit as jfit
from repro_torch.comm.downlink import codec_names
from repro_torch.core import zonotope as tzono
from repro_torch.core.sampling import init_scores
from repro_torch.core.zampling import ZamplingConfig, build_specs
from repro_torch.experiments import (comm_savings_table, paper,
                                     run_wire_formats)
from repro_torch.models import mlp as tmlp
from test_torch_federated import DENSE_ATOL, LOSS_RTOL, MAX_FLIP_SHARE

ROOT = Path(__file__).resolve().parent.parent
JAX_PAPER = ROOT / "src" / "repro" / "experiments" / "paper.py"
WIRE_ZC = dict(compression=8, d=10, window=128, seed=0, min_size=128)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jtemplate(dims):
    return {f"layer{i}": {"kernel": jax.ShapeDtypeStruct((a, b), jnp.float32),
                          "bias": jax.ShapeDtypeStruct((b,), jnp.float32)}
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}


def _specs(dims, **zc):
    return (build_specs(tmlp.mlp_template(dims), ZamplingConfig(**zc)),
            jz.build_specs(_jtemplate(dims), jz.ZamplingConfig(**zc)))


def _jax_row_keys():
    """{function: the keys of the rows it builds}, read from the JAX
    source: every dict literal holding a ``bench`` key; a ``**row``
    spread is marked by ``"**"``."""
    tree = ast.parse(JAX_PAPER.read_text())
    out = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        keys = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Dict) and any(
                    isinstance(k, ast.Constant) and k.value == "bench"
                    for k in node.keys):
                keys |= {k.value if k is not None else "**"
                         for k in node.keys}
        if keys:
            out[fn.name] = keys
    return out


JAX_KEYS = _jax_row_keys()


def _numbers(v):
    if isinstance(v, dict):
        for x in v.values():
            yield from _numbers(x)
    elif isinstance(v, (list, tuple)):
        for x in v:
            yield from _numbers(x)
    elif isinstance(v, (int, float, np.floating, np.integer)) and not \
            isinstance(v, bool):
        yield float(v)


def _check_rows(rows, fn, extra=()):
    want = (JAX_KEYS[fn] - {"**"}) | set(extra)
    assert rows
    for row in rows:
        assert set(row) == want, (fn, set(row) ^ want)
        assert all(math.isfinite(x) for x in _numbers(row)), row


# ---------------------------------------------------------------------------
# zonotope
# ---------------------------------------------------------------------------

def test_zonotope_scalars_equal_jax():
    for d in (1, 2, 5, 10, 16, 100, 256):
        assert tzono.empty_column_fraction(d) == jzono.empty_column_fraction(d)
        for m in (1, 200, 15680, 266200):
            assert tzono.expected_nonzero_weights(m, d) == \
                jzono.expected_nonzero_weights(m, d)
            for n in (d + 1, 4 * d, 33327):
                assert tzono.expected_empty_columns(m, n, d) == \
                    jzono.expected_empty_columns(m, n, d)
        for fan in (1, 20, 300, 784, 4864):
            assert tzono.max_row_magnitude(d, fan) == \
                jzono.max_row_magnitude(d, fan)
        for fans in ([784], [784, 20, 20], [784] * 50, list(range(1, 301))):
            assert tzono.log_expected_zonotope_volume(fans, d) == \
                jzono.log_expected_zonotope_volume(fans, d)


def test_tau_hypercube_dim_equals_jax():
    rng = np.random.RandomState(3)
    p = np.concatenate([rng.rand(997) * 1.4 - 0.2,
                        [0.0, 0.01, 0.2, 0.5, 0.8, 0.99, 1.0]]).astype(
        np.float32)
    for tau in (0.0, 0.01, 0.2, 0.25, 0.5, 0.6):
        want = jzono.tau_hypercube_dim(jnp.asarray(p), tau)
        assert tzono.tau_hypercube_dim(p, tau) == want
        assert tzono.tau_hypercube_dim(torch.from_numpy(p), tau) == want


@pytest.mark.parametrize("tau", [0.01, 0.2, 0.5, 0.7])
def test_perturb_nontrivial_given_jax_noise_is_jax_by_bits(tau):
    rng = np.random.RandomState(4)
    p = (rng.rand(4096) * 1.2 - 0.1).astype(np.float32)
    jp2, jeps = jzono.perturb_nontrivial(jnp.asarray(p),
                                         jax.random.PRNGKey(100 + int(10 * tau)),
                                         tau)
    p2, eps = tzono.perturb_nontrivial(torch.from_numpy(p),
                                       torch.from_numpy(np.asarray(jeps)), tau)
    for got, want in ((p2, jp2), (eps, jeps)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want).view(np.uint32))
    n_hit = int((np.asarray(jeps) != 0).sum())
    assert n_hit == (4096 if tau >= 0.5 else
                     jzono.tau_hypercube_dim(jnp.asarray(p), tau))


def test_perturb_nontrivial_scale_and_generator():
    p = torch.from_numpy(np.random.RandomState(5).rand(512).astype(np.float32))
    noise = torch.from_numpy(np.random.RandomState(6).randn(512).astype(
        np.float32))
    mask = ((p >= 0.2) & (p <= 0.8)).float()
    p2, eps = tzono.perturb_nontrivial(p, noise, 0.2, scale=0.3)
    assert torch.equal(eps, noise * 0.3 * mask)
    assert torch.equal(p2, p + noise * 0.3 * mask)
    a = tzono.perturb_nontrivial(p, torch.Generator().manual_seed(1), 0.5)
    b = tzono.perturb_nontrivial(p, torch.Generator().manual_seed(1), 0.5)
    assert torch.equal(a[0], b[0]) and bool((a[1] != 0).all())


# ---------------------------------------------------------------------------
# Table 1 and the wire accounting
# ---------------------------------------------------------------------------

def test_comm_savings_table_equals_jax():
    assert comm_savings_table() == jcomm_savings_table()


@pytest.mark.parametrize("dims", [tmlp.SMALL_DIMS, tmlp.MNISTFC_DIMS])
def test_comm_bits_per_round_equal_jax(dims):
    zs, jzs = _specs(dims, compression=8, d=10, window=128, min_size=128,
                     seed=1)
    assert zs.compression == jzs.compression
    for codec in codec_names():
        for packed in (True, False):
            got = zs.comm_bits_per_round(packed=packed, downlink=codec)
            assert got == jzs.comm_bits_per_round(packed=packed,
                                                  downlink=codec)
        rep = jmet.round_wire_report(jzs, "psum_u32", 10, downlink=codec)
        got = zs.comm_bits_per_round(downlink=codec)
        assert got["client_up_wire"] == 8 * rep["uplink_bytes_per_client"]
        assert got["server_down_wire"] == 8 * rep["downlink_bytes_per_client"]


def test_wire_formats_rows_and_bytes_equal_jax():
    rows = run_wire_formats(quick=True, device="cpu")
    jrows = jmet.wire_table(_specs(tmlp.SMALL_DIMS, **WIRE_ZC)[1], 4)
    _check_rows(rows, "run_wire_formats", extra=jrows[0])  # the **row
    assert [r["strategy"] for r in rows] == [r["strategy"] for r in jrows]
    for row, jrow in zip(rows, jrows):
        for key, val in jrow.items():
            if key != "bench":
                assert row[key] == val, (row["strategy"], key)
        assert row["bench"] == "wire_formats" and row["compression"] == 8
    assert len({r["loss"] for r in rows}) == 1  # the same round, 3 wires


# ---------------------------------------------------------------------------
# every experiment's cell at a tiny size
# ---------------------------------------------------------------------------

CELLS = {
    "run_local_compression": lambda: [paper.local_compression_cell(
        5, 4, steps=4, n_samples=2, device="cpu")],
    "run_federated": lambda: [paper.federated_cell(
        8, K=3, E=2, rounds=2, n_final=2, device="cpu")],
    "run_downlink_tradeoff": lambda: [
        paper.downlink_cell("u8", K=3, E=2, rounds=2, n_eval=2,
                            device="cpu"),
        paper.downlink_cell("packed4", "cosine", K=3, E=2, rounds=2,
                            n_eval=2, device="cpu")],
    "run_heterogeneity": lambda: [paper.heterogeneity_cell(
        0.1, "packed2", N=6, K=4, E=2, rounds=2, n_eval=2, device="cpu")],
    "run_sensitivity": lambda: paper.sensitivity_cell(
        "continuous", steps=4, taus=(0.2, 0.5), n_pert=2, device="cpu"),
    "run_integrality": lambda: [paper.integrality_cell(
        (0.5, 0.5), steps=4, n_samples=2, device="cpu")],
    "run_zhou_comparison": lambda: [paper.zhou_cell(
        "zampling_d4", 1.0, 4, steps=4, n_samples=2, device="cpu")],
}


@pytest.mark.parametrize("fn", sorted(CELLS))
def test_cell_rows_have_jax_keys_and_finite_values(fn):
    rows = CELLS[fn]()
    _check_rows(rows, fn)
    assert fn in JAX_KEYS and callable(getattr(paper, fn))


def test_experiments_export_jax_names_and_default_to_the_card():
    import repro.experiments as jexp
    import repro_torch.experiments as texp

    assert texp.__all__ == jexp.__all__
    assert set(JAX_KEYS) | {"comm_savings_table"} >= set(texp.__all__)
    if torch.cuda.is_available():
        return
    for name in texp.__all__:
        if name != "comm_savings_table":
            with pytest.raises(RuntimeError, match="no CUDA device"):
                getattr(texp, name)()


@pytest.mark.parametrize("quick", [True, False])
def test_experiment_grids_are_jax_grids(quick):
    """Cells a function at JAX's grids (``experiments/paper.py``), in its
    order; building a grid runs nothing.  The codec rows follow the
    registry, which other tests of a process may have grown
    (``packed_codec(b)``), as JAX's do."""
    codecs = len(codec_names(include_aliases=False))
    counts = {"comm_savings_table": 1,
              "run_local_compression": 9 if quick else 55,
              "run_federated": 3, "run_wire_formats": 1 if quick else 3,
              "run_downlink_tradeoff": codecs + 4,
              "run_heterogeneity": (2 if quick else 5) * codecs,
              "run_sensitivity": 2, "run_integrality": 2 if quick else 5,
              "run_zhou_comparison": 3 if quick else 5}
    for name, n in counts.items():
        assert len(paper.experiment_cells(name, quick, device="cpu")) == n
    labels = [label for label, _ in paper.experiment_cells(
        "run_downlink_tradeoff", quick, device="cpu")]
    assert labels == [f"{c} constant" for c in codec_names(False)] + [
        "u8 cosine", "packed4 cosine", "u8 frontier", "packed4 frontier"]
    with pytest.raises(ValueError, match="unknown experiment"):
        paper.experiment_cells("run_table3")


def test_setup_draws_and_beta_moments():
    zs, arrays = paper.setup_arrays(tmlp.SMALL_DIMS, 2.0, 5, seed=3)
    rng = np.random.RandomState(4)
    for p, s in zs.specs.items():
        np.testing.assert_array_equal(arrays["scores"][p],
                                      rng.rand(s.n).astype(np.float32))
    tmpl = tmlp.init_mlp_params(np.random.RandomState(3), tmlp.SMALL_DIMS)
    assert all(np.array_equal(arrays["dense"][p], tmpl[p])
               for p in zs.dense_paths)
    _, beta = paper.setup_arrays(tmlp.SMALL_DIMS, 2.0, 5, seed=3,
                                 beta=(0.1, 0.1))
    rng = np.random.RandomState(5)
    for p, s in zs.specs.items():
        np.testing.assert_array_equal(
            beta["scores"][p], rng.beta(0.1, 0.1, s.n).astype(np.float32))
    n = 200_000
    for a, b in ((0.1, 0.1), (1.0, 1.0), (2.0, 5.0)):
        x = init_scores(np.random.RandomState(0), n, dist="beta", beta_a=a,
                        beta_b=b)
        jx = np.asarray(jax.random.beta(jax.random.PRNGKey(0), a, b, (n,)))
        mean, var = a / (a + b), a * b / ((a + b) ** 2 * (a + b + 1))
        for sample in (x, jx):
            assert sample.dtype == np.float32
            assert abs(sample.mean() - mean) < 5 * math.sqrt(var / n)
            assert abs(sample.var() - var) < 0.02 * var
    with pytest.raises(ValueError, match="unknown init dist"):
        init_scores(np.random.RandomState(0), 4, dist="normal")


# ---------------------------------------------------------------------------
# a heterogeneity cell against JAX's jitted federated_fit
# ---------------------------------------------------------------------------

def test_heterogeneity_fit_against_jax():
    """Dirichlet population, cohorts, the streaming fold (K=4 in chunks
    of 2), psum_u32, u8: the port's fit and JAX's on the same numpy
    scores, batches, cohorts, weights and words."""
    inputs = paper.heterogeneity_inputs(0.1, "u8", N=6, K=4, E=2, rounds=2)
    key = jax.random.PRNGKey(0)
    inputs["words"] = [int(key_word(k)) for k in jax.random.split(key, 2)]
    state, mets = paper.heterogeneity_fit(inputs, device="cpu")

    zs, cfg = inputs["zspecs"], inputs["cfg"]
    jzs = jz.build_specs(_jtemplate(tmlp.SMALL_DIMS), jz.ZamplingConfig(
        compression=8, d=10, window=128, seed=1, min_size=128))
    jcfg = jfed.FederatedConfig(num_clients=4, local_steps=2, local_lr=0.5,
                                aggregate="psum_u32", downlink="u8",
                                stream_chunk=cfg.stream_chunk)
    arrays = inputs["arrays"]
    jst = jfed.encode_state(jzs, jcfg, {
        part: {p: jnp.asarray(v) for p, v in arrays[part].items()}
        for part in ("scores", "dense")})
    jnew, jm = jax.jit(lambda s, b, ids, w: jfit.federated_fit(
        jzs, s, jmlp.mlp_loss, b, key, jcfg, client_ids=ids, weights=w))(
        jst, {n: jnp.asarray(v) for n, v in inputs["batches"].items()},
        jnp.asarray(inputs["client_ids"]), jnp.asarray(inputs["weights"]))
    for name in ("weight_sum", "num_participating", "uplink_bytes_round",
                 "downlink_bytes_per_client", "round_skipped"):
        np.testing.assert_array_equal(paper._host(mets[name]),
                                      np.asarray(jm[name]), err_msg=name)
    np.testing.assert_allclose(paper._host(mets["loss"]),
                               np.asarray(jm["loss"]),
                               rtol=LOSS_RTOL)
    for p in zs.dense_paths:
        np.testing.assert_allclose(state["dense"][p].numpy(),
                                   np.asarray(jnew["dense"][p]), rtol=0,
                                   atol=DENSE_ATOL)
    differ = sum(int((state["scores"][p].numpy()
                      != np.asarray(jnew["scores"][p])).sum())
                 for p in zs.specs)
    assert all(state["scores"][p].dtype == torch.uint8 for p in zs.specs)
    print(f"u8 words differing from JAX's after 2 rounds: {differ} of "
          f"{zs.n_total}")
    assert differ <= 2 * MAX_FLIP_SHARE * 4 * zs.n_total
