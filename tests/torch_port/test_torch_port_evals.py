"""The port's generation evals against the JAX package's, on the same numpy
inputs from a seed: each MMD kernel and `MMD_METRICS` entry at 1e-5
relative (an even sample count, so the median averages the two middle
values), the blocked elementwise kernels against a direct computation, the
Sinkhorn W1 and W2 at 1e-4 relative with the iteration count of JAX's loop,
`emd` and the registry, `r2_score`, `run_generation_eval` through a stub
sample function on both sides, and `train_ldm` with
`model.eval_generation.enabled=true` on the CPU writing
`generation_eval.csv`."""

import csv
import importlib
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scldm_tpu.data.h5ad import write_h5ad
from scldm_tpu.evals import generation_eval as jge
from scldm_tpu.evals import mmd as jmmd
from scldm_tpu.training.metrics import r2_score as jax_r2_score
from scldm_torch.cli import train, train_ldm
from scldm_torch.evals import generation_eval as ge
from scldm_torch.evals import mmd
from scldm_torch.evals import wasserstein as w
from scldm_torch.training.metrics import r2_score

# the package's `wasserstein` attribute is the function of that name
jw = importlib.import_module("scldm_tpu.evals.wasserstein")
ROOT = Path(__file__).resolve().parents[2]
REL = dict(rtol=1e-5, atol=0)
KERNELS = ["rbf_kernel", "bray_curtis_kernel", "tanimoto_kernel", "ruzicka_kernel"]


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def pair(seed, n=64, m=64, d=12, signed=False, scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)) * scale
    y = rng.normal(loc=0.5, size=(m, d)) * scale
    if not signed:
        x, y = np.abs(x), np.abs(y)
    return x.astype(np.float32), y.astype(np.float32)


def log1p_counts(seed, n, g, lam):
    rng = np.random.default_rng(seed)
    return np.log1p(rng.poisson(lam, size=(n, g))).astype(np.float32)


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("kernel", KERNELS)
def test_mmd_kernels_match_jax(kernel, signed):
    x, y = pair(1, 20, 30, 8, signed)
    got = getattr(mmd, kernel)(torch.from_numpy(x), torch.from_numpy(y))
    want = getattr(jmmd, kernel)(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(jmmd.MMD_METRICS))
def test_mmd_metrics_match_jax(name):
    """Each registry entry on distributions far enough apart that the
    statistic is not a cancellation residue; 64 x 64 cells, so the RBF
    bandwidth is the median of an even count."""
    assert set(mmd.MMD_METRICS) == set(jmmd.MMD_METRICS)
    x = log1p_counts(2, 64, 30, 2.0)
    y = log1p_counts(3, 64, 30, 4.0)
    got = float(mmd.MMD_METRICS[name](torch.from_numpy(x), torch.from_numpy(y)))
    want = float(jmmd.MMD_METRICS[name](jnp.asarray(x), jnp.asarray(y)))
    assert abs(want) > 1e-3
    np.testing.assert_allclose(got, want, **REL)


@pytest.mark.parametrize("n", [4096, 4097])
def test_median_is_jnps(n):
    """`jnp.median` averages the two middle values of an even count;
    `torch.median` would return the lower one."""
    v = np.random.default_rng(n).permutation(n).astype(np.float32)
    got = float(mmd.median(torch.from_numpy(v)))
    assert got == float(jnp.median(jnp.asarray(v)))
    if n % 2 == 0:
        assert got != float(torch.median(torch.from_numpy(v)))


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("kernel", KERNELS[1:])
def test_blocked_kernels_match_direct(kernel, signed, monkeypatch):
    """With a budget small enough to block both the rows of x and the genes
    (temporaries of at most 2,000 elements here), each elementwise kernel
    equals its direct numpy formula."""
    x, y = pair(4, 70, 25, 33, signed)
    monkeypatch.setattr(mmd, "PAIR_BUDGET", 2_000)
    got = getattr(mmd, kernel)(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    a, b = x.astype(np.float64)[:, None], y.astype(np.float64)[None]
    if kernel == "bray_curtis_kernel":
        num, den = np.abs(a - b), np.abs(a + b)
    elif kernel == "tanimoto_kernel":
        num, den = a * b, a + b - a * b
    else:
        num, den = np.minimum(a, b), np.maximum(a, b)
    ratio = num.sum(-1) / (den.sum(-1) + 1e-8)
    want = 1.0 - ratio if kernel == "bray_curtis_kernel" else ratio
    # f32 sums in another order: the forward error bound of num / den, which
    # signed inputs make large where den cancels
    bound = 1e-5 * (np.abs(num).sum(-1) + np.abs(ratio) * np.abs(den).sum(-1)) / np.abs(
        den.sum(-1) + 1e-8)
    assert (np.abs(got - want) <= bound + 1e-6).all()
    # and the blocks are what the budget asks for
    calls = []
    real = torch.Tensor.sum

    def counting_sum(t, *args, **kw):
        if t.ndim == 3:
            calls.append(t.numel())
        return real(t, *args, **kw)

    monkeypatch.setattr(torch.Tensor, "sum", counting_sum)
    getattr(mmd, kernel)(torch.from_numpy(x), torch.from_numpy(y))
    assert calls and max(calls) <= 2_000 and len(calls) > 2 * 70 // 80


def jax_sinkhorn_iterations(x0, x1, reg, power, max_iters, tol=1e-9):
    """The iteration count of JAX's `sinkhorn_divergence` loop (its body
    copied, with the counter returned)."""
    n, m = x0.shape[0], x1.shape[0]
    M = jw._cdist(x0, x1)
    if power == 2:
        M = M * M
    log_a = jnp.full((n,), -jnp.log(n))
    log_b = jnp.full((m,), -jnp.log(m))

    def cond(carry):
        return jnp.logical_and(carry[2] < max_iters, carry[3] > tol)

    def body(carry):
        f, g, it, _ = carry
        f_new = reg * (log_a - jax.nn.logsumexp((g[None, :] - M) / reg, axis=1))
        g_new = reg * (log_b - jax.nn.logsumexp((f_new[:, None] - M) / reg, axis=0))
        log_p_row = jax.nn.logsumexp((f_new[:, None] + g_new[None, :] - M) / reg, axis=1)
        err = jnp.max(jnp.abs(jnp.exp(log_p_row) - jnp.exp(log_a)))
        return f_new, g_new, it + 1, err

    carry = (jnp.zeros((n,)), jnp.zeros((m,)), jnp.array(0), jnp.array(jnp.inf))
    return int(jax.lax.while_loop(cond, body, carry)[2])


@pytest.mark.parametrize("power", [1, 2])
@pytest.mark.parametrize("reg,tol,max_iters", [(0.5, 1e-6, 10_000), (0.05, 1e-9, 300)])
def test_sinkhorn_matches_jax(power, reg, tol, max_iters):
    """The cost at 1e-4 relative and the iteration JAX's loop stops at: one
    case stops at its tolerance, the other runs to its cap (in f32 the
    default tol = 1e-9 is below the marginals' rounding, so the shipped eval
    runs all 10,000 iterations); the port reads its done flag every
    `_CHECK_EVERY` iterations, and the cap is not a multiple of it."""
    assert max_iters % w._CHECK_EVERY != 0
    x0, x1 = pair(5, 40, 50, 6)
    got, iters = w.sinkhorn(torch.from_numpy(x0), torch.from_numpy(x1), reg=reg, power=power,
                            max_iters=max_iters, tol=tol)
    want = float(jw.sinkhorn_divergence(jnp.asarray(x0), jnp.asarray(x1), reg=reg, power=power,
                                        max_iters=max_iters, tol=tol))
    np.testing.assert_allclose(float(got), want, rtol=1e-4)
    want_iters = jax_sinkhorn_iterations(jnp.asarray(x0), jnp.asarray(x1), reg, power, max_iters,
                                         tol)
    assert iters == want_iters
    assert (want_iters < max_iters) == (tol == 1e-6)
    assert float(w.sinkhorn_divergence(torch.from_numpy(x0), torch.from_numpy(x1), reg=reg,
                                       power=power, max_iters=max_iters, tol=tol)) == float(got)


@pytest.mark.parametrize("power", [1, 2])
def test_wasserstein_and_emd_match_jax(power):
    x0, x1 = pair(6, 40, 40, 3, signed=True)
    for method in ("emd", "sinkhorn"):
        got = w.wasserstein(torch.from_numpy(x0), torch.from_numpy(x1), method=method,
                            power=power, reg=0.5)
        want = jw.wasserstein(jnp.asarray(x0), jnp.asarray(x1), method=method, power=power,
                              reg=0.5)
        np.testing.assert_allclose(got, want, rtol=1e-5 if method == "emd" else 1e-4)
    # unequal sizes: `emd` takes the Sinkhorn cost, as JAX's does
    x0, x1 = pair(7, 30, 20, 4)
    np.testing.assert_allclose(
        w.wasserstein(torch.from_numpy(x0), torch.from_numpy(x1), method="emd", power=power),
        jw.wasserstein(jnp.asarray(x0), jnp.asarray(x1), method="emd", power=power), rtol=1e-4)


def test_r2_score_matches_jax():
    rng = np.random.default_rng(8)
    t = rng.normal(size=(5, 40)).astype(np.float32)
    p = (t + 0.3 * rng.normal(size=t.shape)).astype(np.float32)
    got = float(r2_score(torch.from_numpy(p), torch.from_numpy(t)))
    np.testing.assert_allclose(got, float(jax_r2_score(jnp.asarray(p), jnp.asarray(t))), **REL)


def test_run_generation_eval_matches_jax():
    """`run_generation_eval` on both sides through a stub sample function
    that returns the same generated counts for batch i (the first half kept,
    the second half garbage): the metrics on log1p-CPM by the real library,
    `total_samples` the real cells kept (the last batch not needed)."""
    rng = np.random.default_rng(9)
    Bv, Gv = 16, 30
    batches = []
    for _ in range(4):
        counts = rng.poisson(2.0, size=(Bv, Gv)).astype(np.float32) + (rng.uniform(size=(Bv, Gv))
                                                                       < 0.05)
        batches.append({"counts": counts, "library_size": counts.sum(1, keepdims=True),
                        "genes": np.tile(np.arange(1, Gv + 1, dtype=np.int32), (Bv, 1))})
    gen = [np.concatenate([rng.poisson(3.0, size=(Bv, Gv)), np.full((Bv, Gv), 1e6)])
           .astype(np.float32) for _ in batches]
    jax_calls = []

    def jax_fn(state, key, genes, condition):
        jax_calls.append(key)
        return jnp.asarray(gen[len(jax_calls) - 1]), None

    def port_fn(generator, genes, condition, state=None):
        assert generator.initial_seed() == 11 + port_fn.calls
        port_fn.calls += 1
        return torch.from_numpy(gen[port_fn.calls - 1]), None

    port_fn.calls = 0
    want = jge.run_generation_eval(jax_fn, None, iter(batches), sample_size=40, rng_seed=11)
    state = types.SimpleNamespace(module=torch.nn.Linear(1, 1))
    timings = {}
    got = ge.run_generation_eval(port_fn, state, iter(batches), sample_size=40, rng_seed=11,
                                 timings=timings)
    assert port_fn.calls == 3 and set(got) == set(want)
    assert got["generation_eval/total_samples"] == 48.0
    for k in want:  # 1e-4: the MMDs here are differences of kernel means near 0.02
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert set(timings) == {"mmd_s", "sinkhorn_s", "sinkhorn_iters"}


@pytest.mark.parametrize("epoch,enabled,run", [
    (0, True, False), (1, True, True), (2, True, True), (1, False, False)])
def test_should_run_matches_jax(epoch, enabled, run):
    cfg = {"enabled": enabled, "freq": 1, "warmup_epochs": 0}
    assert ge.should_run(epoch, cfg) == jge.should_run(epoch, cfg) == run
    cfg = {"enabled": enabled, "freq": 10, "warmup_epochs": 10}
    assert ge.should_run(epoch, cfg) == jge.should_run(epoch, cfg)


def test_train_ldm_with_eval_generation_writes_csv(tmp_path):
    """`train_ldm` with `model.eval_generation.enabled=true` (freq 1, no
    warmup) on the CPU for two small epochs, on a VAE that `train` just
    wrote: the eval runs after epoch 1's validation (not epoch 0's, as
    `should_run` says) and writes finite metrics to `generation_eval.csv`
    beside `metrics.csv`."""
    rng = np.random.default_rng(0)
    n, g = 160, 24  # the 10% validation split: two batches of 8
    X = rng.poisson(1.0, size=(n, g)).astype(np.float32)
    clusters = rng.choice([f"c{i}" for i in range(14)], size=n)
    write_h5ad(tmp_path / "train.h5ad", X, obs={"clusters": clusters},
               var_names=[f"g{i}" for i in range(g)])
    (tmp_path / "meta.json").write_text(json.dumps(
        {"genes": [f"g{i}" for i in range(g)], "labels": {"clusters": [f"c{i}" for i in range(14)]}}))
    (tmp_path / "mu.json").write_text(json.dumps({"clusters": {f"c{i}": 3.5 for i in range(14)}}))
    (tmp_path / "sd.json").write_text(json.dumps({"clusters": {f"c{i}": 0.1 for i in range(14)}}))
    d = "datamodule.dataset_params.dentate_gyrus"
    ov = [f"datamodule.datamodule.train_adata_path={tmp_path / 'train.h5ad'}",
          f"{d}.metadata_json={tmp_path / 'meta.json'}", f"{d}.n_genes={g}",
          f"{d}.genes_seq_len={g}", f"{d}.mu_size_factor={tmp_path / 'mu.json'}",
          f"{d}.sd_size_factor={tmp_path / 'sd.json'}", f"paths.output_path={tmp_path / 'out'}",
          "model.batch_size=16", "model.test_batch_size=8", "epochs=2",
          "datamodule.datamodule.prefetch=0", "device=cpu",
          "model.vae.n_embed=16", "model.vae.n_embed_latent=8", "model.vae.n_layer=1",
          "model.vae.n_inducing_points=4", "model.vae.n_head=2", "model.vae.n_head_cross=2"]
    config = lambda name: ["--config", str(ROOT / "configs" / name)]  # noqa: E731
    assert train.main(config("vae_training.yaml") + ov) == 0
    assert train_ldm.main(config("ldm_training.yaml") + ov + [
        "model.diffusion_model.n_embed=32", "model.diffusion_model.n_layer=1",
        "model.diffusion_model.n_head=2", "model.eval_generation.enabled=true",
        "model.eval_generation.freq=1", "model.eval_generation.warmup_epochs=0",
        "model.eval_generation.sample_size=12", "model.eval_generation.timesteps=4",
        "model.eval_generation.sampling_method=euler"]) == 0
    ck = tmp_path / "out" / "checkpoints" / "ldm_dentate_gyrus"
    rows = list(csv.DictReader((ck / "generation_eval.csv").open()))
    assert [r["epoch"] for r in rows] == ["1.0"] or [r["epoch"] for r in rows] == ["1"]
    names = [f"generation_eval/{k}" for k in (*jmmd.MMD_METRICS, "wasserstein1_sinkhorn",
                                              "wasserstein2_sinkhorn", "r2_mean", "r2_var")]
    assert all(np.isfinite(float(rows[0][k])) for k in names)
    assert float(rows[0]["generation_eval/total_samples"]) == 16.0  # two val batches of 8
    assert (ck / "metrics.csv").exists()
