"""The port's config loader and builders against the JAX package's: the YAML
subset reader against `yaml.safe_load` on every file under configs/ and on
override strings (types held equal, not only values), the composed and
resolved trees of the top-level configs and of every dataset switch against
JAX's `resolve`, `${repo_root:}` from another working directory, each
builder's parameter names and shapes against JAX's builder's (through the
weight bridge's names), `compute_max_steps`, the compute dtypes and remat the
builders take, the parallel keys' one-process meaning (JAX's: without a mesh
they change nothing) and inference's `n_model` check. Everything here is
exact."""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from scldm_tpu.config import build as jax_build
from scldm_tpu.config.loader import load_config as jax_load_config
from scldm_tpu.config.loader import merge_overrides as jax_merge_overrides
from scldm_tpu.config.loader import resolve as jax_resolve
from scldm_tpu.utils.torch_import import export_torch_state_dict
from scldm_torch.config import build
from scldm_torch.config.loader import load_config, merge_overrides, parse_yaml, resolve

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = sorted(p.relative_to(ROOT).as_posix() for p in (ROOT / "configs").rglob("*.yaml"))
TOP_LEVEL = sorted(p.name for p in (ROOT / "configs").glob("*.yaml"))
DATASETS = sorted(yaml.safe_load((ROOT / "configs/datamodule/default.yaml").read_text())
                  ["dataset_params"])
# small widths for the builders (configs stay as shipped otherwise)
SMALL = ["model.compute_dtype=float32", "datamodule.dataset_params.dentate_gyrus.n_genes=40",
         "model.vae.n_embed=16", "model.vae.n_embed_latent=8", "model.vae.n_layer=2",
         "model.vae.n_inducing_points=4", "model.vae.n_head=2", "model.vae.n_head_cross=2",
         "device=cpu"]
SMALL_DIT = ["model.diffusion_model.n_embed=32", "model.diffusion_model.n_layer=2",
             "model.diffusion_model.n_head=2"]


def same(got, want, path=""):
    """Equal values of the same types, recursively (YAML typing is the point:
    1 is not 1.0 and '5e-4' is not 0.0005)."""
    assert type(got) is type(want), f"{path}: {type(got).__name__} vs {type(want).__name__}"
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got), path
    else:
        assert got == want, path


# -- the YAML subset ---------------------------------------------------------------

@pytest.mark.parametrize("path", CONFIGS)
def test_reader_matches_safe_load_on_configs(path):
    text = (ROOT / path).read_text()
    same(parse_yaml(text, path), yaml.safe_load(text))


OVERRIDE_VALUES = [
    "5e-4", "1e-8", "1e-5", "1.0e-4", "1.5e+3", "3.", ".5", "-.inf", ".nan", "null", "~", "",
    "Null", "true", "False", "on", "off", "yes", "No", "0", "-5", "+3", "012", "0x1F", "1_000",
    "1:30", "[0.9, 0.95]", "[a, b, {c: 1}]", "{}", "[]", "{a: 1, b: [x, y]}", "'quoted'",
    '"double \\"quoted\\" \\t"', "'it''s'", "'5e-4'", "/tmp/data/train.h5ad", "a b",
    "x # a comment", "${model.batch_size}", "${eval:'2 * 3'}", "float32", "a: 1", "- a\n- b",
]


@pytest.mark.parametrize("value", OVERRIDE_VALUES)
def test_reader_matches_safe_load_on_override_values(value):
    same(parse_yaml(value), yaml.safe_load(value))


@pytest.mark.parametrize("text", [
    "a: &x 1\nb: *x", "a: !!str 1", "a: |\n  text", "a: >\n  text", "a: 1\n---\nb: 2",
    "a: one\n  two", "? a\n: 1", "a: 2001-12-14",
])
def test_reader_refuses_constructs_outside_the_subset(text):
    with pytest.raises(ValueError):
        parse_yaml(text)


def test_typed_learning_rates_reach_the_builders():
    """YAML 1.1 reads 5e-4 as a string; the builders call float() on it."""
    cfg = resolve(load_config(ROOT / "configs/ldm_training.yaml"))
    assert cfg["model"]["optimizer"]["lr"] == "5e-4"
    assert cfg["model"]["transport"]["train_eps"] == "1e-5"
    cfg = resolve(merge_overrides(cfg, ["model.optimizer.lr=1.0e-4"]))
    assert cfg["model"]["optimizer"]["lr"] == 1.0e-4


# -- composition and interpolation ------------------------------------------------------

@pytest.mark.parametrize("name", TOP_LEVEL)
def test_resolved_top_level_config_matches_jax(name):
    overrides = ["model.batch_size=64", "training.max_steps=7", "epochs=3"]
    got = resolve(merge_overrides(load_config(ROOT / "configs" / name), overrides))
    want = jax_resolve(jax_merge_overrides(jax_load_config(ROOT / "configs" / name), overrides))
    same(got, want)


@pytest.mark.parametrize("dataset", DATASETS)
def test_resolved_dataset_switch_matches_jax(dataset):
    overrides = [f"datamodule.dataset={dataset}", "model.optimizer.betas=[0.8, 0.9]"]
    got = resolve(merge_overrides(load_config(ROOT / "configs/vae_training.yaml"), overrides))
    want = jax_resolve(jax_merge_overrides(jax_load_config(ROOT / "configs/vae_training.yaml"),
                                           overrides))
    same(got, want)
    assert got["experiment_name"] == f"vae_{dataset}"


def test_repo_root_does_not_depend_on_the_working_directory(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = resolve(load_config(ROOT / "configs/vae_training.yaml"))
    assert cfg["paths"]["base_repo_path"] == str(ROOT)
    meta = Path(cfg["datamodule"]["vocabulary_encoder"]["metadata_json"])
    assert meta.is_file() and meta == ROOT / "metadata/dentategyrus_train.json"


def test_eval_resolver_and_errors():
    cfg = resolve({"a": {"b": 3}, "c": "${eval:'${a.b} * 2 + 1'}", "d": "x${a.b}y"})
    assert cfg["c"] == 7 and cfg["d"] == "x3y"
    with pytest.raises(KeyError):
        resolve({"a": "${missing.key}"})
    with pytest.raises(ValueError):
        merge_overrides({}, ["no_equals_sign"])


# -- builders ------------------------------------------------------------------------------

def small_cfg(name="vae_training.yaml", extra=()):
    return resolve(merge_overrides(load_config(ROOT / "configs" / name), SMALL + list(extra)))


def jax_shapes(abstract_params):
    """Reference names and shapes of a flax tree of shapes (jax.eval_shape)."""
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), abstract_params)
    return {k: tuple(v.shape) for k, v in export_torch_state_dict(zeros).items()}


def port_shapes(module):
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def test_build_vae_matches_jax_shapes():
    cfg = small_cfg()
    vae = build.build_vae(cfg)
    jvae = jax_build.build_vae(cfg)
    b, g = 2, cfg["model"]["vae"]["n_genes"]
    zeros = jnp.zeros((b, g), jnp.float32)
    genes = jnp.broadcast_to(jnp.arange(1, g + 1), (b, g))
    params = jax.eval_shape(lambda: jvae.init(jax.random.PRNGKey(0), counts=zeros, genes=genes,
                                              library_size=jnp.ones((b, 1)),
                                              counts_subset=zeros, genes_subset=genes))
    want = jax_shapes(params)
    assert port_shapes(vae) == want
    # the weights are drawn from the config's seed
    again = build.build_vae(cfg)
    assert all(torch.equal(a, b) for a, b in zip(vae.state_dict().values(),
                                                 again.state_dict().values()))


def test_build_dit_matches_jax_shapes():
    cfg = small_cfg("ldm_training.yaml", SMALL_DIT)
    dit = build.build_dit(cfg)
    jdit = jax_build.build_dit(cfg)
    d = cfg["model"]["diffusion_model"]
    x = jnp.zeros((2, d["seq_len"], d["n_embed_input"]))
    cond = {k: jnp.zeros((2,), jnp.int32) for k in d["class_vocab_sizes"]}
    params = jax.eval_shape(lambda: jdit.init(
        {"params": jax.random.PRNGKey(0), "condition": jax.random.PRNGKey(0)},
        x, jnp.zeros((2,)), cond, train=True))
    want = jax_shapes(params)
    assert port_shapes(dit) == want


def test_build_tasks_carry_the_config():
    cfg = small_cfg()
    task = build.build_vae_task(cfg, build.build_vae(cfg), max_steps=100)
    opt = task.init_state(torch.Generator().manual_seed(0)).optimizer
    assert opt.defaults["lr"] == 1e-3 and opt.defaults["betas"] == (0.9, 0.95)
    assert task.grad_clip == 10.0
    cfg = small_cfg("ldm_training.yaml", SMALL_DIT)
    ldm = build.build_ldm_task(cfg, build.build_vae(cfg), build.build_dit(cfg), max_steps=50)
    assert ldm.ema_cfg == {"beta": 0.9999, "update_every": 10, "update_after_step": 10_000}
    assert ldm._opt_kwargs["learning_rate"] == 5e-4 and ldm._opt_kwargs["betas"] == (0.9, 0.999)
    assert ldm.transport.train_eps == 1e-5 and ldm.algebraic_decode is False


@pytest.mark.parametrize("overrides,n_cells", [
    ([], 10_000), (["training.max_steps=17"], 10_000), (["epochs=3", "model.batch_size=7"], 50),
    (["model.batch_size=512"], 100),
])
def test_compute_max_steps_matches_jax(overrides, n_cells):
    cfg = small_cfg(extra=overrides)
    for world in (1, 2):
        assert (build.compute_max_steps(cfg, n_cells, world)
                == jax_build.compute_max_steps(cfg, n_cells, world))


# -- the parallel keys on one process ----------------------------------------------------------

def _vae_task(cfg):
    return build.build_vae_task(cfg, build.build_vae(cfg), 10)


def _ldm_task(cfg):
    return build.build_ldm_task(cfg, build.build_vae(cfg), build.build_dit(cfg), 10)


def _one_step(task):
    """One train step of a fresh state on a fixed batch: the metrics and the
    module's parameters after it."""
    rng = np.random.default_rng(0)
    counts = rng.poisson(2.0, size=(8, 40)).astype(np.float32)
    genes = np.tile(np.arange(1, 41, dtype=np.int64), (8, 1))
    batch = {k: torch.from_numpy(v) for k, v in {
        "counts": counts, "genes": genes, "library_size": counts.sum(1, keepdims=True),
        "counts_subset": counts[:, :20], "genes_subset": genes[:, :20],
        "clusters": rng.integers(0, 14, size=8)}.items()}
    state, mets = task.train_step(task.init_state(torch.Generator().manual_seed(0)), batch)
    return ({k: float(v) for k, v in mets.items()},
            {k: v.detach().clone() for k, v in state.module.state_dict().items()})


@pytest.mark.parametrize("config,overrides,call,item", [
    ("vae_training.yaml", ["training.fsdp=true"], _vae_task, "item 11"),
    ("vae_training.yaml", ["training.gene_sp=true"], _vae_task, "item 11"),
    ("ldm_training.yaml", ["training.fsdp=true"], _ldm_task, "item 11"),
    ("ldm_training.yaml", ["training.gene_sp=true"], _ldm_task, "item 11"),
    ("ldm_training.yaml", ["training.pipeline_microbatches=4"], _ldm_task, "item 11"),
])
def test_unsupported_values_raise(config, overrides, call, item):
    """The parallel keys the port refused until ROADMAP queue 1, `item`,
    with JAX's meaning on one process: without a mesh (the CLIs build none
    on one card) `fsdp` shards nothing and `gene_sp` and
    `pipeline_microbatches` need a "model" axis above 1, so the task trains
    the same step, bit for bit, as without the key."""
    with_key = _one_step(call(small_cfg(config, SMALL_DIT + overrides)))
    without = _one_step(call(small_cfg(config, SMALL_DIT)))
    assert with_key[0] == without[0], item
    assert all(torch.equal(with_key[1][k], without[1][k]) for k in without[1])


@pytest.mark.parametrize("overrides", [
    ["model.vae_as_tokenizer.train=true"],
    ["model.transport.path_type=GVP"],
    ["model.transport.prediction=noise"],
])
def test_lifted_values_build(overrides):
    """The values the port refused before it had joint finetuning and the
    whole transport family now build the task JAX's `build_ldm_task`
    builds: the same transport (path, prediction, loss weight, epsilons)
    and the same `train_vae`, with the kernel paths off under it."""
    cfg = small_cfg("ldm_training.yaml", SMALL_DIT + overrides)
    task = build.build_ldm_task(cfg, build.build_vae(cfg), build.build_dit(cfg), 10)
    want = jax_build.build_ldm_task(cfg, jax_build.build_vae(cfg), None, jax_build.build_dit(cfg),
                                    10)
    got_t, want_t = task.transport, want.transport
    assert ((got_t.model_type.name, got_t.path_type.name, got_t.loss_type.name)
            == (want_t.model_type.name, want_t.path_type.name, want_t.loss_type.name))
    assert (got_t.train_eps, got_t.sample_eps) == (want_t.train_eps, want_t.sample_eps)
    assert task.train_vae == want.train_vae
    if task.train_vae:
        assert not task.fused_training and not task.fused_encode
        assert not want.fused_training and not want.fused_encode


def test_eval_generation_builds(tmp_path):
    """`model.eval_generation.enabled=true` builds (it raised before the
    evals were ported): the LDM task, and `train_ldm`'s hook, which runs
    only on the epochs `should_run` picks."""
    from scldm_torch.cli import train_ldm
    from scldm_torch.sampling.size_factors import constant_stats

    cfg = small_cfg("ldm_training.yaml", SMALL_DIT + ["model.eval_generation.enabled=true"])
    ldm = build.build_ldm_task(cfg, build.build_vae(cfg), build.build_dit(cfg), max_steps=10)
    vocab = constant_stats(cfg["model"]["diffusion_model"]["class_vocab_sizes"])
    hook = train_ldm.generation_eval_hook(cfg, ldm, vocab, None, tmp_path, seed=0)
    assert callable(hook)
    hook(0, {}, None)  # epoch 0: not run (it would need the datamodule and a state)
    assert not (tmp_path / "generation_eval.csv").exists()
    cfg["model"]["eval_generation"]["enabled"] = False
    assert train_ldm.generation_eval_hook(cfg, ldm, vocab, None, tmp_path, seed=0) is None


@pytest.mark.parametrize("config,overrides,call,dtype,remat", [
    ("vae_training.yaml", ["model.compute_dtype=bfloat16"], build.build_vae, torch.bfloat16, False),
    ("vae_training.yaml", ["model.compute_dtype=float32"], build.build_vae, torch.float32, False),
    ("vae_training.yaml", ["model.remat=true"], build.build_vae, torch.float32, True),
    ("ldm_training.yaml", ["model.compute_dtype=bfloat16"], build.build_dit, torch.bfloat16, False),
    ("ldm_training.yaml", ["model.compute_dtype=float32"], build.build_dit, torch.float32, False),
    ("ldm_training.yaml", ["model.remat=true"], build.build_dit, torch.float32, True),
])
def test_compute_dtype_and_remat_build(config, overrides, call, dtype, remat):
    """`model.compute_dtype` (JAX's `_DTYPES`) and `model.remat` build: f32
    weights whatever the compute dtype, which every dense layer carries, the
    same parameter names and shapes, and remat on every trunk."""
    cfg = small_cfg(config, SMALL_DIT + overrides)
    module = call(cfg)
    assert all(p.dtype == torch.float32 for p in module.parameters())
    linears = [m for m in module.modules() if isinstance(m, torch.nn.Linear)]
    assert linears and all(m.compute_dtype == dtype for m in linears)
    trunks = [module] if call is build.build_dit else [module.encoder, module.decoder]
    assert all(t.dtype == dtype and t.remat == remat for t in trunks)
    assert port_shapes(module) == port_shapes(call(small_cfg(config, SMALL_DIT)))


def test_unknown_compute_dtype_raises():
    with pytest.raises(ValueError, match="compute_dtype=float16"):
        build.build_vae(small_cfg(extra=["model.compute_dtype=float16"]))


def test_inference_refuses_n_model():
    """One process with `n_model=2` exits with JAX's message
    (scldm_tpu/cli/inference.py:74-76): the model axis must divide the
    devices, here the one rank."""
    from scldm_torch.cli import inference

    with pytest.raises(SystemExit, match="^n_model=2 must divide the device count 1$"):
        inference.main(["--config", str(ROOT / "configs/generation.yaml"), "n_model=2",
                        "device=cpu"])


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build.resolve_device({})  # the default device is the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build.build_vae(small_cfg(extra=["device=cuda"]))
