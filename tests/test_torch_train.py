"""Port parity of the training path on the CPU against the JAX package:
the synthetic data pipeline and the warmup-cosine schedule bit for bit,
AdamW within ADAMW_ULPS; one `build_train_step` step per block kind
(reduced configs, the reference's own `init_params` carried across with
`params_from_numpy`)
within stated tolerances; the driver `launch.train.main` learns and
starts as the reference's driver does; its meshes and compressed
gradients train (tests/test_torch_dp.py holds them against the
reference's sharded steps); a model axis > 1 is refused.

Step tolerances (measured worst case over the six configurations, one
step at B 4, microbatch 2, 32 tokens): the loss within LOSS_REL (measured
1.2e-4, falcon-mamba-7b, whose chunked scan associates otherwise;
qwen2-7b's loss is bit-equal), the grad norm within GNORM_REL (measured
1.2e-3, recurrentgemma-9b), and every leaf's gradient, read from the first
moment m = (1 - b1) clip(g) after the step, within LEAF_REL of its norm
(measured 2.3e-2, falcon-mamba-7b's A_log): the backward's bf16 products
round apart from XLA's. Remat on and off give the same bits.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import RunConfig as JRunConfig  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.data import prefix_embeds_stub as j_prefix_embeds_stub  # noqa: E402
from repro.launch import train as j_train  # noqa: E402
from repro.launch.mesh import make_driver_mesh, use_mesh  # noqa: E402
from repro.launch.steps import build_train_step as j_build_train_step  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import apply_updates as j_apply_updates  # noqa: E402
from repro.optim import init_state as j_init_state  # noqa: E402
from repro.optim import warmup_cosine as j_warmup_cosine  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.core.tree import tree_items  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM, prefix_embeds_stub  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import build_train_step  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import AdamWConfig, apply_updates, init_state, warmup_cosine  # noqa: E402

LOSS_REL, GNORM_REL, LEAF_REL = 5e-4, 5e-3, 5e-2
# AdamW against the jitted reference, twelve steps: each leaf's params, m
# and v within ADAMW_ULPS ulp of the leaf's largest |value| (measured 4, 5
# and 8: XLA contracts multiply-adds the port rounds twice), the grad norm
# within ADAMW_GNORM_REL (measured 1.9e-7: another summation order)
ADAMW_ULPS, ADAMW_GNORM_REL = 16, 1e-6
ARCHS = ["qwen2-7b", "llama4-scout-17b-16e", "minicpm3-4b", "internvl2-1b",
         "falcon-mamba-7b", "recurrentgemma-9b"]


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("step,shard,num_shards", [(0, 0, 1), (7, 0, 2), (7, 1, 2),
                                                   (123, 3, 4), (5000, 0, 1)])
def test_synthetic_batches_are_the_reference(step, shard, num_shards):
    jd = JSyntheticLM(JDataConfig(vocab_size=152064, seq_len=96, global_batch=8))
    td = SyntheticLM(DataConfig(vocab_size=152064, seq_len=96, global_batch=8))
    for a, b in zip(jd.batch(step, shard, num_shards), td.batch(step, shard, num_shards)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("arch", ["internvl2-1b", "qwen2-7b"])
def test_prefix_embeds_stub_is_the_reference(arch):
    cfg, tcfg = get_config(arch).reduced(), t_get_config(arch).reduced()
    a, b = j_prefix_embeds_stub(cfg, 3, seed=11), prefix_embeds_stub(tcfg, 3, seed=11)
    assert (a is None and b is None) or (a.dtype == b.dtype and np.array_equal(a, b))


# --------------------------------------------------------------- schedule
@pytest.mark.parametrize("lr,warmup", [(1e-3, 5), (3e-4, 100), (2e-4, 1200)])
def test_warmup_cosine_is_bit_equal(lr, warmup):
    """Steps 0-12000 as a tensor against the jitted reference (the cosine
    is the C library's cosf on both sides: XLA calls it), and the first
    steps as Python ints."""
    steps = np.arange(0, 12001, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(lambda s: j_warmup_cosine(s, lr, warmup, 10_000)))(steps))
    got = warmup_cosine(torch.from_numpy(steps), lr, warmup, 10_000).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    ints = np.array([float(warmup_cosine(int(s), lr, warmup, 10_000)) for s in steps[:8]],
                    np.float32)
    assert np.array_equal(_bits(ints), _bits(want[:8]))


# ------------------------------------------------------------------ AdamW
def _reduced_tree(arch, seed):
    return jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(seed),
                                                  get_config(arch).reduced()))


@pytest.mark.parametrize("arch", ["qwen2-7b", "minicpm3-4b"])
def test_apply_updates_is_bit_equal(arch):
    """Twelve AdamW steps on a reduced model's f32 tree, grads drawn from a
    seed (every other step large enough to clip), against the jitted
    reference: the step bit-equal, params, m and v within ADAMW_ULPS ulp of
    each leaf's largest value, the grad norm within ADAMW_GNORM_REL."""
    rng = np.random.default_rng(0)
    p_np = _reduced_tree(arch, 0)
    jp, jst = p_np, j_init_state(p_np)
    tp = params_from_numpy(p_np)
    tst = init_state(tp)
    step = jax.jit(lambda p, g, s, lr: j_apply_updates(p, g, s, lr, JAdamWConfig()))
    for it in range(12):
        scale = 1e-3 if it % 2 else 0.5
        g = jax.tree.map(lambda x: (scale * rng.standard_normal(x.shape)).astype(np.float32),
                         p_np)
        lr = np.float32(1e-3 * (it + 1))
        jp, jst, jm = step(jp, g, jst, jnp.float32(lr))
        # the port scales its grads in place: give it its own copy
        tp, tst, tm = apply_updates(tp, params_from_numpy(jax.tree.map(np.copy, g)), tst,
                                    torch.tensor(lr), AdamWConfig())
        gn = float(jm["grad_norm"])
        assert abs(float(tm["grad_norm"]) - gn) <= ADAMW_GNORM_REL * gn, it
        for want, got in ((jp, tp), (jst["m"], tst["m"]), (jst["v"], tst["v"])):
            for a, (path, b) in zip(jax.tree.leaves(want), tree_items(got)):
                a = np.asarray(a)
                ulps = np.abs(b.numpy() - a).max() / np.spacing(np.abs(a).max())
                assert ulps <= ADAMW_ULPS, (it, path, ulps)
        assert int(tst["step"]) == int(jst["step"]) == it + 1


def test_weight_decay_only_on_leaves_named_w():
    """Zero grads: only the ``w`` leaves shrink (decoupled decay), norms and
    biases stay as they were, as in the reference."""
    p_np = _reduced_tree("qwen2-7b", 1)
    tp = params_from_numpy(p_np)
    zero = params_from_numpy(jax.tree.map(np.zeros_like, p_np))
    tp, _, _ = apply_updates(tp, zero, init_state(tp), 0.1, AdamWConfig(weight_decay=0.5))
    for (path, got), want in zip(tree_items(tp), jax.tree.leaves(p_np)):
        moved = not np.array_equal(got.numpy(), want)
        assert moved == (path[-1] == "w"), path


# ------------------------------------------------------------ train step
def _configs(arch, S=32, B=4, micro=2):
    cfg, tcfg = get_config(arch).reduced(), t_get_config(arch).reduced()
    kw = dict(seq_len=S, global_batch=B, microbatch=micro, learning_rate=1e-3, warmup_steps=2)
    return cfg, tcfg, JRunConfig(model=cfg, **kw), RunConfig(model=tcfg, **kw)


def _batch(cfg, rcfg, step=0):
    pn = cfg.num_prefix_embeds
    data = JSyntheticLM(JDataConfig(vocab_size=cfg.vocab_size, seq_len=rcfg.seq_len - pn,
                                    global_batch=rcfg.global_batch))
    toks, tgts = data.batch(step)
    pre = j_prefix_embeds_stub(cfg, rcfg.global_batch, seed=step)
    if pre is None:
        pre = np.zeros((rcfg.global_batch, 0, cfg.d_model), np.float32)
    return toks, tgts, pre


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(float(np.linalg.norm(np.asarray(b))), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One step of the reference's `build_train_step(make_driver_mesh("none"),
    ...)` and of the port's from the same params and batch: loss, grad norm
    and every leaf's gradient (through m) within the module's tolerances,
    lr bit-equal; the port's step with remat on and off gives the same
    params, m and v bit for bit."""
    cfg, tcfg, jr, tr = _configs(arch)
    p_np = _reduced_tree(arch, 0)
    toks, tgts, pre = _batch(cfg, jr)
    mesh = make_driver_mesh("none")
    with use_mesh(mesh):
        jstep, _, _ = j_build_train_step(mesh, cfg, jr)
        jp = jax.tree.map(jnp.asarray, p_np)
        _, jo, jm = jstep(jp, j_init_state(jp), jnp.asarray(toks), jnp.asarray(tgts),
                          jnp.asarray(pre), jnp.int32(0))
    runs = []
    for remat in (True, False):
        step = build_train_step(tcfg, dataclasses.replace(tr, remat=remat), device="cpu")
        tp = params_from_numpy(p_np)
        runs.append(step(tp, init_state(tp), torch.from_numpy(toks), torch.from_numpy(tgts),
                         torch.from_numpy(pre), 0))
    tp, to, tm = runs[0]
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_REL * abs(float(jm["loss"]))
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
        GNORM_REL * float(jm["grad_norm"])
    assert _bits(tm["lr"].numpy()) == _bits(jm["lr"])
    for a, (path, b) in zip(jax.tree.leaves(jo["m"]), tree_items(to["m"])):
        assert _rel(b.numpy(), a) <= LEAF_REL, path
    for tree in ("p", "m", "v"):
        pick = {"p": lambda r: r[0], "m": lambda r: r[1]["m"], "v": lambda r: r[1]["v"]}[tree]
        for (_, a), (_, b) in zip(tree_items(pick(runs[0])), tree_items(pick(runs[1]))):
            assert torch.equal(a, b), tree


def test_remat_recomputes_the_pattern_groups(monkeypatch):
    """With remat the block forward runs again in the backward pass, once
    per block of each repeat of the pattern (the tail is not recomputed);
    without it, once."""
    import repro_torch.models.transformer as T

    cfg, tcfg, _, tr = _configs("recurrentgemma-9b")
    tcfg = dataclasses.replace(tcfg, num_layers=5)          # one repeat of 3 and a tail of 2
    p_np = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0),
                                                  dataclasses.replace(cfg, num_layers=5)))
    toks, tgts, pre = _batch(cfg, tr)
    calls = []
    real = T.block_seq
    monkeypatch.setattr(T, "block_seq", lambda *a, **k: calls.append(1) or real(*a, **k))
    for remat, want in ((True, 5 + 3), (False, 5)):
        calls.clear()
        step = build_train_step(tcfg, dataclasses.replace(tr, remat=remat, microbatch=4),
                                device="cpu")
        tp = params_from_numpy(p_np)
        step(tp, init_state(tp), torch.from_numpy(toks), torch.from_numpy(tgts), None, 0)
        assert len(calls) == want, remat


# ---------------------------------------------------------------- driver
ARGS = ["--arch", "qwen2-7b", "--reduced", "--seq-len", "32", "--global-batch", "4",
        "--log-every", "10"]


def test_train_main_learns_and_starts_as_the_reference(capsys):
    """The port's driver on the CPU from the reference's own initial params
    (PRNGKey(0), as its driver draws them): thirty steps, the loss falls
    (the last five steps' mean well below the first loss), and the first
    three losses are the reference driver's within LOSS_REL."""
    cfg = get_config("qwen2-7b").reduced()
    p0 = params_from_numpy(jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), cfg)))
    losses = train.main(ARGS + ["--steps", "30", "--device", "cpu"], params=p0)
    want = j_train.main(ARGS + ["--steps", "3"])
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < losses[0] - 1.0
    for a, b in zip(losses[:3], want):
        assert abs(a - b) <= LOSS_REL * abs(b)


@pytest.mark.parametrize("flag,value", [("--mesh", "single"), ("--mesh", "multi"),
                                        ("--grad-compression", "int8_ag")])
def test_train_main_refuses_what_is_not_ported(flag, value):
    """Meshes and compressed gradients are ported now: ``--mesh single``
    (one spawned rank), ``--mesh multi`` (two pods of one rank each) and
    ``--grad-compression int8_ag`` (a no-op without a pod axis, as in the
    reference) train, their first loss the single-device driver's within
    LOSS_REL (the bits where nothing is exchanged); a model axis > 1 in
    training, refused before, is ported too: the driver's mesh of two ranks
    at ``--model-size 2`` is (data 1, model 2) (tests/test_torch_tp_train.py
    trains it)."""
    from repro_torch.launch.mesh import driver_shape

    extra = ["--dp-size", "2"] if value == "multi" else []
    losses = train.main(ARGS + ["--steps", "1", "--device", "cpu", flag, value] + extra)
    plain = train.main(ARGS + ["--steps", "1", "--device", "cpu"])
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert abs(losses[0] - plain[0]) <= LOSS_REL * abs(plain[0])
    if flag == "--grad-compression":
        assert losses == plain
    assert driver_shape(value if flag == "--mesh" else "single", 4, 2) == (
        {"pod": 2, "data": 1, "model": 2} if value == "multi" else {"data": 2, "model": 2})


def test_train_step_refuses_compressed_gradients():
    """``int8_ag`` without a pod axis leaves the step as it is (the
    reference's ``compress`` needs ``pod`` among the dp axes): the same
    bits as ``none``. A train step on model shards, refused before, builds
    now: its ``shard`` keeps the rank's half of each model-sharded leaf
    (tests/test_torch_tp_train.py runs it)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.parallel import ParallelCtx

    cfg, tcfg, jr, tr = _configs("qwen2-7b")
    toks, tgts, _ = _batch(cfg, jr)
    p_np = _reduced_tree("qwen2-7b", 0)
    out = []
    for comp in ("none", "int8_ag"):
        step = build_train_step(tcfg, dataclasses.replace(tr, grad_compression=comp), "cpu")
        tp = params_from_numpy(p_np)
        out.append(step(tp, init_state(tp), torch.from_numpy(toks), torch.from_numpy(tgts),
                        None, 0))
    assert {k: float(v) for k, v in out[0][2].items()} == \
        {k: float(v) for k, v in out[1][2].items()}
    for (_, a), (_, b) in zip(tree_items(out[0][0]), tree_items(out[1][0])):
        assert torch.equal(a, b)
    ctx = ParallelCtx(mesh=Mesh({"data": 1, "model": 2}), tp_axis="model")
    step = build_train_step(tcfg, tr, "cpu", ctx)
    whole = params_from_numpy(p_np)
    mine = dict(tree_items(step.shard(whole)))
    dims = dict(tree_items(step.layout("model")))
    for path, t in tree_items(whole):
        d = dims[path]
        assert mine[path].shape == (t.shape if d is None else
                                    t.narrow(d, 0, t.shape[d] // 2).shape), path
    assert sum(d is not None for d in dims.values()) >= 10
