"""Tensor-parallel training on the CPU: one world of four spawned ranks over
gloo, (pod 2, data 1, model 2) (`repro_torch.launch.mesh.spawn`; the
ranks' work is `tests/torch_tp_train_cells.py`), against the reference's
sharded programs on four forced host devices, run in a subprocess
meanwhile (as tests/test_distributed.py runs them), on the same seeded
inputs:

  * the training layout's dims over ``model`` and ``data``
    (`launch.sharding.train_dims`) are where the reference's
    ``param_spec(fsdp="data" | None, moe="tp")`` puts those axes, for
    every leaf of every arch of tests/test_torch_train.py at full width,
    tp 2 and 4;
  * `moe_tp` on a (data 1, model 2) view against the reference's `moe_tp`
    on a (1, 2) mesh, on reduced dbrx-132b and llama4-scout-17b-16e, at
    the config's capacity factor (which drops tokens) and at one that
    drops none: y and the auxiliary loss within test_moe_paths_agree's
    bounds, the router's grad bit-equal on both ranks;
  * train steps at (data 1, model 2) and (data 2, model 2) against the
    reference's `build_train_step` on (1, 2) / (2, 2) meshes from the same
    ``init_params(tp=2)`` arrays, on reduced qwen2-7b and
    llama4-scout-17b-16e, and on a reduced qwen2-7b that tp = 2 pads (q
    heads and vocab): the first step's loss, grad norm and m within
    test_torch_train.py's LOSS_REL / GNORM_REL / LEAF_REL; the same steps
    against the port's tp = 1; FSDP's width threshold lowered so that
    leaves are sliced over both axes; (pod 2, model 2) ``int8_ag`` steps
    within PR 31's int8 allowances; replicated leaves bit-equal across
    model ranks throughout;
  * a tp = 2 checkpoint written at (data 2, model 2) restored by the
    reference's `CheckpointManager` and by the port's ranks, byte for byte;
  * the driver at ``--mesh single --dp-size 1 --model-size 2`` with an
    injected failure ends at ``--steps``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import torch_tp_train_cells as C  # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.launch.sharding import param_spec  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models.moe import init_moe as j_init_moe  # noqa: E402
from repro.optim import init_state as j_init_state  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.mesh import driver_shape, spawn  # noqa: E402
from repro_torch.launch.sharding import train_dims  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# test_torch_train.py's step tolerances
LOSS_REL, GNORM_REL, LEAF_REL = 5e-4, 5e-3, 5e-2
# test_moe_paths_agree's bounds (y: rtol = atol; aux: rtol); the router's
# grad against the reference's within ROUTER_GRAD_REL of its norm (the
# experts' partial sums add in another order)
MOE_Y_TOL, MOE_AUX_TOL, ROUTER_GRAD_REL = 2e-5, 1e-5, 1e-4
# one int8 step an element at most this share of a leaf's m norm (PR 31)
INT8_STEPS_MAX = 0.5
TRAIN_ARCHS = ["qwen2-7b", "llama4-scout-17b-16e", "minicpm3-4b", "internvl2-1b",
               "falcon-mamba-7b", "recurrentgemma-9b"]
WORLD = {"pod": 2, "data": 1, "model": 2}
DEADLINE = 600

REF = """
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.configs.base import RunConfig
from repro.data import DataConfig, SyntheticLM
from repro.launch.mesh import make_test_mesh, use_mesh
from repro.launch.sharding import params_shardings
from repro.launch.steps import _loss_fn, build_train_step, make_ctx
from repro.models import init_params, model_dims
from repro.models import moe as M
from repro.models.parallel import ParallelCtx
from repro.optim import AdamWConfig, apply_updates, init_state

dst, part = sys.argv[1], int(sys.argv[2])
S, B, MICRO, STEPS, LR = (int(v) if v.isdigit() else float(v) for v in sys.argv[3:8])
over = json.loads(sys.argv[8])
out = {}


def config(arch, key=None):
    cfg = get_config(arch).reduced()
    return dataclasses.replace(cfg, **over[key]) if key else cfg


SCOUT = "llama4-scout-17b-16e"
for kind, name, arch, key, shape in (
        (("pair", "qwen2-7b", "qwen2-7b", None, (1, 2)),
         ("pair", "padded", "qwen2-7b", "padded", (1, 2)),
         ("pair", SCOUT, SCOUT, None, (1, 2)),
         ("pair", "no_drop", SCOUT, "no_drop", (1, 2))),
        (("quad", "qwen2-7b", "qwen2-7b", None, (2, 2)),
         ("quad", SCOUT, SCOUT, None, (2, 2)),
         ("one", "no_drop", SCOUT, "no_drop", (1, 1))))[part]:
    cfg = config(arch, key)
    mesh = make_test_mesh(shape, ("data", "model"))
    rcfg = RunConfig(model=cfg, seq_len=S, global_batch=B, mode="train", microbatch=MICRO,
                     learning_rate=LR, warmup_steps=2)
    with use_mesh(mesh):
        step, _, shards = build_train_step(mesh, cfg, rcfg)
        params = jax.device_put(init_params(jax.random.PRNGKey(0), cfg, tp=2), shards["params"])
        opt = jax.device_put(init_state(params), shards["opt_state"])
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B))
        pre = jnp.zeros((B, 0, cfg.d_model), jnp.float32)
        for s in range(STEPS):
            t, g = data.batch(s)
            params, opt, m = step(params, opt, jnp.asarray(t), jnp.asarray(g), pre, jnp.int32(s))
            out[f"{kind}.{name}.loss.{s}"] = np.float32(m["loss"])
            out[f"{kind}.{name}.grad_norm.{s}"] = np.float32(m["grad_norm"])
            if s == 0:
                for path, leaf in jax.tree_util.tree_flatten_with_path(opt["m"])[0]:
                    k = "/".join(str(getattr(p, "key", p)) for p in path)
                    out[f"{kind}.{name}.m0.{k}"] = np.asarray(leaf)
# the (pod 2, model 2) int8_ag step's math without the compression, on a
# (1, 2) mesh: each pod's f32 grads of its half of every microbatch
# (bf16 copies, _loss_fn under the mesh's ctx: moe_tp, whose capacity and
# load-balance means see the pod's tokens only, as in the reference's
# pod-manual region) over npod, summed over the pods, AdamW from 0
mesh = make_test_mesh((1, 2), ("data", "model"))
for arch in ("qwen2-7b", SCOUT) if part == 1 else ():
    cfg = config(arch)
    rcfg = RunConfig(model=cfg, seq_len=S, global_batch=B, mode="train", microbatch=MICRO,
                     learning_rate=LR, warmup_steps=2)
    ctx = make_ctx(mesh, "train")
    p0 = init_params(jax.random.PRNGKey(0), cfg, tp=2)
    pb = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 and x.ndim >= 2
                      else x, p0)
    dims = model_dims(cfg, 2)
    with use_mesh(mesh):
        fn = jax.jit(jax.value_and_grad(
            lambda p, t, g: _loss_fn(p, t, g, cfg, rcfg, ctx, None, dims)[0]))
        t, g = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                      global_batch=B)).batch(0)
        half, n_micro, grads, loss = MICRO // 2, B // MICRO, None, 0.0
        for pod in range(2):
            for i in range(n_micro):
                rows = slice(i * MICRO + pod * half, i * MICRO + (pod + 1) * half)
                l, gi = fn(pb, jnp.asarray(t[rows]), jnp.asarray(g[rows]))
                gi = jax.tree.map(lambda x: x.astype(jnp.float32) / n_micro / 2, gi)
                grads = gi if grads is None else jax.tree.map(jnp.add, grads, gi)
                loss += float(l) / n_micro / 2
    _, st, om = apply_updates(p0, grads, init_state(p0), jnp.float32(LR),
                              AdamWConfig(grad_clip=rcfg.grad_clip))
    out[f"podwise.{arch}.loss.0"] = np.float32(loss)
    out[f"podwise.{arch}.grad_norm.0"] = np.float32(om["grad_norm"])
    for path, leaf in jax.tree_util.tree_flatten_with_path(st["m"])[0]:
        k = "/".join(str(getattr(p, "key", p)) for p in path)
        out[f"podwise.{arch}.m0.{k}"] = np.asarray(leaf)
ctx = ParallelCtx(mesh=mesh, dp_axes=(), tp_axis="model")
for i, arch in enumerate(("dbrx-132b", SCOUT) if part == 0 else ()):
    rng = np.random.default_rng(70 + i)
    x = rng.standard_normal((2, 16, 128)).astype(np.float32)
    r = rng.standard_normal((2, 16, 128)).astype(np.float32)
    for key in ("own", "no_drop"):
        cfg = config(arch, None if key == "own" else key)
        p = M.init_moe(jax.random.PRNGKey(0), cfg)

        def f(p, x):
            y, aux = M.moe_tp(p, x, cfg, ctx)
            return (y * r).sum() + aux, (y, aux)

        with use_mesh(mesh):
            p = jax.device_put(p, params_shardings(p, mesh, fsdp=False, moe="tp"))
            (_, (y, aux)), g = jax.jit(jax.value_and_grad(f, has_aux=True))(p, jnp.asarray(x))
        out[f"moe.{arch}.{key}.y"] = np.asarray(y)
        out[f"moe.{arch}.{key}.aux"] = np.float32(aux)
        out[f"moe.{arch}.{key}.router_grad"] = np.asarray(g["router"]["w"])
np.savez(dst, **out)
"""


def _np_params():
    """The reference's ``init_params(PRNGKey(0), cfg, tp=2)`` as numpy: each
    arch, and the padded qwen2-7b (``padded``)."""
    out = {}
    for key, arch, over in [(a, a, None) for a in C.ARCHS] + [("padded", "qwen2-7b", C.PADDED)]:
        cfg = get_config(arch).reduced()
        cfg = dataclasses.replace(cfg, **over) if over else cfg
        out[key] = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), cfg, tp=2))
    return out


def _moe_inputs():
    """Per MoE arch: the reference's ``init_moe(PRNGKey(0), cfg)`` as numpy
    and the seeded x / r [2, 16, D] (the reference's script draws the same)."""
    out = {}
    for i, arch in enumerate(C.MOE_ARCHS):
        rng = np.random.default_rng(70 + i)
        x = rng.standard_normal((*C.MOE_SHAPE, 128)).astype(np.float32)
        r = rng.standard_normal((*C.MOE_SHAPE, 128)).astype(np.float32)
        p = jax.tree.map(np.asarray, j_init_moe(jax.random.PRNGKey(0), get_config(arch).reduced()))
        out[arch] = {"params": p, "xr": (x, r)}
    return out


@pytest.fixture(scope="module")
def run():
    """(the world's four results, the reference's results, the port's tp =
    1 runs, the checkpoint's restores by the reference and the port)."""
    np_params, moe_inputs = _np_params(), _moe_inputs()
    with tempfile.TemporaryDirectory(prefix="tp-train-") as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        dsts = [os.path.join(tmp, f"out{i}.npz") for i in range(2)]
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        tail = [str(v) for v in (C.S, C.B, C.MICRO, C.STEPS, C.LR)] + [
            json.dumps({"padded": C.PADDED, "no_drop": C.NO_DROP})]
        with ThreadPoolExecutor(3) as pool:           # the reference's runs in two halves
            refs = [pool.submit(subprocess.run, [sys.executable, "-c", REF, dst, str(i)] + tail,
                                capture_output=True, text=True, timeout=DEADLINE, env=env,
                                cwd=REPO) for i, dst in enumerate(dsts)]
            world = pool.submit(spawn, C.tp_world, WORLD, "cpu", np_params, moe_inputs, ckpt,
                                deadline=DEADLINE)
            one = C.one_rank(np_params, moe_inputs)
            ranks = world.result()
            done = [r.result() for r in refs]
        for r in done:
            assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr[-3000:]}"
        want = {k: v for dst in dsts for k, v in np.load(dst).items()}
        j_like = {"params": np_params["qwen2-7b"], "opt": j_init_state(np_params["qwen2-7b"])}
        j_restored = JCheckpointManager(ckpt).restore(j_like)
        yield dict(ranks=ranks, want=want, one=one, j_restored=j_restored,
                   moe_inputs=moe_inputs)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(float(np.linalg.norm(b)), 1e-30))


def _pod(ranks, pod):
    return [r for r in ranks if r["coords"]["pod"] == pod]


def _close(got, ref_loss, ref_gn):
    assert abs(got["loss"] - ref_loss) <= LOSS_REL * abs(ref_loss), (got, ref_loss)
    assert abs(got["grad_norm"] - ref_gn) <= GNORM_REL * ref_gn, (got, ref_gn)


def _replicated_equal(res):
    """Every rank's metrics the same at every step; the leaves (params and
    m) whole over ``model`` bit-equal on the model ranks of each data
    index, the sliced ones each rank's own."""
    for other in res[1:]:
        assert other["metrics"] == res[0]["metrics"]
    by_data = {}
    for r in res:
        by_data.setdefault(r["coords"]["data"], []).append(r)
    n_whole = 0
    for group in by_data.values():
        a = group[0]
        for b in group[1:]:
            for k, d in a["model_dims"].items():
                if d is None:
                    n_whole += 1
                    for tree in ("own", "own_m", "own_m0"):
                        assert torch.equal(a[tree][k], b[tree][k]), (tree, k)
    assert n_whole > 0


# ------------------------------------------------------------------ layout
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_dims_are_the_reference_specs(arch, tp):
    """At full width and the dims of ``init_params(tp=tp)`` (abstract
    shapes), each leaf's dims over ``model`` and ``data`` are where the
    reference's ``param_spec(fsdp="data" | None, moe="tp")`` puts them."""
    cfg = get_config(arch)
    shapes = jax.eval_shape(lambda k: j_init_params(k, cfg, tp=tp), jax.random.PRNGKey(0))
    n_model = n_data = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        names = [str(getattr(p, "key", p)) for p in path]
        n_stack = int(names[0] == "layers")
        meta = torch.empty(leaf.shape, device="meta")
        for fsdp in (True, False):
            spec = param_spec(path, leaf, fsdp="data" if fsdp else None, n_stack=n_stack,
                              moe="tp")
            want = tuple(next((i for i, a in enumerate(spec) if a == ax), None)
                         for ax in ("model", "data"))
            assert train_dims(names, meta, n_stack, fsdp) == want, (names, leaf.shape, spec)
            if want[0] is not None:
                assert leaf.shape[want[0]] % tp == 0, (names, leaf.shape)
        n_model += want[0] is not None
        n_data += train_dims(names, meta, n_stack)[1] is not None
    assert n_model > 0
    assert n_data > 0 or cfg.d_model < 1024                   # internvl2-1b's 896


def test_driver_meshes_with_a_model_axis():
    """``--mesh single`` over W ranks with a model axis of M is (data W / M,
    model M), ``multi`` (pod 2, data W / 2M, model M); M = 1 is PR 31's
    shapes; a world that does not divide raises."""
    assert driver_shape("single", 4, 2) == {"data": 2, "model": 2}
    assert driver_shape("single", 2, 2) == {"data": 1, "model": 2}
    assert driver_shape("multi", 8, 2) == {"pod": 2, "data": 2, "model": 2}
    assert driver_shape("multi", 4) == {"pod": 2, "data": 2, "model": 1}
    with pytest.raises(ValueError, match="divide"):
        driver_shape("single", 3, 2)
    with pytest.raises(ValueError, match="two pods"):
        driver_shape("multi", 6, 2)


# --------------------------------------------------------------------- MoE
@pytest.mark.parametrize("cf", ["own", "no_drop"])
@pytest.mark.parametrize("arch", C.MOE_ARCHS)
def test_moe_tp_matches_the_reference(run, arch, cf):
    """`moe_tp` on two ranks against the reference's on a (1, 2) mesh: y
    within MOE_Y_TOL, aux within MOE_AUX_TOL (test_moe_paths_agree's
    bounds), the router's grad within ROUTER_GRAD_REL; the two ranks' y,
    aux and router grad bit-equal (each expert's output summed over the
    ranks before it meets its gate). ``own``: the config's capacity factor
    1.25, which drops tokens; ``no_drop``: 8."""
    want = run["want"]
    pod = C.MOE_ARCHS.index(arch)
    res = [r["moe"][cf] for r in _pod(run["ranks"], pod)]
    y, aux = want[f"moe.{arch}.{cf}.y"], float(want[f"moe.{arch}.{cf}.aux"])
    np.testing.assert_allclose(res[0]["y"].numpy(), y, rtol=MOE_Y_TOL, atol=MOE_Y_TOL)
    np.testing.assert_allclose(res[0]["aux"], aux, rtol=MOE_AUX_TOL)
    assert _rel(res[0]["router_grad"].numpy(), want[f"moe.{arch}.{cf}.router_grad"]) \
        <= ROUTER_GRAD_REL
    assert torch.equal(res[0]["router_grad"], res[1]["router_grad"])
    assert torch.equal(res[0]["y"], res[1]["y"]) and res[0]["aux"] == res[1]["aux"]
    assert torch.equal(res[0]["x_grad"], res[1]["x_grad"])


@pytest.mark.parametrize("arch", C.MOE_ARCHS)
def test_moe_tp_on_one_rank_without_drops_is_the_dense_moe(run, arch):
    """At the capacity factor that drops nothing `moe_tp` on one rank is
    `moe_dense` (the reference's test_moe_paths_agree): y within
    MOE_Y_TOL, aux within MOE_AUX_TOL, and two ranks' `moe_tp` within the
    same of one rank's."""
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.moe import moe_dense

    inp = run["moe_inputs"][arch]
    cfg = C.config(arch, C.NO_DROP)
    y, aux = moe_dense(params_from_numpy(inp["params"]), torch.from_numpy(inp["xr"][0]), cfg)
    one = run["one"]["moe"][arch]
    np.testing.assert_allclose(one["y"].numpy(), y.numpy(), rtol=MOE_Y_TOL, atol=MOE_Y_TOL)
    np.testing.assert_allclose(one["aux"], float(aux), rtol=MOE_AUX_TOL)
    two = _pod(run["ranks"], C.MOE_ARCHS.index(arch))[0]["moe"]["no_drop"]
    np.testing.assert_allclose(two["y"].numpy(), one["y"].numpy(), rtol=MOE_Y_TOL,
                               atol=MOE_Y_TOL)


# -------------------------------------------------------------- train steps
@pytest.mark.parametrize("kind", ["pair", "quad"])
@pytest.mark.parametrize("arch", C.ARCHS)
def test_tp_steps_match_the_reference(run, arch, kind):
    """(data 1, model 2) (``pair``, the pod of the arch) and (data 2, model
    2) (``quad``) against the reference's sharded step from the same
    ``init_params(tp=2)`` arrays: the first step's loss and grad norm within
    LOSS_REL / GNORM_REL, each leaf's m within LEAF_REL of its norm; the
    ranks' metrics bit-equal at every step and every leaf whole over
    ``model`` bit-equal on the model ranks (params, m)."""
    want = run["want"]
    res = ([r["pair"][arch] for r in _pod(run["ranks"], C.ARCHS.index(arch))]
           if kind == "pair" else [r["quad"][arch] for r in run["ranks"]])
    _close(res[0]["metrics"][0], float(want[f"{kind}.{arch}.loss.0"]),
           float(want[f"{kind}.{arch}.grad_norm.0"]))
    for k, m in res[0]["m0"].items():
        assert _rel(m.numpy(), want[f"{kind}.{arch}.m0.{k}"]) <= LEAF_REL, k
    _replicated_equal(res)


@pytest.mark.parametrize("arch", C.ARCHS)
def test_tp2_matches_tp1(run, arch):
    """Where tp = 2 pads nothing (the reduced configs), the (data 1, model
    2) steps against the port's tp = 1 from the same arrays: the first
    step's loss within LOSS_REL, m within LEAF_REL, the grad norm within
    GNORM_REL. Scout at the capacity factor that drops nothing: `moe_tp`'s
    grads differ from tp = 1's `moe_dense`'s in the reference itself (its
    grad norms at (1, 2) and (1, 1) lie 0.78 % apart, the embedding's m 5
    %), so there the port's gap between tp = 2 and tp = 1 in the grad norm
    is held to the reference's gap within GNORM_REL of the norm, and m at
    each tp to the reference's at that tp within LEAF_REL."""
    key = "no_drop" if arch == "llama4-scout-17b-16e" else arch
    want = run["want"]
    two = _pod(run["ranks"], C.ARCHS.index(arch))[0]["pair"][key]
    one = run["one"][key]
    a, b = two["metrics"][0], one["metrics"][0]
    assert abs(a["loss"] - b["loss"]) <= LOSS_REL * abs(b["loss"]), (a, b)
    if key == "no_drop":
        gap = float(want["pair.no_drop.grad_norm.0"]) - float(want["one.no_drop.grad_norm.0"])
        assert abs((a["grad_norm"] - b["grad_norm"]) - gap) <= GNORM_REL * b["grad_norm"]
    else:
        assert abs(a["grad_norm"] - b["grad_norm"]) <= GNORM_REL * b["grad_norm"]
    for k, m in two["m0"].items():
        assert m.shape == one["m0"][k].shape, k
        if key == "no_drop":                    # each against the reference at its tp
            assert _rel(m.numpy(), want[f"pair.no_drop.m0.{k}"]) <= LEAF_REL, k
            assert _rel(one["m0"][k].numpy(), want[f"one.no_drop.m0.{k}"]) <= LEAF_REL, k
        else:
            assert _rel(m.numpy(), one["m0"][k].numpy()) <= LEAF_REL, k


def test_padded_heads_and_vocab_match_the_reference(run):
    """A reduced qwen2-7b with 3 q heads over one kv head and a vocab of
    509, which tp = 2 pads to 4 heads (one a dead head, masked) and 510
    slots (one masked by the vocab bias), and whose kv head does not split
    over the ranks (k / v gathered), against the reference's (1, 2) step
    from its ``init_params(tp=2)``: loss, grad norm and m as above; the
    padded head's and slot's m zero."""
    want = run["want"]
    res = [r["pair"]["padded"] for r in _pod(run["ranks"], 0)]
    _close(res[0]["metrics"][0], float(want["pair.padded.loss.0"]),
           float(want["pair.padded.grad_norm.0"]))
    for k, m in res[0]["m0"].items():
        assert _rel(m.numpy(), want[f"pair.padded.m0.{k}"]) <= LEAF_REL, k
    m0 = res[0]["m0"]
    assert m0["lm_head/w"].shape[-1] == 510 and m0["embed/w"].shape[0] == 510
    assert not m0["lm_head/w"][:, 509].any() and not m0["embed/w"][509].any()
    assert m0["layers/sub0/attn/wq/w"].shape[-1] == 4 * 32
    assert not m0["layers/sub0/attn/wo/w"][:, 3 * 32:].any()
    _replicated_equal(res)


def test_fsdp_slices_over_data_and_model(run):
    """qwen2-7b at (data 2, model 2) with FSDP's width threshold lowered:
    leaves are sliced over both axes (a column-parallel one's N over model
    and K over data, a row-parallel one's the reverse), each rank holding
    the quarter (or half) at its coordinates of the gathered whole, params
    and m alike; the steps within LOSS_REL / GNORM_REL / LEAF_REL of the
    reference's (2, 2) step and of the same mesh without the slices."""
    want = run["want"]
    res = [r["fsdp"] for r in run["ranks"]]
    _close(res[0]["metrics"][0], float(want["quad.qwen2-7b.loss.0"]),
           float(want["quad.qwen2-7b.grad_norm.0"]))
    plain = run["ranks"][0]["quad"]["qwen2-7b"]["metrics"][0]
    _close(res[0]["metrics"][0], plain["loss"], plain["grad_norm"])
    for k, m in res[0]["m0"].items():
        assert _rel(m.numpy(), want[f"quad.qwen2-7b.m0.{k}"]) <= LEAF_REL, k
    ddims, mdims = res[0]["data_dims"], res[0]["model_dims"]
    both = [k for k in ddims if ddims[k] is not None and mdims[k] is not None]
    assert len(both) >= 5
    assert ddims["layers/sub0/attn/wq/w"] == 1 and mdims["layers/sub0/attn/wq/w"] == 2
    assert ddims["layers/sub0/attn/wo/w"] == 2 and mdims["layers/sub0/attn/wo/w"] == 1
    for r in res:
        c = r["coords"]
        for k in ddims:
            whole, own = r["params"][k], r["own"][k]
            for d, i in ((mdims[k], c["model"]), (ddims[k], c["data"])):
                if d is not None:
                    n = whole.shape[d] // 2
                    whole = whole.narrow(d, i * n, n)
            assert torch.equal(own, whole), k
            assert r["own_m"][k].shape == own.shape, k
    assert res[1]["metrics"] == res[0]["metrics"]
    for a, b in ((res[0], res[1]), (res[2], res[3])):        # model ranks of a data index
        for k, d in mdims.items():
            if d is None:
                assert torch.equal(a["own"][k], b["own"][k]), k


def _int8_steps_norm(ranks, key, dims) -> float:
    """The norm over a leaf of one int8 step an element, read from the
    ranks' own slices of m after step 0: each model slice (pod 0's ranks;
    one of them for a leaf whole over ``model``) split in its two pod
    shards, a shard's step its max |m| / 127 (0 where the slice falls back
    to the plain sum)."""
    total = 0.0
    for r in ranks:
        if r["coords"]["pod"] or (dims[key] is None and r["coords"]["model"]):
            continue
        flat = r["own_m0"][key].numpy().astype(np.float64).reshape(-1)
        if flat.size % 2 or flat.size < 16:
            continue
        for shard in flat.reshape(2, -1):
            total += shard.size * (np.abs(shard).max() / 127) ** 2
    return float(np.sqrt(total))


@pytest.mark.parametrize("arch", C.ARCHS)
def test_int8_over_pods_within_the_int8_allowance(run, arch):
    """(pod 2, model 2) with ``int8_ag`` against the same step's math
    without the compression in the reference (each pod's grads of its rows
    through the reference's loss under a (1, 2) mesh's ctx, summed over
    the pods, AdamW; the reference's int8_ag step does not build with a
    model axis on this jax): the first step's loss within LOSS_REL, its
    grad norm within GNORM_REL plus the norm of the int8 error the ranks
    measured (each pod shard of each model slice once), and each leaf's m
    within LEAF_REL of its norm plus one int8 step an element, that
    allowance under INT8_STEPS_MAX of the norm; each compressed shard
    within amax / 254 of its f32 sum; replicated leaves bit-equal."""
    want = run["want"]
    res = [r["int8"][arch] for r in run["ranks"]]
    got = res[0]["metrics"][0]
    loss = float(want[f"podwise.{arch}.loss.0"])
    gn = float(want[f"podwise.{arch}.grad_norm.0"])
    assert abs(got["loss"] - loss) <= LOSS_REL * abs(loss), (got, loss)
    mdims = res[0]["model_dims"]
    err_sq, n_int8 = 0.0, 0
    for r in res:
        for k, st in r["stats"].items():
            if st["fallback"] or (mdims[k] is None and r["coords"]["model"]):
                continue
            assert st["max_err"] <= st["amax"] / 254 * (1 + 1e-5), (k, st)
            err_sq += st["err_sq"]
            n_int8 += 1
    assert n_int8 > 0
    assert abs(got["grad_norm"] - gn) <= GNORM_REL * gn + np.sqrt(err_sq), (got, gn, err_sq)
    for k, m in res[0]["m0"].items():
        ref = want[f"podwise.{arch}.m0.{k}"]
        norm = float(np.linalg.norm(ref.astype(np.float64)))
        steps = _int8_steps_norm(res, k, mdims)
        assert steps <= INT8_STEPS_MAX * norm, (k, steps, norm)
        assert _rel(m.numpy(), ref) * norm <= LEAF_REL * norm + steps, k
    for a in res[1:]:
        assert a["metrics"] == res[0]["metrics"]
    for a, b in ((res[0], res[1]), (res[2], res[3])):
        for k, d in mdims.items():
            if d is None:
                assert torch.equal(a["own"][k], b["own"][k]), k


# ------------------------------------------------------------- checkpoints
def test_tp2_checkpoint_round_trips_with_the_reference(run):
    """The (data 2, model 2) checkpoint of (model, data) slices holds whole
    arrays at the tp = 2 shapes: the reference's `CheckpointManager`
    restores it into ``init_params(tp=2)``'s tree, every param the ranks'
    gathered whole byte for byte, the step present; each rank's own
    restore gives its slices of params, m and v byte for byte."""
    res = [r["fsdp"] for r in run["ranks"]]
    jtree, jstep = run["j_restored"]
    assert jstep == C.STEPS
    jgot = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    for k, v in res[0]["params"].items():
        assert jgot[f"params/{k}"].tobytes() == v.numpy().tobytes(), k
    assert int(jgot["opt/step"]) == C.STEPS
    for r in res:
        at, back, own = r["restored"]
        assert at == C.STEPS and set(back) == set(own)
        for k, v in own.items():
            assert back[k].numpy().tobytes() == v.numpy().tobytes(), k


# ------------------------------------------------------------------ driver
ARGS = ["--arch", "qwen2-7b", "--reduced", "--seq-len", "32", "--global-batch", "4",
        "--log-every", "2", "--device", "cpu"]


def test_driver_single_model2_with_an_injected_failure(monkeypatch, tmp_path):
    """``--mesh single --dp-size 1 --model-size 2`` spawns a (data 1, model
    2) world; a failure injected at step 3 restores both ranks from the
    checkpoint at step 2 (whole arrays at the tp = 2 shapes) and the run
    ends at ``--steps`` with finite losses, its first steps the tp = 1
    driver's within LOSS_REL (reduced qwen2-7b pads nothing at tp = 2)."""
    monkeypatch.setenv("REPRO_INJECT_FAIL_AT", "3")
    ck = str(tmp_path / "ck")
    losses = train.main(ARGS + ["--steps", "5", "--mesh", "single", "--dp-size", "1",
                                "--model-size", "2", "--ckpt-dir", ck, "--ckpt-every", "2"])
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert CheckpointManager(ck).latest_step() == 5
    monkeypatch.delenv("REPRO_INJECT_FAIL_AT")
    one = train.main(ARGS + ["--steps", "2"])
    for a, b in zip(losses[:2], one):
        assert abs(a - b) <= LOSS_REL * abs(b)
