"""Data-parallel training on the CPU: one world of four spawned ranks over
gloo, (pod 2, data 2, model 1) (`repro_torch.launch.mesh.spawn`; the
ranks' work is `tests/torch_dp_cells.py`), against the reference's
sharded programs on four forced host devices, run in a subprocess meanwhile
(as tests/test_distributed.py runs them), on the same seeded inputs:

  * `compressed_psum` over two ranks bit-equal to the reference's (its
    reduce-scatter adds two shards, which commutes), over four within the
    reference's bound (amax / 127); the leaves that fall back to the plain
    sum exact;
  * the reference's FSDP shard dims (`params_shardings(fsdp=True, moe="tp")`
    at model = 1) for every arch of tests/test_torch_train.py, at full width;
  * dp = 2 train steps (``--mesh single``) and (pod 2, data 2) ``int8_ag``
    steps against the reference's `build_train_step` on (2, 1) and
    (2, 2, 1) meshes, on reduced qwen2-7b and llama4-scout-17b-16e (whose
    load-balance loss takes means over the ranks' tokens): the first step's
    loss, grad norm and m within test_torch_train.py's LOSS_REL, GNORM_REL
    and LEAF_REL (under int8_ag plus one int8 step an element, and m
    element by element against the step's math on one device);
    dp = 2 with FSDP slices (the width threshold lowered so reduced leaves
    are sliced) against the port's dp = 1 within the same bounds; the
    ranks bit-equal to each other;
  * a dp = 2 checkpoint of FSDP slices restored at dp = 1 and by the
    reference's `CheckpointManager`, byte for byte, and a dp = 1 checkpoint
    restored into dp = 2 slices;
  * the driver at ``--mesh single --dp-size 2`` with an injected failure
    ends at ``--steps``.
"""

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
import torch_dp_cells as C  # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.launch.sharding import param_spec  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.tree import tree_items  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.mesh import make_driver_mesh, make_train_mesh, spawn  # noqa: E402
from repro_torch.launch.sharding import FSDP_MIN_DIM, train_dims  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import init_state  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# test_torch_train.py's step tolerances
LOSS_REL, GNORM_REL, LEAF_REL = 5e-4, 5e-3, 5e-2
# an int8-compressed m: code x step to within this much of a code (f32
# roundings of (1 - b1) clip(code x scale)); the share of its elements off
# the reference's code at most INT8_FLIP_SHARE; one int8 step an element
# at most INT8_STEPS_MAX of the leaf's norm
INT8_GRID_TOL, INT8_FLIP_SHARE, INT8_STEPS_MAX = 1e-3, 0.04, 0.5
TRAIN_ARCHS = ["qwen2-7b", "llama4-scout-17b-16e", "minicpm3-4b", "internvl2-1b",
               "falcon-mamba-7b", "recurrentgemma-9b"]
WORLD = {"pod": 2, "data": 2, "model": 1}
DEADLINE = 600

REF = """
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import get_config
from repro.configs.base import RunConfig
from repro.data import DataConfig, SyntheticLM
from repro.launch.mesh import compat_shard_map, make_test_mesh, use_mesh
from repro.launch.steps import _loss_fn, build_train_step
from repro.models import init_params, model_dims
from repro.optim import AdamWConfig, apply_updates, compressed_psum, init_state

src, dst = sys.argv[1], sys.argv[2]
S, B, MICRO, STEPS, LR = (int(v) if v.isdigit() else float(v) for v in sys.argv[3:8])
flat = dict(np.load(src))
out = {}


def pod_psum(per_rank, w):
    # the reference's compressed_psum over a (pod w) mesh of each rank's tree
    mesh = make_test_mesh((w,), ("pod",))
    g = jax.tree.map(lambda *xs: jnp.stack(xs), *per_rank)
    spec = jax.tree.map(lambda _: P("pod"), g)
    f = compat_shard_map(lambda g: compressed_psum(jax.tree.map(lambda x: x[0], g), ("pod",)),
                         mesh, {"pod"}, in_specs=(spec,), out_specs=spec)
    with use_mesh(mesh):
        res = jax.jit(f)(g)
    return jax.tree.map(lambda r, x: np.asarray(r).reshape((w,) + x.shape[1:])[0], res, g)


keys = sorted({k.split(".")[1] for k in flat if k.startswith("g.")})
for w in (2, 4):
    for name, ranks in {2: {"d0": (0, 2), "d1": (1, 3)}, 4: {"all": (0, 1, 2, 3)}}[w].items():
        res = pod_psum([{k: jnp.asarray(flat[f"g.{k}.{r}"]) for k in keys} for r in ranks], w)
        for k in keys:
            out[f"psum{w}.{name}.{k}"] = res[k].reshape(-1)
for arch in ("qwen2-7b", "llama4-scout-17b-16e"):
    cfg = get_config(arch).reduced()
    for kind, shape, axes, comp in (("single", (2, 1), ("data", "model"), "none"),
                                    ("multi", (2, 2, 1), ("pod", "data", "model"), "int8_ag")):
        mesh = make_test_mesh(shape, axes)
        rcfg = RunConfig(model=cfg, seq_len=S, global_batch=B, mode="train", microbatch=MICRO,
                         learning_rate=LR, warmup_steps=2, grad_compression=comp)
        with use_mesh(mesh):
            step, _, shards = build_train_step(mesh, cfg, rcfg)
            params = jax.device_put(init_params(jax.random.PRNGKey(0), cfg), shards["params"])
            opt = jax.device_put(init_state(params), shards["opt_state"])
            data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B))
            pre = jnp.zeros((B, 0, cfg.d_model), jnp.float32)
            for s in range(STEPS):
                t, g = data.batch(s)
                params, opt, m = step(params, opt, jnp.asarray(t), jnp.asarray(g), pre,
                                      jnp.int32(s))
                out[f"{arch}.{kind}.loss.{s}"] = np.float32(m["loss"])
                out[f"{arch}.{kind}.grad_norm.{s}"] = np.float32(m["grad_norm"])
                if s == 0:
                    for path, leaf in jax.tree_util.tree_flatten_with_path(opt["m"])[0]:
                        key = "/".join(str(getattr(p, "key", p)) for p in path)
                        out[f"{arch}.{kind}.m0.{key}"] = np.asarray(leaf)
    # the multi step's math on one device: each pod's f32 grads of its half
    # of every microbatch (bf16 copies, _loss_fn, the mean over microbatches)
    # over npod, the reference's compressed_psum over the pods, AdamW from 0
    p0 = init_params(jax.random.PRNGKey(0), cfg)
    pb = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 and x.ndim >= 2
                      else x, p0)
    dims = model_dims(cfg, 1)
    grad = jax.jit(jax.grad(lambda p, t, g: _loss_fn(p, t, g, cfg, rcfg, None, None, dims)[0]))
    t, g = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)).batch(0)
    half, n_micro, per_pod = MICRO // 2, B // MICRO, []
    for pod in range(2):
        acc = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), pb)
        for i in range(n_micro):
            rows = slice(i * MICRO + pod * half, i * MICRO + (pod + 1) * half)
            acc = jax.tree.map(lambda a, b: a + b.astype(jnp.float32), acc,
                               grad(pb, jnp.asarray(t[rows]), jnp.asarray(g[rows])))
        per_pod.append(jax.tree.map(lambda a: a / n_micro / 2, acc))
    grads = pod_psum(per_pod, 2)
    _, st, _ = apply_updates(p0, grads, init_state(p0), jnp.float32(LR),
                             AdamWConfig(grad_clip=rcfg.grad_clip))
    for path, leaf in jax.tree_util.tree_flatten_with_path(st["m"])[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        out[f"{arch}.multi.m0_one_device.{key}"] = np.asarray(leaf)
np.savez(dst, **out)
"""


def _np_params():
    return {a: jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0),
                                                      get_config(a).reduced()))
            for a in C.ARCHS}


def _dp1_checkpoint(np_params, root):
    """A dp = 1 checkpoint per arch (step 3) of the reference's params and a
    seeded m / v, written by the port's manager; returns (its directory,
    the tree written)."""
    out = {}
    for i, arch in enumerate(C.ARCHS):
        p = params_from_numpy(np_params[arch])
        opt = init_state(p)
        gen = torch.Generator().manual_seed(40 + i)
        for tree in (opt["m"], opt["v"]):
            for _, t in tree_items(tree):
                t.copy_(torch.randn(t.shape, generator=gen))
        d = os.path.join(root, f"dp1-{arch}")
        CheckpointManager(d, async_save=False).save(3, {"params": p, "opt": opt})
        out[arch] = (d, {"/".join(k): v for k, v in tree_items({"params": p, "opt": opt})})
    return out


@pytest.fixture(scope="module")
def run():
    """(the world's four results, the reference's results, the port's dp =
    1 runs, the dp = 1 checkpoints, the save directories)."""
    np_params = _np_params()
    with tempfile.TemporaryDirectory(prefix="dp-") as tmp:
        dp1 = _dp1_checkpoint(np_params, tmp)
        saves = {a: os.path.join(tmp, f"dp2-{a}") for a in C.ARCHS}
        dirs = {a: (saves[a], dp1[a][0]) for a in C.ARCHS}
        grads = {f"g.{k}.{r}": v.numpy() for r in range(4) for k, v in C.grad_inputs(r).items()}
        src, dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        np.savez(src, **grads)
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        argv = [sys.executable, "-c", REF, src, dst] + [str(v) for v in (
            C.S, C.B, C.MICRO, C.STEPS, C.LR)]
        with ThreadPoolExecutor(2) as pool:
            ref = pool.submit(subprocess.run, argv, capture_output=True, text=True,
                              timeout=DEADLINE, env=env, cwd=REPO)
            world = pool.submit(spawn, C.dp_world, WORLD, "cpu", np_params, dirs,
                                deadline=DEADLINE)
            one = C.one_rank(np_params)
            ranks = world.result()
            r = ref.result()
        assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr[-3000:]}"
        want = dict(np.load(dst))
        restored = {a: CheckpointManager(saves[a]).restore(_like(np_params[a])) for a in C.ARCHS}
        j_restored = {a: JCheckpointManager(saves[a]).restore(_j_like(np_params[a]))
                      for a in C.ARCHS}
        yield dict(ranks=ranks, want=want, one=one, dp1=dp1, restored=restored,
                   j_restored=j_restored)


def _like(np_tree):
    p = params_from_numpy(np_tree)
    return {"params": p, "opt": init_state(p)}


def _j_like(np_tree):
    from repro.optim import init_state as j_init_state
    return {"params": np_tree, "opt": j_init_state(np_tree)}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(float(np.linalg.norm(b)), 1e-30))


def _pod(ranks, pod):
    return [r for r in ranks if r["coords"]["pod"] == pod]


# ------------------------------------------------------------- collectives
def test_mesh_coordinates_and_reduce_scatter(run):
    """Ranks are numbered pod-major: rank = pod * 2 + data. The chunked
    `reduce_scatter_ranks` over ``data`` is `sum_ranks`' slice bit for bit,
    and `all_gather_dim` concatenates in rank order."""
    ranks = run["ranks"]
    assert [r["coords"] for r in ranks] == [dict(pod=p, data=d, model=0)
                                            for p in range(2) for d in range(2)]
    for r in ranks:
        c = r["collectives"]
        assert c["reduce_scatter_equal"]
        lo = 2 * r["coords"]["pod"]
        want = torch.cat([C.grad_inputs(lo + d)["mat"] for d in range(2)], dim=0)
        assert torch.equal(c["gather"], want)


def test_compressed_psum_w2_is_the_reference_bit_for_bit(run):
    """Over two ranks (each data index's pod pair) every leaf, compressed
    and fallback, equals the reference's `compressed_psum` (in its
    shard_map) bit for bit, on both ranks."""
    want = run["want"]
    for r in run["ranks"]:
        name = f"d{r['coords']['data']}"
        for k, got in r["collectives"]["psum2"].items():
            ref = want[f"psum2.{name}.{k}"]
            np.testing.assert_array_equal(got.numpy().reshape(-1).view(np.int32),
                                          ref.reshape(-1).view(np.int32), err_msg=k)
        fb = {s["numel"]: s["fallback"] for s in r["collectives"]["stats2"]}
        assert fb == {4096: False, 960: False, 7: True, 12: True}


def test_compressed_psum_w4_within_the_int8_bound(run):
    """Over four ranks: each compressed leaf within amax / 127 of the
    reference's result (another order of the f32 sums), every rank the same
    bits, `compressed_allreduce` (the standalone wrapper) the same bits;
    the fallback leaves exact (sums of small multiples of 0.25)."""
    want = run["want"]
    first = run["ranks"][0]["collectives"]["psum4"]
    exact = {k: sum(C.grad_inputs(r)[k] for r in range(4)) for k in ("odd", "small")}
    for r in run["ranks"]:
        got = r["collectives"]["psum4"]
        for k, v in got.items():
            assert torch.equal(v, first[k]), k
            assert torch.equal(r["collectives"]["allreduce4"][k], v), k
            ref = want[f"psum4.all.{k}"].reshape(v.shape)
            if k in exact:
                assert torch.equal(v, exact[k]), k
                np.testing.assert_array_equal(v.numpy(), ref)
                continue
            amax = float(np.abs(ref).max())
            assert float(np.abs(v.numpy() - ref).max()) <= amax / 127, k
        for s in r["collectives"]["stats4"]:
            if not s["fallback"]:
                assert s["max_err"] <= s["amax"] / 254 * (1 + 1e-5), s


# ------------------------------------------------------------- FSDP layout
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_fsdp_dims_are_the_reference_specs(arch):
    """At full width (abstract shapes), the dim each leaf shards over
    ``data`` is the one where the reference's
    ``param_spec(fsdp="data", moe="tp")`` puts ``data``, for every leaf."""
    cfg = get_config(arch)
    shapes = jax.eval_shape(lambda k: j_init_params(k, cfg), jax.random.PRNGKey(0))
    n_fsdp = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        names = [str(getattr(p, "key", p)) for p in path]
        n_stack = int(names[0] == "layers")
        spec = param_spec(path, leaf, fsdp="data", n_stack=n_stack, moe="tp")
        want = next((i for i, a in enumerate(spec) if a == "data"), None)
        got = train_dims(names, torch.empty(leaf.shape, device="meta"), n_stack)[1]
        assert got == want, (names, leaf.shape, spec)
        n_fsdp += want is not None
    assert n_fsdp > 0 or cfg.d_model < FSDP_MIN_DIM          # internvl2-1b's 896


# -------------------------------------------------------------- train steps
def _int8_steps(ref: np.ndarray, w: int = 2) -> np.ndarray:
    """One int8 step of each element of a leaf compressed over ``w`` pods,
    read from the reference's m = (1 - b1) clip(dequantized g): the max |m|
    of the element's shard of the flat leaf over 127 (0 where the leaf
    falls back to the plain sum)."""
    flat = np.abs(ref.reshape(-1))
    if flat.size % w or flat.size < 8 * w:
        return np.zeros_like(flat)
    return np.repeat(flat.reshape(w, -1).max(axis=1) / 127, flat.size // w)


def _int8_grid(m: np.ndarray, w: int = 2):
    """A leaf's m compressed over ``w`` pods read on its int8 grid: m =
    (1 - b1) clip(dequantized g) is code x step in each shard of the flat
    leaf, step the shard's max |m| / 127. Returns (codes [w, n / w], step
    [w, 1]), or None for a leaf that falls back to the plain sum."""
    flat = np.asarray(m, np.float64).reshape(-1)
    if flat.size % w or flat.size < 8 * w:
        return None
    shards = flat.reshape(w, -1)
    step = np.abs(shards).max(axis=1, keepdims=True) / 127
    return shards / np.where(step > 0, step, 1.0), step


@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("arch", C.ARCHS)
def test_dp_steps_match_the_reference(run, arch, kind):
    """dp = 2 (``single``, the pod of the arch) and (pod 2, data 2) int8_ag
    (``multi``) against the reference's sharded step, held as
    test_torch_train.py holds one step: the loss and grad norm within
    LOSS_REL / GNORM_REL, each leaf's m within LEAF_REL of its norm.

    Under int8_ag m is held to the sharded step within LEAF_REL of its norm
    plus one int8 step an element (that allowance under INT8_STEPS_MAX of
    the norm), and element by element to the same step's math on one
    device (each pod's grads of its half of every microbatch through the
    reference's loss, its compressed_psum over the pods, AdamW): each
    shard's step within LEAF_REL, each element within two steps plus
    LEAF_REL of it (one step for each side's rounding, one for the grads'
    bf16 roundings, which the uncompressed run shows up to about one step
    apart), and elements off the reference's code under INT8_FLIP_SHARE
    of all compressed ones. The sharded step is not held element by
    element: on reduced scout its own attention m leaves that one-device
    math by up to 13 steps (measured), where the port's stays within 2.

    Later steps are not held to the reference (Adam's first step moves every
    weight by about lr whatever its grad's size, which amplifies those
    roundings); the ranks' metrics, params and m equal bit for bit at every
    step."""
    want = run["want"]
    ranks = _pod(run["ranks"], C.ARCHS.index(arch)) if kind == "single" else run["ranks"]
    res = [r[kind] if kind == "single" else r[kind][arch] for r in ranks]
    loss, gn = float(want[f"{arch}.{kind}.loss.0"]), float(want[f"{arch}.{kind}.grad_norm.0"])
    got = res[0]["metrics"][0]
    assert abs(got["loss"] - loss) <= LOSS_REL * abs(loss), (got, loss)
    assert abs(got["grad_norm"] - gn) <= GNORM_REL * gn, (got, gn)
    flips = n_int8 = 0
    for key, m in res[0]["m0"].items():
        m = m.numpy()
        ref = want[f"{arch}.{kind}.m0.{key}"]
        if kind == "single":
            assert _rel(m, ref) <= LEAF_REL, key
            continue
        # the sharded reference: m within LEAF_REL of its norm plus one int8
        # step an element, that step well under the norm
        steps = float(np.linalg.norm(_int8_steps(ref)))
        norm = float(np.linalg.norm(ref.astype(np.float64)))
        assert steps <= INT8_STEPS_MAX * norm, (key, steps, norm)
        assert _rel(m, ref) * norm <= LEAF_REL * norm + steps, key
        # the reference's math on one device, element by element
        one = want[f"{arch}.multi.m0_one_device.{key}"]
        grid = _int8_grid(one)
        if grid is None:
            assert _rel(m, one) <= LEAF_REL, key
            continue
        (c_one, s_one), (c_got, s_got) = grid, _int8_grid(m)
        for c in (c_one, c_got):                    # both m lie on their int8 grids
            assert np.abs(c - np.rint(c)).max() <= INT8_GRID_TOL, key
        assert np.all(np.abs(s_got - s_one) <= LEAF_REL * s_one), key
        d = np.abs(c_got * s_got - c_one * s_one)
        two = 2 * np.maximum(s_got, s_one) + LEAF_REL * np.abs(c_one * s_one)
        assert np.all(d <= two), (key, float((d / two).max()))
        flips += int((d > s_one / 2).sum())
        n_int8 += d.size
    assert flips <= INT8_FLIP_SHARE * n_int8, (flips, n_int8)
    for other in res[1:]:
        assert other["metrics"] == res[0]["metrics"]
        for tree in ("params", "m0"):
            for k, v in res[0][tree].items():
                assert torch.equal(other[tree][k], v), (tree, k)


@pytest.mark.parametrize("arch", C.ARCHS)
def test_fsdp_dp2_matches_dp1(run, arch):
    """dp = 2 with FSDP slices against the port's dp = 1 from the same
    params: the first step's loss and grad norm within LOSS_REL / GNORM_REL,
    m within LEAF_REL, the ranks' metrics equal at every step; each sliced
    leaf of the masters and m is exactly half of the whole on each rank,
    the rank's own slice of the gathered tree; whole leaves bit-equal on
    the ranks."""
    one = run["one"][arch]
    ranks = [r["fsdp"] for r in _pod(run["ranks"], C.ARCHS.index(arch))]
    a, b = ranks[0]["metrics"][0], one["metrics"][0]
    assert abs(a["loss"] - b["loss"]) <= LOSS_REL * abs(b["loss"])
    assert abs(a["grad_norm"] - b["grad_norm"]) <= GNORM_REL * b["grad_norm"]
    assert ranks[1]["metrics"] == ranks[0]["metrics"]
    for k, m in ranks[0]["m0"].items():
        assert _rel(m.numpy(), one["m0"][k].numpy()) <= LEAF_REL, k
    dims = ranks[0]["dims"]
    assert sum(d is not None for d in dims.values()) >= 5
    for r, res in enumerate(ranks):
        for k, d in dims.items():
            whole, own = res["params"][k], res["own"][k]
            if d is None:
                assert torch.equal(own, ranks[0]["own"][k]), k
                continue
            n = whole.shape[d] // 2
            assert own.shape[d] * 2 == whole.shape[d], k
            assert res["own_m"][k].shape == own.shape, k
            assert torch.equal(own, whole.narrow(d, r * n, n)), k


# ------------------------------------------------------------- checkpoints
@pytest.mark.parametrize("arch", C.ARCHS)
def test_dp2_checkpoint_restores_at_dp1_and_in_the_reference(run, arch):
    """The dp = 2 checkpoint of FSDP slices holds whole arrays: restored at
    dp = 1 by the port and by the reference's manager, every array is the
    ranks' gathered tree byte for byte (params and m; v and the step
    present)."""
    res = _pod(run["ranks"], C.ARCHS.index(arch))[0]["fsdp"]
    tree, step = run["restored"][arch]
    jtree, jstep = run["j_restored"][arch]
    assert step == jstep == C.STEPS
    got = {"/".join(k): v for k, v in tree_items(tree)}
    jgot = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    assert set(got) == set(jgot)
    for k, v in res["params"].items():
        assert got[f"params/{k}"].numpy().tobytes() == v.numpy().tobytes(), k
        assert jgot[f"params/{k}"].tobytes() == v.numpy().tobytes(), k
    assert int(got["opt/step"]) == C.STEPS


@pytest.mark.parametrize("arch", C.ARCHS)
def test_dp1_checkpoint_restores_into_dp2_slices(run, arch):
    """A dp = 1 checkpoint restored on each rank of dp = 2 gives the rank's
    slice of every whole array it holds sliced, the whole array otherwise,
    byte for byte."""
    written = run["dp1"][arch][1]
    ranks = _pod(run["ranks"], C.ARCHS.index(arch))
    for r, res in enumerate(ranks):
        at, back = res["fsdp"]["restored"]
        assert at == 3
        dims = res["fsdp"]["dims"]
        for key, t in back.items():
            parts = key.split("/")
            d = dims.get("/".join(parts[1:] if parts[0] == "params" else parts[2:]))
            want = written[key]
            if d is not None:
                n = want.shape[d] // 2
                want = want.narrow(d, r * n, n)
            assert t.numpy().tobytes() == want.numpy().tobytes(), key


# ------------------------------------------------------------------ driver
ARGS = ["--arch", "qwen2-7b", "--reduced", "--seq-len", "32", "--global-batch", "4",
        "--log-every", "2", "--device", "cpu"]


def test_driver_single_dp2_with_an_injected_failure(monkeypatch, tmp_path):
    """``--mesh single --dp-size 2`` spawns two ranks; a failure injected at
    step 3 (the environment reaches both) restores both from the checkpoint
    at step 2 and the run ends at ``--steps`` with finite losses; its first
    steps are the port's dp = 1 driver's within LOSS_REL."""
    monkeypatch.setenv("REPRO_INJECT_FAIL_AT", "3")
    ck = str(tmp_path / "ck")
    losses = train.main(ARGS + ["--steps", "5", "--mesh", "single", "--dp-size", "2",
                                "--ckpt-dir", ck, "--ckpt-every", "2"])
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert CheckpointManager(ck).latest_step() == 5
    monkeypatch.delenv("REPRO_INJECT_FAIL_AT")
    one = train.main(ARGS + ["--steps", "2"])
    for a, b in zip(losses[:2], one):
        assert abs(a - b) <= LOSS_REL * abs(b)


def test_meshes_of_the_driver():
    """Without a process group the world is one rank: ``single`` is
    (data 1, model 1); ``multi`` needs an even world; a model axis > 1 in
    training, refused before, is ported: a training mesh of it needs a
    process group of its ranks, as any mesh of more than one rank."""
    m = make_driver_mesh("single", "cpu")
    assert m.shape == {"data": 1, "model": 1} and m.coords == {"data": 0, "model": 0}
    with pytest.raises(ValueError, match="two pods"):
        make_driver_mesh("multi", "cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_train_mesh({"data": 1, "model": 2}, "cpu")
