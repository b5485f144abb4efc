"""Tensor-parallel serving of the port on the CPU: a (1, 2) mesh of two
spawned ranks over gloo (`repro_torch.launch.mesh.spawn`), held to the
reference's house invariant (tests/test_sharded_serving.py): the paged
engine sharded over the ``model`` axis emits token streams and tick stats
bit-identical to tp = 1, here the port's tp = 1 engine and the JAX
package's, over {bf16 pages + FP16, AMS pages + FP5.33} x chunk {1, 4} x
{greedy, seeded sampling, speculative k = 2}. (The reference's own tp = 2
engine cannot serve as the oracle: on the installed jax it fails before its
first tick.) Also: the host side never sees the mesh (block tables, prefix
hits, allocator stats), the accounting is per device, the sharding rules
are the reference's leaf for leaf, the collectives add in rank order, and
what tp > 1 does not serve raises.

One spawned world serves every cell (`torch_tp_cells.serving_world`); the
JAX engines run in this process meanwhile.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch_tp_cells as C  # noqa: E402

from repro.cache import CacheConfig as JCacheConfig  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.policy import QuantPolicy as JQuantPolicy  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.launch.config import EngineConfig as JEngineConfig  # noqa: E402
from repro.launch.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.launch.sampling import SamplingParams as JSamplingParams  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import make_cache as j_make_cache  # noqa: E402
from repro.models.common import quantize_params as j_quantize_params  # noqa: E402
from repro_torch.cache import CacheConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tree import tree_items  # noqa: E402
from repro_torch.core.policy import QuantPolicy  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch.engine import prepare_params  # noqa: E402
from repro_torch.launch.mesh import make_driver_mesh, make_serving_mesh, spawn  # noqa: E402
from repro_torch.models import make_cache  # noqa: E402
from repro_torch.models.common import quantize_params  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import layer_pattern  # noqa: E402

TP = 2
# the reduced configs of the served layer kinds (dense GQA, MoE-GQA; MLA,
# Mamba-1 and the RG-LRU hybrid, over contiguous caches only)
SLICE_ARCHS = ["qwen2-7b", "qwen2.5-7b", "qwen1.5-4b", "deepseek-coder-33b", "internvl2-1b",
               "musicgen-medium", "llama4-scout-17b-16e", "dbrx-132b", "minicpm3-4b",
               "falcon-mamba-7b", "recurrentgemma-9b"]
# linears the port keeps whole on every rank where the reference's
# packed-plane rule N-shards their planes (its REPLICATED MLA down-projections;
# their plain weights are whole in both)
PORT_WHOLE = {"wq_a", "wkv_a"}


@pytest.fixture(scope="module")
def jax_params():
    return j_init_params(jax.random.PRNGKey(0), j_get_config("qwen2-7b").reduced())


@pytest.fixture(scope="module")
def np_params(jax_params):
    return jax.tree.map(np.asarray, jax_params)


@pytest.fixture(scope="module")
def world(np_params):
    """The two ranks' results, spawned from a thread here so the JAX
    engines of the module's first test run in this process meanwhile."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(spawn, C.serving_world, {"model": TP}, "cpu", np_params)


def results(world):
    r0, r1 = world.result()
    return r0, r1


def jax_cell(jax_params, cell):
    kind, scheme, chunk, mode = cell
    eng = JServeEngine(JEngineConfig(
        arch="qwen2-7b", reduced=True, scheme=scheme, impl="fused_ref", slots=2,
        capacity=C.CAP, prefill_chunk=chunk, speculate_k=2 if mode == "spec" else 0,
        cache=JCacheConfig(kind=kind, page_size=C.PAGE, impl="ref")), params=jax_params)
    samp = JSamplingParams(temperature=0.8, top_p=0.9, seed=123) if mode == "sampled" else None
    eng.submit([3, 5, 7], max_tokens=6, sampling=samp)
    eng.submit([3, 5, 11, 13, 2, 9], max_tokens=6, sampling=samp)
    st = eng.run()
    return [list(map(int, r.tokens)) for r in eng.finished], {k: st[k] for k in C.STAT_KEYS}


@pytest.mark.parametrize("cell", C.GRID, ids=lambda c: f"{c[0]}-c{c[2]}-{c[3]}")
def test_tp2_streams_equal_tp1_and_the_reference(cell, world, jax_params, np_params):
    """Port tp = 2 (both ranks) == port tp = 1 == the JAX tp = 1 engine:
    tokens and the ticks / ttft / latency stats, bit for bit."""
    want = jax_cell(jax_params, cell)
    one = C.serve_cell(None, np_params, cell)
    r0, r1 = results(world)
    assert one == want, f"{cell}: port tp=1 {one} != JAX {want}"
    assert r0["cells"][cell] == one, f"{cell}: tp=2 {r0['cells'][cell]} != tp=1 {one}"
    assert r1["cells"][cell] == r0["cells"][cell]


def test_allocator_and_prefix_cache_mesh_invariant(world, np_params):
    """Block-table rows, prefix hits and allocator stats are the same on a
    (1, 1) and a (1, 2) mesh: page ids never see the heads."""
    base = C.drive_shared(make_driver_mesh("none", "cpu"), np_params)
    assert base == C.drive_shared(None, np_params)
    assert base[2]["prefix_hit_pages"] == 2
    r0, r1 = results(world)
    assert r0["shared"] == base and r1["shared"] == base


def test_preemption_spills_and_restores_the_ranks_heads(world, np_params):
    """A request preempted after its prefill and resumed: streams equal to
    tp = 1's, the same pages spilled, each rank's spill half the bytes (its
    kv heads of every page)."""
    toks, st = C.preempt(None, np_params)
    assert st["preemptions"] == st["resumes"] == 1 and st["spill_pages"] >= 1
    r0, r1 = results(world)
    for r in (r0, r1):
        got, gst = r["preempt"]
        assert got == toks
        assert gst["spill_pages"] == st["spill_pages"]
        assert gst["spill_bytes"] * 2 == st["spill_bytes"]


def test_per_device_accounting_halves(world, np_params):
    """Per device at tp = 2: kv_bytes_per_token, every cost-model KV floor
    and weight_bytes halve, the pool holds half the bytes, the compression
    ratio and kv_floor_ratio (1.0) do not move; the step's signature
    carries tp, and the tp = 2 engine replays no graphs."""
    one = C.accounting(None, np_params)
    r0, r1 = results(world)
    assert r0["accounting"] == r1["accounting"]
    two = r0["accounting"]
    assert two["kv_bytes_per_token"] * 2 == one["kv_bytes_per_token"]
    for f in C.COST_FIELDS:
        assert two["cost"][f] * 2 == one["cost"][f], f
    assert two["pool_bytes"] * 2 == one["pool_bytes"]
    assert two["param_bytes"] < one["param_bytes"]
    assert (one["tp"], two["tp"]) == (1, 2)
    assert two["compression"] == one["compression"]
    assert one["kv_floor_ratio"] == two["kv_floor_ratio"] == 1.0
    assert two["graphs"] is False


def test_sum_ranks_and_gather_in_rank_order():
    """Four ranks: every rank gets the same bits, the rank-order sum
    ((r0 + r1) + r2) + r3 (another association gives other bits on these
    operands), and the slices concatenated in rank order."""
    got = spawn(C.collectives, {"model": 4}, "cpu")
    xs, ys = zip(*(C.collective_inputs(r) for r in range(4)))
    want = ((xs[0] + xs[1]) + xs[2]) + xs[3]
    assert not torch.equal(want, xs[0] + (xs[1] + (xs[2] + xs[3])))
    for s, g in got:
        assert torch.equal(s, want)
        assert torch.equal(g, torch.cat(ys, dim=-1))


def test_tp2_refuses_what_it_does_not_serve(world):
    """Data axes > 1, the front end, CUDA graphs and the self drafters
    raise at tp > 1, naming the ROADMAP item. Contiguous caches, MLA, Mamba
    and RG-LRU layers, refused before, are served now (sequence-sharded
    caches, tests/test_torch_tp_contiguous.py): their configs build. MoE
    over a sequence at tp > 1 (``moe_tp``), refused before, runs in the
    training layout (tests/test_torch_tp_train.py holds it)."""
    r0, r1 = results(world)
    assert r0["refusals"] == r1["refusals"]
    served = {"contiguous", "mla", "mamba", "rglru", "moe-seq"}
    for case, (kind, msg) in r0["refusals"].items():
        if case in served:
            assert kind is None, (case, kind, msg)
            continue
        assert kind == "NotImplementedError", (case, kind, msg)
        assert "ROADMAP.md, Modules to port" in msg, (case, msg)
    assert set(r0["refusals"]) >= served | {"data>1", "frontend", "graphs", "self-drafter",
                                            "moe-seq"}


def test_meshes_the_port_does_not_build():
    """Outside a process group: ``single`` is the one-rank (data 1) mesh,
    ``multi`` needs an even world, a training mesh with a model axis > 1
    (ported now) and a tp > 1 serving mesh need a process group, and an
    engine mesh needs a model axis."""
    from repro_torch.launch.mesh import make_train_mesh

    assert make_driver_mesh("single", "cpu").shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="two pods"):
        make_driver_mesh("multi", "cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_train_mesh({"data": 1, "model": 2}, "cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_serving_mesh(2, "cpu")
    m = make_serving_mesh(1, "cpu")
    assert m.shape == {"data": 1, "model": 1} and m.rank == 0
    with pytest.raises(ValueError, match="model"):
        C.engine_config(dataclasses.replace(m, axis_names=("data",)))


# --------------------------------------------------------------- sharding rules
def _names(path):
    return [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]


def _model_dim(spec):
    return next((i for i, a in enumerate(spec) if a == "model"), None)


@pytest.mark.parametrize("arch", SLICE_ARCHS)
@pytest.mark.parametrize("scheme", ["fp16", "fp5.33-e2m3", "fp4.25-e2m2"])
def test_shard_dims_follow_the_reference_specs(arch, scheme):
    """For every leaf of the reduced config's serving tree (plain and
    quantized), the port's shard dim equals the ``model`` dim of the
    reference's ``param_spec(serve_n_shard=True)`` (the planes of MLA's
    ``wq_a`` / ``wkv_a`` excepted: whole in the port, N over ``model`` in
    the reference's packed-plane rule); every page-pool plane a rank's
    `make_cache(tp=2)` makes is the reference's plane cut along the
    ``model`` dim of ``pool_spec`` where ``pool_shardings`` splits it (the
    heads divide tp), and whole otherwise (configs that page); every
    contiguous cache leaf is the reference's cut along the ``model`` dim of
    ``cache_spec(seq_shard=True)``, which `cache_shard_dim` names."""
    jcfg = j_get_config(arch).reduced()

    def serving(k):
        p = j_init_params(k, jcfg, tp=TP)
        p = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, p)
        if scheme != "fp16":
            p = j_quantize_params(p, JQuantPolicy(scheme=scheme, min_elements=1 << 10))
        return p

    shapes = jax.eval_shape(serving, jax.random.PRNGKey(0))
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        names = _names(path)
        ns = 1 if names[0] == "layers" else 0
        want = _model_dim(jsh.param_spec(path, leaf, fsdp=None, n_stack=ns, moe="ep",
                                         serve_n_shard=True))
        if len(names) > 1 and names[-2] in PORT_WHOLE and names[-1] in ("hi", "lsb", "scale"):
            assert want == leaf.ndim - 1, names
            want = None
        assert SH.serve_shard_dim(names, leaf, ns) == want, names
        n += 1
    assert n > 5
    cfg = get_config(arch).reduced()
    paged = set(layer_pattern(cfg)) <= {"gqa", "gqa_moe"} and not cfg.sliding_window
    for kind in ("paged_ams", "paged_bf16") if paged else ():
        jcc = JCacheConfig(kind=kind, page_size=8).sized(capacity=32, slots=2)
        pool = jax.eval_shape(lambda: j_make_cache(jcfg, 2, 32, tp=TP, cache_cfg=jcc))
        mine = dict(tree_items(make_cache(cfg, 2, 32, cache_cfg=CacheConfig(
            kind=kind, page_size=8).sized(capacity=32, slots=2), tp=TP)))
        for path, leaf in jax.tree_util.tree_flatten_with_path(pool)[0]:
            want = list(leaf.shape)
            if leaf.ndim >= 2 and leaf.shape[-2] % TP == 0:
                want[_model_dim(jsh.pool_spec(leaf))] //= TP
            assert list(mine[tuple(_names(path))].shape) == want, _names(path)
    contig = jax.eval_shape(lambda: j_make_cache(jcfg, 2, 32, tp=TP))
    mine = dict(tree_items(make_cache(cfg, 2, 32, tp=TP)))
    assert len(mine) == len(jax.tree_util.tree_leaves(contig))
    for path, leaf in jax.tree_util.tree_flatten_with_path(contig)[0]:
        names = _names(path)
        ns = 1 if names[0] == "layers" else 0
        d = _model_dim(jsh.cache_spec(path, leaf, dp=None, seq_shard=True, n_stack=ns))
        assert SH.cache_shard_dim(names, leaf, ns) == d, names
        want = list(leaf.shape)
        if d is not None:
            want[d] //= TP
        assert list(mine[tuple(names)].shape) == want, names


@pytest.mark.parametrize("scheme", ["fp5.33-e2m3", "fp4.25-e2m2"])
def test_quantize_then_shard_equals_shard_then_quantize(scheme):
    """AMS groups run along K and the scale is per column: the planes of a
    quantized weight sliced by columns are the planes of the quantized
    column slice, bit for bit."""
    pol = QuantPolicy(scheme=scheme, min_elements=1 << 10)
    gen = torch.Generator().manual_seed(0)
    w = (torch.randn((200, 96), generator=gen) / 14).to(torch.bfloat16)
    full = quantize_params({"wq": {"w": w}}, pol)["wq"]
    for r in range(TP):
        shard = SH.shard_tree({"wq": full}, r, TP, ["layers", "sub0", "attn"], n_stack=0)["wq"]
        part = quantize_params({"wq": {"w": w[:, r * 48:(r + 1) * 48].clone()}}, pol)["wq"]
        for k in ("hi", "lsb", "scale"):
            assert torch.equal(shard[k], part[k]), k


def test_shard_params_slices_the_reference_tree(np_params):
    """`shard_params` of the prepared FP5.33 tree: each rank's leaves
    concatenate back to the whole along their shard dim; the pool a tp = 2
    engine makes is the rank's half of the heads."""
    from repro_torch.models.parallel import ParallelCtx

    cfg = get_config("qwen2-7b").reduced()
    full = prepare_params(params_from_numpy(np_params),
                          QuantPolicy(scheme="fp5.33-e2m3", min_elements=1 << 10))

    class M:
        shape, rank = {"data": 1, "model": TP}, 0

    ranks = []
    for r in range(TP):
        M.rank = r
        ranks.append(dict(tree_items(SH.shard_params(full, ParallelCtx(mesh=M(),
                                                                       tp_axis="model")))))
    for path, leaf in tree_items(full):
        d = SH.serve_shard_dim(list(path), leaf, 1 if path[0] == "layers" else 0)
        parts = [r[path] for r in ranks]
        whole = parts[0] if d is None else torch.cat(parts, dim=d)
        assert torch.equal(whole, leaf), path
    assert layer_pattern(cfg) == ("gqa",)
    ccfg = C.engine_config(None).sized_cache()
    one, two = make_cache(cfg, cache_cfg=ccfg), make_cache(cfg, cache_cfg=ccfg, tp=TP)
    assert C.nbytes(two) * 2 == C.nbytes(one)
