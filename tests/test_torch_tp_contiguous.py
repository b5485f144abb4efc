"""Tensor-parallel serving over contiguous caches on the CPU: a (1, 2) mesh
of two spawned ranks over gloo (`repro_torch.launch.mesh.spawn`).

  * The sequence-sharded insert + attend cores (GQA one-token and
    chunked, the sliding-window ring, the absorbed-MLA stream one-token and
    chunked) on 2 ranks against the reference's same cores under
    ``compat_shard_map`` on 2 forced host devices (a subprocess, as
    tests/test_distributed.py runs them), on the same seeded inputs: each
    rank's cache shard byte-equal to the reference's, the merged outputs
    bit-equal on both ranks (one add of two partials commutes, so the
    port's rank-order ``r0 + r1`` is the reference's psum).
  * The owner-shard inserts and the speculative rollback, rank by rank,
    against the whole cache's.
  * Engines of reduced falcon-mamba-7b and recurrentgemma-9b (the
    recurrences on a rank's half of the inner width) and of qwen2-7b and
    minicpm3-4b over contiguous caches, at tp = 2 against the port's tp =
    1 engine and the JAX package's tp = 1 engine; n-gram speculation at
    tp = 2 over the GQA cache; per-device accounting; sizes that do not
    divide over the ranks.

The merged softmax adds two partial sums where one rank adds all keys at
once, which may change a bit of ``l`` or ``o``: the attention engines'
logits are held within ATTN_LOGIT_TOL of tp = 1's, and whether they were
bit-equal, and each stream's first diverging token, are recorded as test
properties (measured: bit-equal on these workloads).
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
import jax.numpy as jnp  # noqa: E402
import torch_tp_cells as C  # noqa: E402

from repro.cache import CacheConfig as JCacheConfig  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch.config import EngineConfig as JEngineConfig  # noqa: E402
from repro.launch.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro_torch.cache import CacheConfig  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch.config import EngineConfig  # noqa: E402
from repro_torch.launch.mesh import Mesh, spawn  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models.parallel import ParallelCtx  # noqa: E402

TP = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECURRENT = ["falcon-mamba-7b", "recurrentgemma-9b"]
ATTENTION = ["qwen2-7b", "minicpm3-4b"]
# the JAX engine each port engine (matmul tier "kernel", the kernels' plain
# versions here; attention "ref") is held against: its fused_ref tier for
# the attention models (tests/test_torch_serve_contiguous.py), its
# pallas_interpret tier for the recurrent ones (test_torch_serve_mamba.py)
J_IMPL = {"qwen2-7b": "fused_ref", "minicpm3-4b": "fused_ref",
          "falcon-mamba-7b": "pallas_interpret", "recurrentgemma-9b": "pallas_interpret"}
# max |logit(tp = 2) - logit(tp = 1)| / max |logit(tp = 1)| where a merged
# softmax feeds the logits: a flipped bit of l or o moves an attention
# output by one bf16 ulp (2^-8 relative) at most
ATTN_LOGIT_TOL = 2.0 ** -6


# ------------------------------------------------------------------ fixtures
@pytest.fixture(scope="module")
def params():
    """Seeded reference params of each reduced arch: (JAX, numpy)."""
    out = {}
    for arch in C.CONTIG:
        jp = j_init_params(jax.random.PRNGKey(0), j_get_config(arch).reduced())
        out[arch] = (jp, jax.tree.map(np.asarray, jp))
    return out


@pytest.fixture(scope="module")
def world(params):
    """The two ranks' results, spawned from a thread so the JAX engines run
    in this process meanwhile."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(spawn, C.contiguous_world, {"model": TP}, "cpu",
                          {a: p[1] for a, p in params.items()})


@pytest.fixture(scope="module")
def one(params):
    """The port's tp = 1 run of each workload (and of speculation)."""
    torch.set_num_threads(1)
    out = {arch: C.contig_serve(None, params[arch][1], arch) for arch in C.CONTIG}
    out["spec"] = C.contig_serve(None, params["qwen2-7b"][1], "qwen2-7b", k=2)
    return out


def jax_engine(arch, jax_params):
    chunk, cap, prompts, new = C.CONTIG[arch]
    eng = JServeEngine(JEngineConfig(
        arch=arch, reduced=True, scheme="fp5.33-e2m3", impl=J_IMPL[arch], slots=2,
        capacity=cap, prefill_chunk=chunk, cache=JCacheConfig(kind="contiguous", impl="ref")),
        params=jax_params)
    hs = [eng.submit(p, n) for p, n in zip(prompts, new)]
    st = eng.run()
    return eng, [list(map(int, h.tokens)) for h in hs], st


def gathered(r0, r1, name, dim):
    """A cache leaf of the two ranks, concatenated along its shard dim."""
    return np.concatenate([r0["cache"][name], r1["cache"][name]], axis=dim)


def shard_dim(name, leaf):
    names = name.split("/")
    return SH.cache_shard_dim(names, leaf, 1 if names[0] == "layers" else 0)


def first_divergence(got, want):
    return [next((t for t, (a, b) in enumerate(zip(g, w)) if a != b), None)
            for g, w in zip(got, want)]


def logits_rel(got, want):
    assert len(got) == len(want)
    return max(float(np.abs(g - w).max() / np.abs(w).max()) for g, w in zip(got, want))


# ------------------------------------------------------------ sharded cores
def core_cases():
    """Seeded bf16 inputs (uint16 bits) of each core: 3 slots, the last
    idle; the caches whole (48 positions, the ring 32 slots), random
    everywhere so that masked rows would show."""
    rng = np.random.default_rng(7)

    def bf(*shape):
        return np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)).view(np.uint16)

    pos1, pos_c, nvalid = (np.array(p, np.int32) for p in ([5, 37, -1], [22, 40, -1],
                                                            [4, 2, 0]))
    return {
        "gqa": dict(q=bf(3, 4, 32), k=bf(3, 1, 2, 32), v=bf(3, 1, 2, 32), ck=bf(3, 48, 2, 32),
                    cv=bf(3, 48, 2, 32), pos=pos1),
        "gqa-chunk": dict(q=bf(3, 4, 4, 32), k=bf(3, 4, 2, 32), v=bf(3, 4, 2, 32),
                          ck=bf(3, 48, 2, 32), cv=bf(3, 48, 2, 32), pos=pos_c, nvalid=nvalid),
        "ring": dict(q=bf(3, 4, 16), k=bf(3, 1, 1, 16), v=bf(3, 1, 1, 16), ck=bf(3, 32, 1, 16),
                     cv=bf(3, 32, 1, 16), pos=np.array([100, 20, -1], np.int32),
                     window=np.int32(32)),
        "mla": dict(q=bf(3, 4, 48), new=bf(3, 1, 1, 48), cache=bf(3, 48, 1, 48), pos=pos1,
                    r_kv=np.int32(32), scale=np.float32(1 / np.sqrt(24))),
        "mla-chunk": dict(q=bf(3, 4, 4, 48), new=bf(3, 4, 1, 48), cache=bf(3, 48, 1, 48),
                          pos=pos_c, nvalid=nvalid, r_kv=np.int32(32),
                          scale=np.float32(1 / np.sqrt(24))),
    }


REF_CORES = """
import functools, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import compat_shard_map, make_test_mesh, use_mesh
from repro.models import attention as A

src, dst = sys.argv[1], sys.argv[2]
flat = dict(np.load(src))
cases = {}
for key, a in flat.items():
    case, name = key.split(".")
    cases.setdefault(case, {})[name] = a
mesh = make_test_mesh((1, 2), ("data", "model"))
R3, R4, SEQ = P(None, None, None), P(None, None, None, None), P(None, "model", None, None)
bf = lambda a: jnp.asarray(a.view(jnp.bfloat16))
bits = lambda a: np.asarray(a).view(np.uint16)
out = {}
for name, c in cases.items():
    q = bf(c["q"])
    rq = R4 if q.ndim == 4 else R3
    if name.startswith("mla"):
        kw = dict(r_kv=int(c["r_kv"]), scale=float(c["scale"]), axis_name="model")
        if "nvalid" in c:
            core = functools.partial(A.mla_decode_core_chunk, **kw)
            args = (q, bf(c["new"]), bf(c["cache"]), c["pos"], c["nvalid"])
            specs = (rq, R4, SEQ, P(), P())
        else:
            core = functools.partial(A.mla_decode_core, **kw)
            args = (q, bf(c["new"]), bf(c["cache"]), c["pos"])
            specs = (rq, R4, SEQ, P())
        outs = (rq, SEQ)
    else:
        H, kv = q.shape[-2], c["k"].shape[-2]
        kvm = A.kv_index_map(H, H, kv)
        if "nvalid" in c:
            core = functools.partial(A.gqa_decode_core_chunk, kv_map=kvm, axis_name="model")
            args = (q, bf(c["k"]), bf(c["v"]), bf(c["ck"]), bf(c["cv"]), c["pos"], c["nvalid"])
            specs = (rq, R4, R4, SEQ, SEQ, P(), P())
        else:
            w = int(c.get("window", 0))
            core = functools.partial(A.gqa_decode_core, kv_map=kvm, window=w, ring=bool(w),
                                     axis_name="model")
            args = (q, bf(c["k"]), bf(c["v"]), bf(c["ck"]), bf(c["cv"]), c["pos"])
            specs = (rq, R4, R4, SEQ, SEQ, P())
        outs = (rq, SEQ, SEQ)
    f = jax.jit(compat_shard_map(core, mesh, {"model"}, in_specs=specs, out_specs=outs))
    with use_mesh(mesh):
        res = f(*args)
    for i, r in enumerate(res):
        out[f"{name}.{i}"] = bits(r)
np.savez(dst, **out)
print("reference cores done")
"""


@pytest.fixture(scope="module")
def core_results():
    """(the reference's sharded cores, the port's two ranks, the port's one
    rank over the whole caches) on `core_cases`."""
    cases = core_cases()
    with tempfile.TemporaryDirectory(prefix="tp-cores-") as tmp:
        src, dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        np.savez(src, **{f"{c}.{k}": v for c, d in cases.items() for k, v in d.items()})
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=2")
        with ThreadPoolExecutor(1) as pool:
            ref = pool.submit(subprocess.run, [sys.executable, "-c", REF_CORES, src, dst],
                              capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
            ranks = spawn(C.seq_cores, {"model": TP}, "cpu", cases)
            r = ref.result()
        assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr[-3000:]}"
        flat = dict(np.load(dst))
    want = {c: [flat[f"{c}.{i}"] for i in range(3 if c in ("gqa", "gqa-chunk", "ring") else 2)]
            for c in cases}
    return want, ranks, C.seq_cores(None, cases)


@pytest.mark.parametrize("case", ["gqa", "gqa-chunk", "ring", "mla", "mla-chunk"])
def test_sharded_cores_match_the_reference(case, core_results, record_property):
    """Each rank's cache shards are the reference's shards byte for byte
    (owner-shard inserts; idle slot and rows past nvalid untouched), and
    both ranks' merged outputs are the reference's pmax / psum merge bit
    for bit. Recorded: whether the merge equals one rank's walk over the
    whole cache."""
    want, ranks, whole = core_results
    ref_out, *ref_caches = want[case]
    for r, res in enumerate(ranks):
        out, caches = res[case]
        for got, ref in zip(caches, ref_caches):
            s = ref.shape[1] // TP
            np.testing.assert_array_equal(got, ref[:, r * s:(r + 1) * s],
                                          err_msg=f"{case}: rank {r}'s cache shard")
        np.testing.assert_array_equal(out, ref_out, err_msg=f"{case}: rank {r}'s output")
    assert np.any(ref_out != 0)
    record_property("merge_bit_equal_to_one_rank", bool(np.array_equal(whole[case][0],
                                                                       ref_out)))


def test_max_ranks_and_gather_each():
    """Three ranks: `max_ranks` is the element-wise max of every rank's
    operand on every rank; `all_gather_last_each` gathers each of two
    tensors in one exchange, each equal to its own `all_gather_last`."""
    got = spawn(C.collectives_merge, {"model": 3}, "cpu")
    xs, ys = zip(*(C.collective_inputs(r) for r in range(3)))
    want = torch.maximum(torch.maximum(xs[0], xs[1]), xs[2])
    for m, (a, b) in got:
        assert torch.equal(m, want)
        assert torch.equal(a, torch.cat(ys, dim=-1))
        assert torch.equal(b, torch.cat([y[..., :2] * 3 for y in ys], dim=-1))


# -------------------------------------------------------- owner-shard writes
def _ctx(rank):
    """A rank's sequence-sharded context as the cache writes see it (they
    exchange nothing, so the mesh needs no process group)."""
    return ParallelCtx(mesh=Mesh({"data": 1, "model": TP}, rank=rank), tp_axis="model",
                       seq_shard=True)


@pytest.mark.parametrize("op", ["insert", "insert-chunk", "ring", "truncate"])
def test_owner_shard_writes_equal_the_whole_cache(op):
    """`cache_insert` (per slot and into a ring), `cache_insert_chunk` and
    `cache_truncate_chunk` on each rank's shard equal the whole cache's op
    sliced, byte for byte: runs that start on rank 0 and end on rank 1,
    runs wholly on one rank, an idle slot, a zero count."""
    gen = torch.Generator().manual_seed(3)
    S, B = 16, 5
    whole = torch.randn((B, S, 2, 4), generator=gen).to(torch.bfloat16)
    new = torch.randn((B, 4, 2, 4), generator=gen).to(torch.bfloat16)
    pos = torch.tensor([6, 9, 0, -1, 12], dtype=torch.int32)
    nvalid = torch.tensor([4, 3, 2, 4, 0], dtype=torch.int32)

    def run(cache, ctx):
        if op == "insert":
            return A.cache_insert(cache, new[:, :1], pos, ctx=ctx)
        if op == "ring":
            return A.cache_insert(cache, new[:, :1], pos + 40, ring_window=S, ctx=ctx)
        if op == "insert-chunk":
            return A.cache_insert_chunk(cache, new, pos, nvalid, ctx)
        return A.cache_truncate_chunk(cache, pos, nvalid, 4, ctx)

    want = run(whole.clone(), None)
    assert not torch.equal(want, whole)
    s = S // TP
    for r in range(TP):
        got = run(whole[:, r * s:(r + 1) * s].clone(), _ctx(r))
        assert torch.equal(got.view(torch.int16), want[:, r * s:(r + 1) * s].view(torch.int16)), r


# ------------------------------------------------------------------ engines
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_engines_bit_equal_tp1_and_the_reference(arch, world, one, params,
                                                           record_property):
    """Falcon-Mamba-7B and RecurrentGemma-9B at tp = 2: both ranks' streams
    equal the port's tp = 1 streams and the JAX tp = 1 engine's (and the
    tick counts); the conv / ssm / recurrent states gathered from the two
    ranks' halves of the inner width equal tp = 1's bit for bit, and the
    JAX engine's in the slot that finished last (the reference goes on
    advancing an idle slot's states, the port keeps them). Mamba's logits
    are tp = 1's bit for bit; the hybrid's pass its attention layer's
    merged softmax and are held within ATTN_LOGIT_TOL (bit-equality
    recorded). The hybrid's second prompt wraps its 64-slot ring (32 a
    rank): the rings gathered from the ranks equal tp = 1's."""
    jeng, jstreams, jst = jax_engine(arch, params[arch][0])
    r0, r1 = (r[arch] for r in world.result())
    base = one[arch]
    assert base["streams"] == jstreams and base["ticks"] == jst["ticks"]
    for r in (r0, r1):
        assert r["streams"] == base["streams"] and r["ticks"] == base["ticks"]
    if arch == "falcon-mamba-7b":
        for r in (r0, r1):
            assert len(r["logits"]) == len(base["logits"])
            assert all(np.array_equal(a, b) for a, b in zip(r["logits"], base["logits"]))
    else:
        rel = max(logits_rel(r["logits"], base["logits"]) for r in (r0, r1))
        assert rel <= ATTN_LOGIT_TOL
        record_property("logits_bit_equal", rel == 0.0)
    jcache = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
              for path, leaf in jax.tree_util.tree_flatten_with_path(jeng.cache)[0]}
    slot = base["last_slot"]
    kinds = []
    for name, leaf in base["cache"].items():
        got = gathered(r0, r1, name, shard_dim(name, leaf))
        assert got.shape == leaf.shape and np.array_equal(got, leaf), name
        last = name.split("/")[-1]
        kinds.append(last)
        if last in ("conv", "ssm", "state"):
            jl = jcache[name]
            jl = jl.view(np.uint8) if jl.dtype == jnp.bfloat16 else jl
            b = 1 if name.startswith("layers") else 0
            assert np.array_equal(np.take(jl, slot, axis=b), np.take(got, slot, axis=b)), name
    want = ["conv", "ssm"] if arch == "falcon-mamba-7b" else ["conv", "state"] * 2 + ["k", "v"]
    assert sorted(kinds) == sorted(want)


@pytest.mark.parametrize("arch", ATTENTION)
def test_attention_engines_within_tolerance_of_tp1(arch, world, one, params, record_property):
    """Qwen2-7B (GQA) and MiniCPM3-4B (absorbed MLA) over sequence-sharded
    contiguous caches at tp = 2, prefill chunk 4, prompts crossing into
    rank 1's half: the port's tp = 1 streams equal the JAX tp = 1 engine's;
    the ranks agree; every step's logits are within ATTN_LOGIT_TOL of tp =
    1's. Recorded: bit-equality of the logits, each stream's first token
    that differs from tp = 1's (None: none), and whether the caches gathered
    from the ranks equal tp = 1's."""
    _, jstreams, jst = jax_engine(arch, params[arch][0])
    r0, r1 = (r[arch] for r in world.result())
    base = one[arch]
    assert base["streams"] == jstreams and base["ticks"] == jst["ticks"]
    assert r0["streams"] == r1["streams"] and r0["logits"] and len(r0["logits"]) == len(
        r1["logits"])
    assert all(np.array_equal(a, b) for a, b in zip(r0["logits"], r1["logits"]))
    n = min(len(r0["logits"]), len(base["logits"]))
    rel = logits_rel(r0["logits"][:n], base["logits"][:n])
    assert rel <= ATTN_LOGIT_TOL, rel
    record_property("logits_bit_equal", rel == 0.0 and len(r0["logits"]) == len(base["logits"]))
    record_property("first_diverging_token", first_divergence(r0["streams"], base["streams"]))
    record_property("caches_equal_tp1", all(
        np.array_equal(gathered(r0, r1, k, shard_dim(k, v)), v) for k, v in base["cache"].items()))
    assert max(len(p) + m for p, m in zip(*C.CONTIG[arch][2:])) > C.CONTIG[arch][1] // TP


def test_ngram_speculation_tp2_over_contiguous_gqa(world, one, record_property):
    """N-gram speculation (k = 2) at tp = 2 over the sequence-sharded GQA
    cache: the rejected drafts' rows are zeroed on the rank that holds
    them, so the speculative streams equal tp = 2's plain decoding (as at
    tp = 1, where they equal tp = 1's plain streams); both ranks agree.
    Recorded: whether they equal tp = 1's speculative streams and caches."""
    w = world.result()
    spec = [r["spec"] for r in w]
    assert spec[0]["streams"] == spec[1]["streams"]
    assert spec[0]["streams"] == w[0]["qwen2-7b"]["streams"]
    assert one["spec"]["streams"] == one["qwen2-7b"]["streams"]
    record_property("spec_streams_equal_tp1", spec[0]["streams"] == one["spec"]["streams"])
    record_property("spec_caches_equal_tp1", all(
        np.array_equal(gathered(spec[0], spec[1], k, shard_dim(k, v)), v)
        for k, v in one["spec"]["cache"].items()))


@pytest.mark.parametrize("arch", list(C.CONTIG))
def test_per_device_accounting_halves(arch, world, one):
    """Per device at tp = 2 over contiguous caches: each rank's cache (KV
    rows, ring slots, states) holds exactly half of tp = 1's bytes;
    kv_bytes_per_token, every cost-model KV floor and weight_bytes halve
    (the reference's KV formula, now per device), the params shrink."""
    base = one[arch]
    for r in world.result():
        two = r[arch]
        assert two["cache_bytes"] * TP == base["cache_bytes"]
        assert two["kv_bytes_per_token"] * TP == base["kv_bytes_per_token"]
        for f in C.COST_FIELDS:
            assert two["cost"][f] * TP == base["cost"][f], f
        assert two["param_bytes"] < base["param_bytes"]


def test_sizes_that_do_not_divide_raise():
    """A contiguous cache at tp = 2 splits its capacity, ring and inner
    widths over the ranks: an odd capacity raises ValueError in
    `EngineConfig`, before any weight is made (a paged cache does not
    care), and `make_cache(tp=)` raises for each size that does not
    divide."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import make_cache

    mesh = Mesh({"data": 1, "model": TP})            # a rank's view; no group needed here
    with pytest.raises(ValueError, match="capacity"):
        EngineConfig(arch="qwen2-7b", reduced=True, device="cpu", capacity=47, mesh=mesh)
    EngineConfig(arch="qwen2-7b", reduced=True, device="cpu", capacity=47, mesh=mesh,
                 cache=CacheConfig(kind="paged_ams", page_size=8))
    with pytest.raises(ValueError, match="capacity"):
        make_cache(get_config("qwen2-7b").reduced(), 2, 47, tp=TP)
    cfg = get_config("recurrentgemma-9b").reduced()
    with pytest.raises(ValueError, match="sliding_window"):
        make_cache(dataclasses.replace(cfg, sliding_window=63), 2, 64, tp=TP)
    with pytest.raises(ValueError, match="lru_width"):
        make_cache(dataclasses.replace(cfg, lru_width=127), 2, 64, tp=TP)
    with pytest.raises(ValueError, match="d_inner"):
        make_cache(dataclasses.replace(get_config("falcon-mamba-7b").reduced(), ssm_expand=1,
                                       d_model=127), 2, 64, tp=TP)


def test_in_proj_shard_holds_both_halves():
    """Mamba's in_proj [D, 2 di] is [x | z]: rank r's shard is its slice of
    each half side by side, plain and packed (hi / scale), and the ranks'
    shards of the x half concatenate to the whole x half."""
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.models.common import quantize_params

    gen = torch.Generator().manual_seed(5)
    D, di = 64, 96
    w = (torch.randn((D, 2 * di), generator=gen) / 8).to(torch.bfloat16)
    full = quantize_params({"in_proj": {"w": w}}, QuantPolicy(min_elements=1 << 10))
    prefix = ["layers", "sub0", "mixer"]
    m = di // TP
    for tree in ({"in_proj": {"w": w}}, full):
        parts = [SH.shard_tree(tree, r, TP, prefix, n_stack=0)["in_proj"] for r in range(TP)]
        for key, leaf in tree["in_proj"].items():
            for r, part in enumerate(parts):
                want = torch.cat([leaf[..., r * m:(r + 1) * m],
                                  leaf[..., di + r * m:di + (r + 1) * m]], dim=-1)
                assert torch.equal(part[key], want), (key, r)
            x_half = torch.cat([p[key][..., :m] for p in parts], dim=-1)
            assert torch.equal(x_half, leaf[..., :di]), key


def test_whole_leaves_quantize_as_at_tp1():
    """A rank's serving params judge a leaf it holds whole (MLA's wq_a /
    wkv_a) at its own size and an N-shard at 1 / tp of it: with
    ``min_elements`` between reduced MiniCPM3-4B's wkv_a (6144 elements)
    and twice it, every linear is quantized at tp = 2 exactly where it is
    at tp = 1, and each rank's whole leaves are tp = 1's bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.tree import tree_items
    from repro_torch.launch.engine import init_serving_params

    cfg = get_config("minicpm3-4b").reduced()
    policy = QuantPolicy(scheme="fp5.33-e2m3", min_elements=8192)
    one = init_serving_params(cfg, policy, 0, "cpu")
    wkv_a = one["layers"]["sub0"]["attn"]["wkv_a"]
    assert "w" in wkv_a and 8192 // 2 < wkv_a["w"][0].numel() < 8192

    def quantized(tree):
        return {path[:-1]: path[-1] == "hi" for path, _ in tree_items(tree)
                if path[-1] in ("w", "hi") and len(path) >= 2}

    want = quantized(one)
    assert any(want.values()) and not all(want.values())
    whole = {path: leaf for path, leaf in tree_items(one)}
    for rank in range(TP):
        ctx = ParallelCtx(mesh=Mesh({"data": 1, "model": TP}, rank=rank), tp_axis="model")
        mine = init_serving_params(cfg, policy, 0, "cpu", ctx)
        assert quantized(mine) == want, rank
        for path, leaf in tree_items(mine):
            n_stack = 1 if path[0] == "layers" else 0
            if SH.serve_shard_dim(list(path), leaf, n_stack) is None:
                assert leaf.dtype == whole[path].dtype and torch.equal(leaf, whole[path]), path
