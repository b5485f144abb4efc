"""Spawn targets of tests/test_torch_tp.py and tests/test_torch_moe_ep.py:
what each rank of a CPU world (gloo, `repro_torch.launch.mesh.spawn`) runs.
Spawn pickles a target by name, so they live in this importable module,
which imports the port only (no JAX). Every function also runs without a
mesh (``mesh=None``: one device), which is how the tests get tp = 1's
answers for the same cells.
"""

from __future__ import annotations

import torch

from repro_torch.cache import CacheConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.launch.config import EngineConfig
from repro_torch.launch.engine import ServeEngine
from repro_torch.launch.sampling import SamplingParams
from repro_torch.models.convert import params_from_numpy

PAGE, CAP = 8, 32
# the reference's equivalence grid (tests/test_sharded_serving.py): cache
# format x chunk x epilogue (speculative decoding at k = 2, greedy)
GRID = [(kind, scheme, chunk, mode)
        for kind, scheme in (("paged_bf16", "fp16"), ("paged_ams", "fp5.33-e2m3"))
        for chunk in (1, 4) for mode in ("greedy", "sampled", "spec")]
STAT_KEYS = ("ticks", "ttft_ticks_p50", "latency_ticks_p50")
SHARED = [3, 5, 7, 11, 13, 2, 9, 4] * 2          # two full pages of 8 tokens
COST_FIELDS = ("kv_bytes_per_token", "kv_ideal_bytes_per_token", "kv_bf16_bytes_per_token",
               "kv_dequant_bytes_per_token", "weight_bytes")


def engine_config(mesh, scheme="fp5.33-e2m3", kind="paged_ams", chunk=4, k=0,
                  arch="qwen2-7b", impl="fused_ref", attn="ref", **kw):
    return EngineConfig(arch=arch, reduced=True, scheme=scheme, impl=impl, slots=2,
                        capacity=CAP, prefill_chunk=chunk, speculate_k=k, mesh=mesh,
                        device="cpu", cache=CacheConfig(kind=kind, page_size=PAGE, impl=attn),
                        **kw)


def drive(eng, mode: str):
    """The reference test's two-request workload; (tokens per finished
    request, the tick stats)."""
    samp = SamplingParams(temperature=0.8, top_p=0.9, seed=123) if mode == "sampled" else None
    eng.submit([3, 5, 7], max_tokens=6, sampling=samp)
    eng.submit([3, 5, 11, 13, 2, 9], max_tokens=6, sampling=samp)
    st = eng.run()
    return [list(map(int, r.tokens)) for r in eng.finished], {k: st[k] for k in STAT_KEYS}


def serve_cell(mesh, np_params, cell):
    kind, scheme, chunk, mode = cell
    eng = ServeEngine(engine_config(mesh, scheme, kind, chunk, 2 if mode == "spec" else 0),
                      params=params_from_numpy(np_params))
    return drive(eng, mode)


def drive_shared(mesh, np_params):
    """Shared-prefix workload: the second request is submitted after the
    first drains, so its two full prefix pages hit the published index."""
    eng = ServeEngine(engine_config(mesh), params=params_from_numpy(np_params))
    eng.submit(SHARED + [17], max_tokens=4)
    eng.run()
    eng.submit(SHARED + [19], max_tokens=4)
    eng.run()
    toks = [list(map(int, r.tokens)) for r in eng.finished]
    return toks, eng.block_tables.tolist(), eng.alloc.stats()


def preempt(mesh, np_params):
    """A request preempted after its prefill (its private pages spill to the
    host, the rank's kv heads of them) and resumed; (tokens, spill stats)."""
    eng = ServeEngine(engine_config(mesh), params=params_from_numpy(np_params))
    a = eng.submit([3, 5, 7, 11, 13, 2, 9, 4, 6, 8], max_tokens=6)
    b = eng.submit([3, 5, 11, 13, 2, 9], max_tokens=6)
    for _ in range(3):
        eng.step()
    eng.preempt(a.request.slot)
    eng.run()
    return [list(a.tokens), list(b.tokens)], dict(
        preemptions=eng.preemptions, resumes=eng.resumes, spill_pages=eng.spill_pages,
        spill_bytes=eng.spill_bytes)


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def accounting(mesh, np_params):
    """Per-device accounting of the FP5.33 engine over AMS pages."""
    eng = ServeEngine(engine_config(mesh), params=params_from_numpy(np_params))
    cm = eng.cost_model
    out = dict(kv_bytes_per_token=eng.kv_bytes_per_token(),
               cost={f: getattr(cm, f) for f in COST_FIELDS},
               tp=eng.signature["tp"], compression=eng.kv_compression_vs_bf16(),
               pool_bytes=nbytes(eng.cache), param_bytes=nbytes(eng.params))
    drive(eng, "greedy")
    out["kv_floor_ratio"] = eng.stats()["kv_floor_ratio"]
    out["graphs"] = eng.stats()["graphs"]
    return out


def refusals(mesh, np_params):
    """What a tp > 1 mesh refuses: {case: (exception type, message)}, (None,
    "") where the case builds (the contiguous, MLA, Mamba and RG-LRU
    configs, served since sequence-sharded caches were ported; MoE over a
    sequence in the training layout, ``moe_tp``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.frontend import ServeFrontend
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import moe as M
    from repro_torch.models.parallel import ParallelCtx

    def scout_seq():
        from repro_torch.core.tree import tree_map
        from repro_torch.launch.sharding import params_shardings, shard_tree
        from repro_torch.models import init_params

        cfg = get_config("llama4-scout-17b-16e").reduced()
        p = tree_map(lambda t: t[0], init_params(0, cfg)["layers"]["sub0"]["moe"])
        ctx = ParallelCtx(mesh=mesh, tp_axis="model", train_layout=True)
        p = shard_tree(p, ctx.rank, ctx.tp, dims=params_shardings(p, axis="model"))
        x = torch.zeros((1, 2, cfg.d_model), dtype=torch.bfloat16)
        y, _ = M.moe_apply(p, x, cfg, ctx=ctx, phase="seq")
        assert y.shape == x.shape

    eng = ServeEngine(engine_config(mesh), params=params_from_numpy(np_params))
    cases = {
        "contiguous": lambda: EngineConfig(reduced=True, device="cpu", mesh=mesh),
        "mla": lambda: engine_config(mesh, arch="minicpm3-4b", kind="contiguous"),
        "mamba": lambda: engine_config(mesh, arch="falcon-mamba-7b", kind="contiguous",
                                       chunk=1),
        "rglru": lambda: engine_config(mesh, arch="recurrentgemma-9b", kind="contiguous",
                                       chunk=1),
        "data>1": lambda: make_serving_mesh(1, "cpu"),
        "frontend": lambda: ServeFrontend(eng),
        "graphs": eng.capture_graphs,
        "self-drafter": lambda: engine_config(mesh, k=2, drafter="self"),
        "moe-seq": scout_seq,
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = (None, "")
        except Exception as e:        # noqa: BLE001 - the test reads the type and message
            out[name] = (type(e).__name__, str(e))
    return out


def serving_world(mesh, np_params):
    """One rank's share of tests/test_torch_tp.py: every grid cell, the
    shared-prefix workload, a preemption, the accounting and the refusals."""
    torch.set_num_threads(1)
    return dict(cells={cell: serve_cell(mesh, np_params, cell) for cell in GRID},
                shared=drive_shared(mesh, np_params),
                preempt=preempt(mesh, np_params),
                accounting=accounting(mesh, np_params),
                refusals=refusals(mesh, np_params))


def collective_inputs(rank: int):
    """Rank r's operands: f32 values of magnitudes 1e-3 .. 1e3 (sums whose
    association shows in the bits) and a bf16 slice."""
    gen = torch.Generator().manual_seed(100 + rank)
    x = torch.randn((3, 64), generator=gen) * 10.0 ** torch.randint(-3, 4, (3, 64),
                                                                        generator=gen)
    return x, torch.randn((2, 3, 5), generator=gen).to(torch.bfloat16)


def collectives(mesh):
    """`sum_ranks` and `all_gather_last` of this rank's operands."""
    from repro_torch.models.parallel import ParallelCtx

    ctx = ParallelCtx(mesh=mesh, tp_axis="model")
    x, y = collective_inputs(ctx.rank)
    return ctx.sum_ranks(x), ctx.all_gather_last(y)


def moe_ep_world(mesh, np_moe, x, cfg, policy=None):
    """`moe_ep` of one layer: the rank's experts of the whole layer tree
    ``np_moe`` (numpy) on x (numpy), as f32 numpy (y, aux)."""
    from repro_torch.launch.sharding import shard_tree
    from repro_torch.models import moe as M
    from repro_torch.models.parallel import ParallelCtx

    torch.set_num_threads(1)
    ctx = ParallelCtx(mesh=mesh, tp_axis="model")
    p = shard_tree(params_from_numpy(np_moe), ctx.rank, ctx.tp, ["moe"])
    y, aux = M.moe_ep(p, torch.from_numpy(x), cfg, ctx, policy)
    return y.to(torch.float32).numpy(), float(aux)


def moe_engine_world(mesh, np_params, scheme, impl):
    """A reduced Llama-4-Scout engine at this mesh serving two requests;
    returns (streams, [(moe_ep's input, output) per MoE call of the run])."""
    from repro_torch.models import moe as M

    torch.set_num_threads(1)
    calls = []
    inner = M.moe_ep

    def recorded(p, x, cfg, ctx, policy=None):
        y, aux = inner(p, x, cfg, ctx, policy)
        calls.append((x.to(torch.float32).numpy(), y.to(torch.float32).numpy()))
        return y, aux

    M.moe_ep = recorded
    try:
        eng = ServeEngine(engine_config(mesh, scheme=scheme, arch="llama4-scout-17b-16e",
                                        chunk=1, impl=impl),
                          params=params_from_numpy(np_params))
        toks, _ = drive(eng, "greedy")
    finally:
        M.moe_ep = inner
    return toks, calls



# ------------------------------------------------ contiguous caches at tp > 1
# (tests/test_torch_tp_contiguous.py) the reduced configs of the slice, each
# over a contiguous cache: (prefill chunk, capacity, prompts, new tokens).
# The attention prompts cross the middle of the cache (rank 1's first
# position); the hybrid's second prompt wraps its 64-slot ring.
CONTIG = {
    "qwen2-7b": (4, 48, (list(range(3, 23)), [3, 5, 11, 13, 2, 9, 4, 4, 2] * 2,
                         [1, 2, 3] * 12), (8, 9, 10)),
    "minicpm3-4b": (4, 48, (list(range(3, 23)), [3, 5, 11, 13, 2, 9, 4, 4, 2] * 2,
                            [1, 2, 3] * 12), (8, 9, 10)),
    "falcon-mamba-7b": (1, 32, ([3, 5, 7, 9, 11, 13, 2, 9, 4], [7, 1, 8, 2, 8],
                                list(range(40, 52))), (8, 8, 8)),
    "recurrentgemma-9b": (1, 96, ([3, 5, 7, 9, 11, 13, 2, 9, 4],
                                  [(7 * i) % 500 + 1 for i in range(74)],
                                  list(range(40, 52))), (8, 8, 8)),
}


def contig_config(mesh, arch, k=0, impl="kernel"):
    chunk, cap, _, _ = CONTIG[arch]
    return EngineConfig(arch=arch, reduced=True, scheme="fp5.33-e2m3", impl=impl, slots=2,
                        capacity=cap, prefill_chunk=max(chunk, k + 1 if k else 1),
                        speculate_k=k, mesh=mesh, device="cpu",
                        cache=CacheConfig(kind="contiguous", impl="ref"))


def contig_serve(mesh, np_params, arch, k=0):
    """The arch's workload on a contiguous-cache engine at this mesh: (the
    streams, the logits of every step (greedy engines), the cache leaves as
    numpy, kv_bytes_per_token, the cost model's KV and weight fields, the
    cache's and the params' bytes)."""
    from repro_torch.core.tree import tree_items
    from repro_torch.launch import steps

    _, _, prompts, new = CONTIG[arch]
    eng = ServeEngine(contig_config(mesh, arch, k), params=params_from_numpy(np_params))
    logits = []
    real = steps.sample_tokens

    def tap(lg, sampling):
        logits.append(lg.to(torch.float32).numpy().copy())
        return real(lg, sampling)

    steps.sample_tokens = tap
    try:
        hs = [eng.submit(p, n) for p, n in zip(prompts, new)]
        eng.run()
    finally:
        steps.sample_tokens = real
    cm = eng.cost_model
    return dict(streams=[list(map(int, h.tokens)) for h in hs], logits=logits,
                last_slot=eng.finished[-1].slot,
                cache={"/".join(p): t.view(torch.uint8).numpy().copy() if t.dtype == torch.bfloat16
                       else t.numpy().copy() for p, t in tree_items(eng.cache)},
                kv_bytes_per_token=eng.kv_bytes_per_token(),
                cost={f: getattr(cm, f) for f in COST_FIELDS},
                cache_bytes=nbytes(eng.cache), param_bytes=nbytes(eng.params),
                ticks=eng.stats()["ticks"])


def contiguous_world(mesh, np_params_by_arch):
    """One rank's share of tests/test_torch_tp_contiguous.py: every arch's
    workload and n-gram speculation (k = 2) on the GQA one."""
    torch.set_num_threads(1)
    out = {arch: contig_serve(mesh, np_params_by_arch[arch], arch) for arch in CONTIG}
    out["spec"] = contig_serve(mesh, np_params_by_arch["qwen2-7b"], "qwen2-7b", k=2)
    return out


def seq_cores(mesh, cases):
    """The sequence-sharded insert + attend cores on this rank: for each
    case of ``cases`` (numpy inputs, the caches whole), the rank's shard of
    the caches goes in; returns {case: (output, the rank's cache shards)}
    as uint16 views of the bf16 bits."""
    from repro_torch.models import attention as A
    from repro_torch.models.parallel import ParallelCtx

    torch.set_num_threads(1)
    ctx = ParallelCtx(mesh=mesh, tp_axis="model", seq_shard=True) if mesh is not None \
        else None
    r, tp = (ctx.rank, ctx.tp) if ctx is not None else (0, 1)
    bits = lambda t: t.contiguous().view(torch.int16).numpy().view("uint16")   # noqa: E731

    def bf(a):
        return torch.from_numpy(a.copy()).view(torch.bfloat16)

    def shard(a):
        s = a.shape[1] // tp
        return bf(a[:, r * s:(r + 1) * s].copy())

    out = {}
    for name, c in cases.items():
        pos = torch.from_numpy(c["pos"])
        if name.startswith("mla"):
            kw = dict(r_kv=int(c["r_kv"]), scale=float(c["scale"]), ctx=ctx)
            cache = shard(c["cache"])
            if "nvalid" in c:
                o, cache = A.mla_decode_core_chunk(bf(c["q"]), bf(c["new"]), cache, pos,
                                                   torch.from_numpy(c["nvalid"]), **kw)
            else:
                o, cache = A.mla_decode_core(bf(c["q"]), bf(c["new"]), cache, pos, **kw)
            out[name] = (bits(o), [bits(cache)])
            continue
        kvm = A.kv_index_map(c["q"].shape[-2], c["q"].shape[-2], c["k"].shape[-2])
        ck, cv = shard(c["ck"]), shard(c["cv"])
        if "nvalid" in c:
            o, ck, cv = A.gqa_decode_core_chunk(bf(c["q"]), bf(c["k"]), bf(c["v"]), ck, cv, pos,
                                                torch.from_numpy(c["nvalid"]), kv_map=kvm,
                                                ctx=ctx)
        else:
            w = int(c.get("window", 0))
            o, ck, cv = A.gqa_decode_core(bf(c["q"]), bf(c["k"]), bf(c["v"]), ck, cv, pos,
                                          kv_map=kvm, window=w, ring=bool(w), ctx=ctx)
        out[name] = (bits(o), [bits(ck), bits(cv)])
    return out


def collectives_merge(mesh):
    """`max_ranks` of this rank's f32 operand and `all_gather_last_each` of
    its two bf16 slices (`collective_inputs`)."""
    from repro_torch.models.parallel import ParallelCtx

    ctx = ParallelCtx(mesh=mesh, tp_axis="model")
    x, y = collective_inputs(ctx.rank)
    return ctx.max_ranks(x), ctx.all_gather_last_each(y, y[..., :2] * 3)
