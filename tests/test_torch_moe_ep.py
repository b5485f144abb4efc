"""Expert-parallel MoE (`repro_torch.models.moe.moe_ep`) on two spawned gloo
ranks against the JAX package's ``moe_ep`` on a forced two-device host
mesh (run in a subprocess, as tests/test_distributed.py runs it).

Each rank holds E / 2 experts, routes every token with the replicated
router, serves each of its experts the top ``cap`` tokens by gate (ties to
the lower index, as ``jax.lax.top_k``) and the ranks' f32 partial sums are
added in rank order. Held on the reduced DBRX layer of the reference's
``test_moe_paths_agree`` at capacity factors 8.0 (no token dropped) and
1.25 (tokens dropped), and through a reduced Llama-4-Scout engine at
tp = 2, every MoE call of its run against the JAX ``moe_ep`` on the same
input.
"""

import dataclasses
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import torch_tp_cells as C  # noqa: E402
from test_distributed import run_py  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

DBRX = dict(num_layers=1, num_experts=4, experts_per_token=2, d_model=64, d_ff=128)
FACTORS = (8.0, 1.25)
# f32 experts: torch's and XLA's f32 dots sum in other orders, so outputs
# agree to f32 rounding, not bit for bit (measured worst case 7.2e-8 of
# the largest |y| at both factors); the routing, the capacity cut and aux
# are exact
EP_REL = 2e-6
# the Scout engine's bf16 layers: outputs within one bf16 rounding of the
# largest |y| (bf16 x bf16 projections summed in torch's and XLA's orders;
# measured: 21 of 22 calls bit-equal, the other 1.3e-3)
ENGINE_REL = 2.0 ** -7


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX ``moe_ep`` (forced 2-device mesh) at both capacity factors,
    with its params and input as numpy."""
    out = tmp_path_factory.mktemp("moe_ep") / "ref.pkl"
    run_py(f"""
    import dataclasses, pickle
    import jax, numpy as np
    from repro.configs import get_config
    from repro.launch.mesh import make_test_mesh, use_mesh
    from repro.models import moe as M
    from repro.models.parallel import ParallelCtx

    cfg = get_config('dbrx-132b').reduced(**{DBRX!r})
    mesh = make_test_mesh((1, 2), ('data', 'model'))
    ctx = ParallelCtx(mesh=mesh, dp_axes=('data',), tp_axis='model')
    p = M.init_moe(jax.random.PRNGKey(0), cfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, 64))
    res = dict(p=jax.tree.map(np.asarray, p), x=np.asarray(x))
    for cf in {FACTORS!r}:
        c = dataclasses.replace(cfg, moe_capacity_factor=cf)
        with use_mesh(mesh):
            y, aux = jax.jit(lambda p, x: M.moe_ep(p, x, c, ctx))(p, x)
            yd, auxd = M.moe_dense(p, x, c)
        res[cf] = (np.asarray(y), float(aux), np.asarray(yd))
    open({str(out)!r}, 'wb').write(pickle.dumps(res))
    """, devices=2, timeout=300)
    return pickle.loads(out.read_bytes())


@pytest.mark.parametrize("cf", FACTORS)
def test_moe_ep_matches_the_reference(cf, reference):
    """Port ``moe_ep`` on two ranks (equal bits on both) against the JAX
    ``moe_ep``: y within EP_REL of the largest |y|, aux bit-equal; at 8.0 no
    token drops, so both equal the dense combine within that tolerance;
    at 1.25 some (token, expert) pairs drop and y moves away from it."""
    cfg = dataclasses.replace(get_config("dbrx-132b").reduced(**DBRX), moe_capacity_factor=cf)
    (y0, aux0), (y1, aux1) = spawn(C.moe_ep_world, {"model": 2}, "cpu", reference["p"],
                                   reference["x"], cfg)
    want, want_aux, dense = reference[cf]
    np.testing.assert_array_equal(y0, y1)
    assert aux0 == aux1
    scale = np.abs(want).max()
    err = np.abs(y0 - want).max() / scale
    print(f"moe_ep cf={cf}: max |port - jax| / max |y| = {err:.3g}, "
          f"bit-equal {np.array_equal(y0, want)}, aux {aux0!r} vs {want_aux!r}")
    assert err <= EP_REL, err
    assert aux0 == want_aux
    drop = np.abs(dense - want).max() / scale
    if cf == 8.0:
        assert drop <= EP_REL
    else:
        assert drop > 1e-2          # dropped tokens change the output
    # the port's moe_ep on one device (tp = 1: every expert local) is moe_dense
    y, _ = M.moe_apply(params_from_numpy(reference["p"]), torch.from_numpy(reference["x"]),
                       cfg)
    np.testing.assert_allclose(y.numpy(), dense, rtol=0, atol=EP_REL * scale)


def test_scout_engine_tp2_moe_matches_the_reference(tmp_path):
    """A reduced Llama-4-Scout engine (bf16 weights over bf16 pages) at
    tp = 2, both ranks the same streams and the same MoE outputs; each
    MoE call's output within ENGINE_REL of the largest |y| against the JAX
    ``moe_ep`` of that layer's params on the call's input."""
    jcfg = j_get_config("llama4-scout-17b-16e").reduced()
    np_params = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), jcfg))
    (t0, calls0), (t1, calls1) = spawn(C.moe_engine_world, {"model": 2}, "cpu", np_params,
                                       "fp16", "fused_ref")
    assert t0 == t1 and len(calls0) == len(calls1) > 0
    for (x0, y0), (x1, y1) in zip(calls0, calls1):
        np.testing.assert_array_equal(x0, x1)
        np.testing.assert_array_equal(y0, y1)
    path = tmp_path / "calls.pkl"
    path.write_bytes(pickle.dumps(dict(params=np_params["layers"]["sub0"]["moe"],
                                       xs=[x for x, _ in calls0])))
    out = tmp_path / "want.pkl"
    run_py(f"""
    import pickle
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.launch.mesh import make_test_mesh, use_mesh
    from repro.models import moe as M
    from repro.models.parallel import ParallelCtx

    cfg = get_config('llama4-scout-17b-16e').reduced()
    mesh = make_test_mesh((1, 2), ('data', 'model'))
    ctx = ParallelCtx(mesh=mesh, dp_axes=('data',), tp_axis='model')
    d = pickle.loads(open({str(path)!r}, 'rb').read())
    stack = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16) if a.ndim >= 3 else
                         jnp.asarray(a), d['params'])
    f = jax.jit(lambda p, x: M.moe_ep(p, x, cfg, ctx)[0])
    ys = []
    with use_mesh(mesh):
        for i, x in enumerate(d['xs']):
            p = jax.tree.map(lambda a: a[i % 2], stack)
            ys.append(np.asarray(f(p, jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32)))
    open({str(out)!r}, 'wb').write(pickle.dumps(ys))
    """, devices=2, timeout=300)
    want = pickle.loads(out.read_bytes())
    worst = max(np.abs(y - w).max() / np.abs(w).max() for (_, y), w in zip(calls0, want))
    equal = sum(np.array_equal(y, w) for (_, y), w in zip(calls0, want))
    print(f"scout tp=2 moe_ep: {len(want)} calls, {equal} bit-equal, worst {worst:.3g}")
    assert worst <= ENGINE_REL, worst
