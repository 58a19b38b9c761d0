"""The port's leftovers of the planning core and the aggregation API
against the JAX package: ``assoc.exhaustive`` and
``iteropt.paper_closed_form_ab`` are numpy only in both packages, so they
must agree EXACTLY; ``aggregate.weighted_average`` runs fp32 sums in
another order, so within 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import assoc as j_assoc  # noqa: E402
from repro.core import delay as j_delay  # noqa: E402
from repro.core import iteropt as j_iteropt  # noqa: E402
from repro.core.problem import HFLProblem as JProblem  # noqa: E402
from repro.fl import aggregate as j_agg  # noqa: E402
from repro_torch.core import assoc as t_assoc  # noqa: E402
from repro_torch.core import delay as t_delay  # noqa: E402
from repro_torch.core import iteropt as t_iteropt  # noqa: E402
from repro_torch.core.problem import HFLProblem as TProblem  # noqa: E402
from repro_torch.fl import aggregate as t_agg  # noqa: E402
from repro_torch.fl.flatten import tree_leaves  # noqa: E402


# tests/test_core_assoc.py:45-53's instances, plus a three-edge one
@pytest.mark.parametrize("kw", [
    dict(num_edges=2, num_ues=7, seed=0),
    dict(num_edges=2, num_ues=7, seed=1),
    dict(num_edges=2, num_ues=7, seed=2),
    dict(num_edges=2, num_ues=7, seed=3),
    dict(num_edges=2, num_ues=6, seed=1),
    dict(num_edges=3, num_ues=6, seed=4)],
    ids=lambda kw: f"{kw['num_edges']}x{kw['num_ues']}-s{kw['seed']}")
def test_exhaustive_matches_reference_exactly(kw):
    jp, tp = JProblem(**kw), TProblem(**kw)
    ja, ta = j_assoc.exhaustive(jp, a=5.0), t_assoc.exhaustive(tp, a=5.0)
    np.testing.assert_array_equal(ta, ja)
    assert ta.dtype == ja.dtype
    assert t_delay.association_latency(tp, ta, 5.0) == \
        j_delay.association_latency(jp, ja, 5.0)
    # the enumeration's optimum bounds every strategy the port has
    for name, fn in t_assoc.STRATEGIES.items():
        assert t_delay.association_latency(tp, ta, 5.0) <= \
            t_delay.association_latency(tp, fn(tp, seed=0), 5.0) + 1e-9, name


def test_exhaustive_refuses_large_instances():
    with pytest.raises(ValueError, match="infeasible"):
        t_assoc.exhaustive(TProblem(num_edges=5, num_ues=100))


# tests/test_core_iteropt.py:91's point, and multiplier settings where the
# printed eq. 32 goes NaN
@pytest.mark.parametrize("mu_scale,T", [(0.1, 10.0), (1.0, 10.0),
                                        (0.01, 3.0), (0.1, 50.0)])
def test_paper_closed_form_matches_reference_exactly(mu_scale, T):
    kw = dict(num_edges=3, num_ues=18, epsilon=0.25, seed=3)
    jp, tp = JProblem(**kw), TProblem(**kw)
    A = j_assoc.proposed(jp)
    np.testing.assert_array_equal(t_assoc.proposed(tp), A)
    lam = np.ones(jp.num_edges)
    mu = np.ones(jp.num_ues) * mu_scale
    j = j_iteropt.paper_closed_form_ab(
        jp, lam, mu, j_delay.edge_round_time(jp, A, 10), jp.t_cmp(), T)
    t = t_iteropt.paper_closed_form_ab(
        tp, lam, mu, t_delay.edge_round_time(tp, A, 10), tp.t_cmp(), T)
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))  # NaN == NaN
    assert np.isfinite(t[0]) and t[0] > 0


def _tree(rng, n):
    """tests/test_fl_runtime.py:15's stacked tree, plus a nested bf16 leaf."""
    return {"w": rng.normal(0, 1, (n, 4, 3)).astype(np.float32),
            "b": rng.normal(0, 1, (n, 5)).astype(np.float32),
            "sub": {"h": rng.normal(0, 1, (n, 2, 2)).astype(np.float32)}}


@pytest.mark.parametrize("n", [1, 2, 7])
def test_weighted_average_matches_reference(n):
    rng = np.random.default_rng(n)
    stacked = _tree(rng, n)
    w = rng.uniform(1, 10, n)
    j_list = [jax.tree.map(lambda x: jnp.asarray(x[i]), stacked)
              for i in range(n)]
    for lst in j_list:
        lst["sub"]["h"] = lst["sub"]["h"].astype(jnp.bfloat16)
    t_list = [{"w": torch.from_numpy(stacked["w"][i]),
               "b": torch.from_numpy(stacked["b"][i]),
               "sub": {"h": torch.from_numpy(stacked["sub"]["h"][i])
                       .to(torch.bfloat16)}} for i in range(n)]
    jo = j_agg.weighted_average(j_list, w)
    to = t_agg.weighted_average(t_list, w)
    assert to["sub"]["h"].dtype == torch.bfloat16
    assert to["w"].dtype == torch.float32
    for a, b in zip(tree_leaves(to), jax.tree.leaves(jo)):
        assert tuple(a.shape) == b.shape
        # the bf16 leaf: fp32 means within 1e-5, each rounded to bf16, may
        # land one bf16 ulp (2**-8 relative) apart
        tol = 2.0 ** -8 if a.dtype == torch.bfloat16 else 1e-5
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=tol,
                                   atol=1e-5)
    # and the numpy weighted mean of tests/test_fl_runtime.py:28
    ref = np.einsum("n,n...->...", (w / w.sum()).astype(np.float32),
                    stacked["w"])
    np.testing.assert_allclose(to["w"].numpy(), ref, rtol=1e-5)
