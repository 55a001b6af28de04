"""The port's cross-device cohort layer (``repro_torch.core.cohort``)
against the JAX reference (``repro.core.cohort``): ``CohortSpec``
validation, the staleness discount, the host-side arrival times and
deadline mask bit for bit, FedNL-PP recovered bit for bit at beta = 0
and deadline quantile 1, 12 rounds on the reference's a1a data to 1e-8
with the reference's draws replayed (its ``"fednl-cohort"`` schedule in
``_torch_replay``), and a ``cohort=`` cell priced on its own link and K.

Every JAX computation runs inside ``jax.enable_x64(True)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_parity import jax_a1a_oracles, port_problem, reference_a1a
from _torch_replay import schedule
from repro.core import cohort as jcohort
from repro.core.compressors import make_compressor as jax_make_compressor
from repro.engine import ExperimentSpec as JaxSpec
from repro.engine import Sweep as JaxSweep
from repro_torch.core import (
    CohortFedNLPP,
    CohortSpec,
    FedNLPP,
    arrival_times,
    make_compressor,
    on_time_mask,
    sample_cohort,
    staleness_weights,
)
from repro_torch.engine import ExperimentSpec, Oracles, Sweep
from repro_torch.engine import records as rec
from repro_torch.engine.method import RoundDraws

ROUNDS = 12
SEED = 3


@pytest.mark.parametrize("kwargs", [
    dict(cohort=0),
    dict(cohort=3, population=2),
    dict(cohort=1, deadline_quantile=0.0),
    dict(cohort=1, deadline_quantile=1.5),
    dict(cohort=1, staleness_beta=-0.1),
])
def test_cohort_spec_rejects_bad_config(kwargs):
    with pytest.raises(ValueError):
        CohortSpec(**kwargs)
    with pytest.raises(ValueError):
        jcohort.CohortSpec(**kwargs)


def test_cohort_spec_defaults_match_reference():
    ours, ref = CohortSpec(cohort=100), jcohort.CohortSpec(cohort=100)
    assert (ours.population, ours.staleness_beta, ours.link,
            ours.deadline_quantile, ours.seed) == \
        (ref.population, ref.staleness_beta, ref.link,
         ref.deadline_quantile, ref.seed)


@pytest.mark.parametrize("beta", [0.0, 0.5, 1.3])
def test_staleness_weights_match_reference(beta):
    s = np.array([-2, 0, 1, 3, 7, 40], np.int32)
    got = staleness_weights(torch.from_numpy(s), beta)
    with jax.enable_x64(True):
        want = np.asarray(jcohort.staleness_weights(jnp.asarray(s), beta))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15, atol=0)
    assert got[0] == got[1] == 1.0                   # clamped; fresh
    if beta == 0.0:
        assert torch.all(got == 1.0)
    else:
        assert torch.all(torch.diff(got[1:]) < 0)
    if beta == 0.5:
        assert got[3] == 0.5                         # (1 + 3)^(-1/2)


@pytest.mark.parametrize("link", ["fl-cross-device", "wan", "datacenter"])
def test_arrival_times_and_deadline_bitwise(link):
    for n, seed, bits in ((32, 3, 1e6), (142, 0, 48064.0), (5, 9, 1.0)):
        spec = CohortSpec(cohort=4, link=link, seed=seed)
        ref = jcohort.CohortSpec(cohort=4, link=link, seed=seed)
        t = arrival_times(spec, n, bits)
        assert np.array_equal(t, jcohort.arrival_times(ref, n, bits))
        for q in (0.3, 0.8, 1.0):
            assert np.array_equal(on_time_mask(t, q),
                                  jcohort.on_time_mask(t, q))
        assert bool(np.all(on_time_mask(t, 1.0)))


def test_sample_cohort_exactly_k():
    draws = RoundDraws(7)
    mask = sample_cohort(draws, 50, 10)
    assert mask.shape == (50,) and mask.dtype == torch.bool
    assert int(mask.sum()) == 10
    assert torch.equal(mask, sample_cohort(RoundDraws(7), 50, 10))
    assert not torch.equal(mask, sample_cohort(draws, 50, 10))
    assert int(sample_cohort(draws, 4, 9).sum()) == 4        # K >= N


def _problem():
    return port_problem(reference_a1a())


@pytest.mark.parametrize("family,level", [("topk", 123), ("blocktopk", 8),
                                          ("randk", 123)])
def test_cohort_recovers_fednl_pp_bitwise(family, level):
    """beta = 0 and deadline quantile 1 are FedNL-PP at tau = K: the same
    draws, unit weights for the sampled cohort, the same iterates bit
    for bit."""
    prob = _problem()
    comp = make_compressor(family, level)
    x0 = torch.zeros(prob["d"], dtype=torch.float64)
    spec = CohortSpec(cohort=5, staleness_beta=0.0, deadline_quantile=1.0)
    pp = FedNLPP(prob["grad"], prob["hess"], comp, tau=5)
    co = CohortFedNLPP(prob["grad"], prob["hess"], comp, cohort=spec)
    _, xs_pp = pp.run(x0, prob["n"], 6, seed=SEED)
    final, xs_co = co.run(x0, prob["n"], 6, seed=SEED)
    assert torch.equal(xs_co, xs_pp)
    assert final.last_round.dtype == torch.int32


SPECS = {
    "default": dict(cohort=5),
    "tight": dict(cohort=6, staleness_beta=1.0, deadline_quantile=0.5,
                  seed=2),
    "wan": dict(cohort=4, link="wan", deadline_quantile=0.7, seed=1),
}


@pytest.mark.parametrize("family,level", [("topk", 123), ("blocktopk", 8)])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_cohort_matches_reference(spec, family, level):
    """12 rounds on the reference's a1a data from x0 = 0, the reference's
    draws replayed: iterates to 1e-8, as FedNL-PP's."""
    kw = SPECS[spec]
    ref = jax_a1a_oracles()
    n, d = ref["n"], ref["d"]
    with jax.enable_x64(True):
        jco = jcohort.CohortFedNLPP(ref["grad"], ref["hess"],
                                    jax_make_compressor(family, level),
                                    cohort=jcohort.CohortSpec(**kw))
        _, want = jco.run(jnp.zeros(d), n, ROUNDS, seed=SEED)
        want = np.asarray(want)
    prob = _problem()
    comp = make_compressor(family, level)
    co = CohortFedNLPP(prob["grad"], prob["hess"], comp,
                       cohort=CohortSpec(**kw))
    draws = schedule("fednl-cohort", SEED, ROUNDS, n, d, comp=comp,
                     tau=kw["cohort"])
    _, xs = co.run(torch.zeros(d, dtype=torch.float64), n, ROUNDS,
                   draws=draws)
    assert draws.left() == 0
    np.testing.assert_allclose(xs.numpy(), want, rtol=0, atol=1e-8)


def test_straggler_discount_applied():
    """With a tight deadline and beta > 0, sampled stragglers weigh
    (1 + staleness)^(-beta), the on-time 1 and the unsampled 0, against
    the hand-computed arrival mask; the weights stay on the tensor's
    device."""
    prob = _problem()
    n, d = prob["n"], prob["d"]
    spec = CohortSpec(cohort=8, staleness_beta=0.5, deadline_quantile=0.5,
                      seed=1)
    co = CohortFedNLPP(prob["grad"], prob["hess"], make_compressor("topk", 30),
                       cohort=spec)
    state = co.init(torch.zeros(d, dtype=torch.float64), n)
    state = state._replace(step=state.step + 3)            # 3 rounds stale
    active = torch.zeros(n, dtype=torch.bool)
    active[::2] = True
    wts = co.round_weights(state, active).numpy()
    on_time = on_time_mask(arrival_times(spec, n, make_compressor(
        "topk", 30).spec((d, d)).bits), 0.5)
    act = active.numpy()
    assert np.all(wts[~act] == 0.0)
    assert np.all(wts[act & on_time] == 1.0)
    assert np.all(wts[act & ~on_time] == 0.5)              # (1 + 3)^(-1/2)
    assert (act & ~on_time).any() and (act & on_time).any()


def test_population_mismatch_raises():
    prob = _problem()
    co = CohortFedNLPP(prob["grad"], prob["hess"], make_compressor("topk", 9),
                       cohort=CohortSpec(cohort=2, population=4))
    with pytest.raises(ValueError, match="population"):
        co.init(torch.zeros(prob["d"], dtype=torch.float64), prob["n"])


def test_cohort_cell_priced_on_its_link_and_k():
    """A ``cohort=`` cell's seconds_per_round is the cohort's K on the
    cohort's link, not the sweep's n on the sweep's link: the reference's
    number exactly."""
    prob = _problem()
    n, d = prob["n"], prob["d"]
    cohort = CohortSpec(cohort=5, link="fl-cross-device")
    specs = [ExperimentSpec("fednl-cohort", "topk", 123, cohort=cohort,
                            num_rounds=2),
             ExperimentSpec("fednl-pp", "topk", 123, params=dict(tau=5),
                            num_rounds=2)]
    res = Sweep(specs, link="wan").run(prob)
    co, pp = res.cells
    method = specs[0].build(Oracles(prob["val"], prob["grad"],
                                    prob["hess"]))
    assert co.seconds_per_round == rec.seconds_per_round(
        method, d, 5, link="fl-cross-device")
    assert pp.seconds_per_round == rec.seconds_per_round(
        method, d, n, link="wan")
    assert co.seconds_per_round != pp.seconds_per_round
    with jax.enable_x64(True):
        ref = jax_a1a_oracles()
        jprob = dict(grad=ref["grad"], hess=ref["hess"], n=n, d=d)
        jspec = JaxSpec("fednl-cohort", "topk", 123,
                        cohort=jcohort.CohortSpec(cohort=5), num_rounds=2)
        want = JaxSweep([jspec], link="wan").run(jprob).cells[0]
    assert co.seconds_per_round == want.seconds_per_round
    assert res.records()[0]["name"] == "fednl-cohort:topk123:K5"
