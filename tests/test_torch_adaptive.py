"""The port's cost model, Eq. 18 selection, convergence math, cost fit,
planner, schedules, two-tier planner and wave planner against
``repro``: the same inputs through both packages.

The math runs the same float64 Python arithmetic in both, so it is
compared exactly (``==``), the least-squares fit to 1e-12 relative.
Plans of TinyLlama-1.1B's smoke and full-size leaf lists (analytic
profiles: the FLOPs-based budgets, and budgets apportioned from a
measured total) must give the same JSON in both packages, and every
schedule written by one package loads in the other with the same
per-leaf k's.  Hardware constants: the reference's three profiles and
the port's ``H100_NVLINK``, each copied field for field into the other
package's ``Hardware``.
"""
import dataclasses
import json
import math
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.autotune import costfit as JF  # noqa: E402
from repro.autotune import planner as JP  # noqa: E402
from repro.autotune import profiler as JPR  # noqa: E402
from repro.autotune import schedule as JS  # noqa: E402
from repro.configs import tinyllama_1_1b as jcfg  # noqa: E402
from repro.core import adaptive as JA  # noqa: E402
from repro.core import comm_model as JCM  # noqa: E402
from repro.core import convergence as JCV  # noqa: E402
from repro.launch import train as JTR  # noqa: E402
from repro.pipeline import waves as JW  # noqa: E402
from repro.runtime import hier as JH  # noqa: E402
from repro_torch.autotune import costfit as TF  # noqa: E402
from repro_torch.autotune import planner as TP  # noqa: E402
from repro_torch.autotune import profiler as TPR  # noqa: E402
from repro_torch.autotune import schedule as TS  # noqa: E402
from repro_torch.configs import tinyllama_1_1b as tcfg  # noqa: E402
from repro_torch.core import adaptive as TA  # noqa: E402
from repro_torch.core import comm_model as TCM  # noqa: E402
from repro_torch.core import convergence as TCV  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.pipeline import waves as TW  # noqa: E402
from repro_torch.runtime import hier as TH  # noqa: E402
from repro_torch import tree  # noqa: E402

HWS = {"eth": JCM.ETH_1GBPS, "tpu_ici": JCM.TPU_V5E_ICI,
       "tpu_dcn": JCM.TPU_DCN, "h100": TCM.H100_NVLINK}
DS = (1, 7, 4096, 1_000_000, 2048 * 5632 * 22)
CS = (1.0, 2.0, 8.0, 100.0, 1000.0)
PS = (1, 2, 4, 16)


def _pair(hw):
    """(the port's Hardware, the reference's) with the same fields."""
    f = dataclasses.asdict(hw)
    return TCM.Hardware(**f), JCM.Hardware(**f)


@pytest.mark.parametrize("hw", list(HWS))
def test_comm_model_matches_reference(hw):
    th, jh = _pair(HWS[hw])
    for d in DS:
        for p in PS:
            assert TCM.allreduce_time(4 * d, p, th) == \
                JCM.allreduce_time(4 * d, p, jh)
            assert TCM.allgather_time(8 * d, p, th) == \
                JCM.allgather_time(8 * d, p, jh)
            for c in CS:
                assert TCM.sparse_allgather_time(d, c, p, th) == \
                    JCM.sparse_allgather_time(d, c, p, jh)
        assert TCM.layer_backward_time(4.0 * d * 1024, th) == \
            JCM.layer_backward_time(4.0 * d * 1024, jh)
    for tf, tb, tc in ((0.0, 1.0, 1.0), (0.1, 0.3, 0.05), (1.0, 0.0, 1.0),
                       (0.2, 0.5, 2.0)):
        assert TCM.pipeline_speedup_bound(tf, tb, tc) == \
            JCM.pipeline_speedup_bound(tf, tb, tc)
        assert TCM.iteration_time_slgs(tf, tb, tc) == \
            JCM.iteration_time_slgs(tf, tb, tc)
        if tf + tb > 0:
            assert TCM.max_speedup_cap(tf, tb) == JCM.max_speedup_cap(tf, tb)
    tb, tc = [0.1, 0.02, 0.3, 0.0], [0.05, 0.2, 0.01, 0.4]
    assert TCM.iteration_time_lags(0.2, tb, tc) == \
        JCM.iteration_time_lags(0.2, tb, tc)
    assert dataclasses.asdict(TCM.ETH_1GBPS) == \
        dataclasses.asdict(JCM.ETH_1GBPS)


def test_h100_profile_is_the_datasheet_and_a_fitted_wire():
    hw = TCM.H100_NVLINK
    assert (hw.hbm_bw, hw.flops) == (3.35e12, 67e12)
    assert 0 < hw.alpha < 1e-3 and 0 < hw.beta < 1.0 / 1e9
    assert TF.fit_hardware.__kwdefaults__["base"] is hw


@pytest.mark.parametrize("hw", list(HWS))
def test_adaptive_matches_reference(hw):
    th, jh = _pair(HWS[hw])
    budgets = (0.0, 1e-6, 1e-4, 1e-3, 1e-2, 1.0)
    for d in DS:
        assert TA.sparsification_overhead(d, th) == \
            JA.sparsification_overhead(d, jh)
        for p in PS:
            for b in budgets:
                for cu in (1000.0, 100.0, 3.0, 1.0):
                    assert TA.choose_ratio(d, b, p, th, cu) == \
                        JA.choose_ratio(d, b, p, jh, cu)
            for t in (1e-6, 1e-3, 1.0):
                assert TA.uniform_ratio_for_target(d, t, p, th) == \
                    JA.uniform_ratio_for_target(d, t, p, jh)
    layers = [(f"l{i}", d, 4.0 * d * 512) for i, d in enumerate(DS)]
    assert TA.choose_ratios([TA.LayerProfile(*x) for x in layers], 4, th) \
        == JA.choose_ratios([JA.LayerProfile(*x) for x in layers], 4, jh)


def test_choose_ratio_saturates_at_the_cap():
    """A zero budget hides nothing: the cap itself (never beyond it),
    in both packages; a budget that hides the dense exchange gives 1."""
    th, jh = _pair(JCM.ETH_1GBPS)
    for cu in (1000.0, 64.0, 3.0):
        want = float(min(cu, 1000))
        assert TA.choose_ratio(10**6, 0.0, 4, th, cu) == want
        assert JA.choose_ratio(10**6, 0.0, 4, jh, cu) == want
    assert TA.choose_ratio(10**6, 10.0, 4, th) == 1.0
    assert TA.uniform_ratio_for_target(10**6, 1e-9, 4, th) == math.inf


def test_convergence_math_matches_reference():
    for cmax in (1.5, 2.0, 10.0, 1000.0):
        rs = [1.0, cmax, cmax / 2]
        assert TCV.lemma1_contraction(rs) == JCV.lemma1_contraction(rs)
        for eta in (None, 0.5 / cmax):
            assert TCV.tau(cmax, eta) == JCV.tau(cmax, eta)
            assert TCV.stepsize_condition_D(0.1, cmax, eta) == \
                JCV.stepsize_condition_D(0.1, cmax, eta)
            for t in (1, 10, 1000):
                assert TCV.corollary1_bound(t, 0.1, cmax, 2.0, eta) == \
                    JCV.corollary1_bound(t, 0.1, cmax, 2.0, eta)
        for T in (1, 100, 10**6):
            assert TCV.corollary2_bound(T, 0.05, cmax, 3.0, 2.0, 1.5) == \
                JCV.corollary2_bound(T, 0.05, cmax, 3.0, 2.0, 1.5)
    alphas = [0.1 / math.sqrt(t + 1) for t in range(50)]
    assert TCV.stepsizes_diverge_sum(alphas) == \
        JCV.stepsizes_diverge_sum(alphas)
    with pytest.raises(AssertionError):
        TCV.stepsize_condition_D(0.1, 4.0, eta=1.0)


def _samples(mod, rng, alpha=7e-6, beta=1 / 90e9, noise=0.0, p=4):
    """Synthetic collective timings on an exact α–β line (+ noise)."""
    out = []
    for nbytes in (4096, 65536, 1 << 20, 1 << 22, 1 << 24):
        n = float(nbytes)
        t_ag = (p - 1) * (alpha + n * beta)
        t_ar = 2 * (p - 1) * (alpha + n / p * beta)
        out.append(mod.CommSample("allgather", n, p,
                                  t_ag * (1 + noise * rng.standard_normal())))
        out.append(mod.CommSample("allreduce", n, p,
                                  t_ar * (1 + noise * rng.standard_normal())))
    return out


def test_costfit_matches_reference():
    rng = np.random.default_rng(0)
    for noise in (0.0, 0.05):
        ts = _samples(TPR, np.random.default_rng(1), noise=noise)
        js = [JPR.CommSample(**dataclasses.asdict(s)) for s in ts]
        assert TF.per_message_points(ts) == JF.per_message_points(js)
        (ta, tb), (ja, jb) = TF.fit_alpha_beta(ts), JF.fit_alpha_beta(js)
        assert abs(ta - ja) <= 1e-12 * abs(ja)
        assert abs(tb - jb) <= 1e-12 * abs(jb)
        if noise == 0.0:      # the exact line comes back
            assert abs(ta - 7e-6) <= 1e-9 * 7e-6
            assert abs(tb - 1 / 90e9) <= 1e-9 / 90e9
        for hw in HWS.values():
            th, jh = _pair(hw)
            for a, b in ((ta, tb), (hw.alpha * 1.5, hw.beta)):
                assert TF.rel_drift(th, a, b) == JF.rel_drift(jh, a, b)
                assert TF.rel_drift(dataclasses.asdict(th), a, b) == \
                    JF.rel_drift(dataclasses.asdict(jh), a, b)
    assert TF.rel_drift({"name": "static"}, 1.0, 1.0) == 0.0
    with pytest.raises(ValueError, match=">=2"):
        TF.fit_alpha_beta(_samples(TPR, rng)[:1])
    with pytest.raises(ValueError, match="kind"):
        TF.per_message_points([TPR.CommSample("bcast", 4.0, 4, 1.0)])
    # samples at one worker carry no wire time: skipped
    assert TF.per_message_points([TPR.CommSample("allgather", 4.0, 1,
                                                 1.0)]) == []


def _profiles(comm: bool):
    """The same ModelProfile in both packages (measured-like numbers)."""
    leaves = TPR.apportion_backward(
        TPR.backprop_leaves(tcfg.smoke_config(), 512.0), 0.05)
    ts = _samples(TPR, np.random.default_rng(2), noise=0.02) if comm else []
    tprof = TPR.ModelProfile(
        arch="tinyllama", shape="s", n_workers=4, mesh_shape=(4,),
        tokens_per_worker=512.0, leaves=leaves, comm_samples=tuple(ts),
        t_step_dense=0.075, t_step_lags=0.08, flops_per_step=3.1e12)
    return tprof, JPR.ModelProfile.from_json(tprof.to_json())


@pytest.mark.parametrize("comm", [True, False])
def test_fit_hardware_matches_reference(comm):
    tprof, jprof = _profiles(comm)
    assert jprof.to_json() == tprof.to_json()
    assert TPR.ModelProfile.from_json(jprof.to_json()) == tprof
    for base in HWS.values():
        tb, jb = _pair(base)
        th = TF.fit_hardware(tprof, base=tb, name="fit")
        jh = JF.fit_hardware(jprof, base=jb, name="fit")
        for f in ("alpha", "beta", "flops", "hbm_bw"):
            t, j = getattr(th, f), getattr(jh, f)
            assert abs(t - j) <= 1e-12 * abs(j), f
        if not comm:        # no wire samples: the base's wire
            assert (th.alpha, th.beta) == (tb.alpha, tb.beta)
        assert th.hbm_bw == tb.hbm_bw         # no byte count: the base's
        assert th.flops == tprof.flops_per_step / tprof.t_step_dense
        hyb_t = TF.hybrid_hardware(tprof, tb)
        hyb_j = JF.hybrid_hardware(jprof, jb)
        assert hyb_t.name == hyb_j.name and hyb_t.flops == tb.flops
        assert abs(hyb_t.alpha - hyb_j.alpha) <= 1e-12 * hyb_j.alpha


def _leaf_lists(full: bool):
    """TinyLlama-1.1B's backprop-ordered leaves in both packages."""
    tc = tcfg.CONFIG if full else tcfg.smoke_config()
    jc = jcfg.CONFIG if full else jcfg.smoke_config()
    return (TPR.backprop_leaves(tc, 1024.0), JPR.backprop_leaves(jc, 1024.0),
            tc, jc)


@pytest.mark.parametrize("full", [False, True])
def test_backprop_leaves_match_reference(full):
    tl, jl, _, _ = _leaf_lists(full)
    assert [dataclasses.astuple(x) for x in tl] == \
        [dataclasses.astuple(x) for x in jl]
    assert len(tl) == 12
    ta = TPR.apportion_backward(tl, 0.3)
    ja = JPR.apportion_backward(jl, 0.3)
    assert [x.t_backward for x in ta] == [x.t_backward for x in ja]


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("hw", list(HWS))
def test_plan_schedule_same_json(full, hw):
    """Analytic budgets (t_backward 0: FLOPs at 45% of peak) and budgets
    apportioned from a measured total, P ∈ {1, 2, 4, 16}, cap 1000 and
    64: the same Schedule JSON, and the same predicted iteration."""
    tl, jl, _, _ = _leaf_lists(full)
    th, jh = _pair(HWS[hw])
    for total in (0.0, 0.02, 0.3):
        tls = TPR.apportion_backward(tl, total) if total else tl
        jls = JPR.apportion_backward(jl, total) if total else jl
        for p in PS:
            for cu in (1000.0, 64.0):
                ts = TP.plan_schedule(tls, p, th, arch="tl", shape="s",
                                      c_upper=cu)
                js = JP.plan_schedule(jls, p, jh, arch="tl", shape="s",
                                      c_upper=cu)
                assert ts.to_json() == js.to_json()
                assert TP.predict_iteration(tls, ts, p, th, 0.01) == \
                    JP.predict_iteration(jls, js, p, jh, 0.01)
    for leaf in tl:
        for c in CS:
            assert TP.leaf_comm_time(leaf.d, c, 4, th) == \
                JP.leaf_comm_time(leaf.d, c, 4, jh)
        for b in (0.0, 1e-5, 1e-3):
            assert TP.plan_leaf(leaf.d, b, 4, th) == \
                JP.plan_leaf(leaf.d, b, 4, jh)


def test_plan_leaf_dense_fallback():
    """When nothing hides and sparse loses to the dense all-reduce, the
    leaf plans dense (both packages)."""
    slow_sel = TCM.Hardware("x", alpha=1e-6, beta=1 / 100e9, flops=1e12,
                            hbm_bw=1e6)
    jslow = JCM.Hardware(**dataclasses.asdict(slow_sel))
    assert TP.plan_leaf(10**6, 0.0, 4, slow_sel) == 1.0
    assert JP.plan_leaf(10**6, 0.0, 4, jslow) == 1.0
    th, _ = _pair(JCM.ETH_1GBPS)
    assert TP.plan_leaf(10**6, 0.0, 4, th) == 1000.0


@pytest.mark.parametrize("full", [False, True])
def test_plan_hier_schedule_same_json(full):
    tl, jl, _, _ = _leaf_lists(full)
    tl = TPR.apportion_backward(tl, 0.2)
    jl = JPR.apportion_backward(jl, 0.2)
    tin, jin = _pair(TCM.H100_NVLINK)
    tout, jout = _pair(JCM.ETH_1GBPS)
    for p_in, p_out in ((2, 2), (4, 1), (8, 4)):
        for mode in ("lags_hier", "lags_hier2"):
            ts = TH.plan_hier_schedule(tl, p_inner=p_in, p_outer=p_out,
                                       hw_inner=tin, hw_outer=tout,
                                       arch="tl", shape="s", train_mode=mode)
            js = JH.plan_hier_schedule(jl, p_inner=p_in, p_outer=p_out,
                                       hw_inner=jin, hw_outer=jout,
                                       arch="tl", shape="s", train_mode=mode)
            assert ts.to_json() == js.to_json()
            for inner in (True, False):
                kw = dict(p_inner=p_in, p_outer=p_out, t_forward=0.05)
                assert TH.predict_hier_iteration(
                    tl, ts.inner if inner else None, ts.outer,
                    hw_inner=tin, hw_outer=tout, **kw) == \
                    JH.predict_hier_iteration(
                        jl, js.inner if inner else None, js.outer,
                        hw_inner=jin, hw_outer=jout, **kw)
    samples = _samples(TPR, np.random.default_rng(3))
    jsamples = [JPR.CommSample(**dataclasses.asdict(s)) for s in samples]
    for got, want in ((TH.tier_hardware(samples, tin, "ici"),
                       JH.tier_hardware(jsamples, jin, "ici")),
                      (TH.tier_hardware([], tin, "ici"),
                       JH.tier_hardware([], jin, "ici"))):
        assert got.name == want.name and got.flops == want.flops
        assert abs(got.alpha - want.alpha) <= 1e-12 * want.alpha
        assert abs(got.beta - want.beta) <= 1e-12 * want.beta


def _params_like(full: bool):
    tc = tcfg.CONFIG if full else tcfg.smoke_config()
    jc = jcfg.CONFIG if full else jcfg.smoke_config()
    return TT.abstract_params(tc), JTR.model_shapes_and_axes(jc)[0]


def _plans():
    """A flat plan with mixed ratios and a two-tier plan, both packages."""
    tl, jl, _, _ = _leaf_lists(False)
    tl = TPR.apportion_backward(tl, 0.01)
    jl = JPR.apportion_backward(jl, 0.01)
    th, jh = _pair(JCM.ETH_1GBPS)
    flat = (TP.plan_schedule(tl, 4, th, arch="tl", shape="s"),
            JP.plan_schedule(jl, 4, jh, arch="tl", shape="s"))
    hier = (TH.plan_hier_schedule(tl, p_inner=2, p_outer=2, hw_inner=th,
                                  hw_outer=th, arch="tl", shape="s",
                                  train_mode="lags_hier2"),
            JH.plan_hier_schedule(jl, p_inner=2, p_outer=2, hw_inner=jh,
                                  hw_outer=jh, arch="tl", shape="s",
                                  train_mode="lags_hier2"))
    return flat, hier


def test_schedules_cross_load_with_equal_ks():
    """Written by either package, loaded by the other: the same object,
    the same per-leaf k's leaf for leaf (flat v2, v1 documents, and the
    two-tier schedule), through load_any and the files too."""
    (tflat, jflat), (thier, jhier) = _plans()
    assert {1.0, 1000.0} < {lp.ratio for lp in tflat.leaves}
    tp, jp = _params_like(False)
    for tsched, jsched in ((tflat, jflat), (thier, jhier)):
        from_j = TS.schedule_from_json(jsched.to_json())
        from_t = JS.schedule_from_json(tsched.to_json())
        assert from_j == tsched
        assert from_t.to_json() == jsched.to_json()
        assert tree.leaves(from_j.ks_tree(tp)) == \
            [int(k) for k in __import__("jax").tree.leaves(
                jsched.ks_tree(jp))]
        assert tree.leaves(tsched.ratios_tree(tp)) == \
            __import__("jax").tree.leaves(from_t.ratios_tree(jp))
    # a v1 document (no train_mode) loads as lags_dp in both
    v1 = json.loads(jflat.to_json())
    v1["version"] = 1
    v1.pop("train_mode")
    for mod in (TS, JS):
        s = mod.Schedule.from_json(json.dumps(v1))
        assert s.train_mode == "lags_dp" and s.version == 2
    assert TS.Schedule.from_json(json.dumps(v1)).to_json() == \
        JS.Schedule.from_json(json.dumps(v1)).to_json()
    for bad, mod in ((thier.to_json(), TS.Schedule),
                     (tflat.to_json(), TS.HierSchedule)):
        with pytest.raises(ValueError):
            mod.from_json(bad)
    with pytest.raises(ValueError, match="version"):
        TS.Schedule.from_json(json.dumps(dict(v1, version=7)))


def test_schedule_files_cache_path_and_summary(tmp_path):
    (tflat, jflat), (thier, _) = _plans()
    path = tflat.save(str(tmp_path / "a" / "flat.json"))
    assert JS.Schedule.load(path).to_json() == jflat.to_json()
    assert TS.load_any(path) == tflat
    hp = thier.save(str(tmp_path / "hier.json"))
    assert TS.load_any(hp) == thier == TS.HierSchedule.load(hp)
    assert JS.load_any(hp).to_json() == thier.to_json()
    for args in (("r", "tl", "s", 4, "h100"),
                 ("r", "tl", "s", 4, "h100", "lags_hier2", 2)):
        assert TS.cache_path(*args) == JS.cache_path(*args)
    assert TS.summarize(tflat) == JS.summarize(jflat)
    assert thier.n_tiers == 2 and thier.ks_tree(_params_like(False)[0]) \
        == thier.outer.ks_tree(_params_like(False)[0])
    drift = TS.Schedule.hardware_drift(tflat, 2 * tflat.hardware["alpha"],
                                       tflat.hardware["beta"])
    assert drift == JS.Schedule.hardware_drift(
        jflat, 2 * jflat.hardware["alpha"], jflat.hardware["beta"]) == 1.0
    with pytest.raises(ValueError, match="different leaves"):
        TS.HierSchedule(arch="x", shape="y", inner=thier.inner,
                        outer=dataclasses.replace(
                            thier.outer, leaves=thier.outer.leaves[1:]))


def _outcome(mod, sched, mode, n, params_like=None):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            mod.validate_for(sched, mode, n_workers=n,
                             params_like=params_like)
        except ValueError:
            return "raise"
    return "warn" if caught else "ok"


class _DuckSchedule:
    def ks_tree(self, params_like):
        return None


def test_validate_for_matrix_matches_reference():
    """Which (schedule kind, mode, worker count) combinations raise,
    warn or pass — the same in both packages, and as the reference's
    contract says."""
    (tflat, jflat), (thier, jhier) = _plans()
    tp, jp = _params_like(False)
    tflat_h = dataclasses.replace(tflat, train_mode="lags_hier")
    jflat_h = dataclasses.replace(jflat, train_mode="lags_hier")
    cases = [
        # (port sched, ref sched, mode, n_workers, expected)
        (tflat, jflat, "lags_dp", 4, "ok"),
        (tflat, jflat, "lags_dp", 2, "warn"),
        (tflat, jflat, "slgs", 4, "ok"),
        (tflat, jflat, "lags_hier", 4, "raise"),
        (tflat, jflat, "lags_hier2", 4, "raise"),
        (tflat, jflat, "lags_dp", None, "ok"),
        (tflat_h, jflat_h, "lags_dp", 4, "raise"),
        (tflat_h, jflat_h, "lags_hier", 4, "ok"),
        (thier, jhier, "lags_dp", 4, "raise"),
        (thier, jhier, "lags_hier", 2, "ok"),
        (thier, jhier, "lags_hier", 4, "warn"),
        (thier, jhier, "lags_hier2", 4, "ok"),
        (thier, jhier, "lags_hier2", 8, "warn"),
        (thier.inner, jhier.inner, "lags_hier2", 99, "ok"),
        (thier.inner, jhier.inner, "lags_hier", 2, "raise"),
        (thier.inner, jhier.inner, "lags_dp", 2, "raise"),
        (None, None, "lags_dp", 4, "ok"),
        (_DuckSchedule(), _DuckSchedule(), "lags_dp", 4, "ok"),
    ]
    for ts, js, mode, n, want in cases:
        got_t, got_j = _outcome(TS, ts, mode, n), _outcome(JS, js, mode, n)
        assert (got_t, got_j) == (want, want), (mode, n, want)
    # the leaf structure is checked when params_like is given
    small = {"a": torch.zeros(3)}
    assert _outcome(TS, tflat, "lags_dp", 4, small) == "raise"
    assert _outcome(TS, tflat, "lags_dp", 4, tp) == "ok"
    assert _outcome(JS, jflat, "lags_dp", 4, jp) == "ok"
    bad = dataclasses.replace(tflat, leaves=(dataclasses.replace(
        tflat.leaves[0], d=tflat.leaves[0].d + 1),) + tflat.leaves[1:])
    with pytest.raises(ValueError, match="params"):
        bad.validate(tp)
    with pytest.raises(ValueError):
        TS.LeafPlan("x", d=4, ratio=0.5, k=8)


@pytest.mark.parametrize("granularity", ["leaf", "model"])
@pytest.mark.parametrize("pipeline", ["wave", "async1", "off"])
def test_plan_waves_same_json(granularity, pipeline):
    tl, jl, tc, jc = _leaf_lists(False)
    tl = TPR.apportion_backward(tl, 0.01)
    jl = JPR.apportion_backward(jl, 0.01)
    (tflat, jflat), _ = _plans()
    th, jh = _pair(TCM.H100_NVLINK)
    names = tree.leaf_paths(TT.abstract_params(tc))
    for sched_t, sched_j in ((tflat, jflat), (None, None)):
        for target in (None, 4096):
            kw = dict(t_forward=0.002, pipeline=pipeline,
                      granularity=granularity, target_bytes=target)
            tw = TW.plan_waves(tl, sched_t, 4, th, flat_names=names, **kw)
            jw = JW.plan_waves(jl, sched_j, 4, jh, flat_names=names, **kw)
            assert tw.to_json() == jw.to_json()
            assert TW.plan_waves(tl, sched_t, 4, th, **kw).to_json() == \
                JW.plan_waves(jl, sched_j, 4, jh, **kw).to_json()
            if granularity == "model":
                assert tw.n_waves == 1


def test_error_feedback_matches_reference():
    """Algorithm 1 lines 7–8 on a tree: zero residuals shaped like the
    parameters, acc = e + lr·g, eps = acc - TopK(acc), bitwise."""
    import jax.numpy as jnp
    from repro.core import error_feedback as JEF
    from repro_torch.core import compressors as TC
    from repro_torch.core import error_feedback as TEF
    rng = np.random.default_rng(5)
    g = {"a": rng.standard_normal((3, 40)).astype(np.float32),
         "b": [rng.standard_normal(7).astype(np.float32)]}
    tg = tree.map(torch.from_numpy, g)
    jg = {"a": jnp.asarray(g["a"]), "b": [jnp.asarray(g["b"][0])]}
    te, je = TEF.init_residuals(tg), JEF.init_residuals(jg)
    assert [tuple(x.shape) for x in tree.leaves(te)] == [(3, 40), (7,)]
    assert not any(x.any() for x in tree.leaves(te))
    for _ in range(2):
        tacc = TEF.accumulate(te, tg, 0.3)
        jacc = JEF.accumulate(je, jg, 0.3)
        tsel = tree.map(lambda x: TC.topk_dense(x.reshape(-1), 5).reshape(
            x.shape), tacc)
        jsel = {"a": jnp.asarray(tsel["a"].numpy()),
                "b": [jnp.asarray(tsel["b"][0].numpy())]}
        te, je = TEF.split(tacc, tsel), JEF.split(jacc, jsel)
        for t, j in zip(tree.leaves(te), [je["a"], je["b"][0]]):
            np.testing.assert_array_equal(t.numpy().view(np.int32),
                                          np.asarray(j).view(np.int32))


def test_profile_model_trace_raises_naming_item_12():
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 12"):
        TPR.profile_model(tcfg.smoke_config(), None, trace=object())


def test_autotune_and_runtime_exports_match_reference():
    import repro.autotune as JAT
    import repro_torch.autotune as TAT
    import repro_torch.runtime as TRT
    assert TAT.__all__ == JAT.__all__
    assert TRT.__all__ == ["plan_hier_schedule", "predict_hier_iteration",
                           "tier_hardware"]
    assert TS.SCHEDULE_VERSION == JS.SCHEDULE_VERSION
    assert TS.HIER_MODES == JS.HIER_MODES
