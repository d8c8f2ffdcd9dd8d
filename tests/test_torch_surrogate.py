"""The port's learned cost model (``repro_torch.surrogate``) and grid
pruning against the JAX package's, on the CPU.

The same inputs, made from seeds, go through both packages:

* the featurizer bitwise (float64) over ``dataset.generate(400, seed=0)``
  with each site's whole action grid;
* ``parse_key``/``build_corpus`` on a DB file the reference's
  ``MeasureDB`` wrote: the same sites, tiles, targets and backends;
* a reference-trained model carried by ``convert.surrogate_from_jax``
  predicts within atol 1e-5 in log-seconds; checkpoints load both ways
  and a tampered one is refused by both;
* training from the same carried initial weights on the same corpus:
  f32 drift grows over the steps (about 1e-2 on normalized predictions
  after 500), so 50 steps are held at 1e-4 and 500 at a per-site
  Spearman >= 0.99 over each site's grid;
* ``SurrogateOracle`` against the reference's under ``legality="tpu_v5e"``
  (rtol 1e-5, the same ``inf`` pattern); under ``"h100"`` ``inf`` falls
  exactly where ``ops.tile_ok`` refuses;
* the reference's pruning tests (``tests/test_surrogate.py:170-215``) on
  the port; with the same carried model and a spy hook the submitted
  ``(site, tile)`` keys equal the reference's; under ``"h100"`` the port
  times ``min(k, legal)`` pairs a site and the baseline; no surrogate-
  priced value reaches the timing DB;
* the facade (``oracle="surrogate"``; ``oracle="measured",
  prune_topk=2``) tunes like the reference's, serve ``--prune-topk``
  prints the reference's state line, and the Prometheus series are
  ``repro.obs``'s.
"""
import dataclasses
import zlib

import numpy as np
import pytest
import torch

from repro.artifacts.agentio import ArtifactError as JArtifactError
from repro.configs.neurovec import DEFAULT as JDEFAULT
from repro.configs.neurovec import NeuroVecConfig as JNeuroVecConfig
from repro.core import costmodel_vec as jcv
from repro.core import dataset as jds
from repro.core.env import ActionSpace as JActionSpace
from repro.core.env import MeasuredEnv as JMeasuredEnv
from repro.measure import MeasureDB as JMeasureDB
from repro.measure import make_key as jmake_key
from repro.models.compute import KernelSite as JKernelSite
from repro.surrogate import SurrogateOracle as JSurrogateOracle
from repro.surrogate import build_corpus as jbuild_corpus
from repro.surrogate import featurize as jfeaturize
from repro.surrogate import load_surrogate as jload_surrogate
from repro.surrogate import model as jmodel
from repro.surrogate import parse_key as jparse_key
from repro.surrogate import save_surrogate as jsave_surrogate
from repro.surrogate import train_from_db as jtrain_from_db
from repro_torch import convert
from repro_torch.artifacts import ArtifactError
from repro_torch.configs.neurovec import DEFAULT, NeuroVecConfig
from repro_torch.core import costmodel_vec, dataset
from repro_torch.core.env import ActionSpace, CostModelEnv, MeasuredEnv
from repro_torch.kernels import ops
from repro_torch.measure import (CachedMeasureFn, InProcessTransport,
                                 MeasureDB, make_key, make_measured_env)
from repro_torch.models.site import KernelSite
from repro_torch.surrogate import (N_FEATURES, SurrogateOracle, build_corpus,
                                   featurize, load_surrogate, parse_key,
                                   save_surrogate, train_from_db,
                                   train_surrogate)
from repro_torch.surrogate import model as tmodel

# the reference test's grid: the baseline matmul tile of MM (32, 128, 128)
# is not in bm_choices, so a pruned grid times exactly top-k pairs
KW = dict(bm_choices=(4, 8, 16), bn_choices=(128,), bk_choices=(128,),
          bq_choices=(64,), bkv_choices=(128,), chunk_choices=(32,))
CFG, JCFG = NeuroVecConfig(**KW), JNeuroVecConfig(**KW)
CPU = {"device": "cpu"}

MM = KernelSite(site="t.mm", kind="matmul", m=32, n=128, k=128)
ATTN = KernelSite(site="t.attn", kind="attention", m=64, n=32, k=64,
                  batch=2, causal=True)
SCAN = KernelSite(site="t.scan", kind="chunk_scan", m=32, n=16, k=8,
                  batch=2)
FIXTURE_SITES = [KernelSite(site=f"f.mm{i}", kind="matmul",
                            m=32 * (1 + i % 2), n=128, k=128)
                 for i in range(4)] + [ATTN, SCAN]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small CPU tensors: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j(s) -> JKernelSite:
    return JKernelSite(**{f.name: getattr(s, f.name)
                          for f in dataclasses.fields(KernelSite)})


def _t(s) -> KernelSite:
    return KernelSite(**{f.name: getattr(s, f.name)
                         for f in dataclasses.fields(JKernelSite)})


def _fixture_db(path, backend="fix"):
    """A warm DB written by the reference's MeasureDB: timings with real
    variance, plus one failed and one foreign-backend record (the
    reference test's fixture)."""
    db = JMeasureDB(str(path))
    for s in FIXTURE_SITES:
        if s.kind != "matmul":
            continue
        for t0 in (4, 8, 16):
            db.put(jmake_key(s.key(), (t0, 128, 128), backend),
                   1e-3 * (1 + t0) * (1 + s.m / 64))
    db.put(jmake_key(ATTN.key(), (64, 128, 1), backend), 2e-3)
    db.put(jmake_key(SCAN.key(), (32, 1, 1), backend), 3e-3)
    db.put(jmake_key(MM.key(), (8, 128, 128), backend), float("inf"))
    db.put(jmake_key(MM.key(), (16, 128, 128), "other-backend"), 9e-3)
    db.close()
    return str(path)


def fake_seconds(site_key, tiles) -> float:
    h = zlib.crc32(f"{site_key}|{tuple(int(t) for t in tiles)}".encode())
    return 1e-5 * (1 + h % 997)


class Spy:
    """A measure hook keeping every submitted ``(site key, tiles)``."""
    backend_key = "spy"

    def __init__(self):
        self.keys = []

    @property
    def pairs(self):
        return len(self.keys)

    def __call__(self, sites, tiles):
        out = []
        for s, t in zip(sites, np.asarray(tiles)):
            self.keys.append((s.key(), tuple(int(x) for x in t)))
            out.append(fake_seconds(s.key(), t))
        return np.array(out, np.float64)


@pytest.fixture(scope="module")
def ref_model(tmp_path_factory):
    """A reference-trained surrogate on the fixture DB."""
    p = _fixture_db(tmp_path_factory.mktemp("ref") / "m.jsonl")
    return jtrain_from_db(p, hidden=(16, 16), ensemble=2, steps=80)


@pytest.fixture(scope="module")
def carried(ref_model):
    return convert.surrogate_from_jax(ref_model.state_dict(), **CPU)


# ---------------------------------------------------------------------------
# featurizer and corpus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["matmul", "attention", "chunk_scan"])
def test_featurize_bitwise_over_the_corpus_grids(kind):
    sites = [s for s in dataset.generate(400, seed=0) if s.kind == kind]
    jsites = [s for s in jds.generate(400, seed=0) if s.kind == kind]
    assert [s.key() for s in sites] == [s.key() for s in jsites] and sites
    grid = costmodel_vec.action_tiles_grid(ActionSpace(DEFAULT), kind)
    assert np.array_equal(grid, jcv.action_tiles_grid(JActionSpace(JDEFAULT),
                                                      kind))
    rep = [s for s in sites for _ in range(len(grid))]
    jrep = [s for s in jsites for _ in range(len(grid))]
    tiles = np.tile(grid, (len(sites), 1))
    X, JX = featurize(rep, tiles), jfeaturize(jrep, tiles)
    assert X.shape == (len(rep), N_FEATURES) and X.dtype == np.float64
    assert np.array_equal(X, JX)
    assert np.isfinite(X).all()


def test_corpus_from_a_reference_db_matches(tmp_path):
    p = _fixture_db(tmp_path / "m.jsonl")
    for backend in (None, "fix"):
        got, want = build_corpus(p, backend=backend), \
            jbuild_corpus(p, backend=backend)
        assert [s.key() for s in got.sites] == [s.key() for s in want.sites]
        assert np.array_equal(got.tiles, want.tiles)
        assert np.array_equal(got.y, want.y) and got.y.dtype == np.float64
        assert got.backends == want.backends
    # finite records only, and the foreign backend filtered
    assert len(build_corpus(p).sites) == 15
    assert set(build_corpus(p, backend="fix").backends) == {"fix"}
    # an open port MeasureDB gives the same corpus
    assert np.array_equal(build_corpus(MeasureDB(p)).y, build_corpus(p).y)


def test_parse_key_matches_reference():
    for s in (MM, ATTN, SCAN, KernelSite(site="a:b|c.d", kind="matmul",
                                         m=8, n=16, k=32, dtype="float32",
                                         transpose="nt", fused_ops=2)):
        key = make_key(s.key(), (8, 128, 1), "be|x")
        got, want = parse_key(key), jparse_key(key)
        assert got[0] == _t(want[0]) and got[0].key() == s.key()
        assert got[1:] == want[1:] == ((8, 128, 1), "be|x")
    for bad in ("malformed-key|1x2x3|b", "no pipes at all"):
        assert parse_key(bad) is None and jparse_key(bad) is None


# ---------------------------------------------------------------------------
# the model: carried weights, checkpoints, training
# ---------------------------------------------------------------------------

def _probe():
    sites = dataset.generate(40, seed=3)
    rng = np.random.default_rng(0)
    tiles = []
    for s in sites:
        g = costmodel_vec.action_tiles_grid(ActionSpace(DEFAULT), s.kind)
        tiles.append(g[rng.integers(len(g))])
    return sites, np.array(tiles)


def test_carried_model_predicts_like_the_reference(ref_model, carried):
    sites, tiles = _probe()
    X = featurize(sites, tiles)
    got = carried.predict_log_seconds(X)
    want = ref_model.predict_log_seconds(X)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert carried.ensemble == ref_model.ensemble == 2
    assert (carried.backend, carried.hidden) == ("fix", (16, 16))
    # priced under the reference's VMEM rule: the same inf pattern
    sec = carried.predict_seconds(sites, tiles, legality="tpu_v5e")
    jsec = ref_model.predict_seconds([_j(s) for s in sites], tiles)
    assert np.array_equal(np.isinf(sec), np.isinf(jsec))
    np.testing.assert_allclose(sec[np.isfinite(sec)],
                               jsec[np.isfinite(jsec)], rtol=1e-4)
    # the state round-trips to the reference's numbers
    st, jst = carried.state_dict(), ref_model.state_dict()
    for m, jm in zip(st["params"], jst["params"]):
        for l, jl in zip(m, jm):
            assert np.array_equal(l["w"], jl["w"])
            assert np.array_equal(l["b"], jl["b"])


def _tamper(directory):
    npz = directory / "state.npz"
    arrays = dict(np.load(str(npz)))
    key = sorted(arrays)[0]
    arrays[key] = arrays[key] + 1.0
    np.savez(str(npz), **arrays)


@pytest.mark.parametrize("way", ["reference_to_port", "port_to_reference"])
def test_checkpoints_load_both_ways_and_tampering_is_refused(
        way, ref_model, carried, tmp_path):
    sites, tiles = _probe()
    X = featurize(sites, tiles)
    art = tmp_path / "ck"
    if way == "reference_to_port":
        jsave_surrogate(ref_model, str(art))
        loaded = load_surrogate(str(art), **CPU)
        np.testing.assert_allclose(loaded.predict_log_seconds(X),
                                   ref_model.predict_log_seconds(X),
                                   atol=1e-5, rtol=0)
    else:
        save_surrogate(carried, str(art))
        loaded = jload_surrogate(str(art))
        np.testing.assert_allclose(loaded.predict_log_seconds(X),
                                   carried.predict_log_seconds(X),
                                   atol=1e-5, rtol=0)
    assert loaded.backend == "fix"
    _tamper(art)
    with pytest.raises(ArtifactError, match="fingerprint"):
        load_surrogate(str(art), **CPU)
    with pytest.raises(JArtifactError, match="fingerprint"):
        jload_surrogate(str(art))


def test_from_state_refuses_other_artifacts(carried):
    st = carried.state_dict()
    with pytest.raises(ArtifactError, match="not a surrogate"):
        tmodel.SurrogateModel.from_state({**st, "name": "ppo"}, **CPU)
    with pytest.raises(ArtifactError, match="version"):
        tmodel.SurrogateModel.from_state({**st, "version": 99}, **CPU)
    with pytest.raises(ArtifactError, match="shapes"):
        tmodel.SurrogateModel.from_state({**st, "hidden": [8, 16]}, **CPU)


def _training_corpus():
    """Pairs of 30 corpus sites (8 tiles each) with noisy analytic
    targets: a corpus with real variance, normalized as train_surrogate
    normalizes it."""
    jsites = jds.generate(30, seed=1)
    rng = np.random.default_rng(0)
    S, T = [], []
    for s in jsites:
        g = jcv.action_tiles_grid(JActionSpace(JDEFAULT), s.kind)
        for i in rng.choice(len(g), size=min(8, len(g)), replace=False):
            S.append(s)
            T.append(g[i])
    T = np.array(T)
    y = np.log(jcv.costs_for_tiles(S, T))
    ok = np.isfinite(y)
    S, T, y = [s for s, k in zip(S, ok) if k], T[ok], y[ok]
    y = y + rng.normal(0, 0.3, len(y))
    X = jfeaturize(S, T)
    x_std = np.where(X.std(0) < 1e-8, 1.0, X.std(0))
    return (X - X.mean(0)) / x_std, (y - y.mean()) / y.std(), \
        X.mean(0), x_std, jsites


def _train_both(steps):
    import jax
    import jax.numpy as jnp
    Xn, yn, _, _, _ = _training_corpus()
    p0 = jmodel._init_member(jax.random.PRNGKey(3), Xn.shape[1], (64, 64))
    init = jax.tree.map(np.asarray, p0)
    pj, lj = jmodel._train_member_jit(p0, jnp.asarray(Xn, jnp.float32),
                                      jnp.asarray(yn, jnp.float32), steps,
                                      1e-2)
    member = tmodel.Member.from_tree(init, "cpu")
    lt = tmodel._train_member(member, torch.tensor(Xn, dtype=torch.float32),
                              torch.tensor(yn, dtype=torch.float32), steps,
                              1e-2)
    return pj, np.asarray(lj), member, lt.numpy()


def _spearman(a, b):
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    ra, rb = ra - ra.mean(), rb - rb.mean()
    return float((ra * rb).sum() / np.sqrt((ra ** 2).sum() * (rb ** 2).sum()))


def test_training_from_carried_weights_agrees_for_50_steps():
    import jax.numpy as jnp
    pj, lj, member, lt = _train_both(50)
    Xn = _training_corpus()[0]
    with torch.no_grad():
        got = member(torch.tensor(Xn, dtype=torch.float32)).numpy()
    want = np.asarray(jmodel._forward(pj, jnp.asarray(Xn, jnp.float32)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-4)


def test_training_from_carried_weights_ranks_alike_after_500_steps():
    """500 steps: the per-site ranking of each site's grid agrees
    (Spearman >= 0.99 at every site)."""
    import jax.numpy as jnp
    pj, lj, member, lt = _train_both(500)
    _, _, x_mean, x_std, jsites = _training_corpus()
    assert lt[-1] < 0.5 * lt[0] and abs(lt[-1] - lj[-1]) < 1e-2
    for s in jsites:
        g = jcv.action_tiles_grid(JActionSpace(JDEFAULT), s.kind)
        Xn = (jfeaturize([s] * len(g), g) - x_mean) / x_std
        with torch.no_grad():
            got = member(torch.tensor(Xn, dtype=torch.float32)).numpy()
        want = np.asarray(jmodel._forward(pj, jnp.asarray(Xn, jnp.float32)))
        assert _spearman(got, want) >= 0.99, s.key()


def test_train_surrogate_and_train_from_db_on_the_cpu(tmp_path):
    p = _fixture_db(tmp_path / "m.jsonl")
    corpus = build_corpus(p, backend="fix")
    model = train_surrogate(corpus, hidden=(16,), ensemble=2, steps=60,
                            seed=0, backend="fix", **CPU)
    pred = model.predict_seconds(list(corpus.sites), corpus.tiles,
                                 legality="tpu_v5e")
    assert pred.shape == (len(corpus.sites),)
    assert np.isfinite(pred).all() and (pred > 0).all()
    # the ranking of the noiseless training corpus (the reference's check)
    mm = [i for i, s in enumerate(corpus.sites)
          if s.kind == "matmul" and s.m == 32]
    assert list(np.argsort(pred[mm])) == list(np.argsort(corpus.y[mm]))
    # the same seed gives the same model; the initial weights come from a
    # CPU generator, whatever the device
    again = train_surrogate(corpus, hidden=(16,), ensemble=2, steps=60,
                            seed=0, backend="fix", **CPU)
    assert np.array_equal(again.predict_seconds(list(corpus.sites),
                                                corpus.tiles), pred)
    # a cold DB trains nothing; the most common backend is taken
    cold = str(tmp_path / "cold.jsonl")
    db = MeasureDB(cold)
    db.put(make_key(MM.key(), (8, 128, 128), "b"), 1e-3)
    db.close()
    assert train_from_db(cold, **CPU) is None
    assert train_from_db(None, **CPU) is None
    warm = train_from_db(p, hidden=(16,), ensemble=2, steps=30, **CPU)
    assert warm is not None and warm.backend == "fix"
    with pytest.raises(ValueError, match="empty corpus"):
        train_surrogate(build_corpus(cold, backend="none"), **CPU)


def test_surrogate_needs_the_card_unless_cpu_is_asked(monkeypatch, carried,
                                                      tmp_path):
    corpus = build_corpus(_fixture_db(tmp_path / "m.jsonl"))
    art = str(tmp_path / "ck")
    save_surrogate(carried, art)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.surrogate_from_jax(carried.state_dict())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_surrogate(corpus, steps=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_surrogate(art)


# ---------------------------------------------------------------------------
# the oracle
# ---------------------------------------------------------------------------

def test_surrogate_oracle_matches_reference_under_tpu_rule(ref_model,
                                                          carried):
    sites = dataset.generate(60, seed=4)
    jsites = jds.generate(60, seed=4)
    port = SurrogateOracle(DEFAULT, carried, legality="tpu_v5e")
    ref = JSurrogateOracle(JDEFAULT, ref_model)
    g, jg = port.cost_grid(sites), ref.cost_grid(jsites)
    assert np.array_equal(np.isinf(g), np.isinf(jg))
    np.testing.assert_allclose(g[np.isfinite(g)], jg[np.isfinite(jg)],
                               rtol=1e-5)
    b, jb = port.baseline_costs(sites), ref.baseline_costs(jsites)
    assert np.array_equal(np.isinf(b), np.isinf(jb))
    np.testing.assert_allclose(b[np.isfinite(b)], jb[np.isfinite(jb)],
                               rtol=1e-5)
    acts = np.stack([np.random.default_rng(1).integers(0, 7, 60),
                     np.random.default_rng(2).integers(0, 3, 60),
                     np.random.default_rng(3).integers(0, 6, 60)], 1)
    c, jc = port.costs_batch(sites, acts), ref.costs_batch(jsites, acts)
    assert np.array_equal(np.isinf(c), np.isinf(jc))
    np.testing.assert_allclose(c[np.isfinite(c)], jc[np.isfinite(jc)],
                               rtol=1e-5)
    r, jr = port.rewards_batch(sites, acts), ref.rewards_batch(jsites, acts)
    np.testing.assert_allclose(r, jr, rtol=1e-4, atol=1e-5)
    # a second sweep is served from the cache
    n = len(port._result_cache)
    port.cost_grid(sites)
    assert len(port._result_cache) == n


def test_surrogate_oracle_refuses_what_the_kernels_refuse(carried):
    """Under ``"h100"`` ``inf`` falls exactly where ``ops.tile_ok``
    refuses: the f32 sites of the corpus, head dims the rule refuses,
    tiles the kernels cannot launch."""
    sites = dataset.generate(60, seed=5)
    port = SurrogateOracle(DEFAULT, carried)
    assert port.legality == "h100"
    g = port.cost_grid(sites)
    space = ActionSpace(DEFAULT)
    for i, s in enumerate(sites):
        grid = costmodel_vec.action_tiles_grid(space, s.kind)
        ok = np.array([ops.tile_ok(s, tuple(int(x) for x in t))
                       for t in grid])
        assert np.array_equal(np.isfinite(g[i, :len(grid)]), ok), s.key()
        assert np.isinf(g[i, len(grid):]).all()
    assert np.isinf(g).any() and np.isfinite(g).any()


# ---------------------------------------------------------------------------
# grid pruning: the reference's three tests, then parity
# ---------------------------------------------------------------------------

def _port_fixture_model(tmp_path):
    return train_from_db(_fixture_db(tmp_path / "m.jsonl"), hidden=(16,),
                         ensemble=2, steps=60, **CPU)


def test_pruned_env_submits_exactly_topk(tmp_path):
    surrogate = _port_fixture_model(tmp_path)
    grid = costmodel_vec.action_tiles_grid(CostModelEnv(CFG).space,
                                           "matmul")
    n_legal = int(np.isfinite(
        costmodel_vec.costs_for_tiles([MM] * len(grid), grid)).sum())
    assert n_legal == 3                   # the fixture grid, sanity
    for topk in (1, 2):
        spy = Spy()
        env = MeasuredEnv(CFG, measure_fn=CachedMeasureFn(spy, db=None),
                          prune_topk=topk, surrogate=surrogate)
        assert env.prune_active
        costs = env.cost_grid([MM])[0]
        assert spy.pairs == topk
        assert env.pruned_pairs == n_legal - topk
        assert np.isfinite(costs[:n_legal]).all()
        # timed_tiles leaves the surrogate-priced pairs out
        assert len(env.timed_tiles(MM)) == topk
    spy = Spy()
    env = MeasuredEnv(CFG, measure_fn=CachedMeasureFn(spy, db=None))
    assert not env.prune_active
    env.cost_grid([MM])
    assert spy.pairs == n_legal


def test_pruned_env_baseline_always_measured(tmp_path):
    surrogate = _port_fixture_model(tmp_path)
    spy = Spy()
    env = MeasuredEnv(CFG, measure_fn=CachedMeasureFn(spy, db=None),
                      prune_topk=1, surrogate=surrogate)
    r = env.rewards_batch([ATTN, SCAN], np.array([[0, 0, 0], [0, 0, 0]]))
    assert r.shape == (2,) and np.isfinite(r).all()
    base = tuple(int(x) for x in
                 costmodel_vec.baseline_tiles_batch([ATTN])[0])
    assert base in env._allowed_tiles(ATTN)


def test_pruned_env_rejects_bad_topk():
    with pytest.raises(ValueError, match="prune_topk"):
        MeasuredEnv(CFG, prune_topk=0)


@pytest.mark.parametrize("topk", [1, 3])
def test_pruned_keys_equal_the_reference_under_tpu_rule(topk, ref_model,
                                                        carried):
    """The same carried model and a spy hook: the port submits exactly
    the reference's ``(site, tile)`` keys, in the same order, and prices
    the same pairs with the surrogate."""
    sites, jsites = dataset.generate(40, seed=2), jds.generate(40, seed=2)
    spy, jspy = Spy(), Spy()
    env = MeasuredEnv(DEFAULT, measure_fn=spy, legality="tpu_v5e",
                      prune_topk=topk, surrogate=carried)
    jenv = JMeasuredEnv(JDEFAULT, measure_fn=jspy, prune_topk=topk,
                        surrogate=ref_model)
    g, jg = env.cost_grid(sites), jenv.cost_grid(jsites)
    assert spy.keys == jspy.keys and spy.pairs > 0
    assert env.pruned_pairs == jenv.pruned_pairs > 0
    assert np.array_equal(np.isinf(g), np.isinf(jg))
    np.testing.assert_allclose(g[np.isfinite(g)], jg[np.isfinite(jg)],
                               rtol=1e-5)
    acts = np.zeros((40, 3), np.int64)
    np.testing.assert_allclose(env.rewards_batch(sites, acts),
                               jenv.rewards_batch(jsites, acts),
                               rtol=1e-4, atol=1e-5)
    assert spy.keys == jspy.keys


def test_pruned_env_under_h100_times_topk_legal_tiles(carried):
    """The port ranks the grid legal under its own rule: under ``"h100"``
    each site times ``min(k, legal)`` of the top-ranked tiles plus its
    baseline tile, all launchable; the reference's rule would have given
    slots to tiles the kernels cannot launch."""
    sites = [KernelSite("sl.q", "matmul", m=2048, n=2560, k=2560),
             KernelSite("sl.down", "matmul", m=4, n=2560, k=6912),
             KernelSite("sl.attn", "attention", m=512, n=80, k=512,
                        batch=128, causal=True),
             KernelSite("sl.scan", "chunk_scan", m=256, n=64, k=16,
                        batch=64),
             KernelSite("f32.attn", "attention", m=512, n=64, k=512,
                        batch=64, causal=True, dtype="float32")]
    k = 4
    spy = Spy()
    env = MeasuredEnv(DEFAULT, measure_fn=spy, prune_topk=k,
                      surrogate=carried)
    env.cost_grid(sites)
    space = ActionSpace(DEFAULT)
    lost = 0
    for s in sites:
        grid = costmodel_vec.action_tiles_grid(space, s.kind)
        legal = [tuple(int(x) for x in t) for t in grid
                 if ops.tile_ok(s, tuple(int(x) for x in t))]
        timed = [t for key, t in spy.keys if key == s.key()]
        assert len(set(timed)) == len(timed)
        assert all(ops.tile_ok(s, t) for t in timed)
        base = tuple(int(x) for x in
                     costmodel_vec.baseline_tiles_batch([s])[0])
        pred = carried.predict_seconds([s] * len(legal), legal)
        top = {legal[i] for i in np.argsort(pred, kind="stable")[:k]}
        assert len(top) == min(k, len(legal))
        want = top | ({base} if ops.tile_ok(s, base) else set())
        assert set(timed) == want, s.key()
        # the reference ranks the TPU-legal grid
        tpu = np.flatnonzero(np.isfinite(costmodel_vec.costs_for_tiles(
            [s] * len(grid), grid, "tpu_v5e")))
        pred = carried.predict_seconds([s] * len(tpu), grid[tpu],
                                       legality="tpu_v5e")
        top = tpu[np.argsort(pred, kind="stable")[:k]]
        lost += sum(not ops.tile_ok(s, tuple(int(x) for x in grid[i]))
                    for i in top)
    assert lost > 0
    assert not [t for key, t in spy.keys if key == sites[-1].key()]


def test_no_surrogate_priced_value_reaches_the_db(tmp_path, carried):
    db = str(tmp_path / "t.jsonl")
    spy = Spy()
    env = make_measured_env(CFG, transport=InProcessTransport(
        spy, MeasureDB(db)), prune_topk=1, surrogate=carried,
        legality="tpu_v5e")
    env.cost_grid(FIXTURE_SITES + [MM])
    env.measure_fn.transport.close()
    assert env.pruned_pairs > 0
    written = {r.key for r in MeasureDB(db).iter_records()}
    assert written == {make_key(k, t, "spy") for k, t in spy.keys}
    priced = set(env._priced)
    assert priced and not priced & set(spy.keys)
    # a surrogate trained from that DB sees only the timed pairs
    corpus = build_corpus(db)
    assert len(corpus.y) == spy.pairs
    assert {(s.key(), tuple(int(x) for x in t))
            for s, t in zip(corpus.sites, corpus.tiles)} == set(spy.keys)


def test_make_measured_env_resolves_the_surrogate(tmp_path, carried):
    """A model passes through, a checkpoint dir loads, ``None`` trains
    from the transport's DB, and a cold DB leaves pruning inactive."""
    art = str(tmp_path / "ck")
    save_surrogate(carried, art)
    warm = _fixture_db(tmp_path / "warm.jsonl")
    for sur, db, active in ((carried, None, True), (art, None, True),
                            (None, warm, True), (None, None, False)):
        env = make_measured_env(CFG, runner=Spy(), db_path=db, prune_topk=2,
                                surrogate=sur, surrogate_device="cpu")
        assert env.prune_active is active
        if active:
            assert env.surrogate.device.type == "cpu"
        env.measure_fn.transport.close()
    # without prune_topk the surrogate is not resolved
    env = make_measured_env(CFG, runner=Spy(), surrogate=art)
    assert not env.prune_active and env.surrogate == art


# ---------------------------------------------------------------------------
# the facade and serve
# ---------------------------------------------------------------------------

def test_facade_surrogate_oracle_tunes_like_the_reference(ref_model,
                                                          tmp_path):
    from repro.api import NeuroVectorizer as JNeuroVectorizer
    from repro_torch.api import NeuroVectorizer, SurrogateOracle as API_SO
    art = str(tmp_path / "ck")
    jsave_surrogate(ref_model, art)
    sites = FIXTURE_SITES + [MM]
    nv = NeuroVectorizer(CFG, agent="brute", oracle="surrogate",
                         surrogate=art, **CPU)
    jnv = JNeuroVectorizer(JCFG, agent="brute", oracle="surrogate",
                           surrogate=art)
    assert isinstance(nv.oracle, API_SO)
    got = nv.fit(sites).tune_sites(sites).tiles
    want = jnv.fit([_j(s) for s in sites]).tune_sites(
        [_j(s) for s in sites]).tiles
    assert got == want
    assert nv._spec["surrogate"] == art and nv._spec["oracle"] == "surrogate"
    # trained from a DB path instead, and the errors of the reference
    with NeuroVectorizer(CFG, agent="brute", oracle="surrogate",
                         db_path=_fixture_db(tmp_path / "m.jsonl"),
                         **CPU) as nv2:
        prog = nv2.fit(sites).tune_sites(sites)
        assert all(ops.tile_ok(s, prog.tiles[s.key()]) for s in sites)
    with pytest.raises(ValueError, match="needs a trained model"):
        NeuroVectorizer(CFG, agent="brute", oracle="surrogate", **CPU)
    with pytest.raises(ValueError, match="prune_topk applies only"):
        NeuroVectorizer(CFG, agent="brute", oracle="surrogate",
                        surrogate=art, prune_topk=2, **CPU)
    with pytest.raises(ValueError, match="apply only"):
        NeuroVectorizer(CFG, agent="brute", prune_topk=2, **CPU)


def test_facade_pruned_measured_tunes_like_the_reference(ref_model,
                                                         carried, tmp_path):
    from repro.api import NeuroVectorizer as JNeuroVectorizer
    from repro.measure import InProcessTransport as JInProcessTransport
    from repro_torch.api import NeuroVectorizer
    sites = FIXTURE_SITES + [MM]
    spy, jspy = Spy(), Spy()
    nv = NeuroVectorizer(CFG, agent="brute", oracle="measured",
                         transport=InProcessTransport(spy, None),
                         prune_topk=2, surrogate=carried, **CPU)
    jnv = JNeuroVectorizer(JCFG, agent="brute", oracle="measured",
                           transport=JInProcessTransport(jspy, None),
                           prune_topk=2, surrogate=ref_model)
    got = nv.fit(sites).tune_sites(sites).tiles
    want = jnv.fit([_j(s) for s in sites]).tune_sites(
        [_j(s) for s in sites]).tiles
    assert got == want
    assert spy.keys == jspy.keys
    assert nv.oracle.pruned_pairs == jnv.oracle.pruned_pairs > 0
    # the recipe records the budget and a live model as "custom"; a load
    # retrains from the DB (none here: pruning inactive)
    assert nv._spec["prune_topk"] == 2 and nv._spec["surrogate"] == "custom"
    nv.save(str(tmp_path / "f"))
    with NeuroVectorizer.load(str(tmp_path / "f"),
                              transport=InProcessTransport(Spy(), None),
                              **CPU) as nv2:
        assert nv2.oracle.prune_topk == 2 and not nv2.oracle.prune_active
    nv.close()


def test_serve_prints_the_pruning_state_line(tmp_path, capsys, carried):
    from repro_torch.launch import serve
    art = str(tmp_path / "ck")
    save_surrogate(carried, art)
    base = ["--device", "cpu", "--batch", "2", "--prompt-len", "16",
            "--gen", "3", "--measured", "--measure-reps", "1",
            "--prune-topk", "2"]
    res = serve.main(base + ["--autotune", "brute", "--surrogate", art])
    out = capsys.readouterr().out
    n = res.tuning["pruned_pairs"]
    assert n > 0
    assert f"[serve] pruning top-2: active, {n} pairs surrogate-priced" in out
    assert "surrogate=" in out
    # at most k tiles of the grid and the baseline timed a site
    for pick in res.tuning["picks"].values():
        assert pick["n_timed"] <= 3
    serve.main(base + ["--autotune", "baseline"])
    out = capsys.readouterr().out
    assert ("[serve] pruning top-2: inactive (DB too cold to train the "
            "surrogate), 0 pairs surrogate-priced") in out
    for argv, msg in ((["--autotune", "ppo", "--prune-topk", "2"],
                       "applies only to --measured"),
                      (["--autotune", "ppo", "--measured", "--surrogate",
                        art], "applies only with --prune-topk"),
                      (["--autotune", "ppo", "--measured", "--prune-topk",
                        "0"], "must be >= 1")):
        with pytest.raises(SystemExit):
            serve.parse_args(["--device", "cpu", *argv])
        assert msg in capsys.readouterr().err


def test_prometheus_series_match_the_reference(ref_model, carried):
    from repro import obs as jobs
    from repro_torch import obs as tobs
    sites, jsites = dataset.generate(30, seed=6), jds.generate(30, seed=6)
    snaps = []
    for mod, oracle, ss in (
            (tobs, SurrogateOracle(DEFAULT, carried, legality="tpu_v5e"),
             sites),
            (jobs, JSurrogateOracle(JDEFAULT, ref_model), jsites)):
        reg = mod.MetricsRegistry()
        h = mod.instrument_oracle_stack(oracle, reg)
        oracle.cost_grid(ss)
        oracle.cost_grid(ss)
        oracle.baseline_costs(ss)
        snap = reg.snapshot()
        h.close()
        snaps.append(snap)
        assert "surrogate_predict_seconds" in reg.render_prom()
    got, want = snaps
    assert sorted(got) == sorted(want)
    for k in ("surrogate_predicted_pairs_total",
              "surrogate_cache_hits_total"):
        assert got[k] == want[k] > 0
    assert got["surrogate_predict_seconds"]["count"] == \
        want["surrogate_predict_seconds"]["count"]
    # a pruned measured env counts its surrogate-priced pairs
    snaps = []
    for mod, env, ss in (
            (tobs, MeasuredEnv(CFG, measure_fn=Spy(), legality="tpu_v5e",
                               prune_topk=1, surrogate=carried),
             FIXTURE_SITES),
            (jobs, JMeasuredEnv(JCFG, measure_fn=Spy(), prune_topk=1,
                                surrogate=ref_model),
             [_j(s) for s in FIXTURE_SITES])):
        reg = mod.MetricsRegistry()
        h = mod.instrument_oracle_stack(env, reg)
        env.cost_grid(ss)
        snaps.append(reg.snapshot())
        h.close()
    got, want = snaps
    assert got["env_surrogate_priced_pairs_total"] == \
        want["env_surrogate_priced_pairs_total"] > 0
    assert got["env_measured_pairs_total"] == want["env_measured_pairs_total"]
