"""``repro_torch.api`` — the public surface of the PyTorch port (the port of
``repro/api.py``; paper Fig. 3/4: end to end, code to vectorization).

One facade drives the pipeline with interchangeable decision methods
behind the :class:`Agent` protocol and interchangeable reward sources
behind the :class:`Oracle` protocol::

    from repro_torch.api import NeuroVectorizer

    nv = NeuroVectorizer(cfg, agent="ppo", lr=5e-4, seed=0)
    nv.fit(corpus_sites, total_steps=30_000)     # train vs the oracle
    prog = nv.tune(step_fn, meta_args)           # extract -> act -> tiles
    print(nv.speedup(prog, sites))               # modelled speedup
    with nv.inject(prog):                        # the tuned Hopper kernels
        step_fn(*real_args)

Swap ``agent="ppo"`` for any registry name (``dtree`` / ``nns`` /
``brute`` / ``random`` / ``polly`` / ``baseline``), or the default
cost-model oracle for ``oracle="measured"``: rewards then come from the
card's timings of the kernels themselves.  ``nv.save(dir)`` writes the
reference's facade artifact and ``NeuroVectorizer.load(dir)`` re-assembles
it; ``program_store=`` memoizes finished programs, so tuning a site set
seen before is a lookup.

Timings may run in this process, in a pool of subprocess workers
(``transport="pool", workers=N``) or on remote ``serve-worker`` daemons
(``transport="socket", hosts=[...]``); a ``fleet://host:port`` path for
``db_path`` or ``program_store`` attaches the shared artifact service.

The facade runs on the card unless ``device="cpu"`` is asked for; without
CUDA it raises.  The reference's surrogate oracle and grid pruning, the
tuning service and ``AsyncOracle`` are not ported yet: each option naming
one raises ``NotImplementedError``.
"""
from __future__ import annotations

import inspect
import json
import os
import shutil
import time
from typing import Optional, Sequence, Union

from repro_torch.artifacts import (ArtifactError, ProgramStore,
                                   agent_fingerprint, load_agent,
                                   open_program_store, program_key,
                                   save_agent, tune_through_store)
from repro_torch.configs.neurovec import (DEFAULT, NeuroVecConfig,
                                          cfg_from_dict, cfg_to_dict)
from repro_torch.core.agents import (AGENT_NAMES, BruteForceAgent,
                                     DecisionTreeAgent, NNSAgent,
                                     default_embed_fn, make_agent)
from repro_torch.core.env import (ActionSpace, CostModelEnv, MeasuredEnv,
                                  set_strict_actions)
from repro_torch.core.extractor import extract_arch_sites, extract_sites
from repro_torch.core.protocols import (Agent, MeasureTransport, Oracle,
                                        resolve_health)
from repro_torch.core.vectorizer import (TileProgram, baseline_program,
                                         inject, program_speedup)
from repro_torch.device import resolve_device
from repro_torch.measure import (TRANSPORT_NAMES, MeasureRunner,
                                 make_measured_env, make_transport)
from repro_torch.obs import (MetricsRegistry, ObsHandle, Tracer,
                             get_registry, instrument_oracle_stack,
                             instrument_program_store, resolve_obs,
                             to_chrome_trace)

__all__ = [
    "NeuroVectorizer",
    "Agent", "Oracle", "MeasureTransport",
    "AGENT_NAMES", "make_agent", "default_embed_fn",
    "NeuroVecConfig", "DEFAULT", "ActionSpace",
    "CostModelEnv", "MeasuredEnv", "set_strict_actions",
    "make_measured_env", "make_transport", "TRANSPORT_NAMES",
    "TileProgram", "baseline_program", "inject", "program_speedup",
    "extract_sites", "extract_arch_sites",
    "ArtifactError", "save_agent", "load_agent", "agent_fingerprint",
    "ProgramStore", "program_key",
    "MetricsRegistry", "get_registry", "Tracer", "to_chrome_trace",
]

_FACADE_FORMAT = "neurovectorizer-facade"
_LATER = "ROADMAP queue 1 item 3"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({_LATER})")


def _runner_options() -> set:
    return {p for p in inspect.signature(MeasureRunner).parameters}


class NeuroVectorizer:
    """The end-to-end facade: extract → fit → tune → inject.

    The reward source, as the reference's matrix restricted to the port's
    layers (every row speaks the same :class:`Oracle` protocol):

    ==================  ======================  ===========================
    ``oracle=``         ``transport=``          rewards come from
    ==================  ======================  ===========================
    ``None`` / "model"  (must be unset)         the analytic cost model,
                                                ``CostModelEnv`` under the
                                                port's launch rule
                                                (``legality="h100"``)
    ``"measured"``      ``None`` / "inproc"     the card's timings of the
                                                kernels in this process
    ``"measured"``      "pool", ``workers=N``   timings in N subprocess
                                                workers, each with its own
                                                CUDA context
                                                (``WorkerPoolTransport``)
    ``"measured"``      "socket", ``hosts=``    timings on remote
                                                ``serve-worker`` hosts
                                                (``SocketTransport``)
    ``"measured"``      a ``MeasureTransport``  timings through your
                                                transport (borrowed)
    an ``Oracle``       (must be unset)         your oracle, verbatim
    ==================  ======================  ===========================

    ``oracle="surrogate"``, ``prune_topk=`` and ``surrogate=`` raise
    ``NotImplementedError``.

    ``device`` (default ``"cuda"``) is where PPO's network, the default
    embedder of ``nns``/``dtree`` and the measuring runner live (each pool
    worker's too; a socket fleet's runners are configured on its hosts);
    without CUDA a ``"cuda"`` facade raises.  ``db_path`` keeps the
    measured oracle's timings (a repeat run times nothing; a
    ``fleet://host:port`` path attaches the shared store);
    ``oracle_kwargs`` are :class:`~repro_torch.measure.MeasureRunner`
    options (``reps=``, ``warmup=``).  ``program_store`` (a
    :class:`ProgramStore`, borrowed, or a path, owned; ``fleet://`` too)
    memoizes finished programs per (site set, agent state, oracle
    backend); ``agent_inferences`` / ``store_hits`` / ``store_misses``
    count what ran.  ``metrics`` / ``trace`` as in
    :func:`repro_torch.obs.resolve_obs`.

    A facade that built a measured oracle owns its transport: :meth:`close`
    (or the context manager) releases it (a pool's workers with it) and an
    owned store; a closed facade raises ``RuntimeError`` on
    ``fit``/``tune``.
    """

    def __init__(self, cfg: NeuroVecConfig = DEFAULT,
                 agent: Union[str, Agent] = "ppo",
                 oracle: Union[str, Oracle, None] = None, seed: int = 0,
                 db_path: Optional[str] = None,
                 oracle_kwargs: Optional[dict] = None,
                 transport: Union[str, MeasureTransport, None] = None,
                 workers: Optional[int] = None,
                 hosts=None,
                 program_store: Union[str, ProgramStore, None] = None,
                 prune_topk: Optional[int] = None,
                 surrogate=None,
                 metrics: Union[MetricsRegistry, bool, None] = None,
                 trace: Union[str, Tracer, None] = None,
                 device="cuda",
                 **agent_kwargs):
        # the options whose layers the port lacks fail loudly, first
        if oracle == "surrogate":
            raise _not_ported("oracle='surrogate' (the learned cost model)")
        if surrogate is not None or prune_topk is not None:
            raise _not_ported("surrogate grid pruning (prune_topk=, "
                              "surrogate=)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._owns_oracle = False
        self._closed = False
        self.registry, self.tracer, self._owns_tracer = \
            resolve_obs(metrics, trace)
        if oracle == "measured":
            runner_kwargs = dict(oracle_kwargs or {})
            if transport in (None, "inproc", "pool"):
                # a built transport carries its own runner, a socket
                # fleet's hosts theirs
                runner_kwargs = {"device": str(self.device), **runner_kwargs}
            self.oracle: Oracle = make_measured_env(
                cfg, db_path=db_path, seed=seed, transport=transport,
                workers=workers, hosts=hosts, **runner_kwargs)
            # a borrowed MeasureTransport instance is not ours to close
            self._owns_oracle = transport is None or isinstance(transport,
                                                                str)
        else:
            if db_path is not None or oracle_kwargs or \
                    transport is not None or workers is not None or \
                    hosts is not None:
                raise ValueError("db_path/oracle_kwargs/transport/workers/"
                                 "hosts apply only to oracle='measured'")
            if oracle is None or oracle == "model":
                self.oracle = CostModelEnv(cfg, seed=seed)
            elif isinstance(oracle, str):
                raise ValueError(f"unknown oracle {oracle!r}: expected "
                                 f"'model' or 'measured'")
            else:
                self.oracle = oracle
        self.agent: Agent = (make_agent(agent, cfg, seed=seed,
                                        device=str(self.device),
                                        **agent_kwargs)
                             if isinstance(agent, str) else agent)
        self._owns_store = isinstance(program_store, str)
        self.program_store: Optional[ProgramStore] = (
            open_program_store(program_store) if self._owns_store
            else program_store)
        self.agent_inferences = 0
        self.store_hits = 0
        self.store_misses = 0
        # the re-assembly recipe nv.save() persists, in the reference's
        # layout (a hand-built oracle/transport/agent is "custom")
        self._spec = {
            "agent": agent if isinstance(agent, str) else None,
            "agent_kwargs": agent_kwargs if isinstance(agent, str) else {},
            "oracle": (oracle if isinstance(oracle, str) or oracle is None
                       else "custom"),
            "transport": (transport if isinstance(transport, str)
                          or transport is None else "custom"),
            "workers": workers, "db_path": db_path,
            "hosts": list(hosts) if hosts else None,
            "oracle_kwargs": dict(oracle_kwargs or {}), "seed": seed,
            "prune_topk": None, "surrogate": None,
        }
        self._obs = ObsHandle(self.registry)
        self._obs.adopt(instrument_oracle_stack(self.oracle, self.registry,
                                                self.tracer))
        self._obs.adopt(instrument_program_store(self.program_store,
                                                 self.registry))
        self._m_fit_s = self.registry.histogram(
            "facade_fit_seconds", "NeuroVectorizer.fit() latency")
        self._m_tune_s = self.registry.histogram(
            "facade_tune_seconds", "NeuroVectorizer.tune_sites() latency")
        self._span = self.tracer.begin("session", detached=True,
                                       kind="facade",
                                       agent=self.agent.name)

    # -- training ----------------------------------------------------------
    def fit(self, corpus_sites: Sequence, **fit_kwargs) -> "NeuroVectorizer":
        """Fit the agent against this facade's oracle (RL training, brute
        labelling, or a no-op for search-free methods).  Extra kwargs flow
        to the agent (``total_steps=`` for ppo, ``labels=`` for
        nns/dtree)."""
        self._check_open("fit")
        corpus_sites = list(corpus_sites)
        t0 = time.monotonic()
        with self.tracer.span("fit", parent=self._span,
                              n_sites=len(corpus_sites)):
            self.agent.fit(corpus_sites, self.oracle, **fit_kwargs)
        self._m_fit_s.observe(time.monotonic() - t0)
        return self

    # -- tuning ------------------------------------------------------------
    def tune(self, step_fn, abstract_args: Sequence = ()) -> TileProgram:
        """Extract kernel sites from ``step_fn`` run on ``meta`` tensors
        ``abstract_args`` and tune them (greedy inference, paper §4.2)."""
        return self.tune_sites(extract_sites(step_fn, *abstract_args))

    def tune_sites(self, sites: Sequence) -> TileProgram:
        """Greedy tiles for ``sites``, among the actions the oracle prices
        as legal; from the program store when it holds them."""
        self._check_open("tune")
        sites = list(sites)
        t0 = time.monotonic()
        with self.tracer.span("tune", parent=self._span,
                              n_sites=len(sites)) as sp:
            prog, hit = tune_through_store(sites, self.agent,
                                           self.oracle.space,
                                           self.oracle, self.program_store)
            sp.set(store_hit=bool(hit))
        self._m_tune_s.observe(time.monotonic() - t0)
        if self.program_store is not None and sites:
            if hit:
                self.store_hits += 1
            else:
                self.store_misses += 1
        if not hit:
            self.agent_inferences += len(sites)
        return prog

    def tune_arch(self, arch: str, batch: int = 8,
                  seq: int = 2048) -> TileProgram:
        """Tune every site of one training step of a ported architecture."""
        return self.tune_sites(extract_arch_sites(arch, batch=batch,
                                                  seq=seq))

    # -- deployment --------------------------------------------------------
    def inject(self, program: TileProgram):
        """Context manager: run model code with every matmul and prefill
        attention site launching its Hopper kernel at the tuned tile (the
        plain versions on CPU tensors)."""
        return inject(program)

    def baseline(self, sites: Sequence) -> TileProgram:
        return baseline_program(list(sites))

    def speedup(self, program: TileProgram, sites: Sequence) -> float:
        """Aggregate speedup of ``program`` over the heuristic baseline,
        priced by this facade's oracle (the card's timings under
        ``oracle="measured"``)."""
        return program_speedup(program, list(sites), env=self.oracle)

    def health(self) -> str:
        """``ok | degraded | down`` of this facade's reward path
        (``degraded``: the measured oracle's breaker opened and it prices
        with the cost model)."""
        fn = getattr(self.oracle, "measure_fn", None)
        return resolve_health(self.oracle, getattr(fn, "transport", None))

    # -- persistence --------------------------------------------------------
    def save(self, path: str) -> str:
        """Persist this facade as the reference's artifact directory: the
        config, the agent's state (``repro_torch.artifacts`` format) and
        the oracle recipe.  Returns the agent-state fingerprint.  A
        hand-built oracle or transport is recorded as ``"custom"``:
        :meth:`load` then needs it passed again."""
        spec = dict(self._spec)
        if spec["agent"] is None:
            # a hand-built nns/dtree carries a live embed_fn outside its
            # state: the registry's default would change act() silently
            if isinstance(self.agent, (NNSAgent, DecisionTreeAgent)):
                raise ArtifactError(
                    f"cannot record the construction of a hand-built "
                    f"{type(self.agent).__name__} (its embed_fn is a live "
                    f"callable) — construct via agent="
                    f"{self.agent.name!r} on the facade, or pass agent= "
                    f"to NeuroVectorizer.load()")
            spec["agent"] = self.agent.name
        payload = {"format": _FACADE_FORMAT, "version": 1,
                   "cfg": cfg_to_dict(self.cfg), **spec}
        try:
            blob = json.dumps(payload, indent=1)
        except TypeError as e:
            raise ArtifactError(
                f"facade spec is not serializable ({e}); agent_kwargs and "
                f"oracle_kwargs must be plain JSON values to save") from e
        path = str(path)
        tmp = path.rstrip(os.sep) + f".tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        fp = save_agent(self.agent, os.path.join(tmp, "agent"))
        with open(os.path.join(tmp, "facade.json"), "w") as f:
            f.write(blob)
        # manifest last: a partial directory is never restorable
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"format": _FACADE_FORMAT, "version": 1,
                       "agent": payload["agent"], "agent_fingerprint": fp,
                       "time": time.time()}, f, indent=1)
        # swap whole directories: a crash leaves the old or the new one
        old = None
        if os.path.isdir(path):
            old = path.rstrip(os.sep) + f".old-{os.getpid()}"
            shutil.rmtree(old, ignore_errors=True)
            os.replace(path, old)
        os.replace(tmp, path)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
        return fp

    @classmethod
    def load(cls, path: str,
             agent: Optional[Agent] = None,
             oracle: Union[str, Oracle, None] = None,
             transport: Union[str, MeasureTransport, None] = None,
             workers: Optional[int] = None, hosts=None,
             db_path: Optional[str] = None,
             program_store: Union[str, ProgramStore, None] = None,
             seed: Optional[int] = None,
             prune_topk: Optional[int] = None,
             surrogate=None,
             device="cuda",
             **agent_kwargs) -> "NeuroVectorizer":
        """Re-assemble a facade saved by :meth:`save` (by either package):
        config, agent construction, verified state restore, and the oracle
        from the recorded recipe; its ``tune_sites`` is the saver's.

        Keyword overrides replace the recipe (``db_path``,
        ``program_store``, ``oracle``...); ``agent=`` restores into an
        agent the caller built (needed for nns/dtree with a custom
        ``embed_fn``); ``oracle=``/``transport=`` are needed where the
        saver's were hand-built.  ``device`` is this process's.  A
        measured recipe whose ``oracle_kwargs`` hold an option the port's
        runner lacks (the reference's ``interpret``, ``max_dim``) raises
        :class:`ArtifactError` naming it; a recipe that names an unported
        layer (a surrogate) raises ``NotImplementedError``."""
        path = str(path)
        if not os.path.exists(os.path.join(path, "manifest.json")):
            raise ArtifactError(f"no restorable facade artifact at "
                                f"{path!r} (manifest.json missing)")
        with open(os.path.join(path, "facade.json")) as f:
            spec = json.load(f)
        if spec.get("format") != _FACADE_FORMAT:
            raise ArtifactError(f"{path!r} is not a facade artifact "
                                f"(format={spec.get('format')!r})")
        cfg = cfg_from_dict(spec["cfg"])
        if spec["oracle"] == "custom" and oracle is None:
            raise ArtifactError(
                "this artifact was saved around a hand-built Oracle, which "
                "cannot be re-assembled automatically — pass oracle= to "
                "load()")
        oracle = spec["oracle"] if oracle is None else oracle
        spec_sur = spec.get("surrogate")
        if surrogate is None and spec_sur != "custom":
            surrogate = spec_sur
        kw = {}
        if oracle == "measured":
            if spec["transport"] == "custom" and transport is None:
                raise ArtifactError(
                    "this artifact was saved around a hand-built "
                    "transport — pass transport= to load()")
            unknown = sorted(set(spec["oracle_kwargs"] or {})
                             - _runner_options())
            if unknown:
                raise ArtifactError(
                    f"the recipe's oracle_kwargs hold {unknown}, which the "
                    f"port's MeasureRunner does not take (it takes "
                    f"{sorted(_runner_options())})")
            kw = {"transport": (spec["transport"] if transport is None
                                else transport),
                  "workers": spec["workers"] if workers is None else workers,
                  "hosts": spec.get("hosts") if hosts is None else hosts,
                  "db_path": spec["db_path"] if db_path is None else db_path,
                  "oracle_kwargs": spec["oracle_kwargs"] or None,
                  "prune_topk": (spec.get("prune_topk")
                                 if prune_topk is None else prune_topk),
                  "surrogate": surrogate}
        merged_kwargs = {**spec["agent_kwargs"], **agent_kwargs}
        nv = cls(cfg, agent=spec["agent"] if agent is None else agent,
                 oracle=oracle,
                 seed=spec["seed"] if seed is None else seed,
                 program_store=program_store, device=device,
                 **kw, **(merged_kwargs if agent is None else {}))
        load_agent(os.path.join(path, "agent"), agent=nv.agent)
        if isinstance(nv.agent, BruteForceAgent):
            # brute captures a live oracle at fit time: re-bind ours
            nv.agent.oracle = nv.oracle
        return nv

    # -- lifecycle ---------------------------------------------------------
    def _check_open(self, verb: str) -> None:
        if self._closed:
            raise RuntimeError(
                f"cannot {verb}: this NeuroVectorizer is closed (its "
                f"transport/store handles were released) — build a new "
                f"facade or NeuroVectorizer.load() a saved one")

    def close(self) -> None:
        """Release the measured oracle's transport (a pool's workers, the
        DB file or connection) and an owned program store, and mark the
        facade closed.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._span.end()
        if self._owns_oracle:
            self.oracle.measure_fn.transport.close()
        if self._owns_store and self.program_store is not None:
            self.program_store.close()
        self._obs.close()
        if self._owns_tracer:
            self.tracer.close()

    def __enter__(self) -> "NeuroVectorizer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
