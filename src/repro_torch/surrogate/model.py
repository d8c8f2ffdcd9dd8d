"""The surrogate itself: a small MLP ensemble (the port of
``repro/surrogate/model.py``).

Inputs are the fixed :mod:`~repro_torch.surrogate.features` vectors,
targets are log-seconds; both are z-normalized with statistics learned
from the corpus and stored in the checkpoint.  An ensemble of
independently initialized members (mean prediction) smooths the
small-corpus variance of a single fit.  Each member is an ``nn.Module``
(tanh MLP, ``h @ w + b`` with ``w`` stored ``(in, out)`` as the reference
stores it), He-normal initialized from a CPU ``torch.Generator`` seeded
by ``seed``, so the initial weights do not depend on the device.
Training is full-batch f32, one ``loss.backward()`` and one
:func:`repro_torch.optim.adamw.update_` a step with the reference's
schedule.

The model lives on the card unless ``device="cpu"`` is asked for.  f32
products stay at full precision there: prediction and training run with
``torch.backends.cuda.matmul.allow_tf32`` off, so the card's predictions
are the CPU's.

Checkpoints are the reference's ``artifacts/agentio`` format
(``state_dict()``: name, version, arrays), so a surrogate saved by either
package loads in the other, fingerprint-checked.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.artifacts import agentio
from repro_torch.core import costmodel_vec
from repro_torch.core.costmodel import DEFAULT_LEGALITY
from repro_torch.core.protocols import AGENT_STATE_VERSION
from repro_torch.device import resolve_device
from repro_torch.measure.db import MeasureDB
from repro_torch.optim import adamw
from repro_torch.surrogate.dataset import Corpus, build_corpus
from repro_torch.surrogate.features import N_FEATURES, featurize

MODEL_NAME = "surrogate"


@contextlib.contextmanager
def _full_f32(device: torch.device):
    """f32 matmuls at full precision on the card (TF32 off), restored
    after."""
    if device.type != "cuda":
        yield
        return
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


class Member(nn.Module):
    """One tanh MLP of the ensemble: layers ``h @ w + b``."""

    def __init__(self, ws: Sequence[torch.Tensor],
                 bs: Sequence[torch.Tensor]):
        super().__init__()
        self.w = nn.ParameterList([nn.Parameter(w) for w in ws])
        self.b = nn.ParameterList([nn.Parameter(b) for b in bs])

    @classmethod
    def he_normal(cls, gen: torch.Generator, n_in: int,
                  hidden: Sequence[int], device) -> "Member":
        sizes = [n_in, *hidden, 1]
        ws, bs = [], []
        for i in range(len(sizes) - 1):
            scale = float(np.sqrt(2.0 / sizes[i]))
            ws.append((torch.randn((sizes[i], sizes[i + 1]), generator=gen,
                                   dtype=torch.float32) * scale).to(device))
            bs.append(torch.zeros((sizes[i + 1],), dtype=torch.float32,
                                  device=device))
        return cls(ws, bs)

    @classmethod
    def from_tree(cls, layers, device) -> "Member":
        """From the reference's ``[{"w", "b"}, ...]`` (numpy arrays)."""
        return cls([torch.tensor(np.asarray(l["w"], np.float32),
                                 device=device) for l in layers],
                   [torch.tensor(np.asarray(l["b"], np.float32),
                                 device=device) for l in layers])

    def tree(self) -> list:
        """The parameters as the reference's ``[{"w", "b"}, ...]``."""
        return [{"w": w, "b": b} for w, b in zip(self.w, self.b)]

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        h = X
        for w, b in zip(list(self.w)[:-1], list(self.b)[:-1]):
            h = torch.tanh(h @ w + b)
        return (h @ self.w[-1] + self.b[-1])[:, 0]


def _train_member(member: Member, X: torch.Tensor, y: torch.Tensor,
                  steps: int, lr: float) -> torch.Tensor:
    """Full-batch AdamW on the mean squared error, in place; returns the
    (steps,) losses."""
    cfg = adamw.AdamWConfig(lr=lr, weight_decay=1e-4, clip_norm=1.0,
                            warmup_steps=min(20, steps // 5),
                            total_steps=steps, min_lr_frac=0.05)
    params = member.tree()
    opt = adamw.init(params)
    losses = []
    for _ in range(steps):
        member.zero_grad(set_to_none=True)
        loss = torch.mean((member(X) - y) ** 2)
        loss.backward()
        grads = [{"w": l["w"].grad, "b": l["b"].grad} for l in params]
        adamw.update_(cfg, grads, opt, params)
        losses.append(loss.detach())
    return torch.stack(losses) if losses else torch.zeros(0)


class SurrogateModel:
    """Ensemble MLP mapping feature vectors to log-seconds."""

    name = MODEL_NAME

    def __init__(self, members: Sequence[Member], x_mean, x_std,
                 y_mean: float, y_std: float, hidden: Tuple[int, ...],
                 backend: str = "", n_features: int = N_FEATURES,
                 device="cuda"):
        self.device = resolve_device(device)
        self.members = [m.to(self.device) for m in members]
        self.x_mean = np.asarray(x_mean, np.float64)
        self.x_std = np.asarray(x_std, np.float64)
        self.y_mean = float(y_mean)
        self.y_std = float(y_std)
        self.hidden = tuple(int(h) for h in hidden)
        self.backend = str(backend)
        self.n_features = int(n_features)

    @property
    def ensemble(self) -> int:
        return len(self.members)

    # -- inference -----------------------------------------------------------
    def predict_log_seconds(self, X) -> np.ndarray:
        """(n,) predicted log-seconds for raw (unnormalized) features."""
        X = np.asarray(X, np.float64)
        if X.ndim != 2 or X.shape[1] != self.n_features:
            raise ValueError(f"features must be (n, {self.n_features}), "
                             f"got {X.shape}")
        if not len(X):
            return np.zeros((0,), np.float64)
        Xn = torch.tensor((X - self.x_mean) / self.x_std,
                          dtype=torch.float32, device=self.device)
        with torch.inference_mode(), _full_f32(self.device):
            outs = [m(Xn).double().cpu().numpy() for m in self.members]
        return np.mean(outs, axis=0) * self.y_std + self.y_mean

    def predict_seconds(self, sites, tiles,
                        legality: str = DEFAULT_LEGALITY) -> np.ndarray:
        """(n,) predicted seconds per pair; ``inf`` where ``legality``
        refuses the tile (never a runtime for a kernel that cannot run):
        ``"h100"`` is the Hopper kernels' launch rule, ``"tpu_v5e"`` the
        reference's VMEM rule."""
        if not len(sites):
            return np.zeros((0,), np.float64)
        t = np.asarray(tiles, np.int64).reshape(len(sites), -1)
        if t.shape[1] < 3:
            t = np.concatenate([t, np.ones((len(t), 3 - t.shape[1]),
                                           np.int64)], 1)
        ok = costmodel_vec.costs_for_tiles(sites, t, legality)
        out = np.full(len(sites), np.inf, np.float64)
        legal = np.flatnonzero(np.isfinite(ok))
        if len(legal):
            X = featurize([sites[i] for i in legal], t[legal])
            out[legal] = np.exp(self.predict_log_seconds(X))
        return out

    # -- checkpoint surface (agentio) ----------------------------------------
    def state_dict(self) -> dict:
        return {
            "name": self.name,
            "version": AGENT_STATE_VERSION,
            "backend": self.backend,
            "hidden": list(self.hidden),
            "n_features": self.n_features,
            "x_mean": self.x_mean, "x_std": self.x_std,
            "y_mean": self.y_mean, "y_std": self.y_std,
            "params": [[{"w": l["w"].detach().cpu().numpy(),
                         "b": l["b"].detach().cpu().numpy()}
                        for l in m.tree()] for m in self.members],
        }

    @classmethod
    def from_state(cls, state: dict, device="cuda") -> "SurrogateModel":
        """A model from a ``state_dict()`` of either package, on
        ``device``; ``ArtifactError`` for another artifact, another schema
        version, or arrays whose shapes disagree with ``hidden`` and
        ``n_features``."""
        if state.get("name") != MODEL_NAME:
            raise agentio.ArtifactError(
                f"not a surrogate checkpoint: name={state.get('name')!r}")
        if state.get("version") != AGENT_STATE_VERSION:
            raise agentio.ArtifactError(
                f"surrogate schema version {state.get('version')!r} "
                f"unsupported (expected {AGENT_STATE_VERSION})")
        sizes = [int(state["n_features"]), *state["hidden"], 1]
        for i, member in enumerate(state["params"]):
            got = [tuple(np.shape(l["w"])) for l in member]
            want = list(zip(sizes[:-1], sizes[1:]))
            if got != want:
                raise agentio.ArtifactError(
                    f"surrogate member {i}: weight shapes {got}, expected "
                    f"{want}")
        dev = resolve_device(device)
        return cls([Member.from_tree(m, dev) for m in state["params"]],
                   state["x_mean"], state["x_std"], state["y_mean"],
                   state["y_std"], hidden=tuple(state["hidden"]),
                   backend=state["backend"],
                   n_features=int(state["n_features"]), device=dev)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def train_surrogate(corpus: Corpus, *, hidden: Tuple[int, ...] = (64, 64),
                    ensemble: int = 4, steps: int = 500, lr: float = 1e-2,
                    seed: int = 0, backend: str = "",
                    device="cuda") -> SurrogateModel:
    """Fit the ensemble on a :class:`~repro_torch.surrogate.dataset.Corpus`
    on ``device`` (the card unless ``"cpu"`` is asked for)."""
    if not len(corpus.y):
        raise ValueError("cannot train a surrogate on an empty corpus")
    dev = resolve_device(device)
    X = featurize(corpus.sites, corpus.tiles)
    x_mean = X.mean(axis=0)
    x_std = np.where(X.std(axis=0) < 1e-8, 1.0, X.std(axis=0))
    y_mean = float(corpus.y.mean())
    y_std = float(corpus.y.std()) or 1.0
    Xn = torch.tensor((X - x_mean) / x_std, dtype=torch.float32, device=dev)
    yn = torch.tensor((corpus.y - y_mean) / y_std, dtype=torch.float32,
                      device=dev)
    gen = torch.Generator().manual_seed(seed)
    members = []
    with _full_f32(dev):
        for _ in range(ensemble):
            member = Member.he_normal(gen, X.shape[1], hidden, dev)
            _train_member(member, Xn, yn, steps, lr)
            members.append(member)
    return SurrogateModel(members, x_mean, x_std, y_mean, y_std,
                          hidden=hidden, backend=backend, device=dev)


def train_from_db(db: Union[MeasureDB, str, None], *, min_pairs: int = 8,
                  backend: Optional[str] = None,
                  **train_kwargs) -> Optional[SurrogateModel]:
    """Train from whatever the DB holds; ``None`` when there is not yet
    enough data (``min_pairs`` finite records): "pruning not active yet",
    the right behaviour for a cold DB.

    With ``backend=None`` the corpus is restricted to the most common
    measurement fingerprint in the DB: mixing fingerprints would train on
    incommensurable clocks.  ``train_kwargs`` go to
    :func:`train_surrogate` (``device=`` among them).
    """
    if db is None:
        return None
    corpus = build_corpus(db, backend=backend)
    if backend is None and corpus.backends:
        backend = Counter(corpus.backends).most_common(1)[0][0]
        keep = [i for i, b in enumerate(corpus.backends) if b == backend]
        corpus = Corpus(
            sites=tuple(corpus.sites[i] for i in keep),
            tiles=corpus.tiles[keep], y=corpus.y[keep],
            backends=tuple(corpus.backends[i] for i in keep))
    if len(corpus.y) < min_pairs:
        return None
    return train_surrogate(corpus, backend=backend or "", **train_kwargs)


# ---------------------------------------------------------------------------
# checkpoints (agentio atomic-save + fingerprint discipline)
# ---------------------------------------------------------------------------


def save_surrogate(model: SurrogateModel, directory: str) -> str:
    """Atomic artifact write; returns the manifest fingerprint."""
    return agentio.save_agent(model, directory)


def load_surrogate(directory: str, device="cuda") -> SurrogateModel:
    """Load and fingerprint-verify a checkpoint onto ``device`` (raises
    ``ArtifactError`` on corruption or a non-surrogate artifact)."""
    state, _ = agentio.read_agent_state(directory)
    return SurrogateModel.from_state(state, device=device)
