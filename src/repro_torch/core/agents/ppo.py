"""PPO contextual bandit in PyTorch (paper §2.3, §3.3, §4); the port of
``repro/core/agents/ppo.py``.  The action-space modes of Fig. 6:

* ``discrete`` (default): three masked categorical heads over the factor
  indices, the configuration the paper found best;
* ``cont1``: one Gaussian output decoding to a flattened action index;
* ``cont2``: one Gaussian output per head, each decoded to its index;
* ``two_agents``: independent categorical heads (the reference computes
  it as ``discrete``, under its own name).

One episode = one site.  A single network embeds the site (code2vec
analogue, trained end to end) and emits a joint action.  The parameter
tree and the Adam state have the reference's structure, so a JAX
``state_dict()`` loads verbatim; the sampling stream is a
``torch.Generator`` (JAX's random bits cannot be reproduced), so training
agrees with the reference only statistically while greedy acting from
the same weights agrees exactly.

``PPOAgent(fused=False)`` is the seed's path, kept as the reference for
benchmarks as in the JAX package: features computed anew on every call
(no memo), the un-factored embedder, and an update that drops the tail
minibatch (``last_minibatch_count == ppo_epochs * (n // mb)``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.neurovec import NeuroVecConfig
from repro_torch.core import embedding as emb
from repro_torch.core.env import ActionSpace
from repro_torch.core.protocols import AGENT_STATE_VERSION, check_agent_state
from repro_torch.device import resolve_device

MODES = ("discrete", "cont1", "cont2", "two_agents")
_CONTINUOUS = ("cont1", "cont2")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _mlp_init(gen, sizes, device):
    return [{"w": torch.randn((a, b), generator=gen, device=device)
             * math.sqrt(2.0 / a),
             "b": torch.zeros((b,), device=device)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def _mlp(params, x):
    for i, p in enumerate(params):
        x = x @ p["w"] + p["b"]
        if i < len(params) - 1:
            x = torch.tanh(x)
    return x


def agent_init(gen, nv: NeuroVecConfig, head_sizes, device,
               mode: str = "discrete"):
    hid = list(nv.hidden)
    n_out = (sum(head_sizes) if mode not in _CONTINUOUS
             else (2 if mode == "cont1" else 2 * len(head_sizes)))
    return {"embedder": emb.embedder_init(gen, device),
            "trunk": _mlp_init(gen, [emb.EMBED_DIM] + hid, device),
            "pi": _mlp_init(gen, [hid[-1], n_out], device),
            "vf": _mlp_init(gen, [hid[-1], 1], device)}


def _head_logits(head_sizes, out, valid_sizes):
    """Split flat logits into masked per-head logits."""
    logits, off = [], 0
    for h, size in enumerate(head_sizes):
        lg = out[:, off:off + size]
        idx = torch.arange(size, device=out.device)[None, :]
        lg = torch.where(idx < valid_sizes[:, h:h + 1], lg,
                         torch.full_like(lg, -1e30))
        logits.append(lg)
        off += size
    return logits


def policy_forward(params, head_sizes, contexts, mask, valid_sizes,
                   mode: str = "discrete", fast_embed: bool = True):
    """-> (per-head logits, value), or for a continuous mode ((B, 2n)
    Gaussian parameters ``[mu, logstd]``, value).  ``fast_embed=False``
    runs the un-factored embedder :func:`~repro_torch.core.embedding.
    embed_sites_ref` (the seed's path)."""
    embed = emb.embed_sites if fast_embed else emb.embed_sites_ref
    code = embed(params["embedder"], contexts, mask)
    h = torch.tanh(_mlp(params["trunk"], code))
    out = _mlp(params["pi"], h)
    v = _mlp(params["vf"], h)[:, 0]
    if mode in _CONTINUOUS:
        return out, v
    return _head_logits(head_sizes, out, valid_sizes), v


def _logp_ent(logits_list, actions):
    logps, ent = 0.0, 0.0
    for i, lg in enumerate(logits_list):
        lp = torch.log_softmax(lg, dim=-1)
        logps = logps + lp.gather(1, actions[:, i:i + 1])[:, 0]
        p = lp.exp()
        ent = ent - (p * torch.where(p > 0, lp, torch.zeros_like(lp))).sum(-1)
    return logps, ent


# continuous helpers (Fig. 6 ablations) -------------------------------------

def _n_cont(mode: str, n_heads: int = 3) -> int:
    return 1 if mode == "cont1" else n_heads


def _cont_decode(raw, valid_sizes, mode):
    """Map continuous samples in R to (B, 3) action indices: the sigmoid
    of each output cut into as many equal bins as there are indices."""
    if mode == "cont1":
        u = torch.sigmoid(raw[:, 0])
        n_flat = (valid_sizes[:, 0] * valid_sizes[:, 1]
                  * valid_sizes[:, 2]).to(torch.float32)
        flat = torch.minimum((u * n_flat).to(torch.int32),
                             (n_flat - 1).to(torch.int32))
        s1 = valid_sizes[:, 1] * valid_sizes[:, 2]
        a0 = torch.div(flat, s1, rounding_mode="floor")
        a1 = torch.div(flat, valid_sizes[:, 2], rounding_mode="floor") \
            % valid_sizes[:, 1]
        a2 = flat % valid_sizes[:, 2]
        return torch.stack([a0, a1, a2], -1).long()
    u = torch.sigmoid(raw)                                    # (B, 3)
    return torch.minimum((u * valid_sizes).to(torch.int32),
                         valid_sizes - 1).long()


def _gauss(out, n):
    return out[:, :n], torch.clamp(out[:, n:], -3.0, 1.0)


def sample_continuous(out, valid_sizes, mode, eps):
    """Draw ``raw = mu + exp(logstd) * eps`` for a given standard normal
    ``eps`` (the agent draws it from its own generator): (raw, logp,
    entropy)."""
    mu, logstd = _gauss(out, _n_cont(mode, valid_sizes.shape[1]))
    raw = mu + torch.exp(logstd) * eps
    logp = (-0.5 * (eps ** 2) - logstd
            - 0.5 * math.log(2 * math.pi)).sum(-1)
    ent = (logstd + 0.5 * math.log(2 * math.pi * math.e)).sum(-1)
    return raw, logp, ent


def logp_continuous(out, raw, mode, n_heads):
    mu, logstd = _gauss(out, _n_cont(mode, n_heads))
    z = (raw - mu) / torch.exp(logstd)
    logp = (-0.5 * (z ** 2) - logstd - 0.5 * math.log(2 * math.pi)).sum(-1)
    ent = (logstd + 0.5 * math.log(2 * math.pi * math.e)).sum(-1)
    return logp, ent


def _bin_logits(n: int) -> np.ndarray:
    """(n,) raw values of the bin centres of ``n`` indices: the decode's
    inverse, ``logit((a + 0.5) / n)``."""
    u = (np.arange(n, dtype=np.float64) + 0.5) / n
    return np.log(u) - np.log1p(-u)


def _cont_joint_logdensity(mu, logstd, sizes, mode) -> np.ndarray:
    """One row's Gaussian log-density (up to a constant) at the bin centre
    of every flat action, in ``cost_grid`` order."""
    std = np.exp(logstd)
    if mode == "cont1":
        z = (_bin_logits(int(np.prod(sizes))) - mu[0]) / std[0]
        return -0.5 * z ** 2 - logstd[0]
    parts = [-0.5 * ((_bin_logits(n) - mu[h]) / std[h]) ** 2 - logstd[h]
             for h, n in enumerate(sizes)]
    return (parts[0][:, None, None] + parts[1][None, :, None]
            + parts[2][None, None, :]).reshape(-1)


@dataclass
class PPOAgent:
    nv: NeuroVecConfig
    mode: str = "discrete"
    seed: int = 0
    lr: Optional[float] = None
    device: str = "cuda"
    fused: bool = True           # False: the seed's update path (below)

    name = "ppo"

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown PPO mode {self.mode!r} (modes: "
                             f"{MODES})")
        self._dev = resolve_device(self.device)
        self.space = ActionSpace(self.nv)
        self.head_sizes = self.space.head_sizes
        init_gen = torch.Generator(device=self._dev).manual_seed(self.seed)
        self.params = agent_init(init_gen, self.nv, self.head_sizes,
                                 self._dev, self.mode)
        self.opt = self._adam_init(self.params)
        self._lr = self.lr if self.lr is not None else self.nv.lr
        self._gen = torch.Generator(device=self._dev).manual_seed(
            self.seed + 777)
        # the reference's sampling key, kept for its loader only (the port
        # samples from self._gen): a loaded state's, else one from the seed
        self._rng_key = np.array([0, (self.seed + 777) % 2 ** 32], np.uint32)
        self.history: List[dict] = []
        self.last_minibatch_count = 0

    # -- Adam (the reference's update rule, same tree) ---------------------
    @staticmethod
    def _adam_init(params):
        return {"m": _tree_map(torch.zeros_like, params),
                "v": _tree_map(torch.zeros_like, params),
                "t": torch.zeros((), dtype=torch.int32)}

    @torch.no_grad()
    def _adam_update(self, grads, b1=0.9, b2=0.999, eps=1e-8):
        t = int(self.opt["t"]) + 1
        for p, g, m, v in zip(_leaves(self.params), grads,
                              _leaves(self.opt["m"]), _leaves(self.opt["v"])):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            mhat = m / (1 - b1 ** t)
            vhat = v / (1 - b2 ** t)
            p.sub_(self._lr * mhat / (torch.sqrt(vhat) + eps))
        self.opt["t"] = torch.tensor(t, dtype=torch.int32)

    # -- featurization ----------------------------------------------------
    def feats(self, sites):
        # the seed's path (fused=False) featurizes anew on every call
        ctx, mask = emb.featurize_batch(sites, cache=self.fused)
        vs = np.array([self.space.valid_sizes(s.kind) for s in sites],
                      np.int64)
        return (torch.as_tensor(ctx, dtype=torch.long, device=self._dev),
                torch.as_tensor(mask, device=self._dev),
                torch.as_tensor(vs, device=self._dev))

    # -- acting -----------------------------------------------------------
    @property
    def continuous(self) -> bool:
        return self.mode in _CONTINUOUS

    def _forward(self, ctx, mask, vs):
        return policy_forward(self.params, self.head_sizes, ctx, mask, vs,
                              self.mode, fast_embed=self.fused)

    @torch.no_grad()
    def sample_actions(self, sites, feats=None):
        """Stochastic draw: (actions, raw, logp, value) as numpy arrays;
        ``raw`` is the continuous sample (the actions as floats in the
        categorical modes)."""
        ctx, mask, vs = feats if feats is not None else self.feats(sites)
        out, v = self._forward(ctx, mask, vs)
        if self.continuous:
            n = _n_cont(self.mode, len(self.head_sizes))
            eps = torch.randn((out.shape[0], n), generator=self._gen,
                              device=self._dev)
            raw, logp, _ = sample_continuous(out, vs, self.mode, eps)
            a = _cont_decode(raw, vs, self.mode).cpu().numpy()
            return (a, raw.cpu().numpy(), logp.cpu().numpy(),
                    v.cpu().numpy())
        acts = torch.stack([torch.multinomial(torch.softmax(lg, -1), 1,
                                              generator=self._gen)[:, 0]
                            for lg in out], -1)
        logp, _ = _logp_ent(out, acts)
        a = acts.cpu().numpy()
        return a, a.astype(np.float32), logp.cpu().numpy(), v.cpu().numpy()

    @torch.no_grad()
    def act(self, sites, *, sample: bool = False, feats=None,
            legal=None) -> np.ndarray:
        """(n, 3) action indices; ``sample=False`` is greedy deployment.

        ``legal`` ((n, A) bool over flat actions, laid out as
        ``CostModelEnv.cost_grid``) restricts the greedy pick to legal
        actions; a row with none raises ``ValueError``.  In the
        categorical modes the pick is the most probable legal joint
        action, which with every action legal is the per-head argmax.  In
        ``cont1``/``cont2`` it is the decode of the mean when that is
        legal; otherwise the legal flat action whose bin centre, mapped
        back to raw space through the decode's inverse (``logit((a +
        0.5) / n)`` per head), has the highest Gaussian log-density under
        ``(mu, exp(logstd))``, the first such on ties.  So with every
        action legal the pick is the reference's greedy decode."""
        if sample:
            return self.sample_actions(sites, feats=feats)[0]
        return self._greedy(sites, feats, legal)

    @torch.no_grad()
    def _greedy(self, sites, feats, legal) -> np.ndarray:
        ctx, mask, vs = feats if feats is not None else self.feats(sites)
        out, _ = self._forward(ctx, mask, vs)
        keys = [s.key() for s in sites]
        if self.continuous:
            n = _n_cont(self.mode, len(self.head_sizes))
            greedy = _cont_decode(out[:, :n], vs, self.mode).cpu().numpy()
            if legal is None:
                return greedy
            mu, logstd = (t.double().cpu().numpy() for t in _gauss(out, n))
            return self._masked_continuous(greedy, mu, logstd,
                                           vs.cpu().numpy(), legal, keys)
        if legal is None:
            return torch.stack([lg.argmax(-1) for lg in out],
                               -1).cpu().numpy()
        return self._masked_categorical(
            [torch.log_softmax(lg, -1).cpu().numpy() for lg in out],
            vs.cpu().numpy(), legal, keys)

    @staticmethod
    def _masked_categorical(lp, vs, legal, keys) -> np.ndarray:
        legal = np.asarray(legal, bool)
        out = np.empty((len(keys), 3), np.int64)
        for i, key in enumerate(keys):
            s0, s1, s2 = (int(x) for x in vs[i])
            joint = (lp[0][i, :s0, None, None] + lp[1][i, None, :s1, None]
                     + lp[2][i, None, None, :s2]).reshape(-1)
            ok = legal[i, :joint.size]
            if not ok.any():
                raise ValueError(f"no legal action for site {key}")
            flat = int(np.argmax(np.where(ok, joint, -np.inf)))
            out[i] = (flat // (s1 * s2), (flat // s2) % s1, flat % s2)
        return out

    def _masked_continuous(self, greedy, mu, logstd, vs, legal,
                           keys) -> np.ndarray:
        legal = np.asarray(legal, bool)
        out = greedy.astype(np.int64)
        for i, key in enumerate(keys):
            sizes = tuple(int(x) for x in vs[i])
            s0, s1, s2 = sizes
            ok = legal[i, :s0 * s1 * s2]
            if not ok.any():
                raise ValueError(f"no legal action for site {key}")
            a = out[i]
            if ok[(a[0] * s1 + a[1]) * s2 + a[2]]:
                continue
            dens = _cont_joint_logdensity(mu[i], logstd[i], sizes, self.mode)
            flat = int(np.argmax(np.where(ok, dens, -np.inf)))
            out[i] = (flat // (s1 * s2), (flat // s2) % s1, flat % s2)
        return out

    def act_bucketed(self, sites, *, bucket: Optional[int] = None,
                     feats=None, legal=None) -> np.ndarray:
        """Greedy :meth:`act` with the batch padded to ``bucket`` rows by
        repeating row 0 (``legal`` likewise), for the serving batcher;
        returns the first ``n`` rows.  The forward is row-independent, so
        a row's action is :meth:`act`'s (a different batch size may take
        another matmul algorithm, so a logit may differ in its last bits
        and flip a near-tie)."""
        n = len(sites)
        ctx, mask, vs = feats if feats is not None else self.feats(sites)
        if bucket is not None and bucket > n and n:
            pad = bucket - n
            ctx, mask, vs = (torch.cat([t, t[:1].expand(pad, *t.shape[1:])])
                             for t in (ctx, mask, vs))
            sites = list(sites) + [sites[0]] * pad
            if legal is not None:
                legal = np.asarray(legal, bool)
                legal = np.concatenate([legal, np.repeat(legal[:1], pad, 0)])
        return self._greedy(sites, (ctx, mask, vs), legal)[:n]

    @torch.no_grad()
    def code_vectors(self, sites) -> np.ndarray:
        """(n, EMBED_DIM) code vectors of the agent's embedder (the
        ``embed_fn`` of nns/dtree in the paper's frozen-after-RL setup)."""
        ctx, mask, _ = self.feats(sites)
        return emb.embed_sites(self.params["embedder"], ctx,
                               mask).cpu().numpy()

    # -- PPO update ---------------------------------------------------------
    def _loss(self, ctx, mask, vs, actions, raw, old_logp, rewards):
        out, v = self._forward(ctx, mask, vs)
        if self.continuous:
            logp, ent = logp_continuous(out, raw, self.mode,
                                        len(self.head_sizes))
        else:
            logp, ent = _logp_ent(out, actions)
        adv = rewards - v.detach()
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-6)
        ratio = torch.exp(logp - old_logp)
        clipped = torch.clamp(ratio, 1 - self.nv.clip, 1 + self.nv.clip)
        pg = -torch.minimum(ratio * adv, clipped * adv).mean()
        vloss = ((v - rewards) ** 2).mean()
        return (pg + self.nv.value_coef * vloss
                - self.nv.entropy_coef * ent.mean())

    def _step(self, data, sl):
        leaves = _leaves(self.params)
        for p in leaves:
            p.requires_grad_(True)
        loss = self._loss(*(d[sl] for d in data))
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        self._adam_update(grads)
        self.last_minibatch_count += 1
        return float(loss.detach())

    def update(self, sites, actions, raw, old_logp, rewards, feats=None):
        """PPO epochs over shuffled minibatches, the tail included; with
        ``fused=False`` the seed's loop, which drops the tail.  Returns
        the mean of the minibatches' losses."""
        ctx, mask, vs = feats if feats is not None else self.feats(sites)
        dev = self._dev
        data = (ctx, mask, vs, torch.as_tensor(actions, device=dev).long(),
                torch.as_tensor(raw, dtype=torch.float32, device=dev),
                torch.as_tensor(old_logp, device=dev),
                torch.as_tensor(rewards, dtype=torch.float32, device=dev))
        n = len(sites)
        mb = min(self.nv.sgd_minibatch, n)
        losses = []
        self.last_minibatch_count = 0
        # the seed's loop stops before a tail shorter than a minibatch
        end = n if self.fused else n - mb + 1
        for _ in range(self.nv.ppo_epochs):
            perm = torch.randperm(n, generator=self._gen, device=dev)
            for i in range(0, end, mb):
                losses.append(self._step(data, perm[i:i + mb]))
        return float(np.mean(losses))

    # -- Agent protocol -----------------------------------------------------
    def fit(self, sites, oracle, *, total_steps: Optional[int] = None,
            batch: Optional[int] = None, log_every: int = 1,
            rng_seed: int = 0) -> "PPOAgent":
        """Train against ``oracle``; default budget 10 training batches.
        ``log_every`` is accepted and unused, as in the reference."""
        self.train(sites, oracle,
                   total_steps=total_steps or 10 * self.nv.train_batch,
                   batch=batch, log_every=log_every, rng_seed=rng_seed)
        return self

    def train(self, sites, env, total_steps: int,
              batch: Optional[int] = None, log_every: int = 1,
              rng_seed: int = 0):
        batch = batch or self.nv.train_batch
        rng = np.random.default_rng(rng_seed)
        steps = 0
        while steps < total_steps:
            idx = rng.integers(0, len(sites),
                               size=min(batch, total_steps - steps))
            batch_sites = [sites[i] for i in idx]
            feats = self.feats(batch_sites)
            a, raw, logp, _ = self.sample_actions(batch_sites, feats=feats)
            rewards = env.rewards_batch(batch_sites, a)
            loss = self.update(batch_sites, a, raw, logp, rewards,
                               feats=feats)
            steps += len(batch_sites)
            self.history.append({"steps": steps,
                                 "reward_mean": float(rewards.mean()),
                                 "loss": loss})
        return self.history

    # -- persistence ----------------------------------------------------------
    def state_dict(self) -> dict:
        """Params, Adam state, lr and mode in the reference's layout
        (numpy), with an ``rng_key`` so that the reference loads it."""
        to_np = lambda t: t.detach().cpu().numpy()
        return {"version": AGENT_STATE_VERSION, "name": self.name,
                "mode": self.mode, "lr": float(self._lr),
                "params": _tree_map(to_np, self.params),
                "opt": _tree_map(to_np, self.opt),
                "rng_key": self._rng_key.copy()}

    def load_state(self, state: dict, seed: Optional[int] = None
                   ) -> "PPOAgent":
        """Load a ``state_dict`` of this package or of the JAX package
        (leaves as numpy arrays).  Params and opt are taken verbatim; the
        reference's ``rng_key`` cannot drive a ``torch.Generator``, so the
        sampling stream is re-seeded from ``seed`` (default: the agent's);
        the key is kept, and :meth:`state_dict` writes it back."""
        check_agent_state(state, self.name)
        if state["mode"] != self.mode:
            raise ValueError(f"state was trained in mode {state['mode']!r}; "
                             f"this agent is {self.mode!r}")
        for attr in ("params", "opt"):
            have, new = _leaves(getattr(self, attr)), _leaves(state[attr])
            if len(have) != len(new) or any(
                    tuple(np.shape(a)) != tuple(np.shape(b))
                    for a, b in zip(have, new)):
                raise ValueError(f"{attr} structure mismatch: the state was "
                                 f"saved under a different config/network")
        def leaf(a):        # a copy: JAX's numpy leaves are read-only
            return torch.tensor(np.array(a, np.float32), device=self._dev)
        opt = state["opt"]
        self.params = _tree_map(leaf, state["params"])
        self.opt = {"m": _tree_map(leaf, opt["m"]),
                    "v": _tree_map(leaf, opt["v"]),
                    "t": torch.tensor(int(np.asarray(opt["t"])),
                                      dtype=torch.int32)}
        self._gen = torch.Generator(device=self._dev).manual_seed(
            (self.seed if seed is None else seed) + 777)
        if "rng_key" in state:
            self._rng_key = np.array(state["rng_key"], np.uint32)
        self._lr = float(state["lr"])
        return self
