"""PPO contextual bandit in PyTorch (paper §2.3, §3.3, §4); the port of
``repro/core/agents/ppo.py`` in its ``discrete`` mode (three masked
categorical heads over the factor indices, the configuration the paper
found best).  The continuous ablation modes wait.

One episode = one site.  A single network embeds the site (code2vec
analogue, trained end to end) and emits a joint action.  The parameter
tree and the Adam state have the reference's structure, so a JAX
``state_dict()`` loads verbatim; the sampling stream is a
``torch.Generator`` (JAX's random bits cannot be reproduced), so training
agrees with the reference only statistically while greedy acting from
the same weights agrees exactly.
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

MODES = ("discrete",)


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


def agent_init(gen, nv: NeuroVecConfig, head_sizes, device):
    hid = list(nv.hidden)
    return {"embedder": emb.embedder_init(gen, device),
            "trunk": _mlp_init(gen, [emb.EMBED_DIM] + hid, device),
            "pi": _mlp_init(gen, [hid[-1], sum(head_sizes)], device),
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


def policy_forward(params, head_sizes, contexts, mask, valid_sizes):
    code = emb.embed_sites(params["embedder"], contexts, mask)
    h = torch.tanh(_mlp(params["trunk"], code))
    out = _mlp(params["pi"], h)
    v = _mlp(params["vf"], h)[:, 0]
    return _head_logits(head_sizes, out, valid_sizes), v


def _logp_ent(logits_list, actions):
    logps, ent = 0.0, 0.0
    for i, lg in enumerate(logits_list):
        lp = torch.log_softmax(lg, dim=-1)
        logps = logps + lp.gather(1, actions[:, i:i + 1])[:, 0]
        p = lp.exp()
        ent = ent - (p * torch.where(p > 0, lp, torch.zeros_like(lp))).sum(-1)
    return logps, ent


@dataclass
class PPOAgent:
    nv: NeuroVecConfig
    mode: str = "discrete"
    seed: int = 0
    lr: Optional[float] = None
    device: str = "cuda"

    name = "ppo"

    def __post_init__(self):
        if self.mode not in MODES:
            raise NotImplementedError(f"PPO mode {self.mode!r} is not ported "
                                      f"yet (ported: {MODES})")
        self._dev = resolve_device(self.device)
        self.space = ActionSpace(self.nv)
        self.head_sizes = self.space.head_sizes
        init_gen = torch.Generator(device=self._dev).manual_seed(self.seed)
        self.params = agent_init(init_gen, self.nv, self.head_sizes,
                                 self._dev)
        self.opt = self._adam_init(self.params)
        self._lr = self.lr if self.lr is not None else self.nv.lr
        self._gen = torch.Generator(device=self._dev).manual_seed(
            self.seed + 777)
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
        ctx, mask = emb.featurize_batch(sites)
        vs = np.array([self.space.valid_sizes(s.kind) for s in sites],
                      np.int64)
        return (torch.as_tensor(ctx, dtype=torch.long, device=self._dev),
                torch.as_tensor(mask, device=self._dev),
                torch.as_tensor(vs, device=self._dev))

    # -- acting -----------------------------------------------------------
    @torch.no_grad()
    def sample_actions(self, sites, feats=None):
        """Stochastic draw: (actions, raw, logp, value) as numpy arrays."""
        ctx, mask, vs = feats if feats is not None else self.feats(sites)
        logits, v = policy_forward(self.params, self.head_sizes, ctx, mask,
                                   vs)
        acts = torch.stack([torch.multinomial(torch.softmax(lg, -1), 1,
                                              generator=self._gen)[:, 0]
                            for lg in logits], -1)
        logp, _ = _logp_ent(logits, acts)
        a = acts.cpu().numpy()
        return a, a.astype(np.float32), logp.cpu().numpy(), v.cpu().numpy()

    @torch.no_grad()
    def act(self, sites, *, sample: bool = False, feats=None,
            legal=None) -> np.ndarray:
        """(n, 3) action indices; ``sample=False`` is greedy deployment.

        ``legal`` ((n, A) bool over flat actions, laid out as
        ``CostModelEnv.cost_grid``) restricts the greedy pick to the most
        probable legal joint action; with every action legal that is the
        per-head argmax."""
        if sample:
            return self.sample_actions(sites, feats=feats)[0]
        ctx, mask, vs = feats if feats is not None else self.feats(sites)
        logits, _ = policy_forward(self.params, self.head_sizes, ctx, mask,
                                   vs)
        if legal is None:
            return torch.stack([lg.argmax(-1) for lg in logits],
                               -1).cpu().numpy()
        legal = np.asarray(legal, bool)
        lp = [torch.log_softmax(lg, -1).cpu().numpy() for lg in logits]
        out = np.empty((len(sites), 3), np.int64)
        for i, s in enumerate(sites):
            s0, s1, s2 = self.space.valid_sizes(s.kind)
            joint = (lp[0][i, :s0, None, None] + lp[1][i, None, :s1, None]
                     + lp[2][i, None, None, :s2]).reshape(-1)
            ok = legal[i, :joint.size]
            if not ok.any():
                raise ValueError(f"no legal action for site {s.key()}")
            flat = int(np.argmax(np.where(ok, joint, -np.inf)))
            out[i] = self.space.unflatten(s.kind, flat)
        return out

    @torch.no_grad()
    def code_vectors(self, sites) -> np.ndarray:
        """(n, EMBED_DIM) code vectors of the agent's embedder (the
        ``embed_fn`` of nns/dtree in the paper's frozen-after-RL setup)."""
        ctx, mask, _ = self.feats(sites)
        return emb.embed_sites(self.params["embedder"], ctx,
                               mask).cpu().numpy()

    # -- PPO update ---------------------------------------------------------
    def _loss(self, ctx, mask, vs, actions, old_logp, rewards):
        logits, v = policy_forward(self.params, self.head_sizes, ctx, mask,
                                   vs)
        logp, ent = _logp_ent(logits, actions)
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
        """PPO epochs over shuffled minibatches, the tail included."""
        ctx, mask, vs = feats if feats is not None else self.feats(sites)
        dev = self._dev
        data = (ctx, mask, vs, torch.as_tensor(actions, device=dev).long(),
                torch.as_tensor(old_logp, device=dev),
                torch.as_tensor(rewards, dtype=torch.float32, device=dev))
        n = len(sites)
        mb = min(self.nv.sgd_minibatch, n)
        losses = []
        self.last_minibatch_count = 0
        for _ in range(self.nv.ppo_epochs):
            perm = torch.randperm(n, generator=self._gen, device=dev)
            for i in range(0, n, mb):
                losses.append(self._step(data, perm[i:i + mb]))
        return float(np.mean(losses))

    # -- Agent protocol -----------------------------------------------------
    def fit(self, sites, oracle, *, total_steps: Optional[int] = None,
            batch: Optional[int] = None, rng_seed: int = 0) -> "PPOAgent":
        """Train against ``oracle``; default budget 10 training batches."""
        self.train(sites, oracle,
                   total_steps=total_steps or 10 * self.nv.train_batch,
                   batch=batch, rng_seed=rng_seed)
        return self

    def train(self, sites, env, total_steps: int,
              batch: Optional[int] = None, rng_seed: int = 0):
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
        """Params, Adam state and lr in the reference's layout (numpy)."""
        to_np = lambda t: t.detach().cpu().numpy()
        return {"version": AGENT_STATE_VERSION, "name": self.name,
                "mode": self.mode, "lr": float(self._lr),
                "params": _tree_map(to_np, self.params),
                "opt": _tree_map(to_np, self.opt)}

    def load_state(self, state: dict, seed: Optional[int] = None
                   ) -> "PPOAgent":
        """Load a ``state_dict`` of this package or of the JAX package
        (leaves as numpy arrays).  Params and opt are taken verbatim; the
        reference's ``rng_key`` cannot drive a ``torch.Generator``, so the
        sampling stream is re-seeded from ``seed`` (default: the agent's)."""
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
        self._lr = float(state["lr"])
        return self
