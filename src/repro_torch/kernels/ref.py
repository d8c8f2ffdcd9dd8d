"""Plain PyTorch oracles for the kernels (the allclose targets); the
counterparts of ``repro/kernels/ref.py``."""
from __future__ import annotations

import torch


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (x.float() @ w.float()).to(x.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, scale: float) -> torch.Tensor:
    """q: (B,H,Sq,D); k,v: (B,H,Skv,D) (heads already expanded)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        Sq, Skv = q.shape[2], k.shape[2]
        kpos = torch.arange(Skv, device=q.device)
        qpos = torch.arange(Sq, device=q.device) + (Skv - Sq)
        s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def chunk_scan_ref(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                   la: torch.Tensor) -> torch.Tensor:
    """Sequential oracle for the SSD scan, in f32.  x (G,S,P); Bm/Cm
    (G,S,N); la (G,S) log-decay.  -> y (G,S,P) in ``x.dtype``."""
    G, S, P = x.shape
    N = Bm.shape[-1]
    xf, bf, cf, lf = (t.float() for t in (x, Bm, Cm, la))
    state = torch.zeros((G, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        state = (state * torch.exp(lf[:, t])[:, None, None]
                 + xf[:, t, :, None] * bf[:, t, None, :])
        ys.append(torch.einsum("gpn,gn->gp", state, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype)
