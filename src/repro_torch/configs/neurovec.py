"""The paper's own configuration: NeuroVectorizer RL hyperparameters
(§4 Evaluation) mapped onto the tile-tuning action space.  A copy of the
JAX package's ``configs/neurovec.py``: the action space is shared, so a
``TileProgram`` tuned by either package names the same tiles.
"""
from dataclasses import asdict, dataclass, fields
from typing import Tuple


@dataclass(frozen=True)
class NeuroVecConfig:
    # --- action space: power-of-two tile factors (the VF/IF analogue) ---
    # matmul sites: (block_m, block_n, block_k); attention: (block_q, block_kv)
    # over-aggressive factors "fail to compile", giving the -9 penalty a live
    # region of the action space exactly as over-vectorization does (§3.4)
    bm_choices: Tuple[int, ...] = (8, 16, 32, 64, 128, 256, 512)
    bn_choices: Tuple[int, ...] = (128, 256, 512)
    bk_choices: Tuple[int, ...] = (128, 256, 512, 1024, 2048, 4096)
    bq_choices: Tuple[int, ...] = (64, 128, 256, 512, 1024)
    bkv_choices: Tuple[int, ...] = (128, 256, 512, 1024, 2048)
    chunk_choices: Tuple[int, ...] = (64, 128, 256, 512, 1024)

    # --- embedding (code2vec analogue) ---
    embed_dim: int = 340            # paper: 340-feature code vector
    n_path_tokens: int = 64         # vocabulary of operand/primitive tokens
    max_paths: int = 32             # path-contexts per site

    # --- PPO (paper §4 defaults) ---
    hidden: Tuple[int, ...] = (64, 64)   # 64x64 FCNN
    lr: float = 5e-5
    train_batch: int = 4000
    sgd_minibatch: int = 128
    ppo_epochs: int = 8
    clip: float = 0.2
    entropy_coef: float = 0.01
    value_coef: float = 0.5

    # --- environment (reward eq. 2, §3.4 penalty) ---
    fail_penalty: float = -9.0      # illegal tile == compile timeout
    illegal_slowdown: float = 10.0  # an illegal tile "runs" this many times
                                    # slower than baseline
    reward_noise: float = 0.0       # measurement-noise injection for tests
    strict_actions: bool = False    # raise on out-of-range action indices

    # --- dataset (§3.2) ---
    n_synthetic: int = 10_000
    train_subset: int = 5_000
    test_frac: float = 0.2


DEFAULT = NeuroVecConfig()


def cfg_to_dict(cfg: NeuroVecConfig) -> dict:
    """JSON-serializable snapshot of a config (tuples become lists)."""
    return asdict(cfg)


def cfg_from_dict(d: dict) -> NeuroVecConfig:
    """Inverse of :func:`cfg_to_dict`; rejects unknown keys."""
    known = {f.name for f in fields(NeuroVecConfig)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"unknown NeuroVecConfig fields: {unknown}")
    return NeuroVecConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in d.items()})
