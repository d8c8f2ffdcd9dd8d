"""Learned cost model trained from the persistent ``MeasureDB`` (the port
of ``repro/surrogate``).

The paper's conjecture is that a learned model predicts the actual cost
better than a fixed-cost heuristic.  Every timing the measured oracle
takes is persisted in the ``MeasureDB``, so the training corpus grows for
free:

* :mod:`~repro_torch.surrogate.features`: a fixed numeric featurizer over
  ``(site, tiles)``, bitwise the reference's;
* :mod:`~repro_torch.surrogate.dataset`: the corpus builder over finite
  ``MeasureDB`` records (quarantined and corrupt entries skipped);
* :mod:`~repro_torch.surrogate.model`: a small MLP ensemble trained with
  :mod:`repro_torch.optim.adamw`, checkpointed in the reference's
  ``artifacts/agentio`` format, on the card unless ``device="cpu"``;
* :mod:`~repro_torch.surrogate.oracle`: :class:`SurrogateOracle`, the
  model behind the ``Oracle`` protocol.

The payoff is **grid pruning**: ``MeasuredEnv(prune_topk=N, surrogate=)``
lets the surrogate rank each site's legal grid and times only the top-k
candidates (and the baseline tile); the rest are priced by the surrogate.
"""
from repro_torch.surrogate.dataset import Corpus, build_corpus, parse_key
from repro_torch.surrogate.features import N_FEATURES, featurize
from repro_torch.surrogate.model import (SurrogateModel, load_surrogate,
                                         save_surrogate, train_from_db,
                                         train_surrogate)
from repro_torch.surrogate.oracle import SurrogateOracle

__all__ = [
    "Corpus", "N_FEATURES", "SurrogateModel", "SurrogateOracle",
    "build_corpus", "featurize", "load_surrogate", "parse_key",
    "save_surrogate", "train_from_db", "train_surrogate",
]
