"""Activation records + explanation scoring (the OpenAI autointerp protocol).

Counterpart of `sparse_coding__tpu/interp/records.py`, a copy (plain
dataclasses + numpy): per-feature activation records over text fragments,
explanation simulation, and the "preferred score" — the correlation between
simulated and true activations (Bills et al. 2023). The LLM calls live
behind `interp.clients`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

# protocol constants
OPENAI_MAX_FRAGMENTS = 50000
OPENAI_FRAGMENT_LEN = 64
OPENAI_EXAMPLES_PER_SPLIT = 5
N_SPLITS = 4
TOTAL_EXAMPLES = OPENAI_EXAMPLES_PER_SPLIT * N_SPLITS
REPLACEMENT_CHAR = "�"


@dataclasses.dataclass
class ActivationRecord:
    tokens: List[str]
    activations: List[float]


@dataclasses.dataclass
class NeuronRecord:
    """Top + random activation records for one feature."""

    feature_index: int
    most_positive_activation_records: List[ActivationRecord]
    random_sample: List[ActivationRecord]

    def train_records(self, per_split: int = OPENAI_EXAMPLES_PER_SPLIT) -> List[ActivationRecord]:
        """Half the top + half the random records (explainer input)."""
        return (
            self.most_positive_activation_records[:per_split]
            + self.random_sample[:per_split]
        )

    def valid_records(self, per_split: int = OPENAI_EXAMPLES_PER_SPLIT) -> List[ActivationRecord]:
        """Held-out top + random records (simulator scoring input)."""
        return (
            self.most_positive_activation_records[per_split : 2 * per_split]
            + self.random_sample[per_split : 2 * per_split]
        )


def calculate_max_activation(records: Sequence[ActivationRecord]) -> float:
    return max((max(r.activations) for r in records), default=0.0)


@dataclasses.dataclass
class SequenceSimulation:
    tokens: List[str]
    true_activations: List[float]
    simulated_activations: List[float]


@dataclasses.dataclass
class ScoredSimulation:
    explanation: str
    sequence_simulations: List[SequenceSimulation]

    def get_preferred_score(self) -> float:
        return aggregate_scored_sequence_simulations(self.sequence_simulations)


def aggregate_scored_sequence_simulations(
    sims: Sequence[SequenceSimulation],
) -> float:
    """Correlation between simulated and true activations, pooled over all
    sequences — the protocol's preferred score (ev_correlation_score)."""
    true = np.concatenate([np.asarray(s.true_activations, dtype=np.float64) for s in sims])
    pred = np.concatenate([np.asarray(s.simulated_activations, dtype=np.float64) for s in sims])
    if true.std() < 1e-9 or pred.std() < 1e-9:
        return 0.0
    return float(np.corrcoef(true, pred)[0, 1])
