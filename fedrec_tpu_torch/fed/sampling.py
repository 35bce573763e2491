"""Seeded, checkpointable per-round cohort sampling over a logical-client
population: a numpy copy of ``fedrec_tpu/fed/sampling.py``, so that both
packages draw the same cohorts from the same seeds.

* **deterministic**: a draw is a pure function of ``(seed, round_idx,
  attempt)`` and the sampler's fairness state, so a quorum re-draw
  (``attempt`` + 1) is itself reproducible;
* **checkpointable**: ``state_dict`` / ``load_state_dict`` round-trip the
  mutable state (the selection counts, the committed-round counter);
* **priority-ordered**: ids come in descending draw priority, so the cohort
  packer fills slots front to back and the over-selected spares are the
  tail of the draw.

Modes (``fed.population.sampler``): ``uniform`` (Gumbel-top-k over zero
log-weights), ``weighted`` (log of the client's sample count) and ``skew``
(``-log1p(times_selected)``: rarely seen clients first, so coverage
flattens over rounds).

The degenerate contract: when ``k`` covers every eligible client the draw
returns the eligible ids in ascending order, so population == slots packs
client *i* into slot *i* every round and nothing is swapped.
"""

from __future__ import annotations

import numpy as np

SAMPLER_MODES = ("uniform", "weighted", "skew")


def validate_sampler_mode(mode: str) -> str:
    if mode not in SAMPLER_MODES:
        raise ValueError(
            f"unknown fed.population.sampler {mode!r}; expected one of "
            f"{SAMPLER_MODES}"
        )
    return mode


class CohortSampler:
    """Per-round cohort draws over ``population`` logical clients."""

    def __init__(
        self,
        population: int,
        mode: str = "uniform",
        seed: int = 0,
        sample_counts: np.ndarray | None = None,
        skew_strength: float = 1.0,
    ):
        if population <= 0:
            raise ValueError(f"population must be positive, got {population}")
        validate_sampler_mode(mode)
        self.population = int(population)
        self.mode = mode
        self.seed = int(seed)
        self.skew_strength = float(skew_strength)
        if sample_counts is None:
            sample_counts = np.ones((self.population,), np.int64)
        sample_counts = np.asarray(sample_counts, np.int64)
        if sample_counts.shape != (self.population,):
            raise ValueError(
                f"sample_counts shape {sample_counts.shape} != "
                f"({self.population},)"
            )
        if mode == "weighted" and not (sample_counts > 0).any():
            raise ValueError("weighted sampling needs >= 1 positive count")
        self.sample_counts = sample_counts
        # the mutable fairness state: what a checkpoint holds
        self.selection_counts = np.zeros((self.population,), np.int64)
        self.rounds_committed = 0

    def _log_weights(self) -> np.ndarray:
        if self.mode == "uniform":
            return np.zeros((self.population,), np.float64)
        if self.mode == "weighted":
            return np.log(np.maximum(self.sample_counts, 1).astype(np.float64))
        return -self.skew_strength * np.log1p(self.selection_counts.astype(np.float64))

    def draw(
        self,
        round_idx: int,
        k: int,
        exclude: set | frozenset | tuple = (),
        attempt: int = 0,
    ) -> np.ndarray:
        """``min(k, eligible)`` distinct client ids for one round. Pure in
        ``(seed, round_idx, attempt)`` and the fairness state; changes
        nothing (``record`` commits a round once it is accepted)."""
        eligible = np.ones((self.population,), bool)
        for c in exclude:
            if 0 <= int(c) < self.population:
                eligible[int(c)] = False
        n_eligible = int(eligible.sum())
        if n_eligible == 0:
            return np.zeros((0,), np.int64)
        ids = np.nonzero(eligible)[0]
        if k >= n_eligible:
            return ids.astype(np.int64)  # the degenerate contract
        rng = np.random.default_rng([self.seed, int(round_idx), int(attempt), 0xC0407])
        # Gumbel-top-k: a sample without replacement proportional to
        # exp(log-weights), in one vectorized draw
        keys = self._log_weights() + rng.gumbel(size=self.population)
        keys[~eligible] = -np.inf
        order = np.argsort(-keys, kind="stable")
        return order[:k].astype(np.int64)

    def record(self, cohort: np.ndarray) -> None:
        """Commit one round's cohort into the fairness state."""
        cohort = np.asarray(cohort, np.int64)
        if cohort.size:
            np.add.at(self.selection_counts, cohort, 1)
        self.rounds_committed += 1

    def state_dict(self) -> dict:
        return {
            "population": np.int64(self.population),
            "mode": self.mode,
            "seed": np.int64(self.seed),
            "selection_counts": self.selection_counts.copy(),
            "rounds_committed": np.int64(self.rounds_committed),
        }

    def load_state_dict(self, state: dict) -> None:
        pop = int(state["population"])
        mode = str(state["mode"])
        if pop != self.population or mode != self.mode:
            raise ValueError(
                f"sampler state mismatch: saved (population={pop}, "
                f"mode={mode!r}) vs configured "
                f"(population={self.population}, mode={self.mode!r}) — the "
                "snapshot was written under a different fed.population "
                "config"
            )
        if int(state["seed"]) != self.seed:
            print(
                "[sampling] WARNING: restored sampler seed "
                f"{int(state['seed'])} != configured {self.seed}; the "
                "resumed schedule follows the CONFIGURED seed"
            )
        counts = np.asarray(state["selection_counts"], np.int64)
        if counts.shape != (self.population,):
            raise ValueError(
                f"restored selection_counts shape {counts.shape} != "
                f"({self.population},)"
            )
        self.selection_counts = counts.copy()
        self.rounds_committed = int(state["rounds_committed"])
