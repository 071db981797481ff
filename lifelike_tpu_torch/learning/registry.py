"""Model pool + league manager + training checkpoints: the host-side
TLeague replacement.

Port of lifelike_tpu.learning.registry. The reference scales self-play
through model_pool, league_mgr and hyperparameter-manager services
(SURVEY.md section 2.3); with on-device rollouts they shrink to a small
host-side registry.

  * ModelPool — keyed parameter snapshots. A snapshot is a Flax-layout
    tree of numpy arrays (`{"params": {...}}`), and a file is a pickle of
    `{"model": tree, "meta": {...}}` — the JAX package's format, so a file
    written by either package is read by the other
    (models.params.flax_tree gives a port net's tree).
  * LeagueManager — the reference's SelfPlayGameMgr (always the latest
    model) and PFSPGameMgr (opponents weighted by (1 - win_rate)^p,
    example_sepmc_train.sh:14), on a numpy Generator: plain numpy, so the
    same generator gives the JAX package's sequence.
  * TrainCheckpoint — the learner's whole state for an exact resume, in
    the port's own format (torch.save of CPU tensors, numpy and Python
    values); compat/from_jax.read_train_checkpoint reads the JAX package's.

The JAX package's ShardedTrainCheckpoint (per-rank shards of a
multi-process run) has no counterpart yet: the port trains on one device.
"""
import os
import pickle
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from lifelike_tpu_torch.learning.replay import tree_map


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


class ModelPool:
    """Keyed parameter store with optional directory persistence."""

    def __init__(self, root: Optional[str] = None):
        self._models: Dict[str, Any] = {}
        self._meta: Dict[str, dict] = {}
        self.root = root
        if root:
            os.makedirs(root, exist_ok=True)

    def push(self, key: str, params, meta: Optional[dict] = None, persist=False):
        self._models[key] = _to_numpy(params)
        self._meta[key] = dict(meta or {}, updated_at=time.time())
        if persist and self.root:
            self.save(key)

    def pull(self, key: str):
        if key not in self._models and self.root:
            self.load(key)
        return self._models[key]

    def keys(self) -> List[str]:
        return list(self._models.keys())

    def save(self, key: str):
        assert self.root, "ModelPool has no persistence root"
        with open(os.path.join(self.root, f"{key}.model"), "wb") as f:
            pickle.dump({"model": self._models[key], "meta": self._meta[key]}, f)

    def load(self, key: str):
        with open(os.path.join(self.root, f"{key}.model"), "rb") as f:
            blob = pickle.load(f)
        self._models[key] = blob["model"]
        self._meta[key] = blob.get("meta", {})
        return self._models[key]

    def load_file(self, key: str, path: str):
        """Seed a model from an explicit file (stage hand-off, reference
        --init_model_paths example_sepmc_train.sh:141)."""
        with open(path, "rb") as f:
            blob = pickle.load(f)
        self._models[key] = blob["model"] if isinstance(blob, dict) else blob
        self._meta[key] = blob.get("meta", {}) if isinstance(blob, dict) else {}
        return self._models[key]


class LeagueManager:
    """Population of frozen models + PFSP match-making + win statistics."""

    def __init__(self, pool: ModelPool, game_mgr_type: str = "self_play", pfsp_power: float = 1.0,
                 checkpoint_dir: Optional[str] = None):
        self.pool = pool
        self.game_mgr_type = game_mgr_type  # {'self_play', 'pfsp'}
        self.pfsp_power = pfsp_power
        self.checkpoint_dir = checkpoint_dir
        self.population: List[str] = []
        # win counts of the learner vs each frozen opponent
        self.wins: Dict[str, int] = {}
        self.games: Dict[str, int] = {}

    def add_to_population(self, key: str):
        if key not in self.population:
            self.population.append(key)
            self.wins.setdefault(key, 0)
            self.games.setdefault(key, 0)

    def report_outcome(self, opponent_key: str, learner_won: bool):
        self.games[opponent_key] = self.games.get(opponent_key, 0) + 1
        self.wins[opponent_key] = self.wins.get(opponent_key, 0) + int(learner_won)

    def report_games(self, opponent_key: str, wins: int, games: int):
        """Batch outcome reporting: per-EPISODE game results (the reference
        counts actual game endings, not per-update return signs)."""
        self.games[opponent_key] = self.games.get(opponent_key, 0) + int(games)
        self.wins[opponent_key] = self.wins.get(opponent_key, 0) + int(wins)

    def win_rate(self, key: str) -> float:
        g = self.games.get(key, 0)
        return self.wins.get(key, 0) / g if g else 0.5

    def sample_opponent(self, rng: np.random.Generator) -> str:
        if not self.population:
            raise ValueError("empty population")
        if self.game_mgr_type == "self_play":
            return self.population[-1]
        # PFSP: weight by (1 - win_rate)^p — prefer opponents we lose to
        w = np.array([(1.0 - self.win_rate(k)) ** self.pfsp_power for k in self.population])
        w = w + 1e-6
        return str(rng.choice(self.population, p=w / w.sum()))

    def state(self):
        return {"population": list(self.population), "wins": dict(self.wins),
                "games": dict(self.games), "game_mgr_type": self.game_mgr_type}

    def load_state(self, state):
        self.population = list(state["population"])
        self.wins = dict(state["wins"])
        self.games = dict(state["games"])

    def checkpoint(self):
        if not self.checkpoint_dir:
            return
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        with open(os.path.join(self.checkpoint_dir, "league.pkl"), "wb") as f:
            pickle.dump(self.state(), f)
        for k in self.population:
            if self.pool.root:
                self.pool.save(k)

    def restore(self):
        path = os.path.join(self.checkpoint_dir or "", "league.pkl")
        if not os.path.exists(path):
            return False
        with open(path, "rb") as f:
            self.load_state(pickle.load(f))
        return True


def _to_cpu(tree):
    """Tensors (in dicts, lists, tuples and NamedTuples) detached and copied
    to the CPU; every other leaf as it is."""
    return tree_map(lambda x: x.detach().to("cpu", copy=True) if torch.is_tensor(x) else x, tree)


class TrainCheckpoint:
    """The learner's whole state for crash / preemption resume, in the
    port's own format: `{"step": int, "format": FORMAT, "trees": {name:
    tree}}` saved by torch.save with every tensor on the CPU (module and
    optimizer state dicts, env state, replay, torch generator states,
    numpy generator states, host statistics). Written to a temp file and
    moved over the old one with os.replace, so a crash mid-save never
    corrupts the previous checkpoint. `load` returns that dict with the
    tensors on the CPU, or None when there is no file."""

    FORMAT = "lifelike_tpu_torch.TrainCheckpoint/1"

    def __init__(self, path: str):
        self.path = path

    def save(self, step: int, **trees):
        state = {"step": int(step), "format": self.FORMAT,
                 "trees": {k: _to_cpu(v) for k, v in trees.items()}}
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        tmp = self.path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self.path)

    def load(self) -> Optional[dict]:
        if not os.path.exists(self.path):
            return None
        state = torch.load(self.path, map_location="cpu", weights_only=False)
        if state.get("format") != self.FORMAT:
            raise ValueError(f"{self.path}: not a {self.FORMAT} file (the JAX package's "
                             "checkpoints are read by compat.from_jax.read_train_checkpoint)")
        return state
