"""Hyperparameter search (counterpart of dose_prediction_tpu/train/tune.py):
random and TPE/GP sampling, ASHA early stopping, population-based training
(PBT, PB2) and concurrent trials.

Reference DosePrediction/Train/tune_light_pyfer.py: Ray Tune with an
ASHAScheduler over {act, multiS_conv, lr, weight_decay} (:160-171), an
Optuna/BayesOpt search algorithm (:75-84), PB2 (:124-145) and Ray
multi-worker trials (:36). Without Ray:
- TPESampler stands for OptunaSearch (a tree-structured Parzen estimator
  over the mixed categorical/log-uniform space), GPSampler for
  BayesOptSearch;
- ASHAScheduler halts trials at promotion rungs;
- run_search(max_concurrent=N) runs N trials at once in threads, each on a
  device of its own, round-robin over ``devices``.

Every random draw comes from an explicit ``np.random.Generator`` seeded by
the caller, so a search draws the JAX package's configurations for the same
seeds and histories.
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# search space (tune.choice / tune.loguniform analogues, :160-168)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Choice:
    options: Sequence[Any]

    def sample(self, rng: np.random.Generator):
        return self.options[int(rng.integers(len(self.options)))]


@dataclasses.dataclass
class LogUniform:
    low: float
    high: float

    def sample(self, rng: np.random.Generator) -> float:
        return float(np.exp(rng.uniform(np.log(self.low), np.log(self.high))))


@dataclasses.dataclass
class Uniform:
    low: float
    high: float

    def sample(self, rng: np.random.Generator) -> float:
        return float(rng.uniform(self.low, self.high))


PYFER_SEARCH_SPACE: Dict[str, Any] = {
    # tune_light_pyfer.py:160-168
    "act": Choice(["relu", "mish"]),
    "multiS_conv": Choice([True, False]),
    "lr": LogUniform(1e-4, 1e-1),
    "weight_decay": LogUniform(1e-5, 1e-1),
}


def sample_config(space: Dict[str, Any], rng: np.random.Generator) -> Dict[str, Any]:
    out = {}
    for k, v in space.items():
        out[k] = v.sample(rng) if hasattr(v, "sample") else v
    return out


# ---------------------------------------------------------------------------
# TPE (tree-structured Parzen estimator) — the OptunaSearch analogue
# ---------------------------------------------------------------------------

class TPESampler:
    """1-D Parzen TPE over a mixed space (tune_light_pyfer.py:75-84 replaces
    OptunaSearch): completed trials split at the ``gamma`` quantile into
    good/bad sets; each hyperparameter gets densities l(x) (good) and g(x)
    (bad) — Gaussian KDE in log space for LogUniform, linear for Uniform,
    Laplace-smoothed counts for Choice — and the suggestion maximizes
    l(x)/g(x) over ``n_candidates`` draws from l. Falls back to random until
    ``n_startup`` trials have completed."""

    def __init__(self, *, gamma: float = 0.25, n_candidates: int = 24,
                 n_startup: int = 4, mode: str = "min", seed: int = 0):
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.n_startup = n_startup
        self.mode = mode
        self.rng = np.random.default_rng(seed)

    # -- per-dimension density helpers ------------------------------------
    @staticmethod
    def _transform(dist, x):
        return math.log(x) if isinstance(dist, LogUniform) else x

    @staticmethod
    def _bounds(dist):
        if isinstance(dist, LogUniform):
            return math.log(dist.low), math.log(dist.high)
        return dist.low, dist.high

    def _bandwidth(self, dist, pts: np.ndarray) -> float:
        lo, hi = self._bounds(dist)
        spread = float(np.std(pts)) if len(pts) > 1 else 0.0
        return max(spread, (hi - lo) / max(len(pts), 1) / 2.0, 1e-6)

    def _kde_logpdf(self, dist, pts: np.ndarray, x: float) -> float:
        bw = self._bandwidth(dist, pts)
        z = (x - pts) / bw
        dens = np.mean(np.exp(-0.5 * z * z)) / (bw * math.sqrt(2 * math.pi))
        return math.log(max(dens, 1e-300))

    def _cat_probs(self, dist: Choice, values: List[Any]) -> np.ndarray:
        counts = np.array([1.0 + sum(v == o for v in values) for o in dist.options])
        return counts / counts.sum()

    def suggest(self, space: Dict[str, Any],
                history: List[Tuple[Dict[str, Any], float]]) -> Dict[str, Any]:
        done = [(c, v) for c, v in history if not math.isnan(v)]
        if len(done) < self.n_startup:
            return sample_config(space, self.rng)
        ranked = sorted(done, key=lambda cv: cv[1], reverse=(self.mode == "max"))
        n_good = max(1, int(math.ceil(self.gamma * len(ranked))))
        good = [c for c, _ in ranked[:n_good]]
        bad = [c for c, _ in ranked[n_good:]] or [ranked[-1][0]]

        best_cfg, best_score = None, -math.inf
        for _ in range(self.n_candidates):
            cand: Dict[str, Any] = {}
            score = 0.0
            for k, dist in space.items():
                if not hasattr(dist, "sample"):
                    cand[k] = dist
                    continue
                if isinstance(dist, Choice):
                    pl = self._cat_probs(dist, [c[k] for c in good])
                    pg = self._cat_probs(dist, [c[k] for c in bad])
                    idx = int(self.rng.choice(len(dist.options), p=pl))
                    cand[k] = dist.options[idx]
                    score += math.log(pl[idx]) - math.log(pg[idx])
                else:
                    lo, hi = self._bounds(dist)
                    gpts = np.array([self._transform(dist, c[k]) for c in good])
                    bpts = np.array([self._transform(dist, c[k]) for c in bad])
                    # draw from l: jitter a random good point by its bandwidth
                    center = gpts[int(self.rng.integers(len(gpts)))]
                    x = float(np.clip(center + self.rng.normal() *
                                      self._bandwidth(dist, gpts), lo, hi))
                    score += (self._kde_logpdf(dist, gpts, x)
                              - self._kde_logpdf(dist, bpts, x))
                    val = math.exp(x) if isinstance(dist, LogUniform) else x
                    cand[k] = float(np.clip(val, dist.low, dist.high))
            if score > best_score:
                best_cfg, best_score = cand, score
        return best_cfg


# ---------------------------------------------------------------------------
# GP expected improvement — the BayesOptSearch analogue
# ---------------------------------------------------------------------------

class GPSampler:
    """BayesOptSearch analogue (tune_light_pyfer.py:75-84): a Gaussian-process
    surrogate with an RBF kernel over the normalized search space (log-scale
    for LogUniform, one-hot for Choice) suggesting the candidate that
    maximizes expected improvement over ``n_candidates`` random draws. Random
    until ``n_startup`` trials have completed. Pure numpy (the GP is over tens
    of trials — O(n³) is nothing)."""

    def __init__(self, *, n_candidates: int = 128, n_startup: int = 4,
                 length_scale: float = 0.25, noise: float = 1e-4,
                 xi: float = 0.01, mode: str = "min", seed: int = 0):
        self.n_candidates = n_candidates
        self.n_startup = n_startup
        self.length_scale = length_scale
        self.noise = noise
        self.xi = xi
        self.mode = mode
        self.rng = np.random.default_rng(seed)

    def _featurize(self, space: Dict[str, Any], cfg: Dict[str, Any]) -> np.ndarray:
        feats: List[float] = []
        for k, dist in space.items():
            if isinstance(dist, LogUniform):
                lo, hi = math.log(dist.low), math.log(dist.high)
                feats.append((math.log(cfg[k]) - lo) / (hi - lo))
            elif isinstance(dist, Uniform):
                feats.append((cfg[k] - dist.low) / (dist.high - dist.low))
            elif isinstance(dist, Choice):
                feats.extend(1.0 if cfg[k] == o else 0.0 for o in dist.options)
            # fixed values carry no information
        return np.asarray(feats)

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / self.length_scale**2)

    def suggest(self, space: Dict[str, Any],
                history: List[Tuple[Dict[str, Any], float]]) -> Dict[str, Any]:
        done = [(c, v) for c, v in history if not math.isnan(v)]
        if len(done) < self.n_startup:
            return sample_config(space, self.rng)
        X = np.stack([self._featurize(space, c) for c, _ in done])
        y = np.asarray([v for _, v in done], np.float64)
        if self.mode == "max":
            y = -y                         # GP always minimizes internally
        mu_y, sd_y = y.mean(), max(y.std(), 1e-12)
        y = (y - mu_y) / sd_y
        K = self._kernel(X, X) + self.noise * np.eye(len(X))
        Kinv_y = np.linalg.solve(K, y)
        Kinv = np.linalg.inv(K)
        best = y.min()

        cands = [sample_config(space, self.rng) for _ in range(self.n_candidates)]
        Xc = np.stack([self._featurize(space, c) for c in cands])
        Ks = self._kernel(Xc, X)                       # (m, n)
        mu = Ks @ Kinv_y
        var = np.clip(1.0 - np.einsum("mn,nk,mk->m", Ks, Kinv, Ks), 1e-12, None)
        sd = np.sqrt(var)
        z = (best - self.xi - mu) / sd
        # EI = (best - xi - mu)·Φ(z) + sd·φ(z), via erf (no scipy dependency)
        phi = np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
        Phi = 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2)))
        ei = (best - self.xi - mu) * Phi + sd * phi
        return cands[int(np.argmax(ei))]


# ---------------------------------------------------------------------------
# ASHA (asynchronous successive halving)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Trial:
    trial_id: int
    config: Dict[str, Any]
    rung: int = 0
    last_value: float = math.nan
    stopped: bool = False      # rung-based ASHA halt (a true early stop)
    completed: bool = False    # ran to the full max_t budget
    history: List[float] = dataclasses.field(default_factory=list)
    # (epoch, value) per report — lets a resumed search replay ASHA rung
    # state exactly (history alone loses the epoch numbers)
    report_log: List[List[float]] = dataclasses.field(default_factory=list)


class ASHAScheduler:
    """Promotion rungs at grace_period · reduction_factor^k epochs; a trial is
    stopped at a rung if its metric is not in the top 1/reduction_factor of
    completed results at that rung (mode='min' or 'max')."""

    def __init__(self, *, max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 2, mode: str = "min"):
        self.max_t = max_t
        self.grace = grace_period
        self.rf = reduction_factor
        self.mode = mode
        self._rung_results: Dict[int, List[float]] = {}

    def milestones(self) -> List[int]:
        out = []
        t = self.grace
        while t < self.max_t:
            out.append(t)
            t *= self.rf
        return out

    def on_result(self, trial: Trial, epoch: int, value: float) -> bool:
        """Record a result; returns True if the trial should STOP."""
        trial.last_value = value
        trial.history.append(value)
        trial.report_log.append([int(epoch), float(value)])
        if epoch >= self.max_t:
            # normal completion: NOT an early stop (num_early_stopped must
            # count rung halts only)
            trial.completed = True
            return True
        if epoch in self.milestones():
            results = self._rung_results.setdefault(epoch, [])
            results.append(value)
            ranked = sorted(results, reverse=(self.mode == "max"))
            cutoff_n = max(1, len(ranked) // self.rf)
            cutoff = ranked[cutoff_n - 1]
            keep = value >= cutoff if self.mode == "max" else value <= cutoff
            if not keep:
                trial.stopped = True
                return True
        return False


class PopulationBasedScheduler:
    """PB2-style population-based training (tune_light_pyfer.py:124-145
    analogue): a population of trials trains in parallel epochs; at each
    ``perturbation_interval`` the bottom quantile copies the config of a top
    performer and perturbs continuous hyperparameters by ×0.8 / ×1.25."""

    def __init__(self, *, population: int = 4, perturbation_interval: int = 4,
                 quantile: float = 0.25, mode: str = "min", seed: int = 0,
                 bounds: Optional[Dict[str, Tuple[float, float]]] = None):
        self.population = population
        self.interval = perturbation_interval
        self.quantile = quantile
        self.mode = mode
        self.rng = np.random.default_rng(seed)
        self.bounds = bounds or {}

    def exploit_explore(self, trials: List[Trial]) -> Dict[int, int]:
        """Mutate the bottom quantile in place from the top quantile. Returns
        ``{bottom_trial_id: top_trial_id}`` — the exploit step of PBT copies
        the winner's TRAINING STATE as well as its config (Ray PBT/PB2 clone
        the checkpoint); run_pbt applies the state transfer from this map."""
        ranked = sorted(trials, key=lambda t: t.last_value,
                        reverse=(self.mode == "max"))
        n_q = max(1, int(len(ranked) * self.quantile))
        top, bottom = ranked[:n_q], ranked[-n_q:]
        moves: Dict[int, int] = {}
        for t in bottom:
            src = top[int(self.rng.integers(len(top)))]
            moves[t.trial_id] = src.trial_id
            new_cfg = dict(src.config)
            for k, v in new_cfg.items():
                if isinstance(v, float):
                    factor = 0.8 if self.rng.random() < 0.5 else 1.25
                    nv = v * factor
                    if k in self.bounds:
                        lo, hi = self.bounds[k]
                        nv = float(np.clip(nv, lo, hi))
                    new_cfg[k] = nv
            t.config = new_cfg
        return moves


class PB2Scheduler(PopulationBasedScheduler):
    """GP-bandit PB2 (Parker-Holder et al. 2020; the Ray PB2 the reference
    configures, tune_light_pyfer.py:124-145). Exploit copies a top performer's
    config (and, via the returned move map applied by run_pbt, its TRAINING
    STATE — Ray's exploit clones the checkpoint), and EXPLORE selects the
    continuous hyperparameters by GP-UCB fitted on the population's
    (config → metric improvement) history instead of a random ×0.8/×1.25
    perturbation."""

    def __init__(self, *, bounds: Dict[str, Tuple[float, float]],
                 ucb_kappa: float = 1.5, length_scale: float = 0.25,
                 noise: float = 1e-4, n_candidates: int = 64, **kw):
        super().__init__(bounds=bounds, **kw)
        self.kappa = ucb_kappa
        self.length_scale = length_scale
        self.noise = noise
        self.n_candidates = n_candidates
        # (feature vector, observed improvement) pairs across the population
        self._data: List[Tuple[np.ndarray, float]] = []
        self._last: Dict[int, float] = {}

    def _feat(self, cfg: Dict[str, Any]) -> np.ndarray:
        out = []
        for k in sorted(self.bounds):
            lo, hi = self.bounds[k]
            lo, hi = math.log(lo), math.log(hi)
            out.append((math.log(max(cfg[k], 1e-300)) - lo) / (hi - lo))
        return np.asarray(out)

    def observe(self, trials: List[Trial]) -> None:
        """Record each trial's metric improvement since the last interval
        (the GP's reward signal). Called internally by exploit_explore — do
        NOT also call it yourself, or every interval double-counts as a
        spurious zero-improvement sample."""
        for t in trials:
            prev = self._last.get(t.trial_id)
            if prev is not None and not math.isnan(t.last_value):
                delta = prev - t.last_value if self.mode == "min" else t.last_value - prev
                self._data.append((self._feat(t.config), float(delta)))
            self._last[t.trial_id] = t.last_value

    def _gp_ucb_choose(self, cands: List[Dict[str, Any]]) -> Dict[str, Any]:
        if len(self._data) < 3:
            return cands[int(self.rng.integers(len(cands)))]
        X = np.stack([x for x, _ in self._data])
        y = np.asarray([v for _, v in self._data], np.float64)
        y = (y - y.mean()) / max(y.std(), 1e-12)

        def kern(a, b):
            d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
            return np.exp(-0.5 * d2 / self.length_scale**2)

        K = kern(X, X) + self.noise * np.eye(len(X))
        Kinv = np.linalg.inv(K)
        Xc = np.stack([self._feat(c) for c in cands])
        Ks = kern(Xc, X)
        mu = Ks @ (Kinv @ y)
        var = np.clip(1.0 - np.einsum("mn,nk,mk->m", Ks, Kinv, Ks), 1e-12, None)
        ucb = mu + self.kappa * np.sqrt(var)
        return cands[int(np.argmax(ucb))]

    def exploit_explore(self, trials: List[Trial]) -> Dict[int, int]:
        self.observe(trials)
        ranked = sorted(trials, key=lambda t: t.last_value,
                        reverse=(self.mode == "max"))
        n_q = max(1, int(len(ranked) * self.quantile))
        top, bottom = ranked[:n_q], ranked[-n_q:]
        moves: Dict[int, int] = {}
        for t in bottom:
            src = top[int(self.rng.integers(len(top)))]
            moves[t.trial_id] = src.trial_id
            base = dict(src.config)
            # candidate set: log-uniform draws inside the bounds (GP picks)
            cands = []
            for _ in range(self.n_candidates):
                c = dict(base)
                for k, (lo, hi) in self.bounds.items():
                    c[k] = float(np.exp(self.rng.uniform(np.log(lo), np.log(hi))))
                cands.append(c)
            t.config = self._gp_ucb_choose(cands)
        return moves


def run_pbt(
    train_epoch: Callable[[Dict[str, Any], Any, int], Tuple[Any, float]],
    init_trial_state: Callable[[Dict[str, Any]], Any],
    *,
    space: Optional[Dict[str, Any]] = None,
    scheduler: Optional[PopulationBasedScheduler] = None,
    num_epochs: int = 16,
    seed: int = 0,
    clone_state: Callable[[Any], Any] = lambda s: s,
) -> Dict[str, Any]:
    """Population-based training loop.

    ``init_trial_state(config)`` builds per-trial mutable state (train state);
    ``train_epoch(config, trial_state, epoch) -> (trial_state, metric)`` runs
    one epoch. Population members run round-robin on one device.

    At each exploit step a bottom-quantile member adopts a top performer's
    hyperparameters AND its training state (Ray PBT/PB2 clone the winner's
    checkpoint — without the state transfer, losers never catch up and the
    GP's improvement signal is evaluated on mismatched weights).
    ``clone_state`` defaults to reference sharing, which is safe for
    immutable state; pass copy.deepcopy for mutable state (a torch model).
    """
    space = space if space is not None else PYFER_SEARCH_SPACE
    scheduler = scheduler or PopulationBasedScheduler(seed=seed)
    rng = np.random.default_rng(seed)
    trials = [Trial(trial_id=i, config=sample_config(space, rng))
              for i in range(scheduler.population)]
    states = [init_trial_state(t.config) for t in trials]
    by_id = {t.trial_id: i for i, t in enumerate(trials)}
    for epoch in range(num_epochs):
        for t, i in zip(trials, range(len(trials))):
            states[i], metric = train_epoch(t.config, states[i], epoch)
            t.last_value = metric
            t.history.append(metric)
        if (epoch + 1) % scheduler.interval == 0:
            moves = scheduler.exploit_explore(trials) or {}
            for dst, src in moves.items():
                if dst != src:
                    states[by_id[dst]] = clone_state(states[by_id[src]])
    best = (max if scheduler.mode == "max" else min)(
        trials, key=lambda t: t.last_value)
    return {"best_config": best.config, "best_value": best.last_value,
            "trials": [dataclasses.asdict(t) for t in trials]}


def run_search(
    train_trial: Callable[[Dict[str, Any], Callable[[int, float], bool]], float],
    *,
    space: Dict[str, Any] = None,
    num_samples: int = 10,
    scheduler: Optional[ASHAScheduler] = None,
    seed: int = 0,
    mode: str = "min",
    out_dir: Optional[str] = None,
    sampler: str = "random",          # 'random' | 'tpe' | 'gp'
    max_concurrent: int = 1,
    resume: bool = False,
    devices: Optional[Sequence[Any]] = None,
) -> Dict[str, Any]:
    """Run the search.

    ``train_trial(config, report, device) -> final_value`` trains one
    configuration on ``device``; it must call ``report(epoch, value)`` each
    validation round and stop when report returns True (ASHA's early stop).

    ``sampler='tpe'`` uses the TPESampler (OptunaSearch analogue) and
    ``sampler='gp'`` the GPSampler (BayesOptSearch analogue), each seeded from
    completed trials. Trial i runs on ``devices[i % len(devices)]``: by
    default every CUDA device (``torch.cuda.device_count()``) when
    ``max_concurrent > 1``, and None (the trainer's own default) otherwise;
    pass ``devices`` to choose (the tests pass the CPU). ``max_concurrent >
    1`` runs that many trials at once in threads, the
    RayStrategy(num_workers) analogue (tune_light_pyfer.py:36). With fewer
    devices than threads, trials share a device: on one card, N concurrent
    trials queue their kernels on it from N threads (each its own model,
    optimizer and activations in its memory), so they overlap host work
    and device work but not device work with itself.

    With ``out_dir`` each finished trial is appended to ``trials.jsonl`` as it
    completes; ``resume=True`` replays that journal: completed trials seed
    the sampler history and (for ASHA) the rung state exactly via their
    report logs, and only the remaining ``num_samples - done`` trials run
    (Ray Tune's resumable experiment; a crash mid-search loses at most the
    trials in flight).

    Returns {'best_config', 'best_value', 'num_early_stopped', 'trials'}.
    """
    space = space if space is not None else PYFER_SEARCH_SPACE
    scheduler = scheduler or ASHAScheduler(mode=mode)
    rng = np.random.default_rng(seed)
    searcher = {"tpe": lambda: TPESampler(mode=mode, seed=seed),
                "gp": lambda: GPSampler(mode=mode, seed=seed),
                "random": lambda: None}[sampler]()
    lock = threading.Lock()                 # ASHA rungs + history are shared
    history: List[Tuple[Dict[str, Any], float]] = []
    trials: List[Trial] = []

    journal = Path(out_dir) / "trials.jsonl" if out_dir else None
    if journal is not None and not resume and journal.exists():
        journal.unlink()       # fresh search: don't mix with a previous run
    if resume and journal is not None and journal.exists():
        for line in journal.read_text().splitlines():
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                # a crash mid-append leaves a truncated trailing line — the
                # exact scenario resume exists for; skip it (that trial
                # simply re-runs)
                print(f"[tune] skipping truncated journal line in {journal}")
                continue
            t = Trial(trial_id=rec["trial_id"], config=rec["config"])
            if isinstance(scheduler, ASHAScheduler):
                for epoch, value in rec.get("report_log", []):
                    scheduler.on_result(t, epoch, value)   # rebuilds rungs
            t.last_value = rec["last_value"]
            t.stopped = rec["stopped"]
            t.completed = rec["completed"]
            t.history = list(rec.get("history", []))
            t.report_log = [list(p) for p in rec.get("report_log", [])]
            trials.append(t)
            history.append((t.config, t.last_value))
        # keep the 'random' stream aligned with the interrupted run: every
        # SUBMITTED trial consumed a draw, including in-flight ones that
        # never reached the journal — max journaled id + 1 counts them
        # (exact for serial runs; best-effort under max_concurrent>1, where
        # thread interleaving already makes draw order nondeterministic)
        n_consumed = max((t.trial_id for t in trials), default=-1) + 1
        for _ in range(n_consumed):
            sample_config(space, rng)
        # the tpe/gp samplers draw their STARTUP configs from their own rng
        # (suggest() → sample_config(space, searcher.rng)); without the same
        # fast-forward a resume that crashed before n_startup completed would
        # re-suggest byte-identical configs to the journaled startup trials
        if searcher is not None:
            for _ in range(n_consumed):
                sample_config(space, searcher.rng)

    def journal_append(trial: Trial) -> None:
        if journal is None:
            return
        journal.parent.mkdir(parents=True, exist_ok=True)
        with open(journal, "a") as f:
            f.write(json.dumps(dataclasses.asdict(trial), default=str) + "\n")

    def next_config() -> Dict[str, Any]:
        with lock:
            if searcher is not None:
                return searcher.suggest(space, history)
            return sample_config(space, rng)

    def run_one(i: int, device=None) -> Trial:
        trial = Trial(trial_id=i, config=next_config())

        def report(epoch: int, value: float) -> bool:
            with lock:
                return scheduler.on_result(trial, epoch, value)

        final = train_trial(trial.config, report, device)
        if final is not None and not math.isnan(final):
            trial.last_value = float(final)
        with lock:
            history.append((trial.config, trial.last_value))
            trials.append(trial)
            journal_append(trial)
        return trial

    # a concurrent crash can journal non-contiguous ids (an in-flight trial
    # never completed): run `num_samples - done` MORE trials with fresh ids
    # rather than re-using any journaled id
    next_id = max((t.trial_id for t in trials), default=-1) + 1
    todo = range(next_id, next_id + max(0, num_samples - len(trials)))
    if devices is None and max_concurrent > 1:
        import torch

        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("max_concurrent > 1 runs trials on CUDA devices and none is "
                               "visible; pass devices=[...] to choose others")
    placed = [(i, devices[i % len(devices)] if devices else None) for i in todo]
    if max_concurrent > 1:
        with ThreadPoolExecutor(max_workers=max_concurrent) as ex:
            for f in [ex.submit(run_one, i, dev) for i, dev in placed]:
                f.result()
    else:
        for i, dev in placed:
            run_one(i, dev)

    valid = [t for t in trials if not math.isnan(t.last_value)]
    # no valid trial (every config diverged, or num_samples=0): return a
    # result reporting that instead of crashing after the compute was spent
    best = ((max if mode == "max" else min)(valid, key=lambda t: t.last_value)
            if valid else None)
    result = {
        "best_config": best.config if best else None,
        "best_value": best.last_value if best else float("nan"),
        "num_early_stopped": sum(t.stopped for t in trials),
        "trials": [dataclasses.asdict(t) for t in trials],
    }
    if out_dir:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        with open(Path(out_dir) / "search_results.json", "w") as f:
            json.dump(result, f, indent=2, default=str)
    return result
