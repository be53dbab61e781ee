"""Model-driven and scripted agents for match play and evaluation.

Counterpart of ``handyrl_tpu/agents.py``.  The acting API that the match
loop (runtime/evaluation.py) calls is three methods:

    reset(env, show=False)
    action(env, player, show=False) -> int
    observe(env, player, show=False) -> value estimate (or None)

Every model-backed agent is an ensemble (one checkpoint is the one-member
case), mean-pooling its members' outputs; selection is masked logits with
argmax (temperature 0) or Gumbel-max sampling.  A "model" is anything with
``inference`` / ``init_hidden``: an ``InferenceModel``, a client of the
batched inference engine, or the zero-output ``RandomModel``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

_ILLEGAL = np.float32(-1e32)


def masked_policy_logits(policy: np.ndarray, legal: Sequence[int]) -> np.ndarray:
    """Logits with every illegal entry pushed to -1e32."""
    out = np.full(np.shape(policy), _ILLEGAL, np.float32)
    idx = np.asarray(legal, np.int64)
    out[idx] = np.asarray(policy, np.float32)[idx]
    return out


def sample_logits(logits: np.ndarray, temperature: float, rng: np.random.Generator) -> int:
    """An action index from masked logits: argmax at ``temperature == 0``,
    else Gumbel-max on ``logits / temperature`` (softmax sampling without a
    normalisation pass, and no underflow on the -1e32 entries)."""
    if temperature <= 0.0:
        return int(np.argmax(logits))
    gumbel = rng.gumbel(size=np.shape(logits)).astype(np.float32)
    return int(np.argmax(logits / np.float32(temperature) + gumbel))


def mean_pool_outputs(member_outs: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Every output but the hidden state, averaged over ensemble members."""
    keys = {k for out in member_outs for k, v in out.items() if k != "hidden" and v is not None}
    return {
        k: np.mean([np.asarray(out[k], np.float32) for out in member_outs
                    if out.get(k) is not None], axis=0)
        for k in keys
    }


def _scalar(x) -> Optional[float]:
    return None if x is None else float(np.asarray(x).reshape(-1)[0])


def _display(env, prob: Optional[np.ndarray], value: Optional[float]) -> None:
    if hasattr(env, "print_outputs"):
        env.print_outputs(prob, value)
        return
    if value is not None:
        print(f"v = {value:.4f}")
    if prob is not None:
        print("p =", np.round(prob * 1000).astype(np.int64))


class RandomAgent:
    """Uniform over legal actions; the value estimate is a flat zero."""

    def __init__(self, seed: Optional[int] = None):
        self._rng = np.random.default_rng(seed)

    def reset(self, env, show: bool = False) -> None:
        pass

    def action(self, env, player: int, show: bool = False) -> int:
        return int(self._rng.choice(np.asarray(env.legal_actions(player))))

    def observe(self, env, player: int, show: bool = False):
        return [0.0]


class RuleBasedAgent(RandomAgent):
    """The environment's scripted policy where it has one, else random."""

    def __init__(self, key: Optional[str] = None, seed: Optional[int] = None):
        super().__init__(seed)
        self.key = key

    def action(self, env, player: int, show: bool = False) -> int:
        rule = getattr(env, "rule_based_action", None)
        if rule is None:
            return super().action(env, player, show)
        return rule(player, key=self.key)


class Agent:
    """Model-backed agent: ensemble forward -> masked logits -> selection.
    Each member carries its own recurrent state."""

    def __init__(self, models, temperature: float = 0.0, observation: bool = True,
                 seed: Optional[int] = None):
        self.models: List[Any] = list(models) if isinstance(models, (list, tuple)) else [models]
        self.temperature = float(temperature)
        self.observation = observation
        self._rng = np.random.default_rng(seed)
        self._hidden: List[Any] = [None] * len(self.models)

    @property
    def model(self):
        """The first (or only) ensemble member."""
        return self.models[0]

    def reset(self, env, show: bool = False) -> None:
        self._hidden = [m.init_hidden() for m in self.models]

    def _forward(self, obs) -> Dict[str, np.ndarray]:
        member_outs = []
        for i, m in enumerate(self.models):
            out = m.inference(obs, self._hidden[i])
            self._hidden[i] = out.get("hidden")
            member_outs.append(out)
        return mean_pool_outputs(member_outs)

    def action(self, env, player: int, show: bool = False) -> int:
        outputs = self._forward(env.observation(player))
        logits = masked_policy_logits(np.reshape(outputs["policy"], -1), env.legal_actions(player))
        if show:
            exp = np.exp(logits - logits.max())
            _display(env, exp / exp.sum(), _scalar(outputs.get("value")))
        return sample_logits(logits, self.temperature, self._rng)

    def observe(self, env, player: int, show: bool = False):
        if not self.observation:
            return None
        outputs = self._forward(env.observation(player))
        value = outputs.get("value")
        if show:
            _display(env, None, _scalar(value))
        return value


class EnsembleAgent(Agent):
    """Mean-pooled multi-checkpoint agent (``Agent`` already pools lists)."""

    def __init__(self, models, temperature: float = 0.0, observation: bool = True):
        super().__init__(list(models), temperature, observation)


class SoftAgent(Agent):
    """Softmax-sampling agent at temperature 1."""

    def __init__(self, model):
        super().__init__(model, temperature=1.0)
