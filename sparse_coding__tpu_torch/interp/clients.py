"""Explainer/simulator clients for autointerp.

Counterpart of `sparse_coding__tpu/interp/clients.py`, a copy (stdlib +
numpy). The LLM dependency sits behind a small protocol so the pipeline is
runnable anywhere:

  - `OpenAIClient` — GPT-4 explanations and a completions-model simulator
    (requires the `openai` package and an API key; without the package it
    raises a clear error).
  - `TokenLexiconClient` — deterministic offline fallback: explains a feature
    by its most activation-weighted tokens and simulates by lexicon lookup.
    Not an LLM, but it exercises the full protocol (records → explanation →
    simulation → correlation score) and gives a meaningful baseline score.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Protocol, Sequence

from sparse_coding__tpu_torch.interp.records import ActivationRecord


class InterpClient(Protocol):
    def explain(self, records: Sequence[ActivationRecord], max_activation: float) -> str: ...

    def simulate(self, explanation: str, tokens: List[str]) -> List[float]: ...


EXPLAINER_MODEL_NAME = "gpt-4"
SIMULATOR_MODEL_NAME = "text-davinci-003"


def expected_activation_from_digit_logprobs(top_logprobs: Dict[str, float]) -> float:
    """Calibrated activation from a digit position's top-logprobs.

    Scored as `neuron-explainer`'s `UncalibratedNeuronSimulator` scores
    davinci logprobs: rather than trusting the sampled digit, take the
    probability-weighted expectation over the digits 0-10 the model
    considered. Pure function — unit-testable without the API."""
    import math

    ps: Dict[int, float] = {}
    for tok, lp in top_logprobs.items():
        s = tok.strip()
        if s.isdigit() and 0 <= int(s) <= 10:
            # a digit may appear as "5" and " 5"; keep the likelier variant
            ps[int(s)] = max(ps.get(int(s), -math.inf), float(lp))
    if not ps:
        return 0.0
    weights = {k: math.exp(v) for k, v in ps.items()}
    z = sum(weights.values())
    return sum(k * w for k, w in weights.items()) / z


def scores_from_completion_logprobs(
    response_tokens: Sequence[str],
    response_top_logprobs: Sequence[Dict[str, float]],
    n_expected: int,
) -> List[float]:
    """Per-line calibrated activations from a completions response.

    The simulation prompt asks for one `token<TAB>digit` line per input
    token; this walks the response token stream and scores ONLY digit tokens
    whose preceding token is the tab separator — corpus tokens that happen to
    be numeric (dates, counts) are echoed parts of the table's token column
    and must not be read as activation cells, which would shift every later
    score. Missing lines score 0."""
    out: List[float] = []
    prev = "\t"  # the prompt ends with the first row's tab seed
    for tok, top in zip(response_tokens, response_top_logprobs or []):
        if len(out) >= n_expected:
            break
        if tok.strip().isdigit() and prev.endswith("\t"):
            out.append(expected_activation_from_digit_logprobs(top or {tok: 0.0}))
        prev = tok
    out += [0.0] * (n_expected - len(out))
    return out[:n_expected]


class OpenAIClient:
    """LLM explain/simulate via the OpenAI API.

    Explanations use the chat API (gpt-4).
    Simulation is CALIBRATED when the simulator is a completions-capable
    model (davinci-style, `text-davinci-003`): one
    completions call per fragment with `logprobs`, scoring each token by the
    probability-weighted expected digit. Chat-only
    simulator models fall back to parsing printed digits — uncalibrated, as
    no logprobs are available over the digit positions."""

    def __init__(self, api_key: str, explainer_model: str = EXPLAINER_MODEL_NAME,
                 simulator_model: str = SIMULATOR_MODEL_NAME):
        try:
            import openai
        except ImportError as e:
            raise ImportError(
                "the `openai` package is not installed; use TokenLexiconClient "
                "for offline autointerp or install openai"
            ) from e
        self._client = openai.OpenAI(api_key=api_key)
        self.explainer_model = explainer_model
        self.simulator_model = simulator_model

    def _simulator_is_completions_model(self) -> bool:
        name = self.simulator_model
        return "davinci" in name or "babbage" in name or "instruct" in name

    def explain(self, records, max_activation):
        examples = "\n\n".join(
            " ".join(
                f"{tok} ({act:.1f})" if act > 0 else tok
                for tok, act in zip(r.tokens, r.activations)
            )
            for r in records
        )
        resp = self._client.chat.completions.create(
            model=self.explainer_model,
            messages=[
                {
                    "role": "system",
                    "content": (
                        "You explain what pattern a neural-network feature "
                        "responds to, given tokens annotated with activations. "
                        "Reply with a short phrase."
                    ),
                },
                {"role": "user", "content": examples},
            ],
        )
        return resp.choices[0].message.content.strip()

    def simulate(self, explanation, tokens):
        if self._simulator_is_completions_model():
            # all tokens listed up front, prompt ends with "tok0<TAB>" so the
            # model's FIRST sampled token is tok0's activation digit and each
            # continued row follows the demonstrated token<TAB>digit shape
            prompt = (
                f"A neural-network feature activates on: {explanation}\n"
                "Rewrite the token list as a table: one line per token — the "
                "token, a tab, then its activation as an integer 0-10.\n"
                "Tokens: " + " ".join(tokens) + "\n\n"
                f"{tokens[0]}\t"
            )
            resp = self._client.completions.create(
                model=self.simulator_model,
                prompt=prompt,
                max_tokens=4 * len(tokens) + 16,
                temperature=0.0,
                logprobs=5,  # the completions API's maximum
            )
            lp = resp.choices[0].logprobs
            return scores_from_completion_logprobs(
                lp.tokens, lp.top_logprobs, len(tokens)
            )
        # chat fallback: parse printed digits (uncalibrated — chat responses
        # expose no logprobs at the digit positions)
        prompt = (
            f"A feature activates on: {explanation}\n"
            "For each token below, output its activation 0-10, comma-separated.\n"
            + " ".join(tokens)
        )
        resp = self._client.chat.completions.create(
            model=self.simulator_model,
            messages=[{"role": "user", "content": prompt}],
        )
        out = []
        for part in resp.choices[0].message.content.replace("\n", ",").split(","):
            try:
                out.append(float(part.strip()))
            except ValueError:
                out.append(0.0)
        out += [0.0] * (len(tokens) - len(out))
        return out[: len(tokens)]


class TokenLexiconClient:
    """Deterministic offline explainer/simulator.

    Explain: rank tokens by total activation mass across the train records;
    the explanation IS the lexicon (top-k tokens, serialized). Simulate: a
    token's predicted activation is its lexicon weight. A feature that
    genuinely fires on specific tokens scores high; an unexplainable one
    scores ≈ 0 — the same ordering the LLM scorer produces, minus semantics.
    """

    def __init__(self, top_k: int = 10):
        self.top_k = top_k

    def explain(self, records, max_activation):
        import json

        mass: Dict[str, float] = defaultdict(float)
        for r in records:
            for tok, act in zip(r.tokens, r.activations):
                mass[tok] += max(float(act), 0.0)  # numpy scalars break json.dumps
        top = sorted(mass.items(), key=lambda kv: -kv[1])[: self.top_k]
        total = sum(w for _, w in top) or 1.0
        lexicon = {tok: round(w / total, 4) for tok, w in top if w > 0}
        # JSON body: survives tokens containing ',' ':' etc. (real BPE vocabs)
        return "activates on tokens: " + json.dumps(lexicon)

    def simulate(self, explanation, tokens):
        import json

        body = explanation.split("activates on tokens:", 1)[-1].strip()
        try:
            lexicon = json.loads(body)
        except json.JSONDecodeError:
            lexicon = {}
        return [10.0 * float(lexicon.get(tok, 0.0)) for tok in tokens]


def default_client() -> InterpClient:
    """OpenAI if a key is configured (``OPENAI_API_KEY``, or ``openai_key``
    in ``secrets.json``), else the offline lexicon client."""
    import json
    import os
    from pathlib import Path

    key = os.environ.get("OPENAI_API_KEY")
    if not key and Path("secrets.json").exists():
        key = json.load(open("secrets.json")).get("openai_key")
    if key:
        try:
            return OpenAIClient(key)
        except ImportError:
            pass
    return TokenLexiconClient()
