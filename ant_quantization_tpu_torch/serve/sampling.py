"""Token sampling for the serving engine: temperature, top-k, top-p.

Counterpart of the reference's ``serve/sampling.py``, in the same order
as Hugging Face's samplers (temperature first, then top-k, then top-p),
each applied as a value threshold: a logit below the threshold takes the
finite fill ``_NEG``, so a softmax stays defined. Temperature 0 is exact
greedy (argmax). :func:`filtered_log_probs` is the exact filtered and
renormalized distribution that speculative decoding's rejection sampling
needs (``serve/speculative.py``).

Randomness comes from a ``torch.Generator`` that the caller passes, on
the device of the logits, never from the global generator. The draws are
not the reference's (``jax.random`` and torch's generators differ): a
draw is held to its distribution, not to the reference's tokens.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["SamplingConfig", "filter_logits", "filtered_log_probs",
           "sample", "categorical"]

_NEG = -1e30   # the fill of masked logits (finite: a softmax stays
               # defined even where everything else is masked)


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """temperature: 0.0 is greedy argmax. top_k: keep the k largest
    logits (0 = off). top_p: keep the smallest prefix of the sorted
    distribution whose probability reaches top_p (1.0 = off)."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0.0


def filter_logits(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    """Temperature-scale, then filter by top-k and top-p over the last
    axis; masked entries get ``_NEG``. (..., V) f32 -> (..., V) f32;
    greedy returns the logits as they are."""
    if cfg.is_greedy:
        return logits
    x = logits.to(torch.float32) / torch.tensor(
        cfg.temperature, dtype=torch.float32, device=logits.device)
    V = x.shape[-1]
    neg = torch.tensor(_NEG, dtype=torch.float32, device=x.device)
    if cfg.top_k and cfg.top_k < V:
        kth = torch.topk(x, cfg.top_k, dim=-1).values[..., -1:]
        x = torch.where(x < kth, neg, x)
    if cfg.top_p < 1.0:
        # the smallest prefix of the descending order whose mass reaches
        # top_p: keep position i iff the mass before it is below top_p;
        # the threshold is the last kept logit value
        sorted_x = torch.sort(x, dim=-1, descending=True).values
        probs = torch.softmax(sorted_x, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        n_keep = ((cum - probs) < cfg.top_p).sum(dim=-1, keepdim=True)
        thresh = torch.gather(sorted_x, -1, n_keep - 1)
        x = torch.where(x < thresh, neg, x)
    return x


def filtered_log_probs(logits: torch.Tensor,
                       cfg: SamplingConfig) -> torch.Tensor:
    """log of the exact sampling distribution (filtered, renormalized)."""
    return torch.log_softmax(filter_logits(logits, cfg), dim=-1)


def categorical(logits: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
    """One draw per row of (..., V) logits from softmax(logits), by the
    Gumbel-max rule on ``generator``'s uniforms -> (...,) int64."""
    u = torch.rand(logits.shape, dtype=torch.float32, device=logits.device,
                   generator=generator)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits.to(torch.float32) + gumbel, dim=-1)


def sample(logits: torch.Tensor, cfg: SamplingConfig,
           generator: torch.Generator) -> torch.Tensor:
    """Draw token ids from (..., V) logits: argmax when greedy, else one
    draw from the filtered distribution. -> (...,) int64."""
    if cfg.is_greedy:
        return torch.argmax(logits, dim=-1)
    return categorical(filter_logits(logits, cfg), generator)
