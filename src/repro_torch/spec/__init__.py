"""Speculative decoding over the paged KV cache.

Decode is the latency-dominated path of the unified flow: the paper's
merged fine-tune + inference step already packs more work per kernel launch
across *requests*; speculation applies the same lever along the *time* axis.
A model-free drafter proposes ``k`` tokens from the request's own history,
the engine folds a ``(1 + k)``-token *verify chunk* per speculating request
into the ordinary unified batch (fine-tune + prefill + verify + plain decode
co-batch in ONE step), and exact greedy acceptance keeps the longest draft
prefix that matches the model's argmax — byte-identical output to plain
greedy decode, fewer sequential steps.  Rejected drafts roll the paged cache
back via ``PagedCacheManager.truncate``.

The port's copy of ``repro.spec``: numpy only, the same classes and rules.
"""
from repro_torch.spec.drafter import (Drafter, NgramDrafter,
                                      StaticSuffixDrafter, make_drafter)
from repro_torch.spec.policy import AdaptiveK, SpecConfig
from repro_torch.spec.verify import accept_greedy, accept_greedy_ids

__all__ = ["Drafter", "NgramDrafter", "StaticSuffixDrafter", "make_drafter",
           "AdaptiveK", "SpecConfig", "accept_greedy", "accept_greedy_ids"]
