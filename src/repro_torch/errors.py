"""Typed invariant exceptions for the serving/core/fleet runtime.

The CI tier-1 matrix runs ``python -O``, which strips ``assert``
statements — so every load-bearing invariant raises a real exception.
``InvariantError`` is the common base: anything that inherits it means
"the engine's internal contract was violated; the process state can no
longer be trusted", as opposed to capacity signals like
``OutOfBlocksError`` that the engine answers with policy (preemption).

Subclassing ``RuntimeError`` keeps every existing ``except RuntimeError``
site (adapter-saturation deferral, fleet drift checks) behaving exactly
as before.  ``reprolint``'s no-bare-invariant-assert rule enforces usage.
"""
from __future__ import annotations


class InvariantError(RuntimeError):
    """Base for violated engine invariants (survives ``python -O``)."""


class ConfigInvariantError(InvariantError):
    """A construction-time contract was violated: an impossible pool
    geometry, an unknown mode string — caller bugs caught at the door."""


class AccountingInvariantError(InvariantError):
    """A counting contract was violated mid-flight: token/latency
    attribution asked to spread over zero tokens, and similar."""


class MigrationInvariantError(InvariantError):
    """A void/unvoid migration was attempted across incompatible model
    configs — the adapter bytes would be reinterpreted under the wrong
    schema."""
