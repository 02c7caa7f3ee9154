"""Activation-sharding hints (``cfg.act_sharding``).

The JAX package pins activations to mesh axes with
``with_sharding_constraint``.  The port runs on one device, where there
is nothing to pin, so ``shard_hint`` is the identity.
"""
from __future__ import annotations

__all__ = ["shard_hint"]


def shard_hint(x, *spec):
    return x
