"""Device-parallel parts of the JAX package's ``parallel/``: so far the
single-device auction matching (``matching_dev.auction_match``).  The mesh,
the distributed SPIKE solves, their autodiff and elastic serving, and the
mesh auction ``auction_match_dist`` are not yet ported (ROADMAP Queue 1
item 5)."""

from .matching_dev import auction_match, auction_match_dist

__all__ = ["auction_match", "auction_match_dist"]
