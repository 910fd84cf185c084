"""Gradient compression for the data-parallel all-reduce: waits for the
port's sharding.  The reference (``repro.train.compression``) quantizes
each rank's gradient to int8 blocks and all-reduces that payload with a
``shard_map`` psum over its DP mesh axis, with error feedback; the port
has no data-parallel mesh yet (ROADMAP queue 1 entry 15)."""

from __future__ import annotations


def compressed_mean(*args, **kwargs):
    """The int8 compressed mean-all-reduce over the DP axis."""
    raise NotImplementedError(
        "compressed_mean is not ported yet: it is an all-reduce over a "
        "data-parallel mesh (ROADMAP queue 1 entry 15)")
