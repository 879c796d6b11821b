"""Weight initialization with bit-exact draw parity to the reference.

The reference initializes all weights from a single ``numpy.random.RandomState``
seeded with ``training_params['SEED']`` and consumes draws in layer-constructor
order (reference: theanet/layer/weights.py:25-81 and the per-layer
``rand_gen.randint(1e6)`` RandomStreams seeds). To let a checkpoint produced by
either framework start from numerically identical weights given the same SEED,
this module reproduces those draws *exactly*, including the quirks:

  * 4-D conv filters: random signs (2*randint(2)-1) / sqrt(fan_in)
    (weights.py:52-54).
  * dense: U(-1,1) * sqrt(6/(fan_in+fan_out)) (weights.py:56-57).
  * sigmoid gets x4 weights (weights.py:62-63).
  * bias starts at 0.5 for 'softplus', 'relu', and names starting with
    'relu0' -- i.e. relu00..relu09 only, NOT relu10+ (weights.py:64-65).
    This asymmetry is load-bearing for seed parity; do not "fix" it.

Stochastic layers additionally consume one ``randint(1e6)`` from the same
stream to seed their per-batch RNG (e.g. reference inlayers.py:72-73); we
consume the identical draw so the weights that follow stay bit-identical.

A copy of ``theanet_tpu/inits.py``: the port cannot import the JAX package
(its ``__init__`` imports JAX), and ``tests/test_torch_inits_data.py`` holds
the two copies bit-equal.
"""

from __future__ import annotations

import numpy as np

__all__ = ["init_wb", "consume_stream_seed"]

FLOATX = np.float32


def init_wb(wb, rng, size_w, size_b, fan_in, fan_out, actvn):
    """Return (w, b) numpy arrays.

    If ``wb`` is given (a sequence of two arrays, e.g. from a checkpoint) it is
    passed through unchanged. Otherwise weights are drawn from ``rng`` with the
    reference's exact draw order and scaling (weights.py:25-81).
    """
    if wb is not None:
        w, b = wb[0], wb[1]
        return np.asarray(w), np.asarray(b)

    if len(size_w) == 4:
        w = 2.0 * rng.randint(2, size=size_w) - 1
        w /= np.sqrt(fan_in)
    else:
        w = rng.uniform(low=-1, high=1, size=size_w)
        w *= np.sqrt(6.0 / (fan_in + fan_out))

    w = np.asarray(w, dtype=FLOATX)
    b = np.zeros(size_b, dtype=FLOATX)

    if actvn == "sigmoid":
        w = w * 4
    if actvn in ("softplus", "relu") or actvn.startswith("relu0"):
        b = b + FLOATX(0.5)

    return w, b


def consume_stream_seed(rng) -> int:
    """Consume one RandomStreams-seed draw, mirroring rand_gen.randint(1e6).

    Returns a deterministic fallback when rng is None (the reference then lets
    Theano pick an arbitrary seed; we stay deterministic instead).
    """
    if rng is None:
        return 12345
    return int(rng.randint(int(1e6)))
