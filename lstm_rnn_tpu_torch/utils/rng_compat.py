"""CURRENNT-compatible weight-init RNG stream (--init_rng currennt).

A copy of lstm_rnn_tpu/utils/rng_compat.py (numpy only): the port never
imports the JAX package, whose `__init__` imports jax.

The reference seeds ONE static boost::mt19937 with --random_seed and draws
every randomly-initialized layer's weights sequentially from it, in layer
construction order, in the flat [input | bias | internal] storage order
(TrainableLayer.cu:103-125). Same-seed runs are therefore bit-comparable
across toolkits only if the stream is replayed exactly.

This module reimplements that stream:

- MT19937: the standard Mersenne Twister (Matsumoto & Nishimura 1998) with
  the standard `init_genrand` single-word seeding — bit-identical to
  boost::mt19937 AND std::mt19937 (the test suite cross-validates the raw
  32-bit outputs against a std::mt19937 program compiled on the fly).
- boost::random::uniform_real_distribution<float> semantics
  (boost/random/uniform_real_distribution.hpp, generate_uniform_real):
  each draw maps one engine output x to float32(x) / 2^32 * (b-a) + a and
  RETRIES on the (≈3e-8 probability) event that rounding pushes the result
  to b. The reference draws from dist(0, max-min) and adds min afterwards
  (TrainableLayer.cu:115-118) — reproduced literally, as the two forms
  round differently.
- normal init is NOT replayed, because no single reference stream exists
  to replay: the reference requires only `Boost 1.48.0` as a version
  floor (CMakeLists.txt:6) and boost::random::normal_distribution
  changed algorithms at boost 1.57 (Box-Muller before; ziggurat with
  boost-private tables + int_float_pair draw packing after, refined
  again in later releases) — two valid builds of the reference produce
  different normal-init networks from the same seed. Requesting
  --init_rng currennt with --weights_dist normal therefore raises an
  explicit error instead of claiming an unverifiable, ill-posed parity.
  Every shipped reference recipe uses the default uniform init.
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER = 0x80000000
_LOWER = 0x7FFFFFFF


class MT19937:
    """Standard MT19937 over numpy uint32 blocks (vectorized twist)."""

    def __init__(self, seed: int):
        mt = np.empty(_N, dtype=np.uint64)
        mt[0] = seed & 0xFFFFFFFF
        for i in range(1, _N):
            mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> 30)) + i) \
                & 0xFFFFFFFF
        self._mt = mt.astype(np.uint32)
        self._buf = np.empty(0, dtype=np.uint32)
        self._pos = 0

    def _twist(self) -> None:
        mt = self._mt.astype(np.uint64)
        # mt[i] depends on mt[i+1] (old) and mt[(i+M)%N] which may be a
        # value UPDATED earlier in this pass — process in chunks whose
        # dependencies are entirely in completed chunks: [0,227), [227,454),
        # [454,623), then the final element (which reads the new mt[0]).
        out = mt.copy()
        for lo, hi in ((0, _N - _M), (_N - _M, 2 * (_N - _M)),
                       (2 * (_N - _M), _N - 1)):
            i = np.arange(lo, hi)
            y = (out[i] & _UPPER) | (mt[i + 1] & _LOWER)
            out[i] = out[(i + _M) % _N] ^ (y >> 1) ^ ((y & 1) * _MATRIX_A)
        y = (out[_N - 1] & _UPPER) | (out[0] & _LOWER)
        out[_N - 1] = out[_M - 1] ^ (y >> 1) ^ ((y & 1) * _MATRIX_A)
        self._mt = out.astype(np.uint32)

        # tempering
        y = out
        y = y ^ (y >> 11)
        y = (y ^ ((y << 7) & 0x9D2C5680)) & 0xFFFFFFFF
        y = (y ^ ((y << 15) & 0xEFC60000)) & 0xFFFFFFFF
        y = y ^ (y >> 18)
        self._buf = y.astype(np.uint32)
        self._pos = 0

    def raw(self, n: int) -> np.ndarray:
        """Next n tempered 32-bit outputs."""
        chunks = []
        while n > 0:
            if self._pos >= self._buf.size:
                self._twist()
            take = min(n, self._buf.size - self._pos)
            chunks.append(self._buf[self._pos:self._pos + take])
            self._pos += take
            n -= take
        return np.concatenate(chunks) if len(chunks) != 1 else chunks[0]

    def raw1(self) -> int:
        return int(self.raw(1)[0])


class CurrenntInitStream:
    """The reference's shared init stream: one engine, sequential draws."""

    _DIV = np.float32(4294967296.0)  # float32(2^32-1) + 1 rounds to 2^32

    def __init__(self, seed: int):
        self.engine = MT19937(seed)

    def uniform(self, n: int, lo: float, hi: float) -> np.ndarray:
        """n float32 draws of `dist(0, hi-lo) + lo` in stream order."""
        rng = np.float32(hi) - np.float32(lo)
        raw = self.engine.raw(n)
        num = raw.astype(np.float32)  # rounds to nearest, ties to even
        v = num / self._DIV * rng  # dist(0, range) draw
        # boost retries a draw whose rounded result reaches the upper
        # bound (prob ~3e-8); a retry consumes extra engine outputs AT
        # THAT STREAM POSITION, so everything after it must be redrawn
        bad = np.nonzero(v >= rng)[0]
        if bad.size:
            i = int(bad[0])
            while True:
                x = np.float32(self.engine.raw1())
                vi = x / self._DIV * rng
                if vi < rng:
                    break
            v[i] = vi
            if i + 1 < n:
                out = v + np.float32(lo)
                out[i + 1:] = self.uniform(n - i - 1, lo, hi)
                return out
        return v + np.float32(lo)


def currennt_init_flat(stream: CurrenntInitStream, n_weights: int,
                       dist: str, lo: float, hi: float) -> np.ndarray:
    """One layer's flat [input|bias|internal] init vector in draw order."""
    if dist != "uniform":
        raise ValueError(
            "--init_rng currennt replays boost's uniform stream only. "
            "There is no single reference normal stream to replay: the "
            "reference requires only Boost >= 1.48 and boost's "
            "normal_distribution algorithm changed at 1.57 (Box-Muller "
            "-> ziggurat), so same-seed normal init differs between "
            "valid reference builds — use --weights_dist uniform or "
            "--init_rng numpy")
    return stream.uniform(n_weights, lo, hi)
