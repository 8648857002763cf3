"""Seeded host stream for measurement outcomes and sampling keys.

A port of quest_tpu/random_.py. The reference QuEST draws outcomes from
a globally seeded Mersenne Twister (mt19937ar.c) seeded by init_by_array,
with time + pid as the default seed (QuEST_common.c:181-213). As in the
reference, the native host library (native.py: init_by_array,
genrand_int32, genrand_real1 of native/quest_host.cpp) is that
generator whenever it loads (`_use_native`). Without it the Python
stream takes over, saying so once (native.warn_degraded):
`_init_by_array` builds the same generator state (mt19937ar.c's
init_by_array, in Python: numpy would seed a one-word key through
init_genrand instead) and numpy's legacy `RandomState` draws from it.
The two streams are equal word for word, so with equal seeds the words
and uniforms here equal the reference binary's either way:

  genrand_int32  one 32-bit word: randint(0, 2^32) of the state;
  genrand_real1  that word x 1/4294967295, a uniform in [0, 1].

Measurements (measurement.measure_with_stats) draw their uniforms here;
measurement.sample seeds its torch.Generator from one word when the
caller gives none.
"""

from __future__ import annotations

import os
import time

import numpy as np

from quest_tpu_torch import native

_N = 624
_MASK = 0xFFFFFFFF
_state: np.random.RandomState = None
_use_native = None          # None: not seeded yet; then True or False


def _init_by_array(key) -> np.ndarray:
    """The 624-word MT19937 state of mt19937ar.c's init_by_array(key)."""
    mt = [19650218]
    for i in range(1, _N):
        mt.append((1812433253 * (mt[-1] ^ (mt[-1] >> 30)) + i) & _MASK)
    i, j = 1, 0
    for _ in range(max(_N, len(key))):
        mt[i] = ((mt[i] ^ ((mt[i - 1] ^ (mt[i - 1] >> 30)) * 1664525))
                 + key[j] + j) & _MASK
        i, j = i + 1, j + 1
        if i >= _N:
            mt[0], i = mt[_N - 1], 1
        if j >= len(key):
            j = 0
    for _ in range(_N - 1):
        mt[i] = ((mt[i] ^ ((mt[i - 1] ^ (mt[i - 1] >> 30)) * 1566083941))
                 - i) & _MASK
        i += 1
        if i >= _N:
            mt[0], i = mt[_N - 1], 1
    mt[0] = 0x80000000
    return np.asarray(mt, dtype=np.uint32)


def seed_quest(seeds) -> None:
    """Seed the stream from a list of ints (ref seedQuEST,
    QuEST_common.c:207-213): the native generator when the library
    loads, else the Python one."""
    global _state, _use_native
    key = [int(s) & _MASK for s in np.asarray(seeds, dtype=np.uint64)]
    _use_native = native.available()
    if _use_native:
        native.init_by_array(key)
        return
    native.warn_degraded("the MT19937 stream (random_)")
    _state = np.random.RandomState()
    _state.set_state(("MT19937", _init_by_array(key), _N, 0, 0.0))


def seed_quest_default() -> None:
    """Seed from time + pid (ref getQuESTDefaultSeedKey,
    QuEST_common.c:181-203)."""
    seed_quest([int(time.time() * 1000) & 0xFFFFFFFF, os.getpid()])


def uint32() -> int:
    """One full 32-bit word of the stream (ref genrand_int32)."""
    if _use_native is None:
        seed_quest_default()
    if _use_native:
        return native.genrand_int32()
    return int(_state.randint(0, 1 << 32, dtype=np.uint64))


def uniform() -> float:
    """One uniform in [0, 1] (ref genrand_real1)."""
    if _use_native is None:
        seed_quest_default()
    if _use_native:
        return native.genrand_real1()
    return uint32() * (1.0 / 4294967295.0)
