"""Deterministic RNGs reproducing miniMD's setup-time random streams.

Two generators are needed for bit-exact setup parity with the reference
(`ref/setup.cpp:496-517` Park-Miller; `ref/atom.cpp:97` + `ref/ljs.cpp:110`
glibc rand for type assignment). Both are implemented vectorized in NumPy:
setup is host-side work that runs once. A copy of minimd_tpu.rng.
"""

from __future__ import annotations

import numpy as np

# Park-Miller minimal standard LCG constants (Schrage factorization),
# matching ref/setup.cpp:498-503.
_IA = 16807
_IM = 2147483647
_AM = 1.0 / _IM
_IQ = 127773
_IR = 2836


def park_miller_step(state: np.ndarray) -> np.ndarray:
    """One Schrage-factorized Park-Miller step on an int64 array of states.

    Exactly reproduces ref/setup.cpp:505-517 `random(int*)` (including its
    behaviour for states that are not in the canonical (0, IM) range, since
    the reference does no masking).
    """
    state = state.astype(np.int64)
    k = state // _IQ
    # C integer division truncates toward zero; states here are always
    # non-negative after the first step, and initial lattice seeds are >= 1,
    # so floor division matches.
    state = _IA * (state - k * _IQ) - _IR * k
    state = np.where(state < 0, state + _IM, state)
    return state


def park_miller_velocity_triplet(seed: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return (vx, vy, vz) for an array of lattice-site seeds.

    The reference warms the generator 5 times and takes the 6th draw per
    component (ref/setup.cpp:378-391): vx = draw 6, vy = draw 12, vz = draw 18.
    """
    state = np.asarray(seed, dtype=np.int64)
    draws = []
    for _ in range(3):
        for _ in range(5):
            state = park_miller_step(state)
        state = park_miller_step(state)
        draws.append(_AM * state.astype(np.float64))
    return draws[0], draws[1], draws[2]


class GlibcRand:
    """glibc's rand() (TYPE_3 additive-feedback generator).

    Reproduces `srand(5413); rand()%ntypes` used for atom-type assignment
    (ref/ljs.cpp:110, ref/atom.cpp:97). Types never change the physics of the
    shipped decks (all type pairs share identical parameters), but we keep the
    assignment bit-exact for full parity.
    """

    def __init__(self, seed: int = 5413):
        self.seed(seed)

    def seed(self, seed: int) -> None:
        if seed == 0:
            seed = 1
        r = np.zeros(344, dtype=np.int64)
        r[0] = seed
        for i in range(1, 31):
            # r[i] = (16807 * r[i-1]) % 2147483647 computed via Schrage to
            # mirror glibc's overflow-free formulation.
            hi, lo = r[i - 1] // 127773, r[i - 1] % 127773
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        for i in range(34, 344):
            r[i] = (r[i - 31] + r[i - 3]) % (1 << 32)
        self._r = list(r[-31:].astype(np.uint64))
        # self._r holds the last 31 generated words; next output uses
        # r[n-31] + r[n-3].

    def rand(self) -> int:
        word = (int(self._r[0]) + int(self._r[28])) % (1 << 32)
        self._r.pop(0)
        self._r.append(np.uint64(word))
        return word >> 1

    def rand_array(self, n: int, mod: int) -> np.ndarray:
        """n successive rand()%mod draws."""
        out = np.empty(n, dtype=np.int32)
        for i in range(n):
            out[i] = self.rand() % mod
        return out
