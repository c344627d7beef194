"""FFT-friendly grid sizes.

Port of ``next_fft_size`` from ``uammd_tpu/core/grid.py`` (:75-114;
reference: src/utils/Grid.cuh:142, nextFFTWiseSize3D). The ``Grid`` class
is not ported yet: no ported path needs it.
"""

from __future__ import annotations


def next_fft_size(n: int, prefer_pow2: bool = False, tile_safe_support: int | None = None,
                  pencil_safe: bool = False) -> int:
    """Smallest m >= n with only factors {2, 3, 5, 7}.

    ``prefer_pow2`` returns the next power of two instead.
    ``tile_safe_support`` also requires the size to suit the tiled
    spread/interpolate path for that kernel support (m % 8 == 0 or
    m % 8 >= ceil(support / 2); a multiple of 4 for supports <= 8), and
    ``pencil_safe`` requires m % 8 == 0 (the pencil path)."""
    def tile_ok(m):
        if pencil_safe and m % 8 != 0:
            return False
        if tile_safe_support is None:
            return True
        half = (tile_safe_support + 1) // 2
        if half <= 4:
            return m % 4 == 0
        w = m % 8
        return w == 0 or w >= half

    if prefer_pow2:
        return 1 << max(0, (n - 1)).bit_length()
    m = max(1, n)
    while True:
        k = m
        for p in (2, 3, 5, 7):
            while k % p == 0:
                k //= p
        if k == 1 and tile_ok(m):
            return m
        m += 1
