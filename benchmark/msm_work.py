"""The least work of an MSM, and the least time the card could take for it.

Pippenger's bucket method over n points and 254-bit scalars with signed
c-bit digits: ceil(254 / c) windows, each putting every point into one of
2^(c-1) buckets (n mixed adds) and summing its buckets by running sums
(2 adds a bucket, 2^c).  The least work minimises that over c and counts
every add as a mixed add of 11 field products (7 multiplications and 4
squarings, madd-2007-bl); the window doublings (254) are left out.  It
depends on the point count only, never on the route the program takes.

A field product is 264 32-bit IMADs (a CIOS Montgomery product over eight
32-bit limbs: 8 x (8 + 8) products, each a low and a high IMAD, and 8 low
products for m), and an SM issues 64 IMADs a clock: the model of the
program's field bench, frozen here with the card's SM count and clock in
`peaks.json`.
"""

from __future__ import annotations

SCALAR_BITS = 254
PRODUCTS_PER_MIXED_ADD = 11
MAX_WINDOW = 31


def least_adds(n: int) -> int:
    """min over c of ceil(254 / c) (n + 2^c); 0 for no points."""
    if n <= 0:
        return 0
    return min(-(-SCALAR_BITS // c) * (n + (1 << c))
               for c in range(1, MAX_WINDOW + 1))


def least_seconds(n: int, peak: dict) -> float:
    """The least time of an MSM of n points at the card's IMAD peak."""
    imads = least_adds(n) * PRODUCTS_PER_MIXED_ADD * peak["imads_per_product"]
    rate = peak["imads_per_sm_clock"] * peak["sms"] * peak["sm_clock_hz"]
    return imads / rate
