"""Coded transmit signals for travel-time tomography.

Ocean acoustic tomography transmits phase-modulated maximal-length
sequences (m-sequences): their circular autocorrelation is L at zero lag
and -1 everywhere else (L = 2^order - 1 digits), so matched filtering
(`Response.correlate`) compresses a long, low-peak-power transmission
into one clean arrival pulse per eigenray with processing gain ~L.
The reference package stops at arrival kinematics; these generators feed
`response.received_waveform` to synthesize what the receiver actually
records for such a transmission.

`msequence_code` produces the +-1 digit sequence from the standard
primitive-polynomial LFSR taps; `msequence_signal` phase-modulates a
carrier with it, one digit per `cycles_per_digit` carrier cycles, using
the tomography convention ``s(t) = cos(2 pi fc t + phi * m(t))`` with
modulation angle ``phi = atan(sqrt(L))`` (the angle that maximizes the
power in the information-carrying sidebands while keeping a carrier
component for phase tracking — Worcester-style OAT transmissions).
All host-side numpy: signal generation is receiver-side bookkeeping,
never device work.  (A copy of ``pygenray_tpu/signals.py``.)
"""

from __future__ import annotations

import numpy as np

__all__ = ["msequence_code", "msequence_signal"]

# primitive-polynomial feedback taps (1-indexed register stages XORed
# into the new bit) for each register order; the standard minimal-tap
# choices, e.g. x^10 + x^3 + 1 for order 10 (L = 1023, the classic OAT
# sequence length)
_TAPS = {
    2: (2, 1), 3: (3, 2), 4: (4, 3), 5: (5, 3), 6: (6, 5), 7: (7, 6),
    8: (8, 6, 5, 4), 9: (9, 5), 10: (10, 3), 11: (11, 9),
    12: (12, 11, 8, 6), 13: (13, 12, 10, 9), 14: (14, 13, 8, 4),
    15: (15, 14), 16: (16, 15, 13, 4),
}


def msequence_code(order: int, seed: int = 1) -> np.ndarray:
    """The +-1 maximal-length sequence of length ``2**order - 1``.

    Fibonacci LFSR over GF(2) with the standard primitive taps; any
    nonzero ``seed`` (the initial register contents, low ``order`` bits)
    generates the same sequence up to a cyclic shift.
    """
    if order not in _TAPS:
        raise ValueError(
            f"order must be one of {sorted(_TAPS)} (got {order})"
        )
    seed = int(seed) & ((1 << order) - 1)
    if seed == 0:
        raise ValueError("seed must be nonzero")
    L = (1 << order) - 1
    # Fibonacci LFSR: stages s[0..n-1], output s[-1], feedback (the XOR
    # of the polynomial's tap stages) shifts in at s[0]
    state = [(seed >> i) & 1 for i in range(order)]
    out = np.empty(L, np.int8)
    taps = [t - 1 for t in _TAPS[order]]
    for i in range(L):
        out[i] = state[-1]
        fb = 0
        for t in taps:
            fb ^= state[t]
        state = [fb] + state[:-1]
    return 2 * out.astype(np.float64) - 1.0


def msequence_signal(
    order: int,
    center_frequency: float,
    fs: float,
    *,
    cycles_per_digit: int = 2,
    modulation_angle: float = None,
    seed: int = 1,
) -> np.ndarray:
    """Phase-modulated m-sequence transmission, sampled at ``fs``.

    One code digit spans ``cycles_per_digit`` carrier cycles (digit rate
    ``fc / cycles_per_digit``); the full sequence lasts
    ``(2**order - 1) * cycles_per_digit / fc`` seconds.  The carrier
    phase is shifted by ``+-modulation_angle`` per digit (default
    ``atan(sqrt(L))``, the standard tomography choice).  ``fs`` must
    resolve the carrier (``fs > 2 * fc``; 8-16x is typical).  Feed the
    result to `received_waveform` as the source and to
    `Response.correlate` as the replica.
    """
    fc = float(center_frequency)
    fs = float(fs)
    if fc <= 0.0 or fs <= 2.0 * fc:
        raise ValueError("need center_frequency > 0 and fs > 2*fc")
    code = msequence_code(order, seed=seed)
    L = code.size
    phi = (np.arctan(np.sqrt(L)) if modulation_angle is None
           else float(modulation_angle))
    digit_dur = cycles_per_digit / fc
    n = int(round(L * digit_dur * fs))
    t = np.arange(n) / fs
    digit = np.minimum((t / digit_dur).astype(np.int64), L - 1)
    return np.cos(2.0 * np.pi * fc * t + phi * code[digit])
