"""Band-limited channel impulse response from ray arrivals.

Counterpart of ``pygenray_tpu/response.py``.  The reference package
(pygenray) stops at arrival kinematics; `amplitudes.arrival_amplitudes` adds the complex arrival
factors, and this module finishes the pipeline with the quantity an
ocean-acoustics user ultimately wants at the receiver: the **received
waveform** for a band-limited source — the superposition of wave
packets, one per eigenray, each delayed by its travel time, scaled by
its spreading amplitude, and rotated by its reflection/caustic phase.

Synthesis is the standard analytic-signal construction (Jensen,
Kuperman, Porter & Schmidt, *Computational Ocean Acoustics*, ch. 8.4):
for a source wavelet with complex analytic signal ``s_a(t)``, arrival
``k`` contributes ``A_k exp(i phi_k) s_a(t - t_k)`` and the real
received waveform is the real part of the sum.  Multiplying the
*analytic* signal by ``exp(i phi_k)`` is what makes the frequency-flat
KMAH ``-pi/2`` act as the 90-degree (Hilbert) rotation of the arrival
shape — the classic caustic-distorted wavelet — while a surface bounce
(``phi = pi``) simply inverts it.

The default wavelet is a Gaussian-envelope cosine at ``center_frequency``
whose power spectrum has full width ``bandwidth`` at -3 dB; its envelope
std is ``sigma_t = sqrt(2 ln 2) / (pi * bandwidth)``.  All of this is
host-side numpy post-processing: the device work (one traced fan with a
forward tangent) already happened inside ``arrival_amplitudes``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .amplitudes import Arrivals, arrival_amplitudes

__all__ = ["Response", "ArrayResponse", "synthesize_response",
           "impulse_response", "array_response", "received_waveform",
           "thorp_attenuation"]


@dataclasses.dataclass(frozen=True)
class Response:
    """Received band-limited waveform at one receiver.

    ``waveform`` is the real received pressure (relative to the source
    level at 1 m); ``analytic`` its complex analytic signal, so
    ``envelope() = |analytic|`` is the arrival-packet envelope whose
    peaks sit at the eigenray travel times.
    """

    t: np.ndarray               # (nt,) time grid (s)
    waveform: np.ndarray        # (nt,) real received waveform
    analytic: np.ndarray        # (nt,) complex analytic waveform
    arrivals: Arrivals          # the per-eigenray factors that built it
    center_frequency: float     # Hz
    bandwidth: float            # -3 dB full power bandwidth (Hz)

    def envelope(self) -> np.ndarray:
        return np.abs(self.analytic)

    def save_npz(self, filename):
        """Numpy-native export (round-trips with ``Response.load_npz``);
        the source ``Arrivals`` ride along under ``arrivals_*`` keys."""
        np.savez(
            filename, t=self.t, analytic=self.analytic,
            center_frequency=self.center_frequency, bandwidth=self.bandwidth,
            **{f"arrivals_{f.name}": getattr(self.arrivals, f.name)
               for f in dataclasses.fields(Arrivals)
               if getattr(self.arrivals, f.name) is not None},
        )

    @classmethod
    def load_npz(cls, filename):
        d = np.load(filename)
        arr = Arrivals(**{f.name: d[f"arrivals_{f.name}"]
                          for f in dataclasses.fields(Arrivals)
                          if f"arrivals_{f.name}" in d})
        analytic = d["analytic"]
        return cls(
            t=d["t"], waveform=analytic.real, analytic=analytic,
            arrivals=arr, center_frequency=float(d["center_frequency"]),
            bandwidth=float(d["bandwidth"]),
        )

    def plot(self, ax=None):
        """Waveform + envelope with arrival-time markers."""
        from matplotlib import pyplot as plt

        if ax is None:
            _, ax = plt.subplots(figsize=(8, 4))
        ax.plot(self.t, self.waveform, lw=0.7, label="waveform")
        ax.plot(self.t, self.envelope(), lw=1.2, label="envelope")
        ok = self.arrivals.alive & np.isfinite(self.arrivals.amplitude)
        for tk in self.arrivals.travel_time[ok]:
            ax.axvline(tk, color="k", lw=0.5, alpha=0.3)
        ax.set_xlabel("time (s)")
        ax.set_ylabel("pressure re 1 m")
        ax.legend(loc="upper right", fontsize=8)
        return ax

    def correlate(self, source: np.ndarray, fs: float) -> "Response":
        """Matched-filter pulse compression against a source replica.

        Returns a new `Response` whose waveform is the cross-correlation
        ``c(t) = (1/E) * integral y(u) s(u - t) du`` (``E`` the replica
        energy ``integral s^2``), so a received copy ``A s(t - tau)`` of
        the replica compresses to an envelope peak of height ``~A`` at
        ``t = tau`` — the standard tomography observable for coded
        transmissions (m-sequences, chirps).  ``source`` is the replica
        sampled at ``fs`` from its own time zero; the time axis of the
        result is the same absolute axis as ``self.t``.  ``fs`` must
        match the grid this response was synthesized on.
        """
        s = np.asarray(source, float)
        fs = float(fs)
        dt = float(self.t[1] - self.t[0])
        if abs(dt * fs - 1.0) > 1e-6:
            raise ValueError(
                f"replica sample rate {fs} does not match the response "
                f"grid spacing {dt} (= {1.0 / dt} Hz)"
            )
        n = self.t.size
        N = 1 << int(np.ceil(np.log2(n + s.size)))
        Y = np.fft.rfft(self.waveform, N)
        S = np.fft.rfft(s, N)
        E = float((s * s).sum()) / fs
        spec = Y * np.conj(S) / (E * fs)
        c_a = _irfft_analytic(spec, N)[:n]
        return Response(
            t=self.t, waveform=c_a.real, analytic=c_a,
            arrivals=self.arrivals, center_frequency=self.center_frequency,
            bandwidth=self.bandwidth,
        )


def _irfft_analytic(spec: np.ndarray, N: int) -> np.ndarray:
    """Analytic (complex) time signal from an rfft half-spectrum.

    The real part equals ``np.fft.irfft(spec, N)``; the imaginary part is
    its Hilbert transform (negative frequencies zeroed, positive doubled).
    """
    Z = np.zeros(N, np.complex128)
    Z[0] = spec[0]
    if N % 2 == 0:
        Z[1 : N // 2] = 2.0 * spec[1 : N // 2]
        Z[N // 2] = spec[N // 2]
    else:
        Z[1 : (N + 1) // 2] = 2.0 * spec[1:]
    return np.fft.ifft(Z)


def _attenuation_db_per_km(attenuation, f_hz: np.ndarray) -> np.ndarray:
    """Evaluate an attenuation spec (``"thorp"`` / float / callable) on a
    frequency grid, elementwise in dB/km."""
    f_hz = np.asarray(f_hz, float)
    if isinstance(attenuation, str):
        if attenuation != "thorp":
            raise ValueError(f"unknown attenuation model {attenuation!r}")
        f2 = (f_hz / 1e3) ** 2
        return (0.11 * f2 / (1.0 + f2) + 44.0 * f2 / (4100.0 + f2)
                + 2.75e-4 * f2 + 0.003)
    if callable(attenuation):
        try:
            a = np.asarray(attenuation(f_hz), float)
            if a.shape == f_hz.shape:
                return a
        except Exception:
            pass
        return np.asarray([float(attenuation(f)) for f in f_hz.ravel()],
                          float).reshape(f_hz.shape)
    return np.full(f_hz.shape, float(attenuation))


def thorp_attenuation(f_hz: float) -> float:
    """Thorp's seawater volume-absorption coefficient (dB/km).

    The canonical low-frequency formula (Thorp 1967; Jensen et al. ch.
    1.5, f in kHz)::

        alpha = 0.11 f^2/(1+f^2) + 44 f^2/(4100+f^2)
                + 2.75e-4 f^2 + 0.003
    """
    f2 = (float(f_hz) / 1e3) ** 2
    return (0.11 * f2 / (1.0 + f2) + 44.0 * f2 / (4100.0 + f2)
            + 2.75e-4 * f2 + 0.003)


def synthesize_response(
    arrivals: Arrivals,
    center_frequency: float,
    *,
    bandwidth: float = None,
    fs: float = None,
    t: np.ndarray = None,
    attenuation=None,
    bottom_loss_db: float = 0.0,
) -> Response:
    """Sum band-limited wave packets from an `Arrivals` set.

    ``bandwidth`` defaults to ``center_frequency / 2``; ``fs`` (sample
    rate) to ``8 * center_frequency``.  Pass an explicit time grid ``t``
    to synthesize several receivers onto a common axis; otherwise the
    grid spans the arrival spread padded by 4 envelope-sigmas per side.
    Dead rays (NaN amplitude) are skipped; raises if no arrival is alive.

    ``attenuation`` adds volume absorption over each arrival's path
    length (requires ``arrivals.path_length``): ``"thorp"`` evaluates
    `thorp_attenuation` at the center frequency, a float is dB/km
    directly, a callable maps ``f_hz -> dB/km``.  Narrowband
    approximation — one coefficient across the band (at 75 Hz over
    100 km Thorp costs ~0.35 dB; it grows quadratically with frequency).

    ``bottom_loss_db`` subtracts that many dB per bottom bounce
    (``arrivals.n_bott``) — the standard summary when sediment
    parameters are reduced to a per-bounce reflection loss; angle
    dependence is not modeled.  Defaults (``None``/0) match the
    reference's lossless reflection model.
    """
    fc = float(center_frequency)
    if fc <= 0.0:
        raise ValueError("center_frequency must be positive")
    bw = fc / 2.0 if bandwidth is None else float(bandwidth)
    sigma_t = np.sqrt(2.0 * np.log(2.0)) / (np.pi * bw)

    ok = np.asarray(arrivals.alive, bool) & np.isfinite(arrivals.amplitude)
    if not ok.any():
        raise ValueError("synthesize_response: no alive arrivals")
    tk = np.asarray(arrivals.travel_time, float)[ok]
    ak = np.asarray(arrivals.amplitude, float)[ok]
    ph = np.asarray(arrivals.phase, float)[ok]
    if attenuation is not None:
        if arrivals.path_length is None:
            raise ValueError(
                "attenuation needs arrivals.path_length (archives written "
                "before the field existed lack it)"
            )
        if attenuation == "thorp":
            alpha = thorp_attenuation(fc)
        elif callable(attenuation):
            alpha = float(attenuation(fc))
        else:
            alpha = float(attenuation)
        L_km = np.asarray(arrivals.path_length, float)[ok] / 1e3
        ak = ak * 10.0 ** (-alpha * L_km / 20.0)
    if bottom_loss_db:
        nb = np.asarray(arrivals.n_bott, float)[ok]
        ak = ak * 10.0 ** (-float(bottom_loss_db) * nb / 20.0)

    if t is None:
        if fs is None:
            fs = 8.0 * fc
        pad = 4.0 * sigma_t
        t0 = tk.min() - pad
        nt = int(np.ceil((tk.max() + pad - t0) * fs)) + 1
        t = t0 + np.arange(nt) / fs
    else:
        t = np.asarray(t, float)

    # analytic wavelet per arrival; (K, nt) then summed.  Memory guard:
    # chunk the arrival axis so K x nt complex temporaries stay small.
    analytic = np.zeros(t.shape, np.complex128)
    factor = ak * np.exp(1j * ph)
    chunk = max(1, int(4e6 // max(t.size, 1)))
    for i in range(0, tk.size, chunk):
        tau = t[None, :] - tk[i : i + chunk, None]
        wa = np.exp(-0.5 * (tau / sigma_t) ** 2 + 2j * np.pi * fc * tau)
        analytic += (factor[i : i + chunk, None] * wa).sum(axis=0)

    return Response(
        t=t,
        waveform=analytic.real,
        analytic=analytic,
        arrivals=arrivals,
        center_frequency=fc,
        bandwidth=bw,
    )


def received_waveform(
    arrivals: Arrivals,
    source: np.ndarray,
    fs: float,
    *,
    t: np.ndarray = None,
    attenuation=None,
    bottom_loss_db: float = 0.0,
) -> Response:
    """Received waveform for an ARBITRARY source signal.

    Where `synthesize_response` assumes the canonical Gaussian-cosine
    wavelet, this propagates a user-supplied transmit signal (an
    m-sequence, an LFM chirp, a measured signature...) through the ray
    channel: arrival ``k`` contributes ``A_k Re[e^{i phi_k} s_a(t - tau_k)]``
    with ``s_a`` the analytic signal of ``source`` — the exact
    analytic-signal construction, evaluated in the frequency domain with
    exact (fractional-sample) delays.

    ``source`` is the real transmit signal sampled at ``fs`` starting at
    its own time zero, so source time zero arrives at each eigenray's
    travel time.  ``t`` (optional) is a uniform output grid with spacing
    ``1/fs`` — pass a shared grid to build array record sections;
    the default spans the arrival spread plus the source duration.

    ``attenuation`` here is applied PER FREQUENCY BIN (``"thorp"``, a
    dB/km float, or a callable ``f_hz -> dB/km``, evaluated across the
    whole band and scaled by each arrival's ``path_length``) — the
    broadband generalization of `synthesize_response`'s single-
    coefficient approximation.  ``bottom_loss_db`` subtracts that many
    dB per bottom bounce (``arrivals.n_bott``).

    Pair with `Response.correlate` for matched-filter pulse compression
    (the tomography observable for coded transmissions).
    """
    s = np.asarray(source, float)
    fs = float(fs)
    if s.ndim != 1 or s.size < 2:
        raise ValueError("source must be a 1-D signal with >= 2 samples")

    ok = np.asarray(arrivals.alive, bool) & np.isfinite(arrivals.amplitude)
    if not ok.any():
        raise ValueError("received_waveform: no alive arrivals")
    tk = np.asarray(arrivals.travel_time, float)[ok]
    ak = np.asarray(arrivals.amplitude, float)[ok]
    ph = np.asarray(arrivals.phase, float)[ok]
    if attenuation is not None and arrivals.path_length is None:
        raise ValueError(
            "attenuation needs arrivals.path_length (archives written "
            "before the field existed lack it)"
        )

    dur = s.size / fs
    if t is None:
        pad = 0.125 * dur
        t0 = tk.min() - pad
        nt = int(np.ceil((tk.max() + dur + pad - t0) * fs)) + 1
        t = t0 + np.arange(nt) / fs
    else:
        t = np.asarray(t, float)
        if t.size < 2 or abs((t[1] - t[0]) * fs - 1.0) > 1e-6:
            raise ValueError(
                "explicit t must be uniform with spacing 1/fs "
                f"(got {t[1] - t[0] if t.size > 1 else 'n/a'} vs {1.0 / fs})"
            )
        t0, nt = float(t[0]), t.size

    N = 1 << int(np.ceil(np.log2(nt + s.size)))
    S = np.fft.rfft(s, N)
    f = np.fft.rfftfreq(N, 1.0 / fs)

    # channel transfer function over the band; chunk the arrival axis so
    # the (K, nf) temporaries stay small
    H = np.zeros(f.shape, np.complex128)
    if bottom_loss_db:
        nb = np.asarray(arrivals.n_bott, float)[ok]
        ak = ak * 10.0 ** (-float(bottom_loss_db) * nb / 20.0)
    factor = ak * np.exp(1j * ph)
    if attenuation is not None:
        alpha_f = _attenuation_db_per_km(attenuation, f)  # (nf,) dB/km
        L_km = np.asarray(arrivals.path_length, float)[ok] / 1e3
    chunk = max(1, int(4e6 // max(f.size, 1)))
    for i in range(0, tk.size, chunk):
        phase_ramp = np.exp(
            -2j * np.pi * f[None, :] * (tk[i : i + chunk, None] - t0)
        )
        if attenuation is not None:
            phase_ramp = phase_ramp * 10.0 ** (
                -alpha_f[None, :] * L_km[i : i + chunk, None] / 20.0
            )
        H += (factor[i : i + chunk, None] * phase_ramp).sum(axis=0)

    y_a = _irfft_analytic(S * H, N)[:nt]

    # spectral centroid / rms width of the source, for the metadata slots
    p = np.abs(S) ** 2
    w = p.sum()
    fc = float((f * p).sum() / w) if w > 0 else 0.0
    bw = float(np.sqrt(max(((f - fc) ** 2 * p).sum() / w, 0.0))) if w > 0 else 0.0

    return Response(
        t=t, waveform=y_a.real, analytic=y_a, arrivals=arrivals,
        center_frequency=fc, bandwidth=bw,
    )


@dataclasses.dataclass(frozen=True)
class ArrayResponse:
    """Received waveforms for a vertical receiver array on one shared
    time grid: ``waveform[d]`` is receiver ``receiver_depths[d]``'s real
    waveform; ``responses[d]`` the full per-depth `Response` (a depth
    that captured no eigenrays gets a zero waveform and an empty
    arrivals container)."""

    receiver_depths: np.ndarray   # (nd,) positive down (m)
    t: np.ndarray                 # (nt,) shared time grid (s)
    waveform: np.ndarray          # (nd, nt)
    responses: list               # of Response

    def save_npz(self, filename):
        """Numpy-native export (round-trips with ``ArrayResponse.load_npz``).
        Per-depth arrivals ride along under ``r{d}_{field}`` keys; the
        shared grid, waveform matrix, and complex analytic rows at the top
        level."""
        payload = dict(
            receiver_depths=self.receiver_depths, t=self.t,
            waveform=self.waveform,
            analytic=np.stack([r.analytic for r in self.responses]),
            center_frequency=self.responses[0].center_frequency,
            bandwidth=self.responses[0].bandwidth,
        )
        for d, r in enumerate(self.responses):
            for f in dataclasses.fields(Arrivals):
                v = getattr(r.arrivals, f.name)
                if v is not None:
                    payload[f"r{d:04d}_{f.name}"] = v
        np.savez(filename, **payload)

    @classmethod
    def load_npz(cls, filename):
        d = np.load(filename)
        zd, t = d["receiver_depths"], d["t"]
        fc, bw = float(d["center_frequency"]), float(d["bandwidth"])
        analytic = d["analytic"]
        responses = []
        for k in range(zd.size):
            arr = Arrivals(**{f.name: d[f"r{k:04d}_{f.name}"]
                              for f in dataclasses.fields(Arrivals)
                              if f"r{k:04d}_{f.name}" in d})
            responses.append(Response(
                t=t, waveform=analytic[k].real, analytic=analytic[k],
                arrivals=arr, center_frequency=fc, bandwidth=bw,
            ))
        return cls(receiver_depths=zd, t=t, waveform=d["waveform"],
                   responses=responses)

    def plot(self, ax=None, scale=None):
        """Record section: each depth's waveform offset to its depth.
        ``scale`` maps unit pressure to meters of offset (default: the
        array spacing over twice the peak amplitude)."""
        from matplotlib import pyplot as plt

        if ax is None:
            _, ax = plt.subplots(figsize=(8, 6))
        zd = np.asarray(self.receiver_depths, float)
        if scale is None:
            spread = np.ptp(zd) if zd.size > 1 and np.ptp(zd) > 0 else 100.0
            peak = max(float(np.abs(self.waveform).max()), 1e-30)
            scale = spread / (2.0 * peak * max(zd.size - 1, 1))
        for d, z in enumerate(zd):
            ax.plot(self.t, z + scale * self.waveform[d], lw=0.6, color="C0")
        ax.invert_yaxis()
        ax.set_xlabel("time (s)")
        ax.set_ylabel("receiver depth (m)")
        return ax


def impulse_response(
    source_depth: float,
    source_range: float,
    receiver_depth: float,
    receiver_range: float,
    environment,
    center_frequency: float,
    *,
    bandwidth: float = None,
    fs: float = None,
    t: np.ndarray = None,
    attenuation=None,
    bottom_loss_db: float = 0.0,
    launch_angles=None,
    num_rays: int = 1024,
    max_angle: float = 15.0,
    num_save: int = 512,
    ztol: float = 1.0,
    rtol: float = 1e-9,
    flatearth: bool = True,
    dx: float = None,
    interp: str = "auto",
    dtype=None,
    device="cuda",
    backend: str = "auto",
) -> Response:
    """End-to-end received waveform at one receiver.

    Shoots a fan (``num_rays`` angles in ``[-max_angle, max_angle]``
    unless explicit ``launch_angles`` are given), finds the eigenrays
    reaching ``receiver_depth`` at ``receiver_range``, evaluates their
    complex arrival factors (`arrival_amplitudes` — one tangent-seeded
    kernel launch), and synthesizes the band-limited waveform.  Extra
    kwargs flow to the trace (dx, interp, dtype, device, backend); the
    device is the CUDA device unless the caller passes ``device="cpu"``.

    For a vertical array, run `eigenrays.find_eigenrays` once over all
    depths yourself, then `arrival_amplitudes` + `synthesize_response`
    per depth with a shared ``t`` grid.
    """
    from .eigenrays import find_eigenrays
    from .shoot import shoot_rays

    if launch_angles is None:
        launch_angles = np.linspace(-abs(max_angle), abs(max_angle), num_rays)
    launch_angles = np.atleast_1d(np.asarray(launch_angles, float))
    kw = dict(dx=dx, interp=interp, dtype=dtype, device=device, backend=backend)

    fan = shoot_rays(
        source_depth, source_range, launch_angles, receiver_range,
        num_save, environment, rtol=rtol, flatearth=flatearth, **kw,
    )
    erays = find_eigenrays(
        fan, np.asarray([float(receiver_depth)]), source_depth,
        source_range, receiver_range, num_save, environment,
        ztol=ztol, rtol=rtol, flatearth=flatearth, **kw,
    )
    th_eig = np.asarray(erays.launch_angles[0], float)
    if th_eig.size == 0:
        raise ValueError(
            "impulse_response: no eigenrays found — widen the fan "
            f"(max_angle={max_angle}) or loosen ztol ({ztol})"
        )
    arr = arrival_amplitudes(
        source_depth, source_range, th_eig, receiver_range, environment,
        num_save=max(int(num_save), 256), rtol=rtol, flatearth=flatearth,
        **kw,
    )
    return synthesize_response(
        arr, center_frequency, bandwidth=bandwidth, fs=fs, t=t,
        attenuation=attenuation, bottom_loss_db=bottom_loss_db,
    )


def array_response(
    source_depth: float,
    source_range: float,
    receiver_depths,
    receiver_range: float,
    environment,
    center_frequency: float,
    *,
    bandwidth: float = None,
    fs: float = None,
    attenuation=None,
    bottom_loss_db: float = 0.0,
    launch_angles=None,
    num_rays: int = 1024,
    max_angle: float = 15.0,
    num_save: int = 512,
    ztol: float = 1.0,
    rtol: float = 1e-9,
    flatearth: bool = True,
    dx: float = None,
    interp: str = "auto",
    dtype=None,
    device="cuda",
    backend: str = "auto",
) -> ArrayResponse:
    """Received waveforms for a vertical receiver array, one shared grid.

    The device-latency discipline of `eigenrays.find_eigenrays` carries
    through: ONE fan trace, ONE multi-depth eigenray solve, and ONE
    `arrival_amplitudes` call over every depth's converged launch angles
    concatenated (a single tangent-seeded kernel launch on a CUDA device), then the
    per-depth waveforms are synthesized onto a common time axis spanning
    all arrivals.  A depth that captured no eigenrays contributes a zero
    waveform row (and an empty arrivals container) rather than raising.
    """
    from .eigenrays import find_eigenrays
    from .shoot import shoot_rays

    zd = np.atleast_1d(np.asarray(receiver_depths, float))
    if launch_angles is None:
        launch_angles = np.linspace(-abs(max_angle), abs(max_angle), num_rays)
    launch_angles = np.atleast_1d(np.asarray(launch_angles, float))
    kw = dict(dx=dx, interp=interp, dtype=dtype, device=device, backend=backend)
    fc = float(center_frequency)
    bw = fc / 2.0 if bandwidth is None else float(bandwidth)
    if fs is None:
        fs = 8.0 * fc
    sigma_t = np.sqrt(2.0 * np.log(2.0)) / (np.pi * bw)

    fan = shoot_rays(
        source_depth, source_range, launch_angles, receiver_range,
        num_save, environment, rtol=rtol, flatearth=flatearth, **kw,
    )
    erays = find_eigenrays(
        fan, zd, source_depth, source_range, receiver_range, num_save,
        environment, ztol=ztol, rtol=rtol, flatearth=flatearth, **kw,
    )
    th_per_depth = [np.asarray(erays.launch_angles[d], float)
                    for d in range(zd.size)]
    th_all = np.concatenate(th_per_depth) if any(
        t.size for t in th_per_depth) else np.zeros(0)
    if th_all.size == 0:
        raise ValueError(
            "array_response: no eigenrays at any depth — widen the fan "
            f"(max_angle={max_angle}) or loosen ztol ({ztol})"
        )
    arr_all = arrival_amplitudes(
        source_depth, source_range, th_all, receiver_range, environment,
        num_save=max(int(num_save), 256), rtol=rtol, flatearth=flatearth,
        **kw,
    )

    ok = np.asarray(arr_all.alive, bool) & np.isfinite(arr_all.amplitude)
    tk = np.asarray(arr_all.travel_time, float)[ok]
    pad = 4.0 * sigma_t
    t0 = tk.min() - pad
    nt = int(np.ceil((tk.max() + pad - t0) * fs)) + 1
    t = t0 + np.arange(nt) / fs

    responses, rows = [], []
    off = 0
    for d in range(zd.size):
        n = th_per_depth[d].size
        arr_d = arr_all[off:off + n]
        off += n
        alive_d = np.asarray(arr_d.alive, bool) & np.isfinite(arr_d.amplitude)
        if alive_d.any():
            resp = synthesize_response(arr_d, fc, bandwidth=bw, t=t,
                                       attenuation=attenuation,
                                       bottom_loss_db=bottom_loss_db)
        else:
            zero = np.zeros(t.shape, np.complex128)
            resp = Response(t=t, waveform=zero.real, analytic=zero,
                            arrivals=arr_d, center_frequency=fc,
                            bandwidth=bw)
        responses.append(resp)
        rows.append(resp.waveform)

    return ArrayResponse(
        receiver_depths=zd, t=t, waveform=np.stack(rows),
        responses=responses,
    )
