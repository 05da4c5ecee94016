"""Received-waveform demo on the PyTorch/CUDA port: the band-limited
channel impulse response.

The full receiver pipeline in one call: fan -> eigenrays -> complex
arrival factors -> superposed wave packets.  Plots the received waveform
and envelope at a SOFAR-channel receiver; each envelope peak is one
eigenray, inverted when it carries an odd surface-bounce count and
Hilbert-rotated per caustic touch.  Then a vertical-array record section
and an LFM chirp through the same channel, pulse-compressed back to the
arrival pattern.

    python examples/torch_port/impulse_response_demo.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent.parent))

import numpy as np

import pygenray_tpu_torch as pr
from pygenray_tpu_torch.models import munk_env

OUT = pathlib.Path(__file__).resolve().parent


def run(smoke=False, device="cuda"):
    """The demo's computation and its asserts.  ``smoke=True`` shrinks every
    size for the test suite; ``device`` is where the tensors live (the CUDA
    card unless the caller asks for ``"cpu"``)."""
    r_max = 30e3 if smoke else 100e3
    env = munk_env(r_max=r_max, nr=12 if smoke else 50, nz=500 if smoke else 1200)
    z_src, z_rcv = 1300.0, (1200.0 if smoke else 1000.0)
    fc = 75.0  # Hz, typical tomography band

    resp = pr.impulse_response(
        z_src, 0.0, z_rcv, r_max, env, center_frequency=fc,
        bandwidth=fc / 2,
        num_rays=256 if smoke else 2048, max_angle=14.0,
        num_save=100 if smoke else 400, flatearth=False, device=device,
    )
    ok = resp.arrivals.alive
    print(f"{ok.sum()} arrivals; window {resp.t[0]:.3f}..{resp.t[-1]:.3f} s")
    peak = resp.envelope().max()
    print(f"peak envelope {peak:.3e} (re 1 m) = {-20*np.log10(peak):.1f} dB TL")
    assert np.isfinite(resp.waveform).all()
    assert peak > 0

    # vertical-array record section: one fan, one multi-depth solve, one
    # amplitude launch — the timefront with waveforms on it
    zd = np.linspace(1100.0, 1500.0, 4 if smoke else 16)
    ar = pr.array_response(
        z_src, 0.0, zd, r_max, env, center_frequency=fc, bandwidth=fc / 2,
        num_rays=256 if smoke else 2048, max_angle=14.0,
        num_save=100 if smoke else 400, flatearth=False, device=device,
    )
    rows = int((np.abs(ar.waveform) > 0).any(axis=1).sum())
    print(f"record section: {rows}/{zd.size} depths received arrivals")
    assert rows > 0

    # coded transmission: an LFM chirp through the same channel, then
    # matched-filter pulse compression back to the arrival pattern —
    # the actual tomography observable (with Thorp absorption)
    fs = 8.0 * fc
    dur = 0.5 if smoke else 2.0
    ts = np.arange(int(dur * fs)) / fs
    f0, f1 = 0.5 * fc, 1.5 * fc
    chirp = np.sin(2 * np.pi * (f0 * ts + 0.5 * (f1 - f0) / dur * ts**2))
    rw = pr.received_waveform(resp.arrivals, chirp, fs, attenuation="thorp")
    cc = rw.correlate(chirp, fs)
    tpk = cc.t[np.argmax(cc.envelope())]
    print(f"chirp reception: raw peak {np.abs(rw.waveform).max():.3e}, "
          f"compressed peak {cc.envelope().max():.3e} at {tpk:.4f} s")
    tk_true = resp.arrivals.travel_time[ok]
    assert np.abs(tk_true - tpk).min() < 5e-3
    return {"arrivals": int(ok.sum()), "peak_envelope": float(peak), "array_rows": rows,
            "compressed_peak_s": float(tpk), "r_max": r_max, "z_rcv": z_rcv, "fc": fc,
            "f0": f0, "f1": f1, "dur": dur, "response": resp, "array_response": ar,
            "received": rw, "compressed": cc}


def main(smoke=False, outdir=None, device="cuda"):
    """``run`` and the figures; ``outdir`` redirects them."""
    out = pathlib.Path(outdir) if outdir is not None else OUT
    res = run(smoke=smoke, device=device)
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    r_max, z_rcv, fc = res["r_max"], res["z_rcv"], res["fc"]
    fig, ax = plt.subplots(figsize=(9, 4))
    res["response"].plot(ax=ax)
    ax.set_title(
        f"Munk channel response, {r_max/1e3:.0f} km, z={z_rcv:.0f} m, "
        f"{fc:.0f} Hz ({res['arrivals']} arrivals)"
    )
    fig.savefig(out / "impulse_response.png", dpi=120, bbox_inches="tight")

    fig2, ax2 = plt.subplots(figsize=(9, 6))
    res["array_response"].plot(ax=ax2)
    ax2.set_title(f"Vertical-array record section, {r_max/1e3:.0f} km")
    fig2.savefig(out / "record_section.png", dpi=120, bbox_inches="tight")

    rw, cc = res["received"], res["compressed"]
    fig3, (ax3a, ax3b) = plt.subplots(2, 1, figsize=(9, 6), sharex=True)
    ax3a.plot(rw.t, rw.waveform, lw=0.5)
    ax3a.set_ylabel("received chirps")
    cc.plot(ax=ax3b)
    ax3b.set_ylabel("pulse-compressed")
    ax3a.set_title(f"LFM {res['f0']:.0f}-{res['f1']:.0f} Hz, {res['dur']:.1f} s, "
                   "matched filter")
    fig3.savefig(out / "pulse_compression.png", dpi=120, bbox_inches="tight")
    plt.close("all")
    return res


if __name__ == "__main__":
    main()
