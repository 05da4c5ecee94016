#!/usr/bin/env python3
"""Hold the forward fan kernels of two checkouts to each other without a
card: their ``csrc/trace_fan.cu`` built for the host by g++.

    python3 tools/host_fan_rehearsal.py PARENT_ROOT [CHANGE_ROOT]

Each ROOT holds a ``pygenray_tpu_torch`` package (CHANGE_ROOT defaults to
this repository).  Both checkouts' fan kernel source is compiled with g++
(``-ffp-contract=off``, as nvcc's ``-fmad=false``) against the stand-in
``cuda_runtime.h`` of ``tools/host_tangent_rehearsal.py``: a block's threads
run as ``std::thread``s, one block at a time, ``__shared__`` is
``static``, dynamic shared memory one static array, ``__syncthreads`` a
pthread barrier, the inline PTX ``max.NaN``, ``min.NaN`` and
``rsqrt.approx.ftz`` their C expressions (1/sqrt the shim's ``1 / sqrtf``,
as ``rsqrtf``).  So the rehearsal is blind to whether those one-instruction
forms keep the bits of the C forms they replace: ``chip_smoke.py``'s
comparisons on the card are the witness for that.  The C entry point
``trace_fan_f32`` is called through ctypes on the CPU operands
``ops/stepper._inputs(..., stations=True)`` builds, as ``trace_kernel``
calls it on the card, with the save grids in the layout the checkout's
kernel writes (``stepper.fan_saves_in_rows``; (nseg+1, B) in every mode for
a checkout without it), read back as (B, nseg+1).

The cases: the range-independent spectral fans (B1a) on Munk fits with K =
16, 32 and 64 compiled fixed and 24 and 41 at run time, Horner and Clenshaw;
Kahan on and off, ``terminate_backwards`` on and off; a curved bottom (the
Chebyshev bottom angle); a seamount with death codes 1, 2 and 3; a range
exit; then one range-dependent spectral fan (B1c) and one range-dependent
segment fan (B1d, the rough field's fit); each with 2 and 50 saves.  Every
output (save grids, counters, death codes, first dead save) must be equal
bit for bit, a NaN equal to any NaN.  Prints one line a case; exits 1 on any
difference.

The host's libm rounds sin, cos and 1/sqrt apart from the card's, so the
numbers are the host build's: this checks that two versions of the kernel
code compute the same thing, not the card's values (``chip_smoke.py`` does
that).  About half a minute, most of it g++.
"""

from __future__ import annotations

import ctypes
import dataclasses
import pathlib
import sys
import tempfile

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from host_tangent_rehearsal import build  # noqa: E402


def main():
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    change = pathlib.Path(sys.argv[2] if len(sys.argv) == 3 else
                          pathlib.Path(__file__).resolve().parent.parent)
    sys.path.insert(0, str(change))
    import torch

    import pygenray_tpu_torch as pt
    from pygenray_tpu_torch.integrate import _plan
    from pygenray_tpu_torch.ops import stepper

    def entry(path):
        fn = ctypes.CDLL(str(path)).trace_fan_f32
        fn.argtypes, fn.restype = stepper._ARGTYPES["trace_fan_f32"], ctypes.c_int
        return fn

    def run(fn, rows_of, env, z0, p0, g, s):
        """the entry point's outputs, save grids as (B, nseg+1)"""
        inp = stepper._inputs(env, z0, p0, g, s, stations=True)
        B, nseg, c = inp.p0.shape[0], g[4], inp.consts
        rows_first = rows_of(c.seg, inp.rd)
        shape = (B, nseg + 1) if rows_first else (nseg + 1, B)
        fl = tuple(torch.full(shape, -7.0) for _ in range(3))
        it = tuple(torch.full((B,), -7, dtype=torch.int32) for _ in range(4))
        K, S = (inp.ccoef.shape[-2], inp.ccoef.shape[-1]) if c.seg else (inp.ccoef.shape[-1], 1)
        err = fn(inp.p0.data_ptr(), inp.z0.data_ptr(), *inp.station_pointers(),
                 *(o.data_ptr() for o in fl + it),
                 B, K, inp.bacoef.shape[0], nseg, g[3], int(c.use_pow), int(c.bangle_cheb),
                 int(c.term_back), int(c.kahan), c.seg, S, inp.ccoef.shape[0] if inp.rd else 1,
                 c.seg_zlo, c.seg_hinv, int(c.any_x_oob), int(inp.rd), g[0], g[2], c.zlo_m,
                 c.zhi_p, c.sc, c.off, c.sin_lim, c.s2b, c.c2b, c.b_sum, c.b_span, None)
        if err:
            raise RuntimeError(f"entry point returned {err}")
        return tuple(a if rows_first else a.t() for a in fl) + it

    def same(a, b):
        return all(bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all())
                   for x, y in zip(a, b))

    def rows_of(root):
        """``root``'s choice of save layout by mode (seg, rd): True for
        (B, nseg+1) rows"""
        src = (pathlib.Path(root) / "pygenray_tpu_torch" / "ops" / "stepper.py").read_text()
        if "def fan_saves_in_rows" in src:
            return stepper.fan_saves_in_rows
        return lambda seg, rd: False

    def munk(nz=2048, r_max=100e3, nr=8, bathy=None, **kw):
        z, r = np.linspace(0.0, 6000.0, nz), np.linspace(0.0, r_max, nr)
        b = np.full(nr, 5000.0) if bathy is None else bathy(r)
        return pt.make_env_data(np.outer(np.ones(nr), pt.munk_ssp(z)), r, z, b, r,
                                dtype=torch.float32, device="cpu", **kw)

    def rough():
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "rough_field", change / "tests" / "fixtures" / "rough_field.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        c, r, z = mod.rough_tables(pt.munk_ssp, 1)
        return pt.make_env_data(c[0], r, z, np.full(len(r), 5000.0), r, dtype=torch.float32,
                                device="cpu", interp="seg", seg_basis="cheb", seg_order=31,
                                seg_exact_order=True)

    clen = lambda e: dataclasses.replace(e, poly_ok=False)
    # Horner on a fit the ladder leaves to Clenshaw: the Chebyshev rows read
    # as monomial ones (an invented profile, every ray on the bottom), for
    # the Horner code
    horner = lambda e: e if e.poly_ok else dataclasses.replace(
        e, poly_ok=True, c_pow=e.c_cheb, dcdz_pow=e.dcdz_cheb)
    s = pt.SolverSettings(dx=200.0)
    s_off = dataclasses.replace(s, kahan=False, terminate_backwards=False)
    head = munk()
    fits = {o: munk(nz=512, cheb_order=o, cheb_exact_order=True) for o in (31, 63, 23, 40)}
    z_rd, r_rd = np.linspace(0.0, 6000.0, 2048), np.linspace(0.0, 100e3, 16)
    env_rd = pt.make_env_data(np.array([pt.munk_ssp(z_rd, sofar_depth=1300 + 0.002 * ri)
                                        for ri in r_rd]), r_rd, z_rd,
                              np.linspace(4400.0, 4900.0, 16), r_rd, dtype=torch.float32,
                              device="cpu")
    rs = np.linspace(0.0, 20e3, 32)
    zs = np.linspace(0.0, 6000.0, 2048)
    seamount = pt.make_env_data(np.outer(np.ones(32), pt.munk_ssp(zs)), rs, zs,
                                3200.0 + 1600.0 * np.cos(2 * np.pi * rs / 20e3), rs,
                                dtype=torch.float32, device="cpu")
    # (label, env, settings, range, seamount fan)
    cases = [("headline", head, s, 100e3, False),
             ("headline_clenshaw", clen(head), s, 100e3, False),
             ("headline_kahan_off_no_term_back", head, s_off, 100e3, False),
             ("clenshaw_kahan_off", clen(head), s_off, 100e3, False)]
    for o, e in fits.items():
        cases += [(f"K{o + 1}_horner", horner(e), s, 100e3, False),
                  (f"K{o + 1}_clenshaw", clen(e), s, 100e3, False)]
    curved = munk(nr=32, bathy=lambda r: 4400.0 + 300.0 * np.sin(r / 30e3))
    cases += [("curved_bottom", curved, s, 100e3, False),
              ("range_exit", munk(r_max=90e3), s, 100e3, False),
              ("seamount_deaths", seamount, s, 20e3, True),
              ("seamount_kahan_off_no_term_back", seamount, s_off, 20e3, True),
              ("range_dependent_b1c", env_rd, pt.SolverSettings(dx=100.0), 100e3, False),
              ("segment_rough_b1d", rough(), pt.SolverSettings(dx=100.0), 20e3, False)]
    n = 150
    parent = pathlib.Path(sys.argv[1])
    layout = {"parent": rows_of(parent), "change": rows_of(change)}
    with tempfile.TemporaryDirectory() as tmp:
        fns = {side: entry(build(root, pathlib.Path(tmp) / side, ("trace_fan",))["trace_fan"])
               for side, root in (("parent", parent), ("change", change))}
        bad = 0
        for label, env, st, x1, deaths in cases:
            ang = (np.r_[np.linspace(-60.0, 60.0, n - 4), -90.0, -89.999, 89.999, 0.0]
                   if deaths else np.linspace(-18.0, 18.0, n))
            z0 = np.full(n, 1300.0)
            z0[-1] = 6500.0 if deaths else 1300.0
            c0 = float(np.interp(1300.0, env.z.numpy(), env.c[0].numpy()))
            p0 = torch.as_tensor(np.sin(np.radians(-ang)) / c0, dtype=torch.float32)
            z0 = torch.as_tensor(z0, dtype=torch.float32)
            for nsave in (2, 50):
                g = (0.0, x1, *_plan(0.0, x1, nsave, st.dx))
                outs = [run(fns[side], layout[side], env, z0, p0, g, st)
                        for side in ("change", "parent")]
                ok = same(*outs)
                bad += not ok
                K = env.c_seg.shape[-2] if env.has_seg else env.c_cheb.shape[-1]
                print(f"{label}: K={int(K)} horner={bool(env.poly_ok)} "
                      f"rd={bool(env.range_dependent)} seg={bool(env.has_seg)} saves={nsave} "
                      f"bounces={int((outs[0][3] + outs[0][4]).sum())} "
                      f"death_codes={sorted(set(outs[0][5].tolist()))} equal={ok}", flush=True)
    print(f"{bad} cases differ", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
