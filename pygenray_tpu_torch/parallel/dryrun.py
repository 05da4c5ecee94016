"""A dry run of the multi-device pipeline on a small problem.

Counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``, which
checks its sharding on a mesh of virtual CPU devices.  Here the mesh names
torch devices, repeated where fewer distinct devices exist than asked for::

    python -c "from pygenray_tpu_torch.parallel import dryrun_multichip; print(dryrun_multichip(4))"
    python -c "from pygenray_tpu_torch.parallel import dryrun_multichip; \\
               print(dryrun_multichip(8, device='cpu'))"

The JAX dry run also traces a fan through its dynamic calm windows
(``classify_dyn_sharded``); that classifier is TPU block scheduling and is
not ported, so this dry run has no such block.
"""

from __future__ import annotations

import numpy as np

__all__ = ["dryrun_multichip"]


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the sharded pipeline once over an ``n_devices`` mesh of
    ``device``'s type and check it against the unsharded one:

    * a 4 n-ray Munk fan, sharded over the launch angles, through the fan
      kernel (its plain version on a CPU mesh);
    * one batched regula-falsi step on the sharded fan's final depths and a
      re-shoot of the updated angles (padded to the mesh, sharded);
    * an n-realization internal-wave ensemble (segment fits, the rough-field
      production path), sharded over the realizations.

    The fan and the ensemble must equal their unsharded runs: bit for bit on
    a card (a ray is one thread) and on the ensemble (each realization runs
    the same call either way); on a CPU fan the counters and death codes
    exactly and the times within 1e-6 s (torch's vectorized CPU loops may
    round a batch's tail apart).  Returns what was checked; raises
    ``AssertionError`` on a difference."""
    import torch

    from ..envdata import make_env_data
    from ..environment import munk_ssp
    from ..integrate import SolverSettings, trace
    from ..models.internal_waves import perturbed_munk_tables
    from ..montecarlo import make_env_ensemble, trace_ensemble
    from ..ops import stepper
    from .sharding import make_mesh, pad_to_multiple, shard_rays

    kind = torch.device(device).type
    avail = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
             if kind == "cuda" else [torch.device(device)])
    if not avail:
        raise RuntimeError("dryrun_multichip: no CUDA device; pass device='cpu'")
    mesh = make_mesh(devices=[avail[i % len(avail)] for i in range(n_devices)])
    dev0 = mesh.device_list[0]
    on_card = kind == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    settings = SolverSettings(dx=2000.0, backend="kernel")

    def same(a, b, fan):
        """Sharded ``a`` against unsharded ``b``: the largest time difference."""
        for f in ("n_bott", "n_surf", "death_code", "alive_save"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f"sharded {f} differs"
        dt = float((a.ts - b.ts).abs().max())
        if on_card or not fan:
            assert torch.equal(a.ts, b.ts) and torch.equal(a.zs, b.zs), "sharded trace differs"
        else:
            assert dt <= 1e-6, f"sharded travel times differ by {dt} s"
        return dt

    # the fan, sharded over the launch angles
    z = np.linspace(0.0, 6000.0, 128)
    r = np.linspace(0.0, 100e3, 4)
    env = make_env_data(np.outer(np.ones(4), munk_ssp(z)), r, z, np.full(4, 5000.0), r,
                        dtype=torch.float32, device=dev0)
    B = 4 * n_devices
    angles = np.linspace(-15.0, 15.0, B)
    p0 = torch.as_tensor(np.sin(np.radians(-angles)) / 1500.0, dtype=torch.float32, device=dev0)
    res_1 = trace(env, 1300.0, p0, 0.0, 100e3, 10, settings)
    sync()
    n0 = stepper.LAUNCHES
    res = trace(env, 1300.0, shard_rays(p0, mesh), 0.0, 100e3, 10, settings)
    sync()
    fan_launches = stepper.LAUNCHES - n0
    assert res.ts.shape == (B, 10) and res.ts.device == dev0
    fan_dt = same(res, res_1, True)

    # one batched regula-falsi step from the sharded final depths, then a
    # re-shoot of the updated angles
    z_end = -res.zs[:, -1].double()
    th = torch.as_tensor(angles, device=dev0)
    th1, th2, z1, z2 = th[:-1], th[1:], z_end[:-1], z_end[1:]
    theta_new = th1 - (z1 + 1300.0) * (th2 - th1) / torch.where(z2 != z1, z2 - z1, 1.0)
    p_new, _ = pad_to_multiple(torch.sin(torch.deg2rad(-theta_new)) / 1500.0, n_devices)
    res2 = trace(env, 1300.0, shard_rays(p_new, mesh), 0.0, 100e3, 2, settings)
    sync()
    assert res2.zs.shape == (B, 2) and bool(torch.isfinite(res2.zs[res2.alive]).all())

    # an ensemble sharded over its realizations (segment fits)
    E = n_devices
    c_ens, r_t, z_t = perturbed_munk_tables(E, r_max=30e3, nr=8, nz=128, seed=3)
    env_ens = make_env_ensemble(c_ens, r_t, z_t, np.full(8, 5000.0), r_t, interp="seg",
                                dtype=torch.float32, device=dev0)
    assert env_ens.has_seg
    p_ens = np.sin(np.radians(-np.linspace(-8.0, 8.0, 8))) / 1500.0
    r_un = trace_ensemble(env_ens, 1300.0, p_ens, 0.0, 30e3, 4, settings)
    sync()
    n0 = stepper.SEG_LAUNCHES
    r_sh = trace_ensemble(env_ens, 1300.0, p_ens, 0.0, 30e3, 4, settings, mesh=mesh)
    sync()
    ens_launches = stepper.SEG_LAUNCHES - n0
    same(r_sh, r_un, False)
    return {"mesh": [str(d) for d in mesh.device_list], "fan_rays": B,
            "fan_launches": fan_launches, "fan_max_time_diff_s": fan_dt,
            "reshoot_alive": int(res2.alive.sum()), "realizations": E,
            "ensemble_segment_launches": ens_launches}
