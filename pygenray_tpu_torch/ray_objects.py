# Copied from pygenray_tpu/ray_objects.py (host-only numpy); tests pin it equal to the original.
"""Result containers: Ray, RayFan, EigenRays.

API-parity with the reference (`pygenray/ray_objects.py`),
numpy-backed.  Sign conventions: the integrator works in the ODE convention
(z positive down); these objects store the user convention z = -y[1],
p = -y[2] (reference `ray_objects.py:51-52`, `docs/ray_physics.md:3-7`).

``RayFan.from_arrays`` is the TPU-native constructor: it ingests whole
batched device arrays without materializing per-ray Python objects, which
matters at 10^5+ rays.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Ray", "RayFan", "EigenRays"]

# muted grey used for guide lines and connective overlays
_GUIDE_GREY = "0.65"

# matplotlib spells several line/scatter properties two ways; passing both the
# alias and the long name raises, so default-merging has to canonicalize
_MPL_ALIASES = {"color": "c", "linewidth": "lw", "linestyle": "ls"}


def _target_axes(ax=None):
    """Axes to draw on: the caller's, else matplotlib's current axes."""
    from matplotlib import pyplot as plt

    return plt.gca() if ax is None else ax


def _styled(user_kwargs, **defaults):
    """Overlay user kwargs on defaults, collapsing matplotlib aliases so a
    user ``color=`` cleanly overrides a default ``c=`` (and so on)."""
    merged = dict(defaults)
    for key, value in user_kwargs.items():
        merged.pop(_MPL_ALIASES.get(key, key), None)
        merged[key] = value
    return merged


def _categorical_scatter(ax, x, y, labels, **common):
    """Scatter (x, y) colored by the distinct values of ``labels``, one
    legend entry per value. Used for ray-ID colored time fronts."""
    from matplotlib import pyplot as plt

    labels = np.asarray(labels)
    distinct = np.unique(labels)
    palette = plt.get_cmap("tab20")(np.linspace(0.0, 1.0, len(distinct)))
    for shade, value in zip(palette, distinct):
        sel = labels == value
        ax.scatter(np.asarray(x)[sel], np.asarray(y)[sel], color=shade,
                   label=str(value), **common)
    ax.legend(ncols=3, loc="lower left")


class Ray:
    """A single ray trajectory with bounce counts and metadata."""

    def __init__(self, r, y, n_bottom, n_surface, launch_angle=None, source_depth=None):
        """``y`` is (3, N) = [travel time, depth, ray parameter] in the
        positive-z-down ODE convention; stored attributes flip to the user
        convention (z negative down)."""
        y = np.asarray(y)
        self.r = np.asarray(r)
        self.t = y[0, :]
        self.z = -y[1, :]
        self.p = -y[2, :]
        self.n_bottom = n_bottom
        self.n_surface = n_surface
        if launch_angle is not None:
            self.launch_angle = launch_angle
        if source_depth is not None:
            self.source_depth = source_depth

    def plot(self, ax=None, **kwargs):
        """Draw the trajectory in range-depth space; returns the axes.

        Output parity with the reference's ``Ray.plot`` minus two of its
        defects (style defaults that were built but never applied, and a
        "time [s]" label on what is a range axis).
        """
        ax = _target_axes(ax)
        ax.plot(self.r, self.z, **_styled(kwargs, c="k", lw=1.0, alpha=0.5))
        ax.set_xlabel("range [m]")
        ax.set_ylabel("depth [m]")
        ax.set_ylim(self.z.min(), self.z.max())
        return ax


class RayFan:
    """A fan of rays stacked into (M, N) arrays along the launch-angle axis."""

    def __init__(self, Rays: list = None):
        if Rays is None:
            return  # internal: populated by from_arrays
        thetas, rs, ts, zs, ps, n_botts, n_surfs, source_depths = (
            [] for _ in range(8)
        )
        for ray in Rays:
            thetas.append(ray.launch_angle)
            rs.append(ray.r)
            ts.append(ray.t)
            zs.append(ray.z)
            ps.append(ray.p)
            n_botts.append(ray.n_bottom)
            n_surfs.append(ray.n_surface)
            source_depths.append(getattr(ray, "source_depth", np.nan))
        self.thetas = np.array(thetas)
        self.rs = np.array(rs)
        self.ts = np.array(ts)
        self.zs = np.array(zs)
        self.ps = np.array(ps)
        self.n_botts = np.array(n_botts)
        self.n_surfs = np.array(n_surfs)
        self.source_depths = np.array(source_depths)
        self.alive = np.array(
            [bool(getattr(ray, "alive", True)) for ray in Rays]
        )
        self.death_code = np.array(
            [int(getattr(ray, "death_code", 0)) for ray in Rays]
        )
        self.compute_rayids()

    @classmethod
    def from_arrays(cls, thetas, rs, ts, zs, ps, n_botts, n_surfs, source_depths,
                    alive=None, death_code=None):
        """Build directly from batched arrays (user sign convention).

        ``alive``/``death_code`` are the per-ray termination diagnostics a
        ``keep_dropped`` fan carries (``integrate.DEATH_CODES``); they
        default to all-alive and survive every container operation
        (``__getitem__``, ``__add__``, npz round-trip)."""
        self = cls()
        self.thetas = np.asarray(thetas)
        self.rs = np.asarray(rs)
        self.ts = np.asarray(ts)
        self.zs = np.asarray(zs)
        self.ps = np.asarray(ps)
        self.n_botts = np.asarray(n_botts)
        self.n_surfs = np.asarray(n_surfs)
        self.source_depths = np.asarray(source_depths)
        M = self.thetas.shape[0]
        self.alive = (np.ones(M, bool) if alive is None
                      else np.asarray(alive, bool))
        self.death_code = (np.zeros(M, int) if death_code is None
                           else np.asarray(death_code, int))
        self.compute_rayids()
        return self

    def compute_rayids(self):
        """Signed turning-point count per ray, "b"-suffixed on boundary hits
        (reference `ray_objects.py:138-155`).  NaN save points (past a
        dropped ray's death, reference `launch_rays.py:745-784`) carry no
        sign information and are excluded from the count."""
        sign = np.sign(self.ps)
        finite = np.isfinite(self.ps[:, 1:]) & np.isfinite(self.ps[:, :-1])
        ray_ids = np.sum((np.diff(sign) != 0) & finite, axis=1) * np.sign(self.thetas)
        b_mask = (self.n_botts == 0) & (self.n_surfs == 0)
        ray_ids_str = [
            str(ray_ids[i]) if b_mask[i] else f"{ray_ids[i]}b"
            for i in range(self.rs.shape[0])
        ]
        self.ray_ids = np.array(ray_ids_str)

    # -- plotting -------------------------------------------------------
    def plot_time_front(
        self, include_lines=False, range_idx=-1, add_colorbar=True,
        ray_id=False, ax=None, **kwargs,
    ):
        """Arrival pattern at one save range: depth vs travel time, colored
        by launch angle (default) or by ray ID when ``ray_id=True``.

        ``include_lines`` threads a faint line through the arrivals in fan
        order; extra keywords style the scatter. Returns the axes.
        """
        ax = _target_axes(ax)
        t_arr = self.ts[:, range_idx]
        z_arr = self.zs[:, range_idx]
        if include_lines:
            ax.plot(t_arr, z_arr, c=_GUIDE_GREY, lw=0.5, zorder=5)
        common = _styled(kwargs, s=2, lw=0, zorder=6)
        if ray_id:
            _categorical_scatter(ax, t_arr, z_arr, self.ray_ids, **common)
        else:
            points = ax.scatter(
                t_arr, z_arr, **_styled(common, c=self.thetas, cmap="viridis")
            )
            if add_colorbar:
                ax.figure.colorbar(points, ax=ax, label="launch angle [degrees]")
        ax.set_ylim(self.zs.min(), self.zs.max())
        ax.set_xlabel("time [s]")
        ax.set_ylabel("depth [m]")
        ax.set_title("Time Front")
        return ax

    def plot_ray_fan(self, ax=None, **kwargs):
        """All trajectories in range-depth space, faded so a dense fan reads
        as a density. Returns the axes."""
        ax = _target_axes(ax)
        fade = min(1.0, 10.0 / max(len(self), 1))
        ax.plot(self.rs.T, self.zs.T, **_styled(kwargs, c="k", lw=1.0, alpha=fade))
        ax.set_xlabel("range [m]")
        ax.set_ylabel("depth [m]")
        ax.set_ylim(self.zs.min(), self.zs.max())
        ax.set_title("Ray Fan")
        return ax

    def plot_depth_v_angle(self, include_line=False, ax=None, **kwargs):
        """Final depth of each ray against its launch angle. Returns the axes.

        (The reference's version dropped its own style defaults and left the
        axes unlabeled; both fixed here.)
        """
        ax = _target_axes(ax)
        z_end = self.zs[:, -1]
        if include_line:
            ax.plot(self.thetas, z_end, c=_GUIDE_GREY, lw=0.5, zorder=5)
        ax.scatter(self.thetas, z_end, **_styled(kwargs, s=2, lw=0, zorder=6))
        ax.set_xlabel("launch angle [degrees]")
        ax.set_ylabel("final depth [m]")
        return ax

    # -- persistence ----------------------------------------------------
    def save_mat(self, filename):
        from scipy import io

        data = {
            "rayfan": {
                "thetas": self.thetas,
                "xs": self.rs,
                "ts": self.ts,
                "zs": self.zs,
                "ps": self.ps,
                "n_botts": self.n_botts,
                "n_surfs": self.n_surfs,
                "source_depths": self.source_depths,
                "alive": self.alive,
                "death_code": self.death_code,
            }
        }
        io.savemat(filename, data)

    def save_npz(self, filename):
        """Numpy-native export (round-trips with ``RayFan.load_npz``)."""
        np.savez(
            filename,
            thetas=self.thetas, rs=self.rs, ts=self.ts, zs=self.zs, ps=self.ps,
            n_botts=self.n_botts, n_surfs=self.n_surfs,
            source_depths=self.source_depths,
            alive=self.alive, death_code=self.death_code,
        )

    @classmethod
    def load_npz(cls, filename):
        d = np.load(filename)
        return cls.from_arrays(
            d["thetas"], d["rs"], d["ts"], d["zs"], d["ps"],
            d["n_botts"], d["n_surfs"], d["source_depths"],
            # archives written before diagnostics were carried lack these
            alive=d["alive"] if "alive" in d else None,
            death_code=d["death_code"] if "death_code" in d else None,
        )

    # -- container protocol ---------------------------------------------
    def __add__(self, other):
        if not isinstance(other, RayFan):
            raise TypeError("Can only add RayFan objects together")
        # an empty fan (every ray dropped) is the identity: chunked fans
        # must still accumulate
        if len(self) == 0:
            return other
        if len(other) == 0:
            return self
        if not np.array_equal(self.rs[0], other.rs[0]):
            raise ValueError("Range arrays (rs) must be equivalent for concatenation")
        return RayFan.from_arrays(
            np.concatenate([self.thetas, other.thetas]),
            np.concatenate([self.rs, other.rs]),
            np.concatenate([self.ts, other.ts]),
            np.concatenate([self.zs, other.zs]),
            np.concatenate([self.ps, other.ps]),
            np.concatenate([self.n_botts, other.n_botts]),
            np.concatenate([self.n_surfs, other.n_surfs]),
            np.concatenate([self.source_depths, other.source_depths]),
            alive=np.concatenate([self.alive, other.alive]),
            death_code=np.concatenate([self.death_code, other.death_code]),
        )

    def __len__(self):
        return len(self.thetas)

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            key = int(key)
            if key < 0:
                key = len(self.thetas) + key
            if key < 0 or key >= len(self.thetas):
                raise IndexError(
                    f"Index {key} is out of bounds for RayFan with "
                    f"{len(self.thetas)} rays"
                )
            ray = Ray(
                r=self.rs[key],
                y=np.array([self.ts[key], -self.zs[key], -self.ps[key]]),
                n_bottom=self.n_botts[key],
                n_surface=self.n_surfs[key],
                launch_angle=self.thetas[key],
                source_depth=self.source_depths[key],
            )
            ray.alive = bool(self.alive[key])
            ray.death_code = int(self.death_code[key])
            return ray
        if isinstance(key, slice):
            idx = np.arange(len(self.thetas))[key]
        else:
            idx = np.asarray(key)
            if idx.dtype == bool:
                idx = np.where(idx)[0]
            if np.isscalar(idx) or idx.ndim == 0:
                idx = np.array([int(idx)])
            elif idx.ndim != 1:
                raise ValueError("Invalid indexing array shape")
        return RayFan.from_arrays(
            self.thetas[idx], self.rs[idx], self.ts[idx], self.zs[idx],
            self.ps[idx], self.n_botts[idx], self.n_surfs[idx],
            self.source_depths[idx],
            alive=self.alive[idx], death_code=self.death_code[idx],
        )


class EigenRays:
    """Eigenrays grouped per receiver depth (reference `ray_objects.py:433-548`).

    ``received_angles`` are computed at the ray endpoint against the
    *untransformed* environment, matching the reference.
    """

    def __init__(
        self,
        receiver_depths,
        eigenray_dict,
        environment,
        num_eigenrays,
        num_eigenrays_found,
        failed_eray_theta_brackets,
    ):
        self.receiver_depths = receiver_depths
        self.rs = {}
        self.ts = {}
        self.zs = {}
        self.ps = {}
        self.received_angles = {}
        self.launch_angles = {}
        self.n_botts = {}
        self.n_surfs = {}
        self.ray_id = {}
        self.ray_id_int = {}
        self.num_eigenrays = num_eigenrays
        self.num_eigenrays_found = num_eigenrays_found
        self.failed_eray_theta_brackets = failed_eray_theta_brackets

        if hasattr(environment, "unpack"):
            cin, _, rin, zin, *_ = environment.unpack(flatearth=False)
        else:  # bare EnvData pytree: one cached device->host pull
            from .envdata import host_profile_tables

            rin, zin, cin = host_profile_tables(environment)

        from .ops.host import bilinear_np

        for ridx in range(len(receiver_depths)):
            rays = eigenray_dict[ridx]
            if len(rays) == 0:
                for d in (self.rs, self.ts, self.zs, self.ps):
                    d[ridx] = np.zeros((0, 0))
                self.n_botts[ridx] = np.zeros(0, int)
                self.n_surfs[ridx] = np.zeros(0, int)
                self.received_angles[ridx] = np.zeros(0)
                self.launch_angles[ridx] = np.zeros(0)
                self.ray_id[ridx] = np.array([], dtype=str)
                self.ray_id_int[ridx] = np.array([], dtype=int)
                continue
            fan = RayFan(rays)
            self.rs[ridx] = fan.rs
            self.ts[ridx] = fan.ts
            self.zs[ridx] = fan.zs
            self.ps[ridx] = fan.ps
            self.n_botts[ridx] = fan.n_botts
            self.n_surfs[ridx] = fan.n_surfs

            received, rids, rids_int = [], [], []
            for k in range(fan.rs.shape[0]):
                # stored zs use the negative-down user convention; the
                # sound-speed grid is positive-down, so interpolate at -z.
                # (The reference feeds the signed value into ray_angle,
                # `pygenray/ray_objects.py:521-535`,
                # which clamp-extrapolates ABOVE the surface and skews the
                # received angle for any depth-varying profile — fixed
                # here, like the failed-bracket index bug.)
                # Known inconsistency, kept for reference parity: this
                # interpolates the RAW table while the engine integrated
                # the spectral/segment FIT — the same table-vs-fit gap the
                # calm classifier refuses to mix (pallas_stepper.py
                # `_fit_eval_np`).  For a *reported angle* the sub-m/s
                # difference is ~millidegrees, far below bracketing
                # resolution, so the table is fine here.
                c = bilinear_np(fan.rs[k, -1], -fan.zs[k, -1], rin, zin, cin)
                theta = np.degrees(np.arcsin(np.clip(fan.ps[k, -1] * c, -1, 1)))
                received.append(theta)
                rid = np.sum(np.diff(np.sign(fan.ps[k, :])) != 0) * np.sign(
                    fan.thetas[k]
                )
                flag = "" if (fan.n_botts[k] == 0 and fan.n_surfs[k] == 0) else "b"
                rids.append(f"{rid}{flag}")
                rids_int.append(int(rid))
            self.received_angles[ridx] = np.array(received)
            self.launch_angles[ridx] = fan.thetas
            self.ray_id[ridx] = np.array(rids)
            self.ray_id_int[ridx] = np.array(rids_int)

    # -- plotting -------------------------------------------------------
    def _depth_indices(self, ridxs):
        if ridxs is None:
            return sorted(self.rs.keys())
        if isinstance(ridxs, (int, np.integer)):
            return [int(ridxs)]
        return list(ridxs)

    def plot_angle_time(self, ridxs=None, ax=None, **kwargs):
        """Received angle vs arrival time for the selected receiver depths
        (all depths by default). Returns the axes."""
        ax = _target_axes(ax)
        for ridx in self._depth_indices(ridxs):
            if self.ts[ridx].size == 0:  # depth with zero eigenrays
                continue
            ax.scatter(self.ts[ridx][:, -1], self.received_angles[ridx], **kwargs)
        ax.set_xlabel("time [s]")
        ax.set_ylabel("received angle [deg]")
        ax.set_title("Received Angle vs Time")
        return ax

    def plot(self, ridxs=0, ax=None, **kwargs):
        """Eigenray trajectories for the selected receiver depths (the first
        depth by default). Returns the axes."""
        ax = _target_axes(ax)
        indices = self._depth_indices(ridxs)
        style = _styled(kwargs, c="k")
        for ridx in indices:
            ax.plot(self.rs[ridx].T, self.zs[ridx].T, **style)
        ax.set_xlabel("range [m]")
        ax.set_ylabel("depth [m]")
        ax.set_title("Eigen Rays")
        zs_shown = [self.zs[i] for i in indices if self.zs[i].size]
        if zs_shown:
            ax.set_ylim(min(z.min() for z in zs_shown),
                        max(z.max() for z in zs_shown))
        return ax

    def plot_ducted(self, ax=None, **kwargs):
        """Trajectories of eigenrays that never touch a boundary, across all
        receiver depths. Returns the axes.

        Depths are drawn in the same (user, negative-down) convention as
        ``plot`` — the reference flipped the sign here, inconsistently with
        its other trajectory plots.
        """
        ax = _target_axes(ax)
        style = _styled(kwargs, c="k")
        for ridx in self._depth_indices(None):
            ducted = (self.n_botts[ridx] == 0) & (self.n_surfs[ridx] == 0)
            if np.any(ducted):
                ax.plot(self.rs[ridx][ducted].T, self.zs[ridx][ducted].T, **style)
        ax.set_xlabel("range [m]")
        ax.set_ylabel("depth [m]")
        ax.set_title("Ducted Eigen Rays")
        return ax

    def save_npz(self, filename):
        """Numpy-native export (round-trips with ``EigenRays.load_npz``).

        Per-depth arrays live under ``d{idx}_*`` keys; the per-depth
        bracket/found counts and failed brackets ride along, plus the
        solver ``diagnostics`` dict when the instance carries one.
        """
        rd = np.asarray(self.receiver_depths, float)
        payload = {
            "receiver_depths": rd,
            "num_eigenrays": np.asarray(
                [self.num_eigenrays[d] for d in rd], int
            ),
            "num_eigenrays_found": np.asarray(
                [self.num_eigenrays_found[i] for i in range(rd.size)], int
            ),
        }
        fields = {
            "rs": self.rs, "ts": self.ts, "zs": self.zs, "ps": self.ps,
            "received_angles": self.received_angles,
            "launch_angles": self.launch_angles,
            "n_botts": self.n_botts, "n_surfs": self.n_surfs,
            "ray_id": self.ray_id, "ray_id_int": self.ray_id_int,
        }
        for i in range(rd.size):
            for name, d in fields.items():
                payload[f"d{i:04d}_{name}"] = np.asarray(d[i])
            payload[f"d{i:04d}_failed"] = np.asarray(
                self.failed_eray_theta_brackets[i], float
            ).reshape(-1, 2)
        for k, v in getattr(self, "diagnostics", {}).items():
            payload[f"diag_{k}"] = np.asarray(v)
        np.savez(filename, **payload)

    @classmethod
    def load_npz(cls, filename):
        d = np.load(filename)
        obj = cls.__new__(cls)
        rd = d["receiver_depths"]
        obj.receiver_depths = rd
        obj.num_eigenrays = {
            k: int(n) for k, n in zip(rd, d["num_eigenrays"])
        }
        obj.num_eigenrays_found = {
            i: int(n) for i, n in enumerate(d["num_eigenrays_found"])
        }
        for name in ("rs", "ts", "zs", "ps", "received_angles",
                     "launch_angles", "n_botts", "n_surfs", "ray_id",
                     "ray_id_int"):
            setattr(obj, name, {
                i: d[f"d{i:04d}_{name}"] for i in range(rd.size)
            })
        obj.failed_eray_theta_brackets = {
            i: [tuple(row) for row in d[f"d{i:04d}_failed"]]
            for i in range(rd.size)
        }
        diag_keys = [k for k in d.files if k.startswith("diag_")]
        if diag_keys:
            obj.diagnostics = {k[5:]: d[k] for k in diag_keys}
        return obj

    def save_mat(self, filename):
        from scipy import io

        data = {}
        for ridx, rdepth in enumerate(self.receiver_depths):
            data[f"receiver_depth_{ridx}"] = {
                "receiver_depth": rdepth,
                "xs": self.rs[ridx],
                "ts": self.ts[ridx],
                "zs": self.zs[ridx],
                "ps": self.ps[ridx],
                "received_angles": self.received_angles[ridx],
                "launch_angles": self.launch_angles[ridx],
                "ray_id": self.ray_id[ridx],
                "ray_id_int": self.ray_id_int[ridx],
                "n_bottom": self.n_botts[ridx],
                "n_surface": self.n_surfs[ridx],
                "source_depth": getattr(self, "source_depths", {}).get(ridx, np.nan)
                if hasattr(self, "source_depths")
                else np.nan,
                "num_eigenrays": self.num_eigenrays,
                "num_eigenrays_found": self.num_eigenrays_found,
            }
        io.savemat(filename, {"eigenrays": data})
