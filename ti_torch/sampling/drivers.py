"""Sampling drivers: batched transport with dlogp and .npy artifacts, and
the SDE rollout (port of the ambient, latent and SDE paths of
ti_tpu/sampling/drivers.py).

``sample_ambient`` transports conformations from sampling_T0 to
sampling_T1 through the route its config names. The reference's own
(every MDQM9 preset's default) is adaptive dopri5 at atol = rtol = 1e-5
with the exact divergence integrated inside every stage. Under
``fast_profile`` it is ``make_ode_sampler``'s segmented Gauss-Legendre
path: RK trajectory segments gap by gap between the quadrature nodes, then
one divergence evaluation per node, and dlogp as the weighted sum. The
trajectory drift and the divergence-node estimator of that path are hooks
(``traj_drift``/``div_drift``) that ``cfg.traj_forward_impl`` and
``cfg.div_forward_impl`` fill with the CUDA pair kernels
(ops/pair_layer_kernel.py, ops/pair_tangent_kernel.py); with a hook left
None the node runs the dense forward (and its torch.func JVPs) — with
``molecular_v_fn_of(impl="dense_fused")`` the message MLPs of that forward
run as kernels B4 and B5 (ops/pallas_kernels.py), on every route.

``sample_latent`` generates conformations from COM-free noise through the
same routes (the Boltzmann generator); its samples, noise and dlogp feed
``sample_ambient``'s latent passthrough for the BG→TI composition.

``make_ode_sampler`` also takes the fixed-step solvers with stage-coupled
dlogp or velocity only, in one pass or in segments, adaptive dopri5, and
Simpson or unsegmented Gauss quadrature dlogp. ``sample_molecular_sde`` is
Euler–Maruyama over the dense drift or the pair-kernel drift (B1, or B2
with ``chain_block`` > 1).

``sample_adw`` transports the 1-D ADW test samples from beta0 to beta1
through ``make_ode_sampler`` on any of its routes, in f32 or f64.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
``div_axis`` shards the divergence's tangent lanes over a process group
(ti_torch.parallel.lane_parallel_sampler); chain sharding wraps a sampler
from outside (ti_torch.parallel.parallel_sampler).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ti_torch import resolve_device
from ti_torch.config import ADWConfig, MDQM9Config
from ti_torch.sampling.integrators import (
    ODESolution,
    _check_quad,
    _tableau,
    check_divergence,
    dopri5_stepper,
    n_short,
    node_divergences,
    sample_ode,
    sample_ode_dopri5,
    sample_ode_gauss_dlogp,
    sample_ode_quad_dlogp,
    sample_sde,
    short_of_save_time,
    simpson_dlogp,
)


def _compute_dtype(cfg):
    """The config's compute_dtype string as the forwards take it (None =
    f32)."""
    name = getattr(cfg, "compute_dtype", "f32")
    if name in ("f32", "float32", ""):
        return None
    if name in ("bf16", "bfloat16"):
        return torch.bfloat16
    if name == "bf16_agg":
        return "bf16_agg"
    raise ValueError(f"unknown compute_dtype {name!r} (use f32, bf16 or bf16_agg)")


def make_ode_sampler(
    v_fn_of: Callable,
    *,
    solver: str = "dopri5",
    n_steps: int = 100,
    n_save: int = 2,
    atol=1e-5,
    rtol=1e-5,
    return_dlogp: bool = True,
    divergence: str = "exact",
    div_chunk: Optional[int] = None,
    t0: float = 0.0,
    t1: float = 1.0,
    steps_per_dispatch: Optional[int] = None,
    max_steps: int = 1024,
    dlogp_quad_points: Optional[int] = None,
    dlogp_quad: str = "simpson",
    num_probes: int = 8,
    div_axis=None,
    probe_crn: bool = False,
    probe_mode: str = "rademacher",
    node_batch: Optional[int] = None,
    traj_drift: Optional[Callable] = None,
    div_drift: Optional[Callable] = None,
    return_dlogp_var: bool = False,
    device=None,
    dtype: torch.dtype = torch.float32,
):
    """Build a batched transport sampler ``sampler(x0s, conds, generator)
    -> ODESolution``.

    ``v_fn_of(conds) -> v(xs, t)`` builds the batched velocity of a chain
    batch from its conditioning (B, ...). Routes, as in ti_tpu:

    - stage-coupled dlogp (``dlogp_quad_points=None``): the divergence is
      integrated inside every solver stage, with the fixed-step solvers
      (euler/heun/rk4, in one pass or in segments of at most
      ``steps_per_dispatch`` steps, dlogp carried across) or adaptive
      dopri5 (``atol``/``rtol`` scalars or (x, dlogp) pairs, at most
      ``max_steps`` steps per save interval, or with
      ``steps_per_dispatch`` resumed in rounds of that many steps up to 64
      rounds; the segmented dopri5 takes the exact divergence only). A
      dopri5 chain that runs out of steps before a save time raises.
      ``return_dlogp=False`` is velocity-only transport, dlogp zero;
    - quadrature dlogp (``dlogp_quad_points``, fixed-step solvers): a
      velocity-only trajectory, then the divergence at a few nodes.
      ``dlogp_quad='gauss'``: ``dlogp_quad_points`` Gauss-Legendre nodes per
      save interval, in one pass on the warped grid of
      ``gauss_dlogp_schedule`` (``steps_per_dispatch=None``), or in
      trajectory gaps between the nodes of at most ``steps_per_dispatch`` RK
      steps each. ``dlogp_quad='simpson'``: composite Simpson over
      ``dlogp_quad_points`` uniform nodes (odd; (points - 1) divides
      ``n_steps``; n_save - 1 divides (points - 1) with an even quotient),
      the trajectory in one pass or in segments of at most
      ``steps_per_dispatch`` steps. ``node_batch`` evaluates the default
      route's nodes in groups of that size, with the same draws and results
      as one node at a time.

    ``traj_drift(xs, t, conds)`` drives the Gauss path's trajectory
    segments; ``div_drift(xs, t, conds, generator) -> (B,)`` estimates the
    divergence at each node — with ``return_dlogp_var`` it must return
    (div, var), e.g. ``pair_tangent_div_fn(return_var=True)``. With a hook
    None the dense velocity of ``v_fn_of`` serves, and the divergence runs
    as forward-mode JVPs: exact (in blocks of ``div_chunk`` lanes, None = all
    at once), or Hutchinson probes or Hutch++ queries (``num_probes`` of
    them) from ``generator``, per chain or shared (``probe_crn``).
    ``div_axis`` (a process group, or the name of a mesh dimension that
    ``lane_parallel_sampler`` resolves) shards the lanes of the divergence
    over the group's ranks, exact or Hutchinson, on every route that
    evaluates the divergence through ``v_fn_of``: not with Hutch++ (as in
    ti_tpu) and not with ``div_drift``, whose batched estimator does not
    shard. The states and the conditioning are cast to ``dtype``
    (float64: the ADW family's f64 mode).
    """
    dev = resolve_device(device)
    gauss = (dlogp_quad_points is not None and return_dlogp and dlogp_quad == "gauss")
    if return_dlogp and divergence == "hutchpp" and div_axis is not None:
        raise NotImplementedError(
            "div_axis lane sharding is not implemented for "
            "divergence='hutchpp' (the sketch QR needs the full query "
            "basis); every lane shard would redundantly compute the full "
            "estimator. Use divergence='exact' or 'hutchinson' with "
            "div_axis, or drop div_axis."
        )
    if div_drift is not None and div_axis is not None:
        raise ValueError(
            "div_axis is not supported with div_drift: the batched divergence-node "
            "estimator evaluates every lane on every rank, so the lanes would not be "
            "sharded. Drop div_drift (cfg.div_forward_impl='default') to shard the lanes."
        )
    if (traj_drift is not None or div_drift is not None) and not (
        gauss and steps_per_dispatch is not None
    ):
        raise ValueError(
            "traj_drift/div_drift require the segmented gauss "
            "quadrature-dlogp path (dlogp_quad='gauss', dlogp_quad_points=, "
            "steps_per_dispatch=)"
        )
    if return_dlogp_var and not (gauss and steps_per_dispatch is not None):
        raise ValueError(
            "return_dlogp_var requires the segmented gauss quadrature-dlogp "
            "path (dlogp_quad='gauss', dlogp_quad_points=, return_dlogp=True, "
            "steps_per_dispatch=)"
        )
    if probe_crn and div_drift is not None:
        raise ValueError(
            "probe_crn is not supported with div_drift: the batched estimator "
            "draws its own probes per chain"
        )
    if return_dlogp:
        check_divergence(divergence, num_probes)
    if dlogp_quad_points is not None and return_dlogp:
        if solver == "dopri5":
            raise ValueError("dlogp_quad_points requires a fixed-step solver")
        quad = dict(solver=solver, t0=t0, t1=t1, n_steps=n_steps, n_save=n_save,
                    divergence=divergence, div_chunk=div_chunk, div_axis=div_axis,
                    steps_per_dispatch=steps_per_dispatch, num_probes=num_probes,
                    probe_crn=probe_crn, probe_mode=probe_mode, node_batch=node_batch,
                    device=dev, dtype=dtype)
        if dlogp_quad == "gauss":
            return _gauss_dlogp_sampler(
                v_fn_of, gl_points=dlogp_quad_points, traj_drift=traj_drift,
                div_drift=div_drift, return_dlogp_var=return_dlogp_var, **quad)
        if dlogp_quad != "simpson":
            raise ValueError(f"unknown dlogp_quad {dlogp_quad!r} (simpson | gauss)")
        return _quad_dlogp_sampler(v_fn_of, div_points=dlogp_quad_points, **quad)
    div = dict(return_dlogp=return_dlogp, divergence=divergence, div_chunk=div_chunk,
               div_axis=div_axis, num_probes=num_probes, probe_mode=probe_mode,
               probe_crn=probe_crn)
    if solver == "dopri5":
        return _dopri5_sampler(v_fn_of, t0=t0, t1=t1, n_save=n_save, atol=atol, rtol=rtol,
                               max_steps=max_steps, steps_per_dispatch=steps_per_dispatch,
                               device=dev, dtype=dtype, **div)
    return _fixed_sampler(v_fn_of, solver=solver, t0=t0, t1=t1, n_steps=n_steps, n_save=n_save,
                          steps_per_dispatch=steps_per_dispatch, device=dev, dtype=dtype,
                          **div)


def _any_batch(v_fn_of, conds):
    """The velocity of ``v_fn_of(conds)`` for k stacked copies of the chain
    batch as well (the node groups of ``node_batch``): the conditioning is
    tiled k times, once for each k."""
    made = {}

    def v(x, t):
        k = x.shape[0] // conds.shape[0]
        if k not in made:
            made[k] = v_fn_of(conds.repeat(k, *([1] * (conds.dim() - 1))))
        return made[k](x, t)

    return v


def _segments_per_interval(per_save: int, steps_per_dispatch: int) -> int:
    """Smallest q dividing per_save with per_save/q <= steps_per_dispatch."""
    q = max(1, -(-per_save // steps_per_dispatch))
    while per_save % q:
        q += 1
    return q


def _fixed_sampler(v_fn_of, *, solver, t0, t1, n_steps, n_save, steps_per_dispatch, device,
                   dtype, **div):
    """Fixed-step transport of the whole chain batch, stage-coupled dlogp
    or velocity only: in one ``sample_ode`` call, or (``steps_per_dispatch``)
    in segments of ``per_save / q`` steps, q the smallest divisor of the
    steps per save interval that keeps a segment within
    ``steps_per_dispatch``, dlogp carried from segment to segment."""
    n_stages = len(_tableau(solver)[2])
    if n_save < 2 or n_steps % (n_save - 1) != 0:
        raise ValueError("n_steps must be a positive multiple of (n_save - 1)")
    per_save = n_steps // (n_save - 1)
    q = 1 if steps_per_dispatch is None else _segments_per_interval(per_save, steps_per_dispatch)
    sub_steps = per_save // q
    seg_span = (t1 - t0) / (n_steps // sub_steps)

    @torch.no_grad()
    def sampler(x0s, conds, generator: Optional[torch.Generator] = None) -> ODESolution:
        x = torch.as_tensor(x0s, dtype=dtype, device=device)
        v = v_fn_of(torch.as_tensor(conds, dtype=dtype, device=device))
        if steps_per_dispatch is None:
            return sample_ode(v, x, t0=t0, t1=t1, n_steps=n_steps, n_save=n_save,
                              method=solver, generator=generator, **div)
        lp = x.new_zeros(x.shape[0])
        xs, lps = [x], [lp]
        for si in range((n_save - 1) * q):
            ts = t0 + si * seg_span
            sol = sample_ode(v, x, t0=ts, t1=ts + seg_span, n_steps=sub_steps, method=solver,
                             generator=generator, dlogp0=lp, **div)
            x, lp = sol.xs[:, -1], sol.dlogp[:, -1]
            if (si + 1) % q == 0:
                xs.append(x)
                lps.append(lp)
        return ODESolution(xs=torch.stack(xs, dim=1), dlogp=torch.stack(lps, dim=1),
                           nfe=n_steps * n_stages)

    return sampler


def _dopri5_sampler(v_fn_of, *, t0, t1, n_save, atol, rtol, max_steps, steps_per_dispatch,
                    device, dtype, **div):
    """Adaptive dopri5 transport of the whole chain batch: ``sample_ode_dopri5``
    (per-chain NFE), or with ``steps_per_dispatch`` the segmented form of
    ti_tpu — every save interval advanced in rounds of at most that many
    steps a chain, up to 64 rounds, exact divergence only, NFE the batch's
    maximum."""
    if steps_per_dispatch is not None and div["return_dlogp"] and div["divergence"] != "exact":
        raise NotImplementedError("segmented dopri5 supports exact divergence only (parity mode)")

    @torch.no_grad()
    def sampler(x0s, conds, generator: Optional[torch.Generator] = None) -> ODESolution:
        x = torch.as_tensor(x0s, dtype=dtype, device=device)
        v = v_fn_of(torch.as_tensor(conds, dtype=dtype, device=device))
        if steps_per_dispatch is None:
            return sample_ode_dopri5(v, x, t0=t0, t1=t1, n_save=n_save, atol=atol, rtol=rtol,
                                     max_steps=max_steps, generator=generator, **div)
        init, advance = dopri5_stepper(v, t0=t0, t1=t1, atol=atol, rtol=rtol,
                                       max_steps=steps_per_dispatch, generator=generator, **div)
        state = init(x)
        xs, lps = [state.x], [state.lp]
        for tau in np.linspace(0.0, abs(t1 - t0), n_save)[1:]:
            for _ in range(64):  # the backstop of ti_tpu's segmented sampler
                state = advance(state, float(tau))
                short = n_short(state, float(tau))
                if not short:
                    break
            else:
                raise short_of_save_time(
                    short, x.shape[0], t0 + np.sign(t1 - t0) * tau,
                    f"64 rounds of steps_per_dispatch = {steps_per_dispatch} steps")
            xs.append(state.x)
            lps.append(state.lp)
        return ODESolution(xs=torch.stack(xs, dim=1), dlogp=torch.stack(lps, dim=1),
                           nfe=int(state.nfe.max()))

    return sampler


def _quad_dlogp_sampler(
    v_fn_of, *, solver, t0, t1, n_steps, n_save, div_points, divergence, div_chunk, div_axis,
    steps_per_dispatch, num_probes, probe_crn, probe_mode, node_batch, device, dtype,
):
    """Simpson-quadrature dlogp: ``sample_ode_quad_dlogp`` on the whole
    chain batch, or with ``steps_per_dispatch`` the velocity-only
    trajectory in segments (``_fixed_sampler``) saving the div_points grid,
    then the divergence at every grid node and cumulative Simpson."""
    _check_quad(div_points, n_steps, n_save)
    div = dict(divergence=divergence, num_probes=num_probes, div_chunk=div_chunk,
               div_axis=div_axis, probe_mode=probe_mode, probe_crn=probe_crn,
               node_batch=node_batch)
    n_stages = len(_tableau(solver)[2])
    traj = None
    if steps_per_dispatch is not None:
        traj = _fixed_sampler(v_fn_of, solver=solver, t0=t0, t1=t1, n_steps=n_steps,
                              n_save=div_points, steps_per_dispatch=steps_per_dispatch,
                              device=device, dtype=dtype, return_dlogp=False)

    @torch.no_grad()
    def sampler(x0s, conds, generator: Optional[torch.Generator] = None) -> ODESolution:
        x = torch.as_tensor(x0s, dtype=dtype, device=device)
        conds = torch.as_tensor(conds, dtype=dtype, device=device)
        v = _any_batch(v_fn_of, conds)
        if traj is None:
            return sample_ode_quad_dlogp(v, x, t0=t0, t1=t1, n_steps=n_steps,
                                         div_points=div_points, n_save=n_save, method=solver,
                                         generator=generator, **div)
        xs = traj(x, conds).xs  # (B, div_points, ...)
        divs = node_divergences(v, xs.transpose(0, 1), np.linspace(t0, t1, div_points),
                                generator=generator, **div)
        out_idx = np.arange(n_save) * ((div_points - 1) // (n_save - 1))
        return ODESolution(xs=xs[:, out_idx], dlogp=simpson_dlogp(divs, t0, t1, n_save),
                           nfe=n_steps * n_stages + div_points)

    return sampler


def _gauss_dlogp_sampler(
    v_fn_of, *, solver, t0, t1, n_steps, n_save, gl_points, divergence, div_chunk, div_axis,
    steps_per_dispatch, num_probes, probe_crn, probe_mode, node_batch,
    traj_drift, div_drift, return_dlogp_var, device, dtype,
):
    """Gauss-Legendre dlogp. With ``steps_per_dispatch=None``
    ``sample_ode_gauss_dlogp`` on the whole chain batch. Otherwise phase 1
    integrates gap by gap (a gap lies between consecutive quadrature/save
    boundaries) with the same number of RK steps per gap; phase 2 evaluates
    the divergence at every node; dlogp is the Gauss-Legendre weighted sum
    per save interval."""
    if gl_points < 1:
        raise ValueError("gl_points must be >= 1")
    if steps_per_dispatch is None:
        div = dict(divergence=divergence, num_probes=num_probes, div_chunk=div_chunk,
                   div_axis=div_axis, probe_mode=probe_mode, probe_crn=probe_crn,
                   node_batch=node_batch)

        @torch.no_grad()
        def sampler_single(x0s, conds, generator: Optional[torch.Generator] = None):
            x = torch.as_tensor(x0s, dtype=dtype, device=device)
            v = _any_batch(v_fn_of, torch.as_tensor(conds, dtype=dtype, device=device))
            return sample_ode_gauss_dlogp(v, x, t0=t0, t1=t1, n_steps=n_steps,
                                          gl_points=gl_points, n_save=n_save, method=solver,
                                          generator=generator, **div)

        return sampler_single
    if return_dlogp_var and divergence != "hutchinson":
        raise ValueError(
            "return_dlogp_var requires divergence='hutchinson' (the "
            "probe-noise variance of the stochastic estimator; exact has none)"
        )
    gl_x, gl_w = np.polynomial.legendre.leggauss(gl_points)
    saves = np.linspace(t0, t1, n_save)
    bounds = [t0]
    node_w = np.zeros((n_save - 1, gl_points))
    for j in range(n_save - 1):
        lo, hi = saves[j], saves[j + 1]
        half = 0.5 * (hi - lo)
        bounds.extend((lo + half * (gl_x + 1.0)).tolist())
        bounds.append(hi)
        node_w[j] = gl_w * half
    bounds = np.asarray(bounds)  # len = 1 + (n_save-1)*(gl_points+1)
    gaps_per_interval = gl_points + 1
    m = max(1, -(-n_steps // ((n_save - 1) * gaps_per_interval)))
    m = min(m, steps_per_dispatch)
    n_stages = len(_tableau(solver)[2])
    save_pos = np.arange(n_save) * gaps_per_interval
    node_pos = np.setdiff1d(np.arange(len(bounds)), save_pos)

    def drift_of(conds):
        if traj_drift is not None:
            return lambda xs, t: traj_drift(xs, t, conds)
        return v_fn_of(conds)

    def node_divs(xs_nodes, conds, generator):
        """(B, nodes) divergences[, variances] at the nodes (nodes, B, ...)."""
        if div_drift is None:
            return node_divergences(
                _any_batch(v_fn_of, conds), xs_nodes, bounds[node_pos], divergence=divergence,
                generator=generator, num_probes=num_probes, div_chunk=div_chunk,
                probe_mode=probe_mode, probe_crn=probe_crn, node_batch=node_batch,
                return_var=return_dlogp_var, div_axis=div_axis)
        outs = [div_drift(xb, float(t), conds, generator)
                for xb, t in zip(xs_nodes, bounds[node_pos])]
        if return_dlogp_var:
            return tuple(torch.stack(o, dim=1) for o in zip(*outs))
        return torch.stack(outs, dim=1)

    @torch.no_grad()
    def sampler(x0s, conds, generator: torch.Generator) -> ODESolution:
        x = torch.as_tensor(x0s, dtype=dtype, device=device)
        conds = torch.as_tensor(conds, dtype=dtype, device=device)
        drift = drift_of(conds)
        states = [x]
        for gi in range(len(bounds) - 1):
            x = sample_ode(drift, x, t0=float(bounds[gi]), t1=float(bounds[gi + 1]),
                           n_steps=m, method=solver).xs[:, -1]
            states.append(x)
        stacked = torch.stack(states, dim=1)  # (B, len(bounds), ...)
        divs = node_divs(stacked[:, node_pos].transpose(0, 1), conds, generator)
        if return_dlogp_var:
            divs, dvars = divs
        b = x.shape[0]
        w = torch.as_tensor(node_w, dtype=x.dtype, device=device)
        divs = divs.reshape(b, n_save - 1, gl_points)
        zero = torch.zeros((b, 1), dtype=x.dtype, device=device)
        dlogp = torch.cat([zero, torch.cumsum(-(w[None] * divs).sum(2), dim=1)], dim=1)
        dlogp_var = None
        if return_dlogp_var:
            # independent probe draws per node: Var(dlogp) = sum w^2 var
            dv = dvars.reshape(b, n_save - 1, gl_points)
            dlogp_var = torch.cat([zero, torch.cumsum(((w ** 2)[None] * dv).sum(2), dim=1)], dim=1)
        nfe = (len(bounds) - 1) * m * n_stages + len(node_pos)
        return ODESolution(xs=stacked[:, save_pos], dlogp=dlogp, nfe=nfe, dlogp_var=dlogp_var)

    return sampler


# ---------------------------------------------------------------------------
# ADW (reference adw/sample.py:14-88)
# ---------------------------------------------------------------------------

def adw_v_fn_of(model, params) -> Callable:
    """``v_fn_of(conds (B, 2)) -> v(xs (B, 1), t)``: the ADW field at the
    chains' (beta0, beta1); t a scalar, or (B,) per chain under dopri5."""
    from ti_torch.models.mlp import apply_fcnet

    def v_fn_of(conds):
        b0, b1 = conds[:, :1], conds[:, 1:]

        def v(xs, t):
            tt = torch.as_tensor(t, dtype=xs.dtype, device=xs.device)
            return apply_fcnet(model, params, xs, tt.reshape(-1, 1).expand(xs.shape[0], 1),
                               b0, b1)

        return v

    return v_fn_of


def sample_adw(
    cfg: ADWConfig,
    model,
    params,
    x0: np.ndarray,
    beta0: np.ndarray,
    save: bool = True,
    device=None,
) -> Dict[str, np.ndarray]:
    """Transport test samples from beta0 to cfg.beta1s[0] with dlogp, all
    chains in one batch, through the route ``cfg`` names (default dopri5
    with the exact divergence in every stage; rk4 and the Simpson or Gauss
    quadrature routes as ``make_ode_sampler`` takes them).

    x0: (n, 1) initial samples, beta0: (n,) their betas; ``params`` a state
    dict (None: the model's own), in ``cfg.dtype``. Returns and saves
    initial_samples/samples/dlogps arrays; samples and dlogps are
    (n_save, n) like the reference's reshaped output (adw/sample.py:63-69),
    n_save = cfg.n_step under dopri5 and 2 otherwise; ``nfe`` is the most
    right-hand-side evaluations a chain took. Runs on ``cuda`` unless
    ``device`` says otherwise."""
    from ti_torch.models.mlp import param_dtype

    if len(cfg.beta1s) != 1:
        raise ValueError("sampling expects a single (beta0, beta1) pair")
    dev = resolve_device(device)
    dt = param_dtype(cfg.dtype)
    beta1 = float(cfg.beta1s[0])
    n_save = cfg.n_step if cfg.solver_type == "dopri5" else 2
    if params is None:
        params = dict(model.named_parameters())
    sampler = make_ode_sampler(
        adw_v_fn_of(model, params),
        solver=cfg.solver_type,
        n_steps=cfg.n_step,
        n_save=n_save,
        atol=cfg.atol,
        rtol=cfg.rtol,
        return_dlogp=cfg.return_dlogp,
        divergence=cfg.divergence,
        steps_per_dispatch=cfg.steps_per_dispatch or None,
        dlogp_quad_points=getattr(cfg, "dlogp_quad_points", 0) or None,
        dlogp_quad=getattr(cfg, "dlogp_quad", "simpson"),
        num_probes=getattr(cfg, "num_probes", 8),
        probe_mode=getattr(cfg, "probe_mode", "rademacher"),
        probe_crn=bool(getattr(cfg, "probe_crn", False)),
        device=dev,
        dtype=dt,
    )
    b0 = np.asarray(beta0, np.float64).reshape(-1)
    conds = np.stack([b0, np.full_like(b0, beta1)], axis=1)
    sol = sampler(np.asarray(x0), conds, torch.Generator(device=dev).manual_seed(int(cfg.seed)))

    out = {
        "initial_samples": np.asarray(x0).reshape(-1),
        "samples": sol.xs[:, :, 0].T.cpu().numpy(),  # (n_save, n)
        "dlogps": sol.dlogp.T.cpu().numpy(),  # (n_save, n)
        "nfe": int(torch.as_tensor(sol.nfe).max()),
    }
    if save:
        out_dir = os.path.join(cfg.data_save_path, cfg.model_save_name,
                               f"beta_{cfg.beta0s[0]}_to_{beta1}")
        os.makedirs(out_dir, exist_ok=True)
        tag = f"epoch_{cfg.sampling_epoch}"
        if getattr(cfg, "num_shards", 1) > 1:  # fan-out
            tag += f"_shard{cfg.shard}of{cfg.num_shards}"
        np.save(os.path.join(out_dir, f"initial_samples_{tag}.npy"), out["initial_samples"])
        np.save(os.path.join(out_dir, f"samples_{tag}.npy"), out["samples"])
        if cfg.return_dlogp:
            np.save(os.path.join(out_dir, f"dlogps_{tag}.npy"), out["dlogps"])
    return out


# ---------------------------------------------------------------------------
# MDQM9 ambient (reference mdqm9/sample_ambient.py)
# ---------------------------------------------------------------------------

def molecular_v_fn_of(model, params, template, impl: str = "dense", compute_dtype=None,
                      device=None):
    """Batched velocity factory ``v_fn_of(temps (B,K)) -> v(xs (B,N,3), t)``;
    ``t`` is a float or per-chain times (B,) (dopri5 steps each chain on its
    own clock).

    ``impl="dense"`` is the dense pair forward (models/cpainn_dense.py);
    ``impl="dense_fused"`` runs its message MLPs as kernel B4, and their
    forward-mode tangents (the divergence's JVP lanes) as kernel B5, with
    the weights packed once, here: f32 only, no reverse mode.
    ``impl="edge"`` is the gather/scatter form (models/cpainn.py::
    apply_edge), f32 only."""
    if impl not in ("dense", "dense_fused", "edge"):
        raise ValueError(f"unknown impl {impl!r} (dense | dense_fused | edge)")
    from ti_torch.models.cpainn import apply_edge, state_of
    from ti_torch.models.cpainn_dense import apply_dense, pack_message_layers

    dev = resolve_device(device)
    p = {k: t.detach().to(dev) for k, t in state_of(model, params).items()}
    atom_ids = torch.as_tensor(template.atom_ids, device=dev)
    if impl != "dense" and compute_dtype is not None:
        raise ValueError(f"impl={impl!r} is f32 only: compute_dtype must be None")
    fused = impl == "dense_fused"
    packed = pack_message_layers(model, p, dev) if fused else None

    def v_fn_of(temps):
        def v(xs, t):
            tb = torch.as_tensor(t, dtype=xs.dtype, device=xs.device).expand(xs.shape[0])
            if impl == "edge":
                return apply_edge(model, p, xs, tb, temps, atom_ids, template.edges)
            return apply_dense(model, p, xs, tb, temps, atom_ids, template.edges,
                               compute_dtype=compute_dtype, fused=fused, packed=packed)

        return v

    return v_fn_of


def _gauss_path(cfg) -> bool:
    return bool(
        getattr(cfg, "dlogp_quad", "") == "gauss"
        and getattr(cfg, "dlogp_quad_points", 0)
        and getattr(cfg, "steps_per_dispatch", 0)
        and cfg.return_dlogp
    )


def _traj_drift_of(cfg, model, params, template, device=None):
    """The trajectory drift from ``cfg.traj_forward_impl``: None for
    "default", kernel B1 (f32 or bf16_agg) for "pair_kernel" /
    "pair_kernel_bf16"."""
    impl = getattr(cfg, "traj_forward_impl", "default")
    if impl in ("", "default"):
        return None
    from ti_torch.ops.pair_layer_kernel import pair_kernel_drift

    try:
        cd = {"pair_kernel": None, "pair_kernel_bf16": "bf16_agg"}[impl]
    except KeyError:
        raise ValueError(
            f"unknown traj_forward_impl {impl!r} (default | pair_kernel | pair_kernel_bf16)"
        ) from None
    if not _gauss_path(cfg):
        raise ValueError(
            "traj_forward_impl needs the segmented gauss quadrature-dlogp "
            "path: set dlogp_quad='gauss', dlogp_quad_points and "
            "steps_per_dispatch (see make_ode_sampler traj_drift)"
        )
    return pair_kernel_drift(model, params, template, compute_dtype=cd, device=device)


def _div_drift_of(cfg, model, params, template, device=None):
    """The divergence-node estimator from ``cfg.div_forward_impl``: None
    for "default", kernel B3 (f32 or bf16_agg) for "pair_tangent" /
    "pair_tangent_bf16". With ``cfg.divergence == "exact"`` it runs the
    full orthogonal frame (K = 3N), which is the exact trace. The
    estimator returns its variance too when ``cfg.return_dlogp_var`` is
    set."""
    impl = getattr(cfg, "div_forward_impl", "default")
    if impl in ("", "default"):
        return None
    from ti_torch.ops.pair_tangent_kernel import pair_tangent_div_fn

    try:
        cd = {"pair_tangent": None, "pair_tangent_bf16": "bf16_agg"}[impl]
    except KeyError:
        raise ValueError(
            f"unknown div_forward_impl {impl!r} (default | pair_tangent | pair_tangent_bf16)"
        ) from None
    if not _gauss_path(cfg):
        raise ValueError(
            "div_forward_impl needs the segmented gauss quadrature-dlogp "
            "path: set dlogp_quad='gauss', dlogp_quad_points and "
            "steps_per_dispatch (see make_ode_sampler div_drift)"
        )
    if cfg.divergence == "hutchinson":
        num_probes = getattr(cfg, "num_probes", 16)
        probe_mode = getattr(cfg, "probe_mode", "rademacher")
    elif cfg.divergence == "exact":
        num_probes = 3 * template.n_atoms
        probe_mode = "orthogonal"
    else:
        raise ValueError(
            f"div_forward_impl does not support divergence={cfg.divergence!r} "
            "(exact | hutchinson)"
        )
    return pair_tangent_div_fn(
        model, params, template, num_probes=num_probes, probe_mode=probe_mode,
        compute_dtype=cd, return_var=bool(getattr(cfg, "return_dlogp_var", False)),
        device=device,
    )


def _config_sampler(cfg, model, params, template, dev):
    """The sampler ``cfg`` names for ``model``: its solver and dlogp route,
    ``n_save`` = n_steps for dopri5, else max(2, n_steps // 50 + 1), and
    the trajectory and divergence hooks of ``cfg.traj_forward_impl`` and
    ``cfg.div_forward_impl``."""
    return make_ode_sampler(
        molecular_v_fn_of(model, params, template, compute_dtype=_compute_dtype(cfg),
                          device=dev),
        solver=cfg.solver_type,
        n_steps=cfg.n_steps,
        n_save=cfg.n_steps if cfg.solver_type == "dopri5" else max(2, cfg.n_steps // 50 + 1),
        atol=cfg.atol,
        rtol=cfg.rtol,
        return_dlogp=cfg.return_dlogp,
        divergence=cfg.divergence,
        steps_per_dispatch=cfg.steps_per_dispatch or None,
        dlogp_quad_points=getattr(cfg, "dlogp_quad_points", 0) or None,
        dlogp_quad=getattr(cfg, "dlogp_quad", "simpson"),
        num_probes=getattr(cfg, "num_probes", 8),
        probe_mode=getattr(cfg, "probe_mode", "rademacher"),
        probe_crn=bool(getattr(cfg, "probe_crn", False)),
        traj_drift=_traj_drift_of(cfg, model, params, template, dev),
        div_drift=_div_drift_of(cfg, model, params, template, dev),
        return_dlogp_var=bool(getattr(cfg, "return_dlogp_var", False)),
        device=dev,
    )


def sample_ambient(
    cfg: MDQM9Config,
    model,
    params,
    template,
    x0: np.ndarray,
    latent_z: Optional[np.ndarray] = None,
    latent_dlogp: Optional[np.ndarray] = None,
    save: bool = True,
    batch_size: Optional[int] = None,
    device=None,
) -> Dict[str, np.ndarray]:
    """Transport conformations x0 (n, N, 3) from sampling_T0 to
    sampling_T1, with dlogp. ``params`` is a CPaiNN state dict (None: the
    model's own). ``nfe`` is the most right-hand-side evaluations a chain
    took, ``nfe_per_chain`` each chain's (dopri5 steps every chain on its
    own). Optional latent_z/latent_dlogp pass through for the
    BG→TI composition bookkeeping. Runs on ``cuda`` unless ``device``
    says otherwise."""
    dev = resolve_device(device)
    x0 = np.asarray(x0, dtype=np.float32)
    n = len(x0)
    bs = batch_size or cfg.batch_size
    sampler = _config_sampler(cfg, model, params, template, dev)

    if latent_z is None:
        latent_z = np.zeros_like(x0)
    if latent_dlogp is None:
        latent_dlogp = np.zeros(n, dtype=np.float32)
    temps_full = np.tile(np.array([cfg.sampling_T0, cfg.sampling_T1], dtype=np.float32), (n, 1))

    if save:
        os.makedirs(cfg.data_save_path, exist_ok=True)
    generator = torch.Generator(device=dev).manual_seed(int(cfg.seed))
    all_samples, all_dlogps, all_dvars, all_nfe = [], [], [], []
    for i in range(0, n, bs):
        xb, tb = x0[i: i + bs], temps_full[i: i + bs]
        take = len(xb)
        if take < bs:  # pad the tail batch, slice back
            pad = bs - take
            xb = np.concatenate([xb, np.repeat(xb[-1:], pad, axis=0)])
            tb = np.concatenate([tb, np.repeat(tb[-1:], pad, axis=0)])
        sol = sampler(xb, tb, generator)
        all_samples.append(sol.xs[:take].cpu().numpy())  # (B, n_save, N, 3)
        all_dlogps.append(sol.dlogp[:take, -1].cpu().numpy())  # final dlogp per chain
        if sol.dlogp_var is not None:
            all_dvars.append(sol.dlogp_var[:take, -1].cpu().numpy())
        all_nfe.append(np.broadcast_to(torch.as_tensor(sol.nfe).cpu().numpy(), (bs,))[:take])
        if save:  # incremental checkpointing
            _save_ambient(cfg, all_samples, all_dlogps, latent_z, latent_dlogp,
                          i + take, all_dvars)

    out = {
        "samples": np.concatenate(all_samples, axis=0),
        "dlogps": np.concatenate(all_dlogps, axis=0),
        "latent_noises": latent_z[:n],
        "latent_dlogps": latent_dlogp[:n],
        "nfe": int(np.max(np.concatenate(all_nfe))),
        "nfe_per_chain": np.concatenate(all_nfe),
    }
    if all_dvars:
        out["dlogp_vars"] = np.concatenate(all_dvars, axis=0)
    return out


def _save_ambient(cfg, samples_list, dlogps_list, latent_z, latent_dlogp,
                  n_done, dvars_list=()):
    base = cfg.data_save_path
    name = cfg.data_save_name
    np.save(os.path.join(base, f"samples_{name}.npy"), np.concatenate(samples_list, axis=0))
    np.save(os.path.join(base, f"dlogps_{name}.npy"), np.concatenate(dlogps_list, axis=0))
    np.save(os.path.join(base, f"latent_noises_{name}.npy"), latent_z[:n_done])
    np.save(os.path.join(base, f"latent_dlogps_{name}.npy"), latent_dlogp[:n_done])
    if dvars_list:
        # probe-noise variance of each chain's dlogp (cfg.return_dlogp_var):
        # exp(-phi) consumers debias with phi += var/2
        # (analysis.free_energy.debias_phis)
        np.save(os.path.join(base, f"dlogp_vars_{name}.npy"),
                np.concatenate(dvars_list, axis=0))


# ---------------------------------------------------------------------------
# MDQM9 latent / Boltzmann generator (reference mdqm9/sample_latent.py)
# ---------------------------------------------------------------------------

def sample_latent(
    cfg: MDQM9Config,
    model,
    params,
    template,
    n_samples: Optional[int] = None,
    save: bool = True,
    batch_size: Optional[int] = None,
    noise: Optional[np.ndarray] = None,
    device=None,
) -> Dict[str, np.ndarray]:
    """Generate conformations at ``cfg.sampling_T`` from COM-free N(0, I)
    noise, with dlogp, through the route ``cfg`` names (as
    ``sample_ambient``: the trajectory and divergence hooks of
    ``cfg.traj_forward_impl``/``cfg.div_forward_impl`` on the segmented
    Gauss path). ``samples`` is (n, n_save, N, 3), its first save point the
    noise. Each batch draws its noise from a generator seeded by
    ``cfg.seed`` (on the device, before the sampler's probes) unless
    ``noise`` (n, N, 3) gives it, used as it is; a tail batch is padded and
    sliced back. The model is conditioned on (B, t_cond) temperatures,
    t_cond 0 or 1 from the template. Writes ``samples_{name}_forward.npy``,
    ``dlogps_{name}_forward.npy`` (and ``dlogp_vars_{name}_forward.npy``)
    after every batch. Runs on ``cuda`` unless ``device`` says otherwise."""
    dev = resolve_device(device)
    n = n_samples or (len(noise) if noise is not None else cfg.n_latent_samples)
    bs = batch_size or cfg.batch_size
    n_atoms = template.n_atoms
    sampler = _config_sampler(cfg, model, params, template, dev)

    if save:
        os.makedirs(cfg.data_save_path, exist_ok=True)
    generator = torch.Generator(device=dev).manual_seed(int(cfg.seed))
    temps = torch.full((bs, template.t_cond), float(cfg.sampling_T), device=dev)
    all_samples, all_dlogps, all_dvars, all_nfe = [], [], [], []
    for i in range(0, n, bs):
        take = min(bs, n - i)
        if noise is None:
            z = torch.randn((bs, n_atoms, 3), generator=generator, device=dev)
            z = z - z.mean(dim=1, keepdim=True)
        else:
            z = torch.as_tensor(np.asarray(noise[i: i + take], np.float32), device=dev)
            z = torch.cat([z, z[-1:].expand(bs - take, n_atoms, 3)])
        sol = sampler(z, temps, generator)
        all_samples.append(sol.xs[:take].cpu().numpy())  # (B, n_save, N, 3)
        all_dlogps.append(sol.dlogp[:take, -1].cpu().numpy())
        if sol.dlogp_var is not None:
            all_dvars.append(sol.dlogp_var[:take, -1].cpu().numpy())
        all_nfe.append(np.broadcast_to(torch.as_tensor(sol.nfe).cpu().numpy(), (bs,))[:take])
        if save:  # incremental checkpointing
            name = cfg.data_save_name
            arrays = {"samples": all_samples, "dlogps": all_dlogps, "dlogp_vars": all_dvars}
            for stem, parts in arrays.items():
                if parts:
                    np.save(os.path.join(cfg.data_save_path, f"{stem}_{name}_forward.npy"),
                            np.concatenate(parts, axis=0))

    out = {
        "samples": np.concatenate(all_samples, axis=0),
        "dlogps": np.concatenate(all_dlogps, axis=0),
        "nfe": int(np.max(np.concatenate(all_nfe))),
        "nfe_per_chain": np.concatenate(all_nfe),
    }
    if all_dvars:
        out["dlogp_vars"] = np.concatenate(all_dvars, axis=0)
    return out


# ---------------------------------------------------------------------------
# SDE sampling (Euler–Maruyama over the learned drift)
# ---------------------------------------------------------------------------

def sample_molecular_sde(
    model,
    params,
    template,
    x0,
    temps,
    generator: Optional[torch.Generator] = None,
    *,
    g_fn=0.0,
    n_steps: int = 100,
    n_save: int = 2,
    compute_dtype=None,
    forward_impl: str = "dense",
    chain_block: int = 1,
    noise: Optional[torch.Tensor] = None,
    device=None,
) -> torch.Tensor:
    """Batched Euler–Maruyama transport (no dlogp) of x0 (C, N, 3) under
    conditioning temps (C, K); the noise is projected to zero centre of
    mass per chain. Returns (C, n_save, N, 3).

    The drift is the dense forward on the whole chain batch per step
    (``forward_impl="dense"``, ``chain_block`` ignored) or the pair-kernel
    forward (``"pair_kernel"``: kernel B1, or B2 with ``chain_block`` > 1;
    ``compute_dtype`` None or "bf16_agg"). On the card ``chain_block`` C
    (any C >= 1) sets min(C, 3) 64-row tiles of pair rows a CTA in bf16_agg
    (min(C, 4) at F = 64, one at F = 256), which share each weight fragment the CTA loads, and changes nothing in
    f32, where B2 is B1's 3xTF32 kernel: every C gives B1's bits. The noise of
    each step is drawn from ``generator`` unless ``noise`` (n_steps, C, N,
    3) is given. Runs on ``cuda`` unless ``device`` says otherwise.
    """
    from ti_torch.models.cpainn import state_of

    if n_save < 2 or n_steps % (n_save - 1) != 0:
        raise ValueError("n_steps must be a positive multiple of (n_save - 1)")
    dev = resolve_device(device)
    if forward_impl == "pair_kernel":
        from ti_torch.ops.pair_layer_kernel import pair_kernel_drift

        drift = pair_kernel_drift(model, params, template, compute_dtype=compute_dtype,
                                  device=dev, chain_block=chain_block)
    elif forward_impl == "dense":
        from ti_torch.models.cpainn_dense import dense_velocity_fn

        p = {k: t.detach().to(dev) for k, t in state_of(model, params).items()}
        drift = dense_velocity_fn(model, p, template, compute_dtype=compute_dtype)
    else:
        raise ValueError(f"unknown forward_impl {forward_impl!r} (dense | pair_kernel)")
    x = torch.as_tensor(x0, dtype=torch.float32, device=dev)
    conds = torch.as_tensor(temps, dtype=torch.float32, device=dev)
    with torch.no_grad():
        xs = sample_sde(lambda xx, t: drift(xx, t, conds).to(x.dtype), x, generator,
                        g_fn=g_fn, n_steps=n_steps, n_save=n_save, project_zero_mean=True,
                        noise=noise)  # (n_save, C, N, 3)
    return xs.movedim(0, 1)
