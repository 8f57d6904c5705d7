"""Probability-flow integrators with stage-coupled or quadrature dlogp,
adaptive Dormand–Prince 5(4) and the Euler–Maruyama SDE (port of
ti_tpu/sampling/integrators.py).

Batched over chains: a velocity ``v_fn(xs, t)`` maps (B, ...) states to
(B, ...) velocities with no coupling between chains, and the joint state
is (x (B, ...), dlogp (B,)). Python loops take the place of ``lax.scan``
and ``lax.while_loop``. With dlogp, every RK stage evaluates the velocity
and its divergence together (``_make_rhs_joint``, exact or stochastic over
ops/divergence.py). The stochastic estimators draw fresh probes from the
``torch.Generator`` at every evaluation, where ti_tpu folds the evaluation
index into its key; ``probes(eval_idx)`` replaces the draw (the parity
tests pass JAX's). ``div_axis`` shards the divergence's tangent lanes over
a process group (ops/divergence.py: exact and Hutchinson).

The quadrature samplers decouple dlogp from the trajectory: velocity-only
RK steps, then the divergence at a few nodes, integrated by composite
Simpson (``sample_ode_quad_dlogp``) or Gauss-Legendre per save interval
(``sample_ode_gauss_dlogp``, on the warped grid of
``gauss_dlogp_schedule`` stepped by ``sample_ode_times``). Node i draws
its probes as evaluation i.

dopri5 keeps ti_tpu's per-chain semantics (one while-loop per chain under
vmap there): every chain has its own time, step size, accept decision and
evaluation count, and a chain that reached the save time stops moving, so
in dopri5 ``v_fn`` receives per-chain times (B,). Unlike ti_tpu, a chain
that spends its ``max_steps`` budget inside one save interval raises
rather than being returned short of the save time.

Sign conventions match ti_tpu: forward transport integrates
d(dlogp)/dt = -div b, so the saved dlogp is log q(x_1) - log p_0(x_0);
reverse transport is t0=1 -> t1=0.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from ti_torch.ops.divergence import draw_probes, value_and_divergence
from ti_torch.parallel.collectives import ChainShard

DIVERGENCES = ("exact", "hutchinson", "hutchpp")


class ODESolution(NamedTuple):
    """xs: (B, n_save, *state) trajectory at the save points (including
    t0); dlogp: (B, n_save) integrated log-density change; nfe: number of
    right-hand-side evaluations, an int, or (B,) per chain for dopri5;
    dlogp_var: optional (B, n_save) variance of the stochastic-divergence
    noise accumulated into dlogp."""

    xs: torch.Tensor
    dlogp: torch.Tensor
    nfe: Union[int, torch.Tensor]
    dlogp_var: Optional[torch.Tensor] = None


def _tableau(method: str):
    """Butcher tableau (c, A, b) of an explicit RK method."""
    if method == "euler":
        return np.zeros(1), np.zeros((1, 1)), np.array([1.0])
    if method == "heun":
        return np.array([0.0, 1.0]), np.array([[0.0, 0.0], [1.0, 0.0]]), np.array([0.5, 0.5])
    if method == "rk4":
        c = np.array([0.0, 0.5, 0.5, 1.0])
        a = np.zeros((4, 4))
        a[1, 0] = 0.5
        a[2, 1] = 0.5
        a[3, 2] = 1.0
        b = np.array([1, 2, 2, 1]) / 6.0
        return c, a, b
    raise ValueError(f"unknown method {method!r}")


def check_divergence(divergence: str, num_probes: int) -> None:
    """Refuse an unknown estimator or a Hutch++ budget below one sketch
    row, its exact-term query and a residual probe."""
    if divergence not in DIVERGENCES:
        raise ValueError(f"unknown divergence {divergence!r} (exact | hutchinson | hutchpp)")
    if divergence == "hutchpp" and num_probes < 3:
        raise ValueError(f"divergence='hutchpp' needs num_probes >= 3 (a sketch row, its "
                         f"exact-term query and a residual probe), got {num_probes}")


def _make_rhs_joint(v_fn, return_dlogp: bool, divergence: str = "exact",
                    generator: Optional[torch.Generator] = None, num_probes: int = 8,
                    div_chunk: Optional[int] = None, div_axis=None,
                    probe_mode: str = "rademacher", probe_crn: bool = False,
                    probes: Optional[Callable] = None):
    """``rhs(x, t, eval_idx) -> (dx/dt (B, ...), d(dlogp)/dt = -div (B,))``,
    the velocity and its divergence in one evaluation (zeros for dlogp
    without ``return_dlogp``). ``div_axis`` shards the divergence's lanes
    over a process group (not Hutch++: its sketch QR needs every query)."""
    if return_dlogp and divergence == "hutchpp" and div_axis is not None:
        raise NotImplementedError(
            "div_axis lane sharding is not implemented for hutchpp "
            "(the sketch QR needs the full query basis)"
        )
    if return_dlogp:
        check_divergence(divergence, num_probes)
        if divergence != "exact" and generator is None and probes is None:
            raise ValueError(f"{divergence} divergence requires a generator (or probes=)")

    def rhs(x, t, eval_idx):
        if not return_dlogp:
            return v_fn(x, t), x.new_zeros(x.shape[0])
        vel, div = value_and_divergence(
            lambda y: v_fn(y, t), x, mode=divergence, generator=generator,
            num_probes=num_probes, chunk=div_chunk, axis_name=div_axis, probe_mode=probe_mode,
            probe_crn=probe_crn, draws=None if probes is None else probes(eval_idx))
        return vel, -div

    return rhs


def _rk_step(rhs, x, lp, t: float, dt: float, method: str, base_idx: int):
    """One explicit RK step of the joint (x, dlogp) system."""
    cc, aa, bb = _tableau(method)
    kx, kl = [], []
    for si in range(len(bb)):
        yi, li = x, lp
        for sj in range(si):
            if aa[si][sj]:
                yi = yi + (dt * aa[si][sj]) * kx[sj]
                li = li + (dt * aa[si][sj]) * kl[sj]
        dx, dl = rhs(yi, t + cc[si] * dt, base_idx + si)
        kx.append(dx)
        kl.append(dl)
    for si in range(len(bb)):
        x = x + (dt * bb[si]) * kx[si]
        lp = lp + (dt * bb[si]) * kl[si]
    return x, lp


def sample_ode(v_fn, x0: torch.Tensor, *, t0: float = 0.0, t1: float = 1.0,
               n_steps: int = 100, n_save: int = 2, method: str = "rk4",
               return_dlogp: bool = False, divergence: str = "exact",
               generator: Optional[torch.Generator] = None, num_probes: int = 8,
               div_chunk: Optional[int] = None, div_axis=None, probe_mode: str = "rademacher",
               probe_crn: bool = False, probes: Optional[Callable] = None,
               dlogp0: Optional[torch.Tensor] = None) -> ODESolution:
    """Fixed-step transport of a chain batch x0 (B, ...) from t0 to t1 in
    ``n_steps`` uniform steps, saving ``n_save`` states (n_steps a
    multiple of n_save - 1).

    With ``return_dlogp`` the divergence is integrated inside every RK
    stage (exact in blocks of ``div_chunk`` lanes, or Hutchinson / Hutch++
    probes from ``generator``; evaluation i of step s is index
    s·n_stages + i for ``probes``), starting from ``dlogp0`` (B,), so an
    integration can be resumed segment by segment; without it dlogp is
    zero."""
    if n_save < 2 or n_steps % (n_save - 1) != 0:
        raise ValueError("n_steps must be a positive multiple of (n_save - 1)")
    rhs = _make_rhs_joint(v_fn, return_dlogp, divergence, generator, num_probes, div_chunk,
                          div_axis, probe_mode, probe_crn, probes)
    n_stages = len(_tableau(method)[2])
    dt = (t1 - t0) / n_steps
    per_save = n_steps // (n_save - 1)
    x = x0
    lp = (x0.new_zeros(x0.shape[0]) if dlogp0 is None
          else torch.as_tensor(dlogp0, dtype=x0.dtype, device=x0.device).expand(x0.shape[0]))
    xs, lps = [x], [lp]
    for i in range(n_steps):
        x, lp = _rk_step(rhs, x, lp, t0 + i * dt, dt, method, i * n_stages)
        if (i + 1) % per_save == 0:
            xs.append(x)
            lps.append(lp)
    return ODESolution(xs=torch.stack(xs, dim=1), dlogp=torch.stack(lps, dim=1),
                       nfe=n_steps * n_stages)


# ---------------------------------------------------------------------------
# Quadrature-decoupled dlogp: velocity-only transport, then the divergence
# at a few nodes of the trajectory.
# ---------------------------------------------------------------------------

def sample_ode_times(v_fn, x0: torch.Tensor, ts, *, method: str = "rk4") -> torch.Tensor:
    """Velocity-only RK transport of x0 (B, ...) over an explicit, possibly
    non-uniform grid of step boundaries ``ts`` (host array, monotone).
    Returns every state, (B, len(ts), ...)."""
    ts = np.asarray(ts, dtype=np.float64)
    rhs = _make_rhs_joint(v_fn, False)
    x, lp = x0, x0.new_zeros(x0.shape[0])
    xs = [x]
    for i in range(len(ts) - 1):
        x, lp = _rk_step(rhs, x, lp, float(ts[i]), float(ts[i + 1] - ts[i]), method, 0)
        xs.append(x)
    return torch.stack(xs, dim=1)


def gauss_dlogp_schedule(t0: float, t1: float, n_steps: int, gl_points: int, n_save: int):
    """The step grid and quadrature bookkeeping of Gauss-Legendre dlogp.

    Per save interval the ``gl_points`` Gauss-Legendre nodes are step
    boundaries, with RK sub-steps per gap in proportion to its length (at
    least one), about ``n_steps`` in all. Returns (ts, node_idx (n_save-1,
    gl_points), node_weights (n_save-1, gl_points), save_idx (n_save,)).
    """
    if n_save < 2:
        raise ValueError("n_save must be >= 2")
    gl_x, gl_w = np.polynomial.legendre.leggauss(gl_points)  # on [-1, 1]
    saves = np.linspace(t0, t1, n_save)
    per_interval = max(gl_points + 1, n_steps // (n_save - 1))
    ts = [t0]
    node_idx = np.zeros((n_save - 1, gl_points), dtype=np.int64)
    node_w = np.zeros((n_save - 1, gl_points))
    save_idx = [0]
    for j in range(n_save - 1):
        lo, hi = saves[j], saves[j + 1]
        half = 0.5 * (hi - lo)
        nodes = lo + half * (gl_x + 1.0)
        node_w[j] = gl_w * half  # the dt/du factor
        bounds = np.concatenate([[lo], nodes, [hi]])
        gaps = np.diff(bounds)
        m = np.maximum(1, np.round(per_interval * np.abs(gaps) / np.abs(hi - lo)).astype(int))
        for k, (a, g, mk) in enumerate(zip(bounds[:-1], gaps, m)):
            ts.extend((a + g * np.arange(1, mk + 1) / mk).tolist())
            if k < gl_points:
                node_idx[j, k] = len(ts) - 1
        save_idx.append(len(ts) - 1)
    return np.asarray(ts), node_idx, node_w, np.asarray(save_idx)


def node_divergences(v_fn, xs_nodes: torch.Tensor, ts_nodes, *, divergence: str = "exact",
                     generator: Optional[torch.Generator] = None, num_probes: int = 8,
                     div_chunk: Optional[int] = None, probe_mode: str = "rademacher",
                     probe_crn: bool = False, probes: Optional[Callable] = None,
                     node_batch: Optional[int] = None, return_var: bool = False,
                     div_axis=None):
    """The divergence of ``v_fn`` at P trajectory nodes, xs_nodes (P, B, ...)
    at times ``ts_nodes`` (P,): (B, P), and with ``return_var`` the
    Hutchinson probe variance (B, P) too.

    Node i takes the probes ``probes(i)`` or draws them from ``generator``,
    node after node. ``node_batch`` evaluates the nodes in groups of that
    size, a group's k·B chains stacked into one batch for ``v_fn``, with
    per-chain times (k·B,): the draws and the results are those of one node
    at a time. ``div_axis`` shards each node's lanes over a process group
    (``probes(i)`` then gives this rank's probes)."""
    p, b = xs_nodes.shape[0], xs_nodes.shape[1]
    d = xs_nodes[0, 0].numel()
    step = 1 if node_batch is None else max(1, int(node_batch))
    divs, dvars = [], []
    for i0 in range(0, p, step):
        group = range(i0, min(i0 + step, p))
        xg = xs_nodes[i0:group.stop].reshape(len(group) * b, *xs_nodes.shape[2:])
        if len(group) == 1:
            tg = float(ts_nodes[i0])
        else:
            tg = torch.as_tensor(np.repeat(np.asarray(ts_nodes[i0:group.stop], np.float64), b),
                                 dtype=xg.dtype, device=xg.device)
        draws = None
        if divergence != "exact":
            per_node = [probes(i) if probes is not None else
                        draw_probes(generator, divergence, b, d, num_probes=num_probes,
                                    probe_mode=probe_mode, probe_crn=probe_crn, dtype=xg.dtype,
                                    axis_name=div_axis)
                        for i in group]
            draws = tuple(torch.cat(parts) for parts in zip(*per_node))
        res = value_and_divergence(lambda y: v_fn(y, tg), xg, mode=divergence,
                                   generator=generator, num_probes=num_probes, chunk=div_chunk,
                                   axis_name=div_axis, probe_mode=probe_mode,
                                   return_var=return_var, draws=draws)
        divs.append(res[1].reshape(len(group), b))
        if return_var:
            dvars.append(res[2].reshape(len(group), b))
    div = torch.cat(divs).transpose(0, 1)
    return (div, torch.cat(dvars).transpose(0, 1)) if return_var else div


def _check_quad(div_points: int, n_steps: int, n_save: int) -> None:
    if div_points < 3 or div_points % 2 == 0:
        raise ValueError("div_points must be odd and >= 3")
    m = div_points - 1
    if n_steps % m != 0:
        raise ValueError("(div_points - 1) must divide n_steps")
    if (n_save - 1) <= 0 or m % (n_save - 1) != 0 or (m // (n_save - 1)) % 2 != 0:
        raise ValueError(
            "n_save - 1 must divide div_points - 1 with an even quotient "
            "(cumulative Simpson needs paired intervals per output time)"
        )


def simpson_dlogp(divs: torch.Tensor, t0: float, t1: float, n_save: int) -> torch.Tensor:
    """dlogp (B, n_save) at the save times from the divergence (B, P) at P
    uniform nodes over [t0, t1]: cumulative composite Simpson of -div over
    pairs of intervals."""
    m = divs.shape[1] - 1
    h = (t1 - t0) / m
    pair = (h / 3.0) * (divs[:, :-2:2] + 4.0 * divs[:, 1:-1:2] + divs[:, 2::2])
    cum = torch.cat([divs.new_zeros(divs.shape[0], 1), torch.cumsum(pair, dim=1)], dim=1)
    return -cum[:, np.arange(n_save) * (m // (n_save - 1)) // 2]


def sample_ode_quad_dlogp(v_fn, x0: torch.Tensor, *, t0: float = 0.0, t1: float = 1.0,
                          n_steps: int = 100, div_points: int = 21, n_save: int = 2,
                          method: str = "rk4", divergence: str = "exact",
                          generator: Optional[torch.Generator] = None, num_probes: int = 8,
                          div_chunk: Optional[int] = None, div_axis=None,
                          probe_mode: str = "rademacher", probe_crn: bool = False,
                          probes: Optional[Callable] = None,
                          node_batch: Optional[int] = None) -> ODESolution:
    """Transport with Simpson-quadrature dlogp: velocity-only RK over
    ``n_steps`` uniform steps, saving the ``div_points`` uniform grid, then
    the divergence at every grid node (``node_divergences``) and cumulative
    composite Simpson. ``div_points`` is odd, (div_points - 1) divides
    n_steps, and n_save - 1 divides (div_points - 1) with an even quotient,
    so the save times are grid nodes. Costs n_stages·n_steps velocity and
    div_points divergence evaluations a chain. With ``node_batch`` the
    divergence takes ``v_fn`` on node groups (``node_divergences``)."""
    check_divergence(divergence, num_probes)
    _check_quad(div_points, n_steps, n_save)
    sol = sample_ode(v_fn, x0, t0=t0, t1=t1, n_steps=n_steps, n_save=div_points, method=method)
    divs = node_divergences(
        v_fn, sol.xs.transpose(0, 1), np.linspace(t0, t1, div_points), divergence=divergence,
        generator=generator, num_probes=num_probes, div_chunk=div_chunk, probe_mode=probe_mode,
        probe_crn=probe_crn, probes=probes, node_batch=node_batch, div_axis=div_axis)
    out_idx = np.arange(n_save) * ((div_points - 1) // (n_save - 1))
    return ODESolution(xs=sol.xs[:, out_idx], dlogp=simpson_dlogp(divs, t0, t1, n_save),
                       nfe=sol.nfe + div_points)


def sample_ode_gauss_dlogp(v_fn, x0: torch.Tensor, *, t0: float = 0.0, t1: float = 1.0,
                           n_steps: int = 100, gl_points: int = 8, n_save: int = 2,
                           method: str = "rk4", divergence: str = "exact",
                           generator: Optional[torch.Generator] = None, num_probes: int = 8,
                           div_chunk: Optional[int] = None, div_axis=None,
                           probe_mode: str = "rademacher", probe_crn: bool = False,
                           probes: Optional[Callable] = None,
                           node_batch: Optional[int] = None) -> ODESolution:
    """Transport with Gauss-Legendre dlogp: ``gl_points`` nodes per save
    interval, which the warped step grid of ``gauss_dlogp_schedule`` makes
    exact step boundaries, velocity-only RK over that grid
    (``sample_ode_times``), then the divergence at the nodes and their
    weighted sum per interval. With ``node_batch`` the divergence takes
    ``v_fn`` on node groups (``node_divergences``)."""
    check_divergence(divergence, num_probes)
    ts, node_idx, node_w, save_idx = gauss_dlogp_schedule(t0, t1, n_steps, gl_points, n_save)
    xs_all = sample_ode_times(v_fn, x0, ts, method=method)
    flat = node_idx.reshape(-1)
    divs = node_divergences(
        v_fn, xs_all[:, flat].transpose(0, 1), ts[flat], divergence=divergence,
        generator=generator, num_probes=num_probes, div_chunk=div_chunk, probe_mode=probe_mode,
        probe_crn=probe_crn, probes=probes, node_batch=node_batch, div_axis=div_axis)
    b = x0.shape[0]
    w = torch.as_tensor(node_w, dtype=x0.dtype, device=x0.device)
    per_interval = -(w[None] * divs.reshape(b, *node_idx.shape)).sum(2)
    dlogp = torch.cat([x0.new_zeros(b, 1), torch.cumsum(per_interval, dim=1)], dim=1)
    n_stages = len(_tableau(method)[2])
    return ODESolution(xs=xs_all[:, save_idx], dlogp=dlogp,
                       nfe=(len(ts) - 1) * n_stages + len(flat))


# ---------------------------------------------------------------------------
# Adaptive Dormand–Prince 5(4), ti_tpu's controller at the reference's
# atol = rtol = 1e-5.
# ---------------------------------------------------------------------------

# Butcher tableau (Dormand & Prince 1980), torchdiffeq's dopri5 coefficients
_DP_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_DP_A = np.zeros((7, 7))
_DP_A[1, :1] = [1 / 5]
_DP_A[2, :2] = [3 / 40, 9 / 40]
_DP_A[3, :3] = [44 / 45, -56 / 15, 32 / 9]
_DP_A[4, :4] = [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729]
_DP_A[5, :5] = [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656]
_DP_A[6, :6] = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]
_DP_B5 = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0])
_DP_B4 = np.array(
    [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40]
)


def _combine(coef, ks):
    """sum_j coef[j] · ks[j] as one product over the stacked stages (zero
    coefficients included), in the order ti_tpu's ``coef @ ks`` takes."""
    k = torch.stack(ks, dim=-1)
    return k @ torch.as_tensor(coef[:len(ks)], dtype=k.dtype, device=k.device)


class Dopri5State(NamedTuple):
    """Per-chain state of the adaptive solver: internal time tau =
    |t - t0| (B,), the joint state x (B, ...) and dlogp (B,), the next
    step size (B,) and the evaluations spent so far (B,)."""

    tau: torch.Tensor
    x: torch.Tensor
    lp: torch.Tensor
    dt: torch.Tensor
    nfe: torch.Tensor


def _tol_pair(tol):
    """A scalar tolerance, or an (x, dlogp) pair — the per-state tolerance
    lists the reference passes to torchdiffeq — as (x tol, dlogp tol)."""
    arr = np.asarray(tol, dtype=np.float64)
    if arr.ndim == 0:
        return float(arr), float(arr)
    if arr.shape != (2,):
        raise ValueError(f"tolerance must be a scalar or an (x, dlogp) pair, got shape "
                         f"{arr.shape}")
    return float(arr[0]), float(arr[1])


def dopri5_stepper(v_fn, *, t0: float = 0.0, t1: float = 1.0, atol=1e-5, rtol=1e-5,
                   max_steps: int = 1024, return_dlogp: bool = True, divergence: str = "exact",
                   generator: Optional[torch.Generator] = None, num_probes: int = 8,
                   div_chunk: Optional[int] = None, div_axis=None,
                   probe_mode: str = "rademacher", probe_crn: bool = False,
                   probes: Optional[Callable] = None, first_dt: float = 0.01):
    """Resumable adaptive RK45 on a chain batch: returns (init, advance).

    ``init(x0, dlogp0=None) -> Dopri5State``; ``advance(state, tau_target)
    -> state`` steps every chain towards internal time tau_target in
    [0, |t1 - t0|] until it gets there or has spent ``7 * max_steps``
    evaluations in this call; a chain that is done stops moving. Error
    control is on each chain's joint (x, dlogp) state (RMS of err / (atol +
    rtol·max(|y|, |y_new|))); a step is accepted at norm <= 1 and the next
    one scaled by 0.9·norm^(-1/5), clipped to [0.2, 10]. ``n_short``
    counts the chains an ``advance`` left before its target.

    Under a ``ChainShard`` generator with a stochastic divergence the ranks
    step in lockstep (one all-reduce of the "any chain active" flag a
    step), so that every evaluation draws the batch's probes as the
    unsharded run does."""
    lockstep = (isinstance(generator, ChainShard) and return_dlogp and divergence != "exact"
                and probes is None)
    rhs0 = _make_rhs_joint(v_fn, return_dlogp, divergence, generator, num_probes, div_chunk,
                           div_axis, probe_mode, probe_crn, probes)
    direction = 1.0 if t1 >= t0 else -1.0  # internal time tau = direction·(t - t0)
    atol_x, atol_l = _tol_pair(atol)
    rtol_x, rtol_l = _tol_pair(rtol)

    def init(x0: torch.Tensor, dlogp0=None) -> Dopri5State:
        b = x0.shape[0]
        lp = (x0.new_zeros(b) if dlogp0 is None
              else torch.as_tensor(dlogp0, dtype=x0.dtype, device=x0.device).expand(b))
        return Dopri5State(tau=x0.new_zeros(b), x=x0, lp=lp, dt=x0.new_full((b,), first_dt),
                           nfe=torch.zeros(b, dtype=torch.int64, device=x0.device))

    def advance(state: Dopri5State, tau_target: float) -> Dopri5State:
        tau, x, lp, dt, nfe = state
        target = torch.tensor(tau_target, dtype=x.dtype, device=x.device)
        t_eps = _t_eps(x.dtype)
        b, d = x.shape[0], x[0].numel()
        bcast = (b,) + (1,) * (x.dim() - 1)
        budget = nfe + 7 * max_steps
        done = tau >= target - t_eps
        while True:
            active = ~done & (nfe < budget)
            if not (generator.any(active.any()) if lockstep else bool(active.any())):
                return Dopri5State(tau, x, lp, dt, nfe)
            dt_c = torch.minimum(dt, target - tau)
            dt_x = dt_c.view(bcast)
            kx, kl = [], []
            for i in range(7):
                yi, li = x, lp
                if i:
                    yi = x + dt_x * _combine(_DP_A[i], kx)
                    li = lp + dt_c * _combine(_DP_A[i], kl)
                vx, vl = rhs0(yi, t0 + direction * (tau + _DP_C[i] * dt_c), nfe + i)
                kx.append(direction * vx)
                kl.append(direction * vl)
            x5 = x + dt_x * _combine(_DP_B5, kx)
            l5 = lp + dt_c * _combine(_DP_B5, kl)
            # the error as dt·Σ(b5 - b4)·k, as torchdiffeq forms it: ti_tpu
            # subtracts the two f32 solutions, whose rounding is the whole of
            # the first steps' norms (so its step counts can differ in f32)
            ex = dt_x * _combine(_DP_B5 - _DP_B4, kx)
            el = dt_c * _combine(_DP_B5 - _DP_B4, kl)
            sx = atol_x + rtol_x * torch.maximum(x.abs(), x5.abs())
            sl = atol_l + rtol_l * torch.maximum(lp.abs(), l5.abs())
            en = torch.sqrt((((ex / sx) ** 2).reshape(b, d).sum(1) + (el / sl) ** 2) / (d + 1))
            accept = active & (en <= 1.0)
            factor = torch.clamp(0.9 * (en + 1e-16) ** -0.2, 0.2, 10.0)
            tau = torch.where(accept, tau + dt_c, tau)
            x = torch.where(accept.view(bcast), x5, x)
            lp = torch.where(accept, l5, lp)
            dt = torch.where(active, torch.clamp(dt_c * factor, min=t_eps), dt)
            nfe = nfe + 7 * active
            done = tau >= target - t_eps

    return init, advance


def n_short(state: Dopri5State, tau_target: float) -> int:
    """The chains of ``state`` short of internal time ``tau_target``."""
    target = torch.tensor(tau_target, dtype=state.x.dtype, device=state.x.device)
    return int((state.tau < target - _t_eps(state.x.dtype)).sum())


def _t_eps(dtype) -> float:
    """Completion tolerance of a save time: 10 ulp of 1 in the state's
    dtype (1e-12 would never trigger in f32)."""
    return 10.0 * torch.finfo(dtype).eps


def short_of_save_time(n_short: int, b: int, t_save: float, budget: str) -> RuntimeError:
    """The error raised when dopri5 chains end a save interval short of
    its time (ti_tpu returns their state as if they had reached it)."""
    return RuntimeError(
        f"dopri5: {n_short} of {b} chains stopped short of the save time t = {t_save:.6g} "
        f"after {budget}; their state is not the state at that time. Raise max_steps "
        "(or steps_per_dispatch) or loosen atol/rtol")


def sample_ode_dopri5(v_fn, x0: torch.Tensor, *, t0: float = 0.0, t1: float = 1.0,
                      n_save: int = 2, atol=1e-5, rtol=1e-5, max_steps: int = 1024,
                      return_dlogp: bool = True, divergence: str = "exact",
                      generator: Optional[torch.Generator] = None, num_probes: int = 8,
                      div_chunk: Optional[int] = None, div_axis=None,
                      probe_mode: str = "rademacher", probe_crn: bool = False,
                      probes: Optional[Callable] = None, first_dt: float = 0.01) -> ODESolution:
    """Adaptive RK45 transport of a chain batch x0 (B, ...) to ``n_save``
    uniform save times, each chain bounded by ``max_steps`` steps per save
    interval; ``nfe`` is per chain (B,). Raises if a chain spends that
    budget before a save time. Reverse transport: t0=1.0, t1=0.0."""
    init, advance = dopri5_stepper(
        v_fn, t0=t0, t1=t1, atol=atol, rtol=rtol, max_steps=max_steps,
        return_dlogp=return_dlogp, divergence=divergence, generator=generator,
        num_probes=num_probes, div_chunk=div_chunk, div_axis=div_axis, probe_mode=probe_mode,
        probe_crn=probe_crn, probes=probes, first_dt=first_dt)
    save_ts = np.linspace(0.0, abs(t1 - t0), n_save)  # rounded to the state dtype in advance
    state = init(x0)
    xs, lps = [state.x], [state.lp]
    for i in range(1, n_save):
        state = advance(state, float(save_ts[i]))
        short = n_short(state, float(save_ts[i]))
        if short:
            raise short_of_save_time(short, x0.shape[0], t0 + np.sign(t1 - t0) * save_ts[i],
                                     f"max_steps = {max_steps} steps in one save interval")
        xs.append(state.x)
        lps.append(state.lp)
    return ODESolution(xs=torch.stack(xs, dim=1), dlogp=torch.stack(lps, dim=1), nfe=state.nfe)


def sample_sde(
    drift_fn,
    x0: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    g_fn: Union[Callable[[float], float], float] = 0.0,
    t0: float = 0.0,
    t1: float = 1.0,
    n_steps: int = 100,
    n_save: int = 2,
    project_zero_mean: bool = False,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Euler–Maruyama: dX = b(X, t) dt + g(t) dW. Returns (n_save, *state).

    With g = 0 this is the Euler probability-flow ODE. ``project_zero_mean``
    removes the mean of the injected noise over axis -2 each step — the
    per-structure centre of mass of a (N, 3) or batched (C, N, 3) state.
    The noise of step i is ``noise[i]`` when ``noise`` (n_steps, *state) is
    given (the parity tests pass JAX's draws), else a standard normal draw
    from ``generator``. The one Euler–Maruyama core: the batched molecular
    driver (drivers.sample_molecular_sde) delegates here.
    """
    if n_save < 2 or n_steps % (n_save - 1) != 0:
        raise ValueError("n_steps must be a positive multiple of (n_save - 1)")
    if noise is not None and tuple(noise.shape) != (n_steps, *x0.shape):
        raise ValueError(f"noise must be {(n_steps, *x0.shape)}, got {tuple(noise.shape)}")
    if noise is None and generator is None:
        raise ValueError("sample_sde needs a generator or explicit noise")
    g = g_fn if callable(g_fn) else (lambda t, _g=float(g_fn): _g)
    dt = (t1 - t0) / n_steps
    sqrt_dt = float(np.sqrt(np.float32(abs(dt))))
    per_save = n_steps // (n_save - 1)
    x = x0
    saves = [x]
    for i in range(n_steps):
        t = t0 + i * dt
        if noise is None:
            z = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
        else:
            z = noise[i].to(device=x.device, dtype=x.dtype)
        if project_zero_mean:
            z = z - z.mean(dim=-2, keepdim=True)
        x = x + (dt * drift_fn(x, t) + g(t) * sqrt_dt * z).to(x.dtype)
        if (i + 1) % per_save == 0:
            saves.append(x)
    return torch.stack(saves)
