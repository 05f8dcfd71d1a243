"""Plain PyTorch reference of the two PIC steps the benchmark times.

One step of 2D (or 3D) electrostatic PIC and of 3D3V electromagnetic PIC,
written from the published schemes and nothing else: cloud-in-cell (CIC)
deposit and gather on a periodic grid with values at integer nodes, the
spectral Poisson solve with E = -grad(phi) by central differences,
leapfrog kick and drift (ES); the node-centered field table, the
non-relativistic Boris rotation, Esirkepov's charge-conserving current
(CPC 135 (2001) 144) and the Yee leapfrog B half, E full, B half (EM).

It imports neither JAX nor the port: it works from positions, velocities
and fields handed to it, in plain ``torch`` operations, in blocks of rows
so that it fits beside what it is checking.  ``fdtype`` is the precision
of everything but positions (grids, velocities, fields, weights):
float32 is the reference, bfloat16 the lower-precision control.
"""

from __future__ import annotations

import itertools
import math

import torch

ROWS = 1 << 21  # rows per block of the particle passes


def _as(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x if x.dtype == dtype else x.to(dtype)


def wrap(x: torch.Tensor, shape) -> torch.Tensor:
    """Positions (N, d) in grid units wrapped into [0, n) per axis."""
    n = torch.tensor(shape, dtype=x.dtype, device=x.device)
    return torch.remainder(x, n)


def _cic(x: torch.Tensor, shape):
    """Per corner: (flat node index (N,), weight (N,) in x's dtype)."""
    base = torch.floor(x)
    frac = x - base
    base = base.to(torch.int64)
    out = []
    for corner in itertools.product((0, 1), repeat=len(shape)):
        flat = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
        w = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
        for axis, c in enumerate(corner):
            flat = flat * shape[axis] + torch.remainder(base[:, axis] + c,
                                                        shape[axis])
            w = w * (frac[:, axis] if c else 1.0 - frac[:, axis])
        out.append((flat, w))
    return out


def deposit(x: torch.Tensor, weights: torch.Tensor, shape,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """CIC deposit of ``weights`` (N,) or (N, C) at wrapped ``x`` (N, d);
    returns (*shape) or (*shape, C), summed in ``dtype``."""
    chans = weights.shape[1:]
    grid = torch.zeros((math.prod(shape),) + tuple(chans), dtype=dtype,
                       device=x.device)
    for lo in range(0, x.shape[0], ROWS):
        xb = wrap(x[lo:lo + ROWS], shape)
        wb = _as(weights[lo:lo + ROWS], dtype)
        for flat, w in _cic(xb, shape):
            w = _as(w, dtype)
            grid.index_add_(0, flat, wb * (w[:, None] if chans else w))
    return grid.reshape(tuple(shape) + tuple(chans))


def gather(grid: torch.Tensor, x: torch.Tensor, shape) -> torch.Tensor:
    """CIC gather of ``grid`` ((*shape, C)) at wrapped ``x``; (N, C) in
    the grid's dtype."""
    flat_grid = grid.reshape(math.prod(shape), -1)
    out = torch.zeros((x.shape[0], flat_grid.shape[1]), dtype=grid.dtype,
                      device=x.device)
    for lo in range(0, x.shape[0], ROWS):
        xb = wrap(x[lo:lo + ROWS], shape)
        acc = 0.0
        for flat, w in _cic(xb, shape):
            acc = acc + _as(w, grid.dtype)[:, None] * flat_grid[flat]
        out[lo:lo + ROWS] = acc
    return out


# -- electrostatic ------------------------------------------------------------

def poisson_e(rho: torch.Tensor, cell_size, eps0: float = 1.0
              ) -> torch.Tensor:
    """E = -grad(phi) with laplacian(phi) = -rho/eps0 on the periodic grid
    (phi_k = rho_k / (eps0 |k|^2), k = 0 dropped), central differences;
    (*shape, d) in rho's dtype.  The FFT runs in float32 (there is no
    bfloat16 FFT); its input and output are rounded to rho's dtype."""
    shape = tuple(rho.shape)
    ks = [2 * math.pi * torch.fft.fftfreq(n, d=d, device=rho.device)
          for n, d in zip(shape[:-1], cell_size[:-1])]
    ks.append(2 * math.pi * torch.fft.rfftfreq(shape[-1], d=cell_size[-1],
                                               device=rho.device))
    ksq = sum(g * g for g in torch.meshgrid(*ks, indexing="ij"))
    inv = torch.where(ksq > 0, 1.0 / (eps0 * ksq), 0.0)
    phi = torch.fft.irfftn(torch.fft.rfftn(rho.float()) * inv, s=shape)
    phi = _as(phi, rho.dtype)
    return torch.stack(
        [-(torch.roll(phi, -1, a) - torch.roll(phi, 1, a)) / (2.0 * d)
         for a, d in enumerate(cell_size)], dim=-1)


def es_step(cfg: dict, x0: torch.Tensor, v0: torch.Tensor,
            fdtype: torch.dtype = torch.float32):
    """One ES leapfrog step of the real particles ``(x0, v0)``: the charge
    at x0 (neutralized), the solve, v1 = v0 + (q/m) dt E(x0), x1 = x0 +
    dt v1 / dx wrapped, and the charge at x1 (not neutralized).  Returns
    ``(x1, v1, rho1)``; v1 and rho1 in ``fdtype``."""
    shape, dx = tuple(cfg["grid_shape"]), tuple(cfg["cell_size"])
    w0 = cfg["charge"] / math.prod(dx)
    w = torch.full((x0.shape[0],), w0, dtype=fdtype, device=x0.device)
    rho = deposit(x0, w, shape, fdtype)
    rho = rho - rho.mean()
    e = poisson_e(rho, dx, cfg.get("eps0", 1.0))
    qm_dt = cfg["charge"] / cfg["mass"] * cfg["dt"]
    v1 = _as(v0, fdtype) + qm_dt * gather(e, x0, shape)
    dxt = torch.tensor(dx, dtype=torch.float32, device=x0.device)
    x1 = wrap(x0 + cfg["dt"] * v1.float() / dxt, shape)
    return x1, v1, deposit(x1, w, shape, fdtype)


# -- electromagnetic (3D3V, centered gather) ------------------------------------

E_OFFSETS = ((0.5, 0.0, 0.0), (0.0, 0.5, 0.0), (0.0, 0.0, 0.5))
B_OFFSETS = ((0.0, 0.5, 0.5), (0.5, 0.0, 0.5), (0.5, 0.5, 0.0))


def center(e: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The (*grid, 6) node table (Ex, Ey, Ez, Bx, By, Bz): a component
    stored half a cell up an axis is averaged with its neighbour below."""
    cols = []
    for field, offsets in ((e, E_OFFSETS), (b, B_OFFSETS)):
        for comp, off in enumerate(offsets):
            c = field[..., comp]
            for axis, o in enumerate(off):
                if o:
                    c = 0.5 * (c + torch.roll(c, 1, axis))
            cols.append(c)
    return torch.stack(cols, dim=-1)


def boris(v: torch.Tensor, e: torch.Tensor, b: torch.Tensor,
          qm_half_dt: float) -> torch.Tensor:
    """Non-relativistic Boris: half E kick, B rotation, half E kick."""
    vm = v + qm_half_dt * e
    t = qm_half_dt * b
    s = 2.0 * t / (1.0 + torch.sum(t * t, dim=-1, keepdim=True))
    vp = vm + torch.linalg.cross(vm, t)
    return vm + torch.linalg.cross(vp, s) + qm_half_dt * e


def _shape3(x: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """CIC weights of x (N,) at nodes base + {0, 1, 2}: (N, 3)."""
    k = torch.arange(3, dtype=x.dtype, device=x.device)
    return torch.clamp(1.0 - torch.abs(x[:, None] - (base[:, None].to(x.dtype)
                                                      + k)), min=0.0)


def _running_sum3(w: torch.Tensor, dim: int) -> torch.Tensor:
    """The running sum along an axis of length 3, added in order (as
    ``torch.cumsum``, whose scan over a short axis is slow on the card)."""
    a, b, c = w.unbind(dim)
    return torch.stack([a, a + b, a + b + c], dim=dim)


def esirkepov(x0: torch.Tensor, x1: torch.Tensor, q: float, dt: float,
              shape, cell_size, fdtype: torch.dtype = torch.float32
              ) -> torch.Tensor:
    """Esirkepov current (*shape, 3) of particles moving x0 -> x1 (x0
    wrapped, x1 = x0 + displacement, under a cell an axis).  J_a sits half
    a cell up axis a: J_a = -q d_a / (V dt) * running sum along a of
    W_a = dS_a [S0_b S0_c + (dS_b S0_c + S0_b dS_c) / 2 + dS_b dS_c / 3]."""
    vol = math.prod(cell_size)
    grid = torch.zeros((math.prod(shape), 3), dtype=fdtype, device=x0.device)
    k = torch.arange(3, device=x0.device)
    for lo in range(0, x0.shape[0], ROWS // 2):
        a0, a1 = x0[lo:lo + ROWS // 2], x1[lo:lo + ROWS // 2]
        base = [torch.floor(torch.minimum(a0[:, c], a1[:, c])).to(torch.int64)
                for c in range(3)]
        s0 = [_as(_shape3(a0[:, c], base[c]), fdtype) for c in range(3)]
        ds = [_as(_shape3(a1[:, c], base[c]), fdtype) - s0[c]
              for c in range(3)]
        vals = []
        for axis in range(3):
            b, c = [a for a in range(3) if a != axis]
            mix = (s0[b][:, :, None] * s0[c][:, None, :]
                   + 0.5 * (ds[b][:, :, None] * s0[c][:, None, :]
                            + s0[b][:, :, None] * ds[c][:, None, :])
                   + (1.0 / 3.0) * ds[b][:, :, None] * ds[c][:, None, :])
            view = [a0.shape[0], 1, 1, 1]
            view[1 + axis] = 3
            w = ds[axis].reshape(view) * mix.unsqueeze(1 + axis)
            vals.append((-q * cell_size[axis] / (vol * dt))
                        * _running_sum3(w, 1 + axis))
        vals = torch.stack(vals, dim=-1)
        gx = torch.remainder(base[0][:, None] + k, shape[0])[:, :, None, None]
        gy = torch.remainder(base[1][:, None] + k, shape[1])[:, None, :, None]
        gz = torch.remainder(base[2][:, None] + k, shape[2])[:, None, None, :]
        grid.index_add_(0, ((gx * shape[1] + gy) * shape[2] + gz).reshape(-1),
                        _as(vals, fdtype).reshape(-1, 3))
    return grid.reshape(tuple(shape) + (3,))


def _dplus(f, axis, d):
    return (torch.roll(f, -1, axis) - f) / d


def _dminus(f, axis, d):
    return (f - torch.roll(f, 1, axis)) / d


def _curl(f, dx, diff):
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    return torch.stack([diff(fz, 1, dx[1]) - diff(fy, 2, dx[2]),
                        diff(fx, 2, dx[2]) - diff(fz, 0, dx[0]),
                        diff(fy, 0, dx[0]) - diff(fx, 1, dx[1])], dim=-1)


def yee(e: torch.Tensor, b: torch.Tensor, j: torch.Tensor, dt: float, dx,
        c: float = 1.0, eps0: float = 1.0):
    """B half step, E full step with J, B half step (periodic Yee)."""
    b = b - (0.5 * dt) * _curl(e, dx, _dplus)
    e = e + dt * ((c * c) * _curl(b, dx, _dminus) - j / eps0)
    return e, b - (0.5 * dt) * _curl(e, dx, _dplus)


def em_step(cfg: dict, x0: torch.Tensor, v0: torch.Tensor, e0: torch.Tensor,
            b0: torch.Tensor, fdtype: torch.dtype = torch.float32):
    """One EM step of the real particles (3D3V, centered gather): table
    from (e0, b0), Boris kick, drift, Esirkepov current, Yee update.
    Returns ``(x1 wrapped, v1, e1, b1)``; all but x1 in ``fdtype``."""
    shape, dx = tuple(cfg["grid_shape"]), tuple(cfg["cell_size"])
    e0, b0 = _as(e0, fdtype), _as(b0, fdtype)
    table = center(e0, b0)
    qm_half_dt = cfg["charge"] / cfg["mass"] * cfg["dt"] * 0.5
    dxt = torch.tensor(dx, dtype=torch.float32, device=x0.device)
    v1 = torch.empty(v0.shape, dtype=fdtype, device=v0.device)
    x1 = torch.empty_like(x0)
    for lo in range(0, x0.shape[0], ROWS):
        xb = wrap(x0[lo:lo + ROWS], shape)
        eb = gather(table, xb, shape)
        v1[lo:lo + ROWS] = boris(_as(v0[lo:lo + ROWS], fdtype), eb[:, :3],
                                 eb[:, 3:], qm_half_dt)
        x1[lo:lo + ROWS] = xb + cfg["dt"] * v1[lo:lo + ROWS].float() / dxt
    j = esirkepov(wrap(x0, shape), x1, cfg["charge"], cfg["dt"], shape, dx,
                  fdtype)
    e1, b1 = yee(e0, b0, j, cfg["dt"], dx, cfg.get("c", 1.0),
                 cfg.get("eps0", 1.0))
    return wrap(x1, shape), v1, e1, b1


def yee_divergence(e: torch.Tensor, cell_size) -> torch.Tensor:
    """div E at the nodes from the staggered E (backward differences)."""
    return sum(_dminus(e[..., a], a, d) for a, d in enumerate(cell_size))
